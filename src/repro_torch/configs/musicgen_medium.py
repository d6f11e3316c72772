"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

The EnCodec frontend is a stub per the brief — the backbone consumes token
ids over the 2048-entry codec vocabulary. (The original's 4-codebook delay
pattern is a frontend concern; DESIGN.md §4.)
"""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    head_dim=64,
)
