"""StableLM-2-12B [hf:stabilityai/stablelm-2-12b family]: dense, GQA kv=8.

The original uses a parallel attention/FFN residual layout; we normalise to
the sequential pre-norm block (DESIGN.md §4 normalisation notes).
"""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    head_dim=160,
    grad_accum=2,
)
