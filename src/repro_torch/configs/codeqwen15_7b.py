"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: dense, MHA (GQA kv=32)."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    head_dim=128,
    rope_theta=1e6,
)
