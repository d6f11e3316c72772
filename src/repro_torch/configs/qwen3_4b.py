"""Qwen3-4B [hf:Qwen/Qwen3-4B family]: dense, GQA kv=8, per-head QK-norm."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
)
