"""Mixtral-8x22B [arXiv:2401.04088]: 8 experts top-2, sliding-window attn."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    rope_theta=1e6,
    grad_accum=4,
)
