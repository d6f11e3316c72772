"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + one *shared*
attention+MLP block invoked every 6 backbone layers (weights reused,
per-invocation KV cache, concat-with-embedding input projection)."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    shared_attn_every=6,
)
