"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD (state-space duality)."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
)
