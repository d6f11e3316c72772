"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained MoE, 64 routed experts
top-6 + 2 shared experts, expert hidden 1408."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
)
