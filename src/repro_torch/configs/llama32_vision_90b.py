"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-90B-Vision family]:
dense backbone with gated cross-attention image layers every 5th layer;
the vision tower is a stub — input_specs() provides precomputed patch
embeddings [B, 1601, d_model]."""

from repro_torch.configs import ArchConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    cross_attn_every=5,
    n_image_tokens=1601,
    rope_theta=5e5,
    grad_accum=8,
)
