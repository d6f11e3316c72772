"""Architecture configs: one file per assigned architecture (exact public
dims) and the shape grid (train_4k / prefill_32k / decode_32k / long_500k).

Counterpart of ``repro.configs``, with the same fields and numbers; the
compute and parameter dtypes are torch dtypes. :func:`input_specs` gives the
dry run's stand-ins for a cell's inputs, as meta tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

__all__ = [
    "ArchConfig",
    "Shape",
    "SHAPES",
    "ARCHS",
    "get_config",
    "reduced_config",
    "runnable_cells",
    "input_specs",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    qk_norm: bool = False
    window: int | None = None  # sliding-window attention (tokens)
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int | None = None  # routed-expert hidden size
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # hybrid (Zamba2): shared attention block every N backbone layers
    shared_attn_every: int = 0
    # VLM: gated cross-attention layer every N layers; stubbed frontend
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    scan_layers: bool = True  # no effect in the port: layers run as a Python loop
    remat: bool = True  # checkpoint each layer body when gradients are on (training)
    attn_chunk: int = 2048
    attn_impl: str = "block_causal"  # "masked_full" | "block_causal"
    # repeat KV heads to the full head count for model-axis sharding; the
    # port has no model axis, so "auto" never expands
    expand_gqa: str | bool = "auto"
    grad_accum: int = 1
    cast_params_before_use: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 (GPT-NeoX convention); the loss and sampler
        mask columns >= vocab."""
        return -(-self.vocab // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid state or bounded SWA window."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "granite-8b": "granite_8b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-130m": "mamba2_130m",
    "musicgen-medium": "musicgen_medium",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name == "bwkm":  # the paper's own workload (launch/cluster.py)
        raise ValueError("bwkm is a clustering workload; see launch/cluster.py")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.ARCH


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells; long_500k only for sub-quadratic archs."""
    cells = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.name == "long_500k" and not cfg.subquadratic:
                continue
            cells.append((a, s.name))
    return cells


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU tests (one forward/decode step)."""
    kw: dict[str, Any] = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        attn_chunk=32,
        dtype=torch.float32,
        param_dtype=torch.float32,
        remat=False,
        grad_accum=1,
    )
    if cfg.n_experts:
        # capacity_factor 4 with 4 experts is effectively dropless, so the
        # teacher-forced decode is exact; production keeps cf=1.25
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=32, capacity_factor=4.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=8, ssm_chunk=16)
    if cfg.shared_attn_every:
        kw.update(shared_attn_every=2, n_layers=4)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, n_layers=4, n_image_tokens=8)
    if cfg.window:
        kw.update(window=32)
    return cfg.replace(**kw)


# --------------------------------------------------------------------- specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: Shape) -> dict[str, Any]:
    """Meta-tensor stand-ins for every input of the cell's step function,
    with the reference's keys and dtypes:

    train:    {tokens [B,S], labels [B,S]} (+ image_embeds [B,T_img,D] for vlm)
    prefill:  {tokens [B,S]} (+ image_embeds)
    decode:   {token [B], pos [], cache <tree>} (the vlm's image K/V lives
              in the cache)
    """
    b, s = shape.global_batch, shape.seq_len
    specs: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = _meta((b, s), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
        if cfg.family == "vlm":
            specs["image_embeds"] = _meta((b, cfg.n_image_tokens, cfg.d_model), cfg.dtype)
    else:  # decode
        from repro_torch.models import cache as cache_mod

        specs["token"] = _meta((b,), torch.int32)
        specs["pos"] = _meta((), torch.int32)
        specs["cache"] = cache_mod.cache_specs(cfg, batch=b, seq_len=s)
    return specs
