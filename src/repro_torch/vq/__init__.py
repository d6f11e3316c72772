"""``repro_torch.vq``: clustering as a consumer of the inference stack.
Counterpart of ``repro.vq``.

Two serving-time uses of BWKM centroids:

* **KV-cache quantization**: :class:`CacheDumpSource` streams per-layer K/V
  vectors out of ``transformer.prefill`` through the ChunkSource protocol;
  :func:`fit_kv_codebook` fits one codebook per (layer, K/V) through the
  ``repro_torch.BWKM`` streaming engine; :func:`quantize_cache` +
  :func:`decode_quantized` serve from codes, dequantizing on attention read
  with the assignment kernel (B1) as the lookup.
* **MoE router seeding**: :func:`seed_router` clusters token
  representations through a :class:`~repro_torch.service.BWKMSession` and
  derives unit-norm router columns (:func:`router_from_centroids`,
  dead-centroid guarded), refreshable online via the session's
  ``partial_fit``.
"""

from repro_torch.vq.codebook import (
    KVCodebook,
    code_dtype_for,
    dequantize_cache,
    dequantize_rows,
    fit_kv_codebook,
    kv_cache_nbytes,
    load_codebook,
    quantize_cache,
    quantize_rows,
    random_kv_codebook,
    save_codebook,
)
from repro_torch.vq.decode import decode_quantized, generate_quantized, teacher_forced_nll
from repro_torch.vq.router import install_router, router_from_centroids, seed_router
from repro_torch.vq.source import CacheDumpSource, kv_dump_sources, n_kv_layers

__all__ = [
    "CacheDumpSource",
    "KVCodebook",
    "code_dtype_for",
    "decode_quantized",
    "dequantize_cache",
    "dequantize_rows",
    "fit_kv_codebook",
    "generate_quantized",
    "install_router",
    "kv_cache_nbytes",
    "kv_dump_sources",
    "load_codebook",
    "n_kv_layers",
    "quantize_cache",
    "quantize_rows",
    "random_kv_codebook",
    "router_from_centroids",
    "save_codebook",
    "seed_router",
    "teacher_forced_nll",
]
