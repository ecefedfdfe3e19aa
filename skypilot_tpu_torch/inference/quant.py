"""KV pool sizing by bytes and the weight footprint (the port's copy of
the pure arithmetic of skypilot_tpu/inference/quant.py `kv_page_bytes` /
`pool_pages_for_bytes` / `weight_num_bytes`, single device). Weight
quantization is not ported yet."""
from __future__ import annotations

import torch


def kv_page_bytes(cfg, kv_dtype: str) -> int:
    """Device bytes ONE physical KV page costs across all layers: K + V
    values, plus two f32 scale rows for int8 — the unit
    `--kv-pool-bytes` divides by, so a byte budget maps to the same
    memory for either storage format."""
    per_layer = 2 * cfg.num_kv_heads * cfg.kv_page_size * cfg.head_dim
    if kv_dtype == 'int8':
        value_bytes = per_layer
        scale_bytes = 2 * cfg.kv_page_size * 4
    else:
        value_bytes = per_layer * torch.empty((), dtype=cfg.dtype
                                              ).element_size()
        scale_bytes = 0
    return cfg.num_layers * (value_bytes + scale_bytes)


def pool_pages_for_bytes(cfg, kv_dtype: str, pool_bytes: int) -> int:
    """Physical pages a byte budget buys under `kv_dtype` (int8 fits
    about twice the pages of bf16 in the same bytes)."""
    pages = pool_bytes // kv_page_bytes(cfg, kv_dtype)
    if pages < 2:
        raise ValueError(
            f'--kv-pool-bytes {pool_bytes} buys {pages} pages '
            f'({kv_page_bytes(cfg, kv_dtype)} bytes/page across layers, '
            f'kv_dtype={kv_dtype}); need >= 2 (page 0 is the trash page)')
    return int(pages)


def weight_num_bytes(model) -> int:
    """Device bytes of a model's parameters (the
    skypilot_serving_weight_bytes gauge): numel x element size of each,
    host metadata only, no device read."""
    return int(sum(p.numel() * p.element_size()
                   for p in model.parameters()))
