"""Quantized serving storage (the port's copy of
skypilot_tpu/inference/quant.py): KV pool sizing by bytes on one device
of a serving grid, and int8 projection weights and their
tensor-parallel split.

Weights. The big projection matrices (wq/wk/wv/wo, w_gate/w_up/w_down)
are stored as int8 with one f32 scale per OUTPUT channel (symmetric
absmax over the input dim); embeddings, norms, biases and the LM head
stay in their serving dtype. `quantize_params` is the reference's
arithmetic on the reference's tree layout (numpy in, numpy out: the
bytes it gives are pinned to the reference's by tier-1), and
`quantize_kernel` the same arithmetic on one f32 `[in, out]` kernel as a
tensor, which the weight bridge (models/convert.py) and the HF importer
call one projection at a time. The reference dequantizes inside its
jitted serving functions, where XLA fuses the `int8 * scale` product
into the consuming matmul; the port's `Int8Dense` (models/llama.py) runs
every quantized projection through `ops/int8_linear.py`, whose CUDA
kernel converts the int8 weights on their way to the tensor cores, so
only int8 is streamed from device memory. `dequantize_params` is the
plain dense tree, for oracles.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import kv_heads

#: Projection modules quantized by default: the Llama-family big
#: matmuls (the GQA attention block + SwiGLU MLP), the same surfaces
#: LoRA covers (models/lora.py ALL_TARGETS).
WEIGHT_TARGETS: Tuple[str, ...] = ('wq', 'wk', 'wv', 'wo',
                                   'w_gate', 'w_up', 'w_down')
QUANT_KEY = 'kernel_q'
SCALE_KEY = 'kernel_scale'


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 [in, out], scale f32 [out]) of an `[in, out]` kernel,
    quantized from its f32 values: scale = max|w[:, j]| / 127, q =
    clip(round(w / scale), -127, 127) with round half to even (np.rint's
    rule), and scale 0 (q 0) for an all-zero column."""
    w = w.float()
    scale = w.abs().amax(dim=0) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(params: Dict[str, Any],
                    targets: Tuple[str, ...] = WEIGHT_TARGETS
                    ) -> Dict[str, Any]:
    """Per-output-channel symmetric int8 quantization of the targeted
    projection kernels of a reference-layout param tree; every other
    leaf passes through untouched (as numpy). scale[j] = max|W[:, j]| /
    127; W ~= q * scale."""

    def walk(node, name):
        if isinstance(node, dict):
            kernel = node.get('kernel') if name in targets else None
            if kernel is not None and getattr(kernel, 'ndim', 0) == 2:
                w = np.asarray(kernel, np.float32)
                amax = np.abs(w).max(axis=0)
                scale = (amax / 127.0).astype(np.float32)
                safe = np.where(scale > 0, scale, 1.0)
                q = np.clip(np.rint(w / safe), -127,
                            127).astype(np.int8)
                out = {QUANT_KEY: q, SCALE_KEY: scale}
                for key, val in node.items():
                    if key != 'kernel':
                        out[key] = np.asarray(val)
                return out
            return {key: walk(val, key) for key, val in node.items()}
        return node

    return walk(params, '')


def is_quantized(params: Any) -> bool:
    """True when the tree holds at least one quantized kernel."""
    if isinstance(params, dict):
        if QUANT_KEY in params:
            return True
        return any(is_quantized(v) for v in params.values())
    return False


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The dense tree of a quantized one: quantized kernels become f32
    `int8 * scale` products (numpy)."""

    def walk(node):
        if isinstance(node, dict):
            if QUANT_KEY in node:
                out = {key: val for key, val in node.items()
                       if key not in (QUANT_KEY, SCALE_KEY)}
                out['kernel'] = (np.asarray(node[QUANT_KEY], np.float32) *
                                 np.asarray(node[SCALE_KEY], np.float32))
                return out
            return {key: walk(val) for key, val in node.items()}
        return node

    return walk(params)


def kv_page_bytes(cfg, kv_dtype: str, shard_ways: int = 1,
                  stages: int = 1) -> int:
    """Device bytes ONE physical KV page costs across all layers ON ONE
    DEVICE of a serving grid (K + V values, plus two f32 scale rows for
    int8) — the unit `--kv-pool-bytes` divides by, so a byte budget maps
    to the same memory for either storage format (reference
    skypilot_tpu/inference/quant.py:151-191).

    `shard_ways` is how many ways the pool's kv-heads axis splits over
    the grid's `tensor` devices (parallel/serving.py kv_shard_ways): a
    device stores 1/shard_ways of the value bytes but the whole scale
    rows (one scale a token covers every head). `stages` splits the
    layers: a device of a stage holds pages of that stage's layers
    only, and the widest stage (ceil(num_layers / stages)) bounds it."""
    per_layer = 2 * kv_heads(cfg) * cfg.kv_page_size * cfg.head_dim
    if kv_heads(cfg) % shard_ways:
        raise ValueError(
            f'shard_ways={shard_ways} does not divide num_kv_heads='
            f'{kv_heads(cfg)} (the GQA remainder rule replicates '
            f'instead — pass shard_ways=1)')
    if stages < 1 or stages > cfg.num_layers:
        raise ValueError(f'stages={stages} must be in [1, num_layers='
                         f'{cfg.num_layers}]')
    if kv_dtype == 'int8':
        value_bytes = per_layer // shard_ways
        scale_bytes = 2 * cfg.kv_page_size * 4
    else:
        value_bytes = (per_layer // shard_ways *
                       torch.empty((), dtype=cfg.dtype).element_size())
        scale_bytes = 0
    stage_layers = -(-cfg.num_layers // stages)
    return stage_layers * (value_bytes + scale_bytes)


def pool_pages_for_bytes(cfg, kv_dtype: str, pool_bytes: int,
                         shard_ways: int = 1, stages: int = 1) -> int:
    """Physical pages a PER-DEVICE byte budget buys under `kv_dtype`
    (int8 fits about twice the pages of bf16 in the same bytes; a pool
    split `shard_ways` ways over the kv heads and `stages` ways over the
    layers fits about that many times more again)."""
    page = kv_page_bytes(cfg, kv_dtype, shard_ways, stages)
    pages = pool_bytes // page
    if pages < 2:
        raise ValueError(
            f'--kv-pool-bytes {pool_bytes} buys {pages} pages '
            f'({page} bytes/page across layers, '
            f'kv_dtype={kv_dtype}); need >= 2 (page 0 is the trash page)')
    return int(pages)


def quantized_leaf_axis(leaf: str, weight_axis):
    """The tensor-parallel split of an int8 projection's tensor, given
    the axis its dense [out, in] weight splits on (None: replicated) —
    the reference's `shard_quantized_for_serving` rule
    (skypilot_tpu/inference/quant.py:211-256): `weight_q` takes the
    weight's split, and `weight_scale` [out] splits with the output
    channels it scales (a column shard) or is whole on every shard (a
    row shard, whose outputs are partial sums of every channel)."""
    if leaf == 'weight_q':
        return weight_axis
    if leaf == 'weight_scale':
        return 0 if weight_axis == 0 else None
    raise ValueError(f'{leaf!r} is not an int8 projection tensor')


def weight_num_bytes(model) -> int:
    """Device bytes of a model's weights (the
    skypilot_serving_weight_bytes gauge): numel x element size of every
    tensor of its state — parameters and buffers, so int8 projections
    and their scales count — from host metadata, no device read."""
    return int(sum(t.numel() * t.element_size()
                   for t in model.state_dict().values()))
