"""Llama-3-family decoder in PyTorch (port of skypilot_tpu/models/llama.py).

RMSNorm, half-split rotary embeddings, grouped-query attention, SwiGLU
MLP, untied LM head; `qkv_bias` gives the Qwen2 variant. Numerics follow
the reference: projections run in `config.dtype`, norms and RoPE in f32,
and the LM head multiplies bf16-rounded operands with an f32 result.

Modes of `Llama.forward`:
  - no cache: teacher-forced causal attention over the input;
  - paged, S == 1: one decode token per row, K/V written into the pool
    and attention read through the paged kernel;
  - paged, S > 1, prefill=True: a chunk whose sequence starts empty
    attends its own K/V (the pool is written for later steps);
  - paged, S > 1, prefill=False: the chunk attends the row's full
    history through the page table;
  - dense (`DenseKVCache`, the one-shot engine's per-request cache and
    the slot engine's dense path, [B, max_seq_len, Hkv, D], reference
    `llama.py:284-340`): S == 1
    decodes one token per row, S > 1 writes a chunk (prefill=True
    attends it alone, else the row's whole history), with the
    reference's plain einsum attention.
The KV pool (`PagedKVCache`) is preallocated and updated in place; so
is a dense cache.

LoRA: `lora` = {'scale', 'layers': {'layer_i': {target: {'a', 'b'}}}}
(models/lora.py). Serving passes stacked factors `a [N, d_in, r]`,
`b [N, r, d_out]` with `adapter_ids` [B] selecting each row's adapter;
when wq, wk and wv all carry factors, their three deltas come from one
`fused_qkv_lora_delta` call. Training passes one adapter's factors
`a [d_in, r]`, `b [r, d_out]` and no `adapter_ids`. A projection's delta
is added to its output (bias included) before the reshape and RoPE.
With no `lora`, nothing LoRA runs.

Training (`LlamaConfig.param_dtype=torch.float32`): every parameter is
an f32 master, trainable, cast to `dtype` where it is used, as Flax
`Dense(dtype=...)` does with its f32 params; `remat` recomputes each
block in the backward. Serving keeps `param_dtype=None`: weights stored
in `dtype`, frozen.

int8 projection weights (`Llama(cfg, weight_dtype='int8')`, serve_lm
`--weight-dtype int8`): the seven projections are `Int8Dense`, int8
[out, in] buffers with one f32 scale per output channel (the reference's
`quantize_params` layout, transposed), run through
`ops/int8_linear.py`; the embedding, the norms, the biases and the head
stay as the config's layout says. The choice lives outside
`LlamaConfig`, as the reference keeps it in its `QuantizedModel` wrapper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import fused_xent
from skypilot_tpu_torch.ops import int8_linear
from skypilot_tpu_torch.ops import lora_kernel
from skypilot_tpu_torch.ops import paged_attention as paged_ops


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency rescaling (HF config.json `rope_scaling`):
    `llama3` is the Llama 3.1/3.2 long-context rule, `linear` classic
    position interpolation."""
    rope_type: str = 'llama3'
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    max_seq_len: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    embed_dim: int = 4096
    mlp_dim: int = 14336
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScaling] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Paged KV cache: page size in tokens and the physical page-pool
    # size; page 0 is the engine's trash page.
    kv_page_size: int = 16
    kv_total_pages: int = 128
    # 'bf16' stores pages in `dtype`; 'int8' stores int8 pages plus f32
    # per-page-slot scales.
    kv_dtype: str = 'bf16'
    # Qwen2-family variant: biases on the q/k/v projections.
    qkv_bias: bool = False
    # Storage dtype of the parameters. None is serving's layout:
    # projections, biases and the embedding stored in `dtype`, norm
    # scales in f32, the head in f32 holding `dtype`-rounded values, all
    # frozen. Training sets torch.float32: every parameter is a
    # trainable f32 master cast to `dtype` per use.
    param_dtype: Optional[torch.dtype] = None
    # Recompute each block's activations in the backward
    # (torch.utils.checkpoint), as the reference's nn.remat(Block).
    remat: bool = False

    @property
    def trainable(self) -> bool:
        return self.param_dtype is not None

    @classmethod
    def llama3_8b(cls, **kw) -> 'LlamaConfig':
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> 'LlamaConfig':
        return cls(vocab_size=512, max_seq_len=256, num_layers=2,
                   num_heads=4, num_kv_heads=2, embed_dim=128, mlp_dim=384,
                   **kw)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def rope_inv_freq(d_half: int, theta: float,
                  scaling: Optional[RopeScaling] = None,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-pair inverse frequencies [d_half] (f32), optionally rescaled."""
    exponent = torch.arange(d_half, dtype=torch.float32,
                            device=device) / d_half
    freqs = 1.0 / (theta ** exponent)
    if scaling is None:
        return freqs
    if scaling.rope_type == 'linear':
        return freqs / scaling.factor
    if scaling.rope_type != 'llama3':
        raise ValueError(f'unsupported rope_type {scaling.rope_type!r}')
    old_ctx = float(scaling.original_max_position_embeddings)
    low_wavelen = old_ctx / scaling.low_freq_factor
    high_wavelen = old_ctx / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (old_ctx / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    interp = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
    return torch.where(wavelen > low_wavelen, freqs / scaling.factor,
                       torch.where(wavelen < high_wavelen, freqs, interp))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """x: [B, S, H, D]; half-split rotary embedding on the last dim,
    computed in f32 from f32 positions."""
    d_half = x.shape[-1] // 2
    freqs = rope_inv_freq(d_half, theta, scaling, device=x.device)
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().split(d_half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def kv_heads(config) -> int:
    """KV heads of a config's pools: `num_kv_heads`, or `num_heads` for
    a multi-head family whose config has no such field (GPT)."""
    return int(getattr(config, 'num_kv_heads', 0) or config.num_heads)


def wire_kv_heads(config) -> int:
    """`num_kv_heads` as a KV chain's header carries it: 0 for a config
    without the field, as the reference writes it
    (`int(getattr(cfg, 'num_kv_heads', 0) or 0)`), so a GPT chain has
    the same bytes in both packages."""
    return int(getattr(config, 'num_kv_heads', 0) or 0)


def kv_dtype_of(config) -> str:
    """A config's KV page storage: its `kv_dtype`, or 'bf16' for a
    family whose config has no such field (GPT, Mixtral)."""
    return getattr(config, 'kv_dtype', 'bf16')


class LayerCache:
    """A model's cache: `layers`, one {name: tensor} dict a layer,
    preallocated on one device and written in place by the model."""

    layers: List[dict]

    def zero_(self) -> None:
        for layer in self.layers:
            for t in layer.values():
                t.zero_()

    def num_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self.layers for t in layer.values())

    # Whole physical pages of a paged pool, page-major (the KV chain's
    # wire rows, `paged_attention.gather_page_rows`): what export,
    # import, spill and migration move.
    def page_leaf_specs(self) -> List[tuple]:
        """(layer, leaf name, one page's row shape, dtype) of every
        leaf, in the order `gather_pages` returns them."""
        return [(i, name, (tuple(t.shape[:1]) + tuple(t.shape[2:])
                           if t.ndim == 4 else tuple(t.shape[1:])), t.dtype)
                for i, layer in enumerate(self.layers)
                for name, t in layer.items()]

    def gather_pages(self, idx: torch.Tensor) -> List[torch.Tensor]:
        """Rows of physical pages `idx` of every leaf."""
        return [paged_ops.gather_page_rows(t, idx)
                for layer in self.layers for t in layer.values()]

    def scatter_pages(self, idx: torch.Tensor,
                      rows: List[torch.Tensor]) -> None:
        """Write `gather_pages`-ordered rows into pages `idx`, in place."""
        leaves = [t for layer in self.layers for t in layer.values()]
        for leaf, r in zip(leaves, rows):
            paged_ops.scatter_page_rows(leaf, idx, r)


class PagedKVCache(LayerCache):
    """Per-layer page pools [Hkv, pages, page_size, D] (plus f32
    [pages, page_size] scale arrays for int8), preallocated on one
    device and updated in place by the model. Any family's config:
    `kv_heads` and `kv_dtype_of` read the fields it has. `heads` and
    `num_layers` override the config's for a tensor-parallel shard's or
    a pipeline stage's pool (parallel/serving.py)."""

    def __init__(self, config, device: Optional[torch.device] = None,
                 heads: Optional[int] = None,
                 num_layers: Optional[int] = None) -> None:
        kv_dtype = kv_dtype_of(config)
        if kv_dtype not in ('bf16', 'int8'):
            raise ValueError(f'unsupported kv_dtype {kv_dtype!r} '
                             f"(choices: 'bf16', 'int8')")
        self.quantized = kv_dtype == 'int8'
        dtype = torch.int8 if self.quantized else config.dtype
        shape = (heads or kv_heads(config), config.kv_total_pages,
                 config.kv_page_size, config.head_dim)
        sshape = (config.kv_total_pages, config.kv_page_size)
        self.layers: List[dict] = []
        for _ in range(config.num_layers if num_layers is None
                       else num_layers):
            layer = {'k_pages': torch.zeros(shape, dtype=dtype,
                                            device=device),
                     'v_pages': torch.zeros(shape, dtype=dtype,
                                            device=device)}
            if self.quantized:
                layer['k_scales'] = torch.zeros(sshape, dtype=torch.float32,
                                                device=device)
                layer['v_scales'] = torch.zeros(sshape, dtype=torch.float32,
                                                device=device)
            self.layers.append(layer)


class SlotCache(LayerCache):
    """A dense per-row cache: {name: [batch, max_seq_len, ...]} a layer.
    The one-shot engine holds one a request batch; the slot engine's
    dense path (models/batching.py) holds one row per slot and runs a
    slot's prefill on `row(slot)`, a view that writes through."""

    #: Cached values a token, a layer (the bytes model's unit).
    values_per_token: int

    def row(self, slot: int) -> 'SlotCache':
        """Row `slot` as a batch-1 cache of the same kind (views)."""
        view = object.__new__(type(self))
        view.__dict__.update(self.__dict__)
        view.layers = [{name: t[slot:slot + 1] for name, t in layer.items()}
                       for layer in self.layers]
        return view


class DenseKVCache(SlotCache):
    """Per layer `cached_key` / `cached_value` [batch, max_seq_len, Hkv,
    D] in the compute dtype, zeroed (the reference's `cached_key`
    variables). `heads` and `num_layers` as `PagedKVCache`'s."""

    def __init__(self, config, batch: int,
                 device: Optional[torch.device] = None,
                 heads: Optional[int] = None,
                 num_layers: Optional[int] = None) -> None:
        heads = heads or kv_heads(config)
        shape = (batch, config.max_seq_len, heads, config.head_dim)
        self.values_per_token = 2 * heads * config.head_dim
        self.layers: List[dict] = [
            {'cached_key': torch.zeros(shape, dtype=config.dtype,
                                       device=device),
             'cached_value': torch.zeros(shape, dtype=config.dtype,
                                         device=device)}
            for _ in range(config.num_layers if num_layers is None
                           else num_layers)]


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, kv: Optional[dict],
                    page_indices: Optional[torch.Tensor], prefill: bool,
                    attend_len: Optional[int], dtype: torch.dtype,
                    kv_amax: Optional[tuple] = None,
                    kv_heads: Optional[tuple] = None) -> torch.Tensor:
    """Causal attention of q [B, S, H, D] over this call's k / v
    [B, S, Hkv, D] and the layer's cache `kv`, in the mode the cache
    selects (module doc): none, dense, a paged chunk (S > 1) or one
    paged decode token per row. K/V are written into the cache first.
    Returns [B, S, H, D] in `dtype`. Every family's attention block
    (Llama, GPT, Mixtral) ends here.

    A tensor-parallel shard (parallel/serving.py) passes `kv_amax`, the
    (k, v) per-token absmax over every shard's kv heads, which an int8
    pool quantizes against, and under the GQA remainder rule `kv_heads`
    (lo, hi): k / v and the replicated cache hold every kv head, all of
    them are written, and this shard's q heads read heads [lo, hi)."""
    seq = q.shape[1]
    if kv is None:
        if kv_heads is not None:    # a tensor shard's heads, contiguous
            k, v, _ = _read_heads(k, v, {}, kv_heads)
            k, v = k.contiguous(), v.contiguous()
        return attention_ops.dot_product_attention(q, k, v, causal=True)
    if 'cached_key' in kv:
        if seq > 1:
            out = attention_ops.chunked_cache_attention(
                q, k, v, kv['cached_key'], kv['cached_value'], positions,
                chunk_only=prefill, kv_heads=kv_heads)
        else:
            out = attention_ops.cached_decode_attention(
                q, k, v, kv['cached_key'], kv['cached_value'],
                positions[:, 0], kv_heads=kv_heads)
        return out.to(dtype)
    if seq > 1:
        # A chunk of S tokens per row: write all of them, then either
        # attend chunk-locally (the sequence starts empty; reads the
        # chunk's own unquantized K/V) or the full paged history.
        if 'k_scales' in kv:
            paged_ops.write_kv_chunk_quant(
                kv['k_pages'], kv['v_pages'], kv['k_scales'],
                kv['v_scales'], k, v, positions, page_indices, kv_amax)
        else:
            paged_ops.write_kv_chunk(kv['k_pages'], kv['v_pages'], k, v,
                                     positions, page_indices)
        k, v, kv = _read_heads(k, v, kv, kv_heads)
        if prefill:
            return attention_ops.dot_product_attention(q, k, v,
                                                       causal=True)
        return paged_ops.paged_chunk_attention(
            q, kv['k_pages'], kv['v_pages'], positions, page_indices,
            k_scales=kv.get('k_scales'), v_scales=kv.get('v_scales'),
            attend_len=attend_len).to(dtype)
    # One decode token per row, each at its own position.
    if 'k_scales' in kv:
        paged_ops.write_kv_quant(
            kv['k_pages'], kv['v_pages'], kv['k_scales'], kv['v_scales'],
            k[:, 0], v[:, 0], positions[:, 0], page_indices,
            None if kv_amax is None else (kv_amax[0][:, 0],
                                          kv_amax[1][:, 0]))
    else:
        paged_ops.write_kv(kv['k_pages'], kv['v_pages'], k[:, 0], v[:, 0],
                           positions[:, 0], page_indices)
    _, _, kv = _read_heads(k, v, kv, kv_heads)
    out = paged_ops.paged_decode_attention(
        q[:, 0], kv['k_pages'], kv['v_pages'],
        lengths=positions[:, 0] + 1, page_indices=page_indices,
        k_scales=kv.get('k_scales'), v_scales=kv.get('v_scales'),
        attend_len=attend_len)
    return out[:, None].to(dtype)


def _read_heads(k: torch.Tensor, v: torch.Tensor, kv: dict,
                kv_heads: Optional[tuple]):
    """(k, v, pool) viewed on kv heads [lo, hi): the pool's value pages
    on their head axis (contiguous views), the per-token scales whole;
    the arguments themselves when `kv_heads` is None."""
    if kv_heads is None:
        return k, v, kv
    lo, hi = kv_heads
    pool = {name: (t[lo:hi] if name.endswith('_pages') else t)
            for name, t in kv.items()}
    return k[:, :, lo:hi], v[:, :, lo:hi], pool


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 trainable: bool = False) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32),
                                  requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale).to(self.dtype)


def _lora(name: str, y: torch.Tensor, x: torch.Tensor,
          lora: Optional[dict], adapter_ids: Optional[torch.Tensor],
          scale: float) -> torch.Tensor:
    """`y` plus projection `name`'s LoRA delta on input `x`; `y` itself
    when this layer carries no factors for it."""
    if lora is None or name not in lora:
        return y
    return lora_lib.apply_delta(y, x, lora[name], adapter_ids, scale)


class Dense(nn.Linear):
    """nn.Linear whose weight and bias are cast to the compute dtype
    where they are used: a no-op for serving's storage, the Flax
    `Dense(dtype=...)` cast for training's f32 masters. A tensor shard
    of a row-parallel projection (`partial_sum`, parallel/tensor.py)
    leaves its bias out: the block adds it once, after the sum."""

    def __init__(self, d_in: int, d_out: int, config: LlamaConfig,
                 bias: bool = False) -> None:
        super().__init__(d_in, d_out, bias=bias,
                         dtype=config.param_dtype or config.dtype)
        self.compute_dtype = config.dtype
        self.partial_sum = False
        self.requires_grad_(config.trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if self.partial_sum:
            bias = None
        if weight.dtype != self.compute_dtype:   # f32 masters only
            weight = weight.to(self.compute_dtype)
            bias = bias.to(self.compute_dtype) if bias is not None else None
        return F.linear(x, weight, bias)


class Int8Dense(nn.Module):
    """A projection stored as int8: buffers `weight_q` [out, in] int8
    and `weight_scale` [out] f32 (W ~= weight_q * weight_scale per
    output channel), and an unquantized `bias` stored as the config's
    layout says. `forward` is `int8_linear` in the compute dtype: the
    CUDA kernel on the card, the plain dequantize-then-linear on the
    CPU."""

    def __init__(self, d_in: int, d_out: int, config: LlamaConfig,
                 bias: bool = False) -> None:
        super().__init__()
        self.compute_dtype = config.dtype
        self.register_buffer('weight_q', torch.empty(d_out, d_in,
                                                     dtype=torch.int8))
        self.register_buffer('weight_scale', torch.empty(
            d_out, dtype=torch.float32))
        self.bias = (nn.Parameter(torch.empty(
            d_out, dtype=config.param_dtype or config.dtype),
            requires_grad=False) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias
        if bias is not None and bias.dtype != self.compute_dtype:
            bias = bias.to(self.compute_dtype)   # f32 masters only
        return int8_linear.int8_linear(x, self.weight_q, self.weight_scale,
                                       bias)


#: The projection class of each weight storage (`Llama(weight_dtype=)`).
DENSE_CLASSES = {'bf16': Dense, 'int8': Int8Dense}


class Attention(nn.Module):
    """Grouped-query attention, called in two steps (the block's
    phases): `qkv`, then `attend` over the cache and `wo`."""

    def __init__(self, config: LlamaConfig, dense=Dense) -> None:
        super().__init__()
        self.config = config
        cfg, hd = config, config.head_dim
        self.wq = dense(cfg.embed_dim, cfg.num_heads * hd, cfg, cfg.qkv_bias)
        self.wk = dense(cfg.embed_dim, cfg.num_kv_heads * hd, cfg,
                        cfg.qkv_bias)
        self.wv = dense(cfg.embed_dim, cfg.num_kv_heads * hd, cfg,
                        cfg.qkv_bias)
        self.wo = dense(cfg.num_heads * hd, cfg.embed_dim, cfg)
        # The heads this module computes: all of them, or a
        # tensor-parallel shard's (parallel/tensor.py sets them), and
        # under the GQA remainder rule the kv heads [lo, hi) its q heads
        # read.
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.read_heads = None

    def shard_tensor(self, index: int, ways: int, kv_split: bool,
                     read_heads=None):
        """Keep tensor shard `index` of `ways`: wq (and wk / wv when
        the kv heads split) column-parallel over heads, wo row-parallel
        (parallel/tensor.py's table); returns the leaves' splits."""
        from skypilot_tpu_torch.parallel import tensor
        return tensor.shard_block(self, index, ways, kv_split, read_heads,
                                  prefix='attn')

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            lora: Optional[dict] = None,
            adapter_ids: Optional[torch.Tensor] = None,
            lora_scale: float = 1.0):
        """(q [B,S,H,D], k, v [B,S,Hkv,D]): projections, LoRA deltas and
        RoPE."""
        cfg = self.config
        batch, seq, _ = x.shape
        hd = cfg.head_dim
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if adapter_ids is not None and lora is not None and all(
                t in lora for t in ('wq', 'wk', 'wv')):
            dq, dk, dv = lora_kernel.fused_qkv_lora_delta(
                x, lora['wq'], lora['wk'], lora['wv'], adapter_ids)
            q = q + (lora_scale * dq).to(q.dtype)
            k = k + (lora_scale * dk).to(k.dtype)
            v = v + (lora_scale * dv).to(v.dtype)
        else:
            q = _lora('wq', q, x, lora, adapter_ids, lora_scale)
            k = _lora('wk', k, x, lora, adapter_ids, lora_scale)
            v = _lora('wv', v, x, lora, adapter_ids, lora_scale)
        q = q.reshape(batch, seq, self.num_heads, hd)
        k = k.reshape(batch, seq, self.num_kv_heads, hd)
        v = v.reshape(batch, seq, self.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        return q, k, v

    def attend(self, qkv, positions: torch.Tensor,
               kv: Optional[dict] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False, lora: Optional[dict] = None,
               adapter_ids: Optional[torch.Tensor] = None,
               lora_scale: float = 1.0, attend_len: Optional[int] = None,
               kv_amax: Optional[tuple] = None,
               kv_heads: Optional[tuple] = None) -> torch.Tensor:
        """`cache_attention` over `qkv`, then `wo` (and its LoRA delta)."""
        cfg = self.config
        q, k, v = qkv
        batch, seq = q.shape[:2]
        if kv_heads is None:
            kv_heads = self.read_heads
        out = cache_attention(q, k, v, positions, kv, page_indices, prefill,
                              attend_len, cfg.dtype, kv_amax, kv_heads)
        out = out.reshape(batch, seq, self.num_heads * cfg.head_dim)
        return _lora('wo', self.wo(out), out, lora, adapter_ids, lora_scale)


class FeedForward(nn.Module):

    def __init__(self, config: LlamaConfig, dense=Dense) -> None:
        super().__init__()
        cfg = config
        self.w_gate = dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.w_up = dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.w_down = dense(cfg.mlp_dim, cfg.embed_dim, cfg)

    def shard_tensor(self, index: int, ways: int):
        """Keep tensor shard `index` of `ways`: w_gate / w_up
        column-parallel over the hidden axis, w_down row-parallel."""
        from skypilot_tpu_torch.parallel import tensor
        return tensor.shard_block(self, index, ways, True, prefix='mlp')

    def forward(self, x: torch.Tensor, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                lora_scale: float = 1.0) -> torch.Tensor:
        gate = _lora('w_gate', self.w_gate(x), x, lora, adapter_ids,
                     lora_scale)
        up = _lora('w_up', self.w_up(x), x, lora, adapter_ids, lora_scale)
        h = F.silu(gate) * up
        return _lora('w_down', self.w_down(h), h, lora, adapter_ids,
                     lora_scale)


class Block(nn.Module):

    def __init__(self, config: LlamaConfig, dense=Dense) -> None:
        super().__init__()
        cfg = config
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                 cfg.trainable)
        self.attn = Attention(cfg, dense)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                cfg.trainable)
        self.mlp = FeedForward(cfg, dense)

    # The block in three phases, the seams where a tensor-parallel
    # grid (parallel/serving.py) sums its shards' partial outputs: every
    # family's block has them.
    def attn_qkv(self, x, positions, lora=None, adapter_ids=None,
                 lora_scale=1.0):
        return self.attn.qkv(self.attn_norm(x), positions, lora,
                             adapter_ids, lora_scale)

    def attn_out(self, qkv, positions, kv=None, page_indices=None,
                 prefill=False, attend_len=None, lora=None,
                 adapter_ids=None, lora_scale=1.0, kv_amax=None,
                 kv_heads=None):
        return self.attn.attend(qkv, positions, kv, page_indices, prefill,
                                lora, adapter_ids, lora_scale, attend_len,
                                kv_amax, kv_heads)

    def ffn(self, x, lora=None, adapter_ids=None, lora_scale=1.0):
        return self.mlp(self.mlp_norm(x), lora, adapter_ids, lora_scale)

    def forward(self, x, positions, kv=None, page_indices=None,
                prefill=False, lora=None, adapter_ids=None, lora_scale=1.0,
                attend_len=None, tensor=None):
        if tensor is not None:      # this rank's shard (parallel/tensor.py)
            return self.tensor_forward(
                {tensor.index: self}, tensor, x, {tensor.index: positions},
                None if lora is None else {tensor.index: lora}, lora_scale)
        qkv = self.attn_qkv(x, positions, lora, adapter_ids, lora_scale)
        x = x + self.attn_out(qkv, positions, kv, page_indices, prefill,
                              attend_len, lora, adapter_ids, lora_scale)
        return x + self.ffn(x, lora, adapter_ids, lora_scale)

    @staticmethod
    def tensor_forward(blocks, group, x, positions, lora=None,
                       lora_scale=1.0):
        """The block over tensor shards (parallel/tensor.py): `blocks`
        {shard: its Block}, `positions` {shard: positions}, `lora`
        {shard: the layer's factor slices} or None; x the whole
        residual stream."""
        lora = lora or {}
        x = attention_step(blocks, group, x, positions, 'attn_norm', lora,
                           lora_scale)
        home = blocks[group.local[0]]
        hs = group.copy(home.mlp_norm(x))
        return x + group.reduce({t: b.mlp(hs[t], lora.get(t), None,
                                          lora_scale)
                                 for t, b in blocks.items()})


def attention_step(blocks, group, x, positions, norm: str, lora=None,
                   lora_scale=1.0):
    """x plus the attention of a GQA block over tensor shards: the
    norm whole, q / k / v and the heads on each shard, wo's partial
    outputs summed (Llama's and Mixtral's first half)."""
    lora = lora or {}
    home = blocks[group.local[0]]
    hs = group.copy(getattr(home, norm)(x))
    parts = {}
    for t, b in blocks.items():
        qkv = b.attn.qkv(hs[t], positions[t], lora.get(t), None, lora_scale)
        parts[t] = b.attn.attend(qkv, positions[t], lora=lora.get(t),
                                 lora_scale=lora_scale)
    return x + group.reduce(parts)


class Llama(nn.Module):
    """Llama decoder. `forward` returns f32 logits [B, S, vocab];
    `hidden` returns the final-norm hidden states and `logits` maps
    them through the LM head (serving computes logits only for the rows
    it samples from).

    Parameters (serving's layout): `tok_embed` [vocab, embed] in
    `dtype`; `lm_head` [vocab, embed] in f32 holding bf16-rounded values
    (for a bf16 config), so the head's product is bf16 operands with an
    f32 result. With `param_dtype` set (training) both are f32 masters
    cast to `dtype` per use, which is the same product.

    `weight_dtype` 'int8' makes the seven projections `Int8Dense`
    (serving only: int8 buffers take no gradient).
    """

    #: Name of layer i's scope in the reference's cache tree (the KV
    #: chain's leaf paths, `['layer_{i}']['attn']['k_pages']`).
    CACHE_PREFIX = 'layer_'

    def __init__(self, config: LlamaConfig,
                 weight_dtype: str = 'bf16') -> None:
        super().__init__()
        if weight_dtype not in DENSE_CLASSES:
            raise ValueError(f'unsupported weight_dtype {weight_dtype!r} '
                             f'(choices: {", ".join(DENSE_CLASSES)})')
        cfg = config
        self.config = cfg
        self.weight_dtype = weight_dtype
        self.tok_embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim,
                        dtype=cfg.param_dtype or cfg.dtype),
            requires_grad=cfg.trainable)
        dense = DENSE_CLASSES[weight_dtype]
        self.layers = nn.ModuleList(Block(cfg, dense)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                  cfg.trainable)
        self.lm_head = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim,
                        dtype=torch.float32), requires_grad=cfg.trainable)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def dense_cache(self, batch: int) -> DenseKVCache:
        """A zeroed dense cache of `batch` rows on the model's device:
        the one-shot engine's, and the slot engine's dense path."""
        return DenseKVCache(self.config, batch, self.device)

    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[Union[PagedKVCache, DenseKVCache]] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False, lora: Optional[dict] = None,
               adapter_ids: Optional[torch.Tensor] = None,
               attend_len: Optional[int] = None) -> torch.Tensor:
        """Final-norm hidden states [B, S, embed] in `dtype`. `lora` =
        {'scale', 'layers'}: stacked factors with `adapter_ids` [B]
        picking each row's adapter, or one adapter's factors with no
        `adapter_ids` (see module doc). `attend_len` (a serving engine's
        max_total_len) is the width the paged kernel cuts the page
        table for, so that rows below it get the same bits from tables
        of any width (ops/paged_kernel.py, `split_plan`)."""
        cfg = self.config
        batch, seq = tokens.shape
        if adapter_ids is not None and lora is None:
            raise ValueError('adapter_ids select rows of stacked lora '
                             'factors; pass lora too')
        lora_scale = float(lora['scale']) if lora is not None else 1.0
        lora_layers = lora['layers'] if lora is not None else {}
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=tokens.device).expand(batch, seq)
        if isinstance(cache, DenseKVCache):
            if page_indices is not None:
                raise ValueError('a dense cache takes no page_indices')
        elif (cache is None) != (page_indices is None):
            raise ValueError('pass the paged cache and page_indices '
                             'together (or neither, for no-cache mode)')
        x = self.tok_embed[tokens].to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            args = (x, positions,
                    cache.layers[i] if cache is not None else None,
                    page_indices, prefill, lora_layers.get(f'layer_{i}'),
                    adapter_ids, lora_scale, attend_len)
            x = (checkpoint.checkpoint(block, *args, use_reentrant=False)
                 if remat else block(*args))
        return self.final_norm(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of hidden states x [..., embed]: `dtype` operands,
        f32 result."""
        if not self.config.trainable:
            return F.linear(x.float(), self.lm_head)
        dt = self.config.dtype
        flat = fused_xent.mm_f32(x.to(dt).reshape(-1, x.shape[-1]),
                                 self.lm_head.to(dt).T)
        return flat.reshape(*x.shape[:-1], -1)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Union[PagedKVCache, DenseKVCache]] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """f32 logits [B, S, vocab], or with `return_hidden` the
        final-norm hidden states, which the trainer's fused loss
        (ops/fused_xent.py) takes against `lm_head` directly."""
        hidden = self.hidden(tokens, positions, cache, page_indices,
                             prefill, lora, adapter_ids)
        return hidden if return_hidden else self.logits(hidden)
