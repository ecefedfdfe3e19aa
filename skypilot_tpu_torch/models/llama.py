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
  - dense (`DenseKVCache`, the one-shot engine's per-request cache
    [B, max_seq_len, Hkv, D], reference `llama.py:284-340`): S == 1
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


class PagedKVCache:
    """Per-layer page pools [Hkv, pages, page_size, D] (plus f32
    [pages, page_size] scale arrays for int8), preallocated on one
    device and updated in place by the model."""

    def __init__(self, config: LlamaConfig,
                 device: Optional[torch.device] = None) -> None:
        if config.kv_dtype not in ('bf16', 'int8'):
            raise ValueError(f'unsupported kv_dtype {config.kv_dtype!r} '
                             f"(choices: 'bf16', 'int8')")
        self.quantized = config.kv_dtype == 'int8'
        dtype = torch.int8 if self.quantized else config.dtype
        shape = (config.num_kv_heads, config.kv_total_pages,
                 config.kv_page_size, config.head_dim)
        sshape = (config.kv_total_pages, config.kv_page_size)
        self.layers: List[dict] = []
        for _ in range(config.num_layers):
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

    def zero_(self) -> None:
        for layer in self.layers:
            for t in layer.values():
                t.zero_()

    def num_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self.layers for t in layer.values())


class DenseKVCache:
    """The one-shot engine's per-request cache: per layer
    `cached_key` / `cached_value` [batch, max_seq_len, Hkv, D] in the
    compute dtype, zeroed (the reference's `cached_key` variables)."""

    def __init__(self, config: LlamaConfig, batch: int,
                 device: Optional[torch.device] = None) -> None:
        shape = (batch, config.max_seq_len, config.num_kv_heads,
                 config.head_dim)
        self.layers: List[dict] = [
            {'cached_key': torch.zeros(shape, dtype=config.dtype,
                                       device=device),
             'cached_value': torch.zeros(shape, dtype=config.dtype,
                                         device=device)}
            for _ in range(config.num_layers)]


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
    `Dense(dtype=...)` cast for training's f32 masters."""

    def __init__(self, d_in: int, d_out: int, config: LlamaConfig,
                 bias: bool = False) -> None:
        super().__init__(d_in, d_out, bias=bias,
                         dtype=config.param_dtype or config.dtype)
        self.compute_dtype = config.dtype
        self.requires_grad_(config.trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if weight.dtype != self.compute_dtype:   # f32 masters only
            weight = weight.to(self.compute_dtype)
            bias = bias.to(self.compute_dtype) if bias is not None else None
        return F.linear(x, weight, bias)


class Attention(nn.Module):

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        self.config = config
        cfg, hd = config, config.head_dim
        self.wq = Dense(cfg.embed_dim, cfg.num_heads * hd, cfg, cfg.qkv_bias)
        self.wk = Dense(cfg.embed_dim, cfg.num_kv_heads * hd, cfg,
                        cfg.qkv_bias)
        self.wv = Dense(cfg.embed_dim, cfg.num_kv_heads * hd, cfg,
                        cfg.qkv_bias)
        self.wo = Dense(cfg.num_heads * hd, cfg.embed_dim, cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[dict] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                lora_scale: float = 1.0,
                attend_len: Optional[int] = None) -> torch.Tensor:
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
        q = q.reshape(batch, seq, cfg.num_heads, hd)
        k = k.reshape(batch, seq, cfg.num_kv_heads, hd)
        v = v.reshape(batch, seq, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)

        if kv is None:
            out = attention_ops.dot_product_attention(q, k, v, causal=True)
        elif 'cached_key' in kv:
            if seq > 1:
                out = attention_ops.chunked_cache_attention(
                    q, k, v, kv['cached_key'], kv['cached_value'],
                    positions, chunk_only=prefill)
            else:
                out = attention_ops.cached_decode_attention(
                    q, k, v, kv['cached_key'], kv['cached_value'],
                    positions[:, 0])
            out = out.to(cfg.dtype)
        elif seq > 1:
            # A chunk of S tokens per row: write all of them, then either
            # attend chunk-locally (the sequence starts empty; reads the
            # chunk's own unquantized K/V) or the full paged history.
            if 'k_scales' in kv:
                paged_ops.write_kv_chunk_quant(
                    kv['k_pages'], kv['v_pages'], kv['k_scales'],
                    kv['v_scales'], k, v, positions, page_indices)
            else:
                paged_ops.write_kv_chunk(kv['k_pages'], kv['v_pages'], k,
                                         v, positions, page_indices)
            if prefill:
                out = attention_ops.dot_product_attention(q, k, v,
                                                          causal=True)
            else:
                out = paged_ops.paged_chunk_attention(
                    q, kv['k_pages'], kv['v_pages'], positions,
                    page_indices, k_scales=kv.get('k_scales'),
                    v_scales=kv.get('v_scales'),
                    attend_len=attend_len).to(cfg.dtype)
        else:
            # One decode token per row, each at its own position.
            if 'k_scales' in kv:
                paged_ops.write_kv_quant(
                    kv['k_pages'], kv['v_pages'], kv['k_scales'],
                    kv['v_scales'], k[:, 0], v[:, 0], positions[:, 0],
                    page_indices)
            else:
                paged_ops.write_kv(kv['k_pages'], kv['v_pages'], k[:, 0],
                                   v[:, 0], positions[:, 0], page_indices)
            out = paged_ops.paged_decode_attention(
                q[:, 0], kv['k_pages'], kv['v_pages'],
                lengths=positions[:, 0] + 1, page_indices=page_indices,
                k_scales=kv.get('k_scales'), v_scales=kv.get('v_scales'),
                attend_len=attend_len)
            out = out[:, None].to(cfg.dtype)
        out = out.reshape(batch, seq, cfg.num_heads * hd)
        return _lora('wo', self.wo(out), out, lora, adapter_ids, lora_scale)


class FeedForward(nn.Module):

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        cfg = config
        self.w_gate = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.w_up = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.w_down = Dense(cfg.mlp_dim, cfg.embed_dim, cfg)

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

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        cfg = config
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                 cfg.trainable)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                cfg.trainable)
        self.mlp = FeedForward(cfg)

    def forward(self, x, positions, kv=None, page_indices=None,
                prefill=False, lora=None, adapter_ids=None, lora_scale=1.0,
                attend_len=None):
        x = x + self.attn(self.attn_norm(x), positions, kv, page_indices,
                          prefill, lora, adapter_ids, lora_scale,
                          attend_len)
        return x + self.mlp(self.mlp_norm(x), lora, adapter_ids,
                            lora_scale)


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
    """

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        self.tok_embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim,
                        dtype=cfg.param_dtype or cfg.dtype),
            requires_grad=cfg.trainable)
        self.layers = nn.ModuleList(Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                  cfg.trainable)
        self.lm_head = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim,
                        dtype=torch.float32), requires_grad=cfg.trainable)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

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
