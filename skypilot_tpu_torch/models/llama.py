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
    history through the page table.
The KV pool (`PagedKVCache`) is preallocated and updated in place.

Multi-LoRA: `lora` = {'scale', 'layers': {'layer_i': {target: {'a': [N,
d_in, r], 'b': [N, r, d_out]}}}} (models/lora.py) with `adapter_ids`
[B] selecting each row's stacked factors. A projection's delta is
added to its output (bias included) before the reshape and RoPE; when
wq, wk and wv all carry factors, their three deltas come from one
`fused_qkv_lora_delta` call. With no `lora`, nothing LoRA runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.ops import attention as attention_ops
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


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32),
                                  requires_grad=False)

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


def _linear(d_in: int, d_out: int, dtype: torch.dtype,
            bias: bool = False) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=bias, dtype=dtype)
    layer.requires_grad_(False)
    return layer


class Attention(nn.Module):

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        self.config = config
        cfg, hd = config, config.head_dim
        self.wq = _linear(cfg.embed_dim, cfg.num_heads * hd, cfg.dtype,
                          cfg.qkv_bias)
        self.wk = _linear(cfg.embed_dim, cfg.num_kv_heads * hd, cfg.dtype,
                          cfg.qkv_bias)
        self.wv = _linear(cfg.embed_dim, cfg.num_kv_heads * hd, cfg.dtype,
                          cfg.qkv_bias)
        self.wo = _linear(cfg.num_heads * hd, cfg.embed_dim, cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[dict] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                lora_scale: float = 1.0) -> torch.Tensor:
        cfg = self.config
        batch, seq, _ = x.shape
        hd = cfg.head_dim
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if lora is not None and all(t in lora for t in ('wq', 'wk', 'wv')):
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
                    v_scales=kv.get('v_scales')).to(cfg.dtype)
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
                k_scales=kv.get('k_scales'), v_scales=kv.get('v_scales'))
            out = out[:, None].to(cfg.dtype)
        out = out.reshape(batch, seq, cfg.num_heads * hd)
        return _lora('wo', self.wo(out), out, lora, adapter_ids, lora_scale)


class FeedForward(nn.Module):

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        cfg = config
        self.w_gate = _linear(cfg.embed_dim, cfg.mlp_dim, cfg.dtype)
        self.w_up = _linear(cfg.embed_dim, cfg.mlp_dim, cfg.dtype)
        self.w_down = _linear(cfg.mlp_dim, cfg.embed_dim, cfg.dtype)

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
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype)
        self.mlp = FeedForward(cfg)

    def forward(self, x, positions, kv=None, page_indices=None,
                prefill=False, lora=None, adapter_ids=None, lora_scale=1.0):
        x = x + self.attn(self.attn_norm(x), positions, kv, page_indices,
                          prefill, lora, adapter_ids, lora_scale)
        return x + self.mlp(self.mlp_norm(x), lora, adapter_ids,
                            lora_scale)


class Llama(nn.Module):
    """Llama decoder. `forward` returns f32 logits [B, S, vocab];
    `hidden` returns the final-norm hidden states and `logits` maps
    them through the LM head (serving computes logits only for the rows
    it samples from).

    Parameters: `tok_embed` [vocab, embed] in `dtype`; `lm_head`
    [vocab, embed] in f32 holding bf16-rounded values (for a bf16
    config), so the head's product is bf16 operands with an f32 result.
    """

    def __init__(self, config: LlamaConfig) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        self.tok_embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim, dtype=cfg.dtype),
            requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype)
        self.lm_head = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim,
                        dtype=torch.float32), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[PagedKVCache] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False, lora: Optional[dict] = None,
               adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`lora` = {'scale', 'layers'} with stacked factors and
        `adapter_ids` [B] picking each row's adapter (see module doc);
        single-adapter (training) factors are not ported yet."""
        batch, seq = tokens.shape
        if (lora is None) != (adapter_ids is None):
            raise ValueError('pass lora and adapter_ids together (stacked '
                             'factors; single-adapter mode is not ported)')
        lora_scale = float(lora['scale']) if lora is not None else 1.0
        lora_layers = lora['layers'] if lora is not None else {}
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=tokens.device).expand(batch, seq)
        if (cache is None) != (page_indices is None):
            raise ValueError('pass the paged cache and page_indices '
                             'together (or neither, for no-cache mode)')
        x = self.tok_embed[tokens]
        for i, block in enumerate(self.layers):
            x = block(x, positions,
                      cache.layers[i] if cache is not None else None,
                      page_indices, prefill, lora_layers.get(f'layer_{i}'),
                      adapter_ids, lora_scale)
        return self.final_norm(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.lm_head)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[PagedKVCache] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.logits(self.hidden(tokens, positions, cache,
                                       page_indices, prefill, lora,
                                       adapter_ids))
