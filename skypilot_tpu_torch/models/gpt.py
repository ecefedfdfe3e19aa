"""GPT-2 decoder in PyTorch (port of skypilot_tpu/models/gpt.py).

LayerNorm with bias (statistics in f32, as flax's `LayerNorm` with its
fast variance: var = E[x^2] - E[x]^2, clipped at 0), a fused `c_attn`
split into q, k and v, multi-head attention with no rotary embedding,
a tanh-approximated GELU MLP (flax's `nn.gelu` default), a learned
position table `wpe` and a head tied to the token embedding `wte`.
Every dense layer has a bias.

The model is driven like the port's `Llama` (models/llama.py): `hidden`
takes the same cache modes (none, dense, paged chunk, paged decode; the
attention block ends in `llama.cache_attention`), `logits` maps hidden
states through the tied head, `forward(..., return_hidden=True)` gives
the trainer's fused loss its hidden states. The KV pool is
[num_heads, pages, page_size, head_dim]: `GPTConfig` has no
`num_kv_heads`, as the reference's has none (`llama.kv_heads` gives the
pool its heads, `llama.wire_kv_heads` the chain header its 0).

Reference contracts kept:
  - explicit positions index `wpe` CLAMPED to [0, block_size): a JAX
    gather clamps, so padded rows and speculative lookahead that reach
    block_size read its last row;
  - the head multiplies `dtype` operands into `cfg.logits_dtype or
    dtype` (bf16 logits for a bf16 config, unlike Llama's f32);
    `logits` returns them widened to f32 (exact), so argmax ties break
    on the same rounded values;
  - one tensor `wte` is the embedding and the head: in training its
    gradient is the sum of both uses.

Serving's layout (`param_dtype=None`): `wte`, `wpe`, the dense weights
and biases in `dtype`, LayerNorm scales and biases in f32, all frozen.
Training (`param_dtype=torch.float32`): every parameter an f32 master,
cast to `dtype` where it is used; `remat` recomputes each block in the
backward. No dropout (`dropout_rate` must be 0), no LoRA and no int8
projections: the reference's GPT takes neither.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from skypilot_tpu_torch.models.llama import (DenseKVCache, Dense,
                                             PagedKVCache, cache_attention)
from skypilot_tpu_torch.ops import fused_xent


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # nanoGPT's padded GPT-2 vocab
    block_size: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    dropout_rate: float = 0.0
    # GPT-2's LayerNorm epsilon (HF layer_norm_epsilon).
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Logits precision; None = `dtype` (see module doc).
    logits_dtype: Optional[torch.dtype] = None
    remat: bool = False
    # Paged KV cache for serving (see llama.LlamaConfig).
    kv_page_size: int = 16
    kv_total_pages: int = 128
    # Storage dtype of the parameters (see llama.LlamaConfig).
    param_dtype: Optional[torch.dtype] = None

    @property
    def trainable(self) -> bool:
        return self.param_dtype is not None

    @classmethod
    def gpt2_124m(cls, **kw) -> 'GPTConfig':
        return cls(num_layers=12, num_heads=12, embed_dim=768, **kw)

    @classmethod
    def tiny(cls, **kw) -> 'GPTConfig':
        return cls(vocab_size=512, block_size=128, num_layers=2,
                   num_heads=4, embed_dim=128, **kw)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def max_seq_len(self) -> int:
        """Alias matching the llama / mixtral configs (the serving
        engines read it)."""
        return self.block_size

    def num_params(self) -> int:
        wpe = self.block_size * self.embed_dim
        wte = self.vocab_size * self.embed_dim
        per_layer = (12 * self.embed_dim ** 2 + 13 * self.embed_dim)
        return wte + wpe + self.num_layers * per_layer + 2 * self.embed_dim


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(epsilon, dtype)`: f32 statistics with the fast
    variance, f32 scale and bias, the result cast to `dtype`."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 trainable: bool = False) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32),
                                  requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32),
                                 requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head attention, called in two steps (the block's phases):
    `qkv` from the fused `c_attn`, then `attend` and `c_proj`."""

    def __init__(self, config: GPTConfig) -> None:
        super().__init__()
        self.config = config
        e = config.embed_dim
        self.c_attn = Dense(e, 3 * e, config, bias=True)
        self.c_proj = Dense(e, e, config, bias=True)
        # The heads this module computes: all of them, or a
        # tensor-parallel shard's (parallel/serving.py sets them).
        self.num_heads = config.num_heads

    def qkv(self, x: torch.Tensor):
        """(q, k, v) [B, S, H, D] of the fused `c_attn`."""
        cfg = self.config
        batch, seq, _ = x.shape
        shape = (batch, seq, self.num_heads, cfg.head_dim)
        return tuple(t.reshape(shape).contiguous() for t in self.c_attn(
            x).split(self.num_heads * cfg.head_dim, dim=-1))

    def attend(self, qkv, positions: torch.Tensor,
               kv: Optional[dict] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False,
               attend_len: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        q, k, v = qkv
        batch, seq = q.shape[:2]
        out = cache_attention(q, k, v, positions, kv, page_indices, prefill,
                              attend_len, cfg.dtype)
        return self.c_proj(out.reshape(batch, seq,
                                       self.num_heads * cfg.head_dim))


class MLP(nn.Module):

    def __init__(self, config: GPTConfig) -> None:
        super().__init__()
        e = config.embed_dim
        self.c_fc = Dense(e, 4 * e, config, bias=True)
        self.c_proj = Dense(4 * e, e, config, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate='tanh'))


class Block(nn.Module):

    def __init__(self, config: GPTConfig) -> None:
        super().__init__()
        cfg = config
        self.ln_1 = LayerNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                              cfg.trainable)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                              cfg.trainable)
        self.mlp = MLP(cfg)

    # The phases of a tensor-parallel grid (llama.Block's).
    def attn_qkv(self, x, positions):
        del positions
        return self.attn.qkv(self.ln_1(x))

    def attn_out(self, qkv, positions, kv=None, page_indices=None,
                 prefill=False, attend_len=None):
        return self.attn.attend(qkv, positions, kv, page_indices, prefill,
                                attend_len)

    def ffn(self, x):
        return self.mlp(self.ln_2(x))

    def forward(self, x, positions, kv=None, page_indices=None,
                prefill=False, attend_len=None, tensor=None):
        if tensor is not None:      # this rank's shard (parallel/tensor.py)
            return self.tensor_forward({tensor.index: self}, tensor, x,
                                       {tensor.index: positions})
        x = x + self.attn_out(self.attn_qkv(x, positions), positions, kv,
                              page_indices, prefill, attend_len)
        return x + self.ffn(x)

    @staticmethod
    def tensor_forward(blocks, group, x, positions):
        """The block over tensor shards (parallel/tensor.py; llama's
        `Block.tensor_forward`): each shard's heads (its slice of every
        third of c_attn) and its slice of the MLP's hidden axis; the
        row-parallel c_proj biases are added once, after the sums."""
        from skypilot_tpu_torch.parallel.tensor import row_bias
        home = blocks[group.local[0]]
        dt = home.attn.config.dtype
        hs = group.copy(home.ln_1(x))
        x = x + (group.reduce({t: b.attn.attend(b.attn.qkv(hs[t]),
                                                positions[t])
                               for t, b in blocks.items()})
                 + row_bias(home.attn.c_proj, dt))
        hs = group.copy(home.ln_2(x))
        return x + (group.reduce({t: b.mlp(hs[t]) for t, b in blocks.items()})
                    + row_bias(home.mlp.c_proj, dt))


class GPT(nn.Module):
    """GPT-2 decoder. `forward` returns logits [B, S, vocab] (f32
    holding `logits_dtype or dtype` values); `hidden` returns the
    post-ln_f hidden states and `logits` maps them through the tied
    head."""

    #: Name of layer i's scope in the reference's cache tree.
    CACHE_PREFIX = 'h_'

    def __init__(self, config: GPTConfig, weight_dtype: str = 'bf16') -> None:
        super().__init__()
        if weight_dtype != 'bf16':
            raise ValueError(f'unsupported weight_dtype {weight_dtype!r} '
                             f'for GPT (its projections are never '
                             f'quantized)')
        if config.dropout_rate:
            raise ValueError(f'dropout_rate={config.dropout_rate}: the '
                             f'port runs GPT without dropout')
        cfg = config
        self.config = cfg
        self.weight_dtype = weight_dtype
        store = cfg.param_dtype or cfg.dtype
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim, dtype=store),
            requires_grad=cfg.trainable)
        self.wpe = nn.Parameter(
            torch.empty(cfg.block_size, cfg.embed_dim, dtype=store),
            requires_grad=cfg.trainable)
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                              cfg.trainable)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def dense_cache(self, batch: int) -> DenseKVCache:
        """A zeroed dense cache of `batch` rows on the model's device:
        the one-shot engine's, and the slot engine's dense path."""
        return DenseKVCache(self.config, batch, self.device)

    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[Union[PagedKVCache, DenseKVCache]] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False,
               attend_len: Optional[int] = None) -> torch.Tensor:
        """Post-ln_f hidden states [B, S, embed] in `dtype`; the cache
        modes and `attend_len` are Llama.hidden's."""
        cfg = self.config
        batch, seq = tokens.shape
        if seq > cfg.block_size:
            raise ValueError(f'{seq} tokens > block_size {cfg.block_size}')
        if isinstance(cache, DenseKVCache):
            if page_indices is not None:
                raise ValueError('a dense cache takes no page_indices')
        elif (cache is None) != (page_indices is None):
            raise ValueError('pass the paged cache and page_indices '
                             'together (or neither, for no-cache mode)')
        dt = cfg.dtype
        pos_embed = self.position_embed(positions, seq)
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=tokens.device).expand(batch, seq)
        x = self.wte[tokens].to(dt) + pos_embed
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            args = (x, positions,
                    cache.layers[i] if cache is not None else None,
                    page_indices, prefill, attend_len)
            x = (checkpoint.checkpoint(block, *args, use_reentrant=False)
                 if remat else block(*args))
        return self.ln_f(x)

    def position_embed(self, positions: Optional[torch.Tensor],
                       seq: int) -> torch.Tensor:
        """The `wpe` rows added to the token rows: [seq, embed] for
        positions 0.., else [B, S, embed] at `positions` clamped to the
        table."""
        dt = self.config.dtype
        if positions is None:
            return self.wpe[:seq].to(dt)
        return self.wpe[positions.clamp(
            0, self.config.block_size - 1).long()].to(dt)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of hidden states x [..., embed] through the tied head:
        `dtype` operands, a `logits_dtype or dtype` result, returned as
        f32 (a widening, exact)."""
        cfg = self.config
        dt = cfg.dtype
        y = fused_xent.mm_f32(x.to(dt).reshape(-1, x.shape[-1]),
                              self.wte.to(dt).T)
        return y.to(cfg.logits_dtype or dt).float().reshape(
            *x.shape[:-1], -1)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Union[PagedKVCache, DenseKVCache]] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        """Logits [B, S, vocab], or with `return_hidden` the post-ln_f
        hidden states, which the trainer's fused loss takes against the
        tied `wte` directly."""
        hidden = self.hidden(tokens, positions, cache, page_indices, prefill)
        return hidden if return_hidden else self.logits(hidden)
