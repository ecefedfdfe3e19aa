"""DeepSeek-V2-family decoder in PyTorch: Multi-head Latent Attention
(port of skypilot_tpu/models/deepseek.py).

MLA caches a per-token latent (`kv_lora_rank` values, normed) and one
shared rotary key (`rope_head_dim` values) where a GQA model caches
K and V for every KV head: 576 values a token a layer at V2-Lite's
widths. The arithmetic and its dtypes are the reference's:
  - queries: `wq`, or `wq_a` -> `q_norm` -> `wq_b` when `q_lora_rank`
    > 0, split per head into a nope part and a rope part; the half-split
    RoPE runs on the rope part only;
  - latents: `wkv_a` gives [d_c + d_r]; `kv_norm` normalizes the first
    d_c, the last d_r are the shared rotary key (RoPE applied);
  - `wkv_b` [d_c, H, d_nope + d_v] is a raw parameter cast to `dtype`
    where it is used and split into W_uk (the nope columns) and W_uv;
  - with a cache (`LatentCache`: decode, chunked prefill, verify
    chunks) attention is ABSORBED: the chunk's latents are written at
    positions[:, 0] first (the start clamped as dynamic_update_slice
    clamps it), q_eff = q_nope . W_uk in f32, scores = (q_eff . latent
    + q_rope . rope) / sqrt(qk_head_dim) over every cache entry
    t <= positions[b, s] (chunk-local S x S with `prefill`), f32
    softmax, then ctx . W_uv in f32, cast to `dtype` before `wo`;
  - without a cache (training) K and V are decompressed from the
    chunk's latents in `dtype`, the rotary key broadcast over the heads,
    and `ops.attention.dot_product_attention` takes its unequal-dims
    route (q/k 192 dims, v 128 at V2-Lite) in f32;
  - the head multiplies `dtype` operands into f32 logits.
None of it is a Pallas kernel in the reference; here it is PyTorch ops.

The family has no page pool (the reference asserts `page_indices is
None`): the slot engine serves it on its dense path, one `LatentCache`
row a slot, and the config has no `kv_dtype` or pool fields.

Parameters (serving's layout, as Llama's): `tok_embed` [vocab, embed],
`layers.i.{attn_norm, attn.{wq | wq_a, q_norm, wq_b}, attn.{wkv_a,
kv_norm, wkv_b, wo}, mlp_norm, mlp.{w_gate, w_up, w_down}}`,
`final_norm`, `lm_head` [vocab, embed] f32 holding `dtype`-rounded
values; `wkv_b` stored in `dtype`. Training (`param_dtype=torch.float32`)
keeps every parameter an f32 master cast to `dtype` per use.

int8 projection weights (`Deepseek(cfg, weight_dtype='int8')`):
`wq`, `wo` and the SwiGLU's three projections are `llama.Int8Dense`,
exactly the 2-D `{kernel}` leaves the reference's `quantize_params`
quantizes; `wkv_a`, `wq_a`, `wq_b` and the 3-D `wkv_b` stay in `dtype`.
No LoRA: the reference's Deepseek takes no `lora`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from skypilot_tpu_torch.models.llama import (DENSE_CLASSES, Dense,
                                             FeedForward, RMSNorm, SlotCache,
                                             apply_rope)
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import fused_xent


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 102400
    max_seq_len: int = 4096
    num_layers: int = 27
    num_heads: int = 16
    embed_dim: int = 2048
    mlp_dim: int = 10944
    # MLA dims (DeepSeek-V2-Lite's): the latent cache rank, the decoupled
    # rotary dims and the no-position ("nope") head dims.
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 = full-rank queries (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # LM-head logits precision; None = f32.
    logits_dtype: Optional[torch.dtype] = None
    remat: bool = False
    # Storage dtype of the parameters (see llama.LlamaConfig).
    param_dtype: Optional[torch.dtype] = None

    @property
    def trainable(self) -> bool:
        return self.param_dtype is not None

    @classmethod
    def v2_lite(cls, **kw) -> 'DeepseekConfig':
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> 'DeepseekConfig':
        return cls(vocab_size=512, max_seq_len=256, num_layers=2,
                   num_heads=4, embed_dim=128, mlp_dim=384,
                   kv_lora_rank=32, q_lora_rank=0, rope_head_dim=16,
                   nope_head_dim=32, v_head_dim=32, **kw)

    @property
    def qk_head_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim


class LatentCache(SlotCache):
    """MLA's dense cache: per layer `latent_cache` [batch, max_seq_len,
    kv_lora_rank] and `rope_cache` [batch, max_seq_len, rope_head_dim]
    in the compute dtype, zeroed (the reference's cache variables).
    `num_layers` overrides the config's for a pipeline stage's rows."""

    def __init__(self, config: DeepseekConfig, batch: int,
                 device: Optional[torch.device] = None,
                 num_layers: Optional[int] = None) -> None:
        cfg = config
        self.values_per_token = cfg.kv_lora_rank + cfg.rope_head_dim

        def zeros(dim):
            return torch.zeros((batch, cfg.max_seq_len, dim),
                               dtype=cfg.dtype, device=device)

        self.layers: List[dict] = [
            {'latent_cache': zeros(cfg.kv_lora_rank),
             'rope_cache': zeros(cfg.rope_head_dim)}
            for _ in range(cfg.num_layers if num_layers is None
                           else num_layers)]


class MLAttention(nn.Module):
    """Multi-head latent attention with the absorbed cache path (module
    doc), called in two steps (the block's phases): `project`, then
    `attend` and `wo`."""

    def __init__(self, config: DeepseekConfig, dense=Dense) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        heads, qk = cfg.num_heads, cfg.qk_head_dim
        if cfg.q_lora_rank:
            self.wq_a = Dense(cfg.embed_dim, cfg.q_lora_rank, cfg)
            self.q_norm = RMSNorm(cfg.q_lora_rank, cfg.norm_eps, cfg.dtype,
                                  cfg.trainable)
            self.wq_b = Dense(cfg.q_lora_rank, heads * qk, cfg)
        else:
            self.wq = dense(cfg.embed_dim, heads * qk, cfg)
        self.wkv_a = Dense(cfg.embed_dim, cfg.kv_lora_rank + cfg.rope_head_dim,
                           cfg)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.norm_eps, cfg.dtype,
                               cfg.trainable)
        self.wkv_b = nn.Parameter(
            torch.empty(cfg.kv_lora_rank, heads,
                        cfg.nope_head_dim + cfg.v_head_dim,
                        dtype=cfg.param_dtype or cfg.dtype),
            requires_grad=cfg.trainable)
        self.wo = dense(heads * cfg.v_head_dim, cfg.embed_dim, cfg)
        # The heads this module computes: all of them, or a
        # tensor-parallel shard's (parallel/serving.py sets them).
        self.num_heads = heads

    def _queries(self, x: torch.Tensor):
        """(q_nope [B,S,H,d_nope], q_rope [B,S,H,d_rope]), RoPE not yet
        applied."""
        return self.head_queries(self.query_input(x))

    def query_input(self, x: torch.Tensor) -> torch.Tensor:
        """What the heads' query projection reads: x, or the normed
        low-rank query latent when `q_lora_rank` > 0 (whole on every
        tensor shard)."""
        if self.config.q_lora_rank:
            return self.q_norm(self.wq_a(x))
        return x

    def head_queries(self, q_in: torch.Tensor):
        """(q_nope, q_rope) of this module's heads from `query_input`."""
        cfg = self.config
        batch, seq, _ = q_in.shape
        q = (self.wq_b if cfg.q_lora_rank else self.wq)(q_in)
        q = q.reshape(batch, seq, self.num_heads, cfg.qk_head_dim)
        return q[..., :cfg.nope_head_dim], q[..., cfg.nope_head_dim:]

    def _latents(self, x: torch.Tensor, positions: torch.Tensor):
        """c_kv [B,S,d_c] (normed) and the shared rotary key k_rope
        [B,S,d_rope] (RoPE applied)."""
        cfg = self.config
        kv = self.wkv_a(x)
        c_kv = self.kv_norm(kv[..., :cfg.kv_lora_rank])
        k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                            cfg.rope_theta)[:, :, 0]
        return c_kv, k_rope

    def project(self, x: torch.Tensor, positions: torch.Tensor):
        """(q_nope, q_rope, c_kv, k_rope), RoPE applied."""
        q_nope, q_rope = self._queries(x)
        q_rope = apply_rope(q_rope, positions, self.config.rope_theta)
        return (q_nope, q_rope) + self._latents(x, positions)

    def attend(self, state, positions: torch.Tensor,
               kv: Optional[dict] = None,
               prefill: bool = False) -> torch.Tensor:
        cfg = self.config
        q_nope, q_rope, c_kv, k_rope = state
        batch, seq = q_nope.shape[:2]
        wkv_b = self.wkv_b.to(cfg.dtype)
        w_uk = wkv_b[..., :cfg.nope_head_dim]          # [d_c, H, d_n]
        w_uv = wkv_b[..., cfg.nope_head_dim:]          # [d_c, H, d_v]
        if kv is not None:
            # Absorbed attention against the latent cache, for any chunk:
            # the chunk's latents are written before attending, so stale
            # entries (rejected drafts, padded tails) are overwritten
            # first.
            start = positions[:, 0]
            attention_ops.write_rows(kv['latent_cache'], c_kv, start)
            attention_ops.write_rows(kv['rope_cache'], k_rope, start)
            q_eff = torch.einsum('bshn,chn->bshc', q_nope.float(),
                                 w_uk.float())
            if prefill:
                # The row starts empty: attend the chunk alone (S x S).
                k_lat, k_rop = c_kv.float(), k_rope.float()
                t = torch.arange(seq, device=c_kv.device)
                mask = (t[None, :] <= t[:, None])[None, None]
            else:
                k_lat = kv['latent_cache'].float()
                k_rop = kv['rope_cache'].float()
                t = torch.arange(k_lat.shape[1], device=c_kv.device)
                mask = (t[None, None, :]
                        <= positions.long()[:, :, None])[:, None]
            scores = (torch.einsum('bshc,btc->bhst', q_eff, k_lat)
                      + torch.einsum('bshr,btr->bhst', q_rope.float(),
                                     k_rop)) / (float(cfg.qk_head_dim) ** 0.5)
            scores = scores.masked_fill(~mask, float('-inf'))
            probs = torch.softmax(scores, dim=-1)
            ctx_lat = torch.einsum('bhst,btc->bshc', probs, k_lat)
            out = torch.einsum('bshc,chv->bshv', ctx_lat,
                               w_uv.float()).to(cfg.dtype)
        else:
            # Training: K and V decompressed from the chunk's latents,
            # attention at qk_head_dim with the value dim apart.
            k_nope = torch.einsum('btc,chn->bthn', c_kv, w_uk)
            v = torch.einsum('btc,chv->bthv', c_kv, w_uv)
            k = torch.cat([k_nope, k_rope[:, :, None].expand(
                batch, seq, self.num_heads, cfg.rope_head_dim)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            out = attention_ops.dot_product_attention(q, k, v, causal=True)
        out = out.reshape(batch, seq, self.num_heads * cfg.v_head_dim)
        return self.wo(out)


class Block(nn.Module):

    def __init__(self, config: DeepseekConfig, dense=Dense) -> None:
        super().__init__()
        cfg = config
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                 cfg.trainable)
        self.attn = MLAttention(cfg, dense)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                cfg.trainable)
        # llama's SwiGLU reads embed_dim / mlp_dim / dtype, as the
        # reference reuses it.
        self.mlp = FeedForward(cfg, dense)

    # The phases of a tensor-parallel grid (llama.Block's; MLA reads no
    # page table).
    def attn_qkv(self, x, positions):
        return self.attn.project(self.attn_norm(x), positions)

    def attn_out(self, state, positions, kv=None, page_indices=None,
                 prefill=False, attend_len=None):
        del page_indices, attend_len
        return self.attn.attend(state, positions, kv, prefill)

    def ffn(self, x):
        return self.mlp(self.mlp_norm(x))

    def forward(self, x, positions, kv=None, prefill=False, tensor=None):
        if tensor is not None:      # this rank's shard (parallel/tensor.py)
            return self.tensor_forward({tensor.index: self}, tensor, x,
                                       {tensor.index: positions})
        x = x + self.attn_out(self.attn_qkv(x, positions), positions, kv,
                              prefill=prefill)
        return x + self.ffn(x)

    @staticmethod
    def tensor_forward(blocks, group, x, positions):
        """The block over tensor shards (parallel/tensor.py; llama's
        `Block.tensor_forward`): the latent projections whole (as
        serving keeps them), the query heads, `wkv_b`'s heads and wo's
        rows on each shard, the partial outputs summed; training's
        unequal-dims attention runs on the shard's heads."""
        home = blocks[group.local[0]]
        attn = home.attn
        h = home.attn_norm(x)
        pos0 = positions[group.local[0]]
        c_kv, k_rope = attn._latents(h, pos0)
        qs = group.copy(attn.query_input(h))
        cs, rs = group.copy(c_kv), group.copy(k_rope)
        parts = {}
        for t, b in blocks.items():
            q_nope, q_rope = b.attn.head_queries(qs[t])
            q_rope = apply_rope(q_rope, positions[t], b.attn.config.rope_theta)
            parts[t] = b.attn.attend((q_nope, q_rope, cs[t], rs[t]),
                                     positions[t])
        x = x + group.reduce(parts)
        hs = group.copy(home.mlp_norm(x))
        return x + group.reduce({t: b.mlp(hs[t]) for t, b in blocks.items()})


class Deepseek(nn.Module):
    """DeepSeek decoder (module doc). `hidden`, `logits` and `forward`
    are Llama's interface, so the engines and the trainer drive it the
    same way; the cache is a `LatentCache` (`dense_cache`), never a
    page pool."""

    def __init__(self, config: DeepseekConfig,
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

    def dense_cache(self, batch: int) -> LatentCache:
        """A zeroed latent cache of `batch` rows on the model's device."""
        return LatentCache(self.config, batch, self.device)

    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[LatentCache] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False,
               attend_len: Optional[int] = None) -> torch.Tensor:
        """Final-norm hidden states [B, S, embed] in `dtype`; with a
        cache, the absorbed path (`prefill`: the rows start empty).
        `attend_len` is the paged families' and is unused here."""
        del attend_len
        if page_indices is not None:
            raise ValueError('MLA caches latents, not K/V pages: the '
                             'DeepSeek family serves from its dense '
                             'latent cache')
        cfg = self.config
        batch, seq = tokens.shape
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=tokens.device).expand(batch, seq)
        x = self.tok_embed[tokens].to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            args = (x, positions,
                    cache.layers[i] if cache is not None else None, prefill)
            x = (checkpoint.checkpoint(block, *args, use_reentrant=False)
                 if remat else block(*args))
        return self.final_norm(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of hidden states x [..., embed]: `dtype` operands, an
        f32 result (rounded to `logits_dtype` when one is set)."""
        cfg = self.config
        if not cfg.trainable:
            out = F.linear(x.float(), self.lm_head)
        else:
            dt = cfg.dtype
            out = fused_xent.mm_f32(x.to(dt).reshape(-1, x.shape[-1]),
                                    self.lm_head.to(dt).T)
            out = out.reshape(*x.shape[:-1], -1)
        if cfg.logits_dtype is not None:
            out = out.to(cfg.logits_dtype).float()
        return out

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[LatentCache] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        """f32 logits [B, S, vocab], or with `return_hidden` the
        final-norm hidden states (the trainer's fused loss)."""
        hidden = self.hidden(tokens, positions, cache, page_indices,
                             prefill)
        return hidden if return_hidden else self.logits(hidden)
