"""Mixtral-family sparse-MoE decoder in PyTorch (port of
skypilot_tpu/models/mixtral.py).

The Llama backbone (the port's `llama.Attention` and `RMSNorm`, on
`MixtralConfig.as_llama()`) with a top-k routed SwiGLU MoE in place of
the MLP. `MoEFeedForward` is the reference's arithmetic, dtypes
included:
  - the router runs in f32 on x cast to f32; softmax, then the top-k
    probabilities, renormalized. The top-k is a stable descending sort,
    so equal probabilities pick the lower expert first, as
    `jax.lax.top_k` does;
  - capacity = max(int(capacity_factor * S * top_k / E), top_k), a
    Python int from the CALL's (padded) S;
  - each (token, k) assignment's slot in its expert's queue is the
    count of earlier assignments to that expert over the [B, S * K]
    flattening (token-major, k-minor); an assignment at or past
    capacity is dropped, so its token gets nothing from that expert;
  - dispatch and combine are dense einsums over [B, S, E, C]: the
    expert inputs gathered in f32 and cast to `dtype`, the SwiGLU
    experts in `dtype` on stacked [E, in, out] weights, the combine in
    f32;
  - the Switch load-balancing loss E * sum(assign_frac * prob_frac) / K.
Under the sharded trainer's `expert` axis (`shard_experts`, train_lm
--expert) a rank holds E / expert of each stack and computes its own
experts' inputs and outputs; the batch is replicated over `expert`, so
the combine is a sum over the expert group, not an all-to-all (the
reference's compiled step holds none). Under its `seq` axis (an active
ring, parallel/context.py) the capacity and queue slots are the whole
sequence's. Nothing in it has a data-dependent shape or reads a device
value on the host, so a decode round stays capturable in a CUDA graph. Dropping
follows the padded chunk length: chunked prefill, speculative verify
chunks and prefix hits give other tokens than whole-prompt prefill, in
the reference as well; a decode round (S = 1, capacity 2 >= top_k)
drops nothing.

`forward` returns (logits, aux) in training (no cache), where aux is
`router_aux_loss_weight * sum over layers / num_layers`, and with
`return_hidden` (hidden, aux); with a cache (serving) it returns logits
or hidden states alone. `hidden` and `logits` are the serving engines'
interface, as `Llama`'s. Layouts (serving and training) are Llama's,
with the router stored f32 in both (the reference's router is an f32
Dense) and the expert stacks `[E, embed, mlp]` (`w_gate`, `w_up`) and
`[E, mlp, embed]` (`w_down`) as the reference stores them. No LoRA: the
reference's Mixtral takes no `lora`.

int8 projection weights (`Mixtral(cfg, weight_dtype='int8')`, serve_lm
`--weight-dtype int8`): the four attention projections are
`llama.Int8Dense`, run through `ops/int8_linear.py`; the expert stacks
stay in `dtype`, as the reference's `quantize_params` leaves them (they
are array leaves, not `{kernel}` dicts), and so do the router, the
norms, the embedding and the head.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from skypilot_tpu_torch.models.llama import (DENSE_CLASSES, Attention,
                                             Dense, DenseKVCache,
                                             LlamaConfig,
                                             PagedKVCache, RMSNorm,
                                             RopeScaling, attention_step)
from skypilot_tpu_torch.ops import fused_xent
from skypilot_tpu_torch.parallel import context as cp_context
from skypilot_tpu_torch.parallel import tensor as tensor_lib


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    max_seq_len: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    embed_dim: int = 4096
    mlp_dim: int = 14336
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_loss_weight: float = 0.02
    rope_theta: float = 1_000_000.0
    rope_scaling: Optional[RopeScaling] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # LM-head logits precision; None = f32 (see llama.LlamaConfig).
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
    def mixtral_8x7b(cls, **kw) -> 'MixtralConfig':
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> 'MixtralConfig':
        return cls(vocab_size=512, max_seq_len=256, num_layers=2,
                   num_heads=4, num_kv_heads=2, embed_dim=128, mlp_dim=256,
                   num_experts=4, experts_per_token=2, **kw)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, max_seq_len=self.max_seq_len,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, embed_dim=self.embed_dim,
            mlp_dim=self.mlp_dim, rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling,
            norm_eps=self.norm_eps, dtype=self.dtype, remat=self.remat,
            kv_page_size=self.kv_page_size,
            kv_total_pages=self.kv_total_pages,
            param_dtype=self.param_dtype)


class MoEFeedForward(nn.Module):
    """Top-k routed SwiGLU experts through capacity-bounded dispatch
    (module doc). Parameters: `router` [E, embed] f32 (an nn.Linear's
    layout), `w_gate` / `w_up` [E, embed, mlp], `w_down` [E, mlp,
    embed]."""

    def __init__(self, config: MixtralConfig) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        e, d, f = cfg.num_experts, cfg.embed_dim, cfg.mlp_dim
        store = cfg.param_dtype or cfg.dtype

        def param(*shape, dtype=store):
            return nn.Parameter(torch.empty(shape, dtype=dtype),
                                requires_grad=cfg.trainable)

        self.router = param(e, d, dtype=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        #: The process group of the ranks holding other tokens of the
        #: batch (parallel/fsdp.py: data, fsdp and seq); None when this
        #: rank holds them all.
        self.batch_group = None
        #: Under expert parallelism (`shard_experts`): the expert group
        #: and this rank's experts [lo, hi); None on one rank.
        self.expert_group = None
        self.experts = (0, e)

    def shard_experts(self, group, index: int, count: int
                      ) -> Tuple[str, ...]:
        """Keep experts [index * E / count, (index + 1) * E / count) of
        each stack (rank `index` of `count` on the expert `group`), as
        the reference's 'expert' -> 'expert' rule shards them; returns
        the names of the parameters sliced."""
        num_exp = self.config.num_experts
        if num_exp % count:
            raise ValueError(f'{num_exp} experts do not split over '
                             f'expert = {count} ranks')
        lo, hi = index * num_exp // count, (index + 1) * num_exp // count
        names = ('w_gate', 'w_up', 'w_down')
        for name in names:
            whole = getattr(self, name)
            setattr(self, name, nn.Parameter(
                whole.detach()[lo:hi].clone(),
                requires_grad=whole.requires_grad))
        self.expert_group, self.experts = group, (lo, hi)
        return names

    def shard_tensor(self, index: int, ways: int):
        """Keep tensor shard `index` of `ways` of each expert's hidden
        axis (the 'mlp' -> 'tensor' rule: w_gate / w_up columns, w_down
        rows; the router stays whole); composes with `shard_experts` in
        either order. Returns the leaves' splits."""
        return tensor_lib.shard_block(self, index, ways, True, prefix='moe')

    def route(self, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
        """(dispatch, combine [B, S, E, C] f32, the one-hot picks
        [B, S, K, E], the router probabilities [B, S, E]) of x
        [B, S, embed]. Under an active ring (parallel/context.py) x is
        this rank's block of the sequence and the capacity and each
        assignment's queue slot are the whole sequence's: the queues
        start after the assignments of the ring's earlier blocks. Under
        expert parallelism the routing weights enter the combine
        through `copy_to_experts` (their gradient is the expert group's
        sum)."""
        cfg = self.config
        batch, seq, _ = x.shape
        num_exp, top_k = cfg.num_experts, cfg.experts_per_token
        ring = cp_context.active_seq_group()
        probs = torch.softmax(F.linear(x.float(), self.router), dim=-1)
        top_w, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        top_w, top_idx = top_w[..., :top_k], top_idx[..., :top_k]
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        if self.expert_group is not None:
            top_w = copy_to_experts(top_w, self.expert_group)
        total = seq * (ring.size if ring is not None else 1)
        capacity = max(int(cfg.capacity_factor * total * top_k / num_exp),
                       top_k)
        picks = (top_idx[..., None] == torch.arange(
            num_exp, device=x.device)).float()                 # [B,S,K,E]
        flat = picks.reshape(batch, seq * top_k, num_exp)
        queue = torch.cumsum(flat, dim=1) - flat
        if ring is not None:
            queue = queue + _earlier_blocks(flat.sum(dim=1), ring)[:, None]
        queue = queue.reshape(batch, seq, top_k, num_exp)
        kept = picks * (queue < capacity).float()
        slot = (queue * picks).sum(dim=-1).long()              # [B,S,K]
        slot_onehot = (slot[..., None] == torch.arange(
            capacity, device=x.device)).float()                # [B,S,K,C]
        dispatch = torch.einsum('bske,bskc->bsec', kept, slot_onehot)
        combine = torch.einsum('bsk,bske,bskc->bsec', top_w, kept,
                               slot_onehot)
        return dispatch, combine, picks, probs

    def forward(self, x: torch.Tensor, with_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(out [B, S, embed] in `dtype`, the layer's aux loss or None).
        Under expert parallelism the batch is the same on every rank of
        the expert group (the reference's 'batch' -> ('data', 'fsdp')
        rule replicates it over 'expert'), so each rank runs its own
        experts on its own copy of the dispatched tokens and the
        combine is a sum over the group (`experts_out`)."""
        dispatch, combine, picks, probs = self.route(x)
        out = self.experts_out(dispatch, combine, x.float())
        return (out.to(self.config.dtype),
                self.aux_loss(picks, probs) if with_aux else None)

    def experts_out(self, dispatch: torch.Tensor, combine: torch.Tensor,
                    x32: torch.Tensor) -> torch.Tensor:
        """This rank's experts' combine [B, S, embed] f32, summed over
        the expert group, x32 entering them through `copy_to_experts`."""
        group = self.expert_group
        if group is not None:
            x32 = copy_to_experts(x32, group)
        out = self.expert_sum(dispatch, combine, x32, *self.experts)
        if group is not None:
            out = reduce_from_experts(out, group)
        return out

    def aux_loss(self, picks: torch.Tensor, probs: torch.Tensor
                 ) -> torch.Tensor:
        """The Switch load-balancing loss of this layer's routing."""
        cfg = self.config
        assign_frac = picks.sum(dim=2).mean(dim=(0, 1))        # [E]
        if self.batch_group is not None:
            # The whole batch's fractions, as the reference computes them
            # over its sharded batch (and sequence). The router
            # probabilities stay this rank's: the ranks' mean aux is then
            # the batch's aux, and its gradient the batch's.
            assign_frac = assign_frac.clone()
            dist.all_reduce(assign_frac, group=self.batch_group)
            assign_frac = assign_frac / dist.get_world_size(self.batch_group)
        prob_frac = probs.mean(dim=(0, 1))                     # [E]
        return (cfg.num_experts * (assign_frac * prob_frac).sum()
                / cfg.experts_per_token)

    def expert_sum(self, dispatch: torch.Tensor, combine: torch.Tensor,
                   x32: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The combine of experts [lo, hi) alone, [B, S, embed] f32:
        their inputs gathered from x32 by `dispatch`, the SwiGLU
        experts in `dtype` on rows [lo, hi) of the stacks (this rank's
        stacks start at expert `self.experts[0]`), summed with the
        `combine` weights in f32."""
        dt = self.config.dtype
        base = self.experts[0]
        w_gate, w_up, w_down = (w[lo - base:hi - base].to(dt) for w in (
            self.w_gate, self.w_up, self.w_down))
        expert_in = torch.einsum('bsec,bsd->ebcd', dispatch[:, :, lo:hi],
                                 x32).to(dt)
        h = F.silu(torch.einsum('ebcd,edf->ebcf', expert_in, w_gate)) * \
            torch.einsum('ebcd,edf->ebcf', expert_in, w_up)
        expert_out = torch.einsum('ebcf,efd->ebcd', h, w_down)
        return torch.einsum('bsec,ebcd->bsd', combine[:, :, lo:hi],
                            expert_out.float())


def _earlier_blocks(counts: torch.Tensor, ring) -> torch.Tensor:
    """The sum of `counts` [B, E] (this block's assignments to each
    expert, a row) over the ring's blocks before this rank's."""
    parts = [torch.empty_like(counts) for _ in range(ring.size)]
    dist.all_gather(parts, counts.contiguous(), group=ring.group)
    return sum(parts[:ring.index], torch.zeros_like(counts))


def copy_to_experts(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums over the expert group."""
    return tensor_lib.copy_to_group(x, group)


def reduce_from_experts(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the expert group; identity backward."""
    return tensor_lib.reduce_from_group(x, group)


class Block(nn.Module):

    def __init__(self, config: MixtralConfig, dense=Dense) -> None:
        super().__init__()
        cfg = config
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                 cfg.trainable)
        self.attn = Attention(cfg.as_llama(), dense)
        self.moe_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype,
                                cfg.trainable)
        self.moe = MoEFeedForward(cfg)

    # The phases of a tensor-parallel grid (llama.Block's).
    def attn_qkv(self, x, positions):
        return self.attn.qkv(self.attn_norm(x), positions)

    def attn_out(self, qkv, positions, kv=None, page_indices=None,
                 prefill=False, attend_len=None, kv_amax=None,
                 kv_heads=None):
        return self.attn.attend(qkv, positions, kv, page_indices, prefill,
                                attend_len=attend_len, kv_amax=kv_amax,
                                kv_heads=kv_heads)

    def ffn(self, x):
        return self.moe(self.moe_norm(x))[0]

    def forward(self, x, positions, kv=None, page_indices=None,
                prefill=False, attend_len=None, with_aux=False, tensor=None):
        if tensor is not None:      # this rank's shard (parallel/tensor.py)
            return self.tensor_forward({tensor.index: self}, tensor, x,
                                       {tensor.index: positions}, with_aux)
        x = x + self.attn_out(self.attn_qkv(x, positions), positions, kv,
                              page_indices, prefill, attend_len)
        out, aux = self.moe(self.moe_norm(x), with_aux)
        return x + out, aux

    @staticmethod
    def tensor_forward(blocks, group, x, positions, with_aux=False):
        """The block over tensor shards (parallel/tensor.py; llama's
        `Block.tensor_forward`): the routing whole, each shard's slice
        of every expert's hidden axis (and, over `expert`, its own
        experts), the combine summed over both groups. Returns (x, the
        layer's aux or None)."""
        x = attention_step(blocks, group, x, positions, 'attn_norm')
        home = blocks[group.local[0]]
        h = home.moe_norm(x)
        dispatch, combine, picks, probs = home.moe.route(h)
        hs, cs = group.copy(h.float()), group.copy(combine)
        ds = tensor_lib.to_shards(group, dispatch)
        out = group.reduce({t: b.moe.experts_out(ds[t], cs[t], hs[t])
                            for t, b in blocks.items()})
        return (x + out.to(home.moe.config.dtype),
                home.moe.aux_loss(picks, probs) if with_aux else None)


class Mixtral(nn.Module):
    """Mixtral decoder (module doc). Parameters: `tok_embed` [vocab,
    embed], `layers.i.{attn_norm, attn.{wq,wk,wv,wo}, moe_norm,
    moe.{router,w_gate,w_up,w_down}}`, `final_norm`, `lm_head` [vocab,
    embed] (f32 holding `dtype`-rounded values in serving's layout, as
    Llama's)."""

    #: Name of layer i's scope in the reference's cache tree.
    CACHE_PREFIX = 'layer_'

    def __init__(self, config: MixtralConfig,
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
               prefill: bool = False, attend_len: Optional[int] = None,
               with_aux: bool = False):
        """Final-norm hidden states [B, S, embed] in `dtype` (the cache
        modes and `attend_len` are Llama.hidden's); with `with_aux`,
        (hidden, the layers' summed aux losses)."""
        cfg = self.config
        batch, seq = tokens.shape
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
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.layers):
            args = (x, positions,
                    cache.layers[i] if cache is not None else None,
                    page_indices, prefill, attend_len, with_aux)
            x, aux = (checkpoint.checkpoint(block, *args,
                                            use_reentrant=False)
                      if remat else block(*args))
            if with_aux:
                total_aux = total_aux + aux
        hidden = self.final_norm(x)
        return (hidden, total_aux) if with_aux else hidden

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of hidden states x [..., embed]: `dtype` operands,
        an f32 result (rounded to `logits_dtype` when one is set)."""
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
                cache: Optional[Union[PagedKVCache, DenseKVCache]] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, return_hidden: bool = False):
        """Training (no cache): (logits, aux_loss), or with
        `return_hidden` (hidden, aux_loss). Serving (a cache): logits,
        or hidden states, alone."""
        cfg = self.config
        if cache is not None:
            hidden = self.hidden(tokens, positions, cache, page_indices,
                                 prefill)
            return hidden if return_hidden else self.logits(hidden)
        hidden, total_aux = self.hidden(tokens, positions, prefill=prefill,
                                        with_aux=True)
        aux_loss = cfg.router_aux_loss_weight * total_aux / cfg.num_layers
        return (hidden if return_hidden else self.logits(hidden)), aux_loss


def moe_next_token_loss(outputs, tokens: torch.Tensor) -> torch.Tensor:
    """The trainer's loss for Mixtral: next-token CE plus the router
    aux loss (outputs = (logits, aux_loss))."""
    from skypilot_tpu_torch.parallel.train import next_token_loss
    logits, aux_loss = outputs
    return next_token_loss(logits, tokens) + aux_loss


# The fused blockwise-xent path handles the (hidden, aux) output, so the
# trainer keeps Mixtral on it.
moe_next_token_loss.fused_ok = True
