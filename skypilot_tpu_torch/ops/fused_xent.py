"""Fused blockwise LM-head + cross-entropy: no [B, S, V] logits in
either pass (port of skypilot_tpu/ops/fused_xent.py).

`fused_next_token_loss(hidden, head, tokens)` predicts tokens[:, 1:]
from hidden[:, :-1] @ head and returns the mean of (logsumexp - target
logit). Over vocab chunks of `pick_block(V)` columns, the forward folds
each chunk's [B, S, C] logits into a running (max, sumexp) pair and the
target-logit gather, then drops them; `BlockwiseXent`'s backward
recomputes each chunk's softmax from the saved [B, S] logsumexp. The
residuals are the hidden states, the head and the normalizer. This is
XLA-level code in the reference (a `lax.scan` under `jax.custom_vjp`),
not a Pallas kernel, so plain torch ops carry it here.

The head split by vocab rows (a tensor group's slices, or the one-device
witness of a pipeline's stage-split head) takes `split_vocab_token_losses`
(`SplitVocabXent`): each slice runs its chunk loop, the row maxima are
taken over the group first, and the summed exponentials and target
logits are summed over it in f32, so a pipeline's head and a tensor
shard's share one arithmetic (`shard_logits`, `owned_targets`,
`shard_backward`); the slices' f32 parts of the input gradient are
summed before the one cast to the compute dtype.

Numerics: chunk products take operands in the compute dtype (the
caller's `cfg.dtype`) and accumulate into f32 results (`mm_f32`), and
the streaming logsumexp is f32, as in the reference. A vocab that fits
one chunk takes the dense math under plain autograd, as the reference
does (logits in the compute dtype, then f32).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

# Chunk-size candidates, largest first.
BLOCK_CANDIDATES = (4096, 2048, 1024, 512)


def pick_block(vocab_size: int) -> int:
    """The reference's chunk choice over {512..4096} and divisors(V):
    the largest candidate dividing V that gives >= 4 chunks, else the
    largest divisor, else the candidate wasting the least padding
    (padded columns are masked inside the op)."""
    divisors = [c for c in BLOCK_CANDIDATES if vocab_size % c == 0]
    for c in divisors:
        if vocab_size // c >= 4:
            return c
    if divisors:
        return divisors[0]
    return min(BLOCK_CANDIDATES, key=lambda c: ((-vocab_size) % c, -c))


def find_lm_head(params: Mapping[str, Any]) -> Tuple[Any, bool]:
    """(weight, vocab_in_rows) of a model's LM head in its top-level
    params. The port's Llama, Mixtral and DeepSeek keep an untied
    `lm_head` [V, H] (vocab in rows, unlike the reference's [H, V]);
    GPT ties its
    head to the token embedding `wte` [V, H], vocab in rows in both
    packages."""
    if 'lm_head' in params:
        return params['lm_head'], True
    if 'wte' in params:
        return params['wte'], True
    raise ValueError("no LM head found in params (expected top-level "
                     "'lm_head' or tied 'wte')")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] with operands in their dtype and an f32
    result: bf16 products are exact in f32, so on the CPU the operands
    are widened first; on the card the product accumulates straight
    into f32 (`out_dtype`)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(vocab: int, block: int):
    for start in range(0, vocab, block):
        yield start, min(start + block, vocab)


def _streaming_lse(x2: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                   block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, target logit), f32 [N], over vocab chunks of x2 [N, H]
    @ w[V, H]^T. A partial last chunk is the reference's padded one with
    its padded columns masked."""
    n = x2.shape[0]
    m = torch.full((n,), float('-inf'), dtype=torch.float32, device=x2.device)
    s = torch.zeros(n, dtype=torch.float32, device=x2.device)
    tgt = torch.zeros(n, dtype=torch.float32, device=x2.device)
    for start, end in _chunks(w.shape[0], block):
        logits = mm_f32(x2, w[start:end].T)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = targets - start
        hit = (local >= 0) & (local < end - start)
        picked = logits.gather(1, local.clamp(0, end - start - 1)[:, None])
        tgt = torch.where(hit, picked[:, 0], tgt)
    return m + torch.log(s), tgt


class BlockwiseXent(torch.autograd.Function):
    """Per-token CE loss [N] from x2 [N, H], w [V, H] and targets [N],
    without a [N, V] array: the backward recomputes each chunk's
    softmax from the saved logsumexp."""

    @staticmethod
    def forward(ctx, x2, w, targets, block: int):
        lse, tgt = _streaming_lse(x2, w, targets, block)
        ctx.save_for_backward(x2, w, targets, lse)
        ctx.block = block
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x2, w, targets, lse = ctx.saved_tensors
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        g = g.float()
        rows = torch.arange(x2.shape[0], device=x2.device)
        for start, end in _chunks(w.shape[0], ctx.block):
            w_c = w[start:end]
            p = torch.exp(mm_f32(x2, w_c.T) - lse[:, None])
            local = targets - start
            hit = (local >= 0) & (local < end - start)
            p[rows[hit], local[hit]] -= 1.0
            d_logits = (p * g[:, None]).to(x2.dtype)
            dx += mm_f32(d_logits, w_c)
            dw[start:end] = mm_f32(d_logits.T, x2)
        return dx.to(x2.dtype), dw.to(w.dtype), None, None


def fused_token_losses(hidden: torch.Tensor, weight: torch.Tensor,
                       targets: torch.Tensor, *,
                       vocab_in_rows: Optional[bool] = None,
                       block_size: Optional[int] = None,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Per-token (logsumexp - target logit) [B * T], f32, of hidden
    [B, T, H] @ head against targets [B, T], blockwise over the vocab,
    with no shift (a seq rank's block predicts the tokens after it, the
    next block's first among them). `weight` is [V, H] when
    `vocab_in_rows` (the port's `lm_head`), else [H, V]; None infers it
    from the shape when unambiguous. `compute_dtype` (None =
    hidden.dtype) is the operand dtype of the products; accumulation
    and the losses are f32."""
    h_dim = hidden.shape[-1]
    if vocab_in_rows is None:
        rows, cols = weight.shape[-1] == h_dim, weight.shape[0] == h_dim
        if rows == cols:
            raise ValueError(f'ambiguous head orientation for shape '
                             f'{tuple(weight.shape)} with H={h_dim}; pass '
                             f'vocab_in_rows explicitly')
        vocab_in_rows = rows
    w = weight if vocab_in_rows else weight.T
    vocab = w.shape[0]
    cd = compute_dtype or hidden.dtype
    w = w.to(cd)
    targets = targets.long()
    block = int(block_size) if block_size else pick_block(vocab)
    if block >= vocab:
        # One chunk: the dense math under plain autograd, as the
        # reference does (logits in the compute dtype, then f32).
        logits = (hidden.to(cd) @ w.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        return (lse - tgt).reshape(-1)
    x2 = hidden.to(cd).reshape(-1, h_dim)
    return BlockwiseXent.apply(x2, w, targets.reshape(-1), block)


def fused_next_token_loss(hidden: torch.Tensor, weight: torch.Tensor,
                          tokens: torch.Tensor, *,
                          vocab_in_rows: Optional[bool] = None,
                          block_size: Optional[int] = None,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Causal-LM loss straight from final hidden states [B, S, H]:
    mean over tokens[:, 1:] of `fused_token_losses` of hidden[:, :-1]
    (the same arguments)."""
    return fused_token_losses(
        hidden[:, :-1], weight, tokens[:, 1:], vocab_in_rows=vocab_in_rows,
        block_size=block_size, compute_dtype=compute_dtype).mean()


# -- the vocab-split head ---------------------------------------------------------
def shard_logits(x2: torch.Tensor, table: torch.Tensor, offset: int,
                 vocab: int, round_to: Optional[torch.dtype]
                 ) -> torch.Tensor:
    """f32 logits [N, rows] of rows x2 [N, E] against a slice of the
    head [rows, E] whose row j is vocab id offset + j: `x2.dtype`
    operands, an f32 product (rounded to `round_to` when given, as the
    family's head rounds), columns past the vocab (padding) -inf."""
    logits = mm_f32(x2, table.to(x2.dtype).T)
    if round_to is not None:
        logits = logits.to(round_to).float()
    valid = max(0, min(table.shape[0], vocab - offset))
    if valid < table.shape[0]:
        logits[:, valid:] = float('-inf')
    return logits


def owned_targets(targets: torch.Tensor, offset: int, rows: int):
    """(local ids clamped into the slice, which targets it owns)."""
    local = targets - offset
    owned = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), owned


def shard_backward(logits: torch.Tensor, lse: torch.Tensor,
                   local: torch.Tensor, owned: torch.Tensor,
                   coef: torch.Tensor, x2: torch.Tensor,
                   table: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d x2 [N, E] f32, d table [rows, E] f32) of coef * the slice's
    part of (lse - target logit): (softmax - onehot) * coef, in x2's
    dtype, through the head's two products."""
    p = torch.exp(logits - lse[:, None])
    # The one-hot of the owned targets, with no host sync.
    p.scatter_add_(1, local[:, None], -owned.to(p.dtype)[:, None])
    d_logits = (p * coef).to(x2.dtype)
    return (mm_f32(d_logits, table.to(x2.dtype)),
            mm_f32(d_logits.T, x2))


def _global_max(group, maxes):
    """The row maxima over every slice of the vocab (the combine's
    first step)."""
    return group.all_reduce(maxes, 'max')


class SplitVocabXent(torch.autograd.Function):
    """Per-token (logsumexp - target logit) [N], f32, of x2 [N, E]
    (the compute dtype) against a head split by vocab rows over a
    tensor group (parallel/tensor.py `LocalTensor` / `RankTensor`, or a
    pipeline's stage group): slice t's rows are vocab ids
    [t * rows, (t + 1) * rows), in chunks of `block` rows (None: one).
    Each slice takes its row maxima, the group their max; each then sums
    exp(logit - max) and its owned target logits, and the group sums
    those in f32. The backward recomputes each chunk's softmax from the
    log-sum-exp; the slices' f32 parts of dx are summed first and cast
    once (x2 is whole on every slice), each slice's head gradient is
    f32 in the table's dtype."""

    @staticmethod
    def forward(ctx, x2, targets, spec, *tables):
        group, vocab, block = spec[:3]
        round_to = spec[3]
        work, maxes = {}, {}
        for t, w in zip(group.local, tables):
            xt = x2 if w.device == x2.device else x2.to(w.device)
            tt = targets.to(w.device)
            offset, rows = t * w.shape[0], w.shape[0]
            blk = rows if block is None else min(block, rows)
            m = None
            for start, end in _chunks(rows, blk):
                cm = shard_logits(xt, w[start:end], offset + start, vocab,
                                  round_to).amax(dim=1)
                m = cm if m is None else torch.maximum(m, cm)
            work[t], maxes[t] = (xt, tt, offset, blk), m
        m = _global_max(group, maxes)
        parts = {}
        for t, w in zip(group.local, tables):
            xt, tt, offset, blk = work[t]
            se = tl = 0
            for start, end in _chunks(w.shape[0], blk):
                logits = shard_logits(xt, w[start:end], offset + start, vocab,
                                      round_to)
                local, owned = owned_targets(tt, offset + start, end - start)
                se = se + torch.exp(logits - m[t][:, None]).sum(dim=1)
                tl = tl + torch.where(
                    owned, logits.gather(1, local[:, None])[:, 0],
                    torch.zeros((), device=logits.device))
            parts[t] = torch.stack([se, tl])
        sums = group.all_reduce(parts)
        lse = {t: m[t] + torch.log(sums[t][0]) for t in group.local}
        home = group.local[0]
        ctx.spec, ctx.work, ctx.lse = spec, work, lse
        ctx.save_for_backward(x2, *tables)
        return (lse[home] - sums[home][1]).to(x2.device)

    @staticmethod
    def backward(ctx, g):
        x2, *tables = ctx.saved_tensors
        group, vocab, _, round_to = ctx.spec
        dxs, dws = {}, []
        for t, w in zip(group.local, tables):
            xt, tt, offset, blk = ctx.work[t]
            coef = g.to(w.device).float()[:, None]
            dx = torch.zeros(xt.shape, dtype=torch.float32, device=w.device)
            dw = []
            for start, end in _chunks(w.shape[0], blk):
                w_c = w[start:end]
                logits = shard_logits(xt, w_c, offset + start, vocab,
                                      round_to)
                local, owned = owned_targets(tt, offset + start, end - start)
                d_x, d_w = shard_backward(logits, ctx.lse[t], local, owned,
                                          coef, xt, w_c)
                dx += d_x
                dw.append(d_w)
            dxs[t] = dx
            dws.append(torch.cat(dw).to(w.dtype))
        dx = group.sum_home(dxs).to(x2.device)
        return (dx.to(x2.dtype), None, None) + tuple(dws)


def split_vocab_token_losses(x2: torch.Tensor, targets: torch.Tensor,
                             tables, group, vocab: int,
                             block: Optional[int] = None,
                             round_to: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """`SplitVocabXent` of rows x2 [N, E] against `targets` [N] through
    `tables` {slice: its rows of the head} (the group's local slices);
    `block` 'auto' picks `pick_block` of a slice's rows."""
    tables = [tables[t] for t in group.local]
    if block == 'auto':
        block = pick_block(tables[0].shape[0])
    return SplitVocabXent.apply(x2, targets.long(),
                                (group, vocab, block, round_to), *tables)
