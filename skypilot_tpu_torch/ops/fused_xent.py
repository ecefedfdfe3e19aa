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
