"""Ring attention: exact attention over a sequence-sharded ring of ranks
(port of skypilot_tpu/ops/ring_attention.py).

Context parallelism: each rank of the mesh's `seq` axis holds one block
of the sequence, q/k/v [B, Sl, H, D] at positions [r*Sl, (r+1)*Sl).
Step 0 attends the rank's own block; after each step the k/v block moves
one hop around the ring (rank r sends to r+1, paired
`dist.batch_isend_irecv` on the seq group, posted before the step's
arithmetic so the transfer overlaps it). Each step is the reference's
online-softmax update in f32 (`_online_block_update`), so the result is
exact, and O(Sl) memory a rank. Causality is by global block position:
a block from a lower rank is fully visible, the rank's own block takes
the triangular mask, a block from a higher rank is fully masked. A
fully masked step adds nothing (its update leaves the accumulators as
they are, bit for bit), so it computes nothing, but it still forwards
its block: every rank makes the same transfers in the same order. A
row that sees nothing returns 0, not NaN.

The reference's ring is einsums under shard_map, not a Pallas kernel,
and its gradient is JAX's transpose of the loop. The port's is
`RingAttention`, an autograd Function with a hand-written backward
ring: it saves the f32 output and the per-row log-sum-exp, recomputes
each block's probabilities from them, accumulates dq locally, and
sends dk/dv around the ring with their block, so after K hops each
block's dk/dv come home whole. The forward makes K - 1 hops, the
backward K - 1 of k/v and K of dk/dv.

`fwd_steps` and `bwd_steps` count ring steps (K a call, masked ones
included); `timing()` collects CUDA events around each forward and
backward on the card. `gather_blocks` is the all-gather (backward: sum
and keep the rank's block) that the unequal-dims attention takes under
an active ring. `reference_attention` is the plain full attention the
tests hold the ring to.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

#: Ring steps of the forward (K a call) in this process.
fwd_steps = 0
#: Ring steps of the backward.
bwd_steps = 0

_timer: Optional[List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = None


@contextlib.contextmanager
def timing() -> Iterator[List[Tuple[torch.cuda.Event, torch.cuda.Event]]]:
    """Within the body, every forward and backward on CUDA tensors
    records a (start, end) CUDA event pair into the yielded list; sum
    `start.elapsed_time(end)` after a synchronize."""
    global _timer
    events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
    prev, _timer = _timer, events
    try:
        yield events
    finally:
        _timer = prev


def _start(t: torch.Tensor):
    if _timer is None or not t.is_cuda:
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def _stop(start) -> None:
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _timer.append((start, end))


def _online_block_update(o, m, l, s, v):
    """One flash-attention accumulation step, in place on o, m, l.

    o: [B,Sq,H,D] f32 accumulator; m, l: [B,Sq,H] running max and
    denominator; s: [B,Sq,H,Sk] scores; v: [B,Sk,H,D]."""
    new_m = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(s - new_m[..., None])
    l.mul_(correction).add_(p.sum(dim=-1))
    o.mul_(correction[..., None]).add_(
        torch.einsum('bqhk,bkhd->bqhd', p, v.float()))
    m.copy_(new_m)


def _exchange(tensors: List[torch.Tensor], seq) -> Tuple[List, List]:
    """Send each tensor to the next rank of the ring and receive the
    previous rank's into new buffers; (buffers, requests to wait)."""
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t, seq.next_rank, seq.group))
        ops.append(dist.P2POp(dist.irecv, r, seq.prev_rank, seq.group))
    return recv, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


def _visible(causal: bool, src: int, index: int) -> bool:
    return not causal or src <= index


class RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, seq, causal: bool, skip: Optional[int]):
        global fwd_steps
        start = _start(q)
        batch, s_local, heads, head_dim = q.shape
        scale = 1.0 / math.sqrt(head_dim)
        q32 = q.float() * scale
        o = torch.zeros((batch, s_local, heads, head_dim),
                        dtype=torch.float32, device=q.device)
        m = torch.full((batch, s_local, heads), float('-inf'),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        tri = torch.ones((s_local, s_local), dtype=torch.bool,
                         device=q.device).tril()
        kv = torch.stack([k, v])
        for step in range(seq.size):
            src = (seq.index - step) % seq.size
            last = step == seq.size - 1
            if not last:
                (recv,), reqs = _exchange([kv], seq)
            if _visible(causal, src, seq.index):
                s = torch.einsum('bqhd,bkhd->bqhk', q32, kv[0].float())
                if causal and src == seq.index:
                    s = s.masked_fill(~tri[None, :, None, :], float('-inf'))
                _online_block_update(o, m, l, s, kv[1])
            if not last:
                _wait(reqs)
                if step != skip:     # a perturbed ring keeps its block
                    kv = recv
        fwd_steps += seq.size
        empty = l == 0
        out = o / torch.where(empty, torch.ones_like(l), l)[..., None]
        # A row that saw nothing takes probability 0 everywhere in the
        # backward.
        lse = torch.where(empty, torch.full_like(l, float('inf')),
                          m + torch.log(l))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seq, ctx.causal, ctx.scale = seq, causal, scale
        _stop(start)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        global bwd_steps
        q, k, v, out, lse = ctx.saved_tensors
        start = _start(q)
        seq, causal, scale = ctx.seq, ctx.causal, ctx.scale
        s_local = q.shape[1]
        do = dout.float()
        di = (do * out).sum(dim=-1)                          # [B,Sq,H]
        q32 = q.float() * scale
        dq = torch.zeros_like(q32)
        tri = torch.ones((s_local, s_local), dtype=torch.bool,
                         device=q.device).tril()
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step in range(seq.size):
            src = (seq.index - step) % seq.size
            last = step == seq.size - 1
            if not last:
                (kv_next,), kv_reqs = _exchange([kv], seq)
            if _visible(causal, src, seq.index):
                kb, vb = kv[0].float(), kv[1].float()
                s = torch.einsum('bqhd,bkhd->bqhk', q32, kb)
                if causal and src == seq.index:
                    s = s.masked_fill(~tri[None, :, None, :], float('-inf'))
                p = torch.exp(s - lse[..., None])
                dkv[1] += torch.einsum('bqhk,bqhd->bkhd', p, do)
                dp = torch.einsum('bqhd,bkhd->bqhk', do, vb)
                ds = p.mul_(dp.sub_(di[..., None]))
                dq += torch.einsum('bqhk,bkhd->bqhd', ds, kb)
                dkv[0] += torch.einsum('bqhk,bqhd->bkhd', ds, q32)
            # dk/dv travel with their block: K hops bring them home.
            (dkv_next,), reqs = _exchange([dkv], seq)
            _wait(reqs)
            dkv = dkv_next
            if not last:
                _wait(kv_reqs)
                kv = kv_next
        bwd_steps += seq.size
        _stop(start)
        return ((dq * scale).to(q.dtype), dkv[0].to(k.dtype),
                dkv[1].to(v.dtype), None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seq, *, causal: bool = True,
                   skip_rotation: Optional[int] = None) -> torch.Tensor:
    """Exact attention of this rank's blocks q/k/v [B, Sl, H, D] over the
    ring `seq` (parallel/context.py SeqGroup); returns [B, Sl, H, D] in
    q.dtype. GQA callers repeat the kv heads first. `skip_rotation`
    (a step index) makes the ring keep its block instead of the one it
    received after that step: a deliberately wrong ring for tests to
    prove the parity pins bite."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f'ring attention takes equal q/k/v shapes, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    return RingAttention.apply(q, k, v, seq, causal, skip_rotation)


class _GatherBlocks(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, seq):
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x.contiguous(), group=seq.group)
        ctx.seq, ctx.block = seq, x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.seq.group)
        lo = ctx.seq.index * ctx.block
        return grad[:, lo:lo + ctx.block], None


def gather_blocks(x: torch.Tensor, seq) -> torch.Tensor:
    """The ring's blocks x [B, Sl, ...] joined along dim 1 in ring order
    ([B, K * Sl, ...]); the gradient of this rank's block is the sum of
    every rank's gradient of it."""
    return _GatherBlocks.apply(x, seq)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain full attention [B, S, H, D] (the tests' comparison): f32
    scores and softmax, output in q.dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum('bqhd,bkhd->bqhk', q.float(), k.float()) * scale
    if causal:
        seq = q.shape[1]
        mask = torch.ones((seq, seq), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask[None, :, None, :], float('-inf'))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bqhk,bkhd->bqhd', p, v.float()).to(q.dtype)
