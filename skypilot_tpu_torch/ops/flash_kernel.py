"""Causal flash attention: kernel wrappers, autograd Function and plain
versions (port of the upstream Pallas TPU kernels of
jax/experimental/pallas/ops/tpu/flash_attention.py that
skypilot_tpu/ops/attention.py:115-123 dispatches: the forward, the
dK/dV backward and the dQ backward).

`flash_attention(q, k, v)` takes the port's layout, q [B, S, Hq, D] and
k/v [B, S, Hkv, D] (GQA: query head h reads kv head h // (Hq // Hkv)),
and returns causal softmax(q k^T * sm_scale) v as [B, S, Hq, D] in
q.dtype, with sm_scale = 1/sqrt(D) as the reference passes it. It is
differentiable through `FlashAttention`: the forward saves o and the
f32 row logsumexp [B, Hq, S]; the backward computes
di = sum(o * do) in f32, then dK/dV, then dQ, each from the saved
logsumexp (upstream saves l and m; lse = m + log l carries the same).
Masked scores take upstream's -0.7 * f32 max, not -inf.

Dispatch is ops/paged_kernel.py's (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is
the CUDA kernels (csrc/flash_attention.cu) for CUDA tensors and the
plain versions below for CPU tensors; 'cuda' on CPU tensors raises. No
environment switch, no fallback. `fwd_launches`, `dkv_launches` and
`dq_launches` count kernel launches, `plain_calls` calls of the plain
versions made through the Function (forward and backward each count).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops.paged_kernel import (  # noqa: F401
    IMPLS, impl_scope, resolve_impl, unavailable_reason)

#: Launches of the forward kernel in this process.
fwd_launches = 0
#: Launches of the dK/dV kernel.
dkv_launches = 0
#: Launches of the dQ kernel.
dq_launches = 0
#: Plain-version calls (forward or backward) made through FlashAttention.
plain_calls = 0

#: Upstream's DEFAULT_MASK_VALUE.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_HEAD_DIMS = (32, 64, 128)
_MAX_F32_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    impl: str = 'auto', perturb: float = 0.0
                    ) -> torch.Tensor:
    """Causal GQA attention (see module doc). `perturb` scales every
    score by (1 + perturb), in the forward and the backward: a
    deliberately wrong kernel for tests to prove the parity pins
    bite."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f'expected q [B,S,Hq,D] and k/v [B,S,Hkv,D], got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    batch, seq, num_q_heads, head_dim = q.shape
    if k.shape[0] != batch or k.shape[1] != seq or k.shape[3] != head_dim \
            or num_q_heads % k.shape[2]:
        raise ValueError(f'q {tuple(q.shape)} does not fit k/v '
                         f'{tuple(k.shape)}')
    route = resolve_impl(impl, q.device)
    scale = (1.0 / math.sqrt(head_dim)) * (1.0 + perturb)
    return FlashAttention.apply(q, k, v, route, scale)


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its backward on the same route
    ('torch' = the written-out plain versions, 'cuda' = the kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, route: str, scale: float):
        global plain_calls
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if route == 'torch':
            plain_calls += 1
            o, lse = flash_forward_reference(q, k, v, scale=scale)
        else:
            o, lse = flash_forward_kernel(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.route, ctx.scale = route, scale
        return o

    @staticmethod
    def backward(ctx, do):
        global plain_calls
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = attention_di(o, do)
        if ctx.route == 'torch':
            plain_calls += 1
            dq, dk, dv = flash_backward_reference(q, k, v, do, lse, di,
                                                  scale=ctx.scale)
        else:
            dk, dv = flash_dkv_kernel(q, k, v, do, lse, di, scale=ctx.scale)
            dq = flash_dq_kernel(q, k, v, do, lse, di, scale=ctx.scale)
        return dq, dk, dv, None, None


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum_d(o * do) in f32, [B, Hq, S] (upstream computes it
    outside its kernels the same way)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


# -- kernels ----------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('flash_attention')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skypilot_flash_fwd.restype = i32
    lib.skypilot_flash_fwd.argtypes = (
        [ptr] * 5 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.skypilot_flash_bwd_dkv.restype = i32
    lib.skypilot_flash_bwd_dkv.argtypes = (
        [ptr] * 8 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.skypilot_flash_bwd_dq.restype = i32
    lib.skypilot_flash_bwd_dq.argtypes = (
        [ptr] * 7 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.skypilot_flash_error_string.restype = ctypes.c_char_p
    lib.skypilot_flash_error_string.argtypes = [i32]
    return lib


def _check(q, tensors) -> Tuple[int, int, int, int, int, int]:
    """Validate what the kernels take; returns (B, S, Hq, Hkv, D,
    dtype code)."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f'all tensors must lie on {q.device}, one lies '
                             f'on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernels take contiguous tensors; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
        if t.data_ptr() % 16:
            raise ValueError('the kernels take 16-byte aligned tensors')
    if q.dtype not in _CODES:
        raise TypeError(f'dtype {q.dtype} not in {list(_CODES)}')
    batch, seq, num_q_heads, head_dim = q.shape
    if q.dtype == torch.bfloat16 and head_dim not in _BF16_HEAD_DIMS:
        raise ValueError(f'the bf16 kernels take head_dim in '
                         f'{_BF16_HEAD_DIMS}, got {head_dim}')
    if head_dim > _MAX_F32_HEAD_DIM:
        raise ValueError(f'head_dim {head_dim} > {_MAX_F32_HEAD_DIM}')
    return (batch, seq, num_q_heads, tensors[1].shape[2], head_dim,
            _CODES[q.dtype])


def _raise(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.skypilot_flash_error_string(err).decode()
        raise RuntimeError(f'flash attention {name} kernel failed to launch: '
                           f'CUDA error {err} ({msg})')


def flash_forward_kernel(q, k, v, *, scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (o, lse f32 [B, Hq, S])."""
    global fwd_launches
    scale = _scale(q, scale)
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f'q, k and v must share a dtype: {q.dtype}, '
                            f'{t.dtype}')
    batch, seq, hq, hkv, dim, code = _check(q, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((batch, hq, seq), dtype=torch.float32, device=q.device)
    lib = _library()
    err = lib.skypilot_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        batch, seq, hq, hkv, dim, code, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, 'forward', err)
    fwd_launches += 1
    return o, lse


def flash_dkv_kernel(q, k, v, do, lse, di, *,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: (dk, dv)."""
    global dkv_launches
    scale = _scale(q, scale)
    batch, seq, hq, hkv, dim, code = _check(q, (q, k, v, do, lse, di))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    err = lib.skypilot_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        batch, seq, hq, hkv, dim, code, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, 'dK/dV', err)
    dkv_launches += 1
    return dk, dv


def flash_dq_kernel(q, k, v, do, lse, di, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The dQ kernel."""
    global dq_launches
    scale = _scale(q, scale)
    batch, seq, hq, hkv, dim, code = _check(q, (q, k, v, do, lse, di))
    dq = torch.empty_like(q)
    lib = _library()
    err = lib.skypilot_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        batch, seq, hq, hkv, dim, code, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, 'dQ', err)
    dq_launches += 1
    return dq


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


# -- plain versions -----------------------------------------------------------
def _heads_first(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[S, H, D] -> f32 [H * rep, S, D] (kv heads repeated for GQA)."""
    x = x.float().transpose(0, 1)
    return x.repeat_interleave(rep, dim=0) if rep > 1 else x


def _masked_scores(qb, kb, scale):
    seq = qb.shape[1]
    s = (qb @ kb.transpose(1, 2)) * scale
    keep = torch.ones(seq, seq, dtype=torch.bool, device=qb.device).tril()
    return s.masked_fill(~keep, MASK_VALUE)


def flash_forward_reference(q, k, v, *, scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, in f32 one batch row at a
    time: (o [B, S, Hq, D] in q.dtype, lse f32 [B, Hq, S])."""
    scale = _scale(q, scale)
    batch, seq, num_q_heads, _ = q.shape
    rep = num_q_heads // k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((batch, num_q_heads, seq), dtype=torch.float32,
                      device=q.device)
    for b in range(batch):
        s = _masked_scores(_heads_first(q[b], 1), _heads_first(k[b], rep),
                           scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = (p / l) @ _heads_first(v[b], rep)
        o[b] = out.transpose(0, 1).to(q.dtype)
        lse[b] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_backward_reference(q, k, v, do, lse, di, *,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of the two backward kernels, written out (not
    autograd over the forward): P recomputed from the saved lse,
    dS = P * (dP - di) * scale, dV = P^T dO, dK = dS^T Q, dQ = dS K,
    with dK/dV summed over each kv head's query-head group. f32 math,
    one batch row at a time; (dq, dk, dv) in the inputs' dtypes."""
    scale = _scale(q, scale)
    batch, seq, num_q_heads, head_dim = q.shape
    num_kv_heads = k.shape[2]
    rep = num_q_heads // num_kv_heads
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    for b in range(batch):
        qb, dob = _heads_first(q[b], 1), _heads_first(do[b], 1)
        kb, vb = _heads_first(k[b], rep), _heads_first(v[b], rep)
        p = torch.exp(_masked_scores(qb, kb, scale) - lse[b][..., None])
        dp = dob @ vb.transpose(1, 2)
        ds = p * (dp - di[b][..., None]) * scale
        dq[b] = (ds @ kb).transpose(0, 1).to(q.dtype)
        group = (num_kv_heads, rep, seq, head_dim)
        dk[b] = (ds.transpose(1, 2) @ qb).view(group).sum(1).transpose(
            0, 1).to(k.dtype)
        dv[b] = (p.transpose(1, 2) @ dob).view(group).sum(1).transpose(
            0, 1).to(v.dtype)
    return dq, dk, dv
