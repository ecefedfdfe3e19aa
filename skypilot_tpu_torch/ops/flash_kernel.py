"""Causal flash attention: kernel wrappers, autograd Function and plain
versions (port of the upstream Pallas TPU kernels of
jax/experimental/pallas/ops/tpu/flash_attention.py that
skypilot_tpu/ops/attention.py:115-123 dispatches: the forward, and the
dK/dV and dQ backward kernels, here fused into one).

`flash_attention(q, k, v)` takes the port's layout, q [B, S, Hq, D] and
k/v [B, S, Hkv, D] (GQA: query head h reads kv head h // (Hq // Hkv)),
and returns causal softmax(q k^T * sm_scale) v as [B, S, Hq, D] in
q.dtype, with sm_scale = 1/sqrt(D) as the reference passes it. It is
differentiable through `FlashAttention`: the forward saves o and the
f32 row logsumexp [B, Hq, S]; the backward computes
di = sum(o * do) in f32, then dQ, dK and dV in one kernel from the saved
logsumexp (upstream saves l and m; lse = m + log l carries the same).
Masked scores take upstream's -0.7 * f32 max, not -inf. The bf16
backward sums dQ over key tiles with f32 reduce-adds in no fixed order,
so dQ's last bits can change from run to run; dK and dV are
deterministic.

Dispatch is ops/paged_kernel.py's (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is
the CUDA kernels (csrc/flash_attention.cu) for CUDA tensors and the
plain versions below for CPU tensors; 'cuda' on CPU tensors raises. No
environment switch, no fallback. `fwd_launches` and `bwd_launches`
count kernel launches, `plain_calls` calls of the plain versions made
through the Function (forward and backward each count).
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
#: Launches of the backward (dQ, dK and dV together).
bwd_launches = 0
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
    _check_shapes(q, k, v)
    route = resolve_impl(impl, q.device)
    scale = (1.0 / math.sqrt(q.shape[-1])) * (1.0 + perturb)
    return FlashAttention.apply(q, k, v, route, scale)


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f'expected q [B,S,Hq,D] and k/v [B,S,Hkv,D], got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    batch, seq, num_q_heads, head_dim = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (batch, seq, head_dim) \
            or num_q_heads % k.shape[2]:
        raise ValueError(f'q {tuple(q.shape)} does not fit k/v '
                         f'{tuple(k.shape)}')


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
            dq, dk, dv = flash_backward_kernel(q, k, v, do, lse, di,
                                               scale=ctx.scale)
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
    lib.skypilot_flash_bwd.restype = i32
    lib.skypilot_flash_bwd.argtypes = (
        [ptr] * 9 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.skypilot_flash_error_string.restype = ctypes.c_char_p
    lib.skypilot_flash_error_string.argtypes = [i32]
    return lib


def _check(q, k, v, *others, rows=()) -> Tuple[int, int, int, int, int,
                                                int]:
    """Validate what the kernels take, before anything is built: q (and
    `others`, e.g. do) [B, S, Hq, D] and k/v [B, S, Hkv, D] of one dtype,
    f32 or bf16 (bf16 only at the head dims of `_BF16_HEAD_DIMS`); `rows`
    f32 [B, Hq, S]; all on one device, contiguous and 16-byte aligned.
    Returns (B, S, Hq, Hkv, D, dtype code)."""
    _check_shapes(q, k, v)
    batch, seq, num_q_heads, head_dim = q.shape
    num_kv_heads = k.shape[2]
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f'expected {tuple(q.shape)}, got '
                             f'{tuple(t.shape)}')
    want = (batch, num_q_heads, seq)
    for t in rows:
        if t.shape != want or t.dtype != torch.float32:
            raise ValueError(f'lse/di must be float32 {want}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    if q.dtype not in _CODES:
        raise TypeError(f'dtype {q.dtype} not in {list(_CODES)}')
    for t in (k, v, *others):
        if t.dtype != q.dtype:
            raise TypeError(f'q, k, v and do must share a dtype: {q.dtype}, '
                            f'{t.dtype}')
    for t in (q, k, v, *others, *rows):
        if t.device != q.device:
            raise ValueError(f'all tensors must lie on {q.device}, one lies '
                             f'on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernels take contiguous tensors; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
        if t.data_ptr() % 16:
            raise ValueError('the kernels take 16-byte aligned tensors')
    if q.dtype == torch.bfloat16 and head_dim not in _BF16_HEAD_DIMS:
        raise ValueError(f'the bf16 kernels take head_dim in '
                         f'{_BF16_HEAD_DIMS}, got {head_dim}')
    if head_dim > _MAX_F32_HEAD_DIM:
        raise ValueError(f'head_dim {head_dim} > {_MAX_F32_HEAD_DIM}')
    return (batch, seq, num_q_heads, num_kv_heads, head_dim,
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
    batch, seq, hq, hkv, dim, code = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((batch, hq, seq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device_of(q):  # q's stream, q's kernel attributes
        err = lib.skypilot_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), batch, seq, hq, hkv, dim, code, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, 'forward', err)
    fwd_launches += 1
    return o, lse


def flash_backward_kernel(q, k, v, do, lse, di, *,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The backward: (dq, dk, dv). bf16 runs one fused kernel that adds
    dQ into a zeroed f32 workspace (cast to bf16 here); f32 runs the
    scalar dK/dV and dQ kernels. Either counts one launch."""
    global bwd_launches
    scale = _scale(q, scale)
    batch, seq, hq, hkv, dim, code = _check(q, k, v, do, rows=(lse, di))
    lse_ld = seq
    if code == _CODES[torch.bfloat16]:
        # TMA reads lse/di rows at 16-byte strides.
        lse_ld = -(-seq // 4) * 4
        if lse_ld != seq:
            lse, di = (torch.nn.functional.pad(t, (0, lse_ld - seq))
                       for t in (lse, di))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    else:
        dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    with torch.cuda.device_of(q):  # q's stream, q's kernel attributes
        err = lib.skypilot_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), batch, seq, hq, hkv, dim, code, lse_ld,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, 'backward', err)
    bwd_launches += 1
    return dq.to(q.dtype), dk, dv


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
    """Plain version of the backward kernel, written out (not
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
