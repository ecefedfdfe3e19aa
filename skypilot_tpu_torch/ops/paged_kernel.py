"""Paged-attention kernel wrapper and dispatch (port of
skypilot_tpu/ops/pallas_paged.py:89-382).

`fused_paged_attention` has the reference's signature and semantics:
q [B, S, Hq, D]; positions int32 [B, S] — query s of row b attends
every cache index <= positions[b, s] (decode is S=1 with positions =
lengths - 1; chunks pass absolute positions); pools
[Hkv, P, page_size, D] in f32, bf16 or int8 (int8 needs the f32
[P, page_size] scale arrays); page_indices int32 [B, pages_per_seq].
Returns [B, S, Hq, D] in q.dtype; a row with nothing visible returns
0.

Dispatch. `IMPLS = ('auto', 'torch', 'cuda')`. 'auto' means the CUDA
kernel (csrc/paged_attention.cu) for CUDA tensors and the plain PyTorch
version `fused_paged_attention_reference` for CPU tensors; an
`impl_scope` override replaces 'auto' (the A/B hook). 'cuda' on CPU
tensors raises. There is no environment switch and no fallback: a
kernel that fails to build or launch raises.

`launches` counts kernel launches and `plain_calls` plain-version
calls through the wrapper, so a run can show which route it took.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

IMPLS: Tuple[str, ...] = ('auto', 'torch', 'cuda')

#: Kernel launches made by `fused_paged_attention` in this process.
launches = 0
#: Calls of the plain version made through `fused_paged_attention`.
plain_calls = 0

_default_impl: Optional[str] = None

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 128


def unavailable_reason() -> Optional[str]:
    """None when the CUDA kernel can run here; otherwise why not."""
    if not torch.cuda.is_available():
        return 'no CUDA device is visible'
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        return (f'compute capability {major}.{minor}: the kernel is '
                f'built for sm_90a (Hopper)')
    from skypilot_tpu_torch.ops import _build
    if _build.find_nvcc() is None:
        return 'nvcc not found: the kernel is built from source'
    return None


def available() -> bool:
    return unavailable_reason() is None


def _validate(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f'unknown kernel impl {impl!r} '
                         f'(choices: {", ".join(IMPLS)})')


@contextlib.contextmanager
def impl_scope(impl: str):
    """Route 'auto' calls of every kernel wrapper (this module's and
    ops/lora_kernel.py's) to `impl` inside the block."""
    global _default_impl
    _validate(impl)
    prev = _default_impl
    _default_impl = impl
    try:
        yield
    finally:
        _default_impl = prev


def resolve_impl(impl: str = 'auto',
                 device: Optional[torch.device] = None) -> str:
    """'torch' or 'cuda' for a call on tensors on `device`."""
    _validate(impl)
    if impl == 'auto' and _default_impl is not None:
        impl = _default_impl
    dev_type = torch.device(device).type if device is not None else 'cpu'
    if impl == 'auto':
        impl = 'cuda' if dev_type == 'cuda' else 'torch'
    if impl == 'cuda' and dev_type != 'cuda':
        reason = unavailable_reason()
        raise RuntimeError(
            f"impl='cuda' needs CUDA tensors; these lie on {dev_type}"
            + (f' ({reason})' if reason else ''))
    return impl


def fused_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, positions: torch.Tensor,
                          page_indices: torch.Tensor, *,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          impl: str = 'auto',
                          perturb: float = 0.0) -> torch.Tensor:
    """Paged attention over bf16/f32 or int8 pools (see module doc).
    `perturb` scales every score by (1 + perturb): a deliberately wrong
    kernel for tests to prove the parity pins bite."""
    global plain_calls
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f'expected q [B,S,Hq,D] and pools [Hkv,P,page,D], '
                         f'got {tuple(q.shape)}, {tuple(k_pages.shape)}, '
                         f'{tuple(v_pages.shape)}')
    batch, seq, num_q_heads, head_dim = q.shape
    num_kv_heads, total_pages, page_size, pool_dim = k_pages.shape
    if pool_dim != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(f'q heads {num_q_heads} x dim {head_dim} do not '
                         f'fit kv heads {num_kv_heads} x dim {pool_dim}')
    if tuple(positions.shape) != (batch, seq) or page_indices.ndim != 2 \
            or page_indices.shape[0] != batch:
        raise ValueError(f'positions {tuple(positions.shape)} / page '
                         f'indices {tuple(page_indices.shape)} do not '
                         f'match q {tuple(q.shape)}')
    if (k_scales is None) != (v_scales is None):
        raise ValueError('pass both k_scales and v_scales, or neither')
    if k_scales is not None and (
            tuple(k_scales.shape) != (total_pages, page_size)
            or tuple(v_scales.shape) != (total_pages, page_size)):
        raise ValueError(f'scales must be [{total_pages}, {page_size}]')
    if resolve_impl(impl, q.device) == 'torch':
        plain_calls += 1
        return fused_paged_attention_reference(
            q, k_pages, v_pages, positions, page_indices,
            k_scales=k_scales, v_scales=v_scales, perturb=perturb)
    return _launch(q, k_pages, v_pages, positions, page_indices,
                   k_scales, v_scales, perturb)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('paged_attention')
    lib.skypilot_paged_attention.restype = ctypes.c_int
    lib.skypilot_paged_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.skypilot_cuda_error_string.restype = ctypes.c_char_p
    lib.skypilot_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(q, k_pages, v_pages, positions, page_indices, k_scales,
            v_scales, perturb) -> torch.Tensor:
    global launches
    tensors = [q, k_pages, v_pages, positions, page_indices]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f'all tensors must lie on {q.device}, one '
                             f'lies on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernel takes contiguous tensors; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
    if q.dtype not in _Q_CODES:
        raise TypeError(f'q dtype {q.dtype} not in {list(_Q_CODES)}')
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f'pool dtype {k_pages.dtype} not in '
                        f'{list(_KV_CODES)}')
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scales is not None):
        raise TypeError('int8 pools need scale arrays, and only int8 '
                        'pools take them')
    if quantized and (k_scales.dtype != torch.float32
                      or v_scales.dtype != torch.float32):
        raise TypeError('scales must be float32')
    if positions.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError('positions and page_indices must be int32')
    batch, seq, num_q_heads, head_dim = q.shape
    num_kv_heads, total_pages, page_size, _ = k_pages.shape
    if head_dim > _MAX_HEAD_DIM or head_dim % 16:
        raise ValueError(f'the kernel takes head_dim <= {_MAX_HEAD_DIM} '
                         f'and a multiple of 16, got {head_dim}')
    lib = _library()
    fn = lib.skypilot_paged_attention
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr() if quantized else None,
             v_scales.data_ptr() if quantized else None,
             positions.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
             batch, seq, num_q_heads, num_kv_heads, head_dim, total_pages,
             page_size, page_indices.shape[1], _Q_CODES[q.dtype],
             _KV_CODES[k_pages.dtype], float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_cuda_error_string(err).decode()
        raise RuntimeError(f'paged attention kernel failed to launch: '
                           f'CUDA error {err} ({msg})')
    launches += 1
    return out


def fused_paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor,
                                    positions: torch.Tensor,
                                    page_indices: torch.Tensor, *,
                                    k_scales: Optional[torch.Tensor] = None,
                                    v_scales: Optional[torch.Tensor] = None,
                                    perturb: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each row's pages
    (dequantizing int8), f32 masked softmax with the kernel's
    fully-masked-row-is-zero rule."""
    from skypilot_tpu_torch.ops.paged_attention import _gather_kv
    head_dim = k_pages.shape[-1]
    max_len = page_indices.shape[1] * k_pages.shape[2]
    k_all, v_all = _gather_kv(q.shape[2], k_pages, v_pages, page_indices,
                              k_scales, v_scales)
    s = torch.einsum('bshd,bthd->bhst', q.float(),
                     k_all.float()) * (1.0 / math.sqrt(head_dim))
    if perturb:
        s = s * (1.0 + perturb)
    t_idx = torch.arange(max_len, device=q.device)
    mask = (t_idx[None, None, :] <= positions[:, :, None])[:, None]
    s = s.masked_fill(~mask, float('-inf'))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(s - m)
    denom = w.sum(dim=-1, keepdim=True)
    p = w / torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.einsum('bhst,bthd->bshd', p, v_all.float())
    return out.to(q.dtype)
