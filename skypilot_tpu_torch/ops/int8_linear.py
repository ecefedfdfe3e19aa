"""W8A16 linear: the kernel behind every int8 projection
(`--weight-dtype int8`), its plain version and its dispatch.

`int8_linear(x, q, scale, bias)` computes y = x . dequant(q, scale)^T +
bias: x [..., in] in bf16 or f32, q [out, in] int8 (the transpose of the
reference's `kernel_q`, in nn.Linear's orientation), scale [out] f32 (one
per output channel), bias [out] in x's dtype or None; y [..., out] in x's
dtype. The plain version `int8_linear_reference` follows the reference's
order exactly: `dequantize_params` (skypilot_tpu/inference/quant.py:86)
forms the f32 product `q * scale`, and the Flax `Dense(dtype=...)` that
consumes it casts it to the compute dtype before its matmul.

No Pallas kernel stands behind this one: the reference dequantizes inside
its jitted serving functions and XLA fuses the product into the matmul,
so only int8 is streamed. `csrc/int8_linear.cu` does that by hand: int8
tiles by 16-byte cp.async, converted to bf16 in registers on their way to
mma.sync (f32 x: CUDA-core FMAs in the same source). `plan` cuts the grid
from the shapes alone: rows and channels a block and the K slices of a
thread-block cluster, whose blocks sum their partials through distributed
shared memory in a fixed order (bit-identical calls, no scratch, nothing
allocated but the output, so a call can be captured in a CUDA graph).

Dispatch is `ops/paged_kernel.py`'s (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is the
CUDA kernel for CUDA tensors and the plain version for CPU tensors; an
`impl_scope('torch')` routes the card's calls to the plain version (the
dequantize-then-`F.linear` A/B); 'cuda' on CPU tensors raises. No
environment switch, no fallback. `route_scope(impl)` overrides 'auto'
for this kernel alone (the A/B of the dequantize route with the other
kernels still on the card). `launches` counts kernel calls (one device
launch each), `launches_by_rows` the same calls by their row count M,
`launches_by_shape` by the weight's (out, in) shape, and `plain_calls`
plain-version calls made through the wrapper. x is flattened to
[M, in]; a non-contiguous x (or one whose data is not 16-byte aligned)
is copied first, which a contiguous one never is.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.ops.paged_kernel import (  # noqa: F401
    IMPLS, available, impl_scope, resolve_impl, unavailable_reason)

#: Kernel calls made by `int8_linear` in this process.
launches = 0
#: The same calls by their row count M (x's rows): decode rounds and
#: prefill chunks apart.
launches_by_rows = collections.Counter()
#: The same calls by the weight's (out_features, in_features): a tensor
#: shard's projections apart from the whole ones.
launches_by_shape = collections.Counter()
#: Calls of the plain version made through `int8_linear`.
plain_calls = 0
#: Device launches per kernel call.
DEVICE_LAUNCHES_PER_CALL = 1
#: k a kernel stage holds; a cluster's K slices are whole stages.
TILE_K = 128
#: Rows of x a block takes, by M (the smallest that holds M, up to 64).
ROW_TILES = (8, 16, 32, 64)
#: The most K slices (blocks of a cluster: the portable cluster size).
MAX_SLICES = 8
#: Blocks the grid aims at, per SM.
BLOCKS_PER_SM = 1.5

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_route: Optional[str] = None


@contextlib.contextmanager
def route_scope(impl: str):
    """Route this kernel's 'auto' calls to `impl` inside the block,
    whatever `impl_scope` says for the other kernels."""
    global _route
    if impl not in IMPLS:
        raise ValueError(f'unknown kernel impl {impl!r} '
                         f'(choices: {", ".join(IMPLS)})')
    prev, _route = _route, impl
    try:
        yield
    finally:
        _route = prev


def plan(m: int, n: int, k: int, sm_count: int) -> Tuple[int, int, int]:
    """The kernel's tiling of a call: (rows a block BT, channels a block
    BN, K slices KS). BT is the smallest row tile that holds M (64 past
    it); BN is 64, or 32 where even MAX_SLICES slices of 64-channel
    tiles would leave SMs idle; KS is the fewest slices (1, 2, 4, 8)
    that give BLOCKS_PER_SM blocks an SM, with at least two stages of K
    a slice. A function of shapes only."""
    bt = next((b for b in ROW_TILES if m <= b), ROW_TILES[-1])
    tiles_m = -(-m // bt)
    bn = 64
    if -(-n // 64) * tiles_m * MAX_SLICES < sm_count:
        bn = 32
    tiles = -(-n // bn) * tiles_m
    units = -(-k // TILE_K)
    ks = 1
    while ks < MAX_SLICES and tiles * ks < BLOCKS_PER_SM * sm_count \
            and units >= 4 * ks:
        ks *= 2
    return bt, bn, ks


def bytes_bound(m: int, n: int, k: int, x_bytes: int) -> int:
    """Bytes a call must move: the int8 weights, the f32 scales, x and y
    (each read or written once; no bias)."""
    return n * k + 4 * n + x_bytes * m * k + x_bytes * m * n


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, impl: str = 'auto',
                perturb: float = 0.0) -> torch.Tensor:
    """y = x . dequant(q, scale)^T + bias (see module doc). `perturb`
    scales every channel's scale by (1 + perturb): a deliberately wrong
    kernel for tests to prove the parity pins bite."""
    global plain_calls
    if q.ndim != 2 or q.dtype != torch.int8:
        raise TypeError(f'q must be int8 [out, in], got {q.dtype} '
                        f'{tuple(q.shape)}')
    n, k = q.shape
    if x.shape[-1] != k:
        raise ValueError(f'x [..., {x.shape[-1]}] does not fit q [{n}, {k}]')
    if tuple(scale.shape) != (n,) or scale.dtype != torch.float32:
        raise TypeError(f'scale must be f32 [{n}], got {scale.dtype} '
                        f'{tuple(scale.shape)}')
    if bias is not None and (tuple(bias.shape) != (n,)
                             or bias.dtype != x.dtype):
        raise TypeError(f'bias must be [{n}] in {x.dtype}, got '
                        f'{bias.dtype} {tuple(bias.shape)}')
    if x.dtype not in _CODES:
        raise TypeError(f'x dtype {x.dtype} not in {list(_CODES)}')
    if impl == 'auto' and _route is not None:
        impl = _route
    if resolve_impl(impl, x.device) == 'torch':
        plain_calls += 1
        return int8_linear_reference(x, q, scale, bias, perturb=perturb)
    return _launch(x, q, scale, bias, perturb)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('int8_linear')
    lib.skypilot_int8_linear.restype = ctypes.c_int
    lib.skypilot_int8_linear.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    lib.skypilot_int8_linear_error_string.restype = ctypes.c_char_p
    lib.skypilot_int8_linear_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, q, scale, bias, perturb):
    global launches
    n, k = q.shape
    for t in (q, scale) + ((bias,) if bias is not None else ()):
        if t.device != x.device:
            raise ValueError(f'all tensors must lie on {x.device}, one '
                             f'lies on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernel takes contiguous weights; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
    if k % 16:
        raise ValueError(f'the kernel takes in_features a multiple of 16, '
                         f'got {k}')
    if q.data_ptr() % 16:
        raise ValueError('q must be 16-byte aligned')
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bt, bn, ks = plan(m, n, k, _sm_count(x.device.index or 0))
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device_of(x):  # x's stream, x's kernel attributes
        err = lib.skypilot_int8_linear(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            m, n, k, bt, bn, ks, _CODES[x.dtype], float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_int8_linear_error_string(err).decode()
        raise RuntimeError(f'int8 linear kernel failed to launch: CUDA '
                           f'error {err} ({msg})')
    launches += 1
    launches_by_rows[m] += 1
    launches_by_shape[(n, k)] += 1
    return y.reshape(*lead, n)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
               perturb: float = 0.0) -> torch.Tensor:
    """The dense [out, in] weight in `dtype`: the f32 product q * scale
    (the reference's `dequantize_params`), cast as its Dense casts."""
    s = scale * (1.0 + perturb) if perturb else scale
    return (q.float() * s[:, None]).to(dtype)


def int8_linear_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          perturb: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: dequantize, then `F.linear`."""
    return F.linear(x, dequantize(q, scale, x.dtype, perturb), bias)
