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
so only int8 is streamed. `csrc/int8_linear.cu` does that by hand on
three routes, which `plan` picks from the shapes alone: 'mma' (bf16 x, M
up to WGMMA_MIN_ROWS: decode; int8 tiles by 16-byte cp.async, converted
to bf16 in registers on their way to mma.sync), 'wgmma' (bf16 x, larger
M: prefill chunks; TMA-fed tiles, the weights converted in registers
into wgmma's A operand) and 'f32' (f32 x: CUDA-core FMAs in the 'mma'
route's kernel). `plan` also cuts the grid: rows and channels a block
and the K slices of a thread-block cluster, whose blocks sum their
partials through distributed shared memory in a fixed order
(bit-identical calls, no scratch, nothing allocated but the output, so a
call can be captured in a CUDA graph).

Dispatch is `ops/paged_kernel.py`'s (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is the
CUDA kernel for CUDA tensors and the plain version for CPU tensors; an
`impl_scope('torch')` routes the card's calls to the plain version (the
dequantize-then-`F.linear` A/B); 'cuda' on CPU tensors raises. No
environment switch, no fallback. `route_scope(impl)` overrides 'auto'
for this kernel alone (the A/B of the dequantize route with the other
kernels still on the card). `launches` counts kernel calls (one device
launch each), `launches_by_rows` the same calls by their row count M,
`launches_by_shape` by the weight's (out, in) shape,
`launches_by_route` by (route, out, in), and `plain_calls` plain-version
calls made through the wrapper. x is flattened to
[M, in]; a non-contiguous x (or one whose data is not 16-byte aligned)
is copied first, which a contiguous one never is.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

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
#: The kernel's routes (see module doc).
ROUTES = ('mma', 'wgmma', 'f32')
#: The same calls by (route, out_features, in_features): a route's
#: total is the sum over its shapes.
launches_by_route = collections.Counter()
#: Calls of the plain version made through `int8_linear`.
plain_calls = 0
#: Device launches per kernel call.
DEVICE_LAUNCHES_PER_CALL = 1
#: bf16 calls of more rows than this take the 'wgmma' route (from 48
#: rows it is the faster one at most shapes; PERF.md says why 64).
WGMMA_MIN_ROWS = 64
#: k a stage holds, by route; a cluster's K slices are whole stages.
TILE_K = {'mma': 128, 'f32': 128, 'wgmma': 64}
#: Rows of x a block takes on the 'mma' / 'f32' routes, by M (the
#: smallest that holds M, up to 64).
ROW_TILES = (8, 16, 32, 64)
#: (rows, channels) a block takes on the 'wgmma' route, in order of
#: preference; 128 channels take an SM alone and are tried unsliced only.
WGMMA_TILES = ((128, 128), (128, 64), (64, 64))
#: The most K slices (blocks of a cluster: the portable cluster size).
MAX_SLICES = 8
#: Blocks the 'mma' / 'f32' grid aims at, per SM.
BLOCKS_PER_SM = 1.5

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {'mma': 0, 'f32': 0, 'wgmma': 1}


class Plan(NamedTuple):
    """A call's route and tiling: rows and channels a block, K slices."""
    route: str
    bt: int
    bn: int
    ks: int


_impl_override: Optional[str] = None


@contextlib.contextmanager
def route_scope(impl: str):
    """Route this kernel's 'auto' calls to `impl` inside the block,
    whatever `impl_scope` says for the other kernels."""
    global _impl_override
    if impl not in IMPLS:
        raise ValueError(f'unknown kernel impl {impl!r} '
                         f'(choices: {", ".join(IMPLS)})')
    prev, _impl_override = _impl_override, impl
    try:
        yield
    finally:
        _impl_override = prev


def plan(m: int, n: int, k: int, sm_count: int,
         dtype: torch.dtype = torch.bfloat16,
         route: Optional[str] = None) -> Plan:
    """The kernel's route and tiling of a call, a function of shapes
    only. The route is 'f32' for f32 x, else 'wgmma' past WGMMA_MIN_ROWS
    rows and 'mma' up to it (`route` asks for one route's tiling at any
    M of its dtype: profile_int8_linear.py times both at one shape).

    'mma' / 'f32': BT is the smallest row tile that holds M (64 past
    it); BN is 64, or 32 where even MAX_SLICES slices of 64-channel tiles
    would leave SMs idle; KS is the fewest slices (1, 2, 4, 8) that give
    BLOCKS_PER_SM blocks an SM, with at least two stages of K a slice.
    'wgmma': (BT, BN) is the first of WGMMA_TILES whose tiles give a
    block an SM (the 128-channel tile with no slices, the others with up
    to MAX_SLICES, at least two stages a slice); KS the fewest slices
    that do (measured on an H100: the fastest such tiling at every timed
    shape, PERF.md)."""
    if route is None:
        route = ('f32' if dtype == torch.float32 else
                 'wgmma' if m > WGMMA_MIN_ROWS else 'mma')
    if route not in ROUTES:
        raise ValueError(f'unknown int8_linear route {route!r}')
    if (route == 'f32') != (dtype == torch.float32):
        raise ValueError(f'route {route!r} does not take {dtype} x')
    units = -(-k // TILE_K[route])
    if route == 'wgmma':
        for bt, bn in WGMMA_TILES:
            most = 1 if bn == 128 else min(MAX_SLICES, max(1, units // 2))
            tiles = -(-n // bn) * -(-m // bt)
            if tiles * most >= sm_count:
                break
        target = sm_count
    else:
        bt = next((b for b in ROW_TILES if m <= b), ROW_TILES[-1])
        tiles_m = -(-m // bt)
        bn = 64
        if -(-n // 64) * tiles_m * MAX_SLICES < sm_count:
            bn = 32
        tiles = -(-n // bn) * tiles_m
        target = BLOCKS_PER_SM * sm_count
    ks = 1
    while ks < MAX_SLICES and tiles * ks < target and units >= 4 * ks:
        ks *= 2
    return Plan(route, bt, bn, ks)


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
    if impl == 'auto' and _impl_override is not None:
        impl = _impl_override
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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
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
    tiling = plan(m, n, k, _sm_count(x.device.index or 0), x.dtype)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device_of(x):  # x's stream, x's kernel attributes
        err = lib.skypilot_int8_linear(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            m, n, k, _ROUTE_CODES[tiling.route], tiling.bt, tiling.bn,
            tiling.ks, _CODES[x.dtype], float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_int8_linear_error_string(err).decode()
        raise RuntimeError(f'int8 linear kernel ({tiling}) failed to '
                           f'launch: CUDA error {err} ({msg})')
    launches += 1
    launches_by_rows[m] += 1
    launches_by_shape[(n, k)] += 1
    launches_by_route[(tiling.route, n, k)] += 1
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
