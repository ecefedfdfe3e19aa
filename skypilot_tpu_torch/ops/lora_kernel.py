"""Fused QKV LoRA kernel wrapper and dispatch (port of
`fused_qkv_lora_delta` / `qkv_lora_dispatches_per_layer`,
skypilot_tpu/ops/pallas_paged.py:385-447).

`fused_qkv_lora_delta(x, wq_f, wk_f, wv_f, adapter_ids)` has the
reference's signature and result: x [B, S, d_in]; each factors dict
holds stacked `a [N, d_in, r]` / `b [N, r, d_out]`; adapter_ids int32
[B] selects each row's adapter. Returns the UNSCALED f32 deltas
(dq, dk, dv), each [B, S, d_out]; the caller adds
`(scale * d).to(y.dtype)`, which matches `lora.apply_delta` (same
(x @ a) @ b contraction order, in f32).

Dispatch is `ops/paged_kernel.py`'s (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is
the CUDA kernel (csrc/qkv_lora.cu) for CUDA tensors and the plain
version `fused_qkv_lora_delta_reference` for CPU tensors; an
`impl_scope` override replaces 'auto' for both kernels; 'cuda' on CPU
tensors raises. No environment switch, no fallback. `launches` counts
kernel calls (one call = `DEVICE_LAUNCHES_PER_CALL` device launches)
and `plain_calls` plain-version calls made through the wrapper.

The kernel groups the batch's rows by adapter on the device: clusters
of `CLUSTER` blocks, one per (distinct adapter, tile of up to
`TILE_ROWS` (b, s) rows, projection, column tile), over a grid that
`grid_tiles` bounds from B, S and N alone, so nothing here reads the
ids on the host and a call can be captured in a CUDA graph.
`fused_qkv_lora_delta_grouped_reference` is the plain version of that
partition; `fused_qkv_lora_delta_reference` and `gathered_delta` stay
the plain version the kernel is held to.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

# One impl switch routes both kernels, as pallas_paged.resolve_impl does
# in the reference.
from skypilot_tpu_torch.ops.paged_kernel import (  # noqa: F401
    IMPLS, impl_scope, resolve_impl, unavailable_reason)

#: Kernel calls made by `fused_qkv_lora_delta` in this process.
launches = 0
#: Calls of the plain version made through `fused_qkv_lora_delta`.
plain_calls = 0
#: Device launches per kernel call: one cluster-launched kernel.
DEVICE_LAUNCHES_PER_CALL = 1
#: Blocks of a cluster: each shrinks 1/CLUSTER of d_in.
CLUSTER = 8
#: (b, s) rows of one adapter in a row tile.
TILE_ROWS = 64

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANK = 128


def qkv_lora_dispatches_per_layer(impl: str) -> int:
    """Batched-LoRA dispatches for the three QKV projections of one
    layer on a resolved route: the kernel folds them into ONE call (of
    `DEVICE_LAUNCHES_PER_CALL` device launches); the plain version
    runs one gather+matmul chain per projection. profile_decode.py
    holds a traced LoRA round's kernel launches to this count."""
    if impl not in IMPLS:
        raise ValueError(f'unknown impl {impl!r} (choices: '
                         f'{", ".join(IMPLS)})')
    return 1 if impl == 'cuda' else 3


def fused_qkv_lora_delta(x: torch.Tensor, wq_factors: Dict,
                         wk_factors: Dict, wv_factors: Dict,
                         adapter_ids: torch.Tensor, *, impl: str = 'auto',
                         perturb: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """UNSCALED f32 LoRA deltas for wq/wk/wv (see module doc).
    `perturb` scales every delta by (1 + perturb): a deliberately wrong
    kernel for tests to prove the parity pins bite."""
    global plain_calls
    factors = (wq_factors, wk_factors, wv_factors)
    if x.ndim != 3:
        raise ValueError(f'expected x [B, S, d_in], got {tuple(x.shape)}')
    batch, _, d_in = x.shape
    n, _, rank = wq_factors['a'].shape
    for f in factors:
        a, b = f['a'], f['b']
        if a.ndim != 3 or b.ndim != 3 or tuple(a.shape) != (n, d_in, rank) \
                or tuple(b.shape[:2]) != (n, rank):
            raise ValueError(
                f'factors must be a [{n}, {d_in}, {rank}] / b [{n}, '
                f'{rank}, d_out]; got {tuple(a.shape)} / {tuple(b.shape)}')
    if tuple(adapter_ids.shape) != (batch,):
        raise ValueError(f'adapter_ids must be [{batch}], got '
                         f'{tuple(adapter_ids.shape)}')
    if resolve_impl(impl, x.device) == 'torch':
        plain_calls += 1
        return fused_qkv_lora_delta_reference(x, *factors, adapter_ids,
                                              perturb=perturb)
    return _launch(x, factors, adapter_ids, perturb)


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def grid_tiles(batch: int, seq: int, n_slots: int) -> int:
    """The kernel grid's bound on (adapter, row tile) pairs, from shapes
    alone: the ids fall into at most min(B, N + 1) groups (every id
    outside [0, N) into one), and groups of r_g rows take
    sum ceil(r_g S / TILE_ROWS) <= ceil(B S / TILE_ROWS) + groups - 1
    tiles."""
    return -(-batch * seq // TILE_ROWS) + min(batch, n_slots + 1) - 1


def d_in_slices(d_in: int) -> List[Tuple[int, int]]:
    """The d_in rows each block of a cluster shrinks, in cluster order:
    ceil(d_in / CLUSTER) rounded up to 16 (the products' k step), the
    last slices shorter or empty."""
    width = _round_up(-(-d_in // CLUSTER), 16)
    return [(min(c * width, d_in), min((c + 1) * width, d_in))
            for c in range(CLUSTER)]


def expand_columns(d_out: int, rows: int, rank: int,
                   factor_bytes: int) -> List[Tuple[int, int]]:
    """The column slices the blocks expand, in grid order: at most 512,
    256 or 128 columns a block as a tile holds <= 16, <= 32 or <= 64 of
    the call's `rows` (B * S) and the b slice fits 32 KB; a projection
    wider than CLUSTER such slices takes more clusters."""
    tile = min(TILE_ROWS, rows)
    cap = next((w for w in (512, 256) if tile * w <= 8192
                and rank * w * factor_bytes <= 32768), 128)
    clusters = -(-d_out // (CLUSTER * cap))
    width = _round_up(-(-d_out // (clusters * CLUSTER)), 8)
    return [(c0, min(c0 + width, d_out))
            for c0 in range(0, clusters * CLUSTER * width, width)
            if c0 < d_out]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('qkv_lora')
    lib.skypilot_qkv_lora.restype = ctypes.c_int
    lib.skypilot_qkv_lora.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_void_p])
    lib.skypilot_qkv_lora_error_string.restype = ctypes.c_char_p
    lib.skypilot_qkv_lora_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(x, factors, adapter_ids, perturb):
    global launches
    tensors = [x, adapter_ids] + [f[k] for f in factors for k in ('a', 'b')]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f'all tensors must lie on {x.device}, one '
                             f'lies on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernel takes contiguous tensors; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
    if x.dtype not in _CODES:
        raise TypeError(f'x dtype {x.dtype} not in {list(_CODES)}')
    f_dtype = factors[0]['a'].dtype
    if f_dtype not in _CODES or any(f[k].dtype != f_dtype for f in factors
                                    for k in ('a', 'b')):
        raise TypeError(f'the six factor arrays must share one dtype in '
                        f'{list(_CODES)}')
    if adapter_ids.dtype != torch.int32:
        raise TypeError('adapter_ids must be int32')
    batch, seq, d_in = x.shape
    n, _, rank = factors[0]['a'].shape
    if not 1 <= rank <= _MAX_RANK:
        raise ValueError(f'the kernel takes ranks 1..{_MAX_RANK}, got {rank}')
    d_outs = [f['b'].shape[2] for f in factors]
    outs = [torch.empty((batch, seq, d), dtype=torch.float32,
                        device=x.device) for d in d_outs]
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.skypilot_qkv_lora(
        x.data_ptr(), *[f[k].data_ptr() for f in factors for k in ('a', 'b')],
        adapter_ids.data_ptr(), *[o.data_ptr() for o in outs], batch, seq,
        d_in, n, rank, *d_outs, grid_tiles(batch, seq, n), _CODES[x.dtype],
        _CODES[f_dtype], float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_qkv_lora_error_string(err).decode()
        raise RuntimeError(f'QKV LoRA kernel failed to launch: CUDA error '
                           f'{err} ({msg})')
    launches += 1
    return tuple(outs)


def fused_qkv_lora_delta_reference(x: torch.Tensor, wq_factors: Dict,
                                   wk_factors: Dict, wv_factors: Dict,
                                   adapter_ids: torch.Tensor, *,
                                   perturb: float = 0.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of the kernel: `gathered_delta` per
    projection."""
    outs = [gathered_delta(x, f, adapter_ids)
            for f in (wq_factors, wk_factors, wv_factors)]
    return tuple(d * (1.0 + perturb) if perturb else d for d in outs)


def gathered_delta(x: torch.Tensor, factors: Dict,
                   adapter_ids: torch.Tensor) -> torch.Tensor:
    """(x @ a) @ b in f32 with each row's stacked factors gathered by
    `adapter_ids`: one projection's unscaled LoRA delta [B, S, d_out]."""
    h = torch.bmm(x.float(), factors['a'][adapter_ids].float())
    return torch.bmm(h, factors['b'][adapter_ids].float())


def fused_qkv_lora_delta_grouped_reference(
        x: torch.Tensor, wq_factors: Dict, wk_factors: Dict,
        wv_factors: Dict, adapter_ids: torch.Tensor, *,
        perturb: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the kernel's partition: the distinct
    adapter keys in sorted order (ids outside [0, N) share the key N and
    give NaN rows), each key's (b, s) rows in row order cut into tiles
    of TILE_ROWS, h = the CLUSTER d_in slices' partial products summed
    in slice order, and the expand by `expand_columns`' slices."""
    factors = (wq_factors, wk_factors, wv_factors)
    batch, seq, d_in = x.shape
    n, _, rank = wq_factors['a'].shape
    ids = adapter_ids.long()
    keys = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    xf = x.float().reshape(batch * seq, d_in)
    outs = [torch.empty((batch * seq, f['b'].shape[2]), dtype=torch.float32,
                        device=x.device) for f in factors]
    steps = torch.arange(seq, device=x.device)
    for key in torch.unique(keys).tolist():
        members = torch.nonzero(keys == key).flatten()
        rows = (members[:, None] * seq + steps).flatten()
        for t0 in range(0, rows.numel(), TILE_ROWS):
            tile = rows[t0:t0 + TILE_ROWS]
            for f, out in zip(factors, outs):
                if key == n:
                    out[tile] = float('nan')
                    continue
                a, b = f['a'][key].float(), f['b'][key].float()
                h = torch.zeros((tile.numel(), rank), device=x.device)
                for k0, k1 in d_in_slices(d_in):
                    h = h + xf[tile, k0:k1] @ a[k0:k1]
                for c0, c1 in expand_columns(out.shape[1], batch * seq, rank,
                                             f['b'].element_size()):
                    out[tile, c0:c1] = h @ b[:, c0:c1]
    return tuple((o * (1.0 + perturb) if perturb else o).reshape(
        batch, seq, -1) for o in outs)
