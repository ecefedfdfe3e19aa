"""Paged-attention kernel wrapper and dispatch (port of
skypilot_tpu/ops/pallas_paged.py:89-382).

`fused_paged_attention` has the reference's signature and semantics:
q [B, S, Hq, D]; positions int32 [B, S] — query s of row b attends
every cache index <= positions[b, s] (decode is S=1 with positions =
lengths - 1; chunks pass absolute positions); pools
[Hkv, P, page_size, D] in f32, bf16 or int8 (int8 needs the f32
[P, page_size] scale arrays, one scale per (page, slot) shared across
heads); page_indices int32 [B, pages_per_seq]. Returns [B, S, Hq, D]
in q.dtype; a row with nothing visible returns 0.

Dispatch. `IMPLS = ('auto', 'torch', 'cuda')`. 'auto' means the CUDA
kernel (csrc/paged_attention.cu) for CUDA tensors and the plain PyTorch
version `fused_paged_attention_reference` for CPU tensors; an
`impl_scope` override replaces 'auto' (the A/B hook). 'cuda' on CPU
tensors raises. There is no environment switch and no fallback: a
kernel that fails to build or launch raises.

Routes inside the kernel library, chosen by `choose_route`, a fixed
rule on dtypes and shapes (never a reaction to a failure):
  'split'   bf16 q over a bf16 or int8 pool, head_dim 64 or 128, page
            size 8, 16, 32 or 64, and S * G <= 16 query rows per kv head
            (decode): split-K over the page table, `split_plan` cuts it;
  'chunk'   the same dtypes, head_dims and page sizes with S * G > 16
            (prefill chunks): tensor-core (wgmma) tiles;
  'scalar'  everything else the library takes: f32 pools (the parity
            path), f32 q, other page sizes; head_dim <= 128 and a
            multiple of 16. A shape no route takes raises before any
            build.

`launches` counts wrapper calls that launched the kernel (each call is
`DEVICE_LAUNCHES_PER_CALL` device launch on every route: the split
route's merge runs in the last block of each (row, kv head)),
`route_launches` the same per route (`shape_launches` per route and S),
and `plain_calls` plain-version
calls through the wrapper. A call captured into a CUDA graph launches
nothing; models/decode_graph.py takes its counts back after the
capture and adds them at every replay.

Under capture the split route's partials come from the graph's private
pool (allocated per call, as eagerly) and its merge counters from a
per-device buffer that `reserve_graph_counters` allocates before the
capture.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

IMPLS: Tuple[str, ...] = ('auto', 'torch', 'cuda')

ROUTES: Tuple[str, ...] = ('scalar', 'split', 'chunk')

#: Kernel launches made by `fused_paged_attention` in this process.
launches = 0
#: The same, per route.
route_launches: Dict[str, int] = dict.fromkeys(ROUTES, 0)
#: The same, per (route, queries a row S): a verify chunk's S = K+1 apart
#: from prefill chunks and decode.
shape_launches: 'collections.Counter[Tuple[str, int]]' = \
    collections.Counter()
#: Device launches per kernel call, on every route.
DEVICE_LAUNCHES_PER_CALL = 1
#: Calls of the plain version made through `fused_paged_attention`.
plain_calls = 0

_default_impl: Optional[str] = None

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ROUTE_CODES = {name: i for i, name in enumerate(ROUTES)}
_MAX_HEAD_DIM = 128
#: What the split and chunk routes take.
TC_HEAD_DIMS = (64, 128)
TC_PAGE_SIZES = (8, 16, 32, 64)
#: Query rows per kv head (S * G) up to which a call takes the split route.
SPLIT_MAX_ROWS = 16
#: Split-route tiling: tokens a stage holds, the fewest tiles of a split
#: (one tile's fixed costs outweigh its bytes), the most splits of one
#: row, and the blocks the split count aims at per SM.
SPLIT_TILE = 32
MIN_SPLIT_TILES = 2
MAX_SPLITS = 32
SPLIT_BLOCKS_PER_SM = 2
#: The most splits a call may have with its tail splits (the kernel's
#: kMaxSplits).
SPLIT_LIMIT = 64


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
                          attend_len: Optional[int] = None,
                          perturb: float = 0.0) -> torch.Tensor:
    """Paged attention over bf16/f32 or int8 pools (see module doc).
    `attend_len` is the width the split route cuts the page table for
    (`split_plan`'s attend_tokens; the result does not depend on it
    beyond the last bits). `perturb` scales every score by
    (1 + perturb): a deliberately wrong kernel for tests to prove the
    parity pins bite."""
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
                   k_scales, v_scales, perturb, attend_len)


def choose_route(q_dtype: torch.dtype, kv_dtype: torch.dtype, seq: int,
                 num_q_heads: int, num_kv_heads: int, page_size: int,
                 head_dim: int) -> str:
    """The kernel route of a call (see module doc): a fixed rule on its
    dtypes and shapes. Raises ValueError for a shape no route takes."""
    if q_dtype not in _Q_CODES:
        raise TypeError(f'q dtype {q_dtype} not in {list(_Q_CODES)}')
    if kv_dtype not in _KV_CODES:
        raise TypeError(f'pool dtype {kv_dtype} not in {list(_KV_CODES)}')
    if head_dim > _MAX_HEAD_DIM or head_dim % 16:
        raise ValueError(f'the kernel takes head_dim <= {_MAX_HEAD_DIM} '
                         f'and a multiple of 16, got {head_dim}')
    if (q_dtype == torch.bfloat16 and kv_dtype != torch.float32
            and head_dim in TC_HEAD_DIMS and page_size in TC_PAGE_SIZES):
        rows = seq * (num_q_heads // num_kv_heads)
        return 'split' if rows <= SPLIT_MAX_ROWS else 'chunk'
    return 'scalar'


def split_plan(batch: int, num_kv_heads: int, rows: int, pages_per_seq: int,
               page_size: int, sm_count: int,
               attend_tokens: Optional[int] = None
               ) -> Tuple[int, int, int, int]:
    """How the split route cuts a call: (rows per block, row groups per
    kv head, splits per row, tokens per split). As many splits as let
    the (split, kv head, row group, batch row) blocks run in one wave
    of SPLIT_BLOCKS_PER_SM an SM (a second, partial wave would double
    the time of the last), each a whole number of SPLIT_TILE-token
    tiles, at least MIN_SPLIT_TILES where the table has them, at most
    MAX_SPLITS; the last split ends at the page table's end.

    `attend_tokens` (default: the table's width) is the width that the
    cut is made for. The table past it goes into tail splits of the
    same size, beyond the one-wave budget: an engine passes its
    max_total_len, and a --decode-chunk or --speculative engine's table
    carries write lookahead past that. Every row below attend_tokens
    then sums the same splits in the same order whatever the table's
    width (the tail splits are empty for it and add exact zeros to the
    merge), so chunked decode stays bit-identical to single-step decode.
    Only where the table is so much wider that SPLIT_LIMIT would be
    passed do the splits grow. A function of shapes only: the host
    cannot see row lengths without a sync."""
    rows_per_block = 4 if rows <= 4 else 8
    groups = -(-rows // rows_per_block)
    tiles = -(-pages_per_seq * page_size // SPLIT_TILE)
    cut = tiles
    if attend_tokens is not None:
        cut = min(tiles, max(1, -(-attend_tokens // SPLIT_TILE)))
    slots = SPLIT_BLOCKS_PER_SM * sm_count
    n_split = max(1, min(slots // (batch * num_kv_heads * groups),
                         cut // MIN_SPLIT_TILES, MAX_SPLITS))
    per = max(-(-cut // n_split), -(-tiles // SPLIT_LIMIT))
    return rows_per_block, groups, -(-tiles // per), per * SPLIT_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: The split route's merge counters: per (device index, stream) for
#: eager calls, created on first use, and per (device index, None) for
#: calls being captured into a CUDA graph, created beforehand by
#: `reserve_graph_counters` (an allocation made during a capture would
#: come from that graph's private pool). They start at zero and every
#: launch leaves them at zero (the last block of each (row, kv head)
#: resets its own), so one buffer serves every call on its stream, and
#: the graph buffer every graph as long as graphs replay on one stream
#: at a time.
_counters: Dict[Tuple[int, Optional[int]], torch.Tensor] = {}
_MIN_COUNTERS = 1024


def reserve_graph_counters(device: torch.device,
                           n: int = _MIN_COUNTERS) -> None:
    """Allocate (outside any capture) the merge counters that captured
    split-route calls on `device` use, at least `n` of them."""
    key = (torch.device(device).index or 0, None)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        _counters[key] = torch.zeros(max(n, _MIN_COUNTERS),
                                     dtype=torch.int32, device=device)


def _counter_buffer(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        buf = _counters.get((device.index, None))
        if buf is None or buf.numel() < n:
            raise RuntimeError(
                f'capturing a split-route paged attention call that needs '
                f'{n} merge counters: call paged_kernel.'
                f'reserve_graph_counters({device}, {n}) before the capture')
        return buf
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, _MIN_COUNTERS), dtype=torch.int32,
                          device=device)
        _counters[key] = buf
    return buf


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('paged_attention')
    lib.skypilot_paged_attention.restype = ctypes.c_int
    lib.skypilot_paged_attention.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
        + [ctypes.c_float, ctypes.c_void_p])
    lib.skypilot_cuda_error_string.restype = ctypes.c_char_p
    lib.skypilot_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(q, k_pages, v_pages, positions, page_indices, k_scales,
            v_scales, perturb, attend_len=None) -> torch.Tensor:
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
    for t in tensors[:3] + tensors[5:]:
        if t.data_ptr() % 16:
            raise ValueError('the kernel takes 16-byte aligned q, pools '
                             'and scales')
    if v_pages.dtype != k_pages.dtype:
        raise TypeError('k_pages and v_pages must share a dtype')
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
    pages_per_seq = page_indices.shape[1]
    route = choose_route(q.dtype, k_pages.dtype, seq, num_q_heads,
                         num_kv_heads, page_size, head_dim)
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials = counters = None
    n_split = split_tokens = 0
    if route == 'split':
        rows = seq * (num_q_heads // num_kv_heads)
        rows_per_block, groups, n_split, split_tokens = split_plan(
            batch, num_kv_heads, rows, pages_per_seq, page_size,
            _sm_count(q.device.index or 0), attend_len)
        pairs = batch * num_kv_heads * groups
        partials = torch.empty(pairs * n_split * rows_per_block
                               * (head_dim + 2), dtype=torch.float32,
                               device=q.device)
        counters = _counter_buffer(q.device, stream, pairs)
    # The launch goes from q's device (its stream belongs to it, and the
    # library keeps its kernel attributes per device).
    with torch.cuda.device_of(q):
        err = lib.skypilot_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            positions.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if counters is None else counters.data_ptr(),
            batch, seq, num_q_heads, num_kv_heads, head_dim, total_pages,
            page_size, pages_per_seq, _Q_CODES[q.dtype],
            _KV_CODES[k_pages.dtype], _ROUTE_CODES[route], n_split,
            split_tokens, float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_cuda_error_string(err).decode()
        raise RuntimeError(f'paged attention kernel ({route} route) failed '
                           f'to launch: CUDA error {err} ({msg})')
    launches += 1
    route_launches[route] += 1
    shape_launches[(route, seq)] += 1
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


def fused_paged_attention_split_reference(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        positions: torch.Tensor, page_indices: torch.Tensor, *,
        split_tokens: int, k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        perturb: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the split route's arithmetic: the page
    table cut into splits of `split_tokens` tokens, a partial (m, l,
    acc) per split, merged by log-sum-exp; int8 scales folded in without
    a dequantized copy (score t times k_scale[t] after q.k, weight t
    times v_scale[t] before p.v). An empty split is (-inf, 0, 0); a row
    empty in every split returns 0. f32 throughout."""
    from skypilot_tpu_torch.ops.paged_attention import _gather_kv
    batch, _, num_q_heads, head_dim = q.shape
    max_len = page_indices.shape[1] * k_pages.shape[2]
    # Raw pool values per query head (no scales), [B, T, Hq, D].
    k_all, v_all = _gather_kv(num_q_heads, k_pages, v_pages, page_indices)
    s = torch.einsum('bshd,bthd->bhst', q.float(), k_all.float())
    s = s * ((1.0 + perturb) / math.sqrt(head_dim))
    v_w = torch.ones(batch, max_len, device=q.device)
    if k_scales is not None:
        idx = page_indices.long()
        s = s * k_scales[idx].reshape(batch, 1, 1, max_len)
        v_w = v_scales[idx].reshape(batch, max_len)
    t_idx = torch.arange(max_len, device=q.device)
    visible = t_idx[None, None, :] <= positions[:, :, None]
    s = s.masked_fill(~visible[:, None], float('-inf'))
    m_all, l_all, acc_all = [], [], []
    for t0 in range(0, max_len, split_tokens):
        part = s[..., t0:t0 + split_tokens]                  # [B, H, S, T]
        m = part.amax(dim=-1)
        w = torch.exp(part - torch.where(torch.isfinite(m), m,
                                         torch.zeros_like(m))[..., None])
        m_all.append(m)
        l_all.append(w.sum(-1))
        acc_all.append(torch.einsum(
            'bhst,bthd->bhsd', w * v_w[:, None, None, t0:t0 + split_tokens],
            v_all[:, t0:t0 + split_tokens].float()))
    m, l, acc = torch.stack(m_all), torch.stack(l_all), torch.stack(acc_all)
    big = m.amax(dim=0)
    big = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
    w = torch.exp(m - big)                                   # 0 where empty
    total = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0) / torch.where(
        total > 0, total, torch.ones_like(total))[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# -- analytic HBM roofline (the port's copy of
# skypilot_tpu/ops/pallas_paged.py `bytes_per_token_model`) --------------
def bytes_per_token_model(*, num_layers: int, kv_values_per_token: int,
                          num_q_heads: int, head_dim: int,
                          page_size: int, pages_per_seq: int,
                          kv_elem_bytes: int, quantized: bool,
                          impl: str, weight_bytes: int = 0,
                          batch: int = 1,
                          lora_bytes_per_row: int = 0
                          ) -> Dict[str, float]:
    """Modeled HBM bytes one decode step moves PER SEQUENCE (= per
    generated token), from the engine's page geometry: the cache walked
    over the row's whole page table, `kv_values_per_token` values a
    token a layer (2 x Hkv x D for K and V; the dense path's MLA latents
    are d_c + d_rope), and the f32 scale rows for int8,
    the weights amortized over the decode batch, each row's LoRA factor
    rows. The dequantize-and-expand term applies to the reference's
    'xla' gather route only; this port's impls ('cuda', 'torch') never
    take it. Plain arithmetic on host ints: no device read."""
    tokens_walked = pages_per_seq * page_size
    pool = tokens_walked * kv_values_per_token * kv_elem_bytes * num_layers
    scales = (2 * tokens_walked * 4 * num_layers) if quantized else 0
    dequant = 0
    if impl == 'xla':
        elem = 4 if quantized else kv_elem_bytes
        dequant = (2 * 2 * tokens_walked * num_q_heads * head_dim
                   * elem * num_layers)
    weights = weight_bytes / max(batch, 1)
    total = pool + scales + dequant + weights + lora_bytes_per_row
    return {
        'impl': impl,
        'context_tokens_walked': tokens_walked,
        'kv_pool_bytes': pool,
        'kv_scale_bytes': scales,
        'dequant_materialize_bytes': dequant,
        'weight_bytes_amortized': round(weights, 1),
        'lora_bytes': lora_bytes_per_row,
        'total_bytes_per_token': round(total + 0.0, 1),
    }
