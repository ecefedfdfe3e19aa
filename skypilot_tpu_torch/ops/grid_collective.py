"""The serving grid's collective: the kernel behind `Grid`'s sums, maxima,
gathers and broadcasts, its plain version and its dispatch.

No Pallas kernel stands behind this one: on the TPU the reference serves a
grid as one XLA program and GSPMD inserts the all-reduces over ICI
(skypilot_tpu/parallel/serving.py:1-24). `csrc/grid_collective.cu` does
that on H100s: a `Team` is an ordered list of ranks, one a grid device
(a device may repeat), and each op is one launch on every distinct card of
the team, acting for the ranks that live there. Over distinct cards the
cards trade their parts over NVLink through exchange buffers that `Team`
allocates once, at startup, after enabling peer access between every pair
(a pair without it raises: nothing goes through the host); on one card
named N times the one launch reads every part directly.

  - `all_reduce(parts, team, op)`: 'sum' accumulates in f32 in rank order
    0..N-1 and casts back to the parts' dtype (f32 or bf16), 'max' is
    `torch.maximum` in rank order; every rank gets the result (ranks on one
    card share one tensor, as the plain version's do);
  - `gather(parts, team)`: the parts' last axes concatenated in rank order,
    on rank 0's device;
  - `broadcast(src, team)`: rank 0's tensor on every rank's device (ranks
    on rank 0's card get `src` itself).

The plain versions (`all_reduce_reference`, `gather_reference`,
`broadcast_reference`) are the grid's helpers as they were: copies to the
first device with `Tensor.to`, combined there. They are the CPU route and
what the kernel is held to, bit for bit.

Dispatch is `ops/paged_kernel.py`'s (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason`): 'auto' is the kernel for CUDA
tensors and the plain version for CPU tensors; 'cuda' on CPU tensors
raises; no environment switch, no fallback. `launches` counts device
launches (one a card an op, and one more a piece where an operand is
larger than a slot), `launches_by_op`, `launches_by_device` and
`launches_by_size` the same by op, by card and by (op, bytes a rank),
`plain_calls` plain-version calls. `next_up` moves a part one ulp of
its dtype up: the checks' deliberately wrong input.

Sizes: block b of a launch takes bytes [b, b + 1) x BLOCK_BYTES of each
part, in every op, so its flags guard the same bytes whatever ran before
(csrc/grid_collective.cu); a launch takes at most MAX_BLOCKS blocks, one
SLOT_BYTES slot (2 MiB) a rank. Each card's exchange buffer holds two
halves of one slot a rank (2 x N x 2 MiB; a prefill chunk's partial,
256 x 4096 bf16, is 2 MiB; 8 rows of Llama-3-8B's f32 vocab slice at
--tensor 2 are 2,052,096 bytes); a larger operand goes in pieces of a
slot, a launch each.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.ops.paged_kernel import (  # noqa: F401
    IMPLS, available, impl_scope, resolve_impl, unavailable_reason)

OPS = ('sum', 'max', 'gather', 'broadcast')
_OP_CODES = {name: i for i, name in enumerate(OPS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Device launches made by the wrappers in this process.
launches = 0
#: The same, by op.
launches_by_op: 'collections.Counter[str]' = collections.Counter()
#: The same, by card ('cuda:1').
launches_by_device: 'collections.Counter[str]' = collections.Counter()
#: The same, by (op, bytes a rank): a decode round's partials apart from
#: a prefill chunk's.
launches_by_size: 'collections.Counter[tuple]' = collections.Counter()
#: Calls of the plain versions made through the wrappers.
plain_calls = 0

#: Blocks a launch takes at most (one an SM and fewer: every block of
#: every card is resident, so no block waits on one that cannot run).
MAX_BLOCKS = 128
#: Bytes of a part that each block takes, block b the b-th run of them.
BLOCK_BYTES = 16 << 10
#: Bytes of one rank's slot in a half of a card's exchange buffer: the
#: most a launch takes a rank.
SLOT_BYTES = MAX_BLOCKS * BLOCK_BYTES
#: The most ranks and distinct cards of a team (the kernel's arrays).
MAX_RANKS = 8
MAX_CARDS = 8
#: How long a card waits for a peer's flag before it traps.
TIMEOUT_NS = 10 * 1000 ** 3


def blocks_for(nbytes: int) -> int:
    """Blocks of a launch over `nbytes` a rank (the kernel's own count: a
    block a BLOCK_BYTES run, at most MAX_BLOCKS)."""
    return max(1, min(MAX_BLOCKS, math.ceil(nbytes / BLOCK_BYTES)))


def bound_bytes(op: str, nranks: int, nbytes: int) -> int:
    """Bytes that must cross NVLink into one card for an op over distinct
    cards, `nbytes` a rank: the other ranks' parts (sum, max, and the
    gather's root), or the root's (broadcast)."""
    return nbytes if op == 'broadcast' else (nranks - 1) * nbytes


# -- the plain versions --------------------------------------------------------
def next_up(t: torch.Tensor) -> torch.Tensor:
    """Each value moved to the next value of its dtype toward +inf (f32
    or bf16; zeros to the smallest positive)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if t.dtype not in ints:
        raise TypeError(f'next_up takes f32 or bf16, got {t.dtype}')
    bits = t.view(ints[t.dtype])
    mag = bits & (0x7fffffff if t.dtype == torch.float32 else 0x7fff)
    up = torch.where(bits >= 0, bits + 1, bits - 1)
    return torch.where(mag == 0, torch.ones_like(bits), up).view(t.dtype)


def all_reduce_reference(parts: Sequence[torch.Tensor],
                         op: str = 'sum') -> List[torch.Tensor]:
    """Plain version: each part copied to the first part's device and
    combined there in rank order (a sum in f32, cast back; a max in the
    parts' dtype), the result copied back to every part's device."""
    if op not in ('sum', 'max'):
        raise ValueError(f'unknown reduction {op!r}')
    home = parts[0].device
    if op == 'sum':
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(home).float()
        acc = acc.to(parts[0].dtype)
    else:
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(home))
    return [acc if p.device == home else acc.to(p.device) for p in parts]


def gather_reference(parts: Sequence[torch.Tensor],
                     device: torch.device) -> torch.Tensor:
    """Plain version: the parts' last axes concatenated in rank order on
    `device`."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=-1)


def broadcast_reference(src: torch.Tensor,
                        devices: Sequence[torch.device]
                        ) -> List[torch.Tensor]:
    """Plain version: `src` copied to every device (itself where it
    lies)."""
    return [src.to(d) for d in devices]


# -- the team ------------------------------------------------------------------
def _normal(device) -> torch.device:
    d = torch.device(device)
    if d.type == 'cuda' and d.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return d


class Team:
    """An ordered list of ranks, one a device, and over distinct CUDA cards
    their exchange buffers and flags (allocated here, once; peer access is
    enabled between every pair first, and a pair without it raises)."""

    def __init__(self, devices: Sequence) -> None:
        self.devices = [_normal(d) for d in devices]
        if not self.devices or len(self.devices) > MAX_RANKS:
            raise ValueError(f'a team has 1..{MAX_RANKS} ranks, got '
                             f'{len(self.devices)}')
        self.cards = list(dict.fromkeys(self.devices))
        if len(self.cards) > MAX_CARDS:
            raise ValueError(f'a team spans at most {MAX_CARDS} cards')
        self.card_of = [self.cards.index(d) for d in self.devices]
        #: Why the team refuses every op (a launch failed on one card after
        #: another had launched: the epochs no longer agree), or None.
        self.broken: Optional[str] = None
        self._bufs = self._flags = None
        cuda = [d.type == 'cuda' for d in self.cards]
        if any(cuda) and not all(cuda):
            raise ValueError(f'a team is all CUDA or all CPU: '
                             f'{[str(d) for d in self.cards]}')
        if all(cuda) and len(self.cards) > 1:
            self._open()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """Whether the ranks span more than one card."""
        return len(self.cards) > 1

    def _open(self) -> None:
        lib = _library()
        n = len(self.cards)
        devs = (ctypes.c_int * n)(*[d.index for d in self.cards])
        self._devs = devs
        self._bufs = (ctypes.c_void_p * n)()
        self._flags = (ctypes.c_void_p * n)()
        bad = (ctypes.c_int * 2)()
        err = lib.skypilot_grid_open(n, devs, self.size, self._bufs,
                                     self._flags, bad)
        if err != 0:
            self._bufs = self._flags = None
            if err == -1:
                raise RuntimeError(
                    f'grid collective: cuda:{bad[0]} has no peer access to '
                    f'cuda:{bad[1]}; the grid sums over NVLink and will not '
                    f'route through the host')
            raise RuntimeError(
                f'grid collective setup over {[str(d) for d in self.cards]} '
                f'failed: CUDA error {err} '
                f'({lib.skypilot_grid_error_string(err).decode()})')

    def close(self) -> None:
        """Free the exchange buffers (the team refuses ops afterwards)."""
        if self._bufs is not None:
            _library().skypilot_grid_close(len(self.cards), self._devs,
                                           self._bufs, self._flags)
            self._bufs = self._flags = None
            self.broken = 'the team was closed'

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # pylint: disable=broad-except
            pass


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('grid_collective')
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.skypilot_grid_open.restype = i32
    lib.skypilot_grid_open.argtypes = [i32, ctypes.POINTER(i32), i32,
                                       ctypes.POINTER(ptr),
                                       ctypes.POINTER(ptr),
                                       ctypes.POINTER(i32)]
    lib.skypilot_grid_close.restype = i32
    lib.skypilot_grid_close.argtypes = [i32, ctypes.POINTER(i32),
                                        ctypes.POINTER(ptr),
                                        ctypes.POINTER(ptr)]
    lib.skypilot_grid_collective.restype = i32
    lib.skypilot_grid_collective.argtypes = (
        [i32] * 6 + [ctypes.POINTER(i32), ctypes.POINTER(ptr), ptr,
                     ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
        + [i64] * 2 + [ctypes.c_ulonglong, ptr])
    lib.skypilot_grid_error_string.restype = ctypes.c_char_p
    lib.skypilot_grid_error_string.argtypes = [i32]
    lib.skypilot_grid_slot_bytes.restype = i64
    if lib.skypilot_grid_slot_bytes() != SLOT_BYTES:
        raise RuntimeError(f'grid collective: the kernel\'s slot is '
                           f'{lib.skypilot_grid_slot_bytes()} bytes, the '
                           f'wrapper cuts {SLOT_BYTES}')
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous on a 16-byte boundary (copied only where not)."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(parts: Sequence[torch.Tensor], team: Team) -> None:
    if team.broken is not None:
        raise RuntimeError(f'grid collective refuses further ops: '
                           f'{team.broken}')
    if len(parts) != team.size:
        raise ValueError(f'{len(parts)} parts for a team of {team.size}')
    for r, (p, d) in enumerate(zip(parts, team.devices)):
        if _normal(p.device) != d:
            raise ValueError(f'rank {r} lies on {p.device}, its team '
                             f'place is {d}')
        if p.shape != parts[0].shape or p.dtype != parts[0].dtype:
            raise ValueError(
                f'parts differ: rank {r} {p.dtype} {tuple(p.shape)} vs '
                f'{parts[0].dtype} {tuple(parts[0].shape)}')


def _run(team: Team, op: str, ins: List[Optional[torch.Tensor]],
         outs: List[Optional[torch.Tensor]], nbytes: int, *, dtype_code=0,
         row_bytes: int = 0, timeout_ns: int = TIMEOUT_NS,
         cards: Optional[Sequence[int]] = None) -> None:
    """One launch on each card of `cards` (every card of the team by
    default): `ins` a rank, `outs` a card (None: the card writes none),
    at most SLOT_BYTES a rank. `cards` short of every card is for tests
    of the bounded wait."""
    global launches
    lib = _library()
    n = team.size
    card_of = (ctypes.c_int * n)(*team.card_of)
    nc = len(team.cards)
    started = []
    for c in (range(nc) if cards is None else cards):
        device = team.cards[c]
        inputs = (ctypes.c_void_p * n)(*[
            ins[r].data_ptr() if ins[r] is not None and team.card_of[r] == c
            else None for r in range(n)])
        out = outs[c]
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = lib.skypilot_grid_collective(
                _OP_CODES[op], dtype_code, n, nc, c, 0, card_of, inputs,
                out.data_ptr() if out is not None else None,
                team._bufs if team.distinct else None,  # pylint: disable=protected-access
                team._flags if team.distinct else None,  # pylint: disable=protected-access
                nbytes, row_bytes, timeout_ns, stream)
        if err != 0:
            msg = (f'grid collective ({op}, {nbytes} bytes a rank) failed '
                   f'to launch on {device}: CUDA error {err} '
                   f'({lib.skypilot_grid_error_string(err).decode()})')
            if started:
                team.broken = (msg + f'; {", ".join(started)} had launched, '
                               f'and would wait for it')
            raise RuntimeError(msg)
        started.append(str(device))
        launches += 1
        launches_by_op[op] += 1
        launches_by_device[str(device)] += 1
        launches_by_size[(op, nbytes)] += 1


def _pieces(total: int, step: int) -> List[tuple]:
    """[lo, hi) ranges of `total` items, `step` (a slot's worth) a piece."""
    step = max(1, step)
    return [(lo, min(total, lo + step)) for lo in range(0, total, step)]


# -- the ops -------------------------------------------------------------------
def all_reduce(parts: Sequence[torch.Tensor], team: Optional[Team] = None,
               op: str = 'sum', *, impl: str = 'auto') -> List[torch.Tensor]:
    """Sum (f32 in rank order, cast back) or max of one part a rank; the
    result on every rank's device (see module doc)."""
    global plain_calls
    if op not in ('sum', 'max'):
        raise ValueError(f'unknown reduction {op!r}')
    if resolve_impl(impl, parts[0].device) == 'torch':
        plain_calls += 1
        return all_reduce_reference(parts, op)
    if team is None:
        raise ValueError('the kernel needs the parts\' Team')
    _check(parts, team)
    dtype = parts[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f'all_reduce takes f32 or bf16, got {dtype}')
    ins = [_aligned(p).view(-1) for p in parts]
    outs = [torch.empty_like(ins[team.card_of.index(c)])
            for c in range(len(team.cards))]
    size = parts[0].element_size()
    for lo, hi in _pieces(ins[0].numel(), SLOT_BYTES // size):
        _run(team, op, [t[lo:hi] for t in ins], [o[lo:hi] for o in outs],
             (hi - lo) * size, dtype_code=_DTYPE_CODES[dtype])
    shape = parts[0].shape
    return [outs[c].view(shape) for c in team.card_of]


def gather(parts: Sequence[torch.Tensor], team: Optional[Team] = None,
           device: Optional[torch.device] = None, *,
           impl: str = 'auto') -> torch.Tensor:
    """The parts' last axes concatenated in rank order on rank 0's device
    (`device`, where given, must be it on the card)."""
    global plain_calls
    if resolve_impl(impl, parts[0].device) == 'torch':
        plain_calls += 1
        return gather_reference(parts, device if device is not None
                                else parts[0].device)
    if team is None:
        raise ValueError('the kernel needs the parts\' Team')
    _check(parts, team)
    if device is not None and _normal(device) != team.devices[0]:
        raise ValueError(f'the kernel gathers on rank 0\'s {team.devices[0]}'
                         f', not {device}')
    ins = [_aligned(p) for p in parts]
    width = parts[0].shape[-1]
    rows = ins[0].numel() // max(width, 1)
    size = parts[0].element_size()
    row_bytes = width * size
    if row_bytes > SLOT_BYTES:
        raise ValueError(f'a gathered row of {row_bytes} bytes is past the '
                         f'{SLOT_BYTES}-byte slot')
    out = torch.empty((*parts[0].shape[:-1], width * team.size),
                      dtype=parts[0].dtype, device=team.devices[0])
    flat_in = [t.view(rows, width) for t in ins]
    flat_out = out.view(rows, width * team.size)
    outs: List[Optional[torch.Tensor]] = [None] * len(team.cards)
    for lo, hi in _pieces(rows, SLOT_BYTES // row_bytes):
        outs[0] = flat_out[lo:hi]
        _run(team, 'gather', [t[lo:hi] for t in flat_in], outs,
             (hi - lo) * row_bytes, row_bytes=row_bytes)
    return out


def broadcast(src: torch.Tensor, team: Optional[Team] = None,
              devices: Optional[Sequence[torch.device]] = None, *,
              impl: str = 'auto') -> List[torch.Tensor]:
    """Rank 0's `src` on every rank's device: `src` itself on rank 0's
    card, a copy on the others."""
    global plain_calls
    if resolve_impl(impl, src.device) == 'torch':
        plain_calls += 1
        return broadcast_reference(src, devices if devices is not None
                                   else team.devices)
    if team is None:
        raise ValueError('the kernel needs the Team')
    if team.broken is not None:
        raise RuntimeError(f'grid collective refuses further ops: '
                           f'{team.broken}')
    if _normal(src.device) != team.devices[0]:
        raise ValueError(f'broadcast from {src.device}, rank 0 lies on '
                         f'{team.devices[0]}')
    if not team.distinct:
        return [src] * team.size
    src = _aligned(src)
    flat = src.view(-1)
    outs = [None] + [torch.empty_like(flat, device=d)
                     for d in team.cards[1:]]
    size = src.element_size()
    for lo, hi in _pieces(flat.numel(), SLOT_BYTES // size):
        ins: List[Optional[torch.Tensor]] = [None] * team.size
        ins[0] = flat[lo:hi]
        _run(team, 'broadcast', ins,
             [o[lo:hi] if o is not None else None for o in outs],
             (hi - lo) * size)
    shaped = [src] + [o.view(src.shape) for o in outs[1:]]
    return [shaped[c] for c in team.card_of]
