"""Paged KV-cache attention for LM serving (port of
skypilot_tpu/ops/paged_attention.py).

K/V live in fixed-size pages shared by all slots; each sequence owns a
page list (its row of the page table). Layouts match the reference:

  q            [B, num_q_heads, head_dim]      one decode token per row
  k/v_pages    [num_kv_heads, total_pages, page_size, head_dim]
  k/v_scales   f32[total_pages, page_size]     int8 pools only
  lengths      i32[B]   tokens already in the cache (incl. current)
  page_indices i32[B, pages_per_seq]  physical page ids per sequence

The pools are preallocated tensors that the writers below update IN
PLACE (the reference returned new arrays from donated buffers). Reads
go through `paged_kernel.fused_paged_attention`: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.

int8 pools store one f32 scale per cached token (page slot), shared
across kv heads: symmetric absmax over that token's (Hkv, head_dim)
values, applied on every write.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import paged_kernel


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization of per-token KV rows.

    x: [..., num_kv_heads, head_dim]. Returns (q int8 same shape,
    scale f32[...]); an all-zero token quantizes to scale 0 / values 0.
    `torch.round` rounds half to even, as `jnp.round` does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(-2, -1))
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x32 / safe[..., None, None]),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv_rows` (scale broadcast over the last two
    dims)."""
    return q.float() * scale[..., None, None]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           page_indices: torch.Tensor, *,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           impl: str = 'auto',
                           attend_len: Optional[int] = None
                           ) -> torch.Tensor:
    """Attention of one query token per row over its paged history.
    Returns [B, num_q_heads, head_dim] in q.dtype. `attend_len`: see
    `paged_kernel.fused_paged_attention`."""
    if q.ndim != 3:
        raise ValueError(f'q must be [B, Hq, D], got {tuple(q.shape)}')
    out = paged_kernel.fused_paged_attention(
        q[:, None], k_pages, v_pages, (lengths - 1)[:, None],
        page_indices, k_scales=k_scales, v_scales=v_scales, impl=impl,
        attend_len=attend_len)
    return out[:, 0]


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, positions: torch.Tensor,
                          page_indices: torch.Tensor,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          impl: str = 'auto',
                          attend_len: Optional[int] = None
                          ) -> torch.Tensor:
    """S queries per row over the row's full paged history: query s of
    row b attends every cache index <= positions[b, s] (the chunk's own
    K/V must already be written). q: [B, S, Hq, D]; returns the same
    shape in q.dtype. `attend_len`: see
    `paged_kernel.fused_paged_attention`."""
    return paged_kernel.fused_paged_attention(
        q, k_pages, v_pages, positions, page_indices,
        k_scales=k_scales, v_scales=v_scales, impl=impl,
        attend_len=attend_len)


def _gather_kv(q_heads: int, k_pages: torch.Tensor, v_pages: torch.Tensor,
               page_indices: torch.Tensor,
               k_scales: Optional[torch.Tensor] = None,
               v_scales: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row page gather + GQA head expansion: k/v as [B, T, Hq, D]
    with T = pages_per_seq * page_size; int8 pages are dequantized
    (int8 * per-slot f32 scale) before the head expansion."""
    num_kv_heads, _, page_size, head_dim = k_pages.shape
    batch, pages_per_seq = page_indices.shape
    max_len = pages_per_seq * page_size
    idx = page_indices.long()

    def gather(pages):                       # [Hkv, B, pps, page, D]
        g = pages[:, idx].permute(1, 2, 3, 0, 4)
        return g.reshape(batch, max_len, num_kv_heads, head_dim)

    k_all, v_all = gather(k_pages), gather(v_pages)
    if k_scales is not None:
        k_s = k_scales[idx].reshape(batch, max_len)
        v_s = v_scales[idx].reshape(batch, max_len)
        k_all = k_all.float() * k_s[:, :, None, None]
        v_all = v_all.float() * v_s[:, :, None, None]
    if q_heads != num_kv_heads:
        rep = q_heads // num_kv_heads
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)
    return k_all, v_all


def _reference_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, lengths: torch.Tensor,
                               page_indices: torch.Tensor,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Gather-based decode semantics: gather each row's pages, masked
    f32 softmax (a row with length 0 is NaN, as in the reference)."""
    head_dim = k_pages.shape[-1]
    max_len = page_indices.shape[1] * k_pages.shape[2]
    k_all, v_all = _gather_kv(q.shape[1], k_pages, v_pages, page_indices,
                              k_scales, v_scales)
    s = torch.einsum('bhd,bkhd->bhk', q.float(),
                     k_all.float()) * (1.0 / head_dim ** 0.5)
    t_idx = torch.arange(max_len, device=q.device)
    mask = (t_idx[None, :] < lengths[:, None])[:, None, :]
    s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bhk,bkhd->bhd', p, v_all.float())
    return out.to(q.dtype)


def _slots(positions: torch.Tensor, page_indices: torch.Tensor,
           page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, slot) of every position, flattened. A logical
    page past the table row is clamped to its last column, as the
    reference's gather clamps out-of-range indices."""
    logical = torch.clamp(positions // page_size, 0,
                          page_indices.shape[1] - 1).long()
    if positions.ndim == 1:
        logical = logical[:, None]
    physical = torch.gather(page_indices.long(), 1, logical).reshape(-1)
    slot = (positions % page_size).reshape(-1).long()
    return physical, slot


def _scatter(pages: torch.Tensor, physical: torch.Tensor,
             slot: torch.Tensor, rows: torch.Tensor) -> None:
    """pages[:, physical[i], slot[i], :] = rows[i] for each flat token i
    (rows: [N, Hkv, D]). Tokens aimed at the trash page may collide;
    which one lands there is unspecified, as in the reference."""
    pages[:, physical, slot, :] = rows.transpose(0, 1).to(pages.dtype)


def write_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             positions: torch.Tensor, page_indices: torch.Tensor) -> None:
    """Write one token's K/V per row at its position's page slot, in
    place. k_new/v_new: [B, Hkv, D]; positions: i32[B]."""
    physical, slot = _slots(positions, page_indices, k_pages.shape[2])
    _scatter(k_pages, physical, slot, k_new)
    _scatter(v_pages, physical, slot, v_new)


def write_kv_chunk(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor,
                   page_indices: torch.Tensor) -> None:
    """Chunked write: S tokens per row in one scatter, in place.
    k_new/v_new: [B, S, Hkv, D]; positions: i32[B, S]. Padded-tail
    positions map to unallocated table entries, i.e. the trash page."""
    physical, slot = _slots(positions, page_indices, k_pages.shape[2])
    _scatter(k_pages, physical, slot, k_new.reshape(-1, *k_new.shape[2:]))
    _scatter(v_pages, physical, slot, v_new.reshape(-1, *v_new.shape[2:]))


def write_kv_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_scales: torch.Tensor, v_scales: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor,
                   page_indices: torch.Tensor) -> None:
    """`write_kv` for an int8 pool: quantize each token's K/V rows and
    scatter values and per-slot scales, in place."""
    physical, slot = _slots(positions, page_indices, k_pages.shape[2])
    qk, sk = quantize_kv_rows(k_new)
    qv, sv = quantize_kv_rows(v_new)
    _scatter(k_pages, physical, slot, qk)
    _scatter(v_pages, physical, slot, qv)
    k_scales[physical, slot] = sk.reshape(-1)
    v_scales[physical, slot] = sv.reshape(-1)


def write_kv_chunk_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                         k_scales: torch.Tensor, v_scales: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         positions: torch.Tensor,
                         page_indices: torch.Tensor) -> None:
    """`write_kv_chunk` for an int8 pool (one scale per token)."""
    physical, slot = _slots(positions, page_indices, k_pages.shape[2])
    qk, sk = quantize_kv_rows(k_new)
    qv, sv = quantize_kv_rows(v_new)
    _scatter(k_pages, physical, slot, qk.reshape(-1, *qk.shape[2:]))
    _scatter(v_pages, physical, slot, qv.reshape(-1, *qv.shape[2:]))
    k_scales[physical, slot] = sk.reshape(-1)
    v_scales[physical, slot] = sv.reshape(-1)


class PageAllocator:
    """Host-side free-list over the fixed physical page pool: the
    engine calls it between steps to grow a sequence's page list or
    release a finished sequence's pages."""

    def __init__(self, total_pages: int, pages_per_seq: int) -> None:
        self.total_pages = total_pages
        self.pages_per_seq = pages_per_seq
        self._free: List[int] = list(range(total_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_allocate(self, num_pages: int) -> bool:
        return len(self._free) >= num_pages

    def allocate(self, num_pages: int) -> List[int]:
        if not self.can_allocate(num_pages):
            raise MemoryError(
                f'paged KV cache exhausted: need {num_pages} pages, '
                f'{len(self._free)} free of {self.total_pages}')
        return [self._free.pop() for _ in range(num_pages)]

    def release(self, pages: List[int]) -> None:
        self._free.extend(pages)

    def pages_needed(self, num_tokens: int, page_size: int) -> int:
        return -(-num_tokens // page_size)  # ceil div


def init_pages(num_kv_heads: int, total_pages: int, page_size: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (num_kv_heads, total_pages, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
