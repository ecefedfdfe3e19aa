"""Attention dispatch: causal flash attention for long sequences, plain
attention below (port of skypilot_tpu/ops/attention.py:42-91
`dot_product_attention`).

Layout: q/k/v are [batch, seq, heads, head_dim]; GQA allowed. The
reference sends `seq >= _FLASH_MIN_SEQ` on the TPU to the upstream
Pallas flash kernel and everything else to `jax.nn.dot_product_attention`
(an XLA op, not a Pallas kernel). The port does the same on the card:
causal calls of 2048 tokens or more go to `ops/flash_kernel.py` (the
hand-written CUDA kernels, forward and backward); shorter ones, and
every call on the CPU unless impl='flash' asks for the flash route's
plain version, take the plain route below (f32 scores and softmax,
output cast back to q.dtype).

Context parallelism (reference `:64-75`): while a ring is active
(parallel/context.py `context_parallel`, the sharded trainer's step on
a mesh whose `seq` axis is larger than 1) q/k/v are this rank's blocks
of the sequence, and attention is `ops/ring_attention.py` over the
ring, GQA k/v repeated first, before the flash route is considered.
The ring is plain PyTorch, as the reference's is plain XLA.

`chunked_cache_attention` and `cached_decode_attention` (reference
`:182-272`) are the one-shot engine's attention over a dense
per-request cache [B, T, Hkv, D]; the reference computes them with
einsum outside any Pallas kernel, and so does the port (in place: the
cache tensors are written, not returned).

Unequal q/v head dims (MLA: DeepSeek's qk_head_dim 192 beside v_head_dim
128) are decided first, whatever `impl` says, as the reference decides
them (`:47-63`): `_unequal_dims_attention` (reference `:94-110`) is the
plain route's arithmetic with the value dim free, because the flash
kernels and the ring need equal dims. Under a ring it warns as the
reference does and attends the rank's queries over k/v gathered whole.

The reference's SKYPILOT_TPU_FLASH_MIN_SEQ environment override is not
carried over: the port selects its routes with arguments and
`impl_scope`, never with environment variables.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import flash_kernel, ring_attention

# Sequence length from which causal attention takes the flash route on
# the card (the reference's default threshold).
_FLASH_MIN_SEQ = 2048

IMPLS = ('auto', 'flash', 'ring', 'xla')


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          impl: str = 'auto') -> torch.Tensor:
    """q: [B,S,H,D]; k/v: [B,S,Hkv,D] (GQA allowed; v may have another
    head dim, Dv). Returns [B,S,H,Dv].
    impl: 'auto' (the ring under an active seq group, else flash on
    CUDA tensors from _FLASH_MIN_SEQ tokens), 'ring' (the ring;
    needs an active seq group), 'flash' (always the flash route;
    causal only) or 'xla' (the plain route, named after the
    reference's). Under an active seq group q/k/v are the rank's
    blocks, so only the ring sees the whole sequence: 'flash' and
    'xla' raise there. Unequal q/v dims take `_unequal_dims_attention`
    whatever `impl` says."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f'expected 4-d q/k/v, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    if impl not in IMPLS:
        raise ValueError(f'unknown attention impl {impl!r} (choices: '
                         f'{", ".join(IMPLS)})')
    from skypilot_tpu_torch.parallel import context as cp_context
    seq_group = cp_context.active_seq_group()
    if v.shape[-1] != q.shape[-1]:
        # Decided before the ring and flash dispatch: both need equal
        # dims.
        if seq_group is not None:
            warnings.warn(
                'context parallelism requested (seq-sharded mesh) but '
                f'v_head_dim={v.shape[-1]} != qk_head_dim={q.shape[-1]} '
                '(MLA): ring attention does not support unequal dims, '
                'falling back to materialized S x S scores under GSPMD '
                '— results are correct but per-shard attention memory '
                'is O(S), not O(S/shards).', stacklevel=2)
        return _unequal_dims_attention(q, k, v, causal=causal,
                                       seq_group=seq_group)
    if seq_group is not None and impl in ('auto', 'ring'):
        # Context parallelism: the sequence is sharded, so ring attention.
        num_q_heads, num_kv_heads = q.shape[2], k.shape[2]
        if num_kv_heads != num_q_heads:
            rep = num_q_heads // num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return ring_attention.ring_attention(q, k, v, seq_group,
                                             causal=causal)
    if seq_group is not None:
        raise ValueError(f'impl={impl!r} attends one block of a '
                         f'seq-sharded sequence; use the ring')
    if impl == 'ring':
        raise ValueError('the ring route needs an active seq group '
                         '(parallel/context.py context_parallel)')
    if impl == 'flash' and not causal:
        raise ValueError('the flash route is causal only')
    use_flash = impl == 'flash' or (
        impl == 'auto' and causal and q.is_cuda
        and q.shape[1] >= _FLASH_MIN_SEQ)
    if use_flash:
        return flash_kernel.flash_attention(q, k, v)
    num_q_heads, num_kv_heads = q.shape[2], k.shape[2]
    if num_kv_heads != num_q_heads:
        rep = num_q_heads // num_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        seq_q, seq_k = q.shape[1], k.shape[1]
        mask = (torch.arange(seq_k, device=q.device)[None, :]
                <= torch.arange(seq_q, device=q.device)[:, None])
        s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return out.to(q.dtype)


def _unequal_dims_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            seq_group=None) -> torch.Tensor:
    """Attention for v_head_dim != qk_head_dim (MLA): GQA repeat, f32
    scores scaled by 1/sqrt(q's head dim), the causal mask, f32 softmax
    and f32 p.v, output in q.dtype. q/k: [B,S,H|Hkv,D]; v: [B,S,Hkv,Dv].
    Under a ring (`seq_group`) q is this rank's block and k/v are
    gathered whole first (the S x S scores the reference's GSPMD
    fallback materializes), the mask taken at q's global positions."""
    offset = 0
    if seq_group is not None:
        offset = seq_group.index * q.shape[1]
        k = ring_attention.gather_blocks(k, seq_group)
        v = ring_attention.gather_blocks(v, seq_group)
    num_q_heads, num_kv_heads = q.shape[2], k.shape[2]
    if num_kv_heads != num_q_heads:
        rep = num_q_heads // num_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        seq_q, seq_k = q.shape[1], k.shape[1]
        mask = (torch.arange(seq_k, device=q.device)[None, :]
                <= offset + torch.arange(seq_q, device=q.device)[:, None])
        s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bhqk,bkhv->bqhv', p, v.float())
    return out.to(q.dtype)


def _read_heads(tensors, kv_heads: Optional[Tuple[int, int]]):
    """Views of [B, T, Hkv, D] tensors on kv heads [lo, hi), or the
    tensors themselves when `kv_heads` is None."""
    if kv_heads is None:
        return tensors
    lo, hi = kv_heads
    return tuple(t[:, :, lo:hi] for t in tensors)


def write_rows(cache: torch.Tensor, rows: torch.Tensor,
                start: torch.Tensor) -> None:
    """cache[b, start[b]:start[b]+S] = rows[b], in place; the start is
    clamped so the rows fit, as `lax.dynamic_update_slice` clamps it."""
    seq = rows.shape[1]
    start = start.long().clamp(0, cache.shape[1] - seq)
    idx = start[:, None] + torch.arange(seq, device=cache.device)
    batch = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[batch, idx] = rows.to(cache.dtype)


def _cache_attention(q: torch.Tensor, cached_k: torch.Tensor,
                     cached_v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, D] over every cache entry t <= positions[b, s], f32
    scores and softmax; output in q.dtype."""
    num_q_heads, num_kv_heads = q.shape[2], cached_k.shape[2]
    k_all, v_all = cached_k, cached_v
    if num_kv_heads != num_q_heads:
        rep = num_q_heads // num_kv_heads
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum('bshd,bthd->bhst', q.float(), k_all.float()) * scale
    mask = (torch.arange(cached_k.shape[1], device=q.device)[None, None, :]
            <= positions.long()[:, :, None])[:, None]      # [B,1,S,T]
    s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bhst,bthd->bshd', p, v_all.float())
    return out.to(q.dtype)


def chunked_cache_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cached_k: torch.Tensor,
                            cached_v: torch.Tensor, positions: torch.Tensor,
                            *, chunk_only: bool = False,
                            kv_heads: Optional[Tuple[int, int]] = None
                            ) -> torch.Tensor:
    """A chunk of S queries per row at its own offset: write the chunk's
    K/V at positions[b, 0].. into the dense cache, then attend every
    cache entry up to each query's position. `chunk_only` (the cache
    holds nothing below the chunk) attends the chunk alone, through
    `dot_product_attention` (flash from 2048 tokens on the card).
    q/k_new/v_new: [B, S, H|Hkv, D]; cached_k/v: [B, T, Hkv, D];
    positions: [B, S]. Returns out [B, S, H, D]. `kv_heads` (lo, hi):
    every kv head is written, and q attends kv heads [lo, hi) only (a
    tensor-parallel shard's q heads over a replicated cache)."""
    start = positions[:, 0]
    write_rows(cached_k, k_new, start)
    write_rows(cached_v, v_new, start)
    k_new, v_new, cached_k, cached_v = _read_heads(
        (k_new, v_new, cached_k, cached_v), kv_heads)
    if chunk_only:
        return dot_product_attention(q, k_new, v_new, causal=True)
    return _cache_attention(q, cached_k, cached_v, positions)


def cached_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cached_k: torch.Tensor,
                            cached_v: torch.Tensor,
                            pos: torch.Tensor,
                            kv_heads: Optional[Tuple[int, int]] = None
                            ) -> torch.Tensor:
    """One token per row at its own position pos[b]: write its K/V,
    attend the cache masked to t <= pos[b]. q/k_new/v_new:
    [B, 1, H|Hkv, D]; pos: [B]. Returns out [B, 1, H, D]. `kv_heads`
    as `chunked_cache_attention`'s."""
    write_rows(cached_k, k_new, pos)
    write_rows(cached_v, v_new, pos)
    cached_k, cached_v = _read_heads((cached_k, cached_v), kv_heads)
    return _cache_attention(q, cached_k, cached_v, pos[:, None])
