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

`chunked_cache_attention` and `cached_decode_attention` (reference
`:182-272`) are the one-shot engine's attention over a dense
per-request cache [B, T, Hkv, D]; the reference computes them with
einsum outside any Pallas kernel, and so does the port (in place: the
cache tensors are written, not returned).

The reference's SKYPILOT_TPU_FLASH_MIN_SEQ environment override is not
carried over: the port selects its routes with arguments and
`impl_scope`, never with environment variables. Its
`_unequal_dims_attention` (MLA) waits for the model family that needs
it.
"""
from __future__ import annotations

import torch

from skypilot_tpu_torch.ops import flash_kernel

# Sequence length from which causal attention takes the flash route on
# the card (the reference's default threshold).
_FLASH_MIN_SEQ = 2048

IMPLS = ('auto', 'flash', 'xla')


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          impl: str = 'auto') -> torch.Tensor:
    """q: [B,S,H,D]; k/v: [B,S,Hkv,D] (GQA allowed). Returns [B,S,H,D].
    impl: 'auto' (flash on CUDA tensors from _FLASH_MIN_SEQ tokens),
    'flash' (always the flash route; causal only) or 'xla' (the plain
    route, named after the reference's)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f'expected 4-d q/k/v, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    if impl not in IMPLS:
        raise ValueError(f'unknown attention impl {impl!r} (choices: '
                         f'{", ".join(IMPLS)})')
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


def _write_rows(cache: torch.Tensor, rows: torch.Tensor,
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
                            *, chunk_only: bool = False) -> torch.Tensor:
    """A chunk of S queries per row at its own offset: write the chunk's
    K/V at positions[b, 0].. into the dense cache, then attend every
    cache entry up to each query's position. `chunk_only` (the cache
    holds nothing below the chunk) attends the chunk alone, through
    `dot_product_attention` (flash from 2048 tokens on the card).
    q/k_new/v_new: [B, S, H|Hkv, D]; cached_k/v: [B, T, Hkv, D];
    positions: [B, S]. Returns out [B, S, H, D]."""
    start = positions[:, 0]
    _write_rows(cached_k, k_new, start)
    _write_rows(cached_v, v_new, start)
    if chunk_only:
        return dot_product_attention(q, k_new, v_new, causal=True)
    return _cache_attention(q, cached_k, cached_v, positions)


def cached_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cached_k: torch.Tensor,
                            cached_v: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
    """One token per row at its own position pos[b]: write its K/V,
    attend the cache masked to t <= pos[b]. q/k_new/v_new:
    [B, 1, H|Hkv, D]; pos: [B]. Returns out [B, 1, H, D]."""
    _write_rows(cached_k, k_new, pos)
    _write_rows(cached_v, v_new, pos)
    return _cache_attention(q, cached_k, cached_v, pos[:, None])
