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
