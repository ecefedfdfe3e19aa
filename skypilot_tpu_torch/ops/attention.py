"""Causal GQA attention over a chunk's own K/V (port of
skypilot_tpu/ops/attention.py:42-91 `dot_product_attention`, whose
non-flash route is `jax.nn.dot_product_attention`, an XLA op).

Layout: q/k/v are [batch, seq, heads, head_dim]. Scores and softmax run
in f32; the output is cast back to q.dtype.
"""
from __future__ import annotations

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """q: [B,S,H,D]; k/v: [B,S,Hkv,D] (GQA allowed). Returns [B,S,H,D]."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f'expected 4-d q/k/v, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
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
