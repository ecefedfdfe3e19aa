"""Token selection for serving (port of skypilot_tpu/models/generate.py:19-70
`filter_logits` and `sample_tokens`).

Greedy is `argmax`, which takes the first index on ties as `jnp.argmax`
does. Sampling draws from a `torch.Generator`: it cannot reproduce the
reference's jax.random stream, so only greedy tokens and the top-k /
top-p masks match the reference exactly.

Nothing here reads a device value on the host, so `sample_tokens` can
run inside a captured CUDA graph (models/decode_graph.py): whether the
top-k / top-p filter runs is the caller's choice (`apply_filter`), which the
engine makes from its host copy of the slots' settings, and the draw is
the exponential race `argmax(p / q)`, q ~ Exp(1), which is the fast path
of `torch.multinomial` for one sample without its host-side checks.
"""
from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k / nucleus (top-p) filtering. logits: [..., V];
    top_k int [...] (0 = off); top_p f32 [...] (1.0 = off). Filtered
    entries become -inf; ties at the k-th logit all survive and the
    nucleus always keeps the argmax."""
    vocab = logits.shape[-1]
    while top_k.ndim < logits.ndim - 1:
        top_k = top_k[..., None]
        top_p = top_p[..., None]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1,
                       torch.clamp(top_k - 1, 0, vocab - 1)[..., None].long())
    keep_k = torch.where((top_k > 0)[..., None], logits >= kth,
                         torch.ones_like(logits, dtype=torch.bool))
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Nucleus: keep a sorted token while the mass BEFORE it is < p.
    sorted_keep = (cum - probs) < top_p[..., None]
    min_kept = torch.where(sorted_keep, sorted_desc,
                           torch.full_like(sorted_desc, float('inf'))
                           ).amin(dim=-1, keepdim=True)
    keep_p = torch.where((top_p < 1.0)[..., None], logits >= min_kept,
                         torch.ones_like(logits, dtype=torch.bool))
    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, float('-inf')))


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  apply_filter: bool = True) -> torch.Tensor:
    """Per-row selection over logits [..., V] (a decode round's [B, V],
    a verify chunk's [B, K+1, V]); temps, top_k, top_p are [B] (or the
    logits' leading shape). Greedy where temps == 0, else a draw from
    the temperature-scaled (then top-k/top-p filtered) distribution.
    `apply_filter=False` skips the filter, which is exact when no row filters
    (top_k 0 and top_p 1 everywhere). Returns int32 [...]."""
    while temps.ndim < logits.ndim - 1:
        temps, top_k, top_p = temps[..., None], top_k[..., None], \
            top_p[..., None]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[..., None]
    if apply_filter:
        scaled = filter_logits(scaled, top_k, top_p)
    probs = torch.softmax(scaled.float(), dim=-1)
    # q > 0, so filtered tokens (p = 0) score 0 and never win.
    q = torch.empty_like(probs).exponential_(generator=generator)
    sampled = torch.argmax(probs / q.clamp_(min=torch.finfo(q.dtype).tiny),
                           dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
