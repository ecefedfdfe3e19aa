"""Token selection for serving and the one-shot generate functions (port
of skypilot_tpu/models/generate.py: `filter_logits` and `sample_tokens`
(:19-70), `make_generate_fn` (:73), `teacher_forced_logits` (:143) and
`make_speculative_generate_fn` (:172)).

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

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import SlotCache


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


# -- one-shot generation -----------------------------------------------------
# The one-shot engine (serve_lm without --continuous-batching) runs each
# request alone through a dense per-request cache, the one the model
# builds (`dense_cache`: K/V rows, or DeepSeek's latent rows). The
# reference traces the step loop into one jitted scan; here it is a
# host loop of eager steps, with the reference's output contract.


def _eos_pad(out: torch.Tensor, prompt_len: int, eos_id: int
             ) -> torch.Tensor:
    """Every generated position after the first eos becomes eos."""
    positions = torch.arange(out.shape[1], device=out.device)[None, :]
    is_eos = (out == eos_id) & (positions >= prompt_len)
    hit = torch.cumsum(is_eos.int(), dim=1)
    keep = (hit - is_eos.int()) == 0
    return torch.where(keep, out, torch.full_like(out, eos_id))


def make_generate_fn(model, max_total_len: int, temperature: float = 0.0,
                     eos_id: Optional[int] = None) -> Callable:
    """Returns fn(prompt [B, P], generator=None) -> tokens [B, T]
    (int32, T = max_total_len): prompt ++ generated, every step of the
    bucket run (T - 1 single-token steps, the prompt's own tokens fed
    one at a time), positions after eos padded with eos."""
    if max_total_len > model.config.max_seq_len:
        raise ValueError(f'max_total_len {max_total_len} > model '
                         f'max_seq_len {model.config.max_seq_len}')

    @torch.no_grad()
    def generate(prompt: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        device = model.device
        prompt = torch.as_tensor(prompt, device=device).long()
        batch, prompt_len = prompt.shape
        cache = model.dense_cache(batch)
        temps = torch.full((batch,), float(temperature), device=device)
        off_k = torch.zeros((batch,), dtype=torch.int32, device=device)
        off_p = torch.ones((batch,), device=device)
        prev = torch.zeros((batch,), dtype=torch.long, device=device)
        steps = []
        for t in range(max_total_len - 1):
            tok = prompt[:, t] if t < prompt_len else prev
            positions = torch.full((batch, 1), t, dtype=torch.int32,
                                   device=device)
            logits = model(tok[:, None], positions, cache=cache)[:, 0]
            if temperature > 0:
                prev = sample_tokens(logits, temps, off_k, off_p, generator,
                                     apply_filter=False).long()
            else:
                prev = torch.argmax(logits, dim=-1)
            steps.append(prev)
        out = torch.zeros((batch, max_total_len), dtype=torch.long,
                          device=device)
        out[:, :prompt_len] = prompt
        if steps:
            # Position p >= prompt_len is the sample of step p - 1.
            sampled = torch.stack(steps, dim=1)
            out[:, prompt_len:] = sampled[:, prompt_len - 1:]
        if eos_id is not None:
            out = _eos_pad(out, prompt_len, eos_id)
        return out.to(torch.int32)

    return generate


@torch.no_grad()
def teacher_forced_logits(model, tokens: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-forward logits, decode-mode logits) [B, S, V] of the same
    tokens: the cached incremental path fed one token a step, against
    the batched forward."""
    tokens = torch.as_tensor(tokens, device=model.device).long()
    batch, seq = tokens.shape
    full = model(tokens)
    cache = model.dense_cache(batch)
    decoded = []
    for t in range(seq):
        positions = torch.full((batch, 1), t, dtype=torch.int32,
                               device=model.device)
        decoded.append(model(tokens[:, t:t + 1], positions,
                             cache=cache)[:, 0])
    return full, torch.stack(decoded, dim=1)


def _draft_row(row: np.ndarray, length: int, draft_k: int,
               ngram: int) -> np.ndarray:
    """draft_k tokens following the most recent earlier occurrence of
    the row's trailing n-gram; the last token repeated when there is
    none (the reference's `draft`, indices clamped as
    `lax.dynamic_slice` clamps them)."""
    total = row.shape[0]
    n_windows = total - ngram
    pattern = row[length - ngram:length]
    windows = np.stack([row[i:i + n_windows] for i in range(ngram)], -1)
    match = np.all(windows == pattern[None, :], axis=-1)
    match &= np.arange(n_windows) + ngram < length
    if not match.any():
        return np.full((draft_k,), row[length - 1], row.dtype)
    src = min(int(np.nonzero(match)[0].max()) + ngram, total - draft_k)
    return row[src:src + draft_k].copy()


def make_speculative_generate_fn(model, max_total_len: int,
                                 draft_k: int = 4, ngram: int = 2,
                                 eos_id: Optional[int] = None) -> Callable:
    """Greedy prompt-lookup speculative decoding through the dense
    cache: the prompt prefills in one chunk, then each round drafts
    `draft_k` tokens per row from an earlier occurrence of its trailing
    n-gram and verifies them in one [B, draft_k + 1] chunk, keeping the
    drafts the model's argmax agrees with plus its first correction.
    The output equals `make_generate_fn`'s greedy tokens.

    Returns fn(prompt [B, P], generator=None) -> tokens [B, T] (int32;
    the generator is unused: greedy)."""
    if draft_k < 1 or ngram < 1:
        raise ValueError(f'draft_k and ngram must be >= 1, got '
                         f'{draft_k}, {ngram}')
    # The verify chunk may write up to draft_k past the last kept token.
    if max_total_len + draft_k > model.config.max_seq_len:
        raise ValueError(f'max_total_len {max_total_len} + draft_k '
                         f'{draft_k} > max_seq_len '
                         f'{model.config.max_seq_len}')
    pad = draft_k + 1   # scratch tail so chunk writes stay in bounds

    def greedy(tokens: torch.Tensor, positions: torch.Tensor,
               cache: SlotCache) -> torch.Tensor:
        hidden = model.hidden(tokens, positions, cache)
        return torch.argmax(model.logits(hidden), dim=-1)

    @torch.no_grad()
    def generate(prompt: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        del generator   # greedy
        device = model.device
        prompt_np = np.asarray(torch.as_tensor(prompt).cpu(), np.int64)
        batch, prompt_len = prompt_np.shape
        total = max_total_len + pad
        cache = model.dense_cache(batch)
        tokens = np.zeros((batch, total), np.int64)
        tokens[:, :prompt_len] = prompt_np
        # Prefill: the whole prompt in one chunk, attending itself; its
        # last logits give the first generated token.
        positions = torch.arange(prompt_len, dtype=torch.int32,
                                 device=device).expand(batch, prompt_len)
        hidden = model.hidden(torch.from_numpy(prompt_np).to(device),
                              positions, cache, prefill=True)
        first = torch.argmax(model.logits(hidden[:, -1]), dim=-1)
        tokens[:, prompt_len] = first.cpu().numpy()
        length = np.full((batch,), prompt_len + 1, np.int64)
        span = np.arange(draft_k + 1)
        rows = np.arange(batch)[:, None]
        while (length < max_total_len).any():
            drafts = np.stack([_draft_row(tokens[b], int(length[b]),
                                          draft_k, ngram)
                               for b in range(batch)])
            tokens[rows, length[:, None] + span[:-1]] = drafts
            # Verify chunk: [x_{L-1}, d_1..d_k] at positions L-1..L+k-1.
            pos = (length - 1)[:, None] + span
            chunk = tokens[rows, pos]
            y = greedy(torch.from_numpy(chunk).to(device),
                       torch.from_numpy(pos).to(device, torch.int32),
                       cache).cpu().numpy()
            n_accept = np.cumprod(drafts == y[:, :-1], axis=1).sum(axis=1)
            tokens[rows, length[:, None] + span] = y
            advance = np.where(length < max_total_len, n_accept + 1, 0)
            length = np.minimum(length + advance, max_total_len)
        out = torch.from_numpy(tokens[:, :max_total_len]).to(device)
        if eos_id is not None:
            out = _eos_pad(out, prompt_len, eos_id)
        return out.to(torch.int32)

    return generate
