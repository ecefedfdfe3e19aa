"""OpenAI-compatible completions / chat shims and SSE streaming (port
of skypilot_tpu/inference/openai_compat.py).

  - non-streaming completions with `n >= 1` (the one-shot mode runs
    the n samples as one [n, P] generate call; the continuous engine
    fans out n slot submissions that decode concurrently);
  - SSE streaming (`stream: true`) with the OpenAI chunk schemas
    (`text_completion` chunks; `chat.completion.chunk` deltas), tokens
    flushed as the engine commits them;
  - incremental detokenization (a token ending in a partial UTF-8
    sequence is held until it completes);
  - stop strings with holdback (text that could begin a stop string is
    not emitted until disambiguated);
  - `logprobs` (0-5 alternatives) and `echo`, from one teacher-forced
    scoring pass over the row (`InferenceRuntime.score_logprobs`).

Requests run through `InferenceRuntime`; HTTP writing goes through the
handler's small writer surface (`_json` / `sse_*`).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.inference.runtime import (FirstTokenLatch,
                                                  InferenceRuntime,
                                                  bucket_len,
                                                  iter_interleaved)


class IncrementalDecoder:
    """Streamed token ids -> text deltas. Decodes the whole generated
    prefix at each push and emits the new suffix; a trailing U+FFFD
    means the byte-level stream ends mid-codepoint, so the delta waits
    for the token that completes it."""

    def __init__(self, tok) -> None:
        self.tok = tok
        self.ids: List[int] = []
        self.text = ''

    def push(self, tok_id: int) -> str:
        self.ids.append(tok_id)
        full = self.tok.decode(self.ids, skip_special_tokens=True)
        if full.endswith('�'):
            return ''
        delta = full[len(self.text):]
        self.text = full
        return delta

    def flush(self) -> str:
        """Final delta (drops an unresolved partial codepoint)."""
        full = self.tok.decode(self.ids, skip_special_tokens=True)
        if full.endswith('�'):
            full = full[:-1]
        delta = full[len(self.text):]
        self.text = full
        return delta


class StopStringScanner:
    """Streaming with OpenAI `stop` semantics: the completion ends
    BEFORE the first occurrence of any stop string, and no text that
    might turn out to be part of one is emitted early."""

    def __init__(self, stops: List[str]) -> None:
        self.stops = [s for s in stops if s]
        self.buf = ''
        self.emitted = 0
        self.hit = False

    def _holdback(self) -> int:
        """Length of the longest buffer suffix that is a proper prefix
        of some stop string (not emittable yet)."""
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        return hold

    def push(self, delta: str) -> str:
        """The newly emittable text; sets `hit` when a stop string
        landed (the emittable text ends right before it)."""
        if self.hit:
            return ''
        self.buf += delta
        cut = -1
        for s in self.stops:
            i = self.buf.find(s)
            if i != -1:
                cut = i if cut == -1 else min(cut, i)
        if cut != -1:
            self.hit = True
            out = self.buf[self.emitted:cut]
            self.emitted = cut
            return out
        safe = len(self.buf) - self._holdback()
        out = self.buf[self.emitted:safe]
        self.emitted = max(self.emitted, safe)
        return out

    def flush(self) -> str:
        if self.hit:
            return ''
        out = self.buf[self.emitted:]
        self.emitted = len(self.buf)
        return out


def trim_stops(text: str, stops: List[str]) -> Tuple[str, bool]:
    """`text` cut before the first occurrence of any stop string, and
    whether one occurred."""
    cut = -1
    for s in stops:
        if not s:
            continue
        i = text.find(s)
        if i != -1:
            cut = i if cut == -1 else min(cut, i)
    if cut != -1:
        return text[:cut], True
    return text, False


class CompletionRequest:
    """Validated, normalized body shared by both /v1 endpoints (the
    reference's refusals, word for word)."""

    def __init__(self, prompts: List[str], max_new: int,
                 temperature: float, top_p: float, stop_strings, n: int,
                 stream: bool, logprobs: Optional[int] = None,
                 echo: bool = False, deadline_s: float = 600.0,
                 adapter: Optional[str] = None,
                 model: Optional[str] = None) -> None:
        if isinstance(stop_strings, str):
            stop_strings = [stop_strings]
        if logprobs is not None and adapter is not None:
            raise ValueError(
                'logprobs with an adapter model is not supported '
                '(the scoring pass runs base weights)')
        if n < 1 or n > 16:
            raise ValueError(f'n must be in [1, 16], got {n}')
        if stream and len(prompts) != 1:
            raise ValueError(
                'stream=true supports a single prompt per request')
        if logprobs is not None:
            logprobs = int(logprobs)
            if not 0 <= logprobs <= 5:
                raise ValueError(
                    f'logprobs must be in [0, 5], got {logprobs}')
            if stream:
                raise ValueError(
                    'logprobs with stream=true is not supported')
        if echo and logprobs is None:
            raise ValueError('echo requires logprobs')
        self.prompts = prompts
        self.max_new = max_new
        self.temperature = temperature
        self.top_p = top_p
        self.stop_strings = list(stop_strings or [])
        self.n = n
        self.stream = stream
        self.logprobs = logprobs
        self.echo = echo
        # Per-request deadline, seconds (the body's `timeout` clamped
        # into (0, --request-timeout]), carried into the engine slots.
        self.deadline_s = float(deadline_s)
        # The resolved adapter (None = base) and the requested model
        # name, which responses echo.
        self.adapter = adapter
        self.model = model


def _logprobs_block(rt: InferenceRuntime, tok, row: List[int], n_top: int,
                    echo: bool, prompt_len: int) -> Dict[str, object]:
    """The OpenAI completions `logprobs` object of one choice: each
    token's log-prob, its top-N alternatives and text offsets, from ONE
    teacher-forced scoring pass. With `echo` the prompt's tokens are
    covered too, position 0 scoring null."""
    chosen, top_ids, top_vals = rt.score_logprobs(row, n_top)
    start = 0 if echo else prompt_len
    tokens, token_logprobs, top_logprobs, offsets = [], [], [], []
    offset = 0
    for i in range(start, len(row)):
        piece = tok.decode([row[i]])
        tokens.append(piece)
        offsets.append(offset)
        offset += len(piece)
        if i == 0:
            token_logprobs.append(None)
            top_logprobs.append(None)
            continue
        token_logprobs.append(round(float(chosen[i - 1]), 5))
        top_logprobs.append(
            {tok.decode([int(t)]): round(float(v), 5)
             for t, v in zip(top_ids[i - 1], top_vals[i - 1])})
    return {'tokens': tokens, 'token_logprobs': token_logprobs,
            'top_logprobs': top_logprobs, 'text_offset': offsets}


def run_completion(rt: InferenceRuntime, req: CompletionRequest
                   ) -> Dict[str, object]:
    """Non-streaming completions: the OpenAI response dict. Each prompt
    yields `n` choices (indices p*n .. p*n+n-1)."""
    tok = rt.get_tokenizer()
    t0 = time.monotonic()
    encoded = [tok(p)['input_ids'] for p in req.prompts]
    limit = rt.limit_for(req.temperature)
    for ids in encoded:
        if len(ids) >= limit:
            raise ValueError(f'prompt tokenizes to {len(ids)} >= '
                             f'max_total_len {limit}')
    rows: List[List[int]] = []
    row_prompt: List[List[int]] = []   # prompt ids per output row
    ttft: Optional[float] = None       # the engine path latches it
    engine = rt.engine_for(req.adapter)
    if req.max_new <= 0:
        # Scoring mode (echo + logprobs + max_tokens=0, the
        # eval-harness contract): no generation at all.
        for ids in encoded:
            for _ in range(req.n):
                rows.append(list(ids))
                row_prompt.append(ids)
    elif engine is not None:
        latch = FirstTokenLatch()
        futs = []
        try:
            for ids in encoded:
                for _ in range(req.n):
                    futs.append(engine.submit(
                        ids, max_new_tokens=req.max_new,
                        temperature=req.temperature, top_p=req.top_p,
                        on_token=latch, deadline_s=req.deadline_s,
                        adapter=req.adapter))
                    row_prompt.append(ids)
        except Exception:
            # A shed submission mid-fan-out: cancel the admitted
            # siblings (they would decode for a client getting a 429).
            if futs:
                engine.cancel(futs)
            raise
        # The engine reaps expired requests; the host timeout is a
        # backstop.
        rows = [f.result(timeout=req.deadline_s + 30.0) for f in futs]
        ttft = latch.first_token_s
    else:
        for ids in encoded:
            # The n samples run as ONE [n, P] generate call.
            want = len(ids) + req.max_new
            bucket = bucket_len(want, limit)
            got = rt.run_one_shot(rt.get_fn(req.n, req.temperature, bucket),
                                  [ids] * req.n)
            for r in range(req.n):
                rows.append(got[r][:min(want, bucket)])
                row_prompt.append(ids)

    choices = []
    total_completion = 0
    for i, (ids, row) in enumerate(zip(row_prompt, rows)):
        text = tok.decode(row[len(ids):], skip_special_tokens=True)
        n_gen = len(row) - len(ids)
        finish = 'length' if n_gen >= req.max_new else 'stop'
        text, hit = trim_stops(text, req.stop_strings)
        if hit:
            finish = 'stop'
        total_completion += n_gen
        lp_block = None
        if req.logprobs is not None:
            lp_block = _logprobs_block(rt, tok, row, req.logprobs,
                                       req.echo, len(ids))
        if req.echo:
            text = tok.decode(ids, skip_special_tokens=True) + text
        choices.append({'index': i, 'text': text, 'finish_reason': finish,
                        'logprobs': lp_block})
    # Usage counts each PROMPT once (the OpenAI contract), however many
    # choices it fans out to.
    total_prompt = sum(len(ids) for ids in encoded)
    rt.metrics.record(time.monotonic() - t0, total_completion,
                      total_prompt, ttft)
    return {
        'object': 'text_completion',
        'model': req.model or rt.model_name,
        'choices': choices,
        'usage': {'prompt_tokens': total_prompt,
                  'completion_tokens': total_completion,
                  'total_tokens': total_prompt + total_completion},
    }


def stream_completion(rt: InferenceRuntime, req: CompletionRequest, writer,
                      chat: bool = False) -> None:
    """SSE streaming of one prompt x n choices: `text_completion`
    chunks, or with `chat` `chat.completion.chunk` deltas ({'role'}
    first, then {'content'}). The n choices decode concurrently in
    engine slots and their chunks interleave by arrival, each tagged
    with its index; per-choice finish_reason chunks and
    `data: [DONE]` end the stream. A consumer that disconnects cancels
    its rows."""
    tok = rt.get_tokenizer()
    ids = tok(req.prompts[0])['input_ids']
    limit = rt.limit_for(req.temperature, streaming=True)
    if len(ids) >= limit:
        raise ValueError(f'prompt tokenizes to {len(ids)} >= '
                         f'max_total_len {limit}')
    t0 = time.monotonic()
    handles = [rt.submit_stream(ids, req.max_new, req.temperature,
                                top_p=req.top_p, deadline_s=req.deadline_s,
                                adapter=req.adapter)
               for _ in range(req.n)]
    writer.sse_start()
    obj = 'chat.completion.chunk' if chat else 'text_completion'
    model_name = req.model or rt.model_name

    def chunk(index: int, text: Optional[str],
              finish: Optional[str] = None) -> Dict[str, object]:
        c: Dict[str, object] = {'index': index, 'finish_reason': finish}
        if chat:
            c['delta'] = {} if text is None else {'content': text}
        else:
            c['text'] = text or ''
            c['logprobs'] = None
        return {'object': obj, 'model': model_name, 'choices': [c]}

    if chat:
        for i in range(req.n):
            writer.sse_send({'object': obj, 'model': model_name,
                             'choices': [{'index': i,
                                          'delta': {'role': 'assistant'},
                                          'finish_reason': None}]})
    decs = [IncrementalDecoder(tok) for _ in range(req.n)]
    scans = [StopStringScanner(req.stop_strings) for _ in range(req.n)]
    n_gen = [0] * req.n
    ttft: Optional[float] = None
    try:
        for i, t in iter_interleaved(handles):
            if ttft is None:
                ttft = time.monotonic() - t0
            n_gen[i] += 1
            if scans[i].hit:
                continue   # post-stop tokens: dropped
            out = scans[i].push(decs[i].push(t))
            if out:
                writer.sse_send(chunk(i, out))
    finally:
        # A consumer that went away frees the slots now (no-op once
        # every row completed).
        rt.cancel_streams(handles)
    for i in range(req.n):
        if not scans[i].hit:
            out = scans[i].push(decs[i].flush()) + scans[i].flush()
            if out:
                writer.sse_send(chunk(i, out))
        finish = ('stop' if scans[i].hit
                  else 'length' if n_gen[i] >= req.max_new else 'stop')
        writer.sse_send(chunk(i, None, finish))
    writer.sse_done()
    rt.metrics.record(time.monotonic() - t0, sum(n_gen), len(ids), ttft)


_warned_no_template = False


def _warn_no_template(reason: str) -> None:
    global _warned_no_template
    if not _warned_no_template:
        _warned_no_template = True
        print(f'openai_compat: tokenizer has no usable chat template '
              f'({reason}); falling back to "role: content" prompts.',
              file=sys.stderr, flush=True)


def render_chat_prompt(rt: InferenceRuntime, messages) -> str:
    """The checkpoint's chat template, else a plain `role: content`
    rendering (base models ship no template)."""
    tok = rt.get_tokenizer()
    try:
        return tok.apply_chat_template(messages, tokenize=False,
                                       add_generation_prompt=True)
    except Exception as e:  # pylint: disable=broad-except
        _warn_no_template(f'{type(e).__name__}: {e}')
        return '\n'.join(f"{m['role']}: {m['content']}"
                         for m in messages) + '\nassistant:'


def to_chat_response(out: Dict[str, object]) -> Dict[str, object]:
    """A completions response dict rewritten as a chat.completion."""
    out['object'] = 'chat.completion'
    for c in out['choices']:
        c['message'] = {'role': 'assistant', 'content': c.pop('text')}
        lp = c.get('logprobs')
        if lp:
            # The completions block in the chat format ({content:
            # [{token, logprob, bytes, top_logprobs}]}).
            content = []
            for token, logprob, top in zip(lp['tokens'],
                                           lp['token_logprobs'],
                                           lp['top_logprobs']):
                content.append({
                    'token': token,
                    'logprob': logprob,
                    'bytes': list(token.encode()),
                    'top_logprobs': [
                        {'token': t, 'logprob': v,
                         'bytes': list(t.encode())}
                        for t, v in sorted((top or {}).items(),
                                           key=lambda kv: -kv[1])],
                })
            c['logprobs'] = {'content': content}
    return out
