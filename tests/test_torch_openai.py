"""The port's request surface (inference/openai_compat.py, the SSE and
text endpoints of inference/http_server.py, runtime streaming) against
the JAX reference server, in process on the CPU: llama-tiny at f32 on
the same weights (the reference's init through the weight bridge),
continuous engines, and one locally written word-level tokenizer:

  - /generate_text, text /v1/completions with `stop`, `n=2`, `logprobs`
    0 and 5 with `echo` (also `max_tokens=0` scoring), and
    /v1/chat/completions with and without a chat template give the same
    response bodies; logprobs within 1e-4;
  - greedy SSE streams (/generate, /generate_text, /v1/completions and
    chat): the same events per row and the same terminal event;
  - the refusals (logprobs + stream, echo without logprobs, logprobs
    with an adapter, n out of range, an unknown model) give the same
    status and body;
  - a client that disconnects mid-stream frees its slot, and nothing
    more is committed for it; /stats carries the itl_ms_* keys;
  - the streaming helpers (StopStringScanner, trim_stops,
    IncrementalDecoder) give the reference's output on the reference's
    cases and on byte-level UTF-8 holdback.
"""
import dataclasses
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from skypilot_tpu.inference import http_server as jax_http
from skypilot_tpu.inference import openai_compat as jax_oai
from skypilot_tpu.inference import runtime as jax_runtime
from skypilot_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu_torch.inference import http_server as pt_http
from skypilot_tpu_torch.inference import openai_compat as pt_oai
from skypilot_tpu_torch.inference import runtime as pt_runtime
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama

VOCAB = 512
ENGINE_KW = dict(num_slots=3, max_total_len=96, prefill_chunk=16)
TEMPLATE = ("{% for m in messages %}{{ m['content'] }} {% endfor %}"
            "{% if add_generation_prompt %}w7{% endif %}")
LP_TOL = 1e-4


def _write_tokenizer(path, chat_template=None):
    """A word-level fast tokenizer over the whole vocab: id i is 'w<i>'
    (0 is <unk>), split on whitespace."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {'<unk>': 0}
    vocab.update({f'w{i}': i for i in range(1, VOCAB)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok,
                                                unk_token='<unk>')
    if chat_template is not None:
        fast.chat_template = chat_template
    fast.save_pretrained(str(path))
    return str(path)


def _text(rng, n):
    return ' '.join(f'w{int(i)}' for i in rng.integers(1, VOCAB, n))


def _serve(rt, make):
    server = make(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    """{'jax': port, 'torch': port, 'rts': (jax rt, torch rt), ...}:
    both servers on one f32 llama-tiny, one tokenizer and one adapter
    directory (the adapter only names a model for the refusals)."""
    root = tmp_path_factory.mktemp('openai')
    tok_dir = _write_tokenizer(root / 'tok')
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_total_pages=40)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    port_cfg = pt_llama.LlamaConfig(
        dtype=torch.float32,
        **{k: v for k, v in dataclasses.asdict(cfg).items()
           if k in fields and k not in ('dtype', 'rope_scaling')})
    port_model = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        port_cfg, device='cpu')
    adapter_dir = root / 'adapters'
    spec = jax_lora.LoraSpec(rank=4, alpha=8.0)
    jax_lora.save_adapter(str(adapter_dir / 'tenant'),
                          jax_lora.random_adapter_params(3, cfg, spec), spec,
                          base_model='llama-tiny')
    ref_engine = jax_batching.ContinuousBatchingEngine(model, params,
                                                       **ENGINE_KW)
    engine = pt_batching.ContinuousBatchingEngine(port_model, **ENGINE_KW)
    ref_rt = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=VOCAB,
        model_name='llama-tiny', max_total_len=96, spec_total=96,
        speculative=0, engine=ref_engine, engine_total=96,
        tokenizer_dir=tok_dir,
        adapters=JaxRegistry(str(adapter_dir), model))
    rt = pt_runtime.InferenceRuntime(
        engine=engine, model_name='llama-tiny', tokenizer_dir=tok_dir,
        adapters=AdapterRegistry(str(adapter_dir), port_model))
    served = [_serve(ref_rt, jax_http.make_server),
              _serve(rt, pt_http.make_server)]
    yield {'jax': served[0][0].server_address[1],
           'torch': served[1][0].server_address[1],
           'rts': (ref_rt, rt), 'root': root, 'model': port_model}
    for server, thread in served:
        server.shutdown()
        thread.join(timeout=10)
    ref_rt.stop()
    rt.stop()


def _post(port, path, body):
    """(status, JSON body) of a POST, errors included."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(port, path, body):
    """Every `data:` event of an SSE answer (JSON, or the string
    '[DONE]')."""
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    conn.request('POST', path, json.dumps(body),
                 {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader('Content-Type') == 'text/event-stream'
    events = []
    for line in resp:
        line = line.strip()
        if line.startswith(b'data: '):
            data = line[len(b'data: '):]
            events.append('[DONE]' if data == b'[DONE]'
                          else json.loads(data))
    conn.close()
    return events


def _both(servers, path, body):
    return [_post(servers[k], path, body) for k in ('jax', 'torch')]


def _assert_same(servers, path, body):
    ref, got = _both(servers, path, body)
    assert got == ref, (path, body)
    assert got[0] == 200, got
    return got[1]


def test_generate_text_matches_reference(servers):
    rng = np.random.default_rng(1)
    body = {'prompts': [_text(rng, 12), _text(rng, 30)],
            'max_new_tokens': 8}
    out = _assert_same(servers, '/generate_text', body)
    assert len(out['texts']) == 2 and all(out['texts'])
    out = _assert_same(servers, '/v1/generate_text',
                       dict(body, prompts=body['prompts'][0], stop='w1'))
    assert len(out['texts']) == 1


def test_completions_stop_and_n_match_reference(servers):
    rng = np.random.default_rng(2)
    prompt = _text(rng, 20)
    body = {'prompt': prompt, 'max_tokens': 10, 'temperature': 0.0}
    plain = _assert_same(servers, '/v1/completions', body)
    words = plain['choices'][0]['text'].split()
    assert len(words) == 10
    stopped = _assert_same(servers, '/v1/completions',
                           dict(body, stop=[words[4], 'w0w0']))
    choice = stopped['choices'][0]
    assert choice['finish_reason'] == 'stop'
    assert choice['text'] == plain['choices'][0]['text'].split(
        words[4])[0]
    fanned = _assert_same(servers, '/v1/completions',
                          dict(body, n=2, prompt=[prompt, _text(rng, 9)]))
    assert [c['index'] for c in fanned['choices']] == [0, 1, 2, 3]
    assert fanned['usage']['prompt_tokens'] == 29


def _assert_logprobs_close(got, ref):
    assert got.keys() == ref.keys()
    for key in ('tokens', 'text_offset'):
        assert got[key] == ref[key]
    for a, b in zip(got['token_logprobs'], ref['token_logprobs']):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= LP_TOL
    for a, b in zip(got['top_logprobs'], ref['top_logprobs']):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            assert all(abs(a[k] - b[k]) <= LP_TOL for k in a)


@pytest.mark.parametrize('logprobs,echo,max_tokens', [
    (0, False, 6), (5, True, 6), (5, True, 0), (2, False, 3)])
def test_logprobs_and_echo_match_reference(servers, logprobs, echo,
                                           max_tokens):
    rng = np.random.default_rng(3)
    body = {'prompt': [_text(rng, 14), _text(rng, 5)],
            'max_tokens': max_tokens, 'temperature': 0.0,
            'logprobs': logprobs, 'echo': echo}
    (ref_code, ref), (code, got) = _both(servers, '/v1/completions', body)
    assert code == ref_code == 200
    lps = [c.pop('logprobs') for c in got['choices']]
    ref_lps = [c.pop('logprobs') for c in ref['choices']]
    assert got == ref
    for lp, ref_lp in zip(lps, ref_lps):
        _assert_logprobs_close(lp, ref_lp)
        assert lp['token_logprobs'][0] is None if echo else \
            lp['token_logprobs'][0] is not None
        assert all(len(t) == logprobs for t in lp['top_logprobs']
                   if t is not None)


@pytest.mark.parametrize('template', [None, TEMPLATE])
def test_chat_matches_reference(servers, template, tmp_path):
    if template is not None:
        # Both runtimes keep the templated tokenizer where get_tokenizer
        # keeps the loaded one.
        tok_dir = _write_tokenizer(tmp_path / 'tok', template)
        from skypilot_tpu.models import hf_import as jax_hf
        from skypilot_tpu_torch.models import hf_import as pt_hf
        held = [rt._tok_holder.get('tok') for rt in servers['rts']]
        servers['rts'][0]._tok_holder['tok'] = jax_hf.load_tokenizer(tok_dir)
        servers['rts'][1]._tok_holder['tok'] = pt_hf.load_tokenizer(tok_dir)
    try:
        body = {'messages': [{'role': 'system', 'content': 'w3 w4'},
                             {'role': 'user', 'content': 'w5 w9 w33 w70'}],
                'max_tokens': 6, 'temperature': 0.0}
        out = _assert_same(servers, '/v1/chat/completions', body)
        assert out['object'] == 'chat.completion'
        assert out['choices'][0]['message']['role'] == 'assistant'
        lp = _both(servers, '/v1/chat/completions',
                   dict(body, logprobs=True, top_logprobs=2))
        assert lp[0][0] == lp[1][0] == 200
        for c, ref_c in zip(lp[1][1]['choices'], lp[0][1]['choices']):
            assert c['message'] == ref_c['message']
            for a, b in zip(c['logprobs']['content'],
                            ref_c['logprobs']['content']):
                assert a['token'] == b['token']
                assert abs(a['logprob'] - b['logprob']) <= LP_TOL
                assert [t['token'] for t in a['top_logprobs']] == \
                    [t['token'] for t in b['top_logprobs']]
        stream = [_sse(servers[k], '/v1/chat/completions',
                       dict(body, stream=True)) for k in ('jax', 'torch')]
        assert stream[1] == stream[0]
        assert stream[1][0]['choices'][0]['delta'] == {'role': 'assistant'}
        text = ''.join(e['choices'][0]['delta'].get('content', '')
                       for e in stream[1][:-1])
        assert text == out['choices'][0]['message']['content']
    finally:
        if template is not None:
            for rt, tok in zip(servers['rts'], held):
                rt._tok_holder['tok'] = tok


def _by_row(events, key):
    rows = {}
    for e in events:
        if isinstance(e, dict) and 'index' in e:
            rows.setdefault(e['index'], []).append(e[key])
    return rows


def test_generate_sse_matches_reference(servers):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, VOCAB, 13).tolist(),
               rng.integers(1, VOCAB, 27).tolist()]
    body = {'tokens': prompts, 'max_new_tokens': 9, 'stream': True}
    ref, got = [_sse(servers[k], '/generate', body)
                for k in ('jax', 'torch')]
    assert got[-1] == ref[-1] == '[DONE]'
    assert got[-2] == ref[-2]
    assert got[-2]['done'] is True
    assert _by_row(got, 'token') == _by_row(ref, 'token')
    plain = _post(servers['torch'], '/generate',
                  dict(body, stream=False))[1]['tokens']
    assert got[-2]['tokens'] == plain
    for i, row in _by_row(got, 'token').items():
        assert prompts[i] + row == plain[i]


def test_text_streams_match_reference(servers):
    rng = np.random.default_rng(5)
    gen_body = {'prompts': [_text(rng, 10), _text(rng, 21)],
                'max_new_tokens': 8, 'stream': True}
    ref, got = [_sse(servers[k], '/generate_text', gen_body)
                for k in ('jax', 'torch')]
    assert got[-1] == '[DONE]'
    assert _by_row(got, 'delta') == _by_row(ref, 'delta')
    plain = _post(servers['torch'], '/generate_text',
                  dict(gen_body, stream=False))[1]['texts']
    assert [''.join(d) for _, d in sorted(_by_row(got, 'delta').items())] \
        == plain
    prompt = _text(rng, 17)
    plain = _post(servers['torch'], '/v1/completions',
                  {'prompt': prompt, 'max_tokens': 8,
                   'temperature': 0.0})[1]['choices'][0]['text']
    body = {'prompt': prompt, 'max_tokens': 8, 'temperature': 0.0,
            'n': 2, 'stream': True, 'stop': [plain.split()[5]]}
    ref, got = [_sse(servers[k], '/v1/completions', body)
                for k in ('jax', 'torch')]
    assert got[-1] == '[DONE]'
    per_row = {}
    ref_rows = {}
    for events, out in ((got, per_row), (ref, ref_rows)):
        for e in events[:-1]:
            c = e['choices'][0]
            out.setdefault(c['index'], []).append(
                (c['text'], c['finish_reason']))
    assert per_row == ref_rows
    for row in per_row.values():
        assert ''.join(t for t, _ in row) == plain.split(
            plain.split()[5])[0]
        assert row[-1] == ('', 'stop')


REFUSALS = (
    ('/v1/completions', {'prompt': 'w1 w2', 'logprobs': 1, 'stream': True}),
    ('/v1/completions', {'prompt': 'w1 w2', 'echo': True}),
    ('/v1/completions', {'prompt': 'w1 w2', 'logprobs': 1,
                         'model': 'tenant'}),
    ('/v1/completions', {'prompt': 'w1 w2', 'n': 17}),
    ('/v1/completions', {'prompt': 'w1 w2', 'logprobs': 6}),
    ('/v1/completions', {'prompt': ['w1', 'w2'], 'stream': True}),
    ('/v1/completions', {'prompt': 'w1 w2', 'model': 'nope'}),
    ('/v1/chat/completions', {'messages': [{'role': 'user', 'content': 'w1'}],
                              'model': 'nope'}),
    ('/v1/chat/completions', {'messages': [{'role': 'user', 'content': 'w1'}],
                              'n': 0}),
    ('/generate_text', {'prompts': ['w1'], 'model': 'nope'}),
    ('/generate', {'tokens': [[1] * 96]}),
)


@pytest.mark.parametrize('path,body', REFUSALS)
def test_refusals_match_reference(servers, path, body):
    ref, got = _both(servers, path, body)
    assert got == ref
    assert got[0] in (400, 404)


def test_disconnect_frees_the_slot_and_itl_is_reported(servers):
    rt = pt_runtime.InferenceRuntime(
        engine=pt_batching.ContinuousBatchingEngine(
            servers['model'], num_slots=1, max_total_len=256,
            prefill_chunk=16),
        model_name='llama-tiny')
    server, thread = _serve(rt, pt_http.make_server)
    port = server.server_address[1]
    eng = rt.engine
    try:
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('POST', '/generate', json.dumps(
            {'tokens': [list(range(1, 11))], 'max_new_tokens': 240,
             'stream': True}), {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        seen = 0
        for line in resp:
            if line.startswith(b'data: '):
                seen += 1
                if seen == 4:
                    break
        resp.close()
        conn.close()
        deadline = time.monotonic() + 30
        while (eng.active.any() or eng.futures[0] is not None) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.active.any() and eng.futures[0] is None
        committed = eng.tokens_committed
        assert 4 <= committed < 240
        time.sleep(0.3)
        assert eng.tokens_committed == committed   # nothing more for it
        # The slot serves the next request.
        code, body = _post(port, '/generate', {'tokens': [[5, 6, 7]],
                                               'max_new_tokens': 3})
        assert code == 200 and len(body['tokens'][0]) == 6
        events = _sse(port, '/generate', {'tokens': [[5, 6, 7]],
                                          'max_new_tokens': 6,
                                          'stream': True})
        assert events[-2]['tokens'][0][:6] == body['tokens'][0]
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                    timeout=30) as resp:
            stats = json.loads(resp.read())['requests']
        for key in ('itl_ms_n', 'itl_ms_p50', 'itl_ms_p95', 'itl_ms_p99'):
            assert key in stats
        assert stats['itl_ms_n'] >= 5 + 3
        assert 0 < stats['itl_ms_p50'] <= stats['itl_ms_p99']
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=10)


# -- streaming helpers -------------------------------------------------------
SCANNER_CASES = (
    ([], ['hello ', 'world']),
    (['END'], ['abc', 'dENDxyz', 'more']),
    (['END'], ['abcE', 'N', 'Dtail']),
    (['END'], ['abcE', 'xyz']),
    (['<|eot|>'], list('hi there<|eot|>IGNORED')),
    (['YY', 'XX'], ['aXXbYYc']),
    (['ab', 'b'], ['xa', 'b', 'c']),
)


@pytest.mark.parametrize('stops,pushes', SCANNER_CASES)
def test_stop_scanner_matches_reference(stops, pushes):
    outs = []
    for mod in (jax_oai, pt_oai):
        s = mod.StopStringScanner(stops)
        outs.append(([s.push(p) for p in pushes], s.flush(), s.hit))
    assert outs[1] == outs[0]


@pytest.mark.parametrize('text,stops', [
    ('a b c', []), ('a b c', ['b']), ('a b c', ['z']), ('a b c', ['c', 'b']),
    ('abc', ['', 'c'])])
def test_trim_stops_matches_reference(text, stops):
    assert pt_oai.trim_stops(text, stops) == jax_oai.trim_stops(text, stops)


class _ByteTokenizer:
    """ids are UTF-8 bytes: a multi-byte character spans tokens."""

    def decode(self, ids, skip_special_tokens=True):
        return bytes(int(i) % 256 for i in ids).decode('utf-8',
                                                       errors='replace')


@pytest.mark.parametrize('text', ['héllo wörld', '日本語のテキスト',
                                  'emoji 🙂 end', 'plain ascii'])
def test_incremental_decoder_holds_partial_utf8(text):
    ids = list(text.encode())
    outs = []
    for mod in (jax_oai, pt_oai):
        dec = mod.IncrementalDecoder(_ByteTokenizer())
        outs.append([dec.push(t) for t in ids] + [dec.flush()])
    assert outs[1] == outs[0]
    assert ''.join(outs[1]) == text
    assert all('�' not in d for d in outs[1])
    # A stream cut mid-character drops the partial one at flush.
    dec = pt_oai.IncrementalDecoder(_ByteTokenizer())
    cut = list('é'.encode())[:1]
    assert [dec.push(t) for t in [104] + cut] == ['h', '']
    assert dec.flush() == ''
