"""Port's continuous-batching engine and HTTP server against the JAX
reference engine, CPU, llama-tiny at f32:

  - the port's engine emits exactly the reference engine's greedy
    tokens for kv_dtype 'bf16' (stored in f32 here) and 'int8', with
    page size 8 and 16-token prefill chunks, so every ~40-token prompt
    runs chunks at offset > 0 through the paged-chunk path; three
    requests share two slots (one waits in the queue) and the third
    shares a 16-token prefix with the first, which has finished by
    then: both engines count the same prefix-cache hits;
  - PrefixCache.chain_keys equals inference/affinity.chain_keys;
  - the port's make_server answers POST /generate and /v1/completions
    with those same tokens.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import affinity
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama

ENGINE_KW = dict(num_slots=2, max_total_len=96, prefill_chunk=16)
MAX_NEW = (4, 12, 8)    # the first request finishes first


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 512, 16).tolist()
    return [shared + rng.integers(1, 512, 24).tolist(),
            rng.integers(1, 512, 38).tolist(),
            shared + rng.integers(1, 512, 25).tolist()]


def _port_config(cfg) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(dtype=torch.float32, **vals)


def _models(kv_dtype):
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_total_pages=40, kv_dtype=kv_dtype)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        _port_config(cfg), device='cpu')
    return model, params, port


def _run(engine):
    futs = [engine.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), MAX_NEW)]
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.stop()


@pytest.fixture(scope='module', params=['bf16', 'int8'])
def served(request):
    """(kv_dtype, port model, reference outputs, reference hits)."""
    model, params, port = _models(request.param)
    ref = jax_batching.ContinuousBatchingEngine(model, params, **ENGINE_KW)
    outs = _run(ref)
    return request.param, port, outs, ref.prefix_cache.hits


def test_engine_greedy_tokens_match_reference(served):
    _, port, ref_outs, ref_hits = served
    engine = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    outs = _run(engine)
    for out, prompt, n in zip(outs, _prompts(), MAX_NEW):
        assert len(out) == len(prompt) + n
    assert outs == ref_outs
    assert ref_hits == 2    # the third request reused two shared pages
    assert engine.prefix_cache.hits == ref_hits
    assert engine.prefill_chunks_run >= 7    # chunks at offset > 0 ran


def test_chain_keys_match_affinity():
    tokens = _prompts()[0]
    for salt in (b'', affinity.adapter_salt('tenant-a')):
        assert (pt_batching.PrefixCache.chain_keys(tokens, 8, salt=salt)
                == affinity.chain_keys(tokens, 8, salt=salt))


def _post(port, path, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_http_server_answers_with_reference_tokens(served):
    kv_dtype, port_model, ref_outs, _ = served
    engine = pt_batching.ContinuousBatchingEngine(port_model, **ENGINE_KW)
    rt = InferenceRuntime(engine=engine, model_name='llama-tiny')
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        prompts = _prompts()
        got = _post(port, '/generate', {'tokens': [prompts[1]],
                                        'max_new_tokens': MAX_NEW[1]})
        assert got['tokens'] == [ref_outs[1]]
        comp = _post(port, '/v1/completions',
                     {'prompt': prompts[0], 'max_tokens': MAX_NEW[0],
                      'temperature': 0.0})
        assert comp['choices'][0]['tokens'] == \
            ref_outs[0][len(prompts[0]):]
        assert comp['usage']['completion_tokens'] == MAX_NEW[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, '/v1/completions', {'prompt': 'text'})
        assert err.value.code == 400
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}/stats', timeout=30) as resp:
            stats = json.loads(resp.read())
        assert stats['kv_pool']['dtype'] == kv_dtype
        assert stats['engine']['tokens_committed'] == \
            MAX_NEW[0] + MAX_NEW[1]
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}/readyz', timeout=30) as resp:
            assert json.loads(resp.read())['ready']
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize('top_k,top_p', [(0, 0.9), (5, 1.0), (3, 0.5),
                                         (0, 1.0)])
def test_filter_logits_and_greedy_match_reference(top_k, top_p):
    from skypilot_tpu.models import generate as jax_generate
    from skypilot_tpu_torch.models import generate as pt_generate
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # a tie
    k = np.full((4,), top_k, np.int32)
    p = np.full((4,), top_p, np.float32)
    ref = np.asarray(jax_generate.filter_logits(
        jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p)))
    out = pt_generate.filter_logits(torch.from_numpy(logits),
                                    torch.from_numpy(k),
                                    torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    greedy = pt_generate.sample_tokens(
        torch.from_numpy(logits), torch.zeros(4), torch.from_numpy(k),
        torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(greedy,
                                  np.asarray(jnp.argmax(logits, -1)))
    assert greedy[2] == 7     # first index on ties
