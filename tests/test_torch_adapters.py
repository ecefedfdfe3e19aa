"""Port's multi-LoRA serving (skypilot_tpu_torch/inference/adapters.py,
the engine's adapter path, runtime/HTTP model selection) against the
JAX reference, CPU, llama-tiny at f32, rank 4 adapters written by the
reference's `save_adapter`:

  - the port engine's greedy tokens for base + 2 adapters (B factors
    amplified so adapters flip tokens) equal the JAX engine's, for bf16
    and int8 pools, and show three distinct streams; an adapter row
    equals the port's own merge_lora oracle; preemption and store
    back-pressure keep the adapter and the tokens;
  - the registry: LRU evicts unpinned adapters only, acquire is None
    when every slot is pinned, the rank ceiling, hot-load, unknown ->
    AdapterNotFoundError, and store stacks byte-identical to the JAX
    registry's after the same loads (f32 and bf16);
  - adapter-salted chain keys equal the reference's, and the prefix
    cache never shares pages across adapters;
  - base-only rounds pass no LoRA arguments at all;
  - HTTP on the CPU: `model` selects an adapter, unknown -> 404,
    /v1/models lists adapters, /stats shows them; serve_lm takes
    --adapter-dir.
"""
import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import affinity as jax_affinity
from skypilot_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu_torch.errors import AdapterLoadError, AdapterNotFoundError
from skypilot_tpu_torch.inference import affinity
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.inference.http_server import (classify_error,
                                                      make_server)
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import lora as pt_lora
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.ops import lora_kernel as lk
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPEC = jax_lora.LoraSpec(rank=4, alpha=8.0)
ENGINE_KW = dict(num_slots=3, max_total_len=64, prefill_chunk=16)
PROMPT = list(range(2, 22))          # 20 tokens: two full 8-token pages


def _port_config(cfg) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(dtype=torch.float32, **vals)


def _models(kv_dtype='bf16', **kw):
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_dtype=kv_dtype,
                                     **{'kv_total_pages': 40, **kw})
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        _port_config(cfg), device='cpu')
    return model, params, port


@pytest.fixture(scope='module')
def adapter_dir(tmp_path_factory):
    """Two rank-4 attention adapters written by the REFERENCE's
    save_adapter, B amplified (default deltas are ~1e-3) so they flip
    greedy tokens; returns (dir, raw factors)."""
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    root = str(tmp_path_factory.mktemp('adapters'))
    raw = {}
    for i in range(2):
        lp = jax_lora.random_adapter_params(i, cfg, SPEC)
        for layer in lp.values():
            for tgt in layer.values():
                tgt['b'] *= 60.0
        jax_lora.save_adapter(os.path.join(root, f'ad{i}'), lp, SPEC,
                              base_model='llama-tiny')
        raw[f'ad{i}'] = lp
    return root, raw


def _submit_mix(engine):
    """base, ad0, ad1 on one prompt, then base again (a prefix hit)."""
    specs = [(None, 4), ('ad0', 10), ('ad1', 10), (None, 6)]
    futs = [engine.submit(PROMPT, max_new_tokens=n, adapter=a)
            for a, n in specs]
    try:
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


@pytest.fixture(scope='module', params=['bf16', 'int8'])
def reference_run(request, adapter_dir):
    """(kv_dtype, port model, JAX engine outputs, JAX prefix hits)."""
    root, _ = adapter_dir
    model, params, port = _models(request.param)
    with pp.impl_scope('xla'):
        reg = JaxRegistry(root, model, max_adapters=4)
        eng = jax_batching.ContinuousBatchingEngine(
            model, params, adapter_store=reg, **ENGINE_KW)
        outs = _submit_mix(eng)
    return request.param, port, outs, eng.prefix_cache.hits


def test_engine_greedy_tokens_match_reference(reference_run, adapter_dir):
    _, port, ref_outs, ref_hits = reference_run
    root, _ = adapter_dir
    reg = AdapterRegistry(root, port, max_adapters=4)
    engine = pt_batching.ContinuousBatchingEngine(port, adapter_store=reg,
                                                  **ENGINE_KW)
    plain0 = lk.plain_calls
    outs = _submit_mix(engine)
    assert outs == ref_outs
    assert len({tuple(o) for o in outs[:3]}) == 3   # three real streams
    assert outs[3][:len(outs[0])] == outs[0]         # base is base
    assert engine.prefix_cache.hits == ref_hits
    assert lk.plain_calls > plain0                   # the QKV path ran
    assert reg.stats()['requests'] == {'ad0': 1, 'ad1': 1}
    assert not reg.stats()['pinned']


def test_adapter_stream_equals_merged_oracle(adapter_dir):
    """The served adapter row == a base engine over merge_lora weights
    (the artifact is the reference's own file)."""
    root, raw = adapter_dir
    _, _, port = _models()
    reg = AdapterRegistry(root, port, max_adapters=2)
    eng = pt_batching.ContinuousBatchingEngine(port, adapter_store=reg,
                                               **ENGINE_KW)
    merged = pt_lora.merge_lora(port, raw['ad1'], pt_lora.LoraSpec(
        rank=SPEC.rank, alpha=SPEC.alpha))
    ref_eng = pt_batching.ContinuousBatchingEngine(merged, **ENGINE_KW)
    try:
        got = eng.submit(PROMPT, max_new_tokens=8,
                         adapter='ad1').result(timeout=180)
        ref = ref_eng.submit(PROMPT, max_new_tokens=8).result(timeout=180)
    finally:
        eng.stop()
        ref_eng.stop()
    assert got == ref


def test_preemption_and_backpressure_keep_adapter(adapter_dir):
    """A 14-page pool forces page-pressure preemption, and one store
    slot forces acquire -> None re-queueing: tokens equal each request
    run alone, and no page or pin leaks."""
    root, _ = adapter_dir
    _, _, port = _models(kv_total_pages=14)
    prompts = [list(range(3, 43)), list(range(50, 90))]
    adapters = ['ad0', 'ad1']
    reg = AdapterRegistry(root, port, max_adapters=1)
    eng = pt_batching.ContinuousBatchingEngine(
        port, adapter_store=reg, num_slots=2, max_total_len=96,
        prefill_chunk=16, prefix_caching=False)
    try:
        alone = [eng.submit(p, max_new_tokens=50,
                            adapter=a).result(timeout=180)
                 for p, a in zip(prompts, adapters)]
        evictions0 = reg.evictions
        futs = [eng.submit(p, max_new_tokens=50, adapter=a)
                for p, a in zip(prompts, adapters)]
        together = [f.result(timeout=180) for f in futs]
        # Same adapter twice: both fit one store slot, and the pool
        # pressure preempts one of them mid-decode.
        futs = [eng.submit(p, max_new_tokens=50, adapter='ad0')
                for p in prompts]
        shared = [f.result(timeout=180) for f in futs]
        solo1 = eng.submit(prompts[1], max_new_tokens=50,
                           adapter='ad0').result(timeout=180)
    finally:
        eng.stop()
    assert together == alone
    assert reg.evictions > evictions0      # ad1 waited for ad0's slot
    assert shared == [alone[0], solo1]
    assert eng.preemptions >= 1
    assert not reg.stats()['pinned']
    assert not eng.slot_adapter.any()
    assert eng.allocator.free_pages == eng.total_pages - 1


def _store_arrays(stack):
    return {f'{l}/{t}/{k}': v for l, layer in stack.items()
            for t, f in layer.items() for k, v in f.items()}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_registry_store_byte_identical_to_reference(adapter_dir, dtype):
    root, _ = adapter_dir
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jdt)
    jreg = JaxRegistry(root, jax_llama.Llama(jcfg), max_adapters=3,
                       max_rank=6)
    port = convert.init_params(dataclasses.replace(
        _port_config(jcfg), dtype=tdt), device='cpu')
    reg = AdapterRegistry(root, port, max_adapters=3, max_rank=6)
    for name in ('ad1', 'ad0'):
        assert reg.acquire(name) == jreg.acquire(name)
    theirs = _store_arrays(jreg.model_lora()['layers'])
    ours = _store_arrays(reg.model_lora()['layers'])
    assert sorted(theirs) == sorted(ours)
    for key, t in ours.items():
        ref = np.asarray(theirs[key])
        assert tuple(t.shape) == ref.shape and t.dtype == tdt
        if dtype == 'f32':
            got, want = t.numpy().view(np.uint32), ref.view(np.uint32)
        else:
            got = t.view(torch.int16).numpy().view(np.uint16)
            want = ref.view(np.uint16)
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert reg.model_lora()['scale'] == 1.0
    assert not any(t[0].any() for t in ours.values())   # row 0 = base
    assert reg.stats() == jreg.stats()


def test_registry_lru_rank_ceiling_hot_load(adapter_dir):
    root, _ = adapter_dir
    _, _, port = _models()
    reg = AdapterRegistry(root, port, max_adapters=2)
    s0 = reg.acquire('ad0')            # pinned
    s1 = reg.acquire('ad1')
    reg.release(s1, tokens=5)          # resident, evictable
    assert reg.stats()['tokens'] == {'ad1': 5}
    # Hot-load: a new artifact dropped into the live directory.
    big = jax_lora.LoraSpec(rank=16, alpha=16.0)
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    jax_lora.save_adapter(os.path.join(root, 'ad2'),
                          jax_lora.random_adapter_params(2, cfg, SPEC),
                          SPEC, base_model='llama-tiny')
    jax_lora.save_adapter(os.path.join(root, 'too-big'),
                          jax_lora.random_adapter_params(9, cfg, big), big,
                          base_model='llama-tiny')
    try:
        assert 'ad2' not in reg.inventory()
        s2 = reg.acquire('ad2')        # rescan, then evicts ad1, never ad0
        assert s2 == s1
        assert reg.stats()['evictions'] == 1
        assert reg.loaded_names() == ['ad0', 'ad2']
        # Both slots pinned: back-pressure, not an eviction.
        assert reg.acquire('ad1') is None
        reg.release(s2)
        assert reg.acquire('ad1') == s2
        assert reg.stats()['evictions'] == 2 and reg.stats()['loads'] == 4
        reg.release(s2)
        with pytest.raises(AdapterLoadError, match='--max-lora-rank 16'):
            reg.acquire('too-big')
        assert reg.stats()['load_failures'] == 1
        with pytest.raises(AdapterNotFoundError):
            reg.acquire('nope')
        with pytest.raises(AdapterNotFoundError):
            reg.resolve('nope')
        reg.release(s0)
        assert reg.stats()['pinned'] == []
    finally:
        shutil.rmtree(os.path.join(root, 'ad2'))
        shutil.rmtree(os.path.join(root, 'too-big'))
    # mesh= is the grid of the model served (parallel/serving.py); any
    # other refuses.
    with pytest.raises(ValueError, match='mesh='):
        AdapterRegistry(root, port, mesh=object())
    assert classify_error(AdapterLoadError('x'))[0] == 503
    assert classify_error(AdapterNotFoundError('x'))[0] == 404


def test_salted_chain_keys_match_reference():
    tokens = list(range(1, 40))
    for name in (None, '', 'alice', 'bob'):
        salt = affinity.adapter_salt(name)
        assert salt == jax_affinity.adapter_salt(name)
        assert pt_batching.PrefixCache.chain_keys(tokens, 8, salt=salt) \
            == jax_batching.PrefixCache.chain_keys(tokens, 8, salt=salt)
    assert affinity.adapter_salt('alice') == b'lora\x00alice'
    assert pt_batching.PrefixCache.chain_keys(tokens, 8) != \
        pt_batching.PrefixCache.chain_keys(tokens, 8,
                                           salt=affinity.adapter_salt('a'))


def test_prefix_cache_isolation_and_base_fast_path(adapter_dir):
    """Same prompt + same adapter: full hits; other adapter or base:
    zero. Rounds with no adapter lane pass no LoRA arguments."""
    root, _ = adapter_dir
    _, _, port = _models()
    reg = AdapterRegistry(root, port, max_adapters=2)
    eng = pt_batching.ContinuousBatchingEngine(port, adapter_store=reg,
                                               **ENGINE_KW)
    prompt = list(range(100, 125))     # three full 8-token pages
    pc = eng.prefix_cache
    try:
        assert eng._lora_args() == {} and eng._slot_lora_args(0) == {}
        plain0 = lk.plain_calls
        eng.submit(prompt, max_new_tokens=4).result(timeout=180)
        assert lk.plain_calls == plain0       # base-only: no LoRA code
        h = pc.hits
        eng.submit(prompt, max_new_tokens=4,
                   adapter='ad0').result(timeout=180)
        assert pc.hits == h                   # base pages: not shared
        eng.submit(prompt, max_new_tokens=4,
                   adapter='ad0').result(timeout=180)
        assert pc.hits == h + 3               # same tenant: all 3 hit
        eng.submit(prompt, max_new_tokens=4,
                   adapter='ad1').result(timeout=180)
        assert pc.hits == h + 3               # other tenant: none
        with pytest.raises(AdapterNotFoundError):
            eng.submit(prompt, max_new_tokens=4, adapter='nope')
    finally:
        eng.stop()
    base_eng = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        with pytest.raises(AdapterNotFoundError, match='no adapter store'):
            base_eng.submit(prompt, adapter='ad0')
    finally:
        base_eng.stop()


def _http(port, path, body=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=json.dumps(body).encode() if body is not None else None,
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_model_field_selects_adapter(tmp_path):
    """serve_lm --cpu --adapter-dir: the `model` field selects the
    adapter (tokens equal the engine's own), unknown models 404,
    /v1/models and /stats list the adapters."""
    cfg = registry.model_config('llama-tiny', 64)
    spec = pt_lora.LoraSpec(rank=4, alpha=8.0)
    for i, name in enumerate(('tenant-a', 'tenant-b')):
        lp = pt_lora.random_adapter_params(i, cfg, spec)
        for layer in lp.values():
            for tgt in layer.values():
                tgt['b'] *= 60.0
        pt_lora.save_adapter(str(tmp_path / name), lp, spec,
                             base_model='llama-tiny')
    args = serve_lm.parse_args([
        '--cpu', '--model', 'llama-tiny', '--continuous-batching',
        '--max-total-len', '64', '--num-slots', '2', '--prefill-chunk',
        '16', '--adapter-dir', str(tmp_path), '--max-adapters', '1',
        '--max-lora-rank', '4', '--port', '0'])
    rt = build_runtime(args)
    assert rt.resolve_model('llama-tiny') is None
    assert rt.resolve_model('base') is None
    assert rt.resolve_model('tenant-b') == 'tenant-b'
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        rows = {}
        for model in (None, 'tenant-a', 'tenant-b'):
            body = {'tokens': [PROMPT], 'max_new_tokens': 6}
            if model:
                body['model'] = model
            code, got = _http(port, '/generate', body)
            assert code == 200, got
            rows[model] = got['tokens'][0]
        assert len({tuple(r) for r in rows.values()}) == 3
        code, got = _http(port, '/v1/completions',
                          {'model': 'tenant-a', 'prompt': PROMPT,
                           'max_tokens': 6, 'temperature': 0.0})
        assert code == 200
        assert got['choices'][0]['tokens'] == rows['tenant-a'][len(PROMPT):]
        code, got = _http(port, '/v1/completions',
                          {'model': 'nope', 'prompt': PROMPT})
        assert code == 404
        assert got['error']['code'] == 'model_not_found'
        code, got = _http(port, '/generate',
                          {'model': 'nope', 'tokens': [PROMPT]})
        assert code == 404 and 'nope' in got['error']
        code, models = _http(port, '/v1/models')
        assert [m['id'] for m in models['data']] == \
            ['llama-tiny', 'tenant-a', 'tenant-b']
        code, stats = _http(port, '/stats')
        ad = stats['adapters']
        assert ad['inventory'] == ['tenant-a', 'tenant-b']
        assert ad['loads'] == 3 and ad['evictions'] == 2   # one slot
        assert ad['requests'] == {'tenant-a': 2, 'tenant-b': 1}
        assert stats['qkv_lora']['kernel_launches'] == 0
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
