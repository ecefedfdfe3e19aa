"""The port's metrics plane (skypilot_tpu_torch/observability/
{metrics,catalog}.py, runtime.ServingMetrics, the /stats and /metrics
bodies of inference/http_server.py, the trainer's and checkpoints'
counters) against the JAX package, CPU:

  - the catalog: SPECS (every series: kind, help, labels, buckets) and
    the bucket ladders are the reference's, equal as Python values; the
    EngineMetrics / RequestMetrics bundles hold the same instruments;
  - rendering: every catalog series, created in a fresh registry of each
    package and updated by one seeded sequence (label values that need
    escaping, histogram observations on and between bucket bounds,
    integer and fractional samples), renders to byte-equal text
    exposition 0.0.4;
  - ServingMetrics: both snapshots agree on the same record stream (the
    TTFTs 10, 20, ..., 600 ms give p99 594.1 and p95 570.5, linear
    interpolation; C4's percentile half), with shed, deadline and ITL
    records and the SLO hooks;
  - /stats (C4's schema half): the same work through a reference replica
    and a port replica gives the same keys, recursively, less the
    port-only keys PORT_ONLY_KEYS; engine is 'continuous';
  - /metrics: the same requests through both replicas, each on a fresh
    registry, give the same family names and label names, and the same
    counts of requests, prompt and completion tokens, admissions, decode
    steps and committed tokens; an injected adapters.load failure is the
    reference's answer (503) and the next request to that adapter loads;
  - the trainer's and checkpoints' counters tick where the reference's
    do (tests/unit_tests/test_train_guard.py:90-150).

Numeric comparisons: percentiles and counters are compared with ==
(the same float arithmetic on both sides); rendered text byte for byte.
"""
import json
import math
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from skypilot_tpu.inference import http_server as jax_http
from skypilot_tpu.inference import runtime as jax_runtime
from skypilot_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.observability import catalog as ref_catalog
from skypilot_tpu.observability import metrics as ref_metrics
from skypilot_tpu.observability import slo as ref_slo
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu.robustness import faults as ref_faults
from skypilot_tpu.robustness import train_guard as ref_guard
from skypilot_tpu_torch.inference import http_server as pt_http
from skypilot_tpu_torch.inference import runtime as pt_runtime
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.observability import catalog
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import slo
from skypilot_tpu_torch.parallel import checkpoints
from skypilot_tpu_torch.robustness import faults, train_guard

from test_torch_adapters import PROMPT, _models, adapter_dir  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ENGINE_KW = dict(num_slots=3, max_total_len=64, prefill_chunk=16)

#: /stats keys only the port serves: the kernels' launch counts, the
#: engine's full stats() dict, and the replica's device, zone and model.
PORT_ONLY_KEYS = ('paged_attention', 'qkv_lora', 'device', 'zone',
                  'model', 'engine_stats')


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


# -- the catalog -------------------------------------------------------------
def test_catalog_is_the_references():
    assert catalog.SPECS == ref_catalog.SPECS
    for name in ('STEP_BUCKETS', 'REQUEST_BUCKETS', 'TOKEN_GAP_BUCKETS'):
        assert getattr(catalog, name) == getattr(ref_catalog, name)
    assert metrics.DEFAULT_BUCKETS == ref_metrics.DEFAULT_BUCKETS
    assert metrics.Registry.CONTENT_TYPE == ref_metrics.Registry.CONTENT_TYPE
    assert metrics.REGISTRY is not ref_metrics.REGISTRY


def test_bundles_hold_the_references_instruments():
    def shape(bundle):
        out = {}
        for attr, inst in vars(bundle).items():
            if attr.startswith('_') and attr != '_engine_label':
                continue
            fam = getattr(inst, '_family', inst)
            out[attr] = (type(fam).__name__, getattr(fam, 'name', inst))
        return out

    assert shape(catalog.EngineMetrics('x')) == \
        shape(ref_catalog.EngineMetrics('x'))
    assert shape(catalog.RequestMetrics()) == \
        shape(ref_catalog.RequestMetrics())
    latch = catalog.FirstTokenLatch()
    assert latch.first_token_s is None
    latch(7)
    first = latch.first_token_s
    latch(8)
    assert first is not None and latch.first_token_s == first


def _render_all(metrics_mod, catalog_mod, seed):
    """Every catalog series in a fresh registry, updated by one seeded
    sequence, rendered."""
    reg = metrics_mod.Registry()
    fams = {name: catalog_mod._create(name, reg)  # pylint: disable=protected-access
            for name in sorted(catalog_mod.SPECS)}
    rng = np.random.default_rng(seed)
    values = ['0', 'a"b', 'back\\slash', 'line\nbreak', 'plain']
    for _ in range(600):
        name = sorted(fams)[int(rng.integers(len(fams)))]
        fam = fams[name]
        target = fam
        if fam.labelnames:
            target = fam.labels(**{ln: values[int(rng.integers(5))]
                                   for ln in fam.labelnames})
        kind = catalog_mod.SPECS[name][0]
        if kind == 'histogram':
            bounds = fam.buckets
            v = (float(bounds[int(rng.integers(len(bounds)))])
                 if rng.random() < 0.4 else float(rng.lognormal(-3, 2)))
            target.observe(v)
        elif kind == 'counter':
            target.inc(float(rng.choice([1, 2, 0.25, 1e-3])))
        elif rng.random() < 0.5:
            target.set(float(rng.choice([0, 3, -2.5, 1e12, 7.125])))
        else:
            target.inc()
    return reg.render()


@pytest.mark.parametrize('seed', [0, 1])
def test_rendering_is_byte_equal(seed):
    got = _render_all(metrics, catalog, seed)
    want = _render_all(ref_metrics, ref_catalog, seed)
    assert got.encode() == want.encode()
    assert '\\"' in got and '\\\\' in got and '\\n' in got
    assert 'le="+Inf"' in got and '# TYPE' in got


def test_registry_refuses_as_the_reference():
    for mod in (metrics, ref_metrics):
        reg = mod.Registry()
        reg.get_or_create(mod.Counter, 'skypilot_x_total', 'h', ('a',))
        with pytest.raises(ValueError):
            reg.get_or_create(mod.Gauge, 'skypilot_x_total', 'h', ('a',))
        with pytest.raises(ValueError):
            mod.Counter('Bad-Name', 'h')
        with pytest.raises(ValueError):
            mod.Counter('skypilot_y_total', 'h').inc(-1)


# -- ServingMetrics -------------------------------------------------------------
def _serving_run(module, slo_module):
    m = module.ServingMetrics()
    clock = {'t': 500.0}
    m.slo = slo_module.SloTracker(
        {'p99_ttft_ms': 300.0, 'p99_itl_ms': 20.0, 'error_rate': 0.05,
         'shed_rate': 0.1}, clock=lambda: clock['t'], publish=False)
    for i in range(1, 61):
        m.record(0.05 * i, i % 7, ttft_s=i / 100.0, n_prompt_tokens=i)
        m.record_inter_token(0.001 * (i % 13 + 1))
        if i % 10 == 0:
            m.record_shed()
        if i % 15 == 0:
            m.record_deadline_exceeded()
        clock['t'] += 1.0
    m.record(0.3, 2)   # a one-shot request: no TTFT
    return m.snapshot(), m.slo.snapshot()


def test_serving_metrics_snapshot_is_the_references():
    got = _serving_run(pt_runtime, slo)
    want = _serving_run(jax_runtime, ref_slo)
    assert got == want
    snap = got[0]
    assert (snap['ttft_ms_p99'], snap['ttft_ms_p95'],
            snap['ttft_ms_p50']) == (594.1, 570.5, 305.0)
    assert snap['ttft_ms_n'] == 60 and snap['latency_ms_n'] == 61


# -- replicas ------------------------------------------------------------------
def _serving(rt, make):
    server = make(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data,
                                 headers={'Content-Type':
                                          'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _keys(body, prefix=''):
    """Every key path of a JSON body, dicts recursed."""
    out = set()
    for k, v in body.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ('migrations', 'requests',
                                             'tokens'):
            out |= _keys(v, prefix + k + '.')
    return out


def _parse_exposition(text):
    """{family: (type, label names, {sample line name+labels: value})},
    checking every line parses as exposition 0.0.4."""
    fams = {}
    for line in text.splitlines():
        if line.startswith('# HELP '):
            continue
        if line.startswith('# TYPE '):
            _, _, name, typ = line.split(' ')
            fams[name] = [typ, set(), {}]
            continue
        head, _, value = line.rpartition(' ')
        float(value)
        name, _, labels = head.partition('{')
        base = name
        for suffix in ('_bucket', '_sum', '_count'):
            if name.endswith(suffix) and name[:-len(suffix)] in fams:
                base = name[:-len(suffix)]
        names = {kv.split('=', 1)[0] for kv in labels.rstrip('}').split(',')
                 if kv} - {'le'}
        fams[base][1] |= names
        fams[base][2][head] = float(value)
    return fams


def _total(fams, name, suffix=''):
    return sum(v for k, v in fams[name][2].items()
               if k.partition('{')[0] == name + suffix)


@pytest.fixture()
def replicas(adapter_dir, monkeypatch):  # noqa: F811
    """A reference replica and a port replica with the same weights and
    adapters, each on a fresh metrics registry, an SLO tracker each."""
    monkeypatch.setattr(metrics, 'REGISTRY', metrics.Registry())
    monkeypatch.setattr(pt_http, 'REGISTRY', metrics.REGISTRY)
    monkeypatch.setattr(ref_metrics, 'REGISTRY', ref_metrics.Registry())
    monkeypatch.setattr(jax_http, 'REGISTRY', ref_metrics.REGISTRY)
    root, _ = adapter_dir
    model, params, port = _models('bf16')
    scope = pp.impl_scope('xla')
    scope.__enter__()
    ref_reg = JaxRegistry(root, model, max_adapters=2)
    ref_rt = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=model.config.vocab_size,
        model_name='llama-tiny', max_total_len=64, spec_total=64,
        speculative=0, engine_total=64, adapters=ref_reg,
        engine=jax_batching.ContinuousBatchingEngine(
            model, params, adapter_store=ref_reg, **ENGINE_KW))
    reg = AdapterRegistry(root, port, max_adapters=2)
    rt = pt_runtime.InferenceRuntime(
        engine=pt_batching.ContinuousBatchingEngine(
            port, adapter_store=reg, **ENGINE_KW),
        model_name='llama-tiny', adapters=reg)
    spec = 'p99_ttft_ms=5000,p99_itl_ms=500,error_rate=0.05'
    ref_rt.slo_tracker = ref_slo.SloTracker(ref_slo.parse_slo(spec))
    ref_rt.metrics.slo = ref_rt.slo_tracker
    rt.slo_tracker = slo.SloTracker(slo.parse_slo(spec))
    rt.metrics.slo = rt.slo_tracker
    servers = [_serving(ref_rt, jax_http.make_server),
               _serving(rt, pt_http.make_server)]
    try:
        yield [(s.server_address[1], r) for s, r in
               zip(servers, (ref_rt, rt))]
    finally:
        for server, r in zip(servers, (ref_rt, rt)):
            server.shutdown()
            r.engine.stop()
        scope.__exit__(None, None, None)


#: Sequential requests (each waits for its answer): base, ad0 with its
#: first load failing, ad0 again, ad1, two base rows.
def _work(port):
    answers = []
    for body in ({'tokens': [PROMPT], 'max_new_tokens': 5},
                 {'tokens': [PROMPT], 'max_new_tokens': 4, 'model': 'ad0'},
                 {'tokens': [PROMPT], 'max_new_tokens': 4, 'model': 'ad0'},
                 {'tokens': [PROMPT[:11]], 'max_new_tokens': 6,
                  'model': 'ad1'}):
        code, out = _http(port, '/generate', body)
        answers.append((code, out if code == 200 else
                        out['error'].split(':')[0]))
    answers.append(_http(port, '/generate',
                         {'tokens': [PROMPT[:13], PROMPT[2:9]],
                          'max_new_tokens': 3}))
    return answers


def test_stats_and_metrics_match_the_reference_replica(replicas):
    plan = {'seed': 0, 'rules': [{'point': 'adapters.load', 'at': [1]}]}
    faults.install_plan(plan)
    ref_faults.install_plan(plan)
    (ref_port, ref_rt), (port, rt) = replicas
    ref_answers = _work(ref_port)
    answers = _work(port)
    assert answers == ref_answers
    assert [a[0] for a in answers] == [200, 503, 200, 200, 200]
    assert answers[1][1] == 'AdapterLoadError'
    bodies = [_http(p, '/stats')[1] for p in (ref_port, port)]
    texts = [_http(p, '/metrics')[1] for p in (ref_port, port)]
    assert [_http(p, '/v1/metrics')[0] for p in (ref_port, port)] == \
        [200, 200]

    # /stats: the reference's keys, recursively, less the port's own.
    ref_body, body = bodies
    port_only = {k for k in _keys(body)
                 if k.split('.')[0] in PORT_ONLY_KEYS}
    assert _keys(body) - port_only == _keys(ref_body)
    assert body['engine'] == ref_body['engine'] == 'continuous'
    for key in ('num_slots', 'active_slots', 'queued', 'decode_calls',
                'tokens_committed', 'preemptions', 'engine_restarts',
                'deadline_exceeded', 'requests_shed', 'queued_tokens',
                'max_queue_requests', 'max_queue_tokens',
                'prefill_token_budget', 'pipeline_stages',
                'prefill_bubble_fraction'):
        assert body[key] == ref_body[key], key
    assert body['storage']['mesh_devices'] == 1
    assert body['storage']['stages'] == 1
    assert body['pid'] == os.getpid() and 'slo' in body
    assert body['attention_impl'] == 'torch'
    apt, ref_apt = (body['attention_bytes_per_token'],
                    ref_body['attention_bytes_per_token'])
    for key in ('context_tokens_walked', 'kv_pool_bytes', 'kv_scale_bytes',
                'lora_bytes'):
        assert apt[key] == ref_apt[key], key
    assert body['serving']['requests'] == ref_body['serving']['requests']
    assert body['adapters']['load_failures'] == 1

    # /metrics: the same families, label names and counts.
    ref_fams, fams = (_parse_exposition(t) for t in texts)
    assert set(fams) == set(ref_fams)
    assert {n: (f[0], f[1]) for n, f in fams.items()} == \
        {n: (f[0], f[1]) for n, f in ref_fams.items()}
    for name, suffix in (
            ('skypilot_serving_requests_total', ''),
            ('skypilot_serving_prompt_tokens_total', ''),
            ('skypilot_serving_completion_tokens_total', ''),
            ('skypilot_serving_admissions_total', ''),
            ('skypilot_serving_decode_steps_total', ''),
            ('skypilot_serving_tokens_committed_total', ''),
            ('skypilot_serving_adapter_loads_total', ''),
            ('skypilot_serving_adapter_load_failures_total', ''),
            ('skypilot_serving_adapter_requests_total', ''),
            ('skypilot_serving_decode_step_seconds', '_count'),
            ('skypilot_serving_prefill_chunk_seconds', '_count'),
            ('skypilot_serving_ttft_seconds', '_count')):
        assert _total(fams, name, suffix) == \
            _total(ref_fams, name, suffix), name
    assert _total(fams, 'skypilot_serving_tokens_committed_total') == \
        body['tokens_committed']
    assert _total(fams, 'skypilot_serving_decode_steps_total') == \
        body['decode_calls']
    assert _total(fams, 'skypilot_serving_decode_step_seconds',
                  '_count') >= body['decode_calls']


# -- trainer and checkpoint counters -----------------------------------------
def _counter_deltas(guard_mod, catalog_mod, tmp_path):
    names = ('skypilot_train_guard_skipped_steps_total',
             'skypilot_train_watchdog_aborts_total',
             'skypilot_train_preempt_notices_total')
    before = [catalog_mod.counter(n).value for n in names]
    g = guard_mod.SpikeGuard(rollback_after=5)
    g.observe(0, math.nan, math.nan, True)
    g.observe(1, 1.0, 1.0, False)
    codes = []
    with open(tmp_path / 'wd.log', 'w+', encoding='utf-8') as stream:
        wd = guard_mod.StepWatchdog(deadline_s=0.1, poll_interval_s=0.02,
                                    exit_fn=codes.append, stream=stream)
        wd._abort('data', 1.0, 0.1)  # pylint: disable=protected-access
    notice = guard_mod.PreemptionNotice(
        poll_interval_s=0.01, metadata_url='http://127.0.0.1:9/x',
        install_sigterm=False)
    notice.trigger('injected')
    notice.trigger('sigterm')   # latched: counts once
    return ([catalog_mod.counter(n).value - b
             for n, b in zip(names, before)], codes)


def test_trainer_counters_tick_as_the_reference(tmp_path):
    got = _counter_deltas(train_guard, catalog, tmp_path)
    want = _counter_deltas(ref_guard, ref_catalog, tmp_path)
    assert got == want == ([1, 1, 1], [train_guard.EXIT_WATCHDOG_ABORT])


def test_checkpoint_points_and_integrity_counter(tmp_path):
    """checkpoint.save / checkpoint.restore fire as the reference's
    points, and a corrupt step counts one integrity failure."""
    from test_torch_train import tiny_trainer
    mgr = checkpoints.CheckpointManager(str(tmp_path / 'ck'))
    _, _, state = tiny_trainer()
    faults.install_plan({'rules': [
        {'point': 'checkpoint.save', 'action': 'raise', 'exc': 'OSError',
         'message': 'disk gone', 'at': [1]},
        {'point': 'checkpoint.restore', 'action': 'raise',
         'exc': 'OSError', 'message': 'store unreadable', 'at': [1]}]})
    with pytest.raises(OSError, match='disk gone'):
        mgr.save(1, state, force=True)
    assert mgr.save(1, state, force=True) and mgr.save(2, state, force=True)
    with pytest.raises(OSError, match='store unreadable'):
        mgr.restore(state)
    assert faults.stats()['checkpoint.save'] == {'hits': 3, 'fired': 1}
    failures = catalog.counter(
        'skypilot_checkpoint_integrity_failures_total')
    before = failures.value
    path = tmp_path / 'ck' / '2' / checkpoints.STATE_FILE
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    mgr.restore(state)
    assert mgr.last_restored_step == 1
    assert failures.value == before + 1
