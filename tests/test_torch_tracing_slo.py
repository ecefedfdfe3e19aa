"""The port's tracing, SLO accounting and flight recorder
(skypilot_tpu_torch/observability/{tracing,slo,flight}.py) against the
JAX package's, CPU:

  - tracing: the header round trip and the malformed headers; a seeded
    `configure` draws the same sampling decisions, trace ids and span
    ids in the same order; span events have the reference's shape and
    parent links; `merge_traces` gives the same timeline on the same
    bodies; the store is LRU-bounded at the same size;
  - SLO: `parse_slo` accepts and refuses the same specs with the same
    messages; burn rates (every dimension, both windows) and
    `snapshot()` are equal on one seeded record stream under a fixed
    virtual clock, window edges and clock jumps included;
  - flight: ring wraparound, the dump's shape and the snapshot file
    equal the reference's;
  - replicas: one request with a made-up trace header through a port
    replica records replica.request, engine.queue_wait, engine.admit,
    engine.prefill_chunk and engine.decode_round spans linked to their
    parents, served at /debug/trace/<id> (404 with `known` otherwise),
    and /debug/flight has the reference's shape; a port prefill replica
    and a port decode replica in one process, fed a header made by the
    reference's tracing, record one trace id, and the reference's
    `merge_traces` merges their bodies.

Numeric comparisons: burn rates, budgets and snapshots are compared
with ==, the same float arithmetic on both sides.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from skypilot_tpu.observability import flight as ref_flight
from skypilot_tpu.observability import slo as ref_slo
from skypilot_tpu.observability import tracing as ref_tracing
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.observability import flight
from skypilot_tpu_torch.observability import slo
from skypilot_tpu_torch.observability import tracing

from test_torch_kv_transfer import PROMPT, build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _clean_tracing():
    tracing.reset()
    ref_tracing.reset()
    yield
    tracing.reset()
    ref_tracing.reset()


# -- tracing -----------------------------------------------------------------
@pytest.mark.parametrize('value', [
    '00ff00ff00ff00ff:abcd1234:1', None, '', 'garbage', 'a:b',
    'a:b:c:d', 'tid:sid:0', ':sid:1', 'tid:sid:x', 'tid::3'])
def test_header_parse_as_the_reference(value):
    got, want = tracing.parse_header(value), ref_tracing.parse_header(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert tracing.format_header(got) == ref_tracing.format_header(want)
    assert tracing.HEADER == ref_tracing.HEADER


def _draw(module, n=64):
    """Sampling decisions, trace ids and span ids of a seeded run."""
    module.configure(sample=0.5, seed=1234, process='t')
    out = []
    for _ in range(n):
        ctx = module.new_ctx()
        if ctx is None:
            out.append(None)
            continue
        with module.span('s', ctx) as sp:
            out.append((ctx.trace_id, sp.ctx.span_id))
    return out


def test_seeded_sampling_gives_the_references_ids():
    got, want = _draw(tracing), _draw(ref_tracing)
    assert got == want
    assert any(g is None for g in got) and any(g for g in got)
    assert tracing.trace_ids() == ref_tracing.trace_ids()


def _span_tree(module):
    module.configure(sample=1.0, seed=5, process='replica')
    root_ctx = module.parse_header('00ff00ff00ff00ff:wire0001:1')
    with module.span('replica.request', root_ctx, path='/generate') as root:
        with module.span('kv.export', root.ctx) as sp:
            sp.add(bytes=7)
        module.record_span('engine.decode_round', root.ctx, 0.002,
                           slot=1, pos=9, batch=2)
        try:
            with module.span('kv.post', root.ctx, peer='h:1'):
                raise RuntimeError('peer gone')
        except RuntimeError:
            pass
    body = module.get_trace('00ff00ff00ff00ff')
    return [(e['name'], e['cat'], e['ph'], e['pid'], sorted(e),
             {k: v for k, v in e['args'].items()})
            for e in body['traceEvents']]


def test_span_events_have_the_references_shape_and_links():
    got, want = _span_tree(tracing), _span_tree(ref_tracing)
    assert got == want
    spans = {g[5]['span_id']: g for g in got}
    root = next(g for g in got if g[0] == 'replica.request')
    assert root[5]['parent_id'] == 'wire0001'
    for g in got:
        if g is not root:
            assert g[5]['parent_id'] == root[5]['span_id'] in spans
    assert next(g for g in got if g[0] == 'kv.post')[5]['error'] == \
        'RuntimeError'


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_merge_traces_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    bodies = []
    for _ in range(4):
        events = []
        for _ in range(int(rng.integers(0, 12))):
            sid = f's{int(rng.integers(0, 10))}'
            events.append({'name': f'n{int(rng.integers(0, 3))}',
                           'ts': float(rng.integers(0, 5)), 'ph': 'X',
                           'args': {'span_id': sid}})
        bodies.append({'traceEvents': events})
    bodies.append(None)
    assert tracing.merge_traces(bodies) == ref_tracing.merge_traces(bodies)


def test_trace_store_is_bounded_as_the_reference():
    assert (tracing.MAX_TRACES, tracing.MAX_SPANS_PER_TRACE) == \
        (ref_tracing.MAX_TRACES, ref_tracing.MAX_SPANS_PER_TRACE)
    ids = []
    for module in (tracing, ref_tracing):
        module.configure(sample=1.0, seed=0)
        first = module.new_ctx()
        module.span('s', first).end()
        for _ in range(module.MAX_TRACES):
            module.span('s', module.new_ctx()).end()
        assert first.trace_id not in module.trace_ids()
        ids.append(module.trace_ids())
    assert ids[0] == ids[1] and len(ids[0]) == tracing.MAX_TRACES


# -- SLO ---------------------------------------------------------------------
@pytest.mark.parametrize('spec', [
    ' p99_ttft_ms=500, error_rate=0.01 ',
    'p99_ttft_ms=5000,p99_itl_ms=500,error_rate=0.05',
    'shed_rate=0.5,,p99_itl_ms=1e2', '', 'p99_ttft_ms', 'nope=1',
    'p99_ttft_ms=x', 'p99_ttft_ms=-1', 'error_rate=2', 'shed_rate=1',
    'ttft_p99_ms=100', ','])
def test_parse_slo_as_the_reference(spec):
    try:
        want = ref_slo.parse_slo(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            slo.parse_slo(spec)
        assert str(err.value) == str(e)
        return
    assert slo.parse_slo(spec) == want
    assert slo.DIMENSIONS == ref_slo.DIMENSIONS
    assert slo.DEFAULT_WINDOWS == ref_slo.DEFAULT_WINDOWS


def _slo_stream(module, targets, seed):
    """Burn rates and snapshots of one seeded record stream on a virtual
    clock that steps, lands on window edges and jumps both ways."""
    clock = {'t': 10_000.0}
    tr = module.SloTracker(targets, bucket_s=5.0,
                           clock=lambda: clock['t'], publish=False)
    rng = np.random.default_rng(seed)
    out = []
    for step in range(400):
        if step == 300:
            clock['t'] += 7 * 24 * 3600.0      # a long idle gap
        elif step == 350:
            clock['t'] = 3.0                   # a clock restart
        else:
            clock['t'] += float(rng.choice([0.0, 1.0, 5.0, 55.0, 60.0]))
        kind = rng.random()
        if kind < 0.1:
            tr.record_request(shed=True)
        elif kind < 0.2:
            tr.record_request(error=True)
        elif kind < 0.7:
            tr.record_request(ttft_ms=float(rng.lognormal(5.0, 1.0)))
        else:
            tr.record_itl(float(rng.lognormal(3.0, 1.0)))
        if step % 7 == 0:
            out.append([tr.burn_rate(dim, w) for dim in sorted(targets)
                        for w in module.DEFAULT_WINDOWS])
        if step % 50 == 0:
            out.append(tr.snapshot())
    out.append(tr.snapshot())
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_burn_rates_and_snapshots_as_the_reference(seed):
    targets = {'p99_ttft_ms': 200.0, 'p99_itl_ms': 40.0,
               'error_rate': 0.05, 'shed_rate': 0.1}
    got = _slo_stream(slo, targets, seed)
    want = _slo_stream(ref_slo, targets, seed)
    assert got == want
    assert any(v > 1.0 for row in got if isinstance(row, list)
               for v in row)   # some window burned past budget


def test_evaluate_as_the_reference():
    targets = {'p99_ttft_ms': 500.0, 'error_rate': 0.01}
    for observed in ({'p99_ttft_ms': 250.0, 'error_rate': 0.02},
                     {'p99_ttft_ms': 250.0}, {}):
        assert slo.evaluate(targets, observed) == \
            ref_slo.evaluate(targets, observed)


# -- flight ------------------------------------------------------------------
def _flight_run(module, tmp_path, monkeypatch):
    monkeypatch.setenv('STPU_FLIGHT_DIR', str(tmp_path))
    fr = module.FlightRecorder(capacity=8, name='t')
    for i in range(20):
        fr.record('tick', i=i, slot=i % 3)
    fr.record('bare')
    dump = fr.dump()
    path = fr.snapshot('reset')
    with open(path, encoding='utf-8') as f:
        body = json.load(f)
    strip = lambda evs: [{k: v for k, v in e.items() if k != 'ts'}
                         for e in evs]
    return ({k: v for k, v in dump.items() if k != 'events'},
            strip(dump['events']), os.path.basename(path),
            {k: v for k, v in body.items() if k != 'events'},
            strip(body['events']))


def test_flight_ring_and_snapshot_as_the_reference(tmp_path, monkeypatch):
    got = _flight_run(flight, tmp_path / 'port', monkeypatch)
    want = _flight_run(ref_flight, tmp_path / 'ref', monkeypatch)
    assert got == want
    assert got[0]['dropped'] == 13
    assert [e['seq'] for e in got[1]] == list(range(13, 21))
    assert flight.DEFAULT_CAPACITY == ref_flight.DEFAULT_CAPACITY
    with pytest.raises(ValueError):
        flight.FlightRecorder(capacity=0)


# -- replicas ----------------------------------------------------------------
def _serving(rt):
    server = make_server(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope='module')
def port_model():
    return build('bf16', total_pages=40)[2]


def _runtime(port_model, **kw):
    eng = pt_batching.ContinuousBatchingEngine(port_model, num_slots=2,
                                               max_total_len=96,
                                               prefill_chunk=8)
    return InferenceRuntime(engine=eng, model_name='llama-tiny',
                            request_timeout=120.0, **kw)


def _linked(events, wire_parent):
    """Every span's parent is the wire parent or a span of the trace."""
    ids = {e['args']['span_id'] for e in events}
    return all(e['args']['parent_id'] in ids | {wire_parent}
               for e in events)


def test_replica_records_the_engine_spans(port_model):
    rt = _runtime(port_model)
    server, port = _serving(rt)
    tid, wire = '0123456789abcdef', 'feedf00d'
    max_new = 12
    try:
        # Sampling off: a request without the header records nothing.
        _post(port, '/generate', {'tokens': [PROMPT[:9]],
                                  'max_new_tokens': 2})
        assert tracing.trace_ids() == []
        # As `--trace-sample 1.0` configures it (round spans need it on,
        # as in the reference); the header's trace is adopted.
        tracing.configure(sample=1.0, seed=0, process='replica')
        out = _post(port, '/generate',
                    {'tokens': [PROMPT], 'max_new_tokens': max_new},
                    headers={tracing.HEADER: f'{tid}:{wire}:1'})
        assert len(out['tokens'][0]) == len(PROMPT) + max_new
        assert tracing.trace_ids() == [tid]
        events = _get(port, f'/debug/trace/{tid}')['traceEvents']
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, '/debug/trace/deadbeef')
        assert err.value.code == 404
        assert json.loads(err.value.read())['known'] == [tid]
        flight_body = _get(port, '/debug/flight')
    finally:
        server.shutdown()
        rt.stop()
    names = [e['name'] for e in events]
    for name in ('replica.request', 'engine.queue_wait', 'engine.admit'):
        assert names.count(name) == 1, name
    # The prompt's uncached suffix prefills in 8-token chunks.
    admit = next(e for e in events if e['name'] == 'engine.admit')
    chunks = [e['args']['n'] for e in events
              if e['name'] == 'engine.prefill_chunk']
    assert admit['args']['cached_tokens'] + sum(chunks) == len(PROMPT)
    assert len(chunks) == -(-(len(PROMPT) -
                              admit['args']['cached_tokens']) // 8)
    assert names.count('engine.decode_round') >= max_new - 1
    assert all(e['args']['trace_id'] == tid for e in events)
    assert _linked(events, wire)
    root = next(e for e in events if e['name'] == 'replica.request')
    assert root['args']['parent_id'] == wire and root['pid'] == 'replica'
    assert all(e['args']['parent_id'] == root['args']['span_id']
               for e in events if e['name'].startswith('engine.'))
    assert set(flight_body) == {'instance_uuid', 'pid', 'role', 'engines'}
    (dump,) = flight_body['engines']
    assert set(dump) == {'name', 'capacity', 'recorded', 'dropped',
                         'events'}
    kinds = {e['kind'] for e in dump['events']}
    assert {'admit', 'chunk_dispatch', 'round_commit'} <= kinds


def test_one_trace_across_prefill_and_decode_replicas(port_model):
    dec = _runtime(port_model, role='decode')
    dec_server, dec_port = _serving(dec)
    pre = _runtime(port_model, role='prefill',
                   decode_peers=[f'127.0.0.1:{dec_port}'])
    pre_server, pre_port = _serving(pre)
    wire = ref_tracing.Ctx('00ff00ff00ff00ff', 'abcd1234')
    tracing.configure(sample=1.0, seed=0)
    try:
        out = _post(pre_port, '/generate',
                    {'tokens': [PROMPT], 'max_new_tokens': 6},
                    headers={ref_tracing.HEADER:
                             ref_tracing.format_header(wire)})
        assert len(out['tokens'][0]) == len(PROMPT) + 6
        assert _get(pre_port, '/stats')['handoff']['handoffs'] == 1
        bodies = [_get(p, f'/debug/trace/{wire.trace_id}')
                  for p in (pre_port, dec_port)]
    finally:
        for server, rt in ((pre_server, pre), (dec_server, dec)):
            server.shutdown()
            rt.stop()
    assert tracing.trace_ids() == [wire.trace_id]
    merged = ref_tracing.merge_traces(bodies)['traceEvents']
    # One process holds both replicas: one store, so the merge dedups.
    assert len(merged) == len(bodies[0]['traceEvents'])
    assert all(e['args']['trace_id'] == wire.trace_id for e in merged)
    assert [e['ts'] for e in merged] == sorted(e['ts'] for e in merged)
    names = {e['name'] for e in merged}
    assert {'replica.request', 'kv.export', 'kv.post', 'kv.import',
            'engine.admit', 'engine.decode_round'} <= names
    roots = [e for e in merged if e['name'] == 'replica.request']
    assert sorted(e['pid'] for e in roots) == ['decode', 'prefill']
    pre_root = next(e for e in roots if e['pid'] == 'prefill')
    dec_root = next(e for e in roots if e['pid'] == 'decode')
    assert pre_root['args']['parent_id'] == wire.span_id
    post = next(e for e in merged if e['name'] == 'kv.post')
    # The decode replica's root adopts the forwarded header: its parent
    # is the prefill replica's request span.
    assert dec_root['args']['parent_id'] == pre_root['args']['span_id']
    assert post['args']['parent_id'] == pre_root['args']['span_id']
    assert _linked(merged, wire.span_id)
