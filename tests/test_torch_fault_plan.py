"""The port's fault plans and the engine's two-tier error containment
(skypilot_tpu_torch/robustness/faults.py, models/batching.py) against
the JAX package, CPU:

  - the point catalog and the derived points equal the reference's;
    every plan of the reference's tests/unit_tests/test_fault_injection.py,
    the committed examples/fault_plans/*.json and chip_smoke.py's plan
    fire in the same order over the same point calls (outcomes, raised
    types and messages, delays, stats and resolved windows, on one
    virtual clock); the plans the reference refuses are refused with
    its messages;
  - one injected engine.decode_step (or a delayed engine.device_get)
    changes no token, pipelined or not, and records one soft_error;
    an injected engine.prefill_chunk fails only its own request;
  - three decode poisons in a row escalate in the port as in the
    reference engine (the port of the reference's
    test_decode_poison_three_strikes_escalate_in_flight_dump): soft
    errors with strikes 1, 2, 3, one reset, the batch's futures failed
    with the injected error, engine_restarts 1 and a snapshot file; the
    next request then gives a fresh engine's tokens on the same pool
    storage; an error raised between a round's dispatch and its commit
    resets at once (the pool may be half-written).

Numeric comparisons: token ids are compared exactly (f32 llama-tiny).
"""
import glob
import json
from pathlib import Path

import pytest

from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.robustness import faults as ref_faults
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.robustness import faults

from test_torch_decode_modes import _models
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(num_slots=2, max_total_len=64, prefill_chunk=16)


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


# -- the plan machinery -------------------------------------------------------
def test_catalog_and_derived_points_are_the_references():
    assert faults.KNOWN_POINTS == ref_faults.KNOWN_POINTS
    assert faults._DERIVED_POINTS == ref_faults._DERIVED_POINTS  # pylint: disable=protected-access


#: The plans of the reference's test_fault_injection.py, the smoke
#: phase's plan, and seeded windows.
PLANS = {
    'every_nth': {'rules': [
        {'point': 'engine.decode_step', 'action': 'raise',
         'exc': 'RuntimeError', 'message': 'boom',
         'after': 2, 'every_nth': 3, 'times': 2}]},
    'at': {'rules': [{'point': 'http.handler', 'action': 'drop',
                      'at': [3, 7]}]},
    'prob': {'seed': 123, 'rules': [
        {'point': 'jobs.monitor_probe', 'action': 'drop', 'prob': 0.5}]},
    'json_exc': {'rules': [{'point': 'checkpoint.save', 'action': 'raise',
                            'exc': 'OSError', 'message': 'disk gone'}]},
    'dotted_exc': {'rules': [
        {'point': 'jobs.launch', 'action': 'raise',
         'exc': 'skypilot_tpu_torch.errors.DeadlineExceededError',
         'times': 1},
        {'point': 'jobs.launch', 'action': 'raise', 'times': 1}]},
    'delay': {'rules': [{'point': 'engine.device_get', 'action': 'delay',
                         'delay_s': 0.03}]},
    'scoped': {'rules': [{'point': 'jobs.monitor_probe', 'action': 'drop',
                          'scope': {'zone': 'us-east5-b'}, 'after': 1}]},
    'multi_scope': {'rules': [
        {'point': 'jobs.monitor_probe', 'action': 'drop',
         'scope': {'zone': 'z1', 'job': '7'}}]},
    'window': {'rules': [
        {'point': 'jobs.launch', 'action': 'raise', 'exc': 'RuntimeError',
         'start_s': 10.0, 'duration_s': 5.0}]},
    'preempt_storm': {'seed': 11, 'rules': [
        {'point': 'jobs.preempt_storm', 'scope': {'zone': 'us-east5-b'},
         'start_range': [20.0, 40.0], 'duration_s': 30.0}]},
    'chip_smoke': {'seed': 0, 'rules': [
        {'point': 'engine.decode_step', 'at': [5]},
        {'point': 'engine.device_get', 'action': 'delay', 'delay_s': 0.02,
         'at': [9]},
        {'point': 'adapters.load', 'at': [1]}]},
    'seeded_windows': {'seed': 7, 'rules': [
        {'point': 'engine.decode_step', 'action': 'delay', 'delay_s': 0.5,
         'prob': 0.3, 'start_range': [2.0, 6.0], 'duration_s': 4.0},
        {'point': 'kv.handoff', 'action': 'drop', 'every_nth': 2,
         'start_s': 1.0, 'duration_s': 20.0},
        {'point': 'serve.preempt_notice', 'action': 'drop',
         'scope': {'zone': 'us-east5-b'}, 'start_range': [5.0, 9.0],
         'duration_s': 3.0}]},
}
for _path in sorted((ROOT / 'examples' / 'fault_plans').glob('*.json')):
    PLANS[_path.stem] = str(_path)

#: Point calls the plans are fired over: (name, context).
CALLS = [(name, ctx)
         for name in sorted(faults.KNOWN_POINTS)
         for ctx in ({}, {'zone': 'us-east5-b', 'job': '1'},
                     {'zone': 'us-west4-a', 'job': '7'},
                     {'zone': 'z1', 'job': '7'}, {'resume': '0'},
                     {'adapter': 'tenant-a'})]


def _fire(module, plan_spec, sleeps):
    """Install the plan on a virtual clock and fire every call of CALLS
    at 0.5 s steps for 40 s, then 5 s steps to 160 s: (per-call outcomes,
    stats, resolved windows)."""
    clock = {'t': 0.0}
    plan = module.install_plan(plan_spec, clock=lambda: clock['t'])
    out = []
    for step in range(104):
        clock['t'] = step * 0.5 if step < 80 else 40.0 + (step - 80) * 5.0
        for name, ctx in CALLS:
            n = len(sleeps)
            try:
                got = module.point(name, **ctx)
                got = 'drop' if got is module.DROP else got
            except Exception as e:  # pylint: disable=broad-except
                got = f'raise {type(e).__name__}: {e}'
            out.append((step, name, tuple(sorted(ctx.items())), got,
                        tuple(sleeps[n:])))
    windows = {name: plan.windows(name) for name in module.KNOWN_POINTS}
    return out, module.stats(), windows


@pytest.mark.parametrize('name', sorted(PLANS))
def test_plans_fire_as_the_reference(name, monkeypatch):
    import time
    sleeps = []
    monkeypatch.setattr(time, 'sleep', sleeps.append)
    spec = PLANS[name]
    if name == 'dotted_exc':
        ref_spec = json.loads(json.dumps(spec).replace(
            'skypilot_tpu_torch.errors', 'skypilot_tpu.robustness.errors'))
    else:
        ref_spec = spec
    got = _fire(faults, spec, sleeps)
    want = _fire(ref_faults, ref_spec, sleeps)
    assert got == want
    assert any(o[3] is not None or o[4] for o in got[0])   # it fired


@pytest.mark.parametrize('plan', [
    {'rules': [{'point': 'engine.nope'}]},
    {'rules': [{'point': 'engine.decode_step', 'action': 'explode'}]},
    {'rules': []},
    {'rules': [{'point': 'jobs.monitor_probe', 'scope': {'zone': 1}}]},
    {'rules': [{'point': 'jobs.launch', 'start_s': 1.0}]},
    {'rules': [{'point': 'jobs.preempt_storm', 'scope': {'zone': 'z'}}]},
    {'rules': [{'point': 'jobs.launch', 'exc': 'NotAnException'}]},
    '{"rules": [',
])
def test_refusals_are_the_references(plan):
    with pytest.raises(ValueError) as ref_err:
        ref_faults.install_plan(plan)
    with pytest.raises(ValueError) as err:
        faults.install_plan(plan)
    assert str(err.value) == str(ref_err.value)
    assert faults.get_plan() is None


# -- the engine's containment ------------------------------------------------
PROMPTS = ([5, 9, 2, 17, 5, 9, 2, 17, 5, 9, 2, 40, 41],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8])
MAX_NEW = (9, 12)


@pytest.fixture(scope='module')
def tiny():
    """(jax model, params, port model, the port's fault-free tokens)."""
    model, params, port = _models('bf16')
    eng = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        clean = _submit_all(eng)
    finally:
        eng.stop()
    return model, params, port, clean


def _submit_all(eng, prompts=PROMPTS, max_new=MAX_NEW):
    futs = [eng.submit(list(p), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    return [f.result(timeout=120) for f in futs]


def _kinds(eng):
    return [e['kind'] for e in eng.flight.events()]


@pytest.mark.parametrize('pipelined', [True, False])
@pytest.mark.parametrize('rule', [
    {'point': 'engine.decode_step', 'at': [5]},
    {'point': 'engine.device_get', 'action': 'delay', 'delay_s': 0.01,
     'at': [3, 9]},
])
def test_soft_error_changes_no_token(tiny, rule, pipelined):
    _, _, port, clean = tiny
    eng = pt_batching.ContinuousBatchingEngine(
        port, pipeline_decode=pipelined, **ENGINE_KW)
    try:
        faults.install_plan({'seed': 0, 'rules': [rule]})
        assert _submit_all(eng) == clean
        faults.clear()
        events = eng.flight.events()
        softs = [e for e in events if e['kind'] == 'soft_error']
        raised = rule.get('action', 'raise') == 'raise'
        assert [e['strikes'] for e in softs] == ([1] if raised else [])
        assert 'reset' not in _kinds(eng)
        assert 'round_commit' in _kinds(eng)
        assert eng.engine_restarts == 0
        assert eng.tokens_committed == sum(MAX_NEW)
    finally:
        faults.clear()
        eng.stop()


def test_prefill_chunk_fault_fails_only_its_request(tiny):
    _, _, port, clean = tiny
    eng = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        faults.install_plan({'rules': [
            {'point': 'engine.prefill_chunk', 'action': 'raise',
             'exc': 'RuntimeError', 'message': 'poison chunk', 'at': [1]}]})
        futs = [eng.submit(list(p), max_new_tokens=n)
                for p, n in zip(PROMPTS, MAX_NEW)]
        with pytest.raises(RuntimeError, match='poison chunk'):
            futs[0].result(timeout=120)
        assert futs[1].result(timeout=120) == clean[1]
        assert eng.engine_restarts == 0 and eng.healthy()
    finally:
        faults.clear()
        eng.stop()


def _three_strikes(eng, flight_dir, monkeypatch):
    """The reference test's body, run on either engine: a clean request,
    then three decode poisons. Returns (the doomed error, flight events,
    snapshot body)."""
    monkeypatch.setenv('STPU_FLIGHT_DIR', str(flight_dir))
    eng.submit([5, 6, 7], max_new_tokens=4).result(timeout=120)
    kinds = [e['kind'] for e in eng.flight.events()]
    assert 'admit' in kinds and 'round_commit' in kinds
    module = faults if isinstance(eng, pt_batching.ContinuousBatchingEngine) \
        else ref_faults
    module.install_plan({'rules': [
        {'point': 'engine.decode_step', 'action': 'raise',
         'exc': 'RuntimeError', 'message': 'poison step', 'times': 3}]})
    doomed = eng.submit([1, 2, 3, 4], max_new_tokens=8)
    with pytest.raises(Exception) as err:
        doomed.result(timeout=120)
    module.clear()
    files = glob.glob(str(flight_dir / 'stpu-flight-*reset*.json'))
    assert len(files) == 1, files
    body = json.loads(Path(files[0]).read_text(encoding='utf-8'))
    return err.value, eng.flight.events(), body


def _escalation(events):
    softs = [e for e in events if e['kind'] == 'soft_error']
    resets = [e for e in events if e['kind'] == 'reset']
    return ([(e['strikes'], e['error'], bool(e['slots'])) for e in softs],
            [(e['strikes'], sorted(e['slots']), e['restarts'])
             for e in resets])


def test_three_strikes_escalate_as_the_reference(tiny, tmp_path,
                                                 monkeypatch):
    model, params, port, _ = tiny
    ref = jax_batching.ContinuousBatchingEngine(model, params, num_slots=2,
                                                max_total_len=64)
    eng = pt_batching.ContinuousBatchingEngine(port, num_slots=2,
                                               max_total_len=64)
    pool_ptr = eng.cache.layers[0]['k_pages'].data_ptr()
    try:
        ref_err, ref_events, ref_body = _three_strikes(
            ref, tmp_path / 'ref', monkeypatch)
        err, events, body = _three_strikes(eng, tmp_path / 'port',
                                           monkeypatch)
        assert (type(err), str(err)) == (type(ref_err), str(ref_err)) == \
            (RuntimeError, 'poison step')
        assert _escalation(events) == _escalation(ref_events)
        assert _escalation(events)[0] == [(1, 'RuntimeError', True),
                                          (2, 'RuntimeError', True),
                                          (3, 'RuntimeError', True)]
        assert eng.engine_restarts == ref.engine_restarts == 1
        assert body['reason'] == ref_body['reason'] == 'reset'
        assert set(body) == set(ref_body)
        assert any(e['kind'] == 'soft_error' for e in body['events'])
        # Crash-only: both keep serving; the port's next answer is a
        # fresh engine's, on the same pool storage.
        assert eng.healthy() and ref.healthy()
        after = eng.submit(list(PROMPTS[1]),
                           max_new_tokens=MAX_NEW[1]).result(timeout=120)
        assert ref.submit(list(PROMPTS[1]), max_new_tokens=MAX_NEW[1]
                          ).result(timeout=120) == after
        assert eng.cache.layers[0]['k_pages'].data_ptr() == pool_ptr
    finally:
        ref.stop()
        eng.stop()
    fresh = pt_batching.ContinuousBatchingEngine(port, num_slots=2,
                                                 max_total_len=64)
    try:
        assert fresh.submit(list(PROMPTS[1]), max_new_tokens=MAX_NEW[1]
                            ).result(timeout=120) == after
    finally:
        fresh.stop()


def test_error_inside_a_round_resets_at_once(tiny, tmp_path, monkeypatch):
    """An exception between a round's dispatch and its commit may have
    left the pool half-written: the first strike resets."""
    _, _, port, clean = tiny
    monkeypatch.setenv('STPU_FLIGHT_DIR', str(tmp_path))
    eng = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    real = eng._rounds[0].dispatch  # pylint: disable=protected-access
    calls = {'n': 0}

    def flaky(**kw):
        calls['n'] += 1
        if calls['n'] == 4:
            raise RuntimeError('device fault mid-round')
        return real(**kw)

    eng._rounds[0].dispatch = flaky  # pylint: disable=protected-access
    try:
        futs = [eng.submit(list(p), max_new_tokens=n)
                for p, n in zip(PROMPTS, MAX_NEW)]
        for f in futs:
            with pytest.raises(RuntimeError, match='mid-round'):
                f.result(timeout=120)
        _softs, resets = _escalation(eng.flight.events())
        assert [r[0] for r in resets] == [1]
        assert eng.engine_restarts == 1
        assert _submit_all(eng) == clean
    finally:
        eng.stop()
