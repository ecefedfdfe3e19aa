"""The port's serving fleet (skypilot_tpu_torch/serve/, recipes/
serve_fleet.py) against the reference's, on the CPU:

  - copies pinned to the reference: every autoscaler decides the same
    on an injected clock and seeded signals; every load-balancing
    policy picks the same replica for the same key sequence and ready
    set (endpoints added and removed, exclusions, loads, pins); a
    journal written by either package replays the same in the other;
    the service spec refuses what the reference refuses; the
    serve_fleet flags, defaults and help agree flag for flag, and
    build_replica_cmd gives the reference's argv with the module
    swapped; adoption decides the same on the same journal;
  - controller parity: the port's FleetController + make_lb_server over
    the port's in-process stubs against the reference's over its
    stubs, the same ticks on the same injected clock and the same
    endpoints: scale-up, drain, a replica death mid-stream and a
    prefill pool give the same scale events at the same ticks, the
    same replica for every request, the same answers, the same
    /fleet/status keys and the same drain order;
  - end to end: `serve_fleet --model llama-tiny --cpu --replicas 2`
    over the port's serve_lm answers through the load balancer as
    each replica answers directly and keeps prefix groups together; a
    stub fleet with --state-dir, SIGKILLed and restarted, adopts its
    replicas; `--spot-decode 1` exits naming ROADMAP A18(b).

Every wait is bounded: HTTP calls, joins and process waits carry a
timeout. Replicas of a fleet get ports outside the ephemeral range, so
no other test's ephemeral bind can take one between choice and bind.
"""
import argparse
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from skypilot_tpu.recipes import serve_fleet as ref_recipe
from skypilot_tpu.serve import autoscalers as ref_autoscalers
from skypilot_tpu.serve import load_balancing_policies as ref_lbp
from skypilot_tpu.serve import serve_state as ref_state
from skypilot_tpu.serve import service_spec as ref_spec
from skypilot_tpu.serve.replica_plane import fleet as ref_fleet
from skypilot_tpu.serve.replica_plane import journal as ref_journal
from skypilot_tpu.serve.replica_plane import lb as ref_lb
from skypilot_tpu.serve.replica_plane import replica_manager as ref_rm
from skypilot_tpu.serve.replica_plane import stub as ref_stub
from skypilot_tpu.utils import common_utils as ref_common
from skypilot_tpu.utils import registry as ref_registry
from skypilot_tpu_torch import errors
from skypilot_tpu_torch.recipes import serve_fleet as pt_recipe
from skypilot_tpu_torch.serve import autoscalers as pt_autoscalers
from skypilot_tpu_torch.serve import load_balancing_policies as pt_lbp
from skypilot_tpu_torch.serve import serve_state as pt_state
from skypilot_tpu_torch.serve import service_spec as pt_spec
from skypilot_tpu_torch.serve.replica_plane import fleet as pt_fleet
from skypilot_tpu_torch.serve.replica_plane import journal as pt_journal
from skypilot_tpu_torch.serve.replica_plane import lb as pt_lb
from skypilot_tpu_torch.serve.replica_plane import replica_manager as pt_rm
from skypilot_tpu_torch.serve.replica_plane import stub as pt_stub
from skypilot_tpu_torch.utils import net
from skypilot_tpu_torch.utils import registry as pt_registry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT = 30

REF = SimpleNamespace(
    name='reference', auto=ref_autoscalers, lbp=ref_lbp, state=ref_state,
    Spec=ref_spec.SkyServiceSpec, fleet=ref_fleet, journal=ref_journal,
    lb=ref_lb, rm=ref_rm, stub=ref_stub)
PORT = SimpleNamespace(
    name='port', auto=pt_autoscalers, lbp=pt_lbp, state=pt_state,
    Spec=pt_spec.SkyServiceSpec, fleet=pt_fleet, journal=pt_journal,
    lb=pt_lb, rm=pt_rm, stub=pt_stub)


class FakeClock:

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def fixed_ports(n):
    """`n` distinct free ports below the ephemeral range (no port-0 bind
    elsewhere can take one before the fleet binds it)."""
    out = []
    while len(out) < n:
        port = net.free_port()
        if port not in out:
            out.append(port)
    return out


def get_json(url, timeout=HTTP_TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def post_json(url, body, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def post_stream(url, body, timeout=HTTP_TIMEOUT):
    """(status, SSE data lines) of a streamed POST; a broken stream
    ends the list early."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    lines = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        try:
            for line in resp:
                if line.startswith(b'data'):
                    lines.append(line.strip())
        except (OSError, ValueError):
            pass
        return resp.status, lines


# ---------------------------------------------------------------------------
# copies pinned to the reference
# ---------------------------------------------------------------------------
def test_registries_and_states_match():
    assert pt_registry.AUTOSCALER_REGISTRY.keys() == \
        ref_registry.AUTOSCALER_REGISTRY.keys()
    assert pt_registry.LB_POLICY_REGISTRY.keys() == \
        ref_registry.LB_POLICY_REGISTRY.keys()
    assert pt_registry.LB_POLICY_REGISTRY.default == \
        ref_registry.LB_POLICY_REGISTRY.default
    assert [s.value for s in pt_state.ReplicaStatus] == \
        [s.value for s in ref_state.ReplicaStatus]
    for s in pt_state.ReplicaStatus:
        r = ref_state.ReplicaStatus(s.value)
        assert (s.is_terminal(), s.is_serving) == \
            (r.is_terminal(), r.is_serving)
    with pytest.raises(ValueError):
        pt_registry.LB_POLICY_REGISTRY.from_str('nope')


SPEC_CASES = [
    dict(),
    dict(min_replicas=2, max_replicas=1),
    dict(readiness_path='healthz'),
    dict(target_qps_per_replica=0),
    dict(target_qps_per_replica={}),
    dict(target_qps_per_replica={'v5e': -1.0}),
    dict(min_replicas=1, max_replicas=3, target_qps_per_replica=2.0),
    dict(min_replicas=2, max_replicas=None),
]


@pytest.mark.parametrize('kw', SPEC_CASES, ids=range(len(SPEC_CASES)))
def test_service_spec_matches(kw):
    try:
        ref = ref_spec.SkyServiceSpec(**kw)
    except Exception as e:  # pylint: disable=broad-except
        with pytest.raises(errors.InvalidTaskYAMLError) as got:
            pt_spec.SkyServiceSpec(**kw)
        assert str(got.value) == str(e)
        return
    port = pt_spec.SkyServiceSpec(**kw)
    assert vars(port) == vars(ref)
    assert port.autoscaling_enabled == ref.autoscaling_enabled


def _spec(side, **kw):
    kw.setdefault('min_replicas', 1)
    kw.setdefault('max_replicas', 5)
    kw.setdefault('upscale_delay_seconds', 10)
    kw.setdefault('downscale_delay_seconds', 20)
    return side.Spec(**kw)


AUTOSCALER_CASES = {
    'base': lambda s, c: s.auto.Autoscaler(_spec(s), c),
    'request_rate': lambda s, c: s.auto.RequestRateAutoscaler(
        _spec(s, target_qps_per_replica=0.5), c),
    'queue_length': lambda s, c: s.auto.QueueLengthAutoscaler(
        _spec(s), clock=c),
    'spot_request_rate': lambda s, c: s.auto.SpotRequestRateAutoscaler(
        _spec(s, target_qps_per_replica=0.5,
              base_ondemand_fallback_replicas=1,
              dynamic_ondemand_fallback=True), c),
    'instance_aware': lambda s, c:
        s.auto.InstanceAwareRequestRateAutoscaler(
            _spec(s, min_replicas=0, target_qps_per_replica={
                'v5e': 0.25, 'v5p': 0.75}), c),
    'engine_metrics': lambda s, c: s.auto.EngineMetricsAutoscaler(
        _spec(s), c, target_queue_per_replica=3.0,
        target_backlog_per_replica=900.0),
}


def _drive_autoscaler(side, name, seed):
    """A seeded run of 300 steps of arrivals, completions, scrapes and
    evaluations on an injected clock; every observable in order."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    scaler = AUTOSCALER_CASES[name](side, clock)
    out = []
    for _ in range(300):
        clock.t += float(rng.choice([0.5, 1.0, 3.0, 7.0]))
        op = int(rng.integers(0, 5))
        if op == 0:
            scaler.collect_request_information(int(rng.integers(0, 40)))
        elif op == 1:
            scaler.request_done(int(rng.integers(0, 10)))
        elif op == 2 and hasattr(scaler, 'observe'):
            replica = f'r{int(rng.integers(0, 4))}'
            scaler.observe(replica,
                           queue_depth=int(rng.integers(0, 12)),
                           prefill_backlog_tokens=int(
                               rng.integers(0, 5000)),
                           requests_shed_total=int(rng.integers(0, 4)))
        elif op == 3 and hasattr(scaler, 'forget'):
            scaler.forget(f'r{int(rng.integers(0, 4))}')
        ready = int(rng.integers(0, 5))
        caps = [float(rng.choice([0.25, 0.75])) for _ in range(ready)]
        d = scaler.evaluate(ready, int(rng.integers(0, 2)),
                            ready_capacities=caps)
        row = [d.operator.value, d.target_num_replicas,
               scaler.target_num_replicas]
        if hasattr(scaler, 'desired_mix'):
            mix = scaler.desired_mix(int(rng.integers(0, 4)))
            row += [mix.spot, mix.ondemand]
        if hasattr(scaler, 'shed_rate'):
            row += [scaler.shed_rate(), scaler.total_queue_depth(),
                    scaler.total_backlog_tokens()]
        if hasattr(scaler, 'current_qps'):
            row.append(scaler.current_qps())
        out.append(row)
    return out


@pytest.mark.parametrize('name', sorted(AUTOSCALER_CASES))
def test_autoscaler_decisions_match(name):
    for seed in (0, 1, 2):
        assert _drive_autoscaler(PORT, name, seed) == \
            _drive_autoscaler(REF, name, seed)


MAKE_SPECS = [
    dict(),
    dict(min_replicas=1, max_replicas=3, target_qps_per_replica=1.0),
    dict(min_replicas=1, max_replicas=3, target_qps_per_replica=1.0,
         autoscaler='queue_length'),
    dict(min_replicas=1, max_replicas=3, autoscaler='engine_metrics'),
    dict(min_replicas=1, max_replicas=3, target_qps_per_replica=1.0,
         base_ondemand_fallback_replicas=1),
    dict(base_ondemand_fallback_replicas=1),
    dict(min_replicas=1, max_replicas=3,
         target_qps_per_replica={'v5e': 1.0}),
    dict(min_replicas=1, max_replicas=3, target_qps_per_replica=1.0,
         autoscaler='nope'),
]


@pytest.mark.parametrize('kw', MAKE_SPECS, ids=range(len(MAKE_SPECS)))
def test_autoscaler_make_matches(kw):
    ref = ref_autoscalers.Autoscaler.make(ref_spec.SkyServiceSpec(**kw))
    port = pt_autoscalers.Autoscaler.make(pt_spec.SkyServiceSpec(**kw))
    assert type(port).__name__ == type(ref).__name__


ENDPOINTS = [f'127.0.0.1:{8000 + i}' for i in range(6)]


def _drive_policy(side, name, seed):
    """A seeded run of 400 operations on a policy: ready-set changes
    (endpoints added and removed), keyed and keyless selections with
    exclusions, completions, loads, weights and pins."""
    rng = np.random.default_rng(seed)
    policy = side.lbp.__dict__[{
        'round_robin': 'RoundRobinPolicy', 'least_load': 'LeastLoadPolicy',
        'instance_aware': 'InstanceAwareLeastLoadPolicy',
        'prefix_affinity': 'PrefixAffinityPolicy'}[name]]()
    if name == 'prefix_affinity':
        policy.saturation_inflight = 4
        policy.saturation_backlog = 3000.0
    keys = [f'{int(k):064x}' for k in rng.integers(0, 2**62, 24)]
    out = []
    ready = list(ENDPOINTS[:3])
    policy.set_ready_replicas(ready)
    for _ in range(400):
        op = int(rng.integers(0, 10))
        if op == 0:
            if rng.random() < 0.5 and len(ready) < len(ENDPOINTS):
                ready.append(next(e for e in ENDPOINTS if e not in ready))
            elif len(ready) > 1:
                ready.pop(int(rng.integers(0, len(ready))))
            policy.set_ready_replicas(list(ready))
        elif op == 1:
            policy.request_done(ENDPOINTS[int(rng.integers(0, 6))])
        elif op == 2 and hasattr(policy, 'set_replica_load'):
            policy.set_replica_load({e: float(rng.integers(0, 5000))
                                     for e in ready})
        elif op == 3 and hasattr(policy, 'pin_key'):
            policy.pin_key(keys[int(rng.integers(0, 24))],
                           ENDPOINTS[int(rng.integers(0, 6))])
        elif op == 4 and hasattr(policy, 'set_replica_weights'):
            policy.set_replica_weights({e: float(rng.integers(1, 9))
                                        for e in ENDPOINTS})
        key = (keys[int(rng.integers(0, 24))] if rng.random() < 0.8
               else None)
        exclude = ({ENDPOINTS[int(rng.integers(0, 6))]}
                   if rng.random() < 0.2 else None)
        row = [policy.select_replica(key=key, exclude=exclude)]
        if hasattr(policy, 'affinity_target'):
            row.append(policy.affinity_target(key))
        out.append(row)
    return out


@pytest.mark.parametrize('name', ['round_robin', 'least_load',
                                  'instance_aware', 'prefix_affinity'])
def test_policy_routes_match(name):
    assert sorted(pt_registry.LB_POLICY_REGISTRY.keys()) == sorted(
        ['round_robin', 'least_load', 'instance_aware', 'prefix_affinity'])
    for seed in (0, 1, 2):
        assert _drive_policy(PORT, name, seed) == \
            _drive_policy(REF, name, seed)


def test_ring_positions_match():
    for data in ['', 'a', '127.0.0.1:8000#3', 'x' * 300]:
        assert pt_lbp._hash64(data) == ref_lbp._hash64(data)  # pylint: disable=protected-access


def _write_journal(side, path, seed):
    """A seeded stream of lifecycle events through `side`'s
    FleetJournal (a compaction in the middle), then a torn tail."""
    rng = np.random.default_rng(seed)
    journal = side.journal.FleetJournal(path, compact_every=17)
    states = ['STARTING', 'READY', 'NOT_READY', 'DRAINING', 'SHUTDOWN',
              'FAILED']
    for i in range(60):
        rid = int(rng.integers(1, 9))
        op = int(rng.integers(0, 3))
        if op == 0:
            rec = side.journal.ReplicaRecord(
                replica_id=rid, port=9000 + rid,
                endpoint=f'127.0.0.1:{9000 + rid}',
                instance_uuid=f'u{rid}-{i}', state='STARTING',
                pid=int(rng.integers(100, 999)),
                role=['', 'prefill', 'decode'][int(rng.integers(0, 3))],
                zone=['', 'z-a'][int(rng.integers(0, 2))],
                price_per_hour=float(rng.integers(0, 3)))
            journal.append('spawn', **rec.to_fields())
        elif op == 1:
            journal.append('state', replica_id=rid,
                           state=states[int(rng.integers(0, 6))])
        else:
            journal.append('terminate', replica_id=rid)
        if i == 30:
            journal.compact()
    journal.close()
    with open(path, 'a', encoding='utf-8') as f:
        f.write('{"event": "state", "replica_id": 1, "sta')


def _replayed(side, path):
    return {rid: rec.to_fields()
            for rid, rec in side.journal.replay_journal(path).items()}


@pytest.mark.parametrize('writer,reader', [(PORT, REF), (REF, PORT)],
                         ids=['port_to_reference', 'reference_to_port'])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / 'fleet.journal')
    _write_journal(writer, path, seed=3)
    got = _replayed(reader, path)
    assert got == _replayed(writer, path)
    assert got  # some records stay live
    assert reader.journal.max_journaled_id(path) == \
        writer.journal.max_journaled_id(path)
    # The reader compacts the writer's file; both still replay it alike.
    reader.journal.FleetJournal(path).compact()
    assert _replayed(writer, path) == got


def _parser_actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.help,
             getattr(a.type, '__name__', a.type), a.choices, a.metavar,
             a.nargs, a.const, type(a).__name__)
            for a in parser._actions]  # pylint: disable=protected-access


class _Captured(Exception):
    pass


def _reference_parser(monkeypatch):
    """The parser the reference's main() builds (it builds it inline):
    main() is stopped at its parse_args call."""
    got = {}

    def capture(self, *a, **kw):
        got['parser'] = self
        raise _Captured()

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(_Captured):
        ref_recipe.main()
    monkeypatch.undo()
    return got['parser']


def test_serve_fleet_flags_match(monkeypatch):
    ref = _parser_actions(_reference_parser(monkeypatch))
    port = _parser_actions(pt_recipe.build_parser())
    assert port == ref
    assert len(port) > 40


REPLICA_ARGVS = [
    [],
    ['--model', 'llama3-8b', '--kv-pool-bytes', '4000000000',
     '--max-total-len', '1024', '--num-slots', '4'],
    ['--cpu', '--hf', '/ckpt', '--ckpt-dir', '/c', '--adapter-dir', '/a',
     '--max-adapters', '3', '--prefill-chunk', '64',
     '--max-queue-requests', '5', '--max-queue-tokens', '700',
     '--kv-dtype', 'int8', '--weight-dtype', 'int8', '--tensor', '2',
     '--stages', '2', '--kv-spill-bytes', '1000', '--kv-cold-dir', '/k',
     '--fault-plan', '{}', '--trace-sample', '0.5', '--trace-seed', '3',
     '--slo', 'p99_ttft_ms=500'],
    ['--trace-sample', '1.0'],
]


@pytest.mark.parametrize('argv', REPLICA_ARGVS,
                         ids=range(len(REPLICA_ARGVS)))
def test_build_replica_cmd_swaps_only_the_module(argv):
    args = pt_recipe.build_parser().parse_args(argv)
    ref = ref_recipe.build_replica_cmd(args)
    port = pt_recipe.build_replica_cmd(args)
    assert ref[:3] == [sys.executable, '-m', 'skypilot_tpu.recipes.serve_lm']
    assert port == ref[:2] + ['skypilot_tpu_torch.recipes.serve_lm'] + \
        ref[3:]
    # Every flag it forwards is one the port's serve_lm takes.
    from skypilot_tpu_torch.recipes import serve_lm
    serve_lm.build_parser().parse_args(port[3:] + ['--port', '0'])


def test_spot_decode_exits_naming_the_roadmap_item(capsys):
    with pytest.raises(SystemExit) as got:
        pt_recipe.main(['--spot-decode', '1', '--stub-replicas'])
    assert got.value.code == 2
    err = capsys.readouterr().err
    assert 'A18(b)' in err and '--spot-decode' in err


def test_spot_accelerator_off_default_exits_naming_the_roadmap_item(capsys):
    with pytest.raises(SystemExit) as got:
        pt_recipe.main(['--spot-accelerator', 'tpu-v6e-8',
                        '--stub-replicas'])
    assert got.value.code == 2
    err = capsys.readouterr().err
    assert 'A18(b)' in err and '--spot-accelerator' in err


def test_free_ports_lie_below_the_ephemeral_range():
    with open('/proc/sys/net/ipv4/ip_local_port_range') as f:
        low = int(f.read().split()[0])
    ports = fixed_ports(20)
    assert all(1024 <= p < low for p in ports)
    assert all(1024 <= net.free_port() < low for _ in range(20))


def test_peer_backoff_schedule_matches():
    for jitter in (False, True):
        ref = ref_common.Backoff(initial=0.5, max_backoff=30.0,
                                 jitter=jitter, rng=random.Random(5))
        port = pt_fleet.Backoff(initial=0.5, max_backoff=30.0,
                                jitter=jitter, rng=random.Random(5))
        assert [port.current_backoff() for _ in range(20)] == \
            [ref.current_backoff() for _ in range(20)]


class FakeProc:

    def __init__(self):
        self.rc = None
        self.signals = []

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        self.rc = 0

    def terminate(self):
        self.send_signal(15)

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def _adopt_run(side, tmp_path):
    """The reference's adoption matrix (verified, UUID mismatch, dead
    pid, port reused, mid-drain) on `side`'s manager."""
    state = tmp_path / side.name
    journal = side.journal.FleetJournal(str(state / 'fleet.journal'))
    rows = [(1, 7101, 'uuid-1', 201, 'READY'),
            (2, 7102, 'uuid-2', 202, 'READY'),
            (3, 7103, 'uuid-3', 203, 'NOT_READY'),
            (4, 7104, 'uuid-4', 204, 'READY'),
            (5, 7105, 'uuid-5', 205, 'DRAINING')]
    for rid, port, uuid, pid, st in rows:
        journal.append('spawn', **side.journal.ReplicaRecord(
            replica_id=rid, port=port, endpoint=f'127.0.0.1:{port}',
            instance_uuid=uuid, state='STARTING', pid=pid).to_fields())
        journal.append('state', replica_id=rid, state=st)
    journal.close()
    stats = {'127.0.0.1:7101': {'instance_uuid': 'uuid-1'},
             '127.0.0.1:7102': {'instance_uuid': 'uuid-OTHER'},
             '127.0.0.1:7104': {'instance_uuid': 'uuid-STRANGER'},
             '127.0.0.1:7105': {'instance_uuid': 'uuid-5'}}

    def http_get(url, timeout):
        host = url.split('//')[1].split('/')[0]
        if host not in stats:
            raise ConnectionError(host)
        return 200, stats[host]

    alive = {201, 202, 205}
    signals, events = [], []
    mgr = side.rm.ReplicaManager(
        lambda rid, port: FakeProc(), http_get=http_get,
        state_dir=str(state), pid_probe=lambda pid: pid in alive,
        signal_pid=lambda pid, sig: signals.append((pid, sig)),
        reattach=lambda rec: FakeProc(),
        on_event=lambda name, view: events.append(
            (name, view.replica_id)))
    summary = mgr.adopt(block_drains=True)
    views = sorted((v.replica_id, v.state.value, v.adopted, v.endpoint)
                   for v in mgr.views())
    live = _replayed(side, str(state / 'fleet.journal'))
    return (summary, signals, events, views, live,
            mgr.spawn().replica_id)


def test_adoption_matches(tmp_path):
    port = _adopt_run(PORT, tmp_path)
    assert port == _adopt_run(REF, tmp_path)
    summary = port[0]
    assert summary == {'adopted': [1], 'resumed_drains': [5],
                       'orphans': [2, 3, 4]}


# ---------------------------------------------------------------------------
# controller parity: the port's controller + LB + stubs vs the reference's
# ---------------------------------------------------------------------------
class Fleet:
    """One side's controller, manager, policy and LB over in-process
    stubs, on fixed replica ports and an injected clock. `log` gathers
    every observable: lifecycle events and scale decisions with their
    tick, the replica id and answer of each request."""

    def __init__(self, side, ports, *, spec_kw, stub_kw=None,
                 per_replica=None, prefill=0, disagg_threshold=0,
                 auto_kw=None):
        self.side = side
        self.clock = FakeClock()
        self.tick_no = 0
        self.log = []
        ports_iter = iter(ports)
        self._saved_free_port = side.rm.free_port
        side.rm.free_port = lambda: next(ports_iter)
        factory = side.stub.in_process_stub_factory(
            per_replica=per_replica or {}, **(stub_kw or {}))
        self.handles = []

        def spawn(*a, **kw):
            self.handles.append(factory(*a, **kw))
            return self.handles[-1]

        self.mgr = side.rm.ReplicaManager(
            spawn,
            drain_grace_s=20.0, clock=self.clock,
            on_event=lambda name, view: self.log.append(
                ('event', self.tick_no, name, view.replica_id)))
        auto_kw = auto_kw or {}
        self.auto = side.auto.EngineMetricsAutoscaler(
            side.Spec(**spec_kw), clock=self.clock, **auto_kw)
        self.prefill_pool = None
        prefill_auto = None
        if prefill:
            prefill_auto = side.auto.EngineMetricsAutoscaler(
                side.Spec(min_replicas=prefill, max_replicas=prefill),
                clock=self.clock, **auto_kw)
            self.prefill_pool = side.lb.PrefillPool()
        self.policy = side.lbp.PrefixAffinityPolicy()
        self.ctl = side.fleet.FleetController(
            self.mgr, self.policy, self.auto, interval_s=0.05,
            clock=self.clock, drain_in_thread=False,
            prefill_autoscaler=prefill_auto,
            prefill_pool=self.prefill_pool)
        self.lb = side.lb.make_lb_server(
            self.policy, 0, policy_name='prefix_affinity',
            manager=self.mgr, disagg_threshold=disagg_threshold,
            prefill_pool=self.prefill_pool)
        self.url = f'http://127.0.0.1:{self.lb.server_address[1]}'
        self._thread = threading.Thread(target=self.lb.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        """Shut the fleet down. Its parallel drains log nothing: their
        order is the threads'."""
        self.log = list(self.log)
        self.mgr._on_event = lambda name, view: None  # pylint: disable=protected-access
        self.side.rm.free_port = self._saved_free_port
        self.ctl.shutdown()
        self.lb.shutdown()
        self.lb.server_close()
        self._thread.join(timeout=HTTP_TIMEOUT)
        # A stub reports its exit code before its listener closes: the
        # other side reuses these ports, so close them here.
        for handle in self.handles:
            handle._thread.join(timeout=HTTP_TIMEOUT)  # pylint: disable=protected-access
            handle.server.server_close()

    def ids(self):
        return {v.endpoint: v.replica_id for v in self.mgr.views()}

    def tick(self, dt=1.0):
        self.clock.t += dt
        self.tick_no += 1
        self.ctl.tick()
        self.log.append(('tick', self.tick_no,
                         sorted((v.replica_id, v.state.value, v.role)
                                for v in self.mgr.views()),
                         self.auto.target_num_replicas))

    def stubs(self):
        return {v.replica_id: v.proc.state for v in self.mgr.views()
                if v.proc is not None}

    def routed(self):
        return dict(self.lb.lb_metrics.snapshot()['routed_per_replica'])

    def request(self, tokens, max_new=4, stream=False):
        """POST /generate through the LB; logs the replica ids the LB
        routed it to and the answer."""
        ids = self.ids()
        before = self.routed()
        body = {'tokens': [tokens], 'max_new_tokens': max_new}
        if stream:
            body['stream'] = True
            code, lines = post_stream(self.url + '/generate', body)
            answer = [l.decode() for l in lines]
        else:
            code, out = post_json(self.url + '/generate', body)
            answer = out['tokens']
        after = self.routed()
        went = sorted(ids.get(e, e) for e in after
                      if after[e] != before.get(e, 0))
        self.log.append(('request', self.tick_no, went, code, answer))
        return went

    def status_keys(self):
        def keys(x):
            if isinstance(x, dict):
                return {k: keys(v) for k, v in sorted(x.items())
                        if k != 'routed_per_replica'}
            if isinstance(x, list):
                return [keys(v) for v in x[:1]]
            return type(x).__name__
        return keys(get_json(self.url + '/fleet/status'))


def _prompt(rng, n, vocab=5000):
    return [int(t) for t in rng.integers(1, vocab, n)]


def _scenario_scale(side, ports):
    """1 replica; engine pressure scales it to 3 after the upscale
    delay; seeded keyed traffic over the three; pressure gone, the
    two least valuable drain one by one after the downscale delay."""
    fleet = Fleet(side, ports, spec_kw=dict(
        min_replicas=1, max_replicas=3, upscale_delay_seconds=2,
        downscale_delay_seconds=3), auto_kw=dict(
            target_queue_per_replica=4.0,
            target_backlog_per_replica=1000.0))
    rng = np.random.default_rng(11)
    try:
        fleet.mgr.spawn()
        fleet.tick()
        for state in fleet.stubs().values():
            state.stats_overrides['prefill_backlog_tokens'] = 2500
        for _ in range(4):
            fleet.tick()
        for state in fleet.stubs().values():
            state.stats_overrides.clear()
        fleet.tick()
        assert len(fleet.mgr.ready_endpoints()) == 3
        groups = [_prompt(rng, 16) for _ in range(4)]
        for _ in range(12):
            g = groups[int(rng.integers(0, 4))]
            fleet.request(g + _prompt(rng, int(rng.integers(1, 20))))
        fleet.request(_prompt(rng, 5))          # keyless: least load
        fleet.log.append(('status', fleet.status_keys()))
        for _ in range(8):
            fleet.tick()
        fleet.request(groups[0] + [1, 2, 3])
    finally:
        fleet.close()
    return fleet.log


def _scenario_death(side, ports):
    """3 replicas; replica 2 dies at its 5th token mid-stream: the
    stream truncates, the next request is retried elsewhere, the
    controller fails and replaces it."""
    fleet = Fleet(side, ports, spec_kw=dict(
        min_replicas=3, max_replicas=3), stub_kw=dict(token_sleep_s=0.002),
        per_replica={2: {'die_after_tokens': 5}})
    rng = np.random.default_rng(12)
    try:
        for _ in range(3):
            fleet.mgr.spawn()
        fleet.tick()
        victim = fleet.mgr.view(2).endpoint
        prompt = None
        for i in range(400):
            cand = [i] * 16 + [7, 8, 9]
            key = fleet.side.lb.affinity.token_affinity_key(cand)
            if fleet.policy.affinity_target(key) == victim:
                prompt = cand
                break
        assert prompt is not None
        went = fleet.request(prompt, max_new=20, stream=True)
        assert went == [2]
        fleet.request(prompt)                   # retried onto a survivor
        for _ in range(3):
            fleet.tick()
        for _ in range(4):
            fleet.request(_prompt(rng, 24))
        fleet.log.append(('status', fleet.status_keys()))
    finally:
        fleet.close()
    return fleet.log


def _scenario_prefill(side, ports):
    """2 decode replicas and a prefill pool of 1: prompts at or past
    the threshold go to the prefill stub, which hands the chain to a
    decode peer the controller pushed; short ones route by affinity."""
    fleet = Fleet(side, ports, spec_kw=dict(
        min_replicas=2, max_replicas=2), prefill=1, disagg_threshold=48)
    rng = np.random.default_rng(13)
    try:
        fleet.mgr.spawn(role='decode')
        fleet.mgr.spawn(role='decode')
        fleet.mgr.spawn(role='prefill')
        fleet.tick()
        fleet.tick()
        for _ in range(8):
            long_prompt = rng.random() < 0.5
            fleet.request(_prompt(rng, 64 if long_prompt else 20))
            fleet.log.append(('imports', sorted(
                (rid, st.kv_imports, st.handoffs)
                for rid, st in fleet.stubs().items())))
        fleet.log.append(('status', fleet.status_keys()))
    finally:
        fleet.close()
    return fleet.log


SCENARIOS = {'scale_up_and_drain': _scenario_scale,
             'death_mid_stream': _scenario_death,
             'prefill_pool': _scenario_prefill}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_controller_matches_the_reference(name):
    ports = fixed_ports(6)
    ref = SCENARIOS[name](REF, ports)
    port = SCENARIOS[name](PORT, ports)
    assert port == ref
    events = [e for e in port if e[0] == 'event']
    assert events
    if name == 'scale_up_and_drain':
        spawned = [e[3] for e in events if e[2] == 'spawned']
        assert spawned == [1, 2, 3]
        # Drain before kill, in order, one victim after the other.
        order = [(e[2], e[3]) for e in events
                 if e[2] in ('draining', 'sigterm', 'drained', 'killed')]
        assert order == [('draining', 3), ('sigterm', 3), ('drained', 3),
                         ('draining', 2), ('sigterm', 2), ('drained', 2)]
    if name == 'death_mid_stream':
        requests = [e for e in port if e[0] == 'request']
        assert requests[0][2] == [2]              # the truncated stream
        assert b'data: [DONE]' not in [l.encode() for l in
                                       requests[0][4]]
        assert len(requests[1][2]) == 2 and requests[1][3] == 200
        assert ('dead' in [e[2] for e in events]
                and [e[3] for e in events if e[2] == 'spawned'][-1] == 4)
    if name == 'prefill_pool':
        last = [e for e in port if e[0] == 'imports'][-1][1]
        assert sum(k for _, k, _ in last) > 0     # handoffs arrived


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    # The replicas' preemption watchers must not poll GCE metadata.
    env['STPU_PREEMPT_METADATA_URL'] = 'http://127.0.0.1:9/'
    env['SKYPILOT_TPU_QUIET'] = '1'
    return env


def _status(url):
    try:
        return get_json(url + '/fleet/status', timeout=5)
    except (OSError, ValueError):
        return None


def _wait_ready(url, n, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = _status(url)
        if status is not None:
            ready = [r for r in status['replicas']
                     if r['state'] == 'READY' and r['ready']]
            if len(ready) >= n:
                return status
        time.sleep(0.2)
    raise AssertionError(f'fleet at {url} not {n} ready in {timeout}s')


def _journal_pids(state_dir):
    pids = set()
    with open(os.path.join(state_dir, 'fleet.journal'), encoding='utf-8') as f:
        for line in f:
            try:
                event = json.loads(line)
            except ValueError:
                continue
            if event.get('event') in ('spawn', 'snapshot') and \
                    event.get('pid'):
                pids.add(int(event['pid']))
    return sorted(pids)


def _stop(proc, pids, timeout=60):
    """SIGTERM the fleet, wait for it and its replicas; SIGKILL and
    fail on anything left."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and \
            any(pt_rm.pid_alive(p) for p in pids):
        time.sleep(0.1)
    left = [p for p in pids if pt_rm.pid_alive(p)]
    for p in left:
        try:
            os.kill(p, signal.SIGKILL)
        except OSError:
            pass
    return left


def test_llama_tiny_fleet_answers_as_its_replicas(tmp_path):
    """Two port serve_lm replicas (llama-tiny, CPU) behind the LB:
    three prefix groups and cold prompts, sent one at a time. Each
    group lands on one replica whose prefix hits cover the shared
    pages; a second, warm pass through the LB gives exactly the tokens
    the serving replica gives when asked directly."""
    lb_port, = fixed_ports(1)
    url = f'http://127.0.0.1:{lb_port}'
    state_dir = str(tmp_path / 'state')
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.recipes.serve_fleet',
           '--model', 'llama-tiny', '--cpu', '--replicas', '2',
           '--lb-port', str(lb_port), '--state-dir', state_dir,
           '--scrape-interval', '0.2', '--max-total-len', '128']
    proc = subprocess.Popen(cmd, env=_env(), cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    pids = []
    try:
        status = _wait_ready(url, 2)
        pids = _journal_pids(state_dir)
        assert len(pids) == 2
        replicas = {r['endpoint'] for r in status['replicas']}
        rng = np.random.default_rng(5)
        prefix_pages = 2
        groups = [_prompt(rng, 16 * prefix_pages, 512) for _ in range(3)]
        prompts = [(g, grp + _prompt(rng, int(rng.integers(3, 30)), 512))
                   for g, grp in enumerate(groups) for _ in range(3)]
        prompts += [(None, _prompt(rng, int(rng.integers(20, 60)), 512))
                    for _ in range(2)]
        served, first = [], []
        for _, p in prompts:
            before = _status(url)['lb']['routed_per_replica']
            code, out = post_json(url + '/generate',
                                  {'tokens': [p], 'max_new_tokens': 6})
            after = _status(url)['lb']['routed_per_replica']
            went = [e for e in after if after[e] != before.get(e, 0)]
            assert code == 200 and len(went) == 1 and went[0] in replicas
            served.append(went[0])
            first.append(out['tokens'][0])
        for g in range(3):
            assert len({s for (gi, _), s in zip(prompts, served)
                        if gi == g}) == 1, f'group {g} split'
        status = _status(url)
        hits = sum(r['prefix_hits'] for r in status['replicas'])
        assert hits >= 3 * 2 * prefix_pages
        for (_, p), s, f in zip(prompts, served, first):
            _, warm = post_json(url + '/generate',
                                {'tokens': [p], 'max_new_tokens': 6})
            _, direct = post_json(f'http://{s}/generate',
                                  {'tokens': [p], 'max_new_tokens': 6})
            assert warm['tokens'][0] == direct['tokens'][0]
            assert len(f) == len(p) + 6 and f[:len(p)] == p
    finally:
        left = _stop(proc, pids)
    assert proc.returncode == 0
    assert not left, f'replicas outlived the fleet: {left}'


def test_stub_fleet_sigkill_restart_adopts(tmp_path):
    """A stub fleet with --state-dir is SIGKILLed; its replicas live
    on, and a restarted fleet with the same state dir adopts them
    (same pids and endpoints, instance UUIDs echoed) and serves."""
    lb_port, = fixed_ports(1)
    url = f'http://127.0.0.1:{lb_port}'
    state_dir = str(tmp_path / 'state')
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.recipes.serve_fleet',
           '--stub-replicas', '--replicas', '2', '--lb-port', str(lb_port),
           '--state-dir', state_dir, '--scrape-interval', '0.2']
    first = subprocess.Popen(cmd, env=_env(), cwd=REPO,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    pids, second = [], None
    try:
        status = _wait_ready(url, 2, timeout=60)
        pids = _journal_pids(state_dir)
        assert len(pids) == 2
        before = sorted(r['endpoint'] for r in status['replicas'])
        uuids = {e: get_json(f'http://{e}/stats')['instance_uuid']
                 for e in before}
        answer = post_json(url + '/generate', {
            'tokens': [list(range(20))], 'max_new_tokens': 3})[1]
        first.kill()
        first.wait(timeout=HTTP_TIMEOUT)
        assert all(pt_rm.pid_alive(p) for p in pids)
        second = subprocess.Popen(cmd, env=_env(), cwd=REPO,
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
        status = _wait_ready(url, 2, timeout=60)
        assert sorted(r['endpoint'] for r in status['replicas']) == before
        assert all(r['adopted'] for r in status['replicas'])
        assert _journal_pids(state_dir) == pids
        for e, u in uuids.items():
            stats = get_json(f'http://{e}/stats')
            assert stats['instance_uuid'] == u and stats['pid'] in pids
        assert post_json(url + '/generate', {
            'tokens': [list(range(20))], 'max_new_tokens': 3})[1] == answer
    finally:
        if first.poll() is None:
            first.kill()
            first.wait(timeout=HTTP_TIMEOUT)
        left = _stop(second, pids) if second is not None else \
            _stop(first, pids)
    assert not left, f'stub replicas outlived the fleet: {left}'
