"""Replica manager: real local serve_lm processes + engine scraping
(port of skypilot_tpu/serve/replica_plane/replica_manager.py; it spawns
the port's `serve_lm`, or the port's stub replica).

Each replica is one `serve_lm` HTTP server process on its own port
(spawned by an injectable factory, so tests substitute stub replicas
or in-process handles). A scrape pass reads every live replica's
`/readyz` and JSON `/stats` into its `ReplicaView` — queue depth,
prefill backlog tokens, shed counter, prefix-cache hits — which the
fleet controller feeds to the EngineMetricsAutoscaler and the LB
policy's load map.

Termination ALWAYS goes through the drain contract (`drain()`):
  1. the view is marked DRAINING (the caller removes it from the
     routing set before calling — see FleetController.drain_replica);
  2. SIGTERM — the replica's own drain (inference/http_server.py)
     flips its /readyz to 503 and finishes in-flight requests;
  3. the manager waits for the process to exit on its own (bounded
     by `drain_grace_s`); only on timeout does it SIGKILL.
Never kill-then-reroute: a killed replica resets every in-flight
stream; a drained one finishes them.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import os
import signal as signal_lib
import subprocess
import sys
import threading
import time
import uuid as uuid_lib
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.serve.replica_plane import http_client
from skypilot_tpu_torch.serve.replica_plane.journal import (
    FleetJournal, ReplicaRecord, max_journaled_id)
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
from skypilot_tpu_torch.utils import net, ux_utils

#: States a replica can occupy in the local plane (subset of the
#: serve-state enum: there is no PROVISIONING — process spawn is
#: instant — and no PREEMPTED).
_LIVE_STATES = (ReplicaStatus.STARTING, ReplicaStatus.READY,
                ReplicaStatus.NOT_READY)


#: A replica's port, below the ephemeral range so that it is still free
#: when the replica binds it seconds later (`utils/net.py`; the
#: reference binds port 0, whose number any outgoing connection may
#: take in between). The reference's name, kept for parity.
free_port = net.free_port


#: Env var carrying a replica's instance UUID into its process; the
#: replica echoes it in `GET /stats` (`instance_uuid`), which is how
#: adoption proves a pid/port still belongs to the journaled replica
#: rather than to whatever reused them after a crash.
INSTANCE_UUID_ENV = 'STPU_REPLICA_INSTANCE_UUID'


def pid_alive(pid: Optional[int]) -> bool:
    """Is `pid` a live (non-zombie) process? Zombies matter: an
    adopted replica that exited before we could wait() on it must
    read as dead, or the drain path would wait a full grace window
    on a corpse."""
    if pid is None or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # alive, owned by someone else
    try:
        with open(f'/proc/{pid}/stat', 'r', encoding='utf-8') as f:
            # Field 3 (after the parenthesized comm) is the state.
            return f.read().rsplit(')', 1)[-1].split()[0] != 'Z'
    except (OSError, IndexError):
        return True  # no /proc (non-Linux): kill(0) said alive


class AdoptedProcess:
    """Popen-shaped handle over a process we did NOT spawn (a
    verified adoption candidate from the journal). `poll()` can only
    report liveness, never the real exit code — the original parent
    (the dead controller) owned wait(); we report 0 once the pid is
    gone, which is correct for every decision this plane makes
    (drain completion, crash detection runs through /stats)."""

    def __init__(self, pid: int,
                 probe: Callable[[Optional[int]], bool] = pid_alive,
                 signal_fn: Callable[[int, int], None] = os.kill
                 ) -> None:
        self.pid = pid
        self._probe = probe
        self._signal = signal_fn

    def poll(self) -> Optional[int]:
        return None if self._probe(self.pid) else 0

    def send_signal(self, sig: int) -> None:
        self._signal(self.pid, sig)

    def terminate(self) -> None:
        self.send_signal(signal_lib.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal_lib.SIGKILL)

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'pid {self.pid} did not exit')
            time.sleep(0.05)
        return 0


@dataclasses.dataclass
class ReplicaView:
    """One replica's last-scraped state, shared between the manager,
    the autoscaler feed, and the LB status surface."""
    replica_id: int
    port: int
    endpoint: str                      # '127.0.0.1:<port>'
    state: ReplicaStatus
    spawned_at: float
    proc: Any = None                   # Popen-shaped handle
    instance_uuid: str = ''            # journaled; echoed by /stats
    adopted: bool = False              # reattached after a restart
    ready: bool = False
    engine_healthy: bool = True
    scrape_failures: int = 0           # consecutive
    # Disaggregated pool membership: '' (unified), 'prefill', or
    # 'decode' — assigned at spawn, confirmed by the /stats echo.
    role: str = ''
    # Spot placement: the zone this replica models ('' = on-demand /
    # zoneless) and its hourly price — what /fleet/status needs for
    # the $/hour rollup and what the zone-scoped preemption storm
    # selects its victims by.
    zone: str = ''
    price_per_hour: float = 0.0
    queue_depth: int = 0
    prefill_backlog_tokens: int = 0
    requests_shed_total: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    # Tiered-cache state scraped from /stats `kv_spill` (zero when
    # the replica runs without a spill tier) — the fleet dashboard's
    # cache-residency signal next to the prefix hit rate.
    kv_spill_bytes: int = 0
    kv_spilled_pages: int = 0
    kv_restored_pages: int = 0
    # Multi-LoRA inventory scraped from /stats `adapters` (empty for
    # base-only replicas): which adapters this replica has device-
    # resident right now, and how many artifacts it can serve.
    adapters_loaded: List[str] = dataclasses.field(default_factory=list)
    adapters_inventory: int = 0
    # Live-migration counters scraped from /stats `migration` (empty
    # until the replica migrates or receives a chain) — the fleet
    # rollup in /fleet/status sums these across views.
    migration: Dict[str, Any] = dataclasses.field(default_factory=dict)
    last_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_hits +
                                      self.prefix_misses, 1)

    def to_dict(self) -> Dict[str, Any]:
        return {
            'replica_id': self.replica_id,
            'endpoint': self.endpoint,
            'state': self.state.value,
            'adopted': self.adopted,
            'ready': self.ready,
            'engine_healthy': self.engine_healthy,
            'role': self.role,
            'zone': self.zone,
            'price_per_hour': self.price_per_hour,
            'queue_depth': self.queue_depth,
            'prefill_backlog_tokens': self.prefill_backlog_tokens,
            'requests_shed_total': self.requests_shed_total,
            'prefix_hits': self.prefix_hits,
            'prefix_misses': self.prefix_misses,
            'prefix_hit_rate': round(self.prefix_hit_rate, 4),
            'kv_spill_bytes': self.kv_spill_bytes,
            'kv_spilled_pages': self.kv_spilled_pages,
            'kv_restored_pages': self.kv_restored_pages,
            'adapters_loaded': list(self.adapters_loaded),
            'adapters_inventory': self.adapters_inventory,
        }


def serve_lm_factory(base_cmd: List[str],
                     env: Optional[Dict[str, str]] = None,
                     quiet: bool = True
                     ) -> Callable[[int, int], 'subprocess.Popen']:
    """Factory spawning `serve_lm` subprocesses: `base_cmd` is the
    full command line WITHOUT `--port` (appended per replica).
    `python -m skypilot_tpu_torch.recipes.serve_lm --model ... --cpu` is
    the usual shape (recipes/serve_fleet.py builds it)."""

    def spawn(replica_id: int, port: int,
              instance_uuid: str = '',
              role: str = '',
              zone: str = '') -> 'subprocess.Popen':
        del replica_id
        out = subprocess.DEVNULL if quiet else None
        child_env = dict(env if env is not None else os.environ)
        if instance_uuid:
            child_env[INSTANCE_UUID_ENV] = instance_uuid
        cmd = base_cmd + ['--port', str(port)]
        if role:
            cmd += ['--role', role]
        if zone:
            cmd += ['--zone', zone]
        return subprocess.Popen(
            cmd, env=child_env,
            stdout=out, stderr=subprocess.STDOUT if quiet else None)

    return spawn


def stub_factory(extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None
                 ) -> Callable[..., 'subprocess.Popen']:
    """Factory spawning model-free stub replicas (stub.py) — the
    deterministic fleet for bench smokes."""

    def spawn(replica_id: int, port: int,
              instance_uuid: str = '',
              role: str = '',
              zone: str = '') -> 'subprocess.Popen':
        cmd = [sys.executable, '-m',
               'skypilot_tpu_torch.serve.replica_plane.stub',
               '--port', str(port), '--seed', str(replica_id)]
        if role:
            cmd += ['--role', role]
        if zone:
            cmd += ['--zone', zone]
        cmd += list(extra_args or [])
        child_env = dict(env if env is not None else os.environ)
        if instance_uuid:
            child_env[INSTANCE_UUID_ENV] = instance_uuid
        return subprocess.Popen(cmd, env=child_env)

    return spawn


def _default_http_get(url: str, timeout: float
                      ) -> Tuple[int, Dict[str, Any]]:
    return http_client.get_json(url, timeout)


class ReplicaManager:
    """Owns the replica processes and their scraped views.

    Injectables (all defaulted for production):
      factory(replica_id, port) -> Popen-shaped handle
          (.poll/.send_signal/.terminate/.kill/.wait);
      http_get(url, timeout) -> (status_code, json_dict);
      clock  -> monotonic seconds (virtual in tests);
      on_event(name, view) -> lifecycle hook; tests assert ordering
          of ('spawned','ready','not_ready','draining','sigterm',
          'drained','killed','dead') events — in particular that
          'draining' precedes 'sigterm' for every voluntary
          termination.
    """

    def __init__(self, factory: Callable[..., Any], *,
                 startup_grace_s: float = 180.0,
                 drain_grace_s: float = 30.0,
                 scrape_timeout_s: float = 3.0,
                 max_scrape_failures: int = 3,
                 http_get: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable] = None,
                 state_dir: Optional[str] = None,
                 pid_probe: Callable[[Optional[int]], bool] = pid_alive,
                 signal_pid: Callable[[int, int], None] = os.kill,
                 reattach: Optional[Callable] = None) -> None:
        self._factory = factory
        # Factories that accept `instance_uuid` (all in-repo ones)
        # get the per-replica UUID; bare (rid, port) test lambdas
        # keep working, their replicas just never verify on adopt.
        try:
            params = inspect.signature(factory).parameters
            var_kw = any(p.kind == p.VAR_KEYWORD
                         for p in params.values())
            self._factory_takes_uuid = ('instance_uuid' in params or
                                        var_kw)
            self._factory_takes_role = 'role' in params or var_kw
            self._factory_takes_zone = 'zone' in params or var_kw
        except (TypeError, ValueError):
            self._factory_takes_uuid = False
            self._factory_takes_role = False
            self._factory_takes_zone = False
        self.startup_grace_s = startup_grace_s
        self.drain_grace_s = drain_grace_s
        self.scrape_timeout_s = scrape_timeout_s
        self.max_scrape_failures = max_scrape_failures
        self._http_get = http_get or _default_http_get
        self._clock = clock
        self._on_event = on_event or (lambda name, view: None)
        self._pid_probe = pid_probe
        self._signal_pid = signal_pid
        self._reattach = reattach or (
            lambda rec: AdoptedProcess(rec.pid, probe=pid_probe,
                                       signal_fn=signal_pid))
        self._lock = threading.Lock()
        self._replicas: Dict[int, ReplicaView] = {}
        self._ids = itertools.count(1)
        self._journal: Optional[FleetJournal] = None
        if state_dir is not None:
            self._journal = FleetJournal(
                os.path.join(state_dir, 'fleet.journal'))
        self._gauge = obs_catalog.gauge('skypilot_replica_plane_replicas')
        self._scrape_errors = obs_catalog.counter(
            'skypilot_replica_plane_scrape_errors_total')
        self._adoptions = obs_catalog.counter(
            'skypilot_fleet_adoptions_total')
        self._orphans_reaped = obs_catalog.counter(
            'skypilot_fleet_orphans_reaped_total')

    # -- journal write-through -------------------------------------------
    # (FleetJournal serializes appends under its own lock; taking the
    # manager lock here too would hold it across an fsync.)
    def _journal_spawn(self, view: ReplicaView) -> None:
        if self._journal is None:
            return
        self._journal.append(
            'spawn', **ReplicaRecord(
                replica_id=view.replica_id, port=view.port,
                endpoint=view.endpoint,
                instance_uuid=view.instance_uuid,
                state=view.state.value,
                pid=getattr(view.proc, 'pid', None),
                role=view.role, zone=view.zone,
                price_per_hour=view.price_per_hour).to_fields())

    def _journal_state(self, view: ReplicaView) -> None:
        if self._journal is None:
            return
        self._journal.append(
            'state', replica_id=view.replica_id,
            state=view.state.value)

    def _journal_terminate(self, replica_id: int) -> None:
        if self._journal is None:
            return
        self._journal.append(
            'terminate', replica_id=replica_id)

    # -- lifecycle -------------------------------------------------------
    def spawn(self, role: str = '', zone: str = '',
              price_per_hour: float = 0.0) -> ReplicaView:
        """Spawn a replica; `role` ('' | 'prefill' | 'decode')
        selects its disaggregated pool and is forwarded to factories
        that accept it (serve_lm/stub factories pass --role).
        `zone`/`price_per_hour` label a spot replica with its
        placement (journaled; `zone` is forwarded to factories that
        accept it, so the replica can answer zone-scoped preemption
        storms)."""
        with self._lock:
            rid = next(self._ids)
        port = free_port()
        instance_uuid = uuid_lib.uuid4().hex
        kwargs = {}
        if self._factory_takes_uuid:
            kwargs['instance_uuid'] = instance_uuid
        if role and self._factory_takes_role:
            kwargs['role'] = role
        if zone and self._factory_takes_zone:
            kwargs['zone'] = zone
        proc = self._factory(rid, port, **kwargs)
        view = ReplicaView(replica_id=rid, port=port,
                           endpoint=f'127.0.0.1:{port}',
                           state=ReplicaStatus.STARTING,
                           spawned_at=self._clock(), proc=proc,
                           instance_uuid=instance_uuid, role=role,
                           zone=zone, price_per_hour=price_per_hour)
        with self._lock:
            self._replicas[rid] = view
        self._journal_spawn(view)
        self._on_event('spawned', view)
        return view

    # -- adoption (controller restart) -----------------------------------
    def _verify_candidate(self, rec: ReplicaRecord) -> bool:
        """Is the journaled process still OUR replica? Two proofs,
        both required: the journaled pid is a live process, and the
        journaled port's `/stats` echoes the journaled instance
        UUID. The UUID check is what defeats pid/port reuse — a
        recycled pid or a stranger's server on the old port fails
        it, and we must never route to (or signal) a process we
        cannot prove is ours."""
        if not rec.instance_uuid or not self._pid_probe(rec.pid):
            return False
        try:
            code, stats = self._http_get(
                f'http://{rec.endpoint}/stats', self.scrape_timeout_s)
        except Exception as e:  # pylint: disable=broad-except
            ux_utils.log(f'adopt: replica {rec.replica_id} at '
                         f'{rec.endpoint} not scrapeable ({e}).')
            return False
        return (code == 200 and
                stats.get('instance_uuid') == rec.instance_uuid)

    def adopt(self, block_drains: bool = False) -> Dict[str, Any]:
        """Crash recovery: replay the journal of the previous
        controller generation and reattach what survived it.

        Per journaled live record:
          - VERIFIED (pid alive + /stats echoes the instance UUID)
            and not mid-drain: reattach as a live STARTING view —
            the next scrape pass re-earns READY and the controller
            pushes it back into the LB ring (same endpoint string,
            so consistent-hash affinity keys land exactly where
            their KV pages still live);
          - VERIFIED but journaled DRAINING: the crash interrupted a
            scale-down — resume the drain (SIGTERM -> wait), never
            readmit to routing;
          - UNVERIFIABLE (dead pid, unreachable port, UUID mismatch
            from pid/port reuse): an orphan. If the journaled pid is
            still a live process we ask it to drain with SIGTERM —
            never SIGKILL: a reused pid belongs to someone else, and
            SIGTERM is the only signal an innocent process gets to
            decline — then drop the record.

        Returns {'adopted': [...], 'resumed_drains': [...],
        'orphans': [...]} (replica ids). `block_drains` makes the
        resumed drains synchronous (tests); by default they run in
        daemon threads so a restart is not gated on a full drain
        grace window."""
        if self._journal is None:
            return {'adopted': [], 'resumed_drains': [], 'orphans': []}
        records = self._journal.replay()
        highest = max_journaled_id(self._journal.path)
        if highest:
            with self._lock:
                self._ids = itertools.count(highest + 1)
        adopted: List[int] = []
        resumed: List[int] = []
        orphans: List[int] = []
        for rid in sorted(records):
            rec = records[rid]
            if self._verify_candidate(rec):
                view = ReplicaView(
                    replica_id=rid, port=rec.port,
                    endpoint=rec.endpoint,
                    state=(ReplicaStatus.DRAINING
                           if rec.state == ReplicaStatus.DRAINING.value
                           else ReplicaStatus.STARTING),
                    spawned_at=self._clock(),
                    proc=self._reattach(rec),
                    instance_uuid=rec.instance_uuid, adopted=True,
                    role=rec.role, zone=rec.zone,
                    price_per_hour=rec.price_per_hour)
                with self._lock:
                    self._replicas[rid] = view
                if view.state == ReplicaStatus.DRAINING:
                    ux_utils.log(f'adopt: replica {rid} was '
                                 f'mid-drain; resuming the drain.')
                    self._journal_state(view)
                    self._on_event('adopt_resume_drain', view)
                    resumed.append(rid)
                    if block_drains:
                        self.drain(rid)
                    else:
                        threading.Thread(target=self.drain,
                                         args=(rid,),
                                         daemon=True).start()
                else:
                    ux_utils.log(
                        f'adopt: replica {rid} verified alive at '
                        f'{rec.endpoint} (pid {rec.pid}); '
                        f'reattached.')
                    self._adoptions.inc()
                    self._journal_spawn(view)
                    self._on_event('adopted', view)
                    adopted.append(rid)
                continue
            # Orphan: stale or unverifiable. Politely ask a
            # still-live pid to drain; never SIGKILL (the pid may
            # have been reused by an innocent process that is free
            # to ignore SIGTERM — SIGKILL would not be).
            if self._pid_probe(rec.pid):
                ux_utils.error(
                    f'adopt: replica {rid} (pid {rec.pid}, '
                    f'{rec.endpoint}) is unverifiable; sending '
                    f'SIGTERM and dropping it.')
                try:
                    self._signal_pid(rec.pid, signal_lib.SIGTERM)
                except OSError as e:
                    ux_utils.log(f'adopt: SIGTERM to orphan pid '
                                 f'{rec.pid} failed ({e}).')
            else:
                ux_utils.log(f'adopt: replica {rid} (pid {rec.pid}) '
                             f'is gone; dropping its record.')
            self._orphans_reaped.inc()
            self._journal_terminate(rid)
            orphans.append(rid)
        self._update_gauges()
        return {'adopted': adopted, 'resumed_drains': resumed,
                'orphans': orphans}

    def views(self) -> List[ReplicaView]:
        with self._lock:
            return list(self._replicas.values())

    def view(self, replica_id: int) -> Optional[ReplicaView]:
        with self._lock:
            return self._replicas.get(replica_id)

    def ready_endpoints(self,
                        role: Optional[str] = None) -> List[str]:
        """READY endpoints, optionally filtered by pool. `role=None`
        returns every ready replica (the unified-fleet behavior);
        'decode' additionally matches role-less replicas so a mixed
        fleet keeps its unified members serving decode traffic."""
        with self._lock:
            views = [v for v in self._replicas.values()
                     if v.state == ReplicaStatus.READY and v.ready]
        if role is None:
            return [v.endpoint for v in views]
        if role == 'decode':
            return [v.endpoint for v in views
                    if v.role in ('decode', '')]
        return [v.endpoint for v in views if v.role == role]

    def mark_draining(self, replica_id: int) -> None:
        """Step 1 of the drain contract: the replica leaves the
        routing set (the caller pushes the shrunken ready set to the
        LB policy before SIGTERM is sent)."""
        view = self.view(replica_id)
        if view is None or view.state not in _LIVE_STATES:
            return
        view.state = ReplicaStatus.DRAINING
        view.ready = False
        self._journal_state(view)
        self._on_event('draining', view)

    def drain(self, replica_id: int) -> None:
        """Steps 2-3: SIGTERM, then wait for the replica's own drain
        to finish (process exits 0 by itself); SIGKILL only past the
        grace window. Blocking — callers wanting async run it in a
        thread (FleetController does)."""
        view = self.view(replica_id)
        if view is None or view.proc is None:
            return
        if view.state != ReplicaStatus.DRAINING:
            self.mark_draining(replica_id)
        try:
            view.proc.send_signal(signal_lib.SIGTERM)
        except (OSError, ValueError) as e:
            ux_utils.log(f'replica {replica_id}: SIGTERM failed '
                         f'({e}); process likely already gone.')
        self._on_event('sigterm', view)
        deadline = self._clock() + self.drain_grace_s
        while self._clock() < deadline:
            if view.proc.poll() is not None:
                view.state = ReplicaStatus.SHUTDOWN
                self._journal_state(view)
                self._on_event('drained', view)
                return
            time.sleep(0.05)
        ux_utils.error(f'replica {replica_id}: drain grace '
                       f'({self.drain_grace_s}s) expired; killing.')
        try:
            view.proc.kill()
        except OSError as e:
            ux_utils.log(f'replica {replica_id}: kill failed ({e}).')
        view.state = ReplicaStatus.SHUTDOWN
        self._journal_state(view)
        self._on_event('killed', view)

    def fail(self, replica_id: int) -> None:
        """Involuntary teardown of a replica already observed dead
        (process exited, engine scheduler died): make sure the
        process is gone and mark FAILED so the controller replaces
        it. This is the ONE path that skips the drain — there is
        nothing left to drain."""
        view = self.view(replica_id)
        if view is None:
            return
        if view.proc is not None and view.proc.poll() is None:
            try:
                view.proc.kill()
            except OSError as e:
                ux_utils.log(f'replica {replica_id}: kill failed '
                             f'({e}).')
        view.state = ReplicaStatus.FAILED
        view.ready = False
        self._journal_state(view)
        self._on_event('dead', view)

    def remove(self, replica_id: int) -> None:
        """Forget a terminal replica's view (keeps `views()` bounded
        in long-running fleets)."""
        with self._lock:
            view = self._replicas.get(replica_id)
            if view is not None and view.state.is_terminal():
                del self._replicas[replica_id]
            else:
                return
        self._journal_terminate(replica_id)

    def shutdown(self) -> None:
        """Drain every live replica, in parallel."""
        live = [v for v in self.views() if v.state in _LIVE_STATES or
                v.state == ReplicaStatus.DRAINING]
        for view in live:
            self.mark_draining(view.replica_id)
        threads = [threading.Thread(target=self.drain,
                                    args=(v.replica_id,), daemon=True)
                   for v in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.drain_grace_s + 5.0)

    # -- scraping --------------------------------------------------------
    def scrape_once(self) -> None:
        """One pass over live replicas: process liveness, /readyz,
        /stats. HTTP happens outside the manager lock (a hung replica
        must not block spawns)."""
        for view in self.views():
            if view.state not in _LIVE_STATES:
                continue
            if view.proc is not None and view.proc.poll() is not None:
                # Exited without being asked: crashed or killed.
                ux_utils.error(
                    f'replica {view.replica_id} process exited '
                    f'(rc={view.proc.poll()}); marking FAILED.')
                view.state = ReplicaStatus.FAILED
                view.ready = False
                self._journal_state(view)
                self._on_event('dead', view)
                continue
            self._scrape_replica(view)
        self._update_gauges()

    def _scrape_replica(self, view: ReplicaView) -> None:
        base = f'http://{view.endpoint}'
        try:
            code, _body = self._http_get(f'{base}/readyz',
                                         self.scrape_timeout_s)
            ready = code == 200
            _code, stats = self._http_get(f'{base}/stats',
                                          self.scrape_timeout_s)
        except Exception as e:  # pylint: disable=broad-except
            view.scrape_failures += 1
            self._scrape_errors.inc()
            age = self._clock() - view.spawned_at
            if view.state == ReplicaStatus.STARTING:
                if age > self.startup_grace_s:
                    ux_utils.error(
                        f'replica {view.replica_id} not scrapeable '
                        f'within {self.startup_grace_s}s ({e}); '
                        f'failing it.')
                    self.fail(view.replica_id)
                return
            if view.scrape_failures >= self.max_scrape_failures:
                if view.ready or view.state == ReplicaStatus.READY:
                    ux_utils.log(
                        f'replica {view.replica_id}: '
                        f'{view.scrape_failures} consecutive scrape '
                        f'failures ({e}); marking NOT_READY.')
                transitioned = view.state != ReplicaStatus.NOT_READY
                view.ready = False
                view.state = ReplicaStatus.NOT_READY
                if transitioned:
                    self._journal_state(view)
                self._on_event('not_ready', view)
            return
        view.scrape_failures = 0
        view.ready = ready
        view.last_stats = stats
        view.queue_depth = int(stats.get('queued', 0) or 0)
        view.prefill_backlog_tokens = int(
            stats.get('prefill_backlog_tokens', 0) or 0)
        view.requests_shed_total = int(
            stats.get('requests_shed', 0) or 0)
        view.engine_healthy = bool(stats.get('healthy', True))
        # The replica's own role echo wins over the spawn-time label
        # (an adopted replica's journaled role may predate a config
        # change; the process knows what it is actually running).
        view.role = str(stats.get('role', view.role) or view.role)
        prefix = stats.get('prefix_cache') or {}
        view.prefix_hits = int(prefix.get('hits', 0) or 0)
        view.prefix_misses = int(prefix.get('misses', 0) or 0)
        spill = stats.get('kv_spill') or {}
        view.kv_spill_bytes = int(spill.get('bytes', 0) or 0)
        view.kv_spilled_pages = int(spill.get('spilled_pages', 0)
                                    or 0)
        view.kv_restored_pages = int(spill.get('restored_pages', 0)
                                     or 0)
        adapters = stats.get('adapters') or {}
        view.adapters_loaded = list(adapters.get('loaded') or [])
        view.adapters_inventory = len(adapters.get('inventory') or [])
        view.migration = dict(stats.get('migration') or {})
        if ready and view.state in (ReplicaStatus.STARTING,
                                    ReplicaStatus.NOT_READY):
            view.state = ReplicaStatus.READY
            self._journal_state(view)
            self._on_event('ready', view)
        elif not ready and view.state == ReplicaStatus.READY:
            view.state = ReplicaStatus.NOT_READY
            self._journal_state(view)
            self._on_event('not_ready', view)

    def _update_gauges(self) -> None:
        counts: Dict[str, int] = {}
        for view in self.views():
            counts[view.state.value] = counts.get(view.state.value,
                                                  0) + 1
        for status in ReplicaStatus:
            self._gauge.labels(state=status.value).set(
                counts.get(status.value, 0))
