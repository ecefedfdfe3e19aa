"""Fleet controller: scraped engine signals -> autoscaler -> replica
manager, with every scale-down going through the drain contract (port
of skypilot_tpu/serve/replica_plane/fleet.py).

One `tick()`:
  1. scrape every replica (/readyz + /stats into ReplicaViews);
  2. cull replicas whose process or engine scheduler died (FAILED;
     the only non-drain teardown — nothing left to drain);
  3. push the ready set + load map into the LB policy (a draining or
     dead replica stops receiving traffic HERE, before any signal is
     sent to it);
  4. feed engine signals to the autoscaler and evaluate;
  5. SCALE_UP -> spawn; SCALE_DOWN -> drain-before-kill the
     least-loaded victims in a background thread.

Deterministic by injection: the manager's clock/http_get and the
autoscaler's clock are injectable, so unit tests drive ticks with a
virtual clock and stub scrapes — no sleeps.
"""
from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Set

from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.robustness import faults
from skypilot_tpu_torch.serve import autoscalers
from skypilot_tpu_torch.serve.replica_plane import http_client
from skypilot_tpu_torch.serve.replica_plane.replica_manager import (
    ReplicaManager, ReplicaView)
from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
from skypilot_tpu_torch.utils import ux_utils

#: Consecutive tick failures before the controller declares itself
#: degraded (error log + `skypilot_fleet_controller_degraded` gauge)
#: — the same 3-strike fuse the engine scheduler uses: one failure
#: is noise, three in a row is a condition.
_TICK_FAILURE_STRIKES = 3


class Backoff:
    """Exponential backoff (the reference's `common_utils.Backoff`,
    copied for the peer pushes: the same schedule for the same seeded
    `rng`).

    With `jitter=True`, uses DECORRELATED jitter (sleep_n =
    min(cap, U(initial, 3 * sleep_{n-1}))): retriers that failed
    together spread out instead of re-colliding every multiplier
    period."""

    def __init__(self, initial: float = 5.0, max_backoff: float = 60.0,
                 multiplier: float = 1.6, jitter: bool = False,
                 rng: Optional[random.Random] = None):
        self._initial = initial
        self._max = max_backoff
        self._mult = multiplier
        self._current = initial
        self._jitter = jitter
        self._rng = rng if rng is not None else random.Random()

    def current_backoff(self) -> float:
        if self._jitter:
            cur = min(self._max,
                      self._rng.uniform(self._initial,
                                        self._current * 3.0))
            self._current = cur
            return cur
        cur = self._current
        self._current = min(self._current * self._mult, self._max)
        return cur


def _default_http_post(url: str, body: dict,
                       timeout: float = 3.0) -> int:
    return http_client.post_json(url, body, timeout)


class FleetController:

    # The control loop is single-threaded by design: run()/tick()/
    # safe_tick()/wait_ready() all execute on the one control-loop
    # thread (the serve_fleet entrypoint's main loop), so controller
    # state needs no locks. Drain worker threads only call
    # manager.drain; they never write controller state.

    def __init__(self, manager: ReplicaManager,
                 policy, autoscaler: 'autoscalers.Autoscaler', *,
                 interval_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 drain_in_thread: bool = True,
                 prefill_autoscaler:
                 Optional['autoscalers.Autoscaler'] = None,
                 prefill_pool=None,
                 http_post: Optional[Callable] = None,
                 rebalance_skew: float = 0.0,
                 rebalance_ticks: int = 3,
                 rebalance_sessions: int = 2) -> None:
        self.manager = manager
        self.policy = policy
        self.autoscaler = autoscaler
        # Disaggregated mode (prefill_autoscaler set): the fleet is
        # TWO pools. `policy` routes the decode pool (prefix affinity
        # keys point at the replicas holding the pages);
        # `prefill_pool` (lb.PrefillPool) receives the prefill-role
        # ready set; the prefill autoscaler runs on prefill backlog
        # tokens while the decode autoscaler keeps its queue/shed
        # signals. The controller also pushes the live decode set to
        # every prefill replica (POST /kv/peers) so handoffs target
        # replicas that exist.
        self.prefill_autoscaler = prefill_autoscaler
        self.prefill_pool = prefill_pool
        self.disagg = prefill_autoscaler is not None
        self._http_post = http_post or _default_http_post
        self._pushed_peers: dict = {}   # endpoint -> peer set sent
        # Failed peer pushes retry on a per-endpoint decorrelated
        # backoff (seeded from the endpoint string, so schedules are
        # reproducible), not every tick.
        self._peer_backoff: Dict[str, Backoff] = {}
        self._peer_retry_at: Dict[str, float] = {}
        # Migrated-in affinity keys already pinned per endpoint (the
        # replica's /stats list is a bounded ring; pinning only new
        # keys avoids churning the policy's pin LRU every tick).
        self._pinned_keys: Dict[str, Set[str]] = {}
        # Hot-spot rebalancing: when one replica's engine load stays
        # above `rebalance_skew` x the pool median for
        # `rebalance_ticks` consecutive ticks, ask it to migrate up
        # to `rebalance_sessions` of its deepest sessions to the
        # coldest replica. skew <= 0 disables.
        self.rebalance_skew = rebalance_skew
        self.rebalance_ticks = rebalance_ticks
        self.rebalance_sessions = rebalance_sessions
        self._rebalance_hot = ''
        self._rebalance_streak = 0
        self.interval_s = interval_s
        self._clock = clock if clock is not None else time.time
        # Tests flip this off to make drains synchronous (ordering
        # assertions without joins).
        self._drain_in_thread = drain_in_thread
        self._drain_threads: List[threading.Thread] = []
        self._shutdown = threading.Event()
        self.consecutive_tick_failures = 0
        self._tick_errors = obs_catalog.counter(
            'skypilot_fleet_tick_errors_total')
        self._degraded = obs_catalog.gauge(
            'skypilot_fleet_controller_degraded')
        self._degraded.set(0)

    # -- scaling actions -------------------------------------------------
    def _push_routing(self) -> None:
        """Ready set + load map into the policy. The load map is the
        affinity policy's saturation/fallback signal: engine-reported
        prefill backlog tokens plus queue depth (token-dominated on
        purpose — a 4k-token backlog is heavier than 4 queued short
        requests). Disaggregated fleets split the ready set: the
        routing policy sees the DECODE pool (affinity keys must point
        at the pool holding the pages), the LB's PrefillPool gets the
        prefill-role set, and every prefill replica learns the live
        decode set via POST /kv/peers."""
        ready = self.manager.ready_endpoints(
            'decode' if self.disagg else None)
        self.policy.set_ready_replicas(ready)
        if hasattr(self.policy, 'set_replica_load'):
            self.policy.set_replica_load({
                v.endpoint:
                    v.prefill_backlog_tokens + v.queue_depth
                for v in self.manager.views()
                if v.endpoint in ready})
        self._sync_session_pins()
        # Every serving replica learns the rest of its pool (minus
        # itself) so evacuations — drain, preemption, rebalance —
        # have affinity-chosen targets; prefill replicas additionally
        # learn the full decode set for KV handoffs.
        pushes = {endpoint: sorted(set(ready) - {endpoint})
                  for endpoint in ready}
        if self.disagg:
            prefill_ready = self.manager.ready_endpoints('prefill')
            if self.prefill_pool is not None:
                self.prefill_pool.set_ready_replicas(prefill_ready)
            want = sorted(ready)
            for endpoint in prefill_ready:
                pushes[endpoint] = want
        self._push_decode_peers(pushes)

    def _push_decode_peers(self,
                           pushes: Dict[str, List[str]]) -> None:
        """Tell each replica where its decode peers are (only when
        its view changed — the push is a no-op per-tick otherwise).
        A failed push is retried on that endpoint's decorrelated
        backoff schedule (a down replica must not eat one connect
        timeout per tick forever); the replica keeps its last set
        and falls back to local serving if every peer in it died."""
        now = self._clock()
        for endpoint, want in pushes.items():
            if self._pushed_peers.get(endpoint) == want:
                continue
            if not want and endpoint not in self._pushed_peers:
                continue  # nothing to tell a single-replica pool
            if now < self._peer_retry_at.get(endpoint, 0.0):
                continue  # backing off this endpoint
            try:
                code = self._http_post(
                    f'http://{endpoint}/kv/peers', {'decode': want})
            except Exception as e:  # pylint: disable=broad-except
                self._defer_peer_push(endpoint, now, f'failed ({e})')
                continue
            if code == 200:
                self._pushed_peers[endpoint] = want
                self._peer_backoff.pop(endpoint, None)
                self._peer_retry_at.pop(endpoint, None)
            else:
                self._defer_peer_push(endpoint, now,
                                      f'answered {code}')
        # Forget pushes to replicas that left the fleet.
        for endpoint in list(self._pushed_peers):
            if endpoint not in pushes:
                del self._pushed_peers[endpoint]
        for endpoint in list(self._peer_retry_at):
            if endpoint not in pushes:
                self._peer_retry_at.pop(endpoint, None)
                self._peer_backoff.pop(endpoint, None)

    def _defer_peer_push(self, endpoint: str, now: float,
                         why: str) -> None:
        """Schedule the next /kv/peers attempt for `endpoint` on its
        decorrelated backoff (seeded from the endpoint string so the
        schedule is reproducible across controller restarts)."""
        backoff = self._peer_backoff.get(endpoint)
        if backoff is None:
            backoff = Backoff(
                initial=max(self.interval_s, 0.5), max_backoff=30.0,
                jitter=True,
                rng=random.Random(zlib.crc32(endpoint.encode())))
            self._peer_backoff[endpoint] = backoff
        delay = backoff.current_backoff()
        self._peer_retry_at[endpoint] = now + delay
        ux_utils.log(f'fleet: /kv/peers push to {endpoint} {why}; '
                     f'retrying in {delay:.1f}s.')

    def _sync_session_pins(self) -> None:
        """Scraped migrated-in affinity keys -> policy session pins,
        so follow-up requests for a migrated session land on the
        replica now holding its warm pages instead of the ring's
        stale owner. Only keys not yet pinned are pushed (the
        replica reports a bounded ring of recent keys)."""
        if not hasattr(self.policy, 'pin_key'):
            return
        live = set()
        for view in self.manager.views():
            live.add(view.endpoint)
            keys = (view.migration or {}).get('migrated_in_keys')
            if not keys:
                continue
            seen = self._pinned_keys.setdefault(view.endpoint, set())
            for key in keys:
                if key not in seen:
                    seen.add(key)
                    self.policy.pin_key(key, view.endpoint)
            if len(seen) > 4096:
                # The replica's ring evicted most of these long ago;
                # restart tracking from what it still reports.
                self._pinned_keys[view.endpoint] = set(keys)
        for endpoint in list(self._pinned_keys):
            if endpoint not in live:
                del self._pinned_keys[endpoint]

    def drain_replica(self, view: ReplicaView) -> None:
        """THE drain contract, in order: mark not-ready -> stop
        routing -> evacuate KV chains to survivors -> SIGTERM ->
        wait for the replica's own drain. Never kill-then-reroute."""
        self.manager.mark_draining(view.replica_id)
        self._push_routing()  # routing stops BEFORE any signal
        for scaler in (self.autoscaler, self.prefill_autoscaler):
            if scaler is not None and hasattr(scaler, 'forget'):
                scaler.forget(view.endpoint)
        # Drain-by-migration: ask the victim to ship its active KV
        # chains to affinity-chosen survivors while routing is
        # already off. The POST returns once sessions are detached
        # (the ships ride the in-flight handler threads, which the
        # replica's own drain waits out); a failed POST is fine —
        # SIGTERM triggers the same evacuation replica-side.
        try:
            self._http_post(f'http://{view.endpoint}/kv/evacuate',
                            {'reason': 'drain'})
        except Exception as e:  # pylint: disable=broad-except
            ux_utils.log(f'fleet: /kv/evacuate to draining replica '
                         f'{view.replica_id} failed ({e}); it will '
                         f'evacuate on SIGTERM.')
        if self._drain_in_thread:
            # Prune finished drains first: over a long-running fleet
            # the list would otherwise grow one dead Thread per
            # scale-down, forever.
            self._drain_threads = [t for t in self._drain_threads
                                   if t.is_alive()]
            thread = threading.Thread(
                target=self.manager.drain, args=(view.replica_id,),
                daemon=True)
            thread.start()
            self._drain_threads.append(thread)
        else:
            self.manager.drain(view.replica_id)

    def _maybe_rebalance(self) -> None:
        """Hot-spot rebalancing: sustained per-replica load skew
        (one replica's engine load above `rebalance_skew` x the pool
        median for `rebalance_ticks` consecutive ticks, same replica
        throughout) triggers a bounded evacuation — the hottest
        replica ships up to `rebalance_sessions` of its deepest
        sessions' chains to the coldest replica between requests.
        One detection, one POST: the streak resets after firing so a
        persistent imbalance re-arms rather than machine-gunning."""
        if self.rebalance_skew <= 0:
            return
        ready = set(self.manager.ready_endpoints(
            'decode' if self.disagg else None))
        loads = {v.endpoint: v.prefill_backlog_tokens + v.queue_depth
                 for v in self.manager.views()
                 if v.endpoint in ready}
        if len(loads) < 2:
            self._rebalance_streak = 0
            return
        ordered = sorted(loads.values())
        median = ordered[len(ordered) // 2]
        hottest = max(loads, key=lambda e: loads[e])
        coldest = min(loads, key=lambda e: loads[e])
        if loads[hottest] <= self.rebalance_skew * max(median, 1.0):
            self._rebalance_streak = 0
            return
        if hottest != self._rebalance_hot:
            self._rebalance_hot = hottest
            self._rebalance_streak = 0
        self._rebalance_streak += 1
        if self._rebalance_streak < self.rebalance_ticks:
            return
        self._rebalance_streak = 0
        ux_utils.log(f'fleet: rebalance — {hottest} load '
                     f'{loads[hottest]} > {self.rebalance_skew}x '
                     f'pool median {median}; migrating up to '
                     f'{self.rebalance_sessions} sessions to '
                     f'{coldest}.')
        try:
            self._http_post(
                f'http://{hottest}/kv/evacuate',
                {'reason': 'rebalance', 'target': coldest,
                 'max_sessions': self.rebalance_sessions})
        except Exception as e:  # pylint: disable=broad-except
            ux_utils.log(f'fleet: rebalance /kv/evacuate to '
                         f'{hottest} failed ({e}); will re-detect.')

    def _pick_victims(self, candidates: List[ReplicaView],
                      count: int) -> List[ReplicaView]:
        """Least-valuable first: replicas still starting (nothing
        in-flight, no hot KV pages), then the lowest engine load,
        newest id as the tie-break."""
        ordered = sorted(
            candidates,
            key=lambda v: (v.state != ReplicaStatus.STARTING,
                           v.prefill_backlog_tokens + v.queue_depth,
                           -v.replica_id))
        return ordered[:max(0, count)]

    # -- control loop ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        faults.point('fleet.tick')  # chaos: controller-loop failures
        now = now if now is not None else self._clock()
        self.manager.scrape_once()

        # Cull replicas whose engine scheduler died: /readyz says 503
        # forever, the process idles. Replace, don't drain — the
        # in-flight work is already lost (crash-only containment).
        for view in self.manager.views():
            if view.state in (ReplicaStatus.READY,
                              ReplicaStatus.NOT_READY) and \
                    not view.engine_healthy:
                ux_utils.error(f'replica {view.replica_id}: engine '
                               'dead; replacing.')
                self.manager.fail(view.replica_id)

        self._push_routing()
        self._maybe_rebalance()

        views = self.manager.views()
        if self.disagg:
            # Two pools, two autoscalers: the decode pool scales on
            # queue/shed pressure, the prefill pool on its own
            # signals (prefill backlog tokens). Victims are picked
            # within their pool — a decode scale-down can never
            # drain a prefill replica.
            self._scale_pool(
                [v for v in views if v.role in ('decode', '')],
                self.autoscaler, 'decode', now)
            self._scale_pool(
                [v for v in views if v.role == 'prefill'],
                self.prefill_autoscaler, 'prefill', now)
        else:
            self._scale_pool(views, self.autoscaler, '', now)

        # Forget terminal views so `views()` stays bounded.
        for view in views:
            if view.state.is_terminal():
                self.manager.remove(view.replica_id)

    def _scale_pool(self, views: List[ReplicaView], autoscaler,
                    role: str, now: float) -> None:
        """Feed one pool's scraped signals to its autoscaler and act
        on the decision (spawn carries the pool's role)."""
        ready = [v for v in views
                 if v.state == ReplicaStatus.READY and v.ready]
        launching = [v for v in views
                     if v.state == ReplicaStatus.STARTING]

        if isinstance(autoscaler,
                      autoscalers.EngineMetricsAutoscaler):
            for view in ready:
                autoscaler.observe(
                    view.endpoint,
                    queue_depth=view.queue_depth,
                    prefill_backlog_tokens=view.prefill_backlog_tokens,
                    requests_shed_total=view.requests_shed_total,
                    now=now)
            for view in views:
                if view.state.is_terminal():
                    autoscaler.forget(view.endpoint)

        decision = autoscaler.evaluate(len(ready), len(launching),
                                       now=now)
        op = autoscalers.AutoscalerDecisionOperator
        pool = f' [{role}]' if role else ''
        if decision.operator == op.SCALE_UP:
            want = (decision.target_num_replicas - len(ready) -
                    len(launching))
            for _ in range(max(0, want)):
                view = self.manager.spawn(
                    role=role if self.disagg else '')
                ux_utils.log(f'fleet: scale-up{pool} -> replica '
                             f'{view.replica_id} on :{view.port} '
                             f'(target '
                             f'{decision.target_num_replicas}).')
        elif decision.operator == op.SCALE_DOWN:
            excess = (len(ready) + len(launching) -
                      decision.target_num_replicas)
            for view in self._pick_victims(launching + ready, excess):
                ux_utils.log(f'fleet: scale-down{pool} -> draining '
                             f'replica {view.replica_id} (target '
                             f'{decision.target_num_replicas}).')
                self.drain_replica(view)

    def safe_tick(self) -> bool:
        """One guarded tick for the control loop: failures are
        counted (`skypilot_fleet_tick_errors_total`) and escalated
        after 3 consecutive strikes (error log + the
        controller-degraded gauge) instead of one forever-identical
        log line per failure. A success resets the fuse. Returns
        whether the tick succeeded."""
        try:
            self.tick()
        except Exception as e:  # pylint: disable=broad-except
            self.consecutive_tick_failures += 1
            self._tick_errors.inc()
            if self.consecutive_tick_failures >= \
                    _TICK_FAILURE_STRIKES:
                self._degraded.set(1)
                ux_utils.error(
                    f'fleet: {self.consecutive_tick_failures} '
                    f'consecutive tick failures (latest: {e}); '
                    f'controller DEGRADED — replicas keep serving '
                    f'but scaling/routing updates are stalled.')
            else:
                ux_utils.log(f'fleet tick failed: {e}')
            return False
        if self.consecutive_tick_failures >= _TICK_FAILURE_STRIKES:
            ux_utils.log('fleet: tick recovered; controller no '
                         'longer degraded.')
            self._degraded.set(0)
        self.consecutive_tick_failures = 0
        return True

    def run(self) -> None:
        """Tick until shutdown() (the serve_fleet entrypoint's main
        loop)."""
        while not self._shutdown.is_set():
            self.safe_tick()
            self._shutdown.wait(self.interval_s)

    def wait_ready(self, count: int, timeout_s: float = 300.0,
                   poll_s: float = 0.2) -> bool:
        """Block until `count` replicas are READY (spawn-time helper
        for benches and the entrypoint). Runs on the injected clock
        like every other controller path (virtual-clock tests drive
        it without sleeping)."""
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            self.tick()
            if len(self.manager.ready_endpoints()) >= count:
                return True
            if self._shutdown.wait(poll_s):
                return False
        return False

    def shutdown(self) -> None:
        self._shutdown.set()
        for thread in self._drain_threads:
            thread.join(self.manager.drain_grace_s + 5.0)
        self.manager.shutdown()
