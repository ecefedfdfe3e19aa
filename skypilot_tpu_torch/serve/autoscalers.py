"""Autoscalers: decide target replica count from load signals (port
of skypilot_tpu/serve/autoscalers.py, decision for decision).

Reference: sky/serve/autoscalers.py (1310 LoC) —
RequestRateAutoscaler (:479) with upscale/downscale hysteresis
(:393), QueueLengthAutoscaler (:1094). Decisions are pure functions
of (spec, signal history, time) so they unit-test without clusters.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.serve import service_spec as spec_lib
from skypilot_tpu_torch.utils.registry import AUTOSCALER_REGISTRY


class AutoscalerDecisionOperator(enum.Enum):
    SCALE_UP = 'scale_up'
    SCALE_DOWN = 'scale_down'
    NO_OP = 'no_op'


@dataclasses.dataclass
class AutoscalerDecision:
    operator: AutoscalerDecisionOperator
    target_num_replicas: int


class Autoscaler:
    """Base: fixed replica count (no autoscaling).

    Every scaler is clock-injectable: pass `clock` (a `time.time`-like
    callable) and/or per-call `now`/`timestamp` values and decisions
    become pure functions of (spec, signal history, time) — unit tests
    and virtual-time simulators never sleep.
    """

    def __init__(self, spec: 'spec_lib.SkyServiceSpec',
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.spec = spec
        self.target_num_replicas = spec.min_replicas
        self._clock = clock if clock is not None else time.time
        self._upscale_candidate_since: Optional[float] = None
        self._downscale_candidate_since: Optional[float] = None

    def _now(self, now: Optional[float]) -> float:
        return now if now is not None else self._clock()

    # -- shared hysteresis + decision (used by every signal scaler) -----
    def _apply_hysteresis(self, desired: int, now: float) -> None:
        """Commit a target move only after it persisted for the
        upscale/downscale delay."""
        if desired > self.target_num_replicas:
            self._downscale_candidate_since = None
            if self._upscale_candidate_since is None:
                self._upscale_candidate_since = now
            if now - self._upscale_candidate_since >= \
                    self.spec.upscale_delay_seconds:
                self.target_num_replicas = desired
                self._upscale_candidate_since = None
        elif desired < self.target_num_replicas:
            self._upscale_candidate_since = None
            if self._downscale_candidate_since is None:
                self._downscale_candidate_since = now
            if now - self._downscale_candidate_since >= \
                    self.spec.downscale_delay_seconds:
                self.target_num_replicas = desired
                self._downscale_candidate_since = None
        else:
            self._upscale_candidate_since = None
            self._downscale_candidate_since = None

    def _decide(self, total: int) -> AutoscalerDecision:
        if total < self.target_num_replicas:
            return AutoscalerDecision(AutoscalerDecisionOperator.SCALE_UP,
                                      self.target_num_replicas)
        if total > self.target_num_replicas:
            return AutoscalerDecision(AutoscalerDecisionOperator.SCALE_DOWN,
                                      self.target_num_replicas)
        return AutoscalerDecision(AutoscalerDecisionOperator.NO_OP, total)

    @classmethod
    def make(cls, spec: 'spec_lib.SkyServiceSpec') -> 'Autoscaler':
        # Spot-fallback fields imply the spot-aware scaler: a YAML with
        # base_ondemand_fallback_replicas but the default autoscaler
        # must not silently ignore its on-demand floor.
        wants_spot_mix = bool(
            getattr(spec, 'base_ondemand_fallback_replicas', 0) or
            getattr(spec, 'dynamic_ondemand_fallback', False))
        # A dict target_qps_per_replica ({accelerator: qps}) selects
        # the instance-aware scaler (mixed v5e/v5p fleets), which also
        # carries the spot floor/backfill mix.
        if isinstance(spec.target_qps_per_replica, dict):
            return InstanceAwareRequestRateAutoscaler(spec)
        # Engine-metrics scaling needs no target_qps (its signals are
        # scraped from the replicas), so it bypasses the
        # autoscaling_enabled gate that requires one.
        if getattr(spec, 'autoscaler', None) == 'engine_metrics' and \
                spec.max_replicas > spec.min_replicas:
            return EngineMetricsAutoscaler(spec)
        if spec.autoscaling_enabled:
            chosen = AUTOSCALER_REGISTRY.get(
                getattr(spec, 'autoscaler', 'request_rate'))
            if chosen is None:
                chosen = RequestRateAutoscaler
            if wants_spot_mix and chosen is RequestRateAutoscaler:
                chosen = SpotRequestRateAutoscaler
            return chosen(spec)
        if wants_spot_mix:
            return SpotRequestRateAutoscaler(spec)
        return Autoscaler(spec)

    def collect_request_information(self, num_requests: int,
                                    timestamp: Optional[float] = None
                                    ) -> None:
        """Called on request *arrival*."""

    def request_done(self, count: int = 1) -> None:
        """Called on request *completion* (queue-based scalers use it)."""

    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        del now, ready_capacities  # fixed target ignores load signals
        total = num_ready + num_launching
        if total < self.target_num_replicas:
            return AutoscalerDecision(AutoscalerDecisionOperator.SCALE_UP,
                                      self.target_num_replicas)
        if total > self.target_num_replicas:
            return AutoscalerDecision(AutoscalerDecisionOperator.SCALE_DOWN,
                                      self.target_num_replicas)
        return AutoscalerDecision(AutoscalerDecisionOperator.NO_OP, total)


@AUTOSCALER_REGISTRY.register(name='request_rate', default=True)
class RequestRateAutoscaler(Autoscaler):
    """Scale on QPS per ready replica, with hysteresis delays.

    Reference: autoscalers.py:479 — target =
    ceil(qps / target_qps_per_replica), clamped to [min, max]; an
    up/down move only commits after the signal has persisted for
    upscale_delay / downscale_delay seconds.
    """

    _QPS_WINDOW_SECONDS = 60.0

    def __init__(self, spec: 'spec_lib.SkyServiceSpec',
                 clock: Optional[Callable[[], float]] = None) -> None:
        super().__init__(spec, clock)
        self._request_timestamps: List[float] = []

    # -- signal -----------------------------------------------------------
    def collect_request_information(self, num_requests: int,
                                    timestamp: Optional[float] = None
                                    ) -> None:
        now = self._now(timestamp)
        self._request_timestamps.extend([now] * num_requests)
        self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self._QPS_WINDOW_SECONDS
        self._request_timestamps = [t for t in self._request_timestamps
                                    if t >= cutoff]

    def current_qps(self, now: Optional[float] = None) -> float:
        now = self._now(now)
        self._trim(now)
        return len(self._request_timestamps) / self._QPS_WINDOW_SECONDS

    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        del ready_capacities  # uniform fleet: every replica equal
        now = self._now(now)
        qps = self.current_qps(now)
        assert self.spec.target_qps_per_replica is not None
        desired = math.ceil(qps / self.spec.target_qps_per_replica)
        desired = max(self.spec.min_replicas,
                      min(self.spec.max_replicas, desired))
        self._apply_hysteresis(desired, now)
        return self._decide(num_ready + num_launching)


@AUTOSCALER_REGISTRY.register(name='queue_length')
class QueueLengthAutoscaler(Autoscaler):
    """Scale on in-flight (queued) requests per ready replica.

    Reference: autoscalers.py:1094 — better signal than QPS for
    long-generation LLM serving where request cost varies wildly.
    """

    def __init__(self, spec: 'spec_lib.SkyServiceSpec',
                 target_queue_per_replica: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        super().__init__(spec, clock)
        self.target_queue_per_replica = (
            target_queue_per_replica if target_queue_per_replica
            is not None else getattr(spec, 'target_queue_per_replica',
                                     4.0))
        self._in_flight = 0

    def collect_request_information(self, num_requests: int,
                                    timestamp: Optional[float] = None
                                    ) -> None:
        del timestamp
        self._in_flight += num_requests

    def request_done(self, count: int = 1) -> None:
        self._in_flight = max(0, self._in_flight - count)

    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        del ready_capacities
        now = self._now(now)
        desired = math.ceil(self._in_flight / self.target_queue_per_replica)
        desired = max(self.spec.min_replicas,
                      min(self.spec.max_replicas, desired))
        self._apply_hysteresis(desired, now)
        return self._decide(num_ready + num_launching)


@dataclasses.dataclass
class ReplicaMix:
    """How many replicas of each procurement class the controller
    should be running right now."""
    spot: int
    ondemand: int


@AUTOSCALER_REGISTRY.register(name='spot_request_rate')
class SpotRequestRateAutoscaler(RequestRateAutoscaler):
    """Request-rate scaling for spot serving with on-demand fallback.

    Reference: sky/serve/autoscalers.py:933 — the target count is met
    with spot replicas; `base_ondemand_fallback_replicas` are always
    on-demand (steady floor while spot churns), and with
    `dynamic_ondemand_fallback` any spot shortfall (preemptions, no
    capacity) is temporarily back-filled with on-demand replicas that
    retire as spot recovers.
    """

    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        # Fixed-count specs (no target_qps) still use the spot mix:
        # fall back to the base fixed-target decision.
        if self.spec.target_qps_per_replica is None:
            return Autoscaler.evaluate(self, num_ready, num_launching)
        return super().evaluate(num_ready, num_launching, now,
                                ready_capacities)

    def desired_mix(self, num_ready_spot: int) -> ReplicaMix:
        target = self.target_num_replicas
        base_od = min(self.spec.base_ondemand_fallback_replicas, target)
        spot_target = target - base_od
        od_target = base_od
        if self.spec.dynamic_ondemand_fallback:
            od_target += max(0, spot_target - num_ready_spot)
        return ReplicaMix(spot=spot_target, ondemand=od_target)


@AUTOSCALER_REGISTRY.register(name='instance_aware')
class InstanceAwareRequestRateAutoscaler(SpotRequestRateAutoscaler):
    """Request-rate scaling over a MIXED fleet: per-accelerator QPS
    capacity, load normalized by what each ready replica can actually
    serve.

    Reference: sky/serve/autoscalers.py:605
    (InstanceAwareRequestRateAutoscaler) — selected when
    `target_qps_per_replica` is a dict {accelerator: qps}, e.g.
    {'tpu-v5e-8': 4, 'tpu-v5p-8': 10} for a v5e+v5p fleet where one
    v5p replica replaces ~2.5 v5e replicas. Subclasses the spot-mix
    scaler, so the on-demand floor + dynamic backfill compose with
    capacity normalization (the reference keeps these as separate
    classes; here mixed fleets get both).

    Scaling rule (matching the reference's):
    - qps >= sum(ready capacities): scale up by
      ceil(overflow / max capacity) above the current count (the
      largest replica class is what launches next).
    - qps < sum: walk ready capacities LARGEST FIRST until they cover
      the qps; that count is the target (retire small replicas first).
    - no ready replicas: min_replicas.
    Hysteresis delays apply as in the base scaler.
    """

    def __init__(self, spec: 'spec_lib.SkyServiceSpec',
                 clock: Optional[Callable[[], float]] = None) -> None:
        super().__init__(spec, clock)
        assert isinstance(spec.target_qps_per_replica, dict), (
            'instance_aware autoscaler needs a {accelerator: qps} dict')
        self.qps_map = {str(k): float(v)
                        for k, v in spec.target_qps_per_replica.items()}

    def capacity_of(self, accelerator: Optional[str]) -> float:
        """QPS capacity of one replica by its accelerator; unknown
        hardware is assumed as capable as the best known class (the
        conservative choice against over-scaling)."""
        if accelerator is not None and accelerator in self.qps_map:
            return self.qps_map[accelerator]
        return max(self.qps_map.values())

    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        now = self._now(now)
        qps = self.current_qps(now)
        max_cap = max(self.qps_map.values())
        # Launching replicas are CREDITED at the largest-class capacity
        # — otherwise every evaluation during a long TPU provision
        # re-counts the same overflow and ratchets desired up to
        # max_replicas before the first launch turns ready.
        caps = sorted(list(ready_capacities or []) +
                      [max_cap] * num_launching, reverse=True)
        total_cap = sum(caps)
        if not caps:
            # Cold start from zero replicas: observed load must still
            # produce a target (min_replicas may be 0).
            desired = max(self.spec.min_replicas,
                          math.ceil(qps / max_cap))
        elif qps >= total_cap:
            overflow = qps - total_cap
            desired = len(caps) + math.ceil(overflow / max_cap)
        elif qps <= 0:
            # Idle: honor min_replicas=0 scale-to-zero like the scalar
            # RequestRateAutoscaler's ceil(0/x) == 0 path.
            desired = 0
        else:
            desired = 0
            covered = 0.0
            for cap in caps:
                desired += 1
                covered += cap
                if covered > qps:
                    break
        desired = max(self.spec.min_replicas,
                      min(self.spec.max_replicas, desired))
        self._apply_hysteresis(desired, now)
        return self._decide(num_ready + num_launching)


@dataclasses.dataclass
class EngineSignal:
    """One replica's scraped engine pressure signals (from its JSON
    `/stats`): what the inference engine actually knows about load,
    as opposed to what the front-end counted arriving."""
    queue_depth: int = 0
    prefill_backlog_tokens: int = 0
    requests_shed_total: int = 0  # lifetime counter as scraped


@AUTOSCALER_REGISTRY.register(name='engine_metrics')
class EngineMetricsAutoscaler(Autoscaler):
    """Scale replica count from scraped ENGINE metrics, not request
    counts.

    The request-rate scalers model load as arrivals/sec, which is
    blind to request cost: forty 16-token prompts and one 4k-token
    prefill read identically. The serving engine already exports the
    real pressure signals: queue depth (requests waiting
    for a decode slot), prefill backlog tokens (admitted prompt
    suffix not yet prefilled — the chunked-prefill scheduler's own
    work queue), and the shed counter (admission control actively
    answering 429). A replica-plane scraper feeds them in via
    `observe()`; `evaluate()` is a pure function of (signals, time).

    Scaling rule:
      desired = max(ceil(total_queue / target_queue_per_replica),
                    ceil(total_backlog / target_backlog_per_replica))
    and while sheds are occurring within the shed window, at least
    one replica above the current fleet (a bounded queue caps the
    depth signal exactly when pressure is worst — the shed counter is
    the overflow indicator). Hysteresis delays apply as in the rate
    scalers; scale-down decisions are executed by the replica plane
    through the drain contract (mark not-ready -> stop routing ->
    SIGTERM -> wait drain), never kill-then-reroute.
    """

    _SHED_WINDOW_SECONDS = 60.0

    def __init__(self, spec: 'spec_lib.SkyServiceSpec',
                 clock: Optional[Callable[[], float]] = None,
                 target_queue_per_replica: Optional[float] = None,
                 target_backlog_per_replica: Optional[float] = None
                 ) -> None:
        super().__init__(spec, clock)
        self.target_queue_per_replica = (
            target_queue_per_replica if target_queue_per_replica
            is not None else getattr(spec, 'target_queue_per_replica',
                                     4.0))
        self.target_backlog_per_replica = (
            target_backlog_per_replica if target_backlog_per_replica
            is not None else getattr(spec,
                                     'target_backlog_per_replica',
                                     4096.0))
        self._signals: Dict[str, EngineSignal] = {}
        self._last_shed_total: Dict[str, int] = {}
        self._shed_events: List[Tuple[float, int]] = []

    # -- signal ----------------------------------------------------------
    def observe(self, replica: str, *, queue_depth: int = 0,
                prefill_backlog_tokens: int = 0,
                requests_shed_total: int = 0,
                now: Optional[float] = None) -> None:
        """One scrape of one replica. `requests_shed_total` is the
        replica's lifetime counter; deltas between scrapes become
        timestamped shed events for the rate window."""
        now = self._now(now)
        prev = self._last_shed_total.get(replica)
        if prev is not None:
            delta = requests_shed_total - prev
            if delta > 0:
                self._shed_events.append((now, delta))
        self._last_shed_total[replica] = requests_shed_total
        self._signals[replica] = EngineSignal(
            queue_depth=queue_depth,
            prefill_backlog_tokens=prefill_backlog_tokens,
            requests_shed_total=requests_shed_total)
        self._trim_sheds(now)

    def forget(self, replica: str) -> None:
        """Replica left the fleet (drained or died): drop its signals
        so a dead replica's last-known backlog cannot hold the target
        up forever. Shed events already recorded stay — the overload
        they witnessed was real."""
        self._signals.pop(replica, None)
        self._last_shed_total.pop(replica, None)

    def _trim_sheds(self, now: float) -> None:
        cutoff = now - self._SHED_WINDOW_SECONDS
        self._shed_events = [(t, n) for t, n in self._shed_events
                             if t >= cutoff]

    def shed_rate(self, now: Optional[float] = None) -> float:
        """Sheds per second over the shed window."""
        now = self._now(now)
        self._trim_sheds(now)
        return (sum(n for _, n in self._shed_events) /
                self._SHED_WINDOW_SECONDS)

    def total_queue_depth(self) -> int:
        return sum(s.queue_depth for s in self._signals.values())

    def total_backlog_tokens(self) -> int:
        return sum(s.prefill_backlog_tokens
                   for s in self._signals.values())

    # -- decision --------------------------------------------------------
    def evaluate(self, num_ready: int, num_launching: int,
                 now: Optional[float] = None,
                 ready_capacities: Optional[List[float]] = None
                 ) -> AutoscalerDecision:
        del ready_capacities  # engine signals already absorb capacity
        now = self._now(now)
        desired = max(
            math.ceil(self.total_queue_depth() /
                      self.target_queue_per_replica),
            math.ceil(self.total_backlog_tokens() /
                      self.target_backlog_per_replica))
        total = num_ready + num_launching
        if self.shed_rate(now) > 0:
            # Admission control is rejecting traffic: the bounded
            # queue caps queue_depth at its limit, so depth alone
            # under-reads pressure exactly when it is worst. Grow
            # beyond the live fleet until sheds stop.
            desired = max(desired, total + 1)
        desired = max(self.spec.min_replicas,
                      min(self.spec.max_replicas, desired))
        self._apply_hysteresis(desired, now)
        return self._decide(total)
