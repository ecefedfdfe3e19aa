"""Deterministic fault injection at named points (the port's copy of
skypilot_tpu/robustness/faults.py, pinned to it by
tests/test_torch_fault_plan.py).

Production code declares injection points (`faults.point(
'engine.decode_step')`) that are no-ops by default: one module-global
read per call. Under a fault plan (JSON through the `STPU_FAULT_PLAN`
environment variable, read once at import, serve_lm's `--fault-plan`,
or `install_plan()`) a point perturbs its code path: raise an
exception, delay, or return `DROP` so the site skips or poisons the
guarded operation.

Plan format, rule semantics, seeded draws, time windows (`start_s` or
a seeded `start_range`, plus `duration_s`, on the plan's clock) and
the derived `jobs.preempt_storm` point are the reference's, so a plan
replays the same firings in both packages. The catalog is the
reference's whole closed catalog: a plan naming an unknown point fails
at install. A point the port has no call site for (the managed-jobs
controller's, the fleet's) is accepted and never fires, as in a
reference replica. The port fires: engine.decode_step,
engine.prefill_chunk, engine.device_get (models/batching.py),
http.handler, kv.handoff, kv.migrate, serve.preempt_notice
(inference/http_server.py), adapters.load (inference/adapters.py),
checkpoint.save, checkpoint.restore (parallel/checkpoints.py) and the
train.* points (robustness/train_guard.py, recipes/train_lm.py).
"""
from __future__ import annotations

import builtins
import importlib
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Union

# Every injection point wired into the codebase, with the behavior a
# firing rule perturbs (also rendered in docs/internals.md).
KNOWN_POINTS: Dict[str, str] = {
    'engine.decode_step':
        'continuous-batching engine, start of one decode round '
        '(before the device dispatch and before the round consumes '
        'RNG — a raised fault retries the round with identical '
        'outputs)',
    'engine.prefill_chunk':
        'engine, start of one prefill-chunk dispatch for one slot (a '
        'raised fault fails only that slot\'s request)',
    'engine.device_get':
        'engine, before fetching sampled tokens from the device '
        '(delay here models host/device interconnect stalls)',
    'jobs.monitor_probe':
        'managed-job controller, before each agent liveness probe '
        '(DROP makes the probe count as unreachable — a synthetic '
        'preemption; fire-site context carries zone=<zone> and '
        'job=<job id> for scoped rules)',
    'jobs.preempt_storm':
        'derived point: a windowed drop rule on jobs.monitor_probe '
        'scoped to a set of jobs (e.g. {"zone": ...}) — one rule '
        'models a zone-wide spot storm hitting every job placed '
        'there during a seeded time window',
    'jobs.launch':
        'recovery-strategy executor, before each cluster launch '
        'attempt (raise ResourcesUnavailableError to exercise '
        'retry/backoff/failover)',
    'http.handler':
        'inference HTTP server, start of each POST handler',
    'kv.handoff':
        'prefill-role inference server, start of each prefill->'
        'decode KV page-chain handoff (raise OR drop fails the '
        'transfer: the prefill replica falls back to serving the '
        'request locally from its already-warm pages — the '
        'disaggregation degradation path, never an error to the '
        'client)',
    'adapters.load':
        'adapter registry (inference/adapters.py), inside each LoRA '
        'artifact load into the device store — raise OR drop makes '
        'the load fail as AdapterLoadError (HTTP 503) for that '
        'request only; the engine, the base model, and every other '
        'adapter keep serving; fire-site context carries '
        'adapter=<name> for scoped rules',
    'fleet.tick':
        'replica-plane fleet controller, start of each control-loop '
        'tick (a raised fault exercises the tick-error fuse: 3 '
        'consecutive failures flip the controller-degraded gauge; '
        'a SIGKILL-shaped chaos run restarts the controller and '
        'adopts the fleet from the journal)',
    'checkpoint.save':
        'CheckpointManager.save, before the orbax save is issued',
    'checkpoint.restore':
        'CheckpointManager.restore, before integrity verification '
        'and the orbax read (raise to model unreadable checkpoint '
        'storage; manifest-verification fallback is separate and '
        'driven by on-disk corruption)',
    'train.preempt_notice':
        'trainer preemption-notice poll loop (train_guard.py) — a '
        'DROP is a synthetic preemption notice: the trainer '
        'checkpoints NOW and exits with the typed code 83 the '
        'managed-jobs controller maps to recovery; fire-site '
        'context carries resume=<0|1> so a scoped rule can preempt '
        'only the first launch',
    'train.step':
        'train loop, before each optimizer-step dispatch — a DROP '
        'poisons that step\'s loss with NaN (through the REAL '
        'on-device isfinite guard: update skipped, rollback after K '
        'consecutive); context: step=<n>, resume=<0|1>',
    'train.data_next':
        'train loop, start of each batch fetch — a delay models a '
        'stalled data loader: the step watchdog dumps all thread '
        'stacks and aborts with the typed code 84 past its '
        'deadline; context: resume=<0|1>',
    'serve.preempt_notice':
        'serving preemption-notice poll loop (http_server.'
        'ServePreemptionNotice + the stub replica) — a DROP is a '
        'synthetic spot preemption: the replica mass-evacuates every '
        'active KV chain to peers and drains inside the grace '
        'window; fire-site context carries zone=<zone>, so a '
        'windowed scoped rule is a zone-wide decode-pool storm '
        '(examples/fault_plans/decode_zone_storm.json)',
    'kv.migrate':
        'inference server, start of each live session migration '
        'ship (the /kv/migrate POST of an evacuated chain + '
        'continuation request) — raise OR drop fails the ship: the '
        'session finishes locally on the pages the evacuation '
        'promoted into the prefix cache, never an error to the '
        'client; context carries reason=<drain|preempt|rebalance>',
}

#: Sentinel returned by `point()` when a drop rule fires; sites that
#: support dropping compare with `is`.
DROP = object()


class InjectedFault(Exception):
    """Default exception type raised by `action: raise` rules."""


def _resolve_exc(name: Optional[str]):
    """Exception class from a builtin name or dotted path."""
    if not name:
        return InjectedFault
    if '.' in name:
        module_name, attr = name.rsplit('.', 1)
        cls = getattr(importlib.import_module(module_name), attr)
    else:
        cls = getattr(builtins, name, None)
    if not (isinstance(cls, type) and
            issubclass(cls, BaseException)):
        raise ValueError(f'fault plan: exc {name!r} is not an '
                         f'exception type')
    return cls


#: Derived points: not called by production code; a rule naming one
#: is rewritten at parse time onto the real point it perturbs, with
#: the listed defaults forced.
_DERIVED_POINTS: Dict[str, Dict[str, Any]] = {
    'jobs.preempt_storm': {
        'target': 'jobs.monitor_probe',
        'action': 'drop',
        'window_required': True,
    },
}


class FaultRule:
    """One parsed rule; owns its hit/fired counters and seeded rng."""

    _ACTIONS = ('raise', 'delay', 'drop')

    def __init__(self, spec: Dict[str, Any], index: int,
                 seed: int) -> None:
        self.point = spec.get('point')
        if self.point not in KNOWN_POINTS:
            raise ValueError(
                f'fault plan: unknown point {self.point!r}; known '
                f'points: {sorted(KNOWN_POINTS)}')
        derived = _DERIVED_POINTS.get(self.point, {})
        #: The point this rule is evaluated at (== `point` unless
        #: derived); plans index rules by target, stats by `point`.
        self.target = derived.get('target', self.point)
        self.action = spec.get('action', derived.get('action', 'raise'))
        if self.action not in self._ACTIONS:
            raise ValueError(f'fault plan: unknown action '
                             f'{self.action!r} (use one of '
                             f'{self._ACTIONS})')
        self.exc = _resolve_exc(spec.get('exc'))
        self.message = str(spec.get('message', f'injected fault at '
                                               f'{self.point}'))
        self.delay_s = float(spec.get('delay_s', 0.0))
        self.every_nth = spec.get('every_nth')
        self.at = [int(x) for x in spec.get('at', [])]
        self.after = int(spec.get('after', 0))
        self.times = spec.get('times')
        self.prob = spec.get('prob')
        self.scope = dict(spec.get('scope') or {})
        for key, value in self.scope.items():
            if not isinstance(key, str) or not isinstance(value, str):
                raise ValueError(
                    f'fault plan: scope must map string keys to '
                    f'string values, got {self.scope!r}')
        # Per-rule deterministic stream: same plan -> same firings.
        # The window draw (if any) consumes the first value, so
        # `prob` streams stay aligned whether or not a range is set.
        self._rng = random.Random(f'{seed}:{index}:{self.point}')
        self.start_s: Optional[float] = None
        self.duration_s: Optional[float] = None
        start_range = spec.get('start_range')
        if start_range is not None:
            lo, hi = (float(start_range[0]), float(start_range[1]))
            self.start_s = self._rng.uniform(lo, hi)
        elif spec.get('start_s') is not None:
            self.start_s = float(spec['start_s'])
        if spec.get('duration_s') is not None:
            self.duration_s = float(spec['duration_s'])
        if (self.start_s is None) != (self.duration_s is None):
            raise ValueError(
                f'fault plan: rule {index} ({self.point}) has a '
                f'partial window — set both start_s/start_range and '
                f'duration_s, or neither')
        if derived.get('window_required') and self.start_s is None:
            raise ValueError(
                f'fault plan: {self.point} requires a window '
                f'(start_s or start_range, plus duration_s)')
        self.hits = 0
        self.fired = 0

    def matches(self, ctx: Dict[str, str], elapsed_s: float) -> bool:
        """Eligibility filters that precede hit counting: a call
        outside the rule's scope or time window is invisible to it."""
        if self.start_s is not None and not (
                self.start_s <= elapsed_s <
                self.start_s + self.duration_s):
            return False
        for key, value in self.scope.items():
            if ctx.get(key) != value:
                return False
        return True

    def check(self) -> bool:
        """Register one hit; True when the rule fires this hit.
        Caller holds the plan lock."""
        self.hits += 1
        if self.times is not None and self.fired >= int(self.times):
            return False
        if self.hits <= self.after:
            return False
        eligible = self.hits - self.after
        if self.at:
            fire = self.hits in self.at
        elif self.every_nth:
            fire = eligible % int(self.every_nth) == 0
        elif self.prob is not None:
            fire = self._rng.random() < float(self.prob)
        else:
            fire = True
        if fire:
            self.fired += 1
        return fire


class FaultPlan:
    """A parsed plan: rules indexed by target point, thread-safe
    firing. `clock` (default `time.monotonic`) anchors rule windows:
    elapsed time is measured from plan construction, so a fleet
    simulator can pass its virtual clock and replay storms in
    virtual seconds."""

    def __init__(self, spec: Dict[str, Any], clock=None) -> None:
        self.seed = int(spec.get('seed', 0))
        rules = spec.get('rules')
        if not isinstance(rules, list) or not rules:
            raise ValueError('fault plan: "rules" must be a '
                             'non-empty list')
        self._clock = clock if clock is not None else time.monotonic
        self._epoch = self._clock()
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[FaultRule]] = {}
        for i, rule_spec in enumerate(rules):
            rule = FaultRule(rule_spec, i, self.seed)
            self._by_point.setdefault(rule.target, []).append(rule)

    def elapsed(self) -> float:
        return self._clock() - self._epoch

    def windows(self, point_name: str) -> List[Dict[str, Any]]:
        """Resolved {scope, start_s, end_s, action} for every
        windowed rule evaluated at `point_name` (storm geometry —
        the fleet simulator aligns cluster death with probe loss
        from this)."""
        out = []
        for rule in self._by_point.get(point_name, []):
            if rule.start_s is None:
                continue
            out.append({'scope': dict(rule.scope),
                        'start_s': rule.start_s,
                        'end_s': rule.start_s + rule.duration_s,
                        'action': rule.action})
        return out

    def fire(self, name: str,
             ctx: Optional[Dict[str, str]] = None) -> Optional[object]:
        rules = self._by_point.get(name)
        if not rules:
            return None
        ctx = ctx or {}
        elapsed = self.elapsed()
        delay = 0.0
        outcome: Optional[object] = None
        raise_rule: Optional[FaultRule] = None
        with self._lock:
            for rule in rules:
                if not rule.matches(ctx, elapsed):
                    continue
                if not rule.check():
                    continue
                if rule.action == 'delay':
                    delay += rule.delay_s
                    continue
                if rule.action == 'drop':
                    outcome = DROP
                    break
                raise_rule = rule
                break
        # Sleep/raise outside the lock: a delayed point must not
        # serialize every other thread's injection checks.
        if delay > 0.0:
            time.sleep(delay)
        if raise_rule is not None:
            raise raise_rule.exc(raise_rule.message)
        return outcome

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{point: {hits, fired}} aggregated over the point's rules.
        Derived rules (jobs.preempt_storm) report under their OWN
        name, not the target they were installed against."""
        grouped: Dict[str, List[FaultRule]] = {}
        with self._lock:
            for rules in self._by_point.values():
                for r in rules:
                    grouped.setdefault(r.point, []).append(r)
            return {name: {'hits': max(r.hits for r in rules),
                           'fired': sum(r.fired for r in rules)}
                    for name, rules in grouped.items()}


_plan: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def install_plan(spec: Union[None, str, Dict[str, Any], FaultPlan],
                 clock=None) -> Optional[FaultPlan]:
    """Install the process-wide plan. `spec` is a dict, a JSON string,
    a path to a JSON file, an already-built FaultPlan, or None
    (clears). `clock` (ignored for a pre-built FaultPlan) anchors
    rule windows — see FaultPlan. Returns the installed plan."""
    global _plan
    if spec is None:
        with _install_lock:
            _plan = None
        return None
    if isinstance(spec, FaultPlan):
        plan = spec
    else:
        if isinstance(spec, str):
            text = spec
            if not spec.lstrip().startswith('{'):
                with open(spec, 'r', encoding='utf-8') as f:
                    text = f.read()
            try:
                spec = json.loads(text)
            except json.JSONDecodeError as e:
                raise ValueError(f'fault plan: invalid JSON: {e}') \
                    from e
        plan = FaultPlan(spec, clock=clock)
    with _install_lock:
        _plan = plan
    return plan


def clear() -> None:
    install_plan(None)


def get_plan() -> Optional[FaultPlan]:
    return _plan


def active() -> bool:
    return _plan is not None


def point(name: str, **ctx: str) -> Optional[object]:
    """THE injection point. No plan installed: returns None after one
    global read (the zero-cost default every production call site
    pays). With a plan: may raise, sleep, or return `DROP`. Keyword
    args are the fire-site context scoped rules match against (e.g.
    `point('jobs.monitor_probe', zone='us-east5-b', job='12')`)."""
    plan = _plan
    if plan is None:
        return None
    return plan.fire(name, ctx)


def windows(point_name: str) -> List[Dict[str, Any]]:
    """Resolved windows of the installed plan's rules at
    `point_name`; empty with no plan."""
    plan = _plan
    return plan.windows(point_name) if plan is not None else []


def stats() -> Dict[str, Dict[str, int]]:
    plan = _plan
    return plan.stats() if plan is not None else {}


# Operators enable chaos on a live process tree via the environment
# (serve replicas, spawned job controllers); loaded once at import.
_env_spec = os.environ.get('STPU_FAULT_PLAN')
if _env_spec:
    install_plan(_env_spec)
