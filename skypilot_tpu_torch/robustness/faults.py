"""Deterministic fault injection at named points (port of
skypilot_tpu/robustness/faults.py, the parts the trainer and the
replica's KV-chain paths fire).

Production code declares injection points (`faults.point('train.step',
step='4')`) that are no-ops by default: one module-global read per
call. Under a fault plan (JSON through the `STPU_FAULT_PLAN`
environment variable, read once at import, or `install_plan()`) a point
perturbs its code path: raise an exception, delay, or return `DROP` so
the site skips or poisons the guarded operation.

Plan format, as the reference's:

    {"seed": 2026,
     "rules": [
       {"point": "train.step", "action": "drop", "at": [5, 6, 7]},
       {"point": "train.data_next", "action": "delay", "delay_s": 300,
        "after": 12, "times": 1, "scope": {"resume": "0"}},
       {"point": "train.preempt_notice", "action": "drop",
        "scope": {"resume": "0"}, "after": 60}]}

Rule semantics (the reference's): every `point(name, **ctx)` call
counts one hit on each matching rule (first call = hit 1). A rule with
a `scope` matches only calls whose context carries every scoped key
with that exact value; other calls are not hits of it. A rule fires
when hits > `after` (default 0), its trigger matches (`every_nth`:
every Nth eligible hit; `at`: exact hit numbers; `prob`: a coin flip
from the rule's own `random.Random`, seeded from the plan seed, the
rule's index and its point; none: every eligible hit), and it has fired
fewer than `times` (default unlimited) times. Rules evaluate in plan
order: `delay` fires and evaluation continues, `drop` and `raise` end
it. So a plan replays the same firings in the port and the reference.

The catalog is closed, and holds the points the port fires: a plan
naming another point fails at install rather than never firing. Time
windows (`start_s`, `start_range`, `duration_s`) and the derived
`jobs.preempt_storm` point serve the fleet simulator and the serving
plane, and wait for ROADMAP A6(e)'s `--fault-plan`; a rule that sets a
window is refused.
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

# The injection points wired into the port, with what a firing rule
# perturbs (the reference's descriptions).
KNOWN_POINTS: Dict[str, str] = {
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
    'kv.handoff':
        'prefill-role inference server, start of each prefill->'
        'decode KV page-chain handoff (raise OR drop fails the '
        'transfer: the prefill replica falls back to serving the '
        'request locally from its already-warm pages — the '
        'disaggregation degradation path, never an error to the '
        'client)',
    'kv.migrate':
        'inference server, start of each live session migration '
        'ship (the /kv/migrate POST of an evacuated chain + '
        'continuation request) — raise OR drop fails the ship: the '
        'session finishes locally on the pages the evacuation '
        'promoted into the prefix cache, never an error to the '
        'client; context carries reason=<drain|preempt|rebalance>',
    'serve.preempt_notice':
        'serving preemption-notice poll loop (http_server.'
        'ServePreemptionNotice) — a DROP is a synthetic spot '
        'preemption: the replica mass-evacuates every active KV '
        'chain to peers and drains inside the grace window; '
        'fire-site context carries zone=<zone>',
}

_WINDOW_KEYS = ('start_s', 'start_range', 'duration_s')

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
    if not (isinstance(cls, type) and issubclass(cls, BaseException)):
        raise ValueError(f'fault plan: exc {name!r} is not an exception '
                         f'type')
    return cls


class FaultRule:
    """One parsed rule; owns its hit/fired counters and seeded rng."""

    _ACTIONS = ('raise', 'delay', 'drop')

    def __init__(self, spec: Dict[str, Any], index: int, seed: int) -> None:
        self.point = spec.get('point')
        if self.point not in KNOWN_POINTS:
            raise ValueError(
                f'fault plan: unknown point {self.point!r}; the port '
                f'fires: {sorted(KNOWN_POINTS)}')
        windowed = [k for k in _WINDOW_KEYS if spec.get(k) is not None]
        if windowed:
            raise ValueError(
                f'fault plan: rule {index} ({self.point}) sets {windowed}: '
                f'time windows are not ported yet (ROADMAP A6(e))')
        self.action = spec.get('action', 'raise')
        if self.action not in self._ACTIONS:
            raise ValueError(f'fault plan: unknown action {self.action!r} '
                             f'(use one of {self._ACTIONS})')
        self.exc = _resolve_exc(spec.get('exc'))
        self.message = str(spec.get('message',
                                    f'injected fault at {self.point}'))
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
                    f'fault plan: scope must map string keys to string '
                    f'values, got {self.scope!r}')
        # Per-rule deterministic stream: same plan -> same firings.
        self._rng = random.Random(f'{seed}:{index}:{self.point}')
        self.hits = 0
        self.fired = 0

    def matches(self, ctx: Dict[str, str]) -> bool:
        """A call outside the rule's scope is invisible to it."""
        return all(ctx.get(k) == v for k, v in self.scope.items())

    def check(self) -> bool:
        """Register one hit; True when the rule fires this hit. Caller
        holds the plan lock."""
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
    """A parsed plan: rules indexed by point, thread-safe firing."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.seed = int(spec.get('seed', 0))
        rules = spec.get('rules')
        if not isinstance(rules, list) or not rules:
            raise ValueError('fault plan: "rules" must be a non-empty list')
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[FaultRule]] = {}
        for i, rule_spec in enumerate(rules):
            rule = FaultRule(rule_spec, i, self.seed)
            self._by_point.setdefault(rule.point, []).append(rule)

    def fire(self, name: str,
             ctx: Optional[Dict[str, str]] = None) -> Optional[object]:
        rules = self._by_point.get(name)
        if not rules:
            return None
        ctx = ctx or {}
        delay = 0.0
        outcome: Optional[object] = None
        raise_rule: Optional[FaultRule] = None
        with self._lock:
            for rule in rules:
                if not rule.matches(ctx) or not rule.check():
                    continue
                if rule.action == 'delay':
                    delay += rule.delay_s
                    continue
                if rule.action == 'drop':
                    outcome = DROP
                    break
                raise_rule = rule
                break
        # Sleep and raise outside the lock: a delayed point must not
        # serialize every other thread's injection checks.
        if delay > 0.0:
            time.sleep(delay)
        if raise_rule is not None:
            raise raise_rule.exc(raise_rule.message)
        return outcome

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{point: {hits, fired}} over the point's rules."""
        with self._lock:
            return {name: {'hits': max(r.hits for r in rules),
                           'fired': sum(r.fired for r in rules)}
                    for name, rules in self._by_point.items()}


_plan: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def install_plan(spec: Union[None, str, Dict[str, Any], FaultPlan]
                 ) -> Optional[FaultPlan]:
    """Install the process-wide plan. `spec` is a dict, a JSON string, a
    path to a JSON file, an already-built FaultPlan, or None (clears).
    Returns the installed plan."""
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
                raise ValueError(f'fault plan: invalid JSON: {e}') from e
        plan = FaultPlan(spec)
    with _install_lock:
        _plan = plan
    return plan


def clear() -> None:
    install_plan(None)


def get_plan() -> Optional[FaultPlan]:
    return _plan


def point(name: str, **ctx: str) -> Optional[object]:
    """THE injection point. No plan installed: returns None after one
    global read. With a plan: may raise, sleep, or return `DROP`.
    Keyword args are the fire-site context scoped rules match."""
    plan = _plan
    if plan is None:
        return None
    return plan.fire(name, ctx)


def stats() -> Dict[str, Dict[str, int]]:
    plan = _plan
    return plan.stats() if plan is not None else {}


# Operators enable chaos on a live process tree through the environment;
# read once at import, as the reference does.
_env_spec = os.environ.get('STPU_FAULT_PLAN')
if _env_spec:
    install_plan(_env_spec)
