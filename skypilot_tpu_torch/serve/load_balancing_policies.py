"""Load balancing policies (port of
skypilot_tpu/serve/load_balancing_policies.py: every routing decision
equals the reference's for the same key sequence and ready set).

Reference: sky/serve/load_balancing_policies.py — RoundRobin (:88),
LeastLoad (:114). The replica-plane LB (serve/replica_plane/lb.py)
calls `select_replica(key=..., exclude=...)`: `key` is an optional
routing key (the prefix-cache chain-key hash of the request, see
inference/affinity.py) and `exclude` removes replicas that already
failed this request (retry-on-death). Policies that ignore keys
simply route as before.
"""
from __future__ import annotations

import bisect
import collections
import threading
from typing import Dict, Iterable, List, Optional, Set

# The ring positions the replicas' peer ring uses too (the reference's
# `_hash64` of this module, byte for byte).
from skypilot_tpu_torch.inference.affinity import _hash64
from skypilot_tpu_torch.utils.registry import LB_POLICY_REGISTRY


class LoadBalancingPolicy:

    def __init__(self) -> None:
        self.ready_replicas: List[str] = []
        self._lock = threading.Lock()

    def set_ready_replicas(self, replicas: List[str]) -> None:
        with self._lock:
            if set(replicas) != set(self.ready_replicas):
                self._on_replicas_changed(replicas)
            self.ready_replicas = list(replicas)

    def _on_replicas_changed(self, replicas: List[str]) -> None:
        pass

    def _candidates(self, exclude: Optional[Set[str]]) -> List[str]:
        """Ready replicas minus the caller's exclusion set (replicas
        that already failed this request). Callers hold `self._lock`."""
        if not exclude:
            return self.ready_replicas
        return [r for r in self.ready_replicas if r not in exclude]

    def select_replica(self, key: Optional[str] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        raise NotImplementedError

    def request_done(self, replica: str) -> None:
        pass


@LB_POLICY_REGISTRY.register(name='round_robin', default=True)
class RoundRobinPolicy(LoadBalancingPolicy):

    def __init__(self) -> None:
        super().__init__()
        self._index = 0

    def _on_replicas_changed(self, replicas: List[str]) -> None:
        self._index = 0

    def select_replica(self, key: Optional[str] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        del key  # round-robin ignores routing keys
        with self._lock:
            candidates = self._candidates(exclude)
            if not candidates:
                return None
            replica = candidates[self._index % len(candidates)]
            self._index += 1
            return replica


@LB_POLICY_REGISTRY.register(name='least_load')
class LeastLoadPolicy(LoadBalancingPolicy):
    """Route to the replica with fewest in-flight requests."""

    def __init__(self) -> None:
        super().__init__()
        self._in_flight: Dict[str, int] = collections.defaultdict(int)

    def select_replica(self, key: Optional[str] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        del key  # least-load ignores routing keys
        with self._lock:
            candidates = self._candidates(exclude)
            if not candidates:
                return None
            replica = min(candidates,
                          key=lambda r: self._in_flight[r])
            self._in_flight[replica] += 1
            return replica

    def request_done(self, replica: str) -> None:
        with self._lock:
            self._in_flight[replica] = max(
                0, self._in_flight[replica] - 1)


@LB_POLICY_REGISTRY.register(name='instance_aware')
class InstanceAwareLeastLoadPolicy(LeastLoadPolicy):
    """Least-load weighted by each replica's hardware capacity.

    Reference: the instance-aware policy in sky/serve — heterogeneous
    replica pools (e.g. a v5e-8 next to a v5e-4 during a rolling
    resize) should not receive equal traffic. The controller sets a
    capacity weight per endpoint (chips per replica); selection
    minimizes in_flight / weight.
    """

    def __init__(self) -> None:
        super().__init__()
        self._weights: Dict[str, float] = {}

    def set_replica_weights(self, weights: Dict[str, float]) -> None:
        with self._lock:
            self._weights = {k: max(v, 1e-6) for k, v in weights.items()}

    def select_replica(self, key: Optional[str] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        del key
        with self._lock:
            candidates = self._candidates(exclude)
            if not candidates:
                return None
            replica = min(
                candidates,
                key=lambda r: self._in_flight[r] / self._weights.get(r, 1.0))
            self._in_flight[replica] += 1
            return replica


@LB_POLICY_REGISTRY.register(name='prefix_affinity')
class PrefixAffinityPolicy(LeastLoadPolicy):
    """Prefix-cache / session affinity via consistent hashing.

    Requests sharing a system prompt carry the same routing key (the
    PrefixCache chain-key hash of the prompt's first full KV page,
    inference/affinity.py), and the key maps through a consistent-hash
    ring to the replica that already holds those KV pages — prefill
    skips recomputation there and the fleet stores one copy per
    prefix instead of one per replica.

    Properties the tests pin down:
      - stability: while the ready set is unchanged, the same key
        always routes to the same replica;
      - minimal remap on death: the ring is per-replica virtual
        nodes, so removing a replica moves ONLY its keys (survivors
        keep theirs — their vnodes did not move);
      - saturation fallback: when the affinity target is saturated
        (in-flight cap or reported engine backlog over the threshold)
        or not ready, the request falls back to the least-loaded
        ready replica instead of queueing behind its favorite;
      - keyless requests (no full prompt page, non-generation routes)
        use plain least-load.
    """

    _VNODES = 64  # virtual nodes per replica: evens out key spread
    _PIN_MAX = 4096  # migrated-session pins kept (bounded LRU)

    def __init__(self, saturation_inflight: int = 32,
                 saturation_backlog: Optional[float] = None) -> None:
        super().__init__()
        self.saturation_inflight = saturation_inflight
        self.saturation_backlog = saturation_backlog
        self._backlog: Dict[str, float] = {}
        self._ring_points: List[int] = []
        self._ring_owners: List[str] = []
        # Session pins (live migration): affinity key -> the endpoint
        # whose pool now holds that session's migrated KV chain. A
        # pin overrides the ring — the chain moved, the ring did not
        # — until it LRU-evicts or its endpoint leaves the ready set.
        self._pins: 'collections.OrderedDict[str, str]' = \
            collections.OrderedDict()

    # -- session pins (live migration) -----------------------------------
    def pin_key(self, key: str, endpoint: str) -> None:
        """Pin `key`'s sessions to `endpoint`: the fleet controller
        calls this for every migrated-in affinity key it scrapes, so
        follow-up requests land on the replica holding the warm
        pages instead of the ring's (now-stale) owner."""
        with self._lock:
            self._pins.pop(key, None)
            self._pins[key] = endpoint
            while len(self._pins) > self._PIN_MAX:
                self._pins.popitem(last=False)

    def _pinned(self, key: str,
                live: Iterable[str]) -> Optional[str]:
        """The pin's endpoint when it is in the live set (a pin to a
        dead or excluded replica is ignored, not dropped — scrape
        blips must not unpin a warm session). Callers hold _lock."""
        pinned = self._pins.get(key)
        if pinned is not None and pinned in live:
            return pinned
        return None

    # -- ring ------------------------------------------------------------
    def _on_replicas_changed(self, replicas: List[str]) -> None:
        ring = []
        for replica in set(replicas):
            for i in range(self._VNODES):
                ring.append((_hash64(f'{replica}#{i}'), replica))
        ring.sort()
        self._ring_points = [p for p, _ in ring]
        self._ring_owners = [r for _, r in ring]

    def _ring_lookup(self, key: str,
                     live: Iterable[str]) -> Optional[str]:
        """First live owner clockwise from the key's ring position.
        Walking (rather than filtering the ring) is what makes
        exclusion minimal-movement too: keys whose owner is live
        never move."""
        if not self._ring_points:
            return None
        live_set = set(live)
        if not live_set:
            return None
        start = bisect.bisect_left(self._ring_points, _hash64(key))
        n = len(self._ring_owners)
        for step in range(n):
            owner = self._ring_owners[(start + step) % n]
            if owner in live_set:
                return owner
        return None

    # -- load signals ----------------------------------------------------
    def set_replica_load(self, loads: Dict[str, float]) -> None:
        """Scraped engine load per endpoint (prefill backlog tokens +
        queue depth) — the saturation + fallback signal."""
        with self._lock:
            self._backlog = dict(loads)

    def _load(self, replica: str) -> float:
        return self._backlog.get(replica, 0.0) + self._in_flight[replica]

    def _saturated(self, replica: str) -> bool:
        if self._in_flight[replica] >= self.saturation_inflight:
            return True
        return (self.saturation_backlog is not None and
                self._backlog.get(replica, 0.0) >=
                self.saturation_backlog)

    # -- selection -------------------------------------------------------
    def affinity_target(self, key: Optional[str]) -> Optional[str]:
        """The pure ring mapping for `key` over the current ready set
        (no saturation, no exclusion) — what the LB compares the
        routed replica against for the affinity-hit ratio."""
        if key is None:
            return None
        with self._lock:
            pinned = self._pinned(key, self.ready_replicas)
            if pinned is not None:
                return pinned
            return self._ring_lookup(key, self.ready_replicas)

    def select_replica(self, key: Optional[str] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        with self._lock:
            candidates = self._candidates(exclude)
            if not candidates:
                return None
            replica = None
            if key is not None:
                replica = self._pinned(key, candidates)
                if replica is None:
                    replica = self._ring_lookup(key, candidates)
                if replica is not None and self._saturated(replica):
                    replica = None  # fall back below
            if replica is None:
                replica = min(candidates, key=self._load)
            self._in_flight[replica] += 1
            return replica
