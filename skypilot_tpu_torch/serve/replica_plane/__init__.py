"""Multi-replica serving plane: local replica manager, engine-metrics
autoscaling, prefix-affinity load balancing, drain-before-kill (port of
skypilot_tpu/serve/replica_plane/ over the port's `serve_lm` replicas;
the same `__all__`).

REAL `serve_lm` server processes on distinct ports of one machine,
scraped and routed directly (the reference's cloud serve controller,
which runs replicas as clusters, is not part of the port):

  - replica_manager.py: spawns/terminates serve_lm processes, scrapes
    each replica's `/stats` + `/readyz` on an interval into shared
    `ReplicaView`s, and executes the drain-before-kill contract
    (mark not-ready -> stop routing -> SIGTERM -> wait for the
    replica's own /readyz drain -> only then kill);
  - fleet.py: the control loop wiring scraped engine signals into an
    `EngineMetricsAutoscaler` (serve/autoscalers.py) and the routing
    set into a load-balancing policy;
  - lb.py: a streaming HTTP front-end routing /generate* and /v1/*
    by prefix-cache chain-key affinity
    (serve/load_balancing_policies.py PrefixAffinityPolicy,
    inference/affinity.py), retrying idempotent not-yet-streamed
    requests on replica death;
  - stub.py: a model-free replica speaking the same control surface
    (readyz/stats/generate+SSE, SIGTERM drain, prefix-cache
    accounting) for deterministic tier-1 tests and bench smokes;
  - journal.py: the durable fleet journal (fsync'd JSONL of replica
    lifecycle events, atomic-rename compaction) that makes the
    control plane crash-only — a restarted controller replays it
    and `ReplicaManager.adopt()` reattaches every replica it can
    verify (pid alive + /stats echoing the journaled instance UUID)
    instead of orphaning or killing them;
  - http_client.py: the plane's HTTP calls over http.client.

Entry point: `python -m skypilot_tpu_torch.recipes.serve_fleet`.
"""
from skypilot_tpu_torch.serve.replica_plane.fleet import FleetController
from skypilot_tpu_torch.serve.replica_plane.journal import (FleetJournal,
                                                            ReplicaRecord)
from skypilot_tpu_torch.serve.replica_plane.lb import (PrefillPool,
                                                       make_lb_server)
from skypilot_tpu_torch.serve.replica_plane.replica_manager import (
    ReplicaManager, ReplicaView, serve_lm_factory, stub_factory)

__all__ = ['FleetController', 'FleetJournal', 'PrefillPool',
           'ReplicaManager', 'ReplicaRecord', 'ReplicaView',
           'make_lb_server', 'serve_lm_factory', 'stub_factory']
