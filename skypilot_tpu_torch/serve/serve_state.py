"""Replica lifecycle states of the serving fleet (port of
skypilot_tpu/serve/serve_state.py `ReplicaStatus`). The reference's
service database is the cloud controller's and is not on the fleet's
path; only the enum is ported.
"""
from __future__ import annotations

import enum


class ReplicaStatus(enum.Enum):
    PENDING = 'PENDING'
    PROVISIONING = 'PROVISIONING'
    STARTING = 'STARTING'
    READY = 'READY'
    NOT_READY = 'NOT_READY'
    # Drain-before-kill: the replica is out of the routing set and
    # finishing its in-flight requests (its /readyz answers 503), but
    # the process is still alive — the dashboard/status surfaces must
    # distinguish this from SHUTTING_DOWN (teardown issued) and the
    # terminal states.
    DRAINING = 'DRAINING'
    SHUTTING_DOWN = 'SHUTTING_DOWN'
    PREEMPTED = 'PREEMPTED'
    FAILED = 'FAILED'
    SHUTDOWN = 'SHUTDOWN'

    def is_terminal(self) -> bool:
        return self in (ReplicaStatus.FAILED, ReplicaStatus.SHUTDOWN)

    @property
    def is_serving(self) -> bool:
        return self == ReplicaStatus.READY
