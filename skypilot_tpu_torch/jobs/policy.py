"""Checkpoint cadence for managed jobs (port of the part of
skypilot_tpu/jobs/policy.py that `train_lm --ckpt-interval auto`
reads).

Young/Daly first-order analysis of checkpointed work under memoryless
interrupts: a zone preempts spot capacity at rate lambda (preemptions
an hour, the catalog's `PreemptionRate` column) and a checkpoint costs
delta seconds of paused progress; the optimum interval balances that
tax against the expected loss of half an interval per preemption:
tau* = sqrt(2 * delta / lambda). Rates are per HOUR, durations in
SECONDS, as in the reference.
"""
from __future__ import annotations

import math

#: Default checkpoint write overhead when the caller has no better
#: number: a large-model checkpoint write to a bucket (~1 min).
DEFAULT_CKPT_OVERHEAD_S = 60.0

#: Cadence clamp: never advise checkpointing more often than once a
#: minute (write amplification) or less than once a day.
MIN_INTERVAL_S = 60.0
MAX_INTERVAL_S = 86400.0


def optimal_checkpoint_interval(
        preemption_rate_per_hour: float,
        ckpt_overhead_s: float = DEFAULT_CKPT_OVERHEAD_S) -> float:
    """Young's optimum tau* = sqrt(2 * delta / lambda), seconds.

    A zone losing capacity 0.5x/hour with 60 s checkpoint writes wants
    a checkpoint roughly every 15.5 minutes; a stable zone (rate ~0)
    wants the cadence ceiling.
    """
    if preemption_rate_per_hour <= 0.0:
        return MAX_INTERVAL_S
    rate_per_s = preemption_rate_per_hour / 3600.0
    tau = math.sqrt(2.0 * max(ckpt_overhead_s, 0.0) / rate_per_s)
    return min(max(tau, MIN_INTERVAL_S), MAX_INTERVAL_S)
