"""Self-supervising trainer guards: the process-side half of the
managed-jobs recovery contract (port of
skypilot_tpu/robustness/train_guard.py).

Three failure families, each ending in a typed exit code that the
reference's `agent/job_lib.py` maps to a recoverable job status, so
the controller relaunches the job without spending the user-failure
restart budget:

  - **Preemption**: a spot reclaim is announced (GCE metadata
    `instance/preempted` flips TRUE, and/or SIGTERM lands) ~30 s before
    the VM dies. The trainer checkpoints at the next step boundary and
    exits 83; the relaunch loses at most the step in flight.
  - **Numerical blowups**: the guarded step (parallel/train.py) flags a
    NaN/inf loss or grad norm, or a norm spike, on the device and skips
    the update; after K consecutive bad steps the host rolls back to
    the last verified checkpoint.
  - **Hangs**: a stalled data loader or device leaves the process
    alive but stuck. A step watchdog dumps every thread's stack and
    exits 84 past a per-phase deadline.

All three are chaos-testable through the fault points
`train.preempt_notice`, `train.step` and `train.data_next`
(robustness/faults.py); the fire-site context carries `resume=<0|1>`
so a plan can scope an injection to the first launch.

Notices, skipped steps and watchdog aborts count in the catalog's
`skypilot_train_preempt_notices_total`,
`skypilot_train_guard_skipped_steps_total` and
`skypilot_train_watchdog_aborts_total` at the reference's sites. One
place differs from the reference: the metadata probe uses
`urllib.request` (the card's machine has no `requests`).
"""
from __future__ import annotations

import faulthandler
import math
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, TextIO, Tuple

from skypilot_tpu_torch.observability import catalog
from skypilot_tpu_torch.robustness import faults

#: Trainer exited after a preemption notice, with a fresh checkpoint
#: on disk: the controller relaunches and the resumed run loses <= 1
#: optimizer step. The reference's codes, in the user-defined range.
EXIT_PREEMPTED_GRACEFUL = 83
#: The step watchdog aborted a hung trainer after dumping all thread
#: stacks: the controller relaunches instead of waiting forever.
EXIT_WATCHDOG_ABORT = 84

#: The default GCE preemption-notice endpoint; overridable for tests and
#: non-GCE substrates via STPU_PREEMPT_METADATA_URL.
GCE_PREEMPTED_URL = ('http://metadata.google.internal/computeMetadata'
                     '/v1/instance/preempted')
METADATA_URL_ENV = 'STPU_PREEMPT_METADATA_URL'

#: Consecutive metadata-probe failures before the poller stops hitting
#: the endpoint; the fault point and SIGTERM keep working.
_METADATA_MAX_FAILURES = 5
#: The reference's (connect, read) timeouts; urllib takes one timeout.
_METADATA_TIMEOUT_S = 2.0


class PreemptionNotice:
    """Watches for a preemption notice: GCE metadata poll + SIGTERM.

    `start()` spawns a daemon poll thread and (optionally) installs a
    SIGTERM handler; `notice` is a `threading.Event` the train loop
    checks once per step. Each poll fires the `train.preempt_notice`
    fault point: a `drop` rule is a synthetic notice.
    """

    def __init__(self, poll_interval_s: float = 5.0,
                 metadata_url: Optional[str] = None,
                 install_sigterm: bool = True,
                 ctx: Optional[Dict[str, str]] = None) -> None:
        self.poll_interval_s = poll_interval_s
        self.metadata_url = (metadata_url
                             or os.environ.get(METADATA_URL_ENV)
                             or GCE_PREEMPTED_URL)
        self.install_sigterm = install_sigterm
        self.ctx = dict(ctx or {})
        self.notice = threading.Event()
        self.reason: Optional[str] = None
        self.polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._metadata_failures = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self.install_sigterm:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._handle_sigterm)
        self._thread = threading.Thread(target=self._poll_loop,
                                        name='preempt-notice', daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- notice sources --------------------------------------------------
    def trigger(self, reason: str) -> None:
        """Latch the notice (first reason wins). Signal-safe: only sets
        an Event and a string."""
        if not self.notice.is_set():
            self.reason = reason
            self.notice.set()
            catalog.counter('skypilot_train_preempt_notices_total').inc()

    def _handle_sigterm(self, signum, frame):  # noqa: ARG002
        self.trigger('sigterm')

    def _poll_loop(self) -> None:
        while not self._stop.is_set() and not self.notice.is_set():
            self.polls += 1
            # Chaos: a drop rule here IS the preemption notice; the
            # resume flag in ctx lets a plan spare the recovered run.
            if faults.point('train.preempt_notice',
                            **self.ctx) is faults.DROP:
                self.trigger('injected')
                break
            if self._probe_metadata():
                self.trigger('metadata')
                break
            self._stop.wait(self.poll_interval_s)

    def _probe_metadata(self) -> bool:
        if self._metadata_failures >= _METADATA_MAX_FAILURES:
            return False
        req = urllib.request.Request(self.metadata_url,
                                     headers={'Metadata-Flavor': 'Google'})
        try:
            with urllib.request.urlopen(req,
                                        timeout=_METADATA_TIMEOUT_S) as resp:
                text = resp.read().decode('utf-8', 'replace')
            self._metadata_failures = 0
            return text.strip().upper() == 'TRUE'
        except urllib.error.HTTPError:
            # A response that is not 2xx: the endpoint answered, so this
            # is no strike (requests' `resp.ok` False).
            self._metadata_failures = 0
            return False
        except (urllib.error.URLError, OSError, ValueError):
            # Not on GCE (or the fake server is gone): give up on the
            # endpoint after a few strikes; SIGTERM and injection still
            # cover the notice path.
            self._metadata_failures += 1
            if self._metadata_failures == _METADATA_MAX_FAILURES:
                print('preempt-notice: metadata endpoint '
                      f'{self.metadata_url} unreachable '
                      f'{_METADATA_MAX_FAILURES}x; polling stopped '
                      '(SIGTERM handling stays active)', flush=True)
            return False


class SpikeGuard:
    """Host-side bad-step policy: EMA spike threshold + rollback-K.

    The device decides whether a step was bad (non-finite loss or grad
    norm, or a norm above `threshold()`) and skips the update itself;
    this class consumes the fetched verdicts, keeps the grad-norm EMA
    the threshold derives from, and escalates to a rollback after
    `rollback_after` consecutive bad steps. Only the train loop calls it.
    """

    def __init__(self, spike_factor: float = 10.0,
                 warmup_steps: int = 10,
                 rollback_after: int = 3,
                 ema_beta: float = 0.98) -> None:
        if rollback_after < 1:
            raise ValueError('rollback_after must be >= 1')
        self.spike_factor = spike_factor
        self.warmup_steps = warmup_steps
        self.rollback_after = rollback_after
        self.ema_beta = ema_beta
        self._ema: Optional[float] = None
        self._good_steps = 0
        self.consecutive_bad = 0
        self.skipped_total = 0
        self.rollbacks = 0

    def threshold(self) -> float:
        """Grad-norm ceiling for the NEXT step (inf while warming up):
        the device flags `gnorm > threshold` as a spike."""
        if self._ema is None or self._good_steps < self.warmup_steps:
            return math.inf
        return self.spike_factor * self._ema

    def observe(self, step: int, loss: float, gnorm: float,
                bad: bool) -> str:
        """Consume one step's fetched (loss, gnorm, bad) verdict.
        Returns 'ok', 'skipped', or 'rollback' (the caller restores the
        last checkpoint and then calls `reset_after_rollback`)."""
        del step
        if bad:
            self.skipped_total += 1
            self.consecutive_bad += 1
            catalog.counter('skypilot_train_guard_skipped_steps_total').inc()
            if self.consecutive_bad >= self.rollback_after:
                return 'rollback'
            return 'skipped'
        self.consecutive_bad = 0
        if math.isfinite(gnorm) and math.isfinite(loss):
            self._ema = (gnorm if self._ema is None else
                         self.ema_beta * self._ema +
                         (1.0 - self.ema_beta) * gnorm)
            self._good_steps += 1
        return 'ok'

    def reset_after_rollback(self) -> None:
        """Forget the (possibly poisoned) EMA and re-warm."""
        self._ema = None
        self._good_steps = 0
        self.consecutive_bad = 0
        self.rollbacks += 1


class StepWatchdog:
    """Aborts a hung trainer: per-phase heartbeat with a deadline.

    The train loop calls `beat(phase)` at every phase transition (data
    fetch, step dispatch, commit); a background thread ends the PROCESS
    when no beat lands within the phase's deadline: `faulthandler`
    dumps every thread's stack (the blocked frame is in the dump), and
    `exit_fn` (default `os._exit`, the only exit that works under a
    wedged main thread) exits with EXIT_WATCHDOG_ABORT.
    """

    def __init__(self, deadline_s: float,
                 poll_interval_s: float = 0.25,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 stream: Optional[TextIO] = None) -> None:
        if deadline_s <= 0:
            raise ValueError('watchdog deadline must be > 0')
        self.deadline_s = deadline_s
        self.poll_interval_s = poll_interval_s
        self.exit_fn = exit_fn if exit_fn is not None else os._exit
        self.stream = stream
        self.fired = False
        # One tuple, so beat() is a single assignment the watchdog
        # thread never reads half-updated.
        self._beat: Tuple[float, str, float] = (
            time.monotonic(), 'init', deadline_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name='step-watchdog', daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def beat(self, phase: str, deadline_s: Optional[float] = None) -> None:
        """Mark a phase transition; `deadline_s` overrides the base
        deadline for THIS phase (e.g. the first step's warm-up)."""
        self._beat = (time.monotonic(), phase,
                      deadline_s if deadline_s is not None
                      else self.deadline_s)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            at, phase, deadline = self._beat
            stalled = time.monotonic() - at
            if stalled > deadline:
                self._abort(phase, stalled, deadline)
                return

    def _abort(self, phase: str, stalled: float, deadline: float) -> None:
        self.fired = True
        catalog.counter('skypilot_train_watchdog_aborts_total').inc()
        stream = self.stream if self.stream is not None else sys.stderr
        print(f'step-watchdog: phase {phase!r} stalled {stalled:.1f}s '
              f'(deadline {deadline:.1f}s); dumping thread stacks and '
              f'aborting with exit code {EXIT_WATCHDOG_ABORT}',
              file=stream, flush=True)
        try:
            faulthandler.dump_traceback(file=stream, all_threads=True)
            stream.flush()
        except (OSError, ValueError):
            pass  # a closed stream must not block the abort itself
        self.exit_fn(EXIT_WATCHDOG_ABORT)


class TrainSupervisor:
    """The train loop's guard bundle: the preemption-notice watcher, the
    spike guard and the step watchdog behind the few calls
    `recipes/train_lm.py` makes per step. `ctx` is the fault-point
    fire-site context (e.g. `{'resume': '1'}` on a resumed run)."""

    def __init__(self, *,
                 spike_factor: float = 10.0,
                 warmup_steps: int = 10,
                 rollback_after: int = 3,
                 watchdog_deadline_s: float = 300.0,
                 compile_deadline_s: float = 1800.0,
                 notice_poll_s: float = 5.0,
                 metadata_url: Optional[str] = None,
                 install_sigterm: bool = True,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 watchdog_stream: Optional[TextIO] = None,
                 ctx: Optional[Dict[str, str]] = None) -> None:
        self.ctx = dict(ctx or {})
        self.guard = SpikeGuard(spike_factor=spike_factor,
                                warmup_steps=warmup_steps,
                                rollback_after=rollback_after)
        self.notice = PreemptionNotice(poll_interval_s=notice_poll_s,
                                       metadata_url=metadata_url,
                                       install_sigterm=install_sigterm,
                                       ctx=self.ctx)
        self.watchdog: Optional[StepWatchdog] = None
        if watchdog_deadline_s > 0:
            self.watchdog = StepWatchdog(watchdog_deadline_s,
                                         exit_fn=exit_fn,
                                         stream=watchdog_stream)
        self.compile_deadline_s = max(compile_deadline_s,
                                      watchdog_deadline_s)
        self._poisoned_steps = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.notice.start()
        if self.watchdog is not None:
            self.watchdog.start()

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        self.notice.stop()

    # -- per-step hooks --------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self.notice.notice.is_set()

    @property
    def preempt_reason(self) -> Optional[str]:
        return self.notice.reason

    def beat(self, phase: str, first_step: bool = False) -> None:
        if self.watchdog is not None:
            self.watchdog.beat(
                phase, self.compile_deadline_s if first_step else None)

    def step_ctl(self, step: int) -> Tuple[float, float]:
        """(max_grad_norm, loss_scale) for the guarded device step.

        Fires `train.step`; a `drop` rule poisons THIS step's loss with
        NaN (scale = NaN), driving the real on-device isfinite guard.
        """
        loss_scale = 1.0
        if faults.point('train.step', step=str(step),
                        **self.ctx) is faults.DROP:
            loss_scale = math.nan
            self._poisoned_steps += 1
            print(f'train-guard: injected NaN into step {step} '
                  f'(fault plan)', flush=True)
        return self.guard.threshold(), loss_scale

    def observe(self, step: int, loss: float, gnorm: float,
                bad: bool) -> str:
        verdict = self.guard.observe(step, loss, gnorm, bad)
        if verdict != 'ok':
            action = ('rolling back' if verdict == 'rollback'
                      else 'update skipped')
            print(f'train-guard: step {step} bad '
                  f'(loss={loss:.6g} grad_norm={gnorm:.6g}); {action} '
                  f'[{self.guard.consecutive_bad} consecutive]',
                  flush=True)
        return verdict

    def summary(self) -> Dict[str, int]:
        return {
            'skipped_steps': self.guard.skipped_total,
            'rollbacks': self.guard.rollbacks,
            'poisoned_steps': self._poisoned_steps,
            'preempt_notice': int(self.preempted),
        }
