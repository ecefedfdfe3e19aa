"""Engine flight recorder: a fixed-size ring of scheduler events.

The port's copy of skypilot_tpu/observability/flight.py, pinned to it by
tests/test_torch_tracing_slo.py (a failed snapshot logs to stderr
itself).

Aggregate metrics say *that* p99 spiked; the flight recorder says
*what the scheduler did* in the seconds before — which slot was
admitted, which chunk dispatched, who was preempted, which page
chain spilled, and the exact soft-error -> 3-strike -> reset
escalation. It records UNCONDITIONALLY (no sampling flag): one list
slot assignment per event, cheap enough to leave on in production.

The ring is single-writer (the engine scheduler thread owns all
`record()` calls) and lock-free by design: list item assignment is
atomic under the GIL, and `dump()` (HTTP scrape threads) takes a
racy-but-consistent snapshot the same way the engine's counters do.

Event shape: `(wall_ts, kind, fields)` in the ring, rendered as
`{'ts', 'seq', 'kind', **fields}` in dumps. Kinds the engine emits:
admit, chunk_dispatch, round_commit, preempt, evict, spill, restore,
handoff_export, kv_import, soft_error, reset, death. The schema is
open — `fields` is whatever the call site passes.

On engine reset or scheduler death the engine calls `snapshot()`,
which writes the full dump to a JSON file (`STPU_FLIGHT_DIR`, else
the system temp dir) so the postmortem survives the process.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 256


def _log(msg: str) -> None:
    print(f'\x1b[36m»\x1b[0m {msg}', file=sys.stderr, flush=True)


class FlightRecorder:
    """Bounded ring of `(ts, kind, fields)` scheduler events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 name: str = 'engine') -> None:
        if capacity < 1:
            raise ValueError('flight recorder capacity must be >= 1')
        self.capacity = int(capacity)
        self.name = name
        # Single-writer ring: only the engine scheduler thread writes
        # (SKY008-verified via the entry contract on record()); scrape
        # threads take racy snapshot READS, which ownership permits.
        self._buf: List[Optional[tuple]] = [None] * self.capacity  # stpu: owner[scheduler]
        self._n = 0  # total events ever recorded  # stpu: owner[scheduler]

    def record(self, kind: str, **fields: Any) -> None:  # stpu: entry[scheduler]
        """Append one event. ~Zero cost: a clock read, a tuple, one
        list slot write. Safe to call at every scheduler decision."""
        i = self._n
        self._buf[i % self.capacity] = (time.time(), kind,
                                        fields or None)
        self._n = i + 1

    @property
    def recorded(self) -> int:
        return self._n

    def events(self) -> List[Dict[str, Any]]:
        """Retained events, oldest first, each stamped with its
        absolute sequence number (so a dump shows how many events a
        wrapped ring dropped before its first row)."""
        n = self._n
        cap = self.capacity
        if n <= cap:
            rows = list(enumerate(self._buf[:n]))
        else:
            start = n % cap
            ring = self._buf[start:] + self._buf[:start]
            rows = [(n - cap + i, r) for i, r in enumerate(ring)]
        out = []
        for seq, row in rows:
            if row is None:  # racing a concurrent record(); skip
                continue
            ts, kind, fields = row
            ev = {'seq': seq, 'ts': ts, 'kind': kind}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def dump(self) -> Dict[str, Any]:
        events = self.events()
        return {
            'name': self.name,
            'capacity': self.capacity,
            'recorded': self._n,
            'dropped': max(0, self._n - self.capacity),
            'events': events,
        }

    def snapshot(self, reason: str = 'manual',
                 path: Optional[str] = None) -> Optional[str]:
        """Write the dump to a JSON file and return its path. Never
        raises — the recorder is a postmortem aid, not a correctness
        dependency — but a failed write is logged."""
        body = self.dump()
        body['reason'] = reason
        if path is None:
            root = os.environ.get('STPU_FLIGHT_DIR',
                                  tempfile.gettempdir())
            path = os.path.join(
                root, f'stpu-flight-{self.name}-{os.getpid()}-'
                      f'{reason}-{self._n}.json')
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f'{path}.tmp.{os.getpid()}'
            with open(tmp, 'w', encoding='utf-8') as f:
                json.dump(body, f)
            os.replace(tmp, path)
            return path
        except OSError as e:
            _log(f'flight recorder: snapshot {reason!r} to '
                         f'{path} failed ({e}); dump still available '
                         f'via /debug/flight.')
            return None
