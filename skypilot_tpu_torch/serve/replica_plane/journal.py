"""Durable fleet journal: the control plane's crash-only memory (port
of skypilot_tpu/serve/replica_plane/journal.py; the same JSONL lines, so
a journal written by either package replays in the other).

`FleetController`/`ReplicaManager` hold all fleet state in memory;
without a journal, a controller crash orphans every live `serve_lm`
process — no routing, no way to reattach, and the only recourse is
killing healthy replicas that were mid-stream. The journal fixes
that with the cheapest durable structure there is: an append-only
JSONL file of replica lifecycle events, fsync'd per append (events
are rare — spawns and state TRANSITIONS, never per-scrape), so the
last journaled state survives a SIGKILL of the controller at any
instruction.

Event grammar (one JSON object per line):

  {"event": "spawn",     ...full ReplicaRecord fields...}
  {"event": "snapshot",  ...full ReplicaRecord fields...}   # compaction
  {"event": "state",     "replica_id": N, "state": "READY", "ts": ...}
  {"event": "terminate", "replica_id": N, "ts": ...}

Replay folds the event stream into the last-known `ReplicaRecord`
per replica and DROPS terminal ones (FAILED/SHUTDOWN/terminated):
what remains is exactly the set of processes that may still be
alive and serving — the adoption candidates (`ReplicaManager.adopt`
verifies each by pid liveness + the `/stats`-echoed instance UUID,
which defeats pid/port reuse).

Crash safety:
  - a torn final line (controller died mid-append) is detected by
    the JSON parse failing and ignored — every *complete* line is
    intact because appends are written whole and fsync'd;
  - compaction never rewrites in place: the live records are
    written as `snapshot` events to a temp file in the same
    directory, fsync'd, and atomically renamed over the journal
    (readers see either the old file or the new one, never a mix);
  - replaying a compacted journal yields a byte-identical state map
    to replaying the original (tested).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from skypilot_tpu_torch.utils import ux_utils

#: Lifecycle states that end a replica's story: a record left in one
#: of these (or explicitly terminated) is not an adoption candidate.
_TERMINAL_STATES = frozenset(('FAILED', 'SHUTDOWN'))

#: Full-record events (create/overwrite on replay).
_RECORD_EVENTS = frozenset(('spawn', 'snapshot'))


@dataclasses.dataclass
class ReplicaRecord:
    """One replica's last journaled state — everything adoption
    needs to find, verify, and reattach (or drain) the process."""
    replica_id: int
    port: int
    endpoint: str
    instance_uuid: str
    state: str
    pid: Optional[int] = None
    # Disaggregated pool membership ('' = unified/decode-only fleet;
    # pre-role journals replay with the default).
    role: str = ''
    # Spot placement: the zone this replica models and its hourly
    # price (zero for on-demand / zoneless fleets). Journals written
    # before these fields replay with the defaults — a restarted
    # controller adopts old replicas as zoneless rather than
    # refusing the journal.
    zone: str = ''
    price_per_hour: float = 0.0

    def to_fields(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_fields(cls, fields: Dict[str, Any]) -> 'ReplicaRecord':
        return cls(replica_id=int(fields['replica_id']),
                   port=int(fields['port']),
                   endpoint=str(fields['endpoint']),
                   instance_uuid=str(fields.get('instance_uuid', '')),
                   state=str(fields.get('state', 'STARTING')),
                   pid=(int(fields['pid'])
                        if fields.get('pid') is not None else None),
                   role=str(fields.get('role', '')),
                   zone=str(fields.get('zone', '')),
                   price_per_hour=float(
                       fields.get('price_per_hour', 0.0) or 0.0))


class FleetJournal:
    """Append-only, fsync'd JSONL journal with atomic compaction.

    Thread-safe: the manager's scrape pass, drain threads, and the
    controller tick all append through one lock. The file handle is
    opened lazily and kept open between appends (one open + fsync
    per event, not per byte)."""

    def __init__(self, path: str, compact_every: int = 512) -> None:
        self.path = os.path.abspath(path)
        self.compact_every = compact_every
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._appends_since_compact = 0

    # -- writing ---------------------------------------------------------
    def append(self, event: str, **fields: Any) -> None:
        """Durably append one event: the call returns only after the
        line is on disk (write + flush + fsync). Auto-compacts every
        `compact_every` appends so a long-running fleet's journal
        stays bounded by live-replica count, not uptime."""
        record = {'event': event, 'ts': time.time()}
        record.update(fields)
        line = json.dumps(record, sort_keys=True) + '\n'
        with self._lock:
            self._append_line_locked(line)
            self._appends_since_compact += 1
            if self._appends_since_compact >= self.compact_every:
                self._compact_locked()

    def _append_line_locked(self, line: str) -> None:
        if self._fh is None:
            # Text append mode: a crash between open and write leaves
            # the file unchanged; a crash mid-write leaves a torn
            # final line replay ignores.
            self._fh = open(self.path, 'a', encoding='utf-8')
        self._fh.write(line)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    # -- replay ----------------------------------------------------------
    def replay(self) -> Dict[int, ReplicaRecord]:
        """Fold the journal into live records (terminal ones
        dropped). Tolerates a torn final line and skips (with a log)
        any malformed interior line rather than refusing to start —
        a crash-only control plane must come up from whatever the
        crash left behind."""
        return replay_journal(self.path)

    # -- compaction ------------------------------------------------------
    def compact(self) -> None:
        """Rewrite the journal as one `snapshot` line per live
        record, atomically (temp file + fsync + rename). State after
        replay is identical before and after."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        live = replay_journal(self.path)
        tmp = f'{self.path}.compact.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            for rid in sorted(live):
                record = {'event': 'snapshot', 'ts': time.time()}
                record.update(live[rid].to_fields())
                f.write(json.dumps(record, sort_keys=True) + '\n')
            f.flush()
            os.fsync(f.fileno())
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        os.replace(tmp, self.path)
        # fsync the directory so the rename itself is durable.
        dir_fd = os.open(os.path.dirname(self.path), os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._appends_since_compact = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def replay_journal(path: str) -> Dict[int, ReplicaRecord]:
    """Module-level replay (adoption reads the journal of a DEAD
    controller — no FleetJournal instance needed)."""
    records: Dict[int, ReplicaRecord] = {}
    terminated = set()
    try:
        with open(path, 'r', encoding='utf-8') as f:
            lines = f.readlines()
    except FileNotFoundError:
        return {}
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except ValueError as e:
            if i == len(lines) - 1:
                # Torn final line: the controller died mid-append.
                # Everything before it is intact (fsync-per-line).
                ux_utils.log(f'fleet journal {path}: ignoring torn '
                             f'final line ({e}).')
            else:
                ux_utils.error(f'fleet journal {path}: skipping '
                               f'malformed line {i + 1} ({e}).')
            continue
        name = event.get('event')
        try:
            if name in _RECORD_EVENTS:
                rec = ReplicaRecord.from_fields(event)
                records[rec.replica_id] = rec
                terminated.discard(rec.replica_id)
            elif name == 'state':
                rid = int(event['replica_id'])
                if rid in records:
                    records[rid].state = str(event['state'])
            elif name == 'terminate':
                terminated.add(int(event['replica_id']))
            else:
                ux_utils.log(f'fleet journal {path}: unknown event '
                             f'{name!r} at line {i + 1}; skipped.')
        except (KeyError, TypeError, ValueError) as e:
            ux_utils.error(f'fleet journal {path}: bad {name!r} '
                           f'event at line {i + 1} ({e}); skipped.')
    return {rid: rec for rid, rec in records.items()
            if rid not in terminated and
            rec.state not in _TERMINAL_STATES}


def max_journaled_id(path: str) -> int:
    """Highest replica id the journal has EVER named (including
    terminated ones): the restarted manager resumes its id counter
    above this so replica ids stay unique across controller
    generations (id reuse would make journal replay ambiguous)."""
    highest = 0
    try:
        with open(path, 'r', encoding='utf-8') as f:
            for line in f:
                try:
                    event = json.loads(line)
                except ValueError:
                    continue  # torn/malformed: replay already logs
                rid = event.get('replica_id')
                if isinstance(rid, int):
                    highest = max(highest, rid)
    except FileNotFoundError:
        return 0
    return highest
