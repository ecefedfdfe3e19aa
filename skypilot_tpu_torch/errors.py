"""Error types of the port: its own copies of the ones that
`skypilot_tpu/robustness/errors.py` defines for the continuous-batching
engine, the adapter registry and live KV-chain migration (the HTTP
layer maps each to a status), for checkpoint restore
(parallel/checkpoints.py) and, from `skypilot_tpu/exceptions.py`, the
service-spec refusal of the serving fleet."""


class DeadlineExceededError(Exception):
    """A request outlived its deadline: expired while queued, or
    reaped mid-decode by the engine's deadline sweep (HTTP 504)."""


class QueueSaturatedError(Exception):
    """Admission control shed this request: the bounded queue is full
    (HTTP 429 with a Retry-After hint)."""

    def __init__(self, message: str, retry_after_s: float = 1.0
                 ) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class EngineDeadError(Exception):
    """The engine's scheduler thread died; submit fails fast and
    pending futures resolve with this (HTTP 503)."""


class AdapterNotFoundError(Exception):
    """The request named a model/adapter the serving process does not
    have: not the base model and not in the adapter registry's
    inventory (HTTP 404, OpenAI code `model_not_found`)."""


class AdapterLoadError(Exception):
    """A registered adapter failed to load onto the device (corrupt
    artifact, shape/rank mismatch with the serving store). The request
    fails 503; the engine and every other adapter keep serving."""


class SessionMigratedError(Exception):
    """The engine evacuated this request's slot (drain, preemption
    notice or rebalance): the future resolves with this instead of a
    result, carrying in `record` what the HTTP layer needs to finish
    the session elsewhere: the committed tokens (prompt + generated so
    far), the generation budget, the sampling knobs and the packed KV
    chain of the committed full pages. The HTTP thread that owns the
    client ships the chain to a peer and proxies the tail; any failure
    resumes locally on the still-warm pages (HTTP 503 only when both
    fail)."""

    def __init__(self, record: dict) -> None:
        super().__init__(
            f'session migrated after '
            f'{len(record.get("tokens") or []) - int(record.get("prompt_len", 0))}'
            f' generated tokens (reason: {record.get("reason", "")})')
        self.record = record


class CheckpointNotFoundError(Exception):
    """No checkpoint exists to restore (empty or absent directory, or
    an explicitly requested step that was never written). Typed, so
    the recovery path can tell "start fresh" from "data lost"."""


class CheckpointCorruptionError(Exception):
    """A checkpoint failed its sha256 manifest verification (torn
    write, truncated upload, bit rot). Raised per step during restore;
    the manager falls back to the newest step that does verify, and
    raises this only when every candidate is corrupt."""


class InvalidTaskYAMLError(Exception):
    """A service spec the serving fleet refuses (the reference's
    `skypilot_tpu.exceptions.InvalidTaskYAMLError`, raised by
    `serve/service_spec.py` with the same messages)."""
