"""Request-path errors of the serving engine (the port's own copy of
the ones that `skypilot_tpu/robustness/errors.py` defines for the
continuous-batching engine and the adapter registry; the HTTP layer
maps each to a status)."""


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
