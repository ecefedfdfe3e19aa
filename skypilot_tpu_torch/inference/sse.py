"""SSE pass-through piping for the replica's proxies (port of
skypilot_tpu/inference/sse.py `pipe`).

A prefill replica proxies its decode peer's `text/event-stream` body to
the waiting client, and a migrating replica the tail of a session from
its new owner. Bytes are forwarded as they ARRIVE: `read1(n)` returns
whatever the socket holds (blocking only when it holds nothing), so a
token frame of a few dozen bytes is not held back until n bytes or EOF.
A truncated pipe (the upstream died, or the client went away) ends the
pipe and is reported in the result, never raised: a proxied stream that
breaks mid-flight must look to the client like a direct replica death.

The upstream is an `http.client.HTTPResponse` (the port does not use
`requests`, whose streamed response the reference pipes).
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple

#: read1 budget per call: an upper bound, not a wait target.
_CHUNK = 8192


def pipe(upstream: Any, wfile: Any) -> Tuple[bool, Optional[float]]:
    """Pipe `upstream` to `wfile` as bytes arrive. Returns
    `(reached_eof, first_at)`: `first_at` is the `time.monotonic()`
    instant the first body bytes arrived (None for an empty body)."""
    first_at: Optional[float] = None
    try:
        while True:
            chunk = upstream.read1(_CHUNK)
            if not chunk:
                return True, first_at
            if first_at is None:
                first_at = time.monotonic()
            wfile.write(chunk)
            wfile.flush()
    except Exception as e:  # pylint: disable=broad-except
        # Upstream death or client disconnect mid-stream: a bounded
        # truncation; the caller decides whether and how to log.
        print(f'sse: pipe truncated ({type(e).__name__}: {e})', flush=True)
        return False, first_at
