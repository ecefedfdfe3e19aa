"""Blocking HTTP calls of the replica plane over `http.client` (the
reference makes them with `requests`, which the port does not use and
the card's machine lacks): the manager's scrapes, the controller's
POSTs and the load balancer's and stub's proxied requests.

`request` returns the open response with its headers read and its body
not, like `requests.post(..., stream=True)`: the caller reads it whole
(`read()`), as it arrives (`read1()`, what `inference/sse.pipe` takes)
or closes it. A `(connect, read)` pair of timeouts works as in
`requests`: the first bounds the connect, the second every later read.
"""
from __future__ import annotations

import http.client
import json
import urllib.parse
from typing import Any, Dict, Optional, Tuple

#: What a failed call raises: refused or reset connections and timeouts
#: (OSError) and malformed or cut responses (HTTPException) — the
#: port's counterpart of `requests.RequestException`.
ERRORS = (OSError, http.client.HTTPException)


class Response:
    """An open response and the connection it came on."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse) -> None:
        self._conn = conn
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers

    def read(self) -> bytes:
        return self._resp.read()

    def read1(self, n: int) -> bytes:
        return self._resp.read1(n)

    def json(self) -> Any:
        return json.loads(self.read())

    def close(self) -> None:
        self._resp.close()
        self._conn.close()

    def __enter__(self) -> 'Response':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def request(method: str, url: str, body: Optional[bytes] = None,
            headers: Optional[Dict[str, str]] = None,
            timeout: Tuple[float, float] = (3.0, 660.0)) -> Response:
    """`method` `url` with `body`; raises one of ERRORS on a failed
    connect, send or header read."""
    parts = urllib.parse.urlsplit(url)
    path = parts.path or '/'
    if parts.query:
        path += '?' + parts.query
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=timeout[0])
    try:
        conn.connect()
        conn.sock.settimeout(timeout[1])
        conn.request(method, path, body=body, headers=headers or {})
        return Response(conn, conn.getresponse())
    except BaseException:
        conn.close()
        raise


def get_json(url: str, timeout: float) -> Tuple[int, Dict[str, Any]]:
    """(status, JSON body or {}) of GET `url`."""
    with request('GET', url, timeout=(timeout, timeout)) as resp:
        data = resp.read()
    try:
        body = json.loads(data)
    except ValueError:
        body = {}
    return resp.status_code, body if isinstance(body, dict) else {}


def post_json(url: str, body: Any, timeout: float = 3.0) -> int:
    """Status of POST `url` with the JSON `body` (its answer read and
    dropped)."""
    with request('POST', url, json.dumps(body).encode(),
                 {'Content-Type': 'application/json'},
                 timeout=(timeout, timeout)) as resp:
        resp.read()
    return resp.status_code
