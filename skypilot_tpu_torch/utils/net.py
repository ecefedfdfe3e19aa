"""A free localhost port to bind later.

A port chosen by binding port 0 is an ephemeral one: until its user
binds it (a job's coordinator, a replica process seconds later), the
kernel may hand the same number to any port-0 bind or outgoing
connection on the host, and the late bind fails with EADDRINUSE. Ports
below the ephemeral range are never handed out so: they are free until
something binds that number explicitly.
"""
from __future__ import annotations

import random
import socket

#: Ports below the ephemeral range this module chooses from.
_SPAN = 12000


def _ephemeral_low() -> int:
    try:
        with open('/proc/sys/net/ipv4/ip_local_port_range') as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768    # Linux's default range starts here


def free_port() -> int:
    """A localhost port that is free now, below the ephemeral range
    (the range's own ports where there is no room below it)."""
    high = _ephemeral_low()
    low = max(1024, high - _SPAN)
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(low, high) if high - low >= 1000 else 0
        with socket.socket() as s:
            try:
                s.bind(('127.0.0.1', port))
            except OSError:
                continue
            return s.getsockname()[1]
    raise OSError(f'no free port in [{low}, {high})')
