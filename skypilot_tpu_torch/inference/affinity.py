"""Routing-affinity keys and the decode-peer ring (ports of
skypilot_tpu/inference/affinity.py:39-82 and of the consistent-hash
ring of skypilot_tpu/serve/load_balancing_policies.py:137-270).

The prefix cache keys KV pages by a chain hash: key_i = sha256 of ALL
prompt tokens through full page i, optionally salted with the adapter
identity. The replica plane's load balancer hashes the FIRST full-page
key into a consistent-hash ring, so requests sharing a system prompt
land on the replica that holds its pages. A prefill replica picks its
handoff peer, and an evacuating replica its migration peer, through
the same ring over the same endpoint strings, so a session's follow-ups
(routed by the load balancer) find the replica that imported its pages.
Only the ring is ported here; the rest of the balancing policy stays in
the replica plane.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, List, Optional

import numpy as np

#: The engine's default KV page size (models/batching.py).
DEFAULT_PAGE_SIZE = 16


def adapter_salt(model: Optional[str]) -> bytes:
    """Chain-key salt for a request served by adapter `model` (b'' for
    the base model, which keeps keys byte-identical to the unsalted
    scheme): the same prompt under two adapters never shares pages or
    an affinity group."""
    if not model:
        return b''
    return b'lora\x00' + str(model).encode('utf-8', 'replace')


def chain_keys(tokens: List[int], page_size: int,
               salt: bytes = b'') -> List[bytes]:
    """One key per FULL page, identical to `PrefixCache.chain_keys`;
    `salt` prefixes the hash chain (the adapter identity)."""
    keys = []
    h = hashlib.sha256()
    if salt:
        h.update(salt)
    for i in range(len(tokens) // page_size):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        h.update(np.asarray(chunk, np.int32).tobytes())
        keys.append(h.digest())
    return keys


def token_affinity_key(tokens: List[int],
                       page_size: int = DEFAULT_PAGE_SIZE,
                       salt: bytes = b'') -> Optional[str]:
    """Affinity key of a token prompt: its FIRST full-page chain key
    (hex); None for a prompt shorter than one page."""
    keys = chain_keys(tokens, page_size, salt=salt)
    if not keys:
        return None
    return keys[0].hex()


def _hash64(data: str) -> int:
    """Stable 64-bit ring position (a sha256 prefix, not Python's
    per-process salted hash())."""
    return int.from_bytes(hashlib.sha256(data.encode()).digest()[:8], 'big')


class PeerRing:
    """The consistent-hash ring of the reference's
    `PrefixAffinityPolicy` over a fixed set of endpoints: 64 virtual
    nodes per endpoint, a key owned by the first endpoint clockwise
    from its position."""

    VNODES = 64

    def __init__(self, endpoints: Iterable[str]) -> None:
        self.endpoints = list(endpoints)
        ring = sorted((_hash64(f'{ep}#{i}'), ep)
                      for ep in set(self.endpoints)
                      for i in range(self.VNODES))
        self._points = [p for p, _ in ring]
        self._owners = [ep for _, ep in ring]

    def affinity_target(self, key: Optional[str]) -> Optional[str]:
        """The endpoint that owns `key` (None for no key or no ring)."""
        if key is None or not self._points:
            return None
        start = bisect.bisect_left(self._points, _hash64(key))
        return self._owners[start % len(self._owners)]
