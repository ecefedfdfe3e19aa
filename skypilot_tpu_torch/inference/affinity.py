"""Routing-affinity keys and the decode-peer ring (ports of
skypilot_tpu/inference/affinity.py and of the consistent-hash ring of
skypilot_tpu/serve/load_balancing_policies.py:137-270).

The prefix cache keys KV pages by a chain hash: key_i = sha256 of ALL
prompt tokens through full page i, optionally salted with the adapter
identity. The replica plane's load balancer hashes the FIRST full-page
key into a consistent-hash ring, so requests sharing a system prompt
land on the replica that holds its pages. A prefill replica picks its
handoff peer, and an evacuating replica its migration peer, through
the same ring over the same endpoint strings, so a session's follow-ups
(routed by the load balancer) find the replica that imported its pages.
The ring here serves the replicas; the load balancer's own policy
(serve/load_balancing_policies.py) keeps its ring, with the same
positions. Text endpoints have no token ids at the load balancer, so
their key hashes the prompt's leading characters.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

#: The engine's default KV page size (models/batching.py).
DEFAULT_PAGE_SIZE = 16

#: Leading characters hashed for text-prompt affinity. Long enough to
#: span a realistic system prompt's distinctive part, short enough
#: that per-user suffixes (appended after the template) don't split
#: the group.
TEXT_PREFIX_CHARS = 256


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


def text_affinity_key(text: str, salt: bytes = b'') -> Optional[str]:
    if not text:
        return None
    return hashlib.sha256(
        salt + text[:TEXT_PREFIX_CHARS].encode('utf-8',
                                               'replace')).hexdigest()


def request_affinity_key(path: str, body: Dict[str, Any],
                         page_size: int = DEFAULT_PAGE_SIZE
                         ) -> Optional[str]:
    """Extract the routing key from a generation request body, by
    endpoint shape. The body's `model` field (adapter selection)
    salts the key, so a tenant's requests pin to the replica holding
    both its KV pages AND its hot-loaded adapter — and never share an
    affinity group with another tenant's identical prompt. Returns
    None for anything unrecognized — the LB then routes by load,
    never errors."""
    try:
        salt = adapter_salt(body.get('model'))
        if path in ('/generate', '/v1/generate'):
            tokens = body.get('tokens') or []
            if tokens and isinstance(tokens[0], list):
                tokens = tokens[0]
            return token_affinity_key([int(t) for t in tokens],
                                      page_size, salt=salt)
        if path in ('/generate_text', '/v1/generate_text'):
            prompts = body.get('prompts', '')
            if isinstance(prompts, list):
                prompts = prompts[0] if prompts else ''
            return text_affinity_key(str(prompts), salt=salt)
        if path == '/v1/completions':
            prompt = body.get('prompt', '')
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ''
            return text_affinity_key(str(prompt), salt=salt)
        if path == '/v1/chat/completions':
            messages = body.get('messages') or []
            # The system message IS the shared prefix; chats without
            # one key on their first message (session affinity).
            for message in messages:
                if message.get('role') == 'system':
                    return text_affinity_key(
                        str(message.get('content', '')), salt=salt)
            if messages:
                return text_affinity_key(
                    str(messages[0].get('content', '')), salt=salt)
    except (TypeError, ValueError, KeyError, IndexError):
        # Malformed bodies are the replica's 400 to give, not the
        # LB's 500: route keyless.
        return None
    return None


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
