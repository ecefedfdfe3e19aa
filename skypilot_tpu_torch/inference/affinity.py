"""Adapter identity in prefix-cache chain keys (port of
`adapter_salt`, skypilot_tpu/inference/affinity.py:39-49).

KV pages are adapter-dependent once LoRA touches the k/v projections,
so the engine's `PrefixCache.chain_keys` are salted with the adapter:
the same prompt under two adapters never shares pages (tenant
isolation). The empty salt (base model) keeps keys byte-identical to
the unsalted scheme, which the reference's load balancer routes on.
"""
from __future__ import annotations

from typing import Optional


def adapter_salt(model: Optional[str]) -> bytes:
    """Chain-key salt for a request served by adapter `model`
    (b'' for the base model)."""
    if not model:
        return b''
    return b'lora\x00' + str(model).encode('utf-8', 'replace')
