#!/usr/bin/env python3
"""Where a KV page chain's time goes, on one GPU.

    python3 profile_kv_chain.py

Builds a KV pool at Llama-3-8B's geometry (32 layers, 8 KV heads, page
16, D 128; bf16 and int8 with their scales), fills it with random bytes
and times, for a 125-page chain (a 2003-token prompt's full pages) on
the engine's own code paths (`ContinuousBatchingEngine`'s gather and
scatter, `inference/kv_transfer.py`, `inference/http_server.py`'s
wire):

  - export: the gather into pinned host memory, then `pack_pages`;
  - import: `unpack_pages`, then the scatter into other pages (a host-
    to-device copy and `index_copy_` in place);
  - spill and restore: the pageable gather a spill makes, `split_pages`,
    `join_pages` and the scatter a restore makes;
  - the /kv/import wire, both ways: the reference's `json.dumps` of the
    base64 string and `json.loads` + `b64decode`, against the port's
    spliced `chain_body` / `split_chain_body` (checked byte-identical).

Each step runs three times (host clock around work that ends in a
synchronize); one JSON line per step with the three ms, then checks that
a chain exported, imported elsewhere and gathered again is the same
bytes, then the card (`nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`). Exits non-zero without a GPU.
"""
import base64
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PAGES = 125
REPEATS = 3


def timed(step, fn, repeats=REPEATS, **extra):
    out, ms = None, []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({'step': step, 'ms': ms, **extra}), flush=True)
    return out


def pool(kv_dtype):
    """A namespace the engine's gather / scatter methods run on: a pool
    of 400 pages at Llama-3-8B's geometry, random bytes in every leaf."""
    from skypilot_tpu_torch.models import registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.llama import PagedKVCache
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 2048),
                              kv_dtype=kv_dtype, kv_total_pages=400)
    cache = PagedKVCache(cfg, torch.device('cuda'))
    g = torch.Generator('cuda').manual_seed(0)
    for layer in cache.layers:
        for t in layer.values():
            t.view(torch.uint8).copy_(torch.randint(
                0, 256, t.view(torch.uint8).shape, generator=g,
                device='cuda', dtype=torch.uint8))
    ns = types.SimpleNamespace(cache=cache, device=torch.device('cuda'))
    ns._cache_leaves = lambda: ContinuousBatchingEngine._cache_leaves(ns)
    return ns


def profile(kv_dtype):
    from skypilot_tpu_torch.inference import kv_transfer as kvt
    from skypilot_tpu_torch.inference.http_server import (chain_body,
                                                          split_chain_body)
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine
    ns = pool(kv_dtype)
    src = list(range(1, PAGES + 1))
    dst = list(range(PAGES + 1, 2 * PAGES + 1))
    tag = {'pool': kv_dtype, 'pages': PAGES}
    meta = {'kind': 'kv_chain', 'kv_dtype': kv_dtype, 'page_size': 16,
            'keys': ['ab' * 32] * PAGES, 'salt': ''}
    blobs = timed('export_gather_pinned',
                  lambda: eng._gather_page_blobs(ns, src), **tag)
    data = timed('export_pack', lambda: kvt.pack_pages(blobs, meta),
                 payload_bytes=sum(t.numel() * t.element_size()
                                   for t in blobs.values()), **tag)
    _, got = timed('import_unpack', lambda: kvt.unpack_pages(data), **tag)
    timed('import_scatter',
          lambda: eng._scatter_page_blobs(ns, dst, got), **tag)
    back = eng._gather_page_blobs(ns, dst)
    same = all(np.array_equal(kvt.leaf_bytes(back[p]),
                              kvt.leaf_bytes(blobs[p])) for p in blobs)
    spilled = timed('spill_gather_pageable',
                    lambda: eng._gather_page_blobs(ns, src, pinned=False),
                    **tag)
    per_page = timed('spill_split_pages',
                     lambda: kvt.split_pages(spilled, PAGES), **tag)
    joined = timed('restore_join_pages',
                   lambda: kvt.join_pages(per_page), **tag)
    timed('restore_scatter',
          lambda: eng._scatter_page_blobs(ns, dst, joined), **tag)
    rest = {'path': '/generate',
            'request': {'tokens': [list(range(2003))],
                        'max_new_tokens': 32}}
    ref_body = timed('wire_encode_json_dumps', lambda: json.dumps(
        {'payload': base64.b64encode(data).decode(), **rest}).encode(),
        repeats=1, **tag)
    body = timed('wire_encode_spliced', lambda: chain_body(data, rest),
                 repeats=1, body_bytes=len(ref_body), **tag)
    decoded = timed('wire_decode_json_loads', lambda: base64.b64decode(
        json.loads(ref_body)['payload']), repeats=1, **tag)
    req, spliced = timed('wire_decode_spliced',
                         lambda: split_chain_body(body), repeats=1, **tag)
    print(json.dumps({'check': kv_dtype, 'roundtrip_bytes_equal': same,
                      'spliced_body_equals_json': body == ref_body,
                      'spliced_decode_equal': spliced == decoded == data
                      and req == rest}), flush=True)
    return same and body == ref_body and spliced == data and req == rest


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_kv_chain: no CUDA device is available',
              file=sys.stderr)
        return 1
    from skypilot_tpu_torch.device import card_description
    torch.cuda.set_device(0)
    ok = all([profile('bf16'), profile('int8')])
    print(card_description(), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
