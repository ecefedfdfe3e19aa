"""KV-page wire format and the tiered prefix-cache spill storage (port
of skypilot_tpu/inference/kv_transfer.py).

Two consumers share one page encoding:

  - disaggregated prefill/decode handoff and live migration: an engine
    exports a prompt's (or a session's) full-page KV chain
    (`ContinuousBatchingEngine.export_chain`) and a peer imports it
    into its own pool (`import_chain`), so it decodes without paying
    the prefill again;
  - the tiered prefix cache: pages the cache would drop under pool
    pressure spill into a bounded host-RAM LRU (`HostSpillTier`), with
    an optional local cold directory behind it (`ColdTier`); a later
    chain-key hit restores the exact bytes.

The layout is the reference's, byte for byte: MAGIC ++ u64 big-endian
header length ++ header JSON (sorted keys) ++ payload. The header holds
the chain keys (hex), the adapter salt, the page geometry and one
(path, dtype, shape) record per cache leaf, leaves in `sorted()` order;
the payload is each leaf's page-major bytes in that order. int8 pages
travel as int8 beside their f32 scales, so a round trip is
bit-identical.

Leaves are CPU torch tensors here (the reference's are numpy arrays):
torch has bfloat16, so a bf16 leaf keeps its true dtype without
ml_dtypes, and its dtype name on the wire is the reference's
'bfloat16'. A cold directory is local only: gs:// prefixes, which the
reference moves with gsutil, are refused (ROADMAP A6(c)).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: Wire magic + version (the reference's): an importer never guesses at
#: bytes from a different build.
MAGIC = b'STPUKV1\n'

#: Host budget put in front of a cold directory given without one.
DEFAULT_HOST_BYTES = 64 * 1024 * 1024

#: Refusal of a remote cold tier (the reference moves gs:// pages with
#: gsutil).
REMOTE_COLD_DIR = ('--kv-cold-dir: remote (gs://) cold tiers are not '
                   'ported yet (ROADMAP A6(c)); give a local directory')

def _dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name ('bfloat16', 'float32',
    'int8', ...)."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f'unsupported KV chain leaf dtype {name!r}')
    return dtype


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's names, 'bfloat16' as
    ml_dtypes names it)."""
    return str(dtype).replace('torch.', '')


def leaf_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a uint8 numpy view (any dtype, bf16 too)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def pack_pages(blobs: Dict[str, torch.Tensor],
               meta: Dict[str, Any]) -> bytes:
    """Serialize page-major per-leaf CPU tensors + metadata. `blobs` maps
    a cache leaf path to a tensor whose LEADING axis is the page index;
    every leaf must agree on the page count. `meta` carries kv_dtype /
    page_size / keys / salt; this adds the leaf table."""
    leaves = []
    tensors = []
    n_pages = None
    for path in sorted(blobs):
        t = blobs[path]
        if n_pages is None:
            n_pages = t.shape[0]
        elif t.shape[0] != n_pages:
            raise ValueError(
                f'leaf {path} has {t.shape[0]} pages, expected '
                f'{n_pages} (all leaves must cover the same chain)')
        leaves.append({'path': path, 'dtype': dtype_name(t.dtype),
                       'shape': list(t.shape)})
        tensors.append(t)
    header = dict(meta)
    header['version'] = 1
    header['n_pages'] = int(n_pages or 0)
    header['leaves'] = leaves
    hjson = json.dumps(header, sort_keys=True).encode()
    # One host copy of the payload: join reads each leaf's buffer.
    return b''.join([MAGIC, len(hjson).to_bytes(8, 'big'), hjson]
                    + [leaf_bytes(t) for t in tensors])


def unpack_pages(data: bytes) -> Tuple[Dict[str, Any],
                                       Dict[str, torch.Tensor]]:
    """Inverse of `pack_pages`: (header, {path: CPU tensor}). The
    tensors view `data` (no copy) and must not be written. Raises
    ValueError on anything that is not a well-formed chain; callers
    treat that as a failed transfer, never a crash."""
    if bytes(data[:len(MAGIC)]) != MAGIC:
        raise ValueError('not a KV page chain (bad magic)')
    off = len(MAGIC)
    hlen = int.from_bytes(data[off:off + 8], 'big')
    off += 8
    try:
        meta = json.loads(bytes(data[off:off + hlen]))
    except ValueError as e:
        raise ValueError(f'corrupt KV chain header: {e}') from e
    off += hlen
    version = meta.get('version') if isinstance(meta, dict) else None
    if version != 1:
        raise ValueError(f'unsupported KV chain version {version!r}')
    blobs: Dict[str, torch.Tensor] = {}
    for leaf in meta.get('leaves', []):
        dtype = _dtype_of(leaf['dtype'])
        shape = tuple(int(s) for s in leaf['shape'])
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if off + nbytes > len(data):
            raise ValueError(
                f'truncated KV chain payload at leaf {leaf["path"]}')
        if count:
            with warnings.catch_warnings():
                # A bytes payload is read-only; the views are never
                # written (every consumer copies them to the device).
                warnings.simplefilter('ignore', UserWarning)
                t = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=off)
        else:
            t = torch.empty(0, dtype=dtype)
        blobs[leaf['path']] = t.reshape(shape)
        off += nbytes
    if off != len(data):
        raise ValueError(
            f'{len(data) - off} trailing bytes after KV chain payload')
    return meta, blobs


def split_pages(blobs: Dict[str, torch.Tensor], n_pages: int
                ) -> List[Dict[str, torch.Tensor]]:
    """Page-major chain arrays -> one {path: row} blob per page (the
    spill tier's unit)."""
    return [{path: arr[i] for path, arr in blobs.items()}
            for i in range(n_pages)]


def join_pages(page_blobs: List[Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """Inverse of `split_pages`: stack per-page blobs back into the
    page-major chain layout (the restore / import scatter input)."""
    assert page_blobs
    return {path: torch.stack([blob[path] for blob in page_blobs])
            for path in page_blobs[0]}


def page_blob_nbytes(blob: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() * t.element_size() for t in blob.values()))


def _log(msg: str) -> None:
    print(msg, flush=True)


class ColdTier:
    """Content-addressed page blobs in a local directory: the cache's
    coldest tier, for long shared system prompts that should survive a
    process restart. Writes are atomic (`os.replace`); a failed write
    drops the page and a failed read is a miss: the tier is an
    optimization, never a correctness dependency."""

    def __init__(self, root: str) -> None:
        if root.startswith('gs://'):
            raise ValueError(REMOTE_COLD_DIR)
        self.root = root.rstrip('/')
        os.makedirs(self.root, exist_ok=True)
        self.writes = 0
        self.reads = 0
        self.errors = 0

    def _path(self, key: bytes) -> str:
        return f'{self.root}/{key.hex()}.kvpage'

    def put(self, key: bytes, blob: Dict[str, torch.Tensor]) -> None:
        data = pack_pages(join_pages([blob]), {'kind': 'cold_page'})
        tmp = f'{self._path(key)}.tmp.{os.getpid()}'
        try:
            with open(tmp, 'wb') as f:
                f.write(data)
            os.replace(tmp, self._path(key))
            self.writes += 1
        except OSError as e:
            self.errors += 1
            _log(f'kv cold tier: write of page {key.hex()[:12]} failed '
                 f'({e}); dropping.')

    def get(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        try:
            try:
                with open(self._path(key), 'rb') as f:
                    data = f.read()
            except FileNotFoundError:
                return None
            _meta, blobs = unpack_pages(data)
            self.reads += 1
            return split_pages(blobs, 1)[0]
        except (OSError, ValueError) as e:
            self.errors += 1
            _log(f'kv cold tier: read of page {key.hex()[:12]} failed '
                 f'({e}); treating as a miss.')
            return None

    def stats(self) -> Dict[str, Any]:
        return {'root': self.root, 'writes': self.writes,
                'reads': self.reads, 'errors': self.errors}


class HostSpillTier:
    """Bounded host-RAM LRU of evicted prefix-cache pages, keyed by
    chain key. `put` is called by `PrefixCache.evict_into` on the
    scheduler thread with the page's exact device bytes; `get` restores
    them on a later chain hit. Pages LRU-evicted from host RAM fall
    through to the cold tier when one is configured, else they are
    dropped. Thread-safe: /stats reads the counters from HTTP threads."""

    def __init__(self, capacity_bytes: int,
                 cold: Optional[ColdTier] = None) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self.cold = cold
        self._lock = threading.Lock()
        self._pages: 'collections.OrderedDict[bytes, Dict[str, torch.Tensor]]' = \
            collections.OrderedDict()
        self.bytes = 0
        self.spilled_pages = 0      # puts (from evictions)
        self.restored_pages = 0     # gets that hit (host or cold)
        self.cold_demotions = 0     # host LRU -> cold tier
        self.dropped_pages = 0      # host LRU -> nowhere
        self.lookups = 0
        self.hits = 0

    def put(self, key: bytes, blob: Dict[str, torch.Tensor]) -> None:
        nbytes = page_blob_nbytes(blob)
        with self._lock:
            old = self._pages.pop(key, None)
            if old is not None:
                self.bytes -= page_blob_nbytes(old)
            self._pages[key] = blob
            self.bytes += nbytes
            self.spilled_pages += 1
            demote = []
            while self.bytes > self.capacity_bytes and \
                    len(self._pages) > 1:
                victim_key, victim = self._pages.popitem(last=False)
                self.bytes -= page_blob_nbytes(victim)
                demote.append((victim_key, victim))
        for victim_key, victim in demote:
            if self.cold is not None:
                self.cold_demotions += 1
                self.cold.put(victim_key, victim)
            else:
                self.dropped_pages += 1

    def get(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        with self._lock:
            self.lookups += 1
            blob = self._pages.get(key)
            if blob is not None:
                self._pages.move_to_end(key)
                self.hits += 1
                self.restored_pages += 1
                return blob
        if self.cold is None:
            return None
        blob = self.cold.get(key)
        if blob is None:
            return None
        with self._lock:
            self.hits += 1
            self.restored_pages += 1
        # Promote back to the host tier (it is hot again).
        self.put(key, blob)
        with self._lock:
            self.spilled_pages -= 1  # the promotion is not a spill
        return blob

    def resident_pages(self) -> int:
        with self._lock:
            return len(self._pages)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            body = {
                'capacity_bytes': self.capacity_bytes,
                'bytes': self.bytes,
                'resident_pages': len(self._pages),
                'spilled_pages': self.spilled_pages,
                'restored_pages': self.restored_pages,
                'lookups': self.lookups,
                'hits': self.hits,
                'hit_rate': round(self.hits / max(self.lookups, 1), 4),
                'cold_demotions': self.cold_demotions,
                'dropped_pages': self.dropped_pages,
            }
        if self.cold is not None:
            body['cold'] = self.cold.stats()
        return body


def make_spill_tier(spill_bytes: int, cold_dir: Optional[str] = None
                    ) -> Optional[HostSpillTier]:
    """The serve_lm --kv-spill-bytes / --kv-cold-dir wiring: a cold dir
    without a host budget still gets a small host tier in front (the
    cold tier alone would make every restore a file read)."""
    if not spill_bytes and not cold_dir:
        return None
    cold = ColdTier(cold_dir) if cold_dir else None
    return HostSpillTier(spill_bytes or DEFAULT_HOST_BYTES, cold=cold)
