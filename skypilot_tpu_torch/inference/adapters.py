"""Adapter registry: hot-loadable multi-LoRA serving state (port of
skypilot_tpu/inference/adapters.py `AdapterRegistry`).

One registry per serving process. Two halves under one lock:

  - INVENTORY: the artifact directory (`serve_lm --adapter-dir`) is
    scanned for `<name>/adapter_config.json` subdirectories (the
    reference's `train_lm --lora` output, models/lora.py). A lookup
    miss rescans, so an artifact dropped into the directory becomes
    servable without a restart (hot-load). `gs://` dirs are synced to
    a local cache with one `gsutil rsync` per (re)scan.
  - DEVICE STORE: `--max-adapters` stacked slots of A/B factors on the
    model's device, `{'layer_i': {target: {'a': [N+1, d_in, R], 'b':
    [N+1, R, d_out]}}}` in the model's dtype. Row 0 is all zeros (the
    base model), rows 1..N hold loaded adapters. The engine passes the
    whole stack plus per-slot adapter ids into the forward. A load
    writes one row in place (`copy_`); the stack is never reallocated.

Residency: `acquire()` pins (refcounts) an adapter while an engine slot
decodes with it; unpinned adapters stay resident (LRU) and are evicted
only when a load needs their slot. A pinned adapter is never evicted:
`acquire` returns None instead and the engine re-queues the request.
Artifacts of rank < the store rank are zero-padded; `alpha/rank` is
folded into B in f32 before the cast to the store dtype, so the engine
applies scale 1 and the stacks are byte-identical to the reference's.

Every load runs the `adapters.load` fault point first (raise or drop
fails that load as AdapterLoadError, 503 for that request only), and
loads, evictions, load failures, requests and tokens per adapter feed
the catalog's `skypilot_serving_adapter*` series, as the reference's
do.

On a serving grid (`mesh=`, the grid of a `parallel/serving.py`
GridModel) the store is one stack per tensor rank, layer i's factors on
its shard's device, split as its projection's weight
(`serving.lora_factor_axes`): the QKV and gate / up deltas' B factors
by output columns, `wo` / `w_down`'s A factors by input rows, the other
factor whole. `model_lora()` is then {'scale', 'shards': [stack a
rank]}, which the grid model's forward takes.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import subprocess
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.errors import AdapterLoadError, AdapterNotFoundError
from skypilot_tpu_torch.inference import affinity
from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.observability import catalog as _obs
from skypilot_tpu_torch.robustness import faults


class AdapterRegistry:
    """Registry + device store. Thread-safe: the engine's scheduler
    thread acquires/releases, HTTP threads read inventory/stats."""

    def __init__(self, adapter_dir: str, model, *,
                 max_adapters: int = 8, max_rank: int = 0,
                 mesh=None) -> None:
        if not lora_lib.supports(model):
            raise ValueError(
                f'{type(model).__name__} has no LoRA forward path; '
                f'multi-LoRA serving supports the Llama family '
                f'(models/lora.py)')
        if max_adapters < 1:
            raise ValueError(
                f'max_adapters must be >= 1, got {max_adapters}')
        if mesh is not getattr(model, 'grid', None):
            raise ValueError('mesh= is the grid of the model the adapters '
                             'serve (a parallel/serving.py GridModel), and '
                             'a grid model needs it')
        self.model = model
        self.mesh = mesh
        self.cfg = model.config
        self.device = model.device
        self.max_adapters = int(max_adapters)
        self._dir = adapter_dir
        self._local_dir = adapter_dir  # set by _sync_remote for gs://
        self._lock = threading.Lock()
        # Inventory (disk): name -> adapter_config dict.
        self._inventory: Dict[str, Dict[str, Any]] = {}
        # Device store bookkeeping. Slots are 1-based (row 0 = base).
        self._loaded: Dict[str, int] = {}
        self._slot_name: Dict[int, str] = {}
        self._refs: Dict[int, int] = {}
        self._lru: 'collections.OrderedDict[str, None]' = \
            collections.OrderedDict()
        self._free: List[int] = list(range(self.max_adapters, 0, -1))
        # One factor tree a tensor rank, built on the first load.
        self._stack: Optional[List[Dict[str, Any]]] = None
        self._rank = int(max_rank)   # 0 = fixed by the scanned max
        self._targets: Tuple[str, ...] = ()
        self.loads = 0
        self.evictions = 0
        self.load_failures = 0
        self.requests: Dict[str, int] = {}
        self.tokens: Dict[str, int] = {}
        self._m_loaded = _obs.gauge('skypilot_serving_adapters_loaded')
        self._m_load_failures = _obs.counter(
            'skypilot_serving_adapter_load_failures_total')
        with self._lock:
            self._scan_locked()

    # -- inventory ----------------------------------------------------------
    def _sync_remote_locked(self) -> None:
        """gs:// artifact dirs sync into a content-addressed local
        cache; local dirs are used as-is."""
        if not self._dir.startswith('gs://'):
            return
        cache = os.path.join(
            os.path.expanduser('~/.cache/skypilot_tpu/adapters'),
            hashlib.sha256(self._dir.encode()).hexdigest()[:16])
        os.makedirs(cache, exist_ok=True)
        try:
            subprocess.run(
                ['gsutil', '-m', 'rsync', '-r', self._dir, cache],
                check=True, capture_output=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as e:
            raise AdapterLoadError(
                f'cannot sync adapter dir {self._dir}: '
                f'{type(e).__name__}: {e}') from e
        self._local_dir = cache

    def _scan_locked(self) -> None:
        self._sync_remote_locked()
        for name in lora_lib.list_adapter_dirs(self._local_dir):
            if name in self._inventory:
                continue
            try:
                config, _ = self._read_config(name)
            except (OSError, ValueError, KeyError):
                continue  # half-written artifact: picked up next scan
            self._inventory[name] = config
            if self._stack is None:
                # The store geometry is fixed by what the scan saw
                # before the first load (or --max-lora-rank).
                self._rank = max(self._rank, int(config['rank']))
                merged = dict.fromkeys(self._targets)
                merged.update(dict.fromkeys(config['targets']))
                self._targets = tuple(
                    t for t in lora_lib.ALL_TARGETS if t in merged)

    def _read_config(self, name: str) -> Tuple[Dict[str, Any], str]:
        path = os.path.join(self._local_dir, name)
        with open(os.path.join(path, lora_lib.CONFIG_FILE),
                  encoding='utf-8') as f:
            config = json.load(f)
        if 'rank' not in config or 'targets' not in config:
            raise ValueError(f'malformed adapter config for {name!r}')
        return config, path

    def inventory(self) -> List[str]:
        with self._lock:
            return sorted(self._inventory)

    def exists(self, name: str) -> bool:
        with self._lock:
            if name not in self._inventory:
                self._scan_locked()   # hot-load: new artifacts appear
            return name in self._inventory

    def resolve(self, name: str) -> None:
        """Raise AdapterNotFoundError unless `name` is servable."""
        if not self.exists(name):
            raise AdapterNotFoundError(
                f'adapter {name!r} not found in {self._dir} '
                f'(known: {self.inventory()})')

    def cache_salt(self, name: str) -> bytes:
        """Prefix-cache chain-key salt: KV pages depend on the adapter
        once LoRA touches the k/v projections."""
        return affinity.adapter_salt(name)

    # -- device store -------------------------------------------------------
    def _ensure_stack_locked(self) -> None:
        if self._stack is not None:
            return
        if self._rank < 1 or not self._targets:
            raise AdapterLoadError(
                'adapter store geometry unknown: no adapters scanned '
                'and no --max-lora-rank given')
        n = self.max_adapters + 1
        ranks = self.mesh.tensor if self.mesh is not None else 1
        stacks = []
        for rank in range(ranks):
            stack: Dict[str, Any] = {}
            for i in range(self.cfg.num_layers):
                device = (self.model.layer_device(i, rank)
                          if self.mesh is not None else self.device)
                stack[f'layer_{i}'] = {}
                for t in self._targets:
                    a, b = self._factor_shards(t, rank, np.zeros(
                        (n, *self._shapes[t][:1], self._rank)), np.zeros(
                        (n, self._rank, self._shapes[t][1])))
                    stack[f'layer_{i}'][t] = {
                        'a': torch.zeros(a.shape, dtype=self.cfg.dtype,
                                         device=device),
                        'b': torch.zeros(b.shape, dtype=self.cfg.dtype,
                                         device=device)}
            stacks.append(stack)
        self._stack = stacks

    @property
    def _shapes(self) -> Dict[str, Tuple[int, int]]:
        return lora_lib.projection_shapes(self.cfg)

    def _factor_shards(self, target: str, rank: int, a, b):
        """Shard `rank`'s (a, b) of a target's factors [..., d_in, r] /
        [..., r, d_out] (the whole factors off a grid)."""
        if self.mesh is None:
            return a, b
        from skypilot_tpu_torch.parallel import serving
        ways = self.mesh.tensor
        a_axis, b_axis = serving.lora_factor_axes(
            target, self.model.kv_shard_ways > 1)
        # The stacked layout has a leading adapter axis.
        lead = a.ndim - 2
        return (serving.piece(a, None if a_axis is None else a_axis + lead,
                              rank, ways),
                serving.piece(b, None if b_axis is None else b_axis + lead,
                              rank, ways))

    def model_lora(self) -> Optional[Dict[str, Any]]:
        """The `lora` argument of the model forward (scale 1: each
        adapter's alpha/rank is folded into B at load). Its tensors
        are updated in place by later loads. None before the first
        load."""
        with self._lock:
            if self._stack is None:
                return None
            if self.mesh is not None:
                return {'scale': 1.0, 'shards': self._stack}
            return {'scale': 1.0, 'layers': self._stack[0]}

    def _load_locked(self, name: str, slot: int) -> None:
        """Read the artifact and write stack row `slot`. Any failure
        (an injected `adapters.load` fault too) surfaces as
        AdapterLoadError without touching the other rows."""
        try:
            if faults.point('adapters.load', adapter=name) is faults.DROP:
                raise AdapterLoadError(
                    f'injected adapters.load drop for {name!r}')
            config, path = self._read_config(name)
            spec = lora_lib.load_spec(config)
            self._ensure_stack_locked()
            if spec.rank > self._rank:
                raise AdapterLoadError(
                    f'adapter {name!r} has rank {spec.rank} > store '
                    f'rank {self._rank}; restart with --max-lora-rank '
                    f'{spec.rank}')
            missing = [t for t in spec.targets
                       if t not in self._targets]
            if missing:
                raise AdapterLoadError(
                    f'adapter {name!r} adapts {missing}, not in the '
                    f'store target set {list(self._targets)} (fixed '
                    f'at startup); restart to widen it')
            _, weights = lora_lib.load_adapter(path)
            shapes = lora_lib.projection_shapes(self.cfg)
            rows: List[Tuple[torch.Tensor, np.ndarray]] = []
            for i in range(self.cfg.num_layers):
                lname = f'layer_{i}'
                for t in self._targets:
                    d_in, d_out = shapes[t]
                    factors = weights.get(lname, {}).get(t)
                    a = np.zeros((d_in, self._rank), np.float32)
                    b = np.zeros((self._rank, d_out), np.float32)
                    if factors is not None:
                        fa = np.asarray(factors['a'], np.float32)
                        fb = np.asarray(factors['b'], np.float32)
                        if fa.shape != (d_in, spec.rank) or \
                                fb.shape != (spec.rank, d_out):
                            raise AdapterLoadError(
                                f'adapter {name!r} {lname}/{t} shape '
                                f'{fa.shape}x{fb.shape} does not '
                                f'match the serving model '
                                f'({d_in},{spec.rank})x'
                                f'({spec.rank},{d_out})')
                        a[:, :spec.rank] = fa
                        # alpha/rank folds into B in f32, before the
                        # cast to the store dtype: the engine applies
                        # scale 1 for every adapter in the stack.
                        b[:spec.rank, :] = fb * spec.scale
                    for rank, stack in enumerate(self._stack):
                        layer = stack[lname][t]
                        pa, pb = self._factor_shards(t, rank, a, b)
                        rows += [(layer['a'][slot], pa),
                                 (layer['b'][slot], pb)]
            # Every shape was checked before the first write.
            for dst, src in rows:
                dst.copy_(torch.from_numpy(
                    np.ascontiguousarray(src)).to(dst.dtype))
        except AdapterLoadError:
            self.load_failures += 1
            self._m_load_failures.inc()
            raise
        except Exception as e:  # pylint: disable=broad-except
            self.load_failures += 1
            self._m_load_failures.inc()
            raise AdapterLoadError(
                f'loading adapter {name!r} failed: '
                f'{type(e).__name__}: {e}') from e
        self.loads += 1
        _obs.counter('skypilot_serving_adapter_loads_total').labels(
            adapter=name).inc()

    def acquire(self, name: str) -> Optional[int]:
        """Pin `name` and return its device slot id (1-based; 0 is the
        base model and never returned). Loads it, evicting the LRU
        unpinned adapter if the store is full, when not resident.
        Returns None when every slot is pinned by a running request
        (the caller re-queues); raises AdapterNotFoundError /
        AdapterLoadError for missing / unloadable artifacts."""
        with self._lock:
            if name not in self._inventory:
                self._scan_locked()
            if name not in self._inventory:
                raise AdapterNotFoundError(
                    f'adapter {name!r} not found in {self._dir} '
                    f'(known: {sorted(self._inventory)})')
            slot = self._loaded.get(name)
            if slot is not None:
                self._refs[slot] = self._refs.get(slot, 0) + 1
                self._lru.pop(name, None)
                self._count_request_locked(name)
                return slot
            if not self._free:
                if not self._lru:
                    return None   # every slot pinned: back-pressure
                evictee, _ = self._lru.popitem(last=False)
                freed = self._loaded.pop(evictee)
                del self._slot_name[freed]
                self._free.append(freed)
                self.evictions += 1
                _obs.counter('skypilot_serving_adapter_evictions_total'
                             ).labels(adapter=evictee).inc()
            slot = self._free[-1]
            self._load_locked(name, slot)   # raises on failure
            self._free.pop()
            self._loaded[name] = slot
            self._slot_name[slot] = name
            self._refs[slot] = 1
            self._count_request_locked(name)
            self._m_loaded.set(len(self._loaded))
            return slot

    def release(self, slot: int, tokens: int = 0) -> None:
        """Unpin one acquire(); refcount 0 makes the adapter LRU-
        evictable (it stays resident until a load needs the slot).
        `tokens` adds the request's committed tokens to the
        per-adapter counter."""
        with self._lock:
            name = self._slot_name.get(slot)
            if name is None:
                return
            self._refs[slot] = self._refs.get(slot, 1) - 1
            if self._refs[slot] <= 0:
                self._refs.pop(slot, None)
                self._lru[name] = None
            if tokens > 0:
                self.tokens[name] = self.tokens.get(name, 0) + tokens
                _obs.counter('skypilot_serving_adapter_tokens_total'
                             ).labels(adapter=name).inc(tokens)

    def _count_request_locked(self, name: str) -> None:
        self.requests[name] = self.requests.get(name, 0) + 1
        _obs.counter('skypilot_serving_adapter_requests_total').labels(
            adapter=name).inc()

    # -- observability ------------------------------------------------------
    def loaded_names(self) -> List[str]:
        with self._lock:
            return sorted(self._loaded)

    def stats(self) -> Dict[str, Any]:
        """The `/stats` adapters section (the reference's keys)."""
        with self._lock:
            bytes_per = (lora_lib.adapter_num_bytes(
                self.cfg, self._rank,
                self._targets or lora_lib.ATTN_TARGETS,
                bytes_per_elem=self.cfg.dtype.itemsize)
                if self._rank else 0)
            return {
                'inventory': sorted(self._inventory),
                'loaded': sorted(self._loaded),
                'pinned': sorted(self._slot_name[s]
                                 for s, r in self._refs.items()
                                 if r > 0),
                'max_adapters': self.max_adapters,
                'rank': self._rank,
                'targets': list(self._targets),
                'loads': self.loads,
                'evictions': self.evictions,
                'load_failures': self.load_failures,
                'requests': dict(self.requests),
                'tokens': dict(self.tokens),
                'bytes_per_adapter': bytes_per,
                'device_bytes': bytes_per * len(self._loaded),
            }
