"""Token data loader (port of skypilot_tpu/data/token_loader.py): the
native mmap+prefetch reader and the numpy route.

Binary token shards (nanoGPT-style .bin of uint16 or uint32) become
[batch, seq+1] uint32 arrays, deterministic per (seed, step, rank) so
data-parallel hosts draw disjoint streams: the reference's shard
format, `rank`/`world` split and window order.

The native route binds the reference's C++ core, `native/token_loader.cpp`
(worker threads fill a ring of batches from memory-mapped shards),
through ctypes. It is compiled at first use with `g++ -O3 -std=c++17
-fPIC -shared -pthread` into `build/native/`, keyed by a hash of the
source and the flags, as `ops/_build.py` builds the kernels; the
tracked `native/libtoken_loader.so` is never rebuilt or loaded. The
core's workers may finish steps out of order (the reference takes them
as they come); this binding hands batches out in step order, so the
native route's batches equal the numpy route's byte for byte when
`shuffle=False`. With `shuffle=True` the two routes draw their windows
from different generators, each the reference's own: splitmix64 in the
core, numpy's `default_rng` in the numpy route. Where the core cannot
be built or loaded, `use_native=True` takes the numpy route and
`native_unavailable_reason()` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _ROOT / 'native' / 'token_loader.cpp'
BUILD_DIR = _ROOT / 'build' / 'native'
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-shared', '-pthread')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Why the native core is unusable, when it is (None: usable or not yet
# tried).
_native_error: Optional[str] = None


def _lib_path() -> Path:
    h = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'libtoken_loader-{h.hexdigest()[:16]}.so'


def _build(out: Path) -> None:
    """Compile the core into `out`, atomically: two processes building
    the same source at once both end with a whole library."""
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None:
        raise OSError('no C++ compiler (g++ on PATH, or $CXX)')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp),
                           str(NATIVE_SOURCE)],
                          capture_output=True, text=True, timeout=300,
                          check=False)
    if proc.returncode != 0:
        raise OSError(f'{cxx} failed on {NATIVE_SOURCE} (exit '
                      f'{proc.returncode}): {proc.stderr.strip()[-2000:]}')
    os.replace(tmp, out)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _native_error
    with _lock:
        if _lib is not None or _native_error is not None:
            return _lib
        try:
            out = _lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            _native_error = str(e)
            return None
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int, ctypes.c_int]
        lib.tl_total_tokens.restype = ctypes.c_uint64
        lib.tl_total_tokens.argtypes = [ctypes.c_void_p]
        lib.tl_start.restype = ctypes.c_int
        lib.tl_start.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.tl_next.restype = ctypes.c_int64
        lib.tl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint32)]
        lib.tl_close.restype = None
        lib.tl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_unavailable_reason() -> Optional[str]:
    """None when the native core builds and loads here; otherwise why
    not (no compiler, a build error, a load error)."""
    _load_lib()
    return _native_error


class TokenLoader:
    """Iterates [batch, seq+1] uint32 batches from token shard files.
    `native` says which route this loader reads through."""

    def __init__(self, shard_paths: Sequence[str], batch: int, seq: int,
                 *, seed: int = 0, rank: int = 0, world: int = 1,
                 shuffle: bool = True, dtype_bytes: int = 2,
                 prefetch_threads: int = 2, use_native: bool = True) -> None:
        self.paths = [os.path.abspath(os.path.expanduser(p))
                      for p in shard_paths]
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.batch, self.seq = batch, seq
        self.seed, self.rank, self.world = seed, rank, world
        self.shuffle = shuffle
        self._step = 0
        self._handle = None
        self._lib = _load_lib() if use_native else None
        self.native = self._lib is not None
        if self.native:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            handle = self._lib.tl_open(arr, len(self.paths), dtype_bytes)
            if not handle:
                raise OSError(f'tl_open failed for {self.paths}')
            self._handle = ctypes.c_void_p(handle)
            self.total_tokens = int(self._lib.tl_total_tokens(self._handle))
            rc = self._lib.tl_start(self._handle, batch, seq, seed, rank,
                                    world, int(shuffle), prefetch_threads, 4)
            if rc != 0:
                self.close()
                raise ValueError('dataset smaller than one window')
            # Batches the workers finished ahead of the one asked for.
            self._early: Dict[int, np.ndarray] = {}
        else:
            dt = np.uint16 if dtype_bytes == 2 else np.uint32
            self._arrays = [np.memmap(p, dtype=dt, mode='r')
                            for p in self.paths]
            self._cum = np.cumsum([0] + [len(a) for a in self._arrays])
            self.total_tokens = int(self._cum[-1])
            if seq + 1 >= self.total_tokens:
                raise ValueError('dataset smaller than one window')

    # -- numpy route ----------------------------------------------------------
    def _window(self, start: int, count: int) -> np.ndarray:
        out = np.empty(count, np.uint32)
        filled = 0
        while filled < count:
            shard = int(np.searchsorted(self._cum, start + filled,
                                        side='right')) - 1
            off = start + filled - self._cum[shard]
            take = min(count - filled, len(self._arrays[shard]) - int(off))
            out[filled:filled + take] = self._arrays[shard][off:off + take]
            filled += take
        return out

    def _next_numpy(self, step: int) -> np.ndarray:
        out = np.empty((self.batch, self.seq + 1), np.uint32)
        n_windows = self.total_tokens // self.seq
        for b in range(self.batch):
            if self.shuffle:
                rng = np.random.default_rng([self.seed, step, self.rank, b])
                start = int(rng.integers(0, self.total_tokens - self.seq - 1))
            else:
                window = (step * self.world + self.rank) * self.batch + b
                start = (window % n_windows) * self.seq
                start = min(start, self.total_tokens - self.seq - 1)
            out[b] = self._window(start, self.seq + 1)
        return out

    # -- native route ---------------------------------------------------------
    def _next_native(self, step: int) -> np.ndarray:
        while step not in self._early:
            out = np.empty((self.batch, self.seq + 1), np.uint32)
            got = self._lib.tl_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            if got < 0:
                raise StopIteration
            self._early[int(got)] = out
        return self._early.pop(step)

    # -- public ---------------------------------------------------------------
    def next_batch(self) -> np.ndarray:
        """[batch, seq+1] uint32; inputs = [:, :-1], targets = [:, 1:]."""
        step = self._step
        self._step += 1
        if self._handle is not None:
            return self._next_native(step)
        return self._next_numpy(step)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.next_batch()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, '_handle', None) is not None:
            self.close()
