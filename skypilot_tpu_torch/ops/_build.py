"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so
a build takes seconds). Libraries land in `build/kernels/` at the root
of the checkout, keyed by a hash of the sources and flags, and are
built at first use: nothing here runs at import time, so the CPU
tests import every module without `nvcc`. `build_all()` starts one
`nvcc` per source at once, for callers that want every kernel ready
(chip_smoke.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('paged_attention', 'qkv_lora', 'flash_attention',
           'int8_linear', 'grid_collective')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (register and shared-memory use per kernel, from
#: -Xptxas=-v) for each library built by this process.
build_logs: Dict[str, str] = {}


def find_nvcc() -> Optional[str]:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates: List[str] = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin',
                                       'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for csrc/<name>.cu unless its library exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            'nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): '
            'the CUDA kernels are built from source at first use')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.out_path = out  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    # Atomic: a concurrent builder of the same sources loses nothing.
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]


def build_all() -> None:
    """Build every kernel library that is not built yet, one nvcc per
    source, all started together."""
    with _lock:
        procs = {name: _start(name) for name in SOURCES}
        for name, proc in procs.items():
            _finish(name, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
        return lib
