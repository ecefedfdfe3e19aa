#!/usr/bin/env python3
"""Times the port's W8A16 linear kernel against another build of it, in
one process on one GPU.

    python3 profile_int8_linear.py --baseline OTHER/int8_linear.cu

Builds the tree's kernel library (skypilot_tpu_torch/ops/_build.py) and,
from the source given, a baseline library with the same nvcc flags into
build/kernels/, then times both on Llama-3-8B's projection shapes
((out, in) = (4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)),
bf16 x, at M = 1, 8 and 256 rows. Both builds get the tree's tiling
(ops/int8_linear.py `plan`) and the same inputs. Turns run baseline,
tree, tree, baseline with chip_smoke.py's `time_cold_ms` (device time of
one call after a write that evicts the L2); beside them the same call
times F.linear on bf16 weights of the same shape (what --weight-dtype
bf16 costs), the plain version and one near-empty launch, and checks
that the two builds agree (the worst output row within chip_smoke's
bf16 tolerance). One JSON line per shape, then the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`). Without
`--baseline` only the tree is timed.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (timer, inputs, bound, tolerance)

SHAPES = {'wq_wo': (4096, 4096), 'wk_wv': (1024, 4096),
          'w_gate_w_up': (14336, 4096), 'w_down': (4096, 14336)}
ROWS = (1, 8, 256)


def build_baseline(source: str) -> ctypes.CDLL:
    """The baseline source compiled as the tree's libraries are."""
    from skypilot_tpu_torch.ops import _build
    text = open(source, 'rb').read()
    digest = hashlib.sha256(text).hexdigest()[:16]
    out = _build.BUILD_DIR / f'libbaseline_int8_linear-{digest}.so'
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-I',
                        str(_build.CSRC), '-o', str(out), source],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.skypilot_int8_linear.restype = ctypes.c_int
    lib.skypilot_int8_linear.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    return lib


def library_call(il, lib, x, q, scale):
    """A callable running `lib`'s kernel with the tree's plan."""
    m, k = x.shape
    n = q.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device='cuda')
    bt, bn, ks = il.plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count)

    def run():
        err = lib.skypilot_int8_linear(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), None, y.data_ptr(),
            m, n, k, bt, bn, ks, 1, 0.0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'baseline launch failed: CUDA error {err}')
        return y

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline', default=None,
                        help='another int8_linear.cu to time in turns')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_int8_linear: no CUDA device', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.ops import int8_linear as il
    base = build_baseline(args.baseline) if args.baseline else None
    time_ms = chip_smoke.time_cold_ms
    for proj, (n, k) in SHAPES.items():
        q, scale, _, g = chip_smoke.int8_case(n, k, torch.bfloat16, False,
                                              seed=200)
        w_bf16 = il.dequantize(q, scale, torch.bfloat16)
        for m in ROWS:
            x = torch.randn((m, k), generator=g, device='cuda').bfloat16()
            tree = lambda: il.int8_linear(x, q, scale)  # noqa: E731
            row = {'proj': proj, 'n': n, 'k': k, 'm': m,
                   'plan': il.plan(m, n, k, torch.cuda.
                                   get_device_properties(0).
                                   multi_processor_count)}
            if base is not None:
                other = library_call(il, base, x, q, scale)
                err = chip_smoke.int8_row_err(other(), tree())
                turns = [time_ms(other), time_ms(tree), time_ms(tree),
                         time_ms(other)]
                row.update(baseline_ms=[turns[0], turns[3]],
                           tree_ms=[turns[1], turns[2]],
                           builds_row_rel_err=err,
                           builds_agree=err <= chip_smoke.INT8_TOL['bf16'])
            else:
                row['tree_ms'] = [time_ms(tree)]
            bound, by = chip_smoke.int8_bound_ms(m, n, k, 2, il)
            row.update(bound_ms=bound, bound_by=by,
                       library_ms=time_ms(lambda: F.linear(x, w_bf16)),
                       plain_ms=time_ms(
                           lambda: il.int8_linear_reference(x, q, scale)),
                       launch_floor_ms=chip_smoke.launch_floor_ms())
            print(json.dumps(row), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
