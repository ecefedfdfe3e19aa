#!/usr/bin/env python3
"""Times the port's W8A16 linear kernel against another version of it, in
one process on one GPU.

    python3 profile_int8_linear.py --baseline DIR

DIR holds the other version's `int8_linear.cu` (with the `hopper.cuh` it
includes) and its wrapper `int8_linear.py`, e.g. the parent commit's:

    mkdir -p build/parent
    git show REV:skypilot_tpu_torch/csrc/int8_linear.cu > build/parent/int8_linear.cu
    git show REV:skypilot_tpu_torch/csrc/hopper.cuh > build/parent/hopper.cuh
    git show REV:skypilot_tpu_torch/ops/int8_linear.py > build/parent/int8_linear.py

Builds the tree's kernel library (skypilot_tpu_torch/ops/_build.py) and,
from DIR's source, a baseline library with the same nvcc flags into
build/kernels/ (DIR's headers first), then loads DIR's wrapper under
another name with that library, so the baseline runs with its own `plan`
and its own C signature. Both are timed on the main path's projection
shapes: Llama-3-8B's ((out, in) = (4096, 4096), (1024, 4096), (14336,
4096), (4096, 14336)), DeepSeek-V2-Lite's w_down (2048, 10944) and one
`--tensor 2` shard's wq (2048, 4096), wo (4096, 2048) and w_down (4096,
7168); bf16 x at M = 1, 8 and 256 rows, on the same inputs. Turns run
baseline, tree, tree, baseline with chip_smoke.py's `time_cold_ms`
(device time of one call after a write that evicts the L2); beside them
the same call times F.linear on bf16 weights of the same shape (what
--weight-dtype bf16 costs), the plain version, one read of the weight's
bytes by one PyTorch call (`chip_smoke.int8_read_floor`: what the timing
charges for the bytes alone) and one near-empty launch, and checks that
the two versions agree (the worst output row within chip_smoke's bf16
tolerance). Then, on the tree alone, the 'mma' and 'wgmma' routes in
turns (mma, wgmma, wgmma, mma) at M around WGMMA_MIN_ROWS, the
measurement behind that threshold; with `--tilings`, every 'wgmma'
tiling (each of WGMMA_TILES at 1, 2, 4 and 8 slices, forced in place
of `plan`'s) at M = 256 and 128, the measurement behind `plan`'s rule. One JSON
line per shape and M, then the card (`nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`). Without `--baseline` only the tree
is timed.
"""
import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (timer, inputs, bound, tolerance, floor)

SHAPES = {'wq_wo': (4096, 4096), 'wk_wv': (1024, 4096),
          'w_gate_w_up': (14336, 4096), 'w_down': (4096, 14336),
          'deepseek_w_down': (2048, 10944), 'tp2_wq': (2048, 4096),
          'tp2_wo': (4096, 2048), 'tp2_w_down': (4096, 7168)}
ROWS = (1, 8, 256)
# Row counts around the route threshold, each timed on both routes.
SWEEP_ROWS = (24, 32, 40, 48, 64, 96, 128)
SWEEP_SHAPES = ('wq_wo', 'wk_wv', 'w_gate_w_up', 'deepseek_w_down',
                'tp2_wo')


def load_baseline(directory: str):
    """DIR's wrapper module, its `_library` bound to DIR's kernel source
    compiled as the tree's libraries are."""
    from skypilot_tpu_torch.ops import _build
    source = os.path.join(directory, 'int8_linear.cu')
    text = open(source, 'rb').read()
    header = os.path.join(directory, 'hopper.cuh')
    if os.path.exists(header):
        text += open(header, 'rb').read()
    digest = hashlib.sha256(text).hexdigest()[:16]
    out = _build.BUILD_DIR / f'libbaseline_int8_linear-{digest}.so'
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-I',
                        os.path.abspath(directory), '-I', str(_build.CSRC),
                        '-o', str(out), source],
                       check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location(
        'baseline_int8_linear', os.path.join(directory, 'int8_linear.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = _build.load
    _build.load = lambda name: ctypes.CDLL(str(out))
    try:
        mod._library()  # pylint: disable=protected-access
    finally:
        _build.load = real
    return mod


@contextlib.contextmanager
def forced_tiling(il, tiling):
    """Every `il.int8_linear` call inside the block takes `tiling` (a
    `Plan`: route and tiles) in place of `il.plan`'s."""
    real = il.plan
    il.plan = lambda *args, **kwargs: tiling
    try:
        yield
    finally:
        il.plan = real


def time_tilings(il, proj, n, k, q, scale, x, time_ms):
    """One line: the 'wgmma' route's time at every tiling, M = x's rows."""
    m = x.shape[0]
    out = {}
    for bt, bn in il.WGMMA_TILES:
        for ks in (1, 2, 4, 8):
            if (bt > 128 and m <= 128) or (ks > 1 and -(-k // 64) < 2 * ks):
                continue
            with forced_tiling(il, il.Plan('wgmma', bt, bn, ks)):
                out[f'{bt}x{bn}x{ks}'] = {
                    'blocks': -(-n // bn) * -(-m // bt) * ks,
                    'ms': time_ms(lambda: il.int8_linear(x, q, scale))}
    print(json.dumps({'tilings': proj, 'n': n, 'k': k, 'm': m,
                      'plan': il.plan(m, n, k, torch.cuda.
                                      get_device_properties(0).
                                      multi_processor_count),
                      'ms': out}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline', default=None,
                        help='directory of another int8_linear.cu / .py '
                             'to time in turns')
    parser.add_argument('--tilings', action='store_true',
                        help='also time every wgmma tiling at M = 256 and 128')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_int8_linear: no CUDA device', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.ops import int8_linear as il
    base = load_baseline(args.baseline) if args.baseline else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    time_ms = chip_smoke.time_cold_ms
    for proj, (n, k) in SHAPES.items():
        q, scale, _, g = chip_smoke.int8_case(n, k, torch.bfloat16, False,
                                              seed=200)
        w_bf16 = il.dequantize(q, scale, torch.bfloat16)
        floor_ms = time_ms(chip_smoke.int8_read_floor(q))
        for m in ROWS:
            x = torch.randn((m, k), generator=g, device='cuda').bfloat16()
            tree = lambda: il.int8_linear(x, q, scale)  # noqa: E731
            row = {'proj': proj, 'n': n, 'k': k, 'm': m,
                   'plan': il.plan(m, n, k, sms)}
            if base is not None:
                other = lambda: base.int8_linear(x, q, scale)  # noqa: E731
                err = chip_smoke.int8_row_err(other(), tree())
                turns = [time_ms(other), time_ms(tree), time_ms(tree),
                         time_ms(other)]
                row.update(baseline_plan=base.plan(m, n, k, sms),
                           baseline_ms=[turns[0], turns[3]],
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
                       floor_ms=floor_ms,
                       launch_floor_ms=chip_smoke.launch_floor_ms())
            print(json.dumps(row), flush=True)
            if args.tilings and m == 256:
                time_tilings(il, proj, n, k, q, scale, x, time_ms)
        if args.tilings:
            x = torch.randn((128, k), generator=g, device='cuda').bfloat16()
            time_tilings(il, proj, n, k, q, scale, x, time_ms)
        if proj in SWEEP_SHAPES:
            for m in SWEEP_ROWS:
                x = torch.randn((m, k), generator=g,
                                device='cuda').bfloat16()
                plans = {r: il.plan(m, n, k, sms, route=r)
                         for r in ('mma', 'wgmma')}

                def timed(route):
                    with forced_tiling(il, plans[route]):
                        return time_ms(lambda: il.int8_linear(x, q, scale))

                with forced_tiling(il, plans['wgmma']):
                    err = chip_smoke.int8_row_err(
                        il.int8_linear(x, q, scale),
                        il.int8_linear_reference(x, q, scale))
                turns = [timed('mma'), timed('wgmma'), timed('wgmma'),
                         timed('mma')]
                print(json.dumps({
                    'sweep': proj, 'n': n, 'k': k, 'm': m,
                    'route': il.plan(m, n, k, sms).route,
                    'mma_plan': plans['mma'], 'wgmma_plan': plans['wgmma'],
                    'mma_ms': [turns[0], turns[3]],
                    'wgmma_ms': [turns[1], turns[2]],
                    'wgmma_row_rel_err': err}), flush=True)
        del w_bf16
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
