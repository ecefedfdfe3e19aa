#!/usr/bin/env python3
"""Times the port's paged-attention kernel against another build of it,
in one process on one GPU.

    python3 profile_paged.py --baseline OTHER/paged_attention.cu

Builds the tree's kernel library (skypilot_tpu_torch/ops/_build.py) and,
from the source given, a baseline library with the same nvcc flags into
build/kernels/, then times both at Llama-3-8B's head shape (Hq=32,
Hkv=8, D=128, page 16, context 1024) for bf16 and int8 pools: decode at
B in {1, 8, 32} and a chunk of 256 queries at offset 768 (B=1). Turns
run baseline, tree, tree, baseline with chip_smoke.py's timer (device
time of back-to-back calls cycling through input sets whose K/V exceed
the 50 MB L2). Beside them, the same call times
scaled_dot_product_attention on the gathered K/V (a boolean mask for
the chunk), and checks that the two builds agree (chip_smoke's unit
error: |tree - baseline| / |baseline| in the worst unit). A baseline
whose C entry has no route arguments (the first kernel's) is called
with that signature. One JSON line per shape, then the card
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
Without `--baseline` only the tree and SDPA are timed.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (timer, inputs, bounds, error metric)


def build_baseline(source: str):
    """(library, whether its entry takes route arguments): the baseline
    source compiled as the tree's libraries are."""
    from skypilot_tpu_torch.ops import _build
    text = open(source, 'rb').read()
    digest = hashlib.sha256(text).hexdigest()[:16]
    out = _build.BUILD_DIR / f'libbaseline_paged-{digest}.so'
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-I',
                        str(_build.CSRC), '-o', str(out), source],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    routed = b'int route' in text
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skypilot_paged_attention.argtypes = (
        [ptr] * (10 if routed else 8) + [i32] * (13 if routed else 10)
        + [ctypes.c_float, ptr])
    return lib, routed


def baseline_call(pk, lib, routed, c):
    """A callable running the baseline on case `c`, returning the
    output: the first kernel's signature, or the tree's (the route and
    split plan the tree's wrapper would pick, its own counters)."""
    q, k = c['q'], c['k_pages']
    batch, seq, hq, dim = q.shape
    hkv, total, page, _ = k.shape
    pps = c['page_indices'].shape[1]
    quant = c['k_scales'] is not None
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), c['v_pages'].data_ptr(),
            c['k_scales'].data_ptr() if quant else None,
            c['v_scales'].data_ptr() if quant else None,
            c['positions'].data_ptr(), c['page_indices'].data_ptr(),
            out.data_ptr()]
    ints = [batch, seq, hq, hkv, dim, total, page, pps, 1, 2 if quant else 1]
    if routed:
        route = pk.choose_route(q.dtype, k.dtype, seq, hq, hkv, page, dim)
        plan, scratch = [0, 0], [None, None]
        if route == 'split':
            rows_per_block, groups, n_split, split_tokens = pk.split_plan(
                batch, hkv, seq * (hq // hkv), pps, page,
                torch.cuda.get_device_properties(0).multi_processor_count)
            pairs = batch * hkv * groups
            part = torch.empty(pairs * n_split * rows_per_block * (dim + 2),
                               device='cuda')
            counters = torch.zeros(pairs, dtype=torch.int32, device='cuda')
            plan, scratch = [n_split, split_tokens], [part, counters]
        ptrs += [None if t is None else t.data_ptr() for t in scratch]
        ints += [pk.ROUTES.index(route)] + plan

    def run():
        err = lib.skypilot_paged_attention(*ptrs, *ints, 0.0, stream)
        if err:
            raise RuntimeError(f'baseline kernel failed: CUDA error {err}')
        return out

    run.scratch = scratch if routed else None  # kept alive with the call
    return run


def profile_shape(pk, lib, routed, kind, label, batch, seq):
    sets = chip_smoke.paged_timing_sets(kind, batch, seq)
    iters = max(60, 3 * len(sets))
    timer = lambda fns: chip_smoke.time_ms(fns, iters=iters)  # noqa: E731
    tree = [lambda c=c: chip_smoke.call(pk, c) for c in sets]
    b_ms, b_by = chip_smoke.bound_ms(sets[0])
    line = {'pool': kind, 'shape': label, 'batch': batch, 'seq': seq,
            'context': 1024, 'hq': chip_smoke.HQ, 'hkv': chip_smoke.HKV,
            'd': chip_smoke.D, 'page': chip_smoke.PAGE,
            'input_sets': len(sets), 'bound_ms': b_ms, 'bound_by': b_by}
    if lib is not None:
        old = [baseline_call(pk, lib, routed, c) for c in sets]
        tile = 1 if seq == 1 else chip_smoke.PAGED_TILE
        line['agreement_unit_rel_err'] = chip_smoke.paged_errors(
            tree[0](), old[0](), tile)[0]
        turns = [timer(old), timer(tree), timer(tree), timer(old)]
        line['baseline_ms'] = [turns[0], turns[3]]
        line['tree_ms'] = [turns[1], turns[2]]
        line['speedup'] = (turns[0] + turns[3]) / (turns[1] + turns[2])
    else:
        line['tree_ms'] = [timer(tree)]
    line['sdpa_ms'] = timer([chip_smoke.paged_library_fn(c) for c in sets])
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='another paged_attention.cu')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_paged: no CUDA device is available', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.ops import paged_kernel as pk
    lib, routed = build_baseline(args.baseline) if args.baseline \
        else (None, False)
    for kind in ('bf16', 'int8'):
        for label, batch, seq in chip_smoke.PAGED_TIMED:
            profile_shape(pk, lib, routed, kind, label, batch, seq)
            torch.cuda.empty_cache()
    print(card_description(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
