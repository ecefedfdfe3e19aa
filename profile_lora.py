#!/usr/bin/env python3
"""Times the port's QKV LoRA kernel against another build of it, in one
process on one GPU.

    python3 profile_lora.py --baseline OTHER/qkv_lora.cu

Builds the tree's kernel library (skypilot_tpu_torch/ops/_build.py) and,
from the source given, a baseline library with the same nvcc flags into
build/kernels/, then times both at Llama-3-8B width (d_in 4096, q 4096,
k/v 1024), bf16, ranks 16 and 64, on chip_smoke.py's timed shapes:
decode B=8 over 4 adapter slots (ids [0,1,1,2,3,0,2,1]), decode B=32
over 9 slots (ids cycling 0..8) and a chunk of 256 rows (B=1). Turns
run baseline, tree, tree, baseline with chip_smoke.py's `time_cold_ms`
(device time of one call after a write that evicts the L2). Beside them
the same call times the gathered-bmm yardstick, the plain version and
one near-empty launch (`launch_floor_ms`), and checks that the two
builds agree (max-abs within chip_smoke's LORA_TOL). A baseline whose C
entry takes a scratch buffer (the two-launch kernel) is called with that
signature. One JSON line per shape, then the card (`nvidia-smi
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (timer, inputs, bound, yardstick)


def build_baseline(source: str):
    """(library, whether its entry takes a scratch buffer): the baseline
    source compiled as the tree's libraries are."""
    from skypilot_tpu_torch.ops import _build
    text = open(source, 'rb').read()
    digest = hashlib.sha256(text).hexdigest()[:16]
    out = _build.BUILD_DIR / f'libbaseline_lora-{digest}.so'
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-I',
                        str(_build.CSRC), '-o', str(out), source],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    scratch = b'skypilot_qkv_lora_scratch_floats' in text
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skypilot_qkv_lora.restype = i32
    lib.skypilot_qkv_lora.argtypes = (
        [ptr] * (12 if scratch else 11) + [i32] * (10 if scratch else 11)
        + [ctypes.c_float, ptr])
    if scratch:
        lib.skypilot_qkv_lora_scratch_floats.restype = ctypes.c_longlong
        lib.skypilot_qkv_lora_scratch_floats.argtypes = [i32] * 4
    return lib, scratch


def baseline_call(lk, lib, scratch, c):
    """A callable running the baseline on case `c`, returning (dq, dk,
    dv): the two-launch kernel's signature (with its f32 scratch), or
    the tree's."""
    x, f, ids = c['x'], c['f'], c['ids']
    batch, seq, d_in = x.shape
    n, _, rank = f[0]['a'].shape
    d_outs = [t['b'].shape[2] for t in f]
    outs = [torch.empty((batch, seq, d), device='cuda') for d in d_outs]
    code = {torch.float32: 0, torch.bfloat16: 1}
    ptrs = [x.data_ptr(), *[t[k].data_ptr() for t in f for k in ('a', 'b')],
            ids.data_ptr()]
    tail = [code[x.dtype], code[f[0]['a'].dtype], 0.0]
    if scratch:
        buf = torch.empty(lib.skypilot_qkv_lora_scratch_floats(
            batch, seq, d_in, rank), device='cuda')
        ptrs.append(buf.data_ptr())
        ints = [batch, seq, d_in, n, rank, *d_outs]
    else:
        buf = None
        ints = [batch, seq, d_in, n, rank, *d_outs,
                lk.grid_tiles(batch, seq, n)]
    ptrs += [o.data_ptr() for o in outs]

    def run():
        err = lib.skypilot_qkv_lora(
            *ptrs, *ints, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'baseline kernel failed: CUDA error {err}')
        return outs

    run.scratch = buf  # kept alive with the call
    return run


def profile_shape(lk, lib, scratch, rank, label, batch, seq, ids, slots):
    c = chip_smoke.lora_case(torch.bfloat16, rank, batch, seq, ids,
                             seed=200, n_adapters=slots)
    args = (c['x'], *c['f'], c['ids'])
    timer = chip_smoke.time_cold_ms
    tree = lambda: lk.fused_qkv_lora_delta(*args)  # noqa: E731
    b_ms, b_by, n_bytes = chip_smoke.lora_bound_ms(c)
    line = {'shape': label, 'dtype': 'bf16', 'rank': rank, 'batch': batch,
            'seq': seq, 'slots': slots, 'bound_ms': b_ms,
            'bound_by': b_by, 'bytes': n_bytes}
    if lib is not None:
        old = baseline_call(lk, lib, scratch, c)
        diff = max((a - b).abs().max().item()
                   for a, b in zip(tree(), old()))
        chip_smoke.check(diff <= chip_smoke.LORA_TOL,
                         f'{label} r{rank}: the builds differ by {diff}')
        line['agreement_max_abs'] = diff
        turns = [timer(old), timer(tree), timer(tree), timer(old)]
        line['baseline_ms'] = [turns[0], turns[3]]
        line['tree_ms'] = [turns[1], turns[2]]
        line['speedup'] = (turns[0] + turns[3]) / (turns[1] + turns[2])
    else:
        line['tree_ms'] = [timer(tree)]
    line['gathered_bmm_ms'] = timer(lambda: chip_smoke.gathered_bmm(c))
    line['plain_ms'] = timer(lambda: lk.fused_qkv_lora_delta_reference(
        *args))
    line['launch_floor_ms'] = chip_smoke.launch_floor_ms()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='another qkv_lora.cu')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_lora: no CUDA device is available', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.ops import lora_kernel as lk
    lib, scratch = build_baseline(args.baseline) if args.baseline \
        else (None, False)
    for rank in (16, 64):
        for label, batch, seq, ids, slots in chip_smoke.LORA_TIMED:
            profile_shape(lk, lib, scratch, rank, label, batch, seq, ids,
                          slots)
    print(card_description(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
