#!/usr/bin/env python3
"""Times the port's flash attention kernels against another build of
them, in one process on one GPU.

    python3 profile_flash.py --baseline OTHER/flash_attention.cu

Builds the tree's kernel library (skypilot_tpu_torch/ops/_build.py) and,
from the source given, a baseline library with the same nvcc flags into
build/kernels/, then times both at training's shape (bf16 B=8 S=2048
Hq=32 Hkv=8 D=128) and a long prefill's (B=1 S=2300) in turns:
baseline, tree, tree, baseline, with chip_smoke.py's L2-cold CUDA-event
timer. The forward is one call; the backward is dQ, dK and dV together
(the tree's wrapper, workspace zeroing and dQ cast included; a baseline
that has separate dK/dV and dQ kernels runs both). Beside them, the
same call times scaled_dot_product_attention forward and backward, and
checks that the two builds agree (worst 128-row tile of |tree -
baseline| / |baseline|). One JSON line per shape, then the card
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
Without `--baseline` only the tree and SDPA are timed.
"""
import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (L2-cold timer, inputs, error metric)

SHAPES = (('train', 8, 2048), ('prefill', 1, 2300))


def build_baseline(source: str) -> ctypes.CDLL:
    """The baseline source compiled as the tree's libraries are."""
    from skypilot_tpu_torch.ops import _build
    digest = hashlib.sha256(open(source, 'rb').read()).hexdigest()[:16]
    out = _build.BUILD_DIR / f'libbaseline-{digest}.so'
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o',
                        str(out), source], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.skypilot_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
    if hasattr(lib, 'skypilot_flash_bwd'):
        lib.skypilot_flash_bwd.argtypes = [ptr] * 9 + [i32] * 7 + [f32, ptr]
    else:
        lib.skypilot_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [f32,
                                                                       ptr]
        lib.skypilot_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [f32,
                                                                      ptr]
    return lib


def baseline_calls(lib, q, k, v, do, lse, di):
    """(forward, backward) callables on the baseline library, returning
    o and (dq, dk, dv); each raises on a launch error."""
    batch, seq, hq, dim = q.shape
    hkv, scale = k.shape[2], 1.0 / math.sqrt(dim)
    stream = torch.cuda.current_stream().cuda_stream
    shape = (batch, seq, hq, hkv, dim, 1)

    def ok(err):
        if err:
            raise RuntimeError(f'baseline kernel failed: CUDA error {err}')

    def fwd():
        o = torch.empty_like(q)
        out_lse = torch.empty_like(lse)
        ok(lib.skypilot_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), out_lse.data_ptr(), *shape,
                                  scale, stream))
        return o

    def bwd():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr())
        if hasattr(lib, 'skypilot_flash_bwd'):
            ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            ok(lib.skypilot_flash_bwd(*args, ws.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), *shape, seq, scale,
                                      stream))
            return ws.to(q.dtype), dk, dv
        dq = torch.empty_like(q)
        ok(lib.skypilot_flash_bwd_dkv(*args, dk.data_ptr(), dv.data_ptr(),
                                      *shape, scale, stream))
        ok(lib.skypilot_flash_bwd_dq(*args, dq.data_ptr(), *shape, scale,
                                     stream))
        return dq, dk, dv

    return fwd, bwd


def tile_err(x, ref):
    """Worst 128-row tile of |x - ref| / |ref| (chip_smoke's metric)."""
    diff = (x.float() - ref.float()).square().sum(-1)
    norm = ref.float().square().sum(-1)
    pad = -x.shape[1] % chip_smoke.FLASH_TILE

    def tiles(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).unflatten(
            1, (-1, chip_smoke.FLASH_TILE)).sum(2)

    return (tiles(diff) / tiles(norm)).sqrt().max().item()


def profile_shape(fk, lib, name, batch, seq, iters):
    import torch.nn.functional as F
    hq, hkv = chip_smoke.HQ, chip_smoke.HKV
    q, k, v, do = chip_smoke.flash_inputs(torch.bfloat16, batch, seq, hq,
                                          hkv, seed=7)
    o, lse = fk.flash_forward_kernel(q, k, v)
    di = fk.attention_di(o, do)
    new = {'fwd': lambda: fk.flash_forward_kernel(q, k, v),
           'bwd': lambda: fk.flash_backward_kernel(q, k, v, do, lse, di)}
    line = {'shape': name, 'batch': batch, 'seq': seq, 'hq': hq,
            'hkv': hkv, 'd': chip_smoke.D, 'dtype': 'bf16'}
    timer = lambda fn: chip_smoke.time_cold_ms(fn, iters=iters)  # noqa
    if lib is not None:
        old = dict(zip(('fwd', 'bwd'), baseline_calls(lib, q, k, v, do, lse,
                                                      di)))
        ref_o, ref_grads = old['fwd'](), old['bwd']()
        line['agreement_tile_rel_err'] = {
            'o': tile_err(new['fwd']()[0], ref_o),
            **{g: tile_err(a, b) for g, a, b in zip(
                ('dq', 'dk', 'dv'), new['bwd'](), ref_grads)}}
        for part in ('fwd', 'bwd'):
            turns = [timer(old[part]), timer(new[part]), timer(new[part]),
                     timer(old[part])]
            line[part] = {'baseline_ms': [turns[0], turns[3]],
                          'tree_ms': [turns[1], turns[2]],
                          'speedup': (turns[0] + turns[3])
                          / (turns[1] + turns[2])}
    else:
        for part in ('fwd', 'bwd'):
            line[part] = {'tree_ms': [timer(new[part])]}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    line['sdpa_fwd_ms'] = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    line['sdpa_bwd_ms'] = timer(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    bounds = chip_smoke.flash_bound_ms(batch, seq, hq, hkv, 2)
    line['bound_ms'] = {'fwd': bounds['flash_fwd'][0],
                        'bwd': bounds['flash_bwd'][0]}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='another flash_attention.cu')
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_flash: no CUDA device is available', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.ops import flash_kernel as fk
    lib = build_baseline(args.baseline) if args.baseline else None
    for name, batch, seq in SHAPES:
        profile_shape(fk, lib, name, batch, seq, args.iters)
        torch.cuda.empty_cache()
    print(card_description(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
