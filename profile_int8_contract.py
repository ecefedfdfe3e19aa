#!/usr/bin/env python3
"""How the int8 log-prob contract of chip_smoke.py's serve_mixtral_int8
phase moves with the int8 kernel's summation order, on one GPU.

    python3 profile_int8_contract.py [--baseline DIR]

Every 'wgmma' call sums the same bf16 products in f32; only the split of
K over a cluster's blocks (`plan`'s KS) changes the order of the sum,
and so the last bit of some outputs. This script first prints, for the
projection shapes the phase runs (Mixtral-8x7B's attention: (out, in) =
(4096, 4096) and (1024, 4096)) and for Llama-3-8B's w_gate and
DeepSeek-V2-Lite's w_down, at M = 8, 128 and 256, the share of output
elements of each split (KS = 1 and 2) and of the 'mma' route that differ
from F.linear on the dequantized weights (the dequantize route's own
call): 0 means bit for bit. Then it runs the phase (a burst through the
kernel and through the dequantize route, scored by the bf16 model) once
per variant: the tree's plan; every 'wgmma' call at KS = 1, 2 and 4;
every 'wgmma' call at the split found bit-identical to F.linear above
(the prefill as the dequantize route computes it); and, with
`--baseline DIR` (as profile_int8_linear.py takes it), the other
version's kernel for every call. Each run prints one JSON line:
the contract (mean log-prob difference to the dequantize route, which
the phase holds to >= -0.1) and the per-request scores; the phase's
checks are logged there instead of raised. Then the card
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
"""
import argparse
import json
import os
import subprocess
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import profile_int8_linear as prof  # noqa: E402

EXACT_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (2048, 10944))
EXACT_ROWS = (8, 128, 256)


def exact_lines(il):
    """Share of outputs of each split that differ from F.linear; returns
    {(m, n, k): the first split that matches it bit for bit}."""
    exact = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, k in EXACT_SHAPES:
        q, scale, _, g = chip_smoke.int8_case(n, k, torch.bfloat16, False,
                                              seed=5)
        w = il.dequantize(q, scale, torch.bfloat16)
        for m in EXACT_ROWS:
            x = torch.randn((m, k), generator=g, device='cuda').bfloat16()
            ref = torch.nn.functional.linear(x, w)
            out = {'n': n, 'k': k, 'm': m}
            for ks in (1, 2):
                with prof.forced_tiling(il, il.Plan('wgmma', 128, 64, ks)):
                    y = il.int8_linear(x, q, scale)
                out[f'wgmma_ks{ks}'] = float((y != ref).float().mean())
            mma = il.plan(m, n, k, sms, route='mma')
            with prof.forced_tiling(il, mma):
                y = il.int8_linear(x, q, scale)
            out['mma'] = float((y != ref).float().mean())
            print(json.dumps({'differs_from_f_linear': out}), flush=True)
            for ks in (1, 2):
                if out[f'wgmma_ks{ks}'] == 0.0 and (m, n, k) not in exact:
                    exact[(m, n, k)] = ks
    return exact


def with_slices(il, slices):
    """`il.plan` with every 'wgmma' call at `slices(m, n, k, ks)`."""
    real = il.plan

    def plan(m, n, k, sm_count, dtype=torch.bfloat16, route=None):
        got = real(m, n, k, sm_count, dtype, route)
        if got.route != 'wgmma':
            return got
        return got._replace(ks=slices(m, n, k, got.ks))
    return plan


def contract_run(name, il, pk):
    """serve_mixtral_int8 once; its checks logged, not raised."""
    fails, emitted = [], {}
    check, emit = chip_smoke.check, chip_smoke.emit
    chip_smoke.check = lambda ok, msg: ok or fails.append(str(msg)[:300])
    chip_smoke.emit = lambda phase, **f: emitted.__setitem__(phase, f)
    try:
        chip_smoke.phase_serve_mixtral_int8(pk, il, 'profile')
    except Exception:  # pylint: disable=broad-except
        traceback.print_exc()
    finally:
        chip_smoke.check, chip_smoke.emit = check, emit
    out = emitted.get('serve_mixtral_int8', {})
    print(json.dumps({
        'variant': name,
        'contract': out.get('contract_vs_dequantize', {}).get('int8'),
        'scores': {k: out.get('scores', {}).get(k)
                   for k in ('int8', 'int8_dequant')},
        'int8_launches_by_route': out.get('int8_launches_by_route'),
        'checks_failed': fails}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline', default=None,
                        help='directory of another int8_linear.cu / .py')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_int8_contract: no CUDA device', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.ops import int8_linear as il
    from skypilot_tpu_torch.ops import paged_kernel as pk
    torch.cuda.set_device(0)
    exact = exact_lines(il)
    # pylint: disable=protected-access
    real_plan, real_launch = il.plan, il._launch
    variants = [('tree', {})]
    variants += [(f'wgmma_ks{ks}',
                  {'plan': with_slices(il, lambda m, n, k, p, ks=ks: ks)})
                 for ks in (1, 2, 4)]
    # Each 'wgmma' call at the split that matched F.linear bit for bit
    # above (where one did): the prefill as the dequantize route computes.
    variants.append(('wgmma_as_f_linear', {'plan': with_slices(
        il, lambda m, n, k, p: exact.get((m, n, k), p))}))
    if args.baseline:
        base = prof.load_baseline(args.baseline)

        variants.append(('baseline', {'_launch': base._launch}))
    for name, patch in variants:
        for attr, fn in patch.items():
            setattr(il, attr, fn)
        try:
            contract_run(name, il, pk)
        finally:
            il.plan, il._launch = real_plan, real_launch
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
