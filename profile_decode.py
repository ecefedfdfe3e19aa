#!/usr/bin/env python3
"""Where a steady decode round of the PyTorch/CUDA port's serving engine
spends its time, from a torch.profiler trace on one GPU.

    python3 profile_decode.py
    python3 profile_decode.py --cpu    # a local probe: llama-tiny

Two phases on one set of seeded random weights, each a runtime built
from serve_lm's flags (Llama-3-8B at full width, 8 slots, bf16 pool,
`--max-total-len 1024 --prefill-chunk 256`) holding chip_smoke.py's 8
prompts (300-700 tokens):

  base   every request on the base model (no adapter directory);
  lora   chip_smoke.py's three seeded adapters (attn r8, attn r16,
         attn-mlp r16) with 2 base and 6 adapter requests, as in its
         serve_lora phase: every round runs the LoRA path.

Each phase runs four times in one process, in turns: decode rounds
eager (`cuda_graphs=False`, the A/B switch serve_lm does not have),
then each single-token step one CUDA-graph replay (the default), graphs
again, eager again. The engine runs its default pipelined loop. The
engine's own scheduler iteration is driven on this thread (its
background thread is stopped first), so the profiler records the host
ops of each round. Once every slot decodes and no prefill is queued,
ROUNDS rounds are timed without the profiler, then ROUNDS more under
it. One JSON line per phase and turn:

  round_ms           host wall time per round, unprofiled / profiled
  device_ms          device-busy time per round: the union of kernel,
                     memcpy and memset intervals (graph replays
                     included: their kernels are traced one by one)
  device_busy_share  device_ms over the unprofiled round (the profiler
                     slows the host, not the device), and over the
                     profiled round
  graph_replays_per_round, paged_launches_per_round,
  lora_launches_per_round   from the engine's and the kernel wrappers'
                     counters over the profiled rounds (a replay adds
                     the launches its capture recorded)
  kernels            device launches per round and per layer
  host_ops           top-level aten ops per round and per layer
  top_kernels        device ms per round by kernel name (largest 12)

and then one line per phase with each turn's round_ms, device_ms and
device_busy_share side by side.

On the GPU every turn of the lora phase checks that each round counts
num_layers x qkv_lora_dispatches_per_layer('cuda') x
DEVICE_LAUNCHES_PER_CALL QKV LoRA launches, the base phase none, and
both phases num_layers x DEVICE_LAUNCHES_PER_CALL paged-attention
launches (one call a layer), and every turn, graph turns included,
checks the same of the traced kernels (`paged_attention_ms_per_round`
is their device time, `lora_ms_per_round` the QKV LoRA kernels').
"""
import argparse
import collections
import gc
import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (prompts and seeded adapters)

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                    'profile_decode')
ROUNDS = 16
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# The QKV LoRA kernel; the two-launch kernel before it named its kernels
# shrink/expand, so this script, run from a checkout of that version,
# times its rounds too.
LORA_KERNELS = ('qkv_lora_kernel', 'shrink_kernel', 'expand_kernel')
# Every route of csrc/paged_attention.cu names its kernel paged_attention_*.
PAGED_KERNEL = 'paged_attention_'


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog='python3 profile_decode.py')
    p.add_argument('--cpu', action='store_true',
                   help='run llama-tiny on the CPU (no device numbers; '
                        'eager turns only)')
    return p.parse_args(argv)


def model_name(args):
    return 'llama-tiny' if args.cpu else 'llama3-8b'


def build(args, model, extra=(), cuda_graphs=True):
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    flags = ['--model', model_name(args), '--continuous-batching',
             '--num-slots', '8', '--max-total-len', '1024',
             '--prefill-chunk', '256', '--kv-dtype', 'bf16', *extra]
    if args.cpu:
        flags.append('--cpu')
    else:
        flags += ['--kv-pool-bytes', '8000000000']
    return build_runtime(serve_lm.parse_args(flags), model=model,
                         cuda_graphs=cuda_graphs)


def merged_ms(spans):
    """Total length of the union of (start, end) intervals, in ms (the
    trace's clock is microseconds)."""
    total, end = 0.0, float('-inf')
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def top_level(ops):
    """Ops of one thread not nested inside another op of that thread."""
    out, end = [], collections.defaultdict(lambda: float('-inf'))
    for ev in sorted(ops, key=lambda ev: (ev['ts'], -ev['dur'])):
        if ev['ts'] >= end[ev['tid']]:
            out.append(ev)
            end[ev['tid']] = ev['ts'] + ev['dur']
    return out


def summarize(trace_path, rounds, layers):
    with open(trace_path, encoding='utf-8') as f:
        events = [ev for ev in json.load(f)['traceEvents']
                  if ev.get('ph') == 'X' and 'dur' in ev]
    device = [ev for ev in events if ev.get('cat') in DEVICE_CATS]
    kernels = [ev for ev in device if ev['cat'] == 'kernel']
    ops = top_level([ev for ev in events if ev.get('cat') == 'cpu_op'
                     and ev['name'].startswith('aten::')])
    by_name = collections.Counter()
    for ev in kernels:
        name = ev['name'].replace('(anonymous namespace)::', '')
        by_name[name.split('(')[0][:90]] += ev['dur'] / 1e3
    span = [ev for ev in events if ev.get('cat') in DEVICE_CATS + ('cpu_op',)]
    t0 = min((ev['ts'] for ev in span), default=0.0)
    t1 = max((ev['ts'] + ev['dur'] for ev in span), default=0.0)
    return {
        'device_ms': merged_ms([(ev['ts'], ev['ts'] + ev['dur'])
                                for ev in device]) / rounds,
        'traced_round_ms': (t1 - t0) / 1e3 / rounds,
        'kernels_per_round': len(kernels) / rounds,
        'kernels_per_layer': len(kernels) / rounds / layers,
        'host_ops_per_round': len(ops) / rounds,
        'host_ops_per_layer': len(ops) / rounds / layers,
        'lora_kernels_per_round': sum(
            any(k in ev['name'] for k in LORA_KERNELS)
            for ev in kernels) / rounds,
        'lora_ms_per_round': sum(
            ev['dur'] for ev in kernels
            if any(k in ev['name'] for k in LORA_KERNELS)) / 1e3 / rounds,
        'paged_attention_per_round': sum(
            PAGED_KERNEL in ev['name'] for ev in kernels) / rounds,
        'paged_attention_ms_per_round': sum(
            ev['dur'] for ev in kernels if PAGED_KERNEL in ev['name'])
        / 1e3 / rounds,
        'top_kernels_ms_per_round': {
            name: ms / rounds for name, ms in by_name.most_common(12)},
        'top_host_ops_per_round': {
            name: n / rounds for name, n in collections.Counter(
                ev['name'] for ev in ops).most_common(12)},
    }


def steady_rounds(engine, n):
    """Run n scheduler iterations that are all plain decode rounds;
    returns host seconds per round."""
    d0, c0 = engine.decode_calls, engine.prefill_chunks_run
    t0 = time.perf_counter()
    for _ in range(n):
        engine._iterate()  # pylint: disable=protected-access
    wall = time.perf_counter() - t0
    if engine.decode_calls - d0 != n or engine.prefill_chunks_run != c0 \
            or not engine.active.all():
        raise AssertionError('the timed iterations were not all steady '
                             'decode rounds of 8 slots')
    return wall / n


def profile_phase(name, rt, models, args, trace_dir, kernels):
    engine = rt.engine
    engine.stop()          # the iterations below run on this thread
    new_tokens = 2 * ROUNDS + 64
    # The futures never resolve: the scheduler thread is stopped.
    for prompt, adapter in zip(chip_smoke.prompts(
            vocab=engine.model.config.vocab_size), models):
        engine.submit(prompt, max_new_tokens=new_tokens, adapter=adapter)
    with torch.no_grad():
        for _ in range(200):
            if engine.active.all() and not engine.prefilling.any():
                break
            engine._iterate()  # pylint: disable=protected-access
        steady_rounds(engine, 2)                 # warm-up
        round_s = steady_rounds(engine, ROUNDS)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if not args.cpu:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        counts0 = [k.launches for k in kernels] + [engine.stats()[
            'graph_replays']]
        with torch.profiler.profile(activities=activities) as prof:
            traced_s = steady_rounds(engine, ROUNDS)
        counts = [(b - a) / ROUNDS for a, b in zip(
            counts0, [k.launches for k in kernels]
            + [engine.stats()['graph_replays']])]
    path = os.path.join(trace_dir, f'{name}.json')
    prof.export_chrome_trace(path)
    layers = engine.model.config.num_layers
    out = summarize(path, ROUNDS, layers)
    out['round_ms'] = 1e3 * round_s
    out['profiled_round_ms'] = 1e3 * traced_s
    out['cuda_graphs'] = engine.cuda_graphs
    (out['paged_launches_per_round'], out['lora_launches_per_round'],
     out['graph_replays_per_round']) = counts
    if args.cpu:
        out = {k: v for k, v in out.items()
               if not k.startswith(('device', 'kernels', 'lora_', 'paged_',
                                    'top_kernels'))}
    else:
        out['device_busy_share'] = out['device_ms'] / out['round_ms']
        out['device_busy_share_traced'] = \
            out['device_ms'] / out['profiled_round_ms']
    return out


def check_turn(name, out, cfg, lk, pk, plain_calls):
    """The launch counts a turn's rounds must show (see module doc)."""
    want = (cfg.num_layers * lk.qkv_lora_dispatches_per_layer('cuda')
            * lk.DEVICE_LAUNCHES_PER_CALL if name == 'lora' else 0)
    paged = cfg.num_layers * pk.DEVICE_LAUNCHES_PER_CALL
    # The wrappers' counters, and the kernels the trace recorded (a
    # replay's kernels are traced one by one): under graphs the counters
    # only restate what the capture recorded, the trace measures it.
    counted = [('lora_launches_per_round', want),
               ('paged_launches_per_round', paged),
               ('lora_kernels_per_round', want),
               ('paged_attention_per_round', paged)]
    for key, n in counted:
        chip_smoke.check(out[key] == n, f'{name}: {out[key]} {key}, '
                                        f'want {n}')
    chip_smoke.check(out['graph_replays_per_round']
                     == (1 if out['cuda_graphs'] else 0),
                     f'{name}: {out["graph_replays_per_round"]} graph '
                     f'replays a round')
    chip_smoke.check(plain_calls == 0, f'{name}: plain route taken')


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print('profile_decode: no CUDA device (use --cpu for a local '
              'probe)', file=sys.stderr)
        return 1
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import lora_kernel as lk
    from skypilot_tpu_torch.ops import paged_kernel as pk
    device = 'cpu' if args.cpu else 'cuda'
    card = 'cpu' if args.cpu else card_description()
    if not args.cpu:
        _build.build_all()
    cfg = registry.model_config(model_name(args), 1024)
    model = convert.init_params(cfg, seed=0, device=device)
    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, 'adapters')
    chip_smoke.seed_adapters(root, cfg, [
        ('attn8', 8, 'attn'), ('attn16', 16, 'attn'),
        ('mlp16', 16, 'attn-mlp')], seed0=10)
    phases = (('base', (), [None] * 8),
              ('lora', ('--adapter-dir', root, '--max-adapters', '3'),
               ['attn8', 'attn16', None, 'mlp16', None, 'attn8',
                'mlp16', 'attn16']))
    turns = (False,) if args.cpu else (False, True, True, False)
    for name, extra, models in phases:
        summary = []
        for turn, graphs in enumerate(turns):
            rt = build(args, model, extra, cuda_graphs=graphs)
            counts0 = (lk.plain_calls, pk.plain_calls)
            out = profile_phase(name, rt, models, args, WORK, (pk, lk))
            lora_plain, pa_plain = (a - b for a, b in zip(
                (lk.plain_calls, pk.plain_calls), counts0))
            rt.stop()
            del rt
            gc.collect()
            if not args.cpu:
                torch.cuda.empty_cache()
                check_turn(name, out, cfg, lk, pk, lora_plain + pa_plain)
            mode = 'graphs' if out['cuda_graphs'] else 'eager'
            summary.append({k: out.get(k) for k in (
                'cuda_graphs', 'round_ms', 'device_ms', 'device_busy_share',
                'graph_replays_per_round')})
            print(json.dumps({'phase': name, 'turn': turn, 'mode': mode,
                              'card': card, 'rounds': ROUNDS,
                              'layers': cfg.num_layers, **out}), flush=True)
        print(json.dumps({'phase': f'{name}_turns', 'card': card,
                          'turns': summary}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
