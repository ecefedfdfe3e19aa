#!/usr/bin/env python3
"""Decode rounds and TTFT of the serving grid over distinct cards, and the
grid collective's time, on a host with 4 GPUs.

    python3 profile_grid.py              # needs 4 cards
    python3 profile_grid.py --eager-only # the grid runs alone, rounds eager

Llama-3-8B at full width and depth (seeded bf16 weights, drawn on cuda:0
and copied to the host, where a grid of distinct cards takes its shards
from), 8 slots, a bf16 pool, `--max-total-len 1024 --prefill-chunk 256`,
chip_smoke.py's 8 prompts (300-700 tokens) with 32 greedy new tokens
each, driven on the engine's own scheduler thread. One JSON line each:

  one_card        the model on cuda:0, decode rounds replayed as CUDA
                  graphs (the engine's default);
  tensor2, tensor4, stages2_tensor2
                  serve_lm --tensor 2 / --tensor 4 / --stages 2
                  --tensor 2 over the first 2 or 4 cards, in turns:
                  rounds eager (the engine's cuda_graphs=False, what the
                  grid did over distinct cards before its rounds were
                  captured), then graphs, graphs, eager;

each with the steady decode round ms (rounds with no prefill queued),
TTFT median and max, decode tokens/s, the wall time of the burst, graph
replays, and the grid collective's launches by card and its plain calls
(the grids' tokens are held to one card named N times by
tests/test_torch_grid_cards.py; bf16 shard sums round apart from one
card's products, so they are not compared here); then

  collective      the grid collective (ops/grid_collective.py) at a decode
                  partial (8 x 4096 bf16) and a prefill chunk's (256 x 4096
                  bf16): sum over 2 and 4 distinct cards and over cuda:0
                  named twice, each op's device ms from CUDA graphs of
                  OPS_PER_GRAPH ops a card (every card's graph replayed,
                  then timed by events on each card; the slowest card's),
                  beside the same launches eagerly, the plain helper
                  (`Tensor.to` to the first card, summed there) and
                  torch.cuda.nccl.all_reduce over the same cards in one
                  process, both eager and timed by events on cuda:0, and
                  the bound: (T - 1) x the partial's bytes over NVLink at
                  450 GB/s a direction.

`--eager-only` runs the grid rows in eager turns alone and no collective
line, with nothing this script needs beyond serve_lm's runtime: it runs
from a checkout that predates the collective (the baseline). Every line
carries `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
of the cards.
"""
import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NEW_TOKENS = 32
OPS_PER_GRAPH = 100
NVLINK_BYTES_PER_S = 450e9
GRIDS = (('tensor2', 1, 2), ('tensor4', 1, 4), ('stages2_tensor2', 2, 2))
SHAPES = (('decode', (8, 4096)), ('chunk', (256, 4096)))


def prompts(seed=0, n=8, vocab=128256):
    """chip_smoke.py's 8 prompts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(300, 701, n)
    out = [rng.integers(1, vocab, int(l)).tolist() for l in lens]
    out[1] = out[0][:256] + out[1][256:]      # a shared 256-token prefix
    return out


def emit(card, name, **fields):
    print(json.dumps({'phase': name, 'card': card, **fields}), flush=True)


def runtime(model, flags, devices, cuda_graphs):
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        'bf16', '--kv-pool-bytes', '8000000000', '--port', '0', *flags])
    return build_runtime(args, model=model, cuda_graphs=cuda_graphs,
                         devices=devices)


def burst(eng, ps):
    """Greedy tokens of `ps` (NEW_TOKENS each, all queued at once after a
    warm-up request) and the burst's numbers."""
    eng.submit(ps[0][:64], max_new_tokens=2).result(timeout=600)
    s0 = eng.stats()
    first = [None] * len(ps)
    t0 = time.perf_counter()

    def on_token(i):
        def record(_tok):
            if first[i] is None:
                first[i] = time.perf_counter() - t0
        return record

    futs = [eng.submit(list(p), max_new_tokens=NEW_TOKENS,
                       on_token=on_token(i)) for i, p in enumerate(ps)]
    tokens = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    s1 = eng.stats()
    steady_s = s1['steady_decode_s'] - s0['steady_decode_s']
    rounds = s1['steady_decode_rounds'] - s0['steady_decode_rounds']
    ttft = sorted(first)
    return tokens, {
        'decode_round_ms': 1e3 * steady_s / rounds if rounds else None,
        'steady_rounds': rounds,
        'decode_tokens_per_s': ((s1['steady_decode_tokens']
                                 - s0['steady_decode_tokens']) / steady_s
                                if steady_s else None),
        'ttft_p50_s': float(np.median(ttft)), 'ttft_max_s': ttft[-1],
        'wall_s': wall, 'tokens_per_s': NEW_TOKENS * len(ps) / wall,
        'graph_replays': s1['graph_replays'] - s0['graph_replays'],
        'cuda_graphs': s1['cuda_graphs']}


def collective_counts():
    try:
        from skypilot_tpu_torch.ops import grid_collective
    except ImportError:
        return None
    return {'launches_by_device': dict(grid_collective.launches_by_device),
            'plain_calls': grid_collective.plain_calls}


def serve_turns(model, flags, devices, modes, ps):
    """Each mode's burst on a runtime of its own: {turn: numbers}."""
    out = {}
    for i, graphs in enumerate(modes):
        before = collective_counts()
        t0 = time.perf_counter()
        rt = runtime(model, flags, devices, graphs)
        setup_s = time.perf_counter() - t0
        try:
            _, nums = burst(rt.engine, ps)
        finally:
            rt.stop()
        after = collective_counts()
        if after is not None:
            nums['collective_launches_by_device'] = {
                d: n - before['launches_by_device'].get(d, 0)
                for d, n in after['launches_by_device'].items()
                if n != before['launches_by_device'].get(d, 0)}
            nums['collective_plain_calls'] = (after['plain_calls']
                                              - before['plain_calls'])
        nums['setup_s'] = setup_s
        out[f'turn{i}_{"graphs" if graphs else "eager"}'] = nums
        del rt
        gc.collect()
        for d in range(torch.cuda.device_count()):
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    return out


def sync_all(cards):
    for d in cards:
        torch.cuda.synchronize(d)


def graphed_ms(cards, fn, n=OPS_PER_GRAPH):
    """Device ms of one `fn()` (collective launches on every card of
    `cards`), from one CUDA graph a card of n calls captured together:
    every card's graph replayed once to warm, then timed by events on
    each card around one replay of all; the slowest card's ms / n."""
    sides = {d: torch.cuda.Stream(d) for d in cards}
    for _ in range(3):
        fn()
    sync_all(cards)
    graphs = {d: torch.cuda.CUDAGraph() for d in cards}
    import contextlib
    with contextlib.ExitStack() as stack:
        for d in cards:
            stack.enter_context(torch.cuda.stream(sides[d]))
        for d in cards:
            with torch.cuda.device(d):
                graphs[d].capture_begin(capture_error_mode='relaxed')
        for _ in range(n):
            fn()
        for d in reversed(cards):
            with torch.cuda.device(d):
                graphs[d].capture_end()
    sync_all(cards)
    for d in cards:
        graphs[d].replay()
    sync_all(cards)
    ev = {d: (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for d in cards}
    for d in cards:
        with torch.cuda.device(d):
            ev[d][0].record()
    for d in cards:
        graphs[d].replay()
    for d in cards:
        with torch.cuda.device(d):
            ev[d][1].record()
    sync_all(cards)
    return max(ev[d][0].elapsed_time(ev[d][1]) for d in cards) / n


def eager_ms(cards, fn, n=OPS_PER_GRAPH):
    """ms of one `fn()` run back to back eagerly, by events on the first
    card (host launch overhead included where it exceeds the device's)."""
    for _ in range(3):
        fn()
    sync_all(cards)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    with torch.cuda.device(cards[0]):
        start.record()
    for _ in range(n):
        fn()
    with torch.cuda.device(cards[0]):
        end.record()
    sync_all(cards)
    return start.elapsed_time(end) / n


def collective_line(card):
    from skypilot_tpu_torch.ops import grid_collective as gcol
    rows = []
    teams = [('cards2', ['cuda:0', 'cuda:1']),
             ('cards4', ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3']),
             ('one_card_x2', ['cuda:0', 'cuda:0'])]
    for label, devs in teams:
        team = gcol.Team(devs)
        cards = [torch.device(d) for d in team.cards]
        for shape_name, shape in SHAPES:
            g = torch.Generator().manual_seed(0)
            parts = [torch.randn(shape, generator=g).to(torch.bfloat16)
                     .to(d) for d in devs]
            got = gcol.all_reduce(parts, team)
            want = gcol.all_reduce_reference(parts)
            exact = all(torch.equal(a.cpu(), b.cpu())
                        for a, b in zip(got, want))
            nbytes = parts[0].numel() * parts[0].element_size()
            row = {'team': label, 'ranks': len(devs), 'cards': len(cards),
                   'shape': list(shape), 'dtype': 'bf16', 'exact': exact,
                   'ms': graphed_ms(cards, lambda: gcol.all_reduce(parts,
                                                                   team)),
                   'eager_ms': eager_ms(cards, lambda: gcol.all_reduce(
                       parts, team)),
                   'plain_ms': eager_ms(cards, lambda: gcol.
                                        all_reduce_reference(parts))}
            if len(cards) > 1:
                row['bound_ms'] = 1e3 * gcol.bound_bytes(
                    'sum', len(devs), nbytes) / NVLINK_BYTES_PER_S
                row['bound_by'] = 'NVLink bytes (latency-bound under a few us)'
                outs = [torch.empty_like(p) for p in parts]
                row['nccl_ms'] = eager_ms(cards, lambda: torch.cuda.nccl.
                                          all_reduce(parts, outs))
            else:
                row['bound_ms'] = 1e3 * (len(devs) + 1) * nbytes / 3.35e12
                row['bound_by'] = 'HBM bytes (T parts read, one written)'
                row['nccl_ms'] = None
            rows.append(row)
        team.close()
    emit(card, 'collective', rows=rows)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--eager-only', action='store_true')
    parser.add_argument('--grids', default=','.join(g[0] for g in GRIDS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_grid: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_description()
    count = torch.cuda.device_count()
    print(card, flush=True)
    _build.build_all()
    want = [g for g in GRIDS if g[0] in args.grids.split(',')]
    if count < max(s * t for _, s, t in want):
        print(f'profile_grid: {count} cards visible; the grids need '
              f'{max(s * t for _, s, t in want)}', file=sys.stderr)
        return 1
    cfg = registry.model_config('llama3-8b', 1024)
    on_card = convert.init_params(cfg, seed=0, device='cuda:0')
    torch.cuda.synchronize()
    host = convert.assemble(cfg, {k: v.to('cpu') for k, v in
                                  on_card.state_dict().items()})
    ps = prompts()
    if not args.eager_only:
        emit(card, 'one_card',
             **serve_turns(on_card, [], None, (True,), ps))
    del on_card
    gc.collect()
    torch.cuda.empty_cache()
    modes = (False,) if args.eager_only else (False, True, True, False)
    for label, stages, tensor in want:
        flags = ['--tensor', str(tensor)] + (
            ['--stages', str(stages)] if stages > 1 else [])
        turns = serve_turns(host, flags, None, modes, ps)
        emit(card, label, stages=stages, tensor=tensor, **turns)
    if not args.eager_only:
        collective_line(card)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
