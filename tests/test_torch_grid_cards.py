"""serve_lm --tensor / --stages over distinct CUDA cards: the grid path
that one card named several times does not reach (each shard's kernels
launched on its own card, from that card's context, with the kernels'
attributes set on each card; the grid's collective trading parts over
NVLink; each decode round one CUDA graph a card). Marked `card`: each
test skips unless the host has the cards it needs. On a host with 4
cards (`--noconftest`: the suite's conftest sets up JAX, which a card
host need not have):

    python -m pytest --noconftest tests/test_torch_grid_cards.py -m card -q

A grid of distinct cards, its decode rounds replayed as graphs, must give
the tokens that the same grid on one card named several times gives (the
same kernels at the same shapes in the same order, and sums of the same
bits in the same shard order), through the collective kernel with no
plain call; and, in f32, the greedy tokens of one device. A collective
one ulp off on one shard must change the tokens or fail the kernel's
check against its plain version, and a collective whose peer never
launches must fail instead of hanging.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching, convert, lora, registry
from skypilot_tpu_torch.ops import (grid_collective, int8_linear,
                                    lora_kernel, paged_kernel)
from skypilot_tpu_torch.parallel import serving
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.recipes import serve_lm

pytestmark = pytest.mark.card

LAYERS = 2
NEW_TOKENS = 8
_RNG = np.random.default_rng(7)
# A 300-token prompt takes two 256-token prefill chunks (the chunk
# route); decode rounds take the split route.
PROMPTS = [_RNG.integers(1, 128256, n).tolist() for n in (40, 300, 17)]
ADAPTERS = ['attn8', None, 'mlp16']
VARIANTS = {
    'tensor2': ['--tensor', '2'],
    'tensor2_int8kv': ['--tensor', '2', '--kv-dtype', 'int8'],
    'tensor2_int8_weights': ['--tensor', '2', '--weight-dtype', 'int8'],
    'tensor2_lora': ['--tensor', '2', '--max-adapters', '3'],
    'stages2': ['--stages', '2'],
    'stages2_tensor2': ['--stages', '2', '--tensor', '2'],
    'tensor4': ['--tensor', '4'],
}


def need_cards(n: int) -> None:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        pytest.skip(f'needs {n} CUDA cards; {count} visible')


def llama_config(**kw):
    return dataclasses.replace(registry.model_config('llama3-8b', 1024),
                               num_layers=LAYERS, **kw)


@pytest.fixture(scope='module')
def weights():
    """Seeded bf16 and int8 Llama-3-8B widths cut to LAYERS layers, on
    the CPU, where a grid of distinct cards takes its shards from."""
    need_cards(2)
    return {w: convert.init_params(llama_config(), seed=0, device='cpu',
                                   weight_dtype=w) for w in ('bf16', 'int8')}


@pytest.fixture(scope='module')
def adapter_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('adapters')
    for i, (name, rank, targets) in enumerate((('attn8', 8, 'attn'),
                                               ('mlp16', 16, 'attn-mlp'))):
        spec = lora.LoraSpec(rank=rank, alpha=2.0 * rank,
                             targets=lora.targets_from_name(targets))
        lora.save_adapter(str(root / name), lora.random_adapter_params(
            10 + i, llama_config(), spec), spec, base_model='llama3-8b')
    return str(root)


def drive(eng, adapters=None):
    """Greedy tokens of PROMPTS, the engine iterated on this thread (its
    scheduler stopped) so two engines schedule them alike."""
    # pylint: disable=protected-access
    eng.stop()
    adapters = adapters or [None] * len(PROMPTS)
    futs = [eng.submit(list(p), max_new_tokens=NEW_TOKENS, adapter=a)
            for p, a in zip(PROMPTS, adapters)]
    with torch.no_grad():
        for _ in range(2000):
            if all(f.done() for f in futs) and not eng.active.any() \
                    and not eng._in_flight():
                break
            eng._iterate()
    return [f.result(timeout=1) for f in futs]


def serve(model, flags, devices):
    """(tokens, the grid's distinct devices, the graph replays) through
    build_runtime with serve_lm's flags over `devices` (None: the first
    distinct cards), decode rounds replayed as CUDA graphs."""
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '4',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        'bf16', '--kv-pool-bytes', '300000000', '--port', '0', *flags])
    rt = build_runtime(args, model=model, devices=devices)
    try:
        eng = rt.engine
        assert eng.cuda_graphs
        assert not hasattr(eng._rounds[0], 'graph_blocker')  # pylint: disable=protected-access
        grid = eng.model.grid
        placed = sorted({str(d) for row in grid.devices for d in row})
        lora_run = '--adapter-dir' in flags
        tokens = drive(eng, ADAPTERS if lora_run else None)
        return tokens, placed, eng.stats()['graph_replays']
    finally:
        rt.stop()


def zero_counts() -> None:
    paged_kernel.launches = paged_kernel.plain_calls = 0
    paged_kernel.route_launches.update(dict.fromkeys(paged_kernel.ROUTES,
                                                     0))
    lora_kernel.launches = lora_kernel.plain_calls = 0
    int8_linear.launches = int8_linear.plain_calls = 0
    grid_collective.launches = grid_collective.plain_calls = 0
    grid_collective.launches_by_device.clear()


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_distinct_cards_give_one_cards_tokens(variant, weights,
                                              adapter_dir):
    flags = list(VARIANTS[variant])
    n = int(np.prod([int(flags[i + 1]) for i, f in enumerate(flags)
                     if f in ('--tensor', '--stages')]))
    need_cards(n)
    if variant == 'tensor2_lora':
        flags += ['--adapter-dir', adapter_dir]
    model = weights['int8' if variant == 'tensor2_int8_weights'
                    else 'bf16']
    one, placed_one, replays_one = serve(copy.deepcopy(model).to('cuda:0'),
                                         flags, ['cuda:0'] * n)
    zero_counts()
    got, placed, replays = serve(model, flags, None)
    cards = [f'cuda:{i}' for i in range(n)]
    assert placed_one == ['cuda:0']
    assert placed == cards
    assert replays_one > 0 and replays > 0
    assert got == one
    assert paged_kernel.route_launches['split'] > 0
    assert paged_kernel.route_launches['chunk'] > 0
    assert paged_kernel.plain_calls == 0
    assert (lora_kernel.launches > 0) == (variant == 'tensor2_lora')
    assert (int8_linear.launches > 0) == (variant == 'tensor2_int8_weights')
    assert lora_kernel.plain_calls == int8_linear.plain_calls == 0
    # The grid's collective ran on every card, never its plain version.
    assert grid_collective.plain_calls == 0
    assert sorted(grid_collective.launches_by_device) == cards
    assert all(grid_collective.launches_by_device[c] > 0 for c in cards)


def test_perturbed_collective_is_caught(weights, monkeypatch):
    """Every sum with its last shard one ulp up: the served tokens change,
    or the kernel's sum of a served prefill partial so moved fails the
    check against the plain sum of the partial as served."""
    need_cards(2)
    flags = ['--tensor', '2']
    good, _, _ = serve(weights['bf16'], flags, None)
    real = grid_collective.all_reduce
    served = {}

    def off_by_one_ulp(parts, team=None, op='sum', **kw):
        if op != 'sum':
            return real(parts, team, op, **kw)
        if parts[0].shape[-2] >= 256 and \
                not torch.cuda.is_current_stream_capturing():
            served['parts'] = [p.clone() for p in parts]  # a chunk's
        moved = list(parts[:-1]) + [grid_collective.next_up(parts[-1])]
        return real(moved, team, op, **kw)

    monkeypatch.setattr(grid_collective, 'all_reduce', off_by_one_ulp)
    bad, _, _ = serve(weights['bf16'], flags, None)
    parts = served['parts']
    team = grid_collective.Team(['cuda:0', 'cuda:1'])
    plain = grid_collective.all_reduce_reference(parts)[0].cpu()
    check_fails = not torch.equal(off_by_one_ulp(parts, team)[0].cpu(),
                                  plain)
    assert bad != good or check_fails
    # The unmoved kernel passes the same check on both cards.
    assert all(torch.equal(o.cpu(), plain) for o in real(parts, team))


def test_mixed_ops_in_graphs_stay_exact():
    """Ops of every size on one team, in the order a round runs them (a
    decode partial's sum, the head's 8 x 64128 f32 gather, an odd-row
    sum, the tokens' broadcast, one-block maxima, a chunk's sum), captured
    into a graph a card with a delay spun on alternating cards before
    each op, and replayed thousands of times: every output on every card
    stays the plain helper's, bit for bit. A card runs up to one op
    ahead of its peer, so this holds only if no card overwrites bytes of
    its exchange buffer that a peer still reads. Three one-block ops a
    replay (an odd count) move block 0's epoch parity against the other
    blocks' at every replay, so a block reads either buffer half while
    its neighbour writes either."""
    need_cards(2)
    devs = [torch.device('cuda:0'), torch.device('cuda:1')]
    team = grid_collective.Team(devs)
    g = torch.Generator().manual_seed(3)

    def parts(shape, dtype):
        return [(torch.randn(shape, generator=g) * 100).to(dtype).to(d)
                for d in devs]

    ops = [('sum', parts((8, 1, 4096), torch.bfloat16)),
           ('gather', parts((8, 64128), torch.float32)),
           ('sum', parts((3, 4096), torch.bfloat16)),
           ('broadcast', [torch.arange(8, dtype=torch.int32,
                                       device=devs[0])]),
           ('max', parts((8, 1), torch.float32)),
           ('max', parts((8, 1), torch.bfloat16)),
           ('sum', parts((1, 256, 4096), torch.bfloat16)),
           ('sum', parts((5, 4096), torch.float32))]
    want = []
    for op, ps in ops:
        if op in ('sum', 'max'):
            want.append(grid_collective.all_reduce_reference(ps, op))
        elif op == 'gather':
            want.append([grid_collective.gather_reference(ps, devs[0])])
        else:
            want.append(grid_collective.broadcast_reference(ps[0], devs))
    bad = {d: torch.zeros((), dtype=torch.int64, device=d) for d in devs}

    def body():
        for i, (op, ps) in enumerate(ops):
            with torch.cuda.device(devs[i % 2]):
                torch.cuda._sleep(20000 * (1 + i % 3))  # pylint: disable=protected-access
            if op in ('sum', 'max'):
                got = grid_collective.all_reduce(ps, team, op)
            elif op == 'gather':
                got = [grid_collective.gather(ps, team)]
            else:
                got = grid_collective.broadcast(ps[0], team)
            for o, w in zip(got, want[i]):
                bad[o.device].add_((o != w).sum())

    sides = {d: torch.cuda.Stream(d) for d in devs}
    for d in devs:
        sides[d].wait_stream(torch.cuda.current_stream(d))

    def on_sides():
        stack = contextlib.ExitStack()
        for d in devs:
            stack.enter_context(torch.cuda.stream(sides[d]))
        return stack

    with on_sides():
        body()
    for d in devs:
        torch.cuda.synchronize(d)
    assert all(int(b) == 0 for b in bad.values())
    graphs = {d: torch.cuda.CUDAGraph() for d in devs}
    with on_sides():
        for d in devs:
            with torch.cuda.device(d):
                graphs[d].capture_begin(capture_error_mode='relaxed')
        body()
        for d in reversed(devs):
            with torch.cuda.device(d):
                graphs[d].capture_end()
    for _ in range(5000):
        for d in devs:
            graphs[d].replay()
    for d in devs:
        torch.cuda.synchronize(d)
    assert {str(d): int(b) for d, b in bad.items()} == \
        {str(d): 0 for d in devs}


def test_scoring_thread_during_decode_rounds(weights):
    """A scoring pass on another thread while the engine replays its
    --tensor 2 rounds over two cards: neither hangs, the scores are those
    of a scoring pass alone and the tokens those of a run alone (every
    cross-card step of either thread holds the grid's lock)."""
    need_cards(2)
    flags = ['--tensor', '2']
    alone, _, _ = serve(weights['bf16'], flags, None)
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '4',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        'bf16', '--kv-pool-bytes', '300000000', '--port', '0', *flags])
    rt = build_runtime(args, model=weights['bf16'], devices=None)
    try:
        ids = PROMPTS[0][:33]
        want = rt.score_logprobs(ids)[0]
        scores, errors = [], []
        done = threading.Event()

        def score_loop():
            try:
                while not done.is_set():
                    scores.append(rt.score_logprobs(ids)[0])
            except Exception as e:  # pylint: disable=broad-except
                errors.append(e)

        thread = threading.Thread(target=score_loop, daemon=True)
        thread.start()
        try:
            busy = drive(rt.engine)
        finally:
            done.set()
            thread.join(timeout=120)
        assert not thread.is_alive() and not errors, errors
        assert scores and all(np.array_equal(s, want) for s in scores)
        assert busy == alone
    finally:
        rt.stop()


BOUNDED_WAIT = """
import sys, torch
sys.path.insert(0, {root!r})
from skypilot_tpu_torch.ops import grid_collective as gc
team = gc.Team(['cuda:0', 'cuda:1'])
x = torch.ones(8, 4096, dtype=torch.bfloat16, device='cuda:0')
out = torch.empty_like(x)
# Card 0 launches its half of a sum; card 1 never does.
gc._run(team, 'sum', [x, None], [out, None], x.numel() * 2,
        dtype_code=1, timeout_ns=2 * 10 ** 9, cards=[0])
torch.cuda.synchronize(0)
print('NO ERROR')
"""


def test_collective_without_its_peer_fails_instead_of_hanging():
    need_cards(2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, '-c',
                           BOUNDED_WAIT.format(root=root)],
                          capture_output=True, text=True, timeout=120)
    elapsed = time.monotonic() - t0
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert 'NO ERROR' not in proc.stdout
    assert 'a peer never launched this op' in proc.stdout, proc.stdout
    assert elapsed < 90


@pytest.mark.parametrize('stages,tensor', [(1, 2), (2, 1), (2, 2)])
def test_f32_distinct_cards_give_one_devices_tokens(stages, tensor):
    n = stages * tensor
    need_cards(n)
    model = convert.init_params(llama_config(dtype=torch.float32), seed=1,
                                device='cuda:0')

    def run(m):
        return drive(batching.ContinuousBatchingEngine(
            m, num_slots=4, max_total_len=1024))

    one = run(model)
    grid = serving.build(model, MeshConfig(stage=stages, tensor=tensor),
                         devices=[f'cuda:{i}' for i in range(n)])
    assert run(grid) == one
