"""serve_lm --tensor / --stages over distinct CUDA cards: the grid path
that one card named several times does not reach (each shard's kernels
launched on its own card, from that card's context, with the kernels'
attributes set on each card). Marked `card`: each test skips unless the
host has the cards it needs. On a host with 4 cards (`--noconftest`:
the suite's conftest sets up JAX, which a card host need not have):

    python -m pytest --noconftest tests/test_torch_grid_cards.py -m card -q

A grid of distinct cards must give the tokens that the same grid on one
card named several times gives (the same kernels at the same shapes in
the same order, both run eagerly), and, in f32, the greedy tokens of one
device.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching, convert, lora, registry
from skypilot_tpu_torch.ops import int8_linear, lora_kernel, paged_kernel
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
    """(tokens, the grid's distinct devices) through build_runtime with
    serve_lm's flags over `devices` (None: the first distinct cards),
    decode rounds eager."""
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '4',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        'bf16', '--kv-pool-bytes', '300000000', '--port', '0', *flags])
    rt = build_runtime(args, model=model, cuda_graphs=False, devices=devices)
    try:
        grid = rt.engine.model.grid
        placed = sorted({str(d) for row in grid.devices for d in row})
        lora_run = '--adapter-dir' in flags
        return drive(rt.engine, ADAPTERS if lora_run else None), placed
    finally:
        rt.stop()


def zero_counts() -> None:
    paged_kernel.launches = paged_kernel.plain_calls = 0
    paged_kernel.route_launches.update(dict.fromkeys(paged_kernel.ROUTES,
                                                     0))
    lora_kernel.launches = lora_kernel.plain_calls = 0
    int8_linear.launches = int8_linear.plain_calls = 0


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
    one, placed_one = serve(copy.deepcopy(model).to('cuda:0'), flags,
                            ['cuda:0'] * n)
    zero_counts()
    got, placed = serve(model, flags, None)
    assert placed_one == ['cuda:0']
    assert placed == [f'cuda:{i}' for i in range(n)]
    assert got == one
    assert paged_kernel.route_launches['split'] > 0
    assert paged_kernel.route_launches['chunk'] > 0
    assert paged_kernel.plain_calls == 0
    assert (lora_kernel.launches > 0) == (variant == 'tensor2_lora')
    assert (int8_linear.launches > 0) == (variant == 'tensor2_int8_weights')
    assert lora_kernel.plain_calls == int8_linear.plain_calls == 0


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
