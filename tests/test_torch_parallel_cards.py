"""`train_lm --expert`, `--seq-parallel`, `--pipeline-stages` and
`--tensor` on NCCL over distinct CUDA cards: the sharded trainer's
expert, seq and tensor axes (parallel/fsdp.py,
models/mixtral.py's expert group, ops/ring_attention.py) as one job of
ranks, one a card. Marked `card`: each test skips unless the host has
the cards it needs. On a host with 4 cards (`--noconftest`: the
suite's conftest sets up JAX, which a card host need not have):

    python -m pytest --noconftest tests/test_torch_parallel_cards.py \
        -m card -q -s

  - expert jobs: `--expert 2` and `--expert 4` at Mixtral-8x7B width,
    2 layers, seq 2048, batch 1, --remat (chip_smoke's `train_mixtral`
    shape), 3 steps;
  - seq jobs: `--seq-parallel 2` and `4` at Llama-3-8B width, 4 layers,
    seq 8192, batch 1, --remat, 3 steps;
  - each job's step-1 loss and grad norm are held to a one-card run of
    the same seed and batch, relative, within bounds that a control
    must fail: the job's step 1 once more with its path broken on
    purpose (W.card_faults: experts, the combine or the gradient of the
    experts' inputs not summed over the expert group; seq, a ring that
    skips a rotation), which must fall outside them.
    Expert jobs: against the one-card trainer with its experts computed
    in `expert` parts, each as an expert rank computes its own, summed
    in f32 before the bf16 cast (W.experts_in_parts: the same order of
    sums as the job's all-reduce), within the bound measured in the same
    run (chip_smoke's train_fsdp pattern): NORM_SPREAD times the spread of
    that trainer's own step 1 over REPEATS evaluations (its flash
    backward is not deterministic), at least FSDP_TOL. The plain
    one-card run sums every expert in one einsum: its offset from the
    job and from the witness is printed beside.
    Seq jobs: against the plain one-card trainer (flash) within SEQ_TOL,
    the norm at least NORM_SPREAD times its spread: the ring attends in
    f32 in another order than the flash kernels, so bf16 activations
    differ in the last bit here and there;
  - expert jobs launch flash_fwd 2 x layers and flash_bwd layers times a
    step on every rank (remat), with no plain flash call and no ring
    step; seq jobs launch no flash kernel and make K ring steps a layer
    in each forward (remat: two) and backward;
  - every rank reports the same curve; the leaves every expert rank
    holds end bit-identical across them.

  - pipeline jobs (`pipe2`: stage 2, 2 ranks; `pipe2x2`: stage 2 x
    data 2, 4 ranks; parallel/pipeline.py over the mesh's stage and
    data axes): Llama-3-8B width, 4 layers, B=8, seq 2048, 1f1b,
    microbatches of one row (8 at data 1, 4 a data rank at data 2:
    the same rows, `microbatch_rows`); each job's step-1 loss and grad
    norm are held to the in-process pipeline on cuda:0 named twice (a
    process of its own), within NORM_SPREAD times that run's spread over
    REPEATS more readings (at least FSDP_TOL), and the job's step 1 with
    the runner broken on purpose (chip_smoke's PIPE_FAULTS: a
    microbatch's backward skipped, a forward hand-off delivering the
    previous microbatch's activation) must fall outside; every rank
    launches flash_fwd
    2 x its layers x its microbatches and flash_bwd half that a step,
    no plain call; every rank reports the same curve. The line records
    step s, tokens/s a card, peak GB a card, and the P2P hand-offs and
    collectives a step.

  - tensor jobs (`tensor2`: 2 ranks; `fsdp2_tensor2`, `stage2_tensor2`:
    4; parallel/tensor.py over the mesh's `tensor` axis, with FSDP or
    within pipeline stages) at train_full's shape (Llama-3-8B width, 4
    layers, B=8, seq 2048; the pipeline 1f1b, a microbatch a row), and
    `stage2_expert2` (Mixtral-8x7B width, 2 layers, B=2, seq 2048:
    experts within stages): each job's step-1 loss and grad norm are
    held to the same mesh in process on one card (a process of its own:
    `ShardedTrainer(devices=['cuda:0'] * 2)`, its rows in the fsdp
    ranks' two blocks for `fsdp2_tensor2`; the pipeline over a
    [2][2] grid of the card; experts summed in the job's two parts)
    within NORM_SPREAD times that run's spread over REPEATS more
    readings (at least FSDP_TOL), and the job's step 1 with its path
    broken on purpose (chip_smoke's TENSOR_FAULTS: copy-to-group's
    backward sum skipped, the vocab-parallel max dropped; within stages,
    whose vocab tables are whole over `tensor`, TENSOR_STAGE_FAULTS:
    the backward sum skipped, the forward sum of the shards' partial
    outputs skipped; experts, card_faults') must fall outside; flash launches a step at the
    shard's heads (16 q, 4 kv), no plain call; every rank reports the
    same curve.

Each test prints one line, `parallel_cards <name> <json>`, with its
measurements (step times, tokens/s per card, MFU, peak GB against one
card's, all-reduces and ring ms a step); the card's name and power
limit come first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402

from skypilot_tpu_torch.parallel import distributed  # noqa: E402

pytestmark = pytest.mark.card

REPEATS = 4
NORM_SPREAD = 2.0
FSDP_TOL = 1e-5
SEQ_TOL = 1e-4
BF16_FLOPS = 989e12
DEADLINE_S = 900
EXPERT = W.card_spec('mixtral-8x7b', layers=2, seq=2048, steps=3)
SEQ = W.card_spec('llama3-8b', layers=4, seq=8192, steps=3)


def need_cards(n: int) -> None:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        pytest.skip(f'needs {n} CUDA cards; {count} visible')


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=False).stdout.strip()


def launch(target, world, out, *args):
    jobs = distributed.jobs(cpu=False, workers=world)
    code = distributed.launch(target, (str(out), *args), jobs,
                              deadline_s=DEADLINE_S)
    assert code == 0, f'{target.__name__} on {world} cards exited {code}'
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope='module')
def built():
    need_cards(2)
    from skypilot_tpu_torch.ops import _build
    _build.build_all()
    print(f'parallel_cards card {card_line()}', flush=True)


def spread(values, ref):
    return (max(values) - min(values)) / abs(ref)


def one_card(spec, out, witness=()):
    """The one-card trainer on `spec`, in a process of its own (its
    memory is freed before the jobs start)."""
    one, = launch(W.card_one_job, 1, out, spec, REPEATS, tuple(witness))
    loss, norm = one['losses'][0], one['norms'][0]
    one['loss_spread'] = spread([x for x, _ in one['step1']] + [loss], loss)
    one['spread'] = spread([x for _, x in one['step1']] + [norm], norm)
    return one


@pytest.fixture(scope='module')
def one_mixtral(built, tmp_path_factory):
    return one_card(EXPERT, tmp_path_factory.mktemp('one_mixtral'),
                    witness=(2, 4))


@pytest.fixture(scope='module')
def one_llama(built, tmp_path_factory):
    return one_card(SEQ, tmp_path_factory.mktemp('one_llama'))


def offsets(got, want):
    """Relative (loss, norm) offsets of `got` from `want`."""
    return tuple(abs(a - b) / abs(b) for a, b in zip(got, want))


def summarize(name, spec, ranks, one, ref, bounds):
    """Hold the job's step 1 and its controls' to `ref` (loss, norm)
    within `bounds` (loss, norm), after printing the line."""
    world = len(ranks)
    first = ranks[0]
    for rank in ranks[1:]:
        assert rank['losses'] == first['losses'], name
        assert rank['norms'] == first['norms'], name
        assert rank['controls'] == first['controls'], name
    step1 = (first['losses'][0], first['norms'][0])
    sound = offsets(step1, ref)
    controls = {k: offsets(v, ref) for k, v in first['controls'].items()}
    plain = (one['losses'][0], one['norms'][0])
    steady = first['times'][1:]
    step_s = float(np.mean(steady))
    tokens = spec['batch'] * spec['seq']
    per_card = tokens / step_s / world
    one_step = float(np.mean(one['times'][1:]))
    record = {
        'world': world, 'mesh': first['summary'], 'spec': spec,
        'losses': first['losses'], 'norms': first['norms'],
        'one_card_losses': one['losses'], 'one_card_norms': one['norms'],
        'reference_step1': list(ref), 'step1_rel_err': list(sound),
        'bounds': list(bounds), 'controls_rel_err': controls,
        'one_card_loss_spread': one['loss_spread'],
        'one_card_spread': one['spread'],
        'job_vs_plain_one_card': list(offsets(step1, plain)),
        'witness_vs_plain_one_card': {
            k: list(offsets(v, plain)) for k, v in one['witness'].items()},
        'step_times_s': first['times'], 'step_s': step_s,
        'one_card_step_s': one_step,
        'tokens_per_s_per_card': per_card,
        'one_card_tokens_per_s': tokens / one_step,
        'mfu': 6.0 * one['matmul_params'] * per_card / BF16_FLOPS,
        'one_card_mfu': 6.0 * one['matmul_params'] * tokens / one_step
        / BF16_FLOPS,
        'peak_gb': [r['peak_gb'] for r in ranks],
        'one_card_peak_gb': one['peak_gb'],
        'all_reduces_a_step': first['all_reduces'] / spec['steps'],
        'layout_reductions_a_step': {
            k: v / spec['steps']
            for k, v in first['layout_reductions'].items()},
        'ring_ms_a_step': [r['ring_ms'] for r in ranks],
        'flash': [r['flash'] for r in ranks],
        'ring_steps': [r['ring_steps'] for r in ranks]}
    print(f'parallel_cards {name} {json.dumps(record)}', flush=True)
    assert all(np.isfinite(first['losses'] + first['norms'])), first
    assert all(e <= b for e, b in zip(sound, bounds)), (name, record)
    assert controls and all(any(e > b for e, b in zip(errs, bounds))
                            for errs in controls.values()), (name, record)
    return record


@pytest.mark.parametrize('expert', [2, 4])
def test_expert_job_on_nccl(expert, one_mixtral, tmp_path):
    need_cards(expert)
    spec = dict(EXPERT, expert=expert)
    ranks = launch(W.card_train_job, expert, tmp_path, spec)
    one = one_mixtral
    summarize(f'expert{expert}', spec, ranks, one, one['witness'][expert],
              (max(FSDP_TOL, NORM_SPREAD * one['loss_spread']),
               max(FSDP_TOL, NORM_SPREAD * one['spread'])))
    layers, steps = spec['layers'], spec['steps']
    for rank in ranks:
        assert rank['summary'] == f'Mesh(expert={expert})'
        assert rank['flash'] == (2 * layers * steps, layers * steps, 0)
        assert rank['ring_steps'] == (0, 0)
        assert rank['layout_reductions']['expert'] > 0
        assert rank['replicated_digest'] == ranks[0]['replicated_digest']


@pytest.mark.parametrize('ways', [2, 4])
def test_seq_job_on_nccl(ways, one_llama, tmp_path):
    need_cards(ways)
    spec = dict(SEQ, seq_parallel=ways)
    ranks = launch(W.card_train_job, ways, tmp_path, spec)
    one = one_llama
    summarize(f'seq{ways}', spec, ranks, one,
              (one['losses'][0], one['norms'][0]),
              (SEQ_TOL, max(SEQ_TOL, NORM_SPREAD * one['spread'])))
    layers, steps = spec['layers'], spec['steps']
    for rank in ranks:
        assert rank['summary'] == f'Mesh(seq={ways})'
        assert rank['flash'] == (0, 0, 0)
        assert rank['ring_steps'] == (2 * layers * steps * ways,
                                      layers * steps * ways)


PIPE = W.card_spec('llama3-8b', layers=4, seq=2048, steps=3, batch=8)


@pytest.fixture(scope='module')
def one_pipe(built, tmp_path_factory):
    """The in-process pipeline on one card named twice, in a process of
    its own: its step-1 readings' spread sets the bounds."""
    one, = launch(W.card_pipe_job, 1, tmp_path_factory.mktemp('one_pipe'),
                  PIPE, REPEATS)
    ref = one['step1'][0]
    one['bounds'] = [max(FSDP_TOL, NORM_SPREAD * spread(
        [r[k] for r in one['step1']], ref[k])) for k in (0, 1)]
    return one


@pytest.mark.parametrize('world', [2, 4], ids=['pipe2', 'pipe2x2'])
def test_pipeline_job_on_nccl(world, one_pipe, tmp_path):
    need_cards(world)
    ranks = launch(W.card_pipe_job, world, tmp_path, PIPE, 0)
    one, bounds = one_pipe, one_pipe['bounds']
    ref = one['step1'][0]
    first = ranks[0]
    for rank in ranks[1:]:
        assert rank['losses'] == first['losses']
        assert rank['norms'] == first['norms']
        assert rank['step1'] == first['step1']
    sound = offsets(first['step1'][0], ref)
    controls = {k: offsets(v, ref) for k, v in first['controls'].items()}
    data = world // 2
    layers = PIPE['layers'] // 2
    micro = PIPE['batch'] // data
    steps = PIPE['steps']
    tokens = PIPE['batch'] * PIPE['seq']
    step_s = float(np.mean(first['times'][1:]))
    one_step = float(np.mean(one['times'][1:]))
    record = {
        'world': world, 'mesh': f'Mesh(data={data}, stage=2)'
        if data > 1 else 'Mesh(stage=2)', 'spec': PIPE,
        'microbatches_a_data_rank': micro,
        'losses': first['losses'], 'norms': first['norms'],
        'in_process_step1': list(ref), 'in_process_step1_readings':
        one['step1'], 'bounds': bounds, 'step1_rel_err': list(sound),
        'controls_rel_err': controls,
        'step_times_s': first['times'], 'step_s': step_s,
        'in_process_step_s': one_step,
        'tokens_per_s_per_card': tokens / step_s / world,
        'in_process_tokens_per_s': tokens / one_step,
        'mfu': 6.0 * one['matmul_params'] * tokens / step_s / world
        / BF16_FLOPS,
        'peak_gb': [r['peak_gb'] for r in ranks],
        'in_process_peak_gb': one['peak_gb'],
        'handoffs_a_step': first['handoffs_a_step'],
        'collectives_a_step': [r['collectives_a_step'] for r in ranks],
        'ticks': first['ticks'], 'bubble_fraction': first['bubble_fraction'],
        'flash': [r['flash'] for r in ranks]}
    print(f'parallel_cards pipe{"2x2" if data > 1 else "2"} '
          f'{json.dumps(record)}', flush=True)
    assert all(np.isfinite(first['losses'] + first['norms'])), record
    assert all(e <= b for e, b in zip(sound, bounds)), record
    assert controls and all(any(e > b for e, b in zip(errs, bounds))
                            for errs in controls.values()), record
    assert sorted((r['data'], r['stage']) for r in ranks) == sorted(
        (d, s) for d in range(data) for s in range(2))
    for rank in ranks:
        assert rank['flash'] == (2 * layers * micro * steps,
                                 layers * micro * steps, 0), record


# -- tensor parallelism, and experts within pipeline stages ---------------------
TENSOR = W.card_spec('llama3-8b', layers=4, seq=2048, steps=3, batch=8)
EXPERT_PIPE = W.card_spec('mixtral-8x7b', layers=2, seq=2048, steps=3,
                          batch=2)
#: name: (spec, MeshConfig fields, the in-process witness's key).
TENSOR_JOBS = {
    'tensor2': (TENSOR, {'tensor': 2}, 'tensor2'),
    'fsdp2_tensor2': (TENSOR, {'fsdp': 2, 'tensor': 2}, 'tensor2_halves'),
    'stage2_tensor2': (TENSOR, {'stage': 2, 'tensor': 2}, 'stage2_tensor2'),
    'stage2_expert2': (EXPERT_PIPE, {'stage': 2, 'expert': 2},
                       'stage2_expert2'),
}
#: key: (spec, the mesh it stands for, row blocks).
TENSOR_WITNESSES = {
    'tensor2': (TENSOR, {'tensor': 2}, 1),
    'tensor2_halves': (TENSOR, {'tensor': 2}, 2),
    'stage2_tensor2': (TENSOR, {'stage': 2, 'tensor': 2}, 1),
    'stage2_expert2': (EXPERT_PIPE, {'stage': 2, 'expert': 2}, 1),
}


@pytest.fixture(scope='module')
def tensor_witness(built, tmp_path_factory):
    """{key: the in-process run on one card (a process of its own), with
    its bounds}: NORM_SPREAD times the spread of REPEATS more readings,
    at least FSDP_TOL."""
    out = {}

    def get(key):
        if key not in out:
            spec, fields, parts = TENSOR_WITNESSES[key]
            one, = launch(W.card_tensor_job, 1,
                          tmp_path_factory.mktemp(f'one_{key}'), spec,
                          fields, REPEATS, parts)
            ref = one['step1'][0]
            one['bounds'] = [max(FSDP_TOL, NORM_SPREAD * spread(
                [r[k] for r in one['step1']], ref[k])) for k in (0, 1)]
            out[key] = one
        return out[key]

    return get


@pytest.mark.parametrize('name', sorted(TENSOR_JOBS))
def test_tensor_job_on_nccl(name, tensor_witness, tmp_path):
    spec, fields, key = TENSOR_JOBS[name]
    world = int(np.prod(list(fields.values())))
    need_cards(world)
    one = tensor_witness(key)
    ranks = launch(W.card_tensor_job, world, tmp_path, spec, fields, 0)
    bounds, ref = one['bounds'], one['step1'][0]
    first = ranks[0]
    for rank in ranks[1:]:
        assert rank['losses'] == first['losses'], name
        assert rank['norms'] == first['norms'], name
    sound = offsets(first['step1'][0], ref)
    controls = {k: offsets(v, ref) for k, v in first['controls'].items()}
    tokens = spec['batch'] * spec['seq']
    step_s = float(np.mean(first['times'][1:]))
    one_step = float(np.mean(one['times'][1:]))
    record = {
        'world': world, 'mesh': first['summary'], 'spec': spec,
        'losses': first['losses'], 'norms': first['norms'],
        'in_process': key, 'in_process_step1': list(ref),
        'in_process_step1_readings': one['step1'], 'bounds': bounds,
        'step1_rel_err': list(sound), 'controls_rel_err': controls,
        'step_times_s': first['times'], 'step_s': step_s,
        'in_process_step_s': one_step,
        'tokens_per_s_per_card': tokens / step_s / world,
        'in_process_tokens_per_s': tokens / one_step,
        'mfu': 6.0 * one['matmul_params'] * tokens / step_s / world
        / BF16_FLOPS,
        'peak_gb': [r['peak_gb'] for r in ranks],
        'in_process_peak_gb': one['peak_gb'],
        'shard_sums_a_step': first['shard_sums_a_step'],
        'all_reduces_a_step': [r['all_reduces_a_step'] for r in ranks],
        'flash': [r['flash'] for r in ranks],
        'flash_heads': first['flash_heads']}
    print(f'parallel_cards {name} {json.dumps(record)}', flush=True)
    assert all(np.isfinite(first['losses'] + first['norms'])), record
    assert all(e <= b for e, b in zip(sound, bounds)), record
    assert controls and all(any(e > b for e, b in zip(errs, bounds))
                            for errs in controls.values()), record
    layers, steps = spec['layers'], spec['steps']
    stage, tensor = fields.get('stage', 1), fields.get('tensor', 1)
    per_rank = layers // stage
    for rank in ranks:
        if stage > 1:
            micro = spec['batch']
            assert rank['flash'] == (2 * per_rank * micro * steps,
                                     per_rank * micro * steps, 0), record
        else:
            assert rank['flash'] == (per_rank * steps, per_rank * steps,
                                     0), record
    heads = (32 // tensor, 8 // tensor, 128) if spec is TENSOR else (
        32, 8, 128)
    assert [list(h) for h in first['flash_heads']] == [list(heads)], record
