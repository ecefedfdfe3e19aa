"""The port's pipeline over ranks (skypilot_tpu_torch/parallel/pipeline.py
on a data x stage DeviceMesh, gloo, CPU, f32) and `train_lm
--pipeline-stages`:

  - stage 2 (2 ranks, 1f1b on tiny GPT with a vocab of 501): the loss,
    every grad, one AdamW step's loss, norm and parameters are the
    in-process run's (['cpu', 'cpu']) bit for bit, and so are the
    hand-offs and collectives the step makes; the checkpoint rank 0
    writes is the in-process run's file byte for byte;
  - stage 2 x data 2 (4 ranks): within TOL = 1e-5 of the reference's
    PipelinedLM on MeshConfig(stage=2, data=2) of XLA host devices
    (loss, grads, step-1 loss and norm, the parameters after the step
    with test_torch_pipeline.py's bounds), and of the in-process run
    with twice the microbatches (data rank i's microbatch m is the
    reference's rows, `microbatch_rows`: the in-process microbatch
    2m + i); both data rows hold the same parameters bit for bit;
  - `train_lm --cpu --pipeline-stages 2` as two gang processes: rank 0
    prints the reference's lines (the mesh, the batch rounding, the
    ignored --no-fused-xent, the schedule's `describe()`), rank 1 none;
    --overlap without --zero1 runs; the metrics carry `bubble_frac`; a
    run stopped at step 2 and resumed from --ckpt-dir gives the
    uninterrupted curve; under --guard a step poisoned by the fault plan
    is skipped and the run finishes;
  - every pipeline refusal and message of the reference's recipe; the
    two the port made alone (--expert with stages, ROADMAP A13, and
    --tensor, A17) now parse, and `train_lm --pipeline-stages 2
    --tensor 2` (tiny) and `--expert 2` (mixtral-tiny) run as four
    workers and print the reference's mesh line.
"""
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402
from test_torch_pipeline import (GRAD_FLOOR, LR, PARAM_TOL, TOL,  # noqa: E402
                                 build, port_run, reference_run, tokens_for)

from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt  # noqa: E402
from skypilot_tpu_torch.parallel import distributed  # noqa: E402
from skypilot_tpu_torch.utils import net  # noqa: E402
from skypilot_tpu_torch.parallel import pipeline as pt_pipe  # noqa: E402
from skypilot_tpu_torch.parallel import train as pt_train  # noqa: E402
from skypilot_tpu_torch.recipes import train_lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL, FIELDS, STYLE, M = 'tiny', {'vocab_size': 501}, '1f1b', 4
JOB_DEADLINE_S = 300


def run_job(world, data, out):
    spec = {'model': MODEL, 'fields': FIELDS, 'style': STYLE, 'v': 1,
            'M': M, 'data': data, 'lr': LR, 'tokens': tokens_for(501)}
    jobs = distributed.jobs(cpu=True, workers=world, timeout_s=60)
    code = distributed.launch(W.pipe_job, (str(out), spec,
                                           str(out / 'ckpt')), jobs,
                              deadline_s=JOB_DEADLINE_S)
    assert code == 0, f'pipe_job exited {code}'
    return [torch.load(out / f'rank{r}.pt', weights_only=False)
            for r in range(world)]


@pytest.fixture(scope='module')
def pipe2(tmp_path_factory):
    out = tmp_path_factory.mktemp('pipe2')
    return run_job(2, 1, out), out


@pytest.fixture(scope='module')
def pipe2x2(tmp_path_factory):
    return run_job(4, 2, tmp_path_factory.mktemp('pipe2x2'))


def merged(ranks, key):
    """{name: numpy} of the data-row-0 ranks' stage pieces of `key`."""
    pp = pt_pipe.PipelinedLM(build(MODEL, **FIELDS), devices=['cpu'] * 2,
                             num_microbatches=M, schedule=STYLE)
    pieces = {r['stage']: r[key] for r in ranks if r['data'] == 0}
    whole = pp.merge_params([pieces[0], pieces[1]])
    return {n: t.detach().numpy() for n, t in whole.items()}


def test_stage2_job_is_the_in_process_run(pipe2, tmp_path):
    ranks, out = pipe2
    local = port_run(MODEL, FIELDS, STYLE, 1, M)
    for r in ranks:
        for key in ('loss', 'loss1', 'gnorm'):
            assert r[key] == local[key], key
    grads, params = merged(ranks, 'grads'), merged(ranks, 'params')
    for n, g in local['grads'].items():
        assert np.array_equal(grads[n], g), n
        assert np.array_equal(params[n], local['params'][n]), n
    # loss_and_grad's hand-offs and collectives, counted alike.
    assert (ranks[0]['handoffs'], ranks[0]['collectives']) == \
        local['counts']
    assert ranks[0]['handoffs'] == 2 * M      # (V - 1) M each way
    pt_ckpt.CheckpointManager(str(tmp_path / 'local')).save(
        1, local['state'], force=True)
    assert filecmp.cmp(out / 'ckpt' / '1' / 'state.pt',
                       tmp_path / 'local' / '1' / 'state.pt', shallow=False)


@pytest.fixture(scope='module')
def reference_2x2():
    return reference_run(MODEL, FIELDS, STYLE, 1, M, data=2)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_stage2_data2_job_is_the_reference(pipe2x2, reference_2x2):
    ranks, ref = pipe2x2, reference_2x2
    assert sorted((r['data'], r['stage']) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        close(r['loss'], ref['loss'])
        close(r['loss1'], ref['loss1'])
        close(r['gnorm'], ref['gnorm'])
    grads, params = merged(ranks, 'grads'), merged(ranks, 'params')
    for n, g in ref['grads'].items():
        np.testing.assert_allclose(grads[n], g, rtol=TOL, atol=TOL,
                                   err_msg=n)
        p = ref['params'][n]
        np.testing.assert_allclose(params[n], p, rtol=0, atol=PARAM_TOL,
                                   err_msg=n)
        sure = np.abs(g) >= GRAD_FLOOR
        np.testing.assert_allclose(params[n][sure], p[sure], rtol=TOL,
                                   atol=TOL, err_msg=n)
    by = {(r['data'], r['stage']): r for r in ranks}
    for s in range(2):
        for n, t in by[0, s]['params'].items():
            assert torch.equal(t, by[1, s]['params'][n]), n


def test_stage2_data2_job_is_the_in_process_run_at_2m(pipe2x2):
    local = port_run(MODEL, FIELDS, STYLE, 1, 2 * M)
    ranks = pipe2x2
    for r in ranks:
        close(r['loss'], local['loss'])
        close(r['gnorm'], local['gnorm'])
    grads = merged(ranks, 'grads')
    for n, g in local['grads'].items():
        np.testing.assert_allclose(grads[n], g, rtol=TOL, atol=TOL,
                                   err_msg=n)


# -- train_lm -----------------------------------------------------------------
ARGV = ['--cpu', '--model', 'tiny', '--seq', '16', '--global-batch', '5',
        '--pipeline-stages', '2', '--pipeline-schedule', '1f1b',
        '--microbatches', '2', '--log-every', '1']


def gang_env(rank, port, **extra):
    return {**os.environ, 'PYTHONPATH': str(ROOT),
            'JAX_NUM_PROCESSES': '2', 'JAX_PROCESS_ID': str(rank),
            'JAX_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
            'OMP_NUM_THREADS': '1',
            'STPU_PREEMPT_METADATA_URL': 'http://127.0.0.1:9/', **extra}


def gang_run(argv, **env):
    """train_lm as two gang processes; [(rc, stdout, stderr)] by rank."""
    port = net.free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm',
         *argv], cwd=ROOT, env=gang_env(rank, port, **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs


def records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope='module')
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('uninterrupted')
    outs = gang_run([*ARGV, '--steps', '4', '--no-fused-xent', '--overlap',
                     '--ckpt-dir', str(tmp / 'ck'), '--ckpt-every', '2',
                     '--metrics-file', str(tmp / 'm.jsonl')])
    return outs, records(tmp / 'm.jsonl'), tmp / 'ck'


def test_train_lm_prints_the_references_lines(uninterrupted):
    (_, out0, _), (_, out1, _) = uninterrupted[0]
    sched = pt_pipe.psched.make_schedule(2, 2, '1f1b')
    for line in ('devices=2 Mesh(stage=2)',
                 'pipeline: rounding global batch to 4 (2 microbatches x '
                 'data=1)',
                 'pipeline trainer: --no-fused-xent/--zero1 ignored (the '
                 'pipeline path computes its head per-stage and keeps '
                 'per-stage opt state)',
                 f'pipeline schedule: {sched.describe()}',
                 'step 4/4 loss=', 'training done'):
        assert line in out0, line
    assert 'step ' not in out1 and 'devices=' not in out1
    recs = uninterrupted[1]
    assert [r['step'] for r in recs] == [1, 2, 3, 4]
    assert all(r['bubble_frac'] == sched.bubble_fraction for r in recs)
    assert all(np.isfinite(r['grad_norm']) for r in recs)


def test_train_lm_resumes_on_the_uninterrupted_curve(uninterrupted,
                                                      tmp_path):
    """Stopped at step 2, the run's checkpoint is the uninterrupted run's
    step 2 byte for byte; resumed, its steps 3 and 4 are that state's
    continuation (the synthetic stream restarts on a relaunch, as the
    reference's does), computed here in process."""
    ckpt, metrics = tmp_path / 'ck', tmp_path / 'm.jsonl'
    common = [*ARGV, '--no-fused-xent', '--ckpt-dir', str(ckpt),
              '--ckpt-every', '2', '--metrics-file', str(metrics)]
    gang_run([*common, '--steps', '2'])
    assert sorted(os.listdir(ckpt)) == ['2', 'manifest-2.json']
    assert filecmp.cmp(ckpt / '2' / 'state.pt',
                       uninterrupted[2] / '2' / 'state.pt', shallow=False)
    (_, out0, _), _ = gang_run([*common, '--steps', '4'])
    assert 'resumed from checkpoint step 2' in out0
    got = [r['loss'] for r in records(metrics)]
    assert got[:2] == [r['loss'] for r in uninterrupted[1][:2]]
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.parallel import train as pt_train
    pp = pt_pipe.PipelinedLM(
        convert.init_params(registry.train_config('tiny', 16), seed=0),
        devices=['cpu'] * 2, num_microbatches=2, schedule='1f1b')
    tx = pt_train.default_optimizer(learning_rate=3e-4, warmup_steps=10,
                                    total_steps=20)
    state = pt_ckpt.CheckpointManager(str(ckpt)).restore(pp.init(tx), 2)
    step, rng = pp.make_train_step(tx), np.random.default_rng(0)
    for want_step in range(2):
        tokens = rng.integers(0, pp.cfg.vocab_size, (4, 16),
                              dtype=np.int32).astype(np.int64)
        state, loss = step(state, torch.from_numpy(tokens))
        assert got[2 + want_step] == loss.item()


def test_train_lm_guard_skips_a_poisoned_step(tmp_path):
    plan = tmp_path / 'plan.json'
    plan.write_text(json.dumps({'rules': [
        {'point': 'train.step', 'action': 'drop', 'at': [2]}]}))
    (_, out0, _), _ = gang_run(
        [*ARGV, '--steps', '4', '--guard', '--guard-warmup', '1',
         '--watchdog-deadline', '0'], STPU_FAULT_PLAN=str(plan))
    assert 'train-guard: injected NaN' in out0
    assert 'update skipped' in out0
    assert 'training done' in out0


@pytest.mark.parametrize('argv,message', [
    (['--microbatches', '4'],
     '--microbatches only applies with --pipeline-stages > 1'),
    (['--pipeline-stages', '2', '--virtual-stages', '2'],
     '--virtual-stages only applies with --pipeline-schedule interleaved'),
    (['--pipeline-schedule', '1f1b'],
     '--pipeline-schedule needs --pipeline-stages > 1'),
    (['--model', 'llama-tiny', '--lora', '4', '--pipeline-stages', '2'],
     '--lora needs the sharded trainer (the GPipe path splits params per '
     'stage); drop one'),
    (['--pipeline-stages', '2', '--seq-parallel', '2'],
     '--pipeline-stages does not compose with --seq-parallel; drop one'),
    # Refused until experts within stages (A13) and --tensor (A17)
    # landed: now each runs (`test_within_stage_runs`), ids kept.
    pytest.param(['--pipeline-stages', '2', '--expert', '2'], None,
                 id='argv5-experts within pipeline stages (ROADMAP A13)'),
    pytest.param(['--tensor', '2'], None,
                 id='argv6---tensor (ROADMAP A17)'),
    (['--overlap'], '--overlap buckets the grad reduce-scatter onto the '
                    'ZeRO-1 moment layout; add --zero1'),
])
def test_parse_refusals(argv, message, capsys):
    if message is None:
        args = train_lm.parse_args(['--cpu', *argv])
        assert (args.pipeline_stages, args.tensor, args.expert) == tuple(
            int(dict(zip(argv[::2], argv[1::2])).get(flag, 1)) for flag in
            ('--pipeline-stages', '--tensor', '--expert'))
        return
    with pytest.raises(SystemExit) as e:
        train_lm.parse_args(['--cpu', *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_pipeline_flags_parse():
    assert not hasattr(train_lm, '_REFUSED')     # nothing left refused
    args = train_lm.parse_args(['--cpu', '--pipeline-stages', '2',
                                '--overlap', '--pipeline-schedule',
                                'interleaved', '--virtual-stages', '2',
                                '--microbatches', '4', '--tensor', '2',
                                '--expert', '2'])
    assert (args.pipeline_stages, args.virtual_stages, args.tensor,
            args.expert) == (2, 2, 2, 2)


# The reference's CLI test (tests/unit_tests/test_pipeline.py:168-187)
# and its expert counterpart: tensor / experts within stages, four
# workers.
@pytest.mark.parametrize('model,flag,batch,seq', [
    ('tiny', '--tensor', 32, 64), ('mixtral-tiny', '--expert', 8, 32)])
def test_within_stage_runs(model, flag, batch, seq, capfd):
    train_lm.main(['--cpu', '--model', model, '--pipeline-stages', '2',
                   flag, '2', '--seq', str(seq), '--global-batch',
                   str(batch), '--log-every', '2', '--steps', '2'],
                  workers=4)
    out = capfd.readouterr().out
    assert f'stage=2, {flag[2:]}=2' in out
    assert 'step 2/2 loss=' in out and 'training done' in out


def test_devices_not_divisible_by_stages_tensor_expert(capsys):
    """One process does not hold stages x tensor = 4: the reference's
    words, exit 2 before training."""
    with pytest.raises(SystemExit) as e:
        train_lm.main(['--cpu', '--model', 'tiny', '--pipeline-stages', '2',
                       '--tensor', '2', '--steps', '1', '--seq', '16'])
    assert e.value.code == 2
    assert ('1 devices not divisible by stages x tensor x expert = 4'
            in capsys.readouterr().err)


def test_devices_not_divisible_by_stages(capsys):
    with pytest.raises(SystemExit) as e:
        train_lm.main(['--cpu', '--model', 'tiny', '--pipeline-stages', '2',
                       '--steps', '1', '--seq', '16'])
    assert e.value.code == 2
    assert ('1 devices not divisible by stages x tensor x expert = 2'
            in capsys.readouterr().err)


@pytest.mark.parametrize('argv,message', [
    (['--model', 'deepseek-tiny'],
     '--pipeline-stages supports the GPT, Llama, and Mixtral families (v1)'),
    (['--model', 'tiny', '--pipeline-schedule', 'interleaved',
      '--microbatches', '3'],
     '--pipeline-schedule: interleaved cycles microbatch groups'),
])
def test_refusals_on_a_job(argv, message):
    port = net.free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm',
         '--cpu', '--pipeline-stages', '2', '--steps', '1', '--seq', '16',
         *argv], cwd=ROOT, env=gang_env(rank, port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [2, 2]
    assert message in outs[0][1]


# -- tensor and experts within stages ------------------------------------------
#: key: (model, MeshConfig fields, schedule, virtual stages), the job's
#: world the product of the fields.
GRID = {
    'stage2_tensor2_data2': ('llama-tiny', {'stage': 2, 'tensor': 2,
                                            'data': 2}, '1f1b', 1),
    'stage2_expert2': ('mixtral-tiny', {'stage': 2, 'expert': 2}, '1f1b', 1),
    'stage2_tensor2': ('tiny', {'stage': 2, 'tensor': 2}, 'interleaved', 2),
}
GRID_LOSS_RTOL, GRID_NORM_RTOL, GRID_NORM_ATOL = 2e-5, 3e-4, 3e-5


def grid_job(world, out):
    specs = [(key, name, fields, style, v) for key, (name, fields, style, v)
             in GRID.items() if int(np.prod(list(fields.values()))) == world]
    jobs = distributed.jobs(cpu=True, workers=world, timeout_s=60)
    code = distributed.launch(W.pipe_grid_job, (str(out), specs,
                                                str(out / 'ckpt')), jobs,
                              deadline_s=JOB_DEADLINE_S)
    assert code == 0, f'pipe_grid_job exited {code}'
    return [torch.load(out / f'rank{r}.pt', weights_only=False)
            for r in range(world)], out / 'ckpt'


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    """{key: rank 0's result}, and the 8-rank job's checkpoint."""
    ranks8, ckpt = grid_job(8, tmp_path_factory.mktemp('grid8'))
    ranks4, _ = grid_job(4, tmp_path_factory.mktemp('grid4'))
    out = {**ranks8[0], **ranks4[0]}
    return out, ckpt, ranks8


def grid_close(got, losses, norms, params):
    np.testing.assert_allclose(got['losses'], losses, rtol=GRID_LOSS_RTOL)
    np.testing.assert_allclose(got['norms'], norms, rtol=GRID_NORM_RTOL,
                               atol=GRID_NORM_ATOL)
    for n, p in params.items():
        np.testing.assert_allclose(np.asarray(got['params'][n]),
                                   np.asarray(p), rtol=0, atol=PARAM_TOL,
                                   err_msg=n)


def test_tensor_within_stages_is_the_sequential_model(grid):
    """stage 2 x tensor 2 x data 2 (the reference's
    test_pipeline_tp_within_stages mesh): the one-device trainer's
    curve and parameters on the same batches."""
    got = grid[0]['stage2_tensor2_data2']
    assert got['summary'] == 'Mesh(data=2, stage=2, tensor=2)'
    trainer = W.make_trainer(W.build('llama-tiny'), collect_grad_norm=True)
    state = trainer.init()
    losses, norms = [], []
    step = trainer.make_train_step()
    for i in range(W.PIPE_STEPS):
        state, (loss, gnorm) = step(state, torch.from_numpy(
            W.tokens_for(i, 512)))
        losses.append(float(loss))
        norms.append(float(gnorm))
    grid_close(got, losses, norms, W.whole_params(state))
    # Each rank holds half of each sliced leaf of its stage's blocks.
    local = got['local']
    assert local['layers.0.attn.wq.weight'] == (64, 128)
    assert local['layers.0.attn.wo.weight'] == (128, 64)
    assert local['layers.0.attn_norm.scale'] == (128,)


@pytest.mark.parametrize('key,devices', [
    ('stage2_expert2', ['cpu', 'cpu']),
    ('stage2_tensor2', [['cpu', 'cpu'], ['cpu', 'cpu']])])
def test_within_stages_is_the_in_process_pipeline(grid, key, devices):
    """Experts within stages against the in-process pipeline (Mixtral's
    loss is the mean of per-microbatch losses, as the reference's), and
    tensor within stages over ranks against the in-process grid."""
    name, _, style, v = GRID[key]
    pp = pt_pipe.PipelinedLM(W.build(name), devices=devices,
                             num_microbatches=W.PIPE_MB, schedule=style,
                             virtual_stages=v)
    tx = pt_train.default_optimizer(learning_rate=W.LR, warmup_steps=10,
                                    total_steps=20)
    _, losses, norms, params = W.pipe_grid_run(pp, tx, pp.init(tx),
                                               W.PIPE_STEPS)
    grid_close(grid[0][key], losses, norms, params)


def test_within_stage_checkpoint_is_the_one_card_file(grid):
    """The 8-rank job's save restores into the one-card trainer with
    the job's gathered parameters, bit for bit."""
    got, ckpt = grid[0]['stage2_tensor2_data2'], grid[1]
    trainer = W.make_trainer(W.build('llama-tiny'))
    state = pt_ckpt.CheckpointManager(str(ckpt)).restore(trainer.init())
    assert state.step == W.PIPE_STEPS
    for n, p in W.whole_params(state).items():
        assert np.array_equal(p, got['params'][n].numpy()), n


def test_train_lm_init_from_hf_under_stages(tmp_path):
    """`--init-from-hf` through the pipeline's split: after one step
    (the warmup's lr is 0 at count 0) the two ranks' checkpoint holds
    the HF checkpoint's weights as f32 masters, bit for bit."""
    import transformers
    from skypilot_tpu_torch.models import hf_import
    hf = tmp_path / 'hf'
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=384,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)).save_pretrained(
            str(hf), safe_serialization=True)
    (_, out0, _), _ = gang_run(
        ['--cpu', '--init-from-hf', str(hf), '--seq', '16',
         '--global-batch', '4', '--pipeline-stages', '2', '--microbatches',
         '2', '--steps', '1', '--log-every', '1', '--ckpt-dir',
         str(tmp_path / 'ck')])
    assert 'initializing from HF checkpoint' in out0
    assert 'devices=2 Mesh(stage=2)' in out0 and 'training done' in out0
    _, model = hf_import.load_hf_checkpoint(
        str(hf), max_seq_len=128, param_dtype=torch.float32)
    saved = pt_ckpt.CheckpointManager(str(tmp_path / 'ck')).restore_params()
    want = dict(model.named_parameters())
    assert list(saved) == list(want)
    for n, p in want.items():
        assert torch.equal(saved[n], p.detach()), n
