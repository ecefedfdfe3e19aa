"""`train_lm` under the gang-exec env contract (ROADMAP C6): processes
started as a multi-node launch starts them (`JAX_NUM_PROCESSES`,
`JAX_PROCESS_ID`, `JAX_COORDINATOR_ADDRESS`, backends/task_codegen.py)
join one gloo job and train one model, as the reference's
`jax.distributed.initialize` joins one:

  - two processes: rank 0 prints `devices=2 Mesh(fsdp=2)` and the step
    lines, rank 1 prints none; the checkpoint dir holds steps 1 and 2
    (rank 0 writes them); the losses (`--metrics-file`, rank 0's) are a
    one-process run's on the same global batch, within rtol 1e-5;
  - rank 0 alone (`distributed.TIMEOUT_S` patched to 5 s in its
    process) exits non-zero naming the coordinator, well before the
    test's own limit;
  - the launcher with two local workers (`train_lm.main(argv,
    workers=2)`), with --zero1 --overlap, trains the same curve, and
    `--ckpt-interval auto` fixes one cadence for both ranks;
  - SIGTERM to rank 1 alone under --guard: both ranks save the same
    step once and exit 83;
  - with --data each rank trains on the reference's rows: its block of
    its process's window of the global batch.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.recipes import train_lm
from skypilot_tpu_torch.utils import net
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARGV = ['--cpu', '--model', 'llama-tiny', '--steps', '2', '--seq', '64',
        '--global-batch', '2', '--log-every', '1']


def gang_env(rank, port):
    return {**os.environ, 'PYTHONPATH': str(ROOT),
            'JAX_NUM_PROCESSES': '2', 'JAX_PROCESS_ID': str(rank),
            'JAX_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
            'OMP_NUM_THREADS': '1',
            'STPU_PREEMPT_METADATA_URL': 'http://127.0.0.1:9/'}


def start(rank, port, argv, timeout_s=None):
    """train_lm as gang process `rank`; `timeout_s` replaces the join
    timeout (`distributed.TIMEOUT_S`) in that process."""
    cmd = ['-m', 'skypilot_tpu_torch.recipes.train_lm']
    if timeout_s is not None:
        cmd = ['-c', 'from skypilot_tpu_torch.parallel import distributed; '
               f'distributed.TIMEOUT_S = {timeout_s}; '
               'from skypilot_tpu_torch.recipes import train_lm; '
               'train_lm.main()']
    return subprocess.Popen(
        [sys.executable, *cmd, *argv], cwd=ROOT, env=gang_env(rank, port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(procs, timeout=180):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def metrics_losses(path):
    return [json.loads(line)['loss']
            for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope='module')
def one_process(tmp_path_factory):
    metrics = tmp_path_factory.mktemp('one') / 'm.jsonl'
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm', *ARGV,
         '--metrics-file', str(metrics)], cwd=ROOT, capture_output=True,
        text=True, timeout=180, env={**os.environ, 'PYTHONPATH': str(ROOT),
                                     'OMP_NUM_THREADS': '1'})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'devices=1 Mesh(single-device)' in proc.stdout
    return metrics_losses(metrics)


def test_two_gang_processes_train_one_model(tmp_path, one_process):
    ckpt, metrics = tmp_path / 'D', tmp_path / 'm.jsonl'
    port = net.free_port()
    argv = [*ARGV, '--ckpt-dir', str(ckpt), '--ckpt-every', '1',
            '--metrics-file', str(metrics)]
    (rc0, out0, err0), (rc1, out1, err1) = finish(
        [start(0, port, argv), start(1, port, argv)])
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert 'devices=2 Mesh(fsdp=2)' in out0
    assert 'step 2/2 loss=' in out0 and 'training done' in out0
    assert 'step ' not in out1 and 'devices=' not in out1
    assert sorted(os.listdir(ckpt)) == ['1', '2', 'manifest-1.json',
                                        'manifest-2.json']
    np.testing.assert_allclose(metrics_losses(metrics), one_process,
                               rtol=1e-5)
    records = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [r['step'] for r in records] == [1, 2]


def test_a_missing_peer_ends_the_run_naming_the_coordinator():
    port = net.free_port()
    t0 = time.monotonic()
    (rc, out, err), = finish([start(0, port, ARGV, timeout_s=5)],
                             timeout=120)
    assert rc == 1 and time.monotonic() - t0 < 100
    assert f'could not join the job at tcp://127.0.0.1:{port} within 5 s' \
        in err
    assert 'step ' not in out


def test_launcher_runs_two_local_workers(tmp_path, one_process, capfd,
                                         monkeypatch):
    monkeypatch.setattr(distributed, 'TIMEOUT_S', 60.0)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')     # the spawned workers'
    metrics, ckpt = tmp_path / 'm.jsonl', tmp_path / 'D'
    train_lm.main([*ARGV, '--zero1', '--overlap', '--metrics-file',
                   str(metrics), '--ckpt-dir', str(ckpt), '--ckpt-interval',
                   'auto', '--preemption-rate', '0.5'], workers=2)
    out = capfd.readouterr().out
    assert 'devices=2 Mesh(fsdp=2)' in out
    assert 'zero1=True overlap=True' in out
    assert out.count('step 2/2 loss=') == 1
    # Rank 0's cadence, fixed once for both ranks: no step is due
    # before the final save.
    assert out.count('ckpt cadence: interval 930s') == 1
    assert sorted(os.listdir(ckpt)) == ['2', 'manifest-2.json']
    np.testing.assert_allclose(metrics_losses(metrics), one_process,
                               rtol=1e-5)


def test_a_notice_on_one_rank_stops_both_at_one_step(tmp_path):
    ckpt = tmp_path / 'D'
    port = net.free_port()
    argv = ['--cpu', '--model', 'llama-tiny', '--steps', '100000', '--seq',
            '32', '--global-batch', '2', '--log-every', '1', '--guard',
            '--guard-warmup', '1', '--ckpt-dir', str(ckpt), '--ckpt-every',
            '100000']
    procs = [start(0, port, argv), start(1, port, argv)]
    try:
        for line in procs[0].stdout:
            if line.startswith('step 3/'):
                break
        procs[1].send_signal(signal.SIGTERM)
        (rc0, out0, err0), (rc1, _, err1) = finish(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert (rc0, rc1) == (83, 83), (err0[-2000:], err1[-2000:])
    line = next(l for l in out0.splitlines()
                if l.startswith('preemption notice'))
    assert line.startswith('preemption notice (another rank) at step ')
    step = line.split(' at step ')[1].split(':')[0]
    assert sorted(os.listdir(ckpt)) == [step, f'manifest-{step}.json']


def test_data_rows_are_the_reference_devices_rows(tmp_path):
    """With --data each process reads its own window of the global batch
    (TokenLoader(rank=process id, world=processes)) and each rank keeps
    its block of it (`mesh.batch_rows`), as the reference's
    `shard_batch` puts block d of process p's window on device d. Both
    logged losses come before any parameter moves (the warmup's first
    lr is 0), so each is the seeded model's loss on those rows."""
    import torch

    from skypilot_tpu_torch.data.token_loader import TokenLoader
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.parallel.train import ShardedTrainer
    data = tmp_path / 'data'
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        rng.integers(0, 512, 4000).astype(np.uint16).tofile(
            data / f'shard{i}.bin')
    metrics = tmp_path / 'm.jsonl'
    port = net.free_port()
    argv = ['--cpu', '--model', 'llama-tiny', '--steps', '2', '--seq', '32',
            '--global-batch', '4', '--log-every', '1', '--data', str(data),
            '--metrics-file', str(metrics)]
    outs = finish([start(0, port, argv), start(1, port, argv)])
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-2000:]
    paths = sorted(str(p) for p in data.glob('*.bin'))
    loaders = [TokenLoader(paths, batch=4, seq=32, rank=p, world=2)
               for p in range(2)]
    trainer = ShardedTrainer(convert.init_params(
        registry.train_config('llama-tiny', 32), seed=0, device='cpu'))
    evaluate = trainer.make_eval_step()
    state = trainer.init()
    want, other = [], []
    for _ in range(2):
        windows = [ld.next_batch()[:, :-1].astype(np.int64) for ld in loaders]
        rows = np.concatenate([windows[0][:2], windows[1][2:]])
        want.append(float(evaluate(state, torch.from_numpy(rows))))
        other.append(float(evaluate(state, torch.from_numpy(windows[0]))))
    got = metrics_losses(metrics)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not np.allclose(got, other, rtol=1e-4)
