"""Context parallelism in the port's sharded trainer (`train_lm
--seq-parallel`: parallel/context.py, ops/ring_attention.py,
parallel/{train,fsdp}.py) on gloo, in spawned CPU processes, against the
reference's ShardedTrainer on XLA host devices and against the port's
own one-process trainer, f32:

  - llama-tiny on MeshConfig.auto(4, seq=2) (fsdp=2 x seq=2) from the
    port's seeded init: the 5 losses and grad norms within 1e-5 of the
    reference's on the same mesh over four devices, the final
    parameters within test_torch_train.py's bounds; each rank holds its
    batch rows (replicated over seq) and its sequence block;
  - `--remat` gives the non-remat curve (the ring's forward replayed in
    the same order on every rank);
  - GPT-2 `tiny` on MeshConfig.auto(2, seq=2) gives its world-1 curve
    and eval loss (the reference's
    test_context_parallel_gpt_matches_single_device);
  - deepseek-tiny (MLA, unequal q/v dims) warns the reference's words
    and gives its world-1 curve;
  - `train_lm --cpu --seq-parallel 2` runs as two workers and gives the
    one-process curve; a world the axes do not divide exits with the
    reference's words.
"""
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402
from test_torch_fsdp import (TOL, as_reference_tree,  # noqa: E402
                             assert_params_close, one_rank, reference_run,
                             run_job)

from skypilot_tpu.ops import attention as jax_attention  # noqa: E402
from skypilot_tpu.parallel import context as jax_context  # noqa: E402
from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu_torch.recipes import train_lm  # noqa: E402


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    return run_job(W.context_job, 4, str(tmp_path_factory.mktemp('ctx4')))


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    return run_job(W.context2_job, 2, str(tmp_path_factory.mktemp('ctx2')))


@pytest.fixture(scope='module')
def reference():
    """llama-tiny on MeshConfig.auto(4, seq=2) over four devices: the
    reference's ring attention under its GSPMD step."""
    return reference_run('llama-tiny', jax_mesh.MeshConfig.auto(4, seq=2), 4)


def test_llama_seq2_matches_the_reference(world4, reference):
    losses, norms, final, _, _ = reference
    got = world4[0]['llama']
    np.testing.assert_allclose(got['losses'], losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, atol=TOL, rtol=TOL)
    assert_params_close(as_reference_tree(got['params']), final)
    for rank in world4[1:]:
        assert rank['llama']['losses'] == got['losses']


def test_ranks_hold_their_rows_and_sequence_blocks(world4):
    """fsdp=2 x seq=2: rows split over fsdp (replicated over seq), the
    sequence over seq, as the reference's 'batch' and 'seq' rules."""
    half = W.SEQ // 2
    want = [((0, 2), (0, half)), ((0, 2), (half, W.SEQ)),
            ((2, 4), (0, half)), ((2, 4), (half, W.SEQ))]
    assert [(r['rows'], r['block']) for r in world4] == want
    assert {r['summary'] for r in world4} == {'Mesh(fsdp=2, seq=2)'}


def test_remat_gives_the_non_remat_curve(world4):
    got, want = world4[0]['remat'], world4[0]['llama']
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=TOL)
    np.testing.assert_allclose(got['norms'], want['norms'], rtol=TOL)


def test_gpt_seq2_equals_world1(world2):
    """The reference's test_context_parallel_gpt_matches_single_device,
    over five training steps."""
    trainer, state, losses, norms, _ = one_rank('tiny')
    got = world2[0]['gpt']
    np.testing.assert_allclose(got['losses'], losses, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, rtol=TOL)
    import torch
    want = float(trainer.make_eval_step()(
        state, torch.from_numpy(W.tokens_for(0, 512))))
    np.testing.assert_allclose(got['eval'], want, rtol=TOL)
    assert world2[1]['gpt']['eval'] == got['eval']


def reference_mla_warning():
    """The reference's warning for unequal q/v dims on a seq-sharded
    mesh (its dot_product_attention, outside any jit)."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(seq=2),
                              devices=jax.devices()[:2])
    q = jnp.zeros((1, 4, 2, 48), jnp.float32)
    v = jnp.zeros((1, 4, 2, 32), jnp.float32)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        with jax_context.context_parallel(mesh):
            jax_attention.dot_product_attention(q, q, v)
    return {str(w.message) for w in seen}


def test_deepseek_seq2_warns_as_the_reference_and_trains(world4):
    got = world4[0]['deepseek']
    assert set(got['warnings']) == reference_mla_warning()
    _, _, losses, norms, _ = one_rank('deepseek-tiny')
    np.testing.assert_allclose(got['losses'], losses, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, rtol=TOL)


def metrics_losses(path):
    return [json.loads(line)['loss']
            for line in Path(path).read_text().splitlines()]


ARGV = ['--cpu', '--model', 'llama-tiny', '--steps', '2', '--seq', '32',
        '--global-batch', '2', '--log-every', '1']


def test_train_lm_seq_parallel_runs_as_two_workers(tmp_path, capfd):
    train_lm.main([*ARGV, '--metrics-file', str(tmp_path / 'one.jsonl')])
    train_lm.main([*ARGV, '--seq-parallel', '2', '--metrics-file',
                   str(tmp_path / 'two.jsonl')], workers=2)
    out = capfd.readouterr().out
    assert 'devices=2 Mesh(seq=2)' in out
    assert out.count('step 2/2 loss=') == 2
    np.testing.assert_allclose(metrics_losses(tmp_path / 'two.jsonl'),
                               metrics_losses(tmp_path / 'one.jsonl'),
                               rtol=TOL)


@pytest.mark.parametrize('argv', [['--seq-parallel', '2'],
                                  ['--expert', '2'],
                                  ['--expert', '2', '--seq-parallel', '3']])
def test_an_undivided_world_exits_with_the_references_words(argv, capfd):
    """One rank on a mesh that wants more: the reference's ValueError
    from MeshConfig.auto, word for word."""
    args = dict(zip(argv[::2], map(int, argv[1::2])))
    with pytest.raises(ValueError) as want:
        jax_mesh.MeshConfig.auto(1, expert=args.get('--expert', 1),
                                 seq=args.get('--seq-parallel', 1))
    with pytest.raises(SystemExit) as exc:
        train_lm.main([*ARGV, *argv])
    assert exc.value.code == 2
    assert f'train_lm: {want.value}' in capfd.readouterr().err


def test_mesh_auto_refuses_an_undivided_world_as_the_reference():
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    for n, kw in ((4, {'expert': 3}), (6, {'expert': 2, 'seq': 4}),
                  (2, {'seq': 4})):
        with pytest.raises(ValueError) as want:
            jax_mesh.MeshConfig.auto(n, **kw)
        with pytest.raises(ValueError) as got:
            mesh_lib.MeshConfig.auto(n, **kw)
        assert str(got.value) == str(want.value)
    assert dataclasses.asdict(mesh_lib.MeshConfig.auto(8, expert=2, seq=2)) \
        == dataclasses.asdict(jax_mesh.MeshConfig.auto(8, expert=2, seq=2))
