"""Expert parallelism in the port's sharded trainer (`train_lm
--expert`: models/mixtral.py `MoEFeedForward` under an expert group,
parallel/{fsdp,train,checkpoints}.py) on gloo, in spawned CPU
processes, against the reference's ShardedTrainer on XLA host devices
and against the port's own one-process trainer, f32:

  - mixtral-tiny on MeshConfig.auto(2, expert=2), auto(4, expert=2)
    (fsdp=2 x expert=2) and auto(4, expert=2, seq=2): the 5 losses and
    grad norms within 1e-5 of the reference's on the same meshes, the
    final parameters within test_torch_train.py's bounds;
  - each rank holds E / expert of every expert stack and all of every
    other leaf (its fsdp shard of it); the gradient of every replicated
    leaf, as backward leaves it, is bit-identical across the expert
    ranks, and so are those leaves after five steps; the layout averages
    those gradients over `expert`, once a leaf a step;
  - copies of those gradients made to differ on one expert rank (as a
    backward that is not deterministic makes them on the card) leave
    the replicated leaves bit-identical across the expert ranks;
  - a guarded step poisoned on one rank is skipped on every rank, and
    the run follows the one-process guarded curve;
  - the `--expert 2` checkpoint restores at world 1 bit for bit, and a
    save holds at most one whole leaf at a time;
  - the reference's compiled step on auto(2, expert=2) holds no
    all-to-all: the batch is replicated over `expert`, so the combine is
    an all-reduce over the expert group (what the port does);
  - llama-tiny (no expert leaf) under auto(2, expert=2) gives its
    one-process curve, the expert ranks repeating the same work;
  - the reference's tree converts to the port's model and back with
    whole stacks, bit for bit; a model holding a slice is refused;
  - `train_lm --cpu --expert 2` runs as two workers and gives the
    one-process curve; `--tensor 2` and `--expert 2 --pipeline-stages 2`
    (once refused naming A17 and A13) run; the three pipeline flags the
    reference refuses alone still exit with its words.
"""
import dataclasses
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402
from test_torch_fsdp import (TOL, as_reference_tree,  # noqa: E402
                             assert_params_close, one_rank, reference_run,
                             run_job)

from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu.parallel import train as jax_train  # noqa: E402
from skypilot_tpu.recipes.train_lm import _build_model  # noqa: E402
from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt  # noqa: E402
from skypilot_tpu_torch.recipes import train_lm  # noqa: E402

EXPERT_LEAVES = ('moe.w_gate', 'moe.w_up', 'moe.w_down')
MESHES = {
    'expert2': (jax_mesh.MeshConfig.auto(2, expert=2), 2),
    'fsdp_expert': (jax_mesh.MeshConfig.auto(4, expert=2), 4),
    'expert_seq': (jax_mesh.MeshConfig.auto(4, expert=2, seq=2), 4),
}


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp('expert2')
    ckpt = out / 'ckpt'
    return run_job(W.expert2_job, 2, str(out), str(ckpt)), ckpt


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    return run_job(W.expert4_job, 4, str(tmp_path_factory.mktemp('expert4')))


@pytest.fixture(scope='module')
def runs(world2, world4):
    """{mesh key: every rank's result}."""
    out = {'expert2': [r['expert2'] for r in world2[0]]}
    for key in ('fsdp_expert', 'expert_seq', 'skewed', 'guard'):
        out[key] = [r[key] for r in world4]
    return out


@pytest.mark.parametrize('key', sorted(MESHES))
def test_mixtral_matches_the_reference(runs, key):
    config, devices = MESHES[key]
    losses, norms, final, _, _ = reference_run('mixtral-tiny', config,
                                               devices)
    got = runs[key][0]
    np.testing.assert_allclose(got['losses'], losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, atol=TOL, rtol=TOL)
    assert_params_close(as_reference_tree(got['params'], 'mixtral-tiny'),
                        final)
    for rank in runs[key][1:]:
        assert rank['losses'] == got['losses']


@pytest.mark.parametrize('key', sorted(MESHES))
def test_each_rank_holds_its_experts(runs, key):
    config, _ = MESHES[key]
    for rank in runs[key]:
        for name, share in rank['fractions'].items():
            if name.endswith(EXPERT_LEAVES):
                # E / expert of the stack, cut over fsdp as FSDP2 cuts it.
                assert share == 1 / (config.expert * config.fsdp), name
            else:
                assert share <= 1 / config.fsdp, name


def expert_peers(key):
    """Pairs of ranks that differ on the expert axis only."""
    config, devices = MESHES[key]
    grid = np.arange(devices).reshape(config.shape)
    pairs = np.moveaxis(grid, 4, -1).reshape(-1, config.expert)
    return [tuple(p) for p in pairs.tolist()]


def replicated_leaves(run):
    return sum(not n.endswith(EXPERT_LEAVES) for n in run['params'])


@pytest.mark.parametrize('key', sorted(MESHES))
def test_replicated_leaves_are_equal_across_expert_ranks(runs, key):
    """The gradient of every leaf the expert ranks all hold comes out
    whole and equal on each (x and the routing weights enter the experts
    through copy_to_experts); the layout averages it over `expert`, one
    all-reduce a leaf a step."""
    ranks = runs[key]
    for a, b in expert_peers(key):
        for step_a, step_b in zip(ranks[a]['grads'], ranks[b]['grads']):
            assert step_a.keys() == step_b.keys() and step_a
            for name in step_a:
                assert np.array_equal(step_a[name], step_b[name]), name
        for name, value in ranks[a]['replicated'].items():
            assert np.array_equal(value, ranks[b]['replicated'][name]), name
    for r in ranks:
        assert r['reductions']['expert'] == replicated_leaves(r) * W.STEPS


def test_averaging_keeps_diverged_expert_copies_equal(runs):
    """Expert rank 1's gradients of the replicated leaves scaled by
    1 + SKEW before the layout reduces them: the copies differ as they
    come out of backward, and the leaves stay bit-identical across the
    expert ranks after five steps."""
    ranks = runs['skewed']
    for a, b in expert_peers('fsdp_expert'):
        for step_a, step_b in zip(ranks[a]['grads'], ranks[b]['grads']):
            assert any(not np.array_equal(step_a[n], step_b[n])
                       for n in step_a)
        for name, value in ranks[a]['replicated'].items():
            assert np.array_equal(value, ranks[b]['replicated'][name]), name
    for r in ranks:
        assert r['reductions']['expert'] == replicated_leaves(r) * W.STEPS
    # The same step-1 loss; the averaged gradient carries half the skew.
    want = runs['fsdp_expert'][0]
    assert ranks[0]['losses'][0] == want['losses'][0]
    assert ranks[0]['norms'][0] != want['norms'][0]


def test_a_family_without_experts_repeats_its_work_on_each_rank(world2):
    """llama-tiny under --expert 2: the expert ranks do the same work,
    as the reference's, and give the one-process curve."""
    _, _, losses, norms, _ = one_rank('llama-tiny')
    for rank in world2[0]:
        np.testing.assert_allclose(rank['llama']['losses'], losses,
                                   rtol=TOL)
        np.testing.assert_allclose(rank['llama']['norms'], norms, rtol=TOL)


def test_seq_parts_are_summed_once_a_leaf_a_step(runs):
    got = runs['expert_seq'][0]
    assert got['reductions'] == {'seq': len(got['params']) * W.STEPS,
                                 'expert': replicated_leaves(got) * W.STEPS}


def test_poisoned_step_is_skipped_on_every_rank(runs):
    def poison(i):
        return float('nan') if i == W.POISON_STEP else 1.0

    _, _, losses, _, bads = one_rank('mixtral-tiny', guard=True,
                                     poison=poison)
    for rank in runs['guard']:
        assert rank['bads'] == bads == [i == W.POISON_STEP
                                        for i in range(W.STEPS)]
        np.testing.assert_allclose(rank['losses'], losses, rtol=TOL)


def test_expert2_checkpoint_restores_at_world1_bit_for_bit(world2):
    ranks, ckpt = world2
    got = ranks[0]['expert2']
    assert got['saved']
    assert got['save_whole_leaves']['peak'] == 1
    trainer = W.make_trainer(W.build('mixtral-tiny'))
    state = pt_ckpt.CheckpointManager(str(ckpt)).restore(trainer.init())
    assert state.step == W.STEPS
    params = W.whole_params(state)
    assert all(np.array_equal(params[n], got['params'][n]) for n in params)
    assert all(np.array_equal(a, b)
               for a, b in zip(W.whole_moments(state), got['mu']))
    assert params['layers.0.moe.w_gate'].shape[0] == 4


def test_the_reference_combines_experts_with_an_all_reduce():
    """The reference's compiled train step on auto(2, expert=2) (two XLA
    host devices): no all-to-all, all-reduces over the expert pair."""
    model, _, loss_fn = _build_model('mixtral-tiny', W.SEQ, remat=False)
    model = type(model)(dataclasses.replace(model.config,
                                            dtype=jnp.float32))
    config, devices = MESHES['expert2']
    mesh = jax_mesh.make_mesh(config, devices=jax.devices()[:devices])
    trainer = jax_train.ShardedTrainer(model, mesh, loss_fn=loss_fn)
    example = jnp.zeros((W.BATCH, W.SEQ), jnp.int32)
    state = trainer.init(jax.random.PRNGKey(0), example)
    step = trainer.make_train_step(example, donate=False)
    with mesh:
        text = step.lower(state, jax_train.shard_batch(
            example, mesh)).compile().as_text()

    def count(op):
        return len(re.findall(r'= \S+ ' + op + r'(-start)?\(', text))

    assert count('all-to-all') == 0
    assert count('all-reduce') > 0


def metrics_losses(path):
    return [json.loads(line)['loss']
            for line in Path(path).read_text().splitlines()]


def test_train_lm_expert_runs_as_two_workers(tmp_path, capfd):
    argv = ['--cpu', '--model', 'mixtral-tiny', '--steps', '2', '--seq',
            '32', '--global-batch', '2', '--log-every', '1']
    train_lm.main([*argv, '--metrics-file', str(tmp_path / 'one.jsonl')])
    train_lm.main([*argv, '--expert', '2', '--metrics-file',
                   str(tmp_path / 'two.jsonl')], workers=2)
    out = capfd.readouterr().out
    assert 'devices=2 Mesh(expert=2)' in out
    assert out.count('step 2/2 loss=') == 2
    np.testing.assert_allclose(metrics_losses(tmp_path / 'two.jsonl'),
                               metrics_losses(tmp_path / 'one.jsonl'),
                               rtol=TOL)


# The pipeline flags parse since A13 (tests/test_torch_pipeline_gang.py):
# these cases, ids kept, exit with the reference's pipeline checks;
# --tensor (A17) and experts within pipeline stages (A13's rest), once
# refused, now run (None: the case runs the flags and trains a step).
@pytest.mark.parametrize('argv,item', [
    pytest.param(['--tensor', '2'], None,
                 id='argv0---tensor (ROADMAP A17)'),
    pytest.param(['--pipeline-stages', '2', '--expert', '2'], None,
                 id='argv1---pipeline-stages (ROADMAP A13)'),
    pytest.param(['--pipeline-schedule', '1f1b'],
                 '--pipeline-schedule needs --pipeline-stages > 1',
                 id='argv2---pipeline-schedule (ROADMAP A13)'),
    pytest.param(['--virtual-stages', '2'],
                 '--virtual-stages only applies with --pipeline-schedule '
                 'interleaved',
                 id='argv3---virtual-stages (ROADMAP A13)'),
    pytest.param(['--microbatches', '4'],
                 '--microbatches only applies with --pipeline-stages > 1',
                 id='argv4---microbatches (ROADMAP A13)'),
])
def test_the_other_parallel_flags_are_still_refused(argv, item, capfd,
                                                    monkeypatch):
    for flag in (['--expert', '2'], ['--seq-parallel', '2']):
        assert train_lm.parse_args(['--cpu'] + flag)
    if item is None:
        # Runs: four workers with stages, two with --tensor alone.
        monkeypatch.setenv('OMP_NUM_THREADS', '1')
        train_lm.main(['--cpu', '--model', 'mixtral-tiny', '--steps', '1',
                       '--seq', '32', '--global-batch', '8', '--log-every',
                       '1', *argv], workers=4 if '--expert' in argv else 2)
        out = capfd.readouterr().out
        assert 'step 1/1 loss=' in out and 'training done' in out
        return
    with pytest.raises(SystemExit) as exc:
        train_lm.parse_args(['--cpu'] + argv)
    assert exc.value.code == 2
    assert item in capfd.readouterr().err


def test_convert_carries_whole_expert_stacks_both_ways():
    """The reference's tree of mixtral-tiny -> the port's training model
    -> the reference's tree, bit for bit, with whole [E, ...] stacks; a
    model holding an expert slice is refused."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.mixtral import Mixtral
    tree = convert.train_params_to_jax(W.build('mixtral-tiny'))
    model = convert.train_params_from_jax(tree, W.f32_config('mixtral-tiny'))
    assert isinstance(model, Mixtral)
    back = convert.train_params_to_jax(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert flat.keys() == dict(jax.tree_util.tree_leaves_with_path(
        back)).keys()
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        assert np.array_equal(leaf, flat[path]), path
    assert back['layer_0']['moe']['w_down'].shape == (4, 256, 128)
    model.layers[0].moe.shard_experts(None, 1, 2)
    assert tuple(model.layers[0].moe.w_gate.shape) == (2, 128, 256)
    with pytest.raises(ValueError, match=r'holds experts \[2, 4\) of 4'):
        convert.train_params_to_jax(model)
