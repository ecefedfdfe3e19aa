"""The port's sharded trainer (skypilot_tpu_torch/parallel/{train,fsdp,
checkpoints}.py over a parallel/mesh.py DeviceMesh) on gloo, in spawned
CPU processes, against the reference's ShardedTrainer on XLA host
devices and against the port's own one-process trainer, f32:

  - llama-tiny at world 2 (MeshConfig.auto(2): fsdp=2) from the port's
    seeded init, which the reference's state takes too: the 5 losses
    and grad norms (optax.global_norm) within 1e-5 of the reference's on
    a 2-device mesh, the final parameters within test_torch_train.py's
    bounds (5e-4 for all, 1e-5 for 99.9%); the losses within rtol 1e-5
    of the port's world-1 run; each rank holds 1/2 of every leaf the
    reference shards over fsdp;
  - mixtral-tiny at world 2 against the reference's on MeshConfig.auto(2)
    (losses, norms within 1e-5, final parameters within the bounds);
  - --remat, LoRA (the base untouched), GPT-2 (tied head, fused loss),
    mixtral-tiny (the router aux loss over the whole batch) and
    deepseek-tiny (MLA's 3-D wkv_b) at world 2 give their world-1
    curves (rtol 1e-5);
  - data=2 x fsdp=2 (4 ranks): zero1 on, and on with overlap, give the
    zero1-off curve within rtol 1e-5, with every moment piece 1/data of
    the rank's parameter shard where the reference's rule shards it;
    all three follow the reference's zero1 + overlap run on four
    devices (losses, norms, final parameters), and each rank's share of
    every mu leaf is the reference device's where the reference shards
    the leaf over fsdp;
  - a guarded data=2 run whose step 2 is poisoned on one rank only
    skips that step on every rank (parameters and count bit for bit),
    ends with parameters bit-identical across ranks, and follows the
    world-1 guarded curve;
  - the world-2 checkpoint restores at world 1 bit for bit and, saved
    again there, is the same file byte for byte; restored into a
    4-rank zero1 trainer and saved again, the same bytes; the 4-rank
    zero1 run's checkpoint restores into a zero1-off trainer bit for
    bit; so too with an odd vocab, whose tables shard unevenly; a save
    keeps at most one whole leaf alive on any rank;
  - overlap without zero1 raises the reference's ValueError.

Each job runs in `distributed.launch`'s spawned workers with
torch.set_num_threads(1), under a free port and a deadline: a hung job
fails the test.
"""
import dataclasses
import filecmp
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402

from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu.parallel import train as jax_train  # noqa: E402
from skypilot_tpu.recipes.train_lm import _build_model  # noqa: E402
from skypilot_tpu_torch.models import convert  # noqa: E402
from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt  # noqa: E402
from skypilot_tpu_torch.parallel import distributed  # noqa: E402
from skypilot_tpu_torch.parallel.train import trainable_items  # noqa: E402

TOL = 1e-5
PARAM_TOL = 5e-4
JOB_DEADLINE_S = 600


def run_job(target, world, *args):
    """`target(job, *args)` on `world` spawned gloo ranks; their
    results, one dict a rank."""
    out = args[0]
    jobs = distributed.jobs(cpu=True, workers=world,
                            timeout_s=60)      # joins and collectives
    code = distributed.launch(target, args, jobs, deadline_s=JOB_DEADLINE_S)
    assert code == 0, f'{target.__name__} exited {code}'
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp('fsdp2')
    ckpt = out / 'ckpt'
    return run_job(W.fsdp_job, 2, str(out), str(ckpt)), ckpt


@pytest.fixture(scope='module')
def world4(world2, tmp_path_factory):
    out = tmp_path_factory.mktemp('zero1')
    return run_job(W.zero1_job, 4, str(out), str(world2[1]),
                   str(out / 'ckpt')), out / 'ckpt'


@pytest.fixture(autouse=True)
def one_thread():
    """The one-process runs on one thread, as the spawned ranks run:
    tiny models gain nothing from more, and a loaded machine loses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_rank(name, remat=False, lora=None, guard=False, poison=None):
    """The port's one-process trainer on the whole batch."""
    trainer = W.make_trainer(W.build(name, remat), lora=lora, guard=guard,
                             collect_grad_norm=True)
    state = trainer.init()
    return (trainer,) + W.run_steps(trainer, state, poison=poison)


def reference_run(name, config, devices, lora=None, **kw):
    """The reference's ShardedTrainer (`kw`: zero1, overlap) on `config`
    over `devices` XLA host devices, from the port's seeded init of
    `name` (with `lora` (rank, alpha), a LoRA run from the port's
    seeded factors): per-step losses and optax.global_norm, final
    params, which leaves shard over fsdp, and the share of each Adam mu
    leaf one device holds."""
    from skypilot_tpu.models import lora as jax_lora
    model, _, loss_fn = _build_model(name, W.SEQ, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32)
    model = type(model)(cfg)
    mesh = jax_mesh.make_mesh(config, devices=jax.devices()[:devices])
    spec = (None if lora is None else
            jax_lora.LoraSpec(rank=lora[0], alpha=lora[1]))
    trainer = jax_train.ShardedTrainer(
        model, mesh, tx=jax_train.default_optimizer(
            learning_rate=W.LR, warmup_steps=10, total_steps=20),
        collect_grad_norm=True, lora=spec,
        **({} if loss_fn is None else {'loss_fn': loss_fn}), **kw)
    example = jnp.zeros((W.BATCH, W.SEQ), jnp.int32)
    state = trainer.init(jax.random.PRNGKey(0), example)
    init = convert.train_params_to_jax(W.build(name))
    if lora is not None:
        port = W.make_trainer(W.build(name), lora=lora).init()
        init = {'base': init,
                'lora': convert.lora_params_to_numpy(port.params['lora'])}
    state = state.replace(params=jax.tree.map(
        lambda tpl, w: jax.device_put(jnp.asarray(w, tpl.dtype),
                                      tpl.sharding), state.params, init))
    sharded = jax.tree.map(lambda s: 'fsdp' in str(s.spec),
                           trainer.state_sharding(example).params)
    step = trainer.make_train_step(example, donate=False)
    losses, norms = [], []
    for i in range(W.STEPS):
        tokens = jax_train.shard_batch(
            jnp.asarray(W.tokens_for(i, cfg.vocab_size).astype(np.int32)),
            mesh)
        state, (loss, gnorm) = step(state, tokens)
        losses.append(float(loss))
        norms.append(float(gnorm))
    final = jax.tree.map(lambda x: np.asarray(x, np.float32),
                         jax.device_get(state.params))

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)

    adam = next(x for x in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=is_adam) if is_adam(x))
    mu_share = jax.tree.map(
        lambda x: x.addressable_shards[0].data.size / x.size, adam.mu)
    return losses, norms, final, sharded, mu_share


@pytest.fixture(scope='module')
def reference():
    """llama-tiny on MeshConfig.auto(2): fsdp=2 over two devices."""
    return reference_run('llama-tiny', jax_mesh.MeshConfig.auto(2), 2)


@pytest.fixture(scope='module')
def reference_mixtral():
    """mixtral-tiny (moe_next_token_loss) on MeshConfig.auto(2)."""
    return reference_run('mixtral-tiny', jax_mesh.MeshConfig.auto(2), 2)


@pytest.fixture(scope='module')
def reference_zero1():
    """llama-tiny on data=2 x fsdp=2 over four devices, zero1 and
    overlap on."""
    return reference_run('llama-tiny',
                         jax_mesh.MeshConfig(data=2, fsdp=2), 4,
                         zero1=True, overlap=True)


def as_reference_tree(values, name='llama-tiny'):
    """{port name: array} -> the reference's params tree of `name`."""
    model = W.build(name)
    with torch.no_grad():
        for key, p in model.named_parameters():
            p.copy_(torch.as_tensor(values[key]).expand(p.shape))
    return convert.train_params_to_jax(model)


def assert_params_close(got, want):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    n_close = n_all = 0
    for path, want_leaf in flat_want.items():
        err = np.abs(flat_got[path] - want_leaf)
        n_close += int((err <= TOL + TOL * np.abs(want_leaf)).sum())
        n_all += err.size
        assert err.max() <= PARAM_TOL, (path, err.max())
    assert n_close >= 0.999 * n_all, (n_close, n_all)


# -- world 2 against the reference --------------------------------------------
def test_world2_losses_and_norms_match_the_reference(world2, reference):
    got = world2[0][0]['llama']
    losses, norms, _, _, _ = reference
    np.testing.assert_allclose(got['losses'], losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, atol=TOL, rtol=TOL)
    assert world2[0][1]['llama']['losses'] == got['losses']


def test_world2_final_params_match_the_reference(world2, reference):
    assert_params_close(as_reference_tree(world2[0][0]['llama']['params']),
                        reference[2])


def test_world2_mixtral_matches_the_reference(world2, reference_mixtral):
    """The router aux loss taken over the whole batch, as the
    reference's GSPMD program takes it over its sharded batch."""
    got = world2[0][0]['mixtral']
    losses, norms, final, _, _ = reference_mixtral
    np.testing.assert_allclose(got['losses'], losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, atol=TOL, rtol=TOL)
    assert_params_close(as_reference_tree(got['params'], 'mixtral-tiny'),
                        final)


def test_each_rank_holds_half_of_every_fsdp_leaf(world2, reference):
    sharded = reference[3]
    for rank in world2[0]:
        tree = as_reference_tree(rank['fractions'])
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        for path, is_sharded in jax.tree_util.tree_leaves_with_path(sharded):
            if is_sharded:
                assert np.all(flat[path] == 0.5), (path, flat[path].flat[0])
    # Every port leaf is a shard (the reference's whole leaves too).
    assert all(f <= 0.5 for f in world2[0][0]['fractions'].values())


# -- world 2 against world 1 --------------------------------------------------
@pytest.mark.parametrize('key,name,remat', [
    ('llama', 'llama-tiny', False), ('remat', 'llama-tiny', True),
    ('gpt', 'tiny', False), ('mixtral', 'mixtral-tiny', False),
    ('deepseek', 'deepseek-tiny', False)])
def test_world2_curve_equals_world1(world2, key, name, remat):
    _, _, losses, norms, _ = one_rank(name, remat)
    got = world2[0][0][key]
    np.testing.assert_allclose(got['losses'], losses, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, rtol=TOL)


def test_world2_lora_equals_world1_and_keeps_the_base(world2):
    trainer, state, losses, norms, _ = one_rank('llama-tiny',
                                                lora=(4, 8.0))
    for rank in world2[0]:
        got = rank['lora']
        assert got['base_kept']
        np.testing.assert_allclose(got['losses'], losses, rtol=TOL)
        np.testing.assert_allclose(got['norms'], norms, rtol=TOL)
    want = W.whole_params(state)
    got = world2[0][0]['lora']['factors']
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_poisoned_step_is_skipped_on_every_rank(world2):
    def poison(i):
        return float('nan') if i == W.POISON_STEP else 1.0

    _, _, losses, _, bads = one_rank('llama-tiny', guard=True,
                                     poison=poison)
    for rank in world2[0]:
        got = rank['guard']
        assert got['bads'] == bads == [i == W.POISON_STEP
                                       for i in range(W.STEPS)]
        assert got['kept'] and got['count'][0] == got['count'][1]
        np.testing.assert_allclose(got['losses'], losses, rtol=TOL)
    a, b = (rank['guard']['local'] for rank in world2[0])
    assert all(np.array_equal(a[n], b[n]) for n in a)


# -- zero1 and overlap on data=2 x fsdp=2 ----------------------------------
@pytest.mark.parametrize('key', ['zero1', 'overlap'])
def test_zero1_curve_equals_the_replicated_one(world4, key):
    ranks = world4[0]
    for rank in ranks:
        np.testing.assert_allclose(rank[key]['losses'],
                                   rank['off']['losses'], rtol=TOL)
        np.testing.assert_allclose(rank[key]['norms'],
                                   rank['off']['norms'], rtol=TOL)
    want = ranks[0]['off']['params']
    for name, value in ranks[0][key]['params'].items():
        np.testing.assert_allclose(value, want[name], atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize('key', ['off', 'zero1', 'overlap'])
def test_data2_fsdp2_matches_the_reference_zero1(world4, reference_zero1,
                                                 key):
    """data=2 x fsdp=2 against the reference's zero1 + overlap run on
    four devices: the reference's contract is that neither changes a
    number, so all three of the port's runs follow it."""
    losses, norms, final, _, _ = reference_zero1
    got = world4[0][0][key]
    np.testing.assert_allclose(got['losses'], losses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got['norms'], norms, atol=TOL, rtol=TOL)
    assert_params_close(as_reference_tree(got['params']), final)


def test_zero1_moments_shard_as_the_reference(world4, reference_zero1):
    """Each rank's share of every Adam mu leaf is the reference device's
    where the reference shards the leaf over fsdp (1/4: fsdp and data),
    and no larger where it keeps the leaf whole over fsdp (the port
    shards those too)."""
    _, _, _, sharded, want = reference_zero1
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    for rank in world4[0]:
        got = dict(jax.tree_util.tree_leaves_with_path(
            as_reference_tree(rank['zero1']['mu_fractions'])))
        for path, is_sharded in jax.tree_util.tree_leaves_with_path(sharded):
            share = float(got[path].flat[0])
            if is_sharded:
                assert share == flat_want[path] == 0.25, (path, share)
            else:
                assert share <= flat_want[path], (path, share)


def test_zero1_moments_are_one_data_th_of_the_shard(world4):
    for rank in world4[0]:
        pieces = rank['zero1']['pieces']
        assert sum(dim is not None for _, _, dim in pieces) \
            >= 0.8 * len(pieces)
        for shard, moment, dim in pieces:
            assert moment * (2 if dim is not None else 1) == shard
        assert all(dim is None and moment == shard
                   for shard, moment, dim in rank['off']['pieces'])


def test_world1_curve_matches_the_4_rank_run(world4):
    _, _, losses, _, _ = one_rank('llama-tiny')
    np.testing.assert_allclose(world4[0][0]['off']['losses'], losses,
                               rtol=TOL)


# -- checkpoints --------------------------------------------------------------
def test_world2_checkpoint_restores_at_world1_bit_for_bit(world2, tmp_path):
    ranks, ckpt = world2
    assert ranks[0]['saved'] and not ranks[0]['saved_again']
    assert sorted(os.listdir(ckpt)) == [str(W.STEPS),
                                        f'manifest-{W.STEPS}.json']
    trainer = W.make_trainer(W.build('llama-tiny'))
    state = pt_ckpt.CheckpointManager(str(ckpt)).restore(trainer.init())
    assert state.step == W.STEPS
    assert int(state.opt_state['count']) == W.STEPS
    params = W.whole_params(state)
    want = ranks[0]['llama']['params']
    assert all(np.array_equal(params[n], want[n]) for n in want)
    mu = W.whole_moments(state)
    assert all(np.array_equal(a, b)
               for a, b in zip(mu, ranks[0]['llama']['mu']))
    again = tmp_path / 'again'
    pt_ckpt.CheckpointManager(str(again)).save(state.step, state,
                                               force=True)
    name = os.path.join(str(W.STEPS), pt_ckpt.STATE_FILE)
    assert filecmp.cmp(ckpt / name, again / name, shallow=False)


def test_a_save_holds_one_whole_leaf_at_a_time(world2, world4):
    """A sharded save gathers a parameter, its mu, its nu, one after the
    other, and no rank keeps a whole leaf past the next gather (rank 0
    moves each to the host at once): a card holds its shards and one
    whole leaf, not the whole state."""
    for ranks in (world2[0], world4[0]):
        for rank in ranks:
            seen = rank['save_whole_leaves']
            assert seen['calls'] == 3 * seen['leaves']
            assert seen['peak'] == 1, seen


def test_checkpoint_moves_across_world_sizes_and_zero1(world2, world4):
    (ranks, ckpt), (ranks4, ckpt4) = world2, world4
    assert ranks4[0]['restored_step'] == (W.STEPS, W.STEPS)
    name = os.path.join(str(W.STEPS), pt_ckpt.STATE_FILE)
    assert filecmp.cmp(ckpt / name, ckpt4 / 'a' / name, shallow=False)
    assert filecmp.cmp(Path(f'{ckpt}_odd') / name, ckpt4 / 'odd' / name,
                       shallow=False)
    assert all(rank['toggled_equal'] for rank in ranks4)


def test_uneven_shards_train_and_restore_as_one_card(world2, tmp_path):
    """An odd vocab (509 rows over fsdp=2: 255 and 254): the world-1
    curve, and the checkpoint restores at world 1 bit for bit."""
    ranks, ckpt = world2
    assert [rank['odd']['local_rows'] for rank in ranks] == [255, 254]
    trainer = W.make_trainer(W.build('llama-tiny', vocab_size=W.ODD_VOCAB),
                             collect_grad_norm=True)
    _, losses, norms, _ = W.run_steps(trainer, trainer.init())
    np.testing.assert_allclose(ranks[0]['odd']['losses'], losses, rtol=TOL)
    np.testing.assert_allclose(ranks[0]['odd']['norms'], norms, rtol=TOL)
    one = W.make_trainer(W.build('llama-tiny', vocab_size=W.ODD_VOCAB))
    state = pt_ckpt.CheckpointManager(f'{ckpt}_odd').restore(one.init())
    params, mu = W.whole_params(state), W.whole_moments(state)
    want = ranks[0]['odd']
    assert all(np.array_equal(params[n], want['params'][n]) for n in params)
    assert all(np.array_equal(a, b) for a, b in zip(mu, want['mu']))


def test_overlap_requires_zero1_as_the_reference():
    from skypilot_tpu.models.llama import Llama, LlamaConfig
    with pytest.raises(ValueError) as want:
        jax_train.ShardedTrainer(Llama(LlamaConfig.tiny()), None,
                                 overlap=True)
    with pytest.raises(ValueError) as got:
        W.make_trainer(W.build('llama-tiny'), overlap=True)
    assert str(got.value) == str(want.value)


def test_state_names_follow_trainable_items():
    trainer = W.make_trainer(W.build('llama-tiny'), lora=(4, 8.0))
    items = trainable_items(trainer.init().params)
    assert items[0][0] == 'lora.layer_0.wk.a'
    assert len(items) == 2 * 4 * 2
