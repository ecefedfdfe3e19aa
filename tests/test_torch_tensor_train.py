"""Tensor-parallel training in the port (`train_lm --tensor`:
skypilot_tpu_torch/parallel/tensor.py, the families' `tensor_forward`,
the vocab-split loss of ops/fused_xent.py, parallel/{fsdp,train,
checkpoints}.py) on gloo, in spawned CPU processes, against the
reference's ShardedTrainer on XLA host devices, f32:

  - MeshConfig(tensor=2) on llama-tiny, tiny (GPT-2), deepseek-tiny;
    fsdp=2 x tensor=2 on llama-tiny; expert=2 x tensor=2 on
    mixtral-tiny; tensor=4 on llama-tiny (2 kv heads over 4 shards: the
    GQA remainder rule); data=2 x fsdp=2 x tensor=2 with zero1 on
    llama-tiny (tests/conftest.py's mesh); tensor=2 x seq=2 on
    llama-tiny and mixtral-tiny (ring attention over a shard's heads,
    each seq rank's block of the loss): steps 1-3's losses within
    rtol 2e-5 and grad norms within rtol 3e-4 / atol 3e-5 of the
    reference's on the same mesh (the reference's own tolerances,
    tests/unit_tests/test_pipeline.py), the final parameters within
    test_torch_fsdp.py's bounds;
  - a LoRA run at tensor=2 (its B factors of q / k / v split by
    columns, wo's A by rows) holds the same pins against the reference's
    LoRA run on MeshConfig(tensor=2) from the same factors, and follows
    the port's one-process LoRA curve;
  - two controls break the path and must fail a pin: the backward sum
    of a sharded region's input skipped ('copy_skipped': the norm), and
    the vocab-parallel max dropped ('max_dropped': the loss);
  - the in-process seam (`ShardedTrainer(devices=['cpu'] * T)`) gives
    the gloo ranks' numbers;
  - each rank holds 1/T of every sliced leaf, and whole leaves are
    averaged (or, read inside a region, summed) over `tensor` once a
    leaf a step;
  - a guarded step poisoned on one rank is skipped on every rank;
  - checkpoints, bit for bit: a tensor=2 save restores on one process,
    a one-process save restores under tensor=2, and the tensor=2 save
    restores under fsdp=2 x tensor=2;
  - `train_lm --cpu --tensor 2` runs as two workers and gives the
    one-process curve (bf16: rtol 1e-4), and prints the reference's
    mesh line.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402
from test_torch_fsdp import (as_reference_tree,  # noqa: E402
                             assert_params_close, one_rank, reference_run,
                             run_job)

from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt  # noqa: E402
from skypilot_tpu_torch.recipes import train_lm  # noqa: E402

LOSS_RTOL = 2e-5
NORM_RTOL, NORM_ATOL = 3e-4, 3e-5
STEPS = 3
LORA = (4, 8.0)
BF16_LOSS_RTOL = 1e-4

#: key: (model, the job's MeshConfig fields, its world, extra kwargs).
RUNS = {
    'llama_t2': ('llama-tiny', {'tensor': 2}, 2, {}),
    'gpt_t2': ('tiny', {'tensor': 2}, 2, {}),
    'deepseek_t2': ('deepseek-tiny', {'tensor': 2}, 2, {}),
    'llama_f2t2': ('llama-tiny', {'fsdp': 2, 'tensor': 2}, 4, {}),
    'mixtral_e2t2': ('mixtral-tiny', {'expert': 2, 'tensor': 2}, 4, {}),
    'llama_t4': ('llama-tiny', {'tensor': 4}, 4, {}),
    'llama_d2f2t2': ('llama-tiny', {'data': 2, 'fsdp': 2, 'tensor': 2}, 8,
                     {'zero1': True}),
    'llama_t2s2': ('llama-tiny', {'tensor': 2, 'seq': 2}, 4, {}),
    'mixtral_t2s2': ('mixtral-tiny', {'tensor': 2, 'seq': 2}, 4, {}),
}
#: The LoRA run (q / k / v B factors split by columns, wo's A by rows).
LORA_RUN = ('llama-tiny', {'tensor': 2}, 2, {'lora': LORA})
CONTROLS = {'copy_skipped': 'norms', 'max_dropped': 'losses'}


def reference_of(run):
    """The reference's (losses, norms, final params) for `run`, a
    (model, MeshConfig fields, world, kwargs) of RUNS or LORA_RUN."""
    name, fields, world, kw = run
    losses, norms, final, _, _ = reference_run(
        name, jax_mesh.MeshConfig(**fields), world, **kw)
    return losses, norms, final


@pytest.fixture(scope='module')
def references():
    """{key: the reference's run}, compiled in threads (XLA compiles
    outside the GIL) while the gloo jobs run in their processes."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(3)
    runs = dict(RUNS, lora_t2=LORA_RUN)
    futures = {key: pool.submit(reference_of, runs[key])
               for key in sorted(runs)}
    yield futures
    pool.shutdown()


def specs_for(world):
    return [(key, name, fields, kw) for key, (name, fields, w, kw)
            in RUNS.items() if w == world]


@pytest.fixture(scope='module')
def one_card_ckpt(tmp_path_factory):
    """llama-tiny after STEPS one-process steps, saved."""
    out = tmp_path_factory.mktemp('one')
    trainer = W.make_trainer(W.build('llama-tiny'), collect_grad_norm=True)
    state, *_ = W.run_steps(trainer, trainer.init())
    pt_ckpt.CheckpointManager(str(out)).save(state.step, state, force=True)
    return out, W.whole_params(state), W.whole_moments(state)


@pytest.fixture(scope='module')
def world2(tmp_path_factory, one_card_ckpt):
    out = tmp_path_factory.mktemp('tensor2')
    specs = specs_for(2) + [
        ('lora_t2', *LORA_RUN[:2], LORA_RUN[3]),
        ('restored_t2', 'llama-tiny', {'tensor': 2},
         {'restore': str(one_card_ckpt[0])})]
    specs += [(f'llama_t2_{fault}', 'llama-tiny', {'tensor': 2},
               {'fault': fault}) for fault in CONTROLS]
    ranks = run_job(W.tensor_job, 2, str(out), specs,
                    {'llama_t2': str(out / 'ckpt')})
    return ranks, out / 'ckpt'


@pytest.fixture(scope='module')
def world4(tmp_path_factory, world2):
    out = tmp_path_factory.mktemp('tensor4')
    specs = specs_for(4) + [
        ('restored_f2t2', 'llama-tiny', {'fsdp': 2, 'tensor': 2},
         {'restore': str(world2[1])}),
        ('guard_f2t2', 'llama-tiny', {'fsdp': 2, 'tensor': 2},
         {'poison': 3})]
    return run_job(W.tensor_job, 4, str(out), specs, {})


@pytest.fixture(scope='module')
def world8(tmp_path_factory):
    out = tmp_path_factory.mktemp('tensor8')
    return run_job(W.tensor_job, 8, str(out), specs_for(8), {})


@pytest.fixture(scope='module')
def runs(references, world2, world4, world8):
    """{key: every rank's result}."""
    out = {}
    for ranks in (world2[0], world4, world8):
        for key in ranks[0]:
            out[key] = [r[key] for r in ranks]
    return out


def pins(got, want_losses, want_norms):
    """The two pins on steps 1-3: (losses hold, norms hold)."""
    return (np.allclose(got['losses'][:STEPS], want_losses[:STEPS],
                        rtol=LOSS_RTOL, atol=0),
            np.allclose(got['norms'][:STEPS], want_norms[:STEPS],
                        rtol=NORM_RTOL, atol=NORM_ATOL))


@pytest.mark.parametrize('key', sorted(RUNS))
def test_matches_the_reference(runs, references, key):
    name = RUNS[key][0]
    losses, norms, final = references[key].result()
    got = runs[key][0]
    assert pins(got, losses, norms) == (True, True), (
        got['losses'], losses, got['norms'], norms)
    assert_params_close(as_reference_tree(got['params'], name), final)
    for rank in runs[key][1:]:
        assert rank['losses'] == got['losses']


@pytest.mark.parametrize('fault', sorted(CONTROLS))
def test_a_broken_path_fails_its_pin(runs, references, fault):
    losses, norms, _ = references['llama_t2'].result()
    loss_ok, norm_ok = pins(runs[f'llama_t2_{fault}'][0], losses, norms)
    assert not (norm_ok if CONTROLS[fault] == 'norms' else loss_ok)


def test_lora_follows_the_one_process_curve(runs):
    _, _, losses, norms, _ = one_rank('llama-tiny', lora=LORA)
    got = runs['lora_t2'][0]
    assert pins(got, losses, norms) == (True, True)


def lora_tree(params):
    """{'lora.<layer>.<target>.<a|b>': array} -> the reference's LoRA
    tree {layer: {target: {'a', 'b'}}}."""
    tree = {}
    for key, value in params.items():
        _, layer, target, k = key.split('.')
        tree.setdefault(layer, {}).setdefault(target, {})[k] = value
    return tree


def test_lora_matches_the_reference(runs, references):
    """LoRA under --tensor 2 against the reference's LoRA run on
    MeshConfig(tensor=2), from the same seeded factors: the pins on
    steps 1-3, the trained factors within test_torch_fsdp.py's bounds,
    every rank on the same curve."""
    losses, norms, final = references['lora_t2'].result()
    got = runs['lora_t2'][0]
    assert pins(got, losses, norms) == (True, True), (
        got['losses'], losses, got['norms'], norms)
    assert_params_close(lora_tree(got['params']), final['lora'])
    assert runs['lora_t2'][1]['losses'] == got['losses']


@pytest.mark.parametrize('key,ways', [('llama_t2', 2), ('gpt_t2', 2),
                                      ('deepseek_t2', 2),
                                      ('llama_t4', 4)])
def test_in_process_shards_give_the_ranks_numbers(runs, key, ways):
    name = RUNS[key][0]
    _, _, local = W.tensor_run(None, name, slice(None),
                               devices=['cpu'] * ways)
    got = runs[key][0]
    assert pins(got, local['losses'], local['norms']) == (True, True)
    for n, v in local['params'].items():
        np.testing.assert_allclose(got['params'][n], v, rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_whole_leaves_sync_over_tensor_once_a_step(runs):
    """The layout syncs each whole leaf over `tensor` once a step; the
    sliced ones never."""
    from skypilot_tpu_torch.parallel import tensor as tensor_lib
    model = W.build('llama-tiny')
    _, axes = tensor_lib.model_axes(model, 2)
    sliced = sum(1 for a in axes.values() if a != 'sum')
    whole = sum(1 for _ in model.parameters()) - sliced
    for key in ('llama_t2', 'llama_f2t2'):
        for rank in runs[key]:
            assert rank['reductions']['tensor'] == whole * W.STEPS


def test_the_remainder_rule_sums_wk_and_wv(runs):
    """At tensor=4 llama-tiny's 2 kv heads do not split: wk / wv are
    whole on every rank and their gradient is the ranks' sum."""
    from skypilot_tpu_torch.parallel import tensor as tensor_lib
    _, axes = tensor_lib.model_axes(W.build('llama-tiny'), 4)
    assert {n for n, a in axes.items() if a == 'sum'} == {
        f'layers.{i}.attn.{w}.weight' for i in range(2)
        for w in ('wk', 'wv')}
    assert runs['llama_t4'][0]['summary'] == 'Mesh(tensor=4)'


def test_poisoned_step_is_skipped_on_every_rank(runs):
    def poison(i):
        return float('nan') if i == W.POISON_STEP else 1.0

    _, _, losses, _, bads = one_rank('llama-tiny', guard=True,
                                     poison=poison)
    for rank in runs['guard_f2t2']:
        assert rank['bads'] == bads
        np.testing.assert_allclose(rank['losses'], losses, rtol=LOSS_RTOL)


def same_state(got, params, mu):
    return (all(np.array_equal(got['params'][n], params[n]) for n in params)
            and all(np.array_equal(a, b) for a, b in zip(got['mu'], mu)))


def test_tensor2_checkpoint_restores_on_one_process(world2):
    ranks, ckpt = world2
    trainer = W.make_trainer(W.build('llama-tiny'))
    state = pt_ckpt.CheckpointManager(str(ckpt)).restore(trainer.init())
    assert state.step == W.STEPS
    got = ranks[0]['llama_t2']
    assert same_state(got, W.whole_params(state), W.whole_moments(state))


def test_one_process_checkpoint_restores_under_tensor2(runs, one_card_ckpt):
    _, params, mu = one_card_ckpt
    for rank in runs['restored_t2']:
        assert rank['step'] == W.STEPS
        assert same_state(rank, params, mu)


def test_tensor2_checkpoint_restores_under_fsdp2_tensor2(runs):
    want = runs['llama_t2'][0]
    for rank in runs['restored_f2t2']:
        assert same_state(rank, want['params'], want['mu'])


def metrics_losses(path):
    return [json.loads(line)['loss']
            for line in Path(path).read_text().splitlines()]


def test_train_lm_tensor_runs_as_two_workers(tmp_path, capfd):
    argv = ['--cpu', '--model', 'llama-tiny', '--steps', '2', '--seq',
            '32', '--global-batch', '2', '--log-every', '1']
    train_lm.main([*argv, '--metrics-file', str(tmp_path / 'one.jsonl')])
    train_lm.main([*argv, '--tensor', '2', '--metrics-file',
                   str(tmp_path / 'two.jsonl')], workers=2)
    out = capfd.readouterr().out
    assert 'devices=2 Mesh(tensor=2)' in out
    # train_lm trains in bf16: the shards' partial sums round apart from
    # the one-process products (2.2e-5 at step 1 on this box).
    np.testing.assert_allclose(metrics_losses(tmp_path / 'two.jsonl'),
                               metrics_losses(tmp_path / 'one.jsonl'),
                               rtol=BF16_LOSS_RTOL)


def test_module_shard_methods_compose_in_either_order():
    """MoEFeedForward.shard_experts and shard_tensor in either order
    keep the same slices (experts over `expert`, their hidden axis over
    `tensor`); Attention / FeedForward.shard_tensor slice as the
    block-level table does."""
    from skypilot_tpu_torch.parallel import tensor as tensor_lib
    first, second = (W.build('mixtral-tiny').layers[0].moe
                     for _ in range(2))
    first.shard_experts(None, 1, 2)
    first.shard_tensor(1, 2)
    second.shard_tensor(1, 2)
    second.shard_experts(None, 1, 2)
    whole = W.build('mixtral-tiny').layers[0].moe
    for name, cut in (('w_gate', (slice(2, 4), slice(None), slice(128, 256))),
                      ('w_up', (slice(2, 4), slice(None), slice(128, 256))),
                      ('w_down', (slice(2, 4), slice(128, 256)))):
        assert torch.equal(getattr(first, name), getattr(second, name))
        assert torch.equal(getattr(first, name), getattr(whole, name)[cut])
    block, want = (W.build('llama-tiny').layers[0] for _ in range(2))
    block.attn.shard_tensor(1, 2, True)
    block.mlp.shard_tensor(1, 2)
    tensor_lib.shard_block(want, 1, 2, True)
    for name, p in want.named_parameters():
        assert torch.equal(block.get_parameter(name), p), name
    assert block.attn.num_heads == 2 and block.attn.num_kv_heads == 1
    assert block.attn.wo.partial_sum and block.mlp.w_down.partial_sum
