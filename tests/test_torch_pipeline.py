"""The port's pipeline-parallel trainer (skypilot_tpu_torch/parallel/
pipeline.py) in process on ['cpu', 'cpu'], against the reference's
PipelinedLM on XLA host devices (MeshConfig(stage=2)), f32, from the
port's seeded init (carried into the reference's (stacked, rest) tree,
padded and permuted, by `convert.train_params_to_jax` and the
reference's own `split_params`):

  - gpipe, 1f1b and interleaved (v = 2) on tiny GPT with a vocab of
    501 that 2 stages do not divide; Llama (GQA) at 3 layers over 2
    stages (a padded slot) on 1f1b; Mixtral (the router aux: the mean of
    per-microbatch losses) on gpipe; DeepSeek (MLA) on interleaved:
    the loss (also `loss`, the schedule's forwards alone, bit for bit
    with `loss_and_grad`'s) and every gradient (the reference's through
    its `merge_params`; gpipe's through `jax.grad` of its fused scan)
    within TOL = 1e-5 (atol and rtol), and the step-1 loss and grad
    norm of one AdamW step of `default_optimizer(learning_rate=LR)`
    within TOL, with the parameters after it within TOL wherever the
    reference's grad is at least GRAD_FLOOR in size, and within
    PARAM_TOL = 2 LR (the most one step moves a parameter) for all:
    Adam's first update is lr * g / (|g| + eps), which jumps between
    -lr and lr where a grad is as small as the f32 noise of its sum;
  - each case again with its stages' blocks over 2 tensor shards in
    process (a [2][2] device grid): the plain pipeline's loss, grads,
    step and gathered parameters within TOL (the parameters as above);
  - `split_vocab_loss` (the witness's vocab-split head) equals the
    model's own next-token loss and its grads;
  - a guarded step with a NaN loss scale keeps every parameter and
    moment bit for bit and still counts the step; a spike past
    max_grad_norm does too;
  - merge(split(x)) is x bit for bit at S = 2 and 3, with the padded
    vocab and the interleave permutation;
  - the reference's refusals: dropout, remat, an unsupported family,
    and the schedule's own argument errors;
  - `microbatch_rows` is the reference's data sharding of a microbatch;
  - the pipelined checkpoint of an in-process run is, byte for byte,
    the one-card trainer's file of the same state, and restores into a
    fresh pipeline (interleaved, another stage count) bit for bit.

The reference's runs are cached in one module fixture.
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

from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu.parallel import pipeline as jax_pipe  # noqa: E402
from skypilot_tpu.parallel import train as jax_train  # noqa: E402
from skypilot_tpu.recipes.train_lm import _build_model  # noqa: E402
from skypilot_tpu_torch.models import convert, registry  # noqa: E402
from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt  # noqa: E402
from skypilot_tpu_torch.parallel import pipeline as pt_pipe  # noqa: E402
from skypilot_tpu_torch.parallel import train as pt_train  # noqa: E402

TOL = 1e-5
LR = 1e-2
PARAM_TOL = 2 * LR
GRAD_FLOOR = 1e-6
SEQ, BATCH = 16, 8
#: (key, model, config fields, schedule, virtual stages, microbatches)
CASES = (
    ('gpt_gpipe', 'tiny', {'vocab_size': 501}, 'gpipe', 1, 4),
    ('gpt_1f1b', 'tiny', {'vocab_size': 501}, '1f1b', 1, 4),
    ('gpt_interleaved', 'tiny', {'vocab_size': 501}, 'interleaved', 2, 4),
    ('llama_3layers', 'llama-tiny', {'num_layers': 3}, '1f1b', 1, 4),
    ('mixtral', 'mixtral-tiny', {}, 'gpipe', 1, 2),
    ('deepseek', 'deepseek-tiny', {}, 'interleaved', 2, 2),
)


def build(name, **fields):
    """The port's f32 training model of `name` (seed 0)."""
    cfg = dataclasses.replace(registry.train_config(name, SEQ),
                              dtype=torch.float32, **fields)
    return convert.init_params(cfg, seed=0, device='cpu')


def tokens_for(vocab, seed=3):
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int64)


def port_names(tree, cfg):
    """{port name: f32 numpy} of a reference param-shaped tree."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    model = convert.train_params_from_jax(tree, cfg)
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def reference_run(name, fields, style, v, M, data=1):
    """The reference's PipelinedLM on MeshConfig(stage=2, data) of XLA
    host devices from the port's init: loss, grads, step-1 loss and
    norm, params after one step of its optimizer."""
    jmodel, _, _ = _build_model(name, SEQ, False)
    jcfg = dataclasses.replace(jmodel.config, dtype=jnp.float32, **fields)
    if hasattr(jcfg, 'logits_dtype'):
        jcfg = dataclasses.replace(jcfg, logits_dtype=jnp.float32)
    jmodel = type(jmodel)(jcfg)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(stage=2, data=data),
                              devices=jax.devices()[:2 * data])
    pp = jax_pipe.PipelinedLM(jmodel, mesh, num_microbatches=M,
                              schedule=style, virtual_stages=v)
    port = build(name, **fields)
    tree = jax.tree.map(jnp.asarray, convert.train_params_to_jax(port))
    stacked, rest = pp.split_params(tree)
    tokens = jnp.asarray(tokens_for(port.config.vocab_size), jnp.int32)
    if style == 'gpipe':
        loss, (gs, gr) = jax.value_and_grad(pp.loss, argnums=(0, 1))(
            stacked, rest, tokens)
    else:
        loss, (gs, gr) = pp.loss_and_grad(stacked, rest, tokens)
    # The step of the reference's make_train_step (tx.update and
    # apply_updates on these grads; its loss is this loss), run here on
    # the host so that no second pipeline compile is paid.
    tx = jax_train.default_optimizer(learning_rate=LR)

    @jax.jit
    def step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), optax.global_norm(grads)

    stepped, gnorm = step((stacked, rest), (gs, gr))
    return {'loss': float(loss),
            'grads': port_names(pp.merge_params(gs, gr), port.config),
            'loss1': float(loss), 'gnorm': float(gnorm),
            'params': port_names(pp.merge_params(*stepped), port.config)}


@pytest.fixture(scope='module')
def reference():
    # The six compiles overlap in threads (XLA compiles outside the GIL).
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        runs = pool.map(lambda case: reference_run(*case[1:]), CASES)
        return {case[0]: run for case, run in zip(CASES, runs)}


def port_run(name, fields, style, v, M):
    model = build(name, **fields)
    pp = pt_pipe.PipelinedLM(model, devices=['cpu', 'cpu'],
                             num_microbatches=M, schedule=style,
                             virtual_stages=v)
    tx = pt_train.default_optimizer(learning_rate=LR)
    state = pp.init(tx)
    tokens = torch.from_numpy(tokens_for(model.config.vocab_size))
    loss, grads = pp.loss_and_grad(tokens)
    counts = (pp.group.handoffs, pp.group.collectives)
    assert pp.loss(tokens).item() == loss.item()    # the forwards alone
    merged = pp.merge_params([grads[s] for s in range(2)])
    state, (loss1, gnorm) = pp.make_train_step(
        tx, collect_grad_norm=True)(state, tokens)
    params = pp.merge_params([state.params[s] for s in range(2)])
    return {'loss': loss.item(),
            'grads': {n: g.numpy() for n, g in merged.items()},
            'loss1': loss1.item(), 'gnorm': gnorm.item(),
            'params': {n: p.detach().numpy() for n, p in params.items()},
            'state': state, 'pp': pp, 'counts': counts}


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_matches_reference_pipeline(case, reference):
    key, name, fields, style, v, M = case
    ref, got = reference[key], port_run(name, fields, style, v, M)
    np.testing.assert_allclose(got['loss'], ref['loss'], rtol=TOL, atol=TOL)
    assert set(got['grads']) == set(ref['grads'])
    for n, g in ref['grads'].items():
        np.testing.assert_allclose(got['grads'][n], g, rtol=TOL, atol=TOL,
                                   err_msg=n)
    np.testing.assert_allclose(got['loss1'], ref['loss1'], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got['gnorm'], ref['gnorm'], rtol=TOL,
                               atol=TOL)
    for n, p in ref['params'].items():
        np.testing.assert_allclose(got['params'][n], p, rtol=0,
                                   atol=PARAM_TOL, err_msg=n)
        sure = np.abs(ref['grads'][n]) >= GRAD_FLOOR
        np.testing.assert_allclose(got['params'][n][sure], p[sure],
                                   rtol=TOL, atol=TOL, err_msg=n)


def joined(pp, grads):
    """{model name: numpy} of a tensor grid's per-stage values, each
    block leaf's shard slices (`name@t`) joined."""
    from skypilot_tpu_torch.parallel.tensor import join_pieces
    out = {}
    for s, values in grads.items():
        for n, g in values.items():
            if '@' in n:
                continue
            pieces = [g] + [values[f'{n}@{t}'] for t in range(1, 2)
                            if f'{n}@{t}' in values]
            if len(pieces) > 1:
                g = join_pieces(pieces, pp._split(n)[0], pp.shapes[n])
            out.setdefault(n, []).append(g)
    return {n: (torch.cat(v)[:pp.shapes[n][0]] if len(v) > 1 else v[0])
            .detach().numpy() for n, v in out.items()}


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_tensor_grid_is_the_plain_pipeline(case):
    """Each stage's blocks over 2 tensor shards in process (a [2][2]
    device grid): the plain pipeline's loss, every gradient, the step-1
    loss and norm, and the parameters after the step (gathered whole
    as a checkpoint gathers them) within TOL."""
    key, name, fields, style, v, M = case
    want = port_run(name, fields, style, v, M)
    model = build(name, **fields)
    pp = pt_pipe.PipelinedLM(model, devices=[['cpu', 'cpu']] * 2,
                             num_microbatches=M, schedule=style,
                             virtual_stages=v)
    tx = pt_train.default_optimizer(learning_rate=LR)
    state = pp.init(tx)
    tokens = torch.from_numpy(tokens_for(model.config.vocab_size))
    loss, grads = pp.loss_and_grad(tokens)
    assert any('@1' in n for n in grads[0])       # the stage's slices
    np.testing.assert_allclose(loss.item(), want['loss'], rtol=TOL, atol=TOL)
    got = joined(pp, grads)
    assert set(got) == set(want['grads'])
    for n, g in want['grads'].items():
        np.testing.assert_allclose(got[n], g, rtol=TOL, atol=TOL, err_msg=n)
    state, (loss1, gnorm) = pp.make_train_step(
        tx, collect_grad_norm=True)(state, tokens)
    np.testing.assert_allclose([loss1.item(), gnorm.item()],
                               [want['loss1'], want['gnorm']], rtol=TOL,
                               atol=TOL)
    for i, n in enumerate(pp.names):
        p, w = pp.gather_leaf(state, i, 'param').numpy(), want['params'][n]
        np.testing.assert_allclose(p, w, rtol=0, atol=PARAM_TOL, err_msg=n)
        sure = np.abs(want['grads'][n]) >= GRAD_FLOOR
        np.testing.assert_allclose(p[sure], w[sure], rtol=TOL, atol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize('name', ['tiny', 'llama-tiny', 'mixtral-tiny'])
def test_split_vocab_loss_is_the_models_loss(name):
    """The witness's vocab-split head: the model's own next-token loss,
    and its grads, over 3 shards of an odd vocab."""
    fields = {'vocab_size': 509}
    model = build(name, **fields)
    tokens = torch.from_numpy(tokens_for(509))
    params = [p for _, p in model.named_parameters()]
    out = model(tokens, return_hidden=True)
    hidden, aux = out if isinstance(out, tuple) else (out, 0.0)
    table = model.wte if name == 'tiny' else model.lm_head
    got = pt_pipe.split_vocab_loss(hidden, table, tokens, 3,
                                   model.config) + aux
    g_got = torch.autograd.grad(got, params)
    out = model(tokens)
    logits, aux = out if isinstance(out, tuple) else (out, 0.0)
    want = pt_train.next_token_loss(logits, tokens) + aux
    g_want = torch.autograd.grad(want, params)
    np.testing.assert_allclose(got.item(), want.item(), rtol=TOL, atol=TOL)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def snapshot(state):
    return {(s, n): p.detach().clone() for s, ps in state.params.items()
            for n, p in ps.items()}, {
        (s, k, i): m.clone() for s, opt in state.opt_state.items()
        for k in ('mu', 'nu') for i, m in enumerate(opt[k])}


@pytest.mark.parametrize('poison', ['nan_scale', 'spike'])
def test_guarded_step_keeps_the_state(poison):
    model = build('llama-tiny')
    pp = pt_pipe.PipelinedLM(model, devices=['cpu', 'cpu'],
                             num_microbatches=2, schedule='1f1b')
    tx = pt_train.default_optimizer(learning_rate=LR)
    state = pp.init(tx)
    step = pp.make_train_step(tx, guard=True)
    tokens = torch.from_numpy(tokens_for(512))
    state, (_, _, bad) = step(state, tokens)       # moments become nonzero
    assert not bool(bad)
    params, moments = snapshot(state)
    counts = [int(o['count']) for o in state.opt_state.values()]
    kw = ({'loss_scale': float('nan')} if poison == 'nan_scale'
          else {'max_grad_norm': 1e-6})
    state, (loss, gnorm, bad) = step(state, tokens, **kw)
    assert bool(bad) and state.step == 2
    if poison == 'nan_scale':
        assert not np.isfinite(loss.item())
    else:
        assert gnorm.item() > 1e-6
    after_p, after_m = snapshot(state)
    for k, v in params.items():
        assert torch.equal(after_p[k], v), k
    for k, v in moments.items():
        assert torch.equal(after_m[k], v), k
    assert [int(o['count']) for o in state.opt_state.values()] == counts
    state, (_, _, bad) = step(state, tokens)
    assert not bool(bad) and state.step == 3


@pytest.mark.parametrize('stages,style,v', [(2, 'gpipe', 1), (2, 'interleaved', 2),
                                            (3, '1f1b', 1), (3, 'interleaved', 2)])
@pytest.mark.parametrize('name', ['tiny', 'llama-tiny'])
def test_split_merge_round_trip(name, stages, style, v):
    model = build(name, vocab_size=509, num_layers=5)
    pp = pt_pipe.PipelinedLM(model, devices=['cpu'] * stages,
                             num_microbatches=stages * 2, schedule=style,
                             virtual_stages=v)
    state = dict(model.named_parameters())
    pieces = pp.split_params(state)
    assert len(pieces) == stages
    for s, piece in enumerate(pieces):
        table = piece['wte' if name == 'tiny' else 'tok_embed']
        assert table.shape[0] == pp.vshard == -(-509 // stages)
        for n in piece:
            if n.startswith(('h.', 'layers.')):
                layer = int(n.split('.')[1])
                # Device s hosts virtual stages s, S + s, ...
                assert (layer // pp.layers_per_chunk) % stages == s
    assert pp.padded_vocab == pp.vshard * stages
    # The padding is zeros.
    last = pieces[-1]['wte' if name == 'tiny' else 'tok_embed']
    assert torch.count_nonzero(last[509 - (stages - 1) * pp.vshard:]) == 0
    back = pp.merge_params(pieces)
    assert list(back) == list(state)
    for n, t in state.items():
        assert torch.equal(back[n], t), n


def test_interleave_layout_is_the_references():
    """Which global layers each device hosts, against the reference's
    permuted stack (3 stages x 2 chunks of 1 layer, 5 real layers)."""
    jmodel, _, _ = _build_model('llama-tiny', SEQ, False)
    jmodel = type(jmodel)(dataclasses.replace(jmodel.config, num_layers=5))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(stage=3),
                              devices=jax.devices()[:3])
    ref = jax_pipe.PipelinedLM(jmodel, mesh, num_microbatches=6,
                               schedule='interleaved', virtual_stages=2)
    pp = pt_pipe.PipelinedLM(build('llama-tiny', num_layers=5),
                             devices=['cpu'] * 3, num_microbatches=6,
                             schedule='interleaved', virtual_stages=2)
    assert (pp.layers_per_chunk, pp.layers_per_stage, pp.padded_layers) == (
        ref.layers_per_chunk, ref.layers_per_stage, ref.padded_layers)
    perm = ref._layer_perm.reshape(3, -1)   # device s's stacked rows
    for s in range(3):
        hosted = sorted({int(n.split('.')[1]) for n in
                        pp.split_params(dict(pp.model.named_parameters()))[s]
                        if n.startswith('layers.')})
        assert hosted == sorted(int(i) for i in perm[s] if i < 5)
    assert (pp.vshard, pp.padded_vocab) == (ref.vshard, ref.padded_vocab)


def test_refusals_are_the_references():
    cfg = registry.train_config('llama-tiny', SEQ)
    with pytest.raises(ValueError, match='does not rematerialize blocks'):
        pt_pipe.PipelinedLM(convert.init_params(
            dataclasses.replace(cfg, remat=True)), devices=['cpu'] * 2)
    model = build('tiny')
    object.__setattr__(model.config, 'dropout_rate', 0.1)
    with pytest.raises(ValueError, match='runs blocks deterministically'):
        pt_pipe.PipelinedLM(model, devices=['cpu'] * 2)
    with pytest.raises(ValueError, match='supports the GPT, Llama, '
                                         'Mixtral, and DeepSeek families'):
        pt_pipe.PipelinedLM(torch.nn.Linear(2, 2), devices=['cpu'] * 2)
    for kw, msg in (({'schedule': 'zigzag'}, 'style must be one of'),
                    ({'schedule': 'interleaved'},
                     'interleaved needs virtual_stages >= 2'),
                    ({'schedule': '1f1b', 'virtual_stages': 2},
                     'runs with virtual_stages == 1'),
                    ({'schedule': 'interleaved', 'virtual_stages': 2,
                      'num_microbatches': 3}, 'must be a multiple')):
        with pytest.raises(ValueError, match=msg):
            pt_pipe.PipelinedLM(build('tiny'), devices=['cpu'] * 2, **kw)
    with pytest.raises(ValueError, match='pipeline schedules need >= 2'):
        pt_pipe.PipelinedLM(build('tiny'), devices=['cpu'])


@pytest.mark.parametrize('data,M', [(1, 4), (2, 2), (2, 4)])
def test_microbatch_rows_are_the_references_sharding(data, M):
    """Data rank i's microbatch m: the rows the reference's
    reshape(M, d * mb, seq) with dim 1 over `data` gives device i."""
    batch = 8
    rows = np.arange(batch * 3).reshape(batch, 3)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=data),
                              devices=jax.devices()[:data])
    sharded = jax.device_put(
        jnp.asarray(rows.reshape(M, batch // M, 3)),
        jax.sharding.NamedSharding(mesh,
                                   jax.sharding.PartitionSpec(None, 'data')))
    by_device = {s.device: np.asarray(s.data)
                 for s in sharded.addressable_shards}
    for i, dev in enumerate(mesh.devices.reshape(-1)):
        got = np.stack([rows[r] for r in pt_pipe.microbatch_rows(
            batch, M, data, i)])
        np.testing.assert_array_equal(got, by_device[dev])


@pytest.mark.parametrize('restore_into', [(2, '1f1b', 1), (3, 'interleaved', 2)])
def test_checkpoint_is_the_one_card_file(restore_into, tmp_path):
    """A pipelined save is the one-card trainer's file of the same state
    byte for byte, and restores into another pipeline bit for bit."""
    tx = pt_train.default_optimizer(learning_rate=LR)
    pp = pt_pipe.PipelinedLM(build('tiny', vocab_size=501),
                             devices=['cpu'] * 2, num_microbatches=2,
                             schedule='gpipe')
    state = pp.init(tx)
    tokens = torch.from_numpy(tokens_for(501))
    step = pp.make_train_step(tx)
    for _ in range(2):
        state, _ = step(state, tokens)
    pt_ckpt.CheckpointManager(str(tmp_path / 'pp')).save(2, state)
    # The one-card trainer holding the merged state.
    merged = pp.merge_params([state.params[s] for s in range(2)])
    one = build('tiny', vocab_size=501)
    trainer = pt_train.ShardedTrainer(one, tx=tx)
    one_state = trainer.init()
    with torch.no_grad():
        for n, p in one.named_parameters():
            p.copy_(merged[n])
        for k in ('mu', 'nu'):
            pieces = [dict(zip(state.params[s], state.opt_state[s][k]))
                      for s in range(2)]
            whole = pp.merge_params(pieces)
            for m, n in zip(one_state.opt_state[k], pp.names):
                m.copy_(whole[n])
        one_state.opt_state['count'].fill_(2)
    one_state.step = 2
    pt_ckpt.CheckpointManager(str(tmp_path / 'one')).save(2, one_state)
    assert filecmp.cmp(tmp_path / 'pp' / '2' / 'state.pt',
                       tmp_path / 'one' / '2' / 'state.pt', shallow=False)
    stages, style, v = restore_into
    fresh = pt_pipe.PipelinedLM(build('tiny', vocab_size=501),
                                devices=['cpu'] * stages,
                                num_microbatches=stages * 2,
                                schedule=style, virtual_stages=v)
    restored = pt_ckpt.CheckpointManager(str(tmp_path / 'pp')).restore(
        fresh.init(tx))
    assert restored.step == 2 and fresh.count(restored) == 2
    got = fresh.merge_params([restored.params[s] for s in range(stages)])
    for n, p in merged.items():
        assert torch.equal(got[n], p), n
    pt_ckpt.CheckpointManager(str(tmp_path / 'again')).save(2, restored)
    assert filecmp.cmp(tmp_path / 'pp' / '2' / 'state.pt',
                       tmp_path / 'again' / '2' / 'state.pt', shallow=False)


@pytest.mark.parametrize('devices', [['cpu', 'cpu'], ['cpu', 'cpu', 'cpu']])
def test_replicated_copies_stay_equal_under_clipping(devices):
    """Every stage's copy of a replicated leaf (the final norm, GPT's
    wpe) takes the same clipped update: after steps whose norm is far
    past grad_clip the copies are equal bit for bit."""
    tx = pt_train.default_optimizer(learning_rate=LR, grad_clip=1e-3)
    pp = pt_pipe.PipelinedLM(build('tiny', vocab_size=501),
                             devices=devices, num_microbatches=4,
                             schedule='1f1b')
    state = pp.init(tx)
    step = pp.make_train_step(tx, collect_grad_norm=True)
    for seed in range(2):
        state, (_, gnorm) = step(state, torch.from_numpy(
            tokens_for(501, seed)))
        assert gnorm.item() > 1.0
    for name in ('ln_f.scale', 'ln_f.bias', 'wpe'):
        copies = [state.params[s][name] for s in range(len(devices))]
        assert not torch.equal(copies[0], build(
            'tiny', vocab_size=501).state_dict()[name]), name
        for c in copies[1:]:
            assert torch.equal(c, copies[0]), name


def test_within_stage_layout_is_the_references():
    """The reference's v2 layout on MeshConfig(stage=2, tensor=2,
    data=2) (its `param_shardings`, tests/unit_tests/test_pipeline.py's
    tensor-within-stages mesh): each block leaf the reference puts on
    `tensor` is the leaf the port's stages split over their tensor
    shards, on the same dim (the port's [out, in] projections are the
    reference's [in, out] kernels transposed), and the vocab tables
    split over `stage` alone in both."""
    jmodel, _, _ = _build_model('llama-tiny', SEQ, False)
    jmodel = type(jmodel)(dataclasses.replace(jmodel.config,
                                              dtype=jnp.float32))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(stage=2, tensor=2, data=2),
                              devices=jax.devices()[:8])
    ref = jax_pipe.PipelinedLM(jmodel, mesh, num_microbatches=4)
    port = build('llama-tiny')
    tree = jax.tree.map(jnp.asarray, convert.train_params_to_jax(port))
    stacked, rest = ref.split_params(tree)
    s_stacked, s_rest = ref.param_shardings(stacked, rest)
    pp = pt_pipe.PipelinedLM(port, devices=[['cpu', 'cpu']] * 2,
                             num_microbatches=4)
    ref_dims = {}
    for path, sharding in jax.tree_util.tree_leaves_with_path(s_stacked):
        keys = [p.key for p in path]
        spec = list(sharding.spec)[1:]          # past the stacked dim
        assert sharding.spec[0] == 'stage', keys
        dims = [d for d, e in enumerate(spec)
                if e == 'tensor' or (isinstance(e, tuple) and 'tensor' in e)]
        name = '.'.join(keys[:-1] + ['weight' if keys[-1] == 'kernel'
                                     else keys[-1]])
        if keys[-1] == 'kernel' and dims:       # [in, out] -> [out, in]
            dims = [1 - dims[0]]
        ref_dims[name] = dims[0] if dims else None
    got = {n: a for n, a in pp.block_axes.items() if a != 'sum'}
    assert ref_dims == {n: got.get(n) for n in ref_dims}, (ref_dims, got)
    for table in ('tok_embed', 'lm_head'):
        spec = str(s_rest[table].spec)
        assert 'stage' in spec and 'tensor' not in spec, spec
        assert pp._split(table) == (None, False)
