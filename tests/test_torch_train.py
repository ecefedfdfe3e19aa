"""Port's training path (skypilot_tpu_torch/parallel/train.py,
checkpoints.py, ckpt_integrity.py, data/token_loader.py,
recipes/train_lm.py, the Llama training mode) against the JAX package,
CPU, f32:

  - trainer parity on llama-tiny and qwen-tiny from the same params and
    tokens: step-1 loss within 1e-5 and grads within 1e-5 (f32 sums in
    another order), through the fused LM-head loss and through the full
    logits, the loss of each of 5 steps of
    default_optimizer(warmup 10) within 1e-5, params after 5 steps
    within 1e-5 for 99.9% of elements and within 5e-4 (5% of one
    step's lr) for all: Adam's update m / (sqrt(v) + eps) is a ratio,
    and where a grad is as small as the f32 noise of its sum the ratio
    differs between two summation orders; step 1 (lr = 0) leaves every
    param bit-identical;
  - LoRA mode: the base stays bit-identical and the factors after 5
    steps match the JAX trainer's within 1e-5;
  - remat gives the same loss and grads;
  - checkpoints: save at step 3, restore, continue: bit-identical to an
    uninterrupted run; a flipped byte in the newest step makes restore
    fall back, and the reference's ckpt_integrity.preflight names the
    same step; max_to_keep prunes steps and manifests; the port's
    manifest equals the reference's;
  - the token loader's batches equal the reference's numpy path;
  - `train_lm --cpu` runs, writes metrics, resumes; `--lora` writes an
    adapter the reference's lora.load_adapter reads and the port's
    AdapterRegistry serves; refused flags and model families exit
    naming themselves; MFU's N leaves the embedding table out;
  - serving's parameter storage is unchanged by the training layout;
  - whole-prompt prefill of a 2100-token prompt (prefill_chunk=0) on
    llama-tiny with its context grown gives the reference engine's
    greedy tokens, through the flash route's plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.data.token_loader import TokenLoader as JaxTokenLoader
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.parallel import ckpt_integrity as jax_integrity
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import train as jax_train
from skypilot_tpu.recipes.train_lm import _build_model
from skypilot_tpu_torch.data.token_loader import TokenLoader
from skypilot_tpu_torch.errors import CheckpointCorruptionError
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import lora as pt_lora
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.observability import step_metrics
from skypilot_tpu_torch.ops import flash_kernel
from skypilot_tpu_torch.parallel import checkpoints as pt_ckpt
from skypilot_tpu_torch.parallel import ckpt_integrity
from skypilot_tpu_torch.parallel import train as pt_train
from skypilot_tpu_torch.recipes import train_lm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
PARAM_TOL = 5e-4
LR = 1e-2
STEPS = 5
BATCH, SEQ = 2, 24
SPEC = (4, 8.0)     # LoRA rank, alpha


def port_config(jax_cfg) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling', 'remat')}
    return pt_llama.LlamaConfig(dtype=torch.float32,
                                param_dtype=torch.float32, **vals)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def tokens_for(step, vocab):
    return np.random.default_rng(100 + step).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int32)


def run_jax(name, lora=None):
    """JAX ShardedTrainer on a one-device mesh: (config, initial params,
    step-1 loss and grads, per-step losses, params after STEPS)."""
    model, _, _ = _build_model(name, SEQ, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32)
    model = jax_llama.Llama(cfg)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    spec = None if lora is None else jax_lora.LoraSpec(rank=lora[0],
                                                       alpha=lora[1])
    trainer = jax_train.ShardedTrainer(
        model, mesh, tx=jax_train.default_optimizer(
            learning_rate=LR, warmup_steps=10, total_steps=20), lora=spec)
    example = jnp.zeros((BATCH, SEQ), jnp.int32)
    state = trainer.init(jax.random.PRNGKey(0), example)
    init = to_numpy(jax.device_get(state.params))
    tok0 = jnp.asarray(tokens_for(0, cfg.vocab_size))
    with mesh:
        loss0, grads0 = jax.value_and_grad(trainer._compute_loss)(
            state.params, tok0)
    step = trainer.make_train_step(example, donate=False)
    losses = []
    for i in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens_for(i,
                                                         cfg.vocab_size)))
        losses.append(float(loss))
    return (cfg, init, float(loss0), to_numpy(grads0), losses,
            to_numpy(jax.device_get(state.params)))


def port_trainer(cfg, init, lora=None, **kw):
    model = convert.train_params_from_jax(init['base'] if lora else init,
                                          port_config(cfg), device='cpu')
    spec = None if lora is None else pt_lora.LoraSpec(rank=lora[0],
                                                      alpha=lora[1])
    trainer = pt_train.ShardedTrainer(
        model, tx=pt_train.default_optimizer(learning_rate=LR,
                                             warmup_steps=10,
                                             total_steps=20),
        lora=spec, **kw)
    lora_params = (convert.lora_train_params_from_jax(init['lora'])
                   if lora else None)
    return model, trainer, trainer.init(lora_params=lora_params)


def grads_as_jax(model, state, trainer, tokens):
    """Step-1 loss and grads under the reference's names."""
    leaves = pt_train.trainable_leaves(state.params)
    loss = trainer._compute_loss(state.params, tokens)
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in model.named_parameters()]
    shadow = convert.assemble(model.config, dict(zip(names, grads)))
    return loss.item(), convert.train_params_to_jax(shadow)


def assert_trees_close(got, want, tol=TOL):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, want_leaf in flat_want.items():
        np.testing.assert_allclose(flat_got[path], want_leaf, atol=tol,
                                   rtol=tol, err_msg=str(path))


def assert_params_close(got, want):
    """Params after Adam steps (see the module doc for the bounds)."""
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


@pytest.fixture(scope='module', params=['llama-tiny', 'qwen-tiny'])
def full(request):
    return run_jax(request.param)


@pytest.mark.parametrize('fused', [None, False], ids=['fused', 'logits'])
def test_step1_loss_and_grads_match(full, fused):
    cfg, init, loss0, grads0, _, _ = full
    model, trainer, state = port_trainer(cfg, init, fused_xent=fused)
    assert trainer.fused_xent is (fused is None)
    loss, grads = grads_as_jax(model, state, trainer, torch.from_numpy(
        tokens_for(0, cfg.vocab_size)).long())
    np.testing.assert_allclose(loss, loss0, atol=TOL, rtol=TOL)
    assert_trees_close(grads, grads0)


def test_five_steps_match(full):
    cfg, init, _, _, losses, final = full
    model, trainer, state = port_trainer(cfg, init)
    step = trainer.make_train_step()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = []
    for i in range(STEPS):
        state, loss = step(state, torch.from_numpy(
            tokens_for(i, cfg.vocab_size)).long())
        got.append(loss.item())
        if i == 0:    # lr(count 0) = 0: nothing moves, bit for bit
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
    assert state.step == STEPS and state.opt_state['count'] == STEPS
    np.testing.assert_allclose(got, losses, atol=TOL, rtol=TOL)
    assert_params_close(convert.train_params_to_jax(model), final)


@pytest.fixture(scope='module')
def lora_run():
    return run_jax('llama-tiny', lora=SPEC)


def test_lora_trainer_matches(lora_run):
    cfg, init, _, _, losses, final = lora_run
    model, trainer, state = port_trainer(cfg, init, lora=SPEC)
    base0 = convert.train_params_to_jax(model)
    assert len(state.opt_state['mu']) == 2 * 4 * cfg.num_layers
    step = trainer.make_train_step()
    got = []
    for i in range(STEPS):
        state, loss = step(state, torch.from_numpy(
            tokens_for(i, cfg.vocab_size)).long())
        got.append(loss.item())
    np.testing.assert_allclose(got, losses, atol=TOL, rtol=TOL)
    base = convert.train_params_to_jax(model)
    jax.tree.map(np.testing.assert_array_equal, base, base0)
    assert_params_close(convert.lora_params_to_numpy(state.params['lora']),
                        final['lora'])
    assert all(np.abs(f['b']).max() > 0 for layer in final['lora'].values()
               for f in layer.values())


def test_remat_matches(full):
    cfg, init, loss0, grads0, _, _ = full
    model = convert.train_params_from_jax(
        init, dataclasses.replace(port_config(cfg), remat=True))
    trainer = pt_train.ShardedTrainer(model)
    state = trainer.init()
    loss, grads = grads_as_jax(model, state, trainer, torch.from_numpy(
        tokens_for(0, cfg.vocab_size)).long())
    np.testing.assert_allclose(loss, loss0, atol=TOL, rtol=TOL)
    assert_trees_close(grads, grads0)


def test_optimizer_schedule_matches_optax():
    sched = pt_train.WarmupCosineSchedule(0.0, 3e-4, 10, 37)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 37)
    for count in (0, 1, 5, 9, 10, 11, 20, 36, 37, 50):
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    assert pt_train.default_optimizer(warmup_steps=10).lr(0) == 0.0
    assert pt_train.default_optimizer(learning_rate=0.5).lr(7) == 0.5


def test_clip_matches_optax_without_epsilon():
    g = [torch.tensor([3.0, 4.0])]       # norm 5
    p = [torch.zeros(2)]
    opt = pt_train.ClippedAdamW(1.0, weight_decay=0.0, grad_clip=5.0)
    state = opt.init(p)
    norm = opt.update(p, [g[0].clone()], state)
    assert norm.item() == 5.0
    # |g| == max_norm clips (optax: g < max keeps, else (g/|g|) * max).
    np.testing.assert_allclose(state['mu'][0].numpy(), [0.3, 0.4],
                               rtol=1e-6)


# -- checkpoints ------------------------------------------------------------
def tiny_trainer(seed=0, lora=None):
    cfg = dataclasses.replace(registry.train_config('llama-tiny', 64),
                              dtype=torch.float32)
    model = convert.init_params(cfg, seed=seed, device='cpu')
    spec = None if lora is None else pt_lora.LoraSpec(*lora)
    trainer = pt_train.ShardedTrainer(
        model, tx=pt_train.default_optimizer(learning_rate=LR,
                                             warmup_steps=2,
                                             total_steps=20), lora=spec)
    return model, trainer, trainer.init(seed=3)


def run_steps(trainer, state, steps):
    step = trainer.make_train_step()
    for i in steps:
        state, _ = step(state, torch.from_numpy(tokens_for(i, 512)).long())
    return state


def snapshot(state):
    leaves = pt_train.trainable_leaves(state.params)
    return [t.detach().clone() for t in
            leaves + state.opt_state['mu'] + state.opt_state['nu']]


@pytest.mark.parametrize('lora', [None, (4, 8.0)], ids=['full', 'lora'])
def test_checkpoint_resume_is_bit_identical(tmp_path, lora):
    _, trainer, state = tiny_trainer(lora=lora)
    want = snapshot(run_steps(trainer, state, range(5)))

    _, trainer, state = tiny_trainer(lora=lora)
    state = run_steps(trainer, state, range(3))
    mgr = pt_ckpt.CheckpointManager(str(tmp_path), base_source='tiny')
    assert mgr.save(3, state)
    assert not mgr.save(3, state)        # an existing step is skipped
    _, trainer, fresh = tiny_trainer(lora=lora)
    fresh = pt_ckpt.CheckpointManager(str(tmp_path),
                                      base_source='tiny').restore(fresh)
    assert fresh.step == 3 and fresh.opt_state['count'] == 3
    got = snapshot(run_steps(trainer, fresh, range(3, 5)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_corrupt_newest_step_falls_back_and_preflight_agrees(tmp_path):
    _, trainer, state = tiny_trainer()
    mgr = pt_ckpt.CheckpointManager(str(tmp_path))
    state = run_steps(trainer, state, range(1))
    mgr.save(1, state)
    state = run_steps(trainer, state, range(1, 2))
    mgr.save(2, state)
    path = tmp_path / '2' / pt_ckpt.STATE_FILE
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptionError):
        mgr.verify_step(2)
    _, _, fresh = tiny_trainer()
    mgr.restore(fresh)
    assert mgr.last_restored_step == 1 and fresh.step == 1
    report = jax_integrity.preflight(str(tmp_path))
    assert report['newest_verifying'] == 1
    assert report['corrupt_steps'] == [2]
    assert ckpt_integrity.preflight(str(tmp_path)) == report


def test_max_to_keep_prunes_steps_and_manifests(tmp_path):
    _, trainer, state = tiny_trainer()
    mgr = pt_ckpt.CheckpointManager(str(tmp_path), save_interval_steps=2)
    for step in range(1, 9):
        mgr.save(step, state)
    assert mgr.all_steps() == [4, 6, 8]
    assert ckpt_integrity.manifest_steps(str(tmp_path)) == [4, 6, 8]
    assert mgr.save(9, state, force=True)
    assert mgr.all_steps() == [6, 8, 9]
    assert jax_integrity.manifest_steps(str(tmp_path)) == [6, 8, 9]
    assert jax_integrity.verify_step(str(tmp_path), 9)


def test_integrity_copy_matches_reference(tmp_path):
    (tmp_path / '5').mkdir()
    (tmp_path / '5' / 'a.bin').write_bytes(b'abc' * 1000)
    (tmp_path / '5' / 'sub').mkdir()
    (tmp_path / '5' / 'sub' / 'b').write_bytes(b'x')
    assert (ckpt_integrity.compute_manifest(str(tmp_path / '5'), 5)
            == jax_integrity.compute_manifest(str(tmp_path / '5'), 5))
    ckpt_integrity.write_manifest(str(tmp_path), 5)
    assert jax_integrity.verify_step(str(tmp_path), 5)
    (tmp_path / '5' / 'sub' / 'b').write_bytes(b'y')
    with pytest.raises(CheckpointCorruptionError):
        ckpt_integrity.verify_step(str(tmp_path), 5)


def test_remote_checkpoint_dir_refused():
    with pytest.raises(ValueError, match='gs://'):
        pt_ckpt.CheckpointManager('gs://bucket/ckpt')


# -- data -------------------------------------------------------------------
@pytest.mark.parametrize('shuffle,rank,world', [(True, 0, 1), (True, 1, 2),
                                                (False, 1, 2)])
def test_token_loader_matches_reference_numpy_path(tmp_path, shuffle, rank,
                                                   world):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((700, 1300)):
        p = tmp_path / f'shard{i}.bin'
        rng.integers(0, 60000, n).astype(np.uint16).tofile(p)
        paths.append(str(p))
    kw = dict(batch=3, seq=64, seed=5, rank=rank, world=world,
              shuffle=shuffle)
    ref = JaxTokenLoader(paths, use_native=False, **kw)
    port = TokenLoader(paths, **kw)
    for _ in range(4):
        np.testing.assert_array_equal(port.next_batch(), ref.next_batch())


# -- train_lm ---------------------------------------------------------------
def run_train_lm(*argv, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm',
         '--cpu', '--model', 'llama-tiny', '--seq', '32',
         '--global-batch', '2', *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_train_lm_runs_writes_metrics_and_resumes(tmp_path):
    ckpt, metrics = tmp_path / 'ckpt', tmp_path / 'm.jsonl'
    out = run_train_lm('--steps', '4', '--log-every', '2', '--ckpt-dir',
                       str(ckpt), '--ckpt-every', '2', '--metrics-file',
                       str(metrics))
    assert out.returncode == 0, out.stderr
    assert 'step 4/4 loss=' in out.stdout and 'training done' in out.stdout
    records = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [r['step'] for r in records] == [2, 4]
    assert all(np.isfinite(r['loss']) and r['grad_norm'] > 0
               and r['mfu'] is None for r in records)
    assert sorted(os.listdir(ckpt)) == ['2', '4', 'manifest-2.json',
                                        'manifest-4.json']
    again = run_train_lm('--steps', '6', '--log-every', '2', '--ckpt-dir',
                         str(ckpt), '--ckpt-every', '2')
    assert again.returncode == 0, again.stderr
    assert 'resumed from checkpoint step 4' in again.stdout
    assert 'step 2/6' not in again.stdout and 'step 6/6' in again.stdout


def test_mfu_leaves_the_embedding_lookup_out(tmp_path):
    cfg = registry.train_config('llama-tiny', 64)
    model = convert.init_params(cfg, seed=0, device='cpu')
    total = sum(p.numel() for p in model.parameters())
    n = step_metrics.matmul_params(model.named_parameters())
    assert n == total - cfg.vocab_size * cfg.embed_dim
    assert model.lm_head.numel() == cfg.vocab_size * cfg.embed_dim
    metrics = step_metrics.StepMetrics(str(tmp_path / 'm.jsonl'), n_params=n,
                                       peak_flops=1e12)
    record = metrics.log(1, step_time_s=0.5, tokens=1000, loss=1.0)
    metrics.close()
    assert record['mfu'] == round(6.0 * n * 2000 / 1e12, 4)


def test_train_lm_lora_adapter_loads_in_both_packages(tmp_path):
    out_dir = tmp_path / 'adapters' / 'tuned'
    out = run_train_lm('--steps', '3', '--log-every', '1', '--lora', '4',
                       '--lora-alpha', '8', '--adapter-out', str(out_dir))
    assert out.returncode == 0, out.stderr
    assert f'adapter artifact -> {out_dir}' in out.stdout
    config, params = jax_lora.load_adapter(str(out_dir))
    assert config['rank'] == 4 and config['step'] == 3
    assert set(params) == {'layer_0', 'layer_1'}
    assert params['layer_0']['wq']['a'].shape == (128, 4)
    base = convert.init_params(registry.model_config('llama-tiny', 64),
                               seed=0, device='cpu')
    engine = pt_batching.ContinuousBatchingEngine(
        base, num_slots=2, max_total_len=64, prefill_chunk=16,
        adapter_store=AdapterRegistry(str(out_dir.parent), base,
                                      max_adapters=1))
    try:
        got = engine.submit(list(range(2, 14)), max_new_tokens=4,
                            adapter='tuned').result(timeout=120)
    finally:
        engine.stop()
    assert len(got) == 16 and got[:12] == list(range(2, 14))


@pytest.mark.parametrize('argv,name', [
    (['--zero1'], '--zero1'),
    (['--guard'], '--guard'),
    (['--overlap'], '--overlap'),
    (['--tensor', '2'], '--tensor'),
    (['--pipeline-stages', '2'], '--pipeline-stages'),
    (['--microbatches', '4'], '--microbatches'),
    (['--ckpt-interval', 'auto'], '--ckpt-interval'),
    (['--init-from-hf', 'dir'], '--init-from-hf'),
    (['--profile', 'dir'], '--profile'),
    (['--trace-file', 't.json'], '--trace-file'),
    (['--model', 'gpt2-124m'], 'gpt2-124m'),
    (['--model', 'mixtral-tiny'], 'mixtral-tiny'),
    (['--model', 'deepseek-v2-lite'], 'deepseek-v2-lite'),
    (['--ckpt-dir', 's3://b/c'], 's3://b/c'),
])
def test_refused_flags_and_models_exit_naming_themselves(argv, name,
                                                         capsys):
    with pytest.raises(SystemExit) as exc:
        train_lm.parse_args(['--cpu'] + argv)
    assert exc.value.code != 0
    assert name in capsys.readouterr().err


def test_bare_recipe_refuses_the_reference_default_naming_a12(capsys):
    assert train_lm.build_parser().parse_args([]).model == 'gpt2-124m'
    with pytest.raises(SystemExit) as exc:
        train_lm.parse_args([])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert 'gpt2-124m' in err and 'ROADMAP A12' in err


def _add_argument_defaults(path):
    """{flag: default} of every `add_argument('--flag', ...)` call in a
    module's source: the literal default, False for store_true and None
    where no default is given."""
    import ast
    out = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, 'attr', '') == 'add_argument'
                and node.args and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith('--')):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if 'default' in kw:
            value = ast.literal_eval(kw['default'])
        else:
            action = kw.get('action')
            value = (action is not None
                     and ast.literal_eval(action) == 'store_true') or None
        out[node.args[0].value] = value
    return out


def test_recipe_defaults_agree_with_the_reference_flag_for_flag():
    root = Path(__file__).resolve().parents[1]
    ref = _add_argument_defaults(root / 'skypilot_tpu/recipes/train_lm.py')
    port = _add_argument_defaults(
        root / 'skypilot_tpu_torch/recipes/train_lm.py')
    shared = sorted(set(ref) & set(port))
    assert len(shared) == len(ref) >= 40    # every reference flag
    assert {f: port[f] for f in shared} == {f: ref[f] for f in shared}


def test_train_config_refuses_other_families():
    with pytest.raises(ValueError, match='A12'):
        registry.train_config('tiny', 64)


# -- model layouts ----------------------------------------------------------
def test_serving_parameter_storage_is_unchanged():
    cfg = registry.model_config('llama-tiny', 64)
    model = convert.init_params(cfg, seed=0, device='cpu')
    d, f, v, n = cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size, cfg.num_layers
    hd = cfg.head_dim
    dense = d * (cfg.num_heads * hd) * 2 + d * (cfg.num_kv_heads * hd) * 2 \
        + 3 * d * f
    want = v * d * 2 + n * (dense * 2 + 2 * d * 4) + d * 4 + v * d * 4
    got = sum(p.numel() * p.element_size() for p in model.parameters())
    assert got == want
    assert not any(p.requires_grad for p in model.parameters())
    assert model.layers[0].attn.wq.weight.dtype == torch.bfloat16
    train = convert.init_params(registry.train_config('llama-tiny', 64),
                                seed=0, device='cpu')
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    # The same seeded values, only stored wider.
    assert torch.equal(train.layers[1].mlp.w_up.weight.bfloat16(),
                       model.layers[1].mlp.w_up.weight)


# -- whole-prompt long prefill ----------------------------------------------
def test_long_whole_prompt_prefill_matches_reference(monkeypatch):
    seq, prompt_len = 2304, 2100
    jcfg = dataclasses.replace(
        _build_model('llama-tiny', seq, remat=False)[0].config,
        dtype=jnp.float32)
    model = jax_llama.Llama(jcfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    prompt = np.random.default_rng(9).integers(1, 512, prompt_len).tolist()
    kw = dict(num_slots=1, max_total_len=seq, prefill_chunk=0)
    ref_engine = jax_batching.ContinuousBatchingEngine(model, params, **kw)
    try:
        ref = ref_engine.submit(prompt, max_new_tokens=6).result(timeout=300)
    finally:
        ref_engine.stop()
    cfg = registry.model_config('llama-tiny', seq)
    assert cfg.max_seq_len == jcfg.max_seq_len
    assert cfg.kv_total_pages == jcfg.kv_total_pages
    port = convert.params_from_jax(
        to_numpy(params), dataclasses.replace(cfg, dtype=torch.float32))
    # On the card the dispatch sends >= 2048-token calls to the flash
    # kernels; here the flash route runs its plain version.
    from skypilot_tpu_torch.ops import attention as pt_attention
    plain = pt_attention.dot_product_attention
    monkeypatch.setattr(
        pt_llama.attention_ops, 'dot_product_attention',
        lambda q, k, v, causal=True: plain(
            q, k, v, causal=causal,
            impl='flash' if q.shape[1] >= 2048 else 'auto'))
    calls0 = flash_kernel.plain_calls
    engine = pt_batching.ContinuousBatchingEngine(port, **kw)
    try:
        got = engine.submit(prompt, max_new_tokens=6).result(timeout=300)
    finally:
        engine.stop()
    assert flash_kernel.plain_calls - calls0 == cfg.num_layers
    assert got == ref and len(got) == prompt_len + 6
