"""The port's Mixtral family (skypilot_tpu_torch/models/mixtral.py)
against the JAX reference (skypilot_tpu/models/mixtral.py) on the same
seeded weights, CPU, f32 (MixtralConfig.tiny: 2 layers, 4 heads, 2 KV
heads, 4 experts, top 2, vocab 512):

  - the weight bridge consumes every leaf and round-trips the training
    tree bit for bit; no-cache logits within 1e-5 and the aux loss
    within 1e-6;
  - the MoE layer where capacity binds (32 identical tokens: capacity 20
    of 32 assignments per expert) drops the reference's tokens and gives
    its outputs; a random chunk too; equal router probabilities pick the
    lower experts first, as jax.lax.top_k does;
  - paged decode == dense decode == the reference's dense decode;
  - the one-shot generate functions give the reference's greedy tokens,
    and the speculative one the reference's speculative tokens (capacity
    follows the chunk, so speculative != greedy for this family, in the
    reference as well);
  - the padded prefill chunk shapes (which set capacity) are the
    reference engine's at every length and offset;
  - the slot engine, pipelined and unpipelined (decode rounds drop
    nothing, so the two agree exactly), with --prefill-chunk, a partial
    last chunk and a prefix hit, gives the JAX engine's tokens; so does
    --speculative 4 against the JAX engine's speculative run;
  - ShardedTrainer: step-1 loss (CE + router aux) and gradients through
    the fused and the logits path, 5 steps, and remat == none;
  - train_lm --model mixtral-tiny writes metrics and resumes; serve_lm
    --model mixtral-tiny answers /generate; the KV-pool flags and
    --adapter-dir are refused with the reference's reasons (int8
    weights are served: tests/test_torch_quant.py);
  - --hf: a tiny MixtralForCausalLM written by transformers loads into
    both packages (capacity_factor E / K: nothing dropped) with the same
    logits, and transformers' own within 1e-5.
"""
import dataclasses
import json
import threading
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import hf_import as jax_hf
from skypilot_tpu.models import mixtral as jax_mixtral
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import train as jax_train
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import generate as pt_gen
from skypilot_tpu_torch.models import hf_import
from skypilot_tpu_torch.models import mixtral as pt_mixtral
from skypilot_tpu_torch.models.llama import DenseKVCache, PagedKVCache
from skypilot_tpu_torch.parallel import train as pt_train
from skypilot_tpu_torch.recipes import serve_lm, train_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
AUX_TOL = 1e-6
PAGED = dict(kv_page_size=8, kv_total_pages=40)
ENGINE_KW = dict(num_slots=2, max_total_len=64, prefill_chunk=16)
LR = 1e-2
BATCH, SEQ = 2, 24


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_config(jax_cfg, **kw) -> pt_mixtral.MixtralConfig:
    fields = {f.name for f in dataclasses.fields(pt_mixtral.MixtralConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'logits_dtype',
                                         'rope_scaling')}
    vals.update(dtype=torch.float32, **kw)
    return pt_mixtral.MixtralConfig(**vals)


def _init(model):
    return nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])


@pytest.fixture(scope='module')
def pair():
    """(JAX model, params, port model in serving's layout), f32."""
    cfg = jax_mixtral.MixtralConfig.tiny(dtype=jnp.float32, **PAGED)
    model = jax_mixtral.Mixtral(cfg)
    params = _init(model)
    port = convert.params_from_jax(to_numpy(params), port_config(cfg))
    return model, params, port


def _prompts():
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 512, 16).tolist()
    loop = [5, 9, 2, 17, 5, 9, 2, 17, 5, 9, 2]
    return [shared + rng.integers(1, 512, 9).tolist(),   # 25: chunk 16 + 9
            loop + rng.integers(1, 512, 12).tolist(),
            shared + rng.integers(1, 512, 20).tolist()]  # a prefix hit


MAX_NEW = (6, 14, 10)


def _run(engine):
    futs = [engine.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), MAX_NEW)]
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        engine.stop()


def test_bridge_consumes_every_leaf_and_round_trips(pair):
    _, params, port = pair
    tree = to_numpy(params)
    assert sum(x.size for x in jax.tree.leaves(tree)) == \
        sum(p.numel() for p in port.parameters())
    assert port.layers[0].moe.router.dtype == torch.float32
    trained = convert.train_params_from_jax(tree, port.config)
    back = convert.train_params_to_jax(trained)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    with pytest.raises(ValueError, match='stray'):
        convert.params_from_jax(dict(tree, stray=np.zeros(3, np.float32)),
                                port.config)


def test_no_cache_logits_and_aux_loss_match(pair):
    model, params, port = pair
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24), np.int32)
    ref, ref_aux = model.apply({'params': params}, jnp.asarray(tokens))
    with torch.no_grad():
        out, aux = port(torch.from_numpy(tokens).long())
        hidden, aux_h = port(torch.from_numpy(tokens).long(),
                             return_hidden=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=AUX_TOL,
                               rtol=0)
    assert float(aux_h) == float(aux)
    assert torch.equal(port.logits(hidden), out)


def _moe_pair(pair, **cfg_kw):
    """(JAX MoE layer, its params, the port's layer 0 MoE) of the tiny
    model, optionally with other config fields."""
    _, params, port = pair
    jcfg = jax_mixtral.MixtralConfig.tiny(dtype=jnp.float32, **cfg_kw)
    moe = jax_mixtral.MoEFeedForward(jcfg)
    layer = pt_mixtral.MoEFeedForward(port_config(jcfg))
    layer.load_state_dict(port.layers[0].moe.state_dict())
    return moe, params['layer_0']['moe'], layer


def test_dropped_tokens_and_outputs_match_where_capacity_binds(pair):
    moe, mparams, layer = _moe_pair(pair)
    rng = np.random.default_rng(4)
    # 32 identical tokens route alike: each of their two experts gets 32
    # assignments for a capacity of int(1.25 * 32 * 2 / 4) = 20.
    x = np.repeat(rng.standard_normal((1, 1, 128)), 32, axis=1)
    x = np.concatenate([x, rng.standard_normal((1, 32, 128))]).astype(
        np.float32)
    ref, ref_aux = moe.apply({'params': mparams}, jnp.asarray(x))
    with torch.no_grad():
        out, aux = layer(torch.from_numpy(x), with_aux=True)
        _, _, picks, _ = layer.route(torch.from_numpy(x))
        dispatch = layer.route(torch.from_numpy(x))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=AUX_TOL)
    capacity = int(1.25 * 32 * 2 / 4)
    assert dispatch.shape[-1] == capacity
    kept = dispatch.sum(dim=(-1, -2))            # assignments kept a token
    assert kept[0, :capacity].tolist() == [2.0] * capacity
    assert kept[0, capacity:].tolist() == [0.0] * (32 - capacity)
    # A dropped token gets nothing from either expert, as in the reference.
    assert np.all(np.asarray(ref)[0, capacity:] == 0)
    assert torch.all(out[0, capacity:] == 0)
    assert picks[1].sum() == 32 * 2 and kept[1].sum() <= 32 * 2


def test_equal_router_probabilities_pick_lower_experts_first(pair):
    moe, mparams, layer = _moe_pair(pair)
    mparams = dict(mparams, router={'kernel': np.zeros((128, 4),
                                                       np.float32)})
    with torch.no_grad():
        layer.router.zero_()
    x = np.random.default_rng(6).standard_normal((2, 8, 128)).astype(
        np.float32)
    ref, _ = moe.apply({'params': mparams}, jnp.asarray(x))
    with torch.no_grad():
        out, _ = layer(torch.from_numpy(x))
        picks = layer.route(torch.from_numpy(x))[2]
    assert picks.sum(dim=(0, 1, 2)).tolist() == [16.0, 16.0, 0.0, 0.0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_paged_decode_matches_dense_and_reference(pair):
    """The counterpart of the reference's test_mixtral_paged_decode_
    matches_dense."""
    model, params, port = pair
    cfg = port.config
    pages = -(-32 // cfg.kv_page_size)
    table = np.asarray([[1 + i for i in range(pages)],
                        [1 + pages + i for i in range(pages)]], np.int32)
    jcache = jax.tree.map(jnp.zeros_like, nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
        positions=jnp.zeros((2, 1), jnp.int32), decode=True)['cache']))
    dense, paged = DenseKVCache(cfg, 2), PagedKVCache(cfg)
    rs = np.random.RandomState(1)
    for t in range(10):
        tok = rs.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2, 1), t, np.int32)
        ref, mut = model.apply({'params': params, 'cache': jcache},
                               jnp.asarray(tok), positions=jnp.asarray(pos),
                               decode=True, mutable=['cache'])
        jcache = mut['cache']
        with torch.no_grad():
            a = port(torch.from_numpy(tok).long(), torch.from_numpy(pos),
                     cache=dense).numpy()
            b = port(torch.from_numpy(tok).long(), torch.from_numpy(pos),
                     cache=paged, page_indices=torch.from_numpy(table)
                     ).numpy()
        np.testing.assert_allclose(a, np.asarray(ref), atol=TOL, rtol=TOL,
                                   err_msg=f'dense step {t}')
        np.testing.assert_allclose(b, np.asarray(ref), atol=TOL, rtol=TOL,
                                   err_msg=f'paged step {t}')


def test_one_shot_generate_matches_reference(pair):
    model, params, port = pair
    prompt = np.asarray([[5, 9, 2, 5, 9, 2, 5, 9],
                         [7, 3, 11, 42, 3, 3, 3, 3]], np.int32)
    want = np.asarray(jax_gen.make_generate_fn(model, 24)(
        params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    spec_want = np.asarray(jax_gen.make_speculative_generate_fn(
        model, 24, draft_k=4, ngram=2)(params, jnp.asarray(prompt),
                                       jax.random.PRNGKey(0)))
    got = pt_gen.make_generate_fn(port, 24)(torch.from_numpy(prompt))
    spec = pt_gen.make_speculative_generate_fn(port, 24, draft_k=4)(
        torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(spec.numpy(), spec_want)


@pytest.mark.parametrize('prefill_chunk,max_total_len,page', [
    (16, 64, 8), (0, 64, 8), (256, 1024, 16), (0, 1000, 16)])
def test_chunk_shapes_are_the_references(prefill_chunk, max_total_len,
                                         page):
    """Capacity follows the padded chunk length, so the port's padded
    prefill shapes must be the reference engine's at every (n, offset)."""
    import types
    lookahead = 4
    eng = types.SimpleNamespace(
        prefill_chunk=prefill_chunk, max_total_len=max_total_len,
        page_size=page, paged=True,
        pages_per_seq=-(-(max_total_len + lookahead) // page))
    cap = prefill_chunk or max_total_len
    for offset in range(0, max_total_len, 3):
        for n in range(1, min(cap, max_total_len - offset) + 1, 5):
            assert pt_batching.ContinuousBatchingEngine._chunk_shape(
                eng, n, offset) == \
                jax_batching.ContinuousBatchingEngine._chunk_shape(
                    eng, n, offset), (n, offset)


@pytest.fixture(scope='module')
def jax_engine_runs(pair):
    """The JAX engine's greedy tokens (pipelined, the default), then its
    --speculative 4 tokens."""
    model, params, _ = pair
    plain = _run(jax_batching.ContinuousBatchingEngine(model, params,
                                                       **ENGINE_KW))
    spec = _run(jax_batching.ContinuousBatchingEngine(
        model, params, speculative_k=4, **ENGINE_KW))
    return plain, spec


@pytest.mark.parametrize('pipelined', [None, False],
                         ids=['pipelined', 'unpipelined'])
def test_engine_matches_the_jax_engine(pair, jax_engine_runs, pipelined):
    _, _, port = pair
    engine = pt_batching.ContinuousBatchingEngine(
        port, pipeline_decode=pipelined, **ENGINE_KW)
    got = _run(engine)
    assert got == jax_engine_runs[0]
    assert engine.stats()['prefix_cache']['hits'] > 0


def test_speculative_engine_matches_the_jax_engine(pair, jax_engine_runs):
    _, _, port = pair
    got = _run(pt_batching.ContinuousBatchingEngine(port, speculative_k=4,
                                                    **ENGINE_KW))
    assert got == jax_engine_runs[1]


# -- training ---------------------------------------------------------------
def tokens_for(step):
    return np.random.default_rng(100 + step).integers(
        0, 512, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope='module')
def jax_training():
    """JAX ShardedTrainer (moe_next_token_loss) on one device: (config,
    initial params, step-1 loss and grads, per-step losses, final
    params)."""
    cfg = jax_mixtral.MixtralConfig.tiny(dtype=jnp.float32)
    model = jax_mixtral.Mixtral(cfg)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    trainer = jax_train.ShardedTrainer(
        model, mesh, loss_fn=jax_mixtral.moe_next_token_loss,
        tx=jax_train.default_optimizer(learning_rate=LR, warmup_steps=10,
                                       total_steps=20))
    example = jnp.zeros((BATCH, SEQ), jnp.int32)
    state = trainer.init(jax.random.PRNGKey(0), example)
    init = to_numpy(jax.device_get(state.params))
    with mesh:
        loss0, grads0 = jax.value_and_grad(trainer._compute_loss)(
            state.params, jnp.asarray(tokens_for(0)))
    step = trainer.make_train_step(example, donate=False)
    losses = []
    for i in range(5):
        state, loss = step(state, jnp.asarray(tokens_for(i)))
        losses.append(float(loss))
    return (cfg, init, float(loss0), to_numpy(grads0), losses,
            to_numpy(jax.device_get(state.params)))


def _port_trainer(cfg, init, **kw):
    model = convert.train_params_from_jax(init, port_config(cfg))
    trainer = pt_train.ShardedTrainer(
        model, loss_fn=pt_mixtral.moe_next_token_loss,
        tx=pt_train.default_optimizer(learning_rate=LR, warmup_steps=10,
                                      total_steps=20), **kw)
    return model, trainer, trainer.init()


def _grads(model, trainer, state, tokens):
    leaves = pt_train.trainable_leaves(state.params)
    loss = trainer._compute_loss(state.params, tokens)
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in model.named_parameters()]
    shadow = convert.assemble(model.config, dict(zip(names, grads)))
    return loss.item(), convert.train_params_to_jax(shadow)


def _assert_trees_close(got, want, tol=TOL):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        np.testing.assert_allclose(flat_got[path], leaf, atol=tol, rtol=tol,
                                   err_msg=str(path))


@pytest.mark.parametrize('fused', [None, False], ids=['fused', 'logits'])
def test_step1_loss_and_grads_match(jax_training, fused):
    cfg, init, loss0, grads0, _, _ = jax_training
    model, trainer, state = _port_trainer(cfg, init, fused_xent=fused)
    assert trainer.fused_xent is (fused is None)
    tokens = torch.from_numpy(tokens_for(0)).long()
    loss, grads = _grads(model, trainer, state, tokens)
    np.testing.assert_allclose(loss, loss0, atol=TOL, rtol=TOL)
    _assert_trees_close(grads, grads0)
    # The aux loss is in: the CE alone is smaller by it.
    with torch.no_grad():
        logits, aux = model(tokens)
    assert float(aux) > 0
    np.testing.assert_allclose(
        loss - float(pt_train.next_token_loss(logits, tokens)), float(aux),
        atol=TOL)


def test_five_steps_and_remat_match(jax_training):
    cfg, init, _, grads0, losses, final = jax_training
    model, trainer, state = _port_trainer(cfg, init)
    step = trainer.make_train_step()
    got = [step(state, torch.from_numpy(tokens_for(i)).long())[1].item()
           for i in range(5)]
    np.testing.assert_allclose(got, losses, atol=TOL, rtol=TOL)
    _assert_trees_close(convert.train_params_to_jax(model), final, tol=5e-4)
    remat = convert.train_params_from_jax(init,
                                          port_config(cfg, remat=True))
    trainer = pt_train.ShardedTrainer(
        remat, loss_fn=pt_mixtral.moe_next_token_loss)
    _, grads = _grads(remat, trainer, trainer.init(),
                      torch.from_numpy(tokens_for(0)).long())
    _assert_trees_close(grads, grads0)


def test_train_lm_writes_metrics_and_resumes(tmp_path, capsys):
    argv = ['--cpu', '--model', 'mixtral-tiny', '--seq', '32',
            '--global-batch', '2', '--log-every', '2', '--ckpt-dir',
            str(tmp_path / 'ck'), '--ckpt-every', '2', '--metrics-file',
            str(tmp_path / 'm.jsonl')]
    train_lm.main(argv + ['--steps', '2'])
    assert 'step 2/2 loss=' in capsys.readouterr().out
    train_lm.main(argv + ['--steps', '4'])
    out = capsys.readouterr().out
    assert 'resumed from checkpoint step 2' in out and 'step 4/4' in out
    records = [json.loads(line) for line in
               (tmp_path / 'm.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [2, 4]
    assert all(np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])
               for r in records)


# -- serving ----------------------------------------------------------------
def test_serve_lm_answers_generate():
    rt = build_runtime(serve_lm.parse_args(
        ['--cpu', '--model', 'mixtral-tiny', '--continuous-batching',
         '--max-total-len', '64']))
    server = make_server(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        prompt = _prompts()[1]
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.server_address[1]}/generate',
            data=json.dumps({'tokens': [prompt],
                             'max_new_tokens': 8}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())['tokens'][0]
        assert len(got) == len(prompt) + 8 and got[:len(prompt)] == prompt
        with urllib.request.urlopen(
                f'http://127.0.0.1:{server.server_address[1]}/stats',
                timeout=60) as resp:
            stats = json.loads(resp.read())
        assert stats['model'] == 'mixtral-tiny'
        state = rt.model.state_dict().values()
        assert {k: stats['storage'][k] for k in
                ('kv_dtype', 'weight_dtype', 'weight_bytes')} == {
            'kv_dtype': 'bf16', 'weight_dtype': 'bf16',
            'weight_bytes': sum(t.numel() * t.element_size()
                                for t in state)}
    finally:
        server.shutdown()
        rt.stop()


@pytest.mark.parametrize('flags,reason', [
    (['--kv-pool-bytes', '1000000'], 'MixtralConfig has none'),
    (['--kv-dtype', 'int8'], 'MixtralConfig has none'),
    (['--adapter-dir', '{tmp}'], 'Mixtral has no LoRA forward path'),
])
def test_serve_lm_refusals_name_their_reason(flags, reason, tmp_path):
    argv = ['--cpu', '--model', 'mixtral-tiny', '--continuous-batching',
            '--max-total-len', '64'] + [f.format(tmp=tmp_path)
                                        for f in flags]
    with pytest.raises((SystemExit, ValueError), match=reason):
        build_runtime(serve_lm.parse_args(argv))


# -- HF checkpoints ---------------------------------------------------------
def test_hf_mixtral_loads_as_the_reference_and_transformers(tmp_path):
    import transformers
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64)).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, port = hf_import.load_hf_checkpoint(str(tmp_path),
                                             dtype=torch.float32)
    assert isinstance(port, pt_mixtral.Mixtral)
    assert cfg.capacity_factor == 2.0
    jmodel, jparams = jax_hf.load_hf_checkpoint(str(tmp_path),
                                                dtype=jnp.float32)
    bridged = convert.params_from_jax(to_numpy(jparams), cfg)
    for (name, a), (_, b) in zip(port.state_dict().items(),
                                 bridged.state_dict().items()):
        assert torch.equal(a, b), name
    tokens = np.random.default_rng(2).integers(0, 128, (2, 20), np.int32)
    with torch.no_grad():
        ours = port(torch.from_numpy(tokens).long())[0].numpy()
        theirs = hf(torch.from_numpy(tokens).long()).logits.numpy()
    ref = np.asarray(jmodel.apply({'params': jparams},
                                  jnp.asarray(tokens))[0])
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
