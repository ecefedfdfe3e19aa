"""The port's DeepSeek family (skypilot_tpu_torch/models/deepseek.py)
against the JAX reference (skypilot_tpu/models/deepseek.py) on the same
seeded weights, CPU, f32 (DeepseekConfig.tiny: 2 layers, 4 heads,
kv_lora_rank 32, rope 16, nope 32, v 32, vocab 512):

  - the weight bridge consumes every leaf and round-trips the training
    tree bit for bit; no-cache logits within 1e-5, with q_lora_rank 0
    and 24;
  - `_unequal_dims_attention` (GQA, causal and not) within 1e-6 of the
    reference's, and `dot_product_attention(q192, k192, v128,
    impl='flash')` takes that route instead of the flash kernels;
  - the absorbed decode reproduces the full forward token for token and
    gives the reference's greedy tokens; the prefill fast path gives the
    general chunked path's logits and latent-cache contents;
  - the one-shot engine and its speculative variant give the
    reference's `make_generate_fn` / `make_speculative_generate_fn`
    tokens;
  - ShardedTrainer: step-1 loss and gradients through the fused and the
    logits path, five steps, and remat == none, against the reference's;
    train_lm --model deepseek-tiny writes metrics and resumes;
  - serve_lm --model deepseek-tiny answers /generate on the dense slot
    path; --adapter-dir, --kv-dtype int8 and --kv-pool-bytes exit naming
    their reason; /stats has the reference replica's key set;
  - --hf: a tiny DeepseekV2ForCausalLM written by transformers (dense
    MLP layers, q_lora_rank None and 24) loads into both packages with
    the same logits; a checkpoint with routed experts is refused before
    any weight is read.
The slot engine's modes are pinned in tests/test_torch_dense_engine.py,
int8 weights in tests/test_torch_quant.py.
"""
import dataclasses
import json
import os
import threading
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import http_server as jax_http
from skypilot_tpu.inference import runtime as jax_runtime
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import deepseek as jax_ds
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import hf_import as jax_hf
from skypilot_tpu.observability import metrics as ref_metrics
from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import train as jax_train
from skypilot_tpu_torch.inference import http_server as pt_http
from skypilot_tpu_torch.inference import runtime as pt_runtime
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import deepseek as pt_ds
from skypilot_tpu_torch.models import generate as pt_gen
from skypilot_tpu_torch.models import hf_import
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.ops import attention as pt_attention
from skypilot_tpu_torch.ops import flash_kernel
from skypilot_tpu_torch.parallel import train as pt_train
from skypilot_tpu_torch.recipes import serve_lm, train_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
LR = 1e-2
BATCH, SEQ = 2, 24
#: /stats keys only the port writes (tests/test_torch_observability.py).
PORT_ONLY_KEYS = ('paged_attention', 'qkv_lora', 'device', 'zone',
                  'model', 'engine_stats')


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_config(jax_cfg, **kw) -> pt_ds.DeepseekConfig:
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k not in ('dtype', 'logits_dtype')}
    vals.update(dtype=torch.float32, **kw)
    return pt_ds.DeepseekConfig(**vals)


def _init(model):
    return nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])


def _pair(q_lora_rank=0):
    cfg = dataclasses.replace(jax_ds.DeepseekConfig.tiny(dtype=jnp.float32),
                              q_lora_rank=q_lora_rank)
    model = jax_ds.Deepseek(cfg)
    params = _init(model)
    return model, params, convert.params_from_jax(to_numpy(params),
                                                  port_config(cfg))


@pytest.fixture(scope='module')
def pair():
    """(JAX model, params, port model in serving's layout), f32."""
    return _pair()


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape)


@pytest.mark.parametrize('q_lora_rank', [0, 24])
def test_bridge_round_trips_and_logits_match(q_lora_rank):
    model, params, port = _pair(q_lora_rank)
    tree = to_numpy(params)
    back = convert.train_params_to_jax(
        convert.train_params_from_jax(tree, port.config))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    names = dict(port.named_parameters())
    assert names['layers.0.attn.wkv_b'].shape == (32, 4, 64)
    assert ('layers.0.attn.wq_a.weight' in names) == bool(q_lora_rank)
    toks = _tokens((2, 12))
    want = np.asarray(model.apply({'params': params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('kv_heads', [4, 2])
def test_unequal_dims_attention_matches_reference(causal, kv_heads):
    rng = np.random.default_rng(kv_heads)
    q = rng.standard_normal((2, 9, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 9, kv_heads, 24)).astype(np.float32)
    v = rng.standard_normal((2, 9, kv_heads, 16)).astype(np.float32)
    want = np.asarray(jax_attention._unequal_dims_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = pt_attention._unequal_dims_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert got.shape == (2, 9, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_unequal_dims_are_decided_before_the_flash_route(monkeypatch):
    """MLA's 192 / 128 dims never reach the flash kernels, whatever the
    impl asks (the reference decides them first too)."""
    def no_flash(*args, **kwargs):
        raise AssertionError('the flash route was taken')
    monkeypatch.setattr(flash_kernel, 'flash_attention', no_flash)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 192))).float()
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 128))).float()
    for impl in ('flash', 'auto', 'xla'):
        out = pt_attention.dot_product_attention(q, q, v, impl=impl)
        assert out.shape == (1, 8, 2, 128)
    want = pt_attention._unequal_dims_attention(q, q, v, causal=True)
    assert torch.equal(out, want)


def test_absorbed_decode_reproduces_the_full_forward(pair):
    """The port of the reference's test_generate.py:290-314, pinned to
    the reference's tokens too."""
    model, params, port = pair
    prompt = np.random.default_rng(7).integers(0, 512, (2, 6))
    out = pt_gen.make_generate_fn(port, 12)(torch.from_numpy(prompt))
    assert out.shape == (2, 12)
    with torch.no_grad():
        logits = port(out.long())
    for t in range(5, 11):
        assert torch.equal(torch.argmax(logits[:, t], dim=-1),
                           out[:, t + 1].long()), t
    want = jax_gen.make_generate_fn(model, max_total_len=12)(
        params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0))
    assert np.array_equal(out.numpy(), np.asarray(want))
    full, decoded = pt_gen.teacher_forced_logits(port, out.long())
    torch.testing.assert_close(decoded, full, atol=TOL, rtol=TOL)


def test_prefill_fast_path_matches_the_general_chunk_path(pair):
    """prefill=True (chunk-local S x S scores) against prefill=False
    over the whole latent row: the same logits and cache contents, and
    the next decode step continues alike (the port of
    test_generate.py:382 for DeepSeek); the chunk's logits are the
    reference's."""
    model, params, port = pair
    toks = torch.from_numpy(_tokens((2, 10), seed=3))
    positions = torch.arange(10, dtype=torch.int32).expand(2, 10)
    outs = []
    for prefill in (True, False):
        cache = port.dense_cache(2)
        with torch.no_grad():
            logits = port(toks, positions, cache=cache, prefill=prefill)
            nxt = port(toks[:, -1:], torch.full((2, 1), 10, dtype=torch.int32),
                       cache=cache)
        outs.append((logits, nxt, cache))
    (fast, fast_next, fast_cache), (slow, slow_next, slow_cache) = outs
    torch.testing.assert_close(fast, slow, atol=TOL, rtol=TOL)
    torch.testing.assert_close(fast_next, slow_next, atol=TOL, rtol=TOL)
    for a, b in zip(fast_cache.layers, slow_cache.layers):
        assert a.keys() == b.keys() == {'latent_cache', 'rope_cache'}
        for name in a:
            torch.testing.assert_close(a[name], b[name], atol=TOL, rtol=TOL)
    want = np.asarray(model.apply({'params': params},
                                  jnp.asarray(toks.numpy())))
    np.testing.assert_allclose(fast.numpy(), want, atol=TOL, rtol=TOL)


def test_one_shot_engines_match_the_reference(pair):
    model, params, port = pair
    repetitive = np.asarray([[5, 9, 2, 5, 9, 2, 5, 9],
                             [3, 3, 3, 3, 3, 3, 3, 3]])
    random_p = _tokens((2, 8), seed=5)
    for prompt in (repetitive, random_p):
        want = np.asarray(jax_gen.make_generate_fn(model, 24)(
            params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0)))
        want_spec = np.asarray(jax_gen.make_speculative_generate_fn(
            model, 24, draft_k=4, ngram=2)(
                params, jnp.asarray(prompt, jnp.int32),
                jax.random.PRNGKey(0)))
        assert np.array_equal(want_spec, want)
        got = pt_gen.make_generate_fn(port, 24)(torch.from_numpy(prompt))
        spec = pt_gen.make_speculative_generate_fn(port, 24, draft_k=4)(
            torch.from_numpy(prompt))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(spec.numpy(), want)


# -- training ---------------------------------------------------------------
def tokens_for(step):
    return np.random.default_rng(100 + step).integers(
        0, 512, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope='module')
def jax_training():
    """The reference's ShardedTrainer on one device: (config, initial
    params, step-1 loss and grads, per-step losses, final params)."""
    cfg = jax_ds.DeepseekConfig.tiny(dtype=jnp.float32)
    model = jax_ds.Deepseek(cfg)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    trainer = jax_train.ShardedTrainer(
        model, mesh,
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
        model, tx=pt_train.default_optimizer(learning_rate=LR,
                                             warmup_steps=10,
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
    loss, grads = _grads(model, trainer, state,
                         torch.from_numpy(tokens_for(0)).long())
    np.testing.assert_allclose(loss, loss0, atol=TOL, rtol=TOL)
    _assert_trees_close(grads, grads0)
    # The 3-D wkv_b leaves are trained like every other.
    assert grads['layer_0']['attn']['wkv_b'].shape == (32, 4, 64)
    assert np.abs(grads['layer_0']['attn']['wkv_b']).max() > 0


def test_five_steps_and_remat_match(jax_training):
    cfg, init, _, grads0, losses, final = jax_training
    model, trainer, state = _port_trainer(cfg, init, guard=True)
    step = trainer.make_train_step()
    got = [step(state, torch.from_numpy(tokens_for(i)).long())[1][0].item()
           for i in range(5)]
    np.testing.assert_allclose(got, losses, atol=TOL, rtol=TOL)
    _assert_trees_close(convert.train_params_to_jax(model), final, tol=5e-4)
    # A guarded NaN step updates nothing, the 3-D wkv_b leaves included.
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, (_, _, bad) = step(state, torch.from_numpy(tokens_for(5)).long(),
                          loss_scale=float('nan'))
    assert bool(bad)
    for name, param in model.named_parameters():
        assert torch.equal(param, before[name]), name
    remat = convert.train_params_from_jax(init, port_config(cfg, remat=True))
    trainer = pt_train.ShardedTrainer(remat)
    _, grads = _grads(remat, trainer, trainer.init(),
                      torch.from_numpy(tokens_for(0)).long())
    _assert_trees_close(grads, grads0)


def test_train_lm_writes_metrics_and_resumes(tmp_path, capsys):
    argv = ['--cpu', '--model', 'deepseek-tiny', '--seq', '32',
            '--global-batch', '2', '--log-every', '2', '--ckpt-dir',
            str(tmp_path / 'ck'), '--ckpt-every', '2', '--metrics-file',
            str(tmp_path / 'm.jsonl')]
    train_lm.main(argv + ['--steps', '2'])
    assert 'step 2/2 loss=' in capsys.readouterr().out
    train_lm.main(argv + ['--steps', '4', '--remat'])
    out = capsys.readouterr().out
    assert 'resumed from checkpoint step 2' in out and 'step 4/4' in out
    records = [json.loads(line) for line in
               (tmp_path / 'm.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [2, 4]
    assert all(np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])
               for r in records)


# -- serving ----------------------------------------------------------------
def _serving(rt, make):
    server = make(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _keys(body, prefix=''):
    out = set()
    for k, v in body.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ('migrations', 'requests',
                                             'tokens'):
            out |= _keys(v, prefix + k + '.')
    return out


def test_serve_lm_answers_generate_on_the_dense_path():
    rt = build_runtime(serve_lm.parse_args(
        ['--cpu', '--model', 'deepseek-tiny', '--continuous-batching',
         '--max-total-len', '64', '--num-slots', '2']))
    server = _serving(rt, pt_http.make_server)
    try:
        assert rt.engine.paged is False
        assert rt.engine.prefix_caching is False
        prompt = [5, 9, 2, 17, 5, 9]
        got = _http(server.server_address[1], '/generate',
                    {'tokens': [prompt], 'max_new_tokens': 8})['tokens'][0]
        assert len(got) == len(prompt) + 8 and got[:len(prompt)] == prompt
        stats = _http(server.server_address[1], '/stats')
        assert stats['model'] == 'deepseek-tiny'
        assert stats['attention_impl'] == 'dense' and 'page_pool' not in stats
        # The latent rows: 2 slots x 256 positions x (32 + 16) values x
        # 2 layers, bf16.
        assert rt.engine.kv_cache_bytes() == 2 * 256 * 48 * 2 * 2
        apt = stats['attention_bytes_per_token']
        assert apt['context_tokens_walked'] == 64
        assert apt['kv_pool_bytes'] == 64 * 48 * 2 * 2
    finally:
        server.shutdown()
        rt.stop()


@pytest.mark.parametrize('flags,reason', [
    (['--adapter-dir', '{tmp}'], 'Deepseek has no LoRA forward path'),
    (['--kv-dtype', 'int8'], 'DeepseekConfig has none'),
    (['--kv-pool-bytes', '1000000'], 'DeepseekConfig has none'),
])
def test_serve_lm_refusals_name_their_reason(flags, reason, tmp_path):
    argv = ['--cpu', '--model', 'deepseek-tiny', '--continuous-batching',
            '--max-total-len', '64'] + [f.format(tmp=tmp_path)
                                        for f in flags]
    with pytest.raises((SystemExit, ValueError), match=reason):
        build_runtime(serve_lm.parse_args(argv))


def test_stats_keys_match_the_reference_replica(pair, monkeypatch):
    """The same requests through a dense reference replica and a dense
    port replica: /stats has the reference's key set, recursively (no
    page_pool, as the reference writes it only for a paged engine). The
    reference's attention_bytes_per_token reads `cfg.head_dim`, which
    its DeepseekConfig lacks (an AttributeError there); this test gives
    the reference's class that property so its body can be built."""
    model, params, port = pair
    monkeypatch.setattr(jax_ds.DeepseekConfig, 'head_dim',
                        property(lambda c: c.qk_head_dim), raising=False)
    monkeypatch.setattr(metrics, 'REGISTRY', metrics.Registry())
    monkeypatch.setattr(pt_http, 'REGISTRY', metrics.REGISTRY)
    monkeypatch.setattr(ref_metrics, 'REGISTRY', ref_metrics.Registry())
    monkeypatch.setattr(jax_http, 'REGISTRY', ref_metrics.REGISTRY)
    kw = dict(num_slots=2, max_total_len=48)
    ref_rt = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=512,
        model_name='deepseek-tiny', max_total_len=48, spec_total=48,
        speculative=0, engine_total=48,
        engine=jax_batching.ContinuousBatchingEngine(model, params, **kw))
    rt = pt_runtime.InferenceRuntime(
        engine=pt_batching.ContinuousBatchingEngine(port, **kw),
        model_name='deepseek-tiny')
    servers = [_serving(ref_rt, jax_http.make_server),
               _serving(rt, pt_http.make_server)]
    try:
        bodies, answers = [], []
        for server in servers:
            p = server.server_address[1]
            answers.append(_http(p, '/generate', {
                'tokens': [[5, 9, 2, 17, 5, 9]], 'max_new_tokens': 6}))
            bodies.append(_http(p, '/stats'))
        assert answers[0]['tokens'] == answers[1]['tokens']
        ref_body, body = bodies
        port_only = {k for k in _keys(body)
                     if k.split('.')[0] in PORT_ONLY_KEYS}
        assert _keys(body) - port_only == _keys(ref_body)
        assert 'page_pool' not in body and 'prefix_cache' not in body
        assert body['attention_impl'] == ref_body['attention_impl'] == \
            'dense'
        for key in ('num_slots', 'decode_calls', 'tokens_committed'):
            assert body[key] == ref_body[key], key
    finally:
        for server, r in zip(servers, (ref_rt, rt)):
            server.shutdown()
            r.engine.stop()


# -- HF checkpoints ---------------------------------------------------------
@pytest.mark.parametrize('q_lora_rank', [None, 24])
def test_hf_deepseek_loads_as_the_reference_and_transformers(tmp_path,
                                                             q_lora_rank):
    import transformers
    torch.manual_seed(0)
    hf = transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        kv_lora_rank=32, q_lora_rank=q_lora_rank, qk_rope_head_dim=16,
        qk_nope_head_dim=32, v_head_dim=32, n_routed_experts=None,
        first_k_dense_replace=2, max_position_embeddings=64,
        tie_word_embeddings=False)).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert hf_import.config_type(str(tmp_path)) is pt_ds.DeepseekConfig
    cfg, port = hf_import.load_hf_checkpoint(str(tmp_path),
                                             dtype=torch.float32)
    assert isinstance(port, pt_ds.Deepseek)
    assert cfg.q_lora_rank == (q_lora_rank or 0)
    jmodel, jparams = jax_hf.load_hf_checkpoint(str(tmp_path),
                                                dtype=jnp.float32)
    toks = _tokens((2, 10)) % 128
    want = np.asarray(jmodel.apply({'params': jparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
        theirs = hf(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, theirs, atol=TOL, rtol=TOL)


def test_hf_routed_experts_refused_before_any_weight_is_read(tmp_path,
                                                             monkeypatch):
    (tmp_path / 'config.json').write_text(json.dumps({
        'model_type': 'deepseek_v2', 'n_routed_experts': 8}))

    def no_read(*args, **kwargs):
        raise AssertionError('weights were read')
    monkeypatch.setattr(hf_import, 'load_state_dict', no_read)
    with pytest.raises(hf_import.HfImportError, match='routed-expert'):
        hf_import.load_hf_checkpoint(str(tmp_path))
    (tmp_path / 'config.json').write_text(json.dumps({
        'model_type': 'deepseek_v2',
        'rope_scaling': {'type': 'yarn', 'factor': 4.0}}))
    with pytest.raises(hf_import.HfImportError, match='yarn'):
        hf_import.load_hf_checkpoint(str(tmp_path))
    assert os.listdir(tmp_path) == ['config.json']
