"""The port's GPT-2 family (skypilot_tpu_torch/models/gpt.py) against the
JAX reference (skypilot_tpu/models/gpt.py) on the same seeded weights,
CPU, f32 (GPTConfig.tiny: 2 layers, 4 heads of 32, vocab 512, block 128):

  - the weight bridge consumes every leaf and round-trips the training
    tree bit for bit; no-cache logits within 1e-5;
  - `wpe` clamps explicit positions at block_size - 1 as a JAX gather
    does; bf16 logits are bf16 values and argmax takes the first of
    tied maxima in both frameworks;
  - paged decode == dense decode == the reference's dense decode
    (teacher-forced logits within 1e-5);
  - the one-shot generate functions (plain and speculative) give the
    reference's greedy tokens, and speculative == greedy;
  - the slot engine (pipelined, unpipelined, --prefill-chunk with a
    partial last chunk, a prefix hit, --speculative 4) gives the JAX
    engine's greedy tokens; speculative == greedy;
  - a KV chain exported by the JAX engine imports into the port's and
    re-exports the same bytes (num_kv_heads 0 in the header, as the
    reference writes it), and the reverse;
  - ShardedTrainer: step-1 loss and gradients (tied `wte`: both uses)
    through the fused and the logits path, 5 steps, and remat == none;
  - train_lm --model tiny writes metrics and resumes from --ckpt-dir;
    serve_lm --model tiny answers /generate (slot and one-shot
    engines); --kv-dtype int8, --kv-pool-bytes, --adapter-dir and
    --weight-dtype int8 are refused with the reference's reasons;
  - --hf: a tiny GPT2LMHeadModel written by transformers loads into both
    packages with the same logits, and transformers' own within 1e-5.
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
from skypilot_tpu.models import gpt as jax_gpt
from skypilot_tpu.models import hf_import as jax_hf
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import train as jax_train
from skypilot_tpu_torch.inference import kv_transfer as kvt
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import generate as pt_gen
from skypilot_tpu_torch.models import gpt as pt_gpt
from skypilot_tpu_torch.models import hf_import
from skypilot_tpu_torch.models.llama import DenseKVCache, PagedKVCache
from skypilot_tpu_torch.parallel import train as pt_train
from skypilot_tpu_torch.recipes import serve_lm, train_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
PAGED = dict(kv_page_size=8, kv_total_pages=40)
ENGINE_KW = dict(num_slots=2, max_total_len=64, prefill_chunk=16)
LR = 1e-2
BATCH, SEQ = 2, 24


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_config(jax_cfg, **kw) -> pt_gpt.GPTConfig:
    fields = {f.name for f in dataclasses.fields(pt_gpt.GPTConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'logits_dtype')}
    vals.update(dtype=torch.float32, **kw)
    return pt_gpt.GPTConfig(**vals)


@pytest.fixture(scope='module')
def pair():
    """(JAX model, params, port model in serving's layout), f32."""
    cfg = jax_gpt.GPTConfig.tiny(dtype=jnp.float32, **PAGED)
    model = jax_gpt.GPT(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(to_numpy(params), port_config(cfg))
    return model, params, port


def _prompts():
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 512, 16).tolist()
    loop = [5, 9, 2, 17, 5, 9, 2, 17, 5, 9, 2]    # drafts get accepted
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
    n_jax = sum(x.size for x in jax.tree.leaves(tree))
    assert n_jax == sum(p.numel() for p in port.parameters())
    trained = convert.train_params_from_jax(tree, port.config)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trained.parameters())
    back = convert.train_params_to_jax(trained)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    with pytest.raises(ValueError, match='stray'):
        convert.params_from_jax(dict(tree, stray=np.zeros(3, np.float32)),
                                port.config)


def test_no_cache_logits_match(pair):
    model, params, port = pair
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24), np.int32)
    ref = np.asarray(model.apply({'params': params}, jnp.asarray(tokens)))
    with torch.no_grad():
        out = port(torch.from_numpy(tokens).long()).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_wpe_clamps_positions_past_block_size(pair):
    model, params, port = pair
    block = port.config.block_size
    tokens = np.asarray([[7, 3, 11, 42, 5]], np.int32)
    positions = np.asarray([[0, 5, block - 1, block, block + 73]], np.int32)
    ref = np.asarray(model.apply({'params': params}, jnp.asarray(tokens),
                                 positions=jnp.asarray(positions)))
    with torch.no_grad():
        out = port.hidden(torch.from_numpy(tokens).long(),
                          torch.from_numpy(positions))
        clamped = port.hidden(torch.from_numpy(tokens).long(),
                              torch.from_numpy(np.minimum(positions,
                                                          block - 1)))
        logits = port.logits(out).numpy()
    assert torch.equal(out, clamped)
    np.testing.assert_allclose(logits, ref, atol=TOL, rtol=TOL)


def test_bf16_logits_and_first_max_ties():
    cfg = pt_gpt.GPTConfig.tiny()
    model = convert.init_params(cfg, seed=1, device='cpu')
    assert model.wte.dtype == torch.bfloat16
    assert model.h[0].ln_1.bias.dtype == torch.float32
    with torch.no_grad():
        model.wte[7] = model.wte[3]
        x = model.wte[3].float()[None]
        logits = model.logits(x)
    # f32 holding bf16 values, the head's output dtype.
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.bfloat16().float())
    assert logits[0, 3] == logits[0, 7] == logits.max()
    assert int(torch.argmax(logits, dim=-1)) == 3
    assert int(jnp.argmax(jnp.asarray(logits.numpy(), jnp.bfloat16),
                          axis=-1)[0]) == 3


def test_paged_decode_matches_dense_and_reference(pair):
    """The counterpart of the reference's test_gpt_paged_decode_matches_
    dense: teacher-forced decode through the dense and the paged cache,
    each step's logits equal to the reference's dense decode."""
    model, params, port = pair
    cfg = port.config
    pages = -(-32 // cfg.kv_page_size)
    table = np.asarray([[1 + i for i in range(pages)],
                        [1 + pages + i for i in range(pages)]], np.int32)
    jcache = jax.tree.map(jnp.zeros_like, nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
        positions=jnp.zeros((2, 1), jnp.int32), decode=True)['cache']))
    dense, paged = DenseKVCache(cfg, 2), PagedKVCache(cfg)
    assert paged.layers[0]['k_pages'].shape == (4, 40, 8, 32)
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
    repetitive = np.asarray([[5, 9, 2, 5, 9, 2, 5, 9],
                             [3, 3, 3, 3, 3, 3, 3, 3]], np.int32)
    want = np.asarray(jax_gen.make_generate_fn(model, 24)(
        params, jnp.asarray(repetitive), jax.random.PRNGKey(0)))
    got = pt_gen.make_generate_fn(port, 24)(torch.from_numpy(repetitive))
    spec = pt_gen.make_speculative_generate_fn(port, 24, draft_k=4)(
        torch.from_numpy(repetitive))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(spec.numpy(), want)


@pytest.fixture(scope='module')
def jax_engine_runs(pair):
    """The JAX engine's greedy tokens (pipelined, the default) and its
    export of the first prompt's chain; then its --speculative 4
    tokens."""
    model, params, _ = pair
    eng = jax_batching.ContinuousBatchingEngine(model, params, **ENGINE_KW)
    futs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), MAX_NEW)]
    try:
        plain = [f.result(timeout=300) for f in futs]
        chain = eng.export_chain(_prompts()[0])
    finally:
        eng.stop()
    spec = _run(jax_batching.ContinuousBatchingEngine(
        model, params, speculative_k=4, **ENGINE_KW))
    return plain, chain, spec


@pytest.mark.parametrize('pipelined', [None, False],
                         ids=['pipelined', 'unpipelined'])
def test_engine_matches_the_jax_engine(pair, jax_engine_runs, pipelined):
    _, _, port = pair
    engine = pt_batching.ContinuousBatchingEngine(
        port, pipeline_decode=pipelined, **ENGINE_KW)
    assert engine.pipeline_decode is (pipelined is None)
    got = _run(engine)
    assert got == jax_engine_runs[0]
    assert engine.stats()['prefix_cache']['hits'] > 0


def test_speculative_engine_matches_reference_and_greedy(pair,
                                                        jax_engine_runs):
    _, _, port = pair
    engine = pt_batching.ContinuousBatchingEngine(port, speculative_k=4,
                                                  **ENGINE_KW)
    got = _run(engine)
    assert got == jax_engine_runs[2] == jax_engine_runs[0]
    assert engine.tokens_committed > engine.decode_calls


def test_chains_cross_frameworks_byte_for_byte(pair, jax_engine_runs):
    model, params, port = pair
    prompt, data = _prompts()[0], jax_engine_runs[1]
    meta, blobs = kvt.unpack_pages(data)
    assert meta['num_kv_heads'] == 0 and meta['head_dim'] == 32
    assert "['h_1']['attn']['v_pages']" in blobs
    eng = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        assert eng.import_chain(data) == {'pages': 3, 'imported': 3,
                                          'already_cached': 0,
                                          'dropped': 0}
        assert eng.export_chain(prompt) == data
    finally:
        eng.stop()
    src = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        src.submit(prompt, max_new_tokens=2).result(timeout=300)
        ours = src.export_chain(prompt)
    finally:
        src.stop()
    dst = jax_batching.ContinuousBatchingEngine(model, params, **ENGINE_KW)
    try:
        assert dst.import_chain(ours)['imported'] == 3
        assert dst.export_chain(prompt) == ours
    finally:
        dst.stop()


# -- training ---------------------------------------------------------------
def tokens_for(step):
    return np.random.default_rng(100 + step).integers(
        0, 512, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope='module')
def jax_training():
    """JAX ShardedTrainer on one device: (config, initial params, step-1
    loss and grads, per-step losses, final params)."""
    cfg = jax_gpt.GPTConfig.tiny(dtype=jnp.float32)
    model = jax_gpt.GPT(cfg)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    trainer = jax_train.ShardedTrainer(
        model, mesh, tx=jax_train.default_optimizer(
            learning_rate=LR, warmup_steps=10, total_steps=20))
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


def test_five_steps_and_remat_match(jax_training):
    cfg, init, _, grads0, losses, final = jax_training
    model, trainer, state = _port_trainer(cfg, init)
    step = trainer.make_train_step()
    got = [step(state, torch.from_numpy(tokens_for(i)).long())[1].item()
           for i in range(5)]
    np.testing.assert_allclose(got, losses, atol=TOL, rtol=TOL)
    _assert_trees_close(convert.train_params_to_jax(model), final, tol=5e-4)
    remat = convert.train_params_from_jax(
        init, port_config(cfg, remat=True))
    trainer = pt_train.ShardedTrainer(remat)
    _, grads = _grads(remat, trainer, trainer.init(),
                      torch.from_numpy(tokens_for(0)).long())
    _assert_trees_close(grads, grads0)


def test_train_lm_writes_metrics_and_resumes(tmp_path, capsys):
    argv = ['--cpu', '--model', 'tiny', '--seq', '32', '--global-batch',
            '2', '--log-every', '2', '--ckpt-dir', str(tmp_path / 'ck'),
            '--ckpt-every', '2', '--metrics-file', str(tmp_path / 'm.jsonl')]
    train_lm.main(argv + ['--steps', '4'])
    out = capsys.readouterr().out
    assert 'step 4/4 loss=' in out and 'training done' in out
    train_lm.main(argv + ['--steps', '6'])
    out = capsys.readouterr().out
    assert 'resumed from checkpoint step 4' in out and 'step 6/6' in out
    records = [json.loads(line) for line in
               (tmp_path / 'm.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [2, 4, 6]
    assert all(np.isfinite(r['loss']) and r['mfu'] is None
               for r in records)


# -- serving ----------------------------------------------------------------
def _post(port, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize('engine', ['--continuous-batching', None])
def test_serve_lm_answers_generate(engine):
    argv = ['--cpu', '--model', 'tiny', '--max-total-len', '64']
    rt = build_runtime(serve_lm.parse_args(argv + ([engine] if engine
                                                   else [])))
    server = make_server(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        prompt = _prompts()[0]
        got = _post(server.server_address[1],
                    {'tokens': [prompt], 'max_new_tokens': 8})['tokens'][0]
        # The one-shot engine answers with its whole bucket, as the
        # reference's does.
        assert got[:len(prompt)] == prompt
        assert len(got) == (len(prompt) + 8 if engine else 64)
        with urllib.request.urlopen(
                f'http://127.0.0.1:{server.server_address[1]}/stats',
                timeout=60) as resp:
            stats = json.loads(resp.read())
        assert stats['model'] == 'tiny'
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
    (['--kv-dtype', 'int8'], 'GPTConfig has none'),
    (['--kv-pool-bytes', '1000000'], 'GPTConfig has none'),
    (['--weight-dtype', 'int8'], 'found no quantizable projection'),
    (['--adapter-dir', '{tmp}'], 'GPT has no LoRA forward path'),
])
def test_serve_lm_refusals_name_the_references_reason(flags, reason,
                                                      tmp_path):
    argv = ['--cpu', '--model', 'tiny', '--continuous-batching',
            '--max-total-len', '64'] + [f.format(tmp=tmp_path)
                                        for f in flags]
    with pytest.raises((SystemExit, ValueError), match=reason):
        build_runtime(serve_lm.parse_args(argv))


# -- HF checkpoints ---------------------------------------------------------
def test_hf_gpt2_loads_as_the_reference_and_transformers(tmp_path):
    import transformers
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4))
    with torch.no_grad():   # init leaves biases at zero
        for name, p in hf.named_parameters():
            if name.endswith('bias'):
                p.normal_(0.0, 0.1)
    hf.eval()     # no dropout
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, port = hf_import.load_hf_checkpoint(str(tmp_path),
                                             dtype=torch.float32)
    assert isinstance(port, pt_gpt.GPT) and cfg.block_size == 64
    jmodel, jparams = jax_hf.load_hf_checkpoint(str(tmp_path),
                                                dtype=jnp.float32)
    bridged = convert.params_from_jax(to_numpy(jparams), cfg)
    for (name, a), (_, b) in zip(port.state_dict().items(),
                                 bridged.state_dict().items()):
        assert torch.equal(a, b), name
    tokens = np.random.default_rng(2).integers(0, 128, (2, 20), np.int32)
    with torch.no_grad():
        ours = port(torch.from_numpy(tokens).long()).numpy()
        theirs = hf(torch.from_numpy(tokens).long()).logits.numpy()
    ref = np.asarray(jmodel.apply({'params': jparams}, jnp.asarray(tokens)))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    with pytest.raises(hf_import.HfImportError, match='n_positions=64'):
        hf_import.load_hf_checkpoint(str(tmp_path), max_seq_len=128)
