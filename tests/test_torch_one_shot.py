"""The port's one-shot engine (serve_lm without --continuous-batching)
against the reference, CPU, llama-tiny at f32 on the same weights:

  - `make_generate_fn` (greedy, with eos padding),
    `teacher_forced_logits` and `make_speculative_generate_fn` give the
    reference's tokens exactly and its logits within 1e-5; the dense
    cache's decode logits equal the full forward's within 1e-5; sampled
    rows keep their prompt and repeat under one generator seed;
  - `one_shot_rows` runs ragged rows in the reference's power-of-two
    buckets and returns its rows;
  - the JAX and the port one-shot servers answer /generate (whole
    bucket rows, plain and --speculative 2), /generate_text and
    /v1/completions with n=2 with the same bodies; a stream in one-shot
    mode builds the stream engine, whose rows equal the one-shot rows;
  - serve_lm without --continuous-batching starts and answers; int8 KV
    pages without it exit with the reference's message;
  - --ckpt-dir: a `train_lm` full-parameter checkpoint serves the
    weights the in-process training produced (bit for bit, through the
    weight bridge) and their greedy tokens.
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
import transformers

from skypilot_tpu.inference import http_server as jax_http
from skypilot_tpu.inference import runtime as jax_runtime
from skypilot_tpu.models import generate as jax_generate
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.inference import http_server as pt_http
from skypilot_tpu_torch.inference import runtime as pt_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import generate as pt_generate
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOTAL = 48
VOCAB = 512


@pytest.fixture(scope='module')
def models():
    """(reference model, params, port model) of one f32 llama-tiny."""
    cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(dtype=jnp.float32),
                              max_seq_len=64)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    port_cfg = pt_llama.LlamaConfig(
        dtype=torch.float32,
        **{k: v for k, v in dataclasses.asdict(cfg).items()
           if k in fields and k not in ('dtype', 'rope_scaling')})
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params), port_cfg,
        device='cpu')
    return model, params, port


def _prompt(batch=2, length=10, seed=0):
    p = np.random.default_rng(seed).integers(1, VOCAB, (batch, length))
    p[-1, length // 2:] = p[-1, :length - length // 2]   # repeats: drafts
    return p


def test_generate_fn_matches_reference(models):
    model, params, port = models
    prompt = _prompt()
    ref = np.asarray(jax_generate.make_generate_fn(model, TOTAL)(
        params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0)))
    out = pt_generate.make_generate_fn(port, TOTAL)(
        torch.from_numpy(prompt)).numpy()
    assert out.shape == (2, TOTAL) and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    eos = int(ref[0, 14])
    ref_eos = np.asarray(jax_generate.make_generate_fn(
        model, TOTAL, eos_id=eos)(params, jnp.asarray(prompt, jnp.int32),
                                  jax.random.PRNGKey(0)))
    out_eos = pt_generate.make_generate_fn(port, TOTAL, eos_id=eos)(
        torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(out_eos, ref_eos)
    assert (out_eos[0, 14:] == eos).all()


def test_sampled_generate_keeps_prompt_and_seed(models):
    _, _, port = models
    prompt = _prompt()
    fn = pt_generate.make_generate_fn(port, TOTAL, temperature=0.9)
    outs = [fn(torch.from_numpy(prompt),
               torch.Generator().manual_seed(3)).numpy() for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:, :10], prompt)
    assert ((0 <= outs[0]) & (outs[0] < VOCAB)).all()


def test_teacher_forced_logits_match_reference(models):
    model, params, port = models
    tokens = _prompt(length=20)
    full, decoded = jax_generate.teacher_forced_logits(
        model, params, jnp.asarray(tokens, jnp.int32))
    pfull, pdecoded = pt_generate.teacher_forced_logits(
        port, torch.from_numpy(tokens))
    np.testing.assert_allclose(pfull.numpy(), np.asarray(full), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pdecoded.numpy(), np.asarray(decoded),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(pdecoded.numpy(), pfull.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('draft_k', [1, 4])
def test_speculative_fn_matches_reference_and_plain(models, draft_k):
    model, params, port = models
    prompt = _prompt(length=12, seed=1)
    ref = np.asarray(jax_generate.make_speculative_generate_fn(
        model, TOTAL, draft_k=draft_k)(params, jnp.asarray(prompt, jnp.int32),
                                       jax.random.PRNGKey(0)))
    out = pt_generate.make_speculative_generate_fn(
        port, TOTAL, draft_k=draft_k)(torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(out, ref)
    plain = pt_generate.make_generate_fn(port, TOTAL)(
        torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(out, plain)


def _write_tokenizer(path):
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers
    vocab = {'<unk>': 0}
    vocab.update({f'w{i}': i for i in range(1, VOCAB)})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token='<unk>').save_pretrained(str(path))
    return str(path)


def _runtimes(models, tok_dir, speculative=0):
    model, params, port = models
    spec_total = TOTAL
    ref = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=VOCAB,
        model_name='llama-tiny', max_total_len=TOTAL,
        spec_total=spec_total, speculative=speculative,
        tokenizer_dir=tok_dir)
    rt = pt_runtime.InferenceRuntime(
        model=port, model_name='llama-tiny', max_total_len=TOTAL,
        speculative=speculative, spec_total=spec_total,
        tokenizer_dir=tok_dir, cuda_graphs=False)
    return ref, rt


def test_one_shot_rows_buckets_match_reference(models, tmp_path):
    ref, rt = _runtimes(models, None)
    rows = [_prompt(1, 5, seed=4)[0].tolist(),
            _prompt(1, 20, seed=5)[0].tolist()]
    got = rt.one_shot_rows(rows, 6, 0.0)
    assert got == ref.one_shot_rows(rows, 6, 0.0)
    assert [len(r) for r in got] == [11, 26]
    # 5 + 6 -> the 16 bucket, 20 + 6 -> 32.
    assert sorted(k for k in rt._fns) == [(1, 0.0, 16), (1, 0.0, 32)]
    got = rt.one_shot_rows(rows[1:], 40, 0.0)   # capped by the limit
    assert len(got[0]) == TOTAL
    assert got == ref.one_shot_rows(rows[1:], 40, 0.0)


def _serve(rt, make):
    server = make(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _post(port, path, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _stream_rows(port, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate',
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={'Content-Type': 'application/json'})
    events = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            if line.startswith(b'data: ') and b'[DONE]' not in line:
                events.append(json.loads(line[len(b'data: '):]))
    return events


@pytest.mark.parametrize('speculative', [0, 2])
def test_one_shot_servers_match_reference(models, tmp_path, speculative):
    tok_dir = _write_tokenizer(tmp_path / 'tok')
    ref, rt = _runtimes(models, tok_dir, speculative)
    served = [_serve(ref, jax_http.make_server),
              _serve(rt, pt_http.make_server)]
    ports = [s.server_address[1] for s, _ in served]
    try:
        prompt = _prompt(2, 9, seed=6).tolist()
        gen = [_post(p, '/generate', {'tokens': prompt}) for p in ports]
        assert gen[1] == gen[0]
        assert [len(r) for r in gen[1]['tokens']] == [TOTAL, TOTAL]
        text = {'prompts': ['w3 w9 w27 w81', 'w5 w25'], 'max_new_tokens': 7}
        assert _post(ports[1], '/generate_text', text) == \
            _post(ports[0], '/generate_text', text)
        comp = {'prompt': 'w11 w12 w13 w11 w12', 'max_tokens': 9, 'n': 2,
                'temperature': 0.0}
        assert _post(ports[1], '/v1/completions', comp) == \
            _post(ports[0], '/v1/completions', comp)
        if speculative:
            return
        assert rt.live_engines() == []
        events = _stream_rows(ports[1], {'tokens': prompt[:1],
                                         'max_new_tokens': 12})
        assert len(rt.live_engines()) == 1     # the stream engine
        assert events[-1]['tokens'][0] == gen[1]['tokens'][0][:9 + 12]
        assert [e['token'] for e in events[:-1]] == \
            gen[1]['tokens'][0][9:9 + 12]
        with urllib.request.urlopen(f'http://127.0.0.1:{ports[1]}/stats',
                                    timeout=30) as resp:
            stats = json.loads(resp.read())
        assert stats['engine'] == 'simple' and stats['healthy']
    finally:
        for server, thread in served:
            server.shutdown()
            thread.join(timeout=10)
        rt.stop()


def test_serve_lm_one_shot_starts_and_answers():
    args = serve_lm.parse_args(['--cpu', '--model', 'llama-tiny',
                                '--max-total-len', '32'])
    assert not args.continuous_batching
    rt = pt_runtime.build_runtime(args)
    assert rt.engine is None and rt.limit_for() == 32
    server, thread = _serve(rt, pt_http.make_server)
    port = server.server_address[1]
    try:
        rows = _post(port, '/generate', {'tokens': [[1, 2, 3, 4]]})['tokens']
        assert len(rows[0]) == 32 and rows[0][:4] == [1, 2, 3, 4]
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/',
                                    timeout=30) as resp:
            assert json.loads(resp.read())['max_total_len'] == 32
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=10)


def test_int8_without_continuous_batching_is_refused_as_reference():
    # The same flags as both recipes parse them (the port's parser takes
    # the reference's command line).
    args = serve_lm.build_parser().parse_args(
        ['--cpu', '--model', 'llama-tiny', '--kv-dtype', 'int8',
         '--max-total-len', '32'])
    with pytest.raises(SystemExit) as ref:
        jax_runtime.build_runtime(args)
    with pytest.raises(SystemExit) as got:
        pt_runtime.build_runtime(args)
    assert str(got.value) == str(ref.value) == \
        pt_runtime.INT8_NEEDS_CONTINUOUS


def test_ckpt_dir_serves_the_trained_weights(tmp_path, monkeypatch):
    from skypilot_tpu_torch.parallel import checkpoints
    from skypilot_tpu_torch.recipes import train_lm
    saved = {}
    real_save = checkpoints.CheckpointManager.save

    def save(self, step, state, force=False):
        # The in-process trained parameters, as each save sees them.
        saved[step] = {k: v.detach().clone()
                       for k, v in state.params.items()}
        return real_save(self, step, state, force)

    monkeypatch.setattr(checkpoints.CheckpointManager, 'save', save)
    ckpt = str(tmp_path / 'ckpt')
    train_lm.main(['--cpu', '--model', 'llama-tiny', '--steps', '3',
                   '--seq', '32', '--global-batch', '2', '--ckpt-dir', ckpt,
                   '--ckpt-every', '2', '--log-every', '1'])
    assert sorted(os.listdir(ckpt)) == ['2', '3', 'manifest-2.json',
                                        'manifest-3.json']
    # The trained model carried to serving's layout through the bridge.
    trained = convert.assemble(registry.train_config('llama-tiny', 32),
                               saved[3])
    served_cfg = registry.model_config('llama-tiny', 48)
    expected = convert.params_from_jax(convert.train_params_to_jax(trained),
                                       served_cfg)
    rt = pt_runtime.build_runtime(serve_lm.parse_args(
        ['--cpu', '--model', 'llama-tiny', '--ckpt-dir', ckpt,
         '--continuous-batching', '--max-total-len', '48',
         '--num-slots', '2']))
    try:
        got = rt.model.state_dict()
        for name, t in expected.state_dict().items():
            assert torch.equal(got[name], t), name
        seeded = convert.init_params(served_cfg, seed=0)
        assert not torch.equal(got['tok_embed'], seeded.tok_embed)
        engine = pt_batching.ContinuousBatchingEngine(
            expected, num_slots=2, max_total_len=48)
        prompts = [_prompt(1, 7, seed=8)[0].tolist(),
                   _prompt(1, 12, seed=9)[0].tolist()]
        try:
            want = [engine.submit(p, max_new_tokens=10).result(timeout=120)
                    for p in prompts]
        finally:
            engine.stop()
        assert [rt.engine.submit(p, max_new_tokens=10).result(timeout=120)
                for p in prompts] == want
    finally:
        rt.stop()
