"""The port engine's decode modes against the JAX reference engine, CPU,
llama-tiny at f32 with bf16 (stored f32) and int8 pools:

  - pipelined decode (the default) == the reference engine (pipelined by
    default) == the port's unpipelined loop;
  - decode_chunk 2 and 4 == the reference's decode_chunk == the port's
    single step, with the reference's dispatch-count contract; the first
    sampled request draws the same tokens chunked and single-step under
    one seed (within the port);
  - speculative_k=4 == the reference's speculative_k=4 == plain greedy;
  - EOS and a stop token mid-chunk truncate where single step does, and
    on_token streams in order; speculation on a 16-page pool of page
    size 4 answers every request through preemption;
  - the constructor rules, serve_lm's --speculative / --decode-chunk /
    --no-pipeline-decode and their headroom clamps, and the /stats keys
    of these modes against a reference replica's for the same run;
  - the static-buffer decode round (models/decode_graph.py), run eagerly,
    gives the plain step's tokens and feeds back on the device;
  - the verify chunk's paged attention (S = K+1, every row at its own
    position) pins the plain version to the Pallas kernel, and the
    perturbed kernel fails the pin.
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
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import pallas_paged as jax_pp
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode_graph
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.ops import paged_kernel as pk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ENGINE_KW = dict(num_slots=2, max_total_len=64, prefill_chunk=16)
MAX_NEW = (6, 14, 10)


def _prompts():
    rng = np.random.default_rng(3)
    loop = [5, 9, 2, 17, 5, 9, 2, 17, 5, 9, 2]    # drafts get accepted
    return [loop + rng.integers(1, 512, 9).tolist(),
            rng.integers(1, 512, 23).tolist(),
            [3, 3, 3, 3, 3, 3] + rng.integers(1, 512, 12).tolist()]


def _port_config(cfg) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(dtype=torch.float32, **vals)


def _models(kv_dtype, **cfg_kw):
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_dtype=kv_dtype,
                                     **{'kv_page_size': 8,
                                        'kv_total_pages': 40, **cfg_kw})
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        _port_config(cfg), device='cpu')
    return model, params, port


def _run(engine, prompts=None, max_new=MAX_NEW, **submit_kw):
    prompts = prompts or _prompts()
    futs = [engine.submit(p, max_new_tokens=n, **submit_kw)
            for p, n in zip(prompts, max_new)]
    try:
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


def _port(port_model, **kw):
    return pt_batching.ContinuousBatchingEngine(port_model,
                                                **{**ENGINE_KW, **kw})


@pytest.fixture(scope='module', params=['bf16', 'int8'])
def pair(request):
    """(jax model, params, port model, the port's unpipelined greedy
    outputs) for one pool dtype."""
    model, params, port = _models(request.param)
    plain = _run(_port(port, pipeline_decode=False))
    for out, prompt, n in zip(plain, _prompts(), MAX_NEW):
        assert out[:len(prompt)] == prompt and len(out) == len(prompt) + n
    return model, params, port, plain


def test_pipelined_matches_reference_and_unpipelined(pair):
    model, params, port, plain = pair
    engine = _port(port)
    assert engine.pipeline_decode is True and engine.cuda_graphs is False
    got = _run(engine)
    ref = jax_batching.ContinuousBatchingEngine(model, params, **ENGINE_KW)
    assert ref.pipeline_decode is True
    assert got == plain == _run(ref)
    # The trailing round after each drain is dispatched, never committed.
    assert engine.tokens_committed == sum(MAX_NEW)


@pytest.mark.parametrize('chunk', [2, 4])
def test_decode_chunk_matches_reference_and_single_step(pair, chunk):
    model, params, port, plain = pair
    engine = _port(port, decode_chunk=chunk)
    assert engine.decode_chunk == chunk and engine.pipeline_decode is False
    got = _run(engine)
    # Dispatch amortization is observable: far fewer decode calls than
    # committed tokens (the reference's bound).
    assert engine.tokens_committed >= \
        chunk * (engine.decode_calls - len(MAX_NEW) - 1)
    ref = _run(jax_batching.ContinuousBatchingEngine(
        model, params, decode_chunk=chunk, **ENGINE_KW))
    assert got == ref == plain


def test_speculative_matches_reference_and_plain(pair):
    model, params, port, plain = pair
    engine = _port(port, speculative_k=4)
    assert engine.pipeline_decode is False
    got = _run(engine)
    ref = _run(jax_batching.ContinuousBatchingEngine(
        model, params, speculative_k=4, **ENGINE_KW))
    assert got == ref == plain
    # The repetitive prompt's drafts were accepted: fewer calls than
    # committed tokens.
    assert engine.tokens_committed == sum(MAX_NEW)
    assert engine.decode_calls < engine.tokens_committed


@pytest.mark.parametrize('pipeline', [False, None])
def test_sampled_first_request_chunked_equals_single_step(pipeline):
    """Within the port, one seed: decode_chunk=4 draws the first
    request's tokens exactly as single-step decode does."""
    _, _, port = _models('bf16')

    def first_sampled(**kw):
        return _run(_port(port, seed=5, **kw), prompts=[_prompts()[1]],
                    max_new=(16,), temperature=0.9, top_k=50)[0]

    single = first_sampled(pipeline_decode=pipeline)
    assert first_sampled(decode_chunk=4) == single
    greedy = _run(_port(port), prompts=[_prompts()[1]], max_new=(16,))[0]
    assert single != greedy     # the draws did sample


@pytest.mark.parametrize('mode', [dict(decode_chunk=3),
                                  dict(speculative_k=4)],
                         ids=['chunk3', 'spec4'])
def test_eos_and_stop_mid_chunk_truncate_like_single_step(pair, mode):
    _, _, port, _ = pair
    p = _prompts()[0]
    base = _run(_port(port, pipeline_decode=False), prompts=[p],
                max_new=(12,))[0]
    gen = base[len(p):]
    stop, eos = gen[4], gen[6]
    for kw, cut in ((dict(stop_token_ids=[stop]), gen.index(stop)),
                    (dict(), gen.index(eos))):
        streamed = []
        eos_id = None if kw else eos
        engine = _port(port, eos_id=eos_id, **mode)
        out = _run(engine, prompts=[p], max_new=(12,),
                   on_token=streamed.append, **kw)[0]
        single = _run(_port(port, eos_id=eos_id, pipeline_decode=False),
                      prompts=[p], max_new=(12,), **kw)[0]
        assert out == single == base[:len(p) + cut + 1]
        assert streamed == out[len(p):]


def test_speculation_preempts_on_a_small_pool():
    """15 usable pages of 4 tokens cannot hold three ~28-token requests at
    once: chunk-lookahead allocation preempts instead of failing."""
    _, _, port = _models('bf16', kv_page_size=4, kv_total_pages=16)
    prompts = [[5, 9, 2, 5, 9, 2, 5, 9], [3, 3, 3, 3],
               [17, 41, 7, 99, 23, 5]]
    engine = pt_batching.ContinuousBatchingEngine(
        port, num_slots=3, max_total_len=28, speculative_k=4)
    plain = pt_batching.ContinuousBatchingEngine(
        port, num_slots=3, max_total_len=28, pipeline_decode=False)
    rows = _run(engine, prompts=prompts, max_new=(20, 20, 20))
    assert engine.preemptions > 0
    for prompt, row in zip(prompts, rows):
        assert row[:len(prompt)] == prompt and len(row) == len(prompt) + 20
    assert rows == _run(plain, prompts=prompts, max_new=(20, 20, 20))


def test_constructor_rules():
    _, _, port = _models('bf16')

    def make(**kw):
        return pt_batching.ContinuousBatchingEngine(
            port, max_total_len=48, **kw)

    for kw in (dict(speculative_k=2), dict(decode_chunk=4)):
        with pytest.raises(ValueError, match='pipeline_decode'):
            make(pipeline_decode=True, **kw)
        eng = make(**kw)       # auto mode turns pipelining off
        assert eng.pipeline_decode is False
        eng.stop()
    eng = make()
    assert eng.pipeline_decode is True and eng.spec_k == 0
    eng.stop()
    with pytest.raises(ValueError, match='decode_chunk'):
        make(speculative_k=2, decode_chunk=4)
    with pytest.raises(ValueError, match='decode_chunk'):
        make(decode_chunk=0)
    # Headroom below max_seq_len (256 for llama-tiny).
    with pytest.raises(ValueError, match='speculative_k=4 needs headroom'):
        pt_batching.ContinuousBatchingEngine(port, max_total_len=254,
                                             speculative_k=4)
    with pytest.raises(ValueError, match='decode_chunk=4 writes'):
        pt_batching.ContinuousBatchingEngine(port, max_total_len=254,
                                             decode_chunk=4)
    # The pool (6 usable pages of 8) must hold max_total_len + K to be
    # paged: paged=True on it raises, and by default the engine takes
    # the dense slot path, as the reference's does.
    _, _, small = _models('bf16', kv_total_pages=7)
    eng = pt_batching.ContinuousBatchingEngine(small, max_total_len=48)
    assert eng.paged is True
    eng.stop()
    with pytest.raises(ValueError, match='chunk-write headroom'):
        pt_batching.ContinuousBatchingEngine(small, max_total_len=48,
                                             speculative_k=2, paged=True)
    eng = pt_batching.ContinuousBatchingEngine(small, max_total_len=48,
                                               speculative_k=2)
    assert eng.paged is False and eng.attention_impl() == 'dense'
    eng.stop()
    eng = make(speculative_k=4)
    # Table rows and limits carry the verify chunk's lookahead.
    assert eng.pages_per_seq == -(-(48 + 4) // 8)
    eng.stop()


def test_serve_lm_flags_and_clamps(capsys):
    from skypilot_tpu_torch.inference.runtime import (build_runtime,
                                                      unsupported_flags)
    from skypilot_tpu_torch.recipes import serve_lm
    base = ['--cpu', '--model', 'llama-tiny', '--continuous-batching',
            '--max-total-len', '256', '--num-slots', '2']
    args = serve_lm.parse_args(base + ['--speculative', '4'])
    assert args.speculative == 4 and unsupported_flags(args) == []
    assert serve_lm.parse_args(base + ['--decode-chunk', '3']).decode_chunk \
        == 3
    cases = (
        (['--speculative', '4'], 252, False,
         'speculative decoding: clamping max_total_len 256 -> 252 (verify '
         'chunk needs K=4 tokens of headroom below max_seq_len=256)'),
        (['--decode-chunk', '3'], 253, False,
         'decode chunking: clamping max_total_len 256 -> 253 (chunk writes '
         'need N=3 tokens of headroom below max_seq_len=256)'),
        ([], 256, True, None),
        (['--no-pipeline-decode'], 256, False, None))
    for extra, total, pipelined, message in cases:
        rt = build_runtime(serve_lm.parse_args(base + extra))
        try:
            assert rt.engine.max_total_len == rt.limit_for() == total
            assert rt.engine.pipeline_decode is pipelined
            printed = capsys.readouterr().out
            if message is not None:
                assert message in printed
            else:
                assert 'clamping' not in printed
        finally:
            rt.stop()
    with pytest.raises(SystemExit, match='no room for the verify chunk'):
        build_runtime(serve_lm.parse_args(base + ['--speculative', '255']))


STATS_KEYS = ('decode_calls', 'tokens_committed', 'tokens_per_call',
              'speculative_k', 'pipeline_decode', 'prefill_chunk',
              'prefill_chunks_run')


def _drive(engine):
    """The same work on an engine whose scheduler thread is stopped,
    iterated on this thread so both engines schedule it identically."""
    engine.stop()
    futs = [engine.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), MAX_NEW)]
    with torch.no_grad():
        for _ in range(500):
            # The reference engine's round in flight is `_inflight`, the
            # port's is `_group_inflight[0]`.
            inflight = getattr(engine, '_inflight', None) or \
                getattr(engine, '_group_inflight', [None])[0]
            if all(f.done() for f in futs) and not engine.active.any() \
                    and inflight is None:
                break
            engine._iterate()  # pylint: disable=protected-access
    return [f.result(timeout=1) for f in futs]


def _stats_body(rt, make):
    server = make(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(
                f'http://127.0.0.1:{server.server_address[1]}/stats',
                timeout=30) as resp:
            return json.loads(resp.read())
    finally:
        server.shutdown()
        thread.join(timeout=10)


@pytest.mark.parametrize('mode', [dict(), dict(speculative_k=4),
                                  dict(decode_chunk=4)],
                         ids=['pipelined', 'spec4', 'chunk4'])
def test_stats_keys_match_reference_replica(mode):
    from skypilot_tpu.inference import http_server as jax_http
    from skypilot_tpu.inference import runtime as jax_runtime
    model, params, port = _models('bf16')
    ref_engine = jax_batching.ContinuousBatchingEngine(model, params,
                                                       **ENGINE_KW, **mode)
    engine = _port(port, **mode)
    assert _drive(engine) == _drive(ref_engine)
    spec = mode.get('speculative_k', 0)
    ref_rt = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=model.config.vocab_size,
        model_name='llama-tiny', max_total_len=64, spec_total=64,
        speculative=spec, engine=ref_engine, engine_total=64)
    ref_body = _stats_body(ref_rt, jax_http.make_server)
    body = _stats_body(InferenceRuntime(engine=engine,
                                        model_name='llama-tiny'),
                       make_server)
    assert {k: body[k] for k in STATS_KEYS} == \
        {k: ref_body[k] for k in STATS_KEYS}
    assert body['tokens_committed'] == sum(MAX_NEW)
    assert body['decode_stall_s'] >= 0.0
    assert body['engine_stats']['graph_replays'] == 0    # no graphs on the CPU


def _plain_step(engine):
    """The engine's plain decode step written out with fresh tensors (no
    static buffers): tokens [B] and the greedy logits' argmax."""
    dev = engine.device
    hidden = engine.model.hidden(
        torch.from_numpy(engine.cur_token).to(dev)[:, None].long(),
        torch.from_numpy(engine.pos).to(dev)[:, None], engine.cache,
        torch.from_numpy(engine.page_table).to(dev))
    return torch.argmax(engine.model.logits(hidden[:, 0]),
                        dim=-1).to(torch.int32).numpy()


def test_round_function_eager_matches_plain_step():
    """DecodeRound.dispatch, run eagerly on its static buffers, gives the
    plain step's tokens; its second step feeds the first's tokens back at
    position + 1 on the device (the chunk and pipelined contract)."""
    _, _, port = _models('int8')
    engine = _port(port, pipeline_decode=False, decode_chunk=2)
    engine.stop()
    for p in _prompts()[:2]:
        engine.submit(p, max_new_tokens=20)
    with torch.no_grad():
        while not engine.active.all():
            engine._iterate()  # pylint: disable=protected-access
        want0 = _plain_step(engine)
        rnd = engine._rounds[0]  # pylint: disable=protected-access
        pending = rnd.dispatch(
            tok=engine.cur_token, pos=engine.pos,
            cont=np.zeros(2, bool), ids=np.zeros(2, np.int32),
            top_k=engine.top_ks, temp=engine.temps, top_p=engine.top_ps,
            table=engine.page_table, selection='greedy', lora=None,
            steps=2)
        got = pending.wait()
        assert got.shape == (2, 2) and got.dtype == np.int32
        np.testing.assert_array_equal(got[0], want0)
        engine.cur_token[:] = want0
        engine.pos += 1
        np.testing.assert_array_equal(got[1], _plain_step(engine))
        np.testing.assert_array_equal(rnd.last_tok.numpy(), got[1])
        np.testing.assert_array_equal(rnd.last_pos.numpy(), engine.pos)
        # A continuing lane ignores the host's token and position.
        pending = rnd.dispatch(
            tok=np.zeros(2, np.int64), pos=np.zeros(2, np.int32),
            cont=np.array([True, False]), ids=np.zeros(2, np.int32),
            top_k=engine.top_ks, temp=engine.temps, top_p=engine.top_ps,
            table=engine.page_table, selection='greedy', lora=None)
        engine.cur_token[:] = got[1]
        engine.pos += 1
        want = _plain_step(engine)
        assert pending.wait()[0, 0] == want[0]
    assert rnd.replays == 0


def test_sample_tokens_over_verify_chunk_logits():
    from skypilot_tpu_torch.models.generate import (filter_logits,
                                                    sample_tokens)
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(
        np.float32))
    temps = torch.tensor([0.0, 0.8, 1.3])
    top_k = torch.tensor([0, 4, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.6])
    out = sample_tokens(logits, temps, top_k, top_p,
                        torch.Generator().manual_seed(0))
    assert out.shape == (3, 5) and out.dtype == torch.int32
    np.testing.assert_array_equal(out[0].numpy(),
                                  logits[0].argmax(-1).numpy())
    kept = torch.isfinite(filter_logits(
        logits / torch.tensor([1e-6, 0.8, 1.3])[:, None, None],
        top_k, top_p))
    assert bool(torch.gather(kept, -1, out.long()[..., None]).all())
    # The filter off is exact where no row filters.
    none_k, none_p = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    a = sample_tokens(logits, temps, none_k, none_p,
                      torch.Generator().manual_seed(1))
    b = sample_tokens(logits, temps, none_k, none_p,
                      torch.Generator().manual_seed(1), apply_filter=False)
    assert torch.equal(a, b)
    assert decode_graph.selection_for(np.zeros(3), np.zeros(3),
                                      np.ones(3)) == 'greedy'
    assert decode_graph.selection_for(np.array([0.0, 0.5]), np.zeros(2),
                                      np.ones(2)) == 'sample'
    assert decode_graph.selection_for(np.array([0.0, 0.5]),
                                      np.array([0, 3]),
                                      np.ones(2)) == 'filter'


def _verify_inputs(quantized, seed, k=4):
    """A verify chunk at Llama-3-8B's G=4 with narrow heads: B=8 rows of
    K+1 queries at their own positions, ending mid-page, on a page's last
    slot and at a page's first, over scattered tables."""
    rng = np.random.default_rng(seed)
    page, pps, hkv, hq, d = 8, 6, 2, 8, 16
    total = 8 * pps + 1
    tbl = (1 + rng.permutation(total - 1)[:8 * pps]).reshape(8, pps)
    shape = (hkv, total, page, d)
    if quantized:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((total, page)) * 0.02).astype(np.float32)
        vs = (rng.random((total, page)) * 0.02).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    ends = np.array([12, 15, 16, 23, 31, 40, 47, 9])   # last position
    pos = (ends[:, None] - k + np.arange(k + 1)).astype(np.int32)
    q = rng.standard_normal((8, k + 1, hq, d)).astype(np.float32)
    return q, kp, vp, pos, tbl.astype(np.int32), ks, vs


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
def test_verify_chunk_attention_pins_and_perturbed_fails(quantized):
    q, kp, vp, pos, tbl, ks, vs = _verify_inputs(quantized, 11)
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(kp), _j(vp), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    args = (_t(q), _t(kp), _t(vp), _t(pos), _t(tbl))
    kw = dict(k_scales=_t(ks), v_scales=_t(vs))
    plain = pk.fused_paged_attention(*args, **kw).numpy()
    np.testing.assert_allclose(plain, pallas, atol=1e-5)
    # The routes the card takes for this shape: chunk at K=4 (5 x 4 = 20
    # rows a kv head); K=3 (4 x 4 = 16) takes the split route, whose
    # plain version is pinned too.
    assert pk.choose_route(torch.bfloat16, torch.bfloat16, 5, 32, 8, 16,
                           128) == 'chunk'
    assert pk.choose_route(torch.bfloat16, torch.int8, 4, 32, 8, 16,
                           128) == 'split'
    split = pk.fused_paged_attention_split_reference(
        _t(q[:, :4]), _t(kp), _t(vp), _t(pos[:, :4]), _t(tbl),
        split_tokens=16, **kw)
    np.testing.assert_allclose(split.numpy(), pallas[:, :4], atol=1e-5)
    bad = pk.fused_paged_attention(*args, perturb=0.5, **kw).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, pallas, atol=1e-5)


def test_pipelined_page_pressure_completes():
    """Two slots on a 14-page pool, two 40-token prompts of 50 new tokens:
    the pipelined loop preempts under page pressure and still answers
    both with the unpipelined loop's tokens (the reference's pipelined
    loop re-admits a preempted request onto the pages the other lane is
    about to need, round after round, and answers neither)."""
    _, _, port = _models('bf16', kv_total_pages=14)
    prompts = [list(range(3, 43)), list(range(50, 90))]
    kw = dict(num_slots=2, max_total_len=96, prefill_chunk=16,
              prefix_caching=False)
    engine = pt_batching.ContinuousBatchingEngine(port, **kw)
    assert engine.pipeline_decode
    got = _run(engine, prompts=prompts, max_new=(50, 50))
    assert engine.preemptions >= 1
    assert engine.allocator.free_pages == engine.total_pages - 1
    plain = pt_batching.ContinuousBatchingEngine(port, pipeline_decode=False,
                                                 **kw)
    assert got == _run(plain, prompts=prompts, max_new=(50, 50))
