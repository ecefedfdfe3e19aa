"""The slot engine's dense path (models/batching.py, `paged=False`)
against the JAX reference engine's, CPU, f32, on the same seeded
weights:

  - every family on the dense path: DeepSeek (no page pool: always
    dense), and llama-tiny, tiny (GPT) and mixtral-tiny built with
    `paged=False` on a pool that could hold them, or auto on a pool
    that cannot hold one max_total_len sequence (`engine.paged is
    False` on both sides). In every mode the port's greedy tokens are
    the JAX engine's in the same mode: the plain (unpipelined) loop,
    the pipelined loop (the default), --prefill-chunk with a partial
    last chunk, --decode-chunk 4 and --speculative 4; speculation gives
    the plain loop's tokens but for Mixtral, whose capacity follows the
    chunk (in the reference as well);
  - llama-tiny with two adapters (written by the reference's
    save_adapter) on the dense path gives the JAX dense engine's tokens,
    through the QKV LoRA route in prefill chunks and decode rounds;
  - the dense engine's refusals name their reason: paged=True on a
    small pool, the spill flags, import_chain; prefix caching is off,
    export_chain gives nothing, a reset zeroes the rows in place;
  - the CPU counterpart of examples/serve_hf_llama.yaml: serve_lm
    --hf DIR --max-total-len 2048 --continuous-batching on a tiny
    LlamaForCausalLM (the default 128-page pool holds 2032 tokens)
    serves /generate on the dense path, as the reference's engine on the
    same checkpoint does.
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

from skypilot_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import deepseek as jax_ds
from skypilot_tpu.models import gpt as jax_gpt
from skypilot_tpu.models import hf_import as jax_hf
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.models import mixtral as jax_mixtral
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.ops import lora_kernel as lk
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_TOTAL = 48
MAX_NEW = (6, 12, 9)
#: The modes of the same-mode comparison (engine kwargs).
#: (The pipelined default is `plain_tokens`, with paged=False.)
MODES = {
    'plain': {'pipeline_decode': False},
    'chunked': {'prefill_chunk': 8},
    'decode_chunk4': {'decode_chunk': 4},
    'speculative4': {'speculative_k': 4},
}
#: (JAX config class, the small pool that cannot hold MAX_TOTAL tokens:
#: 4 pages of 8 = 24 usable, or none for DeepSeek).
FAMILIES = {
    'llama': (jax_llama.LlamaConfig, dict(kv_page_size=8,
                                          kv_total_pages=4)),
    'gpt': (jax_gpt.GPTConfig, dict(kv_page_size=8, kv_total_pages=4)),
    'mixtral': (jax_mixtral.MixtralConfig, dict(kv_page_size=8,
                                                kv_total_pages=4)),
    'deepseek': (jax_ds.DeepseekConfig, {}),
}
_MODEL = {jax_llama.LlamaConfig: jax_llama.Llama, jax_gpt.GPTConfig:
          jax_gpt.GPT, jax_mixtral.MixtralConfig: jax_mixtral.Mixtral,
          jax_ds.DeepseekConfig: jax_ds.Deepseek}


def port_config(jax_cfg):
    """The port's config of a reference config (f32)."""
    from skypilot_tpu_torch.models import (deepseek, gpt, llama,
                                           mixtral)
    cls = {jax_llama.LlamaConfig: llama.LlamaConfig,
           jax_gpt.GPTConfig: gpt.GPTConfig,
           jax_mixtral.MixtralConfig: mixtral.MixtralConfig,
           jax_ds.DeepseekConfig: deepseek.DeepseekConfig}[type(jax_cfg)]
    fields = {f.name for f in dataclasses.fields(cls)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'logits_dtype',
                                         'rope_scaling')}
    return cls(dtype=torch.float32, **vals)


def _prompts():
    rng = np.random.default_rng(11)
    loop = [5, 9, 2, 17, 5, 9, 2, 17, 5, 9]      # drafts get accepted
    return [loop + rng.integers(1, 512, 3).tolist(),
            rng.integers(1, 512, 21).tolist(),     # 8 + 8 + 5 chunks
            rng.integers(1, 512, 6).tolist()]


def _run(engine, prompts=None, max_new=MAX_NEW, **submit_kw):
    prompts = prompts or _prompts()
    futs = [engine.submit(p, max_new_tokens=n, **submit_kw)
            for p, n in zip(prompts, max_new)]
    try:
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def family(request):
    """(name, JAX model on the small pool, params, port model on it, the
    port model on the default pool, sharing its weights)."""
    cfg_cls, small = FAMILIES[request.param]
    cfg = cfg_cls.tiny(dtype=jnp.float32)
    model = _MODEL[cfg_cls](cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        port_config(cfg))
    small_cfg = dataclasses.replace(cfg, **small)
    small_port = convert.assemble(port_config(small_cfg),
                                  port.state_dict())
    return (request.param, _MODEL[cfg_cls](small_cfg), params, small_port,
            port)


@pytest.fixture(scope='module')
def plain_tokens(family):
    """The pipelined loop (the default mode): the port's tokens on the
    default pool with paged=False, held to the JAX engine's with
    paged=False; every other mode is held to them."""
    name, small_model, params, _, port = family
    engine = pt_batching.ContinuousBatchingEngine(
        port, num_slots=2, max_total_len=MAX_TOTAL, paged=False)
    assert engine.paged is False and engine.prefix_caching is False
    assert engine.attention_impl() == 'dense'
    got = _run(engine)
    jax_model = _MODEL[type(small_model.config)](
        dataclasses.replace(small_model.config,
                            **({} if name == 'deepseek' else
                               dict(kv_total_pages=64))))
    ref = jax_batching.ContinuousBatchingEngine(
        jax_model, params, num_slots=2, max_total_len=MAX_TOTAL,
        paged=False)
    assert ref.paged is False
    assert got == _run(ref)
    for out, prompt, n in zip(got, _prompts(), MAX_NEW):
        assert out[:len(prompt)] == prompt and len(out) == len(prompt) + n
    return got


@pytest.mark.parametrize('mode', sorted(MODES))
def test_dense_engine_matches_the_jax_engine(family, plain_tokens, mode):
    name, small_model, params, small_port, _ = family
    kw = dict(num_slots=2, max_total_len=MAX_TOTAL, **MODES[mode])
    engine = pt_batching.ContinuousBatchingEngine(small_port, **kw)
    ref = jax_batching.ContinuousBatchingEngine(small_model, params, **kw)
    assert engine.paged is False and ref.paged is False
    assert engine.pages_per_seq == 0
    got = _run(engine)
    assert got == _run(ref)
    if name != 'mixtral':
        assert got == plain_tokens
    if mode == 'chunked':
        assert engine.prefill_chunks_run == 2 + 3 + 1


# -- LoRA on the dense path ------------------------------------------------
SPEC = jax_lora.LoraSpec(rank=4, alpha=8.0)


def test_llama_adapters_on_the_dense_path_match_the_jax_engine(tmp_path):
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_total_pages=4)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        port_config(cfg))
    for i in range(2):
        lp = jax_lora.random_adapter_params(i, cfg, SPEC)
        for layer in lp.values():
            for tgt in layer.values():
                tgt['b'] *= 60.0     # deltas that flip greedy tokens
        jax_lora.save_adapter(str(tmp_path / f'ad{i}'), lp, SPEC,
                              base_model='llama-tiny')
    prompt = list(range(2, 22))
    specs = [(None, 4), ('ad0', 10), ('ad1', 10), (None, 6)]

    def run(engine):
        futs = [engine.submit(prompt, max_new_tokens=n, adapter=a)
                for a, n in specs]
        try:
            return [f.result(timeout=180) for f in futs]
        finally:
            engine.stop()

    kw = dict(num_slots=3, max_total_len=MAX_TOTAL, prefill_chunk=16)
    with pp.impl_scope('xla'):
        want = run(jax_batching.ContinuousBatchingEngine(
            model, params, adapter_store=JaxRegistry(str(tmp_path), model,
                                                     max_adapters=2), **kw))
    reg = AdapterRegistry(str(tmp_path), port, max_adapters=2)
    engine = pt_batching.ContinuousBatchingEngine(port, adapter_store=reg,
                                                  **kw)
    assert engine.paged is False
    plain0 = lk.plain_calls
    got = run(engine)
    assert got == want
    assert len({tuple(o) for o in got[:3]}) == 3   # three real streams
    assert got[3][:len(got[0])] == got[0]
    assert lk.plain_calls > plain0                 # the QKV path ran
    assert reg.stats()['requests'] == {'ad0': 1, 'ad1': 1}


# -- refusals and bookkeeping ---------------------------------------------
def test_dense_engine_refusals_and_reset(family):
    name, _, _, small_port, port = family
    if name != 'deepseek':
        with pytest.raises(ValueError, match='paged=True but '
                           'kv_total_pages=4 x kv_page_size=8 cannot hold'):
            pt_batching.ContinuousBatchingEngine(
                small_port, max_total_len=MAX_TOTAL, paged=True)
    with pytest.raises(ValueError, match='kv_spill_bytes/kv_cold_dir need '
                       'the paged engine'):
        pt_batching.ContinuousBatchingEngine(
            small_port, max_total_len=MAX_TOTAL, kv_spill_bytes=1 << 20)
    engine = pt_batching.ContinuousBatchingEngine(
        small_port, num_slots=2, max_total_len=MAX_TOTAL)
    try:
        assert engine.paged is False and engine.prefix_cache is None
        assert engine.stats()['prefix_cache'] is None
        assert engine.export_chain(list(range(2, 40))) is None
        with pytest.raises(ValueError, match='import_chain needs the paged '
                           'engine with prefix caching enabled'):
            engine.import_chain(b'')
        assert engine.submit([3, 4, 5], max_new_tokens=4).result(
            timeout=60)[:3] == [3, 4, 5]
        storage = [t.data_ptr() for layer in engine.cache.layers
                   for t in layer.values()]
        assert any(bool(t.any()) for layer in engine.cache.layers
                   for t in layer.values())
        def lose_the_rows():
            engine._pool_at_risk = True    # an error mid-dispatch
            engine._recover_from_error(RuntimeError('rows lost'))
        engine.run_on_scheduler(lose_the_rows)
        assert engine.engine_restarts == 1
        assert not any(bool(t.any()) for layer in engine.cache.layers
                       for t in layer.values())
        assert [t.data_ptr() for layer in engine.cache.layers
                for t in layer.values()] == storage
        assert engine.submit([3, 4, 5], max_new_tokens=4).result(
            timeout=60)[:3] == [3, 4, 5]
    finally:
        engine.stop()


# -- the examples' command line ---------------------------------------------
def test_serve_hf_llama_example_runs_dense_as_the_reference(tmp_path):
    """examples/serve_hf_llama.yaml's serve_lm line on a tiny local
    checkpoint whose max_position_embeddings is 2048: the default pool
    (127 usable pages of 16 = 2032 tokens) cannot hold 2048, so both
    engines run dense instead of refusing."""
    import transformers
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=2048)).save_pretrained(
            str(tmp_path), safe_serialization=True)
    jmodel, jparams = jax_hf.load_hf_checkpoint(str(tmp_path),
                                                max_seq_len=2048,
                                                dtype=jnp.float32)
    ref = jax_batching.ContinuousBatchingEngine(
        jmodel, jparams, num_slots=2, max_total_len=2048)
    ref.stop()
    assert ref.paged is False
    rt = build_runtime(serve_lm.parse_args(
        ['--cpu', '--hf', str(tmp_path), '--max-total-len', '2048',
         '--continuous-batching', '--num-slots', '2']))
    server = make_server(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert rt.engine.paged is False
        assert rt.engine.model.config.kv_total_pages == 128
        prompt = [5, 9, 2, 17, 5, 9]
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.server_address[1]}/generate',
            data=json.dumps({'tokens': [prompt],
                             'max_new_tokens': 6}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())['tokens'][0]
        assert len(got) == len(prompt) + 6 and got[:len(prompt)] == prompt
        # The dense rows: 2 slots x 2048 positions x K and V x 1 head x 16.
        assert rt.engine.kv_cache_bytes() == 2 * 2048 * 2 * 16 * 2
    finally:
        server.shutdown()
        rt.stop()
    assert os.path.exists(tmp_path / 'config.json')
