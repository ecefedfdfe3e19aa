"""Tensor x pipeline serving in the port (parallel/serving.py stage split,
the engine's decode ring) against the JAX package, CPU, f32, grids of
CPU devices named N times:

  - `stage_layer_ranges` is the reference's, errors included; the page
    math with `stages` is covered with `shard_ways` in
    test_torch_tp_serving.py; the prefill bubble the engine reports is
    the reference schedule's closed form (S-1)/(M+S-1);
  - greedy tokens of stages=2 (tensor 1) and stages=2 x tensor=2 engines
    equal the single-device engine's (and on bf16 and int8 pools the
    reference's): bf16 and int8 pools, chunked prefill, --speculative
    and an active LoRA adapter;
    the pipelined loop runs the S-deep ring (one round a slot group);
  - the per-device pool is a quarter of the single-device pool on 2 x 2
    and /stats' per-stage view shows each stage's layers;
  - a chain exported from a staged pool imports on one device, serves
    the same tokens, re-exports byte for byte and imports back into a
    staged pool; a chain of another depth is refused;
  - the staged engine refuses what it cannot serve (the reference's
    list) and serve_lm's --stages refusals are the reference's argparse
    errors, word for word.
"""
import dataclasses
import re
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu.parallel import serving as jax_serving
from skypilot_tpu.parallel.pipeline_schedule import make_inference_schedule
from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.parallel import serving
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPTS = ([5, 9, 2, 17], [30, 31, 32], [5, 9, 2, 17, 40])
ENGINE_KW = dict(num_slots=4, max_total_len=48)


def port_config(jax_cfg) -> LlamaConfig:
    fields = {f.name for f in dataclasses.fields(LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return LlamaConfig(dtype=torch.float32, **vals)


def models(kv_dtype='bf16'):
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_total_pages=40, kv_dtype=kv_dtype)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    return model, params, convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        port_config(cfg))


def grid_model(port, stages=2, tensor=1):
    return serving.build(port, MeshConfig(stage=stages, tensor=tensor),
                         devices=['cpu'] * (stages * tensor))


def run(engine, prompts=PROMPTS, n=8, adapter=None):
    try:
        futs = [engine.submit(list(p), max_new_tokens=n, adapter=adapter)
                for p in prompts]
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


@pytest.fixture(scope='module')
def llama():
    return models()


def test_stage_layer_ranges_match_reference():
    for layers in range(1, 9):
        for stages in range(0, 10):
            try:
                want = jax_serving.stage_layer_ranges(layers, stages)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    serving.stage_layer_ranges(layers, stages)
                continue
            assert serving.stage_layer_ranges(layers, stages) == want


@pytest.mark.parametrize('variant', ['bf16', 'int8kv', 'chunk_prefill',
                                     'spec'])
def test_staged_engine_tokens(llama, variant):
    """stages=2 and 2 x 2 give the single-device tokens (the port's and
    the reference's): the ring and the stage chain change only when
    work runs, never what it computes."""
    jax_model, params, port = llama
    kw, prompts = {}, PROMPTS
    if variant == 'int8kv':
        jax_model, params, port = models('int8')
    elif variant == 'chunk_prefill':
        kw['prefill_chunk'] = 4
        prompts = PROMPTS + ([5, 9, 2, 17, 40, 41, 42, 43, 44],)
    elif variant == 'spec':
        kw['speculative_k'] = 3
        prompts = ([5, 9, 2, 5, 9, 2, 5, 9], [30, 31, 30, 31, 30])
    ref = run(pt_batching.ContinuousBatchingEngine(
        port, **ENGINE_KW, **kw), prompts)
    if variant in ('bf16', 'int8kv'):
        # (test_torch_serving.py and test_torch_decode_modes.py hold the
        # single-device engine to the reference's in the other modes.)
        with pp.impl_scope('xla'):
            assert run(jax_batching.ContinuousBatchingEngine(
                jax_model, params, **ENGINE_KW, **kw), prompts) == ref
    for stages, tensor in ((2, 1), (2, 2)):
        eng = pt_batching.ContinuousBatchingEngine(
            grid_model(port, stages, tensor), **ENGINE_KW, **kw)
        assert eng.stages == 2
        # The pipelined loop is the ring: one round a slot group.
        rounds = eng._rounds  # pylint: disable=protected-access
        assert len(rounds) == (1 if variant == 'spec' else 2)
        assert run(eng, prompts) == ref, (stages, tensor)
        if variant == 'chunk_prefill':
            chunks = eng.prefill_chunks_run
            assert chunks > 1
            assert eng.prefill_bubble_fraction > 0


def test_prefill_bubble_is_the_schedules_closed_form(llama):
    _, _, port = llama
    eng = pt_batching.ContinuousBatchingEngine(
        grid_model(port), prefill_chunk=4, prefill_budget=12, **ENGINE_KW)
    try:
        # One prefill pass of 3 chunks through 2 stages.
        eng.submit(list(range(2, 14)), max_new_tokens=2).result(timeout=180)
        want = make_inference_schedule(2, 3).bubble_fraction
        assert eng.prefill_bubble_fraction == pytest.approx(want)
    finally:
        eng.stop()


def test_staged_lora_tokens(llama, tmp_path):
    jax_model, _, port = llama
    spec = jax_lora.LoraSpec(rank=4, alpha=8.0)
    lp = jax_lora.random_adapter_params(0, jax_model.config, spec)
    for layer in lp.values():
        for tgt in layer.values():
            tgt['b'] *= 60.0
    jax_lora.save_adapter(str(tmp_path / 'ad0'), lp, spec,
                          base_model='llama-tiny')
    ref = run(pt_batching.ContinuousBatchingEngine(
        port, adapter_store=AdapterRegistry(str(tmp_path), port,
                                            max_adapters=2), **ENGINE_KW),
        PROMPTS[:2], adapter='ad0')
    for stages, tensor in ((2, 1), (2, 2)):
        gm = grid_model(port, stages, tensor)
        reg = AdapterRegistry(str(tmp_path), gm, max_adapters=2,
                              mesh=gm.grid)
        got = run(pt_batching.ContinuousBatchingEngine(
            gm, adapter_store=reg, **ENGINE_KW), PROMPTS[:2],
            adapter='ad0')
        assert got == ref, (stages, tensor)
        # Layer 1's factors live on stage 1's devices.
        assert reg.model_lora()['shards'][0]['layer_1']['wq']['a'].device \
            == gm.layer_device(1, 0)


def test_staged_pool_split_accounting(llama):
    _, _, port = llama
    eng = pt_batching.ContinuousBatchingEngine(grid_model(port, 2, 2),
                                               **ENGINE_KW)
    ref = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        assert eng.kv_cache_bytes_per_device() * 4 == \
            ref.kv_cache_bytes_per_device()
        assert eng.kv_cache_bytes() == ref.kv_cache_bytes()
        stats = eng.stage_pool_stats()
        assert [st['layers'] for st in stats] == [[0, 1], [1, 2]]
        assert all(st['pages'] == eng.total_pages for st in stats)
        assert ref.stage_pool_stats() == []
        assert eng.attention_bytes_per_token()['weight_bytes_amortized'] < \
            ref.attention_bytes_per_token()['weight_bytes_amortized']
    finally:
        eng.stop()
        ref.stop()


def _payload(data):
    off = len(kv_transfer.MAGIC)
    hlen = int.from_bytes(data[off:off + 8], 'big')
    return data[off + 8 + hlen:]


def test_chain_across_stage_splits(llama):
    _, _, port = llama
    prompt = list(range(2, 34))
    src = pt_batching.ContinuousBatchingEngine(grid_model(port, 2, 1),
                                               **ENGINE_KW)
    dst = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    src2 = pt_batching.ContinuousBatchingEngine(grid_model(port, 2, 2),
                                                **ENGINE_KW)
    try:
        ref = src.submit(prompt, max_new_tokens=8).result(timeout=180)
        data = src.export_chain(prompt)
        assert dst.import_chain(data)['imported'] == 4
        assert dst.submit(prompt, max_new_tokens=8).result(
            timeout=180) == ref
        back = dst.export_chain(prompt)
        assert _payload(back) == _payload(data)
        src2.import_chain(back)
        assert src2.submit(prompt, max_new_tokens=8).result(
            timeout=180) == ref
        assert _payload(src2.export_chain(prompt)) == _payload(data)
    finally:
        src.stop()
        dst.stop()
        src2.stop()


def test_chain_header_refuses_a_layer_mismatch(llama):
    _, _, port = llama
    deep = convert.init_params(dataclasses.replace(port.config,
                                                   num_layers=3), seed=0)
    src = pt_batching.ContinuousBatchingEngine(grid_model(port),
                                               **ENGINE_KW)
    dst = pt_batching.ContinuousBatchingEngine(deep, **ENGINE_KW)
    try:
        prompt = list(range(2, 34))
        src.submit(prompt, max_new_tokens=4).result(timeout=180)
        with pytest.raises(ValueError, match='num_layers'):
            dst.import_chain(src.export_chain(prompt))
    finally:
        src.stop()
        dst.stop()


def test_staged_engine_refusals(llama):
    _, _, port = llama
    gm = grid_model(port)
    for kw in ({'paged': False}, {'decode_chunk': 4}, {'num_slots': 3}):
        base = dict(ENGINE_KW, **kw)
        with pytest.raises(ValueError):
            pt_batching.ContinuousBatchingEngine(gm, **base)
    int8 = convert.init_params(port.config, seed=0, weight_dtype='int8')
    with pytest.raises(ValueError, match='int8 WEIGHTS'):
        pt_batching.ContinuousBatchingEngine(grid_model(int8), **ENGINE_KW)
    from skypilot_tpu_torch.models.gpt import GPTConfig
    gpt = convert.init_params(GPTConfig.tiny(dtype=torch.float32), seed=0)
    with pytest.raises(ValueError, match='Llama family'):
        grid_model(gpt)


_REFUSALS = (
    ['--stages', '2'],
    ['--stages', '2', '--continuous-batching', '--weight-dtype', 'int8'],
    ['--stages', '2', '--continuous-batching', '--decode-chunk', '4'],
    ['--stages', '2', '--continuous-batching', '--num-slots', '3'],
)


def test_serve_lm_stage_refusals_match_reference(capsys, monkeypatch):
    from skypilot_tpu.recipes import serve_lm as ref_serve_lm
    for argv in _REFUSALS:
        # The reference's main parses sys.argv and exits on these before
        # it builds anything.
        monkeypatch.setattr(sys, 'argv', ['serve_lm', *argv])
        with pytest.raises(SystemExit) as exc:
            ref_serve_lm.main()
        assert exc.value.code == 2
        want = capsys.readouterr().err.strip().splitlines()[-1]
        with pytest.raises(SystemExit) as exc:
            serve_lm.parse_args(['--cpu', *argv])
        assert exc.value.code == 2
        got = capsys.readouterr().err.strip().splitlines()[-1]
        # The same message; the program names differ.
        assert got.split('error: ', 1)[1] == want.split('error: ', 1)[1]
        assert '--stages' in got
