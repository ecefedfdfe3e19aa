"""Tensor-parallel serving in the port (parallel/serving.py, the engine on
a grid model) against the JAX package, CPU, f32, grids of CPU devices
named N times (`devices=['cpu'] * N`):

  - the pure functions are the reference's: `kv_shard_ways` over
    (heads, tensor) pairs, `kv_page_bytes` / `pool_pages_for_bytes` with
    `shard_ways`, and their refusals;
  - every shard's tensors of a tensor=2 llama-tiny, bf16 layout and
    int8 projections, equal the reference device's shard from
    `shard_params_for_serving` / `shard_quantized_for_serving` on 2 XLA
    host devices (weights transposed to the port's [out, in]):
    `kernel_q` split as its kernel, `kernel_scale` with the output
    channels of a column shard and whole on a row shard;
  - greedy tokens of the tensor=2 engine equal the single-device
    engine's and the reference's single-device engine's: llama-tiny on
    bf16 and int8 pools, int8 projections, LoRA (adapter ids 0 and 1
    in one batch), the pipelined loop (the default) and --speculative;
    tiny (GPT), mixtral-tiny and deepseek-tiny; and the GQA remainder
    rule, llama-tiny's 2 kv heads over tensor=4 (the pool whole on each
    shard, shard t reading kv head t // 2);
  - a chain exported from tensor=2 imports on one device and re-exports
    byte for byte;
  - a pool shard's storage stays put over rounds, and the all-reduce
    helper refuses a pool shard (the perturbed control of the
    reference's pool-resharding guard);
  - serve_lm's runtime serves --tensor 2 over an explicit device list
    (/stats storage.mesh_devices, page_pool.shard_ways), and with fewer
    distinct devices than asked exits naming the count.
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

from skypilot_tpu.inference import quant as jax_quant
from skypilot_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import deepseek as jax_ds
from skypilot_tpu.models import gpt as jax_gpt
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.models import mixtral as jax_mixtral
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import serving as jax_serving
from skypilot_tpu_torch.inference import kv_transfer, quant
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.parallel import serving
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPTS = ([5, 9, 2, 17], [30, 31, 32], [5, 9, 2, 17, 40])
SPEC_PROMPTS = ([5, 9, 2, 5, 9, 2, 5, 9], [30, 31, 30, 31, 30])
ENGINE_KW = dict(num_slots=2, max_total_len=48)
_MODEL = {jax_llama.LlamaConfig: jax_llama.Llama, jax_gpt.GPTConfig:
          jax_gpt.GPT, jax_mixtral.MixtralConfig: jax_mixtral.Mixtral,
          jax_ds.DeepseekConfig: jax_ds.Deepseek}


def port_config(jax_cfg):
    """The port's config of a reference config (f32)."""
    from skypilot_tpu_torch.models import deepseek, gpt, llama, mixtral
    cls = {jax_llama.LlamaConfig: llama.LlamaConfig,
           jax_gpt.GPTConfig: gpt.GPTConfig,
           jax_mixtral.MixtralConfig: mixtral.MixtralConfig,
           jax_ds.DeepseekConfig: deepseek.DeepseekConfig}[type(jax_cfg)]
    fields = {f.name for f in dataclasses.fields(cls)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'logits_dtype',
                                         'rope_scaling')}
    return cls(dtype=torch.float32, **vals)


def models(jax_cfg, quantized=False):
    """(reference model, its params, the port's model of them)."""
    model = _MODEL[type(jax_cfg)](jax_cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    if quantized:
        params = jax_quant.quantize_params(params)
        model = jax_quant.QuantizedModel(model)
        tree = params
    return model, params, convert.params_from_jax(tree,
                                                  port_config(jax_cfg))


def grid_model(port, stages=1, tensor=2):
    return serving.build(port, MeshConfig(stage=stages, tensor=tensor),
                         devices=['cpu'] * (stages * tensor))


def run(engine, prompts=PROMPTS, n=8, adapters=None):
    adapters = adapters or [None] * len(prompts)
    try:
        futs = [engine.submit(list(p), max_new_tokens=n, adapter=a)
                for p, a in zip(prompts, adapters)]
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


def jax_run(model, params, prompts=PROMPTS, adapters=None, **kw):
    with pp.impl_scope('xla'):
        return run(jax_batching.ContinuousBatchingEngine(
            model, params, **ENGINE_KW, **kw), prompts, adapters=adapters)


@pytest.fixture(scope='module')
def llama():
    return models(jax_llama.LlamaConfig.tiny(
        dtype=jnp.float32, kv_page_size=8, kv_total_pages=40))


# -- the pure functions -------------------------------------------------------
def test_kv_shard_ways_matches_reference():
    for heads in (0, 1, 2, 3, 4, 8, 12):
        for tensor in (1, 2, 3, 4, 8):
            assert serving.kv_shard_ways(heads, tensor) == \
                jax_serving.kv_shard_ways(heads, tensor), (heads, tensor)


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_page_bytes_match_reference(kv_dtype):
    for jcfg in (jax_llama.LlamaConfig.tiny(kv_page_size=16,
                                            kv_total_pages=64),
                 jax_llama.LlamaConfig.llama3_8b(),
                 dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                     num_layers=3)):
        cfg = port_config(jcfg)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        for ways in (1, 2):
            for stages in range(1, cfg.num_layers + 1):
                assert quant.kv_page_bytes(cfg, kv_dtype, ways, stages) == \
                    jax_quant.kv_page_bytes(jcfg, kv_dtype, ways, stages)
                budget = 64 * quant.kv_page_bytes(cfg, kv_dtype)
                assert quant.pool_pages_for_bytes(
                    cfg, kv_dtype, budget, ways, stages) == \
                    jax_quant.pool_pages_for_bytes(jcfg, kv_dtype, budget,
                                                   ways, stages)
        for bad in ((3, 1), (1, cfg.num_layers + 1), (1, 0)):
            with pytest.raises(ValueError):
                quant.kv_page_bytes(cfg, kv_dtype, *bad)
            with pytest.raises(ValueError):
                jax_quant.kv_page_bytes(jcfg, kv_dtype, *bad)


# -- parameter placement ------------------------------------------------------
def _reference_shards(tree, rank: int):
    """Device `rank`'s shard of every leaf of a placed tree, flattened
    to '/'-joined paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = '/'.join(str(p.key) for p in path)
        want = jax.devices()[rank]
        (shard,) = [s for s in leaf.addressable_shards if s.device == want]
        out[key] = np.asarray(shard.data)
    return out


def _reference_path(name: str) -> str:
    """The reference tree path of a port llama state name."""
    parts = name.split('.')
    if parts[0] == 'layers':
        parts = [f'layer_{parts[1]}'] + parts[2:]
    leaf = {'weight': 'kernel', 'weight_q': 'kernel_q',
            'weight_scale': 'kernel_scale'}.get(parts[-1], parts[-1])
    return '/'.join(parts[:-1] + [leaf])


@pytest.mark.parametrize('quantized', [False, True])
def test_shards_equal_reference_placement(quantized):
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                      kv_total_pages=40)
    model, params, port = models(jcfg, quantized)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tensor=2),
                              devices=jax.devices()[:2])
    placed = (jax_quant.shard_quantized_for_serving(model, params, mesh)
              if quantized else
              jax_serving.shard_params_for_serving(model, params, mesh))
    gm = grid_model(port)
    checked = set()
    for rank in range(2):
        ref = _reference_shards(placed, rank)
        state = dict(gm.edges[rank].state_dict())
        for i, shards in enumerate(gm.blocks):
            state.update({f'layers.{i}.{k}': v for k, v in
                          shards[rank].state_dict().items()})
        for name, got in state.items():
            want = ref[_reference_path(name)]
            if name in ('lm_head',) or name.endswith(('.weight',
                                                      '.weight_q')):
                want = want.T
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            checked.add(name)
    assert len(checked) == len(port.state_dict())
    scale = gm.blocks[0][1].state_dict()
    if quantized:    # a column shard's scales are its channels' only
        assert scale['attn.wq.weight_scale'].shape == (64,)
        assert scale['attn.wo.weight_scale'].shape == (128,)


# -- greedy tokens ------------------------------------------------------------
def _three_ways(jax_model, params, port, prompts=PROMPTS, tensor=2, **kw):
    """(reference single-device, port single-device, port grid) tokens."""
    ref = jax_run(jax_model, params, prompts, **kw)
    one = run(pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW, **kw),
              prompts)
    eng = pt_batching.ContinuousBatchingEngine(
        grid_model(port, tensor=tensor), **ENGINE_KW, **kw)
    return ref, one, run(eng, prompts), eng


@pytest.mark.parametrize('variant', ['bf16', 'int8kv', 'int8w', 'spec'])
def test_llama_tensor2_tokens(llama, variant):
    jax_model, params, port = llama
    kw, prompts = {}, PROMPTS
    if variant == 'int8kv':
        jcfg = dataclasses.replace(jax_model.config, kv_dtype='int8')
        jax_model, params, port = models(jcfg)
    elif variant == 'int8w':
        jax_model, params, port = models(jax_model.config, quantized=True)
    elif variant == 'spec':
        kw, prompts = {'speculative_k': 3}, SPEC_PROMPTS
    ref, one, got, eng = _three_ways(jax_model, params, port, prompts, **kw)
    assert got == one == ref
    assert eng.kv_shard_ways == 2 and eng.mesh_devices == 2
    assert eng.pipeline_decode == (variant != 'spec')


def test_llama_lora_tensor2_tokens(llama, tmp_path):
    jax_model, params, port = llama
    spec = jax_lora.LoraSpec(rank=4, alpha=8.0,
                             targets=jax_lora.targets_from_name('attn-mlp'))
    lp = jax_lora.random_adapter_params(0, jax_model.config, spec)
    for layer in lp.values():
        for tgt in layer.values():
            tgt['b'] *= 60.0     # deltas that flip greedy tokens
    jax_lora.save_adapter(str(tmp_path / 'ad0'), lp, spec,
                          base_model='llama-tiny')
    ids = ['ad0', None, 'ad0']        # adapter ids 1, 0, 1 in one batch
    with pp.impl_scope('xla'):
        ref = run(jax_batching.ContinuousBatchingEngine(
            jax_model, params, adapter_store=JaxRegistry(
                str(tmp_path), jax_model, max_adapters=2), **ENGINE_KW),
            adapters=ids)
    one = run(pt_batching.ContinuousBatchingEngine(
        port, adapter_store=AdapterRegistry(str(tmp_path), port,
                                            max_adapters=2),
        **ENGINE_KW), adapters=ids)
    gm = grid_model(port)
    reg = AdapterRegistry(str(tmp_path), gm, max_adapters=2, mesh=gm.grid)
    got = run(pt_batching.ContinuousBatchingEngine(
        gm, adapter_store=reg, **ENGINE_KW), adapters=ids)
    assert got == one == ref
    assert got[0] != got[1][:len(got[0])] or got[0][:4] != got[1][:4]
    stack = reg.model_lora()['shards']
    # B of the q projection splits with the heads; A of wo by its rows.
    assert stack[0]['layer_0']['wq']['b'].shape[-1] == 64
    assert stack[1]['layer_0']['wo']['a'].shape[1] == 64


@pytest.mark.parametrize('family', ['gpt', 'mixtral', 'deepseek'])
def test_other_families_tensor2_tokens(family):
    cls = {'gpt': jax_gpt.GPTConfig, 'mixtral': jax_mixtral.MixtralConfig,
           'deepseek': jax_ds.DeepseekConfig}[family]
    extra = {} if family == 'deepseek' else dict(kv_page_size=8,
                                                 kv_total_pages=40)
    jax_model, params, port = models(cls.tiny(dtype=jnp.float32, **extra))
    ref, one, got, eng = _three_ways(jax_model, params, port,
                                     prompts=PROMPTS[:1])
    assert got == one == ref
    assert eng.paged == (family != 'deepseek')


def test_gqa_remainder_rule_tensor4_tokens(llama):
    """2 kv heads over tensor=4: the pool is whole on every shard, the
    q heads split, and shard t reads kv head t // 2."""
    jax_model, params, port = llama
    ref, one, got, eng = _three_ways(jax_model, params, port, tensor=4)
    assert got == one == ref
    assert eng.kv_shard_ways == 1
    assert eng.model.read_heads == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert eng.kv_cache_bytes_per_device() == eng.kv_cache_bytes()


# -- KV chains, the pool guard ------------------------------------------------
def _payload(data: bytes) -> bytes:
    off = len(kv_transfer.MAGIC)
    hlen = int.from_bytes(data[off:off + 8], 'big')
    return data[off + 8 + hlen:]


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_chain_from_tensor2_reexports_same_bytes(kv_dtype):
    cfg = LlamaConfig.tiny(dtype=torch.float32, kv_page_size=8,
                           kv_total_pages=40, kv_dtype=kv_dtype)
    port = convert.init_params(cfg, seed=0)
    prompt = list(range(2, 34))      # 4 full 8-token pages
    src = pt_batching.ContinuousBatchingEngine(grid_model(port),
                                               **ENGINE_KW)
    dst = pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW)
    try:
        ref = src.submit(prompt, max_new_tokens=8).result(timeout=180)
        data = src.export_chain(prompt)
        meta, _ = kv_transfer.unpack_pages(data)
        assert meta['num_kv_heads'] == cfg.num_kv_heads
        assert meta['num_layers'] == cfg.num_layers
        summary = dst.import_chain(data)
        assert summary['imported'] == 4 and summary['dropped'] == 0
        assert dst.submit(prompt, max_new_tokens=8).result(
            timeout=180) == ref
        assert _payload(dst.export_chain(prompt)) == _payload(data)
    finally:
        src.stop()
        dst.stop()


def test_pool_shards_stay_put_and_the_helper_refuses_them():
    cfg = LlamaConfig.tiny(dtype=torch.float32, kv_page_size=8,
                           kv_total_pages=40)
    gm = grid_model(convert.init_params(cfg, seed=0))
    eng = pt_batching.ContinuousBatchingEngine(gm, **ENGINE_KW)
    before = eng.cache.data_ptrs()
    run(eng)
    assert eng.decode_calls > 0 and eng.cache.data_ptrs() == before
    shard = eng.cache.shards[0][1].layers[0]['k_pages']
    assert shard.shape[0] == cfg.num_kv_heads // 2
    reductions = gm.grid.reductions
    with pytest.raises(ValueError, match='pool shard'):
        gm.grid.all_reduce([eng.cache.shards[0][0].layers[0]['k_pages'],
                            shard])
    with pytest.raises(ValueError, match='pool shard'):   # a view too
        gm.grid.all_reduce([shard[:, 1:3], shard[:, 1:3]])
    assert gm.grid.reductions == reductions


# -- serve_lm -----------------------------------------------------------------
def _args(*extra):
    return serve_lm.parse_args(['--cpu', '--model', 'llama-tiny',
                                '--continuous-batching', '--num-slots', '2',
                                '--max-total-len', '48', *extra])


def test_runtime_serves_tensor2_over_a_device_list():
    rt = build_runtime(_args('--tensor', '2'), devices=['cpu', 'cpu'])
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate',
            data=json.dumps({'tokens': [PROMPTS[0]],
                             'max_new_tokens': 4}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())['tokens'][0]
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                    timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=30)
    assert len(out) == len(PROMPTS[0]) + 4
    assert stats['storage']['mesh_devices'] == 2
    assert stats['storage']['stages'] == 1
    assert stats['page_pool']['shard_ways'] == 2
    assert stats['page_pool']['pool_bytes_per_device'] * 2 == \
        stats['page_pool']['pool_bytes']


def test_too_few_distinct_devices_exits_naming_the_count():
    with pytest.raises(SystemExit, match='needs 2 distinct devices; 1 CPU'):
        build_runtime(_args('--tensor', '2'))
    with pytest.raises(ValueError, match='lists 3 devices'):
        build_runtime(_args('--tensor', '2'), devices=['cpu'] * 3)
    with pytest.raises(ValueError, match='stage and tensor axes only'):
        serving.make_grid(MeshConfig(data=2, tensor=2), cpu=True)


def test_one_shot_mode_serves_tensor2(llama):
    """The one-shot engine's dense cache is the grid's too."""
    from skypilot_tpu_torch.models import generate as gen
    _, _, port = llama
    prompt = torch.tensor([PROMPTS[0]])
    want = gen.make_generate_fn(port, 12)(prompt, None)
    got = gen.make_generate_fn(grid_model(port), 12)(prompt, None)
    assert torch.equal(got, want)
