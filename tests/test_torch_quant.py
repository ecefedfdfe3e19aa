"""int8 projection weights (`--weight-dtype int8`) in the port against
the reference (skypilot_tpu/inference/quant.py `quantize_params` and
`QuantizedModel`), CPU, llama-tiny and qwen-tiny (and the other
families at the end):

  - bytes: the port's `quantize_params` and `quantize_kernel` give the
    reference's int8 values and f32 scales byte for byte on the same f32
    tree, a constant column round-trips exactly and an all-zero column
    quantizes to scale 0, q 0; only the projections quantize, each
    within scale / 2 (the reference's bounds);
  - bridge: `params_from_jax` on the reference's quantized tree equals
    `params_from_jax(..., weight_dtype='int8')` on the f32 tree, buffer
    for buffer; the HF importer quantizes the checkpoint's f32 values
    as the reference's quantize_params of its import does;
  - logits: the port's int8 `Llama` within atol = rtol = 1e-4 of
    `QuantizedModel.apply` (f32: sums in another order);
  - tokens: greedy tokens of the port's slot engine (bf16 and int8
    pools) and one-shot engine on the int8 model equal the reference
    engines' on `QuantizedModel`, exactly, under f32;
  - the reference's contract (LOGPROB_TOL = 0.1 nats a token, its
    tests/unit_tests/test_quantized_serving.py): int8 continuations
    scored by the bf16 runtime's scoring pass, and LoRA on the int8 base
    against the merged-weights oracle with a loud adapter;
  - exact contracts within the port under int8 weights: pipelined ==
    unpipelined, --decode-chunk 4 == stepwise, --speculative == plain,
    chunked prefill == whole-prompt prefill;
  - the kernel's plain version against numpy (f32 within 1e-6 relative
    Frobenius; bf16 within 1e-2, its output rounding), the dispatch
    rules, the perturbed control, the grid plan;
  - bytes counted (buffers included), /stats `storage`, the gauges, the
    refusal of --ckpt-dir in the reference's words, serve_lm
    --weight-dtype int8 serving through both engines, and --param-dtype
    f32 applying to the leaves that stay dense;
  - DeepSeek and Mixtral (deepseek-tiny, mixtral-tiny): the quantized
    leaves are exactly the reference's (wq / wo / the SwiGLU; the four
    attention projections, expert stacks dense), bytes equal, the slot
    engine's tokens equal the reference engine's on QuantizedModel, the
    0.1-nat contract holds, and serve_lm --weight-dtype int8 serves.
"""
import ast
import dataclasses
import json
import threading
import urllib.request
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import quant as jax_quant
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import generate as jax_generate
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.recipes.train_lm import _build_model
from skypilot_tpu_torch.inference import quant
from skypilot_tpu_torch.inference import runtime as pt_runtime
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import generate as pt_generate
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.ops import int8_linear as il
from skypilot_tpu_torch.recipes import serve_lm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
#: The reference's documented tolerance: mean per-token log-prob of a
#: quantized greedy continuation, scored by the exact scorer, within
#: this of the unquantized path's.
LOGPROB_TOL = 0.1
#: Teacher-forced logits, port vs reference, f32: sums in another order.
LOGITS_TOL = 1e-4
ENGINE_KW = dict(num_slots=2, max_total_len=48)
PROMPTS = ([5, 9, 2, 17], [30, 31, 32, 33, 34], [7] * 12)
MAX_NEW = 10


def _port_config(cfg, **kw) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(**{**vals, 'dtype': torch.float32, **kw})


def _numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _reference(name='llama-tiny', kv_dtype='bf16'):
    """(reference model, f32 numpy params) of a tiny f32 model with the
    reference quant tests' pool geometry."""
    model, _, _ = _build_model(name, 64, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32,
                              kv_page_size=8, kv_total_pages=40,
                              kv_dtype=kv_dtype)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    return model, _numpy(params)


@pytest.fixture(scope='module')
def llama():
    """(reference model, f32 params, reference quantized params, port
    f32 model, port int8 model) of one f32 llama-tiny."""
    model, params = _reference()
    qparams = jax_quant.quantize_params(params)
    cfg = _port_config(model.config)
    dense = convert.params_from_jax(params, cfg, device='cpu')
    int8 = convert.params_from_jax(qparams, cfg, device='cpu')
    return model, params, qparams, dense, int8


def _walk_pairs(a, b, path=''):
    assert set(a) == set(b), path
    for key in a:
        if isinstance(a[key], dict):
            yield from _walk_pairs(a[key], b[key], f'{path}/{key}')
        else:
            yield f'{path}/{key}', np.asarray(a[key]), np.asarray(b[key])


def _run(engine, prompts=PROMPTS, max_new=MAX_NEW, **kw):
    futs = [engine.submit(list(p), max_new_tokens=max_new, **kw)
            for p in prompts]
    try:
        return [f.result(timeout=180) for f in futs]
    finally:
        engine.stop()


def _score(rt, row, prompt_len):
    """Mean log-prob of row[prompt_len:] under rt's scoring pass (the
    /v1/completions echo + logprobs quantity)."""
    chosen, _, _ = rt.score_logprobs(list(row))
    gen = [float(chosen[i - 1]) for i in range(prompt_len, len(row))]
    return sum(gen) / max(len(gen), 1)


# -- bytes ------------------------------------------------------------------
@pytest.mark.parametrize('name', ['llama-tiny', 'qwen-tiny'])
def test_quantize_params_bytes_match_reference(name):
    _, params = _reference(name)
    ref = jax_quant.quantize_params(params)
    port = quant.quantize_params(params)
    n_quant = 0
    for path, a, b in _walk_pairs(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        n_quant += path.endswith(quant.QUANT_KEY)
    assert n_quant == 7 * 2
    # quantize_kernel (the bridge's tensor path) gives the same bytes.
    leaf = params['layer_1']['mlp']['w_down']
    q, scale = quant.quantize_kernel(torch.tensor(leaf['kernel']))
    assert q.numpy().tobytes() == \
        ref['layer_1']['mlp']['w_down'][quant.QUANT_KEY].tobytes()
    assert scale.numpy().tobytes() == \
        ref['layer_1']['mlp']['w_down'][quant.SCALE_KEY].tobytes()
    assert quant.is_quantized(port) and not quant.is_quantized(params)


def test_constant_and_zero_columns():
    """A constant column round-trips exactly; an all-zero column gets
    scale 0 and q 0; ties round half to even; both paths equal the
    reference byte for byte."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.02, (40, 6)).astype(np.float32)
    w[:, 1] = 0.5
    w[:, 2] = 0.0
    w[:, 3] = -3.25
    w[:, 4] = 0.0
    w[0, 4], w[1, 4], w[2, 4] = 127.0, 0.5, -1.5   # x.5 ties at scale 1
    tree = {'wq': {'kernel': w}, 'other': {'kernel': w}}
    ref = jax_quant.quantize_params(tree)
    port = quant.quantize_params(tree)
    for path, a, b in _walk_pairs(ref, port):
        assert a.tobytes() == b.tobytes(), path
    assert 'kernel' in port['other']           # not a target: untouched
    q, scale = quant.quantize_kernel(torch.from_numpy(w))
    assert q.numpy().tobytes() == ref['wq'][quant.QUANT_KEY].tobytes()
    assert scale.numpy().tobytes() == \
        ref['wq'][quant.SCALE_KEY].tobytes()
    back = q.float() * scale
    np.testing.assert_array_equal(back[:, 1].numpy(), w[:, 1])
    np.testing.assert_array_equal(back[:, 3].numpy(), w[:, 3])
    assert scale[2] == 0 and torch.all(q[:, 2] == 0)
    assert q[1, 4] == 0 and q[2, 4] == -2      # 0.5 -> 0, -1.5 -> -2


def test_targets_and_bounds(llama):
    """Only the projection kernels quantize (embedding, norms, head
    untouched); the dequantized error is within scale / 2 per channel
    (port of the reference's test_weight_quantize_targets_and_bounds)."""
    _, params, _, _, _ = llama
    q = quant.quantize_params(params)
    for t in ('wq', 'wk', 'wv', 'wo'):
        assert q['layer_0']['attn'][t][quant.QUANT_KEY].dtype == np.int8
        assert 'kernel' not in q['layer_0']['attn'][t]
    for t in ('w_gate', 'w_up', 'w_down'):
        assert q['layer_0']['mlp'][t][quant.QUANT_KEY].dtype == np.int8
    assert q['tok_embed'].dtype == np.float32
    assert q['lm_head'].dtype == np.float32
    assert 'kernel' not in q['final_norm']
    w = params['layer_0']['attn']['wq']['kernel']
    leaf = q['layer_0']['attn']['wq']
    back = leaf[quant.QUANT_KEY].astype(np.float32) * leaf[quant.SCALE_KEY]
    assert np.all(np.abs(back - w) <= leaf[quant.SCALE_KEY] / 2 + 1e-7)
    dense = quant.dequantize_params(q)
    np.testing.assert_array_equal(dense['layer_0']['attn']['wq']['kernel'],
                                  back)
    ref_dense = jax.tree.map(np.asarray, jax_quant.dequantize_params(
        jax.tree.map(jnp.asarray, jax_quant.quantize_params(params))))
    for path, a, b in _walk_pairs(ref_dense, dense):
        np.testing.assert_array_equal(a, b, err_msg=path)


# -- bridge -----------------------------------------------------------------
@pytest.mark.parametrize('name', ['llama-tiny', 'qwen-tiny'])
def test_bridge_quantized_tree_equals_quantized_bridge(name):
    model, params = _reference(name)
    cfg = _port_config(model.config)
    qparams = jax_quant.quantize_params(params)
    from_q = convert.params_from_jax(qparams, cfg, device='cpu')
    from_f = convert.params_from_jax(params, cfg, device='cpu',
                                     weight_dtype='int8')
    assert from_q.weight_dtype == from_f.weight_dtype == 'int8'
    a, b = from_q.state_dict(), from_f.state_dict()
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), \
            key
    leaf = qparams['layer_0']['attn']['wk']
    wk = from_q.layers[0].attn.wk
    assert isinstance(wk, pt_llama.Int8Dense)
    assert wk.weight_q.numpy().tobytes() == \
        np.ascontiguousarray(leaf[quant.QUANT_KEY].T).tobytes()
    assert wk.weight_scale.numpy().tobytes() == \
        leaf[quant.SCALE_KEY].tobytes()
    if name == 'qwen-tiny':
        np.testing.assert_array_equal(wk.bias.numpy(), leaf['bias'])
    with pytest.raises(ValueError, match='quantized'):
        convert.params_from_jax(qparams, cfg, weight_dtype='bf16')


def test_hf_import_quantizes_the_checkpoints_f32_values(tmp_path):
    """The HF importer with weight_dtype='int8' stores the reference's
    quantize_params of the reference's raw f32 import, byte for byte."""
    transformers = pytest.importorskip('transformers')
    from skypilot_tpu.models import hf_import as jax_hf
    from skypilot_tpu_torch.models import hf_import
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False))
    hf.to(torch.bfloat16).save_pretrained(str(tmp_path),
                                          safe_serialization=True)
    _, ref_params = jax_hf.load_hf_checkpoint(str(tmp_path))
    ref_q = jax_quant.quantize_params(_numpy(ref_params))
    _, port = hf_import.load_hf_checkpoint(str(tmp_path), device='cpu',
                                           weight_dtype='int8')
    assert port.weight_dtype == 'int8'
    for i in range(2):
        for group, names in (('attn', ('wq', 'wk', 'wv', 'wo')),
                             ('mlp', ('w_gate', 'w_up', 'w_down'))):
            for t in names:
                leaf = ref_q[f'layer_{i}'][group][t]
                mod = getattr(getattr(port.layers[i], group), t)
                assert mod.weight_q.numpy().tobytes() == np.ascontiguousarray(
                    leaf[quant.QUANT_KEY].T).tobytes(), (i, t)
                assert mod.weight_scale.numpy().tobytes() == \
                    leaf[quant.SCALE_KEY].tobytes(), (i, t)
    assert port.tok_embed.dtype == torch.bfloat16


# -- logits and tokens ------------------------------------------------------
@pytest.mark.parametrize('name', ['llama-tiny', 'qwen-tiny'])
def test_logits_match_quantized_reference(name):
    model, params = _reference(name)
    qparams = jax_quant.quantize_params(params)
    qm = jax_quant.QuantizedModel(model)
    tokens = np.random.default_rng(0).integers(
        0, model.config.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(qm.apply({'params': jax.tree.map(jnp.asarray, qparams)},
                              jnp.asarray(tokens)))
    port = convert.params_from_jax(qparams, _port_config(model.config),
                                   device='cpu')
    with torch.no_grad():
        out = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    dense = np.asarray(model.apply({'params': params}, jnp.asarray(tokens)))
    assert not np.array_equal(ref, dense)       # quantization noise bites


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_slot_engine_tokens_match_reference(kv_dtype):
    model, params = _reference(kv_dtype=kv_dtype)
    qparams = jax_quant.quantize_params(params)
    port = convert.params_from_jax(qparams, _port_config(model.config),
                                   device='cpu')
    ref = jax_batching.ContinuousBatchingEngine(
        jax_quant.QuantizedModel(model), jax.tree.map(jnp.asarray, qparams),
        **ENGINE_KW)
    got = _run(pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW))
    assert got == _run(ref)
    assert all(len(r) == len(p) + MAX_NEW for r, p in zip(got, PROMPTS))


def test_one_shot_tokens_match_reference(llama):
    model, _, qparams, _, int8 = llama
    prompt = np.array([[5, 9, 2, 17, 30, 31], [7, 7, 7, 7, 8, 9]], np.int32)
    ref = np.asarray(jax_generate.make_generate_fn(
        jax_quant.QuantizedModel(model), 32)(
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(prompt),
            jax.random.PRNGKey(0)))
    out = pt_generate.make_generate_fn(int8, 32)(torch.from_numpy(prompt))
    np.testing.assert_array_equal(out.numpy(), ref)
    # The scoring pass's full forward and the dense cache's decode
    # logits, each against the reference's.
    got = pt_generate.teacher_forced_logits(int8, torch.from_numpy(prompt))
    ref_logits = jax_generate.teacher_forced_logits(
        jax_quant.QuantizedModel(model), jax.tree.map(jnp.asarray, qparams),
        jnp.asarray(prompt))
    for a, b in zip(got, ref_logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)


# -- the reference's tolerance contract -------------------------------------
def test_int8_weights_within_logprob_tolerance():
    """Serving's bf16 layout: the int8 model's greedy continuations,
    scored by the bf16 runtime's scoring pass, lose at most 0.1 nats a
    token against the bf16 model's own."""
    model, params = _reference()
    cfg = _port_config(model.config, dtype=torch.bfloat16)
    dense = convert.params_from_jax(params, cfg, device='cpu')
    int8 = convert.params_from_jax(params, cfg, device='cpu',
                                   weight_dtype='int8')
    assert int8.tok_embed.dtype == torch.bfloat16
    e_ref = pt_batching.ContinuousBatchingEngine(dense, **ENGINE_KW)
    rt = pt_runtime.InferenceRuntime(engine=e_ref, model_name='llama-tiny')
    try:
        a = _run(pt_batching.ContinuousBatchingEngine(dense, **ENGINE_KW))
        b = _run(pt_batching.ContinuousBatchingEngine(int8, **ENGINE_KW))
        for prompt, ra, rb in zip(PROMPTS, a, b):
            lp_ref = _score(rt, ra, len(prompt))
            lp_q = _score(rt, rb, len(prompt))
            assert lp_q >= lp_ref - LOGPROB_TOL, (lp_q, lp_ref)
    finally:
        rt.stop()


def test_int8_weights_with_lora_matches_merged_oracle(llama, tmp_path):
    """Batched LoRA on the int8 base: deltas ride the quantized
    projections' outputs, so the continuation scores within 0.1 nats a
    token of the merged-weights oracle built from the unquantized
    model; the loud adapter changes the greedy tokens."""
    _, _, _, dense, int8 = llama
    spec = lora_lib.LoraSpec(rank=4, alpha=64.0)
    lp = lora_lib.random_adapter_params(0, dense.config, spec)
    lora_lib.save_adapter(str(tmp_path / 'ad0'), lp, spec,
                          base_model='llama-tiny')
    assert lora_lib.supports(int8)
    with pytest.raises(ValueError, match='unquantized'):
        lora_lib.merge_lora(int8, lp, spec)
    merged = lora_lib.merge_lora(dense, lp, spec)
    reg = AdapterRegistry(str(tmp_path), int8, max_adapters=2)
    e_q = pt_batching.ContinuousBatchingEngine(int8, adapter_store=reg,
                                               **ENGINE_KW)
    e_oracle = pt_batching.ContinuousBatchingEngine(merged, **ENGINE_KW)
    rt = pt_runtime.InferenceRuntime(engine=e_oracle,
                                     model_name='llama-tiny')
    prompt = [5, 9, 2, 17, 30]
    try:
        a = e_oracle.submit(prompt, max_new_tokens=MAX_NEW).result(180)
        b = e_q.submit(prompt, max_new_tokens=MAX_NEW,
                       adapter='ad0').result(180)
        base = e_q.submit(prompt, max_new_tokens=MAX_NEW).result(180)
        assert b != base
        assert _score(rt, b, len(prompt)) >= \
            _score(rt, a, len(prompt)) - LOGPROB_TOL
    finally:
        e_q.stop()
        rt.stop()


# -- exact contracts within the port ----------------------------------------
@pytest.mark.parametrize('mode,kw,plain_kw', [
    ('pipelined', dict(pipeline_decode=True), dict(pipeline_decode=False)),
    ('decode_chunk', dict(decode_chunk=4, pipeline_decode=False),
     dict(pipeline_decode=False)),
    ('speculative', dict(speculative_k=3), dict()),
    ('chunked_prefill', dict(prefill_chunk=8), dict(prefill_chunk=0)),
])
def test_exact_contracts_under_int8_weights(llama, mode, kw, plain_kw):
    int8 = llama[4]
    base = dict(num_slots=2, max_total_len=40)
    prompts = ([7, 8, 7, 8, 7, 8, 7, 8, 7], list(range(40, 60)))
    got = _run(pt_batching.ContinuousBatchingEngine(int8, **base, **kw),
               prompts)
    want = _run(pt_batching.ContinuousBatchingEngine(int8, **base,
                                                     **plain_kw), prompts)
    assert got == want, mode


# -- the kernel's plain version, dispatch and plan --------------------------
@pytest.mark.parametrize('dtype,with_bias', [
    (torch.float32, False), (torch.float32, True),
    (torch.bfloat16, False), (torch.bfloat16, True)])
def test_plain_version_matches_numpy(dtype, with_bias):
    """int8_linear on CPU tensors (the plain version) against numpy's
    dequantize-then-matmul: f32 within 1e-6 (relative Frobenius, sums in
    another order); bf16 within 1e-2 (the weights and output round to
    bf16, as the reference's Dense casts). An all-zero channel gives
    exactly the bias."""
    rng = np.random.default_rng(2)
    n, k = 24, 48
    q = rng.integers(-127, 128, (n, k)).astype(np.int8)
    scale = (rng.random(n) * 0.01).astype(np.float32)
    q[5], scale[5] = 0, 0.0
    x = rng.standard_normal((3, 4, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    xt = torch.from_numpy(x).to(dtype)
    bt = torch.from_numpy(bias).to(dtype) if with_bias else None
    before = il.plain_calls
    y = il.int8_linear(xt, torch.from_numpy(q), torch.from_numpy(scale), bt)
    assert il.plain_calls == before + 1 and y.dtype == dtype
    assert y.shape == (3, 4, n)
    want = xt.float().numpy() @ (q.astype(np.float32) * scale[:, None]).T
    if with_bias:
        want = want + bt.float().numpy()
    got = y.float().numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < (1e-6 if dtype == torch.float32 else 1e-2), err
    np.testing.assert_array_equal(
        got[..., 5], np.broadcast_to(bt.float().numpy()[5] if with_bias
                                     else 0.0, got[..., 5].shape))


def test_dispatch_rules():
    q = torch.zeros(8, 16, dtype=torch.int8)
    scale = torch.ones(8)
    x = torch.zeros(2, 16)
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        il.int8_linear(x, q, scale, impl='cuda')
    with il.impl_scope('cuda'):
        with pytest.raises(RuntimeError):
            il.int8_linear(x, q, scale)
    with il.impl_scope('torch'):
        assert il.resolve_impl('auto', torch.device('cuda')) == 'torch'
    assert il.resolve_impl('auto', torch.device('cuda')) == 'cuda'
    before = il.launches, il.plain_calls
    il.int8_linear(x, q, scale)
    assert (il.launches, il.plain_calls) == (before[0], before[1] + 1)
    assert not il.available() and il.unavailable_reason()
    with pytest.raises(TypeError):
        il.int8_linear(x, q.float(), scale)
    with pytest.raises(TypeError):
        il.int8_linear(x, q, scale, torch.zeros(8, dtype=torch.bfloat16))


def test_perturbed_plain_control_fails_the_pin():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, (16, 32)).astype(np.int8))
    scale = torch.from_numpy((rng.random(16) * 0.01).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    good = il.int8_linear(x, q, scale)
    bad = il.int8_linear(x, q, scale, perturb=0.01)
    err = ((bad - good).norm(dim=1) / good.norm(dim=1)).max().item()
    assert err > 1e-3


# Every projection shape the int8 path launches: Llama-3-8B's, Qwen2-7B's,
# DeepSeek-V2-Lite's and one --tensor 2 shard of Llama-3-8B's.
PLAN_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (3584, 3584), (512, 3584), (18944, 3584), (3584, 18944),
               (3072, 2048), (2048, 2048), (10944, 2048), (2048, 10944),
               (2048, 4096), (512, 4096), (7168, 4096), (4096, 2048),
               (4096, 7168))


@pytest.mark.parametrize('m', [1, 8, 32, 40, 64, 128, 256, 2048])
def test_plan_cuts_the_grid(m):
    """The route is a function of dtype and M alone: 'mma' up to
    WGMMA_MIN_ROWS bf16 rows, 'wgmma' past it, 'f32' for f32. Row tiles
    hold M; slices are whole stages of the route, at least two a slice
    when K is split, and a cluster size the card allows; at decode every
    Llama-3-8B projection runs at least ~132 blocks on 132 SMs, and at
    M = 256 every shape of the int8 path at least 132."""
    assert il.WGMMA_MIN_ROWS == 64
    for dtype in (torch.bfloat16, torch.float32):
        for n, k in PLAN_SHAPES:
            route, bt, bn, ks = il.plan(m, n, k, 132, dtype)
            assert route == ('f32' if dtype == torch.float32 else
                             'mma' if m <= 64 else 'wgmma'), (m, route)
            assert ks in (1, 2, 4, 8)
            units = -(-k // il.TILE_K[route])
            assert units >= ks and (ks == 1 or units >= 2 * ks)
            if route == 'wgmma':
                assert (bt, bn) in il.WGMMA_TILES and il.TILE_K[route] == 64
                assert bn < 128 or ks == 1
            else:
                assert bt in il.ROW_TILES and (bt >= m or bt == 64)
                assert bn in (32, 64) and il.TILE_K[route] == 128
            blocks = -(-n // bn) * -(-m // bt) * ks
            if m <= 8 and n in (4096, 1024, 14336) and k in (4096, 14336):
                assert blocks >= 128 * 1.5 or blocks >= 132, (n, k, blocks)
            if m == 256 and route == 'wgmma':
                assert blocks >= 132, (n, k, bt, bn, ks)
    assert il.bytes_bound(8, 4096, 4096, 2) == \
        4096 * 4096 + 4 * 4096 + 2 * 8 * 4096 * 2


def test_plan_pins_the_prefill_tiles():
    """The wgmma tiling at the shapes PERF.md times at M = 256."""
    assert il.plan(256, 2048, 10944, 132) == ('wgmma', 128, 64, 4)
    assert il.plan(256, 4096, 4096, 132) == ('wgmma', 128, 64, 2)
    assert il.plan(256, 14336, 4096, 132) == ('wgmma', 128, 128, 1)
    assert il.plan(256, 1024, 4096, 132) == ('wgmma', 128, 64, 8)
    assert il.plan(256, 512, 3584, 132) == ('wgmma', 64, 64, 8)
    assert il.plan(2048, 14336, 4096, 132) == ('wgmma', 128, 128, 1)
    assert il.plan(8, 4096, 4096, 132) == ('mma', 8, 64, 4)


def test_plan_for_a_route():
    """`plan(..., route=)` gives one route's tiling at any M of its dtype
    and refuses a route that does not take the dtype, or no route."""
    assert il.plan(8, 4096, 4096, 132, route='wgmma') == \
        ('wgmma', 128, 64, 4)
    assert il.plan(2048, 4096, 4096, 132, route='mma') == \
        ('mma', 64, 64, 1)
    for route, dtype in (('f32', torch.bfloat16), ('wgmma', torch.float32),
                         ('mma', torch.float32), ('tma', torch.bfloat16)):
        with pytest.raises(ValueError):
            il.plan(8, 64, 64, 132, dtype, route=route)


# -- bytes, /stats, refusals, the flag --------------------------------------
def test_weight_bytes_count_buffers(llama):
    _, _, _, dense, int8 = llama
    total = sum(t.numel() * t.element_size()
                for t in list(int8.parameters()) + list(int8.buffers()))
    assert quant.weight_num_bytes(int8) == total
    assert quant.weight_num_bytes(dense) == sum(
        p.numel() * p.element_size() for p in dense.parameters())
    cfg = int8.config
    proj = sum(d_in * d_out for d_in, d_out in
               lora_lib.projection_shapes(cfg).values()) * cfg.num_layers
    outs = sum(d_out for _, d_out in
               lora_lib.projection_shapes(cfg).values()) * cfg.num_layers
    # f32 dense -> int8 + one f32 scale a channel.
    assert quant.weight_num_bytes(dense) - quant.weight_num_bytes(int8) == \
        3 * proj - 4 * outs
    engine = pt_batching.ContinuousBatchingEngine(int8, **ENGINE_KW)
    try:
        model = engine.attention_bytes_per_token()
        assert model['weight_bytes_amortized'] == quant.weight_num_bytes(int8)
    finally:
        engine.stop()


def test_stats_storage_reports_int8(llama):
    int8 = llama[4]
    engine = pt_batching.ContinuousBatchingEngine(int8, **ENGINE_KW)
    rt = pt_runtime.InferenceRuntime(engine=engine, model_name='llama-tiny')
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f'http://127.0.0.1:{server.server_address[1]}/stats'
        with urllib.request.urlopen(url, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body['storage']['weight_dtype'] == 'int8'
        assert body['storage']['weight_bytes'] == \
            quant.weight_num_bytes(int8)
    finally:
        server.shutdown()
        rt.stop()


def _reference_runtime_refusals():
    """String constants of the reference build_runtime's SystemExit
    calls (read from its source with the AST)."""
    tree = ast.parse((ROOT / 'skypilot_tpu' / 'inference' /
                      'runtime.py').read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, 'id', '') == 'SystemExit' and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                out.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                out.add(''.join(v.value if isinstance(v, ast.Constant)
                                else '{}' for v in arg.values))
    return out


def test_ckpt_dir_refusal_is_the_references_words(capsys):
    refusals = _reference_runtime_refusals()
    assert pt_runtime.INT8_WEIGHTS_NO_CKPT in refusals
    none_found = pt_runtime.int8_weights_none_found(quant.WEIGHT_TARGETS)
    assert none_found.replace(str(quant.WEIGHT_TARGETS), '{}') in refusals
    assert quant.WEIGHT_TARGETS == jax_quant.WEIGHT_TARGETS
    args = serve_lm.build_parser().parse_args(
        ['--cpu', '--model', 'llama-tiny', '--weight-dtype', 'int8',
         '--ckpt-dir', '/nonexistent', '--continuous-batching'])
    with pytest.raises(SystemExit) as exc:
        pt_runtime.build_runtime(args)
    assert str(exc.value) == pt_runtime.INT8_WEIGHTS_NO_CKPT


@pytest.mark.parametrize('continuous', [True, False])
def test_serve_lm_int8_serves(continuous, capsys):
    """serve_lm --weight-dtype int8 on the seeded llama-tiny: the slot
    engine or the one-shot engine answers with the tokens of the same
    model run directly; the gauges read int8 and its bytes."""
    argv = ['--cpu', '--model', 'llama-tiny', '--weight-dtype', 'int8',
            '--max-total-len', '64']
    if continuous:
        argv.append('--continuous-batching')
    rt = pt_runtime.build_runtime(serve_lm.parse_args(argv))
    try:
        assert 'weights: int8 per-output-channel projections ' \
            '(dequant-on-read)' in capsys.readouterr().out
        assert rt.weight_dtype == 'int8' and rt.model.weight_dtype == 'int8'
        assert isinstance(rt.model.layers[0].mlp.w_up, pt_llama.Int8Dense)
        assert rt.weight_bytes == quant.weight_num_bytes(rt.model)
        info = obs_catalog.gauge('skypilot_serving_storage_info')
        assert info.labels(kv_dtype='bf16', weight_dtype='int8').value == 1
        assert obs_catalog.gauge('skypilot_serving_weight_bytes').value == \
            rt.weight_bytes
        seeded = convert.init_params(rt.model.config, seed=0, device='cpu',
                                     weight_dtype='int8')
        for key, t in seeded.state_dict().items():
            assert torch.equal(t, rt.model.state_dict()[key]), key
        prompt = [5, 9, 2, 17]
        want = pt_generate.make_generate_fn(seeded, 16)(
            torch.tensor([prompt], dtype=torch.int32))[0].tolist()
        if continuous:
            got = rt.engine.submit(prompt, max_new_tokens=12).result(180)
        else:
            got = rt.one_shot_rows([prompt], 12, 0.0)[0]
        assert got == want
    finally:
        rt.stop()


def test_param_dtype_applies_to_the_dense_leaves():
    """--param-dtype f32 with --weight-dtype int8: the embedding, norms,
    head and Qwen2's q/k/v biases are f32 masters (the reference's
    serve_cast on the dense leaves), the projections stay int8 + f32
    scales, and a request is answered."""
    args = serve_lm.parse_args(['--cpu', '--model', 'qwen-tiny',
                                '--weight-dtype', 'int8', '--param-dtype',
                                'f32', '--continuous-batching',
                                '--max-total-len', '64'])
    rt = pt_runtime.build_runtime(args)
    try:
        wq = rt.model.layers[0].attn.wq
        assert rt.model.tok_embed.dtype == torch.float32
        assert wq.bias.dtype == torch.float32
        assert wq.weight_q.dtype == torch.int8
        assert wq.weight_scale.dtype == torch.float32
        row = rt.engine.submit([5, 9, 2, 17], max_new_tokens=6).result(180)
        assert len(row) == 10
    finally:
        rt.stop()


# -- DeepSeek and Mixtral ---------------------------------------------------
#: The quantized leaves a layer of each family has under the reference's
#: quantize_params: 2-D `{kernel}`s named in WEIGHT_TARGETS (DeepSeek's
#: wkv_a / wq_a / wq_b and 3-D wkv_b, Mixtral's router and expert stacks
#: stay dense).
FAMILY_TARGETS = {'deepseek-tiny': ('attn/wq', 'attn/wo', 'mlp/w_down',
                                    'mlp/w_gate', 'mlp/w_up'),
                  'mixtral-tiny': ('attn/wk', 'attn/wo', 'attn/wq',
                                   'attn/wv')}


def _family_reference(name):
    """(reference model, f32 numpy params, the port's f32 config) of a
    tiny f32 DeepSeek or Mixtral."""
    from skypilot_tpu_torch.models import registry
    model, _, _ = _build_model(name, 64, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32)
    model = type(model)(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port_cfg = dataclasses.replace(registry.model_config(name, 64),
                                   dtype=torch.float32)
    return model, _numpy(params), port_cfg


@pytest.mark.parametrize('name', sorted(FAMILY_TARGETS))
def test_other_families_quantize_the_references_leaves(name):
    """quantize_params bytes == the reference's; the quantized leaf set
    is exactly the reference's, and it is the set of the port model's
    Int8Dense modules; the bridge of the quantized tree equals the
    bridge's own quantization, buffer for buffer."""
    _, params, port_cfg = _family_reference(name)
    ref = jax_quant.quantize_params(params)
    port = quant.quantize_params(params)
    quantized = set()
    for path, a, b in _walk_pairs(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        if path.endswith(quant.QUANT_KEY):
            quantized.add(path[1:-len(quant.QUANT_KEY) - 1])
    want = {f'layer_{i}/{leaf}' for i in range(2)
            for leaf in FAMILY_TARGETS[name]}
    assert quantized == want
    from_ref = convert.params_from_jax(ref, port_cfg)
    from_f32 = convert.params_from_jax(params, port_cfg,
                                       weight_dtype='int8')
    assert from_ref.weight_dtype == from_f32.weight_dtype == 'int8'
    modules = {n.replace('layers.', 'layer_').replace('.', '/')
               for n, m in from_ref.named_modules()
               if isinstance(m, pt_llama.Int8Dense)}
    assert modules == want
    a, b = from_ref.state_dict(), from_f32.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key])
    seeded = convert.init_params(port_cfg, seed=0, weight_dtype='int8')
    assert {k: (v.dtype, tuple(v.shape))
            for k, v in seeded.state_dict().items()} == \
        {k: (v.dtype, tuple(v.shape)) for k, v in a.items()}


@pytest.mark.parametrize('name', sorted(FAMILY_TARGETS))
def test_other_families_int8_tokens_match_quantized_reference(name):
    """Greedy tokens of the port's slot engine (the plain int8 route on
    the CPU; DeepSeek on the dense path) == the reference engine's on
    QuantizedModel, f32."""
    model, params, port_cfg = _family_reference(name)
    qparams = jax_quant.quantize_params(params)
    port = convert.params_from_jax(qparams, port_cfg)
    ref = jax_batching.ContinuousBatchingEngine(
        jax_quant.QuantizedModel(model), jax.tree.map(jnp.asarray, qparams),
        **ENGINE_KW)
    plain0 = il.plain_calls
    got = _run(pt_batching.ContinuousBatchingEngine(port, **ENGINE_KW))
    assert il.plain_calls > plain0
    assert got == _run(ref)
    assert all(len(r) == len(p) + MAX_NEW for r, p in zip(got, PROMPTS))


@pytest.mark.parametrize('name', sorted(FAMILY_TARGETS))
def test_other_families_int8_within_logprob_tolerance(name):
    """The reference's 0.1-nat contract on serving's bf16 layout: int8
    continuations scored by the bf16 runtime's scoring pass."""
    _, params, port_cfg = _family_reference(name)
    cfg = dataclasses.replace(port_cfg, dtype=torch.bfloat16)
    dense = convert.params_from_jax(params, cfg)
    int8 = convert.params_from_jax(params, cfg, weight_dtype='int8')
    rt = pt_runtime.InferenceRuntime(
        engine=pt_batching.ContinuousBatchingEngine(dense, **ENGINE_KW),
        model_name=name)
    try:
        a = _run(pt_batching.ContinuousBatchingEngine(dense, **ENGINE_KW))
        b = _run(pt_batching.ContinuousBatchingEngine(int8, **ENGINE_KW))
        for prompt, ra, rb in zip(PROMPTS, a, b):
            lp_ref = _score(rt, ra, len(prompt))
            lp_q = _score(rt, rb, len(prompt))
            assert lp_q >= lp_ref - LOGPROB_TOL, (lp_q, lp_ref)
    finally:
        rt.stop()


@pytest.mark.parametrize('name', sorted(FAMILY_TARGETS))
def test_serve_lm_int8_serves_other_families(name, capsys):
    """serve_lm --weight-dtype int8 on DeepSeek and Mixtral (once
    refused for Mixtral) serves the seeded int8 model's tokens."""
    rt = pt_runtime.build_runtime(serve_lm.parse_args(
        ['--cpu', '--model', name, '--weight-dtype', 'int8',
         '--max-total-len', '64', '--continuous-batching']))
    try:
        assert 'weights: int8 per-output-channel projections' in \
            capsys.readouterr().out
        assert rt.weight_dtype == 'int8'
        seeded = convert.init_params(rt.model.config, seed=0,
                                     weight_dtype='int8')
        prompt = [5, 9, 2, 17]
        want = pt_generate.make_generate_fn(seeded, 16)(
            torch.tensor([prompt], dtype=torch.int32))[0].tolist()
        assert rt.engine.submit(prompt, max_new_tokens=12).result(180) == \
            want
    finally:
        rt.stop()
