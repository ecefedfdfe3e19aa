"""Port's Llama (skypilot_tpu_torch/models/llama.py) against the JAX
reference (skypilot_tpu/models/llama.py) on the same weights, CPU, f32:

  - the weight bridge consumes every leaf of llama-tiny and qwen-tiny
    trees built by the reference's `_build_model` + seeded init;
  - teacher-forced no-cache logits match to atol=rtol=1e-4 (f32 sums
    run in another order in the two frameworks);
  - rope_inv_freq with llama3 and linear scaling matches to 1e-6;
  - the seeded on-device init has the documented shapes and values.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.recipes.train_lm import _build_model
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import registry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def port_config(jax_cfg, **kw) -> pt_llama.LlamaConfig:
    """The port's config with the reference config's values (dtype
    f32, the parity setting)."""
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    if jax_cfg.rope_scaling is not None:
        vals['rope_scaling'] = pt_llama.RopeScaling(
            **dataclasses.asdict(jax_cfg.rope_scaling))
    vals.update(dtype=torch.float32, **kw)
    return pt_llama.LlamaConfig(**vals)


def jax_tiny(name, **kw):
    model, _, _ = _build_model(name, 64, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32, **kw)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    return model, params


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize('name', ['llama-tiny', 'qwen-tiny'])
def test_bridge_consumes_every_leaf(name):
    model, params = jax_tiny(name)
    port = convert.params_from_jax(to_numpy(params), port_config(model.config))
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_jax == n_port
    if name == 'qwen-tiny':
        assert port.layers[0].attn.wq.bias is not None
    extra = dict(to_numpy(params))
    extra['stray'] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match='stray'):
        convert.params_from_jax(extra, port_config(model.config))


@pytest.mark.parametrize('name,scaling', [
    ('llama-tiny', None),
    ('qwen-tiny', None),
    ('llama-tiny', jax_llama.RopeScaling(rope_type='linear', factor=4.0)),
])
def test_no_cache_logits_match(name, scaling):
    model, params = jax_tiny(name, rope_scaling=scaling)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.config.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(model.apply({'params': params}, jnp.asarray(tokens)))
    port = convert.params_from_jax(to_numpy(params),
                                   port_config(model.config))
    with torch.no_grad():
        out = port(torch.from_numpy(tokens)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('scaling', [
    jax_llama.RopeScaling(),
    jax_llama.RopeScaling(rope_type='linear', factor=8.0),
    None,
], ids=['llama3', 'linear', 'none'])
def test_rope_inv_freq_matches(scaling):
    ref = np.asarray(jax_llama.rope_inv_freq(64, 500_000.0, scaling))
    port_scaling = (pt_llama.RopeScaling(**dataclasses.asdict(scaling))
                    if scaling is not None else None)
    out = pt_llama.rope_inv_freq(64, 500_000.0, port_scaling).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_apply_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    ref = np.asarray(jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          10_000.0))
    out = pt_llama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10_000.0).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_seeded_init_shapes_and_values():
    cfg = registry.model_config('qwen-tiny', 64)
    model = convert.init_params(cfg, seed=3, device='cpu')
    again = convert.init_params(cfg, seed=3, device='cpu')
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(a, b), name
    assert model.tok_embed.shape == (cfg.vocab_size, cfg.embed_dim)
    assert model.tok_embed.dtype == torch.bfloat16
    assert model.lm_head.dtype == torch.float32
    # The head holds bf16-rounded values (bf16 operands, f32 result).
    assert torch.equal(model.lm_head, model.lm_head.bfloat16().float())
    assert torch.all(model.final_norm.scale == 1)
    assert torch.all(model.layers[0].attn.wk.bias == 0)
    std = model.layers[0].mlp.w_up.weight.float().std().item()
    assert 0.018 < std < 0.022
