"""Port's LoRA math (skypilot_tpu_torch/models/lora.py,
ops/lora_kernel.py, the Llama forward's adapter path) against the JAX
reference, CPU, f32:

  - the plain version of the QKV LoRA kernel equals the reference's
    `fused_qkv_lora_delta` (run in Pallas interpret mode) and
    `lora.apply_delta`, with repeated ids and id 0, to 1e-5; a perturbed
    kernel fails that pin;
  - the plain version of the kernel's partition (adapters grouped on
    the device, row tiles, d_in slices summed in order, column slices)
    equals the Pallas kernel and `gathered_delta` to 1e-5 for an odd
    rank, a d_in that the cluster does not divide, unsorted repeated
    ids, one adapter, all distinct and a chunk of several row tiles;
    out-of-range ids give NaN rows only; the grid's bound covers every
    batch's (adapter, row tile) pairs from B, S and N alone;
  - port `Llama` logits for a batch whose rows use different adapters
    (and row 0 the base) match the JAX `Llama` with the same `lora`
    (through `convert.lora_from_jax`) to 1e-4, and each row matches the
    port's own `merge_lora` forward for that row's adapter;
  - `lora_from_jax` takes both tree forms and raises on a stray leaf;
  - the framework-free copies (specs, shapes, byte math, random
    factors, the artifact format) equal the reference's.
"""
import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import lora as jax_lora
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu.recipes.train_lm import _build_model
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import lora as pt_lora
from skypilot_tpu_torch.ops import lora_kernel as lk

SPEC = pt_lora.LoraSpec(rank=4, alpha=8.0, targets=pt_lora.ALL_TARGETS)
JAX_SPEC = jax_lora.LoraSpec(rank=4, alpha=8.0, targets=jax_lora.ALL_TARGETS)


def port_config(cfg) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(dtype=torch.float32, **vals)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _stacked(rng, n, d_in, rank, d_out):
    a = (rng.standard_normal((n, d_in, rank)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((n, rank, d_out)) * 0.02).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0        # row 0 is the base model, as in the store
    return {'a': a, 'b': b}


def _qkv_case(seed=7):
    rng = np.random.default_rng(seed)
    n, rank, d_model, batch, chunk = 4, 3, 32, 5, 6
    facs = [_stacked(rng, n, d_model, rank, d) for d in (48, 24, 24)]
    x = rng.standard_normal((batch, chunk, d_model)).astype(np.float32)
    ids = np.asarray([0, 2, 3, 2, 0], np.int32)     # repeats and id 0
    return x, facs, ids


def _torch_facs(facs):
    return [{k: torch.from_numpy(v) for k, v in f.items()} for f in facs]


def test_plain_qkv_lora_matches_reference():
    x, facs, ids = _qkv_case()
    jfacs = [{k: jnp.asarray(v) for k, v in f.items()} for f in facs]
    ref = pp.fused_qkv_lora_delta(jnp.asarray(x), *jfacs, jnp.asarray(ids),
                                  interpret=True)
    plain0 = lk.plain_calls
    out = lk.fused_qkv_lora_delta(torch.from_numpy(x), *_torch_facs(facs),
                                  torch.from_numpy(ids))
    assert lk.plain_calls == plain0 + 1
    scale = 2.0
    for f, jf, d, rd in zip(_torch_facs(facs), jfacs, out, ref):
        assert d.dtype == torch.float32
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), atol=1e-5,
                                   rtol=1e-5)
        # Rows of id 0 read the zero factors: exactly no delta.
        assert not d[torch.from_numpy(ids) == 0].any()
        # The caller-side add equals apply_delta, in both frameworks.
        y = np.random.default_rng(1).standard_normal(
            d.shape).astype(np.float32)
        want = np.asarray(jax_lora.apply_delta(
            jnp.asarray(y), jnp.asarray(x), jf, jnp.asarray(ids),
            jnp.float32(scale)))
        got = torch.from_numpy(y) + (scale * d).to(torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        port = pt_lora.apply_delta(torch.from_numpy(y), torch.from_numpy(x),
                                   f, torch.from_numpy(ids), scale)
        np.testing.assert_allclose(port.numpy(), want, atol=1e-5, rtol=1e-5)
    # The pin bites: a kernel off by 50% fails it.
    bad = lk.fused_qkv_lora_delta(torch.from_numpy(x), *_torch_facs(facs),
                                  torch.from_numpy(ids), perturb=0.5)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-5, rtol=1e-5)


def test_qkv_lora_dispatch_rules():
    x, facs, ids = _qkv_case()
    args = (torch.from_numpy(x), *_torch_facs(facs), torch.from_numpy(ids))
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        lk.fused_qkv_lora_delta(*args, impl='cuda')
    with lk.impl_scope('cuda'):
        with pytest.raises(RuntimeError):
            lk.fused_qkv_lora_delta(*args)
    with pytest.raises(ValueError):
        lk.resolve_impl('fused')
    assert lk.resolve_impl('auto', torch.device('cpu')) == 'torch'
    assert lk.resolve_impl('auto', torch.device('cuda')) == 'cuda'
    with lk.impl_scope('torch'):
        assert lk.resolve_impl('auto', torch.device('cuda')) == 'torch'
    assert lk.unavailable_reason()
    with pytest.raises(ValueError):
        lk.qkv_lora_dispatches_per_layer('fused')
    assert lk.qkv_lora_dispatches_per_layer('cuda') == \
        pp.qkv_lora_dispatches_per_layer('fused') == 1
    assert lk.qkv_lora_dispatches_per_layer('torch') == \
        pp.qkv_lora_dispatches_per_layer('xla') == 3
    with pytest.raises(ValueError, match='adapter_ids'):
        lk.fused_qkv_lora_delta(*args[:-1], torch.zeros(2, dtype=torch.int32))


def _jax_model(name):
    model, _, _ = _build_model(name, 64, remat=False)
    model = jax_llama.Llama(dataclasses.replace(model.config,
                                                dtype=jnp.float32))
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    return model, params


def _stack_adapters(adapters, cfg):
    """Raw per-adapter factors -> stacked [N+1, ...] leaves, row 0
    zeros (the registry's layout, scale folded in as 1)."""
    layers = {}
    for i in range(cfg.num_layers):
        lname = f'layer_{i}'
        layers[lname] = {}
        for t in pt_lora.ALL_TARGETS:
            a0 = adapters[0][lname][t]['a']
            b0 = adapters[0][lname][t]['b']
            layers[lname][t] = {
                'a': np.stack([np.zeros_like(a0)]
                              + [ad[lname][t]['a'] for ad in adapters]),
                'b': np.stack([np.zeros_like(b0)]
                              + [ad[lname][t]['b'] * SPEC.scale
                                 for ad in adapters])}
    return {'scale': 1.0, 'layers': layers}


@pytest.mark.parametrize('name', ['llama-tiny', 'qwen-tiny'])
def test_mixed_adapter_logits_match_reference_and_merged(name):
    model, params = _jax_model(name)
    cfg = port_config(model.config)
    adapters = [pt_lora.random_adapter_params(s, cfg, SPEC)
                for s in (11, 12)]
    # Amplified so the adapters visibly move the logits.
    for ad in adapters:
        for layer in ad.values():
            for f in layer.values():
                f['b'] *= 20.0
    stacked = _stack_adapters(adapters, cfg)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 12)).astype(np.int32)
    ids = np.asarray([0, 1, 2, 1], np.int32)
    ref = np.asarray(model.apply(
        {'params': params}, jnp.asarray(tokens),
        lora=jax.tree.map(jnp.asarray, stacked),
        adapter_ids=jnp.asarray(ids)))
    port = convert.params_from_jax(to_numpy(params), cfg)
    lora = convert.lora_from_jax(stacked)
    lora['layers'] = jax.tree.map(torch.from_numpy, lora['layers'])
    with torch.no_grad():
        out = port(torch.from_numpy(tokens), lora=lora,
                   adapter_ids=torch.from_numpy(ids)).numpy()
        base = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out[0], base[0])     # id 0 = base
    assert np.abs(out[1] - base[1]).max() > 1e-2       # not vacuous
    for row, aid in enumerate(ids):
        if not aid:
            continue
        merged = pt_lora.merge_lora(port, adapters[aid - 1], SPEC)
        with torch.no_grad():
            want = merged(torch.from_numpy(tokens[row:row + 1])).numpy()
        np.testing.assert_allclose(out[row:row + 1], want, atol=1e-4,
                                   rtol=1e-4)


def test_lora_from_jax_forms_and_stray_leaves():
    cfg = port_config(jax_llama.LlamaConfig.tiny(dtype=jnp.float32))
    raw = jax_lora.random_adapter_params(3, cfg, JAX_SPEC)
    got = convert.lora_from_jax(raw, scale=JAX_SPEC.scale)
    assert got['scale'] == JAX_SPEC.scale
    boxed = convert.lora_from_jax(jax_lora.as_model_lora(
        jax.tree.map(jnp.asarray, raw), JAX_SPEC.scale))
    assert boxed['scale'] == pytest.approx(JAX_SPEC.scale)
    for lname, layer in raw.items():
        for t, f in layer.items():
            for k in ('a', 'b'):
                np.testing.assert_array_equal(got['layers'][lname][t][k],
                                              f[k])
                np.testing.assert_array_equal(
                    boxed['layers'][lname][t][k], f[k])
    for stray in ({**raw, 'stray': {}},
                  {'layer_0': {**raw['layer_0'], 'wz': raw['layer_0']['wq']}},
                  {'layer_0': {'wq': {**raw['layer_0']['wq'], 'c': 0}}},
                  {'scale': 1.0, 'layers': raw, 'extra': 0}):
        with pytest.raises(ValueError, match='not consumed'):
            convert.lora_from_jax(stray)


def test_framework_free_copies_match_reference(tmp_path):
    cfg = port_config(jax_llama.LlamaConfig.tiny(dtype=jnp.float32))
    assert pt_lora.ALL_TARGETS == jax_lora.ALL_TARGETS
    assert pt_lora.projection_shapes(cfg) == jax_lora.projection_shapes(cfg)
    for targets in ('attn', 'mlp', 'attn-mlp'):
        t = pt_lora.targets_from_name(targets)
        assert t == jax_lora.targets_from_name(targets)
        assert pt_lora.adapter_num_bytes(cfg, 8, t, 2) == \
            jax_lora.adapter_num_bytes(cfg, 8, t, 2)
    assert SPEC.scale == JAX_SPEC.scale
    with pytest.raises(ValueError):
        pt_lora.LoraSpec(rank=0, alpha=1.0)
    ours = pt_lora.random_adapter_params(5, cfg, SPEC)
    theirs = jax_lora.random_adapter_params(5, cfg, JAX_SPEC)
    for lname in theirs:
        for t in theirs[lname]:
            for k in ('a', 'b'):
                np.testing.assert_array_equal(ours[lname][t][k],
                                              theirs[lname][t][k])
    # Artifacts: each side reads what the other wrote, byte for byte.
    jax_lora.save_adapter(str(tmp_path / 'j'), theirs, JAX_SPEC,
                          base_model='llama-tiny', step=3)
    pt_lora.save_adapter(str(tmp_path / 'p'), ours, SPEC,
                         base_model='llama-tiny', step=3)
    for path in ('j', 'p'):
        c1, w1 = jax_lora.load_adapter(str(tmp_path / path))
        c2, w2 = pt_lora.load_adapter(str(tmp_path / path))
        assert c1 == c2 and c1['format'] == pt_lora.FORMAT
        assert pt_lora.load_spec(c2) == SPEC
        for lname in w1:
            for t in w1[lname]:
                for k in ('a', 'b'):
                    np.testing.assert_array_equal(w1[lname][t][k],
                                                  w2[lname][t][k])
    assert pt_lora.list_adapter_dirs(str(tmp_path)) == \
        jax_lora.list_adapter_dirs(str(tmp_path)) == ['j', 'p']
    texts = []
    for path in ('j', 'p'):
        with open(os.path.join(tmp_path, path, pt_lora.CONFIG_FILE)) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]


# -- the kernel's partition (its grouped plain version) ----------------------
GROUPED_CASES = {   # (d_in, rank, batch, seq, ids, slots)
    'odd_rank': (64, 3, 5, 2, [0, 2, 3, 2, 0], 4),
    'd_in_not_divisible': (100, 4, 4, 3, [1, 3, 1, 2], 4),
    'unsorted_repeats': (96, 8, 8, 1, [3, 1, 1, 0, 3, 2, 0, 1], 4),
    'one_adapter': (64, 5, 6, 1, [2] * 6, 3),
    'all_distinct': (64, 6, 6, 1, [5, 0, 4, 2, 1, 3], 6),
    'chunk_of_tiles': (48, 4, 2, 70, [1, 1], 3),
}


def _grouped_case(d_in, rank, batch, seq, ids, slots, seed):
    rng = np.random.default_rng(seed)
    facs = [_stacked(rng, slots, d_in, rank, d) for d in (40, 24, 24)]
    x = rng.standard_normal((batch, seq, d_in)).astype(np.float32)
    return x, facs, np.asarray(ids, np.int32)


@pytest.mark.parametrize('name', list(GROUPED_CASES))
def test_grouped_reference_matches_pallas_and_gathered(name):
    x, facs, ids = _grouped_case(*GROUPED_CASES[name], seed=len(name))
    jfacs = [{k: jnp.asarray(v) for k, v in f.items()} for f in facs]
    pallas = pp.fused_qkv_lora_delta(jnp.asarray(x), *jfacs,
                                     jnp.asarray(ids), interpret=True)
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids)
    grouped = lk.fused_qkv_lora_delta_grouped_reference(
        tx, *_torch_facs(facs), tids)
    for g, ref, f in zip(grouped, pallas, _torch_facs(facs)):
        assert g.dtype == torch.float32 and g.shape == tuple(ref.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(),
                                   lk.gathered_delta(tx, f, tids).numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert not g[tids == 0].any()      # slot 0 is the zero adapter


def test_grouped_reference_out_of_range_ids_give_nan_rows_only():
    x, facs, _ = _grouped_case(64, 4, 6, 2, [0] * 6, 4, seed=3)
    ids = np.asarray([1, 4, 2, -1, 1, 9], np.int32)   # N = 4
    tx = torch.from_numpy(x)
    grouped = lk.fused_qkv_lora_delta_grouped_reference(
        tx, *_torch_facs(facs), torch.from_numpy(ids))
    ok = (ids >= 0) & (ids < 4)
    for g, f in zip(grouped, _torch_facs(facs)):
        assert torch.isnan(g[torch.from_numpy(~ok)]).all()
        good = g[torch.from_numpy(ok)]
        assert torch.isfinite(good).all()
        want = lk.gathered_delta(tx[torch.from_numpy(ok)], f,
                                 torch.from_numpy(ids[ok]))
        np.testing.assert_allclose(good.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def _tile_pairs(ids, seq, slots):
    """(adapter, row tile) pairs of a batch, counted directly: each
    distinct key (ids outside [0, N) share one) takes ceil(rows * S /
    TILE_ROWS) tiles."""
    keys = np.where((ids >= 0) & (ids < slots), ids, slots)
    return sum(-(-int((keys == k).sum()) * seq // lk.TILE_ROWS)
               for k in np.unique(keys))


def test_grid_bound_covers_every_batch_from_shapes_alone():
    rng = np.random.default_rng(0)
    for _ in range(400):
        batch = int(rng.integers(1, 300))
        seq = int(rng.choice([1, 1, 2, 7, 64, 65, 256, 300]))
        slots = int(rng.integers(1, 40))
        bound = lk.grid_tiles(batch, seq, slots)
        for _ in range(3):
            ids = rng.integers(-2, slots + 3, batch)
            assert _tile_pairs(ids, seq, slots) <= bound
    # Tight where every row is its own adapter, or all share one.
    assert lk.grid_tiles(8, 1, 8) == _tile_pairs(np.arange(8), 1, 8)
    assert lk.grid_tiles(1, 256, 4) == _tile_pairs(np.asarray([2]), 256, 4)
    # A function of B, S and N only: the same for any ids.
    assert lk.grid_tiles(32, 1, 9) == 10 and lk.grid_tiles(8, 1, 4) == 5


@pytest.mark.parametrize('d_in', [1, 15, 100, 3584, 4096, 8192])
def test_d_in_slices_partition_the_rows_in_steps_of_16(d_in):
    slices = lk.d_in_slices(d_in)
    assert len(slices) == lk.CLUSTER
    assert slices[0][0] == 0 and slices[-1][1] == d_in
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    width = slices[0][1] - slices[0][0]
    assert width % 16 == 0 or width == d_in
    assert all(k1 - k0 <= width for k0, k1 in slices)


@pytest.mark.parametrize('d_out,rows,rank,elt,cap', [
    (4096, 8, 16, 2, 512), (1024, 8, 16, 2, 512), (4096, 32, 16, 2, 256),
    (4096, 256, 64, 2, 128), (3584, 8, 16, 2, 512), (512, 8, 16, 2, 512),
    (4096, 8, 128, 4, 128), (100, 3, 3, 4, 512)])
def test_expand_columns_cover_each_column_once(d_out, rows, rank, elt, cap):
    cols = lk.expand_columns(d_out, rows, rank, elt)
    assert cols[0][0] == 0 and cols[-1][1] == d_out
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    assert all(0 < c1 - c0 <= cap for c0, c1 in cols)
    assert all(c0 % 8 == 0 for c0, _ in cols)
    assert len(cols) <= lk.CLUSTER * -(-d_out // (lk.CLUSTER * cap))


def test_grouped_reference_perturbed_fails_the_pin():
    x, facs, ids = _grouped_case(*GROUPED_CASES['unsorted_repeats'], seed=5)
    args = (torch.from_numpy(x), *_torch_facs(facs), torch.from_numpy(ids))
    good = lk.fused_qkv_lora_delta_grouped_reference(*args)
    bad = lk.fused_qkv_lora_delta_grouped_reference(*args, perturb=0.5)
    for g, b in zip(good, bad):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(b.numpy(), g.numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_one_device_launch_per_call():
    assert lk.DEVICE_LAUNCHES_PER_CALL == 1
    assert lk.qkv_lora_dispatches_per_layer('cuda') \
        * lk.DEVICE_LAUNCHES_PER_CALL == 1
