"""KV page chains in the port against the JAX reference, CPU, llama-tiny
(page size 8, as tests/unit_tests/test_kv_transfer.py builds it):

  - the wire format crosses frameworks both ways, whole bytes, for f32,
    bf16 and int8-with-scales leaves; cold-tier files written by either
    side read back on the other; HostSpillTier's counters equal the
    reference's over one sequence of puts and gets (exact);
  - a chain the JAX engine exports imports into the port's engine and
    the port's re-export is the same whole bytes, and the reverse, for
    bf16 (stored f32 and stored bf16) and int8 pools; the leaf paths are
    the JAX cache's keystr paths; after importing the JAX chain the
    port's greedy tokens equal the JAX engine's (f32, exact);
  - the port alone, as the reference's cases: export -> import -> serve
    bit-identical, mismatched geometry refused with the reference's
    messages, adapter-salted chains isolated, spill restore
    bit-identical, the cold tier restores after a host eviction,
    spilling needs prefix caching; the scatter writes into the pool's
    own storage (data_ptr unchanged; the decode round reads the
    imported pages); a perturbed scatter fails the bit-identity pins;
  - HTTP: a dead decode peer and an injected kv.handoff fault (through
    STPU_FAULT_PLAN, in a child process) fall back to local serving with
    the same tokens; a prefill replica answers a malformed body 400; /kv/import plain and with an embedded request; a
    JAX prefill replica hands off to a port decode replica and the
    reverse, the client's tokens equal a unified replica's; every /stats
    body scrapes through the reference ReplicaManager with the role,
    kv_spill and migration views the reference's give;
  - the decode-peer ring names the reference PrefixAffinityPolicy's
    peer; chain and affinity keys equal the reference's; sse.pipe
    forwards an http.client stream as it arrives.
"""
import base64
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import kv_transfer as ref_kvt
from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.inference import affinity, sse
from skypilot_tpu_torch.inference import kv_transfer as kvt
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.ops import paged_attention as paged_ops
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYS_PROMPT = list(range(2, 34))    # 32 tokens = 4 full 8-token pages
PROMPT = SYS_PROMPT + [40, 41]


def _port_config(cfg, dtype) -> pt_llama.LlamaConfig:
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return pt_llama.LlamaConfig(dtype=dtype, **vals)


def build(kv_dtype='bf16', total_pages=24, dtype='f32'):
    """(JAX model, params, port model) with the same weights."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    cfg = jax_llama.LlamaConfig.tiny(dtype=jdt, kv_page_size=8,
                                     kv_total_pages=total_pages,
                                     kv_dtype=kv_dtype)
    model = jax_llama.Llama(cfg)
    params = nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    port = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        _port_config(cfg, tdt), device='cpu')
    return model, params, port


def jax_engine(model, params, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('max_total_len', 96)
    return jax_batching.ContinuousBatchingEngine(model, params, **kw)


def port_engine(port, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('max_total_len', 96)
    return pt_batching.ContinuousBatchingEngine(port, **kw)


def _wire_payload(data: bytes) -> bytes:
    off = len(kvt.MAGIC)
    hlen = int.from_bytes(data[off:off + 8], 'big')
    return data[off + 8 + hlen:]


def _np_bytes(arr) -> bytes:
    """Raw bytes of a reference (numpy) or port (torch) leaf."""
    if isinstance(arr, torch.Tensor):
        return kvt.leaf_bytes(arr).tobytes()
    return np.ascontiguousarray(arr).tobytes()


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------
def _leaf_set(kind):
    rng = np.random.default_rng(3)
    if kind == 'f32':
        return {"['layer_0']['attn']['k_pages']":
                rng.standard_normal((2, 2, 8, 4)).astype(np.float32),
                "['layer_10']['attn']['v_pages']":
                rng.standard_normal((2, 2, 8, 4)).astype(np.float32)}
    if kind == 'bf16':
        return {"['layer_2']['attn']['k_pages']":
                rng.standard_normal((3, 2, 8, 4)).astype(ml_dtypes.bfloat16),
                "['layer_10']['attn']['k_pages']":
                rng.standard_normal((3, 2, 8, 4)).astype(ml_dtypes.bfloat16)}
    return {"['layer_0']['attn']['k_pages']":
            rng.integers(-127, 128, (2, 2, 8, 4)).astype(np.int8),
            "['layer_0']['attn']['k_scales']":
            rng.random((2, 8)).astype(np.float32)}


@pytest.mark.parametrize('kind', ['f32', 'bf16', 'int8'])
def test_wire_format_crosses_frameworks(kind):
    """Exact: the reference's packed bytes unpack in the port to the same
    dtypes and bytes, the port's pack of them is the same whole bytes,
    and the port's own pack unpacks in the reference."""
    blobs = _leaf_set(kind)
    meta = {'kind': 'kv_chain', 'kv_dtype': kind, 'page_size': 8,
            'keys': ['ab' * 32] * next(iter(blobs.values())).shape[0],
            'salt': ''}
    ref_data = ref_kvt.pack_pages(blobs, meta)
    meta2, got = kvt.unpack_pages(ref_data)
    assert meta2 == ref_kvt.unpack_pages(ref_data)[0]
    for path, arr in blobs.items():
        assert kvt.dtype_name(got[path].dtype) == arr.dtype.name
        assert tuple(got[path].shape) == arr.shape
        assert _np_bytes(got[path]) == arr.tobytes()
    assert kvt.pack_pages(got, meta) == ref_data
    # The port's own leaves (torch tensors, bf16 without ml_dtypes).
    mine = {path: (torch.from_numpy(arr.view(np.uint16).copy()).view(
        torch.bfloat16) if kind == 'bf16' else torch.from_numpy(arr))
        for path, arr in blobs.items()}
    port_data = kvt.pack_pages(mine, meta)
    assert port_data == ref_data
    _, back = ref_kvt.unpack_pages(port_data)
    for path, arr in blobs.items():
        assert back[path].dtype == arr.dtype
        assert back[path].tobytes() == arr.tobytes()
    # split / join round trip (the spill tier's unit).
    joined = kvt.join_pages(kvt.split_pages(got, meta2['n_pages']))
    for path, arr in blobs.items():
        assert _np_bytes(joined[path]) == arr.tobytes()
    assert kvt.page_blob_nbytes(got) == sum(a.nbytes for a in blobs.values())


def test_unpack_rejects_garbage():
    with pytest.raises(ValueError):
        kvt.unpack_pages(b'not a chain')
    data = kvt.pack_pages({'x': torch.zeros((1, 2))}, {'kind': 'kv_chain'})
    with pytest.raises(ValueError):
        kvt.unpack_pages(data[:-3])        # truncated payload
    with pytest.raises(ValueError):
        kvt.unpack_pages(data + b'xx')     # trailing junk
    with pytest.raises(ValueError):
        kvt.pack_pages({'a': torch.zeros((2, 2)),
                        'b': torch.zeros((3, 2))}, {})


@pytest.mark.parametrize('kind', ['bf16', 'int8'])
def test_cold_tier_files_cross_frameworks(kind, tmp_path):
    """A page one side's ColdTier writes, the other reads back (exact)."""
    blobs = _leaf_set(kind)
    page = {path: arr[0] for path, arr in blobs.items()}
    key_a, key_b = b'\x01' * 32, b'\x02' * 32
    ref_tier = ref_kvt.ColdTier(str(tmp_path))
    port_tier = kvt.ColdTier(str(tmp_path))
    ref_tier.put(key_a, page)
    got = port_tier.get(key_a)
    for path, arr in page.items():
        assert _np_bytes(got[path]) == arr.tobytes()
    port_tier.put(key_b, got)
    back = ref_tier.get(key_b)
    for path, arr in page.items():
        assert back[path].dtype == arr.dtype
        assert back[path].tobytes() == arr.tobytes()
    with open(tmp_path / f'{key_a.hex()}.kvpage', 'rb') as fa, \
            open(tmp_path / f'{key_b.hex()}.kvpage', 'rb') as fb:
        assert fa.read() == fb.read()
    assert port_tier.get(b'\x03' * 32) is None    # a miss, not an error
    (tmp_path / f'{key_a.hex()}.kvpage').write_bytes(b'torn')
    assert port_tier.get(key_a) is None           # a failed read is a miss
    assert port_tier.stats()['errors'] == 1


def test_host_spill_tier_counters_match_reference(tmp_path):
    """The same puts and gets through a 3-page host tier with a cold dir
    behind it: equal stats (LRU, demotion, promotion; exact)."""
    page = _leaf_set('int8')
    blob = {path: arr[0] for path, arr in page.items()}
    nbytes = sum(a.nbytes for a in blob.values())
    tiers = [ref_kvt.make_spill_tier(3 * nbytes, str(tmp_path / 'ref')),
             kvt.make_spill_tier(3 * nbytes, str(tmp_path / 'port'))]
    port_blob = {path: torch.from_numpy(arr) for path, arr in blob.items()}
    keys = [bytes([i]) * 32 for i in range(6)]
    for tier, b in zip(tiers, (blob, port_blob)):
        for k in keys[:5]:
            tier.put(k, b)
        for k in (keys[0], keys[4], keys[5], keys[1], keys[4]):
            tier.get(k)
        tier.put(keys[5], b)
    ref_stats, port_stats = (t.stats() for t in tiers)
    ref_stats['cold'].pop('root')
    port_stats['cold'].pop('root')
    assert port_stats == ref_stats
    assert port_stats['cold_demotions'] > 0 and port_stats['hits'] > 0
    no_cold = [ref_kvt.make_spill_tier(nbytes), kvt.make_spill_tier(nbytes)]
    for tier, b in zip(no_cold, (blob, port_blob)):
        tier.put(keys[0], b)
        tier.put(keys[1], b)
        tier.get(keys[0])
    assert no_cold[1].stats() == no_cold[0].stats()
    assert kvt.make_spill_tier(0) is None
    assert kvt.make_spill_tier(0, str(tmp_path / 'c')).capacity_bytes == \
        ref_kvt.make_spill_tier(0, str(tmp_path / 'd')).capacity_bytes
    with pytest.raises(ValueError, match=r'A6\(c\)'):
        kvt.ColdTier('gs://bucket/kv')


# ---------------------------------------------------------------------------
# Chains across frameworks
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module', params=[('bf16', 'f32'), ('bf16', 'bf16'),
                                        ('int8', 'f32')],
                ids=['bf16-pool-f32', 'bf16-pool-bf16', 'int8-pool-f32'])
def jax_chain(request):
    """(kv_dtype, model dtype, JAX model, params, port model, JAX tokens
    for PROMPT, JAX export of PROMPT, the JAX cache's keystr paths)."""
    kv_dtype, dtype = request.param
    model, params, port = build(kv_dtype, dtype=dtype)
    eng = jax_engine(model, params)
    try:
        ref = eng.submit(PROMPT, max_new_tokens=8).result(timeout=300)
        data = eng.export_chain(PROMPT)
        paths = sorted(jax.tree_util.keystr(p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(eng.cache)[0])
    finally:
        eng.stop()
    return kv_dtype, dtype, model, params, port, ref, data, paths


def test_jax_chain_imports_into_port_and_reexports_same_bytes(jax_chain):
    kv_dtype, dtype, _, _, port, _, data, paths = jax_chain
    eng = port_engine(port)
    try:
        assert sorted(p for p, _ in eng._cache_leaves()) == paths
        meta, blobs = kvt.unpack_pages(data)
        assert sorted(blobs) == paths
        want = {'bf16': 'float32' if dtype == 'f32' else 'bfloat16',
                'int8': 'int8'}[kv_dtype]
        assert kvt.dtype_name(
            blobs["['layer_0']['attn']['k_pages']"].dtype) == want
        assert eng.import_chain(data) == {'pages': 4, 'imported': 4,
                                          'already_cached': 0,
                                          'dropped': 0}
        # Whole bytes, header included.
        assert eng.export_chain(PROMPT) == data
        assert meta['n_pages'] == 4
    finally:
        eng.stop()


def test_port_chain_imports_into_jax_and_reexports_same_bytes(jax_chain):
    _, _, model, params, port, _, jax_data, _ = jax_chain
    src = port_engine(port)
    try:
        src.submit(PROMPT, max_new_tokens=4).result(timeout=300)
        data = src.export_chain(PROMPT)
    finally:
        src.stop()
    # The header is the reference's (the payload is the port's compute).
    assert json.loads(data[16:16 + int.from_bytes(data[8:16], 'big')]) \
        == json.loads(jax_data[16:16 + int.from_bytes(jax_data[8:16],
                                                     'big')])
    dst = jax_engine(model, params)
    try:
        assert dst.import_chain(data)['imported'] == 4
        assert dst.export_chain(PROMPT) == data
    finally:
        dst.stop()


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_port_tokens_after_jax_chain_equal_jax_tokens(kv_dtype):
    """f32 weights: after importing the JAX engine's chain, the port's
    greedy tokens for the prompt equal the JAX engine's (exact), with
    every full prompt page served from the imported chain."""
    model, params, port = build(kv_dtype)
    src = jax_engine(model, params)
    try:
        ref = src.submit(PROMPT, max_new_tokens=10).result(timeout=300)
        data = src.export_chain(PROMPT)
    finally:
        src.stop()
    eng = port_engine(port)
    try:
        eng.import_chain(data)
        h0, m0 = eng.prefix_cache.hits, eng.prefix_cache.misses
        assert eng.submit(PROMPT, max_new_tokens=10).result(
            timeout=300) == ref
        assert eng.prefix_cache.hits - h0 == 4
        assert eng.prefix_cache.misses == m0
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# The port alone (the reference's cases)
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def tiny_models():
    return {kv: build(kv, total_pages=20)[2] for kv in ('bf16', 'int8')}


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_export_import_bit_identical(kv_dtype, tiny_models):
    port = tiny_models[kv_dtype]
    src, dst = port_engine(port), port_engine(port)
    try:
        ref = src.submit(PROMPT, max_new_tokens=8).result(timeout=300)
        data = src.export_chain(PROMPT)
        meta, blobs = kvt.unpack_pages(data)
        assert meta['kv_dtype'] == kv_dtype and meta['n_pages'] == 4
        if kv_dtype == 'int8':
            assert any('k_scales' in p for p in blobs)
            assert any(b.dtype == torch.int8 for b in blobs.values())
        assert dst.import_chain(data) == {'pages': 4, 'imported': 4,
                                          'already_cached': 0,
                                          'dropped': 0}
        h0, m0 = dst.prefix_cache.hits, dst.prefix_cache.misses
        assert dst.submit(PROMPT, max_new_tokens=8).result(
            timeout=300) == ref
        assert dst.prefix_cache.hits - h0 == 4
        assert dst.prefix_cache.misses == m0
        assert _wire_payload(dst.export_chain(PROMPT)) == \
            _wire_payload(data)
        # Importing again finds every page cached.
        assert dst.import_chain(data)['already_cached'] == 4
    finally:
        src.stop()
        dst.stop()


def _refusal(engine, data):
    with pytest.raises(ValueError) as err:
        engine.import_chain(data)
    return str(err.value)


def test_import_rejects_mismatched_geometry():
    """Each refusal carries the reference engine's message, word for
    word."""
    model, params, port = build('bf16')
    model8, params8, port8 = build('int8')
    src = port_engine(port)
    try:
        src.submit(SYS_PROMPT, max_new_tokens=2).result(timeout=300)
        data = src.export_chain(SYS_PROMPT)
    finally:
        src.stop()
    meta, blobs = kvt.unpack_pages(data)
    bad_page = kvt.pack_pages(blobs, dict(meta, page_size=16))
    bad_layers = kvt.pack_pages(blobs, dict(meta, num_layers=3))
    one_leaf = dict(blobs)
    one_leaf.pop("['layer_1']['attn']['v_pages']")
    bad_leaves = kvt.pack_pages(one_leaf, meta)
    path = "['layer_0']['attn']['k_pages']"
    bad_shape = kvt.pack_pages(
        dict(blobs, **{path: blobs[path][:, :, :4]}), meta)
    cases = [data, bad_page, bad_layers, bad_leaves, bad_shape,
             b'garbage']
    engines = [(jax_engine(model8, params8), port_engine(port8))] + \
        [(jax_engine(model, params), port_engine(port))] * 5
    try:
        for case, (ref_eng, eng) in zip(cases, engines):
            want = _refusal(ref_eng, case)
            assert _refusal(eng, case) == want
        assert 'kv_dtype mismatch' in _refusal(engines[0][1], data)
        assert engines[0][1].healthy()
    finally:
        for ref_eng, eng in set(engines):
            ref_eng.stop()
            eng.stop()


def test_import_leaves_the_pages_decoding_slots_reserve(tiny_models,
                                                       monkeypatch):
    """An import never takes the pages decoding slots reserve for their
    next dispatch (`_growth_reserve`): what does not fit beside them is
    dropped in chain order and counted (exact)."""
    port = tiny_models['bf16']
    src = port_engine(port)
    try:
        src.submit(PROMPT, max_new_tokens=2).result(timeout=300)
        data = src.export_chain(PROMPT)
    finally:
        src.stop()
    dst = port_engine(port)    # 20 pages: 19 free beside the trash page
    monkeypatch.setattr(dst, '_growth_reserve', lambda: 17)
    try:
        assert dst.import_chain(data) == {'pages': 4, 'imported': 2,
                                          'already_cached': 0,
                                          'dropped': 2}
        assert dst.allocator.free_pages == 17
    finally:
        dst.stop()


def _write_adapter(root, seed):
    from skypilot_tpu.models import lora as jax_lora
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    spec = jax_lora.LoraSpec(rank=4, alpha=8.0)
    lp = jax_lora.random_adapter_params(seed, cfg, spec)
    for layer in lp.values():
        for tgt in layer.values():
            tgt['b'] *= 60.0      # big enough to flip greedy tokens
    jax_lora.save_adapter(os.path.join(root, 'ten_a'), lp, spec,
                          base_model='llama-tiny')


def test_adapter_salted_chains_stay_isolated(tmp_path):
    from skypilot_tpu_torch.inference.adapters import AdapterRegistry
    _write_adapter(str(tmp_path), 7)
    _, _, port = build()
    prompt = SYS_PROMPT + [40]
    src = port_engine(port, adapter_store=AdapterRegistry(
        str(tmp_path), port, max_adapters=2))
    dst = port_engine(port, adapter_store=AdapterRegistry(
        str(tmp_path), port, max_adapters=2))
    try:
        ref = src.submit(prompt, max_new_tokens=6,
                         adapter='ten_a').result(timeout=300)
        data = src.export_chain(prompt, adapter='ten_a')
        assert kvt.unpack_pages(data)[0]['salt'] == \
            affinity.adapter_salt('ten_a').hex()
        assert dst.import_chain(data)['imported'] == 4
        h0 = dst.prefix_cache.hits
        dst.submit(prompt, max_new_tokens=2).result(timeout=300)
        assert dst.prefix_cache.hits == h0      # other salt: no hits
        h1 = dst.prefix_cache.hits
        assert dst.submit(prompt, max_new_tokens=6,
                          adapter='ten_a').result(timeout=300) == ref
        assert dst.prefix_cache.hits - h1 >= 4
    finally:
        src.stop()
        dst.stop()


def _fill_pool(eng, base, n):
    for i in range(n):
        eng.submit([base + 7 * i + j for j in range(30)],
                   max_new_tokens=20).result(timeout=300)


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_spill_restore_bit_identical(kv_dtype, tiny_models):
    port = tiny_models[kv_dtype]
    ref_eng = port_engine(port)
    eng = port_engine(port, kv_spill_bytes=64 << 20)
    try:
        ref = ref_eng.submit(PROMPT, max_new_tokens=8).result(timeout=300)
        assert eng.submit(PROMPT, max_new_tokens=8).result(
            timeout=300) == ref
        _fill_pool(eng, 100, 4)
        assert eng.prefix_cache.spilled_pages > 0
        assert eng.spill_tier.stats()['spilled_pages'] > 0
        h0 = eng.prefix_cache.hits
        assert eng.submit(PROMPT, max_new_tokens=8).result(
            timeout=300) == ref
        assert eng.kv_restored_pages > 0 and eng.kv_restore_hits > 0
        # Restored pages count as hits, not misses.
        assert eng.prefix_cache.hits - h0 >= eng.kv_restored_pages
        stats = eng.stats()
        assert stats['kv_restored_pages'] == eng.kv_restored_pages
    finally:
        ref_eng.stop()
        eng.stop()


def test_cold_tier_restores_after_host_eviction(tmp_path, tiny_models):
    port = tiny_models['bf16']
    ref_eng = port_engine(port)
    eng = port_engine(port, kv_spill_bytes=1,
                      kv_cold_dir=str(tmp_path / 'cold'))
    try:
        ref = ref_eng.submit(PROMPT, max_new_tokens=8).result(timeout=300)
        assert eng.submit(PROMPT, max_new_tokens=8).result(
            timeout=300) == ref
        _fill_pool(eng, 200, 5)
        tier = eng.spill_tier.stats()
        assert tier['cold_demotions'] > 0 and tier['cold']['writes'] > 0
        assert eng.submit(PROMPT, max_new_tokens=8).result(
            timeout=300) == ref
        assert eng.kv_restored_pages > 0
        assert eng.spill_tier.stats()['cold']['reads'] > 0
    finally:
        ref_eng.stop()
        eng.stop()


def test_spill_requires_prefix_caching(tiny_models):
    """The reference's refusal, word for word."""
    model, params, _ = build()
    with pytest.raises(ValueError) as ref_err:
        jax_engine(model, params, prefix_caching=False,
                   kv_spill_bytes=1 << 20)
    with pytest.raises(ValueError) as err:
        port_engine(tiny_models['bf16'], prefix_caching=False,
                    kv_spill_bytes=1 << 20)
    assert str(err.value) == str(ref_err.value)


def _pool_ptrs(eng):
    return [t.data_ptr() for layer in eng.cache.layers
            for t in layer.values()]


def test_scatter_writes_into_the_pools_own_storage(tiny_models):
    """An import rewrites no pool tensor: every leaf keeps its storage,
    and the decode round (the function a CUDA graph captures, holding
    the pool tensors it was built with) decodes from the imported
    pages: the continuation equals the source's."""
    port = tiny_models['int8']
    src, dst = port_engine(port), port_engine(port)
    try:
        ref = src.submit(PROMPT, max_new_tokens=12).result(timeout=300)
        data = src.export_chain(PROMPT)
        before = _pool_ptrs(dst)
        round_leaves = [id(t) for layer in dst._rounds[0].cache.layers
                        for t in layer.values()]
        dst.import_chain(data)
        assert _pool_ptrs(dst) == before
        assert [id(t) for layer in dst._rounds[0].cache.layers
                for t in layer.values()] == round_leaves
        assert dst.submit(PROMPT, max_new_tokens=12).result(
            timeout=300) == ref
        assert dst.stats()['decode_calls'] > 0
    finally:
        src.stop()
        dst.stop()


def test_perturbed_scatter_fails_the_pins(monkeypatch, tiny_models):
    """Control: a scatter that flips one byte of one row must fail the
    bit-identity pin (re-export bytes), so the pins above can fail."""
    port = tiny_models['bf16']
    real = paged_ops.scatter_page_rows

    def perturbed(arr, idx, rows):
        if arr.ndim == 4:
            rows = rows.clone()
            rows.view(torch.uint8).view(-1)[5] ^= 0x10
        real(arr, idx, rows)

    src, dst = port_engine(port), port_engine(port)
    try:
        src.submit(PROMPT, max_new_tokens=4).result(timeout=300)
        data = src.export_chain(PROMPT)
        monkeypatch.setattr(paged_ops, 'scatter_page_rows', perturbed)
        dst.import_chain(data)
        assert dst.export_chain(PROMPT) != data
    finally:
        src.stop()
        dst.stop()


# ---------------------------------------------------------------------------
# Keys, the peer ring, sse.pipe
# ---------------------------------------------------------------------------
def test_keys_and_peer_ring_match_reference():
    from skypilot_tpu.inference import affinity as ref_aff
    from skypilot_tpu.serve import load_balancing_policies as lbp
    rng = np.random.default_rng(1)
    peers = [f'10.0.0.{i}:80{i}' for i in range(5)]
    policy = lbp.PrefixAffinityPolicy()
    policy.set_ready_replicas(peers)
    ring = affinity.PeerRing(peers)
    for _ in range(200):
        toks = rng.integers(0, 1000, int(rng.integers(16, 64))).tolist()
        for salt in (b'', affinity.adapter_salt('t')):
            assert affinity.chain_keys(toks, 8, salt) == \
                ref_aff.chain_keys(toks, 8, salt)
            key = affinity.token_affinity_key(toks, 16, salt)
            assert key == ref_aff.token_affinity_key(toks, 16, salt)
            assert ring.affinity_target(key) == policy.affinity_target(key)
    assert affinity.token_affinity_key([1, 2, 3]) is None
    assert affinity.PeerRing([]).affinity_target('ab') is None


def test_chain_body_is_the_references_json():
    """The spliced /kv/import and /kv/migrate body is json.dumps of the
    reference's dict byte for byte, and splits back exactly, also when a
    nested "payload" key comes first or a string holds the word."""
    from skypilot_tpu_torch.inference.http_server import (chain_body,
                                                          split_chain_body)
    data = os.urandom(3001)
    b64 = base64.b64encode(data).decode()
    rest = {'path': '/generate',
            'request': {'tokens': [[1, 2]], 'model': 'x "payload": "y'}}
    body = chain_body(data, rest)
    assert body == json.dumps({'payload': b64, **rest}).encode()
    assert split_chain_body(body) == (rest, data)
    assert chain_body(data, {}) == json.dumps({'payload': b64}).encode()
    assert split_chain_body(chain_body(data, {})) == ({}, data)
    assert chain_body(None, rest) == json.dumps(rest).encode()
    assert split_chain_body(json.dumps(rest).encode()) == (rest, b'')
    nested = json.dumps({'request': {'payload': 'AAAA'},
                         'payload': b64}).encode()
    assert split_chain_body(nested) == ({'request': {'payload': 'AAAA'}},
                                        data)
    assert split_chain_body(b'{"payload" : "AAAA", "a": 1}') == \
        ({'a': 1}, b'\x00\x00\x00')


def test_sse_pipe_forwards_an_http_client_stream():
    """sse.pipe over the port's peer response (http.client) forwards
    every frame as it arrives, and reports EOF."""
    import io
    from skypilot_tpu_torch.inference.http_server import post_peer
    frames = [b'data: {"index": 0, "token": %d}\n\n' % i for i in range(5)]
    ready = threading.Event()

    class Handler(__import__('http.server').server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers['Content-Length']))
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.end_headers()
            for f in frames:
                self.wfile.write(f)
                self.wfile.flush()
                ready.wait(timeout=0.01)

    import http.server
    server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    out = io.BytesIO()
    try:
        with post_peer(f'127.0.0.1:{server.server_address[1]}', '/x',
                       b'{"a": 1}', read_timeout=30) as up:
            assert up.status == 200
            eof, first = sse.pipe(up, out)
    finally:
        server.shutdown()
    assert eof and first is not None
    assert out.getvalue() == b''.join(frames)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------
def _post(port, path, body, timeout=300):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _stats(port):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                timeout=30) as resp:
        return json.loads(resp.read())


def _serving(rt, make=make_server):
    server = make(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def _port_rt(port_model, **kw):
    eng_kw = {k: kw.pop(k) for k in ('kv_spill_bytes', 'kv_cold_dir')
              if k in kw}
    return InferenceRuntime(engine=port_engine(port_model, **eng_kw),
                            model_name='llama-tiny', request_timeout=120.0,
                            **kw)


def _jax_rt(model, params, **kw):
    from skypilot_tpu.inference import runtime as jax_runtime
    return jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=model.config.vocab_size,
        model_name='llama-tiny', max_total_len=96, spec_total=96,
        speculative=0, engine=jax_engine(model, params),
        request_timeout=120.0, **kw)


def test_handoff_to_a_dead_peer_falls_back_to_local(tiny_models):
    port_model = tiny_models['bf16']
    rt = _port_rt(port_model, role='prefill', decode_peers=['127.0.0.1:9'])
    server, port = _serving(rt)
    try:
        ref = rt.engine.submit(list(PROMPT),
                               max_new_tokens=6).result(timeout=300)
        out = _post(port, '/generate', {'tokens': [PROMPT],
                                        'max_new_tokens': 6})
        assert out['tokens'] == [ref]
        stats = _stats(port)
        assert stats['role'] == 'prefill'
        assert stats['handoff']['handoffs'] == 1
        assert stats['handoff']['failures'] == 1
        assert stats['handoff']['decode_peers'] == ['127.0.0.1:9']
        # A batch of rows and a text path never hand off.
        _post(port, '/generate', {'tokens': [PROMPT, PROMPT],
                                  'max_new_tokens': 2})
        assert _stats(port)['handoff']['handoffs'] == 1
        # A malformed body gets its 400 at once (the reference's prefill
        # replica reads the consumed body again and hangs).
        bad = urllib.request.Request(f'http://127.0.0.1:{port}/generate',
                                     data=b'{not json')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
        # /kv/peers replaces the pool.
        assert _post(port, '/kv/peers', {'decode': ['h:1', 'h:2']}) == \
            {'decode': ['h:1', 'h:2']}
        assert rt.decode_peers() == ['h:1', 'h:2']
    finally:
        server.shutdown()
        rt.stop()


_FAULT_CHILD = r'''
import json, sys, threading, urllib.request
sys.path.insert(0, sys.argv[1])
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching, convert, registry
from skypilot_tpu_torch.robustness import faults
model = convert.init_params(registry.model_config('llama-tiny', 96),
                            seed=0, device='cpu')

def rt(**kw):
    eng = batching.ContinuousBatchingEngine(model, num_slots=2,
                                            max_total_len=96)
    return InferenceRuntime(engine=eng, model_name='llama-tiny', **kw)

def serve(r):
    s = make_server(r, 0)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return s.server_address[1]

def post(port, path, body):
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=json.dumps(body).encode())
    return json.loads(urllib.request.urlopen(req, timeout=300).read())

prompt = list(range(2, 34)) + [40, 41]
dec = rt(role='decode')
pre = rt(role='prefill', decode_peers=[f'127.0.0.1:{serve(dec)}'])
port = serve(pre)
want = dec.engine.submit(prompt, max_new_tokens=6).result(timeout=300)
outs = [post(port, '/generate', {'tokens': [prompt],
                                 'max_new_tokens': 6})['tokens'][0]
        for _ in range(2)]
print(json.dumps({'same': all(o == want for o in outs),
                  'prefill': pre.handoff_stats(),
                  'decode': dec.handoff_stats(),
                  'fired': faults.stats()}))
pre.stop(); dec.stop()
'''


def test_injected_handoff_drop_through_the_environment_falls_back():
    """STPU_FAULT_PLAN drops the first kv.handoff in a fresh process:
    that request serves locally, the second hands off; both answers
    equal the decode replica's own tokens."""
    plan = {'rules': [{'point': 'kv.handoff', 'action': 'drop',
                       'times': 1}]}
    env = dict(os.environ, STPU_FAULT_PLAN=json.dumps(plan))
    out = subprocess.run([sys.executable, '-c', _FAULT_CHILD, ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['same']
    assert res['fired']['kv.handoff'] == {'hits': 2, 'fired': 1}
    assert res['prefill']['handoffs'] == 2
    assert res['prefill']['failures'] == 1
    assert res['decode']['kv_imports'] == 1


def test_kv_import_endpoint_plain_and_embedded(tiny_models):
    port_model = tiny_models['bf16']
    src = port_engine(port_model)
    rt = _port_rt(port_model, role='decode')
    server, port = _serving(rt)
    prompt = SYS_PROMPT + [60]
    try:
        ref = src.submit(prompt, max_new_tokens=6).result(timeout=300)
        payload = base64.b64encode(src.export_chain(prompt)).decode()
        body = _post(port, '/kv/import', {'payload': payload})
        assert body['imported']['imported'] == 4
        h0 = rt.engine.prefix_cache.hits
        body = _post(port, '/kv/import', {
            'payload': payload, 'path': '/generate',
            'request': {'tokens': [prompt], 'max_new_tokens': 6}})
        assert body['tokens'] == [ref]
        assert rt.engine.prefix_cache.hits - h0 == 4   # no re-prefill
        assert _stats(port)['handoff']['kv_imports'] == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, '/kv/import', {'payload': 'AAAA'})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, '/kv/import', {'payload': payload,
                                       'path': '/nowhere',
                                       'request': {'tokens': [prompt]}})
        assert err.value.code == 400
        assert rt.engine.healthy()
    finally:
        server.shutdown()
        src.stop()
        rt.stop()


@pytest.mark.parametrize('prefill_side', ['jax', 'port'])
def test_handoff_across_frameworks(prefill_side):
    """A JAX prefill replica (the reference's make_server) hands off to
    a port decode replica, and the reverse: the client's tokens, plain
    and streamed, equal a unified replica's (f32, exact)."""
    from skypilot_tpu.inference import http_server as jax_http
    model, params, port_model = build('bf16', total_pages=40)
    unified = port_engine(port_model)
    want = unified.submit(PROMPT, max_new_tokens=8).result(timeout=300)
    unified.stop()
    if prefill_side == 'jax':
        dec = _port_rt(port_model, role='decode')
        dec_server, dec_port = _serving(dec)
        pre = _jax_rt(model, params, role='prefill',
                      decode_peers=[f'127.0.0.1:{dec_port}'])
        pre_server, pre_port = _serving(pre, jax_http.make_server)
    else:
        dec = _jax_rt(model, params, role='decode')
        dec_server, dec_port = _serving(dec, jax_http.make_server)
        pre = _port_rt(port_model, role='prefill',
                       decode_peers=[f'127.0.0.1:{dec_port}'])
        pre_server, pre_port = _serving(pre)
    try:
        out = _post(pre_port, '/generate', {'tokens': [PROMPT],
                                            'max_new_tokens': 8})
        assert out['tokens'] == [want]
        req = urllib.request.Request(
            f'http://127.0.0.1:{pre_port}/generate',
            data=json.dumps({'tokens': [PROMPT], 'max_new_tokens': 8,
                             'stream': True}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            lines = [ln for ln in resp.read().split(b'\n')
                     if ln.startswith(b'data: ')]
        frames = [json.loads(ln[6:]) for ln in lines[:-1]]
        assert lines[-1] == b'data: [DONE]'
        assert [f['token'] for f in frames if 'token' in f] == \
            want[len(PROMPT):]
        assert frames[-1]['tokens'] == [want]
        pre_stats, dec_stats = _stats(pre_port), _stats(dec_port)
        assert pre_stats['handoff']['handoffs'] == 2
        assert pre_stats['handoff']['failures'] == 0
        assert dec_stats['handoff']['kv_imports'] == 2
        assert dec_stats['role'] == 'decode'
    finally:
        for server, rt in ((pre_server, pre), (dec_server, dec)):
            server.shutdown()
            rt.stop()


def _scraped_view(body):
    from skypilot_tpu.serve.replica_plane import replica_manager as rm
    from skypilot_tpu.serve.serve_state import ReplicaStatus

    def http_get(url, timeout):
        return (200, {}) if url.endswith('/readyz') else (200, body)

    mgr = rm.ReplicaManager(lambda rid, port: None, http_get=http_get)
    view = rm.ReplicaView(replica_id=1, port=1, endpoint='127.0.0.1:1',
                          state=ReplicaStatus.STARTING, spawned_at=0.0)
    mgr._scrape_replica(view)  # pylint: disable=protected-access
    return view


def test_stats_scrape_role_spill_and_migration_like_reference(tmp_path):
    """The same work on a JAX and a port replica (spill tier, a prefix
    evicted and restored, a plain /kv/import, one evacuated session):
    each /stats body through the reference ReplicaManager gives the same
    role / kv_spill / prefix views, and the migration blocks agree."""
    from skypilot_tpu.inference import http_server as jax_http
    from skypilot_tpu.inference import runtime as jax_runtime
    model, params, port_model = build('bf16', total_pages=20)
    src = port_engine(port_model)
    src.submit(PROMPT, max_new_tokens=2).result(timeout=300)
    payload = base64.b64encode(src.export_chain(PROMPT)).decode()
    src.stop()
    jax_eng = jax_engine(model, params, kv_spill_bytes=64 << 20)
    ref_rt = jax_runtime.InferenceRuntime(
        model=model, params=params, vocab_size=model.config.vocab_size,
        model_name='llama-tiny', max_total_len=96, spec_total=96,
        speculative=0, engine=jax_eng, request_timeout=120.0,
        role='decode')
    rt = _port_rt(port_model, role='decode', kv_spill_bytes=64 << 20)
    bodies = []
    try:
        for r, make in ((ref_rt, jax_http.make_server), (rt, make_server)):
            server, port = _serving(r, make)
            _post(port, '/kv/import', {'payload': payload})
            eng = r.engine
            _post(port, '/generate', {'tokens': [PROMPT],
                                      'max_new_tokens': 4})
            _fill_pool(eng, 300, 4)
            _post(port, '/generate', {'tokens': [PROMPT],
                                      'max_new_tokens': 4})
            started = threading.Event()
            # Slowed commits keep the session decoding until the POST.
            emit = eng._emit
            eng._emit = lambda slot, tok, emit=emit: (time.sleep(0.02),
                                                      emit(slot, tok))
            eng.submit(SYS_PROMPT + [9] * 4, max_new_tokens=56,
                       on_token=lambda t: started.set())
            assert started.wait(timeout=300)
            res = _post(port, '/kv/evacuate', {'reason': 'rebalance',
                                               'max_sessions': 1})
            assert res['evacuated'] == 1
            r.record_migration('rebalance', 0.01, ok=True)
            bodies.append(_stats(port))
            server.shutdown()
    finally:
        ref_rt.stop()
        rt.stop()
    ref_body, body = bodies
    ref_view, view = _scraped_view(ref_body), _scraped_view(body)
    fields = ('role', 'prefix_hits', 'prefix_misses', 'prefix_hit_rate',
              'kv_spill_bytes', 'kv_spilled_pages', 'kv_restored_pages',
              'queue_depth', 'engine_healthy')
    assert {f: getattr(view, f) for f in fields} == \
        {f: getattr(ref_view, f) for f in fields}
    assert view.role == 'decode' and view.kv_restored_pages > 0
    for key in ('spilled_pages', 'restored_pages', 'restore_hits',
                'restored_into_pool', 'bytes', 'resident_pages'):
        assert body['kv_spill'][key] == ref_body['kv_spill'][key], key
    for key in ('migrations', 'failures', 'sessions_evacuated',
                'chains_evacuated', 'migrations_in'):
        assert body['migration'][key] == ref_body['migration'][key], key
    assert body['handoff']['kv_imports'] == \
        ref_body['handoff']['kv_imports'] == 1
