"""Port's paged attention (skypilot_tpu_torch/ops/paged_attention.py and
ops/paged_kernel.py) against the JAX reference, CPU:

  - PARITY MATRIX {f32, int8} x {(Hkv, Hq) = (2, 4), (3, 6)} x {decode
    S=1, chunk S=5} over scattered page tables: the port's plain kernel
    version and its paged_decode/chunk_attention match the Pallas
    kernel in interpret mode, `_reference_paged_attention` and
    `paged_chunk_attention(impl='xla')` at atol=1e-5;
  - a fully masked row is 0 on both sides; perturb=0.5 fails the pin;
  - after the same write sequence the port's pools and scales are
    byte-identical to the reference's (page 0, the trash page where
    colliding writes land in unspecified order, excluded);
  - PageAllocator hands out the same pages.
A CUDA kernel cannot run here: chip_smoke.py holds it against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import paged_attention as jax_pa
from skypilot_tpu.ops import pallas_paged as jax_pp
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import paged_kernel as pk

PAGE, PSEQ, TOTAL, D = 8, 4, 32, 16
ATOL = 1e-5


def _inputs(batch, seq, hkv, hq, quantized, seed):
    """numpy inputs: scattered page table, random pools, queries."""
    rng = np.random.default_rng(seed)
    tbl = rng.permutation(TOTAL)[:batch * PSEQ].reshape(batch, PSEQ)
    shape = (hkv, TOTAL, PAGE, D)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((TOTAL, PAGE)) * 0.02).astype(np.float32)
        vs = (rng.random((TOTAL, PAGE)) * 0.02).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((batch, seq, hq, D)).astype(np.float32)
    return q, k, v, tbl.astype(np.int32), ks, vs


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
@pytest.mark.parametrize('hkv,hq', [(2, 4), (3, 6)],
                         ids=['gqa_divisible', 'gqa_remainder'])
def test_decode_parity(quantized, hkv, hq):
    q, k, v, tbl, ks, vs = _inputs(4, 1, hkv, hq, quantized, 1)
    lengths = np.array([1, 7, 20, 32], np.int32)   # cross-page mix
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(lengths - 1)[:, None], _j(tbl),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True))
    gather = np.asarray(jax_pa._reference_paged_attention(
        _j(q[:, 0]), _j(k), _j(v), _j(lengths), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs)))
    plain = pk.fused_paged_attention_reference(
        _t(q), _t(k), _t(v), _t(lengths - 1)[:, None], _t(tbl),
        k_scales=_t(ks), v_scales=_t(vs)).numpy()
    routed = pa.paged_decode_attention(
        _t(q[:, 0]), _t(k), _t(v), _t(lengths), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    port_gather = pa._reference_paged_attention(
        _t(q[:, 0]), _t(k), _t(v), _t(lengths), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(plain, pallas, atol=ATOL)
    np.testing.assert_allclose(plain[:, 0], gather, atol=ATOL)
    np.testing.assert_allclose(routed, gather, atol=ATOL)
    np.testing.assert_allclose(port_gather, gather, atol=ATOL)


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
@pytest.mark.parametrize('hkv,hq', [(2, 4), (3, 6)],
                         ids=['gqa_divisible', 'gqa_remainder'])
def test_chunk_parity(quantized, hkv, hq):
    q, k, v, tbl, ks, vs = _inputs(3, 5, hkv, hq, quantized, 3)
    rng = np.random.default_rng(4)
    pos = rng.integers(0, PSEQ * PAGE, (3, 5)).astype(np.int32)
    xla = np.asarray(jax_pa.paged_chunk_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), impl='xla'))
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    plain = pk.fused_paged_attention_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    routed = pa.paged_chunk_attention(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(plain, xla, atol=ATOL)
    np.testing.assert_allclose(plain, pallas, atol=ATOL)
    np.testing.assert_allclose(routed, xla, atol=ATOL)


def test_fully_masked_row_is_zero():
    q, k, v, tbl, ks, vs = _inputs(3, 2, 2, 4, True, 5)
    pos = np.array([[-1, -1], [3, 9], [-1, 0]], np.int32)
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    plain = pk.fused_paged_attention(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    assert np.all(np.isfinite(plain))
    assert np.all(plain[0] == 0) and np.all(plain[2, 0] == 0)
    np.testing.assert_allclose(plain, pallas, atol=ATOL)


def test_perturbed_kernel_fails_the_pin():
    q, k, v, tbl, ks, vs = _inputs(4, 1, 2, 4, True, 1)
    pos = np.array([[0], [6], [19], [31]], np.int32)
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    calls = pk.plain_calls
    bad = pk.fused_paged_attention(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs), perturb=0.5).numpy()
    assert pk.plain_calls == calls + 1 and pk.launches == 0
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, pallas, atol=ATOL)


def test_quantize_rows_match_bytes():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((5, 7, 3, D)) * 3).astype(np.float32)
    x[1, 2] = 0.0                                   # all-zero token
    jq, js = jax_pa.quantize_kv_rows(jnp.asarray(x))
    tq, ts = pa.quantize_kv_rows(torch.from_numpy(x))
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        pa.dequantize_kv(tq, ts).numpy(),
        np.asarray(jax_pa.dequantize_kv(jq, js)))


def _raw(x) -> np.ndarray:
    """Bytes-comparable view (bf16 through a 16-bit integer view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize('kind', ['f32', 'bf16', 'int8'])
def test_writes_are_byte_identical(kind):
    rng = np.random.default_rng(8)
    hkv, batch, chunk = 2, 3, 6
    quant = kind == 'int8'
    jdt = {'f32': jnp.float32, 'bf16': jnp.bfloat16, 'int8': jnp.int8}[kind]
    tdt = {'f32': torch.float32, 'bf16': torch.bfloat16,
           'int8': torch.int8}[kind]
    # Rows own pages 1..12; the last column of every row is unallocated
    # (trash page 0), so padded-tail writes collide there.
    tbl = np.zeros((batch, PSEQ), np.int32)
    tbl[:, :3] = (1 + rng.permutation(batch * 3)).reshape(batch, 3)
    jk, jv = jax_pa.init_pages(hkv, TOTAL, PAGE, D, jdt)
    tk, tv = pa.init_pages(hkv, TOTAL, PAGE, D, tdt)
    jks = jvs = tks = tvs = None
    if quant:
        jks, jvs = (jnp.zeros((TOTAL, PAGE), jnp.float32) for _ in '01')
        tks, tvs = (torch.zeros((TOTAL, PAGE)) for _ in '01')
    # chunk writes at offsets 0, 10 and 23 (the last runs into trash
    # entries), then three single-token writes (one row's in trash).
    for offset in (0, 10, 23):
        pos = (offset + np.arange(chunk))[None].repeat(batch, 0).astype(
            np.int32)
        kn = rng.standard_normal((batch, chunk, hkv, D)).astype(np.float32)
        vn = rng.standard_normal((batch, chunk, hkv, D)).astype(np.float32)
        if quant:
            jk, jv, jks, jvs = jax_pa.write_kv_chunk_quant(
                jk, jv, jks, jvs, _j(kn), _j(vn), _j(pos), _j(tbl))
            pa.write_kv_chunk_quant(tk, tv, tks, tvs, _t(kn), _t(vn),
                                    _t(pos), _t(tbl))
        else:
            jk, jv = jax_pa.write_kv_chunk(jk, jv, _j(kn).astype(jdt),
                                           _j(vn).astype(jdt), _j(pos),
                                           _j(tbl))
            pa.write_kv_chunk(tk, tv, _t(kn), _t(vn), _t(pos), _t(tbl))
    for step in range(3):
        pos = np.array([16 + step, 5 + step, 30 + step], np.int32)
        kn = rng.standard_normal((batch, hkv, D)).astype(np.float32)
        vn = rng.standard_normal((batch, hkv, D)).astype(np.float32)
        if quant:
            jk, jv, jks, jvs = jax_pa.write_kv_quant(
                jk, jv, jks, jvs, _j(kn), _j(vn), _j(pos), _j(tbl))
            pa.write_kv_quant(tk, tv, tks, tvs, _t(kn), _t(vn), _t(pos),
                              _t(tbl))
        else:
            jk, jv = jax_pa.write_kv(jk, jv, _j(kn).astype(jdt),
                                     _j(vn).astype(jdt), _j(pos), _j(tbl))
            pa.write_kv(tk, tv, _t(kn), _t(vn), _t(pos), _t(tbl))
    pairs = [(tk, jk), (tv, jv)]
    if quant:
        pairs += [(tks[:, None], jks[:, None]), (tvs[:, None], jvs[:, None])]
    for port, ref in pairs:
        a, b = _raw(port), _raw(ref)
        if a.ndim == 4:
            a, b = a[:, 1:], b[:, 1:]
        else:
            a, b = a[1:], b[1:]
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_page_allocator_sequence_matches():
    ref = jax_pa.PageAllocator(12, 4)
    port = pa.PageAllocator(12, 4)
    for op, arg in [('allocate', 1), ('allocate', 3), ('release', [2, 0]),
                    ('allocate', 4), ('release', [5]), ('allocate', 2)]:
        assert getattr(port, op)(arg) == getattr(ref, op)(arg)
        assert port.free_pages == ref.free_pages
    assert port.pages_needed(17, 8) == ref.pages_needed(17, 8) == 3
    with pytest.raises(MemoryError):
        port.allocate(99)
