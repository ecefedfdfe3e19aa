"""Port's paged attention (skypilot_tpu_torch/ops/paged_attention.py and
ops/paged_kernel.py) against the JAX reference, CPU:

  - PARITY MATRIX {f32, int8} x {(Hkv, Hq) = (2, 4), (3, 6), (4, 28)
    (Qwen2-7B's heads, G = 7)} x {decode S=1, chunk S=5} over scattered
    page tables: the port's plain kernel
    version and its paged_decode/chunk_attention match the Pallas
    kernel in interpret mode, `_reference_paged_attention` and
    `paged_chunk_attention(impl='xla')` at atol=1e-5;
  - a fully masked row is 0 on both sides; perturb=0.5 fails the pin;
  - after the same write sequence the port's pools and scales are
    byte-identical to the reference's (page 0, the trash page where
    colliding writes land in unspecified order, excluded);
  - PageAllocator hands out the same pages;
  - the CUDA kernel's split route, through the plain version of its
    split-K decomposition and int8 scale folding, matches the Pallas
    kernel and the plain version at atol=1e-5 over splits that do not
    divide the page table, empty splits and rows empty in every split,
    also at Qwen2-7B's heads;
    the wrapper's split plan and route choice are fixed functions of
    shapes, and a shape no route takes raises before any build.
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
@pytest.mark.parametrize('hkv,hq', [(2, 4), (3, 6), (4, 28)],
                         ids=['gqa_divisible', 'gqa_remainder', 'qwen2_g7'])
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
@pytest.mark.parametrize('hkv,hq', [(2, 4), (3, 6), (4, 28)],
                         ids=['gqa_divisible', 'gqa_remainder', 'qwen2_g7'])
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


# -- the CUDA kernel's routes, through their plain versions -------------------
SPLIT_PSEQ, SPLIT_TOTAL = 10, 64    # 80 tokens a row: splits of 32 or 64


def _split_inputs(batch, seq, quantized, seed, heads=(2, 4)):
    """(Hkv, Hq) = `heads` inputs over SPLIT_PSEQ pages a row."""
    rng = np.random.default_rng(seed)
    tbl = rng.permutation(SPLIT_TOTAL)[:batch * SPLIT_PSEQ].reshape(
        batch, SPLIT_PSEQ).astype(np.int32)
    shape = (heads[0], SPLIT_TOTAL, PAGE, D)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((SPLIT_TOTAL, PAGE)) * 0.02).astype(np.float32)
        vs = (rng.random((SPLIT_TOTAL, PAGE)) * 0.02).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((batch, seq, heads[1], D)).astype(np.float32)
    return q, k, v, tbl, ks, vs


# Row ends: nothing visible (every split empty), a full row, rows whose
# later splits are empty, a row ending on a 32- and a 64-token boundary
# and one just past it.
SPLIT_ENDS = np.array([-1, 79, 20, 31, 63, 64], np.int32)


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
@pytest.mark.parametrize('seq', [1, 3], ids=['decode', 's3'])
@pytest.mark.parametrize('split_tokens', [32, 64, 96],
                         ids=['st32', 'st64', 'st96'])
def test_split_k_reference_parity(quantized, seq, split_tokens):
    """The split route's decomposition (partials per split, log-sum-exp
    merge, int8 scales folded into scores and weights) equals the Pallas
    kernel and the plain version; 80 tokens do not divide into splits
    of 32 or 64, and 96 leaves one split covering every row."""
    q, k, v, tbl, ks, vs = _split_inputs(len(SPLIT_ENDS), seq, quantized,
                                         11)
    pos = SPLIT_ENDS[:, None] - np.arange(seq)[::-1][None]
    pos = np.maximum(pos, -1).astype(np.int32)
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    plain = pk.fused_paged_attention_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    split = pk.fused_paged_attention_split_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), split_tokens=split_tokens,
        k_scales=_t(ks), v_scales=_t(vs)).numpy()
    assert np.all(np.isfinite(split))
    assert np.all(split[0, pos[0] < 0] == 0)
    np.testing.assert_allclose(split, pallas, atol=ATOL)
    np.testing.assert_allclose(split, plain, atol=ATOL)


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
@pytest.mark.parametrize('seq', [1, 2], ids=['decode', 's2'])
def test_split_k_reference_parity_at_qwen2_heads(quantized, seq):
    """The split decomposition at G = 7 (Hq=28, Hkv=4): 7 and 14 query
    rows a kv head, neither a power of two."""
    q, k, v, tbl, ks, vs = _split_inputs(len(SPLIT_ENDS), seq, quantized,
                                         13, heads=(4, 28))
    pos = SPLIT_ENDS[:, None] - np.arange(seq)[::-1][None]
    pos = np.maximum(pos, -1).astype(np.int32)
    pallas = np.asarray(jax_pp.fused_paged_attention(
        _j(q), _j(k), _j(v), _j(pos), _j(tbl), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    split = pk.fused_paged_attention_split_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), split_tokens=32,
        k_scales=_t(ks), v_scales=_t(vs)).numpy()
    assert np.all(split[0, pos[0] < 0] == 0)
    np.testing.assert_allclose(split, pallas, atol=ATOL)


def test_split_k_reference_perturbed_fails_the_pin():
    q, k, v, tbl, ks, vs = _split_inputs(len(SPLIT_ENDS), 1, True, 12)
    pos = SPLIT_ENDS[:, None]
    plain = pk.fused_paged_attention_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    bad = pk.fused_paged_attention_split_reference(
        _t(q), _t(k), _t(v), _t(pos), _t(tbl), split_tokens=32,
        k_scales=_t(ks), v_scales=_t(vs), perturb=0.5).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, plain, atol=ATOL)


@pytest.mark.parametrize('shape', [
    (8, 8, 4, 64, 16, 132), (1, 8, 4, 256, 16, 132), (32, 8, 4, 64, 16, 132),
    (1, 8, 4, 64, 16, 132), (3, 8, 16, 64, 16, 132), (2, 2, 6, 10, 8, 4),
    (5, 3, 2, 7, 64, 132), (1, 1, 1, 1, 8, 132)])
def test_split_plan_is_deterministic_and_covers_the_table(shape):
    batch, hkv, rows, pps, page, sms = shape
    plan = pk.split_plan(*shape)
    assert plan == pk.split_plan(*shape)
    rows_per_block, groups, n_split, split_tokens = plan
    tokens = pps * page
    assert rows_per_block in (4, 8) and rows_per_block * groups >= rows
    assert rows_per_block * (groups - 1) < rows
    assert split_tokens % pk.SPLIT_TILE == 0
    assert 1 <= n_split <= pk.MAX_SPLITS
    assert (n_split - 1) * split_tokens < tokens <= n_split * split_tokens


def test_split_plan_at_llama3_decode():
    """Llama-3-8B decode (Hkv=8, G=4) on 132 SMs: at B=8, context 1024,
    4 splits of 256 tokens (256 blocks, one wave of 2 an SM); at B=1,
    context 4096, the most splits (32 of 128 tokens); at B=32 the
    (batch row, kv head) pairs alone fill the wave. A table one page
    longer, cut for the shorter width, keeps its cut and adds a tail
    split, past MAX_SPLITS where it must."""
    assert pk.split_plan(8, 8, 4, 64, 16, 132) == (4, 1, 4, 256)
    assert pk.split_plan(1, 8, 4, 256, 16, 132) == (4, 1, 32, 128)
    assert pk.split_plan(32, 8, 4, 64, 16, 132) == (4, 1, 1, 1024)
    # One page more (a --decode-chunk / --speculative engine's table at
    # max_total_len 1024 / 4096): the same cut, and a tail split.
    assert pk.split_plan(8, 8, 4, 65, 16, 132, 1024) == (4, 1, 5, 256)
    assert pk.split_plan(1, 8, 4, 257, 16, 132, 4096) == (4, 1, 33, 128)
    assert pk.split_plan(32, 8, 4, 65, 16, 132, 1024) == (4, 1, 2, 1024)


@pytest.mark.parametrize('batch', [1, 8, 32])
@pytest.mark.parametrize('width,page', [(1024, 16), (4096, 16), (1000, 16),
                                        (990, 64), (333, 8)])
@pytest.mark.parametrize('lookahead', [1, 3, 4, 8])
def test_split_plan_cut_ignores_the_write_lookahead(batch, width, page,
                                                    lookahead):
    """An engine at max_total_len `width` whose table carries `lookahead`
    more tokens (--decode-chunk lookahead + 1, --speculative K) cuts the
    table as the single-step engine at that width does: the same split
    size, so every split a row below `width` reaches is the same, and
    the rest of the table lies in tail splits. Where its table is
    `width` rounded up to a tile, the single-step engine's plan is the
    one made with no width given (no extra split), and the splits below
    `width` stay within the one-wave budget."""
    sms = 132
    pairs = batch * 8                    # Llama-3-8B: Hkv = 8, G = 4
    single = -(-width // page)
    wide = -(-(width + lookahead) // page)
    plan_single = pk.split_plan(batch, 8, 4, single, page, sms, width)
    plan_wide = pk.split_plan(batch, 8, 4, wide, page, sms, width)
    assert plan_single[3] == plan_wide[3]
    split_tokens = plan_single[3]
    n_main = -(-width // split_tokens)
    assert n_main <= plan_single[2] <= plan_wide[2] <= pk.SPLIT_LIMIT
    assert n_main * pairs <= max(pk.SPLIT_BLOCKS_PER_SM * sms, pairs)
    for pps, (_, _, n_split, st) in ((single, plan_single),
                                     (wide, plan_wide)):
        assert (n_split - 1) * st < pps * page <= n_split * st
    if -(-single * page // pk.SPLIT_TILE) == -(-width // pk.SPLIT_TILE):
        assert plan_single == pk.split_plan(batch, 8, 4, single, page, sms)


def test_split_plan_grows_splits_only_past_the_kernel_limit():
    """A table far wider than the width it is cut for: the splits grow so
    that the call stays within the kernel's SPLIT_LIMIT."""
    _, _, n_split, st = pk.split_plan(1, 8, 4, 256, 16, 132, 64)
    assert n_split <= pk.SPLIT_LIMIT and n_split * st >= 4096
    assert pk.split_plan(1, 8, 4, 256, 16, 132, 10 ** 6) == \
        pk.split_plan(1, 8, 4, 256, 16, 132)


@pytest.mark.parametrize('args,route', [
    ((torch.bfloat16, torch.bfloat16, 1, 32, 8, 16, 128), 'split'),
    ((torch.bfloat16, torch.int8, 1, 32, 8, 8, 128), 'split'),
    ((torch.bfloat16, torch.bfloat16, 4, 32, 8, 16, 128), 'split'),
    ((torch.bfloat16, torch.bfloat16, 5, 32, 8, 16, 128), 'chunk'),
    ((torch.bfloat16, torch.int8, 256, 32, 8, 16, 64), 'chunk'),
    ((torch.bfloat16, torch.bfloat16, 256, 32, 8, 64, 128), 'chunk'),
    ((torch.float32, torch.float32, 1, 32, 8, 16, 128), 'scalar'),
    ((torch.float32, torch.int8, 256, 32, 8, 16, 128), 'scalar'),
    ((torch.float32, torch.bfloat16, 1, 32, 8, 16, 128), 'scalar'),
    ((torch.bfloat16, torch.float32, 1, 32, 8, 16, 128), 'scalar'),
    ((torch.bfloat16, torch.bfloat16, 1, 32, 8, 12, 128), 'scalar'),
    ((torch.bfloat16, torch.bfloat16, 256, 32, 8, 4, 128), 'scalar'),
    ((torch.bfloat16, torch.bfloat16, 1, 32, 8, 16, 96), 'scalar'),
    ((torch.bfloat16, torch.bfloat16, 1, 6, 3, 16, 16), 'scalar'),
    # Qwen2-7B's heads (G = 7): 7 rows a kv head at decode, 14 at S=2,
    # 21 at S=3.
    ((torch.bfloat16, torch.bfloat16, 1, 28, 4, 16, 128), 'split'),
    ((torch.bfloat16, torch.int8, 2, 28, 4, 16, 128), 'split'),
    ((torch.bfloat16, torch.bfloat16, 3, 28, 4, 16, 128), 'chunk'),
    ((torch.bfloat16, torch.int8, 256, 28, 4, 16, 128), 'chunk')])
def test_route_rule(args, route):
    assert pk.choose_route(*args) == route
    assert pk.choose_route(*args) == route       # a rule, not a state


@pytest.mark.parametrize('head_dim', [72, 144])
def test_untaken_shape_raises_before_any_build(monkeypatch, head_dim):
    def no_build():
        raise AssertionError('the kernel library was asked for')

    monkeypatch.setattr(pk, '_library', no_build)
    q = torch.zeros(1, 1, 4, head_dim, dtype=torch.bfloat16)
    pages = torch.zeros(2, 4, 16, head_dim, dtype=torch.bfloat16)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    tbl = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match='head_dim'):
        pk._launch(q, pages, pages, pos, tbl, None, None, 0.0)
    with pytest.raises(ValueError, match='head_dim'):
        pk.choose_route(q.dtype, pages.dtype, 1, 4, 2, 16, head_dim)
    launches = dict(pk.route_launches)
    # A shape a route takes gets as far as the library.
    q, pages = q[..., :64].contiguous(), pages[..., :64].contiguous()
    with pytest.raises(AssertionError, match='library'):
        pk._launch(q, pages, pages, pos, tbl, None, None, 0.0)
    assert pk.route_launches == launches
