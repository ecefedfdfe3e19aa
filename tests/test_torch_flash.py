"""Port's flash attention (skypilot_tpu_torch/ops/flash_kernel.py and the
ops/attention.py dispatch) against the upstream Pallas TPU flash kernel
that the JAX package dispatches (skypilot_tpu.ops.attention
.dot_product_attention(..., impl='flash')), run on the CPU in Pallas
interpret mode, on the same numpy inputs, f32:

  - forward within 1e-5 (f32 sums in another order; the upstream kernel
    normalizes its accumulator every block, the port once at the end);
  - dq, dk and dv within 1e-4 (the backward recomputes P from the saved
    logsumexp and sums over 256-384 keys in another order);
  - causal, S in {256, 384}, GQA Hq=4, Hkv=2; and S=128 at Qwen2-7B's
    heads (Hq=28, Hkv=4: G = 7), D=32;
  - the perturbed plain version (scores x 1.5) fails the pin;
  - the saved logsumexp equals the reference's logsumexp of the scores;
  - the dispatch routes seq >= 2048 to flash only for CUDA tensors.
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu_torch.ops import attention as pt_attention
from skypilot_tpu_torch.ops import flash_kernel as fk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def inputs(seq, hq=4, hkv=2, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, seq, hq, dim)).astype(np.float32)
    k = rng.standard_normal((1, seq, hkv, dim)).astype(np.float32)
    v = rng.standard_normal((1, seq, hkv, dim)).astype(np.float32)
    ct = rng.standard_normal((1, seq, hq, dim)).astype(np.float32)
    return q, k, v, ct


def jax_flash(q, k, v, ct):
    """Upstream flash forward and the grads of sum(out * ct)."""
    def loss(q, k, v):
        out = jax_attention.dot_product_attention(q, k, v, causal=True,
                                                  impl='flash')
        return jnp.sum(out * ct), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_flash(q, k, v, ct, perturb=0.0):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fk.flash_attention(qt, kt, vt, perturb=perturb)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.fixture(scope='module', params=[256, 384])
def case(request):
    q, k, v, ct = inputs(request.param, seed=request.param)
    return (q, k, v, ct), jax_flash(q, k, v, ct)


def test_forward_matches_upstream_kernel(case):
    args, (ref, _) = case
    plain0 = fk.plain_calls
    out, _ = port_flash(*args)
    assert fk.plain_calls == plain0 + 2   # forward and backward
    np.testing.assert_allclose(out, ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize('which', [0, 1, 2], ids=['dq', 'dk', 'dv'])
def test_grads_match_upstream_kernel(case, which):
    args, (_, ref_grads) = case
    _, grads = port_flash(*args)
    assert grads[which].shape == ref_grads[which].shape
    np.testing.assert_allclose(grads[which], ref_grads[which],
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_perturbed_plain_version_fails_the_pin(case):
    args, (ref, ref_grads) = case
    out, grads = port_flash(*args, perturb=0.5)
    assert np.abs(out - ref).max() > 100 * FWD_TOL
    assert np.abs(grads[0] - ref_grads[0]).max() > 100 * GRAD_TOL


def test_qwen2_heads_match_upstream_kernel():
    """Qwen2-7B's head shape (Hq=28, Hkv=4: G = 7) at a small width: the
    forward and dQ/dK/dV of the plain versions against the upstream
    kernel."""
    args = inputs(128, hq=28, hkv=4, dim=32, seed=7)
    ref, ref_grads = jax_flash(*args)
    out, grads = port_flash(*args)
    np.testing.assert_allclose(out, ref, atol=FWD_TOL, rtol=FWD_TOL)
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_lse_is_the_scores_logsumexp():
    q, k, v, _ = inputs(128, seed=3)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = fk.flash_forward_reference(qt, kt, vt)
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum('bqhd,bkhd->bhqk', q.astype(np.float64),
                  kr.astype(np.float64)) / 8.0
    s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_dispatch_matches_plain_route_and_routes_by_device(monkeypatch):
    q, k, v, _ = inputs(96, seed=4)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    flash = pt_attention.dot_product_attention(qt, kt, vt, impl='flash')
    plain = pt_attention.dot_product_attention(qt, kt, vt, impl='xla')
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    calls = []
    monkeypatch.setattr(fk, 'flash_attention',
                        lambda *a, **kw: calls.append(a[0].shape))
    long_q = torch.zeros(1, pt_attention._FLASH_MIN_SEQ, 2, 16)
    long_kv = torch.zeros(1, pt_attention._FLASH_MIN_SEQ, 1, 16)
    pt_attention.dot_product_attention(long_q, long_kv, long_kv)
    assert calls == []          # CPU tensors: the plain route
    with pytest.raises(ValueError, match='causal only'):
        pt_attention.dot_product_attention(qt, kt, vt, causal=False,
                                           impl='flash')


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v, _ = inputs(64, seed=5)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        fk.flash_attention(qt, kt, vt, impl='cuda')
    with fk.impl_scope('cuda'):
        with pytest.raises(RuntimeError):
            fk.flash_attention(qt, kt, vt)


# -- the kernel wrappers' own checks (the CUDA kernels run only on the card) --
def _bf16(*shape, offset=0):
    """A contiguous bf16 tensor; `offset` elements into its storage."""
    return torch.zeros(int(np.prod(shape)) + offset,
                       dtype=torch.bfloat16)[offset:].view(shape)


def _fwd_args(dim=64, seq=64):
    return _bf16(1, seq, 4, dim), _bf16(1, seq, 2, dim), _bf16(1, seq, 2, dim)


def _rows(seq=64, dtype=torch.float32):
    return torch.zeros(1, 4, seq, dtype=dtype)


REFUSED = {
    'mixed_dtypes': (lambda q, k, v: (q, k.float(), v), TypeError),
    'head_dim_48': (lambda q, k, v: _fwd_args(dim=48), ValueError),
    'head_dim_256': (lambda q, k, v: _fwd_args(dim=256), ValueError),
    'non_contiguous': (lambda q, k, v: (
        q.transpose(1, 2).contiguous().transpose(1, 2), k, v), ValueError),
    'misaligned': (lambda q, k, v: (_bf16(1, 64, 4, 64, offset=1), k, v),
                   ValueError),
    'kv_shape': (lambda q, k, v: (q, k, v[:, :, :1]), ValueError),
}


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError('the kernel library was asked for')
    monkeypatch.setattr(fk, '_library', refuse)


@pytest.mark.parametrize('name', list(REFUSED))
def test_forward_kernel_refuses_before_building(no_build, name):
    make, exc = REFUSED[name]
    with pytest.raises(exc):
        fk.flash_forward_kernel(*make(*_fwd_args()))


@pytest.mark.parametrize('name', list(REFUSED) + [
    'do_dtype', 'lse_dtype', 'lse_shape'])
def test_backward_kernel_refuses_before_building(no_build, name):
    q, k, v = _fwd_args()
    do, lse, di = _bf16(1, 64, 4, 64), _rows(), _rows()
    if name in REFUSED:
        make, exc = REFUSED[name]
        q, k, v = make(q, k, v)
        if q.shape != do.shape:
            do = _bf16(*q.shape)
            lse = di = _rows(q.shape[1])
    elif name == 'do_dtype':
        do, exc = do.float(), TypeError
    elif name == 'lse_dtype':
        lse, exc = _rows(dtype=torch.bfloat16), ValueError
    else:
        di, exc = _rows(seq=63), ValueError
    with pytest.raises(exc):
        fk.flash_backward_kernel(q, k, v, do, lse, di)


def test_torch_route_counts_two_plain_calls_and_no_launches():
    q, k, v, ct = inputs(64, seed=6)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    counts0 = (fk.plain_calls, fk.fwd_launches, fk.bwd_launches)
    out = fk.flash_attention(qt, kt, vt, impl='torch')
    (out * torch.from_numpy(ct)).sum().backward()
    assert (fk.plain_calls, fk.fwd_launches, fk.bwd_launches) == (
        counts0[0] + 2, counts0[1], counts0[2])
    assert all(t.grad is not None for t in (qt, kt, vt))


class _FakeLibrary:
    """Stands in for the built library: records the backward's arguments
    and launches nothing."""

    def __init__(self):
        self.calls = []

    def skypilot_flash_bwd(self, *args):
        self.calls.append(args)
        return 0

    def skypilot_flash_error_string(self, err):
        return b'fake'


@pytest.mark.parametrize('seq', [64, 66])
def test_backward_wrapper_pads_lse_rows_and_casts_the_workspace(
        monkeypatch, seq):
    """bf16: lse/di rows reach the kernel padded to 4 floats (TMA's
    16-byte strides), dQ is a zeroed f32 workspace cast to bf16, one
    launch is counted."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fk, '_library', lambda: lib)
    monkeypatch.setattr(fk.torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 0}))
    q, k, v = _fwd_args(seq=seq)
    do, lse, di = _bf16(1, seq, 4, 64), _rows(seq), _rows(seq)
    launches = fk.bwd_launches
    dq, dk, dv = fk.flash_backward_kernel(q, k, v, do, lse, di)
    assert fk.bwd_launches == launches + 1
    assert len(lib.calls) == 1 and lib.calls[0][9:16] == (
        1, seq, 4, 2, 64, 1, -(-seq // 4) * 4)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert not dq.any()          # the zeroed workspace, cast
    assert dk.shape == k.shape and dv.shape == v.shape
