"""Ring attention (skypilot_tpu_torch/ops/ring_attention.py) on a 4-rank
gloo ring (MeshConfig(seq=4), spawned CPU processes), f32:

  - each rank holds block r of the sequence and makes K ring steps in
    the forward and K in the backward;
  - the blocks' outputs, joined, are the port's plain full attention
    (`reference_attention`) within 1e-5, causal and not, and so are the
    grads (dq, dk, dv) for a seeded upstream gradient;
  - both follow the reference's `ring_attention` on MeshConfig(seq=4)
    over four XLA host devices (forward and jax.vjp) within 1e-5;
  - a ring that keeps its block instead of the one it received after
    step 1 (`skip_rotation=1`) misses the pin;
  - the attention dispatch under `context_parallel` repeats GQA k/v
    before the ring; the ring route without a ring, and the flash and
    plain routes under one, raise.
"""
import sys
import threading
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402
from test_torch_fsdp import run_job  # noqa: E402

from skypilot_tpu.ops import ring_attention as jax_ra  # noqa: E402
from skypilot_tpu.parallel import mesh as jax_mesh  # noqa: E402
from skypilot_tpu_torch.ops import attention as attention_ops  # noqa: E402
from skypilot_tpu_torch.ops import ring_attention as ra  # noqa: E402
from skypilot_tpu_torch.parallel import context  # noqa: E402

TOL = 1e-5
WORLD = 4


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return run_job(W.ring_job, WORLD, str(tmp_path_factory.mktemp('ring')))


def joined(ranks, causal, key, index=None):
    parts = [r[causal][key] if index is None else r[causal][key][index]
             for r in ranks]
    return np.concatenate(parts, axis=1)


def plain(causal):
    """The port's plain full attention and its grads of sum(out * do)."""
    q, k, v, do = W.ring_inputs()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ra.reference_attention(*leaves, causal=causal)
    out.backward(do)
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def reference_ring(causal):
    """The reference's ring on MeshConfig(seq=4) over four XLA host
    devices: its output and jax.vjp with the same upstream gradient."""
    q, k, v, do = (jnp.asarray(x.numpy()) for x in W.ring_inputs())
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(seq=WORLD),
                              devices=jax.devices()[:WORLD])

    def ring(q, k, v):
        with mesh:
            return jax_ra.ring_attention(q, k, v, mesh=mesh,
                                         heads_axis=None, causal=causal)

    out, vjp = jax.vjp(ring, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def test_each_rank_holds_its_block_and_walks_the_ring(ranks):
    width = W.RING_SHAPE[1] // WORLD
    for rank, result in enumerate(ranks):
        assert result['block'] == (rank * width, (rank + 1) * width)
        assert result['ring'] == tuple(range(WORLD))
        assert result['index'] == rank
        for causal in (True, False):
            assert result[causal]['steps'] == (WORLD, WORLD)


@pytest.mark.parametrize('causal', [True, False])
def test_ring_matches_the_plain_version(ranks, causal):
    out, grads = plain(causal)
    np.testing.assert_allclose(joined(ranks, causal, 'out'), out,
                               atol=TOL, rtol=TOL)
    for i, want in enumerate(grads):
        np.testing.assert_allclose(joined(ranks, causal, 'grads', i), want,
                                   atol=TOL, rtol=TOL, err_msg='qkv'[i])


@pytest.mark.parametrize('causal', [True, False])
def test_ring_matches_the_reference_ring(ranks, causal):
    out, grads = reference_ring(causal)
    np.testing.assert_allclose(joined(ranks, causal, 'out'), out,
                               atol=TOL, rtol=TOL)
    for i, want in enumerate(grads):
        np.testing.assert_allclose(joined(ranks, causal, 'grads', i), want,
                                   atol=TOL, rtol=TOL, err_msg='qkv'[i])


@pytest.mark.parametrize('causal', [True, False])
def test_a_ring_that_skips_a_rotation_fails_the_pin(ranks, causal):
    out, _ = plain(causal)
    err = np.abs(joined(ranks, causal, 'perturbed') - out).max()
    assert err > 100 * TOL, err


def test_dispatch_repeats_gqa_heads_before_the_ring(ranks):
    q, k, v, _ = W.ring_inputs()
    rep = q.shape[2]
    want = ra.reference_attention(q, k[:, :, :1].repeat_interleave(rep, 2),
                                  v[:, :, :1].repeat_interleave(rep, 2))
    got = np.concatenate([r['gqa'] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want.numpy(), atol=TOL, rtol=TOL)


def test_the_ring_route_needs_a_ring_and_is_the_only_route_under_one():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match='needs an active seq group'):
        attention_ops.dot_product_attention(q, q, q, impl='ring')
    ring = context.SeqGroup(group=None, index=0, size=2, ranks=(0, 1))
    seen = []
    with mock.patch.object(context, 'seq_group_of', lambda mesh: ring):
        with context.context_parallel(None):
            assert context.active_seq_group() is ring
            # Seen from other threads too: autograd's device threads run
            # the backward and --remat's recompute on the card.
            reader = threading.Thread(
                target=lambda: seen.append(context.active_seq_group()))
            reader.start()
            reader.join(timeout=30)
            assert seen == [ring]
            for impl in ('flash', 'xla'):
                with pytest.raises(ValueError, match='use the ring'):
                    attention_ops.dot_product_attention(q, q, q, impl=impl)
    assert context.active_seq_group() is None
    assert context.seq_group_of(None) is None
