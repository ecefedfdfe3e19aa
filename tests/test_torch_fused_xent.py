"""Port's fused blockwise LM-head cross-entropy
(skypilot_tpu_torch/ops/fused_xent.py) against the JAX op
(skypilot_tpu/ops/fused_xent.py) on the same numpy inputs, f32:

  - pick_block agrees on every vocab size tried;
  - loss within 1e-5 and grads wrt hidden and head within 1e-5
    (f32 sums in another order) with a vocab no candidate block divides
    (2500: a padded last chunk), an explicit block, and a vocab that
    fits one chunk (the dense path);
  - the port's [V, H] head and the reference's [H, V] head are the same
    function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import fused_xent as jax_xent
from skypilot_tpu_torch.ops import fused_xent as pt_xent
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


@pytest.mark.parametrize('vocab', [512, 1000, 2500, 4096, 32000, 128256,
                                   152064])
def test_pick_block_matches(vocab):
    assert pt_xent.pick_block(vocab) == jax_xent.pick_block(vocab)


@pytest.mark.parametrize('vocab,block', [(2500, None), (2500, 1024),
                                         (300, None)])
def test_loss_and_grads_match(vocab, block):
    rng = np.random.default_rng(vocab)
    hidden = rng.standard_normal((2, 9, 32)).astype(np.float32)
    head = (rng.standard_normal((32, vocab)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    tokens[0, 3] = vocab - 1          # a target in the padded last chunk

    def jloss(h, w):
        return jax_xent.fused_next_token_loss(h, w, jnp.asarray(tokens),
                                              vocab_in_rows=False,
                                              block_size=block)

    ref, (ref_dh, ref_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(head.T.copy(), requires_grad=True)   # [V, H]
    loss = pt_xent.fused_next_token_loss(h, w, torch.from_numpy(tokens),
                                         vocab_in_rows=True,
                                         block_size=block)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_dh),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(w.grad.numpy().T, np.asarray(ref_dw),
                               atol=TOL, rtol=TOL)


def test_find_lm_head_orientation():
    head = torch.zeros(7, 3)
    assert pt_xent.find_lm_head({'lm_head': head}) == (head, True)
    with pytest.raises(ValueError, match='no LM head'):
        pt_xent.find_lm_head({'tok_embed': head})
    with pytest.raises(ValueError, match='ambiguous'):
        pt_xent.fused_next_token_loss(torch.zeros(1, 2, 4),
                                      torch.zeros(4, 4),
                                      torch.zeros(1, 2, dtype=torch.long))
