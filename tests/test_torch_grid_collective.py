"""The serving grid's collective (ops/grid_collective.py) and the decode
round over a grid (models/decode_graph.py, parallel/serving.py), on the
CPU:

  - the plain sum / max / gather / broadcast, which the card's kernel is
    held to, are the grid's helpers as they were (copies to the first
    device, an f32 sum in shard order cast back, `torch.maximum`,
    `torch.cat`), pinned bit for bit for bf16 and f32 at T = 2, 3, 4 on
    parts whose sums depend on the order; a perturbed plain version (one
    shard one ulp up) fails the pin;
  - `Grid` routes its collectives through the wrapper and still refuses a
    pool shard;
  - the decode round over a grid of CPU devices named N times keeps its
    static buffers once a place, makes no `Tensor.to` to a device inside
    a round, and its engine gives the reference's tensor-parallel
    engine's greedy tokens (on XLA host devices) exactly in f32, for
    --tensor 2, --tensor 4 (the GQA remainder rule) and --stages 2
    --tensor 2;
  - the collective's launch counters are part of what a graph replay adds
    back, card by card.
"""
import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from skypilot_tpu.models import batching as jax_batching
from skypilot_tpu.ops import pallas_paged as pp
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import serving as jax_serving
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import decode_graph
from skypilot_tpu_torch.ops import grid_collective as gc
from skypilot_tpu_torch.parallel import serving

from test_torch_tp_serving import (ENGINE_KW, PROMPTS, grid_model,  # noqa
                                   llama, run)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def parent_all_reduce(parts, op='sum'):
    """The grid's helper as it was, written out: every part to the first
    part's device; an f32 sum in shard order cast back, or a running
    `torch.maximum`; the result on every part's device."""
    home = parts[0].device
    if op == 'sum':
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(home).float()
        acc = acc.to(parts[0].dtype)
    else:
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(home))
    return [acc if p.device == home else acc.to(p.device) for p in parts]


def order_sensitive_parts(ways, dtype, seed=0):
    """Parts whose f32 sum changes with the order: magnitudes spread over
    eight decades, so partial sums round apart; NaN-free."""
    rng = np.random.default_rng(seed)
    shape = (5, 7, 48)
    return [torch.from_numpy(
        (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 5, shape))
        .astype(np.float32)).to(dtype) for _ in range(ways)]


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize('ways', [2, 3, 4])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('op', ['sum', 'max'])
def test_plain_reductions_pinned_to_the_helper(ways, dtype, op):
    parts = order_sensitive_parts(ways, dtype)
    want = parent_all_reduce(parts, op)
    got = gc.all_reduce(parts, None, op)
    assert len(got) == ways
    for g in got:
        assert g.dtype == dtype and g.shape == parts[0].shape
        np.testing.assert_array_equal(bits(g), bits(want[0]))
    # On one device every rank shares the one result, as the helper's do.
    assert all(g is got[0] for g in got)
    if op == 'sum' and ways > 2 and dtype == torch.float32:
        # The pin sees the order (two terms commute; three do not
        # associate, and in f32 no cast back hides it): the reversed sum
        # differs somewhere.
        rev = parent_all_reduce(parts[::-1], op)[0]
        assert not np.array_equal(bits(rev), bits(want[0]))


@pytest.mark.parametrize('ways', [2, 3, 4])
@pytest.mark.parametrize('dtype', DTYPES)
def test_perturbed_plain_sum_fails_the_pin(ways, dtype):
    parts = order_sensitive_parts(ways, dtype, seed=1)
    want = parent_all_reduce(parts)[0]
    # The last shard one ulp up: the plain sum moves off the pin.
    moved = parts[:-1] + [gc.next_up(parts[-1])]
    bad = gc.all_reduce(moved, None, 'sum')[0]
    assert not np.array_equal(bits(bad), bits(want))
    np.testing.assert_array_equal(bits(bad),
                                  bits(parent_all_reduce(moved)[0]))


def test_next_up_is_one_ulp():
    for dtype, ints in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        x = torch.tensor([1.0, -1.0, 0.0, -0.0, 3e-3, -250.0]).to(dtype)
        up = gc.next_up(x)
        assert (up.float() > x.float()).all()
        b = x.view(ints)
        want = torch.where(b >= 0, b + 1, b - 1)
        want[2] = want[3] = 1
        assert torch.equal(up.view(ints), want)


@pytest.mark.parametrize('ways', [2, 3, 4])
@pytest.mark.parametrize('dtype', DTYPES + [torch.int32])
def test_plain_gather_and_broadcast_pinned(ways, dtype):
    rng = np.random.default_rng(ways)
    parts = [torch.from_numpy(rng.integers(-1000, 1000, (3, 2, 11))
                              .astype(np.float32)).to(dtype)
             for _ in range(ways)]
    got = gc.gather(parts, None, torch.device('cpu'))
    want = torch.cat([p.to('cpu') for p in parts], dim=-1)
    assert got.dtype == dtype and got.shape == (3, 2, 11 * ways)
    assert torch.equal(got, want)
    for t in range(ways):
        assert torch.equal(got[..., 11 * t:11 * (t + 1)], parts[t])
    sent = gc.broadcast(parts[0], None, [torch.device('cpu')] * ways)
    assert len(sent) == ways and all(torch.equal(s, parts[0]) for s in sent)


def test_plain_calls_are_counted_and_the_kernel_needs_its_team():
    before = gc.plain_calls
    parts = order_sensitive_parts(2, torch.float32)
    gc.all_reduce(parts, None)
    gc.gather(parts, None, torch.device('cpu'))
    assert gc.plain_calls == before + 2
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        gc.all_reduce(parts, None, impl='cuda')
    with pytest.raises(ValueError, match='unknown reduction'):
        gc.all_reduce(parts, None, 'mean')
    assert gc.blocks_for(64 << 10) == 4
    assert gc.blocks_for(1) == 1 and gc.blocks_for(1 << 30) == gc.MAX_BLOCKS
    # A launch is at most one slot of fixed block runs: a prefill chunk's
    # bf16 partial and 8 rows of Llama-3-8B's f32 vocab slice at --tensor 2
    # each fit one.
    assert gc.SLOT_BYTES == gc.MAX_BLOCKS * gc.BLOCK_BYTES
    assert 256 * 4096 * 2 <= gc.SLOT_BYTES and 8 * 64128 * 4 <= gc.SLOT_BYTES
    assert gc.bound_bytes('sum', 4, 100) == 300
    assert gc.bound_bytes('broadcast', 4, 100) == 100


def test_cpu_team_is_plain_and_kernel_shapes_are_checked():
    team = gc.Team(['cpu', 'cpu'])
    assert not team.distinct and team.size == 2
    assert team.card_of == [0, 0]
    with pytest.raises(ValueError, match='1..8 ranks'):
        gc.Team(['cpu'] * 9)


def test_grid_routes_through_the_wrapper_and_refuses_a_pool_shard(llama):
    _, _, port = llama
    gm = grid_model(port)
    eng = pt_batching.ContinuousBatchingEngine(gm, **ENGINE_KW)
    try:
        grid = gm.grid
        assert grid.collective_route() == 'plain helpers on the CPU'
        before = gc.plain_calls
        parts = order_sensitive_parts(2, torch.bfloat16)
        got = grid.all_reduce(parts)
        assert gc.plain_calls == before + 1
        np.testing.assert_array_equal(bits(got[1]),
                                      bits(parent_all_reduce(parts)[0]))
        k = eng.cache.shards[0][1].layers[0]['k_pages']
        reductions = grid.reductions
        for op in ('sum', 'max'):
            with pytest.raises(ValueError, match='pool shard'):
                grid.all_reduce([eng.cache.shards[0][0].layers[0]['k_pages'],
                                 k], op)
        assert grid.reductions == reductions
        # One shard: nothing to combine, nothing counted.
        assert grid.all_reduce(parts[:1])[0] is parts[0]
        assert grid.reductions == reductions
    finally:
        eng.stop()


# -- the round over a grid ------------------------------------------------------
class DeviceCopies(TorchFunctionMode):
    """Records `Tensor.to` calls that name a device (or a tensor on another
    device), and `Tensor.cuda` / `cpu` calls, made while active outside
    the collective's own plain helpers (the CPU's route of the
    collective, which the card's kernel replaces)."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.calls = []
        self.inside = 0
        for name in ('all_reduce_reference', 'gather_reference',
                     'broadcast_reference'):
            monkeypatch.setattr(gc, name, self._quiet(getattr(gc, name)))

    def _quiet(self, fn):
        def wrapped(*args, **kwargs):
            self.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.inside -= 1
        return wrapped

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.inside and func in (torch.Tensor.to, torch.Tensor.cuda,
                                        torch.Tensor.cpu):
            named = [a for a in list(args[1:]) + list(kwargs.values())
                     if isinstance(a, (torch.device, str))
                     or (isinstance(a, torch.Tensor)
                         and a.device != args[0].device)]
            if named or func is not torch.Tensor.to:
                self.calls.append((func.__name__, named))
        return func(*args, **kwargs)


def test_round_keeps_buffers_a_place_and_copies_nothing_across(
        llama, monkeypatch):
    _, _, port = llama
    gm = grid_model(port, stages=2, tensor=2)
    eng = pt_batching.ContinuousBatchingEngine(gm, **ENGINE_KW)
    try:
        rnd = eng._rounds[0]  # pylint: disable=protected-access
        assert rnd.places == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert rnd.cards == [torch.device('cpu')]
        assert len({id(b['packed']) for b in rnd._bufs.values()}) == 4  # pylint: disable=protected-access
        assert rnd.packed is rnd._bufs[(0, 0)]['packed']  # pylint: disable=protected-access
        b = rnd.num_slots
        table = np.zeros((b, eng.pages_per_seq), np.int32)
        kw = dict(tok=np.full(b, 5, np.int32), pos=np.arange(b, dtype=np.int32),
                  cont=np.zeros(b, np.int32), ids=np.zeros(b, np.int32),
                  top_k=np.zeros(b, np.int32), temp=np.zeros(b, np.float32),
                  top_p=np.ones(b, np.float32), table=table,
                  selection='greedy', lora=None)
        with torch.no_grad():
            first = rnd.dispatch(**kw).wait()
            mode = DeviceCopies(monkeypatch)
            with mode:
                second = rnd.dispatch(**dict(kw, cont=np.ones(b, np.int32))
                                      ).wait()
            assert mode.calls == []
            # The eager path (prefill, verify chunks) copies its inputs
            # to each device, and the mode sees it.
            with mode:
                eng.model.hidden(torch.zeros((1, 3), dtype=torch.long))
            assert mode.calls
            # Every place fed back alike: the sampled tokens on the stage-0
            # places, the positions everywhere.
            for place, buf in rnd._bufs.items():  # pylint: disable=protected-access
                assert torch.equal(buf['last_pos'],
                                   torch.arange(b, dtype=torch.int32) + 1)
                assert (buf['view']['cont'] == 1).all()
                if place[0] == 0:
                    assert torch.equal(buf['last_tok'],
                                       torch.from_numpy(second[0]))
            assert first.shape == second.shape == (1, b)
    finally:
        eng.stop()


def reference_grid_tokens(jax_model, params, stages, tensor):
    """Greedy tokens of the reference engine on a (stage, tensor) mesh of
    XLA host devices: tensor-sharded params on a tensor mesh, the staged
    engine splitting them itself on a staged one."""
    devices = jax.devices()[:stages * tensor]
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(stage=stages,
                                                  tensor=tensor),
                              devices=devices)
    if stages == 1:
        params = jax_serving.shard_params_for_serving(jax_model, params,
                                                      mesh)
    with pp.impl_scope('xla'):
        return run(jax_batching.ContinuousBatchingEngine(
            jax_model, params, mesh=mesh, **ENGINE_KW))


@pytest.mark.parametrize('stages,tensor', [(1, 2), (1, 4), (2, 2)])
def test_grid_round_tokens_equal_the_reference_grid(llama, stages, tensor):
    jax_model, params, port = llama
    ref = reference_grid_tokens(jax_model, params, stages, tensor)
    eng = pt_batching.ContinuousBatchingEngine(
        grid_model(port, stages=stages, tensor=tensor), **ENGINE_KW)
    assert eng.pipeline_decode
    rounds = eng._rounds  # pylint: disable=protected-access
    assert len(rounds) == stages
    assert all(len(r.places) == stages * tensor for r in rounds)
    got = run(eng, PROMPTS)
    assert got == ref
    assert eng.decode_calls > 0


def test_collective_counts_are_replayed_card_by_card(llama):
    """A capture's count delta holds the collective's counters, by op and
    by card, and adding it back (what every replay does) moves each."""
    _, _, port = llama
    gm = grid_model(port, tensor=2)
    eng = pt_batching.ContinuousBatchingEngine(gm, **ENGINE_KW)
    try:
        rnd = eng._rounds[0]  # pylint: disable=protected-access
        before = rnd._counts()  # pylint: disable=protected-access
        with torch.no_grad():
            rnd.step('greedy', None)
        delta = decode_graph._count_delta(  # pylint: disable=protected-access
            rnd._counts(), before)  # pylint: disable=protected-access
        # 2 layers x 2 sums + the embedding's, and the head's gather and
        # the tokens' broadcast on the CPU's plain route.
        assert delta[('grid', 'reductions')] == 5
        assert delta[('grid', 'plain_calls')] == 5 + 2
        snap = (gc.plain_calls, gm.grid.reductions)
        gc.launches_by_device['cuda:1'] += 0
        fake = {('grid', 'launches'): 3, ('grid_op', 'sum'): 2,
                ('grid_op', 'gather'): 1, ('grid_device', 'cuda:1'): 3,
                ('grid', 'reductions'): 2}
        launches = gc.launches
        rnd._add_counts(fake)  # pylint: disable=protected-access
        assert gc.launches == launches + 3
        assert gc.launches_by_device['cuda:1'] >= 3
        assert gm.grid.reductions == snap[1] + 2
        rnd._add_counts(fake, sign=-1)  # pylint: disable=protected-access
        assert gc.launches == launches
        assert (gc.plain_calls, gm.grid.reductions) == snap
    finally:
        eng.stop()
