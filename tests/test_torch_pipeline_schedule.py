"""The port's copy of the pipeline schedules
(skypilot_tpu_torch/parallel/pipeline_schedule.py) against the original
(skypilot_tpu/parallel/pipeline_schedule.py), and serving's prefill
bubble reading it:

  - over S in {2, 3, 4}, M in {1, 2, 4, 8}, the three styles and
    v in {1, 2, 3}: either both raise the same error with the same
    message, or the ops, the tick count, every table (`np.array_equal`,
    dtypes too), the ring and cotangent depths, the live peaks, the
    bubble accounting, `activation_bytes` and `describe()` are equal,
    and the span is the closed form;
  - the forward-only inference schedule (S 1..4, M 1..8) and both
    closed forms are the original's, and so are its refusals;
  - a two-stage serving engine's `prefill_bubble_fraction` is the
    port's `make_inference_schedule(stages, chunks).bubble_fraction`,
    read from that module.
"""
import itertools

import numpy as np
import pytest
import torch

from skypilot_tpu.parallel import pipeline_schedule as ref
from skypilot_tpu_torch.parallel import pipeline_schedule as port
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRID = [(S, M, style, v) for S, M, style, v in itertools.product(
    (2, 3, 4), (1, 2, 4, 8), ref.STYLES, (1, 2, 3))
    if (v > 1) == (style == 'interleaved') or (S, M) == (2, 4)]


def _build(mod, *args):
    try:
        return mod.make_schedule(*args), None
    except (ValueError, AssertionError, RuntimeError) as e:
        return None, (type(e), str(e))


@pytest.mark.parametrize('S,M,style,v', GRID)
def test_schedule_is_the_originals(S, M, style, v):
    got, got_err = _build(port, S, M, style, v)
    want, want_err = _build(ref, S, M, style, v)
    assert got_err == want_err
    if want is None:
        return
    for field in ('stages', 'microbatches', 'style', 'virtual_stages',
                  'num_ticks', 'live_peak_per_stage', 'rx_fwd_depth',
                  'rx_bwd_depth', 'gy_depth', 'total_slots', 'busy_slots',
                  'bubble_slots', 'bubble_fraction',
                  'peak_live_activations'):
        assert getattr(got, field) == getattr(want, field), field
    assert [tuple(vars(op).values()) for op in got.ops] == \
        [tuple(vars(op).values()) for op in want.ops]
    assert [op.direction for op in got.ops] == \
        [op.direction for op in want.ops]
    assert set(got.tables) == set(want.tables)
    for name, table in want.tables.items():
        assert got.tables[name].dtype == table.dtype, name
        assert np.array_equal(got.tables[name], table), name
    assert got.describe() == want.describe()
    assert got.activation_bytes(2048, 4096) == want.activation_bytes(
        2048, 4096)
    assert got.num_ticks == port.closed_form_span(S, M, style, v) == \
        ref.closed_form_span(S, M, style, v)


@pytest.mark.parametrize('S,M', itertools.product((1, 2, 3, 4),
                                                  range(1, 9)))
def test_inference_schedule_is_the_originals(S, M):
    got, want = port.make_inference_schedule(S, M), \
        ref.make_inference_schedule(S, M)
    assert got.num_ticks == want.num_ticks == \
        port.closed_form_inference_span(S, M)
    assert got.bubble_fraction == want.bubble_fraction
    assert got.describe() == want.describe()
    assert [tuple(vars(op).values()) for op in got.ops] == \
        [tuple(vars(op).values()) for op in want.ops]


@pytest.mark.parametrize('S,M', [(0, 1), (2, 0)])
def test_inference_refusals_are_the_originals(S, M):
    with pytest.raises(ValueError) as got:
        port.make_inference_schedule(S, M)
    with pytest.raises(ValueError) as want:
        ref.make_inference_schedule(S, M)
    assert str(got.value) == str(want.value)


def test_serving_prefill_bubble_reads_the_schedule(monkeypatch):
    """A staged engine's prefill pass of 3 chunks: the bubble is the
    port's inference schedule's, taken through that module."""
    from skypilot_tpu_torch.models import batching, convert
    from skypilot_tpu_torch.models.llama import LlamaConfig
    from skypilot_tpu_torch.parallel import serving
    from skypilot_tpu_torch.parallel.mesh import MeshConfig
    calls = []
    make = port.make_inference_schedule

    def watched(stages, microbatches):
        calls.append((stages, microbatches))
        return make(stages, microbatches)

    monkeypatch.setattr(batching.pipeline_schedule,
                        'make_inference_schedule', watched)
    cfg = LlamaConfig.tiny(dtype=torch.float32, kv_page_size=8,
                           kv_total_pages=40)
    model = serving.build(convert.init_params(cfg, seed=0),
                          MeshConfig(stage=2), devices=['cpu'] * 2)
    eng = batching.ContinuousBatchingEngine(
        model, num_slots=4, max_total_len=48, prefill_chunk=4,
        prefill_budget=12)
    try:
        eng.submit(list(range(2, 14)), max_new_tokens=2).result(timeout=180)
    finally:
        eng.stop()
    assert (2, 3) in calls
    assert eng.prefill_bubble_fraction == make(2, 3).bubble_fraction
