"""The port's mesh (skypilot_tpu_torch/parallel/mesh.py) against the
reference's (skypilot_tpu/parallel/mesh.py) on XLA host devices, case by
case: `MeshConfig.auto`'s sizes and errors, the rank grid against the
reference's device-id grid (single slice, and multislice faked through
`slice_ids`), `mesh_summary`'s strings, `batch_rows` against the rows
`batch_sharding` gives each device, and the rules table. Then
`make_mesh` on a 2-rank gloo job (spawned CPU processes): the
DeviceMesh's grid, axis names, coordinates, rows and summary, and
`TPU_NUM_SLICES` putting one `data` row on each slice.
"""
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dist_workers as W  # noqa: E402

from skypilot_tpu.parallel import mesh as ref  # noqa: E402
from skypilot_tpu_torch.parallel import distributed  # noqa: E402
from skypilot_tpu_torch.parallel import mesh as port  # noqa: E402

AUTO_CASES = [
    dict(num_devices=1), dict(num_devices=2), dict(num_devices=8),
    dict(num_devices=8, tensor=2), dict(num_devices=8, tensor=2, seq=2),
    dict(num_devices=8, expert=4), dict(num_devices=8, num_slices=2),
    dict(num_devices=8, num_slices=4, tensor=2),
    dict(num_devices=6, tensor=4), dict(num_devices=8, num_slices=3),
    dict(num_devices=4, seq=3),
]

CONFIGS = [
    dict(fsdp=2), dict(fsdp=8), dict(data=2, fsdp=4),
    dict(data=2, fsdp=2, tensor=2), dict(data=4, fsdp=2),
    dict(data=2, stage=2, fsdp=2), dict(data=8), dict(),
    dict(fsdp=2, expert=2, seq=2),
]

SLICE_CASES = [
    (dict(data=2, fsdp=4), [0, 1, 0, 1, 0, 1, 0, 1]),
    (dict(data=4, fsdp=2), [1, 1, 1, 1, 0, 0, 0, 0]),
    (dict(data=2, fsdp=2, tensor=2), [0, 0, 0, 0, 1, 1, 1, 1]),
    (dict(data=4, fsdp=2), [0, 0, 1, 1, 2, 2, 3, 3]),
    (dict(data=1, fsdp=8), [0, 0, 0, 0, 1, 1, 1, 1]),
    (dict(data=2, fsdp=4), [0, 0, 0, 1, 1, 1, 1, 1]),
    (dict(data=2, fsdp=4), [0, 1, 0, 1]),
]


def outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ('ValueError', str(e))


def ids(grid):
    return np.vectorize(lambda d: d.id)(grid)


@pytest.mark.parametrize('kw', AUTO_CASES, ids=str)
def test_auto_sizes_and_errors_match(kw):
    got = outcome(lambda: port.MeshConfig.auto(**kw))
    want = outcome(lambda: ref.MeshConfig.auto(**kw))
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.shape == want.shape and got.num_devices == \
            want.num_devices


@pytest.mark.parametrize('kw', CONFIGS, ids=str)
def test_rank_grid_is_the_reference_device_grid(kw):
    cfg = ref.MeshConfig(**kw)
    mesh = ref.make_mesh(cfg, devices=jax.devices()[:cfg.num_devices])
    grid = port.rank_grid(port.MeshConfig(**kw),
                          slice_ids=[0] * cfg.num_devices)
    np.testing.assert_array_equal(grid, ids(mesh.devices))
    assert port.MeshConfig(**kw).axis_names == mesh.axis_names


@pytest.mark.parametrize('kw,slices', SLICE_CASES, ids=str)
def test_multislice_rank_grid_is_the_reference_device_grid(kw, slices):
    devices = jax.devices()[:8]
    want = outcome(lambda: ids(ref.make_mesh(ref.MeshConfig(**kw),
                                             devices=devices,
                                             slice_ids=slices).devices))
    got = outcome(lambda: port.rank_grid(port.MeshConfig(**kw),
                                         slice_ids=slices))
    if isinstance(want, tuple):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('kw', CONFIGS, ids=str)
def test_summary_is_the_reference_string(kw):
    cfg = ref.MeshConfig(**kw)
    mesh = ref.make_mesh(cfg, devices=jax.devices()[:cfg.num_devices])
    assert port.mesh_summary(port.MeshConfig(**kw)) == ref.mesh_summary(mesh)


@pytest.mark.parametrize('kw', CONFIGS, ids=str)
def test_batch_rows_are_the_reference_batch_sharding(kw):
    cfg = ref.MeshConfig(**kw)
    mesh = ref.make_mesh(cfg, devices=jax.devices()[:cfg.num_devices])
    batch = 16
    index = ref.batch_sharding(mesh).devices_indices_map((batch, 4))
    grid = ids(mesh.devices)
    for coord in np.ndindex(*cfg.shape):
        rows = index[jax.devices()[grid[coord]]][0]
        got = port.batch_rows(port.MeshConfig(**kw), batch, coord)
        assert (got.start, got.stop) == (rows.start or 0,
                                         batch if rows.stop is None
                                         else rows.stop), coord


def test_batch_rows_refuse_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match='does not split'):
        port.batch_rows(port.MeshConfig(data=2, fsdp=2), 6, (0,) * 6)


def test_rules_are_the_reference_table():
    assert port.DEFAULT_RULES == ref.DEFAULT_RULES
    over = {'embed': None, 'heads': ('tensor', 'fsdp')}
    assert port.rules_with_overrides(over) == ref.rules_with_overrides(over)
    assert port.rules_with_overrides() == ref.rules_with_overrides()


def test_make_mesh_needs_a_job():
    with pytest.raises(ValueError, match='Mesh needs 2 devices, got 1'):
        port.make_mesh(port.MeshConfig(fsdp=2))
    with pytest.raises(ValueError, match='needs a process group'):
        port.make_mesh(port.MeshConfig())


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """make_mesh on a 2-rank gloo job: auto, data=2, and auto under
    TPU_NUM_SLICES=2."""
    out = tmp_path_factory.mktemp('mesh')
    configs = [('auto', None), ('data', port.MeshConfig(data=2))]
    saved = {k: os.environ.get(k) for k in (port.NUM_SLICES_ENV,)}
    results = {}
    try:
        for slices in ('1', '2'):
            os.environ[port.NUM_SLICES_ENV] = slices
            code = distributed.launch(
                W.mesh_job, (str(out), configs),
                distributed.jobs(cpu=True, workers=2, timeout_s=60),
                deadline_s=120)
            assert code == 0
            results[slices] = [
                torch.load(out / f'rank{r}.pt', weights_only=False)
                for r in range(2)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return results


def test_device_mesh_of_a_two_rank_job(two_ranks):
    for rank, got in enumerate(two_ranks['1']):
        auto = got['auto']
        assert auto['config'] == port.MeshConfig(fsdp=2)
        assert auto['names'] == port.AXIS_NAMES
        np.testing.assert_array_equal(
            auto['grid'], np.arange(2).reshape(1, 1, 2, 1, 1, 1))
        assert auto['coordinate'] == [0, 0, rank, 0, 0, 0]
        assert auto['rows'] == (4 * rank, 4 * rank + 4)
        assert auto['summary'] == 'Mesh(fsdp=2)'
        assert auto['fsdp_group'] == [0, 1]
        data = got['data']
        assert data['summary'] == 'Mesh(data=2)'
        assert data['coordinate'] == [rank, 0, 0, 0, 0, 0]
        assert data['rows'] == (4 * rank, 4 * rank + 4)
        assert data['fsdp_group'] == [rank]


def test_num_slices_env_puts_a_data_row_on_each_slice(two_ranks):
    for rank, got in enumerate(two_ranks['2']):
        assert got['auto']['config'] == port.MeshConfig(data=2)
        assert got['auto']['summary'] == 'Mesh(data=2)'
        assert got['auto']['coordinate'] == [rank, 0, 0, 0, 0, 0]
