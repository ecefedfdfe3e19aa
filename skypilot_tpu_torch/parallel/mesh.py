"""Device mesh and logical sharding rules (port of
skypilot_tpu/parallel/mesh.py) on torch.distributed.

The reference lays a `jax.sharding.Mesh` over the devices of one
controller per host and lets GSPMD insert the collectives. The port runs
one process per card (parallel/distributed.py), so the mesh's cells are
the job's ranks: `make_mesh` returns a `DeviceMesh` with the reference's
six axis names whose rank grid is the reference's device-id grid for the
same config (devices numbered as the gang contract orders processes, a
host's cards in turn), multislice included: with more than one slice the
`data` axis's rows enumerate slices, so only data-parallel collectives
cross the data-center network.

`DEFAULT_RULES` is the reference's table. The sharded trainer
(parallel/train.py, parallel/fsdp.py) reads it where FSDP2 can follow
it: each parameter's `embed` dim goes to `fsdp`, each expert stack's
leading dim to `expert`. `batch_rows` is the port's `batch_sharding`:
the reference shards a batch's rows over `('data', 'fsdp')`, so the
rank at (data=i, fsdp=j) owns block i * fsdp + j of the global batch,
and the rows are the same on every rank of the `tensor`, `expert` and
`seq` axes. The `tensor` axis's process group (`mesh['tensor']`) is
parallel/tensor.py's `RankTensor`: heads, the MLP and the vocab split
over it ('heads' / 'mlp' / 'vocab' -> 'tensor').
`seq_block` is the rule 'seq' -> 'seq': the rank at seq=r holds
positions [r * Sl, (r + 1) * Sl) of each row. `axis_group` gives the
process group of the ranks that differ on a set of axes (the batch's
ranks, for Mixtral's aux fractions: data x fsdp x seq, never tensor or
expert).

The slice count comes from the gang contract: `TPU_NUM_SLICES` when the
launcher set it (backends/task_codegen.py sets it for multislice
tasks), else 1; a rank's slice is its place in that many equal runs of
ranks, as the launcher orders hosts by slice.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUM_SLICES_ENV = 'TPU_NUM_SLICES'

# Logical axis name -> mesh axis (or tuple of mesh axes), the reference's.
DEFAULT_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    ('batch', ('data', 'fsdp')),   # batch sharded over data- and fsdp-axes
    ('seq', 'seq'),                # sequence (context) parallelism axis
    ('act_embed', None),           # activations' embed dim stays unsharded
    ('embed', 'fsdp'),             # FSDP: shard params' embed dim
    # The reference keeps the embedding table's embed dim whole (GSPMD
    # would reshard the lookup's scatter-add gradient); see
    # parallel/fsdp.py for what the port does with such leaves.
    ('table_embed', None),
    ('heads', 'tensor'),           # TP: attention heads
    ('kv', None),
    ('mlp', 'tensor'),             # TP: MLP hidden
    ('vocab', 'tensor'),           # TP: embedding/vocab
    ('expert', 'expert'),          # MoE expert parallelism
    ('norm', None),
)

AXIS_NAMES = ('data', 'stage', 'fsdp', 'tensor', 'expert', 'seq')


def job_world() -> int:
    """Ranks in the job this process joined (1 outside one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def job_slices() -> int:
    return max(1, int(os.environ.get(NUM_SLICES_ENV, '1') or 1))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Named mesh axis sizes (the reference's six; size-1 axes kept)."""
    data: int = 1
    stage: int = 1
    fsdp: int = 1
    tensor: int = 1
    expert: int = 1
    seq: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_NAMES

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.stage, self.fsdp, self.tensor,
                self.expert, self.seq)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def auto(cls, num_devices: Optional[int] = None,
             tensor: int = 1, expert: int = 1, seq: int = 1,
             num_slices: int = 0) -> 'MeshConfig':
        """FSDP-first: every device not on another axis goes to fsdp,
        except on multislice, where `data` takes one row per slice.
        The slice count is the job's (`TPU_NUM_SLICES`) when the whole
        job is used; `num_slices` overrides."""
        world = job_world()
        if num_devices is None:
            num_devices = world
        if not num_slices:
            num_slices = job_slices() if num_devices == world else 1
        inner = tensor * expert * seq * num_slices
        if num_devices % inner != 0:
            raise ValueError(
                f'{num_devices} devices not divisible by '
                f'slices*tensor*expert*seq={inner}')
        return cls(data=num_slices, fsdp=num_devices // inner,
                   tensor=tensor, expert=expert, seq=seq)


def rank_grid(config: MeshConfig,
              slice_ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """The rank at each cell of `config`'s mesh: the reference's
    `make_mesh` grid with rank r standing for device r. `slice_ids[r]`
    is rank r's slice (default: the job's slices, in equal runs)."""
    n = config.num_devices
    ranks = list(range(n))
    if slice_ids is None:
        slices = job_slices() if n == job_world() else 1
        slice_ids = [r * slices // n for r in ranks]
    if len(slice_ids) != n:
        raise ValueError(f'slice_ids ({len(slice_ids)}) must parallel '
                         f'devices ({n}).')
    num_slices = len(set(slice_ids))
    if num_slices <= 1:
        return np.asarray(ranks).reshape(config.shape)
    if config.data % num_slices != 0:
        raise ValueError(
            f'data axis ({config.data}) must be divisible by the '
            f'number of slices ({num_slices}) for multislice meshes.')
    per_slice = n // num_slices
    ici_shape = [config.data // num_slices, *config.shape[1:]]
    groups: Dict[int, List[int]] = {}
    for r, sid in zip(ranks, slice_ids):
        groups.setdefault(sid, []).append(r)
    if any(len(g) != per_slice for g in groups.values()):
        raise ValueError(
            f'uneven slices: {[len(g) for g in groups.values()]} '
            f'devices per slice (need {per_slice} each).')
    return np.concatenate([np.asarray(groups[sid]).reshape(ici_shape)
                           for sid in sorted(groups)], axis=0)


def make_mesh(config: MeshConfig,
              slice_ids: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A `DeviceMesh` over the job's ranks with the reference's axis
    names and `rank_grid(config, slice_ids)`. Every rank calls it (it
    creates each axis's process groups). `device_type` defaults to
    'cuda' under NCCL, else 'cpu'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = job_world()
    if config.num_devices != world:
        raise ValueError(
            f'Mesh needs {config.num_devices} devices, got {world}.')
    if not dist.is_initialized():
        raise ValueError('make_mesh needs a process group: join the job '
                         'first (parallel/distributed.py)')
    if device_type is None:
        device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, rank_grid(config, slice_ids).tolist(),
                      mesh_dim_names=config.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh from `make_mesh` (or a MeshConfig)."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_rows(mesh, batch: int,
               coordinate: Optional[Sequence[int]] = None) -> slice:
    """The global batch rows this rank owns (the reference's
    `batch_sharding`: rows split over `('data', 'fsdp')`, data-major):
    block `data_index * fsdp + fsdp_index` of `data * fsdp` blocks.
    `coordinate` is the rank's mesh coordinate (default: this rank's)."""
    sizes = mesh_shape(mesh)
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    coord = dict(zip(AXIS_NAMES, coordinate))
    blocks = sizes['data'] * sizes['fsdp']
    if batch % blocks:
        raise ValueError(f'global batch {batch} does not split over '
                         f'data x fsdp = {blocks} ranks')
    block = coord['data'] * sizes['fsdp'] + coord['fsdp']
    rows = batch // blocks
    return slice(block * rows, (block + 1) * rows)


def seq_block(mesh, seq: int,
              coordinate: Optional[Sequence[int]] = None) -> slice:
    """The positions of a length-`seq` sequence this rank holds under
    context parallelism (the reference's 'seq' -> 'seq' rule): block
    `seq_index` of `seq_size` equal blocks, `[r * Sl, (r + 1) * Sl)`.
    `coordinate` as `batch_rows`'."""
    sizes = mesh_shape(mesh)
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    index = dict(zip(AXIS_NAMES, coordinate))['seq']
    if seq % sizes['seq']:
        raise ValueError(f'sequence length {seq} does not split over '
                         f'seq = {sizes["seq"]} ranks')
    block = seq // sizes['seq']
    return slice(index * block, (index + 1) * block)


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks whose mesh coordinates differ from
    this rank's on `axes` only (e.g. ('data', 'fsdp', 'seq'): the ranks
    that hold other tokens of the batch), or None when that is this rank
    alone. Every rank calls it at the same point (it creates one group
    for each such set of ranks); the groups are kept on the mesh."""
    import torch.distributed as dist
    key = tuple(a for a in AXIS_NAMES if a in axes)
    cache = mesh.__dict__.setdefault('_axis_groups', {})
    if key not in cache:
        grid = np.asarray(mesh.mesh.tolist())
        inner = [AXIS_NAMES.index(a) for a in key]
        outer = [i for i in range(grid.ndim) if i not in inner]
        rows = grid.transpose(outer + inner).reshape(
            -1, math.prod(grid.shape[i] for i in inner))
        if rows.shape[1] == 1:
            cache[key] = None
        elif rows.shape[0] == 1:
            cache[key] = dist.group.WORLD
        else:
            cache[key], _ = dist.new_subgroups_by_enumeration(rows.tolist())
    return cache[key]


def rules_with_overrides(
        overrides: Optional[Dict[str, Optional[object]]] = None
) -> Tuple[Tuple[str, Optional[object]], ...]:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return tuple(rules.items())


def mesh_summary(mesh) -> str:
    """'Mesh(data=2, fsdp=4)', or 'Mesh(single-device)', as the
    reference prints it; takes a DeviceMesh or a MeshConfig."""
    parts = [f'{name}={size}' for name, size in mesh_shape(mesh).items()
             if size > 1]
    return f'Mesh({", ".join(parts) or "single-device"})'
