"""Context-parallel (sequence-sharded) execution context (port of
skypilot_tpu/parallel/context.py).

While a step of the sharded trainer runs under `context_parallel(mesh)`
and the mesh's `seq` axis is larger than 1, `active_seq_group()` is the
rank's ring: the attention dispatch (ops/attention.py) then takes ring
attention (ops/ring_attention.py) over it, so k/v never gather whole,
and the MoE router (models/mixtral.py) counts its expert queues and
capacity over the whole sequence. The reference keeps the mesh itself
in its context variable and lets shard_map find the axis; the port
keeps the process group of the rank's `seq` axis, its place on it and
the global ranks in ring order, which is what the collectives take.

The active ring is a process-wide value, not a ContextVar as the
reference's: on the card, autograd runs the backward (and `--remat`'s
recompute of each block's forward, which must take the ring again) on
its own device threads, which a ContextVar set on the caller's thread
does not reach. One trainer step runs at a time in a rank's process.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """A rank's ring: `group` (the mesh's `seq` axis through this rank),
    this rank's `index` on it, its `size`, and the global `ranks` of
    the ring in axis order (`ranks[index]` is this rank)."""
    group: Any
    index: int
    size: int
    ranks: Tuple[int, ...]

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


_active: Optional[SeqGroup] = None


def seq_group_of(mesh) -> Optional[SeqGroup]:
    """The SeqGroup of this rank on a DeviceMesh from parallel/mesh.py
    `make_mesh`, or None when the mesh has no `seq` axis larger than 1
    (or is None)."""
    if mesh is None or 'seq' not in (mesh.mesh_dim_names or ()):
        return None
    sub = mesh['seq']
    size = sub.size()
    if size <= 1:
        return None
    return SeqGroup(group=sub.get_group(), index=sub.get_local_rank(),
                    size=size, ranks=tuple(sub.mesh.tolist()))


@contextlib.contextmanager
def context_parallel(mesh) -> Iterator[None]:
    """Make `mesh`'s seq ring the active one (none when its seq axis is
    1) for the body; restores the previous one after."""
    global _active
    prev, _active = _active, seq_group_of(mesh)
    try:
        yield
    finally:
        _active = prev


def active_seq_group() -> Optional[SeqGroup]:
    """The ring to attend over, if sequence parallelism is on."""
    return _active
