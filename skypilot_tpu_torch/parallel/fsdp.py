"""The sharded trainer's layout over a mesh (parallel/train.py
`ShardedTrainer(mesh=...)`): what the reference's GSPMD shardings do
for training (skypilot_tpu/parallel/train.py), with FSDP2 and explicit
collectives.

Parameters: FSDP2 (`fully_shard`) over the mesh's `fsdp` axis, one unit
per block and one root unit that holds the rest (token embedding, final
norm, LM head) and computes the loss, so the fused loss sees the whole
head (and GPT-2 its tied table) inside the unit's forward. Each leaf
shards on the dim the reference's logical axes call `embed`, as
`DEFAULT_RULES` map it to `fsdp` (`_EMBED_DIM`, in the port's layout:
Dense weights are nn.Linear's [out, in], the reference's [in, out]).
The reference keeps some leaves whole: the embedding tables
(`table_embed` -> None, parallel/mesh.py), the norms, the biases and
DeepSeek's `wkv_b` (('kv', 'heads', None)). FSDP2 has no replicated
placement, and the reason the reference keeps tables whole (GSPMD
would reshard the lookup's scatter-add gradient) does not arise when
the table is gathered before the lookup, so the port shards those on
dim 0 (FSDP2's default, uneven sizes padded); so too an embed dim the
fsdp size does not divide. LoRA factors are not module parameters:
every rank holds them whole. Over `data` the parameters are
replicated, as HSDP does. Over `expert` Mixtral's expert stacks
(`w_gate`, `w_up`, `w_down`) are sliced on dim 0 before FSDP2 shards
them (`MoEFeedForward.shard_experts`: rank e keeps experts
[e*E/X, (e+1)*E/X), and names the leaves it sliced); every other leaf
is whole on each expert rank. Over `tensor` each block's heads, MLP
hidden axis (Mixtral's expert stacks' too) and the token table and head
(by vocab rows, padded to a multiple of the size) are sliced before
FSDP2 shards them (parallel/tensor.py `shard_model`: rank t keeps its
slice, and names the leaves it sliced and how); every other leaf is
whole on each tensor rank, and the loss runs the rank's shard through
parallel/tensor.py's collectives.
Over `seq` every leaf is replicated.

Gradients: FSDP2 reduce-scatters (and averages) each unit's gradients
over `fsdp` as backward leaves the unit; frozen LoRA bases take none.
The data axis is reduced here, leaf by leaf: summed over `data` and
divided (replicated moments), or with `zero1` reduce-scattered onto the
leaf's moment shard (the reference's `_zero1_opt_sharding` rule: the
first dim the combined fsdp x data factor divides; scalars and odd
vectors stay whole). Before that, each seq rank's gradient (its block
of the sequence's part) is summed over `seq`. Over `expert`: the batch
is the same on every expert rank, an expert slice's gradient is its
rank's alone, and a replicated leaf's comes out whole on each (the
MoE's copy_to_experts), equal up to the rounding of a backward that is
not deterministic (the card's flash dQ); so the replicated leaves'
gradients are averaged over `expert`, which keeps the copies
bit-identical. Over `tensor` the batch is the same on every rank and a
tensor slice's gradient is its rank's alone; a whole leaf's comes out
whole on each rank (the norms, the router, MLA's latent projections and
a row-parallel bias run outside the sharded regions) and is averaged
over `tensor`, as over `expert`, while a whole leaf read inside a region
(wk / wv under the GQA remainder rule) carries its rank's part and is
summed. LoRA factors are summed over every rank (the expert copies
counted once); a factor sliced over `tensor` over every rank of its
slice. With `overlap` the data-axis collective of each
leaf is issued, async, from its post-accumulate-grad hook (FSDP2 runs
those after the leaf's reduce-scatter), while backward goes on; the
collectives and their inputs are the same, so no number changes.

The optimizer (`ClippedAdamW`, optax's semantics) updates each rank's
piece: the fsdp shard, cut to the moment shard under zero1, after which
the updated pieces are all-gathered over `data`. The clip's global norm
is the sum of squares of every piece, each counted on one rank only
(expert slices on their expert rank, replicated leaves on expert and
seq rank 0, whole leaves on tensor rank 0, tensor slices on every tensor
rank), all-reduced over the job (`global_sq`): optax.global_norm's
value. A checkpoint gathers a leaf over `fsdp`, then over `expert`, then
over `tensor` (a vocab table unpadded), one leaf at a time, and a
restore cuts each rank's slice from the whole leaf, so a file moves
between any two meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from skypilot_tpu_torch.parallel import mesh as mesh_lib

# The single-tensor collectives under their newer names where torch has
# them (the older ones warn there).
_all_gather = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, 'reduce_scatter_single', None) \
    or dist.reduce_scatter_tensor

# The dim of a port leaf the reference's logical axes call 'embed', by
# the end of its name.
_EMBED_DIM = (
    # [out, in] projections reading the residual stream, the head [V, D]
    # and Mixtral's router [E, D] and input experts [E, D, F].
    (('wq.weight', 'wk.weight', 'wv.weight', 'w_gate.weight',
      'w_up.weight', 'c_attn.weight', 'c_fc.weight', 'wq_a.weight',
      'wkv_a.weight', 'lm_head', 'moe.router', 'moe.w_gate', 'moe.w_up'),
     1),
    # [out, in] projections writing it.
    (('wo.weight', 'w_down.weight', 'c_proj.weight'), 0),
    # Mixtral's output experts [E, F, D].
    (('moe.w_down',), 2),
)


def _gather_dim(x: torch.Tensor, dim: int, parts: int, group
                ) -> torch.Tensor:
    """x's equal pieces along `dim`, one on each of `parts` ranks of
    `group` in rank order, whole."""
    part = x.movedim(dim, 0).contiguous()
    buf = torch.empty((parts * part.shape[0], *part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    _all_gather(buf, part, group=group)
    return buf.movedim(0, dim)


def embed_dim_of(name: str) -> Optional[int]:
    for suffixes, dim in _EMBED_DIM:
        if name.endswith(suffixes):
            return dim
    return None


def blocks_of(model) -> nn.ModuleList:
    """The model's stack of decoder blocks (GPT-2's `h`, else
    `layers`)."""
    return model.h if hasattr(model, 'h') else model.layers


def chunk_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(start, size) of part `index` of `n` rows cut as torch.chunk cuts
    them (FSDP2's uneven dim-0 shards: ceil(n / parts) a part, the last
    ones short or empty)."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, max(0, min(size, n - start))


@dataclasses.dataclass
class Leaf:
    """One trainable leaf: its whole shape, the dim FSDP2 shards (None:
    every rank holds it whole), the dim its moments shard over `data`
    under zero1 (None: whole over data), the number of expert ranks its
    dim 0 is sliced over (1: every expert rank holds all of it), its
    split over `tensor` (parallel/tensor.py: a dim, 'qkv' or 'vocab';
    None: whole) and, for a whole leaf, whether each tensor rank's
    gradient is a part to sum ('sum') rather than a copy to average."""
    name: str
    shape: Tuple[int, ...]
    fsdp_dim: Optional[int]
    zero1_dim: Optional[int]
    experts: int = 1
    tensor_axis: Any = None
    tensor_sum: bool = False
    #: This rank's slice's shape (FSDP2's whole).
    part_shape: Tuple[int, ...] = ()


class _LossUnit(nn.Module):
    """The root FSDP unit: the model and the trainer's loss, so that the
    root's parameters (the head among them) are whole while the loss
    reads them."""

    def __init__(self, model: nn.Module, compute: Callable) -> None:
        super().__init__()
        self.model = model
        self._compute = compute

    def forward(self, params: Dict[str, Any], tokens: torch.Tensor):
        return self._compute(params, tokens)


class FSDPLayout:

    def __init__(self, model: nn.Module, mesh, compute_loss: Callable,
                 zero1: bool = False, overlap: bool = False) -> None:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        sizes = mesh_lib.mesh_shape(mesh)
        if sizes['stage'] > 1:
            raise ValueError(f'the sharded trainer shards over data, fsdp, '
                             f'tensor, expert and seq, not '
                             f'{mesh_lib.mesh_summary(mesh)}')
        self.data, self.fsdp = sizes['data'], sizes['fsdp']
        self.expert, self.seq = sizes['expert'], sizes['seq']
        self.tensor = sizes['tensor']
        coord = dict(zip(mesh_lib.AXIS_NAMES, mesh.get_coordinate()))
        self.data_index, self.fsdp_index = coord['data'], coord['fsdp']
        self.expert_index, self.seq_index = coord['expert'], coord['seq']
        self.tensor_index = coord['tensor']
        self.fsdp_mesh = mesh['fsdp']
        self.data_group = mesh['data'].get_group()
        self.fsdp_group = self.fsdp_mesh.get_group()
        self.expert_group = mesh['expert'].get_group()
        self.seq_group = mesh['seq'].get_group()
        self.tensor_group = mesh['tensor'].get_group()
        #: The tensor group seam (parallel/tensor.py) the loss runs the
        #: model's shard through; None without a `tensor` axis.
        self.tensor_seam = None
        #: {leaf name: its split over `tensor`} (parallel/tensor.py).
        self.tensor_axes: Dict[str, Any] = {}
        self.vocab = model.config.vocab_size
        if self.tensor > 1:
            self.tensor_seam = tensor_lib.RankTensor(
                self.tensor_group, self.tensor_index, self.tensor)
            self.tensor_axes = tensor_lib.shard_model(
                model, self.tensor_index, self.tensor)
        self.kv_split = tensor_lib.kv_shard_ways(
            int(getattr(model.config, 'num_kv_heads', 0) or 0),
            self.tensor) > 1
        # A LoRA factor sliced over `tensor` is reduced over the other
        # axes alone.
        self.untensor_group = (mesh_lib.axis_group(
            mesh, ('data', 'fsdp', 'expert', 'seq')) if self.tensor > 1
            else None)
        self.zero1 = zero1 and self.data > 1
        self.overlap = overlap and self.zero1
        #: The collectives `reduce_grads` issued in this layout's life,
        #: by kind ('seq', 'expert', 'data', 'all', 'scatter').
        self.reductions: Dict[str, int] = {}
        # Batch statistics a model takes over the whole batch (Mixtral's
        # router aux loss) are taken over the ranks that hold other
        # tokens of it: data, fsdp and seq, never expert.
        batch_group = mesh_lib.axis_group(mesh, ('data', 'fsdp', 'seq'))
        #: The names of the leaves sliced over `expert` (by the modules
        #: that slice them).
        self.expert_leaves = set()
        for prefix, module in model.named_modules():
            if hasattr(module, 'batch_group'):
                module.batch_group = batch_group
            if self.expert > 1 and hasattr(module, 'shard_experts'):
                self.expert_leaves.update(
                    f'{prefix}.{name}' for name in module.shard_experts(
                        self.expert_group, self.expert_index, self.expert))
        embed = model.config.embed_dim
        names = {id(p): n for n, p in model.named_parameters()}

        def placement(param: nn.Parameter):
            dim = embed_dim_of(names[id(param)])
            if dim is None or param.shape[dim] != embed or (
                    dim and param.shape[dim] % self.fsdp):
                return None                    # Shard(0)
            return Shard(dim)

        for block in blocks_of(model):
            fully_shard(block, mesh=self.fsdp_mesh,
                        shard_placement_fn=placement)
        self.unit = _LossUnit(model, compute_loss)
        fully_shard(self.unit, mesh=self.fsdp_mesh,
                    shard_placement_fn=placement)
        self.leaves: List[Leaf] = []
        self._pending: Dict[int, Tuple[Any, torch.Tensor, Any]] = {}
        self._hooks: List[Any] = []

    # -- leaves ---------------------------------------------------------------
    def shard_lora(self, lora_params) -> None:
        """Slice fresh LoRA factors (whole) to this rank's tensor shard
        in place (models/lora.py `shard_lora_params`)."""
        if self.tensor > 1:
            from skypilot_tpu_torch.models import lora as lora_lib
            self.tensor_axes.update(lora_lib.shard_lora_params(
                lora_params, self.tensor_index, self.tensor, self.kv_split))

    def _whole_shape(self, name: str, shape, experts: int):
        shape = list(shape)
        shape[0] *= experts
        axis = self.tensor_axes.get(name)
        if axis == 'vocab':
            shape[0] = self.vocab
        elif axis == 'qkv':
            shape[0] *= self.tensor
        elif axis not in (None, 'sum'):
            shape[axis] *= self.tensor
        return tuple(shape)

    def bind(self, leaves: List[torch.Tensor], names: List[str]) -> None:
        """Record the trainable leaves (in the optimizer's order) and,
        with overlap, hook each one's data-axis collective."""
        self.leaves = []
        for name, t in zip(names, leaves):
            fsdp_dim = (t.placements[0].dim if hasattr(t, 'placements')
                        else None)
            experts = self.expert if name in self.expert_leaves else 1
            axis = self.tensor_axes.get(name)
            self.leaves.append(Leaf(
                name, self._whole_shape(name, t.shape, experts), fsdp_dim,
                self._zero1_dim(t.shape, fsdp_dim), experts,
                None if axis == 'sum' else axis, axis == 'sum',
                tuple(t.shape)))
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self.overlap:
            for i, t in enumerate(leaves):
                self._hooks.append(t.register_post_accumulate_grad_hook(
                    lambda p, i=i: self._issue(i, p)))

    def _zero1_dim(self, shape, fsdp_dim) -> Optional[int]:
        """The reference's `_zero1_opt_sharding` rule on one leaf."""
        if not self.zero1 or len(shape) == 0:
            return None
        for dim, size in enumerate(shape):
            cur = self.fsdp if dim == fsdp_dim else 1
            if size % (cur * self.data) == 0:
                return dim
        return None

    @staticmethod
    def local(t: torch.Tensor) -> torch.Tensor:
        """This rank's tensor of a leaf (FSDP2's shard, or the whole
        replicated tensor); in-place updates reach the leaf."""
        if not hasattr(t, 'to_local'):
            return t
        with torch.no_grad():       # the local tensor itself, not a view
            return t.to_local()

    def piece(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """The part of leaf i's local tensor this rank's moments cover."""
        dim = self.leaves[i].zero1_dim
        if dim is None:
            return local
        return local.chunk(self.data, dim=dim)[self.data_index]

    def pieces(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        with torch.no_grad():
            return [self.piece(i, self.local(t)) for i, t in
                    enumerate(leaves)]

    # -- gradients ------------------------------------------------------------
    def _count(self, kind: str) -> None:
        self.reductions[kind] = self.reductions.get(kind, 0) + 1

    def _issue(self, i: int, t: torch.Tensor) -> None:
        """Start leaf i's data-axis (or, replicated, job-wide) reduction
        of its gradient; `reduce_grads` waits for it. Before it, the
        seq ranks' partial gradients are summed and a leaf every expert
        rank holds is averaged over them (both synchronous: they
        precede the data-axis op)."""
        grad = t.grad
        t.grad = None
        leaf = self.leaves[i]
        local = (self.local(grad) if grad is not None
                 else torch.zeros_like(self.local(t)))
        if leaf.fsdp_dim is None:
            # Replicated (LoRA factors): every rank's gradient is partial
            # (or, over expert, a copy: the divisor counts them); a
            # factor sliced over tensor is its tensor rank's alone.
            group = (dist.group.WORLD if leaf.tensor_axis is None
                     else self.untensor_group)
            work = (None if group is None else
                    dist.all_reduce(local, group=group, async_op=True))
            self._count('all')
            self._pending[i] = (work, local, 'all')
            return
        if self.seq > 1:
            # Each seq rank's gradient covers its block of the sequence.
            dist.all_reduce(local, group=self.seq_group)
            self._count('seq')
        if self.expert > 1 and leaf.experts == 1:
            dist.all_reduce(local, group=self.expert_group)
            local.div_(self.expert)
            self._count('expert')
        if self.tensor > 1 and leaf.tensor_axis is None:
            # A whole leaf: each tensor rank's gradient is a copy of the
            # whole one (averaged, so the copies stay bit-identical) or,
            # read inside a sharded region, its rank's part (summed).
            dist.all_reduce(local, group=self.tensor_group)
            if not leaf.tensor_sum:
                local.div_(self.tensor)
            self._count('tensor')
        if leaf.zero1_dim is None:
            work = None
            if self.data > 1:
                work = dist.all_reduce(local, group=self.data_group,
                                       async_op=True)
                self._count('data')
            self._pending[i] = (work, local, 'data')
            return
        src = local.movedim(leaf.zero1_dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.data, *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        work = _reduce_scatter(out, src, group=self.data_group,
                               async_op=True)
        self._count('scatter')
        self._pending[i] = (work, (out, src), 'scatter')

    def reduce_grads(self, leaves: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Each leaf's gradient piece, averaged over the job (call after
        backward; clears the leaves' .grad)."""
        if not self.overlap:
            for i, t in enumerate(leaves):
                self._issue(i, t)
        out = []
        # The seq ranks' parts are summed, the expert ranks' copies
        # counted once.
        world = self.data * self.fsdp * self.expert
        for i, leaf in enumerate(self.leaves):
            work, value, kind = self._pending.pop(i)
            if work is not None:
                work.wait()
            if kind == 'all':
                g = self.piece(i, value.div_(world))
            elif kind == 'data':
                g = value.div_(self.data) if self.data > 1 else value
            else:
                g = value[0].div_(self.data).movedim(0, leaf.zero1_dim)
            out.append(g)
        return out

    def global_sq(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The sum of squares of the whole gradient: each piece counted
        on the one rank that owns it, all-reduced over the job."""
        total = 0
        for leaf, g in zip(self.leaves, grads):
            if self.seq_index:
                break               # every leaf a copy of seq rank 0's
            if leaf.fsdp_dim is None and self.fsdp_index:
                continue            # a copy of fsdp rank 0's
            if leaf.zero1_dim is None and self.data_index:
                continue            # a copy of data rank 0's
            if leaf.experts == 1 and self.expert_index:
                continue            # a copy of expert rank 0's
            if leaf.tensor_axis is None and self.tensor_index:
                continue            # a copy of tensor rank 0's
            total = total + g.float().square().sum()
        if not torch.is_tensor(total):
            total = torch.zeros((), dtype=torch.float32,
                                device=grads[0].device)
        dist.all_reduce(total)
        return total

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The job-wide mean of a per-rank scalar (the local loss): the
        mean over the batch's ranks of the sum over the seq ranks' parts
        (the expert and tensor ranks' copies counted once)."""
        x = x.detach().clone()
        dist.all_reduce(x)
        return x.div_(self.data * self.fsdp * self.expert * self.tensor)

    @torch.no_grad()
    def gather_updates(self, leaves: List[torch.Tensor]) -> None:
        """zero1: all-gather each updated moment-shard piece over `data`
        back into the rank's local tensor."""
        for i, (leaf, t) in enumerate(zip(self.leaves, leaves)):
            if leaf.zero1_dim is None:
                continue
            local = self.local(t)
            local.copy_(_gather_dim(self.piece(i, local), leaf.zero1_dim,
                                    self.data, self.data_group))

    # -- whole leaves (checkpoints) -------------------------------------------
    @torch.no_grad()
    def full(self, i: int, local: torch.Tensor, moment: bool = False
             ) -> torch.Tensor:
        """Leaf i's whole value from this rank's `local` tensor (a
        moment piece when `moment`); every rank calls it."""
        leaf = self.leaves[i]
        x = local
        if moment and leaf.zero1_dim is not None:
            x = _gather_dim(x, leaf.zero1_dim, self.data, self.data_group)
        if leaf.fsdp_dim is not None:
            dim, n = leaf.fsdp_dim, leaf.part_shape[leaf.fsdp_dim]
            short = -(-n // self.fsdp) - x.shape[dim]
            if short:        # an uneven dim-0 shard, padded as FSDP2 pads
                x = torch.cat([x, x.new_zeros((short, *x.shape[1:]))])
            x = _gather_dim(x, dim, self.fsdp, self.fsdp_group).narrow(
                dim, 0, n)
        if leaf.experts > 1:     # the expert ranks' slices, in order
            x = _gather_dim(x, 0, leaf.experts, self.expert_group)
        axis = leaf.tensor_axis
        if axis is not None:     # the tensor ranks' slices, in order
            x = _gather_dim(x, 0 if axis in ('vocab', 'qkv') else axis,
                            self.tensor, self.tensor_group)
            if axis == 'vocab':
                x = x.narrow(0, 0, leaf.shape[0])
            elif axis == 'qkv':  # [t][q|k|v][n] -> [q|k|v][t][n]
                x = x.reshape(self.tensor, 3, -1, *x.shape[1:]).transpose(
                    0, 1).reshape(leaf.shape)
        return x.contiguous()

    @torch.no_grad()
    def load(self, i: int, local: torch.Tensor, whole: torch.Tensor,
             moment: bool = False) -> None:
        """Copy this rank's part of leaf i's `whole` value into `local`
        (a moment piece when `moment`)."""
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        leaf = self.leaves[i]
        x = whole
        if leaf.tensor_axis == 'vocab':
            x = tensor_lib.vocab_piece(x, self.tensor_index, self.tensor)
        elif leaf.tensor_axis is not None:
            x = tensor_lib.piece(x, leaf.tensor_axis, self.tensor_index,
                                 self.tensor)
        if leaf.experts > 1:
            part = leaf.part_shape[0]
            x = x.narrow(0, self.expert_index * part, part)
        if leaf.fsdp_dim is not None:
            start, size = chunk_bounds(leaf.part_shape[leaf.fsdp_dim],
                                       self.fsdp, self.fsdp_index)
            x = x.narrow(leaf.fsdp_dim, start, size)
        if moment:
            x = self.piece(i, x)
        if tuple(x.shape) != tuple(local.shape):
            raise ValueError(f'{leaf.name}: part {tuple(x.shape)} does not '
                             f'fit {tuple(local.shape)}')
        local.copy_(x)
