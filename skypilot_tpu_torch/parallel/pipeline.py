"""Pipeline-parallel training (port of skypilot_tpu/parallel/pipeline.py:
`PipelinedLM`).

The model's blocks split over S stages. Stage s holds its
`layers_per_stage` blocks (the model's own `Block` modules, built on
its device), its vocab shard of the embedding and head tables, and a
copy of the rest (the final norm, GPT's `wpe`). Under interleaving
device s hosts virtual stages s, S + s, ... (`virtual_stages` chunks of
`layers_per_chunk` layers); a layer count that does not divide pads
with identity slots, which hold no block and add no aux. The tables
are padded to S * `vshard` rows and split by rows (the port's
`lm_head` is [vocab, embed], vocab in rows, as `wte` and `tok_embed`):
the padded columns get no probability mass. This is the reference's
layout: two 525M-parameter tables of Llama-3-8B never land on one
stage, and the head's FLOPs spread over the stages.

One runner for every style. The schedule's op stream
(parallel/pipeline_schedule.py) runs tick by tick from its tables:
`op_kind`, `op_virtual` and `act_slot` say what each stage does, the
`rxf_*` / `rxb_*` slots (indexed by the producer) where a hand-off
lands, `embed_mb` / `gy_mb` / `embv_mb` which microbatch enters,
leaves and is embedded backward. A forward runs its chunk under
`torch.no_grad()` and keeps the chunk input; a backward re-runs the
chunk forward with grad from that input and takes
`torch.autograd.grad` of it with the incoming cotangent (the
reference's per-chunk rematerialization, `bwd_fn`); parameter grads
accumulate in f32. gpipe is the same runner over the gpipe op stream:
the reference's fused scan under `jax.grad` is its oracle, not its
design, and that scan's `remat_ticks` knob has no counterpart here.

The loss of a microbatch is the vocab-parallel next-token loss in f32
(`_vp_next_token_loss`): the last virtual stage's output goes to every
stage, each stage takes its shard's logits, and the log-sum-exp runs
over the stages with a global max; the target logit comes from the one
stage that owns it. The loss is the mean over the M microbatches,
times `scale`; Mixtral adds router_aux_loss_weight / num_layers times
the stages' summed aux (so it is the mean of per-microbatch losses, as
in the reference). Gradients that cross stages: the cotangent of the
last stage's output is the sum over stages of each stage's part, taken
as one f32 reduction of the parts of the final norm's output gradient,
whose backward the last stage then runs once, in the one-device
order of sums (the reference's `psum_t` probe is a JAX artifact and
has no counterpart); the embedding's backward takes the virtual-0 stage's dx
to every stage, each adding it into its shard's rows (GPT's `wpe` on
stage 0 alone); replicated leaves sum their grads over the stages;
over `data` every grad is averaged.

Within each stage the blocks shard over `tensor` and `expert` (the
reference's v2: GSPMD shards the stacked blocks' inner dims by the
logical rules): each layer's block is split by parallel/tensor.py's
table and runs its `tensor_forward` over the stage's tensor group, and
Mixtral's expert stacks are sliced over the stage's expert group; the
vocab tables stay split over `stage` alone and whole over `tensor`, as
the reference's `_rest_specs` lay them. A whole leaf's gradient is then
averaged over the stage's tensor and expert ranks (a part read inside a
sharded region summed), and the grad norm counts each slice once.

The stage group is the one seam between the two forms the runner
takes, and nothing of the arithmetic forks on it:
  - in process (`devices=`): S stages on a list of devices, where a
    device may repeat, or on the rows of a [S][T] device grid, each
    stage's blocks over its row's `LocalTensor`; hand-offs are
    `Tensor.to`, sums run over the stages in stage order (as
    parallel/serving.py `Grid` sums);
  - over ranks (`mesh=`, parallel/mesh.py `make_mesh` with `stage`,
    `data`, `tensor` and `expert` axes): one stage a rank; sums are
    collectives on the `stage` group, hand-offs paired
    `dist.batch_isend_irecv`, the blocks' collectives on the
    `tensor` and `expert` groups.
Every rank knows the tables, so a collective or a hand-off runs only
on the ticks whose entries say a stage needs it, on every rank alike
(the reference's masked collective on every tick was a constraint of
SPMD, not of the algorithm).

Rows: the reference reshapes the global batch [B, seq] to
[M, d * mb, seq] and shards dim 1 over `data`, so data rank i's
microbatch m is global rows [m*d*mb + i*mb, m*d*mb + (i+1)*mb)
(`microbatch_rows`), not the sharded trainer's contiguous block.

`init` and `make_train_step` use parallel/train.py's `ClippedAdamW` and
`TrainState`, so train_lm's loop and its checkpoints stay one. The
global grad norm sums squares over the stages, each replicated leaf
once. Under `guard=True` a non-finite loss or norm, or a norm past
`max_grad_norm`, keeps every parameter and moment and the count; the
step still advances. The pipeline is its state's `layout`: checkpoints
(parallel/checkpoints.py) gather each leaf from its stage, with vocab
shards joined and unpadded, so rank 0 writes the file a one-card run of
the same state writes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from skypilot_tpu_torch.ops import fused_xent
from skypilot_tpu_torch.parallel import pipeline_schedule as psched
from skypilot_tpu_torch.parallel.train import (ClippedAdamW, TrainState,
                                               default_optimizer)


class _Family(NamedTuple):
    """A model family at the pipeline's seam: the name of its block
    list, a block and a final norm to build on a stage, whether a block
    returns the router aux, its tables (embedding and head; GPT's are
    one) and the replicated leaves besides the final norm."""
    blocks: str
    make_block: Callable
    make_norm: Callable
    returns_aux: bool
    embed: str
    head: str
    norm: str
    extra: Tuple[str, ...]

    @property
    def tables(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys((self.embed, self.head)))


def _family_of(model) -> _Family:
    from skypilot_tpu_torch.models import deepseek, gpt, llama, mixtral

    def rms(cfg):
        return llama.RMSNorm(cfg.embed_dim, cfg.norm_eps, cfg.dtype, True)

    if isinstance(model, gpt.GPT):
        return _Family(
            'h', gpt.Block,
            lambda cfg: gpt.LayerNorm(cfg.embed_dim, cfg.norm_eps,
                                      cfg.dtype, True),
            False, 'wte', 'wte', 'ln_f', ('wpe',))
    if isinstance(model, llama.Llama):
        return _Family('layers', llama.Block, rms, False, 'tok_embed',
                       'lm_head', 'final_norm', ())
    if isinstance(model, mixtral.Mixtral):
        return _Family('layers', mixtral.Block, rms, True, 'tok_embed',
                       'lm_head', 'final_norm', ())
    if isinstance(model, deepseek.Deepseek):
        # MLA blocks are llama-shaped at the seam: (x, positions) in,
        # the same table and norm names.
        return _Family('layers', deepseek.Block, rms, False, 'tok_embed',
                       'lm_head', 'final_norm', ())
    raise ValueError(
        f'Pipeline parallelism supports the GPT, Llama, Mixtral, and '
        f'DeepSeek families; got {type(model).__name__}')


def microbatch_rows(batch: int, microbatches: int, data: int = 1,
                    data_index: int = 0) -> List[slice]:
    """The global rows of each microbatch on data rank `data_index`
    (module doc: the reference's [M, d * mb] reshape, dim 1 over
    `data`)."""
    if batch % (microbatches * data):
        raise ValueError(f'batch {batch} must divide into '
                         f'{microbatches} microbatches x data={data}')
    mb = batch // (microbatches * data)
    return [slice(m * data * mb + data_index * mb,
                  m * data * mb + (data_index + 1) * mb)
            for m in range(microbatches)]


# -- the vocab-split head -------------------------------------------------------
# The arithmetic of a vocab slice's logits, targets and backward is
# ops/fused_xent.py's (`shard_logits`, `owned_targets`,
# `shard_backward`), shared with the tensor-parallel loss.
_shard_logits = fused_xent.shard_logits
_owned = fused_xent.owned_targets
_shard_backward = fused_xent.shard_backward


def split_vocab_loss(hidden: torch.Tensor, table: torch.Tensor,
                     tokens: torch.Tensor, shards: int, cfg) -> torch.Tensor:
    """The next-token loss of final-norm hidden states [B, S, E] through
    the head `table` [V, E] padded and split into `shards` vocab shards
    on its device, with the pipeline's per-shard arithmetic
    (fused_xent.SplitVocabXent, one chunk a shard): the one-device
    witness a pipelined step is held to (its loss and head gradients
    less the hand-offs)."""
    from skypilot_tpu_torch.parallel.tensor import LocalTensor
    x2 = hidden[:, :-1].reshape(-1, hidden.shape[-1]).to(cfg.dtype)
    targets = tokens[:, 1:].reshape(-1)
    rows = -(-table.shape[0] // shards)
    padded = torch.nn.functional.pad(
        table, (0, 0, 0, rows * shards - table.shape[0]))
    group = LocalTensor([table.device] * shards)
    return fused_xent.split_vocab_token_losses(
        x2, targets, dict(enumerate(padded.split(rows))), group,
        cfg.vocab_size, round_to=_logits_round(cfg)).mean()


def _logits_round(cfg) -> Optional[torch.dtype]:
    """The dtype a family's head rounds its f32 logits to: GPT's to
    `logits_dtype or dtype`, the others' to `logits_dtype` when set."""
    from skypilot_tpu_torch.models.gpt import GPTConfig
    if isinstance(cfg, GPTConfig):
        return cfg.logits_dtype or cfg.dtype
    return getattr(cfg, 'logits_dtype', None)


# -- the stage group --------------------------------------------------------------
class LocalStages:
    """The stage group in process: stage s on `devices[s]` (a device may
    repeat), or on row s of a device grid [S][T]: the stage's blocks
    then shard over its row's T devices (parallel/tensor.py
    `LocalTensor`; the stage's whole parts run on the row's first
    device). Sums run over the stages in stage order, in f32."""

    def __init__(self, devices) -> None:
        from skypilot_tpu_torch.parallel.tensor import LocalTensor
        rows = [list(d) if isinstance(d, (list, tuple)) else [d]
                for d in devices]
        if any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f'a device grid is rows of equal length, '
                             f'got {devices}')
        self.devices = [torch.device(r[0]) for r in rows]
        self.size = len(self.devices)
        self.local = tuple(range(self.size))
        self.data_size, self.data_index = 1, 0
        #: Each stage's tensor group (None: the stage is whole).
        self.tensors = [LocalTensor(r) if len(r) > 1 else None
                        for r in rows]
        self.expert_size, self.expert_index, self.expert_group = 1, 0, None
        #: Hand-offs and collectives made (the runner's cost counters).
        self.handoffs = self.collectives = 0

    def tensor_of(self, stage: int):
        return self.tensors[stage]

    def sync_whole(self, grads, names, axes) -> None:
        """Whole leaves are shared by a stage's shards here: nothing to
        sync."""
        del grads, names, axes

    def sq_total(self, sq):
        return sq

    def device(self, stage: int) -> torch.device:
        return self.devices[stage]

    def reduce(self, parts: Dict[int, torch.Tensor], dst: int,
               op: str = 'sum') -> Optional[torch.Tensor]:
        """The f32 sum (or max) of every stage's part, on stage `dst`."""
        self.collectives += 1
        home = self.devices[dst]
        acc = parts[0].to(home).float()
        for s in range(1, self.size):
            p = parts[s].to(home).float()
            acc = acc + p if op == 'sum' else torch.maximum(acc, p)
        return acc

    def all_reduce(self, parts: Dict[int, torch.Tensor],
                   op: str = 'sum') -> Dict[int, torch.Tensor]:
        """The reduction on every stage, a tensor of its own each (the
        optimizer scales its grads in place)."""
        acc = self.reduce(parts, 0, op)
        return {s: acc.to(self.devices[s], copy=True) for s in self.local}

    def broadcast(self, src: int, tensor: Optional[torch.Tensor],
                  like: torch.Tensor) -> Dict[int, torch.Tensor]:
        del like
        self.collectives += 1
        return {s: tensor.to(self.devices[s]) for s in self.local}

    def handoff(self, messages: List[tuple], like: torch.Tensor
                ) -> Dict[tuple, torch.Tensor]:
        """messages: (src, dst, key, tensor); {key: tensor on dst}."""
        del like
        self.handoffs += len(messages)
        return {key: t.to(self.devices[dst]) for _, dst, key, t in messages}

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    # Checkpoints: every stage is here, and this process is rank 0.
    def is_main(self) -> bool:
        return True

    def to_main(self, stage: int, tensor: Optional[torch.Tensor],
                like: torch.Tensor) -> Optional[torch.Tensor]:
        del stage, like
        return tensor

    def from_main(self, whole: Optional[torch.Tensor], like: torch.Tensor
                  ) -> torch.Tensor:
        del like
        return whole


class RankStages:
    """The stage group over ranks: this rank's stage on the `stage` axis
    of a parallel/mesh.py DeviceMesh, its own card or the CPU under
    gloo; within the stage its blocks shard over the mesh's `tensor`
    and `expert` groups (the reference's v2: tensor and expert compose
    within stages), and `fsdp` and `seq` are 1. Sums are collectives on
    the axis's group; hand-offs are paired `dist.batch_isend_irecv`."""

    def __init__(self, mesh) -> None:
        import torch.distributed as dist
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        from skypilot_tpu_torch.parallel.tensor import RankTensor
        sizes = mesh_lib.mesh_shape(mesh)
        others = {a: n for a, n in sizes.items()
                  if a in ('fsdp', 'seq') and n > 1}
        if others:
            raise ValueError(f'the pipeline runs on a data x stage x '
                             f'tensor x expert mesh; got '
                             f'{mesh_lib.mesh_summary(mesh)}')
        sub = mesh['stage']
        self.group = sub.get_group()
        self.size = sub.size()
        self.ranks = tuple(sub.mesh.tolist())
        self.local = (sub.get_local_rank(),)
        grid = mesh.mesh.reshape(sizes['data'], sizes['stage'],
                                 sizes['tensor'] * sizes['expert'])
        #: The rank holding stage s on data row 0, tensor and expert
        #: rank 0 (what a save reads).
        self.main_row = tuple(grid[0, :, 0].tolist())
        tensor = sizes['tensor']
        self.tensor = (RankTensor(mesh['tensor'].get_group(),
                                  mesh['tensor'].get_local_rank(), tensor)
                       if tensor > 1 else None)
        self.expert_size = sizes['expert']
        self.expert_index = mesh['expert'].get_local_rank()
        self.expert_group = (mesh['expert'].get_group()
                             if self.expert_size > 1 else None)
        self.data_size = sizes['data']
        self.data_index = mesh['data'].get_local_rank()
        self.data_group = (mesh['data'].get_group() if self.data_size > 1
                           else None)
        self.rank = dist.get_rank()
        self._device = (torch.device('cuda', torch.cuda.current_device())
                        if dist.get_backend() == 'nccl'
                        else torch.device('cpu'))
        self.handoffs = self.collectives = 0

    def device(self, stage: int) -> torch.device:
        del stage
        return self._device

    def reduce(self, parts, dst, op='sum'):
        import torch.distributed as dist
        self.collectives += 1
        buf = parts[self.local[0]].float().contiguous().clone()
        dist.reduce(buf, dst=self.ranks[dst], op=_op(op), group=self.group)
        return buf if self.local[0] == dst else None

    def all_reduce(self, parts, op='sum'):
        import torch.distributed as dist
        self.collectives += 1
        buf = parts[self.local[0]].float().contiguous().clone()
        dist.all_reduce(buf, op=_op(op), group=self.group)
        return {self.local[0]: buf}

    def broadcast(self, src, tensor, like):
        import torch.distributed as dist
        self.collectives += 1
        buf = (tensor.contiguous() if self.local[0] == src
               else torch.empty_like(like))
        dist.broadcast(buf, src=self.ranks[src], group=self.group)
        return {self.local[0]: buf}

    def handoff(self, messages, like):
        import torch.distributed as dist
        me = self.local[0]
        ops, received = [], {}
        for src, dst, key, tensor in messages:
            if src == me:
                ops.append(dist.P2POp(dist.isend, tensor.contiguous(),
                                      self.ranks[dst], self.group))
            if dst == me:
                received[key] = torch.empty_like(like)
                ops.append(dist.P2POp(dist.irecv, received[key],
                                      self.ranks[src], self.group))
        self.handoffs += len(messages)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return received

    def data_sum(self, t):
        import torch.distributed as dist
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
        return t

    def tensor_of(self, stage: int):
        del stage
        return self.tensor

    def sync_whole(self, grads: Dict[str, torch.Tensor], names,
                   axes: Dict[str, object]) -> None:
        """Each whole leaf's gradient over this stage's tensor and expert
        ranks: a copy averaged (so the copies stay bit-identical), or a
        part read inside a sharded region ('sum') summed; one flat
        buffer a kind."""
        import torch.distributed as dist
        for group, size, over in (
                (self.tensor.group if self.tensor else None,
                 self.tensor.size if self.tensor else 1, 'tensor'),
                (self.expert_group, self.expert_size, 'expert')):
            if group is None:
                continue
            for kind in ('mean', 'sum'):
                picked = [n for n in names
                          if _sync_kind(axes.get(n), over) == kind]
                if not picked:
                    continue
                flat = torch.cat([grads[n].reshape(-1) for n in picked])
                dist.all_reduce(flat, group=group)
                if kind == 'mean':
                    flat.div_(size)
                at = 0
                for n in picked:
                    t = grads[n]
                    grads[n] = flat[at:at + t.numel()].view_as(t)
                    at += t.numel()

    def sq_total(self, sq: torch.Tensor) -> torch.Tensor:
        """A stage-summed square sum, summed over tensor and expert."""
        import torch.distributed as dist
        for group in (self.tensor.group if self.tensor else None,
                      self.expert_group):
            if group is not None:
                dist.all_reduce(sq, group=group)
        return sq

    def is_main(self) -> bool:
        return self.rank == 0

    def to_main(self, stage, tensor, like):
        """Stage `stage`'s tensor (held on data row 0) on rank 0."""
        import torch.distributed as dist
        src = self.main_row[stage]
        buf = tensor.contiguous() if self.rank == src else \
            torch.empty_like(like)
        dist.broadcast(buf, src=src)
        return buf if self.rank == 0 else None

    def from_main(self, whole, like):
        import torch.distributed as dist
        buf = (whole.to(device=like.device, dtype=like.dtype).contiguous()
               if self.rank == 0 else torch.empty_like(like))
        dist.broadcast(buf, src=0)
        return buf


def _sync_kind(split, over: str) -> Optional[str]:
    """How a leaf's gradient syncs over `over` ('tensor' or 'expert'),
    from its split (its tensor split, whether its experts are sliced):
    'mean' for a whole copy, 'sum' for a part read inside a sharded
    region, None for a slice."""
    taxis, expert = split or (None, False)
    if over == 'tensor':
        return {None: 'mean', 'sum': 'sum'}.get(taxis)
    return None if expert else 'mean'


def _op(name: str):
    import torch.distributed as dist
    return dist.ReduceOp.SUM if name == 'sum' else dist.ReduceOp.MAX


class _Stage:
    """One stage's pieces on its device: its blocks by global layer (and
    under tensor parallelism each layer's shards, {shard: block}, shard
    0's the block itself), its final norm, its table shards and
    replicated extras, and every parameter by the model's name
    (`params`, in a fixed order; another shard's slice of a leaf as
    `name@t`)."""

    def __init__(self, index: int, device: torch.device,
                 blocks: Dict[int, nn.Module], norm: nn.Module,
                 tables: Dict[str, torch.Tensor],
                 extra: Dict[str, torch.Tensor], names: Dict[int, str],
                 norm_name: str, shards: Dict[int, Dict[int, nn.Module]],
                 tensor) -> None:
        self.index, self.device = index, device
        self.blocks, self.norm = blocks, norm
        self.shards, self.tensor = shards, tensor
        self.tables, self.extra = tables, extra
        self.params: Dict[str, torch.Tensor] = {}
        self.layer_params: Dict[int, List[Tuple[str, torch.Tensor]]] = {}
        for i in sorted(blocks):
            own = []
            for j, (t, block) in enumerate(shards[i].items()):
                seen = {id(p) for _, p in own}
                own += [(f'{names[i]}.{n}' + (f'@{t}' if j else ''), p)
                        for n, p in block.named_parameters()
                        if id(p) not in seen]
            self.layer_params[i] = own
            self.params.update(own)
        self.params.update(tables)
        for n, p in norm.named_parameters():
            self.params[f'{norm_name}.{n}'] = p
        self.params.update(extra)


class PipelinedLM:
    """Pipeline-parallel training step (GPT/Llama/Mixtral/DeepSeek).

        pp = PipelinedLM(model, devices=['cuda:0', 'cuda:0'],
                         num_microbatches=8, schedule='1f1b')
        state = pp.init(tx)                  # the model's weights, split
        step = pp.make_train_step(tx)        # (state, tokens) -> ...

    or `mesh=` (a data x stage x tensor x expert DeviceMesh of a job)
    instead of `devices=`, one stage a rank; `devices=` may be a [S][T]
    grid, T tensor shards a stage. `tokens` are the global batch
    [B, seq] on every rank. `schedule` is 'gpipe', '1f1b' or
    'interleaved' (`virtual_stages` layer chunks a device)."""

    #: What parallel/checkpoints.py looks for on a state's layout.
    pipelined = True

    def __init__(self, model, mesh=None, num_microbatches: int = 8,
                 schedule: str = 'gpipe', virtual_stages: int = 1,
                 devices=None) -> None:
        if (mesh is None) == (devices is None):
            raise ValueError('pass mesh= (one stage a rank) or devices= '
                             '(every stage in this process), not both')
        self.family = _family_of(model)
        self.model = model
        self.cfg = cfg = model.config
        if not cfg.trainable:
            raise ValueError('the pipeline trains f32 master parameters: '
                             'build the model with param_dtype='
                             'torch.float32 (registry.train_config)')
        if getattr(cfg, 'dropout_rate', 0.0):
            raise ValueError(
                'PipelinedLM runs blocks deterministically; '
                'dropout_rate > 0 would be silently ignored — train '
                'without dropout or use ShardedTrainer.')
        if getattr(cfg, 'remat', False):
            raise ValueError(
                'PipelinedLM does not rematerialize blocks; set '
                'remat=False (per-tick remat already bounds live '
                'activations — see remat_ticks).')
        self.group = (LocalStages(devices) if devices is not None
                      else RankStages(mesh))
        S = self.num_stages = self.group.size
        self.num_microbatches = num_microbatches
        self.schedule_style = schedule
        self.virtual_stages = virtual_stages
        self.schedule = psched.make_schedule(
            S, num_microbatches, style=schedule,
            virtual_stages=virtual_stages)
        V = S * virtual_stages
        self.layers_per_chunk = -(-cfg.num_layers // V)
        self.layers_per_stage = self.layers_per_chunk * virtual_stages
        self.padded_layers = self.layers_per_chunk * V
        self.vshard = -(-cfg.vocab_size // S)
        self.padded_vocab = self.vshard * S
        self.aux_scale = (cfg.router_aux_loss_weight / cfg.num_layers
                          if self.family.returns_aux else 0.0)
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        tensor = self.group.tensor_of(self.group.local[0])
        #: Tensor shards within a stage (1: the stages are whole).
        self.tensor_ways = ways = tensor.size if tensor is not None else 1
        self.kv_split, axes = tensor_lib.model_axes(model, ways)
        block0 = f'{self.family.blocks}.0.'
        #: {block-relative leaf name: its tensor split}.
        self.block_axes = {n[len(block0):]: a for n, a in axes.items()
                           if n.startswith(block0)} if ways > 1 else {}
        named = list(model.named_parameters())
        #: The model's parameter names and shapes, in its order (the
        #: order a one-card checkpoint holds them in).
        self.names = [n for n, _ in named]
        self.shapes = {n: tuple(p.shape) for n, p in named}
        self.stages: List[_Stage] = []
        self.tx: Optional[ClippedAdamW] = None

    # -- layout ---------------------------------------------------------------
    def stage_of_layer(self, layer: int) -> int:
        """The device stage holding global layer `layer`."""
        return (layer // self.layers_per_chunk) % self.num_stages

    def layers_of(self, virtual: int) -> List[int]:
        """The real (unpadded) global layers of virtual stage `virtual`."""
        lo = virtual * self.layers_per_chunk
        return [i for i in range(lo, lo + self.layers_per_chunk)
                if i < self.cfg.num_layers]

    def _kind(self, name: str) -> Tuple[str, Optional[int]]:
        """('block', its stage) | ('table', None) | ('rest', None)."""
        fam = self.family
        head = name.split('.')[0]
        if head == fam.blocks:
            return 'block', self.stage_of_layer(int(name.split('.')[1]))
        if name in fam.tables:
            return 'table', None
        return 'rest', None

    def _pad(self, table: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.padded_vocab,) + tuple(table.shape[1:]),
                          dtype=table.dtype, device=table.device)
        out[:table.shape[0]] = table
        return out

    def split_params(self, params: Dict[str, torch.Tensor]
                     ) -> List[Dict[str, torch.Tensor]]:
        """The model's state {name: tensor} as each stage's pieces: its
        blocks' leaves, its row shard of each padded table, and the
        replicated rest (the input's tensors, not copies, except the
        shards)."""
        pieces: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(self.num_stages)]
        for name in self.names:
            kind, stage = self._kind(name)
            t = params[name]
            if kind == 'block':
                pieces[stage][name] = t
            elif kind == 'table':
                padded = self._pad(t)
                for s in range(self.num_stages):
                    pieces[s][name] = padded[s * self.vshard:
                                             (s + 1) * self.vshard].clone()
            else:
                for s in range(self.num_stages):
                    pieces[s][name] = t
        return pieces

    def merge_params(self, pieces: List[Dict[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
        """The inverse of `split_params`: {name: tensor} in the model's
        order, the tables joined and unpadded (on stage 0's device)."""
        out: Dict[str, torch.Tensor] = {}
        home = next(iter(pieces[0].values())).device
        for name in self.names:
            kind, stage = self._kind(name)
            if kind == 'block':
                out[name] = pieces[stage][name]
            elif kind == 'table':
                out[name] = torch.cat([p[name].to(home) for p in pieces])[
                    :self.shapes[name][0]]
            else:
                out[name] = pieces[0][name]
        return out

    def _build_stages(self, pieces: List[Dict[str, torch.Tensor]]) -> None:
        """Each local stage's modules on its device, holding copies of
        its pieces (a block is built on the meta device and takes its
        tensors)."""
        fam, cfg = self.family, self.cfg
        self.stages = []
        for s in self.group.local:
            dev = self.group.device(s)
            tensor = self.group.tensor_of(s)
            own = {n: t.detach().to(dev, copy=True)
                   for n, t in pieces[s].items()}
            blocks, names, shards = {}, {}, {}
            for k in range(self.virtual_stages):
                for i in self.layers_of(k * self.num_stages + s):
                    prefix = f'{fam.blocks}.{i}.'
                    state = {n[len(prefix):]: t for n, t in own.items()
                             if n.startswith(prefix)}
                    shards[i] = self._block_shards(state, tensor)
                    blocks[i] = next(iter(shards[i].values()))
                    names[i] = f'{fam.blocks}.{i}'
            with torch.device('meta'):
                norm = fam.make_norm(cfg)
            prefix = f'{fam.norm}.'
            norm.load_state_dict({n[len(prefix):]: t for n, t in own.items()
                                  if n.startswith(prefix)}, assign=True)
            leaf = lambda n: nn.Parameter(own[n])  # noqa: E731
            self.stages.append(_Stage(
                s, dev, blocks, norm,
                {n: leaf(n) for n in fam.tables},
                {n: leaf(n) for n in fam.extra}, names, fam.norm, shards,
                tensor))

    def read_heads(self, shard: int, ways: int):
        """The kv heads shard `shard`'s q heads read under the GQA
        remainder rule (parallel/tensor.py), or None."""
        from skypilot_tpu_torch.parallel.tensor import remainder_read_heads
        num_kv = int(getattr(self.cfg, 'num_kv_heads', 0) or 0)
        return (remainder_read_heads(self.cfg.num_heads, num_kv, shard, ways)
                if num_kv else None)

    def _block_shards(self, state: Dict[str, torch.Tensor], tensor
                      ) -> Dict[int, nn.Module]:
        """One layer's block from its whole `state` (on the stage's
        device): {0: it} when the stage is whole, else its tensor
        shards (parallel/tensor.py: sliced in place over ranks; in
        process shard t > 0 on its device, sharing shard 0's whole
        leaves), and over `expert` its experts' slice."""
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        fam, cfg = self.family, self.cfg

        def build(t: int, ways: int) -> nn.Module:
            with torch.device('meta'):
                block = fam.make_block(cfg)
            if ways > 1:
                tensor_lib.shard_block(block, t, ways, self.kv_split,
                                       self.read_heads(t, ways))
                parts = {n: tensor_lib.piece(x, self.block_axes.get(n), t,
                                             ways).clone()
                         if self.block_axes.get(n) not in (None, 'sum')
                         else x for n, x in state.items()}
            else:
                parts = state
            block.load_state_dict(parts, assign=True)
            return block

        g = self.group
        ways = tensor.size if tensor is not None else 1
        local = tensor.local if tensor is not None else (0,)
        out = {}
        for t in local:
            block = build(t, ways)
            if tensor is not None and tensor.device(t) is not None:
                block.to(tensor.device(t))
            if g.expert_size > 1 and hasattr(block, 'moe'):
                block.moe.shard_experts(g.expert_group, g.expert_index,
                                        g.expert_size)
            out[t] = block
        home = out[local[0]]
        for t in local[1:]:
            # In process: a shard shares shard 0's whole leaves.
            for n, p in home.named_parameters():
                if self.block_axes.get(n) in (None, 'sum'):
                    tensor_lib.replace_param(out[t], n, p)
        return out

    # -- training -------------------------------------------------------------
    def init(self, tx: Optional[ClippedAdamW] = None,
             params: Optional[Dict[str, torch.Tensor]] = None
             ) -> TrainState:
        """The train state over the stages' pieces of `params` (default:
        the model's own weights), with zero moments a stage. The model's
        tensors are then released (moved to the meta device): the stages
        hold the weights from here on."""
        self.tx = tx if tx is not None else default_optimizer()
        if params is None:
            params = dict(self.model.named_parameters())
        self._build_stages(self.split_params(params))
        del params
        self.model.to('meta')
        return TrainState(
            step=0,
            params={st.index: st.params for st in self.stages},
            opt_state={st.index: self.tx.init(list(st.params.values()))
                       for st in self.stages},
            layout=self)

    def _microbatches(self, tokens: torch.Tensor
                      ) -> Dict[int, List[torch.Tensor]]:
        g = self.group
        rows = microbatch_rows(tokens.shape[0], self.num_microbatches,
                               g.data_size, g.data_index)
        return {st.index: [tokens[r].to(st.device, torch.long)
                           for r in rows] for st in self.stages}

    def _chunk(self, stage: _Stage, virtual: int, x: torch.Tensor):
        """One chunk forward: (y, the summed router aux or None)."""
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape[0],
                                                         x.shape[1])
        aux = None
        tensor = stage.tensor
        kw = {'with_aux': True} if self.family.returns_aux else {}
        for i in self.layers_of(virtual):
            block = stage.blocks[i]
            if tensor is None:
                out = block(x, positions, **kw)
            elif len(tensor.local) == 1:
                out = block(x, positions, tensor=tensor, **kw)
            else:
                from skypilot_tpu_torch.parallel.tensor import to_shards
                out = type(block).tensor_forward(
                    stage.shards[i], tensor, x,
                    to_shards(tensor, positions), **kw)
            if self.family.returns_aux:
                x, a = out
                aux = a if aux is None else aux + a
            else:
                x = out
        return x, aux

    def _chunk_backward(self, stage: _Stage, virtual: int,
                        x_saved: torch.Tensor, g: torch.Tensor,
                        aux_ct: torch.Tensor,
                        acc: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Re-run the chunk from its stored input with grad and pull the
        cotangent `g` (and `aux_ct` into the aux) through it: the
        parameter grads add into `acc` in f32; returns dx."""
        x = x_saved.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = self._chunk(stage, virtual, x)
        names = [n for i in self.layers_of(virtual)
                 for n, _ in stage.layer_params[i]]
        params = [stage.params[n] for n in names]
        outs, cots = [y], [g]
        if aux is not None:
            outs.append(aux)
            cots.append(aux_ct)
        grads = torch.autograd.grad(outs, [x] + params, cots,
                                    allow_unused=True)
        for n, d in zip(names, grads[1:]):
            if d is not None:
                acc[n] += d.float()
        return grads[0]

    def _embed_part(self, stage: _Stage, tokens: torch.Tensor
                    ) -> torch.Tensor:
        """This stage's rows of the embedding of `tokens` (zeros where
        another stage owns the id), in the compute dtype."""
        table = stage.tables[self.family.embed]
        local, owned = _owned(tokens, stage.index * self.vshard,
                              self.vshard)
        x = table[local].to(self.cfg.dtype)
        return torch.where(owned[..., None], x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))

    def _embed_backward(self, stage: _Stage, tokens: torch.Tensor,
                        dx: torch.Tensor, acc: Dict[str, torch.Tensor]
                        ) -> None:
        fam = self.family
        local, owned = _owned(tokens, stage.index * self.vshard, self.vshard)
        rows = torch.where(owned.reshape(-1, 1),
                           dx.reshape(-1, dx.shape[-1]).float(),
                           torch.zeros((), device=dx.device))
        acc[fam.embed].index_add_(0, local.reshape(-1), rows)
        if 'wpe' in fam.extra and stage.index == 0:
            acc['wpe'][:dx.shape[1]] += dx.sum(dim=0).float()

    def _head(self, ys: Dict[int, torch.Tensor],
              tokens: Dict[int, torch.Tensor], coef: Dict[int, Any],
              acc: Optional[Dict[int, Dict[str, torch.Tensor]]]):
        """The vocab-parallel loss of the last stage's output `ys` (a
        copy on every local stage) against `tokens`: ({stage: ce}, and
        with `acc` d ce / d y on the last stage, or None). Each stage's
        head grads, times `coef`, add into `acc`; the stages' parts of
        the gradient of the final norm's output are summed in f32 on the
        last stage, which takes the norm's backward once (so the norm's
        grads land there)."""
        g, cfg, fam = self.group, self.cfg, self.family
        dt, V, last = cfg.dtype, self.vshard, self.num_stages - 1
        round_to = _logits_round(cfg)
        work, maxes = {}, {}
        for st in self.stages:
            s = st.index
            x = ys[s].detach()
            with torch.set_grad_enabled(acc is not None and s == last):
                x.requires_grad_(torch.is_grad_enabled())
                xn = st.norm(x)
            x2 = xn.detach()[:, :-1].reshape(-1, xn.shape[-1]).to(dt)
            logits = _shard_logits(x2, st.tables[fam.head].detach(), s * V,
                                   cfg.vocab_size, round_to)
            local, owned = _owned(tokens[s][:, 1:].reshape(-1), s * V, V)
            tl = torch.where(owned, logits.gather(1, local[:, None])[:, 0],
                             torch.zeros((), device=logits.device))
            work[s] = (st, x, xn, x2, logits, local, owned, tl)
            maxes[s] = logits.max(dim=1).values
        m = g.all_reduce(maxes, 'max')
        sums = g.all_reduce({s: torch.stack([
            torch.exp(w[4] - m[s][:, None]).sum(dim=1), w[7]])
            for s, w in work.items()})
        ce, parts = {}, {}
        for s, (st, x, xn, x2, logits, local, owned, _) in work.items():
            lse = m[s] + torch.log(sums[s][0])
            ce[s] = (lse - sums[s][1]).mean()
            if acc is None:
                continue
            parts[s], d_table = _shard_backward(
                logits, lse, local, owned, coef[s] / x2.shape[0], x2,
                st.tables[fam.head].detach())
            acc[s][fam.head] += d_table
        if acc is None:
            return ce, None
        d_x2 = g.reduce(parts, last)
        if d_x2 is None:
            return ce, None
        st, x, xn = work[last][:3]
        d_xn = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
        d_xn[:, :-1] = d_x2.reshape(xn.shape[0], -1, xn.shape[-1])
        norm_params = list(st.norm.named_parameters())
        grads = torch.autograd.grad(xn, [x] + [p for _, p in norm_params],
                                    d_xn.to(xn.dtype))
        for (n, _), d in zip(norm_params, grads[1:]):
            acc[last][f'{fam.norm}.{n}'] += d.float()
        return ce, grads[0]

    def _run(self, tokens: torch.Tensor, scale, need_grad: bool):
        """The schedule's ticks: ({stage: loss}, {stage: {name: grad}}
        or None)."""
        g, cfg, sched = self.group, self.cfg, self.schedule
        tb, S = sched.tables, self.num_stages
        V, M = S * self.virtual_stages, self.num_microbatches
        dt, FWD = cfg.dtype, psched.FWD
        mbs = self._microbatches(tokens)
        first = self.stages[0]
        mb_rows = mbs[first.index][0].shape[0]
        like = torch.empty((mb_rows, tokens.shape[1], cfg.embed_dim),
                           dtype=dt, device=first.device)
        scales = {st.index: torch.as_tensor(
            1.0 if scale is None else scale, dtype=torch.float32,
            device=st.device) for st in self.stages}
        acc = ({st.index: {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=st.device)
                           for n, p in st.params.items()}
                for st in self.stages} if need_grad else None)
        aux_ct = {s: self.aux_scale * sc for s, sc in scales.items()}
        act = {st.index: {} for st in self.stages}
        rxf = {st.index: {} for st in self.stages}
        rxb = {st.index: {} for st in self.stages}
        gy: Dict[int, torch.Tensor] = {}
        ce_sum = {s: torch.zeros((), device=sc.device)
                  for s, sc in scales.items()}
        aux_sum = {s: torch.zeros((), device=sc.device)
                   for s, sc in scales.items()}
        by_index = {st.index: st for st in self.stages}
        for t in range(sched.num_ticks):
            emb = None
            m_in = int(tb['embed_mb'][t])
            if m_in >= 0:
                emb = g.reduce({s: self._embed_part(st, mbs[s][m_in])
                                for s, st in by_index.items()}, 0)
                if emb is not None:
                    emb = emb.to(dt)
                    if 'wpe' in self.family.extra:
                        emb = emb + by_index[0].extra['wpe'][
                            :emb.shape[1]].to(dt)
            outs: Dict[int, torch.Tensor] = {}
            y_last = dx_embed = None
            for s, st in by_index.items():
                kind = int(tb['op_kind'][t, s])
                if kind == 0 or (kind != FWD and not need_grad):
                    continue
                vs = int(tb['op_virtual'][t, s])
                slot = int(tb['act_slot'][t, s])
                if kind == FWD:
                    x = emb if vs == 0 else rxf[s].pop(
                        int(tb['rxf_rslot'][t, s]))
                    if need_grad:
                        act[s][slot] = x
                    with torch.no_grad():
                        y, aux = self._chunk(st, vs, x)
                    if aux is not None:
                        aux_sum[s] = aux_sum[s] + aux
                    if vs == V - 1:
                        y_last = y
                    else:
                        outs[s] = y
                else:
                    x = act[s].pop(slot)
                    g_in = (gy.pop(int(tb['gy_rslot'][t])) if vs == V - 1
                            else rxb[s].pop(int(tb['rxb_rslot'][t, s])))
                    dx = self._chunk_backward(st, vs, x, g_in, aux_ct[s],
                                              acc[s])
                    if vs == 0:
                        dx_embed = dx
                    else:
                        outs[s] = dx
            m_out = int(tb['gy_mb'][t])
            if m_out >= 0:
                ys = g.broadcast(S - 1, y_last, like)
                ce, g_last = self._head(
                    ys, {s: mbs[s][m_out] for s in ys}, scales, acc)
                for s in ce:
                    ce_sum[s] = ce_sum[s] + ce[s]
                if g_last is not None:
                    gy[int(tb['gy_wslot'][t])] = g_last.to(dt)
            m_back = int(tb['embv_mb'][t])
            if m_back >= 0 and need_grad:
                dxs = g.broadcast(0, dx_embed, like)
                for s, st in by_index.items():
                    self._embed_backward(st, mbs[s][m_back], dxs[s], acc[s])
            messages = []
            for s in range(S):
                w = int(tb['rxf_wslot'][t, s])
                if w >= 0:
                    dst = (s + 1) % S
                    messages.append((s, dst, ('f', dst, w), outs.get(s)))
                w = int(tb['rxb_wslot'][t, s])
                if w >= 0 and need_grad:
                    dst = (s - 1) % S
                    messages.append((s, dst, ('b', dst, w), outs.get(s)))
            if messages:
                for (ring, dst, w), tensor in g.handoff(messages,
                                                        like).items():
                    (rxf if ring == 'f' else rxb)[dst][w] = tensor
        if self.family.returns_aux:
            aux_sum = g.all_reduce(aux_sum)
        losses = {}
        for s, sc in scales.items():
            total = (ce_sum[s] + self.aux_scale * aux_sum[s]) / M
            losses[s] = g.data_sum(total.clone()) / g.data_size * sc
        if not need_grad:
            return losses, None
        return losses, self._finish_grads(acc)

    def _finish_grads(self, acc):
        """The runner's sums as the step's grads: over `data` averaged
        (one flat buffer a stage), divided by M, and the replicated
        leaves summed over the stages."""
        g, M = self.group, self.num_microbatches
        rest = [n for n in self.names if self._kind(n)[0] == 'rest']
        for s, grads in acc.items():
            flat = torch.cat([t.reshape(-1) for t in grads.values()])
            flat = g.data_sum(flat).div_(g.data_size * M)
            at = 0
            for n, t in grads.items():
                grads[n] = flat[at:at + t.numel()].view_as(t)
                at += t.numel()
            g.sync_whole(grads, list(grads), {n: self._split(n)
                                              for n in grads})
        summed = g.all_reduce({s: torch.cat([acc[s][n].reshape(-1)
                                             for n in rest])
                               for s in acc})
        for s, flat in summed.items():
            at = 0
            for n in rest:
                t = acc[s][n]
                acc[s][n] = flat[at:at + t.numel()].view_as(t)
                at += t.numel()
        return acc

    def loss_and_grad(self, tokens: torch.Tensor, scale: Any = None):
        """(loss, {stage: {name: grad}}) of the global batch `tokens`
        [B, seq] in one pass of the schedule; `scale` (default 1.0)
        multiplies every cotangent seed and the loss (the guard's
        loss_scale: NaN poisons both). The loss is a device scalar on
        this process's first stage, the same on every stage and rank."""
        losses, grads = self._run(tokens, scale, True)
        return losses[self.stages[0].index], grads

    @torch.no_grad()
    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """The mean LM loss of `tokens`: the schedule's forwards alone."""
        losses, _ = self._run(tokens, None, False)
        return losses[self.stages[0].index]

    def _split(self, name: str):
        """(its tensor split, whether its experts are sliced) of stage
        leaf `name` (a block leaf's from `block_axes`; tables, norms and
        extras are whole)."""
        if self._kind(name)[0] != 'block':
            return None, False
        rel = name.split('@')[0].split('.', 2)[2]
        return (self.block_axes.get(rel), self.group.expert_size > 1
                and rel in ('moe.w_gate', 'moe.w_up', 'moe.w_down'))

    def _counted(self, name: str) -> bool:
        """Whether this rank's copy of a leaf counts in the grad norm: a
        tensor or expert slice on every rank, a whole leaf on tensor and
        expert rank 0."""
        tensor = self.group.tensor_of(self.group.local[0])
        taxis, expert = self._split(name)
        if tensor is not None and tensor.index and \
                taxis in (None, 'sum'):
            return False
        return not (self.group.expert_index and not expert)

    def global_sq(self, grads) -> Dict[int, torch.Tensor]:
        """{stage: the sum of squares of every grad of the pipeline},
        each replicated leaf counted once (stage 0's; tensor and expert
        rank 0's)."""
        parts = {}
        for s, gs in grads.items():
            parts[s] = sum(
                (t.float().square().sum() for n, t in gs.items()
                 if (s == 0 or self._kind(n)[0] != 'rest')
                 and self._counted(n)),
                torch.zeros((), device=self.stages[0].device))
        return {s: self.group.sq_total(sq)
                for s, sq in self.group.all_reduce(parts).items()}

    def make_train_step(self, tx: Optional[ClippedAdamW] = None,
                        guard: bool = False,
                        collect_grad_norm: bool = False) -> Callable:
        """Unguarded: `(state, tokens) -> (state, loss)`, or
        `(state, (loss, grad_norm))` with `collect_grad_norm`. With
        `guard`: `(state, tokens, max_grad_norm=inf, loss_scale=1.0) ->
        (state, (loss, grad_norm, bad))`, `bad` computed on the device
        from the global loss and norm, the same on every stage; a bad
        step keeps every parameter and moment. Both update `state` in
        place and return it."""
        tx = tx if tx is not None else self.tx
        collect = collect_grad_norm or guard

        def run(state, tokens, max_grad_norm, loss_scale, guarded):
            losses, grads = self._run(
                tokens, loss_scale if guarded else None, True)
            norms = {s: torch.sqrt(sq)
                     for s, sq in self.global_sq(grads).items()}
            bad = {}
            for s, params in state.params.items():
                if guarded:
                    bad[s] = (~torch.isfinite(losses[s])
                              | ~torch.isfinite(norms[s])
                              | (norms[s] > max_grad_norm))
                tx.update(list(params.values()), list(grads[s].values()),
                          state.opt_state[s], norm=norms[s],
                          bad=bad.get(s))
            state.step += 1
            s0 = self.stages[0].index
            if guarded:
                return state, (losses[s0], norms[s0], bad[s0])
            return state, ((losses[s0], norms[s0]) if collect
                           else losses[s0])

        def step(state: TrainState, tokens: torch.Tensor):
            return run(state, tokens, None, None, False)

        def guarded(state: TrainState, tokens: torch.Tensor,
                    max_grad_norm: float = math.inf,
                    loss_scale: float = 1.0):
            return run(state, tokens, max_grad_norm, loss_scale, True)

        return guarded if guard else step

    # -- checkpoints (parallel/checkpoints.py) --------------------------------
    def _holders(self, name: str) -> List[int]:
        kind, stage = self._kind(name)
        if kind == 'block':
            return [stage]
        return list(range(self.num_stages)) if kind == 'table' else [0]

    def _leaf(self, state: TrainState, stage: int, name: str,
              what: str) -> Optional[torch.Tensor]:
        """This process's copy of leaf `name` of `stage` ('param', 'mu' or
        'nu'), or None when the stage is not here."""
        params = state.params.get(stage)
        if params is None or name not in params:
            return None
        if what == 'param':
            return params[name]
        return state.opt_state[stage][what][list(params).index(name)]

    def _part_shape(self, name: str) -> Tuple[int, ...]:
        """The shape of a block leaf's slice on one rank (tensor split,
        experts sliced)."""
        shape = list(self.shapes[name])
        taxis, expert = self._split(name)
        if expert:
            shape[0] //= self.group.expert_size
        if taxis not in (None, 'sum'):
            shape[0 if taxis == 'qkv' else taxis] //= self.tensor_ways
        return tuple(shape)

    def _joined(self, state: TrainState, stage: int, name: str,
                what: str) -> Optional[torch.Tensor]:
        """Leaf `name` of `stage` whole on this process: its tensor and
        expert slices joined (over the stage's tensor and expert groups,
        which every rank calls; in process from the shards' `name@t`),
        or None when the stage is not here."""
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        from skypilot_tpu_torch.parallel.fsdp import _gather_dim
        taxis, expert = self._split(name)
        g = self.group
        tensor = g.tensor_of(g.local[0])
        x = self._leaf(state, stage, name, what)
        sliced = taxis not in (None, 'sum') and tensor is not None
        if not (sliced or expert):
            return x
        if isinstance(g, LocalStages):
            if x is None:
                return None
            return tensor_lib.join_pieces(
                [x] + [self._leaf(state, stage, f'{name}@{t}', what)
                       for t in tensor.local[1:]], taxis, self.shapes[name])
        if x is None:
            x = torch.zeros(self._part_shape(name), dtype=torch.float32,
                            device=self.stages[0].device)
        if expert:
            x = _gather_dim(x.contiguous(), 0, g.expert_size, g.expert_group)
        if sliced:
            parts = [torch.empty_like(x) for _ in range(tensor.size)]
            import torch.distributed as dist
            dist.all_gather(parts, x.contiguous(), group=tensor.group)
            x = tensor_lib.join_pieces(parts, taxis, self.shapes[name])
        return x if self._leaf(state, stage, name, what) is not None \
            else None

    def _piece_like(self, name: str) -> torch.Tensor:
        shape = self.shapes[name]
        if self._kind(name)[0] == 'table':
            shape = (self.vshard,) + shape[1:]
        return torch.empty(shape, dtype=torch.float32,
                           device=self.stages[0].device)

    @torch.no_grad()
    def gather_leaf(self, state: TrainState, i: int, what: str
                    ) -> Optional[torch.Tensor]:
        """Leaf i of the model ('param', 'mu' or 'nu') whole on the host
        of rank 0 (None elsewhere): from its stage, its table shards
        joined and unpadded. Collective over the job."""
        name = self.names[i]
        like = self._piece_like(name)
        parts = [self.group.to_main(s, self._joined(state, s, name, what),
                                    like) for s in self._holders(name)]
        if not self.group.is_main():
            return None
        whole = parts[0] if len(parts) == 1 else torch.cat(
            [p.to(parts[0].device) for p in parts])[:self.shapes[name][0]]
        return whole.detach().cpu().clone()

    @torch.no_grad()
    def load_leaf(self, state: TrainState, i: int, what: str,
                  whole: Optional[torch.Tensor]) -> None:
        """Copy leaf i (whole on rank 0, None elsewhere) into every local
        stage's piece of it. Collective over the job."""
        name = self.names[i]
        like = torch.empty(self.shapes[name], dtype=torch.float32,
                           device=self.stages[0].device)
        whole = self.group.from_main(whole, like)
        kind, owner = self._kind(name)
        if kind == 'table':
            whole = self._pad(whole.to(like.device))
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        taxis, expert = self._split(name)
        g = self.group
        for st in self.stages:
            if kind == 'block' and owner != st.index:
                continue
            src = whole
            if kind == 'table':
                src = whole[st.index * self.vshard:
                            (st.index + 1) * self.vshard]
            tensor = st.tensor
            for j, t in enumerate(tensor.local if tensor is not None
                                  else (0,)):
                local = self._leaf(state, st.index,
                                   f'{name}@{t}' if j else name, what)
                if local is None:
                    continue        # a whole leaf shard 0 holds for all
                part = src
                if tensor is not None and taxis not in (None, 'sum'):
                    part = tensor_lib.piece(part, taxis, t, tensor.size)
                if expert:
                    n = part.shape[0] // g.expert_size
                    part = part.narrow(0, g.expert_index * n, n)
                local.copy_(part)

    def count(self, state: TrainState) -> int:
        return int(state.opt_state[self.stages[0].index]['count'])

    def set_count(self, state: TrainState, count: int) -> None:
        for opt in state.opt_state.values():
            opt['count'].fill_(count)

