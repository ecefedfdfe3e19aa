"""Training harness (port of skypilot_tpu/parallel/train.py:
`TrainState`, `next_token_loss`, `default_optimizer`, `ShardedTrainer`).

The reference jits its step over a mesh; the port runs eagerly, on one
card, or with `mesh=` (parallel/mesh.py `make_mesh`) on one rank of a
job: FSDP over the mesh's `fsdp` axis, the parameters replicated over
`data`, `zero1` and `overlap` as the reference defines them, Mixtral's
experts split over `expert`, heads, the MLP and the vocab over `tensor`
(the layout and its collectives: parallel/fsdp.py; the sharded forward
and vocab-split loss: parallel/tensor.py, ops/fused_xent.py), or with
`devices=` over tensor shards in this process (parallel/tensor.py
`LocalLayout`), and over `seq` the step runs under
`context_parallel(mesh)` (the reference's `:325`, `:413`, `:491`):
each seq rank reads whole rows, embeds its block of them at its global
positions and attends through the ring (ops/ring_attention.py); its
loss is its block's share of the rows' (`_block_loss`).
`ShardedTrainer` keeps the reference's API (`init`, `make_train_step`,
`make_eval_step`, `fused_xent` auto, `collect_grad_norm`, `lora=`,
`guard=`). Parameters
are the model's own f32 master tensors (`LlamaConfig.param_dtype`), and
the optimizer updates them and its moments IN PLACE: JAX returns new
arrays, the port saves a copy of every parameter and moment that way.
Over a mesh each rank's step takes its own rows of the global batch
(`mesh.batch_rows`) and returns the job-wide loss and grad norm, the
same on every rank.

`default_optimizer` is optax's `chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))` written out to optax's semantics,
not `torch.optim.AdamW` / `clip_grad_norm_`, which differ from it:
  - clipping scales by max_norm / |g| only when |g| >= max_norm (no
    epsilon);
  - the update is -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), the
    decay on every leaf (norm scales and embeddings included);
  - the schedule is read at the count BEFORE the increment, so with a
    warmup from 0 the first step has lr = 0 and moves no parameter.

With `lora=` the base is frozen (no grads, and no optimizer moments:
optax's `multi_transform(..., set_to_zero)` allocates none for it) and
only the A/B factors train.

The optimizer's count is a device int tensor, and the learning rate and
the bias corrections come from a table (the schedule's own f32 values,
computed on the host once) indexed by it: so a guarded step that skips
its update can leave the count where it was without a host sync.
`ShardedTrainer(guard=True)` makes that step (the reference's
`_step_body` with `ctl`): `(state, tokens, max_grad_norm, loss_scale)
-> (state, (loss, gnorm, bad))`, `bad` computed on the device; a bad
step keeps every parameter and moment (bit for bit, in place) and
the count, and still advances `state.step`; on a good step it computes
what the unguarded step computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.ops import fused_xent
from skypilot_tpu_torch.parallel import context as cp_context
from skypilot_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class TrainState:
    """step: optimizer steps taken. params: the model's named f32
    parameters ({name: tensor}, the same tensors the model holds), or
    {'base': {...}, 'lora': {'layer_i': {target: {'a', 'b'}}}} for a
    LoRA finetune. opt_state: {'count', 'mu', 'nu'}, the moments listed
    in `trainable_leaves(params)` order."""
    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    #: Over a mesh, the trainer's parallel/fsdp.py layout: params are
    #: then FSDP2's sharded parameters and the moments this rank's
    #: pieces of them (parallel/checkpoints.py gathers whole leaves).
    layout: Any = None


def trainable_items(params: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """(name, tensor) of what the optimizer updates, in a fixed order:
    every parameter, or in LoRA mode every factor (layer, target,
    a/b)."""
    if 'lora' in params:
        return [(f'lora.{name}.{target}.{k}', factors[k])
                for name, layer in sorted(params['lora'].items(),
                                          key=_layer_key)
                for target, factors in sorted(layer.items())
                for k in ('a', 'b')]
    return list(params.items())


def trainable_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [t for _, t in trainable_items(params)]


def whole_lora(state: TrainState) -> Dict[str, Any]:
    """A LoRA state's factors {'layer_i': {target: {'a', 'b'}}}, whole
    (over a job every rank calls it: a tensor-sharded factor is gathered
    from its slices)."""
    if state.layout is None or not hasattr(state.layout, 'full'):
        return state.params['lora']
    whole = {id(t): state.layout.full(i, state.layout.local(t))
             for i, (_, t) in enumerate(trainable_items(state.params))}
    return {name: {target: {k: whole[id(t)] for k, t in factors.items()}
                   for target, factors in layer.items()}
            for name, layer in state.params['lora'].items()}


def _layer_key(item):
    return int(item[0].split('_')[1])


def token_losses(logits: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """(logsumexp - target logit) in f32 of each position of logits
    [B, T, V] against targets [B, T]."""
    logits = logits.float()
    target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - target_logit


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from logits[:, :-1], mean
    of (logsumexp - target logit) in f32."""
    return token_losses(logits[:, :-1], tokens[:, 1:]).mean()


def _f32(x) -> np.float32:
    return np.float32(x)


class WarmupCosineSchedule:
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps,
    end_value=0): linear from init to peak over `warmup` steps, then
    cosine decay to 0 over decay_steps - warmup, in f32."""

    def __init__(self, init_value: float, peak_value: float,
                 warmup_steps: int, decay_steps: int) -> None:
        self.init_value, self.peak_value = init_value, peak_value
        self.warmup_steps, self.decay_steps = warmup_steps, decay_steps

    def __call__(self, count: int) -> np.float32:
        if count < self.warmup_steps:
            frac = _f32(1) - _f32(count) / _f32(self.warmup_steps)
            return (_f32(self.init_value) - _f32(self.peak_value)) * frac \
                + _f32(self.peak_value)
        steps = self.decay_steps - self.warmup_steps
        t = _f32(min(count - self.warmup_steps, steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * t
                                                / _f32(steps)))
        return _f32(self.peak_value) * cosine


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps, weight_decay)) on a list of tensors, in place."""

    # The reference's adamw(b1=0.9, b2=0.95) with optax's default eps.
    b1, b2, eps = 0.9, 0.95, 1e-8
    #: Counts past the schedule's end that the table covers: lr is
    #: constant there, and 1 - b^c reaches 1.0 in f32 (b2 = 0.95 by
    #: c = 339), so a count past the table reads its last row exactly.
    TABLE_TAIL = 1024

    def __init__(self, learning_rate, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> None:
        self.learning_rate = learning_rate      # a float or a schedule
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else _f32(lr))

    def table(self, device: torch.device) -> torch.Tensor:
        """[n, 3] f32 on `device`: row c holds lr(c), 1 - b1^(c+1) and
        1 - b2^(c+1), the values a step at count c reads."""
        tab = self._tables.get(device)
        if tab is None:
            n = getattr(self.learning_rate, 'decay_steps', 0) \
                + self.TABLE_TAIL
            rows = [(self.lr(c),
                     _f32(1) - _f32(self.b1) ** _f32(c + 1),
                     _f32(1) - _f32(self.b2) ** _f32(c + 1))
                    for c in range(n)]
            tab = torch.tensor(rows, dtype=torch.float32, device=device)
            self._tables[device] = tab
        return tab

    def init(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        device = leaves[0].device if leaves else torch.device('cpu')
        return {'count': torch.zeros((), dtype=torch.int64, device=device),
                'mu': [torch.zeros_like(p) for p in leaves],
                'nu': [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any], norm: Optional[torch.Tensor] = None,
               bad: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on `leaves` (in place); returns the global grad norm
        (before clipping; computed here unless given), a device scalar.
        With `bad` (a device bool scalar) the step is guarded: where it
        is true every leaf, moment and the count keep their values."""
        grads = [g.float() for g in grads]
        if norm is None:
            norm = global_norm(grads)
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        # optax: g if |g| < max else (g / |g|) * max.
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * self.grad_clip)
        count = state['count']
        tab = self.table(count.device)
        # index_select, not tab[count]: indexing with a 0-dim tensor
        # would read it on the host.
        row = tab.index_select(0, count.clamp(max=tab.shape[0] - 1)
                               .reshape(1))
        lr, bc1, bc2 = row[0].unbind()
        neg_lr, b1, b2 = -lr, self.b1, self.b2
        if bad is not None:
            # A bad step leaves every leaf and moment as it was, bit for
            # bit, with no temporaries beyond the unguarded step's: its
            # gradients and updates become -0.0, the moments' decay
            # factors 1 and the step size +0.0, so each in-place op below
            # adds -0.0 (x + -0.0 is x for every x, signed zeros too).
            b1 = torch.where(bad, one, one * self.b1)
            b2 = torch.where(bad, one, one * self.b2)
            neg_lr = torch.where(bad, torch.zeros_like(lr), neg_lr)
        for p, g, mu, nu in zip(leaves, grads, state['mu'], state['nu']):
            g = g.div_(div).mul_(mul)
            if bad is not None:
                g.masked_fill_(bad, -0.0)
            mu.mul_(b1).add_(g, alpha=1 - self.b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - self.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            update.add_(p, alpha=self.weight_decay)
            if bad is not None:
                update.masked_fill_(bad, -0.0)
            p.addcmul_(update, neg_lr)
        count.add_(1 if bad is None else (~bad).long())
        return norm


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares, f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      grad_clip: float = 1.0,
                      warmup_steps: int = 0,
                      total_steps: Optional[int] = None) -> ClippedAdamW:
    if warmup_steps or total_steps:
        schedule = WarmupCosineSchedule(
            0.0, learning_rate, warmup_steps or 1,
            total_steps or (warmup_steps or 1) * 10)
    else:
        schedule = learning_rate
    return ClippedAdamW(schedule, weight_decay=weight_decay,
                        grad_clip=grad_clip)


class ShardedTrainer:
    """Train and eval steps for a port LM, on one device or over a mesh.

    The loss is `loss_fn(outputs, tokens)`, the next-token CE by default
    (Mixtral's `moe_next_token_loss` adds its router aux loss).
    `fused_xent` (None = auto: on when the loss is the CE or flagged
    `fused_ok`; every port model has a `return_hidden` forward) routes
    it through the blockwise LM-head cross-entropy (ops/fused_xent.py),
    adding the aux loss of a model whose forward returns (hidden, aux),
    as the reference's trainer does; False takes `loss_fn` over the full
    logits.
    `collect_grad_norm` makes the step return (loss, grad_norm). `lora`
    (models/lora.py LoraSpec) makes the run a LoRA finetune: params
    become {'base', 'lora'}, the base is frozen and only the factors
    train (and are what a checkpoint holds, with the step and the
    moments; see parallel/checkpoints.py). `guard` makes the guarded
    step (module doc; `train_lm --guard`), which needs the grad norm
    and so collects it.

    `mesh` (a DeviceMesh from parallel/mesh.py `make_mesh`, every rank
    of the job building its trainer alike) shards the model over the
    mesh's `fsdp` axis in place, Mixtral's experts over `expert`,
    heads / MLP / vocab over `tensor` (parallel/fsdp.py), and splits
    each row over `seq` (the loss then must be the next-token CE, with
    a router aux loss or not; so too over `tensor`, whose head is split
    by vocab). `devices` (a list of T devices, which may repeat) splits
    the model over T tensor shards in this process instead; `zero1`
    shards the Adam moments over `data` too, and `overlap` issues that
    reduce-scatter leaf by leaf during backward (it needs `zero1`, as in
    the reference). At `data` = 1 both change nothing.
    """

    def __init__(self, model, tx: Optional[ClippedAdamW] = None,
                 loss_fn: Optional[Callable] = None,
                 fused_xent: Optional[bool] = None,
                 collect_grad_norm: bool = False,
                 lora: Optional[lora_lib.LoraSpec] = None,
                 guard: bool = False, mesh=None, zero1: bool = False,
                 overlap: bool = False, devices=None) -> None:
        if not model.config.trainable:
            raise ValueError('the trainer needs f32 master parameters: '
                             'build the model with param_dtype='
                             'torch.float32 (registry.train_config)')
        self.model = model
        self.tx = tx if tx is not None else default_optimizer()
        self.lora = lora
        if lora is not None and not lora_lib.supports(model):
            raise ValueError(f'{type(model).__name__} has no LoRA forward '
                             f'path; --lora supports the Llama family')
        if overlap and not zero1:
            raise ValueError(
                'overlap=True buckets the grad reduce-scatter onto '
                'the ZeRO-1 moment layout; it needs zero1=True')
        self.zero1, self.overlap = zero1, overlap
        self.guard = guard
        self.collect_grad_norm = collect_grad_norm or guard
        self.loss_fn = loss_fn if loss_fn is not None else next_token_loss
        supported = (self.loss_fn is next_token_loss
                     or bool(getattr(self.loss_fn, 'fused_ok', False)))
        if fused_xent and not supported:
            raise ValueError('fused_xent=True but the loss_fn is not '
                             'next_token_loss (nor flagged fused_ok)')
        self.fused_xent = supported if fused_xent is None else fused_xent
        if mesh is not None and not supported and \
                mesh_lib.mesh_shape(mesh)['seq'] > 1:
            raise ValueError('a seq-sharded mesh takes the next-token loss '
                             '(with a router aux loss, flagged fused_ok); '
                             'this loss_fn needs whole logits')
        self.mesh = mesh
        self.layout = None
        #: (the tensor group seam, {shard: model}) under tensor
        #: parallelism (parallel/tensor.py), else None.
        self.tensor = None
        if mesh is not None and devices is not None:
            raise ValueError('pass mesh= (a job) or devices= (tensor '
                             'shards in process), not both')
        tensor_ways = (len(devices) if devices is not None else
                       mesh_lib.mesh_shape(mesh)['tensor'] if mesh is not None
                       else 1)
        if tensor_ways > 1 and not supported:
            raise ValueError('a tensor-sharded model takes the next-token '
                             'loss (with a router aux loss, flagged '
                             'fused_ok): its head is split by vocab')
        if mesh is not None:
            from skypilot_tpu_torch.parallel.fsdp import FSDPLayout
            if lora is not None:
                # Frozen before sharding: FSDP2 then reduces no base
                # gradient (there is none).
                for p in model.parameters():
                    p.requires_grad_(False)
            self.layout = FSDPLayout(model, mesh, self._loss, zero1=zero1,
                                     overlap=overlap)
            if self.layout.tensor_seam is not None:
                self.tensor = (self.layout.tensor_seam,
                               {self.layout.tensor_index: model})
        elif devices is not None:
            from skypilot_tpu_torch.parallel.tensor import LocalLayout
            if lora is not None:
                raise ValueError('LoRA under tensor shards in process is '
                                 'not supported; use a job (mesh=)')
            self.layout = LocalLayout(model, devices, self._loss)
            self.tensor = (self.layout.group, self.layout.shards)

    # -- init ---------------------------------------------------------------
    def init(self, lora_params: Optional[Dict[str, Any]] = None,
             seed: int = 0) -> TrainState:
        """The train state over the model's own parameters (the model is
        built already, so no example batch is needed), with zero
        moments. LoRA: fresh factors (a ~ N(0, 0.02) from `seed`, b = 0)
        unless `lora_params` are given; the base is frozen."""
        params: Dict[str, Any] = (
            self.layout.params() if hasattr(self.layout, 'params')
            else dict(self.model.named_parameters()))
        if self.lora is not None:
            for p in params.values():
                p.requires_grad_(False)
            if lora_params is None:
                lora_params = lora_lib.init_lora_params(
                    self.model.config, self.lora, seed=seed,
                    device=self.model.device)
                if self.layout is not None:
                    self.layout.shard_lora(lora_params)
            for layer in lora_params.values():
                for factors in layer.values():
                    for t in factors.values():
                        t.requires_grad_(True)
            params = {'base': params, 'lora': lora_params}
        if self.layout is None:
            return TrainState(step=0, params=params,
                              opt_state=self.tx.init(
                                  trainable_leaves(params)))
        items = trainable_items(params)
        leaves = [t for _, t in items]
        self.layout.bind(leaves, [n for n, _ in items])
        return TrainState(step=0, params=params,
                          opt_state=self.tx.init(self.layout.pieces(leaves)),
                          layout=self.layout)

    # -- step ---------------------------------------------------------------
    def _loss(self, params: Dict[str, Any],
              tokens: torch.Tensor) -> torch.Tensor:
        extra = {}
        if self.lora is not None:
            extra['lora'] = lora_lib.as_model_lora(params['lora'],
                                                   self.lora.scale)
        ring = cp_context.active_seq_group()
        if self.tensor is not None:
            return self._tensor_loss(params, tokens, ring)
        if ring is not None:
            return self._block_loss(tokens, ring, extra)
        if self.fused_xent:
            out = self.model(tokens, return_hidden=True, **extra)
            aux = None
            if isinstance(out, tuple):
                out, aux = out
            head, vocab_in_rows = fused_xent.find_lm_head(
                dict(self.model.named_parameters()))
            loss = fused_xent.fused_next_token_loss(
                out, head, tokens, vocab_in_rows=vocab_in_rows)
            return loss if aux is None else loss + aux
        return self.loss_fn(self.model(tokens, **extra), tokens)

    def _block_loss(self, tokens: torch.Tensor, ring,
                    extra: Dict[str, Any]) -> torch.Tensor:
        """This seq rank's part of the loss of whole rows `tokens`
        [B, S]: its block [r*Sl, (r+1)*Sl) runs at its global positions
        and predicts the tokens after it (the last block has one target
        fewer); the sum of its token losses is divided by the global
        count B * (S - 1), so the seq ranks' parts sum to
        `next_token_loss` of the rows. A router aux loss (computed with
        the whole sequence's fractions and this block's probabilities)
        is divided by the ring's size, so its parts sum to the rows'."""
        batch, seq = tokens.shape
        if seq % ring.size:
            raise ValueError(f'sequence length {seq} does not split over '
                             f'seq = {ring.size} ranks')
        width = seq // ring.size
        lo = ring.index * width
        block = tokens[:, lo:lo + width]
        targets = tokens[:, lo + 1:lo + width + 1]
        positions = torch.arange(lo, lo + width, dtype=torch.int32,
                                 device=tokens.device).expand(batch, width)
        out = self.model(block, positions=positions,
                         return_hidden=self.fused_xent, **extra)
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        out = out[:, :targets.shape[1]]
        if self.fused_xent:
            head, vocab_in_rows = fused_xent.find_lm_head(
                dict(self.model.named_parameters()))
            losses = fused_xent.fused_token_losses(
                out, head, targets, vocab_in_rows=vocab_in_rows)
        else:
            losses = token_losses(out, targets)
        loss = losses.sum() / (batch * (seq - 1))
        return loss if aux is None else loss + aux / ring.size

    def _tensor_loss(self, params: Dict[str, Any], tokens: torch.Tensor,
                     ring) -> torch.Tensor:
        """The loss of rows `tokens` over tensor shards (parallel/tensor.py
        `hidden`, the vocab-split head of ops/fused_xent.py): the mean
        next-token loss, or under an active ring this seq rank's block's
        share of it (`_block_loss`), plus a router aux loss."""
        from skypilot_tpu_torch.parallel import tensor as tensor_lib
        group, shards = self.tensor
        cfg = self.model.config
        batch, seq = tokens.shape
        positions, block, targets = None, tokens, tokens[:, 1:]
        if ring is not None:
            if seq % ring.size:
                raise ValueError(f'sequence length {seq} does not split '
                                 f'over seq = {ring.size} ranks')
            width = seq // ring.size
            lo = ring.index * width
            block = tokens[:, lo:lo + width]
            targets = tokens[:, lo + 1:lo + width + 1]
            positions = torch.arange(lo, lo + width, dtype=torch.int32,
                                     device=tokens.device).expand(batch,
                                                                  width)
        lora = None
        if self.lora is not None:
            lora = {group.index: params['lora']}
        moe = hasattr(cfg, 'router_aux_loss_weight')
        out = tensor_lib.hidden(
            shards, group, block, positions, lora,
            self.lora.scale if self.lora is not None else 1.0,
            with_aux=moe)
        hidden, aux = out if moe else (out, None)
        hidden = hidden[:, :targets.shape[1]]
        _, _, head, _ = tensor_lib.edges(self.model)
        losses = fused_xent.split_vocab_token_losses(
            hidden.reshape(-1, hidden.shape[-1]).to(cfg.dtype),
            targets.reshape(-1), {t: getattr(m, head)
                                  for t, m in shards.items()},
            group, cfg.vocab_size, block='auto')
        if ring is None:
            loss = losses.mean()
        else:
            loss = losses.sum() / (batch * (seq - 1))
        if aux is not None:
            aux = cfg.router_aux_loss_weight * aux / cfg.num_layers
            loss = loss + (aux if ring is None else aux / ring.size)
        return loss

    def _compute_loss(self, params: Dict[str, Any],
                      tokens: torch.Tensor) -> torch.Tensor:
        """The loss of `tokens` (over a mesh: this rank's rows, through
        the root FSDP unit)."""
        if self.layout is None:
            return self._loss(params, tokens)
        return self.layout.unit(params, tokens)

    def make_train_step(self) -> Callable:
        """Unguarded: `(state, tokens) -> (state, aux)`, aux the loss (a
        device scalar) or (loss, grad_norm) with `collect_grad_norm`.
        With `guard`: `(state, tokens, max_grad_norm=inf, loss_scale=1.0)
        -> (state, (loss, gnorm, bad))`, three device scalars; the scale
        multiplies the loss inside autograd, so a NaN scale poisons the
        loss and every gradient. Both update `state` in place and return
        it."""
        if self.layout is not None:
            return self._make_sharded_step()

        def step(state: TrainState, tokens: torch.Tensor):
            leaves = trainable_leaves(state.params)
            loss = self._compute_loss(state.params, tokens)
            grads = torch.autograd.grad(loss, leaves)
            gnorm = self.tx.update(leaves, list(grads), state.opt_state)
            state.step += 1
            loss = loss.detach()
            return state, ((loss, gnorm) if self.collect_grad_norm
                           else loss)

        def guarded(state: TrainState, tokens: torch.Tensor,
                    max_grad_norm: float = math.inf,
                    loss_scale: float = 1.0):
            leaves = trainable_leaves(state.params)
            loss = self._compute_loss(state.params, tokens) * loss_scale
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            gnorm = global_norm(grads)
            # Non-finite loss or norm, or a spike past the host's ceiling:
            # the update never happens, but the batch is consumed.
            bad = (~torch.isfinite(loss) | ~torch.isfinite(gnorm)
                   | (gnorm > max_grad_norm))
            self.tx.update(leaves, list(grads), state.opt_state,
                           norm=gnorm, bad=bad)
            state.step += 1
            return state, (loss, gnorm, bad)

        return guarded if self.guard else step

    def _make_sharded_step(self) -> Callable:
        """The step over a mesh: backward through FSDP2, this rank's
        gradient pieces reduced over the job, the job-wide loss and norm
        (so every rank computes the same `bad`), the update on this
        rank's pieces and, under zero1, the pieces gathered back."""
        layout = self.layout

        def run(state, tokens, max_grad_norm, loss_scale, guarded):
            leaves = trainable_leaves(state.params)
            loss = self._compute_loss(state.params, tokens)
            if guarded:
                loss = loss * loss_scale
            loss.backward()
            grads = layout.reduce_grads(leaves)
            gnorm = torch.sqrt(layout.global_sq(grads))
            loss = layout.mean(loss)
            bad = None
            if guarded:
                bad = (~torch.isfinite(loss) | ~torch.isfinite(gnorm)
                       | (gnorm > max_grad_norm))
            self.tx.update(layout.pieces(leaves), grads, state.opt_state,
                           norm=gnorm, bad=bad)
            layout.gather_updates(leaves)
            state.step += 1
            if guarded:
                return state, (loss, gnorm, bad)
            return state, ((loss, gnorm) if self.collect_grad_norm
                           else loss)

        def step(state: TrainState, tokens: torch.Tensor):
            with cp_context.context_parallel(self.mesh):
                return run(state, tokens, None, None, False)

        def guarded(state: TrainState, tokens: torch.Tensor,
                    max_grad_norm: float = math.inf,
                    loss_scale: float = 1.0):
            with cp_context.context_parallel(self.mesh):
                return run(state, tokens, max_grad_norm, loss_scale, True)

        return guarded if self.guard else step

    def make_eval_step(self) -> Callable:

        @torch.no_grad()
        def evaluate(state: TrainState, tokens: torch.Tensor
                     ) -> torch.Tensor:
            with cp_context.context_parallel(self.mesh):
                loss = self._compute_loss(state.params, tokens)
            return loss if self.layout is None else self.layout.mean(loss)

        return evaluate


class HostScalars:
    """Device scalars on their way to the host, fetched without waiting
    for work queued after them.

    `float(t)` on a CUDA tensor is a copy ordered on the stream, so read
    after step N+1 is queued it waits for N+1 too, and the card idles
    while the host then dispatches N+2. Here the values are copied into
    a pinned host buffer right after they are queued (`non_blocking`),
    an event marks the copy, and `values()` waits for that event only:
    the guarded loop's lagged observation of step N overlaps step N+1.
    On the CPU the values are read as they are."""

    def __init__(self, *scalars: torch.Tensor) -> None:
        vals = torch.stack([s.detach().float().reshape(()) for s in scalars])
        self._event = None
        if vals.is_cuda:
            self._host = torch.empty(vals.shape, dtype=torch.float32,
                                     pin_memory=True)
            self._host.copy_(vals, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = vals

    def values(self) -> List[float]:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()
