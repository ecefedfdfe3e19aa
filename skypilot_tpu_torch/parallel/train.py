"""Training harness on one device (port of skypilot_tpu/parallel/train.py:
`TrainState`, `next_token_loss`, `default_optimizer`, `ShardedTrainer`).

The reference jits its step over a mesh; the port runs one card eagerly,
so `ShardedTrainer` keeps the reference's API (`init`,
`make_train_step`, `make_eval_step`, `fused_xent` auto,
`collect_grad_norm`, `lora=`) without the mesh. Parameters are the
model's own f32 master tensors (`LlamaConfig.param_dtype`), and the
optimizer updates them and its moments IN PLACE: JAX returns new arrays,
the port saves a copy of every parameter and moment that way.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.ops import fused_xent


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


def trainable_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors the optimizer updates, in a fixed order: every
    parameter, or in LoRA mode every factor (layer, target, a/b)."""
    if 'lora' in params:
        return [factors[k] for _, layer in sorted(params['lora'].items(),
                                                  key=_layer_key)
                for _, factors in sorted(layer.items())
                for k in ('a', 'b')]
    return list(params.values())


def _layer_key(item):
    return int(item[0].split('_')[1])


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from logits[:, :-1], mean
    of (logsumexp - target logit) in f32."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - target_logit).mean()


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

    def __init__(self, learning_rate, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> None:
        self.learning_rate = learning_rate      # a float or a schedule
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else _f32(lr))

    def init(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        return {'count': 0,
                'mu': [torch.zeros_like(p) for p in leaves],
                'nu': [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """One step on `leaves` (in place); returns the global grad norm
        (before clipping), a device scalar."""
        grads = [g.float() for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        # optax: g if |g| < max else (g / |g|) * max.
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * self.grad_clip)
        count = state['count']
        count_inc = count + 1
        bc1 = float(_f32(1) - _f32(self.b1) ** _f32(count_inc))
        bc2 = float(_f32(1) - _f32(self.b2) ** _f32(count_inc))
        lr = self.lr(count)
        for p, g, mu, nu in zip(leaves, grads, state['mu'], state['nu']):
            g = g.div_(div).mul_(mul)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        state['count'] = count_inc
        return norm


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
    """Train and eval steps for a port LM on one device.

    The loss is the next-token CE. `fused_xent` (None = auto, which is
    on: the port's Llama has a `return_hidden` forward) routes it
    through the blockwise LM-head cross-entropy (ops/fused_xent.py);
    False takes `next_token_loss` over the full logits.
    `collect_grad_norm` makes the step return (loss, grad_norm). `lora`
    (models/lora.py LoraSpec) makes the run a LoRA finetune: params
    become {'base', 'lora'}, the base is frozen and only the factors
    train (and are what a checkpoint holds, with the step and the
    moments; see parallel/checkpoints.py).
    """

    def __init__(self, model, tx: Optional[ClippedAdamW] = None,
                 fused_xent: Optional[bool] = None,
                 collect_grad_norm: bool = False,
                 lora: Optional[lora_lib.LoraSpec] = None) -> None:
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
        self.collect_grad_norm = collect_grad_norm
        self.fused_xent = fused_xent is not False

    # -- init ---------------------------------------------------------------
    def init(self, lora_params: Optional[Dict[str, Any]] = None,
             seed: int = 0) -> TrainState:
        """The train state over the model's own parameters (the model is
        built already, so no example batch is needed), with zero
        moments. LoRA: fresh factors (a ~ N(0, 0.02) from `seed`, b = 0)
        unless `lora_params` are given; the base is frozen."""
        params: Dict[str, Any] = dict(self.model.named_parameters())
        if self.lora is not None:
            for p in params.values():
                p.requires_grad_(False)
            if lora_params is None:
                lora_params = lora_lib.init_lora_params(
                    self.model.config, self.lora, seed=seed,
                    device=self.model.device)
            for layer in lora_params.values():
                for factors in layer.values():
                    for t in factors.values():
                        t.requires_grad_(True)
            params = {'base': params, 'lora': lora_params}
        return TrainState(step=0, params=params,
                          opt_state=self.tx.init(trainable_leaves(params)))

    # -- step ---------------------------------------------------------------
    def _compute_loss(self, params: Dict[str, Any],
                      tokens: torch.Tensor) -> torch.Tensor:
        extra = {}
        if self.lora is not None:
            extra['lora'] = lora_lib.as_model_lora(params['lora'],
                                                   self.lora.scale)
        if self.fused_xent:
            hidden = self.model(tokens, return_hidden=True, **extra)
            head, vocab_in_rows = fused_xent.find_lm_head(
                dict(self.model.named_parameters()))
            return fused_xent.fused_next_token_loss(
                hidden, head, tokens, vocab_in_rows=vocab_in_rows)
        return next_token_loss(self.model(tokens, **extra), tokens)

    def make_train_step(self) -> Callable:
        """`(state, tokens) -> (state, aux)`, aux the loss (a device
        scalar) or (loss, grad_norm) with `collect_grad_norm`. Updates
        `state` in place and returns it."""

        def step(state: TrainState, tokens: torch.Tensor):
            leaves = trainable_leaves(state.params)
            loss = self._compute_loss(state.params, tokens)
            grads = torch.autograd.grad(loss, leaves)
            gnorm = self.tx.update(leaves, list(grads), state.opt_state)
            state.step += 1
            loss = loss.detach()
            return state, ((loss, gnorm) if self.collect_grad_norm
                           else loss)

        return step

    def make_eval_step(self) -> Callable:

        @torch.no_grad()
        def evaluate(state: TrainState, tokens: torch.Tensor
                     ) -> torch.Tensor:
            return self._compute_loss(state.params, tokens)

        return evaluate
