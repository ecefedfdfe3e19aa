"""Checkpoint manager for the port's TrainState (port of
skypilot_tpu/parallel/checkpoints.py).

The format is torch-native (`torch.save`; the card has neither orbax
nor safetensors) and the DIRECTORY CONTRACT is the reference's, so the
managed-jobs controller's `ckpt_integrity.preflight`
(jobs/recovery_strategy.py) reads port checkpoints unchanged:

    <ckpt_dir>/<step>/state.pt      one finalized step directory
    <ckpt_dir>/manifest-<step>.json sha256 of every file in it

A step is written into a temporary directory, fsynced and renamed into
place, so a step directory that exists is complete; its manifest
follows. Saves are synchronous (the reference's are async orbax
saves): `wait_until_finished()` and `close()` return at once, kept so
the train loop reads as the reference's. `restore()` verifies
the candidate step against its manifest and falls back to the newest
step that verifies; failures are typed (`CheckpointNotFoundError`,
`CheckpointCorruptionError`; each corrupt step counts in
`skypilot_checkpoint_integrity_failures_total`). `max_to_keep` prunes
the oldest steps and their manifests. The `checkpoint.save` and
`checkpoint.restore` fault points fire before a save and a restore, as
the reference's do. Remote (gs://, s3://) directories are refused.

A pipelined state (parallel/pipeline.py, its own layout) saves and
restores the same way, collectively: each leaf is gathered from the
stage that holds it (table shards joined, padding dropped; a block
leaf's tensor and expert slices joined first) and rank 0 writes the
one-card file; a restore hands each stage its pieces.

Over a job (a state with a parallel/fsdp.py layout) saving and
restoring are collective: every rank calls them at the same step. A
save gathers one whole leaf at a time on every rank (rank 0 moves each
to the host at once, so no card holds more than one whole leaf beside
its shards), rank 0 alone writes the directory above and the others
wait for it; a step written at any world size is, byte for byte, the
file a one-card run of the same state writes. A restore is read by
rank 0, which broadcasts each whole leaf;
each rank keeps its part (its tensor and expert slice, its FSDP shard
of that, and its moment pieces under zero1), so a run resumes at
another world size, under another `--tensor`, and with `--zero1`
toggled. Rank 0 alone lists, verifies and prunes the directory and its
answers (and errors) reach every rank.

What a step holds: the step count, the trainable parameters and the
optimizer state. A LoRA finetune's frozen base is not written (the
reference writes it, 16 GB in bf16 or 32 GB in f32 at Llama-3-8B): it
is rebuilt from its source, the seeded init, when the run relaunches,
and the checkpoint records that source's description so a relaunch on
another base is refused.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch.errors import (CheckpointCorruptionError,
                                       CheckpointNotFoundError)
from skypilot_tpu_torch.observability import catalog
from skypilot_tpu_torch.parallel import ckpt_integrity, distributed
from skypilot_tpu_torch.parallel.train import (TrainState, trainable_items,
                                               trainable_leaves)
from skypilot_tpu_torch.robustness import faults

STATE_FILE = 'state.pt'


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class CheckpointManager:

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 base_source: Optional[str] = None) -> None:
        """`base_source` describes where a LoRA run's frozen base comes
        from (e.g. 'seeded init of llama3-8b'); restore refuses a step
        written over another base."""
        if ckpt_dir.startswith(('gs://', 's3://')):
            raise ValueError(f'checkpoint dir {ckpt_dir}: remote '
                             f'(gs://, s3://) checkpoint dirs are not '
                             f'ported yet (ROADMAP A11); use a local path')
        self.ckpt_dir = os.path.abspath(os.path.expanduser(ckpt_dir))
        self._main = distributed.rank() == 0
        if self._main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.base_source = base_source
        #: Step the last `restore()` actually read (after any integrity
        #: fallback).
        self.last_restored_step: Optional[int] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def _on_main(self, fn):
        """fn() on rank 0, its value (or its exception) on every rank."""
        value = err = shared = None
        if self._main:
            try:
                value = fn()
            except Exception as e:  # pylint: disable=broad-except
                err = shared = e
                try:
                    pickle.dumps(e)
                except Exception:  # pylint: disable=broad-except
                    shared = RuntimeError(f'rank 0: {e!r}')
        value, shared = distributed.broadcast((value, shared))
        if err is not None:
            raise err
        if shared is not None:
            raise shared
        return value

    # -- listing -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return self._on_main(self._list_steps)

    def _list_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.ckpt_dir):
            if name.isdigit() and os.path.isdir(os.path.join(self.ckpt_dir,
                                                             name)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> bool:
        """True = manifest verified; False = no manifest; raises
        CheckpointCorruptionError on a mismatch."""
        return ckpt_integrity.verify_step(self.ckpt_dir, step,
                                          self._step_dir(step))

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Write `state` as step `step`; returns whether it was written.
        A step that exists, or (without `force`) one off the save
        interval, is skipped."""
        faults.point('checkpoint.save')   # chaos: lost or failed saves
        def due() -> bool:
            return not os.path.isdir(self._step_dir(step)) and (
                force or not step % self.save_interval_steps)

        if not self._on_main(due):
            return False
        payload = self._payload(state)
        self._on_main(lambda: self._write(step, payload))
        return True

    def _payload(self, state: TrainState) -> Optional[Dict[str, Any]]:
        """What a step holds, as CPU tensors (None off rank 0). Over a
        job every rank gathers one whole leaf at a time (a parameter,
        then its mu, then its nu); rank 0 copies each to the host at
        once and the others drop it, so a card holds its shards and at
        most one whole leaf."""
        layout = state.layout
        if getattr(layout, 'pipelined', False):
            return self._pipeline_payload(state)
        lora = 'lora' in state.params
        params = state.params['lora'] if lora else state.params
        opt = state.opt_state
        if layout is None:
            params, mu, nu = (_to_cpu(params), _to_cpu(opt['mu']),
                              _to_cpu(opt['nu']))
        else:
            def fetch(i: int, local: torch.Tensor, moment: bool = False):
                whole = layout.full(i, local, moment=moment)
                return _to_cpu(whole) if self._main else None

            host, mu, nu = {}, [], []
            for i, (_, t) in enumerate(trainable_items(state.params)):
                host[id(t)] = fetch(i, layout.local(t))
                mu.append(fetch(i, opt['mu'][i], moment=True))
                nu.append(fetch(i, opt['nu'][i], moment=True))
            if not self._main:
                return None
            params = _map_tree(params, lambda t: host[id(t)])
        return {
            'step': int(state.step),
            'lora': lora,
            'base_source': self.base_source,
            'params': params,
            'opt_state': {'count': int(opt['count']), 'mu': mu, 'nu': nu},
        }

    def _pipeline_payload(self, state: TrainState
                          ) -> Optional[Dict[str, Any]]:
        """A pipelined state's step (parallel/pipeline.py): every leaf
        gathered whole from its stage, a parameter and then its
        moments, in the model's order; rank 0 gets the payload a
        one-card run of the same state writes."""
        layout = state.layout
        params, mu, nu = {}, [], []
        for i, name in enumerate(layout.names):
            params[name] = layout.gather_leaf(state, i, 'param')
            mu.append(layout.gather_leaf(state, i, 'mu'))
            nu.append(layout.gather_leaf(state, i, 'nu'))
        if not self._main:
            return None
        return {'step': int(state.step), 'lora': False,
                'base_source': self.base_source, 'params': params,
                'opt_state': {'count': layout.count(state), 'mu': mu,
                              'nu': nu}}

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = os.path.join(self.ckpt_dir, f'.tmp-{step}-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._step_dir(step))
        ckpt_integrity.write_manifest(self.ckpt_dir, step,
                                      self._step_dir(step))
        self._prune()

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release: no background saver."""

    def _prune(self) -> None:
        steps = self._list_steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        ckpt_integrity.prune_manifests(self.ckpt_dir, self._list_steps())

    # -- restore ---------------------------------------------------------------
    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy a checkpoint into the template's tensors (in place) and
        return the template, with integrity fallback: the requested
        step (default: newest) is verified first; a corrupt step is
        logged and skipped for the next-newest that verifies. Raises
        CheckpointNotFoundError when there is nothing to restore and
        CheckpointCorruptionError when every candidate is corrupt."""
        if getattr(state_template.layout, 'pipelined', False):
            return self._restore_pipelined(state_template, step)
        if state_template.layout is not None:
            return self._restore_sharded(state_template, step)
        candidate = self._verified_step(step)
        self._load_into(state_template, candidate)
        self.last_restored_step = candidate
        return state_template

    def _restore_sharded(self, state: TrainState,
                         step: Optional[int]) -> TrainState:
        """Rank 0 reads and checks the step; each whole leaf is
        broadcast and every rank keeps its part."""
        layout = state.layout
        items = trainable_items(state.params)
        loaded: Dict[str, Any] = {}

        def read():
            candidate = self._verified_step(step)
            payload = self._read(candidate)
            self._check(payload, state, candidate,
                        [leaf.shape for leaf in layout.leaves])
            loaded['payload'] = payload
            return (candidate, int(payload['step']),
                    int(payload['opt_state']['count']))

        candidate, at, count = self._on_main(read)
        payload = loaded.get('payload')
        leaves = (_leaves_of(payload['params'])
                  if payload is not None else None)
        opt = state.opt_state
        for i, (_, t) in enumerate(items):
            for key, local, moment in ((None, layout.local(t), False),
                                       ('mu', opt['mu'][i], True),
                                       ('nu', opt['nu'][i], True)):
                whole = None
                if payload is not None:
                    whole = (leaves[i] if key is None
                             else payload['opt_state'][key][i])
                layout.load(i, local, _broadcast_leaf(
                    whole, layout.leaves[i].shape, local), moment=moment)
        opt['count'].fill_(count)
        state.step = at
        self.last_restored_step = candidate
        return state

    def _restore_pipelined(self, state: TrainState,
                           step: Optional[int]) -> TrainState:
        """Rank 0 reads and checks the step; each whole leaf is
        broadcast and every stage keeps its piece of it."""
        layout = state.layout
        loaded: Dict[str, Any] = {}

        def read():
            candidate = self._verified_step(step)
            payload = self._read(candidate)
            got = payload['params']
            if payload['lora'] or list(got) != layout.names or any(
                    tuple(got[n].shape) != layout.shapes[n] for n in got):
                raise ValueError(f'checkpoint step {candidate}: structure '
                                 f'does not match the pipelined model')
            loaded['payload'] = payload
            return (candidate, int(payload['step']),
                    int(payload['opt_state']['count']))

        candidate, at, count = self._on_main(read)
        payload = loaded.get('payload')
        for i, name in enumerate(layout.names):
            for what in ('param', 'mu', 'nu'):
                whole = None
                if payload is not None:
                    whole = (payload['params'][name] if what == 'param'
                             else payload['opt_state'][what][i])
                layout.load_leaf(state, i, what, whole)
        layout.set_count(state, count)
        state.step = at
        self.last_restored_step = candidate
        return state

    def restore_params(self, step: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """The parameters ({name: f32 CPU tensor}) of a full-parameter
        step, with `restore`'s integrity fallback and no optimizer
        template: what serving (`serve_lm --ckpt-dir`) needs."""
        candidate = self._verified_step(step)
        payload = self._read(candidate)
        if payload['lora']:
            raise ValueError(
                f'checkpoint step {candidate} in {self.ckpt_dir} holds '
                f'LoRA factors, not full parameters; serve its adapter '
                f'artifact with --adapter-dir')
        self.last_restored_step = candidate
        return payload['params']

    def _read(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location='cpu', weights_only=True)

    def _verified_step(self, step: Optional[int]) -> int:
        """The step to read: `step` (default: newest) or, past corrupt
        ones, the next-newest that verifies."""
        faults.point('checkpoint.restore')   # chaos: unreadable storage
        steps = sorted(self._list_steps(), reverse=True)
        candidates = steps if step is None else \
            [step] + [s for s in steps if s < step]
        if not candidates or (step is not None and step not in steps):
            raise CheckpointNotFoundError(
                f'no checkpoint to restore in {self.ckpt_dir}'
                + (f' at step {step}' if step is not None else ''))
        corrupt: List[int] = []
        for candidate in candidates:
            try:
                verified = self.verify_step(candidate)
            except CheckpointCorruptionError as e:
                catalog.counter(
                    'skypilot_checkpoint_integrity_failures_total').inc()
                _log(f'checkpoint step {candidate} failed integrity '
                     f'verification ({e}); falling back to the previous '
                     f'step.')
                corrupt.append(candidate)
                continue
            if not verified:
                _log(f'checkpoint step {candidate} has no integrity '
                     f'manifest; restoring unverified.')
            if corrupt:
                _log(f'checkpoint restore: fell back from corrupt step(s) '
                     f'{corrupt} to step {candidate}.')
            return candidate
        raise CheckpointCorruptionError(
            f'every restore candidate failed integrity verification '
            f'(steps {corrupt}) in {self.ckpt_dir}: no uncorrupted '
            f'checkpoint left to fall back to')

    def _check(self, payload: Dict[str, Any], state: TrainState, step: int,
               shapes: Optional[List[tuple]] = None) -> None:
        lora = 'lora' in state.params
        if payload['lora'] != lora:
            raise ValueError(f'checkpoint step {step} was written by a '
                             f'{"LoRA" if payload["lora"] else "full"} run; '
                             f'this run is {"LoRA" if lora else "full"}')
        if lora and payload['base_source'] != self.base_source:
            raise ValueError(f'checkpoint step {step} trained LoRA factors '
                             f'over base {payload["base_source"]!r}; this '
                             f'run\'s base is {self.base_source!r}')
        if shapes is None:
            return
        names = [n for n, _ in trainable_items(state.params)]
        got = _leaves_of(payload['params'])
        opt = payload['opt_state']
        if len(got) != len(names) or any(
                len(opt[k]) != len(names) for k in ('mu', 'nu')):
            raise ValueError(f'checkpoint step {step}: structure does not '
                             f'match')
        for name, shape, *tensors in zip(names, shapes, got, opt['mu'],
                                         opt['nu']):
            for t in tensors:
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(
                        f'checkpoint step {step} {name}: shape mismatch '
                        f'{tuple(t.shape)} vs {tuple(shape)}')

    def _load_into(self, state: TrainState, step: int) -> None:
        payload = self._read(step)
        lora = 'lora' in state.params
        self._check(payload, state, step)
        params = state.params['lora'] if lora else state.params
        _copy_into(params, payload['params'], f'step {step} params')
        opt = state.opt_state
        for key in ('mu', 'nu'):
            _copy_into(opt[key], payload['opt_state'][key],
                       f'step {step} {key}')
        opt['count'].fill_(int(payload['opt_state']['count']))
        state.step = int(payload['step'])
        if len(opt['mu']) != len(trainable_leaves(state.params)):
            raise ValueError(f'checkpoint step {step}: optimizer state does '
                             f'not match the trainable parameters')


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _leaves_of(params: Dict[str, Any]) -> List[torch.Tensor]:
    """A payload's parameter tensors in `trainable_items` order."""
    if params and isinstance(next(iter(params.values())), dict):
        return trainable_leaves({'lora': params})
    return list(params.values())


def _broadcast_leaf(whole: Optional[torch.Tensor], shape, like: torch.Tensor
                    ) -> torch.Tensor:
    """Rank 0's whole leaf on every rank, on `like`'s device (the
    default group's collective: the card's under NCCL)."""
    import torch.distributed as dist
    if whole is not None:
        buf = whole.to(device=like.device, dtype=like.dtype).contiguous()
    else:
        buf = torch.empty(shape, dtype=like.dtype, device=like.device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(buf, src=0)
    return buf


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return [_to_cpu(v) for v in tree]


@torch.no_grad()
def _copy_into(dst, src, where: str) -> None:
    """Copy a loaded tree into the same-shaped tree of live tensors."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f'checkpoint {where}: shape mismatch '
                             f'{getattr(src, "shape", None)} vs '
                             f'{tuple(dst.shape)}')
        dst.copy_(src)
        return
    keys = dst.keys() if isinstance(dst, dict) else range(len(dst))
    if (isinstance(dst, dict) and set(dst) != set(src)) or \
            (not isinstance(dst, dict) and len(dst) != len(src)):
        raise ValueError(f'checkpoint {where}: structure does not match')
    for k in keys:
        _copy_into(dst[k], src[k], f'{where}/{k}')
