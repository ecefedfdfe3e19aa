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
saves), so there is nothing to wait for or close. `restore()` verifies
the candidate step against its manifest and falls back to the newest
step that verifies; failures are typed (`CheckpointNotFoundError`,
`CheckpointCorruptionError`). `max_to_keep` prunes the oldest steps and
their manifests. Remote (gs://, s3://) directories are refused.

What a step holds: the step count, the trainable parameters and the
optimizer state. A LoRA finetune's frozen base is not written (the
reference writes it, 16 GB in bf16 or 32 GB in f32 at Llama-3-8B): it
is rebuilt from its source, the seeded init, when the run relaunches,
and the checkpoint records that source's description so a relaunch on
another base is refused.
"""
from __future__ import annotations

import os
import shutil
import sys
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch.errors import (CheckpointCorruptionError,
                                       CheckpointNotFoundError)
from skypilot_tpu_torch.parallel import ckpt_integrity
from skypilot_tpu_torch.parallel.train import TrainState, trainable_leaves

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
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.base_source = base_source
        #: Step the last `restore()` actually read (after any integrity
        #: fallback).
        self.last_restored_step: Optional[int] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    # -- listing -------------------------------------------------------------
    def all_steps(self) -> List[int]:
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
        if os.path.isdir(self._step_dir(step)):
            return False
        if not force and step % self.save_interval_steps:
            return False
        payload = {
            'step': int(state.step),
            'lora': 'lora' in state.params,
            'base_source': self.base_source,
            'params': _to_cpu(state.params['lora'] if 'lora' in state.params
                              else state.params),
            'opt_state': {'count': int(state.opt_state['count']),
                          'mu': _to_cpu(state.opt_state['mu']),
                          'nu': _to_cpu(state.opt_state['nu'])},
        }
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
        return True

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        ckpt_integrity.prune_manifests(self.ckpt_dir, self.all_steps())

    # -- restore ---------------------------------------------------------------
    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy a checkpoint into the template's tensors (in place) and
        return the template, with integrity fallback: the requested
        step (default: newest) is verified first; a corrupt step is
        logged and skipped for the next-newest that verifies. Raises
        CheckpointNotFoundError when there is nothing to restore and
        CheckpointCorruptionError when every candidate is corrupt."""
        candidate = self._verified_step(step)
        self._load_into(state_template, candidate)
        self.last_restored_step = candidate
        return state_template

    def restore_params(self, step: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """The parameters ({name: f32 CPU tensor}) of a full-parameter
        step, with `restore`'s integrity fallback and no optimizer
        template: what serving (`serve_lm --ckpt-dir`) needs."""
        candidate = self._verified_step(step)
        payload = torch.load(os.path.join(self._step_dir(candidate),
                                          STATE_FILE),
                             map_location='cpu', weights_only=True)
        if payload['lora']:
            raise ValueError(
                f'checkpoint step {candidate} in {self.ckpt_dir} holds '
                f'LoRA factors, not full parameters; serve its adapter '
                f'artifact with --adapter-dir')
        self.last_restored_step = candidate
        return payload['params']

    def _verified_step(self, step: Optional[int]) -> int:
        """The step to read: `step` (default: newest) or, past corrupt
        ones, the next-newest that verifies."""
        steps = sorted(self.all_steps(), reverse=True)
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

    def _load_into(self, state: TrainState, step: int) -> None:
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location='cpu', weights_only=True)
        lora = 'lora' in state.params
        if payload['lora'] != lora:
            raise ValueError(f'checkpoint step {step} was written by a '
                             f'{"LoRA" if payload["lora"] else "full"} run; '
                             f'this run is {"LoRA" if lora else "full"}')
        if lora and payload['base_source'] != self.base_source:
            raise ValueError(f'checkpoint step {step} trained LoRA factors '
                             f'over base {payload["base_source"]!r}; this '
                             f'run\'s base is {self.base_source!r}')
        params = state.params['lora'] if lora else state.params
        _copy_into(params, payload['params'], f'step {step} params')
        opt = state.opt_state
        for key in ('mu', 'nu'):
            _copy_into(opt[key], payload['opt_state'][key],
                       f'step {step} {key}')
        opt['count'] = int(payload['opt_state']['count'])
        state.step = int(payload['step'])
        if len(opt['mu']) != len(trainable_leaves(state.params)):
            raise ValueError(f'checkpoint step {step}: optimizer state does '
                             f'not match the trainable parameters')


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
