"""Checkpoint integrity manifests: sha256 per file, stdlib only (the
port's copy of skypilot_tpu/parallel/ckpt_integrity.py, raising the
port's error type; tests/test_torch_train.py pins the two together).

One manifest JSON per finalized checkpoint step, written NEXT TO the
step directory (never inside it — the checkpoint manager owns the step
dir layout):

    <ckpt_dir>/manifest-<step>.json
    {"step": N, "files": {"<relpath>": "<sha256>", ...},
     "total_bytes": B}

`parallel/checkpoints.py` writes one after each step finalizes and
verifies it before restoring; a mismatch (torn write, truncated
upload, bit rot) raises `CheckpointCorruptionError` and the manager
falls back to the newest step that verifies. This module is
deliberately dependency-free (os/json/hashlib) so the managed-jobs
controller can preflight a checkpoint directory before relaunching a
job without importing a framework into the control plane.

Manifests are themselves written atomically (temp file + fsync +
rename): a crash mid-manifest-write leaves the step unverified
(legacy semantics, restore logs and accepts) rather than falsely
corrupt.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.errors import CheckpointCorruptionError

_MANIFEST_RE = re.compile(r'^manifest-(\d+)\.json$')


def manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f'manifest-{step}.json')


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            digest.update(chunk)
    return digest.hexdigest()


def compute_manifest(step_dir: str, step: int) -> Dict[str, Any]:
    """Hash every file under the (finalized) step directory."""
    files: Dict[str, str] = {}
    total = 0
    for root, _dirs, names in os.walk(step_dir):
        for name in sorted(names):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            files[rel] = _sha256_file(path)
            total += os.path.getsize(path)
    return {'step': step, 'files': files, 'total_bytes': total}


def write_manifest(ckpt_dir: str, step: int,
                   step_dir: Optional[str] = None) -> str:
    """Atomically write the manifest for one finalized step; returns
    its path."""
    step_dir = step_dir or os.path.join(ckpt_dir, str(step))
    manifest = compute_manifest(step_dir, step)
    path = manifest_path(ckpt_dir, step)
    tmp = f'{path}.tmp'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def manifest_steps(ckpt_dir: str) -> List[int]:
    """Steps that have a manifest on disk, ascending."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    steps = []
    for name in names:
        match = _MANIFEST_RE.match(name)
        if match:
            steps.append(int(match.group(1)))
    return sorted(steps)


def prune_manifests(ckpt_dir: str, keep_steps) -> None:
    """Drop manifests whose step directory is gone (max_to_keep GC
    removed it)."""
    keep = set(int(s) for s in keep_steps)
    for step in manifest_steps(ckpt_dir):
        if step not in keep:
            try:
                os.remove(manifest_path(ckpt_dir, step))
            except OSError:
                pass  # already gone; nothing to prune


def verify_step(ckpt_dir: str, step: int,
                step_dir: Optional[str] = None) -> bool:
    """Verify one step against its manifest. Returns True when
    verified, False when no manifest exists (a pre-integrity-era
    checkpoint: callers log and accept). Raises
    `CheckpointCorruptionError` on any mismatch: a missing file, a
    hash mismatch, or an unreadable manifest."""
    step_dir = step_dir or os.path.join(ckpt_dir, str(step))
    path = manifest_path(ckpt_dir, step)
    if not os.path.exists(path):
        return False
    try:
        with open(path, 'r', encoding='utf-8') as f:
            manifest = json.load(f)
        files = dict(manifest['files'])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptionError(
            f'checkpoint step {step}: unreadable manifest {path} '
            f'({e})') from e
    for rel, expected in files.items():
        file_path = os.path.join(step_dir, rel)
        if not os.path.exists(file_path):
            raise CheckpointCorruptionError(
                f'checkpoint step {step}: manifest lists {rel} but '
                f'it is missing from {step_dir}')
        actual = _sha256_file(file_path)
        if actual != expected:
            raise CheckpointCorruptionError(
                f'checkpoint step {step}: {rel} sha256 mismatch '
                f'(manifest {expected[:12]}…, on disk '
                f'{actual[:12]}…) — torn or corrupt write')
    return True


def preflight(ckpt_dir: str,
              steps: Optional[List[int]] = None) -> Dict[str, Any]:
    """Controller-side dry run of the restore fallback: which steps
    exist, which verify, and which step a relaunched job will
    actually resume from. Never raises — this is an early-warning
    surface for the jobs recovery path, not a gate."""
    if steps is None:
        steps = []
        try:
            for name in os.listdir(ckpt_dir):
                if name.isdigit() and os.path.isdir(
                        os.path.join(ckpt_dir, name)):
                    steps.append(int(name))
        except OSError:
            pass
        steps = sorted(steps)
    corrupt: List[int] = []
    unverified: List[int] = []
    newest_verifying: Optional[int] = None
    for step in sorted(steps, reverse=True):
        try:
            verified = verify_step(ckpt_dir, step)
        except CheckpointCorruptionError:
            corrupt.append(step)
            continue
        if not verified:
            unverified.append(step)
        if newest_verifying is None:
            newest_verifying = step
    return {'steps': sorted(steps), 'corrupt_steps': sorted(corrupt),
            'unverified_steps': sorted(unverified),
            'newest_verifying': newest_verifying}
