"""Trainer step telemetry: one JSONL record per logged step window (port
of skypilot_tpu/observability/step_metrics.py).

`train_lm --metrics-file out.jsonl` constructs a StepMetrics and calls
`log()` at every `--log-every` boundary. Each record carries step time,
tokens/s, loss, grad norm and an achieved-MFU estimate against the
card's peak. Records are flushed line by line, so a preempted run's file
is valid JSONL up to the last completed window.

MFU model: achieved = 6 * n_params * tokens/s (the dense-transformer
train-FLOPs estimate, forward and backward) over the card's dense bf16
peak, looked up from its name. `matmul_params` gives the N to pass: the
token-embedding table is a lookup and does no matmul work, so it is left
out (the LM head stays in). Unknown hardware (the CPU) reports
mfu = null rather than a made-up number.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Parameters 6N leaves out: looked up by row, not multiplied.
_LOOKUP_PARAMS = ('tok_embed',)


def matmul_params(named_parameters: Iterable[Tuple[str, Any]]) -> int:
    """Elements of every parameter a forward multiplies by: all of them
    but the token-embedding table."""
    return sum(p.numel() for name, p in named_parameters
               if name not in _LOOKUP_PARAMS)

# Dense bf16 tensor-core peak per card (NVIDIA data sheets, SXM parts),
# by substring of torch.cuda.get_device_name(), checked in order.
_PEAK_FLOPS_BY_NAME = (
    ('H200', 989e12),
    ('H100', 989e12),
)


def peak_flops_for(device_name: Optional[str]) -> Optional[float]:
    """The dense bf16 peak of a card named `device_name`; None when the
    name is unknown or None (the CPU)."""
    if not device_name:
        return None
    for sub, flops in _PEAK_FLOPS_BY_NAME:
        if sub in device_name:
            return flops
    return None


class StepMetrics:
    """JSONL step-metrics emitter. Construct once per run; `log()` per
    logged window; `close()` at the end."""

    def __init__(self, path: str, *, n_params: Optional[int] = None,
                 n_devices: int = 1,
                 peak_flops: Optional[float] = None) -> None:
        self.path = os.path.expanduser(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self.n_params = n_params
        self.n_devices = max(n_devices, 1)
        self.peak_flops = peak_flops
        self._f = open(self.path, 'a', encoding='utf-8')

    def mfu(self, tokens_per_sec: float) -> Optional[float]:
        """6 * N * tokens/s over the aggregate peak; None without a
        param count or a known peak."""
        if not self.n_params or not self.peak_flops:
            return None
        achieved = 6.0 * self.n_params * tokens_per_sec
        return round(achieved / (self.peak_flops * self.n_devices), 4)

    def log(self, step: int, *, step_time_s: float, tokens: int,
            loss: float, grad_norm: Optional[float] = None
            ) -> Dict[str, Any]:
        """Write one record covering a window that ended at `step`:
        `step_time_s` is the mean per-step wall time over the window,
        `tokens` the tokens one step consumes. The reference's
        `bubble_frac` (pipelines) and `collective_wait_s` (meshes) keys
        stay in the record, null on one card."""
        tokens_per_sec = tokens / step_time_s if step_time_s > 0 else 0.0
        record: Dict[str, Any] = {
            'step': int(step),
            'time': time.time(),
            'step_time_s': round(float(step_time_s), 6),
            'tokens_per_sec': round(tokens_per_sec, 2),
            'loss': float(loss),
            'grad_norm': None if grad_norm is None else float(grad_norm),
            'mfu': self.mfu(tokens_per_sec),
            'bubble_frac': None,
            'collective_wait_s': None,
        }
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()
        return record

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a --metrics-file back into records."""
    records = []
    with open(os.path.expanduser(path), 'r', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
