"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(`serve_lm --cpu`, `device='cpu'` in tests). With no GPU and no such
request they raise; they never carry on quietly on the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


class NoCudaDeviceError(RuntimeError):
    """CUDA was required (the default) but no CUDA device is visible."""


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   *, cpu: bool = False) -> torch.device:
    """The device an entry point runs on: `cuda` unless `cpu` is set
    or `device` names another one explicitly. Raises
    NoCudaDeviceError when CUDA is wanted and missing."""
    if cpu:
        return torch.device('cpu')
    dev = torch.device(device if device is not None else 'cuda')
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                'no CUDA device is available; the port runs on the GPU '
                'by default — pass --cpu (serve_lm) or device="cpu" to '
                'run on the CPU')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def card_description() -> str:
    """`name, power limit` of the card(s), as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them
    (one line per card). Raises when nvidia-smi is missing."""
    exe = shutil.which('nvidia-smi')
    if exe is None:
        raise FileNotFoundError('nvidia-smi not found on PATH')
    out = subprocess.run(
        [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
