"""Fused QKV LoRA kernel wrapper and dispatch (port of
`fused_qkv_lora_delta` / `qkv_lora_dispatches_per_layer`,
skypilot_tpu/ops/pallas_paged.py:385-447).

`fused_qkv_lora_delta(x, wq_f, wk_f, wv_f, adapter_ids)` has the
reference's signature and result: x [B, S, d_in]; each factors dict
holds stacked `a [N, d_in, r]` / `b [N, r, d_out]`; adapter_ids int32
[B] selects each row's adapter. Returns the UNSCALED f32 deltas
(dq, dk, dv), each [B, S, d_out]; the caller adds
`(scale * d).to(y.dtype)`, which matches `lora.apply_delta` (same
(x @ a) @ b contraction order, in f32).

Dispatch is `ops/paged_kernel.py`'s (`IMPLS`, `impl_scope`,
`resolve_impl`, `unavailable_reason` are the same objects): 'auto' is
the CUDA kernel (csrc/qkv_lora.cu) for CUDA tensors and the plain
version `fused_qkv_lora_delta_reference` for CPU tensors; an
`impl_scope` override replaces 'auto' for both kernels; 'cuda' on CPU
tensors raises. No environment switch, no fallback. `launches` counts
kernel calls (one call = `DEVICE_LAUNCHES_PER_CALL` device launches)
and `plain_calls` plain-version calls made through the wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

# One impl switch routes both kernels, as pallas_paged.resolve_impl does
# in the reference.
from skypilot_tpu_torch.ops.paged_kernel import (  # noqa: F401
    IMPLS, impl_scope, resolve_impl, unavailable_reason)

#: Kernel calls made by `fused_qkv_lora_delta` in this process.
launches = 0
#: Calls of the plain version made through `fused_qkv_lora_delta`.
plain_calls = 0
#: Device launches per kernel call: shrink, then expand.
DEVICE_LAUNCHES_PER_CALL = 2

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANK = 128


def qkv_lora_dispatches_per_layer(impl: str) -> int:
    """Batched-LoRA dispatches for the three QKV projections of one
    layer on a resolved route: the kernel folds them into ONE call (of
    `DEVICE_LAUNCHES_PER_CALL` device launches); the plain version
    runs one gather+matmul chain per projection. profile_decode.py
    holds a traced LoRA round's kernel launches to this count."""
    if impl not in IMPLS:
        raise ValueError(f'unknown impl {impl!r} (choices: '
                         f'{", ".join(IMPLS)})')
    return 1 if impl == 'cuda' else 3


def fused_qkv_lora_delta(x: torch.Tensor, wq_factors: Dict,
                         wk_factors: Dict, wv_factors: Dict,
                         adapter_ids: torch.Tensor, *, impl: str = 'auto',
                         perturb: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """UNSCALED f32 LoRA deltas for wq/wk/wv (see module doc).
    `perturb` scales every delta by (1 + perturb): a deliberately wrong
    kernel for tests to prove the parity pins bite."""
    global plain_calls
    factors = (wq_factors, wk_factors, wv_factors)
    if x.ndim != 3:
        raise ValueError(f'expected x [B, S, d_in], got {tuple(x.shape)}')
    batch, _, d_in = x.shape
    n, _, rank = wq_factors['a'].shape
    for f in factors:
        a, b = f['a'], f['b']
        if a.ndim != 3 or b.ndim != 3 or tuple(a.shape) != (n, d_in, rank) \
                or tuple(b.shape[:2]) != (n, rank):
            raise ValueError(
                f'factors must be a [{n}, {d_in}, {rank}] / b [{n}, '
                f'{rank}, d_out]; got {tuple(a.shape)} / {tuple(b.shape)}')
    if tuple(adapter_ids.shape) != (batch,):
        raise ValueError(f'adapter_ids must be [{batch}], got '
                         f'{tuple(adapter_ids.shape)}')
    if resolve_impl(impl, x.device) == 'torch':
        plain_calls += 1
        return fused_qkv_lora_delta_reference(x, *factors, adapter_ids,
                                              perturb=perturb)
    return _launch(x, factors, adapter_ids, perturb)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from skypilot_tpu_torch.ops import _build
    lib = _build.load('qkv_lora')
    lib.skypilot_qkv_lora.restype = ctypes.c_int
    lib.skypilot_qkv_lora.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.skypilot_qkv_lora_scratch_floats.restype = ctypes.c_longlong
    lib.skypilot_qkv_lora_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.skypilot_qkv_lora_error_string.restype = ctypes.c_char_p
    lib.skypilot_qkv_lora_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(x, factors, adapter_ids, perturb):
    global launches
    tensors = [x, adapter_ids] + [f[k] for f in factors for k in ('a', 'b')]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f'all tensors must lie on {x.device}, one '
                             f'lies on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the kernel takes contiguous tensors; got '
                             f'strides {t.stride()} for shape '
                             f'{tuple(t.shape)}')
    if x.dtype not in _CODES:
        raise TypeError(f'x dtype {x.dtype} not in {list(_CODES)}')
    f_dtype = factors[0]['a'].dtype
    if f_dtype not in _CODES or any(f[k].dtype != f_dtype for f in factors
                                    for k in ('a', 'b')):
        raise TypeError(f'the six factor arrays must share one dtype in '
                        f'{list(_CODES)}')
    if adapter_ids.dtype != torch.int32:
        raise TypeError('adapter_ids must be int32')
    batch, seq, d_in = x.shape
    n, _, rank = factors[0]['a'].shape
    if not 1 <= rank <= _MAX_RANK:
        raise ValueError(f'the kernel takes ranks 1..{_MAX_RANK}, got {rank}')
    d_outs = [f['b'].shape[2] for f in factors]
    outs = [torch.empty((batch, seq, d), dtype=torch.float32,
                        device=x.device) for d in d_outs]
    lib = _library()
    scratch = torch.empty(
        lib.skypilot_qkv_lora_scratch_floats(batch, seq, d_in, rank),
        dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.skypilot_qkv_lora(
        x.data_ptr(), *[f[k].data_ptr() for f in factors for k in ('a', 'b')],
        adapter_ids.data_ptr(), scratch.data_ptr(),
        *[o.data_ptr() for o in outs], batch, seq, d_in, n, rank, *d_outs,
        _CODES[x.dtype], _CODES[f_dtype], float(perturb), stream)
    if err != 0:
        msg = lib.skypilot_qkv_lora_error_string(err).decode()
        raise RuntimeError(f'QKV LoRA kernel failed to launch: CUDA error '
                           f'{err} ({msg})')
    launches += 1
    return tuple(outs)


def fused_qkv_lora_delta_reference(x: torch.Tensor, wq_factors: Dict,
                                   wk_factors: Dict, wv_factors: Dict,
                                   adapter_ids: torch.Tensor, *,
                                   perturb: float = 0.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of the kernel: `gathered_delta` per
    projection."""
    outs = [gathered_delta(x, f, adapter_ids)
            for f in (wq_factors, wk_factors, wv_factors)]
    return tuple(d * (1.0 + perturb) if perturb else d for d in outs)


def gathered_delta(x: torch.Tensor, factors: Dict,
                   adapter_ids: torch.Tensor) -> torch.Tensor:
    """(x @ a) @ b in f32 with each row's stacked factors gathered by
    `adapter_ids`: one projection's unscaled LoRA delta [B, S, d_out]."""
    h = torch.bmm(x.float(), factors['a'][adapter_ids].float())
    return torch.bmm(h, factors['b'][adapter_ids].float())
