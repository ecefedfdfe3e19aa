"""LoRA (low-rank adaptation) for the port's Llama-family models (port of
skypilot_tpu/models/lora.py).

Training (`train_lm --lora`) trains ONE adapter's factors
`a [d_in, r]`, `b [r, d_out]` (`init_lora_params`: a ~ N(0, 0.02),
b = 0) applied to every row (`apply_delta` with no adapter ids).
Serving keeps adapters device-resident as STACKED factors
`a [N, d_in, r]`, `b [N, r, d_out]` (inference/adapters.py); every
engine slot carries an adapter id, and the forward gathers each row's
factors (`apply_delta`), so one batch serves many adapters. Row 0 is
all zeros: the base model.

Factor orientation is the reference's (flax Dense kernels are
[d_in, d_out]): `a: [d_in, rank]`, `b: [rank, d_out]`, delta
`x @ a @ b * scale` with `scale = alpha / rank`. The port's
`nn.Linear` weights are [d_out, d_in], so `merge_lora` adds the
transposed product.

The artifact format (`adapter_config.json` + `adapter_weights.npz`,
format `skypilot-tpu-lora-v1`) and everything here that needs no
framework are copies of the reference, so an adapter the reference's
`train_lm --lora` writes serves on the port unmodified, and one the
port's writes serves on the reference.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.ops import lora_kernel

ATTN_TARGETS: Tuple[str, ...] = ('wq', 'wk', 'wv', 'wo')
MLP_TARGETS: Tuple[str, ...] = ('w_gate', 'w_up', 'w_down')
ALL_TARGETS: Tuple[str, ...] = ATTN_TARGETS + MLP_TARGETS

#: Which Block submodule owns each projection.
_TARGET_MODULE = {t: 'attn' for t in ATTN_TARGETS}
_TARGET_MODULE.update({t: 'mlp' for t in MLP_TARGETS})

CONFIG_FILE = 'adapter_config.json'
WEIGHTS_FILE = 'adapter_weights.npz'
FORMAT = 'skypilot-tpu-lora-v1'


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """Rank/alpha/target-set of one adapter."""
    rank: int
    alpha: float
    targets: Tuple[str, ...] = ATTN_TARGETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f'lora rank must be >= 1, got {self.rank}')
        unknown = [t for t in self.targets if t not in ALL_TARGETS]
        if unknown:
            raise ValueError(
                f'unknown lora targets {unknown}; valid: {ALL_TARGETS}')

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)


def targets_from_name(name: str) -> Tuple[str, ...]:
    """CLI sugar: 'attn' | 'attn-mlp'/'all' | 'mlp' -> target tuple."""
    if name == 'attn':
        return ATTN_TARGETS
    if name in ('attn-mlp', 'all'):
        return ALL_TARGETS
    if name == 'mlp':
        return MLP_TARGETS
    raise ValueError(f'unknown lora target set {name!r} '
                     f'(use attn | mlp | attn-mlp)')


def projection_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) per adaptable projection for a Llama-family
    config."""
    hd = cfg.embed_dim // cfg.num_heads
    return {
        'wq': (cfg.embed_dim, cfg.num_heads * hd),
        'wk': (cfg.embed_dim, cfg.num_kv_heads * hd),
        'wv': (cfg.embed_dim, cfg.num_kv_heads * hd),
        'wo': (cfg.num_heads * hd, cfg.embed_dim),
        'w_gate': (cfg.embed_dim, cfg.mlp_dim),
        'w_up': (cfg.embed_dim, cfg.mlp_dim),
        'w_down': (cfg.mlp_dim, cfg.embed_dim),
    }


def supports(model) -> bool:
    """True when `model` threads the `lora` argument through its
    forward AND its config has the Llama-family projection geometry
    (`projection_shapes`). An int8 model is one: deltas apply to the
    projections' outputs, whatever stores their weights. A serving
    grid's model (parallel/serving.py) is one when its family is."""
    try:
        sig = inspect.signature(getattr(model, 'family', type(model)).forward)
    except (TypeError, ValueError):
        return False
    if 'lora' not in sig.parameters:
        return False
    try:
        projection_shapes(model.config)
    except (AttributeError, TypeError, ZeroDivisionError):
        return False
    return True


def adapter_num_bytes(cfg, rank: int, targets: Tuple[str, ...],
                      bytes_per_elem: int = 4) -> int:
    """Device bytes ONE adapter occupies in the stacked store."""
    shapes = projection_shapes(cfg)
    per_layer = sum((d_in + d_out) * rank
                    for t, (d_in, d_out) in shapes.items()
                    if t in targets)
    return per_layer * cfg.num_layers * bytes_per_elem


def random_adapter_params(seed: int, cfg, spec: LoraSpec
                          ) -> Dict[str, Any]:
    """Numpy-only random adapter (both factors non-zero, so the delta
    is non-trivial); the reference's generator, number for number."""
    rng = np.random.default_rng(seed)
    shapes = projection_shapes(cfg)
    params: Dict[str, Any] = {}
    for i in range(cfg.num_layers):
        layer: Dict[str, Any] = {}
        for t in spec.targets:
            d_in, d_out = shapes[t]
            layer[t] = {
                'a': rng.normal(0, 0.02, (d_in, spec.rank)
                                ).astype(np.float32),
                'b': rng.normal(0, 0.02, (spec.rank, d_out)
                                ).astype(np.float32),
            }
        params[f'layer_{i}'] = layer
    return params


def init_lora_params(cfg, spec: LoraSpec, seed: int = 0,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, Any]:
    """Fresh trainable factors: a ~ N(0, 0.02), b = 0 (step 0 is the
    base model), f32, {'layer_i': {target: {'a': [d_in, r], 'b': [r,
    d_out]}}}, drawn from one torch.Generator seeded with `seed` (the
    reference's distributions, not its jax.random numbers)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = projection_shapes(cfg)
    params: Dict[str, Any] = {}
    for i in range(cfg.num_layers):
        layer: Dict[str, Any] = {}
        for t in spec.targets:
            d_in, d_out = shapes[t]
            a = torch.empty((d_in, spec.rank), dtype=torch.float32,
                            device=device)
            layer[t] = {
                'a': a.normal_(0.0, 0.02, generator=gen),
                'b': torch.zeros((spec.rank, d_out), dtype=torch.float32,
                                 device=device),
            }
        params[f'layer_{i}'] = layer
    return params


def shard_lora_params(lora_params, index: int, ways: int, kv_split: bool
                      ) -> Dict[str, Any]:
    """Slice one adapter's training factors to tensor shard `index` of
    `ways` in place (parallel/tensor.py `lora_factor_axes`: a
    column-parallel delta splits b's columns, a row-parallel one a's
    rows); returns {'lora.layer_i.target.a|b': its split}, 'sum' for a
    whole factor (read inside a sharded region: its gradient is the
    sum of the shards')."""
    from skypilot_tpu_torch.parallel import tensor
    axes = {}
    for name, layer in lora_params.items():
        for target, factors in layer.items():
            for key, axis in zip(('a', 'b'), tensor.lora_factor_axes(
                    target, kv_split)):
                axes[f'lora.{name}.{target}.{key}'] = (
                    'sum' if axis is None else axis)
                if axis is not None:
                    factors[key] = tensor.piece(factors[key], axis, index,
                                                ways).clone()
    return axes


def as_model_lora(lora_params, scale) -> Dict[str, Any]:
    """Wrap raw per-layer factors into what the model forward takes:
    {'scale': float, 'layers': {...}}."""
    return {'scale': float(scale), 'layers': lora_params}


def apply_delta(y: torch.Tensor, x: torch.Tensor, factors: Dict,
                adapter_ids: Optional[torch.Tensor], scale) -> torch.Tensor:
    """y + scale * ((x @ a) @ b), computed in f32 and cast to y's dtype
    before the add (the reference's order).

    Single-adapter mode (`adapter_ids is None`, training): `a: [d_in,
    r]`, `b: [r, d_out]` apply to every row. Batched mode: `a: [N,
    d_in, r]`, `b: [N, r, d_out]` are stacked per device adapter slot;
    `adapter_ids: [batch]` gathers each row's factors (row 0 is all
    zeros = the base model)."""
    if adapter_ids is None:
        delta = (x.float() @ factors['a'].float()) @ factors['b'].float()
    else:
        delta = lora_kernel.gathered_delta(x, factors, adapter_ids)
    return y + (scale * delta).to(y.dtype)


def merge_lora(model, lora_params, spec: LoraSpec):
    """A copy of the port `Llama` `model` whose adapted weights are
    W + (a @ b * scale)^T, summed in f32 and cast back to the weight's
    dtype: the parity oracle for the batched per-slot path. Other
    tensors are shared with `model`, not copied. An int8 model has no
    dense weight to merge into: build the oracle from the unquantized
    model."""
    from skypilot_tpu_torch.models import convert
    if getattr(model, 'weight_dtype', 'bf16') != 'bf16':
        raise ValueError('merge_lora merges into dense weights; pass the '
                         'unquantized model')
    state = dict(model.state_dict())
    for layer_name, layer in lora_params.items():
        idx = int(layer_name.split('_')[1])
        for t, factors in layer.items():
            key = f'layers.{idx}.{_TARGET_MODULE[t]}.{t}.weight'
            w = state[key]
            a = torch.as_tensor(np.asarray(factors['a'], np.float32),
                                device=w.device)
            b = torch.as_tensor(np.asarray(factors['b'], np.float32),
                                device=w.device)
            delta = (a @ b) * spec.scale                   # [d_in, d_out]
            state[key] = (w.float() + delta.T).to(w.dtype)
    return convert.assemble(model.config, state)


# -- artifacts --------------------------------------------------------------
def save_adapter(out_dir: str, lora_params, spec: LoraSpec, *,
                 base_model: str, step: Optional[int] = None) -> str:
    """Write the artifact the serving registry loads unmodified:
    `adapter_config.json` + `adapter_weights.npz` (flattened
    `layer_i/target/a|b` keys)."""
    os.makedirs(out_dir, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    for layer_name, layer in lora_params.items():
        for t, factors in layer.items():
            flat[f'{layer_name}/{t}/a'] = np.asarray(factors['a'],
                                                     np.float32)
            flat[f'{layer_name}/{t}/b'] = np.asarray(factors['b'],
                                                     np.float32)
    np.savez(os.path.join(out_dir, WEIGHTS_FILE), **flat)
    config = {
        'format': FORMAT,
        'base_model': base_model,
        'rank': spec.rank,
        'alpha': spec.alpha,
        'targets': list(spec.targets),
        'num_layers': len(lora_params),
    }
    if step is not None:
        config['step'] = int(step)
    # Weights land before the config that announces them: a scanner
    # never sees a config without loadable weights.
    with open(os.path.join(out_dir, CONFIG_FILE), 'w',
              encoding='utf-8') as f:
        json.dump(config, f, indent=2)
    return out_dir


def load_adapter(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(config, per-layer factors) from an artifact directory."""
    with open(os.path.join(path, CONFIG_FILE), encoding='utf-8') as f:
        config = json.load(f)
    params: Dict[str, Any] = {}
    with np.load(os.path.join(path, WEIGHTS_FILE)) as z:
        for key in z.files:
            layer_name, t, which = key.split('/')
            params.setdefault(layer_name, {}).setdefault(t, {})[which] \
                = z[key]
    return config, params


def load_spec(config: Dict[str, Any]) -> LoraSpec:
    return LoraSpec(rank=int(config['rank']),
                    alpha=float(config['alpha']),
                    targets=tuple(config['targets']))


def list_adapter_dirs(adapter_dir: str) -> List[str]:
    """Subdirectories of `adapter_dir` that hold an adapter artifact
    (name = directory basename)."""
    if not os.path.isdir(adapter_dir):
        return []
    out = []
    for name in sorted(os.listdir(adapter_dir)):
        if os.path.isfile(os.path.join(adapter_dir, name, CONFIG_FILE)):
            out.append(name)
    return out
