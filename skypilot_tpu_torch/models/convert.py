"""Weights for the port's `Llama`: from a Flax param tree, or a seeded
init on the device.

`params_from_jax` maps the tree that the reference's
`model.init(...)['params']` gives (every leaf as a float32 numpy array;
Dense kernels stored [in, out]) onto the port's modules in serving's
layout, and raises on any leaf it did not consume; `lora_from_jax` does
the same for LoRA factor trees. `train_params_from_jax` and
`lora_train_params_from_jax` carry a tree into training's layout (every
leaf an f32 master, as in the reference); `train_params_to_jax` and
`lora_params_to_numpy` map trained tensors back to numpy under the
reference's names. `cast_to_layout` stores a {name: tensor} state of
any source dtype (an HF import, a `train_lm` checkpoint) as a config's
layout says. `init_params` is the seeded init the card uses:
normal(0, 0.02) for Dense kernels, the embedding and the head, ones for
norms, zeros for biases. Nothing is downloaded.

int8 projection weights (`weight_dtype='int8'`): `params_from_jax` takes
a tree the reference's `quantize_params` wrote (`kernel_q` /
`kernel_scale` leaves become `weight_q` = kernel_q.T and `weight_scale`,
byte for byte), and `params_from_jax`, `init_params` and the HF importer
quantize an f32 source (`quantize_state`) from its f32 values, before any
cast to the compute dtype, one tensor at a time, as the reference
quantizes its f32 tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from skypilot_tpu_torch.inference import quant
from skypilot_tpu_torch.models.llama import DENSE_CLASSES, Llama, LlamaConfig

_DENSE = {'attn': ('wq', 'wk', 'wv', 'wo'),
          'mlp': ('w_gate', 'w_up', 'w_down')}
_QKV = ('wq', 'wk', 'wv')


def weight_dtype_of(state: Mapping[str, torch.Tensor]) -> str:
    """'int8' when the state holds int8 projections, else 'bf16'."""
    return ('int8' if any(k.endswith('.weight_q') for k in state)
            else 'bf16')


def assemble(cfg: LlamaConfig, state: Mapping[str, torch.Tensor]) -> Llama:
    """A `Llama` whose weights ARE the given tensors (no copy): the
    module is built on the meta device and the tensors assigned,
    parameters and (int8 projections) buffers, under strict=True. Also
    how two configs that differ only in their KV pool share weights."""
    with torch.device('meta'):
        model = Llama(cfg, weight_dtype=weight_dtype_of(state))
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model


def _store_int8(state: Dict[str, torch.Tensor], key: str,
                kernel: torch.Tensor) -> None:
    """Module `key`'s `weight_q` ([out, in] int8) and `weight_scale`
    (f32 [out]) from its f32 [in, out] kernel, into `state`."""
    q, scale = quant.quantize_kernel(kernel)
    state[f'{key}.weight_q'] = q.T.contiguous()
    state[f'{key}.weight_scale'] = scale


def quantize_state(state: Mapping[str, torch.Tensor],
                   device: Optional[torch.device] = None
                   ) -> Dict[str, torch.Tensor]:
    """`state` with each projection's `.weight` ([out, in], any float
    dtype) replaced by `.weight_q` (int8 [out, in]) and `.weight_scale`
    (f32 [out]), quantized from its values upcast to f32
    (`quant.quantize_kernel` on the [in, out] kernel), one tensor at a
    time on `device`; every other tensor passes through."""
    targets = tuple(f'.{t}.weight' for t in quant.WEIGHT_TARGETS)
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if not name.endswith(targets):
            out[name] = t
            continue
        w = t.to(device) if device is not None else t
        _store_int8(out, name[:-len('.weight')], w.float().T)
    return out


def _head(w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    # The head multiplies bf16 operands into an f32 result: store the
    # operand already rounded to the compute dtype, in f32.
    return w.to(cfg.dtype).float()


def cast_to_layout(cfg: LlamaConfig, state: Mapping[str, torch.Tensor],
                   device: Optional[torch.device] = None
                   ) -> Dict[str, torch.Tensor]:
    """`state` ({port parameter name: tensor}, any float dtype) stored
    as `cfg.param_dtype` says: norm scales in f32; with param_dtype
    None (serving) the rest in `dtype` and the head in f32 holding
    `dtype`-rounded values, else every tensor an f32 master."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        t = t.to(device) if device is not None else t
        if name.endswith(('.weight_q', '.weight_scale')):
            out[name] = t              # int8 projections keep their dtypes
        elif name.endswith('.scale') or cfg.trainable:
            out[name] = t.float()
        elif name == 'lm_head':
            out[name] = _head(t, cfg)
        else:
            out[name] = t.to(cfg.param_dtype or cfg.dtype)
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig,
                    device: Optional[torch.device] = None,
                    weight_dtype: Optional[str] = None) -> Llama:
    """Port `Llama` with the weights of a reference param tree, stored
    as `cfg.param_dtype` says (None: serving's layout). A tree of the
    reference's `quantize_params` gives int8 projections as they are;
    `weight_dtype='int8'` quantizes an f32 tree's kernels (default: the
    tree's own storage)."""
    trainable = cfg.trainable
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f'{prefix}{key}'
            if isinstance(val, Mapping):
                walk(val, path + '/')
            elif key == quant.QUANT_KEY:
                flat[path] = np.asarray(val)
            else:
                flat[path] = np.asarray(val, np.float32)

    walk(tree, '')
    quantized = any(p.endswith('/' + quant.QUANT_KEY) for p in flat)
    if weight_dtype is None:
        weight_dtype = 'int8' if quantized else 'bf16'
    if weight_dtype not in DENSE_CLASSES or (quantized and
                                              weight_dtype != 'int8'):
        raise ValueError(f'weight_dtype {weight_dtype!r} for a '
                         f'{"quantized" if quantized else "dense"} tree')

    def take(path: str) -> torch.Tensor:
        if path not in flat:
            raise KeyError(f'param tree has no leaf {path!r}')
        return torch.tensor(flat.pop(path), device=device)

    def store(t: torch.Tensor) -> torch.Tensor:
        return t if trainable else t.to(cfg.dtype)

    head = take('lm_head').T.contiguous()
    state: Dict[str, torch.Tensor] = {
        'tok_embed': store(take('tok_embed')),
        'lm_head': head if trainable else _head(head, cfg),
        'final_norm.scale': take('final_norm/scale'),
    }
    for i in range(cfg.num_layers):
        src, dst = f'layer_{i}', f'layers.{i}'
        for norm in ('attn_norm', 'mlp_norm'):
            state[f'{dst}.{norm}.scale'] = take(f'{src}/{norm}/scale')
        for group, names in _DENSE.items():
            for name in names:
                leaf, key = f'{src}/{group}/{name}', f'{dst}.{group}.{name}'
                if quantized:
                    state[f'{key}.weight_q'] = take(
                        f'{leaf}/{quant.QUANT_KEY}').T.contiguous()
                    state[f'{key}.weight_scale'] = take(
                        f'{leaf}/{quant.SCALE_KEY}')
                else:
                    kernel = take(f'{leaf}/kernel')
                    if weight_dtype == 'int8':
                        _store_int8(state, key, kernel)
                    else:
                        state[f'{key}.weight'] = store(kernel.T.contiguous())
                if cfg.qkv_bias and name in _QKV:
                    state[f'{key}.bias'] = store(take(f'{leaf}/bias'))
    if flat:
        raise ValueError(f'param tree leaves not consumed: {sorted(flat)}')
    return assemble(cfg, state)


def train_params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig,
                          device: Optional[torch.device] = None) -> Llama:
    """Port `Llama` in training's layout (every leaf an f32 master,
    trainable) with the weights of a reference param tree; raises on a
    stray leaf."""
    return params_from_jax(
        tree, dataclasses.replace(cfg, param_dtype=torch.float32), device)


def train_params_to_jax(model: Llama) -> Dict[str, Any]:
    """The reference's param tree (float32 numpy leaves, Dense kernels
    [in, out], `lm_head` [embed, vocab]) of a port `Llama`: the inverse
    of `train_params_from_jax`."""
    cfg = model.config

    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    tree: Dict[str, Any] = {
        'tok_embed': np32(model.tok_embed),
        'lm_head': np32(model.lm_head).T.copy(),
        'final_norm': {'scale': np32(model.final_norm.scale)},
    }
    for i, block in enumerate(model.layers):
        layer: Dict[str, Any] = {
            'attn_norm': {'scale': np32(block.attn_norm.scale)},
            'mlp_norm': {'scale': np32(block.mlp_norm.scale)}}
        for group, names in _DENSE.items():
            module = getattr(block, group)
            layer[group] = {}
            for name in names:
                dense = getattr(module, name)
                leaf = {'kernel': np32(dense.weight).T.copy()}
                if cfg.qkv_bias and name in _QKV:
                    leaf['bias'] = np32(dense.bias)
                layer[group][name] = leaf
        tree[f'layer_{i}'] = layer
    return tree


def lora_train_params_from_jax(tree: Mapping[str, Any],
                               device: Optional[torch.device] = None
                               ) -> Dict[str, Any]:
    """Trainable f32 factor tensors {'layer_i': {target: {'a', 'b'}}}
    from a reference LoRA factor tree (raw per-layer factors); raises
    on a stray key or leaf."""
    layers = lora_from_jax(tree)['layers']
    return {lname: {t: {k: torch.tensor(v, device=device)
                        for k, v in factors.items()}
                    for t, factors in layer.items()}
            for lname, layer in layers.items()}


def lora_params_to_numpy(lora_params: Mapping[str, Any]) -> Dict[str, Any]:
    """float32 numpy copies of trained factors, same nesting (what
    `lora.save_adapter` and the reference's tree hold)."""
    return {lname: {t: {k: v.detach().float().cpu().numpy()
                        for k, v in factors.items()}
                    for t, factors in layer.items()}
            for lname, layer in lora_params.items()}


def lora_from_jax(tree: Mapping[str, Any], scale: float = 1.0
                  ) -> Dict[str, Any]:
    """The port's `lora` structure ({'scale', 'layers': {'layer_i':
    {target: {'a', 'b'}}}}, float32 numpy leaves) from a reference LoRA
    pytree: raw per-layer factors (`scale` applies) or the model form
    {'scale', 'layers'} (its own scale wins). Factors keep their
    orientation (a [.., d_in, r], b [.., r, d_out]): unlike the base
    kernels they are not transposed. Raises on any stray key or
    leaf."""
    from skypilot_tpu_torch.models.lora import ALL_TARGETS
    if 'layers' in tree or 'scale' in tree:
        stray = sorted(set(tree) - {'scale', 'layers'})
        if stray:
            raise ValueError(f'lora tree keys not consumed: {stray}')
        scale, tree = float(np.asarray(tree['scale'])), tree['layers']
    layers: Dict[str, Any] = {}
    for lname, layer in tree.items():
        if not lname.startswith('layer_') or not isinstance(layer, Mapping):
            raise ValueError(f'lora tree leaf not consumed: {lname!r}')
        out = layers[lname] = {}
        for target, factors in layer.items():
            if target not in ALL_TARGETS or not isinstance(
                    factors, Mapping) or set(factors) != {'a', 'b'}:
                raise ValueError(f'lora tree leaf not consumed: '
                                 f'{lname}/{target}')
            out[target] = {k: np.asarray(v, np.float32)
                           for k, v in factors.items()}
    return {'scale': float(scale), 'layers': layers}


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: Optional[torch.device] = None,
                weight_dtype: str = 'bf16') -> Llama:
    """Seeded random weights, generated on `device` with one
    torch.Generator (not the reference's numbers: jax.random and
    torch generators differ), stored as `cfg.param_dtype` says. With
    `weight_dtype='int8'` each projection is quantized from its f32
    draw (the same draws as the bf16 model of this seed)."""
    if weight_dtype not in DENSE_CLASSES:
        raise ValueError(f'unsupported weight_dtype {weight_dtype!r}')
    gen = torch.Generator(device=device).manual_seed(seed)
    store_dtype = cfg.param_dtype or cfg.dtype

    def normal(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, 0.02, generator=gen)

    hd = cfg.head_dim
    d, f = cfg.embed_dim, cfg.mlp_dim
    out_in = {'wq': (cfg.num_heads * hd, d), 'wk': (cfg.num_kv_heads * hd, d),
              'wv': (cfg.num_kv_heads * hd, d), 'wo': (d, cfg.num_heads * hd),
              'w_gate': (f, d), 'w_up': (f, d), 'w_down': (d, f)}
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=device)
    state: Dict[str, torch.Tensor] = {
        'tok_embed': normal(cfg.vocab_size, d).to(store_dtype)}
    for i in range(cfg.num_layers):
        dst = f'layers.{i}'
        state[f'{dst}.attn_norm.scale'] = ones(d)
        state[f'{dst}.mlp_norm.scale'] = ones(d)
        for group, names in _DENSE.items():
            for name in names:
                w = normal(*out_in[name])
                if weight_dtype == 'int8':
                    _store_int8(state, f'{dst}.{group}.{name}', w.T)
                else:
                    state[f'{dst}.{group}.{name}.weight'] = w.to(store_dtype)
                del w
                if cfg.qkv_bias and name in _QKV:
                    state[f'{dst}.{group}.{name}.bias'] = torch.zeros(
                        out_in[name][0], dtype=store_dtype, device=device)
    state['final_norm.scale'] = ones(d)
    head = normal(cfg.vocab_size, d)
    state['lm_head'] = head if cfg.trainable else _head(head, cfg)
    return assemble(cfg, state)
