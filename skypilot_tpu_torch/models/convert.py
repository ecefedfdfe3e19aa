"""Weights for the port's models (`Llama`, `GPT`, `Mixtral`,
`Deepseek`): from a Flax param tree, or a seeded init on the device.
Each function takes any family's config and dispatches on its type
(`model_class`).

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
norms, zeros for biases (GPT's `wpe` normal(0, 0.01), as the
reference's). Nothing is downloaded.

Trees of the other families: GPT's `wte`, `wpe`, `h_i/{ln_1, attn/c_attn,
attn/c_proj, ln_2, mlp/c_fc, mlp/c_proj}` and `ln_f` (LayerNorms with
`scale` and `bias`, Dense kernels [in, out] with biases); Mixtral's
`tok_embed`, `layer_i/{attn_norm, attn/{wq,wk,wv,wo}, moe_norm,
moe/{router, w_gate, w_up, w_down}}`, `final_norm` and `lm_head`
(the router a bias-free [embed, E] kernel, the expert stacks kept in the
reference's [E, in, out] layout); DeepSeek's `tok_embed`,
`layer_i/{attn_norm, attn/{wq | wq_a, q_norm, wq_b}, attn/{wkv_a,
kv_norm, wkv_b, wo}, mlp_norm, mlp/{w_gate, w_up, w_down}}`,
`final_norm` and `lm_head` (`wkv_b` a raw [d_c, H, nope + v] array).

int8 projection weights (`weight_dtype='int8'`; the Llama family,
Mixtral's attention and DeepSeek's wq / wo / SwiGLU, the 2-D `{kernel}`
leaves named in `quant.WEIGHT_TARGETS`; GPT has none): `params_from_jax`
takes a tree the reference's `quantize_params` wrote (`kernel_q` /
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
from skypilot_tpu_torch.models.deepseek import Deepseek, DeepseekConfig
from skypilot_tpu_torch.models.gpt import GPT, GPTConfig
from skypilot_tpu_torch.models.llama import DENSE_CLASSES, Llama, LlamaConfig
from skypilot_tpu_torch.models.mixtral import Mixtral, MixtralConfig

_DENSE = {'attn': ('wq', 'wk', 'wv', 'wo'),
          'mlp': ('w_gate', 'w_up', 'w_down')}
_QKV = ('wq', 'wk', 'wv')


def weight_dtype_of(state: Mapping[str, torch.Tensor]) -> str:
    """'int8' when the state holds int8 projections, else 'bf16'."""
    return ('int8' if any(k.endswith('.weight_q') for k in state)
            else 'bf16')


_MODEL_CLASSES = {LlamaConfig: Llama, GPTConfig: GPT,
                  MixtralConfig: Mixtral, DeepseekConfig: Deepseek}


def model_class(cfg):
    """The port's model class of a config (`Llama`, `GPT`, `Mixtral`,
    `Deepseek`)."""
    try:
        return _MODEL_CLASSES[type(cfg)]
    except KeyError:
        raise TypeError(f'no port model for {type(cfg).__name__}') from None


def assemble(cfg, state: Mapping[str, torch.Tensor]):
    """The config's model whose weights ARE the given tensors (no copy):
    the module is built on the meta device and the tensors assigned,
    parameters and (int8 projections) buffers, under strict=True. Also
    how two configs that differ only in their KV pool share weights."""
    with torch.device('meta'):
        model = model_class(cfg)(cfg, weight_dtype=weight_dtype_of(state))
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


#: Tensors every layout stores in f32: norm scales, GPT's LayerNorm
#: biases and Mixtral's router (an f32 Dense in the reference).
_F32_SUFFIXES = ('.scale', 'ln_1.bias', 'ln_2.bias', 'ln_f.bias', '.router')


def cast_to_layout(cfg, state: Mapping[str, torch.Tensor],
                   device: Optional[torch.device] = None
                   ) -> Dict[str, torch.Tensor]:
    """`state` ({port parameter name: tensor}, any float dtype) stored
    as `cfg.param_dtype` says: norm scales (and the other
    `_F32_SUFFIXES`) in f32; with param_dtype None (serving) the rest in
    `dtype` and an untied head in f32 holding `dtype`-rounded values,
    else every tensor an f32 master."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        t = t.to(device) if device is not None else t
        if name.endswith(('.weight_q', '.weight_scale')):
            out[name] = t              # int8 projections keep their dtypes
        elif name.endswith(_F32_SUFFIXES) or cfg.trainable:
            out[name] = t.float()
        elif name == 'lm_head':
            out[name] = _head(t, cfg)
        else:
            out[name] = t.to(cfg.param_dtype or cfg.dtype)
    return out


def _flatten(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{'a/b/c': numpy leaf} of a nested param tree; int8 leaves keep
    their dtype, every other leaf becomes float32."""
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
    return flat


def _taker(flat: Dict[str, np.ndarray], device):
    def take(path: str) -> torch.Tensor:
        if path not in flat:
            raise KeyError(f'param tree has no leaf {path!r}')
        return torch.tensor(flat.pop(path), device=device)
    return take


def _dense_taker(flat: Dict[str, np.ndarray], take):
    """dense(leaf, key) -> module `key`'s weight tensors from tree leaf
    `leaf`: `.weight` [out, in] from an f32 `kernel`, or `.weight_q` /
    `.weight_scale` from the reference's quantized leaves, byte for
    byte."""
    def dense(leaf: str, key: str) -> Dict[str, torch.Tensor]:
        if f'{leaf}/{quant.QUANT_KEY}' in flat:
            return {f'{key}.weight_q':
                    take(f'{leaf}/{quant.QUANT_KEY}').T.contiguous(),
                    f'{key}.weight_scale': take(f'{leaf}/{quant.SCALE_KEY}')}
        return {f'{key}.weight': take(f'{leaf}/kernel').T.contiguous()}
    return dense


#: GPT's dense layers: (group, name) under each `h_i`.
_GPT_DENSE = (('attn', 'c_attn'), ('attn', 'c_proj'), ('mlp', 'c_fc'),
              ('mlp', 'c_proj'))
_GPT_NORMS = ('ln_1', 'ln_2')
_MOE_STACKS = ('w_gate', 'w_up', 'w_down')


def _gpt_state(take, dense, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """GPT's {port name: f32 tensor} from a reference tree (`take`)."""
    state = {'wte': take('wte'), 'wpe': take('wpe'),
             'ln_f.scale': take('ln_f/scale'), 'ln_f.bias': take('ln_f/bias')}
    for i in range(cfg.num_layers):
        src, dst = f'h_{i}', f'h.{i}'
        for norm in _GPT_NORMS:
            for leaf in ('scale', 'bias'):
                state[f'{dst}.{norm}.{leaf}'] = take(f'{src}/{norm}/{leaf}')
        for group, name in _GPT_DENSE:
            leaf = f'{src}/{group}/{name}'
            state.update(dense(leaf, f'{dst}.{group}.{name}'))
            state[f'{dst}.{group}.{name}.bias'] = take(f'{leaf}/bias')
    return state


def _head_norm_state(take) -> Dict[str, torch.Tensor]:
    return {'tok_embed': take('tok_embed'),
            'lm_head': take('lm_head').T.contiguous(),
            'final_norm.scale': take('final_norm/scale')}


def _mixtral_state(take, dense, cfg: MixtralConfig) -> Dict[str, torch.Tensor]:
    """Mixtral's {port name: tensor} from a reference tree."""
    state = _head_norm_state(take)
    for i in range(cfg.num_layers):
        src, dst = f'layer_{i}', f'layers.{i}'
        for norm in ('attn_norm', 'moe_norm'):
            state[f'{dst}.{norm}.scale'] = take(f'{src}/{norm}/scale')
        for name in _DENSE['attn']:
            state.update(dense(f'{src}/attn/{name}', f'{dst}.attn.{name}'))
        state[f'{dst}.moe.router'] = \
            take(f'{src}/moe/router/kernel').T.contiguous()
        for name in _MOE_STACKS:
            state[f'{dst}.moe.{name}'] = take(f'{src}/moe/{name}')
    return state


def _deepseek_state(take, dense,
                    cfg: DeepseekConfig) -> Dict[str, torch.Tensor]:
    """DeepSeek's {port name: tensor} from a reference tree."""
    state = _head_norm_state(take)
    for i in range(cfg.num_layers):
        src, dst = f'layer_{i}', f'layers.{i}'
        for norm in ('attn_norm', 'mlp_norm'):
            state[f'{dst}.{norm}.scale'] = take(f'{src}/{norm}/scale')
        attn, out = f'{src}/attn', f'{dst}.attn'
        names = (('wq_a', 'wq_b') if cfg.q_lora_rank else ('wq',)) + \
            ('wkv_a', 'wo')
        for name in names:
            state.update(dense(f'{attn}/{name}', f'{out}.{name}'))
        if cfg.q_lora_rank:
            state[f'{out}.q_norm.scale'] = take(f'{attn}/q_norm/scale')
        state[f'{out}.kv_norm.scale'] = take(f'{attn}/kv_norm/scale')
        state[f'{out}.wkv_b'] = take(f'{attn}/wkv_b')
        for name in _DENSE['mlp']:
            state.update(dense(f'{src}/mlp/{name}', f'{dst}.mlp.{name}'))
    return state


_TREE_READERS = {GPTConfig: _gpt_state, MixtralConfig: _mixtral_state,
                 DeepseekConfig: _deepseek_state}


def params_from_jax(tree: Mapping[str, Any], cfg,
                    device: Optional[torch.device] = None,
                    weight_dtype: Optional[str] = None):
    """The config's port model with the weights of a reference param
    tree, stored as `cfg.param_dtype` says (None: serving's layout). A
    tree of the reference's `quantize_params` gives int8 projections as
    they are; `weight_dtype='int8'` quantizes an f32 tree's projection
    kernels (default: the tree's own storage). Raises on any leaf it did
    not consume."""
    flat = _flatten(tree)
    if not isinstance(cfg, LlamaConfig):
        take = _taker(flat, device)
        quantized = any(p.endswith('/' + quant.QUANT_KEY) for p in flat)
        state = _TREE_READERS[type(cfg)](take, _dense_taker(flat, take),
                                         cfg)
        if flat:
            raise ValueError(f'param tree leaves not consumed: '
                             f'{sorted(flat)}')
        if weight_dtype is None:
            weight_dtype = 'int8' if quantized else 'bf16'
        if weight_dtype not in DENSE_CLASSES or (quantized and
                                                  weight_dtype != 'int8'):
            raise ValueError(f'weight_dtype {weight_dtype!r} for a '
                             f'{"quantized" if quantized else "dense"} '
                             f'tree')
        if weight_dtype == 'int8' and not quantized:
            state = quantize_state(state)
        if weight_dtype_of(state) != weight_dtype:
            raise ValueError(f'weight_dtype {weight_dtype!r}: '
                             f'{type(cfg).__name__} has no int8 '
                             f'projections')
        return assemble(cfg, cast_to_layout(cfg, state))
    trainable = cfg.trainable
    quantized = any(p.endswith('/' + quant.QUANT_KEY) for p in flat)
    if weight_dtype is None:
        weight_dtype = 'int8' if quantized else 'bf16'
    if weight_dtype not in DENSE_CLASSES or (quantized and
                                              weight_dtype != 'int8'):
        raise ValueError(f'weight_dtype {weight_dtype!r} for a '
                         f'{"quantized" if quantized else "dense"} tree')

    take = _taker(flat, device)

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


def train_params_from_jax(tree: Mapping[str, Any], cfg,
                          device: Optional[torch.device] = None):
    """The config's port model in training's layout (every leaf an f32
    master, trainable) with the weights of a reference param tree;
    raises on a stray leaf."""
    return params_from_jax(
        tree, dataclasses.replace(cfg, param_dtype=torch.float32), device)


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _gpt_tree(model: GPT) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        'wte': _np32(model.wte), 'wpe': _np32(model.wpe),
        'ln_f': {'scale': _np32(model.ln_f.scale),
                 'bias': _np32(model.ln_f.bias)}}
    for i, block in enumerate(model.h):
        layer: Dict[str, Any] = {
            norm: {'scale': _np32(getattr(block, norm).scale),
                   'bias': _np32(getattr(block, norm).bias)}
            for norm in _GPT_NORMS}
        for group, name in _GPT_DENSE:
            dense = getattr(getattr(block, group), name)
            layer.setdefault(group, {})[name] = {
                'kernel': _np32(dense.weight).T.copy(),
                'bias': _np32(dense.bias)}
        tree[f'h_{i}'] = layer
    return tree


def _mixtral_tree(model: Mixtral) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        'tok_embed': _np32(model.tok_embed),
        'lm_head': _np32(model.lm_head).T.copy(),
        'final_norm': {'scale': _np32(model.final_norm.scale)}}
    for i, block in enumerate(model.layers):
        moe = block.moe
        lo, hi = moe.experts
        if (lo, hi) != (0, model.config.num_experts):
            # The reference's tree holds whole stacks; a sharded model's
            # whole leaves come from its layout (FSDPLayout.full).
            raise ValueError(
                f'layer {i} holds experts [{lo}, {hi}) of '
                f'{model.config.num_experts} (--expert): convert whole '
                f'stacks, gathered as checkpoints gather them')
        tree[f'layer_{i}'] = {
            'attn_norm': {'scale': _np32(block.attn_norm.scale)},
            'moe_norm': {'scale': _np32(block.moe_norm.scale)},
            'attn': {name: {'kernel': _np32(getattr(block.attn, name)
                                            .weight).T.copy()}
                     for name in _DENSE['attn']},
            'moe': {'router': {'kernel': _np32(moe.router).T.copy()},
                    **{name: _np32(getattr(moe, name))
                       for name in _MOE_STACKS}}}
    return tree


def _deepseek_tree(model: Deepseek) -> Dict[str, Any]:
    cfg = model.config
    kernel = lambda dense: {'kernel': _np32(dense.weight).T.copy()}
    tree: Dict[str, Any] = {
        'tok_embed': _np32(model.tok_embed),
        'lm_head': _np32(model.lm_head).T.copy(),
        'final_norm': {'scale': _np32(model.final_norm.scale)}}
    for i, block in enumerate(model.layers):
        attn = block.attn
        a: Dict[str, Any] = {
            'wkv_a': kernel(attn.wkv_a),
            'kv_norm': {'scale': _np32(attn.kv_norm.scale)},
            'wkv_b': _np32(attn.wkv_b), 'wo': kernel(attn.wo)}
        if cfg.q_lora_rank:
            a.update(wq_a=kernel(attn.wq_a), wq_b=kernel(attn.wq_b),
                     q_norm={'scale': _np32(attn.q_norm.scale)})
        else:
            a['wq'] = kernel(attn.wq)
        tree[f'layer_{i}'] = {
            'attn_norm': {'scale': _np32(block.attn_norm.scale)},
            'mlp_norm': {'scale': _np32(block.mlp_norm.scale)},
            'attn': a,
            'mlp': {name: kernel(getattr(block.mlp, name))
                    for name in _DENSE['mlp']}}
    return tree


def train_params_to_jax(model) -> Dict[str, Any]:
    """The reference's param tree (float32 numpy leaves, Dense kernels
    [in, out], `lm_head` [embed, vocab]) of a port model: the inverse
    of `train_params_from_jax`."""
    if isinstance(model, GPT):
        return _gpt_tree(model)
    if isinstance(model, Mixtral):
        return _mixtral_tree(model)
    if isinstance(model, Deepseek):
        return _deepseek_tree(model)
    cfg = model.config
    tree: Dict[str, Any] = {
        'tok_embed': _np32(model.tok_embed),
        'lm_head': _np32(model.lm_head).T.copy(),
        'final_norm': {'scale': _np32(model.final_norm.scale)},
    }
    for i, block in enumerate(model.layers):
        layer: Dict[str, Any] = {
            'attn_norm': {'scale': _np32(block.attn_norm.scale)},
            'mlp_norm': {'scale': _np32(block.mlp_norm.scale)}}
        for group, names in _DENSE.items():
            module = getattr(block, group)
            layer[group] = {}
            for name in names:
                dense = getattr(module, name)
                leaf = {'kernel': _np32(dense.weight).T.copy()}
                if cfg.qkv_bias and name in _QKV:
                    leaf['bias'] = _np32(dense.bias)
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


def init_params(cfg, seed: int = 0,
                device: Optional[torch.device] = None,
                weight_dtype: str = 'bf16'):
    """Seeded random weights of the config's model, generated on
    `device` with one torch.Generator (not the reference's numbers:
    jax.random and torch generators differ), stored as
    `cfg.param_dtype` says. With `weight_dtype='int8'` (every family but
    GPT) each projection named in `quant.WEIGHT_TARGETS` is quantized
    from its f32 draw (the same draws as the bf16 model of this
    seed)."""
    if weight_dtype not in DENSE_CLASSES:
        raise ValueError(f'unsupported weight_dtype {weight_dtype!r}')
    if weight_dtype != 'bf16' and isinstance(cfg, GPTConfig):
        raise ValueError(f'weight_dtype {weight_dtype!r}: '
                         f'{type(cfg).__name__} has no int8 projections')
    gen = torch.Generator(device=device).manual_seed(seed)
    store_dtype = cfg.param_dtype or cfg.dtype

    def normal(*shape, std=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, std, generator=gen)

    ones = lambda n: torch.ones(n, dtype=torch.float32, device=device)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)

    def proj(state, key: str, shape) -> None:
        """Projection `key`'s [out, in] draw, stored or quantized."""
        w = normal(*shape)
        if weight_dtype == 'int8' and key.split('.')[-1] in \
                quant.WEIGHT_TARGETS:
            _store_int8(state, key, w.T)
        else:
            state[f'{key}.weight'] = w.to(store_dtype)

    d = cfg.embed_dim
    if isinstance(cfg, DeepseekConfig):
        return _init_deepseek(cfg, normal, ones, proj, store_dtype)
    if isinstance(cfg, GPTConfig):
        state: Dict[str, torch.Tensor] = {
            'wte': normal(cfg.vocab_size, d),
            'wpe': normal(cfg.block_size, d, std=0.01),
            'ln_f.scale': ones(d), 'ln_f.bias': zeros(d)}
        out_in = {'c_attn': (3 * d, d), 'c_fc': (4 * d, d)}
        for i in range(cfg.num_layers):
            for norm in _GPT_NORMS:
                state[f'h.{i}.{norm}.scale'] = ones(d)
                state[f'h.{i}.{norm}.bias'] = zeros(d)
            for group, name in _GPT_DENSE:
                shape = out_in.get(name, (d, 4 * d if group == 'mlp'
                                          else d))
                state[f'h.{i}.{group}.{name}.weight'] = normal(*shape)
                state[f'h.{i}.{group}.{name}.bias'] = zeros(shape[0])
        return assemble(cfg, cast_to_layout(cfg, state))
    hd = cfg.head_dim
    f = cfg.mlp_dim
    out_in = {'wq': (cfg.num_heads * hd, d), 'wk': (cfg.num_kv_heads * hd, d),
              'wv': (cfg.num_kv_heads * hd, d), 'wo': (d, cfg.num_heads * hd),
              'w_gate': (f, d), 'w_up': (f, d), 'w_down': (d, f)}
    moe = isinstance(cfg, MixtralConfig)
    state = {'tok_embed': normal(cfg.vocab_size, d).to(store_dtype)}
    for i in range(cfg.num_layers):
        dst = f'layers.{i}'
        state[f'{dst}.attn_norm.scale'] = ones(d)
        state[f'{dst}.{"moe" if moe else "mlp"}_norm.scale'] = ones(d)
        for group, names in _DENSE.items():
            if moe and group == 'mlp':
                e = cfg.num_experts
                state[f'{dst}.moe.router'] = normal(e, d)
                for name, shape in (('w_gate', (e, d, f)),
                                    ('w_up', (e, d, f)),
                                    ('w_down', (e, f, d))):
                    state[f'{dst}.moe.{name}'] = \
                        normal(*shape).to(store_dtype)
                continue
            for name in names:
                proj(state, f'{dst}.{group}.{name}', out_in[name])
                if getattr(cfg, 'qkv_bias', False) and name in _QKV:
                    state[f'{dst}.{group}.{name}.bias'] = torch.zeros(
                        out_in[name][0], dtype=store_dtype, device=device)
    state['final_norm.scale'] = ones(d)
    head = normal(cfg.vocab_size, d)
    state['lm_head'] = head if cfg.trainable else _head(head, cfg)
    return assemble(cfg, state)


def _init_deepseek(cfg: DeepseekConfig, normal, ones, proj, store_dtype):
    """`init_params`' DeepSeek branch (its draws, its layout)."""
    d, f, h = cfg.embed_dim, cfg.mlp_dim, cfg.num_heads
    state: Dict[str, torch.Tensor] = {
        'tok_embed': normal(cfg.vocab_size, d).to(store_dtype)}
    for i in range(cfg.num_layers):
        dst = f'layers.{i}'
        attn = f'{dst}.attn'
        state[f'{dst}.attn_norm.scale'] = ones(d)
        state[f'{dst}.mlp_norm.scale'] = ones(d)
        if cfg.q_lora_rank:
            proj(state, f'{attn}.wq_a', (cfg.q_lora_rank, d))
            state[f'{attn}.q_norm.scale'] = ones(cfg.q_lora_rank)
            proj(state, f'{attn}.wq_b', (h * cfg.qk_head_dim,
                                         cfg.q_lora_rank))
        else:
            proj(state, f'{attn}.wq', (h * cfg.qk_head_dim, d))
        proj(state, f'{attn}.wkv_a', (cfg.kv_lora_rank + cfg.rope_head_dim,
                                      d))
        state[f'{attn}.kv_norm.scale'] = ones(cfg.kv_lora_rank)
        state[f'{attn}.wkv_b'] = normal(
            cfg.kv_lora_rank, h,
            cfg.nope_head_dim + cfg.v_head_dim).to(store_dtype)
        proj(state, f'{attn}.wo', (d, h * cfg.v_head_dim))
        for name, shape in (('w_gate', (f, d)), ('w_up', (f, d)),
                            ('w_down', (d, f))):
            proj(state, f'{dst}.mlp.{name}', shape)
    state['final_norm.scale'] = ones(d)
    head = normal(cfg.vocab_size, d)
    state['lm_head'] = head if cfg.trainable else _head(head, cfg)
    return assemble(cfg, state)
