"""Weights for the port's `Llama`: from a Flax param tree, or a seeded
init on the device.

`params_from_jax` maps the tree that the reference's
`model.init(...)['params']` gives (every leaf as a float32 numpy array;
Dense kernels stored [in, out]) onto the port's modules, and raises on
any leaf it did not consume; `lora_from_jax` does the same for LoRA
factor trees. `init_params` is the seeded init the card
uses: normal(0, 0.02) for Dense kernels, the embedding and the head,
ones for norms, zeros for biases. Nothing is downloaded.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import Llama, LlamaConfig

_DENSE = {'attn': ('wq', 'wk', 'wv', 'wo'),
          'mlp': ('w_gate', 'w_up', 'w_down')}
_QKV = ('wq', 'wk', 'wv')


def assemble(cfg: LlamaConfig, state: Mapping[str, torch.Tensor]) -> Llama:
    """A `Llama` whose parameters ARE the given tensors (no copy): the
    module is built on the meta device and the tensors assigned. Also
    how two configs that differ only in their KV pool share weights."""
    with torch.device('meta'):
        model = Llama(cfg)
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model


def _head(w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    # The head multiplies bf16 operands into an f32 result: store the
    # operand already rounded to the compute dtype, in f32.
    return w.to(cfg.dtype).float()


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig,
                    device: Optional[torch.device] = None) -> Llama:
    """Port `Llama` with the weights of a reference param tree."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f'{prefix}{key}'
            if isinstance(val, Mapping):
                walk(val, path + '/')
            else:
                flat[path] = np.asarray(val, np.float32)

    walk(tree, '')

    def take(path: str) -> torch.Tensor:
        if path not in flat:
            raise KeyError(f'param tree has no leaf {path!r}')
        return torch.tensor(flat.pop(path), device=device)

    state: Dict[str, torch.Tensor] = {
        'tok_embed': take('tok_embed').to(cfg.dtype),
        'lm_head': _head(take('lm_head').T.contiguous(), cfg),
        'final_norm.scale': take('final_norm/scale'),
    }
    for i in range(cfg.num_layers):
        src, dst = f'layer_{i}', f'layers.{i}'
        for norm in ('attn_norm', 'mlp_norm'):
            state[f'{dst}.{norm}.scale'] = take(f'{src}/{norm}/scale')
        for group, names in _DENSE.items():
            for name in names:
                kernel = take(f'{src}/{group}/{name}/kernel')
                state[f'{dst}.{group}.{name}.weight'] = \
                    kernel.T.contiguous().to(cfg.dtype)
                if cfg.qkv_bias and name in _QKV:
                    state[f'{dst}.{group}.{name}.bias'] = take(
                        f'{src}/{group}/{name}/bias').to(cfg.dtype)
    if flat:
        raise ValueError(f'param tree leaves not consumed: {sorted(flat)}')
    return assemble(cfg, state)


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
                device: Optional[torch.device] = None) -> Llama:
    """Seeded random weights, generated on `device` with one
    torch.Generator (not the reference's numbers: jax.random and
    torch generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)

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
        'tok_embed': normal(cfg.vocab_size, d).to(cfg.dtype)}
    for i in range(cfg.num_layers):
        dst = f'layers.{i}'
        state[f'{dst}.attn_norm.scale'] = ones(d)
        state[f'{dst}.mlp_norm.scale'] = ones(d)
        for group, names in _DENSE.items():
            for name in names:
                state[f'{dst}.{group}.{name}.weight'] = \
                    normal(*out_in[name]).to(cfg.dtype)
                if cfg.qkv_bias and name in _QKV:
                    state[f'{dst}.{group}.{name}.bias'] = torch.zeros(
                        out_in[name][0], dtype=cfg.dtype, device=device)
    state['final_norm.scale'] = ones(d)
    state['lm_head'] = _head(normal(cfg.vocab_size, d), cfg)
    return assemble(cfg, state)
