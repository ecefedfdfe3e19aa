"""HuggingFace checkpoint import: a local HF model directory -> the
port's `Llama` (port of skypilot_tpu/models/hf_import.py).

Reads `config.json` and the weights (`model.safetensors`, shards listed
in `model.safetensors.index.json`, or `pytorch_model.bin` through
`torch.load(weights_only=True)`) and maps HF's tensor names onto the
port's modules for the model types `llama`, `mistral` and `qwen2`
(the Llama backbone; Qwen2 adds q/k/v biases, usually with tied
embeddings). `mixtral`, `gpt2` and `deepseek_v2` wait for their model
families (ROADMAP A12). Nothing is downloaded.

Safetensors files are read by this module's own reader
(`read_safetensors`: an 8-byte little-endian header length, a JSON
header of {name: {dtype, shape, data_offsets}}, then the raw bytes;
BF16, F16 and F32), so the `safetensors` package is not needed at run
time. The tokenizer (`load_tokenizer`) needs `transformers`, imported
only when a tokenizer is loaded.

RoPE layout: HF's Llama, Mistral and Qwen2 checkpoints store each
head's q/k rows in the half-split order its `rotate_half` reads, which
is the order the port's `apply_rope` reads, so the rows are taken as
they are (as the reference takes them); `_deinterleave_rope_rows`
converts rows stored as interleaved pairs, the layout of the DeepSeek
family's rope rows.
"""
from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.llama import Llama, LlamaConfig, RopeScaling


class HfImportError(Exception):
    """Unsupported or malformed HF checkpoint."""


#: model types the port imports, and those that wait for their family.
SUPPORTED_MODEL_TYPES = ('llama', 'mistral', 'qwen2')
DEFERRED_MODEL_TYPES = ('deepseek_v2', 'gpt2', 'mixtral')

_ST_DTYPES = {'BF16': (np.int16, torch.bfloat16),
              'F16': (np.float16, torch.float16),
              'F32': (np.float32, torch.float32)}


def read_config(model_dir: str) -> Dict[str, Any]:
    path = os.path.join(model_dir, 'config.json')
    if not os.path.exists(path):
        raise HfImportError(f'no config.json under {model_dir!r} — '
                            'is this a downloaded HF model repo?')
    with open(path, 'r', encoding='utf-8') as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, in its stored dtype, on
    the CPU."""
    with open(path, 'rb') as f:
        (header_len,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(header_len))
    header.pop('__metadata__', None)
    data = np.memmap(path, dtype=np.uint8, mode='r', offset=8 + header_len)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info['dtype'] not in _ST_DTYPES:
            raise HfImportError(f'{path}: tensor {name!r} has dtype '
                                f'{info["dtype"]}; the reader takes '
                                f'{", ".join(_ST_DTYPES)}')
        np_dtype, dtype = _ST_DTYPES[info['dtype']]
        begin, end = info['data_offsets']
        # The bytes are little-endian, as the hosts this runs on.
        arr = np.array(data[begin:end]).view(np_dtype)
        out[name] = torch.from_numpy(arr).view(dtype).reshape(info['shape'])
    return out


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors of the checkpoint, in their stored dtype, from
    safetensors (single or sharded through the index file) or a
    pytorch_model.bin."""
    index = os.path.join(model_dir, 'model.safetensors.index.json')
    single = os.path.join(model_dir, 'model.safetensors')
    if os.path.exists(index):
        with open(index, 'r', encoding='utf-8') as f:
            weight_map = json.load(f)['weight_map']
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(read_safetensors(os.path.join(model_dir, shard)))
        return out
    if os.path.exists(single):
        return read_safetensors(single)
    torch_bin = os.path.join(model_dir, 'pytorch_model.bin')
    if os.path.exists(torch_bin):
        return torch.load(torch_bin, map_location='cpu', weights_only=True)
    raise HfImportError(
        f'no model.safetensors[.index.json] or pytorch_model.bin '
        f'under {model_dir!r}')


def _deinterleave_rope_rows(w: torch.Tensor, rope_dim: int) -> torch.Tensor:
    """Permute the LAST `rope_dim` output rows of a [out, in] weight
    (or [out] bias) from interleaved pairs ((x0,x1),(x2,x3),...) to the
    half-split layout ((x0,x2,...),(x1,x3,...)) `apply_rope` reads."""
    head, rope = w[:-rope_dim], w[-rope_dim:]
    perm = torch.cat([torch.arange(0, rope_dim, 2),
                      torch.arange(1, rope_dim, 2)])
    return torch.cat([head, rope[perm]], dim=0)


def _parse_rope_scaling(cfg_json: Dict[str, Any]) -> Optional[RopeScaling]:
    """config.json `rope_scaling` -> RopeScaling (or None). llama3 and
    linear are supported; any other scheme (yarn, dynamic, longrope)
    raises, since importing it without its rescaling would give
    silently wrong logits."""
    rs = cfg_json.get('rope_scaling')
    if rs is None:
        return None
    rope_type = rs.get('rope_type') or rs.get('type')
    if rope_type in (None, 'default'):
        return None
    try:
        if rope_type == 'llama3':
            return RopeScaling(
                rope_type='llama3',
                factor=float(rs['factor']),
                low_freq_factor=float(rs.get('low_freq_factor', 1.0)),
                high_freq_factor=float(rs.get('high_freq_factor', 4.0)),
                original_max_position_embeddings=int(
                    rs['original_max_position_embeddings']))
        if rope_type == 'linear':
            return RopeScaling(rope_type='linear',
                               factor=float(rs['factor']))
    except KeyError as e:
        raise HfImportError(
            f'rope_scaling block is missing required key {e} for '
            f'rope_type {rope_type!r}: {rs!r}') from e
    raise HfImportError(
        f'rope_scaling type {rope_type!r} is not supported (supported: '
        f'llama3, linear) — importing this checkpoint without its '
        f'frequency rescaling would produce silently wrong logits.')


def _convert_llama_like(cfg_json: Dict[str, Any],
                        sd: Dict[str, torch.Tensor],
                        max_seq_len: Optional[int], **config_overrides
                        ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """(config, {port parameter name: tensor}) of a llama, mistral or
    qwen2 checkpoint; tensors keep their stored dtype."""
    num_layers = cfg_json['num_hidden_layers']
    common = dict(
        vocab_size=cfg_json['vocab_size'],
        max_seq_len=max_seq_len or cfg_json['max_position_embeddings'],
        num_layers=num_layers,
        num_heads=cfg_json['num_attention_heads'],
        num_kv_heads=cfg_json.get('num_key_value_heads',
                                  cfg_json['num_attention_heads']),
        embed_dim=cfg_json['hidden_size'],
        mlp_dim=cfg_json['intermediate_size'],
        rope_theta=float(cfg_json.get('rope_theta', 10000.0)),
        rope_scaling=_parse_rope_scaling(cfg_json),
        norm_eps=float(cfg_json.get('rms_norm_eps', 1e-5)),
    )
    # Qwen2-family variant: q/k/v biases, detected from the checkpoint.
    qkv_bias = 'model.layers.0.self_attn.q_proj.bias' in sd
    if qkv_bias:
        common['qkv_bias'] = True
    common.update(config_overrides)
    state: Dict[str, torch.Tensor] = {
        'tok_embed': sd['model.embed_tokens.weight'],
        'final_norm.scale': sd['model.norm.weight'],
        'lm_head': (sd['model.embed_tokens.weight']
                    if cfg_json.get('tie_word_embeddings')
                    else sd['lm_head.weight']),
    }
    names = {'attn.wq': 'self_attn.q_proj', 'attn.wk': 'self_attn.k_proj',
             'attn.wv': 'self_attn.v_proj', 'attn.wo': 'self_attn.o_proj',
             'mlp.w_gate': 'mlp.gate_proj', 'mlp.w_up': 'mlp.up_proj',
             'mlp.w_down': 'mlp.down_proj'}
    for i in range(num_layers):
        src, dst = f'model.layers.{i}.', f'layers.{i}.'
        state[dst + 'attn_norm.scale'] = sd[src + 'input_layernorm.weight']
        state[dst + 'mlp_norm.scale'] = \
            sd[src + 'post_attention_layernorm.weight']
        for ours, theirs in names.items():
            # nn.Linear's [out, in] is HF's layout: no transpose.
            state[f'{dst}{ours}.weight'] = sd[f'{src}{theirs}.weight']
            if qkv_bias and ours in ('attn.wq', 'attn.wk', 'attn.wv'):
                state[f'{dst}{ours}.bias'] = sd[f'{src}{theirs}.bias']
    return LlamaConfig(**common), state


def load_hf_checkpoint(model_dir: str, *, max_seq_len: Optional[int] = None,
                       device: Optional[torch.device] = None,
                       **config_overrides) -> Tuple[LlamaConfig, Llama]:
    """(config, model) from a local HF model directory, the weights on
    `device` stored as the config's layout says (serving's by default;
    `param_dtype=torch.float32` keeps f32 masters).

    `max_seq_len` overrides the checkpoint's max_position_embeddings
    (serve_lm passes its --max-total-len). `config_overrides` go into
    the LlamaConfig (e.g. `dtype=torch.float32` for CPU parity runs,
    `kv_dtype`, `kv_total_pages`)."""
    cfg_json = read_config(model_dir)
    model_type = cfg_json.get('model_type')
    if model_type in DEFERRED_MODEL_TYPES:
        raise HfImportError(
            f'model_type {model_type!r} is not ported yet: its model '
            f'family waits for ROADMAP A12; this port imports '
            f'{", ".join(SUPPORTED_MODEL_TYPES)}')
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise HfImportError(
            f'unsupported model_type {model_type!r}; supported: '
            f'{", ".join(SUPPORTED_MODEL_TYPES)}')
    trained_ctx = cfg_json.get('max_position_embeddings')
    if max_seq_len is not None and trained_ctx and \
            max_seq_len > trained_ctx:
        warnings.warn(
            f'max_seq_len={max_seq_len} exceeds the checkpoint\'s '
            f'trained context ({trained_ctx}): rope positions beyond '
            f'it are untrained extrapolation — expect degraded output '
            f'past {trained_ctx} tokens.', stacklevel=2)
    # Refuse unsupported scalings before reading gigabytes of weights.
    _parse_rope_scaling(cfg_json)
    sd = load_state_dict(model_dir)
    cfg, state = _convert_llama_like(cfg_json, sd, max_seq_len,
                                     **config_overrides)
    _validate_against_init(cfg, state)
    del sd
    return cfg, convert.assemble(cfg, convert.cast_to_layout(cfg, state,
                                                             device))


def _validate_against_init(cfg: LlamaConfig,
                           state: Dict[str, torch.Tensor]) -> None:
    """The converted state must have exactly the model's parameter
    names and shapes: mapping drift fails loudly here, not at run
    time."""
    with torch.device('meta'):
        ref = {k: tuple(v.shape) for k, v in Llama(cfg).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(set(ref) - set(got))
    extra = sorted(set(got) - set(ref))
    bad_shape = sorted((k, got[k], ref[k]) for k in set(ref) & set(got)
                       if got[k] != ref[k])
    if missing or extra or bad_shape:
        raise HfImportError(
            f'converted params do not match the model: '
            f'missing={missing[:5]} extra={extra[:5]} '
            f'shape-mismatches={bad_shape[:5]}')


def load_tokenizer(model_dir: str):
    """transformers AutoTokenizer over the local files (no network)."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(model_dir, local_files_only=True)

