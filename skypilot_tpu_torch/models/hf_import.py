"""HuggingFace checkpoint import: a local HF model directory -> the
port's `Llama`, `GPT`, `Mixtral` or `Deepseek` (port of
skypilot_tpu/models/hf_import.py).

Reads `config.json` and the weights (`model.safetensors`, shards listed
in `model.safetensors.index.json`, or `pytorch_model.bin` through
`torch.load(weights_only=True)`) and maps HF's tensor names onto the
port's modules for the model types `llama`, `mistral` and `qwen2`
(the Llama backbone; Qwen2 adds q/k/v biases, usually with tied
embeddings), `mixtral` (the same backbone with a routed MoE: each
expert's w1 / w3 / w2 stacked into [E, in, out], and capacity_factor
E / K by default, so no routed token is dropped, as the reference
imports it) and `gpt2` (HF's Conv1D weights are [in, out], transposed
to the port's [out, in]; `wpe` cut to the block size, which may not
exceed n_positions) and `deepseek_v2` (MLA with dense SwiGLU layers: the
rope rows of each q head and of kv_a's last d_rope rows de-interleaved,
`kv_b_proj` reshaped to [d_c, H, nope + v]; a checkpoint with routed
experts is refused before any weight is read, and `rope_scaling`
refused, as the reference refuses them). Nothing is downloaded.

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
from skypilot_tpu_torch.models.deepseek import DeepseekConfig
from skypilot_tpu_torch.models.gpt import GPTConfig
from skypilot_tpu_torch.models.llama import (DENSE_CLASSES, LlamaConfig,
                                             RopeScaling)
from skypilot_tpu_torch.models.mixtral import MixtralConfig


class HfImportError(Exception):
    """Unsupported or malformed HF checkpoint."""


#: model types the port imports, and the config class of each.
_CONFIG_TYPES = {'llama': LlamaConfig, 'mistral': LlamaConfig,
                 'qwen2': LlamaConfig, 'mixtral': MixtralConfig,
                 'gpt2': GPTConfig, 'deepseek_v2': DeepseekConfig}
SUPPORTED_MODEL_TYPES = tuple(_CONFIG_TYPES)

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


def _convert_mixtral(cfg_json: Dict[str, Any], sd: Dict[str, torch.Tensor],
                     max_seq_len: Optional[int], **config_overrides
                     ) -> Tuple[MixtralConfig, Dict[str, torch.Tensor]]:
    """(config, state) of a mixtral checkpoint: the Llama backbone's
    attention and norms, `block_sparse_moe.gate` as the router, experts
    w1 (gate), w3 (up) and w2 (down) transposed and stacked."""
    n_exp = cfg_json['num_local_experts']
    top_k = cfg_json['num_experts_per_tok']
    common = dict(
        vocab_size=cfg_json['vocab_size'],
        max_seq_len=max_seq_len or cfg_json['max_position_embeddings'],
        num_layers=cfg_json['num_hidden_layers'],
        num_heads=cfg_json['num_attention_heads'],
        num_kv_heads=cfg_json.get('num_key_value_heads',
                                  cfg_json['num_attention_heads']),
        embed_dim=cfg_json['hidden_size'],
        mlp_dim=cfg_json['intermediate_size'],
        rope_theta=float(cfg_json.get('rope_theta', 10000.0)),
        rope_scaling=_parse_rope_scaling(cfg_json),
        norm_eps=float(cfg_json.get('rms_norm_eps', 1e-5)),
        num_experts=n_exp, experts_per_token=top_k,
        # Capacity = seq: no routed token is dropped (the reference's
        # inference default for imported checkpoints).
        capacity_factor=float(n_exp) / float(top_k))
    common.update(config_overrides)
    state: Dict[str, torch.Tensor] = {
        'tok_embed': sd['model.embed_tokens.weight'],
        'final_norm.scale': sd['model.norm.weight'],
        'lm_head': (sd['model.embed_tokens.weight']
                    if cfg_json.get('tie_word_embeddings')
                    else sd['lm_head.weight']),
    }
    attn = {'wq': 'q_proj', 'wk': 'k_proj', 'wv': 'v_proj', 'wo': 'o_proj'}
    for i in range(common['num_layers']):
        src, dst = f'model.layers.{i}.', f'layers.{i}.'
        state[dst + 'attn_norm.scale'] = sd[src + 'input_layernorm.weight']
        state[dst + 'moe_norm.scale'] = \
            sd[src + 'post_attention_layernorm.weight']
        for ours, theirs in attn.items():
            state[f'{dst}attn.{ours}.weight'] = \
                sd[f'{src}self_attn.{theirs}.weight']
        moe = src + 'block_sparse_moe.'
        state[dst + 'moe.router'] = sd[moe + 'gate.weight']
        for ours, theirs in (('w_gate', 'w1'), ('w_up', 'w3'),
                             ('w_down', 'w2')):
            state[f'{dst}moe.{ours}'] = torch.stack([
                sd[f'{moe}experts.{j}.{theirs}.weight'].T
                for j in range(n_exp)])
    return MixtralConfig(**common), state


def _convert_gpt2(cfg_json: Dict[str, Any], sd: Dict[str, torch.Tensor],
                  max_seq_len: Optional[int], **config_overrides
                  ) -> Tuple[GPTConfig, Dict[str, torch.Tensor]]:
    """(config, state) of a gpt2 checkpoint (tensor names with or
    without the 'transformer.' prefix)."""
    cfg = GPTConfig(
        vocab_size=cfg_json['vocab_size'],
        block_size=max_seq_len or cfg_json['n_positions'],
        num_layers=cfg_json['n_layer'],
        num_heads=cfg_json['n_head'],
        embed_dim=cfg_json['n_embd'],
        norm_eps=float(cfg_json.get('layer_norm_epsilon', 1e-5)),
        **config_overrides)

    def g(key: str) -> torch.Tensor:
        val = sd.get('transformer.' + key, sd.get(key))
        if val is None:
            raise HfImportError(
                f'checkpoint is missing tensor {key!r} (tried '
                f'"transformer.{key}" and "{key}")')
        return val

    state: Dict[str, torch.Tensor] = {
        'wte': g('wte.weight'), 'wpe': g('wpe.weight')[:cfg.block_size],
        'ln_f.scale': g('ln_f.weight'), 'ln_f.bias': g('ln_f.bias')}
    for i in range(cfg.num_layers):
        src, dst = f'h.{i}.', f'h.{i}.'
        for norm in ('ln_1', 'ln_2'):
            state[f'{dst}{norm}.scale'] = g(f'{src}{norm}.weight')
            state[f'{dst}{norm}.bias'] = g(f'{src}{norm}.bias')
        for name in ('attn.c_attn', 'attn.c_proj', 'mlp.c_fc',
                     'mlp.c_proj'):
            # Conv1D stores [in, out]; the port's Dense is [out, in].
            state[f'{dst}{name}.weight'] = \
                g(f'{src}{name}.weight').T.contiguous()
            state[f'{dst}{name}.bias'] = g(f'{src}{name}.bias')
    return cfg, state


def _convert_deepseek(cfg_json: Dict[str, Any],
                      sd: Dict[str, torch.Tensor],
                      max_seq_len: Optional[int], **config_overrides
                      ) -> Tuple[DeepseekConfig, Dict[str, torch.Tensor]]:
    """(config, state) of a dense-MLP deepseek_v2 checkpoint (the
    reference's `_convert_deepseek`)."""
    if _parse_rope_scaling(cfg_json) is not None:
        raise HfImportError(
            'rope_scaling is not supported for deepseek_v2 imports yet')
    num_layers = cfg_json['num_hidden_layers']
    rope_dim = cfg_json['qk_rope_head_dim']
    nope_dim = cfg_json['qk_nope_head_dim']
    num_heads = cfg_json['num_attention_heads']
    q_lora = cfg_json.get('q_lora_rank') or 0
    common = dict(
        vocab_size=cfg_json['vocab_size'],
        max_seq_len=max_seq_len or cfg_json['max_position_embeddings'],
        num_layers=num_layers, num_heads=num_heads,
        embed_dim=cfg_json['hidden_size'],
        mlp_dim=cfg_json['intermediate_size'],
        kv_lora_rank=cfg_json['kv_lora_rank'], q_lora_rank=q_lora,
        rope_head_dim=rope_dim, nope_head_dim=nope_dim,
        v_head_dim=cfg_json['v_head_dim'],
        rope_theta=float(cfg_json.get('rope_theta', 10000.0)),
        norm_eps=float(cfg_json.get('rms_norm_eps', 1e-6)))
    common.update(config_overrides)
    cfg = DeepseekConfig(**common)

    def fix_q(w: torch.Tensor) -> torch.Tensor:
        """De-interleave the rope rows of each head of a q projection
        ([H * (nope + rope), in])."""
        heads = w.reshape(num_heads, nope_dim + rope_dim, -1)
        return torch.stack([_deinterleave_rope_rows(h, rope_dim)
                            for h in heads]).reshape(
                                num_heads * (nope_dim + rope_dim), -1)

    state: Dict[str, torch.Tensor] = {
        'tok_embed': sd['model.embed_tokens.weight'],
        'final_norm.scale': sd['model.norm.weight'],
        'lm_head': (sd['model.embed_tokens.weight']
                    if cfg_json.get('tie_word_embeddings')
                    else sd['lm_head.weight']),
    }
    for i in range(num_layers):
        src, dst = f'model.layers.{i}.', f'layers.{i}.'
        attn, out = src + 'self_attn.', dst + 'attn.'
        state[dst + 'attn_norm.scale'] = sd[src + 'input_layernorm.weight']
        state[dst + 'mlp_norm.scale'] = \
            sd[src + 'post_attention_layernorm.weight']
        if q_lora:
            state[out + 'wq_a.weight'] = sd[attn + 'q_a_proj.weight']
            state[out + 'q_norm.scale'] = sd[attn + 'q_a_layernorm.weight']
            state[out + 'wq_b.weight'] = fix_q(sd[attn + 'q_b_proj.weight'])
        else:
            state[out + 'wq.weight'] = fix_q(sd[attn + 'q_proj.weight'])
        # kv_a's rope rows are the last d_rope of its output.
        state[out + 'wkv_a.weight'] = _deinterleave_rope_rows(
            sd[attn + 'kv_a_proj_with_mqa.weight'], rope_dim)
        state[out + 'kv_norm.scale'] = sd[attn + 'kv_a_layernorm.weight']
        # [H * (nope + v), d_c] -> [d_c, H, nope + v]
        state[out + 'wkv_b'] = sd[attn + 'kv_b_proj.weight'].T.reshape(
            cfg.kv_lora_rank, num_heads, nope_dim + cfg.v_head_dim)
        state[out + 'wo.weight'] = sd[attn + 'o_proj.weight']
        for ours, theirs in (('w_gate', 'gate_proj'), ('w_up', 'up_proj'),
                             ('w_down', 'down_proj')):
            state[f'{dst}mlp.{ours}.weight'] = \
                sd[f'{src}mlp.{theirs}.weight']
    return cfg, state


_CONVERTERS = {LlamaConfig: _convert_llama_like,
               MixtralConfig: _convert_mixtral, GPTConfig: _convert_gpt2,
               DeepseekConfig: _convert_deepseek}


def config_type(model_dir: str) -> type:
    """The port's config class for a checkpoint's model_type (reads
    config.json only); raises HfImportError on a type not imported."""
    model_type = read_config(model_dir).get('model_type')
    if model_type not in _CONFIG_TYPES:
        raise HfImportError(
            f'unsupported model_type {model_type!r}; supported: '
            f'{", ".join(SUPPORTED_MODEL_TYPES)}')
    return _CONFIG_TYPES[model_type]


def load_hf_checkpoint(model_dir: str, *, max_seq_len: Optional[int] = None,
                       device: Optional[torch.device] = None,
                       weight_dtype: str = 'bf16',
                       **config_overrides) -> Tuple[Any, Any]:
    """(config, model) from a local HF model directory (`Llama`, `GPT`,
    `Mixtral` or `Deepseek` by its model_type), the weights on
    `device` stored as the config's layout says (serving's by default;
    `param_dtype=torch.float32` keeps f32 masters). `weight_dtype='int8'`
    quantizes each projection from the checkpoint's values upcast to
    f32, before the cast to the layout (the reference quantizes its raw
    f32 `hf_params`).

    `max_seq_len` overrides the checkpoint's max_position_embeddings
    (serve_lm passes its --max-total-len). `config_overrides` go into
    the config (e.g. `dtype=torch.float32` for CPU parity runs,
    `kv_dtype`, `kv_total_pages`, Mixtral's `capacity_factor`)."""
    if weight_dtype not in DENSE_CLASSES:
        raise ValueError(f'unsupported weight_dtype {weight_dtype!r}')
    cfg_type = config_type(model_dir)
    cfg_json = read_config(model_dir)
    trained_ctx = (cfg_json.get('n_positions')
                   or cfg_json.get('max_position_embeddings'))
    if max_seq_len is not None and trained_ctx and \
            max_seq_len > trained_ctx:
        if cfg_type is GPTConfig:
            raise HfImportError(
                f'max_seq_len={max_seq_len} exceeds the checkpoint\'s '
                f'trained context (n_positions={trained_ctx}) — GPT-2\'s '
                f'absolute position embeddings cannot extrapolate. '
                f'Serve with --max-total-len <= {trained_ctx}.')
        warnings.warn(
            f'max_seq_len={max_seq_len} exceeds the checkpoint\'s '
            f'trained context ({trained_ctx}): rope positions beyond '
            f'it are untrained extrapolation — expect degraded output '
            f'past {trained_ctx} tokens.', stacklevel=2)
    # Refuse unsupported scalings before reading gigabytes of weights.
    _parse_rope_scaling(cfg_json)
    if cfg_type is DeepseekConfig and cfg_json.get('n_routed_experts'):
        # Refused before any weight is read, as the reference does.
        raise HfImportError(
            'DeepSeek V2 checkpoints with routed-expert (MoE) layers '
            'are not supported yet — the in-framework deepseek family '
            'is MLA + dense SwiGLU. Use a dense-MLP export, or the '
            'mixtral family for MoE serving.')
    sd = load_state_dict(model_dir)
    cfg, state = _CONVERTERS[cfg_type](cfg_json, sd, max_seq_len,
                                       **config_overrides)
    _validate_against_init(cfg, state)
    del sd
    if weight_dtype == 'int8':
        state = convert.quantize_state(state, device)
    return cfg, convert.assemble(cfg, convert.cast_to_layout(cfg, state,
                                                             device))


def _validate_against_init(cfg, state: Dict[str, torch.Tensor]) -> None:
    """The converted state must have exactly the model's parameter
    names and shapes: mapping drift fails loudly here, not at run
    time."""
    with torch.device('meta'):
        ref = {k: tuple(v.shape) for k, v in
               convert.model_class(cfg)(cfg).state_dict().items()}
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

