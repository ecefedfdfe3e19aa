"""Named model configurations (port of skypilot_tpu/recipes/train_lm.py:37-98
`_build_model`): the Llama family, GPT-2, Mixtral and DeepSeek."""
from __future__ import annotations

import dataclasses

import torch

from skypilot_tpu_torch.models.deepseek import DeepseekConfig
from skypilot_tpu_torch.models.gpt import GPTConfig
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.models.mixtral import MixtralConfig

MODELS = ('llama3-8b', 'llama-tiny', 'qwen2-7b', 'qwen-tiny',
          'gpt2-124m', 'tiny', 'mixtral-8x7b', 'mixtral-tiny',
          'deepseek-v2-lite', 'deepseek-tiny')


def model_config(name: str, seq: int):
    """The config `serve_lm --model name --max-total-len seq` serves."""
    if name == 'gpt2-124m':
        return GPTConfig.gpt2_124m()
    if name == 'tiny':
        return GPTConfig.tiny()
    if name == 'mixtral-8x7b':
        return MixtralConfig.mixtral_8x7b()
    if name == 'mixtral-tiny':
        return MixtralConfig.tiny()
    if name == 'llama3-8b':
        return LlamaConfig.llama3_8b(max_seq_len=max(seq, 2048))
    if name == 'llama-tiny':
        cfg = LlamaConfig.tiny()
        if seq > cfg.max_seq_len:
            # Long-context runs on the tiny model: grow the context and
            # the page pool together (same full-depth slot coverage).
            grow = -(-seq // cfg.max_seq_len)
            cfg = dataclasses.replace(
                cfg, max_seq_len=seq,
                kv_total_pages=cfg.kv_total_pages * grow)
        return cfg
    if name == 'qwen2-7b':
        return LlamaConfig(vocab_size=152064, num_layers=28, num_heads=28,
                           num_kv_heads=4, embed_dim=3584, mlp_dim=18944,
                           rope_theta=1e6, norm_eps=1e-6,
                           max_seq_len=max(seq, 2048), qkv_bias=True)
    if name == 'qwen-tiny':
        return LlamaConfig.tiny(qkv_bias=True)
    if name == 'deepseek-v2-lite':
        return DeepseekConfig.v2_lite(max_seq_len=max(seq, 4096))
    if name == 'deepseek-tiny':
        return DeepseekConfig.tiny()
    raise ValueError(f'unknown model {name!r} (this port runs: '
                     f'{", ".join(MODELS)})')


def train_config(name: str, seq: int, remat: bool = False):
    """The config `train_lm --model name --seq seq [--remat]` trains:
    the serving config's geometry with f32 master parameters."""
    return dataclasses.replace(model_config(name, seq),
                               param_dtype=torch.float32, remat=remat)
