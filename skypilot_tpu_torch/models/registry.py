"""Named model configurations (port of the Llama-family entries of
skypilot_tpu/recipes/train_lm.py:37-98 `_build_model`)."""
from __future__ import annotations

import dataclasses

from skypilot_tpu_torch.models.llama import LlamaConfig

MODELS = ('llama3-8b', 'llama-tiny', 'qwen2-7b', 'qwen-tiny')


def model_config(name: str, seq: int) -> LlamaConfig:
    """The config `serve_lm --model name --max-total-len seq` serves."""
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
    raise ValueError(f'unknown model {name!r} (this port serves: '
                     f'{", ".join(MODELS)})')
