"""Package rules of the PyTorch/CUDA port (skypilot_tpu_torch/):

  - neither the package nor chip_smoke.py / profile_decode.py imports
    jax, flax, optax,
    ml_dtypes or skypilot_tpu (an AST scan), and serve_lm imports with
    JAX made unimportable;
  - entry points default to CUDA and raise without it unless the CPU
    was asked for; serve_lm without --cpu exits non-zero saying so;
  - impl='cuda' on CPU tensors raises; unsupported serve_lm flags exit
    naming the flag;
  - kv pool sizing by bytes matches the reference's arithmetic.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from skypilot_tpu.inference import quant as jax_quant
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch import device as device_lib
from skypilot_tpu_torch.inference import quant
from skypilot_tpu_torch.models import registry
from skypilot_tpu_torch.ops import paged_kernel as pk
from skypilot_tpu_torch.recipes import serve_lm

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'flax', 'optax', 'ml_dtypes', 'skypilot_tpu')


def _sources():
    return sorted((ROOT / 'skypilot_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'profile_decode.py']


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_no_jax_or_reference_imports():
    sources = _sources()
    assert len(sources) > 15
    bad = [(str(p.relative_to(ROOT)), mod) for p in sources
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert not bad, bad


def _run(code, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_lm_imports_without_jax():
    code = ('import sys\n'
            'for m in ("jax", "flax", "optax", "ml_dtypes", '
            '"skypilot_tpu"):\n'
            '    sys.modules[m] = None\n'
            'import skypilot_tpu_torch.recipes.serve_lm\n'
            'import skypilot_tpu_torch.inference.http_server\n'
            'import skypilot_tpu_torch.models.batching\n'
            'print("ok")\n')
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(device_lib.NoCudaDeviceError, match='--cpu'):
        device_lib.resolve_device()
    assert device_lib.resolve_device(cpu=True) == torch.device('cpu')
    assert device_lib.resolve_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert device_lib.resolve_device() == torch.device('cuda', 0)


def test_serve_lm_without_cpu_flag_exits_on_gpu_less_box():
    out = _run('from skypilot_tpu_torch.recipes import serve_lm\n'
               'serve_lm.main(["--model", "llama-tiny", '
               '"--continuous-batching", "--port", "0"])\n')
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr


def test_cuda_impl_on_cpu_tensors_raises():
    q = torch.zeros(1, 1, 2, 16)
    pages = torch.zeros(1, 4, 8, 16)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    tbl = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        pk.fused_paged_attention(q, pages, pages, pos, tbl, impl='cuda')
    with pk.impl_scope('cuda'):
        with pytest.raises(RuntimeError):
            pk.fused_paged_attention(q, pages, pages, pos, tbl)
    with pytest.raises(ValueError):
        pk.resolve_impl('fused')
    assert pk.resolve_impl('auto', torch.device('cpu')) == 'torch'
    assert pk.resolve_impl('auto', torch.device('cuda')) == 'cuda'
    with pk.impl_scope('torch'):
        assert pk.resolve_impl('auto', torch.device('cuda')) == 'torch'
    assert not pk.available() and pk.unavailable_reason()


@pytest.mark.parametrize('argv,flag', [
    (['--speculative', '4'], '--speculative'),
    (['--tensor', '2'], '--tensor'),
    (['--kv-spill-bytes', '1024'], '--kv-spill-bytes'),
    (['--weight-dtype', 'int8'], '--weight-dtype'),
    (['--role', 'prefill'], '--role'),
])
def test_unsupported_flag_exits_with_its_name(argv, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_lm.parse_args(['--cpu', '--continuous-batching'] + argv)
    assert exc.value.code != 0
    assert flag in capsys.readouterr().err


def test_continuous_batching_is_required(capsys):
    with pytest.raises(SystemExit):
        serve_lm.parse_args(['--cpu'])
    assert '--continuous-batching' in capsys.readouterr().err


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_pool_sizing_matches_reference(kv_dtype):
    port_cfg = registry.model_config('llama3-8b', 1024)
    ref_cfg = jax_llama.LlamaConfig.llama3_8b(max_seq_len=2048)
    assert port_cfg.max_seq_len == ref_cfg.max_seq_len
    for name in ('num_layers', 'num_heads', 'num_kv_heads', 'embed_dim',
                 'mlp_dim', 'vocab_size', 'kv_page_size', 'head_dim'):
        assert getattr(port_cfg, name) == getattr(ref_cfg, name), name
    assert quant.kv_page_bytes(port_cfg, kv_dtype) == \
        jax_quant.kv_page_bytes(ref_cfg, kv_dtype)
    assert quant.pool_pages_for_bytes(port_cfg, kv_dtype, 8 * 10**9) == \
        jax_quant.pool_pages_for_bytes(ref_cfg, kv_dtype, 8 * 10**9)
    tiny = dataclasses.replace(registry.model_config('llama-tiny', 512),
                               dtype=torch.float32)
    ref_tiny = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    assert tiny.kv_total_pages == 2 * ref_tiny.kv_total_pages
    assert quant.kv_page_bytes(tiny, kv_dtype) == \
        jax_quant.kv_page_bytes(ref_tiny, kv_dtype)
