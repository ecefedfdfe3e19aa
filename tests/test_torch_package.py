"""Package rules of the PyTorch/CUDA port (skypilot_tpu_torch/):

  - neither the package nor chip_smoke.py / profile_*.py imports
    jax, flax, optax, orbax,
    ml_dtypes, requests or skypilot_tpu (an AST scan), and serve_lm and train_lm
    import with those made unimportable;
  - entry points default to CUDA and raise without it unless the CPU
    was asked for; serve_lm without --cpu exits non-zero saying so;
  - no module of the package imports transformers or safetensors at
    module level (the card has neither; the tokenizer loader imports
    transformers when it is called);
  - impl='cuda' on CPU tensors raises; unsupported serve_lm flags exit
    naming the flag, and int8 KV pages without --continuous-batching
    exit with the reference's message; --weight-dtype int8 parses with
    and without --continuous-batching, and with --ckpt-dir exits with
    the reference's message; the KV-chain flags (--role,
    --decode-peers, --kv-spill-bytes, --kv-cold-dir) parse under
    --continuous-batching, and without it the spill flags and the
    prefill role exit with the reference's messages (a gs:// cold dir
    exits naming ROADMAP A6(c)); train_lm without --cpu exits
    on a GPU-less box;
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'flax', 'optax', 'orbax', 'ml_dtypes', 'requests',
             'skypilot_tpu')


def _sources():
    return sorted((ROOT / 'skypilot_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py'] + sorted(ROOT.glob('profile_*.py'))


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
    assert ROOT / 'profile_lora.py' in sources
    bad = [(str(p.relative_to(ROOT)), mod) for p in sources
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert not bad, bad


def _module_level_roots(path: Path):
    """Roots imported by statements outside any function or class."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_no_module_level_transformers_or_safetensors():
    sources = _sources()
    assert ROOT / 'skypilot_tpu_torch' / 'models' / 'hf_import.py' in \
        sources
    bad = [(str(p.relative_to(ROOT)), mod) for p in sources
           for mod in _module_level_roots(p)
           if mod in ('transformers', 'safetensors', 'tokenizers')]
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
            'import skypilot_tpu_torch.inference.openai_compat\n'
            'import skypilot_tpu_torch.models.batching\n'
            'import skypilot_tpu_torch.models.hf_import\n'
            'print("ok")\n')
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_train_lm_imports_without_jax():
    code = ('import sys\n'
            'for m in ("jax", "flax", "optax", "orbax", "ml_dtypes", '
            '"skypilot_tpu"):\n'
            '    sys.modules[m] = None\n'
            'import skypilot_tpu_torch.recipes.train_lm\n'
            'import skypilot_tpu_torch.parallel.train\n'
            'import skypilot_tpu_torch.parallel.checkpoints\n'
            'import skypilot_tpu_torch.data.token_loader\n'
            'import skypilot_tpu_torch.observability.step_metrics\n'
            'import skypilot_tpu_torch.ops.flash_kernel\n'
            'import skypilot_tpu_torch.ops.fused_xent\n'
            'import skypilot_tpu_torch.robustness.train_guard\n'
            'import skypilot_tpu_torch.jobs.policy\n'
            'import skypilot_tpu_torch.utils.timeline\n'
            'print("ok")\n')
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_train_lm_without_cpu_flag_exits_on_gpu_less_box():
    out = _run('from skypilot_tpu_torch.recipes import train_lm\n'
               'train_lm.main(["--model", "llama-tiny", "--steps", "1"])\n')
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr


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
    (['--stages', '2', '--num-slots', '3'], '--stages'),
    (['--stages', '2', '--decode-chunk', '2'], '--stages'),
])
def test_unsupported_flag_exits_with_its_name(argv, flag, capsys):
    # --tensor and --stages serve now; what --stages cannot serve (the
    # reference's refusals) still exits naming the flag.
    with pytest.raises(SystemExit) as exc:
        serve_lm.parse_args(['--cpu', '--continuous-batching'] + argv)
    assert exc.value.code != 0
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize('argv', [
    ['--continuous-batching', '--weight-dtype', 'int8'],
    ['--weight-dtype', 'int8'],
])
def test_weight_dtype_int8_parses(argv):
    """The fleet forwards --weight-dtype to every replica: int8 parses
    with the slot engine and with the one-shot engine, with the
    reference's default when absent."""
    assert serve_lm.parse_args(['--cpu'] + argv).weight_dtype == 'int8'
    bare = serve_lm.parse_args(['--cpu'])
    assert bare.weight_dtype == \
        _reference_serve_lm_flags()['--weight-dtype'][0]


def test_weight_dtype_int8_refuses_ckpt_dir_in_the_references_words(
        capsys):
    """--weight-dtype int8 with --ckpt-dir exits with the message of
    the reference's build_runtime (read from its source with the AST)."""
    from skypilot_tpu_torch.inference import runtime
    tree = ast.parse((ROOT / 'skypilot_tpu' / 'inference' /
                      'runtime.py').read_text())
    messages = {node.args[0].value for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, 'id', '') == 'SystemExit'
                and node.args and isinstance(node.args[0], ast.Constant)}
    assert runtime.INT8_WEIGHTS_NO_CKPT in messages
    with pytest.raises(SystemExit) as exc:
        serve_lm.parse_args(['--cpu', '--continuous-batching',
                             '--weight-dtype', 'int8', '--ckpt-dir', '/x'])
    assert exc.value.code != 0
    assert runtime.INT8_WEIGHTS_NO_CKPT in capsys.readouterr().err


def _reference_serve_lm_flags():
    """{option: (default, help)} of the reference serve_lm parser's
    add_argument calls, read from its source with the AST."""
    def literal(node):
        try:
            return ast.literal_eval(node)
        except ValueError:   # computed (e.g. from the environment)
            return None

    tree = ast.parse((ROOT / 'skypilot_tpu' / 'recipes' /
                      'serve_lm.py').read_text())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, 'attr', '') == 'add_argument':
            kw = {k.arg: k.value for k in node.keywords}
            flags[ast.literal_eval(node.args[0])] = (
                literal(kw['default']) if 'default' in kw else None,
                literal(kw['help']) if 'help' in kw else None)
    return flags


@pytest.mark.parametrize('argv,want', [
    (['--fault-plan', '{"rules": [{"point": "engine.decode_step"}]}'],
     {'fault_plan': '{"rules": [{"point": "engine.decode_step"}]}'}),
    (['--trace-sample', '0.5'], {'trace_sample': 0.5}),
    (['--trace-seed', '3'], {'trace_seed': 3}),
    (['--slo', 'p99_ttft_ms=500,p99_itl_ms=100,error_rate=0.01'],
     {'slo': 'p99_ttft_ms=500,p99_itl_ms=100,error_rate=0.01'}),
])
def test_observability_flags_parse(argv, want):
    """The fleet forwards these four to every replica: the port takes
    them, with the reference's defaults when absent."""
    args = serve_lm.parse_args(['--cpu', '--continuous-batching'] + argv)
    assert {k: getattr(args, k) for k in want} == want
    bare = serve_lm.parse_args(['--cpu', '--continuous-batching'])
    ref = _reference_serve_lm_flags()
    for key in want:
        assert getattr(bare, key) == ref['--' + key.replace('_', '-')][0]


@pytest.mark.parametrize('flag', ['--fault-plan', '--trace-sample',
                                  '--trace-seed', '--slo'])
def test_observability_flag_help_is_the_references(flag):
    """Help text word for word (the fault plan's module named as the
    port's)."""
    ref_help = _reference_serve_lm_flags()[flag][1].replace(
        'skypilot_tpu.robustness', 'skypilot_tpu_torch.robustness')
    port = {a.option_strings[0]: a.help
            for a in serve_lm.build_parser()._actions}
    assert port[flag] == ref_help


@pytest.mark.parametrize('spec', ['ttft_p99_ms=100', 'p99_ttft_ms=-1',
                                  'error_rate=2', 'p99_itl_ms'])
def test_slo_refusals_are_the_references_words(spec, capsys):
    """A spec the reference's parse_slo refuses exits at startup with
    its message."""
    from skypilot_tpu.observability import slo as ref_slo
    with pytest.raises(ValueError) as ref_err:
        ref_slo.parse_slo(spec)
    with pytest.raises(SystemExit) as exc:
        serve_lm.parse_args(['--cpu', '--continuous-batching', '--slo',
                             spec])
    assert exc.value.code != 0
    assert str(ref_err.value) in capsys.readouterr().err


@pytest.mark.parametrize('argv,want', [
    (['--role', 'prefill'], {'role': 'prefill'}),
    (['--role', 'decode'], {'role': 'decode'}),
    (['--decode-peers', 'h:1,h:2'], {'decode_peers': 'h:1,h:2'}),
    (['--kv-spill-bytes', '1024'], {'kv_spill_bytes': 1024}),
    (['--kv-cold-dir', '/x', '--kv-spill-bytes', '8'],
     {'kv_cold_dir': '/x', 'kv_spill_bytes': 8}),
])
def test_kv_chain_flags_parse_under_continuous_batching(argv, want):
    args = serve_lm.parse_args(['--cpu', '--continuous-batching'] + argv)
    assert {k: getattr(args, k) for k in want} == want


@pytest.mark.parametrize('argv,message', [
    (['--kv-spill-bytes', '1024'], 'SPILL_NEEDS_CONTINUOUS'),
    (['--kv-cold-dir', '/x'], 'SPILL_NEEDS_CONTINUOUS'),
    (['--role', 'prefill'], 'PREFILL_NEEDS_CONTINUOUS'),
    (['--continuous-batching', '--kv-cold-dir', 'gs://b/kv'],
     'REMOTE_COLD_DIR'),
])
def test_kv_chain_refusals(argv, message, capsys):
    """The reference's two refusals without --continuous-batching, word
    for word (its serve_lm's parser errors), and a remote cold tier
    refused naming ROADMAP A6(c)."""
    from skypilot_tpu_torch.inference import kv_transfer, runtime
    text = getattr(runtime, message, None) or getattr(kv_transfer, message)
    with pytest.raises(SystemExit) as exc:
        serve_lm.parse_args(['--cpu'] + argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert text in err
    if message == 'REMOTE_COLD_DIR':
        assert 'A6(c)' in err


def test_kv_chain_refusals_are_the_references_words():
    """The refusal strings are the messages of the reference serve_lm's
    parser.error calls (read from its source with the AST)."""
    from skypilot_tpu_torch.inference import runtime
    tree = ast.parse((ROOT / 'skypilot_tpu' / 'recipes' /
                      'serve_lm.py').read_text())
    messages = {ast.literal_eval(node.args[0]) for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, 'attr', '') == 'error'
                and isinstance(node.args[0], ast.Constant)}
    assert runtime.SPILL_NEEDS_CONTINUOUS in messages
    assert runtime.PREFILL_NEEDS_CONTINUOUS in messages


def test_continuous_batching_is_required(capsys):
    """--continuous-batching is required by int8 KV pages only: the
    one-shot engine (no flag) parses, int8 without it exits with the
    reference's message."""
    from skypilot_tpu_torch.inference.runtime import INT8_NEEDS_CONTINUOUS
    assert not serve_lm.parse_args(['--cpu']).continuous_batching
    with pytest.raises(SystemExit):
        serve_lm.parse_args(['--cpu', '--kv-dtype', 'int8'])
    assert INT8_NEEDS_CONTINUOUS in capsys.readouterr().err


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
