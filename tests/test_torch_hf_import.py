"""The port's HF checkpoint import (skypilot_tpu_torch/models/hf_import.py)
against the reference's (skypilot_tpu/models/hf_import.py) and against
transformers, on tiny checkpoints written locally by transformers, CPU,
f32:

  - llama, mistral and qwen2 (q/k/v biases, tied embeddings): the port's
    weights equal the reference's import carried through the weight
    bridge bit for bit, the configs agree, and logits are within 1e-5 of
    the reference's and of transformers';
  - a sharded checkpoint (model.safetensors.index.json) and a
    pytorch_model.bin import the same weights as one safetensors file;
  - llama3 and linear RoPE scaling match transformers; unsupported
    scalings and model types are refused (deferred families naming
    ROADMAP A12);
  - the port's safetensors reader equals safetensors.torch.load_file for
    bf16, f16 and f32;
  - control: q/k rows permuted as if HF stored interleaved pairs (the
    de-interleave applied to HF's half-split layout) fail the logits pin;
  - serve_lm --hf: the runtime serves the checkpoint under the name
    hf:<dir>, with its tokenizer, and --param-dtype f32 keeps f32 masters.
"""
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file, save_file

from skypilot_tpu.models import hf_import as jax_hf
from skypilot_tpu_torch.inference.http_server import make_server
from skypilot_tpu_torch.inference.runtime import build_runtime
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import hf_import
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.recipes import serve_lm

TOL = 1e-5
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


def _hf_model(kind, **kw):
    torch.manual_seed(0)
    args = dict(SMALL, **kw)
    if kind == 'qwen2':
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            tie_word_embeddings=True, **args))
        with torch.no_grad():   # init leaves biases at zero
            for name, p in model.named_parameters():
                if name.endswith('bias'):
                    p.normal_(0.0, 0.1)
    elif kind == 'mistral':
        model = transformers.MistralForCausalLM(transformers.MistralConfig(
            tie_word_embeddings=False, **args))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **dict(dict(tie_word_embeddings=False), **args)))
    return model.eval()


def _save(model, path):
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.fixture(scope='module')
def tokens():
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 120, size=(2, 12)))


def _port_config_of(ref_cfg) -> pt_llama.LlamaConfig:
    """The reference's LlamaConfig as the port's (f32)."""
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(ref_cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    scaling = ref_cfg.rope_scaling
    if scaling is not None:
        vals['rope_scaling'] = pt_llama.RopeScaling(
            **dataclasses.asdict(scaling))
    return pt_llama.LlamaConfig(dtype=torch.float32, **vals)


def _logits(model, toks):
    with torch.no_grad():
        return model(toks)


@pytest.mark.parametrize('kind', ['llama', 'mistral', 'qwen2'])
def test_import_equals_reference_and_transformers(kind, tmp_path, tokens):
    hf = _hf_model(kind)
    path = _save(hf, tmp_path)
    cfg, model = hf_import.load_hf_checkpoint(path, dtype=torch.float32)
    ref_model, ref_params = jax_hf.load_hf_checkpoint(path,
                                                      dtype=jnp.float32)
    bridged = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), ref_params),
        _port_config_of(ref_model.config))
    assert cfg == bridged.config
    assert cfg.qkv_bias == (kind == 'qwen2')
    ours, theirs = model.state_dict(), bridged.state_dict()
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert torch.equal(ours[name], theirs[name]), name
    logits = _logits(model, tokens)
    ref_logits = np.asarray(ref_model.apply(
        {'params': ref_params}, jnp.asarray(tokens.numpy(), jnp.int32)))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=TOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(),
                               _logits(hf, tokens).logits.numpy(),
                               atol=TOL, rtol=0)


def _shard(path, sd, names_per_shard):
    weight_map = {}
    for i, names in enumerate(names_per_shard):
        shard = f'model-{i + 1:05d}-of-{len(names_per_shard):05d}' \
                '.safetensors'
        save_file({n: sd[n].contiguous() for n in names},
                  os.path.join(path, shard))
        weight_map.update({n: shard for n in names})
    with open(os.path.join(path, 'model.safetensors.index.json'), 'w') as f:
        json.dump({'metadata': {}, 'weight_map': weight_map}, f)


def test_sharded_and_torch_bin_checkpoints(tmp_path):
    hf = _hf_model('llama').to(torch.bfloat16)
    single = _save(hf, tmp_path / 'single')
    sd = load_file(os.path.join(single, 'model.safetensors'))
    names = sorted(sd)
    for layout in ('sharded', 'bin'):
        path = tmp_path / layout
        path.mkdir()
        (path / 'config.json').write_text(
            (tmp_path / 'single' / 'config.json').read_text())
        if layout == 'sharded':
            _shard(str(path), sd, [names[:len(names) // 2],
                                   names[len(names) // 2:]])
        else:
            torch.save(sd, str(path / 'pytorch_model.bin'))
        got = hf_import.load_state_dict(str(path))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[n], sd[n]) and got[n].dtype ==
                   torch.bfloat16 for n in sd)
        _, a = hf_import.load_hf_checkpoint(str(path))
        _, b = hf_import.load_hf_checkpoint(single)
        assert all(torch.equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))
        # bf16 storage stays bit-exact; the head is f32 of bf16 values.
        assert a.tok_embed.dtype == torch.bfloat16
        assert a.lm_head.dtype == torch.float32
        assert torch.equal(a.lm_head, sd['lm_head.weight'].float())


@pytest.mark.parametrize('scaling', [
    {'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
     'high_freq_factor': 4.0, 'original_max_position_embeddings': 8},
    {'rope_type': 'linear', 'factor': 4.0},
    {'type': 'linear', 'factor': 2.0}])
def test_rope_scaling_matches_transformers(scaling, tmp_path, tokens):
    hf = _hf_model('llama', rope_scaling=scaling)
    cfg, model = hf_import.load_hf_checkpoint(_save(hf, tmp_path),
                                              dtype=torch.float32)
    assert cfg.rope_scaling.rope_type == (scaling.get('rope_type')
                                          or scaling['type'])
    ref = jax_hf._parse_rope_scaling({'rope_scaling': scaling})
    assert dataclasses.asdict(cfg.rope_scaling) == dataclasses.asdict(ref)
    np.testing.assert_allclose(_logits(model, tokens).numpy(),
                               _logits(hf, tokens).logits.numpy(),
                               atol=TOL, rtol=0)


def test_tied_llama_embeddings(tmp_path, tokens):
    hf = _hf_model('llama', tie_word_embeddings=True)
    _, model = hf_import.load_hf_checkpoint(_save(hf, tmp_path),
                                            dtype=torch.float32)
    assert torch.equal(model.lm_head, model.tok_embed)
    np.testing.assert_allclose(_logits(model, tokens).numpy(),
                               _logits(hf, tokens).logits.numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize('config,match', [
    ({'model_type': 'llama', 'rope_scaling': {'rope_type': 'yarn',
                                              'factor': 4.0}}, 'yarn'),
    ({'model_type': 'llama', 'rope_scaling': {'rope_type': 'dynamic',
                                              'factor': 2.0}}, 'dynamic'),
    ({'model_type': 'llama', 'rope_scaling': {'rope_type': 'llama3',
                                              'factor': 8.0}},
     'original_max_position_embeddings'),
    ({'model_type': 'mixtral'}, 'A12'),
    ({'model_type': 'gpt2'}, 'A12'),
    ({'model_type': 'deepseek_v2'}, 'A12'),
    ({'model_type': 'bert'}, 'unsupported model_type'),
])
def test_unsupported_checkpoints_are_refused(config, match, tmp_path):
    (tmp_path / 'config.json').write_text(json.dumps(config))
    with pytest.raises(hf_import.HfImportError, match=match):
        hf_import.load_hf_checkpoint(str(tmp_path))


def test_missing_tensor_fails_validation(tmp_path):
    path = _save(_hf_model('llama'), tmp_path)
    sd = load_file(os.path.join(path, 'model.safetensors'))
    del sd['model.layers.1.mlp.up_proj.weight']
    save_file(sd, os.path.join(path, 'model.safetensors'))
    with pytest.raises(KeyError):
        hf_import.load_hf_checkpoint(path)
    cfg, state = hf_import._convert_llama_like(
        hf_import.read_config(path),
        dict(sd, **{'model.layers.1.mlp.up_proj.weight':
                    torch.zeros(160, 64)}), None)
    del state['layers.0.attn.wo.weight']
    with pytest.raises(hf_import.HfImportError, match='missing'):
        hf_import._validate_against_init(cfg, state)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_safetensors_reader_equals_the_library(dtype, tmp_path):
    gen = torch.Generator().manual_seed(1)
    tensors = {'a': torch.randn(3, 5, generator=gen).to(dtype),
               'b.c': torch.randn(7, generator=gen).to(dtype),
               'scalar_row': torch.randn(1, 1, 2, generator=gen).to(dtype),
               'empty': torch.zeros(0, 4, dtype=dtype)}
    path = str(tmp_path / 'x.safetensors')
    save_file(tensors, path, metadata={'format': 'pt'})
    ours, theirs = hf_import.read_safetensors(path), load_file(path)
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype == dtype
        assert ours[name].shape == theirs[name].shape
        assert torch.equal(ours[name], theirs[name]), name


def test_wrong_rope_layout_fails_the_logits_pin(tmp_path, tokens):
    """Control: treat HF's rows as interleaved pairs and de-interleave
    each q/k head; the model still runs but its logits leave the pin."""
    hf = _hf_model('llama')
    cfg, model = hf_import.load_hf_checkpoint(_save(hf, tmp_path),
                                              dtype=torch.float32)
    state = dict(model.state_dict())
    hd = cfg.head_dim
    for name in list(state):
        if name.endswith(('attn.wq.weight', 'attn.wk.weight')):
            w = state[name]
            state[name] = torch.cat([
                hf_import._deinterleave_rope_rows(w[h * hd:(h + 1) * hd], hd)
                for h in range(w.shape[0] // hd)])
    wrong = convert.assemble(cfg, state)
    ref = _logits(hf, tokens).logits
    assert (_logits(model, tokens) - ref).abs().max() <= TOL
    assert (_logits(wrong, tokens) - ref).abs().max() > 100 * TOL


def test_deinterleave_rope_rows_matches_reference():
    w = np.random.default_rng(2).standard_normal((12, 5)).astype(np.float32)
    ref = jax_hf._deinterleave_rope_rows(w, 8)
    got = hf_import._deinterleave_rope_rows(torch.from_numpy(w), 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_serve_lm_hf_serves_the_checkpoint_with_its_tokenizer(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    path = _save(_hf_model('llama'), tmp_path / 'tiny-llama')
    vocab = {'<unk>': 0}
    vocab.update({f'w{i}': i for i in range(1, 128)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token='<unk>').save_pretrained(path)
    args = serve_lm.parse_args(['--cpu', '--hf', path, '--max-total-len',
                                '48', '--continuous-batching',
                                '--num-slots', '2', '--param-dtype', 'f32'])
    rt = build_runtime(args)
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        assert rt.model_name == 'hf:tiny-llama'
        assert rt.tokenizer_dir == path
        assert rt.model.config.max_seq_len == 48
        assert rt.model.layers[0].attn.wq.weight.dtype == torch.float32
        assert not any(p.requires_grad for p in rt.model.parameters())
        _, ref = hf_import.load_hf_checkpoint(path, max_seq_len=48,
                                              param_dtype=torch.float32)
        for (name, a), b in zip(rt.model.state_dict().items(),
                                ref.state_dict().values()):
            assert torch.equal(a, b), name
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/v1/models',
                                    timeout=30) as resp:
            ids = [m['id'] for m in json.loads(resp.read())['data']]
        assert ids == ['hf:tiny-llama']
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate_text',
            data=json.dumps({'prompts': ['w1 w2 w3'],
                             'max_new_tokens': 4}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            text = json.loads(resp.read())['texts'][0]
        assert len(text.split()) <= 4 and all(
            w.startswith('w') for w in text.split())
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=10)
