"""Live KV-chain migration in the port, CPU, llama-tiny at f32 (page size
8), against the contract tests/unit_tests/test_kv_transfer.py holds the
reference to:

  - evacuate_chains(max_sessions=1) takes the deepest chain first and
    leaves the other session and the queue alone; a full evacuation
    fails queued requests with payload-less records;
  - an evacuation while a pipelined round is in flight loses no
    committed token and duplicates none: the record's tokens are the
    prompt plus exactly the tokens emitted, the in-flight round's token
    is dropped, and the continuation on another engine ends with an
    undisturbed run's tokens (exact);
  - a stream migrated from replica A to replica B over HTTP (POST
    /kv/evacuate with B as the target) ends with the tokens of an
    undisturbed run (exact), A counts migrations{drain} and B
    migrations_in;
  - migration stays isolated under adapter salts;
  - a failed ship (a dead peer, or a kv.migrate fault) resumes locally
    on the warm pages with the undisturbed tokens;
  - drain() evacuates the sessions before it exits (exit_fn injected),
    and the serving preemption notice fires on its fault point.
"""
import dataclasses
import json
import threading
import time
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.errors import SessionMigratedError
from skypilot_tpu_torch.inference import http_server as pt_http
from skypilot_tpu_torch.inference import kv_transfer as kvt
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.models import batching as pt_batching
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.robustness import faults
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SYS_PROMPT = list(range(2, 34))    # 32 tokens = 4 full 8-token pages
PROMPT = SYS_PROMPT + [40]
MAX_NEW = 48


@pytest.fixture(scope='module')
def port_model():
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, kv_page_size=8,
                                     kv_total_pages=48)
    params = nn.meta.unbox(jax_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))['params'])
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling')}
    return convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        pt_llama.LlamaConfig(dtype=torch.float32, **vals), device='cpu')


def engine(model, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('max_total_len', 96)
    return pt_batching.ContinuousBatchingEngine(model, **kw)


def slowed(eng, seconds=0.02):
    """Slow the engine's token emission (so a test can act while a
    session decodes); returns the engine."""
    emit = eng._emit
    eng._emit = lambda slot, tok: (time.sleep(seconds), emit(slot, tok))
    return eng


@pytest.fixture(scope='module')
def undisturbed(port_model):
    eng = engine(port_model)
    try:
        return eng.submit(PROMPT, max_new_tokens=MAX_NEW).result(
            timeout=300)
    finally:
        eng.stop()


def _wait_tokens(n):
    seen = []
    ready = threading.Event()

    def on_token(tok):
        seen.append(tok)
        if len(seen) >= n:
            ready.set()
    return seen, ready, on_token


def test_bounded_evacuation_takes_the_deepest_chain_first(port_model):
    eng = slowed(engine(port_model))
    try:
        _, ready, on_tok = _wait_tokens(3)
        shallow = eng.submit(SYS_PROMPT[:12], max_new_tokens=40)
        deep = eng.submit(PROMPT, max_new_tokens=40, on_token=on_tok)
        assert ready.wait(timeout=300)
        res = eng.evacuate_chains(max_sessions=1, reason='rebalance')
        assert res == {'evacuated': 1, 'chains': 1, 'queued': 0}
        with pytest.raises(SessionMigratedError) as err:
            deep.result(timeout=300)
        rec = err.value.record
        assert rec['reason'] == 'rebalance'
        assert rec['tokens'][:len(PROMPT)] == PROMPT
        assert rec['pages'] == len(rec['tokens']) // 8
        assert kvt.unpack_pages(rec['payload'])[0]['n_pages'] == \
            rec['pages']
        # The shallower session finishes untouched.
        assert len(shallow.result(timeout=300)) == 12 + 40
        assert eng.stats()['sessions_evacuated'] == 1
        assert eng.stats()['chains_evacuated'] == 1
    finally:
        eng.stop()


def test_full_evacuation_fails_queued_requests_without_payload(port_model):
    eng = slowed(engine(port_model, num_slots=1))
    try:
        _, ready, on_tok = _wait_tokens(2)
        running = eng.submit(PROMPT, max_new_tokens=40, on_token=on_tok)
        queued = eng.submit(SYS_PROMPT[:20], max_new_tokens=5,
                            temperature=0.5, top_k=3)
        assert ready.wait(timeout=300)
        res = eng.evacuate_chains(reason='drain')
        assert res == {'evacuated': 1, 'chains': 1, 'queued': 1}
        with pytest.raises(SessionMigratedError):
            running.result(timeout=300)
        with pytest.raises(SessionMigratedError) as err:
            queued.result(timeout=300)
        rec = err.value.record
        assert rec['payload'] is None and rec['pages'] == 0
        assert rec['tokens'] == SYS_PROMPT[:20]
        assert rec['limit'] == 25 and rec['top_k'] == 3
        assert rec['temperature'] == 0.5
        assert eng.queued_tokens() == 0
    finally:
        eng.stop()


def test_evacuation_during_an_inflight_pipelined_round(port_model,
                                                       undisturbed):
    """The pipelined loop always has a round in flight while a session
    decodes: evacuating then exports only committed tokens, drops the
    in-flight round's token (not emitted, not committed), and the
    continuation from the record ends with the undisturbed tokens."""
    # Slowed commits (the next round is dispatched before each commit)
    # keep the session decoding until the evacuation lands.
    eng = slowed(engine(port_model), 0.01)
    assert eng.pipeline_decode
    inflight_at_evacuation = []
    real = eng._evacuate_slot

    def spy(slot, reason):
        inflight_at_evacuation.append(eng._group_inflight[0] is not None)
        return real(slot, reason)

    eng._evacuate_slot = spy
    seen, ready, on_tok = _wait_tokens(5)
    try:
        fut = eng.submit(PROMPT, max_new_tokens=MAX_NEW, on_token=on_tok)
        assert ready.wait(timeout=300)
        eng.evacuate_chains(reason='preempt')
        with pytest.raises(SessionMigratedError) as err:
            fut.result(timeout=300)
        rec = err.value.record
        emitted = list(seen)
        time.sleep(0.2)
        assert seen == emitted                   # nothing after teardown
        assert inflight_at_evacuation == [True]
        assert rec['tokens'] == PROMPT + emitted  # no loss, no duplicate
        assert rec['tokens'] == undisturbed[:len(rec['tokens'])]
        assert eng.stats()['tokens_committed'] == len(emitted)
    finally:
        eng.stop()
    dst = engine(port_model)
    try:
        summary = dst.import_chain(rec['payload'])
        assert summary['imported'] == rec['pages']
        out = dst.submit(rec['tokens'],
                         max_new_tokens=rec['limit'] - len(rec['tokens'])
                         ).result(timeout=300)
        assert out == undisturbed
    finally:
        dst.stop()


def test_adapter_salted_migration_stays_isolated(port_model, tmp_path):
    from skypilot_tpu.models import lora as jax_lora
    from skypilot_tpu_torch.inference.adapters import AdapterRegistry
    cfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    spec = jax_lora.LoraSpec(rank=4, alpha=8.0)
    lp = jax_lora.random_adapter_params(7, cfg, spec)
    for layer in lp.values():
        for tgt in layer.values():
            tgt['b'] *= 60.0
    jax_lora.save_adapter(str(tmp_path / 'ten_a'), lp, spec,
                          base_model='llama-tiny')
    regs = [AdapterRegistry(str(tmp_path), port_model, max_adapters=2)
            for _ in range(3)]
    ctrl, src, dst = (engine(port_model, adapter_store=r) for r in regs)
    slowed(src)
    try:
        ref = ctrl.submit(PROMPT, max_new_tokens=MAX_NEW,
                          adapter='ten_a').result(timeout=300)
        _, ready, on_tok = _wait_tokens(2)
        fut = src.submit(PROMPT, max_new_tokens=MAX_NEW, adapter='ten_a',
                         on_token=on_tok)
        assert ready.wait(timeout=300)
        assert src.evacuate_chains(reason='drain')['evacuated'] == 1
        with pytest.raises(SessionMigratedError) as err:
            fut.result(timeout=300)
        rec = err.value.record
        assert rec['adapter'] == 'ten_a'
        committed = rec['tokens']
        assert len(PROMPT) < len(committed) < rec['limit']
        assert committed == ref[:len(committed)]
        assert kvt.unpack_pages(rec['payload'])[0]['salt'] != ''
        assert dst.import_chain(rec['payload'])['imported'] == rec['pages']
        h0 = dst.prefix_cache.hits
        dst.submit(list(committed), max_new_tokens=2).result(timeout=300)
        assert dst.prefix_cache.hits == h0     # the base model sees none
        h1 = dst.prefix_cache.hits
        out = dst.submit(list(committed),
                         max_new_tokens=rec['limit'] - len(committed),
                         adapter='ten_a').result(timeout=300)
        assert out == ref
        assert dst.prefix_cache.hits - h1 >= rec['pages']
    finally:
        for e in (ctrl, src, dst):
            e.stop()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------
def replica(model, slow=False, **kw):
    eng = engine(model)
    if slow:
        slowed(eng)
    rt = InferenceRuntime(engine=eng, model_name='llama-tiny',
                          request_timeout=120.0, **kw)
    server = pt_http.make_server(rt, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return rt, server, server.server_address[1]


def _post(port, path, body, timeout=300):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _stats(port):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                timeout=30) as resp:
        return json.loads(resp.read())


def _stream(port, body, first, frames, errors):
    """Client of an SSE /generate stream: frames as they arrive; sets
    `first` at the first token."""
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate',
            data=json.dumps(dict(body, stream=True)).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            for line in resp:
                if not line.startswith(b'data: '):
                    continue
                payload = line[6:].strip()
                if payload == b'[DONE]':
                    frames.append('DONE')
                    break
                frames.append(json.loads(payload))
                first.set()
    except Exception as e:  # pylint: disable=broad-except
        errors.append(e)
    finally:
        first.set()


def _stream_in_thread(port, body):
    first, frames, errors = threading.Event(), [], []
    th = threading.Thread(target=_stream,
                          args=(port, body, first, frames, errors),
                          daemon=True)
    th.start()
    assert first.wait(timeout=300)
    return th, frames, errors


def test_stream_migrated_between_replicas(port_model, undisturbed):
    rt_b, srv_b, port_b = replica(port_model)
    rt_a, srv_a, port_a = replica(port_model, slow=True)
    try:
        th, frames, errors = _stream_in_thread(
            port_a, {'tokens': [PROMPT], 'max_new_tokens': MAX_NEW})
        res = _post(port_a, '/kv/evacuate',
                    {'reason': 'drain', 'target': f'127.0.0.1:{port_b}'})
        assert res['evacuated'] == 1 and res['chains'] == 1
        th.join(timeout=300)
        assert not th.is_alive() and not errors
        toks = [f['token'] for f in frames if isinstance(f, dict)
                and 'token' in f]
        assert toks == undisturbed[len(PROMPT):]
        assert frames[-1] == 'DONE'
        assert frames[-2]['tokens'] == [undisturbed]
        mig_a, mig_b = _stats(port_a)['migration'], \
            _stats(port_b)['migration']
        assert mig_a['migrations'].get('drain', 0) >= 1
        assert mig_a['sessions_evacuated'] == 1
        assert mig_a['chains_evacuated'] == 1
        assert mig_b['migrations_in'] >= 1
        assert mig_b['migrated_in_keys']
        assert _stats(port_b)['handoff']['kv_imports'] == 1
    finally:
        for srv, rt in ((srv_a, rt_a), (srv_b, rt_b)):
            srv.shutdown()
            rt.stop()


@pytest.mark.parametrize('failure', ['dead_peer', 'kv_migrate_fault'])
def test_failed_ship_resumes_locally_on_warm_pages(port_model, undisturbed,
                                                   failure):
    rt, srv, port = replica(port_model, slow=True)
    target = '127.0.0.1:9'
    if failure == 'kv_migrate_fault':
        rt_b, srv_b, port_b = replica(port_model)
        target = f'127.0.0.1:{port_b}'
        faults.install_plan({'rules': [{'point': 'kv.migrate',
                                        'action': 'drop'}]})
    try:
        out = {}

        def client():
            out['tokens'] = _post(port, '/generate', {
                'tokens': [PROMPT], 'max_new_tokens': MAX_NEW})['tokens']

        th = threading.Thread(target=client, daemon=True)
        th.start()
        deadline = time.monotonic() + 300
        while not rt.engine.active.any() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        h0 = rt.engine.prefix_cache.hits
        _post(port, '/kv/evacuate', {'reason': 'drain', 'target': target})
        th.join(timeout=300)
        assert out['tokens'] == [undisturbed]
        mig = _stats(port)['migration']
        assert mig['migrations'] == {'drain': 1, 'local_fallback': 1}
        assert mig['failures'] == 1
        # The resume admitted against the pages the evacuation promoted.
        assert rt.engine.prefix_cache.hits - h0 >= 4
        if failure == 'kv_migrate_fault':
            assert faults.stats()['kv.migrate']['fired'] == 1
            assert 'migration' not in _stats(port_b)
    finally:
        faults.clear()
        srv.shutdown()
        rt.stop()
        if failure == 'kv_migrate_fault':
            srv_b.shutdown()
            rt_b.stop()


def test_drain_evacuates_before_exit(port_model, undisturbed):
    rt_b, srv_b, port_b = replica(port_model)
    rt_a, srv_a, port_a = replica(port_model, slow=True,
                                  decode_peers=[f'127.0.0.1:{port_b}'])
    codes = []
    try:
        th, frames, errors = _stream_in_thread(
            port_a, {'tokens': [PROMPT], 'max_new_tokens': MAX_NEW})
        drainer = threading.Thread(
            target=pt_http.drain, args=(srv_a, rt_a, 60.0),
            kwargs={'straggler_grace': 0.1, 'exit_fn': codes.append},
            daemon=True)
        drainer.start()
        th.join(timeout=300)
        drainer.join(timeout=120)
        assert codes == [0]
        assert not errors
        toks = [f['token'] for f in frames if isinstance(f, dict)
                and 'token' in f]
        assert toks == undisturbed[len(PROMPT):]
        assert rt_a.migration_stats()['migrations'].get('drain', 0) >= 1
        assert rt_b.migration_stats()['migrations_in'] >= 1
        assert not rt_a.engine.healthy()      # stopped by the drain
    finally:
        srv_b.shutdown()
        rt_b.stop()
        rt_a.stop()


def test_serve_preemption_notice_fires_on_its_fault_point():
    faults.install_plan({'rules': [{'point': 'serve.preempt_notice',
                                    'action': 'drop',
                                    'scope': {'zone': 'z1'}}]})
    try:
        notices = [pt_http.ServePreemptionNotice(
            poll_interval_s=0.05, install_sigterm=False,
            metadata_url='http://127.0.0.1:9/', ctx={'zone': zone})
            for zone in ('z1', 'z2')]
        for n in notices:
            n.start()
        assert notices[0].notice.wait(timeout=10)
        assert notices[0].reason == 'injected'
        time.sleep(0.2)
        assert not notices[1].notice.is_set()
        for n in notices:
            n.stop()
    finally:
        faults.clear()
