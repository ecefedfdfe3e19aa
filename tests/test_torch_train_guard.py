"""The port's training recovery contract (skypilot_tpu_torch/robustness/,
parallel/train.py's guarded step, jobs/policy.py, utils/timeline.py,
recipes/train_lm.py --guard / --init-from-hf) against the JAX package,
CPU:

  - fault plans, the committed examples/fault_plans/train_guard_chaos.json
    among them, fire exactly as the reference's (outcome of every call,
    delays, raised types, stats); a plan the reference refuses is
    refused with its message;
  - SpikeGuard's verdicts and thresholds equal the reference's on the
    same loss and grad-norm series; the exit codes equal the reference's
    and the reference's agent/job_lib maps them to PREEMPTED and
    WATCHDOG_ABORT; the notice takes SIGTERM, an injected drop and a
    metadata endpoint on localhost (urllib, the reference's header and
    five-strike give-up); the watchdog dumps stacks and exits 84;
  - the guarded step on llama-tiny in f32 from bridged weights holds
    against the JAX ShardedTrainer(guard=True) over 6 steps with NaN at
    step 3 and a norm spike at step 5: the bad flags, the optimizer
    count and the losses equal, params within test_torch_train's
    PARAM_TOL; a guarded good step equals the unguarded step bit for
    bit, a poisoned one leaves params, moments and the count as they
    were; the device-count optimizer gives the host-count optimizer's
    values bit for bit;
  - train_lm subprocesses mirroring the reference's
    test_train_guard.py:475-578 on llama-tiny (NaN skip and rollback,
    rc 0, with the JAX recipe under the same plan printing the same
    guard events and summary; the committed chaos plan: watchdog rc 84
    naming next_tokens, then a relaunch that finishes; preemption rc 83
    then a resume; SIGTERM taken at the next step boundary);
  - --init-from-hf: the f32 masters equal the checkpoint's bf16 tensors
    upcast; a --lora relaunch rebuilds the base from the HF dir and a
    run over another base is refused.

Every run that arms the preemption watcher points its metadata probe at
a closed port on 127.0.0.1, so no test reaches past the host.
"""
import dataclasses
import http.server
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import transformers

from skypilot_tpu.agent import job_lib
from skypilot_tpu.jobs import policy as ref_policy
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.parallel import train as jax_train
from skypilot_tpu.recipes.train_lm import _build_model
from skypilot_tpu.robustness import faults as ref_faults
from skypilot_tpu.robustness import train_guard as ref_guard
from skypilot_tpu.utils import timeline as ref_timeline
from skypilot_tpu_torch.jobs import policy
from skypilot_tpu_torch.models import convert, hf_import, registry
from skypilot_tpu_torch.models import llama as pt_llama
from skypilot_tpu_torch.models import lora as pt_lora
from skypilot_tpu_torch.parallel import train as pt_train
from skypilot_tpu_torch.recipes import train_lm
from skypilot_tpu_torch.robustness import faults, train_guard
from skypilot_tpu_torch.utils import timeline
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
CHAOS_PLAN = ROOT / 'examples' / 'fault_plans' / 'train_guard_chaos.json'
# A closed port on this host: the notice's metadata probe fails at once.
LOCAL_METADATA = 'http://127.0.0.1:9/computeMetadata/v1/instance/preempted'
TOL = 1e-5
PARAM_TOL = 5e-4        # tests/test_torch_train.py's bound
LR = 1e-2
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv(train_guard.METADATA_URL_ENV, LOCAL_METADATA)
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


# -- fault plans -------------------------------------------------------------
PLANS = {
    'chaos': str(CHAOS_PLAN),
    'counting': {'seed': 3, 'rules': [
        {'point': 'train.step', 'action': 'drop', 'every_nth': 3,
         'after': 2, 'times': 4},
        {'point': 'train.step', 'action': 'raise', 'exc': 'RuntimeError',
         'message': 'boom', 'at': [7, 11]},
        {'point': 'train.data_next', 'action': 'delay', 'delay_s': 0.5,
         'prob': 0.4, 'scope': {'resume': '1'}},
        {'point': 'train.data_next', 'action': 'drop', 'prob': 0.3},
        {'point': 'train.preempt_notice', 'action': 'drop',
         'scope': {'resume': '0'}, 'after': 5, 'times': 2}]},
    'seeded': {'seed': 2026, 'rules': [
        {'point': 'train.step', 'action': 'delay', 'delay_s': 0.1,
         'prob': 0.5},
        {'point': 'train.step', 'action': 'drop', 'prob': 0.25,
         'scope': {'resume': '0'}}]},
}


def _fire_all(module, sleeps):
    """Outcome of 60 rounds of every train point, alternating resume."""
    out = []
    for i in range(60):
        for name in ('train.step', 'train.data_next',
                     'train.preempt_notice'):
            n = len(sleeps)
            try:
                got = module.point(name, step=str(i), resume=str(i % 2))
                got = 'drop' if got is module.DROP else got
            except Exception as e:  # pylint: disable=broad-except
                got = f'raise {type(e).__name__}: {e}'
            out.append((name, got, tuple(sleeps[n:])))
    return out


@pytest.mark.parametrize('plan', sorted(PLANS))
def test_fault_plans_fire_as_the_reference(plan, monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, 'sleep', sleeps.append)
    faults.install_plan(PLANS[plan])
    ref_faults.install_plan(PLANS[plan])
    got, want = _fire_all(faults, sleeps), _fire_all(ref_faults, sleeps)
    assert got == want
    assert any(o[1] is not None or o[2] for o in got)   # the plan fired
    assert faults.stats() == ref_faults.stats()


def test_plans_the_port_cannot_honor_are_refused():
    """The port takes the reference's whole catalog, windows and the
    derived jobs.preempt_storm point (tests/test_torch_fault_plan.py
    fires them), so what it refuses is what the reference refuses, with
    the same message: an unknown point, a partial window, a storm with
    no window."""
    for plan in ({'rules': [{'point': 'train.stepp'}]},
                 {'rules': [{'point': 'train.step', 'action': 'drop',
                             'start_s': 1.0}]},
                 {'rules': [{'point': 'jobs.preempt_storm'}]}):
        with pytest.raises(ValueError) as ref_err:
            ref_faults.install_plan(plan)
        with pytest.raises(ValueError) as err:
            faults.install_plan(plan)
        assert str(err.value) == str(ref_err.value)
    assert faults.get_plan() is None
    faults.install_plan({'rules': [
        {'point': 'train.step', 'action': 'drop', 'start_s': 1.0,
         'duration_s': 5.0},
        {'point': 'engine.decode_step'}]})
    assert faults.get_plan() is not None


# -- guard components ---------------------------------------------------------
def test_spike_guard_verdicts_match_the_reference():
    rng = np.random.default_rng(4)
    kw = dict(spike_factor=3.0, warmup_steps=4, rollback_after=3,
              ema_beta=0.9)
    port, ref = train_guard.SpikeGuard(**kw), ref_guard.SpikeGuard(**kw)
    verdicts = []
    for step in range(200):
        assert port.threshold() == ref.threshold()
        gnorm = float(rng.lognormal(0.0, 0.6))
        loss = float(rng.normal(3.0, 0.1))
        if rng.random() < 0.1:
            loss = gnorm = math.nan
        bad = not (math.isfinite(gnorm) and gnorm <= ref.threshold())
        v = port.observe(step, loss, gnorm, bad)
        assert v == ref.observe(step, loss, gnorm, bad)
        if v == 'rollback':
            port.reset_after_rollback()
            ref.reset_after_rollback()
        verdicts.append(v)
    assert {'ok', 'skipped', 'rollback'} <= set(verdicts)
    assert (port.skipped_total, port.rollbacks) == (ref.skipped_total,
                                                    ref.rollbacks)


def test_supervisor_poisons_and_summarizes_as_the_reference(capsys):
    plan = {'rules': [{'point': 'train.step', 'action': 'drop',
                       'at': [2, 3]}]}
    faults.install_plan(plan)
    ref_faults.install_plan(plan)
    sups = [mod.TrainSupervisor(warmup_steps=1, rollback_after=2,
                                watchdog_deadline_s=0, install_sigterm=False)
            for mod in (train_guard, ref_guard)]
    logs = []
    for sup in sups:
        ctl = [sup.step_ctl(s) for s in range(4)]
        verdicts = [sup.observe(s, 1.0 if c[1] == 1.0 else math.nan, 1.0,
                                c[1] != 1.0) for s, c in enumerate(ctl)]
        logs.append((str(ctl), verdicts, sup.summary(),
                     capsys.readouterr().out))
    assert logs[0] == logs[1]
    assert logs[0][1] == ['ok', 'skipped', 'rollback', 'ok']


def test_exit_codes_map_to_the_recovery_statuses():
    assert train_guard.EXIT_PREEMPTED_GRACEFUL == \
        ref_guard.EXIT_PREEMPTED_GRACEFUL == 83
    assert train_guard.EXIT_WATCHDOG_ABORT == \
        ref_guard.EXIT_WATCHDOG_ABORT == 84
    assert job_lib.status_for_exit_code(
        train_guard.EXIT_PREEMPTED_GRACEFUL) == job_lib.JobStatus.PREEMPTED
    assert job_lib.status_for_exit_code(
        train_guard.EXIT_WATCHDOG_ABORT) == job_lib.JobStatus.WATCHDOG_ABORT


class _Metadata(http.server.BaseHTTPRequestHandler):
    answers = []          # per request: (status, body)
    headers_seen = []

    def do_GET(self):  # noqa: N802
        self.headers_seen.append(self.headers.get('Metadata-Flavor'))
        status, body = (self.answers.pop(0) if self.answers
                        else (200, 'FALSE'))
        self.send_response(status)
        self.end_headers()
        self.wfile.write(body.encode())

    def log_message(self, *args):
        pass


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_notice_takes_metadata_sigterm_and_injection():
    server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), _Metadata)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        _Metadata.answers[:] = [(404, ''), (200, 'FALSE'), (200, 'TRUE\n')]
        url = f'http://127.0.0.1:{server.server_address[1]}/preempted'
        notice = train_guard.PreemptionNotice(
            poll_interval_s=0.02, metadata_url=url, install_sigterm=False)
        notice.start()
        assert _wait(notice.notice.is_set)
        notice.stop()
        assert notice.reason == 'metadata' and notice.polls == 3
        assert set(_Metadata.headers_seen) == {'Google'}
        assert notice._metadata_failures == 0    # a 404 is no strike
    finally:
        server.shutdown()
        server.server_close()

    # Nothing listens: five strikes, then the endpoint is left alone.
    notice = train_guard.PreemptionNotice(poll_interval_s=0.01,
                                          install_sigterm=False)
    assert notice.metadata_url == LOCAL_METADATA
    notice.start()
    assert _wait(lambda: notice.polls >= 8)
    notice.stop()
    assert notice._metadata_failures == 5 and not notice.notice.is_set()

    faults.install_plan({'rules': [{'point': 'train.preempt_notice',
                                    'action': 'drop', 'after': 2,
                                    'scope': {'resume': '0'}}]})
    notice = train_guard.PreemptionNotice(poll_interval_s=0.01,
                                          install_sigterm=False,
                                          ctx={'resume': '0'})
    notice.start()
    assert _wait(notice.notice.is_set)
    notice.stop()
    assert notice.reason == 'injected' and notice.polls == 3

    before = signal.getsignal(signal.SIGTERM)
    notice = train_guard.PreemptionNotice(poll_interval_s=60.0)
    notice.start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait(notice.notice.is_set)
    finally:
        notice.stop()
    assert notice.reason == 'sigterm'
    assert signal.getsignal(signal.SIGTERM) is before


def test_watchdog_dumps_stacks_and_exits_84(tmp_path):
    # faulthandler writes to a file descriptor: a real file, not StringIO.
    codes, stream = [], open(tmp_path / 'dump.txt', 'w+', encoding='utf-8')
    dog = train_guard.StepWatchdog(0.3, poll_interval_s=0.02,
                                   exit_fn=codes.append, stream=stream)
    dog.start()
    for _ in range(20):           # beats keep it quiet
        dog.beat('step')
        time.sleep(0.03)
    assert codes == []
    dog.beat('data')
    assert _wait(lambda: codes, timeout=5.0)
    dog.stop()
    assert codes == [84] and dog.fired
    stream.close()
    out = (tmp_path / 'dump.txt').read_text()
    assert "step-watchdog: phase 'data' stalled" in out
    assert 'exit code 84' in out and 'File ' in out   # the stack dump


def test_policy_and_timeline_copies_match_the_reference(tmp_path,
                                                        monkeypatch):
    assert policy.DEFAULT_CKPT_OVERHEAD_S == ref_policy.DEFAULT_CKPT_OVERHEAD_S
    for rate in (0.0, 0.01, 0.5, 2.0, 50.0, 5000.0):
        for overhead in (0.0, 1.5, 60.0, 900.0):
            assert policy.optimal_checkpoint_interval(rate, overhead) == \
                ref_policy.optimal_checkpoint_interval(rate, overhead)
    traces = []
    for mod, name in ((timeline, 'port.json'), (ref_timeline, 'ref.json')):
        monkeypatch.setattr(mod, '_enabled_path', str(tmp_path / name))
        monkeypatch.setattr(mod, '_events', [])
        monkeypatch.setattr(mod, '_saved', False)
        with mod.Event('train/step', 'step 3'):
            pass
        mod.event('decorated')(lambda: None)()
        mod.save()
        traces.append(json.loads((tmp_path / name).read_text()))
    shape = [[(e['name'], e['ph'], e['cat'], e['args'], sorted(e))
              for e in t['traceEvents']] for t in traces]
    assert shape[0] == shape[1] and len(shape[0]) == 2


# -- the guarded step ---------------------------------------------------------
def _port_config(jax_cfg):
    fields = {f.name for f in dataclasses.fields(pt_llama.LlamaConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jax_cfg).items()
            if k in fields and k not in ('dtype', 'rope_scaling', 'remat')}
    return pt_llama.LlamaConfig(dtype=torch.float32,
                                param_dtype=torch.float32, **vals)


def _tokens(step, vocab):
    return np.random.default_rng(100 + step).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int32)


# (max_grad_norm, loss_scale) per step: NaN at step 3, a spike at step 5.
GUARD_CTL = [(math.inf, 1.0)] * 3 + [(math.inf, math.nan), (math.inf, 1.0),
                                     (1e-3, 1.0)]


def test_guarded_step_matches_jax_guarded_step():
    model, _, _ = _build_model('llama-tiny', SEQ, remat=False)
    cfg = dataclasses.replace(model.config, dtype=jnp.float32)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    jtrainer = jax_train.ShardedTrainer(
        jax_llama.Llama(cfg), mesh, tx=jax_train.default_optimizer(
            learning_rate=LR, warmup_steps=2, total_steps=20), guard=True)
    example = jnp.zeros((BATCH, SEQ), jnp.int32)
    jstate = jtrainer.init(jax.random.PRNGKey(0), example)
    init = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jax.device_get(jstate.params))
    jstep = jtrainer.make_train_step(example, donate=False)

    pmodel = convert.train_params_from_jax(init, _port_config(cfg),
                                           device='cpu')
    ptrainer = pt_train.ShardedTrainer(
        pmodel, tx=pt_train.default_optimizer(learning_rate=LR,
                                              warmup_steps=2,
                                              total_steps=20), guard=True)
    pstate = ptrainer.init()
    pstep = ptrainer.make_train_step()
    got, want = [], []
    for i, (max_norm, scale) in enumerate(GUARD_CTL):
        toks = _tokens(i, cfg.vocab_size)
        jstate, (jl, jg, jb) = jstep(jstate, jnp.asarray(toks), max_norm,
                                     scale)
        pstate, (pl, pg, pb) = pstep(pstate,
                                     torch.from_numpy(toks).long(),
                                     max_norm, scale)
        want.append((float(jl), float(jg), bool(jb)))
        got.append((pl.item(), pg.item(), bool(pb)))
    assert [b for *_, b in got] == [b for *_, b in want] == \
        [False, False, False, True, False, True]
    for (pl, pg, _), (jl, jg, _) in zip(got, want):
        np.testing.assert_allclose([pl, pg], [jl, jg], rtol=TOL, atol=TOL)
    jcounts = {int(c) for _, c in optax.tree_utils.tree_get_all_with_path(
        jstate.opt_state, 'count')}
    assert jcounts == {int(pstate.opt_state['count'])} == {4}
    assert pstate.step == int(jstate.step) == 6
    want_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                               jax.device_get(jstate.params))
    got_params = convert.train_params_to_jax(pmodel)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_params))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        assert np.abs(flat_got[path] - leaf).max() <= PARAM_TOL, path


def _tiny(lora=None, seed=0):
    cfg = dataclasses.replace(registry.train_config('llama-tiny', 64),
                              dtype=torch.float32)
    model = convert.init_params(cfg, seed=seed, device='cpu')
    return model, (None if lora is None else pt_lora.LoraSpec(4, 8.0))


def _snapshot(state):
    leaves = pt_train.trainable_leaves(state.params)
    return [t.detach().clone() for t in
            leaves + state.opt_state['mu'] + state.opt_state['nu']]


@pytest.mark.parametrize('lora', [None, 'lora'])
def test_guarded_good_step_is_the_unguarded_step_bit_for_bit(lora):
    states, losses = [], []
    for guard in (False, True):
        model, spec = _tiny(lora)
        trainer = pt_train.ShardedTrainer(
            model, tx=pt_train.default_optimizer(learning_rate=LR,
                                                 warmup_steps=2,
                                                 total_steps=20),
            collect_grad_norm=True, lora=spec, guard=guard)
        state = trainer.init(seed=3)
        step = trainer.make_train_step()
        run = []
        for i in range(4):
            toks = torch.from_numpy(_tokens(i, 512)).long()
            state, aux = step(state, toks)
            run.append([t.item() for t in aux[:2]])
            if guard:
                assert not aux[2].item()
        states.append(state)
        losses.append(run)
    assert losses[0] == losses[1]
    for a, b in zip(_snapshot(states[0]), _snapshot(states[1])):
        assert torch.equal(a, b)
    assert int(states[0].opt_state['count']) == \
        int(states[1].opt_state['count']) == 4

    # A poisoned step, and a spike: nothing moves but state.step, not
    # even the sign of a zero.
    guarded = states[1]
    with torch.no_grad():
        for t in (pt_train.trainable_leaves(guarded.params)[0],
                  guarded.opt_state['mu'][1]):
            t.view(-1)[:2] = torch.tensor([-0.0, 0.0])
    before = _snapshot(guarded)
    step = trainer.make_train_step()
    for max_norm, scale in ((math.inf, math.nan), (1e-9, 1.0)):
        guarded, (loss, gnorm, bad) = step(
            guarded, torch.from_numpy(_tokens(9, 512)).long(), max_norm,
            scale)
        assert bad.item()
    # Bit for bit: the int32 views, so a -0.0 that came back +0.0 fails.
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(before, _snapshot(guarded)))
    assert int(guarded.opt_state['count']) == 4 and guarded.step == 6


class _HostCountAdamW(pt_train.ClippedAdamW):
    """The optimizer as it was with a host int count: python-float lr
    and bias corrections (the values the device table must keep)."""

    @torch.no_grad()
    def update(self, leaves, grads, state, norm=None, bad=None):
        grads = [g.float() for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=torch.float32)
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, one * self.grad_clip)
        count = state['count']
        bc1 = float(np.float32(1) - np.float32(self.b1)
                    ** np.float32(count + 1))
        bc2 = float(np.float32(1) - np.float32(self.b2)
                    ** np.float32(count + 1))
        lr = self.lr(count)
        for p, g, mu, nu in zip(leaves, grads, state['mu'], state['nu']):
            g = g.div_(div).mul_(mul)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        state['count'] = count + 1
        return norm


def test_device_count_keeps_the_host_count_values():
    shapes = [(37, 19), (64,), (5, 3, 7)]
    runs = []
    for cls in (pt_train.ClippedAdamW, _HostCountAdamW):
        opt = cls(pt_train.WarmupCosineSchedule(0.0, 3e-3, 3, 12),
                  grad_clip=0.5)
        rng = np.random.default_rng(1)
        leaves = [torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32))
                  for s in shapes]
        state = opt.init(leaves)
        if cls is _HostCountAdamW:
            state['count'] = 0
        for _ in range(15):    # past the schedule's end
            grads = [torch.from_numpy(rng.normal(0, 0.3, s)
                                      .astype(np.float32)) for s in shapes]
            opt.update(leaves, grads, state)
        runs.append(leaves + state['mu'] + state['nu'])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # Counts past the table read its last row, which is each value's
    # limit in f32.
    opt = pt_train.default_optimizer(warmup_steps=10, total_steps=50)
    tab = opt.table(torch.device('cpu'))
    for c in (0, 9, 10, 49, 50, 339, len(tab) - 1, len(tab) + 5, 5000):
        row = tab[min(c, len(tab) - 1)].tolist()
        assert row == [opt.lr(c),
                       float(np.float32(1) - np.float32(0.9)
                             ** np.float32(c + 1)),
                       float(np.float32(1) - np.float32(0.95)
                             ** np.float32(c + 1))], c


# -- train_lm -----------------------------------------------------------------
def _env(plan=None):
    # Two threads a child: the runs stay steady beside other test workers.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', JAX_PLATFORMS='cpu',
               OMP_NUM_THREADS='2')
    env[train_guard.METADATA_URL_ENV] = LOCAL_METADATA
    env.pop('STPU_FAULT_PLAN', None)
    env.pop('XLA_FLAGS', None)
    if plan is not None:
        env['STPU_FAULT_PLAN'] = plan if isinstance(plan, str) \
            else json.dumps(plan)
    return env


def _cmd(package, *argv):
    flags = ['--cpu', '--model', 'llama-tiny', '--seq', '16',
             '--global-batch', '4', *argv]
    return [sys.executable, '-m', f'{package}.recipes.train_lm', *flags]


def _run(package, *argv, plan=None, timeout=300):
    return subprocess.run(_cmd(package, *argv), cwd=ROOT, env=_env(plan),
                          capture_output=True, text=True, timeout=timeout)


def _events(out):
    keep = ('train-guard', 'preemption notice', 'resumed from',
            'step-watchdog')
    return [l for l in out.splitlines() if l.startswith(keep)]


def _read_jsonl(path):
    return [json.loads(l) for l in Path(path).read_text().splitlines()]


def test_nan_skip_and_rollback_as_the_jax_recipe(tmp_path):
    plan = {'rules': [{'point': 'train.step', 'action': 'drop',
                       'at': [5, 6, 7]}]}
    outs = {}
    for package in ('skypilot_tpu_torch', 'skypilot_tpu'):
        d = tmp_path / package
        proc = _run(package, '--steps', '10', '--log-every', '1', '--guard',
                    '--guard-warmup', '1', '--rollback-after', '3',
                    '--ckpt-dir', str(d / 'ckpt'), '--ckpt-every', '4',
                    '--metrics-file', str(d / 'steps.jsonl'), plan=plan)
        outs[package] = proc.stdout + proc.stderr
        assert proc.returncode == 0, outs[package]
    out = outs['skypilot_tpu_torch']
    assert _events(out) == _events(outs['skypilot_tpu'])
    assert out.count('injected NaN into step') == 3
    assert 'update skipped' in out and 'rolling back' in out
    assert 'rolled back to last checkpoint (step 4)' in out
    assert "'skipped_steps': 3, 'rollbacks': 1" in out
    records = _read_jsonl(tmp_path / 'skypilot_tpu_torch' / 'steps.jsonl')
    steps = [r['step'] for r in records]
    assert steps[-1] == 10
    assert any(b <= a for a, b in zip(steps, steps[1:])), steps
    assert set(steps) >= set(range(1, 11)), steps
    assert math.isfinite(records[-1]['loss'])


def test_committed_chaos_plan_watchdog_then_relaunch(tmp_path):
    """The committed plan: NaN at steps 4-6 (skip, rollback to step 4),
    then the 13th batch fetch stalls 300 s on the first launch: the
    watchdog dumps stacks naming next_tokens and exits 84 within its
    deadline; the relaunch (resume=1) is spared and finishes."""
    # A deadline far below the stall and far above a step.
    argv = ['--steps', '12', '--log-every', '1', '--guard', '--guard-warmup',
            '1', '--rollback-after', '3', '--watchdog-deadline', '8',
            '--ckpt-dir', str(tmp_path / 'ckpt'), '--ckpt-every', '4']
    t0 = time.monotonic()
    first = _run('skypilot_tpu_torch', *argv, plan=str(CHAOS_PLAN))
    out = first.stdout + first.stderr
    assert first.returncode == train_guard.EXIT_WATCHDOG_ABORT, out
    assert time.monotonic() - t0 < 120
    assert out.count('injected NaN into step') == 3
    assert 'rolled back to last checkpoint (step 4)' in out
    assert "step-watchdog: phase 'data' stalled" in out
    assert 'next_tokens' in out
    second = _run('skypilot_tpu_torch', *argv, plan=str(CHAOS_PLAN))
    out2 = second.stdout + second.stderr
    assert second.returncode == 0, out2
    assert 'resumed from checkpoint step 8' in out2
    assert 'injected NaN' not in out2 and 'training done' in out2


def test_preempt_notice_rc83_then_resume(tmp_path):
    plan = {'rules': [{'point': 'train.preempt_notice', 'action': 'drop',
                       'scope': {'resume': '0'}, 'after': 1}]}
    metrics = tmp_path / 'steps.jsonl'
    argv = ['--steps', '6', '--log-every', '1', '--guard', '--preempt-poll',
            '0.3', '--ckpt-dir', str(tmp_path / 'ckpt'), '--ckpt-every',
            '100', '--metrics-file', str(metrics)]
    # Slow the steps a little so the notice lands mid-run.
    slow = dict(plan, rules=plan['rules'] + [
        {'point': 'train.data_next', 'action': 'delay', 'delay_s': 0.2}])
    first = _run('skypilot_tpu_torch', *argv, plan=slow)
    out = first.stdout + first.stderr
    assert first.returncode == train_guard.EXIT_PREEMPTED_GRACEFUL, out
    assert 'preemption notice (injected)' in out
    saved = [int(d) for d in os.listdir(tmp_path / 'ckpt') if d.isdigit()]
    assert saved and f'at step {max(saved)}:' in out
    second = _run('skypilot_tpu_torch', *argv, plan=plan)
    out2 = second.stdout + second.stderr
    assert second.returncode == 0, out2
    assert f'resumed from checkpoint step {max(saved)}' in out2
    assert 'training done' in out2
    steps = [r['step'] for r in _read_jsonl(metrics)]
    assert steps[-1] == 6
    assert steps == sorted(steps) and len(steps) == len(set(steps)), steps


def test_sigterm_is_taken_at_the_next_step_boundary(tmp_path):
    ckpt = tmp_path / 'ckpt'
    proc = subprocess.Popen(
        _cmd('skypilot_tpu_torch', '--steps', '400', '--log-every', '1',
             '--guard', '--ckpt-dir', str(ckpt), '--ckpt-every', '1000'),
        cwd=ROOT, env=_env({'rules': [{'point': 'train.data_next',
                                       'action': 'delay',
                                       'delay_s': 0.2}]}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith('step 1/'):
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    out = ''.join(lines)
    assert rc == train_guard.EXIT_PREEMPTED_GRACEFUL, out
    notice = [l for l in lines if l.startswith('preemption notice')]
    assert len(notice) == 1 and 'notice (sigterm) at step ' in notice[0]
    at = int(notice[0].split('at step ')[1].split(':')[0])
    logged = [int(l.split()[1].split('/')[0]) for l in lines
              if l.startswith('step ')]
    # The step in flight finished, the next one never started.
    assert logged[-1] == at and 1 <= at <= 5, out
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [at]


# -- --init-from-hf -----------------------------------------------------------
@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp('hf_llama')
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=384,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False))
    model.to(torch.bfloat16).save_pretrained(str(path),
                                             safe_serialization=True)
    return path


def test_init_from_hf_masters_are_the_checkpoint_upcast(hf_dir, tmp_path,
                                                        capsys):
    ckpt = tmp_path / 'ckpt'
    train_lm.main(['--cpu', '--init-from-hf', str(hf_dir), '--steps', '1',
                   '--seq', '32', '--global-batch', '2', '--ckpt-dir',
                   str(ckpt)])
    assert f'initializing from HF checkpoint {hf_dir} (Llama, vocab=512)' \
        in capsys.readouterr().out
    # lr(0) = 0: the step-1 checkpoint holds the masters as loaded.
    saved = torch.load(ckpt / '1' / 'state.pt', weights_only=True)['params']
    files = hf_import.read_safetensors(str(hf_dir / 'model.safetensors'))
    pairs = {'tok_embed': 'model.embed_tokens.weight',
             'lm_head': 'lm_head.weight',
             'final_norm.scale': 'model.norm.weight',
             'layers.1.attn.wq.weight':
                 'model.layers.1.self_attn.q_proj.weight',
             'layers.0.mlp.w_down.weight':
                 'model.layers.0.mlp.down_proj.weight',
             'layers.0.attn_norm.scale':
                 'model.layers.0.input_layernorm.weight'}
    assert len(saved) == 3 + 2 * 9
    for ours, theirs in pairs.items():
        assert files[theirs].dtype == torch.bfloat16
        assert saved[ours].dtype == torch.float32
        assert torch.equal(saved[ours], files[theirs].float()), ours


def test_init_from_hf_lora_relaunch_rebuilds_its_base(hf_dir, tmp_path,
                                                      capsys):
    ckpt = tmp_path / 'ckpt'
    argv = ['--cpu', '--init-from-hf', str(hf_dir), '--lora', '4', '--seq',
            '32', '--global-batch', '2', '--ckpt-dir', str(ckpt),
            '--ckpt-every', '2', '--log-every', '1']
    train_lm.main(argv + ['--steps', '2'])
    config = json.loads((ckpt / 'adapter' / 'adapter_config.json')
                        .read_text())
    assert config['base_model'] == str(hf_dir) and config['step'] == 2
    capsys.readouterr()
    train_lm.main(argv + ['--steps', '3'])
    out = capsys.readouterr().out
    assert 'resumed from checkpoint step 2' in out and 'step 3/3' in out
    with pytest.raises(ValueError, match='over base'):
        train_lm.main(['--cpu', '--model', 'llama-tiny', '--lora', '4',
                       '--seq', '32', '--global-batch', '2', '--ckpt-dir',
                       str(ckpt), '--steps', '4'])
