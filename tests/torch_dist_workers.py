"""Worker bodies of the port's multi-process tests (test_torch_mesh.py,
test_torch_fsdp.py): each runs in a process spawned by
`skypilot_tpu_torch.parallel.distributed.launch`, joins a gloo job on
the CPU and writes what it saw to `<out>/rank<r>.pt` for the test to
read. Imports torch and the port only (no JAX), so a spawn stays
cheap.
"""
import dataclasses
import os

import numpy as np
import torch

LR = 1e-2
STEPS = 5
BATCH, SEQ = 4, 24
POISON_STEP = 2
ODD_VOCAB = 509


def tokens_for(step, vocab):
    return np.random.default_rng(100 + step).integers(
        0, vocab, (BATCH, SEQ)).astype(np.int64)


def f32_config(name, remat=False):
    from skypilot_tpu_torch.models import registry
    return dataclasses.replace(registry.train_config(name, SEQ, remat),
                               dtype=torch.float32)


def build(name, remat=False, device='cpu', **fields):
    """The f32 training model of `name`; `fields` replace config fields
    (an odd vocab_size makes FSDP2's dim-0 shards uneven)."""
    from skypilot_tpu_torch.models import convert
    cfg = dataclasses.replace(f32_config(name, remat), **fields)
    return convert.init_params(cfg, seed=0, device=device)


def loss_fn_for(model):
    from skypilot_tpu_torch.models.mixtral import Mixtral, moe_next_token_loss
    return moe_next_token_loss if isinstance(model, Mixtral) else None


def make_trainer(model, mesh=None, lora=None, **kw):
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.parallel import train
    spec = None if lora is None else lora_lib.LoraSpec(rank=lora[0],
                                                       alpha=lora[1])
    return train.ShardedTrainer(
        model, tx=train.default_optimizer(learning_rate=LR, warmup_steps=10,
                                          total_steps=20),
        loss_fn=loss_fn_for(model), lora=spec, mesh=mesh, **kw)


def run_steps(trainer, state, rows=slice(None), poison=None):
    """STEPS steps on the shared token stream (this rank's rows); the
    job-wide losses and grad norms, and the guard's verdicts."""
    vocab = trainer.model.config.vocab_size
    step = trainer.make_train_step()
    losses, norms, bads = [], [], []
    for i in range(STEPS):
        tokens = torch.from_numpy(tokens_for(i, vocab)[rows])
        if trainer.guard:
            state, (loss, gnorm, bad) = step(
                state, tokens, loss_scale=poison(i) if poison else 1.0)
            bads.append(bool(bad))
        else:
            state, (loss, gnorm) = step(state, tokens)
        losses.append(float(loss))
        norms.append(float(gnorm))
    return state, losses, norms, bads


def whole_params(state):
    """{name: whole f32 numpy} of a sharded or unsharded state."""
    from skypilot_tpu_torch.parallel.train import trainable_items
    out = {}
    for i, (name, t) in enumerate(trainable_items(state.params)):
        if state.layout is not None:
            t = state.layout.full(i, state.layout.local(t))
        out[name] = t.detach().float().numpy().copy()
    return out


def whole_moments(state):
    if state.layout is None:
        return [m.numpy().copy() for m in state.opt_state['mu']]
    return [state.layout.full(i, m, moment=True).numpy().copy()
            for i, m in enumerate(state.opt_state['mu'])]


def watched_save(mgr, state):
    """mgr.save(state.step, state, force=True), counting the whole
    leaves `state.layout.full` returns that are alive at once (a result
    that is the caller's own tensor is no copy and does not count):
    (saved, most alive at once, calls)."""
    import weakref
    layout = state.layout
    full, live, seen = layout.full, [], {'peak': 0, 'calls': 0}

    def watched(i, local, moment=False):
        out = full(i, local, moment=moment)
        live[:] = [r for r in live if r() is not None]
        if out.data_ptr() != local.data_ptr():
            live.append(weakref.ref(out))
        seen['peak'] = max(seen['peak'], len(live))
        seen['calls'] += 1
        return out

    layout.full = watched
    try:
        saved = mgr.save(state.step, state, force=True)
    finally:
        del layout.full
    return saved, seen['peak'], seen['calls']


def _save(out, job, result):
    torch.save(result, os.path.join(out, f'rank{job.rank}.pt'))


# -- test_torch_mesh.py -------------------------------------------------------
def mesh_job(job, out, configs):
    """make_mesh on this job for each config: the rank grid, axis names,
    this rank's coordinate and rows, and the summary."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        result = {}
        for key, cfg in configs:
            if cfg is None:
                cfg = mesh_lib.MeshConfig.auto()
            mesh = mesh_lib.make_mesh(cfg)
            rows = mesh_lib.batch_rows(mesh, 8)
            result[key] = {
                'config': cfg,
                'grid': mesh.mesh.tolist(),
                'names': tuple(mesh.mesh_dim_names),
                'coordinate': list(mesh.get_coordinate()),
                'rows': (rows.start, rows.stop),
                'summary': mesh_lib.mesh_summary(mesh),
                'fsdp_group': sorted(torch.distributed.get_process_group_ranks(
                    mesh['fsdp'].get_group())),
            }
        _save(out, job, result)
    finally:
        distributed.leave()


# -- test_torch_fsdp.py -------------------------------------------------------
def fsdp_job(job, out, ckpt_dir):
    """World 2 (mesh auto: fsdp=2): llama-tiny (saved as a checkpoint at
    the end), the same with an odd vocab (saved to `ckpt_dir`_odd), its
    remat, LoRA, GPT-2, Mixtral, DeepSeek; and a guarded run on data=2
    whose step POISON_STEP is poisoned on rank 1 only."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    from skypilot_tpu_torch.parallel.train import trainable_items
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(job.world))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        result = {}
        model = build('llama-tiny')
        trainer = make_trainer(model, mesh, collect_grad_norm=True)
        state = trainer.init()
        result['fractions'] = {
            name: trainer.layout.local(t).numel() / t.numel()
            for name, t in trainable_items(state.params)}
        state, losses, norms, _ = run_steps(trainer, state, rows)
        result['llama'] = {'losses': losses, 'norms': norms,
                           'params': whole_params(state),
                           'mu': whole_moments(state)}
        mgr = CheckpointManager(ckpt_dir)
        result['saved'], peak, calls = watched_save(mgr, state)
        result['save_whole_leaves'] = {'peak': peak, 'calls': calls,
                                       'leaves': len(trainer.layout.leaves)}
        result['saved_again'] = mgr.save(state.step, state, force=True)

        # An odd vocab: the tables' dim-0 shards are 255 and 254 rows.
        trainer = make_trainer(build('llama-tiny', vocab_size=ODD_VOCAB),
                               mesh, collect_grad_norm=True)
        state = trainer.init()
        state, losses, norms, _ = run_steps(trainer, state, rows)
        result['odd'] = {'losses': losses, 'norms': norms,
                         'params': whole_params(state),
                         'mu': whole_moments(state),
                         'local_rows': trainer.layout.local(
                             state.params['tok_embed']).shape[0]}
        CheckpointManager(ckpt_dir + '_odd').save(state.step, state,
                                                  force=True)

        for key, name, kw in (('remat', 'llama-tiny', {'remat': True}),
                              ('gpt', 'tiny', {}),
                              ('mixtral', 'mixtral-tiny', {}),
                              ('deepseek', 'deepseek-tiny', {})):
            trainer = make_trainer(build(name, **kw), mesh,
                                   collect_grad_norm=True)
            state, losses, norms, _ = run_steps(trainer, trainer.init(),
                                                rows)
            result[key] = {'losses': losses, 'norms': norms,
                           'params': whole_params(state)}

        trainer = make_trainer(build('llama-tiny'), mesh, lora=(4, 8.0),
                               collect_grad_norm=True)
        state = trainer.init()
        base0 = {n: trainer.layout.local(t).clone()
                 for n, t in state.params['base'].items()}
        state, losses, norms, _ = run_steps(trainer, state, rows)
        result['lora'] = {
            'losses': losses, 'norms': norms,
            'factors': whole_params(state),
            'base_kept': all(torch.equal(trainer.layout.local(t), base0[n])
                             for n, t in state.params['base'].items())}

        data_mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=job.world))
        trainer = make_trainer(build('llama-tiny'), data_mesh, guard=True)
        state = trainer.init()
        seen = {}

        def poison(i):
            if i == POISON_STEP:
                seen['before'] = whole_params(state)
                seen['count'] = int(state.opt_state['count'])
            if i == POISON_STEP + 1:
                seen['after'] = whole_params(state)
                seen['count_after'] = int(state.opt_state['count'])
            return float('nan') if (i == POISON_STEP and job.rank == 1) \
                else 1.0

        state, losses, norms, bads = run_steps(
            trainer, state, mesh_lib.batch_rows(data_mesh, BATCH), poison)
        local = {n: trainer.layout.local(t).numpy().copy()
                 for n, t in state.params.items()}
        result['guard'] = {
            'losses': losses, 'norms': norms, 'bads': bads,
            'kept': all(np.array_equal(seen['before'][n], seen['after'][n])
                        for n in seen['before']),
            'count': (seen['count'], seen['count_after']),
            'local': local}
        _save(out, job, result)
    finally:
        distributed.leave()


def zero1_job(job, out, ckpt_in, ckpt_dir):
    """World 4 on data=2 x fsdp=2: zero1 off, on, and on with overlap;
    the zero1 run's moment pieces; restores of the world-2 checkpoints
    `ckpt_in` into a zero1 trainer (saved again to `ckpt_dir`/a) and
    `ckpt_in`_odd (uneven shards; again to `ckpt_dir`/odd), and of the
    zero1 run's own checkpoint (`ckpt_dir`/b) into a zero1-off
    trainer."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    from skypilot_tpu_torch.parallel.train import trainable_items
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=2, fsdp=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        result = {}
        for key, kw in (('off', {}), ('zero1', {'zero1': True}),
                        ('overlap', {'zero1': True, 'overlap': True})):
            trainer = make_trainer(build('llama-tiny'), mesh,
                                   collect_grad_norm=True, **kw)
            state = trainer.init()
            state, losses, norms, _ = run_steps(trainer, state, rows)
            items = trainable_items(state.params)
            result[key] = {
                'losses': losses, 'norms': norms,
                'params': whole_params(state),
                'pieces': [(trainer.layout.local(t).numel(), mu.numel(),
                            trainer.layout.leaves[i].zero1_dim)
                           for i, ((_, t), mu) in enumerate(
                               zip(items, state.opt_state['mu']))],
                'mu_fractions': {name: mu.numel() / t.numel()
                                 for (name, t), mu in zip(
                                     items, state.opt_state['mu'])}}
            if key == 'zero1':
                mgr = CheckpointManager(os.path.join(ckpt_dir, 'b'))
                _, peak, calls = watched_save(mgr, state)
                result['save_whole_leaves'] = {
                    'peak': peak, 'calls': calls,
                    'leaves': len(trainer.layout.leaves)}
                zero1_state = (whole_params(state), whole_moments(state))

        z1 = make_trainer(build('llama-tiny'), mesh, zero1=True)
        state = z1.init()
        mgr = CheckpointManager(ckpt_in)
        state = mgr.restore(state)
        result['restored_step'] = (state.step, mgr.last_restored_step)
        CheckpointManager(os.path.join(ckpt_dir, 'a')).save(
            state.step, state, force=True)

        odd = make_trainer(build('llama-tiny', vocab_size=ODD_VOCAB), mesh,
                           zero1=True)
        state = CheckpointManager(ckpt_in + '_odd').restore(odd.init())
        CheckpointManager(os.path.join(ckpt_dir, 'odd')).save(
            state.step, state, force=True)

        off = make_trainer(build('llama-tiny'), mesh)
        state = off.init()
        state = CheckpointManager(os.path.join(ckpt_dir, 'b')).restore(state)
        params, mu = whole_params(state), whole_moments(state)
        result['toggled_equal'] = (
            all(np.array_equal(params[n], zero1_state[0][n])
                for n in params)
            and all(np.array_equal(a, b) for a, b in zip(mu, zero1_state[1])))
        _save(out, job, result)
    finally:
        distributed.leave()
