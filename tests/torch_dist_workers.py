"""Worker bodies of the port's multi-process tests (test_torch_mesh.py,
test_torch_fsdp.py): each runs in a process spawned by
`skypilot_tpu_torch.parallel.distributed.launch`, joins a gloo job on
the CPU and writes what it saw to `<out>/rank<r>.pt` for the test to
read. Imports torch and the port only (no JAX), so a spawn stays
cheap.
"""
import contextlib
import dataclasses
import functools
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
    if hasattr(state.layout, 'whole'):      # tensor shards in process
        return {n: t.detach().float().numpy().copy() for n, t in
                state.layout.whole(dict(trainable_items(
                    state.params))).items()}
    out = {}
    for i, (name, t) in enumerate(trainable_items(state.params)):
        if state.layout is not None:
            t = state.layout.full(i, state.layout.local(t))
        out[name] = t.detach().float().numpy().copy()
    return out


def whole_moments(state):
    from skypilot_tpu_torch.parallel.train import trainable_items
    if hasattr(state.layout, 'whole'):      # tensor shards in process
        names = [n for n, _ in trainable_items(state.params)]
        return [m.numpy().copy() for m in state.layout.whole(
            dict(zip(names, state.opt_state['mu']))).values()]
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


# -- test_torch_ring.py, test_torch_context.py, test_torch_expert.py ---------
RING_SHAPE = (2, 32, 2, 8)      # B, S, H, D over a 4-rank ring


def ring_inputs():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(RING_SHAPE, generator=g) for _ in range(4)]


def ring_job(job, out):
    """MeshConfig(seq=4): ring attention of this rank's blocks, causal
    and not, its grads for a seeded upstream gradient, the perturbed
    ring's output, and the dispatch's ring route with GQA k/v."""
    from skypilot_tpu_torch.ops import attention as attention_ops
    from skypilot_tpu_torch.ops import ring_attention as ra
    from skypilot_tpu_torch.parallel import context, distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(seq=job.world))
        ring = context.seq_group_of(mesh)
        q, k, v, do = ring_inputs()
        blk = mesh_lib.seq_block(mesh, q.shape[1])
        result = {'block': (blk.start, blk.stop), 'ring': ring.ranks,
                  'index': ring.index}
        for causal in (True, False):
            parts = [x[:, blk].clone().requires_grad_(True)
                     for x in (q, k, v)]
            steps = ra.fwd_steps, ra.bwd_steps
            o = ra.ring_attention(*parts, ring, causal=causal)
            o.backward(do[:, blk])
            result[causal] = {
                'out': o.detach().numpy(),
                'grads': [p.grad.numpy() for p in parts],
                'steps': (ra.fwd_steps - steps[0], ra.bwd_steps - steps[1]),
                'perturbed': ra.ring_attention(
                    *[p.detach() for p in parts], ring, causal=causal,
                    skip_rotation=1).numpy()}
        # The dispatch under context_parallel: GQA k/v (1 kv head of 2)
        # repeated before the ring.
        with context.context_parallel(mesh):
            result['gqa'] = attention_ops.dot_product_attention(
                q[:, blk], k[:, blk, :1], v[:, blk, :1]).numpy()
        _save(out, job, result)
    finally:
        distributed.leave()


def seq_run(name, mesh, rows, remat=False, **kw):
    trainer = make_trainer(build(name, remat), mesh, collect_grad_norm=True,
                           **kw)
    state, losses, norms, _ = run_steps(trainer, trainer.init(), rows)
    return trainer, state, {'losses': losses, 'norms': norms,
                            'params': whole_params(state)}


def context_job(job, out):
    """World 4 on MeshConfig.auto(4, seq=2) (fsdp=2 x seq=2): llama-tiny,
    its remat, and deepseek-tiny (the warnings it gave), and this
    rank's sequence block; world 2 is `context2_job`."""
    import warnings
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(job.world, seq=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        blk = mesh_lib.seq_block(mesh, SEQ)
        result = {'summary': mesh_lib.mesh_summary(mesh),
                  'rows': (rows.start, rows.stop),
                  'block': (blk.start, blk.stop)}
        _, _, result['llama'] = seq_run('llama-tiny', mesh, rows)
        _, _, result['remat'] = seq_run('llama-tiny', mesh, rows, remat=True)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            _, _, result['deepseek'] = seq_run('deepseek-tiny', mesh, rows)
        result['deepseek']['warnings'] = sorted({str(w.message)
                                                 for w in seen})
        _save(out, job, result)
    finally:
        distributed.leave()


def context2_job(job, out):
    """World 2 on MeshConfig.auto(2, seq=2): GPT-2 `tiny` (the
    reference's context-parallel GPT test) and its eval loss."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(job.world, seq=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        trainer, state, result = seq_run('tiny', mesh, rows)
        result['eval'] = float(trainer.make_eval_step()(
            state, torch.from_numpy(tokens_for(0, 512))))
        _save(out, job, {'gpt': result})
    finally:
        distributed.leave()


def expert_leaf_grads(trainer, skew=0.0):
    """Spy on the layout's reduce_grads: the local gradient of every leaf
    the expert ranks all hold, as backward left it, each step. With
    `skew`, expert rank 1 scales those gradients by 1 + skew first: the
    copies diverge, as a backward that is not deterministic to the last
    bit (the card's flash dQ) makes them diverge."""
    layout, seen = trainer.layout, []
    orig = layout.reduce_grads

    def spy(leaves):
        grads = {}
        for leaf, t in zip(layout.leaves, leaves):
            if leaf.experts == 1:
                g = layout.local(t.grad)
                if skew and layout.expert_index == 1:
                    g.mul_(1 + skew)
                grads[leaf.name] = g.detach().clone().numpy()
        seen.append(grads)
        return orig(leaves)

    layout.reduce_grads = spy
    return seen


def expert_run(mesh, rows, skew=0.0, poison=None):
    """mixtral-tiny over `mesh`: the curve, whole params, each leaf's
    local share, the replicated leaves' raw grads (skewed on expert rank
    1 by `skew`) and final local values (compared across expert
    ranks)."""
    from skypilot_tpu_torch.parallel.train import trainable_items
    trainer = make_trainer(build('mixtral-tiny'), mesh,
                           collect_grad_norm=True, guard=poison is not None)
    state = trainer.init()
    fractions = {name: trainer.layout.local(t).numel() / int(np.prod(
        leaf.shape)) for (name, t), leaf in zip(
            trainable_items(state.params), trainer.layout.leaves)}
    grads = expert_leaf_grads(trainer, skew)
    state, losses, norms, bads = run_steps(trainer, state, rows, poison)
    layout = trainer.layout
    return trainer, state, {
        'losses': losses, 'norms': norms, 'bads': bads,
        'params': whole_params(state), 'fractions': fractions,
        'grads': grads, 'reductions': dict(layout.reductions),
        'replicated': {leaf.name: layout.local(t).detach().numpy().copy()
                       for leaf, (_, t) in zip(
                           layout.leaves, trainable_items(state.params))
                       if leaf.experts == 1}}


def expert2_job(job, out, ckpt_dir):
    """World 2 on MeshConfig.auto(2, expert=2): mixtral-tiny, saved to
    `ckpt_dir` (the save's whole-leaf peak watched), and llama-tiny (no
    expert leaf: both ranks do the same work)."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(job.world,
                                                           expert=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        trainer, state, result = expert_run(mesh, rows)
        result['summary'] = mesh_lib.mesh_summary(mesh)
        result['mu'] = whole_moments(state)
        mgr = CheckpointManager(ckpt_dir)
        result['saved'], peak, calls = watched_save(mgr, state)
        result['save_whole_leaves'] = {'peak': peak, 'calls': calls,
                                       'leaves': len(trainer.layout.leaves)}
        _, _, llama = seq_run('llama-tiny', mesh, rows)
        _save(out, job, {'expert2': result, 'llama': llama})
    finally:
        distributed.leave()


SKEW = 1e-3


def expert4_job(job, out):
    """World 4: mixtral-tiny on MeshConfig.auto(4, expert=2) (fsdp=2 x
    expert=2), as is and with expert rank 1's replicated gradients
    skewed by SKEW; on auto(4, expert=2, seq=2); and guarded there with
    step POISON_STEP poisoned on rank 3 only."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        result = {}
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(job.world,
                                                           expert=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        _, _, result['fsdp_expert'] = expert_run(mesh, rows)
        _, _, result['skewed'] = expert_run(mesh, rows, skew=SKEW)
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(
            job.world, expert=2, seq=2))
        rows = mesh_lib.batch_rows(mesh, BATCH)
        result['summary'] = mesh_lib.mesh_summary(mesh)
        _, _, result['expert_seq'] = expert_run(mesh, rows)

        def poison(i):
            return float('nan') if (i == POISON_STEP and job.rank == 3) \
                else 1.0

        _, _, result['guard'] = expert_run(mesh, rows, poison=poison)
        _save(out, job, result)
    finally:
        distributed.leave()


# -- test_torch_tensor_train.py ---------------------------------------------
def tensor_run(mesh, name, rows, restore=None, fault=None, poison=None,
               **kw):
    """`name` over `mesh` (or `devices=` in kw): the curve, the whole
    params and moments after STEPS steps (or, with `restore`, the whole
    state restored from that directory, no step), the layout's
    reductions."""
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    from skypilot_tpu_torch.parallel.tensor import tensor_fault
    fields = kw.pop('fields', {})
    trainer = make_trainer(build(name, **fields), mesh,
                           collect_grad_norm=True, guard=poison is not None,
                           **kw)
    state = trainer.init()
    if restore is not None:
        state = CheckpointManager(restore).restore(state)
        return trainer, state, {'params': whole_params(state),
                                'mu': whole_moments(state),
                                'step': state.step}
    with tensor_fault(fault):
        state, losses, norms, bads = run_steps(trainer, state, rows, poison)
    return trainer, state, {
        'losses': losses, 'norms': norms, 'bads': bads,
        'params': whole_params(state), 'mu': whole_moments(state),
        'reductions': dict(getattr(trainer.layout, 'reductions', {}))}


def tensor_job(job, out, specs, saves):
    """Tensor-parallel runs on this job's ranks, one a
    (`key`, model, MeshConfig fields, trainer kwargs) of `specs`
    (kwargs may name a `fault`, a `restore` directory, a `poison`
    rank and `fields` of the model's config); `saves` {key: directory}
    saves that run's state there."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        result = {}
        for key, name, fields, kw in specs:
            kw = dict(kw)
            mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**fields))
            rows = mesh_lib.batch_rows(mesh, BATCH)
            poison_rank = kw.pop('poison', None)
            poison = None
            if poison_rank is not None:
                def poison(i, rank=poison_rank):
                    return float('nan') if (i == POISON_STEP and
                                            job.rank == rank) else 1.0
            _, state, result[key] = tensor_run(mesh, name, rows,
                                               poison=poison, **kw)
            result[key]['summary'] = mesh_lib.mesh_summary(mesh)
            if key in saves:
                CheckpointManager(saves[key]).save(state.step, state,
                                                   force=True)
        _save(out, job, result)
    finally:
        distributed.leave()


# -- test_torch_parallel_cards.py (NCCL over distinct cards) -----------------
def card_spec(model, layers, seq, steps, expert=1, seq_parallel=1, batch=1):
    return {'model': model, 'layers': layers, 'seq': seq, 'steps': steps,
            'expert': expert, 'seq_parallel': seq_parallel, 'batch': batch}


def card_model(spec, device):
    """The seeded bf16 training model of `spec` (full width, its depth
    cut to spec['layers'], --remat) on `device`."""
    from skypilot_tpu_torch.models import convert, registry
    cfg = dataclasses.replace(
        registry.train_config(spec['model'], spec['seq'], True),
        num_layers=spec['layers'])
    return convert.init_params(cfg, seed=0, device=device)


def card_device(job):
    """The job's card ('cpu' for a gloo job: a rehearsal on the CPU)."""
    return f'cuda:{job.local_rank}' if job.backend == 'nccl' else 'cpu'


def peak_gb(device, reset=False):
    if device == 'cpu':
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device) / 1e9


def card_trainer(model, mesh=None):
    """train_lm's trainer for `model` (its optimizer, the default lr)."""
    from skypilot_tpu_torch.parallel import train
    return train.ShardedTrainer(
        model, tx=train.default_optimizer(warmup_steps=10, total_steps=20),
        loss_fn=loss_fn_for(model), collect_grad_norm=True, mesh=mesh)


def card_tokens(spec, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (spec['batch'], spec['seq']))
            for _ in range(spec['steps'])]


class _Reductions:
    """Counts torch.distributed.all_reduce calls (the MoE's combine and
    copies, the aux fractions, the layout's seq / expert / data sums)."""

    def __init__(self):
        import torch.distributed as dist
        self.count, self._orig = 0, dist.all_reduce

        def counted(*a, **kw):
            self.count += 1
            return self._orig(*a, **kw)

        dist.all_reduce = counted

    def close(self):
        import torch.distributed as dist
        dist.all_reduce = self._orig


@contextlib.contextmanager
def experts_in_parts(parts):
    """One process's MoE computing its experts in `parts` equal ranges,
    each range as an expert rank of `--expert parts` computes its own
    (`MoEFeedForward.expert_sum`), the ranges' combines summed in f32
    before the cast, as that job's all-reduce sums them."""
    from skypilot_tpu_torch.models.mixtral import MoEFeedForward
    whole = MoEFeedForward.expert_sum

    def in_parts(self, dispatch, combine, x32, lo, hi):
        width = (hi - lo) // parts
        out = None
        for i in range(parts):
            part = whole(self, dispatch, combine, x32, lo + i * width,
                         lo + (i + 1) * width)
            out = part if out is None else out + part
        return out

    MoEFeedForward.expert_sum = in_parts
    try:
        yield
    finally:
        MoEFeedForward.expert_sum = whole


def card_one_job(job, out, spec, repeats, witness=()):
    """One card, no job: the trainer's step-1 loss and grad norm, both
    again `repeats` times on the same weights and batch (their spread
    bounds the sharded runs'), the step-1 loss and norm with the experts
    computed in each count of `witness` parts (experts_in_parts), the
    step time and peak memory."""
    import time
    from skypilot_tpu_torch.parallel import train
    from skypilot_tpu_torch.observability.step_metrics import matmul_params
    device = card_device(job)
    if device != 'cpu':
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    peak_gb(device, reset=True)
    model = card_model(spec, device)
    n_matmul = matmul_params(model.named_parameters())
    trainer = card_trainer(model)
    state = trainer.init()
    tokens = [torch.from_numpy(t).to(device)
              for t in card_tokens(spec, model.config.vocab_size)]

    def loss_and_norm():
        loss = trainer._compute_loss(state.params, tokens[0])
        grads = torch.autograd.grad(loss, train.trainable_leaves(
            state.params))
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        return loss.item(), norm.item()

    first = [loss_and_norm() for _ in range(repeats)]
    parts = {}
    for n in witness:
        with experts_in_parts(n):
            parts[n] = loss_and_norm()
    step = trainer.make_train_step()
    losses, norms, times = [], [], []
    for t in tokens:
        t0 = time.perf_counter()
        state, (loss, gnorm) = step(state, t)
        losses.append(loss.item())
        norms.append(gnorm.item())
        times.append(time.perf_counter() - t0)
    _save(out, job, {
        'step1': first, 'witness': parts, 'losses': losses, 'norms': norms,
        'times': times,
        'matmul_params': n_matmul, 'peak_gb': peak_gb(device)})


@contextlib.contextmanager
def patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def card_faults(spec):
    """{name: a context in which the job's path is broken on purpose}:
    the controls its step-1 check must reject. Experts: the combine not
    summed over the expert group, and the gradient of x and the routing
    weights not summed over it; seq: the ring keeping its own block
    after its first step."""
    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.ops import ring_attention as ra
    faults = {}
    if spec['expert'] > 1:
        faults['combine_not_summed'] = lambda: patched(
            mixtral, 'reduce_from_experts', lambda x, group: x)
        faults['grads_not_summed'] = lambda: patched(
            mixtral, 'copy_to_experts', lambda x, group: x)
    if spec['seq_parallel'] > 1:
        ring = ra.ring_attention
        faults['rotation_skipped'] = lambda: patched(
            ra, 'ring_attention', functools.partial(ring, skip_rotation=0))
    return faults


def step1_reading(trainer, state, tokens):
    """The job-wide loss and grad norm of a step on `state`, without its
    update (the sharded step up to the optimizer)."""
    from skypilot_tpu_torch.parallel import context
    from skypilot_tpu_torch.parallel.train import trainable_leaves
    layout = trainer.layout
    with context.context_parallel(trainer.mesh):
        leaves = trainable_leaves(state.params)
        loss = trainer._compute_loss(state.params, tokens)
        loss.backward()
        norm = torch.sqrt(layout.global_sq(layout.reduce_grads(leaves)))
        loss = layout.mean(loss)
    return loss.item(), norm.item()


def card_train_job(job, out, spec):
    """One rank of a NCCL job on MeshConfig.auto(world, expert, seq):
    first the step-1 loss and norm of each of `card_faults` (no update),
    then spec['steps'] steps of the sharded trainer; the curve, step
    times, peak memory, the flash launches and plain calls, the ring
    steps and the ring's device ms a step, the all-reduces a step, and a
    digest of the leaves every expert rank holds."""
    import time
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.ops import ring_attention as ra
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.train import trainable_items
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.join(job)
    try:
        device = card_device(job)
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(
            job.world, expert=spec['expert'], seq=spec['seq_parallel']))
        rows = mesh_lib.batch_rows(mesh, spec['batch'])
        peak_gb(device, reset=True)
        model = card_model(spec, device)
        trainer = card_trainer(model, mesh)
        state = trainer.init()
        tokens = [torch.from_numpy(t[rows]).to(device)
                  for t in card_tokens(spec, model.config.vocab_size)]
        controls = {}
        for name, fault in card_faults(spec).items():
            with fault():
                controls[name] = step1_reading(trainer, state, tokens[0])
        trainer.layout.reductions.clear()
        step = trainer.make_train_step()
        fk.fwd_launches = fk.bwd_launches = fk.plain_calls = 0
        ra.fwd_steps = ra.bwd_steps = 0
        reductions = _Reductions()
        losses, norms, times, ring_ms = [], [], [], []
        try:
            for t in tokens:
                t0 = time.perf_counter()
                with ra.timing() as events:
                    state, (loss, gnorm) = step(state, t)
                    losses.append(loss.item())
                times.append(time.perf_counter() - t0)
                norms.append(gnorm.item())
                if events:
                    torch.cuda.synchronize(device)
                ring_ms.append(sum(a.elapsed_time(b) for a, b in events))
        finally:
            reductions.close()
        layout = trainer.layout
        digest = {leaf.name: float(layout.local(t).double().sum())
                  for leaf, (_, t) in zip(layout.leaves,
                                          trainable_items(state.params))
                  if leaf.experts == 1}
        _save(out, job, {
            'summary': mesh_lib.mesh_summary(mesh),
            'coordinate': list(mesh.get_coordinate()),
            'controls': controls,
            'losses': losses, 'norms': norms, 'times': times,
            'ring_ms': ring_ms, 'peak_gb': peak_gb(device),
            'flash': (fk.fwd_launches, fk.bwd_launches, fk.plain_calls),
            'ring_steps': (ra.fwd_steps, ra.bwd_steps),
            'all_reduces': reductions.count,
            'layout_reductions': dict(layout.reductions),
            'replicated_digest': digest})
    finally:
        distributed.leave()


# -- test_torch_parallel_cards.py: tensor, and experts within stages ----------
def card_tensor_job(job, out, spec, fields, repeats, parts=1):
    """Tensor parallelism (and experts within pipeline stages) at
    `spec`'s shape. Over a NCCL job of `world` ranks on
    MeshConfig(**fields) (the sharded trainer, or with a `stage` axis the
    1f1b pipeline, a microbatch a row): the step-1 reading once and under
    each control (chip_smoke's TENSOR_FAULTS; experts within stages,
    card_faults'), then spec['steps'] steps. On one process (world 1):
    the same mesh in process on the card (ShardedTrainer(devices=) over
    `tensor` shards, the pipeline over a [stage][tensor] grid, experts
    summed in `expert` parts, experts_in_parts), the step-1 reading
    1 + `repeats` times, its rows in `parts` blocks (the job's fsdp
    ranks' rows: the blocks' losses averaged, their f32 grads too).
    The curve, step times, peak GB, flash launches (and the shard heads
    they ran at), the shards' sums and all-reduces a step."""
    import time
    from chip_smoke import (TENSOR_FAULTS, TENSOR_STAGE_FAULTS,
                            flash_shapes, pipe_reading)
    from skypilot_tpu_torch.parallel.tensor import tensor_fault
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.observability.step_metrics import matmul_params
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.parallel import distributed, train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.pipeline import PipelinedLM
    torch.backends.cuda.matmul.allow_tf32 = False
    device = card_device(job)
    if job.world > 1:
        distributed.join(job)
    elif device != 'cpu':
        torch.cuda.set_device(device)
    try:
        tensor, stage = fields.get('tensor', 1), fields.get('stage', 1)
        expert = fields.get('expert', 1)
        peak_gb(device, reset=True)
        cfg = dataclasses.replace(
            registry.train_config(spec['model'], spec['seq']),
            num_layers=spec['layers'])
        model = convert.init_params(cfg, seed=0, device=device)
        n_matmul = matmul_params(model.named_parameters())
        tx = train.default_optimizer(warmup_steps=10, total_steps=20)
        mesh = (mesh_lib.make_mesh(mesh_lib.MeshConfig(**fields))
                if job.world > 1 else None)
        tokens = [torch.from_numpy(t).to(device)
                  for t in card_tokens(spec, cfg.vocab_size)]
        in_parts = contextlib.nullcontext()
        if stage > 1:
            row = [device] * tensor
            where = ({'mesh': mesh} if mesh is not None else
                     {'devices': [row if tensor > 1 else device] * stage})
            runner = PipelinedLM(model, num_microbatches=spec['batch'],
                                 schedule='1f1b', **where)
            state = runner.init(tx)
            group = runner.group.tensor_of(runner.group.local[0])

            def reading():
                return pipe_reading(runner, tokens[0])

            if mesh is None and expert > 1:
                in_parts = experts_in_parts(expert)
            step = runner.make_train_step(tx, collect_grad_norm=True)
        else:
            where = ({'mesh': mesh} if mesh is not None else
                     {'devices': [device] * tensor})
            runner = train.ShardedTrainer(model, tx=tx,
                                          loss_fn=loss_fn_for(model),
                                          collect_grad_norm=True, **where)
            state = runner.init()
            group = runner.tensor[0]
            rows = (mesh_lib.batch_rows(mesh, spec['batch'])
                    if mesh is not None else slice(None))
            tokens = [t[rows] for t in tokens]

            def reading():
                if mesh is not None:
                    return step1_reading(runner, state, tokens[0])
                leaves = train.trainable_leaves(state.params)
                losses, sums = [], None
                for block in tokens[0].chunk(parts):
                    loss = runner._compute_loss(state.params, block)
                    grads = torch.autograd.grad(loss, leaves)
                    losses.append(loss.detach())
                    sums = ([g.float() for g in grads] if sums is None else
                            [a.add_(g.float()) for a, g in zip(sums, grads)])
                sq = runner.layout.global_sq([a / parts for a in sums])
                return ((sum(losses) / parts).item(),
                        torch.sqrt(sq).item())

            step = runner.make_train_step()
        with in_parts:
            step1 = [reading() for _ in range(
                1 + (repeats if job.world == 1 else 0))]
        controls = {}
        if job.world > 1:
            names = TENSOR_STAGE_FAULTS if stage > 1 else TENSOR_FAULTS
            faults = ({n: functools.partial(tensor_fault, n)
                       for n in names} if tensor > 1 else
                      card_faults({'expert': expert, 'seq_parallel': 1}))
            for name, fault in faults.items():
                with fault():
                    controls[name] = reading()
        sums0 = (group.reductions, group.copies) if group else (0, 0)
        fk.fwd_launches = fk.bwd_launches = fk.plain_calls = 0
        reductions = _Reductions()
        losses, norms, times = [], [], []
        try:
            with flash_shapes(fk) as heads:
                for t in tokens:
                    if device != 'cpu':
                        torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    state, (loss, gnorm) = step(state, t)
                    losses.append(loss.item())
                    norms.append(gnorm.item())
                    times.append(time.perf_counter() - t0)
        finally:
            reductions.close()
        steps = len(tokens)
        _save(out, job, {
            'summary': (mesh_lib.mesh_summary(mesh) if mesh is not None
                        else None),
            'step1': step1, 'controls': controls, 'losses': losses,
            'norms': norms, 'times': times, 'peak_gb': peak_gb(device),
            'flash': (fk.fwd_launches, fk.bwd_launches, fk.plain_calls),
            'flash_heads': sorted(heads),
            'shard_sums_a_step': (
                ((group.reductions - sums0[0]) / steps,
                 (group.copies - sums0[1]) / steps) if group else None),
            'all_reduces_a_step': reductions.count / steps,
            'matmul_params': n_matmul})
    finally:
        if job.world > 1:
            distributed.leave()


# -- test_torch_pipeline_gang.py ----------------------------------------------
def pipe_job(job, out, spec, ckpt_dir):
    """One rank of a gloo pipeline job on MeshConfig(data, stage=world /
    data) (`spec`: model, config fields, schedule, virtual stages,
    microbatches, data, seq, batch, lr, tokens): this rank's stage's
    grads, the loss, one AdamW step's loss, norm and parameters, the
    hand-offs and collectives the step made; the state is then saved to
    `ckpt_dir` (every rank calls the save)."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import train
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    from skypilot_tpu_torch.parallel.pipeline import PipelinedLM
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
            data=spec['data'], stage=job.world // spec['data']))
        cfg = dataclasses.replace(f32_config(spec['model']),
                                  **spec['fields'])
        from skypilot_tpu_torch.models import convert
        model = convert.init_params(cfg, seed=0, device='cpu')
        pp = PipelinedLM(model, mesh, num_microbatches=spec['M'],
                         schedule=spec['style'],
                         virtual_stages=spec['v'])
        tx = train.default_optimizer(learning_rate=spec['lr'])
        state = pp.init(tx)
        tokens = torch.from_numpy(spec['tokens'])
        stage = pp.group.local[0]
        loss, grads = pp.loss_and_grad(tokens)
        counts = (pp.group.handoffs, pp.group.collectives)
        state, (loss1, gnorm) = pp.make_train_step(
            tx, collect_grad_norm=True)(state, tokens)
        CheckpointManager(ckpt_dir).save(1, state, force=True)
        _save(out, job, {
            'stage': stage, 'data': pp.group.data_index,
            'loss': loss.item(), 'loss1': loss1.item(),
            'gnorm': gnorm.item(),
            'grads': {n: g.clone() for n, g in grads[stage].items()},
            'params': {n: p.detach().clone()
                       for n, p in state.params[stage].items()},
            'handoffs': counts[0], 'collectives': counts[1]})
    finally:
        distributed.leave()


def pipe_grid_run(pp, tx, state, steps):
    """`steps` AdamW steps of a pipeline on the shared token stream:
    the losses, grad norms and the whole parameters after them
    (gathered on rank 0, None elsewhere)."""
    from skypilot_tpu_torch.parallel import train  # noqa: F401
    step = pp.make_train_step(tx, collect_grad_norm=True)
    losses, norms = [], []
    for i in range(steps):
        tokens = torch.from_numpy(tokens_for(i, pp.cfg.vocab_size))
        state, (loss, gnorm) = step(state, tokens)
        losses.append(float(loss))
        norms.append(float(gnorm))
    params = {n: pp.gather_leaf(state, i, 'param')
              for i, n in enumerate(pp.names)}
    return state, losses, norms, params


def pipe_grid_job(job, out, specs, ckpt_dir):
    """Pipelines with tensor and expert ranks within each stage, one a
    (`key`, model, MeshConfig fields, schedule, virtual stages)
    of `specs`: PIPE_STEPS steps of PIPE_MB rows of microbatches a
    data rank's batch (PIPE_MB / data microbatches), the losses,
    norms and whole parameters, the hand-offs; the first spec's state
    is saved to `ckpt_dir`."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import train
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    from skypilot_tpu_torch.parallel.pipeline import PipelinedLM
    torch.set_num_threads(1)
    distributed.join(job)
    try:
        result = {}
        for n, (key, name, fields, style, v) in enumerate(specs):
            mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**fields))
            pp = PipelinedLM(build(name), mesh,
                             num_microbatches=PIPE_MB // fields.get('data', 1),
                             schedule=style, virtual_stages=v)
            tx = train.default_optimizer(learning_rate=LR, warmup_steps=10,
                                         total_steps=20)
            state = pp.init(tx)
            state, losses, norms, params = pipe_grid_run(pp, tx, state,
                                                         PIPE_STEPS)
            if n == 0 and ckpt_dir:
                CheckpointManager(ckpt_dir).save(state.step, state,
                                                 force=True)
            result[key] = {'losses': losses, 'norms': norms,
                           'params': params,
                           'summary': mesh_lib.mesh_summary(mesh),
                           'local': {k: tuple(p.shape) for k, p in
                                     state.params[pp.group.local[0]]
                                     .items()}}
        _save(out, job, result)
    finally:
        distributed.leave()


PIPE_MB, PIPE_STEPS = 4, 3


# -- test_torch_parallel_cards.py: pipelines ---------------------------------
def card_pipe_job(job, out, spec, repeats):
    """The pipeline at `spec`'s shape, 1f1b, microbatches of one row: on
    one process (world 1) in process on [cuda:0, cuda:0], the step-1
    reading 1 + `repeats` times; over a NCCL job of `world` ranks on
    MeshConfig(data=world / 2, stage=2), the reading once and under each
    of chip_smoke's PIPE_FAULTS. Then spec['steps'] steps: the curve,
    step times, peak memory, flash launches and plain calls, hand-offs
    and collectives a step."""
    import time
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.parallel import distributed, train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.pipeline import PipelinedLM
    from chip_smoke import PIPE_FAULTS, pipe_fault
    torch.backends.cuda.matmul.allow_tf32 = False
    device = card_device(job)
    if job.world > 1:
        distributed.join(job)
    elif device != 'cpu':
        torch.cuda.set_device(device)
    try:
        data = max(1, job.world // 2)
        peak_gb(device, reset=True)
        cfg = dataclasses.replace(
            registry.train_config(spec['model'], spec['seq']),
            num_layers=spec['layers'])
        model = convert.init_params(cfg, seed=0, device=device)
        micro = spec['batch'] // data
        where = ({'devices': [device, device]} if job.world == 1 else
                 {'mesh': mesh_lib.make_mesh(mesh_lib.MeshConfig(
                     data=data, stage=2))})
        pp = PipelinedLM(model, num_microbatches=micro, schedule='1f1b',
                         **where)
        tx = train.default_optimizer(warmup_steps=10, total_steps=20)
        state = pp.init(tx)
        tokens = [torch.from_numpy(t).to(device)
                  for t in card_tokens(spec, cfg.vocab_size)]

        def reading():
            loss, grads = pp.loss_and_grad(tokens[0])
            norm = torch.sqrt(pp.global_sq(grads)[pp.stages[0].index])
            return loss.item(), norm.item()

        step1 = [reading() for _ in range(1 + (repeats if job.world == 1
                                               else 0))]
        controls = {}
        if job.world > 1:
            for name in PIPE_FAULTS:
                with pipe_fault(pp, name):
                    controls[name] = reading()
        step = pp.make_train_step(tx, collect_grad_norm=True)
        group = pp.group
        h0, c0 = group.handoffs, group.collectives
        fk.fwd_launches = fk.bwd_launches = fk.plain_calls = 0
        losses, norms, times = [], [], []
        for t in tokens:
            if device != 'cpu':
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, (loss, gnorm) = step(state, t)
            losses.append(loss.item())
            norms.append(gnorm.item())
            times.append(time.perf_counter() - t0)
        from skypilot_tpu_torch.observability.step_metrics import \
            matmul_params
        _save(out, job, {
            'stage': group.local[0] if job.world > 1 else None,
            'data': group.data_index, 'step1': step1,
            'controls': controls, 'losses': losses, 'norms': norms,
            'times': times, 'peak_gb': peak_gb(device),
            'flash': (fk.fwd_launches, fk.bwd_launches, fk.plain_calls),
            'handoffs_a_step': (group.handoffs - h0) / len(tokens),
            'collectives_a_step': (group.collectives - c0) / len(tokens),
            'ticks': pp.schedule.num_ticks,
            'bubble_fraction': pp.schedule.bubble_fraction,
            'matmul_params': matmul_params(
                (n, torch.empty(s, device='meta'))
                for n, s in pp.shapes.items())})
    finally:
        if job.world > 1:
            distributed.leave()
