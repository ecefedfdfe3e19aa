"""LM-training recipe on PyTorch/CUDA (port of
skypilot_tpu/recipes/train_lm.py), the payload that Managed Jobs
launches and recovers: on relaunch it resumes from the newest verified
step in --ckpt-dir.

Takes the reference's flags and prints its log lines (`devices=N
Mesh(...)`, `step i/N loss=... tokens/s=...`, `resumed from checkpoint
step N`, `adapter artifact -> ...`, `training done`, and the guard's).

One job over processes and cards, as the reference joins one: under the
gang-exec env (`JAX_NUM_PROCESSES` > 1, `JAX_PROCESS_ID`,
`JAX_COORDINATOR_ADDRESS`; parallel/distributed.py) and on a host with
more than one card, every card runs a worker, rank p * k + i of
`JAX_NUM_PROCESSES` x k (k cards a host, 1 with --cpu), NCCL on the
card and gloo with --cpu. The mesh is `MeshConfig.auto(world,
tensor=--tensor, expert=--expert, seq=--seq-parallel)`: FSDP over every
rank not on another axis (parallel/mesh.py), with `--zero1` and
`--overlap` as the reference defines them (parallel/fsdp.py).
`--tensor T` splits heads, the MLP's hidden axis and the vocab over T
ranks (parallel/tensor.py), `--expert E` Mixtral's expert stacks over E
ranks and `--seq-parallel K` the sequence over K ranks, attention a ring
(ops/ring_attention.py); all three repeat the batch, whose rows split
over data x fsdp as the reference's devices take theirs. A world that
those do not divide exits with the reference's words. Rank 0 alone
logs, writes `--metrics-file`, `--profile`, `--trace-file` and the
adapter artifact, and writes checkpoints (every rank gathers them). A
peer that never arrives ends the run with exit 1 naming the coordinator
(after `distributed.TIMEOUT_S`, 300 s).

`--pipeline-stages S` (with `--pipeline-schedule gpipe|1f1b|interleaved`,
`--virtual-stages`, `--microbatches`; parallel/pipeline.py) lays the
ranks on MeshConfig(data=world / (S * T * E), stage=S, tensor=T,
expert=E): one stage a rank, each stage's blocks sharded over its
`tensor` and `expert` ranks, the reference's checks and log lines (the
batch rounded to a multiple of microbatches x data, the schedule's
`describe()`, the bubble fraction in the step records and the
`skypilot_train_pipeline_bubble_fraction` gauge). Every rank draws the
global batch and the pipeline takes its data rank's rows of each
microbatch. GPT, Llama and Mixtral, as the reference's recipe allows;
`--lora` and `--seq-parallel` are refused with it, in the reference's
words. The same loop, --guard and checkpoints run over it.

The Llama family, GPT-2 (`tiny`, `gpt2-124m`, the reference's default),
Mixtral (`mixtral-tiny`, `mixtral-8x7b`, whose loss adds the router aux
loss) and DeepSeek (`deepseek-tiny`, `deepseek-v2-lite`: MLA, whose
attention takes the unequal-dims route, never the flash kernels) train;
`--lora` takes the Llama family only, as in the reference.
Weights are a seeded init on the device, or a local HF checkpoint
(--init-from-hf). Runs on the GPU unless --cpu is given.

The managed-jobs recovery contract is the reference's (--guard,
robustness/train_guard.py): a preemption notice (SIGTERM, the GCE
metadata endpoint, or an injected `train.preempt_notice`) checkpoints at
the next step boundary and exits 83; a hung step or loader dumps every
thread's stack and exits 84; a NaN or spike step is skipped on the
device, and after --rollback-after of them in a row the run rolls back
to the newest verified checkpoint. STPU_FAULT_PLAN injects each
(robustness/faults.py). --ckpt-interval SECONDS|auto turns a wall-time
cadence (auto: the Young/Daly optimum, jobs/policy.py) into steps after
the first logged window.

  python -m skypilot_tpu_torch.recipes.train_lm --model llama3-8b \\
      --seq 2048 --steps 100 --lora 16 --remat --ckpt-dir ckpts/ --guard
  STPU_FAULT_PLAN=examples/fault_plans/train_guard_chaos.json \\
      python -m skypilot_tpu_torch.recipes.train_lm --cpu \\
      --model llama-tiny --steps 20 --seq 64 --guard --guard-warmup 1 \\
      --ckpt-dir /tmp/ck --ckpt-every 4 --log-every 1
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import List, Optional

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.recipes.train_lm')
    p.add_argument('--model', default='gpt2-124m',
                   help='gpt2-124m, tiny, llama3-8b, llama-tiny, qwen2-7b, '
                        'qwen-tiny, mixtral-8x7b, mixtral-tiny, '
                        'deepseek-v2-lite or deepseek-tiny (ignored with '
                        '--init-from-hf)')
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--seq', type=int, default=1024)
    p.add_argument('--global-batch', type=int, default=0,
                   help='0 = 8 per device')
    p.add_argument('--data', default='synthetic',
                   help='"synthetic" or a dir/glob of token .bin shards '
                        '(read by the native reader, native/'
                        'token_loader.cpp, where it builds)')
    p.add_argument('--ckpt-dir', default=None)
    p.add_argument('--init-from-hf', default=None, metavar='DIR',
                   help='initialize from a local HF checkpoint dir (llama, '
                        'mistral, qwen2, gpt2, mixtral) as f32 masters with '
                        'fresh moments; --model is ignored; with --lora '
                        'only the frozen base comes from it')
    p.add_argument('--ckpt-every', type=int, default=50)
    p.add_argument('--ckpt-interval', default=None, metavar='auto|SECONDS',
                   help='checkpoint cadence as wall time: seconds, or '
                        '"auto" for the Young/Daly optimum from '
                        '--preemption-rate and --ckpt-overhead; fixed in '
                        'steps from the first logged window')
    p.add_argument('--preemption-rate', type=float, default=None,
                   metavar='PER_HOUR',
                   help='zone spot preemption rate for --ckpt-interval '
                        'auto (default: SKYPILOT_PREEMPTION_RATE_PER_HOUR)')
    p.add_argument('--ckpt-overhead', type=float, default=None,
                   metavar='SECONDS',
                   help='checkpoint write overhead for --ckpt-interval '
                        'auto (default 60 s)')
    p.add_argument('--guard', action='store_true',
                   help='preemption notice -> checkpoint and exit 83; '
                        'NaN/spike steps skipped on the device, rollback '
                        'after --rollback-after in a row; a step watchdog '
                        'exits 84 on a hang')
    p.add_argument('--spike-factor', type=float, default=10.0,
                   help='grad-norm spike threshold as a multiple of its '
                        'EMA (guard)')
    p.add_argument('--guard-warmup', type=int, default=10,
                   help='good steps of EMA warmup before spike detection '
                        'arms (guard)')
    p.add_argument('--rollback-after', type=int, default=3,
                   help='consecutive bad steps before rolling back to the '
                        'last checkpoint (guard)')
    p.add_argument('--watchdog-deadline', type=float, default=300.0,
                   metavar='SECONDS',
                   help='per-phase step-watchdog deadline; 0 disables it '
                        '(guard)')
    p.add_argument('--watchdog-compile-deadline', type=float,
                   default=1800.0, metavar='SECONDS',
                   help='watchdog deadline for the first step (kernel '
                        'builds and warm-up)')
    p.add_argument('--preempt-poll', type=float, default=5.0,
                   metavar='SECONDS',
                   help='preemption-notice metadata poll interval (guard)')
    p.add_argument('--lora', type=int, default=0, metavar='RANK',
                   help='LoRA finetune: freeze the base and train rank-RANK '
                        'A/B factors; the trained factors are saved as a '
                        'serving adapter artifact (--adapter-out) that '
                        'serve_lm --adapter-dir loads')
    p.add_argument('--lora-alpha', type=float, default=0.0,
                   help='LoRA alpha (delta scale = alpha/rank); 0 = rank')
    p.add_argument('--lora-targets', default='attn',
                   choices=['attn', 'mlp', 'attn-mlp'])
    p.add_argument('--adapter-out', default=None, metavar='DIR',
                   help='where --lora writes the adapter artifact; '
                        'default <--ckpt-dir>/adapter, or ./adapter_out')
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--no-fused-xent', action='store_true',
                   help='materialize the [B,S,V] logits instead of the '
                        'fused blockwise LM-head cross-entropy')
    p.add_argument('--remat', action='store_true',
                   help='recompute each block in the backward')
    p.add_argument('--log-every', type=int, default=10)
    p.add_argument('--metrics-file', default=None, metavar='PATH',
                   help='append one JSONL record per --log-every window')
    p.add_argument('--trace-file', default=None, metavar='PATH',
                   help='write a Chrome-trace timeline of the run\'s '
                        'phases (init, data, step, checkpoint)')
    p.add_argument('--profile', default=None, metavar='DIR',
                   help='torch.profiler trace (CPU and CUDA activity) of '
                        'the --profile-steps window, as a Chrome trace in '
                        'DIR')
    p.add_argument('--profile-steps', default='4:8', metavar='START:STOP',
                   help='step window to trace (default 4:8)')
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (default: the GPU)')
    p.add_argument('--zero1', action='store_true',
                   help='ZeRO-1: shard the Adam moments over the data mesh '
                        'axis too (the same step math)')
    p.add_argument('--overlap', action='store_true',
                   help='with --zero1, issue the grad reduce-scatter leaf by '
                        'leaf during backward')
    p.add_argument('--expert', type=int, default=1)
    p.add_argument('--seq-parallel', type=int, default=1,
                   help='context-parallel mesh axis size '
                        '(ring attention)')
    p.add_argument('--tensor', type=int, default=1,
                   help='tensor-parallel mesh axis size: heads, the MLP '
                        'hidden axis and the vocab split over it '
                        '(parallel/tensor.py); within each stage under '
                        '--pipeline-stages')
    p.add_argument('--pipeline-stages', type=int, default=1,
                   help='pipeline parallelism over a stage mesh axis '
                        '(parallel/pipeline.py; GPT/Llama/Mixtral): one '
                        'stage a rank, the rest of the ranks data '
                        'parallel; uneven num_layers pads with identity '
                        'slots')
    p.add_argument('--pipeline-schedule', default='gpipe',
                   choices=['gpipe', '1f1b', 'interleaved'],
                   help='pipeline schedule (parallel/pipeline_schedule.py):'
                        ' gpipe = all forwards then all backwards '
                        '(activation memory O(microbatches)); 1f1b = '
                        'one-forward-one-backward, live activations '
                        'O(stages); interleaved = 1f1b over '
                        '--virtual-stages layer chunks a device, the '
                        'bubble fraction divided by v')
    p.add_argument('--virtual-stages', type=int, default=0,
                   help='layer chunks a device for --pipeline-schedule '
                        'interleaved (0 = auto: 2 for interleaved, 1 '
                        'otherwise)')
    p.add_argument('--microbatches', type=int, default=0,
                   help='pipeline microbatches (0 = 4 x stages)')
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: exits (status 2) naming every flag, model
    and checkpoint location this port cannot honor."""
    parser = build_parser()
    args = parser.parse_args(argv)
    # The reference's pipeline checks, in its order and words.
    staged = args.pipeline_stages > 1
    if args.microbatches and not staged:
        parser.error('--microbatches only applies with --pipeline-stages '
                     '> 1')
    if args.overlap and not args.zero1 and not staged:
        parser.error('--overlap buckets the grad reduce-scatter onto the '
                     'ZeRO-1 moment layout; add --zero1 (under '
                     '--pipeline-stages it only sets the XLA '
                     'latency-hiding flags)')
    if args.virtual_stages and args.pipeline_schedule != 'interleaved':
        parser.error('--virtual-stages only applies with '
                     '--pipeline-schedule interleaved')
    if args.pipeline_schedule != 'gpipe' and not staged:
        parser.error('--pipeline-schedule needs --pipeline-stages > 1')
    if args.lora and staged:
        parser.error('--lora needs the sharded trainer (the GPipe path '
                     'splits params per stage); drop one')
    if staged and args.seq_parallel != 1:
        parser.error('--pipeline-stages does not compose with '
                     '--seq-parallel; drop one')
    if args.ckpt_dir and args.ckpt_dir.startswith(('gs://', 's3://')):
        parser.error(f'--ckpt-dir {args.ckpt_dir}: remote checkpoint dirs '
                     f'are not ported yet (ROADMAP A11)')
    if args.ckpt_interval is not None:
        if not args.ckpt_dir:
            parser.error('--ckpt-interval needs --ckpt-dir')
        if args.ckpt_interval != 'auto':
            try:
                if float(args.ckpt_interval) <= 0:
                    raise ValueError
            except ValueError:
                parser.error('--ckpt-interval takes "auto" or a positive '
                             'number of seconds')
        elif args.preemption_rate is None and not os.environ.get(
                'SKYPILOT_PREEMPTION_RATE_PER_HOUR'):
            parser.error('--ckpt-interval auto needs the zone preemption '
                         'rate: pass --preemption-rate or set '
                         'SKYPILOT_PREEMPTION_RATE_PER_HOUR')
    try:
        args.profile_window = tuple(int(x) for x in
                                    args.profile_steps.split(':'))
        if len(args.profile_window) != 2:
            raise ValueError
    except ValueError:
        parser.error(f'--profile-steps {args.profile_steps!r}: want '
                     f'START:STOP')
    if not args.init_from_hf:
        from skypilot_tpu_torch.models import convert, registry
        try:
            cfg = registry.train_config(args.model, args.seq)
        except ValueError as e:
            parser.error(f'--model: {e}')
        name = convert.model_class(cfg).__name__
        if args.lora and name != 'Llama':
            # The reference trainer's refusal (models take no `lora`).
            parser.error(f'--lora: {name} has no LoRA forward path; --lora '
                         f'supports the Llama family (models/lora.py)')
    return args


def main(argv: Optional[List[str]] = None,
         workers: Optional[int] = None) -> None:
    """Parse, then train: in this process when the job is one rank, else
    as this host's `workers` ranks (default: 1 with --cpu, else one a
    visible card), spawned here unless there is one."""
    args = parse_args(argv)
    from skypilot_tpu_torch.parallel import distributed
    if workers is None:
        workers = 1 if args.cpu else _local_cards()
    num_processes = distributed.gang()[0]
    if num_processes * workers <= 1:
        _train(args, None)
        return
    jobs = distributed.jobs(args.cpu, workers)
    if workers == 1:
        _run_worker(jobs[0], args)
        return
    code = distributed.launch(_run_worker, (args,), jobs)
    if code:
        sys.exit(code)


def _local_cards() -> int:
    import torch
    return max(1, torch.cuda.device_count()) \
        if torch.cuda.is_available() else 1


def _run_worker(job, args: argparse.Namespace) -> None:
    """One rank: join the job (exit 1 naming the coordinator when it does
    not form in time), train, leave."""
    from skypilot_tpu_torch.parallel import distributed
    try:
        distributed.join(job)
    except distributed.JoinError as e:
        print(f'train_lm: {e}', file=sys.stderr, flush=True)
        sys.exit(1)
    exiting = False
    try:
        _train(args, job)
    except SystemExit:
        exiting = True
        raise
    finally:
        try:
            distributed.leave()
        except Exception:  # pylint: disable=broad-except
            # The run's own exit code stands when leaving fails because
            # a peer that exited first (rank 0 holds the job's store) is
            # gone.
            if not exiting:
                raise


def _train(args: argparse.Namespace, job) -> None:
    """The training run of one rank (`job` None: the only one)."""
    import numpy as np
    import torch

    from skypilot_tpu_torch.device import NoCudaDeviceError, resolve_device
    from skypilot_tpu_torch.errors import CheckpointNotFoundError
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.train import (HostScalars,
                                                   ShardedTrainer,
                                                   default_optimizer)
    from skypilot_tpu_torch.robustness import faults, train_guard
    from skypilot_tpu_torch.utils import timeline
    try:
        device = resolve_device(
            None if job is None or args.cpu else f'cuda:{job.local_rank}',
            cpu=args.cpu)
    except NoCudaDeviceError as e:
        print(f'train_lm: {e}', file=sys.stderr, flush=True)
        sys.exit(1)
    main_rank = job is None or job.is_main
    if args.trace_file and main_rank:
        timeline.enable(args.trace_file)
    n_dev = 1 if job is None else job.world
    stages = args.pipeline_stages
    try:
        if stages > 1:
            inner = stages * args.tensor * args.expert
            if n_dev % inner:
                raise ValueError(f'{n_dev} devices not divisible by stages '
                                 f'x tensor x expert = {inner}')
            # Tensor and expert shard within each stage (the
            # reference's v2).
            mesh_cfg = mesh_lib.MeshConfig(data=n_dev // inner, stage=stages,
                                           tensor=args.tensor,
                                           expert=args.expert)
        else:
            mesh_cfg = mesh_lib.MeshConfig.auto(n_dev, tensor=args.tensor,
                                                expert=args.expert,
                                                seq=args.seq_parallel)
    except ValueError as e:     # the reference's words
        print(f'train_lm: {e}', file=sys.stderr, flush=True)
        sys.exit(2)
    mesh = None if job is None else mesh_lib.make_mesh(mesh_cfg)
    if main_rank:
        print(f'devices={n_dev} {mesh_lib.mesh_summary(mesh or mesh_cfg)}',
              flush=True)

    def say(msg: str) -> None:
        if main_rank:
            print(msg, flush=True)

    if args.init_from_hf:
        from skypilot_tpu_torch.models import hf_import
        # f32 masters of the checkpoint's tensors; the trainer's fresh
        # moments are right for a finetune start, and with --lora the
        # checkpoint is the frozen base under fresh factors.
        cfg, model = hf_import.load_hf_checkpoint(
            args.init_from_hf, max_seq_len=max(args.seq, 128),
            device=device, param_dtype=torch.float32, remat=args.remat)
        base_source = ('HF checkpoint '
                       + os.path.abspath(os.path.expanduser(
                           args.init_from_hf)))
        say(f'initializing from HF checkpoint {args.init_from_hf} '
            f'({type(model).__name__}, vocab={cfg.vocab_size})')
    else:
        cfg = registry.train_config(args.model, args.seq, args.remat)
        model = convert.init_params(cfg, seed=0, device=device)
        base_source = f'seeded init (seed 0) of {args.model}'
    vocab_size = cfg.vocab_size
    batch = args.global_batch or 8 * n_dev
    rows = slice(None)
    if stages > 1:
        from skypilot_tpu_torch.models.deepseek import Deepseek
        if isinstance(model, Deepseek):
            # The reference's recipe refuses it (its PipelinedLM runs it).
            print('train_lm: --pipeline-stages supports the GPT, Llama, and '
                  'Mixtral families (v1)', file=sys.stderr, flush=True)
            sys.exit(2)
        microbatches = args.microbatches or 4 * stages
        denom = microbatches * mesh_cfg.data
        if batch % denom:
            batch = max(denom, (batch // denom) * denom)
            say(f'pipeline: rounding global batch to {batch} '
                f'({microbatches} microbatches x data={mesh_cfg.data})')
    elif mesh is not None:
        try:
            rows = mesh_lib.batch_rows(mesh, batch)
        except ValueError as e:
            print(f'train_lm: --global-batch: {e}', file=sys.stderr,
                  flush=True)
            sys.exit(2)
    # MFU's N, counted before sharding (then leaves are shards).
    from skypilot_tpu_torch.observability.step_metrics import matmul_params
    n_params = matmul_params(model.named_parameters())
    lora_spec = None
    if args.lora:
        lora_spec = lora_lib.LoraSpec(
            rank=args.lora, alpha=args.lora_alpha or float(args.lora),
            targets=lora_lib.targets_from_name(args.lora_targets))
    tx = default_optimizer(learning_rate=args.lr, warmup_steps=10,
                           total_steps=max(args.steps, 20))
    collect = args.metrics_file is not None    # (loss, grad_norm) a step
    bubble_frac = None
    if stages > 1:
        from skypilot_tpu_torch.parallel.pipeline import PipelinedLM
        if args.no_fused_xent or args.zero1:
            say('pipeline trainer: --no-fused-xent/--zero1 ignored (the '
                'pipeline path computes its head per-stage and keeps '
                'per-stage opt state)')
        if args.overlap:
            say('pipeline trainer: --overlap sets no flags here (the '
                'reference sets XLA latency-hiding flags; the port has none '
                'to set)')
        virtual = args.virtual_stages or (
            2 if args.pipeline_schedule == 'interleaved' else 1)
        try:
            pp = PipelinedLM(model, mesh, num_microbatches=microbatches,
                             schedule=args.pipeline_schedule,
                             virtual_stages=virtual)
        except ValueError as e:
            print(f'train_lm: --pipeline-schedule: {e}', file=sys.stderr,
                  flush=True)
            sys.exit(2)
        say(f'pipeline schedule: {pp.schedule.describe()}')
        with timeline.Event('train/init'):
            state = pp.init(tx)
        del model
        step_fn = pp.make_train_step(tx, guard=args.guard,
                                     collect_grad_norm=collect)
        bubble_frac = pp.schedule.bubble_fraction
        from skypilot_tpu_torch.observability import catalog
        catalog.gauge('skypilot_train_pipeline_bubble_fraction').set(
            bubble_frac)
    else:
        from skypilot_tpu_torch.models.mixtral import (Mixtral,
                                                       moe_next_token_loss)
        trainer = ShardedTrainer(
            model, tx=tx,
            loss_fn=(moe_next_token_loss if isinstance(model, Mixtral)
                     else None),
            fused_xent=False if args.no_fused_xent else None,
            collect_grad_norm=collect, lora=lora_spec,
            guard=args.guard, mesh=mesh, zero1=args.zero1,
            overlap=args.overlap)
        say(f'fused_xent={trainer.fused_xent} zero1={args.zero1} '
            f'overlap={args.overlap} lora={args.lora or "off"}')
        with timeline.Event('train/init'):
            state = trainer.init(seed=7)
        step_fn = trainer.make_train_step()

    # Checkpoint resume (preemption recovery path; collective over a
    # job). Interval mode gates the cadence here (it is fixed once the
    # step cost is measured), so the manager must not filter steps
    # itself.
    mgr = None
    if args.ckpt_dir:
        from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
        mgr = CheckpointManager(
            args.ckpt_dir,
            save_interval_steps=(1 if args.ckpt_interval is not None
                                 else args.ckpt_every),
            base_source=base_source)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(state, latest)
            restored = mgr.last_restored_step
            if restored != latest:
                print(f'checkpoint step {latest} corrupt; resumed from '
                      f'step {restored} instead', flush=True)
            else:
                print(f'resumed from checkpoint step {restored}', flush=True)

    loader = None
    if args.data != 'synthetic':
        from skypilot_tpu_torch.data.token_loader import (
            TokenLoader, native_unavailable_reason)
        paths = sorted(glob.glob(os.path.join(args.data, '*.bin'))
                       if os.path.isdir(args.data) else glob.glob(args.data))
        # The reference's reader: a window of the global batch for each
        # process (host) of the gang; each rank keeps its rows of it.
        loader = TokenLoader(
            paths, batch=batch, seq=args.seq,
            rank=0 if job is None else job.process_id,
            world=1 if job is None else job.num_processes)
        reader = ('native reader (native/token_loader.cpp)' if loader.native
                  else f'numpy reader (native unavailable: '
                       f'{native_unavailable_reason()})')
        say(f'data: {reader}, {len(paths)} shards, '
            f'{loader.total_tokens:,} tokens')

    rng = np.random.default_rng(0)
    start_step = state.step
    # Fire-site context for the train.* fault points: scoped rules can
    # target the first launch ({"resume": "0"}) and spare the resumed run.
    resume_ctx = {'resume': '1' if start_step > 0 else '0'}

    def next_tokens() -> torch.Tensor:
        # Chaos: a delay rule here is a stalled data loader, which the
        # step watchdog must abort past its deadline.
        faults.point('train.data_next', **resume_ctx)
        if loader is not None:
            arr = loader.next_batch()[:, :-1].astype(np.int64)
        else:
            # Every rank draws the same global batch.
            arr = rng.integers(0, vocab_size, (batch, args.seq),
                               dtype=np.int32).astype(np.int64)
        return torch.from_numpy(arr[rows]).to(device)

    prof_start, prof_stop = (args.profile_window
                             if args.profile and main_rank else (-1, -1))
    profiler = None

    def stop_profile() -> None:
        # Synchronize first, so the trace holds whole device timelines
        # for the window, not just dispatches.
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        profiler.stop()
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(
            args.profile, f'train_lm.{os.getpid()}.pt.trace.json'))

    emitter = None
    if args.metrics_file and main_rank:
        from skypilot_tpu_torch.observability.step_metrics import (
            StepMetrics, peak_flops_for)
        if lora_spec is not None:
            n_params += sum(t.numel() for layer in state.params['lora']
                            .values() for f in layer.values()
                            for t in f.values())
        emitter = StepMetrics(
            args.metrics_file, n_params=n_params, n_devices=n_dev,
            peak_flops=peak_flops_for(torch.cuda.get_device_name(device)
                                      if device.type == 'cuda' else None))
        print(f'step metrics -> {args.metrics_file} '
              f'(n_params={n_params:,})', flush=True)

    # Self-supervising guards (--guard): preemption-notice watcher,
    # on-device NaN/spike skip + rollback, step watchdog.
    sup = None
    if args.guard:
        sup = train_guard.TrainSupervisor(
            spike_factor=args.spike_factor,
            warmup_steps=args.guard_warmup,
            rollback_after=args.rollback_after,
            watchdog_deadline_s=args.watchdog_deadline,
            compile_deadline_s=args.watchdog_compile_deadline,
            notice_poll_s=args.preempt_poll,
            ctx=resume_ctx)
        sup.start()
        wd = (f'{args.watchdog_deadline:.0f}s'
              if args.watchdog_deadline > 0 else 'off')
        say(f'train-guard armed: spike_factor={args.spike_factor} '
            f'warmup={args.guard_warmup} '
            f'rollback_after={args.rollback_after} watchdog={wd} '
            f'preempt_poll={args.preempt_poll:.1f}s')

    # Checkpoint cadence: steps (--ckpt-every) or wall time
    # (--ckpt-interval SECONDS | auto), converted to steps from the mean
    # step time of the first logged window (its warm-up errs toward
    # checkpointing too often: the safe side).
    ckpt_every_steps = args.ckpt_every
    ckpt_interval_s = None
    if args.ckpt_interval == 'auto':
        from skypilot_tpu_torch.jobs import policy as jobs_policy
        rate = (args.preemption_rate if args.preemption_rate is not None
                else float(os.environ['SKYPILOT_PREEMPTION_RATE_PER_HOUR']))
        overhead = (args.ckpt_overhead if args.ckpt_overhead is not None
                    else jobs_policy.DEFAULT_CKPT_OVERHEAD_S)
        ckpt_interval_s = jobs_policy.optimal_checkpoint_interval(
            rate, overhead)
        say(f'ckpt-interval auto: lambda={rate}/hr '
            f'delta={overhead:.0f}s -> tau*={ckpt_interval_s:.0f}s (step '
            f'cadence fixed after the first logged window)')
    elif args.ckpt_interval is not None:
        ckpt_interval_s = float(args.ckpt_interval)
    cadence_fixed = ckpt_interval_s is None

    t0 = time.perf_counter()
    window_tokens = window_steps = 0
    step = start_step
    pending = None  # guard: the last dispatched step's verdict, in flight
    while step < args.steps:
        # A notice seen by any rank stops every rank at this boundary:
        # the save is collective, so all must save the same step.
        if sup is not None and (distributed.any_rank(sup.preempted)
                                if job is not None else sup.preempted):
            # Preemption notice (metadata, SIGTERM, or injected):
            # checkpoint NOW and exit with the typed code the managed-jobs
            # controller maps to recovery; the resumed run loses at most
            # the step that was in flight.
            if sup.watchdog is not None:
                sup.watchdog.stop()  # a slow save must not trip it
            say(f'preemption notice ({sup.preempt_reason or "another rank"})'
                f' at step {step}: checkpointing and exiting '
                f'rc={train_guard.EXIT_PREEMPTED_GRACEFUL}')
            if mgr is not None:
                with timeline.Event('train/checkpoint', 'preempt'):
                    mgr.save(step, state, force=True)
                    mgr.wait_until_finished()
                    mgr.close()
            if emitter is not None:
                emitter.close()
            if args.trace_file and main_rank:
                timeline.save()
            sup.stop()
            sys.exit(train_guard.EXIT_PREEMPTED_GRACEFUL)
        # >= not ==: a checkpoint resume may land past prof_start.
        if profiler is None and prof_start <= step < prof_stop:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        first = step == start_step
        if sup is not None:
            sup.beat('data', first_step=first)
        with timeline.Event('train/data'):
            tokens = next_tokens()
        if sup is not None:
            sup.beat('step', first_step=first)
        with timeline.Event('train/step', f'step {step}'):
            if sup is not None:
                max_gnorm, loss_scale = sup.step_ctl(step)
                state, aux = step_fn(state, tokens, max_gnorm, loss_scale)
            else:
                faults.point('train.step', step=str(step), **resume_ctx)
                state, aux = step_fn(state, tokens)
        if sup is not None:
            loss, gnorm, bad_flag = aux
            verdict_in_flight = HostScalars(loss, gnorm, bad_flag)
        elif collect:
            loss, gnorm = aux
        else:
            loss, gnorm = aux, None
        if profiler is not None and step + 1 >= prof_stop:
            stop_profile()
            # One window a run: a rollback into it does not trace again.
            profiler, prof_start, prof_stop = None, -1, -1
            print(f'profile: steps {args.profile_window[0]}..'
                  f'{args.profile_window[1]} traced to {args.profile}',
                  flush=True)
        window_tokens += batch * args.seq
        window_steps += 1
        if sup is not None:
            # Lagged observation: read the PREVIOUS step's verdict while
            # this one runs (a rollback discards at most the one step
            # dispatched since).
            if pending is not None:
                p_step, p_scalars = pending
                pending = None
                p_loss, p_gnorm, p_bad = p_scalars.values()
                verdict = sup.observe(p_step, p_loss, p_gnorm, bool(p_bad))
                if verdict == 'rollback':
                    restored = False
                    if mgr is not None:
                        try:
                            state = mgr.restore(state)
                            restored = True
                        except CheckpointNotFoundError:
                            pass
                    if restored:
                        sup.guard.reset_after_rollback()
                        step = state.step
                        t0 = time.perf_counter()
                        window_tokens = window_steps = 0
                        say(f'train-guard: rolled back to last '
                            f'checkpoint (step {step})')
                        continue
                    # Nothing to roll back to. The params are still clean
                    # (every bad step was skipped on the device): reset
                    # the escalation counter and keep skipping.
                    sup.guard.consecutive_bad = 0
                    say('train-guard: rollback requested but no '
                        'checkpoint available; continuing with per-step '
                        'skips')
            pending = (step, verdict_in_flight)
        if mgr is not None and (ckpt_interval_s is None or
                                (step + 1) % ckpt_every_steps == 0):
            with timeline.Event('train/checkpoint', f'step {step + 1}'):
                mgr.save(step + 1, state)
        if profiler is not None and step + 1 >= args.steps:
            # The window ran past the final step: still flush the trace.
            stop_profile()
            profiler, prof_start, prof_stop = None, -1, -1
            print(f'profile: traced through final step {step + 1} to '
                  f'{args.profile}', flush=True)
        boundary = (step + 1) % args.log_every == 0
        if boundary and not cadence_fixed:
            if sup is not None:
                sup.beat('commit')
            float(loss)         # waits for the step to finish
            mean_step = (time.perf_counter() - t0) / max(window_steps, 1)
            # Every rank fixes the cadence (saves are collective); rank
            # 0's, so that clocks apart cannot split the schedule.
            ckpt_every_steps = distributed.broadcast(
                max(1, round(ckpt_interval_s / max(mean_step, 1e-9))))
            cadence_fixed = True
            say(f'ckpt cadence: interval {ckpt_interval_s:.0f}s / '
                f'measured step {mean_step:.3f}s -> checkpoint every '
                f'{ckpt_every_steps} steps')
        if boundary:
            if sup is not None:
                sup.beat('commit')
            if main_rank:
                loss_val = float(loss)      # waits for the step to finish
                dt = time.perf_counter() - t0
                print(f'step {step + 1}/{args.steps} loss={loss_val:.4f} '
                      f'tokens/s={window_tokens / dt:,.0f}', flush=True)
                if emitter is not None:
                    emitter.log(step + 1,
                                step_time_s=dt / max(window_steps, 1),
                                tokens=batch * args.seq, loss=loss_val,
                                grad_norm=(float(gnorm) if gnorm is not None
                                           else None),
                                bubble_frac=bubble_frac)
            t0 = time.perf_counter()
            window_tokens = window_steps = 0
        step += 1
    if sup is not None:
        if pending is not None:
            p_step, p_scalars = pending
            p_loss, p_gnorm, p_bad = p_scalars.values()
            sup.observe(p_step, p_loss, p_gnorm, bool(p_bad))
        sup.stop()  # before the final save: it can be slow
        say(f'train-guard summary: {sup.summary()}')
    if mgr is not None:
        with timeline.Event('train/checkpoint', 'final'):
            mgr.save(args.steps, state, force=True)
            mgr.wait_until_finished()
            mgr.close()
    lora_whole = None
    if lora_spec is not None:
        # Whole factors (a tensor-sharded job gathers its slices; every
        # rank takes part).
        from skypilot_tpu_torch.parallel.train import whole_lora
        lora_whole = whole_lora(state)
    if lora_spec is not None and main_rank:
        # The produce half of the fine-tune-and-serve loop: the trained
        # factors become an artifact serve_lm --adapter-dir loads.
        out_dir = args.adapter_out or (
            os.path.join(args.ckpt_dir, 'adapter') if args.ckpt_dir
            else 'adapter_out')
        lora_lib.save_adapter(
            out_dir, convert.lora_params_to_numpy(lora_whole),
            lora_spec, base_model=args.init_from_hf or args.model,
            step=state.step)
        print(f'adapter artifact -> {out_dir} (rank={lora_spec.rank} '
              f'alpha={lora_spec.alpha} targets={list(lora_spec.targets)})',
              flush=True)
    if emitter is not None:
        emitter.close()
    if loader is not None:
        loader.close()
    say('training done')
    if args.trace_file and main_rank:
        timeline.save()


if __name__ == '__main__':
    main()
