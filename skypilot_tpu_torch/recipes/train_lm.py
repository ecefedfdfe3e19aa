"""LM-training recipe on PyTorch/CUDA (port of
skypilot_tpu/recipes/train_lm.py), the payload that Managed Jobs
launches and recovers: on relaunch it resumes from the newest verified
step in --ckpt-dir.

Takes the reference's flags and prints its log lines (`step i/N
loss=... tokens/s=...`, `resumed from checkpoint step N`, `adapter
artifact -> ...`, `training done`). One card: the flags for meshes,
pipelines and the reference's other trainer features exit at startup
naming themselves and their ROADMAP item, as do the GPT, Mixtral and
DeepSeek model names (ROADMAP A12), the reference's default `--model
gpt2-124m` among them: name a ported model. Weights are a seeded init
on the device. Runs on the GPU unless --cpu is given.

  python -m skypilot_tpu_torch.recipes.train_lm --model llama3-8b \\
      --seq 2048 --steps 100 --lora 16 --remat --ckpt-dir ckpts/
  python -m skypilot_tpu_torch.recipes.train_lm --cpu --model llama-tiny \\
      --steps 20 --seq 64        # a local run on the CPU
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import List, Optional

# Flags the port parses (so a launcher's command line stays the same) but
# does not honor yet: (flag, attribute, default, ROADMAP item). A value
# other than the default exits at startup naming the flag.
_REFUSED = (
    ('--tensor', 'tensor', 1, 'A10/A13'),
    ('--expert', 'expert', 1, 'A12'),
    ('--seq-parallel', 'seq_parallel', 1, 'A13'),
    ('--pipeline-stages', 'pipeline_stages', 1, 'A13'),
    ('--pipeline-schedule', 'pipeline_schedule', 'gpipe', 'A13'),
    ('--virtual-stages', 'virtual_stages', 0, 'A13'),
    ('--microbatches', 'microbatches', 0, 'A13'),
    ('--zero1', 'zero1', False, 'A11'),
    ('--overlap', 'overlap', False, 'A11'),
    ('--guard', 'guard', False, 'A11'),
    ('--spike-factor', 'spike_factor', 10.0, 'A11'),
    ('--guard-warmup', 'guard_warmup', 10, 'A11'),
    ('--rollback-after', 'rollback_after', 3, 'A11'),
    ('--watchdog-deadline', 'watchdog_deadline', 300.0, 'A11'),
    ('--watchdog-compile-deadline', 'watchdog_compile_deadline', 1800.0,
     'A11'),
    ('--preempt-poll', 'preempt_poll', 5.0, 'A11'),
    ('--ckpt-interval', 'ckpt_interval', None, 'A11'),
    ('--preemption-rate', 'preemption_rate', None, 'A11'),
    ('--ckpt-overhead', 'ckpt_overhead', None, 'A11'),
    ('--init-from-hf', 'init_from_hf', None, 'A11'),
    ('--profile', 'profile', None, 'A11'),
    ('--profile-steps', 'profile_steps', '4:8', 'A11'),
    ('--trace-file', 'trace_file', None, 'A11'),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.recipes.train_lm')
    # The reference's default, whose GPT family this port refuses (ROADMAP
    # A12): name one of the ported models.
    p.add_argument('--model', default='gpt2-124m',
                   help='llama3-8b, llama-tiny, qwen2-7b or qwen-tiny')
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--seq', type=int, default=1024)
    p.add_argument('--global-batch', type=int, default=0,
                   help='0 = 8 per device')
    p.add_argument('--data', default='synthetic',
                   help='"synthetic" or a dir/glob of token .bin shards')
    p.add_argument('--ckpt-dir', default=None)
    p.add_argument('--ckpt-every', type=int, default=50)
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
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (default: the GPU)')
    # The reference's flags for features this port does not have yet.
    p.add_argument('--tensor', type=int, default=1)
    p.add_argument('--expert', type=int, default=1)
    p.add_argument('--seq-parallel', type=int, default=1)
    p.add_argument('--pipeline-stages', type=int, default=1)
    p.add_argument('--pipeline-schedule', default='gpipe',
                   choices=['gpipe', '1f1b', 'interleaved'])
    p.add_argument('--virtual-stages', type=int, default=0)
    p.add_argument('--microbatches', type=int, default=0)
    p.add_argument('--zero1', action='store_true')
    p.add_argument('--overlap', action='store_true')
    p.add_argument('--guard', action='store_true')
    p.add_argument('--spike-factor', type=float, default=10.0)
    p.add_argument('--guard-warmup', type=int, default=10)
    p.add_argument('--rollback-after', type=int, default=3)
    p.add_argument('--watchdog-deadline', type=float, default=300.0)
    p.add_argument('--watchdog-compile-deadline', type=float, default=1800.0)
    p.add_argument('--preempt-poll', type=float, default=5.0)
    p.add_argument('--ckpt-interval', default=None)
    p.add_argument('--preemption-rate', type=float, default=None)
    p.add_argument('--ckpt-overhead', type=float, default=None)
    p.add_argument('--init-from-hf', default=None, metavar='DIR')
    p.add_argument('--profile', default=None, metavar='DIR')
    p.add_argument('--profile-steps', default='4:8')
    p.add_argument('--trace-file', default=None, metavar='PATH')
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: exits (status 2) naming every flag, model
    and checkpoint location this port cannot honor."""
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = [f'{flag} (ROADMAP {item})' for flag, attr, default, item
           in _REFUSED if getattr(args, attr) != default]
    if bad:
        parser.error('not supported by the PyTorch port yet: '
                     + ', '.join(bad))
    if args.ckpt_dir and args.ckpt_dir.startswith(('gs://', 's3://')):
        parser.error(f'--ckpt-dir {args.ckpt_dir}: remote checkpoint dirs '
                     f'are not ported yet (ROADMAP A11)')
    from skypilot_tpu_torch.models import registry
    try:
        registry.train_config(args.model, args.seq)
    except ValueError as e:
        parser.error(f'--model: {e}')
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    import numpy as np
    import torch

    from skypilot_tpu_torch.device import NoCudaDeviceError, resolve_device
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.parallel.train import (ShardedTrainer,
                                                   default_optimizer)
    try:
        device = resolve_device(cpu=args.cpu)
    except NoCudaDeviceError as e:
        print(f'train_lm: {e}', file=sys.stderr, flush=True)
        sys.exit(1)
    n_dev = 1
    print(f'devices={n_dev} device={device}', flush=True)

    cfg = registry.train_config(args.model, args.seq, args.remat)
    model = convert.init_params(cfg, seed=0, device=device)
    vocab_size = cfg.vocab_size
    batch = args.global_batch or 8 * n_dev
    lora_spec = None
    if args.lora:
        lora_spec = lora_lib.LoraSpec(
            rank=args.lora, alpha=args.lora_alpha or float(args.lora),
            targets=lora_lib.targets_from_name(args.lora_targets))
    tx = default_optimizer(learning_rate=args.lr, warmup_steps=10,
                           total_steps=max(args.steps, 20))
    trainer = ShardedTrainer(
        model, tx=tx, fused_xent=False if args.no_fused_xent else None,
        collect_grad_norm=args.metrics_file is not None, lora=lora_spec)
    print(f'fused_xent={trainer.fused_xent} zero1=False overlap=False '
          f'lora={args.lora or "off"}', flush=True)
    state = trainer.init(seed=7)
    step_fn = trainer.make_train_step()

    # Checkpoint resume (preemption recovery path).
    mgr = None
    if args.ckpt_dir:
        from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
        mgr = CheckpointManager(
            args.ckpt_dir, save_interval_steps=args.ckpt_every,
            base_source=f'seeded init (seed 0) of {args.model}')
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
        from skypilot_tpu_torch.data.token_loader import TokenLoader
        paths = sorted(glob.glob(os.path.join(args.data, '*.bin'))
                       if os.path.isdir(args.data) else glob.glob(args.data))
        loader = TokenLoader(paths, batch=batch, seq=args.seq)

    rng = np.random.default_rng(0)

    def next_tokens() -> torch.Tensor:
        if loader is not None:
            arr = loader.next_batch()[:, :-1].astype(np.int64)
        else:
            arr = rng.integers(0, vocab_size, (batch, args.seq),
                               dtype=np.int32).astype(np.int64)
        return torch.from_numpy(arr).to(device)

    emitter = None
    if args.metrics_file:
        from skypilot_tpu_torch.observability.step_metrics import (
            StepMetrics, matmul_params, peak_flops_for)
        n_params = matmul_params(model.named_parameters())
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

    t0 = time.perf_counter()
    window_tokens = window_steps = 0
    step = state.step
    while step < args.steps:
        tokens = next_tokens()
        state, aux = step_fn(state, tokens)
        loss, gnorm = aux if emitter is not None else (aux, None)
        window_tokens += batch * args.seq
        window_steps += 1
        if mgr is not None:
            mgr.save(step + 1, state)
        if (step + 1) % args.log_every == 0:
            loss_val = float(loss)      # waits for the step to finish
            dt = time.perf_counter() - t0
            print(f'step {step + 1}/{args.steps} loss={loss_val:.4f} '
                  f'tokens/s={window_tokens / dt:,.0f}', flush=True)
            if emitter is not None:
                emitter.log(step + 1, step_time_s=dt / max(window_steps, 1),
                            tokens=batch * args.seq, loss=loss_val,
                            grad_norm=float(gnorm))
            t0 = time.perf_counter()
            window_tokens = window_steps = 0
        step += 1
    if mgr is not None:
        mgr.save(args.steps, state, force=True)
    if lora_spec is not None:
        # The produce half of the fine-tune-and-serve loop: the trained
        # factors become an artifact serve_lm --adapter-dir loads.
        out_dir = args.adapter_out or (
            os.path.join(args.ckpt_dir, 'adapter') if args.ckpt_dir
            else 'adapter_out')
        lora_lib.save_adapter(
            out_dir, convert.lora_params_to_numpy(state.params['lora']),
            lora_spec, base_model=args.model, step=state.step)
        print(f'adapter artifact -> {out_dir} (rank={lora_spec.rank} '
              f'alpha={lora_spec.alpha} targets={list(lora_spec.targets)})',
              flush=True)
    if emitter is not None:
        emitter.close()
    print('training done', flush=True)


if __name__ == '__main__':
    main()
