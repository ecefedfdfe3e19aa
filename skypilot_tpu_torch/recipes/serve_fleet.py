"""Multi-replica LM serving fleet on one host: N real `serve_lm`
processes behind the replica-plane load balancer, autoscaled from
scraped engine metrics (port of skypilot_tpu/recipes/serve_fleet.py:
the same flags, defaults and help; the replicas are the port's
`serve_lm`, on the card unless --cpu is given).

  python -m skypilot_tpu_torch.recipes.serve_fleet \
      --model llama-tiny --cpu --replicas 2 --max-replicas 4 \
      --lb-port 9000 --lb-policy prefix_affinity
  python -m skypilot_tpu_torch.recipes.serve_fleet \
      --model llama3-8b --replicas 1 --max-replicas 2 \
      --kv-pool-bytes 4000000000 --state-dir /var/lib/fleet

Replicas get no device assignment of their own, as in the reference:
each takes the cards it is shown, so on one card they share it, each
pool bounded by --kv-pool-bytes. Each replica polls the GCE metadata
server for spot preemption notices unless STPU_PREEMPT_METADATA_URL
(inherited from this process) points elsewhere.

The LB serves /generate, /generate_text and /v1/* on --lb-port with
prefix-cache-affinity routing (requests sharing a system prompt land
on the replica already holding those KV pages), /fleet/status with
per-replica scraped state + LB counters, and /metrics. Scale-up
triggers on engine pressure (prefill backlog tokens, queue depth,
shed rate); scale-down always drains: the victim leaves the routing
set, gets SIGTERM, finishes its in-flight requests, and only then
exits. SIGTERM to THIS process drains the whole fleet.

Crash-only restart: with `--state-dir DIR` the replica manager
journals every replica lifecycle change to DIR/fleet.journal
(fsync'd JSONL). Killing THIS process — even SIGKILL — orphans
nothing: restart with the same --state-dir and the controller
replays the journal, verifies each journaled replica (pid alive,
/stats echoing the journaled instance UUID), adopts the survivors
back into the routing ring (prefix-affinity keys land back on the
replicas still holding their KV pages), resumes interrupted drains,
and politely SIGTERMs (never SIGKILLs) anything it cannot verify.

Chaos: --fault-plan is forwarded to every replica (the plan arms
inside each serve_lm process). --stub-replicas swaps serve_lm for the
model-free stub replica (chaos drills and the controller-restart e2e).
Never in production.

--spot-decode N > 0 exits: the reference prices that pool from the GCP
TPU catalog, whose prices have no meaning for the port's cards
(ROADMAP A18(b)). So does --spot-accelerator set away from its default:
only that pool reads it.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional

#: Why --spot-decode N > 0 is refused (ROADMAP A18(b)).
SPOT_DECODE_REFUSAL = (
    '--spot-decode: the spot decode pool is priced from the GCP TPU '
    'catalog (spot_zone_economics over --spot-accelerator), which has '
    'no meaning for the PyTorch port\'s cards; not supported by the '
    'port yet (ROADMAP A18(b))')
#: Why --spot-accelerator away from its default is refused: only the
#: spot decode pool reads it.
SPOT_ACCELERATOR_REFUSAL = (
    '--spot-accelerator: takes effect only with --spot-decode N > 0, '
    'which the PyTorch port refuses (ROADMAP A18(b))')


def build_replica_cmd(args: argparse.Namespace) -> list:
    """The serve_lm command line shared by every replica (no --port:
    the manager appends one per replica)."""
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.recipes.serve_lm',
           '--model', args.model,
           '--max-total-len', str(args.max_total_len),
           '--continuous-batching',
           '--num-slots', str(args.num_slots)]
    if args.hf:
        cmd += ['--hf', args.hf]
    if args.ckpt_dir:
        cmd += ['--ckpt-dir', args.ckpt_dir]
    if args.adapter_dir:
        cmd += ['--adapter-dir', args.adapter_dir,
                '--max-adapters', str(args.max_adapters)]
    if args.prefill_chunk is not None:
        cmd += ['--prefill-chunk', str(args.prefill_chunk)]
    if args.max_queue_requests:
        cmd += ['--max-queue-requests', str(args.max_queue_requests)]
    if args.max_queue_tokens:
        cmd += ['--max-queue-tokens', str(args.max_queue_tokens)]
    if args.kv_dtype:
        cmd += ['--kv-dtype', args.kv_dtype]
    if args.kv_pool_bytes:
        cmd += ['--kv-pool-bytes', str(args.kv_pool_bytes)]
    if args.weight_dtype:
        cmd += ['--weight-dtype', args.weight_dtype]
    if args.tensor > 1:
        cmd += ['--tensor', str(args.tensor)]
    if args.stages > 1:
        cmd += ['--stages', str(args.stages)]
    if args.kv_spill_bytes:
        cmd += ['--kv-spill-bytes', str(args.kv_spill_bytes)]
    if args.kv_cold_dir:
        cmd += ['--kv-cold-dir', args.kv_cold_dir]
    if args.fault_plan:
        cmd += ['--fault-plan', args.fault_plan]
    if args.trace_sample:
        # Replicas never head-sample in a fleet (the LB owns the
        # decision and propagates it via the trace header); the flag
        # still turns their span recording on.
        cmd += ['--trace-sample', str(args.trace_sample)]
        if args.trace_seed is not None:
            cmd += ['--trace-seed', str(args.trace_seed)]
    if args.slo:
        cmd += ['--slo', args.slo]
    if args.cpu:
        cmd += ['--cpu']
    return cmd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.recipes.serve_fleet')
    parser.add_argument('--model', default='llama-tiny')
    parser.add_argument('--hf', default=None)
    parser.add_argument('--ckpt-dir', default=None)
    parser.add_argument('--max-total-len', type=int, default=256)
    parser.add_argument('--num-slots', type=int, default=8)
    parser.add_argument('--prefill-chunk', type=int, default=None)
    parser.add_argument('--max-queue-requests', type=int, default=0)
    parser.add_argument('--max-queue-tokens', type=int, default=0)
    parser.add_argument('--adapter-dir', default=None, metavar='DIR',
                        help='multi-LoRA serving: forwarded to every '
                             'replica; a shared artifact dir means '
                             'any replica can hot-load any tenant '
                             'adapter (the LB affinity key pins a '
                             'tenant to the replica already holding '
                             'its pages + adapter)')
    parser.add_argument('--max-adapters', type=int, default=8,
                        help='forwarded to serve_lm --max-adapters')
    parser.add_argument('--kv-dtype', choices=['bf16', 'int8'],
                        default=None,
                        help='forwarded to every replica: int8 KV '
                             'pages (~2x slots / prefix residency '
                             'per HBM byte; docs/guides.md '
                             '"Quantized serving")')
    parser.add_argument('--kv-pool-bytes', type=int, default=0,
                        metavar='B',
                        help='forwarded to serve_lm --kv-pool-bytes')
    parser.add_argument('--weight-dtype', choices=['bf16', 'int8'],
                        default=None,
                        help='forwarded to every replica: int8 '
                             'per-channel projection weights')
    parser.add_argument('--tensor', type=int, default=1,
                        help='forwarded to every replica: tensor-'
                             'parallel serving over N devices '
                             '(serve_lm --tensor). Each replica '
                             'claims its own N chips')
    parser.add_argument('--stages', type=int, default=1,
                        help='forwarded to every replica: pipeline-'
                             'parallel serving over S stages '
                             '(serve_lm --stages); composes with '
                             '--tensor for S x N chips per replica')
    parser.add_argument('--fault-plan', default=None, metavar='JSON')
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--state-dir', default=None, metavar='DIR',
                        help='durable fleet journal directory: '
                             'restarting with the same DIR adopts '
                             'surviving replicas instead of '
                             'orphaning them')
    parser.add_argument('--stub-replicas', action='store_true',
                        help='model-free stub replicas '
                             '(replica_plane/stub.py) instead of '
                             'serve_lm — chaos drills only')
    parser.add_argument('--replicas', type=int, default=2,
                        help='initial + minimum replica count (the '
                             'DECODE pool when --prefill-replicas '
                             'is set)')
    parser.add_argument('--spot-decode', type=int, default=0,
                        metavar='N',
                        help='spot decode pool: N additional decode '
                             'replicas labeled with zones walked in '
                             'the catalog\'s RISK-ADJUSTED spot '
                             'order (spot_zone_economics: price x '
                             'preemption-rate multiplier) for '
                             '--spot-accelerator. A PreemptionNotice '
                             '(or a serve.preempt_notice fault rule '
                             'scoped to the zone) makes the replica '
                             'evacuate every KV chain to on-demand '
                             'survivors inside the ~30s grace '
                             'window instead of dropping sessions')
    parser.add_argument('--spot-accelerator', default='tpu-v5e-16',
                        metavar='ACC',
                        help='TPU type whose catalog rows price the '
                             'spot decode pool (zone labels + '
                             '$/hour in /fleet/status and the '
                             'journal)')
    parser.add_argument('--rebalance-skew', type=float, default=0.0,
                        metavar='R',
                        help='hot-spot rebalancing: when one ready '
                             'replica\'s load (prefill backlog '
                             'tokens + queue depth) exceeds R x the '
                             'pool median for --rebalance-ticks '
                             'consecutive scrapes, the controller '
                             'migrates its hottest sessions\' KV '
                             'chains to the coldest replica between '
                             'requests. 0 disables (default)')
    parser.add_argument('--rebalance-ticks', type=int, default=3,
                        help='consecutive skewed scrapes (same '
                             'hottest replica) before a rebalance '
                             'fires')
    parser.add_argument('--rebalance-sessions', type=int, default=2,
                        help='sessions migrated per rebalance step '
                             '(small on purpose: each step is '
                             're-evaluated against fresh load)')
    parser.add_argument('--prefill-replicas', type=int, default=0,
                        metavar='N',
                        help='disaggregated serving: N additional '
                             'replicas spawned with --role prefill. '
                             'Long prompts (>= --disagg-prompt-'
                             'threshold) route to them; they prefill '
                             'and hand the KV page chain to a decode '
                             'replica (POST /kv/import), which '
                             'serves the decode phase — decode-pool '
                             'ITL stays flat as long-prompt traffic '
                             'rises. 0 = unified fleet')
    parser.add_argument('--disagg-prompt-threshold', type=int,
                        default=256, metavar='T',
                        help='LB routing threshold, prompt tokens '
                             '(text endpoints estimate chars/4): '
                             'requests at or above it go to the '
                             'prefill pool (when --prefill-replicas '
                             '> 0)')
    parser.add_argument('--kv-spill-bytes', type=int, default=0,
                        metavar='B',
                        help='forwarded to every replica: tiered '
                             'prefix cache — evicted KV pages spill '
                             'to a host-RAM LRU of B bytes and '
                             'restore bit-identically on a later '
                             'chain-key hit')
    parser.add_argument('--kv-cold-dir', default=None, metavar='DIR',
                        help='forwarded to every replica: cold tier '
                             'behind the host spill (local dir or '
                             'gs:// prefix)')
    parser.add_argument('--max-replicas', type=int, default=None,
                        help='autoscaler ceiling (default: --replicas '
                             '— fixed-size fleet)')
    parser.add_argument('--lb-port', type=int,
                        default=int(os.environ.get(
                            'SKYPILOT_SERVE_PORT', 9000)))
    parser.add_argument('--lb-policy', default='prefix_affinity',
                        help='round_robin | least_load | '
                             'prefix_affinity')
    parser.add_argument('--page-size', type=int, default=16,
                        help='affinity hashing page size; must match '
                             'the engine KV page size')
    parser.add_argument('--scrape-interval', type=float, default=1.0)
    parser.add_argument('--drain-grace', type=float, default=630.0,
                        help='seconds a draining replica gets to '
                             'finish in-flight requests before '
                             'SIGKILL')
    parser.add_argument('--target-queue-per-replica', type=float,
                        default=4.0)
    parser.add_argument('--target-backlog-per-replica', type=float,
                        default=4096.0)
    parser.add_argument('--upscale-delay', type=float, default=10.0)
    parser.add_argument('--downscale-delay', type=float, default=60.0)
    parser.add_argument('--trace-sample', type=float, default=0.0,
                        metavar='P',
                        help='distributed tracing: the LB samples '
                             'this fraction of requests and '
                             'propagates the decision to replicas '
                             'over the x-skypilot-trace header; '
                             '`stpu trace <id>` merges the per-'
                             'process spans into one Chrome trace')
    parser.add_argument('--trace-seed', type=int, default=None,
                        help='seed the LB trace sampler '
                             '(reproducible sampled set + ids)')
    parser.add_argument('--slo', default=None, metavar='SPEC',
                        help='fleet SLO targets (e.g. "p99_ttft_ms='
                             '500,error_rate=0.01"): the LB tracks '
                             'user-perceived burn rates in '
                             '/fleet/status and each replica tracks '
                             'its own in /stats')
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.spot_decode > 0:
        parser.error(SPOT_DECODE_REFUSAL)
    if args.spot_accelerator != parser.get_default('spot_accelerator'):
        parser.error(SPOT_ACCELERATOR_REFUSAL)
    slo_targets = None
    if args.slo:
        from skypilot_tpu_torch.observability import slo as slo_lib
        try:
            slo_targets = slo_lib.parse_slo(args.slo)
        except ValueError as e:
            parser.error(str(e))

    from skypilot_tpu_torch.serve import autoscalers
    from skypilot_tpu_torch.serve import load_balancing_policies as lb_policies
    from skypilot_tpu_torch.serve import service_spec as spec_lib
    from skypilot_tpu_torch.serve.replica_plane import (FleetController,
                                                        PrefillPool,
                                                        ReplicaManager,
                                                        make_lb_server,
                                                        serve_lm_factory,
                                                        stub_factory)
    from skypilot_tpu_torch.utils.registry import LB_POLICY_REGISTRY

    # The spot decode pool is part of the serving floor: the
    # autoscaler must not read the extra spot replicas as surplus
    # and drain them right back down (refused above on the port, so
    # the floor is --replicas; zoned replicas adopted from a journal
    # still count as the pool's).
    total_decode = args.replicas + max(args.spot_decode, 0)
    max_replicas = max(args.max_replicas or total_decode,
                       total_decode)
    spec = spec_lib.SkyServiceSpec(
        min_replicas=total_decode, max_replicas=max_replicas,
        upscale_delay_seconds=args.upscale_delay,
        downscale_delay_seconds=args.downscale_delay)
    autoscaler = autoscalers.EngineMetricsAutoscaler(
        spec,
        target_queue_per_replica=args.target_queue_per_replica,
        target_backlog_per_replica=args.target_backlog_per_replica)
    policy_cls = LB_POLICY_REGISTRY.from_str(args.lb_policy)
    policy: lb_policies.LoadBalancingPolicy = policy_cls()

    # Disaggregated mode: a fixed-size (min==max) prefill pool with
    # its own backlog-driven autoscaler, and the LB routing long
    # prompts to it.
    prefill_autoscaler = None
    prefill_pool = None
    if args.prefill_replicas > 0:
        prefill_spec = spec_lib.SkyServiceSpec(
            min_replicas=args.prefill_replicas,
            max_replicas=args.prefill_replicas,
            upscale_delay_seconds=args.upscale_delay,
            downscale_delay_seconds=args.downscale_delay)
        prefill_autoscaler = autoscalers.EngineMetricsAutoscaler(
            prefill_spec,
            target_queue_per_replica=args.target_queue_per_replica,
            target_backlog_per_replica=args.target_backlog_per_replica)
        prefill_pool = PrefillPool()

    env = dict(os.environ)
    if args.stub_replicas:
        if args.fault_plan:
            # Stubs take no --fault-plan flag; the plan arms from
            # the environment at import (robustness/faults.py).
            env['STPU_FAULT_PLAN'] = args.fault_plan
        factory = stub_factory(env=env)
    else:
        factory = serve_lm_factory(build_replica_cmd(args), env=env)
    manager = ReplicaManager(factory,
                             drain_grace_s=args.drain_grace,
                             state_dir=args.state_dir)
    controller = FleetController(
        manager, policy, autoscaler,
        interval_s=args.scrape_interval,
        prefill_autoscaler=prefill_autoscaler,
        prefill_pool=prefill_pool,
        rebalance_skew=args.rebalance_skew,
        rebalance_ticks=args.rebalance_ticks,
        rebalance_sessions=args.rebalance_sessions)
    lb = make_lb_server(
        policy, args.lb_port,
        policy_name=args.lb_policy, manager=manager,
        page_size=args.page_size,
        disagg_threshold=(args.disagg_prompt_threshold
                          if args.prefill_replicas > 0 else 0),
        prefill_pool=prefill_pool,
        trace_sample=args.trace_sample,
        trace_seed=args.trace_seed,
        slo_targets=slo_targets)

    def handle_term(signum, frame):  # noqa: ARG001
        def _shutdown():
            controller.shutdown()
            lb.shutdown()
        threading.Thread(target=_shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, handle_term)
    adopted = 0
    if args.state_dir:
        summary = manager.adopt()
        adopted = len(summary['adopted'])
        if any(summary.values()):
            print(f'serve_fleet: adopted {summary["adopted"]} from '
                  f'{args.state_dir}, resumed drains '
                  f'{summary["resumed_drains"]}, reaped orphans '
                  f'{summary["orphans"]}', flush=True)
    adopted_prefill = sum(
        1 for v in manager.views() if v.role == 'prefill')
    adopted_spot = sum(
        1 for v in manager.views()
        if v.role != 'prefill' and v.zone)
    decode_role = 'decode' if args.prefill_replicas else ''
    for _ in range(max(0, args.replicas -
                       (adopted - adopted_prefill - adopted_spot))):
        manager.spawn(role=decode_role)
    for _ in range(max(0, args.prefill_replicas - adopted_prefill)):
        manager.spawn(role='prefill')
    loop = threading.Thread(target=controller.run, daemon=True)
    loop.start()
    print(f'serve_fleet: LB on :{args.lb_port} '
          f'policy={args.lb_policy} replicas={args.replicas}..'
          f'{max_replicas} model={args.model}', flush=True)
    try:
        lb.serve_forever()
    finally:
        controller.shutdown()


if __name__ == '__main__':
    main()
