"""The metric catalog: every Prometheus metric this codebase exports.

The port's copy of skypilot_tpu/observability/catalog.py, pinned to it by
tests/test_torch_observability.py.

One table, three consumers:
  - the instrumentation sites (`counter()`/`gauge()`/`histogram()`
    get-or-create against the default REGISTRY from these specs);
  - the docs metric table (docs/guides.md — kept in sync by
    tests/unit_tests/test_metric_catalog.py);
  - the CI name checker (snake_case, `skypilot_` prefix, documented).

Adding a metric = adding a row here + a line in the docs table; the
checker fails the build on drift.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from skypilot_tpu_torch.observability import metrics as m

# Latency buckets, seconds. Step/prefill: device dispatches (ms..s);
# request path: whole generations (up to minutes).
STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0)
REQUEST_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0)
TOKEN_GAP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5)

# name -> (kind, help, labelnames[, options])
#   kind: counter | gauge | histogram | gauge_as_counter
#   options: {'buckets': (...)} for histograms
SPECS: Dict[str, Tuple] = {
    # -- serving engine (models/batching.py); label engine = instance id
    'skypilot_serving_queue_depth': (
        'gauge', 'Requests waiting for a decode slot (queued + ready)',
        ('engine',)),
    'skypilot_serving_active_slots': (
        'gauge', 'Decode slots currently running a request',
        ('engine',)),
    'skypilot_serving_num_slots': (
        'gauge', 'Decode slot pool size', ('engine',)),
    'skypilot_serving_admissions_total': (
        'counter', 'Requests admitted into a decode slot (prefilled)',
        ('engine',)),
    'skypilot_serving_preemptions_total': (
        'counter', 'Requests preempted by KV page-pool pressure '
                   '(re-queued for recompute)', ('engine',)),
    'skypilot_serving_decode_steps_total': (
        'counter', 'Jitted decode dispatches (plain, chunked, or '
                   'speculative-verify rounds)', ('engine',)),
    'skypilot_serving_tokens_committed_total': (
        'counter', 'Generated tokens committed across all slots',
        ('engine',)),
    'skypilot_serving_decode_step_seconds': (
        'histogram', 'Wall time of one decode round (dispatch + '
                     'host commit)', ('engine',),
        {'buckets': STEP_BUCKETS}),
    'skypilot_serving_prefill_seconds': (
        'histogram', 'Wall time from a request\'s first prefill '
                     'chunk dispatch to its first token (whole-prompt '
                     'prefill when chunking is off)', ('engine',),
        {'buckets': STEP_BUCKETS}),
    'skypilot_serving_prefill_chunk_seconds': (
        'histogram', 'Wall time of one chunked-prefill dispatch '
                     '(async dispatch cost, not device compute — the '
                     'stall-free scheduler never waits on prefill)',
        ('engine',), {'buckets': STEP_BUCKETS}),
    'skypilot_serving_prefill_backlog_tokens': (
        'gauge', 'Prompt-suffix tokens admitted into a slot but not '
                 'yet prefilled (chunked-prefill backlog)',
        ('engine',)),
    'skypilot_serving_prefill_budget_utilization': (
        'gauge', 'Prefill tokens run last iteration / per-iteration '
                 'token budget (0..1)', ('engine',)),
    'skypilot_serving_decode_stall_seconds_total': (
        'counter', 'Cumulative wall time the scheduler host blocked '
                   'on fetching decode tokens from the device '
                   '(pipelining hides this behind the next dispatch)',
        ('engine',)),
    'skypilot_serving_kv_pool_bytes': (
        'gauge', 'Device bytes of the engine\'s KV cache (paged: '
                 'int8/bf16 pages + scale arrays; dense: per-slot '
                 'rows) — the quantized-serving memory denominator',
        ('engine',)),
    'skypilot_serving_kv_pool_bytes_per_device': (
        'gauge', 'KV cache bytes resident on ONE device: sharded '
                 'pool values count a single kv-heads shard, '
                 'replicated leaves in full — the per-chip HBM '
                 'figure --kv-pool-bytes budgets under --tensor '
                 '(equals kv_pool_bytes on a single device)',
        ('engine',)),
    'skypilot_serving_weight_bytes': (
        'gauge', 'Device bytes of the served model weights '
                 '(quantized projections count their int8 + scale '
                 'footprint)', ()),
    'skypilot_serving_storage_info': (
        'gauge', 'Serving storage formats in effect (always 1; read '
                 'the kv_dtype/weight_dtype labels)',
        ('kv_dtype', 'weight_dtype')),
    'skypilot_serving_attention_impl_info': (
        'gauge', 'Resolved paged-attention implementation in effect '
                 '(always 1; read the labels — impl is xla | kernel | '
                 'fused | fused_interpret, or dense when the engine '
                 'runs the dense KV cache; ops/pallas_paged.py '
                 'dispatch rules)',
        ('engine', 'impl', 'kv_dtype')),
    'skypilot_serving_attention_bytes_per_token': (
        'gauge', 'Modeled HBM bytes one decode step moves per '
                 'generated token at the current decode batch: pool '
                 'reads + scale rows + the XLA route\'s dequantize '
                 'materialization + amortized weight reads + LoRA '
                 'factor rows (ops/pallas_paged.bytes_per_token_model '
                 '— the serve_bench roofline denominator)',
        ('engine',)),
    'skypilot_serving_pipeline_stages': (
        'gauge', 'Pipeline-parallel stages the engine serves over '
                 '(--stages; 1 = no stage split). Each stage owns a '
                 'contiguous layer range on its own tensor submesh '
                 'and stores only its layers\' KV pages', ('engine',)),
    'skypilot_serving_prefill_bubble_fraction': (
        'gauge', 'Closed-form pipeline fill/drain bubble of the last '
                 'prefill burst: (S-1)/(M+S-1) for S stages and M '
                 'chunk microbatches (0 when S=1 or no prefill has '
                 'run)', ('engine',)),
    'skypilot_serving_pages_free': (
        'gauge', 'Free pages in the shared KV page pool', ('engine',)),
    'skypilot_serving_pages_used': (
        'gauge', 'Allocated pages in the shared KV page pool '
                 '(incl. prefix-cache residents)', ('engine',)),
    'skypilot_serving_prefix_cache_hits_total': (
        'counter', 'Prompt pages served from the prefix cache '
                   '(prefill skipped)', ('engine',)),
    'skypilot_serving_prefix_cache_misses_total': (
        'counter', 'Full prompt pages that had to be computed',
        ('engine',)),
    'skypilot_serving_prefix_cache_evictions_total': (
        'counter', 'Cached pages evicted back to the allocator under '
                   'pool pressure', ('engine',)),
    'skypilot_serving_engine_restarts_total': (
        'counter', 'Full engine resets after an unrecoverable '
                   'scheduler error (KV cache lost; in-flight '
                   'requests failed, slots rebuilt)', ('engine',)),
    # -- tiered prefix cache + disaggregated prefill/decode handoff
    #    (inference/kv_transfer.py + models/batching.py)
    'skypilot_serving_kv_spill_pages_total': (
        'counter', 'Prefix-cache pages spilled to the host-RAM tier '
                   'on pool-pressure eviction (payload + scales + '
                   'chain key) instead of being dropped', ('engine',)),
    'skypilot_serving_kv_restore_pages_total': (
        'counter', 'Spilled pages restored into the page pool on a '
                   'chain-key hit (bit-identical to the original '
                   'compute; the prefill those pages would have '
                   'cost was skipped)', ('engine',)),
    'skypilot_serving_kv_restore_hit_ratio': (
        'gauge', 'Spill-tier lookups that restored a page / all '
                 'spill-tier lookups (0..1; lookups happen only for '
                 'chain keys past the device-resident prefix)',
        ('engine',)),
    'skypilot_serving_kv_handoff_seconds': (
        'histogram', 'Wall time of one prefill->decode KV page-chain '
                     'handoff (export + POST /kv/import + decode-'
                     'side scatter), success or failure',
        (), {'buckets': REQUEST_BUCKETS}),
    'skypilot_serving_kv_handoff_bytes_total': (
        'counter', 'Packed KV chain bytes shipped to decode replicas '
                   'by this prefill replica', ()),
    # -- live KV-chain migration (models/batching.evacuate_chains +
    #    http_server /kv/evacuate + /kv/migrate)
    'skypilot_serving_migrations_total': (
        'counter', 'Sessions this replica migrated OUT to a peer '
                   '(chain shipped + tail proxied), by trigger: '
                   'drain (scale-down victim / SIGTERM), preempt '
                   '(preemption notice), rebalance (hot-spot '
                   'migration), or local_fallback (peer ship failed; '
                   'finished locally on the promoted warm pages)',
        ('reason',)),
    'skypilot_serving_chains_evacuated_total': (
        'counter', 'Active KV chains the engine evacuated (packed '
                   'committed-token pages + SessionMigratedError to '
                   'the owning HTTP thread); >= migrations_total '
                   'because failed ships fall back locally', ()),
    'skypilot_serving_migration_seconds': (
        'histogram', 'Wall time of one session migration: chain POST '
                     'to /kv/migrate through the peer\'s first '
                     'response byte (success or failure)',
        (), {'buckets': REQUEST_BUCKETS}),
    'skypilot_serving_tokens_recomputed_total': (
        'counter', 'Committed tokens a migrated-in session had to '
                   're-prefill on this replica (committed length '
                   'minus imported/cached full-page coverage): the '
                   'migration-vs-full-replay recompute cost, ~0 when '
                   'the chain shipped intact', ()),
    # -- multi-LoRA adapter registry (inference/adapters.py)
    'skypilot_serving_adapters_loaded': (
        'gauge', 'Adapters resident in the device store (loaded '
                 'stack rows, pinned or LRU-evictable)', ()),
    'skypilot_serving_adapter_requests_total': (
        'counter', 'Requests admitted per adapter (the `model` field '
                   'routed to a LoRA adapter)', ('adapter',)),
    'skypilot_serving_adapter_tokens_total': (
        'counter', 'Generated tokens committed per adapter',
        ('adapter',)),
    'skypilot_serving_adapter_loads_total': (
        'counter', 'Adapter artifacts loaded into the device store '
                   '(cold or re-load after eviction)', ('adapter',)),
    'skypilot_serving_adapter_evictions_total': (
        'counter', 'Unpinned adapters LRU-evicted from the device '
                   'store to make room for a load', ('adapter',)),
    'skypilot_serving_adapter_load_failures_total': (
        'counter', 'Adapter loads that failed (corrupt artifact, '
                   'rank/shape mismatch, or injected adapters.load '
                   'fault); the request fails 503, the engine keeps '
                   'serving', ()),
    # -- serving request path (inference/runtime.py + http_server.py)
    'skypilot_serving_requests_total': (
        'counter', 'Completed generation requests', ()),
    'skypilot_serving_prompt_tokens_total': (
        'counter', 'Prompt tokens across completed requests', ()),
    'skypilot_serving_completion_tokens_total': (
        'counter', 'Generated tokens across completed requests', ()),
    'skypilot_serving_ttft_seconds': (
        'histogram', 'Time to first token: first committed token for '
                     'engine-backed requests (streaming and not)',
        (), {'buckets': REQUEST_BUCKETS}),
    'skypilot_serving_inter_token_seconds': (
        'histogram', 'Gap between consecutive streamed tokens of one '
                     'request row', (),
        {'buckets': TOKEN_GAP_BUCKETS}),
    'skypilot_serving_e2e_latency_seconds': (
        'histogram', 'End-to-end request latency', (),
        {'buckets': REQUEST_BUCKETS}),
    'skypilot_serving_requests_shed_total': (
        'counter', 'Requests rejected 429 by admission control '
                   '(bounded queue full)', ()),
    'skypilot_serving_deadline_exceeded_total': (
        'counter', 'Requests answered 504: deadline expired while '
                   'queued or mid-decode', ()),
    # -- SLO / error-budget accounting (observability/slo.py; fed by
    #    http_server + LB per finished/shed request)
    'skypilot_serving_slo_target': (
        'gauge', 'Declared SLO target per dimension (p99_ttft_ms, '
                 'p99_itl_ms, error_rate, shed_rate) as passed to '
                 '--slo; absent dimensions are not promised',
        ('dimension',)),
    'skypilot_serving_slo_burn_rate': (
        'gauge', 'Error-budget burn rate per dimension and window: '
                 '(bad/total)/budget over the window, where budget '
                 'is the rate target itself or 1% for p99 latency '
                 'dimensions; 1.0 = consuming budget exactly at the '
                 'allowed pace', ('dimension', 'window')),
    'skypilot_serving_slo_budget_remaining': (
        'gauge', 'max(0, 1 - slow-window burn rate) per dimension: '
                 'the fraction of error budget left if the current '
                 'pace holds', ('dimension',)),
    'skypilot_serving_slo_bad_total': (
        'counter', 'Requests that violated an SLO dimension (errored, '
                   'shed, or over the latency target), cumulative '
                   'since process start', ('dimension',)),
    # -- replica plane (serve/replica_plane/: manager + LB front-end)
    'skypilot_lb_requests_routed_total': (
        'counter', 'Requests the replica-plane LB routed to a '
                   'replica, by load-balancing policy (retries count '
                   'once per attempt)', ('policy',)),
    'skypilot_lb_requests_retried_total': (
        'counter', 'Idempotent (not-yet-streamed) requests the LB '
                   'retried on another replica after a replica died '
                   'or refused, by policy', ('policy',)),
    'skypilot_lb_affinity_requests_total': (
        'counter', 'LB requests that carried a prefix-affinity '
                   'routing key (a full prompt page)', ()),
    'skypilot_lb_affinity_hits_total': (
        'counter', 'Keyed LB requests routed to their affinity '
                   'target (the replica already holding the prefix '
                   'KV pages); hits/requests is the affinity hit '
                   'ratio', ()),
    'skypilot_lb_ttft_seconds': (
        'histogram', 'LB-side time to first response byte, anchored '
                     'at the FIRST attempt (a retry after a replica '
                     'death still counts the dead attempt: this is '
                     'user-perceived TTFT)', (),
        {'buckets': REQUEST_BUCKETS}),
    'skypilot_lb_request_seconds': (
        'histogram', 'LB-side end-to-end proxy latency across all '
                     'retry attempts, anchored at the first attempt',
        (), {'buckets': REQUEST_BUCKETS}),
    'skypilot_replica_plane_replicas': (
        'gauge', 'Local serve_lm replicas managed by the replica '
                 'plane, by lifecycle state', ('state',)),
    'skypilot_replica_plane_scrape_errors_total': (
        'counter', 'Replica /stats-/readyz scrapes that failed '
                   '(replica dead, hung, or malformed response)', ()),
    # -- crash-only fleet controller (replica_plane/journal.py,
    #    fleet.py): restart adoption + tick-failure fuse
    'skypilot_fleet_adoptions_total': (
        'counter', 'Replicas a restarted fleet controller verified '
                   '(pid alive + /stats echoing the journaled '
                   'instance UUID) and reattached as live handles '
                   'instead of killing or orphaning them', ()),
    'skypilot_fleet_orphans_reaped_total': (
        'counter', 'Journaled replicas a restarted controller could '
                   'NOT verify (dead pid, unreachable port, or '
                   'instance-UUID mismatch from pid/port reuse) — '
                   'asked to drain via SIGTERM (never SIGKILL) and '
                   'dropped from the journal', ()),
    'skypilot_fleet_tick_errors_total': (
        'counter', 'Fleet-controller ticks that raised; 3 '
                   'consecutive failures flip the degraded gauge',
        ()),
    'skypilot_fleet_controller_degraded': (
        'gauge', '1 while the fleet controller has failed 3+ '
                 'consecutive ticks (replicas keep serving, but '
                 'scaling and routing updates are stalled); back to '
                 '0 on the first successful tick', ()),
    # -- checkpoint integrity (parallel/checkpoints.py + manifests)
    'skypilot_checkpoint_integrity_failures_total': (
        'counter', 'Checkpoint steps that failed sha256 manifest '
                   'verification at restore (torn/corrupt writes); '
                   'each one triggers fallback to the newest '
                   'verifying step', ()),
    # -- self-supervising trainer (robustness/train_guard.py; the
    #    controller-side increments live in jobs/controller.py when a
    #    typed trainer exit lands)
    'skypilot_train_preempt_notices_total': (
        'counter', 'Preemption notices observed (GCE metadata, '
                   'SIGTERM, or injected): each one is a graceful '
                   'checkpoint-now-then-exit the controller answers '
                   'with recovery instead of FAILED', ()),
    'skypilot_train_guard_skipped_steps_total': (
        'counter', 'Optimizer steps the on-device NaN/spike guard '
                   'skipped (non-finite loss/grad norm, or norm '
                   'above the EMA spike threshold); K consecutive '
                   'skips trigger rollback to the last verified '
                   'checkpoint', ()),
    'skypilot_train_watchdog_aborts_total': (
        'counter', 'Hung trainers the step watchdog aborted (stuck '
                   'collective or stalled data loader past the '
                   'per-phase deadline), with all thread stacks '
                   'dumped; the controller relaunches instead of '
                   'waiting forever', ()),
    # -- pipeline schedule + collective overlap (parallel/pipeline.py
    #    + recipes/train_lm.py)
    'skypilot_train_pipeline_bubble_fraction': (
        'gauge', 'Idle fraction of the active pipeline schedule '
                 '(bubble slots / stage-tick slots, '
                 '(S-1)/(M*v+S-1) for every style): drive it down '
                 'by raising microbatches (1f1b frees the '
                 'activation memory to do so) or virtual stages '
                 '(interleaved)', ()),
    'skypilot_train_collective_wait_seconds_total': (
        'counter', 'Host-observed drain wait at step-window '
                   'boundaries: the un-overlapped tail of the '
                   'device critical path (compute + serialized '
                   'collectives). --overlap should shrink it '
                   'run-over-run; the --profile trace names the '
                   'collectives in the gap', ()),
    # -- managed jobs (jobs/controller.py + recovery_strategy.py)
    'skypilot_jobs_recovery_attempts_total': (
        'counter', 'Managed-job recovery attempts (cluster lost or '
                   'reported failed), by recovery strategy',
        ('strategy',)),
    'skypilot_jobs_preemptions_total': (
        'counter', 'Managed-job cluster preemptions detected '
                   '(probes unreachable past the grace window, or '
                   'an external failure source), by zone the lost '
                   'cluster was placed in — a spiking zone label is '
                   'a spot storm', ('zone',)),
    'skypilot_jobs_relaunch_inflight': (
        'gauge', 'Cluster (re)launch attempts currently in flight '
                 'for managed jobs in this process (fleet-wide in '
                 'the fleet simulator; per-controller in '
                 'production) — the thundering-herd signal jittered '
                 'backoff keeps bounded', ()),
    # -- API server (server/server.py)
    'skypilot_api_requests_total': (
        'counter', 'API server HTTP requests', ('route', 'method',
                                                'code')),
    'skypilot_api_request_seconds': (
        'histogram', 'API server HTTP request latency',
        ('route', 'method'), {'buckets': STEP_BUCKETS}),
    'skypilot_api_requests_in_flight': (
        'gauge', 'API server HTTP requests currently being handled',
        ()),
    'skypilot_requests_total': (
        'gauge_as_counter', 'Async request records by status '
                            '(DB-derived at scrape)', ('status',)),
    'skypilot_clusters': (
        'gauge', 'Clusters by status', ('status',)),
    'skypilot_managed_jobs': (
        'gauge', 'Managed jobs by status', ('status',)),
    'skypilot_services': ('gauge', 'SkyServe services', ()),
    'skypilot_service_replicas_ready': (
        'gauge', 'Ready replicas across services', ()),
    'skypilot_server_rss_bytes': (
        'gauge', 'API server process RSS', ()),
    'skypilot_workers_rss_bytes': (
        'gauge', 'Combined RSS of API server child processes', ()),
    'skypilot_server_uptime_seconds': (
        'gauge', 'Seconds since the API server started', ()),
    'skypilot_scrape_errors_total': (
        'counter', 'Orchestration-gauge sections that failed to '
                   'collect (see server log)', ('section',)),
}

_KINDS = {'counter': m.Counter, 'gauge': m.Gauge,
          'histogram': m.Histogram, 'gauge_as_counter': m.Gauge}


def _create(name: str,
            registry: Optional[m.Registry] = None) -> m._Metric:
    spec = SPECS[name]
    kind, help_text, labelnames = spec[0], spec[1], spec[2]
    options = spec[3] if len(spec) > 3 else {}
    registry = registry or m.REGISTRY
    kwargs = dict(options)
    if kind == 'gauge_as_counter':
        kwargs['expose_type'] = 'counter'
    return registry.get_or_create(_KINDS[kind], name, help_text,
                                  labelnames, **kwargs)


def counter(name: str) -> m.Counter:
    return _create(name)


def gauge(name: str) -> m.Gauge:
    return _create(name)


def histogram(name: str) -> m.Histogram:
    return _create(name)


class EngineMetrics:
    """The continuous-batching engine's instrument bundle, one labeled
    child set per engine instance (label engine="0", "1", ...)."""

    def __init__(self, engine_label: str) -> None:
        lab = {'engine': engine_label}
        self._engine_label = engine_label
        self.queue_depth = gauge(
            'skypilot_serving_queue_depth').labels(**lab)
        self.active_slots = gauge(
            'skypilot_serving_active_slots').labels(**lab)
        self.num_slots = gauge(
            'skypilot_serving_num_slots').labels(**lab)
        self.admissions = counter(
            'skypilot_serving_admissions_total').labels(**lab)
        self.preemptions = counter(
            'skypilot_serving_preemptions_total').labels(**lab)
        self.decode_steps = counter(
            'skypilot_serving_decode_steps_total').labels(**lab)
        self.tokens_committed = counter(
            'skypilot_serving_tokens_committed_total').labels(**lab)
        self.decode_step_seconds = histogram(
            'skypilot_serving_decode_step_seconds').labels(**lab)
        self.prefill_seconds = histogram(
            'skypilot_serving_prefill_seconds').labels(**lab)
        self.prefill_chunk_seconds = histogram(
            'skypilot_serving_prefill_chunk_seconds').labels(**lab)
        self.prefill_backlog = gauge(
            'skypilot_serving_prefill_backlog_tokens').labels(**lab)
        self.prefill_budget_utilization = gauge(
            'skypilot_serving_prefill_budget_utilization').labels(
                **lab)
        self.decode_stall_seconds = counter(
            'skypilot_serving_decode_stall_seconds_total').labels(
                **lab)
        self.kv_pool_bytes = gauge(
            'skypilot_serving_kv_pool_bytes').labels(**lab)
        self.kv_pool_bytes_per_device = gauge(
            'skypilot_serving_kv_pool_bytes_per_device').labels(**lab)
        self.pipeline_stages = gauge(
            'skypilot_serving_pipeline_stages').labels(**lab)
        self.prefill_bubble_fraction = gauge(
            'skypilot_serving_prefill_bubble_fraction').labels(**lab)
        self.pages_free = gauge(
            'skypilot_serving_pages_free').labels(**lab)
        self.pages_used = gauge(
            'skypilot_serving_pages_used').labels(**lab)
        self.prefix_hits = counter(
            'skypilot_serving_prefix_cache_hits_total').labels(**lab)
        self.prefix_misses = counter(
            'skypilot_serving_prefix_cache_misses_total').labels(**lab)
        self.prefix_evictions = counter(
            'skypilot_serving_prefix_cache_evictions_total').labels(
                **lab)
        self.engine_restarts = counter(
            'skypilot_serving_engine_restarts_total').labels(**lab)
        self.kv_spill_pages = counter(
            'skypilot_serving_kv_spill_pages_total').labels(**lab)
        self.kv_restore_pages = counter(
            'skypilot_serving_kv_restore_pages_total').labels(**lab)
        self.kv_restore_hit_ratio = gauge(
            'skypilot_serving_kv_restore_hit_ratio').labels(**lab)
        self.attention_bytes_per_token = gauge(
            'skypilot_serving_attention_bytes_per_token').labels(**lab)

    def set_attention_info(self, impl: str, kv_dtype: str) -> None:
        """Info-style gauge (always 1): the resolved paged-attention
        impl and KV storage dtype ride the labels, so a dashboard can
        tell WHICH kernel path an engine is on without parsing logs."""
        gauge('skypilot_serving_attention_impl_info').labels(
            engine=self._engine_label, impl=impl,
            kv_dtype=kv_dtype).set(1)


class RequestMetrics:
    """The inference request path's instrument bundle (process-global,
    shared by every runtime in the process)."""

    def __init__(self) -> None:
        self.requests = counter('skypilot_serving_requests_total')
        self.prompt_tokens = counter(
            'skypilot_serving_prompt_tokens_total')
        self.completion_tokens = counter(
            'skypilot_serving_completion_tokens_total')
        self.ttft_seconds = histogram('skypilot_serving_ttft_seconds')
        self.inter_token_seconds = histogram(
            'skypilot_serving_inter_token_seconds')
        self.e2e_latency_seconds = histogram(
            'skypilot_serving_e2e_latency_seconds')
        self.requests_shed = counter(
            'skypilot_serving_requests_shed_total')
        self.deadline_exceeded = counter(
            'skypilot_serving_deadline_exceeded_total')


class FirstTokenLatch:
    """TTFT for non-streaming engine requests: passed as the engine's
    `on_token` callback, latches the wall-clock instant of the FIRST
    decode-step commit (streaming requests latch in their own
    StreamHandle). Thread-safe by construction: the latch is written
    only by the engine scheduler thread."""

    __slots__ = ('t0', 'first_token_s')

    def __init__(self) -> None:
        self.t0 = time.monotonic()
        self.first_token_s: Optional[float] = None

    def __call__(self, tok: int) -> None:
        del tok
        if self.first_token_s is None:
            self.first_token_s = time.monotonic() - self.t0
