"""Explicit pipeline schedules: the op stream GPipe/1F1B/interleaved
runners execute.

The port's own copy of skypilot_tpu/parallel/pipeline_schedule.py
(numpy only, copied whole so the port imports nothing of the JAX
package; tests/test_torch_pipeline_schedule.py holds it to the
original table by table). In the port the runner that reads these
tables is parallel/pipeline.py's tick loop, the same for every style,
and serving's prefill-bubble gauge (models/batching.py) reads
`make_inference_schedule`. The text below is the reference's.

`make_schedule(stages, microbatches, style, virtual_stages)` is a PURE
function of its four arguments: it emits the complete per-tick op
stream `[(tick, stage, microbatch, fwd|bwd)]` (plus the virtual-stage
index under interleaving) and every derived artifact the shard_map
runner in parallel/pipeline.py needs — dense [ticks, stages] lookup
tables, activation/cotangent buffer slot assignments, and receive-ring
geometry for the stage-to-stage ppermute links. No jax imports: the
schedule is host-side numpy, testable without devices, and the same
accounting (`bubble_fraction`, `peak_live_activations`) feeds the
step-metrics gauge, `bench.py --sweep-pipeline`, and the invariant
test battery.

Styles (S stages, M microbatches, v virtual stages per device; one op
— a chunk forward or a chunk backward — per device per tick):

  gpipe        fill/drain with a full flush between the phases: all
               forwards, then all backwards. Span 2(M + S - 1) ticks,
               per-device bubble 2(S - 1), but every stage holds all
               M in-flight activations at the flush.
  1f1b         PipeDream-flush one-forward-one-backward: backwards
               get priority and forward admission is capped at S
               in-flight microbatches, so peak live activations per
               stage drop from M to <= S. Same span and bubble count
               as gpipe — the schedule does not run faster at equal
               M, it runs at HIGHER M in the same memory, and that is
               what shrinks the bubble fraction (S-1)/(M+S-1).
  interleaved  1f1b over v virtual stages (layer chunks) per device:
               device s hosts chunks s, S+s, ..., (v-1)S+s (the
               Megatron interleaved-1F1B program; microbatches must
               divide into groups of S). Each device performs 2Mv
               (v-times smaller) ops, the span grows to
               2(Mv + S - 1) ticks but the bubble stays 2(S - 1)
               per device — the fraction (S-1)/(Mv+S-1) is the
               Megatron "bubble / v" — at the cost of holding up to
               2(S-1) + (v-1)S + 1 chunk inputs per device.

The closed forms asserted by tests/unit_tests/test_pipeline_schedule:
every style spans exactly 2(M*v + S - 1) ticks with exactly 2(S - 1)
bubble slots per device (so bubble fraction = (S-1)/(Mv+S-1), and the
styles differ in WHERE the slack goes: gpipe holds all M activations
at the flush, 1f1b caps them at min(M, S), interleaved divides the
fraction by v); peak live activations are exactly M (gpipe) and
min(M, S) (1f1b, stage 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

FWD = 1
BWD = 2

STYLES = ('gpipe', '1f1b', 'interleaved')


@dataclasses.dataclass(frozen=True)
class PipelineOp:
    """One scheduled op: device `stage` runs the forward or backward
    of `virtual` (the global virtual-stage index; == stage when
    virtual_stages == 1) for `microbatch` at `tick`."""
    tick: int
    stage: int
    microbatch: int
    virtual: int
    kind: int  # FWD | BWD

    @property
    def direction(self) -> str:
        return 'fwd' if self.kind == FWD else 'bwd'


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """The op stream plus the accounting and runner tables derived
    from it. Immutable; build with `make_schedule`."""
    stages: int
    microbatches: int
    style: str
    virtual_stages: int
    ops: Tuple[PipelineOp, ...]
    num_ticks: int
    # Dense runner tables, all [num_ticks, stages] int32 unless noted.
    tables: Dict[str, np.ndarray]
    # Peak concurrently-stored chunk inputs, per device.
    live_peak_per_stage: Tuple[int, ...]
    # Receive-ring depths for the fwd/bwd ppermute links.
    rx_fwd_depth: int
    rx_bwd_depth: int
    # Cotangent buffer depth (last-virtual-stage loss grads).
    gy_depth: int

    # -- accounting --------------------------------------------------
    @property
    def total_slots(self) -> int:
        return self.num_ticks * self.stages

    @property
    def busy_slots(self) -> int:
        return len(self.ops)

    @property
    def bubble_slots(self) -> int:
        """Idle (tick, stage) slots over the whole schedule."""
        return self.total_slots - self.busy_slots

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_slots / self.total_slots

    @property
    def peak_live_activations(self) -> int:
        """Max chunk inputs any device stores at once — the schedule's
        activation-memory height in units of one [mb, seq, embed]
        buffer (chunk inputs are full residual width regardless of
        how many layers the chunk holds)."""
        return max(self.live_peak_per_stage)

    def activation_bytes(self, microbatch_tokens: int, embed_dim: int,
                         bytes_per_el: int = 2) -> int:
        """Activation-buffer memory proxy for one device: stored chunk
        inputs only (layer-internal activations are rematerialized by
        the runner's backward)."""
        return (self.peak_live_activations * microbatch_tokens *
                embed_dim * bytes_per_el)

    def describe(self) -> str:
        return (f'{self.style}(S={self.stages}, M={self.microbatches}'
                f', v={self.virtual_stages}): {self.num_ticks} ticks, '
                f'bubble {self.bubble_slots}/{self.total_slots} '
                f'({self.bubble_fraction:.1%}), peak live acts '
                f'{self.peak_live_activations}')


def _device_sequence(rank: int, stages: int, microbatches: int,
                     style: str, virtual_stages: int
                     ) -> List[Tuple[int, int, int]]:
    """Device `rank`'s op program as an ordered list of
    (kind, virtual, microbatch) — the per-rank recipe, before timing.

      gpipe        all forwards (microbatch order), then all
                   backwards: the fill/drain flush.
      1f1b         PipeDream-flush: S-rank-1 warmup forwards, then
                   strict fwd/bwd alternation, then the backward
                   drain.
      interleaved  the Megatron interleaved-1F1B program: microbatch
                   groups of size S cycle through the device's v
                   chunks (forwards deepest-last, backwards
                   deepest-first), warmup 2(S-rank-1) + (v-1)S
                   chunk-forwards deep.
    """
    S, M, v = stages, microbatches, virtual_stages
    total_f = M * v

    if v == 1:
        def fwd_of(i):
            return rank, i

        def bwd_of(j):
            return rank, j
        warmup = total_f if style == 'gpipe' else min(S - rank - 1,
                                                      total_f)
    else:
        def fwd_of(i):
            group, w = divmod(i, S * v)
            return (w // S) * S + rank, group * S + w % S

        def bwd_of(j):
            group, w = divmod(j, S * v)
            return (v - 1 - w // S) * S + rank, group * S + w % S
        warmup = min(2 * (S - rank - 1) + (v - 1) * S, total_f)

    seq: List[Tuple[int, int, int]] = []
    fi = bi = 0
    for _ in range(warmup):
        seq.append((FWD,) + fwd_of(fi))
        fi += 1
    while fi < total_f:
        seq.append((FWD,) + fwd_of(fi))
        fi += 1
        seq.append((BWD,) + bwd_of(bi))
        bi += 1
    while bi < total_f:
        seq.append((BWD,) + bwd_of(bi))
        bi += 1
    return seq


def _schedule_ops(stages: int, microbatches: int, style: str,
                  virtual_stages: int) -> List[PipelineOp]:
    """Lockstep timing for the per-device programs: each tick, every
    device attempts the NEXT op of its sequence and stalls (a bubble
    tick) until the op's inputs exist.

    Dependency rules — completions land at END of tick, so a
    dependency satisfied at tick t unblocks from t+1 (the ppermute
    hand-off takes the tick boundary): fwd(vs, m) needs
    fwd(vs-1, m); bwd(vs, m) needs fwd(vs, m) (whose tick also
    produced the loss cotangent when vs is last) and bwd(vs+1, m).
    """
    S, M, v = stages, microbatches, virtual_stages
    V = S * v
    seqs = [_device_sequence(r, S, M, style, v) for r in range(S)]
    ptr = [0] * S
    fwd_done: Dict[Tuple[int, int], int] = {}
    bwd_done: Dict[Tuple[int, int], int] = {}
    ops: List[PipelineOp] = []
    total = 2 * V * M
    t = 0
    # The per-rank programs are deadlock-free by construction; a bug
    # must fail loudly, not spin.
    max_ticks = 4 * (V * M + V + M + 8)
    while len(ops) < total:
        if t > max_ticks:
            raise RuntimeError(
                f'schedule generation did not converge: {style} S={S} '
                f'M={M} v={v} stuck at tick {t}')
        fired = []
        for r in range(S):
            if ptr[r] >= len(seqs[r]):
                continue
            kind, vs, m = seqs[r][ptr[r]]
            if kind == FWD:
                ready = vs == 0 or fwd_done.get((vs - 1, m), t) < t
            else:
                ready = fwd_done.get((vs, m), t) < t and (
                    vs == V - 1 or bwd_done.get((vs + 1, m), t) < t)
            if ready:
                fired.append((r, kind, vs, m))
                ptr[r] += 1
        for r, kind, vs, m in fired:
            (fwd_done if kind == FWD else bwd_done)[(vs, m)] = t
            ops.append(PipelineOp(t, r, m, vs, kind))
        t += 1
    return ops


def _assign_slots(events: List[Tuple[int, int, str, int]],
                  label: str) -> Tuple[Dict[Tuple[int, int], int], int]:
    """Free-list slot assignment for (write tick, read tick) pairs.

    events: (write_tick, read_tick, key...) sorted by write tick; a
    slot is busy from its write until its read (inclusive). Returns
    ({key: slot}, depth)."""
    free: List[int] = []
    next_slot = 0
    release_at: Dict[int, List[int]] = {}
    slots: Dict[Tuple[int, int], int] = {}
    for wt, rt, *key in sorted(events):
        for old in sorted(release_at.pop(wt, []) + []):
            free.append(old)
        # Also release anything whose read tick passed before wt.
        for rel_t in [k for k in release_at if k < wt]:
            free.extend(release_at.pop(rel_t))
        slot = free.pop(0) if free else next_slot
        if slot == next_slot:
            next_slot += 1
        slots[tuple(key)] = slot
        release_at.setdefault(rt + 1, []).append(slot)
    if next_slot == 0:
        next_slot = 1  # runners always carry a non-empty buffer
    return slots, next_slot


def make_schedule(stages: int, microbatches: int, style: str = 'gpipe',
                  virtual_stages: int = 1) -> PipelineSchedule:
    """Build the explicit schedule. Pure: same args, same stream."""
    if style not in STYLES:
        raise ValueError(f'style must be one of {STYLES}; got {style!r}')
    if stages < 2:
        raise ValueError(f'pipeline schedules need >= 2 stages; got '
                         f'{stages}')
    if microbatches < 1:
        raise ValueError('microbatches must be >= 1')
    if style == 'interleaved':
        if virtual_stages < 2:
            raise ValueError('interleaved needs virtual_stages >= 2')
        if microbatches % stages:
            raise ValueError(
                f'interleaved cycles microbatch groups of size '
                f'stages={stages} through the virtual chunks; '
                f'microbatches={microbatches} must be a multiple')
    elif virtual_stages != 1:
        raise ValueError(f'{style} runs with virtual_stages == 1 '
                         f'(got {virtual_stages}); pick interleaved '
                         f'for virtual-stage chunking')
    S, M, v = stages, microbatches, virtual_stages
    V = S * v
    ops = _schedule_ops(S, M, style, v)
    T = max(op.tick for op in ops) + 1

    # Index ops for table construction + validation.
    fwd_tick = {}
    bwd_tick = {}
    by_slot: Dict[Tuple[int, int], PipelineOp] = {}
    for op in ops:
        key = (op.tick, op.stage)
        if key in by_slot:
            raise AssertionError(
                f'two ops on stage {op.stage} at tick {op.tick}')
        by_slot[key] = op
        if op.kind == FWD:
            fwd_tick[(op.virtual, op.microbatch)] = op.tick
        else:
            bwd_tick[(op.virtual, op.microbatch)] = op.tick

    # -- activation slots (per device): a chunk input is stored at its
    # fwd tick and read back at its bwd tick.
    act_slots: Dict[int, Dict[Tuple[int, int], int]] = {}
    live_peak = []
    act_depth = 1
    for s in range(S):
        events = []
        for k in range(v):
            vs = k * S + s
            for m in range(M):
                events.append((fwd_tick[(vs, m)], bwd_tick[(vs, m)],
                               vs, m))
        slots, depth = _assign_slots(events, f'act[stage {s}]')
        act_slots[s] = slots
        act_depth = max(act_depth, depth)
        live_peak.append(depth)

    # -- loss-cotangent slots: gy for (V-1, m) is produced at the fwd
    # tick of the last virtual stage and consumed at its bwd tick.
    gy_events = [(fwd_tick[(V - 1, m)], bwd_tick[(V - 1, m)], m)
                 for m in range(M)]
    gy_slots, gy_depth = _assign_slots(gy_events, 'gy')

    # -- receive rings. A fwd message for (vs, m), vs in [1, V), is
    # produced at fwd_tick[vs-1, m] on device (vs-1) % S and consumed
    # at fwd_tick[vs, m] on device vs % S; bwd messages mirror it.
    rxf_events = [(fwd_tick[(vs - 1, m)], fwd_tick[(vs, m)], vs, m)
                  for vs in range(1, V) for m in range(M)]
    rxb_events = [(bwd_tick[(vs + 1, m)], bwd_tick[(vs, m)], vs, m)
                  for vs in range(V - 1) for m in range(M)]
    # Ring depth must be uniform across devices (SPMD buffer), so
    # assign per consuming device but take the max depth.
    rxf_slots: Dict[Tuple[int, int], int] = {}
    rxf_depth = 1
    for s in range(S):
        ev = [e for e in rxf_events if e[2] % S == s]
        slots, depth = _assign_slots(ev, f'rxf[{s}]')
        rxf_slots.update(slots)
        rxf_depth = max(rxf_depth, depth)
    rxb_slots: Dict[Tuple[int, int], int] = {}
    rxb_depth = 1
    for s in range(S):
        ev = [e for e in rxb_events if e[2] % S == s]
        slots, depth = _assign_slots(ev, f'rxb[{s}]')
        rxb_slots.update(slots)
        rxb_depth = max(rxb_depth, depth)

    # -- dense runner tables ----------------------------------------
    z = lambda: np.full((T, S), -1, dtype=np.int32)  # noqa: E731
    tables = {
        'op_kind': np.zeros((T, S), dtype=np.int32),
        'op_mb': z(), 'op_chunk': z(), 'op_virtual': z(),
        'act_slot': z(),
        # fwd-message routing: slot the PRODUCER's output is written
        # to on the consumer (indexed by producer tick/stage), and the
        # slot a consuming fwd op reads (indexed by consumer).
        'rxf_wslot': z(), 'rxf_rslot': z(),
        'rxb_wslot': z(), 'rxb_rslot': z(),
    }
    # Per-tick scalars (int32 [T]).
    embed_mb = np.full((T,), -1, dtype=np.int32)   # fwd of virtual 0
    gy_mb = np.full((T,), -1, dtype=np.int32)      # fwd of virtual V-1
    gy_wslot = np.full((T,), -1, dtype=np.int32)
    gy_rslot = np.full((T,), -1, dtype=np.int32)
    embv_mb = np.full((T,), -1, dtype=np.int32)    # bwd of virtual 0

    for op in ops:
        t, s, m, vs = op.tick, op.stage, op.microbatch, op.virtual
        tables['op_kind'][t, s] = op.kind
        tables['op_mb'][t, s] = m
        tables['op_chunk'][t, s] = vs // S
        tables['op_virtual'][t, s] = vs
        tables['act_slot'][t, s] = act_slots[s][(vs, m)]
        if op.kind == FWD:
            if vs == 0:
                embed_mb[t] = m
            if vs == V - 1:
                gy_mb[t] = m
                gy_wslot[t] = gy_slots[(m,)]
            else:
                # This output travels the fwd ring to device (s+1)%S.
                tables['rxf_wslot'][t, s] = rxf_slots[(vs + 1, m)]
            if vs > 0:
                tables['rxf_rslot'][t, s] = rxf_slots[(vs, m)]
        else:
            if vs == V - 1:
                gy_rslot[t] = gy_slots[(m,)]
            else:
                tables['rxb_rslot'][t, s] = rxb_slots[(vs, m)]
            if vs == 0:
                embv_mb[t] = m
            else:
                tables['rxb_wslot'][t, s] = rxb_slots[(vs - 1, m)]
    tables['embed_mb'] = embed_mb
    tables['gy_mb'] = gy_mb
    tables['gy_wslot'] = gy_wslot
    tables['gy_rslot'] = gy_rslot
    tables['embv_mb'] = embv_mb

    sched = PipelineSchedule(
        stages=S, microbatches=M, style=style, virtual_stages=v,
        ops=tuple(ops), num_ticks=T, tables=tables,
        live_peak_per_stage=tuple(live_peak),
        rx_fwd_depth=rxf_depth, rx_bwd_depth=rxb_depth,
        gy_depth=gy_depth)
    _validate(sched, fwd_tick, bwd_tick)
    return sched


def _validate(sched: PipelineSchedule, fwd_tick: Dict, bwd_tick: Dict
              ) -> None:
    """Structural invariants every emitted schedule must satisfy (the
    test battery re-asserts these from the public op stream)."""
    S, M, V = (sched.stages, sched.microbatches,
               sched.stages * sched.virtual_stages)
    assert len(sched.ops) == 2 * V * M, 'op count'
    for vs in range(V):
        for m in range(M):
            f, b = fwd_tick[(vs, m)], bwd_tick[(vs, m)]
            assert f >= 0 and b >= 0, (vs, m)
            assert f < b or (vs == V - 1 and f < b), \
                f'bwd before fwd at vs={vs} m={m}'
            if vs > 0:
                assert fwd_tick[(vs - 1, m)] < f, 'fwd chain order'
            if vs < V - 1:
                assert bwd_tick[(vs + 1, m)] < b, 'bwd chain order'


# -- Inference (serving) schedules: forward-only ---------------------------
@dataclasses.dataclass(frozen=True)
class InferenceSchedule:
    """The forward-only op stream of staged serving: no backwards, no
    flush, no activation stash — a microbatch (one prefill chunk in
    the serving engine; the chunked-prefill fixed-shape chunk IS the
    natural microbatch) enters stage 0 and ripples through the S
    stages, one stage per tick. Span is M + S - 1 ticks and the only
    idle slots are the fill/drain triangles: bubble fraction
    (S - 1)·S / ((M + S - 1)·S) = (S - 1)/(M + S - 1) — half the
    training closed form because there is no backward wave. Build
    with `make_inference_schedule`; the engine's prefill-bubble gauge
    and serve_bench's `--pp-ab` report read `bubble_fraction` from
    here rather than re-deriving it."""
    stages: int
    microbatches: int
    ops: Tuple[PipelineOp, ...]
    num_ticks: int

    @property
    def total_slots(self) -> int:
        return self.num_ticks * self.stages

    @property
    def busy_slots(self) -> int:
        return len(self.ops)

    @property
    def bubble_slots(self) -> int:
        return self.total_slots - self.busy_slots

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_slots / self.total_slots

    def describe(self) -> str:
        return (f'inference(S={self.stages}, M={self.microbatches}): '
                f'{self.num_ticks} ticks, bubble '
                f'{self.bubble_slots}/{self.total_slots} '
                f'({self.bubble_fraction:.1%})')


def make_inference_schedule(stages: int,
                            microbatches: int) -> InferenceSchedule:
    """Forward-only schedule: microbatch m runs on stage s at tick
    m + s. Pure; allows stages == 1 (span M, zero bubble) so the
    engine's accounting degenerates cleanly for unstaged serving."""
    if stages < 1:
        raise ValueError(f'stages must be >= 1; got {stages}')
    if microbatches < 1:
        raise ValueError('microbatches must be >= 1')
    ops = tuple(PipelineOp(m + s, s, m, s, FWD)
                for m in range(microbatches) for s in range(stages))
    sched = InferenceSchedule(stages=stages, microbatches=microbatches,
                              ops=ops,
                              num_ticks=microbatches + stages - 1)
    assert sched.num_ticks == closed_form_inference_span(
        stages, microbatches), 'inference span'
    return sched


def closed_form_inference_span(stages: int, microbatches: int) -> int:
    """Analytic tick count of the forward-only stream: M + S - 1
    (bubble fraction (S - 1)/(M + S - 1))."""
    return microbatches + stages - 1


def closed_form_span(stages: int, microbatches: int, style: str,
                     virtual_stages: int = 1) -> int:
    """Analytic tick count: every style spans exactly
    2(M * v + S - 1) — M*v ops per device plus the 2(S-1)-tick
    fill/drain skew. Per-device bubble is always 2(S - 1) ticks; the
    styles trade WHERE the memory goes, and interleaving divides the
    bubble FRACTION by v by making each tick v-times smaller."""
    del style  # same span for gpipe / 1f1b / interleaved
    return 2 * (microbatches * virtual_stages + stages - 1)
