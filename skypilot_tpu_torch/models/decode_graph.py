"""A decode round on static buffers, replayed as one captured CUDA graph
(the port's counterpart of the reference engine's jitted decode function,
skypilot_tpu/models/batching.py:980-1007, and of its `--decode-chunk`
`lax.scan`, :1009-1046).

`DecodeRound` owns the round's device buffers, laid out once:

  packed    int32 [7B + 1 + B*P], filled by ONE non-blocking copy from
            pinned host staging per dispatch: the host's token and
            position per lane, the pipelined continue-mask, the adapter
            id, top-k, temperature and top-p (f32 bits), the chunk step
            counter, and the page table [B, P] (P = 0 on the engine's
            dense path: the model's dense cache, one row a lane, takes
            no page table);
  last_tok, last_pos   int32 [B]: the tokens the previous step sampled
            and the positions it ran at, written on the device;
  out       int32 [max_steps, B]: step i of a dispatch writes row i.

`step` is the round: its prologue takes each lane's token and position
from the previous step (`cont` lanes: the token it sampled, at position
+1) or from the host, it runs the model's `hidden` in decode mode over the
paged pool or the dense rows, selects the next tokens (greedy, sampled, or sampled with
the top-k / top-p filter), and its epilogue writes them into `out`,
feeds them back (token, position, cont = 1) and advances the step
counter. So the pipelined loop dispatches round N+1 before it has
fetched round N, and `--decode-chunk N` is N steps with no host work
between them, then one fetch of `out[:N]`.

On the card each variant (base or LoRA, times the three selections)
is captured once into a `torch.cuda.CUDAGraph` and every step is one
replay; on the CPU, or with graphs turned off, `step` runs eagerly on
the same buffers, so the CPU tests exercise the data flow the card
replays. A capture that fails raises; nothing falls back to eager
rounds.

Kernel launch counts (ops/paged_kernel.py, ops/lora_kernel.py,
ops/int8_linear.py, ops/grid_collective.py, the last also by card) and
a grid's count of all-reduces are Python increments that a replay does
not run: each variant keeps the counts its capture made and adds them
at every replay.

A grid model (parallel/serving.py) keeps the static buffers once for
every grid place (stage, rank) on its device: the host stages the packed
buffer to each place before a dispatch, each place computes its own
tokens and positions, and the round reads them through
`GridModel.round_logits`, so no `Tensor.to` crosses cards inside it.
The sampled tokens reach the other stage-0 shards through the grid's
broadcast, the stage hand-offs and the head's gather through its other
collectives (ops/grid_collective.py: on the card a kernel that trades
parts over NVLink, with flags in device memory). On the card each
variant is one CUDA graph a distinct card, captured together from this
thread (each card's work on a side stream of that card, its memory from
that card's pool), and a round replays every card's graph in the grid's
order; the collectives inside them wait for each other on the cards, so
nothing on the host sits between two cards' replays. One card named N
times is one graph.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.generate import sample_tokens
from skypilot_tpu_torch.ops import (grid_collective, int8_linear,
                                    lora_kernel, paged_kernel)
from skypilot_tpu_torch.parallel.serving import Placed

#: How a round picks its tokens: argmax everywhere; a draw where a
#: lane's temperature is > 0; the same after the top-k / top-p filter.
SELECTIONS = ('greedy', 'sample', 'filter')

# Lane fields of `packed`, in order (B entries each); then `step` (1),
# then the page table (B * P).
_FIELDS = ('tok', 'pos', 'cont', 'ids', 'top_k', 'temp', 'top_p')
_FLOAT_FIELDS = ('temp', 'top_p')


def select_tokens(logits: torch.Tensor, selection: str, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """int32 tokens [...] from logits [..., V] by `selection` (one of
    SELECTIONS; the host picks it from its copy of the lanes'
    settings, so nothing here syncs)."""
    if selection == 'greedy':
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_tokens(logits, temps, top_ks, top_ps, generator,
                         apply_filter=selection == 'filter')


def selection_for(temps: np.ndarray, top_ks: np.ndarray,
                  top_ps: np.ndarray) -> str:
    """The selection a round over lanes with these host settings needs."""
    if not (temps > 0).any():
        return 'greedy'
    if ((top_ks > 0) | (top_ps < 1.0)).any():
        return 'filter'
    return 'sample'


def _kernel_counts() -> Dict[Tuple, int]:
    """Every launch and plain-call counter of the decode path's kernels."""
    counts = {('paged', 'launches'): paged_kernel.launches,
              ('paged', 'plain_calls'): paged_kernel.plain_calls,
              ('lora', 'launches'): lora_kernel.launches,
              ('lora', 'plain_calls'): lora_kernel.plain_calls,
              ('int8', 'launches'): int8_linear.launches,
              ('int8', 'plain_calls'): int8_linear.plain_calls,
              ('grid', 'launches'): grid_collective.launches,
              ('grid', 'plain_calls'): grid_collective.plain_calls}
    counts.update({('route', r): n
                   for r, n in paged_kernel.route_launches.items()})
    counts.update({('shape', k): n
                   for k, n in paged_kernel.shape_launches.items()})
    counts.update({('int8_rows', m): n
                   for m, n in int8_linear.launches_by_rows.items()})
    counts.update({('int8_shape', nk): n
                   for nk, n in int8_linear.launches_by_shape.items()})
    counts.update({('int8_route', r): n
                   for r, n in int8_linear.launches_by_route.items()})
    counts.update({('grid_op', op): n
                   for op, n in grid_collective.launches_by_op.items()})
    counts.update({('grid_device', d): n
                   for d, n in grid_collective.launches_by_device.items()})
    counts.update({('grid_size', k): n
                   for k, n in grid_collective.launches_by_size.items()})
    return counts


def _count_delta(after: Dict[Tuple, int],
                 before: Dict[Tuple, int]) -> Dict[Tuple, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _add_kernel_counts(delta: Dict[Tuple, int], sign: int = 1) -> None:
    for (kind, name), d in delta.items():
        d *= sign
        if kind == 'paged':
            setattr(paged_kernel, name, getattr(paged_kernel, name) + d)
        elif kind == 'lora':
            setattr(lora_kernel, name, getattr(lora_kernel, name) + d)
        elif kind == 'int8':
            setattr(int8_linear, name, getattr(int8_linear, name) + d)
        elif kind == 'grid':
            setattr(grid_collective, name,
                    getattr(grid_collective, name) + d)
        elif kind == 'grid_op':
            grid_collective.launches_by_op[name] += d
        elif kind == 'grid_device':
            grid_collective.launches_by_device[name] += d
        elif kind == 'grid_size':
            grid_collective.launches_by_size[name] += d
        elif kind == 'route':
            paged_kernel.route_launches[name] += d
        elif kind == 'int8_rows':
            int8_linear.launches_by_rows[name] += d
        elif kind == 'int8_shape':
            int8_linear.launches_by_shape[name] += d
        elif kind == 'int8_route':
            int8_linear.launches_by_route[name] += d
        else:
            paged_kernel.shape_launches[name] += d


class Pending:
    """A dispatched round's tokens on their way to the host: `steps`
    rows of the pinned buffer, ready once `event` has fired."""

    def __init__(self, host: torch.Tensor, steps: int,
                 event: Optional[torch.cuda.Event]) -> None:
        self.host = host
        self.steps = steps
        self.event = event

    def wait(self) -> np.ndarray:
        """int32 [steps, B], copied out of the pinned buffer (which a
        later dispatch reuses)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host[:self.steps].numpy().copy()


class DecodeRound:
    """Static buffers, the round function and its captured graphs for
    one engine (see module doc). `pages_per_seq` 0 is the dense
    variant. `use_graphs` is honoured on CUDA only; on the CPU every
    step runs eagerly."""

    def __init__(self, model, cache, num_slots: int, pages_per_seq: int,
                 max_steps: int, generator: torch.Generator,
                 use_graphs: bool, attend_len: Optional[int] = None
                 ) -> None:
        self.model = model
        self.attend_len = attend_len
        self.cache = cache
        self.device = model.device
        self.generator = generator
        self.num_slots = num_slots
        self.max_steps = max_steps
        self.paged = pages_per_seq > 0
        grid = self.grid = getattr(model, 'grid', None)
        #: The places whose static inputs this round keeps: every (stage,
        #: rank) of a grid, the first on `device`; else the one device.
        self.places: List[Optional[Tuple[int, int]]] = (
            [(s, t) for s in range(grid.stages) for t in range(grid.tensor)]
            if grid is not None else [None])
        #: The distinct devices the round runs on, `device` first: one
        #: graph each.
        self.cards = grid.cards() if grid is not None else [self.device]
        self.use_graphs = bool(use_graphs) and self.device.type == 'cuda'
        b = num_slots
        self._offsets = {name: i * b for i, name in enumerate(_FIELDS)}
        self._step_at = len(_FIELDS) * b
        self._table_at = self._step_at + 1
        size = self._table_at + b * pages_per_seq
        pin = self.device.type == 'cuda'
        self._bufs: Dict[Optional[Tuple[int, int]], Dict[str, object]] = {}
        for place in self.places:
            dev = (self.device if place is None
                   else grid.devices[place[0]][place[1]])
            packed = torch.zeros(size, dtype=torch.int32, device=dev)
            # Device views of `packed` (what the round function reads).
            view = {name: self._field(packed, name) for name in _FIELDS}
            view['step'] = packed[self._step_at:self._step_at + 1]
            view['table'] = packed[self._table_at:].view(b, pages_per_seq)
            self._bufs[place] = {
                'packed': packed, 'view': view,
                'last_tok': torch.zeros(b, dtype=torch.int32, device=dev),
                'last_pos': torch.zeros(b, dtype=torch.int32, device=dev)}
        first = self._bufs[self.places[0]]
        self.packed = first['packed']
        self.view = first['view']
        self.last_tok = first['last_tok']
        self.last_pos = first['last_pos']
        self.out = torch.zeros((max_steps, b), dtype=torch.int32,
                               device=self.device)
        # Two of each pinned buffer, alternating by dispatch: a round's
        # staging is not rewritten, nor its tokens overwritten, until the
        # round after next, by which time the engine has fetched it.
        self._staging = [torch.zeros(size, dtype=torch.int32,
                                     pin_memory=pin) for _ in range(2)]
        self._fetched = [torch.zeros((max_steps, b), dtype=torch.int32,
                                     pin_memory=pin) for _ in range(2)]
        self._parity = 0
        self._graphs: Dict[Tuple[bool, str],
                           Tuple[List[object], Dict[Tuple, int]]] = {}
        self._pools = ({d: torch.cuda.graph_pool_handle()
                        for d in self.cards} if self.use_graphs else {})
        #: Graph replays so far (every step on the card with graphs on; a
        #: step over N cards replays N graphs and counts one).
        self.replays = 0

    def _field(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        at = self._offsets[name]
        t = buf[at:at + self.num_slots]
        return t.view(torch.float32) if name in _FLOAT_FIELDS else t

    # -- the round ----------------------------------------------------------
    def step(self, selection: str, lora: Optional[dict]) -> None:
        """One decode step on the static buffers (what a graph captures)."""
        if self.grid is not None:
            self._grid_step(selection, lora)
            return
        v = self.view
        cont = v['cont'] != 0
        tok = torch.where(cont, self.last_tok, v['tok'])
        pos = torch.where(cont, self.last_pos + 1, v['pos'])
        kw = ({'lora': lora, 'adapter_ids': v['ids']} if lora is not None
              else {})
        hidden = self.model.hidden(tok[:, None].long(), pos[:, None],
                                   self.cache,
                                   v['table'] if self.paged else None,
                                   attend_len=self.attend_len, **kw)
        logits = self.model.logits(hidden[:, 0])
        self._epilogue(selection, logits, pos)

    def _epilogue(self, selection: str, logits: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
        """Select the tokens on `device`, write them into `out` and feed
        them back (the first place's buffers)."""
        v = self.view
        out = select_tokens(logits, selection, v['temp'], v['top_k'],
                            v['top_p'], self.generator)
        self.last_tok.copy_(out)
        self.last_pos.copy_(pos)
        v['cont'].fill_(1)
        self.out.index_copy_(0, v['step'].long(), out[None])
        v['step'].add_(1)
        return out

    def _grid_step(self, selection: str, lora: Optional[dict]) -> None:
        """The round over a grid: every place takes its token and position
        from its own buffers; the sampled tokens reach the other stage-0
        places through the grid's broadcast."""
        toks, poss = {}, {}
        for place in self.places:
            buf = self._bufs[place]
            v = buf['view']
            cont = v['cont'] != 0
            poss[place] = torch.where(cont, buf['last_pos'] + 1, v['pos'])
            if place[0] == 0:
                toks[place] = torch.where(cont, buf['last_tok'],
                                          v['tok'])[:, None].long()

        def placed(name):
            return Placed({p: self._bufs[p]['view'][name]
                           for p in self.places})

        kw = ({'lora': lora, 'adapter_ids': placed('ids')}
              if lora is not None else {})
        logits = self.model.round_logits(
            Placed(toks), Placed({p: q[:, None] for p, q in poss.items()}),
            self.cache, placed('table') if self.paged else None,
            attend_len=self.attend_len, **kw)
        first = self.places[0]
        out = self._epilogue(selection, logits, poss[first])
        fed = self.grid.broadcast(out, 0)
        for place in self.places[1:]:
            buf = self._bufs[place]
            if place[0] == 0:
                buf['last_tok'].copy_(fed[place[1]])
            buf['last_pos'].copy_(poss[place])
            buf['view']['cont'].fill_(1)

    # -- host side ----------------------------------------------------------
    def dispatch(self, *, tok: np.ndarray, pos: np.ndarray,
                 cont: np.ndarray, ids: np.ndarray, top_k: np.ndarray,
                 temp: np.ndarray, top_p: np.ndarray, table: np.ndarray,
                 selection: str, lora: Optional[dict],
                 steps: int = 1) -> Pending:
        """Stage the inputs (one non-blocking copy a place), run `steps`
        steps (graph replays, or eager steps), and start the copy of
        `out[:steps]` to pinned memory. Returns without waiting."""
        if not 1 <= steps <= self.max_steps:
            raise ValueError(f'steps={steps} outside 1..{self.max_steps}')
        p = self._parity
        self._parity ^= 1
        staging = self._staging[p]
        for name, src in (('tok', tok), ('pos', pos), ('cont', cont),
                          ('ids', ids), ('top_k', top_k), ('temp', temp),
                          ('top_p', top_p)):
            self._field(staging, name).numpy()[:] = src
        staging[self._step_at] = 0
        staging[self._table_at:].numpy()[:] = table.reshape(-1)
        for buf in self._bufs.values():
            buf['packed'].copy_(staging, non_blocking=True)
        if self.use_graphs:
            graphs, counts = self._graph(selection, lora)
            with self._lock():
                for _ in range(steps):
                    for graph in graphs:
                        graph.replay()
                    self._add_counts(counts)
            self.replays += steps
        else:
            for _ in range(steps):
                self.step(selection, lora)
        host = self._fetched[p]
        host[:steps].copy_(self.out[:steps], non_blocking=True)
        event = None
        if self.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
        return Pending(host, steps, event)

    # -- capture ------------------------------------------------------------
    def capture(self, selection: str, lora: Optional[dict]) -> None:
        """Capture the variant now (the engine does the base variants at
        startup, so a capture that fails stops the server before it
        serves)."""
        self._graph(selection, lora)

    def _graph(self, selection: str, lora: Optional[dict]):
        key = (lora is not None, selection)
        entry = self._graphs.get(key)
        if entry is None:
            try:
                with self._lock():
                    entry = self._capture(selection, lora)
            except Exception as e:
                raise RuntimeError(
                    f'CUDA-graph capture of the decode round (lora='
                    f'{key[0]}, {selection}, over '
                    f'{[str(d) for d in self.cards]}) failed: '
                    f'{type(e).__name__}: {e}') from e
            self._graphs[key] = entry
        return entry

    def _lock(self):
        """The grid's lock (parallel/serving.py `Grid.lock`): held over a
        capture, whose warm-up runs the collectives on side streams, and
        over a round's replays, so no other thread's work on these cards
        lands among them."""
        return (self.grid.lock if self.grid is not None
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def _on_streams(self, streams: Dict[torch.device, torch.cuda.Stream]):
        """Every card's current stream set to its stream of `streams`."""
        with contextlib.ExitStack() as stack:
            for d in self.cards:
                stack.enter_context(torch.cuda.stream(streams[d]))
            yield

    def _capture(self, selection: str, lora: Optional[dict]):
        """Warm the variant up eagerly (every kernel and library loaded
        outside the capture) on zeroed inputs, so its KV writes land in
        the trash page, then capture it: one graph a card, all begun
        before the round runs and ended after it. The static buffers and
        the generator are restored afterwards: neither the warm-up nor
        the capture changes what the next round computes. The warm-up's
        kernel launches are real and stay counted; the capture's are
        taken back and added at every replay."""
        sampled = selection != 'greedy'
        if sampled and not hasattr(torch.cuda.CUDAGraph,
                                   'register_generator_state'):
            raise RuntimeError(
                f'torch {torch.__version__} cannot register a '
                f'torch.Generator with a CUDA graph (sampled rounds)')
        for d in self.cards:
            paged_kernel.reserve_graph_counters(d)
        statics = [self.out] + [t for buf in self._bufs.values()
                                for t in (buf['packed'], buf['last_tok'],
                                          buf['last_pos'])]
        saved = [t.clone() for t in statics]
        rng_state = self.generator.get_state()
        sides = {d: torch.cuda.Stream(d) for d in self.cards}
        for d in self.cards:
            sides[d].wait_stream(torch.cuda.current_stream(d))
        self._zero_packed()
        with self._on_streams(sides):
            self.step(selection, lora)
        for d in self.cards:
            torch.cuda.current_stream(d).wait_stream(sides[d])
        self._zero_packed()
        for d in self.cards:
            torch.cuda.synchronize(d)
        gc.collect()
        graphs = {d: torch.cuda.CUDAGraph() for d in self.cards}
        if sampled:
            graphs[self.device].register_generator_state(self.generator)
        before = self._counts()
        # One card: the default mode, which refuses any unsafe CUDA call
        # during the capture. Several: 'relaxed', because ending one
        # card's capture instantiates its graph, a call the other modes
        # refuse while another card's capture is still open on this
        # thread (the round makes no such call itself).
        mode = 'global' if len(self.cards) == 1 else 'relaxed'
        begun = []
        with self._on_streams(sides):
            try:
                for d in self.cards:
                    with torch.cuda.device(d):
                        graphs[d].capture_begin(pool=self._pools[d],
                                                capture_error_mode=mode)
                    begun.append(d)
                self.step(selection, lora)
            except BaseException:
                for d in reversed(begun):     # leave no capture open
                    try:
                        with torch.cuda.device(d):
                            graphs[d].capture_end()
                    except Exception:  # pylint: disable=broad-except
                        pass
                raise
            for d in reversed(begun):
                with torch.cuda.device(d):
                    graphs[d].capture_end()
        for d in self.cards:
            torch.cuda.current_stream(d).wait_stream(sides[d])
        counts = _count_delta(self._counts(), before)
        self._add_counts(counts, sign=-1)
        for t, s in zip(statics, saved):
            t.copy_(s)
        self.generator.set_state(rng_state)
        return [graphs[d] for d in self.cards], counts

    def _zero_packed(self) -> None:
        for buf in self._bufs.values():
            buf['packed'].zero_()

    def _counts(self) -> Dict[Tuple, int]:
        counts = _kernel_counts()
        if self.grid is not None:
            counts[('grid', 'reductions')] = self.grid.reductions
        return counts

    def _add_counts(self, delta: Dict[Tuple, int], sign: int = 1) -> None:
        delta = dict(delta)
        if self.grid is not None:
            self.grid.reductions += sign * delta.pop(('grid', 'reductions'),
                                                     0)
        _add_kernel_counts(delta, sign)

    def graphs_captured(self) -> int:
        return len(self._graphs)
