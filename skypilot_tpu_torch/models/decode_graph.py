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
ops/int8_linear.py) and a grid's count of all-reduces are Python
increments that a replay does not run: each graph keeps the counts its
capture made and adds them at every replay.

A grid model (parallel/serving.py) whose shards all lie on one card is
captured the same way, its shards' launches and collectives in one
graph. Over distinct cards a round runs eagerly (`graph_blocker` says
why): one graph holds one device's work, and a graph for each device
segment between collectives is not built yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.generate import sample_tokens
from skypilot_tpu_torch.ops import int8_linear, lora_kernel, paged_kernel

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
              ('int8', 'plain_calls'): int8_linear.plain_calls}
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
        #: Why the rounds run eagerly on the card, or None.
        self.graph_blocker = (
            f'the grid spans {grid.distinct_devices()} distinct devices'
            if grid is not None and grid.distinct_devices() > 1 else None)
        self.use_graphs = (bool(use_graphs) and self.device.type == 'cuda'
                           and self.graph_blocker is None)
        b = num_slots
        self._offsets = {name: i * b for i, name in enumerate(_FIELDS)}
        self._step_at = len(_FIELDS) * b
        self._table_at = self._step_at + 1
        size = self._table_at + b * pages_per_seq
        dev = self.device
        pin = dev.type == 'cuda'
        self.packed = torch.zeros(size, dtype=torch.int32, device=dev)
        # Device views of `packed` (what the round function reads).
        self.view = {name: self._field(self.packed, name) for name in _FIELDS}
        self.view['step'] = self.packed[self._step_at:self._step_at + 1]
        self.view['table'] = self.packed[self._table_at:].view(
            b, pages_per_seq)
        self.last_tok = torch.zeros(b, dtype=torch.int32, device=dev)
        self.last_pos = torch.zeros(b, dtype=torch.int32, device=dev)
        self.out = torch.zeros((max_steps, b), dtype=torch.int32,
                               device=dev)
        # Two of each pinned buffer, alternating by dispatch: a round's
        # staging is not rewritten, nor its tokens overwritten, until the
        # round after next, by which time the engine has fetched it.
        self._staging = [torch.zeros(size, dtype=torch.int32,
                                     pin_memory=pin) for _ in range(2)]
        self._fetched = [torch.zeros((max_steps, b), dtype=torch.int32,
                                     pin_memory=pin) for _ in range(2)]
        self._parity = 0
        self._graphs: Dict[Tuple[bool, str],
                           Tuple[object, Dict[Tuple, int]]] = {}
        self._pool = (torch.cuda.graph_pool_handle() if self.use_graphs
                      else None)
        #: Graph replays so far (every step on the card with graphs on).
        self.replays = 0

    def _field(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        at = self._offsets[name]
        t = buf[at:at + self.num_slots]
        return t.view(torch.float32) if name in _FLOAT_FIELDS else t

    # -- the round ----------------------------------------------------------
    def step(self, selection: str, lora: Optional[dict]) -> None:
        """One decode step on the static buffers (what a graph captures)."""
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
        out = select_tokens(logits, selection, v['temp'], v['top_k'],
                            v['top_p'], self.generator)
        self.last_tok.copy_(out)
        self.last_pos.copy_(pos)
        v['cont'].fill_(1)
        self.out.index_copy_(0, v['step'].long(), out[None])
        v['step'].add_(1)

    # -- host side ----------------------------------------------------------
    def dispatch(self, *, tok: np.ndarray, pos: np.ndarray,
                 cont: np.ndarray, ids: np.ndarray, top_k: np.ndarray,
                 temp: np.ndarray, top_p: np.ndarray, table: np.ndarray,
                 selection: str, lora: Optional[dict],
                 steps: int = 1) -> Pending:
        """Stage the inputs (one non-blocking copy), run `steps` steps
        (graph replays, or eager steps), and start the copy of
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
        self.packed.copy_(staging, non_blocking=True)
        if self.use_graphs:
            graph, counts = self._graph(selection, lora)
            for _ in range(steps):
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
                entry = self._capture(selection, lora)
            except Exception as e:
                raise RuntimeError(
                    f'CUDA-graph capture of the decode round (lora='
                    f'{key[0]}, {selection}) failed: {type(e).__name__}: '
                    f'{e}') from e
            self._graphs[key] = entry
        return entry

    def _capture(self, selection: str, lora: Optional[dict]):
        """Warm the variant up eagerly (every kernel and library loaded
        outside the capture) on zeroed inputs, so its KV writes land in
        the trash page, then capture it. The static buffers and the
        generator are restored afterwards: neither the warm-up nor the
        capture changes what the next round computes. The warm-up's
        kernel launches are real and stay counted; the capture's are
        taken back and added at every replay."""
        sampled = selection != 'greedy'
        if sampled and not hasattr(torch.cuda.CUDAGraph,
                                   'register_generator_state'):
            raise RuntimeError(
                f'torch {torch.__version__} cannot register a '
                f'torch.Generator with a CUDA graph (sampled rounds)')
        paged_kernel.reserve_graph_counters(self.device)
        statics = (self.packed, self.last_tok, self.last_pos, self.out)
        saved = [t.clone() for t in statics]
        rng_state = self.generator.get_state()
        self.packed.zero_()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.step(selection, lora)
        current.wait_stream(side)
        self.packed.zero_()
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        before = self._counts()
        with torch.cuda.graph(graph, pool=self._pool):
            self.step(selection, lora)
        counts = _count_delta(self._counts(), before)
        self._add_counts(counts, sign=-1)
        for t, s in zip(statics, saved):
            t.copy_(s)
        self.generator.set_state(rng_state)
        return graph, counts

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
