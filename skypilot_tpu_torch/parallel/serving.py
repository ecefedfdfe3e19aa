"""Tensor x pipeline serving on a grid of devices (port of
skypilot_tpu/parallel/serving.py and the staged half of
skypilot_tpu/models/batching.py).

The reference serves one model over `jax.devices()[:stages*tensor]` from
ONE process: one engine, one scheduler, one prefix cache and one page
table drive every device, and XLA inserts the collectives. The port
keeps that shape, a single controller over a `Grid` of torch devices,
`stages` rows of `tensor` devices each:

  - `GridModel` holds each layer as `tensor` shard blocks on its stage's
    row. Heads, the MLP's hidden axis and the vocabulary split over
    `tensor` (the reference's DEFAULT_RULES: heads / mlp / vocab ->
    tensor); norms, routers and MLA's latent projections are whole on
    every shard. A block runs in the three phases every family's block
    has (`attn_qkv`, `attn_out`, `ffn`): after `wo` and after the MLP
    the shards' partial outputs are summed by `Grid.all_reduce`, after
    the vocab-sharded embedding too, and the head's vocab slices are
    gathered (`Grid.gather`). An int8 pool whose kv heads split takes
    one more reduction, the max of each token's absmax over the shards,
    so every shard quantizes against the scale the whole token gets.
  - The stage handoff is the activation's copy onto the next stage's
    row (the reference's `device_put`, models/batching.py:866-871); no
    pool page crosses a stage.
  - `GridCache` holds each shard's pool: paged value pages split their
    kv-heads axis (axis 0), dense rows theirs (axis 2), and everything
    else (int8 scale pages, MLA's latent rows) is whole on every shard
    of the stage (reference `serving_cache_shardings`, :110-133). Under
    the GQA remainder rule (`kv_shard_ways` 1 while q heads split) the
    pool is whole on every shard, `wk` / `wv` are too, and shard t's q
    heads [h0, h0 + Hq/T) read kv heads h0 // G.. of it.

The collectives are `Grid`'s, one route for every family and every
grid: `all_reduce` (a sum in f32 in shard order, cast back; or the int8
pool's max), `gather` (the head's vocab slices, in shard order),
`broadcast` (the sampled tokens to every stage-0 shard) and `handoff`
(the activation onto the next stage's row). On the card they are the
hand-written kernel of ops/grid_collective.py: one launch a card an op,
the cards trading their parts over NVLink through exchange buffers set
up once per grid at startup (peer access enabled between every pair; a
pair without it stops the grid with the reason), or one launch for
every shard on one card named N times. On the CPU they are the plain
helpers (`Tensor.to` copies to the row's first device, combined there),
which the kernel is held to bit for bit. The all-reduce refuses any
tensor that shares storage with a pool shard: the reference's guard
(`pool_collective_lines`, an HLO scan for a collective over a
pool-shaped operand) becomes that check, and pool shards are updated in
place, so their storage never changes.

A decode round (models/decode_graph.py) hands `GridModel.round_logits`
its inputs as `Placed`: one copy a grid place, staged there by the host
before the round. So a round makes no cross-card `Tensor.to` copy; every
byte that crosses cards goes through the collective, and each card's
share of the round is captured into a CUDA graph of its own. Eager calls
(prefill and verify chunks, a scoring pass, the KV chain's page rows)
copy their inputs across cards with `Tensor.to`, under `Grid.lock` like
every forward, so no such copy lands between another thread's launches
of one collective on two cards.

A device may repeat only in an explicit `devices=` list (tests run
`['cpu'] * N`, chip_smoke `['cuda:0'] * N`); by default a grid takes the
first `stages * tensor` distinct devices and refuses to start with
fewer. Over distinct cards each kernel wrapper launches from its
tensors' card, and the kernel libraries keep their attributes per card
(`csrc/hopper.cuh` `PerDevice`); tests/test_torch_grid_cards.py holds
such grids to one card named several times.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from skypilot_tpu_torch.models.deepseek import Deepseek, LatentCache
from skypilot_tpu_torch.models.gpt import GPT
from skypilot_tpu_torch.models.llama import (DenseKVCache, LayerCache, Llama,
                                             PagedKVCache, kv_heads)
from skypilot_tpu_torch.ops import grid_collective as collective
from skypilot_tpu_torch.ops import paged_attention as paged_ops
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel.tensor import (  # noqa: F401 (re-exported)
    edges, family, kv_shard_ways, leaf_axis, lora_factor_axes, piece,
    remainder_read_heads, replace_param)


def stage_layer_ranges(num_layers: int,
                       stages: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) layer ranges per stage, earlier stages taking
    the remainder layers (reference :136-156)."""
    if stages < 1:
        raise ValueError(f'stages must be >= 1, got {stages}')
    if stages > num_layers:
        raise ValueError(
            f'cannot split {num_layers} layers over {stages} stages '
            f'(at least one layer per stage)')
    base, rem = divmod(num_layers, stages)
    ranges: List[Tuple[int, int]] = []
    lo = 0
    for s in range(stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def grid_devices(stages: int, tensor: int, *, cpu: bool = False,
                 devices: Optional[Sequence] = None
                 ) -> List[List[torch.device]]:
    """The [stages][tensor] devices of a grid: `devices` as given (the
    one way to repeat a device), else the first stages * tensor distinct
    devices (CUDA cards, or the one CPU with `cpu`); too few exits at
    startup naming the count."""
    want = stages * tensor
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != want:
            raise ValueError(
                f'devices= lists {len(devs)} devices; --stages {stages} x '
                f'--tensor {tensor} needs {want}')
    else:
        visible = ([torch.device('cpu')] if cpu else
                   [torch.device('cuda', i)
                    for i in range(torch.cuda.device_count())])
        if len(visible) < want:
            raise SystemExit(
                f'--stages {stages} x --tensor {tensor} needs {want} '
                f'distinct devices; {len(visible)} '
                f'{"CPU device is" if cpu else "CUDA devices are"} '
                f'visible (a device repeats only in an explicit devices= '
                f'list)')
        devs = visible[:want]
    return [devs[s * tensor:(s + 1) * tensor] for s in range(stages)]


class Grid:
    """`stages` rows of `tensor` torch devices and the collectives over
    them (module doc). On CUDA devices every team the grid's rounds use
    (each row, each stage hand-off, the head's slices to the first
    device) is set up here, at startup."""

    def __init__(self, devices: List[List[torch.device]]) -> None:
        if not devices or any(len(row) != len(devices[0])
                              for row in devices):
            raise ValueError(f'a grid is rows of equal length, got '
                             f'{devices}')
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.stages = len(devices)
        self.tensor = len(devices[0])
        self._pool_storages: set = set()
        #: Reductions made by `all_reduce` so far (a decode graph adds its
        #: capture's count at each replay).
        self.reductions = 0
        #: Held while one op is launched on every card of its team, for a
        #: whole forward of the grid model (its collectives and the eager
        #: calls' cross-card copies), for a decode round's capture and for
        #: its replays: each card then sees the work of two threads (the
        #: scheduler's rounds, a scoring pass) in one order, as the
        #: kernel's epochs need, and no thread puts a cross-card wait
        #: between another thread's launches on two cards, which a
        #: collective spinning on the first card would never see end.
        self.lock = threading.RLock()
        self._teams: Dict[Tuple[str, ...], collective.Team] = {}
        if self.first.type == 'cuda':
            for row in self.devices:
                self.team(row)
            for s in range(1, self.stages):
                for t in range(self.tensor):
                    self.team([self.devices[s - 1][t], self.devices[s][t]])
            if self.stages > 1:
                self.team([self.devices[-1][0], self.first])

    @property
    def size(self) -> int:
        return self.stages * self.tensor

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def distinct_devices(self) -> int:
        return len({str(d) for row in self.devices for d in row})

    def cards(self) -> List[torch.device]:
        """The grid's distinct devices, stage-major, the first first."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def team(self, devices: Sequence[torch.device]) -> collective.Team:
        """The collective team of `devices` (made at startup for the
        grid's own teams; another is made at its first use, never inside
        a graph capture)."""
        key = tuple(str(torch.device(d)) for d in devices)
        team = self._teams.get(key)
        if team is None:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f'no collective team over {key} was '
                                   f'set up before the capture')
            team = self._teams[key] = collective.Team(devices)
        return team

    def collective_route(self) -> str:
        """How the grid's collectives run (serve_lm prints it)."""
        if self.first.type != 'cuda':
            return 'plain helpers on the CPU'
        cards = self.cards()
        if len(cards) == 1:
            return (f'the collective kernel, one launch on {cards[0]} for '
                    f'all {self.size} shards')
        return (f'the collective kernel over NVLink between {len(cards)} '
                f'cards ({", ".join(str(d) for d in cards)}), peer access '
                f'enabled')

    def register_pool(self, tensors) -> None:
        """Mark pool shards: `all_reduce` refuses their storage."""
        for t in tensors:
            self._pool_storages.add(t.untyped_storage().data_ptr())

    def all_reduce(self, parts: List[torch.Tensor],
                   op: str = 'sum') -> List[torch.Tensor]:
        """Sum (or max) one partial per shard of a row, in shard order (a
        sum in f32, cast back); the result on every shard's device."""
        if op not in ('sum', 'max'):
            raise ValueError(f'unknown reduction {op!r}')
        for p in parts:
            if p.untyped_storage().data_ptr() in self._pool_storages:
                raise ValueError(
                    f'all_reduce refuses a KV pool shard '
                    f'{tuple(p.shape)}: pool pages never move between '
                    f'devices')
        if len(parts) == 1:
            return list(parts)
        with self.lock:
            self.reductions += 1
            return collective.all_reduce(parts, self._team_of(parts), op)

    def gather(self, parts: List[torch.Tensor],
               device: torch.device) -> torch.Tensor:
        """The shards' slices of the last axis, concatenated in shard
        order on `device` (the head's vocab slices): gathered on the
        first shard's device, then handed to `device` if it is another."""
        if self.first.type != 'cuda':
            return collective.gather(parts, None, device)
        home = parts[0].device
        with self.lock:
            out = (parts[0] if len(parts) == 1 else
                   collective.gather(parts, self._team_of(parts), home))
            if torch.device(device) == home:
                return out
            return collective.broadcast(out, self.team([home, device]))[1]

    def broadcast(self, src: torch.Tensor, stage: int = 0
                  ) -> List[torch.Tensor]:
        """`src` (on stage `stage`'s first device) on each of that row's
        devices."""
        row = self.devices[stage]
        if len(row) == 1:
            return [src]
        with self.lock:
            return collective.broadcast(src, self._team_of(row), row)

    def handoff(self, xs: List[torch.Tensor],
                stage: int) -> List[torch.Tensor]:
        """Stage `stage - 1`'s per-shard activations onto stage `stage`'s
        row, shard t to shard t (the reference's `device_put` between
        stages)."""
        out = []
        with self.lock:
            for t, x in enumerate(xs):
                pair = [self.devices[stage - 1][t], self.devices[stage][t]]
                out.append(collective.broadcast(x, self._team_of(pair),
                                                pair)[1])
        return out

    def _team_of(self, parts) -> Optional[collective.Team]:
        devices = [p if isinstance(p, torch.device) else p.device
                   for p in parts]
        if devices[0].type != 'cuda':
            return None
        return self.team(devices)


class Placed:
    """One tensor a grid place (stage, rank), each on its place's device,
    all holding the same values: a decode round's inputs, staged on every
    card before the round (module doc)."""

    def __init__(self, copies: Dict[Tuple[int, int], torch.Tensor]) -> None:
        self.copies = copies

    def at(self, stage: int, rank: int) -> torch.Tensor:
        return self.copies[(stage, rank)]


# -- the parameter split -----------------------------------------------------
# The split of every block tensor over `tensor` and each family's edges
# (blocks, token table, head, final norm) are parallel/tensor.py's
# (`leaf_axis`, `piece`, `lora_factor_axes`, `remainder_read_heads`,
# `edges`), which the trainers share.
def shard_block_state(block: nn.Module, rank: int, ways: int,
                      kv_split: bool) -> Dict[str, torch.Tensor]:
    """Shard `rank`'s tensors of one block (views where the split is
    along the leading axis, on the block's device)."""
    return {name: piece(t, leaf_axis(name, kv_split), rank, ways)
            for name, t in block.state_dict().items()}


class GridModel(nn.Module):
    """A port model split over a `Grid` (module doc), driven through the
    families' serving interface: `config`, `device` (the grid's first
    device, where tokens come in and logits go out), `hidden`, `logits`,
    `dense_cache`, and `paged_cache` for the engine's pool. Built from a
    whole model, whose tensors it shares where a shard is a leading-axis
    slice on the same device."""

    def __init__(self, model: nn.Module, grid: Grid) -> None:
        super().__init__()
        cfg = model.config
        ways = grid.tensor
        blocks_attr, table, head, norm = edges(model)
        if grid.stages > 1 and family(model) is not Llama:
            raise ValueError(
                f'staged serving supports the Llama family; '
                f'{family(model).__name__} has no stage split')
        for field in ('num_heads', 'vocab_size'):
            if getattr(cfg, field) % ways:
                raise ValueError(f'{field}={getattr(cfg, field)} does not '
                                 f'split over --tensor {ways}')
        self.config = cfg
        self.grid = grid
        self.family = family(model)
        self.weight_dtype = getattr(model, 'weight_dtype', 'bf16')
        self.CACHE_PREFIX = getattr(  # pylint: disable=invalid-name
            model, 'CACHE_PREFIX', 'layer_')
        self.ranges = stage_layer_ranges(cfg.num_layers, grid.stages)
        self._stage_of = [s for s, (lo, hi) in enumerate(self.ranges)
                          for _ in range(lo, hi)]
        self._table, self._head, self._norm = table, head, norm
        num_kv = kv_heads(cfg) if hasattr(cfg, 'kv_page_size') else 0
        #: Ways the pool's kv heads split (1: whole on every shard).
        self.kv_shard_ways = kv_shard_ways(num_kv, ways)
        kv_split = self.kv_shard_ways > 1
        self.read_heads = [
            remainder_read_heads(cfg.num_heads, num_kv, t, ways)
            if num_kv else None for t in range(ways)]
        source = getattr(model, blocks_attr)
        self.blocks = nn.ModuleList()
        for i, block in enumerate(source):
            devices = grid.devices[self._stage_of[i]]
            shards = nn.ModuleList()
            for t in range(ways):
                with torch.device('meta'):
                    shard = type(model)(dataclasses.replace(
                        cfg, num_layers=1), weight_dtype=self.weight_dtype)
                    shard = getattr(shard, blocks_attr)[0]
                for name, part in shard_block_state(
                        block, t, ways, kv_split).items():
                    replace_param(shard, name,
                                  part.to(devices[t]).contiguous(),
                                  requires_grad=False)
                attn = shard.attn
                attn.num_heads = cfg.num_heads // ways
                if hasattr(attn, 'num_kv_heads'):
                    attn.num_kv_heads = (cfg.num_kv_heads // ways
                                         if kv_split else cfg.num_kv_heads)
                shards.append(shard)
            self.blocks.append(shards)
        # The edges: shard t's vocab slice of the token table on stage
        # 0, its final norm and head slice on the last stage.
        state = model.state_dict()
        first, last = grid.devices[0], grid.devices[-1]
        self.edges = nn.ModuleList()
        for t in range(ways):
            with torch.device('meta'):
                edge = type(model)(dataclasses.replace(cfg, num_layers=0),
                                   weight_dtype=self.weight_dtype)
            for name, tensor in state.items():
                if name.startswith(f'{blocks_attr}.'):
                    continue
                if name in (table, head):
                    dev = first[t] if name == table else last[t]
                    replace_param(edge, name,
                                  piece(tensor, 0, t, ways).to(dev),
                                  requires_grad=False)
                else:
                    dev = last[t] if name.startswith(norm) else first[t]
                    replace_param(edge, name, tensor.to(dev),
                                  requires_grad=False)
            self.edges.append(edge)
        self._vocab_slice = cfg.vocab_size // ways

    @property
    def device(self) -> torch.device:
        return self.grid.first

    def layer_device(self, layer: int, rank: int) -> torch.device:
        """The device of layer `layer`'s shard `rank`."""
        return self.grid.devices[self._stage_of[layer]][rank]

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional['GridCache'] = None,
                page_indices: Optional[torch.Tensor] = None,
                prefill: bool = False, lora: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32 logits [B, S, vocab] on `device`."""
        return self.logits(self.hidden(tokens, positions, cache,
                                       page_indices, prefill, lora,
                                       adapter_ids))

    # -- caches ---------------------------------------------------------------
    def paged_cache(self) -> 'GridCache':
        """The engine's page pool, one shard a grid device."""
        cfg = self.config
        heads = kv_heads(cfg) // self.kv_shard_ways
        return GridCache(self, [[PagedKVCache(cfg, d, heads=heads,
                                              num_layers=hi - lo)
                                 for d in self.grid.devices[s]]
                                for s, (lo, hi) in enumerate(self.ranges)])

    def dense_cache(self, batch: int) -> 'GridCache':
        """Dense rows of `batch` slots, one shard a grid device: kv heads
        split as the pool's, MLA's latents whole on every shard."""
        cfg = self.config

        def shard(device, layers):
            if self.family is Deepseek:
                return LatentCache(cfg, batch, device, num_layers=layers)
            return DenseKVCache(cfg, batch, device,
                                heads=kv_heads(cfg) // self.kv_shard_ways,
                                num_layers=layers)

        return GridCache(self, [[shard(d, hi - lo)
                                 for d in self.grid.devices[s]]
                                for s, (lo, hi) in enumerate(self.ranges)])

    # -- the forward --------------------------------------------------------
    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional['GridCache'] = None,
               page_indices: Optional[torch.Tensor] = None,
               prefill: bool = False, lora: Optional[dict] = None,
               adapter_ids: Optional[torch.Tensor] = None,
               attend_len: Optional[int] = None) -> torch.Tensor:
        """Final-norm hidden states [B, S, embed] on the last stage's
        first device: the families' `hidden`, shard by shard. `lora` is
        a grid registry's `model_lora()` (inference/adapters.py):
        {'scale', 'shards': one factor tree a tensor rank}."""
        with self.grid.lock:
            xs = self._rows(tokens, positions, cache, page_indices, prefill,
                            lora, adapter_ids, attend_len)
            return getattr(self.edges[0], self._norm)(xs[0])

    def round_logits(self, tokens: 'Placed', positions: 'Placed',
                     cache: Optional['GridCache'] = None,
                     page_indices: Optional['Placed'] = None,
                     lora: Optional[dict] = None,
                     adapter_ids: Optional['Placed'] = None,
                     attend_len: Optional[int] = None) -> torch.Tensor:
        """A decode round's f32 logits [B, vocab] on `device`, from inputs
        placed on every grid device beforehand (`Placed`): each shard
        takes the final norm of its own copy of the residual stream and
        its head slice, and the slices are gathered. No `Tensor.to`
        crosses cards; the collectives do."""
        with self.grid.lock:
            xs = self._rows(tokens, positions, cache, page_indices, False,
                            lora, adapter_ids, attend_len)
            parts = [edge.logits(getattr(edge, self._norm)(x)[:, 0])
                     for edge, x in zip(self.edges, xs)]
            return self.grid.gather(parts, self.device)

    def _rows(self, tokens, positions, cache, page_indices, prefill, lora,
              adapter_ids, attend_len) -> List[torch.Tensor]:
        """The residual stream of every shard of the last stage after the
        last layer (each shard holds the same values)."""
        grid = self.grid
        first = tokens.at(0, 0) if isinstance(tokens, Placed) else tokens
        batch, seq = first.shape
        if adapter_ids is not None and lora is None:
            raise ValueError('adapter_ids select rows of stacked lora '
                             'factors; pass lora too')
        if lora is not None and 'shards' not in lora:
            raise ValueError('a grid model takes the factors of an '
                             'adapter registry built on its grid (mesh=)')
        if positions is None:
            positions = torch.arange(seq, dtype=torch.int32,
                                     device=first.device).expand(batch, seq)
        copies: Dict[Tuple[int, str], torch.Tensor] = {}

        def on(t, s: int, r: int):
            """`t` on place (s, r): its placed copy, or one `Tensor.to`
            (eager calls: prefill chunks, verify chunks)."""
            if t is None or isinstance(t, Placed):
                return None if t is None else t.at(s, r)
            device = grid.devices[s][r]
            key = (id(t), str(device))
            if key not in copies:
                copies[key] = t.to(device)
            return copies[key]

        xs = self._embed(tokens, positions, on)
        for s, (lo, hi) in enumerate(self.ranges):
            devices = grid.devices[s]
            if s > 0:
                xs = grid.handoff(xs, s)
            pos = [on(positions, s, t) for t in range(len(devices))]
            table = [on(page_indices, s, t) for t in range(len(devices))]
            lora_kw = [{} for _ in devices]
            if lora is not None:
                for t in range(len(devices)):
                    lora_kw[t] = {'adapter_ids': on(adapter_ids, s, t),
                                  'lora_scale': float(lora['scale'])}
            for i in range(lo, hi):
                layers = [None] * len(devices)
                if cache is not None:
                    layers = [cache.shards[s][t].layers[i - lo]
                              for t in range(len(devices))]
                for t in range(len(devices)):
                    if lora is not None:
                        lora_kw[t]['lora'] = lora['shards'][t].get(
                            f'layer_{i}')
                xs = self._block(i, xs, pos, layers, table, prefill,
                                 attend_len, lora_kw)
        return xs

    def _embed(self, tokens, positions, on) -> List[torch.Tensor]:
        """The token rows (each shard's vocab slice, rows outside it
        zero, summed) plus GPT's position rows, on the stage-0 row."""
        devices = self.grid.devices[0]
        dt = self.config.dtype
        parts = []
        for t, edge in enumerate(self.edges):
            rows = getattr(edge, self._table)
            tok = on(tokens, 0, t)
            if self.grid.tensor == 1:
                parts.append(rows[tok].to(dt))
                continue
            local = tok - t * self._vocab_slice
            hit = (local >= 0) & (local < self._vocab_slice)
            picked = rows[local.clamp(0, self._vocab_slice - 1)]
            parts.append((picked * hit[..., None]).to(dt))
        xs = self.grid.all_reduce(parts)
        if self.family is GPT:
            seq = parts[0].shape[1]
            xs = [x + edge.position_embed(on(positions, 0, t), seq)
                  for t, (x, edge) in enumerate(zip(xs, self.edges))]
        return xs

    def _block(self, i, xs, pos, layers, table, prefill, attend_len,
               lora_kw) -> List[torch.Tensor]:
        """Layer i on its stage's row: attention, then the MLP, each
        shard's partial output summed."""
        grid = self.grid
        shards = self.blocks[i]
        states = [b.attn_qkv(x, p, **kw)
                  for b, x, p, kw in zip(shards, xs, pos, lora_kw)]
        extra = [dict(kw) for kw in lora_kw]
        if self.read_heads[0] is not None:
            for t, e in enumerate(extra):
                e['kv_heads'] = self.read_heads[t]
        if self.kv_shard_ways > 1 and layers[0] is not None and \
                'k_scales' in layers[0]:
            # Each shard holds some of a token's kv heads: the int8 scale
            # is the absmax over all of them.
            k_amax = grid.all_reduce(
                [paged_ops.kv_row_amax(st[1]) for st in states], op='max')
            v_amax = grid.all_reduce(
                [paged_ops.kv_row_amax(st[2]) for st in states], op='max')
            for t, e in enumerate(extra):
                e['kv_amax'] = (k_amax[t], v_amax[t])
        parts = [b.attn_out(st, p, kv, tb, prefill, attend_len, **e)
                 for b, st, p, kv, tb, e in zip(shards, states, pos, layers,
                                                table, extra)]
        xs = [x + a for x, a in zip(xs, grid.all_reduce(parts))]
        parts = [b.ffn(x, **kw) for b, x, kw in zip(shards, xs, lora_kw)]
        return [x + m for x, m in zip(xs, grid.all_reduce(parts))]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits [..., vocab] on `device`: `x` (on the last stage's
        first device) handed to every shard of the last stage, each
        shard's head slice of the vocabulary, gathered in shard order."""
        with self.grid.lock:
            xs = self.grid.broadcast(x, self.grid.stages - 1)
            parts = [edge.logits(x) for edge, x in zip(self.edges, xs)]
            return self.grid.gather(parts, self.device)

    # -- accounting -----------------------------------------------------------
    def stage_weight_bytes(self) -> List[int]:
        """Weight bytes of each stage's row of devices."""
        per = self.device_weight_bytes()
        t = self.grid.tensor
        return [sum(per[s * t:(s + 1) * t]) for s in range(self.grid.stages)]

    def device_weight_bytes(self) -> List[int]:
        """Weight bytes on each grid position, stage-major: its blocks'
        shards, plus the token table on stage 0 and the final norm and
        head on the last stage."""
        def nbytes(tensors):
            return sum(p.numel() * p.element_size() for p in tensors)

        out = []
        for s, (lo, hi) in enumerate(self.ranges):
            for t in range(self.grid.tensor):
                edge = self.edges[t].state_dict()
                names = set()
                if s == 0:
                    names |= {k for k in edge if k != self._head
                              and not k.startswith(self._norm)}
                    names.add(self._table)
                if s == self.grid.stages - 1:
                    names |= {k for k in edge if k.startswith(self._norm)}
                    names.add(self._head)
                out.append(nbytes(p for i in range(lo, hi) for p in
                                  self.blocks[i][t].state_dict().values())
                           + nbytes(edge[k] for k in names))
        return out


class GridCache(LayerCache):
    """A grid model's cache: `shards[s][t]`, the cache of stage s's
    layers on its t-th device (module doc). Presents the engine the
    whole pool: its bytes, a reset, per-slot row views on the dense
    path, and the KV chain's page rows with every head (gathered from
    the shards on export, scattered to them on import)."""

    def __init__(self, model: GridModel, shards: List[List[LayerCache]]
                 ) -> None:
        self.model = model
        self.shards = shards
        self.ways = model.kv_shard_ways
        cfg = model.config
        first = shards[0][0]
        if isinstance(first, DenseKVCache):
            self.values_per_token = 2 * kv_heads(cfg) * cfg.head_dim
        elif hasattr(first, 'values_per_token'):
            self.values_per_token = first.values_per_token
        model.grid.register_pool(self._leaves())

    def _leaves(self) -> List[torch.Tensor]:
        return [t for row in self.shards for shard in row
                for layer in shard.layers for t in layer.values()]

    def zero_(self) -> None:
        for row in self.shards:
            for shard in row:
                shard.zero_()

    def num_bytes(self) -> int:
        """The pool's logical bytes: split leaves over all their shards,
        whole leaves once."""
        split = ('k_pages', 'v_pages', 'cached_key', 'cached_value')
        return sum(t.numel() * t.element_size()
                   for row in self.shards for rank, shard in enumerate(row)
                   for layer in shard.layers for name, t in layer.items()
                   if rank == 0 or (self.ways > 1 and name in split))

    def bytes_per_device(self) -> int:
        """The largest shard: what one grid device holds."""
        return max(shard.num_bytes() for row in self.shards
                   for shard in row)

    def row(self, slot: int) -> 'GridCache':
        """Row `slot` of every shard's dense rows (views)."""
        view = object.__new__(GridCache)
        view.__dict__.update(self.__dict__)
        view.shards = [[shard.row(slot) for shard in row]
                       for row in self.shards]
        return view

    def data_ptrs(self) -> List[int]:
        """Storage of every pool shard (constant across rounds)."""
        return [t.data_ptr() for t in self._leaves()]

    # -- KV chain rows: every kv head, page-major --------------------------
    def page_leaf_specs(self) -> List[tuple]:
        out = []
        lo = 0
        for s, row in enumerate(self.shards):
            for i, name, shape, dtype in row[0].page_leaf_specs():
                if len(shape) == 3:
                    shape = (shape[0] * self.ways,) + shape[1:]
                out.append((lo + i, name, shape, dtype))
            lo += len(row[0].layers)
        return out

    def gather_pages(self, idx: torch.Tensor) -> List[torch.Tensor]:
        with self.model.grid.lock:   # cross-card copies (Grid.lock)
            return self._gather_pages(idx)

    def _gather_pages(self, idx: torch.Tensor) -> List[torch.Tensor]:
        out = []
        home = idx.device
        for row in self.shards:
            per_shard = [shard.gather_pages(idx.to(shard_device(shard)))
                         for shard in row]
            for k, rows in enumerate(per_shard[0]):
                if rows.ndim == 4 and self.ways > 1:
                    rows = torch.cat([p[k].to(home) for p in per_shard],
                                     dim=1)
                out.append(rows.to(home))
        return out

    def scatter_pages(self, idx: torch.Tensor,
                      rows: List[torch.Tensor]) -> None:
        with self.model.grid.lock:   # cross-card copies (Grid.lock)
            self._scatter_pages(idx, rows)

    def _scatter_pages(self, idx: torch.Tensor,
                       rows: List[torch.Tensor]) -> None:
        k0 = 0
        for row in self.shards:
            n = sum(len(layer) for layer in row[0].layers)
            mine = rows[k0:k0 + n]
            k0 += n
            for t, shard in enumerate(row):
                dev = shard_device(shard)
                part = [(r.chunk(self.ways, dim=1)[t]
                         if r.ndim == 4 and self.ways > 1 else r).to(dev)
                        for r in mine]
                shard.scatter_pages(idx.to(dev), part)


def shard_device(cache: LayerCache) -> torch.device:
    return next(iter(cache.layers[0].values())).device


def make_grid(config: mesh_lib.MeshConfig, *, cpu: bool = False,
              devices: Optional[Sequence] = None) -> Grid:
    """The serving grid of a (stage, tensor) `MeshConfig`, as the
    reference's build_runtime makes `make_mesh(MeshConfig(stage=S,
    tensor=T), devices=...)` (`grid_devices` picks the devices). Serving
    splits no batch, sequence or experts: the other axes must be 1."""
    others = {axis: n for axis, n in zip(config.axis_names, config.shape)
              if axis not in ('stage', 'tensor') and n != 1}
    if others:
        raise ValueError(f'a serving grid has stage and tensor axes '
                         f'only, got {others}')
    return Grid(grid_devices(config.stage, config.tensor, cpu=cpu,
                             devices=devices))


def build(model: nn.Module, config: mesh_lib.MeshConfig, *,
          cpu: bool = False, devices: Optional[Sequence] = None
          ) -> GridModel:
    """`model` split over the grid of `config` (`make_grid`)."""
    return GridModel(model, make_grid(config, cpu=cpu, devices=devices))

