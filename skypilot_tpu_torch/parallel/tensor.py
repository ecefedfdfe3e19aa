"""Tensor parallelism (the reference's `heads` / `mlp` / `vocab` ->
`tensor` rules, skypilot_tpu/parallel/mesh.py DEFAULT_RULES) for
serving and training.

The split table. `leaf_axis` gives the split of each block tensor over
`tensor`: attention heads (wq, wk / wv when the kv heads divide, MLA's
`wkv_b` on its heads dim, GPT's fused q|k|v by heads) and the MLP's
hidden axis (w_gate, w_up, c_fc, Mixtral's expert stacks) split their
output channels; `wo`, `w_down` and `c_proj` are row-parallel: they split
their input channels and their outputs are partial sums. The token table
and the head split by vocab rows. Everything else (norms, the router,
MLA's latent projections, a row-parallel bias) is whole on every shard.
Under the GQA remainder rule (kv heads not divisible by the shard count)
`wk` / `wv` stay whole and shard t's q heads read the kv heads
`remainder_read_heads` names. parallel/serving.py splits its grid by
this table, and so do the trainers.

The collectives of a sharded region: its input enters through
`copy` (identity forward; the backward sums the shards' gradients) and
its partial outputs leave through `reduce` (the forward sums them; the
backward hands each shard the whole gradient), Megatron's f / g pair.
Sums of more than two parts run in f32 and are cast back once (of two,
the one rounding of a + b is the same in the parts' dtype). Whole parts (norms, the router,
MLA's latents, the residual stream) run outside the regions, so their
leaves get whole gradients on every shard; a whole leaf read inside a
region (`wk` / `wv` under the remainder rule, a whole LoRA factor) gets
its shard's part, summed over the shards.

Two forms of the tensor group, one set of block code (each family's
`Block.tensor_forward`):
  - `LocalTensor(devices)`: T shards in this process on a device list
    that may repeat (tests: ['cpu'] * T; the one-card smoke:
    ['cuda:0'] * T). Shard 0 is the model itself, sliced in place; shard
    t > 0 holds its sliced leaves and shares shard 0's whole leaves. The
    whole parts run once, on shard 0's device; `copy` and `reduce` are
    autograd functions over `Tensor.to`;
  - `RankTensor(group, index, size)`: one shard a rank, on the mesh's
    `tensor` process group (NCCL on cards, gloo on the CPU); every rank
    runs the whole parts itself; `copy` / `reduce` are all-reduces.
Both hand the block code {shard: tensor} dicts, of T entries in process
and of one over ranks.

`tensor_fault(name)` breaks one collective on purpose: the control that
a parity check of the path (the tests, chip_smoke.py) must fail.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# -- the split table -----------------------------------------------------------
#: The split of each projection's [out, in] weight over `tensor` (block-
#: relative module paths): 0 splits the output channels (heads, the MLP's
#: hidden axis), 1 the input channels (the row-parallel `wo` / `w_down`,
#: whose outputs are partial sums); 'kv' is 0 when the kv heads split and
#: whole otherwise; 'qkv' splits each third of GPT's fused q|k|v columns
#: by heads.
_PROJECTION_AXES = {
    'attn.wq': 0, 'attn.wq_b': 0, 'attn.wk': 'kv', 'attn.wv': 'kv',
    'attn.wo': 1, 'mlp.w_gate': 0, 'mlp.w_up': 0, 'mlp.w_down': 1,
    'attn.c_attn': 'qkv', 'attn.c_proj': 1, 'mlp.c_fc': 0,
    'mlp.c_proj': 1,
}
#: Raw parameters of a block: MLA's wkv_b [d_c, H, d] by heads, Mixtral's
#: experts [E, d, f] / [E, f, d] by the MLP's hidden axis.
_PARAMETER_AXES = {'attn.wkv_b': 1, 'moe.w_gate': 2, 'moe.w_up': 2,
                   'moe.w_down': 1}
#: Row-parallel projections (their bias is added once, after the sum).
_ROW_PARALLEL = ('attn.wo', 'mlp.w_down', 'attn.c_proj', 'mlp.c_proj')


def kv_shard_ways(num_kv_heads: int, tensor_size: int) -> int:
    """How many ways the KV-heads axis shards over `tensor_size`
    devices: all of them when the head count divides evenly, else the
    pool is whole on every device (the GQA remainder rule, reference
    serving :88-99); 0 kv heads (MLA) never shard."""
    if tensor_size > 1 and num_kv_heads > 0 and \
            num_kv_heads % tensor_size == 0:
        return int(tensor_size)
    return 1


def piece(t: torch.Tensor, axis, rank: int, ways: int) -> torch.Tensor:
    """Shard `rank` of `ways` of `t` along `axis` (None: all of it;
    'first': all of it on shard 0, zeros elsewhere, for a row-parallel
    bias added once; 'qkv': each third of axis 0 by heads)."""
    if axis is None or ways == 1:
        return t
    if axis == 'first':
        return t if rank == 0 else torch.zeros_like(t)
    if axis == 'qkv':
        return torch.cat([piece(third, 0, rank, ways)
                          for third in t.chunk(3, dim=0)], dim=0)
    if t.shape[axis] % ways:
        raise ValueError(f'cannot split axis {axis} of {tuple(t.shape)} '
                         f'{ways} ways')
    n = t.shape[axis] // ways
    return t[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)]


def leaf_axis(name: str, kv_split: bool):
    """The split of block tensor `name` (block-relative state-dict name)
    over `tensor`: an axis, 'first', 'qkv' or None (whole)."""
    if name in _PARAMETER_AXES:
        return _PARAMETER_AXES[name]
    module, _, leaf = name.rpartition('.')
    axis = _PROJECTION_AXES.get(module)
    if axis == 'kv':
        axis = 0 if kv_split else None
    if axis is None:
        return None
    if leaf in ('weight_q', 'weight_scale'):
        from skypilot_tpu_torch.inference import quant
        return quant.quantized_leaf_axis(leaf, axis)
    if leaf == 'bias':
        return 'first' if axis == 1 else axis
    return axis


def lora_factor_axes(target: str, kv_split: bool):
    """(a's axis, b's axis) of a LoRA target's factors a [d_in, r] and b
    [r, d_out] over `tensor`: a column-parallel projection's delta
    splits b's output columns with its heads / hidden units (a is whole:
    every shard sees the whole input), a row-parallel one's splits a's
    input rows (b is whole, the partial deltas sum with the outputs)."""
    module = f'{"attn" if target in ("wq", "wk", "wv", "wo") else "mlp"}' \
             f'.{target}'
    axis = leaf_axis(f'{module}.weight', kv_split)
    return (0 if axis == 1 else None), (1 if axis == 0 else None)


def remainder_read_heads(num_heads: int, num_kv: int, rank: int,
                         ways: int) -> Optional[Tuple[int, int]]:
    """Under the GQA remainder rule, the kv heads [lo, hi) that shard
    `rank`'s q heads [h0, h0 + H/T) read (q head h reads kv head
    h // G); None when the kv heads split with the q heads. Raises when
    the shard's q heads do not map onto whole, equal kv groups."""
    if kv_shard_ways(num_kv, ways) > 1 or ways == 1:
        return None
    group = num_heads // num_kv
    n = num_heads // ways
    h0 = rank * n
    lo, hi = h0 // group, (h0 + n - 1) // group + 1
    local_group = n // (hi - lo)
    if n % (hi - lo) or any((h0 + j) // group - lo != j // local_group
                            for j in range(n)):
        raise ValueError(
            f'{num_heads} q heads over {num_kv} kv heads do not split '
            f'{ways} ways: shard {rank} holds q heads [{h0}, {h0 + n}), '
            f'which span kv heads unevenly')
    return lo, hi


# -- autograd collectives over a process group ---------------------------------
def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x in x's dtype. Over two ranks it runs in x's
    dtype: a + b is rounded once either way, so it equals the f32 sum
    cast back, at half the bytes of bf16. Over more it runs in f32 and
    is cast back once."""
    if x.dtype == torch.float32 or dist.get_world_size(group) <= 2:
        buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=group)
        return buf
    buf = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (each rank's shard sees the input on its own copy)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group forward; identity backward (every rank
    holds the summed output and its whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


# -- in-process collectives ------------------------------------------------------
class _Scatter(torch.autograd.Function):
    """x on each shard's device; the backward sums the shards' gradients
    in f32, in shard order, on x's device, and casts once."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home, ctx.dtype = x.device, x.dtype
        return tuple(x.view_as(x) if torch.device(d) == x.device
                     else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g in grads:
            if g is None:
                continue
            g = g.to(ctx.home).float()
            acc = g.clone() if acc is None else acc.add_(g)
        return (None if acc is None else acc.to(ctx.dtype)), None


class _Gather(torch.autograd.Function):
    """The f32 sum, in shard order, of one part a shard, on the first
    part's device, cast to its dtype; the backward hands each part the
    whole gradient on its device."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        home = parts[0].device
        acc = parts[0].float().clone()
        for p in parts[1:]:
            acc.add_(p.to(home).float())
        return acc.to(parts[0].dtype)

    @staticmethod
    def backward(ctx, grad):
        return tuple(grad if d == grad.device else grad.to(d)
                     for d in ctx.devices)


# -- the tensor group seam -------------------------------------------------------
class LocalTensor:
    """T tensor shards in this process, shard t on `devices[t]` (a
    device may repeat); the whole parts run on shard 0's device."""

    def __init__(self, devices: Sequence) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.local = tuple(range(self.size))
        self.index = 0
        #: Sums made by `reduce` (forward) and entries through `copy`
        #: (each a sum in the backward): the cost counters.
        self.reductions = self.copies = 0

    def device(self, shard: int) -> torch.device:
        return self.devices[shard]

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def copy(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """x entering a sharded region: {shard: x on its device}."""
        self.copies += 1
        return dict(zip(self.local, _Scatter.apply(x, self.devices)))

    def reduce(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The shards' partial outputs summed, on shard 0's device."""
        self.reductions += 1
        return _Gather.apply(*(parts[t] for t in self.local))

    def all_reduce(self, parts: Dict[int, torch.Tensor], op: str = 'sum'
                   ) -> Dict[int, torch.Tensor]:
        """A sum (in f32, shard order) or max of one value a shard, on
        every shard's device (no gradient)."""
        home = self.home
        acc = parts[0].to(home).float()
        for t in self.local[1:]:
            p = parts[t].to(home).float()
            acc = acc + p if op == 'sum' else torch.maximum(acc, p)
        return {t: acc.to(self.devices[t], copy=True) for t in self.local}

    def sum_home(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The f32 sum of one value a shard on shard 0's device."""
        return self.all_reduce(parts)[0]


class RankTensor:
    """This rank's tensor shard on the `tensor` process group of a
    parallel/mesh.py DeviceMesh (`group` None: a group of one)."""

    def __init__(self, group, index: int, size: int) -> None:
        self.group = group
        self.index, self.size = index, size
        self.local = (index,)
        self.reductions = self.copies = 0

    def device(self, shard: int) -> Optional[torch.device]:
        del shard
        return None             # wherever the tensors are

    def copy(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        if self.size == 1:
            return {self.index: x}
        self.copies += 1
        return {self.index: copy_to_group(x, self.group)}

    def reduce(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        x = parts[self.index]
        if self.size == 1:
            return x
        self.reductions += 1
        return reduce_from_group(x, self.group)

    def all_reduce(self, parts: Dict[int, torch.Tensor], op: str = 'sum'
                   ) -> Dict[int, torch.Tensor]:
        buf = parts[self.index].float().contiguous().clone()
        if self.size > 1:
            dist.all_reduce(buf, group=self.group,
                            op=dist.ReduceOp.SUM if op == 'sum'
                            else dist.ReduceOp.MAX)
        return {self.index: buf}

    def sum_home(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        return self.all_reduce(parts)[self.index]


def to_shards(group, x: torch.Tensor) -> Dict[int, torch.Tensor]:
    """A tensor that takes no gradient (positions, tokens, one-hots) on
    every local shard's device."""
    return {t: x if group.device(t) in (None, x.device)
            else x.to(group.device(t)) for t in group.local}


# -- splitting a model -----------------------------------------------------------
def family(model) -> type:
    """The family class of a port model (Llama and Qwen2, Mixtral,
    DeepSeek, GPT-2); raises for a model with no tensor-parallel split."""
    from skypilot_tpu_torch.models import deepseek, gpt, llama, mixtral
    for cls in (llama.Llama, mixtral.Mixtral, deepseek.Deepseek, gpt.GPT):
        if isinstance(model, cls):
            return cls
    raise ValueError(f'{type(model).__name__} has no tensor-parallel '
                     f'split')


def edges(model) -> Tuple[str, str, str, str]:
    """(blocks, token table, head, final norm) attribute names of a port
    model (GPT's head is its token table); serving and the trainers
    split by them."""
    if family(model).__name__ == 'GPT':
        return 'h', 'wte', 'wte', 'ln_f'
    return 'layers', 'tok_embed', 'lm_head', 'final_norm'


def vocab_rows(vocab: int, ways: int) -> int:
    """Rows of each shard's table slice: the vocab padded to a multiple
    of `ways` (the padded rows are never looked up, and their logits are
    masked)."""
    return -(-vocab // ways)


def replace_param(module: nn.Module, name: str, tensor: torch.Tensor,
                  requires_grad: Optional[bool] = None) -> None:
    """Put `tensor` at state-dict entry `name` of `module`: a buffer as
    it is, a parameter as it is, a tensor as a new parameter
    (`requires_grad`, by default the old one's)."""
    *path, leaf = name.split('.')
    for part in path:
        module = getattr(module, part)
    if leaf in module._buffers:     # pylint: disable=protected-access
        module._buffers[leaf] = tensor  # pylint: disable=protected-access
        return
    if not isinstance(tensor, nn.Parameter):
        if requires_grad is None:
            requires_grad = getattr(module, leaf).requires_grad
        tensor = nn.Parameter(tensor, requires_grad=requires_grad)
    setattr(module, leaf, tensor)


def vocab_piece(t: torch.Tensor, index: int, ways: int) -> torch.Tensor:
    """Shard `index`'s rows of a vocab table [V, ...] padded to `ways`
    slices of `vocab_rows` (a copy)."""
    rows = vocab_rows(t.shape[0], ways)
    lo, hi = index * rows, min((index + 1) * rows, t.shape[0])
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    if hi > lo:
        out[:hi - lo] = t[lo:hi]
    return out


def _join(prefix: str, name: str) -> str:
    return f'{prefix}.{name}' if prefix and name else prefix or name


def block_axes(module: nn.Module, ways: int, kv_split: bool,
               prefix: str = '') -> Dict[str, object]:
    """{parameter name: its split} of one block (or of its submodule at
    block-relative path `prefix`; names relative to `module`): an axis
    or 'qkv' for a sliced leaf, 'sum' for a whole leaf read inside a
    sharded region (wk / wv under the remainder rule); whole leaves
    read outside the regions are left out."""
    out = {}
    for name, _ in module.named_parameters():
        full = _join(prefix, name)
        axis = leaf_axis(full, kv_split)
        if axis == 'first':
            continue                # added once, after the sum
        if axis is not None:
            out[name] = axis
        elif ways > 1 and full.rpartition('.')[0] in ('attn.wk', 'attn.wv'):
            out[name] = 'sum'
    return out


def shard_block(module: nn.Module, index: int, ways: int, kv_split: bool,
                read_heads: Optional[Tuple[int, int]] = None,
                prefix: str = '') -> Dict[str, object]:
    """Slice a block's tensor leaves (or those of its submodule at
    block-relative path `prefix`) to shard `index` of `ways` in place
    (new parameters, as `MoEFeedForward.shard_experts` makes them), mark
    its row-parallel projections and set the attention's head counts;
    returns `block_axes`. The models' `shard_tensor` methods call it."""
    axes = block_axes(module, ways, kv_split, prefix)
    for name, axis in axes.items():
        if axis == 'sum':
            continue
        whole = module.get_parameter(name)
        replace_param(module, name, piece(whole.detach(), axis, index,
                                     ways).clone())
    for mod_name, sub in module.named_modules():
        full = _join(prefix, mod_name)
        if full in _ROW_PARALLEL:
            sub.partial_sum = True
        if full == 'attn':
            sub.num_heads = sub.config.num_heads // ways
            if hasattr(sub, 'num_kv_heads'):
                sub.num_kv_heads = (sub.config.num_kv_heads // ways
                                    if kv_split else sub.config.num_kv_heads)
                sub.read_heads = read_heads
    return axes


def join_pieces(pieces: Sequence[torch.Tensor], axis, whole_shape
                ) -> torch.Tensor:
    """The whole tensor of its shards' pieces in shard order (the
    inverse of `piece` / `vocab_piece` along `axis`)."""
    if axis == 'qkv':
        return torch.stack([p.reshape(3, -1, *p.shape[1:]) for p in pieces],
                           dim=1).reshape(whole_shape)
    x = torch.cat(list(pieces), dim=0 if axis == 'vocab' else axis)
    return x.narrow(0, 0, whole_shape[0]) if axis == 'vocab' else x


def model_axes(model, ways: int) -> Tuple[bool, Dict[str, object]]:
    """(whether the kv heads split, {parameter name: split}) of a whole
    model over `ways` shards: `block_axes` under each block's prefix,
    'vocab' for the token table and the head."""
    cfg = model.config
    if cfg.num_heads % ways:
        raise ValueError(f'num_heads={cfg.num_heads} does not split over '
                         f'--tensor {ways}')
    num_kv = int(getattr(cfg, 'num_kv_heads', 0) or 0)
    kv_split = kv_shard_ways(num_kv, ways) > 1
    blocks, table, head, _ = edges(model)
    axes = {}
    for i, block in enumerate(getattr(model, blocks)):
        for name, axis in block_axes(block, ways, kv_split).items():
            axes[f'{blocks}.{i}.{name}'] = axis
    for name in dict.fromkeys((table, head)):
        axes[name] = 'vocab'
    return kv_split, axes


def shard_model(model, index: int, ways: int) -> Dict[str, object]:
    """Slice `model`'s tensor leaves to shard `index` of `ways` in place:
    each block's (`shard_block`), and the token table and head by vocab
    rows (padded, `vocab_rows`); returns `model_axes`."""
    cfg = model.config
    kv_split, axes = model_axes(model, ways)
    num_kv = int(getattr(cfg, 'num_kv_heads', 0) or 0)
    read = (remainder_read_heads(cfg.num_heads, num_kv, index, ways)
            if num_kv else None)
    blocks, table, head, _ = edges(model)
    for block in getattr(model, blocks):
        shard_block(block, index, ways, kv_split, read)
    for name in dict.fromkeys((table, head)):
        whole = getattr(model, name)
        setattr(model, name, nn.Parameter(
            vocab_piece(whole.detach(), index, ways),
            requires_grad=whole.requires_grad))
    model.tensor_shard = (index, ways)
    return axes


def local_shards(model, devices: Sequence) -> Tuple[LocalTensor,
                                                    Dict[int, nn.Module],
                                                    Dict[str, object]]:
    """The in-process form: (the group, {shard: model}, `model_axes`).
    Shard 0 is `model` itself, sliced in place on devices[0] (the
    model's device); shard t > 0 is built on the meta device and takes
    its slices of the model's tensors on devices[t] and shard 0's whole
    parameters themselves (so a whole leaf read inside a region needs
    the shards on one device)."""
    group = LocalTensor(devices)
    ways = group.size
    if model.device != group.home:
        raise ValueError(f'the model is on {model.device}; shard 0 of '
                         f'{[str(d) for d in group.devices]} must hold it')
    whole = dict(model.named_parameters())
    _, axes = model_axes(model, ways)
    shards = {}
    for t in range(1, ways):
        with torch.device('meta'):
            shard = type(model)(model.config)
        shard_model(shard, t, ways)
        for name, axis in axes.items():
            if axis == 'sum':
                continue
            src = whole[name].detach()
            part = (vocab_piece(src, t, ways) if axis == 'vocab'
                    else piece(src, axis, t, ways))
            replace_param(shard, name, part.to(group.devices[t], copy=True))
        shards[t] = shard
    shard_model(model, 0, ways)
    for shard in shards.values():
        for name, p in model.named_parameters():
            if axes.get(name) in (None, 'sum'):
                replace_param(shard, name, p)
    shards[0] = model
    return group, dict(sorted(shards.items())), axes


# -- the sharded forward -----------------------------------------------------------
def embed(shards: Dict[int, nn.Module], group, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The vocab-parallel embedding of `tokens`: each shard's masked
    lookup in its rows of the table (zeros where another shard owns the
    id), summed over the shards, in the compute dtype."""
    home = shards[group.local[0]]
    _, table, _, _ = edges(home)
    parts = {}
    for t, toks in to_shards(group, tokens).items():
        rows = getattr(shards[t], table)
        lo = t * rows.shape[0]
        local = toks.long() - lo
        owned = (local >= 0) & (local < rows.shape[0])
        x = rows[local.clamp(0, rows.shape[0] - 1)].to(home.config.dtype)
        parts[t] = torch.where(owned[..., None], x,
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    return group.reduce(parts)


def hidden(shards: Dict[int, nn.Module], group, tokens: torch.Tensor,
           positions: Optional[torch.Tensor] = None,
           lora: Optional[Dict[int, dict]] = None, lora_scale: float = 1.0,
           with_aux: bool = False):
    """The final-norm hidden states [B, S, embed] of `tokens` through the
    shards (the family's `hidden` in training mode, no cache); with
    `with_aux` (Mixtral), (hidden, the layers' summed aux losses).
    `lora` = {shard: {'layer_i': {target: {'a', 'b'}}}} (the shard's
    factor slices)."""
    from torch.utils import checkpoint
    home = shards[group.local[0]]
    cfg = home.config
    blocks_attr, _, _, norm = edges(home)
    batch, seq = tokens.shape
    x = embed(shards, group, tokens)
    if hasattr(home, 'wpe'):
        x = x + home.position_embed(positions, seq)
    if positions is None:
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=tokens.device).expand(batch, seq)
    pos = to_shards(group, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block_cls = type(getattr(home, blocks_attr)[0])
    one = len(group.local) == 1
    for i in range(cfg.num_layers):
        blocks = {t: getattr(m, blocks_attr)[i] for t, m in shards.items()}
        kw = {}
        if lora is not None:
            kw = {'lora': {t: lora[t].get(f'layer_{i}') for t in lora},
                  'lora_scale': lora_scale}
            if one:
                kw['lora'] = kw['lora'][group.index]
        if with_aux:
            kw['with_aux'] = True

        def step(x, blocks=blocks, kw=kw):
            if one:
                # Through the block's own call, so that a sharding
                # wrapper's hooks (FSDP2's gathers) run around it.
                t = group.index
                return blocks[t](x, pos[t], tensor=group, **kw)
            return block_cls.tensor_forward(blocks, group, x, pos, **kw)

        out = (checkpoint.checkpoint(step, x, use_reentrant=False)
               if remat else step(x))
        if with_aux:
            x, aux = out
            total_aux = total_aux + aux
        else:
            x = out
    h = getattr(home, norm)(x)
    return (h, total_aux) if with_aux else h


def row_bias(module: nn.Module, dtype: torch.dtype):
    """A row-parallel projection's bias in the compute dtype (added once
    after the sum), or 0."""
    bias = getattr(module, 'bias', None)
    return 0 if bias is None else bias.to(dtype)


class LocalLayout:
    """The sharded trainer's layout for tensor shards in process
    (parallel/train.py `ShardedTrainer(devices=...)`): the shards of
    `local_shards`, every leaf once (shard 0's whole leaves, each
    shard's slices), the gradients as backward leaves them (a shared
    whole leaf sums its shards' parts itself) and the loss computed by
    `compute_loss(params, tokens)`."""

    def __init__(self, model, devices: Sequence, compute_loss) -> None:
        #: The whole leaves' shapes.
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.group, self.shards, self.axes = local_shards(model, devices)
        self.unit = compute_loss

    def whole(self, values: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """{model name: whole tensor} of values keyed as `params()`
        names them (the params, or a moment keyed alike): each sliced
        leaf joined from its shards."""
        out = {}
        for name, shape in self.shapes.items():
            axis = self.axes.get(name)
            if axis in (None, 'sum'):
                out[name] = values[name]
                continue
            out[name] = join_pieces(
                [values[name]] + [values[f'{name}@{t}']
                                  for t in self.group.local[1:]],
                axis, shape)
        return out

    def params(self) -> Dict[str, torch.Tensor]:
        """{name: leaf}: the model's own (shard 0's), then each other
        shard's slices as `name@t`."""
        out = dict(self.shards[0].named_parameters())
        for t, shard in self.shards.items():
            if t:
                out.update((f'{n}@{t}', p) for n, p in
                           shard.named_parameters()
                           if self.axes.get(n) not in (None, 'sum'))
        return out

    def bind(self, leaves, names) -> None:
        del leaves, names

    def pieces(self, leaves):
        return list(leaves)

    def reduce_grads(self, leaves):
        grads = []
        for t in leaves:
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            grads.append(g)
        return grads

    def global_sq(self, grads) -> torch.Tensor:
        home = self.group.home
        return sum((g.float().square().sum().to(home) for g in grads),
                   torch.zeros((), dtype=torch.float32, device=home))

    @staticmethod
    def mean(x: torch.Tensor) -> torch.Tensor:
        return x.detach()

    def gather_updates(self, leaves) -> None:
        del leaves


# -- controls ------------------------------------------------------------------
#: The faults `tensor_fault` knows.
FAULTS = ('copy_skipped', 'max_dropped', 'reduce_skipped')


@contextlib.contextmanager
def tensor_fault(name: Optional[str]):
    """The tensor path broken on purpose, for the controls that a
    parity check must fail: 'copy_skipped' drops the backward sum of
    every sharded region's input (over ranks and in process: each shard
    keeps its own part of the gradient); 'max_dropped' drops the
    vocab-parallel max (each slice normalizes by its own row maxima);
    'reduce_skipped' drops the forward sum of a sharded region's
    partial outputs (each shard goes on with its own part). None: as it
    is."""
    from skypilot_tpu_torch.ops import fused_xent
    if name is None:
        yield
        return
    if name == 'copy_skipped':
        patches = [(_CopyTo, 'backward',
                    staticmethod(lambda ctx, grad: (grad, None))),
                   (_Scatter, 'backward',
                    staticmethod(lambda ctx, *grads: (
                        grads[0].to(ctx.dtype), None)))]
    elif name == 'max_dropped':
        patches = [(fused_xent, '_global_max', lambda group, maxes: maxes)]
    elif name == 'reduce_skipped':
        patches = [(_ReduceFrom, 'forward',
                    staticmethod(lambda ctx, x, group: x.clone())),
                   (_Gather, 'forward',
                    staticmethod(lambda ctx, *parts: (
                        setattr(ctx, 'devices', [p.device for p in parts])
                        or parts[0].clone())))]
    else:
        raise ValueError(f'unknown tensor fault {name!r}; one of {FAULTS}')
    saved = [(owner, attr, owner.__dict__[attr])
             for owner, attr, _ in patches]
    for owner, attr, value in patches:
        setattr(owner, attr, value)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
