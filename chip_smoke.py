#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch/) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (`serve_lm --continuous-batching` on a
paged KV pool, base model and multi-LoRA, whole-prompt long prefill,
SSE streams, text and chat endpoints, logprobs, `--hf` checkpoints and
the one-shot engine; training through the trainer API and `train_lm
--lora`) through the
entry points a user calls, at the full width of Llama-3-8B with seeded
random weights and adapters, and holds every CUDA kernel of those paths
against its plain PyTorch version. Phases, one JSON line each; any
failure exits non-zero before the result lines:

  device         card name and power limit, torch/CUDA versions
  build          nvcc build of every kernel from skypilot_tpu_torch/csrc
  kernels        paged attention at Llama-3-8B's head shape (Hq=32,
                 Hkv=8, D=128) vs its plain version, for {bf16, int8, f32}
                 pools x {decode B=8 (rows ending mid-page, on a page
                 and on a split boundary, past it, at full length beside
                 rows whose later splits are empty, and a row that sees
                 nothing), B=1 context 4096, page size 8, S=4, B=32
                 (one split a row); chunks of
                 256 at offsets 300 and 768, S=64 on page size 8; a
                 speculative verify chunk B=8 S=5 (K=4), every row at its
                 own position, rows ending mid-page, on a page's last
                 slot and on its first; and at
                 Qwen2-7B's heads (Hq=28, Hkv=4: G=7) decode B=8 and a
                 chunk of 256}: each
                 call takes its route (split for bf16/int8 decode, chunk
                 for bf16/int8 chunks, scalar for f32) and its error is
                 |x - plain| / |plain| (Frobenius) in the worst unit (a
                 (batch row, q head) vector at decode and in the verify
                 chunk, a 128-row tile of one in a chunk) within 6e-3
                 (bf16, int8) or 1e-5 (f32);
                 rows that see nothing exactly 0; the perturbed control
                 fails both new routes; device-time (spun, L2-cold)
                 timings at decode B in {1, 8, 32}, the chunk at
                 offset 768 and the verify chunk vs the bound, the plain
                 version and scaled_dot_product_attention on gathered
                 K/V (a boolean mask for the chunks)
  lora_kernels   QKV LoRA at Llama-3-8B width (d=4096, q 4096, k/v
                 1024), ranks {8, 16, 64} x {bf16, f32} x {decode B=8
                 S=1 with ids [0,1,1,2,3,0,2,1], chunk B=1 S=256} vs its
                 plain version within 1e-5 (max-abs), id-0 rows exactly
                 0; per dtype also rank 12, decode B=32 over 9 slots,
                 decode B=64, all rows under one adapter, all under
                 distinct ones, rows whose id is N (NaN, the others
                 right), Qwen2-7B's widths (d 3584, q 3584, k/v 512:
                 decode B=8 and a chunk B=2 S=100) and widths of 4100 /
                 1028 (no 16-byte copy); two calls bit-identical; one
                 call captured in a CUDA graph replays right on new x
                 and ids; the perturbed control must fail; L2-cold
                 timings (bf16, r 16 and 64, decode B=8, B=32 over 9
                 slots, chunk of 256) vs the bound, the plain version,
                 the gathered-bmm route and one near-empty launch
  serve_bf16,    build_runtime with serve_lm's flags, make_server on an
  serve_int8     ephemeral port, 8 concurrent greedy /generate requests
                 (300-700 prompt tokens, two sharing a 256-token
                 prefix, 32 new tokens), in the default decode loop
                 (pipelined, each step a CUDA-graph replay); every answer
                 has prompt + 32 tokens, the kernel's launch count grew
                 and the plain route was never taken; no LoRA code runs
  serve_lora     the same weights with --adapter-dir (3 seeded adapters:
                 attn r8, attn r16, attn-mlp r16) --max-adapters 3 and a
                 bf16 pool: 8 concurrent requests (2 base, 2 per adapter,
                 two under different adapters sharing a 256-token
                 prefix); then prefix hits only within a tenant, a 4th
                 adapter hot-loads with one eviction, an unknown model
                 is a 404; both kernels launched, no plain call
  flash_kernels  the flash forward and fused backward (dQ, dK, dV)
                 kernels vs their plain versions (D=128) at training's
                 shape (bf16 B=8 S=2048 Hq=32 Hkv=8), a long prefill's
                 (bf16 B=1 S=2300), Qwen2-7B's heads (bf16 B=1 S=2048
                 Hq=28 Hkv=4) and {bf16, f32} x {B=1 S=2048 Hq=32
                 Hkv=8, B=2 S=1000 Hq=8 Hkv=2}: the norm of the error over
                 that of the plain result, in every 128-row tile of each
                 batch row and head, within 6e-3 (bf16) or 1e-5 (f32);
                 query row 0 (which sees only key 0) exactly v[0]; the
                 perturbed control fails both; two backward runs on the
                 same inputs give bit-identical dK and dV (dQ's atomics
                 may differ: its largest difference is reported);
                 L2-cold timings at the training shape vs the bound, the
                 plain versions and scaled_dot_product_attention fwd /
                 bwd
  serve_long     serve_lm's flags with --prefill-chunk 0 --max-total-len
                 4096: 3 prompts of 2048-2600 tokens prefill whole
                 through the flash forward (32 launches each), 8 new
                 tokens each
  graph_round    one decode round of the 32-layer model (8 rows, bf16
                 pool of random history) captured into a CUDA graph and
                 replayed on new inputs: logits bit-identical to the same
                 round run eagerly
  decode_modes   serve_bf16's weights through serve_lm's flags, 8 slots,
                 the 8 prompts, 32 greedy tokens: (a) --no-pipeline-decode
                 with graphs off, (b) pipelined with graphs off, (c) the
                 default (pipelined, graphs), (d) --decode-chunk 4 on the
                 bf16 pool, (a) and (c) on the int8 pool and with
                 serve_lora's adapters; (b), (c) and (d) give (a)'s
                 tokens on every request; split-route launches = layers x
                 decode steps (graph replays counted); then (e)
                 --speculative 4: every answer prompt + 32 tokens, more
                 than one token a verify call, its verify chunks (chunk
                 route, S=5) launched layers x calls; per run the steady
                 round ms, tokens a call, decode stall, graph replays and
                 launches per route; no plain call
  greedy_parity  a 2-layer model at Llama-3-8B width (f32 weights and
                 pool): the engine's greedy tokens through the kernels
                 equal those through the plain versions (4 base and 2
                 adapter requests x 16; and 2 prompts of 2100 / 2600
                 tokens prefilled whole, through the flash forward), and
                 --speculative 4 and --decode-chunk 4 engines give the
                 plain engine's tokens exactly; so do the one-shot
                 generate functions (plain and speculative K=4, dense
                 cache) on the first two base requests
  serve_stream   serve_lora's weights, flags and adapters: the 8 prompts
                 as concurrent /generate SSE streams of 32 tokens (two
                 under adapters); each row's streamed tokens equal its
                 terminal event's row and the non-streamed /generate row
                 of a runtime with the same flags; paged and QKV LoRA
                 kernels launched, no plain call; a client that hangs up
                 after 4 events frees its slot and nothing more is
                 committed for it; stream TTFT and commit-time ITL
  serve_text     a stand-in byte-level tokenizer (the card has no
                 transformers), prefix caching off: /generate_text,
                 text /v1/completions with a stop string and
                 /v1/chat/completions (no template), plain and streamed,
                 each equal to decoding /generate's ids for the same
                 prompt; then at --max-total-len 4096 a logprobs=5,
                 echo completion of a 2150-token prompt: its scoring
                 pass (bucket 4096) launches flash_fwd once per layer,
                 its token_logprobs lie within 0.1 nats on average and
                 0.5 at most of the same pass on the plain versions
                 (beside the plain pass that rounds P to bf16 as the
                 kernel does: this model's bf16 noise floor), and each
                 generated token is the pass's top alternative where
                 the top-2 margin exceeds 0.5
  one_shot       serve_lm's flags without --continuous-batching at
                 --max-total-len 128: two greedy 48-token rows run the
                 whole bucket (127 eager steps) through the dense cache;
                 the continuous engine's rows, --speculative 4's and a
                 stream's (the lazy stream engine, paged launches) may
                 part from them only at a top-2 margin <= 0.5 (bf16
                 routes that sum in other orders; exact in f32, see
                 greedy_parity)
  serve_hf       a Llama-3-8B-width checkpoint cut to 2 layers, written
                 here in HF's layout (two bf16 safetensors shards and an
                 index), served through serve_lm --hf: weights on the card
                 bit-identical to the seeded model's, greedy tokens equal
                 a runtime built from that model, /v1/models names
                 hf:hf_llama; the checkpoint is deleted after
  train_full     ShardedTrainer on Llama-3-8B width cut to 4 layers (f32
                 params + Adam: 1.9e9 params, ~31 GB), B=8 S=2048:
                 step-1 loss and grad norm through the kernels vs the
                 plain route within 1e-3 (bf16 activations), then 4
                 steps: flash launches = 4 layers x 4 steps per kernel;
                 step time, tokens/s, MFU (6 x tokens/s x every
                 parameter but the embedding table, over the bf16 peak)
  train_lora     `train_lm --model llama3-8b --lora 16 --seq 2048
                 --remat` at full depth: 4 steps with checkpoints every
                 2, a relaunch to 6 resumes from step 4; forward launches
                 = 32 x 6 x 2 (remat), backward 32 x 6; then
                 serve_lm --adapter-dir answers a request with the
                 trained adapter

The paged kernel's split and chunk rows in the kernels line count their
launches in the base-serving window (serve_bf16 + serve_int8, counted
from zero, graph replays included; no scalar-route launch may occur
there), its verify row those of decode_modes' (e) run;
the flash kernels' launch counts are those of the two training phases,
each counted from zero. Then, as the last three lines: the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`), the kernels JSON
line, and {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores
# Paged attention tolerances on |x - plain| / |plain| (Frobenius) in the
# worst unit (each (batch row, q head) vector at decode, each 128-row tile
# of a (batch row, head) in a chunk): f32 sums in another order; the
# bf16 and int8 routes round P to bf16 (chunk) and the output to bf16.
PAGED_TOL = {'f32': 1e-5, 'bf16': 6e-3, 'int8': 6e-3}
PAGED_TILE = 128
L2_FLUSH_BYTES = 64e6   # more K/V than the 50 MB L2 per timed cycle
# A speculative verify chunk (K=4): 8 rows of K+1 queries, each row at
# its own position, ending mid-page, on a page's last slot (15, 47, 1023)
# and on its first (16, 512).
VERIFY_ENDS = [999, 1023, 15, 16, 512, 776, 47, 300]
VERIFY_S = 5
PAGED_TIMED = (('decode_b1', 1, 1), ('decode_b8', 8, 1), ('decode_b32', 32, 1),
               ('chunk_offset768', 1, 256), ('verify_b8', 8, 5))
HQ, HKV, D, PAGE = 32, 8, 128, 16
QWEN2_7B_HEADS = (28, 4)       # models/registry.py qwen2-7b: G = 7
PAGED_ATTENTION_TPU = 'skypilot_tpu/ops/pallas_paged.py:224'
QKV_LORA_TPU = 'skypilot_tpu/ops/pallas_paged.py:386'
# Both the kernel and its plain version accumulate in f32 from the same
# (bf16 or f32) inputs; only the order of the sums differs.
LORA_TOL = 1e-5
D_MODEL, D_Q, D_KV = 4096, 4096, 1024
FLASH_TPU = 'jax/experimental/pallas/ops/tpu/flash_attention.py'
FLASH_REPLACES = {'flash_fwd': f'{FLASH_TPU}:331',
                  'flash_bwd': f'{FLASH_TPU}:796 and {FLASH_TPU}:1146'}
# Flash tolerances on |x - plain| / |plain| (Frobenius norms) over every
# 128-row tile of one batch row and head, the worst tile: f32 sums over
# up to 2600 keys in another order; bf16 rounds P and dS to bf16 before
# their products (as upstream does) and the outputs to bf16.
FLASH_TOL = {'f32': 1e-5, 'bf16': 6e-3}
FLASH_TILE = 128
# Step-1 loss and grad norm, kernel route vs plain route, relative: bf16
# activations everywhere; only attention's rounding differs.
TRAIN_TOL = 1e-3
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                    'chip_smoke')


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- kernels ---------------------------------------------------------------
def paged_case(kind, batch, seq, ctx_end, pps, seed, masked_rows=0,
               page=PAGE, heads=(HQ, HKV)):
    """Inputs at a head shape (q heads, kv heads; Llama-3-8B's by
    default). Row b's queries sit at positions ctx_end[b] - seq + 1 ..
    ctx_end[b]; the first `masked_rows` queries of row 0 see nothing
    (position -1)."""
    hq, hkv = heads
    dev = 'cuda'
    rng = np.random.default_rng(seed)
    total = batch * pps + 1
    tbl = (1 + rng.permutation(total - 1)[:batch * pps]).reshape(batch, pps)
    shape = (hkv, total, page, D)
    g = torch.Generator(dev).manual_seed(seed)
    if kind == 'int8':
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((total, page), generator=g, device=dev) * 0.02
        vs = torch.rand((total, page), generator=g, device=dev) * 0.02
        qdt = torch.bfloat16
    else:
        dt = torch.float32 if kind == 'f32' else torch.bfloat16
        k = torch.randn(shape, generator=g, device=dev).to(dt)
        v = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
        qdt = dt
    q = torch.randn((batch, seq, hq, D), generator=g, device=dev).to(qdt)
    pos = np.stack([np.arange(e - seq + 1, e + 1) for e in ctx_end])
    pos[0, :masked_rows] = -1
    pos = np.maximum(pos, -1).astype(np.int32)
    return dict(q=q, k_pages=k, v_pages=v,
                positions=torch.tensor(pos, device=dev),
                page_indices=torch.tensor(tbl, dtype=torch.int32, device=dev),
                k_scales=ks, v_scales=vs)


def call(pk, c, **kw):
    return pk.fused_paged_attention(
        c['q'], c['k_pages'], c['v_pages'], c['positions'],
        c['page_indices'], k_scales=c['k_scales'], v_scales=c['v_scales'],
        **kw)


def plain(pk, c):
    return pk.fused_paged_attention_reference(
        c['q'], c['k_pages'], c['v_pages'], c['positions'],
        c['page_indices'], k_scales=c['k_scales'], v_scales=c['v_scales'])


def must_bytes(c):
    """Bytes the call must move: q and out, the positions and table,
    and the K/V (and scale) bytes of every token some query sees."""
    pos = c['positions'].cpu().numpy()
    visible = int(np.maximum(pos.max(axis=1) + 1, 0).sum())  # tokens
    kv = c['k_pages']
    per_token = 2 * kv.shape[0] * D * kv.element_size()
    if c['k_scales'] is not None:
        per_token += 2 * 4
    io = 2 * c['q'].numel() * c['q'].element_size()
    idx = 4 * (c['positions'].numel() + c['page_indices'].numel())
    return visible * per_token + io + idx


def must_flops(c):
    """4 * D flops (q.k and p.v) per query head per (query, visible
    token) pair."""
    pos = c['positions'].cpu().numpy()
    return 4.0 * D * c['q'].shape[2] * float(np.maximum(pos + 1, 0).sum())


def bound_ms(c):
    t_bytes = must_bytes(c) / HBM_BYTES_PER_S
    peak = F32_FLOPS if c['q'].dtype == torch.float32 else BF16_FLOPS
    t_ops = must_flops(c) / peak
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(fns, iters=60, warmup=6):
    """Mean device ms per call over `iters` calls cycling through `fns`
    (each on its own inputs, so together they exceed the 50 MB L2 and
    every call finds its K/V cold, as a layer does in a real decode
    step). A device spin ahead of the timed calls outlasts their
    enqueue, so the events bracket back-to-back device work, not the
    host's launch rate."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * iters)  # pylint: disable=protected-access
    e0.record()
    for i in range(iters):
        fns[i % len(fns)]()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def paged_timing_sets(kind, batch, seq):
    """Input sets of one timed shape (context 1024, queries ending at
    position 1023; a verify chunk's rows end 61 positions apart from
    1023 down), enough that their K/V exceed the L2 together."""
    elt = 1 if kind == 'int8' else 2
    kv_bytes = batch * 1024 * HKV * D * elt * 2
    n_sets = max(2, math.ceil(L2_FLUSH_BYTES / kv_bytes))
    ends = ([1023 - 61 * i for i in range(batch)] if seq == VERIFY_S
            else [1023] * batch)
    return [paged_case(kind, batch, seq, ends, 64, seed=100 + i)
            for i in range(n_sets)]


def dense_kv(c):
    """K/V of the case gathered dense (bf16, [B, Hkv, T, D]) for the
    library yardstick; int8 pages are dequantized first."""
    from skypilot_tpu_torch.ops.paged_attention import _gather_kv
    k, v = _gather_kv(HKV, c['k_pages'], c['v_pages'], c['page_indices'],
                      c['k_scales'], c['v_scales'])
    return (k.to(torch.bfloat16).transpose(1, 2).contiguous(),
            v.to(torch.bfloat16).transpose(1, 2).contiguous())


def sdpa_fn(q, k, v, mask=None):
    """scaled_dot_product_attention over [B, H, S, D] (with a boolean
    mask if given); GQA through enable_gqa where this torch has it,
    else heads expanded first."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q[:1], k[:1], v[:1], enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        k2 = k.repeat_interleave(rep, dim=1)
        v2 = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2,
                                                      attn_mask=mask)


def paged_library_fn(c):
    """One PyTorch call for the same function on the case's K/V gathered
    dense: SDPA, with a boolean mask (token t <= position) for chunks."""
    k, v = dense_kv(c)
    q = c['q'].transpose(1, 2).contiguous()
    mask = None
    if q.shape[2] > 1:
        t = torch.arange(k.shape[2], device='cuda')
        mask = (t[None, None, :] <= c['positions'][:, :, None])[:, None]
    return sdpa_fn(q, k, v, mask)


def paged_errors(out, ref, tile):
    """|out - ref| / |ref| (Frobenius) in the worst unit, a unit being
    `tile` consecutive query positions of one (batch row, q head):
    1 at decode (each vector), 128 in a chunk. Units whose reference is
    0 (rows that see nothing) are left to the exact-zero check. Also
    the largest absolute error."""
    diff = (out.float() - ref.float()).square().sum(-1)     # [B, S, H]
    norm = ref.float().square().sum(-1)
    pad = -out.shape[1] % tile

    def units(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).unflatten(
            1, (-1, tile)).sum(2)

    d, n = units(diff), units(norm)
    rel = (d[n > 0] / n[n > 0]).sqrt()
    return (rel.max().item() if rel.numel() else 0.0,
            (out.float() - ref.float()).abs().max().item())


def paged_cases(pk):
    """(label, batch, seq, context ends, pages per row, masked queries
    of row 0, page size, (q heads, kv heads)) for every pool type.
    Decode rows end on split boundaries (the split route's cut for that
    shape on this card), just past them, and well before a full-length
    row; at B=32 each row is one split (its block writes the rows, with
    no merge). The g7 cases take Qwen2-7B's heads (Hq=28, Hkv=4: 7 query
    heads a kv head, so a 64-row chunk tile cuts across positions)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, n8, st8 = pk.split_plan(8, HKV, HQ // HKV, 64, PAGE, sms)
    _, _, n1, st1 = pk.split_plan(1, HKV, HQ // HKV, 256, PAGE, sms)
    llama, qwen = (HQ, HKV), QWEN2_7B_HEADS
    return (
        ('decode', 8, 1, [999, 1023, 0, 16, 511, 776, 1, 1022], 64, 1, PAGE,
         llama),
        ('decode_split_edges', 8, 1, [st8 - 1, st8, 2 * st8 - 1, 2 * st8,
                                      1023, 5, st8 + 2, 0], 64, 0, PAGE,
         llama),
        ('decode_ctx4096', 1, 1, [4095], 256, 0, PAGE, llama),
        ('decode_page8', 8, 1, [1023, 0, 7, 8, 500, 999, 255, 256], 128, 1,
         8, llama),
        ('decode_s4', 3, 4, [300, 1023, 64], 64, 2, PAGE, llama),
        ('decode_b32', 32, 1, [(37 * i) % 1024 for i in range(32)], 64, 1,
         PAGE, llama),
        ('chunk', 1, 256, [555], 48, 16, PAGE, llama),
        ('chunk_offset768', 1, 256, [1023], 64, 0, PAGE, llama),
        ('chunk_page8', 2, 64, [700, 130], 128, 3, 8, llama),
        ('decode_g7', 8, 1, [999, 1023, 0, 16, 511, 776, 1, 1022], 64, 1,
         PAGE, qwen),
        ('chunk_g7', 1, 256, [555], 48, 16, PAGE, qwen),
        ('verify_k4', 8, 5, VERIFY_ENDS, 64, 0, PAGE, llama)), \
        {'split_plan_b8': [n8, st8], 'split_plan_b1_ctx4096': [n1, st1]}


# (batch, S, max_total_len, extra tokens of table): an engine's width and
# a --decode-chunk / --speculative engine's write lookahead past it.
TAIL_CASES = ((1, 1, 4096, 16), (8, 1, 1024, 16), (32, 1, 1024, 16),
              (1, 1, 1000, 48), (8, 1, 4096, 64), (3, 4, 1024, 16))


def tail_split_identity(pk):
    """A call over a table `extra` tokens wider than the width it is cut
    for (attend_len) must give the narrower table's call the same bits
    on every row below that width: the same splits, then empty tail
    splits (at B=32 a row's one split alone against the same split
    merged with an empty tail). Also reports whether the cut made for
    each table's own width (no attend_len) would give the same bits."""
    out = []
    for kind in ('bf16', 'int8'):
        for batch, seq, width, extra in TAIL_CASES:
            narrow = -(-width // PAGE)
            wide = -(-(width + extra) // PAGE)
            rng = np.random.default_rng(batch * width + extra)
            ends = rng.integers(seq - 1, width, batch)
            ends[0] = width - 1
            c = paged_case(kind, batch, seq, ends.tolist(), wide,
                           seed=batch + extra)
            cut = dict(c, page_indices=c['page_indices'][:, :narrow]
                       .contiguous())
            a = call(pk, cut, attend_len=width)
            b = call(pk, c, attend_len=width)
            own = call(pk, c)
            torch.cuda.synchronize()
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out.append({
                'pool': kind, 'batch': batch, 'seq': seq, 'width': width,
                'table_tokens': wide * PAGE,
                'plan': pk.split_plan(batch, HKV, seq * HQ // HKV, wide,
                                      PAGE, sms, width)[2:],
                'plan_narrow': pk.split_plan(batch, HKV, seq * HQ // HKV,
                                             narrow, PAGE, sms, width)[2:],
                'bit_identical': bool(torch.equal(a, b)),
                'own_cut_bit_identical': bool(torch.equal(a, own)),
                'finite': bool(torch.isfinite(b.float()).all())})
    check(all(r['bit_identical'] and r['finite'] for r in out),
          f'tail splits changed the bits of rows below the width: {out}')
    return out


def expected_route(kind, seq, heads=(HQ, HKV)):
    if kind == 'f32':
        return 'scalar'
    return 'split' if seq * (heads[0] // heads[1]) <= 16 else 'chunk'


def phase_kernels(pk):
    cases = []
    worst = {'split': 0.0, 'chunk': 0.0, 'scalar': 0.0, 'verify': 0.0}
    shapes, plans = paged_cases(pk)
    for kind in ('bf16', 'int8', 'f32'):
        for label, batch, seq, ends, pps, masked, page, heads in shapes:
            c = paged_case(kind, batch, seq, ends, pps, seed=len(cases),
                           masked_rows=masked, page=page, heads=heads)
            routes0 = dict(pk.route_launches)
            out = call(pk, c)
            ref = plain(pk, c)
            torch.cuda.synchronize()
            route = [r for r in pk.ROUTES
                     if pk.route_launches[r] != routes0[r]]
            tile = 1 if label.startswith(('decode', 'verify')) \
                else PAGED_TILE
            rel, err = paged_errors(out, ref, tile)
            pos = c['positions']
            masked_zero = bool((out[pos < 0].float() == 0).all())
            finite = bool(torch.isfinite(out.float()).all())
            case = {'pool': kind, 'shape': label, 'batch': batch,
                    'seq': seq, 'page': page, 'hq': heads[0],
                    'hkv': heads[1], 'route': route,
                    'unit_rel_err': rel, 'tol': PAGED_TOL[kind],
                    'max_abs_err': err, 'masked_rows_zero': masked_zero,
                    'finite': finite}
            cases.append(case)
            check(route == [expected_route(kind, seq, heads)],
                  f'paged attention took the wrong route: {case}')
            check(rel <= PAGED_TOL[kind] and masked_zero and finite,
                  f'kernel disagrees with its plain version: {case}')
            worst[route[0]] = max(worst[route[0]], err)
            if label.startswith('verify') and kind != 'f32':
                worst['verify'] = max(worst['verify'], err)
    perturb = {}
    controls = [next(c for c in shapes if c[0] == label)   # one a route
                for label in ('decode', 'chunk')]
    for label, batch, seq, ends, pps, masked, page, _ in controls:
        c = paged_case('bf16', batch, seq, ends, pps, seed=99,
                       masked_rows=masked, page=page)
        bad = call(pk, c, perturb=0.5)
        perturb[expected_route('bf16', seq)] = paged_errors(
            bad, plain(pk, c), 1 if seq == 1 else PAGED_TILE)[0]
    check(sorted(perturb) == ['chunk', 'split']
          and all(e > PAGED_TOL['bf16'] for e in perturb.values()),
          f'perturbed kernel passed the pin: {perturb}')
    tails = tail_split_identity(pk)

    # Timings: decode at B in {1, 8, 32}, context 1024, and a chunk of
    # 256 queries at offset 768; enough input sets that their K/V
    # exceed the 50 MB L2.
    timings = {}
    for kind in ('bf16', 'int8'):
        for label, batch, seq in PAGED_TIMED:
            sets = paged_timing_sets(kind, batch, seq)
            n_sets = len(sets)
            routes0 = dict(pk.route_launches)
            ms = time_ms([lambda c=c: call(pk, c) for c in sets],
                         iters=max(60, 3 * n_sets))
            route = [r for r in pk.ROUTES
                     if pk.route_launches[r] != routes0[r]]
            plain_ms = time_ms([lambda c=c: plain(pk, c) for c in sets[:2]],
                               iters=6, warmup=2)
            lib = [paged_library_fn(c) for c in sets]
            library_ms = time_ms(lib, iters=max(60, 3 * n_sets))
            del lib
            b_ms, b_by = bound_ms(sets[0])
            timings[f'{kind}_{label}'] = {
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                'bound_by': b_by, 'bytes': must_bytes(sets[0]),
                'flops': must_flops(sets[0]), 'library_ms': library_ms,
                'input_sets': n_sets, 'route': route}
            del sets
            torch.cuda.empty_cache()
    emit('kernels', cases=cases, perturb_unit_rel_err=perturb,
         perturb_fails=True, split_plans=plans, tail_splits=tails,
         timings=timings, kernels=['paged_attention'])
    rows = []
    for name, route, key, err_key, library in (
            ('paged_attention', 'split', 'bf16_decode_b8', 'split',
             'scaled_dot_product_attention on gathered K/V'),
            ('paged_attention_chunk', 'chunk', 'bf16_chunk_offset768',
             'chunk', 'scaled_dot_product_attention with a boolean mask '
                      'on gathered K/V'),
            ('paged_attention_verify', 'chunk', 'bf16_verify_b8', 'verify',
             'scaled_dot_product_attention with a boolean mask on '
             'gathered K/V')):
        t = timings[key]
        rows.append({'name': name, 'route': 'cuda',
                     'source': 'skypilot_tpu_torch/csrc/paged_attention.cu',
                     'replaces': PAGED_ATTENTION_TPU,
                     'kernel_route': route, 'timed': key,
                     'max_abs_err': worst[err_key], 'ms': t['ms'],
                     'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
                     'bound_by': t['bound_by'],
                     'library_ms': t['library_ms'], 'library': library})
    return rows


# -- QKV LoRA kernel --------------------------------------------------------
def lora_case(dtype, rank, batch, seq, ids, seed, n_adapters=4,
              widths=(D_MODEL, D_Q, D_KV)):
    """Stacked factors (row 0 zeros: the base model) and inputs on the
    card, at `widths` = (d_in, d_q, d_kv): Llama-3-8B's by default."""
    d_in, d_q, d_kv = widths
    g = torch.Generator('cuda').manual_seed(seed)

    def factors(d_out):
        a = torch.randn((n_adapters, d_in, rank), generator=g,
                        device='cuda') * 0.02
        b = torch.randn((n_adapters, rank, d_out), generator=g,
                        device='cuda') * 0.02
        a[0] = 0
        b[0] = 0
        return {'a': a.to(dtype), 'b': b.to(dtype)}

    x = torch.randn((batch, seq, d_in), generator=g, device='cuda').to(dtype)
    return {'x': x, 'f': [factors(d_q), factors(d_kv), factors(d_kv)],
            'ids': torch.tensor(ids, dtype=torch.int32, device='cuda')}


def lora_bound_ms(c):
    """Larger of: bytes (x, the q/k/v factors of every distinct id in
    the batch, id 0 included, and the f32 outputs) over HBM, and
    2*B*S*(3*d_in*r + r*sum(d_out)) flops over the peak for the
    factors' type: bf16 products are exact in f32, so bf16 tensor cores
    accumulating in f32 compute the same function."""
    x = c['x']
    batch, seq, d_in = x.shape
    rank = c['f'][0]['a'].shape[2]
    d_outs = sum(f['b'].shape[2] for f in c['f'])
    peak = F32_FLOPS if c['f'][0]['a'].dtype == torch.float32 \
        else BF16_FLOPS
    distinct = len(set(c['ids'].tolist()))
    per_row = sum(f[k][0].numel() * f[k].element_size() for f in c['f']
                  for k in ('a', 'b'))
    n_bytes = x.numel() * x.element_size() + distinct * per_row \
        + 4 * batch * seq * d_outs + 4 * batch
    flops = 2.0 * batch * seq * (3 * d_in * rank + rank * d_outs)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations'), n_bytes


def time_cold_ms(fn, iters=40, warmup=4):
    """Mean ms per call, each call timed alone by CUDA events right
    after a 64 MB write that evicts the 50 MB L2 (a layer's factors
    are cold when its step reaches them). A ~1 ms device spin ahead of
    each call keeps the card busy while the host enqueues the call, so
    the events see device time, not the host's launch latency."""
    flush = torch.empty(16 << 20, dtype=torch.float32, device='cuda')
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)  # pylint: disable=protected-access
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def launch_floor_ms():
    """`time_cold_ms` of one near-empty launch: the device time any
    one-launch call pays before its work."""
    return time_cold_ms(
        lambda: torch.cuda._sleep(0))  # pylint: disable=protected-access


def gathered_bmm(c):
    """The yardstick: one gathered `torch.bmm` chain per projection."""
    x, ids = c['x'], c['ids']
    return [torch.bmm(torch.bmm(x.float(), f['a'][ids].float()),
                      f['b'][ids].float()) for f in c['f']]


QWEN2_7B_WIDTHS = (3584, 3584, 512)    # models/registry.py qwen2-7b
# Widths no 16-byte copy fits (d % 8 = 4): the kernel's element-wise
# copy and store paths.
UNALIGNED_WIDTHS = (4100, 4100, 1028)
LORA_IDS_B8 = [0, 1, 1, 2, 3, 0, 2, 1]
# Timed shapes: (label, batch, seq, ids, adapter slots).
LORA_TIMED = (('decode', 8, 1, LORA_IDS_B8, 4),
              ('decode_b32_9slots', 32, 1, [i % 9 for i in range(32)], 9),
              ('chunk', 1, 256, [2], 4))


def lora_cases():
    """(label, dtype, rank, batch, seq, ids, slots, widths) of every
    correctness case: PR 2's ranks x dtypes x {decode B=8, chunk of
    256}, then a rank that is not a multiple of 8, 32 rows over 9 slots,
    64 rows (the grouping for more than 32 rows), one adapter, all
    distinct, an id = N (its row must be NaN), Qwen2-7B's widths
    (d_in / 8 = 448, k/v of 512 columns) and widths no 16-byte copy
    fits."""
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for rank in (8, 16, 64):
            out += [('decode', dtype, rank, 8, 1, LORA_IDS_B8, 4, None),
                    ('chunk', dtype, rank, 1, 256, [2], 4, None)]
        out += [('decode_rank12', dtype, 12, 8, 1, LORA_IDS_B8, 4, None),
                ('chunk_rank12', dtype, 12, 1, 256, [2], 4, None),
                ('decode_b32_9slots', dtype, 16, 32, 1,
                 [i % 9 for i in range(32)], 9, None),
                ('decode_b64', dtype, 16, 64, 1,
                 [(7 * i) % 6 for i in range(64)], 6, None),
                ('decode_one_adapter', dtype, 16, 8, 1, [3] * 8, 4, None),
                ('decode_distinct', dtype, 16, 8, 1,
                 [5, 0, 7, 2, 6, 1, 4, 3], 8, None),
                ('decode_id_n', dtype, 16, 8, 1, [1, 0, 4, 2, 3, 0, 4, 1],
                 4, None),
                ('decode_qwen2_7b', dtype, 16, 8, 1, LORA_IDS_B8, 4,
                 QWEN2_7B_WIDTHS),
                ('chunk_qwen2_7b', dtype, 16, 2, 100, [1, 1], 4,
                 QWEN2_7B_WIDTHS),
                ('decode_unaligned_widths', dtype, 16, 8, 1, LORA_IDS_B8, 4,
                 UNALIGNED_WIDTHS)]
    return out


def lora_check_case(lk, label, dtype, rank, batch, seq, ids, slots, widths,
                    seed):
    """The kernel vs its plain version on one case: rows whose id is out
    of range must be NaN; the others within LORA_TOL (max-abs), id-0
    rows exactly 0, finite, of the expected shapes."""
    c = lora_case(dtype, rank, batch, seq, ids, seed, n_adapters=slots,
                  widths=widths or (D_MODEL, D_Q, D_KV))
    out = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'])
    valid = (c['ids'] >= 0) & (c['ids'] < slots)
    # The plain version indexes the stacks: only rows with a valid id.
    ref = lk.fused_qkv_lora_delta_reference(c['x'][valid], *c['f'],
                                            c['ids'][valid])
    torch.cuda.synchronize()
    err = max((o[valid] - r).abs().max().item() for o, r in zip(out, ref))
    nan_rows = all(bool(o[~valid].isnan().all()) for o in out)
    base_zero = all(not o[c['ids'] == 0].any() for o in out)
    finite = all(bool(torch.isfinite(o[valid]).all()) for o in out)
    shape_ok = [tuple(o.shape[:2]) for o in out] == [(batch, seq)] * 3 \
        and [o.shape[2] for o in out] == [f['b'].shape[2] for f in c['f']]
    case = {'shape': label, 'dtype': str(dtype).split('.')[-1],
            'rank': rank, 'batch': batch, 'seq': seq, 'slots': slots,
            'd_in': c['x'].shape[2], 'max_abs_err': err, 'tol': LORA_TOL,
            'nan_rows': int((~valid).sum()), 'nan_rows_nan': nan_rows,
            'base_rows_zero': base_zero, 'finite': finite}
    check(err <= LORA_TOL and base_zero and finite and shape_ok
          and nan_rows, f'QKV LoRA kernel disagrees with its plain '
                        f'version: {case}')
    return case


def lora_graph_replay(lk):
    """One call captured in a CUDA graph; new x and ids contents copied
    into its inputs; the replay against the plain version on them."""
    c = lora_case(torch.bfloat16, 16, 8, 1, LORA_IDS_B8, seed=300)
    x, ids = c['x'].clone(), c['ids'].clone()
    lk.fused_qkv_lora_delta(x, *c['f'], ids)      # first use outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = lk.fused_qkv_lora_delta(x, *c['f'], ids)
    new = lora_case(torch.bfloat16, 16, 8, 1, [3, 3, 0, 1, 2, 2, 1, 0],
                    seed=301)
    x.copy_(new['x'])
    ids.copy_(new['ids'])
    graph.replay()
    ref = lk.fused_qkv_lora_delta_reference(new['x'], *c['f'], new['ids'])
    torch.cuda.synchronize()
    return max((o - r).abs().max().item() for o, r in zip(outs, ref))


def phase_lora_kernels(lk):
    cases = [lora_check_case(lk, *spec, seed=i)
             for i, spec in enumerate(lora_cases())]
    c = lora_case(torch.bfloat16, 16, 8, 1, LORA_IDS_B8, seed=99)
    bad = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'], perturb=0.5)
    ref = lk.fused_qkv_lora_delta_reference(c['x'], *c['f'], c['ids'])
    perturb_err = max((o - r).abs().max().item() for o, r in zip(bad, ref))
    check(perturb_err > LORA_TOL,
          f'perturbed LoRA kernel passed the pin (err {perturb_err})')
    identical = {}
    for label, batch, seq, ids, slots in LORA_TIMED:
        c = lora_case(torch.bfloat16, 16, batch, seq, ids, seed=98,
                      n_adapters=slots)
        one = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'])
        two = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'])
        identical[label] = all(bool(torch.equal(a, b))
                               for a, b in zip(one, two))
    check(all(identical.values()),
          f'two calls on the same inputs differ: {identical}')
    graph_err = lora_graph_replay(lk)
    check(graph_err <= LORA_TOL,
          f'CUDA-graph replay disagrees with the plain version: {graph_err}')

    timings = {}
    for rank in (16, 64):
        for label, batch, seq, ids, slots in LORA_TIMED:
            c = lora_case(torch.bfloat16, rank, batch, seq, ids, seed=200,
                          n_adapters=slots)
            args = (c['x'], *c['f'], c['ids'])
            b_ms, b_by, n_bytes = lora_bound_ms(c)
            timings[f'bf16_r{rank}_{label}'] = {
                'ms': time_cold_ms(lambda: lk.fused_qkv_lora_delta(*args)),
                'plain_ms': time_cold_ms(
                    lambda: lk.fused_qkv_lora_delta_reference(*args)),
                'library_ms': time_cold_ms(lambda: gathered_bmm(c)),
                'library': 'gathered torch.bmm per projection',
                'launch_floor_ms': launch_floor_ms(),
                'bound_ms': b_ms, 'bound_by': b_by, 'bytes': n_bytes,
                'device_launches_per_call': lk.DEVICE_LAUNCHES_PER_CALL}
    main = timings['bf16_r16_decode']
    emit('lora_kernels', cases=cases, perturb_err=perturb_err,
         perturb_fails=True, bit_identical=identical,
         graph_replay_max_abs_err=graph_err, timings=timings)
    return {'name': 'qkv_lora', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/qkv_lora.cu',
            'replaces': QKV_LORA_TPU, 'timed': 'bf16_r16_decode',
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': main['library_ms'],
            'launch_floor_ms': main['launch_floor_ms']}


# -- flash attention kernels ---------------------------------------------------
def flash_inputs(dtype, batch, seq, hq, hkv, seed):
    g = torch.Generator('cuda').manual_seed(seed)

    def mk(heads):
        return torch.randn((batch, seq, heads, D), generator=g,
                           device='cuda').to(dtype)

    return mk(hq), mk(hkv), mk(hkv), mk(hq)


def flash_errors(fk, case, perturb=0.0):
    """Each kernel vs its plain version on `case`: {kernel: (max abs
    err, worst tile's relative err, whole tensor's relative err)}, the
    backward the worst of dQ, dK and dV (each also under its own name);
    the backward is fed the plain forward's o and lse, so each kernel is
    held alone."""
    q, k, v, do = case
    scale = (1.0 + perturb) / math.sqrt(D)
    o, _ = fk.flash_forward_kernel(q, k, v, scale=scale)
    ro, rlse = fk.flash_forward_reference(q, k, v)
    di = fk.attention_di(ro, do)
    grads = fk.flash_backward_kernel(q, k, v, do, rlse, di, scale=scale)
    refs = fk.flash_backward_reference(q, k, v, do, rlse, di)
    torch.cuda.synchronize()

    def err(x, ref):
        """|x - ref| / |ref| over each FLASH_TILE rows of one batch row
        and head (x is [B, S, H, D]), and over the whole tensor."""
        diff = (x.float() - ref.float()).square().sum(-1)     # [B, S, H]
        norm = ref.float().square().sum(-1)
        pad = -x.shape[1] % FLASH_TILE

        def tiles(t):
            return torch.nn.functional.pad(t, (0, 0, 0, pad)).unflatten(
                1, (-1, FLASH_TILE)).sum(2)

        return ((x.float() - ref.float()).abs().max().item(),
                (tiles(diff) / tiles(norm)).sqrt().max().item(),
                (diff.sum() / norm.sum()).sqrt().item())

    per_grad = {n: err(x, r) for n, x, r in zip(('dq', 'dk', 'dv'), grads,
                                                  refs)}
    first = (o[:, 0].float() - v[:, 0].float().repeat_interleave(
        q.shape[2] // k.shape[2], dim=1)).abs().max().item()
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (o, *grads))
    return {'flash_fwd': err(o, ro),
            'flash_bwd': tuple(map(max, *per_grad.values()))}, \
        per_grad, first, finite


def flash_determinism(fk, case):
    """The backward twice on the same inputs: whether dK and dV are
    bit-identical, and dQ's largest difference (its key tiles are summed
    by atomics in whatever order the blocks reach them)."""
    q, k, v, do = case
    o, lse = fk.flash_forward_kernel(q, k, v)
    di = fk.attention_di(o, do)
    dq1, dk1, dv1 = fk.flash_backward_kernel(q, k, v, do, lse, di)
    dq2, dk2, dv2 = fk.flash_backward_kernel(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    return {'dk_dv_identical': bool(torch.equal(dk1, dk2)
                                    and torch.equal(dv1, dv2)),
            'dq_max_diff': (dq1.float() - dq2.float()).abs().max().item()}


def flash_bound_ms(batch, seq, hq, hkv, elt):
    """Least time per kernel at a shape: the larger of the bytes each
    must move (inputs read once, outputs written once; the backward's
    f32 dQ workspace is the kernel's own choice and does not count), and
    its causal flops (4 and 10 x D per visible (query, key) pair) over
    the bf16 (or f32) peak."""
    pairs = batch * hq * seq * (seq + 1) / 2
    io_q, io_kv = batch * seq * hq * D * elt, batch * seq * hkv * D * elt
    rows = batch * hq * seq * 4
    work = {'flash_fwd': (4, 2 * io_q + 2 * io_kv + rows),
            'flash_bwd': (10, 3 * io_q + 4 * io_kv + 2 * rows)}
    peak = BF16_FLOPS if elt == 2 else F32_FLOPS
    out = {}
    for name, (per_pair, n_bytes) in work.items():
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, per_pair * D * pairs / peak
        out[name] = (1e3 * max(t_bytes, t_ops),
                     'bytes' if t_bytes >= t_ops else 'operations', n_bytes)
    return out


FLASH_CASES = (   # (dtype, batch, seq, hq, hkv)
    ('bf16', 8, 2048, 32, 8),     # train_lm --seq 2048, Llama-3-8B
    ('bf16', 1, 2300, 32, 8),     # a serve_long whole-prompt prefill
    ('bf16', 1, 2048, 32, 8),
    ('bf16', 1, 2048, 28, 4),     # Qwen2-7B's heads: 7 q heads a kv head
    ('bf16', 2, 1000, 8, 2),
    ('f32', 1, 2048, 32, 8),
    ('f32', 2, 1000, 8, 2))


def phase_flash_kernels(fk):
    cases = []
    worst = {name: 0.0 for name in FLASH_REPLACES}
    for kind, batch, seq, hq, hkv in FLASH_CASES:
        dtype = torch.bfloat16 if kind == 'bf16' else torch.float32
        errs, per_grad, first, finite = flash_errors(
            fk, flash_inputs(dtype, batch, seq, hq, hkv, seed=len(cases)))
        case = {'dtype': kind, 'batch': batch, 'seq': seq, 'hq': hq,
                'hkv': hkv, 'tol': FLASH_TOL[kind], 'finite': finite,
                'first_row_err': first,
                **{n: {'max_abs_err': e, 'tile_rel_err': t, 'rel_err': r}
                   for n, (e, t, r) in errs.items()},
                'bwd_tile_rel_err': {n: t for n, (_, t, _) in
                                     per_grad.items()}}
        cases.append(case)
        check(finite and first == 0.0
              and all(t <= FLASH_TOL[kind] for _, t, _ in errs.values()),
              f'flash kernels disagree with their plain versions: {case}')
        for n, (e, _, _) in errs.items():
            worst[n] = max(worst[n], e)
        torch.cuda.empty_cache()
    bad, _, _, _ = flash_errors(fk, flash_inputs(torch.bfloat16, 1, 1000, 8,
                                                 2, seed=99), perturb=0.5)
    perturb = {n: t for n, (_, t, _) in bad.items()}
    check(all(t > FLASH_TOL['bf16'] for t in perturb.values()),
          f'a perturbed flash kernel passed the pin: {perturb}')

    # Timings at the training shape (Llama-3-8B, B=8, S=2048, bf16).
    import torch.nn.functional as F
    batch, seq = 8, 2048
    q, k, v, do = flash_inputs(torch.bfloat16, batch, seq, HQ, HKV, seed=7)
    determinism = flash_determinism(fk, (q, k, v, do))
    check(determinism['dk_dv_identical'],
          f'dK/dV differ between two backward runs: {determinism}')
    o, lse = fk.flash_forward_kernel(q, k, v)
    di = fk.attention_di(o, do)
    bounds = flash_bound_ms(batch, seq, HQ, HKV, 2)
    ms = {'flash_fwd': time_cold_ms(lambda: fk.flash_forward_kernel(q, k, v),
                                    iters=20),
          'flash_bwd': time_cold_ms(
              lambda: fk.flash_backward_kernel(q, k, v, do, lse, di),
              iters=20)}
    plain = {'flash_fwd': time_cold_ms(
        lambda: fk.flash_forward_reference(q, k, v), iters=3, warmup=1),
             'flash_bwd': time_cold_ms(
        lambda: fk.flash_backward_reference(q, k, v, do, lse, di),
        iters=3, warmup=1)}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = {'flash_fwd': time_cold_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)}
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    sdpa['flash_bwd'] = time_cold_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    timings = {n: {'ms': ms[n], 'bound_ms': bounds[n][0],
                   'bound_by': bounds[n][1], 'bytes': bounds[n][2]}
               for n in FLASH_REPLACES}
    emit('flash_kernels', cases=cases, perturb_tile_rel_err=perturb,
         perturb_fails=True, determinism=determinism,
         shape={'batch': batch, 'seq': seq, 'hq': HQ, 'hkv': HKV, 'd': D,
                'dtype': 'bf16'},
         timings=timings, plain_fwd_ms=plain['flash_fwd'],
         plain_bwd_ms=plain['flash_bwd'], sdpa_fwd_ms=sdpa['flash_fwd'],
         sdpa_bwd_ms=sdpa['flash_bwd'])
    rows = {}
    for n in FLASH_REPLACES:
        fwd = n == 'flash_fwd'
        rows[n] = {
            'name': n, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/flash_attention.cu',
            'replaces': FLASH_REPLACES[n], 'max_abs_err': worst[n],
            'ms': ms[n], 'plain_ms': plain[n],
            'bound_ms': bounds[n][0], 'bound_by': bounds[n][1],
            'library_ms': sdpa[n],
            'library': ('scaled_dot_product_attention' if fwd else
                        'scaled_dot_product_attention backward (dQ, dK '
                        'and dV together)'),
            'plain': ('flash_forward_reference' if fwd else
                      'flash_backward_reference (dQ, dK and dV together)')}
    return rows


def zero_paged(pk):
    pk.route_launches.update(dict.fromkeys(pk.ROUTES, 0))


def flash_counts(fk):
    return {'flash_fwd': fk.fwd_launches, 'flash_bwd': fk.bwd_launches}


def zero_flash(fk):
    fk.fwd_launches = fk.bwd_launches = fk.plain_calls = 0


# -- training -------------------------------------------------------------------
def phase_train_full(fk, pk, card):
    """The trainer API at Llama-3-8B width, 4 layers, B=8, S=2048."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.observability.step_metrics import matmul_params
    from skypilot_tpu_torch.parallel import train
    layers, steps, batch, seq = 4, 4, 8, 2048
    cfg = dataclasses.replace(registry.train_config('llama3-8b', seq),
                              num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    model = convert.init_params(cfg, seed=0, device='cuda')
    trainer = train.ShardedTrainer(
        model, tx=train.default_optimizer(warmup_steps=10, total_steps=20),
        collect_grad_norm=True)
    state = trainer.init()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = matmul_params(model.named_parameters())
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(steps)]

    def loss_and_norm(impl):
        with pk.impl_scope(impl):
            loss = trainer._compute_loss(state.params, toks[0])
            grads = torch.autograd.grad(loss, train.trainable_leaves(
                state.params))
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            return loss.item(), norm.item()

    plain0 = fk.plain_calls
    loss_plain, norm_plain = loss_and_norm('torch')
    check(fk.plain_calls - plain0 == 2 * layers, 'plain route not taken')
    loss_cuda, norm_cuda = loss_and_norm('cuda')
    check(abs(loss_cuda - loss_plain) <= TRAIN_TOL * abs(loss_plain) and
          abs(norm_cuda - norm_plain) <= TRAIN_TOL * abs(norm_plain),
          f'step-1 loss/grad norm: kernels {loss_cuda}/{norm_cuda}, plain '
          f'{loss_plain}/{norm_plain}')

    zero_flash(fk)
    step = trainer.make_train_step()
    losses, times = [], []
    for tokens in toks:
        t0 = time.perf_counter()
        state, (loss, gnorm) = step(state, tokens)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    counts = flash_counts(fk)
    check(all(c == layers * steps for c in counts.values())
          and fk.plain_calls == 0, f'train_full launches {counts}')
    check(all(np.isfinite(losses)), f'losses {losses}')
    step_s = float(np.mean(times[1:]))
    tps = batch * seq / step_s
    emit('train_full', card=card, layers=layers, steps=steps, batch=batch,
         seq=seq, params=n_params, matmul_params=n_matmul,
         loss_cuda=loss_cuda, loss_plain=loss_plain,
         grad_norm_cuda=norm_cuda, grad_norm_plain=norm_plain,
         tol=TRAIN_TOL, losses=losses, step_times_s=times, step_s=step_s,
         tokens_per_s=tps, mfu=6.0 * n_matmul * tps / BF16_FLOPS,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=counts)
    return counts


def run_train_lm(argv):
    """`train_lm.main(argv)` in this process; its stdout, echoed."""
    from skypilot_tpu_torch.recipes import train_lm
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_lm.main(argv)
    print(buf.getvalue(), end='', flush=True)
    return buf.getvalue()


def phase_train_lora(fk, lk, card):
    """`train_lm --lora` at full Llama-3-8B depth, a relaunch that
    resumes, then the trained adapter served by serve_lm."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.observability.step_metrics import read_jsonl
    root = os.path.join(WORK, 'train_lora')
    shutil.rmtree(root, ignore_errors=True)
    adapters = os.path.join(root, 'adapters')
    metrics = os.path.join(root, 'metrics.jsonl')
    argv = ['--model', 'llama3-8b', '--lora', '16', '--seq', '2048',
            '--remat', '--ckpt-dir', os.path.join(root, 'ckpt'),
            '--ckpt-every', '2', '--log-every', '1', '--metrics-file',
            metrics, '--adapter-out', os.path.join(adapters, 'tuned')]
    torch.cuda.reset_peak_memory_stats()
    zero_flash(fk)
    t0 = time.perf_counter()
    first = run_train_lm(argv + ['--steps', '4'])
    t1 = time.perf_counter()
    second = run_train_lm(argv + ['--steps', '6'])
    t2 = time.perf_counter()
    counts = flash_counts(fk)
    check('step 4/4 loss=' in first and 'training done' in first,
          'first train_lm run did not finish')
    check('resumed from checkpoint step 4' in second
          and 'step 6/6 loss=' in second and 'step 4/6' not in second,
          'relaunch did not resume from step 4')
    check(counts == {'flash_fwd': 32 * 6 * 2, 'flash_bwd': 32 * 6}
          and fk.plain_calls == 0,
          f'train_lora launches {counts}')
    records = read_jsonl(metrics)
    check(len(records) == 6 and all(np.isfinite(r['loss'])
                                    for r in records), 'metrics records')
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    # The fine-tune-and-serve loop: serve the trained adapter.
    model = convert.init_params(registry.model_config('llama3-8b', 1024),
                                seed=0, device='cuda')
    rt, server, thread, port, _ = serve_runtime(
        model, 'bf16', ['--adapter-dir', adapters, '--max-adapters', '1'])
    try:
        lora0 = lk.launches
        prompt = np.random.default_rng(3).integers(1, 128256, 300).tolist()
        answer = post(port, '/generate', {'tokens': [prompt],
                                          'max_new_tokens': 8,
                                          'model': 'tuned'})['tokens'][0]
        lora_launches = lk.launches - lora0
    finally:
        stop_runtime(rt, server, thread)
    del model
    torch.cuda.empty_cache()
    check(len(answer) == 308 and answer[:300] == prompt,
          'trained adapter: bad answer')
    check(lora_launches > 0, 'the trained adapter ran no LoRA kernel')
    emit('train_lora', card=card, layers=32, lora_rank=16, batch=8,
         seq=2048, remat=True, first_run_s=t1 - t0, relaunch_s=t2 - t1,
         steps=[r['step'] for r in records],
         losses=[r['loss'] for r in records],
         step_time_s=[r['step_time_s'] for r in records],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], peak_mem_gb=peak,
         launches=counts, served_tokens=answer[300:],
         serve_lora_launches=lora_launches)
    return counts


# -- serving ---------------------------------------------------------------
def prompts(seed=0, n=8, vocab=128256):
    rng = np.random.default_rng(seed)
    lens = rng.integers(300, 701, n)
    out = [rng.integers(1, vocab, int(l)).tolist() for l in lens]
    out[1] = out[0][:256] + out[1][256:]      # a shared 256-token prefix
    return out


def post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def serve_runtime(model, kv_dtype, extra=(), cuda_graphs=True):
    """build_runtime with serve_lm's flags and make_server on an
    ephemeral port, serving from a thread: (rt, server, thread, port,
    setup seconds, CUDA-graph captures included)."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        kv_dtype, '--kv-pool-bytes', '8000000000', '--port', '0',
        *extra])
    t0 = time.perf_counter()
    rt = build_runtime(args, model=model, cuda_graphs=cuda_graphs)
    setup_s = time.perf_counter() - t0
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return rt, server, thread, server.server_address[1], setup_s


def stop_runtime(rt, server, thread):
    server.shutdown()
    rt.stop()
    thread.join(timeout=30)


def burst(rt, port, ps, models, kernels):
    """8 concurrent greedy /generate requests of 32 new tokens (request
    i under `models[i]`, None = the base model), after a warm-up
    request. Returns the serve_* numbers and each kernel module's
    launch and plain-call deltas over the burst."""
    post(port, '/generate', {'tokens': [ps[0][:64]], 'max_new_tokens': 2})
    rt.metrics = type(rt.metrics)()
    counts0 = [(k.launches, k.plain_calls) for k in kernels]
    routes0 = dict(kernels[0].route_launches)
    verify0 = kernels[0].shape_launches[('chunk', VERIFY_S)]
    stats0 = rt.engine.stats()
    results = [None] * len(ps)
    lat = [0.0] * len(ps)

    def one(i):
        t = time.perf_counter()
        body = {'tokens': [ps[i]], 'max_new_tokens': 32, 'temperature': 0.0}
        if models[i] is not None:
            body['model'] = models[i]
        results[i] = post(port, '/generate', body)['tokens'][0]
        lat[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(ps))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    stats = rt.engine.stats()
    for i, (row, p) in enumerate(zip(results, ps)):
        check(row is not None and len(row) == len(p) + 32
              and row[:len(p)] == p
              and all(0 <= t < rt.vocab_size for t in row),
              f'request {i}: bad answer')
    metrics = rt.metrics.snapshot()

    def delta(key):
        return stats[key] - stats0[key]

    steady_s = delta('steady_decode_s')
    steady_rounds = delta('steady_decode_rounds')
    calls = delta('decode_calls')
    return results, {
        'requests': len(ps), 'answered': sum(r is not None for r in results),
        'prompt_tokens': sum(len(p) for p in ps), 'new_tokens': 32,
        'kv_pages': rt.engine.total_pages, 'wall_s': wall,
        'tokens_per_s': 32 * len(ps) / wall,
        'ttft_p50_s': metrics['ttft_p50_s'],
        'ttft_max_s': metrics['ttft_p99_s'],
        'e2e_p50_s': float(np.median(lat)), 'e2e_max_s': max(lat),
        'decode_tokens_per_s': (delta('steady_decode_tokens') / steady_s
                                if steady_s else None),
        'decode_round_ms': (1e3 * steady_s / steady_rounds
                            if steady_rounds else None),
        'decode_rounds': calls,
        'tokens_per_call': delta('tokens_committed') / max(calls, 1),
        'decode_stall_s': delta('decode_stall_s'),
        'graph_replays': delta('graph_replays'),
        'graph_captures': delta('graph_captures'),
        'pipeline_decode': stats['pipeline_decode'],
        'cuda_graphs': stats['cuda_graphs'],
        'paged_route_launches': {
            r: n - routes0[r]
            for r, n in kernels[0].route_launches.items()},
        'verify_launches': (kernels[0].shape_launches[('chunk', VERIFY_S)]
                            - verify0),
        'prefill_chunks': delta('prefill_chunks'),
        'counts': [(k.launches - l0, k.plain_calls - p0)
                   for k, (l0, p0) in zip(kernels, counts0)]}


def phase_serve(kv_dtype, model, pk, lk, card):
    rt, server, thread, port, setup_s = serve_runtime(model, kv_dtype)
    try:
        _, out = burst(rt, port, prompts(), [None] * 8, (pk, lk))
    finally:
        stop_runtime(rt, server, thread)
    (launches, plain_calls), lora_counts = out.pop('counts')
    check(launches > 0, 'the paged-attention kernel never launched')
    check(plain_calls == 0, f'plain route taken {plain_calls} times')
    check(lora_counts == (0, 0), f'base-only serving ran LoRA code '
                                 f'{lora_counts}')
    emit(f'serve_{kv_dtype}', card=card, setup_s=setup_s, **out,
         kernel_launches=launches, plain_calls=plain_calls)


def seed_adapters(root, cfg, specs, seed0, amplify=1.0):
    """Write one reference-format adapter artifact per (name, rank,
    target set) into `root`, factors from numpy seeds."""
    from skypilot_tpu_torch.models import lora
    for i, (name, rank, targets) in enumerate(specs):
        spec = lora.LoraSpec(rank=rank, alpha=2.0 * rank,
                             targets=lora.targets_from_name(targets))
        params = lora.random_adapter_params(seed0 + i, cfg, spec)
        if amplify != 1.0:
            for layer in params.values():
                for f in layer.values():
                    f['b'] *= amplify
        lora.save_adapter(os.path.join(root, name), params, spec,
                          base_model='llama3-8b')


def phase_serve_lora(model, pk, lk, card):
    """Multi-LoRA serving through serve_lm's flags at Llama-3-8B width."""
    from skypilot_tpu_torch.models import registry
    root = os.path.join(WORK, 'adapters')
    shutil.rmtree(root, ignore_errors=True)
    cfg = registry.model_config('llama3-8b', 1024)
    t0 = time.perf_counter()
    seed_adapters(root, cfg, [('attn8', 8, 'attn'), ('attn16', 16, 'attn'),
                              ('mlp16', 16, 'attn-mlp')], seed0=10)
    write_s = time.perf_counter() - t0
    rt, server, thread, port, setup_s = serve_runtime(
        model, 'bf16', ['--adapter-dir', root, '--max-adapters', '3'])
    try:
        ps = prompts()
        # Requests 0 and 1 share a 256-token prefix under two adapters.
        models = ['attn8', 'attn16', None, 'mlp16', None, 'attn8',
                  'mlp16', 'attn16']
        _, out = burst(rt, port, ps, models, (pk, lk))
        (pa_launches, pa_plain), (lora_launches, lora_plain) = \
            out.pop('counts')
        pc = rt.engine.prefix_cache
        # Tenant isolation: request 1's prompt under attn8 reuses the
        # 16 shared-prefix pages request 0 left under attn8, not the
        # pages request 1 itself left under attn16; request 0's prompt
        # under mlp16 reuses nothing.
        h0 = pc.hits
        post(port, '/generate', {'tokens': [ps[1]], 'max_new_tokens': 1,
                                 'model': 'attn8'})
        same_tenant_hits = pc.hits - h0
        h0 = pc.hits
        post(port, '/generate', {'tokens': [ps[0]], 'max_new_tokens': 1,
                                 'model': 'mlp16'})
        cross_tenant_hits = pc.hits - h0
        # Hot-load: a 4th adapter dropped into the live directory.
        seed_adapters(root, cfg, [('late8', 8, 'attn')], seed0=20)
        evictions0 = rt.adapters.evictions
        late = post(port, '/generate', {'tokens': [ps[2][:300]],
                                         'max_new_tokens': 8,
                                         'model': 'late8'})['tokens'][0]
        evictions = rt.adapters.evictions - evictions0
        try:
            post(port, '/generate', {'tokens': [ps[2][:32]],
                                     'model': 'no-such-adapter'})
            unknown_status = 200
        except urllib.error.HTTPError as e:
            unknown_status = e.code
        adapters = rt.adapters.stats()
    finally:
        stop_runtime(rt, server, thread)
    check(pa_launches > 0 and lora_launches > 0,
          f'kernels not launched: paged {pa_launches}, LoRA {lora_launches}')
    check(pa_plain == 0 and lora_plain == 0,
          f'plain route taken: paged {pa_plain}, LoRA {lora_plain}')
    check(same_tenant_hits == 256 // PAGE,
          f'same-tenant prefix hits {same_tenant_hits}, want {256 // PAGE}')
    check(cross_tenant_hits == 0,
          f'{cross_tenant_hits} prefix hits across adapters')
    check(len(late) == 308, 'hot-loaded adapter: bad answer')
    check(evictions == 1, f'hot-load evicted {evictions} adapters, want 1')
    check(unknown_status == 404, f'unknown model gave {unknown_status}')
    emit('serve_lora', card=card, setup_s=setup_s, adapter_write_s=write_s,
         models=models, **out, kernel_launches=pa_launches,
         plain_calls=pa_plain, lora_launches=lora_launches,
         lora_device_launches=lora_launches * lk.DEVICE_LAUNCHES_PER_CALL,
         lora_plain_calls=lora_plain, same_tenant_hits=same_tenant_hits,
         cross_tenant_hits=cross_tenant_hits, hot_load_evictions=evictions,
         unknown_model_status=unknown_status,
         adapters={k: adapters[k] for k in (
             'loaded', 'rank', 'targets', 'loads', 'evictions',
             'requests', 'bytes_per_adapter')})


# -- decode modes ------------------------------------------------------------
# (label, pool, serve_lm flags, CUDA graphs, adapters): (a) the eager
# unpipelined baseline, (b) pipelined eager, (c) the default, pipelined
# with graphs, (d) --decode-chunk 4; int8 and LoRA runtimes run (a) and
# (c); (e) --speculative 4. The 4096 runs hold (d) to (a) on one slot at
# --max-total-len 4096, where the split route cuts a row into 32 splits
# of 128 tokens and the prompts' rows cross several of them.
LONG_WIDTH = ('--num-slots', '1', '--max-total-len', '4096')
DECODE_MODES = (
    ('a_bf16', 'bf16', ('--no-pipeline-decode',), False, False),
    ('b_bf16', 'bf16', (), False, False),
    ('c_bf16', 'bf16', (), True, False),
    ('d_bf16', 'bf16', ('--decode-chunk', '4'), True, False),
    ('a_int8', 'int8', ('--no-pipeline-decode',), False, False),
    ('c_int8', 'int8', (), True, False),
    ('a_lora', 'bf16', ('--no-pipeline-decode',), False, True),
    ('c_lora', 'bf16', (), True, True),
    ('e_spec', 'bf16', ('--speculative', '4'), True, False),
    ('a_4096', 'bf16', ('--no-pipeline-decode', *LONG_WIDTH), False, False),
    ('d_4096', 'bf16', ('--decode-chunk', '4', *LONG_WIDTH), True, False))
# The sampled first request: (label, serve_lm flags, CUDA graphs).
SAMPLED_MODES = (('single_graphs', (), True),
                 ('chunk_graphs', ('--decode-chunk', '4'), True),
                 ('single_eager', (), False),
                 ('chunk_eager', ('--decode-chunk', '4'), False))
SAMPLED_REQUEST = {'max_new_tokens': 32, 'temperature': 0.9, 'top_k': 50}
LORA_MODELS = ['attn8', 'attn16', None, 'mlp16', None, 'attn8', 'mlp16',
               'attn16']


def phase_decode_modes(model, pk, lk, card):
    """serve_bf16's weights, 8 slots, the 8 prompts, 32 greedy tokens each,
    through serve_lm's flags in each decode mode: (b), (c) and (d) must
    give (a)'s tokens on every request, on each pool and with adapters;
    (e) answers every request with prompt + 32 tokens and commits more
    than one token a verify call. Every single-token decode step
    launches the split route once a layer, so its launches are
    layers x steps: steps = graph replays (launches are counted from
    replays) plus the eager warm-up of each graph captured during the
    burst (a LoRA graph, at the first adapter round) with graphs on, and
    decode calls without. Returns the (e) run's verify-chunk launches
    (chunk route, S = 5)."""
    from skypilot_tpu_torch.models import convert, registry
    root = os.path.join(WORK, 'adapters')     # serve_lora's adapters
    layers = model.config.num_layers
    # The same weight tensors under the 4096-token config.
    long_model = convert.assemble(registry.model_config('llama3-8b', 4096),
                                  model.state_dict())
    runs, tokens = {}, {}
    verify_launches = 0
    for label, kv, flags, graphs, lora in DECODE_MODES:
        extra = list(flags)
        if lora:
            extra += ['--adapter-dir', root, '--max-adapters', '3']
        long = label.endswith('4096')
        rt, server, thread, port, setup_s = serve_runtime(
            long_model if long else model, kv, extra, cuda_graphs=graphs)
        ps = prompts()[:3] if long else prompts()
        try:
            tokens[label], out = burst(
                rt, port, ps, LORA_MODELS if lora else [None] * len(ps),
                (pk, lk))
        finally:
            stop_runtime(rt, server, thread)
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        (launches, plain_calls), (lora_launches, lora_plain) = \
            out.pop('counts')
        split = out['paged_route_launches']['split']
        steps = (out['graph_replays'] + out['graph_captures']
                 if graphs and label != 'e_spec' else out['decode_rounds'])
        runs[label] = {'setup_s': setup_s, **out, 'flags': list(flags),
                       'paged_launches': launches,
                       'lora_launches': lora_launches}
        check(plain_calls == 0 and lora_plain == 0,
              f'{label}: plain route taken ({plain_calls}, {lora_plain})')
        check((out['graph_replays'] > 0) == (graphs and label != 'e_spec'),
              f'{label}: {out["graph_replays"]} graph replays')
        if label == 'e_spec':
            verify_launches = out['verify_launches']
            check(verify_launches == layers * out['decode_rounds']
                  and out['tokens_per_call'] > 1,
                  f'e_spec: {verify_launches} verify launches over '
                  f'{out["decode_rounds"]} calls, {out["tokens_per_call"]} '
                  f'tokens a call')
        else:
            check(split == layers * steps,
                  f'{label}: {split} split-route launches for {steps} '
                  f'decode steps of {layers} layers')
        check(not lora or lora_launches > 0, f'{label}: no LoRA launch')
    same = {label: tokens[label] == tokens['a_' + label.split('_')[1]]
            for label in ('b_bf16', 'c_bf16', 'd_bf16', 'c_int8', 'c_lora',
                          'd_4096')}
    del long_model
    sampled = sampled_first_request(model, tokens['a_bf16'][0])
    emit('decode_modes', card=card, runs=runs, token_identical=same,
         verify_launches=verify_launches, sampled=sampled)
    check(all(same.values()), f'decode modes disagree with the eager '
                              f'unpipelined baseline: {same}')
    check(sampled['chunk_equals_single_graphs']
          and sampled['chunk_equals_single_eager']
          and sampled['differs_from_greedy']
          and sampled['single_graphs']['graph_replays'] > 0
          and sampled['chunk_graphs']['graph_replays'] > 0,
          f'sampled first request: {sampled}')
    return verify_launches


def sampled_first_request(model, greedy):
    """chip_smoke's first prompt, sampled (temperature 0.9, top-k 50: the
    filter variant of the round), as the first request of a fresh
    runtime, single-step and --decode-chunk 4, with graphs and eagerly:
    under the engine's one seed the chunked tokens must equal the
    single-step ones in each (the reference's contract for the first
    request), and differ from the greedy answer. Also reports whether
    the graph and eager runs drew the same tokens."""
    out = {}
    for label, flags, graphs in SAMPLED_MODES:
        rt, server, thread, port, _ = serve_runtime(model, 'bf16', flags,
                                                    cuda_graphs=graphs)
        try:
            row = post(port, '/generate', {'tokens': [prompts()[0]],
                                           **SAMPLED_REQUEST})['tokens'][0]
            stats = rt.engine.stats()
        finally:
            stop_runtime(rt, server, thread)
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        out[label] = {'tokens': row[len(prompts()[0]):],
                      'graph_replays': stats['graph_replays']}
    tok = {label: r['tokens'] for label, r in out.items()}
    out.update(
        chunk_equals_single_graphs=tok['chunk_graphs'] == tok['single_graphs'],
        chunk_equals_single_eager=tok['chunk_eager'] == tok['single_eager'],
        graphs_equal_eager=tok['single_graphs'] == tok['single_eager'],
        differs_from_greedy=tok['single_graphs'] != greedy[
            len(prompts()[0]):])
    return out


def phase_graph_round(model, pk, card):
    """One decode round of the 32-layer model (8 rows over a bf16 pool of
    random history) captured into a CUDA graph, replayed on new tokens,
    positions and tables, against the same round run eagerly on those
    inputs: the logits must be bit-identical (the same kernels on the
    same shapes; each run writes the same K/V at each row's position
    before attending)."""
    from skypilot_tpu_torch.models.llama import PagedKVCache
    cfg = dataclasses.replace(model.config, kv_total_pages=8 * 64 + 1)
    cache = PagedKVCache(cfg, 'cuda')
    g = torch.Generator('cuda').manual_seed(7)
    for layer in cache.layers:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g, device='cuda') * 0.5)
    rng = np.random.default_rng(8)

    def inputs():
        tok = torch.tensor(rng.integers(1, cfg.vocab_size, (8, 1)),
                           device='cuda')
        pos = torch.tensor(rng.integers(0, 1024, (8, 1)), dtype=torch.int32,
                           device='cuda')
        table = torch.tensor(1 + rng.permutation(8 * 64).reshape(8, 64),
                             dtype=torch.int32, device='cuda')
        return tok, pos, table

    tok, pos, table = inputs()

    def round_logits():
        return model.logits(model.hidden(tok, pos, cache, table)[:, 0])

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            round_logits()
        torch.cuda.current_stream().wait_stream(side)
        pk.reserve_graph_counters(torch.device('cuda'))
        graph = torch.cuda.CUDAGraph()
        counts0 = (pk.launches, dict(pk.route_launches),
                   dict(pk.shape_launches))
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            static_out = round_logits()
        capture_s = time.perf_counter() - t0
        captured = pk.launches - counts0[0]
        # The capture launched nothing: its calls are taken back.
        pk.launches = counts0[0]
        pk.route_launches.update(counts0[1])
        pk.shape_launches.clear()
        pk.shape_launches.update(counts0[2])
        results = []
        for _ in range(2):
            for dst, src in zip((tok, pos, table), inputs()):
                dst.copy_(src)
            graph.replay()
            replayed = static_out.clone()
            eager = round_logits()
            torch.cuda.synchronize()
            results.append((bool(torch.equal(replayed, eager)),
                            (replayed - eager).abs().max().item(),
                            bool(torch.isfinite(eager).all())))
    del graph
    draws = sampled_replays(model, cache, tok, pos, table)
    del cache
    torch.cuda.empty_cache()
    emit('graph_round', card=card, layers=cfg.num_layers,
         capture_s=capture_s, paged_calls_captured=captured,
         bit_identical=[r[0] for r in results],
         max_abs_diff=[r[1] for r in results],
         finite=[r[2] for r in results], sampled_replays=draws)
    check(captured == cfg.num_layers, f'{captured} paged calls captured')
    check(all(r[0] and r[2] for r in results),
          f'graph replay differs from the eager round: {results}')
    check(all(d['replays_differ'] and d['reset_repeats']
              for d in draws.values()),
          f'sampled graph replays do not draw from the generator: {draws}')


def sampled_replays(model, cache, tok, pos, table):
    """The engine's round (models/decode_graph.py) in its sampled
    variants, replayed as graphs over the same inputs: two replays must
    draw different tokens (the generator registered with the graph
    advances), and a replay after the generator is reset to its state
    before the first must draw the first replay's tokens. Also reports
    whether an eager round from that state draws the same tokens."""
    from skypilot_tpu_torch.models import decode_graph
    b, pps = table.shape
    lanes = dict(tok=tok[:, 0].cpu().numpy(), pos=pos[:, 0].cpu().numpy(),
                 cont=np.zeros(b, np.int32), ids=np.zeros(b, np.int32),
                 temp=np.ones(b, np.float32), top_p=np.ones(b, np.float32),
                 table=table.cpu().numpy())
    out = {}
    for selection, top_k in (('sample', 0), ('filter', 50)):
        rounds = {}
        for graphs in (True, False):
            gen = torch.Generator('cuda').manual_seed(11)
            rounds[graphs] = (decode_graph.DecodeRound(
                model, cache, b, pps, max_steps=1, generator=gen,
                use_graphs=graphs, attend_len=1024), gen)
        kw = dict(lanes, top_k=np.full(b, top_k, np.int32),
                  selection=selection, lora=None)
        rnd, gen = rounds[True]
        rnd.capture(selection, None)
        state = gen.get_state()
        first = rnd.dispatch(**kw).wait()[0]
        second = rnd.dispatch(**kw).wait()[0]
        gen.set_state(state)
        again = rnd.dispatch(**kw).wait()[0]
        eager = rounds[False][0].dispatch(**kw).wait()[0]
        out[selection] = {
            'replays': rnd.replays, 'first': first.tolist(),
            'second': second.tolist(),
            'replays_differ': bool((first != second).any()),
            'reset_repeats': bool((first == again).all()),
            'eager_draws_equal': bool((first == eager).all())}
        del rounds, rnd
    return out


def phase_serve_long(model, fk, pk, card):
    """Whole-prompt prefill (--prefill-chunk 0) of 2048+ token prompts."""
    from skypilot_tpu_torch.models import convert, registry
    # The same weight tensors under the 4096-token config.
    model = convert.assemble(registry.model_config('llama3-8b', 4096),
                             model.state_dict())
    rt, server, thread, port, setup_s = serve_runtime(
        model, 'bf16', ['--max-total-len', '4096', '--prefill-chunk', '0'])
    rng = np.random.default_rng(5)
    ps = [rng.integers(1, 128256, n).tolist() for n in (2048, 2300, 2600)]
    try:
        # Warm up on a prompt that shares no prefix with the measured ones
        # (a prefix hit would start their prefill past offset 0).
        post(port, '/generate', {'tokens': [rng.integers(
            1, 128256, 64).tolist()], 'max_new_tokens': 2})
        zero_flash(fk)
        pa0 = pk.launches
        lat, outs = [], []
        for p in ps:
            t0 = time.perf_counter()
            outs.append(post(port, '/generate', {
                'tokens': [p], 'max_new_tokens': 8,
                'temperature': 0.0})['tokens'][0])
            lat.append(time.perf_counter() - t0)
        counts, paged = flash_counts(fk), pk.launches - pa0
    finally:
        stop_runtime(rt, server, thread)
    for p, o in zip(ps, outs):
        check(len(o) == len(p) + 8 and o[:len(p)] == p, 'serve_long answer')
    check(counts['flash_fwd'] == 32 * len(ps) and counts['flash_bwd'] == 0
          and fk.plain_calls == 0, f'serve_long launches {counts}')
    emit('serve_long', card=card, setup_s=setup_s,
         prompt_tokens=[len(p) for p in ps], new_tokens=8, e2e_s=lat,
         flash_launches=counts['flash_fwd'], paged_launches=paged)


def long_parity(fk, pk):
    """Greedy tokens of 2 whole-prompt prefills (2100 / 2600 tokens) on a
    2-layer f32 model at Llama-3-8B width, kernel vs plain routes."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 4096),
                              num_layers=2, dtype=torch.float32,
                              kv_total_pages=2 * 256 + 1)
    model = convert.init_params(cfg, seed=2, device='cuda')
    rng = np.random.default_rng(6)
    ps = [rng.integers(1, 128256, n).tolist() for n in (2100, 2600)]
    outs = {}
    for impl in ('cuda', 'torch'):
        engine = ContinuousBatchingEngine(model, num_slots=2,
                                          max_total_len=4096,
                                          prefill_chunk=0)
        zero_flash(fk)
        try:
            with pk.impl_scope(impl):
                futs = [engine.submit(p, max_new_tokens=8) for p in ps]
                outs[impl] = [f.result(timeout=600) for f in futs]
        finally:
            engine.stop()
        routed = fk.fwd_launches if impl == 'cuda' else fk.plain_calls
        check(routed == 2 * len(ps), f'long prefill {impl}: {routed} calls')
    del model
    torch.cuda.empty_cache()
    return outs


def phase_greedy_parity(pk, lk, fk):
    import dataclasses
    from skypilot_tpu_torch.inference.adapters import AdapterRegistry
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 1024),
                              num_layers=2, dtype=torch.float32,
                              kv_total_pages=4 * 64 + 1)
    model = convert.init_params(cfg, seed=1, device='cuda')
    root = os.path.join(WORK, 'parity_adapters')
    shutil.rmtree(root, ignore_errors=True)
    # Amplified B factors, so the adapters move the logits visibly.
    seed_adapters(root, cfg, [('p8', 8, 'attn'), ('p16', 16, 'attn-mlp')],
                  seed0=30, amplify=8.0)
    ps = [p[:400] for p in prompts(seed=1, n=4)]
    ps += [ps[0], ps[0]]       # the first prompt again, under each adapter
    models = [None, None, None, None, 'p8', 'p16']
    outs = {}
    # The kernels and their plain versions (the engines capture their
    # decode graphs at construction, inside the scope); then the
    # speculative and chunked engines through the kernels.
    for label, impl, kw in (('cuda', 'cuda', {}), ('torch', 'torch', {}),
                            ('spec4', 'cuda', {'speculative_k': 4}),
                            ('chunk4', 'cuda', {'decode_chunk': 4})):
        counts0 = [(k.launches, k.plain_calls) for k in (pk, lk)]
        with pk.impl_scope(impl):    # routes both kernels
            engine = ContinuousBatchingEngine(
                model, num_slots=4, max_total_len=1024, prefill_chunk=256,
                adapter_store=AdapterRegistry(root, model, max_adapters=2),
                **kw)
            try:
                futs = [engine.submit(p, max_new_tokens=16, adapter=m)
                        for p, m in zip(ps, models)]
                outs[label] = [f.result(timeout=600) for f in futs]
            finally:
                engine.stop()
        for k, (l0, p0) in zip((pk, lk), counts0):
            routed = k.launches - l0 if impl == 'cuda' else k.plain_calls - p0
            check(routed > 0, f'impl {impl} of {k.__name__} was never taken')
            check(impl == 'torch' or k.plain_calls == p0,
                  f'{label}: plain calls of {k.__name__}')
        del engine
        gc.collect()
    same = outs['cuda'] == outs['torch']
    modes_same = {label: outs[label] == outs['cuda']
                  for label in ('spec4', 'chunk4')}
    # The one-shot engine's functions on the first two base requests:
    # each alone, its whole bucket (prompt + 16).
    from skypilot_tpu_torch.models import generate as gen
    for label, make in (('one_shot', gen.make_generate_fn),
                        ('one_shot_spec4', functools.partial(
                            gen.make_speculative_generate_fn, draft_k=4))):
        modes_same[label] = all(
            make(model, len(p) + 16)(torch.tensor([p], device='cuda'))
            [0].tolist() == o for p, o in zip(ps[:2], outs['cuda'][:2]))
    del model
    torch.cuda.empty_cache()
    long_outs = long_parity(fk, pk)
    long_same = long_outs['cuda'] == long_outs['torch']
    emit('greedy_parity', requests=len(ps), new_tokens=16, layers=2,
         models=models, equal=same, decode_modes_equal=modes_same,
         tokens_cuda=[o[-16:] for o in outs['cuda']],
         tokens_torch=[o[-16:] for o in outs['torch']],
         long_prompt_tokens=[len(o) - 8 for o in long_outs['cuda']],
         long_equal=long_same,
         long_tokens_cuda=[o[-8:] for o in long_outs['cuda']],
         long_tokens_torch=[o[-8:] for o in long_outs['torch']])
    check(same, 'greedy tokens differ between the kernel and plain routes')
    check(all(modes_same.values()), f'speculative / chunked / one-shot '
                                    f'greedy tokens differ from the plain '
                                    f'engine\'s: {modes_same}')
    check(long_same, 'long-prefill greedy tokens differ between the '
                     'kernel and plain routes')
    check(len({tuple(outs['cuda'][i][-16:]) for i in (0, 4, 5)}) == 3,
          'the adapters did not change the greedy tokens')


# -- the request surface: streams, text, HF checkpoints, one-shot ----------
# Streamed and non-streamed runs must prefill the same chunks to give the
# same bf16 tokens, so each side runs on a fresh runtime (a prompt sent
# twice to one runtime hits its own cached pages the second time).
STREAM_MODELS = ['attn8', None, None, 'mlp16', None, None, None, None]
# token_logprobs of the scoring pass (bucket 4096, flash forward) against
# the same pass on the plain versions, in nats. On this random-weight
# model bf16 routes that round differently part by ~0.05 nats on average
# and up to ~0.3 over 32 layers: a plain pass that only rounds P to bf16,
# as the kernel does, differs from the f32 plain pass that much
# (`serve_text` measures it in the same run). Mean and max are both held.
LOGPROB_TOL = {'mean': 0.1, 'max': 0.5}
# Where two greedy bf16 runs that sum in different orders part, the top-2
# log-prob margin there must be below the same bf16 noise (a near tie),
# else it is a fault; in f32 (greedy_parity) they must not part at all.
PART_MARGIN_TOL = 0.5


class ByteTokenizer:
    """Stand-in tokenizer for the text endpoints on the card, which has no
    `transformers` (so no HF tokenizer can load there): UTF-8 bytes are
    token ids, and an id decodes as its low byte. No chat template, so
    chat renders `role: content` lines. Test scaffolding, not a feature
    of the port: the runtime keeps it where `get_tokenizer` keeps a
    loaded tokenizer."""

    def __call__(self, text):
        return {'input_ids': list(text.encode('utf-8'))}

    def decode(self, ids, skip_special_tokens=True):
        return bytes(int(t) % 256 for t in ids).decode('utf-8',
                                                       errors='replace')


def stream_text(text):
    """What an SSE text stream of `text`'s tokens delivers: the
    incremental decoder drops an unresolved trailing partial codepoint."""
    return text[:-1] if text.endswith('�') else text


def text_prompt(rng, n_chars):
    words = [''.join(chr(97 + int(c)) for c in rng.integers(0, 26, k))
             for k in rng.integers(2, 9, n_chars // 4)]
    return ' '.join(words)[:n_chars]


def sse(port, path, body, stop_after=None, timeout=600):
    """(events, seconds to the first event, seconds to the end) of an
    SSE answer; `stop_after` events, then the client hangs up."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    conn.request('POST', path, json.dumps(body),
                 {'Content-Type': 'application/json'})
    resp = conn.getresponse()
    check(resp.status == 200 and
          resp.getheader('Content-Type') == 'text/event-stream',
          f'{path}: status {resp.status}')
    events, first = [], None
    for line in resp:
        if not line.startswith(b'data: '):
            continue
        first = first if first is not None else time.perf_counter() - t0
        data = line[len(b'data: '):].strip()
        events.append('[DONE]' if data == b'[DONE]' else json.loads(data))
        if stop_after is not None and len(events) >= stop_after:
            break
    resp.close()
    conn.close()
    return events, first, time.perf_counter() - t0


def concurrently(fn, n):
    out = [None] * n
    errors = []

    def one(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'{type(e).__name__}: {e}')

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    check(not errors, f'concurrent requests failed: {errors}')
    return out


def zero_counts(pk, lk, fk):
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    zero_paged(pk)
    zero_flash(fk)


def phase_serve_stream(model, pk, lk, fk, card):
    """The 8 prompts as concurrent /generate SSE streams (two under
    serve_lora's adapters), against the same requests non-streamed on a
    runtime with the same flags; then a client that hangs up."""
    root = os.path.join(WORK, 'adapters')
    flags = ['--adapter-dir', root, '--max-adapters', '3']
    ps = prompts()

    def body(i, **kw):
        b = {'tokens': [ps[i]], 'max_new_tokens': 32, **kw}
        if STREAM_MODELS[i] is not None:
            b['model'] = STREAM_MODELS[i]
        return b

    rt, server, thread, port, _ = serve_runtime(model, 'bf16', flags)
    try:
        post(port, '/generate', {'tokens': [ps[2][:64]], 'max_new_tokens': 2})
        plain = concurrently(lambda i: post(port, '/generate', body(i))
                             ['tokens'][0], len(ps))
    finally:
        stop_runtime(rt, server, thread)
    rt, server, thread, port, setup_s = serve_runtime(model, 'bf16', flags)
    try:
        post(port, '/generate', {'tokens': [ps[2][:64]], 'max_new_tokens': 2})
        rt.metrics = type(rt.metrics)()
        zero_counts(pk, lk, fk)
        streams = concurrently(lambda i: sse(port, '/generate',
                                             body(i, stream=True)), len(ps))
        launches, plain_calls = pk.launches, pk.plain_calls
        routes = dict(pk.route_launches)
        lora_launches, lora_plain = lk.launches, lk.plain_calls
        metrics = rt.metrics.snapshot()
        # A client that hangs up after 4 tokens: its slot frees and
        # nothing more is committed for it.
        eng = rt.engine
        committed0 = eng.tokens_committed
        events, _, _ = sse(port, '/generate',
                           {'tokens': [ps[3]], 'max_new_tokens': 200,
                            'stream': True}, stop_after=4)
        deadline = time.monotonic() + 30
        while (eng.active.any() or any(f is not None for f in eng.futures)) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        freed = not eng.active.any() and all(f is None for f in eng.futures)
        hung_up = eng.tokens_committed - committed0
        time.sleep(0.5)
        after = eng.tokens_committed - committed0
    finally:
        stop_runtime(rt, server, thread)
    for i, (evs, _, _) in enumerate(streams):
        toks = [e['token'] for e in evs[:-2]]
        check(evs[-1] == '[DONE]' and evs[-2].get('done') is True,
              f'stream {i}: no terminal event')
        check(evs[-2]['tokens'] == [ps[i] + toks],
              f'stream {i}: streamed tokens differ from the terminal row')
        check(evs[-2]['tokens'][0] == plain[i],
              f'stream {i}: differs from the non-streamed /generate row')
        check(len(toks) == 32, f'stream {i}: {len(toks)} tokens')
    check(launches > 0 and routes['split'] > 0 and plain_calls == 0,
          f'serve_stream: paged {routes}, {plain_calls} plain calls')
    check(lora_launches > 0 and lora_plain == 0,
          f'serve_stream: {lora_launches} LoRA launches, {lora_plain} plain')
    check(freed and 4 <= hung_up < 200 and after == hung_up,
          f'hung-up stream: freed={freed}, committed {hung_up} then '
          f'{after}')
    firsts = [f for _, f, _ in streams]
    emit('serve_stream', card=card, setup_s=setup_s, streams=len(ps),
         models=STREAM_MODELS, new_tokens=32,
         ttft_client_p50_s=float(np.median(firsts)),
         ttft_client_max_s=max(firsts),
         ttft_p50_s=metrics['ttft_p50_s'], ttft_max_s=metrics['ttft_p99_s'],
         itl_ms_n=metrics['itl_ms_n'], itl_ms_p50=metrics['itl_ms_p50'],
         itl_ms_p99=metrics['itl_ms_p99'],
         e2e_max_s=max(t for _, _, t in streams),
         paged_launches=launches, paged_route_launches=routes,
         lora_launches=lora_launches, hung_up_after_events=len(events),
         hung_up_committed=hung_up)


def _deltas(events, key='delta'):
    rows = {}
    for e in events:
        if isinstance(e, dict) and 'index' in e:
            rows[e['index']] = rows.get(e['index'], '') + e[key]
    return [rows.get(i, '') for i in range(len(rows))]


def text_runtime(model, extra=()):
    """serve_lm's flags without prefix caching (a prompt is sent twice:
    as text, then as ids), the stand-in tokenizer in place."""
    rt, server, thread, port, setup_s = serve_runtime(
        model, 'bf16', ['--no-prefix-caching', *extra])
    rt._tok_holder['tok'] = ByteTokenizer()  # pylint: disable=protected-access
    return rt, server, thread, port, setup_s


def phase_serve_text(model, pk, lk, fk, card):
    """/generate_text, text /v1/completions with a stop string and
    /v1/chat/completions, plain and streamed, each equal to decoding the
    token answer for the same prompt; then logprobs with echo over a
    2100+ token prompt at --max-total-len 4096."""
    from skypilot_tpu_torch.inference import openai_compat as oai
    from skypilot_tpu_torch.models import convert, registry
    tok = ByteTokenizer()
    rng = np.random.default_rng(11)
    texts = [text_prompt(rng, n) for n in (420, 610)]
    ids = [tok(t)['input_ids'] for t in texts]
    rt, server, thread, port, setup_s = text_runtime(model)
    out = {}
    try:
        post(port, '/generate', {'tokens': [ids[0][:64]],
                                 'max_new_tokens': 2})
        zero_counts(pk, lk, fk)
        rows = post(port, '/generate', {'tokens': ids,
                                        'max_new_tokens': 32})['tokens']
        want = [tok.decode(r[len(i):]) for r, i in zip(rows, ids)]
        got = post(port, '/generate_text', {'prompts': texts,
                                            'max_new_tokens': 32})['texts']
        check(got == want, '/generate_text differs from the decoded ids')
        evs, _, _ = sse(port, '/generate_text', {
            'prompts': texts, 'max_new_tokens': 32, 'stream': True})
        check(_deltas(evs) == [stream_text(w) for w in want],
              '/generate_text stream differs from the decoded ids')
        # A two-character stop string from the answer (holdback spans
        # tokens), at its first occurrence past the answer's start.
        text0 = want[0]
        k = next((j for j in range(1, len(text0) - 1)
                  if '�' not in text0[j:j + 2]
                  and text0.find(text0[j:j + 2]) == j), None)
        check(k is not None, f'no stop-string candidate in {text0!r}')
        stop = text0[k:k + 2]
        comp = {'prompt': texts[0], 'max_tokens': 32, 'temperature': 0.0,
                'stop': [stop]}
        c = post(port, '/v1/completions', comp)['choices'][0]
        check(c['text'] == text0[:k] and c['finish_reason'] == 'stop',
              f'/v1/completions with stop {stop!r}: {c["text"]!r}')
        evs, _, _ = sse(port, '/v1/completions', dict(comp, stream=True))
        streamed = ''.join(e['choices'][0]['text'] for e in evs[:-1])
        check(streamed == text0[:k] and
              evs[-2]['choices'][0]['finish_reason'] == 'stop',
              f'/v1/completions stream with stop: {streamed!r}')
        # Chat: no template, so `role: content` lines.
        msgs = [{'role': 'user', 'content': texts[1][:200]}]
        chat_ids = tok(oai.render_chat_prompt(rt, msgs))['input_ids']
        chat_row = post(port, '/generate', {'tokens': [chat_ids],
                                            'max_new_tokens': 24})
        chat_want = tok.decode(chat_row['tokens'][0][len(chat_ids):])
        chat = {'messages': msgs, 'max_tokens': 24, 'temperature': 0.0}
        c = post(port, '/v1/chat/completions', chat)['choices'][0]
        check(c['message'] == {'role': 'assistant', 'content': chat_want},
              '/v1/chat/completions differs from the decoded ids')
        evs, _, _ = sse(port, '/v1/chat/completions', dict(chat, stream=True))
        streamed = ''.join(e['choices'][0]['delta'].get('content', '')
                           for e in evs[:-1])
        check(streamed == stream_text(chat_want),
              '/v1/chat/completions stream differs from the decoded ids')
        out['text_paged_launches'] = pk.launches
        check(pk.launches > 0 and pk.plain_calls == 0 and
              fk.fwd_launches == 0, 'text endpoints: kernel counts')
    finally:
        stop_runtime(rt, server, thread)
    # logprobs + echo over 2100+ tokens: the scoring pass's bucket is
    # 4096, which takes the flash forward once per layer.
    long_model = convert.assemble(registry.model_config('llama3-8b', 4096),
                                  model.state_dict())
    rt, server, thread, port, _ = text_runtime(
        long_model, ['--max-total-len', '4096'])
    try:
        prompt = text_prompt(np.random.default_rng(12), 2150)
        p_ids = tok(prompt)['input_ids']
        row = post(port, '/generate', {'tokens': [p_ids],
                                       'max_new_tokens': 16})['tokens'][0]
        zero_counts(pk, lk, fk)
        t0 = time.perf_counter()
        c = post(port, '/v1/completions', {
            'prompt': prompt, 'max_tokens': 16, 'temperature': 0.0,
            'logprobs': 5, 'echo': True})['choices'][0]
        score_s = time.perf_counter() - t0
        flash_launches, flash_plain = fk.fwd_launches, fk.plain_calls
        chosen, top_ids, top_vals = rt.score_logprobs(row, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.score_logprobs(row, 5)
        torch.cuda.synchronize()
        score_pass_ms = 1e3 * (time.perf_counter() - t0)
        with pk.impl_scope('torch'):
            plain_chosen, _, _ = rt.score_logprobs(row, 5)
            # The noise floor: the plain pass with the kernel's rounding
            # of P to bf16.
            plain_forward = fk.flash_forward_reference
            fk.flash_forward_reference = flash_forward_bf16p
            try:
                bf16p_chosen, _, _ = rt.score_logprobs(row, 5)
            finally:
                fk.flash_forward_reference = plain_forward
    finally:
        stop_runtime(rt, server, thread)
        del long_model
    lp = c['logprobs']
    check(c['text'].startswith(prompt) and
          len(lp['token_logprobs']) == len(row) and
          lp['token_logprobs'][0] is None, 'logprobs answer shape')
    check(flash_launches == 32 and flash_plain == 0,
          f'scoring pass: {flash_launches} flash launches, {flash_plain} '
          f'plain calls (want 32, 0)')
    http_lp = np.array(lp['token_logprobs'][1:], np.float64)
    err = np.abs(http_lp - plain_chosen)
    floor = np.abs(bf16p_chosen - plain_chosen)
    errs = {'mean': float(err.mean()), 'max': float(err.max())}
    check(all(errs[k] <= LOGPROB_TOL[k] for k in errs),
          f'token_logprobs vs the plain pass: {errs} > {LOGPROB_TOL}')
    margins = top_vals[:, 0] - top_vals[:, 1]
    gen = range(len(p_ids), len(row))
    wrong = [i for i in gen if margins[i - 1] > LOGPROB_TOL['max']
             and top_ids[i - 1, 0] != row[i]]
    check(not wrong, f'generated tokens not the scoring pass\'s top '
                     f'alternative at {wrong}')
    emit('serve_text', card=card, setup_s=setup_s,
         endpoints=['/generate_text', '/generate_text stream',
                    '/v1/completions stop', '/v1/completions stream stop',
                    '/v1/chat/completions', '/v1/chat/completions stream'],
         stop=stop, **out, logprob_prompt_tokens=len(p_ids),
         logprob_request_s=score_s, score_pass_ms=score_pass_ms,
         score_bucket=4096, flash_launches=flash_launches,
         logprob_err=errs, logprob_tol=LOGPROB_TOL,
         bf16p_plain_err={'mean': float(floor.mean()),
                          'max': float(floor.max())},
         generated_margins=[float(margins[i - 1]) for i in gen])


def flash_forward_bf16p(q, k, v, *, scale=None):
    """The flash forward's plain version with P rounded to bf16 before
    its product with V, as the kernel rounds it: the bf16 noise floor
    `serve_text` reports beside the kernel's error."""
    from skypilot_tpu_torch.ops import flash_kernel as fk
    scale = fk._scale(q, scale)   # pylint: disable=protected-access
    batch, seq, num_q_heads, _ = q.shape
    rep = num_q_heads // k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((batch, num_q_heads, seq), dtype=torch.float32,
                      device=q.device)
    for b in range(batch):
        s = fk._masked_scores(   # pylint: disable=protected-access
            fk._heads_first(q[b], 1), fk._heads_first(k[b], rep), scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = (p.bfloat16().float() @ fk._heads_first(v[b], rep)) / l
        o[b] = out.transpose(0, 1).to(q.dtype)
        lse[b] = (m + torch.log(l))[..., 0]
    return o, lse


def write_safetensors(path, tensors):
    """A .safetensors file: 8-byte little-endian header length, the JSON
    header (padded to 8 bytes), then each tensor's raw bytes."""
    names = {torch.bfloat16: 'BF16', torch.float16: 'F16',
             torch.float32: 'F32'}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {'dtype': names[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b' ' * (-len(blob) % 8)
    with open(path, 'wb') as f:
        f.write(len(blob).to_bytes(8, 'little'))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1)
                    .view(torch.uint8).numpy().tobytes())


def write_hf_checkpoint(path, model):
    """`model` as an HF Llama checkpoint: config.json, HF tensor names in
    bf16 over two shards and model.safetensors.index.json. HF stores each
    head's q/k rows in the half-split order its rotate_half reads, the
    order the port's apply_rope reads, so rows are written as they are."""
    cfg = model.config
    state = model.state_dict()
    names = {'tok_embed': 'model.embed_tokens.weight',
             'final_norm.scale': 'model.norm.weight',
             'lm_head': 'lm_head.weight'}
    theirs = {'attn_norm.scale': 'input_layernorm.weight',
              'mlp_norm.scale': 'post_attention_layernorm.weight',
              'attn.wq.weight': 'self_attn.q_proj.weight',
              'attn.wk.weight': 'self_attn.k_proj.weight',
              'attn.wv.weight': 'self_attn.v_proj.weight',
              'attn.wo.weight': 'self_attn.o_proj.weight',
              'mlp.w_gate.weight': 'mlp.gate_proj.weight',
              'mlp.w_up.weight': 'mlp.up_proj.weight',
              'mlp.w_down.weight': 'mlp.down_proj.weight'}
    for i in range(cfg.num_layers):
        for ours, hf in theirs.items():
            names[f'layers.{i}.{ours}'] = f'model.layers.{i}.{hf}'
    os.makedirs(path, exist_ok=True)
    hf_state = {names[k]: v.to(torch.bfloat16) for k, v in state.items()}
    first = [n for n in hf_state if n.startswith(('model.embed',
                                                  'model.layers.0.'))]
    shards = {'model-00001-of-00002.safetensors': first,
              'model-00002-of-00002.safetensors':
                  [n for n in hf_state if n not in first]}
    for shard, keys in shards.items():
        write_safetensors(os.path.join(path, shard),
                          {k: hf_state[k] for k in keys})
    with open(os.path.join(path, 'model.safetensors.index.json'), 'w') as f:
        json.dump({'metadata': {}, 'weight_map': {
            k: shard for shard, keys in shards.items() for k in keys}}, f)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump({'model_type': 'llama',
                   'architectures': ['LlamaForCausalLM'],
                   'vocab_size': cfg.vocab_size,
                   'hidden_size': cfg.embed_dim,
                   'intermediate_size': cfg.mlp_dim,
                   'num_hidden_layers': cfg.num_layers,
                   'num_attention_heads': cfg.num_heads,
                   'num_key_value_heads': cfg.num_kv_heads,
                   'max_position_embeddings': 8192,
                   'rope_theta': cfg.rope_theta, 'rms_norm_eps': cfg.norm_eps,
                   'tie_word_embeddings': False, 'torch_dtype': 'bfloat16'},
                  f)


def phase_serve_hf(pk, lk, fk, card):
    """serve_lm --hf on a checkpoint written here (Llama-3-8B width, 2
    layers, seeded), against a runtime built directly from the seeded
    model."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import (InferenceRuntime,
                                                      build_runtime)
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    from skypilot_tpu_torch.recipes import serve_lm
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 1024),
                              num_layers=2)
    model = convert.init_params(cfg, seed=4, device='cuda')
    path = os.path.join(WORK, 'hf_llama')
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    write_hf_checkpoint(path, model)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    args = serve_lm.parse_args([
        '--hf', path, '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256',
        '--kv-pool-bytes', '2000000000', '--port', '0'])
    ps = [p[:400] for p in prompts(seed=2, n=4)]
    answers, runtimes = [], []
    try:
        t0 = time.perf_counter()
        hf_rt = build_runtime(args)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = hf_rt.model.state_dict()
        same = all(torch.equal(got[k], v)
                   for k, v in model.state_dict().items())
        direct = InferenceRuntime(
            engine=ContinuousBatchingEngine(
                convert.assemble(hf_rt.model.config, model.state_dict()),
                num_slots=8, max_total_len=1024, prefill_chunk=256),
            model_name='direct')
        for rt in (hf_rt, direct):
            server = make_server(rt, 0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            runtimes.append((rt, server, thread))
            port = server.server_address[1]
            post(port, '/generate', {'tokens': [ps[0][:64]],
                                     'max_new_tokens': 2})
            zero_counts(pk, lk, fk)
            answers.append(concurrently(lambda i: post(
                port, '/generate', {'tokens': [ps[i]], 'max_new_tokens': 16})
                ['tokens'][0], len(ps)))
            check(pk.launches > 0 and pk.plain_calls == 0,
                  'serve_hf: paged kernel counts')
        with urllib.request.urlopen(
                f'http://127.0.0.1:{runtimes[0][1].server_address[1]}'
                f'/v1/models', timeout=30) as resp:
            listed = [m['id'] for m in json.loads(resp.read())['data']]
    finally:
        for rt, server, thread in runtimes:
            stop_runtime(rt, server, thread)
        shutil.rmtree(path, ignore_errors=True)
    check(same, '--hf weights differ from the seeded model\'s')
    check(answers[0] == answers[1],
          '--hf greedy tokens differ from the seeded model\'s runtime')
    check(listed == ['hf:hf_llama'], f'/v1/models under --hf: {listed}')
    emit('serve_hf', card=card, layers=2, checkpoint_bytes=size, shards=2,
         write_s=write_s, load_s=load_s, weights_equal=same,
         tokens_equal=True, requests=len(ps), new_tokens=16, models=listed)
    del model, direct, hf_rt
    gc.collect()
    torch.cuda.empty_cache()


def part_margin(rt, a, b):
    """(first position where rows a and b part, or None; the top-2
    log-prob margin the scoring pass of a[:pos] sees there)."""
    pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if pos is None:
        return None, None
    _, _, top_vals = rt.score_logprobs(a[:pos + 1], 2)
    return pos, float(top_vals[pos - 1, 0] - top_vals[pos - 1, 1])


def phase_one_shot(model, pk, lk, fk, card):
    """serve_lm's flags without --continuous-batching (the one-shot
    engine) at --max-total-len 128: two greedy rows against the
    continuous engine's, --speculative 4 against plain, and a stream,
    which builds the lazy stream engine."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    ps = prompts(seed=3, n=2)
    rows = [p[:48] for p in ps]

    def one_shot(extra=()):
        rt = build_runtime(serve_lm.parse_args(
            ['--model', 'llama3-8b', '--max-total-len', '128', '--port', '0',
             *extra]), model=model)
        server = make_server(rt, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return rt, server, thread, server.server_address[1]

    rt, server, thread, port = one_shot()
    try:
        check(rt.engine is None, 'one-shot runtime built an engine')
        zero_counts(pk, lk, fk)
        t0 = time.perf_counter()
        out = post(port, '/generate', {'tokens': rows})['tokens']
        one_shot_s = time.perf_counter() - t0
        check(pk.launches == 0 and fk.fwd_launches == 0,
              'the one-shot path launched a kernel')
        check(all(len(r) == 128 and r[:48] == p for r, p in zip(out, rows)),
              'one-shot rows: bad shape')
        # A stream in one-shot mode runs on the lazy stream engine.
        zero_counts(pk, lk, fk)
        evs, _, _ = sse(port, '/generate', {'tokens': [rows[0]],
                                            'max_new_tokens': 16,
                                            'stream': True})
        stream_launches = dict(pk.route_launches)
        check(len(rt.live_engines()) == 1 and pk.launches > 0 and
              pk.plain_calls == 0, f'one-shot stream: engines '
              f'{len(rt.live_engines())}, paged {stream_launches}')
        toks = [e['token'] for e in evs[:-2]]
        check(evs[-2]['tokens'] == [rows[0] + toks] and len(toks) == 16,
              'one-shot stream: streamed tokens differ from the terminal row')
        parts = [part_margin(rt, out[0], rows[0] + toks)]
    finally:
        stop_runtime(rt, server, thread)
    spec, s_server, s_thread, s_port = one_shot(['--speculative', '4'])
    try:
        t0 = time.perf_counter()
        spec_out = post(s_port, '/generate', {'tokens': rows})['tokens']
        spec_s = time.perf_counter() - t0
        spec_parts = [part_margin(spec, a, b) for a, b in zip(out, spec_out)]
    finally:
        stop_runtime(spec, s_server, s_thread)
    crt, c_server, c_thread, c_port, _ = serve_runtime(
        model, 'bf16', ['--max-total-len', '128'])
    try:
        cont = concurrently(lambda i: post(c_port, '/generate', {
            'tokens': [rows[i]], 'max_new_tokens': 80})['tokens'][0], 2)
        cont_parts = [part_margin(crt, a, b) for a, b in zip(out, cont)]
    finally:
        stop_runtime(crt, c_server, c_thread)
    emit('one_shot', card=card, max_total_len=128, rows=2, prompt_tokens=48,
         one_shot_s=one_shot_s, step_ms=1e3 * one_shot_s / 127,
         speculative_s=spec_s, stream_paged_route_launches=stream_launches,
         continuous_parts=cont_parts, speculative_parts=spec_parts,
         stream_parts=parts, part_margin_tol=PART_MARGIN_TOL)
    for label, ps_ in (('continuous', cont_parts), ('speculative', spec_parts),
                       ('stream', parts)):
        for pos, margin in ps_:
            check(pos is None or margin <= PART_MARGIN_TOL,
                  f'one-shot vs {label}: part at {pos} with top-2 margin '
                  f'{margin} > {PART_MARGIN_TOL}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.ops import lora_kernel as lk
    from skypilot_tpu_torch.ops import paged_kernel as pk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    card = card_description()
    emit('device', card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [line.strip() for log in _build.build_logs.values()
             for line in log.splitlines()
             if 'registers' in line or 'spill' in line]
    emit('build', seconds=time.perf_counter() - t0, ptxas=ptxas)

    paged_rows = phase_kernels(pk)
    lora_kernel = phase_lora_kernels(lk)
    flash_rows = phase_flash_kernels(fk)

    # The main paths, each driven with the counts zeroed just before and
    # read just after: base serving (bf16 and int8 pools), then
    # multi-LoRA serving.
    t0 = time.perf_counter()
    model = convert.init_params(
        registry.model_config('llama3-8b', 1024), seed=0, device='cuda')
    torch.cuda.synchronize()
    emit('init_weights', seconds=time.perf_counter() - t0,
         parameters=sum(p.numel() for p in model.parameters()))
    zero_paged(pk)
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    phase_serve('bf16', model, pk, lk, card)
    phase_serve('int8', model, pk, lk, card)
    launches, plain_calls = pk.launches, pk.plain_calls
    routes = dict(pk.route_launches)
    check(routes['split'] > 0 and routes['chunk'] > 0
          and routes['scalar'] == 0 and plain_calls == 0,
          f'main path: {routes} launches by route, {plain_calls} plain '
          f'calls')
    zero_paged(pk)
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    phase_serve_lora(model, pk, lk, card)
    lora_launches, lora_plain = lk.launches, lk.plain_calls
    check(lora_launches > 0 and lora_plain == 0 and pk.plain_calls == 0,
          f'LoRA path: {lora_launches} LoRA launches, {lora_plain} plain')
    phase_serve_long(model, fk, pk, card)
    phase_graph_round(model, pk, card)
    verify_launches = phase_decode_modes(model, pk, lk, card)
    # The request surface, each path counted from zero.
    phase_serve_stream(model, pk, lk, fk, card)
    phase_serve_text(model, pk, lk, fk, card)
    phase_one_shot(model, pk, lk, fk, card)
    del model
    torch.cuda.empty_cache()
    phase_serve_hf(pk, lk, fk, card)

    phase_greedy_parity(pk, lk, fk)

    # The training paths, each counted from zero.
    full_counts = phase_train_full(fk, pk, card)
    torch.cuda.empty_cache()
    lora_counts = phase_train_lora(fk, lk, card)

    for row in paged_rows:
        row['launches'] = (verify_launches
                           if row['name'] == 'paged_attention_verify'
                           else routes[row['kernel_route']])
    lora_kernel['launches'] = lora_launches
    for name, row in flash_rows.items():
        row['launches'] = full_counts[name] + lora_counts[name]
    print(card, flush=True)
    print(json.dumps({'kernels': [*paged_rows, lora_kernel,
                                  *flash_rows.values()]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:  # pylint: disable=broad-except
        traceback.print_exc()
        code = 1
    sys.exit(code)
