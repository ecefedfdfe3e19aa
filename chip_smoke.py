#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch/) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (`serve_lm --continuous-batching` on a
paged KV pool, base model and multi-LoRA) through the entry points a
user calls, at the full width of Llama-3-8B with seeded random weights
and adapters, and holds every CUDA kernel of those paths against its
plain PyTorch version. Phases, one JSON line each; any failure exits
non-zero before the result lines:

  device         card name and power limit, torch/CUDA versions
  build          nvcc build of every kernel from skypilot_tpu_torch/csrc
  kernels        paged attention at Llama-3-8B's head shape (Hq=32,
                 Hkv=8, D=128, page 16) vs its plain version, for
                 {bf16, int8, f32} pools x {decode S=1 B=8, chunk S=256
                 B=1} with contexts ending mid-page, on a page boundary
                 and fully masked; the perturbed control must fail;
                 timings (CUDA events, L2-cold) vs the plain version
                 and scaled_dot_product_attention on gathered K/V
  lora_kernels   QKV LoRA at Llama-3-8B width (d=4096, q 4096, k/v
                 1024), ranks {8, 16, 64} x {bf16, f32} x {decode B=8
                 S=1 with ids [0,1,1,2,3,0,2,1], chunk B=1 S=256} vs its
                 plain version, id-0 rows exactly 0; the perturbed
                 control must fail; L2-cold timings vs the bound and the
                 gathered-bmm route
  serve_bf16,    build_runtime with serve_lm's flags, make_server on an
  serve_int8     ephemeral port, 8 concurrent greedy /generate requests
                 (300-700 prompt tokens, two sharing a 256-token
                 prefix, 32 new tokens); every answer has prompt + 32
                 tokens, the kernel's launch count grew and the plain
                 route was never taken; no LoRA code runs
  serve_lora     the same weights with --adapter-dir (3 seeded adapters:
                 attn r8, attn r16, attn-mlp r16) --max-adapters 3 and a
                 bf16 pool: 8 concurrent requests (2 base, 2 per adapter,
                 two under different adapters sharing a 256-token
                 prefix); then prefix hits only within a tenant, a 4th
                 adapter hot-loads with one eviction, an unknown model
                 is a 404; both kernels launched, no plain call
  greedy_parity  a 2-layer model at Llama-3-8B width (f32 weights and
                 pool): the engine's greedy tokens through the kernels
                 equal those through the plain versions (4 base and 2
                 adapter requests x 16)

Then, as the last three lines: the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`), the kernels JSON
line, and {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""
import json
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
TOL = {'f32': 1e-5, 'bf16': 2e-2, 'int8': 2e-2}
HQ, HKV, D, PAGE = 32, 8, 128, 16
PAGED_ATTENTION_TPU = 'skypilot_tpu/ops/pallas_paged.py:224'
QKV_LORA_TPU = 'skypilot_tpu/ops/pallas_paged.py:386'
# Both the kernel and its plain version accumulate in f32 from the same
# (bf16 or f32) inputs; only the order of the sums differs.
LORA_TOL = 1e-5
D_MODEL, D_Q, D_KV = 4096, 4096, 1024
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                    'chip_smoke')


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- kernels ---------------------------------------------------------------
def paged_case(kind, batch, seq, ctx_end, pps, seed, masked_rows=0):
    """Inputs at Llama-3-8B's head shape. Row b's queries sit at
    positions ctx_end[b] - seq + 1 .. ctx_end[b]; the first
    `masked_rows` queries of row 0 see nothing (position -1)."""
    dev = 'cuda'
    rng = np.random.default_rng(seed)
    total = batch * pps + 1
    tbl = (1 + rng.permutation(total - 1)[:batch * pps]).reshape(batch, pps)
    shape = (HKV, total, PAGE, D)
    g = torch.Generator(dev).manual_seed(seed)
    if kind == 'int8':
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((total, PAGE), generator=g, device=dev) * 0.02
        vs = torch.rand((total, PAGE), generator=g, device=dev) * 0.02
        qdt = torch.bfloat16
    else:
        dt = torch.float32 if kind == 'f32' else torch.bfloat16
        k = torch.randn(shape, generator=g, device=dev).to(dt)
        v = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
        qdt = dt
    q = torch.randn((batch, seq, HQ, D), generator=g, device=dev).to(qdt)
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
    per_token = 2 * HKV * D * kv.element_size()
    if c['k_scales'] is not None:
        per_token += 2 * 4
    io = 2 * c['q'].numel() * c['q'].element_size()
    idx = 4 * (c['positions'].numel() + c['page_indices'].numel())
    return visible * per_token + io + idx


def must_flops(c):
    """4 * D flops (q.k and p.v) per query head per (query, visible
    token) pair."""
    pos = c['positions'].cpu().numpy()
    return 4.0 * D * HQ * float(np.maximum(pos + 1, 0).sum())


def bound_ms(c):
    t_bytes = must_bytes(c) / HBM_BYTES_PER_S
    peak = F32_FLOPS if c['q'].dtype == torch.float32 else BF16_FLOPS
    t_ops = must_flops(c) / peak
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(fns, iters=60, warmup=6):
    """Mean ms per call over `iters` calls cycling through `fns` (each
    on its own inputs, so together they exceed the 50 MB L2 and every
    call finds its K/V cold, as a layer does in a real decode step)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fns[i % len(fns)]()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def dense_kv(c):
    """K/V of the case gathered dense (bf16, [B, Hkv, T, D]) for the
    library yardstick; int8 pages are dequantized first."""
    from skypilot_tpu_torch.ops.paged_attention import _gather_kv
    k, v = _gather_kv(HKV, c['k_pages'], c['v_pages'], c['page_indices'],
                      c['k_scales'], c['v_scales'])
    return (k.to(torch.bfloat16).transpose(1, 2).contiguous(),
            v.to(torch.bfloat16).transpose(1, 2).contiguous())


def sdpa_fn(q, k, v):
    """scaled_dot_product_attention over [B, H, S, D]; GQA through
    enable_gqa where this torch has it, else heads expanded first."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q[:1], k[:1], v[:1], enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        k2 = k.repeat_interleave(rep, dim=1)
        v2 = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2)


def phase_kernels(pk):
    cases = []
    decode_ends = [999, 1023, 0, 16, 511, 776, 1, 1022]   # lengths - 1
    for kind in ('bf16', 'int8', 'f32'):
        for label, batch, seq, ends, pps, masked in (
                ('decode', 8, 1, decode_ends, 64, 1),
                ('chunk', 1, 256, [555], 48, 16)):
            c = paged_case(kind, batch, seq, ends, pps, seed=len(cases),
                           masked_rows=masked)
            out = call(pk, c)
            ref = plain(pk, c)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            pos = c['positions']
            masked_zero = bool((out[pos < 0].float() == 0).all())
            finite = bool(torch.isfinite(out.float()).all())
            case = {'pool': kind, 'shape': label, 'batch': batch,
                    'seq': seq, 'max_abs_err': err, 'tol': TOL[kind],
                    'masked_rows_zero': masked_zero, 'finite': finite}
            cases.append(case)
            check(err <= TOL[kind] and masked_zero and finite,
                  f'kernel disagrees with its plain version: {case}')
    c = paged_case('bf16', 8, 1, decode_ends, 64, seed=99)
    bad = call(pk, c, perturb=0.5)
    perturb_err = (bad.float() - plain(pk, c).float()).abs().max().item()
    check(perturb_err > TOL['bf16'],
          f'perturbed kernel passed the pin (err {perturb_err})')

    # Timings at decode B=8, context 1024, and the chunk shape.
    timings = {}
    lib = None
    for kind in ('bf16', 'int8'):
        for label, batch, seq, ends, pps in (
                ('decode', 8, 1, [1023] * 8, 64),
                ('chunk', 1, 256, [1023], 64)):
            sets = [paged_case(kind, batch, seq, ends, pps, seed=100 + i)
                    for i in range(4)]
            ms = time_ms([lambda c=c: call(pk, c) for c in sets])
            plain_ms = time_ms([lambda c=c: plain(pk, c) for c in sets],
                               iters=12, warmup=2)
            b_ms, b_by = bound_ms(sets[0])
            entry = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                     'bound_by': b_by, 'bytes': must_bytes(sets[0])}
            if label == 'decode':
                dense = [dense_kv(c) for c in sets]
                qs = [c['q'].transpose(1, 2).contiguous() for c in sets]
                entry['library_ms'] = time_ms(
                    [sdpa_fn(q, k, v) for q, (k, v) in zip(qs, dense)])
            timings[f'{kind}_{label}'] = entry
            del sets
    main = timings['bf16_decode']
    emit('kernels', cases=cases, perturb_err=perturb_err,
         perturb_fails=True, timings=timings,
         kernels=['paged_attention'])
    return {'name': 'paged_attention', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_attention.cu',
            'replaces': PAGED_ATTENTION_TPU,
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': main['library_ms']}


# -- QKV LoRA kernel --------------------------------------------------------
def lora_case(dtype, rank, batch, seq, ids, seed, n_adapters=4):
    """Stacked factors at Llama-3-8B width (row 0 zeros: the base model)
    and inputs, on the card."""
    g = torch.Generator('cuda').manual_seed(seed)

    def factors(d_out):
        a = torch.randn((n_adapters, D_MODEL, rank), generator=g,
                        device='cuda') * 0.02
        b = torch.randn((n_adapters, rank, d_out), generator=g,
                        device='cuda') * 0.02
        a[0] = 0
        b[0] = 0
        return {'a': a.to(dtype), 'b': b.to(dtype)}

    x = torch.randn((batch, seq, D_MODEL), generator=g,
                    device='cuda').to(dtype)
    return {'x': x, 'f': [factors(D_Q), factors(D_KV), factors(D_KV)],
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
    peak = F32_FLOPS if c['f'][0]['a'].dtype == torch.float32 \
        else BF16_FLOPS
    distinct = len(set(c['ids'].tolist()))
    per_row = sum(f[k][0].numel() * f[k].element_size() for f in c['f']
                  for k in ('a', 'b'))
    outs = 4 * batch * seq * (D_Q + 2 * D_KV)
    n_bytes = x.numel() * x.element_size() + distinct * per_row + outs \
        + 4 * batch
    flops = 2.0 * batch * seq * (3 * d_in * rank + rank * (D_Q + 2 * D_KV))
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


def gathered_bmm(c):
    """The yardstick: one gathered `torch.bmm` chain per projection."""
    x, ids = c['x'], c['ids']
    return [torch.bmm(torch.bmm(x.float(), f['a'][ids].float()),
                      f['b'][ids].float()) for f in c['f']]


def phase_lora_kernels(lk):
    cases = []
    shapes = (('decode', 8, 1, [0, 1, 1, 2, 3, 0, 2, 1]),
              ('chunk', 1, 256, [2]))
    for dtype in (torch.bfloat16, torch.float32):
        for rank in (8, 16, 64):
            for label, batch, seq, ids in shapes:
                c = lora_case(dtype, rank, batch, seq, ids, seed=len(cases))
                out = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'])
                ref = lk.fused_qkv_lora_delta_reference(c['x'], *c['f'],
                                                        c['ids'])
                torch.cuda.synchronize()
                err = max((o - r).abs().max().item()
                          for o, r in zip(out, ref))
                base_rows = c['ids'] == 0
                base_zero = all(not o[base_rows].any() for o in out)
                finite = all(bool(torch.isfinite(o).all()) for o in out)
                shape_ok = [tuple(o.shape) for o in out] == [
                    (batch, seq, D_Q), (batch, seq, D_KV), (batch, seq, D_KV)]
                case = {'dtype': str(dtype).split('.')[-1], 'rank': rank,
                        'shape': label, 'batch': batch, 'seq': seq,
                        'max_abs_err': err, 'tol': LORA_TOL,
                        'base_rows_zero': base_zero, 'finite': finite}
                cases.append(case)
                check(err <= LORA_TOL and base_zero and finite and shape_ok,
                      f'QKV LoRA kernel disagrees with its plain version: '
                      f'{case}')
    c = lora_case(torch.bfloat16, 16, 8, 1, shapes[0][3], seed=99)
    bad = lk.fused_qkv_lora_delta(c['x'], *c['f'], c['ids'], perturb=0.5)
    ref = lk.fused_qkv_lora_delta_reference(c['x'], *c['f'], c['ids'])
    perturb_err = max((o - r).abs().max().item() for o, r in zip(bad, ref))
    check(perturb_err > LORA_TOL,
          f'perturbed LoRA kernel passed the pin (err {perturb_err})')

    timings = {}
    for rank in (16, 64):
        for label, batch, seq, ids in shapes:
            c = lora_case(torch.bfloat16, rank, batch, seq, ids, seed=200)
            args = (c['x'], *c['f'], c['ids'])
            b_ms, b_by, n_bytes = lora_bound_ms(c)
            timings[f'bf16_r{rank}_{label}'] = {
                'ms': time_cold_ms(lambda: lk.fused_qkv_lora_delta(*args)),
                'plain_ms': time_cold_ms(
                    lambda: lk.fused_qkv_lora_delta_reference(*args)),
                'library_ms': time_cold_ms(lambda: gathered_bmm(c)),
                'library': 'gathered torch.bmm per projection',
                'bound_ms': b_ms, 'bound_by': b_by, 'bytes': n_bytes,
                'device_launches_per_call': lk.DEVICE_LAUNCHES_PER_CALL}
    main = timings['bf16_r16_decode']
    emit('lora_kernels', cases=cases, perturb_err=perturb_err,
         perturb_fails=True, timings=timings)
    return {'name': 'qkv_lora', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/qkv_lora.cu',
            'replaces': QKV_LORA_TPU,
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': main['library_ms']}


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


def serve_runtime(model, kv_dtype, extra=()):
    """build_runtime with serve_lm's flags and make_server on an
    ephemeral port, serving from a thread: (rt, server, thread, port,
    setup seconds)."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        kv_dtype, '--kv-pool-bytes', '8000000000', '--port', '0',
        *extra])
    t0 = time.perf_counter()
    rt = build_runtime(args, model=model)
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
        'decode_rounds': delta('decode_calls'),
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


def phase_greedy_parity(pk, lk):
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
    for impl in ('cuda', 'torch'):
        engine = ContinuousBatchingEngine(
            model, num_slots=4, max_total_len=1024, prefill_chunk=256,
            adapter_store=AdapterRegistry(root, model, max_adapters=2))
        counts0 = [(k.launches, k.plain_calls) for k in (pk, lk)]
        try:
            with pk.impl_scope(impl):    # routes both kernels
                futs = [engine.submit(p, max_new_tokens=16, adapter=m)
                        for p, m in zip(ps, models)]
                outs[impl] = [f.result(timeout=600) for f in futs]
        finally:
            engine.stop()
        for k, (l0, p0) in zip((pk, lk), counts0):
            routed = k.launches - l0 if impl == 'cuda' else k.plain_calls - p0
            check(routed > 0, f'impl {impl} of {k.__name__} was never taken')
    same = outs['cuda'] == outs['torch']
    emit('greedy_parity', requests=len(ps), new_tokens=16, layers=2,
         models=models, equal=same,
         tokens_cuda=[o[-16:] for o in outs['cuda']],
         tokens_torch=[o[-16:] for o in outs['torch']])
    check(same, 'greedy tokens differ between the kernel and plain routes')
    check(len({tuple(outs['cuda'][i][-16:]) for i in (0, 4, 5)}) == 3,
          'the adapters did not change the greedy tokens')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
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

    kernel = phase_kernels(pk)
    lora_kernel = phase_lora_kernels(lk)

    # The main paths, each driven with the counts zeroed just before and
    # read just after: base serving (bf16 and int8 pools), then
    # multi-LoRA serving.
    t0 = time.perf_counter()
    model = convert.init_params(
        registry.model_config('llama3-8b', 1024), seed=0, device='cuda')
    torch.cuda.synchronize()
    emit('init_weights', seconds=time.perf_counter() - t0,
         parameters=sum(p.numel() for p in model.parameters()))
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    phase_serve('bf16', model, pk, lk, card)
    phase_serve('int8', model, pk, lk, card)
    launches, plain_calls = pk.launches, pk.plain_calls
    check(launches > 0 and plain_calls == 0,
          f'main path: {launches} launches, {plain_calls} plain calls')
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    phase_serve_lora(model, pk, lk, card)
    lora_launches, lora_plain = lk.launches, lk.plain_calls
    check(lora_launches > 0 and lora_plain == 0 and pk.plain_calls == 0,
          f'LoRA path: {lora_launches} LoRA launches, {lora_plain} plain')
    del model
    torch.cuda.empty_cache()

    phase_greedy_parity(pk, lk)

    kernel['launches'] = launches
    lora_kernel['launches'] = lora_launches
    print(card, flush=True)
    print(json.dumps({'kernels': [kernel, lora_kernel]}), flush=True)
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
