#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch/) on one GPU.

    python3 chip_smoke.py

Drives the port's main path (`serve_lm --continuous-batching` on a
paged KV pool) through the entry points a user calls, at the full width
of Llama-3-8B with seeded random weights, and holds every CUDA kernel
of that path against its plain PyTorch version. Phases, one JSON line
each; any failure exits non-zero before the result lines:

  device         card name and power limit, torch/CUDA versions
  build          nvcc build of every kernel from skypilot_tpu_torch/csrc
  kernels        paged attention at Llama-3-8B's head shape (Hq=32,
                 Hkv=8, D=128, page 16) vs its plain version, for
                 {bf16, int8, f32} pools x {decode S=1 B=8, chunk S=256
                 B=1} with contexts ending mid-page, on a page boundary
                 and fully masked; the perturbed control must fail;
                 timings (CUDA events, L2-cold) vs the plain version
                 and scaled_dot_product_attention on gathered K/V
  serve_bf16,    build_runtime with serve_lm's flags, make_server on an
  serve_int8     ephemeral port, 8 concurrent greedy /generate requests
                 (300-700 prompt tokens, two sharing a 256-token
                 prefix, 32 new tokens); every answer has prompt + 32
                 tokens, the kernel's launch count grew and the plain
                 route was never taken
  greedy_parity  a 2-layer model at Llama-3-8B width (f32 weights and
                 pool): the engine's greedy tokens through the kernel
                 equal those through the plain version (4 requests x 16)

Then, as the last three lines: the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`), the kernels JSON
line, and {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""
import json
import os
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores
TOL = {'f32': 1e-5, 'bf16': 2e-2, 'int8': 2e-2}
HQ, HKV, D, PAGE = 32, 8, 128, 16
PAGED_ATTENTION_TPU = 'skypilot_tpu/ops/pallas_paged.py:224'


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


def phase_serve(kv_dtype, model, pk, card):
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        kv_dtype, '--kv-pool-bytes', '8000000000', '--port', '0'])
    t0 = time.perf_counter()
    rt = build_runtime(args, model=model)
    setup_s = time.perf_counter() - t0
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        ps = prompts()
        # Warm-up request (first-call allocator and cuBLAS set-up).
        post(port, '/generate', {'tokens': [ps[0][:64]],
                                 'max_new_tokens': 2})
        rt.metrics = type(rt.metrics)()
        launches0, plain0 = pk.launches, pk.plain_calls
        stats0 = rt.engine.stats()
        results = [None] * len(ps)
        lat = [0.0] * len(ps)

        def one(i):
            t = time.perf_counter()
            results[i] = post(port, '/generate',
                              {'tokens': [ps[i]], 'max_new_tokens': 32,
                               'temperature': 0.0})['tokens'][0]
            lat[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(ps))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = pk.launches - launches0
        plain_calls = pk.plain_calls - plain0
        stats = rt.engine.stats()
        for i, (row, p) in enumerate(zip(results, ps)):
            check(row is not None and len(row) == len(p) + 32
                  and row[:len(p)] == p
                  and all(0 <= t < rt.vocab_size for t in row),
                  f'request {i}: bad answer')
        check(launches > 0, 'the paged-attention kernel never launched')
        check(plain_calls == 0, f'plain route taken {plain_calls} times')
        metrics = rt.metrics.snapshot()
        steady_s = stats['steady_decode_s'] - stats0['steady_decode_s']
        steady_tok = (stats['steady_decode_tokens']
                      - stats0['steady_decode_tokens'])
        steady_rounds = (stats['steady_decode_rounds']
                         - stats0['steady_decode_rounds'])
        emit(f'serve_{kv_dtype}', card=card, requests=len(ps),
             answered=sum(r is not None for r in results),
             prompt_tokens=sum(len(p) for p in ps), new_tokens=32,
             kv_pages=rt.engine.total_pages, setup_s=setup_s,
             wall_s=wall, tokens_per_s=32 * len(ps) / wall,
             ttft_p50_s=metrics['ttft_p50_s'],
             ttft_max_s=metrics['ttft_p99_s'],
             e2e_p50_s=float(np.median(lat)), e2e_max_s=max(lat),
             decode_tokens_per_s=(steady_tok / steady_s if steady_s
                                  else None),
             decode_round_ms=(1e3 * steady_s / steady_rounds
                              if steady_rounds else None),
             decode_rounds=stats['decode_calls'] - stats0['decode_calls'],
             prefill_chunks=(stats['prefill_chunks']
                             - stats0['prefill_chunks']),
             kernel_launches=launches, plain_calls=plain_calls)
        return launches
    finally:
        server.shutdown()
        rt.stop()
        thread.join(timeout=30)


def phase_greedy_parity(pk):
    import dataclasses
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 1024),
                              num_layers=2, dtype=torch.float32,
                              kv_total_pages=4 * 64 + 1)
    model = convert.init_params(cfg, seed=1, device='cuda')
    ps = [p[:400] for p in prompts(seed=1, n=4)]
    outs = {}
    for impl in ('cuda', 'torch'):
        engine = ContinuousBatchingEngine(model, num_slots=4,
                                          max_total_len=1024,
                                          prefill_chunk=256)
        launches0, plain0 = pk.launches, pk.plain_calls
        try:
            with pk.impl_scope(impl):
                futs = [engine.submit(p, max_new_tokens=16) for p in ps]
                outs[impl] = [f.result(timeout=600) for f in futs]
        finally:
            engine.stop()
        routed = (pk.launches - launches0 if impl == 'cuda'
                  else pk.plain_calls - plain0)
        check(routed > 0, f'impl {impl} was never taken')
    same = outs['cuda'] == outs['torch']
    emit('greedy_parity', requests=len(ps), new_tokens=16, layers=2,
         equal=same, tokens_cuda=[o[-16:] for o in outs['cuda']],
         tokens_torch=[o[-16:] for o in outs['torch']])
    check(same, 'greedy tokens differ between the kernel and plain routes')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
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

    # The main path: both serving runs, counts zeroed just before.
    t0 = time.perf_counter()
    model = convert.init_params(
        registry.model_config('llama3-8b', 1024), seed=0, device='cuda')
    torch.cuda.synchronize()
    emit('init_weights', seconds=time.perf_counter() - t0,
         parameters=sum(p.numel() for p in model.parameters()))
    pk.launches = pk.plain_calls = 0
    phase_serve('bf16', model, pk, card)
    phase_serve('int8', model, pk, card)
    launches, plain_calls = pk.launches, pk.plain_calls
    check(launches > 0 and plain_calls == 0,
          f'main path: {launches} launches, {plain_calls} plain calls')
    del model
    torch.cuda.empty_cache()

    phase_greedy_parity(pk)

    kernel['launches'] = launches
    print(card, flush=True)
    print(json.dumps({'kernels': [kernel]}), flush=True)
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
