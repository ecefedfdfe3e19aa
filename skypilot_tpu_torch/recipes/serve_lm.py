"""LM inference server on PyTorch/CUDA (port of
skypilot_tpu/recipes/serve_lm.py).

Takes the reference's flags, so a replica manager can spawn it with the
same command line; the flags this port does not implement yet exit at
startup with an error naming them (nothing is ignored silently).
Weights come from a seeded init on the device, from a local HF
checkpoint (`--hf DIR`: llama, mistral, qwen2, gpt2, mixtral or
deepseek_v2, with its
tokenizer when the directory has one, for the text endpoints), and / or
from the newest full-parameter step `train_lm` wrote (`--ckpt-dir`).
Runs on the GPU unless `--cpu` is given; without a GPU and without
`--cpu` it exits with an error.

Model families: the Llama family (llama3-8b, qwen2-7b and their tiny
configs), GPT-2 (gpt2-124m, tiny), Mixtral (mixtral-8x7b, mixtral-tiny)
and DeepSeek (deepseek-v2-lite, deepseek-tiny). GPT-2, Mixtral and
DeepSeek refuse, as the reference does, --kv-dtype int8 and
--kv-pool-bytes (their configs have no kv_dtype field) and
--adapter-dir (no LoRA forward path); GPT-2 refuses --weight-dtype int8
(it names no quantizable projection). On Mixtral int8 covers the
attention projections, on DeepSeek wq, wo and the SwiGLU.

The continuous engine runs its dense slot path (one dense cache row a
slot) when the config's KV page pool cannot hold one --max-total-len
sequence (llama3-8b at --max-total-len 2048: 127 usable pages of 16
tokens) and always for DeepSeek, whose latent cache has no pages; it
turns prefix caching off, and --kv-spill-bytes / --kv-cold-dir exit.

  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --kv-dtype int8 --kv-pool-bytes 8000000000
  python -m skypilot_tpu_torch.recipes.serve_lm --cpu --model llama-tiny \\
      --continuous-batching       # a local probe on the CPU
  python -m skypilot_tpu_torch.recipes.serve_lm --model mixtral-8x7b \\
      --continuous-batching --max-total-len 1024
  python -m skypilot_tpu_torch.recipes.serve_lm --cpu --model \\
      deepseek-tiny --continuous-batching    # MLA on the dense path
  python -m skypilot_tpu_torch.recipes.serve_lm --hf ckpts/Llama-3-8B \\
      --continuous-batching       # text, chat and SSE endpoints
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --adapter-dir adapters/ --max-adapters 4
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --speculative 4     # or --decode-chunk 4
  # int8 projection weights (per-output-channel scales), served through
  # the W8A16 kernel of ops/int8_linear.py
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --weight-dtype int8
  # disaggregated serving: a decode replica, and a prefill replica that
  # hands each prompt's KV page chain to it (falling back to local
  # serving when the transfer fails)
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --role decode --port 8001
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --role prefill --decode-peers 127.0.0.1:8001
  # tiered prefix cache: evicted pages spill to 4 GB of host RAM, and
  # from there to a local directory
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --kv-spill-bytes 4000000000 \\
      --kv-cold-dir /var/cache/kv

POST /kv/import, /kv/peers, /kv/evacuate and /kv/migrate serve the
fleet's handoffs and live migrations; on SIGTERM or a spot preemption
notice the replica evacuates its sessions' KV chains to its peers
before it exits.

Observability and chaos, as the reference's: GET /metrics (Prometheus
text), /debug/trace/<id> and /debug/flight; `--trace-sample P`
(`--trace-seed S`) head-samples requests into spans, `--slo SPEC` adds
/stats' `slo` block and the skypilot_serving_slo_* gauges, and
`--fault-plan JSON` (or the STPU_FAULT_PLAN environment variable) arms
the fault points (engine.*, http.handler, kv.*, adapters.load,
serve.preempt_notice) before the engine starts:

  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \
      --continuous-batching --trace-sample 0.1 --trace-seed 0 \
      --slo p99_ttft_ms=500,p99_itl_ms=100,error_rate=0.01 \
      --fault-plan '{"seed":0,"rules":[{"point":"engine.decode_step",
      "at":[5]}]}'

Without --continuous-batching the server runs the one-shot engine, as
the reference does: each request alone, every step of its power-of-two
bucket run, through a dense per-request cache; streamed and adapter
requests then run on a small slot engine built at first use.

Decode rounds are pipelined (round N+1 is dispatched before round N is
committed) unless --no-pipeline-decode, --speculative or --decode-chunk
is given, and on the GPU each single-token step replays one captured
CUDA graph.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.recipes.serve_lm')
    p.add_argument('--model', default='llama-tiny',
                   help='llama3-8b, llama-tiny, qwen2-7b, qwen-tiny, '
                        'gpt2-124m, tiny, mixtral-8x7b, mixtral-tiny, '
                        'deepseek-v2-lite or deepseek-tiny')
    p.add_argument('--max-total-len', type=int, default=256)
    p.add_argument('--continuous-batching', action='store_true',
                   help='slot-based engine (default: the one-shot '
                        'engine)')
    p.add_argument('--num-slots', type=int, default=8)
    p.add_argument('--prefill-chunk', type=int, default=256, metavar='C',
                   help='chunked prefill: prompts prefill in C-token '
                        'chunks interleaved with decode steps; 0 = '
                        'whole-prompt prefill')
    p.add_argument('--prefill-budget', type=int, default=0, metavar='T',
                   help='max prefill tokens per scheduler iteration '
                        '(default: one chunk)')
    p.add_argument('--no-pipeline-decode', action='store_true',
                   help='disable one-step host/device pipelining of '
                        'decode rounds (on by default; it turns itself '
                        'off with --speculative or --decode-chunk)')
    p.add_argument('--decode-chunk', type=int, default=1, metavar='N',
                   help='N single-token decode steps per dispatch (N '
                        'CUDA-graph replays, one host fetch); clamps '
                        'max_total_len to max_seq_len - N')
    p.add_argument('--speculative', type=int, default=0, metavar='K',
                   help='prompt-lookup speculative decoding: verify K '
                        'drafted tokens per round in one [slots, K+1] '
                        'chunk (greedy output unchanged); clamps '
                        'max_total_len to max_seq_len - K')
    p.add_argument('--no-prefix-caching', action='store_true',
                   help='disable shared-prefix KV page reuse')
    p.add_argument('--kv-dtype', choices=['bf16', 'int8'], default='bf16',
                   help='KV page-pool storage: int8 stores quantized '
                        'pages + per-slot f32 scales')
    p.add_argument('--kv-pool-bytes', type=int, default=0, metavar='B',
                   help='size the KV pool by device bytes (0 = model '
                        'default page count)')
    p.add_argument('--port', type=int,
                   default=int(os.environ.get('SKYPILOT_SERVE_PORT', 8000)))
    p.add_argument('--zone', default='', help='placement label, echoed '
                                              'in /stats')
    p.add_argument('--drain-grace', type=float, default=630.0,
                   help='SIGTERM drain: seconds to wait for in-flight '
                        'requests before exiting')
    p.add_argument('--request-timeout', type=float, default=600.0,
                   help='per-request deadline ceiling, seconds')
    p.add_argument('--max-queue-requests', type=int, default=0,
                   metavar='N', help='shed (429) once N requests wait')
    p.add_argument('--max-queue-tokens', type=int, default=0, metavar='T',
                   help='shed once queued prompts hold T tokens')
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (default: the GPU)')
    p.add_argument('--adapter-dir', default=None, metavar='DIR',
                   help='multi-LoRA serving: a local or gs:// '
                        'directory of adapter artifacts '
                        '(<name>/adapter_config.json + weights, '
                        'the train_lm --lora output). The '
                        '`model` field on /v1/* and /generate* '
                        'selects an adapter by name; adapters '
                        'hot-load on first use and LRU-evict '
                        'under the --max-adapters device budget')
    p.add_argument('--max-adapters', type=int, default=8, metavar='N',
                   help='device-resident adapter slots in the '
                        'stacked LoRA store (memory = N x '
                        'per-adapter factor bytes; see '
                        'docs/guides.md "Multi-LoRA serving")')
    p.add_argument('--max-lora-rank', type=int, default=0, metavar='R',
                   help='store rank ceiling (smaller-rank '
                        'adapters zero-pad). 0 = the max rank '
                        'seen in --adapter-dir at startup; set '
                        'it explicitly if bigger-rank adapters '
                        'will be hot-dropped in later')
    p.add_argument('--hf', default=None, metavar='DIR',
                   help='serve a local HF checkpoint directory (llama, '
                        'mistral, qwen2, gpt2, mixtral; safetensors or '
                        'pytorch_model.bin); its tokenizer files enable '
                        '/generate_text and the text / chat endpoints')
    p.add_argument('--ckpt-dir', default=None,
                   help='serve the newest full-parameter step a '
                        'train_lm run wrote there')
    p.add_argument('--param-dtype', choices=['bf16', 'f32'],
                   default='bf16',
                   help='weight storage; f32 keeps f32 weights, cast to '
                        'bf16 where they are used')
    p.add_argument('--role', choices=['', 'prefill', 'decode'], default='',
                   help='disaggregated serving role. "prefill": prefill '
                        'prompts and hand the KV page chain to a decode '
                        'peer (POST /kv/import) instead of decoding '
                        'locally, falling back to local serving when the '
                        'transfer fails; "decode": a label (pool '
                        'membership). Default: unified. prefill needs '
                        '--continuous-batching')
    p.add_argument('--decode-peers', default=None, metavar='HOST:PORT,...',
                   help='static decode pool for --role prefill (the '
                        'fleet controller pushes the live set through '
                        'POST /kv/peers instead)')
    p.add_argument('--kv-spill-bytes', type=int, default=0, metavar='B',
                   help='tiered prefix cache: spill evicted KV pages '
                        '(payload + scales + chain key) into a host-RAM '
                        'LRU of at most B bytes instead of dropping '
                        'them; a later chain-key hit restores the exact '
                        'bytes. 0 = off. Needs --continuous-batching')
    p.add_argument('--kv-cold-dir', default=None, metavar='DIR',
                   help='cold tier behind --kv-spill-bytes: pages '
                        'LRU-evicted from host RAM land in the local '
                        'directory DIR and survive restarts (gs:// '
                        'prefixes are not ported yet)')
    # Observability and chaos: the reference's flags and help text.
    p.add_argument('--fault-plan', default=None, metavar='JSON',
                   help='chaos testing: a fault plan (inline '
                        'JSON or a path to a JSON file) arming '
                        'the skypilot_tpu_torch.robustness.faults '
                        'injection points in this process; see '
                        'docs/guides.md "Serving robustness". '
                        'Equivalent to the STPU_FAULT_PLAN env '
                        'var. Never set this in production')
    p.add_argument('--trace-sample', type=float, default=0.0,
                   metavar='P',
                   help='distributed request tracing: sample '
                        'this fraction of requests (0..1) into '
                        'Chrome-trace spans, served at GET '
                        '/debug/trace/<id> and merged across '
                        'processes by `stpu trace`. Requests '
                        'arriving with an x-skypilot-trace '
                        'header are always traced (the caller '
                        'already paid the sampling decision). '
                        '0 = off (zero overhead)')
    p.add_argument('--trace-seed', type=int, default=None,
                   help='seed the trace sampler: the sampled '
                        'set and its ids become reproducible')
    p.add_argument('--slo', default=None, metavar='SPEC',
                   help='declarative serving SLOs, e.g. '
                        '"p99_ttft_ms=500,p99_itl_ms=100,'
                        'error_rate=0.01,shed_rate=0.05": '
                        '/stats grows an `slo` section with '
                        'multi-window burn rates and the '
                        'skypilot_serving_slo_* gauges go live '
                        '(docs/guides.md "Tracing & SLOs")')
    p.add_argument('--weight-dtype', choices=['bf16', 'int8'],
                   default='bf16',
                   help='serving storage for the projection '
                        'weights (wq/wk/wv/wo, w_gate/w_up/'
                        'w_down). int8 = per-output-channel '
                        'symmetric quantization, dequantized on '
                        'read inside the jitted fns — halves '
                        'weight-streaming HBM bandwidth; '
                        'embeddings/norms/head stay bf16. '
                        'Composes with --tensor (scales shard '
                        'with their channel) and LoRA (deltas '
                        'ride the dequantized base)')
    # Tensor x pipeline serving (parallel/serving.py): the reference's
    # flags, over the first --stages x --tensor distinct CUDA cards.
    p.add_argument('--tensor', type=int, default=1,
                   help='tensor-parallel serving over N devices: heads, '
                        'MLP and vocab split over them, the KV pool\'s '
                        'kv heads too (GQA remainder rule: whole on '
                        'each when they do not divide)')
    p.add_argument('--stages', type=int, default=1,
                   help='pipeline-parallel serving over S stages of '
                        'contiguous layers, each on its own row of '
                        '--tensor devices (total S x --tensor); needs '
                        '--continuous-batching and num_slots a multiple '
                        'of S (the decode ring runs S slot groups)')
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: exits (status 2) naming every flag this port
    cannot honor, on an --slo spec the reference refuses (its message),
    and on the reference's refusals of int8 KV pages, the spill tier and
    the prefill role in the one-shot mode (and of a remote cold tier),
    of int8 weights with --ckpt-dir, and of --stages where the reference
    refuses it."""
    from skypilot_tpu_torch.inference.runtime import (INT8_NEEDS_CONTINUOUS,
                                                      INT8_WEIGHTS_NO_CKPT,
                                                      kv_chain_refusal,
                                                      staged_refusal,
                                                      unsupported_flags)
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = unsupported_flags(args)
    if bad:
        parser.error('not supported by the PyTorch port yet: '
                     + ', '.join(bad))
    if args.slo:
        # Fail fast at startup, not at the first scrape.
        from skypilot_tpu_torch.observability import slo as slo_lib
        try:
            slo_lib.parse_slo(args.slo)
        except ValueError as e:
            parser.error(str(e))
    if args.kv_dtype == 'int8' and not args.continuous_batching:
        parser.error(INT8_NEEDS_CONTINUOUS)
    if args.weight_dtype == 'int8' and args.ckpt_dir:
        parser.error(INT8_WEIGHTS_NO_CKPT)
    refusal = kv_chain_refusal(args) or staged_refusal(args)
    if refusal:
        parser.error(refusal)
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from skypilot_tpu_torch.device import NoCudaDeviceError
    from skypilot_tpu_torch.inference.http_server import serve
    from skypilot_tpu_torch.inference.runtime import build_runtime
    try:
        rt = build_runtime(args)
    except NoCudaDeviceError as e:
        print(f'serve_lm: {e}', file=sys.stderr, flush=True)
        sys.exit(1)
    serve(rt, args.port, drain_grace=args.drain_grace, zone=args.zone)


if __name__ == '__main__':
    main()
