"""LM inference server on PyTorch/CUDA (port of
skypilot_tpu/recipes/serve_lm.py).

Takes the reference's flags, so a replica manager can spawn it with the
same command line; the flags this port does not implement yet exit at
startup with an error naming them (nothing is ignored silently).
Weights come from a seeded init on the device, from a local HF
checkpoint (`--hf DIR`: llama, mistral or qwen2, with its tokenizer
when the directory has one, for the text endpoints), and / or from the
newest full-parameter step `train_lm` wrote (`--ckpt-dir`). Runs on
the GPU unless `--cpu` is given; without a GPU and without `--cpu` it
exits with an error.

  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --kv-dtype int8 --kv-pool-bytes 8000000000
  python -m skypilot_tpu_torch.recipes.serve_lm --cpu --model llama-tiny \\
      --continuous-batching       # a local probe on the CPU
  python -m skypilot_tpu_torch.recipes.serve_lm --hf ckpts/Llama-3-8B \\
      --continuous-batching       # text, chat and SSE endpoints
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --adapter-dir adapters/ --max-adapters 4
  python -m skypilot_tpu_torch.recipes.serve_lm --model llama3-8b \\
      --continuous-batching --speculative 4     # or --decode-chunk 4

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
                   help='llama3-8b, llama-tiny, qwen2-7b or qwen-tiny')
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
                        'mistral, qwen2; safetensors or '
                        'pytorch_model.bin); its tokenizer files enable '
                        '/generate_text and the text / chat endpoints')
    p.add_argument('--ckpt-dir', default=None,
                   help='serve the newest full-parameter step a '
                        'train_lm run wrote there')
    p.add_argument('--param-dtype', choices=['bf16', 'f32'],
                   default='bf16',
                   help='weight storage; f32 keeps f32 weights, cast to '
                        'bf16 where they are used')
    # The reference's flags for features this port does not have yet:
    # parsed so the command line stays the same, refused if used.
    p.add_argument('--tensor', type=int, default=1)
    p.add_argument('--stages', type=int, default=1)
    p.add_argument('--weight-dtype', choices=['bf16', 'int8'],
                   default='bf16')
    p.add_argument('--role', choices=['', 'prefill', 'decode'], default='')
    p.add_argument('--decode-peers', default=None, metavar='HOST:PORT,...')
    p.add_argument('--kv-spill-bytes', type=int, default=0, metavar='B')
    p.add_argument('--kv-cold-dir', default=None, metavar='DIR')
    p.add_argument('--fault-plan', default=None, metavar='JSON')
    p.add_argument('--trace-sample', type=float, default=0.0, metavar='P')
    p.add_argument('--trace-seed', type=int, default=None)
    p.add_argument('--slo', default=None, metavar='SPEC')
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: exits (status 2) naming every flag this port
    cannot honor, and on the reference's refusal of int8 KV pages in
    the one-shot mode."""
    from skypilot_tpu_torch.inference.runtime import (INT8_NEEDS_CONTINUOUS,
                                                      unsupported_flags)
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = unsupported_flags(args)
    if bad:
        parser.error('not supported by the PyTorch port yet: '
                     + ', '.join(bad))
    if args.kv_dtype == 'int8' and not args.continuous_batching:
        parser.error(INT8_NEEDS_CONTINUOUS)
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
    serve(rt, args.port, drain_grace=args.drain_grace)


if __name__ == '__main__':
    main()
