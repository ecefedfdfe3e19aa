#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch/) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (`serve_lm --continuous-batching` on a
paged KV pool, base model and multi-LoRA, the GPT-2, Mixtral and
DeepSeek families, the dense slot path, int8 projection weights
(`--weight-dtype int8`, on Llama, Mixtral and DeepSeek), whole-prompt
long prefill,
SSE streams, text and chat endpoints, logprobs, `--hf` checkpoints and
the one-shot engine; KV page chains: export / import, the host and cold
spill tiers, disaggregated prefill / decode roles and live migration;
training through the trainer API, the sharded trainer (FSDP over a
1-rank NCCL job, `--zero1` / `--overlap`), the pipeline trainer
(gpipe, 1f1b and interleaved on one card named twice; where two cards
are visible `train_lm --pipeline-stages 2` as a 2-rank NCCL job),
`train_lm --lora` and
`train_lm` on GPT-2, Mixtral and DeepSeek, where two cards are visible
`train_lm --expert 2` and `--seq-parallel 2` as 2-rank NCCL jobs (the
other phases use card 0 alone), and train_lm's recovery
contract: --guard, --init-from-hf, the native token reader,
--ckpt-interval, --profile) through the
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
                 Qwen2-7B's heads (Hq=28, Hkv=4: G=7) and one --tensor
                 2 shard's (Hq=16, Hkv=4) decode B=8 and a chunk of
                 256}: each
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
  gpt2_kernels   paged attention at GPT-2 124M's head shape (Hq = Hkv =
                 12, G = 1, D = 64: the kernel's head_dim-64 instance) vs
                 its plain version on bf16 and f32 pools: decode B=8
                 (rows ending mid-page, on a page's last and first slot,
                 at full length, and a row that sees nothing), chunks of
                 256 at offsets 300 and 768, a verify chunk B=8 S=5 (the
                 split route at G = 1); the same error measure and limits
                 as `kernels`, the perturbed control failing both routes;
                 timings of decode B=8 and the chunk at 768 vs the bound,
                 the plain version and SDPA on gathered K/V
  lora_kernels   QKV LoRA at Llama-3-8B width (d=4096, q 4096, k/v
                 1024), ranks {8, 16, 64} x {bf16, f32} x {decode B=8
                 S=1 with ids [0,1,1,2,3,0,2,1], chunk B=1 S=256} vs its
                 plain version within 1e-5 (max-abs), id-0 rows exactly
                 0; per dtype also rank 12, decode B=32 over 9 slots,
                 decode B=64, all rows under one adapter, all under
                 distinct ones, rows whose id is N (NaN, the others
                 right), Qwen2-7B's widths (d 3584, q 3584, k/v 512:
                 decode B=8 and a chunk B=2 S=100) and widths of 4100 /
                 1028 (no 16-byte copy), one --tensor 2 shard's (q 2048,
                 k/v 512: decode B=8, chunk of 256, timed at decode B=8
                 r 16); two calls bit-identical; one
                 call captured in a CUDA graph replays right on new x
                 and ids; the perturbed control must fail; L2-cold
                 timings (bf16, r 16 and 64, decode B=8, B=32 over 9
                 slots, chunk of 256) vs the bound, the plain version,
                 the gathered-bmm route and one near-empty launch
  int8_linear_kernels
                 the W8A16 linear kernel vs its plain version (dequantize,
                 then F.linear) at Llama-3-8B's seven projections and
                 Qwen2-7B's (q/k/v with biases) and DeepSeek-V2-Lite's
                 (wq 3072 x 2048, wo, w_gate / w_up 10944 x 2048, w_down
                 2048 x 10944: K not a multiple of the 128-k stage), M in
                 {1, 8, 32, 40, 256, 2048}, bf16 and f32 x: the worst
                 output row's
                 |y - plain| / |plain| within 6e-3 (bf16) or 1e-5 (f32),
                 the scale-0 channel exactly the bias, two calls
                 bit-identical; one call captured in a CUDA graph replays
                 right on new x; the perturbed control fails; L2-cold
                 timings at M 8 and 256 of each Llama shape and of
                 DeepSeek's w_down (rows of their own in the kernels
                 line) vs the bound, the plain version and F.linear on
                 bf16 weights; the same checks at one --tensor 2 shard's
                 projections, timed at M 8 (wq, wo, w_down)
  grid_collective_kernels
                 the serving grid's collective (ops/grid_collective.py,
                 csrc/grid_collective.cu; no TPU kernel: it stands for
                 XLA's all-reduce over ICI) on cuda:0 named 2 and 4
                 times, one launch acting for every rank: sum (f32 in
                 shard order, cast back) of a decode partial (8 x 4096),
                 a prefill chunk's (256 x 4096) and a ragged 3 x 5 in
                 bf16 and f32, the int8 pool's absmax (max of [8, 1]
                 f32, and bf16), the head's gather (8 x 64128 f32 slices,
                 bf16, int32) and the tokens' broadcast (no launch on one
                 card) bit for bit against the plain helper; one launch a
                 call; the perturbed control (one shard one ulp up) fails;
                 one call captured in a CUDA graph replays right on new
                 parts; the decode and chunk sums' device ms (a CUDA graph
                 of 50 launches, warm L2, as a round finds its partials)
                 vs the bound (every part read, the sum written, over
                 HBM), the plain helper and torch.add of the two parts
                 (the same bits at T = 2, and held so)
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
  serve_int8_weights
                 the int8 model of the serving seed (projections quantized
                 from its f32 draws; embedding, norms and head shared with
                 the bf16 model) through serve_lm --weight-dtype int8: (a)
                 the 8-prompt burst on a bf16 and an int8 pool, (b)
                 serve_lora's adapters and request mix; int8_linear, both
                 paged routes and (b) QKV LoRA launched, no plain call,
                 graph replays; each int8 continuation's mean log-prob
                 under the bf16 model's scoring pass (with the request's
                 adapter in (b)) within 0.1 nats of the bf16 model's own
                 continuation; every adapter changes the int8 base's
                 answer to at least one of its prompts; /stats storage
                 weight_dtype int8 and weight_bytes the int8 tensors'
                 bytes, ~6.98 GB under bf16's. Cost lines: steady round
                 ms in turns (bf16, int8, int8 through the dequantize
                 route (int8_linear alone on its plain version), twice
                 each), the weights' bytes, the phase's seconds
  serve_dense    Llama-3-8B through the examples' serve line
                 (--max-total-len 2048 --continuous-batching --num-slots
                 16, no --kv-pool-bytes: the 128-page pool holds 2032
                 tokens, so the engine runs dense): the 8-prompt burst,
                 engine.paged False, no paged-attention call, graph
                 rounds == eager unpipelined rounds; serve_lora's
                 adapters and mix on a dense runtime: the QKV LoRA kernel
                 launched in dense graph rounds, no plain call, base rows
                 unchanged, adapters change answers. Cost lines: steady
                 round ms beside the paged engine's (serve_bf16's flags)
                 in turns, the dense cache's bytes, the device-busy share
  observability  serve_lora's weights, adapters and flags plus
                 --trace-sample 1.0 --trace-seed 0 --slo
                 p99_ttft_ms=5000,p99_itl_ms=500,error_rate=0.05
                 --fault-plan (engine.decode_step at its 5th hit, a
                 20 ms engine.device_get delay at the 9th, the first
                 adapters.load), STPU_FLIGHT_DIR under build/: the 8
                 prompts (2 base, 2 per adapter, request 2 with a made-up
                 x-skypilot-trace header) after one attn8 request whose
                 load fails: that one answers 503 AdapterLoadError (the
                 reference's answer), every other answer equals the same
                 requests' on a runtime without the four flags; /stats
                 has the repaired keys, engine_restarts 0 and the slo
                 block; /debug/flight one soft_error (strikes 1), no
                 reset; /metrics parses line by line as exposition 0.0.4
                 and this engine's tokens_committed_total and
                 decode_steps_total equal /stats', decode_step_seconds
                 has one sample a round, the adapter series are there;
                 /debug/trace/<id> holds replica.request under the
                 header, engine.queue_wait, engine.admit, prefill chunks
                 and 31+ engine.decode_round spans, each parent in the
                 trace; split and chunk routes and QKV LoRA launched, no
                 plain call; then a 2-layer engine at the same width
                 under engine.decode_step at hits 3-5: one reset, the
                 batch failed with the injected error, a `reset`
                 snapshot file, engine_restarts 1, and the next request
                 equals a fresh engine's from graph replays on the same
                 pool storage. Cost lines: steady round ms with tracing
                 at 0 and 1.0 in turns (0, 1, 1, 0), the ms of a
                 /metrics scrape, the phase's seconds
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
  decode_modes   serve_bf16's weights cut to their first DECODE_MODES_LAYERS
                 (8) layers (the same tensors), through serve_lm's flags,
                 8 slots,
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
                 plain engine's tokens exactly; so does a dense engine
                 (paged=False) with the adapters; DeepSeek-V2-Lite's
                 width cut to 2 layers on the dense path gives the same
                 tokens from graph rounds and eager rounds; GPT-2 124M
                 and Mixtral 8x7B
                 widths cut to 2 layers (f32): 4 requests x 16 tokens
                 through the kernel equal those through the plain version; so do the one-shot
                 generate functions (plain and speculative K=4, dense
                 cache) on the first two base requests; and the same
                 width with int8 projections: 4 base requests through the
                 int8_linear kernel (its f32 route) give the plain
                 version's tokens
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
  kv_chain       per pool (bf16, int8), two runtimes of serve_lm's flags
                 (--max-total-len 2048) sharing the weights: engine A
                 serves P (2003 tokens: 125 pages of 16 and a 3-token
                 tail) cold, then warm, 32 greedy tokens each; A's
                 export of P imports into B as {pages: 125, imported:
                 125, already_cached: 0, dropped: 0}; B serves P with A's
                 warm tokens exactly (both prefill one tail chunk at
                 offset 2000 over the same page bytes), its prefix hits
                 grow by 125, and its re-export equals A's export whole
                 (header included); the paged split and chunk routes
                 launched, no plain call; export (gather, device-to-host,
                 pack) and import (unpack, host-to-device, scatter) ms and
                 GB/s on the scheduler thread, cold / warm / imported
                 TTFT, and the first index where cold and warm tokens
                 part (bf16 chunking; not gated)
  kv_spill       a ~300-page bf16 pool with --kv-spill-bytes 512 MiB: P
                 served cold and warm, prompts of 1000 tokens fill the
                 pool until every page of P is evicted, P again: the
                 restored pages number P's 125 spilled ones (none
                 dropped) and the tokens equal the warm ones exactly;
                 then a host tier of 8 MiB (4 pages) with --kv-cold-dir
                 under build/: the same gates, cold reads > 0; the
                 restore's ms (on the scheduler thread) beside the cold
                 prefill's TTFT
  disagg         two make_servers, --role decode and --role prefill
                 --decode-peers <decode>: 4 greedy /generate requests of
                 1990-2005 tokens and one SSE stream through the prefill
                 replica; each answer equals the decode replica's answer
                 to the same request sent to it directly; handoffs == 5,
                 failures == 0 on the prefill side, kv_imports == 5 on
                 the decode side; then /kv/peers to a closed port: the
                 same answers served locally, one failure each; handoff
                 seconds and bytes, TTFT through the prefill replica vs a
                 cold prompt's straight to the decode replica
  migration      replicas A and B: a 64-token greedy stream on A, POST
                 /kv/evacuate {reason: drain, target: B} after 8 tokens:
                 the stream ends with 64 tokens (its terminal row equal
                 to them) and no error, A counts migrations{drain} >= 1
                 and B migrations_in >= 1, the tokens before the
                 evacuation equal an undisturbed run's; the first index
                 parting from it after the evacuation is printed (B
                 recomputes the sub-page tail as a chunk where A decoded
                 it token by token: exact only in f32, held in tier-1)
  serve_tp       serve_lm --tensor 2 / --stages 2 at Llama-3-8B's full
                 width and depth over one card named twice
                 (build_runtime(devices=['cuda:0', 'cuda:0']), the
                 serving weights shared): the burst of serve_bf16 at
                 --tensor 2 on bf16 and int8 pools, at --stages 2 (the
                 decode ring), at --tensor 2 --weight-dtype int8 and at
                 --tensor 2 with serve_lora's adapters and request mix;
                 every answer prompt + 32, the split and chunk routes,
                 QKV LoRA and int8_linear launched at one shard's shapes
                 (Hq 16 / Hkv 4, q 2048 / kv 512, wq 2048 x 4096, wo
                 4096 x 2048, w_down 4096 x 7168), no plain call, graph
                 replays on the one card, every pool shard's storage
                 unchanged; then f32 2-layer Llama-3-8B and
                 DeepSeek-V2-Lite at full width under --tensor 2 give one
                 device's greedy tokens exactly. The `_tp2` rows of the
                 kernels line are those shapes, their cases and timings
                 in `kernels`, `lora_kernels` and `int8_linear_kernels`;
                 their launches are the --tensor 2 bursts' at that shape
                 (paged: the --tensor 2 bursts only, --stages 2 runs
                 whole heads and is printed apart; int8_linear: counted
                 by weight shape). Every collective of the --tensor 2
                 bursts goes through the grid collective's kernel (its
                 sum rows' launches: the decode and chunk partials'), no
                 plain call. Distinct cards: tests/
                 test_torch_grid_cards.py (-m card, 4 cards)
  serve_tp_2card where two cards are visible: the --tensor 2 engine over
                 cuda:0 and cuda:1 (each decode round one CUDA graph a
                 card, the sums over NVLink) against the same engine on
                 cuda:0 named twice, both driven on this thread: the 8
                 prompts' greedy tokens equal, the collective launched on
                 both cards with no plain call, both grids' steady round
                 ms; on one card it prints that it did not run
  serve_fleet    (the smoke's model freed first) `python -m
                 skypilot_tpu_torch.recipes.serve_fleet` as a user runs
                 it over serve_lm replicas of Llama-3-8B (full width and
                 depth, seeded; --max-total-len 1024, 8 slots, a 4 GB
                 pool each; --replicas 1 --max-replicas 2, prefix
                 affinity, --state-dir): waves of 16 concurrent cold
                 prompts scale it from 1 to 2; 3 groups of 3 prompts
                 sharing a 512-token prefix and 2 cold ones, one at a
                 time through the LB: each group on one replica, prefix
                 hits >= 3 x 2 x 32 pages in /fleet/status; each again
                 through the LB (warm) and straight to the replica that
                 served it: the same tokens; every replica's /stats:
                 device cuda, paged launches on the split and chunk
                 routes, no scalar launch, no plain call, no unavailable
                 reason; load falls and the autoscaler drains back to
                 1 with every request of the drain answered, the victim
                 journaled DRAINING before its /readyz said draining
                 (SIGTERM) and SHUTDOWN after; SIGKILL the fleet,
                 restart it on the state dir: the survivor adopted (same
                 id, pid and instance UUID), answering its warm answers
                 bit for bit; the LB's own cost: 200 GET /v1/models and
                 40 one-token /generate pairs, through the LB and
                 straight to the adopted replica, interleaved, each
                 pair's answers equal; SIGTERM: rc 0 and none of the
                 fleet's serve_lm processes (marked by an env var the
                 fleet's replicas inherit; no other process is read or
                 signalled) left. Prints each replica's spawn-to-ready
                 seconds (the journal's), the adoption's, the LB's cost
                 (median and quartiles of the pairs' differences) and
                 the replicas' launches by route
  serve_gpt2     gpt2-124m (full width and depth, seeded) through
                 build_runtime with serve_lm's flags (--max-total-len 1024
                 --prefill-chunk 256, 8 slots, the config's 128-page
                 pool): 8 concurrent greedy /generate requests of 100-200
                 prompt tokens (two sharing a 64-token prefix that the
                 warm-up request caches), 32 new tokens; every answer
                 prompt + 32, the split and chunk routes launched (never
                 the scalar one), no plain call, graph replays; the same
                 requests on an eager, unpipelined runtime give the same
                 tokens bit for bit. Cost lines: steady round ms, the
                 device ms of a decode dispatch (CUDA events around it)
                 and the device-busy share
  serve_mixtral  mixtral-8x7b at full width cut to 16 of its 32 layers
                 (~47 GB bf16), seeded on the card, the same flags, burst
                 and gates; cost lines: steady round ms beside the bound
                 of the bytes a round reads (every weight but the
                 embedding table: dense dispatch reads every expert),
                 the weights' bytes, the phase's seconds; freed after
  serve_mixtral_int8
                 mixtral-8x7b at full width cut to 4 layers with
                 --weight-dtype int8: Int8Dense on wq / wk / wv / wo only,
                 the expert stacks bf16; the burst through int8_linear
                 (launches a multiple of the 16 int8 projections of a
                 forward, no plain call), graph == eager unpipelined
                 tokens, and the reference's 0.1-nat contract against the
                 dequantize route, scored by the bf16 model. Cost lines:
                 steady round ms of bf16 and int8 in turns, weight bytes
  serve_deepseek deepseek-v2-lite at full width and depth, seeded, through
                 serve_lm's flags (--max-total-len 1024 --prefill-chunk
                 256, 8 slots): the dense slot path (paged False,
                 attention_impl 'dense', no paged-attention call), the
                 serving burst (300-700 prompt tokens, 32 new), graph
                 rounds == eager unpipelined rounds; --speculative 4
                 gives the plain engine's tokens but where a row parts
                 at a near tie (top-2 margin <= 0.5: the verify chunk's
                 bf16 sums run in another order). Cost lines: steady
                 round ms and device-busy share beside the bound of a
                 round's bytes (weights but the embedding table, and the
                 whole latent cache), latent-cache and weight bytes, TTFT
  serve_deepseek_int8
                 the same with --weight-dtype int8 (wq, wo, w_gate, w_up,
                 w_down): the gates of serve_mixtral_int8 (135 int8
                 projections a forward); freed after
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
  train_fsdp     the sharded trainer (parallel/fsdp.py: FSDP2 units per
                 block and a root unit with the loss) on a 1-rank NCCL
                 job joined through parallel/distributed.py (the card
                 holds one rank: more need more cards), on
                 make_mesh(MeshConfig.auto(1)), at train_full's shape,
                 seed and batches: step-1 loss and grad norm within 1e-5
                 of train_full's, its 4 losses within 1e-4 (the one-card
                 trainer is not bit-reproducible on the card; see
                 FSDP_CURVE_TOL); flash launches = 4 layers x 4 steps per
                 kernel, no plain call; its checkpoint (written through
                 the collective save) restores into the one-card trainer
                 bit for bit (step, count, every parameter and moment);
                 then again with zero1=True, overlap=True: at data = 1
                 the layout turns both off (checked), so this run takes
                 the plain path again and measures no zero1: the same
                 gates. The checkpoint round runs on train_full's config
                 cut to CKPT_CUT (1 layer, a 4096-token vocab: ~3 GB
                 of state; the 4-layer state's 23 GB took 119 s), one
                 sharded step into it; the restored state saved again is
                 the same file byte for byte. Step ms, tokens/s, MFU, peak
                 memory and the checkpoint's save / restore s beside
                 train_full's
  train_pipeline the pipeline trainer API (parallel/pipeline.py) in
                 process on devices ['cuda:0', 'cuda:0'] (S = 2) at
                 train_full's shape (Llama-3-8B width, 4 layers, B=8,
                 S=2048), M = 8 microbatches of one row, for gpipe, 1f1b
                 and interleaved (v = 2, one layer a chunk): step 1
                 (loss, grad norm) against the witness, the one-card
                 trainer fed the rows one microbatch at a time with the
                 pipeline's vocab-split head and loss (`split_vocab_loss`,
                 2 shards), grads summed in f32, within a bound set in
                 this run: PIPE_SPREAD times the witness's spread over 5
                 readings, at least FSDP_TOL; two controls (microbatch 1's
                 backward skipped, a forward hand-off delivering the
                 previous microbatch's activation) must fall outside it;
                 64 flash_fwd and 32 flash_bwd launches a step, no plain
                 call; then 3 steps: step s, tokens/s, MFU and peak GB
                 beside train_full's, the schedule's ticks and bubble
                 fraction, hand-offs and collectives a step (one card
                 named twice runs the stages one after the other: these
                 measure the runner's overhead, not a pipeline's overlap),
                 the offset from train_full's whole-batch step 1 beside.
                 Where 2 cards are visible: `train_lm --pipeline-stages 2
                 --pipeline-schedule 1f1b --microbatches 8` at that shape
                 as a 2-rank NCCL job (train_expert's launcher), its step
                 1 within the bound of the in-process 1f1b reading of its
                 own batch, each rank's flash launches for its 2 layers;
                 on one card it prints that it did not run. Distinct
                 cards: tests/test_torch_parallel_cards.py `pipe2`,
                 `pipe2x2` (-m card, 4 cards)
  train_tensor   the sharded trainer over tensor shards in process
                 (ShardedTrainer(devices=['cuda:0', 'cuda:0']),
                 parallel/tensor.py: heads, the MLP and the vocab split
                 over 2 shards of one card) at train_full's shape and
                 batches: the witness (the shards' step-1 reading) 5 times,
                 its spread setting the bound (TENSOR_SPREAD x spread, at
                 least FSDP_TOL); two controls (copy-to-group's backward
                 sum skipped, the vocab-parallel max dropped) must fall
                 outside it and outside train_full's; then 3 steps: step
                 1 within the bound and within train_fsdp's bounds of
                 train_full's whole-model step 1 (loss FSDP_TOL, norm
                 twice train_full's spread),
                 flash_fwd and flash_bwd 2 x 4 a step at the shard's heads
                 (16 q, 4 kv, D 128), no plain call; step s, tokens/s,
                 MFU, peak GB, the shards' sums a step; then the 1f1b
                 pipeline over a [2][2] grid of the card
                 (--pipeline-stages 2 --tensor 2): its step-1 reading 5
                 times, the first within TENSOR_SPREAD x their spread (at
                 least FSDP_TOL) of train_pipeline's 1f1b reading, two
                 controls (copy-to-group's backward sum skipped, a
                 region's forward sum skipped) outside it, 128 / 64
                 flash launches at the shard's heads. Where 2 cards are
                 visible: `train_lm --tensor 2` at that shape as a 2-rank
                 NCCL job, its step 1 within the bound of the in-process
                 reading of its batch; on one card it prints that it did
                 not run
  train_lora     `train_lm --model llama3-8b --lora 16 --seq 2048
                 --remat` at full depth: 4 steps with checkpoints every
                 2, a relaunch to 6 resumes from step 4; forward launches
                 = 32 x 6 x 2 (remat), backward 32 x 6; then
                 serve_lm --adapter-dir answers a request with the
                 trained adapter
  train_gpt2     `train_lm --model gpt2-124m --seq 1024 --global-batch 8
                 --steps 20` (nanogpt.yaml's model and sequence): losses,
                 grad norms and MFU finite in --metrics-file, peak
                 memory; no flash launch (S < 2048)
  train_mixtral  `train_lm --model mixtral-8x7b --seq 2048 --global-batch
                 1 --remat --steps 5` at full width cut to 2 layers (the
                 registry's train config patched): flash forward 2 x 2 x 5
                 (remat), backward 2 x 5; losses, grad norms, MFU and the
                 router aux loss of every step finite; step time and peak
                 memory
  train_deepseek `train_lm --model deepseek-v2-lite --seq 4096
                 --global-batch 2 --remat --steps 5` at full depth
                 (examples/deepseek_mla.yaml's model and sequence, the
                 batch cut from 8): losses, grad norms and MFU finite, no
                 flash launch (MLA's unequal dims take the plain route);
                 step time and peak memory
  train_expert   `train_lm --model mixtral-8x7b --seq 2048 --global-batch
                 1 --remat --steps 3 --expert 2`, train_mixtral's shape,
                 as a 2-rank NCCL job (train_lm's own worker on cards 0
                 and 1, each cutting the depth to 2 layers): each rank
                 launches flash forward 2 x 2 x 3 (remat) and backward
                 2 x 3, no plain flash call, no ring step; losses, grad
                 norms and MFU finite; step 1's loss within 1e-4 and grad
                 norm within 1e-3 (relative) of train_mixtral's (the same
                 seeded weights and batch on one card). Runs where 2 or
                 more cards are visible; on one card it prints that it did
                 not run and the card count
  train_context  `train_lm --model llama3-8b --seq 8192 --global-batch 1
                 --remat --steps 3 --seq-parallel 2` at full width cut to
                 4 layers, a 2-rank NCCL job as train_expert's: ring
                 attention (ops/ring_attention.py) in place of flash, so
                 no flash launch; each rank's ring steps 2 x 4 x 3 x 2
                 forward (remat) and 4 x 3 x 2 backward; step 1's loss and
                 grad norm within 1e-3 of the same command on one card
                 (flash); where train_expert runs
  train_guard    train_lm's recovery contract, each train_lm run a child
                 process after this one has freed its models (its own
                 card memory is reported first, `train_guard_parent`)
                 (`python -m skypilot_tpu_torch.recipes.train_lm`
                 through runpy, writing its flash launch counts at exit;
                 exits 83 and 84 end the child, not this run; the notice's
                 metadata probe goes to a closed port on 127.0.0.1):
                 (d) the trainer API at 4 layers, B=8 S=2048: guarded and
                 unguarded step ms and peak memory in turns, ms a step
                 of back-to-back loops (unguarded; guarded observing the
                 previous step through pinned copies, as train_lm does;
                 guarded observing it through float()), and the device
                 ms of the optimizer update alone, each way; a poisoned
                 step leaves params and moments bit-identical and the
                 count as it was; the next good step equals an unguarded
                 step from the same state on the same batch: loss and
                 grad norm within 1e-3 (relative), the update no farther
                 from the unguarded one (Frobenius over all params, over
                 the update's norm) than twice the distance between two
                 unguarded steps from that state (the floor set by the
                 backward's dQ atomics);
                 then on a 2-layer Llama-3-8B-width HF checkpoint written
                 here and two uint16 token shards, each run --lora 16
                 --seq 2048: (e)+(f) --init-from-hf --data --ckpt-interval
                 30 --profile-steps 1:3: f32 masters equal the file's bf16
                 tensors upcast, the first step's loss the trainer API's
                 within 1e-3, the native reader's batches the numpy
                 route's byte for byte, a cadence fixed after the first
                 window, both flash kernels in the trace, the adapter's
                 base_model the HF dir; (b) SIGTERM after the first logged
                 step: exit 83, the notice at the step in flight and its
                 checkpoint; (c) a 300 s stall in the third batch fetch
                 under --watchdog-deadline 5: exit 84 within 15 s of the
                 last step, the dump naming next_tokens;
                 (a) --remat --guard on the same checkpoint, 24 steps,
                 every batch fetch 1 s late (the pace that puts the
                 notice between the rollback and the last step), NaN at
                 the 5th-7th steps and a notice after 36 one-second polls
                 (both scoped to the first launch): three skips, a
                 rollback to step 4, then exit 83 with a checkpoint at
                 the notice's step; the same command resumes there and
                 finishes, finite losses after the streak; flash launches
                 = 2 x steps run (rolled-back step included) x 2 (remat)
                 forward, 2 x steps run backward, no plain call

The paged kernel's split and chunk rows in the kernels line count their
launches in the base-serving window (serve_bf16 + serve_int8, counted
from zero, graph replays included; no scalar-route launch may occur
there; `fleet_launches`: the serve_fleet replicas' own, from their
/stats), its verify row those of decode_modes' (e) run, the GPT-2 rows
(decode: split, chunk) those of serve_gpt2's window;
the flash kernels' launch counts are those of the training phases
(the `_tp2` rows, at one --tensor 2 shard's heads, train_tensor's steps,
its pipeline reading and its 2-card job's ranks where it runs; the
others train_full, train_fsdp, train_pipeline's steps of each style and
its 2-card job's ranks where it runs, train_lora, train_mixtral,
train_expert's ranks where it runs, and train_guard's trainer-API
steps, its --init-from-hf
run and its chaos run and relaunch), each counted from zero; int8_linear's those of serve_int8_weights; the grid
collective's decode and chunk rows those of serve_tp's bursts at the
partial's size (sums of 8 x 4096 and 256 x 4096 bf16). Then the
`clock` line (by phase name, the wall seconds from the line before to
each emitted line, and the run's total) and, as the last three lines: the card (`nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`), the kernels JSON line, and {"ok": true,
"device": {...}}. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""
import contextlib
import dataclasses
import filecmp
import functools
import gc
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
import uuid

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
# Llama-3-8B's heads on one shard of serve_lm --tensor 2: G stays 4.
TP2_HEADS = (HQ // 2, HKV // 2)
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
# The sharded trainer on one rank against the one-card trainer, relative:
# the same kernels on the same values. The step-1 loss within FSDP_TOL;
# the 4-step curve within FSDP_CURVE_TOL: the one-card trainer itself is
# not bit-reproducible on the card from run to run (over six runs on an
# NVIDIA H100 80GB HBM3, 700.00 W, its step-3 loss spread over 3.3e-5, as
# Adam's m / sqrt(v) carries the first rounding differences onward; the
# sharded trainer's largest gap to it was 3.4e-5). Nor is its step-1 grad
# norm: the flash backward adds dQ with reduce-adds in whatever order the
# blocks reach them, and the norm spread 1.3e-5 over four runs, once past
# a fixed 1e-5. So the sharded step-1 norm is held to a bound measured in
# the same run: train_full repeats its step 1 (its weights, its batch)
# FSDP_NORM_REPEATS times beside the step itself, and the bound is
# FSDP_NORM_SPREAD times those norms' spread (a new sample can fall past
# the few samples' range), FSDP_TOL where they agree bit for bit. A
# sharded step whose gradient is scaled by 1 + FSDP_NORM_CONTROL must
# still fail it.
FSDP_TOL = 1e-5
FSDP_CURVE_TOL = 1e-4
FSDP_NORM_REPEATS = 4
FSDP_NORM_SPREAD = 2.0
FSDP_NORM_CONTROL = 1e-4
# train_fsdp's checkpoint round runs on train_full's config cut to this
# (the round checks the collective save and restore, not the width): one
# layer at Llama-3-8B's width and a 4096-token vocabulary, a ~3 GB state
# (at 32768 tokens its 5.8 GB took ~45 s to save, restore and save
# again).
CKPT_CUT = {'num_layers': 1, 'vocab_size': 4096}
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                    'chip_smoke')


#: Wall seconds by emitted phase name: the time from the previous emit
#: (or the start) to this one, printed by the `clock` line at the end.
START = time.perf_counter()
CLOCK = {'last': START, 'seconds': {}}


def emit(phase, **fields):
    now = time.perf_counter()
    CLOCK['seconds'][phase] = (CLOCK['seconds'].get(phase, 0.0) + now
                               - CLOCK['last'])
    CLOCK['last'] = now
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- kernels ---------------------------------------------------------------
def paged_case(kind, batch, seq, ctx_end, pps, seed, masked_rows=0,
               page=PAGE, heads=(HQ, HKV), head_dim=D):
    """Inputs at a head shape (q heads, kv heads, head dim; Llama-3-8B's
    by default). Row b's queries sit at positions ctx_end[b] - seq + 1
    .. ctx_end[b]; the first `masked_rows` queries of row 0 see nothing
    (position -1)."""
    hq, hkv = heads
    dev = 'cuda'
    rng = np.random.default_rng(seed)
    total = batch * pps + 1
    tbl = (1 + rng.permutation(total - 1)[:batch * pps]).reshape(batch, pps)
    shape = (hkv, total, page, head_dim)
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
    q = torch.randn((batch, seq, hq, head_dim), generator=g,
                    device=dev).to(qdt)
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
    per_token = 2 * kv.shape[0] * kv.shape[-1] * kv.element_size()
    if c['k_scales'] is not None:
        per_token += 2 * 4
    io = 2 * c['q'].numel() * c['q'].element_size()
    idx = 4 * (c['positions'].numel() + c['page_indices'].numel())
    return visible * per_token + io + idx


def must_flops(c):
    """4 * D flops (q.k and p.v) per query head per (query, visible
    token) pair."""
    pos = c['positions'].cpu().numpy()
    return (4.0 * c['q'].shape[-1] * c['q'].shape[2]
            * float(np.maximum(pos + 1, 0).sum()))


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


def paged_timing_sets(kind, batch, seq, heads=(HQ, HKV), head_dim=D):
    """Input sets of one timed shape (context 1024, queries ending at
    position 1023; a verify chunk's rows end 61 positions apart from
    1023 down), enough that their K/V exceed the L2 together."""
    elt = 1 if kind == 'int8' else 2
    kv_bytes = batch * 1024 * heads[1] * head_dim * elt * 2
    n_sets = max(2, math.ceil(L2_FLUSH_BYTES / kv_bytes))
    ends = ([1023 - 61 * i for i in range(batch)] if seq == VERIFY_S
            else [1023] * batch)
    return [paged_case(kind, batch, seq, ends, 64, seed=100 + i,
                       heads=heads, head_dim=head_dim)
            for i in range(n_sets)]


def dense_kv(c):
    """K/V of the case gathered dense (bf16, [B, Hkv, T, D]) for the
    library yardstick; int8 pages are dequantized first."""
    from skypilot_tpu_torch.ops.paged_attention import _gather_kv
    k, v = _gather_kv(c['k_pages'].shape[0], c['k_pages'], c['v_pages'],
                      c['page_indices'], c['k_scales'], c['v_scales'])
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
        ('decode_tp2', 8, 1, [999, 1023, 0, 16, 511, 776, 1, 1022], 64, 1,
         PAGE, TP2_HEADS),
        ('chunk_tp2', 1, 256, [555], 48, 16, PAGE, TP2_HEADS),
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
    # The same at one --tensor 2 shard's heads (the serve_tp path).
    for label, batch, seq in (('decode_b8', 8, 1),
                              ('chunk_offset768', 1, 256)):
        sets = paged_timing_sets('bf16', batch, seq, heads=TP2_HEADS)
        routes0 = dict(pk.route_launches)
        ms = time_ms([lambda c=c: call(pk, c) for c in sets],
                     iters=max(60, 3 * len(sets)))
        route = [r for r in pk.ROUTES if pk.route_launches[r] != routes0[r]]
        plain_ms = time_ms([lambda c=c: plain(pk, c) for c in sets[:2]],
                           iters=6, warmup=2)
        lib = [paged_library_fn(c) for c in sets]
        library_ms = time_ms(lib, iters=max(60, 3 * len(sets)))
        del lib
        b_ms, b_by = bound_ms(sets[0])
        timings[f'bf16_{label}_tp2'] = {
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'bytes': must_bytes(sets[0]),
            'flops': must_flops(sets[0]), 'library_ms': library_ms,
            'input_sets': len(sets), 'route': route, 'heads': TP2_HEADS}
        del sets
        torch.cuda.empty_cache()
    tp2_worst = {
        r: max(c['max_abs_err'] for c in cases if c['pool'] != 'f32'
               and c['shape'] == f'{label}_tp2')
        for r, label in (('split', 'decode'), ('chunk', 'chunk'))}
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
             'gathered K/V'),
            ('paged_attention_tp2', 'split', 'bf16_decode_b8_tp2',
             'tp2_split', 'scaled_dot_product_attention on gathered K/V'),
            ('paged_attention_chunk_tp2', 'chunk',
             'bf16_chunk_offset768_tp2', 'tp2_chunk',
             'scaled_dot_product_attention with a boolean mask on '
             'gathered K/V')):
        t = timings[key]
        err = (tp2_worst[err_key[4:]] if err_key.startswith('tp2')
               else worst[err_key])
        rows.append({'name': name, 'route': 'cuda',
                     'source': 'skypilot_tpu_torch/csrc/paged_attention.cu',
                     'replaces': PAGED_ATTENTION_TPU,
                     'kernel_route': route, 'timed': key,
                     'max_abs_err': err, 'ms': t['ms'],
                     'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
                     'bound_by': t['bound_by'],
                     'library_ms': t['library_ms'], 'library': library})
    return rows


# GPT-2 124M's heads: multi-head attention, Hq = Hkv = 12 (G = 1), D = 64,
# the kernel's head_dim-64 instance.
GPT2_HEADS, GPT2_D = (12, 12), 64
# (label, batch, S, context ends, pages per row, masked queries of row
# 0): decode rows ending mid-page (999, 776), on a page's last slot (15,
# 1023: full length) and on its first (16, 512), row 0 seeing nothing;
# chunks of 256 at offsets 300 and 768; a verify chunk B=8 S=5 (S x G =
# 5: the split route).
GPT2_CASES = (
    ('decode', 8, 1, [999, 1023, 15, 16, 512, 776, 300, 1022], 64, 1),
    ('chunk_offset300', 1, 256, [555], 48, 0),
    ('chunk_offset768', 1, 256, [1023], 64, 0),
    ('verify_k4', 8, 5, VERIFY_ENDS, 64, 0))
GPT2_TIMED = (('decode_b8', 8, 1), ('chunk_offset768', 1, 256))


def phase_gpt2_kernels(pk):
    """The paged kernel at GPT-2's head shape (D = 64, G = 1) on bf16
    and f32 pools against its plain version, the perturbed control, and
    timings of decode B=8 and the chunk at offset 768 (bf16)."""
    cases, worst = [], {'split': 0.0, 'chunk': 0.0, 'scalar': 0.0}
    for kind in ('bf16', 'f32'):
        for label, batch, seq, ends, pps, masked in GPT2_CASES:
            c = paged_case(kind, batch, seq, ends, pps, seed=200 + len(cases),
                           masked_rows=masked, heads=GPT2_HEADS,
                           head_dim=GPT2_D)
            routes0 = dict(pk.route_launches)
            out = call(pk, c)
            ref = plain(pk, c)
            torch.cuda.synchronize()
            route = [r for r in pk.ROUTES
                     if pk.route_launches[r] != routes0[r]]
            rel, err = paged_errors(out, ref, 1 if seq <= VERIFY_S
                                    else PAGED_TILE)
            pos = c['positions']
            case = {'pool': kind, 'shape': label, 'batch': batch, 'seq': seq,
                    'hq': GPT2_HEADS[0], 'hkv': GPT2_HEADS[1],
                    'head_dim': GPT2_D, 'route': route,
                    'unit_rel_err': rel, 'tol': PAGED_TOL[kind],
                    'max_abs_err': err,
                    'masked_rows_zero': bool((out[pos < 0].float() == 0)
                                             .all()),
                    'finite': bool(torch.isfinite(out.float()).all())}
            cases.append(case)
            check(route == [expected_route(kind, seq, GPT2_HEADS)],
                  f'paged attention (GPT-2 heads) took the wrong route: '
                  f'{case}')
            check(rel <= PAGED_TOL[kind] and case['masked_rows_zero']
                  and case['finite'],
                  f'kernel disagrees with its plain version at GPT-2\'s '
                  f'heads: {case}')
            worst[route[0]] = max(worst[route[0]], err)
    perturb = {}
    for label, batch, seq, ends, pps, masked in GPT2_CASES[:2]:
        c = paged_case('bf16', batch, seq, ends, pps, seed=299,
                       masked_rows=masked, heads=GPT2_HEADS, head_dim=GPT2_D)
        perturb[expected_route('bf16', seq, GPT2_HEADS)] = paged_errors(
            call(pk, c, perturb=0.5), plain(pk, c),
            1 if seq == 1 else PAGED_TILE)[0]
    check(sorted(perturb) == ['chunk', 'split']
          and all(e > PAGED_TOL['bf16'] for e in perturb.values()),
          f'perturbed kernel passed the pin at GPT-2\'s heads: {perturb}')
    timings = {}
    for label, batch, seq in GPT2_TIMED:
        sets = paged_timing_sets('bf16', batch, seq, GPT2_HEADS, GPT2_D)
        ms = time_ms([lambda c=c: call(pk, c) for c in sets],
                     iters=max(60, 3 * len(sets)))
        plain_ms = time_ms([lambda c=c: plain(pk, c) for c in sets[:2]],
                           iters=6, warmup=2)
        lib = [paged_library_fn(c) for c in sets]
        library_ms = time_ms(lib, iters=max(60, 3 * len(sets)))
        b_ms, b_by = bound_ms(sets[0])
        timings[f'bf16_{label}'] = {
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'bytes': must_bytes(sets[0]),
            'flops': must_flops(sets[0]), 'library_ms': library_ms,
            'input_sets': len(sets)}
        del sets, lib
        torch.cuda.empty_cache()
    emit('gpt2_kernels', cases=cases, perturb_unit_rel_err=perturb,
         perturb_fails=True, timings=timings)
    rows = []
    for name, route, key, library in (
            ('paged_attention_gpt2_decode', 'split', 'bf16_decode_b8',
             'scaled_dot_product_attention on gathered K/V'),
            ('paged_attention_gpt2_chunk', 'chunk', 'bf16_chunk_offset768',
             'scaled_dot_product_attention with a boolean mask on '
             'gathered K/V')):
        t = timings[key]
        rows.append({'name': name, 'route': 'cuda',
                     'source': 'skypilot_tpu_torch/csrc/paged_attention.cu',
                     'replaces': PAGED_ATTENTION_TPU,
                     'kernel_route': route, 'timed': key,
                     'max_abs_err': worst[route], 'ms': t['ms'],
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
# Llama-3-8B's q / k / v columns on one --tensor 2 shard.
TP2_WIDTHS = (D_MODEL, D_Q // 2, D_KV // 2)
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
                 UNALIGNED_WIDTHS),
                ('decode_tp2', dtype, 16, 8, 1, LORA_IDS_B8, 4, TP2_WIDTHS),
                ('chunk_tp2', dtype, 16, 1, 256, [2], 4, TP2_WIDTHS)]
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
    c = lora_case(torch.bfloat16, 16, 8, 1, LORA_IDS_B8, seed=200,
                  widths=TP2_WIDTHS)
    args = (c['x'], *c['f'], c['ids'])
    b_ms, b_by, n_bytes = lora_bound_ms(c)
    timings['bf16_r16_decode_tp2'] = {
        'ms': time_cold_ms(lambda: lk.fused_qkv_lora_delta(*args)),
        'plain_ms': time_cold_ms(
            lambda: lk.fused_qkv_lora_delta_reference(*args)),
        'library_ms': time_cold_ms(lambda: gathered_bmm(c)),
        'library': 'gathered torch.bmm per projection',
        'launch_floor_ms': launch_floor_ms(), 'bound_ms': b_ms,
        'bound_by': b_by, 'bytes': n_bytes, 'widths': TP2_WIDTHS}
    main = timings['bf16_r16_decode']
    emit('lora_kernels', cases=cases, perturb_err=perturb_err,
         perturb_fails=True, bit_identical=identical,
         graph_replay_max_abs_err=graph_err, timings=timings)
    row = {'name': 'qkv_lora', 'route': 'cuda',
           'source': 'skypilot_tpu_torch/csrc/qkv_lora.cu',
           'replaces': QKV_LORA_TPU, 'timed': 'bf16_r16_decode',
           'max_abs_err': max(c['max_abs_err'] for c in cases),
           'ms': main['ms'], 'plain_ms': main['plain_ms'],
           'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
           'library_ms': main['library_ms'],
           'launch_floor_ms': main['launch_floor_ms']}
    tp2 = timings['bf16_r16_decode_tp2']
    return [row, {**row, 'name': 'qkv_lora_tp2',
                  'timed': 'bf16_r16_decode_tp2 (q 2048, k/v 512)',
                  'max_abs_err': max(c['max_abs_err'] for c in cases
                                     if c['shape'].endswith('_tp2')),
                  'ms': tp2['ms'], 'plain_ms': tp2['plain_ms'],
                  'bound_ms': tp2['bound_ms'], 'bound_by': tp2['bound_by'],
                  'library_ms': tp2['library_ms'],
                  'launch_floor_ms': tp2['launch_floor_ms']}]


# -- flash attention kernels --------------------------------------------------
def flash_inputs(dtype, batch, seq, hq, hkv, seed, dim=D):
    g = torch.Generator('cuda').manual_seed(seed)

    def mk(heads):
        return torch.randn((batch, seq, heads, dim), generator=g,
                           device='cuda').to(dtype)

    return mk(hq), mk(hkv), mk(hkv), mk(hq)


def flash_errors(fk, case, perturb=0.0):
    """Each kernel vs its plain version on `case`: {kernel: (max abs
    err, worst tile's relative err, whole tensor's relative err)}, the
    backward the worst of dQ, dK and dV (each also under its own name);
    the backward is fed the plain forward's o and lse, so each kernel is
    held alone."""
    q, k, v, do = case
    scale = (1.0 + perturb) / math.sqrt(q.shape[-1])
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


FLASH_CASES = (   # (dtype, batch, seq, hq, hkv[, head_dim, default D])
    ('bf16', 8, 2048, 32, 8),     # train_lm --seq 2048, Llama-3-8B
    ('bf16', 8, 2048, 16, 4),     # one shard of its --tensor 2
    ('bf16', 8, 1024, 6, 6, 64),  # one shard of GPT-2's --tensor 2
    ('bf16', 1, 2300, 32, 8),     # a serve_long whole-prompt prefill
    ('bf16', 1, 2048, 32, 8),
    ('bf16', 1, 2048, 28, 4),     # Qwen2-7B's heads: 7 q heads a kv head
    ('bf16', 2, 1000, 8, 2),
    ('f32', 1, 2048, 32, 8),
    ('f32', 2, 1000, 8, 2))


def phase_flash_kernels(fk):
    cases = []
    worst = {name: 0.0 for name in FLASH_REPLACES}
    tp2_worst = {}
    for kind, batch, seq, hq, hkv, *dim in FLASH_CASES:
        dim = dim[0] if dim else D
        dtype = torch.bfloat16 if kind == 'bf16' else torch.float32
        errs, per_grad, first, finite = flash_errors(
            fk, flash_inputs(dtype, batch, seq, hq, hkv, seed=len(cases),
                             dim=dim))
        if (kind, batch, seq, hq, hkv, dim) == ('bf16', 8, 2048,
                                                *TP2_HEADS, D):
            tp2_worst = {n: e for n, (e, _, _) in errs.items()}
        case = {'dtype': kind, 'batch': batch, 'seq': seq, 'hq': hq,
                'hkv': hkv, 'head_dim': dim, 'tol': FLASH_TOL[kind],
                'finite': finite,
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
    del q, k, v, do, o, lse, di, qt, kt, vt, dot, out
    torch.cuda.empty_cache()
    # The same at one --tensor 2 shard's heads (train_tensor's shape).
    tp2 = flash_timings(fk, batch, seq, *TP2_HEADS)
    emit('flash_kernels', cases=cases, perturb_tile_rel_err=perturb,
         perturb_fails=True, determinism=determinism,
         shape={'batch': batch, 'seq': seq, 'hq': HQ, 'hkv': HKV, 'd': D,
                'dtype': 'bf16'},
         timings=timings, plain_fwd_ms=plain['flash_fwd'],
         plain_bwd_ms=plain['flash_bwd'], sdpa_fwd_ms=sdpa['flash_fwd'],
         sdpa_bwd_ms=sdpa['flash_bwd'],
         tp2={'shape': {'batch': batch, 'seq': seq, 'hq': TP2_HEADS[0],
                        'hkv': TP2_HEADS[1], 'd': D, 'dtype': 'bf16'},
              **tp2})
    rows, tp2_rows = {}, {}
    for n in FLASH_REPLACES:
        rows[n] = flash_row(n, worst[n], ms[n], plain[n], bounds[n],
                            sdpa[n])
        tp2_rows[n] = dict(flash_row(
            n, tp2_worst[n], tp2['ms'][n], tp2['plain'][n],
            tp2['bounds'][n], tp2['sdpa'][n]), name=f'{n}_tp2',
            shape=[batch, seq, *TP2_HEADS, D])
    return rows, tp2_rows


def flash_row(n, err, ms, plain_ms, bound, library_ms):
    fwd = n == 'flash_fwd'
    return {
        'name': n, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_attention.cu',
        'replaces': FLASH_REPLACES[n], 'max_abs_err': err,
        'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound[0], 'bound_by': bound[1],
        'library_ms': library_ms,
        'library': ('scaled_dot_product_attention' if fwd else
                    'scaled_dot_product_attention backward (dQ, dK '
                    'and dV together)'),
        'plain': ('flash_forward_reference' if fwd else
                  'flash_backward_reference (dQ, dK and dV together)')}


def flash_timings(fk, batch, seq, hq, hkv):
    """Both kernels, their plain versions and SDPA timed at one bf16
    shape: {'ms', 'plain', 'sdpa', 'bounds'}, each {kernel: value}."""
    import torch.nn.functional as F
    q, k, v, do = flash_inputs(torch.bfloat16, batch, seq, hq, hkv, seed=8)
    o, lse = fk.flash_forward_kernel(q, k, v)
    di = fk.attention_di(o, do)
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
    bounds = flash_bound_ms(batch, seq, hq, hkv, 2)
    del q, k, v, do, o, lse, di, qt, kt, vt, dot, out
    torch.cuda.empty_cache()
    return {'ms': ms, 'plain': plain, 'sdpa': sdpa, 'bounds': bounds}


# -- the int8 linear kernel ---------------------------------------------------
# (out, in) of each projection, by name: Llama-3-8B's seven, Qwen2-7B's
# (q/k/v with biases, as the model has them) and DeepSeek-V2-Lite's five
# (w_down's K = 10944 is 85.5 stages of 128: a ragged last stage and
# slices of 21 and 22 stages).
INT8_SHAPES = {
    'llama3_8b': {'wq_wo': (4096, 4096), 'wk_wv': (1024, 4096),
                  'w_gate_w_up': (14336, 4096), 'w_down': (4096, 14336)},
    'qwen2_7b': {'wq_wo': (3584, 3584), 'wk_wv': (512, 3584),
                 'w_gate_w_up': (18944, 3584), 'w_down': (3584, 18944)},
    'deepseek_v2_lite': {'wq': (3072, 2048), 'wo': (2048, 2048),
                         'w_gate_w_up': (10944, 2048),
                         'w_down': (2048, 10944)},
    # One shard of serve_lm --tensor 2 --weight-dtype int8 at Llama-3-8B:
    # column shards (wq, wk / wv, w_gate / w_up) and row shards (wo,
    # w_down).
    'llama3_8b_tp2': {'wq': (2048, 4096), 'wk_wv': (512, 4096),
                      'w_gate_w_up': (7168, 4096), 'wo': (4096, 2048),
                      'w_down': (4096, 7168)}}
# The --tensor 2 shard rows of the kernels line.
INT8_TP2_ROWS = ('wq', 'wo', 'w_down')
INT8_BIASED = {('qwen2_7b', 'wq_wo'), ('qwen2_7b', 'wk_wv')}
# Row counts M of every case: decode (1, 8), the last rows of the 'mma'
# route (32, 40, 64 = WGMMA_MIN_ROWS) and the 'wgmma' route past it.
INT8_ROWS = (1, 8, 32, 40, 64, 128, 256, 2048)
# Each route's control (perturbed kernel, CUDA-graph replay): (M, dtype).
INT8_ROUTE_CONTROLS = {'mma': (8, torch.bfloat16),
                       'wgmma': (256, torch.bfloat16),
                       'f32': (8, torch.float32)}
# |y - plain| / |plain| (Frobenius) of the worst output row: both sum the
# same bf16 (or f32) products in f32, in another order; bf16 rounds the
# output.
INT8_TOL = {'bf16': 6e-3, 'f32': 1e-5}
INT8_REPLACES = ('no Pallas kernel; stands for XLA\'s fusion of '
                 'skypilot_tpu/inference/quant.py:86 into Dense')
# The all-zero output channel of every case (its scale is 0).
INT8_ZERO_COL = 3


def int8_case(n, k, dtype, biased, seed):
    g = torch.Generator('cuda').manual_seed(seed)
    q = torch.randint(-127, 128, (n, k), generator=g, device='cuda',
                      dtype=torch.int8)
    scale = torch.rand(n, generator=g, device='cuda') * 0.002
    q[INT8_ZERO_COL] = 0
    scale[INT8_ZERO_COL] = 0.0
    bias = ((torch.randn(n, generator=g, device='cuda') * 0.1).to(dtype)
            if biased else None)
    return q, scale, bias, g


def int8_row_err(y, ref):
    ref = ref.float()
    return ((y.float() - ref).norm(dim=-1)
            / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def int8_bound_ms(m, n, k, x_bytes, il):
    t_bytes = il.bytes_bound(m, n, k, x_bytes) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / (BF16_FLOPS if x_bytes == 2 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def int8_graph_replay(il, m, dtype):
    """One call of m rows captured in a CUDA graph, replayed on new x."""
    q, scale, _, g = int8_case(1024, 4096, dtype, False, seed=7)
    x = torch.randn((m, 4096), generator=g, device='cuda').to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        il.int8_linear(x, q, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = il.int8_linear(x, q, scale)
    x.copy_(torch.randn((m, 4096), generator=g, device='cuda').to(dtype))
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(y, il.int8_linear(x, q, scale))), int8_row_err(
        y, il.int8_linear_reference(x, q, scale))


def route_launches(il, route):
    """`int8_linear`'s launches on `route` so far, over every shape."""
    return sum(n for (r, _, _), n in il.launches_by_route.items()
               if r == route)


def int8_read_floor(q):
    """One PyTorch call that reads the weight's bytes once (a max over
    them as int32): what reading them costs under `time_cold_ms`."""
    return lambda: torch.amax(q.view(torch.int32))


def phase_int8_linear_kernels(il):
    import torch.nn.functional as F
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, seed = [], 0
    worst = {'bf16': 0.0, 'f32': 0.0}
    for model_name, shapes in INT8_SHAPES.items():
        for proj, (n, k) in shapes.items():
            for label, dtype in (('bf16', torch.bfloat16),
                                 ('f32', torch.float32)):
                biased = (model_name, proj) in INT8_BIASED
                q, scale, bias, g = int8_case(n, k, dtype, biased, seed)
                seed += 1
                for m in INT8_ROWS:
                    x = torch.randn((m, k), generator=g,
                                    device='cuda').to(dtype)
                    tiling = il.plan(m, n, k, sms, dtype)
                    before = route_launches(il, tiling.route)
                    y = il.int8_linear(x, q, scale, bias)
                    again = il.int8_linear(x, q, scale, bias)
                    routed = route_launches(il, tiling.route) - before
                    ref = il.int8_linear_reference(x, q, scale, bias)
                    torch.cuda.synchronize()
                    err = int8_row_err(y, ref)
                    zero = (bias[INT8_ZERO_COL].expand(m) if biased
                            else torch.zeros(m, dtype=dtype, device='cuda'))
                    case = {'model': model_name, 'proj': proj, 'n': n,
                            'k': k, 'm': m, 'dtype': label, 'bias': biased,
                            'route': tiling.route, 'plan': tiling,
                            'row_rel_err': err,
                            'max_abs_err': (y.float() - ref.float()).abs()
                            .max().item(),
                            'zero_channel_is_bias': bool(torch.equal(
                                y[:, INT8_ZERO_COL], zero)),
                            'bit_identical': bool(torch.equal(y, again))}
                    cases.append(case)
                    worst[label] = max(worst[label], err)
                    check(routed == 2, f'int8_linear {case}: {routed} of 2 '
                                       f'calls on route {tiling.route}')
                    check(err <= INT8_TOL[label],
                          f'int8_linear {case}: error over {INT8_TOL}')
                    check(case['zero_channel_is_bias'],
                          f'int8_linear {case}: the scale-0 channel is not '
                          f'the bias')
                    check(case['bit_identical'],
                          f'int8_linear {case}: two calls differ')
                    del x, y, again, ref
    for route in il.ROUTES:
        check(any(c['route'] == route for c in cases),
              f'int8_linear: no case on route {route}')
    # Each route's controls: the perturbed kernel must fail the pin, and a
    # call replayed from a CUDA graph must equal an eager one.
    controls = {}
    for route, (m, dtype) in INT8_ROUTE_CONTROLS.items():
        label = 'f32' if dtype == torch.float32 else 'bf16'
        q, scale, _, g = int8_case(4096, 4096, dtype, False, seed=99)
        x = torch.randn((m, 4096), generator=g, device='cuda').to(dtype)
        check(il.plan(m, 4096, 4096, sms, dtype).route == route,
              f'int8_linear control of {route} at M={m} takes another route')
        perturb_err = int8_row_err(
            il.int8_linear(x, q, scale, perturb=0.01),
            il.int8_linear_reference(x, q, scale))
        check(perturb_err > INT8_TOL[label],
              f'perturbed int8_linear ({route}) passed the pin (err '
              f'{perturb_err})')
        graph_equal, graph_err = int8_graph_replay(il, m, dtype)
        check(graph_equal and graph_err <= INT8_TOL[label],
              f'CUDA-graph replay of int8_linear ({route}): equal '
              f'{graph_equal}, error {graph_err}')
        controls[route] = {'m': m, 'dtype': label, 'perturb_err': perturb_err,
                           'perturb_fails': True,
                           'graph_replay_equal': graph_equal,
                           'graph_replay_row_rel_err': graph_err}
    timings = {}
    timed = [('llama3_8b', proj, shape)
             for proj, shape in INT8_SHAPES['llama3_8b'].items()]
    timed.append(('deepseek_v2_lite', 'w_down',
                  INT8_SHAPES['deepseek_v2_lite']['w_down']))
    timed += [('llama3_8b_tp2', proj, INT8_SHAPES['llama3_8b_tp2'][proj])
              for proj in INT8_TP2_ROWS]
    for model_name, proj, (n, k) in timed:
        q, scale, _, g = int8_case(n, k, torch.bfloat16, False, seed=200)
        w_bf16 = il.dequantize(q, scale, torch.bfloat16)
        floor_ms = time_cold_ms(int8_read_floor(q))
        for m in (8, 256):
            x = torch.randn((m, k), generator=g, device='cuda').bfloat16()
            b_ms, b_by = int8_bound_ms(m, n, k, 2, il)
            key = (f'{proj}_m{m}' if model_name == 'llama3_8b'
                   else f'{model_name}_{proj}_m{m}')
            timings[key] = {
                'ms': time_cold_ms(lambda: il.int8_linear(x, q, scale)),
                'plain_ms': time_cold_ms(
                    lambda: il.int8_linear_reference(x, q, scale)),
                'library_ms': time_cold_ms(lambda: F.linear(x, w_bf16)),
                'library': 'F.linear on bf16 weights (--weight-dtype bf16)',
                'floor_ms': floor_ms,
                'floor': 'torch.amax over the int8 weight as int32 (one '
                         'read of its bytes)',
                'bound_ms': b_ms, 'bound_by': b_by,
                'bytes': il.bytes_bound(m, n, k, 2),
                'plan': il.plan(m, n, k, sms)}
        del w_bf16
    emit('int8_linear_kernels', cases=len(cases), worst_row_rel_err=worst,
         tolerance=INT8_TOL, all_bit_identical=True,
         zero_channel_is_bias=True, route_controls=controls,
         wgmma_min_rows=il.WGMMA_MIN_ROWS, timings=timings,
         routes_by_rows={m: sorted({c['route'] for c in cases
                                    if c['m'] == m}) for m in INT8_ROWS},
         worst_cases=sorted(cases, key=lambda c: -c['row_rel_err'])[:4])

    def row(name, model_name, proj, m, timed_as):
        n, k = INT8_SHAPES[model_name][proj]
        key = (f'{proj}_m{m}' if model_name == 'llama3_8b'
               else f'{model_name}_{proj}_m{m}')
        t = timings[key]
        case = next(c for c in cases if c['model'] == model_name
                    and c['proj'] == proj and c['m'] == m
                    and c['dtype'] == 'bf16')
        return {'name': name, 'route': 'cuda',
                'source': 'skypilot_tpu_torch/csrc/int8_linear.cu',
                'replaces': INT8_REPLACES,
                'kernel_route': t['plan'].route, 'shape': (n, k),
                'timed': f'bf16 M={m} at {timed_as} ({n}, {k})',
                'max_abs_err': case['max_abs_err'],
                'ms': t['ms'], 'plain_ms': t['plain_ms'],
                'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
                'floor_ms': t['floor_ms'],
                'library_ms': t['library_ms'], 'library': t['library'],
                'plain': 'int8_linear_reference (dequantize, then F.linear)'}

    rows = [row('int8_linear', 'llama3_8b', 'wq_wo', 8, 'wq')]
    rows += [row(f'int8_linear_{proj}_m256', 'llama3_8b', proj, 256, proj)
             for proj in INT8_SHAPES['llama3_8b']]
    # DeepSeek-V2-Lite's w_down (the ragged K), on the DeepSeek path.
    n, k = INT8_SHAPES['deepseek_v2_lite']['w_down']
    rows += [row(f'int8_linear_w_down_k{k}_m{m}', 'deepseek_v2_lite',
                 'w_down', m, 'DeepSeek-V2-Lite w_down') for m in (8, 256)]
    # One --tensor 2 shard's projections: a decode round and a prefill
    # chunk.
    for proj in INT8_TP2_ROWS:
        for m in (8, 256):
            rows.append(row(f'int8_linear_tp2_{proj}' if m == 8 else
                            f'int8_linear_tp2_{proj}_m{m}',
                            'llama3_8b_tp2', proj, m,
                            f'a --tensor 2 shard of Llama-3-8B {proj}'))
    return rows


# -- the grid collective (csrc/grid_collective.cu) ----------------------------
GRID_COLLECTIVE_REPLACES = (
    'no Pallas kernel; stands for the all-reduce over ICI that GSPMD '
    'inserts in the reference\'s serving grid, '
    'skypilot_tpu/parallel/serving.py:1')
GRID_CASES = (   # (op, dtype, per-rank shape)
    ('sum', torch.bfloat16, (8, 1, 4096)), ('sum', torch.bfloat16,
                                            (1, 256, 4096)),
    ('sum', torch.float32, (8, 1, 4096)), ('sum', torch.bfloat16, (3, 5)),
    ('sum', torch.float32, (3, 5)), ('max', torch.float32, (8, 1)),
    ('max', torch.bfloat16, (8, 4096)), ('gather', torch.float32,
                                         (8, 64128)),
    ('gather', torch.bfloat16, (8, 4096)), ('gather', torch.int32, (8, 3)),
    ('broadcast', torch.int32, (8,)))
GRID_TIMED = (('decode', (8, 1, 4096)), ('chunk', (1, 256, 4096)))


def grid_parts(shape, dtype, ways, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    if dtype == torch.int32:
        return [torch.randint(0, 128256, shape, generator=g, device='cuda',
                              dtype=torch.int32) for _ in range(ways)]
    return [(torch.randn(shape, generator=g, device='cuda')
             * 10.0 ** torch.empty(shape, device='cuda').uniform_(
                 -3, 3, generator=g)).to(dtype) for _ in range(ways)]


def grid_call(gcol, team, op, parts):
    """The kernel's call and the plain helper's for one op."""
    dev = torch.device('cuda:0')
    if op in ('sum', 'max'):
        return (gcol.all_reduce(parts, team, op),
                gcol.all_reduce_reference(parts, op))
    if op == 'gather':
        return [gcol.gather(parts, team)], [gcol.gather_reference(parts,
                                                                  dev)]
    return (gcol.broadcast(parts[0], team),
            gcol.broadcast_reference(parts[0], [dev] * len(parts)))


def graph_ms(fn, n=50):
    """Device ms of one `fn()` from a CUDA graph of n calls on this card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_grid_collective_kernels(gcol):
    """The grid collective on cuda:0 named 2 and 4 times against its plain
    helper (module doc); its rows of the kernels line (the decode and
    chunk sums at T = 2, launches filled in by main)."""
    cases, controls = [], []
    for ways in (2, 4):
        team = gcol.Team(['cuda:0'] * ways)
        for i, (op, dtype, shape) in enumerate(GRID_CASES):
            parts = grid_parts(shape, dtype, ways, seed=i)
            before = gcol.launches
            got, want = grid_call(gcol, team, op, parts)
            torch.cuda.synchronize()
            launched = gcol.launches - before
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            cases.append({'ways': ways, 'op': op, 'dtype': str(dtype),
                          'shape': list(shape), 'exact': exact,
                          'launches': launched})
            check(exact, f'grid collective {op} {dtype} {shape} x{ways}: '
                         f'kernel differs from the plain helper')
            check(launched == (0 if op == 'broadcast' else 1),
                  f'grid collective {op} x{ways}: {launched} launches')
            if op == 'sum' and math.prod(shape) >= 4096:
                # The last shard one ulp up: the kernel's sum of it must
                # fail the check against the plain sum of the parts.
                moved = parts[:-1] + [gcol.next_up(parts[-1])]
                bad, _ = grid_call(gcol, team, op, moved)
                caught = not torch.equal(bad[0], want[0])
                controls.append({'ways': ways, 'dtype': str(dtype),
                                 'shape': list(shape), 'caught': caught})
                check(caught, f'perturbed grid sum {dtype} {shape} x{ways} '
                              f'was not caught')
    # One call captured in a CUDA graph replays right on new parts.
    team = gcol.Team(['cuda:0', 'cuda:0'])
    parts = grid_parts((8, 1, 4096), torch.bfloat16, 2, seed=99)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gcol.all_reduce(parts, team)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gcol.all_reduce(parts, team)
    for p, q in zip(parts, grid_parts((8, 1, 4096), torch.bfloat16, 2,
                                      seed=100)):
        p.copy_(q)
    graph.replay()
    torch.cuda.synchronize()
    replay_exact = torch.equal(out[0],
                               gcol.all_reduce_reference(parts)[0])
    check(replay_exact, 'grid collective: the graph replay differs')
    timings, rows = {}, []
    for label, shape in GRID_TIMED:
        parts = grid_parts(shape, torch.bfloat16, 2, seed=7)
        nbytes = parts[0].numel() * 2
        ms = graph_ms(lambda: gcol.all_reduce(parts, team))
        plain_ms = time_ms([lambda: gcol.all_reduce_reference(parts)])
        # At T = 2 one PyTorch call computes the same bits: a bf16 add
        # does its math in f32 and rounds once.
        library_ms = graph_ms(lambda: torch.add(parts[0], parts[1]))
        check(torch.equal(torch.add(parts[0], parts[1]),
                          gcol.all_reduce(parts, team)[0]),
              f'grid collective {label}: torch.add differs from the sum')
        b_ms = 1e3 * 3 * nbytes / HBM_BYTES_PER_S
        timings[label] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                          'library_ms': library_ms, 'bytes': 3 * nbytes}
        rows.append({
            'name': f'grid_collective_sum_{label}', 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/grid_collective.cu',
            'replaces': GRID_COLLECTIVE_REPLACES,
            'timed': (f'bf16 sum of 2 parts of {list(shape)} on cuda:0 '
                      f'named twice (one launch), warm L2'),
            'size_key': ('sum', nbytes), 'max_abs_err': 0.0,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': 'bytes', 'library_ms': library_ms,
            'library': ('torch.add(parts[0], parts[1]) in a graph, warm L2 '
                        '(the same bits at T = 2; over distinct cards '
                        'profile_grid.py times torch.cuda.nccl.all_reduce)'),
            'plain': 'all_reduce_reference (Tensor.to, f32 sum in shard '
                     'order, cast back)'})
    emit('grid_collective_kernels', cases=len(cases),
         all_exact=all(c['exact'] for c in cases), controls=controls,
         graph_replay_exact=replay_exact, timings=timings,
         launch_rule='one launch a call on one card; broadcast none')
    return rows


def zero_paged(pk):
    pk.route_launches.update(dict.fromkeys(pk.ROUTES, 0))


def flash_counts(fk):
    return {'flash_fwd': fk.fwd_launches, 'flash_bwd': fk.bwd_launches}


def zero_flash(fk):
    fk.fwd_launches = fk.bwd_launches = fk.plain_calls = 0


# -- training -----------------------------------------------------------------
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
    # Step 1's grad norm again on the same weights and batch: its spread
    # in this run bounds train_fsdp's step-1 norm.
    step1_norms = [norm_cuda] + [loss_and_norm('cuda')[1]
                                 for _ in range(FSDP_NORM_REPEATS)]

    zero_flash(fk)
    step = trainer.make_train_step()
    losses, norms, times = [], [], []
    for tokens in toks:
        t0 = time.perf_counter()
        state, (loss, gnorm) = step(state, tokens)
        losses.append(loss.item())
        norms.append(gnorm.item())
        times.append(time.perf_counter() - t0)
    counts = flash_counts(fk)
    check(all(c == layers * steps for c in counts.values())
          and fk.plain_calls == 0, f'train_full launches {counts}')
    check(all(np.isfinite(losses)), f'losses {losses}')
    step_s = float(np.mean(times[1:]))
    tps = batch * seq / step_s
    step1_norms.append(norms[0])
    spread = (max(step1_norms) - min(step1_norms)) / abs(norms[0])
    full = {'losses': losses, 'grad_norms': norms, 'step_s': step_s,
            'step1_norms': step1_norms, 'step1_norm_spread': spread,
            'step1_norm_tol': max(FSDP_TOL, FSDP_NORM_SPREAD * spread),
            'matmul_params': n_matmul, 'tokens_per_s': tps,
            'mfu': 6.0 * n_matmul * tps / BF16_FLOPS,
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
    emit('train_full', card=card, layers=layers, steps=steps, batch=batch,
         seq=seq, params=n_params,
         loss_cuda=loss_cuda, loss_plain=loss_plain,
         grad_norm_cuda=norm_cuda, grad_norm_plain=norm_plain,
         tol=TRAIN_TOL, step_times_s=times, launches=counts, **full)
    return counts, full


def sharded_run(fk, cfg, toks, mesh, **kw):
    """train_full's steps through the sharded trainer on `mesh`: (model,
    trainer, state, losses, norms, step times, flash counts); the counts
    are zeroed just before the steps and read just after."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel import train
    model = convert.init_params(cfg, seed=0, device='cuda')
    trainer = train.ShardedTrainer(
        model, tx=train.default_optimizer(warmup_steps=10, total_steps=20),
        collect_grad_norm=True, mesh=mesh, **kw)
    state = trainer.init()
    step = trainer.make_train_step()
    zero_flash(fk)
    losses, norms, times = [], [], []
    for tokens in toks:
        t0 = time.perf_counter()
        state, (loss, gnorm) = step(state, tokens)
        losses.append(loss.item())
        norms.append(gnorm.item())
        times.append(time.perf_counter() - t0)
    counts = flash_counts(fk)
    plain = fk.plain_calls
    return model, trainer, state, losses, norms, times, counts, plain


def phase_train_fsdp(fk, card, full):
    """The sharded trainer over a 1-rank NCCL job at train_full's shape,
    plain and with zero1 + overlap asked for (at data = 1 the layout
    turns both off, so that run is the plain path again), held to
    train_full's curve; its checkpoint restores into the one-card trainer
    bit for bit."""
    import shutil
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.parallel import distributed, train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.checkpoints import CheckpointManager
    layers, steps, batch, seq = 4, 4, 8, 2048
    cfg = dataclasses.replace(registry.train_config('llama3-8b', seq),
                              num_layers=layers)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(steps)]
    job = distributed.jobs(cpu=False, workers=1)[0]
    distributed.join(job)
    ckpt = os.path.join(WORK, 'fsdp_ckpt')
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig.auto(1))
        check(mesh_lib.mesh_summary(mesh) == 'Mesh(single-device)'
              and torch.distributed.get_backend() == 'nccl',
              f'mesh {mesh}')
        rows = mesh_lib.batch_rows(mesh, batch)
        check((rows.start, rows.stop) == (0, batch), f'rows {rows}')
        torch.cuda.reset_peak_memory_stats()
        model, trainer, state, losses, norms, times, counts, plain = \
            sharded_run(fk, cfg, toks, mesh)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(c == layers * steps for c in counts.values())
              and plain == 0, f'train_fsdp launches {counts}, {plain} plain')

        def close(losses, norms):
            return all(abs(x - y) <= tol * abs(y) for got, want, tol in (
                (losses[:1], full['losses'][:1], FSDP_TOL),
                (norms[:1], full['grad_norms'][:1], full['step1_norm_tol']),
                (losses, full['losses'], FSDP_CURVE_TOL))
                for x, y in zip(got, want))

        check(close(losses, norms),
              f'sharded {losses} / {norms[0]} vs train_full '
              f'{full["losses"]} / {full["grad_norms"][0]} (step-1 norm '
              f'bound {full["step1_norm_tol"]})')
        # The control: a step whose gradient is scaled by 1 +
        # FSDP_NORM_CONTROL reports a norm scaled so, which must fail.
        check(not close(losses, [norms[0] * (1 + FSDP_NORM_CONTROL)]),
              f'a step-1 grad norm scaled by 1 + {FSDP_NORM_CONTROL} passed '
              f'the bound {full["step1_norm_tol"]}')
        del model, trainer, state
        torch.cuda.empty_cache()
        # The checkpoint round on a smaller state (CKPT_CUT: one layer, a
        # 4096-token vocab; the 4-layer state's 23 GB round cost 119 s
        # of the run's limit), one sharded step into it: the collective
        # save restores into the one-card trainer bit for bit, and saved
        # again from there is the same file byte for byte.
        ck_cfg = dataclasses.replace(cfg, **CKPT_CUT)
        ck_toks = [torch.from_numpy(np.random.default_rng(0).integers(
            0, ck_cfg.vocab_size, (batch, seq))).cuda()]
        model, trainer, state, *_ = sharded_run(fk, ck_cfg, ck_toks, mesh)
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        CheckpointManager(ckpt).save(state.step, state, force=True)
        save_s = time.perf_counter() - t0
        one = train.ShardedTrainer(
            convert.init_params(ck_cfg, seed=1, device='cuda'),
            tx=train.default_optimizer(warmup_steps=10, total_steps=20))
        t0 = time.perf_counter()
        restored = CheckpointManager(ckpt).restore(one.init())
        restore_s = time.perf_counter() - t0
        layout = state.layout
        same = restored.step == state.step and int(
            restored.opt_state['count']) == int(state.opt_state['count'])
        for i, (t, u) in enumerate(zip(
                train.trainable_leaves(state.params),
                train.trainable_leaves(restored.params))):
            same = same and torch.equal(layout.full(i, layout.local(t)), u)
            for key in ('mu', 'nu'):
                same = same and torch.equal(
                    layout.full(i, state.opt_state[key][i], moment=True),
                    restored.opt_state[key][i])
        check(same, 'the sharded checkpoint did not restore bit for bit')
        again = ckpt + '_again'
        shutil.rmtree(again, ignore_errors=True)
        CheckpointManager(again).save(restored.step, restored, force=True)
        check(filecmp.cmp(os.path.join(ckpt, str(state.step), 'state.pt'),
                          os.path.join(again, str(state.step), 'state.pt'),
                          shallow=False),
              'the restored checkpoint saved again is another file')
        shutil.rmtree(again, ignore_errors=True)
        ckpt_gb = sum(t.numel() for t in train.trainable_leaves(
            restored.params)) * 12 / 1e9
        del model, trainer, state, one, restored, layout
        torch.cuda.empty_cache()
        _, z_trainer, _, z_losses, z_norms, _, z_counts, z_plain = \
            sharded_run(fk, cfg, toks, mesh, zero1=True, overlap=True)
        z_active = z_trainer.layout.zero1 or z_trainer.layout.overlap
        del z_trainer
        check(not z_active, 'zero1 / overlap active at data = 1')
        check(all(c == layers * steps for c in z_counts.values())
              and z_plain == 0 and close(z_losses, z_norms),
              f'zero1+overlap {z_losses} / {z_counts}')
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        distributed.leave()
        torch.cuda.empty_cache()
    step_s = float(np.mean(times[1:]))
    tps = batch * seq / step_s
    ref = full['losses'] + full['grad_norms'][:1]
    emit('train_fsdp', card=card, mesh='Mesh(single-device)', world=1,
         backend='nccl', layers=layers, steps=steps, batch=batch, seq=seq,
         tol=FSDP_TOL, curve_tol=FSDP_CURVE_TOL,
         step1_norm_tol=full['step1_norm_tol'],
         step1_norm_spread=full['step1_norm_spread'],
         step1_norm_control=FSDP_NORM_CONTROL, control_fails=True,
         losses=losses,
         grad_norms=norms,
         max_rel_diff=max(abs(x - y) / abs(y) for x, y in
                          zip(losses + norms[:1], ref)),
         zero1_overlap_max_rel_diff=max(abs(x - y) / abs(y) for x, y in
                                        zip(z_losses + z_norms[:1], ref)),
         zero1_overlap_losses=z_losses, zero1_overlap_active=z_active,
         step_times_s=times, step_s=step_s,
         tokens_per_s=tps,
         mfu=6.0 * full['matmul_params'] * tps / BF16_FLOPS,
         peak_mem_gb=peak, ckpt_cut=CKPT_CUT, ckpt_gb=ckpt_gb,
         ckpt_save_s=save_s, ckpt_restore_s=restore_s,
         launches=counts, zero1_overlap_launches=z_counts,
         train_full=full)
    return {name: counts[name] + z_counts[name] for name in counts}


# -- pipeline training ----------------------------------------------------------
# train_pipeline: the pipeline runner in process on one card named twice
# (parallel/pipeline.py), Llama-3-8B width at PIPE_LAYERS layers, train_full's
# B=8 S=2048 batches, PIPE_MICROBATCHES microbatches of one row, each style.
PIPE_LAYERS = 4
PIPE_BATCH, PIPE_SEQ = 8, 2048
PIPE_MICROBATCHES = 8
PIPE_STEPS = 3
PIPE_DEVICES = ['cuda:0', 'cuda:0']
PIPE_STYLES = (('gpipe', 1), ('1f1b', 1), ('interleaved', 2))
# The step-1 bound: PIPE_SPREAD times the witness's spread over
# 1 + PIPE_REPEATS readings (the flash backward's dQ sums are not
# bit-deterministic), never under FSDP_TOL. Each style's step 1 is read
# 1 + PIPE_REPEATS times as well, and the medians of the two are held to
# that bound; both controls must fall outside it.
PIPE_REPEATS = 4
PIPE_SPREAD = 2.0
PIPE_FAULTS = ('backward_skipped', 'stale_handoff')


def pipe_config():
    from skypilot_tpu_torch.models import registry
    return dataclasses.replace(registry.train_config('llama3-8b', PIPE_SEQ),
                               num_layers=PIPE_LAYERS)


@contextlib.contextmanager
def pipe_fault(pp, name):
    """The runner broken on purpose: 'backward_skipped' drops microbatch
    1's backward (its chunks pass zeros on and add no grads; every style
    runs a chunk's backwards in microbatch order, so it is each chunk's
    second); 'stale_handoff' makes each forward hand-off deliver the
    previous microbatch's activation from the same stage. Also used by
    tests/torch_dist_workers.py's card jobs."""
    if name == 'backward_skipped':
        orig, calls = pp._chunk_backward, {}

        def skipped(stage, virtual, x, g, aux_ct, acc):
            n = calls[stage.index, virtual] = calls.get(
                (stage.index, virtual), -1) + 1
            if n == 1:
                return torch.zeros_like(g)
            return orig(stage, virtual, x, g, aux_ct, acc)

        pp._chunk_backward = skipped
        try:
            yield
        finally:
            del pp._chunk_backward
        return
    group, last = pp.group, {}
    orig = group.handoff

    def stale(messages, like):
        out = []
        for src, dst, key, t in messages:
            if key[0] == 'f' and t is not None:
                prev, last[src] = last.get(src), t
                t = t if prev is None else prev
            out.append((src, dst, key, t))
        return orig(out, like)

    group.handoff = stale
    try:
        yield
    finally:
        del group.handoff


def pipe_reading(pp, tokens):
    """A pipelined step 1 without its update: (loss, grad norm)."""
    loss, grads = pp.loss_and_grad(tokens)
    norm = torch.sqrt(pp.global_sq(grads)[pp.stages[0].index])
    return loss.item(), norm.item()


def median_reading(readings):
    """The componentwise median of (loss, grad norm) readings."""
    return tuple(float(np.median([r[k] for r in readings])) for k in (0, 1))


def pipe_witness(cfg, tokens, shards, readings):
    """The one-card trainer fed `tokens`' rows one microbatch at a time
    (the pipeline's `microbatch_rows`), its loss the pipeline's
    vocab-split head over `shards` shards in f32 (`split_vocab_loss`),
    grads summed in f32 and losses averaged: the pipelined step's
    arithmetic less the hand-offs. `readings` (loss, norm) pairs on the
    same weights and batch."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel import pipeline, train
    model = convert.init_params(cfg, seed=0, device='cuda')
    trainer = train.ShardedTrainer(model, collect_grad_norm=True)
    trainer._loss = lambda params, tok: pipeline.split_vocab_loss(
        model(tok, return_hidden=True), model.lm_head, tok, shards, cfg)
    params = dict(model.named_parameters())
    leaves = list(params.values())
    rows = pipeline.microbatch_rows(tokens.shape[0], PIPE_MICROBATCHES)
    out = []
    for _ in range(readings):
        sums, total = None, 0.0
        for r in rows:
            loss = trainer._compute_loss(params, tokens[r])
            grads = torch.autograd.grad(loss, leaves)
            sums = ([g.float() for g in grads] if sums is None else
                    [a.add_(g.float()) for a, g in zip(sums, grads)])
            total = total + loss.detach()
        norm = torch.sqrt(sum((a / len(rows)).square().sum() for a in sums))
        out.append(((total / len(rows)).item(), norm.item()))
        del sums
    del model, trainer, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_pipeline(fk, card, full):
    """The pipeline trainer API in process on one card named twice, each
    style: the median of its step-1 readings against the witness's
    within a bound set in this run (both controls outside it), flash
    launches, steady steps; where 2 cards are visible, `train_lm --pipeline-stages 2` as a 2-rank NCCL
    job held to the in-process 1f1b reading of its batch. Returns the
    flash launches of the main path's steps."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel import pipeline, train
    t_phase = time.perf_counter()
    cfg = pipe_config()
    layers, M, S = PIPE_LAYERS, PIPE_MICROBATCHES, len(PIPE_DEVICES)
    batch, seq = PIPE_BATCH, PIPE_SEQ
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(PIPE_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    witness = pipe_witness(cfg, toks[0], S, 1 + PIPE_REPEATS)
    witness_s = time.perf_counter() - t0
    ref = median_reading(witness)
    spread = [(max(w[k] for w in witness) - min(w[k] for w in witness))
              / abs(ref[k]) for k in (0, 1)]
    bounds = [max(FSDP_TOL, PIPE_SPREAD * sp) for sp in spread]

    def offsets(reading, against=ref):
        return [abs(reading[k] - against[k]) / abs(against[k])
                for k in (0, 1)]

    def within(reading):
        return all(o <= b for o, b in zip(offsets(reading), bounds))

    two_cards = torch.cuda.device_count() >= PARALLEL_CARDS
    lm_tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32).astype(
            np.int64)).cuda()
    styles, totals, lm_reading = {}, dict.fromkeys(
        ('flash_fwd', 'flash_bwd'), 0), None
    for style, v in PIPE_STYLES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pp = pipeline.PipelinedLM(
            convert.init_params(cfg, seed=0, device='cuda'),
            devices=PIPE_DEVICES, num_microbatches=M, schedule=style,
            virtual_stages=v)
        tx = train.default_optimizer(warmup_steps=10, total_steps=20)
        state = pp.init(tx)
        zero_flash(fk)
        readings = [pipe_reading(pp, toks[0])]
        reading_counts = flash_counts(fk)
        check(reading_counts == {'flash_fwd': 2 * layers * M,
                                 'flash_bwd': layers * M}
              and fk.plain_calls == 0,
              f'train_pipeline {style} step-1 launches {reading_counts}, '
              f'{fk.plain_calls} plain')
        readings += [pipe_reading(pp, toks[0]) for _ in range(PIPE_REPEATS)]
        sound = median_reading(readings)
        controls = {}
        for name in PIPE_FAULTS:
            with pipe_fault(pp, name):
                controls[name] = pipe_reading(pp, toks[0])
        check(within(sound),
              f'train_pipeline {style}: step 1 {sound} (median of '
              f'{readings}) vs witness {ref} (median of {witness}) '
              f'(offsets {offsets(sound)}, bounds {bounds})')
        check(all(not within(c) for c in controls.values()),
              f'train_pipeline {style}: a control passed the bounds '
              f'{bounds}: {controls}')
        if style == '1f1b' and two_cards:
            lm_reading = pipe_reading(pp, lm_tokens)
        step = pp.make_train_step(tx, collect_grad_norm=True)
        group = pp.group
        handoffs0, collectives0 = group.handoffs, group.collectives
        zero_flash(fk)
        losses, norms, times = [], [], []
        for tokens in toks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, (loss, gnorm) = step(state, tokens)
            losses.append(loss.item())
            norms.append(gnorm.item())
            times.append(time.perf_counter() - t0)
        counts = flash_counts(fk)
        check(counts == {'flash_fwd': 2 * layers * M * PIPE_STEPS,
                         'flash_bwd': layers * M * PIPE_STEPS}
              and fk.plain_calls == 0,
              f'train_pipeline {style} launches {counts}, '
              f'{fk.plain_calls} plain')
        check(all(np.isfinite(losses + norms)) and within(
            (losses[0], norms[0])),
              f'train_pipeline {style} steps {losses} / {norms}')
        for k in totals:
            totals[k] += counts[k]
        step_s = float(np.mean(times[1:]))
        tps = batch * seq / step_s
        sched = pp.schedule
        styles[style] = {
            'virtual_stages': v, 'ticks': sched.num_ticks,
            'bubble_fraction': sched.bubble_fraction,
            'describe': sched.describe(),
            'step1': list(sound), 'step1_readings': readings,
            'step1_rel_err': offsets(sound),
            'controls': {k: list(c) for k, c in controls.items()},
            'controls_rel_err': {k: offsets(c) for k, c in
                                 controls.items()},
            'vs_train_full_whole_batch': offsets(
                sound, (full['losses'][0], full['grad_norms'][0])),
            'losses': losses, 'grad_norms': norms, 'step_times_s': times,
            'step_s': step_s, 'tokens_per_s': tps,
            'mfu': 6.0 * full['matmul_params'] * tps / BF16_FLOPS,
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'handoffs_a_step': (group.handoffs - handoffs0) / PIPE_STEPS,
            'collectives_a_step': (group.collectives - collectives0)
            / PIPE_STEPS,
            'launches': counts}
        del pp, state, step, tx
    gc.collect()
    torch.cuda.empty_cache()
    job = phase_train_pipeline_cards(card, lm_reading, bounds)
    emit('train_pipeline', card=card, devices=PIPE_DEVICES, layers=layers,
         reduced={'num_layers': [32, layers]}, batch=batch, seq=seq,
         microbatches=M, witness=witness, witness_s=witness_s,
         witness_spread=spread, bounds=bounds, spread_factor=PIPE_SPREAD,
         styles=styles,
         train_full={'step1': [full['losses'][0], full['grad_norms'][0]],
                     'step_s': full['step_s'],
                     'tokens_per_s': full['tokens_per_s'],
                     'mfu': full['mfu'], 'peak_mem_gb': full['peak_mem_gb']},
         note=('one card named twice: the stages run one after the other, '
               'so step s, tokens/s and MFU measure the runner\'s overhead '
               '(each chunk recomputed in its backward, the hand-offs, the '
               'vocab-split head), not the overlap of a pipeline'),
         two_card_job=job, seconds=time.perf_counter() - t_phase)
    if job is not None:
        for k in totals:
            totals[k] += job['launches'][k]
    return totals, styles['1f1b']['step1']


def phase_train_pipeline_cards(card, lm_reading, bounds):
    """`train_lm --pipeline-stages 2 --pipeline-schedule 1f1b` at
    train_pipeline's shape as a 2-rank NCCL job (None on one card): its
    step 1 within `bounds` of the in-process 1f1b reading of the same
    batch (`lm_reading`)."""
    layers, steps, M = PIPE_LAYERS, PARALLEL_STEPS, PIPE_MICROBATCHES
    argv = ['--model', 'llama3-8b', '--seq', '2048', '--global-batch', '8',
            '--pipeline-stages', str(PARALLEL_CARDS), '--pipeline-schedule',
            '1f1b', '--microbatches', str(M), '--steps', str(steps),
            '--log-every', '1']
    out = parallel_job('train_pipeline_2card', argv, 'llama3-8b', layers,
                       card)
    if out is None:
        return None
    ranks, records, seconds = out
    per_rank = layers // PARALLEL_CARDS
    for counts in ranks:
        check(counts['flash_fwd'] == 2 * per_rank * M * steps
              and counts['flash_bwd'] == per_rank * M * steps
              and counts['plain_calls'] == 0,
              f'train_pipeline_2card launches {ranks}')
    first = (records[0]['loss'], records[0]['grad_norm'])
    errs = [abs(first[k] - lm_reading[k]) / abs(lm_reading[k])
            for k in (0, 1)]
    check(all(e <= b for e, b in zip(errs, bounds)),
          f'train_pipeline_2card step 1 {first} vs in process {lm_reading} '
          f'(bounds {bounds})')
    return {'argv': argv, 'ranks': PARALLEL_CARDS,
            'losses': [r['loss'] for r in records],
            'grad_norms': [r['grad_norm'] for r in records],
            'in_process_step1': list(lm_reading), 'step1_rel_err': errs,
            'step_time_s': [r['step_time_s'] for r in records],
            'tokens_per_s': [r['tokens_per_sec'] for r in records],
            'bubble_frac': [r['bubble_frac'] for r in records],
            'launches': {k: sum(r[k] for r in ranks)
                         for k in ('flash_fwd', 'flash_bwd')},
            'seconds': seconds}


# -- tensor-parallel training ---------------------------------------------------
# train_tensor: the sharded trainer over TENSOR_DEVICES in process
# (ShardedTrainer(devices=...), parallel/tensor.py), one card named twice,
# at train_full's shape and batches; step 1 against train_full's
# whole-model step 1 within train_fsdp's bounds (the loss within
# FSDP_TOL, the norm within twice train_full's step-1 spread) and against
# the median of the shards' own reading (1 + TENSOR_REPEATS times) within
# TENSOR_SPREAD times its spread, at least FSDP_TOL; then the median of
# the pipeline over a 2 x 2 grid of the card (--pipeline-stages 2
# --tensor 2) against train_pipeline's 1f1b median within TENSOR_SPREAD
# times the grid's own spread (1 + TENSOR_REPEATS readings), at least
# FSDP_TOL. Controls
# (parallel/tensor.py `tensor_fault`) must fall outside both.
TENSOR_DEVICES = ['cuda:0', 'cuda:0']
TENSOR_PIPE_DEVICES = [['cuda:0', 'cuda:0'], ['cuda:0', 'cuda:0']]
TENSOR_STEPS = 3
TENSOR_REPEATS = 4
TENSOR_SPREAD = 2.0
TENSOR_FAULTS = ('copy_skipped', 'max_dropped')
# Within pipeline stages the vocab tables are whole over `tensor` (split
# over `stage`): no vocab-parallel max to drop.
TENSOR_STAGE_FAULTS = ('copy_skipped', 'reduce_skipped')


@contextlib.contextmanager
def flash_shapes(fk):
    """The (hq, hkv, head_dim) of every flash launch in the body."""
    orig, seen = fk._check, set()

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen.add(tuple(out[2:5]))
        return out

    fk._check = spy
    try:
        yield seen
    finally:
        fk._check = orig


def tensor_reading(trainer, state, tokens):
    """A tensor-sharded step 1 without its update: (loss, grad norm)."""
    from skypilot_tpu_torch.parallel import train
    loss = trainer._compute_loss(state.params, tokens)
    grads = torch.autograd.grad(loss, train.trainable_leaves(state.params))
    norm = torch.sqrt(trainer.layout.global_sq(grads))
    return loss.item(), norm.item()


def phase_train_tensor(fk, card, full, pipe_step1):
    """Tensor-parallel training on one card named twice: the sharded
    trainer (T = 2) at train_full's shape, step 1 against its witness and
    train_full, two controls, 3 steps; the pipeline over a 2 x 2 grid,
    step 1 against train_pipeline's 1f1b reading (`pipe_step1`); where 2
    cards are visible `train_lm --tensor 2` as a 2-rank NCCL job.
    Returns the flash launches of the main path's steps and readings."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.parallel import pipeline, train
    from skypilot_tpu_torch.parallel.tensor import tensor_fault
    t_phase = time.perf_counter()
    cfg = pipe_config()
    layers, ways = PIPE_LAYERS, len(TENSOR_DEVICES)
    batch, seq, M = PIPE_BATCH, PIPE_SEQ, PIPE_MICROBATCHES
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(TENSOR_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = train.ShardedTrainer(
        convert.init_params(cfg, seed=0, device='cuda'),
        tx=train.default_optimizer(warmup_steps=10, total_steps=20),
        collect_grad_norm=True, devices=TENSOR_DEVICES)
    state = trainer.init()
    group = trainer.tensor[0]
    shard_heads = (cfg.num_heads // ways, cfg.num_kv_heads // ways,
                   cfg.head_dim)
    zero_flash(fk)
    with flash_shapes(fk) as shapes:
        witness = [tensor_reading(trainer, state, toks[0])
                   for _ in range(1 + TENSOR_REPEATS)]
    reading_counts = flash_counts(fk)
    check(reading_counts == dict.fromkeys(
        ('flash_fwd', 'flash_bwd'), layers * ways * (1 + TENSOR_REPEATS))
          and fk.plain_calls == 0 and shapes == {shard_heads},
          f'train_tensor readings launched {reading_counts}, '
          f'{fk.plain_calls} plain, at heads {shapes}')
    ref = median_reading(witness)
    spread = [(max(w[k] for w in witness) - min(w[k] for w in witness))
              / abs(ref[k]) for k in (0, 1)]
    bounds = [max(FSDP_TOL, TENSOR_SPREAD * sp) for sp in spread]

    def offsets(reading, against=ref):
        return [abs(reading[k] - against[k]) / abs(against[k])
                for k in (0, 1)]

    def within(reading, limits=bounds, against=ref):
        return all(o <= b for o, b in zip(offsets(reading, against), limits))

    controls = {}
    for name in TENSOR_FAULTS:
        with tensor_fault(name):
            controls[name] = tensor_reading(trainer, state, toks[0])
    check(all(not within(c) for c in controls.values()),
          f'train_tensor: a control passed the bounds {bounds}: {controls}')
    lm_reading = None
    if torch.cuda.device_count() >= PARALLEL_CARDS:
        lm_reading = tensor_reading(trainer, state, torch.from_numpy(
            np.random.default_rng(0).integers(
                0, cfg.vocab_size, (batch, seq), dtype=np.int32).astype(
                    np.int64)).cuda())
    step = trainer.make_train_step()
    zero_flash(fk)
    reductions0, copies0 = group.reductions, group.copies
    losses, norms, times = [], [], []
    with flash_shapes(fk) as shapes:
        for tokens in toks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, (loss, gnorm) = step(state, tokens)
            losses.append(loss.item())
            norms.append(gnorm.item())
            times.append(time.perf_counter() - t0)
    counts = flash_counts(fk)
    check(counts == dict.fromkeys(('flash_fwd', 'flash_bwd'),
                                  layers * ways * TENSOR_STEPS)
          and fk.plain_calls == 0 and shapes == {shard_heads},
          f'train_tensor launched {counts}, {fk.plain_calls} plain, at '
          f'heads {shapes}')
    step1 = (losses[0], norms[0])
    full1 = (full['losses'][0], full['grad_norms'][0])
    # train_full's bound, as train_fsdp's: the loss within FSDP_TOL, the
    # norm within twice train_full's own step-1 spread (at least
    # FSDP_TOL); both controls must fall outside it too.
    full_bounds = [FSDP_TOL, full['step1_norm_tol']]
    check(all(np.isfinite(losses + norms)) and within(step1),
          f'train_tensor: step 1 {step1} vs witness {ref} (offsets '
          f'{offsets(step1)}, bounds {bounds})')
    check(within(step1, full_bounds, full1),
          f'train_tensor: step 1 {step1} vs train_full {full1} (offsets '
          f'{offsets(step1, full1)}, bounds {full_bounds})')
    check(all(not within(c, full_bounds, full1) for c in controls.values()),
          f'train_tensor: a control passed train_full\'s bounds '
          f'{full_bounds}: {controls}')
    step_s = float(np.mean(times[1:]))
    tps = batch * seq / step_s
    peak = torch.cuda.max_memory_allocated() / 1e9
    reductions = (group.reductions - reductions0) / TENSOR_STEPS
    copies = (group.copies - copies0) / TENSOR_STEPS
    totals = dict(counts)
    del trainer, state, step
    gc.collect()
    torch.cuda.empty_cache()
    # --pipeline-stages 2 --tensor 2 on the card named four times.
    torch.cuda.reset_peak_memory_stats()
    pp = pipeline.PipelinedLM(
        convert.init_params(cfg, seed=0, device='cuda'),
        devices=TENSOR_PIPE_DEVICES, num_microbatches=M, schedule='1f1b')
    pp.init(train.default_optimizer(warmup_steps=10, total_steps=20))
    zero_flash(fk)
    with flash_shapes(fk) as shapes:
        pipe_reading_ = pipe_reading(pp, toks[0])
    pipe_counts = flash_counts(fk)
    check(pipe_counts == {'flash_fwd': 2 * layers * M * ways,
                          'flash_bwd': layers * M * ways}
          and fk.plain_calls == 0 and shapes == {shard_heads},
          f'train_tensor pipeline launched {pipe_counts}, '
          f'{fk.plain_calls} plain, at heads {shapes}')
    # The grid against the 1f1b pipeline on whole heads: within
    # TENSOR_SPREAD times the grid's own spread, at least FSDP_TOL; its
    # controls outside that.
    pipe_witness_ = [pipe_reading_] + [pipe_reading(pp, toks[0])
                                       for _ in range(TENSOR_REPEATS)]
    pipe_center = median_reading(pipe_witness_)
    pipe_spread = [(max(w[k] for w in pipe_witness_)
                    - min(w[k] for w in pipe_witness_)) / abs(
                        pipe_center[k]) for k in (0, 1)]
    pipe_bounds = [max(FSDP_TOL, TENSOR_SPREAD * sp) for sp in pipe_spread]
    pipe_controls = {}
    for name in TENSOR_STAGE_FAULTS:
        with tensor_fault(name):
            pipe_controls[name] = pipe_reading(pp, toks[0])
    check(within(pipe_center, pipe_bounds, pipe_step1),
          f'train_tensor pipeline step 1 {pipe_center} (median of '
          f'{pipe_witness_}) vs the 1f1b pipeline {pipe_step1} (offsets '
          f'{offsets(pipe_center, pipe_step1)}, bounds {pipe_bounds})')
    check(all(not within(c, pipe_bounds, pipe_step1)
              for c in pipe_controls.values()),
          f'train_tensor pipeline: a control passed the bounds '
          f'{pipe_bounds}: {pipe_controls}')
    pipe_peak = torch.cuda.max_memory_allocated() / 1e9
    for k in totals:
        totals[k] += pipe_counts[k]
    del pp
    gc.collect()
    torch.cuda.empty_cache()
    job = phase_train_tensor_cards(card, lm_reading, bounds)
    emit('train_tensor', card=card, devices=TENSOR_DEVICES, layers=layers,
         reduced={'num_layers': [32, layers]}, batch=batch, seq=seq,
         shard_heads=list(shard_heads), witness=witness,
         witness_spread=spread, bounds=bounds, spread_factor=TENSOR_SPREAD,
         step1=list(step1), step1_rel_err=offsets(step1),
         controls={k: list(c) for k, c in controls.items()},
         controls_rel_err={k: offsets(c) for k, c in controls.items()},
         vs_train_full=offsets(step1, full1), train_full_bounds=full_bounds,
         controls_vs_train_full={k: offsets(c, full1)
                                 for k, c in controls.items()},
         losses=losses, grad_norms=norms, step_times_s=times,
         step_s=step_s, tokens_per_s=tps,
         mfu=6.0 * full['matmul_params'] * tps / BF16_FLOPS,
         peak_mem_gb=peak, reductions_a_step=reductions,
         copies_a_step=copies, launches=counts,
         reading_launches=reading_counts,
         pipeline={'devices': TENSOR_PIPE_DEVICES, 'microbatches': M,
                   'schedule': '1f1b', 'step1': list(pipe_center),
                   'readings': pipe_witness_, 'spread': pipe_spread,
                   'bounds': pipe_bounds,
                   'vs_pipeline_1f1b': offsets(pipe_center, pipe_step1),
                   'controls_vs_pipeline_1f1b': {
                       k: offsets(c, pipe_step1)
                       for k, c in pipe_controls.items()},
                   'launches': pipe_counts, 'peak_mem_gb': pipe_peak},
         train_full={'step1': list(full1), 'step_s': full['step_s'],
                     'tokens_per_s': full['tokens_per_s'],
                     'mfu': full['mfu'], 'peak_mem_gb': full['peak_mem_gb']},
         note=('one card named twice: the shards run one after the other, '
               'so step s, tokens/s and MFU measure the sharded code\'s '
               'overhead (half-width products, the sums of the shards\' '
               'parts, the vocab-split head), not two cards\' speed'),
         two_card_job=job, seconds=time.perf_counter() - t_phase)
    if job is not None:
        for k in totals:
            totals[k] += job['launches'][k]
    return totals


def phase_train_tensor_cards(card, lm_reading, bounds):
    """`train_lm --tensor 2` at train_tensor's shape as a 2-rank NCCL
    job (None on one card): its step 1 within `bounds` of the in-process
    reading of its batch (`lm_reading`)."""
    layers, steps = PIPE_LAYERS, PARALLEL_STEPS
    argv = ['--model', 'llama3-8b', '--seq', str(PIPE_SEQ),
            '--global-batch', str(PIPE_BATCH), '--tensor',
            str(PARALLEL_CARDS), '--steps', str(steps), '--log-every', '1']
    out = parallel_job('train_tensor_2card', argv, 'llama3-8b', layers,
                       card)
    if out is None:
        return None
    ranks, records, seconds = out
    for counts in ranks:
        check(counts['flash_fwd'] == layers * steps
              and counts['flash_bwd'] == layers * steps
              and counts['plain_calls'] == 0,
              f'train_tensor_2card launches {ranks}')
    first = (records[0]['loss'], records[0]['grad_norm'])
    errs = [abs(first[k] - lm_reading[k]) / abs(lm_reading[k])
            for k in (0, 1)]
    check(all(e <= b for e, b in zip(errs, bounds)),
          f'train_tensor_2card step 1 {first} vs in process {lm_reading} '
          f'(bounds {bounds})')
    return {'argv': argv, 'ranks': PARALLEL_CARDS,
            'losses': [r['loss'] for r in records],
            'grad_norms': [r['grad_norm'] for r in records],
            'in_process_step1': list(lm_reading), 'step1_rel_err': errs,
            'step_time_s': [r['step_time_s'] for r in records],
            'tokens_per_s': [r['tokens_per_sec'] for r in records],
            'launches': {k: sum(r[k] for r in ranks)
                         for k in ('flash_fwd', 'flash_bwd')},
            'seconds': seconds}


def run_train_lm(argv):
    """`train_lm.main(argv)` in this process, one rank on card 0 however
    many cards are visible (train_lm would start one worker a card);
    its stdout, echoed."""
    from skypilot_tpu_torch.recipes import train_lm
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_lm.main(argv, workers=1)
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
    # The runtime's engine, pool and graphs hold reference cycles: free
    # them here, before later phases start processes of their own.
    del model, rt, server, thread
    gc.collect()
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


# -- training recovery --------------------------------------------------------
ROOT = os.path.dirname(os.path.abspath(__file__))
# The notice's metadata probe goes to a closed port on this host (it
# fails at once, five strikes and it stops), so no run reaches past the
# machine.
LOCAL_METADATA = 'http://127.0.0.1:9/computeMetadata/v1/instance/preempted'
# `python -m skypilot_tpu_torch.recipes.train_lm ARGS` run through runpy,
# so that at exit (rc 0 or the SystemExit of rc 83) the child writes its
# flash kernels' launch counts to the file named first.
COUNTING_CHILD = (
    'import atexit, json, runpy, sys\n'
    'from skypilot_tpu_torch.ops import flash_kernel as fk\n'
    'out = sys.argv.pop(1)\n'
    'def dump():\n'
    '    with open(out, "w") as f:\n'
    '        json.dump({"flash_fwd": fk.fwd_launches, "flash_bwd": '
    'fk.bwd_launches, "plain_calls": fk.plain_calls}, f)\n'
    'atexit.register(dump)\n'
    'runpy.run_module("skypilot_tpu_torch.recipes.train_lm", '
    'run_name="__main__", alter_sys=True)\n')


# train_guard_chaos: the steps of the run, the delay of every batch fetch
# and the one-second polls before the injected notice. With p = CHAOS_PACE_S
# + a 2-layer step (1.43 s on an H100) and T1 the first step (12.2 s, its
# warm-up), the rollback comes at about T1 + 6p s and the last step at
# about T1 + (CHAOS_STEPS + 2)p s after the poller starts: the notice at
# CHAOS_NOTICE_POLLS s falls between them for any T1 from 4 to 24 s.
CHAOS_STEPS = 24
CHAOS_PACE_S = 1.0
CHAOS_NOTICE_POLLS = 36


class Child:
    """One train_lm process: stdout and stderr merged, each line stamped
    with seconds since the start, echoed to WORK/train_guard/<name>.log.
    `on_line(line, child)` sees every line as it arrives. Killed at
    `timeout` or on the way out."""

    def __init__(self, name, argv, plan=None, counts=False, on_line=None,
                 timeout=600):
        from skypilot_tpu_torch.robustness.train_guard import METADATA_URL_ENV
        root = os.path.join(WORK, 'train_guard')
        os.makedirs(root, exist_ok=True)
        env = dict(os.environ)
        env[METADATA_URL_ENV] = LOCAL_METADATA
        env.pop('STPU_FAULT_PLAN', None)
        # One card, however many are visible: train_lm would start one
        # worker a card.
        env['CUDA_VISIBLE_DEVICES'] = os.environ.get(
            'CUDA_VISIBLE_DEVICES', '0').split(',')[0]
        if plan is not None:
            env['STPU_FAULT_PLAN'] = json.dumps(plan)
        self.counts_path = os.path.join(root, f'{name}.counts.json')
        if os.path.exists(self.counts_path):
            os.remove(self.counts_path)
        cmd = ([sys.executable, '-c', COUNTING_CHILD, self.counts_path]
               if counts else
               [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm'])
        self.lines = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd + list(argv), cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        timer = threading.Timer(timeout, self.proc.kill)
        timer.start()
        try:
            with open(os.path.join(root, f'{name}.log'), 'w') as log:
                for line in self.proc.stdout:
                    t = time.perf_counter() - self.t0
                    self.lines.append((t, line.rstrip('\n')))
                    log.write(f'{t:9.3f} {line}')
                    if on_line is not None:
                        on_line(line, self)
            self.rc = self.proc.wait()
            self.seconds = time.perf_counter() - self.t0
        finally:
            timer.cancel()
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.out = '\n'.join(l for _, l in self.lines)
        self.counts = None
        if counts and os.path.exists(self.counts_path):
            with open(self.counts_path) as f:
                self.counts = json.load(f)

    def first(self, prefix, has=''):
        """(seconds, line) of the first line starting with `prefix` and
        holding `has`."""
        return next(((t, l) for t, l in self.lines
                     if l.startswith(prefix) and has in l), (None, None))

    def logged_steps(self):
        return [int(l.split()[1].split('/')[0]) for _, l in self.lines
                if l.startswith('step ') and ' loss=' in l]

    def tail(self, n=30):
        return '\n'.join(l for _, l in self.lines[-n:])


def ckpt_steps(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit())


def guarded_step_cost(fk, card):
    """(d) The trainer API at Llama-3-8B width, 4 layers, B=8 S=2048:
    guarded against unguarded step time and peak memory in turns; a
    poisoned step leaves params and moments as they were, bit for bit;
    the next good step equals an unguarded step from the same state on
    the same batch. Returns the flash launches of its steps."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.parallel import train
    layers, batch, seq = 4, 8, 2048
    cfg = dataclasses.replace(registry.train_config('llama3-8b', seq),
                              num_layers=layers)
    model = convert.init_params(cfg, seed=0, device='cuda')
    # lr stays above 0 through every step taken here.
    tx = train.default_optimizer(warmup_steps=10, total_steps=100)
    plain = train.ShardedTrainer(model, tx=tx, collect_grad_norm=True)
    guarded = train.ShardedTrainer(model, tx=tx, guard=True)
    state = plain.init()
    u_step, g_step = plain.make_train_step(), guarded.make_train_step()
    rng = np.random.default_rng(5)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
            .cuda() for _ in range(12)]
    times = {'unguarded': [], 'guarded': []}
    peaks = {'unguarded': 0.0, 'guarded': 0.0}
    zero_flash(fk)
    steps_run = 0
    for i, kind in enumerate(['unguarded', 'guarded'] +
                             ['unguarded', 'guarded', 'guarded',
                              'unguarded'] * 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind == 'guarded':
            state, (_, _, bad) = g_step(state, toks[i])
        else:
            state, _ = u_step(state, toks[i])
        torch.cuda.synchronize()
        steps_run += 1
        if i >= 2:          # the first of each kind warms up
            times[kind].append(time.perf_counter() - t0)
        peaks[kind] = max(peaks[kind],
                          torch.cuda.max_memory_allocated() / 1e9)
        check(kind != 'guarded' or not bad.item(), 'a good step was bad')

    # The train loop's shape: steps dispatched back to back, the guarded
    # ones observing the previous step's verdict while the next runs,
    # through pinned copies (train_lm) or through float() on the device
    # scalars (which waits for the step queued after them too).
    def loop(kind, n=3):
        pending = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tokens in toks[:n]:
            if kind == 'unguarded':
                u_step(state, tokens)
                continue
            _, aux = g_step(state, tokens)
            if pending is not None:
                vals = (pending.values() if kind == 'pinned'
                        else [float(x) for x in pending])
                check(not vals[2], 'a good step was bad')
            pending = train.HostScalars(*aux) if kind == 'pinned' else aux
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    loop_ms = {'unguarded': [], 'pinned': [], 'float': []}
    for kind in ('unguarded', 'pinned', 'float', 'float', 'pinned',
                 'unguarded'):
        loop_ms[kind].append(loop(kind))
        steps_run += 3

    leaves = train.trainable_leaves(state.params)
    tensors = leaves + state.opt_state['mu'] + state.opt_state['nu']
    t0 = time.perf_counter()
    snap = [t.to('cpu', copy=True) for t in tensors]
    snap_s = time.perf_counter() - t0
    count0, step0 = int(state.opt_state['count']), state.step
    good, poison = toks[10], toks[11]

    def restore():
        with torch.no_grad():
            for t, s in zip(tensors, snap):
                t.copy_(s)
        state.opt_state['count'].fill_(count0)
        state.step = step0

    def update_err(ref):
        """|params - ref| over |ref - snapshot| (Frobenius, all params),
        and the largest |params - ref|."""
        moved_sq = diff_sq = diff_max = 0.0
        for p, s0, r in zip(leaves, snap, ref):
            s0, r = s0.to('cuda'), r.to('cuda')
            moved_sq += (r - s0).double().square().sum().item()
            d = p - r
            diff_sq += d.double().square().sum().item()
            diff_max = max(diff_max, d.abs().max().item())
        return math.sqrt(diff_sq / moved_sq), diff_max

    # Two unguarded steps from the snapshot on the good batch: their
    # updates differ only by the backward's dQ atomics (each dQ sums in
    # f32 in another order, then rounds to bf16), the floor the guarded
    # step is held to.
    state, (loss_u, gnorm_u) = u_step(state, good)
    loss_u, gnorm_u = loss_u.item(), gnorm_u.item()
    after_u = [p.to('cpu', copy=True) for p in leaves]
    restore()
    state, _ = u_step(state, good)
    floor, floor_max = update_err(after_u)
    restore()
    # From the same snapshot, a poisoned guarded step, then the good
    # batch.
    state, (loss_p, gnorm_p, bad_p) = g_step(state, poison, math.inf,
                                             math.nan)
    loss_p, gnorm_p = loss_p.item(), gnorm_p.item()
    # Bit for bit: int32 views, so even a zero's sign must be kept.
    kept = all(torch.equal(t.view(torch.int32),
                           s.to('cuda').view(torch.int32))
               for t, s in zip(tensors, snap))
    check(bad_p.item() and kept and int(state.opt_state['count']) == count0
          and state.step == step0 + 1,
          f'poisoned step: bad={bad_p.item()} state kept={kept} count '
          f'{int(state.opt_state["count"])} (was {count0})')
    state, (loss_g, gnorm_g, bad_g) = g_step(state, good)
    loss_g, gnorm_g = loss_g.item(), gnorm_g.item()
    steps_run += 4
    err, err_max = update_err(after_u)
    check(not bad_g.item()
          and abs(loss_g - loss_u) <= TRAIN_TOL * abs(loss_u)
          and abs(gnorm_g - gnorm_u) <= TRAIN_TOL * abs(gnorm_u)
          and err <= 2 * floor,
          f'good step after a poisoned one: loss {loss_g} vs {loss_u}, '
          f'grad norm {gnorm_g} vs {gnorm_u}, update error {err} against '
          f'the unguarded floor {floor}')
    counts = flash_counts(fk)
    check(all(c == layers * steps_run for c in counts.values())
          and fk.plain_calls == 0, f'guarded step launches {counts}')
    # The optimizer update alone, device time, unguarded and guarded (a
    # good step), in turns: the guard's own cost, below the step's noise.
    grads = [torch.zeros_like(p) for p in leaves]
    good_flag = torch.zeros((), dtype=torch.bool, device='cuda')
    update_ms = {'unguarded': [], 'guarded': []}
    for kind in ('unguarded', 'guarded', 'guarded', 'unguarded'):
        flag = good_flag if kind == 'guarded' else None
        update_ms[kind].append(time_cold_ms(
            lambda: tx.update(leaves, grads, state.opt_state, bad=flag),
            iters=3, warmup=1))
    del grads
    u_ms = 1e3 * float(np.mean(times['unguarded']))
    g_ms = 1e3 * float(np.mean(times['guarded']))
    emit('train_guard_step', card=card, layers=layers, batch=batch, seq=seq,
         unguarded_step_ms=[1e3 * t for t in times['unguarded']],
         guarded_step_ms=[1e3 * t for t in times['guarded']],
         unguarded_ms=u_ms, guarded_ms=g_ms,
         guarded_over_unguarded=g_ms / u_ms, loop_step_ms=loop_ms,
         update_ms=update_ms,
         unguarded_peak_gb=peaks['unguarded'],
         guarded_peak_gb=peaks['guarded'],
         poisoned_loss=loss_p, poisoned_grad_norm=gnorm_p,
         poisoned_state_kept=kept, good_loss=loss_g, unguarded_loss=loss_u,
         good_grad_norm=gnorm_g, unguarded_grad_norm=gnorm_u,
         update_rel_err=err, update_max_diff=err_max,
         unguarded_floor_rel_err=floor, unguarded_floor_max_diff=floor_max,
         snapshot_s=snap_s,
         launches=counts)
    del model, plain, guarded, state, tensors, leaves, snap, after_u
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def write_token_shards(root, vocab, sizes, seed):
    """uint16 token shards (ids below min(vocab, 65536))."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        path = os.path.join(root, f'shard{i}.bin')
        rng.integers(0, min(vocab, 65536), n).astype(np.uint16).tofile(path)
        paths.append(path)
    return paths


def hf_and_native_run(fk, hf, data, card):
    """(e) + (f): `train_lm --init-from-hf` of a 2-layer Llama-3-8B-width
    checkpoint with --lora 16 at S=2048 over token shards (the native
    reader), --ckpt-interval 30 and --profile-steps 1:3. The f32 masters
    equal the file's bf16 tensors upcast; the first step's loss is the
    trainer API's on the same weights and batch; the native reader's
    batches equal the numpy route's; a cadence is fixed after the first
    window; the trace holds both flash kernels."""
    from skypilot_tpu_torch.data import token_loader
    from skypilot_tpu_torch.models import hf_import
    from skypilot_tpu_torch.observability.step_metrics import read_jsonl
    from skypilot_tpu_torch.parallel import train
    batch, seq, steps = 8, 2048, 6
    paths = sorted(os.path.join(data, f) for f in os.listdir(data))
    seq_kw = dict(batch=batch, seq=seq, shuffle=False)
    fast = token_loader.TokenLoader(paths, **seq_kw)
    plain = token_loader.TokenLoader(paths, use_native=False, **seq_kw)
    same = fast.native and all(
        np.array_equal(fast.next_batch(), plain.next_batch())
        for _ in range(12))
    fast.close()
    check(same, 'native reader: batches differ from the numpy route '
          f'({token_loader.native_unavailable_reason()})')
    first = token_loader.TokenLoader(paths, batch=batch, seq=seq)
    tokens = torch.from_numpy(first.next_batch()[:, :-1].astype(np.int64))
    first.close()

    t0 = time.perf_counter()
    cfg, model = hf_import.load_hf_checkpoint(
        hf, max_seq_len=seq, device='cuda', param_dtype=torch.float32)
    load_s = time.perf_counter() - t0
    files = {}
    for name in os.listdir(hf):
        if name.endswith('.safetensors'):
            files.update(hf_import.read_safetensors(os.path.join(hf, name)))
    ours = dict(model.state_dict())
    masters = (len(ours) == len(files) and all(
        v.dtype == torch.float32 for v in ours.values()))
    names = {'tok_embed': 'model.embed_tokens.weight',
             'lm_head': 'lm_head.weight', 'final_norm.scale':
             'model.norm.weight'}
    for i in range(cfg.num_layers):
        names[f'layers.{i}.attn.wq.weight'] = \
            f'model.layers.{i}.self_attn.q_proj.weight'
        names[f'layers.{i}.mlp.w_down.weight'] = \
            f'model.layers.{i}.mlp.down_proj.weight'
        names[f'layers.{i}.attn_norm.scale'] = \
            f'model.layers.{i}.input_layernorm.weight'
    masters = masters and all(
        files[theirs].dtype == torch.bfloat16
        and torch.equal(ours[k], files[theirs].float().cuda())
        for k, theirs in names.items())
    check(masters, '--init-from-hf: f32 masters differ from the checkpoint')
    with torch.no_grad():
        api_loss = train.ShardedTrainer(model)._compute_loss(
            dict(model.named_parameters()), tokens.cuda()).item()
    del model, ours, files
    gc.collect()
    torch.cuda.empty_cache()

    root = os.path.join(WORK, 'train_guard', 'hf_run')
    shutil.rmtree(root, ignore_errors=True)
    metrics, prof = os.path.join(root, 'steps.jsonl'), os.path.join(root,
                                                                    'prof')
    child = Child('hf_native', [
        '--init-from-hf', hf, '--lora', '16', '--seq', str(seq),
        '--global-batch', str(batch), '--steps', str(steps), '--log-every',
        '1', '--data', data, '--ckpt-dir', os.path.join(root, 'ckpt'),
        '--ckpt-interval', '30', '--profile', prof, '--profile-steps', '1:3',
        '--metrics-file', metrics], counts=True)
    check(child.rc == 0 and 'training done' in child.out,
          f'--init-from-hf run rc {child.rc}:\n{child.tail()}')
    _, reader = child.first('data: ')
    _, cadence = child.first('ckpt cadence: ')
    check(reader is not None and 'native reader' in reader,
          f'the run did not read through the native reader: {reader}')
    check(cadence is not None, 'no checkpoint cadence was fixed')
    records = read_jsonl(metrics)
    loss1 = records[0]['loss']
    check(abs(loss1 - api_loss) <= TRAIN_TOL * abs(api_loss),
          f'first step loss {loss1} vs the trainer API\'s {api_loss}')
    with open(os.path.join(root, 'ckpt', 'adapter',
                           'adapter_config.json')) as f:
        base_model = json.load(f)['base_model']
    check(base_model == hf, f'adapter base_model {base_model}')
    traces = os.listdir(prof)
    trace_bytes = os.path.getsize(os.path.join(prof, traces[0]))
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)['traceEvents']
    # Kernel names may carry '(anonymous namespace)::' and a signature.
    kernels = {k: sum(1 for ev in events if ev.get('cat') == 'kernel'
                      and k in ev.get('name', ''))
               for k in ('flash_fwd_bf16', 'flash_bwd_bf16')}
    check(len(traces) == 1 and all(n == 2 * 2 for n in kernels.values()),
          f'profile trace {traces}: flash kernel events {kernels} (want 4 '
          f'each: 2 layers x steps 1..2)')
    counts = child.counts
    check(counts == {'flash_fwd': 2 * steps, 'flash_bwd': 2 * steps,
                     'plain_calls': 0}, f'--init-from-hf launches {counts}')
    step_s = [r['step_time_s'] for r in records]
    emit('train_guard_hf', card=card, layers=2, lora_rank=16, batch=batch,
         seq=seq, hf_load_s=load_s, masters_equal=masters,
         first_loss=loss1, trainer_api_loss=api_loss, reader=reader,
         native_equals_numpy=same, cadence=cadence,
         step_time_s=step_s, profiled_steps=[2, 3],
         profiled_over_unprofiled=float(np.mean(step_s[1:3])
                                        / np.mean(step_s[3:])),
         trace_bytes=trace_bytes, trace_kernel_events=kernels,
         run_s=child.seconds, launches=counts)
    shutil.rmtree(prof, ignore_errors=True)
    return {k: counts[k] for k in ('flash_fwd', 'flash_bwd')}


def sigterm_run(hf, card):
    """(b) SIGTERM after the first logged step: exit 83 with a checkpoint
    at the step in flight."""
    root = os.path.join(WORK, 'train_guard', 'sigterm')
    shutil.rmtree(root, ignore_errors=True)
    sent = {}

    def on_line(line, child):
        if line.startswith('step 1/') and not sent:
            sent['t'] = time.perf_counter() - child.t0
            child.proc.send_signal(signal.SIGTERM)

    child = Child('sigterm', [
        '--init-from-hf', hf, '--lora', '16', '--seq', '2048',
        '--global-batch', '8', '--steps', '50', '--log-every', '1',
        '--guard', '--ckpt-dir', os.path.join(root, 'ckpt'),
        '--ckpt-every', '1000'], on_line=on_line)
    t_notice, notice = child.first('preemption notice')
    check(child.rc == 83 and notice is not None
          and 'notice (sigterm) at step ' in notice,
          f'SIGTERM run rc {child.rc}:\n{child.tail()}')
    at = int(notice.split('at step ')[1].split(':')[0])
    logged = child.logged_steps()
    saved = ckpt_steps(os.path.join(root, 'ckpt'))
    check(logged[-1] == at and saved == [at],
          f'SIGTERM: notice at step {at}, logged {logged}, saved {saved}')
    emit('train_guard_sigterm', card=card, layers=2, notice_step=at,
         logged_steps=logged, saved_steps=saved,
         signal_to_exit_s=child.seconds - sent['t'],
         notice_to_exit_s=child.seconds - t_notice)


def watchdog_run(hf, card):
    """(c) A stalled batch fetch with --watchdog-deadline 5: exit 84
    within the deadline plus 10 s, the dump naming next_tokens."""
    deadline = 5.0
    child = Child('watchdog', [
        '--init-from-hf', hf, '--lora', '16', '--seq', '2048',
        '--global-batch', '8', '--steps', '10', '--log-every', '1',
        '--guard', '--watchdog-deadline', str(deadline)],
        plan={'rules': [{'point': 'train.data_next', 'action': 'delay',
                         'delay_s': 300.0, 'after': 2, 'times': 1}]})
    t_last, _ = child.first('step 2/')
    check(child.rc == 84 and t_last is not None
          and "step-watchdog: phase 'data' stalled" in child.out
          and 'next_tokens' in child.out,
          f'watchdog run rc {child.rc}:\n{child.tail()}')
    stalled_s = child.seconds - t_last
    check(stalled_s <= deadline + 10.0,
          f'watchdog exit {stalled_s:.1f}s after the last step')
    emit('train_guard_watchdog', card=card, layers=2, deadline_s=deadline,
         last_step_to_exit_s=stalled_s)


def chaos_run(hf, card):
    """(a) `train_lm --init-from-hf <2-layer Llama-3-8B width> --lora 16
    --seq 2048 --remat --guard` under a plan with NaN at the 5th-7th
    steps and a notice, both scoped to the first launch (resume 0), and
    every batch fetch CHAOS_PACE_S late, so that the notice, fired by
    the one-second poller, falls after the rollback and before the last
    step: three skips, a rollback to step 4, exit 83 with a fresh
    checkpoint; the same command relaunched resumes there and
    finishes."""
    from skypilot_tpu_torch.observability.step_metrics import read_jsonl
    root = os.path.join(WORK, 'train_guard', 'chaos')
    shutil.rmtree(root, ignore_errors=True)
    ckpt, metrics = os.path.join(root, 'ckpt'), os.path.join(root,
                                                             'steps.jsonl')
    steps, layers = CHAOS_STEPS, 2
    plan = {'seed': 2026, 'rules': [
        {'point': 'train.step', 'action': 'drop', 'at': [5, 6, 7],
         'scope': {'resume': '0'}},
        {'point': 'train.data_next', 'action': 'delay',
         'delay_s': CHAOS_PACE_S},
        {'point': 'train.preempt_notice', 'action': 'drop',
         'scope': {'resume': '0'}, 'after': CHAOS_NOTICE_POLLS}]}
    argv = ['--init-from-hf', hf, '--lora', '16', '--seq', '2048',
            '--global-batch', '8', '--remat', '--guard', '--guard-warmup',
            '1', '--rollback-after', '3', '--preempt-poll', '1',
            '--ckpt-dir', ckpt, '--ckpt-every', '4', '--log-every', '1',
            '--metrics-file', metrics, '--steps', str(steps)]
    first = Child('chaos', argv, plan=plan, counts=True)
    t_back, _ = first.first('train-guard: rolled back to last checkpoint '
                            '(step 4)')
    t_notice, notice = first.first('preemption notice (injected) at step ')
    check(first.rc == 83 and first.out.count('injected NaN into step') == 3
          and t_back is not None and t_notice is not None
          and t_notice > t_back,
          f'chaos run rc {first.rc}:\n{first.tail(40)}')
    at = int(notice.split('at step ')[1].split(':')[0])
    logged = first.logged_steps()
    # The last step logged since the rollback rewound to step 4: the
    # notice may cost at most the one step in flight.
    last = max([int(l.split()[1].split('/')[0]) for t, l in first.lines
                if t > t_back and l.startswith('step ')] or [4])
    check(at in ckpt_steps(ckpt) and last - 1 <= at <= last,
          f'chaos: notice at {at}, logged {logged}, saved '
          f'{ckpt_steps(ckpt)}')
    second = Child('chaos_relaunch', argv, plan=plan, counts=True)
    t_first_step, _ = second.first('step ', has=' loss=')
    relogged = second.logged_steps()
    check(second.rc == 0 and f'resumed from checkpoint step {at}'
          in second.out and relogged[0] == at + 1
          and relogged[-1] == steps and 'injected NaN' not in second.out,
          f'chaos relaunch rc {second.rc}:\n{second.tail()}')
    records = read_jsonl(metrics)
    poisoned = [i for i, r in enumerate(records)
                if not math.isfinite(r['loss'])]
    after = records[poisoned[-1] + 1:] if poisoned else []
    check(len(poisoned) == 3 and after
          and all(math.isfinite(r['loss']) for r in after),
          f'losses around the poisoned streak: '
          f'{[r["loss"] for r in records]}')
    # Every dispatched step logs a line but the one each rollback drops.
    runs = len(logged) + 1 + len(relogged)
    want = {'flash_fwd': layers * runs * 2, 'flash_bwd': layers * runs}
    counts = {k: first.counts[k] + second.counts[k] for k in want}
    check(counts == want and first.counts['plain_calls'] == 0
          and second.counts['plain_calls'] == 0,
          f'chaos launches {counts}, want {want}')
    saves = {4 * k for k in range(1, steps // 4 + 1)}
    plain_steps = [r['step_time_s'] for r in records
                   if r['step'] not in saves and r['step'] > 1
                   and math.isfinite(r['loss'])]
    emit('train_guard_chaos', card=card, layers=layers, lora_rank=16,
         batch=8, seq=2048, remat=True, steps=steps,
         reduced={'num_layers': [32, layers]},
         batch_fetch_delay_s=CHAOS_PACE_S,
         notice_after_polls=CHAOS_NOTICE_POLLS,
         rollback_s=t_back, notice_s=t_notice, notice_step=at,
         logged_first=logged, logged_relaunch=relogged,
         notice_to_exit_s=first.seconds - t_notice,
         relaunch_to_first_step_s=t_first_step,
         paced_step_s=plain_steps,
         paced_step_s_median=float(np.median(plain_steps)),
         first_run_s=first.seconds, relaunch_s=second.seconds,
         launches=counts)
    return counts


def phase_train_guard(fk, card):
    """The recovery contract of train_lm on the card: (d) the guarded
    step at the trainer API; a 2-layer Llama-3-8B-width HF checkpoint and
    token shards, then (e)+(f), (b) and (c) as train_lm processes on
    them; (a) the chaos run and its relaunch on the same checkpoint.
    Returns the flash launches of the phase's main-path steps."""
    from skypilot_tpu_torch.models import convert, registry
    gc.collect()
    torch.cuda.empty_cache()
    # What this process holds on the card while the children run.
    emit('train_guard_parent', card=card,
         allocated_gb=torch.cuda.memory_allocated() / 1e9,
         reserved_gb=torch.cuda.memory_reserved() / 1e9)
    counts = guarded_step_cost(fk, card)
    root = os.path.join(WORK, 'train_guard')
    hf, data = os.path.join(root, 'hf_llama'), os.path.join(root, 'tokens')
    shutil.rmtree(hf, ignore_errors=True)
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 2048),
                              num_layers=2)
    model = convert.init_params(cfg, seed=5, device='cuda')
    write_hf_checkpoint(hf, model)
    del model
    torch.cuda.empty_cache()
    write_token_shards(data, cfg.vocab_size, (150_000, 90_001), seed=6)
    try:
        hf_counts = hf_and_native_run(fk, hf, data, card)
        sigterm_run(hf, card)
        watchdog_run(hf, card)
        chaos_counts = chaos_run(hf, card)
    finally:
        shutil.rmtree(hf, ignore_errors=True)
    return {k: counts[k] + hf_counts[k] + chaos_counts[k] for k in counts}


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


def route_key(route, n, k):
    """int8_linear's launch key (route, out, in) as a JSON key."""
    return f'{route} {n}x{k}'


def route_shape_delta(kernel, before):
    """A kernel module's `launches_by_route` since `before`, keyed by
    `route_key` (empty for modules that count no (route, shape))."""
    return {route_key(*key): n - before.get(key, 0)
            for key, n in sorted(getattr(kernel, 'launches_by_route',
                                         {}).items())
            if n > before.get(key, 0)}


def burst(rt, port, ps, models, kernels):
    """8 concurrent greedy /generate requests of 32 new tokens (request
    i under `models[i]`, None = the base model), after a warm-up
    request. Returns the serve_* numbers and each kernel module's
    launch and plain-call deltas over the burst."""
    post(port, '/generate', {'tokens': [ps[0][:64]], 'max_new_tokens': 2})
    rt.metrics = type(rt.metrics)()
    counts0 = [(k.launches, k.plain_calls) for k in kernels]
    by_rows0 = [dict(getattr(k, 'launches_by_rows', {})) for k in kernels]
    by_route0 = [dict(getattr(k, 'launches_by_route', {})) for k in kernels]
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
        'ttft_p50_s': metrics['ttft_ms_p50'] / 1e3,
        'ttft_max_s': max(rt.metrics.ttft_ms) / 1e3,
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
                   for k, (l0, p0) in zip(kernels, counts0)],
        'launches_by_rows': [
            {m: n - r0.get(m, 0) for m, n in sorted(
                getattr(k, 'launches_by_rows', {}).items())
             if n > r0.get(m, 0)}
            for k, r0 in zip(kernels, by_rows0)],
        'launches_by_route': [route_shape_delta(k, r0)
                              for k, r0 in zip(kernels, by_route0)]}


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


# serve_lora's request mix (None = the base model).
SERVE_LORA_MODELS = ['attn8', 'attn16', None, 'mlp16', None, 'attn8',
                     'mlp16', 'attn16']


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
        models = SERVE_LORA_MODELS
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


# -- int8 projection weights -------------------------------------------------
# The reference's contract (tests/unit_tests/test_quantized_serving.py:42):
# a quantized greedy continuation's mean per-token log-prob, scored by the
# unquantized model, within this of the unquantized model's own. Here it
# holds the kernel route to the dequantize route (the reference's own
# arithmetic, `route_scope('torch')`), pooled over a burst's tokens; the
# int8-vs-bf16 numbers of the reference's form are reported beside it
# with their noise floors (bf16 run again on other prefill chunks, and
# int8 KV pages under the same tolerance).
INT8_LOGPROB_TOL = 0.1
# Parameters of Llama-3-8B's seven projections (32 layers): what int8
# storage saves one byte of, each.
LLAMA3_8B_PROJ_PARAMS = 6.98e9


def int8_model(model):
    """The int8 model of `model`'s seed: projections quantized from that
    seed's f32 draws (`init_params(weight_dtype='int8')`); its embedding,
    norms and head ARE `model`'s tensors (no copy), after checking that
    the seed drew them alike."""
    from skypilot_tpu_torch.models import convert
    drawn = convert.init_params(model.config, seed=0, device='cuda',
                                weight_dtype='int8')
    dense = model.state_dict()
    state = {}
    for key, t in drawn.state_dict().items():
        if key.endswith(('.weight_q', '.weight_scale')):
            state[key] = t
        else:
            check(torch.equal(t, dense[key]),
                  f'{key}: the int8 draw differs from the bf16 model\'s')
            state[key] = dense[key]
    del drawn, t
    return convert.assemble(model.config, state)


def tensor_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def mean_logprob(rt, row, n_prompt):
    """Mean log-prob of row[n_prompt:] under rt's scoring pass (the
    /v1/completions echo + logprobs quantity)."""
    chosen, _, _ = rt.score_logprobs(list(row))
    return float(np.mean(chosen[n_prompt - 1:]))


def adapter_scorer(model, root, name):
    """The scoring pass of `model` with adapter `name` (its factors
    applied in single-adapter mode): row, n_prompt -> mean log-prob of
    row[n_prompt:]."""
    from skypilot_tpu_torch.models import lora
    config, params = lora.load_adapter(os.path.join(root, name))
    factors = lora.as_model_lora(
        {ln: {t: {k: torch.tensor(v, device='cuda') for k, v in f.items()}
              for t, f in layer.items()} for ln, layer in params.items()},
        lora.load_spec(config).scale)

    def score(row, n_prompt):
        tokens = torch.tensor([list(row)], device='cuda')
        with torch.no_grad():
            lp = torch.log_softmax(model(tokens, lora=factors).float(),
                                   dim=-1)[0]
        nxt = tokens[0, n_prompt:, None]
        return lp[n_prompt - 1:-1].gather(-1, nxt).mean().item()

    return score


def int8_burst_gates(label, out, plain_route=False):
    """The kernel gates of one int8-weight burst; returns its counts.
    On the dequantize route int8_linear must never launch."""
    (pa, pa_plain), (lo, lo_plain), (i8, i8_plain) = out.pop('counts')
    routes = out['paged_route_launches']
    if plain_route:
        check(i8 == 0 and i8_plain > 0,
              f'{label}: int8_linear launched {i8} times, {i8_plain} plain')
    else:
        check(i8 > 0 and i8_plain == 0,
              f'{label}: int8_linear launched {i8} times, {i8_plain} plain '
              f'calls')
    check(routes['split'] > 0 and routes['chunk'] > 0 and pa_plain == 0,
          f'{label}: paged routes {routes}, {pa_plain} plain calls')
    check(out['graph_replays'] > 0, f'{label}: no graph replay')
    return {'int8_linear_launches': i8, 'int8_linear_plain_calls': i8_plain,
            'paged_launches': pa, 'paged_plain_calls': pa_plain,
            'lora_launches': lo, 'lora_plain_calls': lo_plain}


def steady_turn(rt, port, ps):
    """(steady decode round ms, rows) of the 8 prompts, 32 greedy tokens
    each, base model, tracing off."""
    from skypilot_tpu_torch.observability import tracing
    tracing.configure(sample=0.0)
    s0 = rt.engine.stats()
    rows = concurrently(lambda i: post(port, '/generate', {
        'tokens': [ps[i]], 'max_new_tokens': 32})['tokens'][0], len(ps))
    s1 = rt.engine.stats()
    rounds = s1['steady_decode_rounds'] - s0['steady_decode_rounds']
    return 1e3 * (s1['steady_decode_s'] - s0['steady_decode_s']) / rounds, \
        rows


def contract_summary(scores, against):
    """Per-run mean log-prob over the burst and its least per-request
    difference from run `against`'s."""
    return {label: {'mean': float(np.mean(v)),
                    'mean_diff': float(np.mean(v) - np.mean(scores[against])),
                    'min_request_diff': float(min(
                        a - b for a, b in zip(v, scores[against])))}
            for label, v in scores.items()}


def phase_serve_int8_weights(model, pk, lk, il, card):
    """serve_lm --weight-dtype int8 at Llama-3-8B width: (a) the 8-prompt
    burst on a bf16 and an int8 pool, (b) serve_lora's adapters and mix
    on the int8 base; each beside the same burst through the dequantize
    route and on bf16 weights, all scored by the bf16 model; steady
    round ms of bf16 weights, int8 through the kernel and int8 through
    the dequantize route in turns."""
    t_phase = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model_q = int8_model(model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    int8_alloc = torch.cuda.memory_allocated() - mem0
    ps = prompts()
    pool = ['--kv-pool-bytes', '4000000000']
    int8_flag = ['--weight-dtype', 'int8']
    kernels = (pk, lk, il)
    rows, outs = {}, {}
    rt_b, srv_b, th_b, port_b, _ = serve_runtime(model, 'bf16', pool)
    try:
        rt_q, srv_q, th_q, port_q, setup_q = serve_runtime(
            model_q, 'bf16', [*int8_flag, *pool])
        with il.route_scope('torch'):    # graphs captured on the plain route
            rt_d, srv_d, th_d, port_d, _ = serve_runtime(
                model_q, 'bf16', [*int8_flag, *pool])
        try:
            rows['int8'], outs['int8'] = burst(rt_q, port_q, ps, [None] * 8,
                                               kernels)
            with il.route_scope('torch'):
                rows['int8_dequant'], outs['int8_dequant'] = burst(
                    rt_d, port_d, ps, [None] * 8, kernels)
            rows['bf16'], outs['bf16'] = burst(rt_b, port_b, ps, [None] * 8,
                                               kernels)
            turns = []
            for label, rt, port in (('bf16', rt_b, port_b),
                                    ('int8', rt_q, port_q),
                                    ('int8_dequant', rt_d, port_d),
                                    ('int8_dequant', rt_d, port_d),
                                    ('int8', rt_q, port_q),
                                    ('bf16', rt_b, port_b)):
                scope = (il.route_scope('torch') if label == 'int8_dequant'
                         else contextlib.nullcontext())
                with scope:
                    ms, turn_rows = steady_turn(rt, port, ps)
                turns.append([label, ms])
                # bf16 again on other prefill chunks (its prefixes are
                # cached now): the contract's bf16 noise floor.
                rows.setdefault('bf16_again', turn_rows)
            stats_q = json.loads(get_raw(port_q, '/stats'))
            weight_bytes = {'bf16': rt_b.weight_bytes,
                            'int8': rt_q.weight_bytes}
        finally:
            stop_runtime(rt_d, srv_d, th_d)
            stop_runtime(rt_q, srv_q, th_q)
        for label, m, kv, extra in (
                ('int8_int8_pool', model_q, 'int8', int8_flag),
                ('bf16_int8_pool', model, 'int8', [])):
            rt, srv, th, port, _ = serve_runtime(m, kv, extra)
            try:
                rows[label], outs[label] = burst(rt, port, ps, [None] * 8,
                                                 kernels)
            finally:
                stop_runtime(rt, srv, th)
        scores = {label: [mean_logprob(rt_b, r, len(p))
                          for r, p in zip(rs, ps)]
                  for label, rs in rows.items()}
    finally:
        stop_runtime(rt_b, srv_b, th_b)
    counts = {'int8': int8_burst_gates('int8 weights, bf16 pool',
                                       outs['int8']),
              'int8_int8_pool': int8_burst_gates('int8 weights, int8 pool',
                                                 outs['int8_int8_pool']),
              'int8_dequant': int8_burst_gates(
                  'int8 weights, dequantize route', outs['int8_dequant'],
                  plain_route=True)}
    for label in ('bf16', 'bf16_int8_pool'):
        outs[label].pop('counts')
    contract = contract_summary(scores, 'int8_dequant')
    for label in ('int8', 'int8_int8_pool'):
        check(contract[label]['mean_diff'] >= -INT8_LOGPROB_TOL,
              f'{label}: mean log-prob {contract[label]} against the '
              f'dequantize route (tolerance {INT8_LOGPROB_TOL})')
    reference_form = contract_summary(scores, 'bf16')
    check(stats_q['storage']['weight_dtype'] == 'int8',
          f'/stats storage {stats_q["storage"]}')
    want = weight_bytes['bf16'] - LLAMA3_8B_PROJ_PARAMS
    check(abs(stats_q['storage']['weight_bytes'] - want) <= 0.01 * want
          and stats_q['storage']['weight_bytes'] == tensor_bytes(model_q),
          f'/stats weight_bytes {stats_q["storage"]["weight_bytes"]}: want '
          f'~{want} and {tensor_bytes(model_q)}')

    # (b) serve_lora's adapters and request mix on the int8 base (kernel
    # and dequantize routes), then on the bf16 base, whose scoring pass
    # (with each request's adapter) scores all three.
    root = os.path.join(WORK, 'adapters')
    lora_flags = ['--adapter-dir', root, '--max-adapters', '3']
    models = SERVE_LORA_MODELS
    lora_rows = {}
    for label in ('int8', 'int8_dequant'):
        plain_route = label == 'int8_dequant'
        with (il.route_scope('torch') if plain_route
              else contextlib.nullcontext()):
            rt, srv, th, port, _ = serve_runtime(
                model_q, 'bf16', [*int8_flag, *lora_flags])
            try:
                lora_rows[label], out = burst(rt, port, ps, models, kernels)
            finally:
                stop_runtime(rt, srv, th)
        counts[f'adapters_{label}'] = int8_burst_gates(
            f'int8 weights with adapters ({label})', out,
            plain_route=plain_route)
        outs[f'adapters_{label}'] = out
    check(counts['adapters_int8']['lora_launches'] > 0 and
          counts['adapters_int8']['lora_plain_calls'] == 0,
          f'int8 weights with adapters: QKV LoRA {counts["adapters_int8"]}')
    rt_a, srv_a, th_a, port_a, _ = serve_runtime(model, 'bf16', lora_flags)
    try:
        lora_rows['bf16'], outs['adapters_bf16'] = burst(
            rt_a, port_a, ps, models, kernels)
        base = [i for i, m in enumerate(models) if m is None]
        lora_scores = {label: {i: mean_logprob(rt_a, r[i], len(ps[i]))
                               for i in base}
                       for label, r in lora_rows.items()}
    finally:
        stop_runtime(rt_a, srv_a, th_a)
    outs['adapters_bf16'].pop('counts')
    bites = {}
    for name in sorted({m for m in models if m is not None}):
        score = adapter_scorer(model, root, name)
        mine = [i for i, m in enumerate(models) if m == name]
        # The adapter bites: its answers are not the int8 base's answers
        # to the same prompts.
        bites[name] = [lora_rows['int8'][i] != rows['int8'][i]
                       for i in mine]
        check(any(bites[name]), f'adapter {name} changed none of the int8 '
                                f'base\'s answers {mine}')
        for label, r in lora_rows.items():
            for i in mine:
                lora_scores[label][i] = score(r[i], len(ps[i]))
        del score
    lora_scores = {label: [v[i] for i in range(len(models))]
                   for label, v in lora_scores.items()}
    lora_contract = contract_summary(lora_scores, 'int8_dequant')
    check(lora_contract['int8']['mean_diff'] >= -INT8_LOGPROB_TOL,
          f'adapters: mean log-prob {lora_contract["int8"]} against the '
          f'dequantize route (tolerance {INT8_LOGPROB_TOL})')
    lora_reference_form = contract_summary(lora_scores, 'bf16')
    del model_q
    gc.collect()
    torch.cuda.empty_cache()
    emit('serve_int8_weights', card=card, build_s=build_s,
         int8_alloc_bytes=int8_alloc, weight_bytes=weight_bytes,
         weight_bytes_saved=weight_bytes['bf16'] - weight_bytes['int8'],
         setup_s=setup_q, stats_storage=stats_q['storage'], bursts=outs,
         counts=counts, logprob_tolerance=INT8_LOGPROB_TOL,
         contract_vs_dequantize=contract,
         reference_form_vs_bf16=reference_form,
         scores=scores, adapters_contract_vs_dequantize=lora_contract,
         adapters_reference_form_vs_bf16=lora_reference_form,
         adapter_scores=lora_scores, adapter_changes_answer=bites,
         steady_round_ms_turns=turns,
         phase_s=time.perf_counter() - t_phase)


# -- observability -----------------------------------------------------------
OBS_PLAN = {'seed': 0, 'rules': [
    {'point': 'engine.decode_step', 'at': [5]},
    {'point': 'engine.device_get', 'action': 'delay', 'delay_s': 0.02,
     'at': [9]},
    {'point': 'adapters.load', 'at': [1]}]}
OBS_SLO = 'p99_ttft_ms=5000,p99_itl_ms=500,error_rate=0.05'
OBS_FLAGS = ('--trace-sample', '1.0', '--trace-seed', '0', '--slo', OBS_SLO,
             '--fault-plan', json.dumps(OBS_PLAN))
# The trace header the phase makes up for request OBS_TRACED.
OBS_TRACE_ID, OBS_TRACE_PARENT, OBS_TRACED = '00c0ffee00c0ffee', 'feedbeef', 2
# /stats keys of the reference's body that C4 repaired.
C4_KEYS = ('serving', 'storage', 'page_pool', 'pid', 'num_slots',
           'active_slots', 'preemptions', 'deadline_exceeded',
           'engine_restarts', 'queued_tokens', 'max_queue_requests',
           'max_queue_tokens', 'prefill_token_budget', 'pipeline_stages',
           'prefill_bubble_fraction', 'attention_impl',
           'attention_bytes_per_token')
# The first adapter load fails (the plan's adapters.load rule): this
# request alone, before the burst; its prompt shares nothing cached.
OBS_FAILED_LOAD = 'attn8'


def get_raw(port, path, timeout=60):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                timeout=timeout) as resp:
        return resp.read()


def post_with(port, path, body, headers=None, timeout=600):
    """(status, JSON body) of a POST, HTTP errors included."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def parse_exposition(text):
    """{sample (name + labels): value} of a text exposition 0.0.4 body;
    fails the run on a line that does not parse."""
    samples, typed = {}, set()
    for line in text.splitlines():
        if line.startswith('# HELP '):
            check(len(line.split(' ', 3)) == 4, f'bad HELP line {line!r}')
            continue
        if line.startswith('# TYPE '):
            parts = line.split(' ')
            check(len(parts) == 4 and parts[3] in (
                'counter', 'gauge', 'histogram', 'untyped'),
                f'bad TYPE line {line!r}')
            typed.add(parts[2])
            continue
        head, _, value = line.rpartition(' ')
        name = head.partition('{')[0]
        check(head and (name in typed or name.rpartition('_')[0] in typed)
              and (head.count('{') == head.count('}') <= 1),
              f'bad sample line {line!r}')
        samples[head] = float(value)
    return samples


def obs_burst(port, ps, headers_for=None):
    """The 8 prompts as concurrent greedy /generate requests of 32 new
    tokens under LORA_MODELS: [(status, tokens)]."""
    def one(i):
        body = {'tokens': [ps[i]], 'max_new_tokens': 32, 'temperature': 0.0}
        if LORA_MODELS[i] is not None:
            body['model'] = LORA_MODELS[i]
        code, out = post_with(port, '/generate', body,
                              headers=(headers_for or {}).get(i))
        return code, out.get('tokens', [None])[0]
    return concurrently(one, len(ps))


def wait_engine_idle(eng, tries=200):
    """Return once the engine's scheduler has no round in flight and no
    active slot. The probe runs as a control op, at the top of an
    iteration, so every earlier round has been observed and recorded."""
    for _ in range(tries):
        if eng.run_on_scheduler(
                lambda: not eng._in_flight() and not eng.active.any()):
            return
    raise AssertionError(f'engine not idle after {tries} iterations')


def steady_round_ms(rt, port, ps, sample):
    """Steady decode round ms (rounds with no prefill queued) over a
    burst of the 8 prompts, base model, with tracing at `sample`."""
    from skypilot_tpu_torch.observability import tracing
    tracing.configure(sample=sample)
    s0 = rt.engine.stats()
    concurrently(lambda i: post(port, '/generate', {
        'tokens': [ps[i]], 'max_new_tokens': 32}), len(ps))
    s1 = rt.engine.stats()
    rounds = s1['steady_decode_rounds'] - s0['steady_decode_rounds']
    return 1e3 * (s1['steady_decode_s'] - s0['steady_decode_s']) / rounds


def escalation(card):
    """A 2-layer engine at Llama-3-8B width under engine.decode_step at
    hits 3, 4, 5: one reset, the batch failed with the injected error, a
    snapshot file with reason 'reset', engine_restarts 1 on /stats; the
    next request equals a fresh engine's tokens, from graph replays, on
    the same pool storage."""
    import glob
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import InferenceRuntime
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    from skypilot_tpu_torch.robustness import faults
    cfg = dataclasses.replace(registry.model_config('llama3-8b', 1024),
                              num_layers=2, kv_total_pages=600)
    model = convert.init_params(cfg, seed=1, device='cuda')
    ps = prompts(seed=5, n=4)
    kw = dict(num_slots=8, max_total_len=1024, prefill_chunk=256)
    fresh = ContinuousBatchingEngine(model, **kw)
    try:
        want = fresh.submit(ps[3], max_new_tokens=16).result(timeout=300)
    finally:
        fresh.stop()
    eng = ContinuousBatchingEngine(model, **kw)
    rt = InferenceRuntime(engine=eng, model_name='llama3-8b-2-layers')
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ptr = eng.cache.layers[0]['k_pages'].data_ptr()
    try:
        faults.install_plan({'rules': [
            {'point': 'engine.decode_step', 'at': [3, 4, 5]}]})
        futs = [eng.submit(p, max_new_tokens=16) for p in ps[:3]]
        errors = []
        for f in futs:
            try:
                f.result(timeout=300)
                errors.append(None)
            except Exception as e:  # pylint: disable=broad-except
                errors.append(f'{type(e).__name__}: {e}')
        faults.clear()
        replays0 = eng.stats()['graph_replays']
        code, after = post_with(port, '/generate', {
            'tokens': [ps[3]], 'max_new_tokens': 16})
        replays = eng.stats()['graph_replays'] - replays0
        stats = post_stats(port)
        events = eng.flight.events()
        snaps = glob.glob(os.path.join(os.environ['STPU_FLIGHT_DIR'],
                                       f'stpu-flight-{eng.flight.name}-*'
                                       f'-reset-*.json'))
        snap = json.load(open(snaps[0], encoding='utf-8')) if snaps else {}
        same_pool = eng.cache.layers[0]['k_pages'].data_ptr() == ptr
    finally:
        faults.clear()
        stop_runtime(rt, server, thread)
    resets = [e for e in events if e['kind'] == 'reset']
    softs = [e['strikes'] for e in events if e['kind'] == 'soft_error']
    check(softs == [1, 2, 3] and len(resets) == 1,
          f'escalation: soft strikes {softs}, {len(resets)} resets')
    check(all(e == 'InjectedFault: injected fault at engine.decode_step'
              for e in errors), f'escalation: futures gave {errors}')
    check(len(snaps) == 1 and snap.get('reason') == 'reset',
          f'escalation: snapshots {snaps}')
    check(stats['engine_restarts'] == 1,
          f'escalation: engine_restarts {stats["engine_restarts"]}')
    check(code == 200 and after['tokens'][0] == want,
          'escalation: the next request differs from a fresh engine')
    check(replays > 0 and same_pool,
          f'escalation: {replays} graph replays, same pool {same_pool}')
    return {'soft_strikes': softs, 'resets': len(resets),
            'failed_futures': len(errors), 'snapshot': os.path.basename(
                snaps[0]), 'engine_restarts': stats['engine_restarts'],
            'replays_after_reset': replays, 'same_pool_storage': same_pool}


def phase_observability(model, pk, lk, card):
    """serve_lora's weights, adapters and flags plus --trace-sample 1.0
    --trace-seed 0 --slo --fault-plan (a soft error at the 5th decode
    step, a 20 ms delay at the 9th token fetch, the first adapter load
    failing) against the same flags without the four: the same tokens
    on every request, the failed load answered 503 as the reference
    answers it and the next request to that adapter served; /stats'
    repaired keys and slo block, /debug/flight's one soft error and no
    reset, /metrics parsed line by line and agreeing with /stats, the
    made-up trace's spans linked to their parents; then the escalation
    (three strikes reset a 2-layer engine); cost lines: steady round ms
    with tracing off and on in turns, one scrape's ms, the phase's
    seconds."""
    from skypilot_tpu_torch.observability import tracing
    from skypilot_tpu_torch.robustness import faults
    t_phase = time.perf_counter()
    flight_dir = os.path.join(WORK, 'flight')
    shutil.rmtree(flight_dir, ignore_errors=True)
    os.makedirs(flight_dir)
    os.environ['STPU_FLIGHT_DIR'] = flight_dir
    root = os.path.join(WORK, 'adapters')
    flags = ['--adapter-dir', root, '--max-adapters', '3']
    ps = prompts()
    failed_prompt = ps[2][:64]
    # The same requests without the observability flags.
    rt, server, thread, port, _ = serve_runtime(model, 'bf16', flags)
    try:
        first = post_with(port, '/generate', {
            'tokens': [failed_prompt], 'max_new_tokens': 4,
            'model': OBS_FAILED_LOAD})
        plain = obs_burst(port, ps)
    finally:
        stop_runtime(rt, server, thread)
    headers = {OBS_TRACED: {'x-skypilot-trace':
                            f'{OBS_TRACE_ID}:{OBS_TRACE_PARENT}:1'}}
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    zero_paged(pk)
    rt, server, thread, port, setup_s = serve_runtime(
        model, 'bf16', flags + list(OBS_FLAGS))
    try:
        eng = rt.engine
        failed = post_with(port, '/generate', {
            'tokens': [failed_prompt], 'max_new_tokens': 4,
            'model': OBS_FAILED_LOAD})
        observed = obs_burst(port, ps, headers)
        # A pipelined engine commits its trailing round after the last
        # answer went out: read /stats, /debug/flight and /metrics only
        # once the scheduler is idle, so all three see the same rounds.
        wait_engine_idle(eng)
        launches, plain_calls = pk.launches, pk.plain_calls
        routes = dict(pk.route_launches)
        lora_launches, lora_plain = lk.launches, lk.plain_calls
        fired = faults.stats()
        stats = post_stats(port)
        flight = json.loads(get_raw(port, '/debug/flight'))
        t0 = time.perf_counter()
        text = get_raw(port, '/metrics').decode()
        first_scrape_ms = 1e3 * (time.perf_counter() - t0)
        v1_text = get_raw(port, '/v1/metrics').decode()
        trace = json.loads(get_raw(port, f'/debug/trace/{OBS_TRACE_ID}'))
        try:
            get_raw(port, '/debug/trace/deadbeef')
            unknown_trace = 200
        except urllib.error.HTTPError as e:
            unknown_trace = e.code
        faults.clear()
        # Cost: steady round ms with tracing off and on in turns, then
        # the ms of one scrape.
        turns = [(sample, steady_round_ms(rt, port, ps, sample))
                 for sample in (0.0, 1.0, 1.0, 0.0)]
        scrape_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            get_raw(port, '/metrics')
            scrape_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        faults.clear()
        tracing.reset()
        stop_runtime(rt, server, thread)
    # Tokens: every answer equals the unobserved runtime's.
    check(first[0] == 200, f'unobserved first adapter request: {first}')
    check(failed[0] == 503 and failed[1]['error'].startswith(
        'AdapterLoadError: loading adapter') and 'InjectedFault' in
        failed[1]['error'], f'the injected load failure answered {failed}')
    check(all(c == 200 for c, _ in observed + plain),
          f'observability burst codes {[c for c, _ in observed]}')
    for i, ((_, got), (_, want)) in enumerate(zip(observed, plain)):
        check(got == want, f'observability: request {i} ({LORA_MODELS[i]}) '
                           f'differs from the unobserved runtime')
    check(fired.get('engine.decode_step', {}).get('fired') == 1
          and fired.get('engine.device_get', {}).get('fired') == 1
          and fired.get('adapters.load', {}).get('fired') == 1,
          f'fault plan fired {fired}')
    # Kernels: the slice's path ran on them.
    check(routes['split'] > 0 and routes['chunk'] > 0
          and routes['scalar'] == 0 and plain_calls == 0
          and lora_launches > 0 and lora_plain == 0,
          f'observability: paged {routes}, {plain_calls} plain; LoRA '
          f'{lora_launches} launches, {lora_plain} plain')
    # /stats.
    missing = [k for k in C4_KEYS if k not in stats]
    check(not missing and stats['engine'] == 'continuous'
          and 'engine_stats' in stats, f'/stats lacks {missing}')
    check(stats['engine_restarts'] == 0, 'observability: engine reset')
    check(stats['attention_impl'] == 'cuda' and stats['storage'][
        'attention_kernel_unavailable_reason'] is None,
        f'attention_impl {stats["attention_impl"]}')
    check('slo' in stats and stats['slo']['targets'] == {
        'p99_ttft_ms': 5000.0, 'p99_itl_ms': 500.0, 'error_rate': 0.05},
        'no slo block')
    # /debug/flight.
    (dump,) = flight['engines']
    kinds = [e['kind'] for e in dump['events']]
    softs = [e for e in dump['events'] if e['kind'] == 'soft_error']
    check(dump['dropped'] == 0 and len(softs) == 1
          and softs[0]['strikes'] == 1 and 'reset' not in kinds
          and kinds.count('round_commit') > 0,
          f'flight: dropped {dump["dropped"]}, soft errors '
          f'{[e["strikes"] for e in softs]}, reset {"reset" in kinds}')
    # /metrics against /stats (this engine's labeled series).
    samples = parse_exposition(text)
    check(text == v1_text or len(parse_exposition(v1_text)) ==
          len(samples), '/v1/metrics differs')
    lab = f'{{engine="{eng.engine_id}"}}'
    check(samples[f'skypilot_serving_tokens_committed_total{lab}'] ==
          stats['tokens_committed'], 'tokens_committed_total != /stats')
    check(samples[f'skypilot_serving_decode_steps_total{lab}'] ==
          stats['decode_calls'], 'decode_steps_total != /stats')
    check(samples[f'skypilot_serving_decode_step_seconds_count{lab}'] ==
          kinds.count('round_commit'),
          'decode_step_seconds: not one sample a round ('
          f'{samples[f"skypilot_serving_decode_step_seconds_count{lab}"]}'
          f' samples, {kinds.count("round_commit")} round_commit events)')
    for name in ('attn8', 'attn16', 'mlp16'):
        check(samples.get('skypilot_serving_adapter_requests_total'
                          f'{{adapter="{name}"}}', 0) >= 2,
              f'adapter series of {name} missing')
    check(samples['skypilot_serving_adapter_load_failures_total'] >= 1,
          'adapter load failure not counted')
    # /debug/trace.
    events = trace['traceEvents']
    names = [e['name'] for e in events]
    ids = {e['args']['span_id'] for e in events}
    root_span = [e for e in events if e['name'] == 'replica.request']
    check(len(root_span) == 1 and root_span[0]['args']['parent_id'] ==
          OBS_TRACE_PARENT, 'trace: no replica.request under the header')
    check(names.count('engine.queue_wait') == 1
          and names.count('engine.admit') == 1
          and names.count('engine.prefill_chunk') >= 1
          and names.count('engine.decode_round') >= 31,
          f'trace spans: {sorted(set(names))}, '
          f'{names.count("engine.decode_round")} decode rounds')
    check(all(e['args']['trace_id'] == OBS_TRACE_ID and
              e['args']['parent_id'] in ids | {OBS_TRACE_PARENT}
              for e in events), 'trace: a span without its parent')
    check(unknown_trace == 404, f'unknown trace answered {unknown_trace}')
    esc = escalation(card)
    del os.environ['STPU_FLIGHT_DIR']
    phase_s = time.perf_counter() - t_phase
    off = [ms for sample, ms in turns if sample == 0.0]
    on = [ms for sample, ms in turns if sample == 1.0]
    emit('observability', card=card, setup_s=setup_s,
         failed_load_status=failed[0], requests=len(observed),
         answers_equal_unobserved=True, faults_fired=fired,
         paged_launches=launches, paged_route_launches=routes,
         lora_launches=lora_launches, soft_errors=len(softs),
         flight_recorded=dump['recorded'], metric_samples=len(samples),
         trace_spans=len(events),
         trace_decode_rounds=names.count('engine.decode_round'),
         slo_ok=stats['slo']['ok'],
         attention_bytes_per_token=stats['attention_bytes_per_token'][
             'total_bytes_per_token'], escalation=esc)
    emit('observability_round_ms', card=card, trace_sample_turns=[
        s for s, _ in turns], round_ms_turns=[ms for _, ms in turns],
         trace_off_round_ms=off, trace_on_round_ms=on,
         on_over_off=sum(on) / sum(off))
    emit('observability_scrape_ms', card=card, first_scrape_ms=
         first_scrape_ms, scrape_ms=scrape_ms, families=text.count(
             '# TYPE '), bytes=len(text))
    emit('observability_seconds', card=card, seconds=phase_s)


# -- decode modes ------------------------------------------------------------
# (label, pool, serve_lm flags, CUDA graphs, adapters): (a) the eager
# unpipelined baseline, (b) pipelined eager, (c) the default, pipelined
# with graphs, (d) --decode-chunk 4; int8 and LoRA runtimes run (a) and
# (c); (e) --speculative 4. The 4096 runs hold (d) to (a) on one slot at
# --max-total-len 4096, where the split route cuts a row into 32 splits
# of 128 tokens and the prompts' rows cross several of them. Prefix
# caching is off there: the one slot takes the 3 concurrent requests in
# arrival order, and a prefix cached by whichever came first would change
# the later ones' prefill chunks, and with them their bf16 tokens.
LONG_WIDTH = ('--num-slots', '1', '--max-total-len', '4096',
              '--no-prefix-caching')
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
# The modes run on the first 8 layers of the serving model: each mode's
# contract (its tokens equal (a)'s, its launches layers x steps) holds at
# any depth, and 11 engines at 32 layers took ~57 s of the smoke's clock
# (at 8 layers ~22 s, at 4 ~20 s: the rest is the engines' fixed cost).
DECODE_MODES_LAYERS = 8


def layer_cut(model, layers, max_seq_len):
    """The first `layers` layers of `model` (the same tensors, no copy)
    under llama3-8b's config at `max_seq_len`."""
    from skypilot_tpu_torch.models import convert, registry
    cfg = dataclasses.replace(registry.model_config('llama3-8b', max_seq_len),
                              num_layers=layers)
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith('layers.') or int(k.split('.')[1]) < layers}
    return convert.assemble(cfg, state)
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
    root = os.path.join(WORK, 'adapters')     # serve_lora's adapters
    layers = DECODE_MODES_LAYERS
    model = layer_cut(model, layers, model.config.max_seq_len)
    # The same weight tensors under the 4096-token config.
    long_model = layer_cut(model, layers, 4096)
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
    emit('decode_modes', card=card, layers=layers, runs=runs,
         token_identical=same,
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
    dense = dense_parity(model, ps, models, root, outs['cuda'])
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
    # The same 2-layer width with int8 projections (f32 x: the kernel's
    # CUDA-core route): the kernel's greedy tokens equal the plain
    # route's.
    from skypilot_tpu_torch.ops import int8_linear as il
    model_q = convert.init_params(cfg, seed=1, device='cuda',
                                  weight_dtype='int8')
    int8_outs = {}
    for impl in ('cuda', 'torch'):
        counts0 = (il.launches, il.plain_calls)
        with il.route_scope(impl):
            engine = ContinuousBatchingEngine(
                model_q, num_slots=4, max_total_len=1024, prefill_chunk=256)
            try:
                futs = [engine.submit(p, max_new_tokens=16) for p in ps[:4]]
                int8_outs[impl] = [f.result(timeout=600) for f in futs]
            finally:
                engine.stop()
        routed = (il.launches - counts0[0] if impl == 'cuda'
                  else il.plain_calls - counts0[1])
        check(routed > 0, f'impl {impl} of int8_linear was never taken')
        check(impl == 'torch' or il.plain_calls == counts0[1],
              'int8 parity: plain calls of int8_linear on the kernel route')
        del engine
        gc.collect()
    int8_same = int8_outs['cuda'] == int8_outs['torch']
    del model_q
    torch.cuda.empty_cache()
    long_outs = long_parity(fk, pk)
    long_same = long_outs['cuda'] == long_outs['torch']
    families = family_parity(pk)
    emit('greedy_parity', requests=len(ps), new_tokens=16, layers=2,
         models=models, equal=same, decode_modes_equal=modes_same,
         tokens_cuda=[o[-16:] for o in outs['cuda']],
         tokens_torch=[o[-16:] for o in outs['torch']],
         long_prompt_tokens=[len(o) - 8 for o in long_outs['cuda']],
         long_equal=long_same,
         long_tokens_cuda=[o[-8:] for o in long_outs['cuda']],
         long_tokens_torch=[o[-8:] for o in long_outs['torch']],
         int8_equal=int8_same,
         int8_tokens_cuda=[o[-16:] for o in int8_outs['cuda']],
         int8_tokens_torch=[o[-16:] for o in int8_outs['torch']],
         families=families, dense=dense)
    check(dense['llama_dense_vs_paged'],
          'the dense slot engine\'s greedy tokens differ from the paged '
          'engine\'s (kernel route)')
    check(dense['deepseek_graphs_vs_eager'],
          'DeepSeek dense engine: graph rounds differ from eager rounds')
    check(same, 'greedy tokens differ between the kernel and plain routes')
    check(all(f['equal'] for f in families.values()),
          f'GPT-2 / Mixtral greedy tokens differ between the kernel and '
          f'plain routes: {families}')
    check(int8_same, 'int8 weights: greedy tokens differ between the '
                     'int8_linear kernel and its plain version')
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
        ttft_max_ms = max(rt.metrics.ttft_ms)
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
         ttft_p50_s=metrics['ttft_ms_p50'] / 1e3,
         ttft_max_s=ttft_max_ms / 1e3,
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


# -- KV page chains ------------------------------------------------------------
CHAIN_FLAGS = ['--max-total-len', '2048']
CHAIN_PROMPT = 2003      # 125 full pages of 16 and a 3-token tail
PAGE_MIB = 2             # a bf16 page: 32 layers x K, V x 8 x 16 x 128 x 2 B


def chain_prompt(seed, n=CHAIN_PROMPT):
    return np.random.default_rng(seed).integers(1, 128256, n).tolist()


def first_part(a, b):
    """The first index where two token rows part (None if they agree)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def timed_tokens(eng, prompt, n=32):
    """(prompt ++ n greedy tokens, seconds to the first committed token)
    of one request on `eng`."""
    t0 = time.perf_counter()
    first = []
    out = eng.submit(prompt, max_new_tokens=n, temperature=0.0,
                     on_token=lambda t: first or first.append(
                         time.perf_counter() - t0)).result(timeout=600)
    check(len(out) == len(prompt) + n and out[:len(prompt)] == prompt,
          'bad answer')
    return out, first[0]


def on_scheduler_ms(eng, fn):
    """(fn(), ms) with fn run on the engine's scheduler thread (where a
    chain op runs inline) and timed there, to its last device write:
    the op alone, not the wait for an idle scheduler to pick it up."""
    def op():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)
    return eng.run_on_scheduler(op)


def paged_window(pk):
    """Zero the paged kernel's counts; returns a reader of them."""
    zero_paged(pk)
    pk.launches = pk.plain_calls = 0

    def read():
        routes = dict(pk.route_launches)
        check(routes['split'] > 0 and routes['chunk'] > 0
              and routes['scalar'] == 0 and pk.plain_calls == 0,
              f'paged launches by route {routes}, {pk.plain_calls} plain '
              f'calls')
        return {'route_launches': routes, 'plain_calls': pk.plain_calls}
    return read


def phase_kv_chain(model, pk, card):
    """Engine A serves P cold then warm; its chain imports into engine B
    (its own pool), which serves P with A's warm tokens and re-exports
    the same bytes; for a bf16 and an int8 pool."""
    prompt = chain_prompt(11)
    for kv in ('bf16', 'int8'):
        made = [serve_runtime(model, kv, CHAIN_FLAGS) for _ in range(2)]
        (rt_a, *_), (rt_b, *_) = made
        a, b = rt_a.engine, rt_b.engine
        try:
            read = paged_window(pk)
            cold, cold_ttft = timed_tokens(a, prompt)
            warm, warm_ttft = timed_tokens(a, prompt)
            data, export_ms = on_scheduler_ms(
                a, lambda: a.export_chain(prompt))
            summary, import_ms = on_scheduler_ms(
                b, lambda: b.import_chain(data))
            check(summary == {'pages': 125, 'imported': 125,
                              'already_cached': 0, 'dropped': 0},
                  f'import summary {summary}')
            h0 = b.prefix_cache.hits
            got, b_ttft = timed_tokens(b, prompt)
            hits = b.prefix_cache.hits - h0
            again = b.export_chain(prompt)
            counts = read()
        finally:
            for m in made:
                stop_runtime(*m[:3])
        check(got == warm, f'{kv}: B parts from A\'s warm tokens at '
                           f'{first_part(got, warm)}')
        check(hits == 125, f'{kv}: B prefix hits grew by {hits}')
        check(again == data, f'{kv}: B\'s re-export differs from A\'s')
        emit('kv_chain', card=card, pool=kv, prompt_tokens=len(prompt),
             pages=125, bytes=len(data), export_ms=export_ms,
             import_ms=import_ms,
             export_gb_per_s=len(data) / export_ms / 1e6,
             import_gb_per_s=len(data) / import_ms / 1e6,
             cold_ttft_ms=1e3 * cold_ttft, warm_ttft_ms=1e3 * warm_ttft,
             imported_ttft_ms=1e3 * b_ttft,
             cold_vs_warm_first_part=first_part(cold[len(prompt):],
                                                warm[len(prompt):]),
             b_equals_a_warm=True, reexport_bytes_equal=True,
             prefix_hits=hits, **counts)


def spill_run(model, pk, extra, label, card):
    """P served cold and warm on a ~300-page pool; prompts of 1000
    tokens fill the pool until every page of P is evicted (and
    spilled); P again restores them: the warm tokens, exactly."""
    prompt = chain_prompt(12)
    rt, server, thread, _, _ = serve_runtime(
        model, 'bf16', CHAIN_FLAGS + ['--kv-pool-bytes',
                                      str(300 * PAGE_MIB << 20)] + extra)
    eng = rt.engine
    keys = eng.prefix_cache.chain_keys(prompt, eng.page_size)
    restore_s = []
    real = eng._restore_from_spill

    def timed_restore(*a):   # the restore alone: lookups, H2D, scatter
        t0 = time.perf_counter()
        real(*a)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)

    eng._restore_from_spill = timed_restore
    try:
        read = paged_window(pk)
        _, cold_ttft = timed_tokens(eng, prompt)
        warm, warm_ttft = timed_tokens(eng, prompt)
        fills = 0
        while any(k in eng.prefix_cache.by_key for k in keys):
            check(fills < 12, 'the fills never evicted P')
            timed_tokens(eng, chain_prompt(100 + fills, 1000), n=8)
            fills += 1
        spilled = eng.prefix_cache.spilled_pages
        tier0 = eng.spill_tier.stats()
        restored0 = eng.kv_restored_pages
        restore_s.clear()
        got, restored_ttft = timed_tokens(eng, prompt)
        restored = eng.kv_restored_pages - restored0
        tier = eng.spill_tier.stats()
        counts = read()
    finally:
        stop_runtime(rt, server, thread)
    check(got == warm, f'{label}: restored run parts from the warm '
                       f'tokens at {first_part(got, warm)}')
    check(restored == len(keys) and tier0['dropped_pages'] == 0,
          f'{label}: restored {restored} of {len(keys)} spilled pages '
          f'({tier0})')
    if 'cold' in tier:
        check(tier['cold']['reads'] > 0, f'{label}: no cold reads {tier}')
    emit('kv_spill', card=card, tier=label, pool_pages=eng.total_pages,
         fills=fills, spilled_pages=spilled, restored_pages=restored,
         restore_ms=1e3 * sum(restore_s), restore_calls=len(restore_s),
         restore_gb_per_s=(restored * (PAGE_MIB << 20) / sum(restore_s)
                           / 1e9 if restore_s else None),
         cold_ttft_ms=1e3 * cold_ttft, warm_ttft_ms=1e3 * warm_ttft,
         restored_ttft_ms=1e3 * restored_ttft, tokens_equal_warm=True,
         tier_stats=tier, **counts)


def phase_kv_spill(model, pk, card):
    spill_run(model, pk, ['--kv-spill-bytes', str(512 << 20)], 'host', card)
    cold = os.path.join(WORK, 'kv_cold')
    shutil.rmtree(cold, ignore_errors=True)
    try:
        spill_run(model, pk, ['--kv-spill-bytes', str(4 * PAGE_MIB << 20),
                              '--kv-cold-dir', cold], 'host+cold', card)
    finally:
        shutil.rmtree(cold, ignore_errors=True)


def phase_disagg(model, pk, card):
    """A prefill replica hands 4 /generate requests and an SSE stream of
    ~2000 tokens to a decode replica; each answer equals the decode
    replica's own (warm) answer to the same request; then a dead peer:
    every request serves locally with the same answers."""
    dec = serve_runtime(model, 'bf16', CHAIN_FLAGS + ['--role', 'decode'])
    pre = serve_runtime(model, 'bf16', CHAIN_FLAGS + [
        '--role', 'prefill', '--decode-peers', f'127.0.0.1:{dec[3]}'])
    d_port, p_port = dec[3], pre[3]
    ps = [chain_prompt(20 + i, 1990 + 5 * i) for i in range(5)]
    try:
        read = paged_window(pk)
        outs, e2e = [], []
        for p in ps[:4]:
            t0 = time.perf_counter()
            outs.append(post(p_port, '/generate', {
                'tokens': [p], 'max_new_tokens': 32})['tokens'][0])
            e2e.append(time.perf_counter() - t0)
        events, handoff_ttft, _ = sse(p_port, '/generate', {
            'tokens': [ps[4]], 'max_new_tokens': 32, 'stream': True})
        check(events[-1] == '[DONE]' and events[-2].get('done'),
              'handoff stream did not end')
        outs.append(ps[4] + [e['token'] for e in events
                             if isinstance(e, dict) and 'token' in e])
        pre_stats = post_stats(p_port)['handoff']
        dec_stats = post_stats(d_port)['handoff']
        direct = [post(d_port, '/generate', {'tokens': [p],
                                             'max_new_tokens': 32}
                       )['tokens'][0] for p in ps]
        # A unified replica's TTFT: a cold prompt straight to the decode
        # replica (the role is a label there).
        _, unified_ttft, _ = sse(d_port, '/generate', {
            'tokens': [chain_prompt(30, 2000)], 'max_new_tokens': 32,
            'stream': True})
        post(p_port, '/kv/peers', {'decode': ['127.0.0.1:9']})
        local = [post(p_port, '/generate', {'tokens': [p],
                                            'max_new_tokens': 32}
                      )['tokens'][0] for p in ps[:2]]
        dead = post_stats(p_port)['handoff']
        counts = read()
    finally:
        stop_runtime(*pre[:3])
        stop_runtime(*dec[:3])
    for i, (o, d) in enumerate(zip(outs, direct)):
        check(o == d, f'request {i}: the handoff answer parts from the '
                      f'decode replica\'s at {first_part(o, d)}')
    check(pre_stats['handoffs'] == 5 and pre_stats['failures'] == 0
          and dec_stats['kv_imports'] == 5,
          f'handoff counts {pre_stats} {dec_stats}')
    check(local == direct[:2], 'a dead peer changed the answers')
    check(dead['handoffs'] == 7 and dead['failures'] == 2,
          f'dead-peer counts {dead}')
    emit('disagg', card=card, prompt_tokens=[len(p) for p in ps],
         handoffs=pre_stats['handoffs'], failures=pre_stats['failures'],
         kv_imports=dec_stats['kv_imports'],
         handoff_bytes=pre_stats['bytes'],
         handoff_s_mean=pre_stats['seconds'] / pre_stats['handoffs'],
         e2e_s=e2e, ttft_through_prefill_s=handoff_ttft,
         ttft_unified_s=unified_ttft, answers_equal_direct=True,
         dead_peer_failures=dead['failures'], **counts)


def post_stats(port):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/stats',
                                timeout=60) as resp:
        return json.loads(resp.read())


def phase_migration(model, pk, card):
    """A 64-token greedy stream on replica A; after 8 tokens POST
    /kv/evacuate to A with B as the target: the stream ends with 64
    tokens through B, with the undisturbed run's tokens before the
    evacuation."""
    rep_b = serve_runtime(model, 'bf16', CHAIN_FLAGS)
    rep_a = serve_runtime(model, 'bf16', CHAIN_FLAGS)
    prompt = chain_prompt(40, 1000)
    body = {'tokens': [prompt], 'max_new_tokens': 64, 'stream': True}
    try:
        read = paged_window(pk)
        undisturbed = post(rep_b[3], '/generate', dict(
            body, stream=False))['tokens'][0][len(prompt):]
        import http.client
        conn = http.client.HTTPConnection('127.0.0.1', rep_a[3],
                                          timeout=600)
        conn.request('POST', '/generate', json.dumps(body),
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        toks, done, evac, at = [], None, None, None
        t_evac = None
        for line in resp:
            if not line.startswith(b'data: '):
                continue
            data = line[6:].strip()
            if data == b'[DONE]':
                break
            frame = json.loads(data)
            if 'token' in frame:
                toks.append(frame['token'])
            if frame.get('done'):
                done = frame
            if len(toks) == 8 and evac is None:
                t_evac = time.perf_counter()
                evac = post(rep_a[3], '/kv/evacuate', {
                    'reason': 'drain', 'target': f'127.0.0.1:{rep_b[3]}'})
                at = len(toks)
        conn.close()
        stats_a, stats_b = post_stats(rep_a[3]), post_stats(rep_b[3])
        counts = read()
    finally:
        stop_runtime(*rep_a[:3])
        stop_runtime(*rep_b[:3])
    mig_a, mig_b = stats_a.get('migration', {}), stats_b.get('migration', {})
    check(len(toks) == 64 and done is not None
          and done['tokens'][0][len(prompt):] == toks,
          f'migrated stream: {len(toks)} tokens, terminal {done is not None}')
    check(evac['evacuated'] == 1 and evac['chains'] == 1, f'{evac}')
    check(mig_a['migrations'].get('drain', 0) >= 1
          and mig_b['migrations_in'] >= 1, f'{mig_a} {mig_b}')
    check(toks[:at] == undisturbed[:at],
          'tokens before the evacuation part from the undisturbed run')
    emit('migration', card=card, prompt_tokens=len(prompt), new_tokens=64,
         evacuated_after=at, evacuate=evac,
         first_part_from_undisturbed=first_part(toks, undisturbed),
         migration_s=mig_a['seconds'], migrations=mig_a['migrations'],
         migrations_in=mig_b['migrations_in'],
         tokens_recomputed=mig_b['tokens_recomputed'],
         imported_pages=stats_b['handoff']['kv_imported_pages'],
         stream_wall_after_evacuate_s=time.perf_counter() - t_evac,
         **counts)


# -- the serving fleet ----------------------------------------------------------
# serve_fleet: the port's fleet (recipes/serve_fleet.py) as a user starts it,
# over serve_lm replicas of Llama-3-8B at full width and depth (seeded
# weights), each on this card with its own 4 GB pool. A burst scales it from
# 1 to 2 replicas (queue depth over --target-queue-per-replica, or backlog
# over the low --target-backlog-per-replica); prefix groups and cold prompts
# are then held through the LB; load falls and the autoscaler drains back to
# 1 after FLEET_DOWNSCALE_S; the fleet is SIGKILLed and restarted on the same
# --state-dir and must adopt its replica.
FLEET_REPLICA_FLAGS = ['--model', 'llama3-8b', '--max-total-len', '1024',
                       '--num-slots', '8', '--prefill-chunk', '256',
                       '--kv-pool-bytes', '4000000000']
FLEET_SCRAPE_S = 0.5
FLEET_DOWNSCALE_S = 22
FLEET_PREFIX = 512           # a group's shared prefix: 32 pages of 16
FLEET_GROUPS, FLEET_GROUP_SIZE, FLEET_COLD = 3, 3, 2
FLEET_NEW = 16
FLEET_BURST = 16             # concurrent requests a wave: 8 over the slots
FLEET_VOCAB = 128256
FLEET_BOOT_S = 300           # a replica's spawn to ready, at most
# Interleaved pairs (through the LB, then directly, the order flipped every
# pair) that time the LB's own cost a request: a GET the replica answers
# from memory, and a one-token /generate of a 16-token prompt.
FLEET_LB_PAIRS_GET, FLEET_LB_PAIRS_GEN = 200, 40


def fleet_prompts(seed):
    """(group or None, tokens): FLEET_GROUPS groups of FLEET_GROUP_SIZE
    prompts sharing a FLEET_PREFIX-token prefix, then FLEET_COLD cold
    prompts; 600-900 tokens each."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(FLEET_GROUPS):
        prefix = rng.integers(1, FLEET_VOCAB, FLEET_PREFIX).tolist()
        for _ in range(FLEET_GROUP_SIZE):
            n = int(rng.integers(600, 901)) - FLEET_PREFIX
            out.append((g, prefix + rng.integers(1, FLEET_VOCAB, n).tolist()))
    for _ in range(FLEET_COLD):
        out.append((None, rng.integers(1, FLEET_VOCAB,
                                       int(rng.integers(600, 901))).tolist()))
    return out


def get_url(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def timed_get(url, timeout=10):
    """(seconds, JSON answer) of GET url."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return time.perf_counter() - t0, json.loads(resp.read())


def post_url(url, body, timeout=600):
    """(seconds, JSON answer) of POST url."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return time.perf_counter() - t0, json.loads(resp.read())


def journal_events(state_dir):
    """The fleet journal's events, in order (a torn last line skipped)."""
    out = []
    path = os.path.join(state_dir, 'fleet.journal')
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


#: Set in the fleet's environment, which its replicas inherit: the mark
#: of this run's own serve_lm processes. Nothing else on the host (another
#: checkout's tests or smoke, a user's server) carries its value.
FLEET_MARK_ENV = 'STPU_SMOKE_FLEET_MARK'


def fleet_pids(mark):
    """Live serve_lm processes whose environment carries `mark` (zombies
    have no cmdline; another user's environ is unreadable, so not ours)."""
    want = f'{FLEET_MARK_ENV}={mark}'.encode()
    pids = []
    for name in os.listdir('/proc'):
        if not name.isdigit():
            continue
        try:
            with open(f'/proc/{name}/cmdline', 'rb') as f:
                cmd = f.read().split(b'\0')
            if b'skypilot_tpu_torch.recipes.serve_lm' not in cmd:
                continue
            with open(f'/proc/{name}/environ', 'rb') as f:
                env = f.read().split(b'\0')
        except OSError:
            continue
        if want in env:
            pids.append(int(name))
    return pids


class Fleet:
    """One `python -m skypilot_tpu_torch.recipes.serve_fleet` process, its
    output in WORK/fleet/<name>.log."""

    def __init__(self, name, lb_port, state_dir, mark):
        from skypilot_tpu_torch.robustness.train_guard import METADATA_URL_ENV
        root = os.path.join(WORK, 'fleet')
        os.makedirs(root, exist_ok=True)
        env = dict(os.environ)
        env[FLEET_MARK_ENV] = mark
        env[METADATA_URL_ENV] = LOCAL_METADATA
        env.pop('STPU_FAULT_PLAN', None)
        env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
        env['CUDA_VISIBLE_DEVICES'] = os.environ.get(
            'CUDA_VISIBLE_DEVICES', '0').split(',')[0]
        self.url = f'http://127.0.0.1:{lb_port}'
        self.log_path = os.path.join(root, f'{name}.log')
        self.log = open(self.log_path, 'w')
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'skypilot_tpu_torch.recipes.serve_fleet',
             *FLEET_REPLICA_FLAGS, '--replicas', '1', '--max-replicas', '2',
             '--lb-policy', 'prefix_affinity', '--lb-port', str(lb_port),
             '--state-dir', state_dir,
             '--scrape-interval', str(FLEET_SCRAPE_S),
             '--upscale-delay', '0',
             '--downscale-delay', str(FLEET_DOWNSCALE_S),
             '--target-backlog-per-replica', '1024', '--drain-grace', '120'],
            cwd=ROOT, env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def status(self):
        try:
            return get_url(self.url + '/fleet/status')
        except (OSError, ValueError):
            return None

    def wait(self, cond, what, timeout):
        """The first /fleet/status for which cond(status) holds."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f'serve_fleet exited rc {self.proc.returncode} waiting '
                    f'for {what}: {self.tail()}')
            st = self.status()
            if st is not None and cond(st):
                return st
            time.sleep(0.1)
        raise AssertionError(f'serve_fleet: no {what} in {timeout} s: '
                             f'{self.tail()}')

    def tail(self, n=20):
        if not self.log.closed:
            self.log.flush()
        with open(self.log_path) as f:
            return ''.join(f.readlines()[-n:])

    def stop(self, sig=signal.SIGTERM, timeout=180):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.log.close()
        return self.proc.returncode


def ready_views(st):
    return [r for r in st['replicas'] if r['state'] == 'READY' and r['ready']]


def fleet_generate(url, tokens, routed=None):
    """(seconds, tokens) of one greedy /generate through `url`, checked;
    with `routed` (a status reader) also the endpoint the LB sent it to."""
    before = routed() if routed else None
    secs, out = post_url(url + '/generate', {'tokens': [tokens],
                                             'max_new_tokens': FLEET_NEW})
    row = out['tokens'][0]
    check(len(row) == len(tokens) + FLEET_NEW and row[:len(tokens)] == tokens
          and all(0 <= t < FLEET_VOCAB for t in row), 'a bad fleet answer')
    if routed is None:
        return secs, row
    after = routed()
    went = [e for e in after if after[e] != before.get(e, 0)]
    check(len(went) == 1, f'one request, routed to {went}')
    return secs, row, went[0]


def phase_serve_fleet(card):
    """The fleet as a user runs it: scale 1 -> 2 on a burst, prefix groups
    on one replica each, answers through the LB equal to the serving
    replica's, every replica on the card through the paged kernel, drain
    back to 1 with every request answered, SIGKILL and adoption, SIGTERM
    and none of its own serve_lm processes left."""
    from skypilot_tpu_torch.serve.replica_plane import replica_manager as rm
    from skypilot_tpu_torch.utils import net
    mark = uuid.uuid4().hex       # this phase's replicas, and only they
    state_dir = os.path.join(WORK, 'fleet', 'state')
    shutil.rmtree(state_dir, ignore_errors=True)
    lb_port = net.free_port()     # below the ephemeral range: the
    fleets = []                   # restarted fleet binds it again
    try:
        fleet = Fleet('first', lb_port, state_dir, mark)
        fleets.append(fleet)
        fleet.wait(lambda st: len(ready_views(st)) == 1, 'first replica',
                   FLEET_BOOT_S)
        routed = lambda: fleet.status()['lb']['routed_per_replica']

        # The burst: waves of FLEET_BURST concurrent cold prompts until the
        # autoscaler's second replica is ready.
        burst_ok, waves, wave_s = 0, 0, []
        rng = np.random.default_rng(60)
        scaled_at = None
        t_burst = time.monotonic()
        while True:
            ps = [rng.integers(1, FLEET_VOCAB, int(rng.integers(600, 901)))
                  .tolist() for _ in range(FLEET_BURST)]
            t0 = time.perf_counter()
            results = concurrently(
                lambda i: fleet_generate(fleet.url, ps[i]), FLEET_BURST)
            wave_s.append(time.perf_counter() - t0)
            burst_ok += len(results)
            waves += 1
            st = fleet.status()
            if scaled_at is None and len(st['replicas']) == 2:
                scaled_at = waves
            if len(ready_views(st)) == 2:
                break
            check(time.monotonic() - t_burst < FLEET_BOOT_S
                  and (scaled_at is not None or waves < 20),
                  f'no second replica after {waves} waves: {st}')
        t_two = time.perf_counter()

        # Prefix groups and cold prompts through the LB, one at a time:
        # each group on one replica, the groups' pages hit.
        ps = fleet_prompts(61)
        hits0 = {r['endpoint']: r['prefix_hits'] for r in st['replicas']}
        served, cold_answers = [], []
        for _, p in ps:
            _, row, went = fleet_generate(fleet.url, p, routed)
            served.append(went)
            cold_answers.append(row)
        groups = {g: {s for (gi, _), s in zip(ps, served) if gi == g}
                  for g in range(FLEET_GROUPS)}
        check(all(len(s) == 1 for s in groups.values()),
              f'a prefix group split over replicas: {groups}')
        time.sleep(3 * FLEET_SCRAPE_S)
        st = fleet.status()
        hits = sum(r['prefix_hits'] - hits0.get(r['endpoint'], 0)
                   for r in st['replicas'])
        want_hits = FLEET_GROUPS * (FLEET_GROUP_SIZE - 1) * FLEET_PREFIX // 16
        check(hits >= want_hits, f'prefix hits {hits} < {want_hits}')
        # Warm through the LB, then the serving replica asked directly: the
        # same bits (both find the prompt's full pages cached).
        warm, lb_s, direct_s = [], [], []
        for (_, p), s in zip(ps, served):
            secs, row, went = fleet_generate(fleet.url, p, routed)
            check(went == s, f'the warm pass went to {went}, not {s}')
            d_secs, d_row = fleet_generate(f'http://{s}', p)
            check(row == d_row, f'through the LB vs {s} directly: parts at '
                                f'{first_part(row, d_row)}')
            warm.append(row)
            lb_s.append(secs)
            direct_s.append(d_secs)
        section_s = time.perf_counter() - t_two
        st = fleet.status()
        check(len(ready_views(st)) == 2,
              f'the scale-down came before the answers were held '
              f'({section_s:.1f} s after the second replica): {st}')
        stats = {r['endpoint']: get_url(f'http://{r["endpoint"]}/stats')
                 for r in st['replicas']}
        for ep, s in stats.items():
            pa = s['paged_attention']
            check(s['device'].startswith('cuda') and pa['kernel_launches'] > 0
                  and pa['plain_calls'] == 0 and pa['routes']['split'] > 0
                  and pa['routes']['chunk'] > 0
                  and pa['routes']['scalar'] == 0
                  and s['storage']['attention_kernel_unavailable_reason']
                  is None, f'replica {ep}: {s["device"]}, {pa}, '
                  f'{s["storage"]}')

        # Load falls: the autoscaler drains one replica after
        # FLEET_DOWNSCALE_S. Requests keep coming, one at a time, short;
        # every one is answered. The victim answers /readyz 503 (draining)
        # while alive, after the fleet has journaled it DRAINING.
        events = journal_events(state_dir)
        pid_of = {e['replica_id']: e['pid'] for e in events
                  if e['event'] == 'spawn'}
        uuid_of = {e['replica_id']: e['instance_uuid'] for e in events
                   if e['event'] == 'spawn'}
        ids = {r['endpoint']: r['replica_id'] for r in st['replicas']}
        stop = threading.Event()
        drain_answers = []
        drain_errors = []

        def drain_traffic():
            r = np.random.default_rng(62)
            while not stop.is_set():
                try:
                    drain_answers.append(fleet_generate(
                        fleet.url, r.integers(1, FLEET_VOCAB, 64).tolist()))
                except Exception as e:  # pylint: disable=broad-except
                    drain_errors.append(repr(e))

        traffic = threading.Thread(target=drain_traffic, daemon=True)
        traffic.start()
        seen = {}
        t_drain0 = time.monotonic()
        victim = None
        try:
            while time.monotonic() - t_drain0 < FLEET_DOWNSCALE_S + 120:
                st = fleet.status() or {'replicas': []}
                now = time.time()
                if victim is None and st['replicas']:
                    # Out of the routing set: DRAINING, SHUTDOWN, or
                    # already forgotten.
                    out = [r['endpoint'] for r in st['replicas']
                           if r['state'] in ('DRAINING', 'SHUTDOWN')]
                    out += sorted(set(ids) - {r['endpoint']
                                              for r in st['replicas']})
                    if out:
                        victim = out[0]
                        seen['status_draining'] = now
                if victim is not None:
                    try:
                        with urllib.request.urlopen(
                                f'http://{victim}/readyz', timeout=2) as _:
                            pass
                    except urllib.error.HTTPError as e:
                        body = json.loads(e.read() or b'{}')
                        if e.code == 503 and 'draining' in body.get(
                                'reasons', []):
                            seen.setdefault('readyz_draining', now)
                    except OSError:
                        pass
                    if not rm.pid_alive(pid_of[ids[victim]]):
                        seen['exited'] = now
                        break
                time.sleep(0.05)
        finally:
            stop.set()
            traffic.join(timeout=600)
        check(victim is not None and 'exited' in seen,
              f'no drain to 1 replica: {seen}, {fleet.status()}')
        check(not drain_errors and drain_answers,
              f'{len(drain_errors)} requests failed during the drain '
              f'({len(drain_answers)} answered): {drain_errors[:3]}')
        st = fleet.wait(lambda s: len(s['replicas']) == 1
                        and len(ready_views(s)) == 1, 'one replica', 60)
        # The fleet took the victim out of routing (journaled DRAINING)
        # before it was signalled (its /readyz says draining from SIGTERM
        # on), and journaled its exit after.
        vid = ids[victim]
        states = [(e['state'], e['ts']) for e in journal_events(state_dir)
                  if e['event'] == 'state' and e['replica_id'] == vid]
        names = [s for s, _ in states]
        check('DRAINING' in names and 'SHUTDOWN' in names
              and names.index('DRAINING') < names.index('SHUTDOWN')
              and 'readyz_draining' in seen
              and dict(states)['DRAINING'] <= seen['readyz_draining'],
              f'replica {vid}: journal {states}, seen {seen}')
        survivor = st['replicas'][0]
        sid = survivor['replica_id']
        survivor_stats = get_url(f'http://{survivor["endpoint"]}/stats')
        # A probe the survivor has answered warm, whatever routed where.
        probe = fleet_prompts(63)[0][1]
        fleet_generate(f'http://{survivor["endpoint"]}', probe)
        _, probe_row = fleet_generate(f'http://{survivor["endpoint"]}',
                                      probe)

        # Crash-only restart: SIGKILL the fleet, start it again on the same
        # state dir. The survivor must be adopted (same pid, same instance
        # UUID), not respawned, and answer as before.
        fleet.stop(signal.SIGKILL)
        check(rm.pid_alive(pid_of[sid]), 'the survivor died with the fleet')
        fleet = Fleet('restart', lb_port, state_dir, mark)
        fleets.append(fleet)
        st = fleet.wait(lambda s: len(ready_views(s)) == 1,
                        'the adopted replica', 120)
        adoption_s = time.time() - fleet.t0
        again = st['replicas'][0]
        again_stats = get_url(f'http://{again["endpoint"]}/stats')
        check(len(st['replicas']) == 1 and again['adopted']
              and again['replica_id'] == sid
              and again_stats['pid'] == pid_of[sid] == survivor_stats['pid']
              and again_stats['instance_uuid'] == uuid_of[sid]
              == survivor_stats['instance_uuid'],
              f'not adopted: {st}, pid {again_stats["pid"]} vs '
              f'{pid_of[sid]}')
        _, got = fleet_generate(fleet.url, probe)
        check(got == probe_row, f'the adopted replica parts from its probe '
                                f'answer at {first_part(got, probe_row)}')
        adopted_answers = 1
        for (_, p), s, row in zip(ps, served, warm):
            if s != survivor['endpoint']:
                continue
            _, got = fleet_generate(fleet.url, p)
            check(got == row, f'the adopted replica parts from its answer '
                              f'at {first_part(got, row)}')
            adopted_answers += 1
        # The LB's own cost a request: the adopted replica alone behind
        # it, the same request through the LB and directly, interleaved so
        # that drift falls on both sides; each pair's answers equal.
        direct = f'http://{again["endpoint"]}'
        short = probe[:16]
        lb_cost = {}
        for what, pairs, call in (
                ('get_v1_models', FLEET_LB_PAIRS_GET,
                 lambda u: timed_get(u + '/v1/models')),
                ('generate_1_token', FLEET_LB_PAIRS_GEN,
                 lambda u: post_url(u + '/generate', {
                     'tokens': [short], 'max_new_tokens': 1}))):
            diffs = []
            for i in range(pairs):
                order = (fleet.url, direct) if i % 2 else (direct, fleet.url)
                got = {u: call(u) for u in order}
                check(got[fleet.url][1] == got[direct][1],
                      f'{what}: the LB answered {got[fleet.url][1]}, the '
                      f'replica {got[direct][1]}')
                diffs.append(got[fleet.url][0] - got[direct][0])
            q25, q50, q75 = 1e3 * np.percentile(diffs, [25, 50, 75])
            lb_cost[what] = {'pairs': pairs, 'median_ms': float(q50),
                             'p25_ms': float(q25), 'p75_ms': float(q75)}
        rc = fleet.stop()
        if rc != 0:
            raise AssertionError(f'serve_fleet exited {rc} on SIGTERM: '
                                 f'{fleet.tail()}')
        deadline = time.monotonic() + 60
        while fleet_pids(mark) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = fleet_pids(mark)
        check(not left, f'serve_lm outlived the fleet: {left}')
    finally:
        for f in fleets:
            if f.proc.poll() is None:
                f.proc.kill()
                f.proc.wait(timeout=30)
        for pid in fleet_pids(mark):     # never a process of another run
            os.kill(pid, signal.SIGKILL)
    ready_s = {}
    for e in journal_events(state_dir):
        if e['event'] == 'spawn' and e['replica_id'] not in ready_s:
            ready_s[e['replica_id']] = [e['ts'], None]
        elif (e['event'] == 'state' and e['state'] == 'READY'
              and ready_s.get(e['replica_id'], [0, 1])[1] is None):
            ready_s[e['replica_id']][1] = e['ts']
    spawn_to_ready = {rid: b - a for rid, (a, b) in ready_s.items()
                      if b is not None}
    launches = {ep: s['paged_attention'] for ep, s in stats.items()}
    emit('serve_fleet', card=card, model=FLEET_REPLICA_FLAGS[1],
         replica_flags=FLEET_REPLICA_FLAGS, replicas='1..2',
         spawn_to_ready_s=spawn_to_ready, adoption_s=adoption_s,
         burst_waves=waves, burst_requests=burst_ok,
         scaled_at_wave=scaled_at, wave_s=wave_s,
         groups=FLEET_GROUPS, group_size=FLEET_GROUP_SIZE,
         prefix_tokens=FLEET_PREFIX, prefix_hits=hits,
         prefix_hits_wanted=want_hits, section_s=section_s,
         lb_warm_s=lb_s, direct_warm_s=direct_s,
         lb_overhead_ms=lb_cost,
         answers_equal_direct=True,
         cold_vs_warm_first_part=[first_part(a, b) for a, b in
                                  zip(cold_answers, warm)],
         drain_requests=len(drain_answers),
         drain_seen={k: v - seen['status_draining'] for k, v in seen.items()},
         victim=vid, survivor=sid, adopted_answers=adopted_answers,
         replica_kernels=launches)
    routes = {'split': 0, 'chunk': 0}
    for pa in launches.values():
        for r in routes:
            routes[r] += pa['routes'][r]
    return routes


# -- GPT-2 and Mixtral ----------------------------------------------------------
# serve_lm's flags for both families: the configs' own 128-page pool.
FAMILY_FLAGS = ('--continuous-batching', '--num-slots', '8',
                '--max-total-len', '1024', '--prefill-chunk', '256',
                '--port', '0')
# Mixtral 8x7B does not fit one card at full depth (46.7e9 parameters):
# serving keeps 16 of its 32 layers (~47 GB in bf16), training 2 (f32
# masters, grads and Adam moments: ~51 GB).
MIXTRAL_SERVE_LAYERS = 16
MIXTRAL_TRAIN_LAYERS = 2


def family_prompts(vocab, seed=0, n=8):
    """n prompts of 100-200 tokens, the second sharing the first's 64
    tokens (4 pages: the burst's warm-up request caches them, so both
    prefill their suffix as a paged chunk at offset 64)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(1, vocab, int(n_tok)).tolist()
           for n_tok in rng.integers(100, 201, n)]
    out[1] = out[0][:64] + out[1][64:]
    return out


def family_runtime(name, model, extra=(), cuda_graphs=True):
    """build_runtime with serve_lm's flags for `--model name`, sharing
    `model`'s weights, and make_server on an ephemeral port."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args(['--model', name, *FAMILY_FLAGS, *extra])
    t0 = time.perf_counter()
    rt = build_runtime(args, model=model, cuda_graphs=cuda_graphs)
    setup_s = time.perf_counter() - t0
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return rt, server, thread, server.server_address[1], setup_s


@contextlib.contextmanager
def dispatch_device_ms(engine):
    """Device ms of each decode dispatch of `engine`: CUDA events
    recorded on the stream just before and after it. A graph round is
    one replay the host enqueues at once, so the interval between the
    two events is the round's device time; the list is filled when the
    block exits (after a synchronize)."""
    rnd = engine._rounds[0]    # pylint: disable=protected-access
    orig = rnd.dispatch
    events, out = [], []

    def timed(**kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pending = orig(**kw)
        e1.record()
        events.append((e0, e1))
        return pending

    rnd.dispatch = timed
    try:
        yield out
    finally:
        rnd.dispatch = orig
        torch.cuda.synchronize()
        out.extend(e0.elapsed_time(e1) for e0, e1 in events)


def serve_family(label, name, model, kernels, card, extra=(), ps=None,
                 dense=False):
    """The burst (`ps`, by default 8 prompts of 100-200 tokens) through
    serve_lm's flags (+ `extra`; pipelined, graph rounds), then on an
    eager, unpipelined runtime: the same tokens bit for bit, every answer
    prompt + 32, graph replays. The paged kernel (kernels[0]): both
    routes launched, never the scalar one nor a plain call; on a `dense`
    engine (the dense slot path, attention_impl 'dense') never at all.
    Returns (the emitted numbers, the paged routes, the rows, each
    kernel's (launches, plain calls) over the graph burst)."""
    pk = kernels[0]
    t_phase = time.perf_counter()
    cfg = model.config
    ps = ps or family_prompts(cfg.vocab_size)
    rt, server, thread, port, setup_s = family_runtime(name, model, extra)
    try:
        paged, impl = rt.engine.paged, rt.engine.attention_impl()
        with dispatch_device_ms(rt.engine) as device_ms:
            rows, out = burst(rt, port, ps, [None] * len(ps), kernels)
        weight_bytes = rt.weight_bytes
        cache_bytes = rt.engine.kv_cache_bytes()
    finally:
        stop_runtime(rt, server, thread)
    del rt, server, thread
    gc.collect()
    counts = out.pop('counts')
    launches, plain_calls = counts[0]
    routes = out['paged_route_launches']
    eager = family_runtime(name, model, [*extra, '--no-pipeline-decode'],
                           cuda_graphs=False)
    try:
        eager_rows, eager_out = burst(eager[0], eager[3], ps,
                                      [None] * len(ps), kernels)
    finally:
        stop_runtime(*eager[:3])
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    if dense:
        check(not paged and impl == 'dense',
              f'{label}: paged {paged}, attention_impl {impl}')
        check(launches == plain_calls == 0
              and eager_out['counts'][0] == (0, 0)
              and not any(routes.values()),
              f'{label}: the dense path ran paged attention ({launches} '
              f'launches, {plain_calls} plain calls, {routes})')
    else:
        check(paged and launches > 0 and plain_calls == 0
              and eager_out['counts'][0][1] == 0,
              f'{label}: {launches} kernel launches, plain calls '
              f'{plain_calls} / {eager_out["counts"][0][1]}')
        check(routes['split'] > 0 and routes['chunk'] > 0
              and routes['scalar'] == 0, f'{label}: routes {routes}')
    check(out['graph_replays'] > 0 and out['cuda_graphs']
          and out['pipeline_decode'], f'{label}: no graph rounds {out}')
    check(not eager_out['cuda_graphs'] and not eager_out['pipeline_decode'],
          f'{label}: the eager runtime ran {eager_out}')
    check(rows == eager_rows, f'{label}: graph-replayed, pipelined tokens '
                              f'differ from eager, unpipelined ones')
    steady = sorted(device_ms)[len(device_ms) // 2] if device_ms else None
    return dict(
        card=card, model=name, layers=cfg.num_layers,
        embed_dim=cfg.embed_dim, setup_s=setup_s, **out,
        kernel_launches=launches, plain_calls=plain_calls,
        paged=paged, attention_impl=impl, kv_cache_bytes=cache_bytes,
        eager_equal=True,
        eager_decode_round_ms=eager_out['decode_round_ms'],
        device_round_ms=steady, device_dispatches=len(device_ms),
        device_busy_share=(steady / out['decode_round_ms']
                           if steady and out['decode_round_ms'] else None),
        weight_bytes=weight_bytes,
        phase_s=time.perf_counter() - t_phase), routes, rows, counts


def phase_serve_gpt2(pk, card):
    """gpt2-124m at full width and depth, seeded on the card."""
    from skypilot_tpu_torch.models import convert, registry
    model = convert.init_params(registry.model_config('gpt2-124m', 1024),
                                seed=0, device='cuda')
    out, routes, _, _ = serve_family('serve_gpt2', 'gpt2-124m', model, (pk,),
                                     card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit('serve_gpt2', **out)
    return routes


def phase_serve_mixtral(pk, card):
    """mixtral-8x7b at full width, cut to MIXTRAL_SERVE_LAYERS, seeded on
    the card; freed before the phase returns. Its decode round reads
    every expert (dense dispatch over E), so the bound of a round is the
    bytes of every weight but the embedding table (8 rows of it)."""
    from skypilot_tpu_torch.models import convert, registry
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.model_config('mixtral-8x7b', 1024),
                              num_layers=MIXTRAL_SERVE_LAYERS)
    model = convert.init_params(cfg, seed=0, device='cuda')
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    round_bytes = sum(t.numel() * t.element_size()
                      for n, t in model.state_dict().items()
                      if n != 'tok_embed')
    out, routes, _, _ = serve_family('serve_mixtral', 'mixtral-8x7b', model,
                                     (pk,), card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bound = 1e3 * round_bytes / HBM_BYTES_PER_S
    emit('serve_mixtral', **out, reduced={'num_layers': [32, cfg.num_layers]},
         init_s=init_s, round_bytes=round_bytes, round_bound_ms=bound,
         round_over_bound=(out['decode_round_ms'] / bound
                           if out['decode_round_ms'] else None))
    return routes


@contextlib.contextmanager
def depth_cut(name, layers):
    """`train_lm --model name` builds `layers` layers of its config (the
    registry's train_config, which train_lm reads, patched)."""
    from skypilot_tpu_torch.models import registry
    orig = registry.train_config

    def cut(model, seq, remat=False):
        cfg = orig(model, seq, remat)
        return (dataclasses.replace(cfg, num_layers=layers)
                if model == name else cfg)

    registry.train_config = cut
    try:
        yield
    finally:
        registry.train_config = orig


def train_family(label, argv, fk, card):
    """`train_lm argv --metrics-file ...` in this process: (its output,
    its metric records, the flash launches, peak GB, seconds)."""
    from skypilot_tpu_torch.observability.step_metrics import read_jsonl
    root = os.path.join(WORK, label)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    metrics = os.path.join(root, 'metrics.jsonl')
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_flash(fk)
    t0 = time.perf_counter()
    text = run_train_lm([*argv, '--metrics-file', metrics])
    seconds = time.perf_counter() - t0
    counts = flash_counts(fk)
    records = read_jsonl(metrics)
    check('training done' in text, f'{label}: train_lm did not finish')
    check(records and all(np.isfinite(r['loss'])
                          and np.isfinite(r['grad_norm'])
                          and r['mfu'] is not None for r in records),
          f'{label}: metric records {records}')
    check(fk.plain_calls == 0, f'{label}: flash plain calls')
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return text, records, counts, peak, seconds


def phase_train_gpt2(fk, card):
    """train_lm --model gpt2-124m with nanogpt.yaml's model and sequence
    (1024): 20 steps of B=8; S < 2048, so no flash launch."""
    argv = ['--model', 'gpt2-124m', '--seq', '1024', '--global-batch', '8',
            '--steps', '20', '--log-every', '5']
    _, records, counts, peak, seconds = train_family('train_gpt2', argv,
                                                     fk, card)
    check(counts == {'flash_fwd': 0, 'flash_bwd': 0},
          f'train_gpt2 launched flash at S=1024: {counts}')
    emit('train_gpt2', card=card, argv=argv,
         steps=[r['step'] for r in records],
         losses=[r['loss'] for r in records],
         grad_norms=[r['grad_norm'] for r in records],
         step_time_s=[r['step_time_s'] for r in records],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], peak_mem_gb=peak,
         launches=counts, seconds=seconds)


def phase_train_mixtral(fk, card):
    """train_lm --model mixtral-8x7b at full width, cut to
    MIXTRAL_TRAIN_LAYERS, B=1 S=2048 --remat, 5 steps: flash forward
    2 x layers a step (remat), backward once a layer; loss, grad norm and
    the router aux loss (read from each step's forward) finite."""
    from skypilot_tpu_torch.models import mixtral
    layers, steps = MIXTRAL_TRAIN_LAYERS, 5
    argv = ['--model', 'mixtral-8x7b', '--seq', '2048', '--global-batch',
            '1', '--remat', '--steps', str(steps), '--log-every', '1']
    aux = []
    orig = mixtral.Mixtral.forward

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        if isinstance(out, tuple):
            aux.append(out[1].detach())
        return out

    mixtral.Mixtral.forward = spy
    try:
        with depth_cut('mixtral-8x7b', layers):
            _, records, counts, peak, seconds = train_family(
                'train_mixtral', argv, fk, card)
    finally:
        mixtral.Mixtral.forward = orig
    aux = [float(a) for a in aux]
    check(counts == {'flash_fwd': layers * steps * 2,
                     'flash_bwd': layers * steps},
          f'train_mixtral flash launches {counts}')
    check(len(aux) == steps and all(np.isfinite(aux)) and min(aux) > 0,
          f'train_mixtral aux losses {aux}')
    emit('train_mixtral', card=card, argv=argv,
         reduced={'num_layers': [32, layers]},
         steps=[r['step'] for r in records],
         losses=[r['loss'] for r in records], aux_losses=aux,
         grad_norms=[r['grad_norm'] for r in records],
         step_time_s=[r['step_time_s'] for r in records],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], peak_mem_gb=peak,
         launches=counts, seconds=seconds)
    return counts, records[0]


def family_parity(pk):
    """GPT-2 and Mixtral at full width, cut to 2 layers, f32 weights and
    pool: the engine's greedy tokens through the kernel (its f32 route)
    equal those through the plain version."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    out = {}
    for name in ('gpt2-124m', 'mixtral-8x7b'):
        cfg = dataclasses.replace(registry.model_config(name, 1024),
                                  num_layers=2, dtype=torch.float32)
        model = convert.init_params(cfg, seed=3, device='cuda')
        ps = family_prompts(cfg.vocab_size, seed=4, n=4)
        toks = {}
        for impl in ('cuda', 'torch'):
            counts0 = (pk.launches, pk.plain_calls)
            with pk.impl_scope(impl):
                engine = ContinuousBatchingEngine(
                    model, num_slots=4, max_total_len=1024,
                    prefill_chunk=64)
                try:
                    futs = [engine.submit(p, max_new_tokens=16) for p in ps]
                    toks[impl] = [f.result(timeout=600) for f in futs]
                finally:
                    engine.stop()
            routed = (pk.launches - counts0[0] if impl == 'cuda'
                      else pk.plain_calls - counts0[1])
            check(routed > 0, f'{name} parity: impl {impl} never taken')
            del engine
            gc.collect()
        out[name] = {'equal': toks['cuda'] == toks['torch'],
                     'tokens_cuda': [t[-16:] for t in toks['cuda']],
                     'tokens_torch': [t[-16:] for t in toks['torch']]}
        del model
        torch.cuda.empty_cache()
    return out


# -- the DeepSeek family, int8 on DeepSeek and Mixtral, the dense path -------
# DeepSeek-V2-Lite is served at full width and depth (5.2 GB in bf16) from
# the dense slot path: MLA's latent cache has no pages.
DEEPSEEK_VOCAB = 102400
# Mixtral's int8 phase keeps 4 of its 32 layers (~11.7 GB bf16, the
# attention in int8 beside bf16 experts).
MIXTRAL_INT8_LAYERS = 4
# The examples' serve line (examples/serve_hf_llama.yaml and two more):
# the config's 128-page pool holds 2032 tokens < 2048, so the engine runs
# dense.
DENSE_FLAGS = ('--model', 'llama3-8b', '--max-total-len', '2048',
               '--continuous-batching', '--num-slots', '16', '--port', '0')


def proj_forward_count(model):
    """int8_linear calls one forward of `model` makes (its Int8Dense
    modules)."""
    from skypilot_tpu_torch.models.llama import Int8Dense
    return sum(isinstance(m, Int8Dense) for m in model.modules())


def round_bytes(model, cache_bytes):
    """Bytes a decode round reads at least: every weight but the
    embedding table (8 rows of it), and the cache it attends."""
    return cache_bytes + sum(t.numel() * t.element_size()
                             for n, t in model.state_dict().items()
                             if n != 'tok_embed')


def int8_family(label, name, model, pk, il, card, ps):
    """serve_lm --weight-dtype int8 for `--model name` beside bf16: the
    int8 burst through the kernel (every call of a forward on the card:
    launches a multiple of the model's Int8Dense count), the same burst
    on an eager unpipelined int8 runtime (bit for bit) and through the
    dequantize route (int8_linear alone on its plain version, captured
    so), all scored by the bf16 model's scoring pass: the reference's
    0.1-nat contract against the dequantize route; steady round ms of
    bf16 and int8 in turns (bf16, int8, int8, bf16)."""
    t_phase = time.perf_counter()
    model_q = int8_model(model)
    per_forward = proj_forward_count(model_q)
    kernels = (pk, il)
    flag = ['--weight-dtype', 'int8']
    rows, outs = {}, {}
    rt_b, srv_b, th_b, port_b, _ = family_runtime(name, model)
    try:
        rt_q, srv_q, th_q, port_q, setup_q = family_runtime(name, model_q,
                                                            flag)
        with il.route_scope('torch'):    # graphs captured on the plain route
            rt_d, srv_d, th_d, port_d, _ = family_runtime(name, model_q,
                                                          flag)
        try:
            rows['int8'], outs['int8'] = burst(rt_q, port_q, ps,
                                               [None] * len(ps), kernels)
            with il.route_scope('torch'):
                rows['int8_dequant'], outs['int8_dequant'] = burst(
                    rt_d, port_d, ps, [None] * len(ps), kernels)
            rows['bf16'], outs['bf16'] = burst(rt_b, port_b, ps,
                                               [None] * len(ps), kernels)
            turns = []
            for tag, rt, port in (('bf16', rt_b, port_b),
                                  ('int8', rt_q, port_q),
                                  ('int8', rt_q, port_q),
                                  ('bf16', rt_b, port_b)):
                turns.append([tag, steady_turn(rt, port, ps)[0]])
            weight_bytes = {'bf16': rt_b.weight_bytes,
                            'int8': rt_q.weight_bytes}
            stats_q = json.loads(get_raw(port_q, '/stats'))
        finally:
            stop_runtime(rt_d, srv_d, th_d)
            stop_runtime(rt_q, srv_q, th_q)
        eager = family_runtime(name, model_q, [*flag, '--no-pipeline-decode'],
                               cuda_graphs=False)
        try:
            rows['int8_eager'], outs['int8_eager'] = burst(
                eager[0], eager[3], ps, [None] * len(ps), kernels)
        finally:
            stop_runtime(*eager[:3])
        scores = {tag: [mean_logprob(rt_b, r, len(p))
                        for r, p in zip(rs, ps)]
                  for tag, rs in rows.items()}
    finally:
        stop_runtime(rt_b, srv_b, th_b)
    counts = {tag: outs[tag].pop('counts')
              for tag in ('int8', 'int8_dequant', 'bf16', 'int8_eager')}
    by_rows = outs['int8'].pop('launches_by_rows')[1]
    by_route = outs['int8'].pop('launches_by_route')[1]
    (_, pa_plain), (i8, i8_plain) = counts['int8']
    check(i8 > 0 and i8_plain == 0 and i8 % per_forward == 0,
          f'{label}: int8_linear {i8} launches ({per_forward} a forward), '
          f'{i8_plain} plain calls')
    check(all(any(key.startswith(f'{r} ') for key in by_route)
              for r in ('mma', 'wgmma')),
          f'{label}: int8_linear routes {by_route}: decode calls take '
          f'mma, prefill chunks wgmma')
    check(counts['int8_dequant'][1][0] == 0
          and counts['int8_dequant'][1][1] > 0,
          f'{label}: the dequantize route launched int8_linear '
          f'{counts["int8_dequant"]}')
    check(pa_plain == 0 and counts['bf16'][1] == (0, 0),
          f'{label}: plain paged calls, or int8 code on bf16 weights '
          f'{counts}')
    check(outs['int8']['graph_replays'] > 0, f'{label}: no graph replay')
    check(rows['int8'] == rows['int8_eager'],
          f'{label}: int8 graph-replayed, pipelined tokens differ from '
          f'eager, unpipelined ones')
    contract = contract_summary(scores, 'int8_dequant')
    check(contract['int8']['mean_diff'] >= -INT8_LOGPROB_TOL,
          f'{label}: mean log-prob {contract["int8"]} against the '
          f'dequantize route (tolerance {INT8_LOGPROB_TOL})')
    check(stats_q['storage']['weight_dtype'] == 'int8'
          and stats_q['storage']['weight_bytes'] == tensor_bytes(model_q),
          f'{label}: /stats storage {stats_q["storage"]}')
    out = dict(
        card=card, model=name, layers=model.config.num_layers,
        int8_projections_a_forward=per_forward, setup_s=setup_q,
        bursts=outs, counts=counts, int8_launches_by_rows=by_rows,
        int8_launches_by_route=by_route,
        weight_bytes=weight_bytes,
        weight_bytes_saved=weight_bytes['bf16'] - weight_bytes['int8'],
        logprob_tolerance=INT8_LOGPROB_TOL,
        contract_vs_dequantize=contract,
        reference_form_vs_bf16=contract_summary(scores, 'bf16'),
        scores=scores, eager_equal=True, steady_round_ms_turns=turns,
        phase_s=time.perf_counter() - t_phase)
    del model_q
    gc.collect()
    torch.cuda.empty_cache()
    return out, i8


def phase_serve_deepseek(pk, il, card):
    """deepseek-v2-lite at full width and depth, seeded on the card,
    through serve_lm's flags on the dense slot path: the serving burst
    (graph rounds == eager unpipelined rounds), --speculative 4 against
    the plain engine, then the same with --weight-dtype int8. Returns
    int8_linear's launches on the int8 burst by row count M; the model
    is freed."""
    from skypilot_tpu_torch.models import convert, registry
    t0 = t_phase = time.perf_counter()
    cfg = registry.model_config('deepseek-v2-lite', 1024)
    model = convert.init_params(cfg, seed=0, device='cuda')
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ps = prompts(vocab=DEEPSEEK_VOCAB)
    out, _, rows, _ = serve_family('serve_deepseek', 'deepseek-v2-lite',
                                   model, (pk,), card, ps=ps, dense=True)
    # --speculative 4: the verify chunk's einsums sum in another order
    # than the single-token round's, so at bf16 a row may part from the
    # plain engine's only at a near tie (top-2 margin <= PART_MARGIN_TOL).
    spec = family_runtime('deepseek-v2-lite', model, ['--speculative', '4'])
    try:
        spec_rows, spec_out = burst(spec[0], spec[3], ps, [None] * len(ps),
                                    (pk,))
        parts = [part_margin(spec[0], a, b) for a, b in zip(rows, spec_rows)]
    finally:
        stop_runtime(*spec[:3])
    del spec
    spec_out.pop('counts')
    for pos, margin in parts:
        check(pos is None or margin <= PART_MARGIN_TOL,
              f'serve_deepseek: --speculative 4 parts from the plain '
              f'engine at {pos} with top-2 margin {margin}')
    read = round_bytes(model, out['kv_cache_bytes'])
    bound = 1e3 * read / HBM_BYTES_PER_S
    out['phase_s'] = time.perf_counter() - t_phase
    emit('serve_deepseek', **out, init_s=init_s,
         parameters=sum(p.numel() for p in model.parameters()),
         latent_cache_bytes=out['kv_cache_bytes'], round_bytes=read,
         round_bound_ms=bound,
         round_over_bound=(out['decode_round_ms'] / bound
                           if out['decode_round_ms'] else None),
         speculative={'tokens_equal': spec_rows == rows,
                      'parts': parts, 'part_margin_tol': PART_MARGIN_TOL,
                      'tokens_per_call': spec_out['tokens_per_call'],
                      'decode_rounds': spec_out['decode_rounds'],
                      'wall_s': spec_out['wall_s']})
    int8_out, _ = int8_family(
        'serve_deepseek_int8', 'deepseek-v2-lite', model, pk, il, card, ps)
    emit('serve_deepseek_int8', **int8_out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return int8_out['int8_launches_by_route']


def phase_serve_mixtral_int8(pk, il, card):
    """mixtral-8x7b at full width cut to MIXTRAL_INT8_LAYERS, serve_lm
    --weight-dtype int8: int8_linear on the four attention projections
    only, the expert stacks bf16; the gates of `int8_family`."""
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.llama import Int8Dense
    cfg = dataclasses.replace(registry.model_config('mixtral-8x7b', 1024),
                              num_layers=MIXTRAL_INT8_LAYERS)
    model = convert.init_params(cfg, seed=0, device='cuda')
    model_q = int8_model(model)
    int8_names = sorted(n for n, m in model_q.named_modules()
                        if isinstance(m, Int8Dense))
    want = sorted(f'layers.{i}.attn.{p}' for i in range(cfg.num_layers)
                  for p in ('wq', 'wk', 'wv', 'wo'))
    experts = {n: str(t.dtype) for n, t in model_q.state_dict().items()
               if '.moe.w_' in n}
    del model_q
    check(int8_names == want, f'serve_mixtral_int8: int8 modules '
                              f'{int8_names[:6]}')
    check(set(experts.values()) == {'torch.bfloat16'},
          f'serve_mixtral_int8: expert stacks {set(experts.values())}')
    out, _ = int8_family('serve_mixtral_int8', 'mixtral-8x7b', model, pk,
                         il, card, family_prompts(cfg.vocab_size))
    emit('serve_mixtral_int8', **out,
         reduced={'num_layers': [32, cfg.num_layers]},
         int8_modules=len(int8_names), expert_stack_dtypes=experts)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def dense_runtime(model, extra=(), cuda_graphs=True):
    """build_runtime with the examples' serve line (DENSE_FLAGS), sharing
    `model`'s weights, and make_server on an ephemeral port."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    t0 = time.perf_counter()
    rt = build_runtime(serve_lm.parse_args([*DENSE_FLAGS, *extra]),
                       model=model, cuda_graphs=cuda_graphs)
    setup_s = time.perf_counter() - t0
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return rt, server, thread, server.server_address[1], setup_s


# -- tensor x pipeline serving (serve_lm --tensor / --stages) -----------------
# One card named twice: every shard's kernels launch at their sharded
# shapes on the card, and the collectives' copies are same-card copies.
TP_DEVICES = ['cuda:0', 'cuda:0']
# A per-device pool budget small enough for the 8 requests on both
# shards of the one card beside the weights.
TP_POOL = ['--kv-pool-bytes', '1500000000']


def tp_runtime(model, kv_dtype, extra=()):
    """`serve_runtime` over TP_DEVICES: serve_lm's flags, the runtime
    built with build_runtime(devices=...)."""
    from skypilot_tpu_torch.inference.http_server import make_server
    from skypilot_tpu_torch.inference.runtime import build_runtime
    from skypilot_tpu_torch.recipes import serve_lm
    args = serve_lm.parse_args([
        '--model', 'llama3-8b', '--continuous-batching', '--num-slots', '8',
        '--max-total-len', '1024', '--prefill-chunk', '256', '--kv-dtype',
        kv_dtype, *TP_POOL, '--port', '0', *extra])
    t0 = time.perf_counter()
    rt = build_runtime(args, model=model, devices=TP_DEVICES)
    setup_s = time.perf_counter() - t0
    server = make_server(rt, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return rt, server, thread, server.server_address[1], setup_s


def tp_burst(label, model, kv_dtype, extra, kernels, models=None):
    """One serving burst over the grid: its numbers, the kernel counts,
    and whether the pool shards kept their storage."""
    rt, server, thread, port, setup_s = tp_runtime(model, kv_dtype, extra)
    try:
        eng = rt.engine
        ptrs = eng.cache.data_ptrs()
        reductions = eng.model.grid.reductions
        _, out = burst(rt, port, prompts(), models or [None] * 8, kernels)
        out['collective_route'] = eng.model.grid.collective_route()
        out.update(setup_s=setup_s, pool_storage_unchanged=(
            eng.cache.data_ptrs() == ptrs),
            collectives=eng.model.grid.reductions - reductions,
            stages=eng.stages, kv_shard_ways=eng.kv_shard_ways,
            mesh_devices=eng.mesh_devices,
            shard_heads=[eng.model.blocks[0][0].attn.num_heads,
                         eng.model.blocks[0][0].attn.num_kv_heads],
            pool_bytes_per_device=eng.kv_cache_bytes_per_device(),
            pool_bytes=eng.kv_cache_bytes())
    finally:
        stop_runtime(rt, server, thread)
    check(out['pool_storage_unchanged'], f'{label}: a pool shard moved')
    check(out['cuda_graphs'] and out['graph_replays'] > 0,
          f'{label}: the rounds did not replay CUDA graphs on one card')
    routes = out['paged_route_launches']
    check(routes['split'] > 0 and routes['chunk'] > 0
          and routes['scalar'] == 0,
          f'{label}: paged launches by route {routes}')
    for k, (launches, plain_calls) in zip(kernels, out['counts']):
        check(plain_calls == 0, f'{label}: {k.__name__} took its plain '
                                f'version {plain_calls} times')
    return out


def f32_grid_parity(name, layers, ps, n_new):
    """`name`'s full widths cut to `layers` layers, f32, seeded on the
    card: greedy tokens of a --tensor 2 grid engine against the
    single-device engine, the same weights (the shards view them)."""
    from skypilot_tpu_torch.models import batching, convert, registry
    from skypilot_tpu_torch.parallel import serving
    from skypilot_tpu_torch.parallel.mesh import MeshConfig
    cfg = dataclasses.replace(registry.model_config(name, 1024),
                              num_layers=layers, dtype=torch.float32)
    model = convert.init_params(cfg, seed=1, device=TP_DEVICES[0])

    def run(m):
        eng = batching.ContinuousBatchingEngine(m, num_slots=4,
                                                max_total_len=1024)
        try:
            futs = [eng.submit(p, max_new_tokens=n_new) for p in ps]
            return [f.result(timeout=600) for f in futs], eng
        finally:
            eng.stop()

    one, _ = run(model)
    grid = serving.build(model, MeshConfig(tensor=2), devices=TP_DEVICES)
    two, eng = run(grid)
    out = {'model': name, 'layers': layers, 'dtype': 'f32',
           'prompts': len(ps), 'new_tokens': n_new,
           'tokens_equal': two == one, 'paged': eng.paged,
           'kv_shard_ways': eng.kv_shard_ways,
           'shard_heads': grid.blocks[0][0].attn.num_heads}
    del model, grid, eng
    gc.collect()
    torch.cuda.empty_cache()
    check(out['tokens_equal'], f'f32 --tensor 2 tokens differ from one '
                               f'device: {out}')
    return out


def phase_serve_tp(model, pk, lk, il, card):
    """serve_lm --tensor 2 / --stages 2 at Llama-3-8B's full width and
    depth over one card named twice, sharing `model`'s tensors: bursts
    on bf16 and int8 pools, at --stages 2, with int8 weights and with
    adapters (serve_lora's), every one through the kernels at their
    sharded shapes with no plain call; then exact f32 greedy tokens of
    2-layer Llama-3-8B and DeepSeek-V2-Lite under --tensor 2 against one
    device. Returns the paged launches by route of the --tensor 2 runs
    (one shard's heads; the --stages 2 run's whole heads are emitted
    apart), the QKV LoRA launches and the int8_linear launches by
    `route_key` of the sharded runs, and their plain calls (0: each
    run's gate)."""
    from skypilot_tpu_torch.ops import grid_collective as gcol
    t_phase = time.perf_counter()
    runs, routes = {}, dict.fromkeys(pk.ROUTES, 0)
    gcol.launches_by_size.clear()
    for label, kv_dtype, extra in (
            ('tensor2_bf16', 'bf16', ['--tensor', '2']),
            ('tensor2_int8kv', 'int8', ['--tensor', '2']),
            ('stages2_bf16', 'bf16', ['--stages', '2'])):
        out = tp_burst(label, model, kv_dtype, extra, (pk, lk, gcol))
        check(out['counts'][1] == (0, 0), f'{label}: LoRA code ran')
        # --stages 2 on one card has nothing to sum and no card to cross.
        check((out['counts'][2][0] > 0) == label.startswith('tensor2_'),
              f'{label}: grid collective launches {out["counts"][2]}')
        runs[label] = out
        if label.startswith('tensor2_'):
            for r, n in out['paged_route_launches'].items():
                routes[r] += n
    lora = tp_burst('tensor2_lora', model, 'bf16',
                    ['--tensor', '2', '--adapter-dir',
                     os.path.join(WORK, 'adapters'), '--max-adapters', '3'],
                    (pk, lk, gcol), models=SERVE_LORA_MODELS)
    check(lora['counts'][1][0] > 0, 'tensor2_lora: no QKV LoRA launch')
    check(lora['counts'][2][0] > 0, 'tensor2_lora: no grid collective '
                                    'launch')
    runs['tensor2_lora'] = lora
    for r, n in lora['paged_route_launches'].items():
        routes[r] += n
    qmodel = int8_model(model)
    il.launches_by_shape.clear()
    il.launches_by_route.clear()
    int8 = tp_burst('tensor2_int8_weights', qmodel, 'bf16',
                    ['--tensor', '2', '--weight-dtype', 'int8'],
                    (pk, il, gcol))
    int8_by_shape = dict(il.launches_by_shape)
    int8_by_route = route_shape_delta(il, {})
    check(all(any(key.startswith(f'{r} ') for key in int8_by_route)
              for r in ('mma', 'wgmma')),
          f'tensor2_int8_weights: int8_linear routes {int8_by_route}')
    for proj in INT8_TP2_ROWS:
        shape = INT8_SHAPES['llama3_8b_tp2'][proj]
        check(int8_by_shape.get(shape, 0) > 0,
              f'tensor2_int8_weights: no int8_linear launch at {proj} '
              f'{shape}: {int8_by_shape}')
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    check(int8['counts'][1][0] > 0, 'tensor2_int8_weights: no int8_linear '
                                    'launch')
    check(int8['counts'][2][0] > 0, 'tensor2_int8_weights: no grid '
                                    'collective launch')
    runs['tensor2_int8_weights'] = int8
    for r, n in int8['paged_route_launches'].items():
        routes[r] += n
    rng = np.random.default_rng(5)
    parity = [
        f32_grid_parity('llama3-8b', 2, [rng.integers(
            1, 128256, int(n)).tolist() for n in (40, 300, 17)], 16),
        f32_grid_parity('deepseek-v2-lite', 2, [rng.integers(
            1, DEEPSEEK_VOCAB, int(n)).tolist() for n in (40, 200)], 16)]
    plain_calls = sum(p for out in runs.values() for _, p in out['counts'])
    emit('serve_tp', card=card, devices=TP_DEVICES, runs={
        label: {k: v for k, v in out.items() if k != 'counts'}
        for label, out in runs.items()}, f32_parity=parity,
        paged_route_launches=routes,
        stages2_paged_route_launches=runs['stages2_bf16'][
            'paged_route_launches'],
        int8_launches_by_shape={f'{n}x{k}': c for (n, k), c
                                in sorted(int8_by_shape.items())},
        int8_launches_by_route=int8_by_route,
        collective_launches={f'{op} {n}': c for (op, n), c
                             in sorted(gcol.launches_by_size.items())},
        plain_calls=plain_calls, phase_s=time.perf_counter() - t_phase)
    return (routes, lora['counts'][1][0], int8_by_route, plain_calls,
            dict(gcol.launches_by_size))


def drive_engine(eng, ps, n_new):
    """Greedy tokens of `ps`, the engine iterated on this thread (its
    scheduler stopped), so two engines schedule them alike; and its
    steady round ms."""
    # pylint: disable=protected-access
    eng.stop()
    futs = [eng.submit(list(p), max_new_tokens=n_new) for p in ps]
    s0 = eng.stats()
    with torch.no_grad():
        for _ in range(20000):
            if all(f.done() for f in futs) and not eng.active.any() \
                    and not eng._in_flight():
                break
            eng._iterate()
    s1 = eng.stats()
    rounds = s1['steady_decode_rounds'] - s0['steady_decode_rounds']
    ms = (1e3 * (s1['steady_decode_s'] - s0['steady_decode_s']) / rounds
          if rounds else None)
    return [f.result(timeout=1) for f in futs], ms, s1


def phase_serve_tp_2card(model, gcol, card):
    """Where two cards are visible: the --tensor 2 engine over cuda:0 and
    cuda:1 against the same engine on cuda:0 named twice (TP_DEVICES),
    both driven on this thread: the same greedy tokens, the collective
    on both cards with no plain call, and both grids' steady round ms."""
    from skypilot_tpu_torch.models import batching
    from skypilot_tpu_torch.parallel import serving
    from skypilot_tpu_torch.parallel.mesh import MeshConfig
    count = torch.cuda.device_count()
    if count < 2:
        emit('serve_tp_2card', card=card, ran=False,
             reason=f'{count} card visible: the 2-card grid needs 2')
        return None
    from skypilot_tpu_torch.models import convert
    t_phase = time.perf_counter()
    ps = prompts()
    out = {}
    # A pool that holds all 8 slots at full length (the weights shared).
    cfg = model.config
    pages = model.config.kv_total_pages
    pages = max(pages, 8 * (1024 // cfg.kv_page_size) + 1)
    pooled = convert.assemble(dataclasses.replace(cfg, kv_total_pages=pages),
                              model.state_dict())
    for label, devices in (('one_card_x2', TP_DEVICES),
                           ('cards2', ['cuda:0', 'cuda:1'])):
        grid = serving.build(pooled, MeshConfig(tensor=2), devices=devices)
        eng = batching.ContinuousBatchingEngine(
            grid, num_slots=8, max_total_len=1024, prefill_chunk=256)
        by_device = dict(gcol.launches_by_device)
        plain = gcol.plain_calls
        try:
            tokens, ms, stats = drive_engine(eng, ps, 32)
        finally:
            eng.stop()
        out[label] = {
            'tokens': tokens, 'decode_round_ms': ms,
            'cuda_graphs': stats['cuda_graphs'],
            'graph_replays': stats['graph_replays'],
            'collective_route': grid.grid.collective_route(),
            'collective_launches_by_device': {
                d: n - by_device.get(d, 0)
                for d, n in gcol.launches_by_device.items()
                if n != by_device.get(d, 0)},
            'collective_plain_calls': gcol.plain_calls - plain}
        del grid, eng
        gc.collect()
        torch.cuda.empty_cache()
    two, one = out['cards2'], out['one_card_x2']
    equal = two.pop('tokens') == one.pop('tokens')
    emit('serve_tp_2card', card=card, ran=True, tokens_equal=equal,
         **out, phase_s=time.perf_counter() - t_phase)
    check(equal, 'serve_tp_2card: tokens over two cards differ from one '
                 'card named twice')
    check(two['cuda_graphs'] and two['graph_replays'] > 0,
          'serve_tp_2card: the rounds did not replay graphs')
    check(sorted(two['collective_launches_by_device']) == ['cuda:0',
                                                           'cuda:1']
          and two['collective_plain_calls'] == 0,
          f'serve_tp_2card: collective {two}')
    return out


def phase_serve_dense(model, pk, lk, card):
    """Llama-3-8B through the examples' serve line, no --kv-pool-bytes:
    the dense slot path. The serving burst (graph rounds == eager
    unpipelined rounds, no paged kernel), steady round ms beside the
    paged engine's (serve_bf16's flags) in turns, then serve_lora's
    adapters and request mix with the QKV LoRA kernel in dense graph
    rounds."""
    t_phase = time.perf_counter()
    ps = prompts()
    kernels = (pk, lk)
    rt, server, thread, port, setup_s = dense_runtime(model)
    try:
        eng = rt.engine
        check(eng.paged is False and eng.attention_impl() == 'dense'
              and eng.prefix_caching is False,
              f'serve_dense: paged {eng.paged}, {eng.attention_impl()}')
        cache_bytes = eng.kv_cache_bytes()
        with dispatch_device_ms(eng) as device_ms:
            rows, out = burst(rt, port, ps, [None] * len(ps), kernels)
        paged = serve_runtime(model, 'bf16')
        try:
            turns = []
            for tag, r, p in (('dense', rt, port), ('paged', paged[0],
                                                    paged[3]),
                              ('paged', paged[0], paged[3]),
                              ('dense', rt, port)):
                turns.append([tag, steady_turn(r, p, ps)[0]])
        finally:
            stop_runtime(*paged[:3])
        del paged
    finally:
        stop_runtime(rt, server, thread)
    del rt, server, thread
    gc.collect()
    eager = dense_runtime(model, ['--no-pipeline-decode'], cuda_graphs=False)
    try:
        eager_rows, eager_out = burst(eager[0], eager[3], ps,
                                      [None] * len(ps), kernels)
    finally:
        stop_runtime(*eager[:3])
    del eager
    gc.collect()
    root = os.path.join(WORK, 'adapters')
    lora = dense_runtime(model, ['--adapter-dir', root, '--max-adapters',
                                 '3'])
    try:
        check(lora[0].engine.paged is False, 'serve_dense: LoRA runtime is '
                                             'paged')
        lora_rows, lora_out = burst(lora[0], lora[3], ps, SERVE_LORA_MODELS,
                                    kernels)
    finally:
        stop_runtime(*lora[:3])
    del lora
    gc.collect()
    torch.cuda.empty_cache()
    counts = {'base': out.pop('counts'), 'eager': eager_out.pop('counts'),
              'adapters': lora_out.pop('counts')}
    check(all(c[0] == (0, 0) for c in counts.values()),
          f'serve_dense: paged attention ran on the dense path {counts}')
    check(counts['base'][1] == (0, 0),
          f'serve_dense: base-only serving ran LoRA code {counts}')
    check(out['graph_replays'] > 0 and lora_out['graph_replays'] > 0,
          'serve_dense: no graph rounds')
    check(rows == eager_rows, 'serve_dense: graph-replayed, pipelined '
                              'tokens differ from eager, unpipelined ones')
    (lora_launches, lora_plain) = counts['adapters'][1]
    # A LoRA graph round carries the QKV LoRA launches of its capture:
    # more launches than the prefill chunks' alone means decode rounds
    # replayed it.
    check(lora_launches > 32 * lora_out['prefill_chunks'] and
          lora_plain == 0 and lora_out['graph_captures'] > 0,
          f'serve_dense adapters: QKV LoRA {counts["adapters"]}, '
          f'{lora_out["prefill_chunks"]} prefill chunks, '
          f'{lora_out["graph_captures"]} captures')
    base = [i for i, m in enumerate(SERVE_LORA_MODELS) if m is None]
    check(all(lora_rows[i] == rows[i] for i in base),
          'serve_dense: base requests beside adapters differ from the '
          'base burst')
    check(any(lora_rows[i] != rows[i] for i, m in
              enumerate(SERVE_LORA_MODELS) if m is not None),
          'serve_dense: no adapter changed an answer')
    steady = sorted(device_ms)[len(device_ms) // 2] if device_ms else None
    dense_ms = [ms for tag, ms in turns if tag == 'dense']
    paged_ms = [ms for tag, ms in turns if tag == 'paged']
    emit('serve_dense', card=card, flags=list(DENSE_FLAGS), setup_s=setup_s,
         **out, dense_cache_bytes=cache_bytes, eager_equal=True,
         eager_decode_round_ms=eager_out['decode_round_ms'],
         device_round_ms=steady, device_dispatches=len(device_ms),
         device_busy_share=(steady / out['decode_round_ms']
                            if steady and out['decode_round_ms'] else None),
         steady_round_ms_turns=turns,
         dense_over_paged=(float(np.mean(dense_ms)) / float(np.mean(paged_ms))
                           if paged_ms else None),
         adapters={'models': SERVE_LORA_MODELS, **lora_out,
                   'qkv_lora_launches': lora_launches,
                   'qkv_lora_plain_calls': lora_plain},
         counts=counts, phase_s=time.perf_counter() - t_phase)


def dense_parity(llama_model, ps, models, root, want):
    """Greedy parity on the dense path, f32: the 2-layer Llama-width
    model (with the parity adapters) on a dense engine gives the paged
    engine's tokens `want` (the kernel route), and DeepSeek-V2-Lite's
    width cut to 2 layers gives the same tokens from graph rounds and
    eager rounds."""
    from skypilot_tpu_torch.inference.adapters import AdapterRegistry
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
    t0 = time.perf_counter()

    def run(model, prompts_, models_, **kw):
        engine = ContinuousBatchingEngine(model, num_slots=4,
                                          max_total_len=1024,
                                          prefill_chunk=256, **kw)
        try:
            check(engine.paged is False, 'dense parity: paged engine')
            futs = [engine.submit(p, max_new_tokens=16, adapter=m)
                    for p, m in zip(prompts_, models_)]
            return [f.result(timeout=600) for f in futs]
        finally:
            engine.stop()

    out = {'llama_dense_vs_paged': run(
        llama_model, ps, models, paged=False,
        adapter_store=AdapterRegistry(root, llama_model,
                                      max_adapters=2)) == want}
    cfg = dataclasses.replace(registry.model_config('deepseek-v2-lite',
                                                    1024),
                              num_layers=2, dtype=torch.float32)
    model = convert.init_params(cfg, seed=3, device='cuda')
    ds_ps = [p[:400] for p in prompts(seed=5, n=4, vocab=DEEPSEEK_VOCAB)]
    toks = {label: run(model, ds_ps, [None] * 4, cuda_graphs=graphs)
            for label, graphs in (('graphs', True), ('eager', False))}
    out['deepseek_graphs_vs_eager'] = toks['graphs'] == toks['eager']
    out['deepseek_tokens'] = [t[-16:] for t in toks['graphs']]
    out['seconds'] = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_deepseek(fk, card):
    """train_lm --model deepseek-v2-lite --seq 4096 (examples/
    deepseek_mla.yaml's model and sequence) --global-batch 2 --remat, 5
    steps at full depth: loss, grad norm and MFU finite; MLA's unequal
    q/v dims never reach the flash kernels."""
    steps = 5
    argv = ['--model', 'deepseek-v2-lite', '--seq', '4096',
            '--global-batch', '2', '--remat', '--steps', str(steps),
            '--log-every', '1']
    _, records, counts, peak, seconds = train_family('train_deepseek', argv,
                                                     fk, card)
    check(counts == {'flash_fwd': 0, 'flash_bwd': 0},
          f'train_deepseek launched flash: {counts}')
    check(len(records) == steps, f'train_deepseek: {len(records)} records')
    emit('train_deepseek', card=card, argv=argv,
         reduced={'global_batch': [8, 2]},
         steps=[r['step'] for r in records],
         losses=[r['loss'] for r in records],
         grad_norms=[r['grad_norm'] for r in records],
         step_time_s=[r['step_time_s'] for r in records],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], peak_mem_gb=peak,
         launches=counts, seconds=seconds)


# -- multi-card training (2-rank NCCL jobs) ----------------------------------
PARALLEL_CARDS = 2
CONTEXT_TRAIN_LAYERS = 4
PARALLEL_STEPS = 3
# Step 1 of the 2-rank jobs against the one-card run, relative. Each
# limit lies between the sound job's offset and that of the same job
# with its path broken on purpose, both measured at these shapes by
# tests/test_torch_parallel_cards.py on NVIDIA H100 80GB HBM3, 700.00 W.
# --expert 2 against train_mixtral: loss 2.56e-5 and norm 2.28e-4 off,
# all of it the order in which the experts' combines are summed before
# the bf16 cast (a one-card run that sums them in the job's order is
# within 2e-7); the combine not summed over the expert group reads
# 1.9e-3 / 0.55, the experts' input gradient not summed 0 / 0.52.
# --seq-parallel 2 against the one-card command: loss 3.51e-5 and norm
# under 1e-5 off (the ring's f32 order against flash); a ring that skips
# a rotation reads 2.2e-3 / 0.040.
EXPERT_LOSS_TOL = 1e-4
EXPERT_NORM_TOL = 1e-3
CONTEXT_TOL = 1e-4


def parallel_worker(job, argv, name, layers, out):
    """One rank of a train_lm job (train_lm's own worker) with `name`'s
    depth cut to `layers`; writes the process's flash launches, plain
    calls and ring steps to `out`/rank<r>.json."""
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.ops import ring_attention as ra
    from skypilot_tpu_torch.recipes import train_lm
    with depth_cut(name, layers):
        train_lm._run_worker(job, train_lm.parse_args(argv))
    with open(os.path.join(out, f'rank{job.rank}.json'), 'w') as f:
        json.dump({'flash_fwd': fk.fwd_launches, 'flash_bwd': fk.bwd_launches,
                   'plain_calls': fk.plain_calls,
                   'ring': [ra.fwd_steps, ra.bwd_steps]}, f)


def parallel_job(label, argv, name, layers, card):
    """`train_lm argv --metrics-file ...` as a PARALLEL_CARDS-rank NCCL
    job on cards 0.. (None, after a line saying so, when fewer cards
    are visible): (each rank's counts, rank 0's metric records,
    seconds)."""
    from skypilot_tpu_torch.observability.step_metrics import read_jsonl
    from skypilot_tpu_torch.parallel import distributed
    visible = torch.cuda.device_count()
    if visible < PARALLEL_CARDS:
        print(f'{label}: not run: {visible} CUDA card visible; the phase '
              f'is a {PARALLEL_CARDS}-rank NCCL job, one rank a card',
              flush=True)
        emit(label, card=card, ran=False, cards=visible,
             needs=PARALLEL_CARDS)
        return None
    root = os.path.join(WORK, label)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    metrics = os.path.join(root, 'metrics.jsonl')
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    code = distributed.launch(
        parallel_worker, ([*argv, '--metrics-file', metrics], name, layers,
                          root),
        distributed.jobs(cpu=False, workers=PARALLEL_CARDS),
        deadline_s=600)
    seconds = time.perf_counter() - t0
    check(code == 0, f'{label}: the {PARALLEL_CARDS}-rank job exited {code}')
    ranks = []
    for rank in range(PARALLEL_CARDS):
        with open(os.path.join(root, f'rank{rank}.json')) as f:
            ranks.append(json.load(f))
    records = read_jsonl(metrics)
    check(len(records) == PARALLEL_STEPS and all(
        np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])
        and r['mfu'] is not None for r in records),
          f'{label}: metric records {records}')
    return ranks, records, seconds


def phase_train_expert(card, mixtral_step1):
    """train_mixtral's command with --expert 2 as a 2-rank NCCL job,
    step 1 held to train_mixtral's (`mixtral_step1`, its first metric
    record); its flash launches summed over the ranks (None on one
    card)."""
    layers, steps = MIXTRAL_TRAIN_LAYERS, PARALLEL_STEPS
    argv = ['--model', 'mixtral-8x7b', '--seq', '2048', '--global-batch',
            '1', '--remat', '--steps', str(steps), '--log-every', '1',
            '--expert', str(PARALLEL_CARDS)]
    out = parallel_job('train_expert', argv, 'mixtral-8x7b', layers, card)
    if out is None:
        return None
    ranks, records, seconds = out
    for counts in ranks:
        check(counts['flash_fwd'] == 2 * layers * steps
              and counts['flash_bwd'] == layers * steps
              and counts['plain_calls'] == 0 and counts['ring'] == [0, 0],
              f'train_expert launches {ranks}')
    first, want = records[0], mixtral_step1
    loss_err = abs(first['loss'] - want['loss']) / abs(want['loss'])
    norm_err = abs(first['grad_norm'] - want['grad_norm']) / abs(
        want['grad_norm'])
    check(loss_err <= EXPERT_LOSS_TOL and norm_err <= EXPERT_NORM_TOL,
          f'train_expert step 1 {first["loss"]} / {first["grad_norm"]} vs '
          f'train_mixtral {want["loss"]} / {want["grad_norm"]}')
    emit('train_expert', card=card, ran=True, argv=argv,
         reduced={'num_layers': [32, layers]}, ranks=PARALLEL_CARDS,
         losses=[r['loss'] for r in records],
         grad_norms=[r['grad_norm'] for r in records],
         step1_loss_rel_err=loss_err, step1_norm_rel_err=norm_err,
         loss_tol=EXPERT_LOSS_TOL, norm_tol=EXPERT_NORM_TOL,
         step_time_s=[r['step_time_s'] for r in records],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], launches=ranks, seconds=seconds)
    return {name: sum(r[name] for r in ranks)
            for name in ('flash_fwd', 'flash_bwd')}


def phase_train_context(fk, card):
    """Llama-3-8B width, 4 layers, seq 8192 with --seq-parallel 2 as a
    2-rank NCCL job (ring attention), held to the same command on one
    card (flash)."""
    layers, steps = CONTEXT_TRAIN_LAYERS, PARALLEL_STEPS
    argv = ['--model', 'llama3-8b', '--seq', '8192', '--global-batch', '1',
            '--remat', '--steps', str(steps), '--log-every', '1']
    out = parallel_job('train_context', [*argv, '--seq-parallel',
                                         str(PARALLEL_CARDS)],
                       'llama3-8b', layers, card)
    if out is None:
        return
    ranks, records, seconds = out
    ways = PARALLEL_CARDS
    for counts in ranks:
        check(counts['flash_fwd'] == counts['flash_bwd'] == 0
              and counts['ring'] == [2 * layers * steps * ways,
                                     layers * steps * ways],
              f'train_context launches / ring steps {ranks}')
    with depth_cut('llama3-8b', layers):
        _, one, one_counts, one_peak, _ = train_family(
            'train_context_one_card', argv, fk, card)
    check(one_counts == {'flash_fwd': 2 * layers * steps,
                         'flash_bwd': layers * steps},
          f'train_context one-card flash launches {one_counts}')
    errs = [abs(records[0][k] - one[0][k]) / abs(one[0][k])
            for k in ('loss', 'grad_norm')]
    check(max(errs) <= CONTEXT_TOL,
          f'train_context step 1 {records[0]} vs one card {one[0]}')
    emit('train_context', card=card, ran=True,
         argv=[*argv, '--seq-parallel', str(ways)],
         reduced={'num_layers': [32, layers]}, ranks=ways,
         losses=[r['loss'] for r in records],
         grad_norms=[r['grad_norm'] for r in records],
         one_card_losses=[r['loss'] for r in one],
         one_card_grad_norms=[r['grad_norm'] for r in one],
         step1_loss_rel_err=errs[0], step1_norm_rel_err=errs[1],
         tol=CONTEXT_TOL,
         step_time_s=[r['step_time_s'] for r in records],
         one_card_step_time_s=[r['step_time_s'] for r in one],
         tokens_per_s=[r['tokens_per_sec'] for r in records],
         mfu=[r['mfu'] for r in records], one_card_peak_mem_gb=one_peak,
         ring_steps=[r['ring'] for r in ranks], seconds=seconds)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skypilot_tpu_torch.device import card_description
    from skypilot_tpu_torch.models import convert, registry
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_kernel as fk
    from skypilot_tpu_torch.ops import grid_collective as gcol
    from skypilot_tpu_torch.ops import int8_linear as il
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
    ptxas = [f'{name}: {line.strip()}'
             for name, log in _build.build_logs.items()
             for line in log.splitlines()
             if 'registers' in line or 'spill' in line]
    emit('build', seconds=time.perf_counter() - t0, ptxas=ptxas)

    paged_rows = phase_kernels(pk)
    gpt2_rows = phase_gpt2_kernels(pk)
    lora_rows = phase_lora_kernels(lk)
    flash_rows, flash_tp2_rows = phase_flash_kernels(fk)
    int8_rows = phase_int8_linear_kernels(il)
    grid_rows = phase_grid_collective_kernels(gcol)

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
    # int8 projection weights (--weight-dtype int8), counted from zero.
    il.launches = il.plain_calls = 0
    il.launches_by_route.clear()
    phase_serve_int8_weights(model, pk, lk, il, card)
    int8_by_route = route_shape_delta(il, {})
    # Decode rounds take the mma route, 256-row prefill chunks the wgmma
    # route (the phase's dequantize-route bursts are its plain calls).
    check(all(route_launches(il, r) > 0 for r in ('mma', 'wgmma')),
          f'int8 weights path: int8_linear routes {int8_by_route}')
    # The dense slot path: the examples' serve line, counted from zero.
    zero_paged(pk)
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    phase_serve_dense(model, pk, lk, card)
    # The observability plane on the multi-LoRA path, counted from zero.
    phase_observability(model, pk, lk, card)
    phase_serve_long(model, fk, pk, card)
    phase_graph_round(model, pk, card)
    verify_launches = phase_decode_modes(model, pk, lk, card)
    # The request surface, each path counted from zero.
    phase_serve_stream(model, pk, lk, fk, card)
    phase_serve_text(model, pk, lk, fk, card)
    phase_one_shot(model, pk, lk, fk, card)
    # KV page chains: export / import, the spill tiers, disaggregated
    # roles and live migration, each counted from zero.
    phase_kv_chain(model, pk, card)
    phase_kv_spill(model, pk, card)
    phase_disagg(model, pk, card)
    phase_migration(model, pk, card)
    # Tensor x pipeline serving over one card named twice, counted from
    # zero: the sharded rows of the kernels line.
    zero_paged(pk)
    pk.launches = pk.plain_calls = lk.launches = lk.plain_calls = 0
    il.launches = il.plain_calls = 0
    gcol.launches = gcol.plain_calls = 0
    tp_routes, tp_lora_launches, tp_int8_by_route, tp_plain, tp_sizes = \
        phase_serve_tp(model, pk, lk, il, card)
    phase_serve_tp_2card(model, gcol, card)
    del model
    torch.cuda.empty_cache()
    # The serving fleet: serve_fleet over serve_lm replicas, each a process
    # of its own on this card (the smoke's model freed first); their
    # counts come from each replica's /stats, every process new.
    fleet_routes = phase_serve_fleet(card)
    # GPT-2 and Mixtral through serve_lm, each counted from zero.
    zero_paged(pk)
    pk.launches = pk.plain_calls = 0
    gpt2_routes = phase_serve_gpt2(pk, card)
    zero_paged(pk)
    pk.launches = pk.plain_calls = 0
    phase_serve_mixtral(pk, card)
    # int8 weights on Mixtral, then DeepSeek-V2-Lite (bf16 and int8), each
    # counted from zero; both families are freed before training.
    zero_paged(pk)
    pk.launches = pk.plain_calls = il.launches = il.plain_calls = 0
    phase_serve_mixtral_int8(pk, il, card)
    zero_paged(pk)
    pk.launches = pk.plain_calls = il.launches = il.plain_calls = 0
    deepseek_by_route = phase_serve_deepseek(pk, il, card)
    phase_serve_hf(pk, lk, fk, card)

    phase_greedy_parity(pk, lk, fk)

    # The training paths, each counted from zero.
    full_counts, full = phase_train_full(fk, pk, card)
    torch.cuda.empty_cache()
    fsdp_counts = phase_train_fsdp(fk, card, full)
    pipe_counts, pipe_step1 = phase_train_pipeline(fk, card, full)
    tensor_counts = phase_train_tensor(fk, card, full, pipe_step1)
    lora_counts = phase_train_lora(fk, lk, card)
    torch.cuda.empty_cache()
    phase_train_gpt2(fk, card)
    mixtral_counts, mixtral_step1 = phase_train_mixtral(fk, card)
    # Multi-card training: 2-rank NCCL jobs where 2 cards are visible.
    expert_counts = phase_train_expert(card, mixtral_step1) or \
        dict.fromkeys(mixtral_counts, 0)
    phase_train_context(fk, card)
    phase_train_deepseek(fk, card)
    guard_counts = phase_train_guard(fk, card)

    for row in paged_rows:
        row['launches'] = (verify_launches
                           if row['name'] == 'paged_attention_verify'
                           else tp_routes[row['kernel_route']]
                           if row['name'].endswith('_tp2')
                           else routes[row['kernel_route']])
        if row['name'].endswith('_tp2'):
            row['launch_window'] = ('serve_tp --tensor 2 bursts (one '
                                    'shard\'s heads)')
            row['plain_calls'] = tp_plain
        elif row['name'] in ('paged_attention', 'paged_attention_chunk'):
            # The same kernel at the same heads in the fleet's replicas.
            row['fleet_launches'] = fleet_routes[row['kernel_route']]

    for row in gpt2_rows:
        row['launches'] = gpt2_routes[row['kernel_route']]
    lora_rows[0]['launches'] = lora_launches
    lora_rows[1]['launches'] = tp_lora_launches
    lora_rows[1]['launch_window'] = 'serve_tp tensor2_lora burst'
    lora_rows[1]['plain_calls'] = tp_plain
    # The int8 rows: launches on the row's route at its weight shape in the
    # window of its model: serve_int8_weights (Llama-3-8B), the
    # serve_deepseek_int8 burst, serve_tp's int8 --tensor 2 burst.
    for row in int8_rows:
        key = route_key(row['kernel_route'], *row['shape'])
        if row['name'].startswith('int8_linear_tp2_'):
            row['launches'] = tp_int8_by_route.get(key, 0)
            row['launch_window'] = ('serve_tp tensor2_int8_weights burst, '
                                    + key)
            row['plain_calls'] = tp_plain
        elif '_k10944_' in row['name']:
            row['launches'] = deepseek_by_route.get(key, 0)
            row['launch_window'] = 'serve_deepseek_int8 burst, ' + key
        else:
            row['launches'] = int8_by_route.get(key, 0)
            row['launch_window'] = 'serve_int8_weights, ' + key
    for row in grid_rows:
        row['launches'] = tp_sizes.get(row.pop('size_key'), 0)
        row['launch_window'] = 'serve_tp --tensor 2 bursts (bf16 sums)'
        row['plain_calls'] = tp_plain
    for name, row in flash_rows.items():
        row['launches'] = (full_counts[name] + fsdp_counts[name]
                           + pipe_counts[name]
                           + lora_counts[name] + mixtral_counts[name]
                           + expert_counts[name] + guard_counts[name])
    # The shard-head rows: train_tensor's steps, readings, its pipeline
    # reading and its 2-card job's ranks where it runs.
    for name, row in flash_tp2_rows.items():
        row['launches'] = tensor_counts[name]
        row['launch_window'] = 'train_tensor (--tensor 2 shards\' heads)'
    emit('clock', seconds=dict(CLOCK['seconds']),
         total_s=time.perf_counter() - START)
    print(card, flush=True)
    print(json.dumps({'kernels': [*paged_rows, *gpt2_rows, *lora_rows,
                                  *flash_rows.values(),
                                  *flash_tp2_rows.values(), *int8_rows,
                                  *grid_rows]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:  # pylint: disable=broad-except
        traceback.print_exc()
        # Where the time went up to the failure.
        emit('clock', seconds=dict(CLOCK['seconds']),
             total_s=time.perf_counter() - START, failed=True)
        code = 1
    sys.exit(code)
