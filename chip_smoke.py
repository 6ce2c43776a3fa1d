#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python3 chip_smoke.py

Phases (any failure fails the run, exit code != 0):

1. Print the card's name and power limit (nvidia-smi), then build every
   kernel source under distributed_llm_inferencing_tpu_torch/csrc/ with
   nvcc for sm_90a (one nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card: the
   serving path's shapes (llama-3-8b, bf16: prefill B=1 H=32 Hkv=8
   hd=128 at S=512, 2048 and 4096, through the tensor-core form; decode
   over a 4096-slot cache at B=4 lengths [1, 37, 1000, 4096], B=1 at 532
   and 4096, and a tp=2 rank's H=16 Hkv=4 at 4096 (the B=1 rows also
   time SDPA on the cache sliced to the length, library_sliced_ms);
   paged decode and fused decode
   R=8 bs=16 over a 2048-block pool, context lengths
   [0, 1, 15, 16, 17, 300, 1000, 4096], the fused q weight [4096, 4096],
   the last two in f32 as well; both also at full occupancy, every slot
   at 4096 with no block shared; the fused kernel in its float, int8 and
   int4 weight forms, its timed rows with ``unfused_ms``, the device time
   of the port's unfused route on the same inputs: the model's Linear for
   the form, RoPE, paged_flash_decode) plus small f32, sliding-window,
   ALiBi, MQA/MHA, head_dim 8-256, ragged-tile, split-edge, row-group
   (R=9, 17) and zero-length cases. The split-KV decodes and the fused
   kernel are bit-identical across two launches; each fused row reports
   err_over_tol and the kernel's launch plan (cluster size, slots per row
   group, attention teams) is printed. The paged and
   fused decodes in bf16 are held to one bf16 ulp (PAGED_BF16_TOL).
   q4_matmul at llama-3-8b's linear and head shapes for b in {1, 8, 32},
   x in bf16 (the tensor-core form) and f32 (the CUDA-core form), and
   tests/test_pallas_parity.py's odd shapes, within Q4_TOL and
   bit-identical across two launches; err_over_tol is each row's margin.
   Every kernel row is device time from torch.profiler over L2-cold
   inputs, in a trace shown to hold every kernel of the timed calls
   (the port's ops/trace.py bracketed_trace) ("ms", the library times
   too; "event_ms" the CUDA events around the wrapper). Times the kernel, its plain version
   and one torch call computing the same function
   (scaled_dot_product_attention, for paged decode on K/V gathered
   beforehand and, as library_gather_ms, with the gather in the timed
   call; for q4_matmul torch.matmul on a bf16
   weight dequantized beforehand, and torch._weight_int4pack_mm where the
   installed torch has it; yardsticks only, the port never calls them;
   none for the fused kernel, which gets unfused_ms), and works out the
   bound: the larger of
   bytes / 3.35 TB/s and operations / peak rate. The softcap arms
   (phase_softcap_kernels): flash_attention (both forms), flash_decode
   and paged_flash_decode with gemma-2's score cap, held to their plain
   versions (bf16 and f32, hd 128 and 256, GQA and MQA, windows, odd
   lengths, ALiBi, caps 0.5-50; same bits on a relaunch) and timed at
   gemma-2-9b's shapes (prefill S=512 and 4096, decode B=1 at 4500 keys,
   paged R=8 at full occupancy) beside the uncapped arm
   ("uncapped_ms") and SDPA without a cap (it has none: the pace only).
   Without a cap each of the three kernels must give the bits it gave
   before the cap arm existed: digests of their outputs on fixed inputs
   (uncapped_digests) equal UNCAPPED_DIGESTS.
3. The engine path: the port's worker on a localhost port serves
   full-width llama-3-8b (random weights from a seed, bf16, max_seq 4096)
   through POST /load_model and three POST /inference requests in
   different prefill buckets (one greedy, two sampled, 32 new tokens).
   Kernel launch counts are zeroed just before and read just after (a
   replayed decode program counts what its capture recorded; see 13),
   and each request must add one flash_attention launch per layer, each in
   the tensor-core form (the "flash_attention[mma]" count), and one
   flash_decode launch per layer per decode step, and no other. Every
   bf16 q4_matmul / q4_matmul_row call of phases 7, 9 and 10 must run in
   its tensor-core form ("q4_matmul[mma]", "q4_matmul_row[mma]").
4. Cross-check at full width and reduced depth (2 layers, f32): the same
   weights through the kernels on the card and through the plain
   versions on the CPU — the dense path (teacher-forced prefill plus 8
   decode steps) and the paged path (paged_prefill_tail with a cached
   prefix plus 8 paged_decode_steps), once through paged_flash_decode and
   once through fused_decode_step.
5. The batched path: the worker loads llama-3-8b bf16 with
   "serving": "batched" (8 slots, 1024 blocks of 16, max_seq 4096) and
   serves 8 concurrent requests (prompts of 60-1000 tokens, two sharing a
   512-token prefix, greedy and sampled, 32 new tokens), once with
   DLI_FUSED_DECODE off and once on. Counts are zeroed before each pass:
   the pass's decode kernel must launch num_layers times per weight pass
   of the batcher, and no other attention kernel may launch.
6. Both decode routes at full depth: phase 5's prompts through
   llama-3-8b with one set of weights in bf16 and in f32, a paged
   prefill and ROUTE_STEPS decode steps (f32 greedy; bf16 through each
   kernel fed the same tokens). Reports the f32 top-1/top-2 logit gaps
   and each route's logit error against f32; each route's error must
   stay within ROUTE_ERR_FACTOR times the bf16 prefill's. Then the same
   prompts through engine-mode (dense) prefill in bf16, the attention
   once through the tensor-core flash_attention and once through
   flash_attention_ref on the card (swapped in by this script only),
   each against the f32 model over every real row: the kernel's worst
   error must stay within ROUTE_ERR_FACTOR times the plain route's.
7. Quantized serving: the worker loads llama-3-8b (bf16 activations) with
   "quantize": "int4" — phase 3's requests in engine mode, then phase 5's
   wave batched with DLI_FUSED_DECODE off and on — and with "quantize":
   "int8", batched, fused on. Counts are zeroed before each pass and the
   gate's exact numbers asserted: in int4 a decode weight pass of <= 32
   rows launches q4_matmul 7 x num_layers + 1 times (6 x num_layers + 1
   with the fused q), a prefill of more rows only for its gathered head
   rows. Reports stored weight bytes, peak memory, ms per weight pass and
   tokens/s beside phases 3 and 5.
8. Phase 4's cross-check with int4 and with int8 weights. The host
   model's int8/int4 linears widen their levels to f32 once
   (``_widen_levels_once``: the plain path's arithmetic, bit for bit on
   the CPU at tiny sizes) instead of in every call.
9. int4 at full depth: phase 6's prompts through int4 llama-3-8b (bf16),
   decode steps through the q4_matmul route and through the plain-unpack
   route, against an f32 forward over the same weights dequantized; the
   kernel route's worst logit error must stay within ROUTE_ERR_FACTOR x
   the unpack route's.
10. Tensor parallelism: the worker loads llama-3-8b at full width and
   TP_SERVING_LAYERS of its 32 layers (registered as TP_SERVING_NAME;
   phase 11 runs tp=2 at full depth) with "mesh": {"tp": 2} in engine
   mode, bf16 and then int4, and
   serves phase 3's three requests in each. The leader (this process)
   spawns one follower; both ranks sit on this machine's card (their
   data collectives over gloo) or on two cards (NCCL), as printed. Every
   rank's counts are zeroed before each request and held after it: one
   flash_attention per layer (tensor-core form), one flash_decode per
   layer per decode step;
   in int4 per decode step q4_matmul_row 2 x L (o, down) and q4_matmul
   5 x L + 1 (q, k, v, gate, up, head; one more for the prefill's head
   row); per weight pass 2 x L + 1 all-reduces (o, down, embedding), one
   logits gather and one token broadcast. The unload must leave no
   follower alive.
11. tp=2 against tp=1 on the same weights: full width, 2 layers, f32,
   float and int4, a teacher-forced prefill plus 8 decode steps within
   XCHECK_TOL; then phase 9's prompts and tokens through int4 tp=2 at full
   depth (bf16), whose worst logit error against phase 9's f32 forward
   must stay within ROUTE_ERR_FACTOR x the tp=1 q4 route's.
12. The worker's control surface over HTTP: the port's worker serves on a
   localhost port with an auth key (CONTROL_KEY) and full-width
   llama-3-8b bf16 (max_seq 4096). A call without the bearer token gets
   401, /health and /metrics included. Engine mode: phase 3's 500-token
   prompt, greedy, 32 new tokens, tagged: one flash_attention[mma] per
   layer and one flash_decode per layer per decode step; the same body
   and tag again answers idempotent with the same tokens and launches
   nothing; /inference_stream of the body gives the same tokens in its
   token events with the same launches (client-clock time to the first
   token event beside prefill_ms, and to done); after a call at master
   term 7 a term-6 /inference gets 409 with X-DLI-Stale-Term. Batched
   mode (phase 5's load, fused off then on): /inference_batch of phase
   5's 8 bodies, tagged, answers 8 lines, each tag once with 200, and
   the pass's decode kernel launches num_layers times per weight pass
   and no other attention kernel (wall time, tokens/s and tokens per
   pass beside phase 5's); a batch of one greedy body equals /inference
   of it. With fused off: a 2000-token request is cancelled once it has
   tokens (its /inference answers an error, blocks_free on /health comes
   back; time from /cancel); /drain with a request in flight (503 with
   Retry-After for a new one, /health draining, the request ends 200,
   drained), /undrain, then 200. /metrics parses line by line (every
   family typed, buckets non-decreasing) and
   dli_requests_completed_total moves by the phase's completions.
13. The decode programs (runtime/graphs.py): every phase above runs the
   engine's and the batcher's decode step as a captured CUDA graph (the
   default), counting each replay's launches, so their exact counts are
   those of the launches the card ran. Phase 13 runs the same paths with
   graphs on and off (DLI_CUDA_GRAPHS=0) at full width (llama-3-8b cut
   to GRAPHS_LAYERS = 16 of its 32 layers, the cut printed;
   bf16 activations, max_seq 4096): phase 3's three
   requests in engine mode, bf16 and int4 (one load each), and phase 5's
   8 bodies as one /inference_batch (one enqueue: the same admission
   waves in both modes) per decode route, paged and fused, bf16 and
   int4, on a fresh load per mode. Both modes must give the same tokens
   (greedy and sampled), the same launch counts per request, the same
   weight passes and launches per wave. One replay of each captured
   program, profiled with torch.profiler in a trace shown to hold the
   whole replay (bracketed_trace), must run on the device exactly the
   kernels its launch counts add (the capture's record). Reports ms
   per engine decode step and prefill, ms per batched weight pass and
   tokens/s, each with graphs on and off, the capture times, the graph
   pool's bytes, the profiled replays, and torch.cuda.memory_allocated()
   before each load (cuBLAS's cached workspaces dropped first, no model
   loaded) and after its unload, which must not be above the first, with
   no segment of the graphs' pool left.

14. The dense families (models/registry.py; no kernel of their own, the
   six above at new shapes). (a) Phase 4's cross-check (full width, 2
   layers, f32, card vs host within XCHECK_TOL, the same exact counts)
   for one row of each family (FAMILY_XCHECK): gpt2-xl, opt-350m,
   qwen2-7b, gemma-7b, pythia-6.9b, phi-2, falcon-7b, falcon-rw-1b,
   bloom-7b1, mpt-7b, gpt-j-6b; the fused route too where the gate
   concerns the family (gemma-7b and falcon-7b take the fused kernel,
   gpt2-xl's biased q keeps the paged one), and int4 and int8 weights
   for gpt2-xl and pythia-6.9b (biased linears); the
   FAMILY_CARD_REFERENCE rows against the plain versions on the card.
   ALiBi families decode
   through the gather formulation: no paged-kernel launch. (b) gpt2-xl
   and bloom-7b1 at full width through the worker, bf16, at
   FAMILY_SERVING_LAYERS (16 of 48, 10 of 30, the cuts
   printed):
   phase 13's engine requests (one flash_attention[mma] per layer per
   request and one flash_decode per layer per decode step, on the ALiBi
   arms for bloom) and one /inference_batch of phase 5's bodies (prompts
   cut to fit gpt2's 1024 positions) per decode route (gpt2-xl: one
   paged_flash_decode per layer per weight pass with DLI_FUSED_DECODE
   off and on;
   bloom-7b1: none, the gather route), each with graphs on and off:
   equal tokens and counts, memory back after each unload. Then phase
   6's prefill check at bloom-7b1's full depth: the ALiBi prefill
   through the tensor-core kernel within ROUTE_ERR_FACTOR x its plain
   version's error against f32. (c) ms per decode step and per batched
   weight pass for these paths, printed with the card's name and power
   limit, no limit.
15. Model ingestion: checkpoint directories written here from seeded
   tensors, each with its own safetensors writer, and served by the
   worker. (a) A Llama-3.1-8B-shaped HF directory (LLAMA31_8B, full
   width, INGEST_LAYERS = 16 of its 32 layers, 4 bf16 shards
   with their index, the llama3 rope_scaling, 131072 positions; the depth
   is cut further, and the cut printed, if the disk cannot hold it
   twice): ``checkpoint_path``
   in engine mode (phase 3's requests and counts; the load's seconds,
   GB/s of file bytes and peak device memory above the baseline, which
   must stay within param_bytes + 2 f32 copies of the largest leaf), in
   batched mode with DLI_FUSED_DECODE off and on (phase 5's pass and
   counts, then phase 3's greedy request alone), with "quantize":
   "int4" (phase 7's engine counts); (c) ``python -m
   distributed_llm_inferencing_tpu_torch convert --quantize int4`` of it
   and ``native_checkpoint`` (phase 3's requests, the int4 load's
   tokens). (b) gpt2-xl (48 layers, Conv1D weights, the hub's layout:
   no "transformer." prefix, no head, attn.bias buffers) and bloom-7b1
   (BLOOM_LAYERS layers, fused per-head QKV, ALiBi), engine and batched
   (paged route; bloom's gather route launches no paged kernel). Every
   param of every load equals, bitwise, the tensor written (int4: ops/
   quant.py's maybe_quantize of it), and every token equals an
   InferenceEngine's or ContinuousBatcher's built in this process on the
   written tensors. Its wall time is printed on a line of its own.
16. The dense switches of the later families (phase_later). (a) A
   gemma-2-9b-shaped HF directory (GEMMA2_9B: 42 layers, hidden 3584,
   16/8 heads of hd 256, sliding window 4096 on alternating layers,
   attention softcap 50, final softcap 30, tied 256000-row head; 18.5
   GB) and (b) a Qwen3-8B-shaped one (QWEN3_8B, q/k norms, full width,
   QWEN3_LAYERS layers, the cut printed), each written by phase 15's
   writer, served through the worker with max_seq 8192 and deleted
   before the next is written: engine mode with phase 3's requests plus
   a 4500-token prompt (past the window), batched on the paged route
   with phase 5's bodies plus that prompt, each with graphs on and off
   (equal tokens; exact counts: one flash_attention[mma] per layer per
   request, one flash_decode per layer per step, one paged_flash_decode
   per layer per pass, no fused_decode_step; one profiled replay per
   captured program), every param bitwise equal to the tensor written,
   tokens equal to an in-process engine's and batcher's on them, memory
   back after each unload; then the bf16 prefill at full depth (250 and
   4500 tokens) through the tensor-core kernel against f32, within 1.5x
   the plain attention's error. (c) Phase 4's card-vs-host check for
   each later converter type at its published width, 2 layers
   (LATER_XCHECK; windows cut to XCHECK_WINDOW, printed, so that the
   prompts pass them; the LATER_CARD_REFERENCE rows against the plain
   versions on the card). Its wall time is printed on a line of its own.
17. The KV plane (phase_kv_plane), llama-3-8b at full width and depth,
   bf16 weights. (a) The int8 KV cache in engine mode, max_seq 8192:
   phase 3's requests plus a 4000-token one, against the bf16 cache at
   the same max_seq (cache bytes: int8 levels plus one f32 scale per
   head vector, L x S x Hkv x (2 hd + 8) bytes, against L x S x Hkv x 4
   hd; ms per decode step, graphs on; exact counts: the int8 decode is
   the plain route, 0 flash_decode), and phase 4's card-vs-host check
   with the int8 cache (2 layers, f32, dense and paged). (b) The int8
   paged pool: phase 5's bodies through the worker with
   DLI_FUSED_DECODE=1 (the fused gate refuses the pool: 0
   paged_flash_decode and 0 fused_decode_step launches, the gather
   route), and ms per weight pass of one 32-step chunk with 8 slots
   live, against the bf16 pool on the same weights. (c) The host KV
   tier: a pool of TIER_BLOCKS blocks where a TIER_PROMPT-token prompt's
   blocks are evicted by the 1500-token requests after it; served again,
   the prompt restores them from the arena (prefill_cached_tokens > 0),
   its tokens equal to its first serving's, greedy and seeded-sampled
   (TIER_PROMPT is four 512-token admission chunks and one block, so the
   cold serving's last admission has the restore's shape, a 16-token
   tail over 128 cached blocks: a GEMM's bits depend on its row count);
   offload GB/s, restore ms per block, and ms per weight pass with the
   tier on and off (kv_host_mb 0) under the same requests. (d)
   Disaggregation: a prefill-role, a decode-role and a mixed worker in
   this process, each loading llama-3-8b; a TIER_PROMPT-token prompt
   runs as the master's disaggregation path runs it (a one-token
   kv_export pass on the prefill worker, then the request on the decode
   worker with a kv_source; the JAX package, the master's home, does
   not run on the card: the unchanged master drives the same two calls
   in tests/test_torch_e2e_master.py), decode on the fused route over
   the fetched pages; its text equals the mixed worker's, with every
   block fetched and the decode worker's pages bitwise equal to the
   prefill worker's (one fetch's cap raised to KV_FETCH_MB: the
   prompt's 128 bf16 blocks are 268.5 MB of frames, past the 256 MiB
   default); /kv_fetch bytes and MB/s over loopback, TTFT against
   recompute. Before that, one prompt at the default serving cap: the
   stream is cut before its last block (0 missing), the fetched blocks
   are bitwise equal to the source's and the rest is recomputed (its
   tokens reported). Then again with DLI_KV_HOST_DTYPE=int8 on the
   prefill worker: the wire bytes' ratio, and every restored element
   within half a quantization step of its head vector plus one bf16
   step (INT8_PAGE_TOL) of the source's (its lossy tokens reported, not
   asserted). Its wall time is printed on a line of its own, and each
   kernel's launches in it ("kv_plane_launches").

18. Speculation, overlapped dispatch and live migration, llama-3-8b
   (seeded weights; cut to SPEC_LAYERS = 16 of its 32 layers, the cut
   printed). (a) The engine's verify step: at 2 layers in f32,
   its logits for 5 query rows on the card against the host's within
   XCHECK_TOL, and speculative greedy tokens equal to plain greedy; at
   full depth in bf16, two repetitive and two random prompts (300 and 900
   tokens) of 64 new tokens, speculative (gamma 4, the adaptive
   controller off) against plain: tokens per verify step, ms per emitted
   token, greedy agreement (reported: random weights copy nothing and
   bf16 near-ties part), graphs on and off equal (asserted), and no
   decode kernel launched by a verify step. (b) The batcher's
   speculative chunk through the worker, full depth bf16, paged route:
   phase 5's bodies plus two repetitive ones as one /inference_batch,
   one load per SPEC_MODES entry (wave on and off, adaptive on and off),
   then the first again with graphs off (equal tokens); counted around
   each chunk, no decode kernel inside a speculative chunk, and
   paged_flash_decode num_layers times per plain pass; tokens per pass,
   ms per verify iteration against the plain pass, the spec_wave_*
   counters. (c) Overlapped dispatch at full occupancy: 8 requests on 8
   slots in chunks of 16, with the overlap off and on over one batcher
   (the first run admits cold, the next two over cached prompt blocks):
   equal tokens, overlapped pairs > 0, ms per pass. (d) Live migration:
   two port workers on the card; a 1500-token prompt generating 256
   tokens is migrated with /migrate_out once it has emitted 64, and
   re-dispatched to the other worker with its resume record and the
   source as kv_source, as the master builds the body: no token lost or
   repeated, the fetched pages bitwise equal to the source's export,
   greedy agreement with an undisturbed run reported; then two more
   migrations resumed straight into the destination's batcher with
   kv_source, the receive-overlapped restore on and off (TTFT reported).
   Its wall time is printed on a line of its own, and each kernel's
   launches in it ("spec_migrate_launches").

19. Multi-LoRA and the experts behind the softmax router (seeded
   weights; DLI_LORA_HOST_MB 1024, DLI_LORA_SLOTS 2, DLI_LORA_MAX_RANK
   16). (a) llama-3-8b at full depth in bf16 with three rank-16
   ``synth:`` adapters over /load_adapter: batched, phase 5's eight
   bodies as one /inference_batch on base weights, then mixing base, a1
   and a2 rows (greedy and sampled), then a3 and a1 rows (a3 evicts a2
   from its device slot in place, so the captured lora program replays
   over rewritten pack rows), on a load with graphs on and one with
   graphs off: equal tokens; DLI_FUSED_DECODE=1, every chunk counted: a
   chunk with an adapter row launches paged_flash_decode num_layers
   times per pass and no fused_decode_step, a base-only chunk the fused
   kernel. Engine mode in bf16 and int4 (base, a1 greedy, a1 sampled;
   graphs on and off over one load): equal tokens, flash_attention per
   request, flash_decode (and q4_matmul: every linear plus the head) per
   step. ms per pass and per step with and without adapters. A mixed
   batch (base, a1, a2) on the card against dedicated single-row runs on
   the host, 2 layers f32, within XCHECK_TOL. (b) mixtral-8x7b at full
   width, 2 layers, f32, the kernels against their plain versions on the
   card (the host's f32 forward took ~33 s) within XCHECK_TOL in dense
   and capacity dispatch (auto takes one of the two by the token count)
   over prompts in runs of one token (the reference's capacity dispatch
   drops choices); moe-proxy-8e at full width,
   2 layers, f32, dense dispatch: the paged pool's prefill and decode on
   the paged and the fused route (the fused gate takes the MoE rows, as
   the JAX gate does) against the host's; moe-proxy-8e
   (bf16) and mixtral-8x7b (int8, 47 GB stored) at full depth through
   the worker: engine requests (graphs on and off over one load) and
   batched bodies as one /inference_batch on the paged route (a fresh
   load per graphs setting; moe-proxy-8e on the fused route too, one
   fused_decode_step per layer per pass), two requests and four bodies
   for moe-proxy-8e, one each for mixtral-8x7b: equal tokens per route,
   exact launches, ms per step and per pass, stored bytes and peak
   device memory. Its wall time is
   printed, and each kernel's launches in it ("lora_moe_launches").
20. The other experts and latent attention. (a) deepseek-proxy (latent
   attention, the deepseek_v3 router, a shared expert, one dense-prefix
   layer) at full width and all 12 layers through the worker, bf16:
   engine mode, phase 3's three requests on the latent cache and on the
   materialized one (DLI_MLA_LATENT=0), graphs on and off over one load
   (equal tokens), no attention kernel and no q4_matmul launched; the
   cache bytes exact by formula ([12, B, S, 1, 160] and no v plane
   against 2 x [12, B, S, 16, 96]: 19.2x); int4 on the latent cache, one
   q4_matmul per quantized linear per layer per step (not kv_b_k /
   kv_b_v, read whole by the absorbed decode) plus the head; phase 5's
   eight bodies as one /inference_batch on the paged route (the
   materialized pool), no paged_flash_decode and no fused_decode_step.
   ms per step and per pass, stored bytes, peak memory. (b) Card against
   host within XCHECK_TOL, f32, one row per converter type at the
   published widths of EXPERT_XCHECK's public models, 2 layers (dbrx 1),
   teacher-forced prefill plus 8 decode steps on the dense and the paged
   path (a latent-attention row's dense path on the latent cache too;
   the CARD_REFERENCE rows against the plain versions on the card, as
   phase 6 swaps them in, since their host side passed 20 s),
   with exact launches: rows 1-3 for glm4_moe, ernie4_5_moe,
   hunyuan_v1_moe and dbrx (ernie4_5_moe's fused route too), none for
   gpt_oss (sinks) and deepseek_v3 (latent attention); DeepSeek-V3's
   router at its widths on [64, 7168] inputs within 1e-6, and
   deepseek-proxy's dense and MoE layer. (c) A gpt-oss-20b-shaped
   checkpoint written by this script (GPT_OSS_LAYERS of its 24 layers)
   through the worker, bf16: engine requests and one /inference_batch,
   graphs on and off (equal tokens), no attention kernel launched, every
   param bitwise as written. Report in chiprun_out/phase20.json
   ("experts_mla_launches" per kernel).
21. Tensor parallelism for what one host serves (both ranks on this
   card, gloo). (a) llama-3-8b at full width and TP_SERVING_LAYERS of
   its 32 layers (phase 10's cut, printed) through the worker with
   "mesh": {"tp": 2}, "serving": "batched" (phase 5's load): phase 5's
   eight bodies as one /inference_batch in bf16 with DLI_FUSED_DECODE
   off and then on, each on a fresh load (the fused gate is off under
   tp: the same tokens), held against a tp=1 load of the same weights
   (at least half of the first tokens equal; bf16 near ties may break
   either way), then in int4; every rank's counts zeroed before each
   batch and held
   after: paged_flash_decode num_layers times per weight pass, no other
   attention kernel; in int4, 5 q4_matmul per layer plus the head and 2
   q4_matmul_row per layer per decode pass, the head (and at <= 32 rows
   the layers' too) per admission wave; 2L + 1 all-reduces and one
   gather per forward, no broadcast (every rank samples the gathered
   logits); every rank's programs and their outputs' digest equal; ms
   per pass, tokens/s, weight bytes per rank; each load on the phase's
   kept pair, each unload releasing it. (b) llama-3-8b, full width, 2
   layers, f32: the batcher's
   scheduler (an admission wave of two prompts, then 8 greedy decode
   steps) at tp=2 against tp=1 on the same weights, every logits row
   the leader computed within XCHECK_TOL and the tokens equal (a token
   may differ only over a near tie), float and int4 weights, and an
   int8 KV pool (its chunk's side buffers and flush; every rank's pool
   shard against tp=1's pool as phase 4 holds an int8 cache, the levels
   at most one step apart on at most 1%: tp's K/V come from GEMMs of
   other widths, so a value on a rounding boundary takes the next level
   on one side); with the sublayers scaled
   by SPEC_RESIDUAL_SCALE, on two prompts p + c + p (c the model's
   greedy continuation of p) whose drafts the model accepts, the tp=2
   speculative engine's and speculative batcher's
   greedy tokens equal plain greedy, with drafts accepted by both. (c)
   TP_FAMILY_ROWS (ALiBi, parallel residual and
   row biases, lm_head bias and partial RoPE, gemma-2's softcaps,
   sandwich norms and windows, gemma-2b's one kv head replicated,
   q/k/v biases, learned positions, Qwen3's q/k norms) at their
   published widths, 2 layers, f32: the engine at tp=2 against tp=1,
   teacher-forced prefill plus 4 decode steps within XCHECK_TOL, exact
   counts on each rank (the all-reduces by the count rule of
   models/transformer.py). One follower serves (a), (b) and (c)
   (``DLI_TP_KEEP_GROUPS``; the spawn it saves per model is timed):
   the pair phase 11 spawns (its spawn timed there), kept through
   phases 21 and 22. Report in chiprun_out/phase21.json
   ("tp_batched_launches" per kernel, every rank's).
22. Pipeline and sequence parallelism (every rank on this card, gloo,
   eager; every model on phase 11's kept pair or one kept group of
   four, each unload releasing it). (a) llama-3-8b at full width and
   depth through the worker with "mesh": {"pp": 2} (16 layers per
   stage): phase 5's bodies as one /inference_batch in bf16 with
   DLI_FUSED_DECODE off and then on over the same load, held against
   phase 5's pp=1 tokens by ``_vs_tp1``, then int4; phase 3's
   500-token request in engine mode against phase 3's tokens. Every
   stage's counts exact by the written rules (``_pp_batched_want``,
   ``_pp_hops_want``: the paged or fused kernel once per local layer
   per microbatch step, 7 q4_matmul per layer and the head on the last
   stage, an admission's q4 rows by microbatch; pp hops out and back
   per pass and wave, one broadcast per program; the engine's
   flash_attention per local layer per prefill, flash_decode per local
   layer per step, one hop each way and one broadcast per pass); ms per
   pass and step, weights per stage. (b) sp=2 against sp=1 on one
   PP_SP_LONG-token prompt at full width and depth in f32 (the weights
   replicate over sp): the prefill's last logits and every decode
   step's within XCHECK_TOL, greedy tokens equal, sp - 1 ring hops per
   layer per prefill and one combine per layer per step on each rank,
   no attention kernel (the ring is plain torch); prefill ms at both.
   (c) 2 layers, f32: the pp=2 batcher against pp=1 (float, int4, an
   int8 pool: tokens equal, the stages' pool slices against pp=1's
   pool, the int8 levels by ``_level_check``); pp=2 speculation, chunk
   and wave, greedy equal to plain with drafts accepted (sublayers
   scaled by SPEC_RESIDUAL_SCALE); pp x tp, sp x tp and pp x sp on one
   group of four; gemma-2's windows and tied head, moe-proxy-8e's
   experts and deepseek-proxy's latent attention (materialized; its
   experts too), each in one microbatch (capacity dispatch counts a
   call's positions), at pp=2; a window, bloom's ALiBi and gemma-2's
   caps at sp=2; each
   against one device within XCHECK_TOL. Report in
   chiprun_out/phase22.json ("pp_sp_launches" per kernel, every
   rank's).

Phase 2 also holds q4_matmul_row to Q4_TOL (bit-identical across two
launches) at llama-3-8b's o and down shapes, chunk-local for 2 and 4
chunks, b in {1, 8, 32}, bf16 and f32, and times it on a tp=2 rank's
chunk.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the port
package beside this file, it exits non-zero and prints no result.

``python3 chip_smoke.py --digests`` builds the attention kernels and
prints uncapped_digests only (from another tree's root, this script
copied in, that tree's digests).

``python3 chip_smoke.py --kv-plane`` builds the kernels and runs only
phase 17.

``python3 chip_smoke.py --spec-migrate`` builds the kernels and runs only
phase 18.

``python3 chip_smoke.py --lora-moe`` builds the kernels and runs only
phase 19.

``python3 chip_smoke.py --experts-mla`` builds the kernels and runs only
phase 20.

``python3 chip_smoke.py --tp-batched`` builds the kernels and runs only
phase 21.

``python3 chip_smoke.py --pp-sp`` builds the kernels and runs only
phase 22 (with its own pp=1 references).

``python3 chip_smoke.py --timed-rows`` builds the kernels and runs only
phase 2's timed rows (``timed_rows``), printing each; from the root of
another checkout (a parent commit unpacked beside this one, this script
copied in) it times that tree's kernels the same way.
"""

import concurrent.futures
import functools
import gc
import itertools
import json
import os
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
# |kernel - plain| <= ATOL + RTOL*|plain|, elementwise. f32: summation
# order only. bf16: both sides round one f32 result to bf16, and one bf16
# ulp is 2^-7 = 0.0078 relative.
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}
# paged and fused decode in bf16: kernel and plain version both compute in
# f32 and round once to bf16, so they differ by at most one bf16 ulp
# (<= 2^-7 |x|) plus the f32 summation-order error
PAGED_BF16_TOL = (1e-4, 2 ** -7)
# fused decode in f32: its GEMV sums D = 4096 products in another order
# than the host's matmul before the attention
FUSED_F32_TOL = (1e-4, 1e-4)
# cross-check (phase 4): f32 GEMMs over K up to 14336 in another
# summation order on card and host, through 2 layers and the head
XCHECK_TOL = (1e-3, 1e-3)
# the same with an int8 KV cache: card and host quantize K/V computed in
# another summation order, and a value that sits on a rounding boundary
# takes the next level on one side (a step of its head vector's
# |max|/127, ~0.8% of it, in one element); the levels are held apart
# (at most one step, on a small share of elements) and the logits within
# this
INT8_KV_XCHECK_TOL = (1e-2, 1e-2)
# phase 5's serving configuration and traffic
BATCHED_LOAD = {"model_name": "llama-3-8b", "allow_random_init": True,
                "dtype": "bfloat16", "serving": "batched", "slots": 8,
                "kv_blocks": 1024, "kv_block_size": 16, "max_seq": 4096}
PROMPT_LENS = (60, 130, 250, 500, 700, 1000)
SHARED_PREFIX, SHARED_TAIL, NEW_TOKENS = 512, 40, 32
# phase 6: decode steps per route at full depth; a route's logit error
# against f32 may be this many times the bf16 prefill's (both decode
# routes stay under the prefill's own error; a decode fault at depth
# decorrelates the logits and lands far above)
ROUTE_STEPS, ROUTE_ERR_FACTOR = 4, 1.5
# q4_matmul against its plain version: both sum din f32 products of x and
# exact int4 levels in some order, each within din * 2^-24 * sum|x * w| of
# the exact sum, then scale once; a bf16 output adds one ulp (2^-7 |ref|)
Q4_TOL = "2*din*2^-24*(|x|@|levels|)*scale (+ 2^-7*|ref| in bf16)"
# llama-3-8b's linears (din, dout) as one weight pass calls them
Q4_SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "gate": (4096, 14336),
             "down": (14336, 4096), "head": (4096, 128256)}
Q4_PASS = {"q": 2, "k": 2, "gate": 2, "down": 1}   # x 32 layers, + head
# the quantized serving phase loads llama-3-8b with these weights
QUANT_LOAD = {"quantize": "int4"}
# phase 10's depth: the tp engine runs eager over gloo on one card (~0.2 s
# per weight pass at 32 layers, PERF.md §5), and phase 11 holds tp=2 to
# tp=1 at full depth; 8 of the 32 layers keep its serving and exact
# per-rank counts in a quarter of the time
TP_SERVING_LAYERS, TP_SERVING_NAME = 8, "llama-3-8b-8-layers"
# the bearer token phase 12's worker requires on every route
CONTROL_KEY = "chip-smoke-control"
# phase 14 (a): one registry row per family, the decode routes of its
# paged cross-check (fused where the fused gate takes the family) and its
# weight forms (the biased int4/int8 linears on gpt2-xl and pythia)
FAMILY_XCHECK = (
    ("gpt2-xl", ("paged", "fused"), (None, "int4", "int8")),
    ("opt-350m", ("paged",), (None,)),
    ("qwen2-7b", ("paged",), (None,)),
    ("gemma-7b", ("paged", "fused"), (None,)),
    ("pythia-6.9b", ("paged",), (None, "int4", "int8")),
    ("phi-2", ("paged",), (None,)),
    ("falcon-7b", ("paged", "fused"), (None,)),
    ("falcon-rw-1b", ("paged",), (None,)),
    ("bloom-7b1", ("paged",), (None,)),
    ("mpt-7b", ("paged",), (None,)),
    ("gpt-j-6b", ("paged",), (None,)),
)
# the rows of phases 14 (a) and 16 (c) whose reference runs on the card,
# the attention kernels swapped for their plain versions (as phase 20's
# CARD_REFERENCE): their host f32 forwards took 6.2-43.4 s each, 201 s of
# the two phases' 395 (NVIDIA H100 80GB HBM3, on a host whose build took
# 129.7 s);
# the others (1.5-3.5 s) keep the host's
FAMILY_CARD_REFERENCE = ("qwen2-7b", "gemma-7b", "pythia-6.9b", "falcon-7b",
                         "bloom-7b1", "mpt-7b", "gpt-j-6b")
LATER_CARD_REFERENCE = ("gemma2", "cohere", "qwen3", "granite", "olmo2",
                        "glm4", "nemotron", "hunyuan_v1_dense", "exaone4")
# phase 14 (b): rows served through the worker (FAMILY_SERVING_LAYERS
# deep), with the
# batched decode routes (DLI_FUSED_DECODE off / on) each is driven by;
# gpt2-xl's biased q keeps the fused route on the paged kernel, and
# bloom's ALiBi decodes through the gather formulation
FAMILY_SERVING = (("gpt2-xl", ("paged", "fused")), ("bloom-7b1", ("paged",)))
# depth cuts, so that the whole smoke, phase 19 included, ends inside
# its 1200 s on the slower of the H100 hosts seen (1307.1 s uncut on
# one, PERF.md §6): phase 13's llama-3-8b, phase 14's served rows, phase
# 15's Llama-3.1-8B-shaped directory and phase 18's llama-3-8b run a
# third to a half of their layers (each cut is printed); full width,
# every path and check kept
GRAPHS_LAYERS = 16                                  # of llama-3-8b's 32
FAMILY_SERVING_LAYERS = {"gpt2-xl": 16, "bloom-7b1": 10}   # of 48, 30
INGEST_LAYERS = 16                                  # of Llama-3.1-8B's 32
SPEC_LAYERS = 16                                    # phase 18, of 32
# phase 5's prompt lengths, the longest cut so that prompt + new tokens
# fit gpt2's 1024 positions; phase 14's bloom-7b1 prefill depth check
FAMILY_PROMPT_LENS = (60, 130, 250, 500, 700, 900)
FAMILY_DEPTH_LENS = (60, 250, 700)


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def _bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _library_call(torch, sdpa, q, k, v, **kw):
    """One torch call computing the same attention on [B,H,S,hd] views:
    SDPA with its GQA mode, or (torch without enable_gqa) on k/v whose
    heads were repeated beforehand, outside the timed call."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        sdpa(qt, kt, vt, enable_gqa=True, **kw)
        return lambda: sdpa(qt, kt, vt, enable_gqa=True, **kw)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return lambda: sdpa(qt, kt, vt, **kw)


def _gather_library_call(torch, sdpa, q, k_pool, v_pool, bt, mask):
    """SDPA over each slot's blocks gathered from the pools (``k_pool[bt]``)
    inside the call, as one would attend a paged cache without a paged
    kernel; the heads repeated in the call where SDPA lacks enable_gqa."""
    R, mb = bt.shape
    bs, Hkv, hd = k_pool.shape[1:]
    btl, qt, g = bt.long(), q.transpose(1, 2), q.shape[2] // Hkv

    def call(gqa):
        kt, vt = (p[btl].reshape(R, mb * bs, Hkv, hd).transpose(1, 2)
                  for p in (k_pool, v_pool))
        if gqa:
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        return sdpa(qt, kt.repeat_interleave(g, dim=1),
                    vt.repeat_interleave(g, dim=1), attn_mask=mask)
    try:
        call(True)
        return lambda: call(True)
    except TypeError:
        return lambda: call(False)


def _compare(torch, out, ref, tol):
    atol, rtol = tol
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all(), "kernel output is not finite"
    err = (o - r).abs()
    ok = bool((err <= atol + rtol * r.abs()).all())
    return float(err.max()), ok


def check_prefill(torch, fa, sdpa, B, S, H, Hkv, hd, dtype, window=None,
                  alibi=False, timing=False, softcap=None):
    from distributed_llm_inferencing_tpu_torch.ops.attention import (
        alibi_slopes)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(S * 31 + H)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    sl = alibi_slopes(H, dev) if alibi else None
    cap = {} if softcap is None else {"softcap": softcap}
    out = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl, **cap)
    again = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl,
                               **cap)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, sliding_window=window, alibi=sl,
                                 **cap)
    dname = str(dtype).replace("torch.", "")
    err, ok = _compare(torch, out, ref, TOL[dname])
    row = {"case": f"prefill B={B} S={S} H={H} Hkv={Hkv} hd={hd} {dname}"
                   f" window={window} alibi={alibi}"
                   + ("" if softcap is None else f" softcap={softcap}"),
           "form": fa.prefill_form(dtype, hd),
           "max_abs_err": err, "tol": TOL[dname],
           "ok": ok and torch.equal(out, again)}
    if timing:
        keys = sum(min(i + 1, window or S) for i in range(S))
        flops = 4.0 * B * H * hd * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        # "ms" and "library_ms" are device time from the profiler (at
        # S=512 the wrapper's host side outlasts the kernel); "event_ms"
        # the CUDA events around a loop of calls, host included
        call = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, sliding_window=window, alibi=sl, **cap)
        row["ms"] = _device_ms(torch, [call])
        row["event_ms"] = timed_ms(torch, call)
        # the plain version materialises [S, S] scores per head: few runs
        # at the longest prompts
        row["plain_ms"] = timed_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, sliding_window=window, alibi=sl, **cap),
            **(dict(iters=5) if S < 4096 else dict(iters=2, warmup=1)))
        # SDPA has no score cap: with one, the yardstick attends uncapped
        row["library_ms"] = _device_ms(torch, [_library_call(
            torch, sdpa, q, k, v, is_causal=True)])
        if softcap is not None:   # the uncapped arm at the same shape
            row["uncapped_ms"] = _device_ms(torch, [
                lambda: fa.flash_attention(q, k, v, sliding_window=window,
                                           alibi=sl)])
    return row


def check_decode(torch, fa, sdpa, lengths, S, H, Hkv, hd, dtype, window=None,
                 alibi=False, timing=False, softcap=None):
    from distributed_llm_inferencing_tpu_torch.ops.attention import (
        alibi_slopes)
    dev = torch.device("cuda")
    B = len(lengths)
    g = torch.Generator(device=dev).manual_seed(S * 17 + H)
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, dev) if alibi else None
    cap = {} if softcap is None else {"softcap": softcap}
    out = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl,
                          **cap)
    again = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl,
                            **cap)
    torch.cuda.synchronize()
    ref = fa.flash_decode_ref(q, k, v, lens, sliding_window=window, alibi=sl,
                              **cap)
    dname = str(dtype).replace("torch.", "")
    err, ok = _compare(torch, out, ref, TOL[dname])
    row = {"case": f"decode lengths={lengths} S={S} H={H} Hkv={Hkv} hd={hd}"
                   f" {dname} window={window} alibi={alibi}"
                   + ("" if softcap is None else f" softcap={softcap}"),
           "max_abs_err": err, "tol": TOL[dname],
           "ok": ok and torch.equal(out, again)}
    if timing:
        keys = sum(min(n, window or n) for n in lengths)   # rows read
        flops = 4.0 * H * hd * keys
        nbytes = (2 * keys * Hkv * hd + 2 * q.numel()) * q.element_size() \
            + 4 * B
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        # cold: cache sets that together exceed the 50 MB L2, as a decode
        # step meets each layer's cache once; "ms" and the library times
        # are device time from the profiler, "event_ms" the CUDA events
        # around a loop of calls (the wrapper's host side included)
        n = max(3, -(-64 * 2 ** 20 // (2 * k.numel() * k.element_size())))
        sets = [(q, k, v)] + [
            (torch.randn_like(q), torch.randn_like(k), torch.randn_like(v))
            for _ in range(n - 1)]
        calls = [(lambda a=a: fa.flash_decode(
            *a, lens, sliding_window=window, alibi=sl, **cap)) for a in sets]
        row["ms"] = _device_ms(torch, calls)
        row["event_ms"] = _cold_ms(torch, calls)
        row["plain_ms"] = timed_ms(torch, lambda: fa.flash_decode_ref(
            q, k, v, lens, sliding_window=window, alibi=sl, **cap), iters=5)
        if softcap is not None:   # the uncapped arm on the same inputs
            row["uncapped_ms"] = _device_ms(torch, [
                (lambda a=a: fa.flash_decode(*a, lens, sliding_window=window,
                                             alibi=sl)) for a in sets])
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        if window:
            mask = mask & (torch.arange(S, device=dev)[None, :]
                           >= (lens - window)[:, None])[:, None, None, :]
        row["library_ms"] = _device_ms(torch, [
            _library_call(torch, sdpa, *a, attn_mask=mask) for a in sets])
        if B == 1:
            # the best a library call can do at B=1: the host knows the
            # length, so SDPA attends the cache sliced to it, no mask
            lo, hi = max(0, lengths[0] - (window or lengths[0])), lengths[0]
            row["library_sliced_ms"] = _device_ms(torch, [
                _library_call(torch, sdpa, a[0], a[1][:, lo:hi],
                              a[2][:, lo:hi]) for a in sets])
        del sets, calls
    return row


def _cold_ms(torch, fns, iters=30):
    """Kernel time with inputs the L2 cache does not hold: round-robin
    over input sets that together exceed its 50 MB, as the serving path
    meets a new layer's pool and weights at every launch."""
    it = itertools.cycle(fns)
    return timed_ms(torch, lambda: next(it)(), iters=iters)


def _device_ms(torch, fns, iters=30):
    """Device time per call: the self device time of every kernel the
    calls launch, under torch.profiler (a trace that holds them all, see
    bracketed_trace), over ``iters`` calls round-robin over ``fns`` (cold
    inputs as in _cold_ms). For calls whose host side outlasts their
    kernels, where CUDA events around a loop would time the host."""
    from distributed_llm_inferencing_tpu_torch.ops.trace import (
        bracketed_trace, kernel_times)
    it = itertools.cycle(fns)
    for _ in range(3):
        next(it)()

    def calls():
        for _ in range(iters):
            next(it)()

    prof, _, _ = bracketed_trace(calls)
    return sum(k["device_ms"] for k in kernel_times(prof).values()) / iters


def _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs, nb,
                  disjoint=False):
    """A random pool of nb blocks; each slot's table is its own random
    permutation of pool blocks (the dummy block 0 aside), or with
    ``disjoint`` one permutation cut into the slots' tables (no block
    read twice, as in a full pool)."""
    dev = torch.device("cuda")
    R = len(lengths)
    mb = max(1, -(-max(lengths) // bs))
    k = torch.randn(nb, bs, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(nb, bs, Hkv, hd, generator=g, device=dev).to(dtype)
    if disjoint:
        bt = (torch.randperm(nb - 1, generator=g, device=dev)[:R * mb]
              + 1).reshape(R, mb).to(torch.int32)
    else:
        bt = torch.stack([torch.randperm(nb - 1, generator=g,
                                         device=dev)[:mb] + 1
                          for _ in range(R)]).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return k, v, bt, lens


def _paged_keys(lengths, window):
    return sum(min(n, window or n) for n in lengths)


def check_paged(torch, pa, sdpa, lengths, H, Hkv, hd, dtype, bs=16, nb=None,
                window=None, timing=False, disjoint=False, softcap=None):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(len(lengths) * 13 + hd)
    R = len(lengths)
    nb = nb or R * max(1, -(-max(lengths) // bs)) + 1
    k, v, bt, lens = _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb, disjoint)
    q = torch.randn(R, 1, H, hd, generator=g, device=dev).to(dtype)
    cap = {} if softcap is None else {"softcap": softcap}
    out = pa.paged_flash_decode(q, k, v, bt, lens, sliding_window=window,
                                **cap)
    again = pa.paged_flash_decode(q, k, v, bt, lens, sliding_window=window,
                                  **cap)
    torch.cuda.synchronize()
    ref = pa.paged_flash_decode_ref(q, k, v, bt, lens, sliding_window=window,
                                    **cap)
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname] if dtype == torch.float32 else PAGED_BF16_TOL
    err, ok = _compare(torch, out, ref, tol)
    row = {"case": f"paged lengths={lengths} H={H} Hkv={Hkv} hd={hd} bs={bs}"
                   f" blocks={nb} {dname} window={window}"
                   + ("" if softcap is None else f" softcap={softcap}"),
           "max_abs_err": err, "tol": tol,
           "ok": ok and torch.equal(out, again)}
    if timing:
        keys = _paged_keys(lengths, window)
        flops = 4.0 * H * hd * keys
        nbytes = (2 * keys * Hkv * hd + 2 * q.numel()) * q.element_size() \
            + 4 * (R + bt.numel())
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        sets = [(q, k, v)] + [
            (torch.randn_like(q), *_paged_inputs(
                torch, g, dtype, lengths, H, Hkv, hd, bs, nb, disjoint)[:2])
            for _ in range(2)]
        # device time (its split pass and merge) from the profiler; the
        # CUDA events around the loop time the wrapper's host side here
        calls = [(lambda a=a: pa.paged_flash_decode(
            a[0], a[1], a[2], bt, lens, sliding_window=window, **cap))
            for a in sets]
        row["ms"] = _device_ms(torch, calls)
        row["event_ms"] = _cold_ms(torch, calls)
        row["plain_ms"] = timed_ms(torch, lambda: pa.paged_flash_decode_ref(
            q, k, v, bt, lens, sliding_window=window, **cap), iters=5)
        if softcap is not None:   # the uncapped arm on the same inputs
            row["uncapped_ms"] = _device_ms(torch, [
                (lambda a=a: pa.paged_flash_decode(
                    a[0], a[1], a[2], bt, lens, sliding_window=window))
                for a in sets])
        # the yardstick attends K/V gathered outside the timed call
        mb = bt.shape[1]
        kg = k[bt.long()].reshape(R, mb * bs, Hkv, hd)
        vg = v[bt.long()].reshape(R, mb * bs, Hkv, hd)
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        row["library_ms"] = _device_ms(torch, [_library_call(
            torch, sdpa, q, kg, vg, attn_mask=mask)])
        # ... and with the gather in the timed call, as a caller without
        # a paged kernel would pay it
        del kg, vg
        row["library_gather_ms"] = _device_ms(torch, [_gather_library_call(
            torch, sdpa, q, k, v, bt, mask)])
    return row


def _unfused_route(torch, leaf, k, v, bt, lens, cos, sin, window):
    """The port's unfused decode step on the fused kernel's inputs: the q
    projection as the model's ``Linear`` runs it for the leaf's form (bf16
    ``matmul``; int8 ``q.to(bf16)`` + ``matmul``; int4 ``q4_matmul``), the
    rotate-half RoPE, then ``paged_flash_decode``. A yardstick only: the
    port never calls it in place of the fused kernel."""
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Linear)
    from distributed_llm_inferencing_tpu_torch.ops import (
        paged_attention as pa)
    from distributed_llm_inferencing_tpu_torch.ops.rope import apply_rope
    lin = Linear(leaf)
    hd = k.shape[-1]
    cs = None if cos is None else tuple(
        t[:, None, None, :hd // 2] for t in (cos, sin))

    def call(x):
        q = lin(x[:, None]).reshape(x.shape[0], 1, -1, hd)
        if cs is not None:
            q = apply_rope(q, None, 0.0, cos_sin=cs)
        return pa.paged_flash_decode(q, k, v, bt, lens,
                                     sliding_window=window)
    return call


def _err_over_tol(torch, out, ref, tol):
    """The worst elementwise |out - ref| / (atol + rtol |ref|): at most 1
    where the check holds."""
    atol, rtol = tol
    r = ref.float()
    return float(((out.float() - r).abs() / (atol + rtol * r.abs())).max())


def check_fused(torch, fd, lengths, H, Hkv, hd, D, dtype, bs=16, nb=None,
                rope=True, window=None, timing=False, form="float",
                disjoint=False):
    """The fused kernel in one weight form ("float", "int8" or "int4":
    the q leaf as ops/quant.py stores it) against its plain version.
    Timed rows also time the port's unfused route on the same inputs
    (``unfused_ms``)."""
    from distributed_llm_inferencing_tpu_torch.ops import quant as tq
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(len(lengths) * 7 + D)
    R = len(lengths)
    nb = nb or R * max(1, -(-max(lengths) // bs)) + 1
    k, v, bt, lens = _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb, disjoint)

    def xw():
        x = torch.randn(R, D, generator=g, device=dev).to(dtype)
        w = torch.randn(D, H * hd, generator=g, device=dev) / D ** 0.5
        if form == "int8":
            return x, tq.quantize_weight(w)
        if form == "int4":
            return x, tq.quantize_weight_int4(w)
        return x, {"w": w.to(dtype)}

    x, w = xw()
    cos = sin = None
    if rope:
        ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    kw = dict(rope_cos=cos, rope_sin=sin, sliding_window=window)
    out = fd.fused_decode_step(x, w, k, v, bt, lens, **kw)
    torch.cuda.synchronize()
    ref = fd.fused_decode_step_ref(x, w, k, v, bt, lens, **kw)
    dname = str(dtype).replace("torch.", "")
    tol = FUSED_F32_TOL if dtype == torch.float32 else PAGED_BF16_TOL
    err, ok = _compare(torch, out, ref, tol)
    again = fd.fused_decode_step(x, w, k, v, bt, lens, **kw)
    row = {"case": f"fused {form} lengths={lengths} H={H} Hkv={Hkv} hd={hd} "
                   f"D={D} bs={bs} blocks={nb} {dname} rope={rope} "
                   f"window={window}",
           "max_abs_err": err, "tol": tol,
           "err_over_tol": _err_over_tol(torch, out, ref, tol),
           "ok": ok and bool(torch.equal(out, again))}
    if timing:
        keys = _paged_keys(lengths, window)
        flops = 2.0 * R * D * H * hd + 4.0 * H * hd * keys
        es = x.element_size()
        # the q weight once (as stored, with its scale), the K/V rows of
        # [0, len), x, out, rope rows
        wbytes = sum(t.numel() * t.element_size() for t in w.values())
        nbytes = wbytes + (2 * keys * Hkv * hd + x.numel()
                           + R * H * hd) * es + 2 * 4 * R * hd \
            + 4 * (R + bt.numel())
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        sets = [(x, w, k, v)] + [
            (*xw(), *_paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb, disjoint)[:2]) for _ in range(2)]
        # "ms" device time from the profiler, "event_ms" the CUDA events
        # around a loop of calls (the wrapper's host side included)
        calls = [(lambda a=a: fd.fused_decode_step(a[0], a[1], a[2], a[3],
                                                   bt, lens, **kw))
                 for a in sets]
        row["ms"] = _device_ms(torch, calls)
        row["event_ms"] = _cold_ms(torch, calls)
        row["plain_ms"] = timed_ms(torch, lambda: fd.fused_decode_step_ref(
            x, w, k, v, bt, lens, **kw), iters=5)
        row["library_ms"] = None   # no single torch call computes it
        # the port's own unfused route on the same inputs, device time
        row["unfused_ms"] = _device_ms(torch, [
            (lambda a=a, f=_unfused_route(torch, a[1], a[2], a[3], bt, lens,
                                          cos, sin, window): f(a[0]))
            for a in sets])
    return row


def q4_bound_ms(b, din, dout, es=2):
    """Bound of one q4_matmul call: p4 (din/2 * dout bytes), the f32
    scale, x and out in x's dtype, over the memory rate; 2*b*din*dout
    operations at the bf16 rate."""
    nbytes = din // 2 * dout + 4 * dout + es * b * (din + dout)
    return _bound_ms(2.0 * b * din * dout, nbytes, "bfloat16")


def int4_row_bounds(cfg, rows=(1, 8), tp=2):
    """Bounds of q4_matmul_row on one tp rank: the row-parallel twin of
    q4_matmul runs the same work on a din/tp shard of o and down (the
    all-reduce after it is not counted)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    lin = {"o": (cfg.num_heads * cfg.head_dim, D), "down": (I, D)}
    out = {}
    for b in rows:
        row = {n: q4_bound_ms(b, din // tp, dout)[0]
               for n, (din, dout) in lin.items()}
        out[f"q4_matmul_row b={b} tp={tp} (per shard)"] = {
            "per_linear_ms": row,
            "per_weight_pass_ms": cfg.num_layers * sum(row.values()),
            "bound_by": q4_bound_ms(b, I // tp, D)[1]}
    return out


def _int4pack_call(torch, x, p4, scale):
    """torch._weight_int4pack_mm on the same function: per-channel scales
    (every 128-row group carries the channel's scale), zero 0, levels + 8
    as its unsigned nibbles. A yardstick only; None where the installed
    torch lacks it or refuses these inputs."""
    from distributed_llm_inferencing_tpu_torch.ops.quant import unpack_int4
    try:
        din, dout = p4.shape[0] * 2, p4.shape[1]
        u = (unpack_int4(p4).to(torch.int16) + 8).to(torch.uint8).t()
        packed = ((u[:, ::2] << 4) | u[:, 1::2]).contiguous()
        w = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.zeros(din // 128, dout, 2, dtype=torch.bfloat16,
                         device=x.device)
        sz[..., 0] = scale.to(torch.bfloat16)
        fn = lambda: torch._weight_int4pack_mm(x, w, 128, sz)  # noqa: E731
        fn()
        return fn
    except Exception as e:   # a yardstick, never a check
        log(f"  _weight_int4pack_mm not timed: {type(e).__name__}: {e}")
        return None


def check_q4(torch, qm, b, din, dout, dtype, timing=False, chunks=None):
    """q4_matmul (or, with ``chunks``, q4_matmul_row over a chunk-local
    pack of that many chunks) against its plain version on random packed
    bytes (every nibble value, -8 included) and scales near 0.02/7,
    within Q4_TOL; two launches give the same bits."""
    from distributed_llm_inferencing_tpu_torch.ops.quant import unpack_int4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(b * 131 + din + dout
                                                + (chunks or 0))
    if chunks is None:
        name, c = "q4_matmul", 1
        kernel, plain = qm.q4_matmul, qm.q4_matmul_ref
    else:
        name, c = "q4_matmul_row", chunks
        kernel = lambda x, p4, s: qm.q4_matmul_row(x, p4, s, c)  # noqa
        plain = lambda x, p4, s: qm.q4_matmul_row_ref(x, p4, s, c)  # noqa

    def weights():
        p4 = torch.randint(0, 256, (din // 2, dout), generator=g, device=dev,
                           dtype=torch.uint8)
        scale = (0.5 + torch.rand(dout, generator=g, device=dev)) * 0.02 / 7
        return p4, scale

    p4, scale = weights()
    x = torch.randn(b, din, generator=g, device=dev).to(dtype)
    out = kernel(x, p4, scale)
    again = kernel(x, p4, scale)
    torch.cuda.synchronize()
    ref = plain(x, p4, scale)
    levels = unpack_int4(p4, c).float()
    tol = 2 * din * 2.0 ** -24 * ((x.float().abs() @ levels.abs()) * scale)
    del levels
    if dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out.float()).all() and (err <= tol).all()
              and torch.equal(out, again))
    dname = str(dtype).replace("torch.", "")
    what = "" if chunks is None else f" chunks={chunks}"
    row = {"case": f"{name} b={b} din={din} dout={dout}{what} {dname}",
           "max_abs_err": float(err.max()), "tol": Q4_TOL, "ok": ok,
           "err_over_tol": float((err / tol.clamp_min(1e-30)).max())}
    if timing:
        row["bound_ms"], row["bound_by"] = q4_bound_ms(b, din, dout,
                                                       x.element_size())
        # cold: weight sets that together exceed the 50 MB L2, as a weight
        # pass meets each layer's weights once
        # "ms" is device time from the profiler (at these sizes the
        # wrapper's host side outlasts the kernels); "event_ms" the CUDA
        # events around a loop of calls, host included
        n = max(1, -(-64 * 2 ** 20 // (din // 2 * dout)))
        sets = [(p4, scale)] + [weights() for _ in range(n - 1)]
        calls = [(lambda a=a: kernel(x, *a)) for a in sets]
        row["ms"] = _device_ms(torch, calls)
        row["event_ms"] = _cold_ms(torch, calls)
        row["plain_ms"] = timed_ms(torch, lambda: plain(x, p4, scale),
                                   iters=3, warmup=1)
        # yardstick: the same function over a bf16 weight dequantized
        # beforehand (4x the bytes), levels exact in bf16
        dq = [(unpack_int4(a[0], c).to(x.dtype), a[1])
              for a in sets[:max(1, -(-64 * 2 ** 20 // (2 * din * dout)))]]
        row["library_ms"] = _device_ms(torch, [
            (lambda a=a: torch.matmul(x, a[0]) * a[1]) for a in dq])
        del dq
        if chunks is None:
            fn = _int4pack_call(torch, x, p4, scale)
            row["library2_ms"] = (None if fn is None
                                  else _device_ms(torch, [fn]))
            row["library2_max_abs_err"] = None if fn is None else float(
                (fn().float() - ref.float()).abs().max())   # reported only
        del sets
    return row


def phase_q4(torch, qm):
    """q4_matmul at llama-3-8b's shapes for b in {1, 8, 32}, x in bf16
    and f32, plus tests/test_pallas_parity.py's odd shapes; times at b=8
    in bf16 (the batched decode shape)."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {(n, b): check_q4(torch, qm, b, din, dout, bf16, timing=True)
             for b in (8, 1) for n, (din, dout) in Q4_SHAPES.items()}
    rows = [timed[("head", 8)]] + [r for k, r in timed.items()
                                    if k != ("head", 8)]
    for b in (1, 8, 32):
        for dt in (bf16, f32):
            for n, (din, dout) in Q4_SHAPES.items():
                if b in (1, 8) and dt == bf16:
                    continue
                rows.append(check_q4(torch, qm, b, din, dout, dt))
    for b, din, dout in ((1, 64, 128), (4, 64, 192), (8, 128, 384),
                         (3, 96, 160)):
        rows += [check_q4(torch, qm, b, din, dout, dt) for dt in (f32, bf16)]
    for row in rows:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in rows if not r["ok"]]
    assert not bad, f"q4_matmul disagrees with its plain version: {bad}"
    L = 32
    per_pass = {b: {k: L * sum(Q4_PASS[n] * timed[(n, b)][k]
                               for n in Q4_PASS) + timed[("head", b)][k]
                    for k in ("ms", "event_ms", "plain_ms", "bound_ms",
                              "library_ms")} for b in (8, 1)}
    for b in (8, 1):
        log(f"  q4_matmul per decode weight pass (b={b}, bf16: 32 x (2 q/o "
            "+ 2 k/v + 2 gate/up + down) + head):", json.dumps(per_pass[b]))
    return rows, per_pass


def phase_q4_row(torch, qm, cfg):
    """q4_matmul_row: llama-3-8b's row-parallel o (4096->4096) and down
    (14336->4096) whole, chunk-local for 2 and 4 chunks (the one-device
    form), b in {1, 8, 32}, x in bf16 and f32, plus
    tests/test_pallas_parity.py's chunked case (b=2, 128->256, 2 chunks)
    and a b=3 twin. Timed on what a tp=2 rank runs, its one chunk: o
    2048->4096 and down 7168->4096, b=1 (engine decode) and b=8, bf16.
    Returns (rows, the b=8 pass per rank)."""
    bf16, f32 = torch.bfloat16, torch.float32
    D, I, tp = cfg.hidden_size, cfg.intermediate_size, 2
    q_dim = cfg.num_heads * cfg.head_dim
    rank = {"o": (q_dim // tp, D), "down": (I // tp, D)}
    timed = {(n, b): check_q4(torch, qm, b, din, dout, bf16, timing=True,
                              chunks=1)
             for b in (8, 1) for n, (din, dout) in rank.items()}
    rows = [timed[("down", 8)]] + [r for k, r in timed.items()
                                    if k != ("down", 8)]
    for b in (1, 8, 32):
        for dt in (bf16, f32):
            for din, dout in ((q_dim, D), (I, D)):
                rows += [check_q4(torch, qm, b, din, dout, dt, chunks=c)
                         for c in (2, 4)]
    for b in (2, 3):
        rows += [check_q4(torch, qm, b, 128, 256, dt, chunks=2)
                 for dt in (f32, bf16)]
    for row in rows:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in rows if not r["ok"]]
    assert not bad, f"q4_matmul_row disagrees with its plain version: {bad}"
    per_pass = {k: cfg.num_layers * (timed[("o", 8)][k]
                                     + timed[("down", 8)][k])
                for k in ("ms", "event_ms", "plain_ms", "bound_ms",
                          "library_ms")}
    log("  q4_matmul_row per decode weight pass per tp=2 rank (b=8, bf16: "
        "32 x (o + down) on the rank's chunk):", json.dumps(per_pass))
    return rows, per_pass


def phase_paged_kernels(torch, pa, fd):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f32 = torch.bfloat16, torch.float32
    serve = [0, 1, 15, 16, 17, 300, 1000, 4096]
    paged = [check_paged(torch, pa, sdpa, serve, 32, 8, 128, bf16, nb=2048,
                         timing=True),
             # full occupancy: every slot at 4096, no block shared
             check_paged(torch, pa, sdpa, [4096] * 8, 32, 8, 128, bf16,
                         nb=8 * 256 + 1, timing=True, disjoint=True),
             check_paged(torch, pa, sdpa, serve, 32, 8, 128, f32, nb=2048),
             check_paged(torch, pa, sdpa, [5, 17, 32, 1], 4, 2, 16, f32,
                         bs=8),
             check_paged(torch, pa, sdpa, [0, 200, 33], 8, 2, 64, f32),
             check_paged(torch, pa, sdpa, [300, 17], 8, 2, 128, bf16,
                         window=64),
             check_paged(torch, pa, sdpa, [90, 3], 8, 1, 256, f32,
                         window=16),
             check_paged(torch, pa, sdpa, [64, 129], 4, 4, 64, bf16),
             # split edges (255/256/257/513), length 0, a table far wider
             # than every length, windows inside and across splits
             check_paged(torch, pa, sdpa, [255, 256, 257, 513, 0], 32, 8,
                         128, bf16, nb=1024),
             check_paged(torch, pa, sdpa, [1000, 700], 32, 8, 128, bf16,
                         window=400),
             check_paged(torch, pa, sdpa, [600, 5], 32, 8, 128, f32,
                         window=100)]
    full = dict(nb=8 * 256 + 1, timing=True, disjoint=True)
    fused = [check_fused(torch, fd, serve, 32, 8, 128, 4096, bf16, nb=2048,
                         timing=True),
             # full occupancy: every slot at 4096, no block shared
             check_fused(torch, fd, [4096] * 8, 32, 8, 128, 4096, bf16,
                         **full),
             check_fused(torch, fd, serve, 32, 8, 128, 4096, f32, nb=2048,
                         timing=True),
             check_fused(torch, fd, [7, 21, 12], 4, 2, 16, 32, f32, bs=8),
             check_fused(torch, fd, [19, 8], 4, 2, 16, 32, f32, bs=8,
                         rope=False, window=5),
             check_fused(torch, fd, [100, 3, 0], 8, 1, 128, 512, bf16),
             check_fused(torch, fd, [100, 33], 8, 8, 64, 512, f32),
             check_fused(torch, fd, [1000, 17], 32, 8, 128, 4096, f32,
                         window=256),
             # the cluster kernel's edges: three row groups, MQA, D = 40
             check_fused(torch, fd, [(37 * i) % 700 for i in range(17)], 4,
                         1, 16, 40, f32, bs=8, window=100),
             check_fused(torch, fd, [(37 * i) % 700 for i in range(17)], 4,
                         1, 16, 40, bf16, bs=8, window=100)]
    quant = {}
    for form in ("int8", "int4"):
        quant[form] = [
            check_fused(torch, fd, serve, 32, 8, 128, 4096, bf16, nb=2048,
                        timing=True, form=form),
            check_fused(torch, fd, [4096] * 8, 32, 8, 128, 4096, bf16,
                        form=form, **full),
            check_fused(torch, fd, serve, 32, 8, 128, 4096, f32, nb=2048,
                        timing=True, form=form),
            check_fused(torch, fd, [7, 21, 12], 4, 2, 16, 32, f32, bs=8,
                        form=form),
            check_fused(torch, fd, [19, 8], 4, 4, 16, 32, bf16, bs=8,
                        rope=False, window=5, form=form),
            check_fused(torch, fd, [1000, 17], 32, 8, 128, 4096, f32,
                        window=256, form=form),
            # two row groups, item edges, length 0
            check_fused(torch, fd, [0, 255, 257, 1000, 4, 1, 17, 300, 64],
                        8, 2, 64, 128, bf16, form=form)]
    every = paged + fused + quant["int8"] + quant["int4"]
    for row in every:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in every if not r["ok"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    return paged, fused, quant


def phase_kernels(torch, fa):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 prefill at the engine's prompt buckets up to max_seq 4096
    pre = [check_prefill(torch, fa, sdpa, 1, S, 32, 8, 128, bf16,
                         timing=True) for S in (512, 2048, 4096)]
    pre += [check_prefill(torch, fa, sdpa, 2, 100, 8, 2, 64, f32),
           check_prefill(torch, fa, sdpa, 2, 300, 8, 2, 128, bf16, window=64),
           check_prefill(torch, fa, sdpa, 1, 64, 8, 8, 32, f32, alibi=True),
           check_prefill(torch, fa, sdpa, 1, 80, 4, 2, 256, f32, window=20,
                         alibi=True),
           check_prefill(torch, fa, sdpa, 2, 40, 8, 4, 8, f32),
           # the tensor-core form's edges: ragged tiles, MQA/MHA, hd 64
           # and 256 (32-key tiles), window across tiles, ALiBi
           check_prefill(torch, fa, sdpa, 1, 513, 8, 1, 128, bf16,
                         alibi=True),
           check_prefill(torch, fa, sdpa, 2, 77, 4, 4, 256, bf16, window=20),
           check_prefill(torch, fa, sdpa, 1, 100, 8, 2, 64, bf16),
           check_prefill(torch, fa, sdpa, 2, 40, 8, 4, 8, bf16)]
    dec = [check_decode(torch, fa, sdpa, [1, 37, 1000, 4096], 4096, 32, 8,
                        128, bf16, timing=True),
           # the engine's shapes: B=1 over a 4096-slot cache, llama-3-8b
           # and a tp=2 rank's half of its heads
           check_decode(torch, fa, sdpa, [532], 4096, 32, 8, 128, bf16,
                        timing=True),
           check_decode(torch, fa, sdpa, [4096], 4096, 32, 8, 128, bf16,
                        timing=True),
           check_decode(torch, fa, sdpa, [4096], 4096, 16, 4, 128, bf16,
                        timing=True),
           check_decode(torch, fa, sdpa, [0, 1, 200], 256, 8, 2, 64, f32),
           check_decode(torch, fa, sdpa, [200, 17], 256, 8, 2, 128, bf16,
                        window=64),
           check_decode(torch, fa, sdpa, [37, 101], 128, 8, 2, 32, f32,
                        alibi=True),
           check_decode(torch, fa, sdpa, [90, 3], 128, 4, 1, 256, f32,
                        window=16, alibi=True),
           check_decode(torch, fa, sdpa, [5, 60], 64, 8, 4, 8, f32)]
    for row in pre + dec:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in pre + dec if not r["ok"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    return pre, dec


# gemma-2-9b's attention: 16 query heads over 8 kv heads of hd 256, its
# attention score softcap and sliding window
GEMMA_ATTN = dict(H=16, Hkv=8, hd=256)
GEMMA_SOFTCAP, GEMMA_WINDOW = 50.0, 4096
# uncapped_digests of the kernels before their cap arm existed (the tree
# at commit a5beff9, ``python3 chip_smoke.py --digests`` on an NVIDIA H100
# 80GB HBM3): phase 2 and tests/test_torch_cuda_kernels.py hold the
# uncapped arms to them
UNCAPPED_DIGESTS = {
    "flash_attention/bfloat16/hd128/wNone": "af170f4c81e11005bb6616f2",
    "flash_attention/bfloat16/hd128/w64": "1b382ce9ca13a6eeaa0e7195",
    "flash_decode/bfloat16/hd128/wNone": "67fdf27fb4b50eaaf96c6561",
    "flash_decode/bfloat16/hd128/w100": "1bf69621880cae95d3179b53",
    "paged_flash_decode/bfloat16/hd128/wNone": "4b735b146baccacba6f4b03a",
    "paged_flash_decode/bfloat16/hd128/w100": "ff68ab4ff117060b7fbdc2f8",
    "flash_attention/bfloat16/hd256/wNone": "5d4145431764ad4cce358b79",
    "flash_attention/bfloat16/hd256/w64": "b9bef58e3f7c572671afb21e",
    "flash_decode/bfloat16/hd256/wNone": "3f4416cb5c3c4e4724f3597d",
    "flash_decode/bfloat16/hd256/w100": "a2943d6a14c34efbc8378056",
    "paged_flash_decode/bfloat16/hd256/wNone": "446a0595638aea221a175084",
    "paged_flash_decode/bfloat16/hd256/w100": "4273ef510ae36a457714cc4d",
    "flash_attention/float32/hd128/wNone": "35e94c56ac61039c70be4459",
    "flash_attention/float32/hd128/w64": "1c5f4443141b3da90b633ca1",
    "flash_decode/float32/hd128/wNone": "37e72f3deb892f20df9ee309",
    "flash_decode/float32/hd128/w100": "8e6f91f14ad6370eb9980426",
    "paged_flash_decode/float32/hd128/wNone": "57936318830bc91b792a49f3",
    "paged_flash_decode/float32/hd128/w100": "68faf0bed6f5260d9fb2e603",
    "flash_attention/float32/hd256/wNone": "e8a1d733b1e2a1faf7576fd6",
    "flash_attention/float32/hd256/w64": "4c498009080036a6fce978ea",
    "flash_decode/float32/hd256/wNone": "5e0110dac7fbccb21b05e7aa",
    "flash_decode/float32/hd256/w100": "3a61296a1f048666ce01b60a",
    "paged_flash_decode/float32/hd256/wNone": "f9315e37c3b100f311a7afb5",
    "paged_flash_decode/float32/hd256/w100": "9b31e2848a748b6cf1991be5",
}


def phase_softcap_kernels(torch, fa, pa):
    """Phase 2's softcap arms (flash_attention's two forms, flash_decode
    and paged_flash_decode, the last two through split_decode.cuh), each
    held to its plain version (same bits on a relaunch): bf16 and f32, hd
    128 and 256, GQA and MQA, with and without a window, odd lengths, a
    cap that bites (0.5-3) and gemma-2's 50; timed at gemma-2-9b's shapes
    (prefill S=512 and 4096, decode B=1 at 4500 keys of an 8192-slot
    cache, paged R=8 at full occupancy), each beside the uncapped arm on
    the same inputs and SDPA without a cap (it has none: the pace only).
    Returns (prefill rows, decode rows, paged rows), timed rows first."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f32 = torch.bfloat16, torch.float32
    H, Hkv, hd = GEMMA_ATTN["H"], GEMMA_ATTN["Hkv"], GEMMA_ATTN["hd"]
    cap, win = GEMMA_SOFTCAP, GEMMA_WINDOW
    pre = [check_prefill(torch, fa, sdpa, 1, S, H, Hkv, hd, bf16,
                         timing=True, softcap=cap) for S in (512, 4096)]
    pre += [check_prefill(torch, fa, sdpa, 1, 4500, H, Hkv, hd, bf16,
                          window=win, softcap=cap),
            check_prefill(torch, fa, sdpa, 2, 300, 8, 2, 128, bf16,
                          softcap=2.0),
            check_prefill(torch, fa, sdpa, 1, 129, 8, 1, 256, bf16,
                          window=50, softcap=1.0),
            check_prefill(torch, fa, sdpa, 1, 100, 8, 2, 64, bf16,
                          alibi=True, softcap=3.0),
            check_prefill(torch, fa, sdpa, 2, 77, 8, 2, 128, f32,
                          window=20, softcap=1.5),
            check_prefill(torch, fa, sdpa, 1, 65, 4, 1, 256, f32,
                          softcap=0.5),
            check_prefill(torch, fa, sdpa, 1, 64, 8, 8, 32, f32,
                          alibi=True, softcap=3.0)]
    dec = [check_decode(torch, fa, sdpa, [4500], 8192, H, Hkv, hd, bf16,
                        timing=True, softcap=cap),
           check_decode(torch, fa, sdpa, [4500], 8192, H, Hkv, hd, bf16,
                        window=win, softcap=cap),
           check_decode(torch, fa, sdpa, [0, 77, 1000], 1024, 8, 1, 256,
                        bf16, window=100, softcap=2.0),
           check_decode(torch, fa, sdpa, [1, 37, 300], 512, 8, 2, 128, f32,
                        softcap=1.5),
           check_decode(torch, fa, sdpa, [90, 3], 128, 4, 1, 256, f32,
                        window=16, softcap=0.7),
           check_decode(torch, fa, sdpa, [37, 101], 128, 8, 2, 32, f32,
                        alibi=True, softcap=3.0)]
    paged = [check_paged(torch, pa, sdpa, [4096] * 8, H, Hkv, hd, bf16,
                         nb=8 * 256 + 1, timing=True, disjoint=True,
                         softcap=cap),
             check_paged(torch, pa, sdpa, [0, 1, 15, 16, 17, 300, 1000, 4500],
                         H, Hkv, hd, bf16, nb=2048, window=win, softcap=cap),
             check_paged(torch, pa, sdpa, [255, 256, 257, 513, 0], 8, 2,
                         128, f32, softcap=1.5),
             check_paged(torch, pa, sdpa, [300, 17], 8, 1, 256, bf16,
                         window=64, softcap=2.0),
             check_paged(torch, pa, sdpa, [90, 3], 8, 1, 256, f32,
                         window=16, softcap=0.5)]
    for row in pre + dec + paged:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in pre + dec + paged if not r["ok"]]
    assert not bad, f"softcap arms disagree with their plain versions: {bad}"
    return pre, dec, paged


def uncapped_digests(torch):
    """sha256 of each attention kernel's output without a cap on fixed
    inputs drawn on the host (numpy, seed 2024): flash_attention's two
    forms (bf16 hd 128 and 256 on the tensor cores, f32 on the CUDA
    cores), flash_decode and paged_flash_decode in bf16 and f32, with and
    without a window. The wrappers are called as they were before the cap
    arm existed, so a tree without it gives its own digests for the
    comparison (UNCAPPED_DIGESTS)."""
    import hashlib

    import numpy as np

    from distributed_llm_inferencing_tpu_torch.ops import (
        flash_attention as fa, paged_attention as pa)
    rng = np.random.default_rng(2024)

    def t(shape, dtype):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to("cuda").to(dtype)

    def digest(x):
        torch.cuda.synchronize()
        bits = x.contiguous().view({2: torch.int16, 4: torch.int32}[
            x.element_size()]).cpu().numpy()
        return hashlib.sha256(bits.tobytes()).hexdigest()[:24]

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        for hd in (128, 256):
            q, k, v = t((2, 300, 8, hd), dt), t((2, 300, 2, hd), dt),                 t((2, 300, 2, hd), dt)
            for w in (None, 64):
                out[f"flash_attention/{name}/hd{hd}/w{w}"] = digest(
                    fa.flash_attention(q, k, v, sliding_window=w))
            q, k, v = t((3, 1, 8, hd), dt), t((3, 600, 2, hd), dt),                 t((3, 600, 2, hd), dt)
            lens = torch.tensor([1, 200, 600], dtype=torch.int32,
                                device="cuda")
            for w in (None, 100):
                out[f"flash_decode/{name}/hd{hd}/w{w}"] = digest(
                    fa.flash_decode(q, k, v, lens, sliding_window=w))
            kp, vp = t((128, 16, 2, hd), dt), t((128, 16, 2, hd), dt)
            bt = torch.from_numpy(rng.permutation(127)[:3 * 40].reshape(
                3, 40).astype(np.int32) + 1).to("cuda")
            for w in (None, 100):
                out[f"paged_flash_decode/{name}/hd{hd}/w{w}"] = digest(
                    pa.paged_flash_decode(q, kp, vp, bt, lens,
                                          sliding_window=w))
    return out


# ---------------------------------------------------------------------
# phase 3: the main path through the port's worker
# ---------------------------------------------------------------------

def zero_counts(kernels):
    """Set every launch counter of ``kernels`` (name -> (module, wrapper
    name, counter attribute)) to 0."""
    for mod, fn, attr in kernels.values():
        setattr(getattr(mod, fn), attr, 0)


def read_counts(kernels):
    return {k: getattr(getattr(mod, fn), attr)
            for k, (mod, fn, attr) in kernels.items()}


def _http(url, body=None, timeout=900):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# phase 3's requests: (prompt tokens, sampling, seed); the byte tokenizer
# makes BOS + one token per byte -> 100/200/500 tokens, prefill buckets
# 128/256/512 (prefill rows > 32: the plain unpack)
ENGINE_REQUESTS = ((100, {"do_sample": False}, 0), (200, {}, 1),
                   (500, {}, 2))


def engine_prompt(n_tok, seed):
    return "".join(chr(97 + (i * 7 + seed) % 26) for i in range(n_tok - 1))


def _engine_requests(torch, base, kernels, cfg, model_name, q4_per_step,
                     requests=ENGINE_REQUESTS, decode_kernel=True,
                     prefill_kernel=True):
    """Phase 3's three requests (or ``requests``: (prompt tokens,
    sampling, seed) each) through a loaded engine-mode model (bf16
    activations): counts zeroed before, each request must add one
    flash_attention launch per layer, each in its tensor-core form
    ("flash_attention[mma]"), one flash_decode launch per layer per
    decode step and
    ``q4_per_step`` q4_matmul launches per decode step plus one for the
    gathered head row of its prefill (int4; 0 otherwise), and nothing
    else; with ``decode_kernel`` False (an int8 KV cache: the plain
    decode route) no flash_decode, with ``prefill_kernel`` False (latent
    attention, sinks: the plain prefill) no flash_attention. Returns
    (launches, request rows)."""
    L, new = cfg.num_layers, 32
    zero_counts(kernels)                 # counts of this path only
    count = lambda: read_counts(kernels)  # noqa: E731
    rows = []
    for n_tok, sampling, seed in requests:
        text = engine_prompt(n_tok, seed)
        n0 = count()
        st, r = _http(base + "/inference", {
            "model_name": model_name, "prompt": text,
            "max_new_tokens": new, "sampling": sampling, "seed": seed})
        assert st == 200 and r["status"] == "success", r
        toks, passes = r["tokens"], r["cost"]["weight_passes"]
        d = {k: v - n0[k] for k, v in count().items()}
        assert all(0 <= t < cfg.vocab_size for t in toks), toks
        want = {k: 0 for k in d}
        want.update(flash_attention=L * int(prefill_kernel),
                    flash_decode=L * (passes - 1) * int(decode_kernel),
                    q4_matmul=(1 + q4_per_step * (passes - 1)
                               if q4_per_step else 0))
        # bf16: the prefill and every q4_matmul in their tensor-core forms
        want["flash_attention[mma]"] = want["flash_attention"]
        want["q4_matmul[mma]"] = want["q4_matmul"]
        assert d == want, f"launches {d} != {want}"
        assert passes <= new and (len(toks) == new or (
            len(toks) < new and passes >= len(toks) + 1)), (toks, passes)
        row = {"prompt_tokens": n_tok, "sampling": sampling or "default",
               "tokens": toks, "new_tokens": len(toks),
               "weight_passes": passes,
               "prefill_ms": r["prefill_ms"],
               "decode_ms_per_weight_pass": r["decode_ms"] / (passes - 1),
               "decode_tokens_per_s": r["tokens_per_s"],
               "execution_s": r["execution_time"],
               "launches": {k: v for k, v in d.items() if v}}
        log("  request", json.dumps(row))
        rows.append(row)
    return count(), rows


def phase_main_path(torch, kernels):
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    cfg = get_config("llama-3-8b")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    try:
        st, health = _http(base + "/health")
        assert st == 200 and health["device"]["platform"] == "gpu", health
        torch.cuda.reset_peak_memory_stats()
        st, res = _http(base + "/load_model", {
            "model_name": "llama-3-8b", "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096})
        assert st == 200 and res["status"] == "success", res
        log(f"  load_model: {res['load_time_s']:.2f} s, "
            f"{res['stats']['param_bytes'] / 1e9:.3f} GB of weights")
        launches, rows = _engine_requests(torch, base, kernels, cfg,
                                          "llama-3-8b", 0)
        peak = torch.cuda.max_memory_allocated()
        log(f"  peak device memory: {peak / 2**30:.3f} GiB "
            "(torch.cuda.max_memory_allocated)")
        st, _ = _http(base + "/unload_model", {"model_name": "llama-3-8b"})
        assert st == 200
    finally:
        worker.shutdown()
    return launches, rows, peak


# ---------------------------------------------------------------------
# phase 4: card (kernels) against host (plain versions), full width
# ---------------------------------------------------------------------

def q4_per_pass(cfg, fused=False):
    """q4_matmul launches of one int4 weight pass of <= 32 rows: every
    linear of every layer (each layer's own: a dense-prefix layer's MLP;
    the q projection inside the fused kernel when ``fused``; not latent
    attention's kv_b_k / kv_b_v over the latent cache, which its absorbed
    einsums read whole) and an untied head."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        layer_linears)
    per = [len(layer_linears(cfg.layer_cfg(i))) - int(fused)
           - 2 * int(cfg.mla_latent_cache) for i in range(cfg.num_layers)]
    return sum(per) + int(not cfg.tie_word_embeddings)


def decode_kernel(cfg, route):
    """The kernel a batched decode step of ``cfg`` launches per layer with
    DLI_FUSED_DECODE on (``route`` "fused") or off: the fused kernel
    where its gate takes the q leaf (no bias), else the paged kernel;
    None for the ALiBi families, an int8 KV pool, sinks and latent
    attention, which decode through the gather formulation, as the JAX
    package does."""
    from distributed_llm_inferencing_tpu_torch.ops import fused_decode
    if cfg.position_embedding == "alibi" or cfg.kv_quant or cfg.mla \
            or cfg.attn_sinks:
        return None
    if route == "fused" and fused_decode.supported(cfg) \
            and not cfg.attn_bias:
        return "fused_decode_step"
    return "paged_flash_decode"


def _widen_levels_once(torch, model):
    """The host model's int8 and int4 linears with their levels widened
    to f32 once: each computes what Linear.forward's plain path does (x
    @ levels in f32, then times the scale, then the bias), without the
    per-call int4 unpack and f32 widening that took most of a quantized
    cross-check's host time."""
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Linear)
    from distributed_llm_inferencing_tpu_torch.ops.quant import (
        pack_chunks, unpack_int4)

    def forward(m, levels, x):
        y = (torch.matmul(x, levels) * m.scale.to(x.dtype)).to(x.dtype)
        return y if m.b is None else (y + m.b).to(x.dtype)
    for m in model.modules():
        if isinstance(m, Linear) and m.form in ("int8", "int4"):
            assert m.tp is None
            levels = (unpack_int4(m.p4, pack_chunks(m.leaf()))
                      if m.form == "int4" else m.q).float()
            m.forward = functools.partial(forward, m, levels)
    return model


class _PlainKernels:
    """Within the block, the model's attention kernels are swapped for
    their plain versions (on the card: phase 6's way of running the plain
    path there)."""

    def __enter__(self):
        from distributed_llm_inferencing_tpu_torch.ops import (
            attention as ta, flash_attention as fa, paged_attention as pa,
            paged_kvcache as pk)
        self.old = [(ta, "flash_attention", ta.flash_attention),
                    (ta, "flash_decode", ta.flash_decode),
                    (pk, "paged_flash_decode", pk.paged_flash_decode)]
        ta.flash_attention = fa.flash_attention_ref
        ta.flash_decode = fa.flash_decode_ref
        pk.paged_flash_decode = pa.paged_flash_decode_ref

    def __exit__(self, *exc):
        for mod, name, fn in self.old:
            setattr(mod, name, fn)


def phase_cross_check(torch, fa, qm, quant=None, name="llama-3-8b",
                      routes=("paged", "fused"), cfg=None, layers=2,
                      ref_on_card=False):
    """Card (kernels) against host (plain versions) at ``name``'s full
    width (or ``cfg``'s), ``layers`` layers, f32, with float weights or
    ``quant`` ("int8"/"int4") ones; the paged path once per decode
    ``route``. Sinks and latent attention launch no attention kernel (the
    plain formulation on every device); a latent-attention config's dense
    path is checked on the latent cache too. ``ref_on_card``: the
    reference runs on the card with the attention kernels swapped for
    their plain versions (``_PlainKernels``), where the host's f32
    forward at the row's width would take too long."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    cfg = (cfg or get_config(name)).replace(num_layers=layers,
                                            dtype="float32", quant=quant)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    host = params if ref_on_card else {k: t.cpu()
                                       for k, t in params.items()}
    models = {"cuda": Transformer(cfg, params),
              "cpu": _widen_levels_once(torch, Transformer(cfg, host))}
    g = torch.Generator().manual_seed(8)
    B, S0, max_seq = 2, 64, 96
    lens = torch.tensor([37, 64], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S0), generator=g)
    toks[0, 37:] = 0
    forced = torch.randint(0, cfg.vocab_size, (8, B, 1), generator=g)
    logits, caches = {}, {}
    n0 = (fa.flash_attention.launches, fa.flash_decode.launches,
          qm.q4_matmul.launches, qm.q4_matmul.launches_mma)
    if cfg.mla:   # the latent cache's dense path beside the materialized
        lat = cfg.replace(mla_latent_cache=True)
        models.update({"cuda-latent": Transformer(lat, params),
                       "cpu-latent": Transformer(lat, host)})
    with torch.inference_mode():
        for key, model in models.items():
            ref = key.startswith("cpu")
            dev = "cuda" if ref_on_card or not ref else "cpu"
            with _PlainKernels() if ref and ref_on_card else _Env():
                cache = init_cache(model.cfg, B, max_seq, device=dev)
                lg, cache = model.prefill(toks.to(dev), lens.to(dev), cache)
                outs = [torch.cat([lg[0, :37], lg[1]]).cpu()]
                for t in range(8):
                    lg, cache = model.decode_step(forced[t].to(dev), cache)
                    outs.append(lg[:, 0].cpu())
            logits[key] = torch.cat(outs)
            caches[key] = cache
    n1 = (fa.flash_attention.launches, fa.flash_decode.launches,
          qm.q4_matmul.launches, qm.q4_matmul.launches_mma)
    # int4: prefill rows (2 x 64) and its full-row head take the plain
    # unpack; each of the 8 decode steps runs every linear x 2 layers +
    # an untied head, all f32, so all on the CUDA-core form
    q4 = 8 * q4_per_pass(cfg) if quant == "int4" else 0
    # sinks, latent attention: no kernel; an int8 cache: the plain decode
    attn = int(not (cfg.mla or cfg.attn_sinks))
    decode = 0 if cfg.kv_quant else 8 * layers * attn
    assert tuple(b - a for a, b in zip(n0, n1)) == (layers * attn, decode,
                                                    q4, 0), (n0, n1)
    what = f"{name} {quant or 'float'} "
    tol = XCHECK_TOL
    if cfg.kv_quant:
        tol = INT8_KV_XCHECK_TOL
        errs = {"levels": _level_check(torch, caches)}
    else:
        errs = {}
    errs["dense"] = _xcheck(torch, what + "dense", logits["cuda"],
                            logits["cpu"], tol)
    if cfg.mla:
        errs["dense_latent"] = _xcheck(torch, what + "dense, latent cache",
                                       logits["cuda-latent"],
                                       logits["cpu-latent"], tol)
    if ref_on_card:
        with _PlainKernels():
            ref = _paged_run(torch, models["cpu"], "cuda")
    else:
        ref = _paged_run(torch, models["cpu"], "cpu")
    for route in routes:
        errs[route] = _xcheck(torch, what + route,
                              _paged_run(torch, models["cuda"], "cuda",
                                         route), ref, tol)
    del models, params, host
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _level_check(torch, caches, what="card vs host"):
    """An int8 cache's levels on card and host (``caches["cuda"]``,
    ``caches["cpu"]``; or ``what`` else): at most one step apart,
    on at most 1% of the elements; the scales (each a head vector's
    |max|/127) within the f32 cross-check's relative tolerance. Returns
    the shares."""
    card, host = caches["cuda"], caches["cpu"]
    out = {}
    for name in ("k", "v"):
        a = getattr(card, name).cpu().int()
        b = getattr(host, name).int()
        d = (a - b).abs()
        share = float((d > 0).float().mean())
        assert int(d.max()) <= 1 and share <= 0.01, (name, int(d.max()),
                                                      share)
        sa = getattr(card, name + "_scale").cpu()
        sb = getattr(host, name + "_scale")
        rel = float(((sa - sb).abs() / sb.clamp(min=1e-30)).max())
        assert rel <= XCHECK_TOL[1], (name, rel)
        out[name] = {"levels_off_by_one": share, "scale_rel_err": rel}
    log(f"  int8 cache, {what}:", json.dumps(out))
    return out


def _xcheck(torch, what, a, b, tol=XCHECK_TOL):
    assert torch.isfinite(a).all()
    err = (a - b).abs()
    atol, rtol = tol
    log(f"  cross-check {what}: full width, 2 layers, f32, "
        f"{a.shape[0]} logit rows: max_abs_err {float(err.max()):.3e} "
        f"(tol {atol} + {rtol}*|ref|), logits |max| {float(b.abs().max()):.3f}")
    assert bool((err <= atol + rtol * b.abs()).all()), \
        f"card and host logits disagree ({what})"
    return float(err.max())


def _paged_run(torch, model, dev, route=None):
    """paged_prefill_tail (a 32-token prompt, then a wave of two tails, one
    reusing that prompt's blocks as its cached prefix) + 8 teacher-forced
    paged_decode_steps; decode attention through `route` ("paged" or
    "fused") on the card. Returns the logits rows [N, V] on the host."""
    from distributed_llm_inferencing_tpu_torch.ops import (
        fused_decode as fd, paged_attention as pa, quant_matmul as qm)
    from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
        init_paged_cache)
    cfg = model.cfg
    V, bs = cfg.vocab_size, 16
    g = torch.Generator().manual_seed(9)
    i32 = dict(dtype=torch.int32, device=dev)
    paged = init_paged_cache(cfg, 16, bs, device=dev)
    prompt = torch.randint(0, V, (1, 32), generator=g)
    tails = torch.randint(0, V, (2, 48), generator=g)
    forced = torch.randint(0, V, (8, 2), generator=g)
    os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
    n0 = (pa.paged_flash_decode.launches, fd.fused_decode_step.launches,
          qm.q4_matmul.launches)
    outs = []
    try:
        with torch.inference_mode():
            lg, _ = model.paged_prefill_tail(
                prompt.to(dev), torch.tensor([32], **i32),
                torch.tensor([[1, 2]], **i32), torch.tensor([[0, 0]], **i32),
                torch.tensor([0], **i32), paged)
            outs.append(lg.cpu())
            lg, _ = model.paged_prefill_tail(
                tails.to(dev), torch.tensor([20, 37], **i32),
                torch.tensor([[3, 4, 5], [6, 7, 8]], **i32),
                torch.tensor([[1, 2], [0, 0]], **i32),
                torch.tensor([32, 0], **i32), paged)
            outs.append(lg.cpu())
            bt = torch.tensor([[1, 2, 3, 4], [6, 7, 8, 9]], **i32)
            cl = torch.tensor([52, 37], **i32)
            for t in range(8):
                lg, _ = model.paged_decode_step(forced[t].to(dev), paged, bt,
                                                cl)
                outs.append(lg.cpu())
                cl = cl + 1
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    d = (pa.paged_flash_decode.launches - n0[0],
         fd.fused_decode_step.launches - n0[1],
         qm.q4_matmul.launches - n0[2])
    kernel = decode_kernel(cfg, route) if route else None
    want = tuple(8 * cfg.num_layers if kernel == k else 0
                 for k in ("paged_flash_decode", "fused_decode_step"))
    # int4 on the card: the 32-row first prefill runs every linear through
    # the kernel (and an untied head on its last row), the 96-row second
    # one only its 2-row head, each decode step every linear (the q
    # projection inside the fused kernel) x 2 + head
    fused = kernel == "fused_decode_step"
    untied = int(not cfg.tie_word_embeddings)
    q4 = (q4_per_pass(cfg) + untied + 8 * q4_per_pass(cfg, fused)
          if cfg.quant == "int4" and route else 0)
    want = want + (q4,)
    assert d == want, f"{route}: kernel launches {d} != {want}"
    return torch.cat(outs)


# ---------------------------------------------------------------------
# phase 5: batched serving through the port's worker
# ---------------------------------------------------------------------

def _batched_bodies(cfg, lens=PROMPT_LENS):
    """8 requests: prompts of ``lens`` tokens plus two that share a
    512-token prefix with different 40-token tails; even ones greedy, odd
    ones sampled, all seeded."""
    import numpy as np
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(1, cfg.vocab_size, n).tolist()  # noqa
    prefix = tok(SHARED_PREFIX)
    prompts = [tok(n) for n in lens] + [
        prefix + tok(SHARED_TAIL), prefix + tok(SHARED_TAIL)]
    return [{"model_name": cfg.name, "prompt_tokens": p,
             "max_new_tokens": NEW_TOKENS, "seed": 100 + i,
             "sampling": ({"do_sample": False} if i % 2 == 0 else
                          {"temperature": 0.8, "top_k": 50, "top_p": 0.95})}
            for i, p in enumerate(prompts)]


def _batched_pass(torch, base, worker, kernels, route, cfg, quant=None,
                  load=None, check=None):
    """Phase 5's 8 concurrent requests through a batched llama-3-8b load
    (``quant``: "int8"/"int4" weights; ``load``: another load body of the
    same shapes, and ``check(loaded model)`` run before the unload).
    Counts are zeroed before: the
    route's attention kernel must launch num_layers times per decode
    weight pass and no other attention kernel may launch; in int4,
    q4_matmul launches (7 linears, 6 with the fused q) x num_layers + 1
    per decode pass, plus, per prefill wave, one for the gathered head
    rows and 7 x num_layers more if the wave has <= 32 rows."""
    bodies = _batched_bodies(cfg)
    L = cfg.num_layers
    load = load or dict(BATCHED_LOAD, quantize=quant)
    name = load["model_name"]
    torch.cuda.reset_peak_memory_stats()
    st, res = _http(base + "/load_model", load)
    assert st == 200 and res["status"] == "success", res
    st, health = _http(base + "/health")
    [desc] = [m for m in health["loaded_models"] if m["name"] == name]
    assert desc["quantize"] == quant, desc
    log(f"  load_model (batched, {quant or 'bf16'}, {route}): "
        f"{res['load_time_s']:.2f} s, {desc['param_bytes'] / 1e9:.3f} GB "
        "of weights")
    batcher = worker.models[name].batcher
    wave_rows = []                       # rows of every prefill wave
    prefill = batcher.model.paged_prefill_tail

    def recorded(tokens, *a, **kw):
        wave_rows.append(tokens.shape[0] * tokens.shape[1])
        return prefill(tokens, *a, **kw)

    batcher.model.paged_prefill_tail = recorded
    snap = lambda: worker.metrics.snapshot()  # noqa: E731
    s0 = snap()
    zero_counts(kernels)                 # counts of this pass only
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        got = list(ex.map(lambda b: _http(base + "/inference", b), bodies))
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    s1 = snap()
    passes, emitted = (s1["counters"].get(k, 0) - s0["counters"].get(k, 0)
                       for k in ("batcher_weight_passes",
                                 "batcher_tokens_emitted"))
    chunk_s = (s1["timings"]["batcher_decode_chunk"]["sum"]
               - s0["timings"].get("batcher_decode_chunk", {}).get("sum", 0))
    rows, tokens = [], []
    for body, (st, r) in zip(bodies, got):
        assert st == 200 and r["status"] == "success", r
        toks = r["tokens"]
        assert 1 <= len(toks) <= NEW_TOKENS, toks
        assert all(0 <= t < cfg.vocab_size for t in toks), toks
        tokens.append(toks)
        rows.append({"prompt_tokens": len(body["prompt_tokens"]),
                     "greedy": body["sampling"].get("do_sample") is False,
                     "new_tokens": len(toks), "ttft_ms": r["ttft_ms"],
                     "cost": r["cost"]})
    # "gather": an int8 pool's plain route, no decode kernel at all
    mine = {"paged": "paged_flash_decode",
            "fused": "fused_decode_step"}.get(route)
    for k in ("paged_flash_decode", "fused_decode_step", "flash_attention",
              "flash_decode"):
        want = L * passes if k == mine else 0
        assert launches[k] == want, \
            f"{k} launches {launches[k]} != {want} ({passes} weight passes)"
    q4 = 0
    if quant == "int4":
        per_pass = (6 if route == "fused" else 7) * L + 1
        q4 = passes * per_pass + sum(1 + (7 * L if n <= 32 else 0)
                                     for n in wave_rows)
    assert launches["q4_matmul"] == q4, \
        f"q4_matmul launches {launches['q4_matmul']} != {q4} " \
        f"({passes} passes, prefill waves of {wave_rows} rows)"
    assert launches["q4_matmul[mma]"] == q4, \
        f"bf16 q4_matmul calls off the tensor cores: {launches}"
    cached = [r["cost"]["prefill_cached_tokens"] for r in rows[-2:]]
    assert max(cached) >= SHARED_PREFIX, \
        f"shared-prefix requests cached {cached} prompt tokens"
    peak = torch.cuda.max_memory_allocated()
    st, health = _http(base + "/health")
    [desc] = [m for m in health["loaded_models"] if m["name"] == name]
    # the captured decode step's scratch (int8: its bf16 weight copies)
    pool = desc["scheduler"]["decode_graph_pool_bytes"]
    # drop the recorder (it holds the model) before the unload frees it
    del batcher.model.paged_prefill_tail, batcher, recorded, prefill
    checked = check(worker.models[name]) if check is not None else None
    summary = {"weights": quant or "bf16", "route": route, "wall_s": wall,
               "check": checked,
               "generated_tokens": sum(len(t) for t in tokens),
               "tokens_per_s": sum(len(t) for t in tokens) / wall,
               "weight_passes": passes,
               "decode_tokens_per_weight_pass": emitted / passes,
               "decode_chunk_ms_per_weight_pass": 1e3 * chunk_s / passes,
               "prefill_wave_rows": wave_rows,
               "param_bytes": desc["param_bytes"],
               "peak_memory_bytes": peak, "decode_graph_pool_bytes": pool,
               "launches": launches, "requests": rows}
    for row in rows:
        log("  request", json.dumps(row))
    log("  wave", json.dumps({k: v for k, v in summary.items()
                              if k != "requests"}))
    st, _ = _http(base + "/unload_model", {"model_name": name})
    assert st == 200
    return summary, tokens


def phase_batched(torch, kernels):
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    try:
        os.environ["DLI_FUSED_DECODE"] = "0"
        paged, toks_p = _batched_pass(torch, base, worker, kernels, "paged",
                                      cfg)
        os.environ["DLI_FUSED_DECODE"] = "1"
        fused, toks_f = _batched_pass(torch, base, worker, kernels, "fused",
                                      cfg)
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    greedy = [i for i in range(len(toks_p)) if i % 2 == 0]
    agree = sum(a == b for i in greedy
                for a, b in zip(toks_p[i], toks_f[i]))
    total = sum(len(toks_p[i]) for i in greedy)
    peak = max(paged["peak_memory_bytes"], fused["peak_memory_bytes"])
    log(f"  greedy tokens equal across the two decode routes: {agree} of "
        f"{total} (bf16 q rounds differently: reported, not asserted)")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged": paged, "fused": fused,
            "greedy_tokens_agree": [agree, total], "peak_memory_bytes": peak,
            "tokens_paged": toks_p}


# ---------------------------------------------------------------------
# phase 6: the two decode routes at full depth, bf16 against f32
# ---------------------------------------------------------------------

def _route_tables(torch, lens, steps, bs):
    """Block tables for one paged prefill of every prompt plus ``steps``
    decode positions: row r owns consecutive fresh blocks, the rest of
    its row is the dummy block 0."""
    need = [-(-(n + steps) // bs) for n in lens]
    mb = max(need)
    bt = torch.zeros(len(lens), mb, dtype=torch.int32)
    nxt = 1
    for r, n in enumerate(need):
        bt[r, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    return bt, nxt


def _route_run(torch, model, pool, bt, lens, first, route, kernels,
               forced=None, q4_per_step=0):
    """ROUTE_STEPS paged_decode_steps through ``route``'s kernel from the
    tokens ``first`` [R]: fed ``forced`` [steps, R] when given, else each
    step's own argmax. Checks the launches (``q4_per_step`` q4_matmul
    launches per step); returns (logits [steps, R, V], the tokens fed
    [steps, R])."""
    L = model.cfg.num_layers
    os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
    zero_counts(kernels)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cur, logits, fed = first, [], []
    try:
        with torch.inference_mode():
            for t in range(ROUTE_STEPS):
                cur = cur if forced is None else forced[t]
                lg, _ = model.paged_decode_step(cur, pool, bt, cl)
                logits.append(lg)
                fed.append(cur)
                cur, cl = lg.argmax(-1), cl + 1
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    launches = read_counts(kernels)
    mine = "fused_decode_step" if route == "fused" else "paged_flash_decode"
    want = {k: (L * ROUTE_STEPS if k == mine else 0) for k in launches}
    want["q4_matmul"] = q4_per_step * ROUTE_STEPS
    if model.cfg.dtype == "bfloat16":      # the tensor-core form
        want["q4_matmul[mma]"] = want["q4_matmul"]
    assert launches == want, f"{route}: launches {launches} != {want}"
    return torch.stack(logits), torch.stack(fed)


def _prefill_routes(torch, models, prompts, kernels):
    """Engine-mode (dense-cache) prefill of ``prompts`` through full-depth
    models: the f32 one, and the bf16 one with its attention through the
    tensor-core kernel ("kernel") and through ``flash_attention_ref`` on
    the card ("plain", swapped into the attention dispatch here and
    nowhere in the package). Returns each bf16 route's largest logit error
    against f32 per prompt, over the prompt's real rows."""
    from distributed_llm_inferencing_tpu_torch.ops import attention as ta
    from distributed_llm_inferencing_tpu_torch.ops import flash_attention as fa
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    lens = [len(p) for p in prompts]
    R, S0 = len(prompts), max(lens)
    L = models["f32"].cfg.num_layers
    tokens = torch.zeros(R, S0, dtype=torch.long, device="cuda")
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = torch.tensor(p)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    real = torch.arange(S0, device="cuda")[None, :] < lengths[:, None]

    def run(model, plain=False):
        cache = init_cache(model.cfg, R, S0, device="cuda")
        zero_counts(kernels)
        kernel = ta.flash_attention
        if plain:
            ta.flash_attention = fa.flash_attention_ref
        try:
            with torch.inference_mode():
                logits, _ = model.prefill(tokens, lengths, cache)
        finally:
            ta.flash_attention = kernel
        n = read_counts(kernels)
        return logits, (n["flash_attention"], n["flash_attention[mma]"])

    ref, n = run(models["f32"])
    assert n == (L, 0), f"f32 prefill launches {n} != ({L}, 0)"
    out = {}
    for route in ("kernel", "plain"):
        lg, n = run(models["bf16"], plain=route == "plain")
        want = (L, L) if route == "kernel" else (0, 0)
        assert n == want, f"{route} prefill launches {n} != {want}"
        assert torch.isfinite(lg[real]).all(), f"{route} prefill not finite"
        err = (lg - ref).abs().amax(-1)
        out[route] = torch.where(real, err, torch.zeros_like(err)) \
            .amax(-1).tolist()
        del lg, err
    del ref
    return out


def phase_route_depth(torch, kernels):
    """Phase 5's eight prompts through full-depth llama-3-8b with one set
    of random weights held in bf16 and, widened, in f32: one paged
    prefill, then ROUTE_STEPS paged decode steps through the paged kernel
    in f32 (greedy), and through each decode kernel in bf16 fed the same
    tokens. Per row and step it reports the f32 top-1/top-2 logit gap,
    each bf16 route's largest logit error against f32 and whether its
    argmax agrees. The bf16 prefill's error against f32 (no decode
    kernel in it) is the yardstick of bf16 rounding at this depth.
    Then the prefill route: the same prompts through engine-mode
    prefill, the bf16 attention through the tensor-core kernel and
    through its plain version, each against f32 over every real row; the
    kernel's worst error must stay within ROUTE_ERR_FACTOR x the plain
    route's."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
        PagedKVCache, init_paged_cache)
    cfg, bs = get_config("llama-3-8b"), 16
    prompts = [b["prompt_tokens"] for b in _batched_bodies(cfg)]
    lens = [len(p) for p in prompts]
    R = len(prompts)
    bt, nb = _route_tables(torch, lens, ROUTE_STEPS, bs)
    tokens = torch.zeros(R, bt.shape[1] * bs, dtype=torch.long)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = torch.tensor(p)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(21),
                         "cuda")
    models = {"bf16": Transformer(cfg, params),
              "f32": Transformer(cfg.replace(dtype="float32"),
                                 {k: t.float() for k, t in params.items()})}
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = bt.cuda()
    pools, prefill = {}, {}
    with torch.inference_mode():
        for name, model in models.items():
            pools[name] = init_paged_cache(model.cfg, nb, bs, device="cuda")
            prefill[name], _ = model.paged_prefill_tail(
                tokens.cuda(), torch.tensor(lens, **i32), bt,
                torch.zeros(R, 1, **i32), torch.zeros(R, **i32), pools[name])
    first = prefill["f32"].argmax(-1)
    ref, fed = _route_run(torch, models["f32"], pools["f32"], bt, lens,
                          first, "paged", kernels)
    runs = {}
    for route in ("paged", "fused"):
        pool = PagedKVCache(pools["bf16"].k.clone(), pools["bf16"].v.clone())
        runs[route], _ = _route_run(torch, models["bf16"], pool, bt, lens,
                                    first, route, kernels, forced=fed)
        del pool
    for t in (ref, *runs.values(), *prefill.values()):
        assert torch.isfinite(t).all(), "full-depth logits are not finite"
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                         # [steps, R]
    amax = ref.argmax(-1)
    out = {"prompt_tokens": lens, "steps": ROUTE_STEPS,
           "prefill_err_bf16": (prefill["bf16"] - prefill["f32"]).abs()
           .amax(-1).tolist(),
           "prefill_argmax_agree": int((prefill["bf16"].argmax(-1)
                                        == first).sum()),
           "logit_std_f32": float(ref.std(-1).mean()),
           "gap_f32": gap.tolist()}
    for route, lg in runs.items():
        out[f"err_{route}"] = (lg - ref).abs().amax(-1).tolist()
        out[f"argmax_agree_{route}"] = int((lg.argmax(-1) == amax).sum())
        # an argmax can flip only where the f32 gap is under twice the
        # route's largest error
        out[f"rows_gap_under_2x_err_{route}"] = int(
            (gap < 2 * (lg - ref).abs().amax(-1)).sum())
    out["argmax_agree_paged_fused"] = int(
        (runs["paged"].argmax(-1) == runs["fused"].argmax(-1)).sum())
    per_row = ("prefill_err_bf16", "gap_f32", "err_paged", "err_fused")
    for key in per_row:
        log(f"  {key}: {json.dumps(out[key])}")
    log("  route summary", json.dumps(
        {k: v for k, v in out.items() if k not in per_row}))
    # both routes stay within bf16 rounding at this depth, as the prefill
    # measures it: a kernel fault at depth would not
    bound = ROUTE_ERR_FACTOR * max(out["prefill_err_bf16"])
    worst = {r: max(map(max, out[f"err_{r}"])) for r in runs}
    assert all(e <= bound for e in worst.values()), \
        f"bf16 decode logits off f32 by {worst}, over {bound}"
    del pools, runs, ref
    gc.collect()
    dense = _prefill_routes(torch, models, prompts, kernels)
    for route, errs in dense.items():
        out[f"dense_prefill_err_{route}"] = errs
        log(f"  dense_prefill_err_{route}: {json.dumps(errs)}")
    worst_k, worst_p = max(dense["kernel"]), max(dense["plain"])
    log("  prefill route summary", json.dumps(
        {"worst_kernel": worst_k, "worst_plain": worst_p,
         "factor": worst_k / worst_p}))
    assert worst_k <= ROUTE_ERR_FACTOR * worst_p, \
        f"tensor-core prefill off f32 by {worst_k}, over " \
        f"{ROUTE_ERR_FACTOR} x the plain route's {worst_p}"
    del models, params, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phase 7: quantized serving through the port's worker
# ---------------------------------------------------------------------

def phase_quant_serving(torch, kernels):
    """llama-3-8b (bf16 activations) loaded with "quantize": "int4": phase
    3's three engine-mode requests, then phase 5's batched wave with the
    fused route off and on; then "quantize": "int8", batched, fused on
    (the int8 form of the fused kernel). Exact launch counts per pass."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    L = cfg.num_layers
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    out = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        st, res = _http(base + "/load_model", {
            "model_name": "llama-3-8b", "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096, **QUANT_LOAD})
        assert st == 200 and res["status"] == "success", res
        st, health = _http(base + "/health")
        [desc] = health["loaded_models"]
        assert desc["quantize"] == "int4", desc
        log(f"  load_model (engine, int4): {res['load_time_s']:.2f} s, "
            f"{desc['param_bytes'] / 1e9:.3f} GB of weights")
        launches, rows = _engine_requests(torch, base, kernels, cfg,
                                          "llama-3-8b", 7 * L + 1)
        peak = torch.cuda.max_memory_allocated()
        log(f"  peak device memory (engine, int4): {peak / 2**30:.3f} GiB")
        st, _ = _http(base + "/unload_model", {"model_name": "llama-3-8b"})
        assert st == 200
        out["engine_int4"] = {"param_bytes": desc["param_bytes"],
                              "peak_memory_bytes": peak,
                              "launches": launches, "requests": rows}
        for quant, route in (("int4", "paged"), ("int4", "fused"),
                             ("int8", "fused")):
            os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
            out[f"batched_{quant}_{route}"], _ = _batched_pass(
                torch, base, worker, kernels, route, cfg, quant=quant)
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phase 9: int4 at full depth, the kernel route against the plain unpack
# ---------------------------------------------------------------------

def phase_int4_depth(torch, kernels, qm):
    """Phase 5's eight prompts through full-depth llama-3-8b with int4
    weights (bf16 activations): one paged prefill, then ROUTE_STEPS paged
    decode steps through the q4_matmul route and through the plain-unpack
    route (the gate forced shut), both fed the tokens of an f32 forward
    over the same weights dequantized. Each route's largest logit error
    against that f32 forward; the kernel route's worst must stay within
    ROUTE_ERR_FACTOR x the unpack route's (the kernel adds no error beyond
    bf16 rounding)."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
        PagedKVCache, init_paged_cache)
    from distributed_llm_inferencing_tpu_torch.ops.quant import (
        dequantize_weight)
    cfg, bs = get_config("llama-3-8b").replace(quant="int4"), 16
    L = cfg.num_layers
    prompts = [b["prompt_tokens"] for b in _batched_bodies(cfg)]
    lens = [len(p) for p in prompts]
    R = len(prompts)
    bt, nb = _route_tables(torch, lens, ROUTE_STEPS, bs)
    tokens = torch.zeros(R, bt.shape[1] * bs, dtype=torch.long)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = torch.tensor(p)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(21),
                         "cuda")
    f32 = {}
    for k, t in params.items():
        if k.endswith(".p4"):
            prefix = k[:-len(".p4")]
            f32[prefix + ".w"] = dequantize_weight(
                {"p4": t, "scale": params[prefix + ".scale"]})
        elif not (k.endswith(".scale") and k[:-len(".scale")] + ".p4"
                  in params):
            f32[k] = t.float()
    models = {"int4": Transformer(cfg, params),
              "f32": Transformer(cfg.replace(quant=None, dtype="float32"),
                                 f32)}
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = bt.cuda()
    pools, prefill = {}, {}
    with torch.inference_mode():
        for name, model in models.items():
            pools[name] = init_paged_cache(model.cfg, nb, bs, device="cuda")
            prefill[name], _ = model.paged_prefill_tail(
                tokens.cuda(), torch.tensor(lens, **i32), bt,
                torch.zeros(R, 1, **i32), torch.zeros(R, **i32), pools[name])
    first = prefill["f32"].argmax(-1)
    ref, fed = _route_run(torch, models["f32"], pools["f32"], bt, lens,
                          first, "paged", kernels)
    runs = {}
    gate = qm.supported
    for route in ("kernel", "unpack"):
        pool = PagedKVCache(pools["int4"].k.clone(), pools["int4"].v.clone())
        if route == "unpack":   # every linear takes the plain unpack
            qm.supported = lambda *a, **kw: False
        try:
            runs[route], _ = _route_run(
                torch, models["int4"], pool, bt, lens, first, "paged",
                kernels, forced=fed,
                q4_per_step=7 * L + 1 if route == "kernel" else 0)
        finally:
            qm.supported = gate
        del pool
    for t in (ref, *runs.values(), *prefill.values()):
        assert torch.isfinite(t).all(), "int4 full-depth logits not finite"
    out = {"prompt_tokens": lens, "steps": ROUTE_STEPS,
           "prefill_err_int4": (prefill["int4"] - prefill["f32"]).abs()
           .amax(-1).tolist(),
           "logit_std_f32": float(ref.std(-1).mean())}
    for route, lg in runs.items():
        out[f"err_{route}"] = (lg - ref).abs().amax(-1).tolist()
        out[f"argmax_agree_{route}"] = int(
            (lg.argmax(-1) == ref.argmax(-1)).sum())
    worst = {r: max(map(max, out[f"err_{r}"])) for r in runs}
    out["worst"] = worst
    for key in ("prefill_err_int4", "err_kernel", "err_unpack"):
        log(f"  {key}: {json.dumps(out[key])}")
    log("  int4 depth summary", json.dumps(
        {k: v for k, v in out.items()
         if k not in ("prefill_err_int4", "err_kernel", "err_unpack")}))
    assert worst["kernel"] <= ROUTE_ERR_FACTOR * worst["unpack"], \
        f"int4 kernel route off f32 by {worst['kernel']}, over " \
        f"{ROUTE_ERR_FACTOR} x the unpack route's {worst['unpack']}"
    kept = {"ref": ref.cpu(), "fed": fed.cpu(), "prompts": prompts,
            "worst": worst}
    del models, params, f32, pools, prefill, runs, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out, kept


# ---------------------------------------------------------------------
# phase 10: tensor-parallel engine serving through the port's worker
# ---------------------------------------------------------------------

def _tp_want(L, passes, int4, prefill_q4=1, bf16=True):
    """Exact per-rank counts of one engine-mode request of ``passes``
    weight passes (a prefill of more than 32 rows, then decode steps of
    one row) under tp, the same at any tp: kernels (a bf16 prefill in
    its tensor-core form), then data collectives."""
    d = passes - 1
    launches = {"flash_attention": L, "flash_attention[mma]": L if bf16
                else 0, "flash_decode": L * d,
                "paged_flash_decode": 0, "fused_decode_step": 0,
                "q4_matmul": prefill_q4 + (5 * L + 1) * d if int4 else 0,
                "q4_matmul_row": 2 * L * d if int4 else 0}
    # bf16 activations: every q4 call in its tensor-core form
    for k in ("q4_matmul", "q4_matmul_row"):
        launches[f"{k}[mma]"] = launches[k] if bf16 else 0
    return launches, {"all_reduce": (2 * L + 1) * passes, "gather": passes,
                      "broadcast": passes}


def phase_tp_serving(torch, tp=2):
    """llama-3-8b at full width and TP_SERVING_LAYERS deep through the
    worker with "mesh": {"tp": tp}, engine mode, bf16 and then int4
    weights: phase 3's three requests each, with every rank's kernel
    launches and data collectives zeroed before each request and held to
    the exact counts after.
    Returns a summary per weight form and the launches summed over the
    ranks and requests."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config, register)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = register(get_config("llama-3-8b").replace(
        name=TP_SERVING_NAME, num_layers=TP_SERVING_LAYERS))
    L, name = cfg.num_layers, cfg.name
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    out, total = {}, {}
    try:
        for quant in (None, "int4"):
            torch.cuda.reset_peak_memory_stats()
            st, res = _http(base + "/load_model", {
                "model_name": name, "allow_random_init": True,
                "dtype": "bfloat16", "max_seq": 4096, "mesh": {"tp": tp},
                **({"quantize": quant} if quant else {})})
            assert st == 200 and res["status"] == "success", res
            st, health = _http(base + "/health")
            [desc] = health["loaded_models"]
            assert desc["mesh"]["tp"] == tp and desc["quantize"] == quant
            engine = worker.models[name].engine
            pids = engine._leader.alive()
            ranks = [s["device"] for s in engine.rank_stats()]
            log(f"  load_model (engine, tp={tp}, {quant or 'bf16'}): "
                f"{res['load_time_s']:.2f} s, {desc['param_bytes'] / 1e9:.3f}"
                f" GB of weights per rank, ranks on {ranks}, data "
                f"collectives over {desc['backend']}")
            rows = []
            for n_tok, sampling, seed in ((100, {"do_sample": False}, 0),
                                          (200, {}, 1), (500, {}, 2)):
                text = "".join(chr(97 + (i * 7 + seed) % 26)
                               for i in range(n_tok - 1))
                engine.reset_counts()
                st, r = _http(base + "/inference", {
                    "model_name": name, "prompt": text, "max_new_tokens": 32,
                    "sampling": sampling, "seed": seed})
                assert st == 200 and r["status"] == "success", r
                stats = engine.rank_stats()
                toks, passes = r["tokens"], r["cost"]["weight_passes"]
                assert all(0 <= t < cfg.vocab_size for t in toks), toks
                want_k, want_c = _tp_want(L, passes, quant == "int4")
                for s_ in stats:
                    assert s_["launches"] == want_k, \
                        f"rank {s_['rank']}: launches {s_['launches']} != " \
                        f"{want_k}"
                    assert s_["collectives"] == want_c, \
                        f"rank {s_['rank']}: {s_['collectives']} != {want_c}"
                    for k, v in s_["launches"].items():
                        total[k] = total.get(k, 0) + v
                row = {"prompt_tokens": n_tok,
                       "sampling": sampling or "default",
                       "new_tokens": len(toks), "weight_passes": passes,
                       "prefill_ms": r["prefill_ms"],
                       "decode_ms_per_weight_pass":
                           r["decode_ms"] / (passes - 1),
                       "launches_per_rank": {k: v for k, v in
                                             stats[0]["launches"].items()
                                             if v},
                       "collectives_per_rank": stats[0]["collectives"]}
                log("  request", json.dumps(row))
                rows.append(row)
            peak = torch.cuda.max_memory_allocated()
            del engine       # the next load's peak must not hold it
            st, _ = _http(base + "/unload_model", {"model_name": name})
            assert st == 200
            alive = [p for p in pids if os.path.exists(f"/proc/{p}")]
            assert not alive, f"tp followers {alive} outlived the unload"
            out[quant or "bf16"] = {
                "backend": desc["backend"], "rank_devices": ranks,
                "param_bytes_per_rank": desc["param_bytes"],
                "leader_peak_memory_bytes": peak, "requests": rows}
    finally:
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out, total


# ---------------------------------------------------------------------
# phase 11: tp=2 against tp=1 on the same weights
# ---------------------------------------------------------------------

def phase_tp_cross_check(torch, quant=None, tp=2):
    """Full width, 2 layers, f32, float or int4 weights from one seed: a
    teacher-forced prefill of two prompts (37 and 64 tokens) plus 8
    decode steps through the engine at tp=1 and at ``tp`` ranks (the
    kernels on every one); every real logit row within XCHECK_TOL, and
    every rank's counts exact."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    cfg = get_config("llama-3-8b").replace(num_layers=2, dtype="float32",
                                           quant=quant)
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    prompts = [toks[0, :37].tolist(), toks[1].tolist()]
    forced = torch.randint(0, cfg.vocab_size, (8, 2), generator=g).tolist()
    one = InferenceEngine(cfg, max_seq=96, seed=7, device="cuda")
    pre1, dec1 = one.teacher_forced(prompts, forced)
    del one
    gc.collect()
    two = InferenceEngine(cfg, mesh_spec=MeshSpec(tp=tp), max_seq=96,
                          seed=7, device="cuda")
    try:
        two.reset_counts()
        pre2, dec2 = two.teacher_forced(prompts, forced)
        stats = two.rank_stats()
    finally:
        two.close()
    # the prefill's 128 rows take the plain unpack, the head included;
    # each decode step of 2 rows the kernels
    want_k, want_c = _tp_want(2, 9, quant == "int4", prefill_q4=0,
                              bf16=False)
    want_c["broadcast"] = 0          # teacher-forced: nothing sampled
    for s_ in stats:
        assert s_["launches"] == want_k and s_["collectives"] == want_c, \
            (s_, want_k, want_c)
    a = torch.cat([pre2[0, :37], pre2[1], dec2.reshape(-1, dec2.shape[-1])])
    b = torch.cat([pre1[0, :37], pre1[1], dec1.reshape(-1, dec1.shape[-1])])
    err = _xcheck(torch, f"{quant or 'float'} tp={tp} vs tp=1", a, b)
    del two
    gc.collect()
    torch.cuda.empty_cache()
    return err


def phase_tp_depth(torch, depth):
    """Phase 9's prompts and teacher-forced tokens through int4
    llama-3-8b (bf16, the same seed's weights) at tp=2, full depth: its
    decode logits' worst error against phase 9's f32 forward must stay
    within ROUTE_ERR_FACTOR x the tp=1 q4 route's."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    cfg = get_config("llama-3-8b").replace(quant="int4")
    L = cfg.num_layers
    ref, fed, prompts = depth["ref"], depth["fed"], depth["prompts"]
    two = InferenceEngine(cfg, mesh_spec=MeshSpec(tp=2), max_seq=2048,
                          seed=21, device="cuda")
    try:
        two.reset_counts()
        _, dec = two.teacher_forced(prompts, fed.tolist(), last_only=True)
        stats = two.rank_stats()
    finally:
        two.close()
    want_k, want_c = _tp_want(L, ROUTE_STEPS + 1, True)
    want_c["broadcast"] = 0
    for s_ in stats:
        assert s_["launches"] == want_k and s_["collectives"] == want_c, \
            (s_, want_k, want_c)
    assert torch.isfinite(dec).all(), "tp=2 full-depth logits not finite"
    err = (dec - ref).abs().amax(-1)                     # [steps, R]
    out = {"err_tp2": err.tolist(), "worst_tp2": float(err.max()),
           "worst_tp1_kernel": depth["worst"]["kernel"],
           "argmax_agree_tp2": int((dec.argmax(-1) == ref.argmax(-1)).sum())}
    log(f"  err_tp2: {json.dumps(out['err_tp2'])}")
    log("  tp depth summary", json.dumps(
        {k: v for k, v in out.items() if k != "err_tp2"}))
    assert out["worst_tp2"] <= ROUTE_ERR_FACTOR * out["worst_tp1_kernel"], \
        f"tp=2 int4 off f32 by {out['worst_tp2']}, over " \
        f"{ROUTE_ERR_FACTOR} x the tp=1 kernel route's " \
        f"{out['worst_tp1_kernel']}"
    del two
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phase 12: the worker's control surface over real HTTP
# ---------------------------------------------------------------------

def _call(url, body=None, key=None, headers=None, timeout=900):
    """One HTTP call: (status, response headers, body bytes)."""
    h = {"Content-Type": "application/json", **(headers or {})}
    if key:
        h["Authorization"] = f"Bearer {key}"
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST", headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _stream_lines(url, body, key, timeout=900):
    """POST ``body`` and return [(seconds since the call, line)], each
    line timed as it arrives (SSE events, JSON lines)."""
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST", headers=headers)
    t0 = time.perf_counter()
    out = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.status == 200, r.status
        for line in r:
            line = line.strip()
            if line:
                out.append((time.perf_counter() - t0, line))
    return out


def parse_exposition(text):
    """Prometheus text, checked line by line: every sample's family has a
    # TYPE, and each histogram's cumulative buckets are in order, never
    decrease, and end at +Inf equal to its _count. Returns the unlabeled
    samples by name."""
    import math
    import re
    sample = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{le="([^"]+)"\})? (\S+)$')
    types, flat, buckets = {}, {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# "):
            kind, name = line.split()[1:3]
            assert kind in ("HELP", "TYPE"), line
            if kind == "TYPE":
                types[name] = line.split()[3]
            continue
        m = sample.match(line)
        assert m, f"not an exposition sample: {line!r}"
        name, le, value = m.group(1), m.group(2), float(m.group(3))
        family = name if name in types else re.sub(
            r"_(bucket|sum|count)$", "", name)
        assert family in types, f"{name} has no # TYPE"
        if le is None:
            flat[name] = value
        else:
            buckets.setdefault(family, []).append(
                (math.inf if le == "+Inf" else float(le), value))
    for family, kind in types.items():
        if kind != "histogram":
            continue
        b = buckets[family]
        les, counts = [x for x, _ in b], [c for _, c in b]
        assert les == sorted(les) and les[-1] == math.inf, family
        assert counts == sorted(counts), f"{family}: buckets decrease"
        assert counts[-1] == flat[family + "_count"], family
    return flat, types


def _wait_for(pred, what, timeout=300.0, every=0.05):
    """Poll ``pred`` until it is truthy, every 0.05 s by default: the
    batcher's scheduler is host-bound, and a tighter loop of /health
    calls would take its GIL time and slow what it measures."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"phase 12: timed out waiting for {what}")


def _streaming(worker, tag):
    """The worker's in-flight request tagged ``tag`` once it has emitted
    tokens, else None."""
    req = worker._tagged.get(tag)
    return req if req is not None and req.tokens else None


def phase_control_surface(torch, kernels, batched, smi):
    """The port's worker on a localhost socket with an auth key, driven
    over HTTP through every route of its control surface at llama-3-8b
    bf16 (max_seq 4096): auth, request_tag replay, /inference_stream,
    lease fencing (engine mode); /inference_batch through each decode
    kernel, /cancel and /drain (batched mode); /metrics. Launch counts
    are zeroed before and read after each request or batch."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    L, name = cfg.num_layers, "llama-3-8b"
    worker = WorkerAgent(device="cuda", auth_key=CONTROL_KEY)
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"

    def call(path, body=None, **kw):
        st, hdrs, raw = _call(base + path, body, key=CONTROL_KEY, **kw)
        return st, hdrs, json.loads(raw)

    def counted(fn):
        zero_counts(kernels)
        out = fn()
        return out, read_counts(kernels)

    def metrics():
        st, hdrs, raw = _call(base + "/metrics", key=CONTROL_KEY)
        assert st == 200 and hdrs["Content-Type"] == \
            "text/plain; version=0.0.4", (st, hdrs)
        return parse_exposition(raw.decode())

    def scheduler():
        st, _, h = call("/health")
        [m] = [m for m in h["loaded_models"] if m["name"] == name]
        return m["scheduler"]

    report = {"smi": smi}
    try:
        for path in ("/health", "/metrics"):
            st, _, _ = _call(base + path)
            assert st == 401, f"{path} without the token: {st}"
        st, _, _ = _call(base + "/inference", {"model_name": name})
        assert st == 401, st
        flat0, _ = metrics()
        completed = 0

        # ---- engine mode --------------------------------------------
        st, _, res = call("/load_model", {
            "model_name": name, "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096})
        assert st == 200 and res["status"] == "success", res
        text = "".join(chr(97 + (i * 7 + 2) % 26) for i in range(499))
        body = {"model_name": name, "prompt": text, "max_new_tokens": 32,
                "sampling": {"do_sample": False}, "seed": 2}
        (st, _, first), d = counted(lambda: call(
            "/inference", dict(body, request_tag="p12-engine")))
        assert st == 200 and first["status"] == "success", first
        completed += 1
        passes = first["cost"]["weight_passes"]
        want = dict.fromkeys(d, 0)
        want.update({"flash_attention": L, "flash_attention[mma]": L,
                     "flash_decode": L * (passes - 1)})
        assert d == want, f"/inference launches {d} != {want}"
        t0 = time.perf_counter()
        (st, _, again), d = counted(lambda: call(
            "/inference", dict(body, request_tag="p12-engine")))
        replay_ms = 1e3 * (time.perf_counter() - t0)
        assert st == 200 and again["idempotent"] is True, again
        assert again["tokens"] == first["tokens"]
        assert not any(d.values()), f"a replay launched kernels: {d}"
        lines, d = counted(lambda: _stream_lines(
            base + "/inference_stream", body, CONTROL_KEY))
        events = [(t, json.loads(line[len(b"data: "):]))
                  for t, line in lines]
        assert events[-1][1]["event"] == "done", events[-1]
        toks = [e["token"] for _, e in events[:-1]]
        assert all(e["event"] == "token" for _, e in events[:-1])
        assert toks == first["tokens"], (toks, first["tokens"])
        assert d == want, f"/inference_stream launches {d} != {want}"
        completed += 1
        report["engine"] = {
            "prompt_tokens": 500, "new_tokens": len(toks),
            "weight_passes": passes, "launches": {k: v for k, v in
                                                  want.items() if v},
            "inference_prefill_ms": first["prefill_ms"],
            "inference_execution_s": first["execution_time"],
            "replay_client_ms": replay_ms,
            "sse_first_token_ms": 1e3 * events[0][0],
            "sse_done_ms": 1e3 * events[-1][0],
            "sse_tokens_per_s": events[-1][1]["tokens_per_s"]}
        log(f"  engine [{smi}]", json.dumps(report["engine"]))
        # lease fencing: term 7 holds, term 6 is stale
        fence = lambda t: {"X-DLI-Master-Term": str(t),  # noqa: E731
                           "X-DLI-Master-Nonce": "smoke-master"}
        st, _, _ = call("/cancel", {"request_tag": "none"},
                        headers=fence(7))
        assert st == 404, st
        (st, hdrs, res), d = counted(lambda: call(
            "/inference", dict(body, request_tag="p12-stale"),
            headers=fence(6)))
        assert st == 409 and res["stale_term"] is True, res
        assert hdrs["X-DLI-Stale-Term"] == "7", dict(hdrs)
        assert not any(d.values()), d
        st, _, _ = call("/unload_model", {"model_name": name})
        assert st == 200

        # ---- batched mode, each decode kernel -------------------------
        report["batched"] = {}
        for route in ("paged", "fused"):
            os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
            st, _, res = call("/load_model", dict(BATCHED_LOAD))
            assert st == 200 and res["status"] == "success", res
            bodies = [dict(b, request_tag=f"p12-{route}-{i}")
                      for i, b in enumerate(_batched_bodies(cfg))]
            s0 = worker.metrics.snapshot()["counters"]
            t0 = time.perf_counter()
            lines, d = counted(lambda: _stream_lines(
                base + "/inference_batch",
                {"model_name": name, "requests": bodies}, CONTROL_KEY))
            wall = time.perf_counter() - t0
            s1 = worker.metrics.snapshot()["counters"]
            passes, emitted = (s1[k] - s0.get(k, 0) for k in (
                "batcher_weight_passes", "batcher_tokens_emitted"))
            msgs = [json.loads(line) for _, line in lines]
            assert sorted(m["request_tag"] for m in msgs) == \
                sorted(b["request_tag"] for b in bodies), msgs
            assert all(m["status"] == 200 for m in msgs), msgs
            completed += len(msgs)
            mine = "paged_flash_decode" if route == "paged" \
                else "fused_decode_step"
            want = dict.fromkeys(d, 0)
            want[mine] = L * passes
            assert d == want, f"/inference_batch launches {d} != {want}"
            generated = sum(len(m["body"]["tokens"]) for m in msgs)
            p5 = batched[route]
            row = {"wall_s": wall, "generated_tokens": generated,
                   "tokens_per_s": generated / wall,
                   "weight_passes": passes,
                   "decode_tokens_per_weight_pass": emitted / passes,
                   "launches": {mine: d[mine]},
                   "phase5_concurrent_inference": {
                       k: p5[k] for k in ("wall_s", "tokens_per_s",
                                          "weight_passes",
                                          "decode_tokens_per_weight_pass")}}
            # one greedy sub-request alone = /inference of the same body
            greedy = dict(bodies[0], request_tag=f"p12-{route}-single")
            one = [json.loads(line) for _, line in _stream_lines(
                base + "/inference_batch",
                {"model_name": name, "requests": [greedy]}, CONTROL_KEY)]
            plain = dict(bodies[0])
            del plain["request_tag"]
            st, _, alone = call("/inference", plain)
            assert st == 200 and len(one) == 1 and one[0]["status"] == 200
            assert one[0]["body"]["tokens"] == alone["tokens"], \
                (one[0]["body"]["tokens"], alone["tokens"])
            completed += 2
            if route == "paged":
                row["cancel"] = _cancel_check(worker, call, scheduler,
                                              bodies)
                row["drain"], n = _drain_check(worker, call, bodies)
                completed += n
            report["batched"][route] = row
            log(f"  batched ({route}) [{smi}]", json.dumps(row))
            st, _, _ = call("/unload_model", {"model_name": name})
            assert st == 200

        # ---- /metrics -------------------------------------------------
        flat1, types = metrics()
        done = (flat1["dli_requests_completed_total"]
                - flat0["dli_requests_completed_total"])
        assert done == completed, \
            f"dli_requests_completed_total moved {done}, not {completed}"
        for k in ("batch_rpcs", "idempotent_hits", "requests_cancelled",
                  "stale_term_rejections"):
            assert flat1[f"dli_{k}_total"] >= 1, k
        assert flat1["dli_draining"] == 0
        report["metrics"] = {"families": len(types),
                             "requests_completed": done}
        log("  metrics", json.dumps(report["metrics"]))
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _cancel_check(worker, call, scheduler, bodies):
    """A tagged request of 2000 new tokens on a thread, cancelled once it
    has tokens: its /inference answers an error and the pool's free
    blocks come back (its prompt's whole blocks were cached by the batch
    before, so they stay cached either way)."""
    free0 = scheduler()["blocks_free"]
    body = dict(bodies[3], max_new_tokens=2000, request_tag="p12-cancel",
                sampling={"do_sample": False})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(call, "/inference", body)
        req = _wait_for(lambda: _streaming(worker, "p12-cancel"),
                        "the request to stream tokens")
        t0 = time.perf_counter()
        st, _, res = call("/cancel", {"request_tag": "p12-cancel"})
        assert st == 200, res
        _wait_for(lambda: scheduler()["blocks_free"] == free0,
                  "the cancelled request's blocks", every=0.05)
        freed_ms = 1e3 * (time.perf_counter() - t0)
        st, _, res = fut.result(timeout=600)
    assert st == 400 and "cancel" in res["message"], (st, res)
    assert len(req.tokens) < 2000, len(req.tokens)
    return {"cancel_to_blocks_free_ms": freed_ms,
            "tokens_before_cancel": len(req.tokens), "blocks_free": free0}


def _drain_check(worker, call, bodies):
    """/drain with one batched request in flight: a new request gets 503
    with Retry-After, /health says draining, the request in flight ends
    200 and /drain answers drained; after /undrain a request gets 200.
    Returns (the check's numbers, requests completed)."""
    body = dict(bodies[0], max_new_tokens=64, request_tag="p12-drain")
    short = dict(bodies[2], max_new_tokens=4)
    del short["request_tag"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut = pool.submit(call, "/inference", body)
        _wait_for(lambda: _streaming(worker, "p12-drain"),
                  "the request in flight")
        t0 = time.perf_counter()
        drain = pool.submit(call, "/drain", {"timeout": 600})
        _wait_for(lambda: call("/health")[2]["status"] == "draining",
                  "/health to say draining", every=0.05)
        st, hdrs, res = call("/inference", short)
        assert st == 503 and res["draining"] is True, (st, res)
        assert hdrs["Retry-After"] == "5", dict(hdrs)
        st, _, res = fut.result(timeout=600)
        assert st == 200 and len(res["tokens"]) >= 1, res
        st, _, res = drain.result(timeout=600)
        drain_ms = 1e3 * (time.perf_counter() - t0)
    assert st == 200 and res["drained"] is True, res
    st, _, _ = call("/undrain", {})
    assert st == 200
    st, _, res = call("/inference", short)
    assert st == 200, res
    return {"drain_ms": drain_ms}, 2


# ---------------------------------------------------------------------
# phase 13: the decode programs, captured (CUDA graphs) and eager
# ---------------------------------------------------------------------

def _graphs_on(on: bool):
    os.environ["DLI_CUDA_GRAPHS"] = "1" if on else "0"


def _allocated(torch) -> int:
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _baseline(torch) -> int:
    """The device memory allocated before a load, with no model loaded:
    cuBLAS's cached workspaces dropped first, so that an unload cannot
    pass its check by dropping workspaces made before its load."""
    from distributed_llm_inferencing_tpu_torch.runtime import graphs
    gc.collect()
    assert graphs.drop_idle_cublas_workspaces(), \
        "an owner of decode programs is still alive"
    return _allocated(torch)


# per counted kernel (runtime/lockstep.py names), the device kernels that
# count one launch of it in a profile (the q4 kernels are those of both
# q4 wrappers; profile_engine/profile_batched match the same names)
REPLAY_KERNELS = (
    ("flash_attention", ("flash_attention",),
     ("prefill_kernel<", "prefill_mma_kernel<")),
    ("flash_decode", ("flash_decode",), ("decode_split_kernel<",)),
    ("paged_flash_decode", ("paged_flash_decode",), ("paged_split_kernel",)),
    ("fused_decode_step", ("fused_decode_step",), ("fused_cluster_kernel",)),
    ("q4", ("q4_matmul", "q4_matmul_row"),
     ("q4_mma_kernel<", "q4_matmul_kernel<")),
    ("q4[mma]", ("q4_matmul[mma]", "q4_matmul_row[mma]"),
     ("q4_mma_kernel<",)),
)


def _replay_profiled(torch, kernels, prog, decode):
    """One replay of the captured ``prog``, profiled on the device (CUPTI
    reports each kernel a graph runs; bracketed_trace makes sure the trace
    holds them all): per REPLAY_KERNELS entry, the launches the replay
    counted and the kernels the device ran; they must be equal, the
    counted ones must be the capture's record, and the step's ``decode``
    kernel must have run."""
    from torch.profiler import ProfilerActivity

    from distributed_llm_inferencing_tpu_torch.ops.trace import (
        bracketed_trace)
    assert prog.captured

    def replay():
        zero_counts(kernels)
        prog()
        return read_counts(kernels)

    prof, counted, traces = bracketed_trace(replay, [ProfilerActivity.CUDA])
    names = [name for _, name in sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if str(e.device_type).endswith("CUDA"))]
    record = {}
    for (fn, attr), n in prog.record.items():
        name = fn.__name__ + ("[mma]" if attr == "launches_mma" else "")
        record[name] = record.get(name, 0) + n
    assert {k: v for k, v in counted.items() if v} == record, \
        (counted, record)
    out = {}
    for label, book, device in REPLAY_KERNELS:
        out[label] = {"counted": sum(counted[k] for k in book),
                      "ran": sum(any(d in n for d in device) for n in names)}
        assert out[label]["counted"] == out[label]["ran"], \
            (label, out[label], [n[:48] for n in names[:8]])
    # ``decode`` None: the ALiBi gather route, no kernel of the port
    assert decode is None or out[decode]["ran"] > 0, out
    out["traces"] = traces
    return out


def _programs(worker, name):
    """The loaded model's decode programs: (capture seconds of each
    captured one, /health's decode program stats)."""
    lm = worker.models[name]
    progs = (lm.engine or lm.batcher).programs
    _, health = _http(_worker_base(worker) + "/health")
    [desc] = [m for m in health["loaded_models"] if m["name"] == name]
    stats = desc if lm.engine else desc["scheduler"]
    return ([p.capture_s for p in progs.programs() if p.capture_s is not None],
            {k: stats[k] for k in ("decode_programs", "decode_graphs_captured",
                                   "decode_graph_pool_bytes")})


def _worker_base(worker) -> str:
    return f"http://127.0.0.1:{worker.service.port}"


def _unload(torch, worker, name, before):
    """Unload ``name``; the device memory allocated must be back at (or
    under) ``before``, its value before the load (``_baseline``): the
    weights, the kept decode state, the graphs and cuBLAS's workspaces
    all freed, and no segment of the graphs' pool left."""
    lm = worker.models[name]
    pool = (lm.engine or lm.batcher).programs.pool
    del lm
    st, _ = _http(_worker_base(worker) + "/unload_model", {"model_name": name})
    assert st == 200
    after = _allocated(torch)
    assert after <= before, \
        f"unload left {after - before} bytes allocated ({before} -> {after})"
    torch.cuda.empty_cache()
    left = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if pool is not None and tuple(seg["segment_pool_id"]) == pool]
    assert not left, f"the graphs' pool {pool} kept segments {left}"
    return after


def _graphs_engine(torch, worker, kernels, cfg, quant, load=None,
                   requests=ENGINE_REQUESTS, check=None):
    """Phase 3's three requests (or ``requests``) through one engine-mode
    load of ``cfg``'s model (bf16 activations, ``quant`` weights; ``load``:
    another load body, and ``check(loaded model)`` run after it), graphs
    on and then off: each with _engine_requests' exact counts, and the
    same tokens and launches on both sides."""
    name, L = cfg.name, cfg.num_layers
    before = _baseline(torch)
    st, res = _http(_worker_base(worker) + "/load_model", load or {
        "model_name": name, "allow_random_init": True, "dtype": "bfloat16",
        "max_seq": 4096, **({"quantize": quant} if quant else {})})
    assert st == 200 and res["status"] == "success", res
    checked = check(worker.models[name]) if check is not None else None
    runs = {}
    for on in (True, False):
        _graphs_on(on)
        runs[on] = _engine_requests(torch, _worker_base(worker), kernels, cfg,
                                    name, q4_per_pass(cfg) if quant else 0,
                                    requests)[1]
    capture_s, stats = _programs(worker, name)
    for a, b in zip(runs[True], runs[False]):
        assert a["tokens"] == b["tokens"], \
            f"graphs on/off tokens differ: {a['tokens']} != {b['tokens']}"
        assert a["launches"] == b["launches"], (a["launches"], b["launches"])
    # each captured program's replay, profiled on the device
    replays = [_replay_profiled(torch, kernels, p, "flash_decode")
               for p in worker.models[name].engine.programs.programs()
               if p.captured]
    assert replays, "no captured program"
    after = _unload(torch, worker, name, before)
    step_ms = {("on" if on else "off"): [r["decode_ms_per_weight_pass"]
                                         for r in runs[on]]
               for on in (True, False)}
    return {"weights": quant or "bf16", "check": checked,
            "load_s": res["load_time_s"],
            "tokens": [r["tokens"] for r in runs[True]],
            "ms_per_decode_step": step_ms,
            "prefill_ms": {("on" if on else "off"): [r["prefill_ms"]
                                                     for r in runs[on]]
                           for on in (True, False)},
            "capture_s": capture_s, **stats,
            "launches_per_request": [r["launches"] for r in runs[True]],
            "replay_profiled": replays,
            "tokens_equal": len(runs[True]),
            "memory_allocated_before_load": before,
            "memory_allocated_after_unload": after}


def _graphs_wave(torch, worker, kernels, cfg, route, quant, on,
                 lens=PROMPT_LENS, load=None, check=None):
    """Phase 5's 8 bodies (prompts of ``lens``) as one /inference_batch
    (one enqueue, so the admission waves do not depend on arrival times)
    through a fresh batched load of ``cfg``'s model, whose radix cache
    starts empty in both modes. The decode kernel of ``route``
    (``decode_kernel``) launches num_layers times per weight pass and no
    other attention kernel (none at all on the ALiBi gather route); in
    int4 q4_matmul as phase 5 counts it. ``load``: another load body;
    ``check(loaded model)`` runs after the batch, before the unload."""
    name, L = cfg.name, cfg.num_layers
    _graphs_on(on)
    os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
    before = _baseline(torch)
    st, res = _http(_worker_base(worker) + "/load_model", load or dict(
        BATCHED_LOAD, model_name=name, quantize=quant))
    assert st == 200 and res["status"] == "success", res
    capture_s, stats = _programs(worker, name)
    assert stats["decode_graphs_captured"] == int(on), stats  # at the load
    bodies = [dict(b, request_tag=f"p13-{name}-{quant}-{route}-{on}-{i}")
              for i, b in enumerate(_batched_bodies(cfg, lens))]
    s0 = worker.metrics.snapshot()
    zero_counts(kernels)
    t0 = time.perf_counter()
    lines = _stream_lines(_worker_base(worker) + "/inference_batch",
                          {"model_name": name, "requests": bodies}, None)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    s1 = worker.metrics.snapshot()
    passes, emitted = (s1["counters"][k] - s0["counters"].get(k, 0)
                       for k in ("batcher_weight_passes",
                                 "batcher_tokens_emitted"))
    chunk_s = (s1["timings"]["batcher_decode_chunk"]["sum"]
               - s0["timings"].get("batcher_decode_chunk", {}).get("sum", 0))
    msgs = {m["request_tag"]: m for m in map(json.loads,
                                             (x for _, x in lines))}
    assert all(m["status"] == 200 for m in msgs.values()), msgs
    tokens = [msgs[b["request_tag"]]["body"]["tokens"] for b in bodies]
    mine = decode_kernel(cfg, route)
    for k in ("paged_flash_decode", "fused_decode_step", "flash_decode",
              "flash_attention"):
        assert launches[k] == (L * passes if k == mine else 0), \
            (k, launches, passes)
    if quant == "int4":
        assert launches["q4_matmul[mma]"] == launches["q4_matmul"] > 0
    replay = None
    if on:   # one replay of the captured step, profiled, every slot idle
        b = worker.models[name].batcher
        [prog] = [p for p in b.programs.programs() if p.captured]
        with torch.inference_mode():
            b._bufs.load(b._chunk_inputs(1))
        replay = _replay_profiled(torch, kernels, prog, mine)
        del b, prog
    checked = check(worker.models[name]) if check is not None else None
    after = _unload(torch, worker, name, before)
    generated = sum(len(t) for t in tokens)
    return {"tokens": tokens, "launches": launches, "weight_passes": passes,
            "wall_s": wall, "tokens_per_s": generated / wall,
            "decode_tokens_per_weight_pass": emitted / passes,
            "decode_chunk_ms_per_weight_pass": 1e3 * chunk_s / passes,
            "capture_s": capture_s, **stats, "replay_profiled": replay,
            "check": checked, "memory_allocated_before_load": before,
            "memory_allocated_after_unload": after}


def phase_graphs(torch, kernels, smi):
    """Phase 13: the decode programs at full width and depth (llama-3-8b,
    bf16 activations, max_seq 4096), captured as CUDA graphs (the
    default) and run eagerly (DLI_CUDA_GRAPHS=0), through the worker:
    phase 3's engine requests in bf16 and int4 (one load each, graphs on
    then off), and phase 5's wave as one /inference_batch per route
    (paged, fused) in bf16 and int4, on a fresh load per mode. Both modes
    must give the same tokens, greedy and sampled, and the same launch
    counts (per request; per weight pass, and the same passes); one
    replay of each captured program, profiled on the device, must run
    exactly the kernels its launch counts add; every unload must give
    back the device memory its load took."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config, register)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = register(get_config("llama-3-8b").replace(
        name=f"llama-3-8b-{GRAPHS_LAYERS}-layers", num_layers=GRAPHS_LAYERS))
    log(f"  llama-3-8b: DEPTH CUT to {GRAPHS_LAYERS} of 32 layers")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    report = {"smi": smi, "engine": {}, "batched": {}}
    try:
        for quant in (None, "int4"):
            row = _graphs_engine(torch, worker, kernels, cfg, quant)
            report["engine"][row["weights"]] = row
            log(f"  engine {row['weights']} [{smi}]", json.dumps(
                {k: v for k, v in row.items()
                 if k != "launches_per_request"}))
        for quant in (None, "int4"):
            for route in ("paged", "fused"):
                runs = {on: _graphs_wave(torch, worker, kernels, cfg, route,
                                         quant, on) for on in (True, False)}
                on, off = runs[True], runs[False]
                assert on["tokens"] == off["tokens"], \
                    f"{quant} {route}: graphs on/off tokens differ"
                assert on["weight_passes"] == off["weight_passes"] \
                    and on["launches"] == off["launches"], \
                    (on["launches"], off["launches"])
                key = f"{quant or 'bf16'}_{route}"
                report["batched"][key] = {
                    mode: {k: v for k, v in r.items() if k != "tokens"}
                    for mode, r in (("on", on), ("off", off))}
                log(f"  batched {key} [{smi}]",
                    json.dumps(report["batched"][key]))
    finally:
        os.environ.pop("DLI_CUDA_GRAPHS", None)
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------
# phase 14: the dense families
# ---------------------------------------------------------------------

def _family_depth(torch, kernels, name, lens):
    """Phase 6's prefill check at ``name``'s full depth: prompts of
    ``lens`` tokens through engine-mode prefill in bf16, the attention
    through the tensor-core kernel and through its plain version, each
    against the same weights in f32; the kernel's worst logit error must
    stay within ROUTE_ERR_FACTOR x the plain route's."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    cfg = get_config(name)
    prompts = [b["prompt_tokens"] for b in _batched_bodies(cfg, lens)]
    prompts = prompts[:len(lens)]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(23),
                         "cuda")
    models = {"bf16": Transformer(cfg, params),
              "f32": Transformer(cfg.replace(dtype="float32"),
                                 {k: t.float() for k, t in params.items()})}
    dense = _prefill_routes(torch, models, prompts, kernels)
    del models, params
    gc.collect()
    torch.cuda.empty_cache()
    worst_k, worst_p = max(dense["kernel"]), max(dense["plain"])
    out = {"prompt_tokens": list(lens), "dense_prefill_err_kernel":
           dense["kernel"], "dense_prefill_err_plain": dense["plain"],
           "worst_kernel": worst_k, "worst_plain": worst_p,
           "factor": worst_k / worst_p}
    log(f"  {name} full-depth prefill, bf16 vs f32", json.dumps(out))
    assert worst_k <= ROUTE_ERR_FACTOR * worst_p, \
        f"{name}: tensor-core prefill off f32 by {worst_k}, over " \
        f"{ROUTE_ERR_FACTOR} x the plain route's {worst_p}"
    return out


def phase_families(torch, fa, qm, kernels, smi):
    """Phase 14: the dense families. (a) FAMILY_XCHECK's cross-checks at
    full width, 2 layers, f32; (b) FAMILY_SERVING's rows at full width
    and depth through the worker, bf16: phase 3's three requests in
    engine mode and one /inference_batch per decode route in batched
    mode, each with graphs on and off (equal tokens and exact counts:
    FAMILY_SERVING says which kernel a batched step launches), then
    bloom-7b1's prefill through the tensor-core kernel against f32;
    (c) ms per engine decode step and per batched weight pass, reported
    with no limit."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config, register)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    report = {"smi": smi, "cross_check": {}, "serving": {}}
    for name, routes, forms in FAMILY_XCHECK:
        on_card = name in FAMILY_CARD_REFERENCE
        if on_card:
            log(f"  {name}: reference: the plain versions on the card")
        for quant in forms:
            t0 = time.perf_counter()
            errs = phase_cross_check(torch, fa, qm, quant, name, routes,
                                     ref_on_card=on_card)
            errs["seconds"] = time.perf_counter() - t0
            report["cross_check"][f"{name}/{quant or 'float'}"] = errs
    launches = {k: 0 for k in kernels}
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    try:
        for name, routes in FAMILY_SERVING:
            depth = FAMILY_SERVING_LAYERS[name]
            log(f"  {name}: DEPTH CUT to {depth} of "
                f"{get_config(name).num_layers} layers")
            cfg = register(get_config(name).replace(
                name=f"{name}-{depth}-layers", num_layers=depth))
            row = _graphs_engine(torch, worker, kernels, cfg, None)
            for n in row["launches_per_request"]:
                for k, v in n.items():
                    launches[k] += 2 * v          # graphs on and off
            waves = {}
            for route in routes:
                runs = {on: _graphs_wave(torch, worker, kernels, cfg, route,
                                         None, on, FAMILY_PROMPT_LENS)
                        for on in (True, False)}
                on, off = runs[True], runs[False]
                assert on["tokens"] == off["tokens"], \
                    f"{name} {route}: graphs on/off tokens differ"
                assert on["weight_passes"] == off["weight_passes"] \
                    and on["launches"] == off["launches"], \
                    (on["launches"], off["launches"])
                for r in (on, off):
                    for k, v in r["launches"].items():
                        launches[k] += v
                waves[route] = {
                    "decode_kernel": decode_kernel(cfg, route),
                    **{mode: {k: v for k, v in r.items() if k != "tokens"}
                       for mode, r in (("on", on), ("off", off))}}
            report["serving"][name] = {"engine": row, "batched": waves}
            timing = {"engine_ms_per_decode_step": row["ms_per_decode_step"],
                      "batched_ms_per_weight_pass": {
                          route: {mode: w[mode][
                              "decode_chunk_ms_per_weight_pass"]
                              for mode in ("on", "off")}
                          for route, w in waves.items()}}
            log(f"  {name} bf16 through the worker [{smi}]",
                json.dumps(timing))
    finally:
        os.environ.pop("DLI_CUDA_GRAPHS", None)
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    report["depth"] = _family_depth(torch, kernels, "bloom-7b1",
                                    FAMILY_DEPTH_LENS)
    report["launches"] = launches
    return report


# ---------------------------------------------------------------------
# phase 15: model ingestion, checkpoint directories through the worker
# ---------------------------------------------------------------------

# meta-llama/Llama-3.1-8B's config.json (its published fields)
LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 131072,
    "mlp_bias": False, "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256}
# openai-community/gpt2-xl's config.json (the hub's files hold f32; these
# are bf16, 3.1 GB)
GPT2_XL = {
    "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
    "activation_function": "gelu_new", "attn_pdrop": 0.1,
    "bos_token_id": 50256, "embd_pdrop": 0.1, "eos_token_id": 50256,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "n_ctx": 1024,
    "n_embd": 1600, "n_head": 25, "n_layer": 48, "n_positions": 1024,
    "output_past": True, "resid_pdrop": 0.1, "vocab_size": 50257}
# bigscience/bloom-7b1's config.json, 30 layers cut to BLOOM_LAYERS
BLOOM_LAYERS = 4
BLOOM_7B1 = {
    "architectures": ["BloomForCausalLM"], "model_type": "bloom",
    "apply_residual_connection_post_layernorm": False,
    "attention_dropout": 0.0, "bos_token_id": 1, "eos_token_id": 2,
    "hidden_dropout": 0.0, "hidden_size": 4096, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "n_head": 32, "n_layer": BLOOM_LAYERS,
    "pad_token_id": 3, "pretraining_tp": 1, "slow_but_exact": False,
    "use_cache": True, "vocab_size": 250880}
LLAMA31_SHARDS = 4
INGEST_SEED = 31
# what a checkpoint load must fit in beside the weights: a leaf's copy in
# its file dtype and its transposed twin, or its f32 arithmetic copy
LOAD_PEAK_LEAVES_F32 = 2


def _hf_tensors(conf):
    """(HF key, shape, kind) of every tensor a checkpoint of ``conf``
    holds, in file order; kind "w" (normal, std 0.02), "norm" (1 + that),
    "b" (normal, std 0.02) or "buf" (a buffer the converter never
    reads). gpt2 and bloom in the hub's layout: no "transformer." prefix,
    no head (tied), gpt2's Conv1D weights [in, out]."""
    out = []
    if conf["model_type"] == "llama":
        D, I, V = (conf["hidden_size"], conf["intermediate_size"],
                   conf["vocab_size"])
        H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
        hd = D // H
        out.append(("model.embed_tokens.weight", (V, D), "w"))
        for i in range(conf["num_hidden_layers"]):
            p = f"model.layers.{i}."
            out += [(p + "input_layernorm.weight", (D,), "norm"),
                    (p + "self_attn.q_proj.weight", (H * hd, D), "w"),
                    (p + "self_attn.k_proj.weight", (KV * hd, D), "w"),
                    (p + "self_attn.v_proj.weight", (KV * hd, D), "w"),
                    (p + "self_attn.o_proj.weight", (D, H * hd), "w"),
                    (p + "post_attention_layernorm.weight", (D,), "norm"),
                    (p + "mlp.gate_proj.weight", (I, D), "w"),
                    (p + "mlp.up_proj.weight", (I, D), "w"),
                    (p + "mlp.down_proj.weight", (D, I), "w")]
        return out + [("model.norm.weight", (D,), "norm"),
                      ("lm_head.weight", (V, D), "w")]
    if conf["model_type"] == "gpt2":
        D, V, P = conf["n_embd"], conf["vocab_size"], conf["n_positions"]
        out += [("wte.weight", (V, D), "w"), ("wpe.weight", (P, D), "w")]
        for i in range(conf["n_layer"]):
            p = f"h.{i}."
            out += [(p + "ln_1.weight", (D,), "norm"),
                    (p + "ln_1.bias", (D,), "b"),
                    (p + "attn.bias", (1, 1, P, P), "buf"),
                    (p + "attn.c_attn.weight", (D, 3 * D), "w"),
                    (p + "attn.c_attn.bias", (3 * D,), "b"),
                    (p + "attn.c_proj.weight", (D, D), "w"),
                    (p + "attn.c_proj.bias", (D,), "b"),
                    (p + "ln_2.weight", (D,), "norm"),
                    (p + "ln_2.bias", (D,), "b"),
                    (p + "mlp.c_fc.weight", (D, 4 * D), "w"),
                    (p + "mlp.c_fc.bias", (4 * D,), "b"),
                    (p + "mlp.c_proj.weight", (4 * D, D), "w"),
                    (p + "mlp.c_proj.bias", (D,), "b")]
        return out + [("ln_f.weight", (D,), "norm"), ("ln_f.bias", (D,), "b")]
    D, V = conf["hidden_size"], conf["vocab_size"]
    out += [("word_embeddings.weight", (V, D), "w"),
            ("word_embeddings_layernorm.weight", (D,), "norm"),
            ("word_embeddings_layernorm.bias", (D,), "b")]
    for i in range(conf["n_layer"]):
        p = f"h.{i}."
        out += [(p + "input_layernorm.weight", (D,), "norm"),
                (p + "input_layernorm.bias", (D,), "b"),
                (p + "self_attention.query_key_value.weight", (3 * D, D),
                 "w"),
                (p + "self_attention.query_key_value.bias", (3 * D,), "b"),
                (p + "self_attention.dense.weight", (D, D), "w"),
                (p + "self_attention.dense.bias", (D,), "b"),
                (p + "post_attention_layernorm.weight", (D,), "norm"),
                (p + "post_attention_layernorm.bias", (D,), "b"),
                (p + "mlp.dense_h_to_4h.weight", (4 * D, D), "w"),
                (p + "mlp.dense_h_to_4h.bias", (4 * D,), "b"),
                (p + "mlp.dense_4h_to_h.weight", (D, 4 * D), "w"),
                (p + "mlp.dense_4h_to_h.bias", (D,), "b")]
    return out + [("ln_f.weight", (D,), "norm"), ("ln_f.bias", (D,), "b")]


def _draw(torch, shape, kind, seed):
    """One seeded bf16 tensor of ``kind`` on the card."""
    if kind == "buf":
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn(shape, generator=g, device="cuda").mul_(0.02)
    if kind == "norm":
        t.add_(1.0)
    return t.to(torch.bfloat16)


_LLAMA_NAMES = {"input_layernorm.weight": "attn_norm.scale",
                "post_attention_layernorm.weight": "mlp_norm.scale"}
_GPT2_NAMES = {"ln_1.weight": "attn_norm.scale", "ln_1.bias": "attn_norm.bias",
               "ln_2.weight": "mlp_norm.scale", "ln_2.bias": "mlp_norm.bias",
               "attn.c_proj.weight": "o.w", "attn.c_proj.bias": "o.b",
               "mlp.c_fc.weight": "up.w", "mlp.c_fc.bias": "up.b",
               "mlp.c_proj.weight": "down.w", "mlp.c_proj.bias": "down.b"}
_BLOOM_NAMES = {"input_layernorm.weight": "attn_norm.scale",
                "input_layernorm.bias": "attn_norm.bias",
                "post_attention_layernorm.weight": "mlp_norm.scale",
                "post_attention_layernorm.bias": "mlp_norm.bias",
                "self_attention.dense.weight": "o.w",
                "self_attention.dense.bias": "o.b",
                "mlp.dense_h_to_4h.weight": "up.w",
                "mlp.dense_h_to_4h.bias": "up.b",
                "mlp.dense_4h_to_h.weight": "down.w",
                "mlp.dense_4h_to_h.bias": "down.b"}
_TOP_NAMES = {"model.embed_tokens.weight": "embed.tokens",
              "model.norm.weight": "final_norm.scale",
              "wte.weight": "embed.tokens", "wpe.weight": "embed.positions",
              "word_embeddings.weight": "embed.tokens",
              "word_embeddings_layernorm.weight": "embed.norm.scale",
              "word_embeddings_layernorm.bias": "embed.norm.bias",
              "ln_f.weight": "final_norm.scale", "ln_f.bias": "final_norm.bias"}


def _port_names(conf, key, t):
    """The port's flat-dict tensors that HF tensor ``key`` (written as
    ``t``) must become, by this script's own reading of the HF layouts:
    torch ``nn.Linear`` weights [out, in] transposed, gpt2's Conv1D
    [in, out] as they are, fused QKV split (gpt2 by columns, bloom per
    head [H, 3, hd])."""
    mt = conf["model_type"]
    if key in _TOP_NAMES:
        return [(_TOP_NAMES[key], t)]
    if key == "lm_head.weight":
        return [("lm_head.w", t.T.contiguous())]
    if mt == "llama":
        i, rest = key.split(".")[2], key.split(".", 3)[3]
        if rest in _LLAMA_NAMES:
            return [(f"layers.{i}.{_LLAMA_NAMES[rest]}", t)]
        n = rest.split(".")[1].split("_")[0]      # q_proj -> q, ...
        return [(f"layers.{i}.{n}.w", t.T.contiguous())]
    _, i, rest = key.split(".", 2)
    if mt == "gpt2":
        if rest == "attn.bias":
            return []
        D = conf["n_embd"]
        if rest.startswith("attn.c_attn."):
            leaf = "w" if rest.endswith("weight") else "b"
            return [(f"layers.{i}.{n}.{leaf}",
                     t[..., j * D:(j + 1) * D].contiguous())
                    for j, n in enumerate("qkv")]
        return [(f"layers.{i}.{_GPT2_NAMES[rest]}", t)]
    D, H = conf["hidden_size"], conf["n_head"]
    if rest.startswith("self_attention.query_key_value."):
        if rest.endswith("weight"):
            w3 = t.view(H, 3, D // H, D)
            return [(f"layers.{i}.{n}.w", w3[:, j].reshape(D, D).T
                     .contiguous()) for j, n in enumerate("qkv")]
        b3 = t.view(H, 3, D // H)
        return [(f"layers.{i}.{n}.b", b3[:, j].reshape(D).contiguous())
                for j, n in enumerate("qkv")]
    name = _BLOOM_NAMES[rest]
    return [(f"layers.{i}.{name}",
             t.T.contiguous() if name.endswith(".w") else t)]


def write_checkpoint(torch, path, conf, seed, shards=1, tensors=None,
                     names=None):
    """Write ``conf``'s checkpoint directory like the hub's: config.json
    and bf16 safetensors (``shards`` files of about equal bytes with
    their index), every tensor drawn on the card from ``seed`` and
    written by this script's own safetensors writer. ``tensors(conf)``
    and ``names(conf, key, t)`` (default ``_hf_tensors`` /
    ``_port_names``) say what the files hold and what each tensor must
    load as. Returns (the port's flat dict the files must load as, on
    the card; file bytes; seconds)."""
    tensors, names = tensors or _hf_tensors, names or _port_names
    import struct
    t0 = time.perf_counter()
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f, indent=2)
    specs = tensors(conf)
    sizes = [2 * int(torch.Size(shape).numel()) for _, shape, _ in specs]
    total = sum(sizes)
    groups, acc = [[]], 0
    for idx, n in enumerate(sizes):
        if acc >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(idx)
        acc += n
    files = (["model.safetensors"] if shards == 1 else
             [f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
              for k in range(shards)])
    expected, weight_map, nbytes = {}, {}, 0
    for fname, group in zip(files, groups):
        header, off = {}, 0
        for idx in group:
            key, shape, _ = specs[idx]
            header[key] = {"dtype": "BF16", "shape": list(shape),
                           "data_offsets": [off, off + sizes[idx]]}
            off += sizes[idx]
            weight_map[key] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for idx in group:
                key, shape, kind = specs[idx]
                t = _draw(torch, shape, kind, seed * 100003 + idx)
                f.write(t.view(torch.int16).cpu().numpy().data)
                for name, e in names(conf, key, t):
                    expected[name] = e
                del t
        nbytes += 8 + len(raw) + off
    if shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f)
    torch.cuda.synchronize()
    return expected, nbytes, time.perf_counter() - t0


def _bits(torch, t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _bitwise(torch, got, want):
    """Every tensor of ``want`` in ``got`` with the same dtype, shape and
    bits, and no other; returns the count."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    bad = [k for k, t in want.items()
           if got[k].dtype != t.dtype or got[k].shape != t.shape
           or not torch.equal(_bits(torch, got[k]), _bits(torch, t))]
    assert not bad, f"params differ from the written tensors: {bad[:6]}"
    return len(want)


def _sampling(body):
    """The SamplingParams the worker builds from a body's ``sampling``."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    sp = body or {}
    return SamplingParams(temperature=float(sp.get("temperature", 0.8)),
                          top_k=int(sp.get("top_k", 50)),
                          top_p=float(sp.get("top_p", 0.95)),
                          do_sample=bool(sp.get("do_sample", True)))


def _timed_load(torch, base, body, nbytes):
    """/load_model ``body``; returns (its answer, a row of load seconds,
    GB/s of file bytes over the worker's load time, and the peak device
    memory the load allocated above what was allocated before it)."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, res = _http(base + "/load_model", body)
    wall = time.perf_counter() - t0
    assert st == 200 and res["status"] == "success", res
    peak = torch.cuda.max_memory_allocated() - before
    row = {"load_s": res["load_time_s"], "wall_s": wall,
           "file_bytes": nbytes, "gb_per_s": nbytes / 1e9 / res["load_time_s"],
           "peak_load_bytes": peak,
           "param_bytes": res["stats"].get("param_bytes")}
    return res, row


def _greedy_batched(base, worker, kernels, cfg, name, route):
    """Phase 3's greedy request through a batched load, alone: the
    route's decode kernel (``decode_kernel``) launches num_layers times
    per weight pass and no other attention kernel launches. Returns its
    tokens."""
    n_tok, sampling, seed = ENGINE_REQUESTS[0]
    s0 = worker.metrics.snapshot()["counters"]
    zero_counts(kernels)
    st, r = _http(base + "/inference", {
        "model_name": name, "prompt": engine_prompt(n_tok, seed),
        "max_new_tokens": NEW_TOKENS, "sampling": sampling, "seed": seed})
    assert st == 200 and r["status"] == "success", r
    launches = read_counts(kernels)
    passes = (worker.metrics.snapshot()["counters"]["batcher_weight_passes"]
              - s0.get("batcher_weight_passes", 0))
    mine = decode_kernel(cfg, route)
    for k in ("paged_flash_decode", "fused_decode_step", "flash_decode",
              "flash_attention"):
        assert launches[k] == (cfg.num_layers * passes if k == mine else 0), \
            (k, launches, passes)
    return r["tokens"], launches


def _reference_tokens(torch, cfg, params, routes=(), max_seq=4096,
                      requests=ENGINE_REQUESTS):
    """Tokens of an InferenceEngine built in this process on ``params``
    for phase 3's requests (or ``requests``; max_seq 4096, as the worker
    loads), and of a
    ContinuousBatcher built as the worker builds BATCHED_LOAD's for phase
    3's greedy request, per decode route."""
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
        ByteTokenizer)
    tok = ByteTokenizer(cfg.vocab_size)
    eng = InferenceEngine(cfg, params, max_seq=max_seq, device="cuda")
    out = {"engine": [eng.generate(
        [tok.encode(engine_prompt(n, seed))], max_new_tokens=NEW_TOKENS,
        sampling=_sampling(sp), seed=seed,
        eos_token_id=tok.eos_token_id).tokens[0]
        for n, sp, seed in requests]}
    eng.close()
    del eng
    n, sp, seed = ENGINE_REQUESTS[0]
    for route in routes:
        os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
        b = ContinuousBatcher(
            cfg, params, max_seq=max_seq,
            num_blocks=BATCHED_LOAD["kv_blocks"],
            block_size=BATCHED_LOAD["kv_block_size"],
            slots=BATCHED_LOAD["slots"], prefill_chunk=32, device="cuda")
        b.warm_decode_programs()
        b.start()
        try:
            out[route] = b.submit(
                tok.encode(engine_prompt(n, seed)), max_new_tokens=NEW_TOKENS,
                sampling=_sampling(sp), eos_token_id=tok.eos_token_id,
                seed=seed).wait(timeout=600)
        finally:
            b.stop()
        del b
    os.environ.pop("DLI_FUSED_DECODE", None)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _ingest_llama(torch, base, worker, kernels, root, report, total):
    """(a): Llama-3.1-8B's shape at full width (and depth unless the disk
    cannot hold it twice), bf16, 4 shards: engine, batched (fused off and
    on), engine int4, then the native int4 checkpoint of the port's
    convert CLI."""
    import shutil
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    from distributed_llm_inferencing_tpu_torch.models.params import (
        param_bytes)
    from distributed_llm_inferencing_tpu_torch.ops.quant import (
        maybe_quantize)
    conf = dict(LLAMA31_8B, num_hidden_layers=INGEST_LAYERS)
    log(f"  Llama-3.1-8B shape: DEPTH CUT to {INGEST_LAYERS} of 32 layers")
    per_layer = sum(2 * torch.Size(s).numel() for k, s, _ in
                    _hf_tensors(dict(conf, num_hidden_layers=1))
                    if ".layers." in k)
    fixed = sum(2 * torch.Size(s).numel() for k, s, _ in
                _hf_tensors(dict(conf, num_hidden_layers=0)))
    free = shutil.disk_usage(root).free
    layers = conf["num_hidden_layers"]
    while layers > 1 and 2 * (fixed + layers * per_layer) > free:
        layers -= 1
    if layers != conf["num_hidden_layers"]:
        log(f"  DISK CUT: {free / 1e9:.1f} GB free holds "
            f"{layers} of {conf['num_hidden_layers']} layers twice over")
        conf["num_hidden_layers"] = layers
    report["llama_layers"] = layers
    report["disk_free_bytes"] = free
    path = os.path.join(root, "llama-3.1-8b")
    expected, nbytes, write_s = write_checkpoint(
        torch, path, conf, INGEST_SEED, shards=LLAMA31_SHARDS)
    log(f"  wrote {path}: {nbytes / 1e9:.3f} GB in {LLAMA31_SHARDS} shards "
        f"in {write_s:.1f} s")
    name = "llama-3.1-8b-ckpt"
    cfg = config_from_hf(conf, name=path).replace(name=name)
    assert cfg.rope_inv_freq is not None and cfg.rope_theta == 500000.0
    L = cfg.num_layers
    largest = max(t.numel() for t in expected.values())
    row = {"write_s": write_s, "file_bytes": nbytes,
           "param_bytes": param_bytes(expected)}

    # engine bf16: the load's time, rate and peak; bitwise; phase 3
    res, row["engine"] = _timed_load(torch, base, {
        "model_name": name, "checkpoint_path": path, "max_seq": 4096}, nbytes)
    bound = param_bytes(expected) + LOAD_PEAK_LEAVES_F32 * 4 * largest
    row["engine"]["peak_bound_bytes"] = bound
    log("  load engine bf16", json.dumps(row["engine"]))
    assert row["engine"]["peak_load_bytes"] <= bound, row["engine"]
    st, health = _http(base + "/health")
    [desc] = [m for m in health["loaded_models"] if m["name"] == name]
    assert desc["source"] == path and desc["param_bytes"] == \
        param_bytes(expected), desc
    row["engine"]["health_param_bytes"] = desc["param_bytes"]
    row["engine"]["bitwise"] = _bitwise(
        torch, worker.models[name].engine.params, expected)
    launches, rows = _engine_requests(torch, base, kernels, cfg, name, 0)
    _add(total, launches)
    row["engine"]["tokens"] = [r["tokens"] for r in rows]
    row["engine"]["peak_serving_bytes"] = torch.cuda.max_memory_allocated()
    st, _ = _http(base + "/unload_model", {"model_name": name})
    assert st == 200

    # batched, fused off and on: phase 5's exact counts, bitwise, and
    # phase 3's greedy request alone
    load = dict(BATCHED_LOAD, model_name=name, checkpoint_path=path)
    load.pop("allow_random_init")
    for route in ("paged", "fused"):
        os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"

        def check(lm, route=route):
            toks, launches = _greedy_batched(base, worker, kernels, cfg,
                                             name, route)
            _add(total, launches)
            return {"bitwise": _bitwise(torch, lm.batcher.params, expected),
                    "greedy": toks}
        summary, _ = _batched_pass(torch, base, worker, kernels, route, cfg,
                                   load=load, check=check)
        _add(total, summary["launches"])
        row[f"batched_{route}"] = {k: summary[k] for k in (
            "check", "weight_passes", "tokens_per_s", "param_bytes",
            "peak_memory_bytes")}
    os.environ.pop("DLI_FUSED_DECODE", None)

    # engine int4: the load quantizes each leaf as it lands
    q_cfg = cfg.replace(quant="int4")
    expected_q = maybe_quantize(dict(expected), q_cfg)
    res, row["engine_int4"] = _timed_load(torch, base, {
        "model_name": name, "checkpoint_path": path, "max_seq": 4096,
        "quantize": "int4"}, nbytes)
    row["engine_int4"]["bitwise"] = _bitwise(
        torch, worker.models[name].engine.params, expected_q)
    launches, rows = _engine_requests(torch, base, kernels, q_cfg, name,
                                      q4_per_pass(q_cfg))
    _add(total, launches)
    row["engine_int4"]["tokens"] = [r["tokens"] for r in rows]
    log("  load engine int4", json.dumps(
        {k: v for k, v in row["engine_int4"].items() if k != "tokens"}))
    st, _ = _http(base + "/unload_model", {"model_name": name})
    assert st == 200

    # (c) the native checkpoint: convert --quantize int4, then load it
    gc.collect()
    torch.cuda.empty_cache()
    native = os.path.join(root, "llama-3.1-8b-int4-native")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "distributed_llm_inferencing_tpu_torch", "convert",
                    "--checkpoint_path", path, "--quantize", "int4",
                    "--out", native], cwd=HERE, check=True, timeout=900)
    convert_s = time.perf_counter() - t0
    native_bytes = sum(os.path.getsize(os.path.join(native, f))
                       for f in os.listdir(native))
    res, row["native_int4"] = _timed_load(torch, base, {
        "model_name": name, "native_checkpoint": native, "max_seq": 4096},
        native_bytes)
    row["native_int4"]["convert_s"] = convert_s
    row["native_int4"]["bitwise"] = _bitwise(
        torch, worker.models[name].engine.params, expected_q)
    launches, rows = _engine_requests(torch, base, kernels, q_cfg, name,
                                      q4_per_pass(q_cfg))
    _add(total, launches)
    tokens = [r["tokens"] for r in rows]
    assert tokens == row["engine_int4"]["tokens"], \
        "the native int4 checkpoint serves other tokens than its HF load"
    log("  native int4", json.dumps(row["native_int4"]))
    st, _ = _http(base + "/unload_model", {"model_name": name})
    assert st == 200
    shutil.rmtree(native)
    shutil.rmtree(path)

    # the in-process references on the written tensors
    ref = _reference_tokens(torch, cfg, expected, ("paged", "fused"))
    assert ref["engine"] == row["engine"]["tokens"], \
        (ref["engine"], row["engine"]["tokens"])
    for route in ("paged", "fused"):
        assert ref[route] == row[f"batched_{route}"]["check"]["greedy"], \
            (route, ref[route])
    del expected
    ref_q = _reference_tokens(torch, q_cfg, expected_q)
    assert ref_q["engine"] == row["engine_int4"]["tokens"], ref_q
    del expected_q
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _ingest_family(torch, base, worker, kernels, root, conf, routes, total):
    """(b): one hub-layout checkpoint (no prefix, tied head absent) at
    full width, bf16: engine mode with phase 3's exact counts, then
    batched per decode route with phase 3's greedy request; every param
    bitwise, every token equal to in-process engines on the written
    tensors."""
    import shutil
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    mt = conf["model_type"]
    path = os.path.join(root, mt)
    expected, nbytes, write_s = write_checkpoint(torch, path, conf,
                                                 INGEST_SEED + 1)
    name = f"{mt}-ckpt"
    cfg = config_from_hf(conf, name=path).replace(name=name)
    row = {"layers": cfg.num_layers, "write_s": write_s}
    res, row["engine"] = _timed_load(torch, base, {
        "model_name": name, "checkpoint_path": path, "max_seq": 4096}, nbytes)
    row["engine"]["bitwise"] = _bitwise(
        torch, worker.models[name].engine.params, expected)
    launches, rows = _engine_requests(torch, base, kernels, cfg, name, 0)
    _add(total, launches)
    row["engine"]["tokens"] = [r["tokens"] for r in rows]
    st, _ = _http(base + "/unload_model", {"model_name": name})
    assert st == 200
    load = dict(BATCHED_LOAD, model_name=name, checkpoint_path=path,
                max_seq=min(4096, cfg.max_position_embeddings))
    load.pop("allow_random_init")
    for route in routes:
        os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
        res, row[f"batched_{route}"] = _timed_load(torch, base, load, nbytes)
        row[f"batched_{route}"]["bitwise"] = _bitwise(
            torch, worker.models[name].batcher.params, expected)
        toks, launches = _greedy_batched(base, worker, kernels, cfg, name,
                                         route)
        _add(total, launches)
        row[f"batched_{route}"]["greedy"] = toks
        st, _ = _http(base + "/unload_model", {"model_name": name})
        assert st == 200
    os.environ.pop("DLI_FUSED_DECODE", None)
    shutil.rmtree(path)
    ref = _reference_tokens(torch, cfg, expected, routes,
                            max_seq=load["max_seq"])
    assert ref["engine"] == row["engine"]["tokens"], mt
    for route in routes:
        assert ref[route] == row[f"batched_{route}"]["greedy"], (mt, route)
    log(f"  {mt}", json.dumps({k: ({kk: vv for kk, vv in v.items()
                                    if kk not in ("tokens", "greedy")}
                                   if isinstance(v, dict) else v)
                               for k, v in row.items()}))
    del expected
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_ingestion(torch, kernels, smi):
    """Phase 15: model ingestion. (a) A Llama-3.1-8B-shaped checkpoint
    directory, (b) gpt2-xl at full depth and bloom-7b1 at full width and
    BLOOM_LAYERS layers, (c) the native int4 checkpoint of (a), written
    here from seeded tensors and served through the worker by
    ``checkpoint_path`` / ``native_checkpoint``: every param bitwise equal
    to what was written, exact launch counts, tokens equal to in-process
    engines on the written tensors; load seconds, GB/s and peak memory
    reported with the card's name and power limit."""
    import shutil
    import tempfile
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dli-ingest-")
    total = {k: 0 for k in kernels}
    report = {"smi": smi}
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    try:
        report["llama"] = _ingest_llama(torch, base, worker, kernels, root,
                                        report, total)
        report["gpt2-xl"] = _ingest_family(torch, base, worker, kernels,
                                           root, GPT2_XL, ("paged",), total)
        report["bloom-7b1"] = _ingest_family(torch, base, worker, kernels,
                                             root, BLOOM_7B1, ("paged",),
                                             total)
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    report["launches"] = total
    report["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 wall time {report['seconds']:.1f} s [{smi}]")
    return report


# ---------------------------------------------------------------------
# phase 16: the dense switches of the later families
# ---------------------------------------------------------------------

# google/gemma-2-9b's config.json (its published fields): 42 layers,
# sliding (4096) and global layers alternating, both softcaps
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "attention_bias": False, "attention_dropout": 0.0,
    "attn_logit_softcapping": 50.0, "bos_token_id": 2,
    "cache_implementation": "hybrid", "eos_token_id": 1,
    "final_logit_softcapping": 30.0, "head_dim": 256,
    "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "num_attention_heads": 16,
    "num_hidden_layers": 42, "num_key_value_heads": 8, "pad_token_id": 0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "sliding_window": 4096,
    "sliding_window_size": 4096, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 256000}
# Qwen/Qwen3-8B's config.json, 36 layers cut to QWEN3_LAYERS
QWEN3_LAYERS = 4
QWEN3_8B = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
    "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 12288, "max_position_embeddings": 40960,
    "max_window_layers": 36, "num_attention_heads": 32,
    "num_hidden_layers": QWEN3_LAYERS, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000,
    "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936}
# phase 3's requests plus one past gemma-2's 4096-key window, and phase
# 5's prompt lengths plus the same long one; served with max_seq 8192
LONG_PROMPT = 4500
LATER_REQUESTS = ENGINE_REQUESTS + ((LONG_PROMPT, {"do_sample": False}, 3),)
LATER_LENS = PROMPT_LENS + (LONG_PROMPT,)
LATER_MAX_SEQ = 8192
# (c): each later converter type's published config (the repo named in
# each comment) at full width, cut to 2 layers for phase 4's card-vs-host
# check: its per-layer keys keep one layer of each kind, and every window
# is cut to XCHECK_WINDOW so that the check's prompts (<= 68 positions)
# pass it
XCHECK_WINDOW = 24
LATER_XCHECK = {
    # EleutherAI/gpt-neo-2.7B
    "gpt_neo": {"model_type": "gpt_neo", "hidden_size": 2560,
                "num_layers": 2, "num_heads": 20, "window_size": 256,
                "attention_types": [[["global", "local"], 1]],
                "vocab_size": 50257, "max_position_embeddings": 2048,
                "activation_function": "gelu_new",
                "layer_norm_epsilon": 1e-05},
    # google/gemma-2-9b
    "gemma2": dict(GEMMA2_9B, num_hidden_layers=2),
    # CohereForAI/c4ai-command-r-plus (use_qk_norm: per-head layernorms)
    "cohere": {"model_type": "cohere", "hidden_size": 12288,
               "intermediate_size": 33792, "num_attention_heads": 96,
               "num_key_value_heads": 8, "num_hidden_layers": 2,
               "vocab_size": 256000, "logit_scale": 0.8333333333333334,
               "use_qk_norm": True, "layer_norm_eps": 1e-05,
               "rope_theta": 75000000.0, "max_position_embeddings": 131072},
    # Qwen/Qwen3-8B
    "qwen3": dict(QWEN3_8B, num_hidden_layers=2),
    # ibm-granite/granite-3.1-8b-instruct
    "granite": {"model_type": "granite", "hidden_size": 4096,
                "intermediate_size": 12800, "num_attention_heads": 32,
                "num_key_value_heads": 8, "num_hidden_layers": 2,
                "vocab_size": 49155, "embedding_multiplier": 12.0,
                "attention_multiplier": 0.0078125,
                "residual_multiplier": 0.22, "logits_scaling": 16.0,
                "rope_theta": 10000000.0, "rms_norm_eps": 1e-05,
                "max_position_embeddings": 131072,
                "tie_word_embeddings": True},
    # allenai/OLMo-2-1124-7B
    "olmo2": {"model_type": "olmo2", "hidden_size": 4096,
              "intermediate_size": 11008, "num_attention_heads": 32,
              "num_key_value_heads": 32, "num_hidden_layers": 2,
              "vocab_size": 100352, "rms_norm_eps": 1e-06,
              "rope_theta": 500000, "max_position_embeddings": 4096},
    # THUDM/GLM-4-9B-0414
    "glm4": {"model_type": "glm4", "hidden_size": 4096,
             "intermediate_size": 13696, "num_attention_heads": 32,
             "num_key_value_heads": 2, "num_hidden_layers": 2,
             "head_dim": 128, "partial_rotary_factor": 0.5,
             "vocab_size": 151552, "rms_norm_eps": 1e-05,
             "max_position_embeddings": 32768, "attention_bias": True},
    # nvidia/Nemotron-Mini-4B-Instruct
    "nemotron": {"model_type": "nemotron", "hidden_size": 3072,
                 "intermediate_size": 9216, "num_attention_heads": 24,
                 "num_key_value_heads": 8, "num_hidden_layers": 2,
                 "head_dim": 128, "vocab_size": 256000,
                 "partial_rotary_factor": 0.5, "norm_eps": 1e-05,
                 "max_position_embeddings": 4096, "hidden_act": "relu2"},
    # HuggingFaceTB/SmolLM3-3B (its 4th layer NoPE: the cut keeps one)
    "smollm3": {"model_type": "smollm3", "hidden_size": 2048,
                "intermediate_size": 11008, "num_attention_heads": 16,
                "num_key_value_heads": 4, "num_hidden_layers": 2,
                "no_rope_layers": [1, 0], "vocab_size": 128256,
                "rope_theta": 5000000.0, "rms_norm_eps": 1e-06,
                "max_position_embeddings": 65536,
                "tie_word_embeddings": True},
    # tencent/Hunyuan-7B-Instruct
    "hunyuan_v1_dense": {"model_type": "hunyuan_v1_dense",
                         "hidden_size": 4096, "intermediate_size": 14336,
                         "num_attention_heads": 32,
                         "num_key_value_heads": 8, "num_hidden_layers": 2,
                         "head_dim": 128, "vocab_size": 128167,
                         "rms_norm_eps": 1e-05,
                         "max_position_embeddings": 32768,
                         "tie_word_embeddings": True},
    # LGAI-EXAONE/EXAONE-4.0-32B (sliding then global layers)
    "exaone4": {"model_type": "exaone4", "hidden_size": 5120,
                "intermediate_size": 27392, "num_attention_heads": 40,
                "num_key_value_heads": 8, "num_hidden_layers": 2,
                "head_dim": 128, "vocab_size": 102400,
                "sliding_window": 4096,
                "layer_types": ["sliding_attention", "full_attention"],
                "rms_norm_eps": 1e-05, "max_position_embeddings": 131072},
}


def _later_tensors(conf):
    """(HF key, shape, kind) of every tensor of a gemma2 or qwen3
    checkpoint (``_hf_tensors``' kinds; gemma-2's (1 + w) norms are drawn
    as "w", near 0 as the published ones)."""
    D, I, V = conf["hidden_size"], conf["intermediate_size"], \
        conf["vocab_size"]
    H, KV, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    gemma = conf["model_type"] == "gemma2"
    norm = "w" if gemma else "norm"
    out = [("model.embed_tokens.weight", (V, D), "w")]
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (D,), norm),
                (p + "self_attn.q_proj.weight", (H * hd, D), "w"),
                (p + "self_attn.k_proj.weight", (KV * hd, D), "w"),
                (p + "self_attn.v_proj.weight", (KV * hd, D), "w"),
                (p + "self_attn.o_proj.weight", (D, H * hd), "w")]
        if gemma:
            out += [(p + n + ".weight", (D,), norm) for n in (
                "post_attention_layernorm", "pre_feedforward_layernorm",
                "post_feedforward_layernorm")]
        else:
            out += [(p + "self_attn.q_norm.weight", (hd,), norm),
                    (p + "self_attn.k_norm.weight", (hd,), norm),
                    (p + "post_attention_layernorm.weight", (D,), norm)]
        out += [(p + "mlp.gate_proj.weight", (I, D), "w"),
                (p + "mlp.up_proj.weight", (I, D), "w"),
                (p + "mlp.down_proj.weight", (D, I), "w")]
    out.append(("model.norm.weight", (D,), norm))
    if not gemma:
        out.append(("lm_head.weight", (V, D), "w"))
    return out


_GEMMA2_NORMS = {"input_layernorm": "attn_norm",
                 "post_attention_layernorm": "attn_post_norm",
                 "pre_feedforward_layernorm": "mlp_norm",
                 "post_feedforward_layernorm": "mlp_post_norm"}


def _later_names(conf, key, t):
    """``_port_names`` for gemma2 and qwen3, by this script's own reading
    of their layouts: gemma-2's (1 + w) norms stored as 1 + w (f32, one
    rounding), its q not scaled (query_pre_attn_scalar = head_dim); qwen3
    the llama layout with q_norm / k_norm as they are."""
    import torch
    if conf["model_type"] == "gemma2" and "norm" in key:
        plus1 = (t.float() + 1.0).to(torch.bfloat16)
        if key == "model.norm.weight":
            return [("final_norm.scale", plus1)]
        i, rest = key.split(".")[2], key.split(".", 3)[3]
        return [(f"layers.{i}.{_GEMMA2_NORMS[rest[:-len('.weight')]]}.scale",
                 plus1)]
    if ".self_attn.q_norm." in key or ".self_attn.k_norm." in key:
        i, n = key.split(".")[2], key.split(".")[4][0]
        return [(f"layers.{i}.{n}_norm.scale", t)]
    return _port_names(dict(conf, model_type="llama"), key, t)


def _hidden(torch, model, tokens):
    """``model``'s final hidden states [1, S, D] for ``tokens`` [1, S]
    (its prefill with the head left out)."""
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    cache = init_cache(model.cfg, 1, tokens.shape[1], device="cuda")
    lens = torch.tensor([tokens.shape[1]], dtype=torch.int32, device="cuda")
    model.unembed = lambda x: x       # this instance only
    try:
        with torch.inference_mode():
            h, _ = model.prefill(tokens, lens, cache)
    finally:
        del model.unembed
    return h


def _later_depth(torch, kernels, cfg, params, lens):
    """Phase 6's prefill check at full depth, one prompt at a time (the
    longest past the window): the bf16 attention through the tensor-core
    kernel ("kernel") and through ``flash_attention_ref`` on the card
    ("plain"), each against the same weights in f32; the logits compared
    in chunks of rows, the head run on the final hidden states (a
    256000-row head over 4500 rows is 4.6 GB of f32 logits). The
    kernel's worst error must stay within ROUTE_ERR_FACTOR x the plain
    route's."""
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops import attention as ta
    from distributed_llm_inferencing_tpu_torch.ops import flash_attention as fa
    import numpy as np
    L = cfg.num_layers
    m16 = Transformer(cfg, params)
    m32 = Transformer(cfg.replace(dtype="float32"),
                      {k: t.float() for k, t in params.items()})
    rng = np.random.default_rng(16)
    out = {"prompt_tokens": list(lens), "kernel": [], "plain": []}
    for n in lens:
        tokens = torch.tensor(rng.integers(1, cfg.vocab_size, n),
                              device="cuda")[None]
        zero_counts(kernels)
        h32 = _hidden(torch, m32, tokens)
        hs = {}
        for route in ("kernel", "plain"):
            kernel = ta.flash_attention
            if route == "plain":
                ta.flash_attention = fa.flash_attention_ref
            try:
                hs[route] = _hidden(torch, m16, tokens)
            finally:
                ta.flash_attention = kernel
        n_fa = read_counts(kernels)
        # f32 on the CUDA-core form, bf16 on the tensor cores, plain: none
        assert (n_fa["flash_attention"], n_fa["flash_attention[mma]"]) == \
            (2 * L, L), n_fa
        for route, h in hs.items():
            worst = 0.0
            with torch.inference_mode():
                for a in range(0, n, 512):
                    ref = m32.unembed(h32[:, a:a + 512])
                    lg = m16.unembed(h[:, a:a + 512])
                    assert torch.isfinite(lg).all(), f"{route}: not finite"
                    worst = max(worst, float((lg - ref).abs().max()))
                    del ref, lg
            out[route].append(worst)
        del h32, hs
    del m16, m32
    gc.collect()
    torch.cuda.empty_cache()
    worst_k, worst_p = max(out["kernel"]), max(out["plain"])
    out.update(worst_kernel=worst_k, worst_plain=worst_p,
               factor=worst_k / worst_p)
    log(f"  {cfg.name} full-depth prefill, bf16 vs f32", json.dumps(out))
    assert worst_k <= ROUTE_ERR_FACTOR * worst_p, \
        f"{cfg.name}: tensor-core prefill off f32 by {worst_k}, over " \
        f"{ROUTE_ERR_FACTOR} x the plain route's {worst_p}"
    return out


def _later_serving(torch, worker, kernels, root, conf, smi, total):
    """One seeded HF directory of ``conf`` (written by phase 15's writer)
    through the worker, bf16, max_seq LATER_MAX_SEQ: engine mode with
    LATER_REQUESTS and batched mode on the paged route with phase 5's
    bodies plus the LONG_PROMPT one, each with graphs on and off (equal
    tokens and exact counts: one flash_attention[mma] per layer per
    request, one flash_decode per layer per step, one paged_flash_decode
    per layer per pass, no fused_decode_step: its gate refuses these
    switches; one profiled replay per captured program); every param
    bitwise equal to the tensor written; the tokens equal to an
    in-process engine's and batcher's on the written tensors; the
    directory deleted before the next is written. Then the full-depth
    prefill check (``_later_depth``)."""
    import shutil

    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    mt = conf["model_type"]
    path = os.path.join(root, mt)
    expected, nbytes, write_s = write_checkpoint(
        torch, path, conf, INGEST_SEED + 2, tensors=_later_tensors,
        names=_later_names)
    name = f"{mt}-ckpt"
    cfg = config_from_hf(conf, name=path).replace(name=name)
    log(f"  wrote {path}: {nbytes / 1e9:.3f} GB, {cfg.num_layers} layers, "
        f"in {write_s:.1f} s")
    row = {"layers": cfg.num_layers, "file_bytes": nbytes,
           "write_s": write_s, "attn_windows": cfg.attn_windows,
           "sliding_window": cfg.sliding_window,
           "attn_softcap": cfg.attn_softcap,
           "logit_softcap": cfg.logit_softcap, "qk_norm": cfg.qk_norm}
    body = {"model_name": name, "checkpoint_path": path,
            "max_seq": LATER_MAX_SEQ}
    row["engine"] = _graphs_engine(
        torch, worker, kernels, cfg, None, load=body,
        requests=LATER_REQUESTS,
        check=lambda lm: _bitwise(torch, lm.engine.params, expected))
    for n in row["engine"]["launches_per_request"]:
        _add(total, {k: 2 * v for k, v in n.items()})   # graphs on, off
    load = dict(BATCHED_LOAD, **body)
    load.pop("allow_random_init")
    base = _worker_base(worker)

    def check(lm):
        toks, launches = _greedy_batched(base, worker, kernels, cfg, name,
                                         "paged")
        _add(total, launches)
        return {"bitwise": _bitwise(torch, lm.batcher.params, expected),
                "greedy": toks}
    runs = {on: _graphs_wave(torch, worker, kernels, cfg, "paged", None, on,
                             LATER_LENS, load=load,
                             check=check if on else None)
            for on in (True, False)}
    on, off = runs[True], runs[False]
    assert on["tokens"] == off["tokens"], f"{mt}: graphs on/off tokens differ"
    assert on["weight_passes"] == off["weight_passes"] \
        and on["launches"] == off["launches"], (on["launches"],
                                                off["launches"])
    for r in (on, off):
        _add(total, r["launches"])
    assert on["launches"]["fused_decode_step"] == 0
    row["batched"] = {mode: {k: v for k, v in r.items() if k != "tokens"}
                      for mode, r in (("on", on), ("off", off))}
    shutil.rmtree(path)
    ref = _reference_tokens(torch, cfg, expected, ("paged",),
                            max_seq=LATER_MAX_SEQ, requests=LATER_REQUESTS)
    assert ref["engine"] == row["engine"]["tokens"], \
        (mt, ref["engine"], row["engine"]["tokens"])
    assert ref["paged"] == on["check"]["greedy"], (mt, ref["paged"])
    row["depth"] = _later_depth(torch, kernels, cfg, expected,
                                (250, LONG_PROMPT))
    del expected
    gc.collect()
    torch.cuda.empty_cache()
    timing = {"engine_ms_per_decode_step": row["engine"]["ms_per_decode_step"],
              "engine_prefill_ms": row["engine"]["prefill_ms"],
              "batched_ms_per_weight_pass": {
                  mode: row["batched"][mode]["decode_chunk_ms_per_weight_pass"]
                  for mode in ("on", "off")},
              "batched_tokens_per_s": {
                  mode: row["batched"][mode]["tokens_per_s"]
                  for mode in ("on", "off")}}
    row["timing"] = timing
    log(f"  {mt} bf16 through the worker [{smi}]", json.dumps(timing))
    return row


def _later_xcheck_cfg(mt):
    """LATER_XCHECK's config of ``mt`` (2 layers), every window cut to
    XCHECK_WINDOW."""
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    cfg = config_from_hf(LATER_XCHECK[mt], name=f"{mt}-xcheck")
    cut = {}
    if cfg.sliding_window is not None:
        cut["sliding_window"] = XCHECK_WINDOW
    if cfg.attn_windows is not None:
        cut["attn_windows"] = tuple(None if w is None else XCHECK_WINDOW
                                    for w in cfg.attn_windows)
    return cfg.replace(**cut), cut


def phase_later(torch, fa, qm, kernels, smi):
    """Phase 16: the dense switches of the later families. (a) a
    gemma-2-9b-shaped HF directory at full width and depth and (b) a
    Qwen3-8B-shaped one at full width, QWEN3_LAYERS layers, through the
    worker (``_later_serving``); (c) phase 4's card-vs-host check of
    each later converter type at full width, 2 layers (LATER_XCHECK).
    Returns the report, launches included; prints its wall time."""
    import shutil
    import tempfile

    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    t0 = time.perf_counter()
    report = {"smi": smi, "cross_check": {}}
    total = {k: 0 for k in kernels}
    root = tempfile.mkdtemp(prefix="dli-later-")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    try:
        zero_counts(kernels)
        report["gemma-2-9b"] = _later_serving(torch, worker, kernels, root,
                                              GEMMA2_9B, smi, total)
        report["gemma2_launches"] = dict(total)
        log(f"  Qwen3-8B shape: DEPTH CUT to {QWEN3_LAYERS} of 36 layers")
        report["qwen3-8b"] = _later_serving(torch, worker, kernels, root,
                                            QWEN3_8B, smi, total)
    finally:
        os.environ.pop("DLI_CUDA_GRAPHS", None)
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    for mt in LATER_XCHECK:
        cfg, cut = _later_xcheck_cfg(mt)
        if cut:
            log(f"  {mt}: WINDOW CUT to {XCHECK_WINDOW} for the 2-layer "
                f"check ({cut})")
        on_card = mt in LATER_CARD_REFERENCE
        if on_card:
            log(f"  {mt}: reference: the plain versions on the card")
        t1 = time.perf_counter()
        errs = phase_cross_check(torch, fa, qm, None, mt, ("paged",),
                                 cfg=cfg, ref_on_card=on_card)
        errs["seconds"] = time.perf_counter() - t1
        report["cross_check"][mt] = errs
    report["launches"] = total
    report["seconds"] = time.perf_counter() - t0
    log(f"  phase 16 wall time {report['seconds']:.1f} s [{smi}]")
    return report


# ---------------------------------------------------------------------
# phase 17: the KV plane (int8 cache, host tier, KV transfer)
# ---------------------------------------------------------------------

KV_MAX_SEQ = 8192
KV_ENGINE_REQUESTS = ENGINE_REQUESTS + ((4000, {"do_sample": False}, 3),)
# the tier's pressure: a pool that holds one TIER_PROMPT-token prompt (129
# blocks of 16) and its growth; the 1500-token requests after it evict it.
# TIER_PROMPT = 4 x 512 + 16: its cold serving admits four chunks of 32
# blocks (the batcher's prefill_chunk) and then a 16-token tail over 128
# cached blocks, the shape of the tail a restore or a fetch leaves
TIER_BLOCKS, TIER_PROMPT, TIER_PRESSURE, TIER_NEW = 160, 2064, 1500, 16
TIER_ARENA_MB = 2048
# the prompt's 129 bf16 blocks take 271 MB: more than the default 256 MB
# arena holds (runtime/kvtier.py DEFAULT_HOST_MB)
DISAGG_LOAD = dict(BATCHED_LOAD, slots=2, kv_blocks=256, kv_host_mb=1024)
KV_FETCH_MB = 512


def _cache_bytes(cache):
    return sum(t.nbytes for t in (cache.k, cache.v, cache.k_scale,
                                  cache.v_scale) if t is not None)


def _kv_engine(torch, kernels, cfg):
    """(a): the engine with the bf16 and the int8 cache at max_seq 8192,
    the same requests; returns the report and the launches."""
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    out, total = {}, {}
    try:
        for kv in (None, "int8"):
            load = {"model_name": cfg.name, "allow_random_init": True,
                    "dtype": "bfloat16", "max_seq": KV_MAX_SEQ}
            if kv:
                load["kv_quantize"] = kv
            st, res = _http(base + "/load_model", load)
            assert st == 200 and res["status"] == "success", res
            launches, rows = _engine_requests(
                torch, base, kernels, cfg, cfg.name, 0,
                requests=KV_ENGINE_REQUESTS, decode_kernel=kv is None)
            _add(total, launches)
            engine = worker.models[cfg.name].engine
            cache = engine._state(1).cache
            assert cache.quantized == (kv == "int8")
            out[kv or "bf16"] = {
                "cache_bytes": _cache_bytes(cache), "requests": rows,
                "launches": launches,
                # the requests after the first of their sampling key
                # replay captured programs: the steady step
                "steady_ms_per_step": [r["decode_ms_per_weight_pass"]
                                       for r in rows[2:]]}
            st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
            assert st == 200
    finally:
        worker.shutdown()
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert out["int8"]["cache_bytes"] == L * KV_MAX_SEQ * Hkv * (2 * hd + 8)
    assert out["bf16"]["cache_bytes"] == L * KV_MAX_SEQ * Hkv * hd * 4
    greedy = [i for i, r in enumerate(KV_ENGINE_REQUESTS)
              if r[1].get("do_sample") is False]
    agree = [sum(a == b for a, b in zip(out["bf16"]["requests"][i]["tokens"],
                                        out["int8"]["requests"][i]["tokens"]))
             for i in greedy]
    out["greedy_tokens_agree_int8_vs_bf16"] = agree
    log("  int8 KV engine:", json.dumps({
        "cache_gb": {k: out[k]["cache_bytes"] / 1e9 for k in ("bf16",
                                                              "int8")},
        "steady_ms_per_step": {k: out[k]["steady_ms_per_step"]
                               for k in ("bf16", "int8")},
        "greedy_tokens_agree": agree}))
    return out, total


def _kv_batched(torch, kernels, cfg, params):
    """(b): phase 5's bodies over the int8 pool through the worker (the
    gather route with the fused kernel asked for), then ms per weight
    pass of one 32-step chunk with 8 slots live, bf16 pool against int8
    pool on ``params``."""
    from distributed_llm_inferencing_tpu_torch.ops import fused_decode
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.profile_batched import (
        PROMPT_LENS as lens, _round)
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"

    def check(lm):
        b = lm.batcher
        assert b.paged.quantized and b.paged.k.dtype == torch.int8
        assert fused_decode.enabled() and \
            not fused_decode.eligible(b.cfg, b.paged.quantized)
        return {"pool_bytes": sum(t.nbytes for t in b.paged.leaves())}
    os.environ["DLI_FUSED_DECODE"] = "1"
    try:
        wave, _ = _batched_pass(torch, base, worker, kernels, "gather", cfg,
                                load=dict(BATCHED_LOAD, kv_quantize="int8"),
                                check=check)
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    total = dict(wave["launches"])
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    # the batched profile's 8 prompts: every slot live in one chunk
    prompts = [[(i * 7919 + j * 104729) % 30000 + 3 for j in range(n)]
               for i, n in enumerate(lens)]
    full = {}
    for kv in (None, "int8"):
        b = ContinuousBatcher(cfg.replace(kv_quant=kv), params,
                              num_blocks=1024, block_size=16, slots=8,
                              max_seq=4096, prefill_chunk=None,
                              device="cuda", kv_host_mb=0)
        b.warm_decode_programs()
        _round(b, prompts, NEW_TOKENS, sp)                      # warm-up
        zero_counts(kernels)
        rounds = [_round(b, prompts, NEW_TOKENS, sp) for _ in range(2)]
        launches = read_counts(kernels)
        _add(total, launches)
        passes = sum(r["weight_passes"] for r in rounds)
        got = launches["paged_flash_decode"]
        assert got == (0 if kv else cfg.num_layers * passes), (kv, launches)
        assert launches["fused_decode_step"] == 0, launches
        full[kv or "bf16"] = {
            "ms_per_weight_pass": min(r["ms_per_weight_pass"]
                                      for r in rounds),
            "rounds": rounds,
            "pool_bytes": sum(t.nbytes for t in b.paged.leaves()),
            "paged_flash_decode": got, "weight_passes": passes}
        b.stop()
        del b
        gc.collect()
        torch.cuda.empty_cache()
    log("  int8 pool:", json.dumps({
        "worker_wave_ms_per_weight_pass":
            wave["decode_chunk_ms_per_weight_pass"],
        "full_occupancy_ms_per_weight_pass": {
            k: v["ms_per_weight_pass"] for k, v in full.items()},
        "pool_gb": {k: v["pool_bytes"] / 1e9 for k, v in full.items()}}))
    return {"worker_wave": wave, "full_occupancy": full}, total


def _serve_one(b, prompt, sampled, seed):
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
          if sampled else SamplingParams.greedy())
    r = b.submit(prompt, max_new_tokens=TIER_NEW, sampling=sp, seed=seed)
    while not r.done.is_set():
        b.step()
    return r.wait(), r.cost


def _kv_tier(torch, kernels, cfg, params):
    """(c): the same requests through a batcher with the tier on and one
    with it off (kv_host_mb 0), paged route, on ``params``."""
    import numpy as np
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    rng = np.random.default_rng(17)
    tok = lambda n: rng.integers(1, cfg.vocab_size, n).tolist()  # noqa
    prompt = tok(TIER_PROMPT)
    pressure = [tok(TIER_PRESSURE) for _ in range(4)]
    out, total = {}, {}
    os.environ["DLI_FUSED_DECODE"] = "0"
    try:
        for mb in (TIER_ARENA_MB, 0):
            b = ContinuousBatcher(cfg, params, num_blocks=TIER_BLOCKS,
                                  block_size=16, slots=2, max_seq=4096,
                                  device="cuda", kv_host_mb=mb)
            b.warm_decode_programs()
            t = {"offload_s": 0.0, "offload_blocks": 0, "restore_s": 0.0,
                 "restore_blocks": 0}
            if mb:
                arena, offload, restore = (b.kvtier.arena,
                                           b._offload_evicted,
                                           b._run_restore)

                def timed_offload(ev):
                    n0, t0 = arena.offloaded, time.perf_counter()
                    offload(ev)
                    t["offload_s"] += time.perf_counter() - t0
                    t["offload_blocks"] += arena.offloaded - n0

                def timed_restore(blocks, pages):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    restore(blocks, pages)
                    torch.cuda.synchronize()
                    t["restore_s"] += time.perf_counter() - t0
                    t["restore_blocks"] += len(blocks)
                b.pool.set_evict_hook(timed_offload)
                b._run_restore = timed_restore
            zero_counts(kernels)
            m0 = b.metrics.snapshot()
            w0 = time.perf_counter()
            first = [_serve_one(b, prompt, s, 7) for s in (False, True)]
            again = []
            for sampled, qs in ((False, pressure[:2]), (True, pressure[2:])):
                for q in qs:
                    _serve_one(b, q, False, 1)
                again.append(_serve_one(b, prompt, sampled, 7))
            wall = time.perf_counter() - w0
            m1 = b.metrics.snapshot()
            _add(total, read_counts(kernels))
            d = lambda k: m1["counters"].get(k, 0) - m0["counters"].get(  # noqa
                k, 0)
            passes = d("batcher_weight_passes")
            chunk_s = (m1["timings"]["batcher_decode_chunk"]["sum"]
                       - m0["timings"].get("batcher_decode_chunk",
                                           {}).get("sum", 0))
            for (toks, _), (toks2, cost) in zip(first, again):
                assert toks2 == toks, (mb, toks, toks2)
                if mb:
                    assert cost["prefill_cached_tokens"] > 0, cost
                    assert cost["arena_restored_bytes"] > 0, cost
            block_bytes = sum(lf[:, 0].nbytes for lf in b.paged.leaves())
            row = {"kv_host_mb": mb, "wall_s": wall, "weight_passes": passes,
                   "decode_chunk_ms_per_weight_pass": 1e3 * chunk_s / passes,
                   "wall_ms_per_weight_pass": 1e3 * wall / passes,
                   "evictions": d("radix_evictions") or b.pool.stats()[
                       "evictions"],
                   "restored_blocks": d("kvtier_restored_blocks"),
                   "offloaded_blocks": d("kvtier_offloaded_blocks"),
                   "cached_tokens_again": [c["prefill_cached_tokens"]
                                           for _, c in again],
                   "tokens_equal_first_serving": True}
            if mb:
                assert row["restored_blocks"] > 0 and \
                    row["offloaded_blocks"] > 0, row
                row["offload_gb_per_s"] = (t["offload_blocks"] * block_bytes
                                           / t["offload_s"] / 1e9)
                row["restore_ms_per_block"] = (1e3 * t["restore_s"]
                                               / t["restore_blocks"])
                row["block_bytes"] = block_bytes
                row["timing"] = t
            out["on" if mb else "off"] = row
            log("  tier", json.dumps(row))
            b.stop()
            del b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    return out, total


# the int8 arena's pages on the decode worker against the source's: each
# element within half a quantization step of its (layer, block, head)
# vector, amax/254, plus one bf16 step (2^-7 relative) of the value the
# dequantization rounds to bf16
INT8_PAGE_TOL = 2.0 ** -7


def _prefix_pages(torch, worker, cfg, text, nblocks):
    """The device pages ([L, nblocks, bs, Hkv, hd] f32, one per pool
    leaf) of ``text``'s first ``nblocks`` blocks in ``worker``'s pool,
    found through its radix cache (the match's references released)."""
    lm = worker.models[cfg.name]
    toks = lm.tokenizer.encode(text)
    b = lm.batcher
    blocks, _ = b.pool.match_prefix(toks[:nblocks * b.block_size])
    try:
        assert len(blocks) == nblocks, (len(blocks), nblocks)
        idx = torch.as_tensor(blocks, dtype=torch.long,
                              device=b.paged.k.device)
        return [lf.index_select(1, idx).float() for lf in b.paged.leaves()]
    finally:
        b.pool.release(blocks)


def _check_fetched_pages(torch, workers, cfg, text, fetched, want, kind):
    """The decode worker's restored pages against the prefill worker's
    native ones: the ``fetched`` blocks bitwise equal for a native
    arena, within INT8_PAGE_TOL's bound for an int8 one; a block that
    was recomputed (past a cut fetch) is only reported."""
    dec = _prefix_pages(torch, workers["decode"], cfg, text, want)
    src = _prefix_pages(torch, workers["prefill"], cfg, text, want)
    worst_ratio, tail_err, tail_amax = 0.0, 0.0, 0.0
    for d, s in zip(dec, src):
        df, sf = d[:, :fetched], s[:, :fetched]
        if kind == "int8_arena":
            # quantize_page's floor of a vector's scale: 1e-8 / 127
            amax = sf.abs().amax(dim=(2, 4), keepdim=True).clamp_min(1e-8)
            half = amax / 254
            err = (df - sf).abs()
            bound = half + INT8_PAGE_TOL * (sf.abs() + half)
            assert bool((err <= bound).all()), \
                f"int8 arena page error {float((err - bound).max())} " \
                "past its bound"
            worst_ratio = max(worst_ratio, float((err / half).max()))
        else:
            assert torch.equal(df, sf), f"{kind}: fetched pages differ"
        if fetched < want:
            tail_err = max(tail_err, float(
                (d[:, fetched:] - s[:, fetched:]).abs().max()))
            tail_amax = max(tail_amax, float(s[:, fetched:].abs().max()))
    del dec, src
    torch.cuda.empty_cache()
    return {"fetched_pages": ("within amax/254" if kind == "int8_arena"
                              else "bitwise equal"),
            "worst_err_in_half_steps": worst_ratio,
            "recomputed_block_max_abs_diff": tail_err,
            "recomputed_block_source_abs_max": tail_amax}


def _disagg_once(torch, bases, workers, cfg, text, kind):
    """One disaggregated request as the master runs it (a one-token
    kv_export pass on the prefill worker, then the request on the decode
    worker naming it as kv_source), beside the same request on the mixed
    worker. ``kind``: "native" (the prefill worker's arena native, the
    fetch cap raised), "int8_arena", or "default_cap" (native, the
    serving cap at its default: the stream is cut before its last block,
    which the decode worker recomputes)."""
    body = {"model_name": cfg.name, "prompt": text,
            "max_new_tokens": NEW_TOKENS, "seed": 5,
            "sampling": {"do_sample": False}}
    st, ref = _http(bases["mixed"] + "/inference", body)
    assert st == 200 and ref["status"] == "success", ref
    dec = workers["decode"].metrics
    src = workers["prefill"].metrics
    c0, s0 = dec.snapshot()["counters"], src.snapshot()["counters"]
    t0 = time.perf_counter()
    st, p1 = _http(bases["prefill"] + "/inference", dict(
        body, max_new_tokens=1, kv_export=True,
        request_tag=f"disagg.{kind}.p"))
    p1_ms = (time.perf_counter() - t0) * 1e3
    assert st == 200 and p1["status"] == "success", p1
    t0 = time.perf_counter()
    st, got = _http(bases["decode"] + "/inference", dict(
        body, kv_source={"url": bases["prefill"], "model": cfg.name}))
    call_ms = (time.perf_counter() - t0) * 1e3
    assert st == 200 and got["status"] == "success", got
    assert len(got["tokens"]) == NEW_TOKENS, got
    c1, s1 = dec.snapshot()["counters"], src.snapshot()["counters"]
    d = lambda c, a, k: c[k] - a.get(k, 0)  # noqa
    blocks = int(d(c1, c0, "kv_transfer_blocks"))
    nbytes = d(c1, c0, "kv_transfer_bytes")
    fetch_ms = d(c1, c0, "kv_transfer_ms")
    n = len(text) + 1                          # BOS + one token per byte
    want = (n - 1) // 16
    served = int(d(s1, s0, "kv_fetch_served_blocks"))
    assert d(s1, s0, "kv_fetch_missing_blocks") == 0
    assert served == blocks, (served, blocks)
    if kind == "default_cap":
        # the rest of the stream was cut (truncated), not missing
        assert 0 < blocks < want, (blocks, want)
    else:
        assert blocks == want, (blocks, n)
    assert d(c1, c0, "kv_transfer_failures") == 0
    assert got["cost"]["prefill_cached_tokens"] == blocks * 16, got["cost"]
    pages = _check_fetched_pages(torch, workers, cfg, text, blocks, want,
                                 kind)
    equal = got["tokens"] == ref["tokens"]
    if kind == "native":
        assert equal and got["result"] == ref["result"], (got, ref)
    row = {"prompt_tokens": n, "blocks": blocks, "truncated": want - blocks,
           "wire_bytes": nbytes,
           "served_bytes": d(s1, s0, "kv_fetch_served_bytes"),
           "raw_bytes": d(s1, s0, "kv_wire_raw_bytes"),
           "fetch_ms": fetch_ms, "fetch_mb_per_s": nbytes / fetch_ms / 1e3,
           "prefill_call_ms": p1_ms, "decode_call_ms": call_ms,
           "decode_ttft_ms_after_fetch": got["ttft_ms"],
           "ttft_disagg_ms": p1_ms + fetch_ms + got["ttft_ms"],
           "ttft_recompute_ms": ref["ttft_ms"],
           "pages": pages, "tokens_equal": equal,
           "tokens_agree": sum(a == b for a, b in zip(got["tokens"],
                                                      ref["tokens"]))}
    log(f"  disagg ({kind})", json.dumps(row))
    return row


def _kv_disagg(torch, kernels, cfg):
    """(d): three workers in this process (prefill, decode, mixed), each
    loading llama-3-8b batched; the decode route fused. The prompt's 128
    bf16 blocks make 268.5 MB of frames, past the 256 MiB default cap of
    one /kv_fetch (DLI_KV_FETCH_MAX_MB, both ends): the phase serves one
    prompt at the default cap (the stream cut, the last block
    recomputed), then raises the cap to KV_FETCH_MB."""
    from distributed_llm_inferencing_tpu_torch.runtime import (
        worker as worker_mod)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    workers, bases = {}, {}
    os.environ["DLI_FUSED_DECODE"] = "1"
    os.environ["DLI_KV_FETCH_MAX_MB"] = str(KV_FETCH_MB)   # the client's
    cap = worker_mod.KV_FETCH_MAX_MB
    zero_counts(kernels)
    try:
        for role in ("prefill", "decode", "mixed"):
            w = workers[role] = WorkerAgent(device="cuda", role=role)
            w.serve("127.0.0.1", 0, background=True)
            bases[role] = f"http://127.0.0.1:{w.service.port}"
            st, res = _http(bases[role] + "/load_model", DISAGG_LOAD)
            assert st == 200 and res["status"] == "success", res
            st, h = _http(bases[role] + "/health")
            assert h["role"] == role and h["arena_occupancy"] is not None, h
        # the server's cap at its default; the client's, raised, is not
        # reached by a stream the server cut
        out = {"default_cap": _disagg_once(
            torch, bases, workers, cfg, engine_prompt(TIER_PROMPT, 7),
            "default_cap")}
        worker_mod.KV_FETCH_MAX_MB = KV_FETCH_MB               # the server's
        out["native"] = _disagg_once(torch, bases, workers, cfg,
                                     engine_prompt(TIER_PROMPT, 5), "native")
        # the prefill worker again with an int8 arena (the same seeded
        # weights: the load draws them from the same seed)
        os.environ["DLI_KV_HOST_DTYPE"] = "int8"
        st, _ = _http(bases["prefill"] + "/unload_model",
                      {"model_name": cfg.name})
        assert st == 200
        st, res = _http(bases["prefill"] + "/load_model", DISAGG_LOAD)
        assert st == 200 and res["status"] == "success", res
        os.environ.pop("DLI_KV_HOST_DTYPE")
        assert workers["prefill"].models[cfg.name].batcher.kvtier.arena \
            .dtype == "int8"
        out["int8_arena"] = _disagg_once(torch, bases, workers, cfg,
                                         engine_prompt(TIER_PROMPT, 6),
                                         "int8_arena")
        out["int8_wire_ratio"] = (
            out["int8_arena"]["wire_bytes"] / out["int8_arena"]["blocks"]
            / (out["native"]["wire_bytes"] / out["native"]["blocks"]))
        assert out["int8_wire_ratio"] < 0.55, out["int8_wire_ratio"]
        launches = read_counts(kernels)
        assert launches["fused_decode_step"] > 0 and \
            launches["paged_flash_decode"] == 0, launches
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        os.environ.pop("DLI_KV_HOST_DTYPE", None)
        os.environ.pop("DLI_KV_FETCH_MAX_MB", None)
        worker_mod.KV_FETCH_MAX_MB = cap
        for w in workers.values():
            w.shutdown()
    log(f"  int8 arena's wire bytes per block / native: "
        f"{out['int8_wire_ratio']:.4f}")
    return out, launches


def phase_kv_plane(torch, fa, qm, kernels, smi):
    """Phase 17 (see the module docstring): (a) the int8 KV cache in
    engine mode and its card-vs-host check; (b) the int8 paged pool; (c)
    the host tier; (d) disaggregation and its int8 wire."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    cfg = get_config("llama-3-8b")
    report, total = {"smi": smi}, {}
    t0 = time.perf_counter()
    report["engine"], launches = _kv_engine(torch, kernels, cfg)
    _add(total, launches)
    report["cross_check_max_abs_err"] = phase_cross_check(
        torch, fa, qm, name="llama-3-8b int8-kv",
        cfg=cfg.replace(kv_quant="int8"), routes=("paged",))
    report["seconds_engine"] = time.perf_counter() - t0
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    t0 = time.perf_counter()
    report["batched"], launches = _kv_batched(torch, kernels, cfg, params)
    _add(total, launches)
    report["seconds_batched"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["tier"], launches = _kv_tier(torch, kernels, cfg, params)
    _add(total, launches)
    report["seconds_tier"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["disagg"], launches = _kv_disagg(torch, kernels, cfg)
    _add(total, launches)
    report["seconds_disagg"] = time.perf_counter() - t0
    report["launches"] = total
    log("  kv plane launches:", json.dumps(total))
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase17.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


# ---------------------------------------------------------------------
# phase 18: speculation, overlapped dispatch, live migration
# ---------------------------------------------------------------------

# (a)/(b) the drafts per verify pass; (a) the engine's new tokens and its
# prompt lengths (a repetitive and a random prompt at each)
SPEC_GAMMA, SPEC_NEW, SPEC_LENS = 4, 64, (300, 900)
# (b) the wave's speculation settings, one load each: (DLI_SPEC_WAVE,
# DLI_SPEC_ADAPTIVE); the first also runs with graphs off on a fresh load
SPEC_MODES = (("wave", "1", "0"), ("wave_adaptive", "1", "1"),
              ("global", "0", "0"), ("global_adaptive", "0", "1"))
# (c) full occupancy: 8 slots, chunks of 16 (three overlapped pairs per
# request), 128 new tokens
OVERLAP_CAP, OVERLAP_NEW = 16, 128
# (d) a 1500-token prompt generating 256 tokens, migrated once it has
# emitted MIGRATE_AT; two port workers on the card
MIGRATE_PROMPT, MIGRATE_NEW, MIGRATE_AT = 1500, 256, 64
MIGRATE_LOAD = dict(BATCHED_LOAD, slots=2, kv_blocks=512, kv_host_mb=1024)


# every launch counted in phase 18, banked before each zeroing of the counts
_PHASE18_LAUNCHES: dict = {}


def _bank(kernels):
    """Add the counts so far to phase 18's total, then zero them."""
    _add(_PHASE18_LAUNCHES, read_counts(kernels))
    zero_counts(kernels)


def _spec_prompts(cfg, lens=SPEC_LENS, seed=18):
    """A repetitive prompt (a 24-token phrase repeated) and a random one
    at each length of ``lens``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        phrase = rng.integers(1, cfg.vocab_size, 24).tolist()
        out.append((phrase * (n // 24 + 1))[:n])
        out.append(rng.integers(1, cfg.vocab_size, n).tolist())
    return out


def _spec_engine(torch, kernels):
    """(a) The engine's verify step: at 2 layers in f32, its logits on
    the card against the host's and its greedy tokens against plain
    decode's (asserted); at full depth in bf16, four prompts of 64 new
    tokens, speculative (graphs on and off: equal tokens, asserted) and
    plain, with the verify steps' tokens per pass, ms per emitted token
    and greedy agreement reported."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    greedy = SamplingParams.greedy()
    full = get_config("llama-3-8b").replace(num_layers=SPEC_LAYERS)
    cfg = full.replace(num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    g = torch.Generator().manual_seed(18)
    toks = torch.randint(1, cfg.vocab_size, (1, 40), generator=g)
    drafts = torch.randint(1, cfg.vocab_size, (1, SPEC_GAMMA + 1),
                           generator=g)
    logits = {}
    _bank(kernels)
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            model = Transformer(cfg, params if dev == "cuda" else
                                {k: t.cpu() for k, t in params.items()})
            cache = init_cache(cfg, 1, 96, device=dev)
            lens = torch.tensor([40], dtype=torch.int32, device=dev)
            _, cache = model.prefill(toks.to(dev), lens, cache)
            q_pos = lens.long()[:, None] + torch.arange(SPEC_GAMMA + 1,
                                                        device=dev)
            lg, _ = model.forward(drafts.to(dev), cache, lens, q_pos,
                                  lens + SPEC_GAMMA + 1)
            logits[dev] = lg[0].cpu()
            del model, cache
    counts = read_counts(kernels)
    assert counts["flash_attention"] == cfg.num_layers and \
        counts["flash_decode"] == 0, counts
    out = {"verify_max_abs_err": _xcheck(
        torch, "verify (5 query rows)", logits["cuda"], logits["cpu"])}
    os.environ["DLI_SPEC_ADAPTIVE"] = "0"
    try:
        eng = InferenceEngine(cfg, params, max_seq=256, device="cuda")
        agree = []
        for p in _spec_prompts(cfg, (40,)):
            plain = eng.generate([p], 48, greedy).tokens
            spec = eng.generate([p], 48, greedy, speculative="ngram",
                                spec_gamma=SPEC_GAMMA).tokens
            assert spec == plain, "2-layer f32: speculative tokens differ"
            agree.append(len(spec[0]))
        eng.close()
        out["f32_greedy_equal_tokens"] = agree
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        eng = InferenceEngine(full, max_seq=2048, device="cuda", seed=0)
        L = full.num_layers
        prompts = _spec_prompts(full)
        # the plain step's and the verify step's captures, outside the
        # timed requests
        eng.generate([prompts[0][:64]], 8, greedy)
        eng.generate([prompts[0][:64]], 8, greedy, speculative="ngram",
                     spec_gamma=SPEC_GAMMA)
        rows = []
        for i, p in enumerate(prompts):
            _bank(kernels)
            plain = eng.generate([p], SPEC_NEW, greedy)
            c_plain = read_counts(kernels)
            _bank(kernels)
            spec = eng.generate([p], SPEC_NEW, greedy, speculative="ngram",
                                spec_gamma=SPEC_GAMMA)
            c_spec = read_counts(kernels)
            assert c_plain["flash_decode"] == L * (plain.steps - 1), c_plain
            # a verify step launches no decode kernel: the prefill alone
            assert c_spec["flash_attention"] == L and \
                c_spec["flash_decode"] == 0, c_spec
            os.environ["DLI_CUDA_GRAPHS"] = "0"
            try:
                eager = eng.generate([p], SPEC_NEW, greedy,
                                     speculative="ngram",
                                     spec_gamma=SPEC_GAMMA)
            finally:
                os.environ.pop("DLI_CUDA_GRAPHS")
            assert eager.tokens == spec.tokens, \
                "verify step: graphs on and off disagree"
            n = len(spec.tokens[0])
            pt, st = plain.tokens[0], spec.tokens[0]
            rows.append({
                "prompt_tokens": len(p),
                "repetitive": i % 2 == 0,
                "new_tokens": n,
                "verify_steps": spec.steps - 1,
                "tokens_per_verify_step": (n - 1) / max(1, spec.steps - 1),
                "ms_per_token_spec": spec.decode_ms / max(1, n - 1),
                "ms_per_token_plain": plain.decode_ms / max(1, len(pt) - 1),
                "ms_per_verify_step": spec.decode_ms / max(1,
                                                           spec.steps - 1),
                "greedy_agree_with_plain": sum(
                    a == b for a, b in zip(pt, st)),
                "greedy_equal_prefix": next(
                    (j for j, (a, b) in enumerate(zip(pt, st)) if a != b),
                    min(len(pt), len(st)))})
            log("  engine spec", json.dumps(rows[-1]))
        out["bf16_full_depth"] = rows
        eng.close()
    finally:
        os.environ.pop("DLI_SPEC_ADAPTIVE", None)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _spec_bodies(cfg):
    """Phase 5's eight bodies plus two repetitive greedy ones."""
    bodies = _batched_bodies(cfg)
    for i, p in enumerate(_spec_prompts(cfg, (400, 800), seed=19)[::2]):
        bodies.append({"model_name": cfg.name, "prompt_tokens": p,
                       "max_new_tokens": NEW_TOKENS, "seed": 200 + i,
                       "sampling": {"do_sample": False}})
    return bodies


def _spec_wave_pass(torch, base, worker, kernels, cfg, mode, wave, adaptive,
                    graphs_on=True):
    """One load with ``speculative`` on (``DLI_SPEC_WAVE``/``_ADAPTIVE``
    as given) and the ten bodies served as one /inference_batch on the
    paged route.
    Asserted: every speculative chunk launches no decode kernel (counted
    around each chunk), and paged_flash_decode launches num_layers per
    plain weight pass. Reported: tokens per weight pass, ms per verify
    iteration and per plain pass, the spec_wave_* counters."""
    L = cfg.num_layers
    os.environ.update(DLI_SPEC_WAVE=wave, DLI_SPEC_ADAPTIVE=adaptive,
                      DLI_CUDA_GRAPHS="1" if graphs_on else "0")
    load = dict(BATCHED_LOAD, model_name=cfg.name, speculative="ngram",
                spec_gamma=SPEC_GAMMA)
    st, res = _http(base + "/load_model", load)
    assert st == 200 and res["status"] == "success", res
    b = worker.models[cfg.name].batcher
    assert b.spec_wave == (wave == "1"), b.stats()
    spec = {"chunks": 0, "iterations": 0, "s": 0.0, "inside": 0}
    run = b._run_spec_decode
    names = ("paged_flash_decode", "fused_decode_step", "flash_decode",
             "flash_attention")

    def counted(a):
        c0 = read_counts(kernels)
        t0 = time.perf_counter()
        out = run(a)
        spec["s"] += time.perf_counter() - t0
        c1 = read_counts(kernels)
        spec["inside"] += sum(c1[k] - c0[k] for k in names)
        spec["chunks"] += 1
        spec["iterations"] += int(a["k"])
        return out

    b._run_spec_decode = counted
    captured = b.stats()["decode_graphs_captured"]
    bodies = [dict(x, request_tag=f"p18-{mode}-{graphs_on}-{i}")
              for i, x in enumerate(_spec_bodies(cfg))]
    s0 = worker.metrics.snapshot()
    _bank(kernels)
    t0 = time.perf_counter()
    # one enqueue in wire order: the admission waves (and so the bits of
    # their rows) do not depend on arrival times
    lines = _stream_lines(base + "/inference_batch",
                          {"model_name": cfg.name, "requests": bodies}, None)
    wall = time.perf_counter() - t0
    msgs = {m["request_tag"]: m for m in map(json.loads,
                                             (x for _, x in lines))}
    got = [(msgs[x["request_tag"]]["status"], msgs[x["request_tag"]]["body"])
           for x in bodies]
    launches = read_counts(kernels)
    s1 = worker.metrics.snapshot()
    d = lambda k: s1["counters"].get(k, 0) - s0["counters"].get(k, 0)  # noqa
    passes, emitted = d("batcher_weight_passes"), d("batcher_tokens_emitted")
    chunk_s = (s1["timings"]["batcher_decode_chunk"]["sum"]
               - s0["timings"].get("batcher_decode_chunk", {}).get("sum", 0))
    tokens = []
    for body, (code, r) in zip(bodies, got):
        assert code == 200 and r["status"] == "success", r
        assert 1 <= len(r["tokens"]) <= NEW_TOKENS, r
        tokens.append(r["tokens"])
    assert spec["inside"] == 0, \
        f"a speculative chunk launched {spec['inside']} decode kernels"
    plain_passes = passes - spec["iterations"]
    for k in names:
        want = L * plain_passes if k == "paged_flash_decode" else 0
        assert launches[k] == want, \
            f"{mode}: {k} launches {launches[k]} != {want} " \
            f"({plain_passes} plain passes of {passes})"
    if adaptive == "0":
        assert plain_passes == 0 and spec["chunks"] > 0, (passes, spec)
    plain_s = chunk_s - spec["s"]
    row = {"mode": mode, "graphs": graphs_on, "wall_s": wall,
           "programs_captured_at_load": captured,
           "weight_passes": passes, "spec_iterations": spec["iterations"],
           "spec_chunks": spec["chunks"],
           "decode_tokens_per_weight_pass": emitted / passes,
           "ms_per_verify_iteration": (1e3 * spec["s"]
                                       / max(1, spec["iterations"])),
           "ms_per_plain_pass": (1e3 * plain_s / plain_passes
                                 if plain_passes else None),
           "spec_accepted_tokens": b.stats()["spec_accepted_tokens"],
           "spec_wave": b.stats()["spec_wave"],
           "spec_adaptive": b.stats()["spec_adaptive"],
           "counters": {k: d(k) for k in (
               "spec_wave_dispatches", "spec_wave_drafted_tokens",
               "spec_wave_accepted_tokens", "spec_wave_plain_rides")},
           "launches": launches}
    log("  spec wave", json.dumps(row))
    del b._run_spec_decode, b, run, counted
    st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
    assert st == 200
    return row, tokens


def _spec_batched(torch, kernels, cfg):
    """(b) The batched speculative chunk through the worker: the four
    SPEC_MODES, then the first again with graphs off (equal tokens)."""
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    rows, toks = [], {}
    os.environ["DLI_FUSED_DECODE"] = "0"
    try:
        for mode, wave, adaptive in SPEC_MODES:
            row, toks[mode] = _spec_wave_pass(torch, base, worker, kernels,
                                              cfg, mode, wave, adaptive)
            rows.append(row)
        mode, wave, adaptive = SPEC_MODES[0]
        row, eager = _spec_wave_pass(torch, base, worker, kernels, cfg,
                                     mode, wave, adaptive, graphs_on=False)
        rows.append(row)
        assert eager == toks[mode], \
            "speculative chunk: graphs on and off disagree"
    finally:
        for k in ("DLI_FUSED_DECODE", "DLI_SPEC_WAVE", "DLI_SPEC_ADAPTIVE",
                  "DLI_CUDA_GRAPHS"):
            os.environ.pop(k, None)
        worker.shutdown()
    greedy = [i for i, b in enumerate(_spec_bodies(cfg))
              if b["sampling"].get("do_sample") is False]
    first = toks[SPEC_MODES[0][0]]
    agree = {m: [sum(a == b for i in greedy
                     for a, b in zip(first[i], t[i])),
                 sum(len(first[i]) for i in greedy)]
             for m, t in toks.items()}
    log("  greedy tokens equal to the wave mode's:", json.dumps(agree))
    gc.collect()
    torch.cuda.empty_cache()
    return {"modes": rows, "greedy_agree_with_wave": agree}


def _overlap(torch, kernels, cfg):
    """(c) Overlapped dispatch at full occupancy: 8 requests (phase 5's
    prompts, no eos, greedy and sampled) on 8 slots, chunks capped at
    OVERLAP_CAP, with ``decode_overlap`` off and on over one batcher:
    equal tokens, overlapped pairs > 0, exact paged launches."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    L = cfg.num_layers
    os.environ["DLI_FUSED_DECODE"] = "0"
    try:
        b = ContinuousBatcher(cfg, None, num_blocks=1024, block_size=16,
                              slots=8, max_seq=4096, seed=0, device="cuda",
                              decode_chunk_cap=OVERLAP_CAP)
        b.warm_decode_programs()
        bodies = _batched_bodies(cfg)
        out = {}
        for on in (False, True, False):
            b.decode_overlap = on
            m0 = b.metrics.snapshot()
            _bank(kernels)
            reqs = [b.submit(x["prompt_tokens"], OVERLAP_NEW,
                             SamplingParams(**x["sampling"]),
                             seed=x["seed"]) for x in bodies]
            # all admitted in one wave: queue empty, every slot live
            while not all(r.done.is_set() for r in reqs):
                b.step()
            m1 = b.metrics.snapshot()
            d = lambda k: m1["counters"].get(k, 0) - \
                m0["counters"].get(k, 0)  # noqa
            passes = d("batcher_weight_passes")
            launches = read_counts(kernels)
            assert launches["paged_flash_decode"] == L * passes, launches
            chunk_s = (m1["timings"]["batcher_decode_chunk"]["sum"]
                       - m0["timings"].get("batcher_decode_chunk",
                                           {}).get("sum", 0))
            row = {"overlap": on, "weight_passes": passes,
                   "overlapped_dispatches": d(
                       "batcher_overlapped_dispatches"),
                   "ms_per_pass": 1e3 * chunk_s / passes,
                   "tokens": [r.wait() for r in reqs]}
            out.setdefault(on, []).append(row)
        b.stop()
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    # the first run admits cold, the next two over the prompts' cached
    # blocks (an admission's bits depend on its rows): on against the
    # second off, asserted; against the first, reported
    cold, on, off = out[False][0], out[True][0], out[False][1]
    assert on["tokens"] == off["tokens"], \
        "overlapped dispatch changed the tokens"
    assert on["overlapped_dispatches"] > 0 and \
        off["overlapped_dispatches"] == cold["overlapped_dispatches"] == 0
    rows = [dict({k: v for k, v in r.items() if k != "tokens"},
                 tokens_equal_cold=r["tokens"] == cold["tokens"])
            for r in (cold, on, off)]
    for r in rows:
        log("  overlap", json.dumps(r))
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _wait_tokens(worker, tag, n, timeout=300.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        req = worker._tagged.get(tag)
        if req is not None and len(req.tokens) >= n:
            return req
        time.sleep(0.002)
    raise AssertionError(f"{tag} never reached {n} tokens")


def _migrate_once(torch, bases, workers, cfg, prompt, seed, tag):
    """One request on the source worker, migrated with /migrate_out once
    it has emitted MIGRATE_AT tokens: its dispatch answers 303 with the
    resume record. Returns the record."""
    body = {"model_name": cfg.name, "prompt_tokens": prompt,
            "max_new_tokens": MIGRATE_NEW, "seed": seed,
            "sampling": {"do_sample": False}, "request_tag": tag}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_http, bases["src"] + "/inference", body)
        _wait_tokens(workers["src"], tag, MIGRATE_AT)
        st, r = _http(bases["src"] + "/migrate_out",
                      {"request_tag": tag, "model_name": cfg.name})
        assert st == 200 and r["status"] == "success", r
        st, res = fut.result()
    assert st == 303 and res["status"] == "migrated", res
    rec = res["resume"]
    assert MIGRATE_AT <= len(rec["tokens"]) < MIGRATE_NEW, len(rec["tokens"])
    assert rec["prompt_tokens"] == prompt and rec["seed"] == seed
    return rec


def _restored_pages_equal(torch, src_b, dst_b, seq, nblocks):
    """The destination's pool pages of ``seq``'s first ``nblocks`` blocks
    (found through its radix) bitwise against the source's exported
    arena pages, the bytes that crossed the wire."""
    from distributed_llm_inferencing_tpu_torch.ops import (
        kvblock_quant as kvq)
    bs = dst_b.block_size
    digs = src_b.kvtier.block_digests(seq[:nblocks * bs])
    blocks, _ = dst_b.pool.match_prefix(seq[:nblocks * bs])
    try:
        assert len(blocks) == nblocks, (len(blocks), nblocks)
        idx = torch.as_tensor(blocks, dtype=torch.long,
                              device=dst_b.paged.k.device)
        for j, lf in enumerate(dst_b.paged.leaves()):
            got = lf.index_select(1, idx).transpose(0, 1).cpu()
            want = torch.stack([kvq.to_torch(
                src_b.kvtier.arena.peek_pages(d)[j]) for d in digs])
            assert torch.equal(got, want), "restored pages differ"
    finally:
        dst_b.pool.release(blocks)


def _migration(torch, kernels, cfg):
    """(d) Live migration between two port workers on the card, the
    master's calls made by hand (tests/test_torch_e2e_master.py drives
    the unchanged master): /migrate_out on the source mid-stream, the
    303's resume record re-dispatched to the destination with the source
    as kv_source (the master's body, JAX runtime/master.py:2697-2711):
    no token lost or repeated, the fetched pages bitwise equal to the
    source's export, greedy agreement with an undisturbed run reported.
    Then two more migrations resumed straight into the destination's
    batcher with kv_source (its receive-overlapped restore), with the
    overlap on and off: their TTFTs reported."""
    import numpy as np
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    workers, bases = {}, {}
    os.environ["DLI_FUSED_DECODE"] = "1"
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, cfg.vocab_size, MIGRATE_PROMPT).tolist()
               for _ in range(3)]
    out = {}
    try:
        for role in ("src", "dst"):
            w = workers[role] = WorkerAgent(device="cuda")
            w.serve("127.0.0.1", 0, background=True)
            bases[role] = f"http://127.0.0.1:{w.service.port}"
            st, res = _http(bases[role] + "/load_model",
                            dict(MIGRATE_LOAD, model_name=cfg.name))
            assert st == 200 and res["status"] == "success", res
        src_b = workers["src"].models[cfg.name].batcher
        dst_b = workers["dst"].models[cfg.name].batcher
        _bank(kernels)
        rec = _migrate_once(torch, bases, workers, cfg, prompts[0], 31,
                            "mig.0")
        c0 = dst_b.metrics.snapshot()["counters"]
        t0 = time.perf_counter()
        st, got = _http(bases["dst"] + "/inference", {
            "model_name": cfg.name, "prompt_tokens": prompts[0],
            "max_new_tokens": MIGRATE_NEW, "seed": 31,
            "sampling": {"do_sample": False}, "resume": rec,
            "kv_source": {"url": bases["src"], "model": cfg.name}})
        call_ms = (time.perf_counter() - t0) * 1e3
        assert st == 200 and got["status"] == "success", got
        c1 = dst_b.metrics.snapshot()["counters"]
        toks, n0 = got["tokens"], len(rec["tokens"])
        # the record is the stream's cursor: nothing repeated, nothing lost
        assert toks[:n0] == rec["tokens"], "resume re-emitted other tokens"
        assert len(toks) == MIGRATE_NEW or (
            toks and toks[-1] != workers["dst"].models[cfg.name]
            .tokenizer.eos_token_id), len(toks)
        blocks = int(c1["kv_transfer_blocks"] - c0.get(
            "kv_transfer_blocks", 0))
        n_ctx = MIGRATE_PROMPT + n0 - 1      # KV on the source's device
        assert blocks == n_ctx // 16, (blocks, n_ctx)
        _restored_pages_equal(torch, src_b, dst_b, prompts[0] + rec["tokens"],
                              blocks)
        st, ref = _http(bases["src"] + "/inference", {
            "model_name": cfg.name, "prompt_tokens": prompts[0],
            "max_new_tokens": MIGRATE_NEW, "seed": 31,
            "sampling": {"do_sample": False}})
        assert st == 200, ref
        agree = sum(a == b for a, b in zip(toks, ref["tokens"]))
        out["worker"] = {
            "resume_tokens": n0, "new_tokens": len(toks) - n0,
            "fetched_blocks": blocks, "fetched_pages": "bitwise equal",
            "destination_call_ms": call_ms,
            "destination_ttft_ms": got["ttft_ms"],
            "kv_transfer_ms": c1["kv_transfer_ms"] - c0.get(
                "kv_transfer_ms", 0),
            "greedy_agree_with_undisturbed": [agree, len(ref["tokens"])],
            "duplicated_tokens": 0, "lost_tokens": 0}
        log("  migration (worker)", json.dumps(out["worker"]))
        # the receive-overlapped restore: a batcher user's kv_source
        sp = SamplingParams.greedy()
        for i, on in ((1, True), (2, False)):
            rec = _migrate_once(torch, bases, workers, cfg, prompts[i],
                                40 + i, f"mig.{i}")
            dst_b._wire_overlap = on
            c0 = dst_b.metrics.snapshot()
            req = dst_b.submit(prompts[i], MIGRATE_NEW, sp, resume=rec,
                               kv_source={"url": bases["src"],
                                          "model": cfg.name})
            toks = req.wait(timeout=600)
            c1 = dst_b.metrics.snapshot()
            n0 = len(rec["tokens"])
            assert toks[:n0] == rec["tokens"]
            blocks = int(c1["counters"]["kv_transfer_blocks"]
                         - c0["counters"].get("kv_transfer_blocks", 0))
            assert blocks == (MIGRATE_PROMPT + n0 - 1) // 16, blocks
            _restored_pages_equal(torch, src_b, dst_b,
                                  prompts[i] + rec["tokens"], blocks)
            row = {"receive_overlap": on, "resume_tokens": n0,
                   "fetched_blocks": blocks, "ttft_ms": req.ttft_ms,
                   "kv_transfer_ms": c1["counters"]["kv_transfer_ms"]
                   - c0["counters"].get("kv_transfer_ms", 0),
                   # the gauge moves on an overlapped fetch only
                   "overlap_ratio": (c1["gauges"].get(
                       "kv_restore_overlap_ratio") if on else None)}
            out[f"restore_overlap_{'on' if on else 'off'}"] = row
            log("  migration (batcher kv_source)", json.dumps(row))
        out["launches"] = read_counts(kernels)
        assert out["launches"]["fused_decode_step"] > 0
        assert workers["src"].metrics.snapshot()["counters"][
            "requests_migrated_out"] == 3
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        for w in workers.values():
            w.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_spec_migrate(torch, kernels, smi):
    """Phase 18 (see the module docstring): (a) the engine's verify step;
    (b) the batcher's speculative chunk through the worker; (c)
    overlapped dispatch; (d) live migration."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config, register)
    cfg = register(get_config("llama-3-8b").replace(
        name=f"llama-3-8b-{SPEC_LAYERS}-layers", num_layers=SPEC_LAYERS))
    log(f"  llama-3-8b: DEPTH CUT to {SPEC_LAYERS} of 32 layers")
    report, t_all = {"smi": smi}, time.perf_counter()
    _PHASE18_LAUNCHES.clear()
    zero_counts(kernels)
    for key, fn in (("engine", lambda: _spec_engine(torch, kernels)),
                    ("batched", lambda: _spec_batched(torch, kernels, cfg)),
                    ("overlap", lambda: _overlap(torch, kernels, cfg)),
                    ("migration", lambda: _migration(torch, kernels, cfg))):
        t0 = time.perf_counter()
        report[key] = fn()
        report[f"seconds_{key}"] = time.perf_counter() - t0
    _bank(kernels)
    report["launches"] = dict(_PHASE18_LAUNCHES)
    log("  phase 18 launches:", json.dumps(report["launches"]))
    report["seconds"] = time.perf_counter() - t_all
    log(f"  phase 18 wall time: {report['seconds']:.1f} s", json.dumps(
        {k: round(v, 1) for k, v in report.items()
         if k.startswith("seconds_")}))
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase18.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


# ---------------------------------------------------------------------
# phase 19: multi-LoRA serving and the experts behind the softmax router
# ---------------------------------------------------------------------

# three rank-16 adapters of llama-3-8b (167.8 MB each in f32); the host
# store's default 64 MB holds none of them, and two device slots make the
# third adapter evict one in place
LORA_SOURCES = {f"a{i}": f"synth:rank=16,seed={i},scale=0.8"
                for i in (1, 2, 3)}
LORA_ENV = {"DLI_LORA_HOST_MB": "1024", "DLI_LORA_SLOTS": "2",
            "DLI_LORA_MAX_RANK": "16", "DLI_DECODE_OVERLAP": "0",
            "DLI_FUSED_DECODE": "1"}
# (b) mixtral-8x7b's 2-layer f32 cross-check: (dispatch, rows, prompt
# tokens), runs of one token so that positions route alike and capacity
# dispatch drops choices; the host runs every expert of every token in
# the dense mode, so its prompt is short
MOE_XCHECK = (("dense", 1, 16), ("capacity", 2, 64))
MIXTRAL_LOAD = {"model_name": "mixtral-8x7b", "allow_random_init": True,
                "dtype": "bfloat16", "quantize": "int8", "max_seq": 4096}
MOE_BATCHED = {"serving": "batched", "slots": 4, "kv_blocks": 512,
               "kv_block_size": 16}
MOE_NEW = 16
# engine requests of (b): (prompt tokens in runs, sampling, seed)
MOE_REQUESTS = ((200, {"do_sample": False}, 0), (100, {}, 1))

# every launch counted in phase 19, banked before each zeroing
_PHASE19_LAUNCHES: dict = {}


def _bank19(kernels):
    _add(_PHASE19_LAUNCHES, read_counts(kernels))
    zero_counts(kernels)


class _Env:
    """Environment variables set for a block, restored after it."""

    def __init__(self, **kw):
        self.kw, self.old = kw, {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _runs_prompt(cfg, n, seed):
    """``n`` tokens in runs of one token (positions route alike)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        out += [int(rng.integers(1, cfg.vocab_size))] * int(
            rng.integers(8, 24))
    return out[:n]


def _counted_wave(base, worker, kernels, name, bodies, cfg, fused,
                  quiet=False, bank=None):
    """``bodies`` as one /inference_batch (one enqueue, wire order) on a
    loaded batched model, each decode chunk counted: a chunk with an
    adapter row must launch paged_flash_decode num_layers times per pass
    and no fused_decode_step; a base-only one the route's kernel
    (``fused``: the fused kernel) num_layers times per pass; nothing
    else launches (``quiet``: nothing at all, the gather route of sinks
    and latent attention). ``bank`` (default ``_bank19``) files the
    counts. Returns (tokens, launches, timing)."""
    bank = bank or _bank19
    import numpy as np
    L = cfg.num_layers
    b = worker.models[name].batcher
    run = b._run_decode
    acc = {"lora": [0, 0.0], "base": [0, 0.0], "bad": []}

    def counted(a):
        lora = bool(np.any(a["aids"]))
        k = int(a["k"])
        c0 = read_counts(kernels)
        t0 = time.perf_counter()
        out = run(a)
        dt = time.perf_counter() - t0
        c1 = read_counts(kernels)
        d = {x: c1[x] - c0[x] for x in c1 if c1[x] != c0[x]}
        kern = ("fused_decode_step" if fused and not lora
                else "paged_flash_decode")
        if d != ({} if quiet else {kern: L * k}):
            acc["bad"].append((lora, k, d))
        acc["lora" if lora else "base"][0] += k
        acc["lora" if lora else "base"][1] += dt
        return out

    b._run_decode = counted
    bank(kernels)
    try:
        lines = _stream_lines(base + "/inference_batch",
                              {"model_name": name, "requests": bodies}, None)
    finally:
        del b._run_decode
    launches = read_counts(kernels)
    bank(kernels)
    msgs = {m["request_tag"]: m for m in map(json.loads,
                                             (x for _, x in lines))}
    tokens = []
    for body in bodies:
        m = msgs[body["request_tag"]]
        assert m["status"] == 200 and m["body"]["status"] == "success", m
        tokens.append(m["body"]["tokens"])
    assert not acc["bad"], f"{name}: chunk launches {acc['bad'][:3]}"
    timing = {f"ms_per_pass_{k}": (1e3 * acc[k][1] / acc[k][0]
                                   if acc[k][0] else None)
              for k in ("lora", "base")}
    timing.update(passes_lora=acc["lora"][0], passes_base=acc["base"][0])
    return tokens, launches, timing


def _lora_bodies(cfg, adapters, tag):
    """Phase 5's eight bodies (greedy and sampled, two sharing a
    512-token prefix) at 16 new tokens, each given the adapter of
    ``adapters`` at its index (None: the base model)."""
    return [dict(body, request_tag=f"p19-{tag}-{i}", max_new_tokens=16,
                 **({"adapter": adapters[i % len(adapters)]}
                    if adapters[i % len(adapters)] else {}))
            for i, body in enumerate(_batched_bodies(cfg))]


def _lora_batched(torch, kernels, cfg, quant=None):
    """(a) Batched: a load, the three adapters over /load_adapter, then
    wave 0 (the eight bodies on base weights), wave 1 (base, a1 and a2
    rows mixed), wave 2 (a3 and a1: a3 evicts a2 from its device slot in
    place, so the captured lora program replays over rewritten pack
    rows); the same load and waves 1-2 with graphs off give the same
    tokens. Exact launches per chunk (``_counted_wave``)."""
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    waves = {"mixed": (None, "a1", "a2"), "evict": ("a3", "a1")}
    out, tokens = {}, {}
    for on in (True, False):
        _graphs_on(on)
        worker = WorkerAgent(device="cuda")
        worker.serve("127.0.0.1", 0, background=True)
        base = _worker_base(worker)
        try:
            load = dict(BATCHED_LOAD, **({"quantize": quant} if quant
                                         else {}))
            st, res = _http(base + "/load_model", load)
            assert st == 200 and res["status"] == "success", res
            for name, src in LORA_SOURCES.items():
                st, r = _http(base + "/load_adapter", {
                    "model_name": cfg.name, "adapter": name, "source": src})
                assert st == 200 and r["rank"] == 16, r
            for wave, ads in [("base", (None,))] + list(waves.items()):
                toks, launches, timing = _counted_wave(
                    base, worker, kernels, cfg.name,
                    _lora_bodies(cfg, ads, f"{wave}-{on}-{quant}"), cfg,
                    fused=True)
                tokens[(wave, on)] = toks
                if on:
                    out[wave] = dict(timing, launches={
                        k: v for k, v in launches.items() if v})
            stats = worker.models[cfg.name].batcher.lora_stats()
            assert stats["slotted"] == ["a1", "a3"], stats
            out["lora_stats" if on else "lora_stats_graphs_off"] = stats
        finally:
            st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
            worker.shutdown()
            _graphs_on(True)
    for wave in ("base",) + tuple(waves):
        assert tokens[(wave, True)] == tokens[(wave, False)], \
            f"lora wave {wave}: graphs on and off disagree"
    log(f"  lora batched {quant or 'bf16'}", json.dumps(out))
    return out


def _lora_engine(torch, kernels, cfg, quant=None):
    """(a) Engine mode: base and a1 requests (greedy and sampled), graphs
    on then off over one load: equal tokens; flash_attention num_layers
    per request, flash_decode num_layers per decode step, and with int4
    weights q4_matmul every linear per decode step plus the gathered head
    row of the prefill, all in their tensor-core forms. ms per step with
    and without the adapter."""
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    L = cfg.num_layers
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    reqs = ((200, {"do_sample": False}, 0, None),
            (200, {"do_sample": False}, 0, "a1"),
            (500, {}, 1, "a1"))
    q4 = q4_per_pass(cfg) if quant == "int4" else 0
    out, toks = {"requests": []}, {}
    try:
        load = {"model_name": cfg.name, "allow_random_init": True,
                "dtype": "bfloat16", "max_seq": 4096,
                **({"quantize": quant} if quant else {})}
        st, res = _http(base + "/load_model", load)
        assert st == 200 and res["status"] == "success", res
        st, r = _http(base + "/load_adapter", {
            "model_name": cfg.name, "adapter": "a1",
            "source": LORA_SOURCES["a1"]})
        assert st == 200, r
        # graphs on twice: the first call of each program captures it, the
        # repeat's step time is the replay's
        for it, on in enumerate((True, True, False)):
            _graphs_on(on)
            for n_tok, sampling, seed, ad in reqs:
                _bank19(kernels)
                st, r = _http(base + "/inference", {
                    "model_name": cfg.name, "prompt": engine_prompt(
                        n_tok, seed), "max_new_tokens": NEW_TOKENS,
                    "sampling": sampling, "seed": seed,
                    **({"adapter": ad} if ad else {})})
                assert st == 200 and r["status"] == "success", r
                passes = r["cost"]["weight_passes"]
                d = {k: v for k, v in read_counts(kernels).items() if v}
                want = {"flash_attention": L, "flash_attention[mma]": L,
                        "flash_decode": L * (passes - 1)}
                if q4:
                    want["q4_matmul"] = want["q4_matmul[mma]"] = \
                        1 + q4 * (passes - 1)
                assert d == want, f"engine {quant} {ad}: {d} != {want}"
                prev = toks.setdefault((n_tok, seed, ad, on), r["tokens"])
                assert prev == r["tokens"], (n_tok, ad, on)
                if it == 1:
                    out["requests"].append({
                        "prompt_tokens": n_tok, "adapter": ad,
                        "sampling": sampling or "default",
                        "ms_per_step": r["decode_ms"] / (passes - 1),
                        "prefill_ms": r["prefill_ms"], "launches": d})
    finally:
        _bank19(kernels)
        _graphs_on(True)
        _http(base + "/unload_model", {"model_name": cfg.name})
        worker.shutdown()
    for n_tok, _, seed, ad in reqs:
        assert toks[(n_tok, seed, ad, True)] == toks[(n_tok, seed, ad, False)]
    assert toks[(200, 0, None, True)] != toks[(200, 0, "a1", True)], \
        "the adapter left the greedy tokens alone"
    log(f"  lora engine {quant or 'bf16'}", json.dumps(out))
    return out


def _lora_xcheck(torch, kernels, cfg):
    """(a) A mixed batch (base, a1, a2 rows; one prefill and 4 decode
    steps on the card, through flash_attention and flash_decode) against
    dedicated single-row runs of each adapter on the host, llama-3-8b's
    width at 2 layers in f32: within XCHECK_TOL."""
    from distributed_llm_inferencing_tpu_torch.models import lora
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        LoRARows, Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    cfg = cfg.replace(num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    ads = [None] + [lora.resolve(cfg, n, LORA_SOURCES[n])
                    for n in ("a1", "a2")]
    pack = lora.build_pack(cfg, ads, 16)
    g = torch.Generator().manual_seed(9)
    B, S0, steps = 3, 64, 4
    lens = torch.tensor([40, 64, 51], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S0), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=g)
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            model = Transformer(cfg, params if dev == "cuda" else
                                {k: t.cpu() for k, t in params.items()})
            dpack = {t: {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
                     for t, p in pack.items()}
            rows = [list(range(B))] if dev == "cuda" else [[r] for r in
                                                            range(B)]
            logits = [None] * B
            _bank19(kernels)
            for rr in rows:
                idx = torch.tensor(rr)
                ids = idx.to(dev)
                lr = LoRARows(dpack, ids)
                cache = init_cache(cfg, len(rr), 96, device=dev)
                ln = lens[idx].to(dev)
                lg, cache = model.prefill(toks[idx].to(dev), ln, cache,
                                          gather=(ln - 1).long(), lora=lr)
                seq = [lg[:, 0].cpu()]
                for t in range(steps):
                    lg, cache = model.decode_step(forced[t][idx].to(dev),
                                                  cache, lr)
                    seq.append(lg[:, 0].cpu())
                for j, r in enumerate(rr):
                    logits[r] = torch.stack([s[j] for s in seq])
            if dev == "cuda":
                d = {k: v for k, v in read_counts(kernels).items() if v}
                assert d == {"flash_attention": 2,
                             "flash_decode": 2 * steps}, d
            out[dev] = torch.stack(logits)
            del model
    _bank19(kernels)
    err = _xcheck(torch, "llama-3-8b mixed adapters vs dedicated",
                  out["cuda"].flatten(0, 1), out["cpu"].flatten(0, 1))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return err


def _moe_drops(ttf):
    """A wrapper of ``ttf.moe_gates`` that counts the choices capacity
    dispatch drops (its caller passes the flat [N, D] input)."""
    import numpy as np
    real, n = ttf.moe_gates, [0]

    def gates(x, w, cfg, b=None):
        g = real(x, w, cfg, b)
        if x.dim() == 2:
            k, e = cfg.num_experts_per_tok, cfg.num_experts
            c = max(1, int(cfg.moe_capacity_factor * k * x.shape[0] / e))
            idx = torch_topk_idx(g, k)
            counts = np.zeros(e, int)
            for row in idx:
                for ex in row:
                    n[0] += counts[ex] >= c
                    counts[ex] += 1
        return g
    return real, gates, n


def torch_topk_idx(g, k):
    return g.topk(k, dim=-1).indices.cpu().numpy()


def _moe_xcheck(torch, kernels):
    """(b) mixtral-8x7b at full width, 2 layers, f32, the kernels against
    their plain versions on the card (``_PlainKernels``: the host's f32
    forward of its experts took 32.5-34.2 s beside an NVIDIA H100)
    in each dispatch mode of MOE_XCHECK (prefill over prompts in runs of
    one token, then 4 decode steps): logits within XCHECK_TOL, and the
    reference's capacity dispatch drops choices. Then moe-proxy-8e (the row
    served on both decode routes) at its full width, 2 layers, f32, dense
    dispatch: the serving path over the paged pool (``_paged_run``) on
    the paged and the fused route (the fused gate takes the MoE rows, as
    the JAX gate does) against the host's."""
    from distributed_llm_inferencing_tpu_torch.models import transformer
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    base = get_config("mixtral-8x7b").replace(num_layers=2, dtype="float32")
    params = init_params(base, torch.Generator(device="cuda").manual_seed(11),
                         "cuda")
    real, gates, drops = _moe_drops(transformer)
    errs, steps = {}, 4
    try:
        for mode, B, S0 in MOE_XCHECK:
            cfg = base.replace(moe_dispatch=mode)
            toks = torch.tensor([_runs_prompt(cfg, S0, 40 + r)
                                 for r in range(B)])
            lens = torch.full((B,), S0, dtype=torch.int32)
            g = torch.Generator().manual_seed(41)
            forced = torch.randint(0, cfg.vocab_size, (steps, B, 1),
                                   generator=g)
            out, dropped = {}, {}
            for side in ("card", "ref"):
                model = transformer.Transformer(cfg, params)
                drops[0] = 0
                transformer.moe_gates = gates if side == "ref" else real
                _bank19(kernels)
                with torch.inference_mode(), (
                        _PlainKernels() if side == "ref" else _Env()):
                    cache = init_cache(cfg, B, S0 + steps, device="cuda")
                    lg, cache = model.prefill(toks.cuda(), lens.cuda(),
                                              cache)
                    seq = [lg.flatten(0, 1).cpu()]
                    for t in range(steps):
                        lg, cache = model.decode_step(forced[t].cuda(),
                                                      cache)
                        seq.append(lg[:, 0].cpu())
                out[side] = torch.cat(seq)
                dropped[side] = drops[0]
                d = {k: v for k, v in read_counts(kernels).items() if v}
                assert d == ({"flash_attention": 2,
                              "flash_decode": 2 * steps}
                             if side == "card" else {}), (side, d)
                del model
            errs[mode] = {"max_abs_err": _xcheck(
                torch, f"mixtral-8x7b {mode} dispatch (plain on the card)",
                out["card"], out["ref"]),
                "reference_dropped_choices": int(dropped["ref"])}
            if mode != "dense":
                assert dropped["ref"] > 0, f"{mode}: no choice dropped"
        del params
        transformer.moe_gates = real
        _bank19(kernels)
        cfg = get_config("moe-proxy-8e").replace(
            num_layers=2, dtype="float32", moe_dispatch="dense")
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(12), "cuda")
        host = {k: t.cpu() for k, t in params.items()}
        ref = _paged_run(torch, transformer.Transformer(cfg, host), "cpu")
        card = transformer.Transformer(cfg, params)
        errs["moe-proxy-8e paged pool"] = {route: _xcheck(
            torch, f"moe-proxy-8e dense dispatch {route}",
            _paged_run(torch, card, "cuda", route), ref)
            for route in ("paged", "fused")}
        del card
    finally:
        transformer.moe_gates = real
        _bank19(kernels)
    del params, host
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _moe_engine(torch, base, kernels, cfg, requests):
    """``requests`` ((prompt tokens in runs, sampling, seed) each) through
    a loaded engine-mode MoE model, graphs on (twice: the repeat's step
    time is the replay's) then off: equal tokens, flash_attention
    num_layers per request (tensor-core) and flash_decode num_layers per
    decode step. ms per step."""
    L = cfg.num_layers
    toks, rows = {}, []
    for it, on in enumerate((True, True, False)):
        _graphs_on(on)
        for n, sampling, seed in requests:
            _bank19(kernels)
            st, r = _http(base + "/inference", {
                "model_name": cfg.name, "prompt_tokens": _runs_prompt(
                    cfg, n, seed), "max_new_tokens": MOE_NEW,
                "sampling": sampling, "seed": seed})
            assert st == 200 and r["status"] == "success", r
            passes = r["cost"]["weight_passes"]
            d = {k: v for k, v in read_counts(kernels).items() if v}
            want = {"flash_attention": L, "flash_attention[mma]": L,
                    "flash_decode": L * (passes - 1)}
            assert d == want, f"{cfg.name} engine: {d} != {want}"
            prev = toks.setdefault((n, on), r["tokens"])
            assert prev == r["tokens"], (cfg.name, n, on)
            if it == 1:
                rows.append({"prompt_tokens": n, "new": len(r["tokens"]),
                             "prefill_ms": r["prefill_ms"],
                             "ms_per_step": r["decode_ms"] / (passes - 1),
                             "launches": d})
    _graphs_on(True)
    _bank19(kernels)
    for n, _, _ in requests:
        assert toks[(n, True)] == toks[(n, False)], \
            f"{cfg.name} engine: graphs on and off disagree"
    return rows


def _moe_bodies(cfg, tag, lens):
    return [{"model_name": cfg.name, "request_tag": f"p19-{tag}-{i}",
             "prompt_tokens": _runs_prompt(cfg, n, 60 + i),
             "max_new_tokens": MOE_NEW, "seed": 300 + i,
             "sampling": ({"do_sample": False} if i % 2 == 0 else {})}
            for i, n in enumerate(lens)]


def _moe_model(torch, kernels, cfg, load, requests, lens, fused=False):
    """(b) One MoE row through the worker: engine mode (``requests``,
    graphs on and off over one load), then batched mode (bodies of
    ``lens`` prompt tokens as one /inference_batch, paged route, and with
    ``fused`` the fused route too), once per graphs setting on a fresh
    load: equal tokens per route, exact launches (the fused kernel once
    per layer per pass on its route), ms per step and per pass, the
    stored bytes and the peak device memory above the load's start."""
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    out = {}
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    try:
        modes = ("engine", "batched_on", "batched_off") + (
            ("fused_on", "fused_off") if fused else ())
        toks = {}
        for mode in modes:
            body = dict(load, model_name=cfg.name,
                        **(MOE_BATCHED if mode != "engine" else {}))
            _graphs_on(not mode.endswith("_off"))
            os.environ["DLI_FUSED_DECODE"] = \
                "1" if mode.startswith("fused") else "0"
            gc.collect()
            torch.cuda.empty_cache()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st, res = _http(base + "/load_model", body)
            assert st == 200 and res["status"] == "success", res
            load_s = time.perf_counter() - t0
            if mode == "engine":
                rows = _moe_engine(torch, base, kernels, cfg, requests)
            else:
                tokens, launches, timing = _counted_wave(
                    base, worker, kernels, cfg.name,
                    _moe_bodies(cfg, mode, lens), cfg,
                    fused=mode.startswith("fused"))
                toks[mode] = tokens
                rows = dict(timing, launches={k: v for k, v in
                                              launches.items() if v})
            out[mode] = {"load_s": load_s,
                         "param_bytes": worker.models[cfg.name].describe(
                             cfg.name)["param_bytes"],
                         "peak_bytes_above_start": (
                             torch.cuda.max_memory_allocated() - start),
                         "result": rows}
            st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
            assert st == 200
            _graphs_on(True)
        for route in ("batched", "fused")[:1 + fused]:
            assert toks[f"{route}_on"] == toks[f"{route}_off"], \
                f"{cfg.name} {route}: graphs on and off disagree"
    finally:
        _graphs_on(True)
        os.environ["DLI_FUSED_DECODE"] = "0"
        worker.shutdown()
    log(f"  moe {cfg.name}", json.dumps(out))
    return out


def phase_lora_moe(torch, kernels, smi):
    """Phase 19 (see the module docstring): (a) multi-LoRA on llama-3-8b;
    (b) the experts of mixtral-8x7b and moe-proxy-8e."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    llama = get_config("llama-3-8b")
    report, t_all = {"smi": smi}, time.perf_counter()
    _PHASE19_LAUNCHES.clear()
    zero_counts(kernels)
    with _Env(**LORA_ENV):
        for key, fn in (
                ("lora_xcheck", lambda: _lora_xcheck(torch, kernels, llama)),
                ("lora_batched", lambda: _lora_batched(torch, kernels,
                                                       llama)),
                ("lora_engine", lambda: _lora_engine(torch, kernels, llama)),
                ("lora_int4_engine", lambda: _lora_engine(
                    torch, kernels, llama, "int4")),
                ("moe_xcheck", lambda: _moe_xcheck(torch, kernels)),
                ("moe_proxy", lambda: _moe_model(
                    torch, kernels, get_config("moe-proxy-8e"),
                    {"allow_random_init": True, "dtype": "bfloat16",
                     "max_seq": 4096}, MOE_REQUESTS, (300, 120, 40, 600),
                    fused=True)),
                # one engine request and one batched body: ~235 ms a step
                ("mixtral_int8", lambda: _moe_model(
                    torch, kernels, get_config("mixtral-8x7b"),
                    MIXTRAL_LOAD, MOE_REQUESTS[:1], (300,)))):
            t0 = time.perf_counter()
            # the MoE rows decode on the paged route unless a check asks
            # for the fused one
            with _Env(DLI_FUSED_DECODE="0" if key.startswith(
                    ("moe", "mixtral")) else "1"):
                report[key] = fn()
            report[f"seconds_{key}"] = time.perf_counter() - t0
            log(f"  phase 19 {key}: {report[f'seconds_{key}']:.1f} s")
    _bank19(kernels)
    report["launches"] = dict(_PHASE19_LAUNCHES)
    log("  phase 19 launches:", json.dumps(report["launches"]))
    report["seconds"] = time.perf_counter() - t_all
    log(f"  phase 19 wall time: {report['seconds']:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase19.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report

# ---------------------------------------------------------------------
# phase 20: the other experts and latent attention
# ---------------------------------------------------------------------

_PHASE20_LAUNCHES: dict = {}
MLA_NAME = "deepseek-proxy"
MLA_BATCHED = dict(BATCHED_LOAD, model_name=MLA_NAME)
# (b): each converter type at the published config of its public model
# (the config.json fields config_from_hf reads); depth is the only cut
EXPERT_XCHECK = {
    "glm4_moe": {   # zai-org/GLM-4.5-Air
        "model_type": "glm4_moe", "vocab_size": 151552, "hidden_size": 4096,
        "intermediate_size": 10944, "moe_intermediate_size": 1408,
        "num_hidden_layers": 46, "num_attention_heads": 96,
        "num_key_value_heads": 8, "head_dim": 128,
        "partial_rotary_factor": 0.5, "n_routed_experts": 128,
        "n_shared_experts": 1, "num_experts_per_tok": 8,
        "first_k_dense_replace": 1, "n_group": 1, "topk_group": 1,
        "routed_scaling_factor": 1.0, "norm_topk_prob": True,
        "use_qk_norm": False, "attention_bias": True,
        "rope_theta": 1000000, "rms_norm_eps": 1e-05,
        "max_position_embeddings": 131072, "tie_word_embeddings": False},
    "ernie4_5_moe": {   # baidu/ERNIE-4.5-21B-A3B-PT
        "model_type": "ernie4_5_moe", "vocab_size": 103424,
        "hidden_size": 2560, "intermediate_size": 12288,
        "moe_intermediate_size": 1536, "num_hidden_layers": 28,
        "num_attention_heads": 20, "num_key_value_heads": 4,
        "moe_num_experts": 64, "moe_k": 6, "moe_num_shared_experts": 2,
        "moe_layer_start_index": 1, "moe_layer_end_index": 27,
        "moe_layer_interval": 1, "rope_theta": 500000,
        "rms_norm_eps": 1e-05, "max_position_embeddings": 131072,
        "use_bias": False, "tie_word_embeddings": True},
    "hunyuan_v1_moe": {   # tencent/Hunyuan-A13B-Instruct
        "model_type": "hunyuan_v1_moe", "vocab_size": 128167,
        "hidden_size": 4096, "intermediate_size": 3072,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "num_experts": 64,
        "moe_topk": 8, "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
        "max_position_embeddings": 32768, "attention_bias": False,
        "tie_word_embeddings": False},
    "dbrx": {   # databricks/dbrx-instruct
        "model_type": "dbrx", "vocab_size": 100352, "d_model": 6144,
        "n_heads": 48, "n_layers": 40, "max_seq_len": 32768,
        "attn_config": {"kv_n_heads": 8, "clip_qkv": 8,
                        "rope_theta": 500000},
        "ffn_config": {"ffn_hidden_size": 10752, "moe_num_experts": 16,
                       "moe_top_k": 4, "moe_normalize_expert_weights": 1,
                       "ffn_act_fn": {"name": "silu"}}},
    "gpt_oss": {   # openai/gpt-oss-20b
        "model_type": "gpt_oss", "vocab_size": 201088, "hidden_size": 2880,
        "intermediate_size": 2880, "num_hidden_layers": 24,
        "num_attention_heads": 64, "num_key_value_heads": 8, "head_dim": 64,
        "num_local_experts": 32, "num_experts_per_tok": 4,
        "sliding_window": 128,
        "layer_types": ["sliding_attention", "full_attention"] * 12,
        "rope_theta": 150000,
        "rope_scaling": {"rope_type": "yarn", "factor": 32.0,
                         "beta_fast": 32.0, "beta_slow": 1.0,
                         "truncate": False,
                         "original_max_position_embeddings": 4096},
        "swiglu_limit": 7.0, "rms_norm_eps": 1e-05,
        "max_position_embeddings": 131072, "tie_word_embeddings": False},
    "deepseek_v3": {   # deepseek-ai/DeepSeek-V3
        "model_type": "deepseek_v3", "vocab_size": 129280,
        "hidden_size": 7168, "intermediate_size": 18432,
        "moe_intermediate_size": 2048, "num_hidden_layers": 61,
        "num_attention_heads": 128, "num_key_value_heads": 128,
        "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_rope_head_dim": 64,
        "qk_nope_head_dim": 128, "v_head_dim": 128, "n_routed_experts": 256,
        "n_shared_experts": 1, "n_group": 8, "topk_group": 4,
        "num_experts_per_tok": 8, "routed_scaling_factor": 2.5,
        "first_k_dense_replace": 3, "norm_topk_prob": True,
        "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                         "beta_slow": 1, "mscale": 1.0,
                         "mscale_all_dim": 1.0,
                         "original_max_position_embeddings": 4096},
        "rms_norm_eps": 1e-06, "max_position_embeddings": 163840,
        "tie_word_embeddings": False},
}
# depth of each (b) row; the decode routes of its paged check (the fused
# kernel where its gate takes the type: no q bias, clamp, q/k norm,
# partial or interleaved rotary, sinks or latent attention)
EXPERT_LAYERS = {"dbrx": 1}
EXPERT_ROUTES = {"ernie4_5_moe": ("paged", "fused")}
# the rows whose reference runs on the card, the attention kernels
# swapped for their plain versions: with the host's f32 forward these
# rows took 40.7, 74.3 and 55.6 s (every expert's weights read on 8 host
# cores per decode step), past the 30 s a row may take; ernie4_5_moe
# too (20.1 s on the host beside an NVIDIA H100), to pay for phase 22.
# gpt_oss (sinks) and deepseek_v3 (latent attention) launch no attention
# kernel: against the plain versions on the card they would compare a
# path with itself, so they keep the host's
CARD_REFERENCE = ("glm4_moe", "hunyuan_v1_moe", "dbrx", "ernie4_5_moe")
V3_GATE_ROWS = 64
# (c): gpt-oss-20b's shape served from a written checkpoint, two of its
# sliding / full window pairs
GPT_OSS_LAYERS = 4
GPT_OSS_NAME = "gpt-oss-20b-ckpt"


def _bank20(kernels):
    _add(_PHASE20_LAUNCHES, read_counts(kernels))
    zero_counts(kernels)


def _mla_engine(torch, worker, kernels, cfg, latent, quant=None):
    """(a) One engine-mode load of deepseek-proxy (``latent``: "1" the
    latent cache, "0" the materialized one; ``quant``), phase 3's
    requests with graphs on, then off over the same load: equal tokens,
    exact launches (none but the int4 linears' q4_matmul), the cache's
    bytes, ms per step, stored bytes and peak memory."""
    base = _worker_base(worker)
    before = _baseline(torch)
    torch.cuda.reset_peak_memory_stats()
    load = {"model_name": cfg.name, "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096}
    if quant:
        load["quantize"] = quant
    with _Env(DLI_MLA_LATENT=latent):
        st, res = _http(base + "/load_model", load)
    assert st == 200 and res["status"] == "success", res
    engine = worker.models[cfg.name].engine
    ecfg = engine.cfg
    assert ecfg.mla_latent_cache == (latent == "1"), ecfg.mla_latent_cache
    q4 = q4_per_pass(ecfg) if quant == "int4" else 0
    out, toks = {}, {}
    for on in (True, False):
        _graphs_on(on)
        launches, rows = _engine_requests(
            torch, base, kernels, ecfg, cfg.name, q4, decode_kernel=False,
            prefill_kernel=False)
        _bank20(kernels)
        toks[on] = [r["tokens"] for r in rows]
        out["graphs_on" if on else "graphs_off"] = {
            "ms_per_step": [r["decode_ms_per_weight_pass"] for r in rows],
            "prefill_ms": [r["prefill_ms"] for r in rows],
            "launches": {k: v for k, v in launches.items() if v}}
    _graphs_on(True)
    assert toks[True] == toks[False], \
        f"{cfg.name} latent={latent}: graphs on and off disagree"
    cache = engine._state(1).cache
    L, S = cfg.num_layers, engine.max_seq
    want = (L * S * (cfg.qk_rope_head_dim + cfg.kv_lora_rank) * 2
            if latent == "1" else 2 * L * S * cfg.num_heads * cfg.head_dim * 2)
    assert _cache_bytes(cache) == want, (_cache_bytes(cache), want)
    if latent == "1":
        assert tuple(cache.k.shape) == (L, 1, S, 1, 160) and \
            cache.v.numel() == 0, (cache.k.shape, cache.v.shape)
    out.update(cache_bytes_b1=_cache_bytes(cache), q4_per_step=q4,
               param_bytes=worker.models[cfg.name].describe(
                   cfg.name)["param_bytes"],
               peak_bytes_above_start=(torch.cuda.max_memory_allocated()
                                       - before),
               tokens=toks[True])
    st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
    assert st == 200
    log(f"  {cfg.name} engine latent={latent} quant={quant}:", json.dumps(
        {k: v for k, v in out.items() if k != "tokens"}))
    return out


def _batched_no_kernel(torch, worker, kernels, cfg, load, tag):
    """Phase 5's eight bodies as one /inference_batch on a fresh batched
    load per graphs setting (the paged route): equal tokens, no kernel
    launched, ms per pass, stored bytes."""
    base = _worker_base(worker)
    out, toks = {}, {}
    bodies = [dict(b, model_name=cfg.name, request_tag=f"p20-{tag}-{i}")
              for i, b in enumerate(_batched_bodies(cfg))]
    for on in (True, False):
        _graphs_on(on)
        with _Env(DLI_FUSED_DECODE="0"):
            st, res = _http(base + "/load_model", load)
            assert st == 200 and res["status"] == "success", res
            tokens, launches, timing = _counted_wave(
                base, worker, kernels, cfg.name,
                [dict(b, request_tag=f"{b['request_tag']}-{on}")
                 for b in bodies], cfg, False, quiet=True, bank=_bank20)
        assert not any(launches.values()), launches
        toks[on] = tokens
        out["graphs_on" if on else "graphs_off"] = dict(
            timing, param_bytes=worker.models[cfg.name].describe(
                cfg.name)["param_bytes"])
        st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
        assert st == 200
    _graphs_on(True)
    assert toks[True] == toks[False], f"{tag}: graphs on and off disagree"
    assert all(0 <= t < cfg.vocab_size for ts in toks[True] for t in ts)
    log(f"  {cfg.name} batched ({tag}):", json.dumps(out))
    return out


def _mla_serving(torch, kernels):
    """(a) deepseek-proxy through the worker (see the module docstring)."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config(MLA_NAME)
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    out = {}
    try:
        out["latent"] = _mla_engine(torch, worker, kernels, cfg, "1")
        out["materialized"] = _mla_engine(torch, worker, kernels, cfg, "0")
        out["latent_int4"] = _mla_engine(torch, worker, kernels, cfg, "1",
                                         "int4")
        out["batched"] = _batched_no_kernel(torch, worker, kernels, cfg,
                                            MLA_BATCHED, "mla")
    finally:
        _graphs_on(True)
        worker.shutdown()
    ratio = (out["materialized"]["cache_bytes_b1"]
             / out["latent"]["cache_bytes_b1"])
    assert abs(ratio - 19.2) < 1e-9, ratio
    out["cache_ratio"] = ratio
    # the two caches hold the same attention: greedy rows agree (bf16
    # rounding may part them late, so only the first tokens are held)
    for i, (n, sp, _) in enumerate(ENGINE_REQUESTS):
        if sp.get("do_sample") is False:
            a, b = (out[k]["tokens"][i] for k in ("latent", "materialized"))
            out.setdefault("greedy_tokens_agree", []).append(
                sum(x == y for x, y in zip(a, b)))
    return out


def _v3_gate_row(torch):
    """DeepSeek-V3's router at its widths (256 experts, 8 groups, top-4
    groups, top-8, scale 2.5) on [V3_GATE_ROWS, 7168] f32 inputs: card
    against host within 1e-6, the same experts picked."""
    from distributed_llm_inferencing_tpu_torch.models import transformer
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    cfg = config_from_hf(EXPERT_XCHECK["deepseek_v3"], name="v3-router")
    g = torch.Generator(device="cuda").manual_seed(20)
    D, E = cfg.hidden_size, cfg.num_experts
    x = torch.randn(V3_GATE_ROWS, D, generator=g, device="cuda")
    w = torch.randn(D, E, generator=g, device="cuda").mul_(0.02)
    bias = torch.randn(E, generator=g, device="cuda").mul_(0.02)
    card = transformer.moe_gates(x, w, cfg, bias)
    host = transformer.moe_gates(x.cpu(), w.cpu(), cfg, bias.cpu())
    assert torch.equal(card.cpu() > 0, host > 0), "V3 router picks differ"
    assert int((host > 0).sum(-1).max()) == cfg.num_experts_per_tok
    err = float((card.cpu() - host).abs().max())
    assert err <= 1e-6, err
    log(f"  DeepSeek-V3 router, card vs host, [{V3_GATE_ROWS}, {D}] x "
        f"{E} experts: max_abs_err {err:.3e} (tol 1e-6)")
    return {"max_abs_err": err, "rows": V3_GATE_ROWS, "experts": E}


def _expert_xcheck(torch, fa, qm, kernels):
    """(b): one card-vs-host row per converter type (EXPERT_XCHECK, the
    depth cut to EXPERT_LAYERS; deepseek_v3's first layers are its dense
    prefix; windows cut to XCHECK_WINDOW so they bite in 72 positions),
    then deepseek-proxy's dense and MoE layer and V3's router."""
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    out = {}
    for mt, conf in EXPERT_XCHECK.items():
        t0 = time.perf_counter()
        cfg = config_from_hf(conf, name=f"{mt}-xcheck")
        layers = EXPERT_LAYERS.get(mt, 2)
        reduced = f"{layers} of {cfg.num_layers} layers"
        if cfg.dense_prefix_layers >= layers:   # deepseek_v3: all prefix
            cfg = cfg.dense_segment_cfg(num_layers=layers)
            reduced += " (its dense prefix)"
        if cfg.attn_windows is not None:
            cfg = cfg.replace(attn_windows=tuple(
                None if w is None else XCHECK_WINDOW
                for w in cfg.attn_windows[:layers]), num_layers=layers)
            reduced += f", windows cut to {XCHECK_WINDOW}"
        on_card = mt in CARD_REFERENCE
        if on_card:
            reduced += "; reference: the plain versions on the card"
        log(f"  {mt}: {reduced}")
        _bank20(kernels)
        errs = phase_cross_check(torch, fa, qm, None, mt,
                                 EXPERT_ROUTES.get(mt, ("paged",)), cfg=cfg,
                                 layers=layers, ref_on_card=on_card)
        launches = {k: v for k, v in read_counts(kernels).items() if v}
        _bank20(kernels)
        out[mt] = dict(errs, reduced=reduced, launches=launches,
                       seconds=time.perf_counter() - t0)
        log(f"  {mt} row:", json.dumps(out[mt]))
    t0 = time.perf_counter()
    errs = phase_cross_check(torch, fa, qm, None, MLA_NAME, ("paged",))
    out[MLA_NAME] = dict(errs, reduced="2 of 12 layers (dense prefix, MoE)",
                         launches={k: v for k, v in
                                   read_counts(kernels).items() if v},
                         seconds=time.perf_counter() - t0)
    _bank20(kernels)
    out["v3_router"] = _v3_gate_row(torch)
    return out


def _gpt_oss_tensors(conf):
    """(HF key, shape, kind) of every tensor of a gpt_oss checkpoint (HF
    modeling_gpt_oss.py's names; the experts' fused gate_up [E, D, 2I]
    and down [E, I, D] stacks as stored)."""
    D, I, V = conf["hidden_size"], conf["intermediate_size"], \
        conf["vocab_size"]
    H, KV, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    E = conf["num_local_experts"]
    out = [("model.embed_tokens.weight", (V, D), "w")]
    for i in range(conf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        out += [(p + "input_layernorm.weight", (D,), "norm")]
        for n, dout, din in (("q", H * hd, D), ("k", KV * hd, D),
                             ("v", KV * hd, D), ("o", D, H * hd)):
            out += [(f"{a}{n}_proj.weight", (dout, din), "w"),
                    (f"{a}{n}_proj.bias", (dout,), "b")]
        out += [(a + "sinks", (H,), "w"),
                (p + "post_attention_layernorm.weight", (D,), "norm"),
                (m + "router.weight", (E, D), "w"),
                (m + "router.bias", (E,), "b"),
                (m + "experts.gate_up_proj", (E, D, 2 * I), "w"),
                (m + "experts.gate_up_proj_bias", (E, 2 * I), "b"),
                (m + "experts.down_proj", (E, I, D), "w"),
                (m + "experts.down_proj_bias", (E, D), "b")]
    return out + [("model.norm.weight", (D,), "norm"),
                  ("lm_head.weight", (V, D), "w")]


def _gpt_oss_names(conf, key, t):
    """``_port_names`` for gpt_oss, by this script's own reading of its
    layout: linears transposed, the router's bias and the sinks as they
    are, gate the even and up the odd columns of the fused stacks."""
    if key in ("model.embed_tokens.weight", "model.norm.weight",
               "lm_head.weight"):
        return _port_names(dict(conf, model_type="llama"), key, t)
    i, rest = key.split(".")[2], key.split(".", 3)[3]
    o = f"layers.{i}."
    if rest in _LLAMA_NAMES:
        return [(o + _LLAMA_NAMES[rest], t)]
    if rest == "self_attn.sinks":
        return [(o + "sinks", t)]
    if rest.startswith("self_attn."):
        n, leaf = rest.split(".")[1][0], rest.split(".")[2]
        return [(f"{o}{n}.{'w' if leaf == 'weight' else 'b'}",
                 t.T.contiguous() if leaf == "weight" else t)]
    if rest == "mlp.router.weight":
        return [(o + "router.w", t.T.contiguous())]
    if rest == "mlp.router.bias":
        return [(o + "router.bias", t)]
    leaf = "b" if rest.endswith("_bias") else "w"
    if "gate_up" in rest:
        return [(f"{o}experts.gate.{leaf}", t[..., 0::2].contiguous()),
                (f"{o}experts.up.{leaf}", t[..., 1::2].contiguous())]
    return [(f"{o}experts.down.{leaf}", t)]


def _gpt_oss_serving(torch, kernels):
    """(c): a gpt-oss-20b-shaped directory (GPT_OSS_LAYERS layers) written
    from seeded tensors, served through the worker in engine mode (graphs
    on and off over one load) and batched mode (a fresh load per graphs
    setting): equal tokens, no attention kernel, every param bitwise."""
    import shutil
    import tempfile

    from distributed_llm_inferencing_tpu_torch.models.convert import (
        config_from_hf)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    conf = dict(EXPERT_XCHECK["gpt_oss"], num_hidden_layers=GPT_OSS_LAYERS,
                layer_types=EXPERT_XCHECK["gpt_oss"]["layer_types"][
                    :GPT_OSS_LAYERS])
    log(f"  gpt-oss-20b shape: DEPTH CUT to {GPT_OSS_LAYERS} of 24 layers")
    root = tempfile.mkdtemp(prefix="dli-gptoss-")
    path = os.path.join(root, "gpt-oss")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    out = {}
    try:
        expected, nbytes, write_s = write_checkpoint(
            torch, path, conf, INGEST_SEED + 4, tensors=_gpt_oss_tensors,
            names=_gpt_oss_names)
        cfg = config_from_hf(conf, name=path).replace(name=GPT_OSS_NAME)
        out.update(file_bytes=nbytes, write_s=write_s)
        log(f"  wrote {path}: {nbytes / 1e9:.3f} GB in {write_s:.1f} s")
        body = {"model_name": GPT_OSS_NAME, "checkpoint_path": path,
                "max_seq": 4096}
        st, res = _http(base + "/load_model", body)
        assert st == 200 and res["status"] == "success", res
        out["bitwise"] = _bitwise(torch, worker.models[
            GPT_OSS_NAME].engine.params, expected)
        toks = {}
        for on in (True, False):
            _graphs_on(on)
            launches, rows = _engine_requests(
                torch, base, kernels, cfg, GPT_OSS_NAME, 0,
                decode_kernel=False, prefill_kernel=False)
            _bank20(kernels)
            toks[on] = [r["tokens"] for r in rows]
            out["engine_" + ("on" if on else "off")] = {
                "ms_per_step": [r["decode_ms_per_weight_pass"]
                                for r in rows],
                "prefill_ms": [r["prefill_ms"] for r in rows]}
        _graphs_on(True)
        assert toks[True] == toks[False], "gpt-oss: graphs on/off disagree"
        st, _ = _http(base + "/unload_model", {"model_name": GPT_OSS_NAME})
        assert st == 200
        del expected
        load = dict(BATCHED_LOAD, **body)
        load.pop("allow_random_init")
        out["batched"] = _batched_no_kernel(torch, worker, kernels, cfg,
                                            load, "gpt-oss")
    finally:
        _graphs_on(True)
        worker.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("  gpt-oss-20b shape through the worker:", json.dumps(out))
    return out


def phase_experts_mla(torch, fa, qm, kernels, smi):
    """Phase 20 (see the module docstring)."""
    report, t_all = {"smi": smi}, time.perf_counter()
    _PHASE20_LAUNCHES.clear()
    zero_counts(kernels)
    for key, fn in (("mla_serving", lambda: _mla_serving(torch, kernels)),
                    ("expert_xcheck", lambda: _expert_xcheck(
                        torch, fa, qm, kernels)),
                    ("gpt_oss_serving", lambda: _gpt_oss_serving(
                        torch, kernels))):
        t0 = time.perf_counter()
        with _Env(DLI_FUSED_DECODE="0"):
            report[key] = fn()
        report[f"seconds_{key}"] = time.perf_counter() - t0
        log(f"  phase 20 {key}: {report[f'seconds_{key}']:.1f} s")
    _bank20(kernels)
    report["launches"] = dict(_PHASE20_LAUNCHES)
    log("  phase 20 launches:", json.dumps(report["launches"]))
    report["seconds"] = time.perf_counter() - t_all
    log(f"  phase 20 wall time: {report['seconds']:.1f} s [{smi}]")
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase20.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report


# ---------------------------------------------------------------------
# phase 21: batched serving, speculation and the families under tp
# ---------------------------------------------------------------------

# (c): registry shapes at their published widths, 2 layers, f32, each
# tp=2 against tp=1 on the engine; "gemma2" / "qwen3": LATER_XCHECK's
# gemma-2-9b and Qwen3-8B configs (gemma-2's windows cut as there)
# phase 21's speculation: at full width the seeded weights' sublayers
# outweigh the token's embedding, so the model's continuation of
# p + c + p is not c and no draft is accepted (0 of 16 prompts on the
# card); sublayers scaled by this leave the next token mostly the
# current token's, as a trained model's continuation of repeated text
# repeats, and drafts accept
SPEC_RESIDUAL_SCALE = 1e-3
TP_FAMILY_ROWS = ("bloom-7b1", "pythia-6.9b", "phi-2", "gemma2", "gemma-2b",
                  "qwen2-7b", "opt-1.3b", "qwen3")
_PHASE21_LAUNCHES: dict = {}


def _bank21(stats):
    """Add every rank's launches of ``stats`` (``rank_stats``) to phase
    21's total."""
    for s in stats:
        for k, v in s["launches"].items():
            _PHASE21_LAUNCHES[k] = _PHASE21_LAUNCHES.get(k, 0) + v


def _tp_all_reduces(cfg):
    """The count rule's all-reduces per weight pass (models/transformer.py):
    the embedding's, then two per layer (o, down), one in a parallel
    block without sublayer norms or residual scale, plus one per
    "rms_full" layer."""
    per = 1 if cfg.parallel_residual and not (
        cfg.post_block_norms or cfg.sublayer_postnorm_only
        or cfg.residual_scale is not None) else 2
    return 1 + cfg.num_layers * (per + (cfg.qk_norm == "rms_full"))


def _same_ranks(stats, what):
    """Every rank ran the leader's programs with its outputs, and counted
    the same launches and collectives."""
    lead = stats[0]
    for s in stats[1:]:
        for k in ("launches", "collectives", "programs_run",
                  "outputs_digest"):
            assert s.get(k) == lead.get(k), \
                f"{what}: rank {s['rank']} {k} {s.get(k)} != {lead.get(k)}"


def _tp_batched_wave(torch, worker, cfg, quant, fused):
    """Phase 5's bodies as one /inference_batch through the loaded tp
    batched model, every rank's counts zeroed before and held after:
    paged_flash_decode num_layers times per weight pass (the fused gate is
    off under tp, whatever DLI_FUSED_DECODE says), no other attention
    kernel; in int4, per decode pass 5 q4_matmul per layer plus the head
    and 2 q4_matmul_row per layer, per admission wave the head and, at
    <= 32 rows, as many again; 2L + 1 all-reduces and one gather per
    forward (decode pass or admission wave), no broadcast."""
    name, L = cfg.name, cfg.num_layers
    b = worker.models[name].batcher
    waves = []
    prefill = b.model.paged_prefill_tail

    def recorded(tokens, *a, **kw):
        waves.append(tokens.shape[0] * tokens.shape[1])
        return prefill(tokens, *a, **kw)

    b.model.paged_prefill_tail = recorded
    bodies = [dict(x, request_tag=f"p21-{quant}-{fused}-{i}")
              for i, x in enumerate(_batched_bodies(cfg))]
    s0 = worker.metrics.snapshot()
    b.reset_counts()
    t0 = time.perf_counter()
    with _Env(DLI_FUSED_DECODE="1" if fused else "0"):
        lines = _stream_lines(_worker_base(worker) + "/inference_batch",
                              {"model_name": name, "requests": bodies}, None)
    wall = time.perf_counter() - t0
    stats = b.rank_stats()
    s1 = worker.metrics.snapshot()
    del b.model.paged_prefill_tail
    passes, emitted = (s1["counters"][k] - s0["counters"].get(k, 0)
                       for k in ("batcher_weight_passes",
                                 "batcher_tokens_emitted"))
    chunk_s = (s1["timings"]["batcher_decode_chunk"]["sum"]
               - s0["timings"].get("batcher_decode_chunk", {}).get("sum", 0))
    msgs = [json.loads(x) for _, x in lines]
    assert all(m["status"] == 200 for m in msgs), msgs
    tags = {m["request_tag"]: m["body"]["tokens"] for m in msgs}
    tokens = [tags[b["request_tag"]] for b in bodies]
    small = sum(n <= 32 for n in waves)
    want = {"paged_flash_decode": L * passes, "fused_decode_step": 0,
            "flash_attention": 0, "flash_decode": 0,
            "q4_matmul": (passes * (5 * L + 1) + len(waves) + small * 5 * L
                          if quant == "int4" else 0),
            "q4_matmul_row": (passes + small) * 2 * L if quant == "int4"
            else 0}
    forwards = passes + len(waves)
    want_c = {"all_reduce": (2 * L + 1) * forwards, "gather": forwards,
              "broadcast": 0}
    for s in stats:
        got = {k: s["launches"][k] for k in want}
        assert got == want, f"rank {s['rank']}: launches {got} != {want}"
        for k in ("q4_matmul", "q4_matmul_row"):
            assert s["launches"][f"{k}[mma]"] == want[k], s["launches"]
        assert s["collectives"] == want_c, \
            f"rank {s['rank']}: {s['collectives']} != {want_c}"
    _same_ranks(stats, f"tp batched {quant} fused={fused}")
    _bank21(stats)
    generated = sum(len(t) for t in tokens)
    row = {"weights": quant or "bf16", "DLI_FUSED_DECODE": int(fused),
           "weight_passes": passes, "admission_waves": len(waves),
           "wall_s": wall, "tokens_per_s": generated / wall,
           "decode_tokens_per_weight_pass": emitted / passes,
           "decode_chunk_ms_per_weight_pass": 1e3 * chunk_s / passes,
           "launches_per_rank": {k: v for k, v in
                                 stats[0]["launches"].items() if v},
           "collectives_per_rank": stats[0]["collectives"]}
    log("  tp=2 batched pass", json.dumps(row))
    return row, tokens


def _tp1_batched_tokens(worker, cfg):
    """Phase 5's bodies through a tp=1 batched bf16 load of ``cfg`` on
    the same seeded weights: each request's tokens, in body order."""
    base = _worker_base(worker)
    st, res = _http(base + "/load_model", dict(BATCHED_LOAD,
                                                model_name=cfg.name))
    assert st == 200 and res["status"] == "success", res
    try:
        bodies = [dict(x, request_tag=f"p21-tp1-{i}")
                  for i, x in enumerate(_batched_bodies(cfg))]
        lines = _stream_lines(base + "/inference_batch",
                              {"model_name": cfg.name, "requests": bodies},
                              None)
    finally:
        st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
        assert st == 200
    msgs = [json.loads(x) for _, x in lines]
    assert all(m["status"] == 200 for m in msgs), msgs
    tags = {m["request_tag"]: m["body"]["tokens"] for m in msgs}
    return [tags[b["request_tag"]] for b in bodies]


def _vs_tp1(got, ref):
    """tp=2's tokens against tp=1's, per request: the tokens they share
    before the first that differs. bf16 partials summed over the ranks
    round otherwise than one GEMM, so a near tie may break the other way
    and the two then go apart; a fault in the tp path would give logits
    unrelated to tp=1's, and next to no first token equal. So at least
    half of the first tokens must be equal."""
    shared = [next((i for i, (a, b) in enumerate(zip(g, r)) if a != b),
                   min(len(g), len(r))) for g, r in zip(got, ref)]
    first = sum(n > 0 for n in shared)
    assert 2 * first >= len(ref), \
        f"tp=2's first tokens equal tp=1's on {first} of {len(ref)}"
    return {"shared_prefix_tokens": shared, "first_token_equal": first,
            "requests": len(ref)}


def _tp_batched_serving(torch):
    """(a): llama-3-8b at full width and TP_SERVING_LAYERS layers through
    the worker, "mesh": {"tp": 2}, "serving": "batched": phase 5's bodies
    on a bf16 load with DLI_FUSED_DECODE=0 and then =1 (over the first
    run's prefixes), each held against a tp=1 load of the same weights
    by ``_vs_tp1``, then on an int4 load; each load takes the phase's
    kept pair and each unload releases it (DLI_TP_KEEP_GROUPS). (b)
    holds the fused gate's on and off runs bitwise equal."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config, register)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = register(get_config("llama-3-8b").replace(
        name=TP_SERVING_NAME, num_layers=TP_SERVING_LAYERS))
    log(f"  (a) depth cut: llama-3-8b at {TP_SERVING_LAYERS} of its 32 "
        "layers (phase 10's; two ranks share the card over gloo)")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    out = {}
    try:
        ref = _tp1_batched_tokens(worker, cfg)
        for quant in (None, "int4"):
            torch.cuda.reset_peak_memory_stats()
            st, res = _http(base + "/load_model", dict(
                BATCHED_LOAD, model_name=cfg.name, mesh={"tp": 2},
                **({"quantize": quant} if quant else {})))
            assert st == 200 and res["status"] == "success", res
            st, health = _http(base + "/health")
            [desc] = health["loaded_models"]
            sched = desc["scheduler"]
            assert sched["mesh"]["tp"] == 2 and sched["ranks"] == 2, sched
            assert sched["decode_graphs_captured"] == 0, sched
            pids = worker.models[cfg.name].batcher._leader.alive()
            log(f"  load_model (batched, tp=2, {quant or 'bf16'}): "
                f"{res['load_time_s']:.2f} s, "
                f"{desc['param_bytes'] / 1e9:.3f} GB of weights per rank, "
                f"data collectives over {sched['backend']}")
            rows = []
            for fused in (False, True) if quant is None else (False,):
                row, toks = _tp_batched_wave(torch, worker, cfg, quant,
                                             fused)
                if quant is None:
                    row["vs_tp1"] = _vs_tp1(toks, ref)
                    log("  tp=2 bf16 against tp=1:",
                        json.dumps(row["vs_tp1"]))
                rows.append(row)
            peak = torch.cuda.max_memory_allocated()
            st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
            assert st == 200 and _released(pids), "the unload kept serving"
            out[quant or "bf16"] = {
                "param_bytes_per_rank": desc["param_bytes"],
                "backend": sched["backend"],
                "leader_peak_memory_bytes": peak, "passes": rows}
    finally:
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _xcheck_prompts(torch, vocab, steps):
    """Phase 11's prompts (37 and 64 tokens) and ``steps`` forced rows."""
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(0, vocab, (2, 64), generator=g)
    forced = torch.randint(0, vocab, (steps, 2), generator=g).tolist()
    return [toks[0, :37].tolist(), toks[1].tolist()], forced


def _served_rows(torch, b, prompts, new):
    """``prompts`` through ``b``'s scheduler, greedy, stepped to the end:
    (tokens, passes, each program's logits rows on the leader) — an
    admission wave's rows, then each decode step's slots, as
    ``Transformer.unembed`` gave them (under tp gathered)."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    rows, unembed = [], b.model.unembed

    def recorded(x):
        out = unembed(x)
        rows.append(out.reshape(-1, out.shape[-1]).cpu())
        return out

    b.model.unembed = recorded
    try:
        reqs = [b.submit(p, max_new_tokens=new,
                         sampling=SamplingParams.greedy(), seed=i)
                for i, p in enumerate(prompts)]
        for _ in range(100):
            b.step()
            if all(r.done.is_set() for r in reqs):
                break
        toks = [r.wait() for r in reqs]
    finally:
        del b.model.unembed
    passes = b.metrics.snapshot()["counters"]["batcher_weight_passes"]
    return toks, passes, rows


def _greedy_rows_xcheck(torch, what, got, ref, tol):
    """Two greedy runs' logits rows, program by program (``_served_rows``:
    tp=2's, tp=1's), every row within ``tol``. Where a row's greedy
    token differs, tp=1's two best logits must lie within twice the
    tolerance of each other (a tie the two summation orders may break
    either way), and the row's slot (every slot, after an admission
    row), fed another token from then on, is compared no further.
    Returns (max_abs_err, rows compared, ties)."""
    atol, rtol = tol
    cut, errs, n, ties = set(), [], 0, 0
    assert len(got) == len(ref), (what, len(got), len(ref))
    for c, (a, b) in enumerate(zip(got, ref)):
        keep = [j for j in range(b.shape[0]) if j not in cut]
        a, b = a[keep], b[keep]
        assert torch.isfinite(a).all() and a.shape == b.shape, what
        err = (a - b).abs()
        assert bool((err <= atol + rtol * b.abs()).all()), \
            f"tp=2 and tp=1 logits disagree ({what}, program {c}: " \
            f"max_abs_err {float(err.max()):.3e})"
        errs.append(float(err.max()))
        n += len(keep)
        for i in (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist():
            top = b[i].topk(2).values
            gap = float(top[0] - top[1])
            assert gap <= 2 * (atol + rtol * float(top[0].abs())), \
                f"{what}: program {c} row {keep[i]} takes another token " \
                f"over a gap of {gap:.3e}"
            ties += 1
            cut.update(range(b.shape[0]) if c == 0 else {keep[i]})
    log(f"  cross-check {what}: full width, 2 layers, f32, {n} logit rows "
        f"through the scheduler: max_abs_err {max(errs):.3e} (tol {atol} + "
        f"{rtol}*|ref|), {ties} near ties")
    return max(errs), n, ties


def _check_xcheck_counts(label, over, stats, L, steps):
    """(b)'s exact counts on every rank: the admission's 128 rows take
    the plain unpack, its head's two gathered rows the kernel; the int8
    pool decodes on the gather route; 2L + 1 all-reduces and a gather
    per forward."""
    int4 = over.get("quant") == "int4"
    want = {"paged_flash_decode": 0 if over.get("kv_quant") else L * steps,
            "fused_decode_step": 0, "flash_attention": 0,
            "flash_decode": 0,
            "q4_matmul": 1 + steps * (5 * L + 1) if int4 else 0,
            "q4_matmul_row": steps * 2 * L if int4 else 0}
    want_c = {"all_reduce": (2 * L + 1) * (steps + 1),
              "gather": steps + 1, "broadcast": 0}
    for s in stats:
        got = {k: s["launches"][k] for k in want}
        assert got == want and s["collectives"] == want_c, \
            (label, {k: v for k, v in s.items() if k != "pool"}, want,
             want_c)
    _same_ranks(stats, f"batcher xcheck {label}")
    _bank21(stats)


def _tp_batcher_xcheck(torch):
    """(b): the batcher's scheduler at tp=2 against tp=1 on the same
    weights (llama-3-8b, full width, 2 layers, f32): two prompts admitted
    in one wave, then 8 greedy decode steps in one chunk, with float and
    int4 weights and an int8 KV pool (whose chunk runs through its side
    buffers and flush), every logits row the leader computed within
    XCHECK_TOL (``_greedy_rows_xcheck``); float at tp=2 again with
    DLI_FUSED_DECODE=1, bitwise equal; every rank's counts exact. The
    int8 pool's levels are held as phase 4 holds an int8 cache's
    (``_level_check``): tp computes K/V through GEMMs of other widths and
    sums, so a value on a rounding boundary takes the next level on one
    side; every rank's pool shard (``rank_stats(pool_blocks)``), side by
    side, against tp=1's pool over the blocks the run wrote. tp=1 runs
    its programs eagerly (DLI_CUDA_GRAPHS=0) so each step's logits are
    seen."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    cfg0 = get_config("llama-3-8b").replace(num_layers=2, dtype="float32")
    L, steps = 2, 8
    prompts, _ = _xcheck_prompts(torch, cfg0.vocab_size, 0)
    kw = dict(num_blocks=64, block_size=16, slots=2, max_seq=128, seed=7,
              device="cuda", kv_host_mb=0, decode_overlap=False)
    blocks = range(1, kw["num_blocks"] + 1)      # 0: the dummy
    out = {}
    for label, over in (("float", {}), ("int4", {"quant": "int4"}),
                        ("int8_kv_pool", {"kv_quant": "int8"})):
        cfg = cfg0.replace(**over)
        runs = {}
        # float: tp=2 once more with DLI_FUSED_DECODE=1, whose gate is
        # off under tp: the same route, so the same bits
        for tp, fused in (((1, "0"), (2, "0"), (2, "1")) if not over
                          else ((1, "0"), (2, "0"))):
            with _Env(DLI_CUDA_GRAPHS="0", DLI_FUSED_DECODE=fused):
                b = ContinuousBatcher(cfg, mesh_spec=MeshSpec(tp=tp), **kw)
                try:
                    b.reset_counts()
                    toks, passes, rows = _served_rows(torch, b, prompts,
                                                      steps + 1)
                    stats = b.rank_stats(pool_blocks=blocks)
                finally:
                    b.stop()
            runs[tp, fused] = (toks, passes, rows, stats)
            del b
            gc.collect()
        runs[1] = runs.pop((1, "0"))
        for key in [k for k in runs if k != 1]:
            toks, passes, rows, stats = runs.pop(key)
            assert passes == steps and len(rows) == steps + 1, \
                (passes, len(rows))
            if key == (2, "1"):
                assert toks == runs[2][0] and all(
                    torch.equal(a, b) for a, b in zip(rows, runs[2][2])), \
                    "tp=2 logits differ with DLI_FUSED_DECODE=1"
            runs[2] = toks, passes, rows, stats
            _check_xcheck_counts(label, over, stats, L, steps)
        toks, passes, rows, stats = runs[2]
        row = {"fused_gate_on_equal": True} if not over else {}
        err, n, ties = _greedy_rows_xcheck(
            torch, f"batcher {label} tp=2 vs tp=1", rows, runs[1][2],
            XCHECK_TOL)
        if not ties:
            assert toks == runs[1][0], (label, toks, runs[1][0])
        if over.get("kv_quant"):
            # k, v, k_scale, v_scale: the ranks' kv heads side by side
            pools = {"cuda": [torch.cat(ls, dim=3)
                              for ls in zip(*(s["pool"] for s in stats))],
                     "cpu": runs[1][3][0]["pool"]}
            written = pools["cpu"][2].flatten(2).ne(0).any(-1).any(0)
            row["levels"] = _level_check(torch, {
                side: types.SimpleNamespace(**{
                    n_: t[:, written] for n_, t in
                    zip(("k", "v", "k_scale", "v_scale"), p)})
                for side, p in pools.items()}, "tp=2 ranks vs tp=1")
            row["blocks_compared"] = int(written.sum())
        row.update(max_abs_err=err, logit_rows=n, near_ties=ties,
                   tokens_equal=toks == runs[1][0])
        out[label] = row
        del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _accepted_drafts(prompt, tokens, gamma):
    """The drafts a greedy prompt-lookup run (``propose_ngram``, gamma
    fixed) accepts when its tokens are ``tokens``: the engine's loop,
    replayed on the host."""
    from distributed_llm_inferencing_tpu_torch.ops.speculative import (
        propose_ngram)
    n, accepted = 1, 0
    while n < len(tokens):
        hist = list(prompt) + tokens[:n]
        drafts = propose_ngram(hist, gamma) or [hist[-1]] * gamma
        k = 0
        while (k < gamma and n + k < len(tokens)
               and drafts[k] == tokens[n + k]):
            k += 1
        accepted += k
        n += k + 1
    return accepted


def _accepting_prompts(torch, eng, vocab, new, gamma):
    """Two prompts ``p + c + p`` (``p`` random, ``c`` the engine's greedy
    continuation of ``p``), each one whose plain greedy tokens the
    n-gram drafts foretell at least once (``_accepted_drafts``), and
    those tokens."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    greedy, g, found = SamplingParams.greedy(), \
        torch.Generator().manual_seed(21), []
    for _ in range(16):
        p = torch.randint(0, vocab, (12,), generator=g).tolist()
        q = p + eng.generate([p], 12, sampling=greedy).tokens[0] + p
        plain = eng.generate([q], new, sampling=greedy).tokens[0]
        if _accepted_drafts(q, plain, gamma):
            found.append((q, plain))
            if len(found) == 2:
                return found
    raise AssertionError(f"{len(found)} of 16 prompts p + c + p draft any "
                         "accepted token")


def _tp_speculation(torch):
    """(b): on two prompts whose drafts the model accepts
    (``_accepting_prompts``; llama-3-8b, 2 layers, f32, tp=2,
    residual_scale SPEC_RESIDUAL_SCALE), the speculative engine's greedy
    tokens equal its plain ones, with drafts accepted
    (fewer verify steps than tokens after the first; no decode kernel in
    a verify step; one broadcast, the leader's outcome, per weight
    pass); the speculative batcher's (wave on, adaptive off) equal a
    plain tp=2 batcher's, with drafts accepted."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    cfg = get_config("llama-3-8b").replace(
        num_layers=2, dtype="float32", residual_scale=SPEC_RESIDUAL_SCALE)
    L, new, gamma, greedy = 2, 24, 4, SamplingParams.greedy()
    out = {}
    eng = InferenceEngine(cfg, mesh_spec=MeshSpec(tp=2), max_seq=256,
                          seed=7, device="cuda")
    try:
        with _Env(DLI_SPEC_ADAPTIVE="0"):
            found = _accepting_prompts(torch, eng, cfg.vocab_size, new,
                                       gamma)
            (prompt, plain), prompts = found[0], [q for q, _ in found]
            eng.reset_counts()
            res = eng.generate([prompt], new, sampling=greedy,
                               speculative="ngram", spec_gamma=gamma)
            stats = eng.rank_stats()
    finally:
        eng.close()
    assert res.tokens == [plain], (res.tokens, plain)
    verify = res.steps - 1
    accepted = len(plain) - 1 - verify
    assert verify > 0 and accepted > 0, (verify, accepted)
    want = {"flash_attention": L, "flash_decode": 0,
            "paged_flash_decode": 0, "fused_decode_step": 0}
    want_c = {"all_reduce": (2 * L + 1) * res.steps, "gather": res.steps,
              "broadcast": res.steps}
    for s in stats:
        got = {k: s["launches"][k] for k in want}
        assert got == want and s["collectives"] == want_c, \
            (s, want, want_c)
    _bank21(stats)
    out["engine"] = {"prompt_tokens": len(prompt), "new_tokens": len(plain),
                     "verify_steps": verify, "accepted_drafts": accepted,
                     "tokens_per_verify_step": (len(plain) - 1) / verify}
    kw = dict(num_blocks=64, block_size=16, slots=2, max_seq=128, seed=7,
              device="cuda", kv_host_mb=0, mesh_spec=MeshSpec(tp=2))
    toks = {}
    for mode in ("plain", "spec"):
        extra = (dict(speculative="ngram", spec_gamma=gamma,
                      spec_adaptive=False, spec_wave=True)
                 if mode == "spec" else {})
        b = ContinuousBatcher(cfg, **kw, **extra)
        try:
            b.reset_counts()
            reqs = [b.submit(p, max_new_tokens=new, sampling=greedy,
                             seed=i) for i, p in enumerate(prompts)]
            for _ in range(200):
                b.step()
                if all(r.done.is_set() for r in reqs):
                    break
            toks[mode] = [r.wait() for r in reqs]
            stats = b.rank_stats()
            _same_ranks(stats, f"batcher {mode}")
            _bank21(stats)
            if mode == "spec":
                spec_chunks = len(b._spec_progs)
                c = b.metrics.snapshot()["counters"]
                out["batcher"] = {
                    "weight_passes": c["batcher_weight_passes"],
                    "tokens_emitted": c["batcher_tokens_emitted"],
                    "spec_accepted_tokens":
                        b.stats()["spec_accepted_tokens"]}
                assert spec_chunks > 0 and c["batcher_weight_passes"] > 0
                assert out["batcher"]["spec_accepted_tokens"] > 0, out
        finally:
            b.stop()
    assert toks["spec"] == toks["plain"], toks
    log("  tp=2 speculation", json.dumps(out))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_family_cfg(row):
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    if row in LATER_XCHECK:
        cfg, _ = _later_xcheck_cfg(row)
    else:
        cfg = get_config(row).replace(num_layers=2)
    return cfg.replace(dtype="float32")


def _tp_families(torch):
    """(c): each TP_FAMILY_ROWS shape, 2 layers, f32, through the engine
    at tp=1 and tp=2 on the same seeded weights: a teacher-forced prefill
    of two prompts plus 4 decode steps within XCHECK_TOL, every rank's
    counts exact (one f32 flash_attention per layer, one flash_decode per
    layer per step; the all-reduces by ``_tp_all_reduces``)."""
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    out, steps = {}, 4
    for row in TP_FAMILY_ROWS:
        cfg = _tp_family_cfg(row)
        L = cfg.num_layers
        prompts, forced = _xcheck_prompts(torch, cfg.vocab_size, steps)
        t0 = time.perf_counter()
        one = InferenceEngine(cfg, max_seq=96, seed=7, device="cuda")
        pre1, dec1 = one.teacher_forced(prompts, forced)
        del one
        gc.collect()
        two = InferenceEngine(cfg, mesh_spec=MeshSpec(tp=2), max_seq=96,
                              seed=7, device="cuda")
        try:
            two.reset_counts()
            pre2, dec2 = two.teacher_forced(prompts, forced)
            stats = two.rank_stats()
            local = (two.model.layers[0].heads, two.model.layers[0].kv_heads)
        finally:
            two.close()
        want = {"flash_attention": L, "flash_attention[mma]": 0,
                "flash_decode": L * steps, "paged_flash_decode": 0,
                "fused_decode_step": 0}
        want_c = {"all_reduce": _tp_all_reduces(cfg) * (steps + 1),
                  "gather": steps + 1, "broadcast": 0}
        for s in stats:
            got = {k: s["launches"][k] for k in want}
            assert got == want and s["collectives"] == want_c, \
                (row, s, want, want_c)
        _bank21(stats)
        a, b = (torch.cat([p[0, :37], p[1], d.reshape(-1, d.shape[-1])])
                for p, d in ((pre2, dec2), (pre1, dec1)))
        err = _xcheck(torch, f"{row} tp=2 vs tp=1 (2 layers, f32)", a, b)
        out[row] = {"max_abs_err": err, "local_heads": local,
                    "all_reduce_per_pass": _tp_all_reduces(cfg),
                    "seconds": time.perf_counter() - t0}
        del two
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_tp_batched(torch, smi, spawn_s=None, keep=False):
    """Phase 21 (see the module docstring). ``spawn_s``: the spawn of the
    kept pair phase 11 made (and (b) takes), else (b) spawns it here;
    ``keep``: leave the pair for phase 22, else stop it."""
    from distributed_llm_inferencing_tpu_torch.runtime import lockstep
    report, t_all = {"smi": smi}, time.perf_counter()
    _PHASE21_LAUNCHES.clear()
    # every tp model of the phase, the worker's included, takes the group
    # the last one released (DLI_TP_KEEP_GROUPS; runtime/lockstep.py), so
    # the phase spawns at most once; the spawn and the stop are timed
    acquired, take = [0], lockstep.leader

    def counted(*a):
        acquired[0] += 1
        return take(*a)

    lockstep.leader = counted
    try:
        with _Env(DLI_TP_KEEP_GROUPS="1"):
            t0 = time.perf_counter()
            counted(2, torch.device("cuda")).stop()
            report["group_spawn_s"] = (time.perf_counter() - t0
                                       if spawn_s is None else spawn_s)
            report["serving"] = _tp_batched_serving(torch)
            report["seconds_serving"] = time.perf_counter() - t0
        with _Env(DLI_TP_KEEP_GROUPS="1", DLI_FUSED_DECODE="0"):
            for key, fn in (("batcher_xcheck", _tp_batcher_xcheck),
                            ("speculation", _tp_speculation),
                            ("families", _tp_families)):
                t0 = time.perf_counter()
                report[key] = fn(torch)
                report[f"seconds_{key}"] = time.perf_counter() - t0
                log(f"  phase 21 {key}: {report[f'seconds_{key}']:.1f} s")
    finally:
        lockstep.leader = take
        t0 = time.perf_counter()
        if not keep:
            lockstep.stop_idle_groups()
        report["group_stop_s"] = time.perf_counter() - t0
    # the first acquisition spawned (or took phase 11's pair); every
    # later one, the worker's loads included, reused the group
    report["tp_models_on_one_group"] = acquired[0] - 1
    log(f"  phase 21: {acquired[0] - 1} tp models on one kept group; a "
        f"spawn took {report['group_spawn_s']:.2f} s"
        + ("" if keep else f", the stop {report['group_stop_s']:.2f} s")
        + f" [{smi}]")
    report["launches"] = dict(_PHASE21_LAUNCHES)
    log("  phase 21 launches (every rank):", json.dumps(report["launches"]))
    report["seconds"] = time.perf_counter() - t_all
    log(f"  phase 21 wall time: {report['seconds']:.1f} s [{smi}]")
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase21.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report


# ---------------------------------------------------------------------
# phase 22: pipeline and sequence parallelism (pp x sp x tp grids)
# ---------------------------------------------------------------------

PP_SP_LONG = 4096          # (b)'s prompt tokens
PP_SP_NEW = 32             # tokens generated per (a) engine / (b) request
_PHASE22_LAUNCHES: dict = {}


def _bank22(stats):
    """Add every rank's launches of ``stats`` to phase 22's total."""
    for s in stats:
        for k, v in s["launches"].items():
            _PHASE22_LAUNCHES[k] = _PHASE22_LAUNCHES.get(k, 0) + v


def _pp_stage_counts(stats, pp):
    """Per stage (from each stage's tp rank 0): weights, launches and hops,
    for the report."""
    return {s["grid"]["pp"]: {
        "param_bytes": s["param_bytes"], "layers": s["layers"],
        "launches": {k: v for k, v in s["launches"].items() if v},
        "collectives": s["collectives"]}
        for s in stats if s["grid"]["tp"] == 0 and s["grid"]["sp"] == 0}


def _pp_batched_want(L_loc, pp, last, passes, chunks, waves, quant, fused):
    """Phase 22's rule for one stage of a pp batched pass: every decode
    pass runs the stage's layers once per microbatch (pp of them), on the
    fused or the paged kernel; an admission runs the plain prefix
    attention. In int4 each microbatch step's 7 linears per layer go to
    q4_matmul (its rows R/pp <= 32), plus the head on the last stage; an
    admission wave of ``rows`` tokens (``waves``: per wave b·t, b rows)
    microbatches into pp parts whose layers take the kernel at <= 32
    rows, and whose head rows (b/pp) always do. Hops: stage 0 sends pp
    per pass and per wave and receives the last stage's tokens pp per
    pass but the last of each chunk; the last stage the reverse; one
    broadcast (the last stage's outputs) per program."""
    route = "fused_decode_step" if fused else "paged_flash_decode"
    want = {"paged_flash_decode": 0, "fused_decode_step": 0,
            "flash_attention": 0, "flash_decode": 0, "q4_matmul": 0,
            "q4_matmul_row": 0}
    want[route] = L_loc * pp * passes
    if quant == "int4":
        want["q4_matmul"] = pp * passes * (7 * L_loc + last) + sum(
            pp * (7 * L_loc * (rows // pp <= 32) + last)
            for rows, _ in waves)
    return want


def _pp_hops_want(p, pp, passes, chunks, waves):
    out = pp * (passes + waves)
    back = pp * (passes - chunks)
    sends, recvs = (out, back) if p == 0 else (back, out)
    if 0 < p < pp - 1:
        sends = recvs = out
    return {"send": sends, "recv": recvs, "broadcast": chunks + waves}


def _pp_batched_wave(torch, worker, cfg, quant, fused):
    """Phase 5's bodies as one /inference_batch through the loaded pp=2
    batched model: every rank's counts zeroed before and held after by
    ``_pp_batched_want`` / ``_pp_hops_want`` per stage, every rank's
    programs and digests equal. Returns (row, tokens)."""
    from distributed_llm_inferencing_tpu_torch.parallel import (
        paged_pipeline)
    name, pp = cfg.name, 2
    b = worker.models[name].batcher
    L_loc = cfg.num_layers // pp
    waves, chunks = [], [0]
    take_w, take_c = (paged_pipeline.prefill_tail_pp,
                      paged_pipeline.decode_chunk_pp)

    def wave(model, group, tokens, *a, **kw):
        waves.append((tokens.shape[0] * tokens.shape[1], tokens.shape[0]))
        return take_w(model, group, tokens, *a, **kw)

    def chunk(*a, **kw):
        chunks[0] += 1
        return take_c(*a, **kw)

    paged_pipeline.prefill_tail_pp = wave
    paged_pipeline.decode_chunk_pp = chunk
    bodies = [dict(x, request_tag=f"p22-{quant}-{fused}-{i}")
              for i, x in enumerate(_batched_bodies(cfg))]
    try:
        s0 = worker.metrics.snapshot()
        b.reset_counts()
        t0 = time.perf_counter()
        with _Env(DLI_FUSED_DECODE="1" if fused else "0"):
            lines = _stream_lines(
                _worker_base(worker) + "/inference_batch",
                {"model_name": name, "requests": bodies}, None)
        wall = time.perf_counter() - t0
        stats = b.rank_stats()
        s1 = worker.metrics.snapshot()
    finally:
        paged_pipeline.prefill_tail_pp = take_w
        paged_pipeline.decode_chunk_pp = take_c
    passes, emitted = (s1["counters"][k] - s0["counters"].get(k, 0)
                       for k in ("batcher_weight_passes",
                                 "batcher_tokens_emitted"))
    chunk_s = (s1["timings"]["batcher_decode_chunk"]["sum"]
               - s0["timings"].get("batcher_decode_chunk", {}).get("sum", 0))
    msgs = [json.loads(x) for _, x in lines]
    assert all(m["status"] == 200 for m in msgs), msgs
    tags = {m["request_tag"]: m["body"]["tokens"] for m in msgs}
    tokens = [tags[x["request_tag"]] for x in bodies]
    lead = stats[0]
    for s in stats:
        p = s["grid"]["pp"]
        want = _pp_batched_want(L_loc, pp, int(p == pp - 1), passes,
                                chunks[0], waves, quant, fused)
        got = {k: s["launches"][k] for k in want}
        assert got == want, f"stage {p}: launches {got} != {want}"
        assert s["launches"]["q4_matmul[mma]"] == want["q4_matmul"]
        hops = _pp_hops_want(p, pp, passes, chunks[0], len(waves))
        got_h = {k: s["collectives"][k] for k in hops}
        assert got_h == hops, f"stage {p}: hops {got_h} != {hops}"
        assert s["programs_run"] == lead["programs_run"] and \
            s["outputs_digest"] == lead["outputs_digest"], s
    _bank22(stats)
    generated = sum(len(t) for t in tokens)
    row = {"weights": quant or "bf16", "DLI_FUSED_DECODE": int(fused),
           "weight_passes": passes, "decode_chunks": chunks[0],
           "admission_waves": len(waves), "wall_s": wall,
           "tokens_per_s": generated / wall,
           "decode_tokens_per_weight_pass": emitted / passes,
           "decode_chunk_ms_per_weight_pass": 1e3 * chunk_s / passes,
           "stages": _pp_stage_counts(stats, pp)}
    log("  pp=2 batched pass", json.dumps(row))
    return row, tokens


def _released(pids):
    """Whether the group of follower ``pids`` is kept idle (released by
    an unload under DLI_TP_KEEP_GROUPS), not serving and not gone."""
    from distributed_llm_inferencing_tpu_torch.runtime import lockstep
    return any(ld.alive() == pids for lds in lockstep._IDLE.values()
               for ld in lds)


def _pp_batched_serving(torch, ref):
    """(a) batched: llama-3-8b at full width and depth through the worker
    with "mesh": {"pp": 2} (16 layers per stage, both ranks on the card
    over gloo): phase 5's bodies with DLI_FUSED_DECODE off and then on
    over the first run's prefixes, held against the pp=1 tokens ``ref``
    by ``_vs_tp1``; then on an int4 load. Each load takes the kept pair
    and each unload releases it (DLI_TP_KEEP_GROUPS)."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    out = {}
    try:
        if ref is None:    # phase 22 alone: the pp=1 load's tokens here
            ref = _tp1_batched_tokens(worker, cfg)
        for quant in (None, "int4"):
            torch.cuda.reset_peak_memory_stats()
            st, res = _http(base + "/load_model", dict(
                BATCHED_LOAD, mesh={"pp": 2},
                **({"quantize": quant} if quant else {})))
            assert st == 200 and res["status"] == "success", res
            st, health = _http(base + "/health")
            [desc] = health["loaded_models"]
            sched = desc["scheduler"]
            assert sched["mesh"]["pp"] == 2 and sched["ranks"] == 2, sched
            assert sched["decode_graphs_captured"] == 0, sched
            pids = worker.models[cfg.name].batcher._leader.alive()
            log(f"  load_model (batched, pp=2, {quant or 'bf16'}): "
                f"{res['load_time_s']:.2f} s, "
                f"{desc['param_bytes'] / 1e9:.3f} GB of weights on stage "
                f"0, data over {sched['backend']}")
            rows = []
            for fused in (False, True) if quant is None else (False,):
                row, toks = _pp_batched_wave(torch, worker, cfg, quant,
                                             fused)
                if quant is None:
                    row["vs_pp1"] = _vs_tp1(toks, ref)
                    log("  pp=2 bf16 against pp=1:",
                        json.dumps(row["vs_pp1"]))
                rows.append(row)
            peak = torch.cuda.max_memory_allocated()
            st, _ = _http(base + "/unload_model", {"model_name": cfg.name})
            assert st == 200 and _released(pids), "the unload kept serving"
            out[quant or "bf16"] = {"leader_peak_memory_bytes": peak,
                                    "passes": rows}
    finally:
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_engine_serving(torch, ref):
    """(a) engine: llama-3-8b bf16, full depth, "mesh": {"pp": 2} through
    the worker: phase 3's 500-token request (32 tokens) against its pp=1
    tokens ``ref`` (``_vs_tp1``; one microbatch, so the stages run pp=1's
    GEMM shapes and the tokens should be equal, which is reported); per
    stage one flash_attention (tensor-core form) per local layer for the
    prefill and one flash_decode per local layer per decode step; per
    forward one hop out and one in on each stage, one broadcast (the
    leader's token) per weight pass."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    n_tok, sampling, seed = ENGINE_REQUESTS[2]
    body = {"model_name": cfg.name, "prompt": engine_prompt(n_tok, seed),
            "max_new_tokens": PP_SP_NEW, "sampling": sampling, "seed": seed}
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = _worker_base(worker)
    try:
        if ref is None:    # phase 22 alone: the pp=1 engine's tokens here
            st, res = _http(base + "/load_model", {
                "model_name": cfg.name, "allow_random_init": True,
                "dtype": "bfloat16", "max_seq": 4096})
            assert st == 200, res
            st, r = _http(base + "/inference", body)
            assert st == 200 and r["status"] == "success", r
            ref = r["tokens"]
            assert _http(base + "/unload_model",
                         {"model_name": cfg.name})[0] == 200
        st, res = _http(base + "/load_model", {
            "model_name": cfg.name, "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096, "mesh": {"pp": 2}})
        assert st == 200 and res["status"] == "success", res
        eng = worker.models[cfg.name].engine
        pids = eng._leader.alive()
        eng.reset_counts()
        st, r = _http(base + "/inference", body)
        assert st == 200 and r["status"] == "success", r
        stats = eng.rank_stats()
        passes, L_loc = r["cost"]["weight_passes"], cfg.num_layers // 2
        want = {"flash_attention": L_loc, "flash_attention[mma]": L_loc,
                "flash_decode": L_loc * (passes - 1),
                "paged_flash_decode": 0, "fused_decode_step": 0,
                "q4_matmul": 0}
        for s in stats:
            got = {k: s["launches"][k] for k in want}
            assert got == want, f"stage {s['grid']['pp']}: {got} != {want}"
            hops = {"send": passes, "recv": passes, "broadcast": passes}
            got_h = {k: s["collectives"][k] for k in hops}
            assert got_h == hops, (s["grid"], got_h, hops)
        _bank22(stats)
        row = {"prompt_tokens": n_tok, "new_tokens": len(r["tokens"]),
               "weight_passes": passes, "prefill_ms": r["prefill_ms"],
               "decode_ms_per_weight_pass": r["decode_ms"] / (passes - 1),
               "vs_pp1": _vs_tp1([r["tokens"]], [ref]),
               "tokens_equal_pp1": r["tokens"] == ref,
               "stages": _pp_stage_counts(stats, 2)}
        log("  pp=2 engine request", json.dumps(row))
        assert _http(base + "/unload_model",
                     {"model_name": cfg.name})[0] == 200
        assert _released(pids), "the unload kept serving"
    finally:
        worker.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _sp_long_prompt(torch):
    """(b): llama-3-8b at full width and depth in f32 (the weights
    replicate over sp: 2 x 32 GB on the card), one PP_SP_LONG-token
    prompt and PP_SP_NEW greedy tokens through the engine at sp=1 and
    sp=2 on the same seeded weights: the prefill's last logits and every
    decode step's within XCHECK_TOL (teacher-forced on sp=1's tokens),
    the tokens equal; per rank sp - 1 ring hops per layer per prefill,
    one combine per layer per decode step plus the prefill's logits, no
    attention kernel (the ring is plain torch); prefill ms at both."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    cfg = get_config("llama-3-8b").replace(dtype="float32")
    L, greedy = cfg.num_layers, SamplingParams.greedy()
    g = torch.Generator().manual_seed(22)
    prompt = torch.randint(0, cfg.vocab_size, (PP_SP_LONG,),
                           generator=g).tolist()
    max_seq = PP_SP_LONG + 2 * PP_SP_NEW
    out = {}
    runs = {}
    for sp in (1, 2):
        eng = InferenceEngine(cfg, mesh_spec=MeshSpec(sp=sp),
                              max_seq=max_seq, seed=3, device="cuda")
        try:
            res = eng.generate([prompt], PP_SP_NEW, sampling=greedy)
            forced = [[t] for t in (runs[1][0] if sp == 2
                                    else res.tokens[0])[:-1]]
            eng.reset_counts()
            t0 = time.perf_counter()
            last, dec = eng.teacher_forced([prompt], forced, last_only=True)
            tf_s = time.perf_counter() - t0
            stats = eng.rank_stats()
        finally:
            eng.close()
        runs[sp] = (res.tokens[0], res.prefill_ms, last, dec, stats, tf_s)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    toks2, pre2_ms, last2, dec2, stats, _ = runs[2]
    toks1, pre1_ms, last1, dec1, _, _ = runs[1]
    steps = len(dec1)
    for s in stats:
        c = s["collectives"]
        assert c["ring"] == L and c["combine"] == L * steps + 1, s
        assert not any(s["launches"][k] for k in (
            "flash_attention", "flash_decode", "paged_flash_decode",
            "fused_decode_step")), s["launches"]
    _bank22(stats)
    a = torch.cat([last2, dec2.reshape(-1, dec2.shape[-1])])
    b = torch.cat([last1, dec1.reshape(-1, dec1.shape[-1])])
    err = _xcheck(torch, f"sp=2 vs sp=1 ({PP_SP_LONG}-token prompt, full "
                  "depth)", a, b)
    assert toks2 == toks1, (toks2, toks1)
    out = {"prompt_tokens": PP_SP_LONG, "new_tokens": len(toks1),
           "max_abs_err": err, "tokens_equal": True,
           "prefill_ms_sp1": pre1_ms, "prefill_ms_sp2": pre2_ms,
           "ring_hops_per_rank": stats[0]["collectives"]["ring"],
           "combines_per_rank": stats[0]["collectives"]["combine"],
           "param_bytes_per_rank": stats[0]["param_bytes"]}
    log("  sp=2 long prompt", json.dumps(out))
    return out


def _pp_pool_check(torch, label, stats_pp, stats_one, int8):
    """The pp=2 stages' pool slices (layers side by side) against pp=1's
    pool over the blocks: float within XCHECK_TOL, an int8 pool's levels
    by ``_level_check``."""
    pools = [torch.cat(ls, dim=0) for ls in zip(
        *(s["pool"] for s in sorted(stats_pp,
                                    key=lambda s: s["grid"]["pp"])
          if s["grid"]["tp"] == 0))]
    one = stats_one[0]["pool"]
    if not int8:
        err = float(max((a - b).abs().max() for a, b in zip(pools, one)))
        atol, rtol = XCHECK_TOL
        assert all(bool(((a - b).abs() <= atol + rtol * b.abs()).all())
                   for a, b in zip(pools, one)), (label, err)
        return {"pool_max_abs_err": err}
    written = one[2].flatten(2).ne(0).any(-1).any(0)
    return {"levels": _level_check(torch, {
        side: types.SimpleNamespace(**{
            n: t[:, written] for n, t in
            zip(("k", "v", "k_scale", "v_scale"), p)})
        for side, p in (("cuda", pools), ("cpu", one))},
        f"{label} pp=2 stages vs pp=1")}


def _pp_batcher_xcheck(torch):
    """(c) the pp=2 batcher's scheduler against pp=1 on the same weights
    (llama-3-8b, full width, 2 layers, f32): two prompts in one
    admission wave, then 8 greedy decode steps; float and int4 weights
    and an int8 pool: the tokens equal and the stages' pool slices,
    layers side by side, against pp=1's pool (the K/V every layer wrote,
    which the last layer's output and the next step's input rest on;
    the leader, stage 0, computes no logits); every rank's programs and
    digests equal."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    cfg0 = get_config("llama-3-8b").replace(num_layers=2, dtype="float32")
    prompts, _ = _xcheck_prompts(torch, cfg0.vocab_size, 0)
    kw = dict(num_blocks=64, block_size=16, slots=2, max_seq=128, seed=7,
              device="cuda", kv_host_mb=0, decode_overlap=False)
    blocks = range(1, kw["num_blocks"] + 1)
    out = {}
    for label, over in (("float", {}), ("int4", {"quant": "int4"}),
                        ("int8_kv_pool", {"kv_quant": "int8"})):
        cfg = cfg0.replace(**over)
        runs = {}
        for pp in (1, 2):
            with _Env(DLI_CUDA_GRAPHS="0", DLI_FUSED_DECODE="0"):
                b = ContinuousBatcher(cfg, mesh_spec=MeshSpec(pp=pp), **kw)
                try:
                    b.reset_counts()
                    toks, passes, _ = _served_rows(torch, b, prompts, 9)
                    stats = b.rank_stats(pool_blocks=blocks)
                finally:
                    b.stop()
            runs[pp] = (toks, stats)
            del b
            gc.collect()
        toks, stats = runs[2]
        assert toks == runs[1][0], (label, toks, runs[1][0])
        lead = stats[0]
        assert all(s["outputs_digest"] == lead["outputs_digest"]
                   for s in stats), label
        _bank22(stats)
        out[label] = dict(_pp_pool_check(torch, label, stats, runs[1][1],
                                         bool(over.get("kv_quant"))),
                          tokens_equal=True)
        log(f"  pp=2 batcher {label}:", json.dumps(out[label]))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_speculation(torch):
    """(c) speculation at pp=2 (llama-3-8b, 2 layers, f32, the sublayers
    scaled by SPEC_RESIDUAL_SCALE): on two prompts whose drafts the model
    accepts, the speculative batcher's chunk (wave off) and wave mode
    (on), adaptive off, give the plain pp=2 batcher's greedy tokens, with
    drafts accepted."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    cfg = get_config("llama-3-8b").replace(
        num_layers=2, dtype="float32", residual_scale=SPEC_RESIDUAL_SCALE)
    new, gamma, greedy = 24, 4, SamplingParams.greedy()
    one = InferenceEngine(cfg, max_seq=256, seed=7, device="cuda")
    with _Env(DLI_SPEC_ADAPTIVE="0"):
        prompts = [q for q, _ in _accepting_prompts(
            torch, one, cfg.vocab_size, new, gamma)]
    del one
    gc.collect()
    kw = dict(num_blocks=64, block_size=16, slots=2, max_seq=128, seed=7,
              device="cuda", kv_host_mb=0, mesh_spec=MeshSpec(pp=2))
    toks, out = {}, {}
    for mode in ("plain", "chunk", "wave"):
        extra = ({} if mode == "plain" else dict(
            speculative="ngram", spec_gamma=gamma, spec_adaptive=False,
            spec_wave=mode == "wave"))
        b = ContinuousBatcher(cfg, **kw, **extra)
        try:
            b.reset_counts()
            reqs = [b.submit(p, max_new_tokens=new, sampling=greedy,
                             seed=i) for i, p in enumerate(prompts)]
            for _ in range(200):
                b.step()
                if all(r.done.is_set() for r in reqs):
                    break
            toks[mode] = [r.wait() for r in reqs]
            stats = b.rank_stats()
            assert all(s["outputs_digest"] == stats[0]["outputs_digest"]
                       for s in stats), mode
            _bank22(stats)
            if mode != "plain":
                acc = b.stats()["spec_accepted_tokens"]
                assert acc > 0, (mode, acc)
                out[mode] = {"spec_accepted_tokens": acc,
                             "weight_passes": b.metrics.snapshot()[
                                 "counters"]["batcher_weight_passes"]}
        finally:
            b.stop()
        del b
        gc.collect()
    assert toks["chunk"] == toks["plain"] and toks["wave"] == toks["plain"]
    log("  pp=2 speculation", json.dumps(out))
    torch.cuda.empty_cache()
    return out


def _pp_sp_xcheck(torch, label, cfg, spec, steps=4, max_seq=96,
                  n_micro=None):
    """An engine on ``spec`` (``n_micro``: its pipeline microbatches)
    against one device on the same seeded weights (2 layers, f32): a
    teacher-forced prefill of phase 11's two prompts and ``steps`` decode
    steps within XCHECK_TOL."""
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)
    prompts, forced = _xcheck_prompts(torch, cfg.vocab_size, steps)
    got = {}
    for key, mesh in (("one", None), ("grid", spec)):
        eng = InferenceEngine(cfg, mesh_spec=mesh, max_seq=max_seq, seed=7,
                              device="cuda", pipeline_microbatches=n_micro)
        try:
            eng.reset_counts()
            got[key] = eng.teacher_forced(prompts, forced)
            if key == "grid":
                stats = eng.rank_stats()
        finally:
            eng.close()
        del eng
        gc.collect()
    _bank22(stats)
    a, b = (torch.cat([p[0, :37], p[1], d.reshape(-1, d.shape[-1])])
            for p, d in (got["grid"], got["one"]))
    err = _xcheck(torch, f"{label} {spec.axis_sizes()} vs one device", a, b)
    return {"max_abs_err": err,
            "collectives": {str(tuple(s["grid"].values())): s["collectives"]
                            for s in stats}}


def _pp_sp_rows(torch):
    """(c): one row each for pp x tp (float and int4 weights), sp x tp
    and pp x sp on one 4-rank group (llama-3-8b, 2 layers, f32); rows
    under pp=2: gemma-2's
    per-layer windows and tied head, mixtral's experts (moe-proxy-8e
    shapes), deepseek-proxy's latent attention (materialized; no dense
    prefix); rows under sp=2: a window (Qwen2-7B, cut to XCHECK_WINDOW),
    bloom's ALiBi, gemma-2's softcaps."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
    out = {}
    llama = get_config("llama-3-8b").replace(num_layers=2, dtype="float32")
    for label, cfg, spec in (
            ("pp2_tp2", llama, MeshSpec(pp=2, tp=2)),
            # int4 weights: a stage's o and down through q4_matmul_row
            ("pp2_tp2_int4", llama.replace(quant="int4"),
             MeshSpec(pp=2, tp=2)),
            ("sp2_tp2", llama, MeshSpec(sp=2, tp=2)),
            ("pp2_sp2", llama, MeshSpec(pp=2, sp=2))):
        out[label] = _pp_sp_xcheck(torch, label, cfg, spec)
    gemma2 = _tp_family_cfg("gemma2")
    # the expert rows run one microbatch: capacity dispatch sizes each
    # expert's slots by the positions of the call, a microbatch's under
    # pp (as the JAX pipeline), so two microbatches drop other choices
    # than one device's batch (NVIDIA H100: 2.375 and 3.420 at
    # two)
    rows = (("pp2_gemma2", gemma2, MeshSpec(pp=2), None),
            ("pp2_experts", get_config("moe-proxy-8e").replace(
                num_layers=2, dtype="float32"), MeshSpec(pp=2), 1),
            ("pp2_latent", get_config("deepseek-proxy").replace(
                num_layers=2, dense_prefix_layers=0, dtype="float32"),
             MeshSpec(pp=2), 1),
            ("sp2_window", get_config("qwen2-7b").replace(
                num_layers=2, dtype="float32",
                sliding_window=XCHECK_WINDOW), MeshSpec(sp=2), None),
            ("sp2_alibi", _tp_family_cfg("bloom-7b1"), MeshSpec(sp=2),
             None),
            ("sp2_softcap", gemma2, MeshSpec(sp=2), None))
    for label, cfg, spec, n_micro in rows:
        t0 = time.perf_counter()
        out[label] = _pp_sp_xcheck(torch, label, cfg, spec,
                                   n_micro=n_micro)
        out[label]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def phase_pp_sp(torch, smi, refs=None):
    """Phase 22 (see the module docstring). ``refs``: phase 5's paged
    pp=1 tokens and phase 3's 500-token request's, when they ran."""
    from distributed_llm_inferencing_tpu_torch.runtime import lockstep
    refs = refs or {}
    report, t_all = {"smi": smi}, time.perf_counter()
    _PHASE22_LAUNCHES.clear()
    # every model of the phase on one kept pair (phase 11's, when it ran)
    # and one kept group of four
    try:
        with _Env(DLI_TP_KEEP_GROUPS="1", DLI_FUSED_DECODE="0"):
            for key, fn in (
                    ("batched", lambda: _pp_batched_serving(
                        torch, refs.get("batched"))),
                    ("engine", lambda: _pp_engine_serving(
                        torch, refs.get("engine"))),
                    ("sp_long", lambda: _sp_long_prompt(torch)),
                    ("batcher_xcheck", lambda: _pp_batcher_xcheck(torch)),
                    ("speculation", lambda: _pp_speculation(torch)),
                    ("rows", lambda: _pp_sp_rows(torch))):
                t0 = time.perf_counter()
                report[key] = fn()
                report[f"seconds_{key}"] = time.perf_counter() - t0
                log(f"  phase 22 {key}: {report[f'seconds_{key}']:.1f} s")
    finally:
        lockstep.stop_idle_groups()
    report["launches"] = dict(_PHASE22_LAUNCHES)
    log("  phase 22 launches (every rank):", json.dumps(report["launches"]))
    for name in ("flash_attention", "flash_decode", "paged_flash_decode",
                 "fused_decode_step", "q4_matmul", "q4_matmul_row"):
        assert report["launches"].get(name, 0) > 0, \
            f"{name} never launched on phase 22's path"
    report["seconds"] = time.perf_counter() - t_all
    log(f"  phase 22 wall time: {report['seconds']:.1f} s [{smi}]")
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "phase22.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report


def timed_rows(torch):
    """Phase 2's timed rows alone (every kernel at its serving shapes,
    with its bound, plain and library times), for comparing two trees'
    kernels in one call: ``python3 chip_smoke.py --timed-rows`` from
    each tree's root times that tree's kernels."""
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops import (
        flash_attention as fa, fused_decode as fd, paged_attention as pa,
        quant_matmul as qm)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, serve = torch.bfloat16, [0, 1, 15, 16, 17, 300, 1000, 4096]
    rows = [check_prefill(torch, fa, sdpa, 1, 4096, 32, 8, 128, bf16,
                          timing=True)]
    rows += [check_decode(torch, fa, sdpa, lens, 4096, H, Hkv, 128, bf16,
                          timing=True)
             for lens, H, Hkv in (([1, 37, 1000, 4096], 32, 8),
                                  ([532], 32, 8), ([4096], 32, 8),
                                  ([4096], 16, 4))]
    rows.append(check_paged(torch, pa, sdpa, serve, 32, 8, 128, bf16,
                            nb=2048, timing=True))
    rows += [check_fused(torch, fd, lens, 32, 8, 128, 4096, bf16, nb=nb,
                         timing=True, form=form, disjoint=disjoint)
             for form in ("float", "int8", "int4")
             for lens, nb, disjoint in ((serve, 2048, False),
                                        ([4096] * 8, 8 * 256 + 1, True))]
    cfg = get_config("llama-3-8b")
    rank = ((cfg.num_heads * cfg.head_dim // 2, cfg.hidden_size),
            (cfg.intermediate_size // 2, cfg.hidden_size))
    for b in (8, 1):
        rows += [check_q4(torch, qm, b, din, dout, bf16, timing=True)
                 for din, dout in Q4_SHAPES.values()]
        rows += [check_q4(torch, qm, b, din, dout, bf16, timing=True,
                          chunks=1) for din, dout in rank]
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from distributed_llm_inferencing_tpu_torch.ops import build
        from distributed_llm_inferencing_tpu_torch.ops import (
            flash_attention as fa, fused_decode as fd, paged_attention as pa,
            quant_matmul as qm)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    # every kernel wrapper's launch counter, by kernel name
    counted = {name: (mod, name, "launches") for mod, name in (
        (fa, "flash_attention"), (fa, "flash_decode"),
        (pa, "paged_flash_decode"), (fd, "fused_decode_step"),
        (qm, "q4_matmul"), (qm, "q4_matmul_row"))}
    # the tensor-core launches among flash_attention's and the q4 kernels'
    for mod, name in ((fa, "flash_attention"), (qm, "q4_matmul"),
                      (qm, "q4_matmul_row")):
        counted[f"{name}[mma]"] = (mod, name, "launches_mma")

    phase_s, last = {}, [None, time.perf_counter()]

    def mark(n, text=None):
        """Log phase ``n``'s header; record the wall time of the one
        before it (``n`` None: close the last)."""
        now = time.perf_counter()
        if last[0] is not None:
            phase_s[last[0]] = now - last[1]
            log(f"  phase {last[0]} took {phase_s[last[0]]:.1f} s")
        last[:] = [n, now]
        if n is not None:
            log(f"phase {n}: {text}")

    if sys.argv[1:2] == ["--digests"]:   # the attention kernels' bits only
        build.build_all(["flash_attention", "paged_attention"])
        log("  digests", json.dumps(uncapped_digests(torch)))
        return 0
    mark(1, "build")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    if sys.argv[1:2] == ["--kv-plane"]:   # phase 17 alone
        report = phase_kv_plane(torch, fa, qm, counted, smi)
        log("  kv plane seconds:", json.dumps(
            {k: round(v, 1) for k, v in report.items()
             if k.startswith("seconds")}))
        log(smi)
        return 0
    if sys.argv[1:2] == ["--spec-migrate"]:   # phase 18 alone
        phase_spec_migrate(torch, counted, smi)
        log(smi)
        return 0
    if sys.argv[1:2] == ["--lora-moe"]:   # phase 19 alone
        phase_lora_moe(torch, counted, smi)
        log(smi)
        return 0
    if sys.argv[1:2] == ["--experts-mla"]:   # phase 20 alone
        phase_experts_mla(torch, fa, qm, counted, smi)
        log(smi)
        return 0
    if sys.argv[1:2] == ["--tp-batched"]:   # phase 21 alone
        phase_tp_batched(torch, smi)
        log(smi)
        return 0
    if sys.argv[1:2] == ["--pp-sp"]:   # phase 22 alone
        phase_pp_sp(torch, smi)
        log(smi)
        return 0
    if sys.argv[1:2] == ["--timed-rows"]:
        rows = timed_rows(torch)
        for row in rows:
            log("  timed", json.dumps(row))
        bad = [r["case"] for r in rows if not r["ok"]]
        assert not bad, f"kernels disagree with their plain versions: {bad}"
        log(smi)
        return 0

    mark(2, "kernels against their plain versions")
    pre, dec = phase_kernels(torch, fa)
    paged, fused, fused_q = phase_paged_kernels(torch, pa, fd)
    cap_pre, cap_dec, cap_paged = phase_softcap_kernels(torch, fa, pa)
    digests = uncapped_digests(torch)
    assert digests == UNCAPPED_DIGESTS, \
        f"uncapped kernels changed their bits: {digests}"
    plans = {f"{str(dt).replace('torch.', '')}/{form}": fd.kernel_plan(
        dt, form, 4096, 32, 8, 128, 256)
        for dt in (torch.bfloat16, torch.float32)
        for form in ("float", "int8", "int4")}
    log("  fused_decode_step launch plans (llama-3-8b, tables of 256):",
        json.dumps(plans))
    q4_rows, q4_pass = phase_q4(torch, qm)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    row_rows, row_pass = phase_q4_row(torch, qm, get_config("llama-3-8b"))
    row_bounds = int4_row_bounds(get_config("llama-3-8b"))
    log("  q4_matmul_row bounds per tp=2 rank (llama-3-8b int4 shapes):",
        json.dumps(row_bounds))

    mark(3, "engine path (worker, llama-3-8b bf16, 3 requests)")
    launches, rows, peak = phase_main_path(torch, counted)
    for name in ("flash_attention", "flash_decode"):
        assert launches[name] > 0, f"{name} never launched on the engine path"
    assert launches["flash_attention[mma]"] == launches["flash_attention"], \
        "a bf16 prefill missed the tensor-core kernel"

    mark(4, "card vs host cross-check")
    xerr = phase_cross_check(torch, fa, qm)

    mark(5, "batched path (worker, llama-3-8b bf16, 8 concurrent "
        "requests, paged then fused decode)")
    batched = phase_batched(torch, counted)
    launches["paged_flash_decode"] = \
        batched["paged"]["launches"]["paged_flash_decode"]
    launches["fused_decode_step"] = \
        batched["fused"]["launches"]["fused_decode_step"]

    mark(6, "both decode routes at full depth, bf16 against f32")
    route_depth = phase_route_depth(torch, counted)

    mark(7, "quantized serving (worker, llama-3-8b int4: engine, "
        "batched paged and fused; int8: batched fused)")
    quant = phase_quant_serving(torch, counted)
    for k in ("q4_matmul", "q4_matmul[mma]"):
        launches[k] = sum(quant[p]["launches"][k] for p in (
            "engine_int4", "batched_int4_paged", "batched_int4_fused"))
    assert launches["q4_matmul[mma]"] == launches["q4_matmul"], \
        "a bf16 q4_matmul call missed the tensor-core kernel"
    launches["fused_decode_step[int4]"] = \
        quant["batched_int4_fused"]["launches"]["fused_decode_step"]
    launches["fused_decode_step[int8]"] = \
        quant["batched_int8_fused"]["launches"]["fused_decode_step"]
    for name in ("paged_flash_decode", "fused_decode_step", "q4_matmul",
                 "fused_decode_step[int4]", "fused_decode_step[int8]"):
        assert launches[name] > 0, f"{name} never launched on its path"

    mark(8, "card vs host cross-check, int4 and int8 weights")
    for mode in ("int4", "int8"):
        xerr[mode] = phase_cross_check(torch, fa, qm, quant=mode)

    mark(9, "int4 at full depth, q4_matmul route vs plain unpack, "
        "against f32 over the same weights")
    int4_depth, depth_kept = phase_int4_depth(torch, counted, qm)

    mark(10, f"tp=2 engine serving (worker, llama-3-8b width, "
        f"{TP_SERVING_LAYERS} layers, "
        "bf16 then int4, 3 requests each)")
    tp_serving, tp_launches = phase_tp_serving(torch)
    for k in ("q4_matmul_row", "q4_matmul_row[mma]"):
        launches[k] = tp_launches[k]
    assert launches["q4_matmul_row"] > 0, \
        "q4_matmul_row never launched on the tp path"
    assert launches["q4_matmul_row[mma]"] == launches["q4_matmul_row"], \
        "a bf16 q4_matmul_row call missed the tensor-core kernel"

    mark(11, "tp=2 against tp=1 on the same weights (2 layers, f32, "
        "float and int4), then int4 at full depth against phase 9's f32")
    # its three tp engines on one group (DLI_TP_KEEP_GROUPS): one spawn,
    # timed; the pair stays for phases 21 and 22 (stopped after 22)
    from distributed_llm_inferencing_tpu_torch.runtime import lockstep
    try:
        with _Env(DLI_TP_KEEP_GROUPS="1"):
            t0 = time.perf_counter()
            lockstep.leader(2, torch.device("cuda")).stop()
            pair_spawn_s = time.perf_counter() - t0
            log(f"  a tp pair's spawn: {pair_spawn_s:.2f} s (kept for "
                "phases 11, 21 and 22)")
            tp_xerr = {q or "float": phase_tp_cross_check(torch, q)
                       for q in (None, "int4")}
            tp_depth = phase_tp_depth(torch, depth_kept)
    except BaseException:
        lockstep.stop_idle_groups()
        raise

    mark(12, "the worker's control surface over HTTP (llama-3-8b "
        "bf16: auth, replay, SSE, fencing; /inference_batch paged and "
        "fused, /cancel, /drain; /metrics)")
    control = phase_control_surface(torch, counted, batched, smi)

    mark(13, "decode programs, CUDA graphs on and off (worker, "
        "llama-3-8b full depth: engine bf16 and int4; /inference_batch "
        "paged and fused, bf16 and int4)")
    graphs_report = phase_graphs(torch, counted, smi)

    mark(14, "the dense families (a) cross-checks at full width, 2 "
        "layers, f32; (b) gpt2-xl and bloom-7b1 at full depth through the "
        "worker, graphs on and off; bloom-7b1's ALiBi prefill vs f32")
    families = phase_families(torch, fa, qm, counted, smi)
    for name in ("flash_attention", "flash_decode"):
        assert families["launches"][name] > 0, \
            f"{name} never launched on the families' path"
    assert families["launches"]["paged_flash_decode"] > 0

    mark(15, "model ingestion through the worker (a) a "
        "Llama-3.1-8B-shaped HF directory: engine, batched paged and "
        "fused, engine int4; (b) gpt2-xl and bloom-7b1 hub layouts; (c) "
        "the native int4 checkpoint of the convert CLI")
    ingestion = phase_ingestion(torch, counted, smi)
    for name in ("flash_attention", "flash_decode", "paged_flash_decode",
                 "fused_decode_step", "q4_matmul"):
        assert ingestion["launches"][name] > 0, \
            f"{name} never launched on the ingestion path"

    mark(16, "the dense switches: (a) a gemma-2-9b-shaped HF directory "
        "at full depth and (b) a Qwen3-8B-shaped one through the worker, "
        "graphs on and off; (c) each later converter type's card-vs-host "
        "check, 2 layers")
    later = phase_later(torch, fa, qm, counted, smi)
    for name in ("flash_attention", "flash_decode", "paged_flash_decode"):
        assert later["gemma2_launches"][name] > 0, \
            f"{name}'s softcap arm never launched on gemma-2's path"
    assert later["launches"]["fused_decode_step"] == 0, later["launches"]

    mark(17, "the KV plane: (a) the int8 KV cache, engine, max_seq 8192; "
        "(b) the int8 paged pool; (c) the host KV tier; (d) "
        "disaggregated prefill over /kv_fetch, native and int8 arenas")
    kv_plane = phase_kv_plane(torch, fa, qm, counted, smi)
    for name in ("flash_attention", "paged_flash_decode",
                 "fused_decode_step", "flash_decode"):
        assert kv_plane["launches"][name] > 0, \
            f"{name} never launched on the KV plane's path"

    mark(18, "speculation, overlap, migration: (a) the engine's verify "
        "step, 2 layers f32 and full depth bf16; (b) the batched "
        "speculative chunk through the worker, wave and global, adaptive "
        "on and off; (c) overlapped dispatch at full occupancy; (d) live "
        "migration between two workers")
    spec = phase_spec_migrate(torch, counted, smi)

    for name in ("flash_attention", "flash_decode", "paged_flash_decode",
                 "fused_decode_step"):
        assert spec["launches"][name] > 0, \
            f"{name} never launched on phase 18's path"

    mark(19, "multi-LoRA and experts: (a) llama-3-8b with three rank-16 "
        "adapters through the worker, batched (mixed waves, an in-place "
        "slot eviction, graphs on and off) and engine (bf16, int4), a "
        "2-layer f32 mixed-vs-dedicated cross-check; (b) mixtral-8x7b 2 "
        "layers f32 kernels vs plain in each dispatch mode, moe-proxy-8e bf16 "
        "and mixtral-8x7b int8 at full depth, engine and batched")
    lora_moe = phase_lora_moe(torch, counted, smi)
    for name in ("flash_attention", "flash_decode", "paged_flash_decode",
                 "fused_decode_step", "q4_matmul"):
        assert lora_moe["launches"][name] > 0, \
            f"{name} never launched on phase 19's path"

    mark(20, "the other experts and latent attention: (a) deepseek-proxy "
        "through the worker, latent and materialized cache, bf16 and int4, "
        "engine and batched; (b) each experts converter type's card-vs-host "
        "check at its public model's widths; (c) a gpt-oss-20b-shaped "
        "checkpoint through the worker")
    experts_mla = phase_experts_mla(torch, fa, qm, counted, smi)
    assert experts_mla["launches"]["flash_attention"] > 0 and \
        experts_mla["launches"]["paged_flash_decode"] > 0 and \
        experts_mla["launches"]["q4_matmul"] > 0, experts_mla["launches"]

    mark(21, "tensor parallelism for what one host serves: (a) batched "
        "serving at tp=2 through the worker (llama-3-8b width, "
        f"{TP_SERVING_LAYERS} layers, bf16 with DLI_FUSED_DECODE off and "
        "on, int4); (b) the batcher and speculation at tp=2 against tp=1 "
        "and plain decode (2 layers, f32); (c) the families at tp=2 "
        "against tp=1 at their published widths (2 layers, f32)")
    tp_batched = phase_tp_batched(torch, smi, spawn_s=pair_spawn_s,
                                  keep=True)
    for name in ("flash_attention", "flash_decode", "paged_flash_decode",
                 "q4_matmul", "q4_matmul_row"):
        assert tp_batched["launches"].get(name, 0) > 0, \
            f"{name} never launched on phase 21's path"
    assert tp_batched["launches"]["fused_decode_step"] == 0

    mark(22, "pipeline and sequence parallelism: (a) pp=2 through the "
        "worker at llama-3-8b's full width and depth (batched bf16 with "
        "DLI_FUSED_DECODE off and on, int4; engine bf16); (b) sp=2 on a "
        f"{PP_SP_LONG}-token prompt at full depth, f32, against sp=1; (c) "
        "the pp batcher, speculation, pp x tp, sp x tp, pp x sp and family "
        "rows (2 layers, f32)")
    pp_sp = phase_pp_sp(torch, smi, refs={
        "batched": batched["tokens_paged"], "engine": rows[2]["tokens"]})

    mark(None)
    log("  wall time by phase (s):", json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    csrc = "distributed_llm_inferencing_tpu_torch/csrc/"
    pallas = "distributed_llm_inferencing_tpu/ops/pallas/"
    kernels = []
    for name, source, replaces, checks in (
            ("flash_attention", "flash_attention.cu",
             "flash_attention.py:115", pre),
            ("flash_decode", "flash_attention.cu", "flash_attention.py:250",
             dec),
            ("paged_flash_decode", "paged_attention.cu",
             "paged_attention.py:87", paged),
            ("fused_decode_step", "fused_decode.cu", "fused_decode.py:193",
             fused),
            ("fused_decode_step[int8]", "fused_decode.cu",
             "fused_decode.py:193", fused_q["int8"]),
            ("fused_decode_step[int4]", "fused_decode.cu",
             "fused_decode.py:193", fused_q["int4"]),
            ("q4_matmul", "quant_matmul.cu", "quant_matmul.py:312",
             q4_rows),
            ("q4_matmul_row", "quant_matmul.cu", "quant_matmul.py:295",
             row_rows)):
        row = checks[0]
        entry = {
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["case"],
            "timed": [{k: r[k] for k in ("case", "ms", "event_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms",
                                         "library_gather_ms",
                                         "library_sliced_ms", "unfused_ms",
                                         "err_over_tol") if k in r}
                      for r in checks if "ms" in r],
            "checks": [{k: r[k] for k in ("case", "max_abs_err",
                                          "err_over_tol", "ok") if k in r}
                       for r in checks],
        }
        if name in ("flash_attention", "q4_matmul", "q4_matmul_row"):
            entry["launches_mma"] = launches[f"{name}[mma]"]
        # phase 14's gpt2-xl and bloom-7b1 serving, beside the llama path
        entry["family_launches"] = families["launches"].get(name, 0)
        # phase 15's checkpoints (fused_decode_step's float form only)
        entry["ingestion_launches"] = ingestion["launches"].get(name, 0) \
            if "[" not in name else 0
        if name == "paged_flash_decode":
            entry["library_gather_ms"] = row["library_gather_ms"]
        if name.startswith("fused_decode_step"):
            entry["unfused_ms"] = row["unfused_ms"]
            entry["plan"] = plans
            entry["full_occupancy"] = {k: checks[1][k] for k in (
                "case", "ms", "bound_ms", "plain_ms", "unfused_ms",
                "err_over_tol")}
        if name == "q4_matmul":
            entry["library2_ms"] = row["library2_ms"]
            entry["per_weight_pass_b8"] = q4_pass[8]
            entry["per_weight_pass_b1"] = q4_pass[1]
        if name == "q4_matmul_row":
            entry["per_weight_pass_b8_per_rank"] = row_pass
        # phase 16's later families; the softcap arm's timed rows at
        # gemma-2-9b's shapes beside the uncapped arm (SDPA: no cap)
        entry["later_launches"] = later["launches"].get(name, 0) \
            if "[" not in name else 0
        # phase 17's KV plane (the int8 routes launch no decode kernel)
        entry["kv_plane_launches"] = kv_plane["launches"].get(name, 0) \
            if "[" not in name else 0
        # phase 18: speculation (verify passes launch no decode kernel),
        # overlapped pairs and migration
        entry["spec_migrate_launches"] = spec["launches"].get(name, 0) \
            if "[" not in name else 0
        # phase 19: adapter passes (never fused) and the MoE rows
        entry["lora_moe_launches"] = lora_moe["launches"].get(name, 0) \
            if "[" not in name else 0
        # phase 20: the GQA experts' rows; sinks and latent attention
        # launch no attention kernel
        entry["experts_mla_launches"] = experts_mla["launches"].get(
            name, 0) if "[" not in name else 0
        # phase 21: every tp rank's launches (batched tp serving, the
        # tp batcher and speculation checks, the families under tp)
        entry["tp_batched_launches"] = tp_batched["launches"].get(
            name, 0) if "[" not in name else 0
        # phase 22: every rank's launches (every pp stage's; the sp ring
        # launches no attention kernel)
        entry["pp_sp_launches"] = pp_sp["launches"].get(
            name, 0) if "[" not in name else 0
        cap_rows = {"flash_attention": cap_pre, "flash_decode": cap_dec,
                    "paged_flash_decode": cap_paged}.get(name)
        if cap_rows is not None:
            entry["softcap"] = {
                "launches": later["gemma2_launches"][name],
                "timed": [{k: r[k] for k in (
                    "case", "ms", "uncapped_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err") if k in r}
                    for r in cap_rows if "ms" in r],
                "checks": [{k: r[k] for k in ("case", "max_abs_err", "ok")}
                           for r in cap_rows]}
        kernels.append(entry)
    report = {"smi": smi, "kernels": kernels, "requests": rows,
              "peak_memory_bytes": peak, "cross_check_max_abs_err": xerr,
              "batched": batched, "route_depth": route_depth,
              "quant_serving": quant, "int4_depth": int4_depth,
              "int4_row_bounds": row_bounds, "tp_serving": tp_serving,
              "fused_plans": plans,
              "tp_cross_check_max_abs_err": tp_xerr, "tp_depth": tp_depth,
              "control_surface": control, "graphs": graphs_report,
              "families": families, "ingestion": ingestion,
              "later": later, "kv_plane": kv_plane, "spec_migrate": spec,
              "lora_moe": lora_moe, "experts_mla": experts_mla,
              "tp_batched": tp_batched, "pp_sp": pp_sp,
              "uncapped_digests": digests,
              "phase_seconds": phase_s,
              "seconds": time.perf_counter() - t_start}
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
