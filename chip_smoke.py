#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
H100: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (one line each, more where noted; every phase ends on a line
"[N] phase N ran S s", and the line before the kernels line gives the
build's and every phase's seconds):
  1. require a CUDA card of capability (9, 0); print its name and power
     limit as nvidia-smi reports them;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print each
     compiled instance's registers and spills, and how many clusters of
     flash_bwd_dkv CTAs the card holds at once; hold the shared helpers of
     csrc/sm90.cuh alone: one wgmma product per operand mode, N and K
     against torch.matmul (SM90_RTOL) and TMA boxes against slices;
  2b. GPP's band loop counted from the SASS: the built gpp.cu library
     disassembled (cuobjdump -sass) and the innermost reciprocal loop of
     gpp_fused_kernel<2, EPT, true> and of gpp_banded_kernel<2, EPT,
     TRANSPOSED> in both aqsm layouts counted by opcode class for every
     compiled EPT (repro_torch.core.sass): instructions a term (with and
     without the reciprocals' slow-path call stubs), the FMA ratio, the
     bytes its LDS read a term, and the issue and MUFU bounds at Si-214,
     and fails unless gpu_model.BAND_LOOP equals that census at every
     compiled instance (the journey's modeled column reads the table);
     phase 6 sets the tuned config's
     issue bound beside the kernel's time; and the selective scan's step
     loop: the built ssm_scan.cu library's ssm_scan_kernel<16, S, bf16>
     (hymba-1.5b's instances, S states a thread) counted per (t, c, n)
     element, one MUFU.EX2 each: instructions an element by class, the
     shuffles among them, the FMA ratio, the issue bound at hymba's
     prefill and at T=4096 on the SMs the grid uses and on all of them,
     and the MUFU bound;
  3. hold each kernel against its plain version on the card at BENCH and
     Si-214 (gpp_fused at V9, gpp_banded at V6, V7 and V8): partials and
     totals within max-norm relative TOL_PLAIN[size]; at BENCH also the totals
     against the complex128 oracle ref_numpy within TOL_REF;
  4. the main path: repro_torch.dispatch("gpp", make_inputs(SI214)) — v10,
     tuned on the card (the candidates ranked and each timed config's ms
     are printed);
  5. the journey: v0–v5 and v6–v10 at Si-214 through the registry, each
     measured beside its modeled Hopper roofline (journey._model_report:
     v0–v5 from the census of the plain version, v6–v10 from phase 2b's
     SASS table and the traffic model) and format_journey's Table I; every
     version's modeled ms at most MODEL_OVER_MEASURED times its measured
     ms (v6–v10's terms are bounds; v0–v5's memory term charges every
     op's bytes to HBM, which the L2 can undercut); tuner.best_config(SI214),
     read back from the on-disk tune cache with the in-process memo
     cleared, equal to the config phase 4's dispatch resolved, and
     measure.time_config of it
     within the spread of its calls (or TIME_CONFIG_RTOL) of phase 4's
     tuner time;
  6. the main path's result held against the plain version (f32) within
     TOL_PLAIN and against a float64 run of it (on the same float32 inputs)
     within TOL_F64; times (CUDA events, median after warm-up);
  7. flash_fwd at op level: the kernel against flash_fwd_plain on the card
     (out within FLASH_OUT_ULPS bf16 ulps, lse within FLASH_LSE_ATOL) at
     qwen2-1.5b's attention shape (B=1, H=12, KvH=2, Hd=128) for S = 256,
     512 and 4096 and at the training shape (B=8, S=512), at codeqwen's MHA
     shape (H = KvH = 32, S = 512) and at one config with blk_q != blk_kv;
     and at Hd 32 (B=2, S=512, H=12, KvH=2: reduce_config's head dim,
     zero-padded to the Hd 64 instances); at S = 512 also against the f32
     oracle ref.reference; each with the
     kernel's, the plain version's and scaled_dot_product_attention's ms
     (timed here only) and the bound, and the kernel's and SDPA's device
     ms replayed from a CUDA graph; at S = 512 and 4096 and the training
     shape the model's block pick beside a timed sweep of the whole menu;
  7b. flash_bwd_dq and flash_bwd_dkv at op level: each kernel against its
     plain version on the kernel forward's lse (within one bf16 ulp at the
     largest element, BWD_ULPS) at the training shape (B=8, S=512, H=12,
     KvH=2, Hd=128) and at B=1, S=4096, at codeqwen's MHA shape (group 1),
     phi4-mini's heads (H=24, KvH=8: group 3), a group of 16 (dkv's f32
     partials), other blocks for each kernel, non-causal, Hd 64, and Hd 32
     (reduce_config's head dim, zero-padded to the Hd 64 instances); at
     every case flash_bwd_dq bit-equal over two launches, with its
     registers and spills; at the training shape and S=4096
     flash_bwd_dkv bit-equal over two launches;
     at the training shape also the FlashAttention gradient against
     autograd through the f32 oracle (BWD_REF_RTOL); the kernels', the
     plain versions' and the backward of scaled_dot_product_attention's ms
     (timed here only) and the bounds;
  7d. a reduced qwen2 (reduce_config: Hd 32, 12/2 heads, 2 layers) with
     flash on: one loss and its gradients through the model at B=2,
     S=512; flash_fwd, flash_bwd_dq and flash_bwd_dkv each launch once a
     layer at Hd 32 and every launch is held against its plain version;
  8. dense serving, the slice's path: ServeEngine on qwen2-1.5b at full
     width and depth with use_flash_attention=True, weights from seed 0,
     max_batch=4, cache_len=1024: 8 greedy requests (prompts of 160, 256,
     300 and 480 tokens, two each) and one at temperature 0.8, 32 new
     tokens each. flash_fwd must launch 28 times a prefill; TTFT, decode
     ms a step, tokens/s and peak device memory are printed (the CUDA
     matmul flags are printed before the phase, as the process has them,
     and read inside the engine's work at every flash call of a warm-up
     request: the port's guard, backend.f32_accumulation, must have both
     off); one admission
     round and three decode rounds run under torch.profiler (device-busy
     share, top kernels, top host ops). Each request's prompt is then
     prefilled again: every flash_fwd launch is held against
     flash_fwd_plain on the same inputs (FLASH_OUT_ULPS), and the
     first-token logits against the same model with flash_fwd_plain in
     the kernel's place and against the engine with flash off (the
     chunked plain path), both within SERVE_LOGIT_RTOL; the kernels line.
  7c. ssm_scan at op level: the kernel against ssm_scan_plain on the card
     (y within SSM_RTOL of the largest |y|, hT within SSM_RTOL of the
     largest |hT|) and bit-equal over two launches at hymba-1.5b's prefill
     (B=1, T=1152, C=3200, N=16), T=4096, B=4 x T=256, a small N=8 shape
     with a ragged time tile, and the prefill shape with a nonzero h0;
     the distance of y and hT from a float64 run of the plain version on
     the same inputs (the plain f32 version's beside it); the kernel's
     call and device (CUDA graph) ms, the plain version's ms and the
     bound (no PyTorch call computes the scan); at the prefill shape and
     T=4096 every config of the space, modeled beside its device ms, the
     model's pick against the measured best;
  10. training, the third slice's path: Trainer(...).run() on qwen2-1.5b
     at full width and depth (remat "full", AdamW, flash on), the
     TrainLoopConfig defaults (seq_len 512, global_batch 8), 4 steps,
     one checkpoint at the end under build/. The step-0 loss within
     LOSS0_ATOL of what random weights give (see LOSS0_ATOL), every loss
     finite; every step
     launches flash_fwd 56 times (forward and remat recompute) and each
     backward kernel 28 times; step ms, tokens/s, mfu, peak memory; the
     save's size and time; resume_or_init restores every leaf bit-equal
     to the state in memory. Then one step under torch.profiler and one
     more with every backward launch held against its plain version on
     its own inputs (BWD_ULPS), the matmul flags read at each of those
     launches (both off: the port's guard; the script sets none).
  11. hybrid serving, the fourth slice's path: ServeEngine on hymba-1.5b
     at full width cut to HYBRID_SERVE_LAYERS layers (uncut: 32) with
     ssm_impl="pallas", weights from seed 0,
     max_batch=4, cache_len=2048: 8 greedy requests (SERVE_PROMPTS) and
     one of 1152 tokens (longer than the 1024 window: the prefill's ring
     roll and ring decode), FAMILY_SERVE_NEW new tokens each, all
     submitted at once. ssm_scan must launch once a layer a prefill;
     TTFT, decode ms a round, tokens/s and peak device memory are printed;
     one admission round and three decode rounds run under torch.profiler.
     Then the long prompt is prefilled again with every ssm_scan launch
     held against ssm_scan_plain on its inputs (SSM_RTOL), and every prompt's
     first-token logits against the engine with ssm_impl="chunked"
     (SERVE_LOGIT_RTOL).
  12a. paged serving, the fifth slice's path: ServeEngine on qwen2-1.5b
     at full width and depth, flash on, max_batch 4, cache_len 1024,
     kv_page_size 16: 8 greedy requests behind one 256-token system
     prompt (suffixes PAGED_SUFFIXES), 32 new tokens each, all submitted
     at once; the first admission is cold and publishes the prefix, the
     others hit it. flash_fwd launches 28 times in the cold admission and
     0 in a hit's suffix prefill; the kvcache stats (hit rate, tokens
     saved, peak live pages, bytes a slot against the static layout),
     TTFT of hits and misses, the admission's own ms, decode round ms,
     tokens/s and peak memory are printed; page conservation and pages
     live == index pages after the run. Every hit's restored K/V lines
     are bit-equal to a cold prefill's of the same prompt, and its
     first-token logits within SERVE_LOGIT_RTOL of it. Then the first 4
     requests through the unpaged engine, through prefix_reuse=False
     (bit-equal tokens: the same path) and through kv_dtype="int8"
     (conservation, finite logits, the distance from bf16 printed).
  12b. the paged decode kernels: dispatch("paged_decode") for gather,
     int8 and verify at qwen2-1.5b's decode shape (B=4, H=12, KvH=2,
     Hd=128, page 16, 64 pages a row; the tuner times the menu), then
     each entry point against its plain version at the same split count
     (within PAGED_OUT_ULPS, bit-equal reruns, gather also against ref
     within PAGED_REF_ATOL) at that shape with a permuted table, full and
     ragged cache_len (one ending mid-page), int8 pools, verify at Q=4 on
     bf16 and int8 pools, rows that see nothing, every pages_per_block of
     the menu, and B=8 at a context of 8192 on bf16 and int8 pools; each
     case's grid (splits,
     KvH, B x row groups), its ring stages and CTAs an SM at every ppb,
     and every split count 1-64 at the best ppb (held to the same gates);
     call, device (CUDA graph) and plain ms, the bound, the model's time
     beside each device time, and two yardsticks: SDPA on the
     already-gathered K/V (gather not counted) and gather + SDPA timed
     together (the same function).
  13. speculative serving, sampling on the card and the Router, the sixth
     slice's path (its own seconds printed):
     13a. qwen2-1.5b at full width cut to SPEC_LAYERS layers (uncut:
     28), flash on, seed 0, served by
     ServeEngine(spec_k=SPEC_K, max_batch 4, cache_len 1024) with the
     target's own first layer as the draft (the stacked layer leaves
     sliced [:1], views of the same params), and by the plain engine, on
     phase 8's nine requests (the ninth at SPEC_HOT_T). flash_fwd must
     launch SPEC_LAYERS + 1 times an admission (the target's layers + 1
     draft) and nowhere else;
     acceptance rate, accepted tokens a verify step and accepted +
     rejected + bonus == tokens emitted; spec round ms p50 beside the
     plain decode round's, tokens/s, TTFT p50 and peak memory of both; one
     admission round and three spec rounds under torch.profiler; every
     greedy token a round emits is its verify argmax at that position; a
     greedy output that diverges from plain fails unless the plain top-2
     gap there lies within the bf16 floor (SERVE_LOGIT_RTOL x max |logit|;
     position and gap printed, bitexact_frac the share of equal outputs);
     decode_verify within SERVE_LOGIT_RTOL of Q sequential decode_step
     calls on a copy of the cache.
     13b. the same requests with kv_page_size 16: page conservation, peak
     live pages within the committed lines' pages, tokens and spec
     counters equal to 13a's.
     13c. Threefry (serve/rng.py) over 64 (seed, rid, n_gen) keys at
     V=151,936: keys, random_bits and categorical bit-equal on the card and
     the CPU; the SPEC_HOT_T row's first 4 tokens against the same spec
     engine on the CPU, failing on a difference only where every
     decision's margin (first token, draft draws, accepts, the residual or
     bonus draw) clears its bf16 floor (printed).
     13d. Router with 2 replicas of qwen2-1.5b sharing one params tree on
     the card over generate_trace(ROUTER_TRACE), replica 1 flapped
     (ROUTER_FLAP): every request one outcome, all completed, one
     recovery; flash_fwd SPEC_LAYERS times an admission of a 129-256
     token prompt;
     TTFT/TPOT ticks p50/p99, wall time; completed greedy outputs against
     one undisturbed engine's under 13a's near-tie rule.
  14. the moe family, the seventh slice's path (its own seconds printed):
     14a. ServeEngine on deepseek-moe-16b at full width cut to
     MOE_SERVE_LAYERS layers (1 dense + the rest moe, 64 experts top-6 +
     2 shared; uncut: 28 layers, ~16.4e9 parameters),
     flash on, seed 0, max_batch 4, cache_len 1024: 8 greedy requests
     (MOE_PROMPTS: 256, 512 and 512 tokens launch flash_fwd once a layer
     an admission, the others take the chunked route) and one of
     MOE_HOT_PROMPT tokens at SPEC_HOT_T, FAMILY_SERVE_NEW new tokens
     each, all at once. flash_fwd launches exactly MOE_SERVE_LAYERS x 3
     times and no other kernel;
     every token in the vocabulary; parameter count, init time, TTFT,
     decode round ms, tokens/s and peak memory; the same requests again
     with every output bit-equal to the first run's; one admission round
     and three decode rounds under torch.profiler (device-busy share,
     cudaLaunchKernel a round); the same requests through
     kv_page_size 16 (k/v and dk/dv paged) with outputs equal to the
     unpaged run's and every page released; each flash-sized prompt
     prefilled once more through the engine's admission path with every
     flash_fwd launch (group 1: B=1, H=KvH=16, Hd 128, S=256/512) held
     against flash_fwd_plain on its own inputs (FLASH_OUT_ULPS), and the
     first token's argmax equal to the first run's greedy token.
     14b. models/moe.moe_ffn on that model's first moe layer at its
     prefill (T=512) and decode (T=4) shapes, inputs from seed 3: two
     runs on the card bit-equal (out, aux, gather_idx, gates); against
     the port's CPU run of the same call where the routing is settled
     (moe.settled at MOE_MARGIN), gather_idx equal, gates within
     MOE_GATE_ATOL, out within MOE_OUT_ULPS; a call's ms, the device ms
     from a CUDA graph and the bound (all expert weights read at both
     shapes).
     14c. Trainer(...).run() on deepseek-moe-16b at full width cut to
     MOE_TRAIN_LAYERS layers (1 dense + 3 moe), remat "full", AdamW,
     flash on, seq_len 512 x global_batch 8, TRAIN_STEPS steps, no
     checkpoint written (phase 10 holds it): losses finite, step 0 within
     MOE_LOSS0_ATOL of lse0 + 1e-4 lse0^2, every step flash_fwd 8 and
     each backward kernel 4 times; loss, router aux, step ms, tokens/s,
     mfu over the active parameters, peak memory; one more step with
     every flash_fwd, flash_bwd_dq and flash_bwd_dkv launch (group 1: B=8,
     S=512, H=KvH=16, Hd 128) held against its plain version on its own
     inputs (FLASH_OUT_ULPS forward, BWD_ULPS backward).
  15. the rwkv6 family and the recurrent families' training, the eighth
     slice's path (its own seconds printed):
     15a. ServeEngine on rwkv6-7b at full width cut to RWKV_SERVE_LAYERS
     layers (d 4096, 64 heads of 64; uncut: 32 layers, ~7.58e9
     parameters), seed 0, max_batch 4,
     cache_len 1024: greedy prompts on every WKV form (RWKV_PROMPTS: one
     chunk, the sequential scan, 64-step chunks) and one of
     RWKV_HOT_PROMPT tokens at SPEC_HOT_T, RWKV_NEW new tokens each, all
     at once; no kernel launches (WKV is plain torch); TTFT by the WKV form
     each admission ran (recorded at the call), decode round ms,
     tokens/s, peak memory; the same requests again, every output
     bit-equal; one admission round and three decode rounds under
     torch.profiler; the matmul flags read at every WKV call (both off);
     decode against prefill on the scan (200 -> 201) within
     RWKV_DECODE_RTOL, and with f32 weights and activations within
     RWKV_DECODE_F32_RTOL (the witness that the bf16 distance is
     rounding), and across the -60 clamp (256 -> 257) printed; one
     prefill's ms on each WKV form.
     15b. that model's layer 0 (time mix and channel mix with their
     residuals) forward and backward at B=1, T=RWKV_LAYER_T on the card
     against the port's CPU run of the same code, every output and
     gradient within RWKV_LAYER_ULPS bf16 ulps at its largest element;
     wkv6_chunked in f32 against wkv6_scan in float64 at B=1, T=512, H=64,
     D=64, at the reference test's decay and chunks 16, 32 and 64 (the
     allclose gate WKV_F64_ATOL before each head's first clamped chunk,
     the state on the heads free of the clamp where there are any; every
     value finite) and at the model's initial decay (printed: every chunk
     is clamped).
     15c. Trainer(...).run() on hymba-1.5b at full width cut to
     HYBRID_TRAIN_LAYERS layers (ssm_impl "chunked", HYBRID_TRAIN_SEQ x
     HYBRID_TRAIN_BATCH) and on
     rwkv6-7b at full width cut to RWKV_TRAIN_LAYERS layers
     (RWKV_TRAIN_SEQ x RWKV_TRAIN_BATCH), remat "full", AdamW,
     SSM_TRAIN_STEPS steps, no checkpoint: losses finite, step 0 within
     LOSS0_ATOL of
     lse0 + 1e-4 lse0^2 and taken apart on its own params and batch
     (mean lse within LOSS0_ATOL of ln V + s2 / 2, mean target logit
     within LOSS0_SE standard errors of 0, the terms' sum within
     LOSS0_SUM_ATOL of the run's loss), no kernel launched; step ms,
     tokens/s, mfu
     (hymba's attention counts min(t + 1, window) keys; rwkv has no
     attention term), peak memory, one step each with the device traced
     (busy share, kernels a step);
     then one hymba train step with ssm_impl "pallas": ssm_scan launches
     n_layers + 1 times (the forward and the last layer's recompute),
     each held against ssm_scan_plain on its own inputs (SSM_RTOL), and
     the backward must raise NotImplementedError.
  16. the encdec and vlm families, the ninth slice's path (its own
     seconds printed):
     16a. ServeEngine on internvl2-26b at full width cut to
     VLM_SERVE_LAYERS layers (d 6144, 48 heads over 8; uncut: 48 layers,
     ~19.86e9 parameters, ~39.7 GB),
     flash on, seed 0, max_batch 4, cache_len VLM_CACHE_LEN: 8 greedy
     requests (VLM_PROMPTS) and one of VLM_HOT_PROMPT tokens at
     SPEC_HOT_T, each with 256 bf16 patch embeddings in Request.extra,
     FAMILY_SERVE_NEW new tokens each, all at once; the text's bucket leaves room for
     the vis lines, so six admissions prefill 512 or 768 rows (flash_fwd
     once a layer each) and three 384, 856 or 956 (chunked); the matmul flags
     read at every flash call of a warm-up request; TTFT, decode round
     ms, tokens/s, peak memory at init (each leaf drawn in f32) and while
     serving; the same requests again, every output bit-equal; one
     admission round and three decode rounds under torch.profiler; the
     same requests through kv_page_size 16, outputs equal; each
     flash-sized request prefilled again through the admission path with
     every flash_fwd launch (group 6: H=48, KvH=8, Hd 128) held against
     flash_fwd_plain (FLASH_OUT_ULPS), its first-token logits against the
     plain version in the kernel's place and against flash off (within
     the sanity bound VLM_LOGIT_RTOL: at 48 layers the bf16 floor lay
     above SERVE_LOGIT_RTOL); the witness at full width cut to
     VLM_WITNESS_LAYERS layers: the same three routes for every
     flash-sized request, each launch held to its plain version, the
     kernel path against the other two within SERVE_LOGIT_RTOL, and the
     two plain routes with f32 weights and activations within
     VLM_F32_RTOL; then, printed only, flash_fwd and SDPA
     device ms at B=1, S=VLM_OP_S, H=48, KvH=8, Hd=128 with the bound.
     16b. ServeEngine on whisper-small at full width and depth (12 + 12
     layers, 1500 frames), seed 0, max_batch 4, cache_len
     WHISPER_CACHE_LEN: 8 greedy requests (WHISPER_PROMPTS) on bf16
     frames and one of WHISPER_HOT_PROMPT tokens on f32 frames at
     SPEC_HOT_T, FAMILY_SERVE_NEW new tokens each, all at once; no kernel
     launches (chunked attention everywhere, as in the reference); the serving
     metrics, the same requests again (bit-equal), profiled rounds,
     kv_page_size 16 (k/v paged, xk/xv dense; equal outputs), an
     admission's own ms (the encoder runs in each); decode against
     prefill at WHISPER_DECODE_AT -> + 1 within SERVE_LOGIT_RTOL in bf16
     and within WHISPER_DECODE_F32_RTOL with f32 weights, activations and
     frames (f32_storage).
     16c. Trainer(...).run() on whisper-small at full width (AdamW,
     WHISPER_TRAIN_SEQ x WHISPER_TRAIN_BATCH, the stub f32 frames) and on
     internvl2-26b at full width cut to VLM_TRAIN_LAYERS layers
     (Adafactor, flash on, VLM_TRAIN_SEQ x VLM_TRAIN_BATCH), remat
     "full", ENCDEC_VLM_TRAIN_STEPS steps, no checkpoint: losses finite, step 0
     within LOSS0_ATOL of lse0 + 1e-4 lse0^2 and taken apart as in 15c,
     no kernel on whisper's
     steps, flash_fwd 16 and each backward kernel 8 times an internvl2
     step; step ms, tokens/s, mfu (whisper: 6 (N_dec tokens + N_enc
     frames) + the encoder's, decoder's and cross-attention's attention
     FLOPs; internvl2: every backbone position, vis included), peak
     memory, one traced step each; then one internvl2 step with every
     flash launch held against its plain version (FLASH_OUT_ULPS,
     BWD_ULPS) and the matmul flags read at each.
 17. tensor-parallel serving (exact-TP, ServeEngine(mesh=)): TP_RANKS
     ranks spawned by torch.multiprocessing, sharing the one card over
     gloo (NCCL refuses two ranks on one GPU; gloo takes CUDA tensors),
     one mesh ("model",) of TP_RANKS, a FileStore rendezvous under build/
     and a timeout on the world and on every collective. In this process the
     unsharded engine serves 17a's and 17b's requests (tokens, and every
     model call's logits as a digest), then frees them; 17d: a 1-rank mesh
     here (no process group) serves 17a's requests bit-equal to no mesh,
     device_stats of length 1. Each rank then builds the whole params
     from seed 0 and its sharded engine: 17a qwen2-1.5b at full width cut
     to TP_DENSE_LAYERS layers, flash on, max_batch 4, phase 8's nine
     prompts (one at SPEC_HOT_T), TP_SERVE_NEW new tokens each; 17b
     deepseek-moe-16b at full width cut to TP_MOE_LAYERS layers, phase
     14a's nine prompts, as many new tokens. Gates: every rank's tokens equal
     the other's and the unsharded engine's, every model call's logits
     bit-equal, every rank-local flash_fwd launch (qwen2: B=1, H=6, KvH=1,
     Hd=128) within FLASH_OUT_ULPS of flash_fwd_plain, and their exact
     count; printed: params a rank against the whole, the sharded leaves,
     a decode round's gathers and bytes gathered, launches a round a rank
     (profiled), round ms (2 ranks sharing one card: not a TP speed).
     17c: flash_decode_sharded at qwen2's decode shape (TP_DECODE, the
     seq dim over the ranks) against decode_attention on the whole cache
     within TP_DECODE_ATOL, the ranks' outputs bit-equal. 17e-17h: the
     other four families the same way, each first served unsharded here
     and freed, max_batch 4, cache_len 1024, five requests of
     TP_FAMILY_NEW new tokens (the last at SPEC_HOT_T): 17e hymba-1.5b
     cut to TP_HYBRID_SERVE_LAYERS layers with ssm_impl="pallas"
     (TP_HYBRID_PROMPTS; every ssm_scan
     launch, n_layers a prefill a rank on its 1600 of 3200 channels, held
     against ssm_scan_plain within SSM_RTOL, its states a thread the
     unsharded scans'); 17f rwkv6-7b cut to TP_RWKV_SERVE_LAYERS layers
     on every WKV form
     (TP_RWKV_PROMPTS; no kernel); 17g whisper-small uncut
     (TP_WHISPER_PROMPTS, each with its own f32 frames; no kernel); 17h
     internvl2-26b at full width cut to TP_VLM_LAYERS layers, flash on,
     256 patch lines before TP_VLM_TEXT (every flash_fwd launch on a
     rank's 24 / 4 heads held within FLASH_OUT_ULPS, n_layers a
     flash-sized admission a rank). For every sub-phase the bytes a rank
     holds are predicted from serve_specs on the abstract params and cache
     and printed before the world starts, and device_stats must equal
     them; the ranks' launches summed go to tp_serve, tp_moe, tp_hybrid,
     tp_ssm, tp_encdec and tp_vlm, where every kernel but the held one
     counts 0. A failure in any rank fails the phase; nothing falls back
     to the CPU, one rank or a plain version.
 18. data-parallel training: DP_RANKS ranks share the card (spawn, gloo
     through host memory, a FileStore under build/), each running, in
     turn and freeing its model between them, Trainer(cfg, loop,
     mesh={"data": 2}).run(): 18a DP on qwen2-1.5b at full width cut to
     DP_QWEN_LAYERS layers, flash on, phase 10's loop (512 x 8 global,
     DP_TRAIN_STEPS steps, seed 0, AdamW), after the same model's
     one-device run here: every step's loss within LOSS0_SUM_ATOL of the
     one-device run's, step 0's
     grad norm within DP_GNORM_RTOL, the replicated leaves' fingerprints
     equal on the ranks after every step, 16/8/8 flash launches a step
     a rank, one more step with every launch held to its plain version;
     18b the same with fsdp=True: params plus optimizer state a rank
     equal to the specs' prediction, rank 0 writes the final checkpoint
     (whole leaves), restored here on one device bit-equal to the ranks'
     gathered params, and one more one-device step from it; 18c
     deepseek-moe-16b cut as 14c, EP (ep_data): every moe layer on
     moe_ffn_ep (the routes counted), step 0's loss within MOE_LOSS0_ATOL
     of its estimate, one moe_ffn_ep call held to moe_ffn_ep_emulated
     within MOE_OUT_ULPS; 18d allreduce_int8 on one qwen2 leaf's per-rank
     grads after 18a's one step, the card's result bit-equal to the same
     call on host copies, the quantizer taken apart op by op (max, scale,
     quotient, round) under the parent's m / 127.0 and under the true
     division, every op bit-equal under the second, and pipelined_apply over the ranks within PIPE_ATOL of the dense
     scan, its gradient (a rank's stage, the stream) within PIPE_ATOL of
     autograd through the dense loop. Printed: step ms, peak memory and
     the bytes a step hands gloo a rank (2 ranks sharing one card: not a
     DP speed).
 19. tensor-parallel training: phase 18's world's ranks over a second
     mesh {"model": 2}, Trainer(cfg, loop, mesh).run() under the
     reference's training plan (row-parallel attention, FFNs, mamba path
     and rwkv mixes, a vocab-parallel embedding and loss where the vocab
     splits) for TP_TRAIN_STEPS steps: 19a qwen2-1.5b cut to
     TP_DENSE_LAYERS layers on phase 10's loop (18a's model and batches; a
     rank's attention at H 6, KvH 1), 19b deepseek-moe-16b cut to
     TP_MOE_LAYERS layers on 14c's loop (every moe layer on moe_ffn_ep's
     has_tp branch, the routes counted), 19c hymba-1.5b cut to
     TP_HYBRID_LAYERS layers on 15c's loop (attention whole on every rank:
     12.5 heads a rank; mamba's packed in_proj; its own one-device run
     first), 19d rwkv6-7b at 8 layers (15c's model and batches), 19e
     whisper-small uncut on f32 frames and 19f internvl2-26b at 8 layers
     (16c's; Adafactor; a rank's attention at H 24, KvH 4). Before the
     world starts, params plus optimizer state a rank, flash launches and
     model-axis collectives (calls and bytes) a step a rank are predicted
     from the specs and shapes (launch/predict.py's tp_collectives); each
     must come true on every rank. Every step's loss within
     LOSS0_SUM_ATOL of the one-device run of the same model and batches
     (18a's reference, 14c's run, 19c's
     own, 15c's and 16c's runs), step 0's grad norm within DP_GNORM_RTOL,
     the replicated leaves' fingerprints equal on the ranks after every
     step; 19a's and 19f's one more step holds every flash launch of a
     rank to its plain version within TP_TRAIN_ULPS. Printed: step ms
     against one device's, peak memory a rank (2 ranks sharing one card:
     not a TP speed).
 20. the static kernel auditor (repro_torch.analyze): the registry's
     censuses (every kernel, version and canonical key: the plain
     versions counted on fake tensors, nothing on the card) on the card's
     spec, run by a worker process started after the build, beside phases
     3-19; then CACHE001 over the tune cache phases 3-19 wrote; any error
     finding fails. At every canonical key of every version that launches
     a kernel (gpp v6-v10, flash cuda, ssm cuda, paged gather, int8 and
     verify) the library's own shared memory a block and grid
     (library_launch_shape) must equal the descriptor's model
     (config_smem_bytes, launch_grid), and one launch is held to its plain
     version on the same inputs (TOL_PLAIN["bench"], FLASH_OUT_ULPS,
     SSM_RTOL, PAGED_OUT_ULPS); every config the tune cache holds is held
     to the library the same way at its own key, without a launch.
     Printed: the census count, the findings by rule, the audit's
     seconds, and gpp v10's census FMA fraction (the plain version's
     arithmetic) beside phase 2b's SASS FMA ratio and the paper's 58%.
 21. FSDP beside a model axis: FSDP_TP_RANKS (4) ranks spawned on the
     card over gloo (a FileStore under build/, a timeout on the world and
     on every collective) on a {"data": 2, "model": 2} mesh,
     Trainer(cfg, loop, mesh, fsdp=True).run() on qwen2.5-32b at full
     width cut to FSDP_TP_LAYERS layers (flash on, Adafactor, remat
     "full") with phase 10's loop for FSDP_TP_STEPS steps: every leaf's
     spec asserted equal to the uncut config's default (FSDP; embed, wo,
     the biases, wi, wg, the FFN's wo and the head split over ('model',
     'data') on one dim), the same model on the same batches first run
     on one device here. Before the world starts, params plus optimizer
     state a rank, flash launches a step a rank and the data-group (FSDP's
     gathers and reduce-scatters, the sums; launch/predict.py's
     fsdp_data_collectives) and model-group (tp_collectives) calls and
     bytes a step a rank are
     predicted from the specs and shapes; each must come true on every
     rank. Every step's loss within LOSS0_SUM_ATOL of the one-device run,
     step 0's grad norm within DP_GNORM_RTOL, the fingerprints of the
     state's leaves each data group and each model group replicates equal
     across it after every step; rank 0's final checkpoint restored here
     on one device bit-equal to the ranks' gathered params; one more step
     holds every flash launch of a rank (H 20, KvH 4) to its plain version
     within TP_TRAIN_ULPS, counted exactly. Printed: step ms, peak memory
     a rank, the bytes a step hands gloo (4 ranks sharing one card: not
     an FSDP or TP speed). The 8-rank multi-pod mesh runs on the CPU only
     (tests/test_torch_fsdp_tp_pods.py).
 22. the dry-run and the examples. A worker process started after the
     build (beside phases 3-21, CPU only) censuses steps on fake tensors
     (analyze.census.census_step): each 19a-19f cell as rank 0 of an
     abstract {"model": TP_RANKS} mesh, phase 21's as rank 0 of an
     abstract FSDP_TP_SHAPE mesh, and one-device train steps of
     MODELED_RUNS (16c's whisper-small, 15c's rwkv6-7b: no flash kernel,
     so the census counts the ops the card runs). 22a: the model-group
     (and 21's data-group) calls and bytes a step and the params plus
     optimizer state a rank of every census equal what phases 19 and 21
     measured on every rank, to the call and byte. 22b: each modeled
     step (core.roofline.analyze_step on the card's spec) and live-byte
     high-water mark printed beside the measured step ms (p50), device
     busy ms and torch.cuda.max_memory_allocated, with the ratios. 22c:
     the four examples on the card (subprocesses, each its own tune
     cache): registry_smoke_torch.py (rc 0, every family's hand kernel
     launched, each against its ref version), train_lm_torch.py --preset
     smoke --steps 20 --ckpt-every 10 twice (the second prints "nothing
     to do"), quickstart_torch.py and serve_batched_torch.py.
Each path (phase 4's dispatch, phase 5's journey, phase 7's flash
checks, phase 7d's Hd 32 model check, phase 8's serving run, phase 10's
training run, phase 11's hybrid serving run, phase 12a's paged serving
run, phase 12b's dispatch, phase 13's spec serving run (spec_serve),
paged spec run (spec_paged) and Router run (router), phase 14's moe
serving run (moe_serve), paged moe run (moe_paged) and moe training run
(moe_train), phase 15's rwkv serving run (rwkv_serve), training runs
(hybrid_train, rwkv_train) and pallas step (hybrid-train-pallas), phase
16's serving runs (vlm_serve, vlm_paged, whisper_serve, whisper_paged)
and training runs (whisper_train, vlm_train), phase 17's sharded serving
runs (tp_serve, tp_moe, tp_hybrid, tp_ssm, tp_encdec, tp_vlm: every
rank's counts, summed), phase 18's data-parallel training runs
(dp_train, fsdp_train, ep_train: every rank's counts, summed), phase
19's tensor-parallel training runs (tp_dense_train, tp_moe_train,
tp_hybrid_train, tp_ssm_train, tp_encdec_train, tp_vlm_train: every
rank's counts, summed), phase 21's FSDP x TP training run
(fsdp_tp_train: every rank's counts, summed)) runs with the launch
counters zeroed just before it and read just after; the kernels line
gives each path's counts, and the script fails unless every kernel
launched on the paths that run it (gpp_fused on dispatch and journey,
gpp_banded on the journey, flash_fwd 28 times a prefill on the serving
run and a cold paged admission, SPEC_LAYERS + 1 an admission on the spec
runs and SPEC_LAYERS a flash-sized admission on the Router run,
flash_fwd 56 and each backward kernel 28 times a training step, ssm_scan
HYBRID_SERVE_LAYERS times a prefill on the hybrid serving run, each
paged_decode entry point on phase 12b's dispatch, flash_fwd
MOE_SERVE_LAYERS times a flash-sized admission on both moe serving runs,
8 and each backward kernel 4 times a moe training step, no kernel on
phase 15's serving and training runs, and ssm_scan in the forward of the
hymba pallas step, flash_fwd VLM_SERVE_LAYERS times a flash-sized
admission on both vlm serving runs, 16 and each backward kernel 8 times
a vlm training step, no kernel on whisper's runs, flash_fwd
TP_DENSE_LAYERS times an admission on each rank of tp_serve and 4 times
a flash-sized admission on each rank of tp_moe, ssm_scan
TP_HYBRID_SERVE_LAYERS times an admission on each rank of tp_hybrid and
flash_fwd 8 times a flash-sized admission on each rank of tp_vlm, and no
other kernel there, nor any on tp_ssm and tp_encdec; flash_fwd 2 x
DP_QWEN_LAYERS and each backward kernel DP_QWEN_LAYERS times a step on
each rank of dp_train and fsdp_train, 8 and 4 on ep_train, flash_fwd 2 x
TP_DENSE_LAYERS and each backward kernel TP_DENSE_LAYERS times a step on
each rank of tp_dense_train, 8 and 4 on tp_moe_train, 16 and 8 on
tp_vlm_train, and no kernel on tp_hybrid_train, tp_ssm_train and
tp_encdec_train; flash_fwd 2 x FSDP_TP_LAYERS and each backward kernel
FSDP_TP_LAYERS times a step on each rank of fsdp_tp_train, and no other
kernel there).

The last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without it. Without a card, or outside the repository, the
script fails before printing any result.
"""

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Kernel vs plain version, both float32, max-norm relative over partials
# and over totals. The two sum in another order (per-thread runs over the
# band chunks, then a block tree, in the kernel; one plane sum per band,
# then a run over the bands, in the plain version). At BENCH that costs a
# few 1e-6. At Si-214 terms near the poles of 1/|wdiff|^2 and 1/|cden|^2
# make the float32 sums ill-conditioned: phase 6 prints how far each of
# the two lies from a float64 run on the same (float32-rounded) inputs,
# and the two float32 results differ by about 1e-3 of the largest partial.
TOL_PLAIN = {"bench": 1e-4, "si214": 5e-3}
# planar f32 against complex128 at BENCH (tests/test_gpp_kernel.py:162)
TOL_REF = 1e-4
# phase 5: every journey version's modeled ms at most this times its
# measured ms (v6–v10's terms are bounds: counted instructions and
# compulsory bytes, so past 5% the count is at fault; v0–v5's memory term
# charges every op's inputs and outputs to HBM, not a strict bound where
# the 50 MB L2 serves an op's inputs, so past 5% there it overstates the
# traffic); measure.time_config of the tuned config within the spread of its
# calls of phase 4's tuner time, or within this share of it where the calls
# spread less (the dispatch has read 53.097 and 53.512 ms in two phases of
# one run on an H100: 0.8%)
MODEL_OVER_MEASURED = 1.05
TIME_CONFIG_RTOL = 0.03
# the main path's totals against a float64 run of the plain version on the
# same float32 inputs at Si-214 (the arithmetic's error alone)
TOL_F64 = 1e-3
# flash_fwd against flash_fwd_plain, compared in the working type (bf16
# out): within 2 bf16 ulps of each value's magnitude (an ulp is at most
# 2^-7 of it; floor 1% of the largest), since the kernel multiplies P V
# with a bf16 hi+lo split of p (~16 bits) and the tensor cores sum in
# another order than the plain f32 einsums, and each side rounds once to
# bf16. lse (f32, magnitude ~10) within 1e-4.
FLASH_OUT_ULPS = 2
FLASH_LSE_ATOL = 1e-4
# first-token logits in the served model, as max |difference| over max
# |logit|. bf16 evaluation of this random-weight 28-layer model has a
# floor: a one-ulp change in a few attention outputs of one layer moves
# the logits by about as much as any larger change, and the first
# full-width runs measured 2.5e-2 to 3.4e-2 between the kernel path and
# the same model with flash_fwd_plain in the kernel's place (every launch
# within 1 ulp of the plain version on its own inputs), and 3.3e-2 to
# 3.8e-2 against the chunked path (PERF.md). So both are held to 6e-2;
# the kernel itself is held at every launch of those prefills to
# FLASH_OUT_ULPS against its plain version on the same inputs.
SERVE_LOGIT_RTOL = 6e-2
SERVE_PROMPTS = (160, 160, 256, 256, 300, 300, 480, 480)
# sm90.cuh's wgmma alone against torch.matmul in f32 on the same bf16
# values: the products are exact in f32 and the sums (K <= 128 terms) run
# in another order, a few f32 ulps of the largest product
SM90_RTOL = 1e-5
# flash_bwd_dq / flash_bwd_dkv against their plain versions, both bf16
# out: max |difference| within one bf16 ulp at the largest |plain| element
# (2^(floor(log2 max) - 7)): both sum in f32 and round once, the kernel
# multiplies ds and p as a bf16 hi + lo split and sums in another order
BWD_ULPS = 1
# the FlashAttention gradient (bf16 in and out) against autograd through
# the f32 oracle on the same values, max-norm relative: the kernel path
# rounds out to bf16 before delta = rowsum(dout * out) and the grads to
# bf16 (2^-9 and 2^-8 of the largest), the oracle neither
BWD_REF_RTOL = 2.0 ** -6
# training from random weights: the final norm leaves each hidden row at
# RMS 1 and the tied table's entries are N(0, 0.02^2), so the step-0
# logits are ~N(0, s2), s2 = 0.02^2 d_model, independent of the label:
# E[lse] = ln V + s2 / 2, and the loss is lse + 1e-4 lse^2 (the z-loss).
# At qwen2-1.5b's d_model 1536 that is 12.2536; ln V + 1e-4 (ln V)^2 alone
# (11.945) leaves out the logits' spread.
LOSS0_ATOL = 0.05
# the same loss taken apart (loss0_terms, phases 15c and 16c): its mean
# lse held to LOSS0_ATOL of ln V + s2 / 2; its mean target logit, which
# random weights leave at 0 with a standard error sqrt(s2 / N) over N
# positions (internvl2-26b's 2048 text positions: 0.035, 70% of
# LOSS0_ATOL), held to LOSS0_SE standard errors; the terms' sum to the
# run's own step-0 loss within LOSS0_SUM_ATOL (no grad and flash's plain
# version against the traced step's kernels)
LOSS0_SE = 4.0
LOSS0_SUM_ATOL = 2e-3
INIT_SCALE = 0.02
TRAIN_STEPS = 4
# 11's, 13a-b's, 14a's, 16a's and 16b's new tokens a request (32 at
# first; halved twice, to make room for phases 19c-19f and 21)
FAMILY_SERVE_NEW = 8
# 16c's steps (PR 29: 2 of TRAIN_STEPS, to the same end; 19e and 19f read
# its first TP_TRAIN_STEPS)
ENCDEC_VLM_TRAIN_STEPS = 2
# phase 15c's hymba and rwkv runs (a hymba step takes ~4.5 s)
SSM_TRAIN_STEPS = 2
# ssm_scan against ssm_scan_plain, both f32: max |difference| of y within
# 1e-5 of the largest |y| (and of hT within 1e-5 of the largest |hT|):
# both run the recurrence in the same order along T; the kernel's expf,
# its FMA for the state update and its butterfly sum over N round
# differently from the plain version's exp, mul/add and einsum
SSM_RTOL = 1e-5
# hybrid serving (phase 11) at HYBRID_SERVE_LAYERS layers (uncut: 32; cut
# to make room for phase 21): the long prompt is longer
# than hymba's 1024-token window and a multiple of 64 (the chunked
# comparison then really chunks)
HYBRID_SERVE_LAYERS = 16
HYBRID_LONG_PROMPT = 1152
HYBRID_CACHE_LEN = 2048
# paged serving (phase 12a): one shared system prompt, page 16; the cold
# prompt and every hit's bucket to 512 (flash's S % 256 == 0 on a cold
# prefill, the same GEMM shapes for the bit-equality of restored lines)
PAGED_PAGE = 16
PAGED_SYSTEM_PROMPT = 256
PAGED_SUFFIXES = (32, 224, 96, 160, 64, 192, 128, 48)
# the paged decode kernels against their plain versions (phase 12b): both
# bf16 out of f32 sums taken in another order, each rounded once; within
# 2 bf16 ulps of the magnitude (bf16_ulps). gather against the ref oracle
# (which rounds p to bf16 before the value product) within 8e-3, as the
# JAX package's tests/test_kvcache.py holds its pair
PAGED_OUT_ULPS = 2
PAGED_REF_ATOL = 8e-3
# speculative serving (phase 13): the draft proposes SPEC_K tokens a round;
# phase 8's ninth request samples at SPEC_HOT_T
SPEC_K = 3
# phase 13's qwen2-1.5b depth, the target of 13a-13c and 13d's replicas
# (uncut: 28; cut to make room for phase 21)
SPEC_LAYERS = 14
SPEC_HOT_T = 0.8
# the Router (phase 13d): 2 replicas over this trace, replica 1 flapped
ROUTER_TRACE = dict(n_requests=16, prompt_median=128, prompt_max=256,
                    out_median=16, out_max=24, seed=0)
ROUTER_FLAP = dict(at_tick=6, down_ticks=4, times=1)
# the moe family (phase 14): deepseek-moe-16b served at full width with
# flash on; three prompts are flash-sized (S % 256 == 0: 28 flash_fwd
# launches an admission, moe admits at exact length), the others take the
# chunked route; MOE_HOT_PROMPT tokens at SPEC_HOT_T
MOE_PROMPTS = (256, 512, 512, 160, 224, 320, 400, 480)
# 14a's depth (uncut: 28; cut to make room for phase 21)
MOE_SERVE_LAYERS = 14
MOE_HOT_PROMPT = 200
# 14b: the moe layer on the card against the port's CPU run of it. Routing
# is discrete: where a token's k-th and (k+1)-th router probabilities, or
# an expert's last taken and first dropped routed weights, lie within
# MOE_MARGIN on the CPU run, the card's f32 router GEMM may choose the
# other way, so the experts and tokens that could move are left out
# (moe.settled; their counts printed); elsewhere gather_idx equal, gates
# within MOE_GATE_ATOL (f32 softmax and renormalisation in another order)
# and the output within MOE_OUT_ULPS bf16 ulps of the largest |out| (bf16
# expert products summed in f32 in another order, rounded once)
MOE_MARGIN = 1e-4
MOE_GATE_ATOL = 1e-5
MOE_OUT_ULPS = 2
# 14c: deepseek-moe-16b at full width cut to 4 layers (first_k_dense 1 + 3
# moe): the full depth's AdamW state does not fit one card. The step-0
# loss within MOE_LOSS0_ATOL of lse0 + 1e-4 lse0^2 (see LOSS0_ATOL; d_model
# 2048: lse0 = ln 102400 + 0.02^2 x 2048 / 2 = 11.946)
MOE_TRAIN_LAYERS = 4
MOE_LOSS0_ATOL = 0.3
# the rwkv6 family (phase 15a): rwkv6-7b served at full width, prompts on
# every WKV form: 40 tokens (one chunk), 200 (64 or more, not a multiple
# of 64: the sequential scan, T x 32 layer steps uncut, ~4.5 ms a token), 256
# and 512 (chunks of 64); RWKV_HOT_PROMPT tokens (the scan) at
# SPEC_HOT_T; RWKV_NEW new tokens each (PR 29 dropped the 160- and
# 384-token prompts, a second prompt of the scan and of the chunks, and
# halved RWKV_NEW from 16, to find phase 19c-19f's time); 15a's depth
# RWKV_SERVE_LAYERS (uncut: 32; cut to make room for phase 21; the decode
# gates below were read at 32)
RWKV_SERVE_LAYERS = 16
RWKV_PROMPTS = (40, 200, 256, 512)
RWKV_NEW = 8
RWKV_HOT_PROMPT = 100
# 15a's decode against prefill (200 -> 201, both the sequential scan),
# max-norm relative, held to a fixed RWKV_DECODE_RTOL: on an H100 80GB
# HBM3 at 700 W it read 6.95e-2 for the sound bf16 model (the same
# 201-token prefill alone and as row 0 of two rows lay 6.09e-2 apart: this
# model's bf16 floor is itself ~SERVE_LOGIT_RTOL), and 1.56 for a carried
# state that left the scan (256 -> 257, across the -60 clamp). The same
# comparison with the weights and activations in f32 (f32_storage) is the
# witness that the bf16 reading is rounding alone: held to
# RWKV_DECODE_F32_RTOL, far below the bf16 reading and far above f32's
# rounding through 32 layers.
RWKV_DECODE_RTOL = 0.15
RWKV_DECODE_F32_RTOL = 1e-3
# 15b: rwkv6-7b's layer 0 forward and backward on the card against the
# port's CPU run of the same code, at T = RWKV_LAYER_T (two 64-step chunks:
# the initial decay crosses the -60 clamp in each), every tensor within
# RWKV_LAYER_ULPS bf16 ulps at its largest element (ulp_at_max). The card's
# GEMMs sum in another order than the CPU's f32 products, so a bf16 value
# can round one ulp apart and the gate, the group norm and the squared
# relu carry it on; the token-shift mus' gradients are sums of signed
# terms over every token, whose error stands against a small largest
# element. On an H100 80GB HBM3 at 700 W the worst was 2.0 ulps (d
# tm/wv), 1.5 on the output; the gate is twice that.
RWKV_LAYER_T = 128
RWKV_LAYER_ULPS = 4
# wkv6_chunked in f32 against wkv6_scan in float64 (15b): the reference
# test's assert_allclose(atol=1e-3, rtol=1e-3) (tests/
# test_models_numerics.py:76-79) at its decay, w = exp(-exp(N(0,1) - 1)),
# at its chunks, 16 and 32, and the model's, 64. That decay's log has a
# heavy tail (a step of z = 5 alone is -e^4 = -55), so at full width
# (2M draws) a few channel-chunks reach the -60 clamp even at chunk 16,
# and the chunked form then leaves the scan for that head (on an H100:
# 1.96 at chunk 16, 17.9 at 32, 44.7 at 64, of max |y| 135; the inputs
# are seeded). So the gate holds every (row, head) up to the first chunk in
# which one of its channels reaches the clamp (99.0%, 95.2% and 31.6% of
# the positions there), and prints how far the rest is; at the model's
# initial decay every channel-chunk reaches it, so that case is printed
WKV_F64_ATOL = 1e-3
WKV_F64_CASES = (("test decay", 16), ("test decay", 32), ("test decay", 64),
                 ("initial decay", 64))
# 15c: hymba-1.5b trained at full width: 2048 x 2 (phase 10's 4,096
# tokens a step; at 2048 the 1024-token window masks half the keys);
# rwkv6-7b at full width cut to 8 layers (the full depth's AdamW state
# does not fit one card), 512 x 8
HYBRID_TRAIN_SEQ = 2048
HYBRID_TRAIN_BATCH = 2
# 15c's hymba-1.5b depth (uncut: 32; cut to 16 and then 8, to make room
# for phases 19c-19f and 21)
HYBRID_TRAIN_LAYERS = 8
RWKV_TRAIN_LAYERS = 8
RWKV_TRAIN_SEQ = 512
RWKV_TRAIN_BATCH = 8
# the vlm family (phase 16a): internvl2-26b served at full width, flash on;
# each prompt's text buckets under the room its 256 vis lines leave in a
# 1024-line slot: 160, 256 and 200 (the SPEC_HOT_T request) prefill 512
# rows and 300, 480 and 512 prefill 768 (flash_fwd, S % 256 == 0); 100
# prefills 384 rows, 600 and 700 their exact 856 and 956 (chunked)
VLM_CACHE_LEN = 1024
VLM_PROMPTS = (100, 160, 256, 300, 480, 512, 600, 700)
VLM_HOT_PROMPT = 200
# flash_fwd and SDPA printed at internvl2's largest flash prefill
VLM_OP_S = 768
# 16a's first-token logits, max-norm relative. At 48 layers internvl2-26b's
# bf16 floor lies above SERVE_LOGIT_RTOL: on an H100 80GB HBM3 at 700 W the
# two plain routes, with no kernel in either (flash's plain version in the
# kernel's place, and flash off: chunked attention, p rounded to bf16),
# lay 8.1e-2 to 1.03e-1 apart, and the kernel path 6.5e-2 to 1.0e-1 from
# either, with every flash_fwd launch within 1.0 bf16 ulp of its plain
# version. So at 48 layers the three are held only to the sanity bound
# VLM_LOGIT_RTOL. The gate the kernel path answers to is the witness at
# full width cut to VLM_WITNESS_LAYERS layers (the plain routes 2.8e-2
# apart there in bf16 on that card): every flash-sized request's kernel
# path against the plain version in its place and against flash off, each
# held to SERVE_LOGIT_RTOL; and with f32 weights and activations (48
# layers in f32 do not fit the card) the two plain routes held to
# VLM_F32_RTOL (7.0e-6 on that card), the witness that the bf16 distance
# between the routes is rounding
VLM_LOGIT_RTOL = 0.2
VLM_WITNESS_LAYERS = 8
# 16a's depth (uncut: 48; cut to make room for phases 21 and 22; the
# floors above were read at 48)
VLM_SERVE_LAYERS = 16
VLM_F32_RTOL = 1e-3
# the encdec family (phase 16b): whisper-small served at full width; 512
# lines are past real whisper's 448-token decoder cap (dec_pos has 32768
# rows); prompts of 16-400 tokens on bf16 frames, WHISPER_HOT_PROMPT on f32
# frames at SPEC_HOT_T
WHISPER_CACHE_LEN = 512
WHISPER_PROMPTS = (16, 40, 64, 100, 160, 250, 330, 400)
WHISPER_HOT_PROMPT = 120
# 16b's decode against prefill (200 -> 201): bf16 held to SERVE_LOGIT_RTOL;
# the same with f32 weights, activations and frames (f32_storage) to
# WHISPER_DECODE_F32_RTOL, the witness that the bf16 distance is rounding
WHISPER_DECODE_AT = 200
WHISPER_DECODE_F32_RTOL = 1e-3
# 16c: whisper-small at full width, 448 (whisper's decoder cap) x 8 on the
# Trainer's stub f32 frames; internvl2-26b at full width cut to 8 layers
# (4.258e9 parameters: the full depth's bf16 grads alone would be another
# 39.7 GB), 768 x 4 positions (256 vis + 512 text a row), Adafactor
VLM_TRAIN_LAYERS = 8
VLM_TRAIN_SEQ = 768
VLM_TRAIN_BATCH = 4
WHISPER_TRAIN_SEQ = 448
WHISPER_TRAIN_BATCH = 8
# tensor-parallel serving (phase 17): TP_RANKS ranks sharing the one card
# over gloo (NCCL refuses two ranks on one GPU), each holding its shards;
# 17a's qwen2-1.5b cut to TP_DENSE_LAYERS layers (8 before PR 29), 17b's
# deepseek-moe-16b to TP_MOE_LAYERS (a gloo round's gathers scale with
# depth); TP_SERVE_NEW new tokens (16 before PR 29); 17c's sharded
# flash-decode at qwen2's decode shape, held within the reference's 5e-3
TP_RANKS = 2
TP_DENSE_LAYERS = 4
TP_MOE_LAYERS = 4
TP_DECODE = dict(b=4, h=12, kvh=2, hd=128, l=8192, clen=8000)
TP_DECODE_ATOL = 5e-3
TP_WORLD_TIMEOUT_S = 900
TP_COLLECTIVE_TIMEOUT_S = 600
# 17e-17h: the other four families, max_batch 4, cache_len 1024,
# TP_FAMILY_NEW new tokens a request, the last request at SPEC_HOT_T.
# 17e hymba-1.5b at full width cut to TP_HYBRID_SERVE_LAYERS layers with
# ssm_impl "pallas" on prompts of exact length;
# 17f rwkv6-7b cut to TP_RWKV_SERVE_LAYERS on each WKV form (40: one
# chunk; 64, 256, 512: chunks of 64; 100: the sequential scan); 17g
# whisper-small uncut on short
# prompts, each with its own f32 frames (16b's hot request's); 17h
# internvl2-26b at full width cut to TP_VLM_LAYERS layers (its whole params
# beside two ranks' halves would not fit the card uncut), flash on, 256
# patch lines before text bucketed to 256, 256 and 512 lines (flash) and
# to 64 and 128 (chunked)
TP_FAMILY_NEW = 8
# 17a/17b's new tokens a request (phase 8's and 14a's prompts)
TP_SERVE_NEW = 8
TP_HYBRID_PROMPTS = (64, 200, 256, 512, 100)
TP_RWKV_PROMPTS = (40, 64, 256, 512, 100)
TP_WHISPER_PROMPTS = (8, 13, 20, 27, 32)
TP_VLM_TEXT = (256, 200, 480, 40, 100)
TP_VLM_LAYERS = 8
# 17e's hymba-1.5b depth (uncut: 32; cut to 16 and then 8, to make room
# for phases 19c-19f and 21)
TP_HYBRID_SERVE_LAYERS = 8
# 17f's rwkv6-7b depth (uncut: 32; cut to 16 and then 8, the same way)
TP_RWKV_SERVE_LAYERS = 8
# phase 17's sub-phases: (tag, the path its launches go to, the kernel each
# rank's launches are held for)
TP_RUNS = {"dense": ("17a", "tp_serve", "flash_fwd"),
           "moe": ("17b", "tp_moe", "flash_fwd"),
           "hybrid": ("17e", "tp_hybrid", "ssm_scan"),
           "ssm": ("17f", "tp_ssm", None),
           "encdec": ("17g", "tp_encdec", None),
           "vlm": ("17h", "tp_vlm", "flash_fwd")}
# data-parallel training (phase 18): DP_RANKS ranks sharing the one card
# over gloo; 18a/18b take phase 10's loop for DP_TRAIN_STEPS steps on
# qwen2-1.5b cut to DP_QWEN_LAYERS layers (a gloo step's bytes, hence its
# 8-10 s at 28 layers, scale with depth; 8 layers before PR 29; the
# one-device reference runs the same cut model first), 18c EP_TRAIN_STEPS
# steps of
# 14c's; step 0's grad norm within DP_GNORM_RTOL of one device's (the
# GEMMs see 4 x 512 rows a rank, not 8 x 512: cuBLAS may pick other
# kernels);
# 18d's pipeline (L layers, M microbatches of B rows, width D, f32) within
# PIPE_ATOL of the dense scan (the reference test's bound)
DP_RANKS = 2
DP_WORLD_TIMEOUT_S = 900
DP_COLLECTIVE_TIMEOUT_S = 600
DP_QWEN_LAYERS = 4
# 18a/18b's steps (18d's input is the grads of the batch after 18a's last
# step; at one step allreduce_int8 on the card and on host copies of those
# grads were not bit-equal on an H100 while the scale was m / 127.0, which
# CUDA computes as m * fl(1/127), so 18a/18b ran 2 steps until the scale
# became a true division; 18d takes that input apart op by op); 18c's (2
# until cut to make room for phase 21)
DP_TRAIN_STEPS = 1
EP_TRAIN_STEPS = 1
DP_GNORM_RTOL = 1e-2
PIPE_SHAPE = (8, 8, 16, 1024)
PIPE_ATOL = 1e-4
# tensor-parallel training (phase 19): phase 18's world's ranks over a
# second mesh {"model": DP_RANKS}; 19a qwen2-1.5b cut to TP_DENSE_LAYERS
# layers on phase 10's loop (18a's model and batches), 19b deepseek-moe-16b
# cut to TP_MOE_LAYERS layers on 14c's loop (512 x 8 = 4096 tokens: every
# moe layer on moe_ffn_ep's has_tp branch); 19c hymba-1.5b cut to
# TP_HYBRID_LAYERS layers on 15c's loop (2048 x 2; its own one-device run
# first: uncut over gloo a step would take ~25 s), 19d rwkv6-7b on 15c's
# run (8 layers, 512 x 8), 19e whisper-small uncut and 19f internvl2-26b at
# 8 layers (Adafactor, flash) on 16c's runs; TP_TRAIN_STEPS steps each (2
# until cut to make room for phase 21); a rank's flash launches of one
# checked step (19a, 19f) within TP_TRAIN_ULPS bf16 ulps; 19c's depth
# TP_HYBRID_LAYERS (8 until the same cut)
TP_TRAIN_STEPS = 1
TP_TRAIN_ULPS = 1.0
TP_HYBRID_LAYERS = 4
# 19d: rwkv6-7b's step-0 grad norm is set by rounding at the model's
# initial decay (the chunked WKV's -60 clamp): one device on the same
# batch with every product in another order (the batch in two halves,
# tools/rwkv_grad_order_probe.py) read 168.40 against 26.12 on an NVIDIA
# H100 80GB HBM3 at 700 W, 5.45 relative, and the WKV's heads in two
# halves alone nothing. So 19d's step-0 grad norm is held to that
# measurement, not to DP_GNORM_RTOL; its losses keep LOSS0_SUM_ATOL
TP_GNORM_RTOL = {"tp_ssm": 5.45}
# phase 19's sub-phases: (tag, the path its launches go to)
TP_TRAIN_RUNS = {"tp_dense": ("19a", "tp_dense_train"),
                 "tp_moe": ("19b", "tp_moe_train"),
                 "tp_hybrid": ("19c", "tp_hybrid_train"),
                 "tp_ssm": ("19d", "tp_ssm_train"),
                 "tp_encdec": ("19e", "tp_encdec_train"),
                 "tp_vlm": ("19f", "tp_vlm_train")}
# the local shapes each sub-phase prints (a few of its split leaves)
TP_SHAPE_LEAVES = {
    "tp_dense": ("embed", "layers/attn/wq", "layers/attn/wo"),
    "tp_moe": ("embed", "layers/attn/wq", "layers/attn/wo", "layers/moe/wi"),
    "tp_hybrid": ("embed", "layers/attn/wq", "layers/attn/wk",
                  "layers/mamba/in_proj", "layers/mamba/x_proj",
                  "layers/mamba/out_proj"),
    "tp_ssm": ("embed", "head", "layers/tm/wr", "layers/tm/u",
               "layers/tm/wo", "layers/cm/wv"),
    "tp_encdec": ("embed", "enc_layers/attn/wq", "enc_layers/ffn/bi",
                  "dec_layers/xattn/wk", "dec_layers/xattn/wo"),
    "tp_vlm": ("embed", "head", "layers/attn/wq", "layers/attn/wk",
               "layers/attn/wo")}
# FSDP beside a model axis (phase 21): FSDP_TP_RANKS ranks sharing the card
# over gloo on FSDP_TP_SHAPE; qwen2.5-32b at full width cut to
# FSDP_TP_LAYERS layers (2.53e9 params, 5.1 GB in bf16 whole; the rank's
# whole init is drawn on the card, 4 at once), flash on, its Adafactor,
# phase 10's loop (512 x 8) for FSDP_TP_STEPS steps, fsdp=True (the cut
# model is under 8e9 params, so its default plan would not take FSDP;
# every leaf's spec is asserted equal to the uncut config's default);
# losses within LOSS0_SUM_ATOL and step 0's grad norm within DP_GNORM_RTOL
# of the same model on one device; the final checkpoint under build/
FSDP_TP_RANKS = 4
FSDP_TP_SHAPE = {"data": 2, "model": 2}
FSDP_TP_LAYERS = 2
FSDP_TP_STEPS = 2
FSDP_TP_CKPT = os.path.join(ROOT, "build", "chip_smoke_fsdp_tp_ckpt")
# phase 7c's cases: (tag, B, T, C, N, h0 scale); inputs from seed 10 + index
SSM_CASES = (("hymba-prefill", 1, HYBRID_LONG_PROMPT, 3200, 16, 0.0),
             ("t4096", 1, 4096, 3200, 16, 0.0),
             ("b4-t256", 4, 256, 3200, 16, 0.0),
             ("small-n8", 2, 100, 48, 8, 0.1),
             ("hymba-prefill-h0", 1, HYBRID_LONG_PROMPT, 3200, 16, 0.1))


# phase 20's audit worker: how long phase 20 waits for it past phase 19
AUDIT_WAIT_S = 300
# phase 22: the census worker may run this long past phase 21; the
# one-device train runs whose steps 22b models (15c's and 16c's tags)
CENSUS_WAIT_S = 300
MODELED_RUNS = ("whisper", "rwkv")
EXAMPLE_TIMEOUT_S = 300


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel(a, b) -> float:
    """Max-norm relative error of a against b (torch or numpy)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def ulp_at_max(want) -> float:
    """One bf16 ulp at the largest |want| element."""
    import math
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in units of a bf16 ulp of the magnitude
    (2^-7 of max(|want|, 1% of max |want|))."""
    want = want.float()
    scale = want.abs().clamp_min(float(want.abs().max()) * 1e-2)
    return float(((got.float() - want).abs() / scale).max()) * 2 ** 7


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of fn() on the card, each call fenced by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]


def graph_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Median ms of one fn() replayed from a CUDA graph that holds n calls
    back to back: the kernel's device time, without the host's work of
    each call between launches (cuda_ms times the call as a caller sees
    it, host work included)."""
    import torch
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
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return sorted(times)[reps // 2]


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"{torch.cuda.get_device_name(0)} has capability {cap}, "
             "the kernels are built for sm_90a")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; capability {cap}", flush=True)
    # every phase's seconds, from the end of the one before it
    phase_s = {}
    mark = [t_start]

    def lap(tag):
        now = time.perf_counter()
        phase_s[tag] = round(now - mark[0], 1)
        mark[0] = now
        print(f"[{tag}] phase {tag} ran {phase_s[tag]:.1f} s [{card}]",
              flush=True)

    lap("1")

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    import repro_torch
    from repro_torch.core import hw
    from repro_torch.core.journey import (format_journey, format_row,
                                          run_journey)
    from repro_torch.kernels import _build, api
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.gpp import gpp_cuda, problem, ref
    from repro_torch.kernels.paged import paged_cuda
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.tune import measure, tuner

    # a fresh tune cache, so the main path tunes on this card
    tune_dir = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(tune_dir, ignore_errors=True)
    os.environ["REPRO_TUNE_CACHE"] = tune_dir
    dev = torch.device("cuda")
    spec = hw.spec_for_device(dev)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    # phase 20's censuses: CPU work only, in a worker beside phases 3-19
    audit = start_audit(spec)
    # phase 22's step censuses: CPU work only, in a worker beside 3-21
    census_job = start_census(spec)
    attrs = {c.name: gpp_cuda.kernel_attrs(c) for c in gpp_cuda.CONFIGS.values()}
    model = {c.name: c.regs_estimate() for c in gpp_cuda.CONFIGS.values()}
    # every compiled EPT: the most registers of its four instances (fused
    # or banded, either aqsm layout), what REGS_BY_EPT records
    by_ept = {ept: max(gpp_cuda.kernel_attrs(gpp_cuda.BlockConfig(
        "e", 16, 32 * ept, 8, tr, fused, 512)) for tr in (False, True)
        for fused in (False, True)) for ept in gpp_cuda.EPT_INSTANCES}
    print(f"[2] built {sorted(libs)} in {build_s:.1f} s; gpp compiled (regs, "
          f"spill bytes) per config: {attrs}; register table: {model}; per "
          f"EPT (the most of its instances): {by_ept}, REGS_BY_EPT "
          f"{gpp_cuda.REGS_BY_EPT}", flush=True)
    fattrs = {f"hd{hd}/q{bq}/kv{bkv}": flash_cuda.kernel_attrs(hd, bq, bkv)
              for hd in flash_cuda.HD_INSTANCES
              for bq in flash_cuda.BLK_Q_INSTANCES
              for bkv in flash_cuda.BLK_KV_INSTANCES}
    print(f"[2] flash_fwd compiled (regs, spill bytes) per instance: {fattrs}; "
          f"register table: {flash_cuda.REGS_BY_INSTANCE}", flush=True)
    battrs = {f"{kind}/hd{hd}/inner{inner}": flash_cuda.bwd_kernel_attrs(
        kind, hd, inner) for kind, inners in (
            ("dq", flash_cuda.DQ_BLK_KV_INSTANCES),
            ("dkv", flash_cuda.DKV_BLK_Q_INSTANCES))
        for hd in flash_cuda.HD_INSTANCES for inner in inners}
    dq_model = {f"hd{hd}/kv{kv}": (regs, flash_cuda.dq_resident_ctas(hd, kv))
                for (hd, kv), regs in flash_cuda.DQ_REGS_BY_INSTANCE.items()}
    print(f"[2] flash_bwd compiled (regs, spill bytes) per instance (dq: "
          f"inner = blk_kv; dkv: inner = blk_q): {battrs}; dq's register "
          f"table and the CTAs an SM it and the shared-memory model give: "
          f"{dq_model}; backward blocks dq {flash_cuda.DQ_BLOCKS}, dkv "
          f"{flash_cuda.DKV_BLOCKS}", flush=True)
    clusters = {f"hd{hd}/q{bq}/group{g}": flash_cuda.dkv_cluster_occupancy(
        hd, bq, g) for hd in flash_cuda.HD_INSTANCES
        for bq in flash_cuda.DKV_BLK_Q_INSTANCES for g in (1, 3, 5, 6, 8)}
    print(f"[2] flash_bwd_dkv clusters of `group` CTAs the card holds at "
          f"once (cudaOccupancyMaxActiveClusters): {clusters}", flush=True)
    sm90_line = sm90_checks(torch, dev)
    print(f"[2] sm90.cuh helpers alone: {sm90_line}", flush=True)
    sattrs = {f"n{n}/s{st}/{'bf16' if bf else 'f32'}":
              ssm_cuda.kernel_attrs(n, st, bf)
              for n, st in ssm_cuda.instances() for bf in (False, True)}
    print(f"[2] ssm_scan compiled (regs, spill bytes) per instance (N, "
          f"states a thread, params): {sattrs}", flush=True)
    pattrs = {f"{'int8' if i8 else 'bf16'}/hd{hd}/tiles{mt}":
              paged_cuda.kernel_attrs(i8, hd, mt) for i8 in (False, True)
              for hd in paged_cuda.HEAD_DIMS for mt in (1, 2)}
    pattrs["combine"] = paged_cuda.kernel_attrs(False, 128, 0)
    print(f"[2] paged_decode compiled (regs, spill bytes) per instance (pool, "
          f"head dim, 16-row tiles): {pattrs}; (shared memory B, stages) at "
          f"qwen2's decode (6 rows, ppb 16, 16 splits) "
          f"{paged_cuda.library_smem_bytes(6, 128, 16, 64, 16, 16, 2)}, "
          f"verify (24 rows) "
          f"{paged_cuda.library_smem_bytes(24, 128, 16, 64, 16, 16, 2)}, "
          f"B=8 x 8192 (ppb 4) "
          f"{paged_cuda.library_smem_bytes(6, 128, 16, 512, 4, 16, 2)}",
          flush=True)

    lap("2")

    # -- 2b. GPP's band loop and the scan's step loop counted from the SASS ----
    census = gpp_census(libs["gpp.cu"], spec, card)
    scan_census = ssm_census(libs["ssm_scan.cu"], spec, card)
    lap("2b")

    # -- 3. each kernel against its plain version ----------------------------
    checks = (("gpp_fused", gpp_cuda.gpp_fused, gpp_cuda.gpp_fused_plain,
               gpp_cuda.V9),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V6),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V7),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V8))
    compared = {}
    for size in (problem.BENCH, problem.SI214):
        inp = problem.make_inputs(size)
        t = problem.to_tensors(inp, dev)
        oracle = ref.ref_numpy(inp) if size is problem.BENCH else None
        for name, kern, plain, base in checks:
            cfg = base.clamped(size)
            got = kern(t, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = plain(t, cfg)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} {cfg.name} {size.name}: shape {tuple(got.shape)} "
                     f"vs {tuple(want.shape)} or non-finite partials")
            err_p = rel(got.cpu(), want.cpu())
            tot_got = got.reshape(-1, 4, size.nw).sum(0).cpu()
            tot_want = want.reshape(-1, 4, size.nw).sum(0).cpu()
            err_t = rel(tot_got, tot_want)
            line = (f"[3] {name} {cfg.name} {size.name}: partials "
                    f"{tuple(got.shape)} max_abs_err "
                    f"{float((got - want).abs().max()):.3e} rel {err_p:.2e}, "
                    f"totals rel {err_t:.2e} (tol {TOL_PLAIN[size.name]})")
            if max(err_p, err_t) > TOL_PLAIN[size.name]:
                fail(line)
            if oracle is not None:
                tot = tot_got.to(torch.float64).numpy()
                err_r = max(rel(tot[0] + 1j * tot[1], oracle[0]),
                            rel(tot[2] + 1j * tot[3], oracle[1]))
                line += f"; vs ref_numpy {err_r:.2e} (tol {TOL_REF})"
                if err_r > TOL_REF:
                    fail(line)
            ms = measure.time_callable(lambda: kern(t, cfg), device=dev,
                                       warmup=1, reps=5) * 1e3
            line += f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms [{card}]"
            print(line, flush=True)
            compared[(name, cfg.name, size.name)] = {
                "max_abs_err": float((got - want).abs().max()), "ms": ms,
                "plain_ms": plain_ms}
        del t
    lap("3")

    # -- 4. the main path: dispatch at Si-214 (v10, tuned on the card) --------
    size = problem.SI214
    inp = problem.make_inputs(size)
    counters = kernel_counters()

    def zero_counts():
        for f in counters:
            f.launches = 0

    def read_counts():
        return {f.__name__: f.launches for f in counters}

    zero_counts()
    ach, asx = repro_torch.dispatch("gpp", inp)
    torch.cuda.synchronize()
    by_path = {"dispatch": read_counts()}
    if by_path["dispatch"]["gpp_fused"] == 0:
        fail("dispatch('gpp') did not launch gpp_fused")
    if ach.shape != (size.nw,) or not (torch.isfinite(ach).all()
                                       and torch.isfinite(asx).all()):
        fail(f"main path output: shape {tuple(ach.shape)}, finite "
             f"{bool(torch.isfinite(ach).all())}/{bool(torch.isfinite(asx).all())}")
    tc = tuner.tune_kernel("gpp", size, device=dev)     # the memoized pick
    timed = ", ".join(f"({c.blk_ig},{c.blk_igp},{c.blk_band},t{c.threads}) "
                      f"{s * 1e3:.3f} ms" for c, s, _ in tc.timings)
    print(f"[4] dispatch('gpp') si214: launches {by_path['dispatch']}, "
          f"ach/asx finite, shape {tuple(ach.shape)}; the tuner ranked "
          f"{tc.ranked} candidates and timed {len(tc.timings)}: {timed}; "
          f"picked ({tc.config.blk_ig},{tc.config.blk_igp},"
          f"{tc.config.blk_band},t{tc.config.threads}) [{card}]", flush=True)
    lap("4")

    # -- 5. the journey --------------------------------------------------------
    zero_counts()
    # v0-v5 are plain torch (~6 s a call at Si-214): one timed call each,
    # no warm-up call
    rows = run_journey("si214", device=dev, warmup=0, reps=1,
                       versions=("v0", "v1", "v2", "v3", "v4", "v5"),
                       verbose=False)
    rows += run_journey("si214", device=dev, warmup=1, reps=5,
                        versions=("v6", "v7", "v8", "v9", "v10"),
                        verbose=False)
    torch.cuda.synchronize()
    by_path["journey"] = read_counts()
    for r in rows:
        print(f"[5] {format_row(r)} [{card}]", flush=True)
    print(f"[5] Table I [{card}]:\n{format_journey(rows, 'si214')}",
          flush=True)
    print(f"[5] journey launches {by_path['journey']} [{card}]", flush=True)
    for path, names in (("dispatch", ("gpp_fused",)),
                        ("journey", ("gpp_fused", "gpp_banded"))):
        for name in names:
            if by_path[path][name] <= 0:
                fail(f"{name} was not launched on the {path} path")
    bad = [r.version for r in rows if not r.rel_err < 1e-4]
    if bad:
        fail(f"journey versions off the oracle at TINY: {bad}")
    ratios = {r.version: round(r.modeled_ms / r.ms, 4) for r in rows}
    line = (f"[5] modeled over measured ms, each at most "
            f"{MODEL_OVER_MEASURED}: {ratios}; counts from "
            f"{ {r.version: r.report.extra['source'] for r in rows[5:7]} }")
    print(f"{line} [{card}]", flush=True)
    if max(ratios.values()) > MODEL_OVER_MEASURED:
        fail(line)
    # the tuner's GPP shorthands against phase 4's pick and time: with the
    # memo cleared, best_config reads the pick back from the tune cache
    tuner.clear_memo()
    best = tuner.best_config(size)
    t = problem.to_tensors(inp, dev)
    measure.time_config(t, best, device=dev, warmup=1, reps=1)
    calls = [measure.time_config(t, best, device=dev, warmup=0, reps=1)
             for _ in range(5)]
    cfg_s = statistics.median(calls)
    room = max(max(calls) - min(calls), TIME_CONFIG_RTOL * tc.measured_s)
    line = (f"[5] tuner.best_config(si214) {best}; phase 4's dispatch "
            f"resolved {tc.config}; measure.time_config of it "
            f"{cfg_s * 1e3:.3f} ms (calls {[round(c * 1e3, 3) for c in calls]}) "
            f"against phase 4's {tc.measured_s * 1e3:.3f} ms, within "
            f"{room * 1e3:.3f} ms")
    print(f"{line} [{card}]", flush=True)
    if best != tc.config or abs(cfg_s - tc.measured_s) > room:
        fail(line)
    lap("5")

    # -- 6. the main path's result against the plain version, times ----------
    tuned = api.resolve_config("gpp", t)
    t1 = time.perf_counter()
    want = gpp_cuda.gpp_fused_plain(t, tuned)
    torch.cuda.synchronize()
    fused_plain_ms = (time.perf_counter() - t1) * 1e3
    got = gpp_cuda.gpp_fused(t, tuned)     # the partials behind dispatch's sums
    fused_err = float((got - want).abs().max())
    err_parts = rel(got.cpu(), want.cpu())
    sums = want.sum((0, 1)).cpu()
    err_plain = max(rel(ach.cpu(), torch.complex(sums[0], sums[1])),
                    rel(asx.cpu(), torch.complex(sums[2], sums[3])))
    p64 = gpp_cuda.gpp_fused_plain({k: v.double() for k, v in t.items()}, tuned)
    s64 = p64.sum((0, 1)).cpu().numpy()
    err_f64 = max(rel(ach.cpu().numpy().astype(np.complex128), s64[0] + 1j * s64[1]),
                  rel(asx.cpu().numpy().astype(np.complex128), s64[2] + 1j * s64[3]))
    plain_f64 = max(rel(torch.complex(sums[0], sums[1]).numpy().astype(np.complex128),
                        s64[0] + 1j * s64[1]),
                    rel(torch.complex(sums[2], sums[3]).numpy().astype(np.complex128),
                        s64[2] + 1j * s64[3]))
    line = (f"[6] main path v10 cfg {tuned}: partials vs plain f32 rel "
            f"{err_parts:.2e}, totals vs plain f32 {err_plain:.2e} (tol "
            f"{TOL_PLAIN[size.name]}); against float64 on the same inputs: "
            f"kernel partials {rel(got.cpu().double(), p64.cpu()):.2e} totals "
            f"{err_f64:.2e} (tol {TOL_F64}), plain f32 partials "
            f"{rel(want.cpu().double(), p64.cpu()):.2e} totals {plain_f64:.2e}; "
            f"plain f32 {fused_plain_ms:.1f} ms")
    print(line, flush=True)
    if max(err_parts, err_plain) > TOL_PLAIN[size.name] or err_f64 > TOL_F64:
        fail(line)
    disp_ms = measure.time_callable(lambda: repro_torch.dispatch("gpp", t),
                                    device=dev, warmup=1, reps=5) * 1e3
    fused_ms = measure.time_callable(lambda: gpp_cuda.gpp_fused(t, tuned),
                                     device=dev, warmup=1, reps=5) * 1e3
    ops_ms = size.total_flops() / spec.fp32_flops * 1e3
    bytes_ms = size.min_hbm_bytes() / spec.hbm_bw * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    term = census[(True, True, tuned.ept_instance())]
    print(f"[6] dispatch('gpp') si214: {disp_ms:.3f} ms "
          f"{size.total_flops() / disp_ms / 1e9:.3f} TFLOP/s "
          f"({size.total_flops() / disp_ms / 1e9 / spec.fp32_flops * 1e12:.1%} "
          f"of the {spec.part} FP32 peak); gpp_fused alone {fused_ms:.3f} ms; "
          f"bound {bound_ms:.3f} ms ({bound_by}: {ops_ms:.3f} ms of FP32 at "
          f"{spec.fp32_flops / 1e12:.0f} TFLOP/s, {bytes_ms:.4f} ms of bytes); "
          f"issue bound of the tuned config's SASS (EPT "
          f"{tuned.ept_instance()}, {term['instructions_per_term']:.2f} "
          f"instructions a term) {term['issue_bound_ms']:.3f} ms, the kernel "
          f"at {term['issue_bound_ms'] / fused_ms:.1%} of it (fast path "
          f"{term['fast_path_per_term']:.2f} a term: "
          f"{term['fast_path_issue_bound_ms']:.3f} ms, "
          f"{term['fast_path_issue_bound_ms'] / fused_ms:.1%}); MUFU bound "
          f"{term['mufu_bound_ms']:.3f} ms [{card}]", flush=True)
    banded = compared[("gpp_banded", "v8", "si214")]
    lap("6")

    # -- 7. flash_fwd at op level --------------------------------------------
    zero_counts()
    flash_rows = flash_checks(torch, dev, spec, card, flash_cuda, flash_ref)
    torch.cuda.synchronize()
    by_path["flash-check"] = read_counts()
    lap("7")

    # -- 7b. the backward kernels at op level ----------------------------------
    zero_counts()
    bwd_rows = flash_bwd_checks(torch, dev, spec, card, flash_cuda, flash_ref)
    torch.cuda.synchronize()
    by_path["bwd-check"] = read_counts()
    lap("7b")

    # -- 7c. the selective scan at op level -------------------------------------
    zero_counts()
    ssm_rows = ssm_checks(torch, dev, spec, card, ssm_cuda)
    torch.cuda.synchronize()
    by_path["ssm-check"] = read_counts()
    lap("7c")

    # -- 7d. a reduced qwen2 at Hd 32 with flash on, forward and backward ------
    zero_counts()
    hd32 = hd32_model_check(torch, np, dev, card, flash_cuda)
    torch.cuda.synchronize()
    by_path["hd32-check"] = read_counts()
    lap("7d")

    # -- 8. dense serving: qwen2-1.5b at full width through ServeEngine -------
    print(f"[8] matmul flags before serving (the process's): "
          f"{matmul_flags(torch)}", flush=True)
    serve = serve_phase(torch, np, dev, card, flash_cuda, zero_counts,
                        read_counts, by_path)
    torch.cuda.empty_cache()
    lap("8")

    # -- 10. training: qwen2-1.5b at full width through Trainer ---------------
    print(f"[10] matmul flags before training (the process's): "
          f"{matmul_flags(torch)}", flush=True)
    train = train_phase(torch, np, dev, spec, card, flash_cuda, zero_counts,
                        read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    lap("10")

    # -- 11. hybrid serving: hymba-1.5b at full width through ServeEngine -----
    hybrid = hybrid_phase(torch, np, dev, card, ssm_cuda, zero_counts,
                          read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    lap("11")

    # -- 12a. paged serving: qwen2-1.5b through ServeEngine(kv_page_size=16) --
    paged_serve = paged_serve_phase(torch, np, dev, card, flash_cuda,
                                    zero_counts, read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    lap("12a")

    # -- 12b. the paged decode kernels: dispatch, then op level ---------------
    paged_rows = paged_checks(torch, np, dev, spec, card, zero_counts,
                              read_counts, by_path)

    gc.collect()
    torch.cuda.empty_cache()
    lap("12b")

    # -- 13. speculative serving, sampling on the card, the Router ------------
    t13 = time.perf_counter()
    spec_serve = spec_phase(torch, np, dev, card, flash_cuda, zero_counts,
                            read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    router = router_phase(torch, np, dev, card, flash_cuda, zero_counts,
                          read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    spec_serve["router"] = router
    spec_serve["phase_s"] = time.perf_counter() - t13
    print(f"[13] phase 13 ran {spec_serve['phase_s']:.1f} s [{card}]",
          flush=True)

    # -- 14. the moe family: deepseek-moe-16b served, its layer, trained -----
    t14 = time.perf_counter()
    moe_serve, moe_layer = moe_serve_phase(torch, np, dev, card, flash_cuda,
                                           zero_counts, read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    moe_rows = moe_layer_checks(torch, np, dev, spec, card, moe_layer)
    del moe_layer
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = moe_train_phase(torch, dev, spec, card, flash_cuda,
                                zero_counts, read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    moe = {"serve": moe_serve, "layer": moe_rows, "train": moe_train,
           "phase_s": time.perf_counter() - t14}
    print(f"[14] phase 14 ran {moe['phase_s']:.1f} s [{card}]", flush=True)

    # -- 15. rwkv6-7b served, its layer; hymba and rwkv trained ---------------
    t15 = time.perf_counter()
    rwkv_serve, rwkv_layer = rwkv_serve_phase(torch, np, dev, card,
                                              zero_counts, read_counts,
                                              by_path)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_rows = rwkv_layer_checks(torch, np, dev, spec, card, rwkv_layer)
    del rwkv_layer
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train = ssm_train_phase(torch, dev, spec, card, zero_counts,
                                read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = {"serve": rwkv_serve, "layer": rwkv_rows, "train": ssm_train,
                 "phase_s": time.perf_counter() - t15}
    print(f"[15] phase 15 ran {recurrent['phase_s']:.1f} s (15a "
          f"{rwkv_serve['phase_s']:.1f} s, 15b {rwkv_rows['phase_s']:.1f} s, "
          f"15c {ssm_train['phase_s']:.1f} s) [{card}]", flush=True)

    # -- 16. internvl2-26b and whisper-small served; both trained -------------
    t16 = time.perf_counter()
    vlm_serve = vlm_serve_phase(torch, np, dev, spec, card, flash_cuda,
                                zero_counts, read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_serve = whisper_serve_phase(torch, np, dev, card, zero_counts,
                                        read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    ev_train = encdec_vlm_train_phase(torch, dev, spec, card, flash_cuda,
                                      zero_counts, read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    encdec_vlm = {"vlm_serve": vlm_serve, "whisper_serve": whisper_serve,
                  "train": ev_train, "phase_s": time.perf_counter() - t16}
    print(f"[16] phase 16 ran {encdec_vlm['phase_s']:.1f} s (16a "
          f"{vlm_serve['phase_s']:.1f} s, 16b {whisper_serve['phase_s']:.1f} "
          f"s, 16c {ev_train['phase_s']:.1f} s) [{card}]", flush=True)

    # -- 17. tensor-parallel serving: 2 ranks on the card over gloo -----------
    tp = tp_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
                  by_path)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18. data-parallel training, 19. tensor-parallel training: 2 ranks --
    # on the card over gloo, one world
    dp, tp_train = dp_phase(torch, np, dev, card, flash_cuda, zero_counts,
                            read_counts, by_path, moe_train, ssm_train,
                            ev_train)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 20. the static kernel auditor ----------------------------------------
    audited = audit_phase(torch, dev, spec, card, tune_dir, audit,
                          tuned.ept_instance(), term)

    # -- 21. FSDP beside a model axis: 4 ranks on the card over gloo ---------
    fsdp_tp = fsdp_tp_phase(torch, np, dev, card, flash_cuda, zero_counts,
                            read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 22. the dry-run's census against 19, 21, 15c and 16c; the examples -
    dry = dryrun_phase(torch, card, census_job, tp_train, fsdp_tp,
                       {"whisper": ev_train["whisper"],
                        "rwkv": ssm_train["rwkv"]})

    names = ("gpp_fused", "gpp_banded", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv", "ssm_scan", "paged_decode_gather",
             "paged_decode_int8", "paged_decode_verify")
    launches = {name: {path: n[name] for path, n in by_path.items()}
                for name in names}
    f512 = flash_rows["s512"]
    kernels = [
        {"name": "gpp_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:219",
         "launches": launches["gpp_fused"]["dispatch"]
         + launches["gpp_fused"]["journey"],
         "launches_by_path": launches["gpp_fused"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "sass_census": {k: term[k] for k in (
             "instructions_per_term", "fast_path_per_term", "fma_ratio",
             "mufu_per_term", "issue_bound_ms", "fast_path_issue_bound_ms",
             "mufu_bound_ms")}},
        {"name": "gpp_banded", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:192",
         "launches": launches["gpp_banded"]["dispatch"]
         + launches["gpp_banded"]["journey"],
         "launches_by_path": launches["gpp_banded"],
         "max_abs_err": banded["max_abs_err"], "ms": banded["ms"],
         "plain_ms": banded["plain_ms"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "sass_census": {k: census[(False, True, 1)][k] for k in (
             "instructions_per_term", "fast_path_per_term", "fma_ratio",
             "lds_bytes_per_term", "issue_bound_ms")}},
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash.cu",
         "replaces": "src/repro/kernels/flash/flash.py:37",
         "launches": launches["flash_fwd"]["serve"],
         "launches_by_path": launches["flash_fwd"],
         "max_abs_err": f512["max_abs_err"], "ms": f512["ms"],
         "plain_ms": f512["plain_ms"], "bound_ms": f512["bound_ms"],
         "bound_by": f512["bound_by"], "library_ms": f512["library_ms"],
         "shape": f512["shape"], "at_s4096": flash_rows["s4096"],
         "at_train": flash_rows["train"]},
    ]
    for name, tpu in (("flash_bwd_dq", 142), ("flash_bwd_dkv", 179)):
        row = bwd_rows["train"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_bwd.cu",
            "replaces": f"src/repro/kernels/flash/flash.py:{tpu}",
            "launches": launches[name]["train"],
            "launches_by_path": launches[name], **row,
            "library_covers": "dq, dk and dv together (SDPA backward)",
            "shape": bwd_rows["train"]["shape"],
            "at_s4096": bwd_rows["s4096"][name],
            "hd32_model_worst_ulps": hd32["worst"][name]})
    row = ssm_rows["hymba-prefill"]
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm/ssm_scan.py:30",
        "launches": launches["ssm_scan"]["hybrid-serve"],
        "launches_by_path": launches["ssm_scan"],
        **{k: row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                               "bound_ms", "bound_by", "shape", "blk_c",
                               "states", "from_float64")},
        "library_ms": None,
        "library_note": "no PyTorch call computes the selective scan",
        "sass_census": {k: scan_census[row["states"]][k] for k in (
            "instructions_per_element", "shfl_per_element", "fma_ratio",
            "mufu_per_element", "bounds")},
        "at_t4096": ssm_rows["t4096"]})
    for name, line_no, tag, at in (
            ("paged_decode_gather", 123, "decode", ("decode-ragged", "long",
                                                    "empty-rows")),
            ("paged_decode_int8", 222, "int8", ("long-int8",)),
            ("paged_decode_verify", 182, "verify-bf16", ("verify-int8",
                                                        "empty-rows"))):
        row = paged_rows[tag]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": f"src/repro/kernels/paged/paged.py:{line_no}",
            "launches": launches[name]["paged"],
            "launches_by_path": launches[name],
            **{k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms",
                                   "library_gather_ms",
                                   "library_gather_device_ms", "shape", "ppb",
                                   "splits", "grid", "worst_ulps")},
            "library_note": "scaled_dot_product_attention on the already-"
                            "gathered dense K/V (gather not counted); "
                            "library_gather_*: gather + the same SDPA",
            **{f"at_{t}": {k: paged_rows[t][k] for k in (
                "device_ms", "bound_ms", "bound_by", "library_device_ms",
                "library_gather_device_ms", "plain_ms",
                "ppb", "splits", "grid", "worst_ulps")} for t in at}})
    print(f"[8] serving summary: {json.dumps(serve)} [{card}]", flush=True)
    print(f"[10] training summary: {json.dumps(train)} [{card}]", flush=True)
    print(f"[11] hybrid serving summary: {json.dumps(hybrid)} [{card}]",
          flush=True)
    print(f"[12a] paged serving summary: {json.dumps(paged_serve)} [{card}]",
          flush=True)
    print(f"[13] spec serving and router summary: {json.dumps(spec_serve)} "
          f"[{card}]", flush=True)
    print(f"[14] moe summary: {json.dumps(moe)} [{card}]", flush=True)
    print(f"[15] rwkv6 and recurrent training summary: "
          f"{json.dumps(recurrent)} [{card}]", flush=True)
    print(f"[16] encdec and vlm summary: {json.dumps(encdec_vlm)} [{card}]",
          flush=True)
    print(f"[17] tensor-parallel summary: {json.dumps(tp)} [{card}]",
          flush=True)
    print(f"[18] data-parallel summary: {json.dumps(dp)} [{card}]",
          flush=True)
    print(f"[19] tensor-parallel training summary: {json.dumps(tp_train)} "
          f"[{card}]", flush=True)
    print(f"[20] static audit summary: {json.dumps(audited)} [{card}]",
          flush=True)
    print(f"[21] FSDP beside a model axis summary: {json.dumps(fsdp_tp)} "
          f"[{card}]", flush=True)
    print(f"[22] dry-run and examples summary: {json.dumps(dry)} [{card}]",
          flush=True)
    for tag, part in (("13", spec_serve), ("14", moe), ("15", recurrent),
                      ("16", encdec_vlm), ("17", tp), ("18", dp),
                      ("19", tp_train), ("20", audited), ("21", fsdp_tp),
                      ("22", dry)):
        phase_s[tag] = round(part["phase_s"], 1)
    print(f"[9] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          f"(build {build_s:.1f} s; every phase's seconds "
          f"{json.dumps(phase_s)}) [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def audit_worker(spec_name, out_path):
    """Phase 20's censuses in a worker process: audit_registry over every
    registered kernel at its canonical keys on the named spec, the tune
    cache left to phase 20. The plain versions run on fake tensors on the
    CPU; nothing here touches the card. The report goes to out_path as
    JSON with the audit's seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.analyze import audit_registry
    from repro_torch.core import hw
    t0 = time.perf_counter()
    report = audit_registry(spec=hw.SPECS[spec_name], skip_cache=True,
                            device="cpu")
    payload = report.to_json()
    payload["audit_s"] = time.perf_counter() - t0
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, out_path)


def start_audit(spec):
    """Start audit_worker (spawn, daemonic: it dies with this process)."""
    import multiprocessing
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_path = os.path.join(ROOT, "build", "chip_smoke_audit.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    proc = multiprocessing.get_context("spawn").Process(
        target=audit_worker, args=(spec.name, out_path), daemon=True)
    proc.start()
    return proc, out_path


def audit_launch(torch, dev, k, version, key, cfg):
    """Launch `version` of kernel family `k` once at `key` under `cfg` on
    make_example's inputs on the card, and hold it to its plain version on
    the same inputs. Returns (error, tolerance, unit)."""
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.gpp import gpp_cuda
    from repro_torch.kernels.paged import paged, paged_cuda
    from repro_torch.kernels.ssm import ssm_cuda
    args, kwargs = k.make_example(key, device=dev)
    if k.name == "gpp":
        # the partials behind run()'s sums, as phase 3
        kern, plain = ((gpp_cuda.gpp_fused, gpp_cuda.gpp_fused_plain)
                       if cfg.fused_acc else
                       (gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain))
        got, want = kern(args[0], cfg), plain(args[0], cfg)
        return rel(got.cpu(), want.cpu()), TOL_PLAIN["bench"], "rel"
    got = k.run(*args, version=version, config=cfg, device=dev, **kwargs)
    if k.name == "flash":
        want, _ = flash_cuda.flash_fwd_plain(*args, cfg, kwargs["causal"])
        return bf16_ulps(got, want), FLASH_OUT_ULPS, "bf16 ulps"
    if k.name == "ssm":
        want = ssm_cuda.ssm_scan_plain(*args, cfg)
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        return err, SSM_RTOL, "of the largest"
    q, kp, vp, table, clen = args
    ppb = cfg.pages_per_block
    splits = paged_cuda.splits_for(q, kp, table)
    ks = vs = None
    if version == "int8":
        (kp, ks), (vp, vs) = paged.quantize_pool(kp), paged.quantize_pool(vp)
    if q.dim() == 4 or version == "verify":
        want = paged.paged_decode_verify(q, kp, vp, table, clen,
                                         pages_per_block=ppb, kscale=ks,
                                         vscale=vs, splits=splits)
    elif version == "int8":
        want = paged.paged_decode_int8(q, kp, vp, table, clen, ks, vs,
                                       pages_per_block=ppb, splits=splits)
    else:
        want = paged.paged_decode_gather(q, kp, vp, table, clen,
                                         pages_per_block=ppb, splits=splits)
    return bf16_ulps(got, want), PAGED_OUT_ULPS, "bf16 ulps"


def audit_phase(torch, dev, spec, card, tune_dir, audit, sass_ept,
                sass_term):
    """Phase 20: the worker's censuses and CACHE001 over this run's tune
    cache (any error finding fails); at every canonical launch the
    library's shared memory and grid held equal to the descriptor's model
    and one launch held to its plain version; every tuned config held to
    the library at its own key. Returns phase 20's results."""
    from repro_torch.analyze import rules
    from repro_torch.kernels import api
    from repro_torch.tune import tuner
    t20 = time.perf_counter()
    proc, out_path = audit
    proc.join(timeout=AUDIT_WAIT_S)
    if proc.is_alive():
        proc.kill()
        fail(f"[20] the audit worker ran {AUDIT_WAIT_S} s past phase 19")
    if proc.exitcode != 0 or not os.path.exists(out_path):
        fail(f"[20] the audit worker exited with {proc.exitcode}")
    wait_s = time.perf_counter() - t20
    with open(out_path) as fh:
        report = json.load(fh)
    t1 = time.perf_counter()
    cache = [f.row() for f in rules.audit_tune_cache(tune_dir)]
    cache_s = time.perf_counter() - t1
    entries = tuner._load_cache(tune_dir)
    findings = report["findings"] + cache
    by_rule = {}
    for f in findings:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    errors = [f for f in findings if f["severity"] == "error"]
    print(f"[20] static audit on {report['spec']} ({spec.part}): "
          f"{len(report['censuses'])} censuses in {report['audit_s']:.1f} s "
          f"(the worker, beside phases 3-19; waited {wait_s:.1f} s for "
          f"it), CACHE001 over the {len(entries)} entries of "
          f"{tuner._cache_path(tune_dir)} in {cache_s:.2f} s; findings by "
          f"rule {by_rule}, {len(errors)} errors [{card}]", flush=True)
    if errors:
        fail(f"[20] error findings: {json.dumps(errors)}")

    launches = []
    for c in report["censuses"]:
        if c["smem_config_bytes"] is None:
            continue                   # a plain-only version
        k = api.get_kernel(c["kernel"])
        key = k.key_from_dims(c["key_dims"])
        cfg = k.clamp(k.config_from_json(c["config"]), key)
        lib = k.library_launch_shape(cfg, key, c["version"])
        model = (c["smem_config_bytes"], c["grid_blocks"])
        err, tol, unit = audit_launch(torch, dev, k, c["version"], key, cfg)
        torch.cuda.synchronize()
        line = (f"[20] {c['kernel']} {c['version']} at {c['key_dims']}: "
                f"shared memory a block library {lib[0]} B, model "
                f"{model[0]} B; blocks library {lib[1]}, model {model[1]}; "
                f"one launch against the plain version {err:.3g} {unit} "
                f"(tol {tol})")
        print(f"{line} [{card}]", flush=True)
        if lib != model or err > tol:
            fail(line)
        launches.append({"kernel": c["kernel"], "version": c["version"],
                         "key": c["key_dims"], "smem_library": lib[0],
                         "smem_model": model[0], "grid": lib[1],
                         "err": err})
    tuned = 0
    for ckey, entry in sorted(entries.items()):
        kname, dims, _tag, version = ckey.split("|")
        k = api.get_kernel(kname)
        key = k.key_from_dims(dims)
        cfg = k.clamp(k.config_from_json(entry["config"]), key)
        model = (k.config_smem_bytes(cfg, key, version=version, spec=spec),
                 k.launch_grid(cfg, key, version=version, spec=spec))
        lib = k.library_launch_shape(cfg, key, version)
        if lib != model:
            fail(f"[20] tuned {ckey} {cfg}: library (shared memory, blocks) "
                 f"{lib}, model {model}")
        tuned += 1
    print(f"[20] every tuned config of the cache ({tuned}) at its own key: "
          f"the library's shared memory a block and blocks equal the "
          f"model's [{card}]", flush=True)
    fma = {c["key_dims"]: round(c["fma_fraction"], 4)
           for c in report["censuses"]
           if c["kernel"] == "gpp" and c["version"] == "v10"}
    print(f"[20] gpp v10 FMA: the census of its plain version (2 min(mul, "
          f"add) / FLOPs, by key) {fma}; phase 2b's SASS FMA ratio of the "
          f"tuned config's band loop (EPT {sass_ept}) "
          f"{sass_term['fma_ratio']:.3f}; the paper's 58% on the V100 (no "
          f"gate) [{card}]", flush=True)
    res = {"phase_s": time.perf_counter() - t20,
           "audit_s": report["audit_s"], "wait_s": wait_s,
           "cache_s": cache_s, "censuses": len(report["censuses"]),
           "findings_by_rule": by_rule, "cache_entries": len(entries),
           "tuned_checked": tuned, "launches": launches,
           "v10_census_fma": fma,
           "sass_fma_ratio": sass_term["fma_ratio"]}
    print(f"[20] phase 20 ran {res['phase_s']:.1f} s [{card}]", flush=True)
    return res


def kernel_counters():
    """Every kernel wrapper of the port (each counts its launches)."""
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.gpp import gpp_cuda
    from repro_torch.kernels.paged import paged_cuda
    from repro_torch.kernels.ssm import ssm_cuda
    return (gpp_cuda.gpp_fused, gpp_cuda.gpp_banded, flash_cuda.flash_fwd,
            flash_cuda.flash_bwd_dq, flash_cuda.flash_bwd_dkv,
            ssm_cuda.ssm_scan) + paged_cuda.ENTRY_POINTS


def matmul_flags(torch) -> dict:
    """The two CUDA matmul flags the port's f32-accumulation guard turns
    off (repro_torch.backend.f32_accumulation)."""
    m = torch.backends.cuda.matmul
    return {"allow_bf16_reduced_precision_reduction":
            m.allow_bf16_reduced_precision_reduction,
            "allow_tf32": m.allow_tf32}


def check_flags_inside(tag, seen, card):
    """Print the flags recorded inside a phase's own work; fail unless
    every record has both off."""
    off = {"allow_bf16_reduced_precision_reduction": False,
           "allow_tf32": False}
    line = (f"[{tag}] matmul flags inside the phase ({len(seen)} reads from "
            f"the port's own calls): {seen[0] if seen else None}; all off "
            f"(the port's guard): {bool(seen) and all(s == off for s in seen)}")
    print(f"{line} [{card}]", flush=True)
    if not seen or any(s != off for s in seen):
        fail(line)


def gpp_census(lib_path, spec, card) -> dict:
    """Phase 2b: gpp.cu's built library disassembled (cuobjdump -sass); the
    band loop of gpp_fused_kernel<2, EPT, true> and of gpp_banded_kernel<2,
    EPT, TRANSPOSED> in both aqsm layouts (v6's strided, v7/v8's swapped)
    counted by opcode class for every compiled EPT (repro_torch.core.sass):
    instructions a term, the FMA ratio, the bytes its LDS read a term, and
    the issue and MUFU bounds at Si-214; then the fast-path counts of the
    journey's instances beside gpu_model's table. Returns {(fused,
    transposed, ept): census}."""
    from repro_torch.core import gpu_model, sass
    from repro_torch.kernels.gpp import gpp_cuda, problem
    text, tool = sass.disassemble(str(lib_path))
    terms = problem.SI214.inner_iters
    out = {}
    for name, fused, transposed in (("gpp_fused", True, True),
                                    ("gpp_banded", False, False),
                                    ("gpp_banded", False, True)):
        for ept in gpp_cuda.EPT_INSTANCES:
            c = sass.term_census(
                text, rf"{name}_kernelILi2ELi{ept}ELb{int(transposed)}E",
                gpp_cuda.RECIPROCALS_PER_TERM)
            c["issue_bound_ms"] = sass.issue_bound_s(
                terms, c["instructions_per_term"], spec) * 1e3
            c["fast_path_issue_bound_ms"] = sass.issue_bound_s(
                terms, c["fast_path_per_term"], spec) * 1e3
            c["mufu_bound_ms"] = sass.mufu_bound_s(
                terms, c["mufu_per_term"], spec) * 1e3
            out[(fused, transposed, ept)] = c
            per = {k: round(v, 2) for k, v in c["per_term"].items()}
            layout = "(band, igp)" if transposed else "(igp, band)"
            print(f"[2b] {name} aqsm {layout} EPT {ept} band loop ({tool}): "
                  f"{c['loop_instructions']} instructions for "
                  f"{c['terms_per_iteration']} terms = "
                  f"{c['instructions_per_term']:.2f} a term "
                  f"{json.dumps(per)}, {c['fast_path_per_term']:.2f} without "
                  f"the reciprocals' slow-path call stubs; FMA ratio "
                  f"{c['fma_ratio']:.3f}; LDS {c['lds_bytes_per_term']:.2f} B "
                  f"a term; Si-214 issue bound {c['issue_bound_ms']:.3f} ms "
                  f"({c['fast_path_issue_bound_ms']:.3f} ms on the fast "
                  f"path), MUFU bound {c['mufu_bound_ms']:.3f} ms [{card}]",
                  flush=True)
    journey = {v: (c.fused_acc, c.aqsm_transposed, c.ept_instance())
               for v, c in gpp_cuda.CONFIGS.items()}
    table = {v: gpu_model.BAND_LOOP[k] for v, k in journey.items()}
    same = all(gpu_model.BAND_LOOP[k] == (c["fast_path_per_term"],
                                          c["lds_bytes_per_term"])
               for k, c in out.items())
    counted = {v: (out[k]["fast_path_per_term"], out[k]["lds_bytes_per_term"])
               for v, k in journey.items()}
    line = (f"[2b] the journey's instances (fused, transposed, EPT) "
            f"{journey}: fast-path instructions and LDS bytes a term "
            f"{counted}; gpu_model.BAND_LOOP {table}; the table equals this "
            f"census at every compiled instance: {same}")
    print(f"{line} [{card}]", flush=True)
    if not same:
        fail(f"{line}: gpu_model.BAND_LOOP is stale against the built "
             f"gpp.cu; re-record it from the counts above")
    return out


def ssm_census(lib_path, spec, card) -> dict:
    """Phase 2b: ssm_scan.cu's built library disassembled; the step loop of
    every ssm_scan_kernel<16, S, bf16> instance (hymba-1.5b's) counted by
    class per (t, c, n) element, one MUFU.EX2 each (ssm_cuda.census):
    instructions an element, shuffles, the FMA ratio, and at hymba's
    prefill and at T=4096 the issue bound on the SMs the grid of the
    model's best config at that S uses and on all of them, and the MUFU
    bound. Returns {states: census}."""
    from repro_torch.core import sass
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.tune import tuner
    text, tool = sass.disassemble(str(lib_path))
    out = ssm_cuda.census(text)
    for states, c in sorted(out.items()):
        c.pop("body")
        bounds = {}
        for tag, t in (("hymba-prefill", HYBRID_LONG_PROMPT), ("t4096", 4096)):
            key = SsmKey(1, t, 3200, 16)
            cfg = next(cfg for cfg, _ in tuner.rank_kernel(
                "ssm", key, device="cuda") if cfg.states == states)
            elems = key.b * key.t * key.c * key.n
            used = min(spec.sms, key.b * key.c // cfg.blk_c)
            ipe = c["instructions_per_element"]
            bounds[tag] = {
                "blk_c": cfg.blk_c, "sms": used,
                "issue_ms": sass.issue_bound_s(elems, ipe, spec, used) * 1e3,
                "issue_ms_all_sms": sass.issue_bound_s(elems, ipe, spec) * 1e3,
                "mufu_ms": sass.mufu_bound_s(elems, c["mufu_per_element"],
                                             spec, used) * 1e3}
        c["bounds"] = bounds
        per = {k: round(v, 3) for k, v in c["per_element"].items()}
        print(f"[2b] ssm_scan_kernel<16, S={states}, bf16> step loop ({tool}): "
              f"{c['loop_instructions']} instructions for "
              f"{c['elements_per_iteration']} (t, c, n) elements = "
              f"{c['instructions_per_element']:.3f} an element "
              f"{json.dumps(per)}, of them SHFL {c['shfl_per_element']:.3f}; "
              f"FMA ratio {c['fma_ratio']:.3f}; bounds (issue on the grid's "
              f"SMs and on all {spec.sms}, MUFU): {json.dumps(bounds)} "
              f"[{card}]", flush=True)
    return out


def hd32_model_check(torch, np, dev, card, flash_cuda):
    """Phase 7d: a reduced qwen2 (Hd 32, reduce_config) with flash on, one
    loss and its gradients through the model at S=512: flash_fwd,
    flash_bwd_dq and flash_bwd_dkv launch on the card at Hd 32 (zero-padded
    to the Hd 64 instances) and every launch is held against its plain
    version on its own inputs (FLASH_OUT_ULPS forward, BWD_ULPS backward)."""
    import dataclasses
    import repro_torch
    from repro_torch.configs.base import reduce_config
    cfg = dataclasses.replace(
        reduce_config(repro_torch.get_config("qwen2-1.5b"), layers=2,
                      d_model=384, vocab=1024), use_flash_attention=True)
    model = repro_torch.build_model(cfg)
    params = model.init_params(0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 512))).to(dev)
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}

    def fwd_check(args, got):
        errs["flash_fwd"].append(bf16_ulps(got[0], flash_cuda.flash_fwd_plain(
            *args)[0]))

    def bwd_check(name, plain):
        def check(args, got):
            want = plain(*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    leaves = [p for p in _leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    with hold_launches(flash_cuda, "flash_fwd", fwd_check), \
            hold_launches(flash_cuda, "flash_bwd_dq", bwd_check(
                "flash_bwd_dq", flash_cuda.flash_bwd_dq_plain)), \
            hold_launches(flash_cuda, "flash_bwd_dkv", bwd_check(
                "flash_bwd_dkv", flash_cuda.flash_bwd_dkv_plain)):
        loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    worst = {k: max(v) if v else None for k, v in errs.items()}
    n = {k: len(v) for k, v in errs.items()}
    line = (f"[7d] reduced qwen2 (Hd {cfg.head_dim}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}) with flash on, B=2, S=512: loss {float(loss.detach()):.4f}, "
            f"grads finite {finite}; launches {n} (expected "
            f"{cfg.n_layers} each); worst vs plain: flash_fwd "
            f"{worst['flash_fwd']} bf16 ulps (tol {FLASH_OUT_ULPS}), "
            f"flash_bwd_dq {worst['flash_bwd_dq']} and flash_bwd_dkv "
            f"{worst['flash_bwd_dkv']} ulps at the largest element (tol "
            f"{BWD_ULPS}) [{card}]")
    print(line, flush=True)
    if (not finite or any(c != cfg.n_layers for c in n.values())
            or worst["flash_fwd"] > FLASH_OUT_ULPS
            or max(worst["flash_bwd_dq"], worst["flash_bwd_dkv"]) > BWD_ULPS):
        fail(line)
    del params, grads, leaves
    return {"launches": n, "worst": worst}


def sm90_checks(torch, dev) -> str:
    """Phase 2: the shared helpers of csrc/sm90.cuh on their own — one
    wgmma product for every operand mode, N and K against torch.matmul in
    f32 (products exact, only the summation order differs: within
    SM90_RTOL of the largest |product|), and TMA boxes of a contiguous and
    a strided (B, S, heads, Hd) tensor against slices (bit-equal)."""
    from repro_torch.kernels import sm90_check
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for mode in sm90_check.MODES:
        for k in sm90_check.K_SIZES:
            for n in sm90_check.N_SIZES:
                a = torch.randn((64, k), generator=gen, device=dev).to(torch.bfloat16)
                b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                want = a.float() @ b.float()
                got = sm90_check.wgmma_product(a, b, mode)
                err = float((got - want).abs().max() / want.abs().max())
                if err > SM90_RTOL:
                    fail(f"[2] wgmma {mode} n{n} k{k}: max-norm rel {err:.2e} "
                         f"(tol {SM90_RTOL})")
                worst = max(worst, err)
    boxes = 0
    for hd in (64, 128):
        x = torch.randn((2, 256, 3, hd), generator=gen, device=dev).to(torch.bfloat16)
        for t in (x, x.transpose(1, 2).contiguous().transpose(1, 2)):
            for rows, head, row0, b in ((64, 1, 64, 1), (128, 2, 128, 0)):
                if not torch.equal(sm90_check.tma_rows(t, rows, head, row0, b),
                                   t[b, row0:row0 + rows, head]):
                    fail(f"[2] TMA box ({rows} rows, head {head}, row {row0}, "
                         f"batch {b}) of {tuple(t.shape)} strides {t.stride()} "
                         f"differs from the slice")
                boxes += 1
    return (f"wgmma {len(sm90_check.MODES)} modes x N {sm90_check.N_SIZES} x "
            f"K {sm90_check.K_SIZES} vs torch.matmul f32, worst max-norm rel "
            f"{worst:.2e} (tol {SM90_RTOL}); {boxes} TMA boxes bit-equal to "
            f"their slices")


def flash_checks(torch, dev, spec, card, flash_cuda, flash_ref):
    """Phase 7: flash_fwd against flash_fwd_plain (and the f32 oracle at
    S=512); times, bound. Returns the rows keyed 's512' and 's4096' (the
    serving shape at the larger bucket, and the operations-bound size)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (("s256", 1, 256, 12, 2, 128, None),
             ("s512", 1, 512, 12, 2, 128, None),
             ("s4096", 1, 4096, 12, 2, 128, None),
             ("train", 8, 512, 12, 2, 128, None),
             ("mha512", 1, 512, 32, 32, 128, None),
             ("s512-q128-kv64", 1, 512, 12, 2, 128, (128, 64)),
             ("hd32", 2, 512, 12, 2, 32, None))     # reduce_config's Hd, padded
    from repro_torch.kernels import api
    from repro_torch.tune import tuner
    rows = {}
    for tag, b, s, h, kvh, hd, blocks in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev
                               ).to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                 (b, s, kvh, hd)))
        if blocks is None:      # what the model path dispatches at this shape
            key = api.get_kernel("flash").problem_key(q, k, v)
            cfg = tuner.tune_kernel("flash", key, measure_mode=False,
                                    device=dev).config
        else:
            cfg = flash_cuda.FlashBlockConfig("check", *blocks)
        out, lse = flash_cuda.flash_fwd(q, k, v, cfg, True)
        torch.cuda.synchronize()
        p_out, p_lse = flash_cuda.flash_fwd_plain(q, k, v, cfg, True)
        torch.cuda.synchronize()
        ulps = bf16_ulps(out, p_out)
        lse_err = float((lse - p_lse).abs().max())
        max_abs = float((out.float() - p_out.float()).abs().max())
        line = (f"[7] flash_fwd {tag} (B={b}, S={s}, H={h}, KvH={kvh}, "
                f"Hd={hd}) blocks ({cfg.blk_q},{cfg.blk_kv}): out vs plain "
                f"max_abs {max_abs:.3e} = {ulps:.2f} bf16 ulps (tol "
                f"{FLASH_OUT_ULPS}), lse {lse_err:.2e} (tol {FLASH_LSE_ATOL})")
        if not (torch.isfinite(out.float()).all() and ulps <= FLASH_OUT_ULPS
                and lse_err <= FLASH_LSE_ATOL):
            fail(line)
        if tag == "s512":
            qp = q.transpose(1, 2).reshape(b * h, s, hd).float()
            kp = k.transpose(1, 2).reshape(b * kvh, s, hd).float()
            vp = v.transpose(1, 2).reshape(b * kvh, s, hd).float()
            want = flash_ref.reference(qp, kp, vp).reshape(b, h, s, hd
                                                           ).transpose(1, 2)
            r_ulps = bf16_ulps(out, want)
            line += f"; vs f32 ref.reference {r_ulps:.2f} ulps (tol {FLASH_OUT_ULPS})"
            if r_ulps > FLASH_OUT_ULPS:
                fail(line)
        ms = cuda_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        dev_ms = graph_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        plain_ms = cuda_ms(lambda: flash_cuda.flash_fwd_plain(q, k, v, cfg,
                                                              True), reps=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
        lib_dev_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True))
        ops_ms = flash_cuda.useful_flops(b, h, s, s, hd, True) \
            / spec.bf16_tc_flops * 1e3
        bytes_ms = flash_cuda.min_bytes(b, h, kvh, s, s, hd) / spec.hbm_bw * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        line += (f"; kernel {ms:.4f} ms (device {dev_ms:.4f} ms from a CUDA "
                 f"graph), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
                 f"(device {lib_dev_ms:.4f} ms); bound {bound:.4f} ms ({by}: "
                 f"{ops_ms:.4f} ms of bf16 at {spec.bf16_tc_flops / 1e12:.0f} "
                 f"TFLOP/s, {bytes_ms:.4f} ms of bytes) [{card}]")
        print(line, flush=True)
        rows[tag] = {"shape": [b, s, h, kvh, hd],
                     "blocks": [cfg.blk_q, cfg.blk_kv], "max_abs_err": max_abs,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms}
        if tag in ("s512", "s4096", "train"):
            rows[tag]["sweep"] = flash_sweep(torch, flash_cuda, q, k, v, cfg,
                                             tag, card)
    return rows


def flash_sweep(torch, flash_cuda, q, k, v, pick, tag, card):
    """Phase 7's model pick beside a timed sweep of the whole menu at one
    shape: each config's modeled ms and its device ms (graph_ms: at short
    S a call's host work hides the kernel), every one held against the
    plain version (FLASH_OUT_ULPS). Returns {"b_q x b_kv": device ms}."""
    from repro_torch.core import gpu_model
    from repro_torch.kernels import api
    kern = api.get_kernel("flash")
    key = kern.problem_key(q, k, v)
    timed = {}
    parts = []
    for cfg in kern.config_space(key, "cuda"):
        out, _ = flash_cuda.flash_fwd(q, k, v, cfg, True)
        p_out, _ = flash_cuda.flash_fwd_plain(q, k, v, cfg, True)
        ulps = bf16_ulps(out, p_out)
        if ulps > FLASH_OUT_ULPS:
            fail(f"[7] flash_fwd {tag} sweep ({cfg.blk_q},{cfg.blk_kv}): "
                 f"{ulps:.2f} bf16 ulps off the plain version")
        ms = graph_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        name = f"{cfg.blk_q}x{cfg.blk_kv}"
        timed[name] = ms
        parts.append(f"{name} modeled {gpu_model.flash_step_s(key, cfg) * 1e3:.4f}"
                     f" ms, device {ms:.4f} ms")
    best = min(timed, key=timed.get)
    print(f"[7] flash_fwd {tag} model pick {pick.blk_q}x{pick.blk_kv} beside "
          f"the timed sweep: {'; '.join(parts)}; fastest on the device {best} "
          f"[{card}]", flush=True)
    return timed


def flash_bwd_checks(torch, dev, spec, card, flash_cuda, flash_ref):
    """Phase 7b: flash_bwd_dq and flash_bwd_dkv against their plain versions
    on the kernel forward's lse (and, at the training shape, the
    FlashAttention gradient against the f32 oracle); times, bounds.
    Returns the rows keyed by case, each with one entry per kernel."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(1)
    # blocks: None for bwd_configs, else ((dq's blk_q, blk_kv), (dkv's))
    cases = (("train", 8, 512, 12, 2, 128, None, True),
             ("s4096", 1, 4096, 12, 2, 128, None, True),
             ("mha512", 1, 512, 32, 32, 128, None, True),
             ("group3", 1, 512, 24, 8, 128, None, True),     # phi4-mini's heads
             ("group16", 1, 512, 16, 1, 128, None, True),    # f32 partials
             ("s512-dq64x128-dkv32x64", 1, 512, 12, 2, 128,
              ((64, 128), (32, 64)), True),
             ("s512-noncausal", 1, 512, 12, 2, 128, None, False),
             ("hd64", 1, 512, 12, 2, 64, None, True),
             ("hd32", 2, 512, 12, 2, 32, None, True))    # padded to Hd 64
    plain = {"flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    rows = {}
    for tag, b, s, h, kvh, hd, blocks, causal in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev
                                   ).to(torch.bfloat16)
                       for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                     (b, s, kvh, hd), (b, s, h, hd)))
        out, lse = flash_cuda.flash_fwd(q, k, v, flash_cuda.FlashBlockConfig(),
                                        causal)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(
            b * h, s).contiguous()
        cfgs = (flash_cuda.bwd_configs(s, s) if blocks is None else
                tuple(flash_cuda.FlashBlockConfig("check", *bl)
                      for bl in blocks))
        kargs = {name: (q, k, v, do, lse, delta, c, causal)
                 for name, c in zip(plain, cfgs)}
        got = {"flash_bwd_dq": (flash_cuda.flash_bwd_dq(*kargs["flash_bwd_dq"]),),
               "flash_bwd_dkv": flash_cuda.flash_bwd_dkv(*kargs["flash_bwd_dkv"])}
        torch.cuda.synchronize()
        row = {"shape": [b, s, h, kvh, hd],
               "blocks": {name: [c.blk_q, c.blk_kv]
                          for name, c in zip(plain, cfgs)},
               "causal": causal}
        line = (f"[7b] {tag} (B={b}, S={s}, H={h}, KvH={kvh}, Hd={hd}, "
                f"{'causal' if causal else 'full'}) blocks dq "
                f"({cfgs[0].blk_q},{cfgs[0].blk_kv}) dkv ({cfgs[1].blk_q},"
                f"{cfgs[1].blk_kv}):")
        ok = True
        for name, outs in got.items():
            want = plain[name](*kargs[name])
            want = want if isinstance(want, tuple) else (want,)
            errs = [(float((g.float() - w.float()).abs().max()), ulp_at_max(w))
                    for g, w in zip(outs, want)]
            ok &= all(bool(torch.isfinite(g.float()).all()) for g in outs)
            ok &= all(e <= BWD_ULPS * u for e, u in errs)
            row[name] = {"max_abs_err": max(e for e, _ in errs),
                         "err_over_ulp_at_max": max(e / u for e, u in errs)}
            line += (f" {name} vs plain max_abs "
                     f"{[f'{e:.3e}' for e, _ in errs]} = "
                     f"{row[name]['err_over_ulp_at_max']:.2f} ulp at max "
                     f"(tol {BWD_ULPS});")
        if tag in ("train", "s4096"):
            again = flash_cuda.flash_bwd_dkv(*kargs["flash_bwd_dkv"])
            same = all(torch.equal(a, b_) for a, b_ in
                       zip(again, got["flash_bwd_dkv"]))
            ok &= same
            row["dkv_bit_equal_rerun"] = same
            line += f" flash_bwd_dkv bit-equal over two launches: {same};"
            del again
        again = flash_cuda.flash_bwd_dq(*kargs["flash_bwd_dq"])
        same = torch.equal(again, got["flash_bwd_dq"][0])
        ok &= same
        row["flash_bwd_dq"]["bit_equal_rerun"] = same
        dq_regs = flash_cuda.bwd_kernel_attrs(
            "dq", flash_cuda.run_head_dim(hd), cfgs[0].blk_kv)
        row["flash_bwd_dq"]["regs_spill"] = list(dq_regs)
        line += (f" flash_bwd_dq bit-equal over two launches: {same}, "
                 f"(regs, spill bytes) {dq_regs};")
        del again
        if not ok:
            fail(line)
        if tag == "train":
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out2 = flash_cuda.flash_attention_diff(
                *leaves, flash_cuda.FlashBlockConfig(), causal)
            grads = torch.autograd.grad(out2, leaves, do)
            ref = [x.float().requires_grad_(True) for x in (q, k, v)]
            planar = [x.transpose(1, 2).reshape(-1, s, hd) for x in ref]
            r_out = flash_ref.reference(*planar, causal=causal).reshape(
                b, h, s, hd).transpose(1, 2)
            want = torch.autograd.grad(r_out, ref, do.float())
            rels = [float((g.float() - w).abs().max() / w.abs().max())
                    for g, w in zip(grads, want)]
            line += (f" FlashAttention grads vs f32 ref.reference, max-norm "
                     f"rel (dq, dk, dv) {[f'{r:.2e}' for r in rels]} (tol "
                     f"{BWD_REF_RTOL:.2e});")
            if max(rels) > BWD_REF_RTOL:
                fail(line)
            row["grad_vs_ref_rel"] = max(rels)
            del leaves, out2, grads, ref, planar, r_out, want
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        o_t = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        for name, kern in (("flash_bwd_dq", flash_cuda.flash_bwd_dq),
                           ("flash_bwd_dkv", flash_cuda.flash_bwd_dkv)):
            kind = name.split("_")[-1]
            args = kargs[name]
            ms = cuda_ms(lambda: kern(*args))
            dev_ms = graph_ms(lambda: kern(*args))
            plain_ms = cuda_ms(lambda: plain[name](*args), reps=5, warmup=1)
            ops_ms = flash_cuda.bwd_useful_flops(b, h, s, s, hd, causal, kind) \
                / spec.bf16_tc_flops * 1e3
            bytes_ms = flash_cuda.bwd_min_bytes(b, h, kvh, s, s, hd, kind) \
                / spec.hbm_bw * 1e3
            bound = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            row[name].update({"ms": ms, "device_ms": dev_ms,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "bound_by": by, "library_ms": lib_ms})
            line += (f" {name} {ms:.4f} ms (device {dev_ms:.4f} ms from a CUDA "
                     f"graph), plain {plain_ms:.3f} ms, bound "
                     f"{bound:.4f} ms ({by}: {ops_ms:.4f} ms of bf16, "
                     f"{bytes_ms:.4f} ms of bytes);")
        line += (f" sdpa backward (dq, dk, dv) {lib_ms:.4f} ms [{card}]")
        print(line, flush=True)
        rows[tag] = row
        del q, k, v, do, out, lse, delta, got, qt, kt, vt, o_t
    return rows


def ssm_inputs(torch, dev, b, t, c, n, seed, h0_scale):
    """The scan's operands as the model hands them over: x, dt, b, c f32
    (x, b, c ~ N(0, 1), dt = softplus(N(0, 1) - 2)), a_log = log(1..N) and
    d ~ N(0, 1) as bf16 params, h0 = h0_scale N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(b, t, c)
    dt = torch.nn.functional.softplus(rnd(b, t, c) - 2)
    bm, cm = rnd(b, t, n), rnd(b, t, n)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))[None].repeat(c, 1)
    d = rnd(c)
    h0 = h0_scale * rnd(b, c, n)
    return (x, dt, bm, cm, a_log.to(torch.bfloat16), d.to(torch.bfloat16), h0)


def ssm_errors(got, want):
    """(max |y diff| / max |y|, max |hT diff| / max |hT|, max |y diff|)."""
    (y, h), (py, ph) = got, want
    dy = float((y - py).abs().max())
    dh = float((h - ph).abs().max())
    return (dy / float(py.abs().max()), dh / max(float(ph.abs().max()), 1e-30),
            dy)


def ssm_checks(torch, dev, spec, card, ssm_cuda):
    """Phase 7c: ssm_scan against ssm_scan_plain, bit-equal over two
    launches, and the distance of both from a float64 run of the plain
    version on the same inputs; call and device ms, bound; at the prefill
    and T=4096 the config sweep. Returns the rows keyed by case."""
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.tune import tuner
    rows = {}
    for i, (tag, b, t, c, n, h0) in enumerate(SSM_CASES):
        args = ssm_inputs(torch, dev, b, t, c, n, seed=10 + i, h0_scale=h0)
        key = SsmKey(b=b, t=t, c=c, n=n)
        # the config the model path takes (mamba_path's model-only pick)
        cfg = tuner.tune_kernel("ssm", key, measure_mode=False,
                                device=dev).config
        got = ssm_cuda.ssm_scan(*args, cfg)
        again = ssm_cuda.ssm_scan(*args, cfg)
        torch.cuda.synchronize()
        want = ssm_cuda.ssm_scan_plain(*args, cfg)
        y_rel, h_rel, dy = ssm_errors(got, want)
        same = all(bool(torch.equal(_bits(a), _bits(b_)))
                   for a, b_ in zip(got, again))
        y64, h64 = ssm_cuda.ssm_scan_plain(*args, cfg, dtype=torch.float64)
        f64 = {"y": rel(got[0].double().cpu(), y64.cpu()),
               "hT": rel(got[1].double().cpu(), h64.cpu()),
               "plain_y": rel(want[0].double().cpu(), y64.cpu()),
               "plain_hT": rel(want[1].double().cpu(), h64.cpu())}
        line = (f"[7c] ssm_scan {tag} (B={b}, T={t}, C={c}, N={n}, h0 "
                f"{h0}) states {cfg.states} blk_c {cfg.blk_c}: y vs plain "
                f"max_abs {dy:.3e} = {y_rel:.2e} of max |y|, hT {h_rel:.2e} "
                f"of max |hT| (tol {SSM_RTOL}); two launches bit-equal "
                f"{same}; from float64 (max |diff| / max |y64|): kernel y "
                f"{f64['y']:.3e} hT {f64['hT']:.3e}, plain f32 y "
                f"{f64['plain_y']:.3e} hT {f64['plain_hT']:.3e}")
        finite = bool(torch.isfinite(got[0]).all() and
                      torch.isfinite(got[1]).all())
        if not finite or not same or max(y_rel, h_rel) > SSM_RTOL:
            fail(line)
        ms = cuda_ms(lambda: ssm_cuda.ssm_scan(*args, cfg))
        dev_ms = graph_ms(lambda: ssm_cuda.ssm_scan(*args, cfg))
        plain_ms = cuda_ms(lambda: ssm_cuda.ssm_scan_plain(*args, cfg),
                           reps=3, warmup=1)
        io = sum(x.numel() * x.element_size() for x in args + got)
        bytes_ms = io / spec.hbm_bw * 1e3
        ops_ms = ssm_cuda.useful_flops(b, t, c, n) / spec.fp32_flops * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        line += (f"; kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
                 f"(CUDA graph), plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
                 f"({by}: {bytes_ms:.4f} ms of {io / 1e6:.2f} MB at "
                 f"{spec.hbm_bw / 1e12:.2f} TB/s, {ops_ms:.4f} ms of FP32 at "
                 f"{spec.fp32_flops / 1e12:.0f} TFLOP/s); no PyTorch call "
                 f"computes the scan [{card}]")
        print(line, flush=True)
        rows[tag] = {"shape": [b, t, c, n], "blk_c": cfg.blk_c,
                     "states": cfg.states, "max_abs_err": dy, "y_rel": y_rel,
                     "h_rel": h_rel, "from_float64": f64, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by}
        if tag in ("hymba-prefill", "t4096"):
            sweep = [(c_.states, c_.blk_c, round(s_ * 1e3, 4),
                      round(graph_ms(lambda c_=c_: ssm_cuda.ssm_scan(*args,
                                                                     c_)), 4))
                     for c_, s_ in tuner.rank_kernel("ssm", key, device=dev)]
            best = min(sweep, key=lambda r: r[3])
            rows[tag]["sweep"] = sweep
            print(f"[7c] ssm_scan {tag}: every config of the space, (states, "
                  f"blk_c, modeled ms, measured device ms) in the model's "
                  f"order: {sweep}; the model's pick {sweep[0][:2]} at "
                  f"{sweep[0][3]} ms, the measured best {best[:2]} at "
                  f"{best[3]} ms [{card}]", flush=True)
        del args, got, again, want, y64, h64
    return rows


def hybrid_phase(torch, np, dev, card, ssm_cuda, zero_counts, read_counts,
                 by_path):
    """Phase 11: ServeEngine on hymba-1.5b at full width, ssm_impl "pallas"."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    base = dataclasses.replace(repro_torch.get_config("hymba-1.5b"),
                               n_layers=HYBRID_SERVE_LAYERS)
    cfg = dataclasses.replace(base, ssm_impl="pallas")
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=HYBRID_CACHE_LEN,
                      device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in SERVE_PROMPTS + (HYBRID_LONG_PROMPT,)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=FAMILY_SERVE_NEW)
            for i, p in enumerate(prompts)]
    # warm-up: one short request (cuBLAS handles, the library's first load)
    eng.run([Request(rid=99, prompt=prompts[0][:64], max_new_tokens=2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    by_path["hybrid-serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_pre = stats["prefills"]
    got = by_path["hybrid-serve"]
    line = (f"[11] serve hymba-1.5b (full width, {cfg.n_layers} layers, "
            f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s), ssm_impl "
            f"'pallas': {stats['requests']} requests (prompts "
            f"{[len(p) for p in prompts]}), {n_pre} prefills, "
            f"{stats['decode_steps']} decode steps, {stats['new_tokens']} "
            f"tokens; launches {got} (ssm_scan expected {cfg.n_layers} x "
            f"{n_pre} = {cfg.n_layers * n_pre}) [{card}]")
    print(line, flush=True)
    others = {k: v for k, v in got.items() if k != "ssm_scan"}
    if (got["ssm_scan"] != cfg.n_layers * n_pre or n_pre != len(reqs)
            or any(others.values())):
        fail(line)
    check_outputs(eng, reqs, cfg.vocab_size)
    res = serve_metrics("11", stats, decode_ms, admit_ms, peak, len(reqs),
                        card)
    res["n_params"] = n_params

    # one admission round (the long prompt and three others) and three
    # decode rounds under torch.profiler
    zero_counts()
    profile_rounds(torch, "11", eng, [reqs[-1]] + reqs[1:6:2], res, card)
    torch.cuda.synchronize()
    by_path["hybrid-profile"] = read_counts()

    # the long prompt prefilled again, every ssm_scan launch held against
    # ssm_scan_plain on its own inputs
    errs = []

    def against_plain(args, out):
        errs.append(ssm_errors(out, ssm_cuda.ssm_scan_plain(*args)))

    zero_counts()
    with hold_launches(ssm_cuda, "ssm_scan", against_plain):
        first_token_logits(eng, reqs[-1])
    torch.cuda.synchronize()
    by_path["hybrid-check"] = read_counts()
    worst_y = max(e[0] for e in errs)
    worst_h = max(e[1] for e in errs)
    line = (f"[11] {len(errs)} ssm_scan launches of one {HYBRID_LONG_PROMPT}-"
            f"token prefill held against ssm_scan_plain on their own inputs: "
            f"worst y {worst_y:.2e} of max |y|, hT {worst_h:.2e} of max |hT| "
            f"(tol {SSM_RTOL}); launches {by_path['hybrid-check']} [{card}]")
    print(line, flush=True)
    if len(errs) != cfg.n_layers or max(worst_y, worst_h) > SSM_RTOL:
        fail(line)
    res["launch_y_rel_max"], res["launch_h_rel_max"] = worst_y, worst_h

    # every prompt's first-token logits against the chunked scan
    zero_counts()
    chunked = ServeEngine(base, params, max_batch=4,
                          cache_len=HYBRID_CACHE_LEN, device=dev)
    rows = []
    for r in reqs:
        a = first_token_logits(eng, r)
        c = first_token_logits(chunked, r)
        rows.append((r.rid, len(r.prompt), logit_rel(a, c),
                     int(a.argmax() == c.argmax()),
                     bool(torch.isfinite(a).all())))
    torch.cuda.synchronize()
    by_path["hybrid-compare"] = read_counts()
    worst = max(x[2] for x in rows)
    line = (f"[11] first-token logits, ssm_impl 'pallas' against 'chunked' "
            f"(the chunked scan at T % 64 == 0, the sequential scan "
            f"otherwise), max |diff| / max |logit|: worst {worst:.3e} (tol "
            f"{SERVE_LOGIT_RTOL}); argmax agrees on "
            f"{sum(x[3] for x in rows)}/{len(rows)}; per request (rid, "
            f"prompt, rel): {[(x[0], x[1], round(x[2], 6)) for x in rows]}; "
            f"launches {by_path['hybrid-compare']} [{card}]")
    print(line, flush=True)
    if worst > SERVE_LOGIT_RTOL or not all(x[4] for x in rows):
        fail(line)
    res["logits_rel_vs_chunked"] = worst
    del eng, chunked, params
    return res


def _bits(t):
    """t's bit patterns as an integer tensor of the same width."""
    import torch
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.int8}
    return t.view(width[t.element_size()])


def train_phase(torch, np, dev, spec, card, flash_cuda, zero_counts,
                read_counts, by_path):
    """Phase 10: Trainer(...).run() on qwen2-1.5b at full width, flash on."""
    import dataclasses
    import math
    import repro_torch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              use_flash_attention=True)
    n_layers = cfg.n_layers
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                           log_every=1, ckpt_dir=ckpt_dir)
    print(f"[10] train qwen2-1.5b (full width, {n_layers} layers, remat "
          f"{cfg.remat!r}, {cfg.optimizer}, flash on): seq_len "
          f"{loop.seq_len}, global_batch {loop.global_batch}, {TRAIN_STEPS} "
          f"steps; free disk under build/ {free_gb:.1f} GB", flush=True)
    tr = Trainer(cfg, loop, device=dev)
    step_ms, step_counts, save = [], [], {}
    real_step, real_write, real_save = tr.step_fn, tr.ckpt._write, tr.ckpt.save

    grad_norms = []

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        grad_norms.append(float(out[2]["grad_norm"]))
        return out

    def timed_save(step, tree, **kw):
        t0 = time.perf_counter()
        real_save(step, tree, **kw)
        save["snapshot_s"] = time.perf_counter() - t0

    def timed_write(step, flat):
        t0 = time.perf_counter()
        real_write(step, flat)
        save["write_s"] = time.perf_counter() - t0

    tr.step_fn, tr.ckpt.save, tr.ckpt._write = timed_step, timed_save, timed_write
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = tr.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    by_path["train"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    v = cfg.vocab_size
    lse0 = math.log(v) + INIT_SCALE ** 2 * cfg.d_model / 2
    loss0 = lse0 + 1e-4 * lse0 ** 2
    per_step = {"gpp_fused": 0, "gpp_banded": 0, "flash_fwd": 2 * n_layers,
                "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers,
                "ssm_scan": 0, "paged_decode_gather": 0,
                "paged_decode_int8": 0, "paged_decode_verify": 0}
    line = (f"[10] losses {[round(x, 4) for x in losses]} (step 0 expected "
            f"{loss0:.4f} +- {LOSS0_ATOL}); launches a step {step_counts} "
            f"(expected {per_step}); whole run {by_path['train']} [{card}]")
    print(line, flush=True)
    if (len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses)
            or abs(losses[0] - loss0) > LOSS0_ATOL
            or any(c != per_step for c in step_counts)
            or by_path["train"] != {k: n * TRAIN_STEPS
                                    for k, n in per_step.items()}):
        fail(line)
    tokens = loop.seq_len * loop.global_batch
    n_params = cfg.param_count()
    attn = 3 * n_layers * flash_cuda.useful_flops(
        loop.global_batch, cfg.n_heads, loop.seq_len, loop.seq_len,
        cfg.head_dim, True)
    steady = sorted(step_ms[1:])
    step_p50 = steady[len(steady) // 2]
    mfu = (6 * n_params * tokens + attn) / (step_p50 / 1e3) / spec.bf16_tc_flops
    step_dir = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    res = {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
           "step_ms_p50": step_p50,
           "tokens_per_step": tokens, "tok_per_s": tokens / step_p50 * 1e3,
           "mfu": mfu, "model_flops_per_step": 6 * n_params * tokens + attn,
           "n_params": n_params, "peak_mem_gb": peak / 1e9, "run_s": run_s,
           "ckpt_gb": ckpt_bytes / 1e9, **save, "free_disk_gb": free_gb}
    print(f"[10] step ms {[round(x, 2) for x in step_ms]} (p50 after the "
          f"first {step_p50:.2f}); {res['tok_per_s']:.1f} tokens/s; mfu "
          f"{mfu:.4f} ((6 N tokens + attention {attn:.3e}) / step / "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, N = {n_params}); peak "
          f"device memory {peak / 1e9:.2f} GB; checkpoint "
          f"{ckpt_bytes / 1e9:.2f} GB, snapshot {save.get('snapshot_s', 0):.2f} "
          f"s, write {save.get('write_s', 0):.2f} s [{card}]", flush=True)

    # the final checkpoint restored bit-equal to the state in memory
    t0 = time.perf_counter()
    step, restored = resume_or_init(tr.ckpt, lambda: None, device=dev)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    mine, back = tree_leaves(tr.state), tree_leaves(restored)
    same = (step == TRAIN_STEPS and len(mine) == len(back) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(_bits(a), _bits(b)) for a, b in zip(mine, back)))
    line = (f"[10] resume_or_init restored step {step} in "
            f"{res['restore_s']:.2f} s: {len(back)} leaves, bit-equal to the "
            f"{len(mine)} in memory: {same} [{card}]")
    print(line, flush=True)
    if not same:
        fail(line)
    del restored, back

    # one more step under torch.profiler
    src = TokenSource(DataConfig(seq_len=loop.seq_len,
                                 global_batch=loop.global_batch,
                                 vocab_size=v, seed=loop.seed))
    params, opt_state = tr.state["params"], tr.state["opt"]

    def batch_at(step):
        return {k: torch.from_numpy(a).to(dev)
                for k, a in src.batch_at(step).items()}

    zero_counts()
    batch = batch_at(TRAIN_STEPS)
    wall, busy, kernels, host, n_launch, ours, _ = profile_window(
        torch, lambda: real_step(params, opt_state, batch))
    by_path["train-profile"] = read_counts()
    res["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                      "cuda_launch_kernel": n_launch, "own_kernels": ours}
    print(f"[10] profile one step: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({busy / wall:.1%}); cudaLaunchKernel {n_launch}; "
          f"the port's kernels (device ms, calls): {ours}; "
          f"top kernels (ms, calls): {kernels}; top host ops (self ms, "
          f"calls): {host} [{card}]", flush=True)

    # one more step with every backward launch held against its plain
    # version on its own inputs
    errs = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    plain = {"flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}

    seen = []

    def against_plain(name):
        def check(args, got):
            seen.append(matmul_flags(torch))
            want = plain[name](*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    zero_counts()
    with hold_launches(flash_cuda, "flash_bwd_dq",
                       against_plain("flash_bwd_dq")), \
            hold_launches(flash_cuda, "flash_bwd_dkv",
                          against_plain("flash_bwd_dkv")):
        real_step(params, opt_state, batch_at(TRAIN_STEPS + 1))
        torch.cuda.synchronize()
    by_path["train-check"] = read_counts()
    check_flags_inside("10", seen, card)
    worst = {name: max(e) for name, e in errs.items()}
    line = (f"[10] one checked step: {len(errs['flash_bwd_dq'])} flash_bwd_dq "
            f"and {len(errs['flash_bwd_dkv'])} flash_bwd_dkv launches held "
            f"against their plain versions on their own inputs: worst "
            f"{worst} in bf16 ulps at the largest element (tol {BWD_ULPS}); "
            f"launches {by_path['train-check']} [{card}]")
    print(line, flush=True)
    if (len(errs["flash_bwd_dq"]) != n_layers
            or len(errs["flash_bwd_dkv"]) != n_layers
            or max(worst.values()) > BWD_ULPS):
        fail(line)
    res["bwd_launch_worst_ulps"] = worst
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr, params, opt_state
    return res


def drive(eng, reqs):
    """Submit every request at once and step the engine until it is idle.
    Returns (engine stats, sorted ms of the rounds without an admission,
    sorted ms of the rounds with one); each round ends on the host, after
    sampling."""
    eng.reset()
    for r in reqs:
        eng.submit(r, t_enqueue=eng._t_start)
    decode_ms, admit_ms = [], []
    while not eng.idle:
        t1 = time.perf_counter()
        rep = eng.step()
        dt = (time.perf_counter() - t1) * 1e3
        (admit_ms if rep.admitted else decode_ms).append(dt)
    return eng.finalize(), sorted(decode_ms), sorted(admit_ms)


def check_outputs(eng, reqs, vocab):
    """Every request got its max_new_tokens tokens, each in the vocabulary."""
    for r in reqs:
        toks = eng.outputs[r.rid]
        if len(toks) != r.max_new_tokens or not all(0 <= t < vocab
                                                    for t in toks):
            fail(f"request {r.rid}: {len(toks)} tokens, range "
                 f"[{min(toks)}, {max(toks)}]")


def serve_metrics(tag, stats, decode_ms, admit_ms, peak, n_reqs, card):
    """The serving metrics of one drive() run, printed and returned."""
    res = {"requests": stats["requests"], "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "new_tokens": stats["new_tokens"],
           "p50_ttft_ms": stats["p50_ttft_s"] * 1e3,
           "p99_ttft_ms": stats["p99_ttft_s"] * 1e3,
           "mean_ttft_ms": stats["mean_ttft_s"] * 1e3,
           "p50_tpot_ms": stats["p50_tpot_s"] * 1e3,
           "decode_step_ms_p50": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_max": decode_ms[-1],
           "admit_step_ms_p50": admit_ms[len(admit_ms) // 2],
           "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
           "occupancy": stats["occupancy"], "peak_mem_gb": peak / 1e9}
    print(f"[{tag}] serve metrics: TTFT p50 {res['p50_ttft_ms']:.1f} ms, p99 "
          f"{res['p99_ttft_ms']:.1f} ms (all {n_reqs} submitted at once, "
          f"4 slots); decode step p50 {res['decode_step_ms_p50']:.2f} ms "
          f"({len(decode_ms)} steps without admissions); admission round p50 "
          f"{res['admit_step_ms_p50']:.2f} ms; TPOT p50 "
          f"{res['p50_tpot_ms']:.2f} ms; {res['tok_per_s']:.1f} tokens/s over "
          f"{res['wall_s']:.2f} s; occupancy {res['occupancy']:.3f}; peak "
          f"device memory {res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    return res


def profile_rounds(torch, tag, eng, reqs, res, card):
    """One admission round and three decode rounds of `reqs` (at most 8 new
    tokens each) under torch.profiler; the device-busy share into res."""
    from repro_torch.serve.engine import Request
    eng.reset()
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8,
                           extra=r.extra))
    for kind, n_steps in (("admit", 1), ("decode", 3)):
        wall, busy, kernels, host, n_launch, ours, _ = profile_window(
            torch, lambda: [eng.step() for _ in range(n_steps)])
        res[f"profile_{kind}"] = {"steps": n_steps, "wall_ms": wall,
                                  "device_busy_ms": busy, "own_kernels": ours,
                                  "cuda_launch_kernel": n_launch}
        print(f"[{tag}] profile {kind} ({n_steps} step(s)): wall {wall:.2f} "
              f"ms, device busy {busy:.2f} ms ({busy / wall:.1%}); "
              f"cudaLaunchKernel {n_launch}; the port's "
              f"kernels (device ms, calls): {ours}; top kernels (ms, calls): "
              f"{kernels}; top host ops (self ms, calls): {host} [{card}]",
              flush=True)


def serve_checked(torch, dev, card, tag, name, eng, reqs, zero_counts,
                  read_counts, by_path, describe, profile_reqs, want=None,
                  paged=None, watch=contextlib.nullcontext):
    """The serving run that 14a, 15a, 16a and 16b share, on a warmed-up
    `eng`: every request of `reqs` submitted at once and served to the end
    (under `watch()`), the counts zeroed just before and read just after
    into by_path[name + "_serve"] and held to `want` (kernel -> launches,
    every other kernel 0), one prefill a request and every output in the
    vocabulary; the same requests again, every output bit-equal; one
    admission round of `profile_reqs` and three decode rounds under the
    profiler; and where `paged` (an engine over the same params with a
    paged cache) is given, the same requests through it: equal outputs,
    the same launches (by_path[name + "_paged"]), every page returned.
    describe(stats) gives the first line's text. Returns (metrics, the
    first run's outputs by rid)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with watch():
        stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    counts = by_path[f"{name}_serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    full = {k: 0 for k in counts}
    full.update(want or {})
    line = (f"[{tag}] {describe(stats)}; launches {counts} (expected "
            f"{full}) [{card}]")
    print(line, flush=True)
    if counts != full or stats["prefills"] != len(reqs):
        fail(line)
    check_outputs(eng, reqs, eng.cfg.vocab_size)
    first = {r.rid: list(eng.outputs[r.rid]) for r in reqs}
    res = serve_metrics(tag, stats, decode_ms, admit_ms, peak, len(reqs),
                        card)

    # determinism: the same requests again, every output bit-equal
    drive(eng, reqs)
    differ = [r.rid for r in reqs if eng.outputs[r.rid] != first[r.rid]]
    line = (f"[{tag}] the same {len(reqs)} requests again: outputs bit-equal "
            f"to the first run's except rids {differ} (none allowed) [{card}]")
    print(line, flush=True)
    if differ:
        fail(line)

    # where a round's time goes: one admission round and three decode
    # rounds under torch.profiler
    zero_counts()
    profile_rounds(torch, tag, eng, profile_reqs, res, card)
    torch.cuda.synchronize()
    res["launches_per_decode_round"] = \
        res["profile_decode"]["cuda_launch_kernel"] / 3
    if paged is None:
        return res, first

    torch.cuda.synchronize()
    zero_counts()
    pstats, pdecode, _ = drive(paged, reqs)
    torch.cuda.synchronize()
    counts = by_path[f"{name}_paged"] = read_counts()
    kv = pstats["kvcache"]
    paged.kv.check_conservation()
    differ = [r.rid for r in reqs if paged.outputs[r.rid] != first[r.rid]]
    line = (f"[{tag}] paged (kv_page_size {paged.kv_page_size}, leaves "
            f"{list(paged.kv.leaves)}): outputs equal to the unpaged run's "
            f"except rids {differ} (none allowed); launches {counts} "
            f"(expected {full}); peak live pages {kv['peak_live_pages']} of "
            f"{paged.kv.n_pages}, pages live after {paged.kv.pages_live}; "
            f"decode round p50 {pdecode[len(pdecode) // 2]:.2f} ms [{card}]")
    print(line, flush=True)
    if differ or counts != full or paged.kv.pages_live:
        fail(line)
    res["paged"] = {"decode_step_ms_p50": pdecode[len(pdecode) // 2],
                    "peak_pages_live": kv["peak_live_pages"],
                    "tok_per_s": pstats["tok_per_s"]}
    return res, first


def first_token_logits(eng, r):
    """Logits of request r's first generated token through `eng`'s own
    admission path on a fresh cache (see cold_prefill)."""
    return cold_prefill(eng, r)[0]


def prefill_rows(eng, r):
    """The rows r's admission prefills: its vis lines and its tokens'
    bucket, as the engine builds them."""
    vis = eng.prompt_lines(r) - len(r.prompt)
    return vis + eng.prefill_batch(r)["tokens"].shape[1]


def serve_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
                by_path):
    """Phase 8: ServeEngine on qwen2-1.5b at full width, flash on."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    base = repro_torch.get_config("qwen2-1.5b")
    cfg = dataclasses.replace(base, use_flash_attention=True)
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    hot = rng.integers(0, cfg.vocab_size, 200)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    reqs.append(Request(rid=len(prompts), prompt=hot, max_new_tokens=32,
                        temperature=0.8))
    # warm-up: one short request (cuBLAS handles, the flash tune pick), with
    # the matmul flags read inside the engine's work, at each flash call
    seen = []

    def read_flags(run, q, k, v, **kw):
        seen.append(matmul_flags(torch))
        return run(q, k, v, **kw)

    with route_flash(read_flags):
        eng.run([Request(rid=99, prompt=prompts[0], max_new_tokens=2)])
    torch.cuda.synchronize()
    check_flags_inside("8", seen, card)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    by_path["serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_pre = stats["prefills"]
    got = by_path["serve"]["flash_fwd"]
    line = (f"[8] serve qwen2-1.5b (full width, {cfg.n_layers} layers, "
            f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s), flash on: "
            f"{stats['requests']} requests, {n_pre} prefills, "
            f"{stats['decode_steps']} decode steps, {stats['new_tokens']} "
            f"tokens; launches {by_path['serve']} (flash_fwd expected "
            f"{cfg.n_layers} x {n_pre} = {cfg.n_layers * n_pre}) [{card}]")
    print(line, flush=True)
    if got != cfg.n_layers * n_pre or n_pre != len(reqs):
        fail(line)
    if by_path["serve"]["gpp_fused"] or by_path["serve"]["gpp_banded"]:
        fail(line)
    check_outputs(eng, reqs, cfg.vocab_size)
    res = serve_metrics("8", stats, decode_ms, admit_ms, peak, len(reqs),
                        card)

    # where a step's time goes: one admission round (4 prefills at the
    # 256 and 512 buckets, then a decode) and three decode-only rounds,
    # each under torch.profiler
    zero_counts()
    profile_rounds(torch, "8", eng, reqs[1:8:2], res, card)
    torch.cuda.synchronize()
    by_path["profile"] = read_counts()

    # each prompt prefilled again through the flash engine (a), holding
    # every flash_fwd launch against flash_fwd_plain on the same inputs;
    # then through the same model with flash_fwd_plain in the kernel's
    # place (b) and through the chunked plain path (c)
    zero_counts()
    plain = ServeEngine(base, params, max_batch=4, cache_len=1024, device=dev)
    rows, launch_ulps = [], []

    def checked(run, q, k, v, **kw):
        out = run(q, k, v, **kw)
        want, _ = flash_cuda.flash_fwd_plain(q, k, v, flash_blocks(q, k, v, kw),
                                             kw["causal"])
        launch_ulps.append(bf16_ulps(out, want))
        return out

    for r in reqs:
        with route_flash(checked):
            a = first_token_logits(eng, r)
        with route_flash(plain_in_place(flash_cuda)):
            b = first_token_logits(eng, r)
        c = first_token_logits(plain, r)
        rows.append((r.rid, len(r.prompt), logit_rel(a, b), logit_rel(a, c),
                     logit_rel(b, c), int(a.argmax() == b.argmax()),
                     int(a.argmax() == c.argmax()),
                     bool(torch.isfinite(a).all())))
    torch.cuda.synchronize()
    by_path["serve-check"] = read_counts()
    worst = {i: max(x[i] for x in rows) for i in (2, 3, 4)}
    line = (f"[8] {len(launch_ulps)} flash_fwd launches in {len(reqs)} "
            f"prefills held against flash_fwd_plain on their own inputs: "
            f"worst {max(launch_ulps):.2f} bf16 ulps (tol {FLASH_OUT_ULPS}); "
            f"first-token logits, max |diff| / max |logit|, worst: kernel path "
            f"vs plain version in its place {worst[2]:.3e}, kernel path vs "
            f"chunked {worst[3]:.3e} (tol {SERVE_LOGIT_RTOL} each), plain "
            f"version vs chunked {worst[4]:.3e}; argmax agrees on "
            f"{sum(x[5] for x in rows)}/{len(rows)} and "
            f"{sum(x[6] for x in rows)}/{len(rows)}; per request (rid, prompt, "
            f"a-b, a-c, b-c): "
            f"{[(x[0], x[1]) + tuple(round(e, 5) for e in x[2:5]) for x in rows]}"
            f"; launches {by_path['serve-check']} [{card}]")
    print(line, flush=True)
    if (len(launch_ulps) != cfg.n_layers * len(reqs)
            or max(launch_ulps) > FLASH_OUT_ULPS
            or max(worst[2], worst[3]) > SERVE_LOGIT_RTOL
            or not all(x[7] for x in rows)):
        fail(line)
    res["launch_ulps_max"] = max(launch_ulps)
    res["logits_rel_vs_plain"] = worst[2]
    res["logits_rel_vs_chunked"] = worst[3]
    return res


@contextlib.contextmanager
def hold_launches(module, name, check):
    """While open, module.<name> (a kernel wrapper) is a stand-in that calls
    the real wrapper, then check(args, result), and returns the result.
    The stand-in forwards `launches` to the real wrapper, which counts
    through its module-level name."""
    real = getattr(module, name)

    class Held:
        @property
        def launches(self):
            return real.launches

        @launches.setter
        def launches(self, n):
            real.launches = n

        def __call__(self, *args):
            out = real(*args)
            check(args, out)
            return out

    setattr(module, name, Held())
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def route_flash(fn):
    """While open, the flash descriptor's run(q, k, v, **kw) calls
    fn(run, q, k, v, **kw) with the real run."""
    from repro_torch.kernels import api
    fk = api.get_kernel("flash")
    run = fk.run
    fk.run = lambda q, k, v, **kw: fn(run, q, k, v, **kw)
    try:
        yield
    finally:
        del fk.run


def flash_blocks(q, k, v, kw):
    """The blocks the descriptor's run launches for these arguments."""
    from repro_torch.kernels import api
    from repro_torch.kernels.flash.flash_cuda import FlashBlockConfig
    key = api.get_kernel("flash").problem_key(q, k, v, causal=kw["causal"])
    return (kw["config"] or FlashBlockConfig()).clamped(key)


def logit_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def profile_window(torch, fn, host=True):
    """Run fn() under torch.profiler (tracing the device alone when host is
    false: a training step issues ~10^5 kernels, and host events would
    multiply the trace). Returns (wall ms, device-busy ms: the sum of the
    kernels' times, the 8 kernels with the most device time as (name, ms,
    calls), the 8 host ops with the most self CPU time as (name, ms,
    calls), the count of cudaLaunchKernel calls (empty and 0 without host),
    the port's own kernels (csrc/) as {name: (ms, calls)}, and the count
    of kernels run)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, host_ops = [], []
    launches = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels.append((e.key[:60], e.self_device_time_total / 1e3,
                            e.count))
        elif host:
            host_ops.append((e.key[:40], e.self_cpu_time_total / 1e3,
                             e.count))
            if e.key == "cudaLaunchKernel":
                launches = e.count
    busy = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    top_host = sorted(host_ops, key=lambda k: -k[1])[:8]
    ours = {}
    for n, ms, c in kernels:
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "dkv_group_sum", "ssm_scan", "paged_decode", "gpp"):
            if f"{name}_kernel" in n or (name == "gpp" and name in n):
                old = ours.get(name, (0.0, 0))
                ours[name] = (round(old[0] + ms, 3), old[1] + c)
    return (wall, busy, [(n, round(ms, 3), c) for n, ms, c in top],
            [(n, round(ms, 3), c) for n, ms, c in top_host], launches, ours,
            sum(k[2] for k in kernels))


# ---------------------------------------------------------------------------
# phase 12: the paged K/V cache (12a) and the paged decode kernels (12b)
# ---------------------------------------------------------------------------

def cold_prefill(eng, r):
    """Request r's whole prompt prefilled cold through `eng`'s admission
    path (eng.prefill_batch: the bucket, the extra inputs; then
    prefill_into_slot) on a fresh cache: (first-token logits, the cache)."""
    logits, cache = eng.model.prefill_into_slot(
        eng.params, eng._fresh_cache(), 0, eng.prefill_batch(r),
        eng.prompt_lines(r))
    return logits[0, 0].float(), cache


def watch_admissions(torch, eng, flash_cuda, keep_rows):
    """Wrap eng._admit and eng._sample_rows (instance attributes): per rid,
    the prefix tokens a hit restored, the flash_fwd launches of its
    admission, the admission's host ms, its first-token logits, and (with
    keep_rows) a copy of the restored K/V lines taken right after the
    admission (later admissions reuse the slot)."""
    seen = {}
    real_admit, real_sample = eng._admit, eng._sample_rows

    def admit(cache, slot_idx, r, t_enqueue):
        saved0 = eng.kv.prefill_tokens_saved
        f0 = flash_cuda.flash_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_admit(cache, slot_idx, r, t_enqueue)
        torch.cuda.synchronize()
        rec = seen.setdefault(r.rid, {})
        rec["hit_tokens"] = eng.kv.prefill_tokens_saved - saved0
        rec["flash"] = flash_cuda.flash_fwd.launches - f0
        rec["admit_ms"] = (time.perf_counter() - t0) * 1e3
        if keep_rows and rec["hit_tokens"]:
            n = rec["hit_tokens"]
            rec["rows"] = {k: out[0][k][:, slot_idx, :n].clone()
                           for k in ("k", "v")}
        return out

    def sample(logits, slots):
        if len(slots) == 1:          # an admission's first token
            seen.setdefault(slots[0].rid, {})["logits"] = \
                logits.reshape(-1).float().clone()
        return real_sample(logits, slots)

    eng._admit, eng._sample_rows = admit, sample
    return seen


def paged_serve_phase(torch, np, dev, card, flash_cuda, zero_counts,
                      read_counts, by_path):
    """Phase 12a: ServeEngine(kv_page_size=16) on qwen2-1.5b at full width,
    flash on, 8 requests behind one 256-token system prompt."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              use_flash_attention=True)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, PAGED_SYSTEM_PROMPT)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
               for n in PAGED_SUFFIXES]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]

    def engine(**kw):
        return ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                           device=dev, **kw)

    eng = engine(kv_page_size=PAGED_PAGE)
    # warm-up: one short request (cuBLAS handles, the flash pick)
    eng.run([Request(rid=99, prompt=prompts[0][:300], max_new_tokens=2)])
    torch.cuda.synchronize()
    seen = watch_admissions(torch, eng, flash_cuda, keep_rows=True)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    by_path["paged-serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    kv = stats["kvcache"]
    eng.kv.check_conservation()
    hits = [r.rid for r in reqs if seen[r.rid]["hit_tokens"]]
    misses = [r.rid for r in reqs if not seen[r.rid]["hit_tokens"]]
    flash_by = {rid: seen[rid]["flash"] for rid in seen}
    line = (f"[12a] serve qwen2-1.5b (full width, {cfg.n_layers} layers), "
            f"flash on, kv_page_size {PAGED_PAGE}: {len(reqs)} requests "
            f"(a {PAGED_SYSTEM_PROMPT}-token system prompt + suffixes "
            f"{list(PAGED_SUFFIXES)}), misses {misses}, hits {hits} "
            f"(restored tokens {[seen[r]['hit_tokens'] for r in hits]}); "
            f"flash_fwd launches per admission {flash_by} (cold "
            f"{cfg.n_layers}, suffix 0); kvcache: hit rate "
            f"{kv['prefix_hit_rate']:.3f}, prefill tokens saved "
            f"{kv['prefill_tokens_saved']}, peak live pages "
            f"{kv['peak_live_pages']} of {kv['n_pages']}, pages live at the "
            f"end {kv['pages_live']} = index pages {kv['index_pages']}, KV "
            f"bytes a slot {kv['kv_bytes_per_slot']:.0f} against "
            f"{kv['static_bytes_per_slot']} static "
            f"({kv['bytes_per_slot_reduction']:.1%} less); launches "
            f"{by_path['paged-serve']} [{card}]")
    print(line, flush=True)
    if (misses != [0] or kv["pages_live"] != kv["index_pages"]
            or any(flash_by[r] != cfg.n_layers for r in misses)
            or any(flash_by[r] != 0 for r in hits)
            or any(v for k, v in by_path["paged-serve"].items()
                   if k.startswith("paged_decode"))):
        fail(line)
    check_outputs(eng, reqs, cfg.vocab_size)
    res = serve_metrics("12a", stats, decode_ms, admit_ms, peak, len(reqs),
                        card)
    res["kvcache"] = kv
    ttft = {rid: eng.request_stats[rid].ttft_s * 1e3 for rid in seen
            if rid != 99}
    res["ttft_ms_p50_hit"] = float(np.median([ttft[r] for r in hits]))
    res["ttft_ms_p50_miss"] = float(np.median([ttft[r] for r in misses]))
    res["admit_ms_p50_hit"] = float(np.median([seen[r]["admit_ms"]
                                               for r in hits]))
    res["admit_ms_miss"] = float(np.median([seen[r]["admit_ms"]
                                            for r in misses]))
    print(f"[12a] TTFT p50 hit {res['ttft_ms_p50_hit']:.1f} ms, miss "
          f"{res['ttft_ms_p50_miss']:.1f} ms (every request submitted at "
          f"once: a TTFT holds the admissions before it); the admission "
          f"alone (restore + suffix prefill + publish, to the first token) "
          f"p50 {res['admit_ms_p50_hit']:.1f} ms on a hit, "
          f"{res['admit_ms_miss']:.1f} ms cold [{card}]", flush=True)

    # every hit: restored lines bit-equal to a cold prefill's of the same
    # prompt, first-token logits against the cold prefill's
    zero_counts()
    rows = []
    for rid in hits:
        cold_logits, cold = cold_prefill(eng, reqs[rid])
        n = seen[rid]["hit_tokens"]
        same = all(torch.equal(_bits(seen[rid]["rows"][k]),
                               _bits(cold[k][:, 0, :n])) for k in ("k", "v"))
        lg = seen[rid]["logits"]
        rows.append((rid, n, same, logit_rel(lg, cold_logits),
                     int(lg.argmax() == cold_logits.argmax()),
                     bool(torch.isfinite(lg).all())))
        del cold
    torch.cuda.synchronize()
    by_path["paged-serve-check"] = read_counts()
    worst = max(x[3] for x in rows)
    line = (f"[12a] hits against a cold full-prompt prefill (flash on, the "
            f"same bucket): restored K/V lines bit-equal "
            f"{sum(x[2] for x in rows)}/{len(rows)}; first-token logits max "
            f"|diff| / max |logit| worst {worst:.3e} (tol "
            f"{SERVE_LOGIT_RTOL}; the suffix runs chunked attention and "
            f"GEMMs of another M), argmax agrees {sum(x[4] for x in rows)}/"
            f"{len(rows)}; per hit (rid, restored, bit-equal, rel): "
            f"{[(x[0], x[1], x[2], round(x[3], 5)) for x in rows]} [{card}]")
    print(line, flush=True)
    if not all(x[2] and x[5] for x in rows) or worst > SERVE_LOGIT_RTOL:
        fail(line)
    res["restored_rows_bit_equal"] = len(rows)
    res["hit_logits_rel_vs_cold"] = worst

    # the unpaged engine and prefix_reuse=False on the first 4 requests
    # (the same path: bit-equal tokens), the reuse run's agreement with it,
    # then the int8 pool
    few = reqs[:4]
    zero_counts()
    base = engine().run(few)
    off_eng = engine(kv_page_size=PAGED_PAGE, prefix_reuse=False)
    off = off_eng.run(few)
    off_eng.kv.check_conservation()
    agree = sum(int(a == b) for r in few
                for a, b in zip(eng.outputs[r.rid], base[r.rid]))
    total = sum(len(base[r.rid]) for r in few)
    i8 = engine(kv_page_size=PAGED_PAGE, kv_dtype="int8")
    seen8 = watch_admissions(torch, i8, flash_cuda, keep_rows=False)
    out8 = i8.run(few)
    torch.cuda.synchronize()
    by_path["paged-serve-compare"] = read_counts()
    i8.kv.check_conservation()
    st8 = i8.last_stats["kvcache"]
    d8 = max(logit_rel(seen8[r.rid]["logits"], seen[r.rid]["logits"])
             for r in few)
    agree8 = sum(int(a == b) for r in few
                 for a, b in zip(out8[r.rid], eng.outputs[r.rid]))
    line = (f"[12a] first 4 requests: prefix_reuse=False tokens bit-equal to "
            f"the unpaged engine's: {off == base}; the prefix-reuse run's "
            f"greedy tokens agree with the unpaged engine's on {agree}/"
            f"{total}; kv_dtype int8: hits {st8['prefix_hits']}, pages live "
            f"{st8['pages_live']} = index {st8['index_pages']}, KV bytes a "
            f"slot {st8['kv_bytes_per_slot']:.0f} against "
            f"{st8['static_bytes_per_slot']}, first-token logits finite "
            f"{all(bool(torch.isfinite(seen8[r.rid]['logits']).all()) for r in few)}, "
            f"max |diff| / max |logit| from bf16 {d8:.3e}, tokens agreeing "
            f"with bf16 {agree8}/{total} [{card}]")
    print(line, flush=True)
    if (off != base or st8["kv_dtype"] != "int8"
            or st8["pages_live"] != st8["index_pages"]
            or not all(bool(torch.isfinite(seen8[r.rid]["logits"]).all())
                       for r in few)):
        fail(line)
    res.update(reuse_off_bit_equal=True, tokens_agree_vs_unpaged=agree,
               tokens_compared=total, int8_logits_rel_vs_bf16=d8,
               int8_tokens_agree=agree8, int8_kvcache=st8)
    del eng, off_eng, i8, params
    return res


def paged_inputs(torch, dev, b, qlen, h, kvh, hd, page, npt, clens, seed,
                 int8=False):
    """q, pools (a permuted table into a pool of b*npt + 40 pages), table,
    cache_len, kscale, vscale on the card, from a seed."""
    from repro_torch.kernels.paged import paged
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    n_pages = b * npt + 40
    q = rnd(b, h, hd) if qlen == 1 else rnd(b, qlen, h, hd)
    kp, vp = rnd(n_pages, page, kvh, hd), rnd(n_pages, page, kvh, hd)
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * npt]
    table = table.reshape(b, npt).to(torch.int32).contiguous()
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        kp, ks = paged.quantize_pool(kp)
        vp, vs = paged.quantize_pool(vp)
    return q, kp, vp, table, clen, ks, vs


def sdpa_on_gathered(torch, q, kp, vp, table, clen, ks, vs):
    """The yardsticks: scaled_dot_product_attention on the already-gathered
    dense K/V (the gather, and an int8 pool's dequantization, done before
    and not timed), and one callable that gathers (paged.gather_pages,
    dequantizing an int8 pool) and then runs the same SDPA: the same
    function as the kernel. Returns the two calls to time."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged import paged
    q4 = q[:, None] if q.dim() == 3 else q
    qn = q4.shape[1]
    qt = q4.transpose(1, 2).contiguous()
    q_pos = clen[:, None] - qn + torch.arange(qn, device=q.device)[None]

    def gathered():
        k = paged.gather_pages(kp, table)
        v = paged.gather_pages(vp, table)
        if ks is not None:
            lines = kp.shape[1]
            k = (k.float() * ks[table.long()].repeat_interleave(lines, 1)[
                ..., None, None]).to(torch.bfloat16)
            v = (v.float() * vs[table.long()].repeat_interleave(lines, 1)[
                ..., None, None]).to(torch.bfloat16)
        pos = torch.arange(k.shape[1], device=q.device)
        mask = (pos[None, None] <= q_pos[..., None])[:, None]    # (B,1,Q,L)
        return k.transpose(1, 2), v.transpose(1, 2), mask

    kt, vt, mask = (x.contiguous() for x in gathered())

    def with_gather():
        k, v, m = gathered()
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=m,
                                              enable_gqa=True)

    return (lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)), with_gather


def paged_calls(entry, plain, version, args, ppb, splits):
    """(kernel call, plain call) of `version` on args at ppb and splits."""
    q, kp, vp, tbl, cl, ks, vs = args
    if version == "int8":
        return (lambda: entry[version](q, kp, vp, tbl, cl, ks, vs, ppb,
                                       splits=splits),
                lambda: plain[version](q, kp, vp, tbl, cl, ks, vs,
                                       pages_per_block=ppb, splits=splits))
    if version == "verify":
        return (lambda: entry[version](q, kp, vp, tbl, cl, ppb, ks, vs,
                                       splits=splits),
                lambda: plain[version](q, kp, vp, tbl, cl,
                                       pages_per_block=ppb, kscale=ks,
                                       vscale=vs, splits=splits))
    return (lambda: entry[version](q, kp, vp, tbl, cl, ppb, splits=splits),
            lambda: plain[version](q, kp, vp, tbl, cl, pages_per_block=ppb,
                                   splits=splits))


def paged_bound(spec, q, kv_itemsize, kvh, hd, clens, ctx, int8_pages):
    """(bound ms, 'bytes' or 'operations'): the K/V lines this run's
    cache_len needs, each read once (a row's valid lines; all ctx lines
    of a row in which a query sees nothing, whose output is their mean), q
    and out in bf16, page scales; against the operations of a (row,
    query, head, line) pair by their type: q.k, 2 Hd on bf16 operands
    (an int8 line is exact in bf16) at the bf16 tensor-core peak, and p v,
    2 Hd with the f32 p of the contract at the FP32 peak."""
    b, h = q.shape[0], q.shape[-2]
    qn = q.shape[1] if q.dim() == 4 else 1
    lines = sum(c if c >= qn else ctx for c in clens)
    bytes_ = (2 * lines * kvh * hd * kv_itemsize + 8 * int8_pages
              + 2 * b * qn * h * hd * 2)
    pairs = 2.0 * qn * h * lines * hd
    bytes_ms = bytes_ / spec.hbm_bw * 1e3
    ops_ms = (pairs / spec.bf16_tc_flops + pairs / spec.fp32_flops) * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def paged_checks(torch, np, dev, spec, card, zero_counts, read_counts,
                 by_path):
    """Phase 12b: the three paged decode entry points at op level: the
    registry's path, then every case against the split-aware plain
    versions, every ppb and split count."""
    from repro_torch import dispatch
    from repro_torch.core import gpu_model
    from repro_torch.kernels.api import get_kernel
    from repro_torch.kernels.paged import paged, paged_cuda
    from repro_torch.kernels.paged.kernel_def import PPB_MENU, PagedBlockConfig
    from repro_torch.tune import tuner
    h, kvh, hd, page = 12, 2, 128, PAGED_PAGE
    entry = {"gather": paged_cuda.paged_decode_gather,
             "int8": paged_cuda.paged_decode_int8,
             "verify": paged_cuda.paged_decode_verify}
    plain = {"gather": paged.paged_decode_gather,
             "int8": paged.paged_decode_int8,
             "verify": paged.paged_decode_verify}

    # the path: dispatch("paged_decode", version=v) at qwen2's decode shape
    # (config None: the tuner times the menu on the card)
    dec = paged_inputs(torch, dev, 4, 1, h, kvh, hd, page, 64,
                       (1024,) * 4, seed=20)
    ver = paged_inputs(torch, dev, 4, 4, h, kvh, hd, page, 64,
                       (1024, 1000, 777, 517), seed=21)
    zero_counts()
    outs = {v: dispatch("paged_decode", *(ver if v == "verify" else dec)[:5],
                        version=v, device=dev)
            for v in ("gather", "int8", "verify")}
    torch.cuda.synchronize()
    by_path["paged"] = read_counts()
    kernel = get_kernel("paged_decode")
    picks = {}
    for v in outs:
        args = (ver if v == "verify" else dec)[:5]
        tc = tuner.tune_kernel("paged_decode", kernel.problem_key(*args),
                               version=v, device=dev)       # the memoized pick
        picks[v] = (tc.config.pages_per_block,
                    {c.pages_per_block: round(t * 1e3, 4)
                     for c, t, _ in tc.timings})
        splits = paged_cuda.splits_for(*args[:2], args[3])
        want = (paged.paged_decode_verify(*args, pages_per_block=picks[v][0],
                                          splits=splits)
                if v == "verify" else paged.paged_decode_gather(
                    *args, pages_per_block=picks[v][0], splits=splits))
        if v != "int8" and bf16_ulps(outs[v], want) > PAGED_OUT_ULPS:
            fail(f"[12b] dispatch {v}: {bf16_ulps(outs[v], want):.2f} bf16 "
                 f"ulps from the plain version")
    line = (f"[12b] dispatch('paged_decode') at qwen2-1.5b's decode shape "
            f"(B=4, H=12, KvH=2, Hd=128, page 16, 64 pages a row; verify "
            f"Q=4): launches {by_path['paged']}; the tuner's pick per "
            f"version (ppb, {{ppb: timed ms}}): {picks} [{card}]")
    print(line, flush=True)
    for name in ("paged_decode_gather", "paged_decode_int8",
                 "paged_decode_verify"):
        if by_path["paged"][name] <= 0:
            fail(f"{name} was not launched on the paged path: {line}")
    for v, out in outs.items():
        if not torch.isfinite(out.float()).all():
            fail(f"dispatch('paged_decode', version={v!r}) non-finite")

    # each case against the plain version at the wrapper's split count
    # (every ppb of the menu on the decode shapes), then every split count
    # at the best ppb; bit-equal reruns, times, the bound, the yardsticks
    cases = (("decode", "gather", 4, 1, 64, (1024,) * 4, False),
             ("decode-ragged", "gather", 4, 1, 64, (1024, 1000, 777, 517),
              False),
             ("int8", "int8", 4, 1, 64, (1024, 1000, 777, 517), True),
             ("verify-bf16", "verify", 4, 4, 64, (1024, 1000, 777, 517),
              False),
             ("verify-int8", "verify", 4, 4, 64, (1024, 1000, 777, 517),
              True),
             ("empty-rows", "verify", 4, 4, 64, (0, 2, 1024, 17), False),
             ("long", "gather", 8, 1, 512, (8192,) * 8, False),
             ("long-int8", "int8", 8, 1, 512, (8192,) * 8, True))
    zero_counts()
    rows = {}
    for i, (tag, version, b, qn, npt, clens, int8) in enumerate(cases):
        args = paged_inputs(torch, dev, b, qn, h, kvh, hd, page, npt, clens,
                            30 + i, int8)
        q, kp, vp, tbl, cl, ks, vs = args
        key = kernel.problem_key(q, kp, vp, tbl, cl)
        rule = paged_cuda.splits_for(q, kp, tbl)
        groups = paged_cuda.row_tiles(h // kvh * qn)[1]
        kvb = 1 if int8 else 2

        def measure(ppb, splits):
            call, ref = paged_calls(entry, plain, version, args, ppb, splits)
            got, again, want = call(), call(), ref()
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, want)
            same = torch.equal(_bits(got), _bits(again))
            if ulps > PAGED_OUT_ULPS or not same \
                    or not torch.isfinite(got.float()).all():
                fail(f"[12b] {tag} ppb {ppb} splits {splits}: {ulps:.2f} bf16 "
                     f"ulps from the plain version (tol {PAGED_OUT_ULPS}), "
                     f"rerun bit-equal {same} [{card}]")
            return {"ulps": ulps, "bit_equal": same,
                    "max_abs_err": float((got.float() - want.float()).abs()
                                         .max()),
                    "device_ms": graph_ms(call),
                    "modeled_ms": gpu_model.paged_step_s(
                        key, PagedBlockConfig("t", ppb).clamped(key), kvb,
                        spec, splits) * 1e3}

        menu = PPB_MENU if not tag.startswith("long") else (4, 8, 16)
        per_ppb = {}
        for ppb in menu:
            per_ppb[ppb] = measure(ppb, rule)
            per_ppb[ppb]["stages"] = paged_cuda.plan(
                h // kvh * qn, hd, page, npt, ppb, rule, kvb)["stages"]
            per_ppb[ppb]["ctas_an_sm"] = paged_cuda.occupancy(
                int8, h // kvh * qn, hd, page, npt, ppb, rule)
        best = min(per_ppb, key=lambda p: per_ppb[p]["device_ms"])
        per_split = {}
        for sp in (1, 2, 4, 8, 16, 32, 64):
            if sp <= npt:
                per_split[sp] = (per_ppb[best] if sp == rule
                                 else measure(best, sp))
        best_split = min(per_split, key=lambda s: per_split[s]["device_ms"])
        rule_loss = (per_split[rule]["device_ms"]
                     / per_split[best_split]["device_ms"] - 1)
        call, ref = paged_calls(entry, plain, version, args, best, rule)
        call_ms = cuda_ms(call)
        plain_ms = cuda_ms(ref, reps=5, warmup=1)
        sdpa, gather_sdpa = sdpa_on_gathered(torch, q, kp, vp, tbl, cl, ks,
                                             vs)
        lib_ms, lib_dev_ms = cuda_ms(sdpa), graph_ms(sdpa)
        lib_g_ms, lib_g_dev_ms = cuda_ms(gather_sdpa), graph_ms(gather_sdpa)
        bound_ms, bound_by = paged_bound(spec, q, kvb, kvh, hd, clens,
                                         npt * page, b * npt if int8 else 0)
        ref_err = None
        if version == "gather":
            ref_err = float((call().float()
                             - paged.paged_decode_ref(q, kp, vp, tbl, cl)
                             .float()).abs().max())
            if ref_err > PAGED_REF_ATOL:
                fail(f"[12b] {tag}: gather against ref {ref_err:.3e} "
                     f"(tol {PAGED_REF_ATOL})")
        rnd5 = (lambda x: {k: (round(v, 5) if isinstance(v, float) else v)
                           for k, v in x.items()})
        rows[tag] = {"shape": {"b": b, "q": qn, "h": h, "kvh": kvh, "hd": hd,
                               "page": page, "npt": npt,
                               "cache_len": list(clens), "int8": int8},
                     "ppb": best, "splits": rule,
                     "grid": [rule, kvh, b * groups], "ms": call_ms,
                     "device_ms": per_ppb[best]["device_ms"],
                     "modeled_ms": per_ppb[best]["modeled_ms"],
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms,
                     "library_gather_ms": lib_g_ms,
                     "library_gather_device_ms": lib_g_dev_ms,
                     "max_abs_err": per_ppb[best]["max_abs_err"],
                     "worst_ulps": max(x["ulps"] for x in list(
                         per_ppb.values()) + list(per_split.values())),
                     "vs_ref": ref_err, "best_splits": best_split,
                     "rule_loss": rule_loss,
                     "by_ppb": {p: rnd5(x) for p, x in per_ppb.items()},
                     "by_splits": {s: rnd5(x) for s, x in per_split.items()}}
        print(f"[12b] {tag} ({version}, B={b}, Q={qn}, {npt} pages a row, "
              f"cache_len {list(clens)}{', int8 pool' if int8 else ''}): "
              f"grid {tuple(rows[tag]['grid'])} (splits {rule}, KvH, B x "
              f"{groups} row groups); every ppb and split count within "
              f"{rows[tag]['worst_ulps']:.2f} bf16 ulps of the plain version "
              f"(tol {PAGED_OUT_ULPS}), reruns bit-equal"
              f"{'' if ref_err is None else f', vs ref {ref_err:.2e}'}; "
              f"best ppb {best}: call {call_ms:.4f} ms, device "
              f"{rows[tag]['device_ms']:.4f} ms (modeled "
              f"{rows[tag]['modeled_ms']:.4f}), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); SDPA on the gathered "
              f"K/V (gather not counted) {lib_ms:.4f} ms, device "
              f"{lib_dev_ms:.4f} ms; gather + SDPA {lib_g_ms:.4f} ms, device "
              f"{lib_g_dev_ms:.4f} ms; by ppb (device ms, modeled "
              f"ms, stages, CTAs an SM): "
              f"{ {p: (round(x['device_ms'], 4), round(x['modeled_ms'], 4), x['stages'], x['ctas_an_sm']) for p, x in per_ppb.items()} }; "
              f"by splits at ppb {best} (device ms, modeled ms): "
              f"{ {s: (round(x['device_ms'], 4), round(x['modeled_ms'], 4)) for s, x in per_split.items()} }, "
              f"best {best_split}, the rule's {rule} {100 * rule_loss:.1f}% "
              f"slower [{card}]", flush=True)
        del args, q, kp, vp, tbl, cl, ks, vs
    torch.cuda.synchronize()
    by_path["paged-check"] = read_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 13: speculative serving (13a, 13b), sampling on the card (13c) and
# the multi-replica Router (13d)
# ---------------------------------------------------------------------------

def first_layer(tree):
    """The stacked layer leaves sliced to layer 0 (views: no copy)."""
    if isinstance(tree, dict):
        return {k: first_layer(v) for k, v in tree.items()}
    return tree[:1]


def watch_gaps(torch, eng):
    """Wrap eng._sample_rows: per (rid, token index), the top-2 logit gap
    and max |logit| of the row the engine samples from (kept on the
    device until read)."""
    seen = {}
    real = eng._sample_rows

    def sample(logits, slots):
        lg = logits.float().reshape(len(slots), -1)
        top = torch.topk(lg, 2, dim=-1).values
        stat = torch.stack([top[:, 0] - top[:, 1], lg.abs().amax(-1)], -1)
        for i, s in enumerate(slots):
            if s is not None:
                seen[(s.rid, s.n_gen)] = stat[i]
        return real(logits, slots)

    eng._sample_rows = sample
    return seen


def watch_verify(torch, eng):
    """Wrap eng.model.decode_verify: per call, the slots (rid, tokens
    before the round, temperature) and the argmax at each verify position
    (on the device until read)."""
    calls = []
    real = eng.model.decode_verify

    def verify(params, cache, tokens):
        logits, new = real(params, cache, tokens)
        calls.append(([(s.rid, s.n_gen, s.temperature) if s else None
                       for s in eng._slots], logits.argmax(-1)))
        return logits, new

    eng.model.decode_verify = verify
    return calls


def first_logits(eng):
    """Wrap eng._sample_rows: the f32 logits (numpy) of the first sample
    of a run, under "logits"."""
    seen = {}
    real = eng._sample_rows

    def sample(logits, slots):
        seen.setdefault("logits", logits.reshape(-1).float().cpu().numpy())
        return real(logits, slots)

    eng._sample_rows = sample
    return seen


def count_admissions(eng, flash_cuda, into):
    """Wrap eng._admit: (rid, prompt length, flash_fwd launches) per
    admission, appended to `into`."""
    real = eng._admit

    def admit(cache, slot_idx, r, t_enqueue):
        f0 = flash_cuda.flash_fwd.launches
        out = real(cache, slot_idx, r, t_enqueue)
        into.append((r.rid, len(r.prompt), flash_cuda.flash_fwd.launches - f0))
        return out

    eng._admit = admit


def first_divergence(got, want):
    """Index of the first token where two outputs differ, else None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def held_to_plain(tag, outs, base, gaps, rids, card):
    """Greedy outputs against an undisturbed plain run: a divergence fails
    unless the plain run's top-2 logit gap at that position lies within
    the bf16 floor (SERVE_LOGIT_RTOL x max |logit|): a verify of M = B Q
    rows and a decode of M = B rows may take different GEMMs on the card.
    Returns (bit-exact fraction, [(rid, position, gap, floor)])."""
    div = []
    for rid in rids:
        p = first_divergence(outs[rid], base[rid])
        if p is None:
            continue
        gap, top = (float(x) for x in gaps[(rid, p)])
        div.append((rid, p, gap, SERVE_LOGIT_RTOL * top))
    frac = 1.0 - len(div) / len(rids)
    line = (f"[{tag}] greedy outputs against the plain run: bit-exact "
            f"{len(rids) - len(div)}/{len(rids)} ({frac:.3f}); divergences "
            f"(rid, position, plain top-2 gap, floor "
            f"{SERVE_LOGIT_RTOL} x max|logit|): "
            f"{[(r, p, round(g, 5), round(f, 5)) for r, p, g, f in div]} "
            f"[{card}]")
    print(line, flush=True)
    if any(g > f for _, _, g, f in div):
        fail(line)
    return frac, div


def verify_vs_steps(torch, eng, q):
    """decode_verify on a copy of eng's cache against q sequential
    decode_step calls on another copy, over the occupied rows: max |diff|
    / max |logit|, and whether the positions agree."""
    copy = {k: v.clone() for k, v in eng._cache.items()}
    seq = {k: v.clone() for k, v in eng._cache.items()}
    g = torch.Generator(device=eng.device).manual_seed(13)
    toks = torch.randint(0, eng.cfg.vocab_size, (eng.max_batch, q),
                         generator=g, device=eng.device)
    toks[:, 0] = torch.as_tensor(eng._cur[:, 0], device=eng.device)
    rows = [i for i, s in enumerate(eng._slots) if s is not None]
    vl, vc = eng.model.decode_verify(eng.params, copy, toks)
    worst = 0.0
    for j in range(q):
        sl, seq = eng.model.decode_step(eng.params, seq, toks[:, j:j + 1])
        worst = max(worst, logit_rel(vl[rows, j], sl[rows, 0]))
    same_pos = bool(torch.equal(vc["pos"], seq["pos"]))
    del copy, seq
    return worst, same_pos, len(rows)


def spec_margins(np, spec_lib, trng, temperature, key, rid, n_gen, dlg, tlg,
                 k):
    """The decisions of one spec round of a temperature row, recomputed
    from its logits (draft (k, V), verify (k+1, V), f32 numpy): each
    draft draw's Gumbel margin (top-2 gap of z/T + g), each accept's
    |log u - log(p_t/p_d)|, and the residual or bonus draw's margin, each
    beside its floor (SERVE_LOGIT_RTOL x max |logit| moves z/T by that
    over T: twice that for a draw, four times for an accept)."""
    def gap(z):
        s = np.sort(z)
        return float(s[-1] - s[-2])

    def gumbel(salt, j, n):
        sk = spec_lib.spec_sample_key(key, rid, n_gen + j, salt)
        return trng.gumbel(sk, (n,)).cpu().numpy()

    out = []
    delta = SERVE_LOGIT_RTOL * float(max(np.abs(dlg).max(),
                                         np.abs(tlg).max()))
    toks = []
    for j in range(k):
        z = dlg[j] / np.float32(temperature) + gumbel(spec_lib.SALT_DRAFT,
                                                       j, dlg.shape[1])
        toks.append(int(np.argmax(z)))
        out.append(("draft", gap(z), 2 * delta / temperature))
    pt = spec_lib._softmax(tlg.astype(np.float64) / temperature)
    pd = spec_lib._softmax(dlg.astype(np.float64) / temperature)
    for j in range(k):
        u = float(trng.uniform(spec_lib.spec_sample_key(
            key, rid, n_gen + j, spec_lib.SALT_ACCEPT)))
        ratio = pt[j, toks[j]] / max(pd[j, toks[j]], 1e-30)
        out.append(("accept", float(abs(np.log(u) - np.log(ratio))),
                    4 * delta / temperature))
        if u >= ratio:
            resid = np.maximum(pt[j] - pd[j], 0.0)
            z = (np.log(resid / resid.sum() + 1e-300).astype(np.float32)
                 + gumbel(spec_lib.SALT_RESIDUAL, j, tlg.shape[1]))
            out.append(("residual", gap(z), 4 * delta / temperature))
            return out
    z = (np.log(pt[k] + 1e-300).astype(np.float32)
         + gumbel(spec_lib.SALT_BONUS, k, tlg.shape[1]))
    out.append(("bonus", gap(z), 4 * delta / temperature))
    return out


def spec_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
               by_path):
    """Phase 13a-c: qwen2-1.5b at full width served speculatively (the
    draft is the target's own first layer), over the dense and the paged
    cache; Threefry on the card against the CPU."""
    import dataclasses
    import repro_torch
    from repro_torch.serve import rng as trng
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              n_layers=SPEC_LAYERS, use_flash_attention=True)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    # the JAX package's zero-train draft (benchmarks/run.py:587-614): the
    # target's first layer over the shared embedding and final norm
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = {**params, "layers": first_layer(params["layers"])}
    rng = np.random.default_rng(0)             # phase 8's nine requests
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    hot = rng.integers(0, cfg.vocab_size, 200)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=FAMILY_SERVE_NEW)
            for i, p in enumerate(prompts)]
    hot_rid = len(prompts)
    reqs.append(Request(rid=hot_rid, prompt=hot,
                        max_new_tokens=FAMILY_SERVE_NEW,
                        temperature=SPEC_HOT_T))
    greedy = [r.rid for r in reqs if r.temperature == 0]

    def engine(**kw):
        return ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                           device=dev, **kw)

    spec_kw = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=SPEC_K)
    plain, spec = engine(), engine(**spec_kw)
    for eng in (plain, spec):      # warm-up: cuBLAS handles, the flash pick
        eng.run([Request(rid=99, prompt=prompts[0], max_new_tokens=4)])
    torch.cuda.synchronize()

    # -- 13a. plain, then spec, on the same params and requests -------------
    gaps = watch_gaps(torch, plain)
    torch.cuda.reset_peak_memory_stats(dev)
    pstats, p_dec, p_adm = drive(plain, reqs)
    torch.cuda.synchronize()
    p_peak = torch.cuda.max_memory_allocated(dev)
    real_verify = spec.model.decode_verify
    vcalls = watch_verify(torch, spec)
    admits = []
    count_admissions(spec, flash_cuda, admits)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    sstats, s_dec, s_adm = drive(spec, reqs)
    torch.cuda.synchronize()
    by_path["spec_serve"] = read_counts()
    s_peak = torch.cuda.max_memory_allocated(dev)
    spec_out = dict(spec.outputs)
    spec.model.decode_verify = real_verify
    sp = sstats["spec"]
    per_admit = sorted({f for _, _, f in admits})
    line = (f"[13a] serve qwen2-1.5b (full width, {cfg.n_layers} layers, "
            f"flash on) speculatively: draft = its own first layer, spec_k "
            f"{SPEC_K}, {len(reqs)} requests (8 greedy, 1 at T={SPEC_HOT_T}), "
            f"{sstats['prefills']} prefills, {sp['verify_steps']} row-verify "
            f"steps in {sstats['decode_steps']} rounds; acceptance rate "
            f"{sp['acceptance_rate']:.4f}, accepted tokens a verify step "
            f"{sp['accepted_tokens_per_step']:.4f}; accepted {sp['accepted']} "
            f"+ rejected {sp['rejected']} + bonus {sp['bonus']} = "
            f"{sp['accepted'] + sp['rejected'] + sp['bonus']} (tokens emitted "
            f"{sp['tokens_emitted']}); flash_fwd launches per admission "
            f"{per_admit} (expected {cfg.n_layers} + {dcfg.n_layers}); "
            f"launches {by_path['spec_serve']} [{card}]")
    print(line, flush=True)
    if (sp["accepted"] + sp["rejected"] + sp["bonus"] != sp["tokens_emitted"]
            or per_admit != [cfg.n_layers + dcfg.n_layers]
            or len(admits) != len(reqs)
            or by_path["spec_serve"]["flash_fwd"]
            != (cfg.n_layers + dcfg.n_layers) * len(reqs)
            or any(v for k, v in by_path["spec_serve"].items()
                   if k != "flash_fwd")):
        fail(line)
    check_outputs(spec, reqs, cfg.vocab_size)
    res = {"plain": serve_metrics("13a plain", pstats, p_dec, p_adm, p_peak,
                                  len(reqs), card),
           "spec": serve_metrics("13a spec", sstats, s_dec, s_adm, s_peak,
                                 len(reqs), card)}
    res["spec"].update({k: sp[k] for k in (
        "acceptance_rate", "accepted_tokens_per_step", "accepted",
        "rejected", "bonus", "tokens_emitted", "verify_steps", "proposed")})
    res["flash_per_admission"] = per_admit[0]
    print(f"[13a] spec round p50 {res['spec']['decode_step_ms_p50']:.2f} ms "
          f"(k {SPEC_K}: {SPEC_K + 1} draft steps + one {SPEC_K + 1}-position "
          f"verify) against the plain decode round p50 "
          f"{res['plain']['decode_step_ms_p50']:.2f} ms; tokens/s spec "
          f"{res['spec']['tok_per_s']:.1f}, plain "
          f"{res['plain']['tok_per_s']:.1f}; TTFT p50 spec "
          f"{res['spec']['p50_ttft_ms']:.1f} ms, plain "
          f"{res['plain']['p50_ttft_ms']:.1f} ms; peak device memory spec "
          f"{s_peak / 1e9:.2f} GB, plain {p_peak / 1e9:.2f} GB [{card}]",
          flush=True)

    # where a spec round's time goes: one admission round and three spec
    # rounds under torch.profiler (after the outputs are kept)
    profile_rounds(torch, "13a spec", spec, reqs[1:8:2], res["spec"], card)
    torch.cuda.synchronize()

    # every greedy token a round emitted is the argmax of its verify
    # logits at that position (a round emits up to the next round's start)
    rounds = [(s[0], s[1], arg, i) for slots, arg in vcalls
              for i, s in enumerate(slots) if s is not None and s[2] == 0]
    bad = []
    for rid, n0, arg, i in rounds:
        n1 = min([n for r, n, _, _ in rounds if r == rid and n > n0],
                 default=len(spec_out[rid]))
        emitted = spec_out[rid][n0:n1]
        want = arg[i].tolist()[:len(emitted)]
        if not emitted or emitted != want:
            bad.append((rid, n0, emitted, want))
    line = (f"[13a] greedy tokens against their round's verify argmax: "
            f"{len(vcalls)} rounds, mismatches {bad[:4]} [{card}]")
    print(line, flush=True)
    if bad:
        fail(line)
    frac, div = held_to_plain("13a", spec_out, plain.outputs, gaps, greedy,
                              card)
    res["bitexact_frac"] = frac
    res["divergences"] = [(r, p) for r, p, _, _ in div]

    # decode_verify against Q sequential decode_step calls on a copy of
    # the cache, after one admission round of 4 requests
    spec.reset()
    for r in reqs[:4]:
        spec.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8))
    spec.step()
    worst, same_pos, n_rows = verify_vs_steps(torch, spec, SPEC_K + 1)
    line = (f"[13a] decode_verify (Q={SPEC_K + 1}) against {SPEC_K + 1} "
            f"sequential decode_step calls on a copy of the cache, {n_rows} "
            f"rows: max |diff| / max |logit| {worst:.3e} (tol "
            f"{SERVE_LOGIT_RTOL}), positions equal {same_pos} [{card}]")
    print(line, flush=True)
    if worst > SERVE_LOGIT_RTOL or not same_pos:
        fail(line)
    res["verify_vs_steps_rel"] = worst

    # -- 13b. the same requests over the paged cache ------------------------
    paged = engine(kv_page_size=PAGED_PAGE, **spec_kw)
    zero_counts()
    bstats, b_dec, b_adm = drive(paged, reqs)
    torch.cuda.synchronize()
    by_path["spec_paged"] = read_counts()
    paged.kv.check_conservation()
    kv = bstats["kvcache"]
    same = all(paged.outputs[r.rid] == spec_out[r.rid] for r in reqs)
    # pages cover committed lines only: each request's peak is
    # ceil((prompt + max_new) / page), never the speculated tip beyond it
    need = sorted((-(-(len(r.prompt) + r.max_new_tokens) // PAGED_PAGE)
                   for r in reqs), reverse=True)
    bound = sum(need[:4]) + kv["index_pages"]
    line = (f"[13b] spec over kv_page_size {PAGED_PAGE}: tokens equal to "
            f"13a's spec run {same}; peak live pages {kv['peak_live_pages']} "
            f"of {kv['n_pages']} (committed lines of the 4 largest requests + "
            f"index pages: {bound}); pages live at the end "
            f"{kv['pages_live']} = index {kv['index_pages']}; conservation "
            f"holds; spec round p50 {b_dec[len(b_dec) // 2]:.2f} ms; "
            f"acceptance {bstats['spec']['acceptance_rate']:.4f}; launches "
            f"{by_path['spec_paged']} [{card}]")
    print(line, flush=True)
    if (not same or kv["pages_live"] != kv["index_pages"]
            or kv["peak_live_pages"] > bound
            or bstats["spec"] != sstats["spec"]):
        fail(line)
    res["paged"] = {"peak_live_pages": kv["peak_live_pages"],
                    "n_pages": kv["n_pages"],
                    "decode_step_ms_p50": b_dec[len(b_dec) // 2],
                    "tok_per_s": bstats["tok_per_s"]}
    del paged

    # -- 13c. Threefry on the card against the CPU --------------------------
    r = np.random.default_rng(13)
    trip = [(int(r.integers(-2 ** 31, 2 ** 31)), int(r.integers(0, 2 ** 32)),
             int(r.integers(0, 64))) for _ in range(64)]

    def keys(device):
        return torch.stack([trng.fold_in(trng.fold_in(
            trng.prng_key(s, device=device), rid), n) for s, rid, n in trip])

    kd, kc = keys(dev), keys("cpu")
    logits = torch.randn((64, cfg.vocab_size),
                         generator=torch.Generator().manual_seed(13)) * 2.0
    t0 = time.perf_counter()
    bits_d = trng.random_bits(kd, (cfg.vocab_size,))
    cat_d = trng.categorical(kd, logits.to(dev))
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    bits_eq = bool(torch.equal(bits_d.cpu(),
                               trng.random_bits(kc, (cfg.vocab_size,))))
    cat_eq = bool(torch.equal(cat_d.cpu(), trng.categorical(kc, logits)))
    keys_eq = bool(torch.equal(kd.cpu(), kc))

    # the T=0.8 row: its first 4 tokens against the same engine on the CPU
    # (tokens 1-3 come from one spec round; each decision's margin beside
    # the floor the two devices' logits may differ by)
    host = ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                       device="cpu", **spec_kw)
    rec = {"draft": [], "verify": []}
    real_d, real_v = host.draft_model.decode_step, host.model.decode_verify

    def d_step(p, c, t):
        lg, new = real_d(p, c, t)
        rec["draft"].append(lg[0, 0].float().numpy().copy())
        return lg, new

    def v_step(p, c, t):
        lg, new = real_v(p, c, t)
        rec["verify"].append(lg[0].float().numpy().copy())
        return lg, new

    host.draft_model.decode_step, host.model.decode_verify = d_step, v_step
    hgaps = first_logits(host)
    t0 = time.perf_counter()
    hout = host.run([Request(rid=hot_rid, prompt=hot, max_new_tokens=4,
                             temperature=SPEC_HOT_T)])[hot_rid]
    host_s = time.perf_counter() - t0
    first = trng.fold_in(trng.fold_in(host.rng, hot_rid), 0)
    z0 = hgaps["logits"] / np.float32(SPEC_HOT_T) + trng.gumbel(
        first, (cfg.vocab_size,)).numpy()
    top2 = np.sort(z0)[-2:]
    margins = [("first", float(top2[1] - top2[0]),
                2 * SERVE_LOGIT_RTOL * float(np.abs(hgaps["logits"]).max())
                / SPEC_HOT_T)]
    margins += spec_margins(np, spec_lib, trng, SPEC_HOT_T, host.rng,
                            hot_rid, 1, np.stack(rec["draft"][:SPEC_K]),
                            rec["verify"][0], SPEC_K)
    card_out = spec_out[hot_rid][:4]
    clears = all(m > f for _, m, f in margins)
    line = (f"[13c] Threefry on the card against the CPU over 64 (seed, rid, "
            f"n_gen) keys at V={cfg.vocab_size}: keys equal {keys_eq}, "
            f"random_bits equal {bits_eq}, categorical equal {cat_eq} (card "
            f"{card_ms:.1f} ms for bits + categorical); the T={SPEC_HOT_T} "
            f"row's first 4 tokens on the card {card_out[:4]} and on the CPU "
            f"{hout} (CPU run {host_s:.1f} s); margins (decision, margin, "
            f"floor): {[(k, round(m, 5), round(f, 5)) for k, m, f in margins]}"
            f" [{card}]")
    print(line, flush=True)
    if not (keys_eq and bits_eq and cat_eq):
        fail(line)
    if card_out != hout and clears:
        fail(line)
    res["sampling"] = {"bits_equal": bits_eq, "categorical_equal": cat_eq,
                       "hot_row_equal": card_out == hout,
                       "margins_clear_floor": clears,
                       "min_margin_over_floor": min(m / f for _, m, f
                                                    in margins)}
    del host, plain, spec, params, dparams
    return res


def router_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
                 by_path):
    """Phase 13d: Router with 2 replicas of qwen2-1.5b (flash on) sharing
    one params tree on the card, a generate_trace trace and a flap of
    replica 1; outputs against an undisturbed single engine."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import FaultPlan, Router
    from repro_torch.serve.trace import TraceConfig, generate_trace
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              n_layers=SPEC_LAYERS, use_flash_attention=True)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    trace = generate_trace(TraceConfig(vocab=cfg.vocab_size, **ROUTER_TRACE))
    single = ServeEngine(cfg, params, max_batch=4, cache_len=512, device=dev)
    gaps = watch_gaps(torch, single)
    base = single.run(trace.plain_requests())
    hb = os.path.join(ROOT, "build", "chip_smoke_router_hb")
    shutil.rmtree(hb, ignore_errors=True)
    router = Router(cfg, params, replicas=2, max_batch=4, cache_len=512,
                    device=dev, heartbeat_dir=hb,
                    fault_plan=FaultPlan().flap(1, **ROUTER_FLAP))
    shared = all(rep.engine.params["embed"] is params["embed"]
                 for rep in router.replicas)
    admits = []
    for rep in router.replicas:
        count_admissions(rep.engine, flash_cuda, admits)
    zero_counts()
    t0 = time.perf_counter()
    out, st = router.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["router"] = read_counts()
    n = len(trace.requests)
    outcomes = st["outcomes"]
    # flash_fwd runs on a prefill whose bucket is 256 (S % 256 == 0):
    # prompts of 129-256 tokens
    want_flash = sum(cfg.n_layers for _, plen, _ in admits if plen > 128)
    line = (f"[13d] Router, 2 replicas of qwen2-1.5b (full width, flash on) "
            f"on one card, params shared {shared}: {n} requests "
            f"(generate_trace {ROUTER_TRACE}), replica 1 flapped "
            f"{ROUTER_FLAP}; outcomes {sorted(set(outcomes.values()))} for "
            f"{len(outcomes)} rids, completed {st['completed']}, killed "
            f"{st['killed']}, fenced {st['fenced']}, recovered "
            f"{st['recovered']} (recoveries {st['recoveries']}, "
            f"fence-to-recover ticks {st['recovery_ticks']}), requeued "
            f"{st['requeued']}, wasted tokens {st['wasted_toks']}; ticks "
            f"{st['ticks']}: TTFT p50 {st['p50_ttft_ticks']} p99 "
            f"{st['p99_ttft_ticks']} ticks, TPOT p50 "
            f"{st['p50_tpot_ticks']:.3f} p99 {st['p99_tpot_ticks']:.3f} "
            f"ticks; wall {wall:.2f} s, {st['goodput_tok_per_s']:.1f} "
            f"tokens/s goodput; {len(admits)} admissions, flash_fwd "
            f"{by_path['router']['flash_fwd']} (expected {want_flash}) "
            f"[{card}]")
    print(line, flush=True)
    if (sorted(outcomes) != [tr.request.rid for tr in trace.requests]
            or st["completed"] + st["shed"] + st["deadline_missed"] != n
            or st["completed"] != n or st["recoveries"] != 1
            or not shared or by_path["router"]["flash_fwd"] != want_flash
            or any(v for k, v in by_path["router"].items()
                   if k != "flash_fwd")):
        fail(line)
    frac, div = held_to_plain("13d", out, base, gaps, sorted(out), card)
    res = {"requests": n, "completed": st["completed"],
           "recoveries": st["recoveries"], "requeued": st["requeued"],
           "wasted_toks": st["wasted_toks"], "ticks": st["ticks"],
           "p50_ttft_ticks": st["p50_ttft_ticks"],
           "p99_ttft_ticks": st["p99_ttft_ticks"],
           "p50_tpot_ticks": st["p50_tpot_ticks"],
           "p99_tpot_ticks": st["p99_tpot_ticks"], "wall_s": wall,
           "goodput_tok_per_s": st["goodput_tok_per_s"],
           "bitexact_frac": frac, "divergences": [(r, p) for r, p, _, _
                                                  in div]}
    del router, single, params
    return res


# ---------------------------------------------------------------------------
# phase 14: the moe family (14a serving, 14b the layer, 14c training)
# ---------------------------------------------------------------------------

def moe_serve_phase(torch, np, dev, card, flash_cuda, zero_counts,
                    read_counts, by_path):
    """Phase 14a: ServeEngine on deepseek-moe-16b at full width cut to
    MOE_SERVE_LAYERS layers, flash on; the same requests again (bit-equal
    outputs), through the paged cache (equal outputs), and the flash-sized
    admissions once more with every flash_fwd launch held against its plain
    version. Returns
    (metrics, the first moe layer's params, cloned, for 14b)."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(repro_torch.get_config("deepseek-moe-16b"),
                              n_layers=MOE_SERVE_LAYERS,
                              use_flash_attention=True)
    v = cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, v, n) for n in MOE_PROMPTS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=FAMILY_SERVE_NEW)
            for i, p in enumerate(prompts)]
    reqs.append(Request(rid=len(prompts),
                        prompt=rng.integers(0, v, MOE_HOT_PROMPT),
                        max_new_tokens=FAMILY_SERVE_NEW,
                        temperature=SPEC_HOT_T))
    # warm-up: one flash-sized request (cuBLAS handles, the flash pick)
    eng.run([Request(rid=99, prompt=prompts[0], max_new_tokens=2)])
    n_flash = sum(len(r.prompt) % 256 == 0 for r in reqs)
    want = {"flash_fwd": cfg.n_layers * n_flash}

    def describe(stats):
        return (f"serve deepseek-moe-16b (full width, {cfg.n_layers} "
                f"layers: {cfg.first_k_dense} dense + "
                f"{cfg.n_layers - cfg.first_k_dense} moe of "
                f"{cfg.n_experts} experts top-{cfg.experts_per_token} + "
                f"{cfg.n_shared_experts} shared; {n_params / 1e9:.3f}e9 "
                f"params, init {init_s:.1f} s), flash on: "
                f"{stats['requests']} requests (prompts "
                f"{[len(r.prompt) for r in reqs]}), {stats['prefills']} "
                f"prefills, {stats['decode_steps']} decode steps, "
                f"{stats['new_tokens']} tokens (flash_fwd: {cfg.n_layers} x "
                f"{n_flash} flash-sized prompts)")

    # the paged cache: k/v and dk/dv leaves paged, no prefix reuse for moe
    peng = ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                       kv_page_size=PAGED_PAGE, device=dev)
    res, first = serve_checked(torch, dev, card, "14a", "moe", eng, reqs,
                               zero_counts, read_counts, by_path, describe,
                               reqs[:8:2], want=want, paged=peng)
    res.update(n_params=n_params, init_s=init_s, flash_prompts=n_flash)

    # each flash-sized prompt prefilled once more through the admission
    # path, every flash_fwd launch (group 1) held against flash_fwd_plain
    # on its own inputs; the first token against the first run's
    flash_reqs = [r for r in reqs if len(r.prompt) % 256 == 0]
    launch_ulps, rows = [], []

    def against_plain(args, got):
        launch_ulps.append(bf16_ulps(got[0],
                                     flash_cuda.flash_fwd_plain(*args)[0]))

    zero_counts()
    with hold_launches(flash_cuda, "flash_fwd", against_plain):
        for r in flash_reqs:
            lg = first_token_logits(eng, r)
            rows.append((r.rid, len(r.prompt), int(lg.argmax()),
                         first[r.rid][0], bool(torch.isfinite(lg).all())))
    torch.cuda.synchronize()
    by_path["moe-serve-check"] = read_counts()
    worst = max(launch_ulps) if launch_ulps else float("inf")
    line = (f"[14a] {len(launch_ulps)} flash_fwd launches (group 1) in "
            f"{len(flash_reqs)} flash-sized prefills held against "
            f"flash_fwd_plain on their own inputs: worst {worst:.2f} bf16 "
            f"ulps (tol {FLASH_OUT_ULPS}); per prompt (rid, tokens, argmax, "
            f"first run's first token, finite): {rows}; launches "
            f"{by_path['moe-serve-check']} [{card}]")
    print(line, flush=True)
    if (len(launch_ulps) != cfg.n_layers * len(flash_reqs)
            or worst > FLASH_OUT_ULPS
            or not all(x[2] == x[3] and x[4] for x in rows)):
        fail(line)
    res["launch_ulps_max"] = worst
    layer = {k: t[0].clone() for k, t in params["layers"]["moe"].items()}
    del eng, peng, params
    return res, layer


def moe_layer_checks(torch, np, dev, spec, card, layer):
    """Phase 14b: the moe layer (models/moe.moe_ffn) on deepseek's first
    moe layer at its prefill (T=512) and decode (T=4) shapes: two runs on
    the card bit-equal, the card against the port's CPU run within the
    MOE_* gates, a call's ms, the device ms from a CUDA graph, the
    bound."""
    import repro_torch
    from repro_torch import backend
    from repro_torch.models import moe
    cfg = repro_torch.get_config("deepseek-moe-16b")
    e, k, d = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    f, fs = cfg.moe_d_ff, cfg.moe_d_ff * cfg.n_shared_experts
    cpu_layer = {n: t.cpu() for n, t in layer.items()}
    w_bytes = sum(t.numel() * t.element_size() for t in layer.values())
    rng = np.random.default_rng(3)
    rows = {}
    for tag, t in (("prefill", 512), ("decode", 4)):
        x_cpu = torch.from_numpy(rng.standard_normal((t, d)).astype(
            np.float32)).to(torch.bfloat16)
        x = x_cpu.to(dev)

        def call():
            return moe.moe_ffn(x, layer, n_experts=e, k=k)

        def route(x, layer):
            gate, idx, _, _ = moe.dispatch(x, layer["router"], n_experts=e,
                                           k=k)
            return {"gather_idx": idx, "gate": gate}

        with backend.f32_accumulation():
            runs = []
            for _ in range(2):
                out, aux = call()
                runs.append((out, aux, route(x, layer)))
            torch.cuda.synchronize()
            ms = cuda_ms(call)
            device_ms = graph_ms(call)
        (o1, a1, d1), (o2, a2, d2) = runs
        rerun = (torch.equal(o1.view(torch.int16), o2.view(torch.int16))
                 and torch.equal(a1, a2)
                 and torch.equal(d1["gather_idx"], d2["gather_idx"])
                 and torch.equal(d1["gate"], d2["gate"]))
        t0 = time.perf_counter()
        oc, ac = moe.moe_ffn(x_cpu, cpu_layer, n_experts=e, k=k)
        cpu_s = time.perf_counter() - t0
        dc = route(x_cpu, cpu_layer)
        ok_e, ok_t = moe.settled(x_cpu, cpu_layer["router"], dc["gate"],
                                 n_experts=e, k=k, margin=MOE_MARGIN)
        gc_, oc_ = d1["gather_idx"].cpu().sort(-1)
        gp_, op_ = dc["gather_idx"].sort(-1)
        same_idx = torch.equal(gc_[ok_e], gp_[ok_e])
        gate_err = float((d1["gate"].cpu().gather(-1, oc_)[ok_e]
                          - dc["gate"].gather(-1, op_)[ok_e]).abs().max())
        n_t = int(ok_t.sum())
        want = oc.float()[ok_t]
        out_ulps = (float((o1.cpu().float()[ok_t] - want).abs().max())
                    / ulp_at_max(want)) if n_t else float("inf")
        c = moe.capacity(t, k, e)
        flops = 2 * e * c * d * f * 3 + 2 * t * d * fs * 3 + 2 * t * d * e
        n_bytes = w_bytes + 2 * t * d * 2
        ops_ms = flops / spec.bf16_tc_flops * 1e3
        bytes_ms = n_bytes / spec.hbm_bw * 1e3
        row = {"shape": {"T": t, "D": d, "E": e, "k": k, "F": f, "C": c},
               "rerun_bit_equal": rerun, "experts_compared": int(ok_e.sum()),
               "tokens_compared": n_t, "gather_idx_equal": same_idx,
               "gate_max_abs_err": gate_err, "out_ulps": out_ulps,
               "aux": float(a1), "aux_cpu": float(ac), "ms": ms,
               "device_ms": device_ms, "cpu_s": cpu_s,
               "bytes": n_bytes, "flops": flops,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}
        rows[tag] = row
        line = (f"[14b] moe_ffn {tag} (T={t}, D={d}, E={e}, top-{k}, F={f}, "
                f"C={c}, shared {fs}): two runs on the card bit-equal "
                f"{rerun}; against the CPU run where the routing margins "
                f"exceed {MOE_MARGIN}: {row['experts_compared']}/{e} experts "
                f"(gather_idx equal {same_idx}, gates within {gate_err:.2e}, "
                f"tol {MOE_GATE_ATOL}), {n_t}/{t} tokens (out within "
                f"{out_ulps:.2f} bf16 ulps at the largest, tol "
                f"{MOE_OUT_ULPS}); aux {float(a1):.6f} (CPU {float(ac):.6f}); "
                f"a call {ms:.4f} ms, device {device_ms:.4f} ms (CUDA graph), "
                f"the CPU run {cpu_s:.2f} s; bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}: {n_bytes / 1e9:.3f} GB at "
                f"{spec.hbm_bw / 1e12:.2f} TB/s, {flops / 1e9:.2f} GFLOP at "
                f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s) [{card}]")
        print(line, flush=True)
        if (not rerun or not same_idx or gate_err > MOE_GATE_ATOL
                or out_ulps > MOE_OUT_ULPS or 2 * n_t < t
                or 4 * row["experts_compared"] < e):
            fail(line)
    return rows


def moe_train_phase(torch, dev, spec, card, flash_cuda, zero_counts,
                    read_counts, by_path):
    """Phase 14c: Trainer(...).run() on deepseek-moe-16b at full width cut
    to MOE_TRAIN_LAYERS layers, remat "full", flash on, the TrainLoopConfig
    defaults (seq_len 512, global_batch 8), TRAIN_STEPS steps. Phase 10
    holds the checkpoint; this one writes none (the save is counted)."""
    import dataclasses
    import math
    import repro_torch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    cfg = dataclasses.replace(repro_torch.get_config("deepseek-moe-16b"),
                              n_layers=MOE_TRAIN_LAYERS, remat="full",
                              use_flash_attention=True)
    n_layers = cfg.n_layers
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_moe_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                           log_every=1, ckpt_dir=ckpt_dir)
    tr = Trainer(cfg, loop, device=dev)
    saves, step_ms, step_counts, metrics = [], [], [], []
    real_step = tr.step_fn

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        metrics.append({k: float(x) for k, x in out[2].items()})
        return out

    tr.step_fn = timed_step
    tr.ckpt.save = lambda step, tree, **kw: saves.append(step)
    print(f"[14c] train deepseek-moe-16b at full width cut to {n_layers} "
          f"layers ({cfg.first_k_dense} dense + "
          f"{n_layers - cfg.first_k_dense} moe), remat {cfg.remat!r}, "
          f"{cfg.optimizer}, flash on: seq_len {loop.seq_len}, global_batch "
          f"{loop.global_batch}, {TRAIN_STEPS} steps", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = tr.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    by_path["moe_train"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    auxes = [m["aux"] for m in metrics]
    lse0 = math.log(cfg.vocab_size) + INIT_SCALE ** 2 * cfg.d_model / 2
    loss0 = lse0 + 1e-4 * lse0 ** 2
    per_step = {k: 0 for k in by_path["moe_train"]}
    per_step.update(flash_fwd=2 * n_layers, flash_bwd_dq=n_layers,
                    flash_bwd_dkv=n_layers)
    line = (f"[14c] losses {[round(x, 4) for x in losses]} (step 0 expected "
            f"{loss0:.4f} +- {MOE_LOSS0_ATOL}); router aux a step "
            f"{[round(a, 4) for a in auxes]} (summed over "
            f"{n_layers - cfg.first_k_dense} moe layers, ~1 each at balanced "
            f"routing); launches a step {step_counts[0]} (expected "
            f"{per_step}); whole run {by_path['moe_train']}; saves {saves} "
            f"[{card}]")
    print(line, flush=True)
    if (len(losses) != TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses + auxes)
            or abs(losses[0] - loss0) > MOE_LOSS0_ATOL
            or any(c != per_step for c in step_counts)
            or saves != [TRAIN_STEPS]):
        fail(line)
    tokens = loop.seq_len * loop.global_batch
    n_params = cfg.param_count()
    # parameters a token meets: every expert but its top-k is skipped
    n_active = n_params - ((n_layers - cfg.first_k_dense)
                           * (cfg.n_experts - cfg.experts_per_token)
                           * 3 * cfg.d_model * cfg.moe_d_ff)
    attn = 3 * n_layers * flash_cuda.useful_flops(
        loop.global_batch, cfg.n_heads, loop.seq_len, loop.seq_len,
        cfg.head_dim, True)
    steady = sorted(step_ms[1:])
    step_p50 = steady[len(steady) // 2]
    mfu = ((6 * n_active * tokens + attn) / (step_p50 / 1e3)
           / spec.bf16_tc_flops)
    res = {"losses": losses, "aux": auxes, "step_ms": step_ms,
           "step_ms_p50": step_p50, "tokens_per_step": tokens,
           "tok_per_s": tokens / step_p50 * 1e3, "mfu": mfu,
           "n_params": n_params, "n_active_params": n_active,
           "peak_mem_gb": peak / 1e9, "run_s": run_s,
           "grad_norm": [m["grad_norm"] for m in metrics]}
    print(f"[14c] step ms {[round(x, 2) for x in step_ms]} (p50 after the "
          f"first {step_p50:.2f}); {res['tok_per_s']:.1f} tokens/s; mfu "
          f"{mfu:.4f} ((6 N_active tokens + attention {attn:.3e}) / step / "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, N_active = {n_active} "
          f"of N = {n_params}); peak device memory {peak / 1e9:.2f} GB "
          f"[{card}]", flush=True)

    # one more step with every flash launch (group 1) held against its
    # plain version on its own inputs
    src = TokenSource(DataConfig(seq_len=loop.seq_len,
                                 global_batch=loop.global_batch,
                                 vocab_size=cfg.vocab_size, seed=loop.seed))
    batch = {k: torch.from_numpy(a).to(dev)
             for k, a in src.batch_at(TRAIN_STEPS).items()}
    plain = {"flash_fwd": lambda *a: flash_cuda.flash_fwd_plain(*a)[0],
             "flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    errs = {name: [] for name in plain}

    def against_plain(name):
        def check(args, got):
            want = plain[name](*args)
            if name == "flash_fwd":
                errs[name].append(bf16_ulps(got[0], want))
                return
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    zero_counts()
    with hold_launches(flash_cuda, "flash_fwd", against_plain("flash_fwd")), \
            hold_launches(flash_cuda, "flash_bwd_dq",
                          against_plain("flash_bwd_dq")), \
            hold_launches(flash_cuda, "flash_bwd_dkv",
                          against_plain("flash_bwd_dkv")):
        real_step(tr.state["params"], tr.state["opt"], batch)
        torch.cuda.synchronize()
    by_path["moe-train-check"] = read_counts()
    worst = {name: max(e) if e else float("inf") for name, e in errs.items()}
    line = (f"[14c] one checked step: launches held against their plain "
            f"versions on their own inputs (group 1): "
            f"{ {n: len(e) for n, e in errs.items()} } (expected "
            f"{ {n: per_step[n] for n in errs} }), worst {worst} (flash_fwd "
            f"in bf16 ulps, tol {FLASH_OUT_ULPS}; the backward kernels in "
            f"bf16 ulps at the largest element, tol {BWD_ULPS}); launches "
            f"{by_path['moe-train-check']} [{card}]")
    print(line, flush=True)
    if (any(len(e) != per_step[n] for n, e in errs.items())
            or worst["flash_fwd"] > FLASH_OUT_ULPS
            or max(worst["flash_bwd_dq"], worst["flash_bwd_dkv"]) > BWD_ULPS):
        fail(line)
    res["launch_worst_ulps"] = worst
    del tr
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 15: the rwkv6 family served (15a), its layer (15b), and training of
# the recurrent families (15c)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def watch_calls(torch, seen, module, names, ran=None):
    """While open, each module.<name> first records the matmul flags into
    seen (and, when ran is a list, (name, its first argument's shape, its
    chunk keyword) into ran), then runs (the port's own calls inside its
    entry points)."""
    real = {n: getattr(module, n) for n in names}

    def wrap(fn):
        def call(*args, **kw):
            seen.append(matmul_flags(torch))
            if ran is not None:
                ran.append((fn.__name__, tuple(args[0].shape),
                            kw.get("chunk")))
            return fn(*args, **kw)
        return call

    for n in names:
        setattr(module, n, wrap(real[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(module, n, real[n])


WKV_FORMS = ("wkv6_scan", "wkv6_chunked", "wkv6_decode")


def wkv_form(ran, n):
    """The WKV form that ran on the (1, n, ...) segments recorded in ran
    (watch_calls): "wkv6_scan" or "wkv6_chunked(chunk=c)"; fails unless
    exactly one form ran there."""
    forms = {name if chunk is None else f"{name}(chunk={chunk})"
             for name, shape, chunk in ran
             if name != "wkv6_decode" and shape[:2] == (1, n)}
    if len(forms) != 1:
        fail(f"[15a] WKV forms recorded on a {n}-token segment: {forms} "
             f"(exactly one expected)")
    return forms.pop()


@contextlib.contextmanager
def f32_storage(torch):
    """While open, the port's model code keeps in f32 what it stores and
    rounds to bf16 (PARAM_DTYPE of layers, attention, transformer and
    registry): with f32 weights, every product and activation of the rwkv
    and whisper families is f32 (TF32 stays off: f32_accumulation)."""
    from repro_torch.models import attention, layers, registry, transformer
    mods = (layers, attention, registry, transformer)
    real = [m.PARAM_DTYPE for m in mods]
    for m in mods:
        m.PARAM_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, dtype in zip(mods, real):
            m.PARAM_DTYPE = dtype


def decode_vs_prefill(model, params, toks, n):
    """prefill(toks[:, :n]) then one decode step of toks[:, n], against
    the last logits of prefill(toks[:, :n + 1]): max-norm relative."""
    _, cache = model.prefill(params, {"tokens": toks[:, :n]})
    got, _ = model.decode_step(params, cache, toks[:, n:n + 1])
    want, _ = model.prefill(params, {"tokens": toks[:, :n + 1]})
    return logit_rel(got, want)


def rwkv_serve_phase(torch, np, dev, card, zero_counts, read_counts,
                     by_path):
    """Phase 15a: ServeEngine on rwkv6-7b at full width cut to
    RWKV_SERVE_LAYERS layers; the same requests again (bit-equal outputs);
    decode against prefill on the sequential scan (gated) and across the
    -60 clamp (printed). Returns (metrics, layer 0's params, cloned, for
    15b)."""
    import dataclasses
    import repro_torch
    from repro_torch.models import rwkv6
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(repro_torch.get_config("rwkv6-7b"),
                              n_layers=RWKV_SERVE_LAYERS)
    v = cfg.vocab_size
    model = repro_torch.build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, v, n) for n in RWKV_PROMPTS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=RWKV_NEW)
            for i, p in enumerate(prompts)]
    reqs.append(Request(rid=len(prompts),
                        prompt=rng.integers(0, v, RWKV_HOT_PROMPT),
                        max_new_tokens=RWKV_NEW, temperature=SPEC_HOT_T))
    # warm-up: one short request on each WKV form, the matmul flags read at
    # every WKV call inside the engine's work
    seen = []
    with watch_calls(torch, seen, rwkv6, WKV_FORMS):
        eng.run([Request(rid=90 + i, prompt=prompts[-1][:n],
                         max_new_tokens=2) for i, n in enumerate((40, 64, 70))])
    check_flags_inside("15a", seen, card)
    seen, ran, by_route, ttft = [], [], {}, {}

    def describe(stats):
        ttft.update({r.rid: eng.request_stats[r.rid].ttft_s * 1e3
                     for r in reqs})
        for r in reqs:     # the form each admission ran (B=1, exact length)
            by_route.setdefault(wkv_form(ran, len(r.prompt)), []).append(
                (len(r.prompt), round(ttft[r.rid], 1)))
        return (f"serve rwkv6-7b (full width, {cfg.n_layers} layers, "
                f"d_model {cfg.d_model}, "
                f"{cfg.d_model // cfg.rwkv_head_dim} heads of "
                f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {v}; "
                f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s): "
                f"{stats['requests']} requests (prompts "
                f"{[len(r.prompt) for r in reqs]}), {stats['prefills']} "
                f"prefills, {stats['decode_steps']} decode steps, "
                f"{stats['new_tokens']} tokens; TTFT ms by the WKV form each "
                f"admission ran (prompt, ms): {by_route} (every kernel 0: "
                f"WKV is plain torch, as the reference's is pure JAX)")

    # one admission round (the greedy prompts on the chunked forms: 40, 256
    # and 512 tokens) and three decode rounds profiled
    chunked = [r for r in reqs if r.temperature == 0
               and (len(r.prompt) < 64 or len(r.prompt) % 64 == 0)]
    res, _ = serve_checked(
        torch, dev, card, "15a", "rwkv", eng, reqs, zero_counts, read_counts,
        by_path, describe, chunked,
        watch=lambda: watch_calls(torch, seen, rwkv6, WKV_FORMS, ran))
    check_flags_inside("15a", seen, card)
    res.update(n_params=n_params, init_s=init_s, ttft_ms=ttft,
               ttft_by_route=by_route)

    # decode against prefill: 200 -> 201 both on the sequential scan (gated
    # at RWKV_DECODE_RTOL); 256 -> 257 leaves the 64-chunk form, whose
    # carried state took the -60 clamp, for the scan (printed); both again
    # with f32 weights and activations, where 200 -> 201 is held to
    # RWKV_DECODE_F32_RTOL: the witness that the bf16 reading is rounding
    del eng
    toks = torch.as_tensor(rng.integers(0, v, (1, 257)), device=dev)
    seen, ran, prefill_ms, rel = [], [], {}, {}
    with watch_calls(torch, seen, rwkv6, WKV_FORMS, ran):
        rel["bf16", 200] = decode_vs_prefill(model, params, toks, 200)
        rel["bf16", 256] = decode_vs_prefill(model, params, toks, 256)
        for n in (40, 200, 256):        # one chunk, the scan, 64-step chunks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": toks[:, :n]})
            torch.cuda.synchronize()
            prefill_ms[n] = (time.perf_counter() - t0) * 1e3
        p32 = tree_map(lambda t: t.float(), params)
        with f32_storage(torch):
            rel["f32", 200] = decode_vs_prefill(model, p32, toks, 200)
            rel["f32", 256] = decode_vs_prefill(model, p32, toks, 256)
        del p32
    check_flags_inside("15a", seen, card)
    forms = {n: wkv_form(ran, n) for n in (200, 201, 256, 257)}
    line = (f"[15a] decode against prefill, max-norm relative: prefill(200) "
            f"+ one decode step vs prefill(201) (WKV forms {forms[200]}, "
            f"{forms[201]}): bf16 {rel['bf16', 200]:.3e} (tol "
            f"{RWKV_DECODE_RTOL}), with f32 weights and activations "
            f"{rel['f32', 200]:.3e} (tol {RWKV_DECODE_F32_RTOL}: the bf16 "
            f"reading is rounding); prefill(256) ({forms[256]}, the carried "
            f"state past the -60 clamp) + one step vs prefill(257) "
            f"({forms[257]}): bf16 {rel['bf16', 256]:.3e}, f32 "
            f"{rel['f32', 256]:.3e} (printed, not gated: the reference's "
            f"chunked form leaves its scan there); one prefill's ms (B=1): "
            f"40 tokens {prefill_ms[40]:.1f}, 200 {prefill_ms[200]:.1f}, 256 "
            f"{prefill_ms[256]:.1f} [{card}]")
    print(line, flush=True)
    if not (rel["bf16", 200] <= RWKV_DECODE_RTOL
            and rel["f32", 200] <= RWKV_DECODE_F32_RTOL
            and forms[200] == forms[201] == "wkv6_scan"):
        fail(line)
    res.update(decode_vs_prefill={f"{p} {n}": r for (p, n), r in rel.items()},
               prefill_ms=prefill_ms)
    layer = {k: ({n: t[0].clone() for n, t in sub.items()}
                 if isinstance(sub, dict) else sub[0].clone())
             for k, sub in params["layers"].items()}
    del params
    res["phase_s"] = time.perf_counter() - t_phase
    return res, layer


def rwkv_layer_checks(torch, np, dev, spec, card, layer):
    """Phase 15b: rwkv6-7b's layer 0 (time mix, then channel mix, each with
    its residual) forward and backward at B=1, T=RWKV_LAYER_T on the card
    against the port's CPU run of the same code (RWKV_LAYER_ULPS); then
    wkv6_chunked in f32 on the card against wkv6_scan in float64 at
    T=512 (WKV_F64_ATOL at the reference test's decay; printed at the
    model's initial decay)."""
    import repro_torch
    from repro_torch import backend
    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves, tree_map
    t_phase = time.perf_counter()
    cfg = repro_torch.get_config("rwkv6-7b")
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = d // hd
    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((1, RWKV_LAYER_T, d)).astype(np.float32)
    g_np = rng.standard_normal((1, RWKV_LAYER_T, d)).astype(np.float32)

    def run(device):
        lp = tree_map(lambda t: t.detach().to(device).requires_grad_(True),
                      {"tm": layer["tm"], "cm": layer["cm"]})
        x = torch.from_numpy(x_np).to(device).to(torch.bfloat16)
        x.requires_grad_(True)
        wkv0 = torch.zeros((1, h, hd, hd), dtype=torch.float32,
                           device=device)
        shift0 = torch.zeros((1, d), dtype=torch.bfloat16, device=device)
        t0 = time.perf_counter()
        with backend.f32_accumulation():
            a, _, state = T.rwkv_time_mix(lp["tm"], x, shift0, wkv0, cfg,
                                          decode=False)
            y = x + a
            c, _ = T.rwkv_channel_mix(lp["cm"], y, shift0)
            out = y + c
            leaves = [x] + tree_leaves(lp)
            grads = torch.autograd.grad(
                (out.float() * torch.from_numpy(g_np).to(device)).sum(),
                leaves)
        if device != "cpu":
            torch.cuda.synchronize()
        return ([out.detach().cpu(), state.detach().cpu()]
                + [gr.cpu() for gr in grads], time.perf_counter() - t0)

    got, card_s = run(dev)
    want, cpu_s = run("cpu")
    # tree_leaves' order: sorted keys, so cm before tm
    names = ["out", "wkv state", "d x"] + [
        f"d {part}/{n}" for part in ("cm", "tm") for n in sorted(layer[part])]
    ulps = {}
    for name, g, w in zip(names, got, want):
        if not torch.isfinite(g).all():
            fail(f"[15b] {name}: non-finite on the card [{card}]")
        ulps[name] = float((g.float() - w.float()).abs().max()) / \
            ulp_at_max(w)
    worst = max(ulps, key=ulps.get)
    line = (f"[15b] rwkv6-7b layer 0 (time mix + channel mix, residuals) at "
            f"B=1, T={RWKV_LAYER_T}, forward and backward, the card against "
            f"the port's CPU run of the same code: in bf16 ulps at each "
            f"tensor's largest element {({k: round(u, 3) for k, u in ulps.items()})}; "
            f"worst {worst} {ulps[worst]:.3f} (tol {RWKV_LAYER_ULPS}); the "
            f"card {card_s:.2f} s, the CPU {cpu_s:.2f} s [{card}]")
    print(line, flush=True)
    if ulps[worst] > RWKV_LAYER_ULPS:
        fail(line)
    rows = {"layer_ulps": ulps, "layer_worst": [worst, ulps[worst]]}

    # wkv6_chunked (f32, the card) against wkv6_scan (float64, the card)
    b, t = 1, 512
    inputs = {}
    for tag, shift, scale in (("test decay", -1.0, 1.0),
                              ("initial decay", 0.0, 0.02)):
        r, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, hd)))
                   for _ in range(3))
        z = torch.from_numpy(rng.standard_normal((b, t, h, hd)))
        w = torch.exp(-torch.exp(scale * z + shift))
        u = 0.3 * torch.from_numpy(rng.standard_normal((h, hd)))
        s0 = 0.1 * torch.from_numpy(rng.standard_normal((b, h, hd, hd)))
        args = [a.to(dev) for a in (r, k, v, w, u, s0)]
        inputs[tag] = (args, rwkv6.wkv6_scan(*args),
                       f"w = exp(-exp({scale} N {shift:+.0f}))")

    def excess(got, want, keep=None):
        """max(|got - want| - WKV_F64_ATOL |want|) over `keep` (a mask of
        got's leading axes; all when None): the reference test's
        assert_allclose(atol, rtol) holds there where this is <=
        WKV_F64_ATOL."""
        diff = (got.double() - want).abs() - WKV_F64_ATOL * want.abs()
        if keep is not None:
            diff = diff[keep]
        return float(diff.max()) if diff.numel() else float("nan")

    for tag, chunk in WKV_F64_CASES:
        args, (y64, st64), law = inputs[tag]
        a32 = [a.float() for a in args]
        # each (row, chunk, head) whose cumulative log-decay reaches -60 in
        # one of its channels; a head is compared up to its first such
        # chunk (y), and its state only if it has none
        n = t // chunk
        la = torch.cumsum(torch.log(a32[3]).reshape(b, n, chunk, h, hd), 2)
        hit = (la < -60).any(2).any(-1)                      # (B, n, H)
        clamped = float((la[:, :, -1] < -60).float().mean())
        idx = torch.arange(n, device=dev)[None, :, None].expand_as(hit)
        first = torch.where(hit, idx, n).min(1).values       # (B, H)
        keep_y = (torch.arange(t, device=dev)[None, :, None]
                  < first[:, None, :] * chunk)                # (B, T, H)
        keep_s = first == n                                   # (B, H)
        with backend.f32_accumulation():
            y32, st32 = rwkv6.wkv6_chunked(*a32, chunk=chunk)
            ys, sts = rwkv6.wkv6_scan(*a32)
            ms = cuda_ms(lambda: rwkv6.wkv6_chunked(*a32, chunk=chunk),
                         reps=5, warmup=1)
        finite = bool(torch.isfinite(y32).all() and torch.isfinite(st32).all())
        e_y, e_s = excess(y32, y64, keep_y), excess(st32, st64, keep_s)
        share = float(keep_y.float().mean())
        gated = share > 0
        state_gated = bool(keep_s.any())
        line = (f"[15b] wkv6_chunked (f32, chunk {chunk}) vs wkv6_scan "
                f"(float64) at B=1, T={t}, H={h}, D={hd}, {tag} ({law}; "
                f"{clamped:.3%} of channel-chunks reach the -60 clamp): "
                f"before each head's first clamped chunk ({share:.1%} of "
                f"the positions, {int(keep_s.sum())} of {b * h} heads' "
                f"states) the allclose excess y {e_y:.3e}, state {e_s:.3e} "
                f"(tol {WKV_F64_ATOL}; y {'gated' if gated else 'not gated'}, "
                f"state "
                f"{'gated' if state_gated else 'not gated: no head free of the clamp'}); "
                f"every value finite: {finite}; everywhere (printed) y "
                f"{float((y32.double() - y64).abs().max()):.3e} max |diff| "
                f"(max |y| {float(y64.abs().max()):.3f}), state "
                f"{float((st32.double() - st64).abs().max()):.3e}; the f32 "
                f"scan: y {float((ys.double() - y64).abs().max()):.3e}, "
                f"state {float((sts.double() - st64).abs().max()):.3e}; "
                f"wkv6_chunked a call {ms:.3f} ms [{card}]")
        print(line, flush=True)
        rows[f"{tag}/chunk{chunk}"] = {"y_excess": e_y, "state_excess": e_s,
                                       "state_gated": state_gated,
                                       "compared_share": share,
                                       "clamped_share": clamped,
                                       "chunked_ms": ms}
        if not finite or (tag == "test decay" and not (
                share > 0.25 and e_y <= WKV_F64_ATOL
                and (not state_gated or e_s <= WKV_F64_ATOL))):
            fail(line)
    rows["phase_s"] = time.perf_counter() - t_phase
    return rows


def step_batch(torch, dev, cfg, loop, step):
    """The batch Trainer.run() feeds at `step` (the data pipeline's tokens
    and labels, whisper's stub frames or internvl2's stub patches
    attached), on the card."""
    from repro_torch.data.pipeline import (DataConfig, TokenSource,
                                           make_stub_frontend_batch)
    src = TokenSource(DataConfig(seq_len=loop.seq_len,
                                 global_batch=loop.global_batch,
                                 vocab_size=cfg.vocab_size, seed=loop.seed))
    return {k: torch.from_numpy(a).to(dev) for k, a in
            make_stub_frontend_batch(cfg, src.batch_at(step),
                                     loop.seed).items()}


def loss0_terms(torch, model, params, batch):
    """The step-0 loss taken apart on the step's own params and batch,
    with no grad and flash's plain version in the kernel's place (so no
    kernel launch is counted): per labelled position the lse and the
    target's logit (from the xent's own f32 logits), and per row the head
    reads, its mean square; and the head table's mean square."""
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.models import registry
    if not bool((batch["labels"] >= 0).all()):
        fail("step 0's batch has masked labels: loss0_terms averages over "
             "every position")
    got = {"lse": [], "ll": [], "ms": []}
    xent, logits_fn = registry.softmax_xent, registry.lm_logits

    def rec_xent(logits, labels, **kw):
        got["lse"].append(torch.logsumexp(logits, -1).flatten())
        got["ll"].append(torch.gather(logits, -1, labels.long()[..., None])
                         .flatten())
        return xent(logits, labels, **kw)

    def rec_logits(x, table, **kw):
        got["ms"].append(x.float().square().mean(-1).flatten())
        return logits_fn(x, table, **kw)

    registry.softmax_xent, registry.lm_logits = rec_xent, rec_logits
    try:
        with torch.no_grad(), route_flash(plain_in_place(flash_cuda)):
            _, m = model.loss_fn(params, batch)
    finally:
        registry.softmax_xent, registry.lm_logits = xent, logits_fn
    lse, ll, ms = (torch.cat(got[k]).double() for k in ("lse", "ll", "ms"))
    table = params["embed"] if model.cfg.tie_embeddings else params["head"]
    table_ms = sum(float(t.double().square().sum())
                   for t in table.split(4096)) / table.numel()
    return {"positions": lse.numel(), "lse_mean": float(lse.mean()),
            "lse_std": float(lse.std()), "ll_mean": float(ll.mean()),
            "zloss_mean": float(1e-4 * lse.square().mean()),
            "row_ms_mean": float(ms.mean()), "table_ms": table_ms,
            "loss": float(m["loss"])}


def loss0_check(label, cfg, t, loss0_run, card):
    """Step 0's loss taken apart (loss0_terms), against what random
    weights give: the logits of a row y are N(0, s2) with s2 = ms(table) x
    d_model x ms(y), so the mean lse is ln V + s2 / 2 (held to LOSS0_ATOL)
    and the mean target logit is 0 with a standard error sqrt(s2 / N) over
    the batch's N positions (held to LOSS0_SE standard errors); the terms
    add up to the loss the run reported (within LOSS0_SUM_ATOL)."""
    import math
    s2 = t["table_ms"] * cfg.d_model * t["row_ms_mean"]
    lse_want = math.log(cfg.vocab_size) + s2 / 2
    se = math.sqrt(s2 / t["positions"])
    total = t["lse_mean"] - t["ll_mean"] + t["zloss_mean"]
    t.update(s2=s2, lse_expected=lse_want, ll_se=se)
    line = (f"[{label}] {cfg.name}: step 0's loss taken apart over its "
            f"{t['positions']} labelled positions (no grad, flash's plain "
            f"version in place): mean lse {t['lse_mean']:.5f} (std over "
            f"positions {t['lse_std']:.5f}; expected ln V + s2 / 2 = "
            f"{lse_want:.5f}, s2 = ms(table) {t['table_ms']:.4e} x d_model "
            f"{cfg.d_model} x ms(normed row) {t['row_ms_mean']:.5f} = "
            f"{s2:.5f}; tol {LOSS0_ATOL}); mean target logit "
            f"{t['ll_mean']:.5f} (expected 0, standard error sqrt(s2 / N) = "
            f"{se:.5f}: {t['ll_mean'] / se:+.2f} se, tol {LOSS0_SE} se); "
            f"z-loss {t['zloss_mean']:.5f}; lse - target + z-loss = "
            f"{total:.5f} against the run's step-0 loss {loss0_run:.5f} "
            f"(tol {LOSS0_SUM_ATOL}) [{card}]")
    print(line, flush=True)
    if not (abs(t["lse_mean"] - lse_want) <= LOSS0_ATOL
            and abs(t["ll_mean"]) <= LOSS0_SE * se
            and abs(total - loss0_run) <= LOSS0_SUM_ATOL
            and abs(t["loss"] - total) <= 1e-4 * abs(total)):
        fail(line)


def _train_run(torch, dev, spec, card, zero_counts, read_counts, by_path,
               tag, cfg, seq_len, global_batch, watch, label="15c",
               per_step=None, steps=TRAIN_STEPS):
    """One Trainer(...).run() of `steps` steps (cfg.optimizer,
    cfg.remat, no checkpoint written: the save is counted), every step's
    kernel counts equal to per_step (every kernel 0 when None), the
    step-0 loss within LOSS0_ATOL of lse0 + 1e-4 lse0^2 and taken apart
    (loss0_terms, loss0_check). watch: (module, names) whose calls read
    the matmul flags. Returns (metrics, trainer).
    One more step runs with the device traced, on the batch (stub frames
    or patches attached) of step `steps`."""
    import math
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    ckpt_dir = os.path.join(ROOT, "build", f"chip_smoke_{tag}_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps,
                           log_every=1, ckpt_dir=ckpt_dir, seq_len=seq_len,
                           global_batch=global_batch)
    tr = Trainer(cfg, loop, device=dev)
    saves, step_ms, step_counts, terms, grad_norms = [], [], [], {}, []
    real_step = tr.step_fn

    def timed_step(params, opt_state, batch):
        if not terms:           # step 0: its own params and batch
            terms.update(loss0_terms(torch, tr.model, params, batch))
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grad_norms.append(float(out[2]["grad_norm"]))
        after = read_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        return out

    tr.step_fn = timed_step
    tr.ckpt.save = lambda step, tree, **kw: saves.append(step)
    impl = f"ssm_impl {cfg.ssm_impl!r}, " if cfg.family == "hybrid" else ""
    print(f"[{label}] train {cfg.name} at full width, {cfg.n_layers} layers, "
          f"{impl}remat {cfg.remat!r}, "
          f"{cfg.optimizer}: seq_len {seq_len}, global_batch "
          f"{global_batch}, {steps} steps", flush=True)
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    with watch_calls(torch, seen, *watch):
        out = tr.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    by_path[f"{tag}_train"] = read_counts()
    check_flags_inside(label, seen, card)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    lse0 = math.log(cfg.vocab_size) + INIT_SCALE ** 2 * cfg.d_model / 2
    loss0 = lse0 + 1e-4 * lse0 ** 2
    want = {k: 0 for k in by_path[f"{tag}_train"]}
    want.update(per_step or {})
    line = (f"[{label}] {cfg.name}: losses {[round(x, 4) for x in losses]} "
            f"(step 0 expected {loss0:.4f} +- {LOSS0_ATOL}); launches a step "
            f"{step_counts[0]} (expected {want}); saves {saves} [{card}]")
    print(line, flush=True)
    if (len(losses) != steps
            or not all(math.isfinite(x) for x in losses)
            or abs(losses[0] - loss0) > LOSS0_ATOL
            or any(c != want for c in step_counts) or saves != [steps]):
        fail(line)
    loss0_check(label, cfg, terms, losses[0], card)
    steady = sorted(step_ms[1:])
    step_p50 = steady[len(steady) // 2]
    n_params = sum(x.numel() for x in _leaves(tr.state["params"]))
    tokens = seq_len * global_batch
    res = {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
           "step_ms_p50": step_p50,
           "tokens_per_step": tokens, "tok_per_s": tokens / step_p50 * 1e3,
           "n_params": n_params, "peak_mem_gb": peak / 1e9, "run_s": run_s,
           "loss0_expected": loss0, "loss0_terms": terms}
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # where a step's time goes: one more step with the device traced
    batch = step_batch(torch, dev, cfg, loop, steps)
    wall, busy, kernels, _, _, _, n_kernels = profile_window(
        torch, lambda: real_step(tr.state["params"], tr.state["opt"], batch),
        host=False)
    res["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                      "kernels": n_kernels}
    print(f"[{label}] {cfg.name}: one step with the device traced: wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms ({busy / wall:.1%}); "
          f"{n_kernels} kernels; top kernels (ms, calls): {kernels} "
          f"[{card}]", flush=True)
    return res, tr


def ssm_train_phase(torch, dev, spec, card, zero_counts, read_counts,
                    by_path):
    """Phase 15c: Trainer(...).run() on hymba-1.5b at full width cut to
    HYBRID_TRAIN_LAYERS layers (ssm_impl "chunked", HYBRID_TRAIN_SEQ x
    HYBRID_TRAIN_BATCH: the window bites) and on rwkv6-7b at full width cut to RWKV_TRAIN_LAYERS layers
    (RWKV_TRAIN_SEQ x RWKV_TRAIN_BATCH), remat "full", AdamW; then one
    hymba train step with ssm_impl "pallas", which must raise the
    kernel's no-backward error."""
    import dataclasses
    import repro_torch
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.models import mamba, rwkv6
    from repro_torch.train import step as step_lib
    t_phase = time.perf_counter()
    res = {}
    cfg = dataclasses.replace(repro_torch.get_config("hymba-1.5b"),
                              n_layers=HYBRID_TRAIN_LAYERS, remat="full",
                              ssm_impl="chunked")
    hy, tr = _train_run(torch, dev, spec, card, zero_counts, read_counts,
                        by_path, "hybrid", cfg, HYBRID_TRAIN_SEQ,
                        HYBRID_TRAIN_BATCH, (mamba, ("ssm_chunked",)),
                        steps=SSM_TRAIN_STEPS)
    s, w = HYBRID_TRAIN_SEQ, cfg.attn_window
    # attention FLOPs: key t sees min(t + 1, window) keys; x3 for the backward
    keys = sum(min(t + 1, w) for t in range(s))
    attn = 3 * cfg.n_layers * 4.0 * HYBRID_TRAIN_BATCH * cfg.n_heads * keys \
        * cfg.head_dim
    hy["mfu"] = ((6 * hy["n_params"] * hy["tokens_per_step"] + attn)
                 / (hy["step_ms_p50"] / 1e3) / spec.bf16_tc_flops)
    print(f"[15c] hymba-1.5b: step ms {[round(x, 2) for x in hy['step_ms']]} "
          f"(p50 after the first {hy['step_ms_p50']:.2f}); "
          f"{hy['tok_per_s']:.1f} tokens/s; mfu {hy['mfu']:.4f} ((6 N tokens "
          f"+ windowed attention {attn:.3e}: key t sees min(t + 1, {w}) "
          f"keys) / step / {spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, N = "
          f"{hy['n_params']}; the scan's FLOPs not counted); peak device "
          f"memory {hy['peak_mem_gb']:.2f} GB [{card}]", flush=True)

    # one train step with ssm_impl "pallas": the forward launches the scan
    # kernel once a layer and the backward's recompute of the last layer
    # once more, every launch held against ssm_scan_plain on its own
    # inputs; then the backward raises
    pcfg = dataclasses.replace(cfg, ssm_impl="pallas")
    step_fn, _ = step_lib.build_train_step(repro_torch.build_model(pcfg))
    toks = torch.randint(0, cfg.vocab_size, (HYBRID_TRAIN_BATCH, s + 1),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    errs, shapes = [], set()

    def against_plain(args, out):
        errs.append(ssm_errors(out, ssm_cuda.ssm_scan_plain(*args)))
        shapes.add((*args[0].shape, args[4].shape[1]))      # B, T, C, N

    zero_counts()
    with hold_launches(ssm_cuda, "ssm_scan", against_plain):
        try:
            step_fn(tr.state["params"], tr.state["opt"],
                    {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            raised = None
        except NotImplementedError as e:
            raised = str(e)
    torch.cuda.synchronize()
    by_path["hybrid-train-pallas"] = read_counts()
    n_scan = by_path["hybrid-train-pallas"]["ssm_scan"]
    worst_y = max((e[0] for e in errs), default=float("nan"))
    worst_h = max((e[1] for e in errs), default=float("nan"))
    line = (f"[15c] hymba-1.5b, one train step with ssm_impl 'pallas': "
            f"ssm_scan launched {n_scan} times at (B, T, C, N) {shapes} "
            f"({cfg.n_layers + 1} expected: the forward, {cfg.n_layers}, and "
            f"the last layer's recompute), each held against ssm_scan_plain "
            f"on its own inputs: worst y {worst_y:.2e} of max |y|, hT "
            f"{worst_h:.2e} of max |hT| (tol {SSM_RTOL}); then the backward "
            f"raised NotImplementedError: {raised!r} (required) [{card}]")
    print(line, flush=True)
    if (raised is None or "no backward" not in raised
            or n_scan != cfg.n_layers + 1 or len(errs) != n_scan
            or not max(worst_y, worst_h) <= SSM_RTOL):
        fail(line)
    hy["pallas_refusal"] = {"ssm_scan_launches": n_scan, "error": raised,
                            "launch_y_rel_max": worst_y,
                            "launch_h_rel_max": worst_h}
    res["hybrid"] = hy
    del tr, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(repro_torch.get_config("rwkv6-7b"),
                              n_layers=RWKV_TRAIN_LAYERS, remat="full")
    rw, tr = _train_run(torch, dev, spec, card, zero_counts, read_counts,
                        by_path, "rwkv", cfg, RWKV_TRAIN_SEQ,
                        RWKV_TRAIN_BATCH, (rwkv6, WKV_FORMS),
                        steps=SSM_TRAIN_STEPS)
    rw["mfu"] = (6 * rw["n_params"] * rw["tokens_per_step"]
                 / (rw["step_ms_p50"] / 1e3) / spec.bf16_tc_flops)
    print(f"[15c] rwkv6-7b ({RWKV_TRAIN_LAYERS} layers): step ms "
          f"{[round(x, 2) for x in rw['step_ms']]} (p50 after the first "
          f"{rw['step_ms_p50']:.2f}); {rw['tok_per_s']:.1f} tokens/s; mfu "
          f"{rw['mfu']:.4f} (6 N tokens / step / "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, N = {rw['n_params']}; "
          f"no attention term: rwkv has no attention, and the WKV's own "
          f"FLOPs are not counted); peak device memory "
          f"{rw['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    res["rwkv"] = rw
    del tr
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 16: the vlm family served (16a), the encdec family served (16b), and
# both trained (16c)
# ---------------------------------------------------------------------------

def stub_input(torch, dev, gen, shape, dtype):
    """A stub frontend input (whisper's frames, internvl2's patch
    embeddings) of N(0, 1) x INIT_SCALE, drawn on the card from `gen`."""
    return (torch.randn(shape, generator=gen, device=dev)
            * INIT_SCALE).to(dtype)


def vlm_serve_phase(torch, np, dev, spec, card, flash_cuda, zero_counts,
                    read_counts, by_path):
    """Phase 16a: ServeEngine on internvl2-26b at full width and depth,
    flash on, each request's 256 patch embeddings in Request.extra; the
    same requests again (bit-equal outputs), through the paged cache
    (equal outputs); each flash-sized admission again with every flash_fwd
    launch held against its plain version, and its first-token logits
    against the plain version in the kernel's place and against flash off;
    flash_fwd and SDPA at this model's prefill shape."""
    import dataclasses
    import repro_torch
    from repro_torch.kernels import api
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tune import tuner
    t_phase = time.perf_counter()
    base = dataclasses.replace(repro_torch.get_config("internvl2-26b"),
                               n_layers=VLM_SERVE_LAYERS)
    cfg = dataclasses.replace(base, use_flash_attention=True)
    v, n_vis = cfg.vocab_size, cfg.n_vis_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(x.numel() for x in _leaves(params))
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=VLM_CACHE_LEN,
                      device=dev)
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (1, n_vis, cfg.d_model)
    reqs = [Request(rid=i, prompt=rng.integers(0, v, n),
                    max_new_tokens=FAMILY_SERVE_NEW,
                    extra={"vis": stub_input(torch, dev, gen, shape,
                                             torch.bfloat16)})
            for i, n in enumerate(VLM_PROMPTS)]
    reqs.append(Request(rid=len(reqs),
                        prompt=rng.integers(0, v, VLM_HOT_PROMPT),
                        max_new_tokens=FAMILY_SERVE_NEW,
                        temperature=SPEC_HOT_T,
                        extra={"vis": stub_input(torch, dev, gen, shape,
                                                 torch.bfloat16)}))
    # the rows each admission prefills, as the engine builds them: the vis
    # lines, then the text's bucket under the room they leave
    rows = {r.rid: prefill_rows(eng, r) for r in reqs}
    flash_rids = [r.rid for r in reqs if rows[r.rid] % 256 == 0]
    # warm-up: one flash-sized request (cuBLAS handles, the flash pick), the
    # matmul flags read at each flash call inside the engine's work
    seen = []

    def read_flags(run, q, k, v, **kw):
        seen.append(matmul_flags(torch))
        return run(q, k, v, **kw)

    with route_flash(read_flags):
        eng.run([Request(rid=99, prompt=reqs[1].prompt, max_new_tokens=2,
                         extra=reqs[1].extra)])
    torch.cuda.synchronize()
    check_flags_inside("16a", seen, card)
    want = {"flash_fwd": cfg.n_layers * len(flash_rids)}

    def describe(stats):
        return (f"serve internvl2-26b (full width, {cfg.n_layers} layers, "
                f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
                f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {v}; "
                f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s), flash "
                f"on: {stats['requests']} requests (text "
                f"{[len(r.prompt) for r in reqs]} + {n_vis} vis; rows "
                f"prefilled {[rows[r.rid] for r in reqs]}: flash-sized rids "
                f"{flash_rids}, the others chunked), {stats['prefills']} "
                f"prefills, {stats['decode_steps']} decode steps, "
                f"{stats['new_tokens']} tokens (flash_fwd: {cfg.n_layers} x "
                f"{len(flash_rids)})")

    # one admission round (four prompts: chunked and flash routes) and
    # three decode rounds profiled; the paged cache: k/v over the vis and
    # text lines, no prefix reuse
    peng = ServeEngine(cfg, params, max_batch=4, cache_len=VLM_CACHE_LEN,
                       kv_page_size=PAGED_PAGE, device=dev)
    res, first = serve_checked(torch, dev, card, "16a", "vlm", eng, reqs,
                               zero_counts, read_counts, by_path, describe,
                               reqs[:8:2], want=want, paged=peng)
    del peng
    res.update(n_params=n_params, init_s=init_s,
               init_peak_mem_gb=init_peak / 1e9, flash_rids=flash_rids,
               rows=list(rows.values()))
    print(f"[16a] peak device memory at init {init_peak / 1e9:.2f} GB (each "
          f"leaf drawn in f32, then rounded), while serving "
          f"{res['peak_mem_gb']:.2f} GB (peak reset after init) [{card}]",
          flush=True)

    # each flash-sized request prefilled again through the admission path,
    # three ways; at 48 layers the logits are held only to the sanity bound
    # VLM_LOGIT_RTOL, the witness below holds them to SERVE_LOGIT_RTOL
    plain = ServeEngine(base, params, max_batch=4, cache_len=VLM_CACHE_LEN,
                        device=dev)
    flash_reqs = [r for r in reqs if r.rid in flash_rids]
    zero_counts()
    launch_ulps, rows_chk = vlm_routes(torch, flash_cuda, eng, plain,
                                       flash_reqs)
    torch.cuda.synchronize()
    by_path["vlm-serve-check"] = read_counts()
    worst = {i: max(x[i] for x in rows_chk) for i in (1, 2, 3)}
    worst_launch = max(launch_ulps, default=float("inf"))
    served = all(x[4] == first[x[0]][0] or reqs[x[0]].temperature
                 for x in rows_chk)
    line = (f"[16a] {len(launch_ulps)} flash_fwd launches (group "
            f"{cfg.n_heads // cfg.n_kv_heads}: H={cfg.n_heads}, "
            f"KvH={cfg.n_kv_heads}, Hd {cfg.head_dim}) in {len(rows_chk)} "
            f"flash-sized prefills (rows {[rows[r] for r in flash_rids]}) "
            f"held against flash_fwd_plain on their own inputs: worst "
            f"{worst_launch:.2f} bf16 ulps (tol {FLASH_OUT_ULPS}); "
            f"first-token logits at {cfg.n_layers} layers, max |diff| / max "
            f"|logit|, worst: kernel path vs plain version in its place "
            f"{worst[1]:.3e}, kernel path vs flash off (chunked) "
            f"{worst[2]:.3e}, plain version vs chunked (no kernel in either: "
            f"this model's bf16 floor at this depth) {worst[3]:.3e} (sanity "
            f"bound {VLM_LOGIT_RTOL} each); the kernel path's greedy argmax "
            f"= the served first token: {served}; per request (rid, a-b, "
            f"a-c, b-c, argmax, finite): {rows_chk}; launches "
            f"{by_path['vlm-serve-check']} [{card}]")
    print(line, flush=True)
    if (len(launch_ulps) != cfg.n_layers * len(flash_rids)
            or worst_launch > FLASH_OUT_ULPS
            or max(worst.values()) > VLM_LOGIT_RTOL
            or not served or not all(x[5] for x in rows_chk)):
        fail(line)
    res.update(launch_ulps_max=worst_launch,
               logits_rel_vs_plain=worst[1], logits_rel_vs_chunked=worst[2],
               logits_rel_plain_vs_chunked=worst[3])
    del plain, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    res["witness"] = vlm_route_witness(torch, dev, card, flash_cuda, base,
                                       flash_reqs)
    by_path["vlm-witness"] = read_counts()

    # printed only: flash_fwd and SDPA at this model's largest flash prefill
    b_, s_, h, kvh, hd = 1, VLM_OP_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, vv = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                for sh in ((b_, s_, h, hd), (b_, s_, kvh, hd),
                           (b_, s_, kvh, hd)))
    key = api.get_kernel("flash").problem_key(q, k, vv)
    fcfg = tuner.tune_kernel("flash", key, measure_mode=False,
                             device=dev).config
    out, _ = flash_cuda.flash_fwd(q, k, vv, fcfg, True)
    ulps = bf16_ulps(out, flash_cuda.flash_fwd_plain(q, k, vv, fcfg, True)[0])
    dev_ms = graph_ms(lambda: flash_cuda.flash_fwd(q, k, vv, fcfg, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, vv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_dev_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                       enable_gqa=True))
    ops_ms = flash_cuda.useful_flops(b_, h, s_, s_, hd, True) \
        / spec.bf16_tc_flops * 1e3
    bytes_ms = flash_cuda.min_bytes(b_, h, kvh, s_, s_, hd) / spec.hbm_bw * 1e3
    bound = max(ops_ms, bytes_ms)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    res["op_level"] = {"shape": [b_, s_, h, kvh, hd],
                       "blocks": [fcfg.blk_q, fcfg.blk_kv], "ulps": ulps,
                       "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                       "bound_ms": bound, "bound_by": by}
    print(f"[16a] flash_fwd at this model's prefill shape (B={b_}, S={s_}, "
          f"H={h}, KvH={kvh}, Hd={hd}) blocks ({fcfg.blk_q},{fcfg.blk_kv}): "
          f"{ulps:.2f} bf16 ulps from the plain version; device {dev_ms:.4f} "
          f"ms (CUDA graph), SDPA device {lib_dev_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({by}: {ops_ms:.4f} ms of bf16 at "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, {bytes_ms:.4f} ms of "
          f"bytes) [{card}]", flush=True)
    if ulps > FLASH_OUT_ULPS:
        fail(f"[16a] flash_fwd at ({b_}, {s_}, {h}, {kvh}, {hd}): {ulps:.2f} "
             f"ulps")
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def vlm_routes(torch, flash_cuda, eng, chunked, reqs):
    """First-token logits of each request of `reqs` three ways, each
    through its engine's admission path: (a) on the kernel path (`eng`,
    flash on), every flash_fwd launch held against flash_fwd_plain on its
    own inputs; (b) `eng` with the plain version in the kernel's place;
    (c) `chunked` (flash off). Returns (each launch's bf16 ulps, per
    request (rid, a-b, a-c, b-c max-norm relative, a's argmax, a finite))."""
    launch_ulps, out = [], []

    def against_plain(args, got):
        launch_ulps.append(bf16_ulps(got[0],
                                     flash_cuda.flash_fwd_plain(*args)[0]))

    for r in reqs:
        with hold_launches(flash_cuda, "flash_fwd", against_plain):
            a = first_token_logits(eng, r)
        with route_flash(plain_in_place(flash_cuda)):
            b = first_token_logits(eng, r)
        c = first_token_logits(chunked, r)
        out.append((r.rid, round(logit_rel(a, b), 6),
                    round(logit_rel(a, c), 6), round(logit_rel(b, c), 6),
                    int(a.argmax()), bool(torch.isfinite(a).all())))
    return launch_ulps, out


def plain_in_place(flash_cuda):
    """A route_flash stand-in: flash_fwd_plain in the kernel's place."""
    def run_plain(run, q, k, v, **kw):
        return flash_cuda.flash_fwd_plain(q, k, v, flash_blocks(q, k, v, kw),
                                          kw["causal"])[0]
    return run_plain


def vlm_route_witness(torch, dev, card, flash_cuda, base, reqs):
    """16a's witness: internvl2-26b at full width cut to VLM_WITNESS_LAYERS
    layers, seed 0. In bf16, each of `reqs`' first-token logits on the
    kernel path (every flash_fwd launch held to its plain version) against
    the plain version in the kernel's place and against flash off, each
    held to SERVE_LOGIT_RTOL; then with f32 weights and activations
    (f32_storage) the plain version in the kernel's place against flash
    off, held to VLM_F32_RTOL: the distance between the routes is
    rounding."""
    import dataclasses
    import repro_torch
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(base, n_layers=VLM_WITNESS_LAYERS)
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)

    def engines():
        return (ServeEngine(c, params, max_batch=1, cache_len=VLM_CACHE_LEN,
                            device=dev) for c in (fcfg, cfg))

    flash, chunked = engines()
    launch_ulps, rows = vlm_routes(torch, flash_cuda, flash, chunked, reqs)
    worst = {i: max(x[i] for x in rows) for i in (1, 2, 3)}
    params = tree_map(lambda t: t.float(), params)
    f32 = []
    with f32_storage(torch):
        flash, chunked = engines()
        for r in reqs:
            with route_flash(plain_in_place(flash_cuda)):
                b = first_token_logits(flash, r)
            f32.append(round(logit_rel(b, first_token_logits(chunked, r)),
                             9))
    del params, flash, chunked
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launch_ulps_max": max(launch_ulps, default=float("inf")),
           "bf16_kernel_vs_plain": worst[1],
           "bf16_kernel_vs_chunked": worst[2],
           "bf16_plain_vs_chunked": worst[3], "f32_plain_vs_chunked": max(f32)}
    line = (f"[16a] witness at full width cut to {VLM_WITNESS_LAYERS} layers, "
            f"rids {[r.rid for r in reqs]}: {len(launch_ulps)} flash_fwd "
            f"launches, worst {out['launch_ulps_max']:.2f} bf16 ulps from "
            f"the plain version (tol {FLASH_OUT_ULPS}); first-token logits, "
            f"max |diff| / max |logit|, worst, in bf16: kernel path vs plain "
            f"version in its place {worst[1]:.3e}, kernel path vs flash off "
            f"{worst[2]:.3e} (tol {SERVE_LOGIT_RTOL} each), plain version vs "
            f"flash off {worst[3]:.3e} (printed); with f32 weights and "
            f"activations, plain version vs flash off, per request {f32} "
            f"(tol {VLM_F32_RTOL}: the bf16 distance between the routes is "
            f"rounding); bf16 per request (rid, a-b, a-c, b-c, argmax, "
            f"finite): {rows} [{card}]")
    print(line, flush=True)
    if (len(launch_ulps) != VLM_WITNESS_LAYERS * len(reqs)
            or out["launch_ulps_max"] > FLASH_OUT_ULPS
            or max(worst[1], worst[2]) > SERVE_LOGIT_RTOL
            or not all(x[5] for x in rows)
            or not out["f32_plain_vs_chunked"] <= VLM_F32_RTOL):
        fail(line)
    return out


def grow_kv(torch, cache, lines):
    """A prefill cache with `lines` more zero k/v lines (room for decode
    steps past the prompt)."""
    out = dict(cache)
    for key in ("k", "v"):
        pad = torch.zeros_like(cache[key][:, :, :lines])
        out[key] = torch.cat([cache[key], pad], dim=2)
    return out


def whisper_decode_vs_prefill(torch, model, params, toks, frames, n):
    """prefill(toks[:, :n]) then one decode step of toks[:, n], against
    the last logits of prefill(toks[:, :n + 1]), both on `frames`:
    max-norm relative."""
    _, cache = model.prefill(params, {"tokens": toks[:, :n],
                                      "frames": frames})
    got, _ = model.decode_step(params, grow_kv(torch, cache, 1),
                               toks[:, n:n + 1])
    want, _ = model.prefill(params, {"tokens": toks[:, :n + 1],
                                     "frames": frames})
    return logit_rel(got, want)


def whisper_serve_phase(torch, np, dev, card, zero_counts, read_counts,
                        by_path):
    """Phase 16b: ServeEngine on whisper-small at full width and depth
    (12 + 12 layers, 1500 frames), each request's frames in
    Request.extra; the same requests again (bit-equal), through the paged
    cache (equal); an admission's own ms; decode against prefill in bf16
    and with f32 weights and activations."""
    import repro_torch
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    t_phase = time.perf_counter()
    cfg = repro_torch.get_config("whisper-small")
    v = cfg.vocab_size
    model = repro_torch.build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(x.numel() for x in _leaves(params))
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=WHISPER_CACHE_LEN,
                      device=dev)
    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev).manual_seed(6)
    shape = (1, cfg.enc_seq, cfg.d_model)
    reqs = [Request(rid=i, prompt=rng.integers(0, v, n),
                    max_new_tokens=FAMILY_SERVE_NEW,
                    extra={"frames": stub_input(torch, dev, gen, shape,
                                                torch.bfloat16)})
            for i, n in enumerate(WHISPER_PROMPTS)]
    reqs.append(Request(rid=len(reqs),
                        prompt=rng.integers(0, v, WHISPER_HOT_PROMPT),
                        max_new_tokens=FAMILY_SERVE_NEW,
                        temperature=SPEC_HOT_T,
                        extra={"frames": stub_input(torch, dev, gen, shape,
                                                    torch.float32)}))
    eng.run([Request(rid=99, prompt=reqs[0].prompt, max_new_tokens=2,
                     extra=reqs[0].extra)])

    def describe(stats):
        return (f"serve whisper-small (full width, {cfg.n_enc_layers} "
                f"encoder + {cfg.n_layers} decoder layers, d_model "
                f"{cfg.d_model}, {cfg.enc_seq} frames, vocab {v}; "
                f"{n_params / 1e9:.4f}e9 params, init {init_s:.1f} s): "
                f"{stats['requests']} requests (prompts "
                f"{[len(r.prompt) for r in reqs]}; frames bf16, the last "
                f"f32), {stats['prefills']} prefills, "
                f"{stats['decode_steps']} decode steps, "
                f"{stats['new_tokens']} tokens (every kernel 0: the encoder, "
                f"the cross-attention and the decoder run chunked attention, "
                f"as in the reference)")

    # the paged cache: the decoder's k/v paged, xk/xv dense
    peng = ServeEngine(cfg, params, max_batch=4, cache_len=WHISPER_CACHE_LEN,
                       kv_page_size=PAGED_PAGE, device=dev)
    res, _ = serve_checked(torch, dev, card, "16b", "whisper", eng, reqs,
                           zero_counts, read_counts, by_path, describe,
                           reqs[:8:2], paged=peng)
    del peng
    res.update(n_params=n_params, init_s=init_s,
               init_peak_mem_gb=init_peak / 1e9)

    # an admission alone: the encoder over 1500 frames, the decoder's
    # prefill and the slot write (prefill_into_slot), each timed to the end
    adm = []
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first_token_logits(eng, r)
        torch.cuda.synchronize()
        adm.append((time.perf_counter() - t0) * 1e3)
    res["admission_ms"] = adm
    res["admission_ms_p50"] = sorted(adm)[len(adm) // 2]
    print(f"[16b] an admission alone (encoder + decoder prefill + slot "
          f"write), ms per request: {[round(x, 2) for x in adm]}; p50 "
          f"{res['admission_ms_p50']:.2f} [{card}]", flush=True)
    del eng

    # decode against prefill (200 -> 201) on bf16 frames, and with f32
    # weights, activations and frames: the witness that the bf16 distance
    # is rounding
    toks = torch.as_tensor(rng.integers(0, v, (1, WHISPER_DECODE_AT + 1)),
                           device=dev)
    frames = stub_input(torch, dev, gen, shape, torch.float32)
    rel = {"bf16": whisper_decode_vs_prefill(
        torch, model, params, toks, frames.bfloat16(), WHISPER_DECODE_AT)}
    p32 = tree_map(lambda t: t.float(), params)
    with f32_storage(torch):
        rel["f32"] = whisper_decode_vs_prefill(torch, model, p32, toks,
                                               frames, WHISPER_DECODE_AT)
    del p32
    n = WHISPER_DECODE_AT
    line = (f"[16b] decode against prefill, max-norm relative: prefill({n}) "
            f"+ one decode step vs prefill({n + 1}): bf16 "
            f"{rel['bf16']:.3e} (tol {SERVE_LOGIT_RTOL}), with f32 weights, "
            f"activations and frames {rel['f32']:.3e} (tol "
            f"{WHISPER_DECODE_F32_RTOL}) [{card}]")
    print(line, flush=True)
    if not (rel["bf16"] <= SERVE_LOGIT_RTOL
            and rel["f32"] <= WHISPER_DECODE_F32_RTOL):
        fail(line)
    res["decode_vs_prefill"] = rel
    del params
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def encdec_vlm_train_phase(torch, dev, spec, card, flash_cuda, zero_counts,
                           read_counts, by_path):
    """Phase 16c: Trainer(...).run() on whisper-small at full width (AdamW,
    WHISPER_TRAIN_SEQ x WHISPER_TRAIN_BATCH, the stub f32 frames) and on
    internvl2-26b at full width cut to VLM_TRAIN_LAYERS layers (Adafactor,
    flash on, VLM_TRAIN_SEQ x VLM_TRAIN_BATCH: 256 vis + 512 text), remat
    "full", ENCDEC_VLM_TRAIN_STEPS steps, no checkpoint; then one
    internvl2 step with every flash launch held against its plain
    version."""
    import dataclasses
    import repro_torch
    from repro_torch.models import attention
    t_phase = time.perf_counter()
    res = {}
    cfg = dataclasses.replace(repro_torch.get_config("whisper-small"),
                              remat="full")
    wh, tr = _train_run(torch, dev, spec, card, zero_counts, read_counts,
                        by_path, "whisper", cfg, WHISPER_TRAIN_SEQ,
                        WHISPER_TRAIN_BATCH,
                        (attention, ("chunked_causal_attention",)),
                        label="16c", steps=ENCDEC_VLM_TRAIN_STEPS)
    b, s, f = WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, cfg.enc_seq
    params = tr.state["params"]
    n_enc = sum(x.numel() for k in ("enc_layers", "enc_ln", "enc_lnb")
                for x in _leaves({k: params[k]}))
    n_dec = wh["n_params"] - n_enc - params["dec_pos"].numel()
    h, hd = cfg.n_heads, cfg.head_dim
    attn = 3 * (cfg.n_enc_layers * flash_cuda.useful_flops(b, h, f, f, hd,
                                                           False)
                + cfg.n_layers * (flash_cuda.useful_flops(b, h, s, s, hd, True)
                                  + flash_cuda.useful_flops(b, h, s, f, hd,
                                                            False)))
    wh["mfu"] = ((6 * (n_dec * b * s + n_enc * b * f) + attn)
                 / (wh["step_ms_p50"] / 1e3) / spec.bf16_tc_flops)
    wh.update(n_enc_params=n_enc, n_dec_params=n_dec)
    print(f"[16c] whisper-small: step ms {[round(x, 2) for x in wh['step_ms']]}"
          f" (p50 after the first {wh['step_ms_p50']:.2f}); "
          f"{wh['tok_per_s']:.1f} tokens/s; mfu {wh['mfu']:.4f} ((6 (N_dec "
          f"tokens + N_enc frames) + attention {attn:.3e}) / step / "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s: N_dec = {n_dec} (every "
          f"parameter but the encoder's and dec_pos), N_enc = {n_enc}, "
          f"{b * s} tokens and {b * f} frames a step; attention x3 for the "
          f"backward: the encoder's {f} x {f} non-causal, the decoder's "
          f"causal {s} x {s}, the cross-attention's {s} x {f}); peak device "
          f"memory {wh['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    res["whisper"] = wh
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(repro_torch.get_config("internvl2-26b"),
                              n_layers=VLM_TRAIN_LAYERS, remat="full",
                              use_flash_attention=True)
    n_layers = cfg.n_layers
    per_step = dict(flash_fwd=2 * n_layers, flash_bwd_dq=n_layers,
                    flash_bwd_dkv=n_layers)
    vl, tr = _train_run(torch, dev, spec, card, zero_counts, read_counts,
                        by_path, "vlm", cfg, VLM_TRAIN_SEQ, VLM_TRAIN_BATCH,
                        (attention, ("flash_attention",)), label="16c",
                        per_step=per_step, steps=ENCDEC_VLM_TRAIN_STEPS)
    b, s = VLM_TRAIN_BATCH, VLM_TRAIN_SEQ
    attn = 3 * n_layers * flash_cuda.useful_flops(b, cfg.n_heads, s, s,
                                                  cfg.head_dim, True)
    vl["mfu"] = ((6 * vl["n_params"] * b * s + attn)
                 / (vl["step_ms_p50"] / 1e3) / spec.bf16_tc_flops)
    print(f"[16c] internvl2-26b ({n_layers} layers, {cfg.optimizer}): step "
          f"ms {[round(x, 2) for x in vl['step_ms']]} (p50 after the first "
          f"{vl['step_ms_p50']:.2f}); {vl['tok_per_s']:.1f} tokens/s (text "
          f"and vis positions); mfu {vl['mfu']:.4f} ((6 N positions + "
          f"attention {attn:.3e}) / step / {spec.bf16_tc_flops / 1e12:.0f} "
          f"TFLOP/s, N = {vl['n_params']}, {b} x {s} positions a step: "
          f"{cfg.n_vis_tokens} vis + {s - cfg.n_vis_tokens} text a row); "
          f"peak device memory {vl['peak_mem_gb']:.2f} GB [{card}]",
          flush=True)

    # one more step with every flash launch (group 6) held against its
    # plain version on its own inputs, the matmul flags read at each
    batch = step_batch(torch, dev, cfg, tr.loop, ENCDEC_VLM_TRAIN_STEPS)
    plain = {"flash_fwd": lambda *a: flash_cuda.flash_fwd_plain(*a)[0],
             "flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    errs = {name: [] for name in plain}
    seen = []

    def against_plain(name):
        def check(args, got):
            seen.append(matmul_flags(torch))
            want = plain[name](*args)
            if name == "flash_fwd":
                errs[name].append(bf16_ulps(got[0], want))
                return
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    zero_counts()
    with hold_launches(flash_cuda, "flash_fwd", against_plain("flash_fwd")), \
            hold_launches(flash_cuda, "flash_bwd_dq",
                          against_plain("flash_bwd_dq")), \
            hold_launches(flash_cuda, "flash_bwd_dkv",
                          against_plain("flash_bwd_dkv")):
        tr.step_fn(tr.state["params"], tr.state["opt"], batch)
        torch.cuda.synchronize()
    by_path["vlm-train-check"] = read_counts()
    check_flags_inside("16c", seen, card)
    worst = {name: max(e) if e else float("inf") for name, e in errs.items()}
    line = (f"[16c] one checked internvl2 step: launches held against their "
            f"plain versions on their own inputs (group "
            f"{cfg.n_heads // cfg.n_kv_heads}: B={b}, S={s}, H={cfg.n_heads}, "
            f"KvH={cfg.n_kv_heads}, Hd {cfg.head_dim}): "
            f"{ {n: len(e) for n, e in errs.items()} } (expected {per_step}), "
            f"worst {worst} (flash_fwd in bf16 ulps, tol {FLASH_OUT_ULPS}; "
            f"the backward kernels in bf16 ulps at the largest element, tol "
            f"{BWD_ULPS}); launches {by_path['vlm-train-check']} [{card}]")
    print(line, flush=True)
    if (any(len(e) != per_step[n] for n, e in errs.items())
            or worst["flash_fwd"] > FLASH_OUT_ULPS
            or max(worst["flash_bwd_dq"], worst["flash_bwd_dkv"]) > BWD_ULPS):
        fail(line)
    vl["launch_worst_ulps"] = worst
    res["vlm"] = vl
    del tr
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel serving, 2 ranks sharing one card over gloo
# ---------------------------------------------------------------------------

def tp_requests(torch, np, cfg, which, dev):
    """Phase 8's nine prompts (which="dense") or phase 14a's ("moe"), each
    with TP_SERVE_NEW new tokens, or
    17e-17h's five (TP_*_PROMPTS, TP_FAMILY_NEW new tokens; whisper's with
    their f32 frames, internvl2's with their bf16 patch embeddings, drawn
    on `dev` from seed 27); the last at SPEC_HOT_T. The same on every
    rank and in the parent."""
    from repro_torch.serve.engine import Request
    v = cfg.vocab_size
    if which in ("dense", "moe"):
        if which == "dense":
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, v, n) for n in SERVE_PROMPTS]
            hot = rng.integers(0, v, 200)
        else:
            rng = np.random.default_rng(2)
            prompts = [rng.integers(0, v, n) for n in MOE_PROMPTS]
            hot = rng.integers(0, v, MOE_HOT_PROMPT)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=TP_SERVE_NEW)
                for i, p in enumerate(prompts)]
        reqs.append(Request(rid=len(prompts), prompt=hot,
                            max_new_tokens=TP_SERVE_NEW,
                            temperature=SPEC_HOT_T))
        return reqs
    lens = {"hybrid": TP_HYBRID_PROMPTS, "ssm": TP_RWKV_PROMPTS,
            "encdec": TP_WHISPER_PROMPTS, "vlm": TP_VLM_TEXT}[which]
    rng = np.random.default_rng(27)
    gen = torch.Generator(device=dev).manual_seed(27)

    def extra():
        if which == "encdec":
            return {"frames": stub_input(torch, dev, gen, (
                1, cfg.enc_seq, cfg.d_model), torch.float32)}
        if which == "vlm":
            return {"vis": stub_input(torch, dev, gen, (
                1, cfg.n_vis_tokens, cfg.d_model), torch.bfloat16)}
        return None

    return [Request(rid=i, prompt=rng.integers(0, v, n),
                    max_new_tokens=TP_FAMILY_NEW, extra=extra(),
                    temperature=SPEC_HOT_T if i == len(lens) - 1 else 0.0)
            for i, n in enumerate(lens)]


def tp_config(which):
    """17a: qwen2-1.5b cut to TP_DENSE_LAYERS layers; 17b:
    deepseek-moe-16b cut to TP_MOE_LAYERS layers; both at full width with
    flash on. 17e hymba-1.5b cut to TP_HYBRID_SERVE_LAYERS layers with
    the "pallas" scan; 17f rwkv6-7b cut to TP_RWKV_SERVE_LAYERS layers;
    17g whisper-small uncut; 17h
    internvl2-26b at full width cut to TP_VLM_LAYERS layers, flash on."""
    import dataclasses
    import repro_torch
    name, kw = {
        "dense": ("qwen2-1.5b", dict(n_layers=TP_DENSE_LAYERS,
                                     use_flash_attention=True)),
        "moe": ("deepseek-moe-16b", dict(n_layers=TP_MOE_LAYERS,
                                         use_flash_attention=True)),
        "hybrid": ("hymba-1.5b", dict(n_layers=TP_HYBRID_SERVE_LAYERS,
                                      ssm_impl="pallas")),
        "ssm": ("rwkv6-7b", dict(n_layers=TP_RWKV_SERVE_LAYERS)),
        "encdec": ("whisper-small", {}),
        "vlm": ("internvl2-26b", dict(n_layers=TP_VLM_LAYERS,
                                      use_flash_attention=True))}[which]
    return dataclasses.replace(repro_torch.get_config(name), **kw)


def tp_predicted_bytes(cfg):
    """One rank's param and cache bytes at TP_RANKS, predicted from
    serve_specs on the abstract params and cache (no tensor allocated):
    the bytes device_stats must report on every rank."""
    import math
    import repro_torch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import Mesh
    model = repro_torch.build_model(cfg)
    mesh = Mesh({"model": TP_RANKS}, rank=0, device="cpu", backend="gloo")
    specs = sharding.serve_specs(cfg, mesh, max_batch=4, cache_len=1024,
                                 model=model)

    def local_bytes(t, spec):
        return (math.prod(sharding.local_shape(t.shape, spec, mesh))
                * t.element_size())

    spec_of = dict(_spec_items(specs.params))
    params = sum(local_bytes(t, spec_of[path])
                 for path, t in _spec_items(model.abstract_params()))
    ab = model.init_cache(4, 1024, abstract=True)
    cache = 4 * 4 + sum(local_bytes(t, specs.cache[k])
                        for k, t in ab.items() if k != "pos")
    return {"params_bytes": params, "cache_bytes": cache}


def record_logits(eng):
    """Wrap eng's model calls so every call's logits are recorded in call
    order (a digest of their bytes), and every admission's logits whole
    (to print how far they lie apart where digests differ)."""
    import dataclasses
    import hashlib
    rec = {"digests": [], "admit": []}

    def wrap(fn, kind):
        def call(*a, **kw):
            lg, cache = fn(*a, **kw)
            host = lg.float().cpu()
            rec["digests"].append(hashlib.sha1(
                host.numpy().tobytes()).hexdigest())
            if kind == "admit":
                rec["admit"].append(host)
            return lg, cache
        return call

    eng.model = dataclasses.replace(
        eng.model, decode_step=wrap(eng.model.decode_step, "decode"),
        prefill_into_slot=wrap(eng.model.prefill_into_slot, "admit"))
    return rec


def warm_up(eng, reqs):
    """One short request (the first's prompt and extra inputs) through
    the engine: the kernels' first launches and the tune picks."""
    from repro_torch.serve.engine import Request
    eng.run([Request(rid=99, prompt=reqs[0].prompt, max_new_tokens=2,
                     extra=reqs[0].extra)])


@contextlib.contextmanager
def ssm_picks(into):
    """While open, every ssm_scan launch records its (C, blk_c, states)."""
    from repro_torch.kernels.ssm import ssm_cuda

    def note(args, out):
        into.add((args[0].shape[2], args[7].blk_c, args[7].states))

    with hold_launches(ssm_cuda, "ssm_scan", note):
        yield


def tp_reference(torch, np, dev, card, which):
    """The unsharded engine on `which`'s config and requests, in this
    process: tokens and the recorded logits (and, for hymba, each
    ssm_scan launch's channels and config), then (17d, dense only) the
    same requests through a 1-rank mesh. Frees the model before it
    returns."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    cfg = tp_config(which)
    reqs = tp_requests(torch, np, cfg, which, dev)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev)
    warm_up(eng, reqs)
    rec = record_logits(eng)
    picks = set()
    with ssm_picks(picks) if which == "hybrid" else contextlib.nullcontext():
        stats, decode_ms, _ = drive(eng, reqs)
    torch.cuda.synchronize()
    out = {"tokens": {r.rid: list(eng.outputs[r.rid]) for r in reqs},
           "rec": rec, "decode_ms_p50": decode_ms[len(decode_ms) // 2],
           "params_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
           "ssm_picks": sorted(picks)}
    print(f"[{TP_RUNS[which][0]}] unsharded {which} reference ({cfg.name}, "
          f"{cfg.n_layers} layers): {stats['requests']} requests, "
          f"{stats['prefills']} prefills, {stats['decode_steps']} decode "
          f"steps, {len(rec['digests'])} model calls recorded; decode round "
          f"p50 {out['decode_ms_p50']:.2f} ms; params "
          f"{out['params_bytes'] / 1e9:.3f} GB"
          + (f"; ssm_scan (C, blk_c, states) {out['ssm_picks']}"
             if picks else "")
          + f"; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del eng
    if which == "dense":
        # 17d: a 1-rank mesh in this process is the mesh-less engine
        mesh = make_mesh({"model": 1}, device=dev, backend="gloo")
        one = ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                          device=dev, mesh=mesh)
        rec1 = record_logits(one)
        drive(one, reqs)
        ds = one.device_stats()
        same = ({r.rid: list(one.outputs[r.rid]) for r in reqs}
                == out["tokens"] and rec1["digests"] == rec["digests"])
        line = (f"[17d] a 1-rank mesh in this process (backend gloo, no "
                f"collective): tokens and all {len(rec1['digests'])} model "
                f"calls' logits bit-equal to no mesh: {same}; device_stats "
                f"{ds} [{card}]")
        print(line, flush=True)
        if not same or len(ds) != 1 or one.last_stats["devices"] != 1:
            fail(line)
        out["one_rank"] = {"bit_equal": same, "device_stats": ds}
        del one
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
             by_path):
    """Phase 17: tensor-parallel serving over TP_RANKS ranks sharing the
    card (torch.multiprocessing spawn, gloo, a FileStore under build/), each
    rank's results held to the unsharded engine run first in this process,
    every family of TP_RUNS in turn.
    """
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    refs = {w: tp_reference(torch, np, dev, card, w) for w in TP_RUNS}
    ref_s = time.perf_counter() - t0
    predicted = {}
    for which, (tag, _, _) in TP_RUNS.items():
        cfg = tp_config(which)
        predicted[which] = tp_predicted_bytes(cfg)
        print(f"[{tag}] predicted from serve_specs on the abstract params "
              f"({cfg.name}, {cfg.n_layers} layers, {TP_RANKS} ranks, "
              f"max_batch 4, cache_len 1024): a rank holds "
              f"{predicted[which]['params_bytes']} B of params and "
              f"{predicted[which]['cache_bytes']} B of cache [{card}]",
              flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="tp_world_",
                            dir=os.path.join(ROOT, "build"))
    store, out_dir = os.path.join(work, "store"), os.path.join(work, "out")
    os.makedirs(out_dir)
    t1 = time.perf_counter()
    ctx = mp.start_processes(tp_rank_main, args=(TP_RANKS, store, out_dir),
                             nprocs=TP_RANKS, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() - t1 > TP_WORLD_TIMEOUT_S:
                fail(f"[17] the {TP_RANKS}-rank world ran past "
                     f"{TP_WORLD_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        fail(f"[17] a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"[17] a rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    world_s = time.perf_counter() - t1
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(TP_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    res = {"world_s": world_s, "reference_s": ref_s}
    for which, (tag, path, kernel) in TP_RUNS.items():
        res[which] = tp_gates(torch, card, tag, which, refs[which],
                              [r[which] for r in ranks], predicted[which])
        # the ranks' launches summed; every kernel but the held one is 0
        counts = {k: sum(r[which]["launches"][k] for r in ranks)
                  for k in read_counts()}
        by_path[path] = counts
        if any(n for k, n in counts.items() if k != kernel):
            fail(f"[{tag}] launches {counts}: only {kernel} runs here")
    res["one_rank"] = refs["dense"]["one_rank"]
    dec = [r["decode"] for r in ranks]
    line = (f"[17c] flash_decode_sharded (B={TP_DECODE['b']}, "
            f"H={TP_DECODE['h']}, KvH={TP_DECODE['kvh']}, "
            f"Hd={TP_DECODE['hd']}, L={TP_DECODE['l']} split over "
            f"{TP_RANKS} ranks, cache_len {TP_DECODE['clen']}) against "
            f"decode_attention on the whole cache: max |diff| "
            f"{[round(d['err'], 6) for d in dec]} (tol {TP_DECODE_ATOL}); "
            f"the ranks' outputs bit-equal: "
            f"{all(d['digest'] == dec[0]['digest'] for d in dec)}; a call "
            f"{[round(d['ms'], 3) for d in dec]} ms with its three gloo "
            f"all_reduces, the whole-cache plain call "
            f"{[round(d['plain_ms'], 3) for d in dec]} ms (2 ranks sharing "
            f"one card: not a TP speed) [{card}]")
    print(line, flush=True)
    if (max(d["err"] for d in dec) > TP_DECODE_ATOL
            or any(d["digest"] != dec[0]["digest"] for d in dec)):
        fail(line)
    res["decode"] = dec
    res["phase_s"] = time.perf_counter() - t0
    per = {w: round(ranks[0][w]["seconds"], 1) for w in TP_RUNS}
    print(f"[17] phase 17 ran {res['phase_s']:.1f} s (the unsharded "
          f"references {ref_s:.1f} s, the {TP_RANKS}-rank world "
          f"{world_s:.1f} s; rank 0's seconds a family {per}) [{card}]",
          flush=True)
    return res


def tp_gates(torch, card, tag, which, ref, ranks, predicted):
    """17a/b/e/f/g/h's gates on every rank's results: tokens equal across
    ranks and to the unsharded engine's, every model call's logits
    bit-equal (their digests), every rank-local launch of the family's
    kernel held against its plain version (flash_fwd within
    FLASH_OUT_ULPS, ssm_scan within SSM_RTOL) and their exact count, and
    device_stats' bytes a rank equal to the specs' prediction; hymba's
    scans on a rank's half of the channels with the unsharded scans'
    states a thread. Printed with the shard bytes, gathers and launches a
    decode round and round ms."""
    first = ranks[0]
    kernel = TP_RUNS[which][2]
    same_tokens = all(r["tokens"] == ref["tokens"] for r in ranks)
    same_logits = all(r["rec"]["digests"] == ref["rec"]["digests"]
                      for r in ranks)
    diffs = []
    if not same_logits:
        for r in ranks:
            d = [i for i, (a, b) in enumerate(zip(r["rec"]["digests"],
                                                  ref["rec"]["digests"]))
                 if a != b]
            adm = [float((a - b).abs().max()) for a, b in
                   zip(r["rec"]["admit"], ref["rec"]["admit"])]
            diffs.append({"calls_differ": len(d), "first_call": d[:1],
                          "admit_max_abs": max(adm) if adm else None})
    want = first["want_launches"]
    errs = [max(r["held"]) if r["held"] else (0.0 if want == 0
                                               else float("inf"))
            for r in ranks]
    n_held = [len(r["held"]) for r in ranks]
    n_launch = [r["launches"][kernel] if kernel else 0 for r in ranks]
    tol = {"flash_fwd": FLASH_OUT_ULPS, "ssm_scan": SSM_RTOL, None: 0.0}[
        kernel]
    unit = {"flash_fwd": "bf16 ulps", "ssm_scan": "of max |y| or |hT|",
            None: ""}[kernel]
    byte_ok = all(d["params_bytes"] == predicted["params_bytes"]
                  and d["cache_bytes"] == predicted["cache_bytes"]
                  for d in first["device_stats"])
    picks_ok = True
    held = "no kernel (every launch count 0)"
    if kernel:
        held = (f"rank-local {kernel} launches {n_launch} (expected {want} "
                f"each: {first['kernel_shape']}), {n_held} held against "
                f"{kernel}_plain, worst {errs} {unit} (tol {tol})")
    if which == "hybrid":
        half = {p for r in ranks for p in r["ssm_picks"]}
        whole = set(ref["ssm_picks"])
        picks_ok = (all(c * TP_RANKS == w for c, _, _ in half
                        for w, _, _ in whole)
                    and {s for _, _, s in half} == {s for _, _, s in whole})
        held += (f"; (C, blk_c, states) a rank {sorted(half)} against the "
                 f"unsharded {sorted(whole)}: states the same "
                 f"{picks_ok}")
    line = (f"[{tag}] {first['name']} ({first['layers']} layers) over "
            f"{len(ranks)} ranks (mesh model={len(ranks)}, gloo, one card): "
            f"tokens equal across ranks and to the unsharded engine: "
            f"{same_tokens}; all {len(ref['rec']['digests'])} model calls' "
            f"logits bit-equal: {same_logits} {diffs}; {held}; device_stats "
            f"bytes a rank equal to the prediction: {byte_ok} [{card}]")
    print(line, flush=True)
    if (not same_tokens or not same_logits or not byte_ok or not picks_ok
            or any(n != want for n in n_launch)
            or any(n != want for n in n_held) or max(errs) > tol):
        fail(line)
    pb = [r["params_bytes"] for r in ranks]
    lpr = [r["launches_per_round"] for r in ranks]
    peak = [r["peak_bytes"] for r in ranks]
    cols = first["column_products"]
    wide = [f"{m}x{k}->{n} of {w} {dt}" for m, k, n, w, dt, need in cols
            if need]
    print(f"[{tag}] params a rank {[round(b / 1e9, 3) for b in pb]} GB "
          f"against {first['whole_bytes'] / 1e9:.3f} GB whole "
          f"({pb[0] / first['whole_bytes']:.1%}); {first['sharded_leaves']} "
          f"sharded leaves {first['sharded']}; cache a rank "
          f"{first['device_stats'][0]['cache_bytes'] / 1e9:.3f} GB; "
          f"device_stats {first['device_stats']}; a decode round: "
          f"{first['gathers_per_round']} gathers, "
          f"{first['gather_bytes_per_round'] / 1e6:.3f} MB gathered (whole "
          f"tensors)"
          + (f", {lpr} launches a rank (cudaLaunchKernel)" if lpr[0] else "")
          + f"; peak a rank while serving {[round(b / 1e9, 3) for b in peak]}"
          f" GB; column-parallel product shapes at the whole width "
          f"{len(wide)} of {len(cols)} {wide}; decode round p50 "
          f"{[round(r['decode_ms_p50'], 2) for r in ranks]} ms against the "
          f"unsharded {ref['decode_ms_p50']:.2f} ms (2 ranks sharing one "
          f"card: not a TP speed) [{card}]", flush=True)
    return {k: first[k] for k in (
        "params_bytes", "whole_bytes", "sharded_leaves",
        "gathers_per_round", "gather_bytes_per_round")} | {
        "params_bytes_by_rank": pb, "predicted": predicted,
        "kernel": kernel, "kernel_launches": n_launch,
        "kernel_worst": max(errs),
        "launches_per_round": lpr, "peak_bytes": peak,
        "column_products": cols,
        "decode_ms_p50": [r["decode_ms_p50"] for r in ranks],
        "unsharded_decode_ms_p50": ref["decode_ms_p50"],
        "tokens_equal": same_tokens, "logits_bit_equal": same_logits,
        "seconds_by_rank": [r["seconds"] for r in ranks]}


def tp_rank_main(rank, n, store, out_dir):
    """One rank of phase 17's world: its mesh over gloo on the one card,
    every family's sharded serving in turn (TP_RUNS) and 17c's sharded
    decode; results to out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh({"model": n}, device="cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    res = {}
    for w in TP_RUNS:
        res[w] = tp_serve_rank(torch, mesh, w)
        gc.collect()
        torch.cuda.empty_cache()
    res["decode"] = tp_decode_rank(torch, mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def tp_serve_rank(torch, mesh, which):
    """One family on one rank: the whole params from seed 0, the sharded
    engine, a warm-up, then the requests with every launch of the
    family's kernel held against its plain version and every model
    call's logits recorded; a decode round's gathers; for dense and moe
    an admission and three decode rounds under the profiler."""
    import numpy as np
    import repro_torch
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.models import layers
    from repro_torch.serve.engine import Request, ServeEngine
    t0 = time.perf_counter()
    cfg = tp_config(which)
    dev = mesh.device
    reqs = tp_requests(torch, np, cfg, which, dev)
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    whole = sum(t.numel() * t.element_size() for t in _leaves(params))
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev,
                      mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    seen = layers.whole_width_picks()
    warm_up(eng, reqs)
    rec = record_logits(eng)
    held, shapes, picks = [], set(), set()
    kernel = TP_RUNS[which][2]

    def flash_plain(args, got):
        held.append(bf16_ulps(got[0], flash_cuda.flash_fwd_plain(*args)[0]))
        q, k = args[0], args[1]
        shapes.add(f"B={q.shape[0]}, H={q.shape[2]}, KvH={k.shape[2]}, "
                   f"Hd={q.shape[3]}")

    def ssm_plain(args, got):
        held.append(max(ssm_errors(got, ssm_cuda.ssm_scan_plain(*args))[:2]))
        x, cfg_ = args[0], args[7]
        shapes.add(f"B={x.shape[0]}, C={x.shape[2]}, N={args[4].shape[1]}")
        picks.add((x.shape[2], cfg_.blk_c, cfg_.states))

    hold = {"flash_fwd": lambda: hold_launches(flash_cuda, "flash_fwd",
                                               flash_plain),
            "ssm_scan": lambda: hold_launches(ssm_cuda, "ssm_scan",
                                              ssm_plain),
            None: contextlib.nullcontext}[kernel]
    counters = kernel_counters()
    for f in counters:
        f.launches = 0
    with hold():
        stats, decode_ms, _ = drive(eng, reqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {f.__name__: f.launches for f in counters}
    # the column-parallel product shapes this family met, each with whether
    # its block runs inside the whole width's product (layers._column_product)
    cols = sorted((math.prod(k[0][:-1]), k[0][-1], k[1][-1], k[2],
                   str(k[5]).replace("torch.", ""), need)
                  for k, need in layers.whole_width_picks().items()
                  if k not in seen)
    tokens = {r.rid: list(eng.outputs[r.rid]) for r in reqs}
    rec = {k: v[:] for k, v in rec.items()}
    if which == "moe":
        want = cfg.n_layers * sum(len(r.prompt) % 256 == 0 for r in reqs)
    elif which == "vlm":
        # the flash route: vis lines + the text's bucket a multiple of 256
        want = cfg.n_layers * sum(
            (cfg.n_vis_tokens + eng.prefill_batch(r)["tokens"].shape[1])
            % 256 == 0 for r in reqs)
    elif kernel:
        # every admission launches it once a layer (dense: each prompt
        # buckets to 256 or 512; hybrid: every prefill scans)
        want = cfg.n_layers * len(reqs)
    else:
        want = 0
    # one decode round's gathers: four admissions, then a decode round
    eng.reset()
    for r in reqs[:4]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=4,
                           extra=r.extra))
    eng.step()
    layers.reset_tp_counts()
    eng.step()
    tp = layers.tp_counts()
    lpr = 0
    if which in ("dense", "moe"):
        prof = {}
        profile_rounds(torch, f"17 {which} rank {mesh.rank}", eng,
                       reqs[1:8:2], prof, f"rank {mesh.rank} of {mesh.size}")
        lpr = prof["profile_decode"]["cuda_launch_kernel"] / 3
    torch.cuda.synchronize()
    split = sorted(p for p, s in _spec_items(eng._specs.params)
                   if any(e is not None for e in s))
    ds = eng.device_stats()           # a collective: every rank calls it
    return {"name": cfg.name, "layers": cfg.n_layers, "tokens": tokens,
            "rec": rec, "launches": launches, "want_launches": want,
            "held": held, "kernel_shape": sorted(shapes),
            "ssm_picks": sorted(picks),
            "params_bytes": ds[mesh.rank]["params_bytes"],
            "device_stats": ds, "whole_bytes": whole,
            "sharded_leaves": len(split),
            "sharded": sorted({p.split("/")[-1] for p in split}),
            "gathers_per_round": tp["gathers"],
            "gather_bytes_per_round": tp["bytes"],
            "launches_per_round": lpr, "peak_bytes": peak,
            "column_products": cols,
            "decode_ms_p50": decode_ms[len(decode_ms) // 2],
            "stats": {k: stats[k] for k in ("requests", "prefills",
                                            "decode_steps", "new_tokens")},
            "seconds": time.perf_counter() - t0}


def _spec_items(tree, pre=""):
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            yield from _spec_items(v, path)
        else:
            yield path, v


def tp_decode_rank(torch, mesh):
    """17c on one rank: flash_decode_sharded at qwen2's decode shape, the
    cache's seq dim split over the ranks (this rank's block cut from the
    whole cache, drawn alike on every rank), against decode_attention on
    the whole cache; a call's ms each way."""
    import hashlib
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models.attention import (decode_attention,
                                              flash_decode_sharded)
    from repro_torch.models.layers import DistCtx
    c = TP_DECODE
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn(c["b"], 1, c["h"], c["hd"], generator=gen,
                    device=dev).bfloat16()
    k, v = (torch.randn(c["b"], c["l"], c["kvh"], c["hd"], generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    spec = (None, "model", None, None)
    kl, vl = (local_shard(t, spec, mesh).contiguous() for t in (k, v))
    ctx = DistCtx(mesh=mesh, kv_seq_shard=True)

    def sharded():
        return flash_decode_sharded(q, kl, vl, c["clen"], ctx=ctx)

    got = sharded()
    want = decode_attention(q, k, v, c["clen"])
    torch.cuda.synchronize()
    return {"err": float((got.float() - want.float()).abs().max()),
            "digest": hashlib.sha1(got.float().cpu().numpy().tobytes()
                                   ).hexdigest(),
            "ms": cuda_ms(sharded, reps=10),
            "plain_ms": cuda_ms(lambda: decode_attention(q, k, v, c["clen"]),
                                reps=10)}


# ---------------------------------------------------------------------------
# phase 18: data-parallel training, 2 ranks sharing one card over gloo
# ---------------------------------------------------------------------------

def dp_config(which):
    """18a/18b: qwen2-1.5b at full width cut to DP_QWEN_LAYERS layers,
    flash on (phase 10's model, cut); 18c: deepseek-moe-16b at full width
    cut to MOE_TRAIN_LAYERS layers, remat "full", flash on (phase
    14c's)."""
    import dataclasses
    import repro_torch
    if which == "ep":
        return dataclasses.replace(repro_torch.get_config("deepseek-moe-16b"),
                                   n_layers=MOE_TRAIN_LAYERS, remat="full",
                                   use_flash_attention=True)
    return dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                               n_layers=DP_QWEN_LAYERS,
                               use_flash_attention=True)


def one_device_run(torch, dev, card, tag, cfg, steps, label, **loop_kw):
    """cfg trained on one device by Trainer(...).run() for `steps` steps
    of a TrainLoopConfig(**loop_kw) (no checkpoint kept): its losses,
    grad norms and step ms."""
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(ROOT, "build", f"chip_smoke_{tag}_ref_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps, log_every=1,
                           ckpt_dir=ckpt_dir, **loop_kw)
    tr = Trainer(cfg, loop, device=dev)
    grad_norms, step_ms, real_step = [], [], tr.step_fn

    def step(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(params, opt_state, batch)
        grad_norms.append(float(out[2]["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr.step_fn = step
    tr.save = lambda step, state: None
    losses = [float(x) for x in tr.run()["losses"]]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] the one-device reference ({cfg.name}, {cfg.n_layers} "
          f"layers, {steps} steps of {label}): losses "
          f"{[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 5) for x in grad_norms]}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms}


def dp_reference(torch, dev, card):
    """18a/18b's reference: dp_config("dp") trained on one device with
    phase 10's loop for DP_TRAIN_STEPS steps."""
    return one_device_run(torch, dev, card, "18", dp_config("dp"),
                          DP_TRAIN_STEPS, "phase 10's loop")


def tp_hybrid_reference(torch, dev, card):
    """19c's reference: tp_train_config("tp_hybrid") trained on one device
    with 15c's loop for TP_TRAIN_STEPS steps."""
    seq, batch = tp_train_loop("tp_hybrid")
    return one_device_run(torch, dev, card, "19c",
                          tp_train_config("tp_hybrid"), TP_TRAIN_STEPS,
                          "15c's loop", seq_len=seq, global_batch=batch)


def dp_state_bytes(cfg, fsdp, shape=None):
    """(params plus optimizer state on one rank, the same whole) in bytes
    under the training plan over `shape` ({"data": DP_RANKS} by default):
    from the spec trees and the abstract (meta) trees, no tensor made."""
    from types import SimpleNamespace
    from repro_torch.dist import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adafactor import make_optimizer
    from repro_torch.train import step as step_lib
    shape = shape or {"data": DP_RANKS}
    mesh = SimpleNamespace(shape=shape, coords={a: 0 for a in shape})
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=fsdp)
    ab = model.abstract_params()
    ps = sharding.params_shardings(plan, model.param_axes, ab)
    st = make_optimizer(cfg.optimizer, lambda s: s).init(ab)
    trees = ((ab, ps), (st, sharding.opt_state_specs(ps, st)))
    local = whole = 0
    for tree, specs in trees:
        spec = dict(_spec_items(specs))
        for path, t in _spec_items(tree):
            n = 1
            for d in sharding.local_shape(tuple(t.shape), spec[path], mesh):
                n *= d
            local += n * t.element_size()
            whole += t.numel() * t.element_size()
    return local, whole


def fingerprint(torch, tree):
    """An exact fingerprint of a tree's bits, on its device: per leaf the
    int64 sum of its 16-bit words times fixed pseudo-random weights (a
    change of any word changes it), summed over the leaves in sorted
    order (0 for an empty tree). One read of the tree; one host sync."""
    acc = None
    for _, t in sorted(_spec_items(tree)):
        words = t.detach().contiguous().reshape(-1).view(torch.int16)
        for c0 in range(0, words.numel(), 1 << 24):
            w = words[c0:c0 + (1 << 24)].to(torch.int64)
            idx = torch.arange(c0, c0 + w.numel(), device=w.device)
            part = (w * ((idx * 2654435761 + 12345) % 65521 + 1)).sum()
            acc = part if acc is None else acc + part
    return 0 if acc is None else int(acc)


def dp_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
             by_path, moe_train, ssm_train, ev_train):
    """Phases 18 and 19 in one world of DP_RANKS ranks sharing the card
    (torch.multiprocessing spawn, gloo, a FileStore under build/). 18,
    data-parallel training over {"data": DP_RANKS}: 18a DP and 18b FSDP
    on qwen2-1.5b cut to DP_QWEN_LAYERS layers with phase 10's loop, 18c
    EP on deepseek-moe-16b cut as 14c, 18d allreduce_int8 and
    pipelined_apply (forward and gradient); every rank's results held
    here, to the same model's one-device run (18a, 18b; run here first) or
    14c's (18c) and to each other, and 18b's final checkpoint restored on
    one device (elastic 2 -> 1). 19, tensor-parallel training over a
    second mesh {"model": DP_RANKS} of the same ranks: 19a qwen2-1.5b
    (18a's model and batches, held to 18a's one-device run), 19b
    deepseek-moe-16b (14c's, held to 14c's run), 19c hymba-1.5b cut to
    TP_HYBRID_LAYERS layers (held to its own one-device run, here before
    the world), 19d rwkv6-7b (15c's, held to 15c's run), 19e
    whisper-small and 19f internvl2-26b (16c's, held to 16c's runs), each
    rank's state bytes, flash launches and model-axis collectives a step
    predicted here before the world starts. Returns (phase 18's results,
    phase 19's)."""
    import math
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.launch.predict import tp_collectives
    t0 = time.perf_counter()
    ref = dp_reference(torch, dev, card)
    t19 = time.perf_counter()
    hybrid_ref = tp_hybrid_reference(torch, dev, card)
    ref19_s = time.perf_counter() - t19
    pred = {w: dp_state_bytes(dp_config(w), w == "fsdp")
            for w in ("dp", "fsdp", "ep")}
    print(f"[18] params plus optimizer state a rank (predicted from the "
          f"specs, {DP_RANKS} data ranks): 18a DP "
          f"{pred['dp'][0] / 1e9:.3f} GB, 18b FSDP {pred['fsdp'][0] / 1e9:.3f}"
          f" GB, 18c EP {pred['ep'][0] / 1e9:.3f} GB (whole "
          f"{pred['ep'][1] / 1e9:.3f} GB) [{card}]", flush=True)
    t19 = time.perf_counter()
    tp_pred = {}
    for which, (tag, _) in TP_TRAIN_RUNS.items():
        cfg = tp_train_config(which)
        seq, batch = tp_train_loop(which)
        tp_pred[which] = {
            "state": dp_state_bytes(cfg, False, {"model": DP_RANKS})[0],
            "collectives": tp_collectives(cfg, seq, batch, DP_RANKS),
            "flash": tp_flash_per_step(cfg)}
        p = tp_pred[which]
        print(f"[{tag}] predicted for {cfg.name} ({cfg.n_layers} layers) "
              f"over {{'model': {DP_RANKS}}}, from the specs and shapes: "
              f"params plus optimizer state a rank {p['state'] / 1e9:.3f} GB;"
              f" flash launches a step a rank {p['flash']}; model-axis "
              f"collectives a step a rank (remat's recompute included) "
              f"{p['collectives'][0]} calls, {p['collectives'][1]} bytes "
              f"[{card}]", flush=True)
    pred19_s = time.perf_counter() - t19 + ref19_s
    for which in ("dp", "fsdp", "ep"):
        shutil.rmtree(os.path.join(ROOT, "build", f"chip_smoke_{which}_ckpt"),
                      ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dp_world_",
                            dir=os.path.join(ROOT, "build"))
    store, out_dir = os.path.join(work, "store"), os.path.join(work, "out")
    os.makedirs(out_dir)
    t1 = time.perf_counter()
    ctx = mp.start_processes(dp_rank_main, args=(DP_RANKS, store, out_dir),
                             nprocs=DP_RANKS, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() - t1 > DP_WORLD_TIMEOUT_S:
                fail(f"[18] the {DP_RANKS}-rank world ran past "
                     f"{DP_WORLD_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        fail(f"[18] a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"[18] a rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    world_s = time.perf_counter() - t1
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    res = {"world_s": world_s, "predicted_state_gb": {
        w: pred[w][0] / 1e9 for w in pred}}
    for tag, which, path in (("18a", "dp", "dp_train"),
                             ("18b", "fsdp", "fsdp_train"),
                             ("18c", "ep", "ep_train")):
        runs = [r[which] for r in ranks]
        by_path[path] = {k: sum(r["launches"][k] for r in runs)
                         for k in read_counts()}
        res[which] = dp_gates(tag, which, runs, pred[which][0], ref,
                              moe_train, card)
    # 18b: the world's final checkpoint on one device (elastic 2 -> 1)
    res["fsdp"]["restore"] = dp_restore_one(
        torch, dev, card, ranks[0]["fsdp"]["final_fingerprint"])
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke_fsdp_ckpt"),
                  ignore_errors=True)
    # 18d
    ops = [r["ops"] for r in ranks]
    line = (f"[18d] allreduce_int8 of one qwen2 leaf's per-rank grads "
            f"({ops[0]['int8_leaf']}, {ops[0]['int8_numel']} elements) on "
            f"the card against the same call on the ranks' CPU copies: "
            f"bit-equal {[o['int8_bit_equal'] for o in ops]}, its distance "
            f"from the exact f32 mean {[o['int8_err'] for o in ops]} (scale "
            f"{ops[0]['int8_scale']:.3e}); values apart card vs host, op by "
            f"op, under the parent's m / 127.0 and the true division: "
            f"{[o['int8_ops_apart'] for o in ops]}; pipelined_apply over the "
            f"{DP_RANKS} ranks ({ops[0]['pipe_shape']}) against the dense "
            f"scan: max |diff| {[o['pipe_err'] for o in ops]} (tol "
            f"{PIPE_ATOL}), the ranks' outputs equal "
            f"{ops[0]['pipe_digest'] == ops[1]['pipe_digest']}; its gradient "
            f"of sum(out * cot) (the rank's stage, the stream) against "
            f"autograd through the dense loop: max |diff| "
            f"{[o['pipe_grad_err'] for o in ops]} (tol {PIPE_ATOL}) [{card}]")
    print(line, flush=True)
    if (not all(o["int8_bit_equal"] for o in ops)
            or any(any(o["int8_ops_apart"]["true_division"].values())
                   for o in ops)
            or max(o["pipe_err"] for o in ops) > PIPE_ATOL
            or max(o["pipe_grad_err"] for o in ops) > PIPE_ATOL
            or any(o["pipe_digest"] != ops[0]["pipe_digest"] for o in ops)):
        fail(line)
    res["ops"] = ops[0]
    # 19
    t19 = time.perf_counter()
    tp = {"predicted": tp_pred, "hybrid_reference": hybrid_ref}
    refs = {"tp_dense": ref,
            "tp_moe": {"losses": moe_train["losses"],
                       "grad_norms": moe_train["grad_norm"],
                       "step_ms": moe_train["step_ms"]},
            "tp_hybrid": hybrid_ref, "tp_ssm": ssm_train["rwkv"],
            "tp_encdec": ev_train["whisper"], "tp_vlm": ev_train["vlm"]}
    for which, (tag, path) in TP_TRAIN_RUNS.items():
        runs = [r[which] for r in ranks]
        by_path[path] = {k: sum(r["launches"][k] for r in runs)
                         for k in read_counts()}
        tp[which] = tp_train_gates(tag, which, runs, tp_pred[which],
                                   refs[which], card)
    in_world = sum(ranks[0][w]["sub_s"] for w in TP_TRAIN_RUNS)
    tp["phase_s"] = pred19_s + in_world + time.perf_counter() - t19
    res["phase_s"] = time.perf_counter() - t0 - tp["phase_s"]
    print(f"[18] phase 18 ran {res['phase_s']:.1f} s (the {DP_RANKS}-rank "
          f"world {world_s - in_world:.1f} s of its {world_s:.1f} s: 18a "
          f"{ranks[0]['dp']['sub_s']:.1f} s, 18b "
          f"{ranks[0]['fsdp']['sub_s']:.1f} s, 18c "
          f"{ranks[0]['ep']['sub_s']:.1f} s) [{card}]", flush=True)
    subs = ", ".join(f"{tag} {ranks[0][w]['sub_s']:.1f} s"
                     for w, (tag, _) in TP_TRAIN_RUNS.items())
    print(f"[19] phase 19 ran {tp['phase_s']:.1f} s (19c's one-device run "
          f"{ref19_s:.1f} s; in the world: {subs}) [{card}]", flush=True)
    return res, tp


def dp_gates(tag, which, runs, predicted, train, moe_train, card):
    """18a/18b/18c's gates on every rank's results."""
    import math
    first = runs[0]
    cfg = dp_config(which)
    n_layers = cfg.n_layers
    per_step = {k: 0 for k in first["launches"]}
    per_step.update(flash_fwd=2 * n_layers, flash_bwd_dq=n_layers,
                    flash_bwd_dkv=n_layers)
    losses = [r["losses"] for r in runs]
    same = all(r["prints"] == first["prints"] for r in runs)
    counts_ok = all(c == per_step for r in runs for c in r["step_counts"])
    state = [r["state_bytes"] for r in runs]
    line = (f"[{tag}] {cfg.name} ({n_layers} layers, {cfg.optimizer}) over "
            f"{len(runs)} data ranks (gloo, one card, {which}): losses "
            f"{[[round(x, 5) for x in l] for l in losses]}; grad norms "
            f"{[round(x, 5) for x in first['grad_norms']]}; the "
            f"replicated leaves' fingerprints after every step equal on the "
            f"ranks: {same}; launches a step a rank {first['step_counts'][0]}"
            f" (expected {per_step}: {counts_ok}); params plus optimizer "
            f"state a rank {[round(b / 1e9, 3) for b in state]} GB "
            f"(predicted {predicted / 1e9:.3f}) [{card}]")
    print(line, flush=True)
    bad = (not same or not counts_ok or any(b != predicted for b in state)
           or any(l != losses[0] for l in losses)
           or not all(math.isfinite(x) for x in losses[0]))
    if which == "ep":
        lse0 = math.log(cfg.vocab_size) + INIT_SCALE ** 2 * cfg.d_model / 2
        loss0 = lse0 + 1e-4 * lse0 ** 2
        n_moe = n_layers - cfg.first_k_dense
        routes = [r["routes"] for r in runs]
        ep = first["ep_check"]
        line = (f"[18c] step 0's loss {losses[0][0]:.5f} (estimate "
                f"{loss0:.5f} +- {MOE_LOSS0_ATOL}; 14c's one-device run on "
                f"the same batches "
                f"{[round(x, 5) for x in moe_train['losses']]}"
                f"); routes a rank over the run (forward and remat "
                f"recompute, {n_moe} moe layers a pass) {routes}; one "
                f"moe_ffn_ep call (first moe layer, {ep['tokens']} tokens a "
                f"rank) against moe_ffn_ep_emulated on the card: worst "
                f"{[r['ep_check']['ulps'] for r in runs]} bf16 ulps at the "
                f"largest element (tol {MOE_OUT_ULPS}), bit-equal "
                f"{[r['ep_check']['bit_equal'] for r in runs]}, aux "
                f"{ep['aux']:.6f} against {ep['emu_aux']:.6f}; a step's "
                f"all_to_all bytes a rank {ep['a2a_bytes_per_step']} [{card}]")
        print(line, flush=True)
        bad = bad or (abs(losses[0][0] - loss0) > MOE_LOSS0_ATOL
                      or any(r["moe_ffn"] for r in routes)
                      or any(r["moe_ffn_ep"] < n_moe * len(losses[0])
                             or r["moe_ffn_ep"] % n_moe for r in routes)
                      or max(r["ep_check"]["ulps"] for r in runs)
                      > MOE_OUT_ULPS
                      or abs(ep["aux"] - ep["emu_aux"]) > 1e-6)
    else:
        ref = train["losses"]
        d = max(abs(a - b) for a, b in zip(losses[0], ref))
        g0 = abs(first["grad_norms"][0] - train["grad_norms"][0]) / abs(
            train["grad_norms"][0])
        line = (f"[{tag}] against the one-device run of the same model "
                f"{[round(x, 5) for x in ref]}: max |loss diff| {d:.2e} (tol "
                f"{LOSS0_SUM_ATOL}); step 0's grad norm {g0:.2e} relative "
                f"(tol {DP_GNORM_RTOL}) [{card}]")
        print(line, flush=True)
        bad = bad or d > LOSS0_SUM_ATOL or g0 > DP_GNORM_RTOL
    if "held" in first:
        held = [r["held"] for r in runs]
        line = (f"[{tag}] one checked step a rank: launches held against "
                f"their plain versions on their own inputs "
                f"{[h['counts'] for h in held]} (expected "
                f"{ {k: per_step[k] for k in held[0]['counts']} } each), "
                f"worst {[h['worst'] for h in held]} (flash_fwd in bf16 "
                f"ulps, tol {FLASH_OUT_ULPS}; backward in bf16 ulps at the "
                f"largest element, tol {BWD_ULPS}) [{card}]")
        print(line, flush=True)
        bad = bad or any(
            h["counts"][k] != per_step[k] for h in held for k in h["counts"]
        ) or any(h["worst"]["flash_fwd"] > FLASH_OUT_ULPS
                 or max(h["worst"]["flash_bwd_dq"],
                        h["worst"]["flash_bwd_dkv"]) > BWD_ULPS
                 for h in held)
    steady = sorted(first["step_ms"][1:]) or first["step_ms"]
    ms = [[round(x, 1) for x in r["step_ms"]] for r in runs]
    print(f"[{tag}] step ms a rank {ms}"
          f" (p50 after the first {steady[len(steady) // 2]:.1f}; 2 ranks "
          f"sharing one card over gloo through host memory: not a DP "
          f"speed); a step's collectives a rank (bytes handed to gloo by "
          f"kind) {first['wire_per_step']}; peak device memory a rank "
          f"{[round(r['peak'] / 1e9, 2) for r in runs]} GB; saves "
          f"{first['saves']} [{card}]", flush=True)
    if bad:
        fail(f"[{tag}] failed: see the lines above")
    out = {k: first[k] for k in ("losses", "grad_norms", "step_ms",
                                 "wire_per_step", "saves")}
    out.update(state_gb=[b / 1e9 for b in state],
               peak_gb=[r["peak"] / 1e9 for r in runs],
               step_ms_p50=steady[len(steady) // 2], sub_s=first["sub_s"])
    if "held" in first:
        out["held_worst"] = first["held"]["worst"]
    if which == "ep":
        out["routes"] = first["routes"]
        out["ep_check"] = first["ep_check"]
    return out


def dp_restore_one(torch, dev, card, want):
    """18b's final checkpoint (whole leaves, written by rank 0) restored
    in this process on one device: its params' fingerprint against the
    ranks' gathered params', then one more one-device step from it."""
    import math
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import TrainLoopConfig
    cfg = dp_config("fsdp")
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_fsdp_ckpt")
    t0 = time.perf_counter()
    step, state = resume_or_init(CheckpointManager(ckpt_dir), lambda: None,
                                 device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = fingerprint(torch, state["params"])
    loop = TrainLoopConfig(total_steps=DP_TRAIN_STEPS)
    bundle, _ = step_lib.build_train_step(build_model(cfg),
                                          peak_lr=loop.peak_lr,
                                          total_steps=loop.total_steps)
    _, _, m = bundle(state["params"], state["opt"],
                     step_batch(torch, dev, cfg, loop, DP_TRAIN_STEPS))
    loss = float(m["loss"])
    line = (f"[18b] the FSDP world's checkpoint (step {step}) restored on "
            f"one device in {restore_s:.1f} s: params bit-equal to the "
            f"ranks' gathered params (fingerprint): {got == want}; one more "
            f"one-device step from it: loss {loss:.5f} [{card}]")
    print(line, flush=True)
    if step != DP_TRAIN_STEPS or got != want or not math.isfinite(loss):
        fail(line)
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return {"step": step, "restore_s": restore_s, "bit_equal": got == want,
            "next_loss": loss}


def dp_rank_main(rank, n, store, out_dir):
    """One rank of phase 18's world: its {"data": n} mesh over gloo on the
    one card, 18a, 18b, 18c and 18d in turn (each sub-phase frees its
    model), then phase 19's 19a-19f over a {"model": n} mesh of the same
    ranks; results to out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh({"data": n}, device="cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    res, ops = {}, {}
    for which in ("dp", "fsdp", "ep"):
        res[which] = dp_train_rank(torch, mesh, which, ops)
        gc.collect()
        torch.cuda.empty_cache()
    res["ops"] = dp_ops_rank(torch, mesh, ops)
    # phase 19: the same ranks over {"model": n}
    tp_mesh = make_mesh({"model": n}, device="cuda:0", backend="gloo")
    for which in TP_TRAIN_RUNS:
        res[which] = tp_train_rank(torch, tp_mesh, which)
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dp_train_rank(torch, mesh, which, ops):
    """18a/18b/18c on one rank: Trainer(cfg, loop, mesh).run() with every
    step timed, its launches, collectives and the replicated leaves'
    fingerprint recorded; then (18a) one step with every flash launch held
    against its plain version and one leaf's per-rank grads for 18d,
    (18b) the gathered final params' fingerprint, (18c) the routes and
    one moe_ffn_ep call against its one-process emulation."""
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.dist import sharding
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    t_sub = time.perf_counter()
    cfg = dp_config(which)
    dev = mesh.device
    steps = EP_TRAIN_STEPS if which == "ep" else DP_TRAIN_STEPS
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps, log_every=1,
                           ckpt_dir=os.path.join(ROOT, "build",
                                                 f"chip_smoke_{which}_ckpt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, loop, mesh, fsdp=which == "fsdp")
    group, real_step = tr.bundle.group, tr.bundle
    counters = kernel_counters()
    for f in counters:
        f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters}

    routes = {"moe_ffn_ep": 0, "moe_ffn": 0}
    real_route = {k: getattr(moe, k) for k in routes}

    def counted(name):
        def call(*a, **kw):
            routes[name] += 1
            return real_route[name](*a, **kw)
        return call

    kinds = tree_leaves(sharding.data_dims(tr.plan, tr._specs()["params"]))
    rec = {"step_ms": [], "step_counts": [], "prints": [], "grad_norms": [],
           "wire": [], "saves": []}

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before, wire0 = counts(), dict(group.counts["bytes"])
        t0 = time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        rec["step_counts"].append({k: after[k] - before[k] for k in after})
        rec["wire"].append({k: v - wire0.get(k, 0)
                            for k, v in group.counts["bytes"].items()})
        rec["grad_norms"].append(float(out[2]["grad_norm"]))
        whole = [t for t, d in zip(tree_leaves(out[0]), kinds) if d is None]
        rec["prints"].append(fingerprint(torch, {str(i): t for i, t in
                                                 enumerate(whole)}))
        return out

    tr.step_fn = timed_step
    if which != "fsdp":           # 18b writes the checkpoint; here counted
        tr.save = lambda step, state: rec["saves"].append(step)
    for k in routes:
        setattr(moe, k, counted(k))
    try:
        out = tr.run(verbose=mesh.rank == 0)
    finally:
        for k in routes:
            setattr(moe, k, real_route[k])
    torch.cuda.synchronize()
    if which == "fsdp":
        rec["saves"] = [steps]
    res = {"losses": out["losses"], "launches": counts(),
           "peak": torch.cuda.max_memory_allocated(dev),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(tr.state)),
           "routes": dict(routes), "wire_per_step": rec["wire"][-1],
           **{k: rec[k] for k in ("step_ms", "step_counts", "prints",
                                  "grad_norms", "saves")}}
    src = TokenSource(DataConfig(seq_len=loop.seq_len,
                                 global_batch=loop.global_batch,
                                 vocab_size=cfg.vocab_size, seed=loop.seed))

    def rows_at(step):
        b = {k: torch.from_numpy(a) for k, a in src.batch_at(step).items()}
        return {k: v.to(dev) for k, v in
                sharding.local_batch(tr.plan, b).items()}

    params = tr.state["params"]
    if which == "dp":
        res["held"] = dp_checked_step(torch, flash_cuda, real_step, tr,
                                      rows_at(steps))
        # 18d's input: one leaf's per-rank grads (this rank's rows only)
        leaf = params["layers"]["attn"]["wk"]
        total, _ = tr.model.loss_fn(params, rows_at(steps + 1),
                                    step_lib.make_dist_ctx(tr.plan))
        ops["int8_grad"] = torch.autograd.grad(total, [leaf])[0].float()
        ops["int8_leaf"] = "layers/attn/wk"
    if which == "fsdp":
        whole = sharding.gather_tree(params, sharding.data_dims(
            tr.plan, tr._specs()["params"]), group)
        res["final_fingerprint"] = fingerprint(torch, whole)
        del whole
    if which == "ep":
        res["ep_check"] = dp_ep_check(torch, moe, cfg, mesh, group, params,
                                      loop)
        res["ep_check"]["a2a_bytes_per_step"] = rec["wire"][-1].get(
            "all_to_all", 0)
    del tr, params, real_step
    res["sub_s"] = time.perf_counter() - t_sub
    return res


def dp_checked_step(torch, flash_cuda, step_fn, tr, batch):
    """One more step with every flash launch held against its plain
    version on its own inputs (phase 14c's check, on one rank)."""
    plain = {"flash_fwd": lambda *a: flash_cuda.flash_fwd_plain(*a)[0],
             "flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    errs = {name: [] for name in plain}
    shapes = set()

    def against_plain(name):
        def check(args, got):
            want = plain[name](*args)
            if name == "flash_fwd":
                shapes.add((args[0].shape[2], args[1].shape[2],
                            args[0].shape[3]))
                errs[name].append(bf16_ulps(got[0], want))
                return
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    with hold_launches(flash_cuda, "flash_fwd", against_plain("flash_fwd")), \
            hold_launches(flash_cuda, "flash_bwd_dq",
                          against_plain("flash_bwd_dq")), \
            hold_launches(flash_cuda, "flash_bwd_dkv",
                          against_plain("flash_bwd_dkv")):
        step_fn(tr.state["params"], tr.state["opt"], batch)
        torch.cuda.synchronize()
    return {"counts": {k: len(e) for k, e in errs.items()},
            "worst": {k: max(e) if e else float("inf")
                      for k, e in errs.items()},
            "shapes": sorted(shapes)}


def dp_ep_check(torch, moe, cfg, mesh, group, params, loop):
    """One moe_ffn_ep call on the first moe layer (this rank's expert
    block, this rank's rows of one (global tokens, d_model) input drawn
    alike on every rank) against moe_ffn_ep_emulated on the whole input
    and the gathered experts, on the card."""
    from repro_torch.dist.sharding import local_shard
    dev = mesh.device
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    tokens = loop.seq_len * loop.global_batch
    gen = torch.Generator(device=dev).manual_seed(183)
    x = torch.randn(tokens, cfg.d_model, generator=gen,
                    device=dev).bfloat16()
    kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token)
    with torch.no_grad():
        out_l, aux_l = moe.moe_ffn_ep(
            local_shard(x, ("data",), mesh).contiguous(), lp, group=group,
            **kw)
        out = group.all_gather(out_l, 0)
        aux = float(group.all_reduce(aux_l))
        whole = dict(lp)
        for k in ("wi", "wg", "wo"):
            whole[k] = group.all_gather(lp[k], 0)
        emu, emu_aux = moe.moe_ffn_ep_emulated(x, whole, n_shards=group.size,
                                               **kw)
    torch.cuda.synchronize()
    return {"tokens": tokens // group.size, "ulps": bf16_ulps(out, emu),
            "bit_equal": bool(torch.equal(out, emu)), "aux": aux,
            "emu_aux": float(emu_aux)}


def dp_ops_rank(torch, mesh, ops):
    """18d on one rank: allreduce_int8 of the per-rank leaf grads 18a left
    (on the card and on the host copy, over the same ranks), and
    pipelined_apply over the data axis against the dense scan, its output
    and its gradient."""
    import hashlib
    from repro_torch.dist.collectives import AxesGroup
    from repro_torch.dist.pipeline import pipelined_apply
    from repro_torch.dist.sharding import local_shard
    from repro_torch.optim import compress
    from repro_torch.optim.compress import allreduce_int8, init_residual
    group = AxesGroup(mesh, ("data",))
    g = {"w": ops.pop("int8_grad")}
    o_dev, r_dev = allreduce_int8(g, init_residual(g), group)
    h = {"w": g["w"].cpu()}
    o_cpu, r_cpu = allreduce_int8(h, init_residual(h), group)
    # the quantizer op by op on the card and on the host (the residual is
    # 0): how many values differ at the max, at the scale divided the
    # parent's way (m / 127.0: a multiply by fl(1/127) on the card) and the
    # port's (compress._div), at the quotient and at its rounding
    apart = {}
    for how, div in (("python_divisor", lambda m: m / 127.0),
                     ("true_division", lambda m: compress._div(m, 127.0))):
        sides = []
        for x in (g["w"], h["w"]):
            m = group.all_reduce(torch.clamp_min(x.abs().max(), 1e-12),
                                 op="max")
            scale = div(m)
            quot = x / scale
            sides.append({"max": m, "scale": scale, "quotient": quot,
                          "round": torch.round(quot)})
        apart[how] = {op: int((sides[0][op].cpu() != sides[1][op]).sum())
                      for op in ("max", "scale", "quotient", "round")}
    exact = group.all_reduce(g["w"]) / group.size
    scale = float(group.all_reduce(g["w"].abs().max(), op="max")) / 127.0
    same = (torch.equal(o_dev["w"].cpu(), o_cpu["w"])
            and torch.equal(r_dev["w"].cpu(), r_cpu["w"]))
    L, M, B, D = PIPE_SHAPE
    gen = torch.Generator(device=mesh.device).manual_seed(18)
    w = torch.randn(L, D, D, generator=gen, device=mesh.device) * D ** -0.5
    x = torch.randn(M, B, D, generator=gen, device=mesh.device)
    cot = torch.randn(M, B, D, generator=gen, device=mesh.device)
    stage = local_shard(w, ("data",), mesh).contiguous().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    got = pipelined_apply(lambda p, t: torch.tanh(t @ p), stage, xg,
                          mesh=mesh, pp_axis="data")
    g_stage, g_x = torch.autograd.grad((got * cot).sum(), [stage, xg])
    # the gradient of the same loss through the dense layer loop
    wd, xd = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
    dense = xd
    for i in range(L):
        dense = torch.tanh(dense @ wd[i])
    gw, gx = torch.autograd.grad((dense * cot).sum(), [wd, xd])
    mine = local_shard(gw, ("data",), mesh)
    got = got.detach()
    return {"int8_leaf": ops["int8_leaf"], "int8_numel": g["w"].numel(),
            "int8_bit_equal": same, "int8_scale": scale,
            "int8_ops_apart": apart,
            "int8_err": float((o_dev["w"] - exact).abs().max()),
            "pipe_shape": f"L={L}, M={M}, B={B}, D={D}, f32",
            "pipe_err": float((got - dense.detach()).abs().max()),
            "pipe_grad_err": max(float((g_stage - mine).abs().max()),
                                 float((g_x - gx).abs().max())),
            "pipe_digest": hashlib.sha1(got.cpu().numpy().tobytes()
                                        ).hexdigest()}


# ---------------------------------------------------------------------------
# phase 19: tensor-parallel training, phase 18's 2 ranks over {"model": 2}
# ---------------------------------------------------------------------------

def tp_train_config(which):
    """19a: qwen2-1.5b at full width cut to TP_DENSE_LAYERS layers, flash
    on (18a's model); 19b: deepseek-moe-16b at full width cut to
    TP_MOE_LAYERS layers, remat "full", flash on (14c's); 19c hymba-1.5b
    at full width cut to TP_HYBRID_LAYERS layers, remat "full", "chunked"
    (15c's, cut); 19d rwkv6-7b cut to RWKV_TRAIN_LAYERS layers (15c's);
    19e whisper-small uncut and 19f internvl2-26b cut to VLM_TRAIN_LAYERS
    layers, flash on (16c's); every one remat "full"."""
    import dataclasses
    import repro_torch
    if which == "tp_moe":
        return dataclasses.replace(dp_config("ep"), n_layers=TP_MOE_LAYERS)
    if which == "tp_hybrid":
        return dataclasses.replace(repro_torch.get_config("hymba-1.5b"),
                                   n_layers=TP_HYBRID_LAYERS, remat="full",
                                   ssm_impl="chunked")
    if which == "tp_ssm":
        return dataclasses.replace(repro_torch.get_config("rwkv6-7b"),
                                   n_layers=RWKV_TRAIN_LAYERS, remat="full")
    if which == "tp_encdec":
        return dataclasses.replace(repro_torch.get_config("whisper-small"),
                                   remat="full")
    if which == "tp_vlm":
        return dataclasses.replace(repro_torch.get_config("internvl2-26b"),
                                   n_layers=VLM_TRAIN_LAYERS, remat="full",
                                   use_flash_attention=True)
    return dataclasses.replace(dp_config("dp"), n_layers=TP_DENSE_LAYERS)


def tp_train_loop(which):
    """(seq_len, global_batch) of a sub-phase's loop: phase 10's for 19a,
    14c's for 19b (both the TrainLoopConfig defaults), 15c's for 19c and
    19d, 16c's for 19e and 19f."""
    return {"tp_hybrid": (HYBRID_TRAIN_SEQ, HYBRID_TRAIN_BATCH),
            "tp_ssm": (RWKV_TRAIN_SEQ, RWKV_TRAIN_BATCH),
            "tp_encdec": (WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH),
            "tp_vlm": (VLM_TRAIN_SEQ, VLM_TRAIN_BATCH)}.get(which,
                                                            (512, 8))


def tp_flash_per_step(cfg):
    """Flash launches a train step a rank: the forward and remat's
    recompute, and each backward kernel once, a layer (none without
    flash)."""
    if not cfg.use_flash_attention:
        return {}
    return {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}


def tp_train_rank(torch, mesh, which):
    """19a-19f on one rank of the {"model": n} mesh: Trainer(cfg, loop,
    mesh).run() for TP_TRAIN_STEPS steps with every step timed, its
    launches, its model-axis collectives (calls and bytes) and the
    replicated leaves' fingerprint recorded, the routes a moe layer took
    (with has_tp or not), a few leaves' local shapes; then (19a, 19f:
    flash on) one step with every flash launch held against its plain
    version."""
    from repro_torch.dist import sharding
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    t_sub = time.perf_counter()
    cfg = tp_train_config(which)
    dev = mesh.device
    seq, batch = tp_train_loop(which)
    loop = TrainLoopConfig(total_steps=TP_TRAIN_STEPS,
                           ckpt_every=TP_TRAIN_STEPS, log_every=1,
                           seq_len=seq, global_batch=batch,
                           ckpt_dir=os.path.join(ROOT, "build",
                                                 f"chip_smoke_{which}_ckpt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, loop, mesh)
    mgroup, real_step = tr.bundle.model_group, tr.bundle
    counters = kernel_counters()
    for f in counters:
        f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters}

    routes = {"moe_ffn_ep": 0, "moe_ffn_ep_tp": 0, "moe_ffn": 0}
    real_route = {k: getattr(moe, k) for k in ("moe_ffn_ep", "moe_ffn")}

    def counted(name):
        def call(*a, **kw):
            routes[name] += 1
            if name == "moe_ffn_ep" and kw.get("tp") is not None:
                routes["moe_ffn_ep_tp"] += 1
            return real_route[name](*a, **kw)
        return call

    whole = [d is None for d in tree_leaves(sharding.model_dims(
        tr.plan, tr._specs()["params"]))]
    rec = {"step_ms": [], "step_counts": [], "prints": [], "grad_norms": [],
           "wire": [], "saves": []}

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before = counts()
        calls0 = sum(mgroup.counts["calls"].values())
        bytes0 = sum(mgroup.counts["bytes"].values())
        t0 = time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = counts()
        rec["step_counts"].append({k: after[k] - before[k] for k in after})
        rec["wire"].append((sum(mgroup.counts["calls"].values()) - calls0,
                            sum(mgroup.counts["bytes"].values()) - bytes0))
        rec["grad_norms"].append(float(out[2]["grad_norm"]))
        rep = [t for t, w in zip(tree_leaves(out[0]), whole) if w]
        rec["prints"].append(fingerprint(torch, {str(i): t for i, t in
                                                 enumerate(rep)}))
        return out

    tr.step_fn = timed_step
    tr.save = lambda step, state: rec["saves"].append(step)
    for k in real_route:
        setattr(moe, k, counted(k))
    try:
        out = tr.run(verbose=mesh.rank == 0)
    finally:
        for k, f in real_route.items():
            setattr(moe, k, f)
    torch.cuda.synchronize()
    params = tr.state["params"]
    local = dict(_spec_items(params))
    shapes = {k: tuple(local[k].shape) for k in TP_SHAPE_LEAVES[which]}
    res = {"losses": out["losses"], "launches": counts(),
           "peak": torch.cuda.max_memory_allocated(dev),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(tr.state)),
           "routes": dict(routes), "shapes": shapes,
           **{k: rec[k] for k in ("step_ms", "step_counts", "prints",
                                  "grad_norms", "wire", "saves")}}
    if which in ("tp_dense", "tp_vlm"):
        batch = sharding.local_batch(tr.plan, step_batch(
            torch, dev, cfg, loop, TP_TRAIN_STEPS))
        res["held"] = dp_checked_step(torch, flash_cuda, real_step, tr, batch)
    del tr, params, local, real_step
    res["sub_s"] = time.perf_counter() - t_sub
    return res


def tp_train_gates(tag, which, runs, pred, ref, card):
    """19a-19f's gates on every rank's results: held to the one-device
    run of the same model and batches (`ref`: 18a's reference, 14c's run,
    19c's own, 15c's, 16c's), the ranks to each other, the predictions
    made before the world."""
    import math
    first = runs[0]
    cfg = tp_train_config(which)
    n_layers = cfg.n_layers
    per_step = {k: 0 for k in first["launches"]}
    per_step.update(tp_flash_per_step(cfg))
    losses = [r["losses"] for r in runs]
    same = all(r["prints"] == first["prints"] for r in runs)
    counts_ok = all(c == per_step for r in runs for c in r["step_counts"])
    state = [r["state_bytes"] for r in runs]
    wire_ok = all(w == tuple(pred["collectives"]) for r in runs
                  for w in r["wire"])
    d = max(abs(a - b) for a, b in zip(losses[0], ref["losses"]))
    g0 = abs(first["grad_norms"][0] - ref["grad_norms"][0]) / abs(
        ref["grad_norms"][0])
    g0_tol = TP_GNORM_RTOL.get(which, DP_GNORM_RTOL)
    line = (f"[{tag}] {cfg.name} ({n_layers} layers, {cfg.optimizer}) over "
            f"{len(runs)} model ranks (gloo, one card): losses "
            f"{[[round(x, 5) for x in l] for l in losses]} against the "
            f"one-device run of the same model and batches "
            f"{[round(x, 5) for x in ref['losses'][:TP_TRAIN_STEPS]]}: max "
            f"|loss diff| {d:.2e} (tol {LOSS0_SUM_ATOL}); grad norms "
            f"{[round(x, 5) for x in first['grad_norms']]}, step 0's "
            f"{g0:.2e} relative to one device's "
            f"{ref['grad_norms'][0]:.5f} (tol {g0_tol}); the replicated "
            f"leaves' fingerprints after every step equal on the ranks: "
            f"{same}; launches a step a rank {first['step_counts'][0]} "
            f"(predicted {per_step}: {counts_ok}); model-axis collectives a "
            f"step a rank (calls, bytes) {first['wire']} (predicted "
            f"{tuple(pred['collectives'])}: {wire_ok}); params plus "
            f"optimizer state a rank {[round(b / 1e9, 3) for b in state]} "
            f"GB (predicted {pred['state'] / 1e9:.3f}); local shapes "
            f"{first['shapes']} [{card}]")
    print(line, flush=True)
    bad = (not same or not counts_ok or not wire_ok
           or any(b != pred["state"] for b in state)
           or any(l != losses[0] for l in losses)
           or not all(math.isfinite(x) for x in losses[0])
           or d > LOSS0_SUM_ATOL or g0 > g0_tol)
    if which == "tp_moe":
        n_moe = n_layers - cfg.first_k_dense
        routes = [r["routes"] for r in runs]
        # forward and remat recompute: two calls a moe layer a step
        want = 2 * n_moe * TP_TRAIN_STEPS
        line = (f"[{tag}] routes a rank over the run (forward and remat "
                f"recompute, {n_moe} moe layers a pass) {routes}: every "
                f"one moe_ffn_ep with has_tp (expected {want}) [{card}]")
        print(line, flush=True)
        bad = bad or any(r["moe_ffn"] or r["moe_ffn_ep"] != want
                         or r["moe_ffn_ep_tp"] != want for r in routes)
    if "held" in first:
        held = [r["held"] for r in runs]
        line = (f"[{tag}] one checked step a rank: launches held against "
                f"their plain versions on their own inputs "
                f"{[h['counts'] for h in held]} (expected "
                f"{ {k: per_step[k] for k in held[0]['counts']} } each) at "
                f"(H, KvH, Hd) {[h['shapes'] for h in held]}, worst "
                f"{[h['worst'] for h in held]} (bf16 ulps; flash_fwd at "
                f"each element, the backward at the largest element; tol "
                f"{TP_TRAIN_ULPS}) [{card}]")
        print(line, flush=True)
        bad = bad or any(
            h["counts"][k] != per_step[k] for h in held for k in h["counts"]
        ) or any(v > TP_TRAIN_ULPS for h in held for v in h["worst"].values())
    steady = sorted(first["step_ms"][1:]) or first["step_ms"]
    one = sorted(ref["step_ms"][1:TP_TRAIN_STEPS]) or ref["step_ms"]
    ms = [[round(x, 1) for x in r["step_ms"]] for r in runs]
    print(f"[{tag}] step ms a rank {ms} (p50 after the first "
          f"{steady[len(steady) // 2]:.1f}) against one device's "
          f"{one[len(one) // 2]:.1f} (2 ranks sharing one card over gloo "
          f"through host memory: not a TP speed); peak device memory a "
          f"rank {[round(r['peak'] / 1e9, 2) for r in runs]} GB; saves "
          f"{first['saves']} [{card}]", flush=True)
    if bad:
        fail(f"[{tag}] failed: see the lines above")
    out = {k: first[k] for k in ("losses", "grad_norms", "step_ms", "wire",
                                 "routes", "shapes")}
    out.update(state_gb=[b / 1e9 for b in state], state_bytes=state,
               peak_gb=[r["peak"] / 1e9 for r in runs],
               step_ms_p50=steady[len(steady) // 2],
               one_device_step_ms=one[len(one) // 2],
               predicted_collectives=list(pred["collectives"]),
               sub_s=first["sub_s"])
    if "held" in first:
        out["held_worst"] = first["held"]["worst"]
    return out


# ---------------------------------------------------------------------------
# phase 21: FSDP beside a model axis, 4 ranks on the card over {"data": 2,
# "model": 2}
# ---------------------------------------------------------------------------

def fsdp_tp_config(layers=None):
    """qwen2.5-32b at full width cut to FSDP_TP_LAYERS layers (uncut with
    layers=64), flash on, remat "full", its config's Adafactor."""
    import dataclasses
    import repro_torch
    cfg = repro_torch.get_config("qwen2.5-32b")
    return dataclasses.replace(cfg, n_layers=layers or FSDP_TP_LAYERS,
                               remat="full", use_flash_attention=True)


def fsdp_tp_specs(cfg, fsdp):
    """(plan, the param spec tree) of cfg's training plan over
    FSDP_TP_SHAPE, from the abstract params (no mesh needed)."""
    from types import SimpleNamespace
    from repro_torch.dist import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    mesh = SimpleNamespace(shape=FSDP_TP_SHAPE,
                           coords={a: 0 for a in FSDP_TP_SHAPE})
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=fsdp)
    return plan, sharding.params_shardings(
        plan, model.param_axes, model.abstract_params(), model.param_parts)


def fsdp_tp_phase(torch, np, dev, card, flash_cuda, zero_counts,
                  read_counts, by_path):
    """Phase 21: FSDP beside a model axis. FSDP_TP_RANKS ranks share the
    card over gloo (spawn, a FileStore under build/) on a
    FSDP_TP_SHAPE mesh; each runs Trainer(fsdp_tp_config(), phase 10's
    loop, mesh, fsdp=True) for FSDP_TP_STEPS steps (every leaf's spec the
    uncut config's default, asserted here first), writes the final
    checkpoint (rank 0) and takes one more step with every flash launch
    held against its plain version. Here, before the world: the same
    model on the same batches on one device, and the predictions from the
    specs (params plus optimizer state a rank; calls and bytes a step a
    rank over the data group and over the model group; flash launches a
    step a rank). After it: every gate, and the checkpoint restored on one
    device against the ranks' gathered params."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.launch.predict import (fsdp_data_collectives,
                                            tp_collectives)
    t0 = time.perf_counter()
    cfg = fsdp_tp_config()
    plan, specs = fsdp_tp_specs(cfg, True)
    uncut_plan, uncut = fsdp_tp_specs(fsdp_tp_config(64), None)
    mine, whole = dict(_spec_items(specs)), dict(_spec_items(uncut))
    same_specs = (mine == whole and uncut_plan.fsdp
                  and all(tuple(mine[k]) == tuple(whole[k]) for k in mine))
    co = sorted(k for k, v in mine.items()
                if any(isinstance(e, tuple) and e[0] == "model" for e in v))
    line = (f"[21] {cfg.name} at {cfg.n_layers} layers "
            f"({cfg.param_count():.4e} params) over {FSDP_TP_SHAPE} with "
            f"fsdp=True: every leaf's spec the uncut "
            f"{fsdp_tp_config(64).n_layers}-layer config's default "
            f"(FSDP: {uncut_plan.fsdp}): {same_specs}; {len(co)} of "
            f"{len(mine)} leaves split over the model axis and the data axis "
            f"together: {co} [{card}]")
    print(line, flush=True)
    if not same_specs or not co:
        fail(line)
    seq, batch = 512, 8                          # phase 10's loop
    ref = one_device_run(torch, dev, card, "21", cfg, FSDP_TP_STEPS,
                         "phase 10's loop")
    data_size = plan.dp_size()
    state, whole_state = dp_state_bytes(cfg, True, FSDP_TP_SHAPE)
    pred = {"state": state,
            "data": fsdp_data_collectives(cfg, FSDP_TP_SHAPE),
            "model": tp_collectives(cfg, seq, batch // data_size,
                                    FSDP_TP_SHAPE["model"], FSDP_TP_SHAPE,
                                    fsdp=True),
            "flash": tp_flash_per_step(cfg)}
    print(f"[21] predicted from the specs and shapes, a rank: params plus "
          f"optimizer state {pred['state'] / 1e9:.3f} GB (whole "
          f"{whole_state / 1e9:.3f}); a "
          f"step's data-group collectives (FSDP's gathers and "
          f"reduce-scatters, the sums) {pred['data'][0]} calls, "
          f"{pred['data'][1]} bytes; model-group collectives (remat's "
          f"recompute included) {pred['model'][0]} calls, "
          f"{pred['model'][1]} bytes; flash launches a step {pred['flash']} "
          f"[{card}]", flush=True)
    shutil.rmtree(FSDP_TP_CKPT, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="fsdp_tp_world_",
                            dir=os.path.join(ROOT, "build"))
    store, out_dir = os.path.join(work, "store"), os.path.join(work, "out")
    os.makedirs(out_dir)
    t1 = time.perf_counter()
    ctx = mp.start_processes(fsdp_tp_rank_main,
                             args=(FSDP_TP_RANKS, store, out_dir),
                             nprocs=FSDP_TP_RANKS, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() - t1 > DP_WORLD_TIMEOUT_S:
                fail(f"[21] the {FSDP_TP_RANKS}-rank world ran past "
                     f"{DP_WORLD_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        fail(f"[21] a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"[21] a rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    world_s = time.perf_counter() - t1
    runs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(FSDP_TP_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    by_path["fsdp_tp_train"] = {k: sum(r["launches"][k] for r in runs)
                                for k in read_counts()}
    res = fsdp_tp_gates(runs, pred, ref, card)
    res["restore"] = fsdp_tp_restore_one(torch, dev, card, cfg,
                                         runs[0]["final_fingerprint"])
    shutil.rmtree(FSDP_TP_CKPT, ignore_errors=True)
    res.update(world_s=world_s, co_split=co,
               predicted={"state_gb": pred["state"] / 1e9,
                          "data": list(pred["data"]),
                          "model": list(pred["model"])},
               phase_s=time.perf_counter() - t0)
    print(f"[21] phase 21 ran {res['phase_s']:.1f} s (the one-device "
          f"reference {sum(ref['step_ms']) / 1e3:.1f} s of steps; the "
          f"{FSDP_TP_RANKS}-rank world {world_s:.1f} s: rank 0's run "
          f"{runs[0]['sub_s']:.1f} s) [{card}]", flush=True)
    return res


def fsdp_tp_rank_main(rank, n, store, out_dir):
    """One rank of phase 21's world: its FSDP_TP_SHAPE mesh over gloo on
    the one card, fsdp_tp_rank; results to out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(FSDP_TP_SHAPE, device="cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    res = fsdp_tp_rank(torch, mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def fsdp_tp_rank(torch, mesh):
    """Phase 21 on one rank: Trainer(cfg, loop, mesh, fsdp=True).run()
    for FSDP_TP_STEPS steps with every step timed, its launches, its
    data-group and model-group collectives (calls and bytes), its grad
    norm and the fingerprints of the state's leaves each group replicates
    recorded, the final checkpoint written (rank 0); then the params
    gathered whole (their fingerprint) and one more step with every flash
    launch held against its plain version."""
    from repro_torch.dist import sharding
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    t_sub = time.perf_counter()
    cfg = fsdp_tp_config()
    dev = mesh.device
    loop = TrainLoopConfig(total_steps=FSDP_TP_STEPS,
                           ckpt_every=FSDP_TP_STEPS, log_every=1,
                           ckpt_dir=FSDP_TP_CKPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, loop, mesh, fsdp=True)
    group, mgroup, real_step = (tr.bundle.group, tr.bundle.model_group,
                                tr.bundle)
    counters = kernel_counters()
    for f in counters:
        f.launches = 0

    def counts():
        return {f.__name__: f.launches for f in counters}

    def wire(g):
        return (sum(g.counts["calls"].values()),
                sum(g.counts["bytes"].values()))

    specs = tr._specs()
    whole_over = {
        "data": [d is None for d in tree_leaves(sharding.data_dims(
            tr.plan, specs))],
        "model": [d is None for d in tree_leaves(sharding.model_dims(
            tr.plan, specs))]}
    rec = {"step_ms": [], "step_counts": [], "data_wire": [],
           "model_wire": [], "grad_norms": [], "prints": []}

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before, d0, m0 = counts(), wire(group), wire(mgroup)
        t0 = time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after, d1, m1 = counts(), wire(group), wire(mgroup)
        rec["step_counts"].append({k: after[k] - before[k] for k in after})
        rec["data_wire"].append((d1[0] - d0[0], d1[1] - d0[1]))
        rec["model_wire"].append((m1[0] - m0[0], m1[1] - m0[1]))
        rec["grad_norms"].append(float(out[2]["grad_norm"]))
        leaves = tree_leaves({"params": out[0], "opt": out[1]})
        rec["prints"].append({
            axis: fingerprint(torch, {str(i): t for i, (t, w) in enumerate(
                zip(leaves, mask)) if w})
            for axis, mask in whole_over.items()})
        return out

    tr.step_fn = timed_step
    out = tr.run(verbose=mesh.rank == 0)
    torch.cuda.synchronize()
    launches = counts()
    params = tr.state["params"]
    local = dict(_spec_items(params))
    res = {"losses": out["losses"], "launches": launches,
           "peak": torch.cuda.max_memory_allocated(dev),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(tr.state)),
           "shapes": {k: tuple(local[k].shape) for k in (
               "embed", "head", "layers/attn/wq", "layers/attn/wo",
               "layers/ffn/wi")},
           "coords": dict(mesh.coords), **rec}
    pspecs = specs["params"]
    whole = sharding.gather_tree(
        params, sharding.data_dims(tr.plan, pspecs), group,
        model_dims=sharding.model_dims(tr.plan, pspecs), model_group=mgroup,
        parts=sharding.packed_parts(pspecs))
    res["final_fingerprint"] = fingerprint(torch, whole)
    del whole
    torch.cuda.empty_cache()
    batch = sharding.local_batch(tr.plan, step_batch(
        torch, dev, cfg, loop, FSDP_TP_STEPS))
    res["held"] = dp_checked_step(torch, flash_cuda, real_step, tr, batch)
    del tr, params, local, real_step
    res["sub_s"] = time.perf_counter() - t_sub
    return res


def fsdp_tp_gates(runs, pred, ref, card):
    """Phase 21's gates on every rank's results: the predictions, the
    one-device run of the same model and batches, the replicas, the flash
    launches."""
    cfg = fsdp_tp_config()
    first = runs[0]
    per_step = {k: 0 for k in first["launches"]}
    per_step.update(pred["flash"])
    losses = [r["losses"] for r in runs]
    counts_ok = all(c == per_step for r in runs for c in r["step_counts"])
    launches_ok = all(r["launches"] == {k: n * FSDP_TP_STEPS for k, n in
                                        per_step.items()} for r in runs)
    state = [r["state_bytes"] for r in runs]
    data_ok = all(w == tuple(pred["data"]) for r in runs
                  for w in r["data_wire"])
    model_ok = all(w == tuple(pred["model"]) for r in runs
                   for w in r["model_wire"])
    # the data group of rank (d, m) is {(0, m), (1, m)}, the model group
    # {(d, 0), (d, 1)}; their replicated leaves' fingerprints every step
    groups = {"data": {}, "model": {}}
    for r in runs:
        c = r["coords"]
        groups["data"].setdefault(c["model"], []).append(
            [p["data"] for p in r["prints"]])
        groups["model"].setdefault(c["data"], []).append(
            [p["model"] for p in r["prints"]])
    same = all(all(p == ps[0] for p in ps) for g in groups.values()
               for ps in g.values())
    d = max(abs(a - b) for a, b in zip(losses[0], ref["losses"]))
    g0 = abs(first["grad_norms"][0] - ref["grad_norms"][0]) / abs(
        ref["grad_norms"][0])
    line = (f"[21] {cfg.name} ({cfg.n_layers} layers, {cfg.optimizer}) over "
            f"{FSDP_TP_SHAPE} (FSDP beside TP; gloo, one card): losses "
            f"{[[round(x, 5) for x in l] for l in losses]} against the "
            f"one-device run of the same model and batches "
            f"{[round(x, 5) for x in ref['losses']]}: max |loss diff| "
            f"{d:.2e} (tol {LOSS0_SUM_ATOL}); grad norms "
            f"{[round(x, 5) for x in first['grad_norms']]}, step 0's "
            f"{g0:.2e} relative to one device's {ref['grad_norms'][0]:.5f} "
            f"(tol {DP_GNORM_RTOL}); the fingerprints of the leaves each "
            f"data group and each model group replicates equal across it "
            f"after every step: {same}; launches a step a rank "
            f"{first['step_counts'][0]} (predicted {per_step}: {counts_ok}); "
            f"data-group collectives a step a rank (calls, bytes) "
            f"{first['data_wire']} (predicted {tuple(pred['data'])}: "
            f"{data_ok}); model-group {first['model_wire']} (predicted "
            f"{tuple(pred['model'])}: {model_ok}); params plus optimizer "
            f"state a rank {[round(b / 1e9, 3) for b in state]} GB "
            f"(predicted {pred['state'] / 1e9:.3f}); local shapes "
            f"{first['shapes']} [{card}]")
    print(line, flush=True)
    bad = (not same or not counts_ok or not launches_ok or not data_ok
           or not model_ok or any(b != pred["state"] for b in state)
           or any(l != losses[0] for l in losses)
           or not all(math.isfinite(x) for x in losses[0])
           or d > LOSS0_SUM_ATOL or g0 > DP_GNORM_RTOL)
    held = [r["held"] for r in runs]
    line = (f"[21] one checked step a rank: launches held against their "
            f"plain versions on their own inputs "
            f"{[h['counts'] for h in held]} (expected "
            f"{ {k: per_step[k] for k in held[0]['counts']} } each) at (H, "
            f"KvH, Hd) {[h['shapes'] for h in held]}, worst "
            f"{[h['worst'] for h in held]} (bf16 ulps; flash_fwd at each "
            f"element, the backward at the largest element; tol "
            f"{TP_TRAIN_ULPS}) [{card}]")
    print(line, flush=True)
    bad = bad or any(
        h["counts"][k] != per_step[k] for h in held for k in h["counts"]
    ) or any(v > TP_TRAIN_ULPS for h in held for v in h["worst"].values())
    steady = sorted(first["step_ms"][1:]) or first["step_ms"]
    one = sorted(ref["step_ms"][1:]) or ref["step_ms"]
    wire_bytes = [w[1] + m[1] for w, m in zip(first["data_wire"],
                                              first["model_wire"])]
    ms = [[round(x, 1) for x in r["step_ms"]] for r in runs]
    print(f"[21] step ms a rank {ms} (p50 after the first "
          f"{steady[len(steady) // 2]:.1f}) against one device's "
          f"{one[len(one) // 2]:.1f} ({FSDP_TP_RANKS} ranks "
          f"sharing one card over gloo through host memory: not an FSDP or "
          f"TP speed); bytes a step rank 0 hands gloo {wire_bytes}; peak "
          f"device memory a rank {[round(r['peak'] / 1e9, 2) for r in runs]}"
          f" GB [{card}]", flush=True)
    if bad:
        fail("[21] failed: see the lines above")
    return {"losses": first["losses"], "grad_norms": first["grad_norms"],
            "step_ms": first["step_ms"], "data_wire": first["data_wire"],
            "model_wire": first["model_wire"], "shapes": first["shapes"],
            "state_gb": [b / 1e9 for b in state], "state_bytes": state,
            "peak_gb": [r["peak"] / 1e9 for r in runs],
            "step_ms_p50": steady[len(steady) // 2],
            "one_device_step_ms": one[len(one) // 2],
            "held_worst": first["held"]["worst"],
            "held_shapes": first["held"]["shapes"], "sub_s": first["sub_s"]}


def fsdp_tp_restore_one(torch, dev, card, cfg, want):
    """Rank 0's final checkpoint (whole leaves) restored here on one
    device: its params' fingerprint against the ranks' gathered params'."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.fault import resume_or_init
    t0 = time.perf_counter()
    step, state = resume_or_init(CheckpointManager(FSDP_TP_CKPT),
                                 lambda: None, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = fingerprint(torch, state["params"])
    line = (f"[21] the FSDP x TP world's checkpoint (step {step}) restored "
            f"on one device in {restore_s:.1f} s: params bit-equal to the "
            f"ranks' gathered params (fingerprint): {got == want} [{card}]")
    print(line, flush=True)
    if step != FSDP_TP_STEPS or got != want:
        fail(line)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"step": step, "restore_s": restore_s, "bit_equal": got == want}


# ---------------------------------------------------------------------------
# phase 22: the dry-run's census against the measured steps; the examples
# ---------------------------------------------------------------------------

def census_batch(torch, cfg, seq, batch):
    """The abstract ("meta") global batch a Trainer feeds cfg at (seq,
    batch): launch.specs.train_batch_specs with the f32 stub frames or
    patches of data.pipeline.make_stub_frontend_batch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import train_batch_specs
    return train_batch_specs(cfg, ShapeConfig("census", seq, batch, "train"),
                             frontend_dtype=torch.float32)


def modeled_config(tag):
    """The config of a MODELED_RUNS tag: 16c's whisper-small, 15c's
    rwkv6-7b."""
    import dataclasses
    import repro_torch
    if tag == "whisper":
        return (dataclasses.replace(repro_torch.get_config("whisper-small"),
                                    remat="full"),
                WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH)
    return (dataclasses.replace(repro_torch.get_config("rwkv6-7b"),
                                n_layers=RWKV_TRAIN_LAYERS, remat="full"),
            RWKV_TRAIN_SEQ, RWKV_TRAIN_BATCH)


def census_worker(spec_name, out_path):
    """Phase 22's step censuses in a worker process (fake tensors on the
    CPU; nothing here touches the card): every 19a-19f cell and phase
    21's as rank 0 of an abstract mesh (the model- and data-group calls
    and bytes, the state bytes), and the MODELED_RUNS one-device steps
    priced on the named spec (core.roofline.analyze_step). The results
    go to out_path as JSON with the worker's seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.analyze.census import census_step
    from repro_torch.core import hw, roofline
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    torch.set_num_threads(2)
    t0 = time.perf_counter()

    def count(cfg, shape, seq, batch, fsdp=None):
        plan = None
        if shape is not None:
            plan = step_lib.make_plan(cfg, abstract_mesh(shape), kind="train",
                                      fsdp=fsdp)
        bundle, _ = step_lib.build_train_step(build_model(cfg), plan)
        t1 = time.perf_counter()
        c = census_step(bundle, census_batch(torch, cfg, seq, batch))
        return c, time.perf_counter() - t1

    def wire(c):
        return {g: [c.group_calls(g), c.group_bytes(g)]
                for g in c.collectives}

    out = {"19": {}, "modeled": {}}
    for which in TP_TRAIN_RUNS:
        seq, batch = tp_train_loop(which)
        c, sec = count(tp_train_config(which), {"model": TP_RANKS}, seq,
                       batch)
        out["19"][which] = {"wire": wire(c), "state": c.state_bytes,
                            "census_s": sec}
    c, sec = count(fsdp_tp_config(), FSDP_TP_SHAPE, 512, 8, fsdp=True)
    out["21"] = {"wire": wire(c), "state": c.state_bytes, "census_s": sec}
    spec = hw.SPECS[spec_name]
    for tag in MODELED_RUNS:
        cfg, seq, batch = modeled_config(tag)
        c, sec = count(cfg, None, seq, batch)
        rep = roofline.analyze_step(cfg.name, c, spec=spec)
        out["modeled"][tag] = {
            "name": cfg.name, "layers": cfg.n_layers, "seq": seq,
            "batch": batch, "step_s": rep.modeled_step_s,
            "compute_s": rep.compute_s, "memory_s": rep.memory_s,
            "dominant": rep.dominant, "flops": c.flops,
            "tc_flops": c.tc_flops, "op_bytes": c.op_bytes,
            "launches": c.launches, "peak_live_bytes": c.peak_live_bytes,
            "state_bytes": c.state_bytes, "census_s": sec}
    out["worker_s"] = time.perf_counter() - t0
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, out_path)


def start_census(spec):
    """Start census_worker (spawn, daemonic: it dies with this process)."""
    import multiprocessing
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_path = os.path.join(ROOT, "build", "chip_smoke_census.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    proc = multiprocessing.get_context("spawn").Process(
        target=census_worker, args=(spec.name, out_path), daemon=True)
    proc.start()
    return proc, out_path


def start_example(name, args, tag):
    """examples/<name> with args on the card, in its own process with its
    own tune cache under build/ (stdout and stderr to a log there)."""
    work = os.path.join(ROOT, "build", f"chip_smoke_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TUNE_CACHE=os.path.join(work, "tune"))
    log = open(os.path.join(work, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def finish_example(proc, log):
    """(rc, output) of a start_example process (killed past
    EXAMPLE_TIMEOUT_S)."""
    try:
        rc = proc.wait(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    with open(log.name) as fh:
        return rc, fh.read()


def examples_phase(card):
    """22c: the four examples on the card. registry_smoke_torch.py,
    quickstart_torch.py, serve_batched_torch.py and the first
    train_lm_torch.py run side by side; then train_lm_torch.py again on
    the same checkpoint directory. Returns each run's rc, seconds and key
    lines."""
    t0 = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_lm_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    train = ("--preset", "smoke", "--steps", "20", "--ckpt-every", "10",
             "--ckpt-dir", ckpt)
    runs = {"registry_smoke": ("registry_smoke_torch.py", ()),
            "quickstart": ("quickstart_torch.py", ()),
            "serve_batched": ("serve_batched_torch.py", ()),
            "train_lm": ("train_lm_torch.py", train)}
    started = {tag: start_example(name, args, f"example_{tag}")
               for tag, (name, args) in runs.items()}
    out = {tag: finish_example(*p) for tag, p in started.items()}
    out["train_lm_again"] = finish_example(*start_example(
        "train_lm_torch.py", train, "example_train_lm_again"))
    res = {}
    for tag, (rc, text) in out.items():
        keys = [ln for ln in text.splitlines() if ln.startswith((
            "registry smoke", "kernel launches", "  gpp", "  flash",
            "  ssm", "  paged", "done.", "nothing to do", "[trainer]",
            "final loss", "restored step", "request ", "served ",
            "  decode_steps"))]
        res[tag] = {"rc": rc, "lines": keys}
        print(f"[22c] examples/{runs.get(tag, runs['train_lm'])[0]}"
              f"{' (again)' if tag == 'train_lm_again' else ''}: rc {rc}; "
              f"{keys} [{card}]", flush=True)
        if rc != 0:
            print(text[-4000:], flush=True)
    reg = "\n".join(res["registry_smoke"]["lines"])
    launched = next((ln for ln in res["registry_smoke"]["lines"]
                     if ln.startswith("kernel launches")), "")
    hand = ("gpp_fused", "flash_fwd", "ssm_scan", "paged_decode_gather")
    bad = (any(r["rc"] != 0 for r in res.values())
           or "all kernels dispatch and match their references" not in reg
           or any(f"'{k}': " not in launched for k in hand)
           or not any(ln.startswith("done.")
                      for ln in res["train_lm"]["lines"])
           or not any(ln.startswith("nothing to do: checkpoint already at "
                                    "step 20")
                      for ln in res["train_lm_again"]["lines"])
           or "restored step 20" not in res["quickstart"]["lines"]
           or sum(ln.startswith("request ")
                  for ln in res["quickstart"]["lines"]) != 3
           or not any(ln.startswith("served 8 requests")
                      for ln in res["serve_batched"]["lines"]))
    if bad:
        fail("[22c] an example failed: see the lines above")
    shutil.rmtree(ckpt, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t0
    return res


def dryrun_phase(torch, card, census_job, tp_train, fsdp_tp, measured):
    """Phase 22 (see the module docstring): the census worker's counts
    held to phases 19 and 21 (22a), its modeled steps beside the
    measured ones (22b), the examples (22c)."""
    t0 = time.perf_counter()
    res = {"examples": examples_phase(card)}
    proc, out_path = census_job
    proc.join(timeout=CENSUS_WAIT_S)
    if proc.is_alive():
        proc.kill()
        fail(f"[22] the census worker ran {CENSUS_WAIT_S} s past phase 21")
    if proc.exitcode != 0 or not os.path.exists(out_path):
        fail(f"[22] the census worker failed (exit code {proc.exitcode})")
    with open(out_path) as fh:
        census = json.load(fh)

    rows, bad = {}, False
    cells = [(TP_TRAIN_RUNS[w][0], census["19"][w], tp_train[w],
              {"model": "wire"}) for w in TP_TRAIN_RUNS]
    cells.append(("21", census["21"], fsdp_tp,
                  {"data": "data_wire", "model": "model_wire"}))
    for tag, cen, got, groups in cells:
        wire = {g: [list(w) for w in got[key]] for g, key in groups.items()}
        ok = (all(w == cen["wire"][g] for g in groups for w in wire[g])
              and all(b == cen["state"] for b in got["state_bytes"]))
        rows[tag] = {"census": cen, "measured": {"wire": wire,
                                                 "state": got["state_bytes"]},
                     "equal": ok}
        line = (f"[22a] {tag}: census of rank 0 on the abstract mesh "
                f"({cen['census_s']:.1f} s on the host) against the ranks' "
                f"measured step: calls and bytes a step "
                f"{ {g: cen['wire'][g] for g in groups} } against "
                f"{wire}; params plus optimizer state a rank "
                f"{cen['state']} B against {got['state_bytes']}: equal "
                f"{ok} [{card}]")
        print(line, flush=True)
        bad = bad or not ok
    res["census_vs_measured"] = rows
    if bad:
        fail("[22a] a census differs from the measured step: see above")

    ratios = {}
    for tag, mod in census["modeled"].items():
        run = measured[tag]
        step_ms = run["step_ms_p50"]
        busy_ms = run["profile"]["device_busy_ms"]
        peak = run["peak_mem_gb"] * 1e9
        ratios[tag] = {
            "modeled_step_ms": mod["step_s"] * 1e3,
            "measured_step_ms": step_ms, "device_busy_ms": busy_ms,
            "step_over_modeled": step_ms / (mod["step_s"] * 1e3),
            "busy_over_modeled": busy_ms / (mod["step_s"] * 1e3),
            "live_peak_bytes": mod["peak_live_bytes"],
            "max_memory_allocated": peak,
            "allocated_over_live_peak": peak / mod["peak_live_bytes"],
            **{k: mod[k] for k in ("name", "layers", "seq", "batch",
                                   "dominant", "compute_s", "memory_s",
                                   "flops", "tc_flops", "op_bytes",
                                   "launches", "census_s")}}
        r = ratios[tag]
        print(f"[22b] {mod['name']} ({mod['layers']} layers, {mod['seq']} x "
              f"{mod['batch']}, one device): census_step modeled on the "
              f"card's spec {r['modeled_step_ms']:.2f} ms ({mod['dominant']}"
              f"-bound: compute {mod['compute_s'] * 1e3:.2f} ms, memory "
              f"{mod['memory_s'] * 1e3:.2f} ms over every op's bytes; "
              f"{mod['launches']} launches) against the measured step "
              f"{step_ms:.2f} ms (p50; ratio {r['step_over_modeled']:.3f}) "
              f"and device busy {busy_ms:.2f} ms (ratio "
              f"{r['busy_over_modeled']:.3f}); live-byte high-water mark "
              f"{mod['peak_live_bytes'] / 1e9:.3f} GB against "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB (ratio "
              f"{r['allocated_over_live_peak']:.3f}) [{card}]", flush=True)
    res["modeled_vs_measured"] = ratios
    res["census_worker_s"] = census["worker_s"]
    res["phase_s"] = time.perf_counter() - t0
    print(f"[22] phase 22 ran {res['phase_s']:.1f} s (22c "
          f"{res['examples']['phase_s']:.1f} s; the census worker's "
          f"{census['worker_s']:.1f} s beside phases 3-21) [{card}]",
          flush=True)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
