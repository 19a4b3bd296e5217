#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases; any failure is an uncaught exception and a non-zero exit:

1. setup — require CUDA, print the card's name and power limit
   (nvidia-smi), build every CUDA kernel of the serving and training
   paths from the sources in the checkout (one nvcc per source, all
   started together, beside them ``nvcc -Xptxas -v`` of
   flash_attention.cu, flash_decode.cu, fused_ce.cu and fused_decode.cu)
   and print the build seconds, then the registers, spills, threads and
   shared memory of each flash-attention instance, of flash_decode's
   split-KV, merge and tensor-core instances, fused_ce's bf16 kernel and
   merge, and fused_decode's four storage-mode instances (dynamic shared
   memory at gpt3_1p3b).
2. kernels (serving) — hold ``flash_decode`` against its plain PyTorch
   version on the card at the serving path's shapes (float32 at atol
   1e-4; bf16 per element, see below), each row naming the instance the
   call ran (split-KV with its split count, tensor cores, or query
   tiles: ``flash_decode.kernel_plan``); time the
   kernel, the plain version and ``F.scaled_dot_product_attention``
   with an explicit boolean mask (the yardstick, never called by the
   port), and compute each shape's bound from the bytes and operations
   its inputs need.  Then the paged layout and the int8/fp8 storage
   modes at the decode shape (B 8, T 1024, 16 heads of 128, q bf16,
   block size 64, a shuffled block table with -1 tail pages): paged
   decode in bf16, int8 and fp8, paged verify (W 4), contiguous decode
   in int8 and fp8, each held per element to its plain version and
   timed beside SDPA on the gathered, dequantized bf16 K/V (gather and
   dequantization untimed); and in each mode a paged call over an
   identity table must equal the contiguous kernel bit for bit.
2a. row_gemm (``row_gemm_phase``) — the decode block's products at
   gpt3_1p3b's shapes (qkv, proj, fc1, fc2 bf16; the tied head from
   ``wte.t()`` with float32 output) for M 8, 32, 64, 128 and 256: each
   row bit for bit the same at M 1 to 257 (group and chunk edges),
   permuted and across 256-row launches (520 rows) as in one 256-row
   call; held to its plain version and to the float32 product
   (``row_gemm_check``: float32 sums of K products within 2 K 2^-24
   (|x| @ |w|) of each other, bf16 output one rounding more, 2^-8 of the
   product; against cuBLAS's bf16 output one step of the element and of
   the output's rms); timed over rotating weight copies beside the plain
   version, ``torch.matmul`` and the byte bound, with the plan on the
   card (units an SM, cluster size, stages), the instance's registers
   and shared memory, and the host time of one call; the float32
   instance at gpt_tiny's shapes (checks only).
2b. sampling kernel (``sampling_kernel_phase``) — the sampler
   (``csrc/sampling.cu``: temperature, top-k, top-p with exact
   thresholds and a keyed Gumbel-max draw on JAX's threefry stream, one
   launch on raw logits) against its plain version (the torch filter
   and ``models/prng.py`` on CUDA tensors) at [8, 50304] (a decode
   step, seeds and positions a slot), [32, 50304] (a k 3 verify pass, 4
   window rows a slot), [4, 32000] and [8, 50304] (LLaMA and GPT
   ``generate``: one key over the draw), 10 times each with fresh
   N(0, 9) logits and keys under six settings (the serving one,
   temperature alone, top-p alone, top-k alone, top-k at V, top-p
   1e-6): 3120 rows, the kernel's token the plain draw over the exact
   rule's kept values or a draw near-tie (perturbed scores within
   2e-6), kept sets the float filter's or a top-p near-tie (mass within
   n 2^-24 of top_p), both counted; edge rows exact; every row drawn
   alone equal to the same row among R 8 / 32 / 64; times over
   rotating logits beside the plain version and ``torch.argmax`` (a
   reading floor: no PyTorch call draws JAX's stream), with the bound:
   bytes against the SASS-counted clocks of the work the function needs
   (a division, a key and a histogram step a logit, a compare a logit
   under a filter, a mass a value under top-p, the draw a kept value).
3. kernels (training) — the flash-attention forward, dK/dV and dQ
   kernels against their plain versions at the training shape (B 8,
   S 1024, 16 heads of 128, bf16, causal, q/k/v strided slices of a
   packed qkv) and at float32 ([2, 1024, 16x128]; ragged S 1000, hD
   64), non-causal and ragged bf16 cases; ``fused_ce_fwd`` at N 8192,
   V 50304, H 2048, bf16, with labels out of range (the tensor-core
   kernel split over the vocabulary, then its merge; one launch count),
   and its float32 instance at N 2048.  float32 outputs are held at
   1e-4 of the largest reference value, lse and z/picked at atol 1e-3;
   the float32 flash forward, dK/dV and dQ and CE (three TF32 products
   a product on the tensor cores) also against their own arithmetic
   (``flash_attention_{fwd,bwd_dkv,bwd_dq}_tf32x3_plain``,
   ``fused_ce_fwd_tf32x3_plain``: TF32X3_REL of max, TF32X3_ATOL), with
   both bounds (the TF32 rate x 3, the CUDA cores') and both shares;
   then ``tf32_witness``: inputs on which one TF32 pass leaves those
   limits and the kernels do not (forward, backward and CE); then,
   reported only, the float32 forward's share of TF32X3_REL at S 2048
   and 4096 and at hD 64 (``tf32x3_forward_drift``).  Yardsticks:
   SDPA (``is_causal``) forward and its autograd backward;
   ``matmul_f32out`` + ``torch.logsumexp`` (two calls).  Each flash
   time has its achieved TFLOP/s and share of the bound beside it.
   The attention kernels (bf16 on the tensor cores, P and dS carried as
   two bf16 halves; float32 as three TF32 products) and their plain versions
   both keep P and dS to float32 precision and round once, so each bf16
   element is held to |got - want| <= 2^-7 |want| + 1e-3: one rounding
   step of the reference value, plus room for float32 summation order
   near zero.  Then, reported and not asserted, why P is not rounded to
   bf16 once as in the TPU kernels: the backward with P and dS rounded
   once, computed in float32 and in float64 at the training shape, and
   the share of that per-element limit their difference takes.
4. reference — the serving engine on the card against the CPU engine
   (gpt_tiny f32, identical greedy streams); at kv_dtype bf16, int8 and
   fp8, the paged engine (block size 8, a pool of 18 pages, so
   admissions defer and a slot is evicted) and the contiguous engine on
   the card, with the flash kernels, against the CPU paged and
   contiguous engines: identical streams; then three train steps of
   gpt_tiny f32 on the card (flash kernels) against the CPU (plain
   versions) at (num_micro 1, remat False) and (2, True): losses at
   rel 1e-4, the float32 flash kernels' launches counted; then the eval
   loss on the card (one float32 ``fused_ce_fwd`` launch) against the
   CPU's at rel 1e-4.
4a. speculative reference (``speculative_reference_phase``) — greedy
   speculative decoding, k 3, gpt_tiny f32 target with four drafts (a
   smaller GPT, a LLaMA with GQA whose RMSNorms run the ``rms_norm``
   kernel, the target itself, n-gram) on the contiguous and the paged
   engine (18 pages: evictions re-prefill the draft), and the fused
   engine on a tiny bf16 int8-weight model (GPT draft, n-gram): every
   card stream equal to the card's non-speculative stream and to the
   CPU's; launches exact (flash_decode L a target decode step, verify
   round and prefill, the draft's layers a draft step and draft
   prefill; fused_decode once a decode step and a verify position; the
   RMS norm alone once and its fused residual-add instance 2 L times a
   LLaMA draft step).
4b. prefix reference (``prefix_reference_phase``) — the prefix cache on
   gpt_tiny f32 (int8 weights for the fused engine): a primer, then a
   shared-prefix load with hits, partial hits and a full hit on the
   contiguous, paged and fused engines: the warm card streams equal the
   cold card streams and the CPU's, with the CPU's hits.
4c. sampled reference (``sampled_reference_phase``) — seeded sampling
   (temperature 0.8, top-k 20, top-p 0.95, seeds a request) on gpt_tiny
   f32 (contiguous, paged with 18 pages) and the tiny int8-weight fused
   model, at steps_per_sync 1 and 8 and with n-gram and model drafts:
   every card and CPU stream equal to the CPU plain stream, or first
   different at a reported near-tie; the sampler launched once a decode
   step and a verify pass on the card, never on the CPU.
5. serving — gpt3_1p3b at full width (24 layers, H 2048, 16 heads of
   128, V 50304, bf16, random weights from seed 0) behind
   ``ContinuousBatchingEngine(max_batch=8, max_len=1024,
   attn_kernel="flash")``: 12 requests with seeded prompt lengths
   32-700 and max_new 32, all DONE with 32 tokens; the kernel's launch
   count, reset just before, must equal 24 per decode step (all on the
   split-KV instance) plus 24 per prefill program (all on the tensor
   cores), and row_gemm's 97 per decode step (4 a layer and the head).
   Then one ``decode_step_multi`` at that width,
   "flash" against "xla", logits finite and within atol 0.25, and a
   profile of where a decode step's time goes.  The same 12 requests
   then go through ``PagedContinuousBatchingEngine(block_size=64)``
   with its default pool of 64 pages at kv_dtype bf16, int8 and fp8,
   through the contiguous engine at int8 and fp8, and through the paged
   engine at bf16 with 26 pages (admissions defer, a slot is evicted).
   Counts reset before each run: 24 launches of the paged layout per
   decode step and 24 of the contiguous one per prefill program (the
   contiguous engine: 24 per decode step too), in the run's storage
   mode, decode steps on the split-KV instance and prefills on the
   tensor cores; every request DONE with 32 tokens, every page back in the
   pool; agreement with the contiguous bf16 streams is reported, not
   asserted (bf16 near-ties, other GEMM shapes).  Then one paged decode
   step per kv_dtype, flash against xla, within atol 0.25, profiled.
5a. speculative serving (``speculative_serving_phase``) — k 3 at that
   width and load: the row check (each verify row's logits against a
   decode step at the same position on a copy of one cache: largest
   |delta|, rows not bitwise equal; contiguous bf16, paged bf16 and
   int8) with one verify pass, one decode step and one self-draft round
   profiled; the contiguous and paged bf16 engines with n-gram and with
   the target as its own draft, the paged int8 engine with n-gram:
   launches exact, every request DONE with 32 tokens, decode-loop tok/s,
   acceptance, tokens per launch and rounds beside the plain run; gates:
   the row check's rows and cache elements all bitwise equal (the
   decode block's products run ``row_gemm``, the same bits at any M),
   every stream equal to the plain run's (a difference is logged with
   the target's top-2 margin there and fails the phase), a self-draft
   round from the row check's state accepting every draft (the engines'
   self-draft acceptance is reported: a fully accepted round leaves the
   draft cache one row short, as in JAX); ``FusedB1Engine``
   (int8 weights, 3 requests x 32) plain and with n-gram: equal streams
   (a gate) and ``verify_fused`` equal to the fused decode steps bit
   for bit, both profiled.
5b. prefix serving (``prefix_serving_phase``) — the device prefix cache
   at that width: a primer, then 12 requests sharing a 512-token seeded
   prefix (tails 16-128, 32 new tokens) through the contiguous engine
   (bf16) and the paged engine (64-token pages, budget 24 pages) at bf16
   and int8, cold and warm, and the fused engine (int8 weights, 3
   requests): every warm request hits the prefix; launches exact
   (flash_decode L a decode step, prefill and suffix pass, row_gemm
   4 L + 1 a decode step and 4 L a suffix pass; fused_decode once a
   decode step and a suffix token); TTFT cold against warm, hit tokens,
   shared pages; warm streams equal cold, or each difference at a
   near-tie (the cold path's top-2 margin within the warm/cold logit
   |delta| of one prompt).
5c. sampled serving (``sampled_serving_phase``) — the serving phase's
   12 requests with seeds 1-12 at temperature 0.8, top-k 20, top-p 0.95
   through the contiguous and paged bf16 engines, plain and n-gram k 3:
   sampler launches exact (one a decode step or verify pass), decode-loop
   tok/s of 4 sampled runs against 4 greedy runs of a greedy engine, in
   turns (the median of the pairs' ratios), repeated sampled runs
   drawing the same streams, speculative streams equal plain bit
   for bit, two seeds of one prompt diverging; one sampled decode step
   (no topk, sort, cumsum or softmax kernel in it), one draw (one
   kernel) and the draw alone profiled (family "sampling").
5d. compiled serving (``compiled_serving_phase``) — every serving
   engine runs its decode rounds, verify passes and draft proposals as
   CUDA-graph replays by default (``cuda_graphs=None``), phases 4-5c
   included; here the serving cell's 12 requests (the fused engine: 3)
   go through a captured engine and a ``cuda_graphs=False`` one in
   turns (two warm runs, then 3 pairs, eager first, then captured
   first) on contiguous bf16, paged bf16 and int8, fused b1 int8,
   sampled contiguous bf16 and n-gram k 3 on contiguous bf16 and on the
   fused engine: every run's streams equal the first eager run's (12/12,
   fused 3/3), each pair counts the same launches of every kernel, each
   captured round is one replay; the median decode-loop tok/s, wall a
   round and a token, programs, capture seconds and pool bytes; then
   steady rounds of each engine (8 slots decoding, 1 on the fused
   engine; 4 timed, 1 profiled): wall and device ms a round, device ms a
   step, idle share, kernels and host CUDA calls a round.
5e. serving faults (``serving_faults_phase``) — robustness and lifecycle
   on 5d's captured engines (contiguous bf16, paged bf16, sampled
   contiguous, n-gram k 3, fused b1 int8) and a contiguous engine with a
   2-layer model draft and the prefix cache, every count of flash_decode,
   row_gemm, fused_decode and sampling set to 0 before and each > 0
   after: ``fail_times=2`` on prefill, decode, verify, draft and prefix
   calls and ``fail_after_times=1`` on decode and verify leave every
   stream equal to the fault-free one bit for bit, with the fault-free
   prefill counts; cancel after the first round and a TTL that expires
   mid-decode leave the next occupants' streams exact and the page pool
   whole; ``fail_always`` on prefill with the breaker at 2 fails every
   request fast, submit raises CircuitOpenError, ``reset_circuit()``
   serves exactly again; a real device stall (``torch.cuda._sleep``, 4x
   ``step_timeout=0.5``) in every decode call trips the deadline and
   ``drain(60)`` returns every request FAILED, and one in a prefill's
   work trips the next decode call's deadline, retried to the exact
   stream.  The funnel's host µs a call, without and with the watchdog.
   ``--phases serving_faults`` runs it alone (its engines built and
   warmed there).
5f. tiered serving (``tiered_serving_phase``) — the prefix cache's host
   tier at that width: the prefix load (a 512-token prefix, a primer,
   12 requests with tails of 16-128, 32 new) on contiguous bf16, paged
   bf16, int8 and fp8, and fused b1 (int8 weights, int8 cache, 3
   requests), each cold, device-warm and host-warm (the device budget
   half a span, the host tier 2 GiB; ``tiered_cell``): host-warm
   streams equal device-warm bit for bit and cold's under the near-tie
   rule; every host-warm request a host hit, none left INSTALLING;
   flash_decode, row_gemm and fused_decode counts set to 0 before the
   host-warm load and exact after; the same captured programs as
   device-warm; the page pool whole, and free once the trie is cleared.
   On contiguous and paged bf16 (``tier_fault_checks``): a slow copy
   (``defer_ready=3``), a reinstall that always fails, one past
   ``install_timeout`` and a cancel mid-install keep the streams and
   free the slot.  A span's demotion ms and bytes, its reinstall copies'
   GB/s beside a pinned ``copy_`` of the same bytes
   (``tier_copy_rates``), mean TTFT cold / device-warm / host-warm,
   reinstall seconds and the decode seconds that overlapped them, and
   the decode tok/s of captured 8-slot rounds with and without a
   reinstall's copies in flight, whole and in 8 MiB chunks, each also
   less the host seconds of issuing the copies (``tier_overlap_tok_s``).
5g. handoff serving (``handoff_serving_phase``) — the load on a
   contiguous bf16 donor snapshotted after 8 rounds
   (``inference.handoff``) and restored into a fresh contiguous engine
   and a paged one, and a fused donor into a fused engine
   (``handoff_cell``): streams equal the uninterrupted run's, or each
   difference at a near-tie, counted; a warm restore runs fewer
   prefills than a cold restart (no prefix cache); the bundle's bytes,
   snapshot and restore seconds, the carried requests' next-token
   seconds warm and cold; a truncated bundle is quarantined and its
   restore falls back to a cold start that serves.  ``--phases
   tiered_serving,handoff_serving`` runs 5f and 5g alone.
6. training — gpt3_1p3b bf16 at full width through
   ``hybrid.build_train_step(num_micro=1, remat=False)``, B 8, S 1024,
   float32 AdamW moments, one warm step then 4 steps under
   ``TrainLoop(max_inflight=2)`` on one seeded batch: every loss finite,
   step 5 below step 1, and 24 launches per step of each flash kernel
   (counts reset just before).  Step ms, tokens/s, peak memory and a
   one-step profile by kernel family.  Then the eval loss
   (``gpt.loss_fn`` under no_grad: exactly one ``fused_ce_fwd``
   launch) and one ``remat=True`` step (48 forward launches), both held
   to the differentiated no-remat loss at those params (atol 2e-3: the
   same bf16 hidden states, float32 logits, another summation order).
   Against the plain softmax composition (``use_flash=False``, which
   rounds P to bf16 and launches no flash kernel): its no-grad loss at
   those params and its loss at the
   seed-0 init (atol 2e-3), its gradients there (each leaf's
   ||g_flash - g_plain|| within 5e-2 of ||g_plain||), and its own
   5-step trajectory from that init (each loss within 1e-2 of the flash
   run's).
6a. float32 training (``float32_training_phase``) — gpt3_1p3b at its
   default dtype (float32, ``use_flash=None``: the float32 flash
   kernels and the float32 ``fused_ce_fwd``) at full width, B 2, S 1024,
   1 warm + 4 AdamW steps through ``TrainLoop`` (the loss must fall; 24
   launches of each flash kernel a step), then the no-grad eval loss
   (one ``fused_ce_fwd`` at N 2048, 24 forward launches) with its
   per-token (z, picked) held to ``fused_ce_fwd_plain`` on the same
   hidden states (atol 1e-3); TF32 matmuls must be off.  Step ms (host
   clock and CUDA events), peak memory, a step's and an eval's device
   ms by family (flash forward, dK/dV, dQ, fused_ce, GEMMs, other) and
   idle share.  ``--phases train_kernel,ring_kernel,float32_training``
   runs phases 3, 11 and 6a alone (or any of them; two sources built);
   ``--phases compiled_serving`` phase 5d alone (four sources),
   ``--phases serving_faults`` phase 5e (the same four).
7. b1 int8 serving — the serving weights quantized by the port
   (``gpt.quantize_decode_params``).  ``fused_decode_layers`` against
   its plain version in four storage modes (an f32 cache at gpt_tiny
   width; bf16, int8 and fp8 at gpt3_1p3b) at positions 0, 1, 7, 8,
   255, 256, 257, 511, 700 and 1023 of a seeded T 1024 cache (the
   attention items' edges among them): h_out row 0 within 2^-6
   of its largest value, the written rows within one step of their
   storage (bf16 step, int8 quantum, e4m3 step) plus 2^-16 of the row's
   largest value for the float32 sum order — layer 0 held to that, its
   int8 scales to 1e-5; layers >= 1 add 2^-7 of the row's largest value
   (the hidden state's own difference, carried through 24 layers, see
   ``_fused_errors``) and their scales 2^-7 — every other row bit for
   bit; the plain version on the card against the CPU at 24 layers (the
   witness of that carried difference); the kernel's time at positions
   64, 512 and 1023 beside the byte bound and its share, the plain
   version's at 512, the grid (blocks x threads), the ring's stages and
   the grid barriers of a token as the kernel counted them (at most 6 a
   layer).
   Then ``FusedB1Engine`` on the card against the CPU one (gpt_tiny f32,
   int8 weights, bf16/int8/fp8 caches: identical streams, one fused
   launch per decode step), and at full width: the serving workload's
   first 3 requests (601, 458, 373 tokens, max_new 32) through
   ``FusedB1Engine(max_len=1024)`` and the per-op int8
   ``ContinuousBatchingEngine(max_batch=1)`` at each kv_dtype, with
   exact launch counts (fused_decode once per decode step, flash_decode
   24 per prefill only), stream agreement reported; one step of each at
   pos 601 on a shared cache, profiled, and the per-op step timed (no
   single library call computes a layer stack: it stands in for one).
8. RMSNorm — the ``rms_norm.cu`` kernels in both rounding policies
   ("fused", the TPU kernel's; "llama", the LLaMA path's), float32 and
   bfloat16, at [8, 4096], [2048, 4096], [8, 128], [7, 11008] and
   llama_7b training's [8192, 4096]: the forward against
   ``rms_norm_plain`` (float32 per element within 1e-6 |want| + 1e-7,
   bfloat16 equal or one step apart on at most 1e-3 of the elements,
   rstd within 1e-6 relative), also through a row stride; the fused
   residual-add instance bit for bit ``h + delta`` and the forward
   kernel on it, its backward with g_s bit for bit T(dx + g_s); the
   backward against ``rms_norm_bwd_plain`` (``_rms_bwd_errors``: dw one
   bf16 step, dx one step of max(|dx|, ``_rms_bwd_floor``): 2 |g w
   rstd| for "llama", 2^-8 of the float32 terms' scale for "fused").
   Each timed
   beside its plain version, its byte bound and share, and a library
   yardstick: ``F.rms_norm``; ``h + delta`` then ``F.rms_norm`` (two
   calls); ``F.rms_norm``'s autograd backward.  Then the LLaMA path's
   attention kernels at the shapes llama_7b gives them (32 heads of 128,
   bf16, unpacked q/k/v), per element at the limits of phase 2/3:
   ``flash_attention_fwd`` at generate's prefill (B 4, S 512, causal),
   ``flash_decode`` at the slot loop's decode step (B 8, T 1024, ragged)
   and at its longest ``prefill_into_slots`` (B 1, W = T = 600, pos 0).
9. LLaMA reference — llama_tiny (GQA 4/2) float32 at
   initializer_range 0.3: ``generate`` and the slot loop
   (``llama_slot_loop``, kv_dtype bf16 and int8) on the card's kernel
   route give the CPU plain route's greedy streams, launches exact.
10. LLaMA serving — llama_7b at full width (32 layers, H 4096, 32 heads
   of 128, FFN 11008, V 32000, bf16, seed 0) after the GPT trees are
   freed: ``generate`` of 4 x 512 tokens, 32 new, and the slot loop over
   8 prompts (32..700 tokens, max_len 1024, 32 new, "flash"), with exact
   launch counts (RMS: the norm alone once and the fused residual-add
   instance 64 times a forward pass, once and 63 times a
   ``prefill_into_slots``; flash_attention_fwd 32 a generate prefill;
   flash_decode 32 a slot decode step or ``prefill_into_slots``); prefill
   ms, decode tok/s, one 8-slot step profiled (and its norms and
   residual adds: device ms and launches, ``norm_add_profile``), cache
   bytes, peak memory; the plain route on the same weights (streams
   reported), and both routes' first-step logits against the same steps
   in float32: the
   kernel route's largest error within 1.5 x the plain route's; beside
   it, negative controls (the kernel route with a fault injected around
   a wrapper: K/V heads rolled, attention zeroed, layer 0's first
   RMSNorm in the "fused" policy, flash_decode's newest row dropped)
   read against the same steps: each attention fault must break the
   bound (the RMS one, a rounding-level fault, is reported).
11. ring kernels — the ring variant of flash attention (a run-time q
   offset: key j visible to query i iff j <= i + offset) at one ring
   chunk of llama_7b (B 1, 1024 queries and keys, 32 heads of 128,
   causal), bfloat16 and float32, offsets -1024 (every row fully
   masked), -37, 0, 37, 1024 and 3072, and at the shape phase 15 gives
   it (llama_7b training, B 4, S 2048, bf16) at offsets 0, -37 and 37:
   forward, dK/dV and dQ (with an lse cotangent folded into delta) held
   per element to their plain versions at the limits of phase 3, lse at
   atol 1e-3, offset 0 bit for bit to the same kernels under
   ``flash_attention``'s entry, float32 also against the tf32x3
   emulations (TF32X3_REL); times beside the plain versions and
   SDPA with the offset's boolean mask (forward, autograd backward; at
   offsets >= 0 only; at the training shape and offset 0 also SDPA
   ``is_causal``, its flash backend), bounds from the visible pairs
   (bytes where none; float32 both: the TF32 rate x 3, the CUDA
   cores'), achieved TFLOP/s and share of the bound.
12. ring replay — the 4 ranks of a 4-way ring over 4096 positions on one
   card through ``ring_attention_loop`` with a local hand-over, 16
   launches of each offset kernel: the outputs and dq/dk/dv of one
   backward against dense ``flash_attention`` over 4096 (float32 within
   1e-4 of the largest value; bfloat16, whose dK/dV sum across ranks in
   bf16 as in JAX, within 2^-6 in norm and 2^-4 of the largest value);
   both timed.
13. LLaMA training reference — llama_tiny (GQA 4/2) float32 through
   ``build_train_step(model=llama_stage_model(cfg, remat))``: three
   steps on the card (flash and RMS kernels) against the CPU (plain
   versions) at remat False and True, losses at rel 1e-4, launches
   exact.
14. LLaMA training — llama_7b's width (H 4096, 32 heads of 128, FFN
   11008, V 32000, untied head, bf16, seed-0 weights) with the depth
   cut to 8 layers (1.88 B parameters; float32 AdamW moments make
   ~22.6 GB of state): at the init, the kernel route's loss and
   gradients against the plain compositions' (``use_flash=False``) on
   one sequence (atol 2e-3; each leaf within 5e-2 in norm); then B 4,
   S 2048, one seeded batch, 1 warm + 4 steps through
   ``TrainLoop(max_inflight=2)`` (the loss must fall; launches exact:
   each flash kernel 8 a step; RMS a step: the norm alone once, the
   fused residual-add instance 16 times, the backward 17 times), step
   ms, tokens/s, peak memory, a profile by family (flash fwd, flash bwd,
   GEMMs, RMS fwd, RMS bwd, other) with the optimizer timed alone; one
   ``remat=True`` step; the RMS "llama" backward at [8192, 4096] bf16
   against the same call on the CPU (dw one bf16 step per element; dx
   one step of the larger of the element and twice its first addend,
   see ``rms_backward_check``), both kernels' time under autograd and
   the backward kernel's alone beside the plain versions'.
15. LLaMA sequence parallel — ``llama.loss_fn(sp_group=g)`` on a real
   one-rank NCCL group at that config (the ring at P = 1: the offset
   kernels, 8 launches each) against ``loss_fn`` without a group: loss
   within 1e-6 relative, each gradient leaf within 1e-3 in norm; a
   first call sets up the communicator, the second is counted and timed.
15a. the rest of the one-device train step, gpt3_1p3b
   at full width (H 2048, 16 x 128, V 50304, bf16 weights, float32
   moments, seed 0), batches from a seeded host loader (batch i made
   from seed + i) through ``io.prefetch_to_device`` and ``TrainLoop``:
   * remat plans (``remat_plans_phase``): 24 layers, B 8, S 1024, one
     warm and four timed steps under False, True, dots_saveable,
     dots_saveable_attn and partial:12: losses equal False's within
     LOSS_TOL; flash forward launches a step L, 2L, 2L, L, L, the dK/dV
     and dQ kernels L each under every plan; step ms, tokens/s, peak
     memory, the idle share of a profiled step;
   * remat fit (``remat_fit_phase``): B 32, where remat False is
     predicted not to fit: True, then partial:K with the fewest
     rematted layers K that the B 8 peaks predict within 90 % of the
     card (every byte above the states scaled by 4); tokens/s and the
     measured peak beside the predicted one;
   * prefetch (``prefetch_phase``): the B 8 remat-False step fed by
     ``prefetch_to_device(depth=2)`` against a synchronous ``.to``, in
     turns (sync, prefetch, prefetch, sync): the first run of each mode
     profiles its first two steps (H2D seconds, the copies' overlap
     with kernels, the idle share), then every run times four steps by
     the host clock alone (step ms); H2D bytes of each;
   * training checkpoint (``train_checkpoint_phase``): 4 layers (about
     0.31 B elements, about 3.1 GB on disk; 24 layers would be about 13
     GB on disk and more than twice that in host memory while
     pickling): an ``AsyncCheckpointer`` save after step 2, steps
     beside its commit until it is done, a second save (into the
     first's pinned buffers) and steps beside its commit; each step's
     host dispatch, card ms and wall against the commit's parts (wait,
     pack, write, metadata), the save steps' ms, save
     lag, commit seconds and GB/s, bytes on disk; the verify walk and
     the load of the newest step into a fresh state, bit for bit (their
     seconds); a flipped byte in that step is quarantined and
     ``load_latest`` loads the first bit for bit;
   * preemption (``preemption_phase``): the 4-layer model at partial:2
     under ``torch.use_deterministic_algorithms(True)`` and
     ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: an uninterrupted 10-step run
     here (while the first process below starts and builds), and two
     processes of this script that import only the port and share a
     fresh ``PT_COMPILE_CACHE_DIR``: the first trains under
     ``PreemptionGuard`` with an ``AsyncCheckpointer`` every 2 steps,
     sends itself SIGTERM after step 5 and must exit 143 with the marker
     at the step ``ElasticInterrupt`` reported; the second resumes
     (``resume_step`` / ``load_latest``) and trains to step 10.  Its
     losses and final params equal the uninterrupted run's bit for bit,
     and it runs no nvcc (both processes' build counts and seconds).
15b. BERT and CTC (``--phases bert_kernel,bert_training,bert_float32,ctc``):
   * bert kernels (``bert_kernel_phase``): the three flash kernels at
     bert_large's attention, non-causal at head dim 64, bf16 [16, 512,
     16x64] (the bench shape) and float32 [4, 512, 16x64], each held to
     its plain version at the limits above, timed against its bound and
     SDPA non-causal (forward, and its autograd backward); the hD-64
     instances' registers, spills and shared memory; the MLM head's
     float32-output product of the bias fold, [8192, 1025] x [1025,
     30522] bf16, with 1025 features and zero-padded to 1032, both
     timed, the head loss forward + backward at each;
   * bert training (``bert_training_phase``): bert_large in bf16 (24
     layers, H 1024, 16 x 64, V 30522, seed 0), MLM + NSP, AdamW,
     through ``build_train_step(model=bert_stage_model)`` with dict
     labels, ``TrainLoop`` and ``prefetch_to_device``, B 16, S 512 (one
     seeded batch, MLM labels on ~15 % of the positions): 1 warm + 4
     timed steps (the loss must fall; each flash kernel 24 times a
     step), step ms, tokens/s, peak memory, a profiled step split into
     flash, GEMMs outside the head, the MLM head (its forward + backward
     alone), AdamW (alone, CUDA events) and other, with the idle share;
     one step each under remat True (48 forward launches) and
     dots_saveable_attn (24), first loss at LOSS_TOL of remat False's;
     4 layers, ``use_flash=None`` against ``use_flash=False`` (no flash
     launch), 1 warm + 3 steps from one init, losses within
     BERT_PLAIN_TOL;
   * bert float32 (``bert_float32_phase``): bert_large at its default
     float32 (the TF32x3 flash kernels), 4 layers, B 4, S 512, 1 warm + 4
     steps against the same run through the plain composition, each
     loss within BERT_F32_LOSS_REL, step ms and a profiled step;
   * ctc (``ctc_phase``): ``nn.functional.ctc_loss`` at bench_ctc's card
     shape (T 500, B 32, L 100, C 80): loss and gradient against the CPU
     run of the same code (CTC_LOSS_REL, CTC_GRAD_REL), forward +
     backward seconds and sequences a second, a profiled call's idle
     share.
16. the seconds of each phase, the kernels line (flash_decode in each
   layout and storage mode that the serving runs launch, row_gemm, the
   training kernels, fused_decode in each storage mode, rms_norm's
   forward, fused residual-add instance and backward in each policy,
   the ring variant's three kernels, ``flash_attention_with_lse_*``,
   with launches from phase 15 and times at its shape; the float32
   instances of the flash and CE kernels beside their bf16 rows
   (launches from phase 6a, both bounds, the witness), and
   the speculative runs' launches and verify times beside rows 1, 2
   and 9; the sampler, launches from the sampled contiguous run; beside
   the flash rows, bert_large's launches a step and times at its
   non-causal hD-64 shapes, bf16 and float32)
   and, last, the device line.

TF32 is off for every matmul (``allow_tf32 = False``), so float32
parity is not loosened by the card's TF32 mode.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,            # dense tensor-core bf16
            "float32": 67e12,              # CUDA-core float32
            "tf32": 495e12}                # dense tensor-core TF32
SERVE_TOL = 0.25                           # flash vs xla logits, bf16
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3       # kernel vs plain, per element
F32_REL = 1e-4                             # training kernels, f32, of max
LOSS_TOL = 2e-3                            # eval / remat vs no-remat loss
PLAIN_GRAD_REL = 5e-2                      # flash vs plain composition,
PLAIN_TRAJ_TOL = 1e-2                      # per gradient leaf; 5 losses
HOST_LEAD_CYCLES = 2_000_000               # ~1 ms of device sleep


#: where ``--out`` keeps every logged line as it is printed (a run that
#: fails midway keeps the phases before the fault)
_LOG_FILE = None


def _log(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if _LOG_FILE is not None:
        with open(_LOG_FILE, "a") as f:
            f.write(line + "\n")


def _time_ms(fn, reps=20, flush=None):
    """Median of per-call CUDA-event times; ``flush`` (a large buffer)
    is rewritten before each call so the inputs start cold in L2.  A
    device-side sleep queued before the start event keeps the card busy
    while the host enqueues the call, so the time is the call's device
    time, not the host's dispatch latency (which otherwise lands inside
    the events whenever the card waits for the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _nvidia_smi(query):
    """First card's ``nvidia-smi --query-gpu=<query>`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


PTXAS_SOURCES = ("flash_attention", "flash_decode", "fused_ce",
                 "fused_decode", "row_gemm", "sampling")


def _flash_ptxas_start(build, sources=PTXAS_SOURCES):
    """Start ``nvcc -Xptxas -v`` on each of ``sources`` with the
    build's own flags, beside the build (the libraries are thrown away):
    {source: (process, library path)}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        out = build.BUILD_DIR / f"{name}_ptxas.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out), str(build.CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs


# mangled names: the float32 kernels on TF32 <hD>, the bf16 tensor-core
# kernels <hD, warps>
FLASH_KERNEL = re.compile(r"flash_attention_(fwd|bwd_dkv|bwd_dq)"
                          r"(_tc|_tf32x3)_kernelILi(\d+)E(?:Li(\d+)E)?")
# threads of a float32 block: flash_attention.cu kF32Warps * 32 and
# kBwdThreads, both 256
F32_THREADS = 256
# flash_decode.cu's split-KV <TQ, TKV, paged, hD, queries>, merge <TQ, hD>
# and tensor-core <hD, paged> instances; fused_ce.cu's bf16 kernel and
# merge; fused_decode.cu's <storage mode> instances
_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8",
          "13__nv_fp8_e4m3": "fp8"}
_Q_CODES = {"float32": 0, "bfloat16": 1}
_KV_CODES = {"int8": 2, "fp8": 3}
NEW_KERNELS = (
    ("split", re.compile(r"flash_decode_split_kernelI(f|13__nv_bfloat16)"
                         r"(f|a|13__nv_fp8_e4m3|13__nv_bfloat16|S\d*_)"
                         r"Lb([01])ELi(\d+)ELi(\d+)E")),
    ("merge", re.compile(r"flash_decode_merge_kernelI(f|13__nv_bfloat16)"
                         r"Li(\d+)E")),
    ("tc", re.compile(r"flash_decode_tc_kernelILi(\d+)ELb([01])E")),
    ("ce_tc", re.compile(r"fused_ce_fwd_tc_kernel")),
    ("ce_tf32x3", re.compile(r"fused_ce_fwd_tf32x3_kernel")),
    ("ce_merge", re.compile(r"fused_ce_merge_kernel")),
    ("fused", re.compile(r"fused_decode_kernelILi(\d)E")),
    ("row_gemm", re.compile(r"row_gemm_(?:bf16_kernelILi(\d)ELb([01])E"
                            r"(f|13__nv_bfloat16)|f32_kernelILb([01])E)")),
    ("sampler", re.compile(r"sampling_filter_draw_kernel")))
FUSED_MODE_NAMES = ("float32", "bfloat16", "int8", "fp8")


def _ptxas_entries(log):
    """[(entry line, {registers, spill_store_bytes, spill_load_bytes,
    static_smem_bytes})] of a ``-Xptxas -v`` report, in its order."""
    entries, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = {}
            entries.append((line, cur))
        elif cur is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = \
                int(st), int(ld)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return entries


def _new_kernel_row(kind, m, build):
    """Name and launch facts of one flash_decode / fused_ce /
    fused_decode instance (fused_decode's shared memory at
    gpt3_1p3b; the sampler's at a decode step's [8, 50304])."""
    if kind == "sampler":
        from paddle_tpu_torch.incubate.nn.kernels import sampling
        dev = torch.device("cuda", torch.cuda.current_device())
        plan = sampling.sampling_plan(8, 50304,
                                      sampling.device_fits(dev, 50304),
                                      SAMPLE_SERVE["top_k"])
        return "sampling_filter_draw", sampling.THREADS, plan["smem"]
    if kind == "row_gemm":
        smem = build.load("row_gemm").pt_row_gemm_smem_bytes
        smem.argtypes = [ctypes.c_int]
        if m.group(4) is not None:
            return (f"row_gemm float32 {_ROW_GEMM_LAYOUTS[m.group(4)]}", 256,
                    smem(0))
        return (row_gemm_instance(64 * int(m.group(1)),
                                  _ROW_GEMM_LAYOUTS[m.group(2)],
                                  _TYPES[m.group(3)]), 384, smem(1))
    if kind == "fused":
        from paddle_tpu_torch.incubate.nn.kernels import fused_decode
        plan = fused_decode.kernel_plan(
            torch.device("cuda", torch.cuda.current_device()), 2048, 8192,
            1024, 16)
        return (f"fused_decode_layers {FUSED_MODE_NAMES[int(m.group(1))]} "
                f"cache", plan["threads"], plan["smem"])
    fd_smem = build.load("flash_decode").pt_flash_decode_smem_bytes
    fd_smem.argtypes = [ctypes.c_int] * 5
    if kind == "split":
        tq = _TYPES[m.group(1)]
        tkv = tq if m.group(2).startswith("S") else _TYPES[m.group(2)]
        code = _KV_CODES.get(tkv, _Q_CODES[tq])
        return (f"flash_decode_split q {tq} K/V {tkv} "
                f"{'paged' if m.group(3) == '1' else 'contiguous'} hD "
                f"{m.group(4)} <= {m.group(5)} queries", 128,
                fd_smem(1, _Q_CODES[tq], code, int(m.group(4)),
                        int(m.group(5))))
    if kind == "merge":
        return (f"flash_decode_merge {_TYPES[m.group(1)]} hD {m.group(2)}",
                128, 0)
    if kind == "tc":
        return (f"flash_decode_tc bfloat16 "
                f"{'paged' if m.group(2) == '1' else 'contiguous'} hD "
                f"{m.group(1)}", 128, fd_smem(2, 1, 1, int(m.group(1)), 0))
    if kind in ("ce_tc", "ce_tf32x3"):
        ce = build.load("fused_ce").pt_fused_ce_smem_bytes
        ce.argtypes = [ctypes.c_int]
        if kind == "ce_tc":
            return "fused_ce_fwd_tc bfloat16", 256, ce(1)
        return "fused_ce_fwd_tf32x3 float32", 256, ce(0)
    return "fused_ce_merge", 256, 0


def flash_resources(procs, build):
    """Registers, spills and shared memory of each kernel instance, from
    the ptxas reports of :func:`_flash_ptxas_start` and the libraries'
    own shared-memory queries: (the flash-attention instances, the
    flash_decode split-KV / merge / tensor-core instances and the
    fused_ce bf16 kernel and merge, fused_decode's instances)."""
    logs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {name}.cu:\n{log}")
        out.unlink(missing_ok=True)
        logs[name] = log
        # warnings, and ptxas's "Potential Performance Loss" notes (wgmma
        # serialized: a kernel at a fraction of its speed, and correct)
        warnings = [x for x in log.splitlines()
                    if "warning" in x.lower() or "Performance Loss" in x]
        if warnings:
            _log({"phase": "ptxas_warnings", "source": name,
                  "lines": warnings})
    smem = build.load("flash_attention").pt_flash_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    rows = {}
    for line, res in _ptxas_entries(logs["flash_attention"]):
        m = FLASH_KERNEL.search(line)
        if m:
            tc = m.group(2) == "_tc"
            name = (f"flash_attention_{m.group(1)}{m.group(2)} "
                    f"{'bfloat16' if tc else 'float32'} hD {m.group(3)}")
            rows[name] = {
                "threads": (32 * int(m.group(4)) if tc
                            else F32_THREADS),
                "smem_bytes": smem(int(tc), int(m.group(3)), (
                    "fwd", "bwd_dkv", "bwd_dq").index(m.group(1))), **res}
    new_rows = {}
    for line, res in _ptxas_entries("".join(
            logs.get(n, "") for n in ("flash_decode", "fused_ce",
                                      "fused_decode", "row_gemm",
                                      "sampling"))):
        for kind, pattern in NEW_KERNELS:
            m = pattern.search(line)
            if m:
                name, threads, dyn = _new_kernel_row(kind, m, build)
                new_rows[name] = {"threads": threads,
                                  "dynamic_smem_bytes": dyn, **res}
                break
    return rows, new_rows


def _rates(times, bounds):
    """Achieved TFLOP/s and the share of the bound of each timed kernel
    (``<key>_ms`` in ``times``, its operations and bound in ``bounds``)."""
    return {"tflops": {k: b["ops"] / times[f"{k}_ms"] / 1e9
                       for k, b in bounds.items() if f"{k}_ms" in times},
            "bound_share": {k: b["bound_ms"] / times[f"{k}_ms"]
                            for k, b in bounds.items()
                            if f"{k}_ms" in times}}


def _work(B, W, T, nH, nKV, hD, pos, elem, kv_elem=None, scale_bytes=0,
          block_size=0):
    """Bytes and operations one call needs on these inputs: q read and
    out written once (``elem`` bytes a value), each visible K/V row read
    once per kv head (``kv_elem`` bytes a value, default ``elem``, plus
    ``scale_bytes`` of int8 scale), pos, and for the paged layout
    (``block_size`` > 0) the table entry of each visible page; 4*hD
    operations per visible (query, row) pair and head."""
    kv_elem = elem if kv_elem is None else kv_elem
    rows = [min(p + W - 1, T - 1) + 1 for p in pos]
    pairs = sum(min(p + j, T - 1) + 1 for p in pos for j in range(W))
    nbytes = 2 * B * W * nH * hD * elem \
        + 2 * sum(rows) * nKV * (hD * kv_elem + scale_bytes) + 4 * B
    if block_size:
        nbytes += 4 * sum(-(-r // block_size) for r in rows)
    return nbytes, 4 * hD * nH * pairs


def _limit_share(got, want, f32_tol, of_max=False):
    """The largest share of its limit that one element of got - want
    uses (the check passes at <= 1).  bfloat16: 2^-7 |want| + 1e-3 per
    element; float32: ``f32_tol``, times max(1, max |want|) when
    ``of_max``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        return (diff / (BF16_RTOL * w.abs() + BF16_ATOL)).max().item()
    scale = max(1.0, w.abs().max().item()) if of_max else 1.0
    return diff.max().item() / (f32_tol * scale)


DECODE_CASES = [
    # name, B, W, T, nH, nKV, dtype, pos, packed (q/k/v sliced from qkv)
    ("decode", 8, 1, 1024, 16, 16, torch.bfloat16, "ragged", False),
    ("verify", 8, 4, 1024, 16, 16, torch.bfloat16, "ragged", False),
    ("prefill", 2, 512, 512, 16, 16, torch.bfloat16, "zero", True),
    ("prefill_1024", 2, 1024, 1024, 16, 16, torch.bfloat16, "zero", True),
    ("decode_gqa", 8, 1, 1024, 16, 4, torch.bfloat16, "ragged", False),
    ("decode_f32", 8, 1, 1024, 16, 16, torch.float32, "ragged", False),
]


def kernel_phase(fd, cases=DECODE_CASES, phase="kernel"):
    """``flash_decode`` against its plain version at each case's shapes
    (hD 128), timed beside its plain version, SDPA and the bound."""
    rng = np.random.default_rng(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    hD = 128
    results = []
    for name, B, W, T, nH, nKV, dt, pk, packed in cases:
        if pk == "zero":
            pos_l = [0] * B
        else:
            pos_l = [int(x) for x in rng.integers(0, T - W + 1, B)]
            pos_l[0], pos_l[-1] = 0, T - W
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")

        def rand(*shape):
            return torch.randn(shape, device="cuda").to(dt)

        if packed:
            qkv = rand(B, W, 3, nH * hD)
            q, k, v = (qkv[:, :, i].view(B, W, nH, hD) for i in range(3))
        else:
            q, k, v = rand(B, W, nH, hD), rand(B, T, nKV, hD), \
                rand(B, T, nKV, hD)
        got = fd.flash_decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        want = fd.flash_decode_attention_plain(q, k, v, pos)
        err = (got.float() - want.float()).abs().max().item()
        share = _limit_share(got, want, 1e-4)
        if not share <= 1:
            raise AssertionError(f"flash_decode {name}: max abs err {err}, "
                                 f"{share} of its limit")
        # the yardstick: one library call on the same inputs
        rep = nH // nKV
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(rep, 2).transpose(1, 2)
        vt = v.repeat_interleave(rep, 2).transpose(1, 2)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos[:, None, None] + torch.arange(W, device="cuda")
                [None, :, None])[:, None]
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        nbytes, ops = _work(B, W, T, nH, nKV, hD, pos_l, q.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[str(dt).split(".")[-1]] * 1e3
        row = {
            "phase": phase, "name": name,
            "shape": f"B={B} W={W} T={T} nH={nH} nKV={nKV} hD={hD} "
                     f"{str(dt).split('.')[-1]}",
            # the instance the call runs and, split-KV, its splits
            "plan": fd.kernel_plan(q, k),
            "kernel_ms": _time_ms(
                lambda: fd.flash_decode_attention(q, k, v, pos),
                flush=flush),
            "plain_ms": _time_ms(
                lambda: fd.flash_decode_attention_plain(q, k, v, pos),
                reps=5, flush=flush),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                flush=flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "max_abs_err": err, "limit_share": share,
            "library_max_abs_err": float(lib_err),
        }
        _log(row)
        results.append(row)
    return results


def _kv_store(kvq, x, mode):
    """``x`` (float32) stored in a K/V mode: "dense" (bf16), int8
    ``(data, scale)`` or bare fp8, quantized on the card."""
    if mode == "dense":
        return x.to(torch.bfloat16)
    data, scale = kvq.quantize_kv(x, mode)
    return data if scale is None else (data, scale)


def paged_kernel_phase(fd, kvq):
    """The paged layout and the int8/fp8 storage modes of flash_decode
    at the serving path's shapes, each held per element to its plain
    version; then, in each storage mode, a paged call over an identity
    table must equal the contiguous kernel bit for bit.  The yardstick
    is SDPA on a dense, gathered and dequantized bf16 K/V (the gather
    and dequantization not timed): no single library call reads a page
    table or an int8 cache."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    B, T, nH, nKV, hD, bs = 8, 1024, 16, 16, 128, 64
    mb = T // bs
    cases = [
        # name, W, paged, K/V storage mode
        ("paged_decode", 1, True, "dense"),
        ("paged_decode_int8", 1, True, "int8"),
        ("paged_decode_fp8", 1, True, "fp8"),
        ("paged_verify", 4, True, "dense"),
        ("decode_int8", 1, False, "int8"),
        ("decode_fp8", 1, False, "fp8"),
    ]
    results, positions = {}, {}
    for name, W, paged, mode in cases:
        if W not in positions:
            # one draw per window width, so the modes read the same rows
            positions[W] = [int(x) for x in rng.integers(0, T - W + 1, B)]
            positions[W][0], positions[W][-1] = 0, T - W
        pos_l = positions[W]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        q = torch.randn((B, W, nH, hD), device="cuda").to(torch.bfloat16)
        rows = (B * mb, bs) if paged else (B, T)
        k, v = (_kv_store(kvq, torch.randn(rows + (nKV, hD), device="cuda"),
                          mode) for _ in range(2))
        if paged:
            # each slot's pages shuffled over the pool; -1 past the
            # pages its last query needs
            perm = torch.randperm(B * mb, generator=gen).view(B, mb)
            bt = torch.full((B, mb), -1, dtype=torch.int32)
            for b, p in enumerate(pos_l):
                used = (p + W - 1) // bs + 1
                bt[b, :used] = perm[b, :used]
            bt = bt.cuda()
            args = (q, k, v, bt, pos)
            call, plain = fd.flash_decode_paged, fd.flash_decode_paged_plain
            safe = bt.clamp_min(0).long()

            def dense(x):
                return kvq.dequantize_kv(x)[safe].reshape(
                    B, T, nKV, hD).to(torch.bfloat16)
        else:
            args = (q, k, v, pos)
            call = fd.flash_decode_attention
            plain = fd.flash_decode_attention_plain

            def dense(x):
                return kvq.dequantize_kv(x).to(torch.bfloat16)
        got = call(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        share = _limit_share(got, want, 1e-4)
        if not share <= 1:
            raise AssertionError(f"flash_decode {name}: max abs err {err}, "
                                 f"{share} of its limit")
        qt = q.transpose(1, 2)
        kt, vt = dense(k).transpose(1, 2), dense(v).transpose(1, 2)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos[:, None, None] + torch.arange(W, device="cuda")
                [None, :, None])[:, None]
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max()
        nbytes, ops = _work(B, W, T, nH, nKV, hD, pos_l, 2,
                            2 if mode == "dense" else 1,
                            4 if mode == "int8" else 0, bs if paged else 0)
        kv_name = "bfloat16" if mode == "dense" else mode
        row = {
            "phase": "kernel", "name": name,
            "shape": f"B={B} W={W} T={T} nH={nH} nKV={nKV} hD={hD} q "
                     f"bfloat16, K/V {kv_name}"
                     + (f", paged bs={bs}, shuffled table" if paged else ""),
            "plan": fd.kernel_plan(q, k, bt if paged else None),
            "kernel_ms": _time_ms(lambda: call(*args), flush=flush),
            "plain_ms": _time_ms(lambda: plain(*args), reps=5, flush=flush),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask),
                flush=flush),
            # operations at the bf16 rate of q
            **_bound(nbytes, ops, "bfloat16"),
            "max_abs_err": err, "limit_share": share,
            "library_max_abs_err": float(lib_err),
        }
        _log(row)
        results[name] = row
        del k, v, kt, vt, args
    # identity table: the paged kernel on the contiguous kernel's rows
    pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                       device="cuda")
    q = torch.randn((B, 1, nH, hD), device="cuda").to(torch.bfloat16)
    ident = torch.arange(B * mb, dtype=torch.int32, device="cuda").view(B, mb)
    for mode in ("dense", "int8", "fp8"):
        k, v = (_kv_store(kvq, torch.randn((B, T, nKV, hD), device="cuda"),
                          mode) for _ in range(2))

        def pages(x):
            return kvq.kv_map(lambda a: a.reshape(
                (B * mb, bs) + tuple(a.shape[2:])), x)

        if not torch.equal(fd.flash_decode_paged(q, pages(k), pages(v),
                                                 ident, pos),
                           fd.flash_decode_attention(q, k, v, pos)):
            raise AssertionError(f"flash_decode {mode}: the paged call on "
                                 f"an identity table differs from the "
                                 f"contiguous kernel")
    _log({"phase": "kernel_identity_table", "shape": f"B={B} W=1 T={T} "
          f"nH={nH} hD={hD} bs={bs}", "modes": ["bfloat16", "int8", "fp8"],
          "bit_identical": True})
    del flush
    torch.cuda.empty_cache()
    return results


# (name, K, N) of gpt3_1p3b's decode products; the head reads wte [N, K]
ROW_GEMM_SHAPES = (("qkv", 2048, 6144), ("proj", 2048, 2048),
                   ("fc1", 2048, 8192), ("fc2", 8192, 2048),
                   ("head", 2048, 50304))
# decode (8 slots), verify k 3, verify k 7, suffix passes of 128 and 256
# rows (one launch each)
ROW_GEMM_ROWS = (8, 32, 64, 128, 256)
_ROW_GEMM_LAYOUTS = {"0": "kn", "1": "nk (wte.t())"}


def row_gemm_instance(rows, layout, out):
    """The kernel_resources name of the bf16 instance for launches of at
    most ``rows`` rows (64, 128 or 256)."""
    return f"row_gemm bfloat16 {layout} <= {rows} rows -> {out}"


def row_gemm_check(rg, x, w, out_dtype=None):
    """``row_gemm`` against its plain version and the float32 product on
    the card; raises past either limit.  Limits, per element: float32
    sums of K products differ by at most 2 K 2^-24 (|x| @ |w|) between
    two orders (``sum_tol``); a bfloat16 output adds one rounding, 2^-8
    of the float32 product; against the plain version (cuBLAS, which
    may reduce split-K partials in bfloat16) one bf16 step of the
    element plus one of the output's rms."""
    got = rg.row_gemm(x, w, out_dtype)
    want = rg.row_gemm_plain(x, w, out_dtype)
    xf, wf = x.float(), w.float()
    ref = xf @ wf                                     # TF32 off: float32
    sum_tol = 2 * x.shape[-1] * 2.0 ** -24 * (xf.abs() @ wf.abs())
    g, p = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        ref_lim = 2.0 ** -8 * ref.abs() + sum_tol
        rms = p.pow(2).mean().sqrt()
        plain_lim = 2.0 ** -7 * (p.abs() + rms) + sum_tol
    else:
        ref_lim = sum_tol + 1e-30
        plain_lim = 2 * sum_tol + 1e-30
    share_ref = ((g - ref).abs() / ref_lim).max().item()
    share_plain = ((g - p).abs() / plain_lim).max().item()
    out = {"max_abs_err": (g - p).abs().max().item(),
           "max_abs_err_f32": (g - ref).abs().max().item(),
           "limit_share": share_plain, "limit_share_f32": share_ref}
    if not (share_ref <= 1 and share_plain <= 1) \
            or not torch.isfinite(g).all():
        raise AssertionError(f"row_gemm {tuple(x.shape)} x {tuple(w.shape)}"
                             f" {x.dtype}: {out}")
    return out


# row counts held against one 256-row call: one group, group edges, the
# 256-row chunk edge
ROW_GEMM_CHECK_ROWS = (1, 8, 13, 32, 63, 64, 65, 128, 200, 256, 257)


def row_gemm_rows_check(rg, x, w, out_dtype=None, seed=0):
    """Each row of ``row_gemm`` bit for bit the same whatever M: x [256,
    K]'s rows at each of ``ROW_GEMM_CHECK_ROWS`` (past 256, x's rows
    again from the first), in a permuted order, and 520 rows (three
    256-row launches) against the one 256-row call."""
    full = rg.row_gemm(x, w, out_dtype)

    def rows(n):
        return torch.cat([x] * (n // len(x)) + [x[:n % len(x)]])

    def want(n):
        return torch.cat([full] * (n // len(x)) + [full[:n % len(x)]])

    for M in ROW_GEMM_CHECK_ROWS:
        if not torch.equal(rg.row_gemm(rows(M), w, out_dtype), want(M)):
            raise AssertionError(f"row_gemm rows at M {M} differ from M "
                                 f"{len(x)}")
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(x.shape[0], generator=gen).to(x.device)
    if not torch.equal(rg.row_gemm(x[perm], w, out_dtype), full[perm]):
        raise AssertionError("row_gemm rows move with their place")
    if not torch.equal(rg.row_gemm(rows(520), w, out_dtype), want(520)):
        raise AssertionError("row_gemm rows differ across 256-row launches")


def _row_gemm_operands(gen, K, N, dtype, head, rows=256):
    """x [rows, K] and w: a [K, N] weight, or for the head the [N, K]
    table read as its transpose (seeded, the init's 0.02 scale)."""
    x = torch.randn((rows, K), generator=gen, device="cuda").to(dtype)
    if head:
        w = (torch.randn((N, K), generator=gen, device="cuda")
             * 0.02).to(dtype).t()
    else:
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * 0.02).to(dtype)
    return x, w


def _time_rotating(fns, reps=30):
    """Median CUDA-event time of one call, cycling through ``fns`` (the
    same product over copies of the weights, 160 MB or more together):
    each call finds its weights cold and the L2 holding the clean lines
    of the previous call's reads, as a decode step's layers do (a
    ``flush.zero_()`` would leave dirty lines whose write-back doubles
    the traffic of a read-bound call).  The device sleep of
    :func:`_time_ms` keeps host dispatch out of the events."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fns[r % len(fns)]()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def row_gemm_phase(rg, resources):
    """``row_gemm`` at gpt3_1p3b's five decode products (bf16; the head
    with float32 output) for each M of ``ROW_GEMM_ROWS``: held to its
    plain version and the float32 product (``row_gemm_check``), rows bit
    for bit across M (``row_gemm_rows_check``), timed over rotating
    weight copies (``_time_rotating``) beside its plain version,
    ``torch.matmul`` (the head: ``torch.mm`` with float32 output) and the
    byte bound, with the plan on this card (units an SM, cluster size,
    stages) and the instance's registers and shared memory
    (``resources``: the ``kernel_resources`` rows); the host time of one
    call (1000 calls at M 8, no sync); then the float32 instance at
    gpt_tiny's shapes (checks only)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    card = rg.device_card(torch.device("cuda", torch.cuda.current_device()))
    rows = {}
    for name, K, N in ROW_GEMM_SHAPES:
        head = name == "head"
        out_dtype = torch.float32 if head else None
        copies = max(2, -(-160_000_000 // (2 * K * N)))
        ops = [_row_gemm_operands(gen, K, N, torch.bfloat16, head)
               for _ in range(copies)]
        row_gemm_rows_check(rg, *ops[0], out_dtype)

        def library(x, w, head=head):
            return (torch.mm(x, w, out_dtype=torch.float32) if head
                    else torch.matmul(x, w))

        for M in ROW_GEMM_ROWS:
            xs = [(x[:M].contiguous(), w) for x, w in ops]
            chk = row_gemm_check(rg, *xs[0], out_dtype)
            out_elem = 4 if head else 2
            b = _bound(2 * K * N + 2 * M * K + out_elem * M * N,
                       2 * M * K * N, "bfloat16")
            ms = _time_rotating([lambda x=x, w=w: rg.row_gemm(x, w, out_dtype)
                                 for x, w in xs])
            plan = rg.row_gemm_plan(M, K, N, torch.bfloat16, card)
            inst = row_gemm_instance(
                64 * plan["groups"] if plan["groups"] < 3 else 256,
                "nk (wte.t())" if head else "kn",
                "float32" if head else "bfloat16")
            row = {"name": name, "shape": f"M={M} K={K} N={N} bf16"
                   + (" wte.t() -> f32" if head else ""),
                   "plan": plan,
                   "units_per_sm": plan["tiles_per_cluster"],
                   "cluster_size": plan["splits"],
                   "stages_per_sm": plan["sm_stages"],
                   "instance": inst, "resources": resources.get(inst),
                   **chk, "kernel_ms": ms,
                   "plain_ms": _time_rotating(
                       [lambda x=x, w=w: rg.row_gemm_plain(x, w, out_dtype)
                        for x, w in xs]),
                   "library_ms": _time_rotating(
                       [lambda x=x, w=w: library(x, w) for x, w in xs]),
                   **b, "bound_share": b["bound_ms"] / ms,
                   "weight_copies": copies,
                   "rows_bit_identical_across_m": True}
            if M == ROW_GEMM_ROWS[0]:
                # 1000 calls, in 4 windows of 250 queued behind a device
                # sleep that outlasts them (no sync inside a window, the
                # launch queue never full): the host's own time
                x, w = xs[0]
                secs = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(50_000_000)
                    t = time.perf_counter()
                    for _ in range(250):
                        rg.row_gemm(x, w, out_dtype)
                    secs.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                row["host_us_per_call"] = sum(secs) / 1000 * 1e6
            rows[(name, M)] = row
            _log({"phase": "row_gemm", **row})
        del ops, xs
    for name, K, N, head in (("gpt_tiny qkv", 128, 384, False),
                             ("gpt_tiny fc2", 512, 128, False),
                             ("gpt_tiny head", 128, 1024, True)):
        x, w = _row_gemm_operands(gen, K, N, torch.float32, head)
        row_gemm_rows_check(rg, x, w)
        chk = row_gemm_check(rg, x[:8], w)
        rows[(name, 8)] = {"name": name, "shape": f"M=8 K={K} N={N} f32",
                           **chk}
        _log({"phase": "row_gemm", **rows[(name, 8)],
              "rows_bit_identical_across_m": True})
    torch.cuda.empty_cache()
    return rows


def reference_phase(gpt, Engine):
    """The card's flash engine against the CPU engine on gpt_tiny in
    float32: identical greedy streams."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu_params = gpt.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    streams = []
    for params, dev, ak in ((cpu_params, "cpu", "xla"),
                            (gpu_params, "cuda", "flash")):
        eng = Engine(params, cfg, max_batch=3, max_len=256,
                     attn_kernel=ak, device=dev)
        rids = [eng.submit(p, max_new=m) for p, m in reqs]
        out = eng.run(steps_per_sync=8)
        streams.append([out[r] for r in rids])
    if streams[0] != streams[1]:
        raise AssertionError(f"card stream {streams[1]} != CPU stream "
                             f"{streams[0]}")
    _log({"phase": "reference", "config": "gpt_tiny f32",
          "requests": len(reqs), "streams_identical": True})


def serving_phase(gpt, Engine, fd, rg):
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    eng = Engine(params, cfg, max_batch=8, max_len=1024,
                 attn_kernel="flash", device="cuda")
    _log({"phase": "serving_setup", "params": gpt.param_count(params),
          "init_s": time.perf_counter() - t0,
          "cache_bytes": eng.metrics()["cache_bytes"]})
    # warm-up: cuBLAS handles and the kernel's first launch stay out of
    # the measured run
    eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    eng.run()
    L = cfg.num_layers
    base = eng.metrics()
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    fd.reset_launches()
    rg.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, (n,)), max_new=32)
            for n in lens]
    out = eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.LAUNCHES
    gemm_launches = rg.LAUNCHES
    instances = dict(fd.INSTANCE_LAUNCHES)
    m = eng.metrics()
    steps = m["decode_steps"] - base["decode_steps"]
    prefills = m["launches"]["prefill"] - base["launches"]["prefill"]
    for rid in rids:
        req = eng.request(rid)
        if req.status != "DONE" or len(out[rid]) != 32:
            raise AssertionError(f"request {rid}: {req.status}, "
                                 f"{len(out.get(rid, []))} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out[rid]):
            raise AssertionError(f"request {rid}: token out of range")
    if launches != L * (steps + prefills) or steps < 1 or prefills < 1:
        raise AssertionError(
            f"flash_decode launches {launches} != {L} x ({steps} decode "
            f"steps + {prefills} prefill programs)")
    # every product of a decode step (4 a layer and the head) on row_gemm;
    # the prefills keep torch.matmul
    if gemm_launches != (4 * L + 1) * steps:
        raise AssertionError(f"row_gemm launches {gemm_launches} != "
                             f"{4 * L + 1} x {steps} decode steps")
    # decode steps on the split-KV instance, admissions on the tensor cores
    if instances != {"split": L * steps, "tc": L * prefills, "simt": 0}:
        raise AssertionError(f"flash_decode instances {instances}: want "
                             f"split {L * steps}, tc {L * prefills}")
    ttft = [eng.request(r).first_token_at - eng.request(r).submitted_at
            for r in rids]
    e2e = [eng.request(r).finished_at - eng.request(r).submitted_at
           for r in rids]
    dsec = m["decode_seconds"] - base["decode_seconds"]
    row = {"phase": "serving", "requests": len(rids),
           "prompt_lens": [int(n) for n in lens], "max_new": 32,
           "launches": launches, "instance_launches": instances,
           "row_gemm_launches": gemm_launches,
           "decode_steps": steps, "prefill_programs": prefills,
           "decode_rounds": m["launches"]["decode"]
           - base["launches"]["decode"],
           "tokens": 32 * len(rids), "wall_s": wall,
           # the decode loops' host syncs also wait for the admission
           # prefills queued before them, so this rate includes them
           "decode_loop_s": dsec,
           "decode_loop_tok_s": 32 * len(rids) / dsec,
           "e2e_tok_s": 32 * len(rids) / wall,
           "ttft_mean_s": float(np.mean(ttft)),
           "ttft_max_s": float(np.max(ttft)),
           "e2e_latency_mean_s": float(np.mean(e2e))}
    _log(row)
    return cfg, params, row, launches, [out[r] for r in rids]


def compare_phase(gpt, cfg, params):
    """One decode step at full width, flash against xla, on a cache
    filled by the flash prefill; then where a decode step's time goes."""
    B, T = 8, 1024
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(32, 701, B)]
    cache = gpt.init_decode_cache(cfg, B, T, device="cuda")
    with torch.inference_mode():
        for i, n in enumerate(lens):
            ids = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device="cuda")
            gpt.prefill_into_slots(params, ids, cfg, cache,
                                   torch.tensor([i], device="cuda"),
                                   attn_kernel="flash")
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, B),
                           dtype=torch.int32, device="cuda")
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        c2 = {k: v.clone() for k, v in cache.items()}
        lf, _ = gpt.decode_step_multi(params, cache, tok, pos, cfg,
                                      attn_kernel="flash")
        lx, _ = gpt.decode_step_multi(params, c2, tok, pos, cfg,
                                      attn_kernel="xla")
        torch.cuda.synchronize()
        if not (torch.isfinite(lf).all() and torch.isfinite(lx).all()):
            raise AssertionError("non-finite logits")
        diff = (lf - lx).abs().max().item()
        agree = int((lf.argmax(-1) == lx.argmax(-1)).sum())
        if not diff <= SERVE_TOL:
            raise AssertionError(f"flash vs xla logits differ by {diff} "
                                 f"> {SERVE_TOL}")
        _log({"phase": "flash_vs_xla", "max_abs_logit_diff": diff,
              "atol": SERVE_TOL, "logit_std": lx.float().std().item(),
              "argmax_agree": f"{agree}/{B}"})
        rows = {}
        for kernel in ("flash", "xla"):
            prof = _step_profile(
                lambda k=kernel: gpt.decode_step_multi(
                    params, cache, tok, pos, cfg, attn_kernel=k))
            rows[kernel] = dict(phase="decode_step", attn_kernel=kernel,
                                slots=B, tok_s=B / prof["wall_ms"] * 1e3,
                                **prof)
            _log(rows[kernel])
    return rows


# a decode step's or verify pass's kernels by family: row_gemm carries
# every product of the decode block (the rest of "matmul" is cuBLAS)
DECODE_FAMILIES = (("flash_decode", ("flash_decode",)),
                   ("row_gemm", ("row_gemm",)))


def _step_profile(step, families=DECODE_FAMILIES, n=10, names=False):
    """Wall time of one eager decode step ``step()`` (synchronised, the
    median of 3 windows of ``n`` calls) against the device time the
    profiler sees in ``n`` calls, by kernel family (``names``: and every
    kernel's name)."""
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n * 1e3)
    wall_ms = statistics.median(windows)
    return dict(wall_ms=wall_ms, wall_ms_windows=windows,
                **_profile(step, n, wall_ms, list(families), names=names))


def _profile(fn, n, wall_ms, families, top_n=8, names=False):
    """Device time of ``n`` calls of ``fn`` under torch.profiler, per
    call, by kernel family: each (family, name substrings) in order,
    then cuBLAS GEMMs (Hopper's are named nvjet_*), then the rest; the
    idle share is 1 - busy / ``wall_ms`` (an unprofiled call's wall
    time).  Host side: the operators' own CPU time per call (the rest
    of the wall time is Python and waiting), and the largest operators
    by that time."""
    clocks = _nvidia_smi("clocks.sm,power.draw")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    fam = {name: 0.0 for name, _ in families}
    fam.update(matmul=0.0, other=0.0)
    kernels, top, host, seen = 0, [], [], set()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if "CPU" in str(getattr(ev, "device_type", "")) \
                and ev.self_cpu_time_total:
            host.append((ev.self_cpu_time_total / n / 1e3, ev.count // n,
                         ev.key[:50]))
        if not us or "CUDA" not in str(getattr(ev, "device_type", "CUDA")):
            continue
        name = ev.key.lower()
        kernels += ev.count
        seen.add(ev.key)
        top.append((us / n / 1e3, ev.count // n, ev.key[:70]))
        hit = next((f for f, subs in families
                    if any(x in name for x in subs)), None)
        if hit is None and any(x in name for x in ("nvjet", "gemm",
                                                   "cutlass", "cublas",
                                                   "gemv")):
            hit = "matmul"
        fam[hit or "other"] += us
    dev_ms = {k: v / n / 1e3 for k, v in fam.items()}
    busy = sum(dev_ms.values())
    out = {} if not names else {"kernel_names": sorted(seen)}
    return {**out, "sm_clock_power": clocks, "device_ms": dev_ms,
            "device_busy_ms": busy, "kernels_per_step": kernels / n,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "top_kernels_ms_count_name": sorted(top, reverse=True)[:top_n],
            "host_op_self_ms": sum(h[0] for h in host),
            "top_host_ops_ms_count_name": sorted(host, reverse=True)[:top_n]}


def _to_device(tree, dev):
    """A parameter tree (dicts, int8 (weight, scale) tuples) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, dev) for v in tree)
    return tree.to(dev)


def paged_reference_phase(gpt, Engine, PagedEngine):
    """gpt_tiny f32, at each kv_dtype: the paged engine on the card
    (flash kernels) gives exactly the greedy streams of the CPU paged
    engine ("xla") and of the CPU contiguous engine; so does the
    contiguous engine on the card.  The pool of 18 pages of 8 rows is
    small enough that admissions defer and a running slot is evicted."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu_params = gpt.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    paged_kw = {"block_size": 8, "num_blocks": 18}
    for kd in ("bf16", "int8", "fp8"):
        streams, pool = {}, {}
        for label, E, params, dev, ak in (
                ("cpu_contiguous_xla", Engine, cpu_params, "cpu", "xla"),
                ("cpu_paged_xla", PagedEngine, cpu_params, "cpu", "xla"),
                ("card_paged_flash", PagedEngine, gpu_params, "cuda",
                 "flash"),
                ("card_contiguous_flash", Engine, gpu_params, "cuda",
                 "flash")):
            paged = E is PagedEngine
            eng = E(params, cfg, max_batch=3, max_len=256, attn_kernel=ak,
                    kv_dtype=kd, device=dev, **(paged_kw if paged else {}))
            rids = [eng.submit(p, max_new=m) for p, m in reqs]
            out = eng.run(steps_per_sync=8)
            streams[label] = [out[r] for r in rids]
            if paged:
                m = eng.metrics()
                pool[label] = {k: m[k] for k in (
                    "evictions", "deferred_admissions", "free_blocks",
                    "num_blocks")}
                if m["free_blocks"] != m["num_blocks"]:
                    raise AssertionError(f"paged {label} {kd}: pages left "
                                         f"claimed: {pool[label]}")
        want = streams["cpu_contiguous_xla"]
        for label, got in streams.items():
            if got != want:
                raise AssertionError(f"{label} {kd}: stream {got} != CPU "
                                     f"contiguous stream {want}")
        card = pool["card_paged_flash"]
        if card["evictions"] < 1 or card["deferred_admissions"] < 1:
            raise AssertionError(f"the pool of 18 pages did not both defer "
                                 f"and evict: {card}")
        _log({"phase": "reference_paged", "config": "gpt_tiny f32",
              "kv_dtype": kd, "requests": len(reqs), **paged_kw,
              "engines": sorted(streams), "streams_identical": True,
              "pool": pool})


def paged_serving_phase(gpt, Engine, PagedEngine, fd, cfg, params,
                        contiguous_streams):
    """The serving phase's 12 requests at full width through the paged
    engine (block_size 64, the default pool of 64 pages) at kv_dtype
    bf16, int8 and fp8, through the contiguous engine at int8 and fp8,
    and through the paged engine at bf16 with a pool of 26 pages, where
    admissions defer and a slot is evicted.  Every launch count is set
    to 0 just before each run: the paged layout must serve every decode
    step (24 launches each) and the contiguous layout every admission
    prefill (24 each), in the run's storage mode; every request DONE
    with 32 tokens and, paged, every page back in the pool."""
    L = cfg.num_layers
    runs = [
        # label, engine, kv_dtype, extra engine arguments
        ("paged", PagedEngine, "bf16", {}),
        ("paged", PagedEngine, "int8", {}),
        ("paged", PagedEngine, "fp8", {}),
        ("contiguous", Engine, "int8", {}),
        ("contiguous", Engine, "fp8", {}),
        ("paged_tight", PagedEngine, "bf16", {"num_blocks": 26}),
    ]
    results, streams_of = {}, {}
    for label, E, kd, kw in runs:
        paged = E is PagedEngine
        if paged:
            kw = dict(block_size=64, **kw)
        eng = E(params, cfg, max_batch=8, max_len=1024, attn_kernel="flash",
                kv_dtype=kd, device="cuda", **kw)
        eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)   # warm-up
        eng.run()
        base = eng.metrics()
        rng = np.random.default_rng(0)
        lens = rng.integers(32, 701, 12)
        fd.reset_launches()
        t0 = time.perf_counter()
        rids = [eng.submit(rng.integers(0, cfg.vocab_size, (n,)),
                           max_new=32) for n in lens]
        out = eng.run(steps_per_sync=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"contiguous": fd.LAUNCHES, "paged": fd.PAGED_LAUNCHES,
                  **{f"mode_{k}": n for k, n in fd.MODE_LAUNCHES.items()},
                  **{f"instance_{k}": n
                     for k, n in fd.INSTANCE_LAUNCHES.items()}}
        m = eng.metrics()
        steps = m["decode_steps"] - base["decode_steps"]
        prefills = m["launches"]["prefill"] - base["launches"]["prefill"]
        for rid in rids:
            req = eng.request(rid)
            if req.status != "DONE" or len(out[rid]) != 32:
                raise AssertionError(f"{label} {kd} request {rid}: "
                                     f"{req.status}, "
                                     f"{len(out.get(rid, []))} tokens")
            if not all(0 <= t < cfg.vocab_size for t in out[rid]):
                raise AssertionError(f"{label} {kd} request {rid}: token "
                                     f"out of range")
        mode = "dense" if kd == "bf16" else kd
        want = {"contiguous": L * prefills + (0 if paged else L * steps),
                "paged": L * steps if paged else 0,
                "mode_dense": 0, "mode_int8": 0, "mode_fp8": 0,
                # decode on the split-KV instance, admissions (bf16 K/V
                # of the prompt) on the tensor cores
                "instance_split": L * steps, "instance_tc": L * prefills,
                "instance_simt": 0}
        want["mode_dense"] += L * prefills
        want[f"mode_{mode}"] += L * steps
        if counts != want or steps < 1 or prefills < 1:
            raise AssertionError(f"{label} {kd}: flash_decode launches "
                                 f"{counts}, want {want} ({steps} decode "
                                 f"steps, {prefills} prefill programs)")
        if paged and m["free_blocks"] != m["num_blocks"]:
            raise AssertionError(f"{label} {kd}: {m['free_blocks']} of "
                                 f"{m['num_blocks']} pages free after the "
                                 f"drain")
        deferred = m["deferred_admissions"] - base["deferred_admissions"]
        evictions = m.get("evictions", 0) - base.get("evictions", 0)
        if label == "paged_tight" and not (deferred >= 1 and evictions >= 1):
            raise AssertionError(f"paged_tight: {deferred} deferred "
                                 f"admissions, {evictions} evictions")
        streams = [out[r] for r in rids]
        ttft = [eng.request(r).first_token_at - eng.request(r).submitted_at
                for r in rids]
        dsec = m["decode_seconds"] - base["decode_seconds"]
        same = sum(a == b for a, b in zip(streams, contiguous_streams))
        tokens_same = sum(x == y for a, b in zip(streams, contiguous_streams)
                          for x, y in zip(a, b))
        row = {"phase": "serving_kv", "engine": label, "kv_dtype": kd,
               **({"block_size": m["block_size"],
                   "num_blocks": m["num_blocks"]} if paged else {}),
               "cache_bytes": m["cache_bytes"], "launches": counts,
               "decode_steps": steps, "prefill_programs": prefills,
               "decode_rounds": m["launches"]["decode"]
               - base["launches"]["decode"],
               "stall_rounds": m["stalls"] - base["stalls"],
               "deferred_admissions": deferred, "evictions": evictions,
               "tokens": 32 * len(rids), "wall_s": wall,
               "decode_loop_s": dsec,
               "decode_loop_tok_s": 32 * len(rids) / dsec,
               "e2e_tok_s": 32 * len(rids) / wall,
               "ttft_mean_s": float(np.mean(ttft)),
               "ttft_max_s": float(np.max(ttft)),
               # reported, not asserted: bf16 near-ties, other GEMM shapes
               "streams_equal_to_contiguous_bf16": f"{same}/{len(rids)}",
               "tokens_equal_to_contiguous_bf16":
                   f"{tokens_same}/{32 * len(rids)}"}
        _log(row)
        results[(label, kd)] = row
        streams_of[(label, kd)] = streams
        del eng
        torch.cuda.empty_cache()

    def agree(a, b):
        return (f"{sum(x == y for x, y in zip(streams_of[a], streams_of[b]))}"
                f"/{len(streams_of[a])}")

    # reported, not asserted: the paged prefill pads to whole pages, so
    # cuBLAS sees other GEMM shapes and near-ties may break otherwise
    _log({"phase": "serving_kv_agreement",
          "paged_vs_contiguous": {kd: agree(("paged", kd),
                                            ("contiguous", kd))
                                  for kd in ("int8", "fp8")},
          "paged_26_pages_vs_paged_64_pages_bf16": agree(
              ("paged_tight", "bf16"), ("paged", "bf16"))})
    return results, streams_of


def paged_compare_phase(gpt, cfg, params):
    """One paged decode step at full width per kv_dtype, flash against
    xla on the same pools (filled by the paged flash prefill): logits
    finite and within SERVE_TOL; then where a paged flash decode step's
    time goes."""
    B, bs = 8, 64
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(32, 701, B)]
    ids = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, B),
                       dtype=torch.int32, device="cuda")
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    # each slot's pages, shuffled over a pool that just holds them: the
    # prompt's pages and the page of the row this step writes
    need = [n // bs + 1 for n in lens]
    nb = sum(need)
    perm = rng.permutation(nb).astype(np.int32)
    table = np.full((B, 1024 // bs), -1, np.int32)
    for b, k in enumerate(need):
        table[b, :k] = perm[sum(need[:b]):sum(need[:b]) + k]
    bt = torch.from_numpy(table).cuda()
    rows = {}
    for kd in ("bf16", "int8", "fp8"):
        pools = gpt.init_decode_cache(cfg, nb, bs, kd, device="cuda")
        with torch.inference_mode():
            for b, n in enumerate(lens):
                nblk = -(-n // bs)
                padded = np.zeros((1, nblk * bs), np.int64)
                padded[0, :n] = ids[b]
                gpt.prefill_paged_batched(
                    params, torch.from_numpy(padded).cuda(), cfg, pools,
                    bt[b:b + 1, :nblk], attn_kernel="flash")
            p2 = {k: v.clone() for k, v in pools.items()}
            lf, _ = gpt.decode_step_paged(params, pools, bt, tok, pos, cfg,
                                          attn_kernel="flash")
            lx, _ = gpt.decode_step_paged(params, p2, bt, tok, pos, cfg,
                                          attn_kernel="xla")
            torch.cuda.synchronize()
            if not (torch.isfinite(lf).all() and torch.isfinite(lx).all()):
                raise AssertionError(f"paged {kd}: non-finite logits")
            diff = (lf - lx).abs().max().item()
            agree = int((lf.argmax(-1) == lx.argmax(-1)).sum())
            if not diff <= SERVE_TOL:
                raise AssertionError(f"paged {kd}: flash vs xla logits "
                                     f"differ by {diff} > {SERVE_TOL}")
            prof = _step_profile(lambda: gpt.decode_step_paged(
                params, pools, bt, tok, pos, cfg, attn_kernel="flash"))
        rows[kd] = dict(phase="paged_decode_step", kv_dtype=kd, slots=B,
                        pool_pages=nb, block_size=bs,
                        max_abs_logit_diff=diff, atol=SERVE_TOL,
                        argmax_agree=f"{agree}/{B}",
                        tok_s=B / prof["wall_ms"] * 1e3, **prof)
        _log(rows[kd])
        del pools, p2
    torch.cuda.empty_cache()
    return rows


def _err(got, want):
    """(max |got - want|, max |want|, the share of elements that differ,
    the share of its limit the worst element uses)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(), want.float().abs().max().item(),
            (diff > 0).float().mean().item(),
            _limit_share(got, want, F32_REL, of_max=True))


def _bound(nbytes, ops, dt):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _split_bounds(bounds):
    """The float32 flash kernels run each product as three TF32 products:
    their bound is three times the operations at the TF32 rate (the
    lower one); the CUDA cores' float32 bound stays beside as
    ``<key>_ffma``.  In place."""
    for key in [k for k in bounds if not k.endswith("_ffma")]:
        b = bounds[key]
        bounds[f"{key}_ffma"] = b
        bounds[key] = _bound(b["bytes"], 3 * b["ops"], "tf32")


def _ffma_shares(times, bounds):
    """Each timed float32 kernel's share of its FFMA bound."""
    return {k: bounds[f"{k}_ffma"]["bound_ms"] / times[f"{k}_ms"]
            for k in ("fwd", "dkv", "dq") if f"{k}_ms" in times}


def flash_kernel_case(fa, gen, flush, name, B, S, nH, hD, dt, causal):
    """One shape of the three flash kernels (q, k, v strided slices of a
    packed qkv): each held per element to its plain version (bf16: one
    rounding step; float32: F32_REL of the max, and to its TF32x3
    emulation), then timed beside the plain version and SDPA (forward,
    and its autograd backward for dq, dk and dv together), with each
    kernel's bound from the bytes and operations the shape needs.  The
    logged row."""
    dts = str(dt).split(".")[-1]
    qkv = torch.randn((B, S, 3, nH * hD), generator=gen,
                      device="cuda").to(dt)
    q, k, v = (qkv[:, :, i].view(B, S, nH, hD) for i in range(3))
    dout = torch.randn((B, S, nH, hD), generator=gen,
                       device="cuda").to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                        causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0,
                                                     causal=causal)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse,
                                                  delta, causal)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                           causal)
    errs = {"out": _err(out, w_out), "dk": _err(dk, w_dk),
            "dv": _err(dv, w_dv), "dq": _err(dq, w_dq)}
    lse_err = (lse - w_lse).abs().max().item()
    # float32: the three kernels against their own arithmetic too
    emu = None if dt != torch.float32 else {
        **tf32x3_forward_share(fa, q, k, v, out, lse, causal, 0),
        **tf32x3_backward_share(fa, q, k, v, dout, lse, delta,
                                (dk, dv, dq), causal, 0)}
    _log({"phase": "kernel_training_check", "name": name,
          "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
          "lse_max_abs_err": lse_err, "tf32x3_emulation": emu})
    for key, (err, _, _, share) in errs.items():
        if not share <= 1:
            raise AssertionError(f"flash_attention {name} {key}: max abs "
                                 f"err {err}, {share} of its limit")
    if not lse_err <= 1e-3 or (emu and not max(emu.values()) <= 1):
        raise AssertionError(f"flash_attention {name} lse: {lse_err}, "
                             f"against the tf32x3 emulation {emu}")
    del w_out, w_lse, w_dk, w_dv, w_dq
    # the yardstick: SDPA forward and its autograd backward
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves), is_causal=causal)
    lib_err = (lib_out.detach().transpose(1, 2).float()
               - out.float()).abs().max().item()
    times = {
        "fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                          causal),
                           reps=10, flush=flush),
        "fwd_plain_ms": _time_ms(
            lambda: fa.flash_attention_with_lse_plain(
                q, k, v, 0, causal=causal), reps=3, flush=flush),
        "fwd_library_ms": _time_ms(
            lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v)),
                is_causal=causal), reps=10, flush=flush),
        "dkv_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, dout, lse, delta, causal), reps=10, flush=flush),
        "dkv_plain_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
            q, k, v, dout, lse, delta, causal), reps=3, flush=flush),
        "dq_ms": _time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, dout, lse, delta, causal), reps=10, flush=flush),
        "dq_plain_ms": _time_ms(lambda: fa.flash_attention_bwd_dq_plain(
            q, k, v, dout, lse, delta, causal), reps=3, flush=flush),
        "bwd_library_ms": _time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout.transpose(1, 2), retain_graph=True),
            reps=10, flush=flush),
    }
    del lib_out, leaves
    # visible (query, key) pairs per (batch, head); elem bytes
    pairs = S * (S + 1) // 2 if causal else S * S
    n_el, e, stats = B * S * nH * hD, q.element_size(), B * nH * S * 4
    bounds = {
        "fwd": _bound(4 * n_el * e + stats, 4 * hD * pairs * B * nH, dts),
        "dkv": _bound(6 * n_el * e + 2 * stats, 8 * hD * pairs * B * nH,
                      dts),
        "dq": _bound(5 * n_el * e + 2 * stats, 6 * hD * pairs * B * nH,
                     dts),
        # the whole backward at FlashAttention-2's count (2.5x fwd)
        "bwd_pair": _bound(7 * n_el * e + 2 * stats,
                           10 * hD * pairs * B * nH, dts),
    }
    if dt == torch.float32:
        _split_bounds(bounds)
    row = {"phase": "kernel_training", "name": name,
           "shape": f"B={B} S={S} nH={nH} hD={hD} {dts} "
                    f"causal={causal} packed qkv",
           **times, **_rates(times, bounds),
           "max_abs_err": {k2: v2[0] for k2, v2 in errs.items()},
           "max_ref": {k2: v2[1] for k2, v2 in errs.items()},
           "share_differing": {k2: v2[2] for k2, v2 in errs.items()},
           "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
           "lse_max_abs_err": lse_err, "tf32x3_emulation": emu,
           "library_fwd_max_abs_err": lib_err,
           "bounds": bounds}
    if dt == torch.float32:
        row["bound_share_ffma"] = _ffma_shares(times, bounds)
    _log(row)
    del qkv, q, k, v, dout, out, lse, delta, dk, dv, dq
    return row


def train_kernel_phase(fa, fce, matmul_f32out):
    """The training kernels against their plain versions on the card,
    with times, bounds and the library yardsticks."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [
        # name, B, S, nH, hD, dtype, causal
        ("train", 8, 1024, 16, 128, torch.bfloat16, True),
        ("train_f32", 2, 1024, 16, 128, torch.float32, True),
        ("noncausal", 2, 1024, 16, 128, torch.bfloat16, False),
        ("ragged", 2, 1000, 16, 64, torch.bfloat16, True),
        ("ragged_f32", 2, 1000, 16, 64, torch.float32, True),
    ]
    results = {}
    for name, B, S, nH, hD, dt, causal in cases:
        results[name] = flash_kernel_case(fa, gen, flush, name, B, S, nH, hD,
                                          dt, causal)
    torch.cuda.empty_cache()

    # fused_ce_fwd at the eval shape
    N, V, H = 8192, 50304, 2048
    h = torch.randn((N, H), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((V, H), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    lbl = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lbl[:64:4], lbl[1:64:4], lbl[2:64:4] = -1, V, V + 100
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    errs = [(z - wz).abs().max().item(), (picked - wp).abs().max().item()]
    if not max(errs) <= 1e-3 or not bool((picked[:64:4] == 0).all()):
        raise AssertionError(f"fused_ce_fwd: z/picked errors {errs}")
    row = {"phase": "kernel_training", "name": "fused_ce",
           "shape": f"N={N} V={V} H={H} bfloat16, 48 labels out of range",
           "ms": _time_ms(lambda: fce.fused_ce_fwd(h, W, lbl), reps=3,
                          flush=flush),
           "plain_ms": _time_ms(lambda: fce.fused_ce_fwd_plain(h, W, lbl),
                                reps=3, flush=flush),
           # two calls: the float32-output product, then logsumexp
           "library_ms": _time_ms(lambda: torch.logsumexp(
               matmul_f32out(h, W.t()), -1), reps=3, flush=flush),
           "library_calls": "matmul_f32out (torch.mm out_dtype=float32) "
                            "+ torch.logsumexp",
           # vocabulary splits and tiles a split of the bf16 kernel
           "plan": fce.ce_plan(N, V, torch.cuda.get_device_properties(
               0).multi_processor_count),
           "max_abs_err": max(errs), "z_err": errs[0],
           "picked_err": errs[1], "atol": 1e-3,
           **_bound((N * H + V * H) * 2 + N * 12, 2 * N * V * H,
                    "bfloat16")}
    _log(row)
    results["fused_ce"] = row
    del h, W, lbl, z, picked, wz, wp
    # the float32 instance (three TF32 products a product) at N 2048 of
    # that head, the eval shape of gpt3_1p3b's default-dtype training
    N = 2048
    h = torch.randn((N, H), generator=gen, device="cuda")
    W = torch.randn((V, H), generator=gen, device="cuda") * 0.02
    lbl = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lbl[:64:4], lbl[1:64:4], lbl[2:64:4] = -1, V, V + 100
    z, picked = fce.fused_ce_fwd(h, W, lbl)
    torch.cuda.synchronize()
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)
    err = max((z - wz).abs().max().item(), (picked - wp).abs().max().item())
    ez, ep = fce.fused_ce_fwd_tf32x3_plain(h, W, lbl)
    emu = max((z - ez).abs().max().item(), (picked - ep).abs().max().item())
    if not (err <= 1e-3 and emu <= TF32X3_ATOL
            and bool((picked[:64:4] == 0).all())):
        raise AssertionError(f"fused_ce_fwd float32: z/picked error {err}, "
                             f"{emu} against the tf32x3 emulation")
    del ez, ep
    row = {"phase": "kernel_training", "name": "fused_ce_f32",
           "shape": f"N={N} V={V} H={H} float32, 48 labels out of range",
           "plan": fce.ce_plan(N, V, torch.cuda.get_device_properties(
               0).multi_processor_count, fce.VOCAB_TILES[torch.float32]),
           "tf32x3_emulation_err": emu, "tf32x3_atol": TF32X3_ATOL,
           "ms": _time_ms(lambda: fce.fused_ce_fwd(h, W, lbl), reps=3,
                          flush=flush),
           "plain_ms": _time_ms(lambda: fce.fused_ce_fwd_plain(h, W, lbl),
                                reps=3, flush=flush),
           "library_ms": _time_ms(lambda: torch.logsumexp(
               matmul_f32out(h, W.t()), -1), reps=3, flush=flush),
           "library_calls": "torch.mm (float32, TF32 off) + torch.logsumexp",
           "max_abs_err": err, "atol": 1e-3,
           # three TF32 products a product: the lower bound; FFMA beside
           **_bound((N * H + V * H) * 4 + N * 12, 3 * 2 * N * V * H, "tf32"),
           "ffma": _bound((N * H + V * H) * 4 + N * 12, 2 * N * V * H,
                          "float32")}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_share_ffma"] = row["ffma"]["bound_ms"] / row["ms"]
    _log(row)
    results["fused_ce_f32"] = row
    del h, W, lbl, z, picked, wz, wp, flush
    torch.cuda.empty_cache()
    results["tf32_witness"] = tf32_witness(fa, fce, gen)
    _log({"phase": "tf32_witness", **results["tf32_witness"]})
    w = results["tf32_witness"]
    if not all(w[k]["kernel"] <= 1 < w[k]["one_pass"] for k in w):
        raise AssertionError(f"single-pass TF32 witness: {w}")
    results["tf32x3_forward_drift"] = tf32x3_forward_drift(fa, gen)
    _log({"phase": "tf32x3_forward_drift", "limit": TF32X3_REL,
          "shares": results["tf32x3_forward_drift"]})
    return results


def tf32x3_forward_drift(fa, gen):
    """Reported, not asserted: the share of its TF32X3_REL limits the
    float32 forward uses against its emulation past the training shape,
    causal: [1, 2048, 16x128] and [1, 4096, 16x128] (longer accumulation
    chains in P V and the online softmax) and [2, 1024, 16x64]."""
    rows = {}
    for B, S, hD in ((1, 2048, 128), (1, 4096, 128), (2, 1024, 64)):
        q, k, v = (torch.randn((B, S, 16, hD), generator=gen, device="cuda")
                   for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        rows[f"B={B} S={S} nH=16 hD={hD}"] = tf32x3_forward_share(
            fa, q, k, v, out, lse, True, 0)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return rows


# The float32 kernels against their tf32x3 emulation: the same split
# products, but the tensor cores add k8 steps into float32 with
# truncation where the emulation rounds (the CE kernel in chains of 12,
# the forward's S in one of 3 hD / 8 and P V in chains of 12 a tile),
# and the forward's online softmax rescales P tile by tile.  A dropped hi.lo or
# lo.hi product moves a logit by ~2^-12 of its terms (~6e-4 at the CE
# shape), so the limits sit an order below that and below the float32
# limits (1e-3, 1e-4 of max).
TF32X3_ATOL = 1e-4     # CE z and picked
TF32X3_REL = 5e-5      # forward out (of max |out|) and lse (relative)


def tf32x3_forward_share(fa, q, k, v, out, lse, causal, offset):
    """The share of its limit the float32 forward's worst element uses
    against ``flash_attention_fwd_tf32x3_plain`` (the same split products,
    another summation order and the online softmax's rescaling): out
    within TF32X3_REL of max |out|, lse within TF32X3_REL relative."""
    e_out, e_lse = fa.flash_attention_fwd_tf32x3_plain(q, k, v, offset,
                                                       causal=causal)
    lse_lim = TF32X3_REL * e_lse.abs().clamp_min(1.0)
    return {"out": _limit_share(out, e_out, TF32X3_REL, of_max=True),
            "lse": ((lse - e_lse).abs() / lse_lim).max().item()}


def tf32x3_backward_share(fa, q, k, v, dout, lse, delta, grads, causal,
                          offset):
    """The share of its limit the float32 dK/dV and dQ kernels' worst
    elements use against ``flash_attention_bwd_{dkv,dq}_tf32x3_plain``
    (the same split products, another summation order; the kernels sum
    each tile's products from zero): each of ``grads`` = (dk, dv, dq)
    within TF32X3_REL of its max."""
    e_dk, e_dv = fa.flash_attention_bwd_dkv_tf32x3_plain(
        q, k, v, dout, lse, delta, causal, None, offset)
    e_dq = fa.flash_attention_bwd_dq_tf32x3_plain(q, k, v, dout, lse, delta,
                                                  causal, None, offset)
    return {name: _limit_share(got, want, TF32X3_REL, of_max=True)
            for name, got, want in zip(("dk", "dv", "dq"), grads,
                                       (e_dk, e_dv, e_dq))}


def tf32_witness(fa, fce, gen):
    """Inputs on which one TF32 pass (each operand rounded to TF32 once)
    leaves the float32 limits and the kernels (three products of split
    operands) stay within them; the share of its limit each takes
    against the float32 plain version (a passing witness: kernel <= 1 <
    one pass).  CE at [2048, 50304, 2048] with W at 0.1 N(0, 1) (logits
    ~4.5 wide: one pass moves a logit by ~1e-3), atol 1e-3; the forward
    at [2, 1024, 16x128] causal with q and k at 3 N(0, 1) (scores ~9
    wide, sharp rows), out 1e-4 of max |out|; the backward (dK/dV and dQ)
    on the same inputs with dO ~ N(0, 1), each grad 1e-4 of its max (the
    kernel's worst grad; one pass: the worst of q * scale, k, v and dO
    rounded once, P and dS kept float32)."""
    from paddle_tpu_torch.incubate.nn.kernels.tf32x3 import tf32_round
    N, V, H = 2048, 50304, 2048
    h = torch.randn((N, H), generator=gen, device="cuda")
    W = torch.randn((V, H), generator=gen, device="cuda") * 0.1
    lbl = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    wz, wp = fce.fused_ce_fwd_plain(h, W, lbl)

    def ce_share(z, p):
        return max((z - wz).abs().max().item(),
                   (p - wp).abs().max().item()) / 1e-3

    out = {"fused_ce": {"kernel": ce_share(*fce.fused_ce_fwd(h, W, lbl)),
                        "one_pass": ce_share(*fce.fused_ce_fwd_plain(
                            tf32_round(h), tf32_round(W), lbl))}}
    del h, W, wz, wp
    B, S, nH, hD = 2, 1024, 16, 128
    q, k = (3 * torch.randn((B, S, nH, hD), generator=gen, device="cuda")
            for _ in range(2))
    v = torch.randn((B, S, nH, hD), generator=gen, device="cuda")
    got, _ = fa.flash_attention_fwd(q, k, v, True)
    want, _ = fa.flash_attention_with_lse_plain(q, k, v, 0)
    one, _ = fa.flash_attention_with_lse_plain(
        tf32_round(q * hD ** -0.5), tf32_round(k), tf32_round(v), 0,
        scale=1.0)
    out["flash_attention_fwd"] = {
        "kernel": _limit_share(got, want, F32_REL, of_max=True),
        "one_pass": _limit_share(one, want, F32_REL, of_max=True)}
    # the backward on the same inputs, dO ~ N(0, 1), from the plain
    # forward's out and lse; one pass: q * scale, k, v and dO rounded once
    dout = torch.randn((B, S, nH, hD), generator=gen, device="cuda")
    del got, one
    w_out, lse = fa.flash_attention_with_lse_plain(q, k, v, 0)
    delta = (dout * w_out).sum(-1).transpose(1, 2).contiguous()
    del w_out
    kernel = (*fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta),
              fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta))
    want = (*fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta),
            fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta))
    r = (tf32_round(q * hD ** -0.5), tf32_round(k), tf32_round(v),
         tf32_round(dout), lse, delta, True, 1.0)
    one = (*fa.flash_attention_bwd_dkv_plain(*r),
           fa.flash_attention_bwd_dq_plain(*r) * hD ** -0.5)
    names = ("dk", "dv", "dq")
    shares = {n: {"kernel": _limit_share(a, w, F32_REL, of_max=True),
                  "one_pass": _limit_share(o, w, F32_REL, of_max=True)}
              for n, a, o, w in zip(names, kernel, one, want)}
    out["flash_attention_bwd"] = {
        "kernel": max(s["kernel"] for s in shares.values()),
        "one_pass": max(s["one_pass"] for s in shares.values()),
        "by_grad": shares}
    torch.cuda.empty_cache()
    return out


def _rounded_once_bwd(q, k, v, dout, lse, delta, dt):
    """(dk, dv, dq) of causal attention with P and dS rounded once to
    bf16 before their products, as the TPU kernels round them
    (``p.astype(do.dtype)``, ``ds.astype(q.dtype)``), every other step
    computed in ``dt``; results in bf16."""
    def bf(x):
        return x.to(torch.bfloat16).to(dt)
    S, scale = q.shape[1], q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    s = s.masked_fill(~_visible(S, S, 0, q.device), -1e30)
    p = torch.exp(s - lse.to(dt)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(dt), v.to(dt))
    ds = p * (dp - delta.to(dt)[..., None]) * scale
    return [t.to(torch.bfloat16) for t in (
        torch.einsum("bhqk,bqhd->bkhd", bf(ds), q.to(dt)),
        torch.einsum("bhqk,bqhd->bkhd", bf(p), dout.to(dt)),
        torch.einsum("bhqk,bkhd->bqhd", bf(ds), k.to(dt)))]


def rounding_witness_phase(fa):
    """Why the bf16 kernels keep P and dS to 16 bits (two bf16 halves)
    where the TPU kernels round them once: the backward with P and dS
    rounded once, computed twice, in float32 and in float64, at the GPT
    training shape (B 8, S 1024, 16 heads of 128, causal, the kernel's
    lse and delta).  Both are right; a score that lands near a bf16 tie
    rounds apart in the two, and the per-element limit of the kernel
    checks (one bf16 step + 1e-3) reads the difference.  Reported, not
    asserted: the share of that limit each gradient uses."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    B, S, nH, hD = 8, 1024, 16, 128
    q, k, v, dout = (torch.randn((B, S, nH, hD), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    f32 = _rounded_once_bwd(q, k, v, dout, lse, delta, torch.float32)
    f64 = _rounded_once_bwd(q, k, v, dout, lse, delta, torch.float64)
    row = {"phase": "rounding_witness",
           "shape": f"B={B} S={S} nH={nH} hD={hD} bfloat16 causal",
           "limit_share_f32_vs_f64": {
               n: _limit_share(a, b, F32_REL)
               for n, a, b in zip(("dk", "dv", "dq"), f32, f64)}}
    _log(row)
    del q, k, v, dout, out, lse, delta, f32, f64
    torch.cuda.empty_cache()
    return row


def train_reference_phase(gpt, hybrid, fa, fce):
    """gpt_tiny f32: three steps on the card (flash kernels) against the
    CPU (plain versions) on the same weights and batch; rel 1e-4.  The
    float32 instances of the flash kernels launch here (counted over the
    card's steps), and so does the float32 ``fused_ce_fwd``: the eval
    loss (no grad) on the card against the CPU's, rel 1e-4, one launch.
    Returns the launches of the float32 instances."""
    cfg = gpt.gpt_tiny(dtype=torch.float32)
    params = gpt.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
    launches = {}
    for num_micro, remat in ((1, False), (2, True)):
        losses = {}
        for dev in ("cpu", "cuda"):
            step, shard, init_opt = hybrid.build_train_step(
                cfg, num_micro=num_micro, remat=remat, device=dev)
            p = shard(params)
            o = init_opt(p)
            out = []
            fa.reset_launches()
            for _ in range(3):
                loss, p, o = step(p, o, ids.to(dev), labels.to(dev))
                out.append(loss.item())
            losses[dev] = out
        for name, n in fa.LAUNCHES.items():
            if n:
                launches[name] = launches.get(name, 0) + n
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        if not rel <= 1e-4:
            raise AssertionError(f"train reference {num_micro}/{remat}: "
                                 f"card {losses['cuda']} vs CPU "
                                 f"{losses['cpu']}")
        _log({"phase": "reference_training", "config": "gpt_tiny f32",
              "num_micro": num_micro, "remat": remat,
              "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
              "max_rel_diff": rel, "rtol": 1e-4})
    before = fce.LAUNCHES
    with torch.no_grad():
        evals = [gpt.loss_fn(_to_device(params, dev), ids.to(dev),
                             labels.to(dev), cfg).item()
                 for dev in ("cpu", "cuda")]
    launches["fused_ce_fwd"] = fce.LAUNCHES - before
    rel = abs(evals[1] - evals[0]) / abs(evals[0])
    if not (rel <= 1e-4 and launches["fused_ce_fwd"] == 1):
        raise AssertionError(f"eval loss f32: card {evals[1]} vs CPU "
                             f"{evals[0]}, {launches['fused_ce_fwd']} "
                             f"fused_ce launches")
    _log({"phase": "reference_training_f32_launches",
          "config": "gpt_tiny f32, 3 steps at (1, False) and (2, True), "
                    "then one eval loss", "eval_loss_card_cpu": evals,
          "launches": launches})
    return launches


def _train_batch(cfg, B=8, S=1024):
    """The training phases' one batch: seeded random ids and labels."""
    rng = np.random.default_rng(0)
    return tuple(torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda") for _ in range(2))


def training_phase(gpt, hybrid, TrainLoop, fa, fce):
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    B, S = 8, 1024
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, shard, init_opt = hybrid.build_train_step(
        cfg, num_micro=1, remat=False, device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    opt = init_opt(params)
    ids, labels = _train_batch(cfg, B, S)
    torch.cuda.synchronize()
    _log({"phase": "training_setup", "params": gpt.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    first, params, opt = step(params, opt, ids, labels)     # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(step, max_inflight=2)
    handles = []
    for _ in range(4):
        d, params, opt = loop.step(params, opt, ids, labels)
        handles.append(d)
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches()
    losses = [first.item()] + [float(d) for d in handles]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    if launches != {name: 4 * L for name in launches}:
        raise AssertionError(f"flash_attention launches {launches} != "
                             f"{L} per step x 4 steps")
    step_ms = wall / 4 * 1e3
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(params, opt, ids, labels)

    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(one_step, 1, wall_ms, [
        ("flash_fwd", ("flash_attention_fwd",)),
        ("flash_bwd", ("flash_attention_bwd",))], top_n=24)
    row = {"phase": "training", "config": "gpt3_1p3b bf16", "B": B, "S": S,
           "num_micro": 1, "remat": False, "moments": "float32",
           "losses": losses, "launches_4_steps": launches,
           "step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3),
           "stall_s": loop.stall_seconds, "peak_memory_bytes": peak,
           "profiled_step_wall_ms": wall_ms, **prof}
    _log(row)

    # the differentiated (scan) loss at these params, no remat
    ref, grads = step.loss_and_grads(params, ids, labels)
    ref = ref.item()
    del grads
    fce.LAUNCHES = 0
    with torch.no_grad():
        ev = gpt.loss_fn(params, ids, labels, cfg).item()
    ce_launches = fce.LAUNCHES
    if ce_launches != 1 or not abs(ev - ref) <= LOSS_TOL:
        raise AssertionError(f"eval loss {ev} ({ce_launches} fused_ce "
                             f"launches) vs differentiated {ref}")
    # where the eval loss's time goes (the fused head by family)
    with torch.no_grad():
        eval_prof = _step_profile(
            lambda: gpt.loss_fn(params, ids, labels, cfg),
            families=(("fused_ce", ("fused_ce",)),
                      ("flash_fwd", ("flash_attention_fwd",))))
    # the same loss through the plain composition: no flash kernel
    with torch.no_grad():
        ev_plain = gpt.loss_fn(params, ids, labels, dataclasses.replace(
            cfg, use_flash=False)).item()
    _log({"phase": "eval_plain_attention", "differentiated_loss": ref,
          "plain_attention_loss": ev_plain, "atol": LOSS_TOL})
    if not abs(ev_plain - ref) <= LOSS_TOL:
        raise AssertionError(f"plain-attention loss {ev_plain} vs flash "
                             f"{ref}")
    step_r, _, _ = hybrid.build_train_step(cfg, num_micro=1, remat=True,
                                           device="cuda")
    fa.reset_launches()
    t0 = time.perf_counter()
    rl, params, opt = step_r(params, opt, ids, labels)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    rl = rl.item()
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    remat_launches = fa.launches()
    if remat_launches != want or not abs(rl - ref) <= LOSS_TOL:
        raise AssertionError(f"remat step: launches {remat_launches} (want "
                             f"{want}), loss {rl} vs {ref}")
    # the optimizer alone, on gradients at these params
    _, grads = step.loss_and_grads(params, ids, labels)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    hybrid.adamw_update(params, grads, opt, hybrid.AdamWConfig())
    b.record()
    torch.cuda.synchronize()
    del grads
    row["eval"] = {k: eval_prof[k] for k in (
        "wall_ms", "device_ms", "device_busy_ms", "idle_share",
        "sm_clock_power")}
    _log({"phase": "eval_and_remat", "differentiated_loss": ref,
          "eval_loss": ev, "fused_ce_launches": ce_launches,
          "eval_profile": row["eval"],
          "remat_loss": rl, "remat_launches": remat_launches,
          "remat_step_ms": remat_ms, "atol": LOSS_TOL,
          "adamw_update_ms": a.elapsed_time(b),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return row, launches, ce_launches


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _named_leaves(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def plain_training_phase(gpt, hybrid, fa, flash_losses):
    """The full-width training step against one through the plain
    softmax composition (``use_flash=False``), which launches no flash
    kernel: the gradients at the seed-0 init, then a 5-step trajectory
    from it on the training phase's batch, held to that phase's."""
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    ids, labels = _train_batch(cfg)
    step, shard, init_opt = hybrid.build_train_step(
        cfg, num_micro=1, remat=False, device="cuda")
    step_p, _, _ = hybrid.build_train_step(
        plain_cfg, num_micro=1, remat=False, device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    opt = init_opt(params)
    lf, gf = step.loss_and_grads(params, ids, labels)
    before = dict(fa.LAUNCHES)
    lp, gp = step_p.loss_and_grads(params, ids, labels)
    grad_rel = {}
    for (name, a), (_, b) in zip(_named_leaves(gf), _named_leaves(gp)):
        grad_rel[name] = ((a.float() - b.float()).norm()
                          / b.float().norm()).item()
    del gf, gp
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, params, opt = step_p(params, opt, ids, labels)
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
    diffs = [abs(a - b) for a, b in zip(losses, flash_losses)]
    row = {"phase": "plain_attention_training",
           "config": "gpt3_1p3b bf16, use_flash=False", "B": 8, "S": 1024,
           "init_loss_flash": lf.item(), "init_loss_plain": lp.item(),
           "grad_rel_diff": grad_rel, "losses_plain": losses,
           "losses_flash": flash_losses, "loss_diffs": diffs,
           "flash_launches": launched,
           "synchronised_step_ms": times[1:],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "loss_atol": PLAIN_TRAJ_TOL, "grad_rel_tol": PLAIN_GRAD_REL}
    _log(row)
    if any(launched.values()):
        raise AssertionError(f"the plain path launched {launched}")
    if not abs(row["init_loss_flash"] - row["init_loss_plain"]) <= LOSS_TOL:
        raise AssertionError(f"init loss: flash {lf.item()} vs plain "
                             f"{lp.item()}")
    if not max(grad_rel.values()) <= PLAIN_GRAD_REL:
        raise AssertionError(f"gradients: flash vs plain {grad_rel}")
    if not max(diffs) <= PLAIN_TRAJ_TOL:
        raise AssertionError(f"trajectory: plain {losses} vs flash "
                             f"{flash_losses}")
    return row


F32_FAMILIES = (("flash_f32_fwd", ("flash_attention_fwd",)),
                ("flash_f32_dkv", ("flash_attention_bwd_dkv",)),
                ("flash_f32_dq", ("flash_attention_bwd_dq",)),
                ("fused_ce", ("fused_ce",)))


def float32_training_phase(gpt, hybrid, TrainLoop, fa, fce):
    """gpt3_1p3b at its default dtype (float32, ``use_flash=None``: the
    float32 flash kernels in training, the float32 ``fused_ce_fwd`` in
    the no-grad loss) at full width: 1 warm + 4 AdamW steps through
    ``TrainLoop`` at B 2, S 1024, the loss falling; then the eval loss on
    the same batch (one ``fused_ce_fwd`` at N 2048) with its per-token
    (z, picked) held to ``fused_ce_fwd_plain`` on the same hidden states
    (atol 1e-3).  Step ms (host clock and CUDA events), peak memory, a
    one-step profile by family (idle share), the float32 launches a step
    and an eval, the eval's device ms and the CE's share of it."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 phase entered with TF32 matmuls on")
    cfg = gpt.gpt3_1p3b()
    if cfg.dtype != torch.float32 or cfg.use_flash is not None:
        raise AssertionError(f"gpt3_1p3b defaults: {cfg.dtype}, "
                             f"use_flash={cfg.use_flash}")
    B, S, L = 2, 1024, cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, shard, init_opt = hybrid.build_train_step(
        cfg, num_micro=1, remat=False, device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    opt = init_opt(params)
    ids, labels = _train_batch(cfg, B, S)
    first, params, opt = step(params, opt, ids, labels)     # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    loop = TrainLoop(step, max_inflight=2)
    handles = []
    for _ in range(4):
        d, params, opt = loop.step(params, opt, ids, labels)
        handles.append(d)
    loop.drain()
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_event_ms = a.elapsed_time(b) / 4
    launches = fa.launches()
    losses = [first.item()] + [float(d) for d in handles]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"float32 training losses {losses}")
    if launches != {name: 4 * L for name in launches}:
        raise AssertionError(f"float32 flash launches {launches} != {L} "
                             f"per step x 4 steps")

    def one_step():
        step(params, opt, ids, labels)

    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(one_step, 1, wall_ms, list(F32_FAMILIES), top_n=12)
    peak = torch.cuda.max_memory_allocated()

    # the eval loss: one float32 fused_ce_fwd at N = B S
    before = fce.LAUNCHES
    fa.reset_launches()
    with torch.no_grad():
        a.record()
        ev = gpt.loss_fn(params, ids, labels, cfg).item()
        b.record()
    torch.cuda.synchronize()
    eval_launches = {"fused_ce_fwd": fce.LAUNCHES - before,
                     **fa.launches()}
    if eval_launches != {"fused_ce_fwd": 1, "flash_attention_fwd": L,
                         "flash_attention_bwd_dkv": 0,
                         "flash_attention_bwd_dq": 0}:
        raise AssertionError(f"eval launches {eval_launches}")
    eval_event_ms = a.elapsed_time(b)
    with torch.no_grad():
        eval_prof = _step_profile(
            lambda: gpt.loss_fn(params, ids, labels, cfg), n=3,
            families=F32_FAMILIES)
        # the head's input, as _head_loss computes it
        h = gpt.forward_layers(gpt.embed(params, ids, cfg), params["layers"],
                               cfg)
        h = gpt._layer_norm(h, params["lnf_g"], params["lnf_b"],
                            cfg.layer_norm_epsilon).reshape(B * S, -1)
        lbl = labels.reshape(-1).to(torch.int32)
        z, picked = fce.fused_ce_fwd(h, params["wte"], lbl)
        wz, wp = fce.fused_ce_fwd_plain(h, params["wte"], lbl)
    errs = {"z": (z - wz).abs().max().item(),
            "picked": (picked - wp).abs().max().item(),
            "eval_loss": abs(ev - (wz - wp).mean().item())}
    row = {"phase": "float32_training",
           "config": "gpt3_1p3b defaults (float32, use_flash=None)",
           "B": B, "S": S, "num_micro": 1, "remat": False,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "losses": losses, "launches_4_steps": launches,
           "launches_per_step": {k: v / 4 for k, v in launches.items()},
           "step_ms_host": wall / 4 * 1e3,
           "step_ms_events": step_event_ms,
           "stall_s": loop.stall_seconds, "peak_memory_bytes": peak,
           "profiled_step_wall_ms": wall_ms, "step_profile": prof,
           "eval_loss": ev, "eval_launches": eval_launches,
           "eval_ms_events": eval_event_ms,
           "eval_profile": {k: eval_prof[k] for k in (
               "wall_ms", "device_ms", "device_busy_ms", "idle_share",
               "sm_clock_power", "top_kernels_ms_count_name")},
           "eval_fused_ce_share": eval_prof["device_ms"]["fused_ce"]
           / max(eval_prof["device_busy_ms"], 1e-9),
           "eval_token_errors": errs, "atol": 1e-3}
    _log(row)
    if not max(errs.values()) <= 1e-3:
        raise AssertionError(f"float32 eval loss against fused_ce_fwd_plain: "
                             f"{errs}")
    return row


FUSED_POS = (0, 1, 7, 8, 255, 256, 257, 511, 700, 1023)  # of a T 1024 cache
FUSED_TIMED_POS = (64, 512, 1023)
FUSED_H_REL = 2 ** -6                        # h_out row 0, of its max
FUSED_SUM_ORDER = 2 ** -16     # of a written row's max: float32 sum order
FUSED_CARRIED = 2 ** -7        # of a written row's max, layers >= 1
FUSED_SCALE0_REL = 1e-5        # int8 scales of layer 0, relative
FUSED_WITNESS_POS = (0, 700)   # plain on the card against the CPU
FUSED_FAMILIES = (("fused_decode", ("fused_decode",)),
                  ("flash_decode", ("flash_decode",)))


def _fused_store(kvq, x, mode):
    """K/V x [2, L, T, nH, hD] float32 in the kernel's flat [L, T, H]
    layout and a storage mode ("f32"/"bf16": the model dtype, "int8"
    with [L, T, nH] scale planes, "fp8"): (ck, cv, scales or None)."""
    L, T, nH, hD = x.shape[1:]
    if mode == "int8":
        (ck, ks), (cv, vs) = (kvq.quantize_kv(x[i], "int8") for i in range(2))
        return (ck.reshape(L, T, nH * hD), cv.reshape(L, T, nH * hD),
                (ks.reshape(L, T, nH).contiguous(),
                 vs.reshape(L, T, nH).contiguous()))
    if mode == "fp8":
        ck, cv = (kvq.quantize_kv(x[i], "fp8")[0].reshape(L, T, nH * hD)
                  for i in range(2))
        return ck, cv, None
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    return (x[0].reshape(L, T, nH * hD).to(dt),
            x[1].reshape(L, T, nH * hD).to(dt), None)


def _fused_work(cfg, pos, kv_elem, scale_bytes, small_elem):
    """Bytes and operations of one fused step at ``pos``: every int8
    weight read once; the float32 per-channel scales, one per output
    column (qkv 3H, proj H, fc1 F, fc2 H: 5H + F a layer); the biases
    (qkv 3H, proj H, fc1 F, fc2 H) and LN parameters (4H) in the model
    dtype (9H + F a layer); the K/V history rows < pos read once (data
    and int8 scales), the two new rows written, h0 row 0 and pos read,
    h_out [8, H] written; 2 operations per weight and 4*hD per (row
    attended, head)."""
    L, H, F, nH = (cfg.num_layers, cfg.hidden_size, cfg.ffn_size,
                   cfg.num_heads)
    weights = L * (3 * H * H + H * H + 2 * H * F)
    row = H * kv_elem + nH * scale_bytes
    nbytes = (weights + L * (5 * H + F) * 4 + L * (9 * H + F) * small_elem
              + 2 * L * (pos + 1) * row + 4 * H + 4 + 32 * H)
    return nbytes, 2 * weights + 4 * H * L * (pos + 1)


def _fused_errors(kvq, got, want, before, pos, mode):
    """Kernel against plain at one position: h_out row 0 within
    FUSED_H_REL of its largest value, rows 1-7 zero; every row other
    than pos bit for bit; the written rows in storage units, each
    element within one step of its storage (bf16: 2^-7 |want|; fp8:
    2^-3 |want|; float32: none; int8: one quantum).  Layer 0 reads the
    same inputs in both versions: its rows add only FUSED_SUM_ORDER of
    the row's largest value (the float32 sums run in another order) and,
    for fp8, the subnormal step 2^-9; its int8 scales are held to
    FUSED_SCALE0_REL.  Layers >= 1 add FUSED_CARRIED of the row's
    largest value (int8 scales: FUSED_CARRIED relative): now and then a
    bf16 rounding point (LN output, q, p, GELU output) flips by one
    step, and the sharp softmax over the history carries such a step
    into the next layers — at 24 layers the hidden state differs by
    ~2e-3 of its largest value, as much as the plain version moves
    between the card and the CPU (``_plain_order_witness``).  Returns
    the shares of each limit used (all layers, and layer 0) and the
    errors."""
    h, w = got[0][0], want[0][0]
    err = (h - w).abs().max().item()
    out = {"h_max_abs_err": err, "h_max": w.abs().max().item()}
    out["h_share"] = err / (FUSED_H_REL * out["h_max"])
    if not (torch.isfinite(h).all() and out["h_share"] <= 1
            and not got[0][1:].any()):
        raise AssertionError(f"fused_decode {mode} pos {pos}: h_out {out}")
    keep = torch.ones(got[1].shape[1], dtype=torch.bool, device="cuda")
    keep[pos] = False
    shares = []
    for g, x, b in zip(got[1:], want[1:], before):
        if not torch.equal(kvq.byte_view(g)[:, keep],
                           kvq.byte_view(b)[:, keep]):
            raise AssertionError(f"fused_decode {mode} pos {pos}: a row "
                                 f"other than pos changed")
        gr, xr = g[:, pos].float(), x[:, pos].float()
        top = xr.abs().amax(1, keepdim=True)
        if g.dtype == torch.int8:
            lim = torch.ones_like(xr)
        elif g.dtype == torch.float32 and mode == "int8":   # scale planes
            lim = FUSED_CARRIED * xr.abs()
            lim[0] = FUSED_SCALE0_REL * xr[0].abs()
            out["scale_rel_layer0"] = max(
                out.get("scale_rel_layer0", 0.0),
                ((gr[0] - xr[0]).abs() / xr[0].abs()).max().item())
        else:
            step = {torch.bfloat16: 2 ** -7 * xr.abs(),
                    torch.float8_e4m3fn: 2 ** -3 * xr.abs(),
                    torch.float32: 0 * xr}[g.dtype]
            lim = step + FUSED_CARRIED * top
            lim[0] = step[0] + FUSED_SUM_ORDER * top[0] + (
                2 ** -9 if g.dtype == torch.float8_e4m3fn else 0.0)
        share = (gr - xr).abs() / lim
        shares.append((share.max().item(), share[0].max().item()))
    out["row_share"] = max(s for s, _ in shares)
    out["row_share_layer0"] = max(s for _, s in shares)
    if not out["row_share"] <= 1:
        raise AssertionError(f"fused_decode {mode} pos {pos}: written rows "
                             f"{shares} of their limits (all layers, "
                             f"layer 0)")
    return out


def _plain_order_witness(fdl, qlayers, h0, state, nH, eps, positions):
    """The plain version on the CPU against the plain version on the
    card, on the same inputs: only the order of the float32 sums differs
    (the CPU's GEMVs against cuBLAS), no kernel is involved.  How far
    h_out row 0 moves is how far a bf16 rounding flip, carried through
    the layers, moves it.  Returns {pos: max |diff| / max |h_out|}."""
    out = {}
    cpu_layers = _to_device(qlayers, "cpu")
    for pos in positions:
        rows = []
        for dev, layers in (("cuda", qlayers), ("cpu", cpu_layers)):
            ck, cv, *s = (t.to(dev, copy=True) for t in state)
            rows.append(fdl.fused_decode_layers_plain(
                h0.to(dev), layers, ck, cv, pos, nH, eps=eps,
                scales=tuple(s) or None)[0][0].cpu())
            del ck, cv, s
        out[str(pos)] = ((rows[0] - rows[1]).abs().max()
                         / rows[1].abs().max()).item()
    return out


def fused_kernel_phase(fdl, kvq, gpt, cfg, qparams):
    """fused_decode_layers against its plain version on the card in the
    four storage modes — an f32 cache at gpt_tiny width (seed-1 weights,
    quantized), bf16, int8 and fp8 at gpt3_1p3b (the serving weights,
    quantized) — at positions FUSED_POS of a T 1024 cache filled from a
    seed (``_fused_errors``); the plain version on the card against the
    CPU at FUSED_WITNESS_POS (bf16 cache); then the kernel's time at
    FUSED_TIMED_POS beside its bound and its share, and the plain
    version's at 512; the launch plan (grid, threads, ring stages) and
    the grid barriers a token, as the kernel counted them (at most 6 a
    layer).  No single library call computes a layer stack: the per-op
    int8 step's time stands in for it (the fused serving phase)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    tiny = gpt.gpt_tiny(dtype=torch.float32)
    tq = gpt.quantize_decode_params(gpt.init_params(tiny, seed=1,
                                                    device="cuda"), tiny)
    T = 1024
    results = {}
    for mode, c, qp in (("f32", tiny, tq), ("bf16", cfg, qparams),
                        ("int8", cfg, qparams), ("fp8", cfg, qparams)):
        L, H, nH = c.num_layers, c.hidden_size, c.num_heads
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        x = torch.randn((2, L, T, nH, H // nH), generator=gen, device="cuda")
        ck, cv, sc = _fused_store(kvq, x, mode)
        del x
        state = (ck, cv) + (sc or ())
        h0 = torch.zeros((8, H), device="cuda")
        h0[0] = torch.randn((H,), generator=gen, device="cuda")
        eps = c.layer_norm_epsilon

        def call(pos, fn=fdl.fused_decode_layers, tensors=state):
            ck, cv, *s = tensors
            return fn(h0, qp["layers"], ck, cv, pos, nH, eps=eps,
                      scales=tuple(s) or None)

        worst, h_rel = {}, {}
        for pos in FUSED_POS:
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            before = [t.clone() for t in state]
            got = call(p)
            torch.cuda.synchronize()
            want = call(p, fdl.fused_decode_layers_plain,
                        [t.clone() for t in before])
            errs = _fused_errors(kvq, got, want, before, pos, mode)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            h_rel[str(pos)] = errs["h_max_abs_err"] / errs["h_max"]
            for t, b in zip(state, before):      # the seeded cache again
                kvq.byte_view(t).copy_(kvq.byte_view(b))
            del before, got, want
        witness = {} if mode != "bf16" else {
            "plain_card_vs_cpu_h_rel": _plain_order_witness(
                fdl, qp["layers"], h0, state, nH, eps, FUSED_WITNESS_POS)}
        small_elem = qp["layers"]["ln1_g"].element_size()
        kv_elem = ck.element_size()
        timed = {}
        for pos in FUSED_TIMED_POS:
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            nbytes, ops = _fused_work(c, pos, kv_elem,
                                      4 if mode == "int8" else 0, small_elem)
            ms = _time_ms(lambda: call(p), flush=flush)
            bound = _bound(nbytes, ops, "bfloat16")
            timed[str(pos)] = {"ms": ms, **bound,
                               "bound_share": bound["bound_ms"] / ms}
        barriers = fdl.last_barriers()
        if not barriers == fdl.barriers_per_token(L) <= 6 * L:
            raise AssertionError(f"fused_decode {mode}: {barriers} grid "
                                 f"barriers a token, want "
                                 f"{fdl.barriers_per_token(L)}")
        plan = fdl.kernel_plan(h0.device, H, c.ffn_size, T, nH)
        p = torch.tensor([512], dtype=torch.int32, device="cuda")
        row = {"phase": "kernel_fused", "mode": mode,
               "shape": f"L={L} H={H} nH={nH} F={c.ffn_size} T={T} cache "
                        f"{mode}, params {str(c.dtype).split('.')[-1]}",
               "positions_checked": list(FUSED_POS), **worst,
               "max_abs_err": worst["h_max_abs_err"], "h_rel": h_rel,
               **witness, "timed": timed,
               "grid": f"{plan['grid']} x {plan['threads']}",
               "ring_stages": plan["stages"],
               "dynamic_smem_bytes": plan["smem"],
               "barriers_per_token": barriers,
               "plain_ms_at_512": _time_ms(
                   lambda: call(p, fdl.fused_decode_layers_plain), reps=3,
                   flush=flush)}
        _log(row)
        results[mode] = row
        del state, ck, cv, sc
        torch.cuda.empty_cache()
    del flush, tq
    torch.cuda.empty_cache()
    return results


def fused_reference_phase(gpt, FusedEngine, fdl):
    """gpt_tiny f32 with int8 weights: FusedB1Engine on the card gives
    the CPU FusedB1Engine's greedy streams at kv_dtype bf16, int8 and
    fp8, with one fused launch per decode step (none on the CPU)."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu = gpt.quantize_decode_params(
        gpt.init_params(cfg, seed=1, device="cpu"), cfg)
    gpu = _to_device(cpu, "cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m)
            for n, m in ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))]
    for kd in ("bf16", "int8", "fp8"):
        streams, launched = [], []
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = FusedEngine(params, cfg, max_len=256, kv_dtype=kd,
                              device=dev)
            fdl.reset_launches()
            rids = [eng.submit(p, max_new=m) for p, m in reqs]
            out = eng.run(steps_per_sync=8)
            streams.append([out[r] for r in rids])
            launched.append((fdl.LAUNCHES, eng.metrics()["decode_steps"]))
        if streams[0] != streams[1]:
            raise AssertionError(f"fused {kd}: card stream {streams[1]} != "
                                 f"CPU stream {streams[0]}")
        if launched[0][0] != 0 or launched[1][0] != launched[1][1]:
            raise AssertionError(f"fused {kd}: launches (CPU, card) "
                                 f"{launched}")
        _log({"phase": "reference_fused", "config": "gpt_tiny f32, int8 "
              "weights", "kv_dtype": kd, "requests": len(reqs),
              "card_launches_decode_steps": launched[1],
              "streams_identical": True})


def fused_serving_phase(gpt, Engine, FusedEngine, fd, fdl, cfg, qparams):
    """gpt3_1p3b with int8 weights (the serving weights, quantized by
    the port) behind FusedB1Engine(max_len=1024) and the per-op int8
    ContinuousBatchingEngine(max_batch=1), at kv_dtype bf16, int8 and
    fp8, "flash" prefill: the serving workload's first 3 requests
    (prompt lengths 601, 458, 373), max_new 32, steps_per_sync 16.
    Counts reset just before each run: the fused engine launches
    fused_decode once per decode step and flash_decode only for its
    prefills (24 each, dense mode); the per-op engine never launches
    fused_decode.  Stream agreement between the two is reported, not
    asserted (random full-width weights give near-tied logits).  Then
    one step of each at the state after the first prompt, on one shared
    cache: logits compared, profiled, and the per-op step timed as the
    fused kernel's stand-in yardstick."""
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens][:3]
    runs, streams_of = {}, {}
    for kd in ("bf16", "int8", "fp8"):
        mode = "dense" if kd == "bf16" else kd
        for label in ("fused", "per_op"):
            fused = label == "fused"
            kw = dict(max_len=1024, kv_dtype=kd, attn_kernel="flash",
                      device="cuda")
            eng = (FusedEngine(qparams, cfg, **kw) if fused
                   else Engine(qparams, cfg, max_batch=1, **kw))
            eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)  # warm-up
            eng.run()
            base = eng.metrics()
            fd.reset_launches()
            fdl.reset_launches()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new=32) for p in prompts]
            out = eng.run(steps_per_sync=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = eng.metrics()
            pk = "prefill_fused" if fused else "prefill"
            steps = m["decode_steps"] - base["decode_steps"]
            prefills = m["launches"][pk] - base["launches"][pk]
            counts = {"fused_decode": fdl.LAUNCHES,
                      **{f"fused_{k}": n for k, n in
                         fdl.MODE_LAUNCHES.items()},
                      "flash_decode": fd.LAUNCHES,
                      "flash_decode_paged": fd.PAGED_LAUNCHES,
                      **{f"flash_{k}": n for k, n in
                         fd.MODE_LAUNCHES.items()}}
            want = {k: 0 for k in counts}
            want["flash_decode"] = L * prefills
            want["flash_dense"] = L * prefills
            if fused:
                want["fused_decode"] = steps
                want[f"fused_{mode}"] = steps
            else:
                want["flash_decode"] += L * steps
                want[f"flash_{mode}"] += L * steps
            if counts != want or steps < 1 or prefills != len(prompts):
                raise AssertionError(f"{label} {kd}: launches {counts}, want "
                                     f"{want} ({steps} decode steps, "
                                     f"{prefills} prefills)")
            for rid in rids:
                req = eng.request(rid)
                if req.status != "DONE" or len(out[rid]) != 32 or not all(
                        0 <= t < cfg.vocab_size for t in out[rid]):
                    raise AssertionError(f"{label} {kd} request {rid}: "
                                         f"{req.status}, {out.get(rid)}")
            ttft = [eng.request(r).first_token_at
                    - eng.request(r).submitted_at for r in rids]
            dsec = m["decode_seconds"] - base["decode_seconds"]
            streams_of[(label, kd)] = [out[r] for r in rids]
            row = {"phase": "serving_b1", "engine": label, "kv_dtype": kd,
                   "prompt_lens": [int(n) for n in lens[:3]], "max_new": 32,
                   "cache_bytes": m["cache_bytes"], "launches": counts,
                   "decode_steps": steps, "prefills": prefills,
                   "tokens": 32 * len(rids), "wall_s": wall,
                   "decode_loop_s": dsec,
                   "decode_loop_tok_s": 32 * len(rids) / dsec,
                   "e2e_tok_s": 32 * len(rids) / wall,
                   "ttft_s": ttft, "ttft_mean_s": float(np.mean(ttft))}
            _log(row)
            runs[(label, kd)] = row
            del eng
            torch.cuda.empty_cache()
        a, b = streams_of[("fused", kd)], streams_of[("per_op", kd)]
        _log({"phase": "serving_b1_agreement", "kv_dtype": kd,
              "streams_equal": f"{sum(x == y for x, y in zip(a, b))}/3",
              "tokens_equal": f"{sum(p == q for x, y in zip(a, b) for p, q in zip(x, y))}/96"})

    # one step of each engine's decode at the state after prompt 0
    n0 = int(lens[0])
    ids = torch.tensor(prompts[0], device="cuda")[None]
    tok = torch.tensor(prompts[1][:1], dtype=torch.int32, device="cuda")
    pos = torch.tensor([n0], dtype=torch.int32, device="cuda")
    steps = {}
    for kd in ("bf16", "int8", "fp8"):
        cache = gpt.init_decode_cache(cfg, 1, 1024, kd, device="cuda")
        with torch.inference_mode():
            gpt.prefill_into_slots(qparams, ids, cfg, cache,
                                   torch.zeros(1, dtype=torch.long,
                                               device="cuda"),
                                   attn_kernel="flash")
            flat = gpt.flatten_decode_cache(cache, cfg)   # the same storage

            def fused_step():
                return gpt.decode_step_fused(qparams, flat, tok, pos, cfg)

            def per_op_step():
                return gpt.decode_step_multi(qparams, cache, tok, pos, cfg,
                                             attn_kernel="flash")

            lf, lp = fused_step()[0], per_op_step()[0]
            torch.cuda.synchronize()
            if not (torch.isfinite(lf).all() and torch.isfinite(lp).all()):
                raise AssertionError(f"b1 step {kd}: non-finite logits")
            row = {"phase": "b1_step", "kv_dtype": kd, "pos": n0,
                   "fused_vs_per_op_max_abs_logit_diff":
                       (lf - lp).abs().max().item(),
                   "logit_std": lp.std().item(),
                   "argmax_equal": bool(lf.argmax() == lp.argmax()),
                   "per_op_int8_step_ms": _time_ms(per_op_step, reps=10)}
            for label, fn in (("fused", fused_step), ("per_op", per_op_step)):
                prof = _step_profile(fn, FUSED_FAMILIES)
                row[label] = dict(tok_s=1e3 / prof["wall_ms"], **prof)
        _log(row)
        steps[kd] = row
        del cache, flat
        torch.cuda.empty_cache()
    return runs, steps


SPEC_K = 3                   # draft tokens a round in every speculative run
SPEC_REQS = ((5, 12), (40, 20), (17, 8), (90, 16), (3, 24))


def _spec_counts(fd, fdl, fnr):
    return {"flash_decode": fd.LAUNCHES,
            "flash_decode_paged": fd.PAGED_LAUNCHES,
            "split": fd.INSTANCE_LAUNCHES["split"],
            "fused_decode": fdl.LAUNCHES, "rms_llama": fnr.LAUNCHES["llama"],
            "rms_add_llama": fnr.LAUNCHES["add_llama"]}


def _spec_reset(fd, fdl, fnr):
    fd.reset_launches()
    fdl.reset_launches()
    fnr.reset_launches()


def _spec_deltas(m, base):
    """The scheduler counters of one run: metrics ``m`` less the
    warm-up's ``base`` (every launch kind, decode and draft steps,
    decode seconds, the speculative counters)."""
    kinds = set(m["launches"]) | set(base["launches"])
    out = {k: m["launches"].get(k, 0) - base["launches"].get(k, 0)
           for k in kinds}
    for key in ("decode_steps", "draft_steps", "decode_seconds"):
        out[key] = m[key] - base[key]
    s, b = m.get("speculative"), base.get("speculative")
    if s is not None:
        for key in ("proposed", "accepted", "emitted", "launches",
                    "slot_launches", "rollbacks"):
            out[f"spec_{key}"] = s[key] - b[key]
    return out


def _spec_want(kind, d, L, Ld, llama_draft=False):
    """The launches a run must count, from its deltas ``d``: flash_decode
    L a target decode step, verify round and prefill (paged: decode steps
    and verify rounds in the paged layout; fused: the fused kernel once a
    decode step and once a verify position, proposed + rounds), the
    draft's Ld a draft step and a draft prefill; RMS "llama" one a LLaMA
    draft step and a draft prefill (layer 0's attention norm), its fused
    residual-add instance 2 Ld a draft step and 2 Ld - 1 a draft
    prefill (``_rms_launches``)."""
    steps, rounds = d["decode_steps"], d.get("verify", 0)
    prefills = d.get("prefill", 0) + d.get("prefill_fused", 0)
    draft = Ld * (d["draft_steps"] + d.get("draft_prefill", 0))
    want = {"flash_decode": L * prefills + draft, "flash_decode_paged": 0,
            "fused_decode": 0, "rms_llama": 0, "rms_add_llama": 0}
    if kind == "contiguous":
        want["flash_decode"] += L * (steps + rounds)
    elif kind == "paged":
        want["flash_decode_paged"] = L * (steps + rounds)
    else:
        want["fused_decode"] = steps + rounds + d.get("spec_proposed", 0)
    if llama_draft:
        want.update(_rms_launches(Ld, d["draft_steps"],
                                  d.get("draft_prefill", 0)))
    return want


def _spec_on(spec, dev):
    """A SpeculativeConfig with its draft weights on ``dev``."""
    if spec is None or spec is True or spec.draft_params is None:
        return spec
    return dataclasses.replace(spec, draft_params=_to_device(
        spec.draft_params, dev))


def speculative_reference_phase(gpt, llama, engines, Spec, fd, fdl, fnr):
    """Greedy speculative decoding on the card against the CPU.  Target:
    gpt_tiny f32 (hD 32); drafts: a smaller GPT (2 layers, H 64, hD
    16), a LLaMA with GQA (2 layers, H 64, 4/2 heads, hD 16: the
    rms_norm kernel's "llama" policy runs), the target itself and
    n-gram, k 3, on the contiguous engine and the paged one (18 pages
    of 8 rows: admissions defer, slots are evicted and their drafts
    prefilled again); the fused engine on the tiny bf16 int8-weight
    config of the JAX speculative tests (max_len 64) with a GPT draft
    and n-gram.  Each card speculative stream must equal the card's
    non-speculative stream and the CPU run of the same engine and
    draft; every launch count, set to 0 before each card run, must be
    exactly what its scheduler counters say (``_spec_want``)."""
    Engine, PagedEngine, FusedEngine = engines
    f32 = torch.float32
    cfg = gpt.gpt_tiny(dtype=f32, use_flash=False)
    target = gpt.init_params(cfg, seed=1, device="cpu")
    dcfg = gpt.gpt_tiny(hidden_size=64, num_layers=2, num_heads=4,
                        dtype=f32, use_flash=False)
    lcfg = llama.llama_tiny(hidden_size=64, num_layers=2, num_heads=4,
                            num_kv_heads=2, dtype=f32)
    drafts = {
        "gpt": Spec(k=SPEC_K, draft_params=gpt.init_params(
            dcfg, seed=2, device="cpu"), draft_cfg=dcfg),
        "llama": Spec(k=SPEC_K, family="llama", draft_params=
                      llama.init_params(lcfg, seed=3, device="cpu"),
                      draft_cfg=lcfg),
        "self": Spec(k=SPEC_K, draft_params=target, draft_cfg=cfg),
        "ngram": True}
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m) for n, m in SPEC_REQS]
    fcfg = gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                         num_heads=2, max_position_embeddings=64,
                         dtype=torch.bfloat16, use_flash=False)
    fq = gpt.quantize_decode_params(gpt.init_params(fcfg, seed=0,
                                                    device="cpu"), fcfg)
    fdcfg = gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                          num_heads=2, max_position_embeddings=64,
                          dtype=f32, use_flash=False)
    frng = np.random.default_rng(1)
    freqs = [(frng.integers(1, 128, (n,)), 8) for n in (5, 9, 12)]
    cases = [(kind, name) for kind in ("contiguous", "paged")
             for name in ("none", "gpt", "llama", "self", "ngram")]
    cases += [("fused", name) for name in ("none", "gpt", "ngram")]
    fdrafts = {"gpt": Spec(k=SPEC_K, draft_params=gpt.init_params(
        fdcfg, seed=2, device="cpu"), draft_cfg=fdcfg), "ngram": True}
    streams, rows = {}, []
    for kind, name in cases:
        fused = kind == "fused"
        spec = None if name == "none" else \
            (fdrafts if fused else drafts)[name]
        for dev in ("cpu", "cuda"):
            kw = dict(device=dev, attn_kernel="flash" if dev == "cuda"
                      else "xla", speculative=_spec_on(spec, dev))
            if fused:
                eng = FusedEngine(_to_device(fq, dev), fcfg, max_len=64, **kw)
            elif kind == "paged":
                eng = PagedEngine(_to_device(target, dev), cfg, max_batch=3,
                                  max_len=256, block_size=8, num_blocks=18,
                                  **kw)
            else:
                eng = Engine(_to_device(target, dev), cfg, max_batch=3,
                             max_len=256, **kw)
            base = eng.metrics()
            _spec_reset(fd, fdl, fnr)
            rs = freqs if fused else reqs
            rids = [eng.submit(p, max_new=m) for p, m in rs]
            out = eng.run(steps_per_sync=8)
            torch.cuda.synchronize()
            counts = _spec_counts(fd, fdl, fnr)
            streams[(kind, name, dev)] = [out[r] for r in rids]
            for rid, (_, m) in zip(rids, rs):
                if eng.request(rid).status != "DONE" or len(out[rid]) != m:
                    raise AssertionError(f"speculative reference {kind} "
                                         f"{name} {dev}: request {rid} "
                                         f"{eng.request(rid).status}")
            if dev == "cpu":
                continue
            d = _spec_deltas(eng.metrics(), base)
            Ld = 0 if not isinstance(spec, Spec) else \
                spec.draft_cfg.num_layers
            want = _spec_want(kind, d, fcfg.num_layers if fused
                              else cfg.num_layers, Ld, name == "llama")
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"speculative reference {kind} {name}: "
                                     f"launches {got}, want {want} ({d})")
            if name != "none" and d.get("verify", 0) < 1:
                raise AssertionError(f"speculative reference {kind} {name}: "
                                     f"no verify round ran")
            if kind == "paged" and eng.free_blocks != eng.num_blocks:
                raise AssertionError(f"speculative reference paged {name}: "
                                     f"pages left claimed")
            rows.append({**{k: v for k, v in d.items()
                            if k != "decode_seconds"},
                         "engine": kind, "draft": name, "launches": got})
    for kind, name in cases:
        card = streams[(kind, name, "cuda")]
        for other in ((kind, "none", "cuda"), (kind, name, "cpu")):
            if card != streams[other]:
                raise AssertionError(f"speculative reference {kind} {name}: "
                                     f"card stream {card} != {other} stream "
                                     f"{streams[other]}")
    row = {"phase": "speculative_reference",
           "config": "gpt_tiny f32 target; drafts gpt (2 x 64, hD 16), "
                     "llama GQA 4/2 (2 x 64, hD 16), self, ngram; fused: "
                     "128 x 32, 1 layer, bf16 int8 weights", "k": SPEC_K,
           "streams_identical": True, "runs": rows}
    _log(row)
    return row


def _slot_state(gpt, params, cfg, kd, layout, k, seed=2, B=8, bs=64):
    """The serving shape's state for the row check and the profiles: B
    slots of random prompts (lengths 32..700) prefilled with the flash
    kernels into a contiguous cache or, paged, shuffled pages that back
    each slot's window; the window's tokens [B, k+1] and positions."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(32, 701, B)]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, k + 1)),
                        dtype=torch.int32, device="cuda")
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ids = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    with torch.inference_mode():
        if layout == "contiguous":
            cache = gpt.init_decode_cache(cfg, B, 1024, kd, device="cuda")
            for b, n in enumerate(lens):
                gpt.prefill_into_slots(
                    params, torch.tensor(ids[b], device="cuda")[None], cfg,
                    cache, torch.tensor([b], device="cuda"),
                    attn_kernel="flash")
            return cache, None, toks, pos
        need = [(n + k) // bs + 1 for n in lens]
        perm = rng.permutation(sum(need)).astype(np.int32)
        table = np.full((B, 1024 // bs), -1, np.int32)
        for b, m in enumerate(need):
            table[b, :m] = perm[sum(need[:b]):sum(need[:b]) + m]
        bt = torch.from_numpy(table).cuda()
        pools = gpt.init_decode_cache(cfg, sum(need), bs, kd, device="cuda")
        for b, n in enumerate(lens):
            nblk = -(-n // bs)
            padded = np.zeros((1, nblk * bs), np.int64)
            padded[0, :n] = ids[b]
            gpt.prefill_paged_batched(params, torch.from_numpy(padded).cuda(),
                                      cfg, pools, bt[b:b + 1, :nblk],
                                      attn_kernel="flash")
        return pools, bt, toks, pos


def _verify_rows(gpt, params, cfg, state, layout, kd, k):
    """Each verify row's logits against a W = 1 decode step at the same
    position on a copy of the same cache (the GEMMs of the window see
    M = B (k+1) rows, the decode's M = B): the largest |delta|, the rows
    (of B (k+1)) not bitwise equal, and argmax disagreements; then the
    device and wall ms of one verify pass, one decode step and, for the
    bf16 cache the self-draft runs use, one self-draft round: k decode
    steps on the second copy, then the verify."""
    cache, bt, toks, pos = state
    c2 = {n: a.clone() for n, a in cache.items()}
    c3 = {n: a.clone() for n, a in cache.items()}
    W = k + 1

    def verify(c=cache):
        if layout == "paged":
            return gpt.verify_paged(params, c, bt, toks, pos, cfg,
                                    attn_kernel="flash")[0]
        return gpt.verify_into_slots(params, c, toks, pos, cfg,
                                     attn_kernel="flash")[0]

    def decode(c, tok, p):
        if layout == "paged":
            return gpt.decode_step_paged(params, c, bt, tok, p, cfg,
                                         attn_kernel="flash")[0]
        return gpt.decode_step_multi(params, c, tok, p, cfg,
                                     attn_kernel="flash")[0]

    with torch.inference_mode():
        lv = verify()
        ld = torch.stack([decode(c2, toks[:, j], pos + j) for j in range(W)],
                         dim=1)
        torch.cuda.synchronize()
        if not (torch.isfinite(lv).all() and torch.isfinite(ld).all()):
            raise AssertionError(f"verify rows {layout} {kd}: non-finite")
        diff = (lv - ld).abs()
        rows_differ = int((diff.amax(-1) > 0).sum())
        argmax_differ = int((lv.argmax(-1) != ld.argmax(-1)).sum())
        # the window's K/V rows as the verify and the decode steps wrote
        # them (fp8 compared as its bytes)
        cache_differ = sum(int((_bits(a) != _bits(c2[n])).sum())
                           for n, a in cache.items())
        # one self-draft round from this state: k greedy decode steps of
        # the target on a third copy, then the verify of [tok, drafts];
        # with verify rows equal to decode rows it accepts all k drafts
        d_tok, drafts = toks[:, 0], []
        for j in range(k):
            d_tok = decode(c3, d_tok, pos + j).argmax(-1).to(torch.int32)
            drafts.append(d_tok)
        drafts = torch.stack(drafts, dim=1)
        if layout == "paged":
            g = gpt.verify_paged(params, c3, bt, torch.cat(
                [toks[:, :1], drafts], 1), pos, cfg,
                attn_kernel="flash")[0].argmax(-1)
        else:
            g = gpt.verify_into_slots(params, c3, torch.cat(
                [toks[:, :1], drafts], 1), pos, cfg,
                attn_kernel="flash")[0].argmax(-1)
        self_accepted = int((drafts == g[:, :k]).sum())
        del c3

        def round_self():
            tok, p = toks[:, 0], pos
            for _ in range(k):
                tok = decode(c2, tok, p).argmax(-1).to(torch.int32)
                p = p + 1
            return verify()

        # n 3: each profiled call is a whole model step (~1000 kernels),
        # and the profiler's bookkeeping grows with the events
        fam = DECODE_FAMILIES
        prof = {"verify": _step_profile(verify, fam, n=3),
                "decode_step": _step_profile(
                    lambda: decode(c2, toks[:, 0], pos), fam, n=3)}
        if kd == "bf16":
            prof["self_draft_round"] = _step_profile(round_self, fam, n=3)
    return {"layout": layout, "kv_dtype": kd, "W": W,
            "rows": int(lv.shape[0] * W), "max_abs_logit_diff":
            diff.max().item(), "rows_not_bitwise_equal": rows_differ,
            "argmax_differ": argmax_differ,
            "cache_elements_differ": cache_differ,
            "self_draft_round_accepted": f"{self_accepted}/{k * lv.shape[0]}",
            "logit_std": ld.std().item(), "profiles": prof}


def _bits(a):
    return a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a


def _top2_margin(gpt, params, cfg, seq, kd):
    """The target's top-2 logit margin for the token after ``seq``, as
    the non-speculative engine computes it: ``seq[:-1]`` prefilled with
    the flash kernels, then one decode step feeding ``seq[-1]``."""
    cache = gpt.init_decode_cache(cfg, 1, 1024, kd, device="cuda")
    ids = torch.tensor(np.asarray(seq), device="cuda")[None]
    n = ids.shape[1]
    with torch.inference_mode():
        if n > 1:
            gpt.prefill_into_slots(params, ids[:, :-1], cfg, cache,
                                   torch.zeros(1, dtype=torch.long,
                                               device="cuda"),
                                   attn_kernel="flash")
        logits, _ = gpt.decode_step_multi(
            params, cache, ids[:, -1].to(torch.int32),
            torch.tensor([n - 1], dtype=torch.int32, device="cuda"), cfg,
            attn_kernel="flash")
        top = torch.topk(logits[0], 2).values
    return (top[0] - top[1]).item()


def speculative_serving_phase(gpt, engines, Spec, fd, fdl, fnr, cfg, params,
                              qparams, base_rows, base_streams):
    """Speculative decoding at gpt3_1p3b's full width (bf16, seed-0
    weights), k 3, on the serving phase's 12 requests (max_batch 8,
    max_len 1024, max_new 32): the contiguous engine (bf16) and the paged
    engine (bf16, 64 pages) each with n-gram and with the target as its
    own draft (the acceptance upper bound), the paged engine at int8 with
    n-gram; ``FusedB1Engine`` on int8 weights (3 requests x 32) with and
    without n-gram.  Launch counts, set to 0 before each run, exact
    (``_spec_want``); every request DONE with 32 tokens; decode-loop
    tok/s, acceptance, tokens per launch and rounds beside the
    non-speculative run of the same engine (from the serving phases).
    The row check (``_verify_rows``) on each layout and kv_dtype, with
    one verify pass, one decode step and one self-draft round profiled.
    Gates: every verify row and written cache element equal to the decode
    steps', bit for bit (row_gemm carries every product of the decode
    block), and a self-draft round from the row check's state accepting
    all k drafts of every slot; every contiguous and paged speculative
    stream equal to the plain run's (a difference is logged with the
    target's top-2 margin there, then fails the phase).  The engines'
    self-draft acceptance is reported, not gated: as in the JAX engine,
    a round's k draft steps write the draft cache's rows pos .. pos+k-1
    only, so after a fully accepted round the next round's draft attends
    a row (pos+k) its cache never received, and may propose another
    token; the fused engine's speculative streams equal its
    non-speculative ones (by construction: the verify is the fused
    decode step), and so do its verify rows, bit for bit."""
    Engine, PagedEngine, FusedEngine = engines
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    self_spec = Spec(k=SPEC_K, draft_params=params, draft_cfg=cfg)
    checks = {(lay, kd): _verify_rows(gpt, params, cfg,
                                      _slot_state(gpt, params, cfg, kd, lay,
                                                  SPEC_K), lay, kd, SPEC_K)
              for lay, kd in (("contiguous", "bf16"), ("paged", "bf16"),
                              ("paged", "int8"))}
    for c in checks.values():
        _log({"phase": "speculative_verify_rows", **c})
        # every product of the decode block is row_gemm's: a verify row
        # is the decode step's row, bit for bit
        acc, total = map(int, c["self_draft_round_accepted"].split("/"))
        if c["rows_not_bitwise_equal"] or c["cache_elements_differ"] \
                or acc != total:
            raise AssertionError(
                f"speculative verify rows {c['layout']} {c['kv_dtype']}: "
                f"{c['rows_not_bitwise_equal']} of {c['rows']} rows and "
                f"{c['cache_elements_differ']} cache elements differ from "
                f"the decode steps'; a self-draft round accepted "
                f"{c['self_draft_round_accepted']}")
    torch.cuda.empty_cache()
    runs = [("contiguous", "bf16", "ngram"), ("contiguous", "bf16", "self"),
            ("paged", "bf16", "ngram"), ("paged", "bf16", "self"),
            ("paged", "int8", "ngram")]
    results = {}
    for kind, kd, draft in runs:
        spec = True if draft == "ngram" else self_spec
        kw = dict(max_batch=8, max_len=1024, attn_kernel="flash",
                  kv_dtype=kd, device="cuda", speculative=spec)
        eng = (PagedEngine(params, cfg, block_size=64, **kw)
               if kind == "paged" else Engine(params, cfg, **kw))
        eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)   # warm-up
        eng.run()
        base = eng.metrics()
        _spec_reset(fd, fdl, fnr)
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=32) for p in prompts]
        out = eng.run(steps_per_sync=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _spec_counts(fd, fdl, fnr)
        d = _spec_deltas(eng.metrics(), base)
        Ld = L if draft == "self" else 0
        want = _spec_want(kind, d, L, Ld)
        got = {k: counts[k] for k in want}
        split = L * (d["decode_steps"] + d["verify"]) + Ld * d["draft_steps"]
        if got != want or counts["split"] != split or d["verify"] < 1:
            raise AssertionError(f"speculative {kind} {kd} {draft}: launches "
                                 f"{counts}, want {want}, split {split} "
                                 f"({d})")
        for rid in rids:
            if eng.request(rid).status != "DONE" or len(out[rid]) != 32:
                raise AssertionError(f"speculative {kind} {kd} {draft}: "
                                     f"request {rid} "
                                     f"{eng.request(rid).status}")
        if kind == "paged" and eng.free_blocks != eng.num_blocks:
            raise AssertionError(f"speculative paged {kd} {draft}: pages "
                                 f"left claimed")
        streams = [out[r] for r in rids]
        plain = base_streams[(kind, kd)]
        delta = checks[(kind, kd)]["max_abs_logit_diff"]
        diverged = []
        for i, (a, b) in enumerate(zip(streams, plain)):
            if a == b:
                continue
            j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = _top2_margin(gpt, params, cfg, np.concatenate(
                [prompts[i], np.asarray(b[:j], np.int64)]), kd)
            diverged.append({"request": i, "token": j, "speculative": a[j],
                             "plain": b[j], "top2_margin": margin,
                             "row_check_max_abs_diff": delta})
        prow = base_rows[(kind, kd)]
        row = {"phase": "speculative_serving", "engine": kind, "kv_dtype": kd,
               "draft": draft, "k": SPEC_K, "launches": got,
               "verify_rounds": d["verify"], "decode_steps": d["decode_steps"],
               "draft_steps": d["draft_steps"],
               "accept_ratio": d["spec_accepted"] / d["spec_proposed"],
               "tokens_per_launch": d["spec_emitted"] / d["spec_slot_launches"],
               "rollbacks": d["spec_rollbacks"],
               "tokens": 32 * len(rids), "wall_s": wall,
               "decode_loop_s": d["decode_seconds"],
               "decode_loop_tok_s": 32 * len(rids) / d["decode_seconds"],
               "plain_decode_loop_tok_s": prow["decode_loop_tok_s"],
               "streams_equal_to_plain": f"{len(rids) - len(diverged)}"
                                         f"/{len(rids)}",
               "tokens_equal_to_plain": f"""{sum(x == y for a, b in zip(
                   streams, plain) for x, y in zip(a, b))}/{32 * len(rids)}""",
               "divergences": diverged}
        _log(row)
        if diverged:
            raise AssertionError(
                f"speculative {kind} {kd} {draft}: {len(diverged)} of "
                f"{len(rids)} streams leave the plain stream: {diverged}")
        results[(kind, kd, draft)] = row
        del eng
        torch.cuda.empty_cache()
    results["fused"] = _speculative_fused(gpt, FusedEngine, fd, fdl, fnr,
                                          cfg, qparams, prompts[:3], lens[:3])
    results["verify_rows"] = checks
    return results


def _speculative_fused(gpt, FusedEngine, fd, fdl, fnr, cfg, qparams, prompts,
                       lens):
    """The fused engine's part of ``speculative_serving_phase``: its
    plain and n-gram runs (gate: equal streams), and at the first
    prompt's state one ``verify_fused`` window against k+1
    ``decode_step_fused`` calls on a copy (gate: bit for bit), both
    profiled."""
    L = cfg.num_layers
    streams, rows = {}, {}
    for draft in ("none", "ngram"):
        eng = FusedEngine(qparams, cfg, max_len=1024, kv_dtype="bf16",
                          attn_kernel="flash", device="cuda",
                          speculative=None if draft == "none" else True)
        eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)   # warm-up
        eng.run()
        base = eng.metrics()
        _spec_reset(fd, fdl, fnr)
        rids = [eng.submit(p, max_new=32) for p in prompts]
        out = eng.run(steps_per_sync=16)
        torch.cuda.synchronize()
        counts = _spec_counts(fd, fdl, fnr)
        d = _spec_deltas(eng.metrics(), base)
        want = _spec_want("fused", d, L, 0)
        got = {k: counts[k] for k in want}
        if got != want or (draft == "ngram" and d["verify"] < 1):
            raise AssertionError(f"speculative fused {draft}: launches "
                                 f"{got}, want {want} ({d})")
        streams[draft] = [out[r] for r in rids]
        rows[draft] = {
            "launches": got, "decode_steps": d["decode_steps"],
            "verify_rounds": d.get("verify", 0),
            "decode_loop_s": d["decode_seconds"],
            "decode_loop_tok_s": 32 * len(rids) / d["decode_seconds"]}
        if draft == "ngram":
            rows[draft].update(
                accept_ratio=d["spec_accepted"] / d["spec_proposed"],
                tokens_per_launch=d["spec_emitted"] / d["spec_slot_launches"],
                rollbacks=d["spec_rollbacks"],
                verify_launches=d["verify"] + d["spec_proposed"])
        del eng
        torch.cuda.empty_cache()
    if streams["ngram"] != streams["none"]:
        raise AssertionError(f"speculative fused: streams {streams['ngram']} "
                             f"!= non-speculative {streams['none']}")
    n0, W = int(lens[0]), SPEC_K + 1
    cache = gpt.init_decode_cache(cfg, 1, 1024, "bf16", device="cuda")
    with torch.inference_mode():
        gpt.prefill_into_slots(qparams, torch.tensor(prompts[0], device="cuda")
                               [None], cfg, cache,
                               torch.zeros(1, dtype=torch.long, device="cuda"),
                               attn_kernel="flash")
        flat = gpt.flatten_decode_cache(cache, cfg)
        copy = {n: a.clone() for n, a in flat.items()}
        toks = torch.tensor(np.asarray(prompts[1][:W])[None],
                            dtype=torch.int32, device="cuda")
        pos = torch.tensor([n0], dtype=torch.int32, device="cuda")
        lv, _ = gpt.verify_fused(qparams, flat, toks, pos, cfg)
        ld = torch.stack([gpt.decode_step_fused(qparams, copy, toks[:, j],
                                                pos + j, cfg)[0]
                          for j in range(W)], dim=1)
        torch.cuda.synchronize()
        if not torch.equal(lv, ld) or any(
                not torch.equal(_bits(a), _bits(copy[n]))
                for n, a in flat.items()):
            raise AssertionError("verify_fused rows are not the fused decode "
                                 "steps bit for bit")
        prof = {"verify": _step_profile(
                    lambda: gpt.verify_fused(qparams, flat, toks, pos, cfg),
                    FUSED_FAMILIES, n=3),
                "decode_step": _step_profile(
                    lambda: gpt.decode_step_fused(qparams, copy, toks[:, 0],
                                                  pos, cfg), FUSED_FAMILIES,
                    n=3)}
    row = {"phase": "speculative_serving", "engine": "fused", "kv_dtype":
           "bf16", "draft": "ngram", "k": SPEC_K,
           "prompt_lens": [int(n) for n in lens], "runs": rows,
           "streams_equal": True, "verify_rows_bitwise_equal": True,
           "pos": n0, "profiles": prof}
    _log(row)
    del cache, flat, copy
    torch.cuda.empty_cache()
    return row


def _shared_prefix_load(rng, vocab, n, prefix_len, tails):
    """n prompts of one seeded prefix plus a seeded tail of a length in
    ``tails`` (inclusive range) each."""
    prefix = rng.integers(0, vocab, prefix_len)
    return [np.concatenate([prefix, rng.integers(0, vocab, int(t))])
            for t in rng.integers(tails[0], tails[1] + 1, n)]


def _prefix_engine(engines, kind, params, cfg, dev, budget, kd="bf16",
                   **kw):
    Engine, PagedEngine, FusedEngine = engines
    common = dict(kv_dtype=kd, device=dev, prefix_cache_bytes=budget,
                  attn_kernel="xla" if dev == "cpu" else "flash")
    if kind == "fused":
        return FusedEngine(params, cfg, max_len=kw.pop("max_len"), **common)
    if kind == "paged":
        return PagedEngine(params, cfg, **kw, **common)
    return Engine(params, cfg, **kw, **common)


def prefix_reference_phase(gpt, engines, rg):
    """The prefix cache on the card against the CPU (gpt_tiny float32;
    int8 weights for the fused engine): a primer request, then a shared
    prefix load with hits, partial hits and a full hit, on the
    contiguous, paged (8-row pages) and fused engines, each warm card
    run equal to the cold card run and to the CPU run; the warm runs
    must hit and must launch row_gemm for their suffix passes."""
    cfg = gpt.gpt_tiny(dtype=torch.float32, use_flash=False)
    cpu = gpt.init_params(cfg, seed=4, device="cpu")
    trees = {"cpu": cpu, "cuda": _to_device(cpu, "cuda")}
    qtrees = {dev: gpt.quantize_decode_params(t, cfg)
              for dev, t in trees.items()}
    rng = np.random.default_rng(4)
    load = _shared_prefix_load(rng, cfg.vocab_size, 5, 40, (0, 21))
    out = {}
    for kind in ("contiguous", "paged", "fused"):
        kw = dict(max_len=128)
        if kind != "fused":
            kw["max_batch"] = 3
        if kind == "paged":
            kw.update(block_size=8, num_blocks=60)
        prompts = load[:3] if kind == "fused" else load
        streams, hits = {}, {}
        for dev, budget in (("cpu", 1 << 30), ("cuda", 0), ("cuda", 1 << 30)):
            params = (qtrees if kind == "fused" else trees)[dev]
            eng = _prefix_engine(engines, kind, params, cfg, dev, budget,
                                 **dict(kw))
            eng.submit(load[0][:45], max_new=6)            # the primer
            eng.run()
            before = rg.LAUNCHES
            rids = [eng.submit(p, max_new=10) for p in prompts]
            res = eng.run(steps_per_sync=4)
            streams[(dev, budget)] = [res[r] for r in rids]
            hits[(dev, budget)] = [eng.request(r).prefix_hit for r in rids]
            if dev == "cuda" and rg.LAUNCHES == before:
                raise AssertionError(f"prefix reference {kind}: no row_gemm "
                                     f"launch on the card")
        want = streams[("cpu", 1 << 30)]
        if streams[("cuda", 0)] != want or streams[("cuda", 1 << 30)] != want:
            raise AssertionError(f"prefix reference {kind}: card streams "
                                 f"{streams} differ from the CPU's")
        h = hits[("cuda", 1 << 30)]
        if h != hits[("cpu", 1 << 30)] or sum(x > 0 for x in h) < 2:
            raise AssertionError(f"prefix reference {kind}: hits {hits}")
        out[kind] = {"hits": h, "streams_identical": True}
    _log({"phase": "prefix_reference", "config": "gpt_tiny f32 (fused: int8 "
          "weights)", **out})
    return out


PREFIX_LEN, PREFIX_TAILS, PREFIX_REQUESTS = 512, (16, 128), 12


def _prefix_run(eng, prompts, primer, fd, rg, fdl):
    """The primer alone, then the load: (streams, per-request TTFT and
    hits, launch counts of the load's run)."""
    eng.submit(primer, max_new=4)
    eng.run()
    base = eng.metrics()
    fd.reset_launches()
    rg.reset_launches()
    fdl.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=32) for p in prompts]
    out = eng.run(steps_per_sync=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in rids:
        if eng.request(rid).status != "DONE" or len(out[rid]) != 32:
            raise AssertionError(f"prefix serving: request {rid} "
                                 f"{eng.request(rid).status}")
    m = eng.metrics()
    d = _spec_deltas(m, base)
    reqs = [eng.request(r) for r in rids]
    return {"streams": [out[r] for r in rids],
            "ttft_s": [r.first_token_at - r.submitted_at for r in reqs],
            "hits": [r.prefix_hit for r in reqs],
            "host_hits": [r.prefix_host_hit for r in reqs],
            # TTFT split at admission: queue and install, then the
            # rounds up to the first token
            "admit_s": [r.admitted_at - r.submitted_at for r in reqs],
            "first_after_admit_s": [r.first_token_at - r.admitted_at
                                    for r in reqs],
            "suffix_tokens": [len(p) - 1 - r.prefix_hit if r.prefix_hit
                              else 0 for p, r in zip(prompts, reqs)],
            "deltas": d, "wall_s": wall,
            "counts": {"flash_decode": fd.LAUNCHES,
                       "flash_decode_paged": fd.PAGED_LAUNCHES,
                       "instances": dict(fd.INSTANCE_LAUNCHES),
                       "row_gemm": rg.LAUNCHES, "fused_decode": fdl.LAUNCHES},
            "metrics": m}


def _prefix_logits(gpt, params, cfg, cache, token, pos, fused):
    """One decode step's logits feeding ``token`` at ``pos``: the per-op
    step, or the fused one over the cache's flat view."""
    tok = torch.tensor([int(token)], dtype=torch.int32, device="cuda")
    at = torch.tensor([pos], dtype=torch.int32, device="cuda")
    if fused:
        return gpt.decode_step_fused(params, gpt.flatten_decode_cache(
            cache, cfg), tok, at, cfg)[0]
    return gpt.decode_step_multi(params, cache, tok, at, cfg,
                                 attn_kernel="flash")[0]


def _prefix_kv_delta(gpt, params, cfg, kd, primer, prompt, fused,
                     prefix_len=PREFIX_LEN):
    """How far the warm path's K/V and logits lie from the cold path's
    for one prompt: the cold cache from one prefill of the prompt, the
    warm one from the primer's prefill rows [0, P) (P the shared prefix)
    and the suffix filled as an engine's hit fills it (one windowed pass;
    fused: one fused step a token); then one decode step feeding the
    last token on each.  Returns (max |K/V delta| over the rows and
    layers, max |logit delta|)."""
    S, P = len(prompt), prefix_len
    slot0 = torch.zeros(1, dtype=torch.long, device="cuda")
    caches = []
    with torch.inference_mode():
        for ids in (prompt[:-1], primer[:P]):
            c = gpt.init_decode_cache(cfg, 1, 1024, kd, device="cuda")
            gpt.prefill_into_slots(params, torch.tensor(ids, device="cuda")
                                   [None], cfg, c, slot0, attn_kernel="flash")
            caches.append(c)
        cold, warm = caches
        toks = torch.tensor(np.asarray(prompt[P:S - 1]), dtype=torch.int32,
                            device="cuda")
        if fused:
            flat = gpt.flatten_decode_cache(warm, cfg)
            for j in range(toks.shape[0]):
                gpt.decode_step_fused(
                    params, flat, toks[j:j + 1],
                    torch.tensor([P + j], dtype=torch.int32, device="cuda"),
                    cfg, logits=False)
        else:
            gpt.verify_into_slots(params, warm, toks[None],
                                  torch.tensor([P], dtype=torch.int32,
                                               device="cuda"), cfg,
                                  attn_kernel="flash", logits=False)
        kv = max((_dequant(cold, n)[:, :, :S - 1]
                  - _dequant(warm, n)[:, :, :S - 1]).abs().max().item()
                 for n in ("k", "v"))
        lc = _prefix_logits(gpt, params, cfg, cold, prompt[-1], S - 1, fused)
        lw = _prefix_logits(gpt, params, cfg, warm, prompt[-1], S - 1, fused)
    return kv, (lc - lw).abs().max().item()


def _prefix_margin(gpt, params, cfg, kd, seq, fused):
    """The cold path's top-2 logit margin for the token after ``seq``:
    ``seq[:-1]`` prefilled, then one decode step (fused: the fused
    step) feeding ``seq[-1]``."""
    cache = gpt.init_decode_cache(cfg, 1, 1024, kd, device="cuda")
    with torch.inference_mode():
        gpt.prefill_into_slots(params, torch.tensor(np.asarray(seq[:-1]),
                                                    device="cuda")[None],
                               cfg, cache, torch.zeros(1, dtype=torch.long,
                                                       device="cuda"),
                               attn_kernel="flash")
        top = torch.topk(_prefix_logits(gpt, params, cfg, cache, seq[-1],
                                        len(seq) - 1, fused)[0], 2).values
    return (top[0] - top[1]).item()


def _near_ties(gpt, params, cfg, kd, prompts, got, want, bound, fused,
               label, primer=None, prefix_len=PREFIX_LEN):
    """The streams ``got`` against ``want`` (the cold path's) under the
    near-tie rule: each request that leaves ``want`` must do so where
    the cold path's top-2 margin is within ``bound`` (the first decode
    step's logit |delta| between a warm and a cold cache,
    ``_prefix_kv_delta``).  With ``primer``, a margin past ``bound`` is
    held to the warm/cold logit |delta| at that request's own position
    (``_prefix_kv_delta`` over its prompt and the tokens before the
    divergence), logged as ``local_delta``.  Returns the divergences;
    raises on one past its bound."""
    diverged = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[i], np.asarray(b[:j], np.int64)])
        margin = _prefix_margin(gpt, params, cfg, kd, seq, fused)
        row = {"request": i, "token": j, "got": a[j], "want": b[j],
               "top2_margin": margin}
        limit = bound
        if margin > bound and primer is not None:
            row["local_delta"] = _prefix_kv_delta(
                gpt, params, cfg, kd, primer, seq, fused, prefix_len)[1]
            limit = max(bound, row["local_delta"])
        diverged.append(row)
        if margin > limit:
            raise AssertionError(
                f"{label}: request {i} leaves the cold stream at token {j} "
                f"(top-2 margin {margin}, the warm/cold logit |delta| "
                f"{limit})")
    return diverged


def _dequant(cache, name):
    a = cache[name].float()
    return a * cache[name + "s"] if name + "s" in cache else a


def prefix_serving_phase(gpt, engines, fd, rg, fdl, cfg, params, qparams):
    """The device prefix cache at gpt3_1p3b's full width (bf16, seed-0
    weights): 12 requests sharing a 512-token seeded prefix with tails
    of 16-128 tokens, 32 new tokens each, after one primer request (the
    prefix and a tail), through the contiguous engine (bf16) and the
    paged engine (64-token pages, 64 pages, the cache's budget 24 pages)
    at bf16 and int8, each cold (no prefix cache) and warm; the fused
    engine (int8 weights) on the first 3 requests.  TTFT with one decode
    step a sync, hit tokens, pages shared, and the suffix passes'
    launches: warm runs must hit every request, launch flash_decode L
    times a decode step, prefill and suffix pass (paged: the paged
    layout for both), row_gemm 4 L + 1 a decode step and 4 L a suffix
    pass (fused: the fused kernel once a decode step and once a suffix
    token).  Streams: warm equal to cold, or each difference at a
    near-tie — the cold path's top-2 margin there within the first
    decode step's logit |delta| between a warm and a cold cache of one
    prompt (``_prefix_kv_delta``; cold is one full prefill on cuBLAS, so
    bitwise equality is not promised)."""
    L = cfg.num_layers
    rng = np.random.default_rng(7)
    load = _shared_prefix_load(rng, cfg.vocab_size, PREFIX_REQUESTS + 1,
                               PREFIX_LEN, PREFIX_TAILS)
    primer, prompts = load[0], load[1:]
    results = {}
    for kind, kd in (("contiguous", "bf16"), ("paged", "bf16"),
                     ("paged", "int8"), ("fused", "bf16")):
        use = prompts[:3] if kind == "fused" else prompts
        tree = qparams if kind == "fused" else params
        kw = dict(max_len=1024)
        if kind != "fused":
            kw["max_batch"] = 8
        budget = None                       # unbounded
        if kind == "paged":
            kw.update(block_size=64, num_blocks=64)
            page = gpt.init_decode_cache(cfg, 1, 64, kd, device="cuda")
            budget = 24 * sum(a.numel() * a.element_size()
                              for a in page.values())
            del page
        runs = {}
        for label in ("cold", "warm"):
            b = budget if label == "warm" else 0
            eng = _prefix_engine(engines, kind, tree, cfg, "cuda", b, kd,
                                 **dict(kw))
            runs[label] = _prefix_run(eng, use, primer, fd, rg, fdl)
            if kind == "paged" and eng.free_blocks + int(
                    (np.asarray(eng._page_rc) > 0).sum()) != eng.num_blocks:
                raise AssertionError(f"prefix serving {kind} {kd}: free + "
                                     f"referenced != total pages")
            del eng
            torch.cuda.empty_cache()
        w = runs["warm"]
        d, c = w["deltas"], w["counts"]
        steps, prefills = d["decode_steps"], d.get("prefill", 0) + d.get(
            "prefill_fused", 0)
        passes = sum(1 for s in w["suffix_tokens"] if s)
        if min(w["hits"]) < PREFIX_LEN:
            raise AssertionError(f"prefix serving {kind} {kd}: hits "
                                 f"{w['hits']}")
        if kind == "fused":
            want = {"fused_decode": steps + sum(w["suffix_tokens"])}
        else:
            layout = "flash_decode_paged" if kind == "paged" \
                else "flash_decode"
            want = {layout: L * (steps + passes),
                    "row_gemm": (4 * L + 1) * steps + 4 * L * passes}
            if kind == "paged":
                want["flash_decode"] = L * prefills
            else:
                want["flash_decode"] += L * prefills
        got = {k: c[k] for k in want}
        if got != want:
            raise AssertionError(f"prefix serving {kind} {kd}: launches "
                                 f"{got}, want {want} ({d})")
        fused = kind == "fused"
        kv_delta, logit_delta = _prefix_kv_delta(gpt, tree, cfg, kd, primer,
                                                 use[0], fused)
        diverged = _near_ties(gpt, tree, cfg, kd, use, w["streams"],
                              runs["cold"]["streams"], logit_delta, fused,
                              f"prefix serving {kind} {kd}")
        row = {"phase": "prefix_serving", "engine": kind, "kv_dtype": kd,
               "requests": len(use), "prefix_len": PREFIX_LEN,
               "prompt_lens": [len(p) for p in use], "max_new": 32,
               "budget_bytes": budget, "hits": w["hits"],
               "hit_tokens": sum(w["hits"]),
               "pages_shared": (sum(w["hits"]) // 64 if kind == "paged"
                                else None),
               "suffix_passes": passes,
               "suffix_tokens": sum(w["suffix_tokens"]),
               "launches": got, "instances": c["instances"],
               "prefix_cache": w["metrics"].get("prefix_cache"),
               "deferred_admissions": {
                   lab: r["metrics"]["deferred_admissions"]
                   for lab, r in runs.items()},
               "ttft_cold_mean_s": float(np.mean(runs["cold"]["ttft_s"])),
               "ttft_warm_mean_s": float(np.mean(w["ttft_s"])),
               "ttft_cold_median_s": float(np.median(runs["cold"]["ttft_s"])),
               "ttft_warm_median_s": float(np.median(w["ttft_s"])),
               "wall_cold_s": runs["cold"]["wall_s"],
               "wall_warm_s": w["wall_s"],
               "kv_delta_warm_cold": kv_delta,
               "logit_delta_warm_cold": logit_delta,
               "streams_equal": f"{len(use) - len(diverged)}/{len(use)}",
               "divergences": diverged}
        _log(row)
        results[(kind, kd)] = row
    return results


RMS_CASES = ((8, 4096), (2048, 4096), (8, 128), (7, 11008))
RMS_TRAIN_ROWS = (8192, 4096)   # llama_7b training: B 4 x S 2048 rows
RMS_F32_REL, RMS_F32_ABS = 1e-6, 1e-7   # float32 out, per element
RMS_BF16_STEP_SHARE = 1e-3   # bf16: elements one step apart, at most
RMS_RSTD_REL = 1e-6          # "fused" rstd, relative
LLAMA_ROUTE_FACTOR = 1.5     # first-step logits vs float32, of plain's
# negative controls the route bound must fail (the RMS-policy control is
# a rounding-level fault, below bf16 noise: reported only)
LLAMA_MUST_FAIL = ("kv_heads_rolled", "attention_zeroed",
                   "newest_row_dropped")
LLAMA_FAMILIES = (("rms_norm", ("rms_norm",)),
                  ("flash_decode", ("flash_decode",)))


def _bf16_step(t):
    """The bfloat16 step (unit in the last place) at each |t| (float32;
    the smallest normal's step below it)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _bf16_steps(got, want):
    """Per element, how many bfloat16 steps apart got and want are (the
    distance of their bit patterns on the ordered line of values)."""
    def ordered(t):
        b = t.view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return (ordered(got) - ordered(want)).abs()


def _rms_errors(got, want, rstd=None, want_rstd=None):
    """The RMS kernel against its plain version, per element: float32
    within RMS_F32_REL |want| + RMS_F32_ABS; bfloat16 equal, or one step
    apart on at most RMS_BF16_STEP_SHARE of the elements (the float32
    sum runs in another order, so rstd may cross a rounding boundary);
    "fused" rstd within RMS_RSTD_REL.  Raises past a limit; returns
    (max |got - want|, share of elements that differ)."""
    diff = (got.float() - want.float()).abs()
    err, share = diff.max().item(), (diff > 0).float().mean().item()
    if got.dtype == torch.bfloat16:
        steps = _bf16_steps(got, want)
        ok = steps.max().item() <= 1 and share <= RMS_BF16_STEP_SHARE
    else:
        ok = bool((diff <= RMS_F32_REL * want.float().abs()
                   + RMS_F32_ABS).all())
    if rstd is not None:
        rel = ((rstd - want_rstd).abs() / want_rstd).max().item()
        ok = ok and rel <= RMS_RSTD_REL
    if not ok:
        raise AssertionError(f"rms_norm {got.dtype} {tuple(got.shape)}: max "
                             f"abs err {err}, {share} of elements differ")
    return err, share


def _rms_work(kind, N, H, e, policy, residual=False):
    """(bytes, operations) the function must move and do: the forward
    reads x and w and writes out (the fused instance: h and delta read,
    s and out written); the backward reads x, g (and g_s) and w and
    writes dx and dw; "fused" adds rstd [N] float32 (written by the
    forward, read by the backward).  Operations: a multiply-add and two
    products an element forward (an add more fused), about ten an
    element backward."""
    rstd = 4 * N if policy == "fused" else 0
    if kind == "fwd":
        return 2 * N * H * e + H * e + rstd, 4 * N * H
    if kind == "add":
        return 4 * N * H * e + H * e + rstd, 5 * N * H
    return ((4 if residual else 3) * N * H * e + 2 * H * e + rstd,
            10 * N * H)


def rms_kernel_phase(fnr):
    """The RMS kernels against their plain versions on the card, both
    policies, float32 and bfloat16, at the LLaMA path's rows (8 decode
    rows and 4 x 512 prefill rows of llama_7b, 8 rows of llama_tiny, an
    odd case of 7 rows of 11008, and llama_7b training's 4 x 2048 rows):
    the forward (``_rms_errors``), the fused residual-add instance
    (``add_rms_check``: bit for bit the add and the forward kernel, and
    its backward with g_s bit for bit), and the backward against its
    plain version on the card (``_rms_bwd_errors``).  Times of each
    kernel, its plain version and the library yardstick — ``F.rms_norm``
    (never called by the port) for the forward; ``h + delta`` then
    ``F.rms_norm`` (two calls) for the fused instance; ``F.rms_norm``'s
    autograd backward (the graph kept, one backward timed) for the
    backward — beside the byte bound and the kernel's share of it.  One
    more call reads x through a row stride (every other row)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    eps = 1e-6
    results = {}

    def timed(fn):
        return _time_ms(fn, flush=flush)

    for N, H in RMS_CASES + (RMS_TRAIN_ROWS,):
        for dt in (torch.bfloat16, torch.float32):
            x, h, delta, g, g_s = (torch.randn(
                (N, H), generator=gen, device="cuda").to(dt)
                for _ in range(5))
            w = (1 + 0.1 * torch.randn((H,), generator=gen,
                                       device="cuda")).to(dt)
            e = x.element_size()
            shape = f"N={N} H={H} {str(dt).split('.')[-1]}"
            for policy in fnr.POLICIES:
                key = (policy, N, H, str(dt).split(".")[-1])
                # the forward
                got, rstd = fnr.rms_norm(x, w, eps, policy)
                torch.cuda.synchronize()
                want, want_rstd = fnr.rms_norm_plain(x, w, eps, policy)
                err, share = _rms_errors(got, want, rstd, want_rstd)
                lib = F.rms_norm(x, (H,), w, eps)
                row = {"phase": "kernel_rms", "kind": "fwd",
                       "policy": policy, "shape": shape,
                       "ms": timed(lambda: fnr.rms_norm(x, w, eps, policy)),
                       "plain_ms": timed(
                           lambda: fnr.rms_norm_plain(x, w, eps, policy)),
                       "library_ms": timed(
                           lambda: F.rms_norm(x, (H,), w, eps)),
                       **_bound(*_rms_work("fwd", N, H, e, policy),
                                "float32"),
                       "max_abs_err": err, "share_differing": share,
                       "library_max_abs_err": (lib.float() - want.float())
                       .abs().max().item()}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                _log(row)
                results[("fwd",) + key] = row
                # the fused residual-add instance
                add_rms_check(fnr, h, delta, w, g, g_s, policy, eps)
                s_plain, out_plain = fnr.add_rms_norm_plain(h, delta, w, eps,
                                                            policy)
                s_k, out_k = fnr.add_rms_norm(h, delta, w, eps, policy)
                err, share = _rms_errors(out_k, out_plain)

                def add_library():
                    F.rms_norm(h + delta, (H,), w, eps)

                row = {"phase": "kernel_rms", "kind": "add",
                       "policy": policy, "shape": shape,
                       "ms": timed(lambda: fnr.add_rms_norm(h, delta, w, eps,
                                                            policy)),
                       "plain_ms": timed(lambda: fnr.add_rms_norm_plain(
                           h, delta, w, eps, policy)),
                       "library_ms": timed(add_library),
                       "library_calls": "h + delta, then F.rms_norm (two)",
                       **_bound(*_rms_work("add", N, H, e, policy),
                                "float32"),
                       "s_bit_equal_add": bool(torch.equal(s_k, s_plain)),
                       "max_abs_err": err, "share_differing": share,
                       "bit_equal_rms_norm_of_s": True}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                _log(row)
                results[("add",) + key] = row
                # the backward, with and without the residual's cotangent
                dx, dw = fnr.rms_norm_bwd(x, w, g, eps, policy, rstd)
                torch.cuda.synchronize()
                pdx, pdw = fnr.rms_norm_bwd_plain(x, w, g, eps, policy,
                                                  want_rstd)
                dx_err, dx_share, dw_err, dw_share = _rms_bwd_errors(
                    (dx, dw), (pdx, pdw),
                    _rms_bwd_floor(x, w, g, policy, eps),
                    f"rms_norm {policy} backward kernel vs plain")
                xx = x.detach().requires_grad_(True)
                ww = w.detach().requires_grad_(True)
                lib_out = F.rms_norm(xx, (H,), ww, eps)
                row = {"phase": "kernel_rms", "kind": "bwd",
                       "policy": policy, "shape": shape,
                       "ms": timed(lambda: fnr.rms_norm_bwd(
                           x, w, g, eps, policy, rstd)),
                       "ms_with_g_s": timed(lambda: fnr.rms_norm_bwd(
                           x, w, g, eps, policy, rstd, g_s)),
                       "plain_ms": timed(lambda: fnr.rms_norm_bwd_plain(
                           x, w, g, eps, policy, want_rstd)),
                       "library_ms": timed(lambda: torch.autograd.grad(
                           lib_out, (xx, ww), g, retain_graph=True)),
                       "library_calls": "F.rms_norm's autograd backward",
                       **_bound(*_rms_work("bwd", N, H, e, policy),
                                "float32"),
                       "bound_with_g_s_ms": _bound(*_rms_work(
                           "bwd", N, H, e, policy, True),
                           "float32")["bound_ms"],
                       "max_abs_err": max(dx_err, dw_err),
                       "dx_max_abs_err": dx_err, "dx_share_differing":
                           dx_share, "dw_max_abs_err": dw_err,
                       "dw_share_differing": dw_share}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["bound_share_with_g_s"] = (row["bound_with_g_s_ms"]
                                               / row["ms_with_g_s"])
                _log(row)
                results[("bwd",) + key] = row
                del lib_out, xx, ww
            del x, h, delta, g, g_s
    # a row stride: every other row of a [16, 4096] tensor
    base = torch.randn((16, 4096), generator=gen,
                       device="cuda").to(torch.bfloat16)
    w = torch.ones(4096, dtype=torch.bfloat16, device="cuda")
    for policy in fnr.POLICIES:
        got, rstd = fnr.rms_norm(base[::2], w, eps, policy)
        want, want_rstd = fnr.rms_norm_plain(base[::2], w, eps, policy)
        _rms_errors(got, want, rstd, want_rstd)
    _log({"phase": "kernel_rms_strided", "shape": "every other row of "
          "[16, 4096] bfloat16", "policies": list(fnr.POLICIES),
          "within_limits": True})
    del flush
    torch.cuda.empty_cache()
    return results


def _llama_prompt_lens(rng):
    """The slot loop's 8 prompt lengths in 32..700 (the first draw of
    ``rng``, as the GPT serving workload draws its lengths)."""
    return [int(n) for n in rng.integers(32, 701, 8)]


def llama_kernel_phase(fa, fd):
    """The two attention kernels of the LLaMA path at the shapes llama_7b
    gives them (32 heads of 128, bf16, q, k and v each a contiguous
    tensor as the rope and the v projection leave them), held per element
    to their plain versions at the limits of the GPT shapes:
    ``flash_attention_fwd`` at generate's prefill (B 4, S 512, causal);
    ``flash_decode`` at the slot loop's decode step (B 8, T 1024, ragged
    positions) and at its ``prefill_into_slots`` of the longest prompt
    (B 1, W = T = its length less one, pos 0: the window attends its own
    fresh K/V).  Times beside the plain versions, SDPA and the bound."""
    W = max(_llama_prompt_lens(np.random.default_rng(0))) - 1
    bf = torch.bfloat16
    rows = kernel_phase(fd, [
        ("llama_decode", 8, 1, 1024, 32, 32, bf, "ragged", False),
        ("llama_prefill_into_slots", 1, W, W, 32, 32, bf, "zero", False)],
        phase="kernel_llama")
    results = {r["name"]: r for r in rows}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    B, S, nH, hD = 4, 512, 32, 128
    q, k, v = (torch.randn((B, S, nH, hD), generator=gen, device="cuda")
               .to(bf) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, 0)
    err, ref_max, differ, share = _err(out, w_out)
    lse_err = (lse - w_lse).abs().max().item()
    if not share <= 1 or not lse_err <= 1e-3:
        raise AssertionError(f"flash_attention_fwd llama_prefill: max abs err "
                             f"{err}, {share} of its limit; lse {lse_err}")
    sdpa = [t.transpose(1, 2) for t in (q, k, v)]
    lib_err = (F.scaled_dot_product_attention(*sdpa, is_causal=True)
               .transpose(1, 2).float() - w_out.float()).abs().max().item()
    n_el, stats = B * S * nH * hD, B * nH * S * 4
    row = {"phase": "kernel_llama", "name": "llama_prefill",
           "shape": f"B={B} S={S} nH={nH} hD={hD} bfloat16 causal, "
                    f"unpacked q/k/v",
           "kernel_ms": _time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                                True),
                                 reps=10, flush=flush),
           "plain_ms": _time_ms(
               lambda: fa.flash_attention_with_lse_plain(q, k, v, 0), reps=3,
               flush=flush),
           "library_ms": _time_ms(
               lambda: F.scaled_dot_product_attention(*sdpa, is_causal=True),
               reps=10, flush=flush),
           **_bound(4 * n_el * 2 + stats,
                    4 * hD * (S * (S + 1) // 2) * B * nH, "bfloat16"),
           "max_abs_err": err, "max_ref": ref_max, "share_differing": differ,
           "limit_share": share, "lse_max_abs_err": lse_err,
           "library_max_abs_err": lib_err}
    row.update(_rates({"fwd_ms": row["kernel_ms"]}, {"fwd": row}))
    _log(row)
    results["llama_prefill"] = row
    del flush, q, k, v, out, lse, w_out, w_lse, sdpa
    torch.cuda.empty_cache()
    return results


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def llama_slot_loop(llama, params, cfg, prompts, new_tokens, max_len,
                    kv_dtype="bf16", attn_kernel=None, device="cuda"):
    """The serving engine's slot priming, written out for LLaMA: each
    prompt but its last token goes through ``prefill_into_slots`` into
    its own slot; one ``decode_step_multi`` at each slot's position S-1
    feeds the last prompt token (the first new token), and new_tokens - 1
    greedy steps follow.  Returns a dict: the streams [B][new_tokens],
    the first step's logits, the cache and the last step's token and
    positions (for a profile), and host seconds of the prefills and of
    the decode steps (each section ends in a synchronise)."""
    cache = llama.init_decode_cache(cfg, len(prompts), max_len, kv_dtype,
                                    device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b, p in enumerate(prompts):
            ids = torch.as_tensor(np.asarray(p[:-1]), device=device)[None]
            llama.prefill_into_slots(params, ids, cfg, cache,
                                     torch.tensor([b], device=device),
                                     attn_kernel=attn_kernel)
        _sync(device)
        t1 = time.perf_counter()
        tok = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32,
                           device=device)
        pos = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                           device=device)
        out, first = [], None
        for i in range(new_tokens):
            if i:
                pos = pos + 1
            logits, cache = llama.decode_step_multi(
                params, cache, tok, pos, cfg, attn_kernel=attn_kernel)
            if first is None:
                first = logits
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        streams = torch.stack(out, 1).cpu().tolist()
        t2 = time.perf_counter()
    return {"streams": streams, "first_logits": first, "cache": cache,
            "token": tok, "pos": pos, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def norm_add_profile(step, rows, H, n=10):
    """The RMS norms and the residual adds of a decode step ``step()``
    over ``rows`` rows of H, under torch.profiler (shapes recorded), per
    step: the device ms and launches of the RMS kernels (every kernel
    named rms_norm*), of the separate residual adds (``aten::add`` of two
    [rows, H] tensors, their kernels' device time), their sum, and the
    step's device ms and kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()

    def dev_us(ev, self_only):
        name = "self_device_time_total" if self_only else "device_time_total"
        us = getattr(ev, name, None)
        if us is None:
            us = getattr(ev, name.replace("device", "cuda"), 0.0)
        return us

    out = dict.fromkeys(("rms_ms", "rms_launches", "residual_add_ms",
                         "residual_adds", "device_ms", "kernels"), 0.0)
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = dev_us(ev, True)
        out["device_ms"] += us / n / 1e3
        out["kernels"] += ev.count / n
        if "rms_norm" in ev.key.lower():
            out["rms_ms"] += us / n / 1e3
            out["rms_launches"] += ev.count / n
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.key == "aten::add" and list(ev.input_shapes[:2]) == [
                [rows, H], [rows, H]]:
            out["residual_add_ms"] += dev_us(ev, False) / n / 1e3
            out["residual_adds"] += ev.count / n
    out["norm_add_ms"] = out["rms_ms"] + out["residual_add_ms"]
    return out


def _rms_launches(L, forwards, into_slots):
    """The RMS launches of a run of an L-layer LLaMA: 2L + 1 norms a
    forward pass (a prefill, a decode step), 2L a ``prefill_into_slots``
    call (no final norm).  Layer 0's attention norm reads no residual sum
    and launches the norm alone ("llama"); every other norm launches the
    fused residual-add instance ("add_llama"), so a forward pass adds
    nothing outside the norm kernels to the residual stream."""
    return {"rms_llama": forwards + into_slots,
            "rms_add_llama": 2 * L * forwards + (2 * L - 1) * into_slots}


def _rms_counts(fnr):
    return {"rms_llama": fnr.LAUNCHES["llama"],
            "rms_add_llama": fnr.LAUNCHES["add_llama"]}


def llama_reference_phase(llama, fnr, fd):
    """llama_tiny (4 q / 2 kv heads, hD 32) in float32 at
    initializer_range 0.3 (0.02 gives near-constant streams that would
    hide a broken cache): the card's kernel route (use_flash None: the
    RMS kernel, flash_attention; attn_kernel "flash") against the CPU's
    plain route, identical greedy streams for ``generate`` (B 2, S 16,
    8 new) and for the slot loop over 4 prompts of different lengths at
    kv_dtype bf16 and int8; the card's launches counted exactly."""
    cfg = llama.llama_tiny(dtype=torch.float32, initializer_range=0.3)
    cpu_params = llama.init_params(cfg, seed=1, device="cpu")
    gpu_params = _to_device(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 16))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 23, 12, 40)]
    gen = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        fnr.reset_launches()
        gen[dev] = llama.generate(params, ids, cfg, max_new_tokens=8).cpu() \
            .tolist()
    want = _rms_launches(cfg.num_layers, 8, 0)
    if gen["cpu"] != gen["cuda"] or _rms_counts(fnr) != want:
        raise AssertionError(f"llama_tiny generate: card {gen['cuda']} vs "
                             f"CPU {gen['cpu']}, {fnr.LAUNCHES} RMS launches "
                             f"(want {want})")
    loops = {}
    for kd in ("bf16", "int8"):
        cpu = llama_slot_loop(llama, cpu_params, cfg, prompts, 8, 64, kd,
                              "xla", "cpu")
        fnr.reset_launches()
        fd.reset_launches()
        card = llama_slot_loop(llama, gpu_params, cfg, prompts, 8, 64, kd,
                               "flash", "cuda")
        counts = (_rms_counts(fnr), fd.LAUNCHES)
        want = (_rms_launches(cfg.num_layers, 8, len(prompts)),
                cfg.num_layers * (8 + len(prompts)))
        if card["streams"] != cpu["streams"] or counts != want:
            raise AssertionError(f"llama_tiny slot loop {kd}: card "
                                 f"{card['streams']} vs CPU {cpu['streams']}, "
                                 f"launches {counts} (want {want})")
        loops[kd] = card["streams"]
    _log({"phase": "reference_llama", "config": "llama_tiny f32, GQA 4/2, "
          "initializer_range 0.3", "generate": gen["cuda"],
          "slot_loop_prompt_lens": [len(p) for p in prompts],
          "slot_loop_kv_dtypes": sorted(loops), "streams_identical": True})


@contextlib.contextmanager
def _patched(module, name, fault):
    """``module.name`` replaced by ``fault(module.name)`` for the block."""
    old = getattr(module, name)
    setattr(module, name, fault(old))
    try:
        yield
    finally:
        setattr(module, name, old)


# Negative controls of the full-width route check: each is the kernel
# route with one fault of the kind a kernel could have, injected at run
# time around the call (the sources are not touched).  Attention faults
# wrap the attention kernel's wrapper (``flash_attention`` in prefill,
# ``flash_decode_attention`` in decode); the RMS fault wraps ``rms_norm``.
def _kv_heads_rolled(attn):
    """Every head attends the K/V of its neighbour (a head-index
    fault)."""
    def f(q, k, v, *a, **kw):
        return attn(q, k.roll(1, 2), v.roll(1, 2), *a, **kw)
    return f


def _attention_zeroed(attn):
    """The attention output is never written (zeros)."""
    def f(q, k, v, *a, **kw):
        return torch.zeros_like(q)
    return f


def _newest_row_dropped(attn):
    """flash_decode attends rows [0, pos) instead of [0, pos] (an
    off-by-one mask)."""
    def f(q, k, v, pos):
        return attn(q, k, v, pos - 1)
    return f


def _first_rms_fused(rms):
    """The first RMSNorm of the call (layer 0's attention norm) runs in
    the "fused" rounding policy (a rounding-point fault)."""
    calls = [0]

    def f(x, w, eps, policy):
        calls[0] += 1
        return rms(x, w, eps, "fused" if calls[0] == 1 else policy)
    return f


def _controls(llama, common, run, decode):
    """``run()`` (one kernel-route step's logits) under each negative
    control: the attention faults on the kernel that step runs
    (``decode``: flash_decode, else flash_attention), and the RMS
    fault."""
    attn = (llama, "flash_decode_attention") if decode \
        else (common, "flash_attention")
    faults = [("kv_heads_rolled", attn, _kv_heads_rolled),
              ("attention_zeroed", attn, _attention_zeroed),
              ("first_rms_fused", (llama, "rms_norm"), _first_rms_fused)]
    if decode:
        faults.append(("newest_row_dropped", attn, _newest_row_dropped))
    out = {}
    for name, (module, attr), fault in faults:
        with _patched(module, attr, fault), torch.inference_mode():
            out[name] = run()
    return out


def llama_serving_phase(llama, common, fnr, fa, fd):
    """llama_7b at full width (32 layers, H 4096, 32 heads of 128, FFN
    11008, V 32000, bf16, random weights from seed 0).  (a) ``generate``
    of 4 seeded prompts of 512 tokens, 32 new, greedy; (b) the slot loop
    over 8 prompts (lengths from seed 0 in 32..700), max_len 1024, 32
    new tokens, attn_kernel "flash".  Counts are set to 0 just before
    each and held exactly (``_rms_launches``: the norm alone once and the
    fused residual-add instance 64 times a forward pass, once and 63
    times a ``prefill_into_slots``), flash_attention_fwd 32 a generate
    prefill,
    flash_decode 32 a slot decode step and a ``prefill_into_slots``.
    Then one 8-slot decode step profiled; the plain route (use_flash
    False, attn_kernel "xla") on the same weights and prompts, its
    stream agreement reported; and the first-step logits of both routes
    (generate's prefill, the slot loop's first step) against the same
    steps computed in float32 from the same weights (``_route_cmp``)."""
    cfg = llama.llama_7b(dtype=torch.bfloat16)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    _log({"phase": "llama_setup", "config": "llama_7b bf16",
          "params": llama.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    rng = np.random.default_rng(0)
    B, S, new = 4, 512, 32
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                       device="cuda")
    # warm-up: cuBLAS handles and each kernel's first launch
    llama.generate(params, ids[:, :16], cfg, max_new_tokens=2)
    torch.cuda.synchronize()

    def counts():
        return {**_rms_counts(fnr), "rms_fused": fnr.LAUNCHES["fused"],
                "rms_add_fused": fnr.LAUNCHES["add_fused"],
                "flash_attention_fwd": fa.LAUNCHES["flash_attention_fwd"],
                "flash_decode": fd.LAUNCHES}

    def reset():
        fnr.reset_launches()
        fd.reset_launches()
        fa.reset_launches()

    reset()
    t0 = time.perf_counter()
    toks = llama.generate(params, ids, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = counts()
    want = {**_rms_launches(L, new, 0), "rms_fused": 0, "rms_add_fused": 0,
            "flash_attention_fwd": L, "flash_decode": 0}
    if gen_counts != want:
        raise AssertionError(f"llama_7b generate launches {gen_counts}, "
                             f"want {want}")
    toks = toks.cpu()
    if toks.shape != (B, new) or not bool(((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"llama_7b generate tokens {toks}")
    with torch.inference_mode():
        cache = llama.init_decode_cache(cfg, B, S + new, device="cuda")
        first = {"kernel": llama.prefill(params, ids, cfg, cache)[0]}
        prefill_ms = _time_ms(lambda: llama.prefill(params, ids, cfg, cache),
                              reps=3)
        first["plain"] = llama.prefill(params, ids, plain_cfg, cache)[0]
        first["controls"] = _controls(
            llama, common, lambda: llama.prefill(params, ids, cfg, cache)[0],
            decode=False)
        del cache
    plain_toks = llama.generate(params, ids, plain_cfg,
                                max_new_tokens=new).cpu()
    gen_row = {"phase": "llama_generate", "B": B, "S": S, "max_new": new,
               "launches": gen_counts, "wall_s": gen_s,
               "prefill_ms": prefill_ms,
               # decode: the wall time less one prefill's device time
               "decode_tok_s": B * (new - 1) / (gen_s - prefill_ms / 1e3),
               "e2e_tok_s": B * new / gen_s,
               "plain_route_streams_equal":
                   f"{sum(a == b for a, b in zip(toks.tolist(), plain_toks.tolist()))}/{B}",
               "plain_route_tokens_equal":
                   f"{int((toks == plain_toks).sum())}/{B * new}"}

    # (b) the slot loop over 8 prompts of seeded lengths
    rng = np.random.default_rng(0)
    lens = _llama_prompt_lens(rng)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    torch.cuda.reset_peak_memory_stats()
    reset()
    loop = llama_slot_loop(llama, params, cfg, prompts, new, 1024,
                           attn_kernel="flash")
    loop_counts = counts()
    want = {**_rms_launches(L, new, len(prompts)),
            "rms_fused": 0, "rms_add_fused": 0, "flash_attention_fwd": 0,
            "flash_decode": L * (new + len(prompts))}
    if loop_counts != want:
        raise AssertionError(f"llama_7b slot loop launches {loop_counts}, "
                             f"want {want}")
    cache = loop.pop("cache")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    peak = torch.cuda.max_memory_allocated()
    prof = _step_profile(lambda: llama.decode_step_multi(
        params, cache, loop["token"], loop["pos"], cfg, attn_kernel="flash"),
        LLAMA_FAMILIES)
    norm_add = norm_add_profile(lambda: llama.decode_step_multi(
        params, cache, loop["token"], loop["pos"], cfg, attn_kernel="flash"),
        len(prompts), cfg.hidden_size)
    # the first step again on the final cache (rows past S-1 are masked,
    # row S-1 is rewritten before it is read), then under each control
    first_tok = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32,
                             device="cuda")
    first_pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                             device="cuda")

    def first_step():
        return llama.decode_step_multi(params, cache, first_tok, first_pos,
                                       cfg, attn_kernel="flash")[0]

    with torch.inference_mode():
        again = first_step()
    loop_controls = _controls(llama, common, first_step, decode=True)
    del cache
    torch.cuda.empty_cache()
    plain = llama_slot_loop(llama, params, plain_cfg, prompts, new, 1024,
                            attn_kernel="xla")
    del plain["cache"]
    same = sum(a == b for a, b in zip(loop["streams"], plain["streams"]))
    tokens_same = sum(x == y for a, b in zip(loop["streams"], plain["streams"])
                      for x, y in zip(a, b))
    loop_row = {"phase": "llama_slot_loop", "prompt_lens": lens,
                "max_len": 1024, "new_tokens": new, "launches": loop_counts,
                "prefill_s": loop["prefill_s"], "decode_s": loop["decode_s"],
                "decode_tok_s": len(prompts) * new / loop["decode_s"],
                "cache_bytes": cache_bytes, "peak_memory_bytes": peak,
                "plain_route_streams_equal": f"{same}/{len(prompts)}",
                "plain_route_tokens_equal":
                    f"{tokens_same}/{len(prompts) * new}",
                "decode_step": dict(slots=len(prompts),
                                    tok_s=len(prompts) / prof["wall_ms"] * 1e3,
                                    **prof),
                "decode_step_norm_add": norm_add}
    torch.cuda.empty_cache()

    # the first steps again in float32 (the same weights widened, plain
    # compositions, TF32 off): the yardstick both bf16 routes are held to
    f32 = _cast(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, use_flash=False)
    with torch.inference_mode():
        cache = llama.init_decode_cache(cfg32, B, S + new, device="cuda")
        ref_gen = llama.prefill(f32, ids, cfg32, cache)[0]
        del cache
    ref_loop = llama_slot_loop(llama, f32, cfg32, prompts, 1, 1024,
                               attn_kernel="xla")
    del f32, ref_loop["cache"]
    torch.cuda.empty_cache()
    gen_row.update(_route_cmp(first["kernel"], first["plain"], ref_gen,
                              "prefill", first["controls"]))
    loop_row.update(_route_cmp(loop["first_logits"], plain["first_logits"],
                               ref_loop["first_logits"], "first_step",
                               loop_controls))
    loop_row["first_step_recomputed_max_abs_diff"] = \
        (again - loop["first_logits"]).abs().max().item()
    _log(gen_row)
    _log(loop_row)
    return gen_row, loop_row


def _cast(tree, dtype):
    """A parameter tree with every floating leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _route_cmp(kernel, plain, ref, label, controls):
    """The bf16 kernel route's first-step logits against the same step in
    float32 (``ref``), per element: |kernel - ref| within
    LLAMA_ROUTE_FACTOR times the plain bf16 route's largest |plain - ref|
    (the size of bf16 rounding through the stack, measured on the same
    inputs); the two routes round P, and sum, in other places, so their
    difference alone has no fixed size.  Raises past the bound.  Each
    negative control (the kernel route with one injected fault) is read
    against the same float32 step and reported beside the bound: the
    largest and the mean |control - ref|, a non-finite control as inf.
    Raises too if an attention-fault control (LLAMA_MUST_FAIL) stays
    within the bound: then the bound could not tell a broken route."""
    for name, t in (("kernel", kernel), ("plain", plain), ("f32", ref)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"llama_7b {label}: non-finite {name} logits")

    def dist(t):
        d = (t.float() - ref).abs()
        if not torch.isfinite(d).all():
            return float("inf"), float("inf")
        return d.max().item(), d.mean().item()

    ek, mk = dist(kernel)
    ep, mp = dist(plain)
    bound = LLAMA_ROUTE_FACTOR * ep
    if not ek <= bound:
        raise AssertionError(f"llama_7b {label}: kernel route {ek} from the "
                             f"float32 step, > {LLAMA_ROUTE_FACTOR} x the "
                             f"plain route's {ep}")

    def agree(a):
        return f"{int((a.argmax(-1) == ref.argmax(-1)).sum())}/{ref.shape[0]}"

    ctl = {}
    for name, t in controls.items():
        m, a = dist(t)
        ctl[name] = {"max_abs": m, "mean_abs": a, "max_over_bound": m / bound,
                     "mean_over_plain_mean": a / mp,
                     "argmax_agree_f32": agree(t)}
        if name in LLAMA_MUST_FAIL and not m > bound:
            raise AssertionError(f"llama_7b {label}: control {name} is "
                                 f"{m} from the float32 step, within the "
                                 f"bound {bound}")
    return {f"{label}_kernel_vs_f32_max_abs": ek,
            f"{label}_plain_vs_f32_max_abs": ep,
            f"{label}_kernel_vs_f32_mean_abs": mk,
            f"{label}_plain_vs_f32_mean_abs": mp,
            f"{label}_kernel_vs_plain_max_abs":
                (kernel - plain).abs().max().item(),
            f"{label}_bound": bound,
            f"{label}_logit_std_f32": ref.std().item(),
            f"{label}_argmax_agree_kernel_f32": agree(kernel),
            f"{label}_argmax_agree_plain_f32": agree(plain),
            f"{label}_controls": ctl}


# ---------------------------------------------------------------------------
# LLaMA training and the ring variant of flash attention
# ---------------------------------------------------------------------------

RING_P = 4                          # ranks of the replayed ring
RING_CHUNK = 1024                   # llama_7b's 4096 positions over 4 ranks
RING_OFFSETS = (-1024, -37, 0, 37, 1024, 3072)
RING_TRAIN_OFFSETS = (0, -37, 37)   # at the sp run's [B, S] (offset 0 there)
RING_LSE_ATOL = 1e-3
# the replayed ring against dense flash attention over the whole
# sequence: float32 within F32_REL of the largest value; bfloat16 (each
# rank's partials rounded to bf16 by the kernel, dK/dV summed across ranks
# in bf16, as in JAX) within 2^-6 in norm and 2^-4 of the largest value
RING_BF16_NORM_REL, RING_BF16_MAX_REL = 2 ** -6, 2 ** -4
SP_LOSS_REL = 1e-6                  # one-rank ring vs no group: loss
SP_GRAD_NORM_REL = 1e-3             # and each gradient leaf, in norm
LLAMA_TRAIN_LAYERS = 8              # llama_7b's 32, cut to fit AdamW state
LLAMA_TRAIN_B, LLAMA_TRAIN_S = 4, 2048
LLAMA_FLASH_FAMILIES = (("flash_fwd", ("flash_attention_fwd",)),
                        ("flash_bwd", ("flash_attention_bwd",)),
                        ("rms_fwd", ("rms_norm_fwd",)),
                        ("rms_bwd", ("rms_norm_bwd", "rms_norm_dw")))


def _visible_pairs(Sq, Sk, offset):
    """(query, key) pairs with j <= i + offset, per (batch, head)."""
    i = np.arange(Sq)
    return int(np.clip(i + offset + 1, 0, Sk).sum())


def _visible(Sq, Sk, offset, device):
    """[Sq, Sk] bool: key j visible to query i iff j <= i + offset."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None] + offset)


RING = "flash_attention_with_lse"    # the ring variant's launch counts


def ring_kernels_check(fa, q, k, v, dout, g_lse, offset):
    """The offset variant's three kernels (counted under the ring entry)
    against their plain versions on the same inputs (the backward pair
    reads the kernel's lse and a delta that folds in the lse cotangent),
    per element at the training phase's limits, lse at RING_LSE_ATOL;
    and at offset 0 the same three kernels under ``flash_attention``'s
    entry, as its autograd Function launches them, bit for bit.  Raises
    past a limit; returns (kernel outputs (out, lse, dk, dv, dq), delta,
    errors, lse error)."""
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, offset, RING)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, True,
                                        None, offset, RING)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, True, None,
                                   offset, RING)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_with_lse_plain(q, k, v, offset)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                  True, None, offset)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, True,
                                           None, offset)
    errs = {"out": _err(out, w_out), "dk": _err(dk, w_dk),
            "dv": _err(dv, w_dv), "dq": _err(dq, w_dq)}
    lse_err = (lse - w_lse).abs().max().item()
    label = f"offset {offset} {q.dtype} {tuple(q.shape)}"
    for key, (err, _, _, share) in errs.items():
        if not share <= 1:
            raise AssertionError(f"flash_attention offset kernels {label} "
                                 f"{key}: max abs err {err}, {share} of "
                                 f"its limit")
    if not lse_err <= RING_LSE_ATOL:
        raise AssertionError(f"flash_attention offset kernels {label} lse: "
                             f"{lse_err}")
    if offset == 0:
        z_out, z_lse = fa.flash_attention_fwd(q, k, v, True)
        z_dk, z_dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)
        z_dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta)
        for name, a, b in (("out", out, z_out), ("lse", lse, z_lse),
                           ("dk", dk, z_dk), ("dv", dv, z_dv),
                           ("dq", dq, z_dq)):
            if not torch.equal(a, b):
                raise AssertionError(f"offset 0 vs the zero-offset kernel "
                                     f"{label} {name}: not bit for bit")
    return (out, lse, dk, dv, dq), delta, errs, lse_err


def ring_kernel_phase(fa):
    """The offset variant at llama_7b's attention per ring chunk (B 1,
    1024 queries and keys, 32 heads of 128, causal), bfloat16 and
    float32, at offsets -1024 (every row fully masked: the kernels visit
    every key tile, as the TPU kernel does), -37, 0, 37, 1024 and 3072
    (every key visible); and at the shape the sequence-parallel run
    gives it (llama_7b training, B 4, S 2048, bf16) at offsets 0 (that
    run's), -37 and 37.  Each held per element to the plain versions,
    offset 0 bit for bit to the zero-offset entry, float32 also to the
    three kernels' tf32x3 emulations.  Times of the kernels and the plain
    versions; SDPA with the offset's boolean mask, forward and autograd
    backward, at offsets >= 0 (a fully masked row gives NaN there);
    bounds from the visible pairs (bytes where none is; float32 as three
    TF32 products, the FFMA bound beside)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    nH, hD = 32, 128
    cases = [("chunk", 1, RING_CHUNK, torch.bfloat16, RING_OFFSETS),
             ("chunk", 1, RING_CHUNK, torch.float32, RING_OFFSETS),
             ("train", LLAMA_TRAIN_B, LLAMA_TRAIN_S, torch.bfloat16,
              RING_TRAIN_OFFSETS)]
    results = {}
    for case, B, S, dt, offsets in cases:
        dts = str(dt).split(".")[-1]
        q, k, v, dout = (torch.randn((B, S, nH, hD), generator=gen,
                                     device="cuda").to(dt) for _ in range(4))
        g_lse = torch.randn((B, nH, S), generator=gen, device="cuda")
        for off in offsets:
            (out, lse, dk, dv, dq), delta, errs, lse_err = ring_kernels_check(
                fa, q, k, v, dout, g_lse, off)
            emu = None
            if dt == torch.float32:
                # the three kernels against their own arithmetic too
                emu = {**tf32x3_forward_share(fa, q, k, v, out, lse, True,
                                              off),
                       **tf32x3_backward_share(fa, q, k, v, dout, lse, delta,
                                               (dk, dv, dq), True, off)}
                if not max(emu.values()) <= 1:
                    raise AssertionError(f"flash_attention offset {off} "
                                         f"float32 against the tf32x3 "
                                         f"emulation: {emu}")
            del dk, dv, dq
            times = {
                "fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, True, None, off, RING), reps=10, flush=flush),
                "fwd_plain_ms": _time_ms(
                    lambda: fa.flash_attention_with_lse_plain(q, k, v, off),
                    reps=3, flush=flush),
                "dkv_ms": _time_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, dout, lse, delta, True, None, off, RING),
                    reps=10, flush=flush),
                "dkv_plain_ms": _time_ms(
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, dout, lse, delta, True, None, off), reps=3,
                    flush=flush),
                "dq_ms": _time_ms(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, dout, lse, delta, True, None, off, RING),
                    reps=10, flush=flush),
                "dq_plain_ms": _time_ms(
                    lambda: fa.flash_attention_bwd_dq_plain(
                        q, k, v, dout, lse, delta, True, None, off), reps=3,
                    flush=flush),
                "fwd_library_ms": None, "bwd_library_ms": None}
            lib_err = None
            if off >= 0:
                mask = _visible(S, S, off, "cuda")
                leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=mask)
                lib_err = (lib_out.detach().transpose(1, 2).float()
                           - out.float()).abs().max().item()
                times["fwd_library_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(t.transpose(1, 2) for t in (q, k, v)),
                        attn_mask=mask), reps=10, flush=flush)
                times["bwd_library_ms"] = _time_ms(
                    lambda: torch.autograd.grad(
                        lib_out, leaves, dout.transpose(1, 2),
                        retain_graph=True), reps=10, flush=flush)
                del lib_out, leaves, mask
            if case == "train" and off == 0:
                # the same function through SDPA's causal flag: its flash
                # backend, where the boolean mask above takes another
                leaves = [t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         is_causal=True)
                times["fwd_library_causal_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *(t.transpose(1, 2) for t in (q, k, v)),
                        is_causal=True), reps=10, flush=flush)
                times["bwd_library_causal_ms"] = _time_ms(
                    lambda: torch.autograd.grad(
                        lib_out, leaves, dout.transpose(1, 2),
                        retain_graph=True), reps=10, flush=flush)
                del lib_out, leaves
            pairs = _visible_pairs(S, S, off) * B * nH
            n_el, e, stats = B * S * nH * hD, q.element_size(), B * nH * S * 4
            bounds = {
                "fwd": _bound(4 * n_el * e + stats, 4 * hD * pairs, dts),
                "dkv": _bound(6 * n_el * e + 2 * stats, 8 * hD * pairs, dts),
                "dq": _bound(5 * n_el * e + 2 * stats, 6 * hD * pairs, dts)}
            if dt == torch.float32:
                _split_bounds(bounds)
            row = {"phase": "kernel_ring", "case": case, "offset": off,
                   "shape": f"B={B} Sq=Sk={S} nH={nH} hD={hD} {dts} causal",
                   "visible_pairs": pairs, **times, **_rates(times, bounds),
                   "max_abs_err": {k2: v2[0] for k2, v2 in errs.items()},
                   "limit_share": {k2: v2[3] for k2, v2 in errs.items()},
                   "lse_max_abs_err": lse_err, "tf32x3_emulation": emu,
                   "library_fwd_max_abs_err": lib_err,
                   "offset0_bit_for_bit": True if off == 0 else None,
                   "bounds": bounds}
            if dt == torch.float32:
                row["bound_share_ffma"] = _ffma_shares(times, bounds)
            _log(row)
            results[(f"{case} {dts}", off)] = row
            del out, lse, delta
        del q, k, v, dout, g_lse
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return results


def _replay_pass(kc, vc, rank):
    """The hand-over of rank ``rank`` in a replayed ring: each call
    returns the chunk one rank further back than the last one."""
    held = iter(range(rank - 1, rank - len(kc), -1))

    def pass_kv(_k, _v):
        src = next(held) % len(kc)
        return kc[src], vc[src]
    return pass_kv


def ring_replay(fa, ra, B, Sl, nH, hD, dtype, seed=0, timed=False):
    """All RING_P ranks of a ring over a sequence of RING_P * Sl, replayed
    on one card through ``ring_attention_loop`` with a local hand-over:
    the concatenated outputs and dq/dk/dv from one backward against
    dense ``flash_attention`` over the whole sequence (float32 within
    F32_REL of the largest value; bfloat16 within RING_BF16_NORM_REL in
    norm and RING_BF16_MAX_REL of the largest value).  Raises past a
    limit; returns a row of errors (and times of both, fwd + bwd)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (B, RING_P * Sl, nH, hD)
    base = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]
    g = base[3]

    def replay():
        leaves = [t.detach().requires_grad_(True) for t in base[:3]]
        qc, kc, vc = (t.chunk(RING_P, dim=1) for t in leaves)
        out = torch.cat([ra.ring_attention_loop(
            qc[r], kc[r], vc[r], r, RING_P, _replay_pass(kc, vc, r))
            for r in range(RING_P)], dim=1)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    def dense():
        leaves = [t.detach().requires_grad_(True) for t in base[:3]]
        out = fa.flash_attention(*leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    fa.reset_launches()
    got = replay()
    torch.cuda.synchronize()
    launches = fa.launches(RING)
    want = dense()
    row = {"shape": f"{RING_P} ranks x B={B} S={Sl} nH={nH} hD={hD} "
                    f"{str(dtype).split('.')[-1]}", "launches": launches}
    if launches != {n: RING_P * RING_P for n in launches}:
        raise AssertionError(f"ring replay launches {launches}: want "
                             f"{RING_P * RING_P} of each (every block)")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        diff = (a.float() - b.float())
        ref = b.float().abs().max().item()
        err, norm_rel = diff.abs().max().item(), (
            diff.norm() / b.float().norm()).item()
        row[name] = {"max_abs_err": err, "max_ref": ref, "norm_rel": norm_rel}
        if dtype == torch.float32:
            ok = err <= F32_REL * max(1.0, ref)
        else:
            ok = norm_rel <= RING_BF16_NORM_REL \
                and err <= RING_BF16_MAX_REL * ref
        if not ok:
            raise AssertionError(f"ring replay {row['shape']} {name}: "
                                 f"{row[name]}")
    if timed:
        row["replay_ms"] = _time_ms(replay, reps=5)
        row["dense_ms"] = _time_ms(dense, reps=5)
    return row


def ring_replay_phase(fa, ra):
    """The replayed 4-way ring at llama_7b's shapes (chunks of 1024,
    global S 4096, 32 heads of 128), float32 and bfloat16, timed beside
    dense flash attention (forward and backward)."""
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        row = ring_replay(fa, ra, 1, RING_CHUNK, 32, 128, dt, timed=True)
        row["phase"] = "ring_replay"
        _log(row)
        rows[str(dt).split(".")[-1]] = row
    torch.cuda.empty_cache()
    return rows


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _grad_leaves(params):
    """(names, leaves) of a parameter tree, each leaf made trainable."""
    named = _named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    return [n for n, _ in named], [t for _, t in named]


def llama_sp_check(llama, fa, cfg, params, ids, labels):
    """``llama.loss_fn(sp_group=g)`` on a real one-rank NCCL group (the
    ring at P = 1: one block at offset 0 through the offset kernels, no
    exchange) against ``loss_fn`` without a group on the same params and
    batch: the loss within SP_LOSS_REL, each gradient leaf within
    SP_GRAD_NORM_REL in norm (bit for bit is reported).  A first call
    sets up the NCCL communicator; the kernels' counts are reset just
    before the second and read just after, and it alone is timed."""
    import torch.distributed as dist
    names, leaves = _grad_leaves(params)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)

    def sp_loss_and_grads():
        loss = llama.loss_fn(params, ids, labels, cfg, sp_group=group)
        return loss, torch.autograd.grad(loss, leaves)

    try:
        group = dist.new_group([0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp_loss_and_grads()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        fa.reset_launches()
        t0 = time.perf_counter()
        loss_sp, g_sp = sp_loss_and_grads()
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.launches(RING)
        zero_offset = fa.launches()
        loss = llama.loss_fn(params, ids, labels, cfg)
        g = torch.autograd.grad(loss, leaves)
    finally:
        dist.destroy_process_group()
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, g_sp, g)}
    row = {"loss_sp": loss_sp.item(), "loss": loss.item(),
           "loss_bit_for_bit": bool(torch.equal(loss_sp, loss)),
           "grads_bit_for_bit": all(torch.equal(a, b)
                                    for a, b in zip(g_sp, g)),
           "grad_norm_rel_max": max(rel.values()), "offset_launches": launches,
           "zero_offset_launches": zero_offset,
           "first_call_ms": first_ms, "sp_loss_and_grads_ms": sp_ms}
    L = cfg.num_layers
    if launches != {n: L for n in launches} or any(zero_offset.values()):
        raise AssertionError(f"llama sp launches: offset {launches} (want "
                             f"{L} each), zero-offset {zero_offset}")
    if not abs(row["loss_sp"] - row["loss"]) <= SP_LOSS_REL * abs(
            row["loss"]) or not row["grad_norm_rel_max"] <= SP_GRAD_NORM_REL:
        raise AssertionError(f"llama sp at P = 1 vs no group: {row}, {rel}")
    return row


def _llama_train_counts(fa, fnr):
    return {**fa.launches(), "ring": sum(fa.launches(RING).values()),
            **_rms_counts(fnr), "rms_bwd_llama": fnr.LAUNCHES["bwd_llama"]}


def _llama_train_want(L, steps, remat):
    """Launches of ``steps`` LLaMA train steps: each flash kernel L a
    step (the forward 2L under remat); the RMS norms of a forward pass
    (``_rms_launches``) and one backward launch for each of the 2L + 1
    norms.  Under remat a layer's checkpoint keeps the residual sum, so
    each attention norm and the final norm launch the norm alone and
    only the ffn norms the fused instance (L + 1 and L), and the layers'
    2L run again in the backward."""
    if remat:
        fwd = {"rms_llama": steps * (L + 1 + L),
               "rms_add_llama": steps * 2 * L}
    else:
        fwd = _rms_launches(L, steps, 0)
    return {"flash_attention_fwd": steps * L * (2 if remat else 1),
            "flash_attention_bwd_dkv": steps * L,
            "flash_attention_bwd_dq": steps * L, "ring": 0, **fwd,
            "rms_bwd_llama": steps * (2 * L + 1)}


def llama_train_reference_phase(llama, hybrid, fa, fnr):
    """llama_tiny (GQA 4/2) float32: three train steps on the card (the
    flash and RMS kernels) against the CPU (plain versions) on the same
    weights and batch, at remat False and True: losses at rel 1e-4,
    launches exact."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    ids, labels = (torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
                   for _ in range(2))
    rows = []
    for remat in (False, True):
        losses = {}
        for dev in ("cpu", "cuda"):
            step, shard, init_opt = hybrid.build_train_step(
                cfg, device=dev, model=hybrid.llama_stage_model(cfg, remat))
            p = shard(params)
            o = init_opt(p)
            fa.reset_launches()
            fnr.reset_launches()
            out = []
            for _ in range(3):
                loss, p, o = step(p, o, ids.to(dev), labels.to(dev))
                out.append(loss.item())
            losses[dev] = out
            counts = _llama_train_counts(fa, fnr)
            want = (_llama_train_want(cfg.num_layers, 3, remat)
                    if dev == "cuda" else dict.fromkeys(counts, 0))
            if counts != want:
                raise AssertionError(f"llama train reference {dev} remat "
                                     f"{remat}: launches {counts} != {want}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        row = {"phase": "reference_llama_training",
               "config": "llama_tiny f32, GQA 4/2", "remat": remat,
               "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
               "max_rel_diff": rel, "rtol": 1e-4,
               "launches_card": _llama_train_want(cfg.num_layers, 3, remat)}
        _log(row)
        if not rel <= 1e-4 or not losses["cuda"][2] < losses["cuda"][0]:
            raise AssertionError(f"llama train reference remat {remat}: card "
                                 f"{losses['cuda']} vs CPU {losses['cpu']}")
        rows.append(row)
    return rows


def _rms_bwd_floor(x, w, g, policy, eps=1e-6):
    """Per element, the magnitude below which a bfloat16 dx may be one
    step off (float32, from x, w, g).  "llama": dx ends in a bfloat16
    add of two rounded terms, T(g w) r + T(c 2x), and where they cancel
    one step of a term is many steps of the sum: twice the first term,
    2 |g w| r.  "fused": dx is one float32 expression, r (g w - xhat m),
    rounded once, so where it cancels only the float32 noise of its
    terms shows, and that of m = mean(g w xhat), a sum in another order,
    scales with mean |g w xhat| (not with |m|, which is small in some
    rows): 2^-8 (|g w| r + r |xhat| mean |g w xhat|), whose bfloat16
    step is 2^-16 of the terms' scale — some 100 float32 steps, and
    2^-7 of what one bfloat16 rounding of xhat or g w would add."""
    xc, gc, wc = x.float(), g.float(), w.float()
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    gw = (gc * wc).abs()
    if policy == "llama":
        return 2 * gw * rstd
    xhat = (xc * rstd).abs()
    return 2.0 ** -8 * rstd * (gw + xhat * (gw * xhat).mean(-1, keepdim=True))


def _rms_bwd_errors(got, want, floor, label):
    """(dx, dw) of the RMS backward against the reference's: float32
    within 1e-5 of each gradient's largest value; bfloat16 dw at most one
    step apart per element (a float32 sum rounded once, in another
    order), and so dx, but within one step of the larger of the element
    and ``floor`` (``_rms_bwd_floor``).  Raises past a limit; returns
    (max |err| of dx, its share of differing elements, the same of
    dw)."""
    out = []
    for g, r, fl, name in zip(got, want, (floor, None), ("dx", "dw")):
        diff = (g.float() - r.float()).abs()
        if g.dtype == torch.bfloat16:
            scale = torch.maximum(g.float().abs(), r.float().abs())
            if fl is not None:
                scale = torch.maximum(scale, fl)
            ok = bool((diff <= _bf16_step(scale)).all())
        else:
            ok = diff.max().item() <= 1e-5 * r.float().abs().max().item()
        if not ok:
            raise AssertionError(f"{label} {name} {g.dtype} "
                                 f"{tuple(g.shape)}: max abs err "
                                 f"{diff.max().item()}")
        out += [diff.max().item(), (diff > 0).float().mean().item()]
    return out


def rms_backward_check(fnr, x, w, g, policy):
    """``rms_norm`` under autograd on the card (the forward and backward
    kernels, one launch each) against the same call on the CPU (the
    plain forward and backward) on the same inputs, under
    ``_rms_bwd_errors``' rule, whose four numbers it returns: the
    "llama" dx within one step of the larger of the element and
    ``_rms_bwd_floor``, the "fused" dx within one step of the element."""
    before = dict(fnr.LAUNCHES)
    grads = []
    for dev in ("cuda", "cpu"):
        xx, ww = (t.detach().to(dev).requires_grad_(True) for t in (x, w))
        fnr.rms_norm(xx, ww, 1e-6, policy)[0].backward(g.to(dev))
        grads.append((xx.grad.cpu(), ww.grad.cpu()))
    launched = {k: fnr.LAUNCHES[k] - before[k] for k in before}
    if launched != {k: int(k in (policy, f"bwd_{policy}")) for k in before}:
        raise AssertionError(f"rms_norm under autograd launched {launched}, "
                             f"want its forward and backward kernels once")
    floor = (_rms_bwd_floor(x.cpu(), w.cpu(), g.cpu(), policy)
             if policy == "llama" else None)
    return _rms_bwd_errors(grads[0], grads[1], floor,
                           f"rms_norm {policy} backward, card vs CPU")


def add_rms_check(fnr, h, delta, w, g, g_s, policy, eps=1e-6):
    """The fused residual-add instance on the card against the kernels it
    fuses: s bit for bit ``h + delta`` (torch's add), out bit for bit
    ``rms_norm`` of that s; and its backward (``rms_norm_bwd`` with the
    residual's cotangent g_s) bit for bit T(dx + g_s) and the same dw,
    dx and dw from the backward kernel without g_s.  Under autograd h
    and delta receive that ds.  Raises past a limit."""
    s, out = fnr.add_rms_norm(h, delta, w, eps, policy)
    want_s = h + delta
    want_out, rstd = fnr.rms_norm(want_s, w, eps, policy)
    dx, dw = fnr.rms_norm_bwd(want_s, w, g, eps, policy, rstd)
    ds, dw_s = fnr.rms_norm_bwd(want_s, w, g, eps, policy, rstd, g_s)
    hh, dd, ww = (t.detach().requires_grad_(True) for t in (h, delta, w))
    s2, out2 = fnr.add_rms_norm(hh, dd, ww, eps, policy)
    torch.autograd.backward([s2, out2], [g_s, g])
    checks = {"s": (s, want_s), "out": (out, want_out),
              "ds": (ds, dx + g_s), "dw": (dw_s, dw),
              "autograd_out": (out2, want_out), "autograd_dh": (hh.grad, ds),
              "autograd_ddelta": (dd.grad, ds), "autograd_dw": (ww.grad, dw)}
    for name, (a, b) in checks.items():
        if not torch.equal(a, b):
            raise AssertionError(
                f"add_rms_norm {policy} {a.dtype} {tuple(a.shape)}: {name} "
                f"not bit for bit, max abs diff "
                f"{(a.float() - b.float()).abs().max().item()}")


def llama_train_phase(llama, hybrid, TrainLoop, fa, fnr):
    """llama_7b at full width, depth cut to LLAMA_TRAIN_LAYERS, bf16,
    seed-0 weights, through ``build_train_step(model=llama_stage_model)``
    with float32 AdamW moments: B 4, S 2048, one seeded batch, one warm
    step then 4 under ``TrainLoop(max_inflight=2)`` (every loss finite,
    step 5 below step 1, launches exact, counts reset just before); step
    ms, tokens/s, peak memory, a one-step profile by family and the
    optimizer alone by CUDA events; one ``remat=True`` step; the RMS
    "llama" backward at [B*S, H] against the plain version's autograd.
    First, at the init, the kernel route's loss and gradients against
    the plain compositions' (``use_flash=False``) on one sequence.
    Returns (row, (cfg, params, ids, labels)) for the sequence-parallel
    check."""
    cfg = llama.llama_7b(num_layers=LLAMA_TRAIN_LAYERS, dtype=torch.bfloat16)
    B, S, L = LLAMA_TRAIN_B, LLAMA_TRAIN_S, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, shard, init_opt = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=False))
    params = shard(llama.init_params(cfg, seed=0, device="cuda"))
    ids, labels = _train_batch(cfg, B, S)
    torch.cuda.synchronize()
    _log({"phase": "llama_training_setup", "config": "llama_7b bf16, "
          f"{L} of 32 layers", "params": llama.param_count(params),
          "init_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    # the kernel route against the plain compositions (use_flash=False:
    # the masked softmax, which rounds P to bf16, and rms_norm_plain) at
    # the seed-0 init on the batch's first sequence: loss within
    # LOSS_TOL, each gradient leaf within PLAIN_GRAD_REL in norm
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    step_p, _, _ = hybrid.build_train_step(
        plain_cfg, device="cuda",
        model=hybrid.llama_stage_model(plain_cfg, remat=False))
    lf, gf = step.loss_and_grads(params, ids[:1], labels[:1])
    fa.reset_launches()
    fnr.reset_launches()
    lp, gp = step_p.loss_and_grads(params, ids[:1], labels[:1])
    plain_launches = _llama_train_counts(fa, fnr)
    grad_rel = {name: ((a.float() - b.float()).norm()
                       / b.float().norm()).item()
                for (name, a), (_, b) in zip(_named_leaves(gf),
                                             _named_leaves(gp))}
    route = {"phase": "llama_training_plain_route",
             "shape": f"B=1 S={S} (the batch's first sequence)",
             "loss_kernels": lf.item(), "loss_plain": lp.item(),
             "grad_rel_diff": grad_rel, "plain_launches": plain_launches,
             "loss_atol": LOSS_TOL, "grad_rel_tol": PLAIN_GRAD_REL}
    _log(route)
    del gf, gp
    if any(plain_launches.values()) \
            or not abs(lf.item() - lp.item()) <= LOSS_TOL \
            or not max(grad_rel.values()) <= PLAIN_GRAD_REL:
        raise AssertionError(f"llama_7b training, kernel vs plain route: "
                             f"{route}")
    opt = init_opt(params)
    first, params, opt = step(params, opt, ids, labels)      # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    fnr.reset_launches()
    t0 = time.perf_counter()
    loop = TrainLoop(step, max_inflight=2)
    handles = []
    for _ in range(4):
        d, params, opt = loop.step(params, opt, ids, labels)
        handles.append(d)
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _llama_train_counts(fa, fnr)
    losses = [first.item()] + [float(d) for d in handles]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"llama training losses {losses}")
    if launches != _llama_train_want(L, 4, False):
        raise AssertionError(f"llama training launches {launches} != "
                             f"{_llama_train_want(L, 4, False)}")
    step_ms = wall / 4 * 1e3
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(params, opt, ids, labels)

    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(one_step, 1, wall_ms, list(LLAMA_FLASH_FAMILIES),
                    top_n=24)
    # the optimizer alone, on gradients at these params (CUDA events):
    # its kernels are elementwise ones that the profile files under other
    _, grads = step.loss_and_grads(params, ids, labels)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    hybrid.adamw_update(params, grads, opt, hybrid.AdamWConfig())
    b.record()
    torch.cuda.synchronize()
    opt_ms = a.elapsed_time(b)
    del grads
    dev = dict(prof["device_ms"])
    dev["optimizer"] = opt_ms
    dev["other"] = dev["other"] - opt_ms
    row = {"phase": "llama_training",
           "config": f"llama_7b bf16, {L} of 32 layers (depth cut), seed 0",
           "B": B, "S": S, "remat": False, "moments": "float32",
           "plain_route": {k: route[k] for k in (
               "loss_kernels", "loss_plain")},
           "plain_route_grad_rel_max": max(grad_rel.values()),
           "losses": losses, "launches_4_steps": launches,
           "step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3),
           "stall_s": loop.stall_seconds, "peak_memory_bytes": peak,
           "profiled_step_wall_ms": wall_ms, **prof,
           "device_ms_by_family": dev, "adamw_update_ms": opt_ms}
    _log(row)
    # one remat=True step from these params
    step_r, _, _ = hybrid.build_train_step(
        cfg, device="cuda", model=hybrid.llama_stage_model(cfg, remat=True))
    fa.reset_launches()
    fnr.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rl, params, opt = step_r(params, opt, ids, labels)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    remat_launches = _llama_train_counts(fa, fnr)
    rl = rl.item()
    if remat_launches != _llama_train_want(L, 1, True) \
            or not np.isfinite(rl):
        raise AssertionError(f"llama remat step: launches {remat_launches}, "
                             f"loss {rl}")
    row["remat_step"] = {
        "loss": rl, "ms": remat_ms, "launches": remat_launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del opt
    torch.cuda.empty_cache()
    # the RMS "llama" backward at the path's rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x, g = (torch.randn((B * S, cfg.hidden_size), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn((cfg.hidden_size,), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    dx_err, dx_share, dw_err, dw_share = rms_backward_check(fnr, x, w, g,
                                                            "llama")

    def fwd_bwd(fn):
        xx, ww = x.detach().requires_grad_(True), w.detach().requires_grad_(
            True)
        fn(xx, ww, 1e-6, "llama")[0].backward(g)

    row["rms_llama_backward"] = {
        "shape": f"[{B * S}, {cfg.hidden_size}] bfloat16",
        "dx_max_abs_err": dx_err, "dx_share_differing": dx_share,
        "dw_max_abs_err": dw_err, "dw_share_differing": dw_share,
        "reference": "the same call on the CPU",
        "rule": "dw one bf16 step per element; dx one step of max(|dx|, "
                "2 |g w rstd|)",
        # forward and backward under autograd: both kernels against the
        # plain forward under torch's autograd; then the backward alone
        "kernel_fwd_bwd_ms": _time_ms(lambda: fwd_bwd(fnr.rms_norm)),
        "plain_autograd_ms": _time_ms(lambda: fwd_bwd(fnr.rms_norm_plain)),
        "kernel_bwd_ms": _time_ms(lambda: fnr.rms_norm_bwd(
            x, w, g, 1e-6, "llama")),
        "plain_bwd_ms": _time_ms(lambda: fnr.rms_norm_bwd_plain(
            x, w, g, 1e-6, "llama"))}
    _log({"phase": "llama_training_remat_and_rms_backward",
          "remat_step": row["remat_step"],
          "rms_llama_backward": row["rms_llama_backward"]})
    del x, g, w
    return row, (cfg, params, ids, labels)


def llama_sp_phase(llama, fa, cfg, params, ids, labels):
    """The sequence-parallel loss of the training config on a one-rank
    NCCL group (``llama_sp_check``); the offset kernels' launches there
    are the kernels line's."""
    row = llama_sp_check(llama, fa, cfg, params, ids, labels)
    row.update(phase="llama_sp", config=f"llama_7b bf16, "
               f"{cfg.num_layers} of 32 layers, B {ids.shape[0]}, "
               f"S {ids.shape[1]}, one-rank NCCL group")
    _log(row)
    return row


# -- seeded sampling: the sampler kernel and the sampled engines -----------

# H100 SXM, 132 SMs at the 1.98 GHz behind the 67 TFLOP/s float32
# figure.  An SM issues one warp instruction a clock in each of its four
# sub-partitions (128 thread instructions), and its pipes take, a clock:
# ALU 64 (logic, shifts, compares, selects, integer adds), FMA-heavy 64
# (IMAD, float32), FMA-lite 64 (float32), XU 16 (MUFU, conversions).
# IADD3 and VIADD are integer adds that the compiler may place on the ALU
# or, as IMAD.IADD, on FMA-heavy: both count as either.
SM_CLOCKS_PER_S = 132 * 1.98e9
SASS_PIPES = {
    "alu": {"LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP", "FSETP",
            "SEL", "FSEL", "FMNMX", "IMNMX", "VIMNMX", "PRMT", "PLOP3",
            "MOV", "IABS", "I2FP", "F2FP", "P2R", "R2P", "BMSK", "SGXT"},
    "int_add": {"IADD3", "VIADD", "IADD"},
    "fma_heavy": {"IMAD", "IMUL"},
    "fp32": {"FADD", "FMUL", "FFMA"},
    "xu": {"MUFU", "I2F", "F2I", "FRND", "POPC", "FLO", "BREV"},
}
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)[^;]*?(?:\s(0x[0-9a-f]+))?\s*;")
SAMPLE_TIE = 2e-6          # perturbed scores closer than this: a near-tie
SAMPLE_SERVE = dict(temperature=0.8, top_k=20, top_p=0.95)
# the settings the kernel is held at: the serving one, temperature alone
# (the draw over every logit), top-p alone, top-k alone, top-k at or
# above V (no top-k), top-p 1e-6 (the maximum alone)
SAMPLINGS = (("t0.8 k20 p0.95", SAMPLE_SERVE), ("t1.0", dict(temperature=1.0)),
             ("t0.7 p0.9", dict(temperature=0.7, top_p=0.9)),
             ("t1.3 k50", dict(temperature=1.3, top_k=50)),
             ("t0.9 k>=V p0.95", dict(temperature=0.9, top_k=1 << 20,
                                      top_p=0.95)),
             ("t0.8 k20 p1e-6", dict(temperature=0.8, top_k=20, top_p=1e-6)))
# (name, rows, V, rule): an 8-slot decode step (engines' rule), a k 3
# verify pass (8 slots x 4 window rows), LLaMA generate (B 4, V 32000)
# and GPT generate (B 8), both one key for the whole draw
SAMPLE_CASES = (("decode", 8, 50304, "pos"), ("verify", 32, 50304, "window"),
                ("llama_generate", 4, 32000, "key"),
                ("generate", 8, 50304, "key"))
SAMPLE_REPS = 10           # x 6 samplings x 52 rows = 3120 rows
TOK_S_PAIRS = 4            # greedy / sampled serving runs in turns
SAMPLE_FAMILIES = (("sampling", ("sampling",)),) + DECODE_FAMILIES
# kernels of the torch filter that the sampled step must no longer run
FILTER_KERNELS = ("topk", "sort", "cumsum", "softmax", "scan")


def _samp(kw):
    return kw["temperature"], kw.get("top_k", 0), kw.get("top_p", 1.0)


def _sample_args(prng, rule, R, gen, rep, dev="cuda"):
    """The keying of one draw of R rows: one key of a split (generate
    rule), or seeds (the whole int32 range) and positions (0..1023) for
    each slot, 4 window rows a slot for the verify."""
    if rule == "key":
        return {"key": prng.split(prng.PRNGKey(1000 + rep, dev), 3)[rep % 3]}
    W = 4 if rule == "window" else 1
    B = R // W
    return {"seeds": torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen,
                                   device=dev, dtype=torch.int32),
            "pos": torch.randint(0, 1024, (B,), generator=gen, device=dev,
                                 dtype=torch.int32),
            "window": W}


def _topp_gap(sm, row, t, kth, p, n_float, n_exact):
    """A top-p near-tie: the row's float64 cumulative softmax mass over
    its descending values at or above ``kth``, at the indices between
    the float rule's and the exact rule's cuts (kept counts ``n_float``,
    ``n_exact``), lies within n 2^-24 of float32 ``p`` (n: the values
    summed).  Returns (is a near-tie, the smallest gap)."""
    x = sm.apply_cuts(row[None], t, kth[None], torch.full_like(kth[None],
                                                              float("-inf")))
    desc = torch.sort(x[0][torch.isfinite(x[0])].double(),
                      descending=True).values
    e = torch.exp(desc - desc[0])
    gap = (torch.cumsum(e, 0) / e.sum() - float(np.float32(p))).abs()
    lo, hi = min(n_float, n_exact) - 1, max(n_float, n_exact)
    n = torch.arange(1, desc.numel() + 1, device=desc.device,
                     dtype=torch.float64)
    ok = bool((gap[lo:hi] <= n[lo:hi] * 2.0 ** -24).any())
    return ok, float(gap[lo:hi].min()) if hi > lo else 0.0


def sampling_check(sm, logits, args, kw):
    """The sampler kernel (``sample_rows`` on raw logits) against its
    plain version on the same logits and keys.  The kernel keeps what
    ``cut_values_plain`` (exact counts and fixed-point masses) keeps:
    where that differs from the float filter (``filter_logits_plain``),
    the float rule's cumulative mass at the cut must lie within n 2^-24
    of top_p (a top-p near-tie, counted).  The kernel's token is the
    plain draw over the exact rule's kept values, or a draw near-tie:
    the two tokens' perturbed scores within ``SAMPLE_TIE`` (counted);
    never a dropped value unless the whole row is -inf.  Returns the
    rows, both near-tie counts, the largest margin (0 when every token
    is equal) and the rows equal to the plain version's token."""
    t, k, p = _samp(kw)
    got = sm.sample_rows(logits, t, k, p, **args)
    want = sm.sample_rows_plain(logits, t, k, p, **args)
    kth, cut = sm.cut_values_plain(logits, t, k, p)
    exact = sm.apply_cuts(logits, t, kth, cut)
    filt = sm.filter_logits_plain(logits, t, k, p)
    same = (exact == filt) | (torch.isnan(exact) & torch.isnan(filt))
    topp, gaps = 0, []
    for r in torch.nonzero(~same.all(-1)).flatten().tolist():
        n_f = int(torch.isfinite(filt[r]).sum())
        n_e = int(torch.isfinite(exact[r]).sum())
        ok, gap = _topp_gap(sm, logits[r], t, kth[r], p, n_f, n_e)
        if not (p < 1.0 and ok):
            raise AssertionError(
                f"sampler row {r} ({kw}): the exact rule keeps {n_e} "
                f"values, the float filter {n_f}, mass gap {gap}")
        topp += 1
        gaps.append(gap)
    ref = sm.gumbel_argmax_plain(exact, **args)
    scores = sm.perturbed_scores(exact, **args)
    rows = torch.arange(logits.shape[0], device=logits.device)
    margin = torch.where(got == ref, 0.0, (
        scores[rows, ref.long()] - scores[rows, got.long()]).abs())
    worst = margin.max().item()
    if not worst < SAMPLE_TIE:
        r = int(margin.argmax())
        raise AssertionError(
            f"sampler row {r} ({kw}): kernel token {int(got[r])}, plain "
            f"{int(ref[r])}, perturbed scores {margin[r].item()} apart "
            f"(a near-tie is < {SAMPLE_TIE})")
    dead = torch.isneginf(exact[rows, got.long()]) & \
        ~torch.isneginf(exact).all(dim=-1)
    if dead.any():
        raise AssertionError(f"sampler drew a dropped logit in rows "
                             f"{dead.nonzero().flatten().tolist()}")
    return {"rows": int(logits.shape[0]),
            "near_ties": int((got != ref).sum()), "topp_near_ties": topp,
            "topp_min_gap": min(gaps) if gaps else None,
            "max_margin": worst, "equal_plain": int((got == want).sum())}


def sampling_edge_check(sm, prng, dev="cuda"):
    """Rows the random cases never build, kernel and plain alike.  The
    draw alone (temperature 1): one finite logit among -inf (drawn), a
    whole -inf row (index 0), +inf at two indices (the first), NaN at
    two (the first, as argmax treats NaN), and two equal finite
    perturbed scores (the first).  The finite tie holds under any log:
    its two indices are two whose uniforms are the same float32 (a row
    of 50304 has ~150 such pairs on the 2^23-point grid), so their
    noise is the same whatever log computes it; both get logit 0.5,
    every other logit is -inf.  Row 4 takes its first such pair, row 5
    the pair farthest apart (so the two lie in different blocks of the
    draw).  Then the filter's edge rows under top-k and top-p (NaN,
    +inf, -0 and +0 tied at the k-th value, ties at the k-th value, an
    all -inf row, all values equal): the kernel's token equals the
    plain version's exactly."""
    V = 50304
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    logits = torch.full((6, V), float("-inf"), device=dev)
    logits[0, 31337] = 0.5
    logits[2, 7], logits[2, 4000] = float("inf"), float("inf")
    logits[3] = torch.randn(V, generator=gen, device=dev)
    logits[3, 90], logits[3, 12] = float("nan"), float("nan")
    seeds = torch.tensor([3, -1, 5, 6, 7, 2 ** 31 - 1], dtype=torch.int32,
                         device=dev)
    pos = torch.tensor([0, 1, 2, 3, 4, 1023], dtype=torch.int32, device=dev)
    args = {"seeds": seeds, "pos": pos, "window": 1}
    u = prng.uniform(prng.fold_in(prng.PRNGKey(seeds[4:]), pos[4:]), (V,),
                     prng.TINY, 1.0)
    want = [31337, 0, 7, 12]
    for r in (4, 5):
        vals, order = torch.sort(u[r - 4], stable=True)
        same = torch.nonzero(vals[1:] == vals[:-1]).flatten()
        pairs = [sorted((int(order[i]), int(order[i + 1]))) for i in same]
        a, b = (min(pairs) if r == 4 else
                max(pairs, key=lambda p: p[1] - p[0]))
        logits[r, a] = logits[r, b] = 0.5
        want.append(a)
    got = sm.gumbel_argmax(logits, **args).tolist()
    plain = sm.gumbel_argmax_plain(logits, **args).tolist()
    if plain != want:
        raise AssertionError(f"sampler edge rows: plain {plain}, want {want}")
    report = sampling_check(sm, logits, args, dict(temperature=1.0))
    if got != want:
        raise AssertionError(f"sampler edge rows: kernel {got}, want {want}")
    rows = torch.randn(6, V, generator=gen, device=dev) * 2
    rows[0, [3, 40000]] = float("nan")
    rows[1, [2, 9000]] = float("inf")
    rows[2] = -torch.rand(V, generator=gen, device=dev) - 0.5
    rows[2, 100:130:2], rows[2, 101:131:2] = -0.0, 0.0
    rows[2, [5, 50000]] = 1.0
    rows[3] = float("-inf")
    rows[4, [1, 2, 3, 30000, 50303]] = 9.0
    rows[4, 4] = 10.0
    rows[5] = 0.25
    filt = {}
    for kw in (SAMPLE_SERVE, dict(temperature=1.0, top_k=3),
               dict(temperature=1.0, top_k=8, top_p=0.5),
               dict(temperature=0.5, top_p=0.9)):
        args = {"seeds": seeds, "pos": pos, "window": 1}
        t, k, p = _samp(kw)
        k_got = sm.sample_rows(rows, t, k, p, **args).tolist()
        k_want = sm.sample_rows_plain(rows, t, k, p, **args).tolist()
        r = sampling_check(sm, rows, args, kw)
        if k_got != k_want or r["topp_near_ties"]:
            raise AssertionError(f"sampler filter edge rows {kw}: kernel "
                                 f"{k_got}, plain {k_want}, {r}")
        filt[str(kw)] = k_got
    return {"kernel": got, "want": want, **report, "filter_rows": filt}


def sampling_rows_alone_check(sm, dev="cuda"):
    """A row's token does not depend on the rows drawn with it: at R 8,
    32 (4 window rows a slot) and 64, V 50304 and 32000, under the
    serving setting and top-p alone, every row drawn alone (R 1, its
    seed and position) gives the token it got among the others, bit
    for bit (exact counts and masses, whatever the plan)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    plans, rows = {}, 0
    for V in (50304, 32000):
        for R, W in ((8, 1), (32, 4), (64, 1)):
            logits = torch.randn(R, V, generator=gen, device=dev) * 3
            B = R // W
            seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=gen,
                                  device=dev, dtype=torch.int32)
            pos = torch.randint(0, 1024, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
            one_pos = (pos[:, None] + torch.arange(W, device=dev,
                                                   dtype=torch.int32))
            for kw in (SAMPLE_SERVE, dict(temperature=0.7, top_p=0.9)):
                t, k, p = _samp(kw)
                many = sm.sample_rows(logits, t, k, p, seeds=seeds, pos=pos,
                                      window=W)
                alone = torch.cat([sm.sample_rows(
                    logits[r:r + 1], t, k, p, seeds=seeds[r // W:r // W + 1],
                    pos=one_pos.reshape(-1)[r:r + 1]) for r in range(R)])
                if not torch.equal(many, alone):
                    bad = torch.nonzero(many != alone).flatten().tolist()
                    raise AssertionError(f"sampler rows {bad} of R {R} V {V} "
                                         f"{kw} moved with R")
                rows += R
            plans[f"R {R} V {V}"] = sm.sampling_plan(
                R, V, sm.device_fits(logits.device, V), SAMPLE_SERVE["top_k"])
    plans["R 1 V 50304"] = sm.sampling_plan(
        1, 50304, sm.device_fits(torch.device(dev), 50304),
        SAMPLE_SERVE["top_k"])
    return {"rows": rows, "plans": plans}


def sass_loops(lib, kernel):
    """The loops of ``kernel``'s SASS in the built library
    (``cuobjdump -sass``): for each backward branch, its body's address
    range and full mnemonics (opcode with its modifiers) in order."""
    from paddle_tpu_torch.incubate.nn.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    body = sass.split(kernel, 1)[1].split("Function :", 1)[0]
    code = [(int(m[1], 16), m[2], m[3]) for m in _SASS_LINE.finditer(body)]
    return [{"start": int(to, 16), "end": at,
             "ops": [op for a, op, _ in code if int(to, 16) <= a <= at]}
            for at, op, to in code
            if op.split(".")[0] == "BRA" and to and int(to, 16) < at]


def _loop_clocks(ops):
    """The fewest SM clocks one element of a loop body needs: its
    instructions over the 128 issue slots, or a pipe's (or pair of
    pipes') load over its lanes, whichever binds; an element is a
    32-bit shared-memory load of the body (``LDS``: the slice's value;
    the 64-bit ones are histogram bins)."""
    trips = max(1, ops.count("LDS"))
    pipes = {p: 0 for p in (*SASS_PIPES, "other")}
    for op in ops:
        base = op.split(".")[0]
        pipes[next((p for p, names in SASS_PIPES.items() if base in names),
                   "other")] += 1
    a, x, m = pipes["alu"], pipes["int_add"], pipes["fma_heavy"]
    f, u = pipes["fp32"], pipes["xu"]
    clocks = {"issue": len(ops) / 128, "alu": a / 64, "fma_heavy": m / 64,
              "alu+fma_heavy": (a + x + m) / 128, "fma": (m + f) / 128,
              "alu+fma": (a + x + m + f) / 192, "xu": u / 16}
    binds = max(clocks, key=clocks.get)
    return {"instructions": len(ops) / trips, "elements": trips,
            "pipes": {k: v / trips for k, v in pipes.items()},
            "binds": binds, "clocks_an_element": clocks[binds] / trips}


def _has(ops, *prefixes):
    return any(op.startswith(prefixes) for op in ops)


# each loop of the sampler kernel over the slice, told apart by what
# its body issues: the division in place (the division's MUFU.RCP, the
# slice stored back; under top-k it also builds the first count pass),
# a count pass (shared atomics), the gather of the
# candidates (shared atomics and stores into rank 0's shared memory
# through a generic address), a mass pass (expf's MUFU.EX2 and shared
# atomics), the draw (threefry's funnel-shift rotates)
SAMPLER_LOOPS = (
    ("divide", lambda ops: "MUFU.RCP" in ops and _has(ops, "STS")),
    ("count", lambda ops: _has(ops, "ATOMS")
     and not _has(ops, "ST.E", "MUFU.EX2", "MUFU.RCP", "SHF.L.W")),
    ("gather", lambda ops: _has(ops, "ATOMS") and _has(ops, "ST.E")),
    ("mass", lambda ops: "MUFU.EX2" in ops and _has(ops, "ATOMS")),
    ("draw", lambda ops: _has(ops, "SHF.L.W")))


def sampler_sass(lib):
    """Per-element SM clocks of the sampler kernel's loops over the
    slice: of the loops whose body matches (``SAMPLER_LOOPS``) and holds
    a slice load, those that hold no other such loop, and of those the
    most instructions an element (a loop that only encloses another
    matching one elsewhere counts its whole body over many loads).  A
    loop not found is listed under "missing" and adds nothing to the
    bound (which stays a least time)."""
    loops = [lp for lp in sass_loops(lib, "sampling_filter_draw_kernel")
             if "LDS" in lp["ops"]]
    out, missing = {}, []
    for name, match in SAMPLER_LOOPS:
        hits = [lp for lp in loops if match(lp["ops"])]
        inner = [lp for lp in hits if not any(
            o is not lp and lp["start"] <= o["start"] and o["end"] <= lp["end"]
            for o in hits)]
        if inner:
            out[name] = max((_loop_clocks(lp["ops"]) for lp in inner),
                            key=lambda c: c["instructions"])
        else:
            missing.append(name)
    return {"loops": out, "missing": missing}


def sampler_bound(sm, logits, kw, rule, sass):
    """The least time of one draw: bytes (logits read once, tokens
    written, keys read) at 3.35 TB/s against the SM clocks of the work
    the function needs on this draw's data, on every SM at 1.98 GHz.
    The work, in clocks an element of :func:`sampler_sass`: a logit's
    division, key and histogram step (the kernel's division loop); under
    a filter, one compare a logit (an ALU instruction) to pick the
    candidates; under top-p, a value's mass (the mass loop: ``expf`` and
    a histogram step) for each value not below the k-th; the draw
    (threefry and the two logs) for each kept value.  The kernel's own
    extra passes (its second count pass, the gather, the radix select's
    repeated mass passes) are its algorithm's cost, not the function's,
    and are left out."""
    R, V = logits.shape
    t, k, p = _samp(kw)
    kth, cut = sm.cut_values_plain(logits, t, k, p)
    x = sm.apply_cuts(logits, t, kth, torch.full_like(cut, float("-inf")))
    in_play = int(torch.isfinite(x).sum())
    kept = int(torch.isfinite(sm.apply_cuts(logits, t, kth, cut)).sum())
    c = {n: sass["loops"].get(n, {}).get("clocks_an_element", 0.0)
         for n, _ in SAMPLER_LOOPS}
    clocks = R * V * c["divide"] + kept * c["draw"]
    if 0 < k < V or p < 1.0:
        clocks += R * V / 64
    if p < 1.0:
        clocks += in_play * c["mass"]
    keys = 16 if rule == "key" else 8 * (R // (4 if rule == "window"
                                              else 1))
    nbytes = R * V * 4 + R * 4 + keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = clocks / SM_CLOCKS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "sm_clocks": clocks, "kept": kept,
            "in_play": in_play}


def sampling_kernel_phase(sm, decoding, prng, lib):
    """The sampler kernel on the card against its plain version: at each
    case of ``SAMPLE_CASES``, ``SAMPLE_REPS`` times with fresh raw
    logits (N(0, 9)) and keys, under every setting of ``SAMPLINGS``
    (:func:`sampling_check`: draw and top-p near-ties counted apart);
    then the edge rows; then rows drawn alone against the same rows in
    R 8 / 32 / 64; then each case's kernel time over rotating copies of
    the logits (64 MB or more, as a decode step finds them after the
    head) under the serving setting and temperature alone, the plain
    version's (the torch filter and the prng composition) and
    ``torch.argmax`` over the same [R, V] (a reading floor: no PyTorch
    call draws JAX's stream), with the bound (:func:`sampler_bound`)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    agg = {}
    sm.reset_launches()
    checks = 0
    for rep in range(SAMPLE_REPS):
        for name, R, V, rule in SAMPLE_CASES:
            logits = torch.randn(R, V, generator=gen, device="cuda") * 3
            args = _sample_args(prng, rule, R, gen, rep)
            for label, kw in SAMPLINGS:
                r = sampling_check(sm, logits, args, kw)
                checks += 1
                a = agg.setdefault((name, label), {
                    "rows": 0, "near_ties": 0, "topp_near_ties": 0,
                    "max_margin": 0.0, "equal_plain": 0})
                for key in ("rows", "near_ties", "topp_near_ties",
                            "equal_plain"):
                    a[key] += r[key]
                a["max_margin"] = max(a["max_margin"], r["max_margin"])
    torch.cuda.synchronize()
    if sm.LAUNCHES != checks:
        raise AssertionError(f"sampler launches {sm.LAUNCHES} != {checks}")
    edge = sampling_edge_check(sm, prng)
    alone = sampling_rows_alone_check(sm)
    sass = sampler_sass(lib)
    out = {"checks": {f"{n} {lbl}": a for (n, lbl), a in agg.items()},
           "sass": sass,
           "rows": sum(a["rows"] for a in agg.values()),
           "near_ties": sum(a["near_ties"] for a in agg.values()),
           "topp_near_ties": sum(a["topp_near_ties"] for a in agg.values()),
           "max_margin": max(a["max_margin"] for a in agg.values()),
           "edge": edge, "rows_alone": alone, "cases": {}}
    for name, R, V, rule in SAMPLE_CASES:
        copies = max(2, -(-64 * 2 ** 20 // (R * V * 4)))
        logits = [torch.randn(R, V, generator=gen, device="cuda") * 3
                  for _ in range(copies)]
        args = _sample_args(prng, rule, R, gen, 0)
        row = {"name": name, "shape": f"[{R}, {V}] f32, {rule} rule",
               "plan": sm.sampling_plan(R, V, sm.device_fits(
                   logits[0].device, V), SAMPLE_SERVE["top_k"]),
               "argmax_ms": _time_rotating([
                   lambda x=x: torch.argmax(x, dim=-1) for x in logits],
                   reps=60),
               "library_ms": None,
               "max_abs_err": max(a["max_margin"] for (n, _), a in agg.items()
                                  if n == name)}
        for label, kw in SAMPLINGS[:2]:
            t, k, p = _samp(kw)
            ms = _time_rotating([lambda x=x: sm.sample_rows(
                x, t, k, p, **args) for x in logits], reps=60)
            plain_ms = _time_ms(lambda: sm.sample_rows_plain(
                logits[0], t, k, p, **args), reps=10)
            b = sampler_bound(sm, logits[0], kw, rule, sass)
            row[label] = {"kernel_ms": ms, "plain_ms": plain_ms, **b,
                          "bound_share": b["bound_ms"] / ms}
        out["cases"][name] = row
        del logits
    _log({"phase": "sampling_kernel", **out})
    return out


def _seq_logits(gpt, params, cfg, seq, dev):
    """Last-position float32 logits [V] of ``seq`` through ``gpt.prefill``
    on ``dev`` (dense or int8 weights)."""
    cache = gpt.init_decode_cache(cfg, 1, len(seq), device=dev)
    with torch.inference_mode():
        logits, _, _ = gpt.prefill(params, torch.tensor(
            np.asarray(seq)[None], device=dev), cfg, cache)
    return logits[0].float()


def _stream_tie(gpt, decoding, prng, models, cfg, prompt, seed, got, want,
                samp):
    """Where two sampled streams of one request first differ: the
    position, both tokens, and their perturbed scores' margin under the
    request's key at that position, from prefill logits of the common
    prefix on the card and on the CPU (``models``: {device: params}),
    with the two logit tokens' card/CPU |delta|.  A near-tie when the
    smaller margin is below ``SAMPLE_TIE`` plus that delta."""
    t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(map(int, prompt)) + list(map(int, want[:t]))
    a, b = int(got[t]), int(want[t])
    margins, logits = {}, {}
    for dev, params in models.items():
        lg = _seq_logits(gpt, params, cfg, seq, dev)
        filt = decoding._filter_logits(lg[None], samp["temperature"],
                                       samp.get("top_k", 0),
                                       samp.get("top_p", 1.0))[0]
        key = prng.fold_in(prng.PRNGKey(seed, dev), len(seq) - 1)
        s = filt + prng.gumbel(key, filt.shape)
        margins[dev] = abs((s[a] - s[b]).item())
        logits[dev] = lg[[a, b]].cpu()
    delta = (logits["cuda"] - logits["cpu"]).abs().max().item()
    margin = min(margins.values())
    return {"index": t, "position": len(seq) - 1, "tokens": [a, b],
            "margin": margin, "margins": margins, "logit_delta": delta,
            "near_tie": margin < SAMPLE_TIE + delta}


def sampled_reference_phase(gpt, decoding, prng, engines, Spec, sm):
    """Sampled serving (``SAMPLE_SERVE``) on the card against the CPU:
    gpt_tiny f32 (seed 1) on the contiguous and paged engines (18 pages
    of 8 rows: admissions defer, slots are evicted) and the tiny bf16
    int8-weight model on the fused engine, each with steps_per_sync 1
    and 8 and speculative k 3 with n-gram and a model draft (the target
    itself; the fused engine a small GPT).  Requests carry seeds 1..5.
    Every stream, card and CPU, must equal the CPU plain run at
    steps_per_sync 8 of its engine, or first differ at a near-tie
    (``_stream_tie``, reported); each card run launches the sampler once
    a decode step and a verify pass (count reset before the run) and
    never falls back."""
    Engine, PagedEngine, FusedEngine = engines
    f32 = torch.float32
    cfg = gpt.gpt_tiny(dtype=f32, use_flash=False)
    target = gpt.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)), m, i + 1)
            for i, (n, m) in enumerate(SPEC_REQS)]
    fcfg = gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                         num_heads=2, max_position_embeddings=64,
                         dtype=torch.bfloat16, use_flash=False)
    fq = gpt.quantize_decode_params(gpt.init_params(fcfg, seed=0,
                                                    device="cpu"), fcfg)
    fdcfg = gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                          num_heads=2, max_position_embeddings=64,
                          dtype=f32, use_flash=False)
    fdraft = Spec(k=SPEC_K, draft_params=gpt.init_params(
        fdcfg, seed=2, device="cpu"), draft_cfg=fdcfg)
    frng = np.random.default_rng(1)
    freqs = [(frng.integers(1, 128, (n,)), 8, i + 1)
             for i, n in enumerate((5, 9, 12))]
    variants = (("plain 1", 1, None), ("plain 8", 8, None),
                ("ngram", 8, "ngram"), ("model", 8, "model"))
    streams, rows, ties = {}, [], []
    for kind in ("contiguous", "paged", "fused"):
        fused = kind == "fused"
        rs = freqs if fused else reqs
        for label, steps, draft in variants:
            spec = None if draft is None else True if draft == "ngram" \
                else fdraft if fused else Spec(k=SPEC_K, draft_params=target,
                                               draft_cfg=cfg)
            for dev in ("cpu", "cuda"):
                kw = dict(device=dev, attn_kernel="flash" if dev == "cuda"
                          else "xla", speculative=_spec_on(spec, dev),
                          **SAMPLE_SERVE)
                if fused:
                    eng = FusedEngine(_to_device(fq, dev), fcfg, max_len=64,
                                      **kw)
                elif kind == "paged":
                    eng = PagedEngine(_to_device(target, dev), cfg,
                                      max_batch=3, max_len=256, block_size=8,
                                      num_blocks=18, **kw)
                else:
                    eng = Engine(_to_device(target, dev), cfg, max_batch=3,
                                 max_len=256, **kw)
                sm.reset_launches()
                rids = [eng.submit(p, max_new=m, seed=s) for p, m, s in rs]
                out = eng.run(steps_per_sync=steps)
                torch.cuda.synchronize()
                for rid, (_, m, _) in zip(rids, rs):
                    if eng.request(rid).status != "DONE" or \
                            len(out[rid]) != m:
                        raise AssertionError(
                            f"sampled reference {kind} {label} {dev}: "
                            f"request {rid} {eng.request(rid).status}")
                streams[(kind, label, dev)] = [out[r] for r in rids]
                if dev == "cpu":
                    if sm.LAUNCHES:
                        raise AssertionError("the CPU engine launched the "
                                             "sampler kernel")
                    continue
                m = eng.metrics()
                draws = m["decode_steps"] + m["launches"].get("verify", 0)
                if sm.LAUNCHES != draws:
                    raise AssertionError(
                        f"sampled reference {kind} {label}: sampler "
                        f"launches {sm.LAUNCHES} != {draws} draws")
                rows.append({"engine": kind, "variant": label,
                             "sampler_launches": sm.LAUNCHES,
                             "decode_steps": m["decode_steps"],
                             "verify": m["launches"].get("verify", 0)})
        ref = streams[(kind, "plain 8", "cpu")]
        models = {"cpu": fq if fused else target,
                  "cuda": _to_device(fq if fused else target, "cuda")}
        for (k2, label, dev), got in streams.items():
            if k2 != kind:
                continue
            for i, (g, w) in enumerate(zip(got, ref)):
                if g == w:
                    continue
                p, _, seed = rs[i]
                tie = _stream_tie(gpt, decoding, prng, models,
                                  fcfg if fused else cfg, p, seed, g, w,
                                  SAMPLE_SERVE)
                tie.update(engine=kind, variant=label, device=dev,
                           request=i)
                ties.append(tie)
                if not tie["near_tie"]:
                    raise AssertionError(f"sampled reference: {tie}")
    row = {"phase": "sampled_reference", "sampling": SAMPLE_SERVE,
           "config": "gpt_tiny f32 (seed 1), 5 requests, seeds 1-5; fused: "
                     "128 x 32, 1 layer, bf16 int8 weights, 3 requests",
           "k": SPEC_K, "streams": len(streams), "near_ties": ties,
           "runs": rows}
    _log(row)
    return row


def sampled_serving_phase(gpt, decoding, engines, sm, fd, rg, cfg, params,
                          greedy):
    """The serving cell sampled: gpt3_1p3b at full width, the 12
    requests of ``serving_phase`` (same prompts) with seeds 1..12 at
    ``SAMPLE_SERVE``, through the contiguous and the paged engine (bf16,
    64-token pages, the default pool), plain and with n-gram k 3: every
    request DONE with 32 tokens; the sampler launched exactly once a
    decode step and a verify pass (count set to 0 before each run; the
    plain composition never runs on the card); decode-loop tok/s beside
    the serving phase's greedy run (``greedy``: {engine: row}) and, for
    the plain runs, ``TOK_S_PAIRS`` pairs of a greedy and a sampled run
    on two engines in turns, each sampled run drawing the first one's
    streams; speculative streams
    equal to the plain streams bit for bit (row_gemm gives verify rows
    the decode rows' bits and the kernel is row-wise); one prompt under
    two seeds must diverge.  Then one sampled decode step of the slot
    state profiled (families sampling, flash_decode, row_gemm) beside a
    greedy one, the draw and the sampler alone profiled over its
    logits."""
    Engine, PagedEngine, _ = engines
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    runs, streams = {}, {}

    def engine(kind, **kw):
        kw = dict(max_batch=8, max_len=1024, attn_kernel="flash",
                  device="cuda", **kw)
        eng = (PagedEngine(params, cfg, block_size=64, **kw)
               if kind == "paged" else Engine(params, cfg, **kw))
        eng.submit(np.arange(40) % cfg.vocab_size, max_new=4, seed=99)
        eng.run()
        return eng

    def timed(eng):
        # one run of the 12 requests (seeds 1..12; greedy ignores them)
        base = eng.metrics()
        sm.reset_launches()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=32, seed=i + 1)
                for i, p in enumerate(prompts)]
        out = eng.run(steps_per_sync=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = _spec_deltas(eng.metrics(), base)
        return {"rids": rids, "out": out, "wall": wall, "d": d,
                "launches": sm.LAUNCHES,
                "tok_s": 32 * len(rids) / d["decode_seconds"]}

    for kind in ("contiguous", "paged"):
        for draft in ("none", "ngram"):
            eng = engine(kind, speculative=draft == "ngram", **SAMPLE_SERVE)
            pairs = []
            if draft == "none":
                # greedy and sampled runs of the same requests in turns
                # (greedy first, then sampled first, ...): the loop is
                # host-bound and the host's speed drifts over a call, so
                # one pair does not tell the two apart
                greedy_eng = engine(kind)
                for i in range(TOK_S_PAIRS):
                    pair = {}
                    for sampled in ((False, True) if i % 2 == 0
                                    else (True, False)):
                        r = timed(eng if sampled else greedy_eng)
                        pair["sampled" if sampled else "greedy"] = r
                    if i == 0:
                        first = pair["sampled"]
                    elif [pair["sampled"]["out"][x]
                          for x in pair["sampled"]["rids"]] != \
                            [first["out"][x] for x in first["rids"]]:
                        raise AssertionError(f"sampled serving {kind}: a "
                                             f"repeated run drew other "
                                             f"streams")
                    pairs.append((pair["greedy"]["tok_s"],
                                  pair["sampled"]["tok_s"]))
                del greedy_eng
            else:
                first = timed(eng)
            rids, out, d = first["rids"], first["out"], first["d"]
            launches = first["launches"]
            for rid in rids:
                req = eng.request(rid)
                if req.status != "DONE" or len(out[rid]) != 32:
                    raise AssertionError(f"sampled serving {kind} {draft}: "
                                         f"request {rid} {req.status}")
            draws = d["decode_steps"] + d.get("verify", 0)
            if launches != draws or draws < 1:
                raise AssertionError(
                    f"sampled serving {kind} {draft}: sampler launches "
                    f"{launches} != {draws} (decode steps + verify passes)")
            if kind == "paged" and eng.free_blocks != eng.num_blocks:
                raise AssertionError("sampled serving paged: pages left "
                                     "claimed")
            streams[(kind, draft)] = [out[r] for r in rids]
            row = {"engine": kind, "kv_dtype": "bf16", "draft": draft,
                   "sampler_launches": launches,
                   "decode_steps": d["decode_steps"],
                   "verify_rounds": d.get("verify", 0),
                   "decode_loop_s": d["decode_seconds"],
                   "decode_loop_tok_s": first["tok_s"],
                   "e2e_tok_s": 32 * len(rids) / first["wall"],
                   "wall_s": first["wall"],
                   "greedy_decode_loop_tok_s":
                       greedy[(kind, draft)]["decode_loop_tok_s"]
                       if (kind, draft) in greedy else None}
            if pairs:
                ratios = [s_ / g for g, s_ in pairs]
                row.update(
                    tok_s_pairs=pairs,
                    greedy_median_tok_s=statistics.median(
                        g for g, _ in pairs),
                    sampled_median_tok_s=statistics.median(
                        s_ for _, s_ in pairs),
                    sampled_over_greedy=statistics.median(ratios),
                    sampled_over_greedy_range=[min(ratios), max(ratios)])
            if draft == "ngram":
                s = eng.metrics()["speculative"]
                row.update(accept_ratio=s["accept_ratio"],
                           tokens_per_launch=s["tokens_per_launch"])
            runs[(kind, draft)] = row
            _log({"phase": "sampled_serving", **row})
            if kind == "contiguous" and draft == "none":
                a = eng.submit(prompts[0], max_new=32, seed=1)
                b = eng.submit(prompts[0], max_new=32, seed=2)
                two = eng.run(steps_per_sync=16)
                if two[a] == two[b]:
                    raise AssertionError("sampled serving: seeds 1 and 2 "
                                         "gave the same stream")
                # reported: alone, its prefill batch (cuBLAS) differs
                row["resubmitted_equal"] = two[a] == streams[(kind, draft)][0]
            del eng
            torch.cuda.empty_cache()
    for kind in ("contiguous", "paged"):
        if streams[(kind, "ngram")] != streams[(kind, "none")]:
            bad = [i for i, (x, y) in enumerate(zip(
                streams[(kind, "ngram")], streams[(kind, "none")])) if x != y]
            raise AssertionError(f"sampled serving {kind}: speculative "
                                 f"streams {bad} left the plain streams")
    agree = sum(x == y for x, y in zip(streams[("paged", "none")],
                                       streams[("contiguous", "none")]))
    # where a sampled step's device time goes, and the draw alone
    cache, _, toks, pos = _slot_state(gpt, params, cfg, "bf16",
                                      "contiguous", 0)
    tok = toks[:, 0].contiguous()
    seeds = torch.arange(1, 9, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        logits, _ = gpt.decode_step_multi(params, cache, tok, pos, cfg,
                                          attn_kernel="flash")

        def step():
            lg, _ = gpt.decode_step_multi(params, cache, tok, pos, cfg,
                                          attn_kernel="flash")
            return decoding.sample_token_pos(lg, seeds, pos, **SAMPLE_SERVE)

        def greedy_step():
            lg, _ = gpt.decode_step_multi(params, cache, tok, pos, cfg,
                                          attn_kernel="flash")
            return decoding.sample_token_pos(lg, seeds, pos, 0.0)

        prof = {"greedy_decode_step": _step_profile(greedy_step,
                                                    SAMPLE_FAMILIES),
                "sampled_decode_step": _step_profile(step, SAMPLE_FAMILIES,
                                                     names=True),
                "draw": _step_profile(lambda: decoding.sample_token_pos(
                    logits, seeds, pos, **SAMPLE_SERVE), SAMPLE_FAMILIES),
                "sampler_alone": _step_profile(lambda: sm.gumbel_argmax(
                    logits.float(), seeds=seeds, pos=pos), SAMPLE_FAMILIES)}
        prof["draw"]["event_ms"] = _time_ms(lambda: decoding.sample_token_pos(
            logits, seeds, pos, **SAMPLE_SERVE), reps=50)
    filters = sorted({n for n in prof["sampled_decode_step"].pop(
        "kernel_names") if any(f in n.lower() for f in FILTER_KERNELS)})
    for name, p in prof.items():
        _log({"phase": "sampled_profile", "name": name, **p})
    if filters:
        raise AssertionError(f"sampled decode step: filter kernels "
                             f"{filters}")
    out = {"runs": runs, "profiles": prof,
           "paged_equal_contiguous": f"{agree}/12",
           "speculative_equal_plain": True}
    _log({"phase": "sampled_serving_summary",
          "speculative_equal_plain": True,
          "paged_equal_contiguous": f"{agree}/12",
          "sampling_ms_a_step": prof["sampled_decode_step"]["device_ms"][
              "sampling"],
          "draw_device_ms": prof["draw"]["device_busy_ms"],
          "draw_event_ms": prof["draw"]["event_ms"],
          "draw_kernels": prof["draw"]["kernels_per_step"],
          "sampled_step_kernels": prof["sampled_decode_step"][
              "kernels_per_step"],
          "sampled_step_device_ms": prof["sampled_decode_step"][
              "device_busy_ms"],
          "greedy_step_kernels": prof["greedy_decode_step"][
              "kernels_per_step"],
          "greedy_step_device_ms": prof["greedy_decode_step"][
              "device_busy_ms"],
          "sampled_over_greedy_tok_s": {
              k: (r["sampled_over_greedy"], r["sampled_over_greedy_range"],
                  r["sampled_median_tok_s"], r["greedy_median_tok_s"])
              for (k, d), r in runs.items() if d == "none"}})
    return out


#: the phases ``--phases`` can run alone
# the compiled_serving phase: eager and captured runs in turns, and the
# steady decode rounds each engine's profile covers
GRAPH_PAIRS = 3
GRAPH_WARM_ROUNDS, GRAPH_TIMED_ROUNDS, GRAPH_PROFILED_ROUNDS = 2, 4, 1
# (label, engine, kv_dtype, n-gram k 3, sampled at SAMPLE_SERVE)
GRAPH_CASES = (("contiguous bf16", "contiguous", "bf16", False, False),
               ("paged bf16", "paged", "bf16", False, False),
               ("paged int8", "paged", "int8", False, False),
               ("fused int8", "fused", "int8", False, False),
               ("sampled contiguous bf16", "contiguous", "bf16", False, True),
               ("ngram contiguous bf16", "contiguous", "bf16", True, False),
               ("ngram fused int8", "fused", "int8", True, False))


def graph_prompts(cfg):
    """The serving cell's 12 seeded prompts (32-700 tokens) as
    ``compiled_serving_phase`` serves them."""
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 701, 12)
    return [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]


def graph_case_engine(engines, case, cfg, params, qparams, cuda_graphs=None):
    """The engine of one ``GRAPH_CASES`` entry (label, engine, kv_dtype,
    n-gram, sampled) at gpt3_1p3b's serving shape: 8 slots (the fused
    engine 1), max_len 1024, "flash", 64-token pages; and the requests it
    serves (the fused engine the first 3 of ``graph_prompts``)."""
    Engine, PagedEngine, FusedEngine = engines
    _, kind, kd, ngram, sampled = case
    kw = dict(kv_dtype=kd, attn_kernel="flash", device="cuda",
              speculative=ngram, cuda_graphs=cuda_graphs,
              **(SAMPLE_SERVE if sampled else {}))
    prompts = graph_prompts(cfg)
    if kind == "fused":
        return FusedEngine(qparams, cfg, max_len=1024, **kw), prompts[:3]
    if kind == "paged":
        return PagedEngine(params, cfg, max_batch=8, max_len=1024,
                           block_size=64, **kw), prompts
    return Engine(params, cfg, max_batch=8, max_len=1024, **kw), prompts


def _host_calls(prof, rounds):
    """CUDA API calls the host made a round in a profiled window, by
    name (kernel launches, graph launches, copies), and their sum."""
    calls = {}
    for ev in prof.key_averages():
        if "CPU" not in str(getattr(ev, "device_type", "")):
            continue
        name = ev.key
        if name.startswith(("cuda", "cu")) and (
                "Launch" in name or "Memcpy" in name or "Memset" in name):
            calls[name] = ev.count / rounds
    return {"by_name": calls, "launches": sum(
        n for k, n in calls.items() if "Launch" in k)}


def _steady_rounds(eng, prompts, spec):
    """Wall, device time and host calls of steady decode rounds: the
    engine's first ``max_batch`` prompts admitted and decoding with
    enough new tokens that nobody retires inside the window (16 a
    round, at most k + 1 = 4 a speculative one), ``GRAPH_WARM_ROUNDS``
    rounds, then ``GRAPH_TIMED_ROUNDS`` timed on the host clock (each
    round ends in its readback) and ``GRAPH_PROFILED_ROUNDS`` under the
    profiler; the requests are then served to the end."""
    from torch.profiler import ProfilerActivity, profile
    rounds = GRAPH_WARM_ROUNDS + GRAPH_TIMED_ROUNDS + GRAPH_PROFILED_ROUNDS
    new = (SPEC_K + 1 if spec else 16) * rounds + 8
    rids = [eng.submit(p, max_new=new, seed=i + 1)
            for i, p in enumerate(prompts[:eng.max_batch])]
    for _ in range(GRAPH_WARM_ROUNDS):
        eng.step(16)
    base = eng.metrics()
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED_ROUNDS):
        eng.step(16)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / GRAPH_TIMED_ROUNDS * 1e3
    d = _spec_deltas(eng.metrics(), base)
    steps = d["decode_steps"] if not spec else d["verify"]
    clocks = _nvidia_smi("clocks.sm,power.draw")
    # CUDA activity alone: the kernels and the host's CUDA API calls,
    # without an event an operator (an eager round has ~2 a kernel)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GRAPH_PROFILED_ROUNDS):
            eng.step(16)
        torch.cuda.synchronize()
    busy, kernels = 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and "CUDA" in str(getattr(ev, "device_type", "CUDA")):
            busy += us
            kernels += ev.count
    busy_ms = busy / GRAPH_PROFILED_ROUNDS / 1e3
    eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    if any(eng.request(r).status != "DONE" for r in rids):
        raise AssertionError("compiled serving: a steady-round request did "
                             "not finish")
    per_round = steps / GRAPH_TIMED_ROUNDS
    if d.get("prefill", 0) + d.get("prefill_fused", 0) or per_round != (
            1 if spec else 16):
        raise AssertionError(f"compiled serving: the timed rounds were not "
                             f"steady ({d})")
    return {"round_wall_ms": wall_ms, "round_device_ms": busy_ms,
            # decode: steps of the K-step loop; speculative: verify passes
            "steps_per_round": per_round,
            "device_ms_per_step": busy_ms / per_round,
            "idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_round": kernels / GRAPH_PROFILED_ROUNDS,
            "host_calls_per_round": _host_calls(prof, GRAPH_PROFILED_ROUNDS),
            "sm_clock_power": clocks}


def compiled_serving_phase(gpt, engines, programs, cfg, params, qparams,
                           keep=None):
    """The serving cell with its decode programs captured as CUDA graphs
    against the same engines run eagerly (``cuda_graphs=False``):
    gpt3_1p3b at full width, the 12 requests of ``serving_phase`` (the
    fused engine: the first 3), 32 new tokens, on contiguous bf16, paged
    bf16 and int8 (64-token pages, the default pool), the fused b1 int8
    engine, the contiguous engine sampled (``SAMPLE_SERVE``, seeds
    1-12), and n-gram k 3 on contiguous bf16 and on the fused engine.
    Each engine is warmed by two runs of the requests (every program of
    the run eager once, then captured); then ``GRAPH_PAIRS`` pairs of
    runs in turns (eager first, then captured first, ...).  Gates: every
    run's streams equal the first eager run's, and each pair's runs
    count the same launches of every kernel; the captured engine's
    timed rounds are all replays.  Reported: the median of the pairs'
    decode-loop tok/s, wall a round and a token, the captured engine's
    programs, replays, capture seconds and pool bytes; and, over steady
    rounds (``_steady_rounds``), each engine's wall and device ms a
    round, device ms a step, idle share and host calls a round.  With
    ``keep`` (a dict), the captured engines of ``FAULT_CASES`` stay alive
    in it, by label, with their requests and fault-free streams:
    ``serving_faults_phase`` takes them over."""
    prompts = graph_prompts(cfg)
    rows = {}
    for case in GRAPH_CASES:
        label, kind, kd, ngram, sampled = case
        t_case = time.perf_counter()

        def make(cuda_graphs):
            return graph_case_engine(engines, case, cfg, params, qparams,
                                     cuda_graphs)[0]

        reqs = prompts[:3] if kind == "fused" else prompts

        def run(eng):
            base, counts = eng.metrics(), programs.snapshot()
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new=32, seed=i + 1)
                    for i, p in enumerate(reqs)]
            out = eng.run(steps_per_sync=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = _spec_deltas(eng.metrics(), base)
            rounds = d.get("decode", 0) + d.get("verify", 0)
            tokens = 32 * len(reqs)
            if any(eng.request(r).status != "DONE" or len(out[r]) != 32
                   for r in rids):
                raise AssertionError(f"compiled serving {label}: a request "
                                     f"did not finish with 32 tokens")
            return {"streams": [list(map(int, out[r])) for r in rids],
                    "launches": programs.difference(programs.snapshot(),
                                                    counts),
                    "replays": eng.metrics()["graph_replays"]
                    - base["graph_replays"],
                    "wall_s": wall, "rounds": rounds,
                    "tok_s": tokens / d["decode_seconds"],
                    "e2e_tok_s": tokens / wall,
                    "round_ms": d["decode_seconds"] / rounds * 1e3,
                    "token_ms": d["decode_seconds"] / tokens * 1e3}

        engs = {"eager": make(False), "captured": make(None)}
        want = run(engs["eager"])
        for _ in range(2):
            run(engs["captured"])
        pairs = []
        for i in range(GRAPH_PAIRS):
            order = ("eager", "captured") if i % 2 == 0 \
                else ("captured", "eager")
            pair = {name: run(engs[name]) for name in order}
            for name, r in pair.items():
                if r["streams"] != want["streams"]:
                    same = sum(a == b for a, b in zip(r["streams"],
                                                      want["streams"]))
                    raise AssertionError(
                        f"compiled serving {label}: {name} run {i} streams "
                        f"{same}/{len(reqs)} equal to the first eager run")
            cap = pair["captured"]
            if cap["launches"] != pair["eager"]["launches"]:
                raise AssertionError(
                    f"compiled serving {label}: launches {cap['launches']} "
                    f"captured != {pair['eager']['launches']} eager")
            if cap["replays"] != cap["rounds"]:
                raise AssertionError(
                    f"compiled serving {label}: {cap['replays']} replays "
                    f"for {cap['rounds']} rounds")
            pairs.append(pair)
        m = engs["captured"].metrics()
        row = {"phase": "compiled_serving", "case": label, "engine": kind,
               "kv_dtype": kd, "draft": "ngram" if ngram else "none",
               "sampled": sampled, "requests": len(reqs), "max_new": 32,
               "streams_equal": f"{len(reqs)}/{len(reqs)}",
               "launches_equal": True, "rounds": want["rounds"],
               "graphs": m["graphs"], "graph_replays": m["graph_replays"],
               "capture_seconds": m["capture_seconds"],
               "graph_pool_bytes": m["graph_pool_bytes"]}
        for name in ("eager", "captured"):
            rs = [p[name] for p in pairs]
            row[name] = {k: statistics.median(r[k] for r in rs)
                         for k in ("tok_s", "e2e_tok_s", "round_ms",
                                   "token_ms", "wall_s")}
            row[name]["tok_s_runs"] = [r["tok_s"] for r in rs]
        row["captured_over_eager_tok_s"] = statistics.median(
            p["captured"]["tok_s"] / p["eager"]["tok_s"] for p in pairs)
        for name in ("eager", "captured"):
            row[name]["steady"] = _steady_rounds(engs[name], prompts, ngram)
        row["seconds"] = time.perf_counter() - t_case
        rows[label] = row
        _log(row)
        if keep is not None and label in FAULT_CASES:
            keep[label] = (engs["captured"], reqs, want["streams"])
        del engs
        torch.cuda.empty_cache()
    return rows


def compiled_serving_alone(gpt, engines, programs):
    """``compiled_serving_phase`` on its own: gpt3_1p3b bf16 from seed
    0 and its int8 serving weights."""
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    qparams = gpt.quantize_decode_params(params, cfg)
    return compiled_serving_phase(gpt, engines, programs, cfg, params,
                                  qparams)


# the serving_faults phase: robustness and lifecycle on compiled_serving's
# captured engines
FAULT_CASES = ("contiguous bf16", "paged bf16", "sampled contiguous bf16",
               "ngram contiguous bf16", "fused int8")
FAULT_TIMEOUT = 0.5          # step_timeout of the device-stall checks, s
FAULT_STALL_S = 2.0          # a stall: 4x FAULT_TIMEOUT
SM_HZ = 1.98e9               # the H100 SXM's top SM clock: a torch.cuda._sleep
                             # of FAULT_STALL_S * SM_HZ cycles lasts >= FAULT_STALL_S
FAULT_TTL = 1.0              # ttl of the requests that expire mid-decode, s
FAULT_DRAIN_S = 60.0         # drain(timeout) of the decode stall
FUNNEL_CALLS = 20000         # calls timed for the funnel's host cost
DRAFT_LAYERS = 2             # the model draft: gpt3_1p3b's width, 2 layers


def _serve_reqs(eng, reqs, **submit_kw):
    """Submit ``reqs`` (32 new tokens, seeds 1..n) and run them: (rids,
    streams)."""
    rids = [eng.submit(p, max_new=32, seed=i + 1, **submit_kw)
            for i, p in enumerate(reqs)]
    out = eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    return rids, [list(map(int, out[r])) for r in rids]


def _retry_deltas(m, before):
    """Retries by funnel kind between two ``metrics()`` snapshots."""
    return {k: n - before["retries"].get(k, 0)
            for k, n in m["retries"].items()
            if n - before["retries"].get(k, 0)}


def _streams_equal(label, check, streams, want, rids=None, eng=None):
    if streams != want:
        same = sum(a == b for a, b in zip(streams, want))
        raise AssertionError(f"serving faults {label} {check}: streams "
                             f"{same}/{len(want)} equal to the fault-free "
                             f"ones")
    if eng is not None and any(eng.status(r) != "DONE" for r in rids):
        raise AssertionError(f"serving faults {label} {check}: a request "
                             f"did not finish DONE")


def fault_free_run(eng, reqs, want, label):
    """One fault-free run of the requests on a warmed engine: its streams
    must equal ``want``; returns its launch deltas (the prefill counts a
    faulted run must keep) and its wall seconds."""
    before = eng.metrics()
    t0 = time.perf_counter()
    rids, streams = _serve_reqs(eng, reqs)
    wall = time.perf_counter() - t0
    _streams_equal(label, "fault-free", streams, want, rids, eng)
    return _spec_deltas(eng.metrics(), before), wall


def fault_schedule_check(eng, reqs, want, base, label, **faults):
    """One run of the requests under an injected fault schedule
    (``testing.faults.inject_engine_faults``: ``fail_times`` before the
    call, or ``fail_after_times`` after it ran): every stream equal to the
    fault-free one bit for bit, every request DONE, the injections and
    the engine's retries as scheduled, and the prefill, draft-prefill
    and fused-prefill counts of the fault-free run ``base`` — a call
    retried after it ran re-prefills nothing, as the caches are written
    in place."""
    from paddle_tpu_torch.testing.faults import inject_engine_faults
    n = faults.get("fail_times") or faults["fail_after_times"]
    want_inj = {k: n for k in faults["kinds"]}
    before = eng.metrics()
    t0 = time.perf_counter()
    with inject_engine_faults(eng, **faults) as inj:
        rids, streams = _serve_reqs(eng, reqs)
    wall = time.perf_counter() - t0
    m = eng.metrics()
    check = ",".join(f"{k}={v}" for k, v in sorted(faults.items()))
    _streams_equal(label, check, streams, want, rids, eng)
    retries = _retry_deltas(m, before)
    if inj.injected != want_inj or retries != want_inj:
        raise AssertionError(f"serving faults {label} {check}: injected "
                             f"{inj.injected}, retries {retries}, want "
                             f"{want_inj}")
    d = _spec_deltas(m, before)
    for key in ("prefill", "prefill_fused", "draft_prefill"):
        if d.get(key, 0) != base.get(key, 0):
            raise AssertionError(f"serving faults {label} {check}: {key} "
                                 f"{d.get(key, 0)} != fault-free "
                                 f"{base.get(key, 0)}")
    return {"faults": check, "injected": inj.injected, "retries": retries,
            "wall_s": wall, "streams_equal": f"{len(want)}/{len(want)}"}


def cancel_ttl_check(eng, reqs, want, label):
    """Cancel after the first round: two running requests and the last
    queued one go CANCELLED (pages back at once), the rest finish with
    their fault-free streams — the cancelled slots' next occupants
    included.  Then a TTL that expires mid-decode: the first two requests
    get ``ttl=FAULT_TTL``; after the first round the host waits out the
    deadline, and the next round retires them TIMEOUT with a prefix of
    their streams (or, queued behind a b1 slot, expired in the queue
    with none); the rest finish exactly.  A paged engine ends both with
    ``free_blocks == num_blocks``."""
    paged = hasattr(eng, "free_blocks")
    rids = [eng.submit(p, max_new=32, seed=i + 1)
            for i, p in enumerate(reqs)]
    eng.step(16)
    running = [r for r in rids if eng.status(r) == "RUNNING"]
    victims = running[:2] + [r for r in rids[-1:]
                             if eng.status(r) == "QUEUED"]
    free = eng.free_blocks if paged else None
    for r in victims:
        if not eng.cancel(r):
            raise AssertionError(f"serving faults {label}: cancel({r}) "
                                 f"refused")
    if paged and eng.free_blocks <= free:
        raise AssertionError(f"serving faults {label}: cancel freed no page")
    out = eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    row = {"cancelled": len(victims)}
    for i, r in enumerate(rids):
        req = eng.request(r)
        got = list(map(int, req.tokens))
        if r in victims:
            ok = req.status == "CANCELLED" and got == want[i][:len(got)]
        else:
            ok = req.status == "DONE" and got == want[i] and r in out
        if not ok:
            raise AssertionError(f"serving faults {label} cancel: request "
                                 f"{i} {req.status}, stream "
                                 f"{'equal' if got == want[i] else 'differs'}")
    if paged and eng.free_blocks != eng.num_blocks:
        raise AssertionError(f"serving faults {label} cancel: "
                             f"{eng.free_blocks}/{eng.num_blocks} pages free")
    rids = [eng.submit(p, max_new=32, seed=i + 1,
                       ttl=FAULT_TTL if i < 2 else None)
            for i, p in enumerate(reqs)]
    deadline = eng.request(rids[1]).deadline
    eng.step(16)
    time.sleep(max(0.0, deadline - time.monotonic()) + 0.01)
    eng.run(steps_per_sync=16)
    torch.cuda.synchronize()
    timed_out = []
    for i, r in enumerate(rids):
        req = eng.request(r)
        got = list(map(int, req.tokens))
        if i < 2:
            ok = (req.status == "TIMEOUT" and "deadline expired" in req.error
                  and len(got) < 32 and got == want[i][:len(got)])
            timed_out.append(len(got))
        else:
            ok = req.status == "DONE" and got == want[i]
        if not ok:
            raise AssertionError(f"serving faults {label} ttl: request {i} "
                                 f"{req.status} ({req.error})")
    if paged and eng.free_blocks != eng.num_blocks:
        raise AssertionError(f"serving faults {label} ttl: "
                             f"{eng.free_blocks}/{eng.num_blocks} pages free")
    row["ttl_tokens_at_expiry"] = timed_out
    return row


def breaker_check(eng, reqs, want, label):
    """``fail_always`` on prefill with the breaker's threshold at 2: two
    admissions are quarantined FAILED "prefill failed after retries", the
    breaker opens and every other request fails fast with its reason;
    submit then raises CircuitOpenError; ``reset_circuit()`` and the
    requests serve again with their fault-free streams."""
    from paddle_tpu_torch.inference.lifecycle import CircuitOpenError
    from paddle_tpu_torch.testing.faults import inject_engine_faults
    threshold = eng._breaker.threshold
    eng._breaker.threshold = 2
    try:
        t0 = time.perf_counter()
        with inject_engine_faults(eng, fail_always=True,
                                  kinds=("prefill",)) as inj:
            rids = [eng.submit(p, max_new=32) for p in reqs]
            out = eng.run(steps_per_sync=16)
        fail_s = time.perf_counter() - t0
        errors = [eng.request(r).error or "" for r in rids]
        if not (eng.circuit_open and sorted(out) == rids
                and all(eng.status(r) == "FAILED" for r in rids)
                and sum("prefill failed after retries" in e
                        for e in errors) == 2
                and sum("circuit breaker open" in e for e in errors)
                == len(rids) - 2):
            raise AssertionError(f"serving faults {label} breaker: "
                                 f"{[eng.status(r) for r in rids]}")
        try:
            eng.submit(reqs[0], max_new=32)
        except CircuitOpenError:
            pass
        else:
            raise AssertionError(f"serving faults {label} breaker: submit "
                                 f"was taken while open")
    finally:
        eng._breaker.threshold = threshold
    eng.reset_circuit()
    rids, streams = _serve_reqs(eng, reqs)
    _streams_equal(label, "after reset_circuit", streams, want, rids, eng)
    return {"injected": inj.injected, "fail_fast_s": fail_s,
            "quarantined": 2, "failed_fast": len(rids) - 2}


def _stall(eng, kind, after=False):
    """Make ``eng``'s device calls of ``kind`` queue a
    ``torch.cuda._sleep`` of FAULT_STALL_S on the current stream: before
    the call's own work (every call), or ``after`` it (the first call
    only: its kernels are slow, its host call is not).  Returns the host
    seconds of each stalled call, as it fills."""
    orig = eng._device_invoke
    took = []

    def stalled(k, fn, *a, **kw):
        if k != kind or (after and took):
            return orig(k, fn, *a, **kw)
        t0 = time.perf_counter()
        if not after:
            torch.cuda._sleep(int(FAULT_STALL_S * SM_HZ))
        out = orig(k, fn, *a, **kw)
        if after:
            torch.cuda._sleep(int(FAULT_STALL_S * SM_HZ))
        took.append(time.perf_counter() - t0)
        return out

    eng._device_invoke = stalled
    return took


def decode_stall_check(eng, reqs, label):
    """A real device stall: every decode call queues FAULT_STALL_S of
    ``torch.cuda._sleep`` before its round.  With ``step_timeout=
    FAULT_TIMEOUT`` (the engine warmed: its kernels built and its
    programs captured), no retry and the breaker's threshold at 2, each
    decode call's readback outlives its deadline and raises TimeoutError,
    the breaker opens and ``drain(FAULT_DRAIN_S)`` returns every request
    FAILED with the breaker's reason, well inside its bound.  The engine
    is STOPPED after."""
    from paddle_tpu_torch.utils.retry import RetryPolicy
    eng.step_timeout = FAULT_TIMEOUT
    eng._retry = RetryPolicy(retries=0, backoff=0.0)
    eng._breaker.threshold = 2
    took = _stall(eng, "decode")
    rids = [eng.submit(p, max_new=32) for p in reqs]
    t0 = time.perf_counter()
    out = eng.drain(timeout=FAULT_DRAIN_S, steps_per_sync=16)
    drain_s = time.perf_counter() - t0
    eng.__dict__.pop("_device_invoke", None)
    last = eng._breaker.last_error or ""
    if not (eng.state == "STOPPED" and drain_s < FAULT_DRAIN_S
            and all(out[r].status == "FAILED"
                    and "circuit breaker" in out[r].error for r in rids)
            and "TimeoutError" in last and len(took) == 2
            and min(took) >= FAULT_STALL_S * 0.9):
        raise AssertionError(f"serving faults {label} decode stall: drain "
                             f"{drain_s:.2f} s, calls {took}, last error "
                             f"{last[:200]}")
    return {"drain_s": drain_s, "stalled_call_s": took,
            "statuses": "FAILED", "last_error": last[:160]}


def prefill_stall_check(eng, reqs, want, label):
    """The same stall in a prefill's device work (queued after the
    call's own kernels) on one request: the prefill call only queues
    work, so it returns inside its deadline; the decode call's copy of
    the round waits for the stall and raises TimeoutError, the default
    policy retries the round, and the stream is the fault-free one."""
    timeout = eng.step_timeout
    eng.step_timeout = FAULT_TIMEOUT
    seen = []
    eng._retry.on_retry = lambda attempt, e: seen.append(repr(e))
    took = _stall(eng, "prefill", after=True)
    before = eng.metrics()
    try:
        rids, streams = _serve_reqs(eng, reqs[:1])
    finally:
        eng.__dict__.pop("_device_invoke", None)
        eng._retry.on_retry = None
        eng.step_timeout = timeout
    _streams_equal(label, "prefill stall", streams, want[:1], rids, eng)
    retries = _retry_deltas(eng.metrics(), before)
    if not (len(took) == 1 and took[0] < FAULT_TIMEOUT
            and retries == {"decode": 1} and seen
            and "serving:decode" in seen[0] and "TimeoutError" in seen[0]):
        raise AssertionError(f"serving faults {label} prefill stall: "
                             f"prefill call {took}, retries {retries}, "
                             f"{seen}")
    return {"prefill_call_s": took[0], "retries": retries,
            "tripped": seen[0][:160]}


def funnel_host_us(eng, n=FUNNEL_CALLS):
    """Host µs the funnel adds to a device call: ``_device_call`` of a
    call that does nothing against the call itself, without and with the
    watchdog (``step_timeout`` None and 30)."""
    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def noop():
        return None

    timeout = eng.step_timeout
    try:
        direct = per_call(noop)
        eng.step_timeout = None
        plain = per_call(lambda: eng._device_call("decode", noop))
        eng.step_timeout = 30.0
        watched = per_call(lambda: eng._device_call("decode", noop))
    finally:
        eng.step_timeout = timeout
    return {"call_us": direct, "funnel_us": plain - direct,
            "funnel_watchdog_us": watched - direct}


def _draft_prefix_engine(gpt, Engine, Spec, cfg, params):
    """The contiguous bf16 engine with a model draft (gpt3_1p3b's width,
    DRAFT_LAYERS layers, seed 1, k 3) and an unbounded prefix cache: the
    engine whose calls include "draft" and, from its second run on,
    "prefix" installs."""
    dcfg = gpt.gpt3_1p3b(dtype=torch.bfloat16, num_layers=DRAFT_LAYERS)
    draft = gpt.init_params(dcfg, seed=1, device="cuda")
    return Engine(params, cfg, max_batch=8, max_len=1024, attn_kernel="flash",
                  device="cuda", prefix_cache_bytes=None,
                  speculative=Spec(k=SPEC_K, draft_params=draft,
                                   draft_cfg=dcfg))


def fault_engines(engines, cfg, params, qparams):
    """The captured engines of ``FAULT_CASES`` when ``compiled_serving``
    has not run (``--phases serving_faults``, the card tests): built as
    that phase builds them (``graph_case_engine``), each warmed by two
    fault-free runs of its requests (every program eager once, then
    captured), the first run's streams the fault-free ones."""
    keep = {}
    for case in GRAPH_CASES:
        if case[0] not in FAULT_CASES:
            continue
        eng, reqs = graph_case_engine(engines, case, cfg, params, qparams)
        _, want = _serve_reqs(eng, reqs)
        _, again = _serve_reqs(eng, reqs)
        _streams_equal(case[0], "warm-up", again, want)
        keep[case[0]] = (eng, reqs, want)
    return keep


def serving_faults_phase(gpt, engines, Spec, programs, kernels, cfg, params,
                         keep):
    """Serving robustness and lifecycle at gpt3_1p3b's full width (bf16,
    seed 0) on captured programs: ``keep`` holds compiled_serving's
    captured engines (contiguous bf16, paged bf16, sampled contiguous,
    n-gram k 3, fused b1 int8: the serving cell's 12 requests, the fused
    engine's 3) with their fault-free streams; a contiguous engine with a
    2-layer model draft and the prefix cache is built here.  On each: a
    fault-free run, then ``fail_times=2`` on each call kind it makes
    (prefill, decode, verify, draft, prefix) and ``fail_after_times=1``
    on decode or verify, streams bit for bit and no extra prefill
    (``fault_schedule_check``); cancel and TTL with the page pool whole
    (``cancel_ttl_check``); the breaker (``breaker_check``); a real
    device stall in a prefill (``prefill_stall_check``) and in every
    decode call, drained (``decode_stall_check``, last: it stops the
    engine).  Every count of ``kernels`` (flash_decode, row_gemm,
    fused_decode, sampling) is set to 0 before and read after; each must
    have launched.  Returns the phase's row (logged)."""
    fd, rg, fdl, sm = kernels
    t_phase = time.perf_counter()
    for mod in kernels:
        mod.reset_launches()
    rows = {}
    schedules = {
        "contiguous bf16": (("prefill",), ("decode",)),
        "paged bf16": (("prefill",), ("decode",)),
        "sampled contiguous bf16": (("decode",),),
        "ngram contiguous bf16": (("prefill",), ("verify",)),
        "fused int8": (("prefill",), ("decode",))}
    after = {"contiguous bf16": "decode", "paged bf16": "decode",
             "ngram contiguous bf16": "verify", "fused int8": "decode"}
    funnel = funnel_host_us(keep["contiguous bf16"][0])
    for label in FAULT_CASES:
        eng, reqs, want = keep[label]
        base, wall = fault_free_run(eng, reqs, want, label)
        row = {"fault_free_wall_s": wall, "schedules": []}
        for kinds in schedules[label]:
            row["schedules"].append(fault_schedule_check(
                eng, reqs, want, base, label, fail_times=2, kinds=kinds))
        if label in after:
            row["schedules"].append(fault_schedule_check(
                eng, reqs, want, base, label, fail_after_times=1,
                kinds=(after[label],)))
        if label in ("contiguous bf16", "paged bf16", "fused int8"):
            row["cancel_ttl"] = cancel_ttl_check(eng, reqs, want, label)
        if label == "paged bf16":
            row["prefill_stall"] = prefill_stall_check(eng, reqs, want,
                                                       label)
        if label == "contiguous bf16":
            row["breaker"] = breaker_check(eng, reqs, want, label)
            row["decode_stall"] = decode_stall_check(eng, reqs, label)
        row["metrics"] = {k: eng.metrics()[k] for k in (
            "retries", "retired", "quarantined", "breaker")}
        rows[label] = row
    Engine = engines[0]
    eng = _draft_prefix_engine(gpt, Engine, Spec, cfg, params)
    eng_reqs, want = keep["contiguous bf16"][1], keep["contiguous bf16"][2]
    _, first = _serve_reqs(eng, eng_reqs)
    base, wall = fault_free_run(eng, eng_reqs, first, "draft prefix")
    rows["draft prefix"] = {
        "fault_free_wall_s": wall, "equals_plain_streams": first == want,
        "prefix_hit_tokens": eng.metrics()["prefix_hit_tokens"],
        "schedules": [fault_schedule_check(eng, eng_reqs, first, base,
                                           "draft prefix", fail_times=2,
                                           kinds=(kind,))
                      for kind in ("draft", "prefix")]}
    del eng
    counts = {"flash_decode": fd.LAUNCHES + fd.PAGED_LAUNCHES,
              "row_gemm": rg.LAUNCHES, "fused_decode": fdl.LAUNCHES,
              "sampling": sm.LAUNCHES}
    if not all(counts.values()):
        raise AssertionError(f"serving faults: a kernel of the path was "
                             f"launched no time: {counts}")
    out = {"phase": "serving_faults", "launches": counts,
           "funnel_host_us": funnel, "cases": rows,
           "seconds": time.perf_counter() - t_phase}
    _log(out)
    return out


def serving_faults_alone(gpt, engines, Spec, programs, kernels):
    """``serving_faults_phase`` on its own: gpt3_1p3b bf16 from seed 0,
    its int8 serving weights, and the engines of ``fault_engines``."""
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    qparams = gpt.quantize_decode_params(params, cfg)
    keep = fault_engines(engines, cfg, params, qparams)
    return serving_faults_phase(gpt, engines, Spec, programs, kernels, cfg,
                                params, keep)


# -- the prefix cache's host tier and the live handoff at full width --------

TIER_HOST_BYTES = 2 << 30     # the host tier's budget: 2 GiB
#: the cells of the tiered phase: (engine, kv_dtype); fused runs int8
#: weights and the first 3 requests
TIER_CELLS = (("contiguous", "bf16"), ("paged", "bf16"), ("paged", "int8"),
              ("paged", "fp8"), ("fused", "int8"))
#: engine sizes of the tiered and handoff phases (prefix_serving's): the
#: card tests pass a smaller one
TIER_SIZE = dict(max_len=1024, max_batch=8, block=64, pages=64,
                 prefix=PREFIX_LEN, tails=PREFIX_TAILS, fused_requests=3)
TIER_FAULT_CELLS = (("contiguous", "bf16"), ("paged", "bf16"))
TIER_COPY_REPS = 5
TIER_OVERLAP_ROUNDS, TIER_OVERLAP_PAIRS = 16, 3
TIER_CHUNK_BYTES = 8 << 20    # the chunked variant's copy size
HANDOFF_ROUNDS = 8            # the donor's rounds before its snapshot


def _kv_token_bytes(cfg, kd):
    """Stored K/V bytes a token at ``kd`` (all layers, scales
    included)."""
    from paddle_tpu_torch.incubate.nn.kv_quant import (kv_has_scales,
                                                       kv_storage_dtype)
    elem = torch.empty(0, dtype=kv_storage_dtype(kd, cfg.dtype)).element_size()
    per = cfg.num_layers * cfg.num_heads * cfg.head_dim * elem
    if kv_has_scales(kd):
        per += cfg.num_layers * cfg.num_heads * 4
    return 2 * per


def _tier_budgets(cfg, kind, kd, size):
    """(device-warm budget, host-warm device budget) in bytes: the
    device-warm run keeps every span on the device (paged: 3/8 of the
    pool, prefix_serving's 24 of 64 pages), the host-warm run has half a
    shared span's bytes, so every insert demotes."""
    tok = _kv_token_bytes(cfg, kd)
    warm = None
    if kind == "paged":
        warm = size["pages"] * 3 // 8 * size["block"] * tok
    return warm, size["prefix"] * tok // 2


def _tier_engine(engines, kind, tree, cfg, kd, budget, host, size,
                 dev="cuda", **kw):
    Engine, PagedEngine, FusedEngine = engines
    common = dict(kv_dtype=kd, device=dev, prefix_cache_bytes=budget,
                  prefix_host_bytes=host, attn_kernel="flash", **kw)
    if kind == "fused":
        return FusedEngine(tree, cfg, max_len=size["max_len"], **common)
    if kind == "paged":
        return PagedEngine(tree, cfg, max_batch=size["max_batch"],
                           max_len=size["max_len"], block_size=size["block"],
                           num_blocks=size["pages"], **common)
    return Engine(tree, cfg, max_batch=size["max_batch"],
                  max_len=size["max_len"], **common)


def _pool_whole(eng, label):
    """Paged: free pages plus trie-pinned pages make the whole pool, and
    every page is free once the trie is cleared."""
    if not hasattr(eng, "_page_rc"):
        return
    rc = np.asarray(eng._page_rc)
    if eng.free_blocks + int((rc > 0).sum()) != eng.num_blocks:
        raise AssertionError(f"{label}: free {eng.free_blocks} + pinned "
                             f"{int((rc > 0).sum())} != {eng.num_blocks}")


def _pool_cleared(eng, label):
    if not hasattr(eng, "_page_rc"):
        return
    eng._prefix.clear()
    if eng.free_blocks != eng.num_blocks or np.asarray(eng._page_rc).any():
        raise AssertionError(f"{label}: pages held after the trie cleared")


def _tier_launch_want(kind, L, d, suffix_tokens):
    """The launches the host-warm load must count (prefix_serving's
    rule): flash_decode L a decode step, suffix pass and prefill (paged:
    the paged layout for steps and passes), row_gemm 4 L + 1 a decode
    step and 4 L a suffix pass; fused: one a decode step and one a
    suffix token."""
    steps = d["decode_steps"]
    prefills = d.get("prefill", 0) + d.get("prefill_fused", 0)
    passes = sum(1 for s in suffix_tokens if s)
    if kind == "fused":
        return {"fused_decode": steps + sum(suffix_tokens)}
    want = {"row_gemm": (4 * L + 1) * steps + 4 * L * passes,
            "flash_decode": L * prefills}
    if kind == "paged":
        want["flash_decode_paged"] = L * (steps + passes)
    else:
        want["flash_decode"] += L * (steps + passes)
    return want


#: the engine calls whose host seconds a tiered run splits out (a
#: blocking call's seconds include the device work it waits for)
TIER_CALLS = ("_prefill_batch", "_admit_hit", "_start_reinstall",
              "_await_install", "_complete_reinstall", "_demote_payload",
              "_decode_many")


@contextlib.contextmanager
def _call_seconds(eng, names=TIER_CALLS):
    """Patch ``names`` on the instance to add their host seconds and
    calls into the yielded dict; restores the engine on exit."""
    out = {n: [0.0, 0] for n in names}

    def wrap(name, fn):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                out[name][0] += time.perf_counter() - t
                out[name][1] += 1
        return timed

    for n in names:
        setattr(eng, n, wrap(n, getattr(eng, n)))
    trie = eng._prefix
    if trie is not None and "_demote_payload" in names:
        # the trie holds the demoter it was built with
        trie._demoter = eng._demote_payload
    try:
        yield out
    finally:
        for n in names:
            eng.__dict__.pop(n, None)
        if trie is not None:
            trie._demoter = eng._demote_payload


def tiered_cell(gpt, engines, counters, cfg, tree, kind, kd, primer, use,
                size=TIER_SIZE):
    """One cell of the tiered phase: the load cold (no prefix cache),
    device-warm and host-warm (device budget half a span, host 2 GiB),
    each after the primer (``_prefix_run``).  Gates: host-warm streams
    equal device-warm streams bit for bit and cold's under the near-tie
    rule; every host-warm request a host hit; nothing left INSTALLING;
    exact launch counts of the host-warm load (counts set to 0 before
    it); the same captured programs as the device-warm run; paged, the
    pool whole.  Returns (row, host-warm engine, the near-tie bound)."""
    fd, rg, fdl = counters
    fused = kind == "fused"
    label = f"tiered serving {kind} {kd}"
    warm_budget, small = _tier_budgets(cfg, kind, kd, size)
    runs, eng = {}, None
    for run, budget, host in (("cold", 0, 0), ("device", warm_budget, 0),
                              ("host", small, TIER_HOST_BYTES)):
        eng = _tier_engine(engines, kind, tree, cfg, kd, budget, host, size)
        with _call_seconds(eng) as calls:
            runs[run] = _prefix_run(eng, use, primer, fd, rg, fdl)
        runs[run]["calls"] = calls
        _pool_whole(eng, f"{label} {run}")
        if run != "host":
            del eng
            torch.cuda.empty_cache()
    h, w = runs["host"], runs["device"]
    if h["streams"] != w["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(h["streams"], w["streams"]))
               if a != b]
        raise AssertionError(f"{label}: host-warm streams {bad} differ from "
                             f"device-warm")
    tiers = h["metrics"]["prefix_tiers"]
    if min(h["host_hits"]) <= 0 or tiers["installing"] or \
            tiers["reinstalls"] < len(use) or eng._installing:
        raise AssertionError(f"{label}: host hits {h['host_hits']}, tiers "
                             f"{tiers}")
    want = _tier_launch_want(kind, cfg.num_layers, h["deltas"],
                             h["suffix_tokens"])
    got = {k: h["counts"][k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want} "
                             f"({h['deltas']})")
    graphs = {r: {k: v["captured"] for k, v in runs[r]["metrics"][
        "graphs"].items()} for r in ("device", "host")}
    if graphs["host"] != graphs["device"]:
        raise AssertionError(f"{label}: programs {graphs}")
    _, bound = _prefix_kv_delta(gpt, tree, cfg, kd, primer, use[0], fused,
                                size["prefix"])
    diverged = _near_ties(gpt, tree, cfg, kd, use, h["streams"],
                          runs["cold"]["streams"], bound, fused, label,
                          primer, size["prefix"])
    n = tiers["reinstalls"]
    row = {"phase": "tiered_serving", "engine": kind, "kv_dtype": kd,
           "requests": len(use), "prefix_len": size["prefix"],
           "span_bytes": size["prefix"] * _kv_token_bytes(cfg, kd),
           "device_budget_bytes": {"device_warm": warm_budget,
                                   "host_warm": small},
           "host_budget_bytes": TIER_HOST_BYTES,
           "ttft_mean_s": {r: float(np.mean(runs[r]["ttft_s"]))
                           for r in runs},
           "ttft_median_s": {r: float(np.median(runs[r]["ttft_s"]))
                             for r in runs},
           "wall_s": {r: runs[r]["wall_s"] for r in runs},
           "admit_mean_s": {r: float(np.mean(runs[r]["admit_s"]))
                            for r in runs},
           "first_after_admit_mean_s": {
               r: float(np.mean(runs[r]["first_after_admit_s"]))
               for r in runs},
           # primer and load: host seconds and calls of each engine call
           "call_seconds": {r: {k: v for k, v in runs[r]["calls"].items()
                                if v[1]} for r in runs},
           "host_hits": h["host_hits"], "launches": got,
           "graphs": graphs["host"],
           "reinstalls": n, "reinstall_mean_s": tiers["reinstall_seconds"] / n,
           "reinstall_decode_overlap_mean_s":
               tiers["reinstall_decode_overlap_seconds"] / n,
           "prefix_tiers": tiers,
           "host_equals_device": f"{len(use)}/{len(use)}",
           "host_vs_cold_equal": f"{len(use) - len(diverged)}/{len(use)}",
           "divergences_vs_cold": diverged, "near_tie_bound": bound,
           "cold_streams": runs["cold"]["streams"],
           "host_streams": h["streams"]}
    return row, eng, bound


def tier_fault_checks(gpt, eng, tree, cfg, kd, primer, use, row, bound,
                      label, size=TIER_SIZE):
    """On a host-warm engine whose trie holds the prefix on the host: a
    slow copy (``defer_ready=3``) keeps the host-warm streams bit for
    bit; a reinstall that always fails and one past ``install_timeout``
    re-prefill to DONE (streams equal cold's, or at a near-tie); a cancel
    mid-install frees the slot; no slot, install or page is left."""
    from paddle_tpu_torch.testing.faults import inject_engine_faults
    fused = False
    out = {}
    fails0 = eng._tier_stats["reinstall_failures"]
    with inject_engine_faults(eng, kinds=(), defer_ready=3) as inj:
        rids = [eng.submit(p, max_new=32) for p in use[:2]]
        res = eng.run(steps_per_sync=1)
    if inj.deferred != 3 or [res[r] for r in rids] != row["host_streams"][:2]:
        raise AssertionError(f"{label}: defer_ready streams or polls "
                             f"({inj.deferred})")
    out["defer_ready"] = {"deferred": inj.deferred, "streams_equal": True}
    for name, case in (("reinstall_fails", 2), ("install_timeout", 3)):
        before = eng._tier_stats["reinstall_failures"]
        if name == "reinstall_fails":
            ctx = inject_engine_faults(eng, fail_always=True,
                                       kinds=("reinstall",))
        else:
            eng.install_timeout = 0.0
            ctx = inject_engine_faults(eng, kinds=(), defer_ready=1)
        with ctx:
            rid = eng.submit(use[case], max_new=32)
            res = eng.run(steps_per_sync=1)
        eng.install_timeout = 30.0
        if eng.status(rid) != "DONE" or \
                eng._tier_stats["reinstall_failures"] != before + 1:
            raise AssertionError(f"{label}: {name} {eng.status(rid)}")
        div = _near_ties(gpt, tree, cfg, kd, [use[case]], [res[rid]],
                         [row["cold_streams"][case]], bound, fused,
                         f"{label} {name}", primer, size["prefix"])
        out[name] = {"status": "DONE", "divergences_vs_cold": div,
                     "reprefill": eng.request(rid).prefix_host_hit == 0}
    with inject_engine_faults(eng, kinds=(), defer_ready=100):
        rid = eng.submit(use[4], max_new=32)
        eng.step(1)
        if eng.status(rid) != "INSTALLING" or not eng.cancel(rid):
            raise AssertionError(f"{label}: cancel mid-install "
                                 f"{eng.status(rid)}")
    if eng.status(rid) != "CANCELLED" or eng._installing or \
            eng.active_slots or eng._has_work():
        raise AssertionError(f"{label}: a cancelled install left work")
    _pool_whole(eng, f"{label} faults")
    out["cancel_mid_install"] = {"status": "CANCELLED", "slots_free": True}
    out["reinstall_failures"] = eng._tier_stats["reinstall_failures"] - fails0
    return out


def _event_ms(fn, stream):
    """Device ms of ``fn()``'s work on ``stream`` (CUDA events)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record(stream)
    fn()
    b.record(stream)
    b.synchronize()
    return a.elapsed_time(b)


def tier_copy_rates(eng, size=TIER_SIZE):
    """One shared span's copies on a host-tier contiguous engine: the
    demotion (``demote()``: blocking copy to pinned host memory, host
    clock), the reinstall's copies (``io.device_put_async`` on the
    engine's side stream, CUDA events there) and, as the yardstick, a
    pinned ``copy_`` of the same tensors on the current stream; medians
    of TIER_COPY_REPS."""
    from paddle_tpu_torch.incubate.nn.kv_quant import kv_components
    from paddle_tpu_torch.io import device_put_async
    P = size["prefix"]
    span = eng._read_span(0, 0, P)
    nbytes = span.nbytes
    demote_ms, host = [], None
    for _ in range(TIER_COPY_REPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = span.demote()
        demote_ms.append((time.perf_counter() - t) * 1e3)
    srcs = list(kv_components(host.k)) + list(kv_components(host.v))
    side, cur = eng._h2d_stream, torch.cuda.current_stream()
    dsts = [torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in srcs]
    h2d, yard = [], []
    for _ in range(TIER_COPY_REPS + 1):
        h2d.append(_event_ms(lambda: [device_put_async(x, "cuda", side)
                                      for x in srcs], side))
        yard.append(_event_ms(lambda: [d.copy_(x, non_blocking=True)
                                       for d, x in zip(dsts, srcs)], cur))
    med = [statistics.median(v[1:]) for v in (demote_ms, h2d, yard)]
    return {"span_tokens": P, "bytes": nbytes, "demote_ms": med[0],
            # the first demotion allocates its pinned buffers
            "demote_first_ms": demote_ms[0],
            "demote_gb_s": nbytes / med[0] / 1e6,
            "reinstall_h2d_ms": med[1], "reinstall_h2d_gb_s": nbytes / med[1]
            / 1e6, "pinned_copy_ms": med[2],
            "pinned_copy_gb_s": nbytes / med[2] / 1e6,
            "reinstall_vs_pinned_copy": med[2] / med[1]}, host


def tier_overlap_tok_s(engines, cfg, params, host, size=TIER_SIZE):
    """The decode-loop tok/s of captured 8-slot rounds (one decode step a
    round) without and with a reinstall's copies in flight (one shared
    span, ``device_put_async`` on the side stream before each round), and
    with the same bytes as TIER_CHUNK_BYTES copies (``h2d_chunked``: does
    a round's own small host copy wait behind one long transfer?), in
    turns: TIER_OVERLAP_PAIRS rounds of the three, TIER_OVERLAP_ROUNDS
    rounds each."""
    from paddle_tpu_torch.incubate.nn.kv_quant import kv_components
    from paddle_tpu_torch.io import device_put_async
    eng = engines[0](params, cfg, max_batch=size["max_batch"],
                     max_len=size["max_len"], device="cuda")
    rng = np.random.default_rng(11)
    need = 4 + 3 * TIER_OVERLAP_PAIRS * TIER_OVERLAP_ROUNDS + 8
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, 16), max_new=need)
            for _ in range(size["max_batch"])]
    for _ in range(4):
        eng.step(1)                  # admitted, programs captured
    srcs = list(kv_components(host.k)) + list(kv_components(host.v))
    n = TIER_CHUNK_BYTES
    chunks = [b[i:i + n] for b in (x.view(torch.uint8).view(-1)
                                   for x in srcs)
              for i in range(0, b.numel(), n)]
    side = eng._h2d_stream
    copies = {"plain": [], "h2d_in_flight": srcs, "h2d_chunked": chunks}
    rates = {mode: [] for mode in copies}
    # the same, less the host seconds spent issuing the copies: what is
    # left of a loss is the device's or the copy engines'
    net = {mode: [] for mode in copies}
    for _ in range(TIER_OVERLAP_PAIRS):
        for mode, xs in copies.items():
            before = sum(len(eng.request(r).tokens) for r in rids)
            issue = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(TIER_OVERLAP_ROUNDS):
                t_issue = time.perf_counter()
                for x in xs:
                    device_put_async(x, "cuda", side)
                issue += time.perf_counter() - t_issue
                eng.step(1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            tokens = sum(len(eng.request(r).tokens) for r in rids) - before
            rates[mode].append(tokens / dt)
            net[mode].append(tokens / (dt - issue))
    for r in rids:
        eng.cancel(r)
    med = {k: statistics.median(v) for k, v in rates.items()}
    med_net = {k: statistics.median(v) for k, v in net.items()}
    return {"slots": size["max_batch"], "rounds": TIER_OVERLAP_ROUNDS,
            "tok_s": rates, "tok_s_median": med,
            "tok_s_less_issue_median": med_net,
            "less_issue_share": {k: v / med_net["plain"]
                                 for k, v in med_net.items()},
            "in_flight_share": med["h2d_in_flight"] / med["plain"],
            "chunked_share": med["h2d_chunked"] / med["plain"],
            "chunks_a_round": len(chunks),
            "h2d_bytes_a_round": sum(x.numel() * x.element_size()
                                     for x in srcs)}


def tiered_serving_phase(gpt, engines, fd, rg, fdl, cfg, params, qparams,
                         size=TIER_SIZE):
    """The prefix cache's host tier at gpt3_1p3b's full width (bf16,
    seed-0 weights; fused: int8 weights): prefix_serving's load (a
    512-token prefix, a primer and 12 requests with tails of 16-128, 32
    new tokens) through every TIER_CELLS cell cold, device-warm and
    host-warm (``tiered_cell``), the fault checks on contiguous and paged
    bf16 (``tier_fault_checks``), a span's copy rates
    (``tier_copy_rates``) and the decode tok/s with a reinstall in flight
    (``tier_overlap_tok_s``)."""
    rng = np.random.default_rng(7)
    load = _shared_prefix_load(rng, cfg.vocab_size, PREFIX_REQUESTS + 1,
                               size["prefix"], size["tails"])
    primer, prompts = load[0], load[1:]
    results, bounds, copies = {}, {}, None
    for kind, kd in TIER_CELLS:
        fused = kind == "fused"
        use = prompts[:size["fused_requests"]] if fused else prompts
        tree = qparams if fused else params
        row, eng, bound = tiered_cell(gpt, engines, (fd, rg, fdl), cfg, tree,
                                      kind, kd, primer, use, size)
        bounds[(kind, kd)] = bound
        label = f"tiered serving {kind} {kd}"
        if (kind, kd) in TIER_FAULT_CELLS:
            row["faults"] = tier_fault_checks(gpt, eng, tree, cfg, kd, primer,
                                              use, row, bound, label, size)
        if (kind, kd) == ("contiguous", "bf16"):
            copies, host = tier_copy_rates(eng, size)
            row["copies"] = copies
        _pool_cleared(eng, label)
        del eng
        torch.cuda.empty_cache()
        for key in ("cold_streams", "host_streams"):
            row.pop(key)
        _log(row)
        results[(kind, kd)] = row
    overlap = tier_overlap_tok_s(engines, cfg, params, host, size)
    _log({"phase": "tiered_overlap", **overlap})
    torch.cuda.empty_cache()
    return {"cells": results, "copies": copies, "overlap": overlap,
            "bounds": bounds}


def _drive_next_tokens(eng, rids):
    """Run ``eng`` to the end, one decode step a sync; the seconds from
    the start to each of ``rids``' next token."""
    base = {r: len(eng.request(r).tokens) for r in rids}
    first = {}
    t0 = time.perf_counter()
    while eng._has_work():
        eng.step(1)
        t = time.perf_counter()
        for r in rids:
            if r not in first and len(eng.request(r).tokens) > base[r]:
                first[r] = t - t0
    return first


def _bundle_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def handoff_cell(gpt, engines, counters, cfg, tree, kd, old_kind, new_kinds,
                 primer, use, bound, root, size=TIER_SIZE,
                 rounds=HANDOFF_ROUNDS):
    """A mid-run handoff: the uninterrupted run of ``use`` (one decode
    step a sync), then a donor of ``old_kind`` stopped after ``rounds``
    rounds and snapshotted, restored into a fresh engine of each of
    ``new_kinds`` (counts set to 0 before the successor's run, each
    kernel of its layout launched), and into a cold restart (no prefix
    cache: every span dropped, the carried requests re-prefill).  Gates:
    the streams equal the uninterrupted run's, or each difference at a
    near-tie (counted); the warm restore runs fewer prefills than the
    cold restart; no slot, install or page left."""
    from paddle_tpu_torch.inference import handoff
    fd, rg, fdl = counters
    fused = old_kind == "fused"
    label = f"handoff serving {old_kind} {kd}"

    def mk(kind, budget="warm"):
        warm, _ = _tier_budgets(cfg, kind, kd, size)
        return _tier_engine(engines, kind, tree, cfg, kd,
                            warm if budget == "warm" else 0, TIER_HOST_BYTES,
                            size)

    ref = mk(old_kind)
    rids = [ref.submit(p, max_new=32) for p in use]
    out = ref.run(steps_per_sync=1)
    want = [out[r] for r in rids]
    del ref
    old = mk(old_kind)
    rids = [old.submit(p, max_new=32) for p in use]
    for _ in range(rounds):
        old.step(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    bundle = handoff.snapshot(old, root)
    snap_s = time.perf_counter() - t
    nbytes = _bundle_bytes(bundle)
    done_old = {r for r in rids if old.request(r).status == "DONE"}
    row = {"phase": "handoff_serving", "donor": old_kind, "kv_dtype": kd,
           "requests": len(use), "rounds_before_snapshot": rounds,
           "done_on_donor": len(done_old), "bundle_bytes": nbytes,
           "snapshot_s": snap_s, "donor_spans": old.metrics()["handoff"][
               "spans_out"], "successors": {}}
    prefills = {}
    rng = np.random.default_rng(13)
    for new_kind in tuple(new_kinds) + ("cold",):
        kind = old_kind if new_kind == "cold" else new_kind
        new = mk(kind, "cold" if new_kind == "cold" else "warm")
        # a successor that serves: its kernels built and its decode
        # program captured by one short request of its own first
        new.submit(rng.integers(0, cfg.vocab_size, 16), max_new=4)
        new.run(steps_per_sync=1)
        base = new.metrics()["launches"]
        t = time.perf_counter()
        rep = handoff.restore(new, bundle)
        restore_s = time.perf_counter() - t
        if not rep.ok or (new_kind != "cold") != (rep.spans_installed > 0):
            raise AssertionError(f"{label} -> {new_kind}: restore {rep}")
        carried = [rep.rid_map[r] for r in rids if r not in done_old]
        fd.reset_launches()
        rg.reset_launches()
        fdl.reset_launches()
        first = _drive_next_tokens(new, carried)
        torch.cuda.synchronize()
        counts = {"flash_decode": fd.LAUNCHES,
                  "flash_decode_paged": fd.PAGED_LAUNCHES,
                  "row_gemm": rg.LAUNCHES, "fused_decode": fdl.LAUNCHES}
        need = (("fused_decode",) if fused else
                ("flash_decode_paged", "row_gemm") if kind == "paged"
                else ("flash_decode", "row_gemm"))
        if any(counts[k] == 0 for k in need):
            raise AssertionError(f"{label} -> {new_kind}: launches {counts}")
        streams = [old.request(r).tokens if r in done_old else
                   new.request(rep.rid_map[r]).tokens for r in rids]
        if any(new.request(r).status != "DONE" for r in carried) or \
                new._installing or new.active_slots:
            raise AssertionError(f"{label} -> {new_kind}: successor state")
        diverged = _near_ties(gpt, tree, cfg, kd, use, streams, want, bound,
                              fused, f"{label} -> {new_kind}", primer,
                              size["prefix"])
        _pool_whole(new, f"{label} -> {new_kind}")
        _pool_cleared(new, f"{label} -> {new_kind}")
        m = new.metrics()
        prefills[new_kind] = sum(
            m["launches"].get(k, 0) - base.get(k, 0)
            for k in ("prefill", "prefill_fused"))
        row["successors"][new_kind] = {
            "restore_s": restore_s, "spans_installed": rep.spans_installed,
            "spans_bad": rep.spans_bad, "carried": len(carried),
            "bytes_in": rep.bytes_in, "prefills": prefills[new_kind],
            "reinstalls": m.get("prefix_tiers", {}).get("reinstalls", 0),
            "next_token_mean_s": float(np.mean(list(first.values()))),
            "next_token_max_s": float(np.max(list(first.values()))),
            "streams_equal": f"{len(use) - len(diverged)}/{len(use)}",
            "divergences": diverged, "launches": counts}
        del new
        torch.cuda.empty_cache()
    warm_kind = new_kinds[0]
    if not prefills[warm_kind] < prefills["cold"]:
        raise AssertionError(f"{label}: warm restore prefills {prefills}")
    row["warm_vs_cold_next_token_s"] = [
        row["successors"][warm_kind]["next_token_mean_s"],
        row["successors"]["cold"]["next_token_mean_s"]]
    return row, bundle


def handoff_serving_phase(gpt, engines, fd, rg, fdl, cfg, params, qparams,
                          bounds, size=TIER_SIZE):
    """The live handoff at gpt3_1p3b's full width: the tiered load on a
    contiguous bf16 donor (host tier 2 GiB) snapshotted after 8 rounds and
    restored into a fresh contiguous engine and a paged one, the fused
    b1 int8 donor (3 requests) into a fused engine (``handoff_cell``);
    then a truncated copy of a bundle is quarantined and its restore
    falls back to a cold start that still serves."""
    import shutil
    import tempfile
    from paddle_tpu_torch.inference import handoff
    rng = np.random.default_rng(7)
    load = _shared_prefix_load(rng, cfg.vocab_size, PREFIX_REQUESTS + 1,
                               size["prefix"], size["tails"])
    prompts = load[1:]
    root = tempfile.mkdtemp(prefix="handoff-smoke-")
    out = {}
    try:
        for old_kind, kd, new_kinds in (
                ("contiguous", "bf16", ("contiguous", "paged")),
                ("fused", "int8", ("fused",))):
            fused = old_kind == "fused"
            use = prompts[:size["fused_requests"]] if fused else prompts
            tree = qparams if fused else params
            bound = bounds.get((old_kind, kd))
            if bound is None:
                _, bound = _prefix_kv_delta(gpt, tree, cfg, kd, load[0],
                                            use[0], fused, size["prefix"])
            row, bundle = handoff_cell(
                gpt, engines, (fd, rg, fdl), cfg, tree, kd, old_kind,
                new_kinds, load[0], use, bound, root, size)
            _log(row)
            out[(old_kind, kd)] = row
        torn = str(Path(root) / "handoff-000099")
        shutil.copytree(bundle, torn)
        with open(Path(torn) / handoff.CACHE_FILE, "r+b") as f:
            f.truncate(f.seek(0, 2) // 2)
        eng = _tier_engine(engines, "fused", qparams, cfg, "int8", None,
                           TIER_HOST_BYTES, size)
        rep = handoff.restore(eng, torn)
        quarantined = [n for n in Path(root).iterdir()
                       if n.name.startswith(handoff.QUARANTINE_PREFIX)]
        rid = eng.submit(prompts[0][:40], max_new=4)
        eng.run()
        if rep.ok or rep.fallback != "cold" or Path(torn).exists() or \
                not quarantined or eng.status(rid) != "DONE":
            raise AssertionError(f"handoff serving: truncated bundle {rep}")
        out["truncated"] = {"ok": rep.ok, "fallback": rep.fallback,
                            "problems": rep.problems,
                            "quarantined": quarantined[0].name,
                            "cold_request": "DONE"}
        _log({"phase": "handoff_truncated", **out["truncated"]})
        del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def _gpt3_trees(gpt):
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    return cfg, params, gpt.quantize_decode_params(params, cfg)


def tiered_serving_alone(gpt, engines, fd, rg, fdl):
    """``tiered_serving_phase`` on its own: gpt3_1p3b bf16 from seed 0
    and its int8 serving weights."""
    return tiered_serving_phase(gpt, engines, fd, rg, fdl, *_gpt3_trees(gpt))


def handoff_serving_alone(gpt, engines, fd, rg, fdl):
    """``handoff_serving_phase`` on its own (the near-tie bounds computed
    there)."""
    return handoff_serving_phase(gpt, engines, fd, rg, fdl,
                                 *_gpt3_trees(gpt), {})


#: the phases ``--phases`` runs alone, and the sources each builds
# ---------------------------------------------------------------------------
# The rest of the one-device train step: remat plans, the prefetcher,
# the training checkpoint and preemption with an exact resume
# ---------------------------------------------------------------------------

REMAT_PLANS = (False, True, "dots_saveable", "dots_saveable_attn",
               "partial:12")
#: flash forward launches a step, in units of L, under each plan
REMAT_FWD = {False: 1, True: 2, "dots_saveable": 2, "dots_saveable_attn": 1,
             "partial:12": 1}
REMAT_STEPS = 4              # timed steps a plan, after one warm step
PREFETCH_PROFILED = 2        # prefetch's first steps a run (profiled once)
FIT_BATCH = 32               # remat_fit's batch rows (B 8 x 4)
FIT_SHARE = 0.9              # of the card's memory a predicted peak may use
CKPT_LAYERS = 4              # the checkpoint and preemption model's depth
CKPT_BESIDE_MAX = 200        # steps beside one commit before the phase waits
PREEMPT_STEPS = 10           # the preemption phase's run
PREEMPT_KILL_AFTER = 5       # the first process's SIGTERM, after this step
CUBLAS_DETERMINISTIC = ":4096:8"
TRAIN_FAMILIES = (("flash_fwd", ("flash_attention_fwd",)),
                  ("flash_bwd", ("flash_attention_bwd",)))


def host_batches(cfg, seed, start, stop, B=8, S=1024):
    """The seeded host loader: batch i (0-based) is (ids, labels) int64
    numpy arrays made from ``seed + i``, for i in [start, stop)."""
    for i in range(start, stop):
        rng = np.random.default_rng(seed + i)
        yield (rng.integers(0, cfg.vocab_size, (B, S)),
               rng.integers(0, cfg.vocab_size, (B, S)))


def _plan_name(plan):
    return plan if isinstance(plan, str) else f"remat={plan}"


def _train_plan(gpt, hybrid, TrainLoop, fa, prefetch, cfg, params, plan, B,
                steps, profile=True):
    """One plan: a fresh copy of ``params`` and AdamW state, one warm
    step, ``steps`` timed steps through TrainLoop over the prefetcher
    (batches 1..steps of the seeded loader), the flash launches of the
    timed steps, peak memory, and a profiled step's idle share."""
    step, shard, init_opt = hybrid.build_train_step(cfg, remat=plan,
                                                    device="cuda")
    # earlier phases leave cycles (an engine and its programs' closures)
    # holding device memory: collect them, so the states and peaks below
    # are this plan's
    gc.collect()
    torch.cuda.empty_cache()
    p = shard(params)
    o = init_opt(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    states = torch.cuda.memory_allocated()
    batches = prefetch(host_batches(cfg, 0, 0, steps + 1, B),
                       device=step.data_device)
    batch = next(batches)
    S = batch[0].shape[1]
    first, p, o = step(p, o, *batch)
    torch.cuda.synchronize()
    fa.reset_launches()
    loop = TrainLoop(step, max_inflight=2)
    t0 = time.perf_counter()
    handles = []
    for batch in batches:
        handles.append(loop.step(p, o, *batch)[0])
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v / steps for k, v in fa.launches().items()}
    losses = [first.item()] + [float(d) for d in handles]
    step_ms = wall / steps * 1e3
    row = {"plan": _plan_name(plan), "B": B, "S": S, "losses": losses,
           "step_ms": step_ms, "tokens_per_s": B * S / (step_ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": states, "flash_launches_per_step": launches,
           "stall_s": loop.stall_seconds}
    if profile:
        prof = _profile(lambda: step(p, o, *batch), 1, step_ms,
                        list(TRAIN_FAMILIES), top_n=6)
        row.update({k: prof[k] for k in ("device_ms", "device_busy_ms",
                                         "idle_share", "sm_clock_power")})
    del p, o, batch
    torch.cuda.empty_cache()
    return row


def remat_plans_phase(gpt, hybrid, TrainLoop, fa, prefetch):
    """gpt3_1p3b bf16, 24 layers, B 8, S 1024 under each plan of
    REMAT_PLANS (module docstring, 15a)."""
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16)
    L = cfg.num_layers
    params = gpt.init_params(cfg, seed=0, device="cuda")
    rows = {}
    for plan in REMAT_PLANS:
        row = _train_plan(gpt, hybrid, TrainLoop, fa, prefetch, cfg, params,
                          plan, 8, REMAT_STEPS)
        _log({"phase": "remat_plans", **row})
        rows[row["plan"]] = row
        want = {"flash_attention_fwd": REMAT_FWD[plan] * L,
                "flash_attention_bwd_dkv": L, "flash_attention_bwd_dq": L}
        if row["flash_launches_per_step"] != want:
            raise AssertionError(f"remat {plan}: flash launches a step "
                                 f"{row['flash_launches_per_step']} != "
                                 f"{want}")
        ref = rows["remat=False"]["losses"]
        if not all(np.isfinite(row["losses"])) or max(
                abs(a - b) for a, b in zip(row["losses"], ref)) > LOSS_TOL:
            raise AssertionError(f"remat {plan}: losses {row['losses']} vs "
                                 f"remat=False {ref} (atol {LOSS_TOL})")
    return {"rows": rows, "params": params, "cfg": cfg}


def _fit_prediction(rows, L, scale, total):
    """The predicted peak at ``scale`` x the B 8 batch: the states, plus
    every byte above them at B 8 times ``scale`` (grads included: an
    over-estimate); partial:K from the B 8 False and dots_saveable_attn
    peaks, K of L layers at the latter's per-layer bytes.  Returns
    (K, predicted bytes of partial:K, predicted bytes of False) with K
    the fewest rematted layers predicted within FIT_SHARE of
    ``total``."""
    f, a = rows["remat=False"], rows["dots_saveable_attn"]
    base = min(r["state_bytes"] for r in rows.values())
    over_f = f["peak_memory_bytes"] - f["state_bytes"]
    over_a = a["peak_memory_bytes"] - a["state_bytes"]

    def pred(k):
        return base + scale * (over_f - k * (over_f - over_a) / L)
    fits = [k for k in range(1, L + 1) if pred(k) <= FIT_SHARE * total]
    if not fits:
        raise AssertionError(f"remat fit: no partial:K predicted within "
                             f"{FIT_SHARE} of {total} bytes "
                             f"(partial:{L}: {pred(L):.4g})")
    return fits[0], pred(fits[0]), pred(0)


def remat_fit_phase(gpt, hybrid, TrainLoop, fa, prefetch, plans):
    """gpt3_1p3b at B 32, S 1024: remat True, then partial:K (module
    docstring, 15a).  No OOM is provoked or caught: K comes from the B 8
    peaks with every byte above the states scaled by 4."""
    cfg, params, rows = plans["cfg"], plans["params"], plans["rows"]
    L = cfg.num_layers
    total = torch.cuda.get_device_properties(0).total_memory
    scale = FIT_BATCH / 8
    k, pred_k, pred_false = _fit_prediction(rows, L, scale, total)
    pred_true = rows["remat=True"]["state_bytes"] + scale * (
        rows["remat=True"]["peak_memory_bytes"]
        - rows["remat=True"]["state_bytes"])
    if not pred_false > FIT_SHARE * total:
        raise AssertionError(f"remat fit: remat False predicted to fit at "
                             f"B {FIT_BATCH} ({pred_false:.4g} bytes)")
    out = {"card_bytes": total, "k": k, "predicted_false_bytes": pred_false}
    for plan, pred in ((True, pred_true), (f"partial:{k}", pred_k)):
        row = _train_plan(gpt, hybrid, TrainLoop, fa, prefetch, cfg, params,
                          plan, FIT_BATCH, 2, profile=False)
        row["predicted_peak_bytes"] = pred
        out[row["plan"]] = row
        _log({"phase": "remat_fit", "card": _nvidia_smi("name,power.limit"),
              **row})
        if not all(np.isfinite(row["losses"])):
            raise AssertionError(f"remat fit {plan}: losses {row['losses']}")
    return out


def _copy_overlap(prof):
    """(H2D copy ms, the part of it during which a kernel ran) from a
    profile's device events; (None, None) when the profile holds none."""
    copies, kernels = [], []
    for ev in prof.events():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        iv = (ev.time_range.start, ev.time_range.end)
        if "memcpy htod" in ev.name.lower():
            copies.append(iv)
        elif "memcpy" not in ev.name.lower() \
                and "memset" not in ev.name.lower():
            kernels.append(iv)
    if not copies:
        return None, None
    kernels.sort()
    total = over = 0.0
    for a, b in copies:
        total += b - a
        for ka, kb in kernels:
            if ka >= b:
                break
            over += max(0.0, min(b, kb) - max(a, ka))
    return total / 1e3, min(over, total) / 1e3


def prefetch_phase(gpt, hybrid, fa, prefetch, tio, plans):
    """The B 8 remat-False step with its batches through
    ``prefetch_to_device(depth=2)`` against a synchronous ``.to`` of
    each batch, in turns (module docstring, 15a).  A run takes
    PREFETCH_PROFILED steps, under the profiler in the first run of
    each mode (the idle share and the copies' overlap; the prefetcher
    issues its copies from the first batch on), then REMAT_STEPS steps
    timed by the host clock alone."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = plans["cfg"], plans["params"]
    step, shard, init_opt = hybrid.build_train_step(cfg, remat=False,
                                                    device="cuda")
    p = shard(params)
    o = init_opt(p)
    step(p, o, *next(prefetch(host_batches(cfg, 0, 0, 1), device="cuda")))
    torch.cuda.synchronize()
    n, m = REMAT_STEPS, PREFETCH_PROFILED
    runs = []
    for mode in ("sync", "prefetch", "prefetch", "sync"):
        host = [0]

        def counted(it):
            for a, b in it:
                host[0] += a.nbytes + b.nbytes
                yield a, b
        src = counted(host_batches(cfg, 0, 1, n + m + 1))
        batches = iter(prefetch(src, device="cuda", depth=2)
                       if mode == "prefetch" else
                       ((torch.from_numpy(a).to("cuda"),
                         torch.from_numpy(b).to("cuda")) for a, b in src))
        h2d0 = tio.TRAIN_H2D_BYTES.value
        profiled = mode not in (r["mode"] for r in runs)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            for _ in range(m):
                step(p, o, *next(batches))
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for ids, lab in batches:
            step(p, o, ids, lab)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        row = {"mode": mode, "steps": n, "wall_ms": wall_ms,
               "step_ms": wall_ms / n, "h2d_bytes": host[0]}
        if profiled:
            busy = sum(ev.self_device_time_total
                       for ev in prof.key_averages()
                       if "CUDA" in str(getattr(ev, "device_type", "")))
            copy_ms, overlap_ms = _copy_overlap(prof)
            row.update({"profiled_steps": m, "h2d_copy_ms": copy_ms,
                        "h2d_overlapped_ms": overlap_ms,
                        "device_busy_ms": busy / 1e3,
                        "idle_share": 1 - busy / 1e3 / prof_ms})
        _log({"phase": "prefetch", **row})
        runs.append(row)
        moved = tio.TRAIN_H2D_BYTES.value - h2d0
        if moved != (host[0] if mode == "prefetch" else 0):
            raise AssertionError(f"prefetch {mode}: the prefetcher counted "
                                 f"{moved} bytes of {host[0]}")
    del p, o
    torch.cuda.empty_cache()
    return {"runs": runs, "card": _nvidia_smi("name,power.limit")}


def _flat_state(state):
    from paddle_tpu_torch.distributed.checkpoint import flatten_state_dict
    return flatten_state_dict(state)[0]


def _state_equal(a, b):
    fa_, fb = _flat_state(a), _flat_state(b)
    return sorted(fa_) == sorted(fb) and all(
        torch.equal(fa_[k], fb[k].to(fa_[k].device)) for k in fa_)


def _clone_state(state):
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.detach().clone()


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def _span_overlap(spans, t0, t1):
    """ms of [t0, t1] (``time.perf_counter``) under each commit part of
    ``spans`` ((step, name, start, end) tuples), by part name."""
    out = {}
    for _, name, a, b in spans:
        ov = min(t1, b) - max(t0, a)
        if ov > 0:
            out[name] = out.get(name, 0.0) + ov * 1e3
    return out


def _commit_split(steps, spans, plain_ms):
    """Where the steps beside a commit lose their time: for each commit
    part, its ms (summed over the commits), the steps that ran mostly
    (over half their wall) under it, their mean wall, host dispatch and
    card ms, and their ms over a plain step."""
    out = {}
    for name in dict.fromkeys(n for _, n, _, _ in spans):
        mine = [st for st in steps
                if st["commit_parts_ms"].get(name, 0.0) > st["wall_ms"] / 2]
        out[name] = {
            "part_ms": sum((b - a) * 1e3 for _, n, a, b in spans
                           if n == name),
            "steps": len(mine)}
        if mine:
            out[name].update({
                k: statistics.mean(st[f] for st in mine) for k, f in (
                    ("wall_ms_mean", "wall_ms"), ("host_ms_mean", "host_ms"),
                    ("card_ms_mean", "card_ms"))})
            out[name]["over_plain_ms"] = sum(st["wall_ms"] - plain_ms
                                             for st in mine)
    return out


def train_checkpoint_phase(gpt, hybrid, TrainLoop, prefetch):
    """The 4-layer full-width model (module docstring, 15a): a save, the
    steps beside its commit until it is done, a second save (into the
    first's pinned buffers) and the steps beside its commit; each step's
    host dispatch, card ms and wall against the commit's parts
    (``AsyncCheckpointer.spans``); then the verify walk and the load of
    the newest step, and the flipped-byte fallback through
    ``load_latest``."""
    from paddle_tpu_torch.distributed import checkpoint as dist_cp
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16, num_layers=CKPT_LAYERS)
    step, shard, init_opt = hybrid.build_train_step(cfg, remat=False,
                                                    device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    state = {"params": params, "opt": init_opt(params)}
    elements = sum(t.numel() for t in _flat_state(state).values())
    snaps, steps, saves = {}, [], []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ckpt")
        # no retention: its walk re-hashes every kept step (SHA-256 of
        # 3.1 GB, ~4 s each here), and the CPU tests cover it
        ac = dist_cp.AsyncCheckpointer(root)
        loop = TrainLoop(step, max_inflight=2)
        batches = prefetch(host_batches(cfg, 0, 0, 2 * CKPT_BESIDE_MAX + 6),
                           device="cuda")
        torch.cuda.synchronize()

        def one(kind):
            i = len(steps) + 1
            ids, lab = next(batches)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            t0 = time.perf_counter()
            loop.step(state["params"], state["opt"], ids, lab)
            t_host = time.perf_counter()
            if kind == "save":
                loop.drain()
                snaps[i] = _clone_state(state)
                ac.save(state, i)
                saves.append(i)
            loop.drain()
            ev1.record()
            ev1.synchronize()
            t1 = time.perf_counter()
            steps.append({"step": i, "kind": kind, "t0": t0, "t1": t1,
                          "host_ms": (t_host - t0) * 1e3,
                          "card_ms": ev0.elapsed_time(ev1),
                          "wall_ms": (t1 - t0) * 1e3,
                          "save_lag_s": ac.save_lag()})

        def beside():
            for _ in range(CKPT_BESIDE_MAX):
                if ac.save_lag() == 0.0:
                    break
                one("beside")
            # the next save then finds the first's buffer set free
            ac.drain()

        for kind in ("plain", "save", "beside", "plain", "save", "beside",
                     "plain"):
            if kind == "beside":
                beside()
            else:
                one(kind)
        commit_s = ac.stats["commit_seconds"]
        spans = list(ac.spans)
        # both saves took one pinned buffer set: the second reused it
        buffer_sets = sum(1 for bufs in list(ac._free.queue) if bufs)
        ac.close()
        if buffer_sets != 1:
            raise AssertionError(f"the two saves made {buffer_sets} pinned "
                                 f"buffer sets, not one")
        new, old = saves[-1], saves[0]
        dn = dist_cp.step_dir(root, new)
        nbytes = _dir_bytes(dn)
        p2 = shard(gpt.init_params(cfg, seed=1, device="cuda"))
        fresh = {"params": p2, "opt": init_opt(p2)}
        t0 = time.perf_counter()
        found = dist_cp.find_latest_verified(root)
        verify_s = time.perf_counter() - t0
        if found != (new, dn):
            raise AssertionError(f"the verify walk found {found}, not step "
                                 f"{new}")
        t0 = time.perf_counter()
        dist_cp.load_state_dict(fresh, dn, verify=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not _state_equal(fresh, snaps[new]):
            raise AssertionError(f"step {new} loaded a tensor that is not "
                                 f"the saved one bit for bit")
        shard_file = os.path.join(dn, "0_0.distcp")
        with open(shard_file, "r+b") as f:
            f.seek(os.path.getsize(shard_file) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        got = dist_cp.load_latest(fresh, root)
        quarantined = sorted(n for n in os.listdir(root)
                             if n.startswith(".corrupt-"))
        if got != old or not _state_equal(fresh, snaps[old]) \
                or not quarantined:
            raise AssertionError(f"after a flipped byte in step {new}: "
                                 f"loaded {got}, quarantined {quarantined}")
    base = steps[0]["t0"]
    for st in steps:
        st["commit_parts_ms"] = _span_overlap(spans, st["t0"], st["t1"])
    plain = [st["wall_ms"] for st in steps
             if st["kind"] == "plain" and not st["commit_parts_ms"]]
    plain_ms = statistics.mean(plain)
    beside_ = [st for st in steps if st["kind"] == "beside"]
    commits = {}
    for s_, name, a, b in spans:
        commits.setdefault(s_, {})[name] = (b - a) * 1e3
    row = {"phase": "train_checkpoint", "card": _nvidia_smi(
               "name,power.limit"),
           "config": f"gpt3_1p3b bf16, {CKPT_LAYERS} layers, float32 "
                     f"moments", "elements": elements,
           "saves": saves,
           "save_step_ms": {"first (pinned buffers made)":
                            steps[saves[0] - 1]["wall_ms"],
                            "second (buffers reused)":
                            steps[saves[1] - 1]["wall_ms"]},
           "plain_step_ms_mean": plain_ms,
           "beside_steps": len(beside_),
           "beside_step_ms_mean": statistics.mean(
               st["wall_ms"] for st in beside_) if beside_ else None,
           "beside_step_ms_max": max(
               (st["wall_ms"] for st in beside_), default=None),
           "commit_ms_by_part": commits,
           "beside_by_part": _commit_split(steps, spans, plain_ms),
           "save_lag_max_s": max(st["save_lag_s"] for st in steps),
           "commit_s": commit_s,
           "bytes_on_disk": nbytes,
           "commit_gb_per_s": nbytes / commit_s / 1e9,
           "verify_s": verify_s, "load_s": load_s,
           "quarantined": quarantined,
           "steps": [{**{k: v for k, v in st.items() if k not in ("t0",
                                                                  "t1")},
                      "start_s": st["t0"] - base} for st in steps]}
    _log(row)
    del state, fresh, snaps
    torch.cuda.empty_cache()
    return row


def _state_digest(state):
    """SHA-256 of each tensor's bytes, by flattened key."""
    out = {}
    for k, t in sorted(_flat_state(state).items()):
        raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
        out[k] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


def preempt_run(role, workdir):
    """The preemption phase's training: gpt3_1p3b bf16 at CKPT_LAYERS
    layers, remat partial:2, deterministic algorithms, seed-0 weights,
    the seeded loader's batches through prefetch_to_device and TrainLoop.
    ``role`` "reference" runs PREEMPT_STEPS steps; "first" saves every 2
    steps (an AsyncCheckpointer), sends itself SIGTERM after step
    PREEMPT_KILL_AFTER and leaves through
    PreemptionGuard.checkpoint_and_exit (exit 143); "resume" resumes
    from the marker (or load_latest over the first's saves) and trains
    to the end.
    Returns (or, before exiting, writes to ``workdir/<role>.json``) the
    losses by step, the final state's digest and the build stats."""
    from paddle_tpu_torch.distributed import checkpoint as dist_cp
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.distributed.fleet.preemption import (
        PreemptionGuard, resume_step)
    from paddle_tpu_torch.incubate.nn.kernels import _build
    from paddle_tpu_torch.io import prefetch_to_device
    from paddle_tpu_torch.jit.loop import ElasticInterrupt, TrainLoop
    from paddle_tpu_torch.models import gpt
    torch.use_deterministic_algorithms(True)
    cfg = gpt.gpt3_1p3b(dtype=torch.bfloat16, num_layers=CKPT_LAYERS)
    step, shard, init_opt = hybrid.build_train_step(cfg, remat="partial:2",
                                                    device="cuda")
    params = shard(gpt.init_params(cfg, seed=0, device="cuda"))
    state = {"params": params, "opt": init_opt(params)}
    final = os.path.join(workdir, "final")
    roots = os.path.join(workdir, "steps")
    start, resumed_from = 0, None
    if role == "resume":
        start = resume_step(final)
        if start is not None:
            # resume_step has just verified the directory's manifest
            dist_cp.load_state_dict(state, final, verify=False)
            resumed_from = "marker"
        else:
            start = dist_cp.load_latest(state, roots) or 0
            resumed_from = "load_latest"
    ac = dist_cp.AsyncCheckpointer(roots) if role == "first" else None
    guard = PreemptionGuard(checkpointer=ac) if role == "first" else None
    loop = TrainLoop(step, max_inflight=2,
                     interrupt_check=guard.should_save if guard else None)
    losses = {}

    def result(**more):
        return {"role": role, "start": start, "resumed_from": resumed_from,
                "losses": {i: float(d) for i, d in losses.items()},
                "builds": _build.BUILD_STATS["builds"],
                "build_s": _build.BUILD_STATS["seconds"],
                "build_dir": str(_build.BUILD_DIR), **more}

    try:
        for i, (ids, lab) in enumerate(prefetch_to_device(
                host_batches(cfg, 0, start, PREEMPT_STEPS),
                device=step.data_device), start=start + 1):
            losses[i] = loop.step(state["params"], state["opt"], ids, lab)[0]
            if ac is not None and i % 2 == 0:
                ac.save(state, i)
            if role == "first" and i == PREEMPT_KILL_AFTER:
                os.kill(os.getpid(), signal.SIGTERM)
        loop.drain()
    except ElasticInterrupt as e:
        with open(os.path.join(workdir, f"{role}.json"), "w") as f:
            json.dump(result(completed_steps=e.completed_steps), f)
        guard.checkpoint_and_exit(state, final, e.completed_steps)
    if ac is not None:
        ac.close()
    out = result(digest=_state_digest(state))
    torch.use_deterministic_algorithms(False)
    return out


def preemption_phase(gpt, hybrid):
    """An uninterrupted run here, then the preempted and the resuming
    process (module docstring, 15a)."""
    from paddle_tpu_torch.distributed.fleet.preemption import MARKER
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != CUBLAS_DETERMINISTIC:
        raise AssertionError("the preemption phase needs "
                             f"CUBLAS_WORKSPACE_CONFIG={CUBLAS_DETERMINISTIC} "
                             "from the start of the process")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PT_COMPILE_CACHE_DIR=os.path.join(tmp, "cache"),
                   CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC)

        def child(role):
            return subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--preempt-child", role, "--preempt-dir", tmp],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

        def finish(role, proc, t0):
            try:
                out, err = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            procs[role] = (subprocess.CompletedProcess(
                proc.args, proc.returncode, out, err),
                time.perf_counter() - t0)

        procs = {}
        # the first process starts and builds its kernels (host work)
        # while the uninterrupted run trains here
        t_first = time.perf_counter()
        first_proc = child("first")
        try:
            t0 = time.perf_counter()
            ref = preempt_run("reference", tmp)
            ref_s = time.perf_counter() - t0
        finally:
            finish("first", first_proc, t_first)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        finish("resume", child("resume"), t0)
        first, resume = ({}, {})
        for role, (proc, _) in procs.items():
            path = os.path.join(tmp, f"{role}.json")
            if os.path.exists(path):
                with open(path) as f:
                    (first if role == "first" else resume).update(json.load(f))
        marker = None
        if os.path.exists(os.path.join(tmp, "final", MARKER)):
            with open(os.path.join(tmp, "final", MARKER)) as f:
                marker = json.load(f)["step"]
    rc = {r: p.returncode for r, (p, _) in procs.items()}
    want = {int(i): v for i, v in ref["losses"].items()}
    row = {"phase": "preemption", "card": _nvidia_smi("name,power.limit"),
           "config": f"gpt3_1p3b bf16, {CKPT_LAYERS} layers, partial:2, "
                     f"B 8, S 1024, deterministic",
           "returncodes": rc, "marker_step": marker,
           "interrupt_completed_steps": first.get("completed_steps"),
           "resumed_from": resume.get("resumed_from"),
           "resume_start": resume.get("start"),
           "reference_losses": want, "first_losses": first.get("losses"),
           "resumed_losses": resume.get("losses"),
           "builds": {"first": first.get("builds"),
                      "resume": resume.get("builds")},
           "build_s": {"first": first.get("build_s"),
                       "resume": resume.get("build_s")},
           "process_s": {r: s for r, (_, s) in procs.items()},
           "reference_s": ref_s}
    _log(row)
    errors = []
    if rc["first"] != 143 or first.get("completed_steps") is None \
            or marker != first["completed_steps"]:
        errors.append(f"first process: exit {rc['first']}, marker {marker}, "
                      f"interrupt at {first.get('completed_steps')}")
    if rc["resume"] != 0 or resume.get("start") != marker:
        errors.append(f"resume: exit {rc['resume']}, start "
                      f"{resume.get('start')}")
    got = {int(i): v for i, v in (resume.get("losses") or {}).items()}
    got.update({int(i): v for i, v in (first.get("losses") or {}).items()})
    # the first process's losses up to the one before the interrupted
    # step (whose handle the interrupt drops), the resumed process's after
    steps = (list(range(1, marker)) if marker else []) \
        + list(range((marker or 0) + 1, PREEMPT_STEPS + 1))
    if sorted(got) != steps or any(got[i] != want[i] for i in steps):
        errors.append(f"losses {got} != uninterrupted {want}")
    if resume.get("digest") != ref["digest"]:
        errors.append("final params and moments differ from the "
                      "uninterrupted run's")
    if resume.get("builds") != 0 or not first.get("builds"):
        errors.append(f"builds: first {first.get('builds')}, resume "
                      f"{resume.get('builds')} (want > 0, 0)")
    if errors:
        for role, (proc, _) in procs.items():
            print(f"--- {role} stderr ---\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
        raise AssertionError("preemption: " + "; ".join(errors))
    return row


def train_slice_alone(gpt, hybrid, TrainLoop, fa):
    """``--phases train_slice``: the phases of 15a on their own, each
    one's seconds logged."""
    from paddle_tpu_torch import io as tio
    prefetch = tio.prefetch_to_device
    seconds = {}

    def timed(name, phase, *a):
        t = time.perf_counter()
        out = phase(*a)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out
    plans = timed("remat_plans", remat_plans_phase, gpt, hybrid, TrainLoop,
                  fa, prefetch)
    timed("remat_fit", remat_fit_phase, gpt, hybrid, TrainLoop, fa,
          prefetch, plans)
    timed("prefetch", prefetch_phase, gpt, hybrid, fa, prefetch, tio, plans)
    del plans
    torch.cuda.empty_cache()
    timed("train_checkpoint", train_checkpoint_phase, gpt, hybrid,
          TrainLoop, prefetch)
    timed("preemption", preemption_phase, gpt, hybrid)
    _log({"phase": "train_slice_seconds", **seconds})


BERT_B, BERT_S = 16, 512        # bench_models.bench_bert's card shape
BERT_MLM_SHARE = 0.15           # positions a sequence with an MLM label
BERT_STEPS = 4                  # timed steps, after one warm step
BERT_PLAIN_LAYERS = 4           # the flash-vs-plain run's depth
BERT_PLAIN_STEPS = 3
BERT_PLAIN_TOL = 1e-2           # |loss_flash - loss_plain| a step, bf16
BERT_F32_LAYERS, BERT_F32_B = 4, 4
BERT_F32_LOSS_REL = 1e-4        # float32 flash vs plain, each step's loss
BERT_KERNEL_CASES = (
    # name, B, S, nH, hD, dtype: bert_large's attention, non-causal
    ("bert_bf16", BERT_B, BERT_S, 16, 64, torch.bfloat16),
    ("bert_f32", BERT_F32_B, BERT_S, 16, 64, torch.float32))
BERT_FAMILIES = (("flash_fwd", ("flash_attention_fwd",)),
                 ("flash_bwd", ("flash_attention_bwd",)))
CTC_SHAPE = dict(T=500, B=32, L=100, C=80)   # bench_models.bench_ctc's
CTC_LOSS_REL = 1e-5             # card vs CPU, the loss
# card vs CPU, each gradient element, of max |grad|: the float32
# recursion's gradients sit 1.5e-4 of the max from float64's on the CPU
# at this shape, and each side carries such an error
CTC_GRAD_REL = 2e-3
CTC_REPS = 5


def bert_batches(cfg, seed, n, B, S):
    """The BERT loader: ``n`` fresh host copies of one batch made from
    ``seed`` — (ids [B, S], {"mlm": [B, S] labels, -100 but on ~15 % of
    the positions, "nsp": [B]}) int64 numpy arrays — so that the loss of
    a short run falls."""
    for _ in range(n):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, cfg.vocab_size, (B, S))
        mlm = rng.integers(0, cfg.vocab_size, (B, S))
        mlm[rng.random((B, S)) >= BERT_MLM_SHARE] = -100
        yield ids, {"mlm": mlm, "nsp": rng.integers(0, 2, (B,))}


def mlm_head_check(bert, cfg, gen, flush):
    """The MLM head's float32-output product of the bias fold at
    bert_large's [B S, H + 1] x [H + 1, V], bf16, with the feature axis
    as it is (1025: rows of 2050 bytes) and zero-padded to a multiple of
    8 (1032): both products' times and their logits' difference, then
    the head loss forward + backward (``mlm_masked_loss``'s steps, the
    fold at each width) at each."""
    from paddle_tpu_torch.incubate.nn.functional.chunked_ce import (
        chunked_vocab_nll, pick_num_chunks)
    from paddle_tpu_torch.models.common import matmul_f32out
    N, H, V = BERT_B * BERT_S, cfg.hidden_size, cfg.vocab_size
    params = {"wte": (torch.randn((V, H), generator=gen, device="cuda")
                      * 0.02).to(torch.bfloat16).requires_grad_(True),
              "mlm_bias": torch.zeros((V,), dtype=torch.bfloat16,
                                      device="cuda", requires_grad=True)}
    for name in ("mlm_w", "mlm_b", "mlm_ln_g", "mlm_ln_b"):
        shape = (H, H) if name == "mlm_w" else (H,)
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.02
             if name == "mlm_w" else torch.zeros(shape, device="cuda")
             + (name == "mlm_ln_g"))
        params[name] = w.to(torch.bfloat16).requires_grad_(True)
    h = torch.randn((BERT_B, BERT_S, H), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    rng = np.random.default_rng(5)
    lbl = rng.integers(0, V, (BERT_B, BERT_S))
    lbl[rng.random((BERT_B, BERT_S)) >= BERT_MLM_SHARE] = -100
    lbl = torch.tensor(lbl, device="cuda")
    x = torch.randn((N, H), generator=gen, device="cuda").to(torch.bfloat16)
    mask = (lbl != -100).reshape(N)
    safe = torch.where(mask, lbl.reshape(N), 0)
    leaves = [params["wte"], params["mlm_bias"], h]
    row, logits, align = {}, {}, bert.MLM_FEATURE_ALIGN
    for a in (1, 8):
        xf, W = bert._bias_folded(x, {k: v.detach()
                                      for k, v in params.items()}, a)
        Wt = W.t()
        logits[a] = matmul_f32out(xf, Wt)

        def head():
            xh = bert._mlm_transform(params, h, cfg).reshape(N, H)
            nll = chunked_vocab_nll(*bert._bias_folded(xh, params, a), safe,
                                    0, pick_num_chunks(N, V))
            loss = (nll * mask).sum() / mask.sum()
            return torch.autograd.grad(loss, leaves)
        row[f"features_{xf.shape[1]}"] = {
            "product_ms": _time_ms(lambda: matmul_f32out(xf, Wt),
                                   reps=10, flush=flush),
            "head_fwd_bwd_ms": _time_ms(head, reps=5, flush=flush)}
    torch.cuda.synchronize()
    diff = (logits[1] - logits[8]).abs().max().item()
    row.update({
        "shape": f"[{N}, {H + 1}] x [{H + 1}, {V}] bf16 -> float32",
        "align_used": align, "logits_max_abs_diff": diff,
        "logits_max": logits[8].abs().max().item(),
        **_bound(2 * (N + V) * (H + 1) + 4 * N * V, 2 * N * V * (H + 1),
                 "bfloat16")})
    # the same zero-free products: only the summation order may differ
    if not diff <= F32_REL * max(1.0, row["logits_max"]):
        raise AssertionError(f"MLM head: padded vs unpadded logits {diff}")
    _log({"phase": "bert_mlm_head", **row})
    return row


def bert_kernel_phase(fa, resources):
    """The flash kernels at bert_large's attention, non-causal at head
    dim 64: bf16 [16, 512, 16x64] (the bench shape) and float32 [4, 512,
    16x64] (the float32 cell), each held per element to its plain
    version, timed against its bound and SDPA; the instances'
    registers, spills and shared memory; the MLM head's product."""
    from paddle_tpu_torch.models import bert
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    rows = {name: flash_kernel_case(fa, gen, flush, name, B, S, nH, hD, dt,
                                    False)
            for name, B, S, nH, hD, dt in BERT_KERNEL_CASES}
    torch.cuda.empty_cache()
    rows["resources"] = {k: v for k, v in resources.items()
                         if k.endswith("hD 64")}
    _log({"phase": "bert_kernel_resources", **rows["resources"]})
    rows["mlm_head"] = mlm_head_check(bert, bert.bert_large(), gen, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def _bert_split(step, hybrid, bert, cfg, p, o, batch, step_ms):
    """A profiled step by family (flash forward, flash backward, cuBLAS
    GEMMs, the rest), the MLM head alone (forward + backward on the
    step's encoder output: its GEMMs and the rest) and AdamW alone (CUDA
    events): the step's device time split into flash, GEMMs outside the
    head, the head, AdamW and other."""
    ids, lbl = batch
    prof = _profile(lambda: step(p, o, *batch), 1, step_ms,
                    list(BERT_FAMILIES), top_n=10)
    model = hybrid.bert_stage_model(cfg)
    with torch.no_grad():
        h = model.trunk(p, model.embed(p, ids))
    h.requires_grad_(True)
    leaves = [p["wte"], p["mlm_bias"], p["mlm_w"], p["mlm_b"],
              p["mlm_ln_g"], p["mlm_ln_b"], h]

    def head():
        loss = bert.mlm_masked_loss(p, h, lbl["mlm"], cfg)
        return torch.autograd.grad(loss, leaves)
    head()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head()
    torch.cuda.synchronize()
    head_prof = _profile(head, 1, (time.perf_counter() - t0) * 1e3, [],
                         top_n=6)
    _, grads = step.loss_and_grads(p, ids, lbl)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    hybrid.adamw_update(p, grads, o, hybrid.AdamWConfig())
    b.record()
    torch.cuda.synchronize()
    del grads
    dev = prof["device_ms"]
    head_ms = head_prof["device_busy_ms"]
    adamw_ms = a.elapsed_time(b)
    flash = dev["flash_fwd"] + dev["flash_bwd"]
    gemm_out = dev["matmul"] - head_prof["device_ms"]["matmul"]
    return {"step_profile": prof,
            "split_ms": {"flash": flash, "gemm_outside_head": gemm_out,
                         "mlm_head": head_ms, "adamw": adamw_ms,
                         "other": prof["device_busy_ms"] - flash - gemm_out
                         - head_ms - adamw_ms},
            "mlm_head_profile": {k: head_prof[k] for k in (
                "device_ms", "device_busy_ms", "top_kernels_ms_count_name")}}


def _bert_run(hybrid, TrainLoop, fa, prefetch, cfg, params, remat, steps,
              B=None):
    """A fresh copy of ``params`` and AdamW state, one warm step and
    ``steps`` steps through ``TrainLoop`` on batches of the seeded BERT
    loader through ``prefetch_to_device``: (row, step, p, o, last
    batch), the flash launches of the timed steps in the row."""
    B = BERT_B if B is None else B
    step, shard, init_opt = hybrid.build_train_step(
        cfg, model=hybrid.bert_stage_model(cfg, remat), device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    p = shard(params)
    o = init_opt(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = prefetch(bert_batches(cfg, 0, steps + 1, B,
                                    BERT_S), device=step.data_device)
    batch = next(batches)
    warm, p, o = step(p, o, *batch)
    torch.cuda.synchronize()
    fa.reset_launches()
    loop = TrainLoop(step, max_inflight=2)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    handles = []
    for batch in batches:
        handles.append(loop.step(p, o, *batch)[0])
    loop.drain()
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall / steps * 1e3
    row = {"remat": _plan_name(remat), "B": B, "S": BERT_S,
           "layers": cfg.num_layers, "dtype": str(cfg.dtype),
           "use_flash": cfg.use_flash,
           "losses": [warm.item()] + [float(d) for d in handles],
           "step_ms": step_ms, "step_ms_events": a.elapsed_time(b) / steps,
           "tokens_per_s": B * BERT_S / (step_ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "stall_s": loop.stall_seconds,
           "flash_launches": fa.launches()}
    if not all(np.isfinite(row["losses"])):
        raise AssertionError(f"BERT losses {row['losses']}")
    return row, step, p, o, batch


def _bert_launch_want(L, steps, remat, use_flash=None):
    if use_flash is False:
        return {f"flash_attention_{k}": 0 for k in ("fwd", "bwd_dkv",
                                                    "bwd_dq")}
    fwd = 2 if remat in (True, "dots_saveable") else 1
    return {"flash_attention_fwd": fwd * L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dq": L * steps}


def bert_training_phase(bert, hybrid, TrainLoop, fa, prefetch):
    """bert_large in bf16 at B 16, S 512 (bench_bert's card shape), MLM
    + NSP, AdamW, through ``build_train_step(model=bert_stage_model)``,
    ``TrainLoop`` and ``prefetch_to_device``: 1 warm + 4 timed steps
    (remat False; 24 launches of each flash kernel a step), a profiled
    split of a step; one step each under remat True and
    dots_saveable_attn (the warm and the next step's loss at LOSS_TOL of
    remat False's, so each plan's gradients are held through an update;
    then a profiled step);
    then 4 layers, use_flash=None against use_flash=False, 3 steps from
    one init (losses within BERT_PLAIN_TOL, the plain run launching no
    flash kernel)."""
    cfg = bert.bert_large(dtype=torch.bfloat16)
    L = cfg.num_layers
    params = bert.init_params(cfg, seed=0, device="cuda")
    row, step, p, o, batch = _bert_run(hybrid, TrainLoop, fa, prefetch, cfg,
                                       params, False, BERT_STEPS)
    want = _bert_launch_want(L, BERT_STEPS, False)
    if row["flash_launches"] != want:
        raise AssertionError(f"BERT flash launches {row['flash_launches']} "
                             f"!= {want}")
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"BERT losses do not fall: {row['losses']}")
    row["param_count"] = bert.param_count(params)
    row.update(_bert_split(step, hybrid, bert, cfg, p, o, batch,
                           row["step_ms"]))
    row["idle_share"] = row["step_profile"]["idle_share"]
    row["launches_per_step"] = {k: v / BERT_STEPS
                                for k, v in row["flash_launches"].items()}
    _log({"phase": "bert_training", "config": "bert_large bf16", **row})
    del step, p, o, batch
    plans = {}
    for remat in (True, "dots_saveable_attn"):
        r, rstep, rp, ro, rbatch = _bert_run(hybrid, TrainLoop, fa, prefetch,
                                             cfg, params, remat, 1)
        # one more step under the profiler: device time by family, the
        # idle share against the timed step's wall, the host's op time
        r["step_profile"] = _profile(lambda: rstep(rp, ro, *rbatch), 1,
                                     r["step_ms"], list(BERT_FAMILIES),
                                     top_n=10)
        r["idle_share"] = r["step_profile"]["idle_share"]
        del rstep, rp, ro, rbatch
        want = _bert_launch_want(L, 1, remat)
        # the warm step's loss (a forward before any update) and the
        # next one's, after an update from this plan's gradients
        diffs = [abs(x - y) for x, y in zip(r["losses"], row["losses"])]
        _log({"phase": "bert_remat", **r, "loss_diffs": diffs,
              "atol": LOSS_TOL})
        if r["flash_launches"] != want or not max(diffs) <= LOSS_TOL:
            raise AssertionError(f"BERT remat {remat}: launches "
                                 f"{r['flash_launches']} (want {want}), "
                                 f"losses {r['losses']} vs "
                                 f"{row['losses'][:2]}")
        plans[_plan_name(remat)] = r
    row["remat_plans"] = plans
    del params
    # the kernels against the plain composition, 4 layers from one init
    cut = bert.bert_large(dtype=torch.bfloat16, num_layers=BERT_PLAIN_LAYERS)
    params = bert.init_params(cut, seed=0, device="cuda")
    runs = {}
    for use_flash in (None, False):
        c = dataclasses.replace(cut, use_flash=use_flash)
        r, *rest = _bert_run(hybrid, TrainLoop, fa, prefetch, c, params,
                             False, BERT_PLAIN_STEPS)
        del rest
        want = _bert_launch_want(BERT_PLAIN_LAYERS, BERT_PLAIN_STEPS, False,
                                 use_flash)
        if r["flash_launches"] != want:
            raise AssertionError(f"BERT use_flash={use_flash}: launches "
                                 f"{r['flash_launches']} != {want}")
        runs[str(use_flash)] = r
    diffs = [abs(a - b) for a, b in zip(runs["None"]["losses"],
                                        runs["False"]["losses"])]
    cmp = {"layers": BERT_PLAIN_LAYERS, "losses_flash": runs["None"]["losses"],
           "losses_plain": runs["False"]["losses"], "loss_diffs": diffs,
           "atol": BERT_PLAIN_TOL,
           "step_ms": {k: r["step_ms"] for k, r in runs.items()},
           "peak_memory_bytes": {k: r["peak_memory_bytes"]
                                 for k, r in runs.items()}}
    _log({"phase": "bert_plain_attention", **cmp})
    if not max(diffs) <= BERT_PLAIN_TOL:
        raise AssertionError(f"BERT flash vs plain losses: {cmp}")
    row["plain_attention"] = cmp
    del params
    torch.cuda.empty_cache()
    return row


def bert_float32_phase(bert, hybrid, TrainLoop, fa, prefetch):
    """bert_large at its default dtype (float32, the TF32x3 flash
    kernels) cut to 4 layers, B 4, S 512: 1 warm + 4 steps through
    ``TrainLoop`` (4 launches of each flash kernel a step), against the
    same run through the plain composition (use_flash=False): each
    step's loss within BERT_F32_LOSS_REL."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 phase entered with TF32 matmuls on")
    cfg = bert.bert_large(num_layers=BERT_F32_LAYERS)
    if cfg.dtype != torch.float32 or cfg.use_flash is not None:
        raise AssertionError(f"bert_large defaults: {cfg.dtype}, "
                             f"use_flash={cfg.use_flash}")
    params = bert.init_params(cfg, seed=0, device="cuda")
    runs = {}
    for use_flash in (None, False):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        r, step, p, o, batch = _bert_run(hybrid, TrainLoop, fa, prefetch, c,
                                         params, False, BERT_STEPS,
                                         B=BERT_F32_B)
        want = _bert_launch_want(BERT_F32_LAYERS, BERT_STEPS, False,
                                 use_flash)
        if r["flash_launches"] != want:
            raise AssertionError(f"BERT float32 use_flash={use_flash}: "
                                 f"launches {r['flash_launches']} != {want}")
        if use_flash is None:
            prof = _profile(lambda: step(p, o, *batch), 1, r["step_ms"],
                            list(BERT_FAMILIES), top_n=8)
            r.update({k: prof[k] for k in ("device_ms", "device_busy_ms",
                                           "idle_share", "sm_clock_power")})
        del step, p, o, batch
        runs[str(use_flash)] = r
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["None"]["losses"],
                                               runs["False"]["losses"])]
    row = {"config": f"bert_large float32, {BERT_F32_LAYERS} layers",
           "flash": runs["None"], "plain": runs["False"], "loss_rel": rel,
           "rtol": BERT_F32_LOSS_REL}
    _log({"phase": "bert_float32", **row})
    if not max(rel) <= BERT_F32_LOSS_REL:
        raise AssertionError(f"BERT float32 flash vs plain losses: {rel}")
    del params
    torch.cuda.empty_cache()
    return row


def ctc_phase(nnf):
    """``nn.functional.ctc_loss`` at bench_ctc's card shape (T 500, B 32,
    L 100, C 80, Dirichlet log-probs, full lengths): the card's loss and
    gradient held to the CPU run of the same code (CTC_LOSS_REL,
    CTC_GRAD_REL); forward + backward timed (median of CTC_REPS,
    synchronised) in sequences a second, and one call profiled (device
    busy against wall: the idle share)."""
    T, B, L, C = (CTC_SHAPE[k] for k in ("T", "B", "L", "C"))
    rng = np.random.default_rng(0)
    lp = np.log(rng.dirichlet(np.ones(C), size=(T, B)).astype("f4"))
    host = [torch.tensor(lp), torch.tensor(rng.integers(1, C, (B, L))),
            torch.full((B,), T, dtype=torch.int64),
            torch.full((B,), L, dtype=torch.int64)]
    out = {}
    for dev in ("cpu", "cuda"):
        x, *rest = (t.to(dev) for t in host)
        x.requires_grad_(True)

        def run():
            loss = nnf.ctc_loss(x, *rest)
            return loss, torch.autograd.grad(loss, x)[0]
        loss, grad = run()
        out[dev] = (loss.item(), grad.cpu())
    card, cpu = out["cuda"], out["cpu"]
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel = ((card[1] - cpu[1]).abs().max()
                / cpu[1].abs().max()).item()
    times = []
    for _ in range(CTC_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    prof = _profile(run, 1, ms, [], top_n=6)
    row = {"phase": "ctc", "shape": dict(CTC_SHAPE), "loss_card": card[0],
           "loss_cpu": cpu[0], "loss_rel": loss_rel,
           "grad_rel_of_max": grad_rel, "loss_rtol": CTC_LOSS_REL,
           "grad_rtol_of_max": CTC_GRAD_REL, "fwd_bwd_ms": ms,
           "fwd_bwd_ms_runs": times, "seq_per_s": B / (ms / 1e3),
           **{k: prof[k] for k in ("device_busy_ms", "idle_share",
                                   "kernels_per_step", "host_op_self_ms",
                                   "sm_clock_power")}}
    _log(row)
    if not (loss_rel <= CTC_LOSS_REL and grad_rel <= CTC_GRAD_REL):
        raise AssertionError(f"ctc_loss card vs CPU: loss {loss_rel}, "
                             f"grad {grad_rel}")
    return row


def _flash_cell(r, key):
    """One kernel's numbers from a ``flash_kernel_case`` row: ``key`` is
    fwd, dkv or dq (SDPA's backward computes dq, dk and dv in one
    call)."""
    err = {"fwd": ("out",), "dkv": ("dk", "dv"), "dq": ("dq",)}[key]
    return {"shape": r["shape"],
            "max_abs_err": max(r["max_abs_err"][x] for x in err),
            "limit_share": max(r["limit_share"][x] for x in err),
            "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
            "bound_ms": r["bounds"][key]["bound_ms"],
            "bound_by": r["bounds"][key]["bound_by"],
            "bound_share": r["bound_share"][key],
            "library_ms": r["fwd_library_ms" if key == "fwd"
                            else "bwd_library_ms"]}


ONLY_PHASES = {"train_kernel": train_kernel_phase,
               "float32_training": float32_training_phase,
               "ring_kernel": ring_kernel_phase,
               "compiled_serving": compiled_serving_alone,
               "serving_faults": serving_faults_alone,
               "tiered_serving": tiered_serving_alone,
               "handoff_serving": handoff_serving_alone,
               "rms_kernel": rms_kernel_phase,
               "train_slice": train_slice_alone,
               "bert_kernel": bert_kernel_phase,
               "bert_training": bert_training_phase,
               "bert_float32": bert_float32_phase,
               "ctc": ctc_phase}
_SERVING_SOURCES = ("flash_decode", "fused_decode", "row_gemm", "sampling")
ONLY_SOURCES = {"compiled_serving": _SERVING_SOURCES,
                "serving_faults": _SERVING_SOURCES,
                "tiered_serving": _SERVING_SOURCES,
                "handoff_serving": _SERVING_SOURCES,
                "rms_kernel": ("rms_norm",),
                "ctc": ()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON")
    ap.add_argument("--phases", help="comma-separated names of ONLY_PHASES: "
                    "build their sources (the training kernels' two, the "
                    "serving kernels' four) and run just these phases (no "
                    "kernels line, no device line)")
    ap.add_argument("--preempt-child", choices=("first", "resume"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--preempt-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # deterministic cuBLAS for the preemption phase's bit-for-bit resume:
    # read when the first cuBLAS handle is made, so set before any work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch").is_dir():
        print(f"chip_smoke: no paddle_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.preempt_child:
        # one process of the preemption phase: "first" leaves through
        # PreemptionGuard (exit 143), "resume" writes its result
        out = preempt_run(args.preempt_child, args.preempt_dir)
        with open(os.path.join(args.preempt_dir,
                               f"{args.preempt_child}.json"), "w") as f:
            json.dump(out, f)
        return 0
    global _LOG_FILE
    if args.out:
        _LOG_FILE = Path(args.out).with_suffix(".log.jsonl")
        _LOG_FILE.parent.mkdir(parents=True, exist_ok=True)
        _LOG_FILE.write_text("")
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.distributed import hybrid
    from paddle_tpu_torch.incubate.nn.kernels import _build
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.kernels import flash_decode as fd
    from paddle_tpu_torch.incubate.nn.kernels import fused_ce as fce
    from paddle_tpu_torch.incubate.nn.kernels import fused_decode as fdl
    from paddle_tpu_torch.incubate.nn.kernels import fused_norm_rope as fnr
    from paddle_tpu_torch.incubate.nn.kernels import ring_attention as ra
    from paddle_tpu_torch.incubate.nn.kernels import row_gemm as rg
    from paddle_tpu_torch.incubate.nn.kernels import sampling as sm
    from paddle_tpu_torch.incubate.nn import kv_quant as kvq
    from paddle_tpu_torch.inference import programs
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingEngine, FusedB1Engine,
        PagedContinuousBatchingEngine, SpeculativeConfig)
    from paddle_tpu_torch.jit.loop import TrainLoop
    from paddle_tpu_torch.models import (bert, common, decoding, gpt, llama,
                                         prng)
    from paddle_tpu_torch.nn import functional as nnf
    from paddle_tpu_torch.models.common import matmul_f32out

    card = _nvidia_smi("name,power.limit")
    print(card, flush=True)
    _log({"phase": "setup", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})
    only = args.phases.split(",") if args.phases else None
    if only and not set(only) <= set(ONLY_PHASES):
        print(f"chip_smoke: --phases takes {sorted(ONLY_PHASES)}",
              file=sys.stderr)
        return 2
    sources = (sorted({s for name in only for s in ONLY_SOURCES.get(
                   name, ("flash_attention", "fused_ce"))}) if only else
               ["flash_decode", "flash_attention", "fused_ce", "fused_decode",
                "rms_norm", "row_gemm", "sampling"])
    t0 = time.perf_counter()
    # the resource report reads flash_attention.cu's: a --phases run
    # without it makes none
    ptxas = (_flash_ptxas_start(_build, [s for s in PTXAS_SOURCES
                                         if s in sources])
             if "flash_attention" in sources else {})
    try:
        libs = _build.build(sources)
    except BaseException:
        for proc, _ in ptxas.values():
            proc.kill()
            proc.wait()
        raise
    build_s = time.perf_counter() - t0
    _log({"phase": "build", "seconds": build_s,
          "libraries": [p.name for p in libs.values()]})
    resources = new_resources = {}
    if ptxas:
        resources, new_resources = flash_resources(ptxas, _build)
        _log({"phase": "flash_attention_resources", "kernels": resources})
        _log({"phase": "kernel_resources", "kernels": new_resources})

    seconds = {}
    engines = (ContinuousBatchingEngine, PagedContinuousBatchingEngine,
               FusedB1Engine)

    def timed(name, phase, *a):
        """Run one phase and keep its seconds (host clock, synchronised)."""
        t = time.perf_counter()
        out = phase(*a)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    if only:
        args_of = {"train_kernel": (fa, fce, matmul_f32out),
                   "float32_training": (gpt, hybrid, TrainLoop, fa, fce),
                   "ring_kernel": (fa,),
                   "compiled_serving": (gpt, (
                       ContinuousBatchingEngine,
                       PagedContinuousBatchingEngine, FusedB1Engine),
                       programs),
                   "serving_faults": (gpt, (
                       ContinuousBatchingEngine,
                       PagedContinuousBatchingEngine, FusedB1Engine),
                       SpeculativeConfig, programs, (fd, rg, fdl, sm)),
                   "tiered_serving": (gpt, engines, fd, rg, fdl),
                   "handoff_serving": (gpt, engines, fd, rg, fdl),
                   "rms_kernel": (fnr,),
                   "train_slice": (gpt, hybrid, TrainLoop, fa),
                   "bert_kernel": (fa, resources),
                   "bert_training": (bert, hybrid, TrainLoop, fa,
                                     tio.prefetch_to_device),
                   "bert_float32": (bert, hybrid, TrainLoop, fa,
                                    tio.prefetch_to_device),
                   "ctc": (nnf,)}
        for name in only:
            timed(name, ONLY_PHASES[name], *args_of[name])
        seconds["total_with_build"] = time.perf_counter() - t0
        _log({"phase": "phase_seconds", "card": card, "build_s": build_s,
              **seconds})
        return 0

    kernels = timed("kernel", kernel_phase, fd)
    gemm_rows = timed("row_gemm", row_gemm_phase, rg, new_resources)
    sampler = timed("sampling_kernel", sampling_kernel_phase, sm, decoding,
                    prng, libs["sampling"])
    paged_kernels = timed("paged_kernel", paged_kernel_phase, fd, kvq)
    train_kernels = timed("train_kernel", train_kernel_phase, fa, fce,
                          matmul_f32out)
    rounding = timed("rounding_witness", rounding_witness_phase, fa)
    timed("reference", reference_phase, gpt, ContinuousBatchingEngine)
    timed("paged_reference", paged_reference_phase, gpt,
          ContinuousBatchingEngine, PagedContinuousBatchingEngine)
    f32_launches = timed("train_reference", train_reference_phase, gpt,
                         hybrid, fa, fce)
    spec_reference = timed("speculative_reference",
                           speculative_reference_phase, gpt, llama, engines,
                           SpeculativeConfig, fd, fdl, fnr)
    prefix_reference = timed("prefix_reference", prefix_reference_phase,
                             gpt, engines, rg)
    sampled_reference = timed("sampled_reference", sampled_reference_phase,
                              gpt, decoding, prng, engines,
                              SpeculativeConfig, sm)
    cfg, params, serving, launches, streams = timed(
        "serving", serving_phase, gpt, ContinuousBatchingEngine, fd, rg)
    steps = timed("compare", compare_phase, gpt, cfg, params)
    kv_runs, kv_streams = timed(
        "paged_serving", paged_serving_phase, gpt, ContinuousBatchingEngine,
        PagedContinuousBatchingEngine, fd, cfg, params, streams)
    paged_steps = timed("paged_compare", paged_compare_phase, gpt, cfg,
                        params)
    qparams = gpt.quantize_decode_params(params, cfg)
    spec_runs = timed(
        "speculative_serving", speculative_serving_phase, gpt, engines,
        SpeculativeConfig, fd, fdl, fnr, cfg, params, qparams,
        {("contiguous", "bf16"): serving, **kv_runs},
        {("contiguous", "bf16"): streams, **kv_streams})
    prefix_runs = timed("prefix_serving", prefix_serving_phase, gpt, engines,
                        fd, rg, fdl, cfg, params, qparams)
    sampled = timed(
        "sampled_serving", sampled_serving_phase, gpt, decoding, engines, sm,
        fd, rg, cfg, params, {
            ("contiguous", "none"): serving,
            ("paged", "none"): kv_runs[("paged", "bf16")],
            ("contiguous", "ngram"): spec_runs[("contiguous", "bf16",
                                                "ngram")],
            ("paged", "ngram"): spec_runs[("paged", "bf16", "ngram")]})
    fault_keep = {}
    compiled = timed("compiled_serving", compiled_serving_phase, gpt, engines,
                     programs, cfg, params, qparams, fault_keep)
    faults = timed("serving_faults", serving_faults_phase, gpt, engines,
                   SpeculativeConfig, programs, (fd, rg, fdl, sm), cfg, params,
                   fault_keep)
    del fault_keep
    torch.cuda.empty_cache()
    tiered = timed("tiered_serving", tiered_serving_phase, gpt, engines, fd,
                   rg, fdl, cfg, params, qparams)
    handoffs = timed("handoff_serving", handoff_serving_phase, gpt, engines,
                     fd, rg, fdl, cfg, params, qparams, tiered["bounds"])
    del params
    torch.cuda.empty_cache()
    fused_kernels = timed("fused_kernel", fused_kernel_phase, fdl, kvq, gpt,
                          cfg, qparams)
    timed("fused_reference", fused_reference_phase, gpt, FusedB1Engine, fdl)
    fused_runs, b1_steps = timed(
        "fused_serving", fused_serving_phase, gpt, ContinuousBatchingEngine,
        FusedB1Engine, fd, fdl, cfg, qparams)
    del qparams
    torch.cuda.empty_cache()
    training, fa_launches, ce_launches = timed(
        "training", training_phase, gpt, hybrid, TrainLoop, fa, fce)
    torch.cuda.empty_cache()
    plain_training = timed("plain_training", plain_training_phase, gpt,
                           hybrid, fa, training["losses"])
    # the GPT trees are gone with their phases
    torch.cuda.empty_cache()
    f32_training = timed("float32_training", float32_training_phase, gpt,
                         hybrid, TrainLoop, fa, fce)
    torch.cuda.empty_cache()
    rms_kernels = timed("rms_kernel", rms_kernel_phase, fnr)
    llama_kernels = timed("llama_kernel", llama_kernel_phase, fa, fd)
    timed("llama_reference", llama_reference_phase, llama, fnr, fd)
    llama_gen, llama_loop = timed("llama_serving", llama_serving_phase,
                                  llama, common, fnr, fa, fd)
    torch.cuda.empty_cache()
    ring_kernels = timed("ring_kernel", ring_kernel_phase, fa)
    ring_replays = timed("ring_replay", ring_replay_phase, fa, ra)
    timed("llama_train_reference", llama_train_reference_phase, llama,
          hybrid, fa, fnr)
    llama_train, train_state = timed("llama_train", llama_train_phase, llama,
                                     hybrid, TrainLoop, fa, fnr)
    llama_sp = timed("llama_sp", llama_sp_phase, llama, fa, *train_state)
    del train_state
    torch.cuda.empty_cache()
    prefetch = tio.prefetch_to_device
    plans = timed("remat_plans", remat_plans_phase, gpt, hybrid, TrainLoop,
                  fa, prefetch)
    remat_fit = timed("remat_fit", remat_fit_phase, gpt, hybrid, TrainLoop,
                      fa, prefetch, plans)
    prefetched = timed("prefetch", prefetch_phase, gpt, hybrid, fa, prefetch,
                       tio, plans)
    plan_rows = plans["rows"]
    del plans
    torch.cuda.empty_cache()
    train_ckpt = timed("train_checkpoint", train_checkpoint_phase, gpt,
                       hybrid, TrainLoop, prefetch)
    preemption = timed("preemption", preemption_phase, gpt, hybrid)
    bert_kernels = timed("bert_kernel", bert_kernel_phase, fa, resources)
    bert_train = timed("bert_training", bert_training_phase, bert, hybrid,
                       TrainLoop, fa, prefetch)
    bert_f32 = timed("bert_float32", bert_float32_phase, bert, hybrid,
                     TrainLoop, fa, prefetch)
    ctc = timed("ctc", ctc_phase, nnf)
    seconds["total_with_build"] = time.perf_counter() - t0
    _log({"phase": "phase_seconds", "card": card, "build_s": build_s,
          **seconds})

    src = "paddle_tpu_torch/incubate/nn/kernels/csrc/"
    ref = "paddle_tpu/incubate/nn/kernels/"
    dec, tr, ce = kernels[0], train_kernels["train"], train_kernels["fused_ce"]
    entries = [{
        "name": "flash_decode", "route": "cuda",
        "source": src + "flash_decode.cu",
        "replaces": ref + "flash_decode.py:67",
        "launches": launches, "max_abs_err": dec["max_abs_err"],
        "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shape": dec["shape"],
        "plan": dec["plan"],
        "instance_launches": serving["instance_launches"],
        # the window cases: verify (split-KV), prefill (tensor cores)
        "cases": [{k: r[k] for k in (
            "name", "shape", "plan", "max_abs_err", "limit_share",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for r in kernels[1:]]}]
    # the paged layout and the quantized modes: launches from the run of
    # the engine and kv_dtype that serves them
    for name, case, line, run, key in (
            ("flash_decode_paged", "paged_decode", 253, ("paged", "bf16"),
             "paged"),
            ("flash_decode_paged_int8", "paged_decode_int8", 84,
             ("paged", "int8"), "paged"),
            ("flash_decode_paged_fp8", "paged_decode_fp8", 84,
             ("paged", "fp8"), "paged"),
            ("flash_decode_int8", "decode_int8", 84, ("contiguous", "int8"),
             "mode_int8"),
            ("flash_decode_fp8", "decode_fp8", 84, ("contiguous", "fp8"),
             "mode_fp8")):
        row = paged_kernels[case]
        entries.append({
            "name": name, "route": "cuda", "source": src + "flash_decode.cu",
            "replaces": ref + f"flash_decode.py:{line}",
            "launches": kv_runs[run]["launches"][key],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "plan": row["plan"]})
    # the port's own kernel: the decode block's products (no TPU kernel
    # stands behind it); launches from the main serving run, times at
    # M 8 (decode), the verify windows' and suffix passes' M 32-256
    # beside; a decode step's and a verify pass's device time and
    # row_gemm's share of it, logged beside the kernel's first design
    # (mma.sync, 64-row launches; measured the same way on an H100 80GB
    # HBM3 at 700 W)
    g8 = gemm_rows[("qkv", 8)]
    verify = spec_runs["verify_rows"][("contiguous", "bf16")]["profiles"]
    step_ms = {
        "decode_step_device_ms": steps["flash"]["device_busy_ms"],
        "decode_step_row_gemm_ms": steps["flash"]["device_ms"]["row_gemm"],
        "verify_pass_device_ms": verify["verify"]["device_busy_ms"],
        "verify_pass_row_gemm_ms": verify["verify"]["device_ms"]["row_gemm"]}
    _log({"phase": "row_gemm_step", **step_ms,
          "first_design": {"decode_step_device_ms": 2.646,
                                "decode_step_matmul_ms": 1.342,
                                "verify_pass_device_ms": 3.665,
                                "verify_pass_matmul_ms": 1.779}})
    entries.append({
        "name": "row_gemm", "route": "cuda", "source": src + "row_gemm.cu",
        "replaces": "none: paddle_tpu/models/gpt.py:520 (_wmm) and :300 "
                    "(logits_from_hidden, the tied head) are XLA einsums, "
                    "no Pallas kernel",
        "launches": serving["row_gemm_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in gemm_rows.values()),
        "ms": g8["kernel_ms"], "plain_ms": g8["plain_ms"],
        "bound_ms": g8["bound_ms"], "bound_by": g8["bound_by"],
        "library_ms": g8["library_ms"], "shape": g8["shape"],
        "cases": [{k: r[k] for k in (
            "name", "shape", "plan", "max_abs_err", "limit_share",
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share") if k in r} for r in gemm_rows.values()
            if "kernel_ms" in r],
        "prefix_serving_launches": {
            f"{a} {b}": r["launches"].get("row_gemm")
            for (a, b), r in prefix_runs.items()},
        "host_us_per_call": {r["name"]: r["host_us_per_call"]
                             for r in gemm_rows.values()
                             if "host_us_per_call" in r},
        **step_ms})
    for name, key, line, err in (
            ("flash_attention_fwd", "fwd", 342, "out"),
            ("flash_attention_bwd_dkv", "dkv", 475, "dk"),
            ("flash_attention_bwd_dq", "dq", 711, "dq")):
        e = tr["max_abs_err"][err] if key != "dkv" else max(
            tr["max_abs_err"]["dk"], tr["max_abs_err"]["dv"])
        entries.append({
            "name": name, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": ref + f"flash_attention.py:{line}",
            "launches": fa_launches[name], "max_abs_err": e,
            "ms": tr[f"{key}_ms"], "plain_ms": tr[f"{key}_plain_ms"],
            "bound_ms": tr["bounds"][key]["bound_ms"],
            "bound_by": tr["bounds"][key]["bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": tr["fwd_library_ms" if key == "fwd"
                             else "bwd_library_ms"],
            "shape": tr["shape"]})
    # the float32 instances: launches from gpt3_1p3b's default-dtype
    # training (4 steps; the gpt_tiny reference phase's beside), timed at
    # [2, 1024, 16x128]; all three as three TF32 products on the tensor
    # cores (the bound at the TF32 rate, the CUDA cores' beside)
    f32 = train_kernels["train_f32"]
    emu = f32["tf32x3_emulation"]
    for e in entries[-3:]:
        key = e["name"].replace("flash_attention_", "").replace("bwd_", "")
        grads = {"fwd": ("out", "lse"), "dkv": ("dk", "dv"),
                 "dq": ("dq",)}[key]
        e["float32"] = {
            "kernel": f"{e['name']}_tf32x3_kernel",
            "shape": f32["shape"],
            "launches": f32_training["launches_4_steps"][e["name"]],
            "reference_launches": f32_launches.get(e["name"], 0),
            "ms": f32[f"{key}_ms"], "plain_ms": f32[f"{key}_plain_ms"],
            "bound_ms": f32["bounds"][key]["bound_ms"],
            "bound_by": f32["bounds"][key]["bound_by"],
            "bound_ffma_ms": f32["bounds"][f"{key}_ffma"]["bound_ms"],
            "max_abs_err": max(f32["max_abs_err"][g] for g in grads
                               if g != "lse"),
            "tf32x3_emulation_share": {g: emu[g] for g in grads},
            "single_pass_witness": train_kernels["tf32_witness"][
                "flash_attention_fwd" if key == "fwd"
                else "flash_attention_bwd"],
            "library_ms": f32["fwd_library_ms" if key == "fwd"
                              else "bwd_library_ms"]}
    ce32 = train_kernels["fused_ce_f32"]
    entries.append({
        "name": "fused_ce_fwd", "route": "cuda",
        "source": src + "fused_ce.cu", "replaces": ref + "fused_ce.py:55",
        "launches": ce_launches, "max_abs_err": ce["max_abs_err"],
        "ms": ce["ms"], "plain_ms": ce["plain_ms"],
        "bound_ms": ce["bound_ms"], "bound_by": ce["bound_by"],
        "library_ms": ce["library_ms"], "shape": ce["shape"],
        "plan": {"splits": ce["plan"][0], "tiles_per_split": ce["plan"][1]},
        "float32": {"kernel": "fused_ce_fwd_tf32x3_kernel + "
                              "fused_ce_merge_kernel",
                    "launches": f32_training["eval_launches"]["fused_ce_fwd"],
                    "reference_launches": f32_launches["fused_ce_fwd"],
                    "bound_ffma_ms": ce32["ffma"]["bound_ms"],
                    "tf32x3_emulation_err": ce32["tf32x3_emulation_err"],
                    "single_pass_witness": train_kernels["tf32_witness"][
                        "fused_ce"],
                    "plan": {"splits": ce32["plan"][0],
                             "tiles_per_split": ce32["plan"][1]},
                    **{k: ce32[k] for k in ("shape", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "max_abs_err")}}})
    # the fused layer stack: launches from the full-width run of the
    # kv_dtype that serves each storage mode, time and bound at pos 512
    for name, kd in (("fused_decode_layers", "bf16"),
                     ("fused_decode_layers_int8", "int8"),
                     ("fused_decode_layers_fp8", "fp8")):
        row = fused_kernels[kd]
        t = row["timed"]["512"]
        entries.append({
            "name": name, "route": "cuda", "source": src + "fused_decode.cu",
            "replaces": ref + "fused_decode.py:84",
            "launches": fused_runs[("fused", kd)]["launches"]["fused_decode"],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": row["plain_ms_at_512"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_share": t["bound_share"],
            "barriers": row["barriers_per_token"], "grid": row["grid"],
            # no single library call computes a layer stack
            "library_ms": None,
            "per_op_int8_step_ms": b1_steps[kd]["per_op_int8_step_ms"],
            "shape": row["shape"] + ", pos 512"})
    # the LLaMA path's shapes of the two attention kernels, launches from
    # the llama_7b runs (flash_decode: the slot loop's decode steps and
    # prefill_into_slots calls together)
    def at_llama(launches, *names):
        return {"launches": launches, "cases": [
            {k: llama_kernels[n][k] for k in (
                "name", "shape", "plan", "max_abs_err", "limit_share",
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in llama_kernels[n]}
            for n in names]}

    # the speculative runs (k 3): their launch counts, and the kernel's
    # device ms in one profiled verify pass against one decode step
    def spec_cell(kind, kd, family="flash_decode"):
        rows = spec_runs["verify_rows"][(kind, kd)]["profiles"]
        return {"launches": {f"{r['draft']}": r["launches"] for r in (
                    spec_runs[(kind, kd, dr)] for dr in ("ngram", "self")
                    if (kind, kd, dr) in spec_runs)},
                "verify_rounds": {r["draft"]: r["verify_rounds"] for r in (
                    spec_runs[(kind, kd, dr)] for dr in ("ngram", "self")
                    if (kind, kd, dr) in spec_runs)},
                "verify_pass_kernel_ms":
                    rows["verify"]["device_ms"][family],
                "decode_step_kernel_ms":
                    rows["decode_step"]["device_ms"][family]}

    fused_spec = spec_runs["fused"]
    for e in entries:
        if e["name"] == "flash_decode":
            e["speculative"] = spec_cell("contiguous", "bf16")
        elif e["name"] == "flash_decode_paged":
            e["speculative"] = spec_cell("paged", "bf16")
        elif e["name"] == "flash_decode_paged_int8":
            e["speculative"] = spec_cell("paged", "int8")
        elif e["name"] == "fused_decode_layers":
            e["speculative"] = {
                "launches": fused_spec["runs"]["ngram"]["launches"],
                "verify_launches":
                    fused_spec["runs"]["ngram"]["verify_launches"],
                "verify_window_kernel_ms": fused_spec["profiles"][
                    "verify"]["device_ms"]["fused_decode"],
                "decode_step_kernel_ms": fused_spec["profiles"][
                    "decode_step"]["device_ms"]["fused_decode"]}
    for e in entries:
        if e["name"] == "flash_decode":
            e["llama_7b"] = at_llama(llama_loop["launches"]["flash_decode"],
                                     "llama_decode",
                                     "llama_prefill_into_slots")
        elif e["name"] == "flash_attention_fwd":
            e["llama_7b"] = at_llama(
                llama_gen["launches"]["flash_attention_fwd"], "llama_prefill")
        if e["name"].startswith("flash_attention_"):
            # the same kernels on the llama_7b training run (4 steps)
            e["llama_7b_train_launches"] = \
                llama_train["launches_4_steps"][e["name"]]
            # launches a gpt3_1p3b step (B 8, S 1024) under each remat plan
            e["remat_plan_launches_per_step"] = {
                name: r["flash_launches_per_step"][e["name"]]
                for name, r in plan_rows.items()}
            # bert_large's non-causal head-dim-64 instances: launches a
            # step of the bf16 training run and of the float32 cell (4
            # layers), times at their shapes
            key = e["name"].replace("flash_attention_", "").replace(
                "bwd_", "")
            e["bert_large"] = {
                "launches_per_step": bert_train["launches_per_step"][
                    e["name"]],
                "remat_launches_one_step": {
                    n: r["flash_launches"][e["name"]]
                    for n, r in bert_train["remat_plans"].items()},
                **_flash_cell(bert_kernels["bert_bf16"], key)}
            e["float32"]["bert_large"] = {
                "launches_per_step": bert_f32["flash"]["flash_launches"][
                    e["name"]] / BERT_STEPS,
                **_flash_cell(bert_kernels["bert_f32"], key)}
    # RMSNorm: the forward, the fused residual-add instance and the
    # backward of csrc/rms_norm.cu, one entry per instance and policy;
    # forward and fused instance timed at the prefill rows of llama_7b
    # (4 x 512, bf16) with the decode rows (8) beside, the backward at
    # llama_7b training's rows (4 x 2048); launches from the llama_7b
    # runs (generate and the slot loop; the backward: the 4 timed
    # training steps)
    train_rows = f"{RMS_TRAIN_ROWS[0]} {RMS_TRAIN_ROWS[1]}"
    for name, kind, policy, replaces, note in (
            ("rms_norm", "fwd", "fused", ref + "fused_norm_rope.py:33",
             "no path of the JAX package calls rms_norm_pallas, so the "
             "LLaMA runs launch this policy no time; the same kernels "
             "carry the path under policy llama"),
            ("rms_norm_llama", "fwd", "llama",
             "paddle_tpu/models/llama.py:117",
             "an XLA function in the JAX package, not a Pallas kernel: "
             "layer 0's attention norm of every LLaMA forward pass"),
            ("add_rms_norm", "add", "fused", ref + "fused_norm_rope.py:33",
             "the fused residual-add instance in the TPU kernel's "
             "policy: on no path"),
            ("add_rms_norm_llama", "add", "llama",
             "paddle_tpu/models/llama.py:117 with the residual add "
             "before it (h = h + ..., :127-130)",
             "every other RMSNorm of the LLaMA path, the residual add "
             "fused in"),
            ("rms_norm_bwd", "bwd", "fused", ref + "fused_norm_rope.py:33 "
             "(the custom VJP _rms2d_bwd, XLA)",
             "the TPU kernel's backward is XLA: on no path"),
            ("rms_norm_bwd_llama", "bwd", "llama",
             "paddle_tpu/models/llama.py:117 (its autodiff gradient, "
             "XLA)", "every RMSNorm backward of LLaMA training")):
        big = (train_rows if kind == "bwd" else "2048 4096")
        row = rms_kernels[(kind, policy) + tuple(
            int(v) for v in big.split()) + ("bfloat16",)]
        dec = rms_kernels[(kind, policy, 8, 4096, "bfloat16")]
        key = {"fwd": f"rms_{policy}", "add": f"rms_add_{policy}",
               "bwd": f"rms_bwd_{policy}"}[kind]
        if kind == "bwd":
            launches = llama_train["launches_4_steps"].get(key, 0)
        else:
            launches = (llama_gen["launches"][key]
                        + llama_loop["launches"][key])
        entries.append({
            "name": name, "route": "cuda", "source": src + "rms_norm.cu",
            "replaces": replaces, "note": note, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for (k, p, *_), r in
                               rms_kernels.items()
                               if k == kind and p == policy),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_share": row["bound_share"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "decode_shape": {k: dec[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_share",
                "library_ms")},
            "cases": [{k: r[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_share", "max_abs_err")}
                for (k, p, *_), r in rms_kernels.items()
                if k == kind and p == policy]})
        if kind != "bwd":
            entries[-1]["llama_7b_train_launches"] = \
                llama_train["launches_4_steps"].get(key, 0)
    # the ring variant (a run-time offset): launches from the sequence-
    # parallel loss and gradients at the training config (a one-rank
    # ring: offset 0 each layer, [4, 2048, 32x128] bf16); times, bound
    # and SDPA with the offset's mask at that shape and offset, the ring
    # chunk of llama_7b ([1, 1024]) at every offset beside
    def ring_cell(r, key, err):
        lib = "fwd_library_ms" if key == "fwd" else "bwd_library_ms"
        return {"max_abs_err": max(r["max_abs_err"][x] for x in err),
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r["bounds"][key]["bound_ms"],
                "bound_by": r["bounds"][key]["bound_by"],
                # SDPA with the boolean mask; its backward computes dq,
                # dk and dv in one call
                "library_ms": r[lib]}

    at_train = ring_kernels[("train bfloat16", 0)]
    for kernel, key, line, err in (("fwd", "fwd", 342, ("out",)),
                                   ("bwd_dkv", "dkv", 475, ("dk", "dv")),
                                   ("bwd_dq", "dq", 711, ("dq",))):
        name = f"{RING}_{kernel}"
        entries.append({
            "name": name, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": ref + f"flash_attention.py:{line} (traced_offset, "
                              f"via flash_attention_with_lse :1023)",
            "launches": llama_sp["offset_launches"][name],
            **ring_cell(at_train, key, err),
            "shape": at_train["shape"] + ", offset 0",
            "offsets": [{"shape": r["shape"], "offset": off,
                         **ring_cell(r, key, err)}
                        for (_, off), r in ring_kernels.items()],
            "ring_replay_launches": ring_replays["bfloat16"]["launches"][
                name]})
        # the zero-offset entry launches the same kernel with the same
        # arguments at the training run's shape (bit for bit, above)
        zero = next(e for e in entries
                    if e["name"] == f"flash_attention_{kernel}")
        zero["llama_7b_train"] = {
            "shape": at_train["shape"],
            "timed_under": f"{RING} at offset 0",
            **ring_cell(at_train, key, err)}
    # the port's sampler (no TPU kernel behind it): launches from the
    # sampled serving cell's plain contiguous run, time and bound at a
    # decode step's [8, 50304] under the serving setting, the other cases
    # and temperature alone beside; max_abs_err is the largest gap of
    # perturbed scores where a kernel token differed from the plain draw
    # over the exact rule's kept values (0: every token equal)
    dec_s = sampler["cases"]["decode"][SAMPLINGS[0][0]]
    draws = sampled["profiles"]
    entries.append({
        "name": "sampling_filter_draw", "route": "cuda",
        "source": src + "sampling.cu",
        "replaces": "none: paddle_tpu/models/decoding.py:25 (_filter_logits) "
                    "and :52 / :62 (jax.random.categorical in sample_token "
                    "and _sample_one) run in XLA, no Pallas kernel",
        "launches": sampled["runs"][("contiguous", "none")][
            "sampler_launches"],
        "max_abs_err": sampler["max_margin"], "ms": dec_s["kernel_ms"],
        "plain_ms": dec_s["plain_ms"], "bound_ms": dec_s["bound_ms"],
        "bound_by": dec_s["bound_by"], "library_ms": None,
        "shape": f"{sampler['cases']['decode']['shape']}, "
                 f"{SAMPLINGS[0][0]}",
        "argmax_ms": sampler["cases"]["decode"]["argmax_ms"],
        "rows_checked": sampler["rows"], "near_ties": sampler["near_ties"],
        "topp_near_ties": sampler["topp_near_ties"],
        "cases": [{"name": r["name"], "shape": r["shape"], "plan": r["plan"],
                   "argmax_ms": r["argmax_ms"],
                   "max_abs_err": r["max_abs_err"],
                   **{lbl: {k: r[lbl][k] for k in (
                       "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                       "bound_share", "kept")} for lbl, _ in SAMPLINGS[:2]}}
                  for r in sampler["cases"].values()],
        "serving_launches": {f"{k} {d}": r["sampler_launches"]
                             for (k, d), r in sampled["runs"].items()},
        "sampled_step_device_ms": draws["sampled_decode_step"][
            "device_busy_ms"],
        "sampled_step_kernels": draws["sampled_decode_step"][
            "kernels_per_step"],
        "sampled_step_sampling_ms": draws["sampled_decode_step"][
            "device_ms"]["sampling"],
        "draw_device_ms": draws["draw"]["device_busy_ms"],
        "draw_kernels": draws["draw"]["kernels_per_step"]})
    # the serving_faults phase's launches, beside each kernel it runs
    for e in entries:
        key = {"flash_decode": "flash_decode", "row_gemm": "row_gemm",
               "fused_decode_layers_int8": "fused_decode",
               "sampling_filter_draw": "sampling"}.get(e["name"])
        if key is not None:
            e["serving_faults_launches"] = faults["launches"][key]
    # the tiered phase's host-warm loads and the handoff successors'
    # runs, beside each kernel they launch
    tier_key = {"flash_decode": ("contiguous", "bf16", "flash_decode"),
                "flash_decode_paged": ("paged", "bf16", "flash_decode_paged"),
                "flash_decode_paged_int8": ("paged", "int8",
                                            "flash_decode_paged"),
                "flash_decode_paged_fp8": ("paged", "fp8",
                                           "flash_decode_paged"),
                "row_gemm": None,
                "fused_decode_layers_int8": ("fused", "int8",
                                             "fused_decode")}
    for e in entries:
        if e["name"] not in tier_key:
            continue
        cells = tiered["cells"]
        if e["name"] == "row_gemm":
            e["tiered_serving_launches"] = {
                f"{a} {b}": r["launches"]["row_gemm"]
                for (a, b), r in cells.items() if "row_gemm" in r["launches"]}
        else:
            kind, kd, key = tier_key[e["name"]]
            e["tiered_serving_launches"] = cells[(kind, kd)]["launches"][key]
        hkey = {"flash_decode": "flash_decode", "row_gemm": "row_gemm",
                "flash_decode_paged": "flash_decode_paged",
                "fused_decode_layers_int8": "fused_decode"}.get(e["name"])
        if hkey is not None:
            e["handoff_serving_launches"] = {
                f"{' '.join(k)} -> {n}": c["launches"][hkey]
                for k, r in handoffs.items() if isinstance(k, tuple)
                for n, c in r["successors"].items()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "phase_seconds": seconds,
             "flash_attention_resources": resources,
             "kernel_resources": new_resources,
             "decode_steps": steps, "paged_decode_steps": paged_steps,
             "kernels": kernels,
             "paged_kernels": paged_kernels,
             "serving_kv": {f"{a} {b}": r for (a, b), r in kv_runs.items()},
             "train_kernels": train_kernels,
             "rounding_witness": rounding, "serving": serving,
             "fused_kernels": fused_kernels,
             "serving_b1": {f"{a} {b}": r for (a, b), r in fused_runs.items()},
             "b1_steps": b1_steps,
             "training": training, "plain_training": plain_training,
             "float32_training": f32_training,
             "rms_kernels": {" ".join(map(str, k)): r
                             for k, r in rms_kernels.items()},
             "llama_kernels": llama_kernels,
             "llama_generate": llama_gen, "llama_slot_loop": llama_loop,
             "ring_kernels": {f"{a} {b}": r
                              for (a, b), r in ring_kernels.items()},
             "ring_replay": ring_replays, "llama_training": llama_train,
             "llama_sp": llama_sp, "speculative_reference": spec_reference,
             "row_gemm": {f"{a} {b}": r for (a, b), r in gemm_rows.items()},
             "prefix_reference": prefix_reference,
             "sampling_kernel": sampler,
             "sampled_reference": sampled_reference,
             "sampled_serving": {
                 "runs": {f"{a} {b}": r
                          for (a, b), r in sampled["runs"].items()},
                 **{k: v for k, v in sampled.items() if k != "runs"}},
             "prefix_serving": {f"{a} {b}": r
                                for (a, b), r in prefix_runs.items()},
             "compiled_serving": compiled, "serving_faults": faults,
             "tiered_serving": {
                 "cells": {f"{a} {b}": r
                           for (a, b), r in tiered["cells"].items()},
                 "copies": tiered["copies"], "overlap": tiered["overlap"]},
             "handoff_serving": {" ".join(k) if isinstance(k, tuple) else k:
                                 v for k, v in handoffs.items()},
             "speculative_serving": {" ".join(k) if isinstance(k, tuple)
                                     else k: v for k, v in spec_runs.items()
                                     if k != "verify_rows"},
             "remat_plans": plan_rows, "remat_fit": remat_fit,
             "prefetch": prefetched, "train_checkpoint": train_ckpt,
             "preemption": preemption, "bert_kernel": bert_kernels,
             "bert_training": bert_train, "bert_float32": bert_f32,
             "ctc": ctc,
             "speculative_verify_rows": {
                 " ".join(k): v
                 for k, v in spec_runs["verify_rows"].items()}},
            indent=1))
    _log({"kernels": entries})
    _log({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
