#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env      -- card name and power limit (nvidia-smi), torch/CUDA versions,
                 and the time to build the CUDA kernels from ``src/repro_torch/csrc``
                 (one nvcc per source, all started at once).
  2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
                 at the main paths' shapes (granite-8b heads: H=32, Hkv=8, D=128),
                 in fp32 and bf16: max |delta| against the stated tolerance, the
                 kernel's time, the plain version's time, the library call's time
                 where one PyTorch call computes the same function, and the bound.
                 The flash forward also at granite's speculative verify (B 8,
                 Sq 4) and prefill chunk (B 8, Sq 256) shapes and at hymba-1.5b's
                 heads (25 / 5 of 64: window prefill at S 1024 and 1536, the
                 Sq = 1 decode tick of 8 slots) and at qwen2-moe-a2.7b's (16 /
                 16 of 128, GQA group 1: bf16 causal and packed prefill rows,
                 fp32 chunk and verify over an int8 pool's dequantized view;
                 the paged decode over a bf16 fp pool and an int8 pool) and at
                 qwen2.5-32b's (40 / 8 of 128, GQA group 5: bf16 causal and
                 packed prefill rows, the decode body at 8 slots, fp32 chunk
                 and verify, the paged decode over a bf16 fp pool and an
                 int8 pool) and at gemma-7b's (16 / 16 of 256: bf16 causal
                 and packed prefill rows, fp32 causal, chunk and verify, the
                 decode body at 8 slots in both types, the paged decode with
                 bf16 and fp32 queries and over int8 and fp8 pools, each
                 with the body the wrapper planned), each
                 case with the body that ran (the tensor-core tile or decode
                 body, in its bf16 or its fp32 instantiation, checked against
                 the wrapper's plan) and its device time (torch.profiler);
                 the fp32 cases' bound at the tensor cores' bf16 peak (the
                 body's own units) with the fp32 CUDA-core bound beside it.
                 The fp32 forward's pre-pass (its operands as two bf16
                 terms) against its plain version: bitwise equal terms.  The
                 env line carries ptxas's registers and spills of the
                 tensor-core kernels.
                 The backward cases (dQ and dK/dV, both on the tensor cores;
                 fp32 inputs through the split pre-pass) also check the body
                 the wrapper planned and that two launches give
                 bitwise-identical gradients; the env line's ptxas summary
                 covers the backward library too.  The backward also at
                 gemma-7b's heads (16 / 16 of 256, the two-warpgroup
                 kernels), fp32 and bf16: causal at 4096 (train_gemma's
                 row), window, striped and segment at 1024, a ragged 1000
                 and a group of 2 (16 / 8 heads).  And at whisper-base's heads
                 (8 / 8 of 64), fp32 and bf16: the forward over the encoder's
                 non-causal 1536 rows, the cross-attention prefill (64 rows
                 over 1536), the cross-attention decode (8 slots x 1 row over
                 1536) and the decoder's dense-cache decode (8 slots over
                 448); the backward over the encoder's band and the cross
                 band (448 rows, and a ragged 440, over 1536).  And at
                 minicpm3-4b's MLA (drawn last): the tile body at head dim
                 96 over the expanded 40 / 40 heads (causal 2048) and at
                 288 over the absorbed latent (40 query heads on one kv
                 head: a 256-token chunk and a 4-row verify over 2048), fp32
                 and bf16; the paged decode's wide bodies at head dim 288,
                 group 40, with bf16 and fp32 queries over fp, int8 and fp8
                 pools, all at MLA's scale 96^-0.5 (the bf16 paged rows pass
                 an element past 1e-3 only as one bf16 rounding step); then
                 the backward at head dim 96 over the expanded 40 / 40 heads,
                 fp32 and bf16: causal at 4096 (train_minicpm's row), packed
                 segments at 1024, a ragged 1000 (the env line's ptxas
                 summary: no spill in the four D 96 kernels).
                 Granite's S 1024 forward rows are drawn, not run, since
                 PR 31 (the run's time).
  3. slice    -- granite-8b at full width, depth cut to 2 layers, fp32: the same
                 weights served by the engine on the card (kernels) and on the
                 CPU (plain versions), dense and paged caches; the greedy streams
                 must be identical and the first-token logits within 1e-3.
  4. serve    -- granite-8b at full width and depth in bf16 (seeded random
                 weights): ServeEngine over the paged pool serves eight requests
                 of mixed lengths and arrival ticks, 32 new tokens each.  The
                 kernels' launch counters are set to 0 just before this run and
                 read just after it: the serving kernels must have run, and
                 every flash launch (bf16 prefill) on the tile body.
  4a. slice_quant -- granite-8b at full width cut to 2 layers, fp32: the same
                 weights served on the card and on the CPU from an fp, an int8
                 and an fp8 paged pool, with continuous prefill and speculative
                 verify, on a short trace with a shared prefix: streams
                 identical (a flip only on a near-tie, printed), first-token
                 logits within 1e-3 (fp) / 5e-3 (int8, fp8: see
                 SLICE_LOGIT_TOL), pages and scale entries drained, the
                 decode ticks on the card through the fp or the quantized
                 decode kernel only; how far the pools' codes are apart is
                 printed.
  4b. serve_quant -- the serve phase's model and trace with continuous prefill
                 (chunk 256, budget 512) and speculative verify (spec_k 4), three
                 times: an fp, an int8 and an fp8 pool.  Counters set to 0
                 before each run: a quantized run's decode ticks launch only the
                 quantized decode kernel, 36 times per plain decode launch; the
                 fp pool's bf16 chunks and verifies never reach the fp32 flash
                 body, a quantized pool's (fp32 dequantized views) only it.
  4c. slice_ssm -- mamba2-370m and hymba-1.5b at full width cut to 2 layers,
                 fp32: the same weights served on the card (the SSD scan
                 kernel, and the flash forward for hymba's attention) and on
                 the CPU (plain versions), prompts of 48, 64, 192 and 320
                 tokens, 8 new tokens each: streams identical, first-token
                 logits within 1e-3.
  4d. serve_ssm -- mamba2-370m and hymba-1.5b at full width and depth, bf16,
                 seeded random weights, 8 slots, max_seq 2048, exact-length
                 prefill: eight prompts of 48 ... 1536 tokens arriving at
                 ticks 0 ... 13, 32 greedy tokens each.  Counters set to 0
                 before each run: the SSD kernel must launch once per layer
                 per prefill (384 and 256), and hymba's flash forward once
                 per layer per prefill (tile body) and per decode tick (decode
                 body).
  4e. slice_ring -- serving over a ring of 4 (``ParallelCtx(sp_size=4)``, a
                 virtual ring on the card): slice_quant's weights and trace
                 (2 layers, fp32, chunk 64, budget 128, spec_k 4) at sp_size 4
                 on the card against sp_size 1 on the CPU, over the dense
                 cache and the fp / int8 / fp8 pools: streams identical (a
                 quantized pool: a flip only on a near-tie, printed),
                 first-token logits within SLICE_LOGIT_TOL, pages and scale
                 entries drained; per layer one decode launch per decode tick
                 (#4 / 4q, or #1 for the dense cache), one #1 launch per chunk
                 and verify launch, one combine per step, all fp32 on the fp32
                 body.
  4f. serve_ring -- this slice's main path: the serve phase's model and
                 trace at sp_size 4, bf16, the fp pool: one-shot prefill (the
                 Mesh-Attention forward), then continuous prefill (chunk 256,
                 budget 512) with spec_k 4.  Counters set to 0 before each
                 run: per layer exactly one #4 launch per decode tick (the 4
                 ranks folded, not 4 x 36), one #1 launch per chunk (tile
                 body) and verify (decode body) launch, one lse combine per
                 step, and prefill's #1 launches = layers x the mesh
                 schedule's blocks x 4 (a segment-masked block launches per
                 rank); every request ok with 32 tokens, pages drained, peak
                 memory within RING_PEAK_SLACK_GB of serve's; the streams
                 against serve's (a flip only on a near-tie, RING_NEAR_TIE);
                 decode and prefill rates, TTFT, the combine's bytes, and a
                 profiled decode tick (#4 and combine device ms, idle share).
  4i. slice_moe -- qwen2-moe-a2.7b and mixtral-8x7b at full width cut to 1
                 layer (2 before, cut for time), fp32, JAX's default capacity factor 1.25: the same
                 weights served on the card and on the CPU, dense cache and
                 paged pool, prompts of 64, 137 and 200 tokens at ticks 0, 0,
                 1, 8 greedy tokens: streams identical, first-token logits
                 within 1e-3, kernels on the card only, and capacity must
                 drop entries on both sides (counted).
  4j. serve_moe -- the MoE serving path at full width, bf16, the serve
                 trace: qwen2-moe-a2.7b whole (a) one-shot over the fp pool,
                 (b) chunk 256, budget 512, spec_k 4 over an int8 pool; (c)
                 mixtral-8x7b with 8 of its 32 layers (93 GB whole) one-shot
                 over the fp pool.  Counters set to 0 before each run: one
                 #4 (or 4q) launch per layer per decode tick, #1 per layer
                 per prefill, chunk and verify launch (tile body; the fp32
                 bodies over the int8 pool).  Rates, pool bytes, peak memory and a
                 profiled decode tick (expert products, router and shared
                 products, dispatch / combine, attention, idle).  Then the
                 dropless check: qwen2-moe whole in fp32 at capacity factor
                 E / K = 15 (C >= S), two requests' first-token and teacher-forced decode
                 logits against the no-cache forward on the card
                 (DROPLESS_TOL), and the same forward with the router in
                 bf16 and without the shared expert, each of which must
                 miss the limit.
  4k. slice_ssm_ring -- mamba2-370m and hymba-1.5b at full width cut to 2
                 layers, fp32: the engine at sp_size 4 on the card (the
                 sequence-sharded SSD scan of ``models/ssm.py``; hymba's
                 attention through the Mesh-Attention forward and the folded
                 decode) against sp_size 1 on the CPU, prompts of 8, 48, 256
                 and 512 tokens (8: 2 rows a rank, fewer than the conv
                 halo's 3), 8 new tokens: streams identical, first-token
                 logits within 1e-3, every request ok, no kernel on the CPU
                 side; #5 once per layer per prefill at batch 4 (the ranks
                 folded), hymba's #1 once per mesh block per layer and
                 prefill and once per layer per decode tick, one combine per
                 layer per decode tick; the ssd_halo / ssd_state / ssd_tail
                 hops and bytes equal ``_ssd_comm_model``'s formula.
  4l. serve_ssm_ring -- this slice's main path: mamba2-370m and hymba-1.5b
                 at full width and depth, bf16, 8 slots, max_seq 2048, 16
                 greedy tokens (32 before, cut for time), prompts of 48 ... 1536 tokens (each a
                 multiple of 4 whose quarter is <= 64 or a multiple of 64)
                 at ticks 0 ... 13, over a ring of 4, then at sp_size 1 in
                 the same call.  Counters set to 0 before each run: 4k's
                 launch and exchange gates (hymba's prefill blocks on the
                 tile body, its decode rows on the decode body); every
                 request ok with 32 tokens; the ring's streams against one
                 rank's under the near-tie rule (RING_NEAR_TIE).  Rates, ms
                 per decode tick and TTFT of both runs, bytes per kind,
                 peak memory, a profiled 1,536-token prefill (#5 beside the
                 halo, the state gather and prefix, the correction, and the
                 copies) at both widths and a profiled decode tick.
  4m. slice_qwen -- qwen2.5-32b at full width cut to 2 layers, fp32, QKV
                 biases drawn nonzero: card vs CPU, dense cache and paged
                 pool: streams identical, first-token logits within 1e-3.
  4n. serve_qwen -- qwen2.5-32b whole (64 layers, 32.8e9 parameters, 65.5
                 GB) in bf16 on the serve trace, 8 slots, max_seq 2048, 512
                 pages of 16: (a) one-shot over the fp pool, (b) chunk 256,
                 budget 512, spec_k 4 over an int8 pool.  serve_moe's gates
                 (one #4 / 4q per layer per decode tick, #1 per layer per
                 prefill, chunk and verify launch, on the tile or fp32
                 body); pool bytes, peak memory under the card's, a
                 profiled decode tick beside the weights' bytes bound.
  4o. slice_gemma -- gemma-7b (16 / 16 heads of 256, GeGLU, tied
                 embeddings) at full width cut to 2 layers, fp32: card vs
                 CPU, dense cache and paged pool (streams identical,
                 first-token logits within 1e-3), and an int8 pool with
                 chunk 256 and spec_k 4 (a flip only on a near-tie, within
                 5e-3): the fp32 tile and decode bodies and the CUDA-core #4
                 / 4q at head dim 256 on the model's path.
  4p. serve_gemma -- gemma-7b whole (28 layers, 8.54e9 parameters, 17.1 GB)
                 in bf16 on the serve trace, 8 slots, max_seq 2048, 512
                 pages of 16, runs (a) and (b) as serve_qwen's, its gates,
                 and no call of a kernel's plain version in either run.
  4q. slice_whisper -- whisper-base whole (6 + 6 layers), fp32, its
                 LayerNorms drawn away from their init: 8 prompts of 4-64
                 tokens, 64 new tokens each (128 before PR 31), 8 slots, max_seq 448, the
                 dense cache, on the card and on the CPU: streams identical,
                 first-token logits within 1e-3.
  4r. serve_whisper -- whisper-base whole in bf16 on 4q's trace: the encoder
                 (1536 rows of zero frames) once per admission, #1 launched
                 per prefill once per encoder layer and twice per decoder
                 layer (the decoder rows' self- and cross-attention on the
                 body ``_fwd_plan`` picks for the bucket), twice per decoder
                 layer per decode tick on the decode body; no plain version
                 called; rates, peak memory, a profiled decode tick.
  4s. slice_pixtral -- pixtral-12b at full width cut to 2 of 40 layers,
                 fp32: 3 prompts of 1,040-1,100 tokens (the 1024 patch
                 positions, then text), 8 new tokens, on the card over the
                 dense cache and the paged pool against the CPU: streams
                 identical, first-token logits within 1e-3.
  4u. slice_minicpm (after 4t) -- minicpm3-4b (MLA) at full width cut to
                 2 layers, fp32: card vs CPU over the dense cache and the
                 paged pool (streams identical, first-token logits within
                 1e-3: #1's fp32 tile body at head dims 96 and 288, the wide
                 CUDA-core #4) and an int8 pool with chunk 256 and spec_k 4
                 (its first prompt slice_quant's looping one, for drafts; a
                 flip only on a near-tie, within 5e-3).
  4v. serve_minicpm -- minicpm3-4b whole (62 layers, 4.26e9 parameters, 8.52
                 GB) in bf16 on the serve trace, 512 pages of 16, runs (a)
                 and (b) as serve_qwen's: #1's tile body at head dim 96 62
                 times a prefill launch, #4 / 4q at 288 (group 40) 62 times
                 a decode tick, #1's fp32 tile body at 288 62 times a chunk
                 or verify launch, no plain version called; ms a tick, a
                 profiled tick's device time against the weights bound, its
                 idle share, peak memory.
  4t. serve_pixtral -- pixtral-12b whole (40 layers, 12.25e9 parameters,
                 24.5 GB) in bf16: 8 requests of 1024 + 32 ... 512 tokens at
                 the serve trace's ticks, 32 new tokens, 8 slots, max_seq
                 2048, 768 pages of 16, one-shot over the fp pool (#1 tile,
                 #4) and over an int8 pool (#1 tile, 4q); serve_qwen's gates
                 and a profiled decode tick beside the weights' bound.
  5. train_parity -- granite-8b at full width cut to 2 layers, fp32, seq 256:
                 one make_train_step on the card and one on the CPU from the same
                 weights and batch; loss, grad norm, and per leaf the gradients
                 and the updated params held to stated tolerances.
  6. train    -- granite-8b at full width cut to 8 layers, fp32 params, AdamW,
                 remat, seq 4096, batch 1: 2 causal steps, then 1 step with 4
                 packed documents, through ``repro_torch.train.loop.fit``.
                 The counters are set to 0 just before and read just after:
                 the forward kernel must have run 2 x 8 x 3 times (all on the
                 fp32 tile body), dQ and dK/dV 8 x 3 times each, every
                 backward on the fp32 tensor-core body (and its pre-pass).  One more step runs
                 under torch.profiler for the device time per kernel class.
                 Then 1 causal step with bf16 params: losses finite and near
                 ln(vocab), the forward on the tile body and every backward on
                 the bf16 body.
  6e. train_gemma_parity (after train) -- gemma-7b at full width cut to 1
                 layer, fp32, seq 128: train_parity's step and limits
                 (head dim 256 through #1-#3; the CPU side holds ~21 GB).
  6f. train_gemma (after 6e) -- gemma-7b at full width cut to 8 of 28
                 layers (3.0e9 parameters), the train phase's runs and gates
                 (2 causal, 1 packed and 1 bf16 step): #1 2 x 8 x
                 3 on the fp32 tile body at head dim 256, #2 and #3 8 x 3
                 each on the fp32 tensor-core body, then the bf16 step on the
                 bf16 bodies; no call of a kernel's plain
                 version in either (as serve_gemma); a profiled step.
  6g. train_whisper_parity (after 6f) -- whisper-base at full width cut to
                 2 + 2 layers, fp32, batch 2 x 448 decoder tokens and 1536
                 frames: train_parity's step and limits; #1 twice and #2 /
                 #3 once per attention call (2 encoder, 2 decoder self-, 2
                 cross-attention).
  6h. train_whisper -- whisper-base whole, fp32 + AdamW, remat, batch 16 x
                 448: 4 steps, the train phase's gates at 18 attention calls
                 a step, then 2 bf16 steps; s per step, tok/s, peak memory,
                 a profiled step.
  6i. train_pixtral -- pixtral-12b at full width cut to PIXTRAL_TRAIN_LAYERS
                 of 40 layers, fp32 + AdamW, remat, seq 4096 (the 1024
                 patch positions in each row), 4 steps: the train phase's
                 gates, no plain version called, a profiled step.
  6j. train_minicpm_parity -- minicpm3-4b (MLA: the expanded 40 / 40 heads
                 of 96 through #1 and #2 / #3) at full width cut to 1 layer,
                 fp32: train_parity's step card vs CPU at seq 256, then the
                 same weights on the card at sp_size 4 (mesh a = 2, striped)
                 against sp_size 1 at seq 2048 (train_mesh_parity's step,
                 limits and gates: launches = the schedules' blocks, Q and
                 KV hop bytes = ``CommModel.chunk_bytes``).
  6k. train_minicpm -- minicpm3-4b at full width cut to
                 MINICPM_TRAIN_LAYERS of 62 layers, fp32 + AdamW, remat, seq
                 4096: 2 causal steps and 1 of packed documents, then 1 bf16
                 step; the train phase's gates (#1 on the fp32 tile body at
                 head dim 96, #2 / #3 on the fp32 tensor-core body, no plain
                 version called), peak memory at most MINICPM_PEAK_GB, a
                 profiled step.
  6a. train_ssm_parity -- mamba2-370m and hymba-1.5b at full width cut to 2
                 layers, fp32, seq 512: one make_train_step on the card (#5,
                 #5b; hymba's #1 fp32 body, #2, #3) and one on the CPU from
                 the same weights and batch, under train_parity's limits;
                 per layer #5 twice (remat) and #5b once, on the card only.
  6b. train_moe_parity -- qwen2-moe-a2.7b the same way at 1 layer, seq 128
                 (#1-#3).
  6c. train_ssm_ring_parity -- mamba2-370m and hymba-1.5b at full width, 2
                 layers, fp32, seq 4096: a train step at sp_size 4 on the
                 virtual ring (the sharded scan; hymba's attention through
                 the mesh executor, a = 2, contiguous) against sp_size 1,
                 both on the card, under train_parity's limits; #5 once per
                 layer and forward pass with the 4 ranks folded into its
                 batch, #5b once per layer, the ssd_halo / ssd_state /
                 ssd_tail exchanges twice ``_ssd_comm_model``'s (remat's two
                 forwards).
  6d. train_ssm -- this slice's main path: mamba2-370m whole (48 layers,
                 seq 4096, batch 4, 4 steps) and hymba-1.5b whole (32
                 layers, seq 4096, batch 2, 3 steps), fp32 params + AdamW,
                 remat, through ``fit``.  Counters set to 0 before each run:
                 #5 = 2 x L x steps, #5b = L x steps (hymba's #1 on the fp32
                 body, #2 and #3 on the fp32 tensor-core body, on the remat
                 schedule); losses and grad norms finite, the first loss
                 near ln(vocab), peak memory under the card's; s per step,
                 tok/s, and one more step under torch.profiler by kernel
                 class.
  7. mesh_op -- this slice's path, the paper's Mesh-Attention:
                 ``dispatch.distributed_attention`` over a virtual ring of 4
                 ranks (``parallel/ring.VirtualRing``: all ranks on the card,
                 a hop a device copy) at paper-mha-7b's heads (32 x 128, MHA),
                 S 16384, causal striped and window 1024, fp32 and bf16:
                 mesh (a = 2), ring and mesh (a = 4), each in the serial,
                 overlap and bidir modes (bitwise equal, forward and
                 gradients), held against the local flash call on the
                 unstriped sequence (o and the gradients of sum(sin(o)):
                 MESH_OP_TOLS); kernel launches per call equal the
                 schedules' blocks (forward: the ranks folded into one
                 launch; backward: one dQ and one dK/dV launch per rank), hops
                 per kind equal ``schedule.comm_requirements``, the Q and KV
                 hops' bytes ``CommModel.chunk_bytes`` x count (the O, OdOQ,
                 dQ and dKV bytes printed beside the model's figure); event
                 times of mesh / ring / local flash and device time by class
                 (the copies apart).
  8. train_mesh_parity -- paper-mha-7b at full width, 2 layers, fp32, seq
                 4096: one make_train_step at sp_size 4 on the virtual ring
                 (mesh a = 2, and ring) against one at sp_size 1, on the card,
                 from the same weights and batch (train_parity's limits);
                 each ring step's launches equal its schedules' blocks x
                 layers (x 2 for remat's forward; the backward per rank), its
                 Q and KV hops carry ``CommModel.chunk_bytes`` each.
  9. train_mesh -- paper-mha-7b at full width cut to MESH_TRAIN_LAYERS layers,
                 fp32 + AdamW, remat, seq 16384, batch 1, sp_size 4: 2 steps
                 on mesh (a = 2), then 2 on ring, through fit; losses finite
                 and near ln(vocab); launches of #1, #2, #3 per step asserted
                 against the schedules x layers (x 2 for remat's forward);
                 s per step, tokens/s, peak memory, hops and bytes per step,
                 and a profiled mesh step by kernel class.
  10. the kernels line (each kernel's launches now including the mesh_op,
                 train_mesh, serve_ring, serve_moe, serve_ssm_ring,
                 serve_qwen, serve_gemma, serve_whisper, serve_pixtral,
                 train_whisper, train_pixtral and train_ssm runs; rows of
                 their own for #1 at whisper's bands (tile and decode
                 bodies, counted over serve_whisper) and #2 / #3 at them
                 (counted over train_whisper), for the head-dim-256
                 instantiations of #1, #4 and 4q,
                 counted over serve_gemma, and of #2 and #3, counted over
                 train_gemma (whose launches also join the backward's and
                 the fp32 forward's rows), for MLA's #1 at head dims 96 and
                 288 and #4 / 4q at 288, counted over serve_minicpm, and
                 for #2 and #3 at head dim 96, counted over train_minicpm
                 (whose launches also join the backward's rows); the ranks' combine a row of
                 its own; #5b's row from train_ssm; the fp32 forward's
                 pre-pass a row of its own, counted over the same main-path
                 runs as the fp32 forward's row, once per launch), the card
                 line, and the final line
     ``{"ok": true, "device": {...}}``.

Each phase line carries the phase's wall ``seconds``.  The kernels phase also
holds the quantized decode (int8 / fp8 pools, fp32 / bf16 queries, windows
None / 512), the paged decode's split combine kernel alone (the main row's
partials, some splits empty, an all-empty row) and the SSD chunked scan
(mamba2-370m and hymba-1.5b heads, fp32, a short chunk, batch 4, a reduced
shape and dt = 3 with A = -1, where a chunk's sum of dt*|A| passes 88;
the sharded scan's folded launches: 4 ranks x 384 rows at both archs'
heads, and local lengths 12 and 2 at mamba2's; finite and a bitwise
repeat) and its backward #5b (train_ssm's rows, mamba2 B 4 x 4096 and hymba
B 2 x 4096, the serving rows, a one-chunk case, 4 folded ranks x 384 rows
with a nonzero gradient of the final state, and dt = 3: each gradient
within 1e-4 of its largest |value|, a repeat bitwise) against their plain
versions.  The paged and
SSD cases carry the kernels' device time (``dev_ms``: all kernels of one
call, torch.profiler, L2 flushed) beside the call's event time (``ms``, L2
flushed); the SSD cases also the bound at the fp32 CUDA-core peak beside
the tensor-core one.  The env line's ptxas summary covers the paged and
SSD libraries.  The kernels phase also holds the mesh executor's blocks
(``mesh_block``: paper heads, 4096 rows a chunk, stride 4, the bands of
block (0, 1) of a = 2 for n = 4, causal and window 1024, fp32 and bf16): the
forward with the 4 ranks folded into its batch (one band per row; ranks 0
and 1 hold a q chunk below their kv chunk, so their row 0 sees no key and
must give o = 0, lse = NEG_INF exactly), the backward on rank 0 with one
band (dq of the blind rows exactly 0, dk / dv finite, a repeat bitwise).
And hymba-1.5b's mesh prefill block over a ring of 4 (contiguous, window
1024, 384 rows a rank, 25 / 5 heads of 64: ranks 0 and 1 blind).  And the
serving ring's launches: #1 at the chunk (256) and verify (4) rows with 4
ranks x 8 slots folded (stride 4; the first rows of ranks 1-3 blind), the
decode rows at hymba's heads (window 1024), and #4 / 4q over a pool sharded 4 ways (bf16 queries, fp and int8
pools, ``paged_case``'s depths: rows of ranks that see no key must give
o = 0, lse = NEG_INF exactly) followed by the ranks' lse combine.

Any failed check raises: the script then exits non-zero without the final
line.  It exits non-zero at once when CUDA is not available.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch, kv_quant, mesh_attention  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.am import CommModel  # noqa: E402
from repro_torch.core.masking import MaskSpec  # noqa: E402
from repro_torch.core.mesh_attention import MeshAttentionConfig  # noqa: E402
from repro_torch.core.mesh_attention_collective import mesh_attention_collective  # noqa: E402
from repro_torch.core.tiling import stripe_permutation, unstripe_permutation  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_leaves  # noqa: E402
from repro_torch.parallel.context import ParallelCtx  # noqa: E402
from repro_torch.parallel.ring import VirtualRing  # noqa: E402
from repro_torch.serve.config import ServeConfig  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.testing.chaos import ChaosConfig, ChaosInjector  # noqa: E402
from repro_torch.train.loop import TrainConfig, fit, make_train_step  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores, no TF32
# the forward runs on the tensor cores for either input type (fp32 inputs as
# two bf16 terms): its bounds take the bf16 peak, and its fp32 records keep
# the bound at the fp32 CUDA-core peak beside it
FWD_PEAK = PEAK_FLOPS[torch.bfloat16]
# the backward runs on the tensor cores for either input type: its bounds
# take the bf16 peak (the fp32 inputs' extra term products are the kernel's
# own cost, not the function's)
BWD_PEAK = PEAK_FLOPS[torch.bfloat16]
# the SSD scan's products run on the tensor cores too (fp32 operands as bf16
# terms): its bound takes the bf16 peak, and its record keeps the bound at
# the fp32 CUDA-core peak beside it
SSD_PEAK = PEAK_FLOPS[torch.bfloat16]
# max |delta| of o against the plain version, per kernel and input type.
# bf16 outputs are rounded to bf16 (an ulp is 3.9e-3 at |o| in [0.5, 1)):
# the limits sit a few times above the largest readings on an H100 (flash
# 3.9e-3, paged 2.4e-4), so a skipped tile or page cannot hide under them.
TOLS = {
    ("flash_attention_fwd", torch.float32): 1e-4,
    ("flash_attention_fwd", torch.bfloat16): 1e-2,
    ("paged_flash_decode", torch.float32): 1e-4,
    ("paged_flash_decode", torch.bfloat16): 1e-3,
}
# dq/dk/dv against the plain backward: |delta| <= atol + rtol * |want|.  fp32:
# the JAX kernel tests' own 2e-4 (sums in another order).  bf16: the inputs
# are the same bf16 values on both sides and the arithmetic fp32, but the
# outputs are rounded to bf16, so one ulp (2**-7 of the value at most) on top
BWD_TOLS = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-4, 2**-7 + 2e-4)}
# the split combine alone, |delta| <= atol + rtol * |want| against the plain
# combine over random partials (|o| ~ 1): both merge in fp32 in other orders
# (largest reading on an H100: 0.17 of the fp32 limit); bf16 adds o's own
# rounding, one ulp (2**-7 of the value) where the two fp32 sums straddle a
# rounding boundary
COMBINE_TOLS = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-6, 2**-7)}
# lse is fp32 for either input type (largest reading 1.9e-6); skipping one
# 16-token page at depth ~1500 moves it by ~1e-2
LSE_TOL = 1e-4
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

FLASH_REPLACES = "src/repro/kernels/flash_attention.py:153"
BWD_SRC = "src/repro_torch/csrc/flash_bwd.cu"
BWD_BODIES = ("tc_fp32", "tc_bf16")
BWD_DQ_REPLACES = "src/repro/kernels/flash_attention.py:411"
BWD_DKV_REPLACES = "src/repro/kernels/flash_attention.py:461"
PAGED_SRC = "src/repro_torch/csrc/paged_decode.cu"
PAGED_REPLACES = "src/repro/kernels/paged_decode.py:205"
QUANT_REPLACES = "src/repro/kernels/paged_decode.py:205 (quantized branch :161-167)"
QUANT_DTYPES = ("int8", "fp8")
SSD_SRC = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:90"
# #5b, the scan's gradient: no Pallas kernel computes it (JAX differentiates
# its jnp chunked scan), so the row names the forward it differentiates
SSD_BWD_SRC = "src/repro_torch/csrc/ssd_scan_bwd.cu"
SSD_BWD_REPLACES = ("src/repro/kernels/ssd_scan.py:90 (its gradient: JAX takes jax.grad of "
                    "src/repro/models/ssm.py:73 _ssd_chunked)")
# the SSD scan against its plain version: both sum fp32 in other orders, so
# y and the final state are held to 1e-4 of the output's scale
SSD_REL_TOL = 1e-4
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
# slice_quant, card vs CPU, first-token logits.  The fp pool on the chunked
# and speculative trace is held to the serving slice's 1e-3 (reading on an
# H100: 1.3e-5).  The quantized pools quantize K/V that card and CPU compute
# ~1e-5 apart, so a value near a rounding boundary takes neighbouring codes
# on the two sides: 529 of 854,508 int8 codes (every one a single step) in
# the first reading, which moved the first-token logits by up to 1.04e-3
# (int8) and 1.58e-3 (fp8) -- the one-shot runs, whose first token reads no
# pool, stayed at 1.1e-5.  Quantization itself moved them by 0.057 (int8)
# and 0.199 (fp8) against the fp pool on the card.  So the quantized pools
# are held to 5e-3: 3x the flip noise, 11-40x below the quantization's own
# effect.  A greedy flip between the two sides is allowed only on a
# near-tie: both score the two candidates within twice the limit
# (dist_check quant_kv's rule).
SLICE_LOGIT_TOL = {"fp": 1e-3, "int8": 5e-3, "fp8": 5e-3}
QMAX = {"int8": 127.0, "fp8": 448.0}

# granite-8b attention geometry
H, HKV, D = 32, 8, 128
# hymba-1.5b's (H, Hkv, D)
HYMBA_HEADS = (25, 5, 64)
# qwen2-moe-a2.7b's: multi-head attention, GQA group 1
QWEN_MOE_HEADS = (16, 16, 128)
# qwen2.5-32b's: GQA group 5 at head dim 128
QWEN_HEADS = (40, 8, 128)
# gemma-7b's: multi-head attention at head dim 256
GEMMA_HEADS = (16, 16, 256)
# a group of 2 at gemma's head dim: the backward's sum over the group
GEMMA_GQA2_HEADS = (16, 8, 256)
# minicpm3-4b's MLA: prefill over the expanded heads (40 / 40 of 96, V padded
# from 64 to the qk width), and decode, chunks and verifies over the
# absorbed latent (40 query heads on one latent head of 256 + 32), both at
# the softmax scale of the expanded heads, qk^-0.5 = 96^-0.5
MLA_PREFILL_HEADS = (40, 40, 96)
MLA_LATENT_HEADS = (40, 1, 288)
MLA_SCALE = 96**-0.5
FLASH_TC_SRC = "src/repro_torch/csrc/flash_fwd_tc.cu"
# #1's tile body at MLA's head dims (96, 288): the same kernels
# (csrc/flash_fwd_tc.cuh), a library of their own
FLASH_MLA_SRC = "src/repro_torch/csrc/flash_fwd_mla.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_PHASE_T0 = [time.perf_counter()]


def emit(record):
    """Print a phase line with the wall seconds since the previous one."""
    now = time.perf_counter()
    if "phase" in record:
        record = {**record, "seconds": now - _PHASE_T0[0]}
    _PHASE_T0[0] = now
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(lib_path, prefix="flash_fwd_"):
    """Registers and spill bytes per kernel of one library, from the
    ``nvcc -Xptxas -v`` log the build keeps beside it (None when the
    library was not built in this run); a kernel whose wgmma products
    ptxas serialized is marked."""
    log_path = f"{lib_path}.log"
    if not os.path.exists(log_path):
        return None

    def kernel_name(mangled):
        # <length><prefix><word>_kernel[I<template args>E]
        k = re.search(r"\d(" + prefix + r"[a-z_]+_kernel)(I(?:Li\d+E)+E)?", mangled)
        if k is None:
            return None
        args = re.findall(r"Li(\d+)E", k.group(2) or "")
        return k.group(1) + (f"<{', '.join(args)}>" if args else "")

    out, name = {}, None
    for line in open(log_path, errors="replace"):
        if "Potential Performance Loss" in line:
            serialized = kernel_name(line)
            if serialized is not None:
                out.setdefault(serialized, {})["serialized_wgmma"] = True
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def time_ms(fn, reps=20, warmup=3, flush=None):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls;
    ``flush`` (untimed) runs before each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


# the forward's launches by input type and body: "tile" and "decode" count
# the bf16 bodies, "fp32" both fp32 ones (the gates' keys)
FWD_BODIES = ("tile", "decode", "fp32")
# the bodies ``_fwd_plan`` names: each body in each input type
FWD_PLAN_BODIES = ("tile", "decode", "tile_fp32", "decode_fp32")


def fwd_body_counts(bodies=FWD_BODIES):
    return {b: getattr(fa.flash_attention_fwd, f"launches_{b}") for b in bodies}


def fwd_body_delta(before):
    return {b: n - before[b] for b, n in fwd_body_counts(tuple(before)).items()}


def flash_case(name, S, dtype, gen, heads=(H, HKV, D), ranks=1, q_rows=64, scale=None,
               measure=True):
    """One flash-forward case; granite-8b's heads unless ``heads`` (H, Hkv,
    D) says otherwise.  ``verify`` and ``chunk`` are the serving path's
    speculative verify (spec_k 4) and prefill chunk (256) over S cached
    positions, each batch row at its own depth; ``decode`` is a dense-cache
    tick, one band per slot (with hymba's heads, its window of 1024; other
    heads see the whole cache).  Full bands (whisper's): ``full`` is S rows
    over S keys (the encoder), ``cross`` ``q_rows`` rows over S keys
    (cross-attention prefill), ``cross_decode`` 8 slots of one row each over
    S keys (cross-attention decode).
    ``ranks`` n > 1: the launch of sequence-sharded serving over a ring of
    n, the ranks folded into the rows -- row b*n + i is rank i's S/n slots
    of slot b, band (pos_b, i, 0, hi), stride n -- and slot 0's chunk starts
    at 0, so the first rows of ranks 1 .. n-1 see no key.  ``scale``: the
    softmax scale (default hd^-0.5; MLA's latent takes MLA_SCALE).
    ``measure=False`` draws the case's inputs from ``gen`` and returns None
    (a row cut for the run's time keeps every later row's inputs)."""
    INF = ref.BAND_INF
    nh, nkv, hd = heads
    scale = hd**-0.5 if scale is None else scale
    B, Sq, Skv, sq, skv, seg = 1, S, S, 1, 1, None
    band = (0, 0, 0, INF)
    hymba = tuple(heads) == HYMBA_HEADS
    per_row_hi = 1023 if hymba else INF
    if name == "window":
        band = (0, 0, 0, 1023 if hymba else 255)
    elif name == "striped":
        band, sq, skv = (1, 0, 0, INF), 2, 2
    elif name == "segment":
        cuts = np.sort(np.random.default_rng(S).choice(np.arange(1, S), 5, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)).cuda()
    elif name in ("full", "cross", "cross_decode"):
        band = ops.full_band()
        B, Sq = (8, 1) if name == "cross_decode" else (1, S if name == "full" else q_rows)
    elif name in ("decode", "verify", "chunk"):
        B, Sq = 8, {"decode": 1, "verify": 4, "chunk": 256}[name]
        pos = torch.from_numpy(
            np.random.default_rng(S).integers(0, S - Sq + 1, B).astype(np.int32)).cuda()
        off = 0 * pos
        if ranks > 1:
            pos[0] = 0
            off = torch.arange(ranks, dtype=torch.int32, device="cuda").repeat(B)
            pos = pos.repeat_interleave(ranks)
            B, Skv, skv = B * ranks, S // ranks, ranks
        band = torch.stack([pos, off, 0 * pos, 0 * pos + per_row_hi], dim=1)
    q = randn(gen, B, Sq, nh, hd, dtype=dtype)
    k = randn(gen, B, Skv, nkv, hd, dtype=dtype)
    v = randn(gen, B, Skv, nkv, hd, dtype=dtype)
    if not measure:
        return None
    kw = dict(scale=scale, stride_q=sq, stride_kv=skv, seg_q=seg, seg_kv=seg)
    plain_band = band if not isinstance(band, torch.Tensor) else tuple(band[:, i] for i in range(4))
    run = lambda: fa.flash_attention_fwd(q, k, v, band, **kw)  # noqa: E731
    plain = lambda: ref.attention_ref(q, k, v, band=plain_band, **kw)  # noqa: E731
    before = fwd_body_counts(FWD_PLAN_BODIES)
    o, lse = run()
    body = [b for b, n in fwd_body_delta(before).items() if n]
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max()) if live.any() else 0.0
    empty_exact = bool(torch.equal(lse[~live], lse_ref[~live])) and bool(
        torch.all(o.transpose(1, 2)[~live] == 0)
    )
    # library yardstick: one SDPA call with the same visibility as a boolean mask
    mask = ref.band_mask(Sq, Skv, plain_band, stride_q=sq, stride_kv=skv, device="cuda")
    if seg is not None:
        mask = mask & (seg[:, None] == seg[None, :])
    rows = 1 if mask.dim() == 3 else B  # a 2-D mask is shared by every batch row
    visible_pairs = int(mask.sum()) * rows
    # keys seen by at least one query of their batch row: the kernel never
    # loads the others (the Sq=1 rows stop at their own pos)
    visible_keys = int(mask.any(dim=-2).sum()) * rows
    attn_mask = mask[:, None] if mask.dim() == 3 else mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if name in ("causal", "full", "cross", "cross_decode"):  # no mask
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=name == "causal", scale=scale, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=attn_mask, scale=scale, enable_gqa=True)
    item = q.element_size()
    # q read and o written once, the visible keys' K and V read once, lse
    # written, the segment ids read
    nbytes = (2 * q.numel() + 2 * visible_keys * nkv * hd) * item + lse.numel() * 4 \
        + (2 * seg.numel() * 4 if seg is not None else 0)
    flops = 4 * hd * nh * visible_pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype, FWD_PEAK)
    tol = TOLS[("flash_attention_fwd", dtype)]
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_fwd", case=name, S=S, B=B, Sq=Sq, heads=list(heads), ranks=ranks,
        dtype=DTYPE_NAMES[dtype], body=body[0] if len(body) == 1 else body,
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run), device_ms=device_ms.get("flash_attention_fwd", 0.0),
        plain_ms=time_ms(plain), library_ms=time_ms(lib),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=visible_pairs,
        visible_keys=visible_keys,
    )
    if dtype == torch.float32:
        rec["bound_ms_fp32_cores"], rec["bound_by_fp32_cores"] = bound(nbytes, flops, dtype)
    want_body = fa._fwd_plan(B, Sq, nh, nkv, hd, dtype)[0]
    check(body == [want_body], f"flash_attention_fwd ran {body}, not the {want_body} body: {rec}")
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"flash_attention_fwd disagrees with its plain version: {rec}")
    check(ranks == 1 or not bool(live.all()), f"the folded ranks left no row blind: {rec}")
    return rec


def bf16_rounding_flips(o, o_ref, tol):
    """(elements of o off o_ref by more than tol, whether each of them is one
    bf16 rounding step: the two sides round fp32 values that straddle a
    bf16 boundary to neighbouring values, one ulp apart)."""
    d = (o.float() - o_ref.float()).abs()
    over = d > tol
    if not bool(over.any()):
        return 0, True
    mag = torch.maximum(o.float().abs(), o_ref.float().abs())[over]
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # bf16: 8 significant bits
    return int(over.sum()), bool((d[over] <= ulp).all())


def paged_case(window, dtype, gen, flush, heads=(H, HKV, D), scale=None, ulp_flips=False):
    """One paged-decode case at the main path's pool: 8 slots, page 16,
    max_seq 2048; mixed depths, partial last pages, -1 past each row's depth,
    one all-empty row; granite-8b's heads unless ``heads`` (H, Hkv, D) says
    otherwise; ``scale`` the softmax scale (default the wrapper's, hd^-0.5).
    ``ulp_flips`` (MLA's rows, bf16 o): an element past the tolerance passes
    when it is one bf16 rounding step from the plain version's
    (``bf16_rounding_flips``)."""
    nh, nkv, hd = heads
    B, ps, max_seq = 8, 16, 2048
    max_pages = max_seq // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(5)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-depth // ps)
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    bt_t = torch.from_numpy(bt).cuda()
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    k_pool = randn(gen, num_pages, ps, nkv, hd, dtype=dtype)
    v_pool = randn(gen, num_pages, ps, nkv, hd, dtype=dtype)
    q = randn(gen, B, 1, nh, hd, dtype=dtype)
    kw = dict(stride_kv=1, window=window, scale=scale)
    run = lambda: pk.paged_flash_decode(q, k_pool, v_pool, bt_t, pos, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q, k_pool, v_pool, bt_t, pos, 0, **kw)  # noqa: E731
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(lse[~live] == ref.NEG_INF)) and bool(torch.all(o[7] == 0))
    check(not bool(live[7].any()), "the all-empty row must have no visible position")
    # bytes this data needs: the visible pages' K/V once, q, o, lse, the
    # block-table rows and pos
    lo = [max(d - 1 - (window - 1), 0) if window else 0 for d in depths]
    visible_tokens = sum(max(d - lo_b, 0) for d, lo_b in zip(depths, lo))
    visible_pages = sum(
        len({p // ps for p in range(lo_b, d)}) for d, lo_b in zip(depths, lo)
    )
    item = q.element_size()
    nbytes = (2 * visible_pages * ps * nkv * hd + 2 * q.numel()) * item + lse.numel() * 4 \
        + bt.nbytes + pos.numel() * 4
    flops = 4 * hd * nh * visible_tokens
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    tol = TOLS[("paged_flash_decode", dtype)]
    flips, flips_ok = bf16_rounding_flips(o, o_ref, tol)
    rec = dict(
        kernel="paged_flash_decode", case=f"window{window}" if window else "full",
        B=B, heads=list(heads), page_size=ps, depths=depths, dtype=DTYPE_NAMES[dtype],
        splits=pk.default_num_splits(B, nkv, max_pages),
        body=pk._plan(B, nh, nkv, hd, max_pages, None, dtype)[0],
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_tokens=visible_tokens,
        visible_pages=visible_pages, rounding_flips=flips,
    )
    within = err <= tol or (ulp_flips and dtype == torch.bfloat16 and flips_ok)
    check(within and err_lse <= LSE_TOL and empty_exact,
          f"paged_flash_decode disagrees with its plain version: {rec}")
    return rec


def paged_device_ms(run, flush, reps=5):
    """The paged kernels' device time per call (torch.profiler, an L2 flush
    before each call): main kernel and combine together, and the combine."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            run()
        torch.cuda.synchronize()
    by_class, by_kernel = device_time(prof, per=reps)
    return dict(dev_ms=by_class.get("paged_flash_decode", 0.0),
                dev_ms_combine=sum(ms for k, ms in by_kernel.items()
                                   if "paged_decode_combine_kernel" in k))


def split_combine_case(dtype, gen):
    """The paged decode's combine kernel alone at the main row's partials (8
    slots, granite heads, the default split count), some splits empty and
    one all-empty row, against combine_split_partials."""
    B, S = 8, pk.default_num_splits(8, HKV, 128)
    o_parts = randn(gen, B, S, H, D, dtype=torch.float32)
    lse_parts = 4 * randn(gen, B, S, H, dtype=torch.float32)
    empty = torch.rand(B, S, H, generator=gen, device="cuda") < 0.3
    empty[7] = True
    lse_parts[empty] = ref.NEG_INF
    run = lambda: pk.split_combine(o_parts, lse_parts, dtype)  # noqa: E731
    plain = lambda: pk.combine_split_partials(o_parts, lse_parts)  # noqa: E731
    before = pk.split_combine.launches
    (o, lse), (o_ref, lse_ref) = run(), plain()
    torch.cuda.synchronize()
    launched = pk.split_combine.launches - before
    live = lse_ref > ref.NEG_INF / 2
    diff = (o.float() - o_ref).abs()
    err = float(diff.max())
    atol, rtol = COMBINE_TOLS[dtype]
    ratio = float((diff / (atol + rtol * o_ref.abs())).max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(o[7] == 0)) and bool(torch.all(lse[~live] == ref.NEG_INF))
    nbytes = 4 * (o_parts.numel() + lse_parts.numel() + lse.numel()) + o.numel() * o.element_size()
    bound_ms, bound_by = bound(nbytes, 0, dtype)
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(kernel="paged_decode_combine", B=B, splits=S, dtype=DTYPE_NAMES[dtype],
               max_abs_err=err, max_err_over_tol=ratio, tol_atol=atol, tol_rtol=rtol,
               max_abs_err_lse=err_lse, tol_lse=LSE_TOL,
               empty_rows_exact=empty_exact, launched=launched, ms=time_ms(run),
               dev_ms=device_ms.get("paged_flash_decode", 0.0), plain_ms=time_ms(plain),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    check(launched == 1 and ratio <= 1.0 and err_lse <= LSE_TOL and empty_exact,
          f"the paged decode's combine kernel disagrees with combine_split_partials: {rec}")
    return rec


def quant_paged_case(kv_dtype, window, dtype, gen, flush, heads=(H, HKV, D), scale=None,
                     ulp_flips=False):
    """The quantized decode (4q) at the main path's pool: 8 slots, page 16,
    max_seq 2048, granite heads unless ``heads`` says otherwise; codes and
    scales quantized on the card from random K/V; the same depths as
    ``paged_case`` (an all-empty row last); ``scale`` and ``ulp_flips`` as
    there."""
    nh, nkv, hd = heads
    B, ps, max_seq = 8, 16, 2048
    max_pages = max_seq // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(6)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-depth // ps)
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    bt_t = torch.from_numpy(bt).cuda()
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    kq, ks = kv_quant.quantize(randn(gen, num_pages, ps, nkv, hd, dtype=torch.float32), kv_dtype)
    vq, vs = kv_quant.quantize(randn(gen, num_pages, ps, nkv, hd, dtype=torch.float32), kv_dtype)
    q = randn(gen, B, 1, nh, hd, dtype=dtype)
    kw = dict(stride_kv=1, window=window, k_scale=ks, v_scale=vs, scale=scale)
    run = lambda: pk.paged_flash_decode(q, kq, vq, bt_t, pos, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q, kq, vq, bt_t, pos, 0, **kw)  # noqa: E731
    before = pk.paged_flash_decode.quant_launches
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    launched = pk.paged_flash_decode.quant_launches - before
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(lse[~live] == ref.NEG_INF)) and bool(torch.all(o[7] == 0))
    lo = [max(d - 1 - (window - 1), 0) if window else 0 for d in depths]
    visible_pages = sum(
        len({p // ps for p in range(lo_b, d)}) for d, lo_b in zip(depths, lo)
    )
    # bytes this data needs: the visible pages' K and V codes (1 byte) and
    # their fp32 scales, q read and o written, lse, block table and pos
    nbytes = 2 * visible_pages * ps * nkv * (hd * kq.element_size() + 4) \
        + 2 * q.numel() * q.element_size() + lse.numel() * 4 + bt.nbytes + pos.numel() * 4
    visible_tokens = sum(max(d - lo_b, 0) for d, lo_b in zip(depths, lo))
    bound_ms, bound_by = bound(nbytes, 4 * hd * nh * visible_tokens, dtype)
    tol = TOLS[("paged_flash_decode", dtype)]
    flips, flips_ok = bf16_rounding_flips(o, o_ref, tol)
    rec = dict(
        kernel="paged_flash_decode_quant", case=f"window{window}" if window else "full",
        kv_dtype=kv_dtype, B=B, heads=list(heads), page_size=ps, depths=depths,
        dtype=DTYPE_NAMES[dtype], splits=pk.default_num_splits(B, nkv, max_pages),
        body=pk._plan(B, nh, nkv, hd, max_pages, None, dtype)[0],
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact, quant_launches=launched,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_pages=visible_pages, bytes=nbytes,
        rounding_flips=flips,
    )
    check(launched == 1, f"the quantized decode did not go through its kernel: {rec}")
    within = err <= tol or (ulp_flips and dtype == torch.bfloat16 and flips_ok)
    check(within and err_lse <= LSE_TOL and empty_exact,
          f"quantized paged_flash_decode disagrees with its plain version: {rec}")
    return rec


# the serving ring: sp_size 4, the JAX CLI's --fake-devices 8 mesh axis
RING_N = 4
# one bf16 ulp, relative: at most 2**-7 of the value
RING_ULP = 2.0**-7


def ring_paged_case(kv_dtype, gen, flush):
    """#4 (an fp pool) or 4q (an int8 pool), bf16 queries, as decode over a
    ring of 4 launches it: 8 slots of max_seq 2048 (512 slots a rank), page
    16, the ranks folded into ONE launch -- the pool [P, 4*16] viewed as
    [P*4, 16], the block table bt*4 + i, row b*4 + i at depth pos_b - i --
    with ``paged_case``'s depths (rows whose later ranks see no key, an
    all-empty row).  Then the ranks' lse combine (the split combine kernel
    over [B, 4] partials) against combine_split_partials."""
    from repro_torch.core import decode_attention as da

    n, B, ps, max_seq = RING_N, 8, 16, 2048
    max_pages = max_seq // n // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(8)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-(-(-depth // n)) // ps)  # rank 0 holds ceil(depth / n) positions
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    if kv_dtype == "fp":
        k_pool = randn(gen, num_pages, n * ps, HKV, D, dtype=torch.bfloat16)
        v_pool = randn(gen, num_pages, n * ps, HKV, D, dtype=torch.bfloat16)
        ks = vs = None
    else:
        k_pool, ks = kv_quant.quantize(randn(gen, num_pages, n * ps, HKV, D, dtype=torch.float32),
                                       kv_dtype)
        v_pool, vs = kv_quant.quantize(randn(gen, num_pages, n * ps, HKV, D, dtype=torch.float32),
                                       kv_dtype)
    fk, fv, fbt, fks, fvs = da._folded_pool(k_pool, v_pool, torch.from_numpy(bt).cuda(), ks, vs, n)
    kv_off, stride = da._rank_offsets(n, max_pages * ps, "striped", "cuda")
    q = randn(gen, B, 1, H, D, dtype=torch.bfloat16)
    q_f = da._fold_rows(q, n)
    pos_r = (da._fold_rows(pos.long(), n) - kv_off.repeat(B)).to(torch.int32)
    kw = dict(stride_kv=stride, k_scale=fks, v_scale=fvs)
    run = lambda: pk.paged_flash_decode(q_f, fk, fv, fbt, pos_r, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q_f, fk, fv, fbt, pos_r, 0, **kw)  # noqa: E731
    before = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    launched = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches - before
    blind = pos_r < 0
    live = ~blind[:, None, None] & (lse_ref > ref.NEG_INF / 2)
    diff = (o.float() - o_ref.float()).abs()
    err = float(diff.max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    blind_exact = bool(torch.all(o[blind] == 0)) and bool(torch.all(lse[blind] == ref.NEG_INF))
    # the function's work: each rank row's visible pages once (fp: K and V
    # in bf16; quantized: 1-byte codes and fp32 scales), the folded q read
    # and o written, lse, the folded block table and depths
    slots = [max(-(-(d - i) // n), 0) for d in depths for i in range(n)]
    pages = sum(-(-x // ps) for x in slots)
    per_slot = HKV * (D * k_pool.element_size() + (4 if ks is not None else 0))
    nbytes = 2 * pages * ps * per_slot + 2 * q_f.numel() * 2 + lse.numel() * 4 \
        + fbt.numel() * 4 + pos_r.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * D * H * sum(depths), torch.bfloat16)
    # the ranks' combine over these partials: [B, n, H, D] fp32 -> [B, H, D]
    o_parts = o.float().view(B, n, H, D)
    lse_parts = lse.view(B, n, H).contiguous()
    comb = lambda: pk.split_combine(o_parts, lse_parts, torch.bfloat16)  # noqa: E731
    comb_plain = lambda: pk.combine_split_partials(o_parts, lse_parts)  # noqa: E731
    c_before = pk.split_combine.launches
    (oc, lc), (oc_ref, lc_ref) = comb(), comb_plain()
    torch.cuda.synchronize()
    c_launched = pk.split_combine.launches - c_before
    atol, rtol = COMBINE_TOLS[torch.bfloat16]
    c_diff = (oc.float() - oc_ref).abs()
    c_ratio = float((c_diff / (atol + rtol * oc_ref.abs())).max())
    c_exact = bool(torch.all(oc[7] == 0)) and bool(torch.all(lc[7] == ref.NEG_INF))
    c_bytes = 4 * (o_parts.numel() + lse_parts.numel() + lc.numel()) + oc.numel() * 2
    c_bound_ms, c_bound_by = bound(c_bytes, 0, torch.bfloat16)
    c_dev, _ = device_time(_profiled(comb, 5), per=5)
    # #4's limit plus one bf16 ulp of the value: a rank row over a few keys
    # has |o| near 1 (not the average of hundreds of keys), where the two
    # sides' bf16 roundings of nearly equal fp32 sums can differ by an ulp
    tol = TOLS[("paged_flash_decode", torch.bfloat16)]
    ratio = float((diff / (tol + RING_ULP * o_ref.float().abs())).max())
    rec = dict(
        kernel="paged_flash_decode" + ("" if kv_dtype == "fp" else "_quant"), case="ring",
        ranks=n, kv_dtype=kv_dtype, B=B, rows=B * n, page_size=ps, depths=depths,
        dtype="bf16", splits=pk.default_num_splits(B * n, HKV, max_pages),
        launched=launched, max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_rtol=RING_ULP,
        max_err_over_tol=ratio, tol_lse=LSE_TOL,
        blind_rows=int(blind.sum()), blind_rows_exact=blind_exact,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_pages=pages,
        combine=dict(kernel="paged_decode_combine", case="ring", max_abs_err=float(c_diff.max()),
                     max_err_over_tol=c_ratio, empty_row_exact=c_exact, launched=c_launched,
                     ms=time_ms(comb), dev_ms=c_dev.get("paged_flash_decode", 0.0),
                     plain_ms=time_ms(comb_plain), library_ms=None, bound_ms=c_bound_ms,
                     bound_by=c_bound_by),
    )
    check(launched == 1 and c_launched == 1, f"the ring decode did not launch its kernels: {rec}")
    check(int(blind.sum()) > 0 and blind_exact,
          f"a rank that sees no key must give exactly o = 0, lse = NEG_INF: {rec}")
    check(ratio <= 1.0 and err_lse <= LSE_TOL,
          f"the folded paged decode disagrees with its plain version: {rec}")
    check(c_ratio <= 1.0 and c_exact, f"the ranks' combine disagrees with its plain version: {rec}")
    return rec


def ssd_case(name, B, S, H, P, G, N, chunk, gen, flush, dt_value=None, autograd=False):
    """One SSD chunked-scan case, fp32 inputs as the model gives them (dt
    through softplus, A = -exp(.)), against the plain chunked dual form.
    ``dt_value``: dt that value everywhere and A = -1 instead, so a chunk's
    sum of dt*|A| passes ~88 (where exp(-acum) would overflow).
    ``autograd``: inputs that require grad, so the call takes the training
    forward's split (``ssd.AUTOGRAD_TERMS``)."""
    x = randn(gen, B, S, H, P, dtype=torch.float32)
    dt = F.softplus(randn(gen, B, S, H, dtype=torch.float32))
    A = -torch.exp(0.5 * randn(gen, H, dtype=torch.float32))
    if dt_value is not None:
        dt, A = torch.full_like(dt, dt_value), -torch.ones_like(A)
    Bm = randn(gen, B, S, G, N, dtype=torch.float32)
    Cm = randn(gen, B, S, G, N, dtype=torch.float32)
    leaves = [t.requires_grad_(autograd) for t in (x, dt, A, Bm, Cm)]
    run = lambda: tuple(t.detach() for t in ssd.ssd_scan_fwd(*leaves, chunk=chunk))  # noqa: E731
    plain = torch.no_grad()(lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk))
    before = ssd.ssd_scan_fwd.launches, ssd.ssd_scan_fwd.launches_autograd
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    launched = ssd.ssd_scan_fwd.launches - before[0]
    launched_autograd = ssd.ssd_scan_fwd.launches_autograd - before[1]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    tol = SSD_REL_TOL * max(1.0, float(want[0].abs().max()))
    err_y = float((got[0] - want[0]).abs().max())
    err_state = float((got[1] - want[1]).abs().max())
    finite = bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    c = min(chunk, S)
    # inputs read once, y and the final state written once
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + Bm.numel() + Cm.numel()
                  + B * H * P * N)
    # what the function needs (S is a multiple of c): the causal half of each
    # chunk, (c+1)/2 pairs a token, for the group's C.B^T scores (N each) and
    # each head's intra-chunk y (P each), plus each head's inter-chunk term and
    # state update (2*P*N each); or the sequential recurrence's 5*P*N a token
    # and head, whichever is less
    chunked = B * S * (c + 1) * (G * N + H * P) + 4 * B * H * S * P * N
    flops = min(chunked, 5 * B * H * S * P * N)
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, SSD_PEAK)
    bound_ms_fp32, bound_by_fp32 = bound(nbytes, flops, torch.float32)
    by_class, _ = device_time(_profiled(lambda: (flush(), run()), 5), per=5)
    rec = dict(
        kernel="ssd_scan_fwd", case=name, B=B, S=S, H=H, P=P, G=G, N=N, chunk=c, dtype="fp32",
        dt_value=dt_value, terms=ssd.AUTOGRAD_TERMS if autograd else ssd.TERMS,
        max_abs_err=max(err_y, err_state), max_abs_err_y=err_y, max_abs_err_state=err_state,
        tol=tol, max_err_over_tol=max(err_y, err_state) / tol, finite=finite,
        bitwise_repeat=bitwise, launched=launched, launched_autograd=launched_autograd,
        ms=time_ms(run, flush=flush), dev_ms=by_class.get("ssd_scan_fwd", 0.0),
        plain_ms=time_ms(plain, reps=5), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, bound_ms_fp32_cores=bound_ms_fp32,
        bound_by_fp32_cores=bound_by_fp32, flops=flops, bytes=nbytes,
    )
    del got, again, want
    check(launched == 2 and launched_autograd == 2 * autograd,
          f"ssd_scan_fwd did not go through its kernel with its split: {rec}")
    check(finite and err_y <= tol and err_state <= tol and bitwise,
          f"ssd_scan_fwd disagrees with its plain version or repeats unequal: {rec}")
    return rec


def ssd_bwd_case(name, B, S, H, P, G, N, chunk, gen, flush, dt_value=None, dstate=False):
    """One case of the SSD scan's backward (#5b) against its plain version,
    inputs as ``ssd_case`` makes them plus dy and, with ``dstate``, a
    nonzero gradient of the final state: each gradient within SSD_REL_TOL
    of its largest |value| (fp32 sums in another order), a repeat bitwise
    equal."""
    x = randn(gen, B, S, H, P, dtype=torch.float32)
    dt = F.softplus(randn(gen, B, S, H, dtype=torch.float32))
    A = -torch.exp(0.5 * randn(gen, H, dtype=torch.float32))
    if dt_value is not None:
        dt, A = torch.full_like(dt, dt_value), -torch.ones_like(A)
    Bm = randn(gen, B, S, G, N, dtype=torch.float32)
    Cm = randn(gen, B, S, G, N, dtype=torch.float32)
    dy = randn(gen, B, S, H, P, dtype=torch.float32)
    ds = randn(gen, B, H, P, N, dtype=torch.float32) if dstate else None
    run = lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, ds, chunk=chunk)  # noqa: E731
    plain = lambda: ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, ds, chunk)  # noqa: E731
    before = ssd.ssd_scan_bwd.launches
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    launched = ssd.ssd_scan_bwd.launches - before
    names = ("dx", "ddt", "dA", "dB", "dC")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(names, got, want)}
    tols = {k: SSD_REL_TOL * max(1.0, float(w.abs().max())) for k, w in zip(names, want)}
    c = min(chunk, S)
    # read once: x, dy, B, C, dt, A (and dstate); written once: dx, dB, dC,
    # ddt, dA
    nbytes = 4 * (3 * x.numel() + 2 * (Bm.numel() + Cm.numel()) + 2 * dt.numel() + 2 * H
                  + (ds.numel() if dstate else 0))
    # the products of the chunked backward: per token the causal half of its
    # chunk, (c+1)/2 pairs, for the group's C.B^T (N) and each head's dy.x^T
    # (P), the intra-chunk dx (P), dB and dC (N each); and per token and head
    # the five state-sized products (the chunk state, the dy.C^T term, g B,
    # x^T g, dy h_in: P*N each)
    flops = 2 * B * S * ((c + 1) / 2 * (G * N + H * (2 * P + 2 * N)) + 5 * H * P * N)
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, SSD_PEAK)
    bound_ms_fp32, bound_by_fp32 = bound(nbytes, flops, torch.float32)
    by_class, _ = device_time(_profiled(lambda: (flush(), run()), 5), per=5)
    rec = dict(
        kernel="ssd_scan_bwd", case=name, B=B, S=S, H=H, P=P, G=G, N=N, chunk=c, dtype="fp32",
        dt_value=dt_value, dstate=dstate,
        max_abs_err=max(errs.values()), max_abs_err_by_grad=errs, tol_by_grad=tols,
        finite=finite, bitwise_repeat=bitwise, launched=launched,
        ms=time_ms(run, flush=flush), dev_ms=by_class.get("ssd_scan_bwd", 0.0),
        plain_ms=time_ms(plain, reps=5), library_ms=None, library="none",
        bound_ms=bound_ms, bound_by=bound_by, bound_ms_fp32_cores=bound_ms_fp32,
        bound_by_fp32_cores=bound_by_fp32, flops=flops, bytes=nbytes,
    )
    del got, again, want
    check(launched == 2, f"ssd_scan_bwd did not go through its kernel: {rec}")
    check(finite and bitwise and all(errs[k] <= tols[k] for k in names),
          f"ssd_scan_bwd disagrees with its plain version or repeats unequal: {rec}")
    return rec


def device_time(prof, per=1, classify=None):
    """(device ms per kernel class, device ms per kernel name) of a
    torch.profiler run, divided by ``per`` (ticks, steps or calls);
    ``classify`` maps a kernel name to its class (``_kernel_class``)."""
    classify = classify or _kernel_class
    by_class, by_kernel = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / per
        cls = classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_kernel[ev.key[:80]] = by_kernel.get(ev.key[:80], 0.0) + ms
    return by_class, by_kernel


def _profiled(fn, reps, attempts=3):
    """``fn`` run ``reps`` times under torch.profiler.  A warm-up window is
    opened and discarded first, as tests/test_torch_cuda.py does: a
    profiling session can close before the tracer has delivered the card's
    events, and then reports no device time at all.  A window that still
    holds no device event is opened again, ``attempts`` times at most."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return prof

    window(1)
    for _ in range(attempts):
        prof = window(reps)
        if any(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.key_averages()):
            break
    return prof


def bwd_counts():
    """Backward calls per body and the fp32 body's pre-pass launches."""
    return {**{b: getattr(fa.flash_attention_bwd, f"launches_{b}") for b in BWD_BODIES},
            "split": fa.split_terms.launches}


def bwd_case(name, S, dtype, gen, heads=(H, HKV, D), Sq=None):
    """One flash-backward case (dQ and dK/dV kernels) at ``heads`` (query
    heads, kv heads, head dim; granite-8b's by default), ``Sq`` rows (default
    S) over S keys.  The segment case gives row 0 a document id no key has:
    a fully masked row, whose dq must be exactly 0.  The window and striped
    cases pass delta in; the others derive it from o.  ``full`` is a full
    band (whisper's encoder, S rows; its cross-attention, Sq rows)."""
    H, HKV, D = heads
    Sq = S if Sq is None else Sq
    INF = ref.BAND_INF
    band, sq, skv, seg_q, seg_kv, given = (0, 0, 0, INF), 1, 1, None, None, False
    if name == "full":
        band = ops.full_band()
    elif name == "window":
        band, given = (0, 0, 0, 255), True
    elif name == "striped":
        band, sq, skv, given = (1, 0, 0, INF), 2, 2, True
    elif name == "segment":
        cuts = np.sort(np.random.default_rng(S).choice(np.arange(1, S), 5, replace=False))
        ids = np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)
        seg_kv = torch.from_numpy(ids.copy()).cuda()
        ids[0] = -1
        seg_q = torch.from_numpy(ids).cuda()
    q = randn(gen, 1, Sq, H, D, dtype=dtype)
    k = randn(gen, 1, S, HKV, D, dtype=dtype)
    v = randn(gen, 1, S, HKV, D, dtype=dtype)
    do = randn(gen, 1, Sq, H, D, dtype=dtype)
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv, seg_q=seg_q, seg_kv=seg_kv)
    o, lse = ref.attention_ref(q, k, v, band=band, **kw)  # the forward's saved state
    delta = (do.float() * o.float()).sum(-1) if given else None
    run = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, None if given else o, lse, do, band, delta=delta, **kw)
    plain = lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)  # noqa: E731
    before = bwd_counts()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    ran = {b: n - before[b] for b, n in bwd_counts().items()}
    body = [b for b in BWD_BODIES if ran[b]]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    atol, rtol = BWD_TOLS[dtype]
    errs, ratio = {}, 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        errs[gname] = float(diff.max())
        ratio = max(ratio, float((diff / (atol + rtol * w.float().abs())).max()))
    masked_row_zero = seg_q is None or bool(torch.all(got[0][:, 0] == 0))
    del got, again, want
    mask = ref.band_mask(Sq, S, band, stride_q=sq, stride_kv=skv, device="cuda")
    if seg_q is not None:
        mask = mask & (seg_q[:, None] == seg_kv[None, :])
    pairs = int(mask.sum())
    vis_keys = int(mask.any(dim=0).sum())
    vis_rows = int(mask.any(dim=1).sum())
    # library yardstick: the backward of one SDPA call (dq, dk, dv together)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    if name in ("causal", "full"):  # no mask
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=name == "causal",
                                             scale=D**-0.5, enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=D**-0.5,
                                             enable_gqa=True)
    dout = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dout, retain_graph=True)  # noqa: E731
    item = q.element_size()
    seg_bytes = 2 * S * 4 if seg_q is not None else 0
    # dQ: q, dO read and dq written for every row, K/V of the visible keys,
    # lse and delta; dK/dV: q, dO, lse, delta of the rows that see a key,
    # k, v read and dk, dv written
    dq_bytes = 3 * Sq * H * D * item + 2 * vis_keys * HKV * D * item + 2 * H * Sq * 4 + seg_bytes
    dkv_bytes = 2 * vis_rows * H * D * item + 4 * S * HKV * D * item + 2 * H * vis_rows * 4 \
        + seg_bytes
    # bounds at the tensor cores' bf16 peak, the kernels' own units; the
    # CUDA cores' fp32 peak (the earlier kernels' units) as a labelled extra
    dq_bound, dq_by = bound(dq_bytes, 6 * D * H * pairs, dtype, BWD_PEAK)
    dkv_bound, dkv_by = bound(dkv_bytes, 8 * D * H * pairs, dtype, BWD_PEAK)
    split, _ = device_time(_profiled(run, 5), per=5)  # the kernels' device ms apart
    rec = dict(
        kernel="flash_attention_bwd", case=name, S=S, Sq=Sq, dtype=DTYPE_NAMES[dtype],
        heads=list(heads), body=body[0] if len(body) == 1 else body, pre_pass_launches=ran["split"],
        delta="given" if given else "from_o", max_abs_err=errs, tol_atol=atol, tol_rtol=rtol,
        max_err_over_tol=ratio, bitwise_repeat=bitwise, masked_row_dq_zero=masked_row_zero,
        ms_dq=split.get("flash_bwd_dq", 0.0), ms_dkv=split.get("flash_bwd_dkv", 0.0),
        ms_split=split.get("flash_bwd_split", 0.0),
        ms_pair=time_ms(run, reps=10), plain_ms_pair=time_ms(plain, reps=5),
        library_ms_pair=time_ms(lib, reps=10),
        bound_ms_dq=dq_bound, bound_by_dq=dq_by, bound_ms_dkv=dkv_bound, bound_by_dkv=dkv_by,
        bound_ms_dq_fp32_cores=bound(dq_bytes, 6 * D * H * pairs, torch.float32)[0],
        bound_ms_dkv_fp32_cores=bound(dkv_bytes, 8 * D * H * pairs, torch.float32)[0],
        visible_pairs_per_head=pairs,
    )
    del out, qt, kt, vt, mask
    torch.cuda.empty_cache()
    want_body = fa._bwd_plan(1, Sq, S, H, HKV, D, dtype)
    check(body == [want_body] and ran["split"] == (2 if want_body == "tc_fp32" else 0),
          f"flash_attention_bwd ran {ran}, not the {want_body} body: {rec}")
    check(ratio <= 1.0 and bitwise and masked_row_zero,
          f"flash_attention_bwd disagrees with its plain version or repeats unequal: {rec}")
    check(rec["ms_dq"] > 0 and rec["ms_dkv"] > 0
          and (rec["ms_split"] > 0) == (want_body == "tc_fp32"),
          f"the profiler saw no device time for the backward kernels: {split}")
    return rec


def split_case(S, gen):
    """The fp32 backward's pre-pass at the training row's operands (granite
    heads, S tokens) against its plain version: bitwise equal terms."""
    xs = [randn(gen, 1, S, h, D, dtype=torch.float32) for h in (H, HKV, HKV, H)]
    run = lambda: fa.split_terms(*xs)  # noqa: E731
    plain = lambda: tuple(fa.split_terms_ref(x) for x in xs)  # noqa: E731
    before = fa.split_terms.launches
    got, want = run(), plain()
    torch.cuda.synchronize()
    launched = fa.split_terms.launches - before
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    n = sum(x.numel() for x in xs)
    bound_ms, bound_by = bound(n * (4 + 2 * 2), 0, torch.float32)  # fp32 in, two bf16 out
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(kernel="flash_bwd_split", S=S, dtype="fp32", max_abs_err=err, exact=exact,
               launched=launched, ms=time_ms(run), device_ms=device_ms.get("flash_bwd_split", 0.0),
               plain_ms=time_ms(plain), library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    del got, want, xs
    check(launched == 1 and exact, f"flash_bwd_split disagrees with its plain version: {rec}")
    return rec


def fwd_split_case(S, gen):
    """The fp32 forward's pre-pass at the training row's operands (granite
    heads, S tokens) against its plain version: bitwise equal terms."""
    xs = [randn(gen, 1, S, h, D, dtype=torch.float32) for h in (H, HKV, HKV)]
    run = lambda: fa.fwd_split_terms(*xs)  # noqa: E731
    plain = lambda: tuple(fa.split_terms_ref(x) for x in xs)  # noqa: E731
    before = fa.fwd_split_terms.launches
    got, want = run(), plain()
    torch.cuda.synchronize()
    launched = fa.fwd_split_terms.launches - before
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    n = sum(x.numel() for x in xs)
    bound_ms, bound_by = bound(n * (4 + 2 * 2), 0, torch.float32)  # fp32 in, two bf16 out
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(kernel="flash_fwd_split", S=S, dtype="fp32", max_abs_err=err, exact=exact,
               launched=launched, ms=time_ms(run),
               device_ms=device_ms.get("flash_attention_fwd", 0.0), plain_ms=time_ms(plain),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    del got, want, xs
    check(launched == 1 and exact, f"flash_fwd_split disagrees with its plain version: {rec}")
    return rec


# --------------------------------------------------------------------------
# phases 3 and 4: the engine
# --------------------------------------------------------------------------


def serve_trace(eng, lengths, arrivals, new_tokens, vocab, seed):
    rng = np.random.default_rng(seed)
    rids = [
        eng.submit(rng.integers(0, vocab, (n,), dtype=np.int32), new_tokens, arrival_tick=t)
        for n, t in zip(lengths, arrivals)
    ]
    done = eng.run()
    return [done[r] for r in rids]


def cross_device(arch="granite-8b", phase="slice", quant_run=False, loop_prompt=False,
                 keep=None):
    """Full width, 2 layers, fp32: card (kernels) vs CPU (plain versions).
    QKV biases (qwen2.5-32b) are drawn nonzero: init leaves them 0.
    ``quant_run``: a third run over an int8 pool with chunk 256 and spec_k
    4, held as slice_quant holds its pools (a flip only on a near-tie,
    first-token logits within SLICE_LOGIT_TOL["int8"]).  ``loop_prompt``:
    that run's first prompt is slice_quant's looping one (12 tokens 8
    times) in place of a random one, so that the prompt-lookup proposer has
    drafts to verify where the model's own stream never repeats a token.
    ``keep`` (a dict) receives the config, the card's weights and the CPU
    side of the paged and int8 runs (their ServeConfig, prompts, arrivals,
    streams and logits), for a later phase to reuse."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    if cfg.qkv_bias:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        for name in ("bq", "bk", "bv"):
            bias = params["layers"]["attn"][name]
            bias.copy_(0.5 * torch.randn(bias.shape, generator=gen, device="cuda"))
    params_cpu = _tree_to(params, "cpu")
    lengths, arrivals = [64, 137, 200], [0, 0, 1]
    out = {}
    for paged in (False, True):
        serve = ServeConfig(max_seq=256, num_slots=4, paged=paged,
                            page_size=16 if paged else None, cache_dtype=torch.float32)
        streams, first_logits = {}, {}
        launches = {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            fa.flash_attention_fwd.launches = pk.paged_flash_decode.launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            res = serve_trace(eng, lengths, arrivals, 8, cfg.vocab_size, seed=1)
            streams[dev] = [r.generated for r in res]
            first_logits[dev] = [eng.debug_logits[r.rid][0] for r in res]
            launches[dev] = (fa.flash_attention_fwd.launches, pk.paged_flash_decode.launches)
        if keep is not None and paged:
            rng = np.random.default_rng(1)  # serve_trace's prompts
            keep["oneshot_fp"] = dict(
                serve=serve, arrivals=arrivals, streams=streams["cpu"],
                prompts=[rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n in lengths],
                first_logits=first_logits["cpu"])
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(first_logits["cuda"], first_logits["cpu"]))
        key = "paged" if paged else "dense"
        out[key] = dict(
            streams_identical=streams["cuda"] == streams["cpu"], first_logits_max_abs_err=err,
            cuda_launches={"flash_attention_fwd": launches["cuda"][0],
                           "paged_flash_decode": launches["cuda"][1]},
            cpu_launches=sum(launches["cpu"]),
        )
        tag = f"{phase} {key}"
        check(streams["cuda"] == streams["cpu"], f"{tag}: card and CPU streams differ: {streams}")
        check(err <= 1e-3, f"{tag}: first-token logits differ by {err} > 1e-3")
        check(launches["cuda"][0] > 0 and launches["cpu"] == (0, 0),
              f"{tag}: kernels must run on the card only: {launches}")
        if paged:
            check(launches["cuda"][1] > 0, f"{tag}: the paged engine never launched #4")
    if quant_run:
        out["int8_chunk_spec"] = _slice_int8_chunk_spec(cfg, params, params_cpu, lengths,
                                                         arrivals, phase, loop_prompt, keep)
    if keep is not None:
        keep.update(cfg=cfg, params=params)
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": phase, "arch": arch, "num_layers": 2, "dtype": "fp32",
          "lengths": lengths, "new_tokens": 8, **out})


def _slice_int8_chunk_spec(cfg, params, params_cpu, lengths, arrivals, phase,
                           loop_prompt=False, keep=None):
    """cross_device's int8 run: chunk 256 (budget 512), spec_k 4, page 16,
    card vs CPU.  Streams identical but for near-tie flips (both sides
    score the two candidates within twice the limit), first-token logits
    within SLICE_LOGIT_TOL["int8"], decode ticks on 4q only, chunks and
    verifies on the fp32 bodies (the pool's dequantized view), no kernel on
    the CPU side."""
    tol = SLICE_LOGIT_TOL["int8"]
    serve = ServeConfig(max_seq=256, num_slots=4, paged=True, page_size=16,
                        cache_dtype=torch.float32, prefill_chunk=256, tick_token_budget=512,
                        spec_k=4, kv_dtype="int8")
    side = {}
    # serve_trace's prompts, the first slice_quant's looping one with loop_prompt
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (lengths[1:] if loop_prompt else lengths)]
    if loop_prompt:
        prompts = [_slice_quant_trace(cfg.vocab_size)[0][0]] + prompts
    for dev, p in (("cuda", params), ("cpu", params_cpu)):
        fa.flash_attention_fwd.launches = fa.flash_attention_fwd.launches_fp32 = 0
        pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
        eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
        eng.capture_logits = True
        rids = [eng.submit(pr, 8, arrival_tick=t) for pr, t in zip(prompts, arrivals)]
        done = eng.run()
        res = [done[r] for r in rids]
        side[dev] = dict(
            streams=[r.generated for r in res], logits=[eng.debug_logits[r.rid] for r in res],
            launches={"flash_attention_fwd": fa.flash_attention_fwd.launches,
                      "flash_attention_fwd (fp32)": fa.flash_attention_fwd.launches_fp32,
                      "paged_flash_decode": pk.paged_flash_decode.launches,
                      "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches},
            decode_launches=eng.decode_launches, prefill_launches=eng.prefill_launches,
            chunk_launches=eng.chunk_launches, verify_launches=eng.verify_launches,
            spec_accepted=eng.spec_accepted,
            pages_in_use=eng.kv_cache_stats()["pages_in_use"])
    card, cpu = side["cuda"], side["cpu"]
    if keep is not None:
        keep["chunk_spec_int8"] = dict(serve=serve, arrivals=arrivals, prompts=prompts,
                                       streams=cpu["streams"], logits=cpu["logits"])
    err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu["logits"]))
    flips = _near_tie_flips(card, cpu)
    rec = dict(streams_identical=card["streams"] == cpu["streams"], near_tie_flips=flips,
               first_logits_max_abs_err=err, logit_tol=tol, cuda_launches=card["launches"],
               cpu_launches=sum(cpu["launches"].values()),
               **{k: card[k] for k in ("decode_launches", "prefill_launches", "chunk_launches",
                                       "verify_launches", "spec_accepted", "pages_in_use")})
    tag = f"{phase} int8_chunk_spec"
    L = cfg.num_layers
    check(all(max(f["card_gap"], f["cpu_gap"]) <= 2 * tol for f in flips),
          f"{tag}: streams differ beyond a near-tie: {rec}")
    check(err <= tol, f"{tag}: first-token logits differ by {err} > {tol}")
    check(rec["cpu_launches"] == 0, f"{tag}: kernels launched on the CPU side: {rec}")
    check(card["launches"]["paged_flash_decode"] == 0
          and card["launches"]["paged_flash_decode_quant"] == L * card["decode_launches"] > 0,
          f"{tag}: decode ticks must run 4q once per layer: {rec}")
    check(card["launches"]["flash_attention_fwd"]
          == card["launches"]["flash_attention_fwd (fp32)"]
          == L * (card["prefill_launches"] + card["chunk_launches"] + card["verify_launches"])
          > 0 and card["chunk_launches"] > 0 and card["verify_launches"] > 0,
          f"{tag}: chunks and verifies must run the fp32 bodies once per layer: {rec}")
    check(card["pages_in_use"] == cpu["pages_in_use"] == 0, f"{tag}: pages left: {rec}")
    return rec


# the serve trace: prompt lengths and arrival ticks, 32 greedy tokens each
SERVE_LENGTHS = [96, 200, 333, 512, 640, 777, 1000, 1500]
SERVE_ARRIVALS = [0, 0, 1, 2, 3, 5, 8, 13]


def full_serve(card):
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
    ))
    # warm-up (cuBLAS handles, allocator), outside the measured run
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skip = eng.tick_stats()["ticks"]
    lengths, arrivals = SERVE_LENGTHS, SERVE_ARRIVALS
    fa.flash_attention_fwd.launches = 0
    pk.paged_flash_decode.launches = 0
    bodies0 = fwd_body_counts()
    t0 = time.perf_counter()
    res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "paged_flash_decode": pk.paged_flash_decode.launches}
    bodies = fwd_body_delta(bodies0)
    stats = eng.tick_stats()
    pf_tok = sum(stats["prefill_tokens"][skip:])
    pf_s = sum(stats["prefill_s"][skip:])
    dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
    dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
    # tokens generated by decode launches (the first token of each request
    # comes off its prefill logits)
    dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
    kv = eng.kv_cache_stats()
    rec = {
        "phase": "serve", "arch": "granite-8b", "num_layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "dtype": "bf16", "params": tfm.param_count(params),
        "paged": True, "page_size": 16, "max_seq": 2048, "num_slots": 8,
        "lengths": lengths, "arrival_ticks": arrivals, "new_tokens": 32,
        "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip,
        "wall_s": wall, "init_s": init_s,
        "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
        "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
        "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
        "ttft_ticks": [r.ttft_ticks for r in res],
        "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "flash_attention_fwd_bodies": bodies, "card": card,
    }
    rec["decode_profile"] = profile_decode(eng, cfg)
    emit(rec)
    check(all(r.status == "ok" and len(r.generated) == 32 for r in res),
          f"not every request finished ok: {rec['statuses']}")
    check(kv["pages_in_use"] == 0, f"pages still in use after the drain: {kv['pages_in_use']}")
    check(launches["flash_attention_fwd"] > 0 and launches["paged_flash_decode"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    # bf16 one-shot prefill: every flash launch on the tile body
    check(bodies == {"tile": launches["flash_attention_fwd"], "decode": 0, "fp32": 0},
          f"serve: bf16 prefill launches must all run the tile body: {bodies}")
    return {**launches, "flash_attention_fwd (tile)": bodies["tile"]}, rec, \
        [r.generated for r in res]


def _code_steps(a, b):
    """|a - b| in steps of the codes' own format (int8: 1; fp8-e4m3: the
    spacing at the larger magnitude, 2**(exponent - 3), 2**-9 below the
    normals)."""
    fa, fb = a.float(), b.float()
    if a.dtype == torch.int8:
        return (fa - fb).abs()
    mag = torch.maximum(fa.abs(), fb.abs()).clamp_min(2.0**-6)
    return (fa - fb).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 3)


def _first_flip(a, b):
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def _slice_quant_trace(V):
    """slice_quant's (and slice_ring's) prompts and arrival ticks."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, V, (64,), dtype=np.int32)
    prompts = [
        np.tile(rng.integers(0, V, (12,), dtype=np.int32), 8),  # repetitive: drafts accepted
        rng.integers(0, V, (137,), dtype=np.int32),
        np.concatenate([prefix, rng.integers(0, V, (40,), dtype=np.int32)]),  # shared prefix
        np.concatenate([prefix, rng.integers(0, V, (56,), dtype=np.int32)]),
    ]
    return prompts, [0, 0, 1, 2]


def _near_tie_flips(card, cpu):
    """Where two runs' streams part: each request's first differing token
    and both sides' logit gaps between the two candidates (``card`` and
    ``cpu``: dicts of streams and per-token logits)."""
    flips = []
    for i, (a, b) in enumerate(zip(card["streams"], cpu["streams"])):
        if a != b:
            j = _first_flip(a, b)
            la, lb = card["logits"][i][j], cpu["logits"][i][j]
            flips.append(dict(request=i, token=j, card=a[j], cpu=b[j],
                              card_gap=float(la[a[j]] - la[b[j]]),
                              cpu_gap=float(lb[b[j]] - lb[a[j]])))
    return flips


def _slice_serve(kv_dtype, paged=True):
    return ServeConfig(max_seq=256, num_slots=4, paged=paged, page_size=16 if paged else None,
                       cache_dtype=torch.float32, prefill_chunk=64, tick_token_budget=128,
                       spec_k=4, kv_dtype=kv_dtype)


def cross_device_quant():
    """Full width, 2 layers, fp32, int8 and fp8 pools with continuous
    prefill and speculative verify: card (kernels) vs CPU (plain versions).
    Returns the CPU runs per pool, which slice_ring holds the ring to."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    params_cpu = _tree_to(params, "cpu")
    prompts, arrivals = _slice_quant_trace(cfg.vocab_size)
    out, card_first, problems, cpu_runs = {}, {}, [], {}
    for kv_dtype in ("fp",) + QUANT_DTYPES:
        tol = SLICE_LOGIT_TOL[kv_dtype]
        serve = _slice_serve(kv_dtype)
        side, pools = {}, {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            fa.flash_attention_fwd.launches = 0
            pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
            done = eng.run()
            kv = eng.kv_cache_stats()
            # the final pools (freed pages keep their data): card vs CPU
            pools[dev] = {key: eng._cache[key].cpu() for key in ("k", "v", "k_scale", "v_scale")
                          if key in eng._cache}
            side[dev] = dict(
                streams=[done[r].generated for r in rids],
                logits=[eng.debug_logits[r] for r in rids],
                launches={"flash_attention_fwd": fa.flash_attention_fwd.launches,
                          "paged_flash_decode": pk.paged_flash_decode.launches,
                          "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches},
                counters={"chunk_launches": eng.chunk_launches,
                          "verify_launches": eng.verify_launches,
                          "decode_launches": eng.decode_launches,
                          "spec_accepted": eng.spec_accepted, "shared_hits": kv["shared_hits"],
                          "pages_in_use": kv["pages_in_use"],
                          "scale_entries_in_use": kv["scale_entries_in_use"],
                          "dequant_fallbacks": kv["dequant_fallbacks"]},
            )
        card, cpu = side["cuda"], side["cpu"]
        cpu_runs[kv_dtype] = cpu
        err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu["logits"]))
        card_first[kv_dtype] = [x[0] for x in card["logits"]]
        # printed, not gated: how far the card's and CPU's final pools are
        # apart (comparable while both sides served the same tokens).  A
        # layer's flipped codes move its output, so deeper layers' K/V and
        # codes drift further apart than the first layer's
        pool_rec = {}
        if kv_dtype != "fp" and card["streams"] == cpu["streams"]:
            for key in ("k", "v"):
                a, b = pools["cuda"][key], pools["cpu"][key]
                sa, sb = pools["cuda"][f"{key}_scale"], pools["cpu"][f"{key}_scale"]
                apart = a.view(torch.uint8) != b.view(torch.uint8)
                pool_rec[key] = dict(
                    codes_apart=int(apart.sum()), codes=int(apart.numel()),
                    max_code_steps=float(_code_steps(a, b).max()),
                    max_amax_diff=float((sa - sb).abs().max()) * QMAX[kv_dtype],
                )
        flips = []
        for i, (a, b) in enumerate(zip(card["streams"], cpu["streams"])):
            if a != b:
                j = _first_flip(a, b)
                la, lb = card["logits"][i][j], cpu["logits"][i][j]
                flips.append(dict(request=i, token=j, card=a[j], cpu=b[j],
                                  card_gap=float(la[a[j]] - la[b[j]]),
                                  cpu_gap=float(lb[b[j]] - lb[a[j]])))
        out[kv_dtype] = dict(
            streams_identical=card["streams"] == cpu["streams"], near_tie_flips=flips,
            first_logits_max_abs_err=err, logit_tol=tol, pools=pool_rec,
            cuda_launches=card["launches"], cpu_launches=sum(cpu["launches"].values()),
            cuda=card["counters"], cpu=cpu["counters"],
        )
        if kv_dtype != "fp":
            # what quantization itself does to the first token, on the card
            out[kv_dtype]["card_vs_fp_first_logits_max_abs_err"] = max(
                float(np.abs(a - b).max()) for a, b in zip(card_first[kv_dtype], card_first["fp"])
            )
        for f in flips:
            if max(f["card_gap"], f["cpu_gap"]) > 2 * tol:
                problems.append(f"slice_quant {kv_dtype}: streams differ beyond a near-tie: {f}")
        if err > tol:
            problems.append(f"slice_quant {kv_dtype}: first-token logits differ by {err} > {tol}")
        for dev in ("cuda", "cpu"):
            c = side[dev]["counters"]
            if not c["pages_in_use"] == c["scale_entries_in_use"] == c["dequant_fallbacks"] == 0:
                problems.append(f"slice_quant {kv_dtype} on {dev}: pages or scales left, or a "
                                f"fallback: {c}")
        used, unused = (("paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
                        else ("paged_flash_decode_quant", "paged_flash_decode"))
        if not (card["launches"][unused] == 0 and card["launches"][used]
                == cfg.num_layers * card["counters"]["decode_launches"] > 0):
            problems.append(f"slice_quant {kv_dtype}: decode ticks must run {used}: "
                            f"{card['launches']}, {card['counters']}")
        if out[kv_dtype]["cpu_launches"]:
            problems.append("slice_quant: kernels launched on the CPU side")
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": "slice_quant", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          "lengths": [len(x) for x in prompts], "arrivals": arrivals, "new_tokens": 8,
          "page_size": 16, "prefill_chunk": 64, "tick_token_budget": 128, "spec_k": 4,
          **out})
    check(not problems, "; ".join(problems))
    return cpu_runs


def full_serve_quant(card):
    """The serve phase's model and trace with continuous prefill and
    speculative verify, from an fp, an int8 and an fp8 pool."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    lengths, arrivals = SERVE_LENGTHS, SERVE_ARRIVALS
    runs, streams, launches_out, problems = {}, {}, {}, []
    for kv_dtype in ("fp",) + QUANT_DTYPES:
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
            prefill_chunk=256, tick_token_budget=512, spec_k=4, kv_dtype=kv_dtype,
        ))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_fwd.launches = fa.fwd_split_terms.launches = 0
        pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
        bodies0 = fwd_body_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, lengths, arrivals, 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                    "fwd_split": fa.fwd_split_terms.launches,
                    "paged_flash_decode": pk.paged_flash_decode.launches,
                    "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches}
        bodies = fwd_body_delta(bodies0)
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"]), sum(stats["prefill_s"])
        dec_ticks = [i for i in range(stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        # tokens committed by decode and verify launches (each request's
        # first token comes off its last chunk's logits)
        dec_tok = sum(stats["decode_tokens"]) - len(res)
        streams[kv_dtype] = [r.generated for r in res]
        rec = {
            "kv_dtype": kv_dtype, "statuses": [r.status for r in res], "ticks": stats["ticks"],
            "wall_s": wall, "prefill_tokens": pf_tok, "prefill_s": pf_s,
            "prefill_tok_per_s": pf_tok / pf_s, "decode_tokens": dec_tok, "decode_s": dec_s,
            "decode_tok_per_s": dec_tok / dec_s, "decode_ticks": len(dec_ticks),
            "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "verify_launches": eng.verify_launches, "decode_launches": eng.decode_launches,
            "chunk_launches": eng.chunk_launches,
            "tokens_per_verify_launch": (eng.verify_tokens / eng.verify_launches
                                         if eng.verify_launches else None),
            "spec_proposed": eng.spec_proposed, "spec_accepted": eng.spec_accepted,
            "ttft_ticks": [r.ttft_ticks for r in res], "chunks": [r.chunks for r in res],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pool_bytes": kv["cache_bytes"] + kv["scale_table_bytes"],
            "pages_in_use": kv["pages_in_use"], "scale_entries_in_use": kv["scale_entries_in_use"],
            "peak_pages": kv["peak_in_use"], "dequant_fallbacks": kv["dequant_fallbacks"],
            "launches": launches, "flash_attention_fwd_bodies": bodies,
        }
        if kv_dtype != "fp":
            pairs = [(a, b) for x, y in zip(streams[kv_dtype], streams["fp"]) for a, b in zip(x, y)]
            rec["tokens_matching_fp"] = sum(a == b for a, b in pairs) / len(pairs)
        runs[kv_dtype] = rec
        launches_out[kv_dtype] = launches
        del eng
        torch.cuda.empty_cache()
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_quant {kv_dtype}: not every request finished ok")
        if not rec["pages_in_use"] == rec["scale_entries_in_use"] == 0:
            problems.append(f"serve_quant {kv_dtype}: pages or scale entries left after the drain")
        if rec["dequant_fallbacks"]:
            problems.append(f"serve_quant {kv_dtype}: a gather fallback served a decode tick")
        if not (launches["flash_attention_fwd"] > 0 and rec["chunk_launches"] > 0):
            problems.append(f"serve_quant {kv_dtype}: chunks must run the flash forward")
        # bf16 chunks (tile body) and verifies (decode body) over the fp pool;
        # a quantized pool's fp32 dequantized view takes q to fp32
        want = ({"fp32": 0} if kv_dtype == "fp"
                else {"tile": 0, "decode": 0, "fp32": launches["flash_attention_fwd"]})
        if any(bodies[b] != n for b, n in want.items()) \
                or sum(bodies.values()) != launches["flash_attention_fwd"]:
            problems.append(f"serve_quant {kv_dtype}: flash bodies {bodies}, want {want}")
        if launches["fwd_split"] != bodies["fp32"]:
            problems.append(f"serve_quant {kv_dtype}: the fp32 pre-pass not once per fp32 "
                            f"forward: {launches}, {bodies}")
        used, unused = (("paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
                        else ("paged_flash_decode_quant", "paged_flash_decode"))
        if not (launches[unused] == 0
                and launches[used] == cfg.num_layers * rec["decode_launches"] > 0):
            problems.append(f"serve_quant {kv_dtype}: decode ticks must launch {used} 36 times "
                            f"each: {launches}, {rec['decode_launches']} decode launches")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_quant", "arch": "granite-8b", "num_layers": cfg.num_layers,
          "dtype": "bf16", "paged": True, "page_size": 16, "max_seq": 2048, "num_slots": 8,
          "prefill_chunk": 256, "tick_token_budget": 512, "spec_k": 4, "lengths": lengths,
          "arrival_ticks": arrivals, "new_tokens": 32, "runs": runs, "card": card})
    check(not problems, "; ".join(problems))
    return launches_out["int8"], runs, streams


# slice_ring and serve_ring: the engine at sp_size 4 (a virtual ring on the
# card) against sp_size 1.  serve_ring's bf16 streams may differ from the
# serve phase's only where the ring's run scores the two candidates within
# RING_NEAR_TIE of each other (the ranks' partials are rounded to bf16 and
# summed in another order than one rank's flash decode)
RING_NEAR_TIE = 0.25
# the ring's peak device memory may exceed the serve phase's by this much (a
# per-tick copy of the pool would take ~2.4 GB)
RING_PEAK_SLACK_GB = 1.0


def _kernel_counts():
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "paged_flash_decode": pk.paged_flash_decode.launches,
            "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches,
            "paged_decode_combine": pk.split_combine.launches,
            "fwd_split": fa.fwd_split_terms.launches,
            **{f"fwd_{b}": n for b, n in fwd_body_counts().items()}}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _ring_launch_problems(tag, L, launches, decode, chunk, verify, decode_kernel, prefill=0):
    """The folded launches of a ring run of ``decode`` / ``chunk`` /
    ``verify`` engine launches: per layer, one decode launch (#4, 4q, or #1
    for the dense cache) per decode tick, one #1 launch per chunk and verify
    launch (``prefill``: #1 launches of one-shot prefill besides), one
    combine per decode, chunk and verify launch."""
    steps = decode + chunk + verify
    want = {"paged_decode_combine": L * steps,
            "flash_attention_fwd": L * (chunk + verify) + prefill}
    if decode_kernel == "flash_attention_fwd":
        want["flash_attention_fwd"] += L * decode
    else:
        want[decode_kernel] = L * decode
    got = {k: launches[k] for k in want}
    return [] if got == want and decode > 0 else [
        f"{tag}: launches {got}, want {want} (decode {decode}, chunk {chunk}, verify {verify})"]


def _run_ring_slice(cfg, params, kv_dtype, paged, prompts, arrivals):
    """One slice_ring run on the card at sp_size 4."""
    ctx = ParallelCtx(sp_size=RING_N, device="cuda")
    eng = ServeEngine(cfg, params, ctx, serve=_slice_serve(kv_dtype, paged))
    eng.capture_logits = True
    before = _kernel_counts()
    rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
    done = eng.run()
    kv = eng.kv_cache_stats()
    return eng, dict(
        streams=[done[r].generated for r in rids], logits=[eng.debug_logits[r] for r in rids],
        launches=_delta(before, _kernel_counts()),
        counters={"chunk_launches": eng.chunk_launches, "verify_launches": eng.verify_launches,
                  "decode_launches": eng.decode_launches, "spec_accepted": eng.spec_accepted,
                  "pages_in_use": kv.get("pages_in_use", 0),
                  "scale_entries_in_use": kv.get("scale_entries_in_use", 0),
                  "dequant_fallbacks": kv.get("dequant_fallbacks", 0),
                  "combine_hops": ctx.ring.stats.hops.get("combine", 0)},
    )


def slice_ring(cpu_runs):
    """granite-8b at full width, 2 layers, fp32, slice_quant's weights and
    trace (continuous prefill, chunk 64, budget 128, spec_k 4): the engine at
    sp_size 4 on the card against sp_size 1 on the CPU, over the dense cache
    and the fp / int8 / fp8 paged pools (the CPU's paged runs are
    slice_quant's)."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    prompts, arrivals = _slice_quant_trace(cfg.vocab_size)
    out, problems, total = {}, [], {}
    for cache in ("dense", "fp") + QUANT_DTYPES:
        kv_dtype, paged = ("fp", False) if cache == "dense" else (cache, True)
        tol = SLICE_LOGIT_TOL[kv_dtype]
        cpu = cpu_runs.get(cache) if paged else None
        if cpu is None:
            params_cpu = _tree_to(params, "cpu")
            eng = ServeEngine(cfg, params_cpu, ParallelCtx(device="cpu"),
                              serve=_slice_serve(kv_dtype, paged))
            eng.capture_logits = True
            rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
            done = eng.run()
            cpu = dict(streams=[done[r].generated for r in rids],
                       logits=[eng.debug_logits[r] for r in rids])
            del eng, params_cpu
        eng, card = _run_ring_slice(cfg, params, kv_dtype, paged, prompts, arrivals)
        for k, v in card["launches"].items():
            total[k] = total.get(k, 0) + v
        decode_kernel = ("flash_attention_fwd" if not paged else
                         "paged_flash_decode" if kv_dtype == "fp" else "paged_flash_decode_quant")
        c = card["counters"]
        problems += _ring_launch_problems(f"slice_ring {cache}", cfg.num_layers,
                                          card["launches"], c["decode_launches"],
                                          c["chunk_launches"], c["verify_launches"],
                                          decode_kernel)
        del eng
        err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu["logits"]))
        flips = []
        for i, (a, b) in enumerate(zip(card["streams"], cpu["streams"])):
            if a != b:
                j = _first_flip(a, b)
                la, lb = card["logits"][i][j], cpu["logits"][i][j]
                flips.append(dict(request=i, token=j, ring=a[j], one_rank=b[j],
                                  ring_gap=float(la[a[j]] - la[b[j]]),
                                  one_rank_gap=float(lb[b[j]] - lb[a[j]])))
        out[cache] = dict(streams_identical=card["streams"] == cpu["streams"],
                          near_tie_flips=flips, first_logits_max_abs_err=err, logit_tol=tol,
                          cuda_launches=card["launches"], cuda=c)
        if flips and kv_dtype == "fp":
            problems.append(f"slice_ring {cache}: streams differ: {flips}")
        for f in flips:
            if max(f["ring_gap"], f["one_rank_gap"]) > 2 * tol:
                problems.append(f"slice_ring {cache}: streams differ beyond a near-tie: {f}")
        if err > tol:
            problems.append(f"slice_ring {cache}: first-token logits differ by {err} > {tol}")
        if not c["pages_in_use"] == c["scale_entries_in_use"] == c["dequant_fallbacks"] == 0:
            problems.append(f"slice_ring {cache}: pages or scales left, or a fallback: {c}")
        if card["launches"]["fwd_fp32"] != card["launches"]["flash_attention_fwd"]:
            problems.append(f"slice_ring {cache}: an fp32 flash launch off the fp32 bodies")
        if card["launches"]["fwd_split"] != card["launches"]["fwd_fp32"]:
            problems.append(f"slice_ring {cache}: the fp32 pre-pass not once per fp32 forward")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "slice_ring", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          "sp_size": RING_N, "lengths": [len(x) for x in prompts], "arrivals": arrivals,
          "new_tokens": 8, "page_size": 16, "prefill_chunk": 64, "tick_token_budget": 128,
          "spec_k": 4, **out})
    check(not problems, "; ".join(problems))
    return total


def _ring_kernel_class(name: str) -> str:
    if "paged_decode_combine" in name:  # #4's split merge and the ranks' combine
        return "combine"
    return _mesh_kernel_class(name)


def _mesh_prefill_launches(bucket: int) -> int:
    """#1 launches of one layer of one-shot prefill over the ring: the
    engine prefills every admission group (one prompt too) as a packed row
    under a segment mask, as JAX's does, and the Mesh-Attention forward
    launches a segment-masked block once per rank (a launch takes one
    segment-id array), so: the blocks of the mesh schedule (a = 2 at n = 4)
    x the ranks."""
    cfg = MeshAttentionConfig(transport=None, n=RING_N, a=2, mask=MaskSpec.segment())
    return len(cfg.schedules(bucket)[0].blocks()) * RING_N


def serve_ring(card, serve_rec, serve_streams):
    """This slice's main path: the serve phase's model (granite-8b at full
    width and depth, bf16) and trace at ParallelCtx(sp_size=4), a virtual
    ring of 4 ranks on the card: one-shot prefill (the Mesh-Attention
    forward), then continuous prefill (chunk 256, budget 512) with spec_k
    4, both over the fp pool."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    L = cfg.num_layers
    runs, problems, total = {}, [], {}
    for name, extra in (("one_shot", {}),
                        ("chunk_spec", dict(prefill_chunk=256, tick_token_budget=512, spec_k=4))):
        ctx = ParallelCtx(sp_size=RING_N, device="cuda")
        eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
            **extra))
        # warm-up (cuBLAS handles, allocator), outside the measured run
        eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skip = eng.tick_stats()["ticks"]
        counts0 = (eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                   eng.prefill_launches)
        eng.capture_logits = True
        ctx.ring.stats.reset()
        before = _kernel_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, SERVE_LENGTHS, [a + skip for a in SERVE_ARRIVALS], 32,
                          cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _delta(before, _kernel_counts())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        decode_l, chunk_l, verify_l, prefill_l = (
            a - b for a, b in zip((eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                                   eng.prefill_launches), counts0))
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"][skip:]), sum(stats["prefill_s"][skip:])
        dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
        streams = [r.generated for r in res]
        flips = []
        for i, (a, b) in enumerate(zip(streams, serve_streams)):
            if a != b:
                j = _first_flip(a, b)
                row = eng.debug_logits[res[i].rid][j]
                top2 = np.sort(row)[-2:]
                flips.append(dict(request=i, token=j, ring=a[j], one_rank=b[j],
                                  top2_gap=float(top2[1] - top2[0]),
                                  ring_gap_to_one_rank=float(row[a[j]] - row[b[j]])))
        combine_bytes = ctx.ring.stats.bytes.get("combine", 0)
        steps = decode_l + chunk_l + verify_l
        bhd = 8 * cfg.num_heads * cfg.hd  # O(B.H.D): one rank's o per layer and decode tick
        rec = {
            "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip, "wall_s": wall,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "ttft_ticks": [r.ttft_ticks for r in res],
            "prefill_launches": prefill_l, "chunk_launches": chunk_l,
            "verify_launches": verify_l, "decode_launches": decode_l,
            "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "serve_peak_mem_gb": serve_rec["peak_mem_gb"],
            "launches": launches, "streams_equal_serve": streams == serve_streams,
            "flips_vs_serve": flips,
            "combine_bytes_per_step": combine_bytes / steps if steps else None,
            "combine_bytes_model_per_step": L * bhd * (2 + 4 / cfg.hd),
            "hops": dict(ctx.ring.stats.hops),
        }
        if name == "one_shot":
            rec["decode_profile"] = profile_decode(eng, cfg, classify=_ring_kernel_class)
        runs[name] = rec
        # gates
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_ring {name}: not every request finished ok: {rec['statuses']}")
        if kv["pages_in_use"]:
            problems.append(f"serve_ring {name}: {kv['pages_in_use']} pages left after the drain")
        blocks = (sum(_mesh_prefill_launches(eng.scheduler.bucket_for(n))
                      for n in SERVE_LENGTHS) if name == "one_shot" else 0)
        problems += _ring_launch_problems(f"serve_ring {name}", L, launches, decode_l, chunk_l,
                                          verify_l, "paged_flash_decode", prefill=L * blocks)
        if launches["paged_flash_decode_quant"] or launches["fwd_fp32"]:
            problems.append(f"serve_ring {name}: a quantized decode or an fp32 flash launch")
        if name == "one_shot":
            want = {"fwd_tile": L * blocks, "fwd_decode": 0, "prefill_launches": len(res)}
            got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
                   "prefill_launches": prefill_l}
        else:
            want = {"fwd_tile": L * chunk_l, "fwd_decode": L * verify_l, "prefill_launches": 0}
            got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
                   "prefill_launches": prefill_l}
        if got != want:
            problems.append(f"serve_ring {name}: flash launches by body {got}, want {want}")
        if rec["peak_mem_gb"] > serve_rec["peak_mem_gb"] + RING_PEAK_SLACK_GB:
            problems.append(f"serve_ring {name}: peak {rec['peak_mem_gb']:.2f} GB > the serve "
                            f"phase's {serve_rec['peak_mem_gb']:.2f} + {RING_PEAK_SLACK_GB}")
        for f in flips:
            if f["ring_gap_to_one_rank"] > RING_NEAR_TIE:
                problems.append(f"serve_ring {name}: a flip beyond a near-tie: {f}")
        del eng, ctx
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_ring", "arch": "granite-8b", "num_layers": L, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "dtype": "bf16", "sp_size": RING_N, "paged": True, "page_size": 16, "max_seq": 2048,
          "num_slots": 8, "lengths": SERVE_LENGTHS, "arrival_ticks": SERVE_ARRIVALS,
          "new_tokens": 32, "near_tie": RING_NEAR_TIE, "runs": runs, "card": card})
    check(not problems, "; ".join(problems))
    return total


# --------------------------------------------------------------------------
# phases 4g and 4h: serving under memory pressure
# --------------------------------------------------------------------------

# slice_pressure: JAX's tests/test_robustness.py pool (page 4, 13 pages, chunk
# 8, oversubscribe 2.0, the sweep every tick) at full width, 2 layers, fp32
PRESSURE_SLICE = dict(max_seq=64, num_slots=3, paged=True, page_size=4, num_pages=13,
                      prefill_chunk=8, oversubscribe=2.0, health_every=1,
                      cache_dtype=torch.float32)
PRESSURE_SLICE_CHAOS = dict(seed=6, ticks=16, squeezes=2, squeeze_hold=3, nan_ticks=1,
                            drop_ticks=1)
# serve_pressure: the serve trace's lifetime need is 334 pages of 16 tokens
# (its prompts alone 318).  Admission books lifetimes against 2x the pool but
# needs a prompt's pages (and one more) free at once, so only a pool that
# the admitted prompts fill to within their decode growth preempts: the
# schedule (token-independent: no EOS) preempts at 114-120 pages and at
# none of 100-112 or 124-240 (CPU runs of the same engine on the reduced
# config).  118 preempts once, with or without the chaos seed below
PRESSURE_PAGES = 118
# seed 4 over 64 ticks: a dropped grant (t33), two squeezes, a NaN tick (t55)
PRESSURE_SERVE_CHAOS = dict(seed=4, ticks=64)


def _pressure_trace(V, chaos):
    """slice_pressure's prompts and token budget: JAX's token-identity case
    (3 x 16 tokens, 12 new) or its chaos case (4 x 16, 10 new)."""
    if chaos:
        rng = np.random.default_rng(13)
        return [rng.integers(0, V, (16,), dtype=np.int32) for _ in range(4)], 10
    rng = np.random.default_rng(3)
    return [rng.integers(0, V, (16,), dtype=np.int32) for _ in range(3)], 12


def slice_pressure():
    """granite-8b at full width, 2 layers, fp32: the same weights served on
    the card (kernels) and on the CPU (plain versions) under oversubscription
    (13 pages of 4, preempt-and-recompute), from an fp and an int8 pool,
    plain and with JAX's chaos seed (squeezes, a NaN tick, a dropped grant)."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    params_cpu = _tree_to(params, "cpu")
    out, problems = {}, []
    for kv_dtype in ("fp", "int8"):
        for run in ("pressure", "chaos"):
            prompts, new = _pressure_trace(cfg.vocab_size, run == "chaos")
            side = {}
            for dev, p in (("cuda", params), ("cpu", params_cpu)):
                inj = (ChaosInjector(ChaosConfig(**PRESSURE_SLICE_CHAOS)) if run == "chaos"
                       else None)
                eng = ServeEngine(cfg, p, ParallelCtx(device=dev), chaos=inj,
                                  serve=ServeConfig(**PRESSURE_SLICE, kv_dtype=kv_dtype))
                before = _kernel_counts()
                rids = [eng.submit(x, new) for x in prompts]
                done = eng.run()
                kv = eng.kv_cache_stats()
                eng.health()
                side[dev] = dict(
                    outcome=[(done[r].status, done[r].generated, done[r].preemptions,
                              done[r].recompute_tokens) for r in rids],
                    events=list(inj.events) if inj else [],
                    preemptions=eng.preemptions, recompute_tokens=eng.recompute_tokens,
                    dropped_grants=eng.chaos_dropped_grants, left=(
                        kv["pages_in_use"], kv["scale_entries_in_use"], kv["seized_pages"]),
                    launches=_delta(before, _kernel_counts()),
                    decode_launches=eng.decode_launches, chunk_launches=eng.chunk_launches,
                )
                del eng
            card, cpu = side["cuda"], side["cpu"]
            tag = f"slice_pressure {kv_dtype} {run}"
            statuses = [o[0] for o in card["outcome"]]
            out[f"{kv_dtype}_{run}"] = dict(
                identical=card["outcome"] == cpu["outcome"] and card["events"] == cpu["events"],
                statuses=statuses, preemptions=card["preemptions"],
                recompute_tokens=card["recompute_tokens"], events=card["events"],
                dropped_grants=card["dropped_grants"], cuda_launches=card["launches"],
                cpu_launches=sum(cpu["launches"].values()),
            )
            if card["outcome"] != cpu["outcome"] or card["events"] != cpu["events"]:
                problems.append(f"{tag}: card and CPU differ: {card['outcome']} {card['events']}"
                                f" vs {cpu['outcome']} {cpu['events']}")
            if card["preemptions"] < 1:
                problems.append(f"{tag}: no preemption")
            if card["left"] != (0, 0, 0) or cpu["left"] != (0, 0, 0):
                problems.append(f"{tag}: pages, scales or seized pages left: {card['left']}")
            if run == "chaos" and statuses.count("numeric_error") != 1:
                problems.append(f"{tag}: the NaN tick must retire one request: {statuses}")
            if run == "pressure" and statuses != ["ok"] * len(statuses):
                problems.append(f"{tag}: not every request finished ok: {statuses}")
            decode_kernel = "paged_flash_decode" if kv_dtype == "fp" else "paged_flash_decode_quant"
            L = cfg.num_layers
            if not (card["launches"][decode_kernel] == L * card["decode_launches"] > 0
                    and card["launches"]["fwd_fp32"] == L * card["chunk_launches"] > 0):
                problems.append(f"{tag}: launches {card['launches']} off the decode "
                                f"({card['decode_launches']}) and chunk "
                                f"({card['chunk_launches']}) launches")
            if out[f"{kv_dtype}_{run}"]["cpu_launches"]:
                problems.append(f"{tag}: kernels launched on the CPU side")
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": "slice_pressure", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          **{k: (str(v) if k == "cache_dtype" else v) for k, v in PRESSURE_SLICE.items()},
          "chaos": PRESSURE_SLICE_CHAOS, **out})
    check(not problems, "; ".join(problems))


def _poisoned_slot(events):
    hits = [e for e in events if ":nan:slot" in e]
    return int(hits[0].rsplit("slot", 1)[1]) if len(hits) == 1 else None


def serve_pressure(card, quant_runs, quant_streams):
    """granite-8b at full width and depth, bf16, the serve trace over a pool of
    PRESSURE_PAGES pages with oversubscribe 2.0 (chunk 256, budget 512): the
    fp pool, the int8 pool, and the fp pool with a chaos seed, twice.  Held to
    serve_quant's roomy fp and int8 runs of the same call (a flip only where
    the pressure run scores its top two within RING_NEAR_TIE)."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    L = cfg.num_layers
    runs, problems, outcomes, main = {}, [], {}, {}
    for name, kv_dtype, chaos in (("fp", "fp", False), ("int8", "int8", False),
                                  ("chaos_1", "fp", True), ("chaos_2", "fp", True)):
        inj = ChaosInjector(ChaosConfig(**PRESSURE_SERVE_CHAOS)) if chaos else None
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), chaos=inj, serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, num_pages=PRESSURE_PAGES,
            cache_dtype=torch.bfloat16, prefill_chunk=256, tick_token_budget=512,
            oversubscribe=2.0, health_every=1, kv_dtype=kv_dtype,
        ))
        eng.capture_logits = True  # the flip rule reads the run's logits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _kernel_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, SERVE_LENGTHS, SERVE_ARRIVALS, 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _delta(before, _kernel_counts())
        health = eng.health()
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"]), sum(stats["prefill_s"])
        dec_ticks = [i for i in range(stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"]) - len(res)
        roomy = quant_streams["int8" if kv_dtype == "int8" else "fp"]
        flips = []
        for i, (r, want) in enumerate(zip(res, roomy)):
            if r.status == "ok" and r.generated != want:
                j = _first_flip(r.generated, want)
                row = eng.debug_logits[r.rid][j]
                top2 = np.sort(row)[-2:]
                flips.append(dict(request=i, token=j, pressure=r.generated[j], roomy=want[j],
                                  top2_gap=float(top2[1] - top2[0]),
                                  gap_to_roomy=float(row[r.generated[j]] - row[want[j]])))
        rec = {
            "kv_dtype": kv_dtype, "chaos": PRESSURE_SERVE_CHAOS if chaos else None,
            "statuses": [r.status for r in res], "ticks": stats["ticks"], "wall_s": wall,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "preemptions": eng.preemptions, "recompute_tokens": eng.recompute_tokens,
            "per_request_preemptions": [r.preemptions for r in res],
            "chunk_launches": eng.chunk_launches, "decode_launches": eng.decode_launches,
            "chaos_events": list(inj.events) if inj else [],
            "chaos_dropped_grants": eng.chaos_dropped_grants,
            "numeric_errors": eng.numeric_errors, "health_sweeps": eng.health_sweeps,
            "ttft_ticks": [r.ttft_ticks for r in res],
            "pool_bytes": kv["cache_bytes"] + kv["scale_table_bytes"],
            "peak_pages": kv["peak_in_use"], "pages_in_use": kv["pages_in_use"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "flips_vs_roomy": flips,
        }
        runs[name] = rec
        outcomes[name] = [(r.status, r.generated, r.preemptions, r.recompute_tokens)
                          for r in res]
        tag = f"serve_pressure {name}"
        if not (rec["preemptions"] >= 1 and rec["recompute_tokens"] > 0):
            problems.append(f"{tag}: no preemption under {PRESSURE_PAGES} pages")
        if not (kv["pages_in_use"] == kv["scale_entries_in_use"] == kv["seized_pages"] == 0
                and health["ok"]):
            problems.append(f"{tag}: pages left or the sweep failed: {kv['pages_in_use']}")
        oks = [r for r in res if r.status == "ok"]
        if not all(len(r.generated) == 32 for r in oks):
            problems.append(f"{tag}: an ok request short of 32 tokens")
        if chaos:
            slot = _poisoned_slot(rec["chaos_events"])
            bad = [r for r in res if r.status != "ok"]
            if not (slot is not None and len(bad) == 1 and bad[0].status == "numeric_error"
                    and bad[0].slot == slot):
                problems.append(f"{tag}: exactly the poisoned slot ({slot}) must end "
                                f"numeric_error: {rec['statuses']}, {rec['chaos_events']}")
        elif len(oks) != len(res):
            problems.append(f"{tag}: not every request finished ok: {rec['statuses']}")
        for f in flips:
            if f["gap_to_roomy"] > RING_NEAR_TIE:
                problems.append(f"{tag}: a flip beyond a near-tie: {f}")
        # per layer one #1 launch per chunk launch (tile body; fp32 bodies over
        # the int8 pool's view) and one #4 / 4q launch per decode launch
        chunk_body, decode_kernel, other = (
            ("fwd_tile", "paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
            else ("fwd_fp32", "paged_flash_decode_quant", "paged_flash_decode"))
        want = {chunk_body: L * rec["chunk_launches"],
                "flash_attention_fwd": L * rec["chunk_launches"],
                decode_kernel: L * rec["decode_launches"], other: 0}
        if {k: launches[k] for k in want} != want or not rec["decode_launches"]:
            problems.append(f"{tag}: launches {launches}, want {want}")
        if launches["fwd_split"] != launches["fwd_fp32"]:
            problems.append(f"{tag}: the fp32 pre-pass not once per fp32 forward: {launches}")
        if name in ("fp", "int8"):
            for k, v in launches.items():
                main[k] = main.get(k, 0) + v
        del eng
        torch.cuda.empty_cache()
    if outcomes["chaos_1"] != outcomes["chaos_2"] or \
            runs["chaos_1"]["chaos_events"] != runs["chaos_2"]["chaos_events"]:
        problems.append("serve_pressure: the two chaos runs differ")
    roomy_fp = quant_runs["fp"]
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_pressure", "arch": "granite-8b", "num_layers": L, "dtype": "bf16",
          "paged": True, "page_size": 16, "num_pages": PRESSURE_PAGES, "lifetime_pages": sum(
              -(-(n + 32) // 16) for n in SERVE_LENGTHS), "oversubscribe": 2.0,
          "max_seq": 2048, "num_slots": 8, "prefill_chunk": 256, "tick_token_budget": 512,
          "lengths": SERVE_LENGTHS, "arrival_ticks": SERVE_ARRIVALS, "new_tokens": 32,
          "near_tie": RING_NEAR_TIE, "chaos_runs_identical": outcomes["chaos_1"] == outcomes[
              "chaos_2"], "runs": runs,
          "serve_quant_fp": {k: roomy_fp[k] for k in (
              "prefill_tok_per_s", "decode_tok_per_s", "ms_per_decode_tick", "pool_bytes",
              "peak_mem_gb", "ticks")},
          "card": card})
    check(not problems, "; ".join(problems))
    return main


def _ssm_state_bytes(eng):
    """Bytes of the engine's SSM cache (conv windows and states, all slots)."""
    return sum(t.numel() * t.element_size() for t in eng._cache["ssm"].values())


def cross_device_ssm():
    """mamba2-370m and hymba-1.5b at full width, 2 layers, fp32: card (the
    SSD kernel; hymba's attention on the flash forward) vs CPU (plain
    versions), exact-length prefill."""
    lengths, arrivals = [48, 64, 192, 320], [0, 0, 1, 2]
    out, problems = {}, []
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        serve = ServeConfig(max_seq=512, num_slots=4, cache_dtype=torch.float32)
        side = {}
        for dev, p in (("cuda", params), ("cpu", _tree_to(params, "cpu"))):
            fa.flash_attention_fwd.launches = ssd.ssd_scan_fwd.launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            res = serve_trace(eng, lengths, arrivals, 8, cfg.vocab_size, seed=4)
            side[dev] = dict(
                streams=[r.generated for r in res],
                first=[eng.debug_logits[r.rid][0] for r in res],
                launches={"ssd_scan_fwd": ssd.ssd_scan_fwd.launches,
                          "flash_attention_fwd": fa.flash_attention_fwd.launches},
                prefill_launches=eng.prefill_launches, decode_launches=eng.decode_launches,
                statuses=[r.status for r in res],
            )
        card, cpu = side["cuda"], side["cpu"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card["first"], cpu["first"]))
        want_ssd = cfg.num_layers * card["prefill_launches"]
        want_flash = (cfg.num_layers * (card["prefill_launches"] + card["decode_launches"])
                      if cfg.hybrid else 0)
        out[arch] = dict(
            streams_identical=card["streams"] == cpu["streams"], first_logits_max_abs_err=err,
            cuda_launches=card["launches"], cpu_launches=sum(cpu["launches"].values()),
            prefill_launches=card["prefill_launches"], decode_launches=card["decode_launches"],
        )
        if card["streams"] != cpu["streams"]:
            problems.append(f"slice_ssm {arch}: card and CPU streams differ: {side}")
        if err > 1e-3:
            problems.append(f"slice_ssm {arch}: first-token logits differ by {err} > 1e-3")
        if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
            problems.append(f"slice_ssm {arch}: not every request finished ok")
        if card["launches"] != {"ssd_scan_fwd": want_ssd, "flash_attention_fwd": want_flash} \
                or out[arch]["cpu_launches"]:
            problems.append(f"slice_ssm {arch}: launches {card['launches']} (CPU "
                            f"{out[arch]['cpu_launches']}), want ssd {want_ssd}, "
                            f"flash {want_flash}")
        del params
        torch.cuda.empty_cache()
    emit({"phase": "slice_ssm", "num_layers": 2, "dtype": "fp32", "lengths": lengths,
          "arrivals": arrivals, "new_tokens": 8, **out})
    check(not problems, "; ".join(problems))


def full_serve_ssm(card):
    """mamba2-370m and hymba-1.5b at full width and depth, bf16, 8 slots,
    max_seq 2048; every prompt <= 64 or a multiple of 64 (exact mode)."""
    lengths = [48, 64, 128, 256, 384, 640, 1024, 1536]
    arrivals = [0, 0, 1, 2, 3, 5, 8, 13]
    runs, launches_total, problems = {}, 0, []
    decode_body_launches = 0
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
            max_seq=2048, num_slots=8, cache_dtype=torch.bfloat16,
        ))
        # warm-up (cuBLAS handles, allocator), outside the measured run
        eng.generate(np.arange(64, dtype=np.int32)[None], max_new_tokens=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skip = eng.tick_stats()["ticks"]
        prefills0, decodes0 = eng.prefill_launches, eng.decode_launches
        fa.flash_attention_fwd.launches = ssd.ssd_scan_fwd.launches = 0
        bodies0 = fwd_body_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ssd_scan_fwd": ssd.ssd_scan_fwd.launches,
                    "flash_attention_fwd": fa.flash_attention_fwd.launches}
        bodies = fwd_body_delta(bodies0)
        prefills = eng.prefill_launches - prefills0
        decodes = eng.decode_launches - decodes0
        stats = eng.tick_stats()
        pf_tok = sum(stats["prefill_tokens"][skip:])
        pf_s = sum(stats["prefill_s"][skip:])
        dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
        ssm_bytes = _ssm_state_bytes(eng)
        rec = {
            "arch": arch, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "ssm": dataclasses.asdict(cfg.ssm), "vocab": cfg.vocab_size,
            "params": tfm.param_count(params), "statuses": [r.status for r in res],
            "ticks": stats["ticks"] - skip, "wall_s": wall, "init_s": init_s,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "ttft_ticks": [r.ttft_ticks for r in res],
            "ssm_state_bytes": ssm_bytes, "ssm_state_bytes_per_slot": ssm_bytes / 8,
            "kv_cache_bytes": eng.kv_cache_stats()["cache_bytes"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefill_launches": prefills, "decode_launches": decodes, "launches": launches,
            "flash_attention_fwd_bodies": bodies,
        }
        rec["decode_profile"] = profile_decode(eng, cfg)
        runs[arch] = rec
        launches_total += launches["ssd_scan_fwd"]
        want_flash = cfg.num_layers * (prefills + decodes) if cfg.hybrid else 0
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_ssm {arch}: not every request finished ok: {rec['statuses']}")
        if launches != {"ssd_scan_fwd": cfg.num_layers * len(lengths),
                        "flash_attention_fwd": want_flash} or prefills != len(lengths):
            problems.append(f"serve_ssm {arch}: launches {launches} over {prefills} prefill and "
                            f"{decodes} decode launches; want ssd {cfg.num_layers * len(lengths)}"
                            f", flash {want_flash}")
        # hymba: window prefill on the tile body, each Sq = 1 tick on the decode body
        want_bodies = ({"tile": cfg.num_layers * prefills, "decode": cfg.num_layers * decodes,
                        "fp32": 0} if cfg.hybrid else {"tile": 0, "decode": 0, "fp32": 0})
        if bodies != want_bodies:
            problems.append(f"serve_ssm {arch}: flash bodies {bodies}, want {want_bodies}")
        if cfg.hybrid:
            decode_body_launches = bodies["decode"]
        del eng, params
        torch.cuda.empty_cache()
    emit({"phase": "serve_ssm", "dtype": "bf16", "max_seq": 2048, "num_slots": 8,
          "lengths": lengths, "arrival_ticks": arrivals, "new_tokens": 32, "runs": runs,
          "card": card})
    check(not problems, "; ".join(problems))
    return launches_total, decode_body_launches


# --------------------------------------------------------------------------
# phases 4k and 4l: the SSM and hybrid archs over a ring of 4
# --------------------------------------------------------------------------


class _ScanBatches:
    """Records the batch of every SSD scan call of the model (the ranks
    folded into it over a ring), by wrapping ``models/ssm.py``'s
    ``ssd_scan_fwd``."""

    def __enter__(self):
        self.batches, self._orig = [], ssm_mod.ssd_scan_fwd

        def recording(x, *args, **kw):
            self.batches.append(int(x.shape[0]))
            return self._orig(x, *args, **kw)

        ssm_mod.ssd_scan_fwd = recording
        return self

    def __exit__(self, *exc):
        ssm_mod.ssd_scan_fwd = self._orig


def _ssd_comm_model(cfg, lengths, itemsize, n=RING_N):
    """The sharded scan's exchanges for one prefill of each prompt (batch 1)
    through every layer: per layer ceil((w-1) / m) halo hops of min(k m,
    w-1) rows of conv_dim inputs (m = S/n rows a rank), one gather of the
    fp32 state (H P N) and total decay (H), one gather of the w-1 row conv
    tail; bytes one rank sends."""
    d_inner = cfg.ssm.expand * cfg.d_model
    H, P, N, G = (d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim,
                  cfg.ssm.n_groups)
    conv_dim, need, L = d_inner + 2 * G * N, cfg.ssm.conv_width - 1, cfg.num_layers
    hops = {"ssd_halo": 0, "ssd_state": L * len(lengths), "ssd_tail": L * len(lengths)}
    nbytes = {"ssd_halo": 0, "ssd_state": L * len(lengths) * H * (P * N + 1) * 4,
              "ssd_tail": L * len(lengths) * need * conv_dim * itemsize}
    for S in lengths:
        m = S // n
        rounds = -(-need // m)
        hops["ssd_halo"] += L * rounds
        nbytes["ssd_halo"] += L * sum(min(k * m, need) for k in range(1, rounds + 1)) \
            * conv_dim * itemsize
    return hops, nbytes


def _hybrid_prefill_blocks(cfg, S, n=RING_N):
    """#1 launches of one layer of a hybrid prefill over the ring: the
    blocks of the mesh schedule (a = 2 at n = 4) for the contiguous,
    windowed mask, every block one launch with the ranks folded."""
    mcfg = MeshAttentionConfig(transport=None, n=n, a=2, mask=MaskSpec.causal(window=cfg.window),
                               layout=cfg.causal_layout)
    return len(mcfg.schedules(S)[0].blocks())


def _ssm_ring_problems(tag, cfg, launches, batches, hops, nbytes, lengths, prefills, decodes,
                       itemsize, dtype):
    """The gates shared by slice_ssm_ring and serve_ssm_ring: #5 once per
    layer per prefill with the 4 ranks folded into its batch; hymba's #1 on
    the prefill blocks and once per layer per decode tick (the decode body
    for bf16), one combine per layer per decode tick; the exchanges'
    hops and bytes against ``_ssd_comm_model``."""
    L, problems = cfg.num_layers, []
    if launches["ssd_scan_fwd"] != L * prefills or batches != [RING_N] * (L * prefills):
        problems.append(f"{tag}: #5 launched {launches['ssd_scan_fwd']} times at batches "
                        f"{sorted(set(batches))}, want {L} x {prefills} at batch {RING_N}")
    want_hops, want_bytes = _ssd_comm_model(cfg, lengths, itemsize)
    got_hops = {k: hops.get(k, 0) for k in want_hops}
    got_bytes = {k: nbytes.get(k, 0) for k in want_bytes}
    if (got_hops, got_bytes) != (want_hops, want_bytes):
        problems.append(f"{tag}: exchanges {got_hops} / {got_bytes} bytes, want {want_hops} / "
                        f"{want_bytes}")
    if cfg.hybrid:
        blocks = L * sum(_hybrid_prefill_blocks(cfg, S) for S in lengths)
        if dtype == torch.bfloat16:
            want = {"fwd_tile": blocks, "fwd_decode": L * decodes, "fwd_fp32": 0}
        else:
            want = {"fwd_tile": 0, "fwd_decode": 0, "fwd_fp32": blocks + L * decodes}
        want.update(flash_attention_fwd=blocks + L * decodes, paged_decode_combine=L * decodes)
        if hops.get("combine", 0) != L * decodes:
            problems.append(f"{tag}: {hops.get('combine', 0)} combines, want {L} x {decodes}")
    else:
        want = {"flash_attention_fwd": 0, "paged_decode_combine": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        problems.append(f"{tag}: #1 / combine launches {got}, want {want}")
    return problems


def _ssm_ring_run(cfg, params, ctx, serve, lengths, arrivals, new_tokens, seed):
    """One engine run of a trace -> (engine, results, kernel launch deltas,
    the scan batches, the ring's hops and bytes)."""
    eng = ServeEngine(cfg, params, ctx, serve=serve)
    eng.capture_logits = True
    if ctx.ring is not None:
        ctx.ring.stats.reset()
    before = {**_kernel_counts(), "ssd_scan_fwd": ssd.ssd_scan_fwd.launches}
    with _ScanBatches() as scans:
        res = serve_trace(eng, lengths, arrivals, new_tokens, cfg.vocab_size, seed=seed)
    launches = _delta(before, {**_kernel_counts(), "ssd_scan_fwd": ssd.ssd_scan_fwd.launches})
    stats = ctx.ring.stats if ctx.ring is not None else None
    return eng, res, launches, scans.batches, \
        dict(stats.hops) if stats else {}, dict(stats.bytes) if stats else {}


def slice_ssm_ring():
    """mamba2-370m and hymba-1.5b at full width, 2 layers, fp32: the engine
    at sp_size 4 on the card (the sharded scan, #5 with the ranks folded;
    hymba's attention through the Mesh-Attention forward and the folded
    decode) against sp_size 1 on the CPU (plain versions).  The 8-token
    prompt leaves each rank 2 rows, fewer than the conv halo's 3."""
    lengths, arrivals = [8, 48, 256, 512], [0, 0, 1, 2]
    out, problems = {}, []
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        serve = ServeConfig(max_seq=1024, num_slots=4, cache_dtype=torch.float32)
        side = {}
        for dev, p, ctx in (
            ("cuda", params, ParallelCtx(sp_size=RING_N, device="cuda")),
            ("cpu", _tree_to(params, "cpu"), ParallelCtx(device="cpu")),
        ):
            eng, res, launches, batches, hops, nbytes = _ssm_ring_run(
                cfg, p, ctx, serve, lengths, arrivals, 8, seed=4)
            side[dev] = dict(
                streams=[r.generated for r in res],
                first=[eng.debug_logits[r.rid][0] for r in res],
                statuses=[r.status for r in res], launches=launches, batches=batches,
                hops=hops, bytes=nbytes, prefills=eng.prefill_launches,
                decodes=eng.decode_launches,
            )
            del eng
        card, cpu = side["cuda"], side["cpu"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card["first"], cpu["first"]))
        kernel_keys = ("ssd_scan_fwd", "flash_attention_fwd", "paged_decode_combine",
                       "paged_flash_decode", "paged_flash_decode_quant")
        cpu_launches = sum(cpu["launches"][k] for k in kernel_keys)
        out[arch] = dict(
            streams_identical=card["streams"] == cpu["streams"], first_logits_max_abs_err=err,
            cuda_launches={k: card["launches"][k] for k in kernel_keys + (
                "fwd_tile", "fwd_decode", "fwd_fp32")},
            cpu_launches=cpu_launches, scan_batches=sorted(set(card["batches"])),
            hops=card["hops"], bytes=card["bytes"], prefill_launches=card["prefills"],
            decode_launches=card["decodes"],
        )
        tag = f"slice_ssm_ring {arch}"
        if card["streams"] != cpu["streams"]:
            problems.append(f"{tag}: sp_size 4 on the card and 1 on the CPU differ: {side}")
        if err > 1e-3:
            problems.append(f"{tag}: first-token logits differ by {err} > 1e-3")
        if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
            problems.append(f"{tag}: not every request finished ok")
        if cpu_launches:
            problems.append(f"{tag}: a kernel ran on the CPU side: {cpu['launches']}")
        problems += _ssm_ring_problems(tag, cfg, card["launches"], card["batches"],
                                       card["hops"], card["bytes"], lengths, card["prefills"],
                                       card["decodes"], 4, torch.float32)
        del params
        torch.cuda.empty_cache()
    emit({"phase": "slice_ssm_ring", "num_layers": 2, "dtype": "fp32", "sp_size": RING_N,
          "lengths": lengths, "arrivals": arrivals, "new_tokens": 8, **out})
    check(not problems, "; ".join(problems))


# serve_ssm_ring's trace: every length a multiple of 4 whose quarter is at
# most 64 or a multiple of 64 (the exact mode's rule at sp_size 4)
SSM_RING_LENGTHS = [48, 64, 128, 256, 512, 768, 1024, 1536]
SSM_RING_ARRIVALS = [0, 0, 1, 2, 3, 5, 8, 13]
# serve_ssm_ring's greedy tokens a request: 32 before, cut to 16 for the
# run's time (its decode ticks took ~33 s of a 98 s phase on a slow host)
SSM_RING_NEW_TOKENS = 16
# the sharded scan's parts around #5, each under a profiler range in the
# profiled prefill: the halo hops, the state gather and prefix, the
# correction (#5 itself is a C call the profiler does not tie to a range:
# its device time is its kernel class's)
SSM_RANGES = {"_halo": "halo", "_incoming_states": "state_gather_prefix",
              "_apply_initial_state": "correction"}


def _ranged_device_ms(module, names, run):
    """Run ``run`` under torch.profiler with each function ``names`` of
    ``module`` under a profiler range -> (the profile, device ms per range
    name: the kernels launched below each range's calls)."""
    from torch.profiler import ProfilerActivity, profile

    origs = {name: getattr(module, name) for name in names}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(names[name]):
                return fn(*args, **kwargs)
        return call

    for name, fn in origs.items():
        setattr(module, name, ranged(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for name, fn in origs.items():
            setattr(module, name, fn)
    split = {label: 0.0 for label in names.values()}

    def walk(ev, label):
        for k in getattr(ev, "kernels", None) or ():
            split[label] += k.duration / 1e3
        for child in ev.cpu_children:
            walk(child, label)

    for ev in prof.events():
        if ev.name in split and ev.device_type == torch.autograd.DeviceType.CPU:
            walk(ev, ev.name)
    return prof, split


def profile_ssm_prefill(eng, cfg, length=1536):
    """One prefill of a ``length``-token prompt into the drained engine under
    torch.profiler: device ms of #5 beside the halo, the state gather and
    prefix, and the correction (their ranges; 0 at sp_size 1), and of the
    whole step by kernel class (copies apart) and by kernel."""
    rng = np.random.default_rng(8)
    eng.submit(rng.integers(0, cfg.vocab_size, (length,), dtype=np.int32), 1,
               arrival_tick=eng.tick_stats()["ticks"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof, split = _ranged_device_ms(ssm_mod, SSM_RANGES, eng.step)
    wall_ms = (time.perf_counter() - t0) * 1e3

    def classify(name):  # a range's own device-side span is no kernel
        return "range" if name in split else _ring_kernel_class(name)

    by_class, by_kernel = device_time(prof, classify=classify)
    by_class.pop("range", None)
    by_kernel = {k: ms for k, ms in by_kernel.items() if k not in split}
    split["scan"] = by_class.get("ssd_scan_fwd", 0.0)
    eng.run()
    return {"prompt": length, "wall_ms_profiled": wall_ms, "device_ms_by_part": split,
            "device_ms_by_class": by_class,
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10])}


def serve_ssm_ring(card):
    """This slice's main path: mamba2-370m and hymba-1.5b at full width and
    depth, bf16, 8 slots, max_seq 2048, SSM_RING_NEW_TOKENS greedy tokens,
    over a ring of 4
    (the sharded scan; hymba's attention through the Mesh-Attention forward
    and the folded decode), then the same trace at sp_size 1 in the same
    call."""
    runs, problems, counted = {}, [], {"ssd_scan_fwd": 0, "fwd_tile": 0, "fwd_decode": 0,
                                        "paged_decode_combine": 0}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        L = cfg.num_layers
        params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        runs[arch] = {}
        streams = {}
        for sp in (RING_N, 1):
            ctx = ParallelCtx(sp_size=sp, device="cuda")
            serve = ServeConfig(max_seq=2048, num_slots=8, cache_dtype=torch.bfloat16)
            # warm-up (cuBLAS handles, allocator), outside the measured run
            warm = ServeEngine(cfg, params, ctx, serve=serve)
            warm.generate(np.arange(64, dtype=np.int32)[None], max_new_tokens=2)
            del warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng, res, launches, batches, hops, nbytes = _ssm_ring_run(
                cfg, params, ctx, serve, SSM_RING_LENGTHS, SSM_RING_ARRIVALS,
                SSM_RING_NEW_TOKENS, seed=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = eng.tick_stats()
            pf_tok, pf_s = sum(stats["prefill_tokens"]), sum(stats["prefill_s"])
            dec_ticks = [i for i in range(stats["ticks"]) if stats["decode_s"][i] > 0]
            dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
            dec_tok = sum(stats["decode_tokens"]) - len(res)
            streams[sp] = ([r.generated for r in res],
                           [eng.debug_logits[r.rid] for r in res])
            rec = {
                "sp_size": sp, "statuses": [r.status for r in res], "ticks": stats["ticks"],
                "wall_s": wall, "prefill_tokens": pf_tok, "prefill_s": pf_s,
                "prefill_tok_per_s": pf_tok / pf_s, "decode_tokens": dec_tok,
                "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
                "decode_ticks": len(dec_ticks),
                "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
                "ttft_ticks": [r.ttft_ticks for r in res],
                "ssm_state_bytes": _ssm_state_bytes(eng),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "prefill_launches": eng.prefill_launches, "decode_launches": eng.decode_launches,
                "launches": {k: launches[k] for k in (
                    "ssd_scan_fwd", "flash_attention_fwd", "fwd_tile", "fwd_decode", "fwd_fp32",
                    "paged_decode_combine", "paged_flash_decode")},
                "scan_batches": sorted(set(batches)), "hops": hops, "bytes": nbytes,
                "bytes_per_prefill": {k: v / len(res) for k, v in nbytes.items()},
            }
            tag = f"serve_ssm_ring {arch} sp_size {sp}"
            if not all(r.status == "ok" and len(r.generated) == SSM_RING_NEW_TOKENS
                       for r in res):
                problems.append(f"{tag}: not every request finished ok: {rec['statuses']}")
            if sp > 1:
                problems += _ssm_ring_problems(
                    tag, cfg, launches, batches, hops, nbytes, SSM_RING_LENGTHS,
                    eng.prefill_launches, eng.decode_launches, 2, torch.bfloat16)
                for k in counted:
                    counted[k] += launches[k]
                rec["decode_profile"] = profile_decode(eng, cfg, classify=_ring_kernel_class)
            elif launches["ssd_scan_fwd"] != L * len(SSM_RING_LENGTHS) or set(batches) != {1}:
                problems.append(f"{tag}: #5 launches {launches['ssd_scan_fwd']} at batches "
                                f"{set(batches)}")
            rec["prefill_profile"] = profile_ssm_prefill(eng, cfg)
            runs[arch][f"sp{sp}"] = rec
            del eng, ctx
            torch.cuda.empty_cache()
        # the ring's bf16 stream against one rank's: a flip only on a near-tie
        flips = []
        for i, (a, b) in enumerate(zip(streams[RING_N][0], streams[1][0])):
            if a != b:
                j = _first_flip(a, b)
                row = streams[RING_N][1][i][j]
                top2 = np.sort(row)[-2:]
                flips.append(dict(request=i, token=j, ring=a[j], one_rank=b[j],
                                  top2_gap=float(top2[1] - top2[0]),
                                  ring_gap_to_one_rank=float(row[a[j]] - row[b[j]])))
        runs[arch]["streams_equal"] = streams[RING_N][0] == streams[1][0]
        runs[arch]["flips"] = flips
        for f in flips:
            if f["ring_gap_to_one_rank"] > RING_NEAR_TIE:
                problems.append(f"serve_ssm_ring {arch}: a flip beyond a near-tie: {f}")
        r4, r1 = runs[arch][f"sp{RING_N}"], runs[arch]["sp1"]
        runs[arch]["tick_ratio_sp4_to_sp1"] = r4["ms_per_decode_tick"] / r1["ms_per_decode_tick"]
        runs[arch]["prefill_rate_ratio_sp4_to_sp1"] = (r4["prefill_tok_per_s"]
                                                       / r1["prefill_tok_per_s"])
        runs[arch].update(arch=arch, num_layers=L, d_model=cfg.d_model,
                          ssm=dataclasses.asdict(cfg.ssm), params=tfm.param_count(params))
        del params
        torch.cuda.empty_cache()
    emit({"phase": "serve_ssm_ring", "dtype": "bf16", "max_seq": 2048, "num_slots": 8,
          "lengths": SSM_RING_LENGTHS, "arrival_ticks": SSM_RING_ARRIVALS, "new_tokens": 32,
          "near_tie": RING_NEAR_TIE, "runs": runs, "card": card})
    check(not problems, "; ".join(problems))
    return counted


def _kernel_class(name: str) -> str:
    if "flash_fwd_" in name:  # the fp32, tile, decode and combine kernels
        return "flash_attention_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if "flash_bwd_split_kernel" in name:  # the fp32 body's pre-pass
        return "flash_bwd_split"
    if "paged_decode_" in name:  # the main kernels and the split combine
        return "paged_flash_decode"
    if "ssd_bwd_" in name:  # #5b: the state, chunk and reduce kernels
        return "ssd_scan_bwd"
    if "ssd_scan_" in name:  # the chunk (scores and states), pass and y kernels
        return "ssd_scan_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def _profiled_ticks(eng, cfg, ticks, host_ops=True):
    """A few decode ticks of 8 slots at depth ~128 under torch.profiler ->
    (profile, host wall ms of those ticks).  Runs after the measured trace
    (its launches are not counted) and drains the engine again.
    ``host_ops=False`` records the card's activity alone: what
    ``_tick_summary`` reads, without the host ops' events, whose parse
    takes seconds at full depth."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    now = eng.tick_stats()["ticks"]
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, (128,), dtype=np.int32), ticks + 2,
                   arrival_tick=now)
    eng.step()  # admission + prefill + the first decode, outside the window
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    return prof, wall_ms


def _tick_summary(prof, wall_ms, ticks, classify=None):
    """Device ms per tick by kernel class (``classify``, default
    ``_kernel_class``; the class "range", a profiler range's own span, is
    left out), the top kernels and the idle share of the host wall clock."""
    classify = classify or _kernel_class
    device_ms, by_kernel = device_time(prof, per=ticks, classify=classify)
    device_ms.pop("range", None)
    by_kernel = {k: ms for k, ms in by_kernel.items() if classify(k) != "range"}
    busy = sum(device_ms.values())
    per_tick_wall = wall_ms / ticks
    return {
        "ticks": ticks, "slots": 8, "depth": 128, "wall_ms_per_tick": per_tick_wall,
        "device_ms_per_tick": device_ms or None,
        "top_kernels_ms_per_tick": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]),
        # the profiler's own host cost inflates this window's wall clock
        "device_idle_share": (1 - busy / per_tick_wall) if device_ms else None,
    }


def profile_decode(eng, cfg, ticks=4, classify=None):
    """Where a decode tick's time goes (``_profiled_ticks`` over the card's
    activity alone, ``_tick_summary``).  The host ops' events are left out
    for the run's time: ``_tick_summary`` reads none of them, and their
    parse takes seconds a tick at full depth.  ``profile_s``: what the
    profile cost the run, ticks and parse."""
    t0 = time.perf_counter()
    prof, wall_ms = _profiled_ticks(eng, cfg, ticks, host_ops=False)
    rec = _tick_summary(prof, wall_ms, ticks, classify)
    rec["profile_s"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------
# phases 4i and 4j: the MoE decoders
# --------------------------------------------------------------------------

MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
# mixtral-8x7b at full width is 46.7e9 parameters, 93 GB in bf16: serve_moe
# keeps 8 of its 32 layers (~24 GB); qwen2-moe-a2.7b (14.3e9, 28.6 GB) whole
MIXTRAL_SERVE_LAYERS = 8
# the dropless check (serve_moe) runs at capacity factor E / K, so C >= S
# on every row and nothing can drop.  JAX's tests pin 8.0, which is E / K x 2
# for mixtral but half of qwen2-moe's 15: at 8.0 (C = ceil(0.53 S)) the
# random weights route more tokens than that to one expert, and a 24-layer
# forward over two prompts dropped 3,355 entries (first chip run).  It holds
# the engine's first-token and teacher-forced decode logits against the
# no-cache forward, both on the card, fp32.
# The two sum fp32 products in other orders (#4 over the pool, #1 over the
# whole row), ~1e-5 apart; a router computed in bf16 flips near-tie expert
# choices and a missing shared expert moves every token, both by far more
# than the limit (measured in the same run and gated).  bf16 cannot hold
# this line: the paths' bf16 roundings of h flip near-tie experts just as a
# bf16 router would.
DROPLESS_TOL = 1e-3


class _DropCounter:
    """Counts the (token, k) entries that capacity drops, by wrapping the
    MoE layer's dispatch (a host read-back per call: correctness runs only)."""

    def __init__(self):
        self.dropped = 0

    def __enter__(self):
        self._orig = moe_mod._dispatch_indices

        def counting(idx, E, C):
            slot, valid = self._orig(idx, E, C)
            self.dropped += int((~valid).sum())
            return slot, valid

        moe_mod._dispatch_indices = counting
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_indices = self._orig


# slice_moe's depth: 2 layers before, cut to 1 for the run's time (48-50
# s on slow hosts, most of it the CPU side's experts)
MOE_SLICE_LAYERS = 1


def cross_device_moe():
    """qwen2-moe-a2.7b and mixtral-8x7b at full width, MOE_SLICE_LAYERS
    layers, fp32, JAX's default capacity factor 1.25: card (kernels) vs CPU
    (plain versions) over the dense cache; capacity must drop entries on
    both.  The paged pool's run was cut for the run's time:
    slice_moe_ring holds the same weights card vs CPU over the fp and int8
    pools, at sp_size 4.  -> each arch's (cfg, card weights, CPU weights),
    which slice_moe_ring serves again over the ring."""
    lengths, arrivals = [64, 137, 200], [0, 0, 1]
    out, problems, weights = {}, [], {}
    serve = ServeConfig(max_seq=256, num_slots=4, cache_dtype=torch.float32)
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=MOE_SLICE_LAYERS)
        params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        params_cpu = _tree_to(params, "cpu")
        weights[arch] = (cfg, params, params_cpu)
        side = {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            fa.flash_attention_fwd.launches = pk.paged_flash_decode.launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            with _DropCounter() as drops:
                res = serve_trace(eng, lengths, arrivals, 8, cfg.vocab_size, seed=1)
            side[dev] = dict(
                streams=[r.generated for r in res],
                first=[eng.debug_logits[r.rid][0] for r in res],
                launches={"flash_attention_fwd": fa.flash_attention_fwd.launches,
                          "paged_flash_decode": pk.paged_flash_decode.launches},
                statuses=[r.status for r in res], dropped=drops.dropped,
            )
        card, cpu = side["cuda"], side["cpu"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card["first"], cpu["first"]))
        out[arch] = {"dense": dict(
            streams_identical=card["streams"] == cpu["streams"],
            first_logits_max_abs_err=err, cuda_launches=card["launches"],
            cpu_launches=sum(cpu["launches"].values()),
            dropped_entries={"cuda": card["dropped"], "cpu": cpu["dropped"]},
        )}
        tag = f"slice_moe {arch} dense"
        if card["streams"] != cpu["streams"]:
            problems.append(f"{tag}: card and CPU streams differ: {side}")
        if err > 1e-3:
            problems.append(f"{tag}: first-token logits differ by {err} > 1e-3")
        if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
            problems.append(f"{tag}: not every request finished ok")
        if not (card["launches"]["flash_attention_fwd"] > 0
                and card["launches"]["paged_flash_decode"] == 0
                and out[arch]["dense"]["cpu_launches"] == 0):
            problems.append(f"{tag}: kernels must run on the card only: "
                            f"{card['launches']}, CPU {out[arch]['dense']['cpu_launches']}")
        if not (card["dropped"] > 0 and cpu["dropped"] > 0):
            problems.append(f"{tag}: capacity dropped nothing: {out[arch]['dense']}")
        del params, params_cpu
    emit({"phase": "slice_moe", "num_layers": MOE_SLICE_LAYERS, "dtype": "fp32",
          "capacity_factor": 1.25, "lengths": lengths, "arrivals": arrivals, "new_tokens": 8,
          **out})
    check(not problems, "; ".join(problems))
    return weights


def _moe_kernel_class(name: str) -> str:
    if name == "moe_block":  # the profiler range's own device-side span
        return "range"
    cls = _kernel_class(name)
    return "attention" if cls in ("flash_attention_fwd", "paged_flash_decode") else cls


def profile_moe_decode(eng, cfg, ticks=4):
    """profile_decode's window with each MoE block under a profiler range,
    and the device ms per tick of the block's kernels: the expert products
    (under ``aten::bmm``: the capacity-dense einsums), the router and
    shared-expert products (its other matmul kernels) and the dispatch /
    combine (every other kernel of the block: sort, ranks, scatter, gather,
    weights)."""
    orig = moe_mod.moe_block

    def ranged(*args, **kwargs):
        with torch.profiler.record_function("moe_block"):
            return orig(*args, **kwargs)

    moe_mod.moe_block = ranged
    try:
        prof, wall_ms = _profiled_ticks(eng, cfg, ticks)
    finally:
        moe_mod.moe_block = orig
    split = {"expert_products": 0.0, "router_and_shared_products": 0.0,
             "dispatch_combine": 0.0}

    def walk(ev, in_bmm):
        in_bmm = in_bmm or ev.name == "aten::bmm"
        for k in getattr(ev, "kernels", None) or ():
            part = ("expert_products" if in_bmm else "router_and_shared_products"
                    if _kernel_class(k.name) == "matmul" else "dispatch_combine")
            split[part] += k.duration / 1e3 / ticks
        for child in ev.cpu_children:
            walk(child, in_bmm)

    for ev in prof.events():
        if ev.name == "moe_block" and ev.device_type == torch.autograd.DeviceType.CPU:
            walk(ev, False)
    rec = _tick_summary(prof, wall_ms, ticks, _moe_kernel_class)
    # kernels the profiler tied to the MoE blocks (None: none were tied)
    rec["moe_block_ms_per_tick"] = split if sum(split.values()) > 0 else None
    return rec


def _serve_full_run(cfg, params, serve, lengths, arrivals, profile, phase="serve_moe"):
    """One measured serving run at full width (after a warm-up outside it):
    rates, memory, launches per kernel and per engine launch, and
    ``profile(eng, cfg)`` (a profiled tick) unless it is None."""
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=serve)
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skip = eng.tick_stats()["ticks"]
    engine0 = (eng.prefill_launches, eng.decode_launches, eng.chunk_launches,
               eng.verify_launches)
    fa.flash_attention_fwd.launches = fa.fwd_split_terms.launches = 0
    pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
    bodies0 = fwd_body_counts()
    t0 = time.perf_counter()
    res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "fwd_split": fa.fwd_split_terms.launches,
                "paged_flash_decode": pk.paged_flash_decode.launches,
                "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches}
    bodies = fwd_body_delta(bodies0)
    engine = dict(zip(("prefill", "decode", "chunk", "verify"),
                      (b - a for a, b in zip(engine0, (
                          eng.prefill_launches, eng.decode_launches, eng.chunk_launches,
                          eng.verify_launches)))))
    stats = eng.tick_stats()
    kv = eng.kv_cache_stats()
    pf_tok = sum(stats["prefill_tokens"][skip:])
    pf_s = sum(stats["prefill_s"][skip:])
    dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
    dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
    dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
    rec = {
        "arch": cfg.name, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
        "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
        "params": tfm.param_count(params),
        "kv_dtype": serve.kv_dtype, "prefill_chunk": serve.prefill_chunk,
        "spec_k": serve.spec_k, "statuses": [r.status for r in res],
        "ticks": stats["ticks"] - skip, "wall_s": wall,
        "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
        "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
        "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
        "ttft_ticks": [r.ttft_ticks for r in res],
        "pool_bytes": kv["cache_bytes"] + kv["scale_table_bytes"],
        "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "engine_launches": engine, "launches": launches, "flash_attention_fwd_bodies": bodies,
    }
    problems = []
    tag = f"{phase} {cfg.name} {serve.kv_dtype}" + (" chunked" if serve.prefill_chunk else "")
    L = cfg.num_layers
    if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
        problems.append(f"{tag}: not every request finished ok: {rec['statuses']}")
    if kv["pages_in_use"]:
        problems.append(f"{tag}: {kv['pages_in_use']} pages in use after the drain")
    # one decode kernel launch per layer and decode tick; #1 once per layer
    # and prefill, chunk or verify launch
    quant = serve.kv_dtype != "fp"
    used, unused = (("paged_flash_decode_quant", "paged_flash_decode") if quant
                    else ("paged_flash_decode", "paged_flash_decode_quant"))
    if not (launches[used] == L * engine["decode"] > 0 and launches[unused] == 0):
        problems.append(f"{tag}: decode launches {launches}, want {used} = {L} x "
                        f"{engine['decode']}")
    want_flash = L * (engine["prefill"] + engine["chunk"] + engine["verify"])
    if launches["flash_attention_fwd"] != want_flash or want_flash == 0:
        problems.append(f"{tag}: #1 launched {launches['flash_attention_fwd']} times, want "
                        f"{want_flash} ({L} x {engine})")
    # bf16 one-shot prefill on the tile body (its own fresh K/V); a
    # quantized pool's chunks and verifies on the fp32 bodies (its
    # dequantized view is fp32)
    over_pool = L * (engine["chunk"] + engine["verify"])
    want_bodies = ({"tile": want_flash - over_pool, "decode": 0, "fp32": over_pool} if quant
                   else {"tile": want_flash, "decode": 0, "fp32": 0})
    if bodies != want_bodies:
        problems.append(f"{tag}: flash bodies {bodies}, want {want_bodies}")
    if launches["fwd_split"] != bodies["fp32"]:
        problems.append(f"{tag}: the fp32 pre-pass not once per fp32 forward: {launches}")
    if profile is not None:
        rec["decode_profile"] = profile(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    return rec, problems, bodies


def _moe_dropless():
    """qwen2-moe-a2.7b whole, fp32, capacity factor E / K (no entry dropped,
    counted): two requests through the engine (one-shot, fp pool) against
    the no-cache forward over prompt + generated tokens, teacher-forced, on
    the card; and the same forward with the router computed in bf16 and
    without the shared expert, each of which the limit must catch."""
    base = get_config("qwen2-moe-a2.7b")
    cf = base.moe.num_experts / base.moe.top_k
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    ctx = ParallelCtx(device="cuda")
    eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(
        max_seq=256, num_slots=2, paged=True, page_size=16, cache_dtype=torch.float32))
    eng.capture_logits = True
    lengths, new_tokens = [96, 137], 8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n in lengths]
    with _DropCounter() as drops:
        rids = [eng.submit(p, new_tokens) for p in prompts]
        done = eng.run()
    engine_logits = [np.stack(eng.debug_logits[r]) for r in rids]
    del eng
    torch.cuda.empty_cache()

    def no_cache(run_cfg):
        rows, dev = [], params["embed"].device
        for p, r in zip(prompts, rids):
            seq = np.concatenate([p, np.asarray(done[r].generated[:-1], np.int32)])
            batch = {"tokens": torch.from_numpy(seq)[None].to(dev),
                     "positions": torch.arange(len(seq), dtype=torch.int32, device=dev)}
            with torch.no_grad():
                logits = tfm.forward(params, run_cfg, ctx, batch)
            rows.append(logits[0, len(p) - 1:].float().cpu().numpy())
        return rows

    def err(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    with _DropCounter() as fwd_drops:
        ref = no_cache(cfg)
    orig = moe_mod._route

    def route_in_bf16(h, router_w, cfg_, E_pad):
        logits = (h.to(torch.bfloat16) @ router_w.to(torch.bfloat16)).float()
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[..., : cfg_.moe.top_k], idx[..., : cfg_.moe.top_k]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return idx, w.to(h.dtype), torch.zeros((), device=h.device)

    moe_mod._route = route_in_bf16
    try:
        bf16_router = no_cache(cfg)
    finally:
        moe_mod._route = orig
    no_shared = no_cache(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                        num_shared=0)))
    del params
    torch.cuda.empty_cache()
    rec = {
        "arch": cfg.name, "num_layers": cfg.num_layers, "dtype": "fp32",
        "capacity_factor": cf, "lengths": lengths, "new_tokens": new_tokens,
        "statuses": [done[r].status for r in rids],
        "dropped_entries": {"engine": drops.dropped, "forward": fwd_drops.dropped},
        "max_abs_err": err(engine_logits, ref), "limit": DROPLESS_TOL,
        "bf16_router_err": err(bf16_router, ref), "no_shared_expert_err": err(no_shared, ref),
        "logit_scale": max(float(np.abs(x).max()) for x in ref),
    }
    problems = []
    if not all(done[r].status == "ok" for r in rids) or any(
            len(x) != new_tokens for x in engine_logits):
        problems.append(f"dropless: engine run incomplete: {rec}")
    if drops.dropped or fwd_drops.dropped:
        problems.append(f"dropless: capacity {cf} dropped entries: {rec['dropped_entries']}")
    if not rec["max_abs_err"] <= DROPLESS_TOL:
        problems.append(f"dropless: engine vs no-cache forward {rec['max_abs_err']} > "
                        f"{DROPLESS_TOL}")
    if not (rec["bf16_router_err"] > DROPLESS_TOL and rec["no_shared_expert_err"] > DROPLESS_TOL):
        problems.append(f"dropless: the limit misses a fault: {rec}")
    return rec, problems


def serve_moe(card):
    """The MoE serving path at full width on the card, bf16, the serve
    trace (8 slots, max_seq 2048, page 16, 32 greedy tokens): qwen2-moe
    whole one-shot over the fp pool, then chunk 256 / budget 512 / spec_k 4
    over an int8 pool; mixtral-8x7b (8 of 32 layers) one-shot over the fp
    pool; then the dropless check."""
    runs, problems, counted = {}, [], {}
    qwen = get_config("qwen2-moe-a2.7b")
    t0 = time.perf_counter()
    params = tfm.init_params(qwen, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    base = dict(max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16)
    for key, extra in (("qwen_oneshot_fp", {}),
                       ("qwen_chunk_spec_int8", dict(prefill_chunk=256, tick_token_budget=512,
                                                     spec_k=4, kv_dtype="int8"))):
        # the profiled tick: plain decode of the one-shot run
        rec, probs, bodies = _serve_full_run(qwen, params, ServeConfig(**base, **extra),
                                             SERVE_LENGTHS, SERVE_ARRIVALS,
                                             profile=None if extra else profile_moe_decode)
        rec["init_s"] = init_s
        runs[key], counted[key] = rec, (rec["launches"], bodies)
        problems += probs
    del params
    torch.cuda.empty_cache()
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=MIXTRAL_SERVE_LAYERS)
    params = tfm.init_params(mixtral, seed=0, dtype=torch.bfloat16, device="cuda")
    # its profiled tick was cut for the run's time (no gate read it)
    rec, probs, bodies = _serve_full_run(mixtral, params, ServeConfig(**base), SERVE_LENGTHS,
                                         SERVE_ARRIVALS, profile=None)
    runs["mixtral_8_layers_oneshot_fp"], counted["mixtral"] = rec, (rec["launches"], bodies)
    problems += probs
    del params
    torch.cuda.empty_cache()
    dropless, probs = _moe_dropless()
    problems += probs
    emit({"phase": "serve_moe", "dtype": "bf16", "max_seq": 2048, "num_slots": 8,
          "page_size": 16, "lengths": SERVE_LENGTHS, "arrival_ticks": SERVE_ARRIVALS,
          "new_tokens": 32, "runs": runs, "dropless": dropless, "card": card})
    check(not problems, "; ".join(problems))
    # the main runs' launches, for the kernels line
    total = {"flash_attention_fwd (tile)": 0, "flash_attention_fwd (fp32)": 0,
             "flash_fwd_split": 0, "paged_flash_decode": 0, "paged_flash_decode_quant": 0}
    for launches, bodies in counted.values():
        total["flash_attention_fwd (tile)"] += bodies["tile"]
        total["flash_attention_fwd (fp32)"] += bodies["fp32"]
        total["flash_fwd_split"] += launches["fwd_split"]
        total["paged_flash_decode"] += launches["paged_flash_decode"]
        total["paged_flash_decode_quant"] += launches["paged_flash_decode_quant"]
    return total, runs["qwen_oneshot_fp"]


# --------------------------------------------------------------------------
# the MoE decoders over a ring of 4: expert parallelism
# --------------------------------------------------------------------------

# slice_moe_ring's runs: one-shot over the fp pool, and chunk 256 (budget
# 512) with spec_k 4 over an int8 pool; its first prompt loops, so prompt
# lookup drafts and verify windows run
MOE_RING_RUNS = (("oneshot_fp", {}),
                 ("chunk_spec_int8", dict(prefill_chunk=256, tick_token_budget=512, spec_k=4,
                                          kv_dtype="int8")))
# train_moe_ring_parity's sequence: 512 rows a rank
MOE_RING_PARITY_SEQ = 2048


def _moe_a2a_bytes(cfg, shapes, itemsize, n=RING_N):
    """The reckoning of the moe_dispatch (and, equal, moe_return) bytes one
    rank sends: for each MoE call on rows [B, S] with S a multiple of n
    (an "ep" arch), its [B, E, C_loc, D] buffer at C_loc = ceil(S/n K cf /
    E), (n - 1) / n of it; decode rows (S 1) send nothing."""
    m = cfg.moe
    if m.mode != "ep":
        return 0
    E = -(-m.num_experts // n) * n
    total = 0
    for b, length in shapes:
        if length % n == 0:
            c = int(np.ceil(length // n * m.top_k * m.capacity_factor / E))
            total += b * E * c * cfg.d_model * itemsize * (n - 1) // n
    return total


# a router choice may differ between the card and the CPU only where the
# K-th and (K+1)-th router probabilities of the token lie this close: the
# two sides' hidden states differ by fp32 rounding (the card's #1 and #4
# take fp32 inputs as bf16 terms), which can move a near-tie expert in or
# out of a token's top-K and so change what capacity drops
ROUTE_NEAR_TIE = 1e-4


class _RouteRecorder:
    """Records every MoE routing while it is entered: each token's chosen
    experts (as a set: sorted) and the gap between its K-th and (K+1)-th
    router probability, on the host (correctness runs only)."""

    def __enter__(self):
        self.calls, self._orig = [], moe_mod._route

        def recording(h, router_w, cfg_, E_pad):
            idx, w, aux = self._orig(h, router_w, cfg_, E_pad)
            k, e = cfg_.moe.top_k, cfg_.moe.num_experts
            probs = torch.softmax(h.float() @ router_w.float()[:, :e], dim=-1)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.calls.append((idx.sort(dim=-1).values.cpu(),
                               (top[..., k - 1] - top[..., k]).cpu()))
            return idx, w, aux

        moe_mod._route = recording
        return self

    def __exit__(self, *exc):
        moe_mod._route = self._orig


def _route_flips(card_calls, cpu_calls):
    """Tokens whose expert sets differ between two runs of one schedule, and
    the largest router gap (either side's) among them."""
    if len(card_calls) != len(cpu_calls):
        return None, None
    flips, worst = 0, 0.0
    for (a, ga), (b, gb) in zip(card_calls, cpu_calls):
        diff = (a != b).any(dim=-1)
        if diff.any():
            flips += int(diff.sum())
            worst = max(worst, float(torch.maximum(ga, gb)[diff].max()))
    return flips, worst


class _AlwaysDraft:
    """While entered, the engine's prompt-lookup proposer always drafts (the
    fed token repeated), so verify windows run whatever a random model
    generates: a random 1-layer qwen2-moe and mixtral repeated no token in
    24 greedy tokens on an H100, and drafted nothing.  Verify
    commits only what greedy decode gives, so the streams stay greedy."""

    def __enter__(self):
        self._orig = serve_engine.propose_ngram

        def always(prompt, generated, k, **kwargs):
            return self._orig(prompt, generated, k, **kwargs) or [int(generated[-1])] * k

        serve_engine.propose_ngram = always
        return self

    def __exit__(self, *exc):
        serve_engine.propose_ngram = self._orig


def slice_moe_ring(weights):
    """slice_moe's weights (qwen2-moe-a2.7b and mixtral-8x7b at full width,
    MOE_SLICE_LAYERS layer, fp32, cf 1.25) served at sp_size 4 on the card
    and on the CPU: one-shot over the fp pool, chunk 256 + spec_k 4 over an
    int8 pool (the proposer always drafting: ``_AlwaysDraft``).  Streams
    identical, the entries capacity drops counted on both sides and equal
    (> 0 for qwen2-moe, whose "ep" dispatch caps each rank's quarter of a
    row), the all-to-all bytes equal, no kernel on the CPU side.  Expert
    choices may differ only at router near-ties (``ROUTE_NEAR_TIE``), and
    only then may the drop counts."""
    lengths, arrivals = [96, 137, 200], [0, 0, 1]
    out, problems = {}, []
    for arch in MOE_ARCHS:
        cfg, params, params_cpu = weights.pop(arch)
        loop = _slice_quant_trace(cfg.vocab_size)[0][0]  # 96 tokens, a loop of 12
        rng = np.random.default_rng(1)
        prompts = [loop] + [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
                            for n in lengths[1:]]
        out[arch] = {}
        for key, extra in MOE_RING_RUNS:
            serve = ServeConfig(max_seq=512, num_slots=4, paged=True, page_size=16,
                                cache_dtype=torch.float32, **extra)
            side = {}
            for dev, p in (("cuda", params), ("cpu", params_cpu)):
                ctx = ParallelCtx(sp_size=RING_N, device=dev)
                eng = ServeEngine(cfg, p, ctx, serve=serve)
                before = _kernel_counts()
                with _DropCounter() as drops, _RouteRecorder() as routes, _AlwaysDraft():
                    rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
                    done = eng.run()
                side[dev] = dict(
                    routes=routes.calls, streams=[done[r].generated for r in rids],
                    statuses=[done[r].status for r in rids], dropped=drops.dropped,
                    launches=_delta(before, _kernel_counts()),
                    ring_bytes={k: v for k, v in ctx.ring.stats.bytes.items()
                                if k.startswith("moe_")},
                    engine={"prefill": eng.prefill_launches, "chunk": eng.chunk_launches,
                            "verify": eng.verify_launches, "decode": eng.decode_launches,
                            "spec_accepted": eng.spec_accepted},
                    pages_in_use=eng.kv_cache_stats()["pages_in_use"])
                del eng
            card, cpu = side.pop("cuda"), side.pop("cpu")
            flips, worst_gap = _route_flips(card.pop("routes"), cpu.pop("routes"))
            cpu_launches = sum(v for k, v in cpu["launches"].items() if not k.startswith("fwd_"))
            out[arch][key] = dict(
                streams_identical=card["streams"] == cpu["streams"],
                route_flips=flips, route_flip_max_gap=worst_gap,
                dropped_entries={"cuda": card["dropped"], "cpu": cpu["dropped"]},
                ring_bytes={"cuda": card["ring_bytes"], "cpu": cpu["ring_bytes"]},
                engine=card["engine"], cuda_launches=card["launches"], cpu_launches=cpu_launches)
            tag = f"slice_moe_ring {arch} {key}"
            if card["streams"] != cpu["streams"]:
                problems.append(f"{tag}: card and CPU streams differ: {card}, {cpu}")
            if flips is None or (flips and not worst_gap <= ROUTE_NEAR_TIE):
                problems.append(f"{tag}: expert choices differ beyond a near-tie: {flips} "
                                f"tokens, gap {worst_gap}")
            if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
                problems.append(f"{tag}: not every request finished ok")
            if (card["dropped"] != cpu["dropped"] and not flips) or (
                    cfg.moe.mode == "ep" and not (card["dropped"] > 0 and cpu["dropped"] > 0)):
                problems.append(f"{tag}: drops {out[arch][key]['dropped_entries']}, want equal "
                                f"and > 0 for an ep arch")
            if card["ring_bytes"] != cpu["ring_bytes"] or (cfg.moe.mode == "ep") != bool(
                    card["ring_bytes"].get("moe_dispatch")):
                problems.append(f"{tag}: all-to-all bytes {out[arch][key]['ring_bytes']}")
            decode_kernel = "paged_flash_decode_quant" if extra else "paged_flash_decode"
            if not (card["launches"][decode_kernel] == cfg.num_layers * card["engine"]["decode"]
                    > 0 and card["launches"]["flash_attention_fwd"] > 0 and cpu_launches == 0):
                problems.append(f"{tag}: kernels must run on the card only: {card['launches']}, "
                                f"CPU {cpu_launches}")
            if extra and not (card["engine"]["chunk"] > 0 and card["engine"]["verify"] > 0):
                problems.append(f"{tag}: no chunk or no verify launch: {card['engine']}")
            if card["pages_in_use"] or cpu["pages_in_use"]:
                problems.append(f"{tag}: pages left after the drain")
        del params, params_cpu
        torch.cuda.empty_cache()
    emit({"phase": "slice_moe_ring", "num_layers": MOE_SLICE_LAYERS, "dtype": "fp32",
          "capacity_factor": 1.25, "sp_size": RING_N, "lengths": lengths, "arrivals": arrivals,
          "new_tokens": 8, "page_size": 16, "route_near_tie": ROUTE_NEAR_TIE,
          "runs": [k for k, _ in MOE_RING_RUNS], **out})
    check(not problems, "; ".join(problems))


def serve_moe_ring(card, sp1_rec):
    """qwen2-moe-a2.7b whole, bf16, at sp_size 4 (the virtual ring: its "ep"
    experts 15 a rank, each prefill's rows dispatched by all-to-all), the
    serve trace one-shot over the fp pool.  Gates: every request ok, pages
    drained, per layer one #4 launch a decode tick (the 4 ranks folded) and
    the mesh blocks' #1 launches a prefill (on the body ``_fwd_plan`` picks
    for a rank's quarter of the bucket), no call of a
    kernel's plain version, the moe_dispatch / moe_return bytes equal to the
    reckoning (decode rows send none), the peak under 80 GB.  Beside
    ``sp1_rec``, serve_moe's one-shot fp run of the same weights in this
    call: the ratio of ms a tick."""
    cfg = get_config("qwen2-moe-a2.7b")
    ctx = ParallelCtx(sp_size=RING_N, device="cuda")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda", ctx=ctx)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.num_layers
    eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(
        max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16))
    # warm-up (cuBLAS handles, allocator), outside the measured run
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skip = eng.tick_stats()["ticks"]
    counts0 = (eng.decode_launches, eng.chunk_launches, eng.verify_launches,
               eng.prefill_launches)
    ctx.ring.stats.reset()
    before = _kernel_counts()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        res = serve_trace(eng, SERVE_LENGTHS, [a + skip for a in SERVE_ARRIVALS], 32,
                          cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _delta(before, _kernel_counts())
    decode_l, chunk_l, verify_l, prefill_l = (
        a - b for a, b in zip((eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                               eng.prefill_launches), counts0))
    stats = eng.tick_stats()
    kv = eng.kv_cache_stats()
    pf_tok, pf_s = sum(stats["prefill_tokens"][skip:]), sum(stats["prefill_s"][skip:])
    dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
    dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
    dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
    buckets = [eng.scheduler.bucket_for(n) for n in SERVE_LENGTHS]
    want_a2a = L * _moe_a2a_bytes(cfg, [(1, b) for b in buckets], 2)
    ring_bytes = stats["ring_bytes"]
    rec = {
        "arch": cfg.name, "num_layers": L, "d_model": cfg.d_model,
        "moe": dataclasses.asdict(cfg.moe), "params": tfm.param_count(params), "init_s": init_s,
        "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip, "wall_s": wall,
        "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
        "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
        "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
        "sp1_ms_per_decode_tick": sp1_rec["ms_per_decode_tick"],
        "sp1_decode_tok_per_s": sp1_rec["decode_tok_per_s"],
        "sp1_prefill_tok_per_s": sp1_rec["prefill_tok_per_s"],
        "ttft_ticks": [r.ttft_ticks for r in res], "buckets": buckets,
        "prefill_launches": prefill_l, "decode_launches": decode_l,
        "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "plain_calls": plain.calls, "ring_bytes": ring_bytes,
        "moe_a2a_bytes_reckoned": want_a2a, "hops": dict(ctx.ring.stats.hops),
    }
    rec["tick_ratio_to_sp1"] = rec["ms_per_decode_tick"] / rec["sp1_ms_per_decode_tick"]
    rec["decode_profile"] = profile_moe_decode(eng, cfg)
    problems = []
    if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
        problems.append(f"serve_moe_ring: not every request finished ok: {rec['statuses']}")
    if kv["pages_in_use"]:
        problems.append(f"serve_moe_ring: {kv['pages_in_use']} pages left after the drain")
    blocks = sum(_mesh_prefill_launches(b) for b in buckets)
    problems += _ring_launch_problems("serve_moe_ring", L, launches, decode_l, chunk_l, verify_l,
                                      "paged_flash_decode", prefill=L * blocks)
    # a mesh block's rows are a rank's quarter of the bucket: 32 rows of MHA
    # (the 128 bucket) fit #1's decode body, the longer ones take the tile
    body = {b: fa._fwd_plan(1, b // RING_N, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                            torch.bfloat16)[0] for b in set(buckets)}
    got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
           "fwd_fp32": launches["fwd_fp32"], "prefill_launches": prefill_l,
           "paged_flash_decode_quant": launches["paged_flash_decode_quant"]}
    want = {f"fwd_{k}": L * sum(_mesh_prefill_launches(b) for b in buckets if body[b] == k)
            for k in ("tile", "decode")}
    want.update(fwd_fp32=0, prefill_launches=len(res), paged_flash_decode_quant=0)
    if got != want:
        problems.append(f"serve_moe_ring: launches by body {got}, want {want}")
    if any(plain.calls.values()):
        problems.append(f"serve_moe_ring: a kernel's plain version was called: {plain.calls}")
    if not (ring_bytes.get("moe_dispatch") == ring_bytes.get("moe_return") == want_a2a > 0):
        problems.append(f"serve_moe_ring: all-to-all bytes {ring_bytes}, reckoned {want_a2a}")
    if rec["peak_mem_gb"] >= 80:
        problems.append(f"serve_moe_ring: peak {rec['peak_mem_gb']:.2f} GB")
    del eng, params
    torch.cuda.empty_cache()
    emit({"phase": "serve_moe_ring", "dtype": "bf16", "sp_size": RING_N, "max_seq": 2048,
          "num_slots": 8, "page_size": 16, "lengths": SERVE_LENGTHS,
          "arrival_ticks": SERVE_ARRIVALS, "new_tokens": 32, "run": rec, "card": card})
    check(not problems, "; ".join(problems))
    return {"flash_attention_fwd (tile)": launches["fwd_tile"],
            "flash_attention_fwd (decode)": launches["fwd_decode"],
            "paged_flash_decode": launches["paged_flash_decode"]}


def train_moe_ring_parity():
    """qwen2-moe-a2.7b at full width, 1 layer, fp32, seq 2048, at capacity
    factor E / K = 15, where neither side drops (C_loc = S/n, C = S), so
    sp_size 4 and 1 compute one function: train_mesh_parity's step at
    sp_size 4 (mesh a = 2) against sp_size 1 on the card, with its gates,
    and the all-to-all bytes against the reckoning (remat runs each layer's
    forward twice)."""
    base = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, num_layers=1, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.num_experts / base.moe.top_k))
    with _DropCounter() as drops:
        train_mesh_parity(cfg=cfg, seq=MOE_RING_PARITY_SEQ, impls=(("mesh", 2),),
                          phase="train_moe_ring_parity",
                          a2a_bytes=2 * _moe_a2a_bytes(cfg, [(1, MOE_RING_PARITY_SEQ)], 4))
    check(drops.dropped == 0, f"train_moe_ring_parity: capacity dropped {drops.dropped} entries")


# --------------------------------------------------------------------------
# phases 4m and 4n: qwen2.5-32b (QKV bias, GQA group 5 at head dim 128)
# --------------------------------------------------------------------------

QWEN_ARCH = "qwen2.5-32b"
# serve_qwen's pool: 512 pages of 16 (8,192 tokens) hold the serve trace's
# 5,314 tokens with room; at 64 layers x 8 kv heads x 128 x 2 (K, V) x 2 B
# a token that is 2.1 GB in bf16 (int8: half, plus the scales), beside the
# 65.5 GB of weights
QWEN_PAGES = 512


class _PlainCalls:
    """Counts calls of the kernels' plain versions (the flash forward's and
    backward's, the split pre-pass's, the paged decode's and its
    combine's, and the masked attention under them) while it is entered: on
    the card the wrappers must launch their kernels and never reach these."""

    NAMES = ((ref, "attention_ref"), (ref, "masked_attention"), (ref, "attention_bwd_ref"),
             (fa, "split_terms_ref"), (pk, "paged_decode_ref"), (pk, "combine_split_partials"))

    def __init__(self):
        self.calls = {name: 0 for _, name in self.NAMES}

    def __enter__(self):
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in self.NAMES]
        for mod, name, fn in self._orig:
            def counting(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                return _fn(*args, **kwargs)
            setattr(mod, name, counting)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


# _serve_whole's runs: (a) one-shot over the fp pool, (b) chunk 256, budget
# 512, spec_k 4 over an int8 pool
WHOLE_RUNS = (("oneshot_fp", {}),
              ("chunk_spec_int8", dict(prefill_chunk=256, tick_token_budget=512, spec_k=4,
                                       kv_dtype="int8")))


def _serve_whole(card, arch, num_pages, phase, runs=WHOLE_RUNS, lengths=SERVE_LENGTHS,
                 keep=None, profile=True):
    """``arch`` whole in bf16 on the card, ``lengths`` at the serve trace's
    arrival ticks, 8 slots, max_seq 2048, a pool of ``num_pages`` pages of
    16, each of ``runs`` (key, ServeConfig fields).  A profiled decode tick
    of the first run (unless ``profile`` is False), beside the bytes bound
    its weights alone set; no plain version of a kernel called in any run.
    Returns the launches counted on its runs, keyed as the kernels line's
    rows.  ``keep`` (a dict) receives the weights and the runs' records, for
    a later phase to reuse."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tfm.param_count(params)
    weight_bytes = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    base = dict(max_seq=2048, num_slots=8, paged=True, page_size=16, num_pages=num_pages,
                cache_dtype=torch.bfloat16)
    records, problems, counted = {}, [], {"flash_attention_fwd (tile)": 0,
                                          "flash_attention_fwd (fp32)": 0, "flash_fwd_split": 0,
                                          "paged_flash_decode": 0, "paged_flash_decode_quant": 0}
    for i, (key, extra) in enumerate(runs):
        with _PlainCalls() as plain:
            rec, probs, bodies = _serve_full_run(cfg, params, ServeConfig(**base, **extra),
                                                 lengths, SERVE_ARRIVALS,
                                                 profile=profile_decode if profile and not i
                                                 else None,
                                                 phase=phase)
        rec.update(init_s=init_s, weight_bytes=weight_bytes, plain_calls=plain.calls,
                   weights_bound_ms_per_tick=1e3 * weight_bytes / HBM_BYTES_PER_S)
        if rec["peak_mem_gb"] * 1e9 > torch.cuda.get_device_properties(0).total_memory:
            problems.append(f"{phase} {key}: peak {rec['peak_mem_gb']} GB above the card's")
        if any(plain.calls.values()):
            problems.append(f"{phase} {key}: a kernel's plain version ran: {plain.calls}")
        records[key] = rec
        problems += probs
        counted["flash_attention_fwd (tile)"] += bodies["tile"]
        counted["flash_attention_fwd (fp32)"] += bodies["fp32"]
        counted["flash_fwd_split"] += rec["launches"]["fwd_split"]
        for k in ("paged_flash_decode", "paged_flash_decode_quant"):
            counted[k] += rec["launches"][k]
    if keep is not None:
        keep.update(params=params, records=records)
    del params
    torch.cuda.empty_cache()
    emit({"phase": phase, "arch": arch, "num_layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.hd],
          "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params, "dtype": "bf16",
          "max_seq": 2048, "num_slots": 8, "page_size": 16, "num_pages": num_pages,
          "lengths": lengths, "arrival_ticks": SERVE_ARRIVALS, "new_tokens": 32,
          "runs": records, "card": card})
    check(not problems, "; ".join(problems))
    return counted


def serve_qwen(card):
    """qwen2.5-32b whole (64 layers, 32.8e9 parameters) in bf16 on the card
    (``_serve_whole``, a pool of QWEN_PAGES pages of 16)."""
    return _serve_whole(card, QWEN_ARCH, QWEN_PAGES, "serve_qwen")


# --------------------------------------------------------------------------
# phases 4o and 4p: gemma-7b (head dim 256, GeGLU, tied embeddings)
# --------------------------------------------------------------------------

GEMMA_ARCH = "gemma-7b"
# serve_gemma's pool: 512 pages of 16 (8,192 tokens) hold the serve trace's
# 5,314 tokens; at 28 layers x 16 kv heads x 256 x 2 (K, V) x 2 B a token
# that is 3.76 GB in bf16 (458,752 bytes a token), beside 17.1 GB of weights
GEMMA_PAGES = 512


def serve_gemma(card):
    """gemma-7b whole (28 layers, 8.54e9 parameters) in bf16 on the card
    (``_serve_whole``): every attention launch on a head-dim-256 body."""
    return _serve_whole(card, GEMMA_ARCH, GEMMA_PAGES, "serve_gemma")


# --------------------------------------------------------------------------
# phases 4u and 4v: minicpm3-4b (MLA)
# --------------------------------------------------------------------------

MINICPM_ARCH = "minicpm3-4b"
# serve_minicpm's pool: 512 pages of 16 (8,192 tokens) hold the serve trace's
# 5,314 tokens; at 62 layers x one latent head of 288 x 2 (K and V, the same
# latent written twice) x 2 B a token that is 0.58 GB in bf16 (71,424 bytes
# a token), beside 8.52 GB of weights
MINICPM_PAGES = 512


def serve_minicpm(card, keep=None):
    """minicpm3-4b whole (62 layers, 4.26e9 parameters) in bf16 on the card
    (``_serve_whole``): prefill on #1's tile body at head dim 96, decode
    ticks on #4 / 4q at head dim 288 with 40 query heads on the latent, the
    int8 pool's chunks and verifies on #1's fp32 tile body at 288; no plain
    version called.  ``keep``: as ``_serve_whole``'s.  No profiled tick, cut
    for the run's time: serve_minicpm_ring profiles the ring's, and PERF.md
    keeps an earlier sp_size 1 tick."""
    return _serve_whole(card, MINICPM_ARCH, MINICPM_PAGES, "serve_minicpm", keep=keep,
                        profile=False)


def _mla_wire_ratio(cfg):
    """(latent values, expanded K and V values) a token: kvr + rope and
    2 x H x qk (minicpm3-4b: 288 and 7,680)."""
    m = cfg.mla
    return (m.kv_lora_rank + m.qk_rope_head_dim,
            2 * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim))


def _mesh_prefill_kv_rows(bucket: int) -> int:
    """The rows one rank's KV hops carry in one layer of one-shot prefill
    over the ring: the segment-masked mesh schedule's (a = 2 at n = 4) KV
    hops x a rank's quarter of the bucket."""
    cfg = MeshAttentionConfig(transport=None, n=RING_N, a=2, mask=MaskSpec.segment())
    hops = sum(1 for c in cfg.schedules(bucket)[0].comm_ops() if c == S.RECV_KV)
    return hops * bucket // RING_N


class _PrefillRows:
    """Records the row length of every one-shot prefill call (``prefill``
    and the packed ``prefill_packed``) while it is entered: the buckets the
    mesh schedules run at, packed admissions included."""

    def __enter__(self):
        self.rows, self._orig = [], (tfm.prefill, tfm.prefill_packed)

        def wrap(fn):
            def recording(params, cfg, ctx, batch, cache, *args, **kwargs):
                self.rows.append(int(batch["tokens"].shape[1]))
                return fn(params, cfg, ctx, batch, cache, *args, **kwargs)
            return recording

        tfm.prefill, tfm.prefill_packed = (wrap(fn) for fn in self._orig)
        return self

    def __exit__(self, *exc):
        tfm.prefill, tfm.prefill_packed = self._orig


def slice_mla_ring(keep):
    """slice_minicpm's weights (minicpm3-4b at full width, its 2 layers,
    fp32) served on the card at sp_size 4 with the latent wire on, against
    slice_minicpm's own CPU runs at sp_size 1 (one function: the ring
    changes the order of sums, not what is summed), kept from that phase:
    one-shot over the fp pool, and chunk 256 + spec_k 4 over an int8 pool
    (its first prompt the looping one).  Gates: fp streams identical and
    first-token logits within 1e-3; int8 a flip only on a near-tie and
    first-token logits within SLICE_LOGIT_TOL["int8"], as slice_quant; per
    layer one #4 / 4q launch a decode tick (the 4 ranks folded) and one
    combine a decode, chunk or verify launch; #1 at head dim 96 for the
    one-shot prefills' mesh blocks (a segment-masked block launches per
    rank) and at 288 once per layer and chunk or verify, every one on the
    fp32 bodies; no plain version called; the KV hops carry the latent."""
    cfg, params = keep["cfg"], keep["params"]
    L = cfg.num_layers
    out, problems = {}, []
    for key in ("oneshot_fp", "chunk_spec_int8"):
        cpu = keep[key]
        serve = cpu["serve"]
        tol = SLICE_LOGIT_TOL[serve.kv_dtype]
        ctx = ParallelCtx(sp_size=RING_N, device="cuda", mla_latent_wire=True)
        eng = ServeEngine(cfg, params, ctx, serve=serve)
        eng.capture_logits = True
        before = _kernel_counts()
        with _PlainCalls() as plain, _PrefillRows() as rows:
            rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(cpu["prompts"],
                                                                     cpu["arrivals"])]
            done = eng.run()
        launches = _delta(before, _kernel_counts())
        card = dict(streams=[done[r].generated for r in rids],
                    logits=[eng.debug_logits[r] for r in rids])
        cpu_logits = cpu.get("logits") or [[x] for x in cpu["first_logits"]]
        err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu_logits))
        flips = (_near_tie_flips(card, dict(streams=cpu["streams"], logits=cpu_logits))
                 if serve.kv_dtype != "fp" else [])
        counters = {"prefill_launches": eng.prefill_launches,
                    "chunk_launches": eng.chunk_launches,
                    "verify_launches": eng.verify_launches,
                    "decode_launches": eng.decode_launches, "spec_accepted": eng.spec_accepted,
                    "pages_in_use": eng.kv_cache_stats()["pages_in_use"]}
        buckets = rows.rows
        rec = dict(streams_identical=card["streams"] == cpu["streams"], near_tie_flips=flips,
                   first_logits_max_abs_err=err, logit_tol=tol, cuda_launches=launches,
                   plain_calls=plain.calls, ring_bytes=dict(ctx.ring.stats.bytes),
                   buckets=buckets, **counters)
        out[key] = rec
        tag = f"slice_mla_ring {key}"
        if serve.kv_dtype == "fp" and card["streams"] != cpu["streams"]:
            problems.append(f"{tag}: card and CPU streams differ: {card['streams']} vs "
                            f"{cpu['streams']}")
        for f in flips:
            if max(f["card_gap"], f["cpu_gap"]) > 2 * tol:
                problems.append(f"{tag}: streams differ beyond a near-tie: {f}")
        if err > tol:
            problems.append(f"{tag}: first-token logits differ by {err} > {tol}")
        if not all(done[r].status == "ok" for r in rids) or counters["pages_in_use"]:
            problems.append(f"{tag}: a request not ok or pages left: {rec}")
        if any(plain.calls.values()):
            problems.append(f"{tag}: a kernel's plain version ran: {plain.calls}")
        chunked = serve.prefill_chunk is not None
        prefill = 0 if chunked else L * sum(_mesh_prefill_launches(b) for b in buckets)
        decode_kernel = "paged_flash_decode_quant" if serve.kv_dtype != "fp" else \
            "paged_flash_decode"
        problems += _ring_launch_problems(tag, L, launches, counters["decode_launches"],
                                          counters["chunk_launches"],
                                          counters["verify_launches"], decode_kernel,
                                          prefill=prefill)
        # one kind of #1 launch a run: the mesh blocks at head dim 96 (one-shot)
        # or the chunks and verifies at 288 over the latent; fp32 bodies only
        if not (launches["fwd_fp32"] == launches["flash_attention_fwd"] == launches["fwd_split"]
                > 0):
            problems.append(f"{tag}: #1 off the fp32 bodies: {launches}")
        if chunked:
            if not (counters["chunk_launches"] > 0 and counters["verify_launches"] > 0
                    and counters["prefill_launches"] == 0):
                problems.append(f"{tag}: no chunk or no verify launch: {counters}")
        elif not (counters["prefill_launches"] == len(buckets) > 0
                  and rec["ring_bytes"].get("recv_kv", 0) > 0):
            problems.append(f"{tag}: one-shot prefills over the ring: {counters}, "
                            f"{rec['ring_bytes']}")
        del eng, ctx
    del params
    keep.pop("params")
    torch.cuda.empty_cache()
    emit({"phase": "slice_mla_ring", "arch": MINICPM_ARCH, "num_layers": L, "dtype": "fp32",
          "sp_size": RING_N, "mla_latent_wire": True, "cpu_side": "slice_minicpm's, sp_size 1",
          "new_tokens": 8, **out})
    check(not problems, "; ".join(problems))


def serve_minicpm_ring(card, keep):
    """serve_minicpm's weights (minicpm3-4b whole, bf16) at sp_size 4, the
    serve trace one-shot over the fp pool, twice: over the expanded heads
    (JAX's default), then with the latent on the KV ring.  Gates: every
    request ok, pages drained, per layer one #4 launch a decode tick (the 4
    ranks folded) and the mesh blocks' #1 launches a prefill (on the body
    ``_fwd_plan`` picks for a rank's quarter of the bucket), no call of a
    kernel's plain version, the two runs' streams equal but for a near-tie
    (RING_NEAR_TIE on the wire run's logits), the KV hops' bytes those of
    the rows the schedules carry -- latent (288 values) plus segment id a
    row under the wire, 2 x 40 x 96 values plus segment id without -- so
    the wire moves 288 / 7,680 of the K / V bytes exactly, the Q hops' and
    O sends' bytes equal, the peak under 80 GB.  Beside serve_minicpm's
    one-shot fp run at sp_size 1 in this call: the ratio of ms a tick; a
    profiled decode tick after the wire run."""
    cfg = get_config(MINICPM_ARCH)
    params, sp1 = keep["params"], keep["records"]["oneshot_fp"]
    L = cfg.num_layers
    lat, kv = _mla_wire_ratio(cfg)
    runs, problems, total, streams = {}, [], {}, {}
    for name, wire in (("expanded", False), ("wire", True)):
        ctx = ParallelCtx(sp_size=RING_N, device="cuda", mla_latent_wire=wire)
        eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, num_pages=MINICPM_PAGES,
            cache_dtype=torch.bfloat16))
        # warm-up (cuBLAS handles, allocator), outside the measured run
        t0 = time.perf_counter()
        eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        skip = eng.tick_stats()["ticks"]
        counts0 = (eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                   eng.prefill_launches)
        ctx.ring.stats.reset()
        eng.capture_logits = True
        before = _kernel_counts()
        with _PlainCalls() as plain, _PrefillRows() as prefill_rows:
            t0 = time.perf_counter()
            res = serve_trace(eng, SERVE_LENGTHS, [a + skip for a in SERVE_ARRIVALS], 32,
                              cfg.vocab_size, seed=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _delta(before, _kernel_counts())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        decode_l, chunk_l, verify_l, prefill_l = (
            a - b for a, b in zip((eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                                   eng.prefill_launches), counts0))
        stats = eng.tick_stats()
        kvs = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"][skip:]), sum(stats["prefill_s"][skip:])
        dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
        buckets = prefill_rows.rows
        rows = L * sum(_mesh_prefill_kv_rows(b) for b in buckets)
        ring_bytes = stats["ring_bytes"]
        # a KV hop row: bf16 K and V (or the latent) and the int32 segment id
        want_kv = rows * (2 * (lat if wire else kv) + 4)
        streams[name] = dict(streams=[r.generated for r in res],
                             logits=[eng.debug_logits[r.rid] for r in res])
        rec = {
            "mla_latent_wire": wire, "statuses": [r.status for r in res],
            "ticks": stats["ticks"] - skip, "wall_s": wall, "warmup_s": warmup_s,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "sp1_ms_per_decode_tick": sp1["ms_per_decode_tick"],
            "sp1_decode_tok_per_s": sp1["decode_tok_per_s"],
            "sp1_prefill_tok_per_s": sp1["prefill_tok_per_s"],
            "ttft_ticks": [r.ttft_ticks for r in res], "buckets": buckets,
            "prefill_launches": prefill_l, "decode_launches": decode_l,
            "pages_in_use": kvs["pages_in_use"], "peak_pages": kvs["peak_in_use"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "plain_calls": plain.calls, "ring_bytes": ring_bytes,
            "kv_hop_rows_reckoned": rows, "recv_kv_bytes_reckoned": want_kv,
            "hops": dict(ctx.ring.stats.hops),
        }
        rec["tick_ratio_to_sp1"] = rec["ms_per_decode_tick"] / rec["sp1_ms_per_decode_tick"]
        if wire:
            # after the last measured run (the decode path is the expanded
            # run's); one tick, for the run's time
            rec["decode_profile"] = profile_decode(eng, cfg, ticks=1,
                                                   classify=_ring_kernel_class)
        runs[name] = rec
        tag = f"serve_minicpm_ring {name}"
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"{tag}: not every request finished ok: {rec['statuses']}")
        if kvs["pages_in_use"]:
            problems.append(f"{tag}: {kvs['pages_in_use']} pages left after the drain")
        problems += _ring_launch_problems(tag, L, launches, decode_l, chunk_l, verify_l,
                                          "paged_flash_decode",
                                          prefill=L * sum(_mesh_prefill_launches(b)
                                                          for b in buckets))
        # a mesh block's rows are a rank's quarter of the bucket, at head dim 96
        body = {b: fa._fwd_plan(1, b // RING_N, cfg.num_heads, cfg.num_heads, kv // (
            2 * cfg.num_heads), torch.bfloat16)[0] for b in set(buckets)}
        got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
               "fwd_fp32": launches["fwd_fp32"], "prefill_launches": prefill_l,
               "paged_flash_decode_quant": launches["paged_flash_decode_quant"]}
        want = {f"fwd_{k}": L * sum(_mesh_prefill_launches(b) for b in buckets if body[b] == k)
                for k in ("tile", "decode")}
        want.update(fwd_fp32=0, prefill_launches=len(buckets), paged_flash_decode_quant=0)
        if got != want:
            problems.append(f"{tag}: launches by body {got}, want {want}")
        if any(plain.calls.values()):
            problems.append(f"{tag}: a kernel's plain version was called: {plain.calls}")
        if ring_bytes.get("recv_kv") != want_kv:
            problems.append(f"{tag}: KV hop bytes {ring_bytes.get('recv_kv')}, reckoned "
                            f"{want_kv} ({rows} rows)")
        if rec["peak_mem_gb"] >= 80:
            problems.append(f"{tag}: peak {rec['peak_mem_gb']:.2f} GB")
        del eng, ctx
        torch.cuda.empty_cache()
    keep.pop("params")
    torch.cuda.empty_cache()
    exp, wire_rec = runs["expanded"], runs["wire"]
    rows = exp["kv_hop_rows_reckoned"]
    # the K / V payload: each run's KV bytes less the segment ids' 4 B a row
    payload = {k: runs[k]["ring_bytes"]["recv_kv"] - 4 * rows for k in runs}
    flips = _near_tie_flips(streams["wire"], streams["expanded"])
    summary = {"streams_equal": streams["wire"]["streams"] == streams["expanded"]["streams"],
               "flips": flips, "kv_payload_bytes": payload,
               "kv_payload_ratio": payload["wire"] / payload["expanded"],
               "kv_payload_ratio_want": lat / kv}
    if payload["wire"] * kv != payload["expanded"] * lat or not payload["wire"] > 0:
        problems.append(f"serve_minicpm_ring: the wire's K / V bytes {payload}, want "
                        f"{lat} / {kv} of the expanded run's")
    for k in ("recv_q", "send_o", "combine"):
        if wire_rec["ring_bytes"].get(k) != exp["ring_bytes"].get(k):
            problems.append(f"serve_minicpm_ring: {k} bytes differ: {wire_rec['ring_bytes']} vs "
                            f"{exp['ring_bytes']}")
    for f in flips:
        if max(f["card_gap"], f["cpu_gap"]) > RING_NEAR_TIE:
            problems.append(f"serve_minicpm_ring: the runs part beyond a near-tie: {f}")
    emit({"phase": "serve_minicpm_ring", "arch": MINICPM_ARCH, "num_layers": L,
          "dtype": "bf16", "sp_size": RING_N, "max_seq": 2048, "num_slots": 8, "page_size": 16,
          "num_pages": MINICPM_PAGES, "lengths": SERVE_LENGTHS,
          "arrival_ticks": SERVE_ARRIVALS, "new_tokens": 32, "near_tie": RING_NEAR_TIE,
          "runs": runs, "wire_vs_expanded": summary, "card": card})
    check(not problems, "; ".join(problems))
    return {"flash_attention_fwd (tile)": total["fwd_tile"],
            "flash_attention_fwd (decode)": total["fwd_decode"],
            "paged_flash_decode": total["paged_flash_decode"],
            "paged_decode_combine": total["paged_decode_combine"]}


# --------------------------------------------------------------------------
# phases 4q-4t: the encoder-decoder and VLM families (whisper-base,
# pixtral-12b)
# --------------------------------------------------------------------------

WHISPER_ARCH = "whisper-base"
# whisper-base's heads: 8 / 8 of 64, for its encoder, decoder and
# cross-attention alike
WHISPER_HEADS = (8, 8, 64)
# the whisper trace: 8 prompts of 4-64 decoder tokens at the serve trace's
# ticks, 128 greedy tokens, 8 slots, max_seq 448 (whisper's decoder
# context); the buckets 16 ... 64 and the encoder's 1536 rows
WHISPER_LENGTHS = [4, 9, 16, 23, 32, 41, 50, 64]
WHISPER_NEW = 128
# slice_whisper's new tokens a prompt: its CPU side decodes every one of them
# (26.6 of its 30.1 s at 128 in one whole run on an H100 host), cut for the
# run's time to 64, then to 32 (serve_whisper keeps 128)
WHISPER_SLICE_NEW = 32
WHISPER_MAX_SEQ = 448
PIXTRAL_ARCH = "pixtral-12b"
# pixtral's prompts: an image's 1024 patch positions, then text (the
# engine's zero patches embed every position below 1024 to zero, so a
# shorter prompt carries no text).  slice_pixtral: 3 prompts at 2 layers;
# serve_pixtral: 8 requests at the serve trace's ticks
PIXTRAL_SLICE_LENGTHS = [1040, 1072, 1100]
PIXTRAL_LENGTHS = [1024 + n for n in (32, 64, 96, 128, 192, 256, 384, 512)]
# serve_pixtral's pool: 768 pages of 16 (12,288 tokens) hold the trace's
# 10,112 (prompts and 32 new tokens each); at 40 layers x 8 kv heads x 128
# x 2 (K, V) x 2 B a token (163,840 B) that is 2.0 GB in bf16, beside 24.5
# GB of weights
PIXTRAL_PAGES = 768


def _perturb_norms(params, seed):
    """Draw the LayerNorm gains and biases away from their init (1, 0).  The
    engine feeds zero frames, so the encoder's output is its norms' biases'
    work: with zero biases the cross-attention K/V would be zero."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for path, leaf in tree_leaves(params):
        if path.rsplit("/", 1)[-1] in ("ln", "ln_b", "final_ln", "final_ln_b"):
            noise = torch.randn(leaf.shape, generator=gen, device="cuda")
            leaf.add_((0.2 * noise).to(leaf.dtype))


def _card_vs_cpu(cfg, params, serves, lengths, arrivals, new_tokens, phase):
    """The engine on the card under each of ``serves`` (key -> ServeConfig)
    and once on the CPU (the first), from the same fp32 weights: each card
    run's streams must equal the CPU's, its first-token logits within 1e-3,
    and only the card may launch a kernel."""
    params_cpu = _tree_to(params, "cpu")
    out, runs = {}, [("cpu", next(iter(serves)), params_cpu)]
    runs += [("cuda", key, params) for key in serves]
    for dev, key, p in runs:
        fa.flash_attention_fwd.launches = pk.paged_flash_decode.launches = 0
        eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serves[key])
        eng.capture_logits = True
        t0 = time.perf_counter()
        res = serve_trace(eng, lengths, arrivals, new_tokens, cfg.vocab_size, seed=1)
        out[(dev, key)] = dict(
            streams=[r.generated for r in res], statuses=[r.status for r in res],
            first=[eng.debug_logits[r.rid][0] for r in res], wall_s=time.perf_counter() - t0,
            launches={"flash_attention_fwd": fa.flash_attention_fwd.launches,
                      "paged_flash_decode": pk.paged_flash_decode.launches})
        del eng
    cpu = out[runs[0][:2]]
    rec, problems = {"cpu": {k: cpu[k] for k in ("wall_s", "launches")}}, []
    for key in serves:
        card = out[("cuda", key)]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card["first"], cpu["first"]))
        rec[key] = dict(streams_identical=card["streams"] == cpu["streams"],
                        first_logits_max_abs_err=err, wall_s=card["wall_s"],
                        launches=card["launches"])
        tag = f"{phase} {key}"
        if card["streams"] != cpu["streams"]:
            problems.append(f"{tag}: card and CPU streams differ: {card['streams']} vs "
                            f"{cpu['streams']}")
        if err > 1e-3:
            problems.append(f"{tag}: first-token logits differ by {err} > 1e-3")
        if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
            problems.append(f"{tag}: not every request finished ok")
        if card["launches"]["flash_attention_fwd"] == 0 or (
                serves[key].paged and card["launches"]["paged_flash_decode"] == 0):
            problems.append(f"{tag}: a kernel of the path never launched: {card['launches']}")
    if any(cpu["launches"].values()):
        problems.append(f"{phase}: the CPU side launched a kernel: {cpu['launches']}")
    return rec, problems


def slice_whisper():
    """whisper-base whole (6 + 6 layers), fp32, its LayerNorms drawn away
    from their init: the whisper trace (WHISPER_SLICE_NEW new tokens) over
    the dense cache on the card and on the CPU.  Streams identical,
    first-token logits within 1e-3."""
    cfg = get_config(WHISPER_ARCH)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    _perturb_norms(params, seed=5)
    serve = ServeConfig(max_seq=WHISPER_MAX_SEQ, num_slots=8, cache_dtype=torch.float32)
    rec, problems = _card_vs_cpu(cfg, params, {"dense": serve}, WHISPER_LENGTHS,
                                 SERVE_ARRIVALS, WHISPER_SLICE_NEW, "slice_whisper")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "slice_whisper", "arch": WHISPER_ARCH, "layers": [cfg.encoder_layers,
          cfg.num_layers], "dtype": "fp32", "lengths": WHISPER_LENGTHS,
          "new_tokens": WHISPER_SLICE_NEW, "max_seq": WHISPER_MAX_SEQ, **rec})
    check(not problems, "; ".join(problems))


def serve_whisper(card):
    """whisper-base whole in bf16 on the whisper trace, 8 slots, the dense
    cache: the encoder once per admission, cross- and self-attention decode
    on #1's decode body.  Counters set to 0 just before the run: #1 =
    (encoder + 2 x decoder layers) per prefill -- the encoder's on the tile
    body, the decoder rows' self- and cross-attention on the body
    ``_fwd_plan`` picks for the bucket (the decode body up to 32 rows) --
    and 2 x decoder layers per decode tick on the decode body; no call of a
    kernel's plain version.  Rates, peak memory, a profiled decode tick.
    Returns the launches counted, keyed as the kernels line's rows."""
    cfg = get_config(WHISPER_ARCH)
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    _perturb_norms(params, seed=5)
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=WHISPER_MAX_SEQ, num_slots=8, cache_dtype=torch.bfloat16))
    eng.generate(np.arange(16, dtype=np.int32)[None], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skip = eng.tick_stats()["ticks"]
    engine0 = (eng.prefill_launches, eng.decode_launches)
    fa.flash_attention_fwd.launches = pk.paged_flash_decode.launches = 0
    bodies0 = fwd_body_counts()
    t0 = time.perf_counter()
    with _PlainCalls() as plain:
        res = serve_trace(eng, WHISPER_LENGTHS, [a + skip for a in SERVE_ARRIVALS], WHISPER_NEW,
                          cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "paged_flash_decode": pk.paged_flash_decode.launches}
    bodies = fwd_body_delta(bodies0)
    prefills, decodes = (b - a for a, b in zip(engine0, (eng.prefill_launches,
                                                          eng.decode_launches)))
    stats = eng.tick_stats()
    pf_tok, pf_s = sum(stats["prefill_tokens"][skip:]), sum(stats["prefill_s"][skip:])
    dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
    dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
    dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
    rec = {
        "phase": "serve_whisper", "arch": WHISPER_ARCH,
        "layers": [cfg.encoder_layers, cfg.num_layers], "d_model": cfg.d_model,
        "heads": list(WHISPER_HEADS), "encoder_seq": cfg.encoder_seq, "vocab": cfg.vocab_size,
        "params": tfm.param_count(params), "dtype": "bf16", "cache": "dense",
        "max_seq": WHISPER_MAX_SEQ, "num_slots": 8, "lengths": WHISPER_LENGTHS,
        "arrival_ticks": SERVE_ARRIVALS, "new_tokens": WHISPER_NEW,
        "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip, "wall_s": wall,
        "prefill_launches": prefills, "prefill_tokens": pf_tok, "prefill_s": pf_s,
        "prefill_tok_per_s": pf_tok / pf_s, "decode_tokens": dec_tok, "decode_s": dec_s,
        "decode_tok_per_s": dec_tok / dec_s, "decode_ticks": len(dec_ticks),
        "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
        "ttft_ticks": [r.ttft_ticks for r in res],
        "cache_bytes": eng.kv_cache_stats()["cache_bytes"],
        "cross_cache_bytes": sum(eng._cache[k].numel() * eng._cache[k].element_size()
                                 for k in ("cross_k", "cross_v")),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "flash_attention_fwd_bodies": bodies, "plain_calls": plain.calls,
        "card": card,
    }
    per_prefill, per_tick = _attn_calls(cfg), 2 * cfg.num_layers
    want_bodies = {"tile": 0, "decode": per_tick * decodes, "fp32": 0}
    for n in WHISPER_LENGTHS:
        rows = eng.scheduler.bucket_for(n)
        want_bodies[fa._fwd_plan(1, cfg.encoder_seq, *WHISPER_HEADS, torch.bfloat16)[0]] += \
            cfg.encoder_layers
        want_bodies[fa._fwd_plan(1, rows, *WHISPER_HEADS, torch.bfloat16)[0]] += \
            2 * cfg.num_layers
    rec["decode_profile"] = profile_decode(eng, cfg)
    del eng, params
    torch.cuda.empty_cache()
    emit(rec)
    check(all(r.status == "ok" and len(r.generated) == WHISPER_NEW for r in res),
          f"serve_whisper: not every request finished ok: {rec['statuses']}")
    check(prefills == len(WHISPER_LENGTHS) and decodes > 0,
          f"serve_whisper: {prefills} prefill and {decodes} decode launches")
    check(launches == {"flash_attention_fwd": per_prefill * prefills + per_tick * decodes,
                       "paged_flash_decode": 0}
          and bodies == want_bodies,
          f"serve_whisper: #1 must launch {per_prefill} x {prefills} and {per_tick} x "
          f"{decodes} times, on the bodies {want_bodies}: {launches}, {bodies}")
    check(not any(plain.calls.values()), f"serve_whisper: a plain version ran: {plain.calls}")
    return {"flash_attention_fwd (tile)": bodies["tile"],
            "flash_attention_fwd (decode)": bodies["decode"]}


def slice_pixtral():
    """pixtral-12b at full width cut to 2 of 40 layers, fp32: 3 prompts of
    1,040-1,100 tokens (an image's 1024 patch positions, then text), 8 new
    tokens, on the card over the dense cache and the paged pool (16-token
    pages) against the CPU over the dense cache.  Streams identical,
    first-token logits within 1e-3."""
    cfg = dataclasses.replace(get_config(PIXTRAL_ARCH), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    base = dict(max_seq=1152, num_slots=4, cache_dtype=torch.float32)
    serves = {"dense": ServeConfig(**base),
              "paged": ServeConfig(**base, paged=True, page_size=16)}
    rec, problems = _card_vs_cpu(cfg, params, serves, PIXTRAL_SLICE_LENGTHS, [0, 0, 1], 8,
                                 "slice_pixtral")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "slice_pixtral", "arch": PIXTRAL_ARCH, "num_layers": 2, "dtype": "fp32",
          "lengths": PIXTRAL_SLICE_LENGTHS, "new_tokens": 8, "max_seq": 1152, **rec})
    check(not problems, "; ".join(problems))


def serve_pixtral(card):
    """pixtral-12b whole (40 layers, 12.2e9 parameters) in bf16 on the card
    (``_serve_whole``): 8 requests of 1024 + 32 ... 512 tokens, a pool of
    PIXTRAL_PAGES pages of 16, one-shot over the fp pool (#1 tile, #4) and
    over an int8 pool (#1 tile, 4q).  No chunked prefill and no speculation:
    JAX refuses both for a frontend arch."""
    runs = (("oneshot_fp", {}), ("oneshot_int8", dict(kv_dtype="int8")))
    return _serve_whole(card, PIXTRAL_ARCH, PIXTRAL_PAGES, "serve_pixtral", runs=runs,
                        lengths=PIXTRAL_LENGTHS)


# --------------------------------------------------------------------------
# phases 5 and 6: training
# --------------------------------------------------------------------------

# card vs CPU after one train step, fp32 (granite-8b width, 2 layers, seq 512).
# The two sides sum the same fp32 products in other orders (cuBLAS vs the
# CPU's BLAS over K = 4096 / 14336).  Readings on an H100: loss 9.5e-7, grad
# norm equal, per-leaf gradient 4.7e-6 of the leaf's max |g|, params 7.0e-7;
# the loss, grad-norm and gradient limits sit a few times above them.
# params: one AdamW step from zero moments moves a weight by lr_1 * (~1 +
# wd*|p|) with lr_1 = 3e-6 (warmup 1/100), so two sides that disagree on the
# sign of a near-zero gradient may differ by ~6e-6: the limit allows that.
PARITY_TOLS = {"loss": 1e-5, "grad_norm_rel": 1e-5, "grad_rel": 5e-5, "param": 1e-5}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


_PARITY_KERNELS = ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ssd_scan_fwd",
                   "ssd_scan_bwd")


def _train_kernel_counts():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv, ssd.ssd_scan_fwd.launches,
            ssd.ssd_scan_bwd.launches)


def _attn_calls(cfg) -> int:
    """Attention calls of one forward: each decoder layer's (and its
    cross-attention, with an encoder), each encoder layer's."""
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers * (2 if cfg.encoder_layers else 1) + cfg.encoder_layers


def _train_launches(cfg, steps=1):
    """What a remat train step launches per attention call: #1 twice and
    #2, #3 once; per SSD block #5 twice and #5b once."""
    A = _attn_calls(cfg) * steps
    L = cfg.num_layers * steps * (cfg.ssm is not None)
    return dict(zip(_PARITY_KERNELS, (2 * A, A, A, 2 * L, L)))


def train_parity(arch="granite-8b", seq=512, phase="train_parity", layers=2, batch=1):
    """One make_train_step on the card and on the CPU from the same weights:
    ``arch`` at full width cut to ``layers`` layers (and as many encoder
    layers, if it has an encoder), fp32."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers,
                              encoder_layers=min(cfg.encoder_layers, layers))
    opt = AdamWConfig()
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    sides = {"cuda": params, "cpu": _tree_to(params, "cpu")}
    out, launches, batch_rows = {}, {}, batch
    for dev, p in sides.items():
        ctx = ParallelCtx(device=dev)
        state = init_opt_state(p)
        batch = make_batch(cfg, seq, batch_rows, seed=0, step=0, ctx=ctx)
        before = _train_kernel_counts()
        t0 = time.perf_counter()
        p, state, _, metrics = make_train_step(cfg, ctx, opt)(p, state, {}, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        launches[dev] = dict(zip(_PARITY_KERNELS,
                                 (a - b for a, b in zip(_train_kernel_counts(), before))))
        out[dev] = dict(loss=loss, grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                        params=p, m=state.m)
    card, cpu = out["cuda"], out["cpu"]
    leaves = {}
    # the gradient the step applied (after clipping), read back from the first
    # moment: m = (1 - b1) * g after one step from zero moments.  Each CPU
    # leaf is moved to the card and compared there: the host's passes over
    # GB-sized leaves would take most of the phase
    m_cpu = dict(tree_leaves(cpu["m"]))
    p_cpu = dict(tree_leaves(cpu["params"]))
    p_card = dict(tree_leaves(card["params"]))
    for path, m_card in tree_leaves(card["m"]):
        m_ref, p_ref = m_cpu[path].cuda(), p_cpu[path].detach().cuda()
        leaves[path] = dict(
            grad_max_abs_err=float((m_card - m_ref).abs().max()) / (1 - opt.b1),
            grad_max_abs=float(m_ref.abs().max()) / (1 - opt.b1),
            param_max_abs_err=float((p_card[path].detach() - p_ref).abs().max()),
        )
        del m_ref, p_ref
    rec = {
        "phase": phase, "arch": arch, "num_layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "dtype": "fp32",
        "seq": seq, "batch": batch_rows, "loss": {"cuda": card["loss"], "cpu": cpu["loss"]},
        "grad_norm": {"cuda": card["grad_norm"], "cpu": cpu["grad_norm"]},
        "wall_s": {"cuda": card["wall_s"], "cpu": cpu["wall_s"]},
        "launches": launches, "leaves": leaves, "tols": PARITY_TOLS,
    }
    emit(rec)
    del sides, out, card, cpu, params, m_cpu, p_cpu, p_card
    torch.cuda.empty_cache()
    check(abs(rec["loss"]["cuda"] - rec["loss"]["cpu"]) <= PARITY_TOLS["loss"],
          f"{phase} ({arch}): loss differs")
    check(abs(rec["grad_norm"]["cuda"] - rec["grad_norm"]["cpu"])
          <= PARITY_TOLS["grad_norm_rel"] * rec["grad_norm"]["cpu"],
          f"{phase} ({arch}): grad norm differs")
    for path, leaf in leaves.items():
        check(leaf["grad_max_abs_err"] <= PARITY_TOLS["grad_rel"] * leaf["grad_max_abs"],
              f"{phase} ({arch}): gradient of {path} differs: {leaf}")
        check(leaf["param_max_abs_err"] <= PARITY_TOLS["param"],
              f"{phase} ({arch}): updated {path} differs: {leaf}")
    check(launches["cuda"] == _train_launches(cfg)
          and launches["cpu"] == dict.fromkeys(_PARITY_KERNELS, 0),
          f"{phase} ({arch}): kernels must run on the card only, with remat: {launches}")


# train_gemma_parity's sequence: its CPU side holds ~21 GB (params, grads
# and two moments of 1.34e9 fp32 weights), and at seq 512 its CPU step took
# 41 s of a 67 s phase on an H100 host's CPU (256: 44.5-52.2 s), so it takes
# 128.
# train_gemma's depth: 8 of 28 layers, 3.0e9 parameters, 48 GB of fp32
# params, grads and moments beside ~13 GB of [4096, 256,000] fp32 logits,
# their log-softmax and gradient (peak 69.5 GB on an H100)
GEMMA_PARITY_SEQ = 128
GEMMA_TRAIN_LAYERS = 8
# train_parity's and train_moe_parity's sequences and the depth of the
# latter and of train_gemma_parity, cut for time (an earlier full run: 35.5 s
# at seq 512, 58.0 s at seq 256 and 2 layers, 44.5 s at seq 256 and 2 layers
# on an H100 host, most of it their CPU steps over 0.84e9 / 1.76e9 / 1.34e9
# weights and the weights moved and compared on the host: at seq 128 the
# MoE phase still took 70.1 s, its CPU step 42.8 s, as the step's weight-
# sized passes (AdamW, the experts' gradients) do not shrink with seq)
TRAIN_PARITY_SEQ = 256
MOE_PARITY_SEQ = 128
MOE_PARITY_LAYERS = 1
GEMMA_PARITY_LAYERS = 1
# train_whisper's batch (x 448 decoder tokens and 1536 encoder frames a row)
WHISPER_TRAIN_BATCH = 16
# train_pixtral's depth: 8 of 40 layers (3.53e9 parameters, 56.5 GB of fp32
# params, grads and moments) peaked at 78.7 GB on an H100, past 72, so 6
# (2.98e9 parameters, 47.7 GB): the rest is [4096, 131,072] fp32 logits,
# their log-softmax and gradient, AdamW's temporaries and the layers' saved
# inputs
PIXTRAL_TRAIN_LAYERS = 6
# minicpm3-4b's training (MLA: the expanded 40 / 40 heads of 96 through #1
# and #2 / #3).  The parity phase: 1 layer, card vs CPU at seq 256, then
# sp_size 4 (mesh a = 2) vs 1 on the card at seq 2048.  train_minicpm's
# depth from the memory reckoning: 62,674,944 parameters a layer and
# 376,056,320 in the embedding and the untied head, so 40 of 62 layers hold
# 2.88e9 parameters, 46.1 GB of fp32 params, grads and moments, beside ~3.6
# GB of [4096, 73,448] fp32 logits, their log-softmax and gradient, and
# AdamW's temporaries over the stacked [L, 2560, 6400] leaves; its peak must
# stay under MINICPM_PEAK_GB
MINICPM_PARITY_LAYERS = 1
MINICPM_PARITY_SEQ = 256
MINICPM_MESH_SEQ = 2048
MINICPM_TRAIN_LAYERS = 40
MINICPM_PEAK_GB = 72.0


def full_train(card, arch="granite-8b", layers=8, phase="train", seq=4096, batch=1,
               steps=4, steps_docs=2, bf16_steps=2, max_peak_gb=None):
    """``arch`` at full width cut to ``layers`` layers (None: whole), fp32 +
    AdamW, remat, ``seq`` x ``batch``: ``steps`` causal steps and
    ``steps_docs`` of 4 packed documents, then ``bf16_steps`` bf16 steps
    (``full_train_bf16``); no call of a kernel's plain version; the fp32
    runs' peak memory under the card's (and ``max_peak_gb``); a profiled
    step.  Returns the launches of the fp32 runs, keyed as the kernels
    line's rows."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ctx = ParallelCtx(device="cuda")
    grad_norms = []
    hooks = {"on_step": lambda s, m: grad_norms.append(float(m["grad_norm"]))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = fa.fwd_split_terms.launches = 0
    fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
    bodies0, bwd0 = fwd_body_counts(), bwd_counts()
    tile_fp32 = fa.flash_attention_fwd.launches_tile_fp32
    runs, last = [], None
    with _PlainCalls() as plain:
        for n, docs in ((steps, None), (steps_docs, 4)):
            if not n:
                continue
            last = None  # the previous run's params go before the next run starts
            t0 = time.perf_counter()
            last = fit(cfg, ctx, TrainConfig(steps=n, seq=seq, batch=batch, seed=0, docs=docs),
                       hooks=hooks)
            runs.append(dict(docs=docs, losses=last["history"], step_s=last["step_seconds"],
                             fit_s=time.perf_counter() - t0,
                             params=tfm.param_count(last["params"])))
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv}
    bodies = fwd_body_delta(bodies0)
    tile_fp32 = fa.flash_attention_fwd.launches_tile_fp32 - tile_fp32
    fwd_split = fa.fwd_split_terms.launches
    bwd_bodies = {b: n - bwd0[b] for b, n in bwd_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_train_step(cfg, ctx, last.pop("params"), seq, batch=batch,
                                 docs=4 if steps_docs else None)
    del last
    torch.cuda.empty_cache()
    losses = [x for r in runs for x in r["losses"]]
    step_s = [x for r in runs for x in r["step_s"]]
    total = steps + steps_docs
    rec = {
        "phase": phase, "arch": arch, "num_layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers,
        "d_model": cfg.d_model, "heads": list(_attn_dims(cfg)),
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": runs[0]["params"],
        "param_dtype": "fp32", "optimizer": "adamw", "remat": True, "seq": seq, "batch": batch,
        "runs": [{k: v for k, v in r.items() if k != "params"} for r in runs],
        "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
        "tokens_per_s": [seq * batch / t for t in step_s], "peak_mem_gb": peak_gb,
        "launches": launches, "flash_attention_fwd_bodies": bodies,
        "flash_fwd_split_launches": fwd_split, "flash_attention_bwd_bodies": bwd_bodies,
        "plain_calls": plain.calls, "ln_vocab": float(np.log(cfg.vocab_size)),
        "profile": profile,
        "bf16": full_train_bf16(cfg, ctx, seq, batch, bf16_steps) if bf16_steps else None,
        "card": card,
    }
    emit(rec)
    check(len(losses) == total and all(np.isfinite(losses)),
          f"{phase}: losses not finite: {losses}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) < 1.5,
          f"{phase}: first loss {losses[0]} is not near ln(vocab) = {np.log(cfg.vocab_size)}")
    A = _attn_calls(cfg)
    check(launches == {"flash_attention_fwd": 2 * A * total, "flash_bwd_dq": A * total,
                       "flash_bwd_dkv": A * total},
          f"{phase}: launch counts off the remat schedule: {launches}")
    check(bodies == {"tile": 0, "decode": 0, "fp32": launches["flash_attention_fwd"]}
          and tile_fp32 == bodies["fp32"] == fwd_split,
          f"{phase}: the fp32 forward must run the fp32 tile body after one pre-pass each: "
          f"{bodies}, tile {tile_fp32}, pre-pass {fwd_split}")
    n_bwd = A * total
    check(bwd_bodies == {"tc_fp32": n_bwd, "tc_bf16": 0, "split": n_bwd},
          f"{phase}: every fp32 backward must run the fp32 tensor-core body: {bwd_bodies}")
    bf = rec["bf16"]
    check(not any(plain.calls.values()) and not (bf and any(bf["plain_calls"].values())),
          f"{phase}: a kernel's plain version ran: {plain.calls}, bf16 "
          f"{bf and bf['plain_calls']}")
    check(peak_gb * 1e9 <= torch.cuda.get_device_properties(0).total_memory
          and (max_peak_gb is None or peak_gb <= max_peak_gb),
          f"{phase}: peak {peak_gb} GB above the card's or {max_peak_gb}")
    if bf:
        check(len(bf["losses"]) == bf16_steps and all(np.isfinite(bf["losses"]))
              and abs(bf["losses"][0] - np.log(cfg.vocab_size)) < 1.5,
              f"{phase} (bf16): losses not finite or not near ln(vocab): {bf}")
        n_bf = A * bf16_steps
        check(bf["launches"] == {"flash_attention_fwd": 2 * n_bf, "flash_bwd_dq": n_bf,
                                 "flash_bwd_dkv": n_bf}
              and bf["flash_attention_fwd_bodies"] == {"tile": 2 * n_bf, "decode": 0,
                                                       "fp32": 0}
              and bf["flash_attention_bwd_bodies"] == {"tc_fp32": 0, "tc_bf16": n_bf,
                                                       "split": 0},
              f"{phase} (bf16): launches off the remat schedule or off the bf16 bodies: {bf}")
    return {**{k: launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")},
            "flash_attention_fwd (fp32)": bodies["fp32"], "flash_fwd_split": fwd_split,
            "flash_bwd_split": bwd_bodies["split"]}


def full_train_bf16(cfg, ctx, seq, batch=1, steps=2):
    """``steps`` causal steps of the train phase's model with bf16 params
    (the JAX package's ``param_dtype`` option); counters set to 0 just
    before."""
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
    bodies0, bwd0 = fwd_body_counts(), bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _PlainCalls() as plain:
        out = fit(cfg, ctx, TrainConfig(steps=steps, seq=seq, batch=batch, seed=0,
                                        param_dtype=torch.bfloat16))
    fit_s = time.perf_counter() - t0
    rec = {
        "param_dtype": "bf16", "steps": steps, "losses": out["history"],
        "step_s": out["step_seconds"], "fit_s": fit_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                     "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
                     "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv},
        "flash_attention_fwd_bodies": fwd_body_delta(bodies0),
        "flash_attention_bwd_bodies": {b: n - bwd0[b] for b, n in bwd_counts().items()},
        "plain_calls": plain.calls,
    }
    del out
    torch.cuda.empty_cache()
    return rec


def profile_train_step(cfg, ctx, params, seq, batch=1, docs=4):
    """Device time per kernel class of one more train step (``docs`` packed
    documents a row; None: causal rows) under torch.profiler; after the
    counted run."""
    from torch.profiler import ProfilerActivity, profile

    state = init_opt_state(params)
    step_fn = make_train_step(cfg, ctx, AdamWConfig(total_steps=2))
    batch = make_batch(cfg, seq, batch, seed=0, step=2, ctx=ctx, docs=docs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, metrics = step_fn(params, state, {}, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, by_kernel = device_time(prof)
    busy = sum(device_ms.values())
    del state, params
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "device_busy_ms": busy,
        "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]),
        # the profiler's own host cost inflates this window's wall clock
        "device_idle_share": (1 - busy / wall_ms) if device_ms else None,
    }


# --------------------------------------------------------------------------
# phases 6a-6d: SSM and hybrid training (#5 forward, #5b backward), MoE's
# card gate
# --------------------------------------------------------------------------

SSM_TRAIN = {  # arch: (steps, seq, batch) of train_ssm, each arch whole
    "mamba2-370m": (4, 4096, 4),
    "hymba-1.5b": (3, 4096, 2),
}
SSM_RING_SEQ = 4096


def train_ssm_ring_parity():
    """mamba2-370m and hymba-1.5b at full width, 2 layers, fp32, seq 4096,
    batch 1: one train step at sp_size 4 on the virtual ring (the sharded
    scan; hymba's attention through the mesh executor, a = 2, contiguous)
    against one at sp_size 1, both on the card, from the same weights and
    batch (train_parity's limits).  #5 once per layer and forward pass (x 2
    for remat) with the 4 ranks folded into its batch, #5b once per layer;
    the ssd_halo / ssd_state / ssd_tail exchanges twice _ssd_comm_model's
    (the forward runs twice)."""
    opt = AdamWConfig()
    recs, problems = [], []
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params0 = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        out = {}
        for name, ctx in (("sp1", ParallelCtx(device="cuda")),
                          ("sp4", ParallelCtx(sp_size=RING_N, attn_impl="mesh", mesh_a=2,
                                              device="cuda"))):
            p = _clone_tree(params0)
            state = init_opt_state(p)
            batch = make_batch(cfg, SSM_RING_SEQ, 1, seed=0, step=0, ctx=ctx)
            before = _train_kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _ScanBatches() as scans:
                p, state, _, metrics = make_train_step(cfg, ctx, opt)(p, state, {}, batch)
                loss = float(metrics["loss"])
            wall = time.perf_counter() - t0
            side = dict(loss=loss, grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                        launches=dict(zip(_PARITY_KERNELS, (a - b for a, b in zip(
                            _train_kernel_counts(), before)))),
                        scan_batches=scans.batches,
                        hops=dict(ctx.ring.stats.hops) if ctx.ring is not None else {},
                        bytes=dict(ctx.ring.stats.bytes) if ctx.ring is not None else {},
                        params=dict(tree_leaves(p)), m=dict(tree_leaves(state.m)))
            out[name] = side
            del p, state, batch
            torch.cuda.empty_cache()
        base, ring = out["sp1"], out["sp4"]
        leaves = {}
        for path, m4 in ring["m"].items():
            g, g_ref = m4 / (1 - opt.b1), base["m"][path] / (1 - opt.b1)
            leaves[path] = dict(
                grad_max_abs_err=float((g - g_ref).abs().max()),
                grad_max_abs=float(g_ref.abs().max()),
                param_max_abs_err=float((ring["params"][path] - base["params"][path])
                                        .detach().abs().max()),
            )
        L = cfg.num_layers
        want_hops, want_bytes = _ssd_comm_model(cfg, [SSM_RING_SEQ], itemsize=4)
        want_hops = {k: 2 * v for k, v in want_hops.items()}
        want_bytes = {k: 2 * v for k, v in want_bytes.items()}
        rec = {"phase": "train_ssm_ring_parity", "arch": arch, "num_layers": L, "dtype": "fp32",
               "seq": SSM_RING_SEQ, "batch": 1, "n": RING_N, "tols": PARITY_TOLS,
               "want_exchanges": {"hops": want_hops, "bytes": want_bytes},
               "sides": {k: {kk: vv for kk, vv in v.items() if kk not in ("params", "m")}
                         for k, v in out.items()}, "leaves": leaves}
        recs.append(rec)
        emit(rec)
        tag = f"train_ssm_ring_parity ({arch})"
        if abs(ring["loss"] - base["loss"]) > PARITY_TOLS["loss"]:
            problems.append(f"{tag}: loss {ring['loss']} vs {base['loss']}")
        if abs(ring["grad_norm"] - base["grad_norm"]) > PARITY_TOLS["grad_norm_rel"] * \
                base["grad_norm"]:
            problems.append(f"{tag}: grad norm {ring['grad_norm']} vs {base['grad_norm']}")
        for path, leaf in leaves.items():
            if leaf["grad_max_abs_err"] > PARITY_TOLS["grad_rel"] * leaf["grad_max_abs"] or \
                    leaf["param_max_abs_err"] > PARITY_TOLS["param"]:
                problems.append(f"{tag}: {path} differs: {leaf}")
        for name, side in out.items():
            want = _train_launches(cfg)
            got = {k: side["launches"][k] for k in ("ssd_scan_fwd", "ssd_scan_bwd")}
            batches = [RING_N if name == "sp4" else 1] * (2 * L)
            if got != {k: want[k] for k in got} or side["scan_batches"] != batches:
                problems.append(f"{tag}: {name} launched {got} at batches "
                                f"{side['scan_batches']}, want {want} at {batches}")
        got_hops = {k: ring["hops"].get(k, 0) for k in want_hops}
        got_bytes = {k: ring["bytes"].get(k, 0) for k in want_bytes}
        if (got_hops, got_bytes) != (want_hops, want_bytes):
            problems.append(f"{tag}: exchanges {got_hops} / {got_bytes}, want {want_hops} / "
                            f"{want_bytes}")
        if cfg.hybrid and not (ring["launches"]["flash_attention_fwd"] > 0
                               and ring["launches"]["flash_bwd_dq"] > 0):
            problems.append(f"{tag}: the attention did not run its kernels: {ring['launches']}")
        del params0, out, base, ring
        torch.cuda.empty_cache()
    check(not problems, "; ".join(problems))
    return recs


def train_ssm(card):
    """This slice's main path: mamba2-370m and hymba-1.5b whole at full
    width, fp32 params + AdamW, remat, through ``fit`` (SSM_TRAIN: steps,
    seq, batch).  Counters set to 0 just before each run and read just
    after: #5 = 2 x L x steps, #5b = L x steps (and hymba's #1 fp32 body, #2,
    #3 on the remat schedule); losses and grad norms finite, peak memory
    under the card's; one more step under torch.profiler."""
    runs, launches_main = [], dict.fromkeys(_PARITY_KERNELS, 0)
    launches_main["flash_attention_fwd (fp32)"] = launches_main["flash_bwd_split"] = 0
    launches_main["flash_fwd_split"] = 0
    for arch, (steps, seq, batch) in SSM_TRAIN.items():
        cfg = get_config(arch)
        ctx = ParallelCtx(device="cuda")
        grad_norms = []
        hooks = {"on_step": lambda st, m: grad_norms.append(float(m["grad_norm"]))}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_fwd.launches = fa.fwd_split_terms.launches = 0
        fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
        ssd.ssd_scan_fwd.launches = ssd.ssd_scan_bwd.launches = 0
        ssd.ssd_scan_fwd.launches_autograd = 0
        bodies0, bwd0 = fwd_body_counts(), bwd_counts()
        t0 = time.perf_counter()
        out = fit(cfg, ctx, TrainConfig(steps=steps, seq=seq, batch=batch, seed=0), hooks=hooks)
        fit_s = time.perf_counter() - t0
        launches = dict(zip(_PARITY_KERNELS, _train_kernel_counts()))
        scan_autograd = ssd.ssd_scan_fwd.launches_autograd
        bodies = fwd_body_delta(bodies0)
        bwd_bodies = {b: n - bwd0[b] for b, n in bwd_counts().items()}
        for k, n in launches.items():
            launches_main[k] += n
        fwd_split = fa.fwd_split_terms.launches
        launches_main["flash_attention_fwd (fp32)"] += bodies["fp32"]
        launches_main["flash_fwd_split"] += fwd_split
        launches_main["flash_bwd_split"] += bwd_bodies["split"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_params = tfm.param_count(out["params"])
        profile = profile_train_step(cfg, ctx, out.pop("params"), seq, batch=batch, docs=None)
        run = {"arch": arch, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
               "params": n_params, "param_dtype": "fp32", "optimizer": "adamw", "remat": True,
               "seq": seq, "batch": batch, "steps": steps, "losses": out["history"],
               "grad_norms": grad_norms, "step_s": out["step_seconds"], "fit_s": fit_s,
               "tokens_per_s": [seq * batch / t for t in out["step_seconds"]],
               "peak_mem_gb": peak_gb, "launches": launches,
               "ssd_scan_fwd_autograd": scan_autograd,
               "want_launches": _train_launches(cfg, steps),
               "flash_attention_fwd_bodies": bodies, "flash_fwd_split_launches": fwd_split,
               "flash_attention_bwd_bodies": bwd_bodies,
               "ln_vocab": float(np.log(cfg.vocab_size)), "profile": profile}
        runs.append(run)
        del out
        torch.cuda.empty_cache()
    emit({"phase": "train_ssm", "card": card, "runs": runs})
    for run in runs:
        tag = f"train_ssm ({run['arch']})"
        check(len(run["losses"]) == run["steps"] and all(np.isfinite(run["losses"]))
              and all(np.isfinite(run["grad_norms"]))
              and abs(run["losses"][0] - run["ln_vocab"]) < 1.5,
              f"{tag}: losses / grad norms not finite or not near ln(vocab): {run['losses']}, "
              f"{run['grad_norms']}")
        check(run["launches"] == run["want_launches"]
              and run["ssd_scan_fwd_autograd"] == run["launches"]["ssd_scan_fwd"],
              f"{tag}: launches off the remat schedule or the training split: "
              f"{run['launches']} ({run['ssd_scan_fwd_autograd']} with the training split) vs "
              f"{run['want_launches']}")
        n_attn = run["launches"]["flash_bwd_dq"]
        check(run["flash_attention_fwd_bodies"]["fp32"] == run["launches"]["flash_attention_fwd"]
              == run["flash_fwd_split_launches"]
              and run["flash_attention_bwd_bodies"] == {"tc_fp32": n_attn, "tc_bf16": 0,
                                                        "split": n_attn},
              f"{tag}: the fp32 attention must run the fp32 bodies: {run}")
        check(run["peak_mem_gb"] < torch.cuda.get_device_properties(0).total_memory / 1e9,
              f"{tag}: peak memory {run['peak_mem_gb']} GB")
    return launches_main


# --------------------------------------------------------------------------
# phases 7-9: the paper's Mesh-Attention over a virtual ring of 4 ranks
# --------------------------------------------------------------------------

# paper-mha-7b's attention (configs/paper_mha_7b.py: 32 heads x 128, MHA)
PAPER_HEADS = (32, 32, 128)
MESH_N = 4
MESH_S = 16384  # S / n = 4096 rows per rank's chunk
MESH_WINDOW = 1024
MESH_BACKENDS = (("mesh", 2), ("ring", 1), ("mesh", 4))
# mesh_op against the local flash call on the unstriped sequence: o within
# the limit, the q/k/v gradients of sum(sin(o)) within the limit times their
# max |g|.  fp32: JAX's dist_check mesh_fwd / mesh_bwd limits.  bf16: every
# block's o (and dq, dk, dv) leaves the kernel rounded to bf16 before the
# fp32 merge (as in JAX), so a row carries up to b + 1 <= 5 roundings of
# half an ulp (2**-9 of the value) where the local call has one: the limit is
# 2**-6 of the output's max for o and of each gradient's max.
MESH_OP_TOLS = {torch.float32: (2e-5, 5e-5), torch.bfloat16: (2**-6, 2**-6)}
MESH_OP_O_RELATIVE = {torch.float32: False, torch.bfloat16: True}
# 8 layers peaked at 42.0 GB, and each more layer adds ~4.3 GB (fp32 params,
# grads, the clipped grads, m, v: 20 B per weight, and its remat input), so
# 14 (~68 GB) were the most that fit; cut to 4 for the run's time (14 took
# 54.3 s of an earlier full run, 8 took 31.9-33.3 s on slower hosts)
MESH_TRAIN_LAYERS = 4


def _mesh_cfg_for(kind, a, transport=None, window=None, layout="striped"):
    spec = MaskSpec.causal(window=(window or MESH_WINDOW) if kind == "window" else None)
    return MeshAttentionConfig(transport=transport, n=MESH_N, a=a, mask=spec, layout=layout)


def _mesh_kernel_class(name: str) -> str:
    cls = _kernel_class(name)
    if cls != "other":
        return cls
    low = name.lower()
    if "index" in low or "copy" in low or "memcpy" in low:
        return "copy"  # the virtual ring's hops, the layout's splits and joins
    return "other"  # the online-softmax merges and the dq / dkv sums


def _mesh_device_time(prof, per=1):
    return device_time(prof, per, classify=_mesh_kernel_class)[0]


def mesh_block_case(kind, dtype, gen, heads=PAPER_HEADS, S=MESH_S, layout="striped",
                    window=None):
    """One AM block (u, v) = (0, 1) of a = 2 on all 4 ranks at once, as the
    executor's forward launches it: the ranks folded into the batch, one band
    per rank ([4, 4]), paper heads, 4096 rows per chunk, striped (stride 4)
    unless the arguments say otherwise.  Ranks 0 and 1 hold q chunk < kv
    chunk: their row 0 (contiguous: every row) sees no key."""
    nh, nkv, hd = heads
    R, m = MESH_N, S // MESH_N
    cfg = _mesh_cfg_for(kind, 2, window=window, layout=layout)
    blocks = [mesh_attention._band_for_block(cfg, i, 0, 1, m, m) for i in range(R)]
    bands = [b for b, _, _ in blocks]
    sq, skv = blocks[0][1], blocks[0][2]
    q = randn(gen, R, m, nh, hd, dtype=dtype)
    k = randn(gen, R, m, nkv, hd, dtype=dtype)
    v = randn(gen, R, m, nkv, hd, dtype=dtype)
    band_t = torch.tensor(bands, dtype=torch.int32, device="cuda")
    kw = dict(scale=hd**-0.5, stride_q=sq, stride_kv=skv)
    run = lambda: fa.flash_attention_fwd(q, k, v, band_t, **kw)  # noqa: E731

    def plain():
        outs = [ref.attention_ref(q[r:r + 1], k[r:r + 1], v[r:r + 1], band=bands[r], **kw)
                for r in range(R)]
        return torch.cat([o for o, _ in outs]), torch.cat([lse for _, lse in outs])

    before = fwd_body_counts(FWD_PLAN_BODIES)
    o, lse = run()
    body = [b for b, n in fwd_body_delta(before).items() if n]
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.equal(lse[~live], lse_ref[~live])) and bool(
        torch.all(o.transpose(1, 2)[~live] == 0))
    mask = torch.stack([ref.band_mask(m, m, bands[r], stride_q=sq, stride_kv=skv, device="cuda")
                        for r in range(R)])
    empty_rows = int((~mask.any(-1)).sum())
    visible_pairs = int(mask.sum())
    visible_keys = int(mask.any(dim=-2).sum())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None], scale=hd**-0.5, enable_gqa=nkv != nh)
    item = q.element_size()
    nbytes = (2 * q.numel() + 2 * visible_keys * nkv * hd) * item + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * hd * nh * visible_pairs, dtype, FWD_PEAK)
    tol = TOLS[("flash_attention_fwd", dtype)]
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_fwd", case=f"mesh_block_{kind}", S=S, rows=m, B=R,
        heads=list(heads), layout=layout, bands=bands, stride=sq, dtype=DTYPE_NAMES[dtype],
        body=body[0] if len(body) == 1 else body, max_abs_err=err, max_abs_err_lse=err_lse,
        tol=tol, tol_lse=LSE_TOL, empty_rows=empty_rows, empty_rows_exact=empty_exact,
        ms=time_ms(run), device_ms=device_ms.get("flash_attention_fwd", 0.0),
        plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib), bound_ms=bound_ms,
        bound_by=bound_by, visible_pairs=visible_pairs,
    )
    if dtype == torch.float32:
        rec["bound_ms_fp32_cores"], rec["bound_by_fp32_cores"] = bound(
            nbytes, 4 * hd * nh * visible_pairs, dtype)
    del q, k, v, o, lse, o_ref, lse_ref, mask, qt, kt, vt
    torch.cuda.empty_cache()
    want_body = fa._fwd_plan(R, m, nh, nkv, hd, dtype)[0]
    check(body == [want_body], f"mesh block forward ran {body}, not the {want_body} body: {rec}")
    check(empty_rows > 0, f"the mesh block case must hold rows that see no key: {rec}")
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"mesh block forward disagrees with its plain version: {rec}")
    return rec


def mesh_block_bwd_case(kind, dtype, gen):
    """The backward of block (0, 1) of a = 2 on rank 0 (q chunk 0, kv chunk
    2: row 0 sees no key), one band ([4]) as the executor launches it per
    rank; dq of the rows that see nothing must be exactly 0, dk / dv finite,
    and a second launch bitwise equal."""
    nh, nkv, hd = PAPER_HEADS
    m = MESH_S // MESH_N
    band, sq, skv = mesh_attention._band_for_block(_mesh_cfg_for(kind, 2), 0, 0, 1, m, m)
    band_t = torch.tensor(band, dtype=torch.int32, device="cuda")
    q = randn(gen, 1, m, nh, hd, dtype=dtype)
    k = randn(gen, 1, m, nkv, hd, dtype=dtype)
    v = randn(gen, 1, m, nkv, hd, dtype=dtype)
    do = randn(gen, 1, m, nh, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, stride_q=sq, stride_kv=skv)
    o, lse = ref.attention_ref(q, k, v, band=band, **kw)
    delta = (do.float() * o.float()).sum(-1)
    run = lambda: fa.flash_attention_bwd(q, k, v, None, lse, do, band_t, delta=delta, **kw)  # noqa: E731
    plain = lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)  # noqa: E731
    before = bwd_counts()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    ran = {b: n - before[b] for b, n in bwd_counts().items()}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    mask = ref.band_mask(m, m, band, stride_q=sq, stride_kv=skv, device="cuda")
    blind = ~mask.any(dim=1)
    blind_dq_zero = bool(torch.all(got[0][0][blind] == 0))
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    atol, rtol = BWD_TOLS[dtype]
    errs, ratio = {}, 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        errs[gname] = float(diff.max())
        ratio = max(ratio, float((diff / (atol + rtol * w.float().abs())).max()))
    pairs = int(mask.sum())
    vis_keys, vis_rows = int(mask.any(dim=0).sum()), int(mask.any(dim=1).sum())
    item = q.element_size()
    # as bwd_case: dQ reads q, dO and writes dq for every row, K/V of the
    # visible keys, lse and delta; dK/dV the rows that see a key, all of k, v
    dq_bytes = 3 * m * nh * hd * item + 2 * vis_keys * nkv * hd * item + 2 * nh * m * 4
    dkv_bytes = 2 * vis_rows * nh * hd * item + 4 * m * nkv * hd * item + 2 * nh * vis_rows * 4
    split, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_bwd", case=f"mesh_block_{kind}", S=MESH_S, rows=m,
        heads=list(PAPER_HEADS), band=list(band), stride=sq, dtype=DTYPE_NAMES[dtype],
        ran=ran, max_abs_err=errs, tol_atol=atol, tol_rtol=rtol, max_err_over_tol=ratio,
        bitwise_repeat=bitwise, blind_rows=int(blind.sum()), blind_rows_dq_zero=blind_dq_zero,
        finite=finite, ms_dq=split.get("flash_bwd_dq", 0.0), ms_dkv=split.get("flash_bwd_dkv", 0.0),
        ms_split=split.get("flash_bwd_split", 0.0), ms_pair=time_ms(run, reps=10),
        plain_ms_pair=time_ms(plain, reps=5), visible_pairs_per_head=pairs,
        bound_ms_dq=bound(dq_bytes, 6 * hd * nh * pairs, dtype, BWD_PEAK)[0],
        bound_ms_dkv=bound(dkv_bytes, 8 * hd * nh * pairs, dtype, BWD_PEAK)[0],
    )
    del got, again, want, q, k, v, do, o, lse, delta, mask
    torch.cuda.empty_cache()
    check(ratio <= 1.0 and bitwise and finite and blind_dq_zero and int(blind.sum()) > 0,
          f"mesh block backward disagrees with its plain version or repeats unequal: {rec}")
    return rec


def mesh_counts():
    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
        "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv,
        "flash_bwd_split": fa.split_terms.launches,
        "fwd_split": fa.fwd_split_terms.launches,
        **{f"fwd_{b}": n for b, n in fwd_body_counts().items()},
    }


def _schedules_of(backend, a, kind, seq):
    fwd = S.ring_forward_schedule(MESH_N) if backend == "ring" else None
    cfg = dataclasses.replace(_mesh_cfg_for(kind, a), fwd_schedule=fwd)
    return cfg.schedules(seq)


def _expected_hops(fwd, bwd):
    hops = {}
    for sched in (fwd, bwd):
        for kind, c in S.comm_requirements(sched.a, sched.b, sched.direction, sched.skip).items():
            if c:
                hops[kind] = hops.get(kind, 0) + c
    return hops


def mesh_op_case(kind, dtype, gen):
    """dispatch.distributed_attention over the virtual ring at S 16384, paper
    heads: mesh (a = 2), ring, mesh (a = 4), each in the three comm_overlap
    modes, forward and the gradients of sum(sin(o)), against the local flash
    call on the unstriped sequence."""
    nh, nkv, hd = PAPER_HEADS
    window = MESH_WINDOW if kind == "window" else None
    q = randn(gen, 1, MESH_S, nh, hd, dtype=dtype)
    k = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    v = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    order = torch.from_numpy(stripe_permutation(MESH_S, MESH_N)).cuda()
    inv = torch.from_numpy(unstripe_permutation(MESH_S, MESH_N)).cuda()

    def local():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True, window=window)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    o_ref, g_ref = local()
    o_ref, g_ref = o_ref.detach(), [g.float() for g in g_ref]
    o_max, g_max = float(o_ref.float().abs().max()), [float(g.abs().max()) for g in g_ref]
    tol_o, tol_g = MESH_OP_TOLS[dtype]
    lim_o = tol_o * o_max if MESH_OP_O_RELATIVE[dtype] else tol_o
    comm = CommModel(seq=MESH_S, hidden=nh * hd, n=MESH_N, kv_hidden=nkv * hd,
                     bytes_per_elem=q.element_size())
    xs_striped = [t[:, order].contiguous() for t in (q, k, v)]
    runs, main_counts = [], None
    for backend, a in MESH_BACKENDS:
        fwd_s, bwd_s = _schedules_of(backend, a, kind, MESH_S)
        want_hops = _expected_hops(fwd_s, bwd_s)
        first = None
        for mode in S.COMM_OVERLAP_MODES:
            ring = VirtualRing(MESH_N)
            cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=MESH_N, a=a,
                                               causal=True, window=window, comm_overlap=mode)

            def call():
                xs = [t.detach().requires_grad_(True) for t in xs_striped]
                o = dispatch.distributed_attention(*xs, cfg=cfg)
                return o, torch.autograd.grad(o.float().sin().sum(), xs)

            torch.cuda.synchronize()
            c0 = mesh_counts()
            o, g = call()
            torch.cuda.synchronize()
            counts = {key: n - c0[key] for key, n in mesh_counts().items()}
            hops, nbytes = dict(ring.stats.hops), dict(ring.stats.bytes)
            if first is None:
                o_err = float((o[:, inv].float() - o_ref.float()).abs().max())
                g_err = [float((gg[:, inv].float() - gr).abs().max()) for gg, gr in zip(g, g_ref)]
                first = dict(o=o.detach(), g=[gg.detach() for gg in g])
                rec = dict(backend=backend, a=a, b=MESH_N // a, o_err=o_err, o_limit=lim_o,
                           g_err=g_err, g_limit=[tol_g * x for x in g_max],
                           fwd_blocks=len(fwd_s.blocks()), bwd_blocks=len(bwd_s.blocks()),
                           launches=counts, hops=hops, bytes=nbytes,
                           model_bytes={kk: comm.chunk_bytes(ck) * hops.get(kk, 0)
                                        for kk, ck in (("recv_q", "q"), ("recv_kv", "kv"),
                                                       ("send_o", "o"), ("recv_odoq", "odoq"),
                                                       ("send_dq", "dq"), ("send_dkv", "dkv"))
                                        if hops.get(kk)},
                           bitwise_modes={})
                if backend == "mesh" and a == 2:
                    main_counts = counts
                check(o_err <= lim_o and all(e <= lim for e, lim in zip(g_err, rec["g_limit"])),
                      f"mesh_op: {backend} a={a} disagrees with the local flash call: {rec}")
                n_fwd, n_bwd = len(fwd_s.blocks()), len(bwd_s.blocks()) * MESH_N
                check(counts["flash_attention_fwd"] == n_fwd and counts["flash_bwd_dq"] == n_bwd
                      and counts["flash_bwd_dkv"] == n_bwd
                      and counts["fwd_split"] == counts["fwd_fp32"],
                      f"mesh_op: launches off the schedules ({n_fwd} forward, {n_bwd} per "
                      f"backward kernel), or the fp32 pre-pass not once per fp32 forward: {rec}")
                check(hops == want_hops, f"mesh_op: hops off comm_requirements {want_hops}: {rec}")
                for kk, ck in (("recv_q", "q"), ("recv_kv", "kv")):
                    check(nbytes.get(kk, 0) == hops.get(kk, 0) * comm.chunk_bytes(ck),
                          f"mesh_op: {kk} bytes off CommModel.chunk_bytes: {rec}")
            else:
                same = bool(torch.equal(o, first["o"])) and all(
                    torch.equal(x, y) for x, y in zip(g, first["g"]))
                rec["bitwise_modes"][mode] = same
                check(same and hops == rec["hops"] and nbytes == rec["bytes"],
                      f"mesh_op: {backend} a={a} {mode} is not bitwise the serial mode: {rec}")
            del o, g
        ring = VirtualRing(MESH_N)
        cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=MESH_N, a=a,
                                           causal=True, window=window)
        fwd_only = lambda: dispatch.distributed_attention(*xs_striped, cfg=cfg)  # noqa: E731

        def fwd_bwd():
            xs = [t.detach().requires_grad_(True) for t in xs_striped]
            o = dispatch.distributed_attention(*xs, cfg=cfg)
            torch.autograd.grad(o.float().sin().sum(), xs)

        rec["ms_fwd"] = time_ms(fwd_only, reps=5, warmup=1)
        rec["ms_fwd_bwd"] = time_ms(fwd_bwd, reps=3, warmup=1)
        rec["device_ms_fwd_bwd"] = _mesh_device_time(_profiled(fwd_bwd, 2), per=2)
        runs.append(rec)
        del first
        torch.cuda.empty_cache()

    def local_fwd():
        return ops.flash_attention(q, k, v, causal=True, window=window)

    out = dict(kind=kind, window=window, dtype=DTYPE_NAMES[dtype], S=MESH_S, n=MESH_N,
               heads=list(PAPER_HEADS), o_max=o_max, g_max=g_max, runs=runs,
               local_ms_fwd=time_ms(local_fwd, reps=5, warmup=1),
               local_ms_fwd_bwd=time_ms(local, reps=3, warmup=1),
               local_device_ms_fwd_bwd=_mesh_device_time(_profiled(local, 2), per=2))
    del q, k, v, xs_striped, o_ref, g_ref
    torch.cuda.empty_cache()
    return out, main_counts


def mesh_op(card):
    """Phase mesh_op: the dispatch seam over the virtual ring (see
    ``mesh_op_case``); the launches of mesh (a = 2) in overlap mode are the
    main path's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases, launches = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            rec, counts = mesh_op_case(kind, dtype, gen)
            cases.append(rec)
            for key, n in counts.items():
                launches[key] = launches.get(key, 0) + n
    emit({"phase": "mesh_op", "card": card, "tols": {DTYPE_NAMES[d]: t
                                                      for d, t in MESH_OP_TOLS.items()},
          "cases": cases, "launches_main": launches})
    return launches


# Algorithm 1's collective form on a 2 x 2 grid of the same 4 ranks
COLLECTIVE_GRID = (2, 2)


def collective_case(kind, dtype, gen):
    """mesh_attention_collective over a virtual ring of 4 (a = b = 2) at S
    16384, paper heads, in the three comm_overlap modes, forward and the
    gradients of sum(sin(o)), against the local flash call and the executor
    (dispatch, mesh a = 2: mesh_op's main call)."""
    nh, nkv, hd = PAPER_HEADS
    a, b = COLLECTIVE_GRID
    window = MESH_WINDOW if kind == "window" else None
    mask = MaskSpec.causal(window=window)
    q = randn(gen, 1, MESH_S, nh, hd, dtype=dtype)
    k = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    v = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    order = torch.from_numpy(stripe_permutation(MESH_S, MESH_N)).cuda()
    inv = torch.from_numpy(unstripe_permutation(MESH_S, MESH_N)).cuda()
    xs_striped = [t[:, order].contiguous() for t in (q, k, v)]

    def local():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True, window=window)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    mesh_cfg = dispatch.AttentionPlanConfig(backend="mesh", transport=VirtualRing(MESH_N),
                                            n=MESH_N, a=a, causal=True, window=window)

    def mesh():
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = dispatch.distributed_attention(*xs, cfg=mesh_cfg)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    o_ref, g_ref = local()
    o_ref, g_ref = o_ref.detach().float(), [g.float() for g in g_ref]
    o_mesh, g_mesh = mesh()
    o_mesh, g_mesh = o_mesh[:, inv].detach().float(), [g[:, inv].float() for g in g_mesh]
    o_max, g_max = float(o_ref.abs().max()), [float(g.abs().max()) for g in g_ref]
    tol_o, tol_g = MESH_OP_TOLS[dtype]
    lim_o = tol_o * o_max if MESH_OP_O_RELATIVE[dtype] else tol_o
    lim_g = [tol_g * x for x in g_max]
    elem = q.element_size()
    m = MESH_S // MESH_N
    want_bytes = {"gather_q": (a - 1) * m * nh * hd * elem,
                  "gather_kv": (b - 1) * 2 * m * nkv * hd * elem,
                  "gather_lse": (a - 1) * a * nh * m * 4,
                  "scatter_o": (a - 1) * m * nh * hd * 4}
    rec = dict(kind=kind, window=window, dtype=DTYPE_NAMES[dtype], S=MESH_S, n=MESH_N, a=a, b=b,
               heads=list(PAPER_HEADS), o_limit=lim_o, g_limit=lim_g, bitwise_modes={},
               want_bytes=want_bytes)
    first, main_counts = None, None
    for mode in S.COMM_OVERLAP_MODES:
        ring = VirtualRing(MESH_N)
        torch.cuda.synchronize()
        c0 = mesh_counts()
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = ring.join(mesh_attention_collective(*(ring.split(t) for t in xs), ring, a, b,
                                                mask=mask, comm_overlap=mode))
        g = torch.autograd.grad(o.float().sin().sum(), xs)
        torch.cuda.synchronize()
        counts = {key: n - c0[key] for key, n in mesh_counts().items()}
        if first is None:
            first = dict(o=o.detach(), g=[x.detach() for x in g])
            ou, gu = o.detach()[:, inv].float(), [x[:, inv].float() for x in g]
            rec.update(
                o_err_local=float((ou - o_ref).abs().max()),
                g_err_local=[float((x - y).abs().max()) for x, y in zip(gu, g_ref)],
                o_err_mesh=float((ou - o_mesh).abs().max()),
                g_err_mesh=[float((x - y).abs().max()) for x, y in zip(gu, g_mesh)],
                launches=counts, hops=dict(ring.stats.hops), bytes=dict(ring.stats.bytes),
                messages=dict(ring.stats.messages))
            main_counts = counts
            check(rec["o_err_local"] <= lim_o and rec["o_err_mesh"] <= lim_o
                  and all(e <= lim for e, lim in zip(rec["g_err_local"], lim_g))
                  and all(e <= lim for e, lim in zip(rec["g_err_mesh"], lim_g)),
                  f"collective: disagrees with local flash or mesh a = 2: {rec}")
            check(rec["bytes"] == want_bytes and rec["hops"] == {kk: 1 for kk in want_bytes},
                  f"collective: bytes per kind off (group size - 1) x the chunk: {rec}")
            blocks = a * b
            check(counts["flash_attention_fwd"] == blocks
                  and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == blocks * MESH_N
                  and counts["fwd_split"] == counts["fwd_fp32"],
                  f"collective: #1 must launch once per (u, w) block ({blocks}), #2 / #3 once "
                  f"per block and rank, the fp32 pre-pass once per fp32 #1: {counts}")
        else:
            same = bool(torch.equal(o, first["o"])) and all(
                torch.equal(x, y) for x, y in zip(g, first["g"]))
            rec["bitwise_modes"][mode] = same
            check(same and dict(ring.stats.bytes) == rec["bytes"],
                  f"collective: {mode} is not bitwise the serial mode: {rec}")
        del o, g
    ring = VirtualRing(MESH_N)

    def coll_fwd():
        with torch.no_grad():
            mesh_attention_collective(*(ring.split(t) for t in xs_striped), ring, a, b, mask=mask)

    def coll_fwd_bwd():
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = mesh_attention_collective(*(ring.split(t) for t in xs), ring, a, b, mask=mask)
        torch.autograd.grad(o.float().sin().sum(), xs)

    def mesh_fwd():
        with torch.no_grad():
            dispatch.distributed_attention(*xs_striped, cfg=mesh_cfg)

    rec["ms_fwd"] = time_ms(coll_fwd, reps=5, warmup=1)
    rec["ms_fwd_bwd"] = time_ms(coll_fwd_bwd, reps=3, warmup=1)
    rec["mesh_ms_fwd"] = time_ms(mesh_fwd, reps=5, warmup=1)
    rec["mesh_ms_fwd_bwd"] = time_ms(mesh, reps=3, warmup=1)
    del q, k, v, xs_striped, o_ref, g_ref, o_mesh, g_mesh, first
    torch.cuda.empty_cache()
    return rec, main_counts


def collective(card):
    """Phase collective: Algorithm 1's collective form (see
    ``collective_case``); the serial mode's launches are the main path's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases, launches = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            rec, counts = collective_case(kind, dtype, gen)
            cases.append(rec)
            for key, n in counts.items():
                launches[key] = launches.get(key, 0) + n
    emit({"phase": "collective", "card": card, "tols": {DTYPE_NAMES[d]: t
                                                         for d, t in MESH_OP_TOLS.items()},
          "cases": cases, "launches_main": launches})
    return launches


def _attn_dims(cfg):
    """(query heads, kv heads, head dim) of the attention kernels' calls:
    MLA's expanded heads at the qk width (V padded to it)."""
    if cfg.mla is not None:
        return cfg.num_heads, cfg.num_heads, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.num_heads, cfg.num_kv_heads, cfg.hd


def train_mesh_parity(arch="paper-mha-7b", layers=2, seq=4096, impls=(("mesh", 2), ("ring", 1)),
                      phase="train_mesh_parity", cfg=None, a2a_bytes=None, wire_phase=None):
    """``arch`` at full width cut to ``layers`` layers (or ``cfg``), fp32:
    one train step at sp_size 4 on the virtual ring (each of ``impls``: mesh
    a = 2, ring) against one at sp_size 1, all on the card, from the same
    weights and batch.  Each ring step launches #1 twice (remat) and #2 / #3
    once per layer and schedule block (the backward per rank), and its Q and
    KV hops carry ``CommModel.chunk_bytes`` each; with ``a2a_bytes`` (an
    "ep" MoE arch) its moe_dispatch and moe_return bytes are that.
    ``wire_phase`` (an MLA arch, with a "mesh" impl): a further step at
    sp_size 4 with the latent on the KV ring (``mla_latent_wire``), held to
    the mesh step under its own phase name: the same limits, the same
    launches (its blocks' backward is autograd's, one #2 / #3 pair a rank
    and block), the KV hops carrying kvr + rope of the 2 x H x qk values a
    row (``_mla_wire_ratio``) and the Q hops the mesh step's bytes."""
    cfg = cfg or dataclasses.replace(get_config(arch), num_layers=layers)
    arch, layers = cfg.name, cfg.num_layers
    opt = AdamWConfig()
    params0 = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    nh, nkv, hd = _attn_dims(cfg)
    comm = CommModel(seq=seq, hidden=nh * hd, n=MESH_N, kv_hidden=nkv * hd, bytes_per_elem=4)
    ctxs = {"sp1": ParallelCtx(device="cuda")}
    for impl, a in impls:
        ctxs[impl] = ParallelCtx(sp_size=MESH_N, attn_impl=impl,
                                 mesh_a=a if impl == "mesh" else None, device="cuda")
    if wire_phase is not None:
        ctxs["wire"] = ParallelCtx(sp_size=MESH_N, mesh_a=dict(impls)["mesh"], device="cuda",
                                   mla_latent_wire=True)
    # the sides others are held to: sp_size 1, and the mesh step for the wire
    against = {name: "sp1" for name, _ in impls}
    against["wire"] = "mesh"
    out, refs = {}, {}
    for name, ctx in ctxs.items():
        p = _clone_tree(params0)
        state = init_opt_state(p)
        batch = make_batch(cfg, seq, 1, seed=0, step=0, ctx=ctx)
        torch.cuda.synchronize()
        c0 = mesh_counts()
        t0 = time.perf_counter()
        p, state, _, metrics = make_train_step(cfg, ctx, opt)(p, state, {}, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        side = dict(loss=loss, grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                    launches={key: n - c0[key] for key, n in mesh_counts().items()},
                    hops=dict(ctx.ring.stats.hops) if ctx.ring is not None else {},
                    bytes=dict(ctx.ring.stats.bytes) if ctx.ring is not None else {})
        if name != "sp1":
            impl, a = ("mesh", ctx.mesh_a) if name == "wire" else (name, dict(impls)[name])
            fwd_s, bwd_s = _schedules_of(impl, a, "causal", seq)
            # the wire's backward is autograd through its forward's blocks
            blocks = len((fwd_s if name == "wire" else bwd_s).blocks())
            side["want_launches"] = {"flash_attention_fwd": 2 * layers * len(fwd_s.blocks()),
                                     "flash_bwd_dq": layers * blocks * MESH_N}
            ref_side = refs[against[name]]
            leaves, p_now = {}, dict(tree_leaves(p))
            for path, m_card in tree_leaves(state.m):
                g = m_card / (1 - opt.b1)
                g_ref = ref_side["m"][path] / (1 - opt.b1)
                leaves[path] = dict(
                    grad_max_abs_err=float((g - g_ref).abs().max()),
                    grad_max_abs=float(g_ref.abs().max()),
                    param_max_abs_err=float((p_now[path] - ref_side["params"][path])
                                            .abs().max()),
                )
            side["leaves"] = leaves
            del p_now
        if name in against.values() and (name != "mesh" or "wire" in ctxs):
            refs[name] = dict(params=dict(tree_leaves(p)), m=dict(tree_leaves(state.m)))
        out[name] = side
        del p, state, batch
        torch.cuda.empty_cache()
    rec = {"phase": phase, "arch": arch, "num_layers": layers, "dtype": "fp32", "seq": seq,
           **({"moe": dataclasses.asdict(cfg.moe), "a2a_bytes_reckoned": a2a_bytes}
              if cfg.moe else {}),
           "batch": 1, "n": MESH_N, "heads": [nh, nkv, hd], "tols": PARITY_TOLS,
           "sides": {k: v for k, v in out.items() if k != "wire"}}
    emit(rec)
    del params0, refs
    torch.cuda.empty_cache()
    _mesh_parity_gates(phase, out, impls, comm, a2a_bytes)
    if wire_phase is not None:
        lat, kv = _mla_wire_ratio(cfg)
        emit({"phase": wire_phase, "arch": arch, "num_layers": layers, "dtype": "fp32",
              "seq": seq, "batch": 1, "n": MESH_N, "mesh_a": ctxs["wire"].mesh_a,
              "heads": [nh, nkv, hd], "tols": PARITY_TOLS, "against": "mesh",
              "kv_values_a_row": [lat, kv], "side": out["wire"], "mesh": out["mesh"]})
        _mesh_parity_gates(wire_phase, out, [("wire", None)], comm, None,
                           kv_bytes=comm.chunk_bytes("kv") * lat // kv, against=against)


def _mesh_parity_gates(phase, out, impls, comm, a2a_bytes, kv_bytes=None, against=None):
    """train_mesh_parity's gates on each of ``impls``' sides against its
    reference (``against``; sp_size 1 by default): loss, grad norm, every
    gradient and updated leaf, the launches, and the bytes of each Q and KV
    hop (``kv_bytes``: the KV hop's, when not CommModel's)."""
    for name, _ in impls:
        base = out[(against or {}).get(name, "sp1")]
        side = out[name]
        check(abs(side["loss"] - base["loss"]) <= PARITY_TOLS["loss"],
              f"{phase}: {name} loss differs: {side['loss']} vs {base['loss']}")
        check(abs(side["grad_norm"] - base["grad_norm"])
              <= PARITY_TOLS["grad_norm_rel"] * base["grad_norm"],
              f"{phase}: {name} grad norm differs")
        for path, leaf in side["leaves"].items():
            check(leaf["grad_max_abs_err"] <= PARITY_TOLS["grad_rel"] * leaf["grad_max_abs"],
                  f"{phase}: {name} gradient of {path} differs: {leaf}")
            check(leaf["param_max_abs_err"] <= PARITY_TOLS["param"],
                  f"{phase}: {name} updated {path} differs: {leaf}")
        check(side["hops"].get("recv_kv", 0) > 0, f"{phase}: {name} made no KV hop")
        ran, want = side["launches"], side["want_launches"]
        check(ran["flash_attention_fwd"] == want["flash_attention_fwd"]
              and ran["flash_bwd_dq"] == ran["flash_bwd_dkv"] == ran["flash_bwd_split"]
              == want["flash_bwd_dq"],
              f"{phase}: {name} launches off the schedules x layers x remat: {ran} vs {want}")
        for kk, want in (("recv_q", comm.chunk_bytes("q")),
                         ("recv_kv", kv_bytes or comm.chunk_bytes("kv"))):
            check(side["bytes"].get(kk, 0) == side["hops"].get(kk, 0) * want,
                  f"{phase}: {name} {kk} bytes off {want} a hop: {side}")
        if a2a_bytes is not None:
            check(side["bytes"].get("moe_dispatch") == side["bytes"].get("moe_return")
                  == a2a_bytes > 0,
                  f"{phase}: {name} all-to-all bytes {side['bytes']}, reckoned {a2a_bytes}")


def train_mesh(card):
    """paper-mha-7b at full width cut to MESH_TRAIN_LAYERS layers, fp32 + AdamW,
    remat, seq 16384, batch 1, sp_size 4 on the virtual ring: 2 steps on mesh
    (a = 2), then 2 on ring, through fit; one more mesh step under the
    profiler."""
    cfg = dataclasses.replace(get_config("paper-mha-7b"), num_layers=MESH_TRAIN_LAYERS)
    seq, steps = MESH_S, 2
    runs, launches_main = [], {}
    for impl, a in (("mesh", 2), ("ring", 1)):
        ctx = ParallelCtx(sp_size=MESH_N, attn_impl=impl, mesh_a=a if impl == "mesh" else None,
                          device="cuda")
        fwd_s, bwd_s = _schedules_of(impl, a, "causal", seq)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c0 = mesh_counts()
        t0 = time.perf_counter()
        out = fit(cfg, ctx, TrainConfig(steps=steps, seq=seq, batch=1, seed=0))
        fit_s = time.perf_counter() - t0
        counts = {key: n - c0[key] for key, n in mesh_counts().items()}
        for key, n in counts.items():
            launches_main[key] = launches_main.get(key, 0) + n
        L = cfg.num_layers
        want = {"flash_attention_fwd": 2 * L * len(fwd_s.blocks()) * steps,
                "flash_bwd_dq": L * len(bwd_s.blocks()) * MESH_N * steps}
        want["flash_bwd_dkv"] = want["flash_bwd_split"] = want["flash_bwd_dq"]
        run = dict(attn=impl, a=a, losses=out["history"], step_s=out["step_seconds"],
                   tokens_per_s=[seq / t for t in out["step_seconds"]], fit_s=fit_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches_per_step={k: n / steps for k, n in counts.items()},
                   want_launches_per_step={k: n / steps for k, n in want.items()},
                   hops_per_step={k: n / steps for k, n in ctx.ring.stats.hops.items()},
                   bytes_per_step={k: n / steps for k, n in ctx.ring.stats.bytes.items()},
                   params=tfm.param_count(out["params"]))
        if impl == "mesh":
            run["profile"] = _profile_mesh_step(cfg, ctx, out.pop("params"), seq)
        runs.append((run, counts, want))
        del out
        torch.cuda.empty_cache()
    rec = {"phase": "train_mesh", "arch": "paper-mha-7b", "num_layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "param_dtype": "fp32", "optimizer": "adamw", "remat": True,
           "seq": seq, "batch": 1, "n": MESH_N, "ring": "VirtualRing",
           "reduced": {"num_layers": f"{get_config('paper-mha-7b').num_layers} -> "
                                     f"{cfg.num_layers} (fp32 params + AdamW at seq 16384)"},
           "ln_vocab": float(np.log(cfg.vocab_size)), "runs": [r for r, _, _ in runs],
           "card": card}
    emit(rec)
    for run, counts, want in runs:
        losses = run["losses"]
        check(len(losses) == steps and all(np.isfinite(losses))
              and abs(losses[0] - np.log(cfg.vocab_size)) < 1.5,
              f"train_mesh: {run['attn']} losses not finite or not near ln(vocab): {losses}")
        check(all(counts[k] == n for k, n in want.items()),
              f"train_mesh: {run['attn']} launches off the schedules x layers x remat: "
              f"{counts} vs {want}")
        check(counts["fwd_fp32"] == counts["flash_attention_fwd"] == counts["fwd_split"],
              f"train_mesh: the fp32 forward must run the fp32 bodies after one pre-pass "
              f"each: {counts}")
    return launches_main


def _profile_mesh_step(cfg, ctx, params, seq):
    """Device time per kernel class (the hops' and layout's copies apart) of
    one more mesh train step under torch.profiler; after the counted run."""
    from torch.profiler import ProfilerActivity, profile

    state = init_opt_state(params)
    step_fn = make_train_step(cfg, ctx, AdamWConfig(total_steps=2))
    batch = make_batch(cfg, seq, 1, seed=0, step=2, ctx=ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, metrics = step_fn(params, state, {}, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _mesh_device_time(prof)
    busy = sum(device_ms.values())
    del state, params
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if device_ms else None}


def mla_kernel_cases(gen):
    """minicpm3-4b's kernel rows (the kernels phase): #1 at head dims 96
    and 288, #4 / 4q at head dim 288 with a group of 40, at MLA's scale.
    #4 / 4q's bf16 limit (1e-3) is below one bf16 ulp of any o above 0.25,
    and at MLA's scale (96^-0.5 over 288 dims) the softmax is peaked enough
    that o reaches there: their bf16 rows take an element past the limit
    only as one rounding step from the plain version (``ulp_flips``), and
    say how many."""
    out = {"flash": [], "paged": [], "quant": []}
    for dtype in (torch.float32, torch.bfloat16):
        out["flash"].append(flash_case("causal", 2048, dtype, gen, heads=MLA_PREFILL_HEADS))
        for name in ("chunk", "verify"):
            out["flash"].append(flash_case(name, 2048, dtype, gen, heads=MLA_LATENT_HEADS,
                                           scale=MLA_SCALE))
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = lambda: scratch.add_(1)  # noqa: E731
    for dtype in (torch.bfloat16, torch.float32):
        out["paged"].append(paged_case(None, dtype, gen, flush, heads=MLA_LATENT_HEADS,
                                       scale=MLA_SCALE, ulp_flips=True))
        for kv_dtype in QUANT_DTYPES:
            out["quant"].append(quant_paged_case(kv_dtype, None, dtype, gen, flush,
                                                 heads=MLA_LATENT_HEADS, scale=MLA_SCALE,
                                                 ulp_flips=True))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {**(ptxas_summary(libs["flash_fwd_tc"]) or {}),
             **(ptxas_summary(libs["flash_fwd_mla"]) or {}),
             **(ptxas_summary(libs["flash_bwd"], prefix="flash_bwd_") or {}),
             **(ptxas_summary(libs["paged_decode"], prefix="paged_decode_") or {}),
             **(ptxas_summary(libs["ssd_scan"], prefix="ssd_scan_") or {}),
             **(ptxas_summary(libs["ssd_scan_bwd"], prefix="ssd_bwd_") or {})}
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "build_s": build_s,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas})

    check(not any(k.get("serialized_wgmma") for k in ptxas.values()),
          f"ptxas serialized the wgmma products of a tensor-core kernel: {ptxas}")
    bwd96 = {k: v for k, v in ptxas.items() if k.startswith("flash_bwd_") and "<96," in k}
    check(len(bwd96) == 4 and not any(v.get("spill_stores") or v.get("spill_loads")
                                       for v in bwd96.values()),
          f"the backward's head-dim-96 kernels must build without spills: {bwd96}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash, paged, bwd = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        # granite's S 1024 rows (the S 2048 rows' shapes at half the length)
        # are cut for the run's time since PR 31: drawn, not run
        for S in (1024, 2048):
            for name in ("causal", "window", "striped", "segment", "decode", "verify", "chunk"):
                rec = flash_case(name, S, dtype, gen, measure=S == 2048)
                if rec is not None:
                    flash.append(rec)
        # hymba-1.5b's attention: window prefill, and the dense-cache decode
        # tick of its 8 slots over max_seq 2048
        for S in (1024, 1536):
            flash.append(flash_case("window", S, dtype, gen, heads=HYMBA_HEADS))
        flash.append(flash_case("decode", 2048, dtype, gen, heads=HYMBA_HEADS))
    # the ring's chunk and verify launches: 4 ranks x 8 slots folded, stride 4
    ring_flash = [flash_case(name, 2048, torch.bfloat16, gen, ranks=RING_N)
                  for name in ("chunk", "verify")]
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = lambda: scratch.add_(1)  # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 512):
            paged.append(paged_case(window, dtype, gen, flush))
    quant = []
    for kv_dtype in QUANT_DTYPES:
        for dtype in (torch.float32, torch.bfloat16):
            for window in (None, 512):
                quant.append(quant_paged_case(kv_dtype, window, dtype, gen, flush))
    # qwen2-moe-a2.7b's attention (GQA group 1), as serve_moe launches it:
    # bf16 causal and packed prefill rows on the tile body, the int8 pool's
    # chunks and verifies on the fp32 body, #4 over the bf16 fp pool, 4q
    # over the int8 pool
    for S in (1024, 2048):
        flash.append(flash_case("causal", S, torch.bfloat16, gen, heads=QWEN_MOE_HEADS))
    flash.append(flash_case("segment", 2048, torch.bfloat16, gen, heads=QWEN_MOE_HEADS))
    for name in ("chunk", "verify"):
        flash.append(flash_case(name, 2048, torch.float32, gen, heads=QWEN_MOE_HEADS))
    paged.append(paged_case(None, torch.bfloat16, gen, flush, heads=QWEN_MOE_HEADS))
    quant.append(quant_paged_case("int8", None, torch.bfloat16, gen, flush,
                                  heads=QWEN_MOE_HEADS))
    # qwen2.5-32b's attention (GQA group 5 at head dim 128), as serve_qwen
    # launches it: bf16 causal and packed prefill rows on the tile body, the
    # decode body at 8 slots, the int8 pool's chunks and verifies on the fp32
    # body, #4 over the bf16 fp pool, 4q over the int8 pool
    for S in (1024, 2048):
        flash.append(flash_case("causal", S, torch.bfloat16, gen, heads=QWEN_HEADS))
    for name in ("segment", "decode"):
        flash.append(flash_case(name, 2048, torch.bfloat16, gen, heads=QWEN_HEADS))
    for name in ("chunk", "verify"):
        flash.append(flash_case(name, 2048, torch.float32, gen, heads=QWEN_HEADS))
    paged.append(paged_case(None, torch.bfloat16, gen, flush, heads=QWEN_HEADS))
    quant.append(quant_paged_case("int8", None, torch.bfloat16, gen, flush, heads=QWEN_HEADS))
    # gemma-7b's attention (16 / 16 heads of 256), as serve_gemma and
    # slice_gemma launch it: bf16 causal and packed prefill rows on the tile
    # body, fp32 causal, the int8 pool's chunks and verifies on the fp32
    # bodies, the decode body at 8 slots in both types, #4 with bf16 and
    # fp32 queries, 4q over int8 and fp8 pools
    for S in (1024, 2048):
        flash.append(flash_case("causal", S, torch.bfloat16, gen, heads=GEMMA_HEADS))
    for name in ("segment", "decode"):
        flash.append(flash_case(name, 2048, torch.bfloat16, gen, heads=GEMMA_HEADS))
    for name in ("causal", "chunk", "verify", "decode"):
        flash.append(flash_case(name, 2048, torch.float32, gen, heads=GEMMA_HEADS))
    for dtype in (torch.bfloat16, torch.float32):
        paged.append(paged_case(None, dtype, gen, flush, heads=GEMMA_HEADS))
    for kv_dtype in QUANT_DTYPES:
        quant.append(quant_paged_case(kv_dtype, None, torch.bfloat16, gen, flush,
                                      heads=GEMMA_HEADS))
    # hymba-1.5b over a ring of 4 (serve_ssm_ring): the folded decode rows of
    # its dense cache (window 1024, 4 ranks x 8 slots, stride 4)
    ring_flash.append(flash_case("decode", 2048, torch.bfloat16, gen, heads=HYMBA_HEADS,
                                 ranks=RING_N))
    # sequence-sharded decode over a ring of 4: the ranks folded into one
    # launch, beside the n = 1 rows above
    ring_paged = [ring_paged_case(kv_dtype, gen, flush) for kv_dtype in ("fp", "int8")]
    del scratch
    combine = [split_combine_case(dtype, gen) for dtype in (torch.float32, torch.bfloat16)]
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ssd_cases = [
        ssd_case("mamba2", 1, 2048, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("mamba2", 1, 1536, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("mamba2_short_chunk", 1, 48, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("hymba", 1, 1024, 50, 64, 1, 16, 64, gen, flush),
        ssd_case("mamba2_batch4", 4, 512, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("reduced", 1, 256, 16, 16, 1, 16, 8, gen, flush),
        ssd_case("mamba2_large_dt", 1, 2048, 32, 64, 1, 128, 64, gen, flush, dt_value=3.0),
        # the sequence-sharded scan over a ring of 4 (serve_ssm_ring): the
        # ranks folded into the batch of one launch, at a 1,536-token
        # prompt's 384 rows a rank, and at local lengths 12 and 2 (a chunk
        # of the local length)
        ssd_case("mamba2_ring4", 4, 384, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("hymba_ring4", 4, 384, 50, 64, 1, 16, 64, gen, flush),
        ssd_case("mamba2_ring4_local12", 4, 12, 32, 64, 1, 128, 12, gen, flush),
        ssd_case("mamba2_ring4_local2", 4, 2, 32, 64, 1, 128, 2, gen, flush),
        # the training forward's split (under autograd) at train_ssm's rows
        ssd_case("mamba2_train", 4, 4096, 32, 64, 1, 128, 64, gen, flush, autograd=True),
        ssd_case("hymba_train", 2, 4096, 50, 64, 1, 16, 64, gen, flush, autograd=True),
    ]
    # #5b, the scan's backward: train_ssm's rows (mamba2 B 4 x 4096, hymba
    # B 2 x 4096), the serving rows, a one-chunk case, the sharded scan's
    # folded ranks with a nonzero gradient of the final state, and dt = 3
    ssd_bwd_cases = [
        ssd_bwd_case("mamba2_train", 4, 4096, 32, 64, 1, 128, 64, gen, flush),
        ssd_bwd_case("hymba_train", 2, 4096, 50, 64, 1, 16, 64, gen, flush),
        ssd_bwd_case("mamba2", 1, 2048, 32, 64, 1, 128, 64, gen, flush),
        ssd_bwd_case("hymba", 1, 1024, 50, 64, 1, 16, 64, gen, flush),
        ssd_bwd_case("mamba2_short_chunk", 1, 48, 32, 64, 1, 128, 64, gen, flush),
        ssd_bwd_case("mamba2_ring4", 4, 384, 32, 64, 1, 128, 64, gen, flush, dstate=True),
        ssd_bwd_case("mamba2_large_dt", 1, 2048, 32, 64, 1, 128, 64, gen, flush, dt_value=3.0),
    ]
    del scratch
    # the training row (4096) in every mask and causal at 2048; the S 1024
    # rows went for the run's time (after every paged row, so the forward's
    # and the decode's cases keep their inputs)
    for dtype in (torch.float32, torch.bfloat16):
        bwd.append(bwd_case("causal", 2048, dtype, gen))
        for name in ("causal", "window", "striped", "segment"):
            bwd.append(bwd_case(name, 4096, dtype, gen))
    # gemma-7b's backward (16 / 16 heads of 256), as train_gemma launches
    # it: the training row (causal, 4096), the masks at 1024, a ragged S
    # (1000: a part-filled last CTA and tile) and a group of 2
    for dtype in (torch.float32, torch.bfloat16):
        bwd.append(bwd_case("causal", 4096, dtype, gen, heads=GEMMA_HEADS))
        for name in ("window", "striped", "segment"):
            bwd.append(bwd_case(name, 1024, dtype, gen, heads=GEMMA_HEADS))
        bwd.append(bwd_case("causal", 1000, dtype, gen, heads=GEMMA_HEADS))
        bwd.append(bwd_case("causal", 1024, dtype, gen, heads=GEMMA_GQA2_HEADS))
    split = split_case(4096, gen)
    fwd_split = fwd_split_case(4096, gen)  # the train phase's forward
    # the mesh executor's blocks: 4 ranks folded into the forward's batch,
    # the backward per rank; row 0 of some ranks sees no key
    mesh_blocks = []
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            mesh_blocks.append(mesh_block_case(kind, dtype, gen))
            mesh_blocks.append(mesh_block_bwd_case(kind, dtype, gen))
    # hymba-1.5b's mesh prefill over a ring of 4 (serve_ssm_ring): the
    # contiguous, window-1024 blocks of a 1,536-token prompt
    mesh_blocks.append(mesh_block_case("window", torch.bfloat16, gen, heads=HYMBA_HEADS,
                                       S=1536, layout="contiguous", window=1024))
    # whisper-base's attention (8 / 8 heads of 64), drawn last so that every
    # earlier case keeps its inputs: the forward as serve_whisper and
    # slice_whisper launch it -- the encoder's non-causal 1536 rows, the
    # cross-attention prefill (the trace's largest bucket, 64 rows, over the
    # 1536 encoder rows), the cross-attention decode (8 slots x 1 row over
    # 1536), the decoder's dense-cache decode (8 slots over max_seq 448) --
    # and the backward as train_whisper launches it: the encoder's band, the
    # decoder rows' cross band (448 rows over 1536) and a ragged 440 rows
    for dtype in (torch.float32, torch.bfloat16):
        for name in ("full", "cross", "cross_decode"):
            flash.append(flash_case(name, 1536, dtype, gen, heads=WHISPER_HEADS))
        flash.append(flash_case("decode", WHISPER_MAX_SEQ, dtype, gen, heads=WHISPER_HEADS))
        for rows in (1536, WHISPER_MAX_SEQ, 440):
            bwd.append(bwd_case("full", 1536, dtype, gen, heads=WHISPER_HEADS, Sq=rows))
    # minicpm3-4b's MLA (drawn after every earlier case): #1's tile body at
    # head dim 96 over the expanded 40 / 40 heads (causal prefill at 2048)
    # and at head dim 288 over the absorbed latent (40 query heads on one kv
    # head: a 256-token chunk and a 4-row verify over 2048), both types; #4
    # and 4q at head dim 288, group 40 (8 slots, depths to 2047), bf16 and
    # fp32 queries, over fp, int8 and fp8 pools
    mla = mla_kernel_cases(gen)
    flash += mla["flash"]
    paged += mla["paged"]
    quant += mla["quant"]
    # minicpm3-4b's backward (#2 / #3 at head dim 96 over the expanded 40 /
    # 40 heads), drawn after every earlier case: train_minicpm's row (causal
    # 4096), a packed-segment row and a ragged one (1000 rows, off the
    # kernels' 64-row tiles)
    for dtype in (torch.float32, torch.bfloat16):
        for name, S in (("causal", 4096), ("segment", 1024), ("causal", 1000)):
            bwd.append(bwd_case(name, S, dtype, gen, heads=MLA_PREFILL_HEADS))
    emit({"phase": "kernels", "card": card,
          "cases": flash + paged + quant + combine + ssd_cases + ssd_bwd_cases + bwd + [split]
          + [fwd_split] + mesh_blocks
          + ring_flash + ring_paged})
    cross_device()
    launches, serve_rec, serve_streams = full_serve(card)
    cpu_runs = cross_device_quant()
    quant_launches, quant_runs, quant_streams = full_serve_quant(card)
    launches["paged_flash_decode_quant"] = quant_launches["paged_flash_decode_quant"]
    # serving over a ring of 4 ranks on the card
    ring_slice = slice_ring(cpu_runs)
    ring = serve_ring(card, serve_rec, serve_streams)
    # serving under memory pressure: preempt-and-recompute and the chaos
    # injector, card vs CPU at 2 layers, then granite-8b in full
    slice_pressure()
    pressure = serve_pressure(card, quant_runs, quant_streams)
    cross_device_ssm()
    launches["ssd_scan_fwd"], launches["flash_attention_fwd (decode)"] = full_serve_ssm(card)
    # the SSM and hybrid archs over a ring of 4: the sequence-sharded scan
    slice_ssm_ring()
    ssm_ring = serve_ssm_ring(card)
    # the MoE decoders: card vs CPU at 1 layer, at sp_size 1 and over a ring
    # of 4 (expert parallelism; slice_moe's weights, freed before
    # serve_moe's 57 GB fp32 check), then served at full width, qwen2-moe
    # also whole at sp_size 4, and a train step at sp_size 4 vs 1
    slice_moe_ring(cross_device_moe())
    moe_launches, moe_sp1 = serve_moe(card)
    moe_ring = serve_moe_ring(card, moe_sp1)
    train_moe_ring_parity()
    # qwen2.5-32b: card vs CPU at 2 layers, then served whole
    cross_device(QWEN_ARCH, phase="slice_qwen")
    qwen_launches = serve_qwen(card)
    # gemma-7b (head dim 256): card vs CPU at 2 layers, then served whole
    cross_device(GEMMA_ARCH, phase="slice_gemma", quant_run=True)
    gemma_launches = serve_gemma(card)
    # whisper-base (encoder-decoder) whole card vs CPU, then served in bf16;
    # pixtral-12b (VLM) card vs CPU at 2 layers, then served whole
    slice_whisper()
    whisper_launches = serve_whisper(card)
    slice_pixtral()
    pixtral_launches = serve_pixtral(card)
    # minicpm3-4b (MLA: #1 at head dims 96 and 288, #4 / 4q at 288, group
    # 40): card vs CPU at 2 layers, then served whole; each followed by its
    # run over a ring of 4 on the weights it holds (slice_mla_ring also on its
    # CPU runs): the latent wire and the sequence-sharded latent cache
    minicpm_slice, minicpm_whole = {}, {}
    cross_device(MINICPM_ARCH, phase="slice_minicpm", quant_run=True, loop_prompt=True,
                 keep=minicpm_slice)
    slice_mla_ring(minicpm_slice)
    minicpm_launches = serve_minicpm(card, keep=minicpm_whole)
    mla_ring = serve_minicpm_ring(card, minicpm_whole)
    for key in ("flash_attention_fwd (tile)", "paged_flash_decode"):
        minicpm_launches[key] += mla_ring[key]
    launches["flash_attention_fwd (decode)"] += mla_ring["flash_attention_fwd (decode)"]
    # serve_ring's launches join the serving rows
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (decode)", "fwd_decode"),
                      ("paged_flash_decode", "paged_flash_decode")):
        launches[key] += ring[part]
    train_parity(seq=TRAIN_PARITY_SEQ)
    # train and train_gemma take 2 causal, 1 packed and 1 bf16 step, cut
    # for the run's time
    launches.update(full_train(card, steps=2, steps_docs=1, bf16_steps=1))
    # gemma-7b (head dim 256): card vs CPU at 1 layer, then trained at 8
    train_parity(GEMMA_ARCH, seq=GEMMA_PARITY_SEQ, phase="train_gemma_parity",
                 layers=GEMMA_PARITY_LAYERS)
    gemma_train = full_train(card, GEMMA_ARCH, GEMMA_TRAIN_LAYERS, phase="train_gemma",
                             steps=2, steps_docs=1, bf16_steps=1)
    for key, n in gemma_train.items():
        launches[key] += n
    # whisper-base at 2 + 2 layers card vs CPU, then trained whole; pixtral-12b
    # trained at full width, PIXTRAL_TRAIN_LAYERS of its 40 layers
    train_parity(WHISPER_ARCH, seq=WHISPER_MAX_SEQ, phase="train_whisper_parity", batch=2)
    whisper_train = full_train(card, WHISPER_ARCH, None, phase="train_whisper",
                               seq=WHISPER_MAX_SEQ, batch=WHISPER_TRAIN_BATCH, steps_docs=0)
    pixtral_train = full_train(card, PIXTRAL_ARCH, PIXTRAL_TRAIN_LAYERS, phase="train_pixtral",
                               steps_docs=0, bf16_steps=0)
    # minicpm3-4b (MLA: #1 and #2 / #3 at head dim 96): card vs CPU and
    # sp_size 4 vs 1 at 1 layer, then trained at MINICPM_TRAIN_LAYERS
    train_parity(MINICPM_ARCH, seq=MINICPM_PARITY_SEQ, phase="train_minicpm_parity",
                 layers=MINICPM_PARITY_LAYERS)
    train_mesh_parity(MINICPM_ARCH, layers=MINICPM_PARITY_LAYERS, seq=MINICPM_MESH_SEQ,
                      impls=(("mesh", 2),), phase="train_minicpm_parity",
                      wire_phase="train_minicpm_wire_parity")
    minicpm_train = full_train(card, MINICPM_ARCH, MINICPM_TRAIN_LAYERS, phase="train_minicpm",
                               steps=2, steps_docs=1, bf16_steps=1, max_peak_gb=MINICPM_PEAK_GB)
    for part in (whisper_train, pixtral_train, minicpm_train):
        for key, n in part.items():
            launches[key] += n
    # SSM and hybrid training (#5 forward, #5b backward) card vs CPU, over a
    # ring of 4 vs one rank, then whole; the MoE family's train step card vs
    # CPU
    for arch in SSM_ARCHS:
        train_parity(arch, seq=512, phase="train_ssm_parity")
    train_parity("qwen2-moe-a2.7b", seq=MOE_PARITY_SEQ, phase="train_moe_parity",
                 layers=MOE_PARITY_LAYERS)
    train_ssm_ring_parity()
    ssm_train = train_ssm(card)
    launches["ssd_scan_fwd (training)"] = ssm_train["ssd_scan_fwd"]
    launches["ssd_scan_bwd"] = ssm_train["ssd_scan_bwd"]
    for key in ("flash_attention_fwd (fp32)", "flash_fwd_split", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_bwd_split"):
        launches[key] += ssm_train[key]
    # serve_moe's, serve_moe_ring's, serve_qwen's, serve_gemma's,
    # serve_whisper's, serve_pixtral's and serve_minicpm's runs join the
    # serving rows
    for key, n in (list(moe_launches.items()) + list(moe_ring.items())
                   + list(qwen_launches.items())
                   + list(gemma_launches.items()) + list(whisper_launches.items())
                   + list(pixtral_launches.items()) + list(minicpm_launches.items())):
        launches[key] += n
    # serve_ssm_ring's ring runs: #5 folded, hymba's prefill blocks and
    # folded decode rows, the ranks' combine
    launches["ssd_scan_fwd"] += ssm_ring["ssd_scan_fwd"]
    launches["flash_attention_fwd (tile)"] += ssm_ring["fwd_tile"]
    launches["flash_attention_fwd (decode)"] += ssm_ring["fwd_decode"]
    # slice_ring's fp32 chunks and verifies, and its quantized decode ticks
    launches["flash_attention_fwd (fp32)"] += ring_slice["fwd_fp32"]
    launches["flash_fwd_split"] += ring_slice["fwd_split"]
    launches["paged_flash_decode_quant"] += ring_slice["paged_flash_decode_quant"]
    # serve_pressure's fp and int8 runs (the chaos runs are gates, not counted)
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (fp32)", "fwd_fp32"), ("flash_fwd_split", "fwd_split"),
                      ("paged_flash_decode", "paged_flash_decode"),
                      ("paged_flash_decode_quant", "paged_flash_decode_quant")):
        launches[key] += pressure[part]
    # the Mesh-Attention path: the dispatch seam and paper-mha-7b training
    # over a virtual ring of 4 ranks; their main runs' launches join the counts
    mesh = [mesh_op(card), collective(card)]
    train_mesh_parity()
    mesh.append(train_mesh(card))
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (fp32)", "fwd_fp32"), ("flash_fwd_split", "fwd_split"),
                      ("flash_bwd_dq", "flash_bwd_dq"), ("flash_bwd_dkv", "flash_bwd_dkv"),
                      ("flash_bwd_split", "flash_bwd_split")):
        launches[key] += sum(m[part] for m in mesh)

    granite = [H, HKV, D]
    main_flash = next(r for r in flash if r["case"] == "causal" and r["S"] == 2048
                      and r["dtype"] == "bf16" and r["heads"] == granite)
    # the decode body's main path: hymba's dense-cache ticks
    main_flash_decode = next(r for r in flash if r["case"] == "decode" and r["dtype"] == "bf16"
                             and r["heads"] == list(HYMBA_HEADS))
    # the fp32 body's main path: the training forward
    main_flash_fp32 = next(r for r in flash if r["case"] == "causal" and r["S"] == 2048
                           and r["dtype"] == "fp32" and r["heads"] == granite)
    main_paged = next(r for r in paged if r["case"] == "full" and r["dtype"] == "bf16"
                      and r["heads"] == granite)
    main_quant = next(r for r in quant if r["case"] == "full" and r["dtype"] == "bf16"
                      and r["kv_dtype"] == "int8" and r["heads"] == granite)
    main_ssd = next(r for r in ssd_cases if r["case"] == "mamba2" and r["S"] == 2048)
    # the training forward's main path: train_ssm's mamba2-370m rows
    main_ssd_train = next(r for r in ssd_cases if r["case"] == "mamba2_train")
    # #5b's main path: train_ssm's mamba2-370m rows
    main_ssd_bwd = next(r for r in ssd_bwd_cases if r["case"] == "mamba2_train")
    # the ranks' combine on the ring's decode path: the split combine kernel
    # over the folded fp pool's partials
    ring_combine = next(r for r in ring_paged if r["kv_dtype"] == "fp")["combine"]
    # the training path runs the backward in fp32 at 4096 causal tokens
    main_bwd = next(r for r in bwd if r["case"] == "causal" and r["S"] == 4096
                    and r["dtype"] == "fp32" and r["heads"] == granite)
    kernels = []
    for name, key, src, replaces, rec in (
        ("flash_attention_fwd", "flash_attention_fwd (tile)", FLASH_TC_SRC, FLASH_REPLACES,
         main_flash),
        ("flash_attention_fwd (decode body)", "flash_attention_fwd (decode)", FLASH_TC_SRC,
         FLASH_REPLACES, main_flash_decode),
        ("flash_attention_fwd (fp32: tile and decode bodies, two bf16 terms)",
         "flash_attention_fwd (fp32)", FLASH_TC_SRC, FLASH_REPLACES, main_flash_fp32),
        ("paged_flash_decode", "paged_flash_decode", PAGED_SRC, PAGED_REPLACES, main_paged),
        ("paged_flash_decode (quantized branch)", "paged_flash_decode_quant", PAGED_SRC,
         QUANT_REPLACES, main_quant),
        ("ssd_scan_fwd", "ssd_scan_fwd", SSD_SRC, SSD_REPLACES, main_ssd),
        ("ssd_scan_fwd (training split)", "ssd_scan_fwd (training)", SSD_SRC, SSD_REPLACES,
         main_ssd_train),
        ("ssd_scan_bwd", "ssd_scan_bwd", SSD_BWD_SRC, SSD_BWD_REPLACES, main_ssd_bwd),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    # plain_ms and library_ms of the backward pair are the pair's: both the
    # plain backward and the SDPA backward compute dq, dk and dv together
    for name, replaces, part, err in (
        ("flash_bwd_dq", BWD_DQ_REPLACES, "dq", main_bwd["max_abs_err"]["dq"]),
        ("flash_bwd_dkv", BWD_DKV_REPLACES, "dkv",
         max(main_bwd["max_abs_err"]["dk"], main_bwd["max_abs_err"]["dv"])),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SRC, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": main_bwd[f"ms_{part}"],
            "plain_ms": main_bwd["plain_ms_pair"], "bound_ms": main_bwd[f"bound_ms_{part}"],
            "bound_by": main_bwd[f"bound_by_{part}"],
            "library_ms": main_bwd["library_ms_pair"],
        })
    # #2 and #3 at head dim 256, counted over train_gemma, timed at its row
    # (fp32, causal, 4096)
    gemma_bwd = next(r for r in bwd if r["case"] == "causal" and r["S"] == 4096
                     and r["dtype"] == "fp32" and r["heads"] == list(GEMMA_HEADS))
    for name, replaces, part, err in (
        ("flash_bwd_dq (head dim 256)", BWD_DQ_REPLACES, "dq", gemma_bwd["max_abs_err"]["dq"]),
        ("flash_bwd_dkv (head dim 256)", BWD_DKV_REPLACES, "dkv",
         max(gemma_bwd["max_abs_err"]["dk"], gemma_bwd["max_abs_err"]["dv"])),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SRC, "replaces": replaces,
            "launches": gemma_train[f"flash_bwd_{part}"], "max_abs_err": err,
            "ms": gemma_bwd[f"ms_{part}"], "plain_ms": gemma_bwd["plain_ms_pair"],
            "bound_ms": gemma_bwd[f"bound_ms_{part}"], "bound_by": gemma_bwd[f"bound_by_{part}"],
            "library_ms": gemma_bwd["library_ms_pair"],
        })
    # #2 and #3 at head dim 96 (MLA's expanded heads), counted over
    # train_minicpm, timed at its row (fp32, causal, 4096)
    mla_bwd = next(r for r in bwd if r["case"] == "causal" and r["S"] == 4096
                   and r["dtype"] == "fp32" and r["heads"] == list(MLA_PREFILL_HEADS))
    for name, replaces, part, err in (
        ("flash_bwd_dq (head dim 96)", BWD_DQ_REPLACES, "dq", mla_bwd["max_abs_err"]["dq"]),
        ("flash_bwd_dkv (head dim 96)", BWD_DKV_REPLACES, "dkv",
         max(mla_bwd["max_abs_err"]["dk"], mla_bwd["max_abs_err"]["dv"])),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SRC, "replaces": replaces,
            "launches": minicpm_train[f"flash_bwd_{part}"], "max_abs_err": err,
            "ms": mla_bwd[f"ms_{part}"], "plain_ms": mla_bwd["plain_ms_pair"],
            "bound_ms": mla_bwd[f"bound_ms_{part}"], "bound_by": mla_bwd[f"bound_by_{part}"],
            "library_ms": mla_bwd["library_ms_pair"],
        })
    # the head-dim-256 instantiations (gemma-7b), counted over serve_gemma:
    # the bf16 tile body of its prefills, the fp32 bodies of its int8 pool's
    # chunks and verifies, #4 and 4q of its decode ticks
    gemma = list(GEMMA_HEADS)
    for name, key, src, replaces, rec in (
        ("flash_attention_fwd (head dim 256: tile body)", "flash_attention_fwd (tile)",
         FLASH_TC_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "causal" and r["S"] == 2048
              and r["dtype"] == "bf16" and r["heads"] == gemma)),
        ("flash_attention_fwd (head dim 256: fp32 bodies)", "flash_attention_fwd (fp32)",
         FLASH_TC_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "chunk" and r["dtype"] == "fp32"
              and r["heads"] == gemma)),
        ("paged_flash_decode (head dim 256)", "paged_flash_decode", PAGED_SRC, PAGED_REPLACES,
         next(r for r in paged if r["dtype"] == "bf16" and r["heads"] == gemma)),
        ("paged_flash_decode (quantized branch, head dim 256)", "paged_flash_decode_quant",
         PAGED_SRC, QUANT_REPLACES,
         next(r for r in quant if r["kv_dtype"] == "int8" and r["heads"] == gemma)),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": gemma_launches[key], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    # minicpm3-4b's MLA, counted over serve_minicpm: #1's bf16 tile body at
    # head dim 96 (its prefills), its fp32 tile body at 288 (the int8 pool's
    # chunks and verifies over the latent), #4 and 4q at 288, group 40 (its
    # decode ticks), each timed at that run's row
    latent = list(MLA_LATENT_HEADS)
    for name, key, src, replaces, rec in (
        ("flash_attention_fwd (head dim 96: tile body, MLA prefill)",
         "flash_attention_fwd (tile)", FLASH_MLA_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "causal" and r["dtype"] == "bf16"
              and r["heads"] == list(MLA_PREFILL_HEADS))),
        ("flash_attention_fwd (head dim 288: fp32 tile body, MLA chunks and verifies)",
         "flash_attention_fwd (fp32)", FLASH_MLA_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "chunk" and r["dtype"] == "fp32"
              and r["heads"] == latent)),
        ("paged_flash_decode (head dim 288, group 40)", "paged_flash_decode", PAGED_SRC,
         PAGED_REPLACES, next(r for r in paged if r["dtype"] == "bf16" and r["heads"] == latent)),
        ("paged_flash_decode (quantized branch, head dim 288, group 40)",
         "paged_flash_decode_quant", PAGED_SRC, QUANT_REPLACES,
         next(r for r in quant if r["kv_dtype"] == "int8" and r["dtype"] == "bf16"
              and r["heads"] == latent)),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": minicpm_launches[key], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    # whisper-base's bands (8 / 8 heads of 64): #1 counted over serve_whisper
    # (the encoder and cross-attention prefill on the tile body, timed at the
    # encoder's row; cross- and self-attention decode on the decode body,
    # timed at the cross-attention decode row), #2 / #3 over train_whisper
    # (timed at the cross band, 448 x 1536, fp32)
    wh = list(WHISPER_HEADS)
    for name, count, src, replaces, rec in (
        ("flash_attention_fwd (whisper-base: non-causal encoder and cross-attention, tile body)",
         whisper_launches["flash_attention_fwd (tile)"], FLASH_TC_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "full" and r["dtype"] == "bf16"
              and r["heads"] == wh)),
        ("flash_attention_fwd (whisper-base: cross- and self-attention decode, decode body)",
         whisper_launches["flash_attention_fwd (decode)"], FLASH_TC_SRC, FLASH_REPLACES,
         next(r for r in flash if r["case"] == "cross_decode" and r["dtype"] == "bf16"
              and r["heads"] == wh)),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    whisper_bwd = next(r for r in bwd if r["case"] == "full" and r["Sq"] == WHISPER_MAX_SEQ
                       and r["dtype"] == "fp32" and r["heads"] == wh)
    for name, replaces, part, err in (
        ("flash_bwd_dq (whisper-base: encoder and cross bands)", BWD_DQ_REPLACES, "dq",
         whisper_bwd["max_abs_err"]["dq"]),
        ("flash_bwd_dkv (whisper-base: encoder and cross bands)", BWD_DKV_REPLACES, "dkv",
         max(whisper_bwd["max_abs_err"]["dk"], whisper_bwd["max_abs_err"]["dv"])),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SRC, "replaces": replaces,
            "launches": whisper_train[f"flash_bwd_{part}"], "max_abs_err": err,
            "ms": whisper_bwd[f"ms_{part}"], "plain_ms": whisper_bwd["plain_ms_pair"],
            "bound_ms": whisper_bwd[f"bound_ms_{part}"],
            "bound_by": whisper_bwd[f"bound_by_{part}"],
            "library_ms": whisper_bwd["library_ms_pair"],
        })
    kernels.append({
        "name": "paged_decode_combine (the ring's lse combine)", "route": "cuda",
        "source": PAGED_SRC, "replaces": PAGED_REPLACES,
        "launches": ring["paged_decode_combine"] + ssm_ring["paged_decode_combine"]
        + mla_ring["paged_decode_combine"],
        "max_abs_err": ring_combine["max_abs_err"],
        "ms": ring_combine["ms"], "plain_ms": ring_combine["plain_ms"],
        "bound_ms": ring_combine["bound_ms"], "bound_by": ring_combine["bound_by"],
        "library_ms": None,
    })
    # the fp32 body's pre-pass: part of #2 and #3 on the training path
    kernels.append({
        "name": "flash_bwd_split (fp32 pre-pass of #2, #3)", "route": "cuda", "source": BWD_SRC,
        "replaces": f"{BWD_DQ_REPLACES}, {BWD_DKV_REPLACES}", "launches": launches["flash_bwd_split"],
        "max_abs_err": split["max_abs_err"], "ms": split["device_ms"], "plain_ms": split["plain_ms"],
        "bound_ms": split["bound_ms"], "bound_by": split["bound_by"], "library_ms": None,
    })
    # the fp32 forward's pre-pass: part of #1 on the fp32 paths, summed over
    # the same main-path runs as the fp32 forward's row, one launch each
    check(launches["flash_fwd_split"] == launches["flash_attention_fwd (fp32)"],
          f"the fp32 forward's pre-pass ran {launches['flash_fwd_split']} times on the main "
          f"paths, not once per fp32 forward launch ({launches['flash_attention_fwd (fp32)']})")
    kernels.append({
        "name": "flash_fwd_split (fp32 pre-pass of #1)", "route": "cuda", "source": FLASH_TC_SRC,
        "replaces": FLASH_REPLACES, "launches": launches["flash_fwd_split"],
        "max_abs_err": fwd_split["max_abs_err"], "ms": fwd_split["device_ms"],
        "plain_ms": fwd_split["plain_ms"], "bound_ms": fwd_split["bound_ms"],
        "bound_by": fwd_split["bound_by"], "library_ms": None,
    })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
