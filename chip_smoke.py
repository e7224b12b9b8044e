#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, serve, int8
weights, train (on one device and on a (data, model) mesh), offload,
xLSTM, head dims 80 and 96, the mixture-of-experts block (served,
trained, expert-parallel and at tp=2), the Mamba layer (hymba), the
encoder-decoder (whisper), M-RoPE and the vision stub (qwen2-vl), the
recurrent cells and the encoder-decoder trained on a (data, model)
mesh, the int8 error-feedback all-reduce, GPipe, the first roofline
readings, dense decode with the cache sharded along its sequence over a
(data, model) mesh, dense decode on that mesh for every other block
kind (hymba, the mLSTM and sLSTM, the encoder-decoder, MoE), and the dry
run beside one rank of three production cells run at full size.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository's
``src/repro_torch`` package; it imports nothing of JAX.  Phases, each of
which raises on failure (the script then exits non-zero):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port from ``src/repro_torch/**/csrc``; the
   ``-Xptxas -v`` log must show no spills in the tensor-core (``*_wgmma``)
   kernels and the dense decode kernel (``flash_decode_*``), and no
   serialized ``wgmma``.
2. Each kernel against its plain PyTorch version on the card, with the
   maximum absolute error held to a stated tolerance (the attention
   checks also hold each output row's error to that row's scale): the
   paged kernels at the shapes of llama2-7b's and gemma2-2b's serving
   path and at page size 16 in float32, qwen2.5-32b's GQA 40/8 at page
   size 16 in bf16 (ragged chunks, a padded row), paged prefill at the
   speculative verify shape (``VERIFY_CASE``: B=8 rows of a 5-token chunk
   at pos_start 37-1900 of a 2048-token table, n_valid 5 down to 0), both
   at one rank's shape of phase 3e (a) (llama2-7b at tp=2: 16/16 heads,
   8 rows, with its own split-KV plan and its split edges), and paged
   decode at its
   split-KV edges (``DECODE_CASES``: kv_len one below, at and one above a
   split, a window narrower than the table, 4096 keys in one sequence,
   only idle rows); ``fastattn_fwd`` at llama2-7b's training shape, a
   gemma2-2b band (GQA, window, softcap), a ragged case with a q_offset
   and a kv_valid tail in float32 and in bf16, a non-causal case, and
   phase 4b's context-parallel shape (``CONTEXT_CASES``: a rank's
   2 x 1024 query rows against 2048 keys at q_offset 0 and 1024, SDPA
   with ``causal_lower_right`` for m=1);
   ``flash_decode`` on dense caches (``DENSE_DECODE_CASES``, every
   (batch, head) row to its own scale) at llama2-7b's decode shape in both
   layouts, a gemma2-2b window/softcap case, a float32 case, llama2-7b
   at B=1 on a 65536-token cache (the kernels line's long shape) and on
   the paper's longest, 262144 tokens, qwen2.5-32b's GQA 40/8 at B=2 on
   32768 tokens, and its split-KV edges (kv_len one below, at and one
   above a split; a window narrower than a split); ``flash_decode`` on a
   context-parallel rank's slice with its log-sum-exp
   (``CP_SLICE_CASES``: llama2-7b's 32/32 at B=4 on the second 16,384
   rows of a 32,768-position cache at kv_len 1,000, 16,390 and 32,768,
   gemma2-2b's D=256 GQA 8/4 softcap 50 with window 4,096 emptying slice
   0 and cutting slice 1; out float32 (the partial the ranks' merge
   reads unrounded) within the float32 tolerance per row, the lse
   within LSE_TOL, a row with no valid key exactly 0 and NEG_INF in both,
   SDPA on the slice with a boolean mask beside it; and phase 15's head
   shapes on a rank's second slice: hymba's 25/5 at D=64 with its window
   of 1,024, qwen3-moe's GQA 32/4, whisper's 12/12);
   ``mlstm_chunkwise_fwd``
   (``MLSTM_CASES``) at xlstm-125m's training shape (the model's
   (B, S, H, D) projections read in place), a ragged float32 case, a
   sequence shorter than the chunk, 16 chunks at a small dk/dv, a ragged
   S over eight chunks and a forget bias of -2, h held to the plain
   version as an unbounded output and the float32 state (C, n, m) to 1e-3
   of its scale; and the four attention kernels at head dims 80
   (stablelm-3b) and 96 (phi3-mini-3.8b), phase 7's models, in bf16 and
   float32 (``HEAD_DIM_ARCHS``, ``head_dim_case``): paged decode at B=8,
   32/32 heads, 16 pages of 128, its split edges (D=80) and a GQA group
   of 4 (D=96); paged prefill at chunk 512 and a ragged 100-token chunk
   with a padded row; ``fastattn_fwd`` at B=4, S=2048 causal and a ragged
   float32 case with a q_offset and a kv_valid tail; ``flash_decode`` at
   B=8, kv_len 159 in both layouts and at B=1 on 65536 tokens; and the
   four in bf16 at qwen3-moe-30b-a3b's 32/4 heads of 128, phase 8's
   model (``gqa8_case``: a GQA group of 8, every row of the kernels'
   8-row instances): paged decode at B=8 on 16 pages of 128, paged
   prefill of 8 rows of 512 with ragged and padded rows, ``fastattn_fwd``
   at 1 x 2048 causal, ``flash_decode`` at B=8, kv_len 159; and
   ``fastattn_fwd`` and ``flash_decode`` at hymba-1.5b's 25/5 heads of
   64 with its window of 1024, phase 9's model (``hymba_case``): the
   forward at 8 x 2048 causal with and without the window and a ragged
   float32 case with the window, dense decode at B=8, kv_len 159 in both
   layouts and at B=1 on 4096 keys with the window; and both at
   whisper-small's 12/12 heads of 64, phase 10's model
   (``whisper_case``): ``fastattn_fwd`` non-causal at B=8 on 1500 keys
   with 1500 (the encoder), 448 (the decoder's cross-attention) and 1
   (a decode step's) query rows, ``flash_decode`` at B=8 on a 512-slot
   cache at kv_len 64 and at a ragged kv_len a row; and the four in bf16
   at qwen2-vl-72b's 64/8 heads of 128, phase 11's model (``vl_case``:
   GQA 8 at twice qwen3-moe's heads): paged decode at B=8 on 16 pages of
   128, paged prefill of 8 rows of 512, ``fastattn_fwd`` at 1 x 2048
   causal, ``flash_decode`` at B=8, kv_len 159; and at a phase 12
   rank's shapes, ``mlstm_chunkwise_fwd`` at B=2, 2 heads, S=1024,
   dk=dv=384 and ``fastattn_fwd`` non-causal at B=2, 12/12 heads, 750
   query rows at q_offset 750 against 1500 keys.  Each is
   timed (median of 20 launches, CUDA events
   around each: the wrapper's host work included) and on the device
   alone (``device_ms``: 20 launches queued behind a spin kernel) beside
   the least time the card could take (its bound), the plain version's
   time and, where one PyTorch call computes the same function, that
   call's time (``library_ms``: ``scaled_dot_product_attention``, with a
   gather, GQA expansion or layout copy excluded from the time -- with no
   mask where every key is visible, and for whisper's decode cases on
   the first kv_len keys or a jagged batch of each row's keys; the port
   never calls it), its achieved TFLOP/s on this data's useful operations
   and its time over ``library_ms``.
3. Serving: an ``EngineCore`` on llama2-7b at full width and depth (bf16,
   random weights from a seeded CUDA generator) answers 12 greedy
   requests of 37-1800 prompt tokens with 32 new tokens each.  Both
   paged kernels' launch counts must be above 0, no page may leak, and
   the first request's first chunk and one decode step must agree with
   the plain attention path within a stated tolerance.
3b. Dense generation, on phase 3's model before it is freed:
   ``ServeEngine.generate`` of 8 prompts of 128 tokens (numpy seed 0), 32
   greedy new tokens, dense KV caches through ``flash_decode``, which must
   launch exactly 32 layers x (128 + 31) steps; the paged ``EngineCore``
   must give the same greedy tokens wherever the top-1 margin exceeds the
   phase 3 tolerance, and kernel and plain ``decode_step`` logits must
   agree within it at positions 0-3 and 36-39.  ``flash_decode`` is held
   to its plain version on generate's own caches (B=8, kv_len 159) and
   timed there: those are the kernels line's numbers for it.
3c. One long-context decode step, on phase 3's model before it is
   freed: ``LM.decode_step`` at B=1 on a 65537-token dense cache (34.4
   GB; every layer's K/V seeded at the RMS of 3b's) at kv_len 65536,
   through ``flash_decode`` (exactly 32 launches) and the plain attention
   path, logits within the phase 3 tolerance; the step's wall time
   (median of 10), its device time and ``flash_decode``'s share of it
   (one profiled step).
3d. The rest of the paged engine, on phase 3's model cut to its first
   16 of 32 layers (``FEATURE_LAYERS``, the cut that pays for phase 8
   (g)-(i)) after 3c freed its cache (``phase_features``), each run
   against the same traffic with
   the feature off (the reference run records the top-1 margin of every
   token it takes; tokens must be equal up to the first position whose
   margin is under the phase 3 tolerance), with both paged kernels'
   launch counts set to 0 just before each run and read just after it,
   and no page or host stash left behind: (a) the prefix cache, 8
   requests of one 1024-token system prompt plus 64-448 tokens in two
   waves, 32 new each: prefix hits, and the warm wave prefilling at least
   the system prompt fewer tokens a request; (b) a pool at 60% of the
   worst-case demand of 8 requests of 1200-1800 tokens with 128 new each,
   the host stash capped at 48 pages, under preempt_policy swap,
   recompute and auto: preemptions in each, swap bytes in == out; (c)
   speculation (4 drafted tokens) on 8 tiled-motif prompts of 256 tokens,
   64 new each: verify launches and drafted tokens, the first verify
   launch (and the first with every slot in it) held to the same launch
   through the plain attention path, and paged_prefill's launches beyond
   the prefill's exactly one a layer a verify launch; (d) (a)+(b)+(c)
   together with every fault site armed once (``FAULT_CALLS``): every
   failed request names a fault of the injector's log, every fault at a
   request's site failed one, the survivors' and the fault-free run's
   tokens equal the all-off run's, and the fault-free run fails nothing;
   (e) one 128-token prompt through the scan prefill oracle (a decode
   step a prompt token, no prefill launch) against the chunked prefill.
3e. Tensor-parallel serving (``phase_tp``), after 3d: (a) phase 3's 12
   requests on phase 3's llama2-7b cut to its first 8 of 32 layers
   (``TP_LAYERS``, the cut that pays for phases 12 and 15) at tp=2 (g=2,
   s=1) as
   two ranks of ``launch.mesh.spawn_ranks``, the weights shared by CUDA
   IPC and each
   rank keeping its slices, under the tiled and the single all-reduce;
   with one GPU both ranks share cuda:0 over gloo, which stages every
   collective through the host (its times are no TP speed), with
   several one GPU a rank over NCCL.  Its reference is phase 3's engine
   on the same traffic at tp=1 at the same depth, run again here to
   record its top-1 margins and first prefill logits (phase 3's timed
   run records nothing).  Gates: every rank's streams equal, equal to the
   reference's under its margins, the first prefill launch's logits
   within the phase 3 tolerance of the reference's, both paged
   kernels launched on every rank exactly 16 times a prefill or decode
   launch, no page left, ``stats()["tp"]`` the plan.  (b) Reduced
   gemma2-2b at tp=4 (g=2, s=2: the LSE merge over page-row sub-shards on
   CUDA tensors) against its own tp=1 run (plain paged attention: the
   kernels take no head dim 16), three requests under each mode and an
   oversubscribed pool under swap.  The ring and reduce-scatter variants
   run only under NCCL (gloo has no CUDA send/recv or reduce-scatter).
3f. Int8 weights (``phase_int8``), on phase 3's llama2-7b at full width
   and depth after 3e: ``quant.int8.quantize_tree`` on the card in both
   of the JAX tree's layouts (``scan_layers`` True: one scale a channel
   for the 32 stacked layers, norm scales quantized; False: a layer's
   own), dequantized to bf16; ``LM.apply`` on 2 x 512 tokens with the
   bf16 weights and with each dequantized tree, ``fastattn_fwd`` exactly
   32 launches a run.  Gates, JAX's own (``tests/test_quant.py``): the
   logits' drift under 0.15 of the bf16 logits' scale, the greedy tokens
   equal at every decisive position (top-1 margin over twice the largest
   error), agreement over 0.8, and ``quantized_size_bytes`` under 0.6 of
   the bf16 tree's; JAX's share of decisive positions (> 0.1) is read,
   not gated: random weights at full width have too few (``INT8_*``).
4. Training: with phase 3's model freed, the trainer's own functions
   (``init_train_state``, ``make_train_step``, ``TokenPipeline``,
   ``CheckpointManager``, as ``repro_torch.launch.train`` calls them) take
   5 AdamW steps of llama2-7b at full width, cut to 4 layers, on batches
   of 4 x 2048 tokens.  Every loss must be finite, ``fastattn_fwd`` must
   have launched once per layer and forward pass (twice per layer and
   step under remat), a checkpoint must round-trip params and optimizer
   state bit for bit, and on one 1 x 2048 batch the kernel path's loss
   and gradient norm must agree with the plain attention path's within
   1% and 5%.  One more step is traced with ``torch.profiler`` for the
   share of the step's device time in ``fastattn_fwd``.
4b. Data- and model-parallel training (``phase_dist_training``), after
   phase 4: phase 4's model, seed, batches and TrainConfig at
   ``ParallelConfig(data=2, model=2, remat="selective")``, four ranks of
   ``launch.mesh.spawn_ranks`` on the one card over gloo (NCCL with a GPU
   a rank where there are four), each drawing the whole tree and keeping
   its pieces under the logical-axis rules, for the first ``DIST_STEPS``
   (3) of phase 4's steps.  Gates: the ranks' loss, grad norm and lr
   equal; each step's loss within 1% and grad norm within 2% of phase
   4's, lr exact; each leaf's update within 15% of phase 4's (norm of
   the difference over the norm of one device's; leaves one device left
   unchanged unchanged); ``fastattn_fwd.cu`` 4 layers x 2 x 3 launches a
   rank, all at its q_offset (0, 1024); each rank's initial pieces phase
   4's slices for its coordinate, a sharded leaf half the whole; the
   (2, 2) checkpoint, gathered whole and written by rank 0, holding
   file for file what a one-rank save of the state gathered again writes
   (each array bit for bit, the manifest but for its time; read back
   and compared, no second file written); restored at
   (1, 2), each rank's every leaf (params, AdamW's moments, step) its
   slice of that checkpoint and the next step's loss within 1e-3 of
   (2, 2)'s; and
   ``python -m repro_torch.launch.train --arch llama2-7b --smoke --steps 2
   --data 2 --model-axis 2`` (run beside the restore) ends cleanly.
   Prints each rank's step wall, collectives a step and their bytes,
   peak memory, backend and device, and the leaves whose step-0 gradient
   norms differ most from phase 4's.  gloo stages every collective
   through the host: no number of it is a parallel speed.
5. Cooperative offload (paper §4.4), after phase 4: ``plan_offload`` and
   ``max_context_length`` for llama2-7b on one 80 GB card, then one
   layer's decode attention at B=1, S=65536 with the KV on the host
   (``HostOffloadEngine``: Q down, host attention, output up) against
   classical offloading (upload the layer's bf16 KV from pinned memory,
   then ``flash_decode``), outputs held to each other per query head,
   times (the kernel's also on the device alone), the
   measured pinned copy rate and host GFLOP/s, and ``table3_row`` under
   those constants.  The host KV is f32 (twice the upload's bytes), so
   host attention is also timed once over the pinned bf16 copy.
6. xlstm-125m at full width and depth (12 layers: 10 mLSTM blocks on
   ``mlstm_chunkwise.cu``, 2 sLSTM blocks; random weights from a seeded
   CUDA generator), after phase 5.  (a) ``LM.apply`` on 8 x 2048 tokens
   through the kernel: exactly 10 launches, finite logits, and every
   mlstm block held on the inputs this run gave it -- its output and its
   input and weight gradients to the plain version's, and the recurrent
   cells' output over the first 128 positions to the kernel's -- within
   one bf16 ulp.  End to end this random-weight bf16 model is
   ill-conditioned, so the logits of the kernel and plain paths are
   compared beside the plain path against itself with one bf16 ulp
   added to 1% of every mlstm h (``_perturbed_h``), and held to
   max(5%, twice that).  (c) ``ServeEngine.generate`` of 8 prompts of 128
   tokens (the first 128 of (a)'s), 32 greedy new tokens through the
   recurrent cells (no kernel launch), its teacher-forced logits at the
   last prompt position held to (a)'s the same way, and one profiled
   decode step.  (b) The trainer's functions take 3 AdamW steps of
   8 x 512 tokens (``XLSTM_TRAIN_SEQ``) on the first 3 layers (mlstm,
   mlstm, slstm: ``XLSTM_TRAIN_LAYERS``; both are cuts for the time
   limit): finite losses, exactly 2 x 2 (remat) x 3 launches, a
   bit-exact checkpoint; on one batch the kernel path's loss within 1% of
   the plain path's and its gradient norm within a factor of 2 (both
   paths also measured under two perturbations of h); one profiled step
   and one sLSTM block's forward and backward timed alone.

7. Head dims 80 and 96, after phase 6 (``phase_head_dims``):
   stablelm-3b (D=80, LayerNorm) and phi3-mini-3.8b (D=96) at full width
   and their first 16 of 32 layers (``HEAD_DIM_LAYERS``, a cut for the
   time limit), bf16, random weights from a seeded CUDA generator, each
   freed before the next.  (a) Phase 3's serving on phase 3's engine and
   traffic: each paged kernel exactly one launch a layer a prefill launch
   or decode step, no page left, the first chunk and one decode step
   within the phase 3 tolerance of the plain path; (b) phase 3b's dense
   generation: ``flash_decode`` exactly 16 x 159 launches, greedy tokens
   equal the paged engine's under the margin rule, ``flash_decode`` held
   to its plain version on generate's caches; (c) ``LM.apply`` on
   1 x 2048 tokens: exactly 16 ``fastattn_fwd`` launches, logits within
   the phase 3 tolerance of the plain path's.
8. The mixture-of-experts block, after phase 7 (``phase_moe``):
   qwen3-moe-30b-a3b (48 MoE blocks of 128 experts top-8, 32/4 heads of
   128; 30.53 B parameters, 61 GB) at full width, its first 16 of 48
   layers (``MOE_LAYERS``, a cut for the time limit), bf16, random
   weights from a seeded CUDA generator.  Gate G bounds every logits
   comparison: LOGIT_TOL or twice the plain path's own change when one
   ulp moves 1% of the first block's router inputs, whichever is larger
   (``gate_g``, ``router_sensitivity``).  (a) Phase 3's serving: each
   paged kernel exactly one launch a layer a prefill launch or decode
   step, no page left, the first chunk and a decode step within G, the
   share of valid assignments each prefill launch drops by capacity;
   (b) phase 3b's generate: ``flash_decode`` exactly 16 x 159 launches,
   no assignment dropped in generate or in the paged engine (the same
   weights at capacity factor ``NO_DROP_CF``), greedy tokens equal under
   the margin rule with G's bound, decode_step logits within G; (c)
   ``LM.apply`` on 1 x 2048: exactly 16 ``fastattn_fwd`` launches, logits
   within G; (d) one prefill launch of 8 x 512 twice on the same pools,
   every valid row's logits the same bits; (e) each block on (c)'s own
   inputs through the kernels and the plain path: the rows whose top-8
   set and kept experts agree held to it, each row within twice what one
   ulp on half the plain attention output does or the unbounded bf16
   gate, the share of tokens routed otherwise recorded per layer; (f) a
   B=8 decode step and the 8 x 512 prefill launch timed (wall, one
   profiled run's device time, idle share, largest kernels) against
   their bounds.  Peak memory below 80 GB.  Then, with the 16-layer
   model freed (``phase_moe_parallel``), on random weights from seed 0
   at full width: (g) 3 AdamW steps of its first 2 layers
   (``MOE_TRAIN_LAYERS``, 1.87 B parameters) at 2 x 2048, remat full,
   capacity factor 1.25, each step's drop share printed: step 0's loss
   within LOSS_RTOL and grad norm within GNORM_RTOL of the plain path's,
   ``fastattn_fwd`` exactly 2 x 2 x 3 launches, finite losses, peak
   memory below 80 GB; (h) (g)'s weights and first 2 steps at (data=2,
   model=2), four gloo ranks on the card, the experts sharded over the
   model axis (expert parallelism): each rank's expert leaves its 64
   experts and every piece its rule-table slice of (g)'s draw, the
   ranks' loss, grad norm and lr equal, each step within phase 4b's
   DIST_LOSS_RTOL / DIST_GNORM_RTOL of (g)'s, each leaf's update within
   DIST_DELTA_RTOL of (g)'s (summed over the ranks' pieces),
   ``fastattn_fwd`` 2 x 2 x 2 a rank at its q_offset, the collectives'
   counts and bytes printed (correctness only: gloo stages every
   collective through the host); (i) its first 4 layers (3.1 B
   parameters) serving phase 3's 12 requests at tp=2 (g=2, s=1) through
   phase 3e's harness, tiled: the ranks' streams exactly equal, equal to
   a tp=1 run of the same model on the card under the margin rule, each
   paged kernel exactly 4 launches a prefill launch or decode step on
   every rank, every rank holding all 128 experts of every layer, no
   page left.
9. The Mamba layer, after phase 8 (``phase_hymba``): hymba-1.5b (32
   blocks of parallel attention and Mamba heads, 25/5 heads of 64,
   window 1024 on 29 layers, 1.42 B parameters) at full width, its first
   16 layers (``HYMBA_LAYERS``: global at 0 and 15; a cut for the time
   limit), bf16, random weights from a seeded CUDA generator; the formula's and
   the tensors' parameter counts logged.  The logits gate comes from
   the plain path's own change with one ulp on 1% of block 0's inputs:
   LOGIT_TOL where that is at most half of it, else gate G's rule
   (``hymba_gate``).  (a) ``LM.apply`` on 8 x 2048 through
   ``fastattn_fwd``, exactly 16 launches, logits held to the plain path
   (under G, if even G fails, each block to its plain version on its
   own inputs); (b) ``ServeEngine.generate`` of (a)'s first 128 tokens
   of each row, 32 greedy new tokens through ``flash_decode``, exactly
   16 x 159 launches, the decode logits at DENSE_CHECK_POS held to (a)'s
   (the recurrence against the chunked scan), those at the generated
   positions and the greedy tokens (the margin rule) to the plain path's
   LM.apply on the same tokens and to its decode_step teacher-forced on
   them from the prompt's caches, no kernel launched in either; (c) one
   sequence of 1100 tokens and 8 new on the first 4 layers (layer 0
   global, 1-3 with the window), decode past the window, exactly 4 x 1107
   launches, the decode logits from position 1024 held to LM.apply's on
   the 1108 tokens; (e) a B=8 decode step and LM.apply on 2 of (a)'s rows
   profiled: wall, device time, idle share, the Mamba scan's share; (d)
   3 AdamW steps at
   2 x 2048 (remat), finite, exactly 16 x 2 x 3 launches, step 0's loss
   and grad norm within LOSS_RTOL and GNORM_RTOL of the plain path's.
10. The encoder-decoder, after phase 9 (``phase_whisper``):
   whisper-small (12 encoder and 12 decoder layers, d_model 768, 12/12
   heads of 64, d_ff 3072, vocab 51,865, 1500 frames; 239,850,240
   parameters in the tensors, the formula's count logged beside) at full
   width and depth, bf16, random weights from a seeded CUDA generator,
   N(0, 1) float32 frames from a seeded generator, 448 decoder tokens
   (whisper's text context).  The logits gate comes from the plain
   path's own change with one ulp on 1% of the encoder's inputs, by
   phase 9's rule.  (a) ``EncDec.apply`` on 8 x (1500, 448): exactly 36
   ``fastattn_fwd`` launches (12 encoder, 12 causal self-attention, 12
   cross), logits held to the plain path, ``encode`` timed alone; (b) the
   transcription loop (``encode``, ``init_cache`` with the encoder
   states, 4 prompt tokens teacher-forced and 60 greedy ones through
   ``decode_step``): ``flash_decode`` exactly 12 x 64, ``fastattn_fwd``
   12 + 12 x 64, each step's logits held to ``EncDec.apply`` on the same
   tokens, the greedy tokens to a plain run under the margin rule; (c)
   ``ServeEngine.generate`` of 8 x (4 + 16) over the zero cross cache,
   each kernel exactly 12 x 19, the tokens held to the plain engine's;
   (e) an ``encode`` and a B=8 decode step profiled: wall, device time,
   idle share, each kernel's device time and launches; (d) 3 AdamW steps
   at 8 x (1500, 448) (remat): finite, exactly 36 x 2 x 3 launches, step
   0's loss and grad norm within LOSS_RTOL and GNORM_RTOL of the plain
   path's, peak memory.  Every plain run launches neither kernel.
11. M-RoPE and the vision stub, after phase 10 (``phase_vl``):
   qwen2-vl-72b (64/8 heads of 128, d_model 8192, d_ff 29568, vocab
   152,064, qkv bias, M-RoPE sections (16, 24, 24)) at full width cut to
   its first 16 of 80 layers (``VL_LAYERS``: 16,601,497,600 parameters,
   33.2 GB), bf16, random weights from a seeded CUDA generator; on cuda
   or the phase fails.  The gate comes from the plain path's own change
   with one ulp on 1% of block 0's inputs, by phase 9's rule.  (a) The
   vision ``LM.apply`` on 1 x 2048 N(0, 1) patch and token embeddings
   through the frontend: 64 text tokens, a 32 x 48 image (1536 patches at
   t = 64, h = 64 + r, w = 64 + c), 448 text tokens from 112
   (``vl_positions``, Qwen2-VL's layout): exactly 16 ``fastattn_fwd``
   launches, logits held to the plain path; how far they move at
   t = h = w = index positions logged.  (b) Phase 3's serving: each paged
   kernel exactly 16 launches a prefill launch or decode step, no page
   left (``serve_gate``).  (c) Phase 3b's generate 8 x (128 + 32):
   ``flash_decode`` exactly 16 x 159, tokens equal (b)'s engine's under
   the margin rule.  (e) A B=8 decode step profiled: device time, idle
   share, launches, beside its byte bound.  (d) Three AdamW steps on the
   first 2 layers (4,313,911,296 parameters) at 1 x 2048 on vision
   batches with the image's labels masked (``vl_batch``): 2 x 2 x 3
   ``fastattn_fwd`` launches, step 0's loss and grad norm within
   LOSS_RTOL and GNORM_RTOL of the plain path's, peak memory under 80 GB.
12. The model axis over the recurrent cells and the encoder-decoder,
   after phase 11 (``phase_mesh``): xlstm-125m's first 3 layers (mlstm,
   mlstm, slstm) and hymba-1.5b's first 2 (global, windowed) at 4 x
   1024, whisper-small's 2 encoder and 2 decoder layers at 4 x (1500
   frames, 448 tokens), full width, bf16, random weights from seed 0
   (``MESH_MODELS``): each model's 2 AdamW steps (remat) on one device
   (``mesh_reference``), then one spawn of four gloo ranks at (data=2,
   model=2) on the card runs the three in turn (``_mesh_models_rank``):
   the mLSTM and sLSTM heads and hymba's Mamba channels over the model
   axis (a rank's 2 of 4 heads, 800 of 1600 channels), whisper's frames
   and tokens split over it.  Phase 4b's gates against each one-device
   run (the ranks' loss, grad norm and lr equal, each step within 1% /
   2%, lr exact, each leaf's update within 0.15, the initial pieces the
   rule table's slices, the sharded leaves half the whole) and each
   leaf's step-0 gradient within MESH_GRAD_RTOL = 0.15 of one device's
   (a dropped leaf reads 1.0); xlstm-125m's bounds past step 0's loss
   and grad norm twice what one bf16 ulp on 1% of every mlstm h does to
   its one-device run where that is larger, printed beside them, its
   gradient bound under MESH_GRAD_CAP = 0.75; and each rank's launches
   exactly: ``mlstm_chunkwise`` 2 x 2 x 2 at 2 heads,
   ``fastattn_fwd`` hymba 2 x 2 x 2 at the rank's first row, whisper
   (2 + 2 + 2) x 2 x 2 at the rank's first frame, first token and 0
   (cross-attention) (``mesh_expected``).  Correctness only: gloo stages
   every collective through the host.
13. The int8 error-feedback all-reduce and GPipe, after phase 12
   (``phase_compress_pipeline``), as one spawn of four gloo ranks on the
   card: (a) each rank's gradient of llama2-7b's first 2 layers at full
   width (667 M parameters), bf16, on its own 1 x 2048 batch through the
   train step (``first_step_grads``; ``fastattn_fwd`` 2 x 2 launches a
   rank), then 3 rounds of ``training.compression.compressed_psum`` with
   the residuals carried.  Gates: every rank's reduced tree the same
   bits; in the last round each leaf within COMPRESS_ULPS ulps of its
   scale of the same arithmetic in float64 on rank 0 from the int8
   values and scales gathered to its host (the f32 sum of the four
   scales rounds up to 3 times, the product once); each new residual
   v - q * scale rounded once, exactly;
   the payload's bytes an f32 all-reduce's.  Prints each leaf's error
   against the plain f32 mean and the bytes a round.  (b) GPipe
   (``training.pipeline.make_pipeline``): four stages of one llama2-7b
   layer each (layers 0-3 of a seeded draw, full width, bf16; the
   stage's weights by CUDA IPC) on 8 microbatches of 1 x 512 embedded
   tokens, stage_fn ``apply_block``.  Gates: every rank's output the
   same bits, held to the four layers applied one after another here
   within the bf16 bound, ``fastattn_fwd`` exactly 11 launches a rank
   (one layer x 11 ticks), 11 ring sends a rank, the bubble exactly 3/11.
   Prints each rank's wall and point-to-point bytes.  Correctness only.
   Then the first roofline readings: phase 4's MFU (``model_flops`` of 4
   layers at 4 x 2048 over the median step and the bf16 peak) and phase
   3c's decode step against ``analysis.roofline.roofline_terms`` of an
   analytic cost (``model_flops`` + ``attention_flops``, 3c's bytes):
   either share above 1.05 fails the run (a count is wrong).
14. Context-parallel dense decode (``phase_cp_decode``), its ranks in
   phase 13's spawn after (b) (``_cp_job``), its one-device run after
   that spawn: llama2-7b at full width cut to its first 4 of 32 layers
   (``CP_LAYERS``), B=8 of decode_32k's 128 rows (``CP_BATCH``), a cache
   of decode_32k's 32,768 positions (``CP_WIDTH``) filled with N(0, 1)
   at phase 3b's per-layer K / V RMS, each (layer, K / V, row, slice)
   piece from one generator seeded for it (``cp_cache_piece``), so that
   the one-device run and each rank draw the same values; a decode step
   at pos 1,000 and at 16,381-16,386 (the write crosses into model rank
   1's slice at 16,384) on one device through ``flash_decode``, and on
   four gloo ranks at (data=2, model=2), each on its (4, 16384, 32, 128)
   slice (``LM.init_cache`` / ``LM.decode_step`` under ``axis_rules``).
   Gates (``cp_gate``): each rank's logits within LOGIT_TOL of its rows'
   scale with greedy tokens equal where the margin exceeds it, the two
   model ranks of a data group bit for bit, each K/V row a rank wrote,
   in every layer, within the bf16 bound of the one-device cache's
   (``bf16_row_gate``), each slice the rule table's shape,
   ``flash_decode`` exactly 4 x 7
   launches a rank, every one asked for the log-sum-exp, and no plain
   attention on CUDA tensors.  Prints each rank's step wall, merges a
   step and their bytes, weight gathers, peak memory and the kernel's
   device time at its slice.  Correctness only: gloo shares the card.
15. Dense decode on a mesh for every other block kind
   (``phase_mesh_decode``), after phase 14; its ranks ran in phase 12's
   spawn after each model's steps and in phase 8 (h)'s after its steps
   (``_decode_job``): xlstm-125m's first 3 layers, hymba-1.5b's first 2
   (global, windowed), whisper-small's 2 + 2 and qwen3-moe-30b-a3b's
   first 2 at full width, bf16, random weights from seed 0, B=8
   (``MESH_DECODE_BATCH``) at (data=2, model=2), each rank on the rule
   table's slice of every cache leaf (``init_cache`` under
   ``axis_rules``): the KV caches over their sequence (hymba 8,192
   positions, steps 4,094-4,097 across the slice boundary and 5,200 /
   5,201 where hymba_local's window of 1,024 leaves slice 0 no valid
   key; whisper's self cache 448, its cross K/V of 1,500 frames from
   ``encode`` on the mesh; qwen3-moe 4,096), hymba's Mamba h and conv
   history and the sLSTM's states over their channels, the mLSTM's C
   over dv, qwen3-moe's 64 experts a rank (``MESH_DECODE``).  Every leaf
   filled per (leaf, row, piece) from one seeded generator
   (``decode_fill``), so the one-device run (``decode_reference``, after
   the ranks) draws the same.  Gates (``decode_gate``): each rank's
   logits within the model's measured gate (LOGIT_TOL, or twice what one
   ulp on 1% of the embedded tokens does to one device's logits where
   larger) with greedy tokens equal where decisive, the model ranks of a
   data group bit for bit, every layer's written K/V rows and the rank's
   slice of every recurrent state within the bf16 bound of one device's,
   every leaf the rule table's shape, ``flash_decode`` exactly attention
   layers x steps a rank, every one with the log-sum-exp,
   ``fastattn_fwd`` whisper's 2 cross layers x steps, no plain attention
   on CUDA tensors.  Prints each rank's step wall, collectives a step
   and their bytes, peak memory and launches.  Correctness only.
16. The dry run and one rank of three production cells
   (``phase_dryrun``, after phase 15): (a) ``python -m
   repro_torch.launch.dryrun --all`` in this process on the meta device
   (nothing allocated on the card): every assigned arch x shape x
   {16 x 16, 2 x 16 x 16} cell's bytes a rank, no error cell and JAX's
   skipped set (long_500k but for ``JAX_LONG_ARCHS``), each ok cell's
   argument GB and fits_h100 printed; beside it (b) three spawned
   processes, one a cell, each rank 0 of a fake world of 256 ranks
   (torch's "fake" backend, whose collectives move no data: values are
   not checked), run
   qwen2.5-32b decode_32k (4 decode steps), hymba-1.5b long_500k (B=1,
   the batch whole on every data rank; 4 steps) and qwen2.5-32b
   train_4k (one AdamW step of the rank's 16 rows x 256 positions) at
   full width and depth on the card, each parameter made as the rank's
   piece (``DRYRUN_CELLS``).  Gates (``dryrun_gate``): the bytes the
   rank's parameters, AdamW state and cache ask the caching allocator
   for are the dry run's count, and the allocated bytes they add lie
   between that count and the count + 512 B a tensor (``ALLOC_ROUND``)
   + 1 MiB a tensor over 1 MiB (``ALLOC_LARGE``: a large block is handed
   out whole where at most 1 MiB would be left), the step's ``sharding/collectives.COUNTS`` and
   ``core/tiled_allreduce.COUNTS`` equal the record's ``collectives``
   (times the decode steps), ``flash_decode`` exactly attention layers
   x steps, each with the log-sum-exp, no plain attention on CUDA,
   ``fastattn_fwd`` 2 x layers in training, the peak under 80 GB; the
   peak minus the arguments is printed beside the record's activation
   estimate (read, not gated).

The line before the last is a JSON object with one entry per kernel
(``ms`` per launch as above, ``device_ms`` on the device alone;
``flash_decode`` also ``long_*``: phase 2's B=1, S=65536 case and phase
3c's step; ``paged_prefill`` also ``verify_*``: phase 2's VERIFY_CASE,
with its launches in phase 3d (c); both paged kernels also
``tp_launches``, each rank's launches in phase 3e (a) under each
all-reduce mode; each attention kernel also ``d80_*`` and ``d96_*``, its
phase 2 bf16 case at the main path's shape -- flash_decode's from phase 7
(b), its ``d80_long_*`` / ``d96_long_*`` at B=1 on 65536 tokens -- and
its launches in phase 7; each attention kernel also ``g8_*``, its phase 2
case at qwen3-moe's GQA 32/4 -- flash_decode's from phase 8 (b)'s caches,
its phase-2 case as ``g8_case_*`` -- and ``moe_launches``, its launches in
phase 8; ``fastattn_fwd`` also ``moe_train_launches`` and
``moe_ep_launches`` / ``moe_ep_q_offsets`` (phase 8 (g), each rank of
(h)), the paged kernels ``moe_tp_launches`` (each rank of (i));
``fastattn_fwd`` and ``flash_decode`` also ``hymba_*``, phase
2's case at hymba-1.5b's main-path shape, ``fastattn_fwd``'s
``hymba_global_*`` without the window, ``flash_decode``'s
``hymba_window_*`` on 4096 keys, and ``hymba_launches``, each run's
launches in phase 9; ``fastattn_fwd`` also ``whisper_enc_*``,
``whisper_cross_*`` and ``whisper_step_*``, ``flash_decode``
``whisper_*`` and ``whisper_ragged_*``, phase 2's cases at whisper's
shapes, and both ``whisper_launches``, each run's launches in phase
10; each attention kernel also ``vl_*``, its phase 2 case at
qwen2-vl's 64/8 heads -- flash_decode's from phase 11 (c)'s caches, its
phase-2 case as ``vl_case_*`` -- and ``vl_launches``, its launches in
phase 11; ``fastattn_fwd`` also ``context_*``, phase 2's context-parallel
case of rank m=1, ``context_m0_*`` of m=0, and each
phase 4b rank's launches; ``mlstm_chunkwise`` and ``fastattn_fwd`` also
``mesh_*``, phase 2's case at a phase 12 rank's shape (``MESH_MLSTM_CASE``,
whisper's encoder), ``fastattn_fwd`` also ``mesh_hymba_*``, ``mesh_dec_*``
and ``mesh_cross_*`` at its other shapes there (``MESH_FWD_CASES``), and
``mesh_launches``, each rank's launches in phase 12; ``fastattn_fwd``
also ``int8_launches``, each run's launches in phase 3f, and
``pipeline_launches``, each rank's in phase 13 (b); ``flash_decode``
also ``cp_*``, its phase 2 slice cases (``CP_SLICE_CASES``, each with
its ``lse_err``), and ``cp_launches`` / ``cp_lse_calls`` /
``cp_rank_device_ms``, each phase 14 rank's, with phase 15's
``cp_hymba_*`` / ``cp_moe_*`` / ``cp_whisper_*``; ``flash_decode`` and
``fastattn_fwd`` also ``mesh_decode_launches``, each phase 15 model's
launches on each rank, flash_decode's ``mesh_decode_lse_calls``, and
``dryrun_launches``, their launches in each of phase 16 (b)'s cells);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # FP32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# bf16 outputs: kernel and plain version both accumulate in f32 and
# round once to bf16 (2^-8 relative); inputs are N(0, 1), outputs |o| < 4.
# f32: only the summation order differs.
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-3}
# the attention checks also hold each output row's error to its own scale
# (held_to_plain): one bf16 rounding apart is at most 2^-7 of the row's
# largest |output|.


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` launches (CUDA events
    around each launch, after ``warmup`` untimed launches)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one launch of ``fn()``: ``reps`` launches queued
    behind a spin kernel (``torch.cuda._sleep``), so the card runs them
    back to back while the host is still enqueueing them; CUDA events
    around the run, mean per launch.  time_ms's window also holds the
    host's work between its two events (the wrapper's checks and the
    launch itself), which is most of a short kernel's time; this one
    holds only the card's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)         # ~10 ms: longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


# entry functions that must not spill: the tensor-core kernels, and the
# dense decode kernel, bound by bytes, whose registers carry its loads in
# flight (a spill adds local-memory traffic to every step)
NO_SPILL_ENTRIES = ("_wgmma", "flash_decode_")


def ptxas_faults(log: str) -> list:
    """The faults of a ``-Xptxas -v`` build log: spill stores or loads in
    an entry function named with one of NO_SPILL_ENTRIES, and any
    "Performance Loss" advisory on ``wgmma`` (C7510 to C7520: ptxas
    serialized the wgmmas, which costs the kernel ~1.7x)."""
    faults, entry = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _SPILLS.search(line)
        if m and entry and any(t in entry for t in NO_SPILL_ENTRIES) and (
                int(m.group(1)) or int(m.group(2))):
            faults.append(f"{entry}: {line.strip()}")
        if "Performance Loss" in line and "wgmma" in line:
            faults.append(line.strip())
    return faults


def phase_card_and_build() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.1f}s "
        "(nvcc in parallel)")
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f}s"
            f"{' (cached)' if r['cached'] else ''}")
        for line in r["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line or "Performance" in line
                    or "warning" in line):
                log(f"[build]   {line.strip()}")
    faults = [f"{name}: {f}" for name, r in report.items()
              for f in ptxas_faults(r["log"])]
    if faults:
        raise AssertionError("ptxas: spills or serialized wgmma in the "
                             "kernels that must have neither:\n"
                             + "\n".join(faults))
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pools(gen, hkv, num_pages, ps, d, dtype):
    import torch
    shape = (hkv, num_pages, ps, d)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def _tables(rng, b, n_kv, num_pages):
    """Scrambled page tables: every sequence owns distinct pages spread
    over the pool (page 0 is the scratch page)."""
    import numpy as np
    perm = rng.permutation(np.arange(1, num_pages))[:b * n_kv]
    return perm.reshape(b, n_kv).astype(np.int32)


def _speed(res: dict, n_ops: float) -> str:
    """The kernel's achieved rate on this data's useful operations, and
    its time over the library call's (where there is one); then both
    again on device time alone (``device_ms``)."""
    ratio = ("" if res["library_ms"] is None else
             f", kernel / library {res['ms'] / res['library_ms']:.2f}x")
    dev = (f"; device time {res['device_ms']:.4f} ms (bound / device "
           f"{res['bound_ms'] / res['device_ms']:.1%}")
    if res["library_ms"] is not None:
        dev += (f", library {res['library_device_ms']:.4f} ms, kernel / "
                f"library {res['device_ms'] / res['library_device_ms']:.2f}x")
    return f"{n_ops / (res['ms'] * 1e-3) / 1e12:.1f} TFLOP/s{ratio}{dev})"


def _report(kind: str, name: str, res: dict, n_ops: float) -> None:
    lib = ("n/a (no single PyTorch call applies a softcap or window)"
           if res["library_ms"] is None else
           f"{res['library_ms']:.4f} ms (scaled_dot_product_attention on the "
           "gathered view, gather excluded)")
    log(f"[{kind}] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), library {lib}; {_speed(res, n_ops)}")


def decode_case(name, *, b, hq, hkv, d, ps, n_kv, dtype, window=None,
                softcap=None, seed=0, lens=None, library=True):
    """paged_flash_decode vs paged_decode_reference on one shape, every
    (sequence, query head) row held to its own scale (held_to_plain).
    kv_len: ``lens`` -- a list, or a function of the launch's split_keys
    (the split-KV edges) -- or else drawn in 1..n_kv * ps with the first
    row full and the last an idle engine slot.  A row of kv_len 1 is an
    idle slot: all-scratch table row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (paged_flash_decode,
                                                      plan_splits)
    from repro_torch.kernels.flash_decode.ref import (paged_decode_reference,
                                                      paged_gather)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = _pools(gen, hkv, num_pages, ps, d, tdt)
    table = _tables(rng, b, n_kv, num_pages)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_keys, n_split = plan_splits(b, hkv, hq // hkv, n_kv, ps, window,
                                      sms)
    if lens is None:
        lens = rng.integers(1, n_kv * ps + 1, size=b)
        lens[0] = n_kv * ps                          # one full-length row
        lens[-1] = 1
    elif callable(lens):
        lens = lens(split_keys)
    lens = np.asarray(lens, np.int32)
    table[lens == 1] = 0
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(tdt)
    table_t = torch.from_numpy(table).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap)

    def kernel():
        return paged_flash_decode(q, kp, vp, table_t, lens_t, **kw)

    def plain():
        return paged_decode_reference(q[:, :, None], kp, vp, table_t,
                                      lens_t, **kw)[:, :, 0]

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    log(f"[decode] {name}: kv_len {lens.tolist()}; split planner "
        f"{split_keys}-key splits, {n_split} a row on {sms} SMs")
    err, rel = held_to_plain("decode", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: each valid K/V row read once per kv head
    keys = np.minimum(lens, window) if window else lens
    esize = torch.empty((), dtype=tdt).element_size()
    n_bytes = (2 * hkv * int(keys.sum()) * d + 2 * b * hq * d) * esize \
        + table.nbytes + lens.nbytes
    n_ops = 4.0 * (hq // hkv) * hkv * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "split_keys": split_keys,
           "n_split": n_split}
    res["device_ms"] = device_ms(kernel)
    if library and window is None and softcap is None:
        kd = paged_gather(kp, table_t)
        vd = paged_gather(vp, table_t)
        pos = torch.arange(kd.shape[2], device="cuda")
        mask = (pos[None, :] < lens_t[:, None].long())[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask,
                enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
    _report("decode", name, res, n_ops)
    return res


def prefill_case(name, *, hq, hkv, d, ps, n_kv, chunk, dtype, starts,
                 nvalid, window=None, softcap=None, seed=0, library=True):
    """fastattn_paged_prefill vs paged_prefill_reference on one launch of
    ``len(starts)`` rows.  A row with n_valid 0 is a padded batch row:
    all-scratch table row, pos_start 0, kv_len 0 -- its output must be
    exactly 0."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.fastattn.ref import paged_prefill_reference
    from repro_torch.kernels.flash_decode.ref import paged_gather
    tdt = getattr(torch, dtype)
    b = len(starts)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    num_pages = b * n_kv + 8
    kp, vp = _pools(gen, hkv, num_pages, ps, d, tdt)
    table = _tables(rng, b, n_kv, num_pages)
    starts = np.asarray(starts, np.int32)
    nvalid = np.asarray(nvalid, np.int32)
    table[nvalid == 0] = 0
    lens = starts + nvalid
    q = torch.randn((b, hq, chunk, d), generator=gen, device="cuda").to(tdt)
    table_t = torch.from_numpy(table).cuda()
    starts_t = torch.from_numpy(starts).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap)

    def kernel():
        return fastattn_paged_prefill(q, kp, vp, table_t, starts_t, lens_t,
                                      **kw)

    def plain():
        return paged_prefill_reference(q, kp, vp, table_t, starts_t, lens_t,
                                       **kw)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    for i in range(b):
        if nvalid[i] == 0 and out[i].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: padded row {i} is not 0")
    # every valid query row of every head, each to its own scale
    got = torch.cat([out[i, :, :n].reshape(-1, d)
                     for i, n in enumerate(nvalid) if n])
    want = torch.cat([ref[i, :, :n].reshape(-1, d)
                      for i, n in enumerate(nvalid) if n])
    err, rel = held_to_plain("prefill", f"{name} (padded rows exactly 0)",
                             got, want, dtype)

    # work this data needs: valid (row, key) pairs of the valid rows, and
    # every key any valid row sees read once per kv head
    pairs, keys_read = 0, 0
    for i in range(b):
        n = int(nvalid[i])
        if n == 0:
            continue
        rows = starts[i] + np.arange(n)
        lo = np.maximum(rows - window + 1, 0) if window else np.zeros_like(
            rows)
        pairs += int((rows + 1 - lo).sum())
        keys_read += int(lens[i] - lo.min())
    esize = torch.empty((), dtype=tdt).element_size()
    n_valid_rows = int(nvalid.sum())
    n_bytes = (2 * hkv * keys_read * d + 2 * hq * n_valid_rows * d) * esize \
        + table.nbytes + starts.nbytes + lens.nbytes
    n_ops = 4.0 * hq * pairs * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    res["device_ms"] = device_ms(kernel)
    if library and window is None and softcap is None:
        kd = paged_gather(kp, table_t)
        vd = paged_gather(vp, table_t)
        cols = torch.arange(kd.shape[2], device="cuda")
        rows = starts_t[:, None].long() + torch.arange(chunk, device="cuda")
        mask = ((cols[None, None, :] <= rows[:, :, None])
                & (cols[None, None, :] < lens_t[:, None, None].long()))
        mask = mask[:, None]

        def lib():
            return F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask, enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
    _report("prefill", name, res, n_ops)
    return res


def fwd_bytes(mask, *, b, hq, hkv, d, esize) -> int:
    """The bytes an attention forward must move for a (Sq, Skv) ``mask``
    of visible pairs: Q read and O written once, and K and V read once
    for each key column some query row sees (a context-parallel rank at
    q_offset 0 sees only the first Sq of its keys)."""
    sq = mask.shape[0]
    kv_needed = int(mask.any(0).sum().item())
    return (2 * b * hq * sq * d + 2 * b * hkv * kv_needed * d) * esize


def fwd_case(name, *, b, hq, hkv, sq, skv, d, dtype, causal=True,
             window=None, softcap=None, q_offset=0, kv_valid=None, seed=0):
    """fastattn_fwd vs flash_reference on one shape.  Rows with no visible
    key are 0 on both sides, so every row is compared."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.tiling_mask import dense_mask
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.fastattn.ref import flash_reference
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)

    def kernel():
        return fastattn_fwd(q, k, v, kv_valid=kv_valid, **kw)

    def plain():
        return flash_reference(q, k, v, kv_len=kv_valid, **kw)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    # every query row of every head, each to its own scale (a long causal
    # row's output is ~0.1, an early row's up to ~4)
    err, rel = held_to_plain("fastattn", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: the visible (row, key) pairs of every head;
    # Q read and O written once, K and V read once where a row sees them
    mask = dense_mask(sq, skv, causal=causal, window=window,
                      q_offset=q_offset, device="cuda")
    if kv_valid is not None:
        mask[:, kv_valid:] = False
    pairs = int(mask.sum().item())
    n_bytes = fwd_bytes(mask, b=b, hq=hq, hkv=hkv, d=d,
                        esize=q.element_size())
    n_ops = 4.0 * b * hq * pairs * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "pairs": pairs}
    res["device_ms"] = device_ms(kernel)
    if softcap is None:
        from torch.nn.attention.bias import causal_lower_right
        ke = k.repeat_interleave(hq // hkv, dim=1)      # GQA expanded
        ve = v.repeat_interleave(hq // hkv, dim=1)      # outside the time
        # SDPA's causal masks: is_causal aligns the diagonal top left
        # (q_offset 0), causal_lower_right bottom right (q_offset = the
        # keys beyond the queries, a context-parallel rank's last rows)
        # and with neither (non-causal, every key valid) no mask at all:
        # SDPA's plain flash path
        every = window is None and kv_valid in (None, skv)
        plain = causal and every
        lib_mask = (True if plain and q_offset == 0 else
                    causal_lower_right(sq, skv)
                    if plain and q_offset == skv - sq else
                    None if every and not causal else mask)

        def lib():
            if lib_mask is True:
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(q, ke, ve,
                                                  attn_mask=lib_mask)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
    lib_s = ("n/a (no single PyTorch call applies a softcap)"
             if res["library_ms"] is None else
             f"{res['library_ms']:.4f} ms (scaled_dot_product_attention, "
             "GQA expansion excluded)")
    log(f"[fastattn] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {pairs} visible pairs per head), library "
        f"{lib_s}; {_speed(res, n_ops)}")
    return res


def held_to_plain(tag, name, out, ref, dtype, unbounded=False) -> tuple:
    """Hold ``out`` to its plain version ``ref`` (leading dim = rows: a
    batch row, or a query row of a head): the max abs error within TOL,
    and every row's max abs error within REL_TOL of that row's largest
    |ref|.  The second check matters
    on long caches, where an output's scale is about sqrt(e / kv_len) and
    TOL alone would pass a kernel that skipped part of the keys.  TOL
    assumes outputs below 4 in magnitude (an attention output).  For an
    ``unbounded`` output (the mLSTM's h, whose denominator can be small,
    reaches ~80 on N(0, 1) inputs at xlstm-125m's training shape; the
    xLSTM blocks' outputs and gradients) TOL is scaled by
    max(1, max|ref| / 2): two bf16 values one rounding apart differ by
    one ulp, at most 2^-7 of the largest value.
    Returns (max abs error, max error relative to its row's scale)."""
    import torch
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    err = diff.max().item()
    rel = (diff / scale.clamp_min(1e-30)).max().item()
    tol, rtol = TOL[dtype], REL_TOL[dtype]
    if unbounded:
        tol *= max(1.0, scale.max().item() / 2)
    log(f"[{tag}] {name}: max_abs_err {err:.3e} (tol {tol:g}), max error "
        f"/ row scale {rel:.3e} (tol {rtol:g}), smallest row scale "
        f"{scale.min().item():.3e}")
    if not (err <= tol and rel <= rtol):
        raise AssertionError(f"{name}: max_abs_err {err} (tol {tol}), "
                             f"relative {rel} (tol {rtol})")
    return err, rel


def _jagged(values, lens):
    """(sum lens, H, D) ``values`` as a jagged nested tensor (B, H, j, D)
    of rows ``lens`` long, its shortest and longest row length cached:
    SDPA would otherwise read them back from the card, a host sync a
    call."""
    import torch
    offsets = torch.zeros(len(lens) + 1, dtype=torch.int64,
                          device=values.device)
    offsets[1:] = torch.as_tensor(lens, device=values.device).cumsum(0)
    return torch.nested.nested_tensor_from_jagged(
        values, offsets, min_seqlen=int(min(lens)),
        max_seqlen=int(max(lens))).transpose(1, 2)


def _jagged_rows(t, lens, layout):
    """Each row's first ``lens[i]`` keys of a cache ``t`` as one jagged
    nested tensor (B, H, j, D) (a copy, made outside any timed region)."""
    import torch
    rows = [(t[i, :n] if layout == "bshd" else t[i, :, :n].transpose(0, 1))
            for i, n in enumerate(lens.tolist())]
    return _jagged(torch.cat(rows), lens.tolist())


def dense_decode_measure(name, q, k, v, lens, *, dtype, layout,
                         window=None, softcap=None, lib="mask") -> dict:
    """flash_decode vs decode_reference on given cache tensors (read in
    place in ``layout``) and host kv_len ``lens``; then the kernel, the
    plain version and SDPA timed, and the bound of this data's work.
    SDPA (``lib``): "mask" over the whole cache with a boolean mask of
    each row's keys (and the window); "flash" (no window, no GQA) its
    flash path with no mask -- over the first kv_len keys where every
    row has the same, else over each row's keys as one jagged nested
    batch (which syncs the host twice a call, so its device time is one
    profiled call's kernels, not ``device_ms``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference
    b, hq, d = q.shape
    if layout == "bshd":
        s, hkv = k.shape[1], k.shape[2]
    else:
        hkv, s = k.shape[1], k.shape[2]
    split_keys, n_split = _dense_plan(b, hq, hkv, s, window)
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap, layout=layout)

    def kernel():
        return flash_decode(q, k, v, lens_t, **kw)

    def plain():
        return decode_reference(q[:, :, None], k, v, lens_t,
                                **kw)[:, :, 0]

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    log(f"[flash_decode] {name}: kv_len {lens.tolist()}; split planner "
        f"{split_keys}-key splits, {n_split} a row")
    # every (batch, query head) row to its own scale
    err, rel = held_to_plain("flash_decode", name, out.reshape(-1, d),
                             ref.reshape(-1, d), dtype)

    # work this data needs: each valid K/V row read once per kv head
    keys = np.minimum(lens, window) if window else lens
    esize = q.element_size()
    n_bytes = (2 * hkv * int(keys.sum()) * d + 2 * b * hq * d) * esize \
        + lens.nbytes
    n_ops = 4.0 * hq * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None, "split_keys": split_keys,
           "n_split": n_split}
    res["device_ms"] = device_ms(kernel)
    lib_note = "n/a (no single PyTorch call applies a softcap)"
    if softcap is None and lib == "flash":
        if window is not None or hq != hkv:
            raise ValueError(f"{name}: SDPA's flash path takes no window "
                             "or GQA here")
        n = int(lens[0])
        if (lens == n).all():
            kf, vf = ((t[:, :n].transpose(1, 2) if layout == "bshd"
                       else t[:, :, :n]).contiguous() for t in (k, v))
            qf = q[:, :, None]
            how = f"its first {n} keys, layout copy excluded"
        else:
            qf = _jagged(q, [1] * b)
            kf, vf = _jagged_rows(k, lens, layout), _jagged_rows(v, lens,
                                                                 layout)
            how = "a jagged batch of each row's keys, the copy excluded"

        def lib_call():
            return F.scaled_dot_product_attention(qf, kf, vf)
        res["library_ms"] = time_ms(lib_call)
        res["library_device_ms"] = (_profile_kernels(lib_call)[1] * 1e3
                                    if qf.is_nested else device_ms(lib_call))
        lib_note = (f"{res['library_ms']:.4f} ms (scaled_dot_product_"
                    f"attention's flash path, no mask, on {how})")
    elif softcap is None:
        # SDPA takes (B, H, S, D): a "bshd" cache is copied to that layout
        # outside the timed region; the boolean mask applies the window
        kd = k.transpose(1, 2).contiguous() if layout == "bshd" else k
        vd = v.transpose(1, 2).contiguous() if layout == "bshd" else v
        pos = torch.arange(s, device="cuda")
        lens_l = lens_t[:, None].long()
        mask = pos[None, :] < lens_l
        if window is not None:
            mask &= pos[None, :] >= lens_l - window
        mask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask,
                enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
        lib_note = (f"{res['library_ms']:.4f} ms (scaled_dot_product_"
                    "attention, boolean mask"
                    + (", layout copy excluded)" if layout == "bshd"
                       else ")"))
    log(f"[flash_decode] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {n_bytes / 1e6:.1f} MB), library {lib_note}; "
        f"{_speed(res, n_ops)}")
    return res


def _dense_plan(b, hq, hkv, s, window):
    """(split_keys, n_split) of a flash_decode launch on this card."""
    import torch
    from repro_torch.kernels.flash_decode.ops import plan_dense_splits
    return plan_dense_splits(b, hq, hkv, s, window,
                             torch.cuda.get_device_properties(
                                 0).multi_processor_count)


def dense_decode_case(name, *, b, hq, hkv, s, d, dtype, layout,
                      window=None, softcap=None, seed=0, lens=None,
                      lib="mask"):
    """flash_decode vs decode_reference on random N(0, 1) inputs of one
    shape, the cache in ``layout``.  kv_len: ``lens`` -- a list, or a
    function of the launch's split_keys (the split-KV edges) -- or else
    ragged in 1..s with one row at s and (for b > 1) one at 1."""
    import numpy as np
    import torch
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (b, s, hkv, d) if layout == "bshd" else (b, hkv, s, d)
    k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt)
            for _ in range(2))
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(tdt)
    if lens is None:
        lens = rng.integers(1, s + 1, size=b)
        lens[0] = s
        if b > 1:
            lens[-1] = 1
    elif callable(lens):
        lens = lens(_dense_plan(b, hq, hkv, s, window)[0])
    return dense_decode_measure(name, q, k, v, np.asarray(lens, np.int32),
                                dtype=dtype, layout=layout, window=window,
                                softcap=softcap, lib=lib)



LSE_TOL = 1e-3              # a slice's log-sum-exp, float32 on both sides


def slice_keys(lens, kv_start: int, s: int, window=None):
    """Valid keys of each row in a cache slice of ``s`` rows from global
    position ``kv_start``: [max(kv_len - window, 0), kv_len) cut to the
    slice."""
    import numpy as np
    lens = np.asarray(lens, np.int64)
    lo = np.maximum(lens - window, 0) if window else np.zeros_like(lens)
    return np.maximum(np.minimum(lens, kv_start + s)
                      - np.maximum(lo, kv_start), 0)


def dense_slice_case(name, *, b, hq, hkv, s, d, kv_start, lens, dtype,
                     window=None, softcap=None, seed=0) -> dict:
    """flash_decode on one context-parallel rank's slice of a "bshd"
    cache (``kv_start``, kv_len global) with its log-sum-exp, against
    decode_reference on the same slice: the output float32 on both sides
    (the partial a cross-rank merge reads unrounded), every (batch, head)
    row of it to its own scale at the float32 tolerance (held_to_plain:
    both compute in float32 from the same inputs), the log-sum-exp within
    LSE_TOL, and a row with no valid key exactly 0 and NEG_INF in both;
    then the
    kernel, the plain version and SDPA over the slice with a boolean mask
    of each row's valid keys (no softcap: SDPA applies none; it returns
    no log-sum-exp) timed, and the bound of this data's work."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import NEG_INF, decode_reference
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(tdt)
            for _ in range(2))
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(tdt)
    lens = np.asarray(lens, np.int32)
    lens_t = torch.from_numpy(lens).cuda()
    kw = dict(window=window, softcap=softcap, layout="bshd",
              kv_start=kv_start, return_lse=True)

    def kernel():
        return flash_decode(q, k, v, lens_t, **kw)

    def plain():
        return decode_reference(q[:, :, None], k, v, lens_t, **kw)

    (out, lse), (ref, ref_lse) = kernel(), plain()
    ref, ref_lse = ref[:, :, 0], ref_lse[:, :, 0]
    torch.cuda.synchronize()
    keys = slice_keys(lens, kv_start, s, window)
    log(f"[flash_decode] {name}: kv_len {lens.tolist()}, kv_start "
        f"{kv_start}: valid keys in the slice {keys.tolist()}")
    if not out.dtype == ref.dtype == torch.float32:
        raise AssertionError(f"{name}: out {out.dtype}, plain {ref.dtype}, "
                             "want float32 with the log-sum-exp")
    err, rel = held_to_plain("flash_decode", name, out.reshape(-1, d),
                             ref.reshape(-1, d), "float32")
    lse_err = (lse - ref_lse).abs().max().item()
    empty = keys == 0
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"{name}: lse differs by {lse_err} "
                             f"(tol {LSE_TOL})")
    for what, o, ls in (("kernel", out, lse), ("plain", ref, ref_lse)):
        if bool(empty.any()) and not (
                bool((o[empty] == 0).all())
                and bool((ls[empty] == NEG_INF).all())):
            raise AssertionError(f"{name}: a row with no valid key is not "
                                 f"0 / NEG_INF in the {what} version")
        if bool((~empty).any()) and not bool(
                (ls[~empty] > NEG_INF / 2).all()):
            raise AssertionError(f"{name}: a row with valid keys has no "
                                 f"lse in the {what} version")
    log(f"[flash_decode] {name}: lse max_abs_err {lse_err:.3e} (tol "
        f"{LSE_TOL:g}); {int(empty.sum())} of {b} rows with no valid key "
        "exactly 0 and NEG_INF in both")
    esize = q.element_size()
    # K/V rows read, q read; out (float32) and lse written; kv_len read
    n_bytes = (2 * hkv * int(keys.sum()) * d + b * hq * d) * esize \
        + b * hq * d * 4 + b * hq * 4 + lens.nbytes
    n_ops = 4.0 * hq * int(keys.sum()) * d
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "lse_err": lse_err,
           "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5),
           "device_ms": device_ms(kernel), "bound_ms": bnd, "bound_by": by,
           "library_ms": None, "library_device_ms": None,
           "empty_rows": int(empty.sum()), "keys": keys.tolist()}
    lib_note = "n/a (no single PyTorch call applies a softcap)"
    if softcap is None:
        kd, vd = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        pos = kv_start + torch.arange(s, device="cuda")
        lens_l = lens_t[:, None].long()
        mask = pos[None, :] < lens_l
        if window is not None:
            mask &= pos[None, :] >= lens_l - window
        mask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=hq != hkv)
        res["library_ms"] = time_ms(lib)
        res["library_device_ms"] = device_ms(lib)
        lib_note = (f"{res['library_ms']:.4f} ms (scaled_dot_product_"
                    "attention on the slice, boolean mask, layout copy "
                    "excluded; no log-sum-exp)")
    log(f"[flash_decode] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {n_bytes / 1e6:.1f} MB), library {lib_note}; "
        + (_speed(res, n_ops) if keys.sum() else
           f"no valid key; device time {res['device_ms']:.4f} ms"))
    return res

MLSTM_STATE_RTOL = 1e-3     # C, n, m: float32 on both sides


def mlstm_case(name, *, b, h, s, dk, dv, dtype, chunk=128, layout="bhsd",
               fbias=3.0, seed=0):
    """mlstm_chunkwise_fwd vs ref.mlstm_chunkwise on one shape: h under
    held_to_plain (an unbounded output), the float32 state (C, n, m)
    within MLSTM_STATE_RTOL of each one's largest |value|.  q/k/v are
    N(0, 1) in ``dtype``; with layout "bshd" they are (B, S, H, D) tensors
    passed transposed, as the model passes its projections.  Gates: i
    N(0, 1), f N(0, 1) + ``fbias`` (3: the model's forget-gate bias)."""
    import torch
    from repro_torch.kernels.mlstm import ref as mref
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(d):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        t = torch.randn(shape, generator=gen, device="cuda").to(tdt)
        return t.transpose(1, 2) if layout == "bshd" else t
    q, k, v = draw(dk), draw(dk), draw(dv)
    ig = torch.randn((b, h, s), generator=gen, device="cuda")
    fg = torch.randn((b, h, s), generator=gen, device="cuda") + fbias

    def kernel():
        return mlstm_chunkwise_fwd(q, k, v, ig, fg, chunk=chunk)

    def plain():
        return mref.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk,
                                    return_state=True)

    (out, state), (ref, ref_state) = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = held_to_plain("mlstm", name, out.flatten(0, 1),
                             ref.flatten(0, 1), dtype, unbounded=True)
    for what, got, want in zip("Cnm", state, ref_state):
        serr = (got - want).abs().max().item()
        sscale = want.abs().max().item()
        log(f"[mlstm] {name}: state {what} max_abs_err {serr:.3e} "
            f"({serr / sscale:.3e} of its scale {sscale:.3e}, tol "
            f"{MLSTM_STATE_RTOL:g})")
        if not serr <= MLSTM_STATE_RTOL * sscale:
            raise AssertionError(f"{name}: state {what} differs by {serr}")

    # work this data needs: q, k, v and gates read once, h and the state
    # written once; operations: the causal (row, key) pairs of every chunk
    # (q.k and the weighted sum of v: 2 (dk + dv) each) and per token q C,
    # the k v^T update (2 dk dv each) and q.n, the n update (2 dk each)
    esize = q.element_size()
    n_bytes = ((2 * dk + 2 * dv) * b * h * s * esize + 2 * b * h * s * 4
               + (dk * dv + dk + 1) * b * h * 4)
    L = min(chunk, s)
    sizes = [L] * (s // L) + ([s % L] if s % L else [])
    pairs = sum(n * (n + 1) // 2 for n in sizes)
    n_ops = b * h * (2.0 * (dk + dv) * pairs + s * (4.0 * dk * dv + 4 * dk))
    bnd, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"err": err, "rel_err": rel, "ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=5), "bound_ms": bnd,
           "bound_by": by, "library_ms": None}
    res["device_ms"] = device_ms(kernel)
    log(f"[mlstm] {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({by}, {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP), library "
        f"n/a (no single PyTorch call computes the mLSTM); "
        f"{_speed(res, n_ops)}")
    return res


# phase 2's attention-forward cases, (name, arguments): the first of each
# list is the main path's shape (the kernels line's numbers)
FWD_CASES = [
    ("llama2-7b train B=4 H=32/32 S=2048 D=128 bf16 causal",
     dict(b=4, hq=32, hkv=32, sq=2048, skv=2048, d=128, dtype="bfloat16")),
    ("gemma2-2b train B=4 H=8/4 S=2048 D=256 bf16 window=512 cap=50",
     dict(b=4, hq=8, hkv=4, sq=2048, skv=2048, d=256, dtype="bfloat16",
          window=512, softcap=50.0, seed=1)),
    ("f32 B=2 H=8/2 Sq=1000 Skv=1500 D=128 q_offset=300 kv_valid=1400",
     dict(b=2, hq=8, hkv=2, sq=1000, skv=1500, d=128, dtype="float32",
          q_offset=300, kv_valid=1400, seed=2)),
    ("non-causal B=2 H=8/8 Sq=512 Skv=777 D=64 bf16",
     dict(b=2, hq=8, hkv=8, sq=512, skv=777, d=64, dtype="bfloat16",
          causal=False, seed=3)),
    ("bf16 B=2 H=8/2 Sq=1000 Skv=1500 D=128 q_offset=300 kv_valid=1400",
     dict(b=2, hq=8, hkv=2, sq=1000, skv=1500, d=128, dtype="bfloat16",
          q_offset=300, kv_valid=1400, seed=4)),
]
# phase 4b's shape: a (data=2, model=2) rank's 2 x 1024 query rows of
# llama2-7b against all 2048 keys, q_offset = the rank's first row (m=1
# is the kernels line's context_* entry: three times m=0's work)
CONTEXT_CASES = {
    m: (f"llama2-7b context rank m={m} B=2 H=32/32 Sq=1024 Skv=2048 D=128 "
        f"bf16 q_offset={m * 1024}",
        dict(b=2, hq=32, hkv=32, sq=1024, skv=2048, d=128,
             dtype="bfloat16", q_offset=m * 1024, seed=5 + m))
    for m in (0, 1)}
PREFILL_CASES = [
    ("llama2-7b B=4 chunk=512 H=32/32 D=128 bf16 ps=128",
     dict(hq=32, hkv=32, d=128, ps=128, n_kv=16, chunk=512,
          dtype="bfloat16", starts=[0, 512, 1024, 0],
          nvalid=[512, 300, 512, 0])),
    ("gemma2-2b B=4 chunk=512 H=8/4 D=256 bf16 window=256 cap=50",
     dict(hq=8, hkv=4, d=256, ps=128, n_kv=16, chunk=512, dtype="bfloat16",
          starts=[0, 512, 1536, 0], nvalid=[512, 37, 512, 0], window=256,
          softcap=50.0, seed=1)),
    ("ps=16 f32 chunk=64 H=8/2 D=128 window=40 cap=30",
     dict(hq=8, hkv=2, d=128, ps=16, n_kv=12, chunk=64, dtype="float32",
          starts=[0, 64, 100, 0], nvalid=[64, 64, 20, 0], window=40,
          softcap=30.0, seed=2)),
    ("qwen2.5-32b ps=16 B=4 chunk=512 H=40/8 D=128 bf16",
     dict(hq=40, hkv=8, d=128, ps=16, n_kv=68, chunk=512, dtype="bfloat16",
          starts=[0, 512, 1000, 0], nvalid=[512, 301, 77, 0], seed=3)),
    # one rank of phase 3e (a): llama2-7b at tp=2 holds 16 of the 32 query
    # and kv heads
    ("llama2-7b tp=2 rank B=8 chunk=512 H=16/16 D=128 bf16 ps=128",
     dict(hq=16, hkv=16, d=128, ps=128, n_kv=16, chunk=512,
          dtype="bfloat16", starts=[0, 512, 1024, 1536, 0, 512, 0, 0],
          nvalid=[512, 300, 512, 512, 37, 512, 0, 0], seed=5)),
]
# the speculative verify launch's shape (phase 3d (c)): one row a running
# slot, K+1 = 5 query rows deep in a 2048-token cache, a different n_valid
# a row (59 or more rows of each 64-row tile are padding), one padded row
VERIFY_CASE = "llama2-7b verify B=8 chunk=5 H=32/32 D=128 bf16 ps=128"
PREFILL_CASES.append(
    (VERIFY_CASE,
     dict(hq=32, hkv=32, d=128, ps=128, n_kv=16, chunk=5, dtype="bfloat16",
          starts=[37, 300, 811, 1024, 1500, 1777, 1900, 0],
          nvalid=[5, 5, 4, 3, 2, 1, 1, 0], seed=4)))


# phase 2's paged decode cases, (name, arguments): the first is the main
# path's shape (the kernels line's numbers).  kv_len as a function of the
# launch's split_keys puts rows one below, at and one above a split; then
# a window narrower than the table, one sequence over many splits, and
# only idle rows (kv_len 1, all-scratch table rows)
DECODE_CASES = [
    ("llama2-7b B=8 H=32/32 D=128 bf16 ps=128",
     dict(b=8, hq=32, hkv=32, d=128, ps=128, n_kv=16, dtype="bfloat16")),
    ("gemma2-2b B=8 H=8/4 D=256 bf16 ps=128 window=256 cap=50",
     dict(b=8, hq=8, hkv=4, d=256, ps=128, n_kv=16, dtype="bfloat16",
          window=256, softcap=50.0, seed=1)),
    ("ps=16 f32 B=4 H=8/2 D=128 window=100 cap=30",
     dict(b=4, hq=8, hkv=2, d=128, ps=16, n_kv=24, dtype="float32",
          window=100, softcap=30.0, seed=2)),
    ("split edges B=4 H=32/8 D=128 bf16 ps=128 kv_len split-1/split/"
     "split+1/1", dict(b=4, hq=32, hkv=8, d=128, ps=128, n_kv=16,
                       dtype="bfloat16", seed=3,
                       lens=lambda sk: [sk - 1, sk, sk + 1, 1])),
    ("window in a later split B=4 H=8/4 D=256 bf16 ps=16 window=300",
     dict(b=4, hq=8, hkv=4, d=256, ps=16, n_kv=128, dtype="bfloat16",
          window=300, seed=4, lens=[2048, 1337, 301, 1])),
    ("B=1 H=32/8 D=128 bf16 ps=128 kv_len=4096 (many splits)",
     dict(b=1, hq=32, hkv=8, d=128, ps=128, n_kv=32, dtype="bfloat16",
          seed=5, lens=[4096])),
    ("idle rows only B=2 H=8/8 D=64 bf16 ps=16",
     dict(b=2, hq=8, hkv=8, d=64, ps=16, n_kv=8, dtype="bfloat16", seed=6,
          lens=[1, 1])),
    # one rank of phase 3e (a): llama2-7b at tp=2 decodes 16/16 heads at
    # its 8 slots, a split plan of its own (the planner reads B * Hkv);
    # drawn lengths, then rows one below, at and one above its first two
    # split edges, a full row and an idle slot
    ("llama2-7b tp=2 rank B=8 H=16/16 D=128 bf16 ps=128",
     dict(b=8, hq=16, hkv=16, d=128, ps=128, n_kv=16, dtype="bfloat16",
          seed=7)),
    ("llama2-7b tp=2 rank split edges B=8 H=16/16 D=128 bf16 ps=128",
     dict(b=8, hq=16, hkv=16, d=128, ps=128, n_kv=16, dtype="bfloat16",
          seed=8, lens=lambda sk: [sk - 1, sk, sk + 1, 2 * sk - 1, 2 * sk,
                                   2 * sk + 1, 16 * 128, 1])),
]
# phase 2's dense decode cases, (name, arguments).  The main path's own
# shape is phase 3b's (generate's caches); LONG_DECODE is the kernels
# line's long shape (llama2-7b at B=1 on a 65536-token cache), then the
# paper's longest input (262144 tokens), qwen2.5-32b's GQA 40/8 (a group
# of 5 in the 8-row instance) at its native context, kv_len one below, at
# and one above a split, and a window narrower than the 32-key split
LONG_DECODE = "llama2-7b B=1 H=32/32 D=128 bf16 bshd S=65536"
DENSE_DECODE_CASES = [
    ("llama2-7b B=8 H=32/32 D=128 bf16 bshd S=4096",
     dict(b=8, hq=32, hkv=32, s=4096, d=128, dtype="bfloat16",
          layout="bshd")),
    ("llama2-7b B=8 H=32/32 D=128 bf16 bhsd S=4096",
     dict(b=8, hq=32, hkv=32, s=4096, d=128, dtype="bfloat16",
          layout="bhsd")),
    ("gemma2-2b B=8 H=8/4 D=256 bf16 bshd S=8192 window=4096 cap=50",
     dict(b=8, hq=8, hkv=4, s=8192, d=256, dtype="bfloat16", layout="bshd",
          window=4096, softcap=50.0, seed=1)),
    ("f32 B=4 H=8/2 D=64 bshd S=1000",
     dict(b=4, hq=8, hkv=2, s=1000, d=64, dtype="float32", layout="bshd",
          seed=2)),
    (LONG_DECODE,
     dict(b=1, hq=32, hkv=32, s=65536, d=128, dtype="bfloat16",
          layout="bshd", seed=3)),
    ("llama2-7b B=1 H=32/32 D=128 bf16 bshd S=262144",
     dict(b=1, hq=32, hkv=32, s=262144, d=128, dtype="bfloat16",
          layout="bshd", seed=4)),
    ("qwen2.5-32b B=2 H=40/8 D=128 bf16 bshd S=32768",
     dict(b=2, hq=40, hkv=8, s=32768, d=128, dtype="bfloat16",
          layout="bshd", seed=5, lens=[32768, 32768])),
    ("split edges B=4 H=32/8 D=128 bf16 bhsd S=4096 kv_len split-1/split/"
     "split+1/1", dict(b=4, hq=32, hkv=8, s=4096, d=128, dtype="bfloat16",
                       layout="bhsd", seed=6,
                       lens=lambda sk: [sk - 1, sk, sk + 1, 1])),
    ("window narrower than a split B=4 H=8/2 D=256 bf16 bshd S=2048 "
     "window=20", dict(b=4, hq=8, hkv=2, s=2048, d=256, dtype="bfloat16",
                       layout="bshd", window=20, seed=7,
                       lens=[2048, 21, 20, 1])),
]
# flash_decode on one context-parallel rank's slice (phase 14's path,
# the kernels line's cp_* entries): llama2-7b's 32/32 heads at B=4 on the
# second 16,384-row slice of a 32,768-position cache (kv_start 16,384)
# at kv_len 1,000 (no valid key), 16,390 (6 keys) and 32,768 (the whole
# slice: a rank's share of decode_32k); gemma2-2b's head shape (D=256,
# GQA 8/4, softcap 50) with window 4,096 on slices of 8,192 rows, where
# the window leaves slice 0 no valid key (kv_len 24,000) and where it
# cuts slice 1 (ragged rows from 1 valid key to the window's 4,096, one
# with none)
CP_SLICE_CASES = {
    f"cp_{tag}": (f"llama2-7b cp rank B=4 H=32/32 D=128 bf16 slice "
                  f"16384@16384 kv_len={n}",
                  dict(b=4, hq=32, hkv=32, s=16384, d=128, kv_start=16384,
                       lens=[n] * 4, dtype="bfloat16", seed=20 + i))
    for i, (tag, n) in enumerate((("empty", 1000), ("start", 16390),
                                  ("full", 32768)))}
CP_SLICE_CASES.update({
    "cp_gemma_s0": ("gemma2-2b cp B=8 H=8/4 D=256 bf16 slice 8192@0 "
                    "window=4096 cap=50 kv_len=24000",
                    dict(b=8, hq=8, hkv=4, s=8192, d=256, kv_start=0,
                         lens=[24000] * 8, dtype="bfloat16", window=4096,
                         softcap=50.0, seed=23)),
    "cp_gemma_s1": ("gemma2-2b cp B=8 H=8/4 D=256 bf16 slice 8192@8192 "
                    "window=4096 cap=50 ragged",
                    dict(b=8, hq=8, hkv=4, s=8192, d=256, kv_start=8192,
                         lens=[14000, 12288, 10000, 16384, 8200, 20000,
                               30000, 8193], dtype="bfloat16", window=4096,
                         softcap=50.0, seed=24)),
})
# phase 15's head shapes, each on a (data=2, model=2) rank's 4 rows of
# its second slice: hymba's 25/5 at D=64 on 4,096 of 8,192 positions with
# its window of 1,024 (kv_len 5,202: the window inside the slice, as at
# phase 15's last step), qwen3-moe's GQA 32/4 on 2,048 of 4,096 and
# whisper's 12/12 on 224 of 448 (kv_len the cache's width: the whole
# slice)
CP_SLICE_CASES.update({
    "cp_hymba": ("hymba-1.5b cp B=4 H=25/5 D=64 bf16 slice 4096@4096 "
                 "window=1024 kv_len=5202",
                 dict(b=4, hq=25, hkv=5, s=4096, d=64, kv_start=4096,
                      lens=[5202] * 4, dtype="bfloat16", window=1024,
                      seed=25)),
    "cp_moe": ("qwen3-moe-30b-a3b cp B=4 H=32/4 D=128 bf16 slice 2048@2048 "
               "kv_len=4096",
               dict(b=4, hq=32, hkv=4, s=2048, d=128, kv_start=2048,
                    lens=[4096] * 4, dtype="bfloat16", seed=26)),
    "cp_whisper": ("whisper-small cp B=4 H=12/12 D=64 bf16 slice 224@224 "
                   "kv_len=448",
                   dict(b=4, hq=12, hkv=12, s=224, d=64, kv_start=224,
                        lens=[448] * 4, dtype="bfloat16", seed=27)),
})
# head dims 80 (stablelm-3b) and 96 (phi3-mini-3.8b), phase 7's models:
# each attention kernel in bf16 and float32 at its main path's shape (the
# bf16 case is the kernels line's d80_* / d96_* numbers; flash_decode's at
# phase 7 (b)'s own caches, its long_* at B=1 on 65536 tokens); paged
# decode also at its split edges (D = 80) and a GQA group of 4 (D = 96:
# the 16-lane thread group against the 4-row tile), paged prefill also a
# ragged 100-token chunk, fastattn_fwd also a ragged float32 case with a
# q_offset and a kv_valid tail
HEAD_DIM_ARCHS = {80: "stablelm-3b", 96: "phi3-mini-3.8b"}


def _hd_tag(d: int, dtype: str) -> str:
    short = "bf16" if dtype == "bfloat16" else "f32"
    return f"{HEAD_DIM_ARCHS[d]} D={d} {short}"


def head_dim_case(kernel: str, d: int, dtype: str = "bfloat16") -> str:
    """The name of ``kernel``'s phase-2 case at head dim ``d`` at its main
    path's shape (flash_decode: B=1 on 65536 tokens, the long shape)."""
    tag = _hd_tag(d, dtype)
    return {"paged_decode": f"{tag} B=8 H=32/32 ps=128",
            "paged_prefill": f"{tag} B=4 chunk=512 H=32/32 ps=128",
            "fastattn_fwd": f"{tag} B=4 H=32/32 S=2048 causal",
            "flash_decode": f"{tag} B=1 H=32/32 bshd S=65536"}[kernel]


for _d in HEAD_DIM_ARCHS:
    for _i, _dt in enumerate(("bfloat16", "float32")):
        _kw = dict(d=_d, dtype=_dt, seed=20 + _d + _i)
        DECODE_CASES.append((head_dim_case("paged_decode", _d, _dt), dict(
            b=8, hq=32, hkv=32, ps=128, n_kv=16, **_kw)))
        PREFILL_CASES.append((head_dim_case("paged_prefill", _d, _dt), dict(
            hq=32, hkv=32, ps=128, n_kv=16, chunk=512,
            starts=[0, 512, 1024, 0], nvalid=[512, 300, 512, 0], **_kw)))
        FWD_CASES.append((head_dim_case("fastattn_fwd", _d, _dt), dict(
            b=4, hq=32, hkv=32, sq=2048, skv=2048, **_kw)))
        for _lay in ("bshd", "bhsd"):
            DENSE_DECODE_CASES.append((
                f"{_hd_tag(_d, _dt)} B=8 H=32/32 {_lay} S=161 kv_len=159",
                dict(b=8, hq=32, hkv=32, s=161, layout=_lay, lens=[159] * 8,
                     **_kw)))
    PREFILL_CASES.append((
        f"{_hd_tag(_d, 'bfloat16')} ragged chunk=100 H=32/32 ps=128",
        dict(hq=32, hkv=32, d=_d, ps=128, n_kv=4, chunk=100,
             dtype="bfloat16", starts=[128, 3, 0], nvalid=[100, 77, 0],
             seed=_d)))
    FWD_CASES.append((
        f"{_hd_tag(_d, 'float32')} B=2 H=8/2 Sq=1000 Skv=1500 q_offset=300 "
        "kv_valid=1400", dict(b=2, hq=8, hkv=2, sq=1000, skv=1500, d=_d,
                              dtype="float32", q_offset=300, kv_valid=1400,
                              seed=_d)))
    DENSE_DECODE_CASES.append((head_dim_case("flash_decode", _d), dict(
        b=1, hq=32, hkv=32, s=65536, d=_d, dtype="bfloat16", layout="bshd",
        seed=_d)))
DECODE_CASES += [
    ("stablelm-3b D=80 bf16 split edges B=4 H=32/32 ps=128 kv_len "
     "split-1/split/split+1/1",
     dict(b=4, hq=32, hkv=32, d=80, ps=128, n_kv=16, dtype="bfloat16",
          seed=81, lens=lambda sk: [sk - 1, sk, sk + 1, 1])),
    ("D=96 bf16 GQA B=4 H=32/8 ps=128 (4-row tile)",
     dict(b=4, hq=32, hkv=8, d=96, ps=128, n_kv=16, dtype="bfloat16",
          seed=97)),
]

# GQA group 8 (qwen3-moe-30b-a3b's 32/4 heads of 128, phase 8's model):
# each attention kernel in bf16 at its main path's shape there, every row
# of the 8-row GQA instances used (the kernels line's g8_* numbers;
# flash_decode's from phase 8 (b)'s own caches, its phase-2 case at the
# same shape on N(0, 1) inputs): paged decode at B=8 on 16 pages of 128,
# a chunk-512 prefill of 8 rows (ragged and padded rows), the causal
# forward at 1 x 2048, dense decode at B=8, kv_len 159
MOE_ARCH = "qwen3-moe-30b-a3b"
# phase 8 (a)-(f) run its first MOE_LAYERS of 48 layers, every gate at
# that depth: a host-bound decode step of 48 MoE blocks took ~0.2 s, and
# (a)-(f) 117 s of the script's time limit
MOE_LAYERS = 16


def gqa8_case(kernel: str) -> str:
    """The name of ``kernel``'s phase-2 case at qwen3-moe's GQA 32/4."""
    tag = "qwen3-moe H=32/4 D=128 bf16"
    return {"paged_decode": f"{tag} B=8 ps=128",
            "paged_prefill": f"{tag} B=8 chunk=512 ps=128",
            "fastattn_fwd": f"{tag} B=1 S=2048 causal",
            "flash_decode": f"{tag} B=8 bshd S=161 kv_len=159"}[kernel]


_G8 = dict(hq=32, hkv=4, d=128, dtype="bfloat16")
DECODE_CASES.append((gqa8_case("paged_decode"), dict(
    b=8, ps=128, n_kv=16, seed=41, **_G8)))
PREFILL_CASES.append((gqa8_case("paged_prefill"), dict(
    ps=128, n_kv=16, chunk=512, starts=[0, 512, 1024, 1536, 0, 512, 0, 0],
    nvalid=[512, 300, 512, 512, 37, 512, 0, 0], seed=42, **_G8)))
FWD_CASES.append((gqa8_case("fastattn_fwd"), dict(
    b=1, sq=2048, skv=2048, seed=43, **_G8)))
DENSE_DECODE_CASES.append((gqa8_case("flash_decode"), dict(
    b=8, s=161, layout="bshd", lens=[159] * 8, seed=44, **_G8)))

# hymba-1.5b's 25/5 heads of 64 (GQA 5: 5 of the 8 rows of the kernels'
# 8-row instances), phase 9's model, window 1024 on 29 of its 32 layers:
# fastattn_fwd at (a)'s 8 x 2048 with the window (the kernels line's
# hymba_* numbers) and without (the 3 global layers), a ragged float32
# case with a q_offset, a kv_valid tail and the window; flash_decode at
# (b)'s B=8, kv_len 159 in both layouts (bshd: the kernels line's), and
# at B=1 on 4096 keys with the window narrower than the cache
HYMBA_ARCH = "hymba-1.5b"
# phase 9 runs its first HYMBA_LAYERS of 32 layers (global attention at 0
# and 15, the window on the rest), every gate at that depth: a cut for
# the script's time limit
HYMBA_LAYERS = 16


def hymba_case(kernel: str, variant: str = "main") -> str:
    """The name of ``kernel``'s phase-2 case at hymba-1.5b's shape:
    ``variant`` "main" (its main path's), "global" (fastattn_fwd without
    the window) or "window" (flash_decode on 4096 keys)."""
    tag = "hymba H=25/5 D=64"
    return {("fastattn_fwd", "main"): f"{tag} bf16 B=8 S=2048 causal "
            "window=1024",
            ("fastattn_fwd", "global"): f"{tag} bf16 B=8 S=2048 causal",
            ("flash_decode", "main"): f"{tag} bf16 B=8 bshd S=161 "
            "kv_len=159",
            ("flash_decode", "window"): f"{tag} bf16 B=1 bshd S=4096 "
            "window=1024"}[(kernel, variant)]


_HY = dict(hq=25, hkv=5, d=64)
FWD_CASES += [
    (hymba_case("fastattn_fwd"), dict(b=8, sq=2048, skv=2048, window=1024,
                                      dtype="bfloat16", seed=51, **_HY)),
    (hymba_case("fastattn_fwd", "global"), dict(
        b=8, sq=2048, skv=2048, dtype="bfloat16", seed=52, **_HY)),
    ("hymba H=25/5 D=64 f32 B=2 Sq=1000 Skv=1500 q_offset=300 "
     "kv_valid=1400 window=1024", dict(
         b=2, sq=1000, skv=1500, q_offset=300, kv_valid=1400, window=1024,
         dtype="float32", seed=53, **_HY))]
DENSE_DECODE_CASES += [
    (hymba_case("flash_decode"), dict(
        b=8, s=161, layout="bshd", lens=[159] * 8, dtype="bfloat16",
        seed=54, **_HY)),
    ("hymba H=25/5 D=64 bf16 B=8 bhsd S=161 kv_len=159", dict(
        b=8, s=161, layout="bhsd", lens=[159] * 8, dtype="bfloat16",
        seed=55, **_HY)),
    (hymba_case("flash_decode", "window"), dict(
        b=1, s=4096, layout="bshd", window=1024, dtype="bfloat16", seed=56,
        **_HY))]

# whisper-small's 12/12 heads of 64 (GQA 1), phase 10's model, bf16:
# fastattn_fwd non-causal at its three main-path shapes -- the encoder's
# 1500 x 1500, the teacher-forced decoder's cross-attention 448 x 1500,
# a decode step's 1 x 1500 (1500 = 23 x 64 + 28: a ragged last key
# sub-tile) -- and flash_decode at B=8 on a 512-slot cache at kv_len 64
# and at a ragged kv_len a row; SDPA's flash path with no mask on each
# (ragged kv_len: a jagged batch of each row's keys).
# The kernels line's whisper_* numbers.
WHISPER_ARCH = "whisper-small"


def whisper_case(kernel: str, variant: str) -> str:
    """The name of ``kernel``'s phase-2 case at whisper-small's shape:
    fastattn_fwd's "enc", "cross" or "step", flash_decode's "main"
    (kv_len 64) or "ragged"."""
    tag = "whisper H=12/12 D=64 bf16 B=8"
    return {("fastattn_fwd", "enc"): f"{tag} Sq=1500 Skv=1500 non-causal",
            ("fastattn_fwd", "cross"): f"{tag} Sq=448 Skv=1500 non-causal",
            ("fastattn_fwd", "step"): f"{tag} Sq=1 Skv=1500 non-causal",
            ("flash_decode", "main"): f"{tag} bshd S=512 kv_len=64",
            ("flash_decode", "ragged"): f"{tag} bshd S=512 ragged kv_len"}[
        (kernel, variant)]


WHISPER_CASES = (("fastattn_fwd", "enc"), ("fastattn_fwd", "cross"),
                 ("fastattn_fwd", "step"), ("flash_decode", "main"),
                 ("flash_decode", "ragged"))
_WH = dict(b=8, hq=12, hkv=12, d=64, dtype="bfloat16")
FWD_CASES += [(whisper_case("fastattn_fwd", v), dict(
    sq=sq, skv=1500, causal=False, seed=61 + i, **_WH))
    for i, (v, sq) in enumerate((("enc", 1500), ("cross", 448),
                                 ("step", 1)))]
DENSE_DECODE_CASES += [
    (whisper_case("flash_decode", "main"), dict(
        s=512, layout="bshd", lens=[64] * 8, lib="flash", seed=64, **_WH)),
    (whisper_case("flash_decode", "ragged"), dict(
        s=512, layout="bshd", lib="flash", seed=65, **_WH))]

# qwen2-vl-72b's 64/8 heads of 128 (GQA 8, twice qwen3-moe's heads: twice
# each launch's grid), phase 11's model, bf16: each attention kernel at its
# main path's shape there (the kernels line's vl_* numbers; flash_decode's
# from phase 11 (c)'s own caches, its phase-2 case as vl_case_*): paged
# decode at B=8 on 16 pages of 128, a chunk-512 prefill of 8 rows (ragged
# and padded rows), the causal forward at 1 x 2048, dense decode at B=8,
# kv_len 159
VL_ARCH = "qwen2-vl-72b"


def vl_case(kernel: str) -> str:
    """The name of ``kernel``'s phase-2 case at qwen2-vl's 64/8 heads."""
    tag = "qwen2-vl H=64/8 D=128 bf16"
    return {"paged_decode": f"{tag} B=8 ps=128",
            "paged_prefill": f"{tag} B=8 chunk=512 ps=128",
            "fastattn_fwd": f"{tag} B=1 S=2048 causal",
            "flash_decode": f"{tag} B=8 bshd S=161 kv_len=159"}[kernel]


_VL = dict(hq=64, hkv=8, d=128, dtype="bfloat16")
DECODE_CASES.append((vl_case("paged_decode"), dict(
    b=8, ps=128, n_kv=16, seed=71, **_VL)))
PREFILL_CASES.append((vl_case("paged_prefill"), dict(
    ps=128, n_kv=16, chunk=512, starts=[0, 512, 1024, 1536, 0, 512, 0, 0],
    nvalid=[512, 300, 512, 512, 37, 512, 0, 0], seed=72, **_VL)))
FWD_CASES.append((vl_case("fastattn_fwd"), dict(
    b=1, sq=2048, skv=2048, seed=73, **_VL)))
DENSE_DECODE_CASES.append((vl_case("flash_decode"), dict(
    b=8, s=161, layout="bshd", lens=[159] * 8, seed=74, **_VL)))

# phase 2's mLSTM cases: xlstm-125m's training shape first (the kernels
# line's numbers); then a ragged f32 case, S below the chunk, 16 chunks of
# state recurrence at a small dk/dv, a ragged S over eight chunks, and a
# forget bias of -2 (m falls across chunks, the stabiliser changes sign)
MLSTM_CASES = [
    ("xlstm-125m train B=8 H=4 S=2048 dk=dv=384 bf16 chunk=128 bshd",
     dict(b=8, h=4, s=2048, dk=384, dv=384, dtype="bfloat16",
          layout="bshd")),
    ("f32 B=2 H=3 S=1000 dk=64 dv=96 chunk=128 (ragged)",
     dict(b=2, h=3, s=1000, dk=64, dv=96, dtype="float32", seed=1)),
    ("bf16 B=2 H=4 S=77 dk=dv=384 chunk=128 (S below the chunk)",
     dict(b=2, h=4, s=77, dk=384, dv=384, dtype="bfloat16", layout="bshd",
          seed=2)),
    ("bf16 B=2 H=2 S=2048 dk=32 dv=48 chunk=128 (16 chunks)",
     dict(b=2, h=2, s=2048, dk=32, dv=48, dtype="bfloat16", seed=3)),
    ("bf16 B=2 H=4 S=1000 dk=dv=384 chunk=128 bshd (ragged, 8 chunks)",
     dict(b=2, h=4, s=1000, dk=384, dv=384, dtype="bfloat16",
          layout="bshd", seed=4)),
    ("bf16 B=2 H=4 S=2048 dk=dv=384 chunk=128 forget bias -2",
     dict(b=2, h=4, s=2048, dk=384, dv=384, dtype="bfloat16", fbias=-2.0,
          seed=5)),
]


# phase 12's (data=2, model=2) rank shapes, each at model rank 1 and a
# rank's 2 batch rows: xlstm-125m's mLSTM at 2 of 4 heads on the gathered
# 1024 rows; fastattn_fwd at each shape phase 12 launches it -- whisper's
# encoder, 750 of 1500 frames against all 1500 (non-causal: the offset
# does not mask), hymba's context-parallel rows, 512 at q_offset 512
# against 1024 keys with hymba_local's window 1024, whisper's decoder,
# 224 causal rows at q_offset 224 against 448 keys, and its
# cross-attention, 224 rows against 1500 frames (the kernels line's
# mesh_*, mesh_hymba_*, mesh_dec_*, mesh_cross_*)
MESH_MLSTM_CASE = ("xlstm-125m (2,2) rank B=2 H=2 S=1024 dk=dv=384 bf16 "
                   "chunk=128 bshd")
MLSTM_CASES.append((MESH_MLSTM_CASE, dict(b=2, h=2, s=1024, dk=384, dv=384,
                                          dtype="bfloat16", layout="bshd",
                                          seed=6)))
_MW = dict(b=2, hq=12, hkv=12, d=64, dtype="bfloat16")
MESH_FWD_CASES = {
    "mesh": ("whisper (2,2) rank H=12/12 D=64 bf16 B=2 Sq=750 Skv=1500 "
             "non-causal q_offset=750", dict(
                 sq=750, skv=1500, causal=False, q_offset=750, seed=81,
                 **_MW)),
    "mesh_hymba": ("hymba (2,2) rank H=25/5 D=64 bf16 B=2 Sq=512 Skv=1024 "
                   "causal q_offset=512 window=1024", dict(
                       b=2, sq=512, skv=1024, q_offset=512, window=1024,
                       dtype="bfloat16", seed=82, **_HY)),
    "mesh_dec": ("whisper (2,2) rank H=12/12 D=64 bf16 B=2 Sq=224 Skv=448 "
                 "causal q_offset=224", dict(
                     sq=224, skv=448, q_offset=224, seed=83, **_MW)),
    "mesh_cross": ("whisper (2,2) rank H=12/12 D=64 bf16 B=2 Sq=224 "
                   "Skv=1500 non-causal", dict(
                       sq=224, skv=1500, causal=False, seed=84, **_MW))}
FWD_CASES += list(MESH_FWD_CASES.values())


def phase_kernels() -> dict:
    """Every kernel against its plain version.  Returns the main-path
    numbers of each kernel."""
    fwds = {name: fwd_case(name, **kw)
            for name, kw in FWD_CASES + list(CONTEXT_CASES.values())}
    decs = {name: decode_case(name, **kw) for name, kw in DECODE_CASES}
    pres = {name: prefill_case(name, **kw) for name, kw in PREFILL_CASES}
    dense = {name: dense_decode_case(name, **kw)
             for name, kw in DENSE_DECODE_CASES}
    cp = {pre: dense_slice_case(name, **kw)
          for pre, (name, kw) in CP_SLICE_CASES.items()}
    mls = {name: mlstm_case(name, **kw) for name, kw in MLSTM_CASES}
    # flash_decode's numbers for the kernels line are taken at the main
    # path's own shape, in phase 3b (D = 128) and 7 (b) (D = 80, 96); its
    # long_* keys at LONG_DECODE and its head-dim cases
    every = {"paged_decode": decs, "paged_prefill": pres,
             "fastattn_fwd": fwds, "flash_decode": dense}
    return {"paged_decode": decs[DECODE_CASES[0][0]],
            "paged_prefill": pres[PREFILL_CASES[0][0]],
            "fastattn_fwd": fwds[FWD_CASES[0][0]],
            "mlstm_chunkwise": mls[MLSTM_CASES[0][0]],
            "mesh": {"mlstm_chunkwise": {"mesh": mls[MESH_MLSTM_CASE]},
                     "fastattn_fwd": {pre: fwds[name] for pre, (name, _)
                                      in MESH_FWD_CASES.items()}},
            "flash_decode_long": dense[LONG_DECODE],
            "flash_decode_cp": cp,
            "paged_prefill_verify": pres[VERIFY_CASE],
            "fastattn_context": {m: fwds[name] for m, (name, _) in
                                 CONTEXT_CASES.items()},
            "head_dims": {(k, d): every[k][head_dim_case(k, d)]
                          for k in every for d in HEAD_DIM_ARCHS},
            "gqa8": {k: every[k][gqa8_case(k)] for k in every},
            "hymba": {(k, v): every[k][hymba_case(k, v)] for k, v in (
                ("fastattn_fwd", "main"), ("fastattn_fwd", "global"),
                ("flash_decode", "main"), ("flash_decode", "window"))},
            "whisper": {(k, v): every[k][whisper_case(k, v)]
                        for k, v in WHISPER_CASES},
            "vl": {k: every[k][vl_case(k)] for k in every}}


# ---------------------------------------------------------------------------
# phase 3: serving llama2-7b
# ---------------------------------------------------------------------------

def build_llama():
    """llama2-7b at full width and depth, random weights from seed 0."""
    return build_full("llama2-7b")


def build_full(arch: str, layers: int = None):
    """``arch`` at full width and depth (or its first ``layers``), random
    weights from a CUDA generator seeded with 0."""
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.models import build_model
    cfg = get_model_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers))
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f}B params ({cfg.param_dtype}) "
        f"initialised in {time.perf_counter() - t0:.1f}s")
    return model, params


# phase 3's engine and traffic (also phase 3e's)
SERVE_3 = dict(max_batch=8, max_seq_len=2048, page_size=128,
               prefill_chunk=512)
SERVE_3_NEW = 32                # new tokens a request


def phase_serving(model, params, n_requests: int = 12,
                  new_tokens: int = SERVE_3_NEW,
                  rel_tol: float = None) -> dict:
    """Phase 3's 12 requests on ``model``; the first chunk and one decode
    step then within ``rel_tol`` (LOGIT_TOL by default) of the plain
    attention path (``check_against_plain``).  On a MoE model each
    prefill launch's share of (valid token, expert) assignments dropped
    by capacity is recorded (``moe_drops``)."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.serving.scheduler import FINISHED, SamplingParams

    cfg = model.cfg
    serve = ServeConfig(**SERVE_3)
    core = _make_timed_core()(model, params, cfg, serve, device="cuda")
    prompts, lens = serve_traffic(cfg.vocab_size, n_requests)
    greedy = SamplingParams(max_new_tokens=new_tokens)

    paged_flash_decode.launches = 0
    fastattn_paged_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with counting_drops(model) as drops:
        t0 = time.perf_counter()
        ids = [core.add_request(p, greedy) for p in prompts]
        tokens = {i: [] for i in ids}
        while core.has_work:
            for ev in core.step():
                if ev.kind != "token":
                    raise AssertionError(f"request {ev.request_id}: {ev}")
                tokens[ev.request_id].append(ev.token)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_flash_decode.launches,
                "paged_prefill": fastattn_paged_prefill.launches}
    stats = core.stats()
    log(f"[serve] launches on the main path: {launches}")
    for rid, req_len in zip(ids, lens):
        toks = tokens[rid]
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if stats["finished"] != n_requests or any(
            r.state != FINISHED for r in core.sched.finished):
        raise AssertionError("a request did not finish")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if stats["pages_used"] != 0:
        raise AssertionError(f"{stats['pages_used']} pages leaked")
    dev = core.device_seconds()
    pre_s, dec_s = dev["prefill"], dev["decode"]
    n_prompt = int(lens.sum())
    n_decode = n_requests * (new_tokens - 1)
    out = {"requests": n_requests, "prompt_tokens": n_prompt,
           "decode_tokens": n_decode, "steps": stats["steps"],
           "prefill_launches": stats["prefill_launches"],
           "decode_launches": stats["decode_launches"],
           "pages_peak": stats["pages_peak"],
           "pages_used": stats["pages_used"], "pool_pages":
           serve.pool_pages(), "wall_s": wall,
           "prefill_device_s": pre_s, "decode_device_s": dec_s,
           "prefill_tok_s": n_prompt / pre_s,
           "decode_tok_s": n_decode / dec_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    if drops.active:
        out["moe_drops"] = drops.shares()
        out["moe_drops_by_layer"] = drops.layer_shares()
        log(f"[serve] MoE assignments dropped by capacity, each prefill "
            f"launch (valid tokens): {out['moe_drops']}; each layer over "
            f"the launches: {out['moe_drops_by_layer']}")
    log(f"[serve] {n_requests} requests ({n_prompt} prompt tokens, "
        f"{n_decode} decode tokens) in {stats['steps']} steps, "
        f"{wall:.2f}s wall; prefill {out['prefill_tok_s']:.0f} tok/s "
        f"({pre_s:.3f}s device), decode {out['decode_tok_s']:.1f} tok/s "
        f"({dec_s:.3f}s device); peak pages {stats['pages_peak']}/"
        f"{serve.pool_pages() - 1}; peak memory {out['peak_mem_gb']:.1f} GB")
    log("[serve] " + json.dumps({k: v for k, v in out.items()}))
    check_against_plain(model, params, prompts[0], tokens[ids[0]][0],
                        rel_tol=rel_tol)
    return out


def serve_traffic(vocab: int, n_requests: int = 12):
    """Phase 3's prompts (numpy seed 0): 37-1800 tokens each."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(37, 1801, size=n_requests)
    return [rng.integers(0, vocab, size=int(n)) for n in lens], lens


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _make_timed_core():
    from repro_torch.serving.core import EngineCore

    class TimedCore(EngineCore):
        """EngineCore that brackets every prefill, decode, verify and scan
        launch with CUDA events, so their device time is read without
        extra synchronisation on the serving path, and counts the prefill
        kernel's launches made by verify launches."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._ev = {"prefill": [], "decode": [], "verify": [],
                        "scan": []}
            self.verify_kernel_launches = 0

        def _timed(self, kind, fn, *args):
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self._ev[kind].append((start, end))
            return out

        def _prefill(self, *args):
            return self._timed("prefill", super()._prefill, *args)

        def _decode(self, *args):
            return self._timed("decode", super()._decode, *args)

        def _verify(self, *args):
            from repro_torch.kernels.fastattn.ops import \
                fastattn_paged_prefill
            before = fastattn_paged_prefill.launches
            out = self._timed("verify", super()._verify, *args)
            self.verify_kernel_launches += (fastattn_paged_prefill.launches
                                            - before)
            return out

        def _scan(self, *args):
            return self._timed("scan", super()._scan, *args)

        def device_seconds(self) -> dict:
            import torch
            torch.cuda.synchronize()
            return {k: sum(s.elapsed_time(e) for s, e in ev) / 1e3
                    for k, ev in self._ev.items()}

    return TimedCore


def first_chunk_and_step(model, params, prompt, impl):
    """The first chunk (512 tokens at most) of ``prompt`` on fresh pools,
    then one decode step of its greedy token, through ``impl``: (last
    valid row's logits, the step's logits), float32."""
    import torch
    ps, chunk, n_kv = 128, 512, 16
    n = min(len(prompt), chunk)
    i32 = dict(dtype=torch.int32, device=model.device)
    toks = torch.zeros((1, chunk), **i32)
    toks[0, :n] = torch.from_numpy(prompt[:n]).to(model.device)
    table = torch.zeros((1, n_kv), **i32)
    table[0, :8] = torch.arange(1, 9, dtype=torch.int32)
    z = torch.zeros((1,), **i32)
    nv = torch.full((1,), n, **i32)
    pools = model.init_paged_cache(9, ps)
    logits, pools = model.prefill_chunk_paged(
        params, toks, pools, table, z, nv, impl=impl)
    last = logits[0, n - 1].float()
    tok = torch.argmax(last).to(torch.int32).reshape(1)
    dl, _ = model.decode_step_paged(params, tok, pools, table, nv, impl=impl)
    return last, dl[0].float()


def check_against_plain(model, params, prompt, first_token,
                        rel_tol: float = None) -> None:
    """The first request's first chunk, then one decode step, through the
    kernels and through the plain attention path on fresh pools: the
    last-row logits must agree within ``rel_tol`` (LOGIT_TOL by default)
    of the logits' scale, and the greedy tokens wherever the plain path's
    top-1 margin exceeds that tolerance."""
    import torch
    rel_tol = rel_tol or LOGIT_TOL
    n = min(len(prompt), 512)
    res = {impl: first_chunk_and_step(model, params, prompt, impl)
           for impl in ("paged", "paged_reference")}
    for what, i in (("prefill last row", 0), ("decode step", 1)):
        got, ref = res["paged"][i], res["paged_reference"][i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite logits")
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        tol = rel_tol * scale
        top2 = torch.topk(ref, 2).values
        margin = (top2[0] - top2[1]).item()
        same = int(torch.argmax(got)) == int(torch.argmax(ref))
        log(f"[serve] kernels vs plain, {what}: max_abs_err {err:.4f} "
            f"(tol {tol:.4f} = {rel_tol:.4g} x max|logit| {scale:.3f}), "
            f"top-1 margin {margin:.4f}, same greedy token {same}")
        if not err <= tol:
            raise AssertionError(f"{what}: logits differ by {err} > {tol}")
        if margin > tol and not same:
            raise AssertionError(f"{what}: greedy tokens differ")
    if n == len(prompt) and int(torch.argmax(res["paged"][0])) != first_token:
        log("[serve] note: engine's first token differs from the fresh-pool "
            "rerun (batched launch rounding)")


# bf16 activations through 32 layers: the two attention paths round their
# outputs to bf16 at different points, so the logits drift by a few
# percent of their scale at most.
LOGIT_TOL = 0.05

# ---------------------------------------------------------------------------
# phase 3b: dense generation on llama2-7b
# ---------------------------------------------------------------------------

DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 8, 128, 32
DENSE_CHECK_POS = (0, 1, 2, 3, 36, 37, 38, 39)


def _compare_logits(what, got, ref, rel_tol: float = None) -> None:
    """Hold kernel-path logits ``got`` (B, V) to ``ref``: within
    ``rel_tol`` (LOGIT_TOL by default) of ``ref``'s scale, and the same
    greedy token in every row whose top-1 margin exceeds that
    tolerance."""
    import torch
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    tol = (rel_tol or LOGIT_TOL) * scale
    if not err <= tol:
        raise AssertionError(f"{what}: logits differ by {err} > {tol}")
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = torch.argmax(got, -1) == torch.argmax(ref, -1)
    if bool((clear & ~same).any()):
        raise AssertionError(f"{what}: greedy tokens differ")
    log(f"{what}: max_abs_err {err:.4f} (tol {tol:.4f}), greedy "
        f"tokens equal in {int(clear.sum())} rows with a clear margin")


def phase_dense(model, params, rel_tol: float = None,
                paged_model=None) -> dict:
    """ServeEngine.generate on phase 3's llama2-7b: B=8 prompts of 128
    tokens, 32 greedy new tokens, dense caches through flash_decode.
    ``rel_tol`` (LOGIT_TOL by default) bounds the kernel-vs-plain logits
    and the margin rule.  On a MoE model no valid token's assignment may
    drop in generate or in the paged engine's run (``drop_gate``): the
    two then route the same tokens alike, or their tokens could not be
    compared.  ``paged_model`` (default ``model``) is the model the
    paged engine runs on ``params``."""
    rel_tol = rel_tol or LOGIT_TOL
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import SamplingParams

    cfg = model.cfg
    b, s, n_new = DENSE_BATCH, DENSE_PROMPT, DENSE_NEW
    serve = ServeConfig(max_seq_len=s + n_new + 1, top_k=1)
    engine = ServeEngine(model=model, params=params, cfg=cfg, serve=serve)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(b, s))
    cache_gb = 2 * cfg.num_layers * b * serve.max_seq_len * cfg.kv_dim \
        * 2 / 1e9
    # the logits each generated token was sampled from, for the margins,
    # and the dense caches as generate left them
    seen, last_cache = [], []
    decode = engine._decode

    def recording(tok, cache, pos):
        logits, cache = decode(tok, cache, pos)
        if pos >= s - 1:
            seen.append(logits.float())
        last_cache[:] = [cache]
        return logits, cache
    engine._decode = recording

    torch.cuda.synchronize()
    flash_decode.launches = 0
    with counting_drops(model) as gen_drops:
        t0 = time.perf_counter()
        out = engine.generate(prompts, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = flash_decode.launches
    engine._decode = decode
    expected = cfg.num_layers * (s + n_new - 1)
    log(f"[dense] generate: B={b} x {s} prompt tokens, {n_new} new, dense "
        f"cache {cache_gb:.2f} GB, {wall:.2f}s wall; flash_decode launches "
        f"{launches} (expected {cfg.num_layers} layers x ({s} prompt + "
        f"{n_new - 1} decode steps) = {expected})")
    if launches != expected:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {expected}")
    out = out.cpu().numpy()
    if out.shape != (b, n_new) or not ((0 <= out) & (out < cfg.vocab_size)
                                       ).all():
        raise AssertionError(f"bad generated tokens {out.shape}")

    # the kernel against its plain version at the main path's own shape:
    # generate's caches (B=8, 161 token rows, "bshd") of the first and the
    # last layer, at the last step's kv_len (prompt + new - 1 = 159); the
    # first layer's numbers are the kernels line's
    cache, = last_cache
    del last_cache
    kv_len = s + n_new - 1
    lens = np.full((b,), kv_len, np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kern = None
    for layer in (0, cfg.num_layers - 1):
        q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(cache[layer].k.dtype)
        what = (f"generate's layer-{layer} cache B={b} "
                f"S={serve.max_seq_len} kv_len={kv_len} bshd")
        if kern is None:
            kern = dense_decode_measure(what, q, cache[layer].k,
                                        cache[layer].v, lens,
                                        dtype="bfloat16", layout="bshd")
            continue
        out_k = flash_decode(q, cache[layer].k, cache[layer].v,
                             torch.from_numpy(lens).cuda(), layout="bshd")
        ref_k = decode_reference(q[:, :, None], cache[layer].k,
                                 cache[layer].v, torch.from_numpy(lens),
                                 layout="bshd")[:, :, 0]
        held_to_plain("flash_decode", what, out_k.reshape(-1, cfg.head_dim),
                      ref_k.reshape(-1, cfg.head_dim), "bfloat16")
    # the RMS of the K and V rows generate wrote, per layer: phase 3c
    # fills its long cache to these scales
    kv_rms = [[t[:, :kv_len].float().square().mean().sqrt().item()
               for t in (c.k, c.v)] for c in cache]
    del cache

    # the same prompts through the paged EngineCore: equal greedy tokens
    # wherever the dense path's top-1 margin exceeds the tolerance; the
    # streams may fork only at a near-tie, after which contexts differ
    paged_model = paged_model or model
    core = EngineCore(paged_model, params, paged_model.cfg, ServeConfig(
        max_batch=b, max_seq_len=s + n_new + 128, page_size=128,
        prefill_chunk=512), device="cuda")
    ids = [core.add_request(p, SamplingParams(max_new_tokens=n_new))
           for p in prompts]
    paged = {i: [] for i in ids}
    with counting_drops(paged_model) as paged_drops:
        while core.has_work:
            for ev in core.step():
                if ev.kind != "token":
                    raise AssertionError(f"request {ev.request_id}: {ev}")
                paged[ev.request_id].append(ev.token)
    if paged_drops.active:
        drop_gate("[dense] generate's decode steps", gen_drops)
        drop_gate("[dense] the paged engine's prefill", paged_drops)
    logits = torch.stack(seen, dim=1)                 # (B, n_new, V)
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tol = rel_tol * logits.abs().amax(dim=-1).cpu().numpy()
    compared = equal = 0
    for row, rid in enumerate(ids):
        for t in range(n_new):
            clear = margin[row, t] > tol[row, t]
            if paged[rid][t] != out[row, t]:
                if clear:
                    raise AssertionError(
                        f"row {row} token {t}: paged {paged[rid][t]} != "
                        f"dense {out[row, t]} at margin {margin[row, t]}")
                break                   # forked at a near-tie
            equal += 1
            compared += int(clear)
    log(f"[dense] paged EngineCore vs dense generate: {equal} of "
        f"{b * n_new} greedy tokens equal before the streams fork at a "
        f"near-tie, {compared} of them with a top-1 margin above the "
        "tolerance")
    del core, logits, seen

    # kernel vs plain attention path, each teacher-forced on its own
    # cache: the first 4 prompt positions, and 4 past one 32-key pass of
    # the kernel's thread groups (flash_decode.cu)
    caches = {impl: model.init_cache(b, serve.max_seq_len)
              for impl in ("kernel", "reference")}
    toks = torch.from_numpy(prompts).cuda()
    for pos in range(DENSE_CHECK_POS[-1] + 1):
        res = {}
        for impl, cache in caches.items():
            res[impl], _ = model.decode_step(params, toks[:, pos], cache,
                                             pos, impl=impl)
        if pos in DENSE_CHECK_POS:
            _compare_logits(f"[dense] decode_step pos {pos}, kernel vs "
                            "plain",
                            res["kernel"], res["reference"], rel_tol)
    del caches
    tok_s = engine.throughput_tokens_per_s(b, s, n_new=8)
    res = {"batch": b, "prompt": s, "new_tokens": n_new,
           "wall_s": wall, "tokens_per_s_generate": b * n_new / wall,
           "throughput_tokens_per_s": tok_s, "launches": launches,
           "tokens_equal": equal, "tokens_clear": compared,
           "cache_gb": cache_gb, "kernel": kern, "kv_rms": kv_rms}
    log(f"[dense] generate {res['tokens_per_s_generate']:.1f} new tok/s "
        f"(prompt teacher-forced one position a step); "
        f"throughput_tokens_per_s(B={b}, prompt {s}, 8 steps) "
        f"{tok_s:.1f} tok/s")
    log("[dense] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 3c: one long-context decode step of llama2-7b
# ---------------------------------------------------------------------------

LONG_KV = 65536       # kv_len of the step: the token at position LONG_KV - 1


def phase_long_decode(model, params, kv_rms) -> dict:
    """One ``LM.decode_step`` of phase 3's llama2-7b at B=1 on a dense
    cache of LONG_KV + 1 tokens, at position LONG_KV - 1 (kv_len
    LONG_KV): every layer's K/V drawn from a seeded CUDA generator at the
    RMS of what phase 3b's generate wrote (``kv_rms``), then the step
    through flash_decode (exactly one launch a layer) and through the
    plain attention path, logits held to each other; then the kernel
    step's wall time (median of 10, synchronised) and one profiled step:
    its device time and flash_decode's share."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode.ops import flash_decode

    cfg = model.cfg
    gc.collect()                  # phase 3's engines and pools
    torch.cuda.empty_cache()
    pos = LONG_KV - 1
    t0 = time.perf_counter()
    cache = model.init_cache(1, LONG_KV + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for c, rms in zip(cache, kv_rms):
        for buf, r in zip((c.k, c.v), rms):
            buf.copy_(torch.randn(buf.shape, generator=gen,
                                  device="cuda").mul_(r))
    torch.cuda.synchronize()
    cache_gb = sum(c.k.nbytes + c.v.nbytes for c in cache) / 1e9
    log(f"[long] {cfg.name}: dense cache B=1 x {LONG_KV + 1} tokens, "
        f"{cache_gb:.1f} GB, filled at generate's K/V RMS in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1,)).astype(np.int32)).cuda()

    def step(impl):
        return model.decode_step(params, tok, cache, pos, impl=impl)[0]

    flash_decode.launches = 0
    got = step("kernel")
    torch.cuda.synchronize()
    launches = flash_decode.launches
    log(f"[long] decode_step at position {pos} (kv_len {LONG_KV}): "
        f"flash_decode launches {launches} (expected {cfg.num_layers}, one "
        "a layer)")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {cfg.num_layers}")
    ref = step("reference")
    _compare_logits(f"[long] decode step kv_len {LONG_KV}, kernel "
                    "vs plain", got, ref)
    wall_ms, _ = _wall_ms(lambda: step("kernel"))
    plain_ms, _ = _wall_ms(lambda: step("reference"), reps=3)
    kernels, dev_s = _profile_kernels(lambda: step("kernel"))
    fd = [e for e in kernels if "flash_decode_" in e.key]
    fd_s = sum(_device_us(e) for e in fd) / 1e6
    # least time of the step: every weight read once (bf16; of an untied
    # embedding table only the token's row) and every layer's kv_len K/V
    # rows read once
    n_params = sum(t.numel() for t in _leaves(params))
    if not cfg.tie_embeddings:
        n_params -= params["embedding"]["embed"].numel() - cfg.d_model
    step_bytes = n_params * 2 + cfg.num_layers * 2 * LONG_KV \
        * cfg.kv_dim * 2
    res = {"kv_len": LONG_KV, "cache_gb": cache_gb, "launches": launches,
           "wall_ms": wall_ms, "plain_wall_ms": plain_ms,
           "device_ms": dev_s * 1e3, "flash_decode_device_ms": fd_s * 1e3,
           "flash_decode_calls": sum(e.count for e in fd),
           "flash_decode_share_of_device": fd_s / dev_s,
           "idle_share": 1 - dev_s * 1e3 / wall_ms,
           "bound_ms": step_bytes / H100_BYTES_PER_S * 1e3,
           "step_bytes": step_bytes, "card": _card()}
    log(f"[long] {res['card']}: step {wall_ms:.2f} ms wall (median of 10; "
        f"plain attention path {plain_ms:.2f} ms), {res['device_ms']:.2f} "
        f"ms of kernels in one profiled step (idle share "
        f"{res['idle_share']:.3f}); flash_decode {fd_s * 1e3:.3f} ms in "
        f"{res['flash_decode_calls']} launches, "
        f"{res['flash_decode_share_of_device']:.1%} of the device time; "
        f"the step's byte bound {res['bound_ms']:.2f} ms")
    groups = {}
    for e in kernels:
        grp = ("attention: flash_decode.cu" if "flash_decode_" in e.key
               else _train_group(e.key))
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e3
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[long]   {ms:9.3f} ms  {grp}")
    log("[long] " + json.dumps(res))
    del cache
    return res


# ---------------------------------------------------------------------------
# phase 3d: the rest of the paged engine on llama2-7b
# ---------------------------------------------------------------------------

FEATURE_SERVE = dict(max_batch=8, max_seq_len=2048, page_size=128,
                     prefill_chunk=512)
SYSTEM_LEN = 1024           # (a), (d): a shared system prompt of 8 pages
PRESSURE_FRAC = 0.6         # (b): the pool over the worst-case demand
HOST_POOL_PAGES = 48        # (b): 3.2 GB of pinned host stash at most
# (d): the one call of each fault site that fails
FAULT_CALLS = {"page_alloc": 7, "swap_d2h": 1, "swap_h2d": 1,
               "cow_copy": 1, "prefill_launch": 3, "decode_launch": 5,
               "sample": 9, "spec_verify": 2}
# (d): the sites whose fault always fails the request it hit (a
# page_alloc fault may instead unwind an admission, which retries)
FAILING_SITES = ("cow_copy", "sample")


def _motif(rng, vocab, n, period=5):
    import numpy as np
    motif = rng.integers(1, vocab, size=period).tolist()
    return np.array((motif * (n // period + 1))[:n], np.int32)


def feature_traffic(vocab: int) -> dict:
    """Phase 3d's traffic, ``{run: [wave of (request id, prompt,
    max_new_tokens)]}``, from numpy seeds alone."""
    import numpy as np
    rng = np.random.default_rng(31)
    system = rng.integers(0, vocab, size=SYSTEM_LEN)
    tails = rng.integers(64, 449, size=8)
    prefix = [[(i, np.concatenate([system, rng.integers(
        0, vocab, size=int(tails[i]))]), 32) for i in range(w, w + 4)]
        for w in (0, 4)]
    rng = np.random.default_rng(32)
    pressure = [[(i, rng.integers(0, vocab, size=int(n)), 128)
                 for i, n in enumerate(rng.integers(1200, 1801, size=8))]]
    rng = np.random.default_rng(33)
    spec = [[(i, _motif(rng, vocab, 256), 64) for i in range(8)]]
    # (d): motif tails on the system prompt; the second wave also serves
    # the system prompt alone -- fully cached and page-aligned, so its
    # last token is recomputed into a copy of its shared tail page
    rng = np.random.default_rng(34)
    faults = [[(i, np.concatenate([system, _motif(rng, vocab, int(n))]),
                32) for i, n in zip(range(w, w + 4),
                                    rng.integers(64, 449, size=4))]
              for w in (0, 4)]
    faults[1][-1] = (7, system.copy(), 32)
    rng = np.random.default_rng(35)
    scan = [[(0, rng.integers(0, vocab, size=128), 16)]]
    return {"prefix": prefix, "pressure": pressure, "spec": spec,
            "faults": faults, "scan": scan}


def worst_pages(waves, page_size: int) -> int:
    return sum(-(-(len(p) + n) // page_size) for w in waves
               for _, p, n in w)


def tokens_gate(what, got: dict, ref: dict, margins: dict) -> tuple:
    """Phase 3b's rule: ``got``'s greedy tokens equal the reference run's
    up to the first position whose top-1 margin in the reference logits
    (``margins[(request id, index)] = (margin, tol)``) is under the
    tolerance; a clear-margin mismatch fails.  Returns (tokens equal
    before any fork, tokens compared)."""
    equal = total = 0
    for rid, want in ref.items():
        toks = got[rid]
        total += len(want)
        if len(toks) != len(want):
            raise AssertionError(f"{what}: request {rid} gave {len(toks)} "
                                 f"tokens, the reference {len(want)}")
        for t, (a, b) in enumerate(zip(toks, want)):
            if a != b:
                margin, tol = margins[(rid, t)]
                if margin > tol:
                    raise AssertionError(
                        f"{what}: request {rid} token {t}: {a} != {b} at "
                        f"margin {margin:.4f} > tol {tol:.4f}")
                break                   # forked at a near-tie
            equal += 1
    return equal, total


def launch_gate(what, launches: dict, kernels) -> None:
    """Every kernel of the run's path launched in it."""
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: "
                             f"{launches}")


def leak_gate(what, stats: dict, host_stash: int) -> None:
    """Nothing but the prefix index holds a page, and no swap stash
    survives."""
    cached = stats.get("prefix_cached_pages", 0)
    if stats["pages_used"] != cached or stats["active_slots"] or host_stash:
        raise AssertionError(
            f"{what}: {stats['pages_used']} pages used beside "
            f"{cached} cached, {stats['active_slots']} slots busy, "
            f"{host_stash} host stashes left")


def pressure_gate(what, stats: dict) -> None:
    p = stats["pressure"]
    if p["preemptions"] <= 0:
        raise AssertionError(f"{what}: the pool was never pressured")
    if p["swap_bytes_in"] != p["swap_bytes_out"]:
        raise AssertionError(f"{what}: swapped out {p['swap_bytes_out']} "
                             f"bytes, back in {p['swap_bytes_in']}")


def prefix_gate(what, stats: dict, warm: list, system_len: int) -> int:
    """Prefix hits, and the warm wave (``warm``: (prompt length,
    matched_len) a request) prefilling at least the shared system prompt
    fewer tokens than its prompts hold.  Returns the tokens it
    prefilled."""
    if stats["prefix"]["hits"] <= 0:
        raise AssertionError(f"{what}: no prefix hit")
    prompt = sum(n for n, _ in warm)
    computed = sum(n - m for n, m in warm)
    if computed > prompt - len(warm) * system_len:
        raise AssertionError(
            f"{what}: the warm wave prefilled {computed} of {prompt} "
            f"prompt tokens; the shared {system_len} a request should "
            "have been cached")
    return computed


def spec_gate(what, stats: dict) -> None:
    sp = stats["spec"]
    if sp["verify_launches"] <= 0 or sp["drafted"] <= 0:
        raise AssertionError(f"{what}: {sp['verify_launches']} verify "
                             f"launches, {sp['drafted']} drafted tokens")


def fault_gate(what, errors: dict, fired_log: list) -> None:
    """Every failed request names an injected fault of the log, each at
    most once, and every fault at FAILING_SITES failed one.  A request
    that failed for any other reason fails the run: a kernel fault must
    not hide behind the engine's request isolation."""
    fired = set(fired_log)
    named = []
    for rid, detail in errors.items():
        m = re.fullmatch(r"injected: injected fault at (\w+) \(call (\d+)\)",
                         detail)
        if m is None or (m.group(1), int(m.group(2))) not in fired:
            raise AssertionError(f"{what}: request {rid} failed for "
                                 f"another reason: {detail}")
        named.append((m.group(1), int(m.group(2))))
    if len(set(named)) != len(named):
        raise AssertionError(f"{what}: one fault failed two requests: "
                             f"{errors}")
    unnamed = [f for f in fired_log if f[0] in FAILING_SITES
               and f not in named]
    if unnamed:
        raise AssertionError(f"{what}: faults {unnamed} failed no request")


def failure_gate(what, errors: dict, stats: dict, armed: bool) -> None:
    """A run without an injector fails no request and records no error,
    so that no fault of a kernel hides behind the engine's request
    isolation.  An armed run reports every request it failed as an error
    event, for fault_gate to name, and sheds or times out none."""
    h = stats["health"]
    if armed:
        if h["failed"] != len(errors) or h["shed"] or h["timed_out"]:
            raise AssertionError(
                f"{what}: {h['failed']} failed, {h['shed']} shed, "
                f"{h['timed_out']} timed out; error events {errors}")
    elif errors or h["failed"] or h["shed"] or h["timed_out"] or \
            h["last_error"] is not None:
        raise AssertionError(f"{what}: requests failed with no fault "
                             f"armed: {errors}, last error "
                             f"{h['last_error']}")


def _make_feature_core():
    import torch
    from repro_torch.serving.scheduler import RUNNING

    class FeatureCore(_make_timed_core()):
        """TimedCore that records, when ``record`` is set, the top-1
        margin of every row a greedy token is taken from (in its wall
        time) and the first prefill launch's logits (the reference runs
        of phases 3d and 3e), and holds its first verify launch to the
        same launch through the plain attention path (``check_verify``).
        The seconds of the logits' copy and of the check (the pool
        clone, the plain launch and the comparison, each waited on) add
        up in ``check_s``, which the run takes off its wall time."""

        def __init__(self, *a, record=False, check_verify=False, **kw):
            super().__init__(*a, **kw)
            self.record = record
            self.check_verify = check_verify
            self.margins = {}
            # the first verify launch, and the first with every row in it
            self.verify_check = {}
            self.first_prefill = None   # the first launch's last-row logits
            self.check_s = 0.0

        def _note(self, keys, logits):
            lf = logits.float()
            top2 = torch.topk(lf, 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().tolist()
            tol = (LOGIT_TOL * lf.abs().amax(dim=-1)).cpu().tolist()
            for i, key in keys:
                self.margins[key] = (margin[i], tol[i])

        def _prefill(self, *args):
            out = super()._prefill(*args)
            if self.record and self.first_prefill is None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self.first_prefill = out.float().cpu()
                self.check_s += time.perf_counter() - t0
            return out

        def _first_token(self, req, slot, last_logits, events):
            if self.record:
                self._note([(0, (req.id, len(req.generated)))],
                           last_logits.reshape(1, -1))
            return super()._first_token(req, slot, last_logits, events)

        def _decode(self, table, pos):
            logits = super()._decode(table, pos)
            if self.record:
                self._note([(s, (r.id, len(r.generated)))
                            for s, r in enumerate(self.sched.slots)
                            if r is not None and r.state == RUNNING
                            and not r.done], logits)
            return logits

        def _verify(self, buf, table, pos0, nval):
            which = ("first" if "first" not in self.verify_check else
                     "full" if "full" not in self.verify_check
                     and (nval > 0).all() else None)
            if not self.check_verify or which is None:
                return super()._verify(buf, table, pos0, nval)
            # the pools as the launch finds them, for the plain launch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = [type(c)(*(t.clone() for t in c)) for c in self.pools]
            torch.cuda.synchronize()
            self.check_s += time.perf_counter() - t0
            got = super()._verify(buf, table, pos0, nval)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, _ = self.model.prefill_chunk_paged(
                self.params, self._to_device(buf), before,
                self._to_device(table), self._to_device(pos0),
                self._to_device(nval), impl="paged_reference")
            del before
            rows = [(b, r) for b, n in enumerate(nval) for r in range(n)]
            idx = torch.tensor(rows, device=got.device)
            _compare_logits(
                f"[3d] {which} verify launch ({len(rows)} valid rows of "
                f"{tuple(buf.shape)}, pos_start {pos0.tolist()}, n_valid "
                f"{nval.tolist()}), kernel vs plain",
                got[idx[:, 0], idx[:, 1]], ref[idx[:, 0], idx[:, 1]])
            self.verify_check[which] = {"rows": len(rows),
                                        "pos0": pos0.tolist(),
                                        "nval": nval.tolist()}
            self.check_s += time.perf_counter() - t0
            return got

    return FeatureCore


def _feature_run(name, model, params, waves, *, injector=None,
                 record=False, check_verify=False, **serve_kw) -> dict:
    """One engine run of phase 3d: a fresh core, the kernel counts set to
    0 just before the traffic and read just after it, then the run's
    numbers, printed on one line."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.serving.scheduler import SamplingParams

    serve = ServeConfig(**{**FEATURE_SERVE, **serve_kw})
    core = _make_feature_core()(model, params, model.cfg, serve,
                                device=model.device, injector=injector,
                                record=record, check_verify=check_verify)
    tokens, errors = {}, {}
    torch.cuda.synchronize()
    fastattn_paged_prefill.launches = 0
    paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    for wave in waves:
        for rid, prompt, n_new in wave:
            core.add_request(prompt, SamplingParams(max_new_tokens=n_new),
                             request_id=rid)
            tokens[rid] = []
        while core.has_work:
            for ev in core.step():
                if ev.kind == "token":
                    tokens[ev.request_id].append(ev.token)
                elif ev.kind == "error":
                    errors[ev.request_id] = ev.detail
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - core.check_s
    launches = {"paged_prefill": fastattn_paged_prefill.launches,
                "paged_decode": paged_flash_decode.launches}
    stats = core.stats()
    failure_gate(name, errors, stats, armed=injector is not None)
    device_s = sum(core.device_seconds().values())
    served = sum(len(p) for w in waves for _, p, _ in w) + sum(
        len(t) for t in tokens.values())
    finished = {r.id: r for r in core.sched.finished}
    p = stats["pressure"]
    pre = stats.get("prefix")
    sp = stats.get("spec")
    out = {"run": name, "wall_s": wall, "steps": stats["steps"],
           "device_s": device_s, "tokens_served": served,
           "device_tok_s": served / device_s if device_s else 0.0,
           "preemptions": p["preemptions"], "swaps": p["swaps"],
           "recomputes": p["recomputes"],
           "swap_bytes_out": p["swap_bytes_out"],
           "swap_bytes_in": p["swap_bytes_in"],
           "swap_fail_downgrades": p["swap_fail_downgrades"],
           "prefix_hit_rate": (pre["hits"] / max(1, pre["hits"]
                                                 + pre["misses"])
                               if pre else None),
           "accept_rate": sp["accept_rate"] if sp else None,
           "verify_launches": core.spec_launches,
           "verify_kernel_launches": core.verify_kernel_launches,
           "prefill_launches": core.prefill_launches,
           "pool_pages": serve.pool_pages(), "launches": launches,
           "failed": len(errors)}
    log(f"[3d] {name}: {out['wall_s']:.2f}s wall, {out['steps']} steps, "
        f"{out['device_tok_s']:.0f} device-time tok/s ({served} prompt + "
        f"generated tokens over {device_s:.3f}s of launches), "
        f"preemptions {p['preemptions']} (swap {p['swaps']}, recompute "
        f"{p['recomputes']}), swap bytes out/in {p['swap_bytes_out']}/"
        f"{p['swap_bytes_in']}, prefix hit rate {out['prefix_hit_rate']}, "
        f"accept rate {out['accept_rate']}, verify launches "
        f"{core.spec_launches}, kernel launches {launches}, pool "
        f"{out['pool_pages'] - 1} pages")
    res = {"out": out, "tokens": tokens, "errors": errors, "stats": stats,
           "margins": core.margins, "verify_check": core.verify_check,
           "host_stash": len(core.pressure.host_pool),
           "matched": {rid: (len(r.prompt), r.matched_len)
                       for rid, r in finished.items()},
           "fired_log": (list(injector.fired_log) if injector is not None
                         else [])}
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _held(what, run, ref) -> None:
    """A run's streams against its reference run's (tokens_gate), for
    the requests the run did not fail."""
    equal, total = tokens_gate(what, {r: t for r, t in run["tokens"].items()
                                      if r not in run["errors"]},
                               {r: t for r, t in ref["tokens"].items()
                                if r not in run["errors"]},
                               ref["margins"])
    run["out"]["tokens_equal"] = equal
    run["out"]["tokens_compared"] = total
    log(f"[3d] {what}: {equal} of {total} greedy tokens equal the "
        "feature-off run's before any fork at a near-tie")


def first_layers(model, params, n: int):
    """``model`` and ``params`` cut to their first ``n`` layers (at most
    all of them; the weights shared)."""
    from repro_torch.models import build_model
    n = min(n, model.cfg.num_layers)
    cfg = dataclasses.replace(model.cfg, num_layers=n)
    return (build_model(cfg, device=model.device, parallel=model.parallel),
            {**params, "layers": params["layers"][:n]})


# phase 3d runs llama2-7b's first FEATURE_LAYERS of 32 layers, each run
# gated against its own feature-off run at the same depth: the cut that
# pays for phase 8 (g)-(i) in the script's time limit
FEATURE_LAYERS = 16


def phase_features(model, params) -> dict:
    """Phase 3d on phase 3's llama2-7b cut to its first FEATURE_LAYERS
    layers: the prefix cache, preemption and swap, speculative decoding,
    fault injection and the scan prefill oracle, each against the same
    traffic with the feature off."""
    import torch
    from repro_torch.serving.faults import FaultInjector

    gc.collect()                  # phase 3c's dense cache
    torch.cuda.empty_cache()
    model, params = first_layers(model, params, FEATURE_LAYERS)
    log(f"[3d] {model.cfg.name} cut to its first {model.cfg.num_layers} "
        "layers")
    t0 = time.perf_counter()
    traffic = feature_traffic(model.cfg.vocab_size)
    both = ("paged_prefill", "paged_decode")
    res = {}

    # (a) the prefix cache: two waves over one system prompt
    off = _feature_run("prefix off", model, params, traffic["prefix"],
                       record=True)
    on = _feature_run("prefix on", model, params, traffic["prefix"],
                      prefix_cache=True)
    for run in (off, on):
        launch_gate(run["out"]["run"], run["out"]["launches"], both)
        leak_gate(run["out"]["run"], run["stats"], run["host_stash"])
    _held("prefix on vs off", on, off)
    warm = [on["matched"][rid] for rid, _, _ in traffic["prefix"][1]]
    on["out"]["warm_prefilled"] = prefix_gate("prefix on", on["stats"],
                                              warm, SYSTEM_LEN)
    on["out"]["warm_prompt"] = sum(n for n, _ in warm)
    res["prefix"] = {"off": off["out"], "on": on["out"]}
    del off, on

    # (b) preemption and swap: a pool at 60% of the worst-case demand
    waves = traffic["pressure"]
    pool = int(PRESSURE_FRAC * worst_pages(
        waves, FEATURE_SERVE["page_size"])) + 1
    ref = _feature_run("pressure off", model, params, waves, record=True)
    launch_gate("pressure off", ref["out"]["launches"], both)
    res["pressure"] = {"off": ref["out"]}
    for policy in ("swap", "recompute", "auto"):
        run = _feature_run(f"pressure {policy}", model, params, waves,
                           num_pages=pool, preempt_policy=policy,
                           host_pool_pages=HOST_POOL_PAGES)
        launch_gate(run["out"]["run"], run["out"]["launches"], both)
        pressure_gate(run["out"]["run"], run["stats"])
        leak_gate(run["out"]["run"], run["stats"], run["host_stash"])
        _held(f"pressure {policy} vs off", run, ref)
        res["pressure"][policy] = run["out"]
    del ref, run

    # (c) speculative decoding on tiled-motif prompts
    off = _feature_run("spec off", model, params, traffic["spec"],
                       record=True)
    on = _feature_run("spec on", model, params, traffic["spec"],
                      spec_mode="lookup", spec_tokens=4, check_verify=True)
    launch_gate("spec off", off["out"]["launches"], both)
    # with speculation on every decode step is a verify launch
    launch_gate("spec on", on["out"]["launches"], ("paged_prefill",))
    for run in (off, on):
        leak_gate(run["out"]["run"], run["stats"], run["host_stash"])
    spec_gate("spec on", on["stats"])
    if "first" not in on["verify_check"]:
        raise AssertionError("spec on: no verify launch was checked")
    _held("spec on vs off", on, off)
    # one prefill-kernel launch a layer for each verify launch, and the
    # rest of them the prefill's, as with speculation off
    verify_kernel = on["out"]["verify_kernel_launches"]
    if verify_kernel != model.cfg.num_layers * on["out"][
            "verify_launches"] or on["out"]["launches"]["paged_prefill"] \
            - verify_kernel != off["out"]["launches"]["paged_prefill"]:
        raise AssertionError(
            f"spec on: {verify_kernel} prefill-kernel launches at verify "
            f"launches, for {on['out']['verify_launches']} verify launches")
    on["out"]["verify_check"] = on["verify_check"]
    log(f"[3d] spec: accept rate {on['out']['accept_rate']:.3f}, "
        f"{on['out']['steps']} steps against {off['out']['steps']} with "
        f"speculation off; paged_prefill.cu launched {verify_kernel} times "
        "at the verify shape")
    res["spec"] = {"off": off["out"], "on": on["out"]}
    del off, on

    # (d) faults on (a)+(b)+(c) together
    waves = traffic["faults"]
    # the pool at 60% of one wave's worst-case demand: the cold wave
    # preempts, the warm one shares the cached system prompt
    kw = dict(prefix_cache=True, spec_mode="lookup", spec_tokens=4,
              num_pages=int(PRESSURE_FRAC * worst_pages(
                  waves, FEATURE_SERVE["page_size"]) / len(waves)) + 1,
              preempt_policy="swap", host_pool_pages=HOST_POOL_PAGES)
    ref = _feature_run("faults: all off", model, params, waves, record=True)
    clean = _feature_run("faults: all on, none armed", model, params,
                         waves, **kw)
    inj = FaultInjector(seed=0)
    for site, call in FAULT_CALLS.items():
        inj.arm(site, nth=(call,))
    hit = _feature_run("faults: all on, every site armed once", model,
                       params, waves, injector=inj, **kw)
    launch_gate("faults: all off", ref["out"]["launches"], both)
    for run in (ref, clean, hit):
        if run is not ref:              # decode steps are verify launches
            launch_gate(run["out"]["run"], run["out"]["launches"],
                        ("paged_prefill",))
        leak_gate(run["out"]["run"], run["stats"], run["host_stash"])
    fault_gate("faults", hit["errors"], hit["fired_log"])
    _held("faults: all on vs off", clean, ref)
    _held("faults: survivors vs off", hit, ref)
    hit["out"]["fired"] = [list(f) for f in hit["fired_log"]]
    hit["out"]["failed_ids"] = sorted(hit["errors"])
    log(f"[3d] faults: fired {hit['fired_log']}; failed requests "
        f"{hit['errors']}")
    res["faults"] = {"off": ref["out"], "clean": clean["out"],
                     "armed": hit["out"]}
    del ref, clean, hit

    # (e) the scan prefill oracle against the chunked prefill
    chunked = _feature_run("scan: chunked", model, params, traffic["scan"],
                           record=True)
    scan = _feature_run("scan: scan", model, params, traffic["scan"],
                        prefill_mode="scan")
    launch_gate("scan: chunked", chunked["out"]["launches"], both)
    launch_gate("scan: scan", scan["out"]["launches"], ("paged_decode",))
    if scan["out"]["launches"]["paged_prefill"] or scan["out"][
            "prefill_launches"]:
        raise AssertionError("scan: the scan oracle launched the prefill "
                             "kernel")
    for run in (chunked, scan):
        leak_gate(run["out"]["run"], run["stats"], run["host_stash"])
    _held("scan vs chunked", scan, chunked)
    res["scan"] = {"chunked": chunked["out"], "scan": scan["out"]}
    res["seconds"] = time.perf_counter() - t0
    res["card"] = _card()
    log(f"[3d] {res['card']}: all runs passed in {res['seconds']:.1f}s")
    log("[3d] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 3e: tensor-parallel serving
# ---------------------------------------------------------------------------

TP_MODES = ("tiled", "single")
TP_INIT_TIMEOUT_S = 120.0     # every collective of a rank
TP_DEADLINE_S = 420.0         # a spawned group as a whole
GLOO_NOTE = "gloo stages through the host: not a TP speed"


def tp_backend() -> tuple:
    """(backend, device of each rank): one GPU a rank over NCCL where the
    machine has as many; else every rank on cuda:0 over gloo (NCCL
    refuses two ranks on one device)."""
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        return "nccl", (lambda r: f"cuda:{r}")
    # every rank is on this host: gloo's sockets on the loopback device,
    # whatever the host name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return "gloo", (lambda r: "cuda:0")


def _tp_drive(core, waves, counts) -> dict:
    """Drive one rank's core over ``waves`` of (request id, prompt,
    max_new_tokens), the kernel and collective counts set to 0 just
    before and read just after; the run's numbers."""
    import torch
    from repro_torch.core.tiled_allreduce import COUNTS
    from repro_torch.serving.scheduler import SamplingParams
    torch.cuda.synchronize()
    for c in counts.values():
        c.launches = 0
    COUNTS.update(all_reduce=0, bytes=0)
    torch.cuda.reset_peak_memory_stats()
    tokens = {}
    t0 = time.perf_counter()
    for wave in waves:
        for rid, prompt, n_new in wave:
            core.add_request(prompt, SamplingParams(max_new_tokens=n_new),
                             request_id=rid)
            tokens[rid] = []
        while core.has_work:
            for ev in core.step():
                if ev.kind != "token":
                    raise AssertionError(f"request {ev.request_id}: {ev}")
                tokens[ev.request_id].append(ev.token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - core.check_s
    stats = core.stats()
    dev = core.device_seconds()
    served = sum(len(p) for w in waves for _, p, _ in w) + sum(
        len(t) for t in tokens.values())
    return {"tokens": tokens, "wall_s": wall, "steps": stats["steps"],
            "prefill_launches": stats["prefill_launches"],
            "decode_launches": stats["decode_launches"],
            "launches": {k: c.launches for k, c in counts.items()},
            "all_reduce": COUNTS["all_reduce"],
            "all_reduce_bytes": COUNTS["bytes"],
            "device_s": sum(dev.values()),
            "device_tok_s": served / sum(dev.values()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pages_used": stats["pages_used"], "tp": stats.get("tp"),
            "pool_gb": sum(t.numel() * t.element_size()
                           for c in core.pools for t in c) / 1e9,
            "swap_bytes_out": stats["pressure"]["swap_bytes_out"],
            "preemptions": stats["pressure"]["preemptions"],
            "first_prefill": core.first_prefill.numpy(),
            "device": torch.cuda.current_device(),
            "margins": core.margins}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _tp_rank(rank: int, cfg, params, runs) -> dict:
    """One rank of phase 3e (and of phase 8 (i)): for each (name,
    ServeConfig keywords, waves) of ``runs`` a fresh EngineCore on this
    rank's slices of ``params`` (shared with the parent by CUDA IPC;
    copied over first where the rank has a GPU of its own) of the model
    ``cfg``, driven over the waves; with each run, the experts of every
    MoE layer the core holds."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.fastattn.ops import fastattn_paged_prefill
    from repro_torch.kernels.flash_decode.ops import paged_flash_decode
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_model(cfg, device=dev)
    if next(_leaves(params)).device != dev:
        params = _tree_to(params, dev)
    counts = {"paged_prefill": fastattn_paged_prefill,
              "paged_decode": paged_flash_decode}
    out = {}
    for name, serve, waves in runs:
        core = _make_feature_core()(model, params, cfg, ServeConfig(**serve),
                                    device=dev, record=True)
        out[name] = _tp_drive(core, waves, counts)
        out[name]["experts"] = [bp["moe"]["w_up"].shape[0]
                                for bp in core.params["layers"]
                                if "moe" in bp]
        del core
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_gate(what, ranks: list, ref_tokens: dict, margins: dict,
            plan: dict, layers: int, kernels) -> tuple:
    """Phase 3e's gates on one run, every rank's result in ``ranks``: the
    ranks' streams exactly equal; equal to the tp=1 reference under the
    greedy margin rule (``tokens_gate``); every kernel of ``kernels``
    launched on every rank exactly ``layers`` times a prefill or decode
    launch; no page left; ``stats()["tp"] == plan``.  Returns
    tokens_gate's (equal, compared)."""
    first = ranks[0]["tokens"]
    for r, res in enumerate(ranks):
        if res["tokens"] != first:
            raise AssertionError(f"{what}: rank {r}'s streams differ from "
                                 "rank 0's")
        if res["tp"] != plan:
            raise AssertionError(f"{what}: rank {r} ran plan {res['tp']}, "
                                 f"not {plan}")
        if res["pages_used"]:
            raise AssertionError(f"{what}: rank {r} leaked "
                                 f"{res['pages_used']} pages")
        want = {"paged_prefill": layers * res["prefill_launches"],
                "paged_decode": layers * res["decode_launches"]}
        for k in kernels:
            if res["launches"][k] != want[k] or want[k] <= 0:
                raise AssertionError(
                    f"{what}: rank {r} launched {k} {res['launches'][k]} "
                    f"times, not {want[k]}")
    return tokens_gate(what, first, ref_tokens, margins)


def _tp_report(what, ranks: list, backend: str) -> dict:
    """Print a run's lines and return its numbers (per rank)."""
    steps = ranks[0]["steps"]
    for r, res in enumerate(ranks):
        log(f"[3e] {what} rank {r} on cuda:{res['device']} ({backend}): "
            f"{res['wall_s']:.2f}s wall, {res['steps']} steps, "
            f"{res['all_reduce'] / max(1, steps):.1f} all-reduces a step "
            f"({res['all_reduce_bytes'] / 1e9:.3f} GB through them), "
            f"{res['device_tok_s']:.0f} device-time tok/s, peak memory "
            f"{res['peak_mem_gb']:.2f} GB (pools {res['pool_gb']:.2f} GB), "
            f"kernel launches {res['launches']}")
    log(f"[3e] {what}: {GLOO_NOTE}" if backend == "gloo" else
        f"[3e] {what}: one GPU a rank over nccl")
    keys = ("wall_s", "steps", "all_reduce", "all_reduce_bytes",
            "device_tok_s", "peak_mem_gb", "pool_gb", "launches")
    return {k: [res[k] for res in ranks] for k in keys}


def _tp_memory(params, cfg, serve: dict, tp: int) -> None:
    """The peak reckoned before the first spawn: the parent's weights
    (shared with the ranks), and each rank's slices and local pools."""
    import torch
    from repro_torch.sharding.tp import plan_tp
    plan = plan_tp(cfg, tp, serve["page_size"])
    sliced = sum(t.numel() * t.element_size() for bp in params["layers"]
                 for k in ("attn", "mlp") for t in _leaves(bp[k]))
    from repro_torch.config import ServeConfig
    pages = ServeConfig(**serve).pool_pages()
    pools = (cfg.num_layers * 2 * cfg.num_kv_heads // plan.g * pages
             * serve["page_size"] // plan.s * cfg.head_dim * 2)
    log(f"[3e] memory reckoned: parent "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated; each of "
        f"{tp} ranks about "
        f"{sliced / tp / 1e9:.1f} GB of slices (column slices copied, row "
        f"slices views of the parent's) + {pools / 1e9:.1f} GB of pools + "
        "about 1 GB of context and activations")


# (b): reduced gemma2-2b at tp=4 (g=2, s=2), the LSE merge on CUDA
# tensors: tests/test_tp_serving.py's engine, three requests, then an
# oversubscribed pool under swap
TP_B_SERVE = dict(max_batch=3, max_seq_len=96, page_size=16,
                  prefill_chunk=16, num_pages=24)
TP_B_PRESSURE = dict(max_batch=4, max_seq_len=64, page_size=16,
                     prefill_chunk=16, num_pages=14, preempt_policy="swap")
TP_B_SPEC = [(8, 56), (5, 43), (20, 44), (4, 44), (30, 34), (6, 58)]


def tp_b_traffic(vocab: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(7)
    basic = [[(i, rng.integers(0, vocab, size=n), 8)
              for i, n in enumerate((5, 23, 40))]]
    rng = np.random.default_rng(7)
    pressure = [[(i, rng.integers(0, vocab, size=s), n)
                 for i, (s, n) in enumerate(TP_B_SPEC)]]
    return {"tiled": (TP_B_SERVE, basic), "single": (TP_B_SERVE, basic),
            "swap": (TP_B_PRESSURE, pressure)}


def _tp_nccl_collectives(rank: int) -> dict:
    """The ring and reduce-scatter variants on CUDA tensors, one GPU a
    rank (NCCL): each rank's output against the sum of the per-rank
    products, which every rank computes from one seed."""
    import torch
    from repro_torch.core import tiled_allreduce as ta
    import torch.distributed as dist
    n = dist.get_world_size()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4096, 4096), generator=gen, device="cuda")
    w = torch.randn((4096, 1024), generator=gen, device="cuda")
    f = 4096 // n
    want = sum(x[:, r * f:(r + 1) * f] @ w[r * f:(r + 1) * f]
               for r in range(n))
    xs, ws = x[:, rank * f:(rank + 1) * f], w[rank * f:(rank + 1) * f]
    got = {"ring": ta.ring_matmul_allreduce(xs, ws),
           "reducescatter": ta.tiled_matmul_reducescatter(xs, ws,
                                                          n_chunks=1)}
    rows = 4096 // n
    ref = {"ring": want, "reducescatter": want[rank * rows:
                                               (rank + 1) * rows]}
    return {k: ((got[k] - ref[k]).abs().max().item(),
                ref[k].abs().max().item()) for k in got}


# phase 3e (a) runs llama2-7b's first TP_LAYERS of 32 layers at tp=2,
# against a tp=1 run at the same depth: the cut that pays for phases 12
# (16 layers) and 15 (8)
TP_LAYERS = 8


def phase_tp(model, params) -> dict:
    """Phase 3e: (a) phase 3's traffic on phase 3's llama2-7b cut to its
    first TP_LAYERS layers at tp=2 (g=2, s=1), two ranks, under each
    collective mode, against a tp=1 run of phase 3's engine at that depth
    on the same traffic that records its margins (a run of its own, so
    that phase 3's timed run stays as it was); (b)
    reduced gemma2-2b at tp=4 (g=2, s=2) against its own tp=1 run; the
    ring and reduce-scatter variants where NCCL runs."""
    import torch
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.config import ServeConfig
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backend, dev_of = tp_backend()
    cfg = model.cfg
    out = {"backend": backend}

    def spawn(tmp, tag, tp, *args, fn=_tp_rank):
        devs = [dev_of(r) for r in range(tp)]
        log(f"[3e] {tag}: {tp} ranks over {backend} on {devs}")
        res = spawn_ranks(fn, tp, args=args, device_of_rank=dev_of,
                          backend=backend,
                          init_method=f"file://{tmp}/pg-{tag}",
                          timeout_s=TP_DEADLINE_S,
                          init_timeout_s=TP_INIT_TIMEOUT_S)
        torch.cuda.ipc_collect()      # the ranks' handles on our tensors
        return res

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the slice: llama2-7b at full width cut to its first
        # TP_LAYERS layers, tp=2, against phase 3's engine and traffic at
        # tp=1 at that depth, margins recorded
        model, params = first_layers(model, params, TP_LAYERS)
        cfg = model.cfg
        log(f"[3e] (a) {cfg.name} cut to its first {cfg.num_layers} layers")
        prompts, _ = serve_traffic(cfg.vocab_size)
        waves = [[(i, p, SERVE_3_NEW) for i, p in enumerate(prompts)]]
        core = _make_feature_core()(model, params, cfg,
                                    ServeConfig(**SERVE_3), device="cuda",
                                    record=True)
        tp1 = _tp_drive(core, waves, {})
        del core
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[3e] (a) {cfg.name} ({cfg.num_layers} layers) tp=1 "
            f"reference: {tp1['wall_s']:.2f}s "
            f"wall, {tp1['steps']} steps, {tp1['device_tok_s']:.0f} "
            "device-time tok/s")
        out["a_tp1"] = {k: tp1[k] for k in ("wall_s", "steps",
                                            "device_tok_s", "peak_mem_gb")}
        _tp_memory(params, cfg, SERVE_3, 2)
        ranks = spawn(tmp, "a", 2, cfg, params, [
            (m, dict(SERVE_3, tp=2, tp_collectives=m), waves)
            for m in TP_MODES])
        for m in TP_MODES:
            what = f"(a) llama2-7b tp=2 {m}"
            rr = [r[m] for r in ranks]
            eq, tot = tp_gate(what, rr, tp1["tokens"], tp1["margins"],
                              {"tp": 2, "g": 2, "s": 1, "collectives": m},
                              cfg.num_layers,
                              ("paged_prefill", "paged_decode"))
            _compare_logits(f"[3e] {what}: first prefill launch against "
                            "tp=1's", torch.from_numpy(rr[0]["first_prefill"]),
                            torch.from_numpy(tp1["first_prefill"]))
            out[f"a_{m}"] = {**_tp_report(what, rr, backend),
                             "tokens_equal": eq, "tokens_compared": tot}
            log(f"[3e] {what}: {eq} of {tot} greedy tokens equal tp=1's "
                "before any fork at a near-tie")
        del ranks

        # (b) the LSE merge on CUDA tensors: reduced gemma2-2b at tp=4
        rcfg = reduce_for_smoke(get_model_config("gemma2-2b"))
        rmodel = build_model(rcfg, device="cuda")
        rparams = rmodel.init(rmodel.generator(0))
        traffic = tp_b_traffic(rcfg.vocab_size)
        refs = {}
        for name, (serve, w) in traffic.items():
            if name == "single":
                refs[name] = refs["tiled"]
                continue
            # tp=1 on the plain paged attention: the kernels take head
            # dims 64, 128 and 256, the reduced config has 16
            core = _make_feature_core()(
                rmodel, rparams, rcfg,
                ServeConfig(**dict(serve, paged_impl="paged_reference")),
                device="cuda", record=True)
            refs[name] = _tp_drive(core, w, {})
            del core
        ranks = spawn(tmp, "b", 4, rcfg, rparams, [
            (name, dict(serve, tp=4, tp_collectives=(
                "single" if name == "single" else "tiled")), w)
            for name, (serve, w) in traffic.items()])
        for name in traffic:
            what = f"(b) gemma2-2b reduced tp=4 {name}"
            rr = [r[name] for r in ranks]
            coll = "single" if name == "single" else "tiled"
            eq, tot = tp_gate(what, rr, refs[name]["tokens"],
                              refs[name]["margins"],
                              {"tp": 4, "g": 2, "s": 2, "collectives": coll},
                              rcfg.num_layers, ())
            _compare_logits(f"[3e] {what}: first prefill launch against "
                            "tp=1's", torch.from_numpy(rr[0]["first_prefill"]),
                            torch.from_numpy(refs[name]["first_prefill"]))
            if name == "swap" and not (
                    rr[0]["preemptions"] > 0 and rr[0]["swap_bytes_out"]
                    == refs[name]["swap_bytes_out"] > 0):
                raise AssertionError(
                    f"{what}: {rr[0]['preemptions']} preemptions, swap "
                    f"bytes {rr[0]['swap_bytes_out']} against tp=1's "
                    f"{refs[name]['swap_bytes_out']}")
            out[f"b_{name}"] = {**_tp_report(what, rr, backend),
                                "tokens_equal": eq, "tokens_compared": tot}
            log(f"[3e] {what}: {eq} of {tot} greedy tokens equal tp=1's")
        del ranks, rparams, rmodel

        # the ring and reduce-scatter variants need CUDA send/recv and
        # reduce-scatter: NCCL's, one GPU a rank
        if backend == "nccl":
            tp = min(torch.cuda.device_count(), 4)
            for r, errs in enumerate(spawn(tmp, "ring", tp,
                                           fn=_tp_nccl_collectives)):
                for k, (err, scale) in errs.items():
                    if not err <= 1e-4 * scale:
                        raise AssertionError(f"{k} on rank {r}: error "
                                             f"{err} of scale {scale}")
            log(f"[3e] ring and reduce-scatter on {tp} GPUs: within 1e-4 "
                "of the products' scale")
        else:
            log("[3e] ring and reduce-scatter variants not run: one GPU, "
                "and gloo has no CUDA send/recv or reduce-scatter (NCCL "
                "refuses two ranks on one device)")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card()
    log(f"[3e] {out['card']}: all runs passed in {out['seconds']:.1f}s")
    log("[3e] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 3f: int8 weights on llama2-7b
# ---------------------------------------------------------------------------

INT8_BATCH, INT8_SEQ = 2, 512
# JAX's own rules for int8 weights (tests/test_quant.py): the logits'
# drift, the greedy tokens equal at every decisive position (top-1
# margin over twice the largest error), the greedy agreement, the size
# against the unquantized tree.  Its fourth rule, more than 0.1 of the
# positions decisive, is read and not gated: it holds at the smoke
# width JAX tests (d_model 32, 256 tokens of vocabulary), not on random
# weights at full width, where the top-1 margin among 32000 logits
# averages ~0.22 of their spread and twice the largest error is ~0.7 of
# it -- 0.6-4.2% of the positions were decisive on bf16 llama2-7b at
# d_model 2048, 16 and 32 layers, on the CPU (ROADMAP Queue 3).
INT8_DRIFT = 0.15
INT8_AGREE = 0.8
INT8_SIZE = 0.6


def int8_gate(what, got, base, size_ratio: float) -> dict:
    """JAX's rules for int8 weights on logits ``got`` against ``base``
    (..., V): the drift under INT8_DRIFT of ``base``'s scale, the greedy
    tokens equal at every decisive position (their share read), agreement
    over INT8_AGREE, the size ratio under INT8_SIZE."""
    import torch
    got, base = got.float(), base.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    err = (got - base).abs().max().item()
    drift = err / max(base.abs().max().item(), 1e-9)
    agree = torch.argmax(got, -1) == torch.argmax(base, -1)
    top2 = torch.topk(base, 2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    res = {"drift": drift, "max_abs_err": err,
           "decisive": decisive.float().mean().item(),
           "agree": agree.float().mean().item(),
           "agree_where_decisive": bool(agree[decisive].all()),
           "size_ratio": size_ratio}
    log(f"{what}: drift {drift:.4f} of the logits' scale (bound "
        f"{INT8_DRIFT}), greedy agreement {res['agree']:.3f} (> "
        f"{INT8_AGREE}), equal at every decisive position "
        f"{res['agree_where_decisive']} ({int(decisive.sum())} decisive, "
        f"{res['decisive']:.3f} of the positions), size {size_ratio:.4f} "
        f"of the bf16 tree (< {INT8_SIZE})")
    if not (drift < INT8_DRIFT and res["agree_where_decisive"]
            and res["agree"] > INT8_AGREE and size_ratio < INT8_SIZE):
        raise AssertionError(f"{what}: int8 weights fail JAX's rules: "
                             f"{res}")
    return res


def phase_int8(model, params) -> dict:
    """Phase 3f: ``quantize_tree`` of phase 3's llama2-7b in both of the
    JAX tree's layouts, dequantized to bf16, ``LM.apply`` on INT8_BATCH x
    INT8_SEQ tokens (numpy seed 5) against the bf16 weights', each run
    launching ``fastattn_fwd`` once a layer (none on the CPU: a
    rehearsal runs the plain attention), held by ``int8_gate``."""
    import numpy as np
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.quant.int8 import (dequantize_tree, quantize_tree,
                                        quantized_size_bytes)
    cfg, dev = model.cfg, model.device
    gc.collect()                  # phase 3e's engines and pools
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = cfg.num_layers if dev.type == "cuda" else 0
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(INT8_BATCH, INT8_SEQ)).astype(np.int32)
    ).to(dev)
    full = sum(t.numel() * t.element_size() for t in _leaves(params))

    def run(what, p):
        fastattn_fwd.launches = 0
        with torch.no_grad():
            logits = model.apply(p, toks)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if fastattn_fwd.launches != want:
            raise AssertionError(f"[3f] {what}: fastattn_fwd launched "
                                 f"{fastattn_fwd.launches} times, "
                                 f"expected {want}")
        return logits

    base = run("bf16 weights", params)
    out = {"batch": INT8_BATCH, "seq": INT8_SEQ, "launches": [want],
           "bf16_bytes": full, "layouts": {}}
    for scan in (True, False):
        what = f"[3f] {cfg.name} int8, scan_layers={scan}"
        t1 = time.perf_counter()
        qp = quantize_tree(params, cfg, scan_layers=scan)
        size = quantized_size_bytes(qp)
        qts = _quantized(qp)
        scales = {id(x.scale) for x in qts}
        deq = dequantize_tree(qp, torch.bfloat16)
        del qp
        if dev.type == "cuda":
            torch.cuda.synchronize()
        quant_s = time.perf_counter() - t1
        logits = run(what, deq)
        del deq
        res = int8_gate(what, logits, base, size / full)
        res.update(bytes=size, scale_tensors=len(scales),
                   quantized_leaves=len(qts), quantize_s=quant_s)
        log(f"{what}: {len(qts)} leaves quantized, "
            f"{len(scales)} scale tensors, {size / 1e9:.3f} GB; quantized "
            f"and dequantized in {quant_s:.2f}s")
        out["layouts"][str(scan)] = res
        out["launches"].append(want)
        del logits
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if dev.type == "cuda" else "cpu"
    log(f"[3f] {out['card']}: both layouts within JAX's rules in "
        f"{out['seconds']:.1f}s; fastattn_fwd {out['launches']} launches "
        "(bf16, scan_layers True, False)")
    log("[3f] " + json.dumps(out))
    return out


def _quantized(tree) -> list:
    """The QuantizedTensor leaves of a quantized parameter tree."""
    from repro_torch.quant.int8 import QuantizedTensor
    if isinstance(tree, QuantizedTensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [x for t in tree for x in _quantized(t)]
    return []


# ---------------------------------------------------------------------------
# phase 4: training llama2-7b at full width
# ---------------------------------------------------------------------------

# Depth cut for memory: at 32 layers bf16 params + bf16 grads + two f32
# AdamW moments take about 13.5 + 13.5 + 54 GB, over one 80 GB card; 4
# layers keep every width (1.07 B params, about 13 GB of state).  (At 2
# layers phase 4b's step 0 read its grad norm 2.03% above phase 4's, over
# DIST_GNORM_RTOL: the embed's share of the norm, where phase 4's bf16
# scatter-add loses most, doubles.)
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# kernel path vs plain attention path on one 1 x 2048 batch: bf16
# activations through the layers, rounded at different points by the two
# attention paths (the kernel rounds its output once; the plain path's
# backward recomputes in f32), move the loss by well under 1% and the
# gradient norm by a few percent at most.
LOSS_RTOL = 0.01
GNORM_RTOL = 0.05


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# every CUDA kernel of mlstm_chunkwise.cu is named mlstm_chunkwise_*: the
# float32 FMA kernel, and bf16's gates, states and outputs kernels
MLSTM_KERNELS = "mlstm_chunkwise_"


def _train_group(name: str) -> str:
    n = name.lower()
    if "fastattn_fwd_" in n:
        return "attention forward: fastattn_fwd.cu"
    if MLSTM_KERNELS in n:
        return "mLSTM forward: mlstm_chunkwise.cu"
    if any(t in n for t in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                            "cublas")):
        if "f32f32" in n or "sgemm" in n:
            return "matrix products, float32 (plain attention recompute)"
        return "matrix products, bf16 (projections, MLP, LM head)"
    if "reduce" in n or "softmax" in n or "logsumexp" in n:
        return "reductions"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copies / casts"
    return "elementwise and other"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_training() -> dict:
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import (ParallelConfig, TrainConfig,
                                    get_model_config)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.fastattn.ops import fastattn, fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = dataclasses.replace(get_model_config("llama2-7b"),
                              num_layers=TRAIN_LAYERS)
    parallel = ParallelConfig(remat="selective")   # as launch/train.py
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(state.params))
    log(f"[train] {cfg.name} cut to {cfg.num_layers} layers: d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, {n_params / 1e9:.3f}B params ({cfg.param_dtype}, f32 "
        f"moments), remat {parallel.remat}; initialised in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))

    # phase 4b's reference: the initial parameters and those after
    # DIST_STEPS steps (host copies, tree order), and every step's loss,
    # grad norm and lr
    ref = {"init": [t.cpu() for t in tree.leaves(state.params)],
           "loss": [], "grad_norm": [], "lr": [],
           "paths": [p for p, _ in tree.leaves_with_paths(state.params)]}
    # step 0's gradient norm leaf by leaf (phase 4b's against it), on the
    # first batch of a pipeline of its own
    first = to_device(TokenPipeline(data.cfg).next(), model.device)
    ref["leaf_gnorm"] = leaf_grad_norms(model, cfg, state.params, first)
    ref["embed_gnorm_f32"] = embed_f32_grad_norm(model, cfg, state.params,
                                                 first)
    del first
    fastattn_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        batch = to_device(data.next(), model.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        for k in ("loss", "grad_norm", "lr"):
            ref[k].append(float(metrics[k]))
        if i + 1 == DIST_STEPS:
            ref["snapshot"] = [t.cpu() for t in tree.leaves(state.params)]
        log(f"[train] step {i} loss {losses[-1]:.4f} lr "
            f"{float(metrics['lr']):.2e} gnorm "
            f"{float(metrics['grad_norm']):.4f} {step_s[-1] * 1e3:.1f} ms")
    launches = fastattn_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = TRAIN_LAYERS * (2 if parallel.remat != "none" else 1) \
        * TRAIN_STEPS
    log(f"[train] fastattn_fwd launches on the training path: {launches} "
        f"(expected {TRAIN_LAYERS} layers x 2 forward passes under remat x "
        f"{TRAIN_STEPS} steps = {expected})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"fastattn_fwd launched {launches} times, "
                             f"expected {expected}")
    steady_s = statistics.median(step_s[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / steady_s

    # checkpoint: params and optimizer state round-trip bit for bit
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        t1 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state, extras={"data": data.state()})
        save_s = time.perf_counter() - t1
        restored, manifest = mgr.restore(state)
        for (path, a), b in zip(tree.leaves_with_paths(restored),
                                tree.leaves(state)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"checkpoint leaf {path} changed")
        n_leaves = manifest["n_leaves"]
        del restored
    log(f"[train] checkpoint of {n_leaves} leaves saved in {save_s:.1f}s "
        "and restored bit for bit")

    # kernel path vs plain attention path on one 1 x 2048 batch
    one = {k: x[:1] for k, x in to_device(data.next(), model.device).items()}
    (k_loss, k_gn), (p_loss, p_gn) = (
        _loss_and_gnorm(model, state.params, one, impl)
        for impl in (None, "reference"))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    gn_rel = abs(k_gn - p_gn) / abs(p_gn)
    log(f"[train] kernel vs plain path, 1 x {TRAIN_SEQ}: loss {k_loss:.5f}"
        f" vs {p_loss:.5f} (rel {loss_rel:.2e}, tol {LOSS_RTOL}), grad norm "
        f"{k_gn:.5f} vs {p_gn:.5f} (rel {gn_rel:.2e}, tol {GNORM_RTOL})")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("kernel and plain training paths disagree")

    # one more step under the profiler: where the device time goes
    batch = to_device(data.next(), model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    total_us = sum(_device_us(e) for e in kernels)
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    fa = [e for e in kernels if "fastattn_fwd_" in e.key]
    fa_us = sum(_device_us(e) for e in fa)
    groups = {}
    for e in kernels:
        grp = _train_group(e.key)
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:8]

    # attention of one layer at the training shape, forward (kernel) plus
    # backward (plain recompute), and one AdamW update of every parameter
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    shape = (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.head_dim)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    attn_ms = time_ms(lambda: torch.autograd.grad(
        fastattn(q, k, v, impl="kernel"), (q, k, v), g), reps=5)
    del q, k, v, g
    zeros = tree.tree_map(torch.zeros_like, state.params)
    opt_ms = time_ms(lambda: adamw_update(zeros, state.opt, state.params,
                                          tcfg), reps=3, warmup=1)
    del zeros
    out = {"layers": TRAIN_LAYERS, "params": n_params, "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
           "step_s": step_s, "steady_step_s": steady_s, "tok_s": tok_s,
           "peak_mem_gb": peak_gb, "launches": launches,
           "loss_rel": loss_rel, "gnorm_rel": gn_rel,
           "profiled_kernel_s": total_us / 1e6,
           "fastattn_s": fa_us / 1e6,
           "fastattn_calls": sum(e.count for e in fa),
           "groups_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "fastattn_share_of_step": fa_us / 1e6 / steady_s,
           "fastattn_share_of_kernels": fa_us / total_us,
           "idle_share": 1.0 - total_us / 1e6 / steady_s,
           "attn_layer_fwd_bwd_ms": attn_ms, "adamw_ms": opt_ms,
           "card": _card()}
    log(f"[train] {out['card']}: steady step {steady_s * 1e3:.1f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}), {tok_s:.0f} tok/s, peak "
        f"memory {peak_gb:.1f} GB")
    log(f"[train] profiled step: kernels {out['profiled_kernel_s']:.4f}s, "
        f"fastattn_fwd {out['fastattn_s']:.4f}s in {out['fastattn_calls']} "
        f"launches ({out['fastattn_share_of_step']:.1%} of the unprofiled "
        f"step, {out['fastattn_share_of_kernels']:.1%} of kernel time), "
        f"idle share {out['idle_share']:.3f}")
    for grp, sec in out["groups_s"].items():
        log(f"[train]   {sec:9.4f}s  {grp}")
    log(f"[train] one layer's attention, kernel forward + plain backward: "
        f"{attn_ms:.2f} ms (x{TRAIN_LAYERS} layers = "
        f"{TRAIN_LAYERS * attn_ms / 1e3 / steady_s:.1%} of the step); one "
        f"adamw_update of {n_params / 1e9:.2f}B params: {opt_ms:.2f} ms "
        f"({opt_ms / 1e3 / steady_s:.1%} of the step)")
    for e in top:
        log(f"[train]   {_device_us(e) / 1e6:9.4f}s {e.count:6d}x "
            f"{e.key[:90]}")
    log("[train] " + json.dumps(out))
    out["reference"] = ref
    return out


# ---------------------------------------------------------------------------
# phase 4b: data- and model-parallel training at (data=2, model=2)
# ---------------------------------------------------------------------------

DIST_MESH = dict(data=2, model=2)
# phase 4b takes the first DIST_STEPS of phase 4's TRAIN_STEPS steps,
# against phase 4's snapshot there: a step through gloo on one card costs
# 8-12 s (5.6 GB of collectives a rank)
DIST_STEPS = 3
DIST_INIT_TIMEOUT_S = 300.0       # every collective of a rank
DIST_DEADLINE_S = 900.0           # a spawned group as a whole
# Bounds against phase 4's one-device run of the same weights and batches,
# fixed before this phase first ran on the card (PERF.md, the phase 4b
# prediction) from the same comparison in bf16 on CPU ranks at a reduced
# width (held to them by tests/test_torch_chip_smoke.py): each leaf's
# update within a few percent -- bf16 gradients summed over four ranks
# in another order flip the sign of some of Adam's first updates.
# Leaves whose one-device update is 0 (norm scales: their updates round
# away at 1.0) must not move either.
DIST_LOSS_RTOL = 0.01
DIST_GNORM_RTOL = 0.02
DIST_DELTA_RTOL = 0.15
# the step after the checkpoint at (data=1, model=2) from the restored
# state against the (2, 2) run's own: the same parameters, another layout
DIST_RESUME_RTOL = 1e-3
LAUNCHER = ["-m", "repro_torch.launch.train", "--arch", "llama2-7b",
            "--smoke", "--steps", "2", "--data", "2", "--model-axis", "2"]


def bits_key(t) -> tuple:
    """An exact fingerprint of a tensor's bits (order-independent sums of
    its words, plain and weighted by position), to compare tensors held
    in other processes without moving them."""
    import torch
    word = torch.int16 if t.element_size() == 2 else torch.int32
    w = t.detach().contiguous().reshape(-1).view(word).long()
    idx = torch.arange(w.numel(), device=w.device) % 1009 + 1
    return (int(w.sum()), int((w * idx).sum()))


def read_checkpoint(ckpt_dir: str, step: int, layouts: dict,
                    on_card: bool) -> dict:
    """One read of a checkpoint's step ``step``: its file names, its
    manifest, and for each layout (name -> (meshes, specs), one mesh a
    rank) every rank's fingerprints (``bits_key``) of its slice of each
    saved leaf, taken on the card where there is one."""
    from repro_torch.sharding.rules import shard_of
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys = {name: [[] for _ in meshes]
            for name, (meshes, _) in layouts.items()}
    for i, (_, t) in enumerate(checkpoint_leaves(ckpt_dir, step)):
        t = t.cuda() if on_card else t
        for name, (meshes, specs) in layouts.items():
            for r, mesh in enumerate(meshes):
                keys[name][r].append(bits_key(shard_of(t, specs[i], mesh)))
        del t
    return {"files": sorted(os.listdir(d)), "manifest": manifest,
            "keys": keys}


def checkpoint_differs(read: dict, ranks: list, layout: str) -> list:
    """What of a checkpoint (``read_checkpoint``) differs from what a
    one-rank save of the ranks' state gathered whole writes, the ranks
    having saved it at ``layout``: a file missing or extra, the manifest
    but for its write time (``ckpt_manifest``, each rank's whole-leaf
    paths, dtypes and shapes and its extras), and each leaf whose slice
    for some rank is not that rank's piece bit for bit (``final_keys``);
    [] when nothing does."""
    want = ranks[0]["ckpt_manifest"]
    names = [f"arr_{i}.npy" for i in range(want["n_leaves"])]
    bad = sorted(set(read["files"]) ^ set(names + ["manifest.json"]))
    got = {k: v for k, v in read["manifest"].items() if k != "time"}
    if got != want:
        bad.append("manifest.json")
    for r, res in enumerate(ranks):
        for i, (a, b) in enumerate(zip(read["keys"][layout][r],
                                       res["final_keys"], strict=True)):
            if a != b and want["leaves"][i]["path"] not in bad:
                bad.append(want["leaves"][i]["path"])
    return bad


def _dist_rank(rank: int, cfg, mesh_kw: dict, run: dict) -> dict:
    """One rank of a training run on a mesh (phase 4b; phase 8 (h)): the
    one-device run's model (``cfg``), seed, batches and schedule at
    ``ParallelConfig(remat=run["remat"], **mesh_kw)`` (``_dist_job``),
    then phase 15's decode where ``run`` holds a "decode" job (phase 8
    (h): ``_decode_job``)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_mesh_for
    mesh = make_mesh_for(ParallelConfig(remat=run["remat"], **mesh_kw),
                         timeout=DIST_INIT_TIMEOUT_S)
    out = _dist_job(rank, mesh, cfg, mesh_kw, run)
    if run.get("decode"):
        _free_card()
        out["decode"] = _decode_job(mesh, run["decode"])
    return out


def _dist_job(rank: int, mesh, cfg, mesh_kw: dict, run: dict) -> dict:
    """This rank's share of one training run on ``mesh``, drawing the
    whole tree and keeping its pieces.  ``run``: the one-device run's
    "batch" x "seq" batches (with "frames": an encoder-decoder's N(0, 1)
    frames from a generator on the device seeded with 2, drawn after each
    batch's tokens) and its "steps" (the schedule), the "dist_steps" to
    take, "mode" and "ckpt_dir" (None: no checkpoint), the one-device
    parameters after dist_steps ("snapshot", in tree order), or a queue
    that hands them over after the steps ("feed"; the one-device run
    goes on beside the ranks) beside its step-0 gradients, or neither,
    whether to read step 0's "leaf_gnorm" and, with a feed, whether to
    hold step 0's gradients to one device's ("grad0").  Mode "train":
    every step's numbers and the collectives it issued, the initial pieces'
    fingerprints and sizes, the expert count of each expert leaf,
    fastattn_fwd's launches and q_offsets, mlstm_chunkwise's launches
    and the head counts it ran at; given a snapshot, for each leaf the
    squared norms on this rank's piece of the one-device update and of
    the updates' difference (``delta_gate``), and with "grad0" the same
    of step 0's gradients (``first_step_grads``); given a ckpt_dir, a
    checkpoint of the final state, each piece's fingerprint and the
    manifest a one-rank save of the whole writes (``checkpoint_differs``
    holds the files to them), then one more step.  "resume": that
    checkpoint restored into this rank's pieces and the one more step.  The rank runs on its CUDA device (on the CPU
    only where there is none: a rehearsal of the phase's host code, on
    one thread a rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn import ops
    from repro_torch.kernels.mlstm import ops as mops
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (axis_rules, entry_axes, flatten,
                                            is_spec, shard_of)
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import (CheckpointManager,
                                                 _dtype_name)
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step,
                                                 state_specs)
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel = ParallelConfig(remat=run["remat"], **mesh_kw)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)        # a rehearsal: ranks share the cores
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=run["steps"])   # the one-device schedule
    model = build_model(cfg, dev, parallel)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=run["seq"],
                                    global_batch=run["batch"]))
    frames = None
    if run.get("frames"):
        frames = torch.Generator(device=dev)
        frames.manual_seed(2)
    kernel, mkernel = ops.fastattn_fwd, mops.mlstm_chunkwise_fwd
    offsets, heads = set(), set()

    def recorded(*args, **kw):            # every launch's q_offset
        offsets.add(kw.get("q_offset", 0))
        return kernel(*args, **kw)

    def mrecorded(q, *args, **kw):        # every launch's head count
        if q.is_cuda:
            heads.add(q.shape[1])
        return mkernel(q, *args, **kw)
    # each wrapper counts its launches on the module's name: here
    recorded.launches = mrecorded.launches = 0

    ckpt_dir, snapshot = run["ckpt_dir"], run["snapshot"]
    out = {"rank": rank, "coords": mesh.coords, "device": str(dev),
           "backend": str(dist.get_backend()), "loss": [], "grad_norm": [],
           "lr": [], "step_s": [], "collectives": [], "coll_bytes": []}
    ops.fastattn_fwd, mops.mlstm_chunkwise_fwd = recorded, mrecorded
    try:
        with axis_rules(mesh=mesh):
            t0 = time.perf_counter()
            state = init_train_state(model, model.generator(tcfg.seed))
            synchronize(dev)
            out["init_s"] = time.perf_counter() - t0
            pspecs = model.param_specs(mesh)
            specs = flatten(pspecs, is_spec)
            mgr = (CheckpointManager(ckpt_dir, mesh=mesh,
                                     specs=state_specs(pspecs))
                   if ckpt_dir else None)
            step_fn = make_train_step(model, cfg, parallel, tcfg)
            paths = tree.leaves_with_paths(state.params)
            out["numel"] = [t.numel() for _, t in paths]
            out["experts"] = [t.shape[0] for p, t in paths
                              if "/moe/w_" in p]
            if run["mode"] == "resume":
                state, manifest = mgr.restore(state)
                data.restore(manifest["extras"]["data"])
                out["restored_keys"] = [bits_key(t)
                                        for t in tree.leaves(state)]
            else:
                out["init_keys"] = [bits_key(t) for _, t in paths]
            if run["leaf_gnorm"]:
                # step 0's gradient, leaf by leaf, on the first batch (a
                # pipeline of its own: ``data`` stays at 0)
                first = TokenPipeline(data.cfg).next()
                out["leaf_gnorm"] = leaf_grad_norms(
                    model, cfg, state.params, to_device(first, dev))

        def snap(i):                      # the one-device piece of leaf i
            return shard_of(snapshot[i].to(dev), specs[i], mesh).float()
        # the one-device update's squared norm on each piece, before the
        # steps update the pieces in place; with the snapshot still to
        # come ("feed"), a copy of the initial pieces for after the steps
        one = [(snap(i) - t.float()).square().sum().item()
               for i, (_, t) in enumerate(paths)] if snapshot else None
        start = ([t.clone() for _, t in paths] if run.get("feed")
                 else None)
        del paths
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        recorded.launches = mrecorded.launches = 0
        grads: list = []
        with (first_step_grads(grads) if run.get("grad0")
              else contextlib.nullcontext()):
            for _ in range(run["dist_steps"] if run["mode"] == "train"
                           else 0):
                batch = to_device(data.next(), dev)
                if frames is not None:
                    batch["enc_embeds"] = torch.randn(
                        (run["batch"], cfg.encoder_seq, cfg.d_model),
                        generator=frames, device=dev)
                C.COUNTS.update(all_gather=0, reduce_scatter=0,
                                all_reduce=0, bytes=0)
                synchronize(dev)
                t1 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                synchronize(dev)
                out["step_s"].append(time.perf_counter() - t1)
                for k in ("loss", "grad_norm", "lr"):
                    out[k].append(float(metrics[k]))
                out["collectives"].append({k: C.COUNTS[k] for k in (
                    "all_gather", "reduce_scatter", "all_reduce")})
                out["coll_bytes"].append(C.COUNTS["bytes"])
        out["launches"] = recorded.launches
        out["q_offsets"] = sorted(offsets)
        out["mlstm_launches"] = mrecorded.launches
        out["mlstm_heads"] = sorted(heads)
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if dev.type == "cuda" else None)
        if start is not None:
            got = run["feed"].get(timeout=DIST_DEADLINE_S)
            if got is None:
                raise RuntimeError(f"{cfg.name}: no one-device run to hold "
                                   "the mesh's updates to")
            snapshot, grad_one = got
            one = [(snap(i) - t.float()).square().sum().item()
                   for i, t in enumerate(start)]
            del start
            if grads:
                # step 0's gradient: the same squared norms on this piece
                out["grad0"] = []
                for i, g in enumerate(grads):
                    w = shard_of(grad_one[i].to(dev), specs[i], mesh).float()
                    out["grad0"].append(((g.float() - w).square().sum().item(),
                                         w.square().sum().item()))
                del grads, grad_one
        if one is not None:
            # the updates' difference: final - snapshot (the init cancels)
            out["delta"] = [((t.float() - snap(i)).square().sum().item(),
                             one[i])
                            for i, t in enumerate(tree.leaves(state.params))]
        if ckpt_dir is None:
            return out
        if run["mode"] == "train":
            # gathered whole now, written to disk beside the next step
            t1 = time.perf_counter()
            mgr.save(run["dist_steps"], state,
                     extras={"data": data.state()}, async_=True)
            out["save_s"] = time.perf_counter() - t1
            # what a one-rank save of the state gathered whole writes,
            # without gathering it again: each piece's fingerprint, and
            # the manifest of the whole leaves
            sspecs = flatten(state_specs(pspecs), is_spec)
            out["final_keys"] = [bits_key(t) for t in tree.leaves(state)]
            out["ckpt_manifest"] = {
                "step": run["dist_steps"], "n_leaves": len(sspecs),
                "leaves": [{"path": path, "dtype": _dtype_name(t),
                            "shape": [n * (mesh.size(entry_axes(sp[d]))
                                           if d < len(sp) else 1)
                                      for d, n in enumerate(t.shape)]}
                           for (path, t), sp in zip(
                               tree.leaves_with_paths(state), sspecs,
                               strict=True)],
                "extras": {"data": data.state()}}
        state, metrics = step_fn(state, to_device(data.next(), dev))
        out["next_loss"] = float(metrics["loss"])
        if run["mode"] == "train":
            t1 = time.perf_counter()
            mgr.wait()                    # on disk for every rank
            out["write_wait_s"] = time.perf_counter() - t1
    finally:
        ops.fastattn_fwd, mops.mlstm_chunkwise_fwd = kernel, mkernel
    return out


def dist_gate(what, ranks: list, ref: dict, keys: list, specs: list,
              seq: int, model: int, *, layers: int = TRAIN_LAYERS,
              steps: int = DIST_STEPS, experts: int = None,
              checkpoint: bool = True, launches: int = None,
              offsets=None, loss_rtol: float = DIST_LOSS_RTOL,
              gnorm_rtol: float = DIST_GNORM_RTOL) -> None:
    """The gates of a training run on a mesh against its one-device run
    (``ref``; phase 4b, phase 8 (h), phase 12): every rank's loss, grad
    norm and lr equal the others' and, step by step, the one device's
    within ``loss_rtol`` / ``gnorm_rtol`` (DIST_LOSS_RTOL /
    DIST_GNORM_RTOL, or a list of a bound a step; lr exactly); each rank
    launched fastattn_fwd ``launches`` (``layers`` x 2 (remat) x
    ``steps``) times, at the q_offsets ``offsets(m)`` of model
    coordinate m (its first row, m x seq / model); its initial pieces
    are the rule table's slices of the one device's draw (``keys``: per
    rank, the fingerprints of those slices); a leaf sharded over the
    model axis holds 1/model of the whole; given ``experts``, each
    expert leaf holds that many experts (its slice of the expert dim);
    with ``checkpoint``, rank 0's checkpoint equals the one-rank save of
    the same gathered state."""
    from repro_torch.sharding.rules import spec_axes
    first = ranks[0]
    want = layers * 2 * steps if launches is None else launches
    offsets = offsets or (lambda m: [m * seq // model])
    for r, res in enumerate(ranks):
        for k in ("loss", "grad_norm", "lr"):
            if res[k] != first[k]:
                raise AssertionError(f"{what}: rank {r}'s {k} {res[k]} "
                                     f"differs from rank 0's {first[k]}")
        m = res["coords"]["model"]
        at = offsets(m) if want else []
        if res["launches"] != want or res["q_offsets"] != at:
            raise AssertionError(
                f"{what}: rank {r} launched fastattn_fwd {res['launches']} "
                f"times at q_offsets {res['q_offsets']}, not {want} at "
                f"{at}")
        if res["init_keys"] != keys[r]:
            raise AssertionError(f"{what}: rank {r}'s initial pieces are "
                                 "not its slices of the one device's "
                                 "parameters")
        sharded = [i for i, s in enumerate(specs) if spec_axes(s)]
        whole = [int(t.numel()) for t in ref["init"]]
        bad = [i for i in sharded if res["numel"][i] * model != whole[i]]
        if not sharded or bad:
            raise AssertionError(f"{what}: rank {r}: sharded leaves {bad} "
                                 f"do not hold 1/{model} of the whole")
        if experts is not None and (not res["experts"]
                                    or set(res["experts"]) != {experts}):
            raise AssertionError(f"{what}: rank {r}'s expert leaves hold "
                                 f"{res['experts']} experts, not {experts}")
    if len(first["loss"]) != steps:
        raise AssertionError(f"{what}: {len(first['loss'])} steps, not "
                             f"{steps}")
    for i in range(steps):
        l1, g1, lr1 = (ref[k][i] for k in ("loss", "grad_norm", "lr"))
        l2, g2, lr2 = (first[k][i] for k in ("loss", "grad_norm", "lr"))
        lt, gt = (t[i] if isinstance(t, list) else t
                  for t in (loss_rtol, gnorm_rtol))
        if not (abs(l2 - l1) <= lt * abs(l1) and abs(g2 - g1) <= gt * abs(g1)
                and lr2 == lr1):
            raise AssertionError(
                f"{what}: step {i}: loss {l2} / grad norm {g2} / lr {lr2} "
                f"against one device's {l1} / {g1} / {lr1} (rtol "
                f"{lt} / {gt}, lr exact)")
    if checkpoint and (first["ckpt_differs"] or not first["ckpt_files"]):
        raise AssertionError(f"{what}: the checkpoint differs from what "
                             "a one-rank save writes in "
                             f"{first['ckpt_differs']}")


def leaf_grad_norms(model, cfg, params, batch) -> list:
    """Each parameter leaf's gradient norm (f32) at ``params`` on a global
    ``batch`` of one microbatch: on one device, or -- under a mesh -- from
    this rank's rows, each gradient summed over the axes its leaf is not
    sharded over and its square over those it is, as the train step
    does.  Phase 4b reads it at step 0 beside phase 4's, to see which
    leaves make the grad norms differ."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (current_mesh, flatten, is_spec,
                                            spec_axes)
    from repro_torch.training.train_step import (_value_and_grad,
                                                 make_loss_fn, rank_rows)
    mesh = current_mesh()
    if mesh is None:
        _, grads = _value_and_grad(make_loss_fn(model, cfg), params, batch)
        return [g.float().norm().item() for g in grads]
    _, grads = _value_and_grad(make_loss_fn(model, cfg), params,
                               rank_rows(batch, mesh, 1)[0])
    out = []
    for g, s in zip(grads, flatten(model.param_specs(mesh), is_spec),
                    strict=True):
        g = C.all_reduce(g, mesh.group(tuple(
            a for a in mesh.axis_names if a not in spec_axes(s))))
        sq = C.all_reduce(g.float().square().sum(), mesh.group(spec_axes(s)))
        out.append(sq.sqrt().item())
    return out


def embed_f32_grad_norm(model, cfg, params, batch) -> float:
    """The embed's gradient norm on one device with each row's sum over
    its tokens' positions taken in f32: the lookup indexes an f32 copy of
    the table (the same forward values; no embed scale in phase 4's
    llama2-7b), so the backward's scatter-add runs in f32 and is rounded
    once.  Beside phase 4's bf16 scatter-add, whose rows of frequent
    tokens sum thousands of positions in bf16, and the mesh's, whose
    ranks sum a quarter of them each."""
    import repro_torch.models.lm as lm
    from repro_torch.training import tree
    from repro_torch.training.train_step import (_value_and_grad,
                                                 make_loss_fn)
    lookup = lm.embed_tokens

    def f32_rows(p, tokens, c):
        return lookup({**p, "embed": p["embed"].float()}, tokens,
                      c).to(p["embed"].dtype)
    lm.embed_tokens = f32_rows
    try:
        _, grads = _value_and_grad(make_loss_fn(model, cfg), params, batch)
    finally:
        lm.embed_tokens = lookup
    i = [p for p, _ in tree.leaves_with_paths(params)].index(
        "/embedding/embed")
    return grads[i].float().norm().item()


def leaf_gnorm_report(paths: list, one: list, mesh: list,
                      top: int = 3) -> list:
    """[(path, relative difference of the leaf's gradient norm, its share
    of the squared total's difference)] of the ``top`` leaves by share:
    where the mesh's step-0 grad norm departs from one device's."""
    total = sum(x * x for x in one)
    rows = [(p, abs(b - a) / a if a > 0 else math.inf, (b * b - a * a) / total)
            for p, a, b in zip(paths, one, mesh, strict=True)]
    return sorted(rows, key=lambda r: -abs(r[2]))[:top]


def resume_gate(what, resumed: list, keys: list, base: float) -> None:
    """The (data=1, model=2) restore of phase 4b's checkpoint: every
    restored leaf of every rank (params, AdamW's moments, its step) is
    that rank's slice of the saved whole (``keys``: per rank, the
    fingerprints of those slices), and the next step's loss is the same
    on every rank and within DIST_RESUME_RTOL of the (2, 2) run's."""
    for r, res in enumerate(resumed):
        if len(res["restored_keys"]) != len(keys[r]):
            raise AssertionError(f"{what}: rank {r} restored "
                                 f"{len(res['restored_keys'])} leaves, the "
                                 f"checkpoint holds {len(keys[r])}")
        bad = [i for i, (a, b) in enumerate(zip(res["restored_keys"],
                                                keys[r])) if a != b]
        if bad:
            raise AssertionError(f"{what}: rank {r}'s restored leaves {bad} "
                                 "are not its slices of the checkpoint")
    nxt = [r["next_loss"] for r in resumed]
    if len(set(nxt)) != 1 or not abs(nxt[0] - base) <= \
            DIST_RESUME_RTOL * abs(base):
        raise AssertionError(f"{what}: next losses {nxt} against (2,2)'s "
                             f"{base} (rtol {DIST_RESUME_RTOL})")


def delta_gate(what, paths: list, ranks: list, specs: list,
               moe_bound: float = None, bound: float = DIST_DELTA_RTOL,
               key: str = "delta") -> dict:
    """Each leaf's update at the mesh against one device's, as
    ||d_mesh - d_one|| / ||d_one|| with d = final - init (Adam flips the
    sign of near-zero updates, so no elementwise bound holds), from the
    ranks' pieces (``_dist_rank``'s "delta": per leaf the two squared
    norms on its piece) summed over the leaf's distinct pieces -- those
    of the ranks at coordinate 0 on every axis it is not sharded over:
    within ``bound`` (DIST_DELTA_RTOL; a MoE block's leaves within
    ``moe_bound`` where given); a leaf one device left unchanged must
    stay unchanged.  ``key`` "grad0" holds each
    leaf's step-0 gradient so (``_dist_job``'s "grad0").  Returns path
    -> that ratio (0 for unchanged leaves)."""
    from repro_torch.sharding.rules import spec_axes
    rel = {}
    name = "update" if key == "delta" else "step-0 gradient"
    for i, (path, spec) in enumerate(zip(paths, specs, strict=True)):
        b = moe_bound if moe_bound is not None and "/moe/" in path \
            else bound
        axes = spec_axes(spec)
        held = [r for r in ranks if all(
            c == 0 for a, c in r["coords"].items() if a not in axes)]
        num = sum(r[key][i][0] for r in held)
        den = sum(r[key][i][1] for r in held)
        rel[path] = (math.sqrt(num / den) if den > 0 else
                     0.0 if num == 0 else math.inf)
        if not rel[path] <= b:
            raise AssertionError(f"{what}: leaf {path}: {name} off by "
                                 f"{rel[path]:.3e} of one device's "
                                 f"(bound {b})")
    return rel


def checkpoint_leaves(ckpt_dir: str, step: int):
    """(path, tensor) of every leaf a checkpoint holds, in its order, one
    at a time, each in its stored dtype and shape (on the host)."""
    import numpy as np
    import torch
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    for i, m in enumerate(leaves):
        a = np.load(os.path.join(d, f"arr_{i}.npy"))
        if m["dtype"] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a).to(getattr(torch, m["dtype"]))
        yield m["path"], t.reshape(m["shape"])


def phase_dist_training(trained: dict, cfg=None, run: dict = None,
                        tag: str = "[4b]", experts: int = None,
                        decode: dict = None) -> dict:
    """Phase 4b: phase 4's training (llama2-7b cut to TRAIN_LAYERS, or
    ``cfg``) at (data=2, model=2), four ranks over gloo sharing the card
    (NCCL where there is a GPU a rank), held to phase 4's run
    (``dist_gate``, ``delta_gate``); its checkpoint restored at (data=1,
    model=2) for the next step; the launcher at --data 2 --model-axis 2.
    ``run`` (phase 8 (h) gives its own) sets the one-device run's
    "remat", "batch" x "seq" batches, "steps" and "layers", the
    "dist_steps" taken, whether to "checkpoint" (and then restore and
    run the launcher) and to read step 0's "leaf_gnorm"; ``experts``,
    the expert count each rank's expert leaves must hold; ``decode``, a
    phase 15 job the (2, 2) ranks run after their steps (phase 8 (h)),
    whose results come back as "decode_ranks"."""
    import torch
    from repro_torch.config import ParallelConfig, get_model_config
    from repro_torch.launch.mesh import make_mesh, spawn_ranks
    from repro_torch.launch.mesh import train_backend
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import flatten, is_spec, shard_of
    from repro_torch.training.train_step import state_specs

    ref = trained["reference"]
    run = run or dict(remat="selective", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      steps=TRAIN_STEPS, layers=TRAIN_LAYERS,
                      dist_steps=DIST_STEPS, checkpoint=True,
                      leaf_gnorm=True)
    steps = run["dist_steps"]
    t0 = time.perf_counter()
    on_card = torch.cuda.is_available()
    kind = torch.device("cuda" if on_card else "cpu")
    parallel = ParallelConfig(**DIST_MESH)
    world = parallel.pods * parallel.data * parallel.model
    cfg = cfg or dataclasses.replace(get_model_config("llama2-7b"),
                                     num_layers=TRAIN_LAYERS)
    # the rule table's layout of the one-device tree, and each rank's
    # slices of its draw (fingerprints), without a device
    meta = build_model(cfg, "cpu", parallel)
    specs = flatten(meta.param_specs(make_mesh(parallel.mesh_shape(),
                                               parallel.mesh_axes())),
                    is_spec)
    meshes = [make_mesh(parallel.mesh_shape(), parallel.mesh_axes(), r)
              for r in range(world)]
    keys = [[] for _ in range(world)]
    for t, s in zip(ref["init"], specs, strict=True):
        t = t.to(kind)
        for r, mesh in enumerate(meshes):
            keys[r].append(bits_key(shard_of(t, s, mesh)))
        del t
    # the one device's parameters after ``steps``, on the card: the ranks
    # read them through CUDA IPC
    snapshot = [t.to(kind) for t in ref["snapshot"]]
    # the launcher's choice for each world: NCCL with a GPU a rank where
    # there are as many, else gloo, the ranks sharing cuda:0
    backend = train_backend(kind, world)[0]
    out = {"backend": backend, "mesh": DIST_MESH}

    def spawn(name, n, mesh_kw, **kw):
        backend, dev_of = train_backend(kind, n)
        devs = [dev_of(r) for r in range(n)]
        log(f"{tag} {name}: {n} ranks over {backend} on {devs}")
        res = spawn_ranks(_dist_rank, n, args=(cfg, mesh_kw, dict(
            run, **kw)), device_of_rank=dev_of, backend=backend,
            init_method=f"file://{tmp}/pg-{name}",
            timeout_s=DIST_DEADLINE_S, init_timeout_s=DIST_INIT_TIMEOUT_S)
        if on_card:
            torch.cuda.ipc_collect()  # the ranks' handles on our tensors
        return res

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        ckpt = os.path.join(tmp, "ckpt") if run["checkpoint"] else None
        # the launcher needs nothing of this run: it starts with it
        launcher = stack.enter_context(_launcher(tmp, on_card)) if ckpt \
            else None
        ranks = spawn("(2,2)", world, DIST_MESH, mode="train",
                      ckpt_dir=ckpt, snapshot=snapshot, decode=decode)
        del snapshot
        decoded = [r.pop("decode") for r in ranks] if decode else None
        what = f"{tag} {cfg.name} (data=2, model=2)"
        if ckpt:
            # one read of the checkpoint: held to the ranks' pieces at
            # (2, 2), and each (1, 2) rank's slices for the restore
            t1 = time.perf_counter()
            par12 = ParallelConfig(data=1, model=2)
            meshes12 = [make_mesh(par12.mesh_shape(), par12.mesh_axes(), r)
                        for r in range(2)]
            read = read_checkpoint(ckpt, steps, {
                "(2,2)": (meshes, flatten(state_specs(meta.param_specs(
                    meshes[0])), is_spec)),
                "(1,2)": (meshes12, flatten(state_specs(meta.param_specs(
                    meshes12[0])), is_spec))}, on_card)
            ranks[0].update(
                ckpt_differs=checkpoint_differs(read, ranks, "(2,2)"),
                ckpt_files=len(read["files"]),
                ckpt_check_s=time.perf_counter() - t1)
        dist_gate(what, ranks, ref, keys, specs, run["seq"],
                  parallel.model, layers=run["layers"], steps=steps,
                  experts=experts, checkpoint=run["checkpoint"])
        rel = delta_gate(what, ref["paths"], ranks, specs,
                         MOE_DELTA_RTOL if experts is not None else None)
        worst = max(rel, key=rel.get)
        first = ranks[0]
        for r, res in enumerate(ranks):
            per = {k: sum(c[k] for c in res["collectives"]) / steps
                   for k in res["collectives"][0]}
            held = (f"{res['experts'][0]} experts a leaf, "
                    if res["experts"] else "")
            log(f"{tag} rank {r} {res['coords']} on {res['device']} "
                f"({res['backend']}): {held}step wall "
                f"{[round(x, 3) for x in res['step_s']]} s, collectives a "
                f"step {per} ({sum(res['coll_bytes']) / steps / 1e9:.3f} GB"
                f"), peak memory {res['peak_mem_gb'] or 0:.2f} GB, "
                f"fastattn_fwd {res['launches']} launches at q_offset "
                f"{res['q_offsets']}")
        for i in range(steps):
            log(f"{tag} step {i}: loss {first['loss'][i]:.5f} vs one "
                f"device's {ref['loss'][i]:.5f}, grad norm "
                f"{first['grad_norm'][i]:.5f} vs {ref['grad_norm'][i]:.5f}, "
                f"lr {first['lr'][i]:.3e}")
        rest = max((v, p) for p, v in rel.items() if "/moe/" not in p)
        moe = ""
        if experts is not None:
            moe = max(v for p, v in rel.items() if "/moe/" in p)
            moe = f", of the MoE leaves {moe:.3e} (bound {MOE_DELTA_RTOL})"
        log(f"{tag} updates against one device's: worst {worst} "
            f"{rel[worst]:.3e}; of the other leaves {rest[1]} {rest[0]:.3e} "
            f"(bound {DIST_DELTA_RTOL}){moe}; ranks initialised in "
            f"{[round(r['init_s'], 1) for r in ranks]} s")
        out.update({
            "loss": first["loss"], "grad_norm": first["grad_norm"],
            "lr": first["lr"], "ref_loss": ref["loss"][:steps],
            "ref_grad_norm": ref["grad_norm"][:steps],
            "delta_rel": rel, "worst_delta": [worst, rel[worst]],
            "launches": [r["launches"] for r in ranks],
            "q_offsets": [r["q_offsets"] for r in ranks],
            "step_s": [r["step_s"] for r in ranks],
            "collectives": [r["collectives"][-1] for r in ranks],
            "coll_bytes": [r["coll_bytes"][-1] for r in ranks],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]})
        if experts is not None:
            out["experts"] = [r["experts"][0] for r in ranks]
        if run["leaf_gnorm"]:
            gn = leaf_gnorm_report(ref["paths"], ref["leaf_gnorm"],
                                   first["leaf_gnorm"])
            log(f"{tag} step 0's gradient, leaves whose norms move the "
                "grad norm most against one device's (path, relative "
                "difference, share of the squared total's difference): "
                + ", ".join(f"{p} {r:.3e} {c:+.3e}" for p, r, c in gn))
            e = ref["paths"].index("/embedding/embed")
            embed_gn = {"one_bf16": ref["leaf_gnorm"][e],
                        "one_f32_rows": ref["embed_gnorm_f32"],
                        "mesh": first["leaf_gnorm"][e]}
            log(f"{tag} step 0's embed gradient norm: one device "
                "{one_bf16:.5f} (bf16 scatter-add), {one_f32_rows:.5f} "
                "(rows summed in f32), mesh {mesh:.5f}".format(**embed_gn))
            out.update(leaf_gnorm_step0=gn, embed_gnorm_step0=embed_gn)
        if ckpt:
            out.update(_dist_resume(tag, spawn, first, ckpt,
                                    read["keys"]["(1,2)"], launcher))
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if on_card else "cpu"
    log(f"{tag} {out['card']}: all gates passed in {out['seconds']:.1f}s "
        f"({GLOO_NOTE if backend == 'gloo' else 'nccl, one GPU a rank'})")
    log(f"{tag} " + json.dumps(out))
    if decoded:
        log(f"[15] a rank's job in {tag}'s spawn: "
            f"{[round(r['job_s'], 1) for r in decoded]} s")
        out["decode_ranks"] = decoded
    return out


@contextlib.contextmanager
def _launcher(tmp: str, on_card: bool):
    """``python -m repro_torch.launch.train`` at --data 2 --model-axis 2
    (``LAUNCHER``), as a user runs it, started now and run beside what
    follows; yields (process, stdout file, stderr file, start time) and
    kills the process if it is still running at the end."""
    cmd = [sys.executable] + LAUNCHER + ["--ckpt-dir",
                                         os.path.join(tmp, "cli")]
    if not on_card:
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with open(os.path.join(tmp, "cli.out"), "w+") as fo, \
            open(os.path.join(tmp, "cli.err"), "w+") as fe:
        cli = subprocess.Popen(cmd, env=env, stdout=fo, stderr=fe)
        try:
            yield cli, fo, fe, time.perf_counter()
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()


def _dist_resume(tag, spawn, first, ckpt, keys12, launcher) -> dict:
    """Phase 4b's checkpoint part: the (2, 2) checkpoint restored at
    (data=1, model=2) for the next step, each rank's leaves held to its
    slices of the saved ones (``keys12``, ``resume_gate``); and the
    launcher at --data 2 --model-axis 2, which ran beside the phase
    (``_launcher``), ending cleanly."""
    log(f"{tag} checkpoint of {first['ckpt_files']} files holds what a "
        f"one-rank save of the gathered state writes (each rank's "
        f"pieces, the manifest); gathered in {first['save_s']:.1f}s and "
        f"written beside the next step ({first['write_wait_s']:.1f}s "
        f"waited after it), read back and checked in "
        f"{first['ckpt_check_s']:.1f}s")
    t1 = time.perf_counter()
    resumed = spawn("(1,2)", 2, dict(data=1, model=2), mode="resume",
                    ckpt_dir=ckpt, snapshot=None, leaf_gnorm=False)
    resume_s = time.perf_counter() - t1
    cli, fo, fe, cli_t0 = launcher
    rc = cli.wait(timeout=DIST_DEADLINE_S)
    cli_s = time.perf_counter() - cli_t0
    fo.seek(0)
    fe.seek(0)
    cli_out, cli_err = fo.read(), fe.read()
    for line in cli_out.splitlines():
        log(f"{tag} launcher: {line}")
    if rc != 0 or "done" not in cli_out:
        raise AssertionError(f"{tag} launcher failed ({rc}):\n"
                             f"{cli_err[-3000:]}")
    nxt = [r["next_loss"] for r in resumed]
    base = first["next_loss"]
    log(f"{tag} next step after the checkpoint: (2,2) {base:.6f}, "
        f"restored at (1,2) {nxt}")
    resume_gate(f"{tag} restored at (1,2)", resumed, keys12, base)
    log(f"{tag} restored at (1,2): each rank's {len(keys12[0])} leaves "
        "(params, moments, step) are its slices of the checkpoint")
    return {"next_loss": base, "resumed_next_loss": nxt,
            "save_s": first["save_s"], "resume_s": resume_s,
            "launcher_s": cli_s}


# ---------------------------------------------------------------------------
# phase 5: the paper's CPU-GPU cooperative offload
# ---------------------------------------------------------------------------

OFFLOAD_SEQ = 65536


def _host_memory_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2 ** 20      # kB -> GiB
    raise AssertionError("MemTotal not in /proc/meminfo")


def _wall_ms(fn, reps: int = 10):
    """Median host wall time of ``fn()`` (synchronised) and its last
    result."""
    import torch
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase_offload() -> dict:
    """Per-layer decode attention at llama2-7b's layer shape, B=1,
    S=65536: the cooperative strategy (KV on the host, attention there,
    only Q and the output cross PCIe) against classical offloading
    (upload the layer's KV, then the kernel)."""
    import dataclasses as dc

    import torch
    from repro_torch.config import get_model_config
    from repro_torch.core.offload import (HostOffloadEngine,
                                          OffloadLatencyModel,
                                          max_context_length, plan_offload,
                                          table3_row)
    from repro_torch.kernels.flash_decode.ops import flash_decode

    cfg = get_model_config("llama2-7b")
    for seq in (131072, 196608):
        plan = plan_offload(cfg, batch=1, seq_len=seq, gen_len=64,
                            n_devices=1, device_memory_gb=80.0)
        log(f"[offload] plan_offload {cfg.name} B=1 S={seq} gen 64, one "
            f"80 GB device: {plan.summary()}")
    host_gb = _host_memory_gb()
    ctx = max_context_length(cfg, batch=1, n_devices=1,
                             device_memory_gb=80.0, host_memory_gb=host_gb)
    log(f"[offload] max_context_length with {host_gb:.1f} GiB of host "
        f"memory: {ctx['device_only']} tokens on the device alone, "
        f"{ctx['cooperative']} with the cooperative strategy")

    s, hkv, d = OFFLOAD_SEQ, cfg.num_kv_heads, cfg.head_dim
    plan = dc.replace(plan_offload(cfg, batch=1, seq_len=s, gen_len=64,
                                   n_devices=1),
                      l_gpu=cfg.num_layers - 2, l_cpu=2, needs_offload=True)
    t0 = time.perf_counter()
    eng = HostOffloadEngine(cfg, plan, max_batch=1, max_seq=s)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k, v = (torch.randn((1, s, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    for layer in range(plan.l_cpu):
        eng.prefill_offload(layer, k[:, :s - 1], v[:, :s - 1])
        eng.decode_append(layer, k[:, s - 1:], v[:, s - 1:], s - 1)
    torch.cuda.synchronize()
    host_kv_gb = 2 * s * hkv * d * 4 / 1e9
    log(f"[offload] HostOffloadEngine l_cpu={plan.l_cpu}: host KV "
        f"{host_kv_gb:.2f} GB a layer (f32, pinned), filled by "
        f"prefill_offload + one decode_append in "
        f"{time.perf_counter() - t0:.1f}s")

    q = torch.randn((1, 1, cfg.num_heads, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.full((1,), s, dtype=torch.int32)
    eng.decode_attention(0, q, lens)                      # warm-up
    down_ms, q_h = _wall_ms(lambda: q.to("cpu"))
    host_ms, out_h = _wall_ms(lambda: eng.host_attention(0, q_h, lens))
    up_ms, _ = _wall_ms(lambda: out_h.to("cuda"))
    coop_ms, coop = _wall_ms(lambda: eng.decode_attention(0, q, lens))

    # classical: the layer's bf16 KV in pinned host memory, uploaded, then
    # the kernel on it
    k_h, v_h = (t.cpu().pin_memory() for t in (k, v))
    k_d, v_d = torch.empty_like(k), torch.empty_like(v)
    lens_d = lens.cuda()
    kv_bytes = 2 * k.numel() * k.element_size()

    def upload():
        k_d.copy_(k_h, non_blocking=True)
        v_d.copy_(v_h, non_blocking=True)

    def classical():
        upload()
        return flash_decode(q[:, 0], k_d, v_d, lens_d, layout="bshd")
    classical()
    upload_ms = time_ms(upload, reps=10)
    calc_ms = time_ms(lambda: flash_decode(q[:, 0], k_d, v_d, lens_d,
                                           layout="bshd"), reps=10)
    calc_device_ms = device_ms(lambda: flash_decode(q[:, 0], k_d, v_d,
                                                    lens_d, layout="bshd"))
    classical_ms, ref = _wall_ms(classical)
    # every query head's output to its own scale
    err, rel = held_to_plain("offload", "host output vs flash_decode on "
                             "the uploaded KV", coop[:, 0].reshape(-1, d),
                             ref.reshape(-1, d), "bfloat16")

    # the host KV is f32 (JAX's layout), twice the bytes the classical path
    # uploads: host attention once more over the pinned bf16 copies, for a
    # comparison of equal bytes (f32 math on 4096-key slices widened from
    # bf16, so the bf16 bytes are read once)
    g, step = cfg.num_heads // hkv, 4096
    slices = [slice(i, i + step) for i in range(0, s, step)]

    def host_bf16():
        qg = q_h[0, 0].float().reshape(hkv, g, d) * d ** -0.5
        logits = torch.cat([torch.einsum("hgd,shd->hgs", qg,
                                         k_h[0, sl].float())
                            for sl in slices], dim=-1)
        p = torch.softmax(logits, dim=-1)
        out = sum(torch.einsum("hgs,shd->hgd", p[..., sl], v_h[0, sl].float())
                  for sl in slices)
        return out.reshape(1, -1, d).to(q_h.dtype)
    host_bf16_ms, out_b = _wall_ms(host_bf16, reps=5)
    held_to_plain("offload", "bf16 host attention vs flash_decode",
                  out_b.reshape(-1, d), ref.cpu().reshape(-1, d), "bfloat16")

    flops = 4.0 * s * cfg.q_dim
    pcie_gbps = kv_bytes / (upload_ms / 1e3) / 1e9
    host_gflops = flops / (host_ms / 1e3) / 1e9
    model = OffloadLatencyModel(pcie_gbps=pcie_gbps, host_gflops=host_gflops)
    pred_classical = (model.classical_upload_s(kv_bytes)
                      + model.device_attention_s(1, s, cfg.q_dim)) * 1e3
    pred_coop = (model.host_attention_s(1, s, cfg.q_dim)
                 + model.coop_offupload_s(1, cfg.q_dim)) * 1e3
    rows = [table3_row(cfg, seq, n_devices=1, model=model)
            for seq in (131072, 196608)]
    res = {"seq": s, "host_kv_gb_per_layer": host_kv_gb,
           "coop_ms": coop_ms, "coop_q_down_ms": down_ms,
           "coop_host_attention_ms": host_ms, "coop_out_up_ms": up_ms,
           "classical_ms": classical_ms, "classical_upload_ms": upload_ms,
           "classical_kernel_ms": calc_ms,
           "classical_kernel_device_ms": calc_device_ms,
           "classical_over_coop": classical_ms / coop_ms,
           "pinned_h2d_gbps": pcie_gbps, "host_attention_gflops":
           host_gflops, "predicted_classical_ms": pred_classical,
           "predicted_coop_ms": pred_coop,
           "host_attention_bf16_kv_ms": host_bf16_ms,
           "table3_rows": rows, "max_abs_err": err, "rel_err": rel,
           "host_memory_gib": host_gb, "max_context": ctx}
    log(f"[offload] cooperative {coop_ms:.2f} ms a layer (Q down "
        f"{down_ms:.3f}, host attention over {host_kv_gb:.2f} GB of f32 KV "
        f"{host_ms:.2f}, output up {up_ms:.3f}); classical "
        f"{classical_ms:.2f} ms (upload of {kv_bytes / 1e9:.2f} GB of bf16 "
        f"KV {upload_ms:.2f}, flash_decode {calc_ms:.3f}, on the device "
        f"{calc_device_ms:.3f}); classical / "
        f"cooperative {classical_ms / coop_ms:.3f} (the paper's Table 3: "
        f"1.27-1.48); host attention over the {kv_bytes / 1e9:.2f} GB of "
        f"bf16 KV {host_bf16_ms:.2f} ms")
    log(f"[offload] measured: pinned host->device {pcie_gbps:.2f} GB/s, "
        f"host attention {host_gflops:.2f} GFLOP/s; the latency model "
        f"with them predicts classical {pred_classical:.2f} ms, "
        f"cooperative {pred_coop:.2f} ms at S={s}")
    for row in rows:
        log(f"[offload] table3_row S={row['seq']} (measured constants): "
            + json.dumps({k: v for k, v in row.items() if k != "seq"}))
    log("[offload] " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 6: xlstm-125m at full width and depth
# ---------------------------------------------------------------------------

XLSTM_BATCH, XLSTM_SEQ, XLSTM_STEPS = 8, 2048, 3
XLSTM_PROMPT, XLSTM_NEW = 128, 32
# (b) trains the first 3 of the 12 layers (mlstm, mlstm, slstm: both block
# kinds and the kernel): the two sLSTM time loops were about half of a
# 12-layer step, and the script's time limit pays for phase 11 with them.
# (b) runs at 8 x XLSTM_TRAIN_SEQ: the sLSTM time loop, 70% of a step,
# walks the sequence one position at a time, and (b)'s profiled step and
# timed loop took 103 s of the time limit at 2048 (45 s at 1024)
XLSTM_TRAIN_LAYERS = 3
XLSTM_TRAIN_SEQ = 512


def _profile_kernels(fn):
    """Run ``fn()`` under torch.profiler (kernels only) and return its
    kernel events and their summed device time in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    total = sum(_device_us(e) for e in kernels) / 1e6
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return kernels, total


def _wall_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _logit_err(got, ref) -> tuple:
    """(max abs difference, that over max |ref|, the median over
    positions of each position's max difference over max |ref|)."""
    import torch
    v = ref.shape[-1]
    diff = (got.float() - ref.float()).abs().reshape(-1, v).amax(-1)
    scale = ref.float().abs().max().item()
    return (diff.max().item(), diff.max().item() / scale,
            torch.median(diff).item() / scale)


@contextlib.contextmanager
def _perturbed_h(seed: int = 9, path: str = "reference",
                 device: str = "cuda"):
    """Within the block, every mlstm block runs ``path`` (the plain version
    or the kernel, whatever impl the model passes) with one bf16 ulp added to a seeded 1% of the elements
    of its h: what rounding alone does downstream.  (The mLSTM output h = q C / max(|q.n|,
    exp(-m)) changes fast where q.n crosses 0; with random weights ten
    such blocks make a 1-ulp difference as large as the logits
    themselves, so two correct paths that round h at different places
    disagree end to end by about the logits' scale, and their gradient
    norms by far more than 5%.)"""
    import torch
    from repro_torch.layers import ssm
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    chunkwise = ssm.mlstm_chunkwise

    def perturbed(q, k, v, ig, fg, chunk=128, impl=None):
        h = chunkwise(q, k, v, ig, fg, chunk, impl=path)
        hb = h.to(torch.bfloat16).float()
        flip = torch.rand(h.shape, generator=gen, device=device) < 0.01
        return torch.where(flip, hb + hb.abs() * 2 ** -7, hb)
    ssm.mlstm_chunkwise = perturbed
    try:
        yield
    finally:
        ssm.mlstm_chunkwise = chunkwise


def _end_to_end_gate(what, err, base, rtol) -> None:
    """End to end the kernel and plain paths may differ by what rounding
    alone does (``base``, the largest difference measured under
    _perturbed_h), so the gate is ``rtol`` or twice that, whichever is
    larger: it catches non-finite or exploding results; the blocks
    themselves are held to their plain versions one by one on the same
    inputs, forward and backward (phase 6a)."""
    tol = max(rtol, 2 * base)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel and plain paths differ by "
                             f"{err:.3g} (relative), above {tol:.3g}")


def _loss_and_gnorm(model, params, batch, impl):
    """The loss and gradient norm of ``batch`` ({"tokens", "labels"}, and
    for an encoder-decoder "enc_embeds"; for the vision stub
    {"inputs_embeds", "positions", "labels"}) through attention
    ``impl``."""
    import torch
    from repro_torch.training import tree
    from repro_torch.training.optimizer import global_norm
    if "inputs_embeds" in batch:
        args, kw = (None, batch["labels"]), {
            "inputs_embeds": batch["inputs_embeds"],
            "positions": batch.get("positions")}
    else:
        keys = (("enc_embeds",) if model.cfg.is_encoder_decoder else ()) \
            + ("tokens", "labels")
        args, kw = tuple(batch[k] for k in keys), {}
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, *args, impl=impl, **kw)
        # a vision batch never reads the token table: no gradient there
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.item(), global_norm([g for g in grads
                                     if g is not None]).item()


def phase_xlstm() -> dict:
    """xlstm-125m (12 layers: 10 mLSTM blocks through mlstm_chunkwise.cu,
    2 sLSTM blocks) at full width and depth, random weights from a seeded
    CUDA generator: (a) LM.apply on 8 x 2048 tokens, kernel vs plain; (b)
    XLSTM_STEPS AdamW steps through the trainer's functions on the first
    XLSTM_TRAIN_LAYERS layers at 8 x XLSTM_TRAIN_SEQ; (c) ServeEngine.generate through the
    recurrent cells, held to (a)."""
    import math

    import numpy as np
    import torch

    from repro_torch.config import (ParallelConfig, ServeConfig,
                                    TrainConfig, get_model_config)
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.layers import ssm
    from repro_torch.models import blocks as B
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training import tree
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_model_config("xlstm-125m")
    kinds = cfg.blocks()
    n_mlstm = kinds.count("mlstm")
    parallel = ParallelConfig(remat="selective")   # as launch/train.py
    b, s = XLSTM_BATCH, XLSTM_SEQ
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", parallel)
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"[xlstm] {cfg.name}: {cfg.num_layers} layers ({n_mlstm} mlstm, "
        f"{kinds.count('slstm')} slstm), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f}M params ({cfg.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- (a) forward through the kernel ----------------------------------
    # Each mlstm block's input is captured on the way, so that every block
    # can be held to its plain version (and to the recurrent cells) on the
    # very inputs the main path gave it: end to end the bf16 model is too
    # ill-conditioned for a logit comparison to test the kernel (see
    # _perturbed_plain below).
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)).cuda()
    apply_mlstm = ssm.apply_mlstm
    captured = []

    def capturing(bp, x, c, **kw):
        captured.append((bp, x))
        return apply_mlstm(bp, x, c, **kw)
    v = cfg.vocab_size
    with torch.no_grad():
        ssm.apply_mlstm = capturing
        try:
            mlstm_chunkwise_fwd.launches = 0
            fwd_s, logits = _wall_s(lambda: model.apply(params, tokens))
            fwd_launches = mlstm_chunkwise_fwd.launches
        finally:
            ssm.apply_mlstm = apply_mlstm
        log(f"[xlstm] (a) LM.apply B={b} S={s} through the kernel: "
            f"{fwd_s:.2f}s; mlstm_chunkwise_fwd launches {fwd_launches} "
            f"(expected {n_mlstm}, one per mlstm block)")
        if fwd_launches != n_mlstm or len(captured) != n_mlstm:
            raise AssertionError(f"mlstm_chunkwise_fwd launched "
                                 f"{fwd_launches} times, expected {n_mlstm}")
        if logits.shape != (b, s, v) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        # every block: the kernel's output against the plain version's,
        # and the recurrent cells' (generate's path) over the first
        # XLSTM_PROMPT positions, on the main path's own inputs
        p = XLSTM_PROMPT
        blk = {"kernel_vs_plain": [0.0, 0.0], "recurrent_vs_kernel": [0.0, 0.0],
               "grad_kernel_vs_plain": [0.0, 0.0]}
        for i, (bp, x) in enumerate(captured):
            out_k = apply_mlstm(bp, x, cfg)
            out_p = apply_mlstm(bp, x, cfg, impl="reference")
            out_r, _ = ssm.mlstm_decode(bp, x[:, :p], cfg)
            for key, got, want in (
                    ("kernel_vs_plain", out_k, out_p),
                    ("recurrent_vs_kernel", out_r, out_k[:, :p])):
                e = held_to_plain("xlstm", f"mlstm block {i} output, "
                                  f"{key.replace('_', ' ')}",
                                  got.flatten(0, 1), want.flatten(0, 1),
                                  "bfloat16", unbounded=True)
                blk[key] = [max(a, c) for a, c in zip(blk[key], e)]
            # backward: the gradients of the block's input and weights
            # for one seeded upstream gradient, kernel path vs plain path
            gen = torch.Generator(device="cuda")
            gen.manual_seed(100 + i)
            g = torch.randn(out_k.shape, generator=gen,
                            device="cuda").to(out_k.dtype)
            grads = {}
            for impl in (None, "reference"):
                leaves = {k: t.detach().requires_grad_()
                          for k, t in bp.items()}
                xg = x.detach().requires_grad_()
                with torch.enable_grad():
                    out = apply_mlstm(leaves, xg, cfg, impl=impl)
                    grads[impl] = torch.autograd.grad(
                        out, [xg, *leaves.values()], g)
            for name, got, want in zip(["x", *bp], grads[None],
                                       grads["reference"]):
                e = held_to_plain("xlstm", f"mlstm block {i} gradient of "
                                  f"{name}, kernel vs plain",
                                  got.reshape(got.shape[0], -1)
                                  if got.dim() > 1 else got[None],
                                  want.reshape(want.shape[0], -1)
                                  if want.dim() > 1 else want[None],
                                  "bfloat16", unbounded=True)
                blk["grad_kernel_vs_plain"] = [
                    max(a, c) for a, c in zip(blk["grad_kernel_vs_plain"], e)]
        del captured, out_k, out_p, out_r, grads
        ref_s, ref = _wall_s(lambda: model.apply(params, tokens,
                                                 impl="reference"))
        with _perturbed_h():
            base = model.apply(params, tokens, impl="reference")
    fwd_err = _logit_err(logits, ref)
    base_err = _logit_err(base, ref)
    last_prompt = logits[:, XLSTM_PROMPT - 1].float()
    last_base = (base_err, _logit_err(base[:, XLSTM_PROMPT - 1],
                                      ref[:, XLSTM_PROMPT - 1]))
    del logits, ref, base
    log(f"[xlstm] (a) end to end, kernel vs plain path ({ref_s:.2f}s): "
        f"logits differ by {fwd_err[0]:.4f}, {fwd_err[1]:.3f} of their scale "
        f"(median position {fwd_err[2]:.3f}); the plain path against itself "
        f"with 1% of every mlstm h moved by one bf16 ulp: {base_err[0]:.4f}, "
        f"{base_err[1]:.3f} (median {base_err[2]:.3f})")
    _end_to_end_gate("LM.apply logits", fwd_err[1], base_err[1], LOGIT_TOL)

    # ---- (c) serving through the recurrent cells --------------------------
    prompts = tokens[:, :XLSTM_PROMPT].cpu().numpy()
    serve = ServeConfig(max_seq_len=XLSTM_PROMPT + XLSTM_NEW + 1, top_k=1)
    engine = ServeEngine(model=model, params=params, cfg=cfg, serve=serve)
    seen = {}
    decode = engine._decode

    def recording(tok, cache, pos):
        out, cache = decode(tok, cache, pos)
        if pos == XLSTM_PROMPT - 1:
            seen["logits"] = out.float()
        return out, cache
    engine._decode = recording
    mlstm_chunkwise_fwd.launches = 0
    gen_s, out = _wall_s(lambda: engine.generate(prompts, XLSTM_NEW))
    engine._decode = decode
    if mlstm_chunkwise_fwd.launches != 0:
        raise AssertionError("generate launched the chunkwise kernel")
    out = out.cpu().numpy()
    if out.shape != (b, XLSTM_NEW) or not ((0 <= out) & (out < v)).all():
        raise AssertionError(f"bad generated tokens {out.shape}")
    dec_err = _logit_err(seen["logits"], last_prompt)
    log(f"[xlstm] (c) recurrent decode_step logits at position "
        f"{XLSTM_PROMPT - 1} vs (a)'s kernel LM.apply: {dec_err[0]:.4f}, "
        f"{dec_err[1]:.3f} of their scale; the perturbed plain path there: "
        f"{last_base[1][0]:.4f}, {last_base[1][1]:.3f}")
    _end_to_end_gate("decode_step logits", dec_err[1], last_base[1][1],
                     LOGIT_TOL)
    steps = XLSTM_PROMPT + XLSTM_NEW - 1
    tok_s = engine.throughput_tokens_per_s(b, XLSTM_PROMPT, n_new=8)
    log(f"[xlstm] (c) generate B={b} x {XLSTM_PROMPT} prompt + {XLSTM_NEW} "
        f"greedy: {gen_s:.2f}s for {steps} decode steps "
        f"({gen_s / steps * 1e3:.1f} ms a step, {b * XLSTM_NEW / gen_s:.1f} "
        f"new tok/s, prompt teacher-forced); throughput_tokens_per_s(B={b}, "
        f"prompt {XLSTM_PROMPT}, 8 steps) {tok_s:.1f} tok/s")
    # where a decode step's device time goes: 9 decode steps (a 4-token
    # prompt, one warm-up step and 4 timed ones) under the profiler
    dec_kernels, dec_dev = _profile_kernels(
        lambda: engine.throughput_tokens_per_s(b, 4, n_new=4))
    dec_groups = {}
    for e in dec_kernels:
        grp = _train_group(e.key)
        dec_groups[grp] = dec_groups.get(grp, 0.0) + _device_us(e) / 9e6
    dec_step_dev = dec_dev / 9
    log(f"[xlstm] (c) a decode step: {dec_step_dev * 1e3:.2f} ms of kernels "
        f"against {gen_s / steps * 1e3:.1f} ms of wall (idle share "
        f"{1 - dec_step_dev / (gen_s / steps):.3f}), "
        f"{sum(e.count for e in dec_kernels) / 9:.0f} kernels a step")
    for grp, sec in sorted(dec_groups.items(), key=lambda kv: -kv[1]):
        log(f"[xlstm]   {sec * 1e3:9.3f} ms  {grp}")
    del engine, seen, last_prompt, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) training, on the first XLSTM_TRAIN_LAYERS layers --------------
    del model
    gc.collect()
    torch.cuda.empty_cache()
    full_layers = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=XLSTM_TRAIN_LAYERS)
    kinds = cfg.blocks()
    n_mlstm = kinds.count("mlstm")
    s = XLSTM_TRAIN_SEQ
    model = build_model(cfg, "cuda", parallel)
    log(f"[xlstm] (b) trains the first {cfg.num_layers} layers "
        f"({', '.join(kinds)}) on {b} x {s} tokens")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=XLSTM_STEPS)
    state = init_train_state(model, model.generator(tcfg.seed))
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=v, seq_len=s,
                                    global_batch=b))
    mlstm_chunkwise_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(XLSTM_STEPS):
        batch = to_device(data.next(), model.device)
        dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        log(f"[xlstm] (b) step {i} loss {losses[-1]:.4f} gnorm "
            f"{float(metrics['grad_norm']):.4f} {dt * 1e3:.1f} ms")
    launches = mlstm_chunkwise_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = n_mlstm * (2 if parallel.remat != "none" else 1) * XLSTM_STEPS
    log(f"[xlstm] (b) mlstm_chunkwise_fwd launches on the training path: "
        f"{launches} (expected {n_mlstm} blocks x 2 forward passes under "
        f"remat x {XLSTM_STEPS} steps = {expected})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"mlstm_chunkwise_fwd launched {launches} "
                             f"times, expected {expected}")
    steady_s = statistics.median(step_s[1:])
    train_tok_s = b * s / steady_s

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(XLSTM_STEPS, state, extras={"data": data.state()})
        restored, _ = mgr.restore(state)
        for (path, x), y in zip(tree.leaves_with_paths(restored),
                                tree.leaves(state)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"checkpoint leaf {path} changed")
        del restored
    log("[xlstm] (b) checkpoint saved and restored bit for bit")

    # kernel path vs plain path on one batch: loss and gradient norm,
    # beside the plain path under _perturbed_h
    one = to_device(data.next(), model.device)
    (k_loss, k_gn), (p_loss, p_gn) = (
        _loss_and_gnorm(model, state.params, one, impl)
        for impl in (None, "reference"))
    # both paths again under two perturbations of h each (seeded)
    perturbed = {impl: [] for impl in ("reference", "kernel")}
    for impl, runs in perturbed.items():
        for seed in (9, 10):
            with _perturbed_h(seed, impl):
                runs.append(_loss_and_gnorm(model, state.params, one,
                                            "reference"))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    gn_rel = abs(k_gn - p_gn) / abs(p_gn)
    base_loss = max(abs(q - p_loss) / abs(p_loss)
                    for q, _ in perturbed["reference"])
    base_gn = max(abs(q - p_gn) / abs(p_gn)
                  for _, q in perturbed["reference"])
    log(f"[xlstm] (b) kernel vs plain path, {b} x {s}: loss {k_loss:.5f} vs "
        f"{p_loss:.5f} (rel {loss_rel:.2e}), grad norm {k_gn:.5f} vs "
        f"{p_gn:.5f} (rel {gn_rel:.2e})")
    for impl, runs in perturbed.items():
        log(f"[xlstm] (b) the {impl} path under two perturbations of h: "
            f"losses {', '.join(f'{q:.5f}' for q, _ in runs)}, grad norms "
            f"{', '.join(f'{q:.5f}' for _, q in runs)}")
    _end_to_end_gate("loss", loss_rel, base_loss, LOSS_RTOL)
    # the gradient norm of this model is heavy-tailed (a position where
    # |q.n| nearly cancels contributes ~1/den^2), so end to end it is only
    # guarded against exploding: within a factor of 2
    if not (math.isfinite(k_gn) and 0.5 <= k_gn / p_gn <= 2.0):
        raise AssertionError(f"grad norm {k_gn} against the plain path's "
                             f"{p_gn}")

    # one more step under the profiler: where the device time goes
    batch = to_device(data.next(), model.device)
    kernels, total_s = _profile_kernels(lambda: step_fn(state, batch))
    ml = [e for e in kernels if MLSTM_KERNELS in e.key]
    ml_s = sum(_device_us(e) for e in ml) / 1e6
    groups = {}
    for e in kernels:
        grp = _train_group(e.key)
        groups[grp] = groups.get(grp, 0.0) + _device_us(e) / 1e6

    # the sLSTM time loop alone: one slstm block's forward and backward at
    # the training shape, wall time and device time
    layer = kinds.index("slstm")
    bp = state.params["layers"][layer]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.arange(s, device="cuda").expand(b, s)

    def slstm_fwd():
        with torch.no_grad():
            return B.apply_block(bp, x, cfg, "slstm", positions=pos)

    def slstm_fwd_bwd():
        y = B.apply_block(bp, x, cfg, "slstm", positions=pos)
        return torch.autograd.grad(y, x, g)
    sl_fwd_s, _ = _wall_s(slstm_fwd)
    sl_fb_s, _ = _wall_s(slstm_fwd_bwd)
    _, sl_fwd_dev = _profile_kernels(slstm_fwd)
    _, sl_fb_dev = _profile_kernels(slstm_fwd_bwd)
    n_sl = kinds.count("slstm")
    # a step runs each block's forward twice (remat) and its backward once
    sl_wall = n_sl * (sl_fwd_s + sl_fb_s)
    sl_dev = n_sl * (sl_fwd_dev + sl_fb_dev)
    del x, g

    out = {"layers": full_layers, "train_layers": cfg.num_layers,
           "params": n_params, "batch": b, "seq": XLSTM_SEQ,
           "train_seq": s, "forward_s": fwd_s, "forward_plain_s": ref_s,
           "forward_launches": fwd_launches,
           "forward_logit_err": fwd_err, "perturbed_plain_logit_err": base_err,
           "block_kernel_vs_plain": blk["kernel_vs_plain"],
           "block_recurrent_vs_kernel": blk["recurrent_vs_kernel"],
           "block_grad_kernel_vs_plain": blk["grad_kernel_vs_plain"],
           "generate_s": gen_s,
           "generate_ms_per_step": gen_s / steps * 1e3,
           "generate_new_tok_s": b * XLSTM_NEW / gen_s,
           "decode_step_device_ms": dec_step_dev * 1e3,
           "decode_step_idle_share": 1 - dec_step_dev / (gen_s / steps),
           "decode_step_groups_ms": {k: x * 1e3 for k, x in
                                     dec_groups.items()},
           "throughput_tokens_per_s": tok_s, "decode_logit_err": dec_err,
           "perturbed_plain_logit_err_at_prompt_end": last_base[1],
           "steps": XLSTM_STEPS,
           "losses": losses, "step_s": step_s, "steady_step_s": steady_s,
           "tok_s": train_tok_s, "peak_mem_gb": peak_gb,
           "launches": launches, "loss_rel": loss_rel, "gnorm_rel": gn_rel,
           "perturbed_loss_rel": base_loss, "perturbed_gnorm_rel": base_gn,
           "perturbed_loss_gnorm": perturbed, "loss_gnorm": [
               [k_loss, k_gn], [p_loss, p_gn]],
           "profiled_kernel_s": total_s, "mlstm_s": ml_s,
           "mlstm_calls": sum(e.count for e in ml),
           "mlstm_share_of_kernels": ml_s / total_s,
           "mlstm_share_of_step": ml_s / steady_s,
           "idle_share": 1.0 - total_s / steady_s,
           "groups_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "slstm_block_fwd_s": sl_fwd_s, "slstm_block_fwd_bwd_s": sl_fb_s,
           "slstm_block_fwd_device_s": sl_fwd_dev,
           "slstm_block_fwd_bwd_device_s": sl_fb_dev,
           "slstm_share_of_step": sl_wall / steady_s,
           "slstm_share_of_kernels": sl_dev / total_s,
           "card": _card()}
    log(f"[xlstm] (b) {out['card']}: steady step {steady_s * 1e3:.1f} ms "
        f"(median of steps 1-{XLSTM_STEPS - 1}), {train_tok_s:.0f} tok/s, "
        f"peak memory {peak_gb:.1f} GB")
    log(f"[xlstm] (b) profiled step: kernels {total_s:.4f}s (idle share "
        f"{out['idle_share']:.3f}); mlstm_chunkwise.cu {ml_s:.4f}s in "
        f"{out['mlstm_calls']} CUDA kernels (gates, states, outputs a "
        f"wrapper launch; {out['mlstm_share_of_kernels']:.1%}"
        f" of kernel time, {out['mlstm_share_of_step']:.1%} of the step)")
    log(f"[xlstm] (b) sLSTM time loop, one block at {b} x {s}: forward "
        f"{sl_fwd_s:.3f}s wall / {sl_fwd_dev:.4f}s device, forward + "
        f"backward {sl_fb_s:.3f}s / {sl_fb_dev:.4f}s; the step's {n_sl} "
        f"blocks (forward, remat recompute, backward): "
        f"{out['slstm_share_of_step']:.1%} of the step's wall time, "
        f"{out['slstm_share_of_kernels']:.1%} of its kernel time")
    for grp, sec in out["groups_s"].items():
        log(f"[xlstm]   {sec:9.4f}s  {grp}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"[xlstm]   {_device_us(e) / 1e6:9.4f}s {e.count:6d}x "
            f"{e.key[:90]}")
    log("[xlstm] " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 7: head dims 80 and 96 -- stablelm-3b and phi3-mini-3.8b served
# ---------------------------------------------------------------------------

APPLY_TOKENS = 2048           # (c): LM.apply on 1 x APPLY_TOKENS
# each model runs its first HEAD_DIM_LAYERS of 32 layers, every gate at
# that depth: the cut that pays, with phase 8's, for the time limit
HEAD_DIM_LAYERS = 16


def apply_tokens(model):
    """(c)'s 1 x APPLY_TOKENS tokens (numpy seed 0), on the model's
    device."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(1, APPLY_TOKENS)).astype(np.int32)
    ).to(model.device)


def apply_check(model, params, tag: str, rel_tol: float = None) -> int:
    """``LM.apply`` on 1 x APPLY_TOKENS tokens through the kernels: exactly
    one fastattn_fwd launch a layer, logits within ``rel_tol`` (LOGIT_TOL
    by default) of the plain path's.  Returns the launches."""
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    layers = model.cfg.num_layers
    toks = apply_tokens(model)
    with torch.no_grad():
        fastattn_fwd.launches = 0
        logits = model.apply(params, toks)
        torch.cuda.synchronize()
        launches = fastattn_fwd.launches
        ref = model.apply(params, toks, impl="reference")
    log(f"{tag}: LM.apply 1 x {APPLY_TOKENS}, fastattn_fwd launches "
        f"{launches} (expected {layers})")
    if launches != layers:
        raise AssertionError(f"{tag}: fastattn_fwd launched {launches} "
                             f"times, expected {layers}")
    _compare_logits(f"{tag}: LM.apply logits, kernel vs plain", logits[0],
                    ref[0], rel_tol)
    return launches


def phase_head_dims() -> dict:
    """Phase 7: each model of HEAD_DIM_ARCHS at full width, its first
    HEAD_DIM_LAYERS layers (bf16, random weights from a seeded CUDA
    generator, freed before the next):
    (a) phase 3's paged serving (``phase_serving``: 12 requests, no page
    left, first chunk and a decode step within LOGIT_TOL of the plain
    path), each paged kernel exactly one launch a layer a prefill launch
    or decode step; (b) phase 3b's dense generation (``phase_dense``:
    flash_decode exactly layers x 159 launches, greedy tokens equal the
    paged engine's under the margin rule, decode_step logits within
    LOGIT_TOL); (c) ``LM.apply`` on 1 x APPLY_TOKENS tokens, exactly one
    fastattn_fwd launch a layer, logits within LOGIT_TOL of the plain
    path's.  Returns per head dim the launches of each kernel, and (b)'s
    flash_decode numbers at generate's own caches."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for d, arch in sorted(HEAD_DIM_ARCHS.items()):
        t1 = time.perf_counter()
        model, params = build_full(arch, HEAD_DIM_LAYERS)
        cfg = model.cfg
        if cfg.head_dim != d:
            raise AssertionError(f"{arch}: head_dim {cfg.head_dim} != {d}")
        layers = cfg.num_layers
        log(f"[head_dims] {arch}: head_dim {d}, {layers} layers, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, norm "
            f"{cfg.norm_type}")
        served = phase_serving(model, params)
        serve_gate(f"[head_dims] {arch}", served, layers)
        dense = phase_dense(model, params)

        launches = apply_check(model, params, f"[head_dims] {arch}")
        out[d] = {"arch": arch, "launches": {
            **served["launches"], "flash_decode": dense["launches"],
            "fastattn_fwd": launches}, "flash_decode": dense["kernel"],
            "serve": {k: served[k] for k in (
                "wall_s", "prefill_tok_s", "decode_tok_s", "steps",
                "peak_mem_gb")},
            "generate_tok_s": dense["tokens_per_s_generate"],
            "seconds": time.perf_counter() - t1}
        log(f"[head_dims] {arch}: {json.dumps(out[d])}")
        del model, params, dense, served
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[head_dims] phase 7 in {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 8: the mixture-of-experts block -- qwen3-moe-30b-a3b served
# ---------------------------------------------------------------------------

ROUTER_FLIP = 0.01            # G: the share of router inputs moved 1 ulp
# (b) compares dense generate (one token a launch: cap 1, no drop) with
# the paged engine on the same weights at this capacity factor, the JAX
# package's own for its decode-vs-prefill comparison: cap 256 of a
# 512-token chunk's slots an expert holds a 128-token prompt's every
# assignment, however skewed the routing (random weights route most
# tokens of a chunk alike: at 1.25, (a) drops most assignments)
NO_DROP_CF = 8.0


class DropLog:
    """Capacity drops of a MoE model's blocks: each prefill launch's
    (dropped, total) assignments of its valid tokens summed over its
    blocks (``launches``), and those of every other forward
    (``other``: decode steps, whose rows are all valid)."""

    def __init__(self, active: bool):
        self.active = active
        self.launches: list = []
        self.other = [0, 0]
        self.layers: list = []      # prefill launches' drops per block
        self.n_valid = None         # set while a prefill launch runs
        self._block = 0

    def start_launch(self, n_valid) -> None:
        self.n_valid, self._block = n_valid, 0
        self.launches.append([0, 0])

    def add(self, dropped: int, total: int) -> None:
        if self.n_valid is None:
            acc = self.other
        else:
            if self._block == len(self.layers):
                self.layers.append([0, 0])
            acc = self.launches[-1]
            self.layers[self._block][0] += dropped
            self.layers[self._block][1] += total
            self._block += 1
        acc[0] += dropped
        acc[1] += total

    def shares(self) -> list:
        return [d / t for d, t in self.launches]

    def layer_shares(self) -> list:
        return [d / t for d, t in self.layers]


@contextlib.contextmanager
def _wrapped(owner, name: str, wrap):
    """Within the block, ``owner.name`` is ``wrap(<the original>)``."""
    orig, own = getattr(owner, name), name in vars(owner)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


@contextlib.contextmanager
def counting_drops(model):
    """Within the block, every MoE block of ``model`` also counts the
    assignments that its capacity drops, with the plain routing helper
    (``layers/moe.routing``: the router runs once more a block, inside
    the walls measured meanwhile); a prefill launch counts only each
    row's first n_valid tokens.  A model without MoE blocks counts
    nothing."""
    from repro_torch.layers import moe
    log = DropLog("moe" in model.cfg.blocks())
    if not log.active:
        yield log
        return

    def counting(apply):
        def run(params, x, cfg, **kw):
            r = moe.routing(params, x, cfg,
                            capacity_factor=kw.get("capacity_factor"))
            log.add(*moe.assignments_dropped(r, log.n_valid))
            return apply(params, x, cfg, **kw)
        return run

    def prefill(chunk):
        def run(params, tokens, cache, table, pos_start, n_valid, **kw):
            log.start_launch(n_valid)
            try:
                return chunk(params, tokens, cache, table, pos_start,
                             n_valid, **kw)
            finally:
                log.n_valid = None
        return run
    with _wrapped(moe, "apply_moe", counting), \
            _wrapped(model, "prefill_chunk_paged", prefill):
        yield log


def drop_gate(what, drops: DropLog) -> None:
    """No valid token's assignment dropped by capacity in any launch."""
    dropped = [d for d, _ in drops.launches] + [drops.other[0]]
    total = sum(t for _, t in drops.launches) + drops.other[1]
    log(f"{what}: {sum(dropped)} of {total} (token, expert) assignments "
        "dropped by capacity")
    if any(dropped):
        raise AssertionError(f"{what}: {sum(dropped)} assignments dropped "
                             "by capacity; the runs compared would route "
                             "differently")


def one_ulp_up(x, flip):
    """``x`` with the magnitude of the elements under ``flip`` raised by
    one ulp of x's dtype (the next representable value away from 0)."""
    import torch
    ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return torch.where(flip, (x.view(ints) + 1).view(x.dtype), x)


def _ulp_noise(seed: int, frac: float):
    """A function moving a seeded ``frac`` of a tensor's elements by one
    ulp (``one_ulp_up``), from a generator per device."""
    import torch
    gens = {}

    def noisy(x):
        gen = gens.get(x.device)
        if gen is None:
            gen = gens[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        return one_ulp_up(x, torch.rand(x.shape, generator=gen,
                                        device=x.device) < frac)
    return noisy


def perturbed_router(model, seed: int = 9, frac: float = ROUTER_FLIP):
    """Within the block, the first MoE block of every forward of
    ``model`` sees its input -- the router's -- with a seeded ``frac`` of
    the elements moved by one ulp: what rounding alone does to a routing
    decision upstream of every other block."""
    from repro_torch.layers import moe
    n_moe = sum(k == "moe" for k in model.cfg.blocks())
    calls, noisy = [0], _ulp_noise(seed, frac)

    def wrap(apply):
        def run(params, x, cfg, **kw):
            if calls[0] % n_moe == 0:
                x = noisy(x)
            calls[0] += 1
            return apply(params, x, cfg, **kw)
        return run
    return _wrapped(moe, "apply_moe", wrap)


def gate_g(base: float) -> float:
    """Gate G: the logits of the kernel and plain paths of a MoE model
    within LOGIT_TOL of their scale, or twice ``base`` -- the largest
    relative change of the plain path's logits under perturbed_router --
    whichever is larger.  Each attention kernel rounds at other points
    than its plain version, so a few tokens route to another expert set,
    each swapping a whole expert's contribution; with random weights that
    can move the logits by more than LOGIT_TOL (the kernels themselves are
    held one by one in phase 2, the blocks in (e))."""
    return max(LOGIT_TOL, 2 * base)


def _rel_change(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def router_sensitivity(model, params, prompt) -> dict:
    """The plain path's relative logits change under perturbed_router on
    phase 8's own inputs: the first chunk's last row and one decode step
    (``first_chunk_and_step``), and LM.apply on 1 x APPLY_TOKENS."""
    import torch
    base = first_chunk_and_step(model, params, prompt, "paged_reference")
    with perturbed_router(model):
        moved = first_chunk_and_step(model, params, prompt,
                                     "paged_reference")
    toks = apply_tokens(model)
    with torch.no_grad():
        ref = model.apply(params, toks, impl="reference")
        with perturbed_router(model):
            out = _rel_change(model.apply(params, toks, impl="reference"),
                              ref)
    return {"prefill": _rel_change(moved[0], base[0]),
            "decode": _rel_change(moved[1], base[1]), "apply": out}


def capturing_block_inputs(model, inputs: list):
    """Within the block, the first num_layers blocks that ``model``'s
    full forward runs append their inputs to ``inputs``."""
    from repro_torch.models import blocks

    def wrap(apply):
        def run(params, x, *a, **kw):
            if len(inputs) < model.cfg.num_layers:
                inputs.append(x)
            return apply(params, x, *a, **kw)
        return run
    return _wrapped(blocks, "apply_block", wrap)


def recording_routes(routes: list):
    """Within the block, every MoE block appends its routing
    (``layers/moe.routing``) to ``routes``."""
    from repro_torch.layers import moe

    def wrap(apply):
        def run(params, x, cfg, **kw):
            routes.append(moe.routing(
                params, x, cfg, capacity_factor=kw.get("capacity_factor")))
            return apply(params, x, cfg, **kw)
        return run
    return _wrapped(moe, "apply_moe", wrap)


def kept_experts(r, num_experts: int):
    """(B, S, E) bool: the experts each token's kept assignments reach."""
    import torch
    b, s, k = r.idx.shape
    keep = torch.empty_like(r.plan.keep).scatter_(1, r.plan.order,
                                                  r.plan.keep)
    return torch.zeros((b, s, num_experts), dtype=torch.bool,
                       device=r.idx.device).scatter_(
        2, r.idx, keep.reshape(b, s, k))


def perturbed_attention(seed: int, frac: float = 0.5):
    """Within the block, every block's attention output has a seeded
    ``frac`` of its elements moved by one ulp: what rounding the
    attention output elsewhere alone does downstream."""
    from repro_torch.models import blocks
    noisy = _ulp_noise(seed, frac)
    return _wrapped(blocks.attn_mod, "apply_attention",
                    lambda apply: lambda *a, **kw: noisy(apply(*a, **kw)))


def _routed_alike(ra, rb, num_experts: int):
    """(B, S) bool: tokens with the same top-k set and kept experts."""
    import torch
    same_top = (torch.sort(ra.idx, dim=-1).values
                == torch.sort(rb.idx, dim=-1).values).all(-1)
    same_kept = (kept_experts(ra, num_experts)
                 == kept_experts(rb, num_experts)).all(-1)
    return same_top, same_top & same_kept


def _row_errors(got, ref):
    """Each row's max abs error, and that over the row's largest |ref|."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return diff, diff / ref.float().abs().amax(-1).clamp_min(1e-30)


def moe_block_check(model, params, inputs: list) -> dict:
    """(e): each block on the kernel path's own input (``inputs[i]``, from
    (c)'s LM.apply) through the kernels and through the plain attention
    path, and the plain path once more with one ulp on half its attention
    output's elements (``perturbed_attention``).  The rows that route
    alike (the same top-k set and kept experts) in the kernel and plain
    runs are held to the plain run, each row's max error within twice
    what the perturbation alone does to rows routed alike (its largest
    absolute and row-relative error), or within the unbounded bf16 gate
    (``held_to_plain``'s TOL and REL_TOL), whichever is larger: the
    rounding of the attention output is amplified downstream by the
    norm and the gated expert products.  The share of tokens whose top-k
    set differs, and whose kept experts differ, is recorded per layer."""
    import torch
    from repro_torch.models import blocks
    cfg = model.cfg
    dt = cfg.dtype
    res = {"top_set_differs": [], "kept_differs": [], "max_rel_err": [],
           "base_rel_err": []}
    with torch.no_grad():
        for i, (kind, bp) in enumerate(zip(cfg.blocks(), params["layers"])):
            x = inputs[i]
            pos = torch.arange(x.shape[1], device=x.device).expand(
                x.shape[0], -1)
            routes = []
            with recording_routes(routes):
                got = blocks.apply_block(bp, x, cfg, kind, positions=pos)
                ref = blocks.apply_block(bp, x, cfg, kind, positions=pos,
                                         impl="reference")
                with perturbed_attention(seed=100 + i):
                    moved = blocks.apply_block(bp, x, cfg, kind,
                                               positions=pos,
                                               impl="reference")
            rk, rp, rm = routes
            same_top, alike = _routed_alike(rk, rp, cfg.num_experts)
            base_alike = _routed_alike(rm, rp, cfg.num_experts)[1]
            if not torch.isfinite(got).all():
                raise AssertionError(f"(e) block {i}: non-finite output")
            err, rel = _row_errors(got[alike], ref[alike])
            b_err, b_rel = _row_errors(moved[base_alike], ref[base_alike])
            scale = ref.float().abs().max().item()
            tol = max(TOL[dt] * max(1.0, scale / 2),
                      2 * b_err.max().item())
            rtol = max(REL_TOL[dt], 2 * b_rel.max().item())
            worst, worst_rel = err.max().item(), rel.max().item()
            log(f"[moe] (e) block {i}: {int(alike.sum())} of "
                f"{alike.numel()} rows routed alike, max_abs_err "
                f"{worst:.3e} (tol {tol:.3e}), max error / row scale "
                f"{worst_rel:.3e} (tol {rtol:.3e}; one ulp on half the "
                f"attention output: {b_rel.max().item():.3e})")
            if not (worst <= tol and worst_rel <= rtol):
                raise AssertionError(
                    f"(e) block {i}: rows routed alike differ by "
                    f"{worst} (tol {tol}), relative {worst_rel} (tol "
                    f"{rtol})")
            res["top_set_differs"].append(
                1 - same_top.float().mean().item())
            res["kept_differs"].append(1 - alike.float().mean().item())
            res["max_rel_err"].append(worst_rel)
            res["base_rel_err"].append(b_rel.max().item())
    log(f"[moe] (e) tokens whose top-{cfg.num_experts_per_tok} set differs "
        f"between the kernel and plain runs, per layer: "
        f"{[round(v, 5) for v in res['top_set_differs']]}; whose top-k "
        f"set or kept experts differ: "
        f"{[round(v, 5) for v in res['kept_differs']]}")
    return res


PREFILL_ROWS, PREFILL_CHUNK = 8, 512     # (d), (f): one full prefill launch


def prefill_launch(model, params, prompts):
    """The first chunks of the first PREFILL_ROWS prompts as one prefill
    launch of PREFILL_ROWS x PREFILL_CHUNK on fresh pools: (a function
    running the launch and returning its logits, n_valid)."""
    import numpy as np
    import torch
    b, chunk, ps = PREFILL_ROWS, PREFILL_CHUNK, 128
    n_valid = np.array([min(len(p), chunk) for p in prompts[:b]], np.int32)
    toks = np.zeros((b, chunk), np.int32)
    for i, p in enumerate(prompts[:b]):
        toks[i, :n_valid[i]] = p[:n_valid[i]]
    pages = chunk // ps
    table = (1 + np.arange(b * pages, dtype=np.int32)).reshape(b, pages)
    pools = model.init_paged_cache(b * pages + 1, ps)
    args = [torch.from_numpy(a).to(model.device) for a in (
        toks, table, np.zeros(b, np.int32), n_valid)]

    def run():
        with torch.no_grad():
            return model.prefill_chunk_paged(params, args[0], pools,
                                             *args[1:])[0]
    return run, n_valid


def deterministic_prefill(model, params, prompts) -> int:
    """(d): ``prefill_launch`` run twice on the same pools: every valid
    row's logits the same bits.  Returns the rows compared."""
    import torch
    run, n_valid = prefill_launch(model, params, prompts)
    first, second = run(), run()
    for i, n in enumerate(n_valid):
        if not torch.equal(first[i, :n], second[i, :n]):
            raise AssertionError(f"(d) prefill row {i}: the second launch's "
                                 "logits differ from the first's")
    log(f"[moe] (d) one prefill launch of {PREFILL_ROWS} x {PREFILL_CHUNK} "
        f"run twice on the same pools: logits of all {int(n_valid.sum())} "
        "valid rows bit-identical")
    return int(n_valid.sum())


def moe_step_profile(model, params, prompts) -> dict:
    """(f): a B=8 decode step (``LM.decode_step`` at position 0 of a dense
    cache) and ``prefill_launch``: wall (median of 5, synchronised),
    device time of one profiled run, its idle share and its largest
    kernels, beside the step's byte bound (every weight read once, of
    the embedding table only the tokens' rows) and the launch's operation
    bound (the expert products over every (expert, slot) as the function
    computes them, the projections and LM head over every chunk row, and
    causal attention over the valid rows)."""
    import numpy as np
    import torch
    cfg = model.cfg
    b, d, e = PREFILL_ROWS, cfg.d_model, cfg.num_experts
    cache = model.init_cache(b, 8)
    tok = torch.from_numpy(np.array([p[0] for p in prompts[:b]],
                                    np.int32)).to(model.device)
    prefill, n_valid = prefill_launch(model, params, prompts)
    emb = params["embedding"]["embed"].numel()
    n_params = sum(t.numel() for t in _leaves(params))
    step_bytes = (n_params - emb + b * d) * 2
    tokens = b * PREFILL_CHUNK
    cap = max(1, int(PREFILL_CHUNK * cfg.num_experts_per_tok / e
                     * cfg.moe_capacity_factor))
    per_layer = (2 * 3 * d * cfg.expert_dff * e * cap * b
                 + 2 * tokens * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
                                 + d * e)
                 + 4 * cfg.num_heads * cfg.head_dim
                 * int((n_valid * (n_valid + 1) // 2).sum()))
    ops = cfg.num_layers * per_layer + 2 * tokens * d * cfg.vocab_size
    runs = (("decode step B=8", lambda: model.decode_step(
        params, tok, cache, 0), step_bytes / H100_BYTES_PER_S * 1e3,
        "bytes"), (f"prefill launch {b} x {PREFILL_CHUNK}", prefill,
                   ops / PEAK_FLOPS["bfloat16"] * 1e3, "operations"))
    out = {}
    with torch.no_grad():
        for name, fn, bnd, by in runs:
            wall, _ = _wall_ms(fn, reps=5)
            kernels, dev_s = _profile_kernels(fn)
            top = sorted(kernels, key=_device_us, reverse=True)[:4]
            res = {"wall_ms": wall, "device_ms": dev_s * 1e3,
                   "idle_share": 1 - dev_s * 1e3 / wall, "bound_ms": bnd,
                   "bound_by": by, "kernel_launches": sum(
                       k.count for k in kernels),
                   "top": [(k.key[:48], _device_us(k) / 1e3, k.count)
                           for k in top]}
            log(f"[moe] (f) {name}: {wall:.2f} ms wall, {dev_s * 1e3:.2f} "
                f"ms of kernels in one profiled run ({res['kernel_launches']}"
                f" launches, idle share {res['idle_share']:.3f}), bound "
                f"{bnd:.2f} ms ({by}); largest kernels (name, device ms, "
                f"launches): {res['top']}")
            out[name] = res
    return out


def phase_moe() -> dict:
    """Phase 8: qwen3-moe-30b-a3b (128 experts top-8, 32/4 heads of 128:
    every row of the kernels' GQA-8 instances) at full width, its first
    MOE_LAYERS of 48 MoE blocks, bf16, random weights from a seeded CUDA generator,
    after every earlier model is freed.  Gate G (``gate_g``) on the plain
    path's own sensitivity (``router_sensitivity``) bounds every logits
    comparison.  (a) phase 3's serving: each paged kernel exactly one
    launch a layer a prefill launch or decode step, no page left, the
    share of assignments dropped by capacity in each prefill launch; (b)
    phase 3b's dense generation: flash_decode exactly layers x 159
    launches, greedy tokens equal those of the paged engine -- on the
    same weights at capacity factor NO_DROP_CF -- under the margin rule,
    no assignment dropped in either; (c) LM.apply on 1 x 2048, exactly one
    fastattn_fwd launch a layer; (d) one prefill launch twice, the same
    bits; (e) each block on (c)'s inputs against its plain run; (f) a
    decode step and a prefill launch profiled.  Peak memory below 80
    GB."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    model, params = build_full(MOE_ARCH, MOE_LAYERS)
    cfg = model.cfg
    layers = cfg.num_layers
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[moe] {cfg.name}: {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok} (expert_dff {cfg.expert_dff}, "
        f"capacity factor {cfg.moe_capacity_factor}), "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}; "
        f"{left:.2f} GB allocated before the build (earlier phases), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after, init peak "
        f"{init_peak:.2f} GB")
    prompts, _ = serve_traffic(cfg.vocab_size)
    sens = router_sensitivity(model, params, prompts[0])
    g = gate_g(max(sens.values()))
    log(f"[moe] gate G = {g:.4g} = max(LOGIT_TOL {LOGIT_TOL}, 2 x the plain "
        f"path's change with one ulp on {ROUTER_FLIP:.0%} of the first "
        f"block's router inputs: {json.dumps(sens)})")

    served = phase_serving(model, params, rel_tol=g)
    serve_gate(f"[moe] {cfg.name}", served, layers)
    from repro_torch.models import build_model
    paged_model = build_model(dataclasses.replace(
        cfg, moe_capacity_factor=NO_DROP_CF), device=model.device)
    dense = phase_dense(model, params, rel_tol=g, paged_model=paged_model)
    inputs = []
    with capturing_block_inputs(model, inputs):
        launches = apply_check(model, params, f"[moe] {cfg.name}",
                               rel_tol=g)
    blocks = moe_block_check(model, params, inputs)
    del inputs
    rows = deterministic_prefill(model, params, prompts)
    profile = moe_step_profile(model, params, prompts)
    peak = max(init_peak, torch.cuda.max_memory_allocated() / 1e9)
    if not peak < 80:
        raise AssertionError(f"{cfg.name}: peak memory {peak:.2f} GB")
    out = {"arch": cfg.name, "gate_g": g, "sensitivity": sens,
           "launches": {**served["launches"],
                        "flash_decode": dense["launches"],
                        "fastattn_fwd": launches},
           "flash_decode": dense["kernel"],
           "moe_drops": served["moe_drops"],
           "moe_drops_by_layer": served["moe_drops_by_layer"],
           "serve": {k: served[k] for k in (
               "wall_s", "prefill_tok_s", "decode_tok_s", "steps",
               "prefill_launches", "decode_launches", "prefill_device_s",
               "decode_device_s", "peak_mem_gb")},
           "generate_tok_s": dense["tokens_per_s_generate"],
           "tokens_equal": dense["tokens_equal"],
           "tokens_clear": dense["tokens_clear"], "blocks": blocks,
           "deterministic_rows": rows, "profile": profile,
           "peak_mem_gb": peak, "allocated_before_gb": left,
           "seconds": time.perf_counter() - t0}
    log(f"[moe] {_card()}: phase 8 passed in {out['seconds']:.1f}s")
    log(f"[moe] {json.dumps(out)}")
    del model, params, dense, served
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8 (g)-(i): qwen3-moe-30b-a3b trained, expert-parallel, served at tp=2
# ---------------------------------------------------------------------------

# (g), (h): the first 2 of 48 layers at full width (1.87 B parameters with
# the untied embed and head: bf16 weights and gradients and f32 AdamW
# moments take about 23 GB); (i): the first 4 (3.1 B parameters)
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2048
MOE_DIST_STEPS = 2            # (h): (g)'s first 2 steps and batches
MOE_TP_LAYERS = 4
# (h): a MoE block's leaves' updates against (g)'s.  At 72-84% of the
# assignments dropped, a rounding that moves one token's top-8 set moves
# which later tokens keep their slots, so layer 1's router and experts
# differ from one device's far more than phase 4b's leaves do (sound runs
# on the card: 0.138, 0.195, 0.243 and 0.170 at seeds 0 to 3, 0.100 at
# seed 0 with the combine in f32; a block that dispatches each rank's
# rows on their own, the capacity error it must not make: 0.60, while
# its loss and grad norm pass their bounds).  Every other leaf keeps
# DIST_DELTA_RTOL (at most 0.066 in those runs).
MOE_DELTA_RTOL = 0.3


def moe_train(cfg, device: str = "cuda") -> dict:
    """(g): MOE_TRAIN_STEPS AdamW steps of ``cfg`` cut to its first
    MOE_TRAIN_LAYERS layers on MOE_TRAIN_BATCH x MOE_TRAIN_SEQ batches of
    the data pipeline through the trainer's functions (remat "full",
    capacity factor cfg's: the random router drops), fastattn_fwd's
    launches counted and each step's share of (token, expert) assignments
    dropped by capacity.  Before them, step 0's batch through the plain
    attention path: the first step's loss and grad norm within LOSS_RTOL
    and GNORM_RTOL of its.  Returns the numbers and, under "reference",
    (h)'s: the initial parameters and those after MOE_DIST_STEPS steps
    (host copies in tree order) and every step's loss, grad norm and
    lr."""
    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.training import tree
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    parallel = ParallelConfig(remat="full")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=MOE_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device, parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    n_params = sum(t.numel() for t in tree.leaves(state.params))
    # host copies (a copy on the CPU too: the steps update in place)
    ref = {"init": [t.to("cpu", copy=True)
                    for t in tree.leaves(state.params)],
           "paths": [p for p, _ in tree.leaves_with_paths(state.params)],
           "loss": [], "grad_norm": [], "lr": []}
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=MOE_TRAIN_SEQ,
                                    global_batch=MOE_TRAIN_BATCH))
    batches = [to_device(data.next(), model.device)
               for _ in range(MOE_TRAIN_STEPS)]
    p_loss, p_gn = _loss_and_gnorm(model, state.params, batches[0],
                                   "reference")
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    fastattn_fwd.launches = 0
    step_s, drop_share = [], []
    with counting_drops(model) as drops:
        for i, batch in enumerate(batches):
            drops.other = [0, 0]
            dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
            step_s.append(dt)
            for k in ("loss", "grad_norm", "lr"):
                ref[k].append(float(metrics[k]))
            drop_share.append(drops.other[0] / drops.other[1])
            if i + 1 == MOE_DIST_STEPS:
                ref["snapshot"] = [t.to("cpu", copy=True) for t in
                                   tree.leaves(state.params)]
            log(f"[moe] (g) step {i} loss {ref['loss'][-1]:.4f} gnorm "
                f"{ref['grad_norm'][-1]:.4f} {dt * 1e3:.1f} ms, "
                f"{drop_share[-1]:.3f} of the assignments dropped by "
                "capacity")
    launches = fastattn_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, gnorms = ref["loss"], ref["grad_norm"]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"(g) non-finite loss or grad norm: {losses}, "
                             f"{gnorms}")
    loss_rel = abs(losses[0] - p_loss) / abs(p_loss)
    gn_rel = abs(gnorms[0] - p_gn) / abs(p_gn)
    log(f"[moe] (g) {cfg.num_layers} layers, {n_params:,} parameters; "
        f"step 0 vs the plain path on its batch: loss {losses[0]:.5f} vs "
        f"{p_loss:.5f} (rel {loss_rel:.2e}, tol {LOSS_RTOL}), grad norm "
        f"{gnorms[0]:.5f} vs {p_gn:.5f} (rel {gn_rel:.2e}, tol "
        f"{GNORM_RTOL}); fastattn_fwd {launches} launches; peak memory "
        f"{peak:.2f} GB")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("(g) kernel and plain training paths disagree")
    if not peak < 80:
        raise AssertionError(f"(g) peak memory {peak:.2f} GB")
    return {"layers": cfg.num_layers, "params": n_params,
            "losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "drop_share": drop_share, "plain_loss_gnorm": [p_loss, p_gn],
            "loss_rel": loss_rel, "gnorm_rel": gn_rel,
            "launches": launches, "peak_mem_gb": peak,
            "tok_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
            / statistics.median(step_s[1:]), "reference": ref}


def moe_dist(trained: dict, cfg, decode: dict = None) -> dict:
    """(h): (g)'s training (``cfg`` cut to MOE_TRAIN_LAYERS) at
    DIST_MESH on phase 4b's harness (``phase_dist_training``) for (g)'s
    first MOE_DIST_STEPS steps, without the checkpoint: each rank's
    expert leaves its E / model experts; then ``decode``, phase 15's
    job, on the same ranks.  Correctness only: gloo stages every
    collective through the host."""
    return phase_dist_training(
        trained, dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS),
        run=dict(remat="full", batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
                 steps=MOE_TRAIN_STEPS, layers=MOE_TRAIN_LAYERS,
                 dist_steps=MOE_DIST_STEPS, checkpoint=False,
                 leaf_gnorm=False),
        tag="[moe] (h)", experts=cfg.num_experts // DIST_MESH["model"],
        decode=decode)


def whole_experts_gate(what, ranks: list, experts: int, layers: int) -> None:
    """(i): every rank's core holds all ``experts`` experts of each of its
    ``layers`` MoE layers (tensor parallelism leaves the experts
    whole)."""
    for r, res in enumerate(ranks):
        if res["experts"] != [experts] * layers:
            raise AssertionError(f"{what}: rank {r} holds {res['experts']} "
                                 f"experts a layer, not {experts} in each "
                                 f"of {layers}")


def moe_tp(cfg) -> dict:
    """(i): ``cfg`` cut to its first MOE_TP_LAYERS layers (bf16, random
    weights from a CUDA generator seeded with 0) serving phase 3's 12
    requests at tp=2 (g=2, s=1) under the tiled all-reduce, two ranks of
    phase 3e's harness, against a tp=1 run of the same model on the card
    that records its margins: ``tp_gate`` (streams, launches, pages,
    plan), and every rank holding every expert of every layer whole."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=MOE_TP_LAYERS)
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    n_params = sum(t.numel() for t in _leaves(params))
    prompts, _ = serve_traffic(cfg.vocab_size)
    waves = [[(i, p, SERVE_3_NEW) for i, p in enumerate(prompts)]]
    core = _make_feature_core()(model, params, cfg, ServeConfig(**SERVE_3),
                                device="cuda", record=True)
    tp1 = _tp_drive(core, waves, {})
    del core
    gc.collect()
    torch.cuda.empty_cache()
    backend, dev_of = tp_backend()
    log(f"[moe] (i) {cfg.name} cut to {cfg.num_layers} layers "
        f"({n_params:,} parameters): tp=1 reference {tp1['wall_s']:.2f}s "
        f"wall, {tp1['steps']} steps; 2 ranks over {backend} on "
        f"{[dev_of(r) for r in range(2)]}")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_tp_rank, 2, args=(cfg, params, [
            ("tiled", dict(SERVE_3, tp=2, tp_collectives="tiled"), waves)]),
            device_of_rank=dev_of, backend=backend,
            init_method=f"file://{tmp}/pg-moe-tp", timeout_s=TP_DEADLINE_S,
            init_timeout_s=TP_INIT_TIMEOUT_S)
    torch.cuda.ipc_collect()
    rr = [r["tiled"] for r in ranks]
    what = f"[moe] (i) {cfg.name} tp=2 tiled"
    eq, tot = tp_gate(what, rr, tp1["tokens"], tp1["margins"],
                      {"tp": 2, "g": 2, "s": 1, "collectives": "tiled"},
                      cfg.num_layers, ("paged_prefill", "paged_decode"))
    whole_experts_gate(what, rr, cfg.num_experts, cfg.num_layers)
    out = {**_tp_report(what, rr, backend), "tokens_equal": eq,
           "tokens_compared": tot, "params": n_params,
           "experts": [res["experts"] for res in rr],
           "seconds": time.perf_counter() - t0}
    log(f"{what}: {eq} of {tot} greedy tokens equal tp=1's "
        f"before any fork at a near-tie; every rank holds all "
        f"{cfg.num_experts} experts of its {cfg.num_layers} layers")
    del model, params
    return out


def phase_moe_parallel(done=lambda phase: None) -> dict:
    """Phase 8 (g)-(i), after phase 8's 48-layer model is freed:
    qwen3-moe-30b-a3b at full width trained on one device (g), at
    (data=2, model=2) with its experts sharded over the model axis (h),
    and served at tp=2 (i); (h)'s ranks then decode phase 15's qwen3-moe
    job (its (job, ranks) returned as "decode").  ``done`` is called
    after each part."""
    import torch
    from repro_torch.config import get_model_config
    cfg = get_model_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"train": moe_train(cfg)}
    exact_launches("[moe] (g)", {"fastattn_fwd": out["train"]["launches"]},
                   {"fastattn_fwd": MOE_TRAIN_LAYERS * 2 * MOE_TRAIN_STEPS})
    done("8g")
    trained = out["train"]
    gc.collect()                  # (g)'s model and optimizer state
    torch.cuda.empty_cache()
    job = decode_job_for(MOE_ARCH, dataclasses.replace(
        cfg, num_layers=MOE_TRAIN_LAYERS))
    out["dist"] = moe_dist(trained, cfg, decode=job)
    decode = (job, out["dist"].pop("decode_ranks"))
    del trained["reference"]
    done("8h")
    gc.collect()
    torch.cuda.empty_cache()
    out["tp"] = moe_tp(cfg)
    done("8i")
    gc.collect()
    torch.cuda.empty_cache()
    out["card"] = _card()
    log(f"[moe] {out['card']}: phase 8 (g)-(i) passed")
    log(f"[moe] (g)-(i) {json.dumps(out)}")
    out["decode"] = decode        # phase 15's qwen3-moe ranks
    return out


# ---------------------------------------------------------------------------
# phase 9: the Mamba layer -- hymba-1.5b at full width and depth
# ---------------------------------------------------------------------------

HYMBA_BATCH, HYMBA_SEQ = 8, 2048          # (a): LM.apply
HYMBA_LONG_PROMPT, HYMBA_LONG_NEW = 1100, 8   # (c): decode past the window
HYMBA_LONG_FROM = 1024                    # (c): positions held from here on
# (c) runs the first 4 layers of the pattern (layer 0 global, 1-3 with
# the window): decoding past the window is a per-layer mechanism, and 32
# host-bound layers x 1107 steps took ~80 s of the script's time limit
HYMBA_LONG_LAYERS = 4
HYMBA_TRAIN_BATCH, HYMBA_TRAIN_STEPS = 2, 3   # (d)
HYMBA_PROFILE_ROWS = 2        # (e): LM.apply profiled on (a)'s first rows
BLOCK_FLIP = 0.01             # the share of block 0's inputs moved one ulp


def hymba_gate(change: float) -> tuple:
    """Phase 9's logits gate from ``change``, the plain path's own largest
    relative logits change under ``perturbed_first_block``: LOGIT_TOL
    where the model is well conditioned (a change of at most half of
    it), else gate G's rule, max(LOGIT_TOL, 2 x change).  Returns (gate,
    the rule's name)."""
    if change <= LOGIT_TOL / 2:
        return LOGIT_TOL, "LOGIT_TOL"
    return gate_g(change), "G"


def perturbed_first_block(model, seed: int = 9, frac: float = BLOCK_FLIP):
    """Within the block, the first block of every full forward of
    ``model`` sees its input with a seeded ``frac`` of the elements moved
    by one ulp: what rounding alone does upstream of every other
    block."""
    from repro_torch.models import blocks
    n, calls, noisy = model.cfg.num_layers, [0], _ulp_noise(seed, frac)

    def wrap(apply):
        def run(params, x, *a, **kw):
            if calls[0] % n == 0:
                x = noisy(x)
            calls[0] += 1
            return apply(params, x, *a, **kw)
        return run
    return _wrapped(blocks, "apply_block", wrap)


def hymba_sensitivity(model, params, toks) -> tuple:
    """The plain path's logits on ``toks`` and their largest relative
    change under ``perturbed_first_block``: (logits, change)."""
    import torch
    with torch.no_grad():
        ref = model.apply(params, toks, impl="reference")
        with perturbed_first_block(model):
            change = _rel_change(model.apply(params, toks,
                                             impl="reference").float(),
                                 ref.float())
    return ref, change


def exact_launches(what, got: dict, want: dict) -> None:
    """Every kernel of ``want`` launched exactly that many times."""
    for name, n in want.items():
        if got.get(name) != n:
            raise AssertionError(f"{what}: {name} launched {got.get(name)} "
                                 f"times, expected {n}")


def hymba_block_check(model, params, toks) -> list:
    """The fallback when even gate G fails end to end: each block on the
    inputs the kernel path's LM.apply gave it, through the kernels and
    through the plain path, held under the unbounded bf16 rule.  Returns
    each block's (max abs error, largest error over its row's scale)."""
    import torch
    from repro_torch.models import blocks as B
    inputs = []
    with torch.no_grad(), capturing_block_inputs(model, inputs):
        model.apply(params, toks)
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device).expand(b, s)
    errs = []
    with torch.no_grad():
        for i, (kind, bp, x) in enumerate(zip(model.cfg.blocks(),
                                              params["layers"], inputs)):
            got, ref = (B.apply_block(bp, x, model.cfg, kind, positions=pos,
                                      impl=impl)
                        for impl in (None, "reference"))
            errs.append(held_to_plain("hymba", f"block {i} ({kind}) output, "
                                      "kernel vs plain", got.flatten(0, 1),
                                      ref.flatten(0, 1), "bfloat16",
                                      unbounded=True))
    return errs


def hymba_apply(model, params, toks, ref, gate: float, rule: str) -> dict:
    """(a): LM.apply on ``toks`` through the kernels (fastattn_fwd's
    launches counted), its logits held to the plain path's ``ref`` under
    ``gate``; where the rule is G and even that fails, each block is held
    to its plain version instead (``hymba_block_check``)."""
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    b, s = toks.shape
    with torch.no_grad():
        fastattn_fwd.launches = 0
        wall, logits = _wall_s(lambda: model.apply(params, toks))
        launches = fastattn_fwd.launches
    if logits.shape != (b, s, model.cfg.vocab_size):
        raise AssertionError(f"(a) logits {tuple(logits.shape)}")
    err = _logit_err(logits, ref)
    log(f"[hymba] (a) LM.apply {b} x {s}: {wall:.2f}s wall, fastattn_fwd "
        f"launches {launches}; kernel vs plain logits {err[0]:.4f}, "
        f"{err[1]:.4f} of their scale (median position {err[2]:.4f})")
    out = {"wall_s": wall, "launches": launches, "logit_err": err,
           "rule": rule, "logits": logits}
    try:
        _compare_logits("[hymba] (a) LM.apply logits, kernel vs plain",
                        logits.flatten(0, 1), ref.flatten(0, 1), gate)
    except AssertionError:
        if rule != "G":
            raise
        log(f"[hymba] (a) the logits miss gate G ({gate:.4g}): each block "
            "is held to its plain version on its own inputs")
        out["blocks"] = hymba_block_check(model, params, toks)
        out["rule"] = "blocks"
    return out


def _recording_engine(model, params, serve, keep, snap_at=None):
    """A ServeEngine on ``model`` whose decode steps record, at every
    position ``keep(pos)`` admits, the logits (float32), the last caches
    and a copy of the caches as the step at ``snap_at`` left them:
    (engine, {pos: logits}, {"last": cache, "snap": cache})."""
    import torch
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.tree import tree_map
    engine = ServeEngine(model=model, params=params, cfg=model.cfg,
                         serve=serve)
    seen, caches = {}, {}
    decode = engine._decode

    def recording(tok, cache, pos):
        logits, cache = decode(tok, cache, pos)
        if keep(pos):
            seen[pos] = logits.float()
        if pos == snap_at:        # later steps write K/V rows in place
            caches["snap"] = tree_map(torch.clone, cache)
        caches["last"] = cache
        return logits, cache
    engine._decode = recording
    return engine, seen, caches


def hymba_generate(model, plain_model, params, prompts, apply_logits,
                   gate: float) -> dict:
    """(b): ServeEngine.generate of ``prompts`` (B, DENSE_PROMPT), DENSE_NEW
    greedy tokens, through flash_decode (its launches counted); its
    decode logits at DENSE_CHECK_POS held to ``apply_logits`` -- (a)'s
    LM.apply on the same tokens -- under ``gate``.  Then the plain
    attention path (``plain_model``), with no kernel launched: its
    LM.apply on the generated sequence, against generate's logits at
    every generated position, and its ``decode_step`` teacher-forced on
    generate's tokens from the caches generate held after the prompt,
    against generate's logits at the positions after it -- each under
    ``gate``, the greedy tokens under the margin rule.  (The plain
    decode_step starts from the prompt's caches: its own 128 prompt steps
    would cost the script ~15 s of its time limit.)  Also returns the
    run's last caches for (e)."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.flash_decode.ops import flash_decode
    b, s = prompts.shape
    n_new = DENSE_NEW
    serve = ServeConfig(max_seq_len=s + n_new + 1, top_k=1)
    engine, seen, caches = _recording_engine(
        model, params, serve, lambda p: p in DENSE_CHECK_POS or p >= s - 1,
        snap_at=s - 1)
    torch.cuda.synchronize()
    flash_decode.launches = 0
    wall, out = _wall_s(lambda: engine.generate(prompts, n_new))
    launches = flash_decode.launches
    del engine
    log(f"[hymba] (b) generate B={b} x {s} + {n_new}: {wall:.2f}s wall "
        f"through flash_decode ({launches} launches)")
    if out.shape != (b, n_new) or not bool(((0 <= out) & (
            out < model.cfg.vocab_size)).all()):
        raise AssertionError(f"(b) bad generated tokens {tuple(out.shape)}")
    for pos in DENSE_CHECK_POS:
        _compare_logits(f"[hymba] (b) decode_step logits at position {pos} "
                        "vs (a)'s LM.apply", seen[pos], apply_logits[:, pos],
                        gate)
    seq = torch.cat([torch.as_tensor(prompts, device=out.device).long(),
                     out[:, :-1].long()], dim=1).to(torch.int32)
    fastattn_fwd.launches = flash_decode.launches = 0
    with torch.no_grad():
        plain = plain_model.apply(params, seq)[:, s - 1:].float()
        cache, stepped = caches.pop("snap"), []
        for j in range(n_new - 1):
            logits, cache = plain_model.decode_step(params, out[:, j],
                                                    cache, s + j)
            stepped.append(logits.float())
    del cache
    plain_launches = {"fastattn_fwd": fastattn_fwd.launches,
                      "flash_decode": flash_decode.launches}
    exact_launches("[hymba] (b) the plain runs", plain_launches,
                   {"fastattn_fwd": 0, "flash_decode": 0})
    got = torch.stack([seen[p] for p in range(s - 1, s + n_new - 1)], dim=1)
    _compare_logits("[hymba] (b) generate's logits at the generated "
                    "positions vs the plain LM.apply on its tokens",
                    got.flatten(0, 1), plain.flatten(0, 1), gate)
    _compare_logits(f"[hymba] (b) generate's logits at positions {s}-"
                    f"{s + n_new - 2} vs the plain decode_step teacher-forced "
                    "on its tokens from the prompt's caches",
                    got[:, 1:].flatten(0, 1),
                    torch.stack(stepped, dim=1).flatten(0, 1), gate)
    return {"wall_s": wall, "launches": launches,
            "plain_launches": plain_launches,
            "new_tok_s": b * n_new / wall, "cache": caches["last"]}


def hymba_long(model, params, prompt, gate: float) -> dict:
    """(c): one sequence of len(prompt) tokens and HYMBA_LONG_NEW new ones
    through ServeEngine.generate on the first HYMBA_LONG_LAYERS layers of
    ``model`` (its weights, its final norm and head), decode passing the
    window (flash_decode's launches counted); the decode logits from
    HYMBA_LONG_FROM on held to LM.apply's on the whole sequence under
    ``gate``."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.models import build_model
    n = min(HYMBA_LONG_LAYERS, model.cfg.num_layers)
    model = build_model(dataclasses.replace(model.cfg, num_layers=n),
                        device=model.device)
    params = {**params, "layers": params["layers"][:n]}
    p, n_new = len(prompt), HYMBA_LONG_NEW
    serve = ServeConfig(max_seq_len=p + n_new + 1, top_k=1)
    engine, seen, _ = _recording_engine(model, params, serve,
                                        lambda q: q >= HYMBA_LONG_FROM)
    torch.cuda.synchronize()
    flash_decode.launches = 0
    wall, out = _wall_s(lambda: engine.generate(prompt[None], n_new))
    launches = flash_decode.launches
    del engine
    seq = torch.cat([torch.as_tensor(prompt, device=model.device)[None]
                     .long(), out.long()], dim=1).to(torch.int32)
    with torch.no_grad():
        full = model.apply(params, seq)[0].float()
    steps = p + n_new - 1
    got = torch.cat([seen[q] for q in range(HYMBA_LONG_FROM, steps)])
    _compare_logits(f"[hymba] (c) decode_step logits at positions "
                    f"{HYMBA_LONG_FROM}-{steps - 1} vs LM.apply on the "
                    f"{seq.shape[1]} tokens", got,
                    full[HYMBA_LONG_FROM:steps], gate)
    log(f"[hymba] (c) generate 1 x {p} + {n_new} on the first {n} "
        f"layers: {wall:.2f}s wall, flash_decode launches {launches} "
        f"({steps} decode steps)")
    return {"wall_s": wall, "launches": launches, "steps": steps,
            "layers": n, "ms_per_step": wall / steps * 1e3}


@contextlib.contextmanager
def counting_scans(calls: list):
    """Within the block, each call of ``layers/ssm.mamba_scan_chunk``
    appends an entry to ``calls``: the first its arguments, the others
    None (a long forward's chunk inputs would fill gigabytes)."""
    from repro_torch.layers import ssm

    def wrap(scan):
        def run(*a, **kw):
            calls.append(None if calls else (a, kw))
            return scan(*a, **kw)
        return run
    with _wrapped(ssm, "mamba_scan_chunk", wrap):
        yield


def scan_device_s(calls: list) -> float:
    """The device time of the Mamba scans ``calls`` recorded (one run's,
    by ``counting_scans``), seconds: their number times one call's
    device time (``device_ms``) on the first call's inputs -- every call
    of one of phase 9's runs has the same shapes."""
    from repro_torch.layers import ssm
    a, kw = calls[0]
    return len(calls) * device_ms(lambda: ssm.mamba_scan_chunk(*a, **kw)) \
        / 1e3


def hymba_profile(model, params, toks, cache, pos: int) -> dict:
    """(e): one B=8 decode step (``LM.decode_step`` at ``pos`` of (b)'s
    caches) and LM.apply on the first HYMBA_PROFILE_ROWS rows of
    ``toks``: wall (median of 5 and of 2), the kernels' device time in
    one profiled run, the idle share, and the Mamba scan's share of that
    device time (``scan_device_s`` on the profiled run's calls)."""
    import torch
    b = toks.shape[0]
    tok = toks[:, 0].contiguous()
    rows = toks[:HYMBA_PROFILE_ROWS]

    def step():
        return model.decode_step(params, tok, cache, pos)

    def apply():
        return model.apply(params, rows)
    out = {}
    with torch.no_grad():
        for name, fn, reps in (
                (f"decode step B={b}", step, 5),
                ("LM.apply %d x %d" % tuple(rows.shape), apply, 2)):
            wall, _ = _wall_ms(fn, reps=reps)
            calls = []
            with counting_scans(calls):
                kernels, dev_s = _profile_kernels(fn)
            scan_s, n_scans = scan_device_s(calls), len(calls)
            del calls
            top = sorted(kernels, key=_device_us, reverse=True)[:4]
            res = {"wall_ms": wall, "device_ms": dev_s * 1e3,
                   "idle_share": 1 - dev_s * 1e3 / wall,
                   "kernel_launches": sum(k.count for k in kernels),
                   "scan_device_ms": scan_s * 1e3, "scan_calls": n_scans,
                   "scan_share": scan_s / dev_s,
                   "top": [(k.key[:48], _device_us(k) / 1e3, k.count)
                           for k in top]}
            log(f"[hymba] (e) {name}: {wall:.2f} ms wall, {dev_s * 1e3:.2f} "
                f"ms of kernels in one profiled run ({res['kernel_launches']}"
                f" launches, idle share {res['idle_share']:.3f}); the Mamba "
                f"scan {scan_s * 1e3:.2f} ms ({n_scans} calls), "
                f"{res['scan_share']:.1%} of the device time; largest "
                f"kernels (name, device ms, launches): {res['top']}")
            out[name] = res
    return out


def hymba_train(cfg) -> dict:
    """(d): HYMBA_TRAIN_STEPS AdamW steps at HYMBA_TRAIN_BATCH x HYMBA_SEQ
    through the trainer's functions (remat "selective", as
    launch/train.py; phase 4's TrainConfig), fastattn_fwd's launches
    counted; before them, step 0's batch through the plain attention
    path: the first step's loss and grad norm within LOSS_RTOL and
    GNORM_RTOL of its."""
    import math

    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    parallel = ParallelConfig(remat="selective")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=HYMBA_TRAIN_STEPS)
    model = build_model(cfg, "cuda", parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=HYMBA_SEQ,
                                    global_batch=HYMBA_TRAIN_BATCH))
    first = to_device(TokenPipeline(data.cfg).next(), model.device)
    p_loss, p_gn = _loss_and_gnorm(model, state.params, first, "reference")
    del first
    torch.cuda.reset_peak_memory_stats()
    fastattn_fwd.launches = 0
    losses, gnorms, step_s = [], [], []
    for i in range(HYMBA_TRAIN_STEPS):
        batch = to_device(data.next(), model.device)
        dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        log(f"[hymba] (d) step {i} loss {losses[-1]:.4f} gnorm "
            f"{gnorms[-1]:.4f} {dt * 1e3:.1f} ms")
    launches = fastattn_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"(d) non-finite loss or grad norm: {losses}, "
                             f"{gnorms}")
    loss_rel = abs(losses[0] - p_loss) / abs(p_loss)
    gn_rel = abs(gnorms[0] - p_gn) / abs(p_gn)
    log(f"[hymba] (d) step 0 vs the plain path on its batch: loss "
        f"{losses[0]:.5f} vs {p_loss:.5f} (rel {loss_rel:.2e}, tol "
        f"{LOSS_RTOL}), grad norm {gnorms[0]:.5f} vs {p_gn:.5f} (rel "
        f"{gn_rel:.2e}, tol {GNORM_RTOL}); peak memory {peak:.2f} GB")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("(d) kernel and plain training paths disagree")
    del state, step_fn
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "plain_loss_gnorm": [p_loss, p_gn], "loss_rel": loss_rel,
            "gnorm_rel": gn_rel, "launches": launches, "peak_mem_gb": peak,
            "tok_s": HYMBA_TRAIN_BATCH * HYMBA_SEQ / statistics.median(
                step_s[1:])}


def phase_hymba() -> dict:
    """Phase 9: hymba-1.5b (32 blocks of parallel attention and Mamba
    heads, 25/5 heads of 64, window 1024 on 29 layers) at full width, its
    first HYMBA_LAYERS blocks, bf16, random weights from a seeded CUDA generator, after every
    earlier model is freed.  The gate (``hymba_gate``) comes from the
    plain path's own change under one ulp on 1% of block 0's inputs.
    (a) LM.apply on 8 x 2048 through fastattn_fwd, one launch a layer,
    logits held to the plain path; (b) generate 8 x (128 + 32) through
    flash_decode, exactly layers x 159 launches, decode logits at
    DENSE_CHECK_POS held to (a)'s LM.apply, the generated positions'
    logits and greedy tokens to the plain path's LM.apply and
    decode_step teacher-forced; (c) 1 x (1100 + 8) on the first 4 layers
    (global, then 3 windowed), decode past the window, exactly 4 x 1107
    launches, logits from position 1024 held to LM.apply's; (e) a
    decode step and LM.apply profiled, the Mamba scan's share; (d) 3 AdamW steps at 2 x 2048 (remat), finite, step 0 held to
    the plain path, exactly layers x 2 x 3 launches."""
    import numpy as np
    import torch
    from repro_torch.analysis.flops import param_count
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    model, params = build_full(HYMBA_ARCH, HYMBA_LAYERS)
    cfg = model.cfg
    layers = cfg.num_layers
    n_real = sum(t.numel() for t in _leaves(params))
    log(f"[hymba] {cfg.name}: {layers} layers ({cfg.blocks().count('hymba')} "
        f"global), {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, window {cfg.window_size}, ssm state "
        f"{cfg.ssm_state_size}; parameters {n_real:,} in the tensors, "
        f"{param_count(cfg):,} by the reference's formula "
        f"(analysis/flops.param_count); {left:.2f} GB allocated before the "
        f"build, {torch.cuda.memory_allocated() / 1e9:.2f} GB after")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(HYMBA_BATCH, HYMBA_SEQ)).astype(np.int32)
    ).cuda()
    t_parts = {"build": time.perf_counter()}
    ref, change = hymba_sensitivity(model, params, toks)
    t_parts["gate"] = time.perf_counter()
    gate, rule = hymba_gate(change)
    log(f"[hymba] gate {gate:.4g} ({rule}): the plain path's logits move by "
        f"{change:.4g} of their scale with one ulp on {BLOCK_FLIP:.0%} of "
        f"block 0's inputs (LOGIT_TOL {LOGIT_TOL} where that is at most "
        "half of it, else max(LOGIT_TOL, twice it))")
    applied = hymba_apply(model, params, toks, ref, gate, rule)
    t_parts["a"] = time.perf_counter()
    del ref
    apply_logits = applied.pop("logits")[:, :DENSE_PROMPT].float()
    plain_model = build_model(dataclasses.replace(
        cfg, attention_impl="reference"), device=model.device)
    gen = hymba_generate(model, plain_model, params,
                         toks[:, :DENSE_PROMPT].cpu().numpy(), apply_logits,
                         gate)
    del apply_logits
    t_parts["b"] = time.perf_counter()
    long_prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=HYMBA_LONG_PROMPT).astype(np.int32)
    long_run = hymba_long(model, params, long_prompt, gate)
    t_parts["c"] = time.perf_counter()
    profile = hymba_profile(model, params, toks, gen.pop("cache"),
                            DENSE_PROMPT + DENSE_NEW - 1)
    t_parts["e"] = time.perf_counter()
    launches = {"fastattn_fwd": {"apply": applied["launches"]},
                "flash_decode": {"generate": gen["launches"],
                                 "long": long_run["launches"]}}
    exact_launches("[hymba] (a), (b), (c)", {
        "fastattn_fwd": applied["launches"], "flash_decode": gen["launches"],
        "flash_decode (c)": long_run["launches"]}, {
        "fastattn_fwd": layers,
        "flash_decode": layers * (DENSE_PROMPT + DENSE_NEW - 1),
        "flash_decode (c)": HYMBA_LONG_LAYERS * long_run["steps"]})
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del model, plain_model, params, toks
    gc.collect()
    torch.cuda.empty_cache()
    train = hymba_train(cfg)
    t_parts["d"] = time.perf_counter()
    launches["fastattn_fwd"]["train"] = train["launches"]
    exact_launches("[hymba] (d)", {"fastattn_fwd": train["launches"]},
                   {"fastattn_fwd": layers * 2 * HYMBA_TRAIN_STEPS})
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "params_real": n_real,
           "params_formula": param_count(cfg), "gate": gate, "rule":
           applied["rule"], "sensitivity": change, "launches": launches,
           "apply": applied, "generate": gen, "long": long_run,
           "profile": profile, "train": train, "serve_peak_mem_gb":
           serve_peak, "allocated_before_gb": left,
           "seconds": time.perf_counter() - t0, "card": _card()}
    prev, out["part_seconds"] = t0, {}
    for part, t in t_parts.items():
        out["part_seconds"][part], prev = t - prev, t
    log(f"[hymba] {out['card']}: phase 9 passed in {out['seconds']:.1f}s")
    log(f"[hymba] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the encoder-decoder -- whisper-small at full width and depth
# ---------------------------------------------------------------------------

WHISPER_BATCH = 8
# the decoder's length: whisper's text context (n_text_ctx of
# openai/whisper's ModelDimensions)
WHISPER_TEXT = 448
WHISPER_PROMPT, WHISPER_NEW = 4, 60       # (b): transcription decode
WHISPER_GEN_NEW = 16                      # (c): dense generate
WHISPER_TRAIN_STEPS = 3                   # (d)
FRAME_FLIP = 0.01             # the share of the encoder's inputs moved 1 ulp


def whisper_inputs(model, b: int, s: int, seed: int = 0) -> tuple:
    """N(0, 1) float32 frames (b, encoder_seq, d_model) from a generator
    on the model's device seeded with ``seed``, and (b, s) int32 tokens
    from numpy's generator seeded with ``seed``."""
    import numpy as np
    import torch
    cfg = model.cfg
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=model.device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)).to(model.device)
    return frames, toks


def perturbed_frames(seed: int = 9, frac: float = FRAME_FLIP):
    """Within the block, every encode sees its input -- the frames in the
    model's dtype, entering the frontend -- with a seeded ``frac`` of the
    elements moved by one ulp: what rounding alone does upstream of the
    whole model."""
    from repro_torch.models import encdec
    noisy = _ulp_noise(seed, frac)

    def wrap(frontend):
        def run(params, embeds, cfg, **kw):
            return frontend(params, noisy(embeds), cfg, **kw)
        return run
    return _wrapped(encdec, "apply_frontend", wrap)


def whisper_sensitivity(model, params, frames, toks) -> tuple:
    """The plain path's ``EncDec.apply`` logits and their largest relative
    change under ``perturbed_frames``: (logits, change)."""
    import torch
    with torch.no_grad():
        ref = model.apply(params, frames, toks, impl="reference")
        with perturbed_frames():
            change = _rel_change(model.apply(params, frames, toks,
                                             impl="reference").float(),
                                 ref.float())
    return ref, change


def whisper_apply(model, params, frames, toks, ref, gate: float) -> dict:
    """(a): ``EncDec.apply`` through the kernels (fastattn_fwd's launches
    counted), its logits held to the plain path's ``ref`` under ``gate``;
    ``encode`` alone timed too (median of 3)."""
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    b, s = toks.shape
    with torch.no_grad():
        fastattn_fwd.launches = 0
        wall, logits = _wall_s(lambda: model.apply(params, frames, toks))
        launches = fastattn_fwd.launches
        enc_ms, _ = _wall_ms(lambda: model.encode(params, frames), reps=3)
    if tuple(logits.shape) != (b, s, model.cfg.vocab_size):
        raise AssertionError(f"(a) logits {tuple(logits.shape)}")
    err = _logit_err(logits, ref)
    log(f"[whisper] (a) EncDec.apply {b} x ({frames.shape[1]} frames, {s} "
        f"tokens): {wall:.3f}s wall, encode alone {enc_ms:.1f} ms; "
        f"fastattn_fwd launches {launches}; kernel vs plain logits "
        f"{err[0]:.4f}, {err[1]:.4f} of their scale (median position "
        f"{err[2]:.4f})")
    _compare_logits("[whisper] (a) EncDec.apply logits, kernel vs plain",
                    logits.flatten(0, 1), ref.flatten(0, 1), gate)
    return {"wall_s": wall, "encode_ms": enc_ms, "launches": launches,
            "logit_err": err}


def transcribe(model, params, frames, prompt, n_new: int) -> tuple:
    """The JAX package's transcription loop: ``encode``, ``init_cache``
    with the encoder states (each layer's cross K/V projected once), then
    ``decode_step`` over ``prompt`` (B, P) teacher-forced and ``n_new``
    greedy tokens fed back.  Returns (the fed greedy tokens (B, n_new),
    every step's logits in float32 (B, P + n_new, V), the cache)."""
    import torch
    b, p = prompt.shape
    with torch.no_grad():
        enc = model.encode(params, frames)
        cache = model.init_cache(b, p + n_new + 1, enc_out=enc,
                                 params=params)
        del enc
        steps, toks = [], []
        for t in range(p + n_new):
            tok = prompt[:, t] if t < p else toks[t - p]
            logits, cache = model.decode_step(params, tok, cache, t)
            steps.append(logits.float())
            if p - 1 <= t < p + n_new - 1:
                toks.append(torch.argmax(logits, -1).to(prompt.dtype))
    return torch.stack(toks, 1), torch.stack(steps, 1), cache


def _margins(logits, gate: float) -> dict:
    """{(row, j): (top-1 margin, ``gate`` x the largest |logit|)} of
    logits (B, N, V): tokens_gate's reference margins."""
    import torch
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tol = gate * logits.float().abs().amax(-1).cpu().numpy()
    return {(r, j): (float(margin[r, j]), float(tol[r, j]))
            for r in range(margin.shape[0]) for j in range(margin.shape[1])}


def _counts() -> dict:
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.flash_decode.ops import flash_decode
    return {"fastattn_fwd": fastattn_fwd.launches,
            "flash_decode": flash_decode.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.flash_decode.ops import flash_decode
    fastattn_fwd.launches = flash_decode.launches = 0


def whisper_transcribe(model, plain_model, params, frames, prompt,
                       gate: float) -> dict:
    """(b): ``transcribe`` through the kernels, WHISPER_PROMPT prompt
    tokens and WHISPER_NEW greedy ones, both kernels' launches counted
    (the phase holds them); every step's logits held under ``gate`` to
    ``EncDec.apply`` on the same tokens; then ``plain_model``'s run, no
    kernel launched, its greedy tokens the kernel run's under the margin
    rule.  Also returns the kernel run's cache for (e)."""
    import torch
    b, p = prompt.shape
    n_new = WHISPER_NEW
    torch.cuda.synchronize()
    _zero_counts()
    wall, (toks, steps, cache) = _wall_s(
        lambda: transcribe(model, params, frames, prompt, n_new))
    launches = _counts()
    n = p + n_new
    log(f"[whisper] (b) transcription decode B={b}: encode, {p} prompt "
        f"tokens and {n_new} greedy ones, {wall:.2f}s wall "
        f"({wall / n * 1e3:.1f} ms a step); launches {launches}")
    seq = torch.cat([prompt, toks], dim=1)
    with torch.no_grad():
        full = model.apply(params, frames, seq).float()
    _compare_logits(f"[whisper] (b) decode_step logits at positions 0-"
                    f"{n - 1} vs EncDec.apply on the same tokens",
                    steps.flatten(0, 1), full.flatten(0, 1), gate)
    del full
    _zero_counts()
    plain_toks, plain_steps, _ = transcribe(plain_model, params, frames,
                                            prompt, n_new)
    plain_launches = _counts()
    exact_launches("[whisper] (b) the plain run", plain_launches,
                   {"fastattn_fwd": 0, "flash_decode": 0})
    equal, total = tokens_gate(
        "[whisper] (b) greedy tokens, kernel vs plain",
        {r: toks[r].tolist() for r in range(b)},
        {r: plain_toks[r].tolist() for r in range(b)},
        _margins(plain_steps[:, p - 1:n - 1], gate))
    log(f"[whisper] (b) {equal} of {total} greedy tokens equal to the plain "
        "run's before a fork at a near-tie")
    return {"wall_s": wall, "steps": n, "ms_per_step": wall / n * 1e3,
            "launches": launches, "plain_launches": plain_launches,
            "tokens_equal": equal, "tokens": total, "cache": cache}


def whisper_generate(model, plain_model, params, prompt,
                     gate: float) -> dict:
    """(c): ``ServeEngine.generate`` of ``prompt`` (B, P) and
    WHISPER_GEN_NEW greedy tokens over the zero cross cache (JAX's dense
    engine passes no encoder states), both kernels' launches counted (the
    phase holds them); ``plain_model``'s engine on the same prompt, no
    kernel launched, its greedy tokens the kernel run's under the margin
    rule."""
    import torch
    from repro_torch.config import ServeConfig
    b, p = prompt.shape
    n_new = WHISPER_GEN_NEW
    serve = ServeConfig(max_seq_len=p + n_new + 1, top_k=1)
    runs = {}
    for name, m in (("kernel", model), ("plain", plain_model)):
        engine, seen, _ = _recording_engine(m, params, serve,
                                            lambda q: q >= p - 1)
        torch.cuda.synchronize()
        _zero_counts()
        wall, out = _wall_s(lambda: engine.generate(prompt, n_new))
        runs[name] = {"wall_s": wall, "launches": _counts(), "out": out,
                      "logits": torch.stack([seen[q] for q in range(
                          p - 1, p - 1 + n_new)], dim=1)}
        del engine, seen
    exact_launches("[whisper] (c) the plain generate",
                   runs["plain"]["launches"],
                   {"fastattn_fwd": 0, "flash_decode": 0})
    out, ref = runs["kernel"]["out"], runs["plain"]["out"]
    if tuple(out.shape) != (b, n_new):
        raise AssertionError(f"(c) bad generated tokens {tuple(out.shape)}")
    equal, total = tokens_gate(
        "[whisper] (c) generate's greedy tokens, kernel vs plain",
        {r: out[r].tolist() for r in range(b)},
        {r: ref[r].tolist() for r in range(b)},
        _margins(runs["plain"]["logits"], gate))
    wall = runs["kernel"]["wall_s"]
    log(f"[whisper] (c) generate B={b} x {p} + {n_new}: {wall:.2f}s wall, "
        f"launches {runs['kernel']['launches']}; {equal} of {total} greedy "
        "tokens equal to the plain engine's before a fork at a near-tie")
    return {"wall_s": wall, "plain_wall_s": runs["plain"]["wall_s"],
            "launches": runs["kernel"]["launches"],
            "plain_launches": runs["plain"]["launches"],
            "tokens_equal": equal, "tokens": total,
            "new_tok_s": b * n_new / wall}


def whisper_profile(model, params, frames, cache, pos: int) -> dict:
    """(e): one ``encode`` of the frames and one decode step at ``pos`` of
    (b)'s cache: wall (median of 3 and 5), the kernels' device time in one
    profiled run, the idle share, the launches, and fastattn_fwd's and
    flash_decode's device time and launches in it."""
    import torch
    b = frames.shape[0]
    tok = torch.zeros((b,), dtype=torch.int32, device=frames.device)

    def encode():
        return model.encode(params, frames)

    def step():
        return model.decode_step(params, tok, cache, pos)
    out = {}
    with torch.no_grad():
        for name, fn, reps in ((f"encode B={b}", encode, 3),
                               (f"decode step B={b}", step, 5)):
            wall, _ = _wall_ms(fn, reps=reps)
            kernels, dev_s = _profile_kernels(fn)
            res = {"wall_ms": wall, "device_ms": dev_s * 1e3,
                   "idle_share": 1 - dev_s * 1e3 / wall,
                   "kernel_launches": sum(k.count for k in kernels)}
            for k in ("fastattn_fwd", "flash_decode"):
                ours = [e for e in kernels if f"{k}_" in e.key]
                res[f"{k}_device_ms"] = sum(_device_us(e) for e in ours) / 1e3
                res[f"{k}_launches"] = sum(e.count for e in ours)
            top = sorted(kernels, key=_device_us, reverse=True)[:4]
            res["top"] = [(k.key[:48], _device_us(k) / 1e3, k.count)
                          for k in top]
            log(f"[whisper] (e) {name}: {wall:.2f} ms wall, "
                f"{res['device_ms']:.2f} ms of kernels in one profiled run "
                f"({res['kernel_launches']} launches, idle share "
                f"{res['idle_share']:.3f}); fastattn_fwd "
                f"{res['fastattn_fwd_device_ms']:.3f} ms "
                f"({res['fastattn_fwd_launches']}), flash_decode "
                f"{res['flash_decode_device_ms']:.3f} ms "
                f"({res['flash_decode_launches']}); largest kernels (name, "
                f"device ms, launches): {res['top']}")
            out[name] = res
    return out


def whisper_train(cfg, device: str = "cuda") -> dict:
    """(d): WHISPER_TRAIN_STEPS AdamW steps at WHISPER_BATCH x
    (encoder_seq frames, WHISPER_TEXT tokens) through the trainer's
    functions (remat "selective", as launch/train.py), fastattn_fwd's
    launches counted; batches of TokenPipeline's tokens and labels and
    N(0, 1) frames from a seeded generator.  Before them, step 0's batch
    through the plain attention path: the first step's loss and grad norm
    within LOSS_RTOL and GNORM_RTOL of its."""
    import math

    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    parallel = ParallelConfig(remat="selective")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=WHISPER_TRAIN_STEPS)
    model = build_model(cfg, device, parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=WHISPER_TEXT,
                                    global_batch=WHISPER_BATCH))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(2)
    batches = []
    for _ in range(WHISPER_TRAIN_STEPS):
        batch = to_device(data.next(), model.device)
        batch["enc_embeds"] = torch.randn(
            (WHISPER_BATCH, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=model.device)
        batches.append(batch)
    p_loss, p_gn = _loss_and_gnorm(model, state.params, batches[0],
                                   "reference")
    torch.cuda.reset_peak_memory_stats()
    fastattn_fwd.launches = 0
    losses, gnorms, step_s = [], [], []
    for i, batch in enumerate(batches):
        dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        log(f"[whisper] (d) step {i} loss {losses[-1]:.4f} gnorm "
            f"{gnorms[-1]:.4f} {dt * 1e3:.1f} ms")
    launches = fastattn_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"(d) non-finite loss or grad norm: {losses}, "
                             f"{gnorms}")
    loss_rel = abs(losses[0] - p_loss) / abs(p_loss)
    gn_rel = abs(gnorms[0] - p_gn) / abs(p_gn)
    log(f"[whisper] (d) step 0 vs the plain path on its batch: loss "
        f"{losses[0]:.5f} vs {p_loss:.5f} (rel {loss_rel:.2e}, tol "
        f"{LOSS_RTOL}), grad norm {gnorms[0]:.5f} vs {p_gn:.5f} (rel "
        f"{gn_rel:.2e}, tol {GNORM_RTOL}); peak memory {peak:.2f} GB")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("(d) kernel and plain training paths disagree")
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "plain_loss_gnorm": [p_loss, p_gn], "loss_rel": loss_rel,
            "gnorm_rel": gn_rel, "launches": launches, "peak_mem_gb": peak,
            "tok_s": WHISPER_BATCH * WHISPER_TEXT / statistics.median(
                step_s[1:])}


def phase_whisper() -> dict:
    """Phase 10: whisper-small (12 encoder and 12 decoder layers, d_model
    768, 12/12 heads of 64, vocab 51,865, encoder_seq 1500) at full width
    and depth, bf16, random weights from a seeded CUDA generator, after
    every earlier model is freed; the tensors' and the formula's parameter
    counts logged.  The gate (``hymba_gate``'s rule) comes from the plain
    path's own change under one ulp on 1% of the encoder's inputs.  (a)
    EncDec.apply on 8 x (1500 frames, 448 tokens), exactly 36
    fastattn_fwd launches, logits held to the plain path; (b) the
    transcription loop, 4 prompt and 60 greedy tokens (``transcribe``):
    fastattn_fwd exactly 12 + 12 x 64, flash_decode 12 x 64, each step's
    logits held to EncDec.apply on the same tokens, the greedy tokens to
    a plain run under the margin rule; (c) ServeEngine.generate 8 x (4 +
    16) over the zero cross cache, each kernel exactly 12 x 19, tokens
    held to the plain engine's; (e) an encode and a decode step profiled;
    (d) 3 AdamW steps at 8 x (1500, 448) (remat), finite, exactly 36 x 2
    x 3 launches, step 0's loss and grad norm held to the plain path's.
    Every plain run launches no kernel."""
    import torch
    from repro_torch.analysis.flops import param_count
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    model, params = build_full(WHISPER_ARCH)
    cfg = model.cfg
    n_real = sum(t.numel() for t in _leaves(params))
    log(f"[whisper] {cfg.name}: {cfg.encoder_layers} encoder and "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"encoder_seq {cfg.encoder_seq}, vocab {cfg.vocab_size}; parameters "
        f"{n_real:,} in the tensors, {param_count(cfg):,} by the "
        f"reference's formula (analysis/flops.param_count); {left:.2f} GB "
        f"allocated before the build")
    frames, toks = whisper_inputs(model, WHISPER_BATCH, WHISPER_TEXT)
    t_parts = {"build": time.perf_counter()}
    ref, change = whisper_sensitivity(model, params, frames, toks)
    gate, rule = hymba_gate(change)
    t_parts["gate"] = time.perf_counter()
    log(f"[whisper] gate {gate:.4g} ({rule}): the plain path's logits move "
        f"by {change:.4g} of their scale with one ulp on {FRAME_FLIP:.0%} "
        "of the encoder's inputs (LOGIT_TOL where that is at most half of "
        "it, else max(LOGIT_TOL, twice it))")
    applied = whisper_apply(model, params, frames, toks, ref, gate)
    t_parts["a"] = time.perf_counter()
    del ref
    plain_model = build_model(dataclasses.replace(
        cfg, attention_impl="reference"), device=model.device)
    prompt = toks[:, :WHISPER_PROMPT].contiguous()
    trans = whisper_transcribe(model, plain_model, params, frames, prompt,
                               gate)
    t_parts["b"] = time.perf_counter()
    gen = whisper_generate(model, plain_model, params, prompt, gate)
    t_parts["c"] = time.perf_counter()
    profile = whisper_profile(model, params, frames, trans.pop("cache"),
                              WHISPER_PROMPT + WHISPER_NEW)
    t_parts["e"] = time.perf_counter()
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del model, plain_model, params, frames, toks, prompt
    gc.collect()
    torch.cuda.empty_cache()
    train = whisper_train(cfg)
    t_parts["d"] = time.perf_counter()
    # (a), (d): the encoder's, the decoder's self- and cross-attention
    attn = cfg.encoder_layers + 2 * cfg.num_layers
    n_b = WHISPER_PROMPT + WHISPER_NEW              # (b)'s decode steps
    n_c = WHISPER_PROMPT + WHISPER_GEN_NEW - 1      # (c)'s
    launches = {"fastattn_fwd": {
        "apply": applied["launches"],
        "transcribe": trans["launches"]["fastattn_fwd"],
        "generate": gen["launches"]["fastattn_fwd"],
        "train": train["launches"]}, "flash_decode": {
        "transcribe": trans["launches"]["flash_decode"],
        "generate": gen["launches"]["flash_decode"]}}
    exact_launches("[whisper] (a)-(d) fastattn_fwd",
                   launches["fastattn_fwd"], {
                       "apply": attn,
                       "transcribe": cfg.encoder_layers + cfg.num_layers
                       * n_b,
                       "generate": cfg.num_layers * n_c,
                       "train": attn * 2 * WHISPER_TRAIN_STEPS})
    exact_launches("[whisper] (b), (c) flash_decode",
                   launches["flash_decode"], {
                       "transcribe": cfg.num_layers * n_b,
                       "generate": cfg.num_layers * n_c})
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "params_real": n_real,
           "params_formula": param_count(cfg), "gate": gate, "rule": rule,
           "sensitivity": change, "launches": launches, "apply": applied,
           "transcribe": trans, "generate": gen, "profile": profile,
           "train": train, "serve_peak_mem_gb": serve_peak,
           "allocated_before_gb": left,
           "seconds": time.perf_counter() - t0, "card": _card()}
    prev, out["part_seconds"] = t0, {}
    for part, t in t_parts.items():
        out["part_seconds"][part], prev = t - prev, t
    log(f"[whisper] {out['card']}: phase 10 passed in {out['seconds']:.1f}s")
    log(f"[whisper] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 11: M-RoPE and the vision stub -- qwen2-vl-72b at full width
# ---------------------------------------------------------------------------

# the first 16 of qwen2-vl-72b's 80 layers: 16.6 B parameters, 33.2 GB of
# bf16 (full depth is 145.5 GB); the script's time limit, not the card's
# memory (~30 layers would fit), sets the cut
VL_LAYERS = 16
VL_SEQ = 2048                 # (a), (d): one row of 2048 positions
VL_TEXT = 64                  # (a), (d): text tokens before the image
VL_GRID = (32, 48)            # (a), (d): the image's patch rows x columns
VL_TRAIN_LAYERS, VL_TRAIN_STEPS = 2, 3        # (d)


def vl_positions(b: int, s: int, n_text: int = None, grid=None,
                 device="cuda") -> tuple:
    """Qwen2-VL's M-RoPE positions (Hugging Face
    ``Qwen2VLForConditionalGeneration.get_rope_index``) of rows of
    ``n_text`` text tokens, one image of ``grid`` patches and text to
    ``s``: text at t = h = w = i, patch (r, c) at (n_text, n_text + r,
    n_text + c), the text after the image from n_text + max(grid)
    (VL_TEXT and VL_GRID by default).  Returns ((3, b, s) int64
    positions, (b, s) mask of the patches)."""
    import torch
    n_text = VL_TEXT if n_text is None else n_text
    grid = VL_GRID if grid is None else grid
    gh, gw = grid
    n_img = gh * gw
    if n_text + n_img > s:
        raise ValueError(f"{n_text} text tokens and {n_img} patches do not "
                         f"fit in {s} positions")
    i = torch.arange(s, device=device)
    img = (i >= n_text) & (i < n_text + n_img)
    j = (i - n_text).clamp(0, n_img - 1)
    t = torch.where(i < n_text, i, torch.where(
        img, n_text, i - n_img + max(grid)))
    h = torch.where(img, n_text + j // gw, t)
    w = torch.where(img, n_text + j % gw, t)
    return torch.stack([t, h, w])[:, None].expand(3, b, s), img.expand(b, s)


def vl_inputs(model, b: int, s: int, seed: int = 0) -> tuple:
    """N(0, 1) float32 patch and token embeddings (b, s, d_model) from a
    generator on the model's device seeded with ``seed``, and
    ``vl_positions``'s positions and patch mask."""
    import torch
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    emb = torch.randn((b, s, model.cfg.d_model), generator=gen,
                      device=model.device)
    return (emb, *vl_positions(b, s, device=model.device))


def vl_batch(model, b: int, s: int, seed: int) -> dict:
    """A vision training batch: ``vl_inputs``'s embeddings and positions,
    seeded random labels masked (-1) on the image's patches."""
    import torch
    emb, pos, image = vl_inputs(model, b, s, seed)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 1000)
    labels = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                           device=model.device)
    return {"inputs_embeds": emb, "positions": pos,
            "labels": torch.where(image, -1, labels)}


def serve_gate(what, served: dict, layers: int) -> None:
    """Phase 3's serving run ``served`` on a model of ``layers`` layers:
    each paged kernel exactly one launch a layer a prefill launch or
    decode step, and no page left in use."""
    exact_launches(what, served["launches"], {
        "paged_prefill": layers * served["prefill_launches"],
        "paged_decode": layers * served["decode_launches"]})
    if served["pages_used"] != 0:
        raise AssertionError(f"{what}: {served['pages_used']} pages leaked")


def vl_sensitivity(model, params, emb, pos) -> tuple:
    """The plain path's vision logits and their largest relative change
    under ``perturbed_first_block``: (logits, change)."""
    import torch
    with torch.no_grad():
        ref = model.apply(params, inputs_embeds=emb, positions=pos,
                          impl="reference")
        with perturbed_first_block(model):
            change = _rel_change(model.apply(
                params, inputs_embeds=emb, positions=pos,
                impl="reference").float(), ref.float())
    return ref, change


def vl_apply(model, params, emb, pos, ref, gate: float) -> dict:
    """(a): the vision LM.apply through the kernels (fastattn_fwd's
    launches counted), its logits held to the plain path's ``ref`` under
    ``gate``.  Then, with no gate, how far the logits move when the same
    embeddings get t = h = w = index positions, over every row and over
    the text rows before the image (whose positions are the same)."""
    import torch
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    b, s = emb.shape[:2]
    with torch.no_grad():
        fastattn_fwd.launches = 0
        wall, logits = _wall_s(lambda: model.apply(
            params, inputs_embeds=emb, positions=pos))
        launches = fastattn_fwd.launches
        if logits.shape != (b, s, model.cfg.vocab_size):
            raise AssertionError(f"(a) logits {tuple(logits.shape)}")
        err = _logit_err(logits, ref)
        log(f"[vl] (a) LM.apply {b} x {s} (patch embeddings, M-RoPE "
            f"positions): {wall:.3f}s wall, fastattn_fwd launches "
            f"{launches}; kernel vs plain logits {err[0]:.4f}, {err[1]:.4f} "
            f"of their scale (median position {err[2]:.4f})")
        _compare_logits("[vl] (a) LM.apply logits, kernel vs plain",
                        logits.flatten(0, 1), ref.flatten(0, 1), gate)
        flat = model.apply(params, inputs_embeds=emb)
    moved = _rel_change(flat.float(), logits.float())
    before = (flat[:, :VL_TEXT].float() - logits[:, :VL_TEXT].float()
              ).abs().max().item()
    log(f"[vl] (a) the same embeddings at t = h = w = index positions (no "
        f"gate): the logits move by {moved:.4f} of their scale; the "
        f"{VL_TEXT} text rows before the image, whose positions are the "
        f"same, by {before:.3g}")
    return {"wall_s": wall, "launches": launches, "logit_err": err,
            "index_positions_change": moved,
            "index_positions_text_rows_change": before}


def vl_profile(model, params) -> dict:
    """(e): a B=8 decode step (``LM.decode_step`` at position 0 of a dense
    cache): wall (median of 5), device time of one profiled run, its
    idle share, its launches and largest kernels, beside its byte bound
    (every weight a decode step reads once: not the frontend, of the
    embedding table only the tokens' rows)."""
    import torch
    cfg = model.cfg
    b = DENSE_BATCH
    cache = model.init_cache(b, 8)
    tok = torch.arange(b, dtype=torch.int32, device=model.device)
    unread = params["embedding"]["embed"].numel() + sum(
        t.numel() for t in _leaves(params["frontend"]))
    n_read = sum(t.numel() for t in _leaves(params)) - unread + b * cfg.d_model
    bound = n_read * 2 / H100_BYTES_PER_S * 1e3

    def step():
        return model.decode_step(params, tok, cache, 0)
    with torch.no_grad():
        wall, _ = _wall_ms(step, reps=5)
        kernels, dev_s = _profile_kernels(step)
    top = sorted(kernels, key=_device_us, reverse=True)[:4]
    res = {"wall_ms": wall, "device_ms": dev_s * 1e3,
           "idle_share": 1 - dev_s * 1e3 / wall, "bound_ms": bound,
           "bound_by": "bytes", "bytes_gb": n_read * 2 / 1e9,
           "kernel_launches": sum(k.count for k in kernels),
           "top": [(k.key[:48], _device_us(k) / 1e3, k.count) for k in top]}
    log(f"[vl] (e) decode step B={b}: {wall:.2f} ms wall, {dev_s * 1e3:.2f} "
        f"ms of kernels in one profiled run ({res['kernel_launches']} "
        f"launches, idle share {res['idle_share']:.3f}), bound {bound:.2f} "
        f"ms ({res['bytes_gb']:.2f} GB of weights); largest kernels (name, "
        f"device ms, launches): {res['top']}")
    return res


def vl_train(cfg, device: str = "cuda") -> dict:
    """(d): VL_TRAIN_STEPS AdamW steps of ``cfg`` cut to its first
    VL_TRAIN_LAYERS layers at 1 x VL_SEQ through the trainer's functions
    (remat "selective", as launch/train.py), fastattn_fwd's launches
    counted, on vision batches (``vl_batch``: the image's labels masked).
    Before them, step 0's batch through the plain attention path: the
    first step's loss and grad norm within LOSS_RTOL and GNORM_RTOL of
    its.  Peak memory logged."""
    import math

    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.models import build_model
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = dataclasses.replace(cfg, num_layers=VL_TRAIN_LAYERS)
    parallel = ParallelConfig(remat="selective")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=VL_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device, parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    n_params = sum(t.numel() for t in _leaves(state.params))
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    batches = [vl_batch(model, 1, VL_SEQ, seed=10 + i)
               for i in range(VL_TRAIN_STEPS)]
    p_loss, p_gn = _loss_and_gnorm(model, state.params, batches[0],
                                   "reference")
    fastattn_fwd.launches = 0
    losses, gnorms, step_s = [], [], []
    for i, batch in enumerate(batches):
        dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        log(f"[vl] (d) step {i} loss {losses[-1]:.4f} gnorm "
            f"{gnorms[-1]:.4f} {dt * 1e3:.1f} ms")
    launches = fastattn_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"(d) non-finite loss or grad norm: {losses}, "
                             f"{gnorms}")
    loss_rel = abs(losses[0] - p_loss) / abs(p_loss)
    gn_rel = abs(gnorms[0] - p_gn) / abs(p_gn)
    log(f"[vl] (d) {cfg.num_layers} layers, {n_params:,} parameters; step 0 "
        f"vs the plain path on its batch: loss {losses[0]:.5f} vs "
        f"{p_loss:.5f} (rel {loss_rel:.2e}, tol {LOSS_RTOL}), grad norm "
        f"{gnorms[0]:.5f} vs {p_gn:.5f} (rel {gn_rel:.2e}, tol "
        f"{GNORM_RTOL}); peak memory {peak:.2f} GB")
    if not (loss_rel <= LOSS_RTOL and gn_rel <= GNORM_RTOL):
        raise AssertionError("(d) kernel and plain training paths disagree")
    if not peak < 80:
        raise AssertionError(f"(d) peak memory {peak:.2f} GB")
    return {"layers": cfg.num_layers, "params": n_params, "losses": losses,
            "grad_norms": gnorms, "step_s": step_s,
            "plain_loss_gnorm": [p_loss, p_gn], "loss_rel": loss_rel,
            "gnorm_rel": gn_rel, "launches": launches, "peak_mem_gb": peak,
            "tok_s": VL_SEQ / statistics.median(step_s[1:])}


def phase_vl() -> dict:
    """Phase 11: qwen2-vl-72b (M-RoPE, the vision stub; 64/8 heads of 128)
    at full width, cut to its first VL_LAYERS of 80 layers, bf16, random
    weights from a seeded CUDA generator, after every earlier model is
    freed; the tensors' and the formula's parameter counts logged.  The
    gate (``hymba_gate``'s rule) comes from the plain path's own change
    under one ulp on 1% of block 0's inputs.  (a) the vision LM.apply on
    1 x 2048 (64 text tokens, a 32 x 48 image, 448 text tokens; Qwen2-VL's
    positions), exactly one fastattn_fwd launch a layer, logits held to
    the plain path, the move under index positions logged; (b) phase 3's
    serving: each paged kernel exactly one launch a layer a prefill
    launch or decode step, no page left; (c) phase 3b's generate:
    flash_decode exactly layers x 159 launches, greedy tokens equal the
    paged engine's under the margin rule; (e) a B=8 decode step profiled;
    (d) VL_TRAIN_STEPS AdamW steps on the first VL_TRAIN_LAYERS layers at
    1 x 2048 on vision batches, exactly layers x 2 x steps launches, step
    0 held to the plain path, peak memory under 80 GB.  Runs on cuda or
    fails."""
    import torch
    from repro_torch.analysis.flops import param_count
    from repro_torch.config import get_model_config
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    cfg = dataclasses.replace(get_model_config(VL_ARCH),
                              num_layers=VL_LAYERS)
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    layers = cfg.num_layers
    n_real = sum(t.numel() for t in _leaves(params))
    log(f"[vl] {cfg.name}: the first {layers} of "
        f"{get_model_config(VL_ARCH).num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, M-RoPE sections {cfg.mrope_sections}, vocab "
        f"{cfg.vocab_size}; parameters {n_real:,} in the tensors "
        f"({n_real * 2 / 1e9:.1f} GB), {param_count(cfg):,} by the "
        f"reference's formula (no frontend); {left:.2f} GB allocated before "
        f"the build, {torch.cuda.memory_allocated() / 1e9:.2f} GB after")
    emb, pos, _ = vl_inputs(model, 1, VL_SEQ)
    t_parts = {"build": time.perf_counter()}
    ref, change = vl_sensitivity(model, params, emb, pos)
    gate, rule = hymba_gate(change)
    t_parts["gate"] = time.perf_counter()
    log(f"[vl] gate {gate:.4g} ({rule}): the plain path's logits move by "
        f"{change:.4g} of their scale with one ulp on {BLOCK_FLIP:.0%} of "
        "block 0's inputs (LOGIT_TOL where that is at most half of it, "
        "else max(LOGIT_TOL, twice it))")
    applied = vl_apply(model, params, emb, pos, ref, gate)
    del ref, emb, pos
    t_parts["a"] = time.perf_counter()
    served = phase_serving(model, params, rel_tol=gate)
    serve_gate("[vl] (b)", served, layers)
    t_parts["b"] = time.perf_counter()
    dense = phase_dense(model, params, rel_tol=gate)
    exact_launches("[vl] (c)", {"flash_decode": dense["launches"]}, {
        "flash_decode": layers * (DENSE_PROMPT + DENSE_NEW - 1)})
    t_parts["c"] = time.perf_counter()
    profile = vl_profile(model, params)
    t_parts["e"] = time.perf_counter()
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    train = vl_train(cfg)
    t_parts["d"] = time.perf_counter()
    exact_launches("[vl] (d)", {"fastattn_fwd": train["launches"]}, {
        "fastattn_fwd": VL_TRAIN_LAYERS * 2 * VL_TRAIN_STEPS})
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "layers": layers, "params_real": n_real,
           "params_formula": param_count(cfg), "gate": gate, "rule": rule,
           "sensitivity": change, "launches": {
               **served["launches"], "flash_decode": dense["launches"],
               "fastattn_fwd": {"apply": applied["launches"],
                                "train": train["launches"]}},
           "flash_decode": dense["kernel"], "apply": applied,
           "serve": {k: served[k] for k in (
               "wall_s", "prefill_tok_s", "decode_tok_s", "steps",
               "prefill_launches", "decode_launches", "prefill_device_s",
               "decode_device_s", "peak_mem_gb")},
           "generate_tok_s": dense["tokens_per_s_generate"],
           "tokens_equal": dense["tokens_equal"],
           "tokens_clear": dense["tokens_clear"], "profile": profile,
           "train": train, "serve_peak_mem_gb": serve_peak,
           "allocated_before_gb": left,
           "seconds": time.perf_counter() - t0, "card": _card()}
    prev, out["part_seconds"] = t0, {}
    for part, t in t_parts.items():
        out["part_seconds"][part], prev = t - prev, t
    log(f"[vl] {out['card']}: phase 11 passed in {out['seconds']:.1f}s")
    log(f"[vl] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the model axis over the recurrent cells and the encoder-decoder
# ---------------------------------------------------------------------------

# each model at full width, cut in depth, and its sequence: xlstm-125m's
# first 3 layers (mlstm, mlstm, slstm: both recurrent kinds), hymba-1.5b's
# first 2 (one global, one windowed), whisper-small's 2 encoder and 2
# decoder layers on 448 tokens and its 1500 frames
MESH_MODELS = {"xlstm-125m": (dict(num_layers=3), 1024),
               "hymba-1.5b": (dict(num_layers=2), 1024),
               "whisper-small": (dict(encoder_layers=2, num_layers=2), 448)}
MESH_BATCH = 4
MESH_STEPS = 2
# the measured gate of xlstm-125m (phase 6's rule for its bf16
# ill-conditioning): its one-device run again with one bf16 ulp on 1% of
# every mlstm h, and each bound past step 0's loss and grad norm twice
# that change where that is larger (``measured_mesh_gate``)
MESH_MEASURED = ("xlstm-125m",)
# each leaf's step-0 gradient (the one the first AdamW update is handed,
# on the same weights and batch on both sides) within this of one
# device's, as ||g_mesh - g_one|| / ||g_one||: a leaf the mesh dropped
# reads 1.0, one of the right size in a random direction about 1.41.  A
# measured bound must stay under MESH_GRAD_CAP, or the gate could not
# tell such a leaf from a sound one.
MESH_GRAD_RTOL = 0.15
MESH_GRAD_CAP = 0.75


def mesh_batches(cfg, b: int, s: int, steps: int, device) -> list:
    """``steps`` global batches of b x s from the data pipeline; an
    encoder-decoder's with N(0, 1) frames from a generator on ``device``
    seeded with 2, drawn after each batch's tokens (as ``_dist_job``
    draws them on every rank)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import to_device
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                    global_batch=b))
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    out = []
    for _ in range(steps):
        batch = to_device(data.next(), torch.device(device))
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = torch.randn(
                (b, cfg.encoder_seq, cfg.d_model), generator=gen,
                device=device)
        out.append(batch)
    return out


def mesh_reference(cfg, s: int, device: str = "cuda",
                   perturb=None) -> dict:
    """Phase 12's one-device run of ``cfg``: MESH_STEPS AdamW steps at
    MESH_BATCH x ``s`` through the trainer's functions (remat "full",
    phase 4's TrainConfig over MESH_STEPS), under the context
    ``perturb()`` where given.  Returns phase 4b's reference: host copies
    of the initial and final parameters in tree order, their paths, each
    step's loss, grad norm and lr; host copies of step 0's gradients
    ("grad0", ``first_step_grads``); and the steps' walls, each kernel's
    launches and the peak memory."""
    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise_fwd
    from repro_torch.models import build_model
    from repro_torch.training import tree
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    parallel = ParallelConfig(remat="full")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=MESH_STEPS)
    model = build_model(cfg, device, parallel)
    state = init_train_state(model, model.generator(tcfg.seed))
    ref = {"init": [t.to("cpu", copy=True)
                    for t in tree.leaves(state.params)],
           "paths": [p for p, _ in tree.leaves_with_paths(state.params)],
           "loss": [], "grad_norm": [], "lr": [], "step_s": []}
    step_fn = make_train_step(model, cfg, parallel, tcfg)
    batches = mesh_batches(cfg, MESH_BATCH, s, MESH_STEPS, device)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    fastattn_fwd.launches = mlstm_chunkwise_fwd.launches = 0
    grads: list = []
    with perturb() if perturb else contextlib.nullcontext(), \
            first_step_grads(grads):
        for batch in batches:
            dt, (state, metrics) = _wall_s(lambda: step_fn(state, batch))
            ref["step_s"].append(dt)
            for k in ("loss", "grad_norm", "lr"):
                ref[k].append(float(metrics[k]))
    ref["grad0"] = [g.to("cpu") for g in grads]
    del grads
    ref["launches"] = {"fastattn_fwd": fastattn_fwd.launches,
                       "mlstm_chunkwise": mlstm_chunkwise_fwd.launches}
    ref["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if torch.cuda.is_available() else None)
    ref["snapshot"] = [t.to("cpu", copy=True)
                       for t in tree.leaves(state.params)]
    if not all(math.isfinite(x) for x in ref["loss"] + ref["grad_norm"]):
        raise AssertionError(f"[12] {cfg.name}: non-finite loss or grad "
                             f"norm on one device: {ref['loss']}, "
                             f"{ref['grad_norm']}")
    return ref


def first_step_grads(out: list):
    """A context in which the first train step's gradients, as it hands
    them to AdamW (under a mesh: this rank's piece of each leaf's
    gradient summed over the mesh), are copied into ``out`` in tree
    order."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree
    update = opt.adamw_update

    def recording(grads, *args, **kw):
        if not out:
            out.extend(g.detach().clone() for g in tree.leaves(grads))
        return update(grads, *args, **kw)

    @contextlib.contextmanager
    def patched():
        opt.adamw_update = recording
        try:
            yield out
        finally:
            opt.adamw_update = update
    return patched()


def leaf_rel(paths: list, base: list, a: list, b: list = None) -> dict:
    """path -> ||b - a|| / ||a - base|| of each leaf in float32 (with
    ``b`` None: ||a - base|| / ||base||, a change against the leaf's own
    size); 0 where both norms are 0."""
    out = {}
    for i, path in enumerate(paths):
        x0, x1 = base[i].float(), a[i].float()
        if b is None:
            num, den = (x1 - x0).norm().item(), x0.norm().item()
        else:
            num, den = (b[i].float() - x1).norm().item(), \
                (x1 - x0).norm().item()
        out[path] = num / den if den > 0 else 0.0 if num == 0 else math.inf
    return out


def measured_mesh_gate(ref: dict, pert: dict) -> dict:
    """Phase 6's rule on phase 12's bounds: what one bf16 ulp on 1% of
    every mlstm h does to the one-device run (``pert`` against ``ref``) --
    each step's loss and grad norm, and the leaf whose update (as
    ``delta_gate`` measures it) and whose step-0 gradient change most --
    and the bounds: step 0's loss and grad norm phase 4b's (the same
    weights and batch on both sides, the step's gradients held leaf by
    leaf), a later step's the larger of phase 4b's and twice the largest
    change over the steps; every leaf's update and step-0 gradient the
    larger of phase 4b's (MESH_GRAD_RTOL for a gradient) and twice the
    largest leaf's change.  Raises where the gradient bound reaches
    MESH_GRAD_CAP: the gate could not see a leaf dropped."""
    def rel(k):
        return [abs(b - a) / abs(a) for a, b in zip(ref[k], pert[k])]

    def steps(k, floor):
        return [floor] + [max(floor, 2 * max(measured[k]))] * (
            len(measured[k]) - 1)

    def worst(changes):
        path = max(changes, key=changes.get)
        return [path, changes[path]]
    paths = ref["paths"]
    measured = {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
                "delta": worst(leaf_rel(paths, ref["init"], ref["snapshot"],
                                        pert["snapshot"])),
                "grad0": worst(leaf_rel(paths, ref["grad0"], pert["grad0"]))}
    gates = {"measured": measured,
             "loss": steps("loss", DIST_LOSS_RTOL),
             "grad_norm": steps("grad_norm", DIST_GNORM_RTOL),
             "delta": max(DIST_DELTA_RTOL, 2 * measured["delta"][1]),
             "grad0": max(MESH_GRAD_RTOL, 2 * measured["grad0"][1])}
    if gates["grad0"] >= MESH_GRAD_CAP:
        raise AssertionError(f"measured step-0 gradient bound "
                             f"{gates['grad0']} ({measured['grad0']}) reaches "
                             f"MESH_GRAD_CAP = {MESH_GRAD_CAP}: such a gate "
                             "passes a leaf the mesh dropped")
    return gates


def mesh_expected(cfg, s: int, model: int) -> dict:
    """The launches each rank of phase 12 must make at a model axis of
    ``model`` (remat: two forward passes a step): fastattn_fwd once an
    attention a pass -- an LM's attention blocks at the rank's first row;
    an encoder-decoder's encoder (non-causal, its first frame), decoder
    (causal, its first token) and cross-attention (offset 0) -- and
    mlstm_chunkwise once an mLSTM block a pass at H / model heads (H where
    the model axis does not split them, ``ssm.channel_shards``)."""
    from repro_torch.layers.ssm import channel_shards
    passes = 2 * MESH_STEPS
    kinds = [] if cfg.is_encoder_decoder else list(cfg.blocks())
    if cfg.is_encoder_decoder:
        attn = cfg.encoder_layers + 2 * cfg.num_layers

        def offsets(m):
            return sorted({0, m * cfg.encoder_seq // model, m * s // model})
    else:
        attn = sum(k not in ("mlstm", "slstm") for k in kinds)

        def offsets(m):
            return [m * s // model]
    split = model if channel_shards(cfg, "mlstm", model) else 1
    return {"fastattn_fwd": attn * passes, "offsets": offsets,
            "mlstm_chunkwise": kinds.count("mlstm") * passes,
            "mlstm_heads": ([cfg.num_heads // split]
                            if "mlstm" in kinds else [])}


def mesh_launch_gate(what, ranks: list, want: dict) -> None:
    """Each rank launched mlstm_chunkwise exactly ``want``'s count, at
    its heads only (fastattn_fwd's count and offsets: ``dist_gate``)."""
    for r, res in enumerate(ranks):
        got = (res["mlstm_launches"], res["mlstm_heads"])
        if got != (want["mlstm_chunkwise"], want["mlstm_heads"]):
            raise AssertionError(
                f"{what}: rank {r} launched mlstm_chunkwise "
                f"{got[0]} times at {got[1]} heads, not "
                f"{want['mlstm_chunkwise']} at {want['mlstm_heads']}")


def _mesh_models_rank(rank: int, mesh_kw: dict, jobs: list) -> list:
    """One rank of phase 12: its mesh once, then each (cfg, run) of
    ``jobs`` through ``_dist_job`` in turn, the last's memory freed
    before the next, each followed by phase 15's decode of that model
    where ``run`` holds a "decode" job (``_decode_job``)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_mesh_for
    mesh = make_mesh_for(ParallelConfig(**mesh_kw),
                         timeout=DIST_INIT_TIMEOUT_S)
    out = []
    for cfg, run in jobs:
        t0 = time.perf_counter()
        res = _dist_job(rank, mesh, cfg, mesh_kw, run)
        res["job_s"] = time.perf_counter() - t0
        out.append(res)
        _free_card()
        if run.get("decode"):
            res["decode"] = _decode_job(mesh, run["decode"])
            _free_card()
    return out


def _free_card() -> None:
    """Collect garbage and return the card's cached blocks."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _mesh_one_device(arch: str, cfg, seq: int, device: str, parallel,
                     meshes: list) -> dict:
    """Phase 12's one-device side of ``arch``: its reference run, its
    gates (xlstm-125m's measured, ``measured_mesh_gate``), the rule
    table's specs and each rank's fingerprints of its initial pieces."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import flatten, is_spec, shard_of
    t1 = time.perf_counter()
    ref = mesh_reference(cfg, seq, device)
    gates = {"loss": DIST_LOSS_RTOL, "grad_norm": DIST_GNORM_RTOL,
             "delta": DIST_DELTA_RTOL, "grad0": MESH_GRAD_RTOL}
    if arch in MESH_MEASURED:
        pert = mesh_reference(cfg, seq, device, perturb=lambda: (
            _perturbed_h(9, "kernel", device)))
        gates = measured_mesh_gate(ref, pert)
        del pert
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    specs = flatten(build_model(cfg, "cpu", parallel).param_specs(
        meshes[0]), is_spec)
    keys = [[] for _ in meshes]
    for t, sp in zip(ref["init"], specs, strict=True):
        t = t.to(device)
        for r, mesh in enumerate(meshes):
            keys[r].append(bits_key(shard_of(t, sp, mesh)))
        del t
    n_params = sum(t.numel() for t in ref["init"])
    layers = (f"{cfg.encoder_layers} + {cfg.num_layers} layers"
              if cfg.is_encoder_decoder else ", ".join(cfg.blocks()))
    log(f"[12] {arch} ({layers}), {n_params:,} parameters, {MESH_BATCH} x "
        f"{seq}: one device losses {[round(x, 5) for x in ref['loss']]}, "
        f"grad norms {[round(x, 5) for x in ref['grad_norm']]}, steps "
        f"{[round(x, 3) for x in ref['step_s']]} s, launches "
        f"{ref['launches']}, peak memory {ref['peak_mem_gb'] or 0:.2f} GB "
        f"({time.perf_counter() - t1:.1f}s, beside the ranks)")
    return dict(cfg=cfg, seq=seq, ref=ref, gates=gates, keys=keys,
                specs=specs, params=n_params)


def phase_mesh(device: str = "cuda", configs: dict = None,
               decode: dict = None) -> dict:
    """Phase 12: xlstm-125m, hymba-1.5b and whisper-small at full width
    (``MESH_MODELS``' cuts), bf16, random weights from seed 0, each
    trained MESH_STEPS AdamW steps on one device (``mesh_reference``) and,
    beside those runs, at (data=2, model=2) by one spawn of four ranks
    that runs the three in turn (``_mesh_models_rank``; each takes a
    one-device snapshot after its steps): the mLSTM and sLSTM heads and
    the Mamba channels over the model axis, whisper's frames and tokens
    split over it.  Each model is held by phase 4b's gates
    (``dist_gate``, ``delta_gate``: the ranks equal, each step within 1%
    / 2% of one device, each leaf's update within 0.15, the initial
    pieces the rule table's slices, the sharded leaves half the whole)
    and each leaf's step-0 gradient within MESH_GRAD_RTOL of one
    device's (``first_step_grads``, ``delta_gate``), xlstm-125m's by
    its measured gate where larger (``measured_mesh_gate``), and each
    rank's launches are exact
    (``mesh_expected``).  ``configs`` (arch -> (cfg, seq); a rehearsal
    on the CPU) replaces MESH_MODELS' cuts.  After each model's steps the
    ranks decode its phase 15 job (``decode``: arch -> job, by default
    ``decode_job_for`` of MESH_DECODE where ``configs`` is not given;
    the (job, ranks) of each returned as "decode").  Correctness only:
    gloo stages every collective through the host."""
    import threading

    import torch
    import torch.multiprocessing  # noqa: F401  (CUDA tensors through queues)
    from repro_torch.config import ParallelConfig, get_model_config
    from repro_torch.launch.mesh import make_mesh, spawn_ranks
    from repro_torch.launch.mesh import train_backend

    t0 = time.perf_counter()
    kind = torch.device(device)
    on_card = kind.type == "cuda"
    parallel = ParallelConfig(**DIST_MESH)
    world = parallel.dp * parallel.model
    meshes = [make_mesh(parallel.mesh_shape(), parallel.mesh_axes(), r)
              for r in range(world)]
    if configs is None:
        configs = {
            arch: (dataclasses.replace(get_model_config(arch), **keep), seq)
            for arch, (keep, seq) in MESH_MODELS.items()}
        decode = {arch: decode_job_for(arch, cfg)
                  for arch, (cfg, _) in configs.items()}
    decode = decode or {}
    # the ranks start and train while the one-device runs go on here: each
    # rank takes a run's snapshot from its queue after its own steps
    feeds = {arch: torch.multiprocessing.get_context("spawn").Queue()
             for arch in configs}
    # the ranks take the models in the reverse order: their first model's
    # first step pays each process's one-time costs (slow where five
    # processes share the card), and xlstm's long sLSTM loops then run
    # once the one-device xlstm runs here are done
    jobs = [(cfg, dict(remat="full", batch=MESH_BATCH, seq=seq,
                       steps=MESH_STEPS, dist_steps=MESH_STEPS, mode="train",
                       ckpt_dir=None, snapshot=None, feed=feeds[arch],
                       leaf_gnorm=False, grad0=True,
                       frames=cfg.is_encoder_decoder,
                       decode=decode.get(arch)))
            for arch, (cfg, seq) in reversed(configs.items())]
    backend, dev_of = train_backend(kind, world)
    log(f"[12] one spawn of {world} ranks over {backend} on "
        f"{[dev_of(r) for r in range(world)]}, the three models in turn, "
        "beside the one-device runs")
    spawned: dict = {}
    models, held = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        def run_ranks():
            try:
                spawned["ranks"] = spawn_ranks(
                    _mesh_models_rank, world, args=(DIST_MESH, jobs),
                    device_of_rank=dev_of, backend=backend,
                    init_method=f"file://{tmp}/pg-mesh",
                    timeout_s=DIST_DEADLINE_S,
                    init_timeout_s=DIST_INIT_TIMEOUT_S)
            except BaseException as e:          # raised below
                spawned["error"] = e
        thread = threading.Thread(target=run_ranks)
        thread.start()
        try:
            for arch, (cfg, seq) in configs.items():
                models[arch] = _mesh_one_device(arch, cfg, seq, device,
                                                parallel, meshes)
                ref = models[arch]["ref"]
                snapshot = ([t.to(kind) for t in ref["snapshot"]],
                            [t.to(kind) for t in ref["grad0"]])
                held.append(snapshot)       # alive while ranks map it
                for _ in range(world):
                    feeds[arch].put(snapshot)
        finally:
            for arch, q in feeds.items():
                if arch not in models:      # a failed run: release the ranks
                    for _ in range(world):
                        q.put(None)
            thread.join()
    if "error" in spawned:
        raise spawned["error"]
    ranks = spawned["ranks"]
    del jobs, held
    if on_card:
        torch.cuda.ipc_collect()      # the ranks' handles on the snapshots
    out = {"backend": backend, "mesh": DIST_MESH,
           "spawn_s": time.perf_counter() - t0, "models": {}}
    decoded = {}
    for i, (arch, mm) in enumerate(reversed(models.items())):
        rr = [r[i] for r in ranks]
        if arch in decode:
            decoded[arch] = (decode[arch], [r.pop("decode") for r in rr])
            log(f"[15] a rank's {arch} job in phase 12's spawn: "
                f"{[round(r['job_s'], 1) for r in decoded[arch][1]]} s")
        cfg, ref, gates = mm["cfg"], mm["ref"], mm["gates"]
        want = mesh_expected(cfg, mm["seq"], parallel.model)
        what = f"[12] {arch} (data=2, model=2)"
        dist_gate(what, rr, ref, mm["keys"], mm["specs"], mm["seq"],
                  parallel.model, steps=MESH_STEPS, checkpoint=False,
                  launches=want["fastattn_fwd"], offsets=want["offsets"],
                  loss_rtol=gates["loss"], gnorm_rtol=gates["grad_norm"])
        mesh_launch_gate(what, rr, want)
        rel = delta_gate(what, ref["paths"], rr, mm["specs"],
                         bound=gates["delta"])
        grel = delta_gate(what, ref["paths"], rr, mm["specs"],
                          bound=gates["grad0"], key="grad0")
        worst, gworst = max(rel, key=rel.get), max(grel, key=grel.get)
        first = rr[0]
        if "measured" in gates:
            m = gates["measured"]
            log(f"{what}: measured gate (one ulp on 1% of every mlstm h, "
                f"one device): each step's loss {m['loss']}, grad norm "
                f"{m['grad_norm']}, the leaf that changed most: update "
                f"{m['delta']}, step-0 gradient {m['grad0']}; bounds a "
                f"step loss {gates['loss']}, grad norm {gates['grad_norm']}"
                f", a leaf update {gates['delta']:.3g}, step-0 gradient "
                f"{gates['grad0']:.3g} (phase 4b's {DIST_LOSS_RTOL} / "
                f"{DIST_GNORM_RTOL} / {DIST_DELTA_RTOL}, MESH_GRAD_RTOL "
                f"{MESH_GRAD_RTOL}, MESH_GRAD_CAP {MESH_GRAD_CAP})")
        for r, res in enumerate(rr):
            per = {k: sum(c[k] for c in res["collectives"]) / MESH_STEPS
                   for k in res["collectives"][0]}
            log(f"{what} rank {r} {res['coords']} on {res['device']} "
                f"({res['backend']}): step wall "
                f"{[round(x, 3) for x in res['step_s']]} s, collectives a "
                f"step {per} ({sum(res['coll_bytes']) / MESH_STEPS / 1e9:.3f}"
                f" GB), peak memory {res['peak_mem_gb'] or 0:.2f} GB, "
                f"fastattn_fwd {res['launches']} at q_offsets "
                f"{res['q_offsets']}, mlstm_chunkwise "
                f"{res['mlstm_launches']} at {res['mlstm_heads']} heads; "
                f"{res['job_s']:.1f}s")
        for j in range(MESH_STEPS):
            log(f"{what} step {j}: loss {first['loss'][j]:.5f} vs one "
                f"device's {ref['loss'][j]:.5f}, grad norm "
                f"{first['grad_norm'][j]:.5f} vs {ref['grad_norm'][j]:.5f}, "
                f"lr {first['lr'][j]:.3e}")
        log(f"{what}: updates against one device's: worst {worst} "
            f"{rel[worst]:.3e} (bound {gates['delta']:.3g})")
        log(f"{what}: step-0 gradients against one device's: worst "
            f"{gworst} {grel[gworst]:.3e} (bound {gates['grad0']:.3g}); by "
            "leaf " + json.dumps({p: round(x, 5) for p, x in grel.items()}))
        out["models"][arch] = {
            "params": mm["params"], "seq": mm["seq"],
            "loss": first["loss"], "grad_norm": first["grad_norm"],
            "lr": first["lr"], "ref_loss": ref["loss"],
            "ref_grad_norm": ref["grad_norm"],
            "ref_step_s": ref["step_s"], "ref_peak_mem_gb":
            ref["peak_mem_gb"], "gates": gates,
            "worst_delta": [worst, rel[worst]],
            "worst_grad0": [gworst, grel[gworst]],
            "launches": [r["launches"] for r in rr],
            "q_offsets": [r["q_offsets"] for r in rr],
            "mlstm_launches": [r["mlstm_launches"] for r in rr],
            "mlstm_heads": [r["mlstm_heads"] for r in rr],
            "step_s": [r["step_s"] for r in rr],
            "job_s": [r["job_s"] for r in rr],
            "collectives": [r["collectives"][-1] for r in rr],
            "coll_bytes": [r["coll_bytes"][-1] for r in rr],
            "peak_mem_gb": [r["peak_mem_gb"] for r in rr]}
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if on_card else "cpu"
    log(f"[12] {out['card']}: all gates passed in {out['seconds']:.1f}s "
        f"(the ranks, beside the one-device runs, {out['spawn_s']:.1f}s; "
        f"{GLOO_NOTE if backend == 'gloo' else 'nccl, one GPU a rank'})")
    log("[12] " + json.dumps(out))
    out["decode"] = decoded
    return out


# ---------------------------------------------------------------------------
# phase 13: the int8 error-feedback all-reduce and GPipe, on gloo ranks
# ---------------------------------------------------------------------------

COMPRESS_LAYERS = 2           # (a): llama2-7b's first 2 layers, full width
COMPRESS_SEQ = 2048           # (a): each rank's own 1 x 2048 batch
COMPRESS_ROUNDS = 3
PIPE_STAGES = 4               # (b): one llama2-7b layer a stage
PIPE_MICRO, PIPE_SEQ = 8, 512  # (b): 8 microbatches of 1 x 512
# (a): a reduced leaf against the same arithmetic in float64, in ulps of
# the leaf's scale: one for each rounding the f32 arithmetic makes --
# up to 3 in the sum of the four ranks' scales (gloo's order), one in
# the product (the int32 sum and the division by 4 are exact)
COMPRESS_ULPS = 4.0
PIPE_WORLD = 4


def _gather_rank0(t, group) -> list:
    """Every rank's ``t`` on rank 0's host, in rank order (None on the
    other ranks); gloo gathers CPU tensors, NCCL CUDA ones."""
    import torch
    import torch.distributed as dist
    src = t.cpu() if dist.get_backend(group) == "gloo" else t
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    parts = [torch.empty_like(src) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(src, parts, dst=0, group=group)
    return [p.cpu() for p in parts] if rank == 0 else None


def _compress_job(rank: int, cfg, seq: int, dev) -> dict:
    """Phase 13 (a) on this rank: the gradient of ``cfg`` on its own
    1 x ``seq`` batch through the train step, then COMPRESS_ROUNDS rounds
    of ``compressed_psum`` over the world with the residuals carried,
    each checked leaf by leaf."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as C
    from repro_torch.training import tree
    from repro_torch.training.compression import (compressed_psum,
                                                  init_residuals,
                                                  quantize_int8)
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    group, world = dist.group.WORLD, dist.get_world_size()
    t0 = time.perf_counter()
    parallel = ParallelConfig(remat="selective")    # as launch/train.py
    model = build_model(cfg, dev, parallel)
    state = init_train_state(model, model.generator(0))
    out = {"paths": [p for p, _ in tree.leaves_with_paths(state.params)]}
    step_fn = make_train_step(model, cfg, parallel, TrainConfig(
        learning_rate=3e-4, warmup_steps=1, total_steps=1))
    batch = to_device(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=world,
        host_count=world, host_index=rank)).next(), dev)
    grads: list = []
    fastattn_fwd.launches = 0
    with first_step_grads(grads):
        state, metrics = step_fn(state, batch)
    synchronize(dev)
    out.update(launches=fastattn_fwd.launches, loss=float(metrics["loss"]),
               numel=sum(g.numel() for g in grads),
               grad_s=time.perf_counter() - t0)
    del state, step_fn, model, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the plain f32 mean (kept on the host), and an f32 all-reduce's bytes
    C.COUNTS.update({k: 0 for k in C.COUNTS})
    t0 = time.perf_counter()
    mean = [(C.all_reduce(g.float(), group) / world).cpu() for g in grads]
    out.update(f32_bytes=C.COUNTS["bytes"], mean_s=time.perf_counter() - t0)
    residuals = init_residuals(grads)
    out["rounds"] = []
    for i in range(COMPRESS_ROUNDS):
        # the float64 check of the last round, which carries the earlier
        # rounds' residuals (every rank's int8 values gathered: 2 GB)
        last = i == COMPRESS_ROUNDS - 1
        C.COUNTS.update({k: 0 for k in C.COUNTS})
        synchronize(dev)
        t0 = time.perf_counter()
        red, new_res = compressed_psum(grads, residuals, group)
        synchronize(dev)
        rnd = {"wall_s": time.perf_counter() - t0,
               "counts": dict(C.COUNTS), "keys": [], "residual_exact": [],
               "mean_err": [], "ulps": []}
        t0 = time.perf_counter()
        for j, g in enumerate(grads):
            # each leaf's old residual and reduction freed once read
            v = g.float() + residuals[j]
            residuals[j] = None
            q, scale = quantize_int8(v)
            # v - q * scale: exact in float64, rounded once to f32
            r = torch.addcmul(v.double(), q.double(), scale.double(),
                              value=-1).float()
            rnd["residual_exact"].append(bool(torch.equal(r, new_res[j])))
            del v, r
            rnd["keys"].append(bits_key(red[j]))
            m = mean[j].to(dev)
            rnd["mean_err"].append(((red[j] - m).abs().max() / m.abs().max(
            ).clamp_min(1e-30)).item())
            del m
            if last:
                qs = _gather_rank0(q, group)
                ss = _gather_rank0(scale.reshape(1), group)
            if last and rank == 0:
                # the same arithmetic in float64 from every rank's values,
                # on the card (the host's cores, which the four ranks
                # share, would take each round's 667 M elements slowly)
                qsum = sum(x.to(dev, torch.int32) for x in qs).double()
                ssum = sum(float(x.double()) for x in ss) / world
                ref = qsum * ssum / world
                top = ref.abs().max().item()
                ulp = float(np.spacing(np.float32(top))) if top else 1.0
                rnd["ulps"].append((red[j].double() - ref).abs().max().item()
                                   / ulp)
                del qsum, ref, qs
            del q
            red[j] = None
        rnd["check_s"] = time.perf_counter() - t0
        residuals = new_res
        out["rounds"].append(rnd)
    return out


def _pipeline_job(rank: int, cfg, stages: list, x_micro) -> dict:
    """Phase 13 (b) on this rank: stage ``rank`` (``stages[rank]``, one
    block of ``cfg``) of the GPipe forward of ``x_micro`` over the
    world."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn.ops import fastattn_fwd
    from repro_torch.models.blocks import apply_block
    from repro_torch.sharding import collectives as C
    from repro_torch.training.pipeline import make_pipeline
    b, s = x_micro.shape[1:3]
    pos = torch.arange(s, device=x_micro.device).expand(b, s)

    def stage_fn(p, h):
        return apply_block(p, h, cfg, "attn", positions=pos)
    C.COUNTS.update({k: 0 for k in C.COUNTS})
    fastattn_fwd.launches = 0
    synchronize(x_micro.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        y = make_pipeline(stage_fn, group=dist.group.WORLD)(
            stages[rank], x_micro)
    synchronize(x_micro.device)
    out = {"wall_s": time.perf_counter() - t0,
           "launches": fastattn_fwd.launches, "counts": dict(C.COUNTS),
           "key": bits_key(y),
           "carry_bytes": x_micro[0].numel() * x_micro.element_size()}
    if rank == 0:
        out["out"] = y.cpu()
    return out


# ---------------------------------------------------------------------------
# phase 14: context-parallel dense decode (the cache's kv_seq -> model)
# ---------------------------------------------------------------------------

CP_LAYERS = 4                 # llama2-7b's first 4 of 32 layers (a cut)
CP_BATCH = 8                  # 8 of decode_32k's 128 rows (a cut)
CP_WIDTH = 32768              # decode_32k's cache width, uncut
CP_MESH = dict(data=2, model=2)
# pos 1000 (model rank 1's slice holds no valid key), then 16381-16386:
# the new row's write crosses from rank 0's slice into rank 1's at 16384
CP_POSITIONS = (1000, 16381, 16382, 16383, 16384, 16385, 16386)
CP_SEED = 14


def cp_job_for(kv_rms, cfg=None, batch: int = CP_BATCH,
               width: int = CP_WIDTH, positions=CP_POSITIONS) -> dict:
    """Phase 14's run: ``cfg`` (llama2-7b's first CP_LAYERS layers), a
    ``batch`` x ``width`` cache filled at phase 3b's per-layer RMS
    ``kv_rms`` ([k, v] a layer), and a decode step at each of
    ``positions`` with tokens from a seeded generator."""
    import numpy as np
    from repro_torch.config import get_model_config
    cfg = cfg or dataclasses.replace(get_model_config("llama2-7b"),
                                     num_layers=CP_LAYERS)
    rng = np.random.default_rng(CP_SEED)
    steps = [(int(pos), rng.integers(0, cfg.vocab_size, size=batch).astype(
        np.int64)) for pos in positions]
    return {"cfg": cfg, "batch": batch, "width": width, "steps": steps,
            "kv_rms": [list(r) for r in kv_rms[:cfg.num_layers]],
            "mesh": dict(CP_MESH)}


def cp_cache_piece(job: dict, layer: int, which: int, row: int,
                   piece: int, device):
    """Rows ``[piece * S / model, (piece + 1) * S / model)`` of batch row
    ``row`` of layer ``layer``'s K (``which`` 0) or V (1) cache: N(0, 1)
    from one CUDA (or CPU) generator seeded for this piece, at the
    layer's RMS, in the model's dtype.  The one-device run and every rank
    draw the same values without holding the whole cache."""
    import torch
    from repro_torch.device import torch_dtype
    cfg = job["cfg"]
    n = job["mesh"]["model"]
    s_l = job["width"] // n
    gen = torch.Generator(device=device)
    gen.manual_seed(CP_SEED * 1_000_003 + ((layer * 2 + which) * job["batch"]
                                           + row) * n + piece)
    x = torch.randn((s_l, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                    device=device)
    return (x * job["kv_rms"][layer][which]).to(torch_dtype(cfg.dtype))


def _cp_fill(job: dict, cache: list, rows, pieces, device) -> None:
    """Fill each layer's (rows x pieces) cache in place with
    ``cp_cache_piece``."""
    s_l = job["width"] // job["mesh"]["model"]
    for layer, kv in enumerate(cache):
        for which, buf in enumerate((kv.k, kv.v)):
            for i, row in enumerate(rows):
                for j, piece in enumerate(pieces):
                    buf[i, j * s_l:(j + 1) * s_l].copy_(cp_cache_piece(
                        job, layer, which, row, piece, device))


def _cp_counting():
    """Wrap ``core.distributed_decode``'s local attention: count each
    call it makes asked for the log-sum-exp (``flash_decode``, or the
    plain ``decode_reference`` where the tensors are on the CPU), and
    each plain call (``decode_reference``, ``attend_with_positions``,
    the wrapper's own plain path) on CUDA tensors.  Returns (counts,
    restore)."""
    from repro_torch.core import distributed_decode as dd
    from repro_torch.kernels.flash_decode import ops
    counts = {"lse_calls": 0, "plain_cuda": 0}
    saved = {(m, n): getattr(m, n) for m, n in (
        (dd, "flash_decode"), (dd, "decode_reference"),
        (dd, "attend_with_positions"), (ops, "decode_reference"))}

    def wrap(mod, name):
        fn = saved[(mod, name)]

        def counted(q, *a, **kw):
            if mod is dd:
                counts["lse_calls"] += bool(kw.get("return_lse"))
            if name != "flash_decode" and q.is_cuda:
                counts["plain_cuda"] += 1
            return fn(q, *a, **kw)
        setattr(mod, name, counted)
    for mod, name in saved:
        wrap(mod, name)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return counts, restore


def _cp_job(rank: int, job: dict, dev) -> dict:
    """Phase 14 on this rank: its mesh coordinate's pieces of a seeded
    draw of ``job["cfg"]`` and its slice of the cache (B / data rows x
    S / model positions, ``LM.init_cache`` under the mesh), then every
    step's ``LM.decode_step`` on the whole batch of tokens: its rows'
    logits, the K/V rows it wrote, its launches and collectives, and the
    kernel's device time at its slice."""
    import torch
    from repro_torch.config import ParallelConfig
    from repro_torch.core import tiled_allreduce as tar
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (axis_rules, flatten, is_spec,
                                            shard_of)
    from repro_torch.training import tree
    cfg, b, width = job["cfg"], job["batch"], job["width"]
    parallel = ParallelConfig(**job["mesh"])
    mesh = make_mesh_for(parallel, timeout=DIST_INIT_TIMEOUT_S)
    d, m = mesh.coords["data"], mesh.coords["model"]
    n_data, n_model = job["mesh"]["data"], job["mesh"]["model"]
    b_l, s_l = b // n_data, width // n_model
    model = build_model(cfg, dev, parallel)
    whole = model.init(model.generator(0))
    with axis_rules(mesh=mesh), torch.no_grad():
        pieces = tree.unflatten(whole, [
            shard_of(t, sp, mesh) for t, sp in zip(
                tree.leaves(whole), flatten(model.param_specs(mesh),
                                            is_spec), strict=True)])
        del whole
        cache = model.init_cache(b, width)
        _cp_fill(job, cache, range(d * b_l, (d + 1) * b_l), [m], dev)
        shapes = [tuple(kv.k.shape) for kv in cache]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        counts, restore = _cp_counting()
        flash_decode.launches = 0
        C.COUNTS.update({k: 0 for k in C.COUNTS})
        tar.COUNTS.update({k: 0 for k in tar.COUNTS})
        logits, walls = [], []
        try:
            for pos, tok in job["steps"]:
                synchronize(dev)
                t0 = time.perf_counter()
                lg, cache = model.decode_step(
                    pieces, torch.from_numpy(tok).to(dev), cache, pos)
                synchronize(dev)
                walls.append(time.perf_counter() - t0)
                logits.append(lg.float().cpu().numpy())
        finally:
            restore()
        launches = flash_decode.launches
        out = {"coords": mesh.coords, "shapes": shapes, "logits": logits,
               "wall_s": walls, "launches": launches, **counts,
               "merges": dict(tar.COUNTS), "gathers": dict(C.COUNTS),
               "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else 0.0)}
        # the K/V rows this rank wrote: the steps' positions in its slice
        # (numpy: a rank's CPU tensors would reach the parent by a file
        # descriptor that dies with the rank)
        owned = [pos for pos, _ in job["steps"] if pos // s_l == m]
        out["written"] = {
            pos: [tuple(t[:, pos - m * s_l].float().cpu().numpy()
                        for t in (kv.k, kv.v)) for kv in cache]
            for pos in owned}
        if dev.type == "cuda":
            # the kernel alone at this rank's slice and the last step's
            # kv_len, with the log-sum-exp (not counted above)
            kv_len = torch.full((b_l,), job["steps"][-1][0] + 1,
                                dtype=torch.int32, device=dev)
            q = torch.randn((b_l, cfg.num_heads, cfg.head_dim), device=dev,
                            dtype=cache[0].k.dtype)
            out["kernel_device_ms"] = device_ms(lambda: flash_decode(
                q, cache[0].k, cache[0].v, kv_len, layout="bshd",
                kv_start=m * s_l, return_lse=True))
    return out


def cp_reference(job: dict, device: str = "cuda") -> dict:
    """Phase 14's one-device run: ``job["cfg"]`` from the same seeded
    draw, the whole cache (every row and slice), every step's
    ``decode_step`` through ``flash_decode`` on the whole cache: the
    logits, the K/V rows written at the steps' positions, the launches
    and the wall; the cache freed after."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.models import build_model
    kind = torch.device(device)
    cfg, b = job["cfg"], job["batch"]
    model = build_model(cfg, kind)
    params = model.init(model.generator(0))
    cache = model.init_cache(b, job["width"])
    _cp_fill(job, cache, range(b), range(job["mesh"]["model"]), kind)
    cache_gb = sum(t.numel() * t.element_size()
                   for kv in cache for t in kv) / 1e9
    flash_decode.launches = 0
    logits = []
    synchronize(kind)
    t0 = time.perf_counter()
    with torch.no_grad():
        for pos, tok in job["steps"]:
            lg, cache = model.decode_step(
                params, torch.from_numpy(tok).to(kind), cache, pos)
            logits.append(lg.float().cpu())
    synchronize(kind)
    wall = time.perf_counter() - t0
    written = {pos: [(kv.k[:, pos].float().cpu(), kv.v[:, pos].float().cpu())
                     for kv in cache] for pos, _ in job["steps"]}
    out = {"logits": logits, "written": written, "wall_s": wall,
           "launches": flash_decode.launches, "cache_gb": cache_gb}
    del cache, params, model
    gc.collect()
    if kind.type == "cuda":
        torch.cuda.empty_cache()
    return out


def bf16_row_gate(what, got, ref) -> float:
    """Each row of ``got`` against ``ref`` (leading dim = rows) in units
    of the bf16 bound: TOL["bfloat16"] plus REL_TOL["bfloat16"] of the
    row's largest |ref|.  Returns the largest such ratio; a ratio above
    1 fails."""
    import torch
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - ref).abs().flatten(1).amax(1)
    bound = TOL["bfloat16"] + REL_TOL["bfloat16"] * \
        ref.abs().flatten(1).amax(1)
    worst = (diff / bound).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{what}: a row differs by {worst:.3f} of "
                             "its bf16 bound")
    return worst


def cp_gate(what, ranks: list, ref: dict, job: dict, on_card: bool) -> dict:
    """Hold phase 14's ranks to the one-device run: each rank's logits
    within LOGIT_TOL of its rows' scale with greedy tokens equal where
    the top-1 margin exceeds it (``_compare_logits``), the two model
    ranks of a data group bit for bit, each K/V row a rank wrote, in
    every layer, within the bf16 bound of the one-device cache's (the
    slices' float32 partials merge unrounded, so a rank's attention
    output is rounded to bf16 once, as the one device's is); its slice
    the rule table's shape, ``flash_decode`` exactly layers x steps launches (on the card;
    0 on the CPU's plain path), every one asked for the log-sum-exp, and
    no plain attention on CUDA tensors."""
    import numpy as np
    import torch
    cfg = job["cfg"]
    n_layers, n_steps = cfg.num_layers, len(job["steps"])
    b_l = job["batch"] // job["mesh"]["data"]
    s_l = job["width"] // job["mesh"]["model"]
    want_shape = (b_l, s_l, cfg.num_kv_heads, cfg.head_dim)
    by_coords = {(r["coords"]["data"], r["coords"]["model"]): r
                 for r in ranks}
    for r, res in enumerate(ranks):
        d, m = res["coords"]["data"], res["coords"]["model"]
        tag = f"{what} rank {r} (data {d}, model {m})"
        if res["shapes"] != [want_shape] * n_layers:
            raise AssertionError(f"{tag}: cache slices {res['shapes']}, "
                                 f"the rule table's {want_shape}")
        want = n_layers * n_steps if on_card else 0
        if res["launches"] != want or res["lse_calls"] != n_layers * n_steps:
            raise AssertionError(
                f"{tag}: flash_decode launched {res['launches']} times "
                f"({res['lse_calls']} with the log-sum-exp), want {want} "
                f"({n_layers * n_steps})")
        if res["plain_cuda"]:
            raise AssertionError(f"{tag}: {res['plain_cuda']} plain "
                                 "attention calls on CUDA tensors")
        rows = slice(d * b_l, (d + 1) * b_l)
        for (pos, _), got, lg in zip(job["steps"], res["logits"],
                                     ref["logits"], strict=True):
            _compare_logits(f"{tag} pos {pos}", torch.from_numpy(got),
                            lg[rows])
        other = by_coords[(d, 1 - m)]
        for a, b_ in zip(res["logits"], other["logits"], strict=True):
            if not np.array_equal(a, b_):
                raise AssertionError(f"{tag}: logits differ from its "
                                     "model group's other rank")
        want_pos = [pos for pos, _ in job["steps"] if pos // s_l == m]
        if sorted(res["written"]) != sorted(want_pos):
            raise AssertionError(f"{tag}: wrote positions "
                                 f"{sorted(res['written'])}, owns {want_pos}")
        worst = [0.0] * n_layers
        for pos, layers in res["written"].items():
            for layer, (k, v) in enumerate(layers):
                rk, rv = ref["written"][pos][layer]
                for name, got, exp in (("k", k, rk[rows]), ("v", v, rv[rows])):
                    worst[layer] = max(worst[layer], bf16_row_gate(
                        f"{tag} layer {layer} {name} rows at {pos}",
                        torch.from_numpy(got).reshape(b_l, -1),
                        exp.reshape(b_l, -1)))
        res["written_worst"] = worst
        log(f"{tag}: the K/V rows it wrote at {sorted(res['written'])}, "
            f"each layer's worst against its bf16 bound: "
            f"{[round(w, 3) for w in worst]}")
    steps = n_steps
    summary = {
        "launches": [r["launches"] for r in ranks],
        "lse_calls": [r["lse_calls"] for r in ranks],
        "wall_s": [r["wall_s"] for r in ranks],
        "merges_a_step": [r["merges"]["all_reduce"] / steps for r in ranks],
        "merge_bytes_a_step": [r["merges"]["bytes"] / steps for r in ranks],
        "gathers_a_step": [r["gathers"]["all_gather"] / steps
                           for r in ranks],
        "gather_bytes_a_step": [r["gathers"]["bytes"] / steps
                                for r in ranks],
        "peak_gb": [r["peak_gb"] for r in ranks],
        "kernel_device_ms": [r.get("kernel_device_ms") for r in ranks],
        "written_worst": [r["written_worst"] for r in ranks],
        "ref_wall_s": ref["wall_s"], "ref_launches": ref["launches"],
        "ref_cache_gb": ref["cache_gb"]}
    log(f"{what}: every gate passed; per rank: step wall "
        f"{[[round(w, 3) for w in x] for x in summary['wall_s']]} s, "
        f"merges a step {summary['merges_a_step']} "
        f"({summary['merge_bytes_a_step']} B), weight gathers a step "
        f"{summary['gathers_a_step']} "
        f"({[round(x / 1e6, 1) for x in summary['gather_bytes_a_step']]} "
        f"MB), peak {[round(x, 2) for x in summary['peak_gb']]} GB, "
        f"flash_decode {summary['launches']} launches "
        f"(device ms at the rank's slice: {summary['kernel_device_ms']}); "
        f"one device: {ref['launches']} launches, {ref['wall_s']:.2f} s, "
        f"cache {ref['cache_gb']:.2f} GB ({GLOO_NOTE})")
    return summary


def _cp_rank(rank: int, job: dict) -> dict:
    """One rank of phase 14 spawned alone (``phase_cp_decode``)."""
    import torch
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)        # a rehearsal: ranks share the cores
    return _cp_job(rank, job, dev)


def phase_cp_decode(job: dict, ranks: list = None,
                    device: str = "cuda") -> dict:
    """Phase 14: context-parallel decode of llama2-7b (``cp_job_for``)
    on (data=2, model=2), held by ``cp_gate`` to the one-device run
    (``cp_reference``, run after the ranks so that the two never hold
    the card's memory at once).  ``ranks``: the ranks' results of
    phase 13's spawn (``phase_compress_pipeline(cp_job=job)``); None
    spawns them here (the phase alone, or a CPU rehearsal at a reduced
    ``job``).  Correctness only: gloo stages every collective through
    the host."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks, train_backend
    t0 = time.perf_counter()
    kind = torch.device(device)
    on_card = kind.type == "cuda"
    cfg = job["cfg"]
    log(f"[14] {cfg.name}: its first {cfg.num_layers} of 32 layers "
        f"(a cut), B={job['batch']} of decode_32k's 128 rows (a cut), a "
        f"cache of {job['width']} positions (decode_32k's width) at "
        f"(data={job['mesh']['data']}, model={job['mesh']['model']}), "
        f"steps at {[p for p, _ in job['steps']]}")
    if ranks is None:
        world = job["mesh"]["data"] * job["mesh"]["model"]
        backend, dev_of = train_backend(kind, world)
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_ranks(
                _cp_rank, world, args=(job,), device_of_rank=dev_of,
                backend=backend, init_method=f"file://{tmp}/pg-14",
                timeout_s=DIST_DEADLINE_S,
                init_timeout_s=DIST_INIT_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ref = cp_reference(job, device)
    if on_card and ref["launches"] != cfg.num_layers * len(job["steps"]):
        raise AssertionError(f"[14] one device: {ref['launches']} "
                             "flash_decode launches")
    out = cp_gate("[14] context-parallel decode", ranks, ref, job, on_card)
    out["seconds"] = time.perf_counter() - t0
    out["ranks_s"] = ranks_s
    out["card"] = _card() if on_card else "cpu"
    log(f"[14] {out['card']}: all gates passed in {out['seconds']:.1f}s")
    log("[14] " + json.dumps(out))
    return out


def _compress_pipeline_rank(rank: int, cfg_a, cfg_b, stages: list,
                            x_micro, seq: int, cp_job: dict = None) -> dict:
    """One rank of phase 13: (a) then, its memory freed, (b); then with
    ``cp_job`` phase 14's rank (``_cp_job``) in the same process."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)        # a rehearsal: ranks share the cores
    out = {"rank": rank, "device": str(dev),
           "backend": str(dist.get_backend())}
    t0 = time.perf_counter()
    out["compress"] = _compress_job(rank, cfg_a, seq, dev)
    out["compress"]["job_s"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["pipeline"] = _pipeline_job(rank, cfg_b, stages, x_micro)
    if cp_job is not None:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["cp"] = _cp_job(rank, cp_job, dev)
        out["cp"]["job_s"] = time.perf_counter() - t0
    return out


def compress_gate(what, ranks: list, launches: int) -> dict:
    """Phase 13 (a)'s gates: every rank's reduced tree the same bits each
    round, every residual exact, the payload an f32 all-reduce's bytes,
    rank 0's float64 check of the last round within COMPRESS_ULPS, the
    train step's launches.  Returns the readings."""
    first = ranks[0]["compress"]
    n_leaves = len(first["paths"])
    out = {"rounds": [], "f32_bytes": first["f32_bytes"],
           "numel": first["numel"], "launches": []}
    for r, res in enumerate(ranks):
        c = res["compress"]
        out["launches"].append(c["launches"])
        if c["launches"] != launches:
            raise AssertionError(f"{what}: rank {r}'s train step launched "
                                 f"fastattn_fwd {c['launches']} times, "
                                 f"expected {launches}")
    for i, rnd in enumerate(first["rounds"]):
        for r, res in enumerate(ranks):
            other = res["compress"]["rounds"][i]
            if other["keys"] != rnd["keys"]:
                bad = [p for p, a, b in zip(first["paths"], rnd["keys"],
                                            other["keys"]) if a != b]
                raise AssertionError(f"{what}: round {i}: rank {r}'s "
                                     f"reduction differs from rank 0's in "
                                     f"{bad}")
            if not all(other["residual_exact"]):
                bad = [p for p, ok in zip(first["paths"],
                                          other["residual_exact"]) if not ok]
                raise AssertionError(f"{what}: round {i}: rank {r}'s new "
                                     f"residuals are not v - q * scale in "
                                     f"{bad}")
            counts = other["counts"]
            payload = counts["bytes"] - 4 * n_leaves
            if counts["all_reduce"] != 2 * n_leaves or \
                    payload != first["f32_bytes"]:
                raise AssertionError(f"{what}: round {i}: rank {r}'s "
                                     f"collectives {counts}, an f32 "
                                     f"all-reduce {first['f32_bytes']} B")
        read = {"bytes": rnd["counts"]["bytes"],
                "wall_s": [res["compress"]["rounds"][i]["wall_s"]
                           for res in ranks],
                "mean_err": dict(zip(first["paths"], rnd["mean_err"]))}
        f64 = ""
        if i == len(first["rounds"]) - 1:
            if len(rnd["ulps"]) != n_leaves:
                raise AssertionError(f"{what}: the last round's float64 "
                                     f"check read {len(rnd['ulps'])} of "
                                     f"{n_leaves} leaves")
            worst = max(range(n_leaves), key=lambda j: rnd["ulps"][j])
            if rnd["ulps"][worst] > COMPRESS_ULPS:
                raise AssertionError(
                    f"{what}: round {i}: {first['paths'][worst]} is "
                    f"{rnd['ulps'][worst]:.2f} ulps of its scale from the "
                    f"float64 arithmetic (bound {COMPRESS_ULPS})")
            read["worst_ulps"] = [first["paths"][worst], rnd["ulps"][worst]]
            f64 = (f"; worst leaf {first['paths'][worst]} "
                   f"{rnd['ulps'][worst]:.3f} ulps of its scale from float64 "
                   f"(bound {COMPRESS_ULPS})")
        out["rounds"].append(read)
        log(f"{what}: round {i}: every rank's reduction the same bits, "
            f"residuals exact{f64}; {rnd['counts']['bytes'] / 1e9:.4f} "
            f"GB all-reduced a rank ({first['f32_bytes'] / 1e9:.4f} GB as "
            f"f32: int32 payload, +4 B of scale a leaf); wall "
            f"{[round(x, 3) for x in read['wall_s']]} s")
        log(f"{what}: round {i}: each leaf's max error against the plain "
            "f32 mean, of its scale: " + json.dumps(
                {p: round(e, 5) for p, e in zip(first["paths"],
                                                rnd["mean_err"])}))
    return out


def pipeline_gate(what, ranks: list, ref, launches: int) -> dict:
    """Phase 13 (b)'s gates: every rank's output the same bits and held
    to ``ref`` (the stages applied in sequence) within the bf16 bound,
    the launches and ring sends of every tick, the bubble 3/11.  Returns
    the readings."""
    from repro_torch.training.pipeline import bubble_fraction
    n = len(ranks)
    ticks = PIPE_MICRO + n - 1
    out = ranks[0]["pipeline"]["out"]
    for r, res in enumerate(ranks):
        p = res["pipeline"]
        if p["key"] != ranks[0]["pipeline"]["key"]:
            raise AssertionError(f"{what}: rank {r}'s output differs from "
                                 "rank 0's")
        c = p["counts"]
        if p["launches"] != launches or c["ppermute"] != ticks or \
                c["all_reduce"] != 1 or c["bytes"] != \
                ticks * p["carry_bytes"] + out.numel() * out.element_size():
            raise AssertionError(
                f"{what}: rank {r}: fastattn_fwd {p['launches']} launches "
                f"(expected {launches}), collectives {c} (expected "
                f"{ticks} ring sends of {p['carry_bytes']} B and one "
                "all-reduce of the output)")
    flat = out.shape[-1]
    err, rel = held_to_plain("13b", "GPipe's output against the stages in "
                             "sequence", out.reshape(-1, flat),
                             ref.reshape(-1, flat).to(out.device),
                             "bfloat16", unbounded=True)
    bubble = bubble_fraction(n, PIPE_MICRO)
    if bubble != 3 / 11:
        raise AssertionError(f"{what}: bubble {bubble}, not 3/11")
    res = {"ticks": ticks, "bubble": bubble, "max_abs_err": err,
           "max_rel_err": rel,
           "launches": [r["pipeline"]["launches"] for r in ranks],
           "wall_s": [r["pipeline"]["wall_s"] for r in ranks],
           "p2p_bytes": [r["pipeline"]["counts"]["ppermute"]
                         * r["pipeline"]["carry_bytes"] for r in ranks]}
    for r, rr in enumerate(ranks):
        log(f"{what}: rank {r} on {rr['device']} ({rr['backend']}): wall "
            f"{res['wall_s'][r]:.3f} s, fastattn_fwd {res['launches'][r]} "
            f"launches, {ticks} ring sends, {res['p2p_bytes'][r] / 1e6:.2f} "
            "MB point to point")
    log(f"{what}: bubble {bubble:.6f} (3/11 at 4 stages, 8 microbatches)")
    return res


def phase_compress_pipeline(device: str = "cuda", cfg_a=None, cfg_b=None,
                            seq: int = COMPRESS_SEQ,
                            pipe_seq: int = PIPE_SEQ,
                            cp_job: dict = None) -> dict:
    """Phase 13: (a) the int8 error-feedback all-reduce of llama2-7b's
    first COMPRESS_LAYERS layers' gradients (``cfg_a``) and (b) GPipe over
    PIPE_STAGES of its layers (``cfg_b``), one spawn of PIPE_WORLD ranks
    (gloo sharing the card; NCCL with a GPU a rank where there are as
    many), held by ``compress_gate`` and ``pipeline_gate``.  ``cfg_a``,
    ``cfg_b``, ``seq``, ``pipe_seq``: a rehearsal on the CPU at a reduced
    size.  With ``cp_job`` the same ranks then run phase 14's
    (``_cp_job``; its results in ``cp_ranks``, for ``phase_cp_decode``),
    which pays no second process start and rendezvous.  Correctness
    only: gloo stages every collective through the host."""
    import numpy as np
    import torch
    from repro_torch.config import get_model_config
    from repro_torch.launch.mesh import spawn_ranks, train_backend
    from repro_torch.layers.embedding import embed_tokens
    from repro_torch.models import build_model
    from repro_torch.models.blocks import apply_block

    t0 = time.perf_counter()
    kind = torch.device(device)
    on_card = kind.type == "cuda"
    llama = get_model_config("llama2-7b")
    cfg_a = cfg_a or dataclasses.replace(llama, num_layers=COMPRESS_LAYERS)
    cfg_b = cfg_b or dataclasses.replace(llama, num_layers=PIPE_STAGES)
    world = PIPE_WORLD
    # (b)'s stages and inputs: a seeded draw's layers 0-3, the embedded
    # tokens of 8 microbatches, and the layers applied in sequence here
    model = build_model(cfg_b, kind)
    params = model.init(model.generator(0))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg_b.vocab_size, size=(PIPE_MICRO, 1, pipe_seq)).astype(
        np.int32)).to(kind)
    pos = torch.arange(pipe_seq, device=kind).expand(1, pipe_seq)
    with torch.no_grad():
        x = embed_tokens(params["embedding"], toks, cfg_b)
        ref = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for layer in params["layers"]:
                h = apply_block(layer, h, cfg_b, "attn", positions=pos)
            ref.append(h)
        ref = torch.stack(ref)
    stages = params["layers"]
    del params, model
    backend, dev_of = train_backend(kind, world)
    log(f"[13] one spawn of {world} ranks over {backend} on "
        f"{[dev_of(r) for r in range(world)]}: (a) {cfg_a.name}'s first "
        f"{cfg_a.num_layers} layers' gradients, {COMPRESS_ROUNDS} rounds of "
        f"compressed_psum; (b) {cfg_b.num_layers} stages of one layer, "
        f"{PIPE_MICRO} microbatches of 1 x {pipe_seq}")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(
            _compress_pipeline_rank, world,
            args=(cfg_a, cfg_b, stages, x, seq, cp_job),
            device_of_rank=dev_of,
            backend=backend, init_method=f"file://{tmp}/pg-13",
            timeout_s=DIST_DEADLINE_S, init_timeout_s=DIST_INIT_TIMEOUT_S)
    del stages, x
    if on_card:
        torch.cuda.ipc_collect()      # the ranks' handles on (b)'s tensors
    spawn_s = time.perf_counter() - t0
    remat = 2                         # remat "selective" runs as "full"
    out = {"backend": backend, "spawn_s": spawn_s,
           "compress": compress_gate(
               "[13a] compressed_psum", ranks,
               cfg_a.num_layers * remat if on_card else 0),
           "pipeline": pipeline_gate(
               "[13b] GPipe", ranks, ref,
               PIPE_MICRO + world - 1 if on_card else 0)}
    for k in ("job_s", "grad_s", "mean_s"):
        out["compress"][k] = [r["compress"][k] for r in ranks]
    out["compress"]["check_s"] = [[rnd["check_s"] for rnd in
                                   r["compress"]["rounds"]] for r in ranks]
    log(f"[13a] a rank's time: {out['compress']['job_s'][0]:.1f}s, of "
        f"which the gradient {out['compress']['grad_s'][0]:.1f}s, the f32 "
        f"all-reduce {out['compress']['mean_s'][0]:.1f}s, the checks "
        f"{[round(x, 1) for x in out['compress']['check_s'][0]]} s a round")
    if cp_job is not None:
        out["cp_ranks"] = [r["cp"] for r in ranks]
        log(f"[14] a rank's job in phase 13's spawn: "
            f"{[round(r['cp']['job_s'], 1) for r in ranks]} s")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if on_card else "cpu"
    log(f"[13] {out['card']}: all gates passed in {out['seconds']:.1f}s "
        f"({GLOO_NOTE if backend == 'gloo' else 'nccl, one GPU a rank'})")
    log("[13] " + json.dumps({k: v for k, v in out.items()
                              if k != "cp_ranks"}))
    return out


# ---------------------------------------------------------------------------
# phase 15: dense decode on a mesh for every block kind, on gloo ranks
# ---------------------------------------------------------------------------

MESH_DECODE_BATCH = 8
# arch -> (the cache width, the decode steps' positions), at phase 12's
# cuts (qwen3-moe: phase 8 (h)'s 2 layers).  hymba's steps cross the
# slice boundary at 4096 and at 5200 / 5201 hymba_local's window of 1024
# leaves slice 0 no valid key; qwen3-moe's and whisper's cross theirs
# (2048, 224); xlstm-125m holds no KV cache (the width is unused)
MESH_DECODE = {"xlstm-125m": (16, (0, 1, 2, 3)),
               "hymba-1.5b": (8192, (4094, 4095, 4096, 4097, 5200, 5201)),
               "whisper-small": (448, (222, 223, 224, 225)),
               "qwen3-moe-30b-a3b": (4096, (2046, 2047, 2048, 2049))}
DECODE_SEED = 15
DECODE_FLIP = 0.01            # the share of the embedded tokens moved 1 ulp


def decode_job_for(arch: str, cfg, batch: int = MESH_DECODE_BATCH,
                   width: int = None, positions=None) -> dict:
    """Phase 15's run of ``arch`` (``cfg``: its cut): a ``batch`` x
    ``width`` cache (MESH_DECODE's by default) filled by ``decode_fill``,
    and a decode step at each of ``positions`` with tokens from a seeded
    generator, at DIST_MESH."""
    import numpy as np
    w, p = MESH_DECODE[arch]
    rng = np.random.default_rng(DECODE_SEED)
    steps = [(int(pos), rng.integers(0, cfg.vocab_size, size=batch).astype(
        np.int64)) for pos in (positions or p)]
    return {"arch": arch, "cfg": cfg, "batch": batch, "width": width or w,
            "steps": steps, "mesh": dict(DIST_MESH)}


def decode_fill(job: dict, model, cache, coords: dict = None) -> None:
    """Fill ``cache`` in place -- the whole one-device cache, or with
    ``coords`` a rank's slice (of an encoder-decoder: the self caches) --
    with N(0, 1) in each leaf's dtype: each batch row's piece of each
    leaf along the dim the model axis splits (all of it where it splits
    none) from one generator seeded for (leaf, row, piece), so that the
    one-device run and each rank draw the same values."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import (entry_axes, flatten, is_spec,
                                            param_sharding_tree)
    from repro_torch.training import tree
    n_data, n = job["mesh"]["data"], job["mesh"]["model"]
    b = job["batch"]
    specs = param_sharding_tree(model.cache_logical(b, job["width"]),
                                make_mesh((n_data, n), ("data", "model")))
    if isinstance(cache, dict):
        cache, specs = cache["self"], specs["self"]
    b_l = b // n_data
    rows = range(b) if coords is None else range(
        coords["data"] * b_l, (coords["data"] + 1) * b_l)
    for i, (t, sp) in enumerate(zip(tree.leaves(cache),
                                    flatten(specs, is_spec), strict=True)):
        if not t.numel():                 # the mLSTM's conv placeholder
            continue
        split = next((d for d, e in enumerate(sp)
                      if "model" in entry_axes(e)), None)
        count = 1 if split is None else n
        pieces = ([0] if split is None else
                  range(n) if coords is None else [coords["model"]])
        for r, row in enumerate(rows):
            for j, piece in enumerate(pieces):
                dst = t[r]
                if split is not None:
                    size = t.shape[split] // len(pieces)
                    dst = dst.narrow(split - 1, j * size, size)
                gen = torch.Generator(device=t.device)
                gen.manual_seed(DECODE_SEED * 1_000_003
                                + (i * b + row) * count + piece)
                dst.copy_(torch.randn(dst.shape, generator=gen,
                                      device=t.device))


def _decode_cache(job: dict, model, params, dev, mesh=None):
    """Phase 15's cache on ``dev``: one device's whole, or under ``mesh``
    (the rule context entered) the rank's slice, filled by
    ``decode_fill``; an encoder-decoder's cross K/V projected from
    ``encode`` of N(0, 1) frames from a generator seeded with DECODE_SEED
    (under the mesh: of the rank's rows and frames)."""
    import torch
    from repro_torch.sharding.rules import param_sharding_tree, shard_of
    cfg, b = model.cfg, job["batch"]
    kw = {}
    if cfg.is_encoder_decoder:
        gen = torch.Generator(device=dev)
        gen.manual_seed(DECODE_SEED)
        frames = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev)
        if mesh is not None:
            frames = shard_of(frames, param_sharding_tree(
                (("batch", "seq", None), tuple(frames.shape)), mesh), mesh)
        kw = dict(enc_out=model.encode(params, frames), params=params)
    cache = model.init_cache(b, job["width"], **kw)
    decode_fill(job, model, cache, None if mesh is None else mesh.coords)
    return cache


def decode_parts(cache) -> tuple:
    """(each KV cache as (layer, KVCache), each recurrent state leaf as
    (layer, name, tensor)) of a dense decode cache (an encoder-decoder's
    self caches: no states)."""
    from repro_torch.layers.attention import KVCache
    kvs, states = [], []
    for li, c in enumerate(cache["self"] if isinstance(cache, dict)
                           else cache):
        if isinstance(c, dict):
            kvs.append((li, c["kv"]))
            c = c["mamba"]
        if isinstance(c, KVCache):
            kvs.append((li, c))
            continue
        states += [(li, f"{type(c).__name__}.{f}", t)
                   for f, t in zip(c._fields, c) if t.numel()]
    return kvs, states


def _decode_counts():
    """Zero the launch and collective counters phase 15 reads: returns
    (the flash_decode LSE / plain-on-CUDA counts, restore)."""
    from repro_torch.core import tiled_allreduce as tar
    from repro_torch.kernels.fastattn import ops as fops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.sharding import collectives as C
    flash_decode.launches = fops.fastattn_fwd.launches = 0
    C.COUNTS.update({k: 0 for k in C.COUNTS})
    tar.COUNTS.update({k: 0 for k in tar.COUNTS})
    return _cp_counting()


def _last_moe_blocks(cfg, into: list):
    """Within the block, the input and output of the last MoE block of
    every decode step, (B, D) each on its device, land in ``into`` (a
    null context for a model with no MoE block)."""
    import itertools
    from repro_torch.models import blocks
    n_moe = cfg.blocks().count("moe")
    if not n_moe:
        return contextlib.nullcontext()
    calls = itertools.count()

    def wrap(ffn):
        def run(params, h2, c, decode=False):
            out = ffn(params, h2, c, decode)
            if next(calls) % n_moe == n_moe - 1:
                into.append((h2[:, 0].detach().clone(),
                             out[:, 0].detach().clone()))
            return out
        return run
    return _wrapped(blocks, "_moe_ffn", wrap)


def _decode_job(mesh, job: dict) -> dict:
    """Phase 15 on this rank, in phase 12's or phase 8 (h)'s spawn after
    its training job: its pieces of a seeded draw of ``job["cfg"]``, its
    slice of every cache leaf (``init_cache`` under the mesh), then every
    step's ``decode_step`` on the whole batch of tokens: its rows'
    logits, the K/V rows it wrote, its final state slices, the input and
    output of its last MoE block each step (``_last_moe_blocks``), its
    launches, collectives, walls and peak memory."""
    import torch
    from repro_torch.config import ParallelConfig
    from repro_torch.core import tiled_allreduce as tar
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn import ops as fops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.models import build_model
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (axis_rules, flatten, is_spec,
                                            shard_of)
    from repro_torch.training import tree
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    cfg = job["cfg"]
    model = build_model(cfg, dev, ParallelConfig(**job["mesh"]))
    whole = model.init(model.generator(0))
    m = mesh.coords["model"]
    with axis_rules(mesh=mesh), torch.no_grad():
        pieces = tree.unflatten(whole, [
            shard_of(t, sp, mesh) for t, sp in zip(
                tree.leaves(whole), flatten(model.param_specs(mesh),
                                            is_spec), strict=True)])
        del whole
        cache = _decode_cache(job, model, pieces, dev, mesh)
        shapes = [tuple(t.shape) for t in tree.leaves(cache)]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        counts, restore = _decode_counts()
        logits, walls, moe = [], [], []
        try:
            with _last_moe_blocks(cfg, moe):
                for pos, tok in job["steps"]:
                    synchronize(dev)
                    t1 = time.perf_counter()
                    lg, cache = model.decode_step(
                        pieces, torch.from_numpy(tok).to(dev), cache, pos)
                    synchronize(dev)
                    walls.append(time.perf_counter() - t1)
                    logits.append(lg.float().cpu().numpy())
        finally:
            restore()
        kvs, states = decode_parts(cache)
        s_l = kvs[0][1].k.shape[1] if kvs else 0
        # numpy: a rank's CPU tensors would reach the parent by a file
        # descriptor that dies with the rank
        out = {"coords": mesh.coords, "shapes": shapes, "logits": logits,
               "wall_s": walls, "launches": flash_decode.launches,
               "fastattn_launches": fops.fastattn_fwd.launches, **counts,
               "merges": dict(tar.COUNTS), "collectives": dict(C.COUNTS),
               "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else 0.0),
               "written": {pos: [tuple(t[:, pos - m * s_l].float().cpu()
                                       .numpy() for t in kv)
                                 for _, kv in kvs]
                           for pos, _ in job["steps"]
                           if kvs and pos // s_l == m},
               "states": [t.float().cpu().numpy() for _, _, t in states],
               "moe": [tuple(t.float().cpu().numpy() for t in pair)
                       for pair in moe]}
    out["job_s"] = time.perf_counter() - t0
    return out


def _perturbed_tokens(model, seed: int = 9, frac: float = DECODE_FLIP):
    """Within the block, every embedding of ``model``'s tokens comes out
    with a seeded ``frac`` of its elements moved by one ulp: what
    rounding alone does upstream of every block."""
    noisy = _ulp_noise(seed, frac)

    def wrap(embed):
        def run(*a, **kw):
            return noisy(embed(*a, **kw))
        return run
    return _wrapped(sys.modules[type(model).__module__], "embed_tokens",
                    wrap)


def moe_block_reference(cfg, params, mine: list, ranks: list,
                        batch: int, n_data: int) -> list:
    """For each rank of ``ranks`` (their ``_decode_job`` results) and each
    step: the plain one-device MoE block -- ``apply_moe`` over every
    expert of the last MoE block's ``params`` -- on the rank's own input
    to that block, and the number of the rank's routing choices (its
    rows' top-k experts) that are not among one device's on its own
    input (``mine``: the one-device run's ``_last_moe_blocks``)."""
    import torch
    from repro_torch.layers import moe as moe_mod
    last = max(i for i, k in enumerate(cfg.blocks()) if k == "moe")
    p = params["layers"][last]["moe"]
    dev = mine[0][0].device
    b_l = batch // n_data
    out = []
    for res in ranks:
        d = res["coords"]["data"]
        per = []
        for (h2, _), (h2_one, _) in zip(res["moe"], mine, strict=True):
            x = torch.from_numpy(h2).to(dev, h2_one.dtype)[:, None]
            one_idx = moe_mod.routing(
                p, h2_one[d * b_l:(d + 1) * b_l, None], cfg).idx
            idx = moe_mod.routing(p, x, cfg).idx
            kept = (idx[..., :, None] == one_idx[..., None, :]).any(-1)
            per.append({"plain": moe_mod.apply_moe(p, x, cfg)[:, 0]
                        .float().cpu(),
                        "flips": int((~kept).sum()),
                        "choices": int(kept.numel())})
        out.append(per)
    return out


def decode_reference(job: dict, device: str = "cuda",
                     ranks: list = None) -> dict:
    """Phase 15's one-device run of ``job``: the same seeded draw and
    whole cache, every step's ``decode_step``: the logits, the K/V rows
    written at the steps' positions, the final states, the launches and
    the wall; then the same run with the embedded tokens one ulp off on
    DECODE_FLIP of their elements (``_perturbed_tokens``), whose largest
    relative logits change sets the logits gate (``hymba_gate``'s rule).
    With ``ranks`` (their ``_decode_job`` results) and a MoE block:
    ``moe_block_reference`` on each rank's inputs to the last one.  The
    model and caches are freed after."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn import ops as fops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.models import build_model
    kind = torch.device(device)
    model = build_model(job["cfg"], kind)
    params = model.init(model.generator(0))

    def run():
        cache = _decode_cache(job, model, params, kind)
        counts, restore = _decode_counts()
        logits = []
        synchronize(kind)
        t0 = time.perf_counter()
        try:
            for pos, tok in job["steps"]:
                lg, cache = model.decode_step(
                    params, torch.from_numpy(tok).to(kind), cache, pos)
                logits.append(lg.float().cpu())
        finally:
            restore()
        synchronize(kind)
        return cache, logits, counts, time.perf_counter() - t0
    with torch.no_grad():
        mine = []
        with _last_moe_blocks(job["cfg"], mine):
            cache, logits, counts, wall = run()
        kvs, states = decode_parts(cache)
        out = {"logits": logits, "wall_s": wall, **counts,
               "launches": flash_decode.launches,
               "fastattn_launches": fops.fastattn_fwd.launches,
               "written": {pos: [(kv.k[:, pos].float().cpu(),
                                  kv.v[:, pos].float().cpu())
                                 for _, kv in kvs]
                           for pos, _ in job["steps"] if kvs},
               "states": [(li, name, t.float().cpu())
                          for li, name, t in states]}
        if mine and ranks is not None:
            out["moe"] = moe_block_reference(
                job["cfg"], params, mine, ranks, job["batch"],
                job["mesh"]["data"])
        del cache, kvs, states, mine
        with _perturbed_tokens(model):
            moved = run()[1]
    out["change"] = max(_rel_change(a, b) for a, b in zip(moved, logits))
    out["gate"], out["rule"] = hymba_gate(out["change"])
    del model, params
    gc.collect()
    if kind.type == "cuda":
        torch.cuda.empty_cache()
    return out


def decode_expected(cfg, steps: int, on_card: bool) -> dict:
    """Each phase 15 rank's launches over ``steps`` decode steps:
    ``flash_decode`` once an attention layer a step, each asked for the
    log-sum-exp, and (an encoder-decoder's cross-attention)
    ``fastattn_fwd`` once a decoder layer a step; the kernels count 0 on
    the CPU's plain path."""
    if cfg.is_encoder_decoder:
        attn, cross = cfg.num_layers, cfg.num_layers
    else:
        attn = sum(k not in ("mlstm", "slstm") for k in cfg.blocks())
        cross = 0
    return {"lse_calls": attn * steps,
            "flash_decode": attn * steps if on_card else 0,
            "fastattn_fwd": cross * steps if on_card else 0}


def decode_gate(what, ranks: list, ref: dict, job: dict,
                on_card: bool) -> dict:
    """Hold phase 15's ranks of ``job`` to the one-device run: each
    rank's logits within the measured gate ``ref["gate"]`` of its rows'
    scale with greedy tokens equal where the top-1 margin exceeds it
    (``_compare_logits``), the model ranks of a data group bit for bit,
    every layer's K/V rows a rank wrote and its slice of every recurrent
    state within the bf16 bound of the one-device run's (``bf16_row_gate``),
    its last MoE block's output each step within the bf16 bound of the
    plain one-device block's on the rank's own input (``ref["moe"]``,
    which also counts the routing choices that differ from one device's),
    every cache leaf the rule table's slice of ``cache_logical``, the
    launches exact (``decode_expected``: every ``flash_decode`` with the
    log-sum-exp) and no plain attention on CUDA tensors."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (flatten, is_logical_leaf,
                                            is_spec, local_shape,
                                            param_sharding_tree)
    cfg, b = job["cfg"], job["batch"]
    n_data, n = job["mesh"]["data"], job["mesh"]["model"]
    b_l = b // n_data
    steps = len(job["steps"])
    want = decode_expected(cfg, steps, on_card)
    logical = build_model(cfg, "cpu").cache_logical(b, job["width"])
    leaves = flatten(logical, is_logical_leaf)
    by_coords = {(r["coords"]["data"], r["coords"]["model"]): r
                 for r in ranks}
    out = {"written_worst": [], "state_worst": [], "moe_worst": [],
           "moe_flips": [], "moe_choices": []}
    for r, res in enumerate(ranks):
        d, m = res["coords"]["data"], res["coords"]["model"]
        tag = f"{what} rank {r} (data {d}, model {m})"
        mesh = make_mesh((n_data, n), ("data", "model"), r)
        specs = flatten(param_sharding_tree(logical, mesh), is_spec)
        shapes = [local_shape(shape, sp, mesh)
                  for (_, shape), sp in zip(leaves, specs, strict=True)]
        if res["shapes"] != shapes:
            raise AssertionError(f"{tag}: cache slices {res['shapes']}, "
                                 f"the rule table's {shapes}")
        got = {"lse_calls": res["lse_calls"],
               "flash_decode": res["launches"],
               "fastattn_fwd": res["fastattn_launches"]}
        if got != want:
            raise AssertionError(f"{tag}: launched {got} (flash_decode "
                                 f"with the log-sum-exp: lse_calls), want "
                                 f"{want}")
        if res["plain_cuda"]:
            raise AssertionError(f"{tag}: {res['plain_cuda']} plain "
                                 "attention calls on CUDA tensors")
        rows = slice(d * b_l, (d + 1) * b_l)
        for (pos, _), lg, rl in zip(job["steps"], res["logits"],
                                    ref["logits"], strict=True):
            _compare_logits(f"{tag} pos {pos}", torch.from_numpy(lg),
                            rl[rows], rel_tol=ref["gate"])
        for peer in range(n):
            other = by_coords[(d, peer)]
            for a, b_ in zip(res["logits"], other["logits"], strict=True):
                if not np.array_equal(a, b_):
                    raise AssertionError(f"{tag}: logits differ from its "
                                         f"model group's rank {peer}")
        s_l = job["width"] // n
        owned = sorted(pos for pos, _ in job["steps"]
                       if ref["written"] and pos // s_l == m)
        if sorted(res["written"]) != owned:
            raise AssertionError(f"{tag}: wrote positions "
                                 f"{sorted(res['written'])}, owns {owned}")
        worst = 0.0
        for pos, layers in res["written"].items():
            for layer, (k, v) in enumerate(layers):
                rk, rv = ref["written"][pos][layer]
                for name, g, e in (("k", k, rk[rows]), ("v", v, rv[rows])):
                    worst = max(worst, bf16_row_gate(
                        f"{tag} KV layer {layer} {name} rows at {pos}",
                        torch.from_numpy(g).reshape(b_l, -1),
                        e.reshape(b_l, -1)))
        sworst = 0.0
        if len(res["states"]) != len(ref["states"]):
            raise AssertionError(f"{tag}: {len(res['states'])} state "
                                 f"leaves, one device {len(ref['states'])}")
        for g, (layer, name, e) in zip(res["states"], ref["states"]):
            e = e[rows]
            for dim, size in enumerate(g.shape):
                if size != e.shape[dim]:      # the model axis splits it
                    e = e.narrow(dim, m * size, size)
            sworst = max(sworst, bf16_row_gate(
                f"{tag} layer {layer} {name}",
                torch.from_numpy(g).reshape(b_l, -1), e.reshape(b_l, -1)))
        out["written_worst"].append(worst)
        out["state_worst"].append(sworst)
        if "moe" in ref:
            mine = ref["moe"][r]
            if len(res["moe"]) != len(mine):
                raise AssertionError(f"{tag}: {len(res['moe'])} MoE block "
                                     f"records, one device {len(mine)}")
            out["moe_worst"].append(max(bf16_row_gate(
                f"{tag} last MoE block at {pos}", torch.from_numpy(got),
                want["plain"]) for (pos, _), (_, got), want in zip(
                    job["steps"], res["moe"], mine, strict=True)))
            out["moe_flips"].append(sum(w["flips"] for w in mine))
            out["moe_choices"].append(sum(w["choices"] for w in mine))
    out.update({
        "gate": ref["gate"], "rule": ref["rule"], "change": ref["change"],
        "launches": [r["launches"] for r in ranks],
        "lse_calls": [r["lse_calls"] for r in ranks],
        "fastattn_launches": [r["fastattn_launches"] for r in ranks],
        "wall_s": [r["wall_s"] for r in ranks],
        "job_s": [r["job_s"] for r in ranks],
        "collectives_a_step": [{k: v / steps for k, v in
                                r["collectives"].items()} for r in ranks],
        "merges_a_step": [{k: v / steps for k, v in r["merges"].items()}
                          for r in ranks],
        "peak_gb": [r["peak_gb"] for r in ranks],
        "ref_wall_s": ref["wall_s"], "ref_launches": ref["launches"],
        "ref_fastattn_launches": ref["fastattn_launches"]})
    log(f"{what}: every gate passed; logits gate {ref['gate']:.3g} "
        f"({ref['rule']}: one ulp on {DECODE_FLIP} of the embedded tokens "
        f"moves one device's logits {ref['change']:.3g} of their scale); "
        f"per rank: written K/V rows {[round(x, 3) for x in out['written_worst']]}"
        f" and states {[round(x, 3) for x in out['state_worst']]} of the "
        f"bf16 bound at worst"
        + (f", last MoE block {[round(x, 3) for x in out['moe_worst']]} of"
           f" it on the rank's own input, routing choices unlike one "
           f"device's {out['moe_flips']} of {out['moe_choices']}"
           if out["moe_worst"] else "")
        + ", step wall "
        f"{[[round(w, 3) for w in x] for x in out['wall_s']]} s, "
        f"collectives a step {out['collectives_a_step'][0]}, merges a "
        f"step {out['merges_a_step'][0]}, peak "
        f"{[round(x, 2) for x in out['peak_gb']]} GB, flash_decode "
        f"{out['launches']} (lse {out['lse_calls']}), fastattn_fwd "
        f"{out['fastattn_launches']}; one device {ref['launches']} / "
        f"{ref['fastattn_launches']} launches, {ref['wall_s']:.2f} s "
        f"({GLOO_NOTE})")
    return out


def _decode_rank(rank: int, jobs: list) -> list:
    """One rank of phase 15 spawned alone (``phase_mesh_decode``): its
    mesh at DIST_MESH, then each job's ``_decode_job``."""
    import torch
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_mesh_for
    if not torch.cuda.is_available():
        torch.set_num_threads(1)        # a rehearsal: ranks share the cores
    mesh = make_mesh_for(ParallelConfig(**DIST_MESH),
                         timeout=DIST_INIT_TIMEOUT_S)
    out = []
    for job in jobs:
        out.append(_decode_job(mesh, job))
        _free_card()
    return out


def phase_mesh_decode(runs: dict, device: str = "cuda") -> dict:
    """Phase 15: dense decode at (data=2, model=2) for every block kind
    left after phase 14 -- xlstm-125m's first 3 layers (the mLSTM's C
    over dv, the sLSTM's states over DI), hymba-1.5b's first 2 (its KV
    cache over the sequence, its Mamba h and conv history over DI),
    whisper-small's 2 + 2 (its self caches over the sequence, its cross
    K/V of every frame from ``encode`` on the mesh) and qwen3-moe's first
    2 (its KV caches, 64 experts a rank) at full width, bf16, random
    weights from seed 0 -- whose ranks ran in phase 12's and phase 8
    (h)'s spawns (``_decode_job``).  ``runs``: arch -> (job, the ranks'
    results, or None: one spawn of four ranks here runs those jobs, the
    phase alone).  Each one-device run (``decode_reference``) runs after
    the ranks; ``decode_gate`` holds the ranks to it.  Correctness only:
    gloo stages every collective through the host."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks, train_backend
    t0 = time.perf_counter()
    kind = torch.device(device)
    on_card = kind.type == "cuda"
    alone = [arch for arch, (_, ranks) in runs.items() if ranks is None]
    if alone:
        world = DIST_MESH["data"] * DIST_MESH["model"]
        backend, dev_of = train_backend(kind, world)
        with tempfile.TemporaryDirectory() as tmp:
            got = spawn_ranks(
                _decode_rank, world, args=([runs[a][0] for a in alone],),
                device_of_rank=dev_of, backend=backend,
                init_method=f"file://{tmp}/pg-15",
                timeout_s=DIST_DEADLINE_S,
                init_timeout_s=DIST_INIT_TIMEOUT_S)
        runs = dict(runs, **{a: (runs[a][0], [r[i] for r in got])
                             for i, a in enumerate(alone)})
        log(f"[15] one spawn of {world} ranks over {backend} for "
            f"{alone}: {time.perf_counter() - t0:.1f}s")
    out = {"models": {}}
    for arch, (job, ranks) in runs.items():
        cfg = job["cfg"]
        layers = (f"{cfg.encoder_layers} + {cfg.num_layers} layers"
                  if cfg.is_encoder_decoder else ", ".join(cfg.blocks()))
        log(f"[15] {arch} ({layers}), B={job['batch']}, a cache of "
            f"{job['width']} positions, steps at "
            f"{[p for p, _ in job['steps']]} at (data="
            f"{job['mesh']['data']}, model={job['mesh']['model']})")
        ref = decode_reference(job, device, ranks)
        out["models"][arch] = decode_gate(f"[15] {arch}", ranks, ref, job,
                                          on_card)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if on_card else "cpu"
    log(f"[15] {out['card']}: all gates passed in {out['seconds']:.1f}s "
        "(the one-device runs and the gates; the ranks ran in phases 8 "
        "(h) and 12)")
    log("[15] " + json.dumps(out))
    return out


def add_mesh_decode_entries(kernels: list, run: dict) -> None:
    """``flash_decode``'s and ``fastattn_fwd``'s entries of the kernels
    line also ``mesh_decode_launches``: each phase 15 model's launches
    on each rank (flash_decode's every one with the log-sum-exp:
    ``mesh_decode_lse_calls``)."""
    k = {e["name"]: e for e in kernels}
    models = run["models"]
    k["flash_decode"].update(
        mesh_decode_launches={a: m["launches"] for a, m in models.items()},
        mesh_decode_lse_calls={a: m["lse_calls"]
                               for a, m in models.items()})
    k["fastattn_fwd"]["mesh_decode_launches"] = {
        a: m["fastattn_launches"] for a, m in models.items()
        if any(m["fastattn_launches"])}


# ---------------------------------------------------------------------------
# phase 16: the dry run, and one rank of three production cells
# ---------------------------------------------------------------------------

# (b)'s cells, run as rank 0 of the 16 x 16 production mesh: (arch, shape,
# the decode steps' positions: every one in rank 0's slice of the cache)
DRYRUN_CELLS = (("qwen2.5-32b", "decode_32k", (1000, 1001, 1002, 1003)),
                ("hymba-1.5b", "long_500k", (1000, 1001, 1002, 1003)),
                ("qwen2.5-32b", "train_4k", ()))
DRYRUN_MESH = dict(data=16, model=16)
# JAX's skipped cells (its launch/dryrun.skip_reason): long_500k for every
# assigned arch but these two, the sub-quadratic ones
JAX_LONG_ARCHS = ("xlstm-125m", "hymba-1.5b")
# the caching allocator rounds every block up to a multiple of this, and
# hands a block of its large pool (requests over ALLOC_LARGE) out whole
# where what is left would be ALLOC_LARGE or less: up to that much more
ALLOC_ROUND = 512
ALLOC_LARGE = 1 << 20
DRYRUN_TIMEOUT_S = 600.0


def dryrun_summary(out_dir: str) -> dict:
    """(a): the records ``launch.dryrun.main`` wrote to ``out_dir``,
    counted; each ok cell's argument GB and fits_h100 logged.  Fails on
    an error cell and on a skipped set other than JAX's."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import ASSIGNED_ARCHS
    recs = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            recs.append(json.load(f))
    by = {st: [r for r in recs if r["status"] == st]
          for st in ("ok", "skipped", "error")}
    if by["error"] or len(recs) != 2 * len(ASSIGNED_ARCHS) * len(SHAPES):
        raise AssertionError(f"(a) {len(recs)} records, errors: " + "; ".join(
            f"{r['cell']}: {r['error']}" for r in by["error"]))
    skipped = {(r["arch"], r["shape"]) for r in by["skipped"]}
    want = {(a, "long_500k") for a in ASSIGNED_ARCHS
            if a not in JAX_LONG_ARCHS}
    if skipped != want:
        raise AssertionError(f"(a) skipped {sorted(skipped)}, JAX skips "
                             f"{sorted(want)}")
    for r in by["ok"]:
        m = r["memory"]
        log(f"[16] (a) {r['cell']}: arguments "
            f"{m['argument_bytes'] / 1e9:.3f} GB, estimate "
            f"{m['activation_bytes_estimate'] / 1e9:.3f} GB, fits_h100 "
            f"{r['fits_h100']}" + (f" (the port's step: {r['refused']})"
                                   if r.get("refused") else ""))
    return {"ok": len(by["ok"]), "skipped": len(by["skipped"]),
            "error": 0, "fits": sum(r["fits_h100"] for r in by["ok"])}


def _state_tensors(cell) -> tuple:
    """(the tensors of a cell's parameters, AdamW state and cache that
    hold any bytes -- each one allocation on the card --, those of them
    over ``ALLOC_LARGE``)."""
    from repro_torch.training import tree
    sizes = {id(x): x.numel() * x.element_size()
             for t in (cell.params, cell.opt, cell.cache) if t is not None
             for x in tree.leaves(t) if x.numel()}
    return len(sizes), sum(n > ALLOC_LARGE for n in sizes.values())


def _dryrun_rank(job: tuple, mesh_kw: dict, device: str) -> dict:
    """(b) for one cell, in a process of its own (a fresh allocator, so
    that the bytes the state adds are its own allocations: a block the
    caching allocator kept from an earlier cell may be handed out up to
    1 MiB larger than asked): a fake world of the mesh's ranks
    (``launch.mesh.fake_world``, this process rank 0), the mesh's groups
    (``make_mesh_for``), the dry run's record of rank 0 for ``job``
    (config, shape, decode positions), its state made at its shapes on
    ``device`` (``launch.dryrun.materialize``: the allocated bytes it
    adds), then one step (``rank_step``) with the collectives and
    launches counted and the peak read."""
    import torch
    from repro_torch.config import ParallelConfig
    from repro_torch.core import tiled_allreduce as tar
    from repro_torch.device import synchronize
    from repro_torch.kernels.fastattn import ops as fops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_world, make_mesh_for
    from repro_torch.sharding import collectives as C
    cfg, shape, positions = job
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    parallel = ParallelConfig(**mesh_kw)
    with fake_world(math.prod(parallel.mesh_shape())):
        cell = D.build_cell(cfg, shape, make_mesh_for(parallel))
        res = {"memory": D.memory(cell),
               "collectives": D.collective_counts(cell),
               "tensors": _state_tensors(cell),
               "steps": max(len(positions), 1)}
        def stats():
            m = torch.cuda.memory_stats(dev)
            return m["allocated_bytes.all.current"], \
                m["requested_bytes.all.current"]
        base = stats() if on_card else None
        real = D.materialize(cell, dev)
        synchronize(dev)
        res["grown"], res["requested"] = (
            (a - b for a, b in zip(stats(), base)) if on_card
            else (None, None))
        flash_decode.launches = fops.fastattn_fwd.launches = 0
        C.COUNTS.update({k: 0 for k in C.COUNTS})
        tar.COUNTS.update({k: 0 for k in tar.COUNTS})
        counts, restore = _cp_counting()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            D.rank_step(real, positions=positions)
            synchronize(dev)
        finally:
            restore()
        res.update(
            wall_s=time.perf_counter() - t0,
            counts={"sharding": dict(C.COUNTS), "merge": dict(tar.COUNTS)},
            flash_decode=flash_decode.launches,
            fastattn_fwd=fops.fastattn_fwd.launches, **counts,
            peak=torch.cuda.max_memory_allocated(dev) if on_card else None)
    return res


def dryrun_gate(what, res: dict, cfg, kind: str, on_card: bool) -> dict:
    """(b)'s gates on one cell's rank: the bytes its state added within
    the caching allocator's rounding of the dry run's count, the step's
    collectives the record's (a decode step's times the steps), the
    kernel launches (``flash_decode`` with the log-sum-exp each
    attention layer a step, no plain attention on CUDA; ``fastattn_fwd``
    twice an attention layer under remat), the peak under the card's
    80 GB.  Returns the readings."""
    mem = res["memory"]
    count = mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
    steps = res["steps"]
    want = {part: {k: v * steps for k, v in c.items()}
            for part, c in res["collectives"].items()}
    if res["counts"] != want:
        raise AssertionError(f"{what}: collectives {res['counts']}, the "
                             f"dry run's {want}")
    attn = sum(k not in ("mlstm", "slstm") for k in cfg.blocks())
    if kind == "decode":
        launches = {"lse_calls": attn * steps, "plain_cuda": 0}
        if on_card:
            launches["flash_decode"] = attn * steps
    else:
        launches = {"fastattn_fwd": 2 * attn} if on_card else {}
    got = {k: res[k] for k in launches}
    if got != launches:
        raise AssertionError(f"{what}: launches {got}, want {launches}")
    if on_card:
        tensors, large = res["tensors"]
        slack = ALLOC_ROUND * tensors + ALLOC_LARGE * large
        if res["requested"] != count or \
                not count <= res["grown"] <= count + slack:
            raise AssertionError(
                f"{what}: its state asked for {res['requested']} B and "
                f"added {res['grown']} B; the dry run counts {count} B (+ "
                f"at most {slack} B of the allocator's rounding)")
        if res["peak"] >= 80e9:
            raise AssertionError(f"{what}: peak {res['peak'] / 1e9:.2f} GB")
    out = {"count_bytes": count, "grown_bytes": res["grown"],
           "requested_bytes": res["requested"],
           "tensors": res["tensors"], "peak_bytes": res["peak"],
           "argument_bytes": mem["argument_bytes"],
           "estimate_bytes": mem["activation_bytes_estimate"],
           "wall_s": round(res["wall_s"], 3), "launches": got,
           "collectives": res["counts"]}
    peak = "" if res["peak"] is None else (
        f"; peak {res['peak'] / 1e9:.3f} GB, peak - arguments "
        f"{(res['peak'] - mem['argument_bytes']) / 1e9:.3f} GB beside the "
        f"estimate {mem['activation_bytes_estimate'] / 1e9:.3f} GB (read, "
        "not gated)")
    grown = "" if res["grown"] is None else (
        f", requested {res['requested']} B, allocated {res['grown']} B "
        f"(+{res['grown'] - count} over {res['tensors'][0]} tensors, "
        f"{res['tensors'][1]} of them over 1 MiB)")
    log(f"{what}: state {count} B by the dry run{grown}; collectives "
        f"{res['counts']}; launches {got}; step {res['wall_s']:.2f}s{peak}")
    return out


def phase_dryrun(device: str = "cuda", cells=DRYRUN_CELLS,
                 mesh_kw: dict = None) -> dict:
    """Phase 16: (a) ``python -m repro_torch.launch.dryrun --all`` in
    this process, on the meta device (nothing allocated on the card),
    read by ``dryrun_summary``; beside it (b) spawned processes, each
    rank 0 of a fake world of the production mesh's 256 ranks, run
    ``cells`` for real on ``device`` at the rank's shapes, one process a
    cell (``_dryrun_rank``), held by ``dryrun_gate``.  ``cells``: (arch or
    config, shape name or ShapeConfig, decode positions); ``mesh_kw``
    (default ``DRYRUN_MESH``) the mesh (b) runs."""
    import concurrent.futures
    import multiprocessing

    import torch
    from repro_torch.config import SHAPES, get_model_config
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    mesh_kw = mesh_kw or DRYRUN_MESH
    jobs = [(get_model_config(a) if isinstance(a, str) else a,
             SHAPES[s] if isinstance(s, str) else s, tuple(p))
            for a, s, p in cells]
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    log("[16] (b) under the fake backend the collectives move no data: "
        "values are not checked, only what the rank holds, issues and "
        "launches")
    # one fresh process a cell, side by side (their peaks together stay
    # under the card's memory: ~12.5 + 2 + 45 GB at the production cells)
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        ranks = [pool.submit(_dryrun_rank, job, mesh_kw, device)
                 for job in jobs]
        before = torch.cuda.memory_allocated() if on_card else 0
        with tempfile.TemporaryDirectory() as tmp:
            try:
                D.main(["--all", "--out", tmp])
            except SystemExit as e:
                if e.code:
                    raise AssertionError(f"(a) the dry run exited {e.code}")
            summary = dryrun_summary(tmp)
        if on_card and torch.cuda.memory_allocated() != before:
            raise AssertionError("(a) the dry run allocated on the card")
        t_a = time.perf_counter() - t0
        log(f"[16] (a) {summary} in {t_a:.1f}s")
        got = [r.result(timeout=DRYRUN_TIMEOUT_S) for r in ranks]
    out = {"a": dict(summary, seconds=t_a), "b": {}}
    for (cfg, shape, _), res in zip(jobs, got, strict=True):
        name = f"{cfg.name} {shape.name}"
        out["b"][name] = dryrun_gate(f"[16] (b) {name}", res, cfg,
                                     shape.kind, on_card)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = _card() if on_card else "cpu"
    log(f"[16] {out['card']}: all gates passed in {out['seconds']:.1f}s")
    log("[16] " + json.dumps(out))
    return out


def add_dryrun_entries(kernels: list, run: dict) -> None:
    """``flash_decode``'s and ``fastattn_fwd``'s entries of the kernels
    line also ``dryrun_launches``: their launches in each of phase 16
    (b)'s cells (rank 0 of the production mesh)."""
    k = {e["name"]: e for e in kernels}
    for name, key in (("flash_decode", "flash_decode"),
                      ("fastattn_fwd", "fastattn_fwd")):
        k[name]["dryrun_launches"] = {
            cell: r["launches"][key] for cell, r in run["b"].items()
            if key in r["launches"]}


def roofline_readings(trained: dict, long_step: dict) -> dict:
    """The first roofline readings: phase 4's MFU (``model_flops`` of its
    layers and batches over its median step and the bf16 peak) and phase
    3c's decode step against ``roofline_terms`` of an analytic cost
    (``model_flops`` + ``attention_flops`` as the FLOPs, 3c's byte
    count), each share of its bound; a share above 1.05 means a count is
    wrong, and fails."""
    from repro_torch.analysis.flops import attention_flops, model_flops
    from repro_torch.analysis.roofline import (PEAK_FLOPS, Cost, lever,
                                               roofline_terms)
    from repro_torch.config import ShapeConfig, get_model_config
    llama = get_model_config("llama2-7b")
    cfg4 = dataclasses.replace(llama, num_layers=trained["layers"])
    train = ShapeConfig("phase4", trained["seq"], trained["batch"], "train")
    mf = model_flops(cfg4, train)
    mfu = mf / (trained["steady_step_s"] * PEAK_FLOPS)
    dec = ShapeConfig("phase3c", long_step["kv_len"], 1, "decode")
    terms = roofline_terms(Cost(flops=model_flops(llama, dec)
                                + attention_flops(llama, dec),
                                bytes=long_step["step_bytes"]),
                           cfg=llama, shape=dec, n_devices=1)
    bound_s = max(terms[k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    out = {"mfu": mfu, "train_model_flops": mf,
           "train_step_s": trained["steady_step_s"],
           "decode_terms": terms, "decode_bound_ms": bound_s * 1e3,
           "decode_share_device": bound_s * 1e3 / long_step["device_ms"],
           "decode_share_wall": bound_s * 1e3 / long_step["wall_ms"],
           "lever": lever(terms)}
    log(f"[roofline] phase 4: {mf / 1e12:.2f} TFLOP of model FLOPs a step "
        f"({cfg4.num_layers} layers, {trained['batch']} x "
        f"{trained['seq']}) in {trained['steady_step_s'] * 1e3:.1f} ms: "
        f"MFU {mfu:.4f} of {PEAK_FLOPS / 1e12:.0f} TFLOP/s")
    log(f"[roofline] phase 3c: bound {out['decode_bound_ms']:.3f} ms "
        f"({terms['dominant']}; compute {terms['compute_s'] * 1e3:.4f} ms, "
        f"memory {terms['memory_s'] * 1e3:.3f} ms), the step's share of "
        f"it {out['decode_share_device']:.3f} of its device time "
        f"({long_step['device_ms']:.2f} ms), "
        f"{out['decode_share_wall']:.3f} of its wall "
        f"({long_step['wall_ms']:.2f} ms); {out['lever']}")
    if not (0 < mfu <= 1.05 and 0 < out["decode_share_device"] <= 1.05):
        raise AssertionError(f"[roofline] a share above 1.05: MFU {mfu}, "
                             f"decode {out['decode_share_device']}")
    log("[roofline] " + json.dumps(out))
    return out


def add_int8_pipeline_entries(kernels: list, int8: dict,
                              compress: dict) -> None:
    """``fastattn_fwd``'s entry of the kernels line also with its
    launches in phase 3f (each run: bf16, scan_layers True, False) and
    on each rank of phase 13 (b)."""
    k = next(k for k in kernels if k["name"] == "fastattn_fwd")
    k.update(int8_launches=int8["launches"],
             pipeline_launches=compress["pipeline"]["launches"])


def add_cp_entries(kernels: list, cases: dict, run: dict) -> None:
    """``flash_decode``'s entry of the kernels line also at phase 2's
    context-parallel slice cases (``CP_SLICE_CASES``: ``cp_full_*`` is a
    phase 14 rank's share of decode_32k, ``cp_empty_*`` / ``cp_start_*``
    its slice with 0 and 6 valid keys, ``cp_gemma_s0_*`` /
    ``cp_gemma_s1_*`` a window that empties or cuts a slice), each with
    its log-sum-exp error, and with its launches on each rank of phase 14
    (``cp_launches``, every one with the log-sum-exp: ``cp_lse_calls``)
    and its device time at each rank's slice there."""
    keys = ("err", "lse_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    k = next(k for k in kernels if k["name"] == "flash_decode")
    for pre, res in cases.items():
        k.update({f"{pre}_{'max_abs_err' if x == 'err' else x}": res.get(x)
                  for x in keys})
    k.update(cp_launches=run["launches"], cp_lse_calls=run["lse_calls"],
             cp_rank_device_ms=run["kernel_device_ms"])


def add_mesh_entries(kernels: list, cases: dict, run: dict) -> None:
    """``mlstm_chunkwise``'s and ``fastattn_fwd``'s entries of the
    kernels line also at each (2, 2) rank's shape of phase 12 (``cases``:
    kernel -> prefix -> phase 2's case; ``mesh_*``: xlstm-125m's 2 of 4
    heads at B=2, S=1024 and whisper's encoder, 750 of 1500 frames
    against all 1500, non-causal; ``mesh_hymba_*``, ``mesh_dec_*``,
    ``mesh_cross_*``: fastattn_fwd's other shapes there,
    ``MESH_FWD_CASES``), and their launches on each rank there
    (``mesh_launches``: fastattn_fwd's by model, at
    ``mesh_q_offsets``)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    models = run["models"]
    for k in kernels:
        name = k["name"]
        if name not in cases:
            continue
        for pre, res in cases[name].items():
            k.update({f"{pre}_{'max_abs_err' if x == 'err' else x}":
                      res.get(x) for x in keys})
        if name == "mlstm_chunkwise":
            k["mesh_launches"] = models["xlstm-125m"]["mlstm_launches"]
            k["mesh_heads"] = models["xlstm-125m"]["mlstm_heads"]
        else:
            k["mesh_launches"] = {a: m["launches"] for a, m in models.items()
                                  if any(m["launches"])}
            k["mesh_q_offsets"] = {a: m["q_offsets"]
                                   for a, m in models.items()
                                   if any(m["launches"])}


def add_hymba_entries(kernels: list, cases: dict, run: dict) -> None:
    """``fastattn_fwd``'s and ``flash_decode``'s entries of the kernels
    line also at hymba-1.5b's shape (``hymba_*``: phase 2's case at its
    main path's shape, ``cases[(name, "main")]``), fastattn_fwd's without
    the window (``hymba_global_*``), flash_decode's with the window
    narrower than the cache (``hymba_window_*``), and each one's launches
    in phase 9 (``hymba_launches``, by run)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    extra = {"fastattn_fwd": "global", "flash_decode": "window"}
    for k in kernels:
        name = k["name"]
        if name not in extra:
            continue
        for variant, pre in (("main", "hymba"),
                             (extra[name], f"hymba_{extra[name]}")):
            res = cases[(name, variant)]
            k.update({f"{pre}_{'max_abs_err' if x == 'err' else x}":
                      res.get(x) for x in keys})
        k["hymba_launches"] = run["launches"][name]


def add_whisper_entries(kernels: list, cases: dict, run: dict) -> None:
    """``fastattn_fwd``'s and ``flash_decode``'s entries of the kernels
    line also at whisper-small's shapes: phase 2's cases (``cases[(name,
    variant)]``, WHISPER_CASES) -- fastattn_fwd's ``whisper_enc_*``,
    ``whisper_cross_*`` and ``whisper_step_*``, flash_decode's
    ``whisper_*`` (kv_len 64) and ``whisper_ragged_*`` -- and each one's
    launches in phase 10 (``whisper_launches``, by run)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    for k in kernels:
        name = k["name"]
        if name not in run["launches"]:
            continue
        for kernel, variant in WHISPER_CASES:
            if kernel != name:
                continue
            pre = "whisper" if variant == "main" else f"whisper_{variant}"
            res = cases[(kernel, variant)]
            k.update({f"{pre}_{'max_abs_err' if x == 'err' else x}":
                      res.get(x) for x in keys})
        k["whisper_launches"] = run["launches"][name]


def add_vl_entries(kernels: list, cases: dict, run: dict) -> None:
    """Each attention kernel's entry of the kernels line also at
    qwen2-vl's 64/8 heads of 128 (``vl_*``): phase 2's case at its main
    path's shape (``cases[name]``; flash_decode's from phase 11 (c)'s
    caches, its phase-2 case as ``vl_case_*``), and its launches in phase
    11 (``vl_launches``; fastattn_fwd's by run)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    for k in kernels:
        name = k["name"]
        if name not in run["launches"]:
            continue
        res = run["flash_decode"] if name == "flash_decode" else cases[name]
        k.update({f"vl_{'max_abs_err' if x == 'err' else x}": res.get(x)
                  for x in keys})
        k["vl_launches"] = run["launches"][name]
        if name == "flash_decode":
            case = cases[name]
            k.update({f"vl_case_{x}": case.get(x) for x in (
                "err", "device_ms", "bound_ms", "library_device_ms")})


def add_moe_entries(kernels: list, cases: dict, run: dict) -> None:
    """Each attention kernel's entry of the kernels line also at GQA
    group 8 (``g8_*``): phase 2's case at qwen3-moe's shape
    (``cases[name]``; flash_decode's from phase 8 (b)'s caches, its
    phase-2 case as ``g8_case_*``), and its launches in phase 8
    (``moe_launches``)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    for k in kernels:
        name = k["name"]
        if name == "mlstm_chunkwise":
            continue
        res = run["flash_decode"] if name == "flash_decode" else cases[name]
        k.update({f"g8_{'max_abs_err' if x == 'err' else x}": res.get(x)
                  for x in keys})
        k["moe_launches"] = run["launches"][name]
        if name == "flash_decode":
            case = cases[name]
            k.update({f"g8_case_{x}": case.get(x) for x in (
                "err", "device_ms", "bound_ms", "library_device_ms")})


def add_moe_parallel_entries(kernels: list, run: dict) -> None:
    """``fastattn_fwd``'s entry gains its launches in phase 8 (g)
    (``moe_train_launches``) and on each rank of (h)
    (``moe_ep_launches``, at ``moe_ep_q_offsets``); the paged kernels'
    entries their launches on each rank of (i) (``moe_tp_launches``)."""
    for k in kernels:
        name = k["name"]
        if name == "fastattn_fwd":
            k["moe_train_launches"] = run["train"]["launches"]
            k["moe_ep_launches"] = run["dist"]["launches"]
            k["moe_ep_q_offsets"] = run["dist"]["q_offsets"]
        elif name in ("paged_prefill", "paged_decode"):
            k["moe_tp_launches"] = [r[name] for r in
                                    run["tp"]["launches"]]


def add_head_dim_entries(kernels: list, cases: dict, runs: dict) -> None:
    """Each attention kernel's entry of the kernels line also at head dims
    80 and 96 (``d80_*`` / ``d96_*``): phase 2's bf16 case at the main
    path's shape (``cases[(name, d)]``; flash_decode's from phase 7 (b)'s
    caches, and its ``d{d}_long_*`` from phase 2's B=1 on 65536 tokens),
    and the kernel's launches in phase 7 (``runs[d]``)."""
    keys = ("err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for k in kernels:
        name = k["name"]
        if name == "mlstm_chunkwise":
            continue
        for d, run in runs.items():
            res = (run["flash_decode"] if name == "flash_decode"
                   else cases[(name, d)])
            k.update({f"d{d}_{'max_abs_err' if x == 'err' else x}": res[x]
                      for x in keys})
            k[f"d{d}_launches"] = run["launches"][name]
            if name == "flash_decode":
                long = cases[(name, d)]
                k.update({f"d{d}_long_{x}": long[x] for x in (
                    "device_ms", "bound_ms", "library_device_ms")})


def add_context_entries(kernels: list, cases: dict, dist_run: dict) -> None:
    """``fastattn_fwd``'s entry gains phase 2's context-parallel cases
    (``CONTEXT_CASES``: ``context_*`` from rank m=1's shape,
    ``context_m0_*`` from m=0's) and each phase 4b rank's launches."""
    k = next(k for k in kernels if k["name"] == "fastattn_fwd")
    one, zero = cases[1], cases[0]
    k.update({f"context_{x}": one[x] for x in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_device_ms")})
    k["context_max_abs_err"] = one["err"]
    k.update({f"context_m0_{x}": zero[x] for x in (
        "device_ms", "bound_ms", "library_device_ms")})
    k["context_m0_max_abs_err"] = zero["err"]
    k["context_launches"] = dist_run["launches"]
    k["context_q_offsets"] = dist_run["q_offsets"]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[time] {phase} done at {time.perf_counter() - t0:.1f}s")
    phase_card_and_build()
    done("1")
    kern = phase_kernels()
    done("2")
    model, params = build_llama()
    served = phase_serving(model, params)
    done("3")
    dense = phase_dense(model, params)
    done("3b")
    long_step = phase_long_decode(model, params, dense["kv_rms"])
    done("3c")
    features = phase_features(model, params)
    done("3d")
    tp = phase_tp(model, params)
    done("3e")
    int8 = phase_int8(model, params)
    done("3f")
    del model, params
    gc.collect()                  # phase 3's model, pools and engines
    torch.cuda.ipc_collect()      # what phase 3e's ranks held by IPC
    torch.cuda.empty_cache()
    log(f"[train] {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        "allocated after serving")
    trained = phase_training()
    done("4")
    gc.collect()                  # phase 4's model and optimizer state
    torch.cuda.empty_cache()
    dist_run = phase_dist_training(trained)
    done("4b")
    del trained["reference"]      # phase 4's host copies
    gc.collect()
    phase_offload()
    done("5")
    gc.collect()                  # phase 5's host engine and caches
    torch.cuda.empty_cache()
    xlstm = phase_xlstm()
    done("6")
    gc.collect()                  # phase 6's model and optimizer state
    torch.cuda.empty_cache()
    head_dims = phase_head_dims()
    done("7")
    gc.collect()                  # phase 7's models
    torch.cuda.empty_cache()
    moe = phase_moe()
    done("8")
    gc.collect()                  # phase 8's model
    torch.cuda.empty_cache()
    moe_par = phase_moe_parallel(done)
    gc.collect()
    torch.cuda.empty_cache()
    hymba = phase_hymba()
    done("9")
    gc.collect()                  # phase 9's model
    torch.cuda.empty_cache()
    whisper = phase_whisper()
    done("10")
    gc.collect()                  # phase 10's model
    torch.cuda.empty_cache()
    vl = phase_vl()
    done("11")
    gc.collect()                  # phase 11's model
    torch.cuda.empty_cache()
    mesh = phase_mesh()
    done("12")
    gc.collect()                  # phase 12's models
    torch.cuda.empty_cache()
    cp_job = cp_job_for(dense["kv_rms"])
    compress = phase_compress_pipeline(cp_job=cp_job)
    done("13")
    cp = phase_cp_decode(cp_job, compress.pop("cp_ranks"))
    done("14")
    decode = phase_mesh_decode({**mesh.pop("decode"),
                                MOE_ARCH: moe_par.pop("decode")})
    done("15")
    gc.collect()
    torch.cuda.empty_cache()
    dry = phase_dryrun()
    done("16")
    roofline_readings(trained, long_step)
    launches = {**served["launches"], "fastattn_fwd": trained["launches"],
                "flash_decode": dense["launches"],
                "mlstm_chunkwise": xlstm["launches"]}
    kern["flash_decode"] = dense["kernel"]
    sources = {"paged_decode": (
        "src/repro_torch/kernels/flash_decode/csrc/paged_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:171"),
        "paged_prefill": (
        "src/repro_torch/kernels/fastattn/csrc/paged_prefill.cu",
        "src/repro/kernels/fastattn/kernel.py:322"),
        "fastattn_fwd": (
        "src/repro_torch/kernels/fastattn/csrc/fastattn_fwd.cu",
        "src/repro/kernels/fastattn/kernel.py:156"),
        "flash_decode": (
        "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode/kernel.py:87"),
        "mlstm_chunkwise": (
        "src/repro_torch/kernels/mlstm/csrc/mlstm_chunkwise.cu",
        "src/repro/kernels/mlstm/kernel.py:116")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1],
         "launches": launches[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"],
         "device_ms": kern[name]["device_ms"]}
        for name in ("paged_prefill", "paged_decode", "fastattn_fwd",
                     "flash_decode", "mlstm_chunkwise")]}
    # flash_decode also at the long shape (phase 2's LONG_DECODE), and the
    # long-context decode step it carries (phase 3c)
    long = kern["flash_decode_long"]
    next(k for k in line["kernels"] if k["name"] == "flash_decode").update(
        long_device_ms=long["device_ms"], long_bound_ms=long["bound_ms"],
        long_library_device_ms=long["library_device_ms"],
        long_step_device_ms=long_step["device_ms"],
        long_step_wall_ms=long_step["wall_ms"])
    # paged_prefill also at the speculative verify shape (phase 2's
    # VERIFY_CASE), with its launches in phase 3d (c)'s run
    ver = kern["paged_prefill_verify"]
    next(k for k in line["kernels"] if k["name"] == "paged_prefill").update(
        verify_launches=features["spec"]["on"]["verify_kernel_launches"],
        verify_max_abs_err=ver["err"], verify_ms=ver["ms"],
        verify_device_ms=ver["device_ms"], verify_plain_ms=ver["plain_ms"],
        verify_bound_ms=ver["bound_ms"], verify_bound_by=ver["bound_by"],
        verify_library_ms=ver["library_ms"],
        verify_library_device_ms=ver.get("library_device_ms"))
    # paged_prefill and paged_decode also launched on each rank of phase
    # 3e (a)'s tp=2 run, under each collective mode
    for k in line["kernels"]:
        if k["name"] in ("paged_prefill", "paged_decode"):
            k["tp_launches"] = {m: [r[k["name"]] for r in
                                    tp[f"a_{m}"]["launches"]]
                                for m in TP_MODES}
    add_head_dim_entries(line["kernels"], kern["head_dims"], head_dims)
    add_context_entries(line["kernels"], kern["fastattn_context"], dist_run)
    add_moe_entries(line["kernels"], kern["gqa8"], moe)
    add_moe_parallel_entries(line["kernels"], moe_par)
    add_hymba_entries(line["kernels"], kern["hymba"], hymba)
    add_whisper_entries(line["kernels"], kern["whisper"], whisper)
    add_vl_entries(line["kernels"], kern["vl"], vl)
    add_mesh_entries(line["kernels"], kern["mesh"], mesh)
    add_int8_pipeline_entries(line["kernels"], int8, compress)
    add_cp_entries(line["kernels"], kern["flash_decode_cp"], cp)
    add_mesh_decode_entries(line["kernels"], decode)
    add_dryrun_entries(line["kernels"], dry)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s on "
        f"{_card()}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
