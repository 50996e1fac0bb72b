#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a host with a CUDA device and the CUDA
toolkit.  The phases, each of which raises (and so exits non-zero) on
failure:

1. Build the six CUDA kernels from `src/repro_torch/csrc` (one nvcc per
   source, in parallel), print each kernel's ptxas line (registers,
   shared memory, spills) and the HGMMA count of flash attention's
   kernels from ``cuobjdump -sass``: its bf16 kernels must have some.
2. The main path, with every kernel's launch count set to 0 first: for
   jacobi-1d, jacobi-2d and heat-3d at PolyBench/C 4.2.1's EXTRALARGE sizes
   (N = 4000, 2800, 200; TSTEPS = 1000), ``analyze(get(k)).classify()
   .fifoize().size().plan().compile(backend="cuda")`` must pick the fused
   ring; T = 1000 runs as 125 chained calls with a time tile of
   steps = block = 8 and must match the PyTorch oracle on the card; each
   ring launch's shape (CTAs in one cluster, a cooperative grid, or blocks
   in flight across the card; threads) is printed, and on jacobi-2d and
   heat-3d it must span more than one CTA.  The same job forced to
   ``mode="addressable"`` must match too, in exactly 1000 launches queued
   from C by one call.
   Then ``validate(backend="cuda")`` must give 14/17/35 replays and 3/8/12
   negative rejections (its host clock, the analysis time users wait on,
   is printed), and a wrong plan must raise.  The counts are read here:
   every kernel must have launched.
3. The undersized-ring and narrowed-halo injections must diverge from the
   oracle, at a small size.
4. Each kernel is held against its plain PyTorch version on the same
   inputs: at small shapes (block = 1 and the injections included, the
   ring in each launch mode that takes the ring, its rows or its blocks
   over several CTAs; the addressable job entry point against chained
   plain steps) and at the main path's shapes.  A ring cluster or grid
   that cannot be placed must raise and leave the next launch clean.  The
   replay is held to its sequential walk exactly, on every channel's list
   in the three disciplines and on seeded random lists of one to three
   tiles and 7 events more (rings of 1 to 1024 slots and one past what
   the kernel keeps in shared memory, NOOPs mixed in).
5. Each kernel is timed with CUDA events at the main path's shapes, beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call; the ring also in every launch mode the
   geometry takes, each forced and bit-equal to the path's own.  The
   addressable step's call and its library call are timed in turns over
   five rounds (min / median / max), and its 1000-step job also as a
   replayed CUDA graph.
6. Fig. 3, with the counts set to 0 first: jacobi-1d at EXTRALARGE
   (N = 4000, T = 1000) as 125 chained ``jacobi_fifo_op`` calls at
   steps = block = 8 (the generated ring's tile) must equal phase 2's ring
   job and the oracle; then the two `repro_torch.bench.fig3_stencil` rows,
   hand-written against generated at (N, T) = (1024, 128) and
   (4096, 256), each time beside the hand-written kernel's wave count
   (the levels of its chain).  The hand-written kernel must have
   launched.
7. Flash attention through ``attention_op`` at qwen2-7b's width (H = 28,
   KV = 4, hd = 128), B = 1, causal: S = 4096 in bf16 and float32, and one
   bf16 call at S = 32768, each held against the kernel's plain version
   (the 32768 call also against the chunked oracle with 2048-wide
   chunks).  The kernel must have launched once a call.
8. The GLA time-mix through ``timemix_op`` at rwkv6-1.6b's width (H = 32,
   hd = 64), B = 1, S = 4096, chunk 64, float32, with decays drawn at
   scale 1.0 (the reference's overflow case), held against the plain
   version and the sequential oracle.  The kernel must have launched (one
   call queues its three phases: chunk increments, the state scan, the
   outputs).
9. The three kernels against their plain versions at the shapes of
   `tests/test_kernels.py`; the Fig. 3 stencil also against its grid walk
   on the CPU, bit for bit, there and at an odd block and at fewer, as
   many and more blocks than one CTA's workers; attention also at ragged
   S with B = 2,
   qwen2-7b's 7:1 grouping, bf16 and f16 at every head width,
   non-causal bf16, and hd = 16 and 80 (run on zero-padded channels); the
   time-mix at hd 16 to 128 (hd = 128 at chunk 64 included), chunks of 16
   to 128 and one that is no multiple of 16, in float32 and bf16.
10. The three kernels timed as in phase 5 (the Fig. 3 stencil with its
   wave count; the time-mix also phase by phase); the attention yardstick
   is
   ``F.scaled_dot_product_attention`` with k and v repeated to H heads so
   that head h reads kv head h % KV, as the reference groups them.
11. The design-space exploration on the card (`repro_torch.dse`):
   ``default_experiment("stencils-card")`` over jacobi-1d, jacobi-2d and
   heat-3d, 12 tilings (b = 1..16) x 2 topologies x 3 sizes = 216 points
   in 72 groups, the first size point of each group measured
   (``repeats`` 3) by ``cuda_backend.measure_compiled`` through the fused
   ring or the addressable fallback, as the plan says.  Three acts against
   a fresh store under ``build/dse``, in this process (one process owns
   the card while it times): a run stopped after 48 points, the resume,
   and a run that must compute nothing.  No point may be an error, all 72
   measurements must be there, none skipped, each on this card in mode
   ``fifo-ring`` or ``addressable``, and the ring and addressable launch
   counts, set to 0 before the acts and read after them, must be exactly
   what those measurements launch (their ``calls``, the warm-up included:
   one ring launch a call, one addressable launch a step).  Each measured
   geometry's output, on the input it was timed on, is then held to the
   kernel's plain version (``TOL``).  The measured seconds are the
   device's (`measure_compiled` holds the stream while the host queues the
   timed calls).  Printed per kernel: the points, the frontier over
   ``predicted_s`` and over ``measured_s`` beside `BENCH_dse.json`'s
   (taken on a TPU host), the measured seconds by mode; the acts' host
   seconds; jacobi-1d's parametric template build and per-size
   evaluation times, each evaluation held to a concrete analysis.  Then
   the same grid, roofline only, through the `PoolManager`'s 4 spawned
   workers while CUDA is live here, must give the same
   ``(fifo_fraction, total_slots)`` at every point.
12. The fault matrix and the self-timed engine (`runtime.resilience`,
   `runtime.selftimed`), at the PolyBench default sizes the reference's
   benchmarks analyze.  For each of `BENCH_faults.json`'s 15 kernels,
   ``faults_validate`` of ``classify().fifoize().size(pow2=True)`` with no
   device named, so its ``"cuda"`` trace rows replay on the card through
   kernel 3, the replay's launch count set to 0 first: the reference
   rows must give the kernel's ``counts``, ``clean_guard_events``,
   ``engine_cases`` and ``trace_cases``; every cuda row must be detected
   with the reference rows' fault specs (``faults_validate`` raises where
   a row blames another channel than the one injected); and the launches
   must equal the cuda rows whose trace has edges (108).  Every faulted
   event list then goes through kernel 3 and through the sequential walk,
   which must give the same six counters.  The self-timed points
   (`repro_torch.bench.selftimed_points`: jacobi-1d, jacobi-2d, heat-3d
   at exact sizing and the vpp-blocked ring, each at planned, planned−1
   and planned+25% under the concurrent policy) must equal
   `BENCH_selftimed.json`'s in every field but the seconds.  Phase 2's
   analyses must pass ``validate(mode="selftimed")`` and
   ``validate(mode="faults")`` (one replay launch a cuda row).  Printed,
   not gated: the host seconds of the matrix and of the points, and each
   stencil's guarded-run overhead over the plain run (best of 5).
13. The pipeline-parallel ring and the optimizers (`repro_torch.comm`,
   `repro_torch.optim`), TF32 off, the six kernels' launch counts set to 0
   first: they must stay 0, as the path runs torch ops and collectives and
   no kernel of this repository.  Four stages on the card in one
   ``LocalGroup(4)``, for three selections of the ring's lowering: the
   planner's records (``analyze_pipeline``, which must select
   ``"ppermute"``), ``"reorder-buffer"`` and ``"cuda:ppermute"``.  At the
   reference test's shape (S = 4, D = 16, M = 8, mb = 4) the loss and
   gradients must equal the sequential composition on the card and the
   same code on the CPU, and 30 SGD steps (lr 0.05) must lower the loss.
   At qwen2-7b's d_model (D = 3584, `src/repro/configs/qwen2_7b.py`), S =
   4, M = 8, mb = 512, float32 (205 MB of weights), each selection is held
   to the sequential composition and one ``pipeline_train_step`` is timed
   (CUDA events, median of 10 after a warm-up) beside its peak memory and
   its operations' bound, float32 products at three TF32 passes
   (`repro_torch.device`), for all its products and for the useful ones
   (the M ticks that carry microbatches, not the S - 1 of the bubble);
   the reorder buffer's time over ppermute's is
   printed with the card's name and power limit.  `adamw_update` (two
   steps, the learning rate from `cosine_warmup`) in float32 and with int8
   state on a (4, 3584, 3584) stacked parameter must agree with the same
   calls on the CPU, the int8 codes equal; `compressed_psum_mean` on
   ``LocalGroup(4)`` at the same shape must be within max|g| / 127 of the
   exact mean and equal to the CPU's result.  Each is timed on the card.
   Where the machine has two or more cards, a NCCL `DistGroup` over
   min(4, count) ranks, one card each, must give the CPU's loss and
   gradients (`dist_pipeline_errors`, which the CPU tests run under
   gloo); with one card a line says that it did not run.
14. The model path (`repro_torch.models`, `repro_torch.launch.serve`),
   TF32 off, each kernel's launch count set to 0 before each run that is
   read.  qwen2-7b (`src/repro/configs/qwen2_7b.py`) at full width and
   depth, bf16, weights drawn from ``--seed`` on the card, its serving
   layout (``parallel_for("decode_32k")``): `serve` answers 8 requests
   drawn as the reference launcher draws them (``--seed``), with 4 slots,
   a cache of 256 positions and up to 23 new tokens each (a prefill runs
   one prompt at B = 1 into its slot's cache rows).  Every request must
   finish with tokens in the vocabulary, kernel 5 must launch 28 times
   per prefill call (every train/prefill attention layer) and no other
   kernel may launch (decode runs `decode_attention` in PyTorch).  In the
   first run every prefill attention call's kernel 5 output is held to
   `chunked_attention` on the same q, k and v at phase 7's tolerance on
   the data's scale (`scaled_err`).  A second run is timed warm and must
   serve the same tokens.  Timed with
   CUDA events: the prefill of 1 × 4096 tokens (with kernel 5's share:
   28 × phase 10's device time of one launch at this width, over it) and
   the median decode step at B = 4.  Then layer 0's prefill attention at
   B = 1, S = 4096, bf16: kernel 5 through `self_attention` against
   `chunked_attention` on the same tensors on the card, at phase 7's
   tolerance (`attention_err`), before and after the ``wo`` projection,
   and at B = 4 with other tokens in each row for S = 4, 13 and 23
   (shorter than one 128-row tile, a tensor map per sequence).
   Then the same model cast to float32 (30.5 GB): at B = 4, S = 512, a
   prefill of S − 1 tokens through kernel 5 and the decode of token S
   through `decode_attention` (the cache in float32) against the train
   forward's logits at S − 1: within `PAIR_REL` of the largest logit, the
   top token equal in every row, with the attention projections at unit
   fan-in (`unit_fan_in`; the reference's init is run first and printed,
   not gated).  Then rwkv6-1.6b (`src/repro/configs/rwkv6_1_6b.py`) at
   full width and depth in float32, B = 1, S = 4096: the train forward
   launches kernel 6 once a layer (24) and nothing else, and is timed
   (median of 3); the prefill with a cache (the chunked form in PyTorch,
   no launch) and the token-by-token recurrence over the first 64 tokens
   are compared with it in logits, of the largest logit: with the
   reference's init at full depth (printed, not gated), then with the
   time-mix projections at unit fan-in and the bonus u drawn from N(0, 1)
   (the reference's init sets it to 0) for the model cut to 1 and 2
   layers (within `RWKV_SHALLOW_REL`) and at full depth (within
   `RWKV_REL`).  Layer 0's time-mix, kernel 6 against the chunked form
   from a zero state, must agree within `RWKV_TM_REL` of the largest
   output over 4 draws of the tokens and of u.  Each model's weights are
   freed before the next.  The launches of the server's first run and of
   the rwkv train forward are each kernel's ``model_path_launches`` in the
   JSON line.
15. The train path (`repro_torch.train`, `repro_torch.data`,
   `repro_torch.checkpoint`), TF32 off.  Reduced smollm-135m and
   rwkv6-1.6b in float32, the same parameters on the card and on the CPU:
   ``Model.loss_fn(...).backward()`` must give every leaf a gradient on the
   card (attention's and the time-mix's projections reach the loss only
   through kernels 5 and 6), each within `TRAIN_GRAD_REL` of the CPU's
   relative to its largest entry, with the kernel launched twice a layer
   (the forward and remat's recompute); one `make_train_step` step at m = 2
   must give the CPU's loss and ``grad_norm`` within the same bar.  Kernels
   5 and 6 differentiated at full width (`GRAD_ATTN`, `GRAD_GLA`): the
   `autograd.Function`'s gradients of every input must equal the chunked
   forms' autograd on the same inputs and upstream gradient (to 1e-6 of the
   largest entry: the backward is that computation), the forward within
   phase 7's and phase 8's tolerances; forward and backward timed (CUDA
   events).  Then smollm-135m (`src/repro/configs/smollm_135m.py`) at full
   width and depth, bf16, ``parallel_for("train_4k")``, through `train()`
   (8 x 128 batches) into ``build/train_ckpt``: 20 steps with checkpoints
   at 10 and 20, a second call that must resume from step 20, and a third
   that meets a fault at step 27, restores step 25 and replays; the losses
   must be finite, the mean of the last 5 of the first call below that of
   its first 5, and the launches exactly the steps run (replayed ones
   included) times 2 x 30.  (The synthetic stream is uniform, so all a
   model can learn is its init's excess over ln V, about 0.007 here, and in
   20 steps of the warm-up, lr at most 6e-5, it learns almost none of it:
   the gate holds within the batches' noise, -1.2e-4 at the default seed,
   and guards against a step that diverges, not for learning; lr 3e-3
   raises the loss.)  One step at train_4k's sequence, B = 4 x S =
   4096, is timed (median of 3 after a warm-up) with tokens a second, peak
   memory, kernel 5's launches and share, and against the products' bound
   (6 x parameters x tokens plus causal attention's 2 B H S^2 hd a layer
   x 3, at bf16's rate), and one more under torch.profiler (the device's
   busy share and kernels, and the kernel's backward's device time).
   rwkv6-1.6b at full width and depth, bf16, one step at B = 1, S = 4096,
   the same way (median of 2; kernel 6: 48 launches a step; its profile
   records the device's kernels alone, as its op events would take
   minutes to summarise).
   The launches of the three `train()` calls and of the timed steps (not
   of the comparisons) are each kernel's ``train_path_launches``.
16. The moe, hybrid and encoder-decoder families (`models/moe.py`,
   `models/ssm.py`, the stacks of `models/model.py`), TF32 off, weights
   drawn from ``--seed`` on the card in bf16, each model freed before the
   next, each with its peak memory.  qwen3-moe-30b-a3b
   (`src/repro/configs/qwen3_moe_30b_a3b.py`) at full width and depth (48
   layers, 128 experts, top-8) in its serving layout: `serve` answers 8
   requests (as phase 14: 4 slots, 256 positions), twice, the second run
   timed warm and held to the first's tokens; each prefill broadcasts its
   prompt to the 4 slots (the experts couple the rows) and launches kernel
   5 48 times, and no other kernel launches.  Its prefill of 1 × 4096 is
   timed (CUDA events, median of 3) with kernel 5's and the MoE blocks'
   shares (layer 0's call timed alone, times 48) and the products' bound
   (`_flops_products`: the experts over their capacity slots, 1.25 times
   the routed rows, at bf16's rate); the decode step at B = 4 as in phase
   14, against the bytes of every weight but the embedding table.  Layer
   0's MoE block in float32 must equal the CPU's within `PAIR_REL` at
   B = 1, S = 512 and on a crafted input that sends every token to experts
   0 and 1 (so both overflow): there two bf16 runs on the card must give
   the same bits, and expert 0 must serve cap − 1 tokens on both devices
   (the reference's overflow rule).  jamba-1.5-large-398b
   (`src/repro/configs/jamba_1_5_large_398b.py`) at full width, cut by
   `HYBRID_CUT` to one super-block (8 layers: 1 attention, 7 Mamba, 4 MoE)
   and 8 of its 16 experts (top-2 kept), int8 KV: its prefill of 1 × 4096
   timed with the Mamba sublayers' share, the decode step at B = 4, and 8
   requests served (kernel 5 once a prefill).  whisper-medium
   (`src/repro/configs/whisper_medium.py`) at full width and depth: a train
   forward over 1500 frames (the encoder's 30 s context) and 448 decoder
   tokens must call kernel 5 48 times, 24 non-causal at S = 1500 and 24
   causal at S = 448 (cross attention is `chunked_attention`), and is
   timed; 8 requests served with the launcher's zero frames (48 launches a
   prefill).  Then the four new archs reduced, float32 (`family_parity`):
   the card's train logits, decode after a prefill and loss against the
   CPU's within `PAIR_REL` (a decode through jamba's int8 KV within
   `FAMILY_INT8_DECODE`), every leaf with a gradient within
   `TRAIN_GRAD_REL` of the CPU's, kernel 5 once an attention layer in the
   forward and twice under the backward.  In the three models' first
   serving runs, in one prefill of 1 × 4096 each of qwen3-moe-30b-a3b and
   the jamba cut, and in whisper's train forward, every kernel 5 output is
   held to `chunked_attention` on the same q, k and v, bf16 on the card,
   at phase 7's tolerance on the data's scale.  The launches of the three
   models' first serving runs and of whisper's train forward are each
   kernel's ``family_path_launches``.
17. The dry run (`repro_torch.launch.{dryrun,hlo_stats,mesh,roofline}`),
   the six kernels' launch counts set to 0 first.  Its grid on the card's
   host: every cell of `DRYRUN_ARCHS` on both production meshes (16x16,
   2x16x16) traced on ``meta`` into ``build/dryrun_torch``, in
   `DRYRUN_WORKERS` spawned processes; every record must be ``ok`` or
   ``skipped``, the skipped ones exactly ``long_500k`` of the archs that
   are neither ssm nor hybrid (the reference's rule), and no kernel may
   have launched in any worker or here (a trace on ``meta`` takes the CPU
   route: attention is `chunked_attention`).  Each record on a production
   mesh is device 0's program, the step run as DTensors over a fake
   process group of the mesh's size, and must carry its collectives: a
   numeric ``collective_bytes`` above 0, its counts by kind and a
   ``collective_s``.  The two meshes' `render` tables, per mesh the summed
   trace, collective, compute and memory seconds and how many records
   each term dominates, and the grid's seconds are printed.  Then three
   steps of phases
   14-15, each model built from ``--seed`` on the card in bf16 and freed
   before the next: qwen2-7b's decode at B = 4 with a 256-position cache
   and its prefill of 1 x 4096, smollm-135m's train step at 4 x 4096
   (``parallel_for("train_4k")``).  For each, the dry run's one-card record
   (`make_host_mesh(1, 1)`, a `ShapeCell` at that shape) must predict the
   step's argument bytes exactly (the parameters, the optimizer state,
   the batch and the cache on the card); printed, not gated: the
   predicted peak against the arguments plus ``max_memory_allocated``'s
   growth over one call, the roofline seconds against the step's time
   (CUDA events, median of `DRYRUN_REPS`), the useful FLOPs ratio, and
   kernel 5's launches in one call (0, 28 and 60, as phases 14-15 read
   them), which are each kernel's ``dryrun_path_launches``.  No default
   process group may be up at the end of the phase (phase 18 starts
   one).
18. The sharded path (`Rules` on a `DeviceMesh`, every tensor a DTensor,
   kernels 5 and 6 under `local_map` on each rank's block) at world size 1:
   a one-rank NCCL group and a 1x1 ``("data", "model")`` mesh on the card.
   qwen2-7b at full width and depth (``parallel_for("decode_32k")``, as
   phase 14) serves phase 14's 8 requests through ``serve(…, mesh=)``, and
   every request's tokens must equal phase 14's one-device run; kernel 5
   must launch 28 times a prefill call there and nothing else launch.  Its
   prefill of 1 x 4096 and its decode step at B = 4 (a 256-position cache)
   are timed on both paths in turns (one-device, mesh, mesh, one-device;
   CUDA events, medians) and printed beside each other with the card's
   name and power limit; the mesh prefill's logits must sit within
   `PAIR_REL` of the one-device prefill's largest logit, the decode step's
   greedy tokens must be equal, kernel 5 must launch 28 times in a mesh
   prefill, and the one-device outputs must be plain tensors (no DTensor on
   that path); three mesh decode steps under `torch.profiler` give
   DTensor's dispatches a step and their host time.  Then smollm-135m's train step at 4 x 4096 (``train_4k``,
   TF32 off) from the same state and tokens on both paths: the mesh loss
   within `TRAIN_GRAD_REL` of the one-device loss, kernel 5 launched 60
   times a step, both steps timed.  With two or more cards, a 1x2
   (``model``) serve of the same requests and a 2x1 (``data``) train step
   over NCCL, a rank a card (`mesh_serve_rank`, `mesh_train_rank`), held
   to the one-card tokens and loss; on one card a line says they were not
   run.  Before the train step, rwkv6-1.6b's train forward at S = 4096 in
   float32 (projections at unit fan-in, as phase 14) on both paths: kernel
   6 must launch 24 times under `local_map` and the logits sit within
   `RWKV_TM_REL` of the one-device path's largest.  Each kernel's
   ``mesh_path_launches`` counts the mesh serve, prefill, rwkv forward and
   train step above.

Tolerances.  The kernels compute the same float32 operations in the same
order as the plain versions and the oracles (built with -fmad=false, so no
multiply is fused into an add).  One difference is left: on the card,
PyTorch divides by a Python scalar by multiplying with its rounded
reciprocal, and the kernels divide exactly.  fl(1/3) and fl(1/5) are
3.0e-8 and 1.5e-8 too large relative to 1/3 and 1/5, and that bias
compounds over the steps.  So one call (8 steps) and everything at small
shapes is held to rtol = atol = 1e-5, and the 1000-step jobs against the
oracle to rtol = 1000 * 2**-22 (2.4e-4, twice the worst compounded bias of
one rounding per step), atol = 1e-5.  The two kernel paths both divide
exactly, so the fused ring and the addressable fallback are held to each
other at rtol = atol = 1e-5 after the 1000 steps.  The hand-written Fig. 3
kernel does the ring's operations in the same order, so its 1000-step job
is held to the ring job at 1e-5 and to the oracle at the long tolerance;
at small shapes it is held to its plain version at rtol = max(1e-5,
steps * 2**-22), the same rule per call.

Attention computes in float32 from inputs rounded to their dtype, with the
sums in another order than the plain version's.  In bf16 and f16 the
kernel also rounds the probabilities P to the input dtype before the PV
product on the tensor cores, as the chunked oracle does (2**-9 and 2**-12
relative each, averaging out over a row's terms); the plain version
keeps them in float32.  In float32 it takes each product in three TF32
passes (about 20 bits of it), sums a tile's products on the tensor cores
and the tiles on the CUDA cores.  At small shapes float32 is held to the
reference's 1e-5, and bf16 and f16 to its 2e-2 and 1e-2,
which cover one rounding of the output to the dtype (2**-8 and 2**-11
relative, one unit of the last place apart at most).  Those are absolute
and relative tolerances, calibrated where S <= 256 and a typical |o| is
about 0.15.  At full width they would be loose: with N(0, 1) inputs a
query row that sees n keys has |o| about sqrt(e / n), 0.036 at S = 4096
and 0.013 at S = 32768, smaller than an absolute 2e-2.  So phases 7 and
10 hold each element to rtol = tol plus atol = tol * the RMS of the
reference's row (one query position, over heads and channels, capped at
1): float32 at tol = 1e-4 (sums in another order, and the TF32
passes), bf16 at the reference's 2e-2.  The chunked oracle rounds the
probabilities to bf16 before the PV product (a 2**-9 relative error
each, that does not shrink with |o| where a row's terms cancel); its
error stays near 1e-3 of the row's RMS, well inside the tolerance.  The
GLA time-mix is held to the reference's 2e-3 in float32 (its products in
three TF32 passes, its exponentials on the special-function unit), and in
bf16 to 2e-2, one rounding of the output to bf16 (2**-8 relative) from
float32 sums in another order.  The plain versions and the yardsticks run
with TF32 off.

Phase 14 compares the model's paths at the scale of its random weights.
The reference draws a stacked (D, heads, hd) projection with the head
count as its fan-in (``shape[-2]``), so at qwen2-7b's width layer 0's q,
k and v have an RMS of 10–30 (printed) and the scores of about 300:
phase 7's row-scaled atol, capped at 1 for inputs of unit scale, would be
tighter than the kernel's bf16 rounding of P (2**-9 of |v|), so kernel 5
in layer 0 is held to it after both outputs are divided by the
reference's RMS (`scaled_err`), in every prefill attention call of the
server's first run too.  The same scores make the random network chaotic:
a float32 rounding difference between two correct paths grows with depth
to O(1) logits (the reference init's pair is printed, not gated).  So the
float32 comparisons are gated with the projections rescaled to the fan-in
of their contraction (D, and heads x hd; `unit_fan_in`).  `PAIR_REL` =
1e-4 is the bar the reduced card tests hold the same pair to, 20 times the
measured difference (PERF.md §6), room for the kernel's float32 products
(about 20 bits) and cuBLAS's sum order.  RWKV-6 still grows a difference
with depth at unit fan-in, so kernel 6 is held where that growth has not
begun: layer 0's time-mix within `RWKV_TM_REL` = 1e-4 of its largest
output (5.1e-6 to 6.6e-6 over the 4 draws, PERF.md §6), the model cut to
1 and 2 layers within `RWKV_SHALLOW_REL` = 1e-4 of the largest logit
(4.4e-6 and 1.5e-5): 15 and 6.5 times the largest readings.  At 24
layers the difference is chaotic in the weights (1.0e-2 with u = 0,
5.6e-4 with u drawn), so
`RWKV_REL` = 2e-2 there only guards against a path that computes another
function, which is off by O(1).

Phase 15 holds the card's gradients to the CPU's at `TRAIN_GRAD_REL` = 2e-4
of each leaf's largest entry: the forwards differ by the kernels' rounding
(`MODEL_REL`), and the backwards, the chunked forms' autograd on both
devices, sum in another order, which alone reads up to 5.2e-5 between the
CPU port and the JAX package (`tests/test_torch_train.py`).

Phase 16 compares the reduced models at the reference's init with every
attention's ``wq`` and ``wk`` times `FAMILY_QK_SCALE` (1/4), and a decode
through an int8 KV cache at `FAMILY_INT8_DECODE` = 2e-2 of the largest
logit; `repro_torch.bench.family_parity`'s docstring says why.  Its
kernel 5 outputs inside the three served models and whisper's train
forward are held to `chunked_attention` on the same q, k and v as phase
14 holds qwen2-7b's, at phase 7's tolerance on the data's scale.

Phase 13 compares products in float32 with TF32 off.  At D = 16 a sum of
16 products differs by a few units of the last place between orders (the
card's cuBLAS, the CPU's, the batched and the per-stage products), so the
loss and gradients (of order 0.01–1) are held to an absolute 1e-6, the
tolerance the CPU tests hold the port to the JAX package with.  At D =
3584 the sums have 3584 terms and the gradients are of order 1e-6, so each
leaf is held to a relative 1e-4 of its largest element and the loss to a
relative 1e-4.  The optimizers' elementwise steps round the same way on
both devices; the gradients are drawn with a global norm under the clip
norm, so the clip scale is exactly 1 and no sum order reaches the update:
the int8 codes and the compressed mean must be equal, and the float32
moments and parameters agree to 1e-6 (relative for the moments), which
leaves room for one rounding of ``b1**step`` and ``sqrt``.

The last lines are the card's name and power limit, one JSON line with the
kernels' numbers (each replay row also with its stencil's launches in the
phase 12 matrix, ``fault_matrix_launches``), and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: PolyBench/C 4.2.1 EXTRALARGE_DATASET (jacobi-1d.h, jacobi-2d.h, heat-3d.h)
SIZES = {"jacobi-1d": (4000,), "jacobi-2d": (2800, 2800),
         "heat-3d": (200, 200, 200)}
TSTEPS = 1000
STEPS = BLOCK = 8                       # time tile; divides every size and T
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_LONG = dict(rtol=TSTEPS * 2 ** -22, atol=1e-5)   # see the docstring
#: addressable step: rounds of its call against its library call, and
#: launches queued back to back for its device time
ADDR_ROUNDS, ADDR_REPS = 5, 200
#: replays and negative rejections of validate (the reference's evidence)
VALIDATE = {"jacobi-1d": (14, 3), "jacobi-2d": (17, 8), "heat-3d": (35, 12)}
#: small shapes for the kernel-vs-plain checks: (shape, steps, blocks)
SMALL = {"jacobi-1d": ((32,), 4, (1, 2, 4)),
         "jacobi-2d": ((16, 40), 4, (1, 4)),
         "heat-3d": ((8, 6, 5), 2, (1, 2))}
#: inner widths over several ring CTAs and a multiple of no tile:
#: (shape, steps), run at block 1 and block = steps
SMALL_WIDE = {"jacobi-2d": ((40, 300), 4), "heat-3d": ((16, 37, 45), 2)}
#: float32 operations a cell takes in one step of each update
FLOPS_PER_CELL = {"jacobi-1d": 3, "jacobi-2d": 5, "heat-3d": 15}
#: qwen2-7b's attention width (src/repro/configs/qwen2_7b.py), B = 1,
#: S = 4096 (the train_4k sequence); S = 32768 is prefill_32k
ATTN = dict(B=1, S=4096, H=28, KV=4, hd=128)
ATTN_LONG_S = 32768
#: rwkv6-1.6b's time-mix width (src/repro/configs/rwkv6_1_6b.py), B = 1
GLA = dict(B=1, S=4096, H=32, hd=64)
GLA_CHUNK = 64
#: attention tolerances by dtype (see the docstring)
ATTN_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2,
            "torch.float16": 1e-2}
GLA_TOL = dict(rtol=2e-3, atol=2e-3)
#: small shapes of tests/test_kernels.py
SMALL_FIFO = ((256, 32), (512, 64), (1024, 128), (8, 1))
#: the Fig. 3 stencil at an odd block, and at fewer, exactly as many and
#: more blocks (the flush block included) than one CTA's workers at block 8
#: (1024) and block 3
WIDE_FIFO = ((99, 3), (3300, 3), (4000, 8), (8 * 1023, 8), (16000, 8))
#: seeded random replay lists: tiles (then 7 events more) and ring sizes
REPLAY_RANDOM = ((1, 1), (2, 37), (3, 1024), (1, 65536))
SMALL_ATTN = ((2, 128, 4, 2, 64, True, "float32"),
              (1, 256, 8, 8, 128, True, "bfloat16"),
              (2, 128, 4, 1, 64, False, "float32"),
              (1, 128, 6, 3, 32, True, "float32"),
              (1, 64, 2, 2, 128, True, "float16"),
              # ragged B = 2 (tensor maps bounded per sequence), qwen2-7b's
              # 7:1 grouping, bf16/f16 at every head width, non-causal bf16
              (2, 192, 4, 2, 64, True, "bfloat16"),
              (2, 192, 4, 2, 64, True, "float32"),
              (1, 128, 28, 4, 128, True, "bfloat16"),
              (1, 128, 4, 2, 32, True, "bfloat16"),
              (1, 128, 4, 2, 64, True, "bfloat16"),
              (1, 128, 4, 2, 32, True, "float16"),
              (1, 128, 4, 2, 64, True, "float16"),
              (2, 192, 4, 2, 128, True, "float16"),
              (2, 256, 4, 2, 128, False, "bfloat16"),
              # head widths the kernel runs on zero-padded channels
              (1, 128, 4, 2, 16, True, "float32"),
              (1, 128, 4, 2, 16, True, "bfloat16"),
              (2, 192, 4, 2, 80, True, "float32"),
              (2, 192, 4, 2, 80, True, "bfloat16"),
              # the server's prompts, shorter than one tile, at B = 4 and
              # qwen2-7b's width (phase 14 holds them inside the model)
              (4, 4, 28, 4, 128, True, "bfloat16"),
              (4, 13, 28, 4, 128, True, "bfloat16"),
              (4, 23, 28, 4, 128, True, "bfloat16"),
              # whisper-medium's encoder: non-causal over its 1500 frames, a
              # ragged last tile (phase 16 holds it inside the model)
              (1, 1500, 16, 16, 64, False, "bfloat16"))
#: (B, S, H, hd, chunk, decay scale, dtype): tests/test_kernels.py's cases,
#: hd = 128 at the default chunk, bf16, chunk 16 at hd 16, and a padded hd
#: with a chunk that is no multiple of the kernel's 16-row sub-chunks
SMALL_GLA = ((2, 128, 3, 32, 32, 0.5, "float32"),
             (1, 256, 2, 64, 64, 1.0, "float32"),
             (2, 128, 4, 16, 128, 1.5, "float32"),
             (1, 128, 2, 128, 64, 1.0, "float32"),
             (1, 128, 2, 128, 64, 1.0, "bfloat16"),
             (1, 128, 2, 64, 64, 1.0, "bfloat16"),
             (1, 64, 2, 16, 16, 1.0, "float32"),
             (1, 96, 2, 20, 24, 1.0, "float32"))
#: the time-mix's bf16 tolerance: outputs rounded to bf16 (a relative step of
#: up to 2**-7) from float32 sums taken in another order
GLA_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
#: the time-mix's phases, as the C entry's mask takes them
GLA_PHASES = {"A (chunk increments)": 1, "B (state scan)": 2,
              "C (outputs)": 4}
REPLACES = {
    "ring_stencil": "src/repro/runtime/pallas_codegen.py:142",
    "addressable_step": "src/repro/runtime/pallas_codegen.py:190",
    "replay": "src/repro/runtime/pallas_backend.py:126",
    "stencil_fifo": "src/repro/kernels/stencil_fifo/kernel.py:30",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:29",
    "gla_timemix": "src/repro/kernels/gla_timemix/kernel.py:23",
}
SOURCES = {
    "ring_stencil": "src/repro_torch/csrc/ring_stencil.cu",
    "addressable_step": "src/repro_torch/csrc/addressable_step.cu",
    "replay": "src/repro_torch/csrc/replay.cu",
    "stencil_fifo": "src/repro_torch/csrc/stencil_fifo.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "gla_timemix": "src/repro_torch/csrc/gla_timemix.cu",
}
#: phase 11: the DSE over the three stencils `STENCIL_PROGRAMS` covers, its
#: first act's point budget, and the pool run's workers
DSE_KERNELS = ("jacobi-1d", "jacobi-2d", "heat-3d")
DSE_BUDGET = 48
DSE_POOL_WORKERS = 4
DSE_REPEATS = 3
#: phase 12: the guarded-run overhead's stencils and best-of count
#: (benchmarks/bench_faults.py's OVERHEAD_KERNELS and REPS)
OVERHEAD_KERNELS = ("jacobi-1d", "jacobi-2d", "heat-3d")
OVERHEAD_REPS = 5
#: phase 13: the pipeline ring (stages S, width D, M microbatches of mb
#: rows) at the reference test's shape, and at qwen2-7b's d_model
#: (src/repro/configs/qwen2_7b.py) with 512 rows a microbatch
PIPE_SMALL = dict(S=4, D=16, M=8, mb=4)
PIPE_WIDE = dict(S=4, D=3584, M=8, mb=512)
PIPE_SGD_STEPS = 30
PIPE_LR = 0.05
PIPE_REPS = 10
PIPE_TOL = 1e-6                     # small shape, absolute (see docstring)
PIPE_WIDE_RTOL = 1e-4               # wide shape, of each leaf's max |grad|
#: the optimizers' stacked parameter: four stages of a qwen2-7b-wide square
OPT_SHAPE = (4, 3584, 3584)
OPT_STEPS = 2
#: phase 14: qwen2-7b served at full width and depth (src/repro/configs/
#: qwen2_7b.py) as the reference launcher serves it; its prefill timed at
#: B = 1, S = 4096 (where phase 14 also holds kernel 5 in layer 0 to the
#: chunked form); a float32 prefill/decode pair at B = 4, S = 512; and
#: rwkv6-1.6b (src/repro/configs/rwkv6_1_6b.py) at S = 4096, its first 64
#: tokens decoded step by step
MODEL_ARCH, RWKV_ARCH = "qwen2-7b", "rwkv6-1.6b"
SERVE = dict(requests=8, slots=4, max_seq=256, max_new=24)
MODEL_PREFILL_S = 4096
PAIR = dict(B=4, S=512)
RWKV_S, RWKV_PREFIX = 4096, 64
MODEL_REPS, DECODE_REPS = 3, 10
#: prompts shorter than kernel 5's 128-row tile at B = 4, bf16: the
#: shortest, a middle and the longest prompt the launcher draws
SHORT_B, SHORT_S = 4, (4, 13, 23)
#: rwkv6-1.6b cut to these depths, and layer 0's time-mix over this many
#: draws of its tokens and u
RWKV_DEPTHS, RWKV_DRAWS = (1, 2), 4
#: phase 14's float32 bars, of the largest logit or output (see the
#: docstring)
PAIR_REL = 1e-4
RWKV_TM_REL = 1e-4
RWKV_SHALLOW_REL = 1e-4
RWKV_REL = 2e-2
#: phase 15: the train path.  Reduced smollm-135m and rwkv6-1.6b in float32
#: (B x S tokens, m microbatches in the step) for the gradient checks;
#: kernels 5 and 6 differentiated at full width, (B, S, H, KV, hd) in bf16
#: at smollm-135m's and qwen2-7b's widths and the time-mix at rwkv6-1.6b's
#: in float32; smollm-135m (src/repro/configs/smollm_135m.py) trained at
#: full width and depth through `train()` (its 8 x 128 geometry) for
#: TRAIN_STEPS steps, resumed for RESUME_STEPS, then replayed through a
#: fault at global step REPLAY_FAIL over REPLAY_STEPS; one step timed at
#: train_4k's sequence, B x S; rwkv6-1.6b one step at B = 1, S = 4096
TRAIN_ARCH = "smollm-135m"
TRAIN_SMALL = dict(B=4, S=32, m=2)
TRAIN_GRAD_REL = 2e-4
GRAD_ATTN = ((4, 4096, 9, 3, 64), (1, 4096, 28, 4, 128))
GRAD_GLA = dict(B=1, S=4096, H=32, hd=64)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_LR = 20, 10, 3e-4
RESUME_STEPS, REPLAY_STEPS, REPLAY_FAIL = 5, 4, 27
TRAIN_STEP = dict(B=4, S=4096)
RWKV_STEP = dict(B=1, S=4096)
TRAIN_REPS, RWKV_STEP_REPS = 3, 2
#: phase 16: the moe, hybrid and encoder-decoder families.  qwen3-moe-30b-a3b
#: (src/repro/configs/qwen3_moe_30b_a3b.py) at full width and depth, its
#: prefill timed at B = 1, S = FAMILY_PREFILL_S, layer 0's MoE block held to
#: the CPU at MOE_LAYER0 and on a crafted overflow (every token sent to
#: experts 0 and 1 by an input along their router columns); jamba-1.5-large-
#: 398b (src/repro/configs/jamba_1_5_large_398b.py) at full width cut by
#: HYBRID_CUT; whisper-medium (src/repro/configs/whisper_medium.py) at full
#: width and depth, a train forward over the encoder's 30 s context and the
#: decoder's 448 tokens; the four new archs reduced (`family_parity`),
#: float32, card against CPU
MOE_ARCH, HYBRID_ARCH, ENCDEC_ARCH = ("qwen3-moe-30b-a3b",
                                      "jamba-1.5-large-398b",
                                      "whisper-medium")
FAMILY_ARCHS = (MOE_ARCH, "dbrx-132b", HYBRID_ARCH, ENCDEC_ARCH)
FAMILY_PREFILL_S = 4096
MOE_LAYER0 = dict(B=1, S=512)
MOE_OVERFLOW = dict(B=4, S=256, scale=8.0)
HYBRID_CUT = dict(num_layers=8, num_experts=8)
#: phase 16: jamba2-mini (src/repro_torch/configs/jamba2_mini.py) at its
#: published widths, one stage of 8 of its 32 layers: the prefill of 1 x
#: FAMILY_PREFILL_S and a decode step timed
STAGE_ARCH, STAGE_LAYERS = "jamba2-mini", 8
ENCDEC_FRAMES, ENCDEC_TOKENS = 1500, 448
#: phase 17: the dry run (`repro_torch.launch.dryrun`).  Its grid here, on
#: the card's host, over these archs x every cell x both production meshes
#: (the CLI's default grid is every arch), in DRYRUN_WORKERS spawned
#: processes: llama3-405b is left to the CLI, as its train_4k trace alone
#: takes 424-733 s on the card's host (PERF.md section 6, PR 23); then the
#: one-card records of three steps of phases 14-15, (arch, cell, B, S),
#: each held to the step run on the card (DRYRUN_REPS)
DRYRUN_ARCHS = ("qwen2-7b", "smollm-135m", "qwen3-moe-30b-a3b")
DRYRUN_WORKERS = 8
DRYRUN_STEPS = (("qwen2-7b", "decode_32k", 4, 256),
                ("qwen2-7b", "prefill_32k", 1, 4096),
                ("smollm-135m", "train_4k", 4, 4096))
DRYRUN_REPS = 3
#: phase 18: the sharded path on a 1x1 DeviceMesh (the serve of phase 14's
#: requests, its prefill and decode timed, smollm-135m's train step)
MESH_TRAIN_REPS = 2
#: kernels redesigned for Hopper after their first port
REDESIGNED = {"ring_stencil", "addressable_step", "replay", "stencil_fifo",
              "flash_attention", "gla_timemix"}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def spread(times) -> list:
    """min, median and max of a list of times."""
    return [min(times), statistics.median(times), max(times)]


def gla_work(B: int, S: int, H: int, hd: int, C: int, sub: int = 16):
    """(operations on the CUDA cores, product flops) of the chunkwise
    time-mix as the kernel runs it (``csrc/gla_timemix.cu``), C a multiple
    of ``sub``.  Per chunk of each (b, h), with NB = C / sub sub-chunks of
    two halves each: the cumulative sums (C hd adds); k e^{tot - cl} (3 C
    hd: a subtraction, an exponential, a product) and e^{tot} (hd); the
    pairwise terms inside each half, 2 NB h(h-1)/2 hd of them (h = sub / 2)
    at 5 operations (a subtraction, an exponential, r k, a fused
    multiply-add as two); the factors of the factored blocks, 2 sub hd for
    each of the NB(NB-1)/2 blocks between sub-chunks and 2 h hd for each of
    the NB half blocks, at 3 operations (a subtraction, an exponential, a
    product); r e^{cl_prev} (2 C hd); y_diag (5 C hd: r u k summed, times
    v, added); the state chain (2 hd^2).  Products, two flops a
    multiply-add: D_c and y_inter (C hd^2 each), y_intra over the C(C-1)/2
    pairs t > s (hd each), the blocks between sub-chunks (sub^2 hd each)
    and the half blocks (h^2 hd each)."""
    h = sub // 2
    NB, chunks = C // sub, B * H * (S // C)
    blocks = NB * (NB - 1) // 2
    core = (C * hd + 3 * C * hd + hd + 5 * 2 * NB * h * (h - 1) // 2 * hd
            + 3 * (blocks * 2 * sub + NB * 2 * h) * hd + 2 * C * hd
            + 5 * C * hd + 2 * hd * hd)
    products = 2 * (2 * C * hd * hd + C * (C - 1) // 2 * hd
                    + (blocks * sub * sub + NB * h * h) * hd)
    return chunks * core, chunks * products


def attention_err(got, want, tol: float) -> float:
    """The largest |got - want| / (tol * |want| + tol * min(1, RMS of
    want's row)), the row being one query position over heads and channels
    of a (B, S, H, hd) output: at most 1 where every element is within
    rtol = tol and the row-scaled atol (see the docstring)."""
    w = want.float()
    rms = w.square().mean(dim=(-2, -1), keepdim=True).sqrt().clamp(max=1.0)
    return float(((got.float() - w).abs() / (tol * (w.abs() + rms))).max())


def ptxas_entries(log: str) -> dict:
    """``nvcc -Xptxas -v``'s lines by kernel: the registers and shared
    memory (``Used ...``) and the spills (``... stack frame, ...``)."""
    entries, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("Used" in line or "spill" in line):
            entries.setdefault(fn, []).append(line.split(":")[-1].strip())
    return entries


def hgmma_counts(library: Path):
    """HGMMA instructions per kernel (by mangled name) in a built library's
    SASS (``cuobjdump -sass``); None where there is no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def dse_phase() -> None:
    """Phase 11: the design-space exploration on the card (see the
    docstring).  Raises on any failed check."""
    import shutil

    import torch

    from repro_torch.core import analyze, report_payload, symbolic
    from repro_torch.core.registry import get
    from repro_torch.dse import (ArtifactStore, DSEService, PoolManager,
                                 default_experiment)
    from repro_torch.kernels import cuda_lib
    from repro_torch.runtime import cuda_backend as cb
    from repro_torch.runtime import cuda_codegen as cg

    kernels = list(DSE_KERNELS)
    exp = default_experiment(
        "stencils-card", kernels=kernels,
        measure={"kernels": kernels, "repeats": DSE_REPEATS,
                 "max_points": 1})
    groups = exp.groups()
    total = sum(len(g.size_envs) for g in groups)
    # the measured points: the first size point of every group
    requested = {g.points()[0].key for g in groups}
    say(f"phase 11 experiment {exp.experiment_id}: {len(kernels)} kernels, "
        f"{len(groups)} groups, {total} points, {len(requested)} measured")
    root = ROOT / "build" / "dse"
    shutil.rmtree(root, ignore_errors=True)
    svc = DSEService(exp, ArtifactStore(str(root / "card")),
                     manager="inline")
    counted = {"ring_stencil": cuda_lib.RING_STENCIL,
               "addressable_step": cuda_lib.ADDRESSABLE_STEP}
    for k in counted.values():
        k.launches = 0
    acts = {}
    for act, budget in (("budgeted", DSE_BUDGET), ("resume", None),
                        ("verify", None)):
        t0 = time.perf_counter()
        summary = svc.run(max_points=budget)
        summary["host_s"] = time.perf_counter() - t0
        acts[act] = summary
        say(f"phase 11 act {act}: " + json.dumps(
            {k: summary[k] for k in ("points_total", "from_store",
                                     "computed", "errors", "stopped_early",
                                     "pending", "host_s")}))
        check(summary["errors"] == 0, f"DSE act {act}: {summary['errors']} "
              f"error point(s)")
    check(acts["budgeted"]["computed"] == DSE_BUDGET
          and acts["budgeted"]["stopped_early"],
          f"budgeted act: {acts['budgeted']}")
    check(acts["resume"]["computed"] == total - DSE_BUDGET
          and acts["resume"]["pending"] == 0, f"resume: {acts['resume']}")
    check(acts["verify"]["computed"] == 0
          and acts["verify"]["from_store"] == total,
          f"verify: {acts['verify']}")
    launches = {n: k.launches for n, k in counted.items()}

    points = list(svc.store.iter_points(exp.experiment_id))
    check(len(points) == total, f"{len(points)} points in the store")
    card = torch.cuda.get_device_name(0)
    measured = {p["key"]: p["measured"] for p in points if "measured" in p}
    check(set(measured) == requested,
          f"measured {len(measured)} of the {len(requested)} requested "
          f"points")
    skipped = [n for p in points for n in p["provenance"]["notes"]
               if n.startswith("measure skipped")]
    check(not skipped, f"measurements skipped: {skipped[:3]}")
    # what each mode's measurements launch: a warm-up and the repeats, one
    # ring launch a call, or one addressable launch a step
    want = {"ring_stencil": 0, "addressable_step": 0}
    for m in measured.values():
        check(m["device"] == card and m["mode"] in ("fifo-ring",
                                                    "addressable"),
              f"measurement on {m['device']} in mode {m['mode']}")
        check(0 < m["seconds"] < float("inf"), f"measured {m}")
        if m["mode"] == "fifo-ring":
            want["ring_stencil"] += m["calls"]
        else:
            want["addressable_step"] += m["calls"] * m["steps"]
    say(f"phase 11 launches in the acts: {json.dumps(launches)} (the "
        f"measurements' modes ask for {json.dumps(want)})")
    check(launches == want and launches["ring_stencil"] > 0,
          f"launches {launches}, measurements ask for {want}")

    # what each measured geometry computes, on the input it was timed on,
    # against the kernel's plain version (after the counted acts)
    geometries = sorted(
        {(g.kernel,) + tuple(measured[g.points()[0].key][k]
                             for k in ("mode", "n_items", "block", "steps"))
         for g in groups})
    worst = 0.0
    for kernel, mode, n, block, steps in geometries:
        p = cg.STENCIL_PROGRAMS[kernel]
        x = cb.measure_input(p, n, block, "cuda")
        got = cg.CompiledStencil(program=p, mode=mode)(x, steps, block)
        if mode == "fifo-ring":
            plain = cg._ring_plain(x, p, steps, block, steps + 1,
                                   2 * p.radius)
        else:
            plain = x
            for _ in range(steps):
                plain = cg._addressable_plain(plain, p)
        err = float((got.double() - plain.double()).abs().max())
        check(torch.allclose(got, plain, **TOL), f"phase 11 {kernel} {mode} "
              f"n {n} block {block} steps {steps}: err {err}")
        worst = max(worst, err)
    say(f"phase 11 the {len(geometries)} measured geometries, each held to "
        f"its plain version on the input it was timed on: max abs err "
        f"{worst:.3g}")

    bench = json.loads((ROOT / "BENCH_dse.json").read_text())["frontiers"]
    doc = svc.frontier()
    for kernel in kernels:
        kdoc = doc["kernels"][kernel]
        ref = bench.get(kernel, {})
        kms, by_tiling = {}, {}
        for g in groups:                # in the axes' order: b = 1..16
            m = measured[g.points()[0].key]
            if g.kernel == kernel:
                kms.setdefault(m["mode"], []).append(m["seconds"])
                # the ring's levels: (blocks + 1) x steps, each a barrier
                levels = (m["n_items"] // m["block"] + 1) * m["steps"]
                by_tiling.setdefault(g.topology, {})[g.tiling_id] = [
                    m["seconds"], m["n_items"], m["block"], m["steps"],
                    levels]
        say(f"phase 11 {kernel}: {kdoc['points']} points, frontier over "
            f"predicted_s {len(kdoc['predicted']['frontier'])} (TPU "
            f"reference {ref.get('frontier')}), over measured_s "
            f"{len(kdoc['measured']['frontier'])} (TPU reference "
            f"{ref.get('measured_frontier', 'none')}); measured s by mode, "
            f"median [min, max]: " + json.dumps(
                {mode: [statistics.median(t), min(t), max(t)]
                 for mode, t in kms.items()}))
        cells = [c for d in by_tiling.values() for c in d.values()]
        fit = statistics.linear_regression([c[4] for c in cells],
                                           [c[0] for c in cells])
        say(f"phase 11 {kernel} measured by tiling, [s, n, block, steps, "
            f"levels]: " + json.dumps(by_tiling) + f"; least squares s = "
            f"t0 + c x levels: t0 = {fit.intercept:.4g} s, c = "
            f"{fit.slope:.4g} s")

    # analysis time (a): jacobi-1d's template, then one evaluation a size,
    # each held to a concrete analysis at that size
    case = get("jacobi-1d")
    t0 = time.perf_counter()
    pa = analyze(case, sizes=symbolic).classify().fifoize().size().plan()
    pa.prepare()
    build_s = time.perf_counter() - t0
    check(pa.status == "symbolic", f"jacobi-1d template: {pa.status}")
    t = pa._template
    evals = []
    for k in range(3):
        env = {p: t["theta"][p] + k * t["strides"][p]
               for p in pa.symbolic_params}
        t0 = time.perf_counter()
        got = report_payload(pa.evaluate(**env))
        evals.append(time.perf_counter() - t0)
        want_doc = report_payload(
            analyze(case.kernel, params=env, tilings=case.tilings)
            .classify().fifoize().size().plan().report())
        check(got == want_doc, f"jacobi-1d template at {env} differs from "
              f"the concrete analysis")
    pa.release()
    say(f"phase 11 jacobi-1d parametric template: built in {build_s:.4f} s, "
        f"evaluated in {json.dumps(evals)} s at three lattice sizes (each "
        f"equal to a concrete analysis)")

    # the same grid, roofline only, through spawned pool workers while CUDA
    # is live in this process
    plain = default_experiment("stencils-card", kernels=kernels)
    pool = PoolManager(max_workers=DSE_POOL_WORKERS)
    try:
        check(pool._pool._mp_context.get_start_method() == "spawn",
              "the pool does not spawn its workers")
        t0 = time.perf_counter()
        psvc = DSEService(plain, ArtifactStore(str(root / "pool")),
                          manager=pool)
        summary = psvc.run()
        pool_s = time.perf_counter() - t0
    finally:
        pool.close()
    check(summary["errors"] == 0 and summary["computed"] == total,
          f"pool run: {summary}")

    def axes(docs) -> dict:
        return {p["key"]: (p["metrics"]["fifo_fraction"],
                           p["metrics"]["total_slots"]) for p in docs}

    card_axes = axes(points)
    pool_axes = axes(psvc.store.iter_points(plain.experiment_id))
    check(pool_axes == card_axes, "the pool run's (fifo_fraction, "
          "total_slots) differ from the inline run's")
    say(f"phase 11 pool run ({DSE_POOL_WORKERS} spawned workers, roofline "
        f"only): {summary['computed']} points in {pool_s:.3f} s host clock, "
        f"(fifo_fraction, total_slots) equal at every point")


def faults_phase(planned) -> dict:
    """Phase 12: the fault matrix with its wire faults replayed on the card
    by kernel 3, and the self-timed engine's capacity points (see the
    docstring).  ``planned(name)`` gives phase 2's analyses.  Returns the
    matrix's replay launches by kernel; raises on any failed check."""
    import torch

    from repro_torch.bench.selftimed_points import (deterministic, points,
                                                    targets)
    from repro_torch.core import analyze
    from repro_torch.core.registry import get
    from repro_torch.kernels import cuda_lib
    from repro_torch.runtime import cuda_backend as cb
    from repro_torch.runtime.lowering import backend
    from repro_torch.runtime.resilience import (FaultPlan, channel_lowerings,
                                                faults_validate, run_guarded,
                                                wire_faults)
    from repro_torch.runtime.selftimed import (execute_ppn,
                                               executable_capacities)

    bench = json.loads((ROOT / "BENCH_faults.json").read_text())
    want_st = json.loads((ROOT / "BENCH_selftimed.json").read_text())
    dev = torch.device("cuda")

    def matrix_analysis(name):           # bench_faults.py's _planned
        return analyze(get(name)).classify().fifoize().size(pow2=True)

    # the fault matrix, on the card, its replay launches counted
    cases, launched, matrix_s = {}, {}, {}
    t0 = time.perf_counter()
    for row in bench["matrix"]:
        name = row["kernel"]
        a = matrix_analysis(name)
        cuda_lib.REPLAY.launches = 0
        t1 = time.perf_counter()
        v = faults_validate(a)           # the card: no device named
        matrix_s[name] = time.perf_counter() - t1
        launched[name] = cuda_lib.REPLAY.launches
        ref = [r for r in v.trace_matrix if r["backend"] == "reference"]
        cud = [r for r in v.trace_matrix if r["backend"] == "cuda"]
        got = {"counts": {"injected": len(v.matrix) + len(ref),
                          "engine_cases": len(v.matrix),
                          "trace_cases": len(ref),
                          "recovered": v.recovered},
               "clean_guard_events": v.clean["guard_events"],
               "engine_cases": len(v.matrix), "trace_cases": len(ref)}
        check(got == {k: row[k] for k in got},
              f"phase 12 {name}: the matrix gave {got}, BENCH_faults.json "
              f"{row}")
        # faults_validate raises where a row is undetected or blames
        # another channel than the one injected; these hold it again
        check([r["fault"] for r in cud] == [r["fault"] for r in ref]
              and all(r["detected"] for r in cud),
              f"phase 12 {name}: cuda rows {cud}")
        cases[name] = wire_faults(a)
        edged = sum(1 for c in cases[name] if c.trace.num_edges)
        check(launched[name] == edged,
              f"phase 12 {name}: {launched[name]} replay launches for "
              f"{edged} cuda rows with edges")
    total_s = time.perf_counter() - t0
    n_rows = sum(len(c) for c in cases.values())
    say(f"phase 12 fault matrix: {len(cases)} kernels as BENCH_faults.json "
        f"has them, {n_rows} cuda rows detected, {sum(launched.values())} "
        f"replay launches (one a row with edges); host seconds "
        f"{total_s:.3f}, by kernel (faults_validate) "
        f"{json.dumps({k: round(t, 4) for k, t in matrix_s.items()})}")

    # kernel 3 against the sequential walk on every faulted event list
    n_events = 0
    for name, kernel_cases in cases.items():
        for c in kernel_cases:
            ev = cb.ring_events(c.trace)
            op = backend("cuda").implementation(c.lowering).order_op
            ts = [torch.from_numpy(x) for x in (ev.kind, ev.value, ev.slot)]
            got = cb.replay_events(*(t.to(dev) for t in ts), ev.ring,
                                   op).tolist()
            walk = cb._replay_walk(*ts, ev.ring, op).tolist()
            check(got == walk, f"phase 12 {name} {c.fault.spec()}: kernel "
                  f"{got}, walk {walk}")
            n_events += len(ev.kind)
    say(f"phase 12 kernel 3 equals the walk on all {n_rows} faulted event "
        f"lists ({n_events} events)")

    # the self-timed points
    want = {t["target"]: t for t in want_st["targets"]}
    t0 = time.perf_counter()
    walls = {}
    for label, ppn, caps in targets():
        got = points(ppn, caps)
        bounded = sum(1 for c in caps.values() if c is not None)
        check(bounded == want[label]["bounded_channels"],
              f"phase 12 {label}: {bounded} bounded channels")
        for point, row in got.items():
            ref = want[label]["points"][point]
            check(deterministic(row) == deterministic(ref),
                  f"phase 12 {label} {point}: {row} against {ref}")
        walls[label] = {p: r["wall_seconds"] for p, r in got.items()}
    points_s = time.perf_counter() - t0
    say(f"phase 12 self-timed points: {len(walls)} targets x 3 as "
        f"BENCH_selftimed.json has them; host seconds {points_s:.3f}, by "
        f"point {json.dumps(walls)}")

    # the main path's analyses, both modes, the faults' rows on the card
    for name in SIZES:
        a = planned(name)
        st = a.validate(mode="selftimed").selftimed
        check(st.report.completed, f"phase 12 {name}: {st.summary()}")
        cuda_lib.REPLAY.launches = 0
        r = a.validate(mode="faults").resilience
        check(r.trace_backends == ["reference", "cuda"]
              and cuda_lib.REPLAY.launches == sum(
                  1 for c in wire_faults(a) if c.trace.num_edges),
              f"phase 12 {name}: {r.summary()}, "
              f"{cuda_lib.REPLAY.launches} launches")
        say(f"phase 12 main path {name}: {st.summary()}; {r.summary()}")

    # the guarded run's cost over the plain one (bench_faults.py's overhead)
    for name in OVERHEAD_KERNELS:
        a = matrix_analysis(name)
        caps, lows = executable_capacities(a), channel_lowerings(a)

        def best(fn):
            times = []
            for _ in range(OVERHEAD_REPS):
                t1 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t1)
            return min(times)

        plain = best(lambda: execute_ppn(a.ppn, caps, policy="sequential"))
        guarded = best(lambda: run_guarded(a.ppn, caps, FaultPlan(), lows,
                                           policy="sequential"))
        say(f"phase 12 overhead {name}: plain {plain:.6f} s, guarded "
            f"{guarded:.6f} s host clock, {100 * (guarded / plain - 1):+.2f}%"
            f" (best of {OVERHEAD_REPS})")
    return launched


def _stage_fn(p, h):
    import torch
    return torch.tanh(h @ p["w"] + p["b"])


def _loss_head(h, tgt):
    import torch
    return torch.mean((h - tgt) ** 2)


def pipe_selections(stages: int, microbatches: int) -> dict:
    """Phase 13's three ways to pick the ring's lowering: the planner's
    records (which must select ``"ppermute"``), the reorder buffer by name,
    and the cuda backend's stream by qualified name."""
    from repro_torch.comm import PipelineSpec, analyze_pipeline, ring_lowering

    _, plans = analyze_pipeline(PipelineSpec(stages=stages,
                                             microbatches=microbatches))
    check(ring_lowering(plans) == "ppermute",
          f"the planner selects {ring_lowering(plans)!r}, not 'ppermute'")
    return {"plans": {"plans": plans},
            "reorder-buffer": {"lowering": "reorder-buffer"},
            "cuda:ppermute": {"lowering": "cuda:ppermute"}}


def pipe_inputs(shape: dict, seed: int):
    """Stacked stage parameters (numpy, as the reference's), inputs and
    targets from ``seed``; w's scale 2/sqrt(D) is the reference test's 0.5
    at D = 16."""
    import numpy as np

    S, D, M, mb = (shape[k] for k in ("S", "D", "M", "mb"))
    rng = np.random.default_rng(seed)
    normal = lambda *size: rng.standard_normal(size, dtype=np.float32)
    params = {"w": normal(S, D, D) * np.float32(2 / np.sqrt(D)),
              "b": normal(S, D) * np.float32(0.1)}
    return params, normal(M, mb, D), normal(M, mb, D)


def pipe_grads(group, params, xs, tg, kwargs: dict):
    """The pipeline's loss and gradients on ``group`` (``params``: the local
    block's tensors, `stage_params`)."""
    import torch

    from repro_torch.comm import pipeline_loss_fn

    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = pipeline_loss_fn(_stage_fn, _loss_head, group, **kwargs)(
        params, torch.as_tensor(xs).to(group.device),
        torch.as_tensor(tg).to(group.device))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def sequential_grads(params: dict, xs, tg):
    """The sequential composition (every microbatch through the stages in
    turn, the reference test's ``ref_loss``) and its gradients."""
    import torch

    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    S, M = params["w"].shape[0], xs.shape[0]
    total = 0.0
    for m in range(M):
        h = xs[m]
        for s in range(S):
            h = _stage_fn({k: v[s] for k, v in params.items()}, h)
        total = total + _loss_head(h, tg[m])
    loss = total / M
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def pipe_errors(got, want) -> dict:
    """Max abs error of the loss and of each gradient leaf."""
    out = {"loss": abs(float(got[0]) - float(want[0]))}
    for k, g in got[1].items():
        out[k] = float((g.double().cpu() - want[1][k].double().cpu())
                       .abs().max())
    return out


def dist_pipeline_rank(rank: int, inputs: str, out_dir: str) -> None:
    """One rank of a `DistGroup` pipeline (spawned by `run_ranks`): the
    three selections' loss and gradients of its stage, on card ``rank``
    under NCCL and on the CPU under gloo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.comm import DistGroup, stage_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)                # the ranks share the host
    data = np.load(inputs)
    group = DistGroup()
    want = (torch.device("cuda", rank) if dist.get_backend() == "nccl"
            else torch.device("cpu"))
    check(group.device == want, f"rank {rank} runs on {group.device}, "
          f"not {want}")
    params = stage_params({"w": data["w"], "b": data["b"]}, group)
    out = {}
    for name, kw in pipe_selections(len(data["w"]),
                                    len(data["xs"])).items():
        loss, grads = pipe_grads(group, params, data["xs"], data["tg"], kw)
        out[f"{name}/loss"] = loss.cpu().numpy()
        for k, g in grads.items():
            out[f"{name}/grad_{k}"] = g.cpu().numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def dist_pipeline_errors(world: int, backend: str, seed: int,
                         work: Path) -> dict:
    """The pipeline at the reference test's shape over ``world`` ranks of a
    ``backend`` `DistGroup` (one stage a rank; NCCL takes one card a rank),
    against the same code on a CPU ``LocalGroup(world)``: for each
    selection, the largest abs error of any rank's loss and of each
    gradient leaf, the ranks' stages stacked in rank order.  The ranks
    read their inputs from and write their stages to ``work``."""
    import shutil

    import numpy as np

    from repro_torch.comm import LocalGroup, run_ranks, stage_params

    shape = dict(PIPE_SMALL, S=world)
    params, xs, tg = pipe_inputs(shape, seed)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    np.savez(work / "inputs.npz", xs=xs, tg=tg, **params)
    run_ranks(dist_pipeline_rank, world, args=(str(work / "inputs.npz"),
                                               str(work)),
              backend=backend, timeout=300)
    ranks = [np.load(work / f"rank{r}.npz") for r in range(world)]
    cpu = LocalGroup(world, "cpu")
    out = {}
    for name, kw in pipe_selections(world, shape["M"]).items():
        want = pipe_grads(cpu, stage_params(params, cpu), xs, tg, kw)
        errs = {"loss": max(abs(float(r[f"{name}/loss"]) - float(want[0]))
                            for r in ranks)}
        for k, g in want[1].items():
            got = np.concatenate([r[f"{name}/grad_{k}"] for r in ranks])
            errs[k] = float(np.abs(got - g.numpy()).max())
        out[name] = errs
    return out


def pipeline_phase(seed: int, smi_line: str, dev=None) -> None:
    """Phase 13: the pipeline-parallel ring and the optimizers on the card
    (see the docstring), ``dev`` the card's device.  Raises on any failed
    check."""
    import numpy as np
    import torch

    from repro_torch.bench import cuda_ms
    from repro_torch.comm import LocalGroup, pipeline_train_step, stage_params
    from repro_torch.device import PEAK_FLOPS_FP32_PRODUCTS
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
    from repro_torch.optim.compression import compressed_psum_mean

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 13 runs with TF32 off")
    dev = torch.device("cuda" if dev is None else dev)
    for k in cuda_lib.KERNELS:
        k.launches = 0

    # the reference's shape: against the sequential composition on the
    # card and the same code on the CPU, then SGD steps
    S, M = PIPE_SMALL["S"], PIPE_SMALL["M"]
    card, cpu = LocalGroup(S, dev), LocalGroup(S, "cpu")
    params, xs, tg = pipe_inputs(PIPE_SMALL, seed)
    xs_d, tg_d = torch.from_numpy(xs).to(dev), torch.from_numpy(tg).to(dev)
    seq = sequential_grads(stage_params(params, card), xs_d, tg_d)
    for name, kw in pipe_selections(S, M).items():
        got = pipe_grads(card, stage_params(params, card), xs_d, tg_d, kw)
        check(got[0].device.type == dev.type, f"phase 13 {name} ran on "
              f"{got[0].device}")
        on_cpu = pipe_grads(cpu, stage_params(params, cpu), xs, tg, kw)
        err_seq, err_cpu = pipe_errors(got, seq), pipe_errors(got, on_cpu)
        check(max(err_seq.values()) <= PIPE_TOL
              and max(err_cpu.values()) <= PIPE_TOL,
              f"phase 13 {name}: against the sequential composition "
              f"{err_seq}, against the CPU {err_cpu} (tolerance {PIPE_TOL})")
        step = pipeline_train_step(_stage_fn, _loss_head, card, lr=PIPE_LR,
                                   **kw)
        p = stage_params(params, card)
        losses = []
        for _ in range(PIPE_SGD_STEPS):
            p, loss = step(p, xs_d, tg_d)
            losses.append(float(loss))
        check(losses[-1] < losses[0], f"phase 13 {name}: {PIPE_SGD_STEPS} "
              f"SGD steps did not lower the loss: {losses}")
        say(f"phase 13 {name} S={S} D={PIPE_SMALL['D']} M={M} "
            f"mb={PIPE_SMALL['mb']}: loss {float(got[0]):.7f}, max abs err "
            f"against the sequential composition {json.dumps(err_seq)}, "
            f"against the CPU {json.dumps(err_cpu)}; {PIPE_SGD_STEPS} SGD "
            f"steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}")

    # qwen2-7b's width: against the sequential composition, then one
    # pipeline_train_step per selection timed
    S, D, M, mb = (PIPE_WIDE[k] for k in ("S", "D", "M", "mb"))
    params, xs, tg = pipe_inputs(PIPE_WIDE, seed)
    params = stage_params(params, card)
    xs, tg = torch.from_numpy(xs).to(dev), torch.from_numpy(tg).to(dev)
    seq = sequential_grads(params, xs, tg)
    # a step runs S stages in each of M + S - 1 ticks, forward and backward
    # (twice the forward's products); M of the ticks carry microbatches, the
    # S - 1 others are the bubble's, whose products nothing uses
    flops = 3 * (M + S - 1) * S * 2 * mb * D * D
    useful = 3 * M * S * 2 * mb * D * D
    bound_ms = flops / PEAK_FLOPS_FP32_PRODUCTS * 1e3
    useful_ms = useful / PEAK_FLOPS_FP32_PRODUCTS * 1e3
    times, peaks = {}, {}
    for name, kw in pipe_selections(S, M).items():
        got = pipe_grads(card, params, xs, tg, kw)
        rel = {"loss": abs(float(got[0]) / float(seq[0]) - 1)}
        for k, g in got[1].items():
            want = seq[1][k]
            rel[k] = float((g - want).abs().max() / want.abs().max())
        check(max(rel.values()) <= PIPE_WIDE_RTOL, f"phase 13 {name} "
              f"D={D}: relative errors {rel} against the sequential "
              f"composition (tolerance {PIPE_WIDE_RTOL})")
        del got
        step = pipeline_train_step(_stage_fn, _loss_head, card, lr=PIPE_LR,
                                   **kw)
        times[name] = cuda_ms(lambda: step(params, xs, tg), PIPE_REPS)
        # the step's own peak, above what the phase holds already
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step(params, xs, tg)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        say(f"phase 13 {name} S={S} D={D} M={M} mb={mb} fp32: loss "
            f"{float(seq[0]):.7f}, relative errors against the sequential "
            f"composition {json.dumps(rel)}; pipeline_train_step "
            f"{times[name]:.3f} ms (median of {PIPE_REPS}, CUDA events), "
            f"{flops / times[name] / 1e9:.1f} TFLOP/s over {flops:.6g} "
            f"FLOP, {useful:.6g} of them on microbatches; bound "
            f"{bound_ms:.3f} ms for all of them, {useful_ms:.3f} ms for the "
            f"useful ones (operations, float32 products at three TF32 "
            f"passes), {times[name] / bound_ms:.2f}x and "
            f"{times[name] / useful_ms:.2f}x; peak {peaks[name]:.2f} GiB "
            f"above the weights and inputs")
    say(f"phase 13 reorder buffer / ppermute, one train step at D={D}: "
        f"{times['reorder-buffer'] / times['plans']:.4f} "
        f"(cuda:ppermute / ppermute {times['cuda:ppermute'] / times['plans']:.4f}); "
        f"{smi_line}")
    del params, xs, tg, seq

    # the optimizers on a stacked parameter: the card against the CPU
    rng = np.random.default_rng(seed + 1)
    p0 = 0.02 * rng.standard_normal(OPT_SHAPE, dtype=np.float32)
    # gradients whose global norm stays under clip_norm = 1, so the clip
    # scale is exactly 1 on both devices (see the docstring)
    grads = [1e-5 * rng.standard_normal(OPT_SHAPE, dtype=np.float32)
             for _ in range(OPT_STEPS)]
    lr_fn = cosine_warmup(3e-4, 100, 10000)
    for state_dtype in ("float32", "int8"):
        runs = []
        for d in (dev, torch.device("cpu")):
            params = {"w": torch.from_numpy(p0).to(d)}
            opt = adamw_init(params, state_dtype)
            for g in grads:
                params, opt, gnorm = adamw_update(
                    params, {"w": torch.from_numpy(g).to(d)}, opt,
                    lr_fn(opt["step"]), state_dtype=state_dtype)
            runs.append((params, opt, gnorm))
        (pc, oc, nc), (ph, oh, nh) = runs
        check(float(nc) < 1.0, f"phase 13 adamw: gnorm {float(nc)} clips")
        err = {"param": float((pc["w"].cpu() - ph["w"]).abs().max()),
               "gnorm": abs(float(nc) / float(nh) - 1)}
        for m in ("m", "v"):
            if state_dtype == "int8":
                check(torch.equal(oc[m]["w"]["q"].cpu(), oh[m]["w"]["q"]),
                      f"phase 13 adamw int8: {m} codes differ from the CPU's")
                err[m] = float((oc[m]["w"]["scale"].cpu()
                                - oh[m]["w"]["scale"]).abs().max()
                               / oh[m]["w"]["scale"].abs().max())
            else:
                err[m] = float((oc[m]["w"].cpu() - oh[m]["w"]).abs().max()
                               / oh[m]["w"].abs().max())
        check(err["param"] <= PIPE_TOL and max(err.values()) <= PIPE_TOL,
              f"phase 13 adamw {state_dtype}: against the CPU {err}")
        g_d = {"w": torch.from_numpy(grads[0]).to(dev)}
        ms = cuda_ms(lambda: adamw_update(pc, g_d, oc, 3e-4,
                                          state_dtype=state_dtype), PIPE_REPS)
        say(f"phase 13 adamw_update {state_dtype} {OPT_SHAPE}, "
            f"{OPT_STEPS} steps: against the CPU {json.dumps(err)}"
            f"{' (m and v codes equal)' if state_dtype == 'int8' else ''}; "
            f"one update {ms:.3f} ms on the card (median of {PIPE_REPS})")
        del runs, pc, oc, ph, oh, g_d

    g = rng.standard_normal(OPT_SHAPE, dtype=np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        gt = torch.from_numpy(g).to(d)
        outs.append(compressed_psum_mean(gt, torch.zeros_like(gt),
                                         LocalGroup(OPT_SHAPE[0], d)))
    (mean, err), on_cpu = outs
    gt = torch.from_numpy(g).to(dev)
    dev_exact = float((mean - gt.mean(0, keepdim=True)).abs().max())
    bound = float(gt.abs().max()) / 127.0
    check(dev_exact <= bound, f"phase 13 compressed mean off the exact mean "
          f"by {dev_exact} > max|g|/127 = {bound}")
    check(torch.equal(mean.cpu(), on_cpu[0])
          and torch.equal(err.cpu(), on_cpu[1]),
          "phase 13 compressed mean or error differs from the CPU's")
    ms = cuda_ms(lambda: compressed_psum_mean(gt, err, LocalGroup(
        OPT_SHAPE[0], dev)), PIPE_REPS)
    say(f"phase 13 compressed_psum_mean {OPT_SHAPE} on LocalGroup(4): "
        f"{dev_exact:.3g} off the exact mean (bound max|g|/127 = "
        f"{bound:.3g}), equal to the CPU's; {ms:.3f} ms on the card "
        f"(median of {PIPE_REPS})")
    del outs, mean, err, gt

    launched = {k.source.name: k.launches for k in cuda_lib.KERNELS}
    check(not any(launched.values()), f"phase 13 launched kernels: "
          f"{launched}")
    say(f"phase 13 kernel launches on the pipeline path: "
        f"{json.dumps(launched)}")

    # NCCL: one card a rank, so only where the machine has two or more
    count = torch.cuda.device_count()
    if count < 2:
        say(f"phase 13 NCCL DistGroup: not run, the machine has {count} "
            f"card (NCCL takes one card a rank, and refuses two ranks on "
            f"one)")
        return
    world = min(4, count)
    errs = dist_pipeline_errors(world, "nccl", seed,
                                ROOT / "build" / "pipeline_nccl")
    for name, err in errs.items():
        check(max(err.values()) <= PIPE_TOL, f"phase 13 NCCL {name} on "
              f"{world} cards: {err} against the CPU")
        say(f"phase 13 NCCL DistGroup {name}, {world} ranks on {world} "
            f"cards: max abs err against the CPU {json.dumps(err)}")


def unit_fan_in(layers: dict) -> None:
    """Rescale, in place, the stacked input projections (L, D, heads, hd)
    and output projections (L, heads, hd, D) of attention or the time-mix
    to std 1 / sqrt(fan-in of their contraction): D, and heads x hd.  The
    reference's init takes ``shape[-2]`` (the head count, the head width)
    as their fan-in, which at qwen2-7b's width gives layer 0 scores of RMS
    about 300 (see the docstring)."""
    for key in ("attn", "tm"):
        for name, w in layers.get(key, {}).items():
            if name in ("wq", "wk", "wv", "wr", "wg"):
                w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
            elif name == "wo":
                w.mul_((1.0 / w.shape[-3]) ** 0.5)


def model_phase(seed: int, smi_line: str, attn_device_ms: float,
                dev=None) -> dict:
    """Phase 14: the model path on the card (see the docstring), ``dev``
    the card's device and ``attn_device_ms`` kernel 5's device time per
    launch at qwen2-7b's width, S = 4096, bf16 (phase 10's row).  Returns
    each kernel's launches on the model path: the server's run and the
    rwkv train forward, counted from 0.  Raises on any failed check."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import cuda_ms
    from repro_torch.device import HBM_BW
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import MESH, draw_requests, serve
    import repro_torch.models.attention as attention_mod
    from repro_torch.models import Rules, build
    from repro_torch.models.attention import (_heads_out, _project_qkv,
                                              chunked_attention,
                                              self_attention)
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.models.rwkv import apply_time_mix
    from repro_torch.tree import tree_leaves, tree_map

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 14 runs with TF32 off")
    dev = torch.device("cuda" if dev is None else dev)
    rng = np.random.default_rng(seed)
    path = {k.source.stem: 0 for k in cuda_lib.KERNELS}

    def zero():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    def counted():
        return {k.source.stem: k.launches for k in cuda_lib.KERNELS}

    def tokens(B, S, vocab):
        return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(
            np.int32)).to(dev)

    def f32(tree):
        return tree_map(lambda a: a.float() if a.is_floating_point() else a,
                        tree)

    def rel_err(got, want) -> float:
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    def scaled_err(o, ref) -> float:
        """Kernel 5's output against the chunked form's at phase 7's bf16
        tolerance, both divided by the chunked output's RMS (see the
        docstring)."""
        rms = ref.float().square().mean().sqrt()
        return attention_err(o.float() / rms, ref.float() / rms,
                             ATTN_TOL[str(ref.dtype)])

    served_attn = []                      # (B, S, scaled_err) per call

    def checked_attention(q, k, v, causal=True):
        """`self_attention` (kernel 5), held to `chunked_attention` on the
        same q, k and v: the server's first run calls this instead."""
        o = self_attention(q, k, v, causal=causal)
        served_attn.append((q.shape[0], q.shape[1], scaled_err(
            o, chunked_attention(q, k, v, causal=causal))))
        return o

    # ---- qwen2-7b served at full width and depth, bf16
    bundle = configs.get(MODEL_ARCH)
    cfg = bundle.model
    model = build(cfg, bundle.parallel_for("decode_32k", multi_pod=False))
    rules = Rules.make(MESH, model.par)
    t0 = time.perf_counter()
    params = model.init(seed, dev)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in tree_leaves(params))
    say(f"phase 14 {MODEL_ARCH}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, H {cfg.num_heads}, KV {cfg.num_kv_heads}, hd "
        f"{cfg.head_dim_}, vocab {cfg.vocab_size}; {n_params:.4g} "
        f"parameters in bf16 drawn from seed {seed} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    runs = []
    for run in range(2):
        reqs = draw_requests(SERVE["requests"], cfg.vocab_size,
                             SERVE["max_new"], seed)
        zero()
        if run == 0:
            attention_mod.self_attention = checked_attention
        try:
            done, c = serve(model, params, reqs, SERVE["slots"],
                            SERVE["max_seq"], dev)
        finally:
            attention_mod.self_attention = self_attention
        launched = counted()
        served = sum(len(r.generated) for r in done)
        check(len(done) == SERVE["requests"] and all(r.done for r in done),
              f"phase 14 served {len(done)} of {SERVE['requests']}, "
              f"{sum(r.done for r in done)} finished")
        check(all(0 <= t < cfg.vocab_size for r in done
                  for t in r.generated), "phase 14: a token past the vocab")
        check(c["prefills"] == SERVE["requests"]
              and launched["flash_attention"] == cfg.num_layers
              * c["prefills"] and not any(
                  n for k, n in launched.items() if k != "flash_attention"),
              f"phase 14 serve: {json.dumps(launched)} launches for "
              f"{c['prefills']} prefill calls of {cfg.num_layers} layers")
        if run == 0:
            for k, n in launched.items():
                path[k] += n
            outputs = {r.rid: list(r.generated) for r in done}
            PHASE14["outputs"] = outputs
        else:
            check({r.rid: r.generated for r in done} == outputs,
                  "phase 14: the second run served other tokens")
        runs.append((served, c, launched["flash_attention"]))
    worst_served = max(e for _, _, e in served_attn)
    check(len(served_attn) == runs[0][2] and worst_served <= 1.0,
          f"phase 14 serve: kernel 5 against chunked_attention in "
          f"{len(served_attn)} prefill attention calls, worst {worst_served}"
          f" of phase 7's tolerance")
    say(f"phase 14 serve {MODEL_ARCH}: each of the first run's "
        f"{len(served_attn)} prefill attention calls (B = "
        f"{sorted({b for b, _, _ in served_attn})}, S = "
        f"{min(n for _, n, _ in served_attn)}-"
        f"{max(n for _, n, _ in served_attn)}, bf16) held to "
        f"chunked_attention on the same q, k, v: worst {worst_served:.3g} "
        f"of phase 7's tolerance on the data's scale")
    for run, (served, c, fa_launches) in enumerate(runs):
        say(f"phase 14 serve {MODEL_ARCH} ("
            f"{'first, checked' if run == 0 else 'warm'} run): "
            f"{SERVE['requests']} requests, {served} tokens in "
            f"{c['seconds']:.4f} s host clock, {served / c['seconds']:.2f} "
            f"tokens/s, {c['steps']} decode steps, occupancy "
            f"{c['slot_steps'] / max(c['steps'], 1):.2f}/{SERVE['slots']}, "
            f"{c['prefills']} prefill calls, kernel 5 launched "
            f"{fa_launches} times; {smi_line}")

    # ---- times: the prefill of 1 x 4096 and a decode step at B = 4
    S = MODEL_PREFILL_S
    toks = tokens(1, S, cfg.vocab_size)
    cache = model.init_cache(1, S, dev)
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: model.prefill_fn(
            params, {"tokens": toks}, rules, cache), MODEL_REPS)
    share = cfg.num_layers * attn_device_ms / prefill_ms
    say(f"phase 14 {MODEL_ARCH} prefill 1 x {S} tokens, bf16: "
        f"{prefill_ms:.3f} ms (CUDA events, median of {MODEL_REPS}); kernel "
        f"5: {cfg.num_layers} launches x {attn_device_ms:.4f} ms (phase 10's"
        f" device time) = {share:.4f} of it; {smi_line}")
    del cache
    B = SERVE["slots"]
    cache = model.init_cache(B, SERVE["max_seq"], dev)
    dtoks = tokens(B, 1, cfg.vocab_size)
    with torch.no_grad():
        decode_ms = cuda_ms(lambda: model.decode_fn(
            params, {"tokens": dtoks, "pos": SERVE["max_seq"] // 2}, cache,
            rules), DECODE_REPS)
    with torch.no_grad(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.decode_fn(params, {"tokens": dtoks,
                                     "pos": SERVE["max_seq"] // 2}, cache,
                            rules)
        torch.cuda.synchronize()
    # the device's kernels alone: an op's row carries the device time of
    # the kernels it launched too, so summing every row counts it twice
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    busy = (f"{device_us / 3e3:.3f} ms of device time a step "
            f"({device_us / 3e3 / decode_ms:.3f} of it busy; "
            f"{launches / 3:.0f} device kernels a step, torch.profiler)"
            if device_us else "device time not measured (the profiler "
            "recorded none)")
    weight_bytes = sum(a.numel() * a.element_size()
                       for a in tree_leaves(params))
    say(f"phase 14 {MODEL_ARCH} decode step, B = {B}, cache "
        f"{SERVE['max_seq']}: {decode_ms:.3f} ms (median of {DECODE_REPS}); "
        f"{busy}; its weights' bytes over the card's memory rate "
        f"{weight_bytes / HBM_BW * 1e3:.3f} ms; {smi_line}")
    del cache

    # ---- kernel 5 inside the model: one prefill attention layer, bf16
    lp = tree_map(lambda a: a[0], params["layers"])
    with torch.no_grad():
        x = apply_norm(lp["attn_norm"], embed_tokens(
            params["embed"], toks, cfg, rules), cfg)
        pos = torch.arange(S, device=dev)[None]
        q, k, v = _project_qkv(lp["attn"], x, cfg, rules, pos)
        zero()
        o = self_attention(q, k, v, causal=True)
        check(cuda_lib.FLASH_ATTENTION.launches == 1,
              "phase 14: attention() did not launch kernel 5")
        ref = chunked_attention(q, k, v, causal=True)
        tol = ATTN_TOL[str(q.dtype)]
        y, y_ref = _heads_out(o, lp["attn"]["wo"]), _heads_out(
            ref, lp["attn"]["wo"])
        rms = {n: float(a.float().square().mean().sqrt())
               for n, a in (("q", q), ("k", k), ("v", v), ("o", ref),
                            ("y", y_ref))}
        # phase 7's tolerance on the data's own scale (see the docstring)
        worst = attention_err(o / rms["o"], ref / rms["o"], tol)
        worst_y = attention_err(y[:, :, None] / rms["y"],
                                y_ref[:, :, None] / rms["y"], tol)
        raw = attention_err(o, ref, tol)
    check(worst <= 1.0 and worst_y <= 1.0,
          f"phase 14 kernel 5 in layer 0: {worst}, {worst_y} of the "
          f"tolerance")
    say(f"phase 14 {MODEL_ARCH} layer 0 prefill attention, B = 1, S = {S}, "
        f"bf16: kernel 5 against chunked_attention on the card, max abs "
        f"{float((o.float() - ref.float()).abs().max()):.3g}, RMS "
        + ", ".join(f"{n} {r:.4g}" for n, r in rms.items())
        + f"; on the data's scale {worst:.3g} of phase 7's tolerance "
        f"({raw:.3g} unscaled); after wo {worst_y:.3g} of it")
    del x, q, k, v, o, ref, y, y_ref
    # prompts shorter than one 128-row tile, B = 4 (a tensor map per
    # sequence), each row its own tokens
    short = {}
    with torch.no_grad():
        for n in SHORT_S:
            x = apply_norm(lp["attn_norm"], embed_tokens(
                params["embed"], tokens(SHORT_B, n, cfg.vocab_size), cfg,
                rules), cfg)
            pos = torch.arange(n, device=dev)[None].expand(SHORT_B, n)
            q, k, v = _project_qkv(lp["attn"], x, cfg, rules, pos)
            short[n] = scaled_err(self_attention(q, k, v, causal=True),
                                  chunked_attention(q, k, v, causal=True))
    check(max(short.values()) <= 1.0, f"phase 14 kernel 5 in layer 0 at "
          f"B = {SHORT_B}: {short} of the tolerance")
    say(f"phase 14 {MODEL_ARCH} layer 0 prefill attention, B = {SHORT_B}, "
        f"bf16, kernel 5 against chunked_attention on the data's scale: "
        + ", ".join(f"S = {n} {e:.3g}" for n, e in short.items())
        + " of phase 7's tolerance")
    del x, q, k, v, lp

    # ---- float32 at full width: prefill S - 1 through kernel 5, decode S
    params = f32(params)                  # the bf16 leaves go as they cast
    torch.cuda.empty_cache()
    B, S = PAIR["B"], PAIR["S"]
    ptoks = tokens(B, S, cfg.vocab_size)

    def pair():
        with torch.no_grad():
            full = model.forward(params, {"tokens": ptoks}, rules,
                                 "train")[0][:, -1]
            cache = f32(model.init_cache(B, S, dev))
            _, cache = model.prefill_fn(params, {"tokens": ptoks[:, :S - 1]},
                                        rules, cache)
            dec, _ = model.decode_fn(params, {"tokens": ptoks[:, S - 1:],
                                              "pos": S - 1}, cache, rules)
        dec = dec[:, 0]
        return (rel_err(dec, full), int((dec.argmax(-1)
                                         == full.argmax(-1)).sum()),
                float(full.abs().max()))

    ref_err, ref_top1, _ = pair()
    unit_fan_in(params["layers"])
    err, top1, top = pair()
    check(err <= PAIR_REL and top1 == B, f"phase 14 {MODEL_ARCH} float32 "
          f"prefill/decode against the forward: {err} of the largest logit, "
          f"top-1 equal in {top1} of {B} rows")
    say(f"phase 14 {MODEL_ARCH} float32, B = {B}: prefill {S - 1} tokens "
        f"(kernel 5) and decode token {S} (decode_attention) against the "
        f"forward's logits at {S - 1}, projections at unit fan-in: "
        f"{err:.4g} of the largest logit ({top:.4g}; bar {PAIR_REL}), top-1 "
        f"equal in {top1} of {B} rows; with the reference's init (not "
        f"gated) {ref_err:.4g}, top-1 equal in {ref_top1}")
    del params, model
    torch.cuda.empty_cache()

    # ---- rwkv6-1.6b at full width, float32
    bundle = configs.get(RWKV_ARCH)
    rcfg = bundle.model
    model = build(rcfg, bundle.parallel_for("decode_32k", multi_pod=False))
    rules = Rules.make(MESH, model.par)
    params = f32(model.init(seed, dev))
    rtoks = tokens(1, RWKV_S, rcfg.vocab_size)

    def rwkv_errors(p, train):
        with torch.no_grad():
            cache = f32(model.init_cache(1, RWKV_S, dev))
            zero()
            pre = model.forward(p, {"tokens": rtoks}, rules, "prefill",
                                cache)[0]
            check(not any(counted().values()), "phase 14: rwkv prefill with "
                  "a cache launched a kernel")
            cache = f32(model.init_cache(1, RWKV_PREFIX, dev))
            steps = []
            for t in range(RWKV_PREFIX):
                lg, cache = model.decode_fn(p, {
                    "tokens": rtoks[:, t:t + 1], "pos": t}, cache, rules)
                steps.append(lg[:, 0])
            steps = torch.stack(steps, dim=1)
        check(all(bool(torch.isfinite(a).all()) for a in (train, pre, steps)),
              f"phase 14 {RWKV_ARCH}: logits not finite")
        return {"train vs prefill": rel_err(train, pre),
                "stepwise vs train": rel_err(steps, train[:, :RWKV_PREFIX]),
                "stepwise vs prefill": rel_err(steps,
                                               pre[:, :RWKV_PREFIX])}

    def train_forward(p=None):
        with torch.no_grad():
            return model.forward(params if p is None else p,
                                 {"tokens": rtoks}, rules, "train")[0]

    zero()
    train = train_forward()
    torch.cuda.synchronize()
    launched = counted()
    check(launched["gla_timemix"] == rcfg.num_layers and not any(
        n for k, n in launched.items() if k != "gla_timemix"),
        f"phase 14 {RWKV_ARCH} train forward: {json.dumps(launched)}")
    for k, n in launched.items():
        path[k] += n
    train_ms = cuda_ms(train_forward, MODEL_REPS)
    ref_errs = rwkv_errors(params, train)
    del train
    # the projections at unit fan-in and the bonus u drawn N(0, 1) (the
    # reference's init sets it to 0), then the model cut to its first n
    # layers (the stack loops over the stacked parameters' leading
    # dimension, so a slice of them is a shallower model)
    unit_fan_in(params["layers"])
    tm = params["layers"]["tm"]
    tm["u"].copy_(torch.from_numpy(rng.standard_normal(tuple(
        tm["u"].shape)).astype(np.float32)))
    depth_errs = {}
    for n in RWKV_DEPTHS + (rcfg.num_layers,):
        cut = dict(params, layers=tree_map(lambda a: a[:n],
                                           params["layers"]))
        depth_errs[n] = rwkv_errors(cut, train_forward(cut))
    # layer 0's time-mix: kernel 6 against the chunked form from a zero
    # state, over RWKV_DRAWS draws of the tokens and of layer 0's u
    lp = tree_map(lambda a: a[0], params["layers"])
    H, hd = rcfg.num_heads, rcfg.head_dim_
    zero_state = {"shift": torch.zeros((1, rcfg.d_model), device=dev),
                  "state": torch.zeros((1, H, hd, hd), device=dev)}
    tm_errs = []
    with torch.no_grad():
        for _ in range(RWKV_DRAWS):
            lp["tm"]["u"].copy_(torch.from_numpy(rng.standard_normal(
                (H, hd)).astype(np.float32)))
            h = apply_norm(lp["tm_norm"], embed_tokens(
                params["embed"], tokens(1, RWKV_S, rcfg.vocab_size), rcfg,
                rules), rcfg)
            got, _ = apply_time_mix(lp["tm"], h, rcfg, rules, "train", None)
            want, _ = apply_time_mix(lp["tm"], h, rcfg, rules, "prefill",
                                     dict(zero_state))
            tm_errs.append(rel_err(got, want))
    shallow = max(max(depth_errs[n].values()) for n in RWKV_DEPTHS)
    check(max(tm_errs) <= RWKV_TM_REL and shallow <= RWKV_SHALLOW_REL
          and max(depth_errs[rcfg.num_layers].values()) <= RWKV_REL,
          f"phase 14 {RWKV_ARCH}: layer 0's time-mix {tm_errs} (bar "
          f"{RWKV_TM_REL}), by depth {depth_errs} (bars {RWKV_SHALLOW_REL} "
          f"at {RWKV_DEPTHS} layers, {RWKV_REL} at {rcfg.num_layers})")
    say(f"phase 14 {RWKV_ARCH} float32, S = {RWKV_S}: train forward "
        f"{launched['gla_timemix']} launches of kernel 6, {train_ms:.3f} ms "
        f"(median of {MODEL_REPS}); {smi_line}")
    say(f"phase 14 {RWKV_ARCH} layer 0 time-mix, S = {RWKV_S}, kernel 6 "
        f"against the chunked form, of the largest output, {RWKV_DRAWS} "
        f"draws of tokens and u: " + ", ".join(f"{e:.4g}" for e in tm_errs)
        + f" (bar {RWKV_TM_REL})")
    for n, errs in depth_errs.items():
        say(f"phase 14 {RWKV_ARCH} cut to {n} layers, against the chunked "
            f"prefill and the stepwise recurrence over {RWKV_PREFIX} tokens,"
            f" of the largest logit, projections at unit fan-in, u drawn: "
            + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
            + f" (bar {RWKV_REL if n == rcfg.num_layers else RWKV_SHALLOW_REL})")
    say(f"phase 14 {RWKV_ARCH} with the reference's init, {rcfg.num_layers} "
        f"layers (not gated): " + ", ".join(
            f"{k} {v:.4g}" for k, v in ref_errs.items()))
    del params, model, lp, h, got, want
    torch.cuda.empty_cache()
    say(f"phase 14 kernel launches on the model path: {json.dumps(path)}")
    return path

def _products_params(model) -> int:
    """Parameters that enter a product once a token: all of them but an
    untied embedding table, which is a lookup."""
    from repro_torch.tree import tree_leaves
    n = sum(a.numel() for a in tree_leaves(model.abstract_params()))
    if not model.cfg.tie_embeddings:
        n -= model.cfg.padded_vocab() * model.cfg.d_model
    return n


def train_phase(seed: int, smi_line: str, dev=None) -> dict:
    """Phase 15: the train path on the card (see the docstring), ``dev``
    the card's device.  Returns each kernel's launches on the train path:
    smollm-135m's three `train()` calls and its timed steps, and
    rwkv6-1.6b's steps, counted from 0 (not the gradient checks).  Raises
    on any failed check."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import cuda_ms
    from repro_torch.configs.base import reduced
    from repro_torch.device import PEAK_FLOPS_BF16
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    from repro_torch.kernels.gla_timemix.kernel import (gla_timemix,
                                                        timemix_from_zero)
    from repro_torch.launch.train import MESH
    from repro_torch.models import Rules, build
    from repro_torch.models.common import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import train
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 15 runs with TF32 off")
    dev = torch.device("cuda" if dev is None else dev)
    rng = np.random.default_rng(seed + 15)
    path = {k.source.stem: 0 for k in cuda_lib.KERNELS}

    def zero():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    def counted():
        return {k.source.stem: k.launches for k in cuda_lib.KERNELS}

    def only(launched, kernel, n, what):
        check(launched[kernel] == n and not any(
            c for k, c in launched.items() if k != kernel),
            f"phase 15 {what}: {json.dumps(launched)}, expected {n} "
            f"launches of {kernel} and none of another kernel")

    def on_path():
        for k, n in counted().items():
            path[k] += n

    def rel(got, want) -> float:
        got, want = got.detach().cpu().float(), want.detach().cpu().float()
        return float((got - want).abs().max()
                     / max(float(want.abs().max()), 1e-30))

    def draw(shape, dtype, scale=1.0, grad=True):
        t = torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)
        return t.requires_grad_(grad)

    def kernel_of(cfg):
        return "gla_timemix" if cfg.family == "ssm" else "flash_attention"

    # ---- 1. gradients at the reduced configs, float32, card against CPU
    B, S, m = TRAIN_SMALL["B"], TRAIN_SMALL["S"], TRAIN_SMALL["m"]
    for arch in (TRAIN_ARCH, RWKV_ARCH):
        bundle = configs.get(arch)
        par = bundle.parallel_for("train_4k", multi_pod=False).replace(
            num_microbatches=m)
        model = build(reduced(bundle.model), par)
        rules = Rules.make(MESH, par)
        L, kernel = model.cfg.num_layers, kernel_of(model.cfg)
        host = tree_map(lambda a: a.float().numpy(), model.init(seed, "cpu"))
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (B, S)).astype(np.int32))

        def grads(device):
            p = tree_map(lambda a: a.requires_grad_(a.is_floating_point()),
                         params_from_numpy(host, device))
            total, _ = model.loss_fn(p, {"tokens": toks.to(device)}, rules)
            total.backward()
            return total, dict(tree_items(p))

        want_total, want = grads("cpu")
        zero()
        got_total, got = grads(dev)
        torch.cuda.synchronize()
        only(counted(), kernel, 2 * L, f"{arch} reduced loss_fn backward")
        missing = [k for k, p in got.items() if p.grad is None]
        check(not missing, f"phase 15 {arch}: no gradient on the card for "
              f"{missing}")
        errs = {k: rel(got[k].grad, want[k].grad) for k in want}
        worst = max(errs, key=errs.get)
        loss_err = rel(got_total, want_total)
        check(errs[worst] <= TRAIN_GRAD_REL and loss_err <= TRAIN_GRAD_REL,
              f"phase 15 {arch}: gradients against the CPU's {errs}, loss "
              f"{loss_err} (bar {TRAIN_GRAD_REL})")
        step = make_train_step(model, rules, lr=1e-3).step_fn

        def one_step(device):
            p = params_from_numpy(host, device)
            return step({"params": p, "opt": adamw_init(p)},
                        {"tokens": toks.to(device)})[1]

        want_m = one_step("cpu")
        zero()
        got_m = one_step(dev)
        torch.cuda.synchronize()
        only(counted(), kernel, 2 * L * m, f"{arch} reduced train step")
        step_errs = {k: rel(got_m[k], want_m[k])
                     for k in ("loss", "grad_norm")}
        check(max(step_errs.values()) <= TRAIN_GRAD_REL,
              f"phase 15 {arch}: train step against the CPU's {step_errs}")
        say(f"phase 15 {arch} reduced, float32, B = {B}, S = {S}: "
            f"loss_fn backward on the card, {len(got)} leaves each with a "
            f"gradient, {kernel} launched {2 * L} times ({L} layers, "
            f"forward and remat's recompute); of each leaf's largest entry "
            f"against the CPU's, worst {errs[worst]:.3g} ({worst}), loss "
            f"{loss_err:.3g}; one train step at m = {m}: loss "
            f"{step_errs['loss']:.3g}, grad_norm "
            f"{step_errs['grad_norm']:.3g} (bar {TRAIN_GRAD_REL})")
        del got, want

    # ---- 2. kernels 5 and 6 differentiated at full width
    fwd_ms = {}
    for (B, S, H, KV, hd) in GRAD_ATTN:
        q = draw((B, S, H, hd), torch.bfloat16)
        k, v = (draw((B, S, KV, hd), torch.bfloat16) for _ in range(2))
        g = draw((B, S, H, hd), torch.bfloat16, grad=False)
        out = flash_attention(q, k, v, causal=True)
        got = torch.autograd.grad(out, (q, k, v), g)
        ref = chunked_attention(q, k, v, causal=True)
        want = torch.autograd.grad(ref, (q, k, v), g)
        f_err = attention_err(out.detach(), ref.detach(),
                              ATTN_TOL[str(ref.dtype)])
        g_errs = [rel(a, b) for a, b in zip(got, want)]
        check(f_err <= 1.0 and max(g_errs) <= 1e-6,
              f"phase 15 kernel 5 at B={B} S={S} H={H} KV={KV} hd={hd}: "
              f"forward {f_err} of phase 7's tolerance, gradients {g_errs}")
        del out, ref, got, want
        with torch.no_grad():
            fwd_ms[(B, S, H, KV, hd)] = cuda_ms(lambda: flash_attention(
                q, k, v, causal=True), TRAIN_REPS)
        out = flash_attention(q, k, v, causal=True)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (q, k, v), g, retain_graph=True), TRAIN_REPS)
        say(f"phase 15 kernel 5 differentiated, B = {B}, S = {S}, H = {H}, "
            f"KV = {KV}, hd = {hd}, bf16, causal: forward (the kernel) "
            f"{fwd_ms[(B, S, H, KV, hd)]:.4f} ms, backward (chunked_attention"
            f" recomputed and differentiated) {bwd_ms:.3f} ms (CUDA events, "
            f"median of {TRAIN_REPS}); forward {f_err:.3g} of phase 7's "
            f"tolerance, gradients of q, k, v against chunked_attention's "
            f"autograd " + ", ".join(f"{e:.3g}" for e in g_errs)
            + f"; {smi_line}")
        del q, k, v, g, out
        torch.cuda.empty_cache()
    B, S, H, hd = (GRAD_GLA[k] for k in ("B", "S", "H", "hd"))
    r, k, v = (draw((B, S, H, hd), torch.float32, hd ** -0.5)
               for _ in range(3))
    logw = (-torch.exp(draw((B, S, H, hd), torch.float32, grad=False))
            ).requires_grad_()
    u = draw((H, hd), torch.float32)
    ins = (r, k, v, logw, u)
    g = draw((B, S, H, hd), torch.float32, grad=False)
    out = gla_timemix(*ins, chunk=GLA_CHUNK)
    got = torch.autograd.grad(out, ins, g)
    ref = timemix_from_zero(*ins, GLA_CHUNK)
    want = torch.autograd.grad(ref, ins, g)
    g_errs = [rel(a, b) for a, b in zip(got, want)]
    check(torch.allclose(out, ref, **GLA_TOL) and max(g_errs) <= 1e-6,
          f"phase 15 kernel 6 at {GRAD_GLA}: forward off the chunked form "
          f"by {float((out - ref).detach().abs().max())}, gradients "
          f"{g_errs}")
    del got, want, ref
    with torch.no_grad():
        gla_ms = cuda_ms(lambda: gla_timemix(*ins, chunk=GLA_CHUNK),
                         TRAIN_REPS)
    out = gla_timemix(*ins, chunk=GLA_CHUNK)
    gla_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, ins, g, retain_graph=True), TRAIN_REPS)
    say(f"phase 15 kernel 6 differentiated, B = {B}, S = {S}, H = {H}, hd = "
        f"{hd}, chunk {GLA_CHUNK}, float32: forward (the kernel) "
        f"{gla_ms:.4f} ms, backward (the chunked form recomputed from a "
        f"zero state and differentiated) {gla_bwd_ms:.3f} ms (median of "
        f"{TRAIN_REPS}); gradients of r, k, v, logw, u against the chunked "
        f"form's autograd " + ", ".join(f"{e:.3g}" for e in g_errs)
        + f"; {smi_line}")
    del r, k, v, logw, u, ins, g, out
    torch.cuda.empty_cache()

    # ---- 3. smollm-135m trained at full width and depth, bf16
    bundle = configs.get(TRAIN_ARCH)
    cfg = bundle.model
    par = bundle.parallel_for("train_4k", multi_pod=False)
    model = build(cfg, par)
    rules = Rules.make(MESH, par)
    L = cfg.num_layers
    per_step = 2 * L * par.num_microbatches
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(ckpt_dir=str(ckpt), seed=seed, ckpt_every=TRAIN_CKPT_EVERY,
              lr=TRAIN_LR, device=dev)
    runs = []
    for steps, fail_at in ((TRAIN_STEPS, None), (RESUME_STEPS, None),
                           (REPLAY_STEPS, REPLAY_FAIL)):
        zero()
        t0 = time.perf_counter()
        rep = train(model, rules, steps=steps, fail_at=fail_at, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counted()
        on_path()
        check(rep.steps_run == steps and len(rep.losses) == steps
              and all(math.isfinite(x) for x in rep.losses),
              f"phase 15 {TRAIN_ARCH} train(steps={steps}): {rep}")
        runs.append((rep, secs, launched))
    (first, s1, l1), (second, s2, l2), (third, s3, l3) = runs
    start3 = TRAIN_STEPS + RESUME_STEPS
    only(l1, "flash_attention", per_step * TRAIN_STEPS, "first train()")
    only(l2, "flash_attention", per_step * RESUME_STEPS, "resumed train()")
    # the replay: the steps before the fault, then all REPLAY_STEPS again
    only(l3, "flash_attention",
         per_step * (REPLAY_STEPS + REPLAY_FAIL - start3), "replayed train()")
    head = statistics.mean(first.losses[:5])
    tail = statistics.mean(first.losses[-5:])
    steps_kept = sorted(int(p.name.split("_")[1]) for p in ckpt.glob("step_*"))
    check(first.restored_from is None and second.restored_from == TRAIN_STEPS
          and third.restored_from == start3 and tail < head
          and steps_kept == [TRAIN_STEPS, start3, start3 + REPLAY_STEPS],
          f"phase 15 {TRAIN_ARCH}: restored from {first.restored_from}, "
          f"{second.restored_from}, {third.restored_from}; loss of the first "
          f"5 steps {head}, of the last 5 {tail}; checkpoints {steps_kept}")
    shutil.rmtree(ckpt, ignore_errors=True)
    n_params = sum(a.numel() for a in tree_leaves(model.abstract_params()))
    say(f"phase 15 {TRAIN_ARCH}: {L} layers, d_model {cfg.d_model}, "
        f"{n_params:.4g} parameters in bf16, parallel_for('train_4k') (m = "
        f"{par.num_microbatches}, remat {par.remat}, moments "
        f"{par.optimizer_state_dtype}), train()'s 8 x 128 batches, lr "
        f"{TRAIN_LR}: {TRAIN_STEPS} steps in {s1:.2f} s host clock (init and "
        f"checkpoints at {TRAIN_CKPT_EVERY} and {TRAIN_STEPS} included), "
        f"loss {first.losses[0]:.4f} -> {first.losses[-1]:.4f} (mean of the "
        f"first 5 {head:.4f}, of the last 5 {tail:.4f}); resumed from step "
        f"{second.restored_from} for {RESUME_STEPS} steps in {s2:.2f} s; "
        f"a fault at step {REPLAY_FAIL} restored step {start3} and replayed, "
        f"{REPLAY_STEPS} steps in {s3:.2f} s, final loss "
        f"{third.final_loss:.4f}; kernel 5 launched {per_step} times a step")

    def timed_steps(model, rules, Bt, St, reps, ops=True):
        """``reps`` steps after a warm-up at Bt x St: (median ms, peak bytes,
        launches a step, the last step's metrics, a profiled step's
        summary).  ``ops``: the profile records the host's ops too, which
        attributes device time to the kernel's backward; without them it
        records the device's kernels alone (rwkv6-1.6b's step queues some
        160,000, and its op events cost minutes to summarise)."""
        box = {"state": init_train_state(model, seed, dev)}
        step_fn = make_train_step(model, rules, lr=TRAIN_LR).step_fn
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (Bt, St)).astype(np.int32)).to(dev)

        def one():
            box["state"], box["metrics"] = step_fn(box["state"],
                                                   {"tokens": toks})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        ms = cuda_ms(one, reps)
        launched = counted()
        on_path()
        peak = torch.cuda.max_memory_allocated()
        kernel = kernel_of(model.cfg)
        only(launched, kernel, (reps + 1) * 2 * model.cfg.num_layers
             * model.par.num_microbatches, f"{model.cfg.name} timed steps")
        met = box["metrics"]
        check(math.isfinite(float(met["loss"]))
              and math.isfinite(float(met["grad_norm"])),
              f"phase 15 {model.cfg.name}: step metrics {met}")
        # one more step under torch.profiler: the device's busy share, its
        # kernels a step and, with ``ops``, the kernel's backward (the
        # chunked form's recompute and autograd) in device time
        activities = [torch.profiler.ProfilerActivity.CUDA]
        if ops:
            activities.append(torch.profiler.ProfilerActivity.CPU)
        with torch.profiler.profile(activities=activities) as prof:
            one()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3
        backward_ms = sum(e.device_time_total for e in events if e.key in (
            "_FlashAttentionBackward", "_GlaTimemixBackward")) / 1e3
        backward = (f", the kernel's backward {backward_ms:.1f} ms of it "
                    f"({backward_ms / max(device_ms, 1e-9):.3f})" if ops
                    else ", the kernel's backward's share not measured")
        trace = (f"device {device_ms:.1f} ms a step (busy {device_ms / ms:.3f}"
                 f", {sum(e.count for e in device)} device kernels"
                 f"{backward}; torch.profiler)"
                 if device_ms else "device time not measured (the profiler "
                 "recorded none)")
        del box
        torch.cuda.empty_cache()
        return ms, peak, launched[kernel] // (reps + 1), met, trace

    Bt, St = TRAIN_STEP["B"], TRAIN_STEP["S"]
    ms, peak, launches, met, trace = timed_steps(model, rules, Bt, St,
                                                 TRAIN_REPS)
    H, hd = cfg.num_heads, cfg.head_dim_
    flops = (6 * _products_params(model) * Bt * St
             + 2 * Bt * H * St * St * hd * L * 3)
    bound_ms = flops / PEAK_FLOPS_BF16 * 1e3
    k5 = fwd_ms[(Bt, St, H, cfg.num_kv_heads, hd)]
    say(f"phase 15 {TRAIN_ARCH} train step, B = {Bt}, S = {St}, bf16: "
        f"{ms:.2f} ms (CUDA events, median of {TRAIN_REPS} after a warm-up),"
        f" {Bt * St / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, loss {float(met['loss']):.4f}; kernel 5 "
        f"{launches} launches a step x {k5:.4f} ms = "
        f"{launches * k5 / ms:.4f} of the step; {trace}; the products' "
        f"bound {flops:.4g} FLOP at bf16's {PEAK_FLOPS_BF16:.4g} FLOP/s = "
        f"{bound_ms:.3f} ms, the step {ms / bound_ms:.1f}x it; {smi_line}")
    del model
    torch.cuda.empty_cache()

    # ---- 4. rwkv6-1.6b at full width and depth, bf16: one step
    bundle = configs.get(RWKV_ARCH)
    cfg = bundle.model
    par = bundle.parallel_for("train_4k", multi_pod=False)
    model = build(cfg, par)
    rules = Rules.make(MESH, par)
    Bt, St = RWKV_STEP["B"], RWKV_STEP["S"]
    ms, peak, launches, met, trace = timed_steps(model, rules, Bt, St,
                                                 RWKV_STEP_REPS, ops=False)
    n_prod = _products_params(model)
    flops = 6 * n_prod * Bt * St
    bound_ms = flops / PEAK_FLOPS_BF16 * 1e3
    say(f"phase 15 {RWKV_ARCH} train step, {cfg.num_layers} layers, "
        f"B = {Bt}, S = {St}, bf16 parameters, moments "
        f"{par.optimizer_state_dtype}: {ms:.2f} ms (median of "
        f"{RWKV_STEP_REPS} after a warm-up), {Bt * St / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, loss {float(met['loss']):.4f}; kernel 6 "
        f"{launches} launches a step; {trace}; the products' bound 6 x "
        f"{n_prod:.4g} parameters (less the embedding lookup) x {Bt * St} "
        f"tokens = {flops:.4g} FLOP at bf16's rate = {bound_ms:.3f} ms, the step "
        f"{ms / bound_ms:.1f}x it; {smi_line}")
    del model
    torch.cuda.empty_cache()
    say(f"phase 15 kernel launches on the train path: {json.dumps(path)}")
    return path


def _flops_products(cfg, T: int, S: int) -> float:
    """Operations of a prefill's products over T = B x S tokens (causal
    attention, every logit): the attention projections and scores, the
    dense MLPs, the MoE router and the experts over their capacity slots
    (E x cap rows a layer, 1.25 times the routed T x K), the Mamba
    projections and the unembedding."""
    from repro_torch.models.moe import capacity
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    attn = 2 * T * D * (2 * H + 2 * KV) * hd + 2 * (T // S) * H * S * S * hd
    mlp = 2 * T * 3 * D * F
    moe = (2 * T * D * cfg.num_experts
           + 2 * cfg.num_experts * capacity(T, cfg) * 3 * D * F)
    di, ds = cfg.ssm_expand * D, cfg.ssm_state_dim
    mamba = 2 * T * (D * 2 * di + di * 2 * ds + di * di + di * D)
    total = 2 * T * D * V
    for j in range(cfg.num_layers):
        if cfg.family == "hybrid":
            total += attn if j % cfg.attn_period == cfg.attn_period // 2 \
                else mamba
            total += moe if j % cfg.moe_every == \
                cfg.moe_offset % cfg.moe_every else mlp
        else:
            total += attn + (moe if cfg.num_experts else mlp)
    return float(total)


def family_phase(seed: int, smi_line: str, dev=None) -> dict:
    """Phase 16: the moe, hybrid and encoder-decoder families on the card
    (see the docstring), ``dev`` the card's device.  Returns each kernel's
    launches on the family path: the first serving run of each of the
    three models and whisper-medium's train forward, counted from 0.
    Raises on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import cuda_ms
    from repro_torch.bench.family_parity import (FAMILY_INT8_DECODE,
                                                 FAMILY_QK_SCALE,
                                                 FAMILY_SMALL, family_parity)
    from repro_torch.configs.base import reduced
    from repro_torch.device import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import MESH, draw_requests, serve
    import repro_torch.models.attention as attention_mod
    from repro_torch.models import Rules, build
    from repro_torch.models.attention import (_project_qkv,
                                              chunked_attention,
                                              self_attention)
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.models.moe import apply_moe, capacity
    from repro_torch.models.ssm import apply_mamba
    from repro_torch.tree import tree_leaves, tree_map

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 16 runs with TF32 off")
    dev = torch.device("cuda" if dev is None else dev)
    rng = np.random.default_rng(seed + 16)
    path = {k.source.stem: 0 for k in cuda_lib.KERNELS}

    def zero():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    def counted():
        return {k.source.stem: k.launches for k in cuda_lib.KERNELS}

    def tokens(B, S, vocab):
        return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(
            np.int32)).to(dev)

    def rel(got, want) -> float:
        got, want = got.detach().cpu().float(), want.detach().cpu().float()
        return float((got - want).abs().max()
                     / max(float(want.abs().max()), 1e-30))

    def gib(n: float) -> str:
        return f"{n / 2 ** 30:.2f} GiB"

    attn_calls = {}       # label: [(B, S, H, KV, hd, causal, dtype, err)]

    def attention_checked(label, fn):
        """``fn()`` with every `self_attention` call (kernel 5) held to
        `chunked_attention` on the same q, k and v: phase 7's tolerance
        (`attention_err`) with both outputs divided by the chunked one's
        RMS, as phase 14 holds qwen2-7b's server.  The calls are kept under
        ``label``."""
        calls = attn_calls.setdefault(label, [])

        def checked_attention(q, k, v, causal=True):
            o = self_attention(q, k, v, causal=causal)
            ref = chunked_attention(q, k, v, causal=causal).float()
            rms = ref.square().mean().sqrt()
            calls.append((*q.shape[:3], k.shape[2], q.shape[3], causal,
                          str(q.dtype).replace("torch.", ""),
                          attention_err(o.float() / rms, ref / rms,
                                        ATTN_TOL[str(q.dtype)])))
            return o

        attention_mod.self_attention = checked_attention
        try:
            return fn()
        finally:
            attention_mod.self_attention = self_attention

    def attention_report(label, n_calls: int):
        """Checks ``n_calls`` kernel 5 calls under ``label``, each within
        the tolerance, and prints their shapes and the worst error."""
        calls = attn_calls[label]
        worst = max(c[-1] for c in calls)
        check(len(calls) == n_calls and worst <= 1.0,
              f"phase 16 {label}: kernel 5 against chunked_attention in "
              f"{len(calls)} calls ({n_calls} expected), worst {worst} of "
              f"phase 7's tolerance")

        def vals(i):
            return "/".join(str(v) for v in sorted({c[i] for c in calls}))
        say(f"phase 16 {label}: each of the {len(calls)} kernel 5 calls (B "
            f"{vals(0)}, S {vals(1)}, H {vals(2)}, KV {vals(3)}, hd "
            f"{vals(4)}, causal {vals(5)}, {vals(6)}) held to "
            f"chunked_attention on the same q, k, v: worst {worst:.3g} of "
            f"phase 7's tolerance on the data's scale")

    def built(arch, cfg):
        """The model on the card, bf16 weights from ``seed``."""
        bundle = configs.get(arch)
        model = build(cfg, bundle.parallel_for("decode_32k",
                                               multi_pod=False))
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model.init(seed, dev)
        torch.cuda.synchronize()
        n = sum(a.numel() for a in tree_leaves(params))
        nbytes = sum(a.numel() * a.element_size()
                     for a in tree_leaves(params))
        say(f"phase 16 {arch}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, H {cfg.num_heads}, KV {cfg.num_kv_heads}, hd "
            f"{cfg.head_dim_}, d_ff {cfg.d_ff}, experts {cfg.num_experts} "
            f"top-{cfg.experts_per_token}, vocab {cfg.vocab_size}; "
            f"{n:.4g} parameters, {gib(nbytes)} in bf16, drawn from seed "
            f"{seed} on the card in {time.perf_counter() - t0:.2f} s")
        return model, Rules.make(MESH, model.par), params

    def served(model, params, per_prefill: int, label: str):
        """`serve` twice (the first run's launches are the path's, the
        second must give the same tokens); kernel 5 must launch
        ``per_prefill`` times a prefill call and no other kernel at all.
        The first run holds each kernel 5 output to `chunked_attention`
        (`attention_checked`)."""
        cfg = model.cfg
        outputs = None
        for run in range(2):
            reqs = draw_requests(SERVE["requests"], cfg.vocab_size,
                                 SERVE["max_new"], seed)
            zero()
            done, c = (attention_checked(f"serve {label}", lambda: serve(
                model, params, reqs, SERVE["slots"], SERVE["max_seq"], dev))
                if run == 0 else serve(model, params, reqs, SERVE["slots"],
                                       SERVE["max_seq"], dev))
            launched = counted()
            n_tok = sum(len(r.generated) for r in done)
            check(len(done) == SERVE["requests"]
                  and all(r.done for r in done),
                  f"phase 16 {label}: served {len(done)} of "
                  f"{SERVE['requests']}")
            check(all(0 <= t < cfg.vocab_size for r in done
                      for t in r.generated),
                  f"phase 16 {label}: a token past the vocab")
            check(c["prefills"] == SERVE["requests"]
                  and launched["flash_attention"] == per_prefill
                  * c["prefills"] and not any(
                      n for k, n in launched.items()
                      if k != "flash_attention"),
                  f"phase 16 {label} serve: {json.dumps(launched)} for "
                  f"{c['prefills']} prefill calls, {per_prefill} each")
            if run == 0:
                for k, n in launched.items():
                    path[k] += n
                outputs = {r.rid: list(r.generated) for r in done}
                attention_report(f"serve {label}",
                                 launched["flash_attention"])
            else:
                check({r.rid: r.generated for r in done} == outputs,
                      f"phase 16 {label}: the second run served other "
                      f"tokens")
            say(f"phase 16 serve {label} ("
                f"{'first, checked' if run == 0 else 'warm, same tokens'} "
                f"run): "
                f"{SERVE['requests']} requests, {SERVE['slots']} slots, "
                f"cache {SERVE['max_seq']}: {n_tok} tokens in "
                f"{c['seconds']:.4f} s host clock, "
                f"{n_tok / c['seconds']:.2f} tokens/s, {c['steps']} decode "
                f"steps, occupancy "
                f"{c['slot_steps'] / max(c['steps'], 1):.2f}/"
                f"{SERVE['slots']}, {c['prefills']} prefill calls, kernel 5 "
                f"launched {launched['flash_attention']} times; {smi_line}")

    def profiled(fn, label, calls: int = 1):
        """``calls`` calls of ``fn`` under torch.profiler: the device's
        kernels alone, their time a call, their count a call and the five
        that take the most device time (name shortened)."""
        with torch.no_grad(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # the hybrid stack's spans (`record_function`) have a copy on the
        # device's timeline: no kernel
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        device_us = sum(e.self_device_time_total for e in kernels)
        if not device_us:
            say(f"phase 16 {label}: device time not measured (the profiler "
                f"recorded none)")
            return 0.0
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        say(f"phase 16 {label}, torch.profiler: {device_us / calls / 1e3:.3f}"
            f" ms of device time and "
            f"{sum(e.count for e in kernels) / calls:.0f} device kernels a "
            f"call; the heaviest: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / calls / 1e3:.3f} ms"
                f" ({e.count / calls:.0f}x)" for e in top))
        return device_us / calls / 1e3

    def decode_step(model, params, rules, label):
        """The median decode step at B = slots over `DECODE_REPS`, one
        profile of 3 steps, and the weights' bytes over the memory rate
        (every weight but the embedding table, which is a lookup)."""
        B = SERVE["slots"]
        cache = model.init_cache(B, SERVE["max_seq"], dev)
        batch = {"tokens": tokens(B, 1, model.cfg.vocab_size),
                 "pos": SERVE["max_seq"] // 2}
        if model.cfg.family == "encdec":
            batch["frames"] = torch.zeros((B, 1, model.cfg.d_model),
                                          device=dev)
        with torch.no_grad():
            ms = cuda_ms(lambda: model.decode_fn(params, batch, cache, rules),
                         DECODE_REPS)
        device_ms = profiled(lambda: model.decode_fn(params, batch, cache,
                                                     rules),
                             f"{label} decode step", 3)
        busy = (f"busy {device_ms / ms:.3f} of it (device time over the "
                f"step's)" if device_ms else "busy share not measured")
        weights = sum(a.numel() * a.element_size()
                      for a in tree_leaves(params)) - \
            params["embed"]["embedding"].numel() * \
            params["embed"]["embedding"].element_size()
        say(f"phase 16 {label} decode step, B = {B}, cache "
            f"{SERVE['max_seq']}: {ms:.3f} ms (median of {DECODE_REPS}); "
            f"{busy}; bound: its weights' bytes ({gib(weights)}, the "
            f"embedding table excluded) over the card's memory rate, "
            f"{weights / HBM_BW * 1e3:.3f} ms; {smi_line}")
        del cache

    def peak(label):
        say(f"phase 16 {label}: peak device memory "
            f"{gib(torch.cuda.max_memory_allocated(dev))}")

    # ---- qwen3-moe-30b-a3b at full width and depth, bf16
    cfg = configs.get(MOE_ARCH).model
    model, rules, params = built(MOE_ARCH, cfg)
    L = cfg.num_layers
    served(model, params, L, MOE_ARCH)
    S = FAMILY_PREFILL_S
    toks = tokens(1, S, cfg.vocab_size)
    cache = model.init_cache(1, S, dev)
    with torch.no_grad():
        attention_checked(f"{MOE_ARCH} prefill 1 x {S}", lambda: model.
                          prefill_fn(params, {"tokens": toks}, rules, cache))
        attention_report(f"{MOE_ARCH} prefill 1 x {S}", L)
        prefill_ms = cuda_ms(lambda: model.prefill_fn(
            params, {"tokens": toks}, rules, cache), MODEL_REPS)
        lp = tree_map(lambda a: a[0], params["layers"])
        x = embed_tokens(params["embed"], toks, cfg, rules)
        h = apply_norm(lp["attn_norm"], x, cfg)
        q, k, v = _project_qkv(lp["attn"], h, cfg, rules,
                               torch.arange(S, device=dev)[None])
        attn_ms = cuda_ms(lambda: self_attention(q, k, v, causal=True), 5)
        h2 = apply_norm(lp["mlp_norm"], x, cfg)
        moe_ms = cuda_ms(lambda: apply_moe(lp["mlp"], h2, cfg, rules),
                         MODEL_REPS)
    prefill_device = profiled(lambda: model.prefill_fn(
        params, {"tokens": toks}, rules, cache), f"{MOE_ARCH} prefill")
    del cache, q, k, v
    flops = _flops_products(cfg, S, S)
    cap = capacity(S, cfg)
    say(f"phase 16 {MOE_ARCH} prefill 1 x {S} tokens, bf16: "
        f"{prefill_ms:.3f} ms (CUDA events, median of {MODEL_REPS}); "
        f"kernel 5: {L} launches x {attn_ms:.4f} ms (layer 0 alone) = "
        f"{L * attn_ms / prefill_ms:.4f} of it; the MoE blocks: {L} x "
        f"{moe_ms:.4f} ms (layer 0's alone) = {L * moe_ms / prefill_ms:.4f}"
        f" of it; bound: the products' {flops:.4g} operations (experts over "
        f"{cfg.num_experts} x {cap} slots, {cfg.num_experts * cap / (S * cfg.experts_per_token):.3f} "
        f"x the routed rows) at bf16's {PEAK_FLOPS_BF16:.3g}/s, "
        f"{flops / PEAK_FLOPS_BF16 * 1e3:.3f} ms; device busy "
        f"{prefill_device / prefill_ms:.3f} of it; {smi_line}")
    decode_step(model, params, rules, MOE_ARCH)

    # layer 0's MoE block, float32, against the CPU on the same inputs
    # (no expert overflows at 1.25 x), then a crafted input that sends
    # every token to experts 0 and 1: bit-equal across two card runs, cap - 1
    # tokens served by the overflowing expert on both devices, and the CPU's
    # result
    mp = {n: w.float() for n, w in lp["mlp"].items()}
    mp_cpu = {n: w.cpu() for n, w in mp.items()}
    Bl, Sl = MOE_LAYER0["B"], MOE_LAYER0["S"]
    with torch.no_grad():
        x0 = apply_norm({n: w.float() for n, w in lp["mlp_norm"].items()},
                        embed_tokens(params["embed"], tokens(
                            Bl, Sl, cfg.vocab_size), cfg, rules).float(),
                        cfg)
        y_card, aux_card = apply_moe(mp, x0, cfg, rules)
        y_cpu, aux_cpu = apply_moe(mp_cpu, x0.cpu(), cfg, rules)
        layer0 = (rel(y_card, y_cpu), rel(aux_card, aux_cpu))
        route = mp["router"][:, 0] + mp["router"][:, 1]
        noise = torch.from_numpy(rng.standard_normal(
            (MOE_OVERFLOW["B"], MOE_OVERFLOW["S"], cfg.d_model)).astype(
                np.float32)).to(dev)
        xo = 0.1 * noise + MOE_OVERFLOW["scale"] * route
        runs = [apply_moe(lp["mlp"], xo.to(torch.bfloat16), cfg, rules)
                for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        keep0 = (torch.arange(cfg.num_experts, device=dev) == 0)
        only0 = dict(mp, wo=mp["wo"] * keep0[:, None, None])
        Tover = MOE_OVERFLOW["B"] * MOE_OVERFLOW["S"]
        cap_o = capacity(Tover, cfg)
        n_card = int((apply_moe(only0, xo, cfg, rules)[0].abs().amax(-1)
                      > 0).sum())
        n_cpu = int((apply_moe({n: w.cpu() for n, w in only0.items()},
                               xo.cpu(), cfg, rules)[0].abs().amax(-1)
                     > 0).sum())
        over = rel(apply_moe(mp, xo, cfg, rules)[0],
                   apply_moe(mp_cpu, xo.cpu(), cfg, rules)[0])
    check(max(layer0) <= PAIR_REL and over <= PAIR_REL,
          f"phase 16 {MOE_ARCH} layer 0 MoE against the CPU: {layer0}, "
          f"overflow {over} (bar {PAIR_REL})")
    check(same, f"phase 16 {MOE_ARCH}: the overflowing MoE gave other bits "
          f"on a second run")
    check(n_card == n_cpu == cap_o - 1, f"phase 16 {MOE_ARCH}: expert 0 "
          f"served {n_card} tokens on the card, {n_cpu} on the CPU, cap "
          f"{cap_o}")
    say(f"phase 16 {MOE_ARCH} layer 0 MoE block, float32, B = {Bl}, S = "
        f"{Sl}: against the CPU y {layer0[0]:.3g}, aux {layer0[1]:.3g} of "
        f"the largest (bar {PAIR_REL}); every token sent to experts 0 and 1 "
        f"(B = {MOE_OVERFLOW['B']}, S = {MOE_OVERFLOW['S']}, cap {cap_o}): "
        f"bf16 bit-equal across two card runs, expert 0 serves {n_card} "
        f"tokens on the card and {n_cpu} on the CPU (cap - 1), float32 "
        f"against the CPU {over:.3g}")
    peak(MOE_ARCH)
    del params, model, lp, mp, mp_cpu, only0, x, h, h2, x0, xo, runs, noise
    del route, y_card, y_cpu
    torch.cuda.empty_cache()
    say(f"phase 16: {gib(torch.cuda.memory_allocated(dev))} held after "
        f"freeing {MOE_ARCH}")

    # ---- jamba-1.5-large-398b at full width, cut
    full = configs.get(HYBRID_ARCH).model
    cfg = dataclasses.replace(full, **HYBRID_CUT)
    say(f"phase 16 {HYBRID_ARCH}: the full model has {full.param_count():.4g}"
        f" parameters ({full.num_layers} layers, {full.num_experts} "
        f"experts); cut to {cfg.num_layers} layers (one super-block: 1 "
        f"attention, {cfg.attn_period - 1} Mamba, "
        f"{cfg.num_layers // cfg.moe_every} MoE) and {cfg.num_experts} of "
        f"its {full.num_experts} experts (top-{cfg.experts_per_token} "
        f"kept), widths as published")
    model, rules, params = built(HYBRID_ARCH, cfg)
    toks = tokens(1, S, cfg.vocab_size)
    cache = model.init_cache(1, S, dev)
    with torch.no_grad():
        attention_checked(f"{HYBRID_ARCH} (cut) prefill 1 x {S}",
                          lambda: model.prefill_fn(params, {"tokens": toks},
                                                   rules, cache))
        attention_report(f"{HYBRID_ARCH} (cut) prefill 1 x {S}",
                         cfg.num_layers // cfg.attn_period)
        zero()
        hybrid_ms = cuda_ms(lambda: model.prefill_fn(
            params, {"tokens": toks}, rules, cache), MODEL_REPS)
        per_prefill = counted()["flash_attention"] / (MODEL_REPS + 1)
        sp = tree_map(lambda a: a[0], params["layers"])
        x = apply_norm(tree_map(lambda a: a[0], sp["pre_norms"]),
                       embed_tokens(params["embed"], toks, cfg, rules), cfg)
        mamba_ms = cuda_ms(lambda: apply_mamba(
            tree_map(lambda a: a[0], sp["mamba"]), x, cfg, rules, "prefill",
            None), MODEL_REPS)
    hybrid_device = profiled(lambda: model.prefill_fn(
        params, {"tokens": toks}, rules, cache), f"{HYBRID_ARCH} (cut) "
        f"prefill")
    del cache, x
    check(per_prefill == cfg.num_layers // cfg.attn_period,
          f"phase 16 {HYBRID_ARCH}: {per_prefill} launches of kernel 5 a "
          f"prefill")
    flops = _flops_products(cfg, S, S)
    n_mamba = cfg.num_layers // cfg.attn_period * (cfg.attn_period - 1)
    say(f"phase 16 {HYBRID_ARCH} (cut) prefill 1 x {S} tokens, bf16: "
        f"{hybrid_ms:.3f} ms (median of {MODEL_REPS}); kernel 5 launched "
        f"{per_prefill:.0f} times a prefill; the Mamba sublayers: {n_mamba} x"
        f" {mamba_ms:.3f} ms (sublayer 0 alone) = "
        f"{n_mamba * mamba_ms / hybrid_ms:.4f} of it; bound: the products' "
        f"{flops:.4g} operations at bf16's rate, "
        f"{flops / PEAK_FLOPS_BF16 * 1e3:.3f} ms; device busy "
        f"{hybrid_device / hybrid_ms:.3f} of it; {smi_line}")
    decode_step(model, params, rules, f"{HYBRID_ARCH} (cut)")
    served(model, params, cfg.num_layers // cfg.attn_period,
           f"{HYBRID_ARCH} (cut)")
    peak(f"{HYBRID_ARCH} (cut)")
    del params, model, sp
    torch.cuda.empty_cache()

    # ---- jamba2-mini at its published widths, one 8-layer stage
    cfg = dataclasses.replace(configs.get(STAGE_ARCH).model,
                              num_layers=STAGE_LAYERS)
    model, rules, params = built(STAGE_ARCH, cfg)
    toks = tokens(1, S, cfg.vocab_size)
    cache = model.init_cache(1, S, dev)
    zero()
    with torch.no_grad():
        stage_ms = cuda_ms(lambda: model.prefill_fn(
            params, {"tokens": toks}, rules, cache), MODEL_REPS)
    per_prefill = counted()["flash_attention"] / (MODEL_REPS + 1)
    stage_device = profiled(lambda: model.prefill_fn(
        params, {"tokens": toks}, rules, cache), f"{STAGE_ARCH} (stage) "
        f"prefill")
    del cache
    n_attn = len(cfg.attn_layer_indices())
    check(per_prefill == n_attn, f"phase 16 {STAGE_ARCH}: {per_prefill} "
          f"launches of kernel 5 a prefill")
    # the products: 2 x the active weights a token (the embedding table is
    # a lookup), and the causal scores
    flops = float(2 * S * (cfg.active_param_count()
                           - cfg.padded_vocab() * cfg.d_model)
                  + 2 * n_attn * cfg.num_heads * S * S * cfg.head_dim_)
    say(f"phase 16 {STAGE_ARCH} (stage of {cfg.num_layers} layers) prefill 1"
        f" x {S} tokens, bf16: {stage_ms:.3f} ms (median of {MODEL_REPS}); "
        f"kernel 5 launched {per_prefill:.0f} times a prefill; bound: the "
        f"products' {flops:.4g} operations at bf16's rate, "
        f"{flops / PEAK_FLOPS_BF16 * 1e3:.3f} ms; device busy "
        f"{stage_device / stage_ms:.3f} of it; {smi_line}")
    decode_step(model, params, rules, f"{STAGE_ARCH} (stage)")
    # the step as `serve` runs it on the card: one CUDA graph replay
    cache = model.init_cache(1, SERVE["max_seq"], dev)
    with torch.no_grad():
        step = model.decode_graph(params, cache, rules, 1)
        graph_ms = cuda_ms(lambda: step(np.zeros((1, 1), np.int32),
                                        SERVE["max_seq"] // 2), DECODE_REPS)
    say(f"phase 16 {STAGE_ARCH} (stage) decode step as `serve` runs it, a "
        f"CUDA graph, B = 1, cache {SERVE['max_seq']}: {graph_ms:.3f} ms "
        f"(median of {DECODE_REPS}); {smi_line}")
    del cache, step
    peak(f"{STAGE_ARCH} (stage)")
    del params, model
    torch.cuda.empty_cache()

    # ---- whisper-medium at full width and depth
    cfg = configs.get(ENCDEC_ARCH).model
    model, rules, params = built(ENCDEC_ARCH, cfg)
    batch = {"tokens": tokens(1, ENCDEC_TOKENS, cfg.vocab_size),
             "frames": torch.from_numpy(rng.standard_normal(
                 (1, ENCDEC_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)}
    zero()
    label = f"{ENCDEC_ARCH} train forward"
    with torch.no_grad():
        logits = attention_checked(label, lambda: model.forward(
            params, batch, rules, "train")[0])
    torch.cuda.synchronize()
    launched = counted()
    flags = [(c[1], c[5]) for c in attn_calls[label]]
    want = ([(ENCDEC_FRAMES, False)] * cfg.encoder_layers
            + [(ENCDEC_TOKENS, True)] * cfg.num_layers)
    attention_report(label, len(want))
    check(flags == want and launched["flash_attention"] == len(want)
          and not any(n for k, n in launched.items()
                      if k != "flash_attention")
          and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, ENCDEC_TOKENS, cfg.padded_vocab()),
          f"phase 16 {ENCDEC_ARCH} train forward: {json.dumps(launched)}, "
          f"{len(flags)} attention calls")
    for k, n in launched.items():
        path[k] += n
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: model.forward(params, batch, rules,
                                               "train"), MODEL_REPS)
    D, V = cfg.d_model, cfg.padded_vocab()
    enc_flops = float(
        cfg.encoder_layers * (2 * ENCDEC_FRAMES * 12 * D * D
                              + 4 * ENCDEC_FRAMES ** 2 * D)
        + cfg.num_layers * (2 * ENCDEC_TOKENS * 14 * D * D
                            + 2 * ENCDEC_FRAMES * 2 * D * D
                            + 2 * ENCDEC_TOKENS ** 2 * D
                            + 4 * ENCDEC_TOKENS * ENCDEC_FRAMES * D)
        + 2 * ENCDEC_TOKENS * D * V)
    enc_device = profiled(lambda: model.forward(params, batch, rules,
                                                "train"),
                          f"{ENCDEC_ARCH} train forward")
    say(f"phase 16 {ENCDEC_ARCH} train forward, {ENCDEC_FRAMES} frames and "
        f"{ENCDEC_TOKENS} tokens, bf16: kernel 5 launched "
        f"{launched['flash_attention']} times ({cfg.encoder_layers} "
        f"non-causal at S = {ENCDEC_FRAMES}, {cfg.num_layers} causal at S = "
        f"{ENCDEC_TOKENS}; cross attention is chunked_attention); "
        f"{enc_ms:.3f} ms (median of {MODEL_REPS}), device busy "
        f"{enc_device / enc_ms:.3f} of it; bound: the products' "
        f"{enc_flops:.4g} operations at bf16's rate, "
        f"{enc_flops / PEAK_FLOPS_BF16 * 1e3:.3f} ms; {smi_line}")
    served(model, params, cfg.encoder_layers + cfg.num_layers, ENCDEC_ARCH)
    peak(ENCDEC_ARCH)
    del params, model, logits, batch
    torch.cuda.empty_cache()

    # ---- the four archs reduced, float32, card against CPU
    for arch in FAMILY_ARCHS:
        e = family_parity(arch, seed, dev)
        bundle = configs.get(arch)
        rc = reduced(bundle.model)
        n_attn = (rc.encoder_layers + rc.num_layers if rc.family == "encdec"
                  else rc.num_layers // rc.attn_period
                  if rc.family == "hybrid" else rc.num_layers)
        int8 = bundle.parallel_for("decode_32k", False).kv_cache_dtype \
            == "int8"
        check(e["train"] <= PAIR_REL and e["loss"] <= PAIR_REL
              and e["grad"] <= TRAIN_GRAD_REL
              and e["decode"] <= (FAMILY_INT8_DECODE if int8 else PAIR_REL)
              and e["launches_forward"] == n_attn
              and e["launches_backward"] == 2 * n_attn,
              f"phase 16 {arch} reduced, card against CPU: {e}")
        say(f"phase 16 {arch} reduced, float32, B = {FAMILY_SMALL['B']}, "
            f"S = {FAMILY_SMALL['S']}, wq and wk x {FAMILY_QK_SCALE}: "
            f"against the CPU train logits {e['train']:.3g}, decode after "
            f"prefill {e['decode']:.3g} (bar "
            f"{FAMILY_INT8_DECODE if int8 else PAIR_REL}"
            f"{', int8 KV' if int8 else ''}), loss {e['loss']:.3g} (bar "
            f"{PAIR_REL}); {e['leaves']} leaves each with a gradient, worst "
            f"{e['grad']:.3g} ({e['grad_leaf']}; bar {TRAIN_GRAD_REL}); "
            f"kernel 5 launched {e['launches_forward']} times in the train "
            f"forward and {e['launches_backward']} in loss_fn's forward and "
            f"backward ({n_attn} attention layers)")
    say(f"phase 16 kernel launches on the family path: {json.dumps(path)}")
    return path


def dryrun_job(job):
    """One cell of phase 17's grid, in a spawned worker: its record (written
    under the job's directory) and the kernel launches this worker counted,
    which a trace on ``meta`` must leave at 0."""
    arch, cell, multi_pod, out = job
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, cell, multi_pod, Path(out), force=True)
    return rec, {k.source.stem: k.launches for k in cuda_lib.KERNELS}


def dryrun_phase(seed: int, smi_line: str, dev=None) -> dict:
    """Phase 17: the dry run on the card's host and its one-card predictions
    against the card (see the docstring), ``dev`` the card's device.
    Returns each kernel's launches on the dry-run path: one counted call of
    each card step.  Raises on any failed check."""
    import multiprocessing
    import os
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import cuda_ms
    from repro_torch.configs.base import SHAPE_CELLS, ShapeCell
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LINK_BW, make_host_mesh
    from repro_torch.launch.roofline import render
    from repro_torch.models import Rules, build
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda" if dev is None else dev)
    rng = np.random.default_rng(seed)
    path = {k.source.stem: 0 for k in cuda_lib.KERNELS}

    def zero():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    def counted():
        return {k.source.stem: k.launches for k in cuda_lib.KERNELS}

    # ---- the grid, traced on `meta` in spawned workers
    zero()
    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    kinds = {"train": 0, "prefill": 1, "decode": 2}     # the longest first
    jobs = sorted(((a, c, mp, str(out)) for a in DRYRUN_ARCHS
                   for c in SHAPE_CELLS for mp in (False, True)),
                  key=lambda j: (kinds[SHAPE_CELLS[j[1]].kind],
                                 -configs.get(j[0]).model.num_layers))
    workers = min(DRYRUN_WORKERS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        results = list(pool.map(dryrun_job, jobs))
    grid_s = time.perf_counter() - t0
    recs = sorted((r for r, _ in results),
                  key=lambda r: (r["arch"], r["cell"], r["mesh"]))
    bad = [(r["arch"], r["cell"], r["mesh"], r.get("error"))
           for r in recs if r["status"] not in ("ok", "skipped")]
    check(not bad, f"phase 17 dry run: records in error: {bad}")
    skipped = {(r["arch"], r["cell"]) for r in recs
               if r["status"] == "skipped"}
    want = {(a, "long_500k") for a in DRYRUN_ARCHS
            if configs.get(a).model.family not in ("ssm", "hybrid")}
    check(skipped == want, f"phase 17 dry run skipped {sorted(skipped)}, "
          f"the reference's rule {sorted(want)}")
    traced = {k: sum(c[k] for _, c in results) for k in path}
    check(not any(traced.values()) and not any(counted().values()),
          f"phase 17: a trace on meta launched a kernel: workers "
          f"{json.dumps(traced)}, here {json.dumps(counted())}")
    # each record on a production mesh is device 0's DTensor program over a
    # fake group: its collectives counted, by kind
    ok = [r for r in recs if r["status"] == "ok"]
    bare = [(r["arch"], r["cell"], r["mesh"]) for r in ok
            if not (isinstance(r["hlo"]["collective_bytes"], float)
                    and r["hlo"]["collective_bytes"] > 0
                    and r["hlo"]["collective_count"]
                    and r["roofline"]["collective_s"] is not None)]
    check(not bare, f"phase 17 dry run: records without collectives: {bare}")
    for mesh in ("16x16", "2x16x16"):
        mine = [r for r in ok if r["mesh"] == mesh]
        dominant = {t: sum(r["roofline"]["dominant"] == t for r in mine)
                    for t in ("compute", "memory", "collective")}
        kinds = {}
        for r in mine:
            for k, n in r["hlo"]["collective_count"].items():
                kinds[k] = kinds.get(k, 0) + n
        say(f"phase 17 dry run, mesh {mesh}:\n" + render(recs, mesh))
        say(f"phase 17 mesh {mesh}: {len(mine)} records traced in "
            f"{sum(r['lower_s'] for r in mine):.1f} s of worker time; "
            f"collective seconds summed "
            f"{sum(r['roofline']['collective_s'] for r in mine):.4f} "
            f"(at {LINK_BW / 1e9:.0f} GB/s a card), compute "
            f"{sum(r['roofline']['compute_s'] for r in mine):.4f}, memory "
            f"{sum(r['roofline']['memory_s'] for r in mine):.4f}; dominant "
            f"term: {json.dumps(dominant)}; collectives by kind "
            f"{json.dumps(kinds)}")
    slow = sorted((r for r in recs if r["status"] == "ok"),
                  key=lambda r: -r["lower_s"])[:5]
    say(f"phase 17 dry-run grid: {len(DRYRUN_ARCHS)} archs ("
        f"{', '.join(DRYRUN_ARCHS)}) x {len(SHAPE_CELLS)} cells x 2 meshes ="
        f" {len(recs)} records ({len(recs) - len(skipped) * 2} traced, "
        f"{len(skipped) * 2} skipped) in {grid_s:.1f} s on {workers} "
        f"spawned workers; the longest traces: " + ", ".join(
            f"{r['arch']} {r['cell']} {r['mesh']} {r['lower_s']} s"
            for r in slow) + "; kernel launches 0")

    # ---- one-card records against the steps on the card
    def real_bytes(*trees) -> int:
        return sum(t.numel() * t.element_size() for tree in trees
                   for t in tree_leaves(tree))

    def tokens(B, S, vocab):
        return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(
            np.int32)).to(dev)

    def against(arch, cell, rec, args_bytes, fn):
        """Hold ``rec`` to the step ``fn`` on the card: argument bytes
        (gated), then peak memory, time and kernel 5's launches
        (printed)."""
        mem = rec["memory"]
        check(mem["argument_bytes"] == args_bytes,
              f"phase 17 {arch} {cell.name} {cell.global_batch} x "
              f"{cell.seq_len}: predicted argument bytes "
              f"{mem['argument_bytes']}, the step's tensors {args_bytes}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero()
        result = fn()
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - base
        launched = counted()
        del result
        for k, n in launched.items():
            path[k] += n
        ms = cuda_ms(fn, DRYRUN_REPS)
        rf = rec["roofline"]
        roof_ms = max(rf["compute_s"], rf["memory_s"]) * 1e3
        added = mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
        say(f"phase 17 {arch} {cell.kind} {cell.global_batch} x "
            f"{cell.seq_len} ({cell.name}'s layout), one card: argument "
            f"bytes {args_bytes} predicted exactly; peak "
            f"{mem['peak_bytes_per_device'] / 2 ** 30:.3f} GiB predicted, "
            f"{(args_bytes + growth) / 2 ** 30:.3f} GiB measured (the "
            f"arguments and max_memory_allocated's growth over the step, "
            f"{growth / 2 ** 30:.3f} GiB against {added / 2 ** 30:.3f} "
            f"predicted: {growth / added:.3f}x), ratio "
            f"{(args_bytes + growth) / mem['peak_bytes_per_device']:.3f}; "
            f"roofline {roof_ms:.3f} ms ({rf['dominant']}; compute "
            f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}"
            f" ms), the step {ms:.3f} ms (CUDA events, median of "
            f"{DRYRUN_REPS}), {ms / roof_ms:.2f}x it; useful FLOPs ratio "
            f"{rf['useful_flops_ratio']:.4f}; traced in {rec['lower_s']} s; "
            f"kernel 5 launched {launched['flash_attention']} times in the "
            f"step, others {sum(launched.values()) - launched['flash_attention']}"
            f"; {smi_line}")
        check(not any(n for k, n in launched.items()
                      if k != "flash_attention"),
              f"phase 17 {arch} {cell.name}: {json.dumps(launched)}")
        return launched["flash_attention"]

    one = make_host_mesh(1, 1)
    k5 = {}
    params, params_of = None, None      # a model's weights, kept for its
    for arch, cell_name, B, S in DRYRUN_STEPS:     # next serving step
        cell = ShapeCell(cell_name, S, B, SHAPE_CELLS[cell_name].kind)
        zero()
        rec = dryrun.cell_record(arch, cell, one)
        check(not any(counted().values()), f"phase 17: the one-card trace "
              f"of {arch} {cell_name} launched {json.dumps(counted())}")
        bundle = configs.get(arch)
        par = bundle.parallel_for(cell_name, multi_pod=False)
        model = build(bundle.model, par)
        rules = Rules.make(one, par)
        vocab = model.cfg.vocab_size
        if params_of != (arch if cell.kind != "train" else None):
            params, params_of = None, None
            torch.cuda.empty_cache()
        if cell.kind == "train":
            state = init_train_state(model, seed, dev)
            batch = {"tokens": tokens(B, S, vocab)}
            step = make_train_step(model, rules).step_fn
            k5[cell.kind] = against(arch, cell, rec, real_bytes(state, batch),
                                    lambda: step(state, batch))
            del state
        else:
            if params is None:
                params, params_of = model.init(seed, dev), arch
            cache = model.init_cache(B, S, dev)
            if cell.kind == "decode":
                batch = {"tokens": tokens(B, 1, vocab),
                         "pos": torch.full((), S // 2, dtype=torch.int32,
                                           device=dev)}
                fn = (lambda: model.decode_fn(params, batch, cache, rules))
            else:
                batch = {"tokens": tokens(B, S, vocab)}
                fn = (lambda: model.prefill_fn(params, batch, rules, cache))

            def no_grad(fn=fn):
                with torch.no_grad():
                    return fn()

            k5[cell.kind] = against(arch, cell, rec,
                                    real_bytes(params, batch, cache), no_grad)
            del cache
    del model, params
    torch.cuda.empty_cache()
    check(k5 == {"decode": 0, "prefill": 28, "train": 60},
          f"phase 17: kernel 5's launches a step {k5}, phases 14-15 read "
          f"decode 0, prefill 28 and train 60")
    # phase 18 starts its NCCL group: no fake group may be left up
    check(not torch.distributed.is_initialized(),
          "phase 17 left a default process group up")
    say(f"phase 17 kernel launches on the dry-run path (one counted call "
        f"of each card step): {json.dumps(path)}")
    return path


#: what phase 14 served, for phase 18 to hold the sharded path to
PHASE14: dict = {}


def _mesh_model(arch: str, cell: str):
    from repro_torch import configs
    from repro_torch.models import build
    bundle = configs.get(arch)
    return build(bundle.model, bundle.parallel_for(cell, multi_pod=False))


def mesh_serve_rank(rank: int, seed: int, sizes: str, out_dir: str) -> None:
    """One rank of phase 18's multi-card serve (spawned by `run_ranks`
    under NCCL, card ``rank``): qwen2-7b serves the phase's requests on the
    mesh of axis ``sizes`` (JSON); the tokens go to ``rank<r>.json``."""
    import torch

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import draw_requests, serve

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _mesh_model(MODEL_ARCH, "decode_32k")
    dev = torch.device("cuda", rank)
    params = model.init(seed, dev)
    reqs = draw_requests(SERVE["requests"], model.cfg.vocab_size,
                         SERVE["max_new"], seed)
    done, _ = serve(model, params, reqs, SERVE["slots"], SERVE["max_seq"],
                    dev, device_mesh(json.loads(sizes), "cuda"))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {str(r.rid): list(map(int, r.generated)) for r in done}))


def mesh_train_rank(rank: int, seed: int, sizes: str, out_dir: str) -> None:
    """One rank of phase 18's multi-card train step (as `mesh_serve_rank`):
    smollm-135m's step at `TRAIN_STEP` from the seed's state and tokens on
    the mesh of axis ``sizes``; the loss goes to ``rank<r>.json``."""
    import torch

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Rules
    from repro_torch.train.step import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _mesh_model(TRAIN_ARCH, "train_4k")
    dev = torch.device("cuda", rank)
    rules = Rules.make(device_mesh(json.loads(sizes), "cuda"), model.par)
    toks = _mesh_tokens(seed, model.cfg.vocab_size).to(dev)
    _, met = make_train_step(model, rules, lr=TRAIN_LR).step_fn(
        init_train_state(model, seed, dev, rules),
        {"tokens": rules.distribute(toks, ("batch", "seq"))})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"loss": float(met["loss"].full_tensor())}))


def _f32(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a.float() if a.is_floating_point() else a, tree)


def _mesh_tokens(seed: int, vocab: int):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed + 18).integers(
        0, vocab, (TRAIN_STEP["B"], TRAIN_STEP["S"])).astype(np.int32))


def mesh_phase(seed: int, smi_line: str, dev=None) -> dict:
    """Phase 18: the sharded path at world size 1 on the card (see the
    docstring), ``dev`` the card's device.  Returns each kernel's launches
    on the mesh path (the serve, one prefill and one train step), counted
    from 0.  Raises on any failed check."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.bench import cuda_ms
    from repro_torch.comm import run_ranks
    from repro_torch.comm.group import _free_port
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import MESH, draw_requests, serve
    from repro_torch.models import Rules
    from repro_torch.models.sharding import is_dtensor
    from repro_torch.train.step import init_train_state, make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 18 runs with TF32 off")
    dev = torch.device("cuda" if dev is None else dev)
    path = {k.source.stem: 0 for k in cuda_lib.KERNELS}

    def zero():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    def counted():
        return {k.source.stem: k.launches for k in cuda_lib.KERNELS}

    def only_attention(launched, n, what):
        check(launched["flash_attention"] == n and not any(
            c for k, c in launched.items() if k != "flash_attention"),
            f"phase 18 {what}: {json.dumps(launched)}, expected {n} "
            f"launches of kernel 5 alone")
        for k, c in launched.items():
            path[k] += c

    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = device_mesh(MESH, "cuda")
        say(f"phase 18: a one-rank NCCL group, DeviceMesh {mesh}")

        # ---- qwen2-7b served through the mesh path
        model = _mesh_model(MODEL_ARCH, "decode_32k")
        cfg = model.cfg
        one = Rules.make(MESH, model.par)
        rules = Rules.make(mesh, model.par)
        params = model.init(seed, dev)
        dparams = model.distribute(params, rules)
        reqs = draw_requests(SERVE["requests"], cfg.vocab_size,
                             SERVE["max_new"], seed)
        zero()
        done, c = serve(model, dparams, reqs, SERVE["slots"],
                        SERVE["max_seq"], dev, mesh)
        only_attention(counted(), cfg.num_layers * c["prefills"], "serve")
        got = {r.rid: list(r.generated) for r in done}
        check(got == PHASE14["outputs"], f"phase 18 serve: the mesh path "
              f"served other tokens than phase 14's one-device path")
        served = sum(len(t) for t in got.values())
        say(f"phase 18 serve {MODEL_ARCH} on the 1x1 mesh: {len(done)} "
            f"requests, {served} tokens, each request's tokens equal to "
            f"phase 14's; {c['seconds']:.4f} s host clock, "
            f"{served / c['seconds']:.2f} tokens/s, {c['steps']} decode "
            f"steps, kernel 5 launched {cfg.num_layers} x {c['prefills']} "
            f"prefill calls; {smi_line}")

        # ---- the prefill of 1 x 4096 and a decode step, both paths
        S = MODEL_PREFILL_S
        toks = _mesh_tokens(seed, cfg.vocab_size)[:1, :S].to(dev)
        dtoks = rules.distribute(toks, ("batch", "seq"))
        caches = {"one": model.init_cache(1, S, dev),
                  "mesh": model.init_cache(1, S, dev, rules)}
        runs = {"one": (params, one, toks), "mesh": (dparams, rules, dtoks)}

        def prefill(name):
            p, r, t = runs[name]
            return model.prefill_fn(p, {"tokens": t}, r, caches[name])[0]

        with torch.no_grad():
            zero()
            logits = prefill("mesh")
            only_attention(counted(), cfg.num_layers, "prefill")
            want = prefill("one")
            check(not is_dtensor(want) and is_dtensor(logits),
                  "phase 18: the one-device path made a DTensor, or the "
                  "mesh path a plain tensor")
            err = float((logits.full_tensor().float() - want.float()).abs()
                        .max() / want.float().abs().max())
            check(err <= PAIR_REL, f"phase 18 prefill logits: {err} of the "
                  f"largest against the one-device path")
            pre = {}
            for name in ("one", "mesh", "mesh", "one"):
                pre.setdefault(name, []).append(cuda_ms(
                    lambda: prefill(name), MODEL_REPS))
        del caches
        B = SERVE["slots"]
        btoks = _mesh_tokens(seed + 1, cfg.vocab_size)[:B, :1].to(dev)
        caches = {"one": model.init_cache(B, SERVE["max_seq"], dev),
                  "mesh": model.init_cache(B, SERVE["max_seq"], dev, rules)}
        runs = {"one": (params, one, btoks),
                "mesh": (dparams, rules, rules.distribute(
                    btoks, ("batch", "seq")))}

        def decode(name):
            p, r, t = runs[name]
            return model.decode_fn(p, {"tokens": t,
                                       "pos": SERVE["max_seq"] // 2},
                                   caches[name], r)[0]

        with torch.no_grad():
            a = torch.argmax(decode("one")[:, 0], -1)
            b = torch.argmax(decode("mesh").full_tensor()[:, 0], -1)
            check(torch.equal(a, b), f"phase 18 decode: tokens {b.tolist()}"
                  f" on the mesh, {a.tolist()} on one device")
            dec = {}
            for name in ("one", "mesh", "mesh", "one"):
                dec.setdefault(name, []).append(cuda_ms(
                    lambda: decode(name), DECODE_REPS))
            # the host's work DTensor adds: its dispatches a step and their
            # own host time (torch.profiler's "PythonSubclass" rows)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                for _ in range(3):
                    decode("mesh")
                torch.cuda.synchronize()
        events = prof.key_averages()
        sub = [e for e in events if e.key == "PythonSubclass"]
        sub_ms = sum(e.self_cpu_time_total for e in sub) / 3e3
        host_ms = sum(e.self_cpu_time_total for e in events) / 3e3
        dispatch = (f"{sum(e.count for e in sub) / 3:.0f} DTensor dispatches "
                    f"a mesh decode step, {sub_ms:.3f} ms of host self time "
                    f"a step in them of {host_ms:.3f} in all (torch.profiler)"
                    if sub else "DTensor dispatch not measured (the "
                    "profiler recorded no PythonSubclass row)")
        say(f"phase 18 {MODEL_ARCH} prefill 1 x {S}, bf16: one device "
            f"{pre['one']} ms, mesh {pre['mesh']} ms (CUDA events, medians "
            f"of {MODEL_REPS}, in turns); logits {err:.3g} of the largest "
            f"apart; decode step B = {B}, cache {SERVE['max_seq']}: one "
            f"device {dec['one']} ms, mesh {dec['mesh']} ms (medians of "
            f"{DECODE_REPS}), the same greedy tokens; {dispatch}; "
            f"{smi_line}")
        del caches, runs, dparams, params, model
        torch.cuda.empty_cache()

        # ---- rwkv6-1.6b's train forward (kernel 6), both paths, float32
        model = _mesh_model(RWKV_ARCH, "decode_32k")
        rules = Rules.make(mesh, model.par)
        params = _f32(model.init(seed, dev))
        unit_fan_in(params["layers"])
        rtoks = _mesh_tokens(seed + 2, model.cfg.vocab_size)[:1].to(dev)
        with torch.no_grad():
            want = model.forward(params, {"tokens": rtoks},
                                 Rules.make(MESH, model.par), "train")[0]
            zero()
            got = model.forward(model.distribute(params, rules), {
                "tokens": rules.distribute(rtoks, ("batch", "seq"))},
                rules, "train")[0]
            launched = counted()
        rerr = float((got.full_tensor() - want).abs().max()
                     / want.abs().max())
        check(launched["gla_timemix"] == model.cfg.num_layers
              and rerr <= RWKV_TM_REL, f"phase 18 {RWKV_ARCH} train forward "
              f"on the mesh: {json.dumps(launched)}, {rerr} of the largest "
              f"logit from the one-device path")
        for k, n in launched.items():
            path[k] += n
        say(f"phase 18 {RWKV_ARCH} train forward, S = {rtoks.shape[1]}, "
            f"float32, projections at unit fan-in: kernel 6 launched "
            f"{launched['gla_timemix']} times under local_map, logits "
            f"{rerr:.3g} of the largest from the one-device path")
        del params, got, want, model
        torch.cuda.empty_cache()

        # ---- smollm-135m's train step at 4 x 4096, both paths
        model = _mesh_model(TRAIN_ARCH, "train_4k")
        toks = _mesh_tokens(seed, model.cfg.vocab_size).to(dev)
        steps, losses = {}, {}
        for name, r in (("one", Rules.make(MESH, model.par)),
                        ("mesh", Rules.make(mesh, model.par))):
            step_fn = make_train_step(model, r, lr=TRAIN_LR).step_fn
            state = init_train_state(model, seed, dev,
                                     r if r.on_mesh else None)
            batch = {"tokens": r.distribute(toks, ("batch", "seq"))}
            zero()
            _, met = step_fn(state, batch)
            launched = counted()
            loss = met["loss"]
            losses[name] = float(loss.full_tensor() if is_dtensor(loss)
                                 else loss)
            if name == "mesh":
                only_attention(launched, 2 * model.cfg.num_layers
                               * model.par.num_microbatches, "train step")
            steps[name] = cuda_ms(lambda: step_fn(state, batch),
                                  MESH_TRAIN_REPS)
            del state
            torch.cuda.empty_cache()
        rel = abs(losses["mesh"] - losses["one"]) / abs(losses["one"])
        check(math.isfinite(losses["mesh"]) and rel <= TRAIN_GRAD_REL,
              f"phase 18 train step: loss {losses['mesh']} on the mesh, "
              f"{losses['one']} on one device")
        say(f"phase 18 {TRAIN_ARCH} train step, B = {TRAIN_STEP['B']}, S = "
            f"{TRAIN_STEP['S']}, bf16: loss {losses['mesh']:.6f} on the mesh,"
            f" {losses['one']:.6f} on one device ({rel:.3g} apart); one "
            f"device {steps['one']:.2f} ms, mesh {steps['mesh']:.2f} ms "
            f"(CUDA events, medians of {MESH_TRAIN_REPS} after a warm-up); "
            f"{smi_line}")
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- across cards, where the machine has them
    count = torch.cuda.device_count()
    if count < 2:
        say(f"phase 18 NCCL across cards: not run, the machine has {count} "
            f"card (a 1x2 serve and a 2x1 train step need two)")
        return path
    work = ROOT / "build" / "mesh_ranks"
    for fn, sizes in ((mesh_serve_rank, {"data": 1, "model": 2}),
                      (mesh_train_rank, {"data": 2, "model": 1})):
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        run_ranks(fn, 2, args=(seed, json.dumps(sizes), str(work)),
                  backend="nccl", timeout=900)
        outs = [json.loads((work / f"rank{r}.json").read_text())
                for r in range(2)]
        if fn is mesh_serve_rank:
            want = {str(k): v for k, v in PHASE14["outputs"].items()}
            check(all(o == want for o in outs), "phase 18 NCCL serve on "
                  f"{sizes}: other tokens than the one-card run")
            say(f"phase 18 NCCL serve {MODEL_ARCH} on {sizes}, 2 cards: "
                f"every rank served the one-card tokens; {smi_line}")
        else:
            rel = max(abs(o["loss"] - losses["one"]) for o in outs) \
                / abs(losses["one"])
            check(rel <= TRAIN_GRAD_REL, f"phase 18 NCCL train step on "
                  f"{sizes}: losses {outs} against {losses['one']}")
            say(f"phase 18 NCCL train step {TRAIN_ARCH} on {sizes}, 2 "
                f"cards: loss {outs[0]['loss']:.6f}, {rel:.3g} from the "
                f"one-card loss; {smi_line}")
    shutil.rmtree(work, ignore_errors=True)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from repro_torch import device as h100
    from repro_torch.bench import cuda_ms
    from repro_torch.core import Pattern, analyze
    from repro_torch.core.registry import get
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.stencil_fifo import hbm_traffic_model
    from repro_torch.runtime import FIFO_STREAM, ValidationError
    from repro_torch.runtime import cuda_backend as cb
    from repro_torch.runtime import cuda_codegen as cg
    from repro_torch.runtime.simulator import trace_channel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    def on_card(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def max_err(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    def close(a, b) -> bool:
        return bool(torch.allclose(a, b, **TOL))

    def device_ms(launch, reps: int) -> float:
        """Device time per launch: CUDA events around ``reps`` raw launches
        queued back to back (no wrapper on the host path, so the device,
        not the host's enqueue, sets the pace)."""
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def planned(name):
        return analyze(get(name)).classify().fifoize().size().plan()

    # ---------------------------------------------------------- phase 1 --
    secs = cuda_lib.build_all(cuda_lib.KERNELS)
    say(f"phase 1 build: {json.dumps(secs)}")
    for k in cuda_lib.KERNELS:
        for fn, lines in ptxas_entries(k.ptxas_log).items():
            say(f"  {k.source.name} {fn}: " + "; ".join(lines))
    hgmma = hgmma_counts(cuda_lib.FLASH_ATTENTION.library)
    if hgmma is None:
        say("phase 1 flash_attention SASS: no cuobjdump in this toolkit, "
            "HGMMA not counted")
    else:
        say(f"phase 1 flash_attention SASS, HGMMA per kernel: "
            f"{json.dumps(hgmma)}")
        bf16 = {fn: n for fn, n in hgmma.items()
                if "flash_attention_tc" in fn and "bfloat16" in fn}
        check(bool(bf16) and all(bf16.values()),
              f"flash_attention's bf16 kernels run no HGMMA: {bf16}")

    # ---------------------------------------------------------- phase 2 --
    card = cg.ring_card(dev)
    say(f"phase 2 ring limits: {card}")
    kernels = {"ring_stencil": cuda_lib.RING_STENCIL,
               "addressable_step": cuda_lib.ADDRESSABLE_STEP,
               "replay": cuda_lib.REPLAY}
    for k in kernels.values():
        k.launches = 0
    launches = {}                                 # (kernel, stencil) -> n
    inputs, walls, ring_out, shapes, addr_out = {}, {}, {}, {}, {}

    def counted(stencil, fn):
        before = {n: k.launches for n, k in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        for n, k in kernels.items():
            if k.launches - before[n]:
                launches[(n, stencil)] = (launches.get((n, stencil), 0)
                                          + k.launches - before[n])
        return out

    for name, shape in SIZES.items():
        a = planned(name)
        c = a.compile(backend="cuda")
        check(c.mode == "fifo-ring", f"{name}: {c.describe()}")
        x = on_card(shape)
        inputs[name] = x
        shapes[name] = cg.ring_launch(shape, BLOCK, STEPS + 1, 2, card, STEPS)
        say(f"phase 2 {name} ring launch: {shapes[name].describe()}")
        check(name == "jacobi-1d" or shapes[name].ctas > 1,
              f"{name}: the ring runs on one CTA")

        def fused():
            y = x
            for _ in range(TSTEPS // STEPS):
                y = c(y, STEPS, BLOCK)
            return y

        torch.cuda.synchronize()          # time the job, not queued work
        t0 = time.perf_counter()
        y = counted(name, fused)
        fused_s = time.perf_counter() - t0
        ring_out[name] = y
        want = c.program.ref(x, TSTEPS)
        check(tuple(y.shape) == shape and bool(torch.isfinite(y).all()),
              f"{name}: output not finite or of shape {tuple(y.shape)}")
        err = max_err(y, want)
        check(bool(torch.allclose(y, want, **TOL_LONG)),
              f"{name}: fifo-ring vs oracle err {err}")
        ca = a.compile(backend="cuda", mode="addressable")
        before = cuda_lib.ADDRESSABLE_STEP.launches
        torch.cuda.synchronize()          # the oracle's steps are queued
        t0 = time.perf_counter()
        ya = counted(name, lambda: ca(x, TSTEPS, BLOCK))
        addr_s = time.perf_counter() - t0
        check(cuda_lib.ADDRESSABLE_STEP.launches - before == TSTEPS,
              f"{name}: the addressable job made "
              f"{cuda_lib.ADDRESSABLE_STEP.launches - before} launches")
        walls[name] = {"ring_stencil": fused_s, "addressable_step": addr_s}
        addr_out[name] = ya
        aerr = max_err(ya, want)
        check(bool(torch.allclose(ya, want, **TOL_LONG)),
              f"{name}: addressable vs oracle err {aerr}")
        check(close(y, ya), f"{name}: fifo-ring vs addressable err "
              f"{max_err(y, ya)}")
        say(f"phase 2 {name} {shape} T={TSTEPS}: fifo-ring err {err:.3g} "
            f"({fused_s:.3f} s host clock), addressable err {aerr:.3g} "
            f"({addr_s:.3f} s), fifo-ring vs addressable err "
            f"{max_err(y, ya):.3g}, |oracle| max "
            f"{float(want.abs().max()):.3g}")

    validate_s = {}
    for name, want in VALIDATE.items():
        a = planned(name)
        t0 = time.perf_counter()
        v = counted(name, lambda: a.validate(backend="cuda")).validation
        validate_s[name] = time.perf_counter() - t0
        check(v.backend == "cuda" and (v.replays, v.rejections) == want,
              f"{name}: validate gave {v.summary()}")
        say(f"phase 2 validate: {v.summary()}; {validate_s[name]:.4f} s "
            f"host clock, {launches[('replay', name)]} replay launches")
    a = analyze(get("jacobi-1d")).classify().size(pow2=True).plan()
    broken = next(p for p in a.plans if p.pattern_before != Pattern.FIFO.value
                  and not p.split)
    bad = dataclasses.replace(broken, lowering=FIFO_STREAM)
    wrong = dataclasses.replace(a, plans=tuple(
        bad if p.name == bad.name else p for p in a.plans))
    try:
        wrong.validate(backend="cuda")
    except ValidationError as e:
        say(f"phase 2 wrong plan rejected: {str(e).splitlines()[1].strip()}")
    else:
        raise AssertionError("a FIFO plan on a non-FIFO channel validated")
    total = {n: k.launches for n, k in kernels.items()}
    say(f"phase 2 launches: {json.dumps(total)}")
    for n, count in total.items():
        check(count > 0, f"kernel {n} never launched on the main path")
    for n in ("ring_stencil", "addressable_step", "replay"):
        for name in SIZES:
            check(launches.get((n, name), 0) > 0, f"{n} not run on {name}")

    # ---------------------------------------------------------- phase 3 --
    for name, (shape, steps, blocks) in SMALL.items():
        c = planned(name).compile(backend="cuda")
        x = on_card(shape)
        want = c.program.ref(x, steps)
        block = blocks[-1]
        check(close(c(x, steps, block), want), f"{name}: small run")
        for knob in ({"ring_depth": (steps + 1) // 2},
                     {"halo": 2 * c.program.radius - 1}):
            got = c(x, steps, block, **knob)
            check(not close(got, want), f"{name}: {knob} did not diverge")
            say(f"phase 3 {name} {knob}: diverges by {max_err(got, want):.3g}")

    # ---------------------------------------------------------- phase 4 --
    errs = {}
    small = [(name, shape, steps, blocks)
             for name, (shape, steps, blocks) in SMALL.items()]
    small += [(name, shape, steps, (1, steps))
              for name, (shape, steps) in SMALL_WIDE.items()]
    for name, shape, steps, blocks in small:
        p = cg.STENCIL_PROGRAMS[name]
        x = on_card(shape)
        for block, (depth, halo), mode in itertools.product(
                blocks, ((steps + 1, 2), ((steps + 1) // 2, 2),
                         (steps + 1, 1)), cg.RING_MODES):
            # the wave takes full rings of blocks of 2 to 8 items: the
            # others go through the mode ring_launch gives them
            takes = mode != "wave" or (depth > steps and halo == 2
                                       and 2 <= block <= cg.WAVE_ITEMS)
            got = cg._ring_stencil_with(
                x, p, steps, block, depth, halo,
                cg._ring_launch(shape, block, depth, halo, card,
                                mode=mode if takes else None, steps=steps))
            want = cg._ring_plain(x, p, steps, block, depth, halo)
            e = max_err(got, want)
            check(close(got, want), f"ring {name} {shape} block {block} "
                  f"depth {depth} halo {halo} mode {mode}: err {e}")
        got, want = cg.addressable_step(x, p), cg._addressable_plain(x, p)
        check(close(got, want), f"addressable {name}: {max_err(got, want)}")
        want = x
        for n_steps in range(1, 4):
            want = cg._addressable_plain(want, p)
            got = cg.addressable_steps(x, p, n_steps)
            check(close(got, want), f"addressable job {name} {shape} "
                  f"steps {n_steps}: {max_err(got, want)}")
    ctas_in = lambda shape, steps, m: cg._ring_launch(
        shape, steps, steps + 1, 2, card, mode=m, steps=steps).ctas
    wide = "; ".join(
        f"{name} {shape}: " + ", ".join(
            f"{ctas_in(shape, steps, m)} in {m}" for m in cg.RING_MODES)
        for name, (shape, steps) in SMALL_WIDE.items())
    say(f"phase 4 small shapes: ring (block 1 and injections included, in "
        f"every mode: {wide} CTAs) and addressable (one step and the job) "
        f"match their plain versions")
    xw = on_card(SMALL_WIDE["jacobi-2d"][0])
    p = cg.STENCIL_PROGRAMS["jacobi-2d"]
    too_many = cg._ring_launch(tuple(xw.shape), 4, 5, 2, card, ctas=32)
    try:
        cg._ring_stencil_with(xw, p, 4, 4, 5, 2, too_many)
    except RuntimeError as e:
        say(f"phase 4 a cluster of {too_many.ctas} CTAs is refused: {e}")
    else:
        raise AssertionError("a ring cluster of more than 16 CTAs launched")
    # 300 CTAs of 1024 threads, one a row: more than the SMs can hold
    xg = on_card((4, 300, 1024))
    pg = cg.STENCIL_PROGRAMS["heat-3d"]
    big = cg._ring_launch(tuple(xg.shape), 4, 5, 2, card, ctas=300,
                          mode="grid")
    check(big.ctas == 300 and big.threads * big.segments == 1024,
          f"the oversized grid is {big.describe()}")
    try:
        cg._ring_stencil_with(xg, pg, 4, 4, 5, 2, big)
    except RuntimeError as e:
        say(f"phase 4 a grid of 300 CTAs is refused: {e}")
    else:
        raise AssertionError("a ring grid of more CTAs than SMs launched")
    check(close(cg.ring_stencil(xw, p, 4, 4, 5, 2),
                cg._ring_plain(xw, p, 4, 4, 5, 2)),
          "the launch after a refused one")
    events = {}
    for name, x in inputs.items():
        p = cg.STENCIL_PROGRAMS[name]
        got = cg.ring_stencil(x, p, STEPS, BLOCK, STEPS + 1, 2)
        want = cg._ring_plain(x, p, STEPS, BLOCK, STEPS + 1, 2)
        errs[("ring_stencil", name)] = max_err(got, want)
        check(close(got, want), f"ring {name} full size: "
              f"{errs[('ring_stencil', name)]}")
        got, want = cg.addressable_step(x, p), cg._addressable_plain(x, p)
        errs[("addressable_step", name)] = max_err(got, want)
        check(close(got, want), f"addressable {name} full size")
        a = planned(name)
        sizing = a.ctx.sizing(a.ppn)
        worst, lists = 0, []
        for ch in a.ppn.channels:
            trace = trace_channel(a.ppn, ch, sizing)
            if trace.num_edges == 0:
                continue
            ev = cb.ring_events(trace)
            lists.append(([torch.from_numpy(v).to(dev)
                           for v in (ev.kind, ev.value, ev.slot)], ev.ring))
        for ts, ring in lists:
            for order_op in (cb._FIFO, cb._REGISTER, cb._REORDER):
                got = cb.replay_events(*ts, ring, order_op)
                want = cb._replay_plain(*ts, ring, order_op)
                walk = cb._replay_walk(*ts, ring, order_op)
                worst = max(worst, int((got - want).abs().max()),
                            int((got - walk).abs().max()))
        errs[("replay", name)] = float(worst)
        check(worst == 0, f"replay {name}: kernel, plain version and walk "
              f"differ")
        events[name] = max(lists, key=lambda item: item[0][0].numel())
    for tiles, ring in REPLAY_RANDOM:
        n_ev = tiles * cb.REPLAY_TILE + 7
        ts = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            rng.integers(0, 4, n_ev), rng.integers(0, 64, n_ev),
            rng.integers(0, ring, n_ev))]
        for order_op in (cb._FIFO, cb._REGISTER, cb._REORDER):
            got = cb.replay_events(*ts, ring, order_op).tolist()
            walk = cb._replay_walk(*ts, ring, order_op).tolist()
            check(got == walk, f"replay, {n_ev} random events, ring {ring}, "
                  f"discipline {order_op}: {got} against the walk's {walk}")
    say("phase 4 main-path shapes: every kernel matches its plain version; "
        "the replay matches its walk on every channel's list and on random "
        "lists of " + ", ".join(f"{t * cb.REPLAY_TILE + 7} events (ring {r})"
                                 for t, r in REPLAY_RANDOM))

    # ---------------------------------------------------------- phase 5 --
    conv_w = {
        "jacobi-1d": torch.tensor([1.0, 1.0, 1.0]) / 3.0,
        "jacobi-2d": torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2],
                                   [0.0, 0.2, 0.0]]),
        "heat-3d": torch.zeros(3, 3, 3),
    }
    hw = conv_w["heat-3d"]
    hw[1, 1, 1] = 0.25
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        hw[idx] = 0.125
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
    rows = []
    for name, x in inputs.items():
        p = cg.STENCIL_PROGRAMS[name]
        cells = x.numel()
        w = conv_w[name].to(dev)[None, None]
        xin = x[None, None]
        fn = conv[x.dim()]
        lib_err = max_err(fn(xin, w, padding=1)[0, 0],
                          cg._addressable_plain(x, p))
        check(lib_err < 1e-4, f"{name}: conv yardstick err {lib_err}")
        traffic = hbm_traffic_model(cells, STEPS)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        d1, d2 = cg._inner_dims(x.shape)
        out = torch.empty_like(x)
        out2 = torch.empty_like(x)
        shape = shapes[name]
        if shape.mode == "wave":      # the wrapper's channels and flags
            flags, scratch = cg._wave_channels(
                x.device, cuda_lib.raw_stream(x.device), shape)
            flags = flags.data_ptr()
        else:
            flags = None
            scratch = torch.empty(shape.scratch_floats, device=dev)
        raw = {
            "ring_stencil": lambda: cuda_lib.RING_STENCIL(
                x.data_ptr(), out.data_ptr(), scratch.data_ptr(), flags,
                p.cuda_kind, x.shape[0], d1, d2, STEPS, BLOCK, STEPS + 1, 2,
                shape.ctas, shape.rows, shape.stride, shape.threads,
                shape.segments, shape.cols, shape.smem_bytes,
                cg.RING_MODES.index(shape.mode), stream),
            # ADDR_REPS launches queued back to back by one C call
            "addressable_step": lambda: cuda_lib.ADDRESSABLE_STEP(
                x.data_ptr(), out.data_ptr(), out2.data_ptr(), p.cuda_kind,
                x.shape[0], d1, d2, ADDR_REPS, stream, launches=ADDR_REPS),
        }
        for kernel, kfn, pfn, lfn, nbytes, flops in (
                ("ring_stencil",
                 lambda: cg.ring_stencil(x, p, STEPS, BLOCK, STEPS + 1, 2),
                 lambda: cg._ring_plain(x, p, STEPS, BLOCK, STEPS + 1, 2),
                 None, traffic["fifo_bytes"],
                 STEPS * cells * FLOPS_PER_CELL[name]),
                ("addressable_step", lambda: cg.addressable_step(x, p),
                 lambda: cg._addressable_plain(x, p),
                 lambda: fn(xin, w, padding=1),
                 traffic["naive_bytes"] / STEPS,
                 cells * FLOPS_PER_CELL[name])):
            bound_s, bound_by = h100.roofline_seconds(nbytes, flops)
            row = {
                "name": f"{kernel}[{name}]", "route": "cuda",
                "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                "launches": launches[(kernel, name)],
                "max_abs_err": errs[(kernel, name)],
                "plain_ms": cuda_ms(pfn, 3),
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "shape": list(x.shape), "steps": STEPS, "block": BLOCK}
            if kernel == "ring_stencil":
                # every launch mode the geometry takes, forced, each call
                # bit-equal to the path's own
                mode_ms = {}
                for m in cg.RING_MODES:
                    try:
                        forced = cg._ring_launch(tuple(x.shape), BLOCK,
                                                 STEPS + 1, 2, card, mode=m,
                                                 steps=STEPS)
                    except ValueError:
                        continue      # its tiles or its block fit no CTA
                    call = (lambda L=forced: cg._ring_stencil_with(
                        x, p, STEPS, BLOCK, STEPS + 1, 2, L))
                    check(torch.equal(call(), kfn()),
                          f"ring {name} in {m}: not bit-equal to the path's")
                    mode_ms[m] = device_ms(call, 5)
                say(f"phase 5 {name} ring device ms a launch by mode: "
                    f"{json.dumps(mode_ms)} (the path takes {shape.mode})")
                row.update(ms=cuda_ms(kfn, 20),
                           device_ms=device_ms(raw[kernel], 5),
                           library_ms=None, mode=shape.mode,
                           mode_device_ms=mode_ms,
                           ctas=shape.ctas, threads=(shape.threads + cg.COURIER
                                                     if shape.mode == "wave"
                                                     else shape.threads
                                                     * shape.segments),
                           smem_bytes=shape.smem_bytes)
            else:
                # the call and its library call in turns: their ratio has
                # crossed 1 from run to run
                k_ms, l_ms = [], []
                for _ in range(ADDR_ROUNDS):
                    k_ms.append(cuda_ms(kfn, 20))
                    l_ms.append(cuda_ms(lfn, 20))
                row.update(ms=statistics.median(k_ms),
                           device_ms=device_ms(raw[kernel], 1) / ADDR_REPS,
                           library_ms=statistics.median(l_ms),
                           ms_min_median_max=spread(k_ms),
                           library_ms_min_median_max=spread(l_ms))
                row["bound_share"] = row["bound_ms"] / row["device_ms"]
            rows.append(row)
        for kernel in ("ring_stencil", "addressable_step"):
            row = rows[-2 if kernel == "ring_stencil" else -1]
            busy = (row["device_ms"] * launches[(kernel, name)] / 1e3
                    / walls[name][kernel])
            say(f"phase 5 {name} {kernel} job T={TSTEPS}: "
                f"{walls[name][kernel]:.4f} s host clock, "
                f"{launches[(kernel, name)]} launches, device busy "
                f"{busy:.4f} of it")
        row = rows[-1]
        say(f"phase 5 {name} addressable_step call, {ADDR_ROUNDS} rounds "
            f"min/median/max: {row['ms_min_median_max']} ms, library "
            f"({fn.__name__}) {row['library_ms_min_median_max']} ms; device "
            f"{row['device_ms']:.5f} ms a launch, {row['bound_share']:.3f} "
            f"of the bytes bound")
        # the job again, warm (phase 2's first job also loaded the kernel),
        # and as one replayed CUDA graph, the alternative to the launches
        # queued from C
        t0 = time.perf_counter()
        cg.addressable_steps(x, p, TSTEPS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        # (capture only records the launches, and the replays are not
        # counted: the count is kept as it was, launches made)
        graph = torch.cuda.CUDAGraph()
        counted_before = cuda_lib.ADDRESSABLE_STEP.launches
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            yg = cg.addressable_steps(x, p, TSTEPS)
        capture_s = time.perf_counter() - t0
        cuda_lib.ADDRESSABLE_STEP.launches = counted_before
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(yg, addr_out[name]), f"{name}: graph job differs")
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        say(f"phase 5 {name} addressable_step job T={TSTEPS}, host clock: "
            f"{warm_s:.4f} s queued from C, warm ("
            f"{walls[name]['addressable_step']:.4f} s in phase 2), "
            f"{graph_s:.4f} s as a replayed CUDA graph ({capture_s:.4f} s "
            f"to capture and instantiate it)")
        row["job_s"] = walls[name]["addressable_step"]
        row["job_warm_s"] = warm_s
        row["job_graph_s"] = graph_s
        row["job_graph_capture_s"] = capture_s
        del graph, yg
        ts, ring = events[name]
        n_ev = ts[0].numel()
        ring_buf = torch.empty(ring, dtype=torch.int32, device=dev)
        out6 = torch.empty(6, dtype=torch.int32, device=dev)
        rows.append({
            "name": f"replay[{name}]", "route": "cuda",
            "source": SOURCES["replay"], "replaces": REPLACES["replay"],
            "launches": launches[("replay", name)],
            "max_abs_err": errs[("replay", name)],
            "ms": cuda_ms(lambda: cb.replay_events(*ts, ring, cb._FIFO), 20),
            "device_ms": device_ms(lambda: cuda_lib.REPLAY(
                *(t.data_ptr() for t in ts), n_ev, ring_buf.data_ptr(), ring,
                cb._FIFO, out6.data_ptr(), stream), 200),
            "plain_ms": cuda_ms(
                lambda: cb._replay_plain(*ts, ring, cb._FIFO), 3),
            "bound_ms": h100.roofline_seconds(3 * 4 * n_ev + 6 * 4, 0)[0]
            * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "events": n_ev, "ring_slots": ring,
            "tiles": -(-n_ev // cb.REPLAY_TILE),
            "validate_s": validate_s[name]})
    timing = cb.measure_compiled(planned("jacobi-1d").compile(), 4000,
                                 STEPS, BLOCK, repeats=5)
    say(f"phase 5 measure_compiled(jacobi-1d, 4000): {json.dumps(timing)}")
    for row in rows:
        say(f"phase 5 {row['name']}: {row['ms']:.4f} ms (device "
            f"{row['device_ms']}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} by "
            f"{row['bound_by']}, library {row['library_ms']})")

    # ---------------------------------------------------------- phase 6 --
    from repro_torch.bench import fig3_stencil
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     chunked_attention)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gla_timemix import timemix_op, timemix_ref
    from repro_torch.kernels.gla_timemix import kernel as gla
    from repro_torch.kernels.stencil_fifo import jacobi_fifo_op
    from repro_torch.kernels.stencil_fifo import kernel as sf

    def zero_counts():
        for k in cuda_lib.KERNELS:
            k.launches = 0

    x = inputs["jacobi-1d"]
    want = cg.STENCIL_PROGRAMS["jacobi-1d"].ref(x, TSTEPS)
    zero_counts()

    def fig3_job():
        y = x
        for _ in range(TSTEPS // STEPS):
            y = jacobi_fifo_op(y, STEPS, BLOCK)
        return y

    fifo = sf.fifo_launch(x.shape[0], BLOCK)
    torch.cuda.synchronize()              # the oracle's steps are queued
    t0 = time.perf_counter()
    y4 = fig3_job()
    torch.cuda.synchronize()
    walls["stencil_fifo"] = time.perf_counter() - t0
    launches["stencil_fifo"] = cuda_lib.STENCIL_FIFO.launches
    check(launches["stencil_fifo"] > 0, "stencil_fifo never launched")
    check(tuple(y4.shape) == tuple(x.shape)
          and bool(torch.isfinite(y4).all()), "fig3 job: output")
    check(close(y4, ring_out["jacobi-1d"]), f"fig3 job vs the ring job: "
          f"{max_err(y4, ring_out['jacobi-1d'])}")
    check(bool(torch.allclose(y4, want, **TOL_LONG)),
          f"fig3 job vs oracle: {max_err(y4, want)}")
    say(f"phase 6 fig3 jacobi-1d N={x.shape[0]} T={TSTEPS} as "
        f"{launches['stencil_fifo']} jacobi_fifo calls of {fifo.waves} "
        f"waves ({fifo.workers} blocks in flight, {fifo.rounds} round): "
        f"{walls['stencil_fifo']:.4f} s host clock, vs oracle "
        f"{max_err(y4, want):.3g}, vs the fifo-ring job "
        f"{max_err(y4, ring_out['jacobi-1d']):.3g}")
    zero_counts()
    fig3_rows = fig3_stencil.rows(args.seed)
    check(cuda_lib.STENCIL_FIFO.launches > 0
          and cuda_lib.RING_STENCIL.launches > 0, "fig3 rows: no launch")
    for row in fig3_rows:
        bias = row["steps"] * 2 ** -22 * row["oracle_max_abs"]
        check(row["err"] <= 1e-5 + bias, f"{row['name']}: err {row['err']}")
        check(row.get("vs_handwritten_err", 0.0) <= 1e-5,
              f"{row['name']}: vs hand-written "
              f"{row.get('vs_handwritten_err')}")
        say(f"phase 6 {row['name']}: {row['ms']:.4f} ms"
            + (f" ({row['waves']} waves)" if "waves" in row else "")
            + f", err {row['err']:.3g}"
            + (f", {row['vs_handwritten']:.3f}x of the hand-written time, "
               f"outputs differ by {row['vs_handwritten_err']:.3g}"
               if "vs_handwritten" in row else
               f", traffic {row['naive_bytes']:.3g} B -> "
               f"{row['fifo_bytes']:.3g} B"))

    # ---------------------------------------------------------- phase 7 --
    def randn(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    def qkv(B, S, H, KV, hd, dtype):
        return (randn((B, S, H, hd), dtype), randn((B, S, KV, hd), dtype),
                randn((B, S, KV, hd), dtype))

    attn = {}
    for dt in (torch.bfloat16, torch.float32):
        attn[(str(dt), ATTN["S"])] = qkv(**ATTN, dtype=dt)
    long_shape = dict(ATTN, S=ATTN_LONG_S)
    attn[(str(torch.bfloat16), ATTN_LONG_S)] = qkv(**long_shape,
                                                    dtype=torch.bfloat16)
    zero_counts()
    attn_out = {}
    for key, (q, k, v) in attn.items():
        before = cuda_lib.FLASH_ATTENTION.launches
        t0 = time.perf_counter()
        attn_out[key] = attention_op(q, k, v, causal=True)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        launches[key] = cuda_lib.FLASH_ATTENTION.launches - before
    check(cuda_lib.FLASH_ATTENTION.launches == len(attn),
          f"flash_attention launched {cuda_lib.FLASH_ATTENTION.launches} "
          f"times for {len(attn)} calls")
    for key, (q, k, v) in attn.items():
        o = attn_out[key]
        check(o.shape == q.shape and o.dtype == q.dtype
              and bool(torch.isfinite(o).all()), f"attention {key}: output")
        tol = ATTN_TOL[key[0]]
        blk = 128 if key[1] == ATTN["S"] else 2048
        plain = fa._flash_attention_plain(q, k, v, causal=True, bq=blk,
                                          bk=blk)
        errs[("flash_attention", key)] = max_err(o, plain)
        worst = attention_err(o, plain, tol)
        check(worst <= 1.0, f"attention {key} vs plain: "
              f"{errs[('flash_attention', key)]}, {worst} of the tolerance")
        msg = ""
        if key[1] == ATTN_LONG_S:
            ref = chunked_attention(q, k, v, causal=True, q_chunk=2048,
                                    kv_chunk=2048)
            worst_ref = attention_err(o, ref, tol)
            check(worst_ref <= 1.0, f"attention {key} vs chunked ref: "
                  f"{max_err(o, ref)}, {worst_ref} of the tolerance")
            msg = (f", vs chunked ref {max_err(o, ref):.3g} "
                   f"({worst_ref:.3g} of the tolerance)")
            del ref
        del plain
        say(f"phase 7 attention {key[0]} S={key[1]} (qwen2-7b: H=28 KV=4 "
            f"hd=128, causal): {walls[key]:.4f} s host clock, vs plain "
            f"{errs[('flash_attention', key)]:.3g} ({worst:.3g} of the "
            f"tolerance){msg}")

    # ---------------------------------------------------------- phase 8 --
    def gla_inputs(B, S, H, hd, decay_scale, dtype=torch.float32):
        arrs = [rng.normal(size=(B, S, H, hd)) for _ in range(3)]
        arrs.append(-np.exp(rng.normal(size=(B, S, H, hd)) * decay_scale))
        arrs.append(rng.normal(size=(H, hd)))
        return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                for a in arrs]

    gin = gla_inputs(**GLA, decay_scale=1.0)
    zero_counts()
    t0 = time.perf_counter()
    yg = timemix_op(*gin, chunk=GLA_CHUNK)
    torch.cuda.synchronize()
    walls["gla_timemix"] = time.perf_counter() - t0
    launches["gla_timemix"] = cuda_lib.GLA_TIMEMIX.launches
    check(launches["gla_timemix"] > 0, "gla_timemix never launched")
    check(yg.shape == gin[0].shape and bool(torch.isfinite(yg).all()),
          "gla_timemix: output not finite")
    plain = gla._gla_timemix_plain(*gin, chunk=GLA_CHUNK)
    errs["gla_timemix"] = max_err(yg, plain)
    check(bool(torch.allclose(yg, plain, **GLA_TOL)),
          f"gla_timemix vs plain: {errs['gla_timemix']}")
    ref = timemix_ref(*gin)
    check(bool(torch.allclose(yg, ref, **GLA_TOL)),
          f"gla_timemix vs sequential ref: {max_err(yg, ref)}")
    say(f"phase 8 gla_timemix (rwkv6-1.6b: H=32 hd=64, S=4096, chunk "
        f"{GLA_CHUNK}, decay scale 1.0): {walls['gla_timemix']:.4f} s host "
        f"clock, vs plain {errs['gla_timemix']:.3g}, vs sequential ref "
        f"{max_err(yg, ref):.3g}, |ref| max {float(ref.abs().max()):.3g}")
    del plain, ref

    # ---------------------------------------------------------- phase 9 --
    for n, bn in SMALL_FIFO + WIDE_FIFO:
        xs = randn((n,))
        got, want = sf.jacobi_fifo(xs, bn, bn), sf._jacobi_fifo_plain(
            xs, bn, bn)
        check(bool(torch.allclose(got, want, rtol=max(1e-5, bn * 2 ** -22),
                                  atol=1e-5)),
              f"stencil_fifo ({n}, {bn}): {max_err(got, want)}")
        # on the CPU PyTorch divides exactly, as the kernel does
        walk = sf._jacobi_fifo_walk(xs.cpu(), bn, bn)
        check(torch.equal(got.cpu(), walk), f"stencil_fifo ({n}, {bn}) vs "
              f"the grid walk: {max_err(got.cpu(), walk)}")
    attn_worst = {}                   # dtype: the worst error of its cases
    for B, S, H, KV, hd, causal, dname in SMALL_ATTN:
        dt = getattr(torch, dname)
        q, k, v = qkv(B, S, H, KV, hd, dt)
        got = fa.flash_attention(q, k, v, causal=causal)
        # the plain version's blocks: S's largest divisor up to 64
        blk = max(d for d in range(1, 65) if S % d == 0)
        want = fa._flash_attention_plain(q, k, v, causal=causal, bq=blk,
                                         bk=blk)
        tol = 1e-5 if dt == torch.float32 else ATTN_TOL[str(dt)]
        attn_worst[dname] = max(attn_worst.get(dname, 0.0),
                                max_err(got, want))
        check(bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"attention {(B, S, H, KV, hd, causal, dname)}: "
              f"{max_err(got, want)}")
    gla_worst = {}                    # dtype: the worst error of its cases
    for B, S, H, hd, chunk, scale, dname in SMALL_GLA:
        gs = gla_inputs(B, S, H, hd, scale, getattr(torch, dname))
        got = gla.gla_timemix(*gs, chunk=chunk)
        want = gla._gla_timemix_plain(*gs, chunk=chunk)
        tol = GLA_TOL if dname == "float32" else GLA_TOL_BF16
        gla_worst[dname] = max(gla_worst.get(dname, 0.0), max_err(got, want))
        check(got.dtype == gs[0].dtype and bool(torch.isfinite(got).all())
              and bool(torch.allclose(got.float(), want.float(), **tol)),
              f"gla {(B, S, H, hd, chunk, scale, dname)}: "
              f"{max_err(got, want)}")
    say("phase 9 small shapes: stencil_fifo, flash_attention and "
        "gla_timemix match their plain versions; stencil_fifo equals its "
        "grid walk bit for bit at " + ", ".join(
            f"({n}, {bn}: {sf.fifo_launch(n, bn).workers} in flight, "
            f"{sf.fifo_launch(n, bn).rounds} rounds)"
            for n, bn in SMALL_FIFO + WIDE_FIFO)
        + "; flash_attention's worst |kernel - plain|: " + ", ".join(
            f"{d} {e:.3g}" for d, e in attn_worst.items())
        + "; gla_timemix's: " + ", ".join(
            f"{d} {e:.3g}" for d, e in gla_worst.items()))

    # --------------------------------------------------------- phase 10 --
    out4 = torch.empty_like(x)
    n4 = x.shape[0]
    bound_s, bound_by = h100.roofline_seconds(
        2 * 4 * n4, FLOPS_PER_CELL["jacobi-1d"] * n4 * STEPS)
    rows.append({
        "name": "stencil_fifo[jacobi-1d]", "route": "cuda",
        "source": SOURCES["stencil_fifo"],
        "replaces": REPLACES["stencil_fifo"],
        "launches": launches["stencil_fifo"],
        "max_abs_err": max_err(sf.jacobi_fifo(x, STEPS, BLOCK),
                               sf._jacobi_fifo_plain(x, STEPS, BLOCK)),
        "ms": cuda_ms(lambda: sf.jacobi_fifo(x, STEPS, BLOCK), 20),
        "device_ms": device_ms(lambda: cuda_lib.STENCIL_FIFO(
            x.data_ptr(), out4.data_ptr(), n4, BLOCK, STEPS, fifo.workers,
            fifo.threads_per_worker, stream), 50),
        "plain_ms": cuda_ms(lambda: sf._jacobi_fifo_plain(x, STEPS, BLOCK),
                            3),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "library_ms": None, "shape": [n4], "steps": STEPS, "block": BLOCK,
        "waves": fifo.waves, "workers": fifo.workers, "rounds": fifo.rounds,
        "threads": fifo.threads})
    busy = (rows[-1]["device_ms"] * launches["stencil_fifo"] / 1e3
            / walls["stencil_fifo"])
    say(f"phase 10 stencil_fifo job T={TSTEPS}: "
        f"{walls['stencil_fifo']:.4f} s host clock, "
        f"{launches['stencil_fifo']} launches, device busy {busy:.4f} of it; "
        f"a call {rows[-1]['device_ms']:.5f} ms on the device over "
        f"{fifo.waves} waves")

    for key, (q, k, v) in attn.items():
        B, S, H, hd = q.shape
        KV = k.shape[2]
        long = S == ATTN_LONG_S
        reps = 1 if long else 5
        elem = q.element_size()
        nbytes = elem * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        flops = 4 * hd * B * H * (S * (S + 1) // 2)   # causal pairs
        peak = (h100.PEAK_FLOPS_FP32_PRODUCTS if q.dtype == torch.float32
                else h100.PEAK_FLOPS_BF16)
        bound_s, bound_by = h100.roofline_seconds(nbytes, flops, peak)
        o_raw = torch.empty_like(q)
        scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))

        def raw():
            cuda_lib.FLASH_ATTENTION(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o_raw.data_ptr(),
                B, S, H, KV, hd, 1, scale, fa._DTYPES[q.dtype], stream)

        # the yardstick: SDPA with k and v repeated to H heads so that head
        # h reads kv head h % KV (`repeat`, as the reference groups heads)
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat(1, H // KV, 1, 1).contiguous()
        vt = v.transpose(1, 2).repeat(1, H // KV, 1, 1).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        lib_out = sdpa().transpose(1, 2)
        lib_err = max_err(lib_out, attn_out[key])
        # a sanity check that the yardstick computes the same function (a
        # wrong head grouping is off by about the row's RMS); SDPA's kernels
        # may round the probabilities to bf16, float32 products to TF32 and
        # scale q in another precision
        lib_tol = 2e-2 if q.dtype == torch.float32 else 5e-2
        lib_worst = attention_err(lib_out, attn_out[key], lib_tol)
        check(lib_worst <= 1.0, f"SDPA yardstick {key}: err {lib_err}, "
              f"{lib_worst} of the tolerance")
        del lib_out
        blk = 128 if not long else 2048
        rows.append({
            "name": f"flash_attention[{key[0].split('.')[1]} S={S}]",
            "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"],
            "launches": launches[key],
            "max_abs_err": errs[("flash_attention", key)],
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          reps),
            "device_ms": device_ms(raw, reps),
            "plain_ms": cuda_ms(lambda: fa._flash_attention_plain(
                q, k, v, causal=True, bq=blk, bk=blk), 1 if long else 2),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": cuda_ms(sdpa, 3 if long else 20),
            "library": "F.scaled_dot_product_attention",
            "library_max_abs_err": lib_err,
            "shape": list(q.shape), "kv_heads": KV, "causal": True,
            "dtype": key[0], "flops": flops, "bytes": nbytes})
        # achieved rate and share of the bound, both on the device time
        rows[-1]["tflops"] = flops / rows[-1]["device_ms"] / 1e9
        rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["device_ms"]
        del qt, kt, vt, o_raw

    B, S, H, hd = gin[0].shape
    C = GLA_CHUNK
    # the chunkwise work (gla_work): the CUDA cores' operations at the
    # float32 rate and the products at three TF32 passes; the two units run
    # side by side, so the least time for the work is the larger of the two
    gla_ops, gla_flops = gla_work(B, S, H, hd, C)
    gla_ops_s = max(gla_ops / h100.PEAK_FLOPS_FP32,
                    gla_flops / h100.PEAK_FLOPS_FP32_PRODUCTS)
    gla_bytes = 4 * (5 * B * S * H * hd + H * hd)
    bound_s, bound_by = h100.roofline_seconds(
        gla_bytes, gla_ops_s * h100.PEAK_FLOPS_FP32)
    og = torch.empty_like(gin[0])
    ws = torch.empty(gla.workspace_floats(B, S, H, hd, C), device=dev)

    def gla_raw(phases):
        return lambda: cuda_lib.GLA_TIMEMIX(
            *(t.data_ptr() for t in gin), og.data_ptr(), ws.data_ptr(), B,
            S, H, hd, C, 0, phases, stream)

    # each phase alone (B and C then read what the phase before left in
    # the workspace; the values do not change the time)
    phase_ms = {name: device_ms(gla_raw(mask), 10)
                for name, mask in GLA_PHASES.items()}
    say(f"phase 10 gla_timemix phases, device ms: {json.dumps(phase_ms)}")
    rows.append({
        "name": "gla_timemix[rwkv6-1.6b f32 S=4096]", "route": "cuda",
        "source": SOURCES["gla_timemix"], "replaces": REPLACES["gla_timemix"],
        "launches": launches["gla_timemix"],
        "max_abs_err": errs["gla_timemix"],
        "ms": cuda_ms(lambda: gla.gla_timemix(*gin, chunk=C), 10),
        "device_ms": device_ms(gla_raw(7), 10),
        "plain_ms": cuda_ms(lambda: gla._gla_timemix_plain(*gin, chunk=C),
                            3),
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "library_ms": None, "shape": list(gin[0].shape), "chunk": C,
        "core_ops": gla_ops, "flops": gla_flops, "bytes": gla_bytes,
        "phase_device_ms": phase_ms})
    rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["device_ms"]
    del ws
    for row in rows[-5:]:
        say(f"phase 10 {row['name']}: {row['ms']:.4f} ms (device "
            f"{row['device_ms']}, plain {row['plain_ms']:.4f}, bound "
            f"{row['bound_ms']:.5f} by {row['bound_by']}, library "
            f"{row['library_ms']})" + (
                f", {row['tflops']:.1f} TFLOP/s" if "tflops" in row else "")
            + (f", {row['bound_share']:.3f} of the bound"
               if "bound_share" in row else "") + (
                f", {row['waves']} waves" if "waves" in row else ""))
    # the redesign order: first the kernels slower than their library call,
    # the largest factor first; then the rest by launches x (time - bound)
    for row in rows:
        row["redesigned"] = row["name"].split("[")[0] in REDESIGNED
        row["excess_ms"] = row["launches"] * (row["ms"] - row["bound_ms"])
        if row["library_ms"] is not None:
            row["vs_library"] = row["ms"] / row["library_ms"]
    order = sorted(rows, key=lambda r: (-r.get("vs_library", 0.0)
                                        if r.get("vs_library", 0.0) > 1
                                        else 0.0, -r["excess_ms"]))
    say("redesign order: " + "; ".join(
        f"{r['name']}{' (redesigned)' if r['redesigned'] else ''} "
        + (f"{r['vs_library']:.2f}x library, "
           if r.get("vs_library", 0.0) > 1 else "")
        + f"{r['launches']} x (time - bound) = {r['excess_ms']:.4f} ms"
        for r in order))

    # --------------------------------------------------------- phase 11 --
    t0 = time.perf_counter()
    dse_phase()
    say(f"phase 11 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 12 --
    t0 = time.perf_counter()
    fault_launches = faults_phase(planned)
    for row in rows:
        if row["name"].startswith("replay["):
            stencil = row["name"][len("replay["):-1]
            row["fault_matrix_launches"] = fault_launches[stencil]
    say(f"phase 12 done in {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]

    # --------------------------------------------------------- phase 13 --
    t0 = time.perf_counter()
    pipeline_phase(args.seed, smi_line)
    say(f"phase 13 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 14 --
    t0 = time.perf_counter()
    attn_row = next(r for r in rows
                    if r["name"] == f"flash_attention[bfloat16 S={ATTN['S']}]")
    model_launches = model_phase(args.seed, smi_line, attn_row["device_ms"])
    for row in rows:
        row["model_path_launches"] = model_launches[row["name"].split("[")[0]]
    say(f"phase 14 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 15 --
    t0 = time.perf_counter()
    train_launches = train_phase(args.seed, smi_line)
    for row in rows:
        row["train_path_launches"] = train_launches[row["name"].split("[")[0]]
    say(f"phase 15 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 16 --
    t0 = time.perf_counter()
    family_launches = family_phase(args.seed, smi_line)
    for row in rows:
        row["family_path_launches"] = family_launches[
            row["name"].split("[")[0]]
    say(f"phase 16 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 17 --
    t0 = time.perf_counter()
    dryrun_launches = dryrun_phase(args.seed, smi_line)
    for row in rows:
        row["dryrun_path_launches"] = dryrun_launches[
            row["name"].split("[")[0]]
    say(f"phase 17 done in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- phase 18 --
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(args.seed, smi_line)
    for row in rows:
        row["mesh_path_launches"] = mesh_launches[row["name"].split("[")[0]]
    say(f"phase 18 done in {time.perf_counter() - t0:.1f} s")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    say(smi_line)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
