#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives ``repro_torch`` only (never JAX or the JAX package), on the card,
and fails (non-zero exit, no result line) when any phase fails:

Phase 0  build every kernel of the ported paths from ``src/repro_torch``
         (one nvcc per source, all at once, the flash-attention source
         among them); print the build times, what ``-Xptxas -v`` reports
         (each instance's registers and spills, and every ptxas warning, a
         serialized-wgmma note among them: the GEMM's and the conv's
         3xTF32 wgmma instances and every flash-attention instance, bf16
         and f32, must show neither a spill nor a warning), and the card's
         name and power limit.
Phase 1  the paged-decode kernel against its plain PyTorch version, on the
         card, at the serving path's shapes and a few variants (among them
         each head shape that phase 17 serves: qwen2-moe's MHA, Hq 16 = Hkv
         16, D 128; gemma-2b's MQA, Hq 8, Hkv 1, D 256); max |error|
         against a stated tolerance; CUDA-event times of both beside the
         kernel's least possible time (its bound), at the serving shapes,
         at h2o-danube's heads (D 120: Hq 32, Hkv 8, window 40) and at a
         long context (4 requests of 4096 positions).
Phase 2  the serving path: llama3-8b at full width and depth with random
         f32 weights from a seed, through ``compile_serve``; 8 requests of
         2-512 prompt tokens and 32 new tokens each, drained.  Launch counts
         are zeroed just before the drain and read just after: every kernel
         of the path must have launched (paged decode: exactly decode steps
         x 32 layers, conv and flash: never).  Then one decode step with the plain
         attention and one with the kernel on the same live state must agree.
Phase 3  the direct-conv kernel against its plain version, f32 with TF32
         off, at every conv layer of VGG-A and OverFeat-FAST at batch 64;
         CUDA-event times of the kernel, the plain version, ``F.conv2d``
         (the library call) and the reference backward, beside two bounds:
         the kernel's own (3xTF32 on the tensor cores) and the FFMA one.
Phase 4  the training path: full-width VGG-A through ``compile_run`` and
         ``Run.fit`` for 6 steps of batch 64 with every forward conv on the
         kernel.  Launch counts are zeroed just before ``fit`` and read just
         after (conv: exactly 8 x 6, paged decode and flash: never).  Then one forward
         and backward through the kernel and one through the plain route,
         from the same params and batch, must agree.

Phase 5  the three ring kernels (``ring_reduce_scatter``, ``ring_all_gather``,
         ``ring_hop_accum``) against their plain versions, bitwise, at G in
         {1, 2, 3, 4, 8} and strips of 1 to 2^20 + 3 elements, f32 and bf16,
         16-byte-aligned and unaligned rows and a member stride of 0, one
         launch a call; then CUDA-event times of each kernel, its plain
         version and its library yardstick over VGG-A's 14 fusion buckets at
         G = 4 (the reduce-scatter of the zero1 path's stride-0 stacks and of
         G distinct partials, 14 launches each; one hop beside ``torch.add``),
         beside the bound.
Phase 6  the zero1 path: full-width VGG-A through ``compile_run`` with
         ``parallel="zero1"``, G = 4 members on the card
         (``MeshSpec(members_per_device=4)``) and the ``pallas-ring`` backend,
         every forward conv on the kernel, ``Run.fit`` for 4 steps of batch 64.
         Launch counts are zeroed just before ``fit`` and read just after:
         reduce-scatters = steps x 14 buckets, all-gathers = steps x 14,
         conv = steps x 8, paged decode, flash and the process hop never.  Then the
         strip state's layout, the replication invariant (every member's
         gathered buffer bitwise the same), one step split into reduce, apply
         and broadcast, and two parity gates against the serial update.
Phase 8  the three wire-format kernels (``int8_quantize``, ``ring_hop_int8``,
         ``ring_hop_topk``) against their plain versions, bitwise: whole
         member-batched int8 and top-k rings at G in {2, 3, 4, 8} over chunks
         of 1 to 2^20 + 3 elements, aligned, unaligned, wide-stride, stride-0,
         all-zero and subnormal stacks, the per-member forms with host and on-card
         chunk indices, and both rings at VGG-A's 14 bucket shapes at G = 4;
         ``torch.profiler`` must show one int8 call as one kernel on the
         card and no memset; then CUDA-event times of each kernel and its
         plain version (top-k also ``index_add``) beside the bound, and the
         int8 calls' device time alone (CUDA graphs) beside their two-pass
         floor.
Phase 9  the zero1 path under ``wire_format="int8"`` and ``"topk"`` (ratio
         0.05, error feedback; then again at 0.25, ``BENCH_fig5.json``'s):
         full-width VGG-A, G = 4 members on the card, 3 steps of batch 64
         each.  Launch counts are zeroed just before
         ``fit`` and read just after (int8: 14 quantize + 42 hops a step;
         top-k: 42 hops; both 14 gathers, 8 convs; flash never).  Then the replication
         invariant, the update split into reduce, apply and broadcast; for
         int8 the strips against the fp32 ring's within the largest scale of
         each bucket's messages, for top-k kept + residual == buffer bitwise;
         and one whole update through the kernels bitwise the same update
         through their plain versions on the card.
Phase 10 the blocked-GEMM kernel against its plain version, f32 with TF32
         off, at CD-DNN's three layer shapes at batch 1024 and at ragged and
         small shapes (M = 1, K = 1, N a multiple of no tile) and the
         reference's test shapes, f32 and bf16 inputs, at the solver's tile
         and every compiled tile; CUDA-event times of the kernel, the plain
         version and ``torch.matmul`` (the library call) per CD-DNN shape
         and summed over one forward's 8 layers, beside two bounds: the
         kernel's own (3xTF32 on the tensor cores) and the FFMA one.
Phase 11 the CD-DNN path: full-width CD-DNN through ``compile_run`` and
         ``Run.fit``, every forward product on the kernel, 6 steps of batch
         1024 serially and then with ``parallel="zero1"``, G = 4 members on
         the card and the ``pallas-ring`` backend.  Launch counts are zeroed
         just before each ``fit`` and read just after (GEMM: steps x 8 in
         both; zero1 also steps x buckets reduce-scatters and steps x
         buckets gathers; nothing else, flash included).  Then the kernel route against the plain
         route from the same params and batch, the zero1 params and losses
         bitwise the serial run's, and one zero1 update split into reduce,
         apply and broadcast.
Phase 12 the flash-attention kernel against its plain version: a feature
         grid (B 2; Sq 1, 64, 200, 256; Skv = Sq and Sq + 64; (Hq, Hkv)
         (4, 4), (8, 4), (32, 8); D 32, 64, 128, 256; causal and not;
         window 0 and 48; softcap 0 and 50; bf16 and f32) and the training
         path's shapes (gemma2-2b's global and local layers at B 2, S 1024,
         its local layer at B 1, S 8192, llama3-8b's at B 1, S 2048; and
         head dims between the compiled instances, which run the 128 one:
         zamba2-2.7b's shared attention at B 2, S 1024, Hq = Hkv = 32, D
         80, h2o-danube-3-4b's at B 1, S 2048, Hq 32, Hkv 8, D 120,
         window 4096, their bounds counting the true D);
         bf16 within one ulp of each (batch, head) slice's largest
         magnitude, f32 within 2e-5 of max |plain|; CUDA-event times of the
         kernel and the plain version at the model shapes, and of
         ``F.scaled_dot_product_attention`` (the library call) beside the
         kernel's where it computes the same function without the softcap;
         the bound, the achieved TFLOP/s and the share of the bf16
         tensor-core bound.  The f32 instances (a split pass, then six bf16
         wgmma products a product) at the same four shapes, also as CUDA
         graphs, beside their bound (six bf16 products at the tensor-core
         peak) and the FFMA one, and beside ``F.scaled_dot_product_attention``
         in f32 where the window is 0, with the GEMM kernels that call
         launches (``torch.profiler``).  Then the f32 path: gemma2-2b's two
         attention blocks at full width on f32 activations of 2 x 1024,
         forward and backward through ``layers.attention_block(use_kernel=
         True)``; counts zeroed just before and read just after (flash: 2,
         everything else 0), and the kernel route against the plain route.
Phase 13 the LM training path: gemma2-2b at full width and depth
         (2,614,222,080 f32 params) through ``compile_run`` and ``Run.fit``,
         AdamW, 4 steps of batch 2 x 1024 tokens of the seeded
         ``lm_token_stream``, every attention forward on the flash kernel.
         Launch counts are zeroed just before ``fit`` and read just after
         (flash: exactly 26 x 4; every other kernel: never).  Then the step
         split into forward, backward and update, and, with the optimizer
         state freed, the kernel route against the plain route from the same
         params and batch, held to the network's own one-ulp sensitivity.
Phase 14 the overlapped zero1 path (paper §3.1): ``compile_run`` with
         ``CommConfig(overlap=True)``, every bucket's reduce issued inside
         the backward pass on a side CUDA stream.  Full-width VGG-A, G = 4
         members on the card, every forward conv on the kernel: 4 steps of
         batch 64 in fp32 and 3 under int8, then full-width CD-DNN (6 steps
         of batch 1024, every forward product on the kernel), each fit and
         check under a deadline that ends the run (a stack dump, exit code
         1) if a side-stream reduce hangs.  Launch counts are zeroed just
         before each fit and read just after (VGG-A fp32: reduce-scatters
         and all-gathers steps x 14, conv steps x 8; int8: 14 quantize and
         42 hops a step instead of the reduce-scatters; CD-DNN: GEMM steps
         x 8, reduce-scatters and gathers steps x 14; nothing else).  Then
         one step split into forward, backward+reduce and exposed_reduce
         (CUDA events), apply and broadcast, with the launch counts read
         when ``autograd.grad`` returns (every reduce, no gather) and after
         the step (the gathers); the strip state's layout and the
         replication invariant; the monolithic and the overlapped step
         alternating on one batch (step medians, peak memory);
         ``torch.profiler``'s kernel timestamps (how much of the side
         stream's kernel time ran beside the compute stream's kernels);
         for fp32, one step with grad_clip=0 bitwise the monolithic step
         from the same params, state and batch (3 times), and 3-step
         losses against the monolithic run's.
Phase 15 checkpoints, resume and the cluster (after phase 14).  (a) In
         this process, full-width VGG-A zero1 at G = 4 members on the card
         (``pallas-ring``, every forward conv on the kernel, batch 64,
         deterministic cuDNN), each fit under a ``faulthandler`` deadline:
         4 uninterrupted steps against 2 steps, a checkpoint, a fresh
         ``compile_run`` and 2 more (auto-resumed by ``Run.fit``), params
         and strips bitwise; counts zeroed just before each fit and read
         just after (per step 8 convs, 14 reduce-scatters, 14 all-gathers,
         nothing else); the checkpoint's bytes and its write and restore
         seconds; then the same checkpoint resumed at G = 2 (strips
         re-planned) against an uninterrupted G = 2 run, final loss within
         1e-5 of the loss, and a control whose world meta misreads the
         owner order must miss it.  (b) ``python -m
         repro_torch.launch.cluster --processes 2 --use-kernel`` at full
         width on the card (gloo, since the ranks share it; ``pallas-ring``
         in and across pods, f32, batch 64, 6 steps, a checkpoint every 2,
         worker 1 killed at step 3, ``--verify``, ``--trace-dir``) in a
         session killed whole at its timeout: exit 0, world 2, the chaos
         kill of worker 1 (exit code -9) the one failed attempt, the
         relaunch at world 1 resuming from the step-2 checkpoint,
         |cluster - one process| within 1e-5 of the loss, a dropped rank's
         final loss (emulated in this process) 10 times outside it, the
         ``step``, ``data_wait``, ``first_step`` and ``ckpt_write`` spans in
         the merged Chrome trace; then a world-2 run of 6 steps without a
         kill or a checkpoint for its step times and each rank's launches
         (its trace's ``launches/<kernel>`` counters: 14 ``ring_hop_accum``
         and 8 convs a step); then ``python -m repro_torch.launch.train``
         once (zero1, 2 steps, a checkpoint).  The attempts, the per-step
         seconds of each world and the wall seconds.
Phase 16 the stale-sync and gossip update modes and ``comm="auto"`` (after
         phase 15), full-width VGG-A at batch 64, G = 4 members on the card,
         every forward conv on the kernel, deterministic cuDNN.  (a)
         stale-sync on ``pallas-ring``, 4 steps (counts zeroed just before
         the fit and read just after: per step 8 convs, 14 reduce-scatters,
         14 all-gathers, nothing else); three full-width gradients [g0, g1,
         g2] through the update bitwise the serial optimizer on [g0, g0,
         g1]; its first train step bitwise zero1's from the same params and
         batch.  (b) gossip (shifts 1, 2, 3, 1): the member-batched pair add
         (``ring_hop_accum_members``, the fold kernel) bitwise its plain
         version at the 14 bucket shapes, each shift, on 4 distinct random
         partials, and its summed time; ``GossipBackend.part_reduce`` on the
         same rows bitwise the pair sum written out member by member; 4
         steps (per step 8 convs, 14 folds, 14 all-gathers, no
         reduce-scatter); the replication invariant; the losses against
         zero1's on the same batches; each mode's median step.  (c)
         ``python -m repro_torch.launch.cluster --parallel stale-sync``
         and ``--parallel gossip``, 2 gloo processes each on the card
         (the two runs at once), full width, 3 steps, ``--verify`` within
         1e-5 of the loss.  (d)
         ``comm="auto"``: every (backend, wire format) pair probed and
         fitted on its own, every probe's time, each pair's SWlat and BW and
         the chosen bucket size, backend and wire format, labelled as one
         card's device memory traffic; 2 steps with the plan bitwise a run
         given it, their launches those the plan's backend, wire format and
         collectives require.
Phase 17 the MoE family and dense decode (after phase 16), each model
         freed before the next.  (a) qwen2-moe-a2.7b at full width and
         depth (24 layers, 60 experts top-4 + 4 shared; 14,004,422,656 f32
         params from seed 0) through ``compile_serve`` with phase 2's spec:
         8 requests of 2-512 prompt tokens and 32 new tokens, drained with
         the counts zeroed just before and read just after (paged decode
         exactly decode steps x 24, everything else never); tok/s, decode
         step, TTFT and end-to-end p50/p99, peak memory, the time to cast
         every weight to bf16; then one decode step on a live state,
         kernel against gather with the router's choices pinned to the
         gather run's, held to twice the logits' measured one-ulp
         sensitivity (pinned too; never under phase 2's gate), greedy
         tokens equal where decided, the unpinned run's router choices
         that differ counted.  (b)
         h2o-danube-3-4b (3,961,839,360 params, D 120, window 4096), 4
         requests, the same checks.  (c) gemma-2b (2,506,172,416 params,
         MQA, D 256) through ``serve.decode.generate``, greedy, 4 prompts
         of 64-200 tokens, 32 new each: no kernel launches (the ring-buffer
         decode is the plain ``decode_attention_ref``), its tokens equal to
         a ``compile_serve`` drain of the same prompts until a step where
         the top-2 margin is within twice the logits' difference; one
         decode step's time.  (d) qwen2-moe-a2.7b at full width and 2 of
         its 24 layers (1,452,271,616 params) through ``compile_run`` and
         ``Run.fit``, AdamW, 4 steps of 2 x 1024 tokens on the flash kernel
         (flash exactly 2 x 4, nothing else); losses finite, the aux loss
         positive; the kernel route against the plain route with the
         router's choices pinned to the plain route's, as phase 13 holds
         it, and the unpinned route's differing choices counted.
Phase 18 the SSM, hybrid, vision and audio families (after phase 17),
         each model at its published widths with random f32 weights from
         seed 0, trained through ``compile_run`` and ``Run.fit`` with
         AdamW and every attention forward on the flash kernel (counts
         zeroed just before each fit and read just after: flash exactly
         steps x attention blocks, everything else never), then freed.
         (a) zamba2-2.7b (1,981,756,080 params; 54 blocks, 9 x (5 Mamba2
         + the shared attention+MLP block, D 80 on the 128 instance)), 3
         steps of 2 x 1024 tokens: 9 flash launches a forward; the step
         split (CUDA events), its idle share (``torch.profiler``), each
         block kind's share of a forward + backward (CUDA events around
         every block and its backward, in the model); the kernel route against the plain route at
         phase 13's gate; then, on fresh weights from seed 0,
         prefill(128) + decode(1) against the full forward: on f32
         activations and caches within the reference's decode-consistency
         tolerance (rtol = atol = 0.05), on bf16 activations within 10x
         the logits' one-ulp sensitivity; greedy ``generate`` of 2 prompts
         of 128 tokens, 32 new, with no kernel launch.  (b) qwen2-vl-2b
         (1,543,656,960 params) on ``vlm_stream``'s batches of 1024 vision
         stub tokens + 1024 text tokens with M-RoPE positions, 3 steps, 28
         launches a forward (D 128, GQA 12 / 2); the route gate;
         ``generate`` of 16 tokens.  (c) musicgen-medium (1,377,977,856
         params) on ``audio_stream``'s 2 x 1024 frames, 4 codebook heads,
         3 steps, 48 launches a forward (D 64); the token embedding and LM
         head, which the loss does not reach, move by AdamW's weight decay
         alone; the route gate.  (d) xlstm-125m (123,684,144 params), 2
         steps of 2 x 1024 tokens, no kernel; the sLSTM scan's time (1024
         sequential steps issued by the host); decode consistency and
         ``generate``.
Phase 19 the paper's §3.3 hybrid (after phase 18): a model axis on the
         card, random f32 weights from seed 0, data from the seeded
         streams.  (a) CD-DNN at full width on a ``{data: 2, model: 2}``
         local mesh (``MeshSpec(members_per_device=2, model_ways=2)``),
         every FC forward on the GEMM kernel as one launch per model member
         (16 a step), 6 steps each under zero1 (pallas-ring: one
         reduce-scatter and one all-gather per bucket of the full tree a
         step), dp and zero1-gspmd; each held against the serial run from
         the same params and batches (every loss, every leaf's update) at
         10x the one-ulp sensitivity measured in the run; step time, the
         forward / backward / update split, peak memory; the GEMM's time
         per shard beside the whole layer's.  (b) VGG-A, batch 64, dp at
         the same mesh, deterministic cuDNN, 4 steps, 16 conv launches a
         step, the same gate.  (c) the process path: 4 gloo ranks on the
         card (``make_process_mesh(model_ways=2)``, spawned as phase 7's
         members), CD-DNN zero1 on pallas-ring for 3 steps: each rank 8
         GEMM launches and one ``ring_hop_accum`` per bucket a step, its
         losses held to (a)'s local-mesh zero1 run at (a)'s loss gate;
         ranks leave as phase 7's do.
Phase 20 the transformer family's model ways (after phase 19): every LM at
         ``{data: 2, model: 2}`` on the card, random f32 weights from seed
         0, the seeded streams, every attention forward on the flash
         kernel once per model member.  Each part's gate is phase 13's on
         the run's params after its fit and its next batch: the
         model-ways route against the serial route on the same full
         params, the loss within ``LM_LOSS_REL_TOL`` and every leaf's
         gradient within 10x the serial route's one-ulp sensitivity, never
         tighter than ``LM_GRAD_REL_L2_TOL``.  (a) gemma2-2b at full width
         and depth under dp, 4 steps of 2 x 1024 tokens: exactly 52 flash
         launches a step (2 members x 26 layers), step time, tokens/s, the
         forward / backward / update split, peak memory, and the flash
         kernel on one member's heads beside the whole layer's.  (b)
         llama-100m at full width and depth under zero1-gspmd and zero1
         (pallas-ring: one reduce-scatter and one all-gather per bucket of
         the full tree a step), 4 steps of 8 x 512; gemma-2b at full width
         and 2 layers under dp (4 q heads and the one kv head a member), 3
         steps.  (c) qwen2-moe-a2.7b at full width and 2 layers, 1 x 128
         tokens, dp, 3 steps: the experts on the model axis (30 a member),
         then ``moe_expert_pad=4`` on ``moe_ep_block`` (32 a member);
         router choices pinned to the serial pass's in the gate, and no
         assignment dropped at either route's capacities.  (d) gemma-2b at
         full width and depth through ``serve.decode`` with
         ``hybrid.plan``'s rules (``cache_seq`` on "model"): a 2 x 64
         prompt and 16 steps teacher-forced on the unsharded run, every
         step's logits within 10x the one-ulp sensitivity (at least 4 bf16
         ulps), the written slots equal and layer 0's bitwise.  (e) 4 gloo
         ranks on the card, llama-100m zero1 on pallas-ring, 2 steps: each
         rank 12 flash and one ``ring_hop_accum`` per bucket a step, its
         losses within ``LM_LOSS_REL_TOL`` of (b)'s local run.
Phase 21 the planning tools and the examples (after phase 20; every part
         on the card, random f32 weights from seed 0, attention on the
         flash kernel wherever a run takes ``use_kernel``).  (a)
         qwen2-vl-2b at full width under dp at ``{data: 1, model: 8}``: its
         12 q heads do not split over 8 ways while its q_dim does, so every
         member takes the four projections whole; two steps of 1 x (1024
         vision + 1024 text), each loss within ``LM_LOSS_REL_TOL`` of the
         serial run's, 28 flash launches a step each; then phase 20's gate
         on the 8-way run's params (every gradient leaf against the serial
         route's).  (b) gemma2-2b at phase 13's size at ``remat="block"``
         against ``"none"``: 2 steps each, 26 flash launches a step at
         "none" and 52 at "block" (each attention forward recomputed
         once), step time and peak memory, the histories equal; then one
         forward and backward of each on the same params and batch with
         AdamW freed: the loss and every gradient leaf bitwise equal (the
         recompute runs the same kernels on the same inputs), the peak
         lower at "block".  (c) that step, at "block" on the plain route, counted by
         ``FlopCounterMode`` on the card and by ``launch.dryrun.count_step``
         on ``meta``: the counts equal; the roofline's compute and memory
         terms at that size (data sheet) beside the measured steps; then
         the dry run of gemma2-2b x train_4k and llama3-8b x decode_32k at
         16 x 16 and mixtral-8x22b x train_4k at 2 x 16 x 16, each
         ``useful_ratio`` in (0, 1.05].  (d) the examples:
         ``launch.quickstart`` as it stands, ``launch.train_lm_100m --steps
         30 --use-kernel`` (30 x 12 flash launches) and again (nothing to
         train), ``launch.serve_batched`` on gemma2-2b (paged launches =
         decode steps x layers).  Every shape (a), (b) and (d) hand the
         flash kernel is then held to its plain version at phase 12's gate.
Phase 22 several members a process and model ways on the cluster (after
         phase 21): two gloo ranks share the card, each holding
         ``--local-devices 2`` members (``launch.mesh.ClusterMesh``), at
         full width, every forward on the kernel, through the cluster CLI.
         (a) VGG-A zero1 at ``--model-ways 2``, mesh (2, 1, 2), 3 steps of
         batch 64, ``--verify`` within phase 15b's relative tolerance; rank
         0 launches 16 convs a step (a member's half of each layer's output
         channels) and one ``ring_hop_accum`` a bucket a step across the
         pods.  (b) CD-DNN zero1, mesh (2, 2, 1), batch 1024, 6 steps, a
         checkpoint every 2, the chaos kill at step 3: world 2, the kill,
         world 1 on a 2-member local mesh from the checkpoint,
         ``--verify``; then its first 3 steps at world 2 unkilled: per
         bucket a step the in-pod ``ring_reduce_scatter`` and
         ``ring_all_gather`` on the rank's two members and one
         ``ring_hop_accum`` for both across the pods, 8 GEMMs a step.
         (c) those 3 steps under ``--wire-format int8``, ``--verify`` (the
         CLI's own tolerance: the one-process run rounds no message):
         ``int8_quantize`` and ``ring_hop_int8`` 3 a bucket a step (the
         in-pod ring's member-batched pair, each member's own ring across
         the pods).  Every run's step seconds per rank and wall time.
Phase 7  the process path on the same card: two processes over gloo, one
         member each, run the zero1 update of full-width VGG-A on a
         ``ProcessMesh`` under fp32, int8 and top-k; each hop's combine is
         ``ring_hop_accum``, ``ring_hop_int8`` or ``ring_hop_topk`` (counts
         zeroed just before, read just after: one hop per bucket, and one
         quantize per bucket under int8), and the params (and the top-k
         residual) must equal a local mesh's bitwise.  Then one overlapped
         zero1 step of full-width VGG-A (batch 8, grad_clip=0,
         deterministic cuDNN) on the ProcessMesh, its hops issued inside
         the backward (one ``ring_hop_accum`` per bucket), bitwise the same
         step on a local mesh.  The plain reduce-scatter of card buffers
         over gloo must refuse (it would sum them in host memory).  A
         member that succeeds waits for the other and leaves with ``os._exit(0)``,
         without gloo's teardown; every member must exit with code 0.  It
         runs last.

The line before the last is a JSON object of per-kernel findings (each
row's ``launches`` includes ``launches_overlap``, its launches on the
overlapped path of phases 14 and 7, and the conv's and ring rows'
``launches_resume`` and ``launches_cluster``, their launches on phase 15a's
resumed fit and on one rank of phase 15b's world-2 run, and
``launches_modes``, on phase 16's stale-sync, gossip and ``comm="auto"``
fits, and the paged and flash rows' ``launches_moe``, on phase 17, and
the flash row's ``launches_families``, on phase 18's fits, and the conv,
GEMM and ring rows' ``launches_hybrid``, on phase 19's fits and one rank of
19c, and the flash and ring rows' ``launches_lm_model``, on phase 20's
fits and one rank of 20e, and the flash and paged rows'
``launches_tools``, on phase 21's fits and examples, and the conv, GEMM,
ring and int8 rows' ``launches_cluster_local``, on rank 0 of each of phase
22's four runs), the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's data-sheet figures that every bound below divides by: device
# memory 3.35 TB/s, f32 outside the tensor cores 67 TFLOP/s
from repro_torch.configs.base import H100_SXM  # noqa: E402
from repro_torch.core.sharding import ShardingCtx  # noqa: E402

# the models' sharding context with no mesh (the serial route), the
# argument the LM functions take in the reference's position
NO_MESH = ShardingCtx()

REL_L2_TOL = 0.025             # kernel vs gather decode logits, phase 2
LONG_CONTEXT = 4096             # positions a request, phase 1's long timing
# phase 3: max |kernel - plain| over max |plain| of a conv layer.  Each
# output is an f32 sum of up to K*K*IFM = 9216 products, which the kernel
# (as three TF32 products each, promoted to an f32 sum every 32 of the
# depth) and cuBLAS take in different orders; with unit-scale inputs their
# rounding differs by a few 1e-6 of the output's scale
# (tests/test_torch_tf32x3_numerics.py emulates the kernel's).
CONV_REL_TOL = 2e-5
# phase 4: kernel route vs plain route from the same params and batch.  The
# forward convs differ by rounding (above) in each of 8 layers, carried
# through 3 FC layers: the loss to a relative 1e-5.  The backward is the
# same cuDNN call on both routes, run deterministically for the check, but
# at full width with random weights the gradients below the last two FC
# layers are small sums of large per-sample terms of both signs, so any
# f32-level change of the forward moves them by ~1e-3 in relative L2.  Where
# that jump starts depends on which ReLU or pool near-tie the change happens
# to tip, and two changes of the same size tip different ones: a leaf can
# move by 2e-3 under one and by 1e-5 under the other.  So the run measures
# the network's sensitivity as one number, the largest relative L2 of any
# leaf's gradient when every conv weight is scaled by 1 + 2^-23, and holds
# every leaf of the kernel route to SENSITIVITY_FACTOR times it, never
# tighter than GRAD_REL_L2_TOL; a backward wired wrongly differs by O(1).
# The check runs on the params as initialised, not as trained: the training
# steps use cuDNN's non-deterministic backward, so trained params differ
# from run to run, and the check's outcome with them.
LOSS_REL_TOL = 1e-5
GRAD_REL_L2_TOL = 1e-4
SENSITIVITY_FACTOR = 10.0
# phase 6 (a): one update of the same clipped gradients, serial vs zero1,
# held bitwise (no tolerance), and the ring's mean of the gradient with it.  The ring's sum of G = 4 equal f32 rows,
# ((g + g) + g) + g, is 4g exactly: 3g rounds by at most half an ulp of 3g,
# which is under half an ulp of 4g, and a tie (3g's last bits ...10) needs
# an even significand, whose 4g rounds back to itself.  So the mean is g
# bitwise, and the strip update runs the serial optimizer's elementwise
# arithmetic on the same numbers.
# phase 6 (b): 3-step losses, zero1 vs serial from the same seed, under
# deterministic cuDNN.  By (a) the two runs take the same steps; the limit
# is the one phase 4 holds a one-ulp weight change to (~1e-7 relative
# measured there), so a step that goes astray in the data, the clipping or
# the schedule shows.
ZERO1_LOSS_REL_TOL = 1e-5
RING_GS = (1, 2, 3, 4, 8)
RING_NS = (1, 3, 250, 2 ** 20 + 3)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def graph_ms(fn, warmup=3, reps=20) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured as a CUDA
    graph: the device's time alone, no host time between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, warmup, reps)


def device_ops(fn):
    """Names of the kernels and memory operations ``fn`` puts on the card,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def cuda_ms(fn, warmup=10, reps=50) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class SyncedSpans:
    """A recorder for ``Server`` and ``Trainer``: host-clock span times that
    end in a device synchronise, summed per kind, and counts."""
    sync = True

    def __init__(self):
        self.seconds = {}
        self.samples = {}
        self.counts = {}

    def span(self, kind, **attrs):
        rec = self

        class _Span:
            def __enter__(self):
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                torch.cuda.synchronize()
                dt = time.perf_counter() - self.t0
                rec.seconds[kind] = rec.seconds.get(kind, 0.0) + dt
                rec.samples.setdefault(kind, []).append(dt)
                return False

        return _Span()

    def event(self, kind, **attrs):
        pass

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def reset(self):
        self.seconds.clear()
        self.samples.clear()
        self.counts.clear()


# ---------------------------------------------------------------------------
# phase 1: paged decode attention, kernel vs plain
# ---------------------------------------------------------------------------
def paged_inputs(dev, B, Hq, Hkv, D, ps, n, P, lengths, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).bfloat16()
    pk = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).bfloat16()
    pv = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).bfloat16()
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * n] + 1)
    pt = pt.reshape(B, n).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, pt, ln


def paged_bound(q, pk, pt, lengths, window):
    """Least time of one call on an H100 SXM: the K and V rows of every
    attended position, q, the attended pages' table entries and the lengths
    read once, the output written once; about 4 Hq D operations per
    attended position."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = pk.shape
    pages = positions = 0
    for L in lengths:
        lo = max(0, L - window) if window > 0 else 0  # first attended position
        positions += L - lo
        pages += sum(1 for i in range(pt.shape[1])
                     if i * ps < L and i * ps + ps - 1 >= lo)
    el = pk.element_size()
    nbytes = (2 * positions * Hkv * D * el + 2 * q.numel() * el
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * positions
    t_bytes, t_ops = nbytes / H100_SXM.mem_bw, ops / H100_SXM.peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase1(dev):
    from repro_torch.kernels import paged_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: paged_decode_attention kernel vs plain, bf16, "
          "allow_tf32=False for matmul and cuDNN; tolerance per request: "
          "1 bf16 ulp at the largest magnitude of that request's output")
    ps, n, P = 16, 34, 160
    lengths = [1, ps, 300, n * ps]       # one token, a page boundary, full
    variants = [  # (name, Hq, Hkv, D, window, softcap)
        ("llama3-8b heads", 32, 8, 128, 0, 0.0),
        ("llama3-8b heads, window 40", 32, 8, 128, 40, 0.0),
        ("llama3-8b heads, softcap 50", 32, 8, 128, 0, 50.0),
        ("gemma2 heads, window 40, softcap 50", 8, 4, 256, 40, 50.0),
        ("h2o-danube heads (D 120), window 40", 32, 8, 120, 40, 0.0),
        ("qwen2-moe heads (MHA: one q head a kv head)", 16, 16, 128, 0, 0.0),
        ("gemma-2b heads (MQA: one kv head)", 8, 1, 256, 0, 0.0),
    ]
    worst = 0.0
    for i, (name, Hq, Hkv, D, window, softcap) in enumerate(variants):
        q, pk, pv, pt, ln = paged_inputs(dev, 4, Hq, Hkv, D, ps, n, P,
                                         lengths, seed=i)
        kw = dict(window=window, logit_softcap=softcap)
        got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln, **kw)
        torch.cuda.synchronize()
        want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln,
                                                       **kw)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().flatten(1).amax(1)   # (B,)
        tol = torch.exp2(torch.floor(torch.log2(
            want.float().abs().flatten(1).amax(1))) - 7)
        ratio = (err / tol).max().item()
        print(f"  {name}: max|kernel - plain| per request {err.tolist()}, "
              f"tolerance {tol.tolist()}; worst error/tolerance {ratio}")
        check(ratio <= 1.0, f"{name}: kernel disagrees with the plain version")
        if Hq == 32:
            worst = max(worst, err.max().item())
        if i == 0:   # the serving path's own shapes and options
            ms = cuda_ms(lambda: paged_attn.paged_decode_attention(
                q, pk, pv, pt, ln, **kw))
            plain_ms = cuda_ms(lambda: paged_attn.paged_decode_attention_plain(
                q, pk, pv, pt, ln, **kw))
            bound_ms, bound_by = paged_bound(q, pk, pt, lengths, window)
        if D == 120:   # h2o-danube's heads: 15 lanes a row of 16
            ms_120 = cuda_ms(lambda: paged_attn.paged_decode_attention(
                q, pk, pv, pt, ln, **kw))
            plain_120 = cuda_ms(lambda: paged_attn.paged_decode_attention_plain(
                q, pk, pv, pt, ln, **kw))
            bound_120, _ = paged_bound(q, pk, pt, lengths, window)
    print(f"  time at B=4 Hq=32 Hkv=8 D=120 window 40 ps=16 n=34 lengths="
          f"{lengths}: kernel {ms_120} ms, plain {plain_120} ms, bound "
          f"{bound_120} ms")
    pps = paged_attn.split_pages(4, 8, 4, n)
    print(f"  time at B=4 Hq=32 Hkv=8 D=128 ps=16 n=34 lengths={lengths} "
          f"({-(-n // pps)} splits of {pps} pages, two CUDA launches a "
          f"call): kernel {ms} ms, plain {plain_ms} ms, bound {bound_ms} ms "
          f"({bound_by})")
    # a long context: 4 requests of 4096 positions, llama3-8b's heads
    n_long = LONG_CONTEXT // ps
    q, pk, pv, pt, ln = paged_inputs(dev, 4, 32, 8, 128, ps, n_long,
                                     4 * n_long + 16, [LONG_CONTEXT] * 4,
                                     seed=9)
    got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln)
    want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln)
    err = (got.float() - want.float()).abs().max().item()
    long_ms = cuda_ms(lambda: paged_attn.paged_decode_attention(
        q, pk, pv, pt, ln))
    long_plain = cuda_ms(lambda: paged_attn.paged_decode_attention_plain(
        q, pk, pv, pt, ln), 2, 10)
    long_bound, long_by = paged_bound(q, pk, pt, [LONG_CONTEXT] * 4, 0)
    pps = paged_attn.split_pages(4, 8, 4, n_long)
    print(f"  time at B=4 Hq=32 Hkv=8 D=128 ps=16, {LONG_CONTEXT} positions "
          f"each ({-(-n_long // pps)} splits of {pps} pages): kernel "
          f"{long_ms} ms, plain {long_plain} ms, bound {long_bound} ms "
          f"({long_by}); max|kernel - plain| {err} (timing only, no gate)")
    del q, pk, pv, pt, ln, got, want
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:131",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_d120": ms_120, "plain_ms_d120": plain_120,
            "bound_ms_d120": bound_120}


# ---------------------------------------------------------------------------
# phase 2: serve llama3-8b at full width and depth
# ---------------------------------------------------------------------------
def phase2(card):
    from repro_torch.api import ServeSpec, compile_serve
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import paged_attn
    spec = ServeSpec(arch="llama3-8b", smoke=False, max_batch=4,
                     page_size=16, num_pages=160, max_prompt=512,
                     max_new_tokens=32, attn_impl="kernel")
    spans = SyncedSpans()
    t0 = time.perf_counter()
    server = compile_serve(spec, recorder=spans)
    torch.cuda.synchronize()
    cfg = server.cfg
    n_params = sum(w.numel() for w in _leaves(server.params))
    print(f"phase 2: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model}, {n_params} f32 params initialised on "
          f"{server.device} in {time.perf_counter() - t0:.2f} s")

    # warm-up request (library handles, allocator), outside the counted run
    server.submit(np.arange(1, 33), 2)
    server.drain()
    spans.reset()
    server.reset_latency_stats()

    rng = np.random.default_rng(0)
    lengths = rng.integers(2, server.spec.max_prompt + 1, size=8)
    for L in lengths:
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    steps0 = server.stats["steps"]
    torch.cuda.reset_peak_memory_stats()
    paged_attn.launches = 0
    kconv.launches = kflash.launches = 0
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attn.launches
    check(kconv.launches == 0, f"serving launched the conv kernel "
          f"{kconv.launches} times")
    check(kflash.launches == 0, f"serving launched the flash kernel "
          f"{kflash.launches} times")
    steps = server.stats["steps"] - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == 8, f"{len(done)} of 8 requests completed")
    for r in done:
        check(len(r.tokens) == server.spec.max_new_tokens,
              f"request {r.rid} returned {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} returned a token outside the vocabulary")
    check(steps > 0 and launches == steps * cfg.num_layers,
          f"paged-decode kernel launched {launches} times in {steps} decode "
          f"steps x {cfg.num_layers} layers")
    pre_s, dec_s = spans.seconds["prefill"], spans.seconds["decode"]
    n_pre = int(lengths.sum())
    n_dec = sum(len(r.tokens) - 1 for r in done)
    print(f"  served 8 requests ({n_pre} prompt tokens, {n_dec} decoded) in "
          f"{wall} s; {steps} decode steps, {launches} kernel launches "
          f"= steps x {cfg.num_layers}")
    print(f"  prefill {n_pre / pre_s} tok/s over {pre_s} s; decode "
          f"{n_dec / dec_s} tok/s over {dec_s} s; decode step median "
          f"{np.median(spans.samples['decode']) * 1e3} ms; peak memory "
          f"{peak_gb} GB [{card}]")
    lat = server.latency_stats()
    check(lat["n"] == 8, f"latency samples {lat['n']}")
    print(f"  all 8 submitted at once: TTFT p50 {lat['ttft_p50_s']} s p99 "
          f"{lat['ttft_p99_s']} s; end to end p50 {lat['e2e_p50_s']} s p99 "
          f"{lat['e2e_p99_s']} s [{card}]")

    # what one step spends recasting the f32 weights to bf16
    def cast_all():
        for w in _leaves(server.params):
            w.to(torch.bfloat16)

    cast_ms = cuda_ms(cast_all, 2, 5)
    print(f"  casting every weight f32 -> bf16 once: {cast_ms} ms "
          f"(the decode step does this) [{card}]")

    # gather vs kernel on one live decode state
    for L in rng.integers(2, server.spec.max_prompt + 1, size=4):
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    server.step()
    ref = server.decode_logits("gather").float()
    got = server.decode_logits("kernel").float()
    check(tuple(got.shape) == (4, cfg.vocab_size), f"logits {got.shape}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
          "non-finite logits")
    delta = (got - ref).abs().max().item()
    rel = ((got - ref).norm() / ref.norm()).item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * delta
    same = (got.argmax(-1) == ref.argmax(-1)) | ~decided
    # tolerance: per call the kernel is within one bf16 ulp of the plain
    # version (phase 1), but 32 layers of random weights carry those ulps
    # into the logits: 0.0183, the same bits in every run on an H100 80GB
    # HBM3 (PERF.md); the gate sits just above it
    print(f"  one decode step, kernel vs gather on the same state: max|dlogit| "
          f"{delta}, relative L2 {rel} (tolerance {REL_L2_TOL}), greedy "
          f"tokens agree wherever the top-2 margin exceeds 2 max|dlogit|: "
          f"{bool(same.all())}")
    check(rel <= REL_L2_TOL, "kernel and gather decode logits disagree")
    check(bool(same.all()), "greedy token differs at a decided step")

    # where one decode step's time goes, on this live state
    step_ms = {impl: cuda_ms(lambda: server.decode_logits(impl), 2, 5)
               for impl in ("kernel", "gather")}
    kp, vp = server._pools[0]
    q = torch.randn(spec.max_batch, cfg.num_heads, cfg.head_dim,
                    device=server.device).bfloat16()
    pt = torch.tensor(server._pt, device=server.device)
    ln = torch.tensor(server._lengths + 1, device=server.device)
    attn_ms = cuda_ms(lambda: paged_attn.paged_decode_attention(
        q, kp[0], vp[0], pt, ln))
    layers_attn = cfg.num_layers * attn_ms
    print(f"  decode step at lengths {(server._lengths + 1).tolist()}: "
          f"{step_ms['kernel']} ms with the kernel ({step_ms['gather']} ms "
          f"with gather); of it, weight recast {cast_ms} ms, paged attention "
          f"{cfg.num_layers} x {attn_ms} = {layers_attn} ms, the rest "
          f"{step_ms['kernel'] - cast_ms - layers_attn} ms [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 3: direct conv, kernel vs plain, every layer of the paper's CNNs
# ---------------------------------------------------------------------------
def conv_layer_shapes(cfg):
    """(name, H_in, IFM, OFM, K, stride, pad) of every conv layer of
    ``cfg``, walking the spatial size through its convs and 2x2 pools."""
    h, out = cfg.image_size, []
    for i, lyr in enumerate(cfg.layers):
        if lyr.kind == "conv":
            out.append((f"{cfg.name} layer {i}", h, lyr.ifm, lyr.ofm,
                        lyr.kernel, lyr.stride, lyr.pad))
            h = (h + 2 * lyr.pad - lyr.kernel) // lyr.stride + 1
            check(h == lyr.out_hw, f"{cfg.name} layer {i}: {h} != "
                  f"{lyr.out_hw}")
        elif lyr.kind == "pool":
            h //= 2
    return out


def conv_bound(N, H, C, F, K, s, p):
    """Least time of one call on an H100 SXM, in ms: x, w and out moved once
    at 3.35 TB/s, or the kernel's 3 x 2 N OH OW F K K C tf32 operations
    (3xTF32) at the dense TF32 tensor-core peak, whichever is longer.
    Returns (ms, t_bytes, t_ops, FFMA ms), the last the bound with the
    2 N OH OW F K K C operations at the f32 peak of 67 TFLOP/s outside the
    tensor cores (the ceiling of an FFMA kernel)."""
    OH = (H + 2 * p - K) // s + 1
    nbytes = 4 * (N * H * H * C + K * K * C * F + N * OH * OH * F)
    ops = 2 * N * OH * OH * F * K * K * C
    t_bytes, t_ops = nbytes / H100_SXM.mem_bw, 3 * ops / H100_TF32_TC_FLOPS
    ffma = max(t_bytes, ops / H100_SXM.peak_flops)
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3, ffma * 1e3


def phase3(dev, card):
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import conv2d as kconv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    N = 64
    print(f"phase 3: conv2d_nhwc kernel vs plain, f32, allow_tf32=False for "
          f"matmul and cuDNN, batch {N}; tolerance max|kernel - plain| <= "
          f"{CONV_REL_TOL} x max|plain| per layer; CUDA-event medians of 20 "
          f"calls after 3 warm-up [{card}]")
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "t_bytes": 0.0, "t_ops": 0.0, "ffma_ms": 0.0, "bwd_ms": 0.0}
    worst = 0.0
    kconv.launches = kconv.launches_ws = 0
    for arch in ("vgg-a", "overfeat-fast"):
        for j, (name, H, C, Fo, K, s, p) in enumerate(
                conv_layer_shapes(get_config(arch))):
            gen = torch.Generator(device=dev).manual_seed(100 + j)
            x = torch.randn(N, H, H, C, generator=gen, device=dev)
            w = torch.randn(K, K, C, Fo, generator=gen, device=dev) \
                / np.sqrt(K * K * C)
            before_ws = kconv.launches_ws
            got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
            torch.cuda.synchronize()
            took = "ws" if kconv.launches_ws > before_ws else "tiled"
            check(took == kconv.path(C, Fo, K, s) == ("tiled" if j == 0
                                                      else "ws"),
                  f"{name}: took the {took} instance")
            want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= CONV_REL_TOL * scale,
                  f"{name}: kernel disagrees with the plain version "
                  f"({err} > {CONV_REL_TOL} x {scale})")
            worst = max(worst, err)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            g = torch.randn_like(got)
            del got, want
            t = {
                "ms": cuda_ms(lambda: kconv.conv2d_nhwc(
                    x, w, stride=s, padding=p), 3, 20),
                "plain_ms": cuda_ms(lambda: kconv.conv2d_nhwc_plain(
                    x, w, stride=s, padding=p), 3, 20),
                "library_ms": cuda_ms(lambda: F.conv2d(
                    xn, wn, stride=s, padding=p), 3, 20),
                "bwd_ms": cuda_ms(lambda: kconv.conv2d_ref_backward(
                    x, w, g, s, p), 3, 20),
            }
            bound_ms, t_bytes, t_ops, ffma_ms = conv_bound(N, H, C, Fo, K, s,
                                                           p)
            print(f"  {name}: {H}x{H}x{C} -> {Fo}, {K}x{K} s{s} p{p}, "
                  f"{took} instance: max|kernel - plain| {err} (max|plain| "
                  f"{scale}); kernel "
                  f"{t['ms']} ms, plain {t['plain_ms']} ms, F.conv2d "
                  f"{t['library_ms']} ms (kernel / F.conv2d "
                  f"{t['ms'] / t['library_ms']}), reference backward (input "
                  f"+ weight grads) {t['bwd_ms']} ms; 3xTF32 bound {bound_ms} "
                  f"ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
                  f"bytes {t_bytes} ms, tensor-core operations {t_ops} ms), "
                  f"kernel / bound {t['ms'] / bound_ms}; FFMA bound "
                  f"{ffma_ms} ms, kernel / FFMA bound {t['ms'] / ffma_ms} "
                  f"[{card}]")
            if arch == "vgg-a":     # the training path's shapes
                for k in t:
                    totals[k] += t[k]
                totals["bound_ms"] += bound_ms
                totals["t_bytes"] += t_bytes
                totals["t_ops"] += t_ops
                totals["ffma_ms"] += ffma_ms
            del x, w, xn, wn, g
    print(f"  VGG-A's 8 conv layers at batch {N}, one forward pass: kernel "
          f"{totals['ms']} ms, plain {totals['plain_ms']} ms, F.conv2d "
          f"{totals['library_ms']} ms (kernel / F.conv2d "
          f"{totals['ms'] / totals['library_ms']}), 3xTF32 bound "
          f"{totals['bound_ms']} ms (kernel / bound "
          f"{totals['ms'] / totals['bound_ms']}), FFMA bound "
          f"{totals['ffma_ms']} ms (kernel / FFMA bound "
          f"{totals['ms'] / totals['ffma_ms']}); reference backward "
          f"{totals['bwd_ms']} ms [{card}]")
    print(f"  launches by path: {kconv.launches_ws} warp-specialised, "
          f"{kconv.launches - kconv.launches_ws} tiled, of {kconv.launches}")
    return {"name": "conv2d_nhwc", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv2d.cu",
            "replaces": "src/repro/kernels/conv2d.py:85",
            "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            "bound_by": ("operations" if totals["t_ops"] >= totals["t_bytes"]
                         else "bytes"),
            "library_ms": totals["library_ms"]}


# ---------------------------------------------------------------------------
# phase 4: train full-width VGG-A through compile_run -> Run.fit
# ---------------------------------------------------------------------------
def phase4(card):
    import torch.nn.functional as F

    from repro_torch.api import RunSpec, compile_run
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels.ref import conv2d_ref
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models import cnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = RunSpec(arch="vgg-a", smoke=False, batch=64, steps=6, lr=5e-3,
                   schedule="constant", seed=0, log_every=1)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in run.params.values())
    n_conv = len(run.cfg.conv_layers())
    print(f"phase 4: {run.cfg.name}, {n_conv} conv layers, {n_params} f32 "
          f"params initialised on {run.device} in "
          f"{time.perf_counter() - t0:.2f} s; {spec.steps} steps of batch "
          f"{spec.batch}, every forward conv on the kernel")
    # the params as initialised, for the route check after the run; held in
    # host memory so that the run's peak is the training's own
    init = {k: p.detach().cpu() for k, p in run.params.items()}

    torch.cuda.reset_peak_memory_stats()
    kconv.launches = kconv.launches_ws = 0
    paged_attn.launches = kflash.launches = 0
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paged = kconv.launches, paged_attn.launches
    launches_ws = kconv.launches_ws
    flash = kflash.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(hist) == spec.steps, f"{len(hist)} of {spec.steps} steps "
          "logged")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad norm: {hist}")
    check(launches == n_conv * spec.steps,
          f"conv kernel launched {launches} times in {spec.steps} steps x "
          f"{n_conv} conv layers")
    check(launches_ws == (n_conv - 1) * spec.steps,
          f"{launches_ws} of {launches} conv launches warp-specialised, want "
          f"all but conv1's")
    check(paged == 0, f"training launched the paged-decode kernel {paged} "
          "times")
    check(flash == 0, f"VGG-A training launched the flash kernel {flash} "
          "times")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    later = sum(steps[1:]) + sum(waits[1:])
    n_later = spec.batch * (spec.steps - 1)
    print(f"  {spec.steps} steps in {wall} s; conv kernel launches "
          f"{launches} = {spec.steps} x {n_conv} ({launches_ws} "
          f"warp-specialised); paged-decode launches "
          f"{paged}; flash launches {flash}")
    print(f"  steps 2-{spec.steps}: {n_later / later} images/s with the "
          f"data waits ({n_later / sum(steps[1:])} images/s of step time "
          f"alone); step median {np.median(steps[1:]) * 1e3} ms; first step "
          f"{steps[0] * 1e3} ms; data_wait summed {sum(waits)} s over "
          f"{len(waits)} steps ({[w * 1e3 for w in waits]} ms); peak "
          f"memory {peak_gb} GB [{card}]")

    # the kernel route against the plain route, on the params as initialised
    # and the run's next batch.  cuDNN's default backward algorithms are not
    # deterministic, so two runs of one route differ (printed as the
    # backward's noise); the check runs with deterministic cuDNN, where they
    # do not.  The network's own sensitivity is measured beside it: the plain
    # route again with every conv weight scaled by 1 + 2^-23 (one or two ulps
    # larger).
    batch = next(run.data)
    keys = sorted(run.params)

    def loss_and_grads(params, uk):
        loss = cnn.loss_fn(params, run.cfg, batch, use_kernel=uk)
        return loss.item(), torch.autograd.grad(
            loss, [params[k] for k in keys])

    def rel_l2(ga, gb):
        return {k: ((a - b).norm() / b.norm()).item()
                for k, a, b in zip(keys, ga, gb)}

    def worst(rel):
        k = max(rel, key=rel.get)
        return f"{rel[k]} at {k}"

    ps = {k: p.to(run.device).requires_grad_() for k, p in init.items()}
    del init
    noise = rel_l2(loss_and_grads(ps, False)[1], loss_and_grads(ps, False)[1])
    torch.backends.cudnn.deterministic = True
    lk, gk = loss_and_grads(ps, True)
    lp, gp = loss_and_grads(ps, False)
    same = all(torch.equal(a, b)
               for a, b in zip(gp, loss_and_grads(ps, False)[1]))
    ulp = {k: (p.detach() * (1 + 2.0 ** -23) if k.startswith("conv")
               and k.endswith("_w") else p.detach()).requires_grad_()
           for k, p in ps.items()}
    floor = rel_l2(loss_and_grads(ulp, False)[1], gp)
    torch.backends.cudnn.deterministic = False
    check(np.isfinite(lk) and np.isfinite(lp), "non-finite parity loss")
    check(same, "deterministic cuDNN: two plain-route backwards differ")
    loss_rel = abs(lk - lp) / abs(lp)
    rel = rel_l2(gk, gp)
    print(f"  worst leaf's gradient relative L2: plain route twice, default "
          f"cuDNN (the backward's noise): {worst(noise)}; plain "
          f"route with each conv weight scaled by 1 + 2^-23 vs plain, "
          f"deterministic (the network's sensitivity): {worst(floor)}")
    tol = max(GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * max(floor.values()))
    print(f"  kernel vs plain route, one forward and backward on the params "
          f"as initialised and one batch, deterministic cuDNN: loss {lk} vs "
          f"{lp} (relative {loss_rel}, tolerance {LOSS_REL_TOL}); gradients "
          f"{worst(rel)}; tolerance for every leaf max({GRAD_REL_L2_TOL}, "
          f"{SENSITIVITY_FACTOR} x the largest sensitivity) = {tol}, worst "
          f"relative L2 / tolerance {max(rel.values()) / tol}")
    print(f"  per leaf, kernel vs plain: {rel}")
    print(f"  per leaf, conv weights x (1 + 2^-23) vs plain: {floor}")
    check(loss_rel <= LOSS_REL_TOL, "kernel and plain route losses differ")
    check(max(rel.values()) <= tol,
          "kernel and plain route gradients differ")
    del gk, gp, ulp

    # a discrete cause of the gradient gap would show here: after conv1,
    # the 2x2 pool windows with a positive max whose gradient goes to a
    # different input on the two routes
    lyr = run.cfg.layers[0]
    picks = []
    with torch.no_grad():
        for conv in (lambda x, w: kconv.conv2d_nhwc(
                x, w, stride=lyr.stride, padding=lyr.pad),
                     lambda x, w: conv2d_ref(x, w, lyr.stride, lyr.pad)):
            h = torch.relu(conv(batch["images"], ps["conv00_w"])
                           + ps["conv00_b"])
            picks.append(F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2,
                                      return_indices=True))
    live = (picks[0][0] > 0) & (picks[1][0] > 0)
    flips = ((picks[0][1] != picks[1][1]) & live).sum().item()
    print(f"  pool after conv1: {flips} of {live.sum().item()} windows with "
          f"a positive max route their gradient to another input on the "
          f"kernel route than on the plain route")
    del picks, live, ps
    leaves = [run.params[k] for k in keys]

    # where one training step's time goes (CUDA events, 3 reps, median)
    split = {"step": [], "forward": [], "backward": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        run.step(batch, step_idx=spec.steps)
        ev[3].record()
        ev[3].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["step"].append(ev[2].elapsed_time(ev[3]))
    fwd, bwd, step = (float(np.median(split[k]))
                      for k in ("forward", "backward", "step"))
    print(f"  one step by CUDA events: whole train_step {step} ms; its "
          f"forward alone {fwd} ms, backward alone {bwd} ms, so gradient "
          f"norm, clipping and the SGD update about {step - fwd - bwd} ms "
          f"[{card}]")
    run.close()
    return launches



# ---------------------------------------------------------------------------
# phase 5: the §3.4 ring kernels, kernel vs plain, and their times
# ---------------------------------------------------------------------------
def ring_layouts(dev, G, N, dtype, seed):
    """A (G, N) member stack four ways: contiguous, starting one element
    into its storage (unaligned), with a wider member stride, and one row
    viewed G times (member stride 0, the zero1 path's gradient)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    return {"contiguous": randn(G, N),
            "unaligned": randn(G * N + 1)[1:].view(G, N),
            "wide": randn(G, N + 5)[:, :N],
            "stride0": randn(N).expand(G, N)}


def vgg_buckets(G):
    """The fusion buckets of full-width VGG-A at G members and the default
    4 MiB target: ``plan_buckets`` on meta tensors, no memory."""
    from repro_torch.comm import CommConfig, plan_buckets
    from repro_torch.configs import get_config
    from repro_torch.models import cnn
    meta = {k: torch.empty(sp.shape, device="meta")
            for k, sp in cnn.param_specs(get_config("vgg-a")).items()}
    return plan_buckets(meta, G, CommConfig().bucket_bytes)


def bytes_bound(nbytes):
    return nbytes / H100_SXM.mem_bw * 1e3


def phase5(dev, card):
    from repro_torch.kernels import ring as kring
    print("phase 5: ring kernels vs plain, f32 and bf16, bitwise (no "
          f"tolerance); G in {RING_GS}, strips of {RING_NS} elements; "
          "contiguous, unaligned, wide-stride and stride-0 member stacks")
    worst = {"ring_hop_accum": 0.0, "ring_reduce_scatter": 0.0,
             "ring_all_gather": 0.0}
    calls = dict.fromkeys(worst, 0)     # one launch a call (none at G = 1)
    cases = 0
    kring.reset_launches()
    for G in RING_GS:
        for n in RING_NS:
            for dtype in (torch.float32, torch.bfloat16):
                lay = ring_layouts(dev, G, G * n, dtype, seed=G * 31 + n)
                recv = ring_layouts(dev, 1, n, dtype, seed=n)["contiguous"][0]
                for name, x in lay.items():
                    tag = f"G={G} n={n} {dtype} {name}"
                    pairs = [("ring_reduce_scatter",
                              kring.ring_reduce_scatter(x),
                              kring.ring_reduce_scatter_plain(x)),
                             ("ring_all_gather",
                              kring.ring_all_gather(x[:, :n]),
                              kring.ring_all_gather_plain(x[:, :n]))]
                    for c in range(G):
                        cd = torch.tensor([c], dtype=torch.int32, device=dev)
                        want = kring.ring_hop_accum_plain(x[:, :n], recv, c)
                        pairs += [("ring_hop_accum",
                                   kring.ring_hop_accum(x[:, :n], recv, c),
                                   want),
                                  ("ring_hop_accum",
                                   kring.ring_hop_accum(x[:, :n], recv, cd),
                                   want)]
                    torch.cuda.synchronize()
                    for kname, got, want in pairs:
                        check(got.shape == want.shape and torch.equal(
                            got, want), f"{kname} {tag}: kernel disagrees "
                              f"with the plain version")
                        worst[kname] = max(worst[kname], (
                            got.float() - want.float()).abs().max().item())
                        cases += 1
                        calls[kname] += kname == "ring_hop_accum" or G > 1
    launched = {k: kring.launches[k] for k in calls}
    check(launched == calls, f"ring launches {launched}, want one a call "
          f"{calls}")
    print(f"  {cases} kernel calls bitwise equal to their plain versions; "
          f"launches {launched}, one a call")

    G = 4
    plan = vgg_buckets(G)
    check(plan.n_collectives == 14, f"{plan.n_collectives} VGG-A buckets")
    print(f"  timing over VGG-A's {plan.n_collectives} buckets at G={G} "
          f"({plan.total_padded} f32 elements, largest "
          f"{max(b.padded_size for b in plan.buckets)}); CUDA-event medians "
          f"of 10 calls after 3 warm-up [{card}]")
    t = dict.fromkeys(("rs", "rs_plain", "rs_lib", "rs_full", "rs_full_plain",
                       "rs_full_lib", "ag", "ag_plain", "ag_lib"), 0.0)
    N_tot = 0
    at_buckets = 0
    for bi, b in enumerate(plan.buckets):
        N = b.padded_size
        n = N // G
        N_tot += N
        g = torch.randn(N, device=dev)
        stacked = g.expand(G, N)            # the zero1 path's member partials
        full = torch.randn(G, N, device=dev)   # G distinct partials
        strips = torch.randn(G, n, device=dev)
        # kernel against plain at the path's own shapes, bitwise
        for kname, fn, plain, x in (
                ("ring_reduce_scatter", kring.ring_reduce_scatter,
                 kring.ring_reduce_scatter_plain, stacked),
                ("ring_reduce_scatter", kring.ring_reduce_scatter,
                 kring.ring_reduce_scatter_plain, full),
                ("ring_all_gather", kring.ring_all_gather,
                 kring.ring_all_gather_plain, strips)):
            before = kring.launches[kname]
            got, want = fn(x), plain(x)
            check(kring.launches[kname] - before == 1, f"{kname} at VGG-A "
                  f"bucket {bi}: {kring.launches[kname] - before} launches")
            check(got.shape == want.shape and torch.equal(got, want),
                  f"{kname} at VGG-A bucket {bi} (N={N}, member "
                  f"stride {x.stride(0)}): kernel disagrees with the plain "
                  f"version")
            worst[kname] = max(worst[kname],
                               (got - want).abs().max().item())
            at_buckets += 1
            del got, want
        for key, fn in (
                ("rs", lambda: kring.ring_reduce_scatter(stacked)),
                ("rs_plain", lambda: kring.ring_reduce_scatter_plain(stacked)),
                ("rs_lib", lambda: stacked.view(G, G, n).sum(0)),
                ("rs_full", lambda: kring.ring_reduce_scatter(full)),
                ("rs_full_plain",
                 lambda: kring.ring_reduce_scatter_plain(full)),
                ("rs_full_lib", lambda: full.view(G, G, n).sum(0)),
                ("ag", lambda: kring.ring_all_gather(strips)),
                ("ag_plain", lambda: kring.ring_all_gather_plain(strips)),
                ("ag_lib", lambda: strips.reshape(1, -1).expand(G, -1)
                 .contiguous())):
            t[key] += cuda_ms(fn, 3, 10)
        del g, stacked, full, strips
    print(f"  at VGG-A's {plan.n_collectives} bucket shapes: {at_buckets} "
          f"kernel calls (reduce-scatter of the stride-0 stack and of G "
          f"distinct partials, all-gather) bitwise equal to their plain "
          f"versions")
    rs_launches = plan.n_collectives    # a call of each timing: one a bucket
    # bytes each function must move: inputs read once, outputs written once
    rs_bound = bytes_bound(4 * (N_tot + N_tot))          # one buffer in
    rs_full_bound = bytes_bound(4 * (G * N_tot + N_tot))  # G buffers in
    ag_bound = bytes_bound(4 * (N_tot + G * N_tot))
    print(f"  reduce-scatter of the zero1 path's stride-0 stacks (one "
          f"gradient viewed {G} times), summed over the buckets: kernel "
          f"{t['rs']} ms ({rs_launches} launches), plain "
          f"{t['rs_plain']} ms, library (view(G, G, n).sum(0)) "
          f"{t['rs_lib']} ms, bound {rs_bound} ms (bytes) [{card}]")
    print(f"  reduce-scatter of G distinct partials: kernel {t['rs_full']} "
          f"ms ({rs_launches} launches), plain {t['rs_full_plain']} ms, "
          f"library {t['rs_full_lib']} "
          f"ms, bound {rs_full_bound} ms (bytes) [{card}]")
    print(f"  all-gather: kernel {t['ag']} ms, plain (a view) "
          f"{t['ag_plain']} ms, library (expand().contiguous()) "
          f"{t['ag_lib']} ms, bound {ag_bound} ms (bytes) [{card}]")

    n = max(b.padded_size for b in plan.buckets) // G
    chunks = torch.randn(G, n, device=dev)
    recv = torch.randn(n, device=dev)
    cd = torch.tensor([1], dtype=torch.int32, device=dev)
    for c in (cd, 2):
        got = kring.ring_hop_accum(chunks, recv, c)
        want = kring.ring_hop_accum_plain(chunks, recv, c)
        check(torch.equal(got, want), f"ring_hop_accum at the largest "
              f"bucket (n={n}, c={c}): kernel disagrees with the plain "
              f"version")
        worst["ring_hop_accum"] = max(worst["ring_hop_accum"],
                                      (got - want).abs().max().item())
    del got, want
    hop = {"ms": cuda_ms(lambda: kring.ring_hop_accum(chunks, recv, cd)),
           "plain_ms": cuda_ms(lambda: kring.ring_hop_accum_plain(
               chunks, recv, cd)),
           "library_ms": cuda_ms(lambda: torch.add(recv, chunks.select(0, 1)))}
    hop_bound = bytes_bound(4 * 3 * n)
    print(f"  one process-path hop at the largest bucket (n={n}): kernel "
          f"{hop['ms']} ms, plain {hop['plain_ms']} ms, torch.add "
          f"{hop['library_ms']} ms, bound {hop_bound} ms (bytes) [{card}]")
    del chunks, recv
    src = "src/repro_torch/kernels/csrc/ring.cu"
    return [
        {"name": "ring_hop_accum", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/ring.py:195",
         "max_abs_err": worst["ring_hop_accum"], **hop, "bound_ms": hop_bound,
         "bound_by": "bytes"},
        {"name": "ring_reduce_scatter", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/ring.py:138",
         "max_abs_err": worst["ring_reduce_scatter"], "ms": t["rs"],
         "plain_ms": t["rs_plain"], "bound_ms": rs_bound, "bound_by": "bytes",
         "library_ms": t["rs_lib"]},
        {"name": "ring_all_gather", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/ring.py:156",
         "max_abs_err": worst["ring_all_gather"], "ms": t["ag"],
         "plain_ms": t["ag_plain"], "bound_ms": ag_bound, "bound_by": "bytes",
         "library_ms": t["ag_lib"]},
    ]


# ---------------------------------------------------------------------------
# phase 6: the zero1 path, G = 4 members of full-width VGG-A on the card
# ---------------------------------------------------------------------------
def phase6(card):
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.comm import CommConfig, pack_bucket
    from repro_torch.core.params import tree_leaves
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels import ring as kring
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.optim.dist import UpdatePlan, make_distributed_update
    from repro_torch.train.train_step import global_norm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    G = 4
    base = dict(arch="vgg-a", batch=64, lr=5e-3, schedule="constant", seed=0,
                log_every=1)
    spec = RunSpec(**base, steps=4, parallel="zero1",
                   comm=CommConfig(backend="pallas-ring"),
                   mesh=MeshSpec(members_per_device=G))
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    strips = run.opt_state.velocity
    n_conv = len(run.cfg.conv_layers())
    print(f"phase 6: {run.cfg.name} zero1, {G} members on {run.device} "
          f"({run.mesh}), backend {run.comm.backend}, bucket target "
          f"{run.comm.bucket_bytes} B; compiled in "
          f"{time.perf_counter() - t0:.2f} s; {spec.steps} steps of batch "
          f"{spec.batch}, every forward conv on the kernel")
    # the reference's strip layout: one (G, n/G) tensor per bucket
    check(len(strips) == 14 and all(s.dim() == 2 and s.shape[0] == G
                                    for s in strips),
          f"strip state {[tuple(s.shape) for s in strips]}")
    n_buckets = len(strips)
    print(f"  strip state: {n_buckets} tensors, shapes "
          f"{[tuple(s.shape) for s in strips]}")

    torch.cuda.reset_peak_memory_stats()
    kring.reset_launches()
    kconv.launches = 0
    paged_attn.launches = kflash.launches = 0
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kring.launches)
    conv, paged = kconv.launches, paged_attn.launches
    check(kflash.launches == 0, f"flash launches {kflash.launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"zero1 history {hist}")
    # the path's launches: one reduce-scatter and one gather per bucket, one
    # conv per conv layer; the process hop is not on this path
    check(counts["ring_reduce_scatter"] == spec.steps * n_buckets,
          f"reduce-scatters {counts['ring_reduce_scatter']}")
    check(counts["ring_all_gather"] == spec.steps * n_buckets,
          f"all-gathers {counts['ring_all_gather']}")
    check(counts["ring_hop_accum"] == 0,
          f"process hops {counts['ring_hop_accum']} on the local mesh")
    check(conv == spec.steps * n_conv, f"conv launches {conv}")
    check(paged == 0, f"paged-decode launches {paged}")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    n_later = spec.batch * (spec.steps - 1)
    print(f"  {spec.steps} steps in {wall} s; launches: reduce-scatters "
          f"{counts['ring_reduce_scatter']} = {spec.steps} x {n_buckets}, "
          f"all-gathers {counts['ring_all_gather']} = {spec.steps} "
          f"x {n_buckets}, conv {conv} = {spec.steps} x {n_conv}, "
          f"paged {paged}, process hops {counts['ring_hop_accum']}")
    print(f"  steps 2-{spec.steps}: {n_later / (sum(steps[1:]) + sum(waits[1:]))}"
          f" images/s with the data waits ({n_later / sum(steps[1:])} images/s "
          f"of step time alone); step median {np.median(steps[1:]) * 1e3} ms; "
          f"first step {steps[0] * 1e3} ms; peak memory {peak_gb} GB [{card}]")

    # one step split into its update phases; the replication invariant
    batch = next(run.data)
    up = UpdatePlan.build(run.optimizer, run.mesh, run.mesh.axis_names,
                          run.comm)
    plan, sched = up.buckets(run.params), up.schedule()
    keys = sorted(run.params)
    lr = run.lr_schedule(0)

    def clipped_grads():
        leaves = [run.params[k].requires_grad_() for k in keys]
        loss = run.loss_fn(run.params, batch)
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        scale = torch.clamp(spec.grad_clip / torch.clamp(
            global_norm(grads), min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale)
        return grads

    split = SyncedSpans()
    for rep in range(4):
        grads = clipped_grads()
        with torch.no_grad():
            with split.span("reduce"):
                g_strips = up.reduce(sched, plan, grads)
            with split.span("apply"):
                new_p, run.opt_state = up.apply(sched, plan, run.params,
                                                g_strips, run.opt_state, lr)
            if rep == 0:
                # every member must leave the gather with the same weights
                for ps in new_p:
                    full = sched.broadcast(ps)
                    check(all(torch.equal(full[0], full[i])
                              for i in range(1, G)),
                          "members' gathered buffers differ")
                # the ring's mean of G equal rows is the gradient bitwise
                # (the note on phase 6 (a) above): strip p of a bucket is
                # chunk p of its packed gradient
                flat = tree_leaves(grads)
                check(all(torch.equal(gs, pack_bucket(flat, b).view(G, -1))
                          for gs, b in zip(g_strips, plan.buckets)),
                      "the ring's mean of 4 equal gradient rows is not the "
                      "gradient bitwise")
            with split.span("broadcast"):
                up.broadcast(sched, plan, run.params, new_p)
    med = {k: float(np.median(v[1:])) * 1e3 for k, v in split.samples.items()}
    print(f"  replication invariant: all {G} rows of each of the "
          f"{n_buckets} gathered buffers bitwise equal; the ring's mean of "
          f"{G} equal gradient rows bitwise equal to the gradient")
    print(f"  one update by phases (spans ending in a device sync, median of "
          f"3 after one warm-up): reduce {med['reduce']} ms (pack + "
          f"{n_buckets} reduce-scatters + mean), apply {med['apply']} ms "
          f"(pack the params + strip SGD), broadcast {med['broadcast']} ms "
          f"({n_buckets} all-gathers + unpack); total "
          f"{sum(med.values())} ms [{card}]")

    # (a) the same clipped gradients through optimizer.update and through
    # the zero1 update, from the same params and fresh state
    grads = clipped_grads()
    with torch.no_grad():
        p0 = {k: v.detach().clone() for k, v in run.params.items()}
        p_ser = {k: v.clone() for k, v in p0.items()}
        p_dst = {k: v.clone() for k, v in p0.items()}
        run.optimizer.update(grads, run.optimizer.init(p_ser), p_ser, lr)
        init_fn, update_fn = make_distributed_update(
            run.optimizer, run.mesh, run.mesh.axis_names, run.comm)
        update_fn(p_dst, grads, init_fn(p_dst), lr, 0)
        step_rel = {k: ((p_dst[k] - p_ser[k]).norm()
                        / (p_ser[k] - p0[k]).norm().clamp(min=1e-30)).item()
                    for k in keys}
        differ = [k for k in keys if not torch.equal(p_dst[k], p_ser[k])]
    print(f"  (a) one update of the same clipped gradients, zero1 vs serial "
          f"optimizer.update: {len(keys) - len(differ)} of {len(keys)} "
          f"leaves bitwise equal (required: all); worst relative L2 of the "
          f"difference to the update itself {max(step_rel.values())}")
    check(not differ, f"zero1 and serial updates of the same gradients "
          f"differ at {differ}")
    run.close()
    del run, p0, p_ser, p_dst, grads, g_strips, new_p, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 3 steps of zero1 and of the serial run from the same seed
    torch.backends.cudnn.deterministic = True
    losses = {}
    for mode, s in (("zero1", spec.replace(steps=3)),
                    ("serial", RunSpec(**base, steps=3))):
        r = use_kernel(compile_run(s))
        losses[mode] = [h["loss"] for h in r.fit(log_fn=lambda *_: None)]
        r.close()
        del r
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["zero1"], losses["serial"]))
    print(f"  (b) 3 steps from seed 0, deterministic cuDNN: zero1 losses "
          f"{losses['zero1']}, serial {losses['serial']}; worst relative "
          f"difference {worst} (tolerance {ZERO1_LOSS_REL_TOL})")
    check(worst <= ZERO1_LOSS_REL_TOL, "zero1 and serial losses differ")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the wire-format kernels, kernel vs plain, and their times
# ---------------------------------------------------------------------------
WIRE_GS = (2, 3, 4, 8)
TOPK_RATIO = 0.05               # the reference's CommConfig default


def wire_ring_pairs(st, k):
    """(kernel, got, want) of one member-batched int8 ring and one top-k
    ring over the stack ``st``, each call against its plain version on the
    same inputs (the kernel's own output feeds the next hop)."""
    from repro_torch.comm.backends.ring import _topk_select
    from repro_torch.kernels import ring as kring
    G = st.shape[0]
    q, s = kring.int8_quantize_members(st)
    pairs = [("int8_quantize", (q, s), kring.int8_quantize_members_plain(st))]
    vals, idx = _topk_select(kring.member_chunks(st, -1), k)
    scales = [s]
    for step in range(G - 1):
        want = kring.ring_hop_int8_members_plain(st, q, s, step)
        q, s = kring.ring_hop_int8_members(st, q, s, step)
        pairs.append(("ring_hop_int8", (q, s), want))
        scales.append(s)
        want = kring.ring_hop_topk_members_plain(st, vals, idx, step)
        dense = kring.ring_hop_topk_members(st, vals, idx, step)
        pairs.append(("ring_hop_topk", (dense,), (want,)))
        vals, idx = _topk_select(dense, k)
    return pairs, scales


def int8_ring_scale(st):
    """The largest scale of the messages of one member-batched int8 ring
    over the stack ``st`` (the kernels, outside any counted run)."""
    from repro_torch.kernels import ring as kring
    q, s = kring.int8_quantize_members(st)
    best = s.max().item()
    for step in range(st.shape[0] - 1):
        q, s = kring.ring_hop_int8_members(st, q, s, step)
        best = max(best, s.max().item())
    return best


def check_pairs(pairs, tag, worst):
    torch.cuda.synchronize()
    for kname, got, want in pairs:
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype
                  and torch.equal(g, w),
                  f"{kname} {tag}: kernel disagrees with the plain version")
            worst[kname] = max(worst[kname],
                               (g.float() - w.float()).abs().max().item())
    return len(pairs)


def phase8(dev, card):
    from repro_torch.comm.backends.ring import _topk_select, topk_chunk_k
    from repro_torch.kernels import ring as kring
    print("phase 8: wire-format kernels vs plain, bitwise (no tolerance); "
          f"member-batched rings at G in {WIRE_GS}, chunks of {RING_NS} "
          "elements, contiguous, unaligned, wide-stride, stride-0, all-zero "
          "and subnormal stacks; per-member calls with host and on-card "
          "chunk indices")
    worst = dict.fromkeys(("int8_quantize", "ring_hop_int8",
                           "ring_hop_topk"), 0.0)
    cases = 0
    for G in WIRE_GS:
        for n in RING_NS:
            lay = ring_layouts(dev, G, G * n, torch.float32, seed=G * 37 + n)
            lay["zeros"] = torch.zeros(G, G * n, device=dev)
            # below 2^-126: an atomic add would flush these to zero
            lay["subnormal"] = lay["contiguous"] * 2.0 ** -130
            for name, st in lay.items():
                pairs, scales = wire_ring_pairs(st, topk_chunk_k(n, TOPK_RATIO))
                cases += check_pairs(pairs, f"G={G} n={n} {name}", worst)
                if name == "zeros":
                    check(all(bool((s == 1).all()) for s in scales),
                          "an all-zero message's scale is not 1")
    for n in RING_NS:
        for name, chunks in ring_layouts(dev, 4, n, torch.float32,
                                         seed=n + 3).items():
            x = chunks[1]
            q, s = kring.int8_quantize(x)
            pairs = [("int8_quantize", (q, s), kring.int8_quantize_plain(x))]
            vals, idx = _topk_select(x, topk_chunk_k(n, TOPK_RATIO))
            for c in range(4):
                cd = torch.tensor([c], dtype=torch.int32, device=dev)
                want = kring.ring_hop_int8_plain(chunks, q, s, c)
                pairs += [("ring_hop_int8", kring.ring_hop_int8(
                    chunks, q, s, c), want), ("ring_hop_int8",
                    kring.ring_hop_int8(chunks, q, s, cd), want)]
                want = (kring.ring_hop_topk_plain(chunks, vals, idx, c),)
                pairs += [("ring_hop_topk", (kring.ring_hop_topk(
                    chunks, vals, idx, c),), want), ("ring_hop_topk", (
                        kring.ring_hop_topk(chunks, vals, idx, cd),), want)]
            cases += check_pairs(pairs, f"per member n={n} {name}", worst)
    print(f"  {cases} kernel calls bitwise equal to their plain versions")

    # one int8 call is one kernel on the card, and no memset
    st = torch.randn(4, 4 * 1000, device=dev)
    q, s = kring.int8_quantize_members(st)
    for name, fn in (("int8_quantize_members",
                      lambda: kring.int8_quantize_members(st)),
                     ("ring_hop_int8_members",
                      lambda: kring.ring_hop_int8_members(st, q, s, 0)),
                     ("int8_quantize", lambda: kring.int8_quantize(st[1])),
                     ("ring_hop_int8", lambda: kring.ring_hop_int8(
                         st.view(16, 1000), q[0], s[:1], 5))):
        ops = device_ops(fn)
        check(len(ops) == 1 and "int8_wire_kernel" in ops[0],
              f"{name}: the card ran {ops}, want one int8_wire_kernel")
    print("  torch.profiler: one int8 call (member-batched or one member, "
          "quantize or hop) is one int8_wire_kernel on the card and no "
          "memset")
    del st, q, s

    G = 4
    plan = vgg_buckets(G)
    at_buckets = 0
    t = dict.fromkeys(("q", "q_plain", "h", "h_plain", "k", "k_plain",
                       "q_graph", "h_graph"), 0.0)
    per_bucket = {"q": [], "h": [], "k": [], "q_graph": [], "h_graph": []}
    nbytes = dict.fromkeys(("q", "h", "k", "q_floor", "h_floor"), 0)
    for bi, b in enumerate(plan.buckets):
        N = b.padded_size
        n = N // G
        k = topk_chunk_k(n, TOPK_RATIO)
        g = torch.randn(N, device=dev)
        for name, st in (("stride0", g.expand(G, N)),
                         ("distinct", torch.randn(G, N, device=dev))):
            pairs, _ = wire_ring_pairs(st, k)
            at_buckets += check_pairs(
                pairs, f"VGG-A bucket {bi} (N={N}) {name}", worst)
            del pairs
        st = g.expand(G, N)           # the int8 zero1 path's member partials
        kept = torch.randn(G, N, device=dev)    # the top-k path's: distinct
        q, s = kring.int8_quantize_members(st)
        vals, idx = _topk_select(kring.member_chunks(kept, -1), k)
        for key, fn in (
                ("q", lambda: kring.int8_quantize_members(st)),
                ("q_plain", lambda: kring.int8_quantize_members_plain(st)),
                ("h", lambda: kring.ring_hop_int8_members(st, q, s, 0)),
                ("h_plain",
                 lambda: kring.ring_hop_int8_members_plain(st, q, s, 0)),
                ("k", lambda: kring.ring_hop_topk_members(kept, vals, idx, 0)),
                ("k_plain", lambda: kring.ring_hop_topk_members_plain(
                    kept, vals, idx, 0))):
            ms = cuda_ms(fn, 3, 10)
            t[key] += ms
            if key in per_bucket:
                per_bucket[key].append(ms)
        # the int8 calls' device time alone, each as a CUDA graph
        for key, fn in (("q_graph", lambda: kring.int8_quantize_members(st)),
                        ("h_graph",
                         lambda: kring.ring_hop_int8_members(st, q, s, 0))):
            ms = graph_ms(fn)
            t[key] += ms
            per_bucket[key].append(ms)
        # bytes each call must move: inputs read once, outputs written once;
        # the int8 kernels' two passes read the inputs twice (their floor)
        nbytes["q"] += 4 * N + N + 4 * G
        nbytes["h"] += 4 * N + N + 4 * G + N + 4 * G
        nbytes["q_floor"] += 2 * 4 * N + N + 4 * G
        nbytes["h_floor"] += 2 * (4 * N + N + 4 * G) + N + 4 * G
        nbytes["k"] += 4 * N + 8 * G * k + 4 * N
        del g, st, kept, q, s, vals, idx
    print(f"  at VGG-A's {plan.n_collectives} bucket shapes at G={G}: "
          f"{at_buckets} member-batched calls (one int8 and one top-k ring "
          "of a stride-0 stack and of G distinct partials per bucket) "
          "bitwise equal to their plain versions")
    print(f"  one member-batched call per bucket, summed over the "
          f"{plan.n_collectives} buckets (CUDA-event medians of 10 after 3 "
          f"warm-up): int8_quantize {t['q']} ms (plain {t['q_plain']} ms, "
          f"bound {bytes_bound(nbytes['q'])} ms); ring_hop_int8 {t['h']} ms "
          f"(plain {t['h_plain']} ms, bound {bytes_bound(nbytes['h'])} ms); "
          f"ring_hop_topk at ratio {TOPK_RATIO} {t['k']} ms (plain "
          f"{t['k_plain']} ms, bound {bytes_bound(nbytes['k'])} ms); per "
          f"step the int8 ring makes 1 + {G - 1} such passes, top-k "
          f"{G - 1} [{card}]")
    print(f"  per bucket (chunk sizes {[b.padded_size // G for b in plan.buckets]}"
          f"): int8_quantize {per_bucket['q']} ms; ring_hop_int8 "
          f"{per_bucket['h']} ms; ring_hop_topk {per_bucket['k']} ms [{card}]")
    print(f"  int8, device time alone (each call a CUDA graph), summed over "
          f"the {plan.n_collectives} buckets: int8_quantize {t['q_graph']} ms "
          f"(two-pass floor {bytes_bound(nbytes['q_floor'])} ms, bound "
          f"{bytes_bound(nbytes['q'])} ms), ring_hop_int8 {t['h_graph']} ms "
          f"(floor {bytes_bound(nbytes['h_floor'])} ms, bound "
          f"{bytes_bound(nbytes['h'])} ms); per bucket int8_quantize "
          f"{per_bucket['q_graph']} ms, ring_hop_int8 {per_bucket['h_graph']}"
          f" ms [{card}]")

    # one member's call at the largest chunk (fc13_w, n = 25,690,112)
    n = max(b.padded_size for b in plan.buckets) // G
    k = topk_chunk_k(n, TOPK_RATIO)
    chunks = torch.randn(G, n, device=dev)
    x = chunks[3].clone()
    q, s = kring.int8_quantize(x)
    vals, idx = _topk_select(torch.randn(n, device=dev), k)
    cd = torch.tensor([1], dtype=torch.int32, device=dev)
    pairs = [("int8_quantize", (q, s), kring.int8_quantize_plain(x)),
             ("ring_hop_int8", kring.ring_hop_int8(chunks, q, s, cd),
              kring.ring_hop_int8_plain(chunks, q, s, 1)),
             ("ring_hop_topk", (kring.ring_hop_topk(chunks, vals, idx, cd),),
              (kring.ring_hop_topk_plain(chunks, vals, idx, 1),))]
    check_pairs(pairs, f"one member at the largest chunk (n={n})", worst)
    del pairs
    idx64 = idx.long()
    one = {
        "int8_quantize": (lambda: kring.int8_quantize(x),
                          lambda: kring.int8_quantize_plain(x), None,
                          4 * n + n + 4),
        "ring_hop_int8": (lambda: kring.ring_hop_int8(chunks, q, s, cd),
                          lambda: kring.ring_hop_int8_plain(chunks, q, s, cd),
                          None, 4 * n + n + 4 + n + 4),
        "ring_hop_topk": (lambda: kring.ring_hop_topk(chunks, vals, idx, cd),
                          lambda: kring.ring_hop_topk_plain(
                              chunks, vals, idx, cd),
                          lambda: chunks[1].index_add(0, idx64, vals),
                          4 * n + 8 * k + 4 * n)}
    rows = {}
    for name, (fn, plain, lib, nb) in one.items():
        rows[name] = {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
                      "library_ms": None if lib is None else cuda_ms(lib),
                      "bound_ms": bytes_bound(nb), "bound_by": "bytes"}
        extra = ""
        if lib is None:   # int8: the device time alone and the two-pass floor
            extra = (f"device alone (CUDA graph) {graph_ms(fn)} ms, two-pass "
                     f"floor {bytes_bound(nb + (4 * n if name == 'int8_quantize' else 5 * n))}"
                     f" ms, ")
        print(f"  {name}, one member at n={n}" + (f", k={k}" if lib else "")
              + f": kernel {rows[name]['ms']} ms, {extra}plain "
              f"{rows[name]['plain_ms']} ms, "
              + (f"index_add {rows[name]['library_ms']} ms, " if lib else
                 "no single PyTorch call computes it, ")
              + f"bound {rows[name]['bound_ms']} ms (bytes) [{card}]")
    del chunks, x, q, s, vals, idx, idx64
    src = "src/repro_torch/kernels/csrc/ring_wire.cu"
    lines = {"int8_quantize": 221, "ring_hop_int8": 258, "ring_hop_topk": 294}
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": f"src/repro/kernels/ring.py:{lines[name]}",
             "max_abs_err": worst[name], **rows[name]} for name in lines]


# ---------------------------------------------------------------------------
# phase 9: the zero1 path under the int8 and top-k wire formats
# ---------------------------------------------------------------------------
@contextmanager
def plain_ring():
    """Route the ring backends through the kernels' plain versions (on the
    card), for the whole-update check of phase 9."""
    from repro_torch.kernels import ring as kring
    names = ("ring_reduce_scatter", "ring_all_gather",
             "int8_quantize_members", "ring_hop_int8_members",
             "ring_hop_topk_members")
    saved = {n: getattr(kring, n) for n in names}
    try:
        for n in names:
            setattr(kring, n, getattr(kring, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kring, n, fn)


def phase9(card, fmt, ratio=TOPK_RATIO):
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.comm import CommConfig, pack_bucket
    from repro_torch.comm.backends.ring import topk_chunk_k
    from repro_torch.core.params import tree_leaves
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels import ring as kring
    from repro_torch.kernels.ref import topk_mask_ref
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.optim.dist import (UpdatePlan, make_distributed_update,
                                        make_topk_ef_update, topk_ef_reduce)
    from repro_torch.train.train_step import global_norm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    G = 4
    comm = CommConfig(backend="pallas-ring", wire_format=fmt,
                      topk_ratio=ratio)
    spec = RunSpec(arch="vgg-a", batch=64, lr=5e-3, schedule="constant",
                   seed=0, log_every=1, steps=3, parallel="zero1", comm=comm,
                   mesh=MeshSpec(members_per_device=G))
    spans = SyncedSpans()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    n_conv = len(run.cfg.conv_layers())
    n_params = sum(p.numel() for p in run.params.values())
    ef = fmt == "topk"
    check(isinstance(run.opt_state, dict) == ef, f"{fmt} state "
          f"{type(run.opt_state).__name__}")
    n_buckets = len(run.opt_state["residual"]) if ef \
        else len(run.opt_state.velocity)
    print(f"phase 9 ({fmt}): {run.cfg.name} zero1, {n_params} f32 params, "
          f"{G} members on {run.device}, backend {run.comm.backend}, "
          f"wire_format {fmt}" + (f" at ratio {ratio}, residual "
                                  f"{[tuple(r.shape) for r in run.opt_state['residual']]}"
                                  if ef else "")
          + f"; {spec.steps} steps of batch {spec.batch}, every forward conv "
          "on the kernel")
    torch.cuda.reset_peak_memory_stats()
    kring.reset_launches()
    kconv.launches = 0
    paged_attn.launches = kflash.launches = 0
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kring.launches)
    conv, paged = kconv.launches, paged_attn.launches
    check(kflash.launches == 0, f"flash launches {kflash.launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"{fmt} zero1 history {hist}")
    want = dict.fromkeys(kring.launches, 0)
    want["ring_all_gather"] = spec.steps * n_buckets
    if ef:
        want["ring_hop_topk"] = spec.steps * n_buckets * (G - 1)
    else:
        want["int8_quantize"] = spec.steps * n_buckets
        want["ring_hop_int8"] = spec.steps * n_buckets * (G - 1)
    check(counts == want, f"{fmt} launches {counts}, want {want}")
    check(conv == spec.steps * n_conv and paged == 0,
          f"conv launches {conv}, paged {paged}")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    n_later = spec.batch * (spec.steps - 1)
    print(f"  {spec.steps} steps in {wall} s; launches {counts}, as "
          f"required for {spec.steps} steps x {n_buckets} buckets; conv "
          f"{conv} = {spec.steps} x {n_conv}")
    print(f"  steps 2-{spec.steps}: "
          f"{n_later / (sum(steps[1:]) + sum(waits[1:]))} images/s with the "
          f"data waits ({n_later / sum(steps[1:])} images/s of step time "
          f"alone); step median {np.median(steps[1:]) * 1e3} ms; first step "
          f"{steps[0] * 1e3} ms; peak memory {peak_gb} GB [{card}]")

    batch = next(run.data)
    up = UpdatePlan.build(run.optimizer, run.mesh, run.mesh.axis_names,
                          run.comm)
    plan, sched = up.buckets(run.params), up.schedule()
    keys = sorted(run.params)
    lr = run.lr_schedule(0)

    def clipped_grads():
        leaves = [run.params[k].requires_grad_() for k in keys]
        loss = run.loss_fn(run.params, batch)
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        scale = torch.clamp(spec.grad_clip / torch.clamp(
            global_norm(grads), min=1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale)
        return grads

    # one update split into its phases; the replication invariant
    split = SyncedSpans()
    inner = run.opt_state["zero1"] if ef else run.opt_state
    for rep in range(4):
        grads = clipped_grads()
        with torch.no_grad():
            with split.span("reduce"):
                if ef:
                    g_strips = topk_ef_reduce(up, sched, plan, grads,
                                              run.opt_state["residual"])
                else:
                    g_strips = up.reduce(sched, plan, grads)
            with split.span("apply"):
                new_p, inner = up.apply(sched, plan, run.params, g_strips,
                                        inner, lr)
            if rep == 0:
                for ps in new_p:
                    full = sched.broadcast(ps)
                    check(all(torch.equal(full[0], full[i])
                              for i in range(1, G)),
                          f"{fmt}: members' gathered buffers differ")
                del full
            with split.span("broadcast"):
                up.broadcast(sched, plan, run.params, new_p)
    med = {k: float(np.median(v[1:])) * 1e3 for k, v in split.samples.items()}
    print(f"  replication invariant: all {G} rows of each of the {n_buckets} "
          f"gathered buffers bitwise equal")
    print(f"  one update by phases (spans ending in a device sync, median of "
          f"3 after one warm-up): reduce {med['reduce']} ms, apply "
          f"{med['apply']} ms, broadcast {med['broadcast']} ms; total "
          f"{sum(med.values())} ms [{card}]")

    grads = clipped_grads()
    with torch.no_grad():
        flat = tree_leaves(grads)
        if ef:
            # kept + residual == buffer, bucket by bucket, from a residual
            # carried by the run
            res = [r.clone() for r in run.opt_state["residual"]]
            bufs = [r + run.mesh.replicated(pack_bucket(flat, b))
                    for r, b in zip(res, plan.buckets)]
            topk_ef_reduce(up, sched, plan, grads, res)
            for b, buf, r in zip(plan.buckets, bufs, res):
                kept = topk_mask_ref(buf, topk_chunk_k(
                    b.padded_size, ratio, floor=G))
                check(torch.equal(kept + r, buf), "kept + residual != buffer")
            print(f"  kept + residual == buffer bitwise in all {n_buckets} "
                  "buckets")
            del res, bufs, kept
        else:
            # against the fp32 ring: every mean-gradient strip entry within
            # the largest scale of its bucket's int8 messages
            fp32 = UpdatePlan.build(run.optimizer, run.mesh,
                                    run.mesh.axis_names,
                                    CommConfig(backend="pallas-ring"))
            exact = fp32.reduce(fp32.schedule(), plan, grads)
            got = up.reduce(sched, plan, grads)
            ratios = []
            for b, e, g8 in zip(plan.buckets, exact, got):
                s_max = int8_ring_scale(run.mesh.replicated(
                    pack_bucket(flat, b)))
                ratios.append((g8 - e).abs().max().item() / s_max)
            print(f"  int8 vs fp32 mean-gradient strips, one update of the "
                  f"same clipped gradients: worst |difference| / largest "
                  f"scale of the bucket's messages {max(ratios)} (required "
                  f"<= 1; per bucket {ratios})")
            check(max(ratios) <= 1.0, "int8 strips outside the quantum bound")
            del exact, got
        # the whole update through the kernels and through their plain
        # versions on the card, from the same params and fresh state
        make = make_topk_ef_update if ef else make_distributed_update
        init_fn, update_fn = make(run.optimizer, run.mesh,
                                  run.mesh.axis_names, run.comm)
        p0 = {k: v.detach().clone() for k, v in run.params.items()}
        outs = []
        for route in ("kernel", "plain"):
            p = {k: v.clone() for k, v in p0.items()}
            s0 = init_fn(p)
            with (plain_ring() if route == "plain" else nullcontext()):
                p, s1 = update_fn(p, grads, s0, lr, 0)
            outs.append([p[k] for k in keys]
                        + (list(s1["residual"]) if ef else []))
            del s0, s1
        same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"  one whole {fmt} update through the kernels and through their "
          f"plain versions on the card: params{' and residuals' if ef else ''}"
          f" bitwise equal: {same}")
    if not same:
        print(f"  differing (tensor, elements, max |difference|): "
              f"{[(i, int((a != b).sum()), (a - b).abs().max().item()) for i, (a, b) in enumerate(zip(*outs)) if not torch.equal(a, b)]}")
    check(same, f"{fmt} update: kernels and plain versions differ")
    run.close()
    del run, p0, outs, grads, g_strips, new_p, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: the blocked GEMM, kernel vs plain, at CD-DNN's layer shapes
# ---------------------------------------------------------------------------
# max |kernel - plain| over max |plain| of a product.  Each output is an f32
# sum of up to K = 2048 products (2048 of the ragged shapes), which the
# kernel (f32 inputs as three TF32 products each) and cuBLAS take in
# different orders; with unit-scale inputs their rounding differs by a few
# 1e-6 of the output's scale (the conv's 4.2e-6 at K = 9216).  bf16 inputs
# are widened exactly on both sides.
GEMM_REL_TOL = 2e-5
DNN_BATCH = 1024                # frames a minibatch (fig7_cddnn_scaling.py)
GEMM_TILES = (None, (64, 64), (64, 128), (128, 64), (128, 128))
# (M, N, K): M = 1, K = 1, N a multiple of no tile, N % 4 != 0, and the
# reference's test shapes (tests/test_kernels.py)
GEMM_RAGGED = ((1, 9304, 2048), (1024, 2048, 1), (1, 1, 1), (3, 7, 5),
               (130, 70, 200), (1000, 1001, 999), (8, 128, 128),
               (128, 128, 128), (256, 512, 384), (64, 256, 1024))


def dnn_layer_shapes(cfg, batch):
    """(M, N, K) of each layer's forward product ``h @ W``, in order."""
    dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.num_hidden \
        + [cfg.output_dim]
    return [(batch, n, k) for k, n in zip(dims[:-1], dims[1:])]


def gemm_bound(M, N, K):
    """Least time of one f32 call on an H100 SXM, in ms: A and B read once,
    C written once, or the kernel's 3 x 2 M N K tf32 operations (3xTF32) at
    the dense TF32 tensor-core peak, whichever is longer.  Returns (ms,
    t_bytes, t_ops, FFMA ms), the last the bound with the 2 M N K operations
    at the f32 peak of 67 TFLOP/s outside the tensor cores (the ceiling of an
    FFMA kernel)."""
    nbytes = 4 * (M * K + K * N + M * N)
    ops = 2 * M * N * K
    t_bytes, t_ops = nbytes / H100_SXM.mem_bw, 3 * ops / H100_TF32_TC_FLOPS
    ffma = max(t_bytes, ops / H100_SXM.peak_flops)
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3, ffma * 1e3


def phase10(dev, card):
    from repro_torch.configs import get_config
    from repro_torch.core.blocking import (GemmBlocking,
                                           solve_h100_gemm_blocking)
    from repro_torch.kernels import blocked_matmul as kmm
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = dnn_layer_shapes(get_config("cd-dnn"), DNN_BATCH)
    cd_dnn = sorted(set(layers), key=layers.index)
    print(f"phase 10: blocked_matmul kernel vs plain, allow_tf32=False for "
          f"matmul; tolerance max|kernel - plain| <= {GEMM_REL_TOL} x "
          f"max|plain| per product; CD-DNN's {len(cd_dnn)} layer shapes at "
          f"batch {DNN_BATCH} and {len(GEMM_RAGGED)} ragged and test shapes, "
          f"f32 and bf16 inputs, the solver's tile and every compiled tile")
    worst_abs = worst_rel = 0.0
    calls = 0
    for j, (M, N, K) in enumerate(cd_dnn + list(GEMM_RAGGED)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(200 + j)
            a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            b = torch.randn(K, N, generator=gen, device=dev).to(dtype)
            want = kmm.blocked_matmul_plain(a, b)
            scale = want.abs().max().item()
            for tile in GEMM_TILES:
                blk = None if tile is None else GemmBlocking(*tile, 8, 0, 0.)
                got = kmm.blocked_matmul(a, b, blocking=blk)
                torch.cuda.synchronize()
                check(got.shape == (M, N) and bool(torch.isfinite(got).all()),
                      f"({M}, {N}, {K}) {dtype} tile {tile}: shape or "
                      "non-finite")
                err = (got - want).abs().max().item()
                check(err <= GEMM_REL_TOL * scale,
                      f"({M}, {N}, {K}) {dtype} tile {tile}: kernel "
                      f"disagrees with the plain version ({err} > "
                      f"{GEMM_REL_TOL} x {scale})")
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / scale)
                calls += 1
            del a, b, want, got
    print(f"  {calls} products within tolerance; worst max|kernel - plain| "
          f"{worst_abs}, worst relative to max|plain| {worst_rel}")

    times = {}
    for M, N, K in cd_dnn:
        gen = torch.Generator(device=dev).manual_seed(K + N)
        a = torch.randn(M, K, generator=gen, device=dev)
        b = torch.randn(K, N, generator=gen, device=dev)
        blk = solve_h100_gemm_blocking(M, N, K)
        t = {"ms": cuda_ms(lambda: kmm.blocked_matmul(a, b), 3, 20),
             "plain_ms": cuda_ms(lambda: kmm.blocked_matmul_plain(a, b), 3,
                                 20),
             "library_ms": cuda_ms(lambda: torch.matmul(a, b), 3, 20)}
        t["bound_ms"], t_bytes, t_ops, t["ffma_ms"] = gemm_bound(M, N, K)
        t["t_bytes"], t["t_ops"] = t_bytes, t_ops
        times[(M, N, K)] = t
        print(f"  ({M} x {K}) @ ({K} x {N}), f32: solver tile bm={blk.bm} "
              f"bn={blk.bn} bk={blk.bk} (B/F {blk.bf_ratio}); kernel "
              f"{t['ms']} ms, plain {t['plain_ms']} ms, torch.matmul "
              f"{t['library_ms']} ms; 3xTF32 bound {t['bound_ms']} ms ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}; bytes "
              f"{t_bytes} ms, tensor-core operations {t_ops} ms); kernel / "
              f"bound {t['ms'] / t['bound_ms']}, FFMA bound {t['ffma_ms']} "
              f"ms, kernel / FFMA bound {t['ms'] / t['ffma_ms']}, kernel / "
              f"torch.matmul {t['ms'] / t['library_ms']} [{card}]")
        del a, b
    total = {k: sum(times[s][k] for s in layers)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes",
                       "t_ops", "ffma_ms")}
    print(f"  CD-DNN's {len(layers)} forward products at batch {DNN_BATCH}, "
          f"one forward pass: kernel {total['ms']} ms, plain "
          f"{total['plain_ms']} ms, torch.matmul {total['library_ms']} ms "
          f"(kernel / torch.matmul {total['ms'] / total['library_ms']}), "
          f"3xTF32 bound {total['bound_ms']} ms (kernel / bound "
          f"{total['ms'] / total['bound_ms']}), FFMA bound "
          f"{total['ffma_ms']} ms (kernel / FFMA bound "
          f"{total['ms'] / total['ffma_ms']}) [{card}]")
    return {"name": "blocked_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blocked_matmul.cu",
            "replaces": "src/repro/kernels/blocked_matmul.py:60",
            "max_abs_err": worst_abs, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if total["t_ops"] >= total["t_bytes"]
                         else "bytes"),
            "library_ms": total["library_ms"]}


# ---------------------------------------------------------------------------
# phase 11: CD-DNN at full width through compile_run -> Run.fit
# ---------------------------------------------------------------------------
# Kernel route vs plain route from the same params and batch: the forward
# products differ by rounding (phase 10) in each of 8 layers, carried
# through smooth sigmoids: the loss to a relative 1e-5 and every leaf's
# gradient to a relative L2 of 1e-4.  A weight gradient sums 1024 frames'
# terms of both signs, which can magnify an f32-level change of the forward
# some 30-fold; with no ReLU, pool or other tie for a change to tip, that
# stays far under 1e-4.  The network's own one-ulp sensitivity is printed
# beside it (every weight scaled by 1 + 2^-23).
DNN_STEPS = 6
DNN_LR = 0.1
DNN_LOSS_REL_TOL = 1e-5
DNN_GRAD_REL_L2_TOL = 1e-4


def _counts_zeroed():
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()


def _counts():
    """Every kernel's launches since :func:`_counts_zeroed`."""
    from repro_torch.kernels import launch_counts
    return launch_counts()


def _fit_dnn(spec, tag, card, unit="frames", what="product"):
    """Compile ``spec`` on the kernel route, fit it with every count zeroed
    just before and read just after; print the run's numbers (throughput in
    ``unit``/s) and return (run, history, counts)."""
    from repro_torch.api import compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in run.params.values())
    print(f"  {tag}: {run.cfg.name}, {n_params} f32 params on {run.device}"
          + (f" ({run.mesh}, backend {run.comm.backend}, "
             f"{len(run.opt_state.velocity)} buckets)" if run.mesh else "")
          + f", compiled in {time.perf_counter() - t0:.2f} s; {spec.steps} "
          f"steps of batch {spec.batch}, every forward {what} on the kernel")
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"    {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"{tag} history {hist}")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    n_later = spec.batch * (spec.steps - 1)
    print(f"    {spec.steps} steps in {wall} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"    steps 2-{spec.steps}: "
          f"{n_later / (sum(steps[1:]) + sum(waits[1:]))} {unit}/s with the "
          f"data waits ({n_later / sum(steps[1:])} {unit}/s of step time "
          f"alone); step median {np.median(steps[1:]) * 1e3} ms; first step "
          f"{steps[0] * 1e3} ms; data_wait median "
          f"{np.median(waits[1:]) * 1e3} ms; peak memory {peak_gb} GB "
          f"[{card}]")
    return run, hist, counts


def phase11(card):
    from repro_torch.api import MeshSpec, RunSpec
    from repro_torch.comm import CommConfig
    from repro_torch.configs import get_config
    from repro_torch.models import dnn
    from repro_torch.optim.dist import UpdatePlan
    from repro_torch.train.train_step import global_norm
    torch.backends.cuda.matmul.allow_tf32 = False
    G = 4
    spec = RunSpec(arch="cd-dnn", batch=DNN_BATCH, steps=DNN_STEPS,
                   lr=DNN_LR, schedule="constant", seed=0, log_every=1)
    print(f"phase 11: CD-DNN at full width through compile_run -> Run.fit, "
          f"momentum SGD, serial and zero1 (G = {G} members on the card, "
          f"pallas-ring, fp32 wire)")

    # serial
    run, hist, counts = _fit_dnn(spec, "serial", card)
    n_layers = run.cfg.num_hidden + 1
    check(counts["blocked_matmul"] == spec.steps * n_layers,
          f"serial: GEMM launched {counts['blocked_matmul']} times in "
          f"{spec.steps} steps x {n_layers} layers")
    check(sum(counts.values()) == counts["blocked_matmul"],
          f"serial: other kernels launched: {counts}")
    gemm_launches = counts["blocked_matmul"]
    serial_params = {k: p.detach().clone() for k, p in run.params.items()}
    serial_losses = [h["loss"] for h in hist]
    batch = next(run.data)
    keys = sorted(run.params)
    leaves = [run.params[k] for k in keys]

    # where one serial step's time goes (CUDA events, 3 reps, median)
    split = {"forward": [], "backward": [], "step": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        run.step(batch, step_idx=spec.steps)
        ev[3].record()
        ev[3].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["step"].append(ev[2].elapsed_time(ev[3]))
    fwd, bwd, step = (float(np.median(split[k]))
                      for k in ("forward", "backward", "step"))
    print(f"    one step by CUDA events: whole train_step {step} ms; its "
          f"forward alone {fwd} ms ({n_layers} kernel products, bias adds, "
          f"sigmoids, loss), backward alone {bwd} ms (torch.matmul), so "
          f"gradient norm, clipping and the SGD update about "
          f"{step - fwd - bwd} ms [{card}]")
    run.close()
    del run, leaves, loss

    # the kernel route against the plain route, on the params as
    # initialised (the seed's, drawn again) and the run's next batch
    cfg = get_config("cd-dnn")
    ps = {k: p.requires_grad_()
          for k, p in dnn.init_params(cfg, seed=spec.seed).items()}

    def loss_and_grads(params, uk):
        loss = dnn.loss_fn(params, cfg, batch, use_kernel=uk)
        return loss.item(), torch.autograd.grad(
            loss, [params[k] for k in keys])

    def rel_l2(ga, gb):
        return {k: ((a - b).norm() / b.norm()).item()
                for k, a, b in zip(keys, ga, gb)}

    def worst(rel):
        k = max(rel, key=rel.get)
        return f"{rel[k]} at {k}"

    lk, gk = loss_and_grads(ps, True)
    lp, gp = loss_and_grads(ps, False)
    ulp = {k: (p.detach() * (1 + 2.0 ** -23) if k.endswith("_w")
               else p.detach()).requires_grad_() for k, p in ps.items()}
    floor = rel_l2(loss_and_grads(ulp, False)[1], gp)
    check(np.isfinite(lk) and np.isfinite(lp), "non-finite parity loss")
    loss_rel = abs(lk - lp) / abs(lp)
    rel = rel_l2(gk, gp)
    print(f"    kernel vs plain route, one forward and backward on the "
          f"params as initialised and one batch: loss {lk} vs {lp} "
          f"(relative {loss_rel}, tolerance {DNN_LOSS_REL_TOL}); worst "
          f"leaf's gradient relative L2 {worst(rel)} (tolerance "
          f"{DNN_GRAD_REL_L2_TOL}); the plain route with every weight "
          f"scaled by 1 + 2^-23 (the network's sensitivity): {worst(floor)}")
    print(f"    per leaf, kernel vs plain: {rel}")
    check(loss_rel <= DNN_LOSS_REL_TOL, "kernel and plain route losses "
          "differ")
    check(max(rel.values()) <= DNN_GRAD_REL_L2_TOL,
          "kernel and plain route gradients differ")
    del ps, gk, gp, ulp

    # zero1: G members on the card, the §3.4 update on the ring kernels
    zspec = spec.replace(parallel="zero1",
                         comm=CommConfig(backend="pallas-ring"),
                         mesh=MeshSpec(members_per_device=G))
    run, hist, counts = _fit_dnn(zspec, f"zero1, G = {G}", card)
    n_buckets = len(run.opt_state.velocity)
    want = dict.fromkeys(counts, 0)
    want["blocked_matmul"] = zspec.steps * n_layers
    want["ring_reduce_scatter"] = zspec.steps * n_buckets
    want["ring_all_gather"] = zspec.steps * n_buckets
    check(counts == want, f"zero1 launches {counts}, want {want}")
    rs_launches = counts["ring_reduce_scatter"]
    ag_launches = counts["ring_all_gather"]
    # bitwise by phase 6 (a)'s argument: the ring's mean of G equal rows is
    # the gradient, the strip update the serial optimizer's arithmetic, and
    # nothing on this path (the kernel, cuBLAS on one stream, PyTorch's
    # reductions) varies from run to run
    z_losses = [h["loss"] for h in hist]
    differ = [k for k in keys
              if not torch.equal(run.params[k], serial_params[k])]
    print(f"    zero1 vs serial after {spec.steps} steps from seed "
          f"{spec.seed}: losses {z_losses} vs {serial_losses}; "
          f"{len(keys) - len(differ)} of {len(keys)} leaves bitwise equal "
          f"(required: all, and every loss)")
    check(z_losses == serial_losses and not differ,
          f"zero1 and serial runs differ (leaves {differ})")
    del serial_params

    # one zero1 update split into its phases
    up = UpdatePlan.build(run.optimizer, run.mesh, run.mesh.axis_names,
                          run.comm)
    plan, sched = up.buckets(run.params), up.schedule()
    lr = run.lr_schedule(0)
    timer = SyncedSpans()
    for _ in range(4):
        leaves = [run.params[k].requires_grad_() for k in keys]
        loss = run.loss_fn(run.params, batch)
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        scale = torch.clamp(spec.grad_clip / torch.clamp(
            global_norm(grads), min=1e-9), max=1.0)
        with torch.no_grad():
            for g in grads.values():
                g.mul_(scale)
            with timer.span("reduce"):
                g_strips = up.reduce(sched, plan, grads)
            with timer.span("apply"):
                new_p, run.opt_state = up.apply(sched, plan, run.params,
                                                g_strips, run.opt_state, lr)
            with timer.span("broadcast"):
                up.broadcast(sched, plan, run.params, new_p)
    med = {k: float(np.median(v[1:])) * 1e3 for k, v in timer.samples.items()}
    print(f"    one zero1 update by phases (spans ending in a device sync, "
          f"median of 3 after one warm-up): reduce {med['reduce']} ms "
          f"({n_buckets} reduce-scatters), apply {med['apply']} ms, "
          f"broadcast {med['broadcast']} ms ({n_buckets} all-gathers); "
          f"total {sum(med.values())} ms [{card}]")
    run.close()
    del run, leaves, loss, grads, g_strips, new_p, batch
    return gemm_launches, rs_launches, ag_launches


# ---------------------------------------------------------------------------
# phase 12: flash attention, kernel vs plain, and its times
# ---------------------------------------------------------------------------
# bf16: one bf16 ulp at the largest |plain| of each (batch, head) slice.
# The plain version widens bf16 to f32 and rounds once; the bf16 kernel sums
# exact bf16 products in f32 on the tensor cores and also rounds each tile's
# P to bf16 before P V, which moves an output by far less than an ulp of the
# slice's largest value (tests/test_torch_flash_numerics.py emulates it), so
# the two part where an f32 value straddles a rounding boundary.
# f32: 2e-5 of max |plain|; the two sum the same f32 products (at most D =
# 256 a score, Skv a row) in different orders.
FLASH_F32_TOL = 2e-5
H100_BF16_TC_FLOPS = 989e12    # data sheet, dense bf16 tensor cores
H100_TF32_TC_FLOPS = 494.7e12  # data sheet, dense TF32 tensor cores
FLASH_GRID = dict(Sq=(1, 64, 200, 256), extra=(0, 64),
                  heads=((4, 4), (8, 4), (32, 8)), D=(32, 64, 128, 256),
                  causal=(True, False), window=(0, 48), softcap=(0.0, 50.0),
                  dtype=(torch.bfloat16, torch.float32))
# (name, B, S, Hq, Hkv, D, window, softcap): the training path's shapes
FLASH_MODEL_SHAPES = (
    ("gemma2-2b global, B 2 S 1024", 2, 1024, 8, 4, 256, 0, 50.0),
    ("gemma2-2b local, B 2 S 1024", 2, 1024, 8, 4, 256, 4096, 50.0),
    ("gemma2-2b local, B 1 S 8192", 1, 8192, 8, 4, 256, 4096, 50.0),
    ("llama3-8b, B 1 S 2048", 1, 2048, 32, 8, 128, 0, 0.0),
    # head dims between the instances, on the 128 one
    ("zamba2-2.7b shared attention, B 2 S 1024", 2, 1024, 32, 32, 80, 0,
     0.0),
    ("h2o-danube-3-4b, B 1 S 2048", 1, 2048, 32, 8, 120, 4096, 0.0),
)


def flash_live_pairs(Sq, Skv, causal, window):
    """The (q, k) pairs one (batch, head) row block's mask keeps: the work
    this call's masks leave."""
    q_pos = np.arange(Sq) + (Skv - Sq)
    hi = np.minimum(q_pos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(B, Sq, Skv, Hq, Hkv, D, causal, window, dtype):
    """Least time of one call on an H100 SXM, in ms: 4 D operations (two
    products) per live (q, k) pair and head at the bf16 tensor-core peak
    (f32: six bf16 products for each, the f32 kernel's arithmetic, the same
    tensor time as three TF32 ones), or q, k, v read once and o written
    once, whichever is longer; and the operations at the f32 peak outside
    the tensor cores, the ceiling of an FFMA kernel.  Returns (bound ms,
    bound_by, f32 ms)."""
    f32 = dtype == torch.float32
    ops = 4 * B * Hq * D * flash_live_pairs(Sq, Skv, causal, window)
    nbytes = (4 if f32 else 2) * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    t_ops = (6 if f32 else 1) * ops / H100_BF16_TC_FLOPS
    t_bytes = nbytes / H100_SXM.mem_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            ops / H100_SXM.peak_flops * 1e3)


def flash_ratio(got, want):
    """Worst |kernel - plain| over its tolerance (<= 1 passes)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        return (err.max() / (FLASH_F32_TOL * w.abs().max())).item()
    big = w.abs().amax(dim=(1, 3), keepdim=True)
    return (err / torch.exp2(torch.floor(torch.log2(big)) - 7)).max().item()


def flash_inputs(dev, dtype, B, Sq, Skv, Hq, Hkv, D, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


def phase12(dev, card):
    import itertools

    from repro_torch.kernels import flash_attention as kflash
    torch.backends.cuda.matmul.allow_tf32 = False
    g = FLASH_GRID
    print(f"phase 12: flash_attention kernel vs plain; tolerance bf16 one "
          f"ulp at the largest |plain| of each (batch, head), f32 "
          f"{FLASH_F32_TOL} x max|plain|; feature grid B 2, Sq {g['Sq']}, "
          f"Skv = Sq + {g['extra']}, (Hq, Hkv) {g['heads']}, D {g['D']}, "
          f"causal and not, window {g['window']}, softcap {g['softcap']}, "
          f"bf16 and f32")
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n = 0
    for i, (Sq, extra, (Hq, Hkv), D, causal, window, softcap, dtype) in \
            enumerate(itertools.product(*g.values())):
        q, k, v = flash_inputs(dev, dtype, 2, Sq, Sq + extra, Hq, Hkv, D, i)
        kw = dict(causal=causal, window=window, logit_softcap=softcap)
        got = kflash.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        r = flash_ratio(got, kflash.flash_attention_plain(q, k, v, **kw))
        check(np.isfinite(r) and r <= 1.0,
              f"Sq {Sq} Skv {Sq + extra} Hq {Hq} Hkv {Hkv} D {D} {kw} "
              f"{dtype}: kernel disagrees with the plain version "
              f"(error / tolerance {r})")
        worst[dtype] = max(worst[dtype], r)
        n += 1
    print(f"  {n} feature-grid calls within tolerance; worst error / "
          f"tolerance bf16 {worst[torch.bfloat16]}, f32 "
          f"{worst[torch.float32]}")

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in FLASH_MODEL_SHAPES:
            row = flash_model_shape(dev, card, dtype, *shape)
            rows.setdefault(dtype, row)   # the global layer: the JSON rows
    rows[torch.float32]["name"] = "flash_attention_f32"
    return rows[torch.bfloat16], rows[torch.float32]


def flash_model_shape(dev, card, dtype, name, B, S, Hq, Hkv, D, window,
                      softcap):
    """Phase 12 at one of the training path's shapes in one type: the
    kernel against its plain version, their times, the bound, and
    ``F.scaled_dot_product_attention`` beside the kernel without the softcap
    where the window is 0; returns the shape's JSON row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    q, k, v = flash_inputs(dev, dtype, B, S, S, Hq, Hkv, D, S + D)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    got = kflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = kflash.flash_attention_plain(q, k, v, **kw)
    r = flash_ratio(got, want)
    err = (got.float() - want.float()).abs().max().item()
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    check(np.isfinite(r) and r <= 1.0, f"{name} {tag}: kernel disagrees with "
          f"the plain version (error / tolerance {r})")
    del got, want
    ms = cuda_ms(lambda: kflash.flash_attention(q, k, v, **kw), 3, 20)
    plain_ms = cuda_ms(lambda: kflash.flash_attention_plain(q, k, v, **kw),
                       1, 3)
    bound_ms, bound_by, f32_ms = flash_bound(B, S, S, Hq, Hkv, D, True,
                                             window, dtype)
    tflops = 4 * B * Hq * D * flash_live_pairs(S, S, True, window) \
        / (ms * 1e-3) / 1e12
    if dtype == torch.bfloat16:
        line = (f"  {name}, Hq {Hq} Hkv {Hkv} D {D}, causal, window "
                f"{window}, softcap {softcap}, bf16: max|kernel - plain| "
                f"{err} (error / tolerance {r}); kernel {ms} ms, plain "
                f"{plain_ms} ms; bound {bound_ms} ms ({bound_by}), at the "
                f"f32 FFMA peak {f32_ms} ms; kernel / bound {ms / bound_ms}, "
                f"kernel / f32 bound {ms / f32_ms}; {tflops} TFLOP/s, "
                f"{bound_ms / ms} of the bf16 tensor-core bound")
    else:
        dev_ms = graph_ms(lambda: kflash.flash_attention(q, k, v, **kw), 3, 20)
        line = (f"  {name}, Hq {Hq} Hkv {Hkv} D {D}, causal, window "
                f"{window}, softcap {softcap}, f32 (split pass, then six "
                f"bf16 products a product): max|kernel - plain| {err} "
                f"(error / tolerance {r}); kernel {ms} ms (as a CUDA graph "
                f"{dev_ms} ms), plain {plain_ms} ms; bound {bound_ms} ms "
                f"({bound_by}; six bf16 products at the tensor-core peak), at "
                f"the f32 FFMA peak {f32_ms} ms; kernel / bound "
                f"{ms / bound_ms}, kernel / FFMA bound {ms / f32_ms}; "
                f"{tflops} TFLOP/s of the attention's own operations")
    library_ms = None
    if window == 0:
        # SDPA has no softcap: time it, and the kernel, without one
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        library_ms = cuda_ms(sdpa, 3, 20)
        bare_ms = cuda_ms(lambda: kflash.flash_attention(q, k, v), 3, 20)
        d_sdpa = (sdpa().transpose(1, 2).float()
                  - kflash.flash_attention(q, k, v).float()).abs().max().item()
        line += (f"; without the softcap, side by side: kernel {bare_ms} ms, "
                 f"F.scaled_dot_product_attention {library_ms} ms (max|kernel "
                 f"- SDPA| {d_sdpa}), kernel / SDPA {bare_ms / library_ms}")
        if dtype == torch.float32:
            ops = device_ops(sdpa)
            line += (f"; SDPA f32 launches {len(ops)} kernels, its products "
                     f"{sorted({o for o in ops if 'gemm' in o.lower()})}")
    print(line + f" [{card}]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:105",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# The f32 path's kernel route against its plain route (chunked attention):
# both sum f32 products in different orders (the kernel within 2e-5 of max
# |plain|, ~1e-6 in relative L2 at these shapes), carried through one
# projection; a kernel wired wrongly differs by O(1).
FLASH_PATH_REL_L2_TOL = 1e-5
FLASH_PATH_GRAD_REL_L2_TOL = 1e-4


def phase12_f32_path(dev, card):
    """The f32 attention path: gemma2-2b's two attention blocks (its global
    and its local layer) at full width with random f32 weights from a seed,
    on f32 activations of batch 2 x 1024, forward and backward through
    ``layers.attention_block(use_kernel=True)``, the entry the LM's layers
    call (the LM itself runs bf16 activations).  Counts are zeroed just
    before and read just after (flash: one launch a block; nothing else);
    then the kernel route against the plain route from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.params import init_tree, tree_leaves
    from repro_torch.models import layers
    from repro_torch.models.transformer import effective_window
    cfg = get_config("gemma2-2b")
    batch, seq = LM_BATCH, LM_SEQ
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_tree(layers.attn_specs(cfg), gen, dev, torch.float32)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=dev)
    pos = torch.arange(seq, device=dev).expand(batch, seq)
    windows = [effective_window(cfg, kind, False) for kind in
               dict.fromkeys(cfg.block_pattern)]
    leaves = [x.requires_grad_()] + [t.requires_grad_() for t in
                                     tree_leaves(p)]

    def run(uk):
        outs, grads = [], []
        for w in windows:
            y, _ = layers.attention_block(p, x, cfg, NO_MESH, pos, window=w,
                                          use_kernel=uk)
            grads.append(torch.autograd.grad(y.square().mean(), leaves))
            outs.append((y - x).detach())
        return outs, grads

    torch.backends.cuda.matmul.allow_tf32 = False
    _counts_zeroed()
    t0 = time.perf_counter()
    out_k, grad_k = run(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = len(windows)
    check(counts == want, f"launches {counts}, want {want}")
    out_p, grad_p = run(False)

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()
    rel = max(rel_l2(a, b) for a, b in zip(out_k, out_p))
    rel_g = max(rel_l2(a, b) for ga, gb in zip(grad_k, grad_p)
                for a, b in zip(ga, gb))
    print(f"phase 12 (f32 path): {cfg.name}'s attention blocks (windows "
          f"{windows}) at full width (d_model {cfg.d_model}, {cfg.num_heads} "
          f"q / {cfg.num_kv_heads} kv heads of {cfg.head_dim}) on f32 "
          f"activations of {batch} x {seq}, forward and backward through "
          f"attention_block(use_kernel=True) in {wall} s: launches "
          f"{ {k: n for k, n in counts.items() if n} }, every other kernel "
          f"0; kernel vs plain route: attention output relative L2 {rel} "
          f"(tolerance {FLASH_PATH_REL_L2_TOL}), worst gradient relative L2 "
          f"{rel_g} (tolerance {FLASH_PATH_GRAD_REL_L2_TOL}) [{card}]")
    check(rel <= FLASH_PATH_REL_L2_TOL, "kernel and plain route outputs "
          "differ")
    check(rel_g <= FLASH_PATH_GRAD_REL_L2_TOL, "kernel and plain route "
          "gradients differ")
    return counts["flash_attention"]


# ---------------------------------------------------------------------------
# phase 13: gemma2-2b trains at full width and depth
# ---------------------------------------------------------------------------
# Kernel route vs plain route from the same params and batch.  The two
# attention forwards differ by f32 sum order and the kernel's bf16 P, so a
# bf16 output now and then rounds one ulp apart (phase 12), in each of 26
# layers, carried through bf16 activations: the loss to a relative 1e-3 (the CPU tests' bound
# against the reference, where such flips measured 1.2e-4).  The gradients
# of a bf16 network move with any such flip: on the CPU a one-ulp change
# of the embedding moves every leaf by ~1e-2 relative L2.  So, as phase 4
# does, the run measures the network's sensitivity (the plain route with
# every weight scaled by 1 + 2^-23 against the plain route) and holds every
# leaf of the kernel route to SENSITIVITY_FACTOR times its largest value,
# never tighter than LM_GRAD_REL_L2_TOL (the CPU tests' bound); a backward
# wired to the wrong function differs by O(1).
LM_STEPS = 4
LM_BATCH, LM_SEQ = 2, 1024
LM_PARAMS = 2_614_222_080
LM_LOSS_REL_TOL = 1e-3
LM_GRAD_REL_L2_TOL = 5e-2


def phase13(card):
    from repro_torch.api import RunSpec, compile_run
    from repro_torch.core.params import tree_leaves
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = RunSpec(arch="gemma2-2b", steps=LM_STEPS, batch=LM_BATCH,
                   seq=LM_SEQ, seed=0, log_every=1)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    cfg = run.cfg
    n_params = sum(p.numel() for p in tree_leaves(run.params))
    check(n_params == LM_PARAMS, f"{n_params} params, want {LM_PARAMS}")
    n_attn = cfg.num_layers
    print(f"phase 13: {cfg.name} at full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} q / "
          f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, window "
          f"{cfg.sliding_window}, softcaps {cfg.attn_logit_softcap} / "
          f"{cfg.final_logit_softcap}, vocab {cfg.vocab_size}), {n_params} "
          f"f32 params and AdamW state on {run.device} in "
          f"{time.perf_counter() - t0:.2f} s; {spec.steps} steps of batch "
          f"{spec.batch} x {spec.seq} tokens, every attention forward on "
          f"the kernel")

    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"history {hist}")
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = spec.steps * n_attn
    check(counts == want, f"launches {counts}, want {want}")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    tokens = spec.batch * spec.seq
    n_later = tokens * (spec.steps - 1)
    print(f"  {spec.steps} steps in {wall} s; launches: flash_attention "
          f"{counts['flash_attention']} = {spec.steps} x {n_attn}, every "
          f"other kernel 0")
    print(f"  steps 2-{spec.steps}: "
          f"{n_later / (sum(steps[1:]) + sum(waits[1:]))} tokens/s with the "
          f"data waits ({n_later / sum(steps[1:])} tokens/s of step time "
          f"alone); step median {np.median(steps[1:]) * 1e3} ms; first step "
          f"{steps[0] * 1e3} ms; data_wait median "
          f"{np.median(waits[1:]) * 1e3} ms; peak memory {peak_gb} GB "
          f"[{card}]")

    # where one step's time goes (CUDA events, 3 reps, median)
    batch = next(run.data)
    leaves = tree_leaves(run.params)
    split = {"forward": [], "backward": [], "step": [], "enqueue": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        h0 = time.perf_counter()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        # the host's time to issue the forward: where it is about the
        # forward's device time, the card waits on the host
        split["enqueue"].append((time.perf_counter() - h0) * 1e3)
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        del loss, grads
        run.step(batch, step_idx=spec.steps)
        ev[3].record()
        ev[3].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["step"].append(ev[2].elapsed_time(ev[3]))
    fwd, bwd, step = (float(np.median(split[k]))
                      for k in ("forward", "backward", "step"))
    print(f"  one step by CUDA events: whole train_step {step} ms; its "
          f"forward alone {fwd} ms ({n_attn} kernel attentions), backward "
          f"alone {bwd} ms (attention_ref's gradient recomputed per layer), "
          f"so gradient norm, clipping and the AdamW update about "
          f"{step - fwd - bwd} ms; the host issued the forward in "
          f"{float(np.median(split['enqueue']))} ms [{card}]")
    run.close()
    run.opt_state = None     # free AdamW's moments before the route check
    del leaves
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel route against the plain route, on the run's params and its
    # next batch; the plain route's gradients wait in host memory, so that
    # at most one pass and one set of gradients share the card with the
    # params
    leaves = tree_leaves(run.params)
    names = list(_leaf_names(run.params))

    def loss_and_grads(uk):
        torch.cuda.reset_peak_memory_stats()
        loss = transformer.lm_loss(run.params, cfg, NO_MESH, batch,
                                   use_kernel=uk)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads, torch.cuda.max_memory_allocated() / 1e9

    def rel_l2(ga, gb_host):
        return [((a - b.to(a.device)).norm() / b.norm().to(a.device)).item()
                for a, b in zip(ga, gb_host)]

    lp, gp, peak_plain = loss_and_grads(False)
    gp = [g.cpu() for g in gp]
    lk, gk, peak_kernel = loss_and_grads(True)
    rel = rel_l2(gk, gp)
    del gk
    with torch.no_grad():          # the params are not needed after this
        for p in leaves:
            p.mul_(1 + 2.0 ** -23)
    _, gu, _ = loss_and_grads(False)
    floor = rel_l2(gu, gp)
    del gu, gp
    check(np.isfinite(lk) and np.isfinite(lp), "non-finite parity loss")
    loss_rel = abs(lk - lp) / abs(lp)
    tol = max(LM_GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * max(floor))
    worst_k = int(np.argmax(rel))
    print(f"  kernel vs plain route, one forward and backward on the "
          f"params after the run and its next batch: loss {lk} vs {lp} "
          f"(relative {loss_rel}, tolerance {LM_LOSS_REL_TOL}); worst "
          f"leaf's gradient relative L2 {rel[worst_k]} at "
          f"{names[worst_k]}; the plain route with every weight scaled by "
          f"1 + 2^-23 (the network's sensitivity): worst {max(floor)} at "
          f"{names[int(np.argmax(floor))]}; tolerance for every leaf "
          f"max({LM_GRAD_REL_L2_TOL}, {SENSITIVITY_FACTOR} x "
          f"sensitivity) = {tol}; peak memory of one pass with the optimizer "
          f"state freed: kernel route {peak_kernel} GB, plain route "
          f"{peak_plain} GB [{card}]")
    print(f"  per leaf, kernel vs plain: {dict(zip(names, rel))}")
    print(f"  per leaf, weights x (1 + 2^-23) vs plain: "
          f"{dict(zip(names, floor))}")
    check(loss_rel <= LM_LOSS_REL_TOL, "kernel and plain route losses "
          "differ")
    check(max(rel) <= tol, "kernel and plain route gradients differ")
    del leaves, batch
    run.params = None
    return counts["flash_attention"]


# ---------------------------------------------------------------------------
# phase 14: the overlapped zero1 path (paper §3.1)
# ---------------------------------------------------------------------------
# Every fit and check of this phase runs under a deadline: a reduce that
# hangs on the side stream (the int8 kernels are cooperative launches,
# which need every block of their grid resident at once, queued beside the
# backward's kernels) ends the run with every thread's stack and exit code
# 1 instead of hanging it.
# (a) one fp32 step with grad_clip=0 from the same params, state and batch,
# overlapped against monolithic, bitwise (no tolerance), 3 times: the taps
# pack the same cotangents and reduce them with the same kernels, and the
# side stream only moves when the ring reads them (a missing wait or
# record_stream shows as wrong numbers only now and then).
# (b) 3-step losses, overlapped vs monolithic from the same seed under
# deterministic cuDNN: phase 6 (b)'s tolerance (the clip scales the
# reduced strips, not the gradient, so the runs part by rounding).
OVERLAP_DEADLINE_S = 300
OVERLAP_AB_REPS = 9             # alternating step pairs; the first warms up


@contextmanager
def deadline(seconds):
    """Dump every thread's stack and exit with code 1 if the block has not
    ended after ``seconds``."""
    import faulthandler
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _clone(tree):
    from repro_torch.core.params import map_tree
    return map_tree(lambda t: t.detach().clone(), tree)


def _monolithic_step(run, grad_clip):
    """The monolithic zero1 step of ``run``'s loss, optimizer and comm
    (``overlap=False``): the same strip state layout as the run's."""
    import dataclasses
    from repro_torch.optim.dist import make_distributed_update
    from repro_torch.train import make_train_step
    _, update = make_distributed_update(
        run.optimizer, run.mesh, run.mesh.axis_names,
        dataclasses.replace(run.comm, overlap=False))
    return make_train_step(run.loss_fn, run.optimizer, run.lr_schedule,
                           grad_clip=grad_clip, dist_update=update)


def _reduce_kernels(fmt, n_buckets, G):
    return ({"int8_quantize": n_buckets,
             "ring_hop_int8": n_buckets * (G - 1)} if fmt == "int8"
            else {"ring_reduce_scatter": n_buckets})


def _overlap_split(run, batch, fmt, card, reps=4):
    """One overlapped step split into spans: forward, backward+reduce (the
    tapped backward up to the stream join) and exposed_reduce (from the
    compute stream's last backward kernel to the join), by CUDA events on
    the compute stream; then apply and broadcast (spans ending in a device
    sync).  The launch counts are read when ``autograd.grad`` returns and
    after the step: every reduce is issued inside the backward, every
    gather after it.  The first rep also checks the replication invariant."""
    from repro_torch.comm.overlap import join_comm, make_overlap_grad
    from repro_torch.comm.schedule import group_axes
    from repro_torch.kernels import ring as kring
    from repro_torch.optim.dist import UpdatePlan
    from repro_torch.train.train_step import clip_strips
    ev = {}

    def timed_loss(p, b):
        loss = run.loss_fn(p, b)
        ev["forward"].record()
        return loss

    axes = run.mesh.axis_names
    _, axis_arg, G = group_axes(run.mesh, axes)
    grad = make_overlap_grad(timed_loss, run.mesh, axis_arg, run.comm, G)
    up = UpdatePlan.build(run.optimizer, run.mesh, axes, run.comm)
    plan, sched = up.buckets(run.params), up.schedule()
    nb = plan.n_collectives
    lr = run.lr_schedule(0)
    want = _reduce_kernels(fmt, nb, G)
    ms = {k: [] for k in ("forward", "backward+reduce", "exposed_reduce")}
    split = SyncedSpans()
    for rep in range(reps):
        torch.cuda.synchronize()
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "forward", "backward", "join")}
        _counts_zeroed()
        ev["start"].record()
        _, strips = grad(run.params, batch, join=False)
        ev["backward"].record()
        at_backward = _counts()
        join_comm(run.device)
        ev["join"].record()
        ev["join"].synchronize()
        ms["forward"].append(ev["start"].elapsed_time(ev["forward"]))
        ms["backward+reduce"].append(ev["forward"].elapsed_time(ev["join"]))
        ms["exposed_reduce"].append(ev["backward"].elapsed_time(ev["join"]))
        clip_strips(strips, run.mesh, axis_arg, run.spec.grad_clip)
        with torch.no_grad():
            with split.span("apply"):
                new_p, run.opt_state = up.apply(sched, plan, run.params,
                                                strips, run.opt_state, lr)
            if rep == 0:
                for ps in new_p:
                    full = sched.broadcast(ps)
                    check(all(torch.equal(full[0], full[i])
                              for i in range(1, G)),
                          "members' gathered buffers differ")
                _counts_zeroed()
                for k in kring.launches:       # the forward's are counted too
                    check(at_backward[k] == want.get(k, 0), f"{fmt} overlap: "
                          f"{at_backward[k]} {k} launches when the backward "
                          f"returned, want {want.get(k, 0)} ({want})")
            with split.span("broadcast"):
                up.broadcast(sched, plan, run.params, new_p)
            if rep == 0:
                after = _counts()
                check(after["ring_all_gather"] == nb and sum(after.values())
                      == nb, f"after the step {after}, want {nb} gathers")
    med = {k: float(np.median(v[1:])) for k, v in ms.items()}
    med.update({k: float(np.median(v[1:])) * 1e3
                for k, v in split.samples.items()})
    print(f"    launches when autograd.grad returned: {want} (every "
          f"reduce issued inside the backward), all-gathers 0; after the "
          f"step {nb} all-gathers; replication invariant: all {G} rows of "
          f"each of the {nb} gathered buffers bitwise equal")
    print(f"    one step by spans (median of {reps - 1} after one warm-up; "
          f"CUDA events on the compute stream): forward {med['forward']} "
          f"ms, backward+reduce {med['backward+reduce']} ms, "
          f"exposed_reduce {med['exposed_reduce']} ms; then apply "
          f"{med['apply']} ms, broadcast {med['broadcast']} ms (spans "
          f"ending in a device sync) [{card}]")
    return med


def _step_ab(run, batch, card, reps=OVERLAP_AB_REPS):
    """The monolithic and the overlapped step of ``run`` alternating on
    its params, state and one batch: the median of each's step time (the
    device synchronised before and after) over the reps after the first,
    and each's peak memory."""
    steps = {"monolithic": _monolithic_step(run, run.spec.grad_clip),
             "overlap": run.train_step}
    times = {k: [] for k in steps}
    peak = dict.fromkeys(steps, 0)
    for rep in range(reps):
        names = list(steps) if rep % 2 == 0 else list(steps)[::-1]
        for name in names:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run.params, run.opt_state, _ = steps[name](
                run.params, run.opt_state, 0, batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    med = {k: float(np.median(v[1:])) for k, v in times.items()}
    print(f"    A/B, {reps - 1} alternating pairs after one warm-up, one "
          f"batch: step median monolithic {med['monolithic']} ms, overlap "
          f"{med['overlap']} ms (overlap / monolithic "
          f"{med['overlap'] / med['monolithic']}); peak memory monolithic "
          f"{peak['monolithic'] / 1e9} GB, overlap {peak['overlap'] / 1e9} "
          f"GB [{card}]")
    return med, peak


def _stream_overlap(fn):
    """Run ``fn`` under ``torch.profiler`` and read its kernels from the
    trace: the side stream is the one the reduce kernels (the ring's fold,
    the int8 wire kernel) ran on.  Returns, for all of the side stream's
    kernels and for its cooperative int8 kernels alone, (kernels, those
    that ran beside a kernel of another stream, their ms, the ms of that
    which another stream's kernels covered); None when the trace has no
    side-stream kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    ks = [(e.get("args", {}).get("stream"), e["ts"], e["ts"] + e["dur"],
           e["name"]) for e in events
          if e.get("cat") == "kernel" and "dur" in e]
    side = {s for s, _, _, n in ks
            if "fold_kernel" in n or "int8_wire_kernel" in n}
    if not side:
        return None
    merged = []
    for a, b in sorted((a, b) for s, a, b, _ in ks if s not in side):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out = {"all": [0, 0, 0.0, 0.0], "int8": [0, 0, 0.0, 0.0]}
    for s, a, b, n in ks:
        if s not in side:
            continue
        cov = sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)
        for key in ("all", "int8") if "int8_wire_kernel" in n else ("all",):
            row = out[key]
            row[0] += 1
            row[1] += cov > 0
            row[2] += (b - a) / 1e3
            row[3] += cov / 1e3
    return out


def _print_stream_overlap(run, batch, fmt):
    got = _stream_overlap(lambda: run.step(batch))
    if got is None:
        print("    torch.profiler: no side-stream kernel in the trace; "
              "concurrency not measured")
        return
    n, beside, total, covered = got["all"]
    print(f"    torch.profiler, one {fmt} step: {n} kernels on the side "
          f"stream, {beside} of them ran beside a kernel of the compute "
          f"stream; {total} ms of side-stream kernel time, {covered} ms of "
          f"it beside the compute stream's kernels")
    if got["int8"][0]:
        n, beside, total, covered = got["int8"]
        print(f"    of them the cooperative int8 kernels: {n}, {beside} "
              f"beside a compute-stream kernel; {total} ms, {covered} ms "
              f"of it beside the compute stream's kernels")


def phase14(card):
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.comm import CommConfig
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.optim.dist import make_overlapped_update
    from repro_torch.train import make_overlapped_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    G = 4
    base = dict(arch="vgg-a", batch=64, lr=5e-3, schedule="constant", seed=0,
                log_every=1, parallel="zero1",
                mesh=MeshSpec(members_per_device=G))
    print(f"phase 14: the overlapped zero1 path (paper §3.1): each bucket's "
          f"reduce issued inside the backward pass on a side CUDA stream; "
          f"G = {G} members on the card, pallas-ring, every fit and check "
          f"under a {OVERLAP_DEADLINE_S} s deadline")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for fmt, steps in (("fp32", 4), ("int8", 3)):
        spec = RunSpec(**base, steps=steps,
                       comm=CommConfig(backend="pallas-ring",
                                       wire_format=fmt, overlap=True))
        with deadline(OVERLAP_DEADLINE_S):
            run, hist, counts = _fit_dnn(spec, f"VGG-A {fmt}, overlap", card,
                                         unit="images", what="conv")
            strips = run.opt_state.velocity
            n_buckets, n_conv = len(strips), len(run.cfg.conv_layers())
            check(n_buckets == 14 and all(
                s.dim() == 2 and s.shape[0] == G for s in strips),
                f"strip state {[tuple(s.shape) for s in strips]}")
            want = dict.fromkeys(counts, 0)
            want["conv2d_nhwc"] = steps * n_conv
            want["ring_all_gather"] = steps * n_buckets
            for k, v in _reduce_kernels(fmt, n_buckets, G).items():
                want[k] = steps * v
            check(counts == want, f"{fmt} overlap launches {counts}, want "
                  f"{want}")
            add(counts)
            batch = next(run.data)
            _overlap_split(run, batch, fmt, card)
            _step_ab(run, batch, card)
            _print_stream_overlap(run, batch, fmt)
        if fmt == "fp32":
            with deadline(OVERLAP_DEADLINE_S):
                torch.backends.cudnn.deterministic = True
                p0, s0 = _clone(run.params), _clone(run.opt_state)
                mono = _monolithic_step(run, 0.0)
                init_fn, local = make_overlapped_update(
                    run.optimizer, run.mesh, run.mesh.axis_names, run.comm)
                over = make_overlapped_train_step(
                    run.loss_fn, run.lr_schedule, run.mesh,
                    run.mesh.axis_names, run.comm, local, grad_clip=0.0)
                for rep in range(3):
                    pm, sm = _clone(p0), _clone(s0)
                    mono(pm, sm, 0, batch)
                    po, so = _clone(p0), _clone(s0)
                    over(po, so, 0, batch)
                    differ = [k for k in sorted(pm)
                              if not torch.equal(pm[k], po[k])]
                    differ += [f"state {i}" for i, (a, b) in enumerate(
                        zip(sm.velocity, so.velocity))
                        if not torch.equal(a, b)]
                    check(not differ, f"(a) rep {rep}: overlapped and "
                          f"monolithic steps differ at {differ}")
                print(f"    (a) one step with grad_clip=0 from the same "
                      f"params, state and batch, deterministic cuDNN: "
                      f"overlapped bitwise equal to monolithic, all "
                      f"{len(pm)} leaves and {len(sm.velocity)} state "
                      f"strips, 3 times out of 3")
                del p0, s0, pm, sm, po, so
                run.close()
                del run, batch
                gc.collect()
                torch.cuda.empty_cache()
                losses = {}
                for mode in (True, False):
                    s = spec.replace(steps=3, comm=CommConfig(
                        backend="pallas-ring", overlap=mode))
                    r = use_kernel(compile_run(s))
                    losses[mode] = [h["loss"]
                                    for h in r.fit(log_fn=lambda *_: None)]
                    r.close()
                    del r
                    gc.collect()
                    torch.cuda.empty_cache()
                torch.backends.cudnn.deterministic = False
                worst = max(abs(a - b) / abs(b)
                            for a, b in zip(losses[True], losses[False]))
                print(f"    (b) 3 steps from seed 0, deterministic cuDNN: "
                      f"overlap losses {losses[True]}, monolithic "
                      f"{losses[False]}; worst relative difference {worst} "
                      f"(tolerance {ZERO1_LOSS_REL_TOL})")
                check(worst <= ZERO1_LOSS_REL_TOL,
                      "overlapped and monolithic losses differ")
        else:
            run.close()
            del run, batch
        gc.collect()
        torch.cuda.empty_cache()

    spec = RunSpec(arch="cd-dnn", batch=DNN_BATCH, steps=DNN_STEPS,
                   lr=DNN_LR, schedule="constant", seed=0, log_every=1,
                   parallel="zero1", mesh=MeshSpec(members_per_device=G),
                   comm=CommConfig(backend="pallas-ring", overlap=True))
    with deadline(OVERLAP_DEADLINE_S):
        run, hist, counts = _fit_dnn(spec, "CD-DNN fp32, overlap", card)
        n_buckets = len(run.opt_state.velocity)
        n_layers = run.cfg.num_hidden + 1
        want = dict.fromkeys(counts, 0)
        want["blocked_matmul"] = spec.steps * n_layers
        want["ring_reduce_scatter"] = spec.steps * n_buckets
        want["ring_all_gather"] = spec.steps * n_buckets
        check(counts == want, f"CD-DNN overlap launches {counts}, want "
              f"{want}")
        add(counts)
        batch = next(run.data)
        _overlap_split(run, batch, "fp32", card)
        _step_ab(run, batch, card)
        _print_stream_overlap(run, batch, "fp32")
        run.close()
        del run, batch
    print(f"  the overlapped path's launches in its fits: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: checkpoints, resume across world sizes, and the cluster CLI
# ---------------------------------------------------------------------------
# (a) in this process, full-width VGG-A zero1 at G = 4 on the card,
# pallas-ring, every forward conv on the kernel, deterministic cuDNN.  2
# steps, a checkpoint, a fresh compile_run and 2 more steps must be bitwise
# the 4 uninterrupted steps, params and strips: the checkpoint holds the
# same f32 bits, the resumed stream skips the same batches, and every kernel
# and cuDNN call repeats.  Resumed at G = 2 (the strips re-planned) its
# final loss must lie within RESUME_REL_TOL of an uninterrupted G = 2 run's:
# in general another G sums the members' gradients in another order (on a
# local mesh the G rows are equal, and the ring's mean of 2 or 4 equal rows
# is exact, phase 6 (a), so here the two may agree bitwise).  A control
# resumes the same checkpoint with its world meta rewritten as hierarchical
# [2, 2]: the re-plan then undoes an owner permutation the save never
# applied (rows 1 and 2 of every strip swapped), and it must miss the
# tolerance.
# (b) the cluster CLI as a user runs it: 2 processes on the card over gloo
# (they share it), worker 1 killed at step 3, the run resumed at world 1
# from the step-2 checkpoint; --verify trains one process in the
# supervisor, and the final losses must agree within RESUME_REL_TOL of the
# loss, while a dropped rank must miss that by CONTROL_MISS times.  A
# world-2 run without a kill or a checkpoint gives that world's step time
# and each rank's launches (the "launches/<kernel>" counters of its
# trace).  Then the training CLI once.  Every CLI runs in a session of its
# own, killed whole at its timeout.
CKPT_G = 4
CKPT_RESUME_G = 2
CKPT_DEADLINE_S = 300          # each fit of phase 15a; ~3 s alone
RESUME_REL_TOL = 1e-5
CONTROL_MISS = 10.0
CLUSTER_TIMEOUT_S = 420
CLUSTER_STEPS = 6
CLUSTER_W2_STEPS = 6
TRAIN_CLI_STEPS = 2


def _ckpt_spec(G, steps, **kw):
    from repro_torch.api import MeshSpec, RunSpec
    from repro_torch.comm import CommConfig
    return RunSpec(arch="vgg-a", batch=64, lr=5e-3, schedule="constant",
                   seed=0, log_every=1, steps=steps, parallel="zero1",
                   comm=CommConfig(backend="pallas-ring"),
                   mesh=MeshSpec(members_per_device=G), **kw)


def _ckpt_fit(spec, tag, spans=None, wrap_restore=None):
    """compile_run of ``spec`` with every forward conv on the kernel, and
    its fit under a deadline, every count zeroed just before ``fit`` and
    read just after; returns (run, history, counts, lines)."""
    from repro_torch.api import compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    run = use_kernel(compile_run(spec, recorder=spans))
    if wrap_restore is not None:
        run.restore = wrap_restore(run.restore)
    lines = []
    torch.cuda.synchronize()
    _counts_zeroed()
    with deadline(CKPT_DEADLINE_S):
        hist = run.fit(log_fn=lambda line: (lines.append(line),
                                            print(f"    {tag}: {line}")))
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts().items() if v}
    check(hist and all(np.isfinite(h["loss"]) for h in hist),
          f"{tag} history {hist}")
    return run, hist, counts, lines


def _host_state(run):
    from repro_torch.checkpoint.ckpt import leaves_with_paths
    return ({k: v.detach().cpu() for k, v in run.params.items()},
            [(p, v.cpu() if isinstance(v, torch.Tensor) else v)
             for p, v in leaves_with_paths(run.opt_state)])


def _drop(run):
    del run
    gc.collect()
    torch.cuda.empty_cache()


def _per_step(n_buckets, steps):
    return {"conv2d_nhwc": 8 * steps, "ring_reduce_scatter": n_buckets * steps,
            "ring_all_gather": n_buckets * steps}


def _misread_owner_order(src, dst, step):
    """A copy of checkpoint ``step`` of ``src`` in ``dst`` whose world meta
    says hierarchical [2, 2]: a re-plan from it un-permutes rows that the
    flat save never permuted."""
    import shutil
    from repro_torch.checkpoint.replan import world_meta
    os.makedirs(dst)
    name = f"ckpt_{step:08d}"
    with open(os.path.join(src, name + ".json")) as f:
        manifest = json.load(f)
    flat = manifest["meta"]["zero1"]
    check(flat["axes_sizes"] == [CKPT_G] and not flat["hierarchical"],
          f"phase 15a saved {flat}, want a flat world of {CKPT_G}")
    manifest["meta"]["zero1"] = world_meta([2, 2], True,
                                           flat["bucket_bytes"])
    with open(os.path.join(dst, name + ".json"), "w") as f:
        json.dump(manifest, f)
    shutil.copy(os.path.join(src, name + ".npz"), dst)


def phase15a(card):
    import shutil
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    n_buckets = vgg_buckets(CKPT_G).n_collectives
    d = tempfile.mkdtemp(prefix="ckpt15-")
    try:
        print(f"phase 15a: full-width VGG-A zero1, G = {CKPT_G} members on "
              f"the card, pallas-ring, forward convs on the kernel, batch "
              f"64, deterministic cuDNN: 4 uninterrupted steps against 2 + "
              f"checkpoint + fresh compile_run + 2 [{card}]")
        whole, _, counts, _ = _ckpt_fit(_ckpt_spec(CKPT_G, 4), "whole")
        want = _per_step(n_buckets, 4)
        check(counts == want, f"uninterrupted launches {counts}, want {want}")
        want_p, want_s = _host_state(whole)
        n_params = sum(p.numel() for p in whole.params.values())
        _drop(whole)

        spans = SyncedSpans()
        first, _, _, _ = _ckpt_fit(_ckpt_spec(CKPT_G, 2, ckpt_every=2,
                                              ckpt_dir=d), "first", spans)
        _drop(first)
        write_s = spans.seconds["ckpt_write"]
        nbytes = os.path.getsize(os.path.join(d, "ckpt_00000002.npz"))
        payload = sum(t.numel() * t.element_size()
                      for t in [*want_p.values(), *(v for _, v in want_s)])
        restore_s = []

        def timed(restore):
            def run_timed(step):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                restore(step)
                torch.cuda.synchronize()
                restore_s.append(time.perf_counter() - t0)
            return run_timed
        resumed, hist, counts, lines = _ckpt_fit(
            _ckpt_spec(CKPT_G, 4, ckpt_dir=d), "resumed", wrap_restore=timed)
        check(any("resuming from checkpoint step 2" in x for x in lines),
              f"no resume line in {lines}")
        check([h["step"] for h in hist] == [3, 4], f"resumed {hist}")
        want = _per_step(n_buckets, 2)
        check(counts == want, f"resumed launches {counts}, want {want}")
        resumed_counts = counts
        got_p, got_s = _host_state(resumed)
        _drop(resumed)
        check(all(torch.equal(got_p[k], want_p[k]) for k in want_p),
              "resumed params differ from the uninterrupted run's")
        check(len(got_s) == len(want_s) and all(
            a[0] == b[0] and torch.equal(a[1], b[1])
            for a, b in zip(got_s, want_s)),
            "resumed strips differ from the uninterrupted run's")
        print(f"  checkpoint of step 2: {nbytes} bytes on disk ({payload} "
              f"bytes of arrays: {n_params} params and {len(want_s)} strip "
              f"tensors, f32); written in {write_s} s (ckpt_write span, "
              f"gather + host copy + npz), restored in {restore_s[0]} s "
              f"[{card}]")
        print(f"  resumed at G = {CKPT_G}: params and strips bitwise the "
              f"uninterrupted run's; launches {resumed_counts} = 2 steps x "
              f"(8 convs, {n_buckets} reduce-scatters, {n_buckets} gathers)")

        # the same checkpoint resumed at another world size, and misread
        def final(spec, tag):
            run, hist, counts, lines = _ckpt_fit(spec, tag)
            p, _ = _host_state(run)
            _drop(run)
            return hist[-1]["loss"], p, counts, lines
        loss, s_p, counts, lines = final(
            _ckpt_spec(CKPT_RESUME_G, 4, ckpt_dir=d), f"G={CKPT_RESUME_G} "
            "resumed")
        check(any("resuming from checkpoint step 2" in x for x in lines),
              f"no resume line in {lines}")
        small_buckets = vgg_buckets(CKPT_RESUME_G).n_collectives
        want = _per_step(small_buckets, 2)
        check(counts == want, f"G={CKPT_RESUME_G} resumed launches {counts},"
              f" want {want}")
        ref_loss, r_p, _, _ = final(_ckpt_spec(CKPT_RESUME_G, 4),
                                    f"G={CKPT_RESUME_G} whole")
        wrong_dir = os.path.join(d, "misread")
        _misread_owner_order(d, wrong_dir, 2)
        bad_loss, _, _, _ = final(_ckpt_spec(CKPT_RESUME_G, 4,
                                             ckpt_dir=wrong_dir),
                                  f"G={CKPT_RESUME_G} misread owner order")
        tol = RESUME_REL_TOL * abs(ref_loss)
        diff, bad = abs(loss - ref_loss), abs(bad_loss - ref_loss)
        worst = max(float((s_p[k] - r_p[k]).abs().max()) for k in r_p)
        check(diff <= tol, f"G={CKPT_RESUME_G} resume: final loss {loss} vs "
              f"{ref_loss}, |diff| {diff} > {tol}")
        check(bad > tol, f"the misread owner order's final loss {bad_loss} "
              f"lies within {tol} of {ref_loss}: the resume gate is blind")
        print(f"  resumed at G = {CKPT_RESUME_G} from the G = {CKPT_G} "
              f"checkpoint (strips re-planned): final loss {loss} vs "
              f"{ref_loss} uninterrupted, |diff| {diff} <= tol {tol} "
              f"({RESUME_REL_TOL} of the loss); max |param diff| {worst}"
              f"{' (bitwise)' if worst == 0 else ''}; launches {counts}; "
              f"the control with the owner order misread (hierarchical "
              f"[2, 2] meta): final loss {bad_loss}, |diff| {bad} = "
              f"{bad / tol} x tol [{card}]")
        return resumed_counts
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.backends.cudnn.deterministic = False


def _trace_events(path):
    from repro_torch.telemetry import read_jsonl
    return read_jsonl(path)


def _trace_steps(path):
    """Durations (s) of the ``step`` spans in one worker's JSONL trace."""
    return [e["dur"] for e in _trace_events(path)
            if e.get("kind") == "step" and e.get("ph") == "span"]


def _trace_launches(path):
    """The ``launches/<kernel>`` counters of a trace's closing metrics."""
    metrics = [e for e in _trace_events(path) if e.get("kind") == "metrics"]
    check(metrics, f"no closing metrics in {path}")
    return {k.split("/", 1)[1]: v for k, v in metrics[-1]["counters"].items()
            if k.startswith("launches/")}


def _cli(module, argv, env):
    """``python -m module argv`` as a user runs it, in a session of its
    own that is killed whole after CLUSTER_TIMEOUT_S: its CompletedProcess
    and wall seconds; its stdout is printed under cli:."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CLUSTER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"chip smoke failed: {module} ran past "
                           f"{CLUSTER_TIMEOUT_S} s:\n{out}\n{err}") from None
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        print(f"    cli: {line}")
    check(proc.returncode == 0, f"{module} exit {proc.returncode}:\n"
          f"{err[-6000:]}")
    return subprocess.CompletedProcess(proc.args, 0, out, err), wall


def _dropped_rank_loss(argv, steps):
    """The final loss of the verify's one-process run had rank 1's gradient
    been dropped: steps 1..steps-1 train on rank 0's rows of each batch
    alone (under the clip, whose norm the gradient far exceeds, that is the
    update of a mean over ranks missing rank 1's term), and the last step's
    loss is taken over the whole batch, as the group mean is."""
    import argparse
    from repro_torch.data.pipeline import make_placer
    from repro_torch.launch.cluster import make_parser, resolve_comm_backends
    from repro_torch.launch.train import compile_from_args
    args = make_parser().parse_args(argv)
    resolve_comm_backends(args)
    run = compile_from_args(argparse.Namespace(**dict(
        vars(args), ckpt_dir=None, ckpt_every=0, trace_dir=None)))
    stream = run.family.stream(run.cfg, run.spec.batch, run.spec.seq,
                               run.spec.seed)
    whole, rank0 = make_placer(run.device), make_placer(run.device, (0, 2))
    with deadline(CKPT_DEADLINE_S):
        for i in range(steps - 1):
            run.step(rank0(next(stream)), i)
        loss = float(run.step(whole(next(stream)), steps - 1)["loss"])
    _drop(run)
    return loss


def phase15b(card):
    import ast
    import re
    import shutil
    d = tempfile.mkdtemp(prefix="cluster15-")
    trace = os.path.join(d, "trace")
    # the cross-pod level takes the cluster's default, pallas-ring
    argv = ["--processes", "2", "--arch", "vgg-a", "--parallel", "zero1",
            "--comm-backend", "pallas-ring", "--batch", "64", "--steps",
            str(CLUSTER_STEPS), "--schedule", "constant", "--ckpt-every", "2",
            "--ckpt-dir", d, "--run-dir", d, "--chaos-kill-step", "3",
            "--trace-dir", trace, "--use-kernel", "--verify"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        out, wall = _cli("repro_torch.launch.cluster", argv, env)
        for want in ("2 processes over gloo", "cross_backend='pallas-ring'",
                     "kernel=True", "chaos: SIGKILL worker 1 at step",
                     "attempt 1: world=1", "resuming from checkpoint step 2",
                     "verify:", "OK"):
            check(want in out.stdout, f"no {want!r} in:\n{out.stdout[-4000:]}")
        # the one failure must be the chaos kill: any other death would be
        # recovered from the same way and hide a fault.  Worker 1 ends by
        # SIGKILL (-9); worker 0 may also exit, with an error, on losing its
        # peer before the supervisor looks
        failed = re.findall(r"\[elastic\] attempt (\d+) failed: (\w+) "
                            r"\(dead workers: [^;]*; exit codes ([^)]*)\)",
                            out.stdout)
        check(len(failed) == 1 and failed[0][:2] == ("0", "exit"),
              f"failed attempts {failed}, want attempt 0's only")
        codes = ast.literal_eval(failed[0][2])
        check(codes.get(1) == -9 and all(c > 0 for w, c in codes.items()
                                         if w != 1),
              f"dead workers' exit codes {codes}: want worker 1 SIGKILLed "
              f"(-9), any other an error exit after it")
        attempts = re.findall(r"\[elastic\] (attempt \d+[^\n]*)", out.stdout)
        check([a.split(":")[0] for a in attempts] == [
            "attempt 0", "attempt 0 failed", "attempt 1"]
            and "world=2" in attempts[0] and "world=1" in attempts[2],
            f"attempts {attempts}: want world 2, the kill, world 1")
        with open(os.path.join(trace, "trace.json")) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"}
        want_spans = {"step", "data_wait", "first_step", "ckpt_write"}
        check(want_spans <= spans, f"merged trace spans {spans}, want "
              f"{want_spans} among them")
        # attempt 1's worker 0 rewrote trace_p0 (world 1, steps 3-6)
        w1 = _trace_steps(os.path.join(trace, "trace_p0.jsonl"))
        verify = re.search(r"\[cluster\] verify: cluster=(\S+) single=(\S+) "
                           r"\|diff\|=(\S+) tol=(\S+)", out.stdout)
        cluster_loss, single = float(verify.group(1)), float(verify.group(2))
        tol = RESUME_REL_TOL * abs(single)
        diff = abs(cluster_loss - single)
        check(diff <= tol, f"cluster final loss {cluster_loss} vs one "
              f"process {single}: |diff| {diff} > {tol}")
        print(f"phase 15b: python -m repro_torch.launch.cluster "
              f"{' '.join(argv).replace(d, 'D')} on the card, f32 (TF32 off, "
              f"compile_run's hold_f32): exit 0 in {wall} s; {attempts}; "
              f"{verify.group(0)}; |cluster - single| {diff} <= {tol} "
              f"({RESUME_REL_TOL} of the loss); merged Chrome trace spans "
              f"{sorted(spans)} [{card}]")

        # what the gate would see of a dropped rank
        dropped = _dropped_rank_loss(argv, CLUSTER_STEPS)
        miss = abs(dropped - single)
        check(miss >= CONTROL_MISS * tol,
              f"a dropped rank's final loss {dropped} lies within "
              f"{CONTROL_MISS} x {tol} of the one-process run's {single}: "
              f"the verify gate is blind")
        print(f"  a dropped rank (rank 0's rows alone in steps 1-"
              f"{CLUSTER_STEPS - 1}, in this process): final loss {dropped} "
              f"against {single}, |diff| {miss} = {miss / tol} x tol; the "
              f"cluster's own |diff| {diff}")

        # world 2 without a kill or a checkpoint: step times and launches
        trace2 = os.path.join(d, "trace2")
        argv2 = ["--processes", "2", "--arch", "vgg-a", "--batch", "64",
                 "--steps", str(CLUSTER_W2_STEPS), "--schedule", "constant",
                 "--run-dir", os.path.join(d, "w2"), "--trace-dir", trace2,
                 "--use-kernel"]
        out2, wall2 = _cli("repro_torch.launch.cluster", argv2, env)
        check("attempts=1" in out2.stdout and "world=2" in out2.stdout,
              f"the world-2 run did not finish in its first attempt:\n"
              f"{out2.stdout[-3000:]}")
        w2 = [_trace_steps(os.path.join(trace2, f"trace_p{r}.jsonl"))
              for r in range(2)]
        check(all(len(w) == CLUSTER_W2_STEPS for w in w2),
              f"world-2 step spans {w2}")
        n_buckets = vgg_buckets(2).n_collectives
        rank_counts = [_trace_launches(os.path.join(trace2,
                                                    f"trace_p{r}.jsonl"))
                       for r in range(2)]
        for r, c in enumerate(rank_counts):
            check(c.get("ring_hop_accum") == n_buckets * CLUSTER_W2_STEPS
                  and c.get("conv2d_nhwc") == 8 * CLUSTER_W2_STEPS,
                  f"rank {r} launched {c}: want ring_hop_accum "
                  f"{n_buckets} and conv2d_nhwc 8 a step")
        med2 = [float(np.median(w[1:])) for w in w2]
        print(f"  world 2 (its own run, {CLUSTER_W2_STEPS} steps, exit 0 in "
              f"{wall2} s): each rank's launches {rank_counts} = "
              f"{CLUSTER_W2_STEPS} steps x ({n_buckets} hops, 8 convs)")
        print(f"  step seconds (step spans, each ending in a device sync; f32): "
              f"world 2 worker 0 {w2[0]}, worker 1 {w2[1]}, medians of "
              f"steps 2-{CLUSTER_W2_STEPS} {med2}; world 1 (the chaos run's "
              f"attempt 1, steps 3-{CLUSTER_STEPS}) {w1}, median of steps "
              f"4-{CLUSTER_STEPS} "
              f"{float(np.median(w1[1:])) if len(w1) > 1 else None} [{card}]")

        # the training CLI, once
        trace3 = os.path.join(d, "trace3")
        argv3 = ["--arch", "vgg-a", "--parallel", "zero1", "--pods", "2",
                 "--comm-backend", "pallas-ring", "--cross-backend",
                 "pallas-ring", "--batch", "64", "--steps",
                 str(TRAIN_CLI_STEPS), "--schedule", "constant",
                 "--ckpt-dir", os.path.join(d, "train"), "--ckpt-every",
                 str(TRAIN_CLI_STEPS), "--trace-dir", trace3, "--use-kernel"]
        out3, wall3 = _cli("repro_torch.launch.train", argv3, env)
        check("final loss" in out3.stdout, f"train CLI:\n{out3.stdout}")
        c3 = _trace_launches(os.path.join(trace3, "trace_p0.jsonl"))
        check(c3.get("conv2d_nhwc") == 8 * TRAIN_CLI_STEPS,
              f"train CLI launches {c3}: want 8 convs a step")
        print(f"  python -m repro_torch.launch.train "
              f"{' '.join(argv3).replace(d, 'D')}: exit 0 in {wall3} s, "
              f"launches {c3} [{card}]")
        return rank_counts[0]
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: the stale-sync and gossip update modes, and comm="auto"
# ---------------------------------------------------------------------------
# Full-width VGG-A at batch 64, G = 4 members on the card, every forward
# conv on the kernel, deterministic cuDNN (the bitwise checks compare two
# runs' gradients).
# (a) stale-sync on pallas-ring: 4 steps, launches per step 8 convs, 14
# reduce-scatters, 14 all-gathers, nothing else.  Then three full-width
# gradients g0, g1, g2 through the update land where the serial optimizer
# lands on [g0, g0, g1]: bitwise, by phase 6 (a)'s argument (the ring's
# mean of G equal rows is the gradient bitwise, and the carry applies those
# bits a step late).  Its first train step is bitwise zero1's from the same
# params and batch (an empty carry applies the step's own reduce).
# (b) gossip (shifts 1, 2, 3, 1 at G = 4): the member-batched pair add
# bitwise its plain version at all 14 bucket shapes, each shift, on G
# distinct random partials, and ``GossipBackend.part_reduce`` on the same
# rows bitwise the pair sum of members p and p - s written out member by
# member; 4 steps, launches per step 8 convs, 14 folds
# (``ring_hop_accum``), 14 all-gathers, no reduce-scatter; the replication
# invariant; the loss history against zero1's on the same batches within
# ZERO1_LOSS_REL_TOL (on a local mesh every member holds the same gradient,
# so the pair mean of equal rows is the group mean: (g + g) * 2 / 4 is g
# exactly, and the histories may agree bitwise).
# (c) the cluster CLI, --parallel stale-sync and --parallel gossip, each 2
# gloo processes on the card, full width, 3 steps, --verify, the two at
# once; the final losses within RESUME_REL_TOL of the one-process run's.
# (d) comm="auto" on the G = 4 local mesh: every (backend, wire format)
# pair's probes and fitted SWlat and BW (device memory traffic of the
# collective kernels on one card, not a link), the chosen plan; 2 steps with
# it bitwise a run given that plan, launching what the plan requires.
MODES_G = 4
MODES_STEPS = 4
MODES_CLI_STEPS = 3
AUTO_STEPS = 2


def _modes_spec(parallel, steps, **kw):
    from repro_torch.api import MeshSpec, RunSpec
    from repro_torch.comm import CommConfig
    if "comm" not in kw and parallel != "gossip":
        kw["comm"] = CommConfig(backend="pallas-ring")
    return RunSpec(arch="vgg-a", batch=64, lr=5e-3, schedule="constant",
                   seed=0, log_every=1, steps=steps, parallel=parallel,
                   mesh=MeshSpec(members_per_device=MODES_G), **kw)


def _raw_grads(run, batch):
    keys = sorted(run.params)
    leaves = [run.params[k].requires_grad_() for k in keys]
    loss = run.loss_fn(run.params, batch)
    return dict(zip(keys, torch.autograd.grad(loss, leaves)))


# each mode's step times over its fit's steps 2-N (synced "step" spans),
# filled by phases 16a and 16b and printed by phase 16
MODE_STEP_MS = {}


def _modes_fit(parallel, tag):
    """``_ckpt_fit`` of ``parallel``'s phase-16 spec with synced spans; its
    median step over steps 2-N goes to ``MODE_STEP_MS``."""
    spans = SyncedSpans()
    out = _ckpt_fit(_modes_spec(parallel, MODES_STEPS), tag, spans=spans)
    MODE_STEP_MS[parallel] = float(np.median(spans.samples["step"][1:])) * 1e3
    return out


def _sum_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase16a(card):
    from repro_torch.optim.dist import (make_distributed_update,
                                        make_stale_sync_update)
    from repro_torch.train import make_train_step
    n_buckets = vgg_buckets(MODES_G).n_collectives
    print(f"phase 16a: full-width VGG-A stale-sync, G = {MODES_G} members "
          f"on the card, pallas-ring, forward convs on the kernel, batch 64, "
          f"deterministic cuDNN, {MODES_STEPS} steps [{card}]")
    run, hist, counts, _ = _modes_fit("stale-sync", "stale-sync")
    want = _per_step(n_buckets, MODES_STEPS)
    check(counts == want, f"stale-sync launches {counts}, want {want}")
    st = run.opt_state
    check(set(st) == {"stale", "synced", "zero1"} and int(st["synced"]) == 1
          and len(st["stale"]) == n_buckets
          and all(s.shape[0] == MODES_G for s in st["stale"]),
          f"stale-sync state {set(st)}")
    print(f"  launches {counts} = {MODES_STEPS} steps x (8 convs, "
          f"{n_buckets} reduce-scatters, {n_buckets} all-gathers); the carry: "
          f"{n_buckets} strips (G, n/G), synced = 1")

    # [g0, g1, g2] through the update against the serial optimizer on
    # [g0, g0, g1]
    grads = [_raw_grads(run, next(run.data)) for _ in range(3)]
    keys = sorted(run.params)
    lr = run.lr_schedule(0)
    with torch.no_grad():
        p0 = {k: v.detach().clone() for k, v in run.params.items()}
        p_st = {k: v.clone() for k, v in p0.items()}
        p_ser = {k: v.clone() for k, v in p0.items()}
        init_fn, upd = make_stale_sync_update(
            run.optimizer, run.mesh, run.mesh.axis_names, run.comm)
        state = init_fn(p_st)
        for t, g in enumerate(grads):
            upd(p_st, g, state, lr, t)
        s_ser = run.optimizer.init(p_ser)
        for g in (grads[0], grads[0], grads[1]):
            run.optimizer.update(g, s_ser, p_ser, lr)
        differ = [k for k in keys if not torch.equal(p_st[k], p_ser[k])]
        worst = max(((p_st[k] - p_ser[k]).norm()
                     / (p_ser[k] - p0[k]).norm().clamp(min=1e-30)).item()
                    for k in keys)
    same = len(keys) - len(differ)
    print(f"  [g0, g1, g2] through stale-sync vs the serial optimizer on "
          f"[g0, g0, g1] (three full-width gradients): {same} of "
          f"{len(keys)} leaves bitwise equal (required: all); worst relative "
          f"L2 of the difference to the updates {worst}")
    check(not differ, f"stale-sync [g0, g1, g2] and serial [g0, g0, g1] "
          f"differ at {differ}")
    del grads, p_st, p_ser, s_ser, state

    # the first train step: stale-sync's bitwise zero1's
    batch = next(run.data)
    out = []
    for make in (make_stale_sync_update, make_distributed_update):
        p = {k: v.clone() for k, v in p0.items()}
        init_fn, upd = make(run.optimizer, run.mesh, run.mesh.axis_names,
                            run.comm)
        step = make_train_step(run.loss_fn, run.optimizer, run.lr_schedule,
                               grad_clip=run.spec.grad_clip,
                               dist_update=upd)
        p, _, m = step(p, init_fn(p), 0, batch)
        out.append(({k: v.detach() for k, v in p.items()}, float(m["loss"])))
    differ = [k for k in keys if not torch.equal(out[0][0][k], out[1][0][k])]
    check(not differ and out[0][1] == out[1][1],
          f"stale-sync's first step differs from zero1's at {differ}")
    print(f"  first train step from the same params and batch: stale-sync "
          f"bitwise zero1 ({len(keys)} leaves, loss {out[0][1]})")
    _drop(run)
    return counts


def phase16b(dev, card):
    from repro_torch.comm.backends.gossip import GossipBackend, shift_of
    from repro_torch.kernels import ring as kring
    from repro_torch.launch.mesh import make_local_mesh
    G = MODES_G
    mesh = make_local_mesh(G, device=dev)
    plan = vgg_buckets(G)
    n_buckets = plan.n_collectives
    shifts = [shift_of(t, G) for t in range(MODES_STEPS)]
    print(f"phase 16b: gossip, G = {G}, shifts {shifts} over steps "
          f"0-{MODES_STEPS - 1}: the pair add (one fold launch a bucket for "
          f"all members) vs plain at VGG-A's {n_buckets} bucket shapes, "
          f"each shift, on {G} distinct random partials, bitwise [{card}]")
    gen = torch.Generator(device=dev).manual_seed(16)
    m = torch.arange(G, device=dev)
    k_ms = p_ms = 0.0
    nbytes = 0
    for b in plan.buckets:
        x = torch.randn(G, b.padded_size, generator=gen, device=dev)
        for s in sorted(set(shifts)):
            recv = x.view(G, G, -1)[(m - s) % G, m]
            got = kring.ring_hop_accum_members(x, recv)
            want = kring.ring_hop_accum_members_plain(x, recv)
            check(torch.equal(got, want), f"pair add at bucket "
                  f"{b.padded_size}, shift {s}: kernel != plain")
            # the backend on the same distinct rows against the pair sum
            # written out member by member: member p's chunk p plus member
            # (p - s)'s, times G / 2
            n = b.padded_size // G
            pair = torch.stack([x[(p - s) % G, p * n:(p + 1) * n]
                                + x[p, p * n:(p + 1) * n] for p in range(G)])
            got = GossipBackend(step=s - 1).part_reduce(x, mesh, "data")
            check(torch.equal(got, pair * (G / 2.0)), f"gossip part_reduce "
                  f"at bucket {b.padded_size}, shift {s} != the pair sum "
                  f"of members p and p - {s}")
            del pair
        k_ms += cuda_ms(lambda: kring.ring_hop_accum_members(x, recv),
                        warmup=2, reps=5)
        p_ms += cuda_ms(lambda: kring.ring_hop_accum_members_plain(x, recv),
                        warmup=2, reps=5)
        nbytes += 3 * recv.numel() * recv.element_size()
        del x, recv, got, want
    print(f"  pair add bitwise its plain version at all {n_buckets} bucket "
          f"shapes x shifts {sorted(set(shifts))}, and GossipBackend."
          f"part_reduce bitwise the member-by-member pair sum of p and p - s "
          f"times G / 2 there; one call a bucket (CUDA "
          f"events, median of 5): kernel {k_ms} ms summed over the buckets, "
          f"plain {p_ms} ms, byte bound {bytes_bound(nbytes)} ms [{card}]")

    run, hist, counts, _ = _modes_fit("gossip", "gossip")
    check(run.comm.backend == "gossip" and not run.comm.hierarchical,
          f"gossip comm {run.comm}")
    want = {"conv2d_nhwc": 8 * MODES_STEPS,
            "ring_hop_accum": n_buckets * MODES_STEPS,
            "ring_all_gather": n_buckets * MODES_STEPS}
    check(counts == want, f"gossip launches {counts}, want {want}")
    # the replication invariant: one more update, every member's gathered
    # buffer the same
    up = run.dist_update.plan
    bplan, sched = up.buckets(run.params), up.schedule(MODES_STEPS)
    grads = _raw_grads(run, next(run.data))
    with torch.no_grad():
        g_strips = up.reduce(sched, bplan, grads)
        new_p, _ = up.apply(sched, bplan, run.params, g_strips, run.opt_state,
                            run.lr_schedule(0))
        for ps in new_p:
            full = sched.broadcast(ps)
            check(all(torch.equal(full[0], full[i]) for i in range(1, G)),
                  "gossip: members' gathered buffers differ")
    losses = [h["loss"] for h in hist]
    _drop(run)
    del grads, g_strips, new_p
    zrun, zhist, _, _ = _modes_fit("zero1", "zero1 (for gossip)")
    _drop(zrun)
    zl = [h["loss"] for h in zhist]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, zl))
    print(f"  launches {counts} = {MODES_STEPS} steps x (8 convs, "
          f"{n_buckets} folds, {n_buckets} all-gathers), no reduce-scatter; "
          f"replication invariant: all {G} rows of each gathered buffer "
          f"bitwise equal; losses {losses} vs zero1 {zl} on the same "
          f"batches, worst relative difference {worst} (tolerance "
          f"{ZERO1_LOSS_REL_TOL})")
    check(worst <= ZERO1_LOSS_REL_TOL, "gossip and zero1 losses differ")
    return counts


def phase16c(card):
    import re
    import shutil
    d = tempfile.mkdtemp(prefix="modes16-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def argv(mode):
        return ["--processes", "2", "--arch", "vgg-a", "--parallel", mode,
                "--batch", "64", "--steps", str(MODES_CLI_STEPS),
                "--schedule", "constant", "--run-dir",
                os.path.join(d, mode), "--use-kernel", "--verify"]
    try:
        modes = ("stale-sync", "gossip")
        with ThreadPoolExecutor(len(modes)) as pool:
            outs = list(pool.map(
                lambda mode: _cli("repro_torch.launch.cluster", argv(mode),
                                  env), modes))
        for mode, (out, wall) in zip(modes, outs):
            for want in ("2 processes over gloo", f"parallel={mode}",
                         "attempts=1", "world=2", "verify:", "OK"):
                check(want in out.stdout, f"{mode}: no {want!r} in:\n"
                      f"{out.stdout[-4000:]}")
            v = re.search(r"\[cluster\] verify: cluster=(\S+) single=(\S+) "
                          r"\|diff\|=(\S+) tol=(\S+)", out.stdout)
            cluster_loss, single = float(v.group(1)), float(v.group(2))
            tol = RESUME_REL_TOL * abs(single)
            diff = abs(cluster_loss - single)
            check(diff <= tol, f"{mode}: cluster final loss {cluster_loss} "
                  f"vs one process {single}: |diff| {diff} > {tol}")
            print(f"phase 16c: python -m repro_torch.launch.cluster "
                  f"{' '.join(argv(mode)).replace(d, 'D')} on the card (the "
                  f"two modes' runs at once): exit 0 in {wall} s; "
                  f"{v.group(0)}; |cluster - single| {diff} <= {tol} "
                  f"({RESUME_REL_TOL} of the loss) [{card}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _auto_want(plan, steps):
    """The launches of ``steps`` steps at the autotuner's plan on the
    G-member local mesh: the convs, and on pallas-ring per collective one
    all-gather and either one reduce-scatter (fp32, bf16) or one quantize
    and G - 1 int8 hops; the lax backend launches no ring kernel."""
    n = plan["n_collectives"] * steps
    want = {"conv2d_nhwc": 8 * steps}
    if plan["chosen_backend"] == "pallas-ring":
        want["ring_all_gather"] = n
        if plan["chosen_wire_format"] == "int8":
            want["int8_quantize"] = n
            want["ring_hop_int8"] = n * (MODES_G - 1)
        else:
            want["ring_reduce_scatter"] = n
    return want


def phase16d(card):
    from repro_torch.api import compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.telemetry import Recorder
    print(f"phase 16d: comm='auto' on the G = {MODES_G} local mesh, "
          f"full-width VGG-A zero1: every probe's time, the fitted SWlat and "
          f"BW, the chosen plan (the fit is of the collective kernels' "
          f"device memory traffic on one card, not of a link) [{card}]")
    rec = Recorder()
    spec = _modes_spec("zero1", AUTO_STEPS, comm="auto")
    t0 = time.perf_counter()
    auto = use_kernel(compile_run(spec, recorder=rec))
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    plan = [e for e in rec.events if e["kind"] == "autotune_plan"]
    check(len(plan) == 1, f"autotune plan events {plan}")
    plan = plan[0]
    probes = [e for e in rec.events if e["kind"] == "collective"]
    for pair, (lat, bw, pred) in sorted(plan["fits"].items()):
        print(f"  fit {pair}: SWlat {lat} s, BW {bw} B/s of gradient bytes, "
              f"predicted wire time a step at its own bucket {pred} s "
              f"({plan['measured']}) [{card}]")
    print(f"  fitted SWlat {plan['sw_latency_s']} s, BW "
          f"{plan['link_bw_Bps']} B/s ({plan['measured']}); chosen "
          f"bucket_bytes {plan['bucket_bytes']} ({plan['n_collectives']} "
          f"collectives), backend {plan['chosen_backend']}, wire format "
          f"{plan['chosen_wire_format']}, predicted wire time "
          f"{plan['predicted_s']} s; {len(probes)} timed probes; "
          f"compile_run with the autotuner {tune_s} s [{card}]")
    check(auto.comm.bucket_bytes == plan["bucket_bytes"]
          and auto.comm.backend == plan["chosen_backend"]
          and auto.comm.wire_format == plan["chosen_wire_format"],
          f"run comm {auto.comm} is not the plan {plan}")
    torch.cuda.synchronize()
    _counts_zeroed()
    with deadline(CKPT_DEADLINE_S):
        ha = auto.fit(log_fn=lambda line: print(f"    auto: {line}"))
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts().items() if v}
    want = _auto_want(plan, AUTO_STEPS)
    check(counts == want, f"comm='auto' launches {counts}, want {want} for "
          f"the plan {plan}")
    pa = {k: v.detach().cpu() for k, v in auto.params.items()}
    comm = auto.comm
    _drop(auto)
    fixed, hf, _, _ = _ckpt_fit(spec.replace(comm=comm), "fixed")
    pf = {k: v.detach().cpu() for k, v in fixed.params.items()}
    _drop(fixed)
    differ = [k for k in pa if not torch.equal(pa[k], pf[k])]
    la, lf = [h["loss"] for h in ha], [h["loss"] for h in hf]
    check(not differ and la == lf, f"comm='auto' run vs fixed-comm run: "
          f"losses {la} vs {lf}, params differ at {differ}")
    print(f"  {AUTO_STEPS} steps with the plan: losses {la}, bitwise the "
          f"fixed-comm run at that plan (params, all {len(pa)} leaves); "
          f"launches {counts}, as the plan's backend, wire format and "
          f"{plan['n_collectives']} collectives a step require")
    return counts


def phase16(dev, card):
    """Phase 16's four parts; the launches of the modes' fits (a, b, d)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    walls = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        gc.collect()
        torch.cuda.empty_cache()
        return out
    try:
        a = part("16a", phase16a, card)
        b = part("16b", phase16b, dev, card)
        part("16c", phase16c, card)
        d = part("16d", phase16d, card)
    finally:
        torch.backends.cudnn.deterministic = False
    modes = _sum_counts(a, b, d)
    print(f"  phase 16 wall seconds by part {walls}; the modes' fits "
          f"launched {modes}")
    print(f"  median step over steps 2-{MODES_STEPS} (synced spans, batch "
          f"64, G = {MODES_G}): " + ", ".join(
              f"{m} {ms} ms" for m, ms in MODE_STEP_MS.items())
          + f"; stale-sync / zero1 "
          f"{MODE_STEP_MS['stale-sync'] / MODE_STEP_MS['zero1']} [{card}]")
    return modes


# ---------------------------------------------------------------------------
# phase 17: the MoE family, h2o-danube's head_dim 120 and dense decode
# ---------------------------------------------------------------------------
# (a), (b): one decode step on the same live state through the kernel and
# through its plain gather version.  The kernel is within one bf16 ulp of
# the plain version per call (phase 1), at some of its outputs, and 24
# layers carry those ulps into the logits.  So the run measures the logits'
# one-ulp sensitivity on that state, the gather route with every attention
# output moved by one ulp (scaled by 1 + 2^-8) against the gather route,
# and holds the kernel route to PARITY_SENSITIVITY_FACTOR times it, never
# tighter than phase 2's REL_L2_TOL.  A router choice within a near-tie can
# flip under either change and move that slot's logits by far more than
# rounding, so both the kernel run and the one-ulp run take the gather
# run's router choices; the unpinned kernel run's flips (slot x layer) are
# counted and printed.
# (d): the kernel route against the plain route, as phase 13 holds it, with
# the kernel route's router choices pinned to the plain route's (its own
# probabilities, weights and aux loss): a flipped choice reroutes a token
# and moves every gradient leaf by ~1/sqrt(tokens), which says nothing of
# the kernel; the flips of the unpinned kernel route are counted beside.
MOE_PARAMS = 14_004_422_656        # qwen2-moe-a2.7b, 24 layers
H2O_PARAMS = 3_961_839_360         # h2o-danube-3-4b
GEMMA_PARAMS = 2_506_172_416       # gemma-2b
MOE_TRAIN_LAYERS = 2               # of qwen2-moe's 24, with AdamW state
MOE_TRAIN_PARAMS = 1_452_271_616
MOE_TRAIN_STEPS = 4
DECODE_NEW = 32
PARITY_SENSITIVITY_FACTOR = 2.0


def _serve_spec(arch):
    from repro_torch.api import ServeSpec
    return ServeSpec(arch=arch, smoke=False, max_batch=4, page_size=16,
                     num_pages=160, max_prompt=512,
                     max_new_tokens=DECODE_NEW, attn_impl="kernel")


def _moe_train_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-moe-a2.7b").replace(
        num_layers=MOE_TRAIN_LAYERS, pattern_repeats=MOE_TRAIN_LAYERS)


@contextmanager
def routes_recorded():
    """Every MoE router call's top-k indices and its k-th vs (k+1)-th
    probability margins, as host tensors, in call order."""
    from repro_torch.models import moe
    real, seen = moe._top_k, []

    def spy(probs, k):
        idx = real(probs, k)
        srt = torch.sort(probs.detach(), -1, descending=True).values
        seen.append((idx.cpu(), (srt[..., k - 1] - srt[..., k]).cpu()))
        return idx

    moe._top_k = spy
    try:
        yield seen
    finally:
        moe._top_k = real


@contextmanager
def routes_pinned(choices):
    """Every MoE router call takes its top-k indices from ``choices`` (a
    :func:`routes_recorded` list) in call order."""
    from repro_torch.models import moe
    real, it = moe._top_k, iter(choices)
    moe._top_k = lambda probs, k: next(it)[0].to(probs.device)
    try:
        yield
    finally:
        moe._top_k = real


@contextmanager
def flash_shapes_recorded(seen, tag):
    """Adds ``tag`` to ``seen[shape]`` for every call of
    ``kernels.flash_attention.attention`` (the LM blocks' kernel route),
    ``shape`` being (dtype, B, Sq, Skv, Hq, Hkv, D, causal, window,
    softcap) of the tensors it was handed."""
    from repro_torch.kernels import flash_attention as kflash
    real = kflash.attention

    def spy(q, k, v, causal=True, window=0, logit_softcap=0.0):
        B, Sq, Hq, D = q.shape
        seen.setdefault((q.dtype, B, Sq, k.shape[1], Hq, k.shape[2], D,
                         causal, window, float(logit_softcap)),
                        set()).add(tag)
        return real(q, k, v, causal, window, logit_softcap)

    kflash.attention = spy
    try:
        yield seen
    finally:
        kflash.attention = real


def route_flips(a, b):
    """(choices that differ between two recordings, counted per token and
    layer; the largest margin among them in either recording)."""
    n, worst = 0, 0.0
    for (ia, ma), (ib, mb) in zip(a, b):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        n += int(diff.sum())
        if diff.any():
            worst = max(worst, ma[diff].max().item(), mb[diff].max().item())
    return n, worst


def step_profile(fn, tag, card):
    """Where one call of ``fn`` spends its time: its wall time (CUDA events
    around it, median of 5 after 2 warm-ups), the card's busy time (the
    summed durations of the kernels and memory operations it ran, from
    ``torch.profiler``; one stream, so they do not overlap), how many it
    ran, and the five kernels that took the most, summed by name."""
    from torch.profiler import ProfilerActivity, profile
    wall = cuda_ms(fn, 2, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {tag}: {wall} ms a call; the card busy {busy} ms of it "
          f"({n} kernels and copies; idle share {1 - busy / wall}); the most "
          f"time: " + "; ".join(f"{name[:90]} {ms} ms" for name, ms in top)
          + f" [{card}]")
    return wall, busy


def _serve_full(card, arch, want_params, n_req, tag):
    """``compile_serve`` at full width and depth, a warm-up request, then
    ``n_req`` requests of 2-512 prompt tokens drained with every count
    zeroed just before and read just after.  Returns (server, the paged
    kernel's launches)."""
    from repro_torch.api import compile_serve
    spec = _serve_spec(arch)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    server = compile_serve(spec, recorder=spans)
    torch.cuda.synchronize()
    cfg = server.cfg
    n_params = sum(w.numel() for w in _leaves(server.params))
    check(n_params == want_params, f"{n_params} params, want {want_params}")
    print(f"phase 17{tag}: {cfg.name} at full width and depth "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}, window {cfg.sliding_window}, experts "
          f"{cfg.num_experts} top-{cfg.num_experts_per_tok} + "
          f"{cfg.num_shared_experts} shared), {n_params} f32 params from "
          f"seed {spec.seed} on {server.device} in "
          f"{time.perf_counter() - t0:.2f} s")
    server.submit(np.arange(1, 33), 2)
    server.drain()
    spans.reset()
    server.reset_latency_stats()

    rng = np.random.default_rng(0)
    lengths = rng.integers(2, spec.max_prompt + 1, size=n_req)
    for L in lengths:
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    steps0 = server.stats["steps"]
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    steps = server.stats["steps"] - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(done) == n_req, f"{len(done)} of {n_req} requests completed")
    for r in done:
        check(len(r.tokens) == spec.max_new_tokens,
              f"request {r.rid} returned {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} returned a token outside the vocabulary")
    want = dict.fromkeys(counts, 0)
    want["paged_decode_attention"] = steps * cfg.num_layers
    check(steps > 0 and counts == want, f"launches {counts} in {steps} "
          f"decode steps, want {want}")
    pre_s, dec_s = spans.seconds["prefill"], spans.seconds["decode"]
    n_pre = int(lengths.sum())
    n_dec = sum(len(r.tokens) - 1 for r in done)
    lat = server.latency_stats()
    print(f"  served {n_req} requests ({n_pre} prompt tokens, {n_dec} "
          f"decoded) in {wall} s; {steps} decode steps, paged_decode_attention "
          f"{counts['paged_decode_attention']} = steps x {cfg.num_layers}, "
          f"every other kernel 0")
    print(f"  prefill {n_pre / pre_s} tok/s over {pre_s} s; decode "
          f"{n_dec / dec_s} tok/s over {dec_s} s; decode step median "
          f"{np.median(spans.samples['decode']) * 1e3} ms; TTFT p50 "
          f"{lat['ttft_p50_s']} s p99 {lat['ttft_p99_s']} s; end to end p50 "
          f"{lat['e2e_p50_s']} s p99 {lat['e2e_p99_s']} s; peak memory "
          f"{peak_gb} GB [{card}]")
    return server, counts["paged_decode_attention"]


def _decode_parity(server, card, tag):
    """One decode step on a live state of 4 fresh requests: kernel against
    gather, beside the logits' one-ulp sensitivity (see above).  Both the
    kernel run and the one-ulp run take the gather run's router choices
    (``routes_pinned``), so that the gate reads the attention's rounding
    and not a near-tied expert choice that the rounding flips; the
    unpinned kernel run's flips are counted and printed beside it."""
    from repro_torch.kernels import paged_attn
    cfg = server.cfg
    rng = np.random.default_rng(1)
    for L in rng.integers(2, server.spec.max_prompt + 1, size=4):
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    server.step()
    with routes_recorded() as r_ref:
        ref = server.decode_logits("gather").float()
    with routes_recorded() as r_free:
        free = server.decode_logits("kernel").float()
    with routes_pinned(r_ref):
        got = server.decode_logits("kernel").float()
    plain = paged_attn.paged_decode_attention_plain

    def shifted(*args, **kw):
        out = plain(*args, **kw)
        return (out.float() * (1 + 2.0 ** -8)).to(out.dtype)

    paged_attn.paged_decode_attention_plain = shifted
    try:
        with routes_pinned(r_ref):
            moved = server.decode_logits("gather").float()
    finally:
        paged_attn.paged_decode_attention_plain = plain
    check(tuple(got.shape) == (4, cfg.vocab_size), f"logits {got.shape}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()
               and torch.isfinite(free).all()), "non-finite logits")
    delta = (got - ref).abs().max().item()
    rel = ((got - ref).norm() / ref.norm()).item()
    rel_free = ((free - ref).norm() / ref.norm()).item()
    sens = ((moved - ref).norm() / ref.norm()).item()
    tol = max(REL_L2_TOL, PARITY_SENSITIVITY_FACTOR * sens)
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * delta
    same = (got.argmax(-1) == ref.argmax(-1)) | ~decided
    flips, flip_margin = route_flips(r_ref, r_free)
    print(f"  one decode step at lengths {(server._lengths + 1).tolist()}, "
          f"kernel vs gather on the same state, the kernel's router choices "
          f"pinned to the gather's: max|dlogit| {delta}, relative L2 {rel}; "
          f"gather with every attention output moved one ulp, choices "
          f"pinned, vs gather: relative L2 {sens}; tolerance "
          f"max({REL_L2_TOL}, {PARITY_SENSITIVITY_FACTOR} x {sens}) = {tol}; "
          f"greedy tokens agree wherever the top-2 margin exceeds 2 "
          f"max|dlogit| ({int(decided.sum())} of 4 decided): "
          f"{bool(same.all())}; unpinned, the kernel's router choices (slot x "
          f"layer) differ from the gather's at {flips} of "
          f"{4 * len(r_ref)} (largest k-th vs (k+1)-th margin among them "
          f"{flip_margin}) and its logits' relative L2 is {rel_free} "
          f"(printed, not gated) [{card}]")
    check(rel <= tol, f"{tag}: kernel and gather decode logits disagree")
    check(bool(same.all()), f"{tag}: greedy token differs at a decided step")
    step_profile(lambda: server.decode_logits("kernel"),
                 f"one decode step of the 4 slots (kernel) at these lengths",
                 card)


def phase17a(card):
    server, launches = _serve_full(card, "qwen2-moe-a2.7b", MOE_PARAMS, 8,
                                   "a")

    def cast_all():
        for w in _leaves(server.params):
            w.to(torch.bfloat16)

    print(f"  casting every weight f32 -> bf16 once: "
          f"{cuda_ms(cast_all, 2, 5)} ms [{card}]")
    _decode_parity(server, card, "17a")
    from repro_torch.models import transformer
    toks = torch.randint(1, server.cfg.vocab_size, (1, 256),
                         device=server.device)
    with torch.no_grad():
        step_profile(lambda: transformer.forward(server.params, server.cfg,
                                                 tokens=toks),
                     "one prefill forward of 256 tokens (B 1, no cache)",
                     card)
    return launches


def phase17b(card):
    server, launches = _serve_full(card, "h2o-danube-3-4b", H2O_PARAMS, 4,
                                   "b")
    _decode_parity(server, card, "17b")
    return launches


def phase17c(card):
    """gemma-2b through ``serve.decode.generate`` (greedy, one prompt a call:
    the ring buffer holds one batch of equal lengths) against a
    ``compile_serve`` drain of the same prompts on the same params."""
    from repro_torch.api import compile_serve
    from repro_torch.api import serve as api_serve
    from repro_torch.serve import decode
    server = compile_serve(_serve_spec("gemma-2b"))
    params, cfg = server.params, server.cfg
    n_params = sum(w.numel() for w in _leaves(params))
    check(n_params == GEMMA_PARAMS, f"{n_params} params, want {GEMMA_PARAMS}")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(L))
               for L in rng.integers(64, 201, size=4)]
    decode.generate(params, cfg, NO_MESH, prompts[0][None], 2)  # warm-up

    rec = []
    real_pre, real_step = decode.prefill, decode.decode_step

    def pre(*args, **kw):
        lg, c = real_pre(*args, **kw)
        rec.append(lg.float())
        return lg, c

    def step(*args, **kw):
        lg, c = real_step(*args, **kw)
        rec.append(lg.float())
        return lg, c

    gen_tok, gen_log = [], []
    decode.prefill, decode.decode_step = pre, step
    _counts_zeroed()
    t0 = time.perf_counter()
    try:
        for p in prompts:
            rec.clear()
            out = decode.generate(params, cfg, NO_MESH, p[None],
                                  DECODE_NEW)
            check(tuple(out.shape) == (1, DECODE_NEW), f"tokens {out.shape}")
            gen_tok.append(out[0].cpu().numpy())
            gen_log.append(torch.cat(rec))
        torch.cuda.synchronize()
    finally:
        decode.prefill, decode.decode_step = real_pre, real_step
    wall = time.perf_counter() - t0
    counts = _counts()
    check(not any(counts.values()), f"generate launched {counts}")
    for t in gen_tok:
        check(all(0 <= x < cfg.vocab_size for x in t), "token outside the "
              "vocabulary")
    # one decode step's time against a prompt's ring (the same position
    # again each call: the write lands in the same slot)
    p = torch.as_tensor(prompts[0][None], device=server.device)
    lg, caches = decode.prefill(params, cfg, NO_MESH, p,
                                p.shape[1] + DECODE_NEW)
    tok = lg.argmax(-1)[:, None]
    step_ms, _ = step_profile(
        lambda: decode.decode_step(params, cfg, NO_MESH, tok, p.shape[1],
                                   caches),
        f"one ring-buffer decode step (B 1, {p.shape[1]} cached)", card)
    del caches

    srec = []
    real_sample = api_serve._sample

    def sample(logits, temperature, gen):
        srec.append(logits.float().clone())
        return real_sample(logits, temperature, gen)

    for q in prompts:
        server.submit(q, DECODE_NEW)
    api_serve._sample = sample
    try:
        done = {r.rid: r for r in server.drain()}
    finally:
        api_serve._sample = real_sample
    check(sorted(done) == [0, 1, 2, 3] and server.stats["preemptions"] == 0,
          f"drain {sorted(done)}, {server.stats}")
    compared, deltas = 0, []
    for r in range(4):
        # request r sat in slot r: its prefill sample, then row r of every
        # decode step's
        srv_log = torch.stack([srec[r][0]] + [s[r] for s in srec[4:]])
        srv_tok = done[r].output
        for i in range(DECODE_NEW):
            d = (gen_log[r][i] - srv_log[i]).abs().max().item()
            deltas.append(d)
            if gen_tok[r][i] != srv_tok[i]:
                top2 = srv_log[i].topk(2).values
                margin = (top2[0] - top2[1]).item()
                print(f"  request {r} parts at token {i}: top-2 margin "
                      f"{margin}, max|dlogit| {d}")
                check(margin <= 2 * d, f"request {r}: generate and the "
                      f"server part at decided token {i}")
                break
            compared += 1
    print(f"phase 17c: {cfg.name} at full width and depth ({n_params} f32 "
          f"params, {cfg.num_heads} q / {cfg.num_kv_heads} kv head of "
          f"{cfg.head_dim}) through serve.decode.generate: 4 prompts of "
          f"{[len(q) for q in prompts]} tokens, {DECODE_NEW} new each, in "
          f"{wall} s; launches: none (ring-buffer decode is the plain "
          f"decode_attention_ref); one decode step {step_ms} ms (B 1); "
          f"tokens equal to a compile_serve drain (paged kernel) for "
          f"{compared} of {4 * DECODE_NEW}, every parting at a margin within "
          f"2 max|dlogit|; max|dlogit| generate vs server before parting "
          f"{max(deltas)} [{card}]")


def phase17d(card):
    """qwen2-moe-a2.7b at full width, 2 of its 24 layers, through
    ``compile_run`` and ``Run.fit`` on the flash kernel."""
    from repro_torch.api import RunSpec, compile_run
    from repro_torch.core.params import tree_leaves
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_train_cfg()
    spec = RunSpec(arch=cfg, steps=MOE_TRAIN_STEPS, batch=LM_BATCH,
                   seq=LM_SEQ, seed=0, log_every=1)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(run.params))
    check(n_params == MOE_TRAIN_PARAMS,
          f"{n_params} params, want {MOE_TRAIN_PARAMS}")
    print(f"phase 17d: {cfg.name} at full width, {cfg.num_layers} of 24 "
          f"layers ({cfg.num_experts} experts top-{cfg.num_experts_per_tok} "
          f"+ {cfg.num_shared_experts} shared, capacity factor "
          f"{cfg.moe_capacity_factor}), {n_params} f32 params and AdamW "
          f"state on {run.device} in {time.perf_counter() - t0:.2f} s; "
          f"{spec.steps} steps of {spec.batch} x {spec.seq} tokens, every "
          f"attention forward on the kernel")
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"history {hist}")
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = spec.steps * cfg.num_layers
    check(counts == want, f"launches {counts}, want {want}")
    batch = next(run.data)
    with torch.no_grad():
        aux = transformer.forward(run.params, cfg,
                                  tokens=batch["tokens"])[1].item()
    check(np.isfinite(aux) and aux > 0, f"aux loss {aux}")
    steps = spans.samples["step"]
    print(f"  {spec.steps} steps in {wall} s; flash_attention "
          f"{counts['flash_attention']} = {spec.steps} x {cfg.num_layers}, "
          f"every other kernel 0; step median over steps 2-{spec.steps} "
          f"{np.median(steps[1:]) * 1e3} ms; aux loss (x "
          f"{cfg.router_aux_loss_coef}, summed over layers) on the next "
          f"batch {aux}; peak memory {peak_gb} GB [{card}]")
    run.close()
    run.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()

    leaves = tree_leaves(run.params)
    names = list(_leaf_names(run.params))

    def loss_and_grads(uk):
        loss = transformer.lm_loss(run.params, cfg, NO_MESH, batch,
                                   use_kernel=uk)
        return loss.item(), torch.autograd.grad(loss, leaves)

    def rel_l2(ga, gb):
        return [((a - b).norm() / b.norm()).item() for a, b in zip(ga, gb)]

    with routes_recorded() as plain_routes:
        lp, gp = loss_and_grads(False)
    with torch.no_grad(), routes_recorded() as kernel_routes:
        transformer.lm_loss(run.params, cfg, NO_MESH, batch, use_kernel=True)
    flips, flip_margin = route_flips(plain_routes, kernel_routes)
    with routes_pinned(plain_routes):
        lk, gk = loss_and_grads(True)
    rel = rel_l2(gk, gp)
    with torch.no_grad():
        for p in leaves:
            p.mul_(1 + 2.0 ** -23)
    with routes_pinned(plain_routes):
        _, gu = loss_and_grads(False)
    floor = rel_l2(gu, gp)
    check(np.isfinite(lk) and np.isfinite(lp), "non-finite parity loss")
    loss_rel = abs(lk - lp) / abs(lp)
    tol = max(LM_GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * max(floor))
    worst = int(np.argmax(rel))
    n_choices = sum(r[0].numel() // r[0].shape[-1] for r in plain_routes)
    print(f"  kernel vs plain route, one forward and backward on the params "
          f"after the run and its next batch, the kernel route's router "
          f"choices pinned to the plain route's: loss {lk} vs {lp} "
          f"(relative {loss_rel}, tolerance {LM_LOSS_REL_TOL}); worst leaf's "
          f"gradient relative L2 {rel[worst]} at {names[worst]}; the plain "
          f"route with every weight scaled by 1 + 2^-23: worst {max(floor)}; "
          f"tolerance max({LM_GRAD_REL_L2_TOL}, {SENSITIVITY_FACTOR} x "
          f"sensitivity) = {tol}; unpinned, the kernel route's router "
          f"choices differ from the plain route's at {flips} of {n_choices} "
          f"(token x layer; largest margin among them {flip_margin}) [{card}]")
    check(loss_rel <= LM_LOSS_REL_TOL, "kernel and plain route losses differ")
    check(max(rel) <= tol, "kernel and plain route gradients differ")
    run.params = None
    return counts["flash_attention"]


def phase17(card):
    """Phase 17's four parts, each model freed before the next; the paged
    kernel's launches (a, b) and the flash kernel's (d)."""
    print(f"phase 17: {torch.cuda.memory_allocated() / 1e9} GB still "
          f"allocated from earlier phases")
    walls = {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn(card)
        walls[name] = round(time.perf_counter() - t0, 1)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    paged = part("17a", phase17a) + part("17b", phase17b)
    part("17c", phase17c)
    flash = part("17d", phase17d)
    print(f"  phase 17 wall seconds by part {walls}; paged_decode_attention "
          f"{paged} launches, flash_attention {flash}")
    return paged, flash


# ---------------------------------------------------------------------------
# phase 18: the SSM, hybrid, vision and audio families at full width
# ---------------------------------------------------------------------------
# Each model at its published widths with random f32 weights from seed 0,
# trained through compile_run and Run.fit with AdamW and every attention
# forward on the flash kernel, then freed before the next.  The kernel
# route is held to the plain route from the same params and batch as phase
# 13 holds gemma2-2b (10x the network's measured one-ulp sensitivity, never
# under LM_GRAD_REL_L2_TOL); prefill(S) + decode(1) to the full forward at
# position S within the reference's test_arch_decode_consistency tolerance
# on f32 activations, and within 10x the logits' one-ulp sensitivity on
# bf16 ones (``_decode_consistency``).
FAMILY_SEQ = 1024
FAMILY_STEPS = 3
XLSTM_STEPS = 2
ZAMBA_PARAMS = 1_981_756_080
ZAMBA_BATCH = 2
QWEN_VL_PARAMS = 1_543_656_960
MUSICGEN_PARAMS = 1_377_977_856
XLSTM_PARAMS = 123_684_144
GEN_PROMPT, GEN_NEW = 128, 32
DECODE_RTOL = DECODE_ATOL = 0.05


def _family_run(arch, batch, seq, steps, want_params, card, tag):
    """``compile_run`` at full width on the kernel route, its fit with every
    count zeroed just before and read just after; prints its numbers and
    returns (run, counts, init copies of the named leaves)."""
    from repro_torch.api import RunSpec, compile_run
    from repro_torch.core.params import tree_leaves
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models.transformer import ATTN_KINDS
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = RunSpec(arch=arch, steps=steps, batch=batch, seq=seq, seed=0,
                   log_every=1)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    cfg = run.cfg
    n_params = sum(p.numel() for p in tree_leaves(run.params))
    check(n_params == want_params, f"{arch}: {n_params} params, want "
          f"{want_params}")
    print(f"phase 18{tag}: {cfg.name} at full width and depth "
          f"({cfg.num_layers} blocks {cfg.block_pattern} x "
          f"{cfg.pattern_repeats}, d_model {cfg.d_model}, "
          f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}), {n_params} f32 params "
          f"and AdamW state on {run.device} in "
          f"{time.perf_counter() - t0:.2f} s; {steps} steps of batch "
          f"{batch} x {seq} positions, every attention forward on the kernel")
    keep = {k: run.params[k].detach().clone() for k in ("embed", "lm_head")
            if cfg.frontend == "audio" and k in run.params}
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"{arch}: history {hist}")
    n_attn = sum(k in ATTN_KINDS for k in cfg.block_pattern) \
        * cfg.pattern_repeats
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = steps * n_attn
    check(counts == want, f"{arch}: launches {counts}, want {want}")
    step_s = spans.samples["step"]
    tokens = batch * seq
    print(f"  {steps} steps in {wall} s; flash_attention "
          f"{counts['flash_attention']} = {steps} x {n_attn}, every other "
          f"kernel 0; step median over steps 2-{steps} "
          f"{np.median(step_s[1:]) * 1e3} ms ({tokens / np.median(step_s[1:])}"
          f" positions/s of step time), first step {step_s[0] * 1e3} ms, "
          f"data_wait median {np.median(spans.samples['data_wait'][1:]) * 1e3}"
          f" ms; peak memory {peak_gb} GB [{card}]")
    return run, counts, keep, hist


def _step_split(run, batch, card):
    """One step's forward, backward and update by CUDA events (median of
    3), and the card's idle share of one step (``torch.profiler``)."""
    from repro_torch.core.params import tree_leaves
    leaves = tree_leaves(run.params)
    split = {"forward": [], "backward": [], "step": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        ev[2].record()
        del loss, grads
        run.step(batch, step_idx=run.spec.steps)
        ev[3].record()
        ev[3].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["step"].append(ev[2].elapsed_time(ev[3]))
    fwd, bwd, step = (float(np.median(split[k]))
                      for k in ("forward", "backward", "step"))
    print(f"  one step by CUDA events: train_step {step} ms; forward alone "
          f"{fwd} ms, backward alone {bwd} ms, so norm, clip and AdamW about "
          f"{step - fwd - bwd} ms [{card}]")
    wall, busy = step_profile(lambda: run.step(batch,
                                               step_idx=run.spec.steps),
                              "one train_step", card)
    return fwd, bwd, step, wall, busy


def _route_gate(run, batch, card, tag):
    """Phase 13's kernel-vs-plain gate on the run's params and ``batch``,
    with the optimizer state freed first; the plain route's gradients wait
    in host memory."""
    from repro_torch.core.params import tree_leaves
    from repro_torch.models import transformer
    run.close()
    run.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    cfg = run.cfg
    leaves = tree_leaves(run.params)
    names = list(_leaf_names(run.params))

    def loss_and_grads(uk):
        loss = transformer.lm_loss(run.params, cfg, NO_MESH, batch,
                                   use_kernel=uk)
        return loss.item(), torch.autograd.grad(loss, leaves,
                                                materialize_grads=True)

    def rel_l2(ga, gb_host):
        out = []
        for a, b in zip(ga, gb_host):
            nb = b.norm().item()
            out.append(0.0 if nb == 0 and a.norm().item() == 0 else
                       ((a - b.to(a.device)).norm() / nb).item())
        return out

    lp, gp = loss_and_grads(False)
    gp = [g.cpu() for g in gp]
    lk, gk = loss_and_grads(True)
    rel = rel_l2(gk, gp)
    del gk
    with torch.no_grad():
        scaled = [p.clone() for p in leaves]
        for p in leaves:
            p.mul_(1 + 2.0 ** -23)
    _, gu = loss_and_grads(False)
    floor = rel_l2(gu, gp)
    with torch.no_grad():              # the params as they were
        for p, q in zip(leaves, scaled):
            p.copy_(q)
    del gu, gp, scaled
    check(np.isfinite(lk) and np.isfinite(lp), f"{tag}: non-finite loss")
    loss_rel = abs(lk - lp) / abs(lp)
    tol = max(LM_GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * max(floor))
    worst = int(np.argmax(rel))
    print(f"  kernel vs plain route, one forward and backward on the params "
          f"after the run and its next batch: loss {lk} vs {lp} (relative "
          f"{loss_rel}, tolerance {LM_LOSS_REL_TOL}); worst leaf's gradient "
          f"relative L2 {rel[worst]} at {names[worst]}; the plain route with "
          f"every weight scaled by 1 + 2^-23: worst {max(floor)} at "
          f"{names[int(np.argmax(floor))]}; tolerance max({LM_GRAD_REL_L2_TOL}, "
          f"{SENSITIVITY_FACTOR} x sensitivity) = {tol} [{card}]")
    check(loss_rel <= LM_LOSS_REL_TOL, f"{tag}: kernel and plain route "
          "losses differ")
    check(max(rel) <= tol, f"{tag}: kernel and plain route gradients differ")


def _decode_consistency(params, cfg, gen, card, tag):
    """prefill(S) + decode(1) logits against the full forward's at position
    S, for 2 prompts of GEN_PROMPT tokens.  On f32 activations and caches
    (``transformer.ACTIVATION_DTYPE`` and the caches' type set to f32)
    within the reference's tolerance (rtol = atol = DECODE_RTOL): that
    shows the arithmetic.  With bf16 activations, as the model runs, the
    two orders of the same sums round apart at many places over the
    blocks, so the bf16 check is held, as phase 13 holds its routes, to
    SENSITIVITY_FACTOR times the logits' measured one-ulp sensitivity (the
    full forward with every weight scaled by 1 + 2^-23), never under the
    reference's atol."""
    import functools

    from repro_torch.core.params import tree_leaves
    from repro_torch.models import transformer
    from repro_torch.serve import decode
    toks = torch.randint(1, cfg.vocab_size, (2, GEN_PROMPT + 1),
                         generator=gen, device=gen.device)

    def full_logits():
        with torch.no_grad():
            return transformer.forward(params, cfg,
                                       tokens=toks)[0][:, -1].float()

    def decode_logits():
        with torch.no_grad():
            _, caches = decode.prefill(params, cfg, NO_MESH, toks[:, :-1],
                                       GEN_PROMPT + GEN_NEW)
            return decode.decode_step(params, cfg, NO_MESH, toks[:, -1:],
                                      GEN_PROMPT, caches)[0].float()

    def worst(dec, full, atol):
        """max of |dec - full| / (atol + rtol |full|): <= 1 passes."""
        return ((dec - full).abs() / (atol + DECODE_RTOL * full.abs())) \
            .max().item()

    real_dtype, real_init = transformer.ACTIVATION_DTYPE, \
        transformer.init_caches
    transformer.ACTIVATION_DTYPE = torch.float32
    transformer.init_caches = functools.partial(real_init,
                                                dtype=torch.float32)
    try:
        full32, dec32 = full_logits(), decode_logits()
    finally:
        transformer.ACTIVATION_DTYPE = real_dtype
        transformer.init_caches = real_init
    full, dec = full_logits(), decode_logits()
    with torch.no_grad():          # then back, within an ulp
        for w in tree_leaves(params):
            w.mul_(1 + 2.0 ** -23)
        moved = full_logits()
        for w in tree_leaves(params):
            w.div_(1 + 2.0 ** -23)
    sens = (moved - full).abs().max().item()
    atol = max(DECODE_ATOL, SENSITIVITY_FACTOR * sens)
    r32, r16 = worst(dec32, full32, DECODE_ATOL), worst(dec, full, atol)
    print(f"  prefill({GEN_PROMPT}) + decode(1) vs the full forward at "
          f"position {GEN_PROMPT}: on f32 activations and caches max|dlogit| "
          f"{(dec32 - full32).abs().max().item()} (logits up to "
          f"{full32.abs().max().item()}), error / tolerance {r32} at rtol = "
          f"atol = {DECODE_RTOL}; on bf16 activations max|dlogit| "
          f"{(dec - full).abs().max().item()}, the full forward with every "
          f"weight x (1 + 2^-23) moves the logits by up to {sens}, so atol "
          f"max({DECODE_ATOL}, {SENSITIVITY_FACTOR} x {sens}) = {atol}, "
          f"rtol {DECODE_RTOL}: error / tolerance {r16} [{card}]")
    check(r32 <= 1.0, f"{tag}: prefill + decode disagree with the full "
          "forward on f32 activations")
    check(r16 <= 1.0, f"{tag}: prefill + decode disagree with the full "
          "forward on bf16 activations")


def _generate(params, cfg, gen, new, card, tag):
    """Greedy ``generate`` of 2 prompts of GEN_PROMPT tokens; no kernel
    launches (the ring buffer's plain attention)."""
    from repro_torch.serve import decode
    prompt = torch.randint(1, cfg.vocab_size, (2, GEN_PROMPT),
                           generator=gen, device=gen.device)
    decode.generate(params, cfg, NO_MESH, prompt, 2)   # warm-up
    torch.cuda.synchronize()
    _counts_zeroed()
    t0 = time.perf_counter()
    out = decode.generate(params, cfg, NO_MESH, prompt, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    check(tuple(out.shape) == (2, new), f"{tag}: tokens {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{tag}: a token outside the vocabulary")
    check(not any(counts.values()), f"{tag}: generate launched {counts}")
    print(f"  generate: 2 prompts of {GEN_PROMPT} tokens, {new} new each, "
          f"greedy, in {wall} s ({2 * new / wall} tokens/s, a decode step "
          f"~{wall / new * 1e3} ms with the prefill); no kernel launches "
          f"[{card}]")


class _Mark(torch.autograd.Function):
    """Identity whose backward records a CUDA event: placed on a block's
    output it marks where the block's backward starts, on its input where
    it ends."""

    @staticmethod
    def forward(ctx, ev, x):
        ctx.ev = ev
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.ev.record()
        return None, g


def _block_shares(run, batch):
    """Each block kind's share of one forward + backward of the loss, from
    CUDA events around every block's forward and (by ``_Mark``) its
    backward, in the real model; returns ({kind: (ms, calls)}, whole ms)."""
    from repro_torch.core.params import tree_leaves
    from repro_torch.models import transformer
    real, marks = transformer._apply_block, []

    def timed(kind, p, shared_p, x, cfg, ctx, positions, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        x = _Mark.apply(ev[3], x)
        ev[0].record()
        y, aux, nc = real(kind, p, shared_p, x, cfg, ctx, positions, **kw)
        ev[1].record()
        marks.append((kind, ev))
        return _Mark.apply(ev[2], y), aux, nc

    leaves = tree_leaves(run.params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    transformer._apply_block = timed
    try:
        start.record()
        loss = run.loss_fn(run.params, batch)
        torch.autograd.grad(loss, leaves, materialize_grads=True)
        end.record()
        end.synchronize()
    finally:
        transformer._apply_block = real
    out = {}
    for kind, ev in marks:
        ms = ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])
        t, n = out.get(kind, (0.0, 0))
        out[kind] = (t + ms, n + 1)
    return out, start.elapsed_time(end)


def phase18a(card):
    """zamba2-2.7b: 54 blocks, 9 x (5 Mamba2 + the shared attention+MLP
    block, one set of weights at all 9 points)."""
    run, counts, _, _ = _family_run("zamba2-2.7b", ZAMBA_BATCH, FAMILY_SEQ,
                                    FAMILY_STEPS, ZAMBA_PARAMS, card, "a")
    cfg = run.cfg
    batch = next(run.data)
    shares, whole = _block_shares(run, batch)
    print(f"  one forward + backward of the loss, {whole} ms by CUDA events, "
          f"its blocks' forward and backward by events in the model: "
          + "; ".join(f"{kind} x {n} {ms} ms, share {ms / whole}"
                      for kind, (ms, n) in shares.items()) + f" [{card}]")
    _step_split(run, batch, card)
    # the route gate on a batch the step split did not train on
    _route_gate(run, next(run.data), card, "18a")
    del batch
    # decode on fresh weights from seed 0, as the reference's decode test
    # runs on initial params: the step split trained 11 steps on one batch
    run.params = None
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, 0, run.device)
    gen = torch.Generator(device=run.device).manual_seed(2)
    _decode_consistency(params, cfg, gen, card, "18a")
    _generate(params, cfg, gen, GEN_NEW, card, "18a")
    return counts["flash_attention"]


def phase18b(card):
    """qwen2-vl-2b: vision stub embeddings then text, M-RoPE positions."""
    run, counts, _, _ = _family_run(
        "qwen2-vl-2b", LM_BATCH, 1024 + FAMILY_SEQ, FAMILY_STEPS,
        QWEN_VL_PARAMS, card, "b")
    cfg = run.cfg
    batch = next(run.data)
    check(tuple(batch["positions"].shape) == (LM_BATCH, 2048, 3) and
          tuple(batch["patch_embeds"].shape) == (LM_BATCH, 1024, cfg.d_model),
          f"18b: batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    _route_gate(run, batch, card, "18b")
    del batch
    gen = torch.Generator(device=run.device).manual_seed(3)
    _generate(run.params, cfg, gen, 16, card, "18b")
    run.params = None
    return counts["flash_attention"]


def phase18c(card):
    """musicgen-medium: audio frame embeddings, four codebook heads; the
    token embedding and LM head take zero gradients and move by AdamW's
    weight decay alone."""
    run, counts, keep, hist = _family_run(
        "musicgen-medium", LM_BATCH, FAMILY_SEQ, FAMILY_STEPS,
        MUSICGEN_PARAMS, card, "c")
    wd = run.optimizer.weight_decay
    for k, before in keep.items():
        lrs = [float(run.lr_schedule(i)) for i in range(len(hist))]
        want = before.clone()
        for lr in lrs:
            want.mul_(1 - lr * wd)
        got = run.params[k].detach()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        moved = ((got - before).abs().max() / before.abs().max()).item()
        print(f"  {k}: zero gradient; moved {moved} of its largest magnitude "
              f"in {len(hist)} steps; against decay alone, prod(1 - lr x "
              f"{wd}), max relative difference {rel} [{card}]")
        check(rel <= 1e-6 and moved > 0,
              f"18c: {k} did not move by weight decay alone")
    batch = next(run.data)
    _route_gate(run, batch, card, "18c")
    run.params = None
    return counts["flash_attention"]


def phase18d(card):
    """xlstm-125m: mLSTM and sLSTM blocks, no attention, no kernel."""
    from repro_torch.models import ssm
    run, counts, _, _ = _family_run("xlstm-125m", LM_BATCH, FAMILY_SEQ,
                                    XLSTM_STEPS, XLSTM_PARAMS, card, "d")
    cfg = run.cfg
    H, d = cfg.num_heads, cfg.d_model
    sp = {k: v[0].detach() for k, v in run.params["blocks"][1]["slstm"]
          .items()}
    dev = run.device
    gen = torch.Generator(device=dev).manual_seed(4)
    wx = torch.randn(LM_BATCH, FAMILY_SEQ, 4 * d, generator=gen, device=dev)
    z = torch.zeros(LM_BATCH, d, device=dev)
    carry = (z, z, z, torch.full_like(z, -1e30))
    with torch.no_grad():
        scan_ms = cuda_ms(lambda: ssm.slstm_scan(sp, H, d // H, carry, wx),
                          1, 3)
    print(f"  the sLSTM scan alone (forward, {FAMILY_SEQ} sequential steps "
          f"issued by the host, batch {LM_BATCH}, d {d}): {scan_ms} ms, "
          f"{scan_ms / FAMILY_SEQ * 1e3} us a step; {cfg.pattern_repeats} "
          f"sLSTM layers a forward [{card}]")
    gen = torch.Generator(device=dev).manual_seed(5)
    _decode_consistency(run.params, cfg, gen, card, "18d")
    _generate(run.params, cfg, gen, 16, card, "18d")
    run.close()
    run.params = run.opt_state = None
    return counts["flash_attention"]


def phase18(card):
    """Phase 18's four models, each freed before the next; the flash
    kernel's launches over their fits."""
    walls, flash = {}, 0
    for name, fn in (("18a", phase18a), ("18b", phase18b), ("18c", phase18c),
                     ("18d", phase18d)):
        t0 = time.perf_counter()
        flash += fn(card)
        walls[name] = round(time.perf_counter() - t0, 1)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  phase 18 wall seconds by part {walls}; flash_attention {flash} "
          f"launches")
    return flash


# ---------------------------------------------------------------------------
# phase 19: the paper's §3.3 hybrid, a model axis on the card
# ---------------------------------------------------------------------------
# Each hybrid run is held against the serial run from the same params (the
# seed's) and batches (the seeded stream): every step's loss, and every
# leaf's update over the run (final minus initial params, relative L2).  The
# sharded products sum the same terms in other orders: the forward's shards
# are the whole layer's columns (the kernel's K loop does not depend on N),
# but cuBLAS's backward on a shard picks its own algorithm, and each input
# gradient is the sum of the members' partial products.  So the gate is
# HYBRID_FACTOR x the one-ulp sensitivity measured in this run: the serial
# run again with every weight scaled by 1 + 2^-23, its largest relative
# loss change over the steps and its largest leaf's update change; for
# VGG-A never tighter than GRAD_REL_L2_TOL, as phase 4 (its ReLU and pool
# ties make a leaf's update jump under any f32-level change).  A missing or
# doubled model-axis collective is off by a factor of 2 or misses terms.
# The loss gate is never tighter than 10 ulps of the loss: a one-ulp change of
# CD-DNN's weights moves its loss (~9.26) by less than the loss's own ulp.
# (c) holds the process path's losses to (a)'s local-mesh zero1 run at (a)'s
# loss gate (each rank's loss is its half batch's mean, their mean the
# group's).
HYBRID_LOSS_ULP = 2.0 ** -23
HYBRID_MESH = {"members_per_device": 2, "model_ways": 2}
HYBRID_FACTOR = 10.0
HYBRID_VGG_BATCH = 64
HYBRID_VGG_STEPS = 4
HYBRID_PROCESS_STEPS = 3
HYBRID_RANKS = 4


def _hybrid_fit(spec, card, tag, ulp=False):
    """Compile ``spec`` on the kernel route (``ulp``: every weight scaled by
    1 + 2^-23 first), fit it with every count zeroed just before and read
    just after; return (run, losses, full params before, full params
    after, counts, step spans, peak GB)."""
    from repro_torch.api import compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    spans = SyncedSpans()
    run = use_kernel(compile_run(spec, recorder=spans))
    if ulp:
        with torch.no_grad():
            for k, p in run.params.items():
                if k.endswith("_w"):
                    p.mul_(1 + 2.0 ** -23)
    before = {k: v.detach().clone() for k, v in run.full_params().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    hist = run.fit(log_fn=lambda line: None)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"19{tag}: history {hist}")
    after = {k: v.detach().clone() for k, v in run.full_params().items()}
    return (run, [h["loss"] for h in hist], before, after, counts,
            spans.samples["step"], peak)


def _update_rel(a, b):
    """Per leaf, the relative L2 of run a's update against run b's."""
    (a0, a1), (b0, b1) = a, b
    return {k: ((a1[k] - a0[k]) - (b1[k] - b0[k])).norm().item()
            / (b1[k] - b0[k]).norm().item() for k in b0}


def _loss_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _hybrid_gate(cfg_name, spec, card, tag, modes, floor=0.0):
    """The serial run, its one-ulp twin and a hybrid run per (parallel,
    comm) of ``modes``; every gate of the module comment.  Returns ({mode:
    (run, losses, counts)}, the loss gate)."""
    serial = _hybrid_fit(spec, card, tag)
    s_run, s_loss, s0, s1 = serial[:4]
    s_step = float(np.median(serial[5][1:]))
    s_run.close()
    del s_run, serial
    u = _hybrid_fit(spec, card, tag, ulp=True)
    u[0].close()
    sens_upd = _update_rel(u[2:4], (s0, s1))
    sens_loss = _loss_rel(u[1], s_loss)
    del u
    upd_tol = max(floor, HYBRID_FACTOR * max(sens_upd.values()))
    loss_tol = HYBRID_FACTOR * max(sens_loss, HYBRID_LOSS_ULP)
    print(f"  19{tag}: {cfg_name} serial, {spec.steps} steps of batch "
          f"{spec.batch}: step median {s_step * 1e3} ms; losses {s_loss}; "
          f"one-ulp sensitivity (every weight x (1 + 2^-23)): loss "
          f"{sens_loss}, update {max(sens_upd.values())} (worst leaf); gates "
          f"loss {loss_tol}, update {upd_tol} [{card}]")
    from repro_torch.api import MeshSpec
    out = {}
    for parallel, comm in modes:
        hspec = spec.replace(parallel=parallel, comm=comm,
                             mesh=MeshSpec(**HYBRID_MESH))
        run, losses, h0, h1, counts, steps, peak = _hybrid_fit(
            hspec, card, tag)
        rel = _update_rel((h0, h1), (s0, s1))
        lrel = _loss_rel(losses, s_loss)
        name = parallel + (f" ({comm.backend})" if comm else "")
        worst = max(rel, key=rel.get)
        print(f"  19{tag}: {name} on {run.mesh}, {len(run.params)} leaves in "
              f"member layout (e.g. {worst} "
              f"{tuple(run.params[worst].shape)}): step median "
              f"{float(np.median(steps[1:])) * 1e3} ms ({spec.batch * len(steps[1:]) / sum(steps[1:])} "
              f"samples/s of step time), first step {steps[0] * 1e3} ms; "
              f"peak {peak} GB; launches "
              f"{ {k: v for k, v in counts.items() if v} }; losses {losses}; "
              f"against serial: loss {lrel} (gate {loss_tol}), worst leaf's "
              f"update {rel[worst]} at {worst} (gate {upd_tol}) [{card}]")
        check(lrel <= loss_tol, f"19{tag} {name}: losses {losses} against "
              f"serial {s_loss}")
        check(rel[worst] <= upd_tol, f"19{tag} {name}: {worst}'s update off "
              f"by {rel[worst]}")
        out[name] = (run, losses, counts)
    return out, loss_tol


def _hybrid_split(run, batch, card, tag):
    """One hybrid step's forward / backward / update split, CUDA events,
    median of 3."""
    from repro_torch.core.params import tree_leaves
    split = {"forward": [], "backward": [], "step": []}
    for i in range(3):
        leaves = [p.requires_grad_() for p in tree_leaves(run.params)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        run.step(batch, step_idx=100 + i)
        ev[3].record()
        ev[3].synchronize()
        for k, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[k].append(ev[a].elapsed_time(ev[b]))
    fwd, bwd, step = (float(np.median(split[k])) for k in split)
    print(f"    19{tag} one step by CUDA events: train_step {step} ms; "
          f"forward alone {fwd} ms, backward alone {bwd} ms, so norm, clip "
          f"and the update about {step - fwd - bwd} ms [{card}]")


def _gemm_shards(card):
    """The GEMM's time per model shard beside the whole layer's, at CD-DNN's
    three layer shapes (batch 1024, 2 model ways)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import blocked_matmul as kmm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    seen = {}
    for M, N, K in dnn_layer_shapes(get_config("cd-dnn"), DNN_BATCH):
        if (N, K) in seen:
            continue
        a = torch.randn(M, K, generator=gen, device=dev)
        full = torch.randn(K, N, generator=gen, device=dev)
        half = full[:, :N // 2].contiguous()
        seen[(N, K)] = (cuda_ms(lambda: kmm.blocked_matmul(a, full)),
                        cuda_ms(lambda: kmm.blocked_matmul(a, half)))
    print("    19a the GEMM per model shard against the whole layer, batch "
          f"{DNN_BATCH}: " + "; ".join(
              f"K {K} N {N}: whole {w} ms, shard (N {N // 2}) {h} ms"
              for (N, K), (w, h) in seen.items()) + f" [{card}]")


def phase19a(card):
    from repro_torch.api import RunSpec
    from repro_torch.comm import CommConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = RunSpec(arch="cd-dnn", batch=DNN_BATCH, steps=DNN_STEPS,
                   lr=DNN_LR, schedule="constant", seed=0, log_every=1)
    print(f"phase 19a: CD-DNN at full width on a {HYBRID_MESH} mesh (2 data "
          f"members x 2 model ways on one card), every FC forward on the "
          f"GEMM kernel as one launch per model member")
    runs, loss_tol = _hybrid_gate(
        "CD-DNN", spec, card, "a",
        (("zero1", CommConfig(backend="pallas-ring")), ("dp", None),
         ("zero1-gspmd", None)))
    n_layers = 8
    total = {}
    for name, (run, losses, counts) in runs.items():
        want = dict.fromkeys(counts, 0)
        want["blocked_matmul"] = spec.steps * n_layers * 2
        if name.startswith("zero1 "):
            n_buckets = len(run.opt_state.velocity)
            want["ring_reduce_scatter"] = spec.steps * n_buckets
            want["ring_all_gather"] = spec.steps * n_buckets
        check(counts == want, f"19a {name}: launches {counts}, want {want}")
        total = _sum_counts(total, counts)
        _hybrid_split(run, next(run.data), card, "a " + name)
        run.close()
    zero1_losses = runs["zero1 (pallas-ring)"][1]
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    _gemm_shards(card)
    return total, zero1_losses, loss_tol


def phase19b(card):
    from repro_torch.api import RunSpec
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    spec = RunSpec(arch="vgg-a", batch=HYBRID_VGG_BATCH,
                   steps=HYBRID_VGG_STEPS, lr=5e-3, schedule="constant",
                   seed=0, log_every=1)
    print(f"phase 19b: VGG-A at full width, dp on a {HYBRID_MESH} mesh, "
          f"every forward conv on the kernel as one launch per model member, "
          f"deterministic cuDNN")
    try:
        runs, _ = _hybrid_gate("VGG-A", spec, card, "b", (("dp", None),),
                               floor=GRAD_REL_L2_TOL)
    finally:
        torch.backends.cudnn.deterministic = False
    run, _, counts = runs["dp"]
    want = dict.fromkeys(counts, 0)
    want["conv2d_nhwc"] = spec.steps * len(run.cfg.conv_layers()) * 2
    check(counts == want, f"19b dp: launches {counts}, want {want}")
    _hybrid_split(run, next(run.data), card, "b dp")
    run.close()
    return counts


def _hybrid_member(rank, world, init_file, results):
    """One rank of phase 19c: CD-DNN zero1 on pallas-ring over a
    ``{data: 2, model: 2}`` ProcessMesh, every FC forward on the GEMM
    kernel."""
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        from repro_torch.api import RunSpec, compile_run
        from repro_torch.comm import CommConfig
        from repro_torch.launch.mesh import make_process_mesh
        from repro_torch.launch.paper_cnn_training import use_kernel
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        mesh = make_process_mesh(model_ways=2, device=dev)
        spec = RunSpec(arch="cd-dnn", batch=DNN_BATCH,
                       steps=HYBRID_PROCESS_STEPS, lr=DNN_LR,
                       schedule="constant", seed=0, log_every=1,
                       parallel="zero1",
                       comm=CommConfig(backend="pallas-ring"))
        spans = SyncedSpans()
        run = use_kernel(compile_run(spec, recorder=spans, mesh=mesh))
        n_buckets = len(run.opt_state.velocity)
        torch.cuda.synchronize()
        _counts_zeroed()
        hist = run.fit(log_fn=lambda line: None)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _counts().items() if v}
        results.put((rank, ([h["loss"] for h in hist], counts, n_buckets,
                            spans.samples["step"], repr(mesh)), None))
        code = 0
    except Exception:
        results.put((rank, None, traceback.format_exc()))
        code = 1
    results.close()
    results.join_thread()
    if code == 0:
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def phase19c(card, local_losses, loss_tol):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(), "init")
    procs = [ctx.Process(target=_hybrid_member,
                         args=(r, HYBRID_RANKS, init_file, results))
             for r in range(HYBRID_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    for rank, out, err in got:
        check(err is None, f"19c rank {rank} failed:\n{err}")
    for rank, p in enumerate(procs):
        check(p.exitcode == 0, f"19c rank {rank} exited with code "
              f"{p.exitcode}")
    steps = HYBRID_PROCESS_STEPS
    for rank, out, _ in got:
        losses, counts, n_buckets, spans, mesh = out
        want = {"blocked_matmul": steps * 8,
                "ring_hop_accum": steps * n_buckets}
        check(counts == want, f"19c rank {rank}: launches {counts}, want "
              f"{want}")
        lrel = _loss_rel(losses, local_losses[:steps])
        print(f"  19c rank {rank} of {mesh}: {steps} zero1 steps of CD-DNN "
              f"(its data pair's {DNN_BATCH // 2} rows, its model member's "
              f"columns; messages staged through host memory over gloo): "
              f"steps {[s * 1e3 for s in spans]} ms; launches {counts}; "
              f"losses {losses} against the local mesh's "
              f"{local_losses[:steps]}: {lrel} (gate {loss_tol}) [{card}]")
        check(lrel <= loss_tol, f"19c rank {rank}: losses {losses}")
    print(f"  19c: {HYBRID_RANKS} ranks in {wall} s, spawn and exit included")
    return got[0][1][1]


def phase19(card):
    """Phase 19's three parts; the kernels' launches over its fits (19c's
    one rank's)."""
    walls = {}
    t0 = time.perf_counter()
    dnn_counts, zero1_losses, loss_tol = phase19a(card)
    walls["19a"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    vgg_counts = phase19b(card)
    walls["19b"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank_counts = phase19c(card, zero1_losses, loss_tol)
    walls["19c"] = round(time.perf_counter() - t0, 1)
    total = _sum_counts(dnn_counts, vgg_counts, rank_counts)
    print(f"  phase 19 wall seconds by part {walls}; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


# ---------------------------------------------------------------------------
# phase 20: the transformer family's model ways (paper §3.3 on the LMs)
# ---------------------------------------------------------------------------
# Every part runs at MeshSpec(members_per_device=2, model_ways=2) on one
# card (2 data members x 2 model ways), from seed 0's random weights and
# the seeded streams, every attention forward on the flash kernel.  The
# gate of every part is phase 13's, on the run's params after its fit and
# its next batch: one forward and backward on the model-ways route against
# the serial route (``ShardingCtx()``) on the same full params, the loss
# within LM_LOSS_REL_TOL and every leaf's gradient within
# SENSITIVITY_FACTOR times the serial route's own one-ulp sensitivity
# (every weight x (1 + 2^-23)), never tighter than LM_GRAD_REL_L2_TOL.  An
# MoE's router choices in the model-ways pass are pinned to the serial
# pass's (phase 17d), and the recorded choices must drop no assignment at
# either route's capacities.
LM_MODEL_MESH = {"members_per_device": 2, "model_ways": 2}
LM_MODEL_STEPS = 4
LM_MODEL_SMALL_STEPS = 3
LLAMA100M_BATCH, LLAMA100M_SEQ = 8, 512
MOE_MODEL_BATCH, MOE_MODEL_SEQ = 1, 128
MOE_MODEL_CF = 16.0     # capacities above any expert's assignments here
MOE_MODEL_PAD = 4
MQA_LAYERS = 2
SHARDED_DECODE_PROMPT, SHARDED_DECODE_NEW, SHARDED_DECODE_BATCH = 64, 16, 2
LM_PROCESS_STEPS = 2
LM_PROCESS_RANKS = 4
# every flash kernel shape phase 20's fits launch, and the parts that
# launched it (flash_shapes_recorded); phase20_flash_shapes holds the kernel
# to its plain version at each
FLASH_FIT_SHAPES = {}


def _lm_cfg(arch, **kw):
    """A registry config at full width, ``kw`` replaced (a rehearsal on the
    CPU patches this to the smoke variant)."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(**kw)


def _lm_spec(cfg, batch, seq, steps, parallel="dp", comm=None, **kw):
    from repro_torch.api import MeshSpec, RunSpec
    return RunSpec(arch=cfg, steps=steps, batch=batch, seq=seq, seed=0,
                   log_every=1, parallel=parallel, comm=comm,
                   mesh=MeshSpec(**LM_MODEL_MESH), **kw)


def _lm_fit(spec, card, tag, record=False):
    """Compile ``spec`` on the kernel route and fit it, every count zeroed
    just before and read just after (``record``: the router's choices
    recorded); returns (run, history, counts, step spans, peak GB, the
    recorded choices)."""
    from repro_torch.api import compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _counts_zeroed()
    with (routes_recorded() if record else nullcontext([])) as routes, \
            flash_shapes_recorded(FLASH_FIT_SHAPES, tag):
        hist = run.fit(log_fn=lambda line: None)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(hist) == spec.steps and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
        f"20{tag}: history {hist}")
    print(f"  20{tag}: {run.cfg.name} {spec.parallel}"
          f"{f' ({spec.comm.backend})' if spec.comm else ''} on {run.mesh} "
          f"compiled in {init_s:.2f} s; {spec.steps} steps of "
          f"{spec.batch} x {spec.seq} tokens: losses "
          f"{[h['loss'] for h in hist]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return run, hist, counts, spans.samples["step"], peak, list(routes)


def _rel_l2(ga, gb_host):
    return [((a - b.to(a.device)).norm() / b.norm().to(a.device)).item()
            for a, b in zip(ga, gb_host)]


def _lm_pass(loss_fn, params, batch):
    """One forward and backward: (loss, gradient leaves)."""
    from repro_torch.core.params import tree_leaves
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(params, batch)
    return loss.item(), torch.autograd.grad(loss, leaves)


def _lm_gate(run, batch, card, tag, phase="20"):
    """Phase 13's gate (module comment) of ``run``'s model-ways route
    against the serial route on the same full params; frees the run's
    optimizer state first and its params after.  Returns the serial
    pass's router choices."""
    from repro_torch.core.params import map_tree, tree_leaves
    from repro_torch.models import transformer
    run.close()
    run.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    cfg, ctx = run.cfg, run.ctx
    specs = run.family.param_specs(cfg)
    names = list(_leaf_names(run.params))
    held = {id(p) for p in tree_leaves(run.params)}
    full = map_tree(lambda x: x.detach().clone() if id(x) in held
                    else x.detach(), ctx.full(run.params, specs))

    def serial(p, b):
        return transformer.lm_loss(p, cfg, NO_MESH, b, use_kernel=True)

    torch.cuda.reset_peak_memory_stats()
    with routes_recorded() as routes:
        ls, gs = _lm_pass(serial, full, batch)
    gs = [g.cpu() for g in gs]
    with routes_pinned(routes):
        lm, gm = _lm_pass(run.loss_fn, run.params, batch)
    it = iter(gm)
    gm = tree_leaves(ctx.full(map_tree(lambda _: next(it), run.params),
                              specs))
    rel = _rel_l2(gm, gs)
    del gm
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        for p in tree_leaves(full):
            p.mul_(1 + 2.0 ** -23)
    with routes_pinned(routes):
        _, gu = _lm_pass(serial, full, batch)
    floor = _rel_l2(gu, gs)
    del gu, gs, full
    run.params = None
    gc.collect()
    torch.cuda.empty_cache()
    check(np.isfinite(lm) and np.isfinite(ls),
          f"{phase}{tag}: non-finite loss")
    loss_rel = abs(lm - ls) / abs(ls)
    tol = max(LM_GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * max(floor))
    worst = int(np.argmax(rel))
    print(f"  {phase}{tag} gate, one forward and backward on the params after the "
          f"fit and its next batch{', router choices pinned to the serial pass' if routes else ''}: "
          f"model ways {lm} vs serial {ls} (relative {loss_rel}, tolerance "
          f"{LM_LOSS_REL_TOL}); worst leaf's gradient relative L2 {rel[worst]} "
          f"at {names[worst]}; serial with every weight x (1 + 2^-23): worst "
          f"{max(floor)}; tolerance max({LM_GRAD_REL_L2_TOL}, "
          f"{SENSITIVITY_FACTOR} x sensitivity) = {tol}; peak of the two "
          f"passes {peak} GB [{card}]")
    check(loss_rel <= LM_LOSS_REL_TOL, f"{phase}{tag}: losses differ")
    check(max(rel) <= tol,
          f"{phase}{tag}: gradients differ at {names[worst]}")
    return routes


def _lm_split(run, batch, card, tag):
    """One step's forward / backward / update split, CUDA events, median
    of 3."""
    from repro_torch.core.params import tree_leaves
    split = {"forward": [], "backward": [], "step": []}
    for i in range(3):
        leaves = [p.requires_grad_() for p in tree_leaves(run.params)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        del loss, grads
        run.step(batch, step_idx=100 + i)
        ev[3].record()
        ev[3].synchronize()
        for k, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[k].append(ev[a].elapsed_time(ev[b]))
    fwd, bwd, step = (float(np.median(split[k])) for k in split)
    print(f"  20{tag} one step by CUDA events: train_step {step} ms; forward "
          f"alone {fwd} ms, backward alone {bwd} ms, so norm, clip and the "
          f"update about {step - fwd - bwd} ms [{card}]")
    return fwd, bwd, step


def _flash_member_ms(card, cfg, B, S):
    """The flash kernel on one model member's heads (Hq/2, Hkv/2) against
    the whole layer's, at ``cfg``'s global-attention shape."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for name, hq, hk in (("whole", cfg.num_heads, cfg.num_kv_heads),
                         ("member", cfg.num_heads // 2,
                          max(1, cfg.num_kv_heads // 2))):
        q, k, v = (torch.randn(B, S, h, cfg.head_dim, generator=gen,
                               device=dev, dtype=torch.bfloat16)
                   for h in (hq, hk, hk))
        out[name] = cuda_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, logit_softcap=cfg.attn_logit_softcap))
    print(f"  20a flash kernel forward at {B} x {S}, head dim "
          f"{cfg.head_dim}: the whole layer's {cfg.num_heads} q / "
          f"{cfg.num_kv_heads} kv heads {out['whole']} ms, one member's "
          f"{cfg.num_heads // 2} / {max(1, cfg.num_kv_heads // 2)} "
          f"{out['member']} ms [{card}]")


def phase20a(card):
    """gemma2-2b at full width and depth, dp at model ways 2."""
    from repro_torch.core.params import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg("gemma2-2b")
    spec = _lm_spec(cfg, LM_BATCH, LM_SEQ, LM_MODEL_STEPS)
    print(f"phase 20a: {cfg.name} at full width and depth, dp on a "
          f"{LM_MODEL_MESH} mesh: each model member on {cfg.num_heads // 2} "
          f"of {cfg.num_heads} q heads, {cfg.num_kv_heads // 2} of "
          f"{cfg.num_kv_heads} kv heads, {cfg.d_ff // 2} of {cfg.d_ff} GeGLU "
          f"columns and {cfg.vocab_size // 2} of {cfg.vocab_size} vocab rows")
    run, hist, counts, steps, peak, _ = _lm_fit(spec, card, "a")
    n_params = sum(p.numel() for p in tree_leaves(run.full_params()))
    check(n_params == LM_PARAMS, f"20a: {n_params} params, want {LM_PARAMS}")
    per_step = 2 * cfg.num_layers
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = spec.steps * per_step
    check(counts == want, f"20a: launches {counts}, want {want}")
    tokens = spec.batch * spec.seq
    print(f"  20a: flash_attention {counts['flash_attention']} = "
          f"{spec.steps} x {per_step} (2 members x {cfg.num_layers} layers), "
          f"every other kernel 0; step median over steps 2-{spec.steps} "
          f"{float(np.median(steps[1:])) * 1e3} ms "
          f"({tokens * len(steps[1:]) / sum(steps[1:])} tokens/s of step "
          f"time); first step {steps[0] * 1e3} ms; peak memory {peak} GB "
          f"[{card}]")
    batch = next(run.data)
    _lm_split(run, batch, card, "a")
    _lm_gate(run, batch, card, "a")
    _flash_member_ms(card, cfg, LM_BATCH, LM_SEQ)
    return counts


def _ring_want(run, steps):
    """The zero1 ring kernels' launches of a ``steps``-step fit: one
    reduce-scatter and one all-gather a bucket of the full tree's plan."""
    n = run.dist_update.plan.buckets(run.full_params()).n_collectives
    return {"ring_reduce_scatter": steps * n, "ring_all_gather": steps * n}


def phase20b(card):
    """llama-100m under zero1-gspmd and zero1, gemma-2b's MQA under dp."""
    from repro_torch.comm import CommConfig
    cfg = _lm_cfg("llama-100m")
    print(f"phase 20b: {cfg.name} at full width and depth under zero1-gspmd "
          f"and zero1 (pallas-ring), gemma-2b at full width and "
          f"{MQA_LAYERS} layers under dp (4 q heads and the one kv head a "
          f"member), on a {LM_MODEL_MESH} mesh")
    total, zero1_losses = {}, None
    for parallel, comm in (("zero1-gspmd", None),
                           ("zero1", CommConfig(backend="pallas-ring"))):
        spec = _lm_spec(cfg, LLAMA100M_BATCH, LLAMA100M_SEQ, LM_MODEL_STEPS,
                        parallel, comm)
        run, hist, counts, steps, peak, _ = _lm_fit(spec, card, "b")
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = spec.steps * 2 * cfg.num_layers
        if parallel == "zero1":
            want.update(_ring_want(run, spec.steps))
            zero1_losses = [h["loss"] for h in hist]
        check(counts == want, f"20b {parallel}: launches {counts}, want "
              f"{want}")
        print(f"  20b {parallel}: step median "
              f"{float(np.median(steps[1:])) * 1e3} ms, peak {peak} GB; "
              f"launches as planned [{card}]")
        total = _sum_counts(total, counts)
        _lm_gate(run, next(run.data), card, "b " + parallel)
    mqa = _lm_cfg("gemma-2b", num_layers=MQA_LAYERS,
                  pattern_repeats=MQA_LAYERS)
    spec = _lm_spec(mqa, LM_BATCH, LM_SEQ, LM_MODEL_SMALL_STEPS)
    run, hist, counts, steps, peak, _ = _lm_fit(spec, card, "b")
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = spec.steps * 2 * mqa.num_layers
    check(counts == want, f"20b gemma-2b: launches {counts}, want {want}")
    total = _sum_counts(total, counts)
    _lm_gate(run, next(run.data), card, "b gemma-2b")
    return total, zero1_losses


def _moe_drops(cfg, routes, B, S, ep_members=0):
    """Assignments over capacity in the recorded router choices (one (B, S,
    k) per MoE layer): the capacity-bounded route's per-sample expert
    capacity, or (``ep_members`` = n) ``moe_ep_block``'s per-destination
    and per-expert capacities."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    Ep = E + cfg.moe_expert_pad
    cf = cfg.moe_capacity_factor
    drops = 0
    for idx, _ in routes:
        idx = idx.reshape(B, S * k).long()
        if not ep_members:
            C = max(1, int(S * k / E * cf))
            per = torch.nn.functional.one_hot(idx, Ep).sum(1)
            drops += int((per - C).clamp(min=0).sum())
            continue
        n = ep_members
        T = B * S * k
        Ts, E_loc = T // n, Ep // n
        C = max(1, int(Ts / n * cf))
        Ce = max(1, int(n * C / E_loc * cf))
        flat = idx.reshape(T)
        for m in range(n):
            dest = flat[m * Ts:(m + 1) * Ts] // E_loc
            drops += int((torch.bincount(dest, minlength=n) - C)
                         .clamp(min=0).sum())
        drops += int((torch.bincount(flat, minlength=Ep) - Ce)
                     .clamp(min=0).sum())
    return drops


def phase20c(card):
    """qwen2-moe-a2.7b at full width and 2 layers: the expert-sharded
    route, then moe_ep_block with 4 padded experts."""
    print(f"phase 20c: qwen2-moe-a2.7b at full width and "
          f"{MOE_TRAIN_LAYERS} layers, dp on a {LM_MODEL_MESH} mesh, batch "
          f"{MOE_MODEL_BATCH} x {MOE_MODEL_SEQ}, capacity factor "
          f"{MOE_MODEL_CF}")
    total = {}
    for pad, route in ((0, "experts on the model axis"),
                       (MOE_MODEL_PAD, "moe_ep_block")):
        cfg = _lm_cfg("qwen2-moe-a2.7b", num_layers=MOE_TRAIN_LAYERS,
                      pattern_repeats=MOE_TRAIN_LAYERS,
                      moe_capacity_factor=MOE_MODEL_CF,
                      moe_expert_pad=pad)
        Ep = cfg.num_experts + pad
        spec = _lm_spec(cfg, MOE_MODEL_BATCH, MOE_MODEL_SEQ,
                        LM_MODEL_SMALL_STEPS)
        run, hist, counts, steps, peak, fit_routes = _lm_fit(
            spec, card, "c", record=True)
        w = run.params["blocks"][0]["moe"]["w_gate"]
        check(w.shape[0] == 2 and w.shape[2] == Ep // 2,
              f"20c {route}: w_gate held as {tuple(w.shape)}")
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = spec.steps * 2 * cfg.num_layers
        check(counts == want, f"20c {route}: launches {counts}, want {want}")
        total = _sum_counts(total, counts)
        gate_routes = _lm_gate(run, next(run.data), card, f"c {route}")
        # the fit's choices at its own route's capacities; the gate's (the
        # serial pass's, which both passes take) at both routes'
        n = 2 if pad else 0
        drops = (_moe_drops(cfg, fit_routes, MOE_MODEL_BATCH, MOE_MODEL_SEQ,
                            n),
                 _moe_drops(cfg, gate_routes, MOE_MODEL_BATCH,
                            MOE_MODEL_SEQ, n)
                 + _moe_drops(cfg, gate_routes, MOE_MODEL_BATCH,
                              MOE_MODEL_SEQ))
        print(f"  20c {route}: {Ep} experts, {Ep // 2} a member (w_gate "
              f"held as {tuple(w.shape)}); step median "
              f"{float(np.median(steps[1:])) * 1e3} ms, peak {peak} GB; "
              f"dropped assignments in the fit's and the gate's router "
              f"choices {drops} [{card}]")
        check(drops == (0, 0), f"20c {route}: dropped assignments {drops}")
    return total


def phase20d(card):
    """gemma-2b at full width and depth through serve.decode with a
    sequence-sharded cache, teacher-forced on the unsharded run."""
    from repro_torch.configs.base import H100_SXM, InputShape
    from repro_torch.core import hybrid
    from repro_torch.core.sharding import from_members
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers, transformer
    from repro_torch.serve import decode
    cfg = _lm_cfg("gemma-2b")
    dev = torch.device("cuda")
    params = transformer.init_params(cfg, 0, dev)
    mesh = make_local_mesh(LM_MODEL_MESH["members_per_device"],
                           model_ways=LM_MODEL_MESH["model_ways"], device=dev)
    B, S, new = (SHARDED_DECODE_BATCH, SHARDED_DECODE_PROMPT,
                 SHARDED_DECODE_NEW)
    plan = hybrid.plan(cfg, InputShape("decode", S + new, B, "decode"), mesh,
                       H100_SXM)
    check(plan.rules.rules["cache_seq"] == ("model",),
          f"20d: plan {plan.rules.rules['cache_seq']}, {plan.notes}")
    ctx = ShardingCtx(mesh, plan.rules)
    specs = transformer.param_specs(cfg)
    placed = ctx.place(params, specs)
    prompt = torch.tensor(np.random.default_rng(20).integers(
        1, cfg.vocab_size, (B, S)), device=dev)
    cap = S + new
    print(f"phase 20d: {cfg.name} at full width and depth through "
          f"serve.decode on {mesh}, hybrid.plan's rules for a decode of "
          f"batch {B}: cache_seq {plan.rules.rules['cache_seq']} "
          f"({'; '.join(plan.notes)}); prompt {B} x {S}, {new} decode steps "
          f"teacher-forced on the unsharded run's tokens")

    def run(p, c, forced=None):
        t0 = time.perf_counter()
        lg, caches = decode.prefill(p, cfg, c, prompt, cap)
        logs, toks = [lg.float()], []
        for i in range(new):
            tok = (forced[:, i:i + 1] if forced is not None
                   else torch.argmax(lg, -1)[:, None])
            toks.append(tok)
            lg, caches = decode.decode_step(p, cfg, c, tok, S + i, caches)
            logs.append(lg.float())
        torch.cuda.synchronize()
        return logs, torch.cat(toks, 1), caches, time.perf_counter() - t0

    want, toks, w_caches, w_s = run(params, NO_MESH)
    got, _, g_caches, g_s = run(placed, ctx, toks)
    with torch.no_grad():
        for p in _leaves(params):
            p.mul_(1 + 2.0 ** -23)
    ulp, _, u_caches, _ = run(params, NO_MESH, toks)
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want)) / scale
    sens = max((u - w).abs().max().item() for u, w in zip(ulp, want)) / scale
    tol = max(SENSITIVITY_FACTOR * sens, 4 * 2.0 ** -8)
    kc = g_caches[0]
    check(isinstance(kc, layers.SeqShardedCache), f"20d: cache {type(kc)}")
    spec = (None, None, "model")
    exact, slots_ok = True, True
    # every layer's keys and values against the unsharded run's, relative
    # to the layer's largest |value|: (difference, the one-ulp run's, layer)
    c_err = c_sens = (0.0, "")
    for i, (wc, gc_, uc) in enumerate(zip(w_caches, g_caches, u_caches)):
        for name, a, b, u in (("k", wc.k, gc_.k, uc.k),
                              ("v", wc.v, gc_.v, uc.v)):
            full = torch.stack([from_members(b[r], spec[1:], mesh)
                                for r in range(b.shape[0])])
            written_w = a.abs().amax((-1, -2)) > 0
            written_g = full.abs().amax((-1, -2)) > 0
            slots_ok &= bool(torch.equal(written_w, written_g))
            exact &= bool(torch.equal(a[0], full[0]))
            for r in range(a.shape[0]):
                big = a[r].float().abs().max().item()
                at = f"stack {i} layer {r} {name}"
                c_err = max(c_err, ((full[r].float() - a[r].float()).abs()
                                    .max().item() / big, at))
                c_sens = max(c_sens, ((u[r].float() - a[r].float()).abs()
                                      .max().item() / big, at))
        check(torch.equal(wc.length, gc_.length), "20d: cache lengths")
    c_tol = max(SENSITIVITY_FACTOR * c_sens[0], 4 * 2.0 ** -8)
    print(f"  20d: unsharded {w_s} s, sharded {g_s} s for prefill and {new} "
          f"steps; the sharded cache held as {tuple(kc.k.shape)} (R, "
          f"shards, B, C / 2, Hkv, D) per layer stack; logits' largest "
          f"difference {err} of their largest magnitude over prefill and "
          f"{new} steps (the unsharded run with every weight x (1 + "
          f"2^-23): {sens}; tolerance max({SENSITIVITY_FACTOR} x that, "
          f"4 bf16 ulps) = {tol}); written slots equal in every layer "
          f"{slots_ok}, layer 0's keys and values bitwise {exact}; every "
          f"layer's keys and values, largest difference {c_err[0]} of the "
          f"layer's largest magnitude at {c_err[1]} (the one-ulp run: "
          f"{c_sens[0]} at {c_sens[1]}; tolerance max({SENSITIVITY_FACTOR} "
          f"x that, 4 bf16 ulps) = {c_tol}) [{card}]")
    check(err <= tol, f"20d: logits differ by {err}")
    check(slots_ok and exact, "20d: cache slots differ")
    check(c_err[0] <= c_tol, f"20d: cached keys or values differ by "
          f"{c_err[0]} at {c_err[1]}")


def _lm_member(rank, world, init_file, results):
    """One rank of phase 20e: llama-100m zero1 on pallas-ring over a
    ``{data: 2, model: 2}`` ProcessMesh on the card."""
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        from repro_torch.api import compile_run
        from repro_torch.comm import CommConfig
        from repro_torch.launch.mesh import make_process_mesh
        from repro_torch.launch.paper_cnn_training import use_kernel
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_process_mesh(model_ways=2, device=torch.device("cuda", 0))
        spec = _lm_spec(_lm_cfg("llama-100m"), LLAMA100M_BATCH,
                        LLAMA100M_SEQ, LM_PROCESS_STEPS, "zero1",
                        CommConfig(backend="pallas-ring"))
        spans = SyncedSpans()
        run = use_kernel(compile_run(spec, recorder=spans, mesh=mesh))
        n_buckets = run.dist_update.plan.buckets(
            run.full_params()).n_collectives
        torch.cuda.synchronize()
        _counts_zeroed()
        with flash_shapes_recorded({}, "e") as shapes:
            hist = run.fit(log_fn=lambda line: None)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _counts().items() if v}
        results.put((rank, ([h["loss"] for h in hist], counts, n_buckets,
                            spans.samples["step"], repr(mesh), list(shapes)),
                           None))
        code = 0
    except Exception:
        results.put((rank, None, traceback.format_exc()))
        code = 1
    results.close()
    results.join_thread()
    if code == 0:
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def phase20e(card, local_losses):
    cfg = _lm_cfg("llama-100m")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(), "init")
    procs = [ctx.Process(target=_lm_member,
                         args=(r, LM_PROCESS_RANKS, init_file, results))
             for r in range(LM_PROCESS_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    for rank, out, err in got:
        check(err is None, f"20e rank {rank} failed:\n{err}")
    for rank, p in enumerate(procs):
        check(p.exitcode == 0, f"20e rank {rank} exited with code "
              f"{p.exitcode}")
    steps = LM_PROCESS_STEPS
    for rank, out, _ in got:
        losses, counts, n_buckets, spans, mesh, shapes = out
        for shape in shapes:
            FLASH_FIT_SHAPES.setdefault(shape, set()).add("e")
        want = {"flash_attention": steps * cfg.num_layers,
                "ring_hop_accum": steps * n_buckets}
        check(counts == want, f"20e rank {rank}: launches {counts}, want "
              f"{want}")
        dl = max(abs(a - b) for a, b in zip(losses, local_losses[:steps]))
        print(f"  20e rank {rank} of {mesh}: {steps} zero1 steps of "
              f"{cfg.name} (its data pair's {LLAMA100M_BATCH // 2} rows, its "
              f"model member's heads, ff columns and vocab rows; messages "
              f"staged through host memory over gloo): steps "
              f"{[s * 1e3 for s in spans]} ms; launches {counts}; losses "
              f"{losses} against 20b's local run "
              f"{local_losses[:steps]}: |delta| {dl} (gate "
              f"{LM_LOSS_REL_TOL} x loss) [{card}]")
        check(dl <= LM_LOSS_REL_TOL * abs(local_losses[0]),
              f"20e rank {rank}: losses {losses}")
    print(f"  20e: {LM_PROCESS_RANKS} ranks in {wall} s, spawn and exit "
          f"included")
    return got[0][1][1]


def phase20_flash_shapes(card, shapes=FLASH_FIT_SHAPES, phase="20"):
    """Phase 12's check at every shape ``phase``'s fits handed the flash
    kernel (``shapes``; phase 20's: one model member's heads): the kernel
    against its plain version on the same inputs, to one bf16 ulp of each
    (batch, head)'s largest |plain| (f32: FLASH_F32_TOL), with their
    times."""
    dev = torch.device("cuda")
    print(f"phase {phase} flash shapes: the kernel against its plain version "
          f"at the {len(shapes)} shapes phase {phase}'s fits launched it "
          f"at, on seeded inputs; tolerance as phase 12's")
    check(shapes, f"{phase}: no flash shape recorded")
    for (dtype, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap), parts in \
            sorted(shapes.items(), key=str):
        check(causal and Sq == Skv, f"{phase}: flash shape causal {causal}, "
              f"Sq {Sq}, Skv {Skv} outside the check's (causal, Sq = Skv)")
        flash_model_shape(dev, card, dtype, f"{phase}"
                          f"{'/'.join(sorted(parts))} "
                          f"{'member, ' if phase == '20' else ''}B {B} S "
                          f"{Sq}", B, Sq, Hq, Hkv, D, window, softcap)


def phase20(card):
    """Phase 20's five parts and the flash kernel at their shapes; the kernels' launches over its fits (20e's
    one rank's)."""
    walls = {}
    t0 = time.perf_counter()
    a = phase20a(card)
    walls["20a"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b, zero1_losses = phase20b(card)
    walls["20b"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = phase20c(card)
    walls["20c"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase20d(card)
    walls["20d"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    e = phase20e(card, zero1_losses)
    walls["20e"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    phase20_flash_shapes(card)
    walls["flash shapes"] = round(time.perf_counter() - t0, 1)
    total = _sum_counts(a, b, c, e)
    print(f"  phase 20 wall seconds by part {walls}; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


# ---------------------------------------------------------------------------
# phase 21: q heads that do not split, activation checkpointing, the
# planning tools and the examples
# ---------------------------------------------------------------------------
TOOLS_VL_WAYS = 8                  # qwen2-vl-2b's 12 q heads over 8 ways
TOOLS_VL_SEQ = 1024 + 1024         # vision stub tokens + text
TOOLS_VL_STEPS = 2
REMAT_STEPS = 2
DRYRUN_PAIRS = (("gemma2-2b", "train_4k", False),
                ("llama3-8b", "decode_32k", False),
                ("mixtral-8x22b", "train_4k", True))
# every flash kernel shape phase 21 hands the kernel (as phase 20's)
FLASH_TOOLS_SHAPES = {}


def _drop_run(run):
    run.close()
    run.params = run.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()


def phase21a(card):
    """qwen2-vl-2b at full width under dp at ``{data: 1, model: 8}``: its 12
    q heads do not split over the 8 ways while its q_dim does (the rules
    shard ``wq``), so each member takes the four projections whole.  Two
    steps, each loss held to the serial run's from the same seed, then
    phase 20's gate: one forward and backward against the serial route on
    the same params and batch, every gradient leaf (``gather_leaf``'s
    backward of ``wq`` / ``wk`` / ``wv`` / ``wo``, the dp gradient at 8
    ways) held to the sensitivity-scaled tolerance."""
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for ways in (1, TOOLS_VL_WAYS):
        spec = RunSpec(arch="qwen2-vl-2b", steps=TOOLS_VL_STEPS, batch=1,
                       seq=TOOLS_VL_SEQ, seed=0, log_every=1, parallel="dp",
                       mesh=MeshSpec(members_per_device=1, model_ways=ways))
        run = use_kernel(compile_run(spec))
        cfg = run.cfg
        if ways > 1:
            check(run.ctx.sharded(layers.attn_specs(cfg)["wq"])
                  and cfg.num_heads % ways and cfg.q_dim % ways == 0,
                  f"21a: {cfg.num_heads} q heads at {ways} ways is not the "
                  f"case of q heads that do not split")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _counts_zeroed()
        with flash_shapes_recorded(FLASH_TOOLS_SHAPES, "a"):
            hist = run.fit(log_fn=lambda line: None)
        torch.cuda.synchronize()
        counts = _counts()
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = TOOLS_VL_STEPS * cfg.num_layers
        check(counts == want, f"21a: launches {counts}, want {want}")
        losses = [h["loss"] for h in hist]
        check(len(losses) == TOOLS_VL_STEPS
              and all(np.isfinite(x) for x in losses),
              f"21a: history {hist}")
        out[ways] = (losses, time.perf_counter() - t0, counts)
        print(f"  21a: {cfg.name} dp on {run.mesh}: {TOOLS_VL_STEPS} steps "
              f"of 1 x {TOOLS_VL_SEQ} positions, losses {losses}, "
              f"{out[ways][1]} s with the first step's set-up, launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]")
        if ways == 1:
            _drop_run(run)
    got, want = out[TOOLS_VL_WAYS][0], out[1][0]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"  21a: {cfg.num_heads} q heads over {TOOLS_VL_WAYS} ways, losses "
          f"{got} against the serial run's {want}: relative {rel}, "
          f"tolerance {LM_LOSS_REL_TOL}")
    check(max(rel) <= LM_LOSS_REL_TOL, "21a: the losses differ from serial")
    _lm_gate(run, next(run.data), card, "a", phase="21")
    return _sum_counts(out[TOOLS_VL_WAYS][2], out[1][2])


def phase21b(card):
    """gemma2-2b at phase 13's size, ``remat="block"`` against ``"none"``:
    two fits from the same seed, then one forward and backward of each on
    the same params and batch with the optimizer state freed."""
    from repro_torch.api import RunSpec, compile_run
    from repro_torch.core.params import tree_leaves
    from repro_torch.launch.paper_cnn_training import kernel_loss, use_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    fits, total = {}, {}
    base = _lm_cfg("gemma2-2b")
    for remat in ("none", "block"):
        spec = RunSpec(arch=base.replace(remat=remat), steps=REMAT_STEPS,
                       batch=LM_BATCH, seq=LM_SEQ, seed=0, log_every=1)
        spans = SyncedSpans()
        run = use_kernel(compile_run(spec, recorder=spans))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _counts_zeroed()
        with flash_shapes_recorded(FLASH_TOOLS_SHAPES, "b"):
            hist = run.fit(log_fn=lambda line: None)
        torch.cuda.synchronize()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        per_step = base.num_layers * (2 if remat == "block" else 1)
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = REMAT_STEPS * per_step
        check(counts == want, f"21b {remat}: launches {counts}, want {want}")
        step_ms = float(np.median(spans.samples["step"][1:])) * 1e3
        fits[remat] = ([h["loss"] for h in hist], step_ms, peak)
        total = _sum_counts(total, counts)
        print(f"  21b remat={remat}: {REMAT_STEPS} steps of {LM_BATCH} x "
              f"{LM_SEQ} tokens, losses {fits[remat][0]}; step {step_ms} ms "
              f"(step 2), peak {peak} GB with AdamW; flash launches "
              f"{counts['flash_attention']} = {REMAT_STEPS} x {per_step} "
              f"[{card}]")
        if remat == "none":
            _drop_run(run)
    # one pass of each on the block run's params and next batch
    batch = next(run.data)
    run.close()
    run.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    passes = {}
    for remat in ("none", "block"):
        torch.cuda.reset_peak_memory_stats()
        loss, grads = _lm_pass(kernel_loss(base.replace(remat=remat)),
                               run.params, batch)
        passes[remat] = (loss, [g.cpu() for g in grads],
                         torch.cuda.max_memory_allocated() / 1e9)
        del grads
    # the recompute runs the same kernels on the same inputs in the same
    # order, so remat's result is bitwise that of "none": every gradient
    # leaf, the loss and the fits' histories must be equal, not close
    names = list(_leaf_names(run.params))
    differ = [n for n, a, b in zip(names, passes["block"][1],
                                   passes["none"][1]) if not torch.equal(a, b)]
    print(f"  21b one forward and backward on the same params and batch, "
          f"AdamW freed: loss {passes['block'][0]} (block) vs "
          f"{passes['none'][0]} (none); gradient leaves not bitwise equal: "
          f"{len(differ)} of {len(names)} {differ[:4]}; peak "
          f"{passes['block'][2]} GB (block) vs {passes['none'][2]} GB "
          f"(none) [{card}]")
    check(passes["block"][0] == passes["none"][0],
          "21b: remat moved the loss")
    check(not differ, f"21b: remat moved the gradients of {differ}")
    check(fits["block"][0] == fits["none"][0],
          f"21b: histories differ {fits['block'][0]} {fits['none'][0]}")
    check(passes["block"][2] < passes["none"][2],
          "21b: remat did not lower the peak")
    del passes
    run.params = None
    gc.collect()
    torch.cuda.empty_cache()
    return total, fits["block"][1]


def phase21c(card, block_step_ms):
    """The gemma2-2b step of 21b counted on the card and on ``meta``, the
    roofline's terms against the measured step, then the dry run of three
    pairs of the production meshes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import RunSpec, compile_run
    from repro_torch.configs.base import H100_SXM_BF16, InputShape
    from repro_torch.core.sharding import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LocalMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg("gemma2-2b", remat="block")
    spec = RunSpec(arch=cfg, steps=1, batch=LM_BATCH, seq=LM_SEQ, seed=0,
                   log_every=1)
    run = compile_run(spec)            # the plain route, the dry run's
    batch = next(run.data)
    _counts_zeroed()
    with FlopCounterMode(display=False) as fc:
        run.train_step(run.params, run.opt_state, 0, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    plain_ms = cuda_ms(lambda: run.train_step(run.params, run.opt_state, 1,
                                              batch), 1, 3)
    counts = _counts()
    check(not any(counts.values()), f"21c: the plain route launched "
          f"{counts}")
    _drop_run(run)
    shape = InputShape("2x1024", LM_SEQ, LM_BATCH, "train")
    t0 = time.perf_counter()
    meta_flops, meta_bytes, coll = dryrun.count_step(
        cfg, shape, LocalMesh(1, device="meta"), ShardingRules())
    meta_s = time.perf_counter() - t0
    hw = H100_SXM_BF16
    compute_ms = meta_flops / hw.peak_flops * 1e3
    memory_ms = meta_bytes / hw.mem_bw * 1e3
    print(f"  21c gemma2-2b, remat=block, {LM_BATCH} x {LM_SEQ} tokens: "
          f"FlopCounterMode over one train step on the card {card_flops}, on "
          f"meta {meta_flops} (counted in {meta_s} s); the roofline at that "
          f"size (data sheet {hw.name}): compute {compute_ms} ms, memory "
          f"{memory_ms} ms ({meta_bytes} bytes by the byte counter's rule), "
          f"collective bytes {coll.ring_bytes}; measured step "
          f"{block_step_ms} ms on the kernel route (21b), {plain_ms} ms on "
          f"the plain route [{card}]")
    check(card_flops == meta_flops, "21c: the card's count differs from "
          "meta's")
    for arch, shape_name, multi in DRYRUN_PAIRS:
        row = dryrun.count_pair(arch, shape_name, multi, verbose=False)
        keys = ("dominant", "compute_s", "memory_s", "collective_s",
                "useful_ratio", "mfu", "mem_state_per_dev_gb", "coll_counts",
                "t_count_s", "plan_G", "plan_model_ways")
        print(f"  21c dry run {arch} x {shape_name} x {row['mesh']}: "
              f"{ {k: row[k] for k in keys} } (modelled from the data "
              f"sheet, {hw.name})")
        check(0 < row["useful_ratio"] <= 1.05,
              f"21c: {arch} x {shape_name} useful_ratio "
              f"{row['useful_ratio']}")


def phase21d(card):
    """The three examples on the card: quickstart as it stands,
    ``train_lm_100m --steps 30 --use-kernel`` twice (the second resumes
    with nothing to train), ``serve_batched`` on gemma2-2b."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart, serve_batched, train_lm_100m
    layers = get_config("llama-100m").num_layers
    total = {}
    _counts_zeroed()
    hist, out = quickstart.main([])
    torch.cuda.synchronize()
    counts = _counts()
    check(np.isfinite(hist[-1]["loss"]) and out.shape[0] == 2,
          f"21d quickstart: {hist[-1]}, {tuple(out.shape)}")
    print(f"  21d quickstart: losses {[h['loss'] for h in hist]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    total = _sum_counts(total, counts)
    with tempfile.TemporaryDirectory() as d:
        argv = ["--steps", "30", "--use-kernel", "--ckpt-dir", d]
        _counts_zeroed()
        t0 = time.perf_counter()
        with flash_shapes_recorded(FLASH_TOOLS_SHAPES, "d"):
            hist = train_lm_100m.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = 30 * layers
        check(counts == want, f"21d train_lm_100m: launches {counts}, want "
              f"{want}")
        check(hist and hist[-1]["step"] == 30, f"21d: history {hist}")
        again = train_lm_100m.main(argv)
        check(again == [], f"21d: the second run trained {again}")
        rows = open(os.path.join(d, "history.csv")).read().splitlines()
        print(f"  21d train_lm_100m --use-kernel: 30 steps in {wall} s with "
              f"the checkpoint write, losses {[h['loss'] for h in hist]}, "
              f"flash launches {counts['flash_attention']} = 30 x {layers}; "
              f"the "
              f"second run trained nothing; {sorted(os.listdir(d))}, "
              f"history.csv {len(rows)} lines [{card}]")
        total = _sum_counts(total, counts)
    _counts_zeroed()
    server, done = serve_batched.main(["--arch", "gemma2-2b"])
    torch.cuda.synchronize()
    counts = _counts()
    steps = server.stats["steps"]
    check(len(done) == 12 and all(
        0 <= t < server.cfg.vocab_size for r in done for t in r.tokens),
        f"21d serve_batched: {len(done)} requests")
    check(counts["paged_decode_attention"] == steps * server.cfg.num_layers
          and counts["flash_attention"] == 0,
          f"21d serve_batched: launches {counts} in {steps} steps")
    print(f"  21d serve_batched: {len(done)} requests in {steps} steps, paged "
          f"launches {counts['paged_decode_attention']} = steps x "
          f"{server.cfg.num_layers} [{card}]")
    return _sum_counts(total, counts)


def phase21(card):
    """Phase 21's four parts and the flash kernel at their shapes; the
    kernels' launches over its main paths."""
    walls = {}
    t0 = time.perf_counter()
    a = phase21a(card)
    walls["21a"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    b, block_ms = phase21b(card)
    walls["21b"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    phase21c(card, block_ms)
    walls["21c"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d = phase21d(card)
    walls["21d"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    phase20_flash_shapes(card, FLASH_TOOLS_SHAPES, "21")
    walls["flash shapes"] = round(time.perf_counter() - t0, 1)
    total = _sum_counts(a, b, d)
    print(f"  phase 21 wall seconds by part {walls}; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


# ---------------------------------------------------------------------------
# phase 22: several members a process and model ways on the cluster (module
# docstring); each rank's launches and step times from its trace
# ---------------------------------------------------------------------------
CLUSTER_LOCAL_STEPS = 3
CLUSTER_LOCAL_CHAOS_STEPS = 6


def dnn_buckets(G):
    """The fusion buckets of full-width CD-DNN at G members and the default
    4 MiB target (as ``vgg_buckets``)."""
    from repro_torch.comm import CommConfig, plan_buckets
    from repro_torch.configs import get_config
    from repro_torch.models import dnn
    meta = {k: torch.empty(sp.shape, device="meta")
            for k, sp in dnn.param_specs(get_config("cd-dnn")).items()}
    return plan_buckets(meta, G, CommConfig().bucket_bytes)


def _local_cluster(tag, argv, d, env, card, rel_gate=True):
    """The cluster CLI at 2 processes of 2 local members on the card, with a
    trace: its output, each rank's launches and step seconds (a rank whose
    trace has no closing metrics, the chaos run's killed attempt, is left
    out).  Under ``--verify`` the CLI's own gate must pass and, with
    ``rel_gate``, phase 15b's: the final loss within RESUME_REL_TOL of the
    one-process run's (an int8 run is held to the CLI's gate alone: its
    messages are rounded to 8 bits, the one-process run's are not)."""
    import re
    trace = os.path.join(d, tag)
    argv = ["--processes", "2", "--local-devices", "2", *argv,
            "--use-kernel", "--trace-dir", trace,
            "--run-dir", os.path.join(d, tag + "-run")]
    out, wall = _cli("repro_torch.launch.cluster", argv, env)
    ranks = []
    for r in range(2):
        path = os.path.join(trace, f"trace_p{r}.jsonl")
        try:
            events = _trace_events(path)
        except (OSError, ValueError):   # none, or a killed rank's, cut short
            continue
        if any(e.get("kind") == "metrics" for e in events):
            ranks.append((_trace_launches(path), _trace_steps(path)))
    verify = None
    if "--verify" in argv:
        m = re.search(r"\[cluster\] verify: cluster=(\S+) single=(\S+) "
                      r"\|diff\|=(\S+) tol=(\S+) OK", out.stdout)
        check(m, f"{tag}: no passing verify line in:\n{out.stdout[-3000:]}")
        cluster, single = float(m.group(1)), float(m.group(2))
        tol = RESUME_REL_TOL * abs(single) if rel_gate else float(m.group(4))
        check(abs(cluster - single) <= tol,
              f"{tag}: cluster final loss {cluster} vs one process {single}"
              f": |diff| {abs(cluster - single)} > {tol}")
        verify = (cluster, single, abs(cluster - single), tol)
    print(f"phase {tag}: python -m repro_torch.launch.cluster "
          f"{' '.join(argv).replace(d, 'D')}: exit 0 in {wall} s; verify "
          f"(cluster, one process, |diff|, gate) {verify} [{card}]")
    for r, (counts, steps) in enumerate(ranks):
        print(f"  rank {r}: launches { {k: v for k, v in counts.items() if v} }"
              f"; step seconds (step spans, each ending in a device sync) "
              f"{steps} [{card}]")
    return out, ranks


def _want_launches(tag, counts, want):
    got = {k: counts.get(k, 0) for k in want}
    check(got == want, f"{tag}: rank 0 launched {counts}, want {want}")


def phase22(card):
    """Phase 22 (module docstring): rank 0's launches on its four runs,
    summed."""
    import ast
    import re
    import shutil
    d = tempfile.mkdtemp(prefix="cluster22-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    steps = CLUSTER_LOCAL_STEPS
    try:
        # (a) model ways in each process
        out, ranks = _local_cluster(
            "22a", ["--model-ways", "2", "--arch", "vgg-a", "--parallel",
                    "zero1", "--batch", "64", "--steps", str(steps),
                    "--schedule", "constant", "--verify"], d, env, card)
        check("ClusterMesh({'pod': 2, 'data': 1, 'model': 2}" in out.stdout
              and "L=2, model ways M=2" in out.stdout,
              f"22a: mesh not (2, 1, 2):\n{out.stdout[-3000:]}")
        check(len(ranks) == 2, "22a: a rank's trace has no counters")
        a = ranks[0][0]
        # a member's half of every conv's output channels; one cross-pod hop
        # a bucket of the full tree (G = 2 data members); no in-pod level
        _want_launches("22a", a, {
            "conv2d_nhwc": 16 * steps,
            "ring_hop_accum": vgg_buckets(2).n_collectives * steps,
            "ring_reduce_scatter": 0, "ring_all_gather": 0})

        # (b) the chaos kill at 2 local members, then world 2 unkilled
        dnn = ["--arch", "cd-dnn", "--parallel", "zero1", "--batch",
               str(DNN_BATCH), "--schedule", "constant"]
        out, ranks = _local_cluster(
            "22b", [*dnn, "--steps", str(CLUSTER_LOCAL_CHAOS_STEPS),
                    "--ckpt-every", "2", "--ckpt-dir",
                    os.path.join(d, "ckpt"), "--chaos-kill-step", "3",
                    "--verify"], d, env, card)
        attempts = re.findall(r"\[elastic\] (attempt \d+[^\n]*)", out.stdout)
        check([x.split(":")[0] for x in attempts] == [
            "attempt 0", "attempt 0 failed", "attempt 1"]
            and "world=2" in attempts[0] and "world=1" in attempts[2]
            and "chaos: SIGKILL worker 1" in out.stdout,
            f"22b: attempts {attempts}: want world 2, the kill, world 1")
        # the one failure is the chaos kill (phase 15b's gate)
        codes = ast.literal_eval(re.search(r"exit codes ([^)]*)\)",
                                           attempts[1]).group(1))
        check(codes.get(1) == -9 and all(c > 0 for w, c in codes.items()
                                         if w != 1),
              f"22b: dead workers' exit codes {codes}: want worker 1 "
              f"SIGKILLed (-9), any other an error exit after it")
        check("ClusterMesh({'pod': 2, 'data': 2, 'model': 1}" in out.stdout
              and "mesh=LocalMesh({'data': 2, 'model': 1}" in out.stdout,
              f"22b: want mesh (2, 2, 1), then a 2-member local mesh:\n"
              f"{out.stdout[-3000:]}")
        m = re.search(r"resuming from checkpoint step (\d+)", out.stdout)
        check(m and int(m.group(1)) in (2, 4), f"22b: no resume from an "
              f"even step before the end:\n{out.stdout[-3000:]}")
        resumed = CLUSTER_LOCAL_CHAOS_STEPS - int(m.group(1))
        # attempt 1's worker 0 rewrote trace_p0: world 1, the resumed steps
        nb = dnn_buckets(2).n_collectives
        b1 = ranks[0][0]
        _want_launches("22b world 1", b1, {
            "blocked_matmul": 8 * resumed,
            "ring_reduce_scatter": nb * resumed,
            "ring_all_gather": nb * resumed, "ring_hop_accum": 0})
        print(f"  22b: {attempts}; resumed from step {m.group(1)}: "
              f"{resumed} steps at world 1 on the 2-member local mesh")
        out, ranks = _local_cluster(
            "22b-w2", [*dnn, "--steps", str(steps)], d, env, card)
        check(len(ranks) == 2, "22b world 2: a rank's trace has no counters")
        nb = dnn_buckets(4).n_collectives
        b2 = ranks[0][0]
        # per bucket: the in-pod ring over the rank's 2 members, one hop
        # across the pods for both members' chunks, the in-pod gather
        _want_launches("22b world 2", b2, {
            "blocked_matmul": 8 * steps, "ring_reduce_scatter": nb * steps,
            "ring_hop_accum": nb * steps, "ring_all_gather": nb * steps})

        # (c) int8 at both levels
        out, ranks = _local_cluster(
            "22c", [*dnn, "--steps", str(steps), "--wire-format", "int8",
                    "--verify"], d, env, card, rel_gate=False)
        check(len(ranks) == 2, "22c: a rank's trace has no counters")
        c = ranks[0][0]
        # per bucket: the in-pod ring's first quantize and one hop, both
        # member-batched; across the pods each member's own ring, its
        # quantize and its one hop
        _want_launches("22c", c, {
            "blocked_matmul": 8 * steps, "int8_quantize": 3 * nb * steps,
            "ring_hop_int8": 3 * nb * steps, "ring_all_gather": nb * steps,
            "ring_reduce_scatter": 0, "ring_hop_accum": 0})
        return _sum_counts(a, b1, b2, c)
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: the process path, two members as two processes on the card
# ---------------------------------------------------------------------------
PROCESS_MEMBERS = 2
PROCESS_FORMATS = ("fp32", "int8", "topk")
PROCESS_OVERLAP_BATCH = 8


def _process_member(rank, world, init_file, results):
    """One member of phase 7: the zero1 update of full-width VGG-A over a
    ProcessMesh, under each wire format, against the same update over a
    LocalMesh in this process."""
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        from repro_torch.comm import CommConfig
        from repro_torch.configs import get_config
        from repro_torch.kernels import ring as kring
        from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
        from repro_torch.models import cnn
        from repro_torch.optim import MomentumSGD
        from repro_torch.optim.dist import (make_distributed_update,
                                            make_topk_ef_update)
        dev = torch.device("cuda", 0)
        opt = MomentumSGD(momentum=0.9)
        p0 = cnn.init_params(get_config("vgg-a"), 0, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        # every member's gradient is the same global one
        grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
                 for k, p in p0.items()}
        local_mesh = make_local_mesh(world, device=dev)
        proc_mesh = make_process_mesh(device=dev)
        out = {}
        for fmt in PROCESS_FORMATS:
            comm = CommConfig(backend="pallas-ring", wire_format=fmt,
                              topk_ratio=TOPK_RATIO)
            make = make_topk_ef_update if fmt == "topk" \
                else make_distributed_update
            local = {k: v.clone() for k, v in p0.items()}
            init_l, update_l = make(opt, local_mesh, ("data",), comm)
            _, s_l = update_l(local, grads, init_l(local), 5e-3, 0)
            params = {k: v.clone() for k, v in p0.items()}
            init_p, update_p = make(opt, proc_mesh, ("data",), comm)
            state = init_p(params)
            torch.cuda.synchronize()
            kring.reset_launches()
            t0 = time.perf_counter()
            _, s_p = update_p(params, grads, state, 5e-3, 0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(kring.launches)
            same = all(torch.equal(params[k], local[k]) for k in params)
            if fmt == "topk":
                same = same and all(
                    torch.equal(a, b[rank])
                    for a, b in zip(s_p["residual"], s_l["residual"]))
            out[fmt] = (counts, same, dt)
            del local, params, state, s_l, s_p
        out["overlap"] = _process_overlap_step(opt, p0, local_mesh, proc_mesh,
                                               dev)
        # the plain reduce-scatter of card buffers over gloo would sum them
        # in host memory: it must refuse, not fall back
        from repro_torch.core.collectives import part_reduce
        try:
            part_reduce(torch.ones(2 * world, device=dev), proc_mesh, "data")
            raise RuntimeError("the plain reduce-scatter summed card buffers "
                               "over gloo instead of refusing")
        except NotImplementedError:
            pass
        results.put((rank, out, None))
        code = 0
    except Exception:
        results.put((rank, None, traceback.format_exc()))
        code = 1
    # the result is sent (the queue flushed); gloo's own teardown has
    # aborted a rank under load after that ("terminate called without an
    # active exception", tests/test_torch_dist.py), so a member that
    # succeeded waits for the others, and every member leaves without it
    results.close()
    results.join_thread()
    if code == 0:
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _process_overlap_step(opt, p0, local_mesh, proc_mesh, dev):
    """One overlapped zero1 step of full-width VGG-A (batch
    ``PROCESS_OVERLAP_BATCH``, grad_clip=0, deterministic cuDNN) on the
    ProcessMesh and on a LocalMesh from the same params and batch: (the
    process step's launches, whether its params equal the local step's
    bitwise, its seconds)."""
    from repro_torch.comm import CommConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ring as kring
    from repro_torch.models import cnn
    from repro_torch.optim.dist import make_overlapped_update
    from repro_torch.optim.schedule import constant
    from repro_torch.train import make_overlapped_train_step
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("vgg-a")
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"images": torch.randn(PROCESS_OVERLAP_BATCH, cfg.image_size,
                                   cfg.image_size, 3, generator=gen,
                                   device=dev),
             "labels": torch.randint(0, cfg.num_classes,
                                     (PROCESS_OVERLAP_BATCH,), generator=gen,
                                     device=dev)}
    comm = CommConfig(backend="pallas-ring", overlap=True)
    got = {}
    for name, mesh in (("local", local_mesh), ("process", proc_mesh)):
        init_fn, local_update = make_overlapped_update(opt, mesh, ("data",),
                                                       comm)
        step = make_overlapped_train_step(
            lambda p, b: cnn.loss_fn(p, cfg, b), constant(5e-3), mesh,
            ("data",), comm, local_update, grad_clip=0.0)
        params = {k: v.clone() for k, v in p0.items()}
        state = init_fn(params)
        torch.cuda.synchronize()
        kring.reset_launches()
        t0 = time.perf_counter()
        params, _, _ = step(params, state, 0, batch)
        torch.cuda.synchronize()
        got[name] = (params, dict(kring.launches), time.perf_counter() - t0)
    same = all(torch.equal(got["process"][0][k], got["local"][0][k])
               for k in p0)
    return got["process"][1], same, got["process"][2]


def phase7(card):
    G = PROCESS_MEMBERS
    n_buckets = vgg_buckets(G).n_collectives
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(), "init")
    procs = [ctx.Process(target=_process_member,
                         args=(r, G, init_file, results)) for r in range(G)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=900) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    # the kernel each format's hop runs, and how often a member launches it
    hop = {"fp32": {"ring_hop_accum": n_buckets * (G - 1)},
           "int8": {"int8_quantize": n_buckets,
                    "ring_hop_int8": n_buckets * (G - 1)},
           "topk": {"ring_hop_topk": n_buckets * (G - 1)},
           "overlap": {"ring_hop_accum": n_buckets * (G - 1)}}
    for rank, out, err in got:
        check(err is None, f"process member {rank} failed:\n{err}")
        for fmt, (counts, same, dt) in out.items():
            want = {k: hop[fmt].get(k, 0) for k in counts}
            check(counts == want, f"process member {rank} {fmt} launches "
                  f"{counts}, want {want}")
            check(same, f"process member {rank} {fmt}: params"
                  f"{' or residual' if fmt == 'topk' else ''} differ from "
                  f"the local mesh's{' overlapped step' if fmt == 'overlap' else ''}")
    for rank, p in enumerate(procs):
        check(p.exitcode == 0, f"process member {rank} exited with code "
              f"{p.exitcode}")
    for fmt in PROCESS_FORMATS:
        print(f"phase 7 ({fmt}): zero1 update of full-width VGG-A by {G} "
              f"processes on one card over gloo (messages staged through "
              f"host memory), {n_buckets} buckets: each member launched "
              f"{ {k: v for k, v in got[0][1][fmt][0].items() if v} }; "
              f"params{' and residual' if fmt == 'topk' else ''} bitwise "
              f"equal to a local mesh's on every member; update "
              f"{[r[1][fmt][2] for r in got]} s per member (host-bound) "
              f"[{card}]")
    print(f"phase 7 (overlap): one overlapped zero1 step of full-width VGG-A "
          f"(batch {PROCESS_OVERLAP_BATCH}, grad_clip=0, deterministic "
          f"cuDNN) by {G} processes, each bucket's reduce issued inside the "
          f"backward: each member launched "
          f"{ {k: v for k, v in got[0][1]['overlap'][0].items() if v} }; "
          f"params bitwise equal to a local mesh's overlapped step on every "
          f"member; step {[r[1]['overlap'][2] for r in got]} s per member "
          f"[{card}]")
    return (got[0][1]["fp32"][0]["ring_hop_accum"],
            got[0][1]["overlap"][0]["ring_hop_accum"])


def _leaf_names(tree, prefix=""):
    """Names of a tree's leaves, in ``_leaves``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaf_names(t, f"{prefix}[{i}]")
    else:
        yield prefix


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def instance_name(entry):
    """A compiled kernel instance's name for the build lines, from its
    mangled entry: the flash kernels' head dim, the GEMM's input type and
    tile, the conv's instance and tile."""
    import re
    if m := re.search(r"flash_tc_kernelILi(\d+)E", entry):
        return f"bf16 wgmma D {m.group(1)}"
    if m := re.search(r"flash_f32_kernelILi(\d+)E", entry):
        return f"f32 bf16x6 wgmma D {m.group(1)}"
    if m := re.search(r"split_kv_kernelILb(\d)E", entry):
        return f"f32 K/V split, {'16-byte' if m.group(1) == '1' else '4-byte'} loads"
    if m := re.search(r"blocked_matmul_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                      r"(\d+)E", entry):
        kind = "f32 3xTF32" if m.group(1) == "f" else "bf16"
        return f"{kind} wgmma {m.group(2)} x {m.group(3)}"
    if m := re.search(r"conv2d_nhwc_kernel_wsILi(\d+)E", entry):
        return f"f32 3xTF32 wgmma warp-specialised 128 x {m.group(1)}"
    if "conv2d_nhwc_kernel_split_w" in entry:
        return "f32 weight split"
    if m := re.search(r"conv2d_nhwc_kernelILi(\d+)E", entry):
        return f"f32 3xTF32 wgmma 128 x {m.group(1)}"
    return entry


def build_lines(log):
    """One line per compiled instance from ``-Xptxas -v``: its name, its
    spills and its registers; and every ptxas warning in full (a
    serialized-wgmma note among them)."""
    import re
    out, inst = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance_name(m.group(1))
        elif "spill" in line and inst:
            out.append(f"{inst}: {line.strip()}")
        elif "Used" in line and "registers" in line and inst:
            out[-1] += f"; {line.split(':', 1)[1].strip()}"
        elif "warning" in line or "Performance Loss" in line:
            out.append(line.strip())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    names = ("paged_attn", "conv2d", "ring", "ring_wire", "blocked_matmul",
             "flash_attention")

    def timed_build(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        secs = dict(zip(names, pool.map(timed_build, names)))
    print(f"phase 0: built {', '.join(f'{n} in {secs[n]:.2f} s' for n in names)}"
          f", all in {time.perf_counter() - t0:.2f} s")
    for name in names:
        lines = build_lines(build.BUILD_LOG.get(name, ""))
        for line in lines:
            print(f"  {name}: {line}")
        if name in ("blocked_matmul", "conv2d", "flash_attention"):
            # the wgmma kernels: no spill, no ptxas warning
            check(not any("warning" in x or "Performance Loss" in x or
                          (" 0 bytes spill stores" not in x and "spill" in x)
                          for x in lines),
                  f"{name}: ptxas spilled or serialized the wgmmas")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    paged = timed("1", phase1, dev)
    paged["launches"] = timed("2", phase2, card)
    torch.cuda.reset_peak_memory_stats()
    conv = timed("3", phase3, dev, card)
    conv["launches"] = timed("4", phase4, card)
    hop, rs, ag = timed("5", phase5, dev, card)
    counts = timed("6", phase6, card)
    rs["launches"] = counts["ring_reduce_scatter"]
    ag["launches"] = counts["ring_all_gather"]
    wire = timed("8", phase8, dev, card)
    int8 = timed("9 int8", phase9, card, "int8")
    topk = timed("9 topk", phase9, card, "topk")
    timed("9 topk 0.25", phase9, card, "topk", 0.25)   # BENCH_fig5's ratio
    for w in wire:
        w["launches"] = (topk if w["name"] == "ring_hop_topk"
                         else int8)[w["name"]]
    gemm = timed("10", phase10, dev, card)
    gemm["launches"], dnn_rs, dnn_ag = timed("11", phase11, card)
    print(f"CD-DNN zero1 path (phase 11): ring_reduce_scatter {dnn_rs}, "
          f"ring_all_gather {dnn_ag} launches")
    flash, flash_f32 = timed("12", phase12, dev, card)
    flash_f32["launches"] = timed("12 f32 path", phase12_f32_path, dev,
                                  card)
    flash["launches"] = timed("13", phase13, card)
    ov = timed("14", phase14, card)
    resume = timed("15a", phase15a, card)
    cluster = timed("15b", phase15b, card)
    modes = timed("16", phase16, dev, card)
    paged["launches_moe"], flash["launches_moe"] = timed("17", phase17, card)
    paged["launches"] += paged["launches_moe"]
    flash["launches"] += flash["launches_moe"]
    flash["launches_families"] = timed("18", phase18, card)
    flash["launches"] += flash["launches_families"]
    hybrid = timed("19", phase19, card)
    lm_model = timed("20", phase20, card)
    tools = timed("21", phase21, card)
    cluster_local = timed("22", phase22, card)
    # the tools slice's launches (phase 21: C1's and remat's fits, the
    # examples) beside the flash and paged rows'
    flash["launches_tools"] = tools.get("flash_attention", 0)
    paged["launches_tools"] = tools.get("paged_decode_attention", 0)
    flash["launches"] += flash["launches_tools"]
    paged["launches"] += paged["launches_tools"]
    # the LMs' model-ways path's launches (phase 20; 20e's one rank's)
    for row, name in ((flash, "flash_attention"), (hop, "ring_hop_accum"),
                      (rs, "ring_reduce_scatter"), (ag, "ring_all_gather")):
        row["launches_lm_model"] = lm_model.get(name, 0)
    # the hybrid path's launches (phase 19; 19c's one rank) beside each row's
    for row, name in ((conv, "conv2d_nhwc"), (gemm, "blocked_matmul"),
                      (hop, "ring_hop_accum"), (rs, "ring_reduce_scatter"),
                      (ag, "ring_all_gather")):
        row["launches_hybrid"] = hybrid.get(name, 0)
    hop["launches"], ov["ring_hop_accum"] = timed("7", phase7, card)
    for row in (conv, gemm, hop, rs, ag):
        row["launches"] += row["launches_hybrid"]
    for row in (flash, hop, rs, ag):
        row["launches"] += row["launches_lm_model"]
    # the overlapped path's launches (phases 14 and 7) beside each row's
    for row, name in ((conv, "conv2d_nhwc"), (gemm, "blocked_matmul"),
                      (hop, "ring_hop_accum"), (rs, "ring_reduce_scatter"),
                      (ag, "ring_all_gather"), *((w, w["name"]) for w in wire)):
        row["launches_overlap"] = ov.get(name, 0)
        row["launches"] += row["launches_overlap"]
    # the resumed path's launches (phase 15a) and one cluster rank's
    # (phase 15b's world-2 run, rank 0) beside each row's
    for row, name in ((conv, "conv2d_nhwc"), (hop, "ring_hop_accum"),
                      (rs, "ring_reduce_scatter"), (ag, "ring_all_gather")):
        row["launches_resume"] = resume.get(name, 0)
        row["launches_cluster"] = cluster.get(name, 0)
        row["launches"] += row["launches_resume"] + row["launches_cluster"]
    # and the stale-sync, gossip and comm="auto" fits' (phase 16; the plan
    # comm="auto" picks decides which ring or wire kernels its fit runs)
    for row, name in ((conv, "conv2d_nhwc"), (gemm, "blocked_matmul"),
                      (hop, "ring_hop_accum"), (rs, "ring_reduce_scatter"),
                      (ag, "ring_all_gather"), *((w, w["name"]) for w in wire)):
        row["launches_modes"] = modes.get(name, 0)
        row["launches"] += row["launches_modes"]
    # the cluster's several members a process (phase 22, rank 0 of each run)
    for row, name in ((conv, "conv2d_nhwc"), (gemm, "blocked_matmul"),
                      (hop, "ring_hop_accum"), (rs, "ring_reduce_scatter"),
                      (ag, "ring_all_gather"), *((w, w["name"]) for w in wire)):
        row["launches_cluster_local"] = cluster_local.get(name, 0)
        row["launches"] += row["launches_cluster_local"]
    print(f"wall seconds per phase {walls}; all "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [paged, conv, hop, rs, ag, *wire, gemm,
                                  flash, flash_f32]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
