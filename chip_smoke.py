#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the paged serving engine on
SmolLM3-3B (bf16, and int8 weights over an int8 KV pool), the one-card
trainer on SmolLM3-3B-L8 (fp8 and int8 projections), the FSDP trainer
on SmolLM3-3B-L8 (``ring_fused_pallas``, one NCCL rank; and with int8
gathers, grads and Adam moments), with the hand-written Hopper kernels,
DDP and ZeRO-1/2/3 on the ZeRO toy MLP, the pipeline schedules, the
remat policies, preempt → resume under the run harness, the
mixture-of-experts model, tensor and sequence parallelism and the
composable dp x fsdp x tp step with FSDP's auto variant (one NCCL
rank), the serving frontier (the prefix cache and speculative
decoding), and the serving fleet (failover, shedding, hot-swap),
tensor-parallel and disaggregated serving and the MoE serve, the data
tier (the corpus and its held-out eval, the native data engine),
sentence-pair classification on the DDP twin, the model families
of the JAX package's registry (the flash kernels at hd 64 and 128), and
the observability tier (the pipeline twin under the run harness, the
collective ledger from the profiler's traces, the timeline export and
the cross-run report).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and nvcc.
TF32 is off for matmuls and cuDNN, so the plain paths are f32 oracles.
Phases, each of which fails the run:

1. card and build — print the card's name and power limit, build every
   kernel from ``csrc/`` (one nvcc per source, in parallel);
2. kernels — each kernel against its plain PyTorch version at the shapes
   its path gives it, at the tolerance its module states (K4 and K5 bit
   for bit), and launched twice on the same inputs with bit-equal
   results; K3 also over ``COMPARE_DRAWS`` draws of its serve shapes
   from each seed of ``K3_DRAW_SEEDS``, beside an f64 oracle of the
   reference's arithmetic, with each seed's count of outputs off the
   plain path gated, and K3's count off the oracle over the plain
   path's; the flash forward over ``FA_ORACLE_DRAWS`` draws beside its
   f64 oracle, its count off the oracle over the plain path's gated;
   the flash backward at a pipeline stage's microbatch (B 16, S 256)
   from each seed of ``FA_BWD_PIPE_SEEDS``, each grad's L2 distance from
   the exact f64 gradient over the plain path's gated;
   then CUDA-event times of the
   kernel, the plain version and a library yardstick (SDPA,
   ``torch._scaled_mm``, ``torch._int_mm``, ``torch.matmul``), beside
   the card's bound; K4 on each of its designs: the training products
   (wgmma), decode at M 1, 8 and 16 and the unembedding (the split-K
   GEMV, timed at M 8 in CUDA-graph replays beside ``torch._int_mm`` on
   the rows zero-padded to the fewest it takes) and one prefill chunk
   (M 256, mma.sync); at phase 20's shapes (``new_shapes_phase``): the
   flash kernels at hd 64 (``FA_HD64``; the oracle readings, the
   backward at B 16, S 256 over ``FA_HD64_BWD_SEEDS``), K6, K5 and K4
   at ``WIDE_CFGS``' projections;
3. serve — ``ServingEngine`` with K1 and K3 on SMOLLM3_3B (full width,
   all 36 layers, seeded random weights scaled ×3) answers 8 requests;
   launch counts must equal the steps × layers, plain counts must be 0;
4. parity — against the port's one-shot ``generate`` at the engine's
   view capacity: first tokens equal, the prefill logits through K3 and
   through the plain gather path within ``PREFILL_LOGIT_ATOL`` on the
   serve's first two prompts and on two prompts from each seed of
   ``PARITY_PROMPT_SEEDS`` (beside the logits through K3's f64 oracle,
   a second witness of how far any other summation order moves them),
   and one
   decode step's logits through the kernels and through the plain path
   from one pool state allclose;
5. train parity — SMOLLM3_3B_L8 at full width and depth, seq 8192: the
   step-0 loss and grads through K6 and the flash attention against the
   plain path (plain fp8 forward, plain attention) on the same params
   and batch, and the grads again with bf16 projections (flash against
   plain attention);
6. train — ``train.flagship.run_leg`` takes 6 AdamW steps on the card
   through K6 and the flash attention (forward and backward): launch
   counts exact, plain counts 0, losses finite and falling, the step-0
   loss bit-equal to phase 5's kernel path; step time,
   tokens/s, MFU, peak memory, and a ``torch.profiler`` breakdown of
   the last step;
7. int8 serve and parity — the SMOLLM3_3B weights through
   ``quantize_decode_params``, served with ``kv_quant`` through K2
   (decode attention) and K4 (every projection and the unembedding):
   launch counts exact, plain counts 0; every first token equals the
   port's one-shot ``generate(kv_quant=True)``, and one decode step's
   logits through K2 and K4 and through the plain path allclose;
8. int8 train parity and train — SMOLLM3_3B_L8 at ``int8_pallas_bwd``:
   the step-0 loss and every grad leaf through K5 (forward) and K4 (dX,
   dW) bit-equal to the plain int8 products, then 4 steps of
   ``run_leg`` with exact launch counts, as phase 6;
9. FSDP train parity and train — on a one-rank NCCL process group (the
   group ``torchrun --nproc-per-node 1`` would give), SMOLLM3_3B_L8 at
   seq 8192, batch 1, bf16: the step-0 loss and every grad leaf of the
   FSDP step at ``overlap="ring_fused_pallas"`` (every projection
   through K7) against ``overlap="none"`` (plain bf16 products), then 4
   steps of ``train.train_fsdp.run`` at ``ring_fused_pallas``: K7's
   launches exact (7 projections x 8 layers x 2, remat, a step), plain
   calls 0, losses finite and falling, the step-0 loss bit-equal to the
   parity's K7 path; step time, tokens/s, MFU, peak memory and a
   ``torch.profiler`` breakdown of the last step.  K7 itself is held
   against its plain version in phase 2, at the seven one-rank products
   and at a rank's K-chunks of a four-rank ring (Kc 512 and 2752, the
   activation a strided view);
10. ddp and zero — on the same one-rank NCCL group, the ZeRO toy MLP at
   full width (6 x Linear(10 000, 10 000), 600 060 000 f32 params, no
   kernel of the table: its products are cuBLAS's, as the reference's
   are XLA dots): ``train.ddp.run`` takes 6 SGD steps at batch 32 with
   per-leaf sync (the sync check reads 0.0; 12 init broadcasts; 14
   all_reduces a step; the first batch's loss lower under the final
   params), then ``train.zero.run`` 6 steps a leg at batch 16 for
   ZeRO-1 (both rebuilds), -2 and -3: every sharded leg equal to its
   baseline Adam leg in losses and final params bit for bit, the
   broadcast rebuild bit-equal to the all_gather one, the shim's counts a
   step the contracts' (``parallel.contracts``); step ms beside each
   step's byte bound (``STEP_BYTES_OVER_P``), optimizer MB, memory, and a
   ``torch.profiler`` breakdown of the last step of DDP, ZeRO-1 and
   ZeRO-3 (both legs);
11. pipeline — (a) the PP toy at full width (50 -> 4 x 500 -> 50) through
   ``train.pipeline.run``, 16 epochs each of GPipe and 1F1B at 2 stages
   and of interleaved 1F1B at 4 virtual stages on 2 logical devices of
   the card: each schedule's step 0 against one monolithic Adam step,
   GPipe against 1F1B, the pinned 1F1B tick trace, the high-water marks,
   no collective, the first batch's loss lower under the final params;
   (b) SMOLLM3_3B_L8 at full width as 4 stages of 2 layers on the card
   (seq 256, batch 64 in 4 microbatches, untied head, flash attention,
   the streamed loss, remat ``"full"``): the GPipe step 0 against one
   monolithic ``lm_loss`` step and against the same pipeline with plain
   attention, FA's launches exact, then 3 epochs each of GPipe and 1F1B
   through ``train.pipeline.run``: launches exact, plain calls 0, step
   ms, tokens/s, MFU, memory and a ``torch.profiler`` breakdown of the
   last step;
12. busbench — ``train.busbench.run`` on the one-rank group: every
   collective at 1, 16 and 128 MiB, bf16, the reference's schema and
   sizing, each output a copy of its input (one rank measures no link);
13. precision — on the same group: (a) SMOLLM3_3B_L8 at int8_pallas_bwd
   with flash attention, seq 8192, batch 1, through the FSDP step with
   int8 gathers, int8 grad reduce-scatters and int8 Adam moments: step
   0 bit-equal to the plain int8 products, the flash kernels on the
   step's own layer-0 attention inputs at FA's limits, the step against
   plain attention (``PREC_PLAIN_*``), the gathered weights bit for bit
   the int8 round-trip, launches and collectives exact (the latter
   ``parallel.contracts.fsdp_quantized_step_collectives``), the int8
   moments after two updates bit-equal to ``optim8.adam8_update`` on a CPU copy, the
   update's time beside its byte bound; then 4 steps of
   ``train_fsdp.run`` with those options (launches and collectives
   exact, step 0 bit-equal to the parity's, the moments' bytes at rest
   against bf16's, step time, MFU, peak, a profile of the last step);
   (b) the same model at bf16 under each remat policy, one step after a
   warm-up: the flash forward's launches (2·L, L under ``save_attn``),
   ``save_attn`` and ``save_dots`` bit-equal to ``full``,
   ``save_dots_q8``'s loss within ``REMAT_Q8_LOSS_RTOL`` and not closer
   than ``REMAT_Q8_LOSS_MIN_RTOL``, its kept bytes at most
   ``REMAT_Q8_SAVED_RATIO`` of ``save_dots``', each policy's peak and
   step time; (c) ``train.precision_benchmark.run_one`` at seq 2048 for
   bf16, int8_pallas_bwd and fp8_pallas (K6), each row's step 0 first
   on its own inputs: the flash kernels on its layer-0 attention inputs
   at FA's limits, int8 bit-equal to the plain products, K6 on the
   row's operands at its tolerance and the step against the plain fp8
   recipe; then the rows: the reference's row keys, step 0 bit-equal to
   the parity's, launches exact;
14. resilience — on the same group, the run harness (supervisor, RunState
   checkpoints over ``torch.distributed.checkpoint``, telemetry run,
   profiler, prefetcher, async step pump): (a) ``train_fsdp.run`` as
   phase 9 runs it (K7, the flash kernels), 6 steps with telemetry and
   the profiler on (the third step traced), uninterrupted and then
   preempted at step 3 (saves every 2 steps at the pump's sync points,
   one restart): the stitched losses bit-equal to the uninterrupted
   run's, K7's and FA's launches exact for each run and for the first
   segment, plain calls 0, the manifest's lineage (resumed from step 2, a
   preempted segment), every ``steps.jsonl`` line valid, checkpoint and
   prefetch spans, a trace written; it prints each save's bytes (bf16
   params, m and v), blocking and background ms, the restore's ms, the
   async step ms and the tracker's tokens/s beside phase 9's sync ones,
   and the traced step's idle share; (b) the ZeRO toy at full width:
   ``train.ddp.run`` preempted at step 3 and crashed at step 5 (saves
   every 2 steps), ``train.zero.run`` stage 3 preempted at step 3 of its
   sharded leg: stitched losses and final params bit-equal to the
   uninterrupted runs', ZeRO-3 bit-equal to its baseline Adam leg.
   Checkpoints go under a temporary directory, removed after each run;
   the free space is checked against the saves' bytes first;
15. moe — on the same group, SMOLLM3_3B_L8_MOE (8 experts of ffn 2752,
   top-1, grouped dispatch, cf 2.0) at full width, seq 8192, batch 1,
   flash attention, remat ``"full"``, through
   ``parallel.expert.make_moe_lm_train_step`` at dp 1 x ep 1: (a) step 0
   at int8_pallas_bwd through K5 and K4 bit-equal to the plain int8
   products (loss and every grad leaf, router and expert banks too),
   launches exact, each layer's drop fraction at init, and the loss the
   cross-entropy plus the weighted aux recomposed apart; (oracle)
   ``moe_mlp`` on layer 0's weights and normed embeddings against the
   script's own ``moe_oracle`` (capacity claimed first choices first,
   token by token on the host; each expert's products on its kept
   tokens only): top-1 at cf 0.75 and top-2 at cf 1.0 in f32, top-1 at
   cf 2.0 through K5 and K4, output and grads within
   ``MOE_ORACLE_REL_L2``; (b) step 0 at bf16 with the flash kernels
   against plain attention (``MOE_BF16_*``), the tokens routed to
   another expert logged; (c) 6 steps of ``train.moe.run`` at ep 1:
   launches exact, plain calls 0, every step's collectives the ``moe``
   contract's (``parallel.contracts.moe_step_collectives``), step 0
   bit-equal to (a), losses finite and falling; step ms, tokens/s, MFU
   on active FLOPs, peak memory and a ``torch.profiler`` breakdown of
   the last step by kernel and by the MoE layer's ranges;
16. tensor and sequence parallelism — on the same group: (a) layer 0 of
   the seeded SMOLLM3_3B_L8 cut by ``parallel.tensor.tp_specs`` for tp 2
   and 4, every rank, at M 8192: each shard's product at
   int8_pallas_bwd through K5 and K4 (dX, dW) bit-equal to the plain
   int8 products, one K5 and two K4 launches a product; the flash
   kernels on a rank's local heads (16/tp query, 4/tp KV: 4 and 1 at tp
   4) within FA's limits of plain attention (the grads by block and by
   their L2 distance from the exact f64 gradient over the plain path's,
   as at a pipeline stage); the row-parallel shards'
   f32 partials summed over the ranks within ``TP_PARTIAL_REL`` of the
   whole product; (b) ``tensor.make_tp_train_step`` at dp 1 x tp 1,
   int8_pallas_bwd, seq 8192: ``tp_lm_loss``'s step-0 loss and every
   grad leaf bit-equal to the plain int8 products, the step's loss the
   same, launches exact, its collectives the ``tp`` contract's; (c) ring
   attention at seq 16384 (B 1, 16 query and 4 KV heads, hd 128, bf16)
   over 4 virtual ranks in one process, every rank's blocks folded in
   hop order through ``ring_attention.contiguous_hop`` / ``zigzag_hop``
   (zigzag shuffled in, unshuffled out), forward and backward: O, dq,
   dk, dv against the flash kernels on the whole sequence (FA's limits)
   and against the exact f64 attention on slices of rows
   (``RING_ORACLE_TOL``), the merges counted (zigzag's score elements
   10/16 of the contiguous fold's at 4 ranks, the contiguous fold's
   unmasked share); (d) 6 steps each of ``train.train_tp.run`` at tp 1
   (bf16, flash), ``train.train_sp.run`` at sp 1 with
   ``overlap="ring_fused_pallas"`` (K7; the ring on its own block) and
   the dp x sp x ep MoE step at dp 1 x sp 1 x ep 1 on SMOLLM3_3B_L8_MOE
   at int8_pallas_bwd (K5, K4; the ring in place of the flash
   kernels): launches exact, plain calls 0, every step's collectives
   the contract's (``parallel.contracts``), losses finite and falling;
   step ms, tokens/s, MFU, peak memory; phase 16's wall time;
17. the composable step — on the same group, SMOLLM3_3B_L8 at seq 8192:
   (a) ``parallel.composable``'s dp x fsdp x tp step at 1 x 1 x 1
   (int8_pallas_bwd, flash): step-0 loss and every grad leaf bit-equal
   to the TP step's at dp 1 x tp 1 on phase 16b's shards and batch (K5,
   K4, FA), then 6 steps: launches exact, plain calls 0, every step's
   collectives the generated contract's (``analysis.contract_gen``),
   losses finite and falling; (b) the twin ``train.train_composable``
   at ``--mesh dp1xw3named --overlap ring_fused_pallas`` (K7, FA), its
   losses bit-equal to ``train.train_fsdp``'s with the same flags; (c)
   FSDP's auto variant over ``fully_shard`` (bf16, flash): step-0 loss
   and grads bit-equal to the explicit step's, then 6 steps as (a); (d)
   the laws more than one rank shows, on two gloo ranks of the host's
   CPU (TINY_LM): the 3-axis step's grads at tp 2 and at fsdp 2 and the
   auto variant's at 2 ranks against the one-process grads; step ms,
   tokens/s, MFU, peak memory; phase 17's wall time.  17d uses no card:
   ``tests/test_torch_composable_ranks.py`` and
   ``tests/test_torch_fsdp_auto.py`` hold the same laws against the JAX
   package.  It is hosted here so that ``chip_gate_mutation.py``'s three
   composable mutants, which change no value at one rank, have a gate of
   their own in the smoke (about 10 s);
18. the serving frontier — SmolLM3-3B at full width and depth (built
   again, weights x3), ``ENGINE``'s flags: (a) the prefix cache on
   ``frontier_trace`` (two tenants' 512-token system prompts, eight
   requests, one a tenant first, then the other six): hit pages 6 x 32
   and the lookups' sum, prefill chunks and K3's and K1's launches as
   the suffixes predict, plain calls 0, the CoW law (no write lands on a
   cached page, which keeps its bytes), the allocator law (free + cached
   = n_pages - 1), the six requests' TTFT beside an uncached engine's;
   (b) speculative decoding, k = ``SPEC_K``, on phase 3's requests at 4
   and at 36 draft layers: K1 = draft steps x draft layers, K3 = chunks
   x (36 + draft layers) + verifies x 36, plain calls 0, one host sync a
   burst (the pump's, at its last macro-step; none inside the chain,
   read in ``torch.cuda``'s sync-debug mode), at 36 layers the
   acceptance over ``ACCEPT_RATE_MIN``, at 4 rollbacks; (c)
   ``INT8_ENGINE`` with the cache and speculation at 4 draft layers on
   (a)'s trace, two twins of each tenant prefilled together first: K2
   and K4 exact, plain calls 0, the allocator law (the twins' swapped
   pages freed) and the CoW law on the int8 pools and their scales; (d)
   ``train.serve_bench`` at ``TWIN_ARGS``: exit 0 and the reference's
   serving keys (``SERVING_KEYS``).  Every path is held to the
   near-argmax law: each request's prompt and emitted tokens
   teacher-forced through ``generate``'s cached forward, every emitted
   token within ``FRONTIER_ARGMAX_ATOL`` of its row's maximum logit.
   Phase 2 holds K3 at the verify's (8, 4) block and K4 at its M 32 rows
   (``K4_VERIFY_M``, the ``mma.sync`` design) too.
19. the fleet, TP serving, disaggregation and the MoE serve — on
   phase 18's SmolLM3-3B and ``ENGINE``'s flags unless named: (a) two
   replicas on cuda:0 (``serving.Fleet``) serve ``fleet_trace`` (phase
   18d's tenant trace, 16 requests of 64 new tokens, every arrival at
   virtual time 0) undisturbed, then with ``kill_replica@1:1``, then with
   ``hang_decode@1:0`` under a 2 s watchdog: zero dropped, one
   ``replica_dead`` event with the fault's trigger, the survivor's pool
   empty, K1 and K3 exact over both replicas' dispatched steps and
   chunks, plain calls 0, the hang bounded, every request's tokens
   bit-equal to the undisturbed fleet's; (b) one replica, a modeled
   queue two deep and a deadline on the odd requests: the shed set and
   its ``Rejection`` records equal to the port's router replayed on the
   host, both reasons, every admitted request complete; (c) two replicas
   of SmolLM3-3B-L8 (full width) hot-swap to new weights (x3, another
   seed) saved with the port's ``Checkpointer``: zero dropped, each
   request on one weight set by the near-argmax law (``_weights_law``),
   both sets served, the requests after the swap on the new ones; then
   ``corrupt_swap``: the old weights kept, the warning printed; (d) the
   engine under ``mesh`` at tp 1 on the one-rank group: phase 3's
   tokens bit for bit and the shim's calls equal to the generated
   ``serve_decode`` contract (2 x 36 all_reduces a pass); (e)
   ``disaggregate`` on ``("cuda:0", "cuda:0")``: phase 3's tokens
   (``ENGINE``) and phase 7's (``INT8_ENGINE``, K2 and K4 exact) bit for
   bit, each handoff's device time and bytes logged; (f) ``MOE_SERVE_CFG``
   (SmolLM3-3B-L8-MoE, no drops) at bf16, with int8 projections (K4)
   and at f32: launches exact, the batching law, and C9's route-aware
   law: the first ``MOE_ALONE`` requests served alone with the engine's
   experts recorded, ``generate`` teacher-forced on them (its own
   gates): at f32 every token within ``MOE_F32_GAP_ATOL``, the router
   probabilities within ``MOE_F32_PROB_ATOL``, every route within
   ``MOE_ROUTE_FLIP_MARGIN`` of the pass's top-1; at bf16 and int8 the
   router probabilities' RMS distance from an f32 pass within
   ``MOE_ROUTER_RMS_RATIO`` times generate's own; (g)
   ``train.serve_bench`` at ``TWIN_FLEET_ARGS``: exit 0 and the
   reference's fleet keys (``FLEET_KEYS``).  Phase 2 holds K1, K2 and K3
   on a tensor-parallel rank's local heads (``LOCAL_KV_HEADS``) too;
20. data, classification and the model families (on the one-rank
   group): (a) ``CORPUS_TRAIN``: corpus-70m on the committed corpus
   through ``flagship.run_leg`` (step 0 against plain attention at
   ``LOSS_ATOL`` and ``FAMILY_GRAD_REL_L2``, launches exact, the final
   params saved), then ``train.eval_lm`` on the held-out tail from that
   save (finite, restored at the last step, no held-out window among the
   trained ones); (b) ``FAMILY_TRAINS`` (Llama-3.2-1B at hd 64,
   Qwen3-4B-L6 at hd 128 and vocab 151 936), gated the same way, then
   ``FP8_FAMILY`` (corpus-350m at fp8_pallas, K6) by its launches; (c)
   ``train.ddp.run`` at ``CLS`` (SmolLM3-350M's full width): the sync
   check exactly 0.0, the ``ddp`` contract's collectives every step,
   padded widths multiples of 8 (two at least), finite losses, and the
   same with int8 grads and error feedback; (d) the native data engine
   built from ``native/dtsdata.cpp``: its Zipf stream's digest
   (``NATIVE_ZIPF_DIGEST``) and its packer bit-equal to numpy's.
21. the observability tier (on the one-rank group, under a temporary
   directory): (a) ``train.pipeline.run`` at ``PIPE_LM`` under the run
   harness (``PIPE_HARNESS``), profiled with the host prefetcher: the
   summary's comm/compute split (device compute, no comm on one card)
   and its ledger joined to the zero-collective contract; the same run
   preempted and resumed from its checkpoint, its losses and every
   stage's params and Adam state bit-equal to the profiled run's; FA's
   launches exact (the path "pipeline harness"); (b) the DDP and FSDP twins
   profiled (``LEDGER_DDP``, ``LEDGER_FSDP``): ``collectives.json``
   filed, its join ok, the traced calls of each kind the shim's a step
   times the traced steps, and the join failing once the contract is
   edited by one call; (c) ``serve_bench`` at ``TIMELINE_ARGS``: the
   timeline's device rows hold K1 and K3, its host rows the ``serve/*``
   spans; 21a's run exported too (the FA forward); (d)
   ``train/report.py`` over every run dir phase 21 wrote, exit 0, with
   its bandwidth table, and exit 0 against the same dirs as
   ``--baseline``.
22. the model core's rest (on the one-rank group, under a temporary
   directory): (a) SmolLM3-3B-L8 at int8_pallas_bwd and fp8_pallas, one FSDP
   value-and-grad under ``full``, ``save_dots`` and ``save_dots_q8``
   after a warm-up that records what the policy keeps
   (``transformer.record_kept``): ``save_dots`` bit-equal to ``full``
   and keeping no byte, ``save_dots_q8``'s loss within the q8 tier and
   its kept bytes at most ``REMAT_Q8_SAVED_RATIO`` of bf16
   ``save_dots``', K4, K5, K6 and FA launches what the kept set
   implies; the int8 ``save_dots`` leg (K4's bf16 outputs kept, logged
   against the reference's int32 accumulators); the path "22: remat";
   (b) the twins at cut depth: two ``moe_bench`` rows, one
   ``moe_profile`` step (every phase with device time but the two a2a
   ranges, views at one rank), one ``long_context`` row at 16384, the
   flagship's ``--spike-demo``, ``generate_demo --serve`` on a
   corpus-70m checkpoint (the engine's tokens equal ``generate``'s, K1
   launched; K3 refuses the model's GQA group of 3, so its prefill takes
   the gather path) and ``decode_bench`` on SmolLM3-3B (C14: a positive
   slope); each its path "22: <twin>".

After every phase a full garbage collection may free at most
``CYCLIC_LIMIT_BYTES`` of card memory: a finished phase leaves none of
its state in reference cycles.

After each serving path's gates, a second serve run of the same shape,
its scheduler rounds 4-5 under ``torch.profiler``, reports the device's
busy share and its top kernels, and a profile of ``DECODE_PROFILE_STEPS`` decode steps over the
serve's slots reports the decode step's device time beside its host
clock.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no card or when any phase fails.

    python3 chip_smoke.py --parent-csrc DIR

builds K7, K4/K5, K1, K2, K3, K6 and the flash attention (forward and
backward) from DIR (another commit's ``csrc/``, unpacked under the
gitignored ``build/``) beside this checkout's, gates both builds against
the plain versions (K3 over the multi-draw reading and the forward over
its f64 oracle reading too), times both in turns at the kernel phase's
shapes (K4 at training, where the parent's wrapper copied X's codes
transposed for dW, and at decode; K1 and K2 in CUDA-graph replays),
reads the int8 serve's decode step on the device with each build's K2
(in turns), serves the serve phase's kind of requests with each build's
K1 in the engine's decode step (in turns, after a warm-up serve), prints
a ``{"compare": ...}`` line and runs nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import gzip
import importlib
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

from distributed_training_sandbox_tpu_torch.kernels import loader
from distributed_training_sandbox_tpu_torch.models import MODEL_REGISTRY
from distributed_training_sandbox_tpu_torch.models import mlp as MLP
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.models.generate import (
    _forward_cached, generate, init_cache, quantize_decode_params)
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.ops import flash_attention as FA
from distributed_training_sandbox_tpu_torch.ops import flash_prefill as FP
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PA
from distributed_training_sandbox_tpu_torch.ops import quant as Q
from distributed_training_sandbox_tpu_torch.ops import busbench as BB
from distributed_training_sandbox_tpu_torch.ops import ring_attention as RA
from distributed_training_sandbox_tpu_torch.parallel import fsdp, optim8, tensor
from distributed_training_sandbox_tpu_torch.parallel import composable as CP
from distributed_training_sandbox_tpu_torch.analysis import contract_gen as CG
from distributed_training_sandbox_tpu_torch.parallel import expert as EX
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.parallel import sequence as PS
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    fsdp_quantized_step_collectives, moe_step_collectives, step_collectives,
    tp_step_collectives)
from distributed_training_sandbox_tpu_torch.resilience import (
    generator_states)
from distributed_training_sandbox_tpu_torch.train import busbench as bb_run
from distributed_training_sandbox_tpu_torch.train import ddp as ddp_run
from distributed_training_sandbox_tpu_torch.train import flagship, train_fsdp
from distributed_training_sandbox_tpu_torch.train import moe as moe_run
from distributed_training_sandbox_tpu_torch.train import (
    precision_benchmark as prec_bench)
from distributed_training_sandbox_tpu_torch.train import pipeline as pp_run
from distributed_training_sandbox_tpu_torch.train import report as report_run
from distributed_training_sandbox_tpu_torch.train import (
    export_timeline as xt_run)
from distributed_training_sandbox_tpu_torch.train import (
    train_composable, train_sp, train_tp)
from distributed_training_sandbox_tpu_torch.train import serve_bench
from distributed_training_sandbox_tpu_torch.train import (
    decode_bench as decode_bench_run, generate_demo as generate_demo_run,
    long_context as long_context_run, moe_bench as moe_bench_run,
    moe_profile as moe_profile_run)
from distributed_training_sandbox_tpu_torch.train import zero as zero_run
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.telemetry import ledger as LD
from distributed_training_sandbox_tpu_torch.utils import mesh
from distributed_training_sandbox_tpu_torch.utils.checkpoint import (
    flatten as flatten_tree)
from distributed_training_sandbox_tpu_torch.utils.profiling import (
    ProfileSchedule)
from distributed_training_sandbox_tpu_torch.resilience import (
    Checkpointer, RunState)
from distributed_training_sandbox_tpu_torch.serving import engine as E
from distributed_training_sandbox_tpu_torch.serving import (
    AdmissionController, Fleet, Rejection, Request, Router)
from distributed_training_sandbox_tpu_torch.serving.accounting import (
    kv_bytes_per_step, tree_bytes, weight_read_bytes)
from distributed_training_sandbox_tpu_torch.serving.kv_pool import PagedKVPool
from distributed_training_sandbox_tpu_torch.serving.traces import build_trace

SEED = 0
CFG = T.SMOLLM3_3B
PARAM_SCALE = 3.0
N_REQUESTS, NEW_TOKENS = 8, 64
SERVE_ROUNDS = 5   # --parent-csrc: serves in turns, 4 a round
PROMPT_LEN = (256, 1536)
ENGINE = dict(paged_kernel=True, flash_prefill=True, max_batch=8,
              page_size=16, max_seq_len=2048, prefill_chunk=256,
              sync_every=8)
# H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP8_FLOPS = 1979e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
# the training phase: run_leg's flagship at a quarter of its batch
TRAIN = dict(model="smollm3-3b-l8", precision="fp8_pallas", seq=8192, bs=1,
             num_steps=6, warmup_steps=3, peak_lr=3e-4, seed=42)
TRAIN_CFG = dataclasses.replace(T.SMOLLM3_3B_L8,
                                matmul_precision=TRAIN["precision"])
# the int8 training phase: int8_pallas_bwd, 4 steps
INT8_TRAIN = dict(TRAIN, precision="int8_pallas_bwd", num_steps=4)
INT8_TRAIN_CFG = dataclasses.replace(T.SMOLLM3_3B_L8,
                                     matmul_precision="int8_pallas_bwd")
# the int8 serve phase: int8 weights, the int8 pool, K2 for decode; the
# reference refuses kv_quant with flash_prefill, so prefill gathers
INT8_ENGINE = dict(ENGINE, kv_quant=True, flash_prefill=False)
# the projections of one layer: (name, K, N) of x @ w at M = seq · bs
PROJECTIONS = [("wq", 2048, 2048), ("wk", 2048, 512), ("wv", 2048, 512),
               ("wo", 2048, 2048), ("w_gate", 2048, 11008),
               ("w_up", 2048, 11008), ("w_down", 11008, 2048)]
# draws of the serve shapes on which K3's multi-draw gate reads its
# accuracy (kernel_phase, and --parent-csrc for both builds)
COMPARE_DRAWS = 10
# the seeds of K3's multi-draw readings (k3_draws): COMPARE_DRAWS draws
# each, every seed's count gated on its own
K3_DRAW_SEEDS = (SEED, SEED + 5)
# the FA forward's reading against its f64 oracle (fa_oracle_reading):
# draws of B 1, S FA_ORACLE_SEQ at the training shape's heads, one seed
# each from FA_ORACLE_SEED (the default run and --parent-csrc read the
# same draws)
FA_ORACLE_SEQ, FA_ORACLE_DRAWS, FA_ORACLE_SEED = 2048, 4, SEED + 100
# Phase 20's step-0 parity of the flash kernels against plain attention
# at bf16: every grad leaf's relative L2 (LOSS_ATOL for the loss).  The
# 16 layers of Llama-3.2-1B read more than SmolLM3-3B-L8's 8
# (BF16_GRAD_REL_L2): on an H100 its embed leaf reads 0.0206 (corpus-70m
# 0.0083, Qwen3-4B-L6 0.0095); the hd-64 mutants read 0.265 (O's last
# column block unrescaled) and 0.779 (a QKᵀ k-step lost).  The limit lies
# between; the subtle FA mutants (0.0203, 0.0222) stay inside it, and
# phase 2's kernel gates catch them.
FAMILY_GRAD_REL_L2 = 0.03
# ... its plain attention runs this many KV heads at a time: after the
# earlier phases, Llama-3.2-1B's 32 heads at S 8192 at once ran out of
# the card's memory in the whole smoke
FAMILY_PLAIN_KV_HEADS = 2
# Step-0 parity, kernel path vs plain path on the same params and batch:
# |loss difference| <= LOSS_ATOL, and every grad leaf's relative L2
# error <= GRAD_REL_L2; the same without fp8 (bf16 projections, so only
# the attention kernels differ from the plain path): every grad leaf's
# relative L2 error <= BF16_GRAD_REL_L2.  Each is set between the sound
# kernels' reading and a mutant's (chip_gate_mutation.py; PERF.md).  The
# fp8 grad reading is mostly fp8 rounding noise (one-ulp differences
# upstream flip e4m3/e5m2 roundings), so GRAD_REL_L2 separates only a
# K6 mutant, by a thin margin; BF16_GRAD_REL_L2 is the backward
# kernel's step-level gate.
LOSS_ATOL = 1.5e-3
GRAD_REL_L2 = 0.182
BF16_GRAD_REL_L2 = 0.017
# the FSDP phases: train_fsdp.run at ring_fused_pallas on a one-rank
# NCCL group, SMOLLM3_3B_L8 (bf16, flash attention) at seq 8192, batch 1
FSDP_TRAIN = dict(model="smollm3-3b-l8", overlap="ring_fused_pallas",
                  seq=8192, bs=1, num_steps=4, seed=42)
FSDP_CFG = train_fsdp.model_config(FSDP_TRAIN["model"])
# K7 at one rank's K-chunk of a four-rank ring: (name, K, Kc, N), the
# chunk a strided view of the (M, K) activation
AG_CHUNKS = [("wq/wo chunk", 2048, 512, 2048),
             ("w_down chunk", 11008, 2752, 2048)]
# FSDP step-0 parity, ring_fused_pallas (K7) vs none (plain bf16
# products) on the same shards and batch: |loss difference| <=
# FSDP_LOSS_ATOL and every grad leaf's relative L2 error <=
# FSDP_GRAD_REL_L2.  Both paths run the same flash attention and the
# same plain backward products; they can differ only where K7's f32 sum
# and the library's round to neighbouring bf16 values.  On an H100 they
# read 0 (bit-equal: both sum each output's products in K order); K7
# mutants read 1.75e-4 and 8.5e-4 on the loss, 0.73 and 0.064 on the
# grads (chip_gate_mutation.py; PERF.md).  The limits leave room for a
# library that sums in another order, whose one-ulp flips would move
# the loss by ~1e-5 and the grads by a few 1e-3.
FSDP_LOSS_ATOL = 1e-4
FSDP_GRAD_REL_L2 = 0.02
# phase 10, DDP and ZeRO-1/2/3: the ZeRO toy MLP at full width (scale 1:
# 6 layers of 10 000 x 10 000, 12 leaves, 600 060 000 f32 params) on the
# FSDP phases' one-rank NCCL group; DDP takes SGD steps on a new global
# batch each step, each ZeRO stage's A/B run Adam steps on one batch
DDP_ZERO = dict(scale=1, num_steps=6, ddp_batch=32, zero_batch=16, seed=42)
# each step's least bytes over the MLP's param bytes P (f32; the GEMMs at
# M 16 or 32 are bound by reading the weights, not by their FLOPs):
# forward + backward read the weights 3 times (x @ w, dy @ w^T, and dW
# written); Adam reads p, g, m, v and writes p, m, v (7 P); SGD reads p,
# g and writes p (3 P); ZeRO-3 reads the weights once more, in the
# backward's recompute
# phase 14, resilience, on the same group: train_fsdp.run as phase 9 runs
# it (SMOLLM3_3B_L8, ring_fused_pallas: K7; flash attention), 6 steps
# under the supervisor with telemetry and the profiler (one traced step,
# the third), async dispatch with a sync point every 2 steps, where the
# saves of every 2 steps land; uninterrupted, then preempted at step 3
RESILIENCE = dict(model="smollm3-3b-l8", overlap="ring_fused_pallas",
                  seq=8192, bs=1, num_steps=6, seed=42, ckpt_every=2,
                  sync_every=2, fault="preempt@3", fault_step=3, keep=3,
                  profile=dict(skip_first=0, wait=2, warmup=0, active=1))
# SMOLLM3_3B_L8's params: its bf16 Adam moments at rest read 3 550 617
# 600 bytes on one card (PERF.md, PR 12), 2 x 2 bytes a param
FSDP_PARAMS = 887_654_400
# 14(b): the ZeRO toy at full width, as phase 10; DDP preempted at step 3
# and crashed at step 5 (saves every 2 steps), ZeRO-3 preempted at step
# 3 of its sharded leg
RESILIENCE_TOY = dict(scale=1, num_steps=6, ddp_batch=32, zero_batch=16,
                      seed=42, fault="preempt@3", crash="crash@5",
                      zero_fault="preempt@3:sharded")
STEP_BYTES_OVER_P = {"ddp": 3 + 3, "adam": 3 + 7, "zero1": 3 + 7,
                     "zero2": 3 + 7, "zero3": 4 + 7}
# phase 11, the pipeline.  (a) The reference's PP toy at full width (50
# -> 4 x 500 -> 50), batch 64 in 4 microbatches, 16 epochs a leg through
# train.pipeline.run: GPipe and 1F1B at 2 stages, interleaved at 4
# virtual stages on 2 logical devices (V 2) of the one card.  Step 0 of
# each leg against one monolithic Adam step on the same params and batch:
# the loss within rel PIPE_TOY_LOSS_RTOL (the reference's tier,
# tests/test_pipeline.py), every grad leaf that Adam takes within
# relative L2 PIPE_TOY_GRAD_REL_L2 (f32 sums of 4 microbatches against
# one), the params after the step within PIPE_TOY_PARAM_ATOL.  The
# reference's 1e-5 on the params does not hold on an H100 (1.8e-5):
# Adam's first step is lr · g / (|g| + eps), so a grad that cancels to
# within a few eps of zero turns a last-bit difference of the sum into a
# share of lr; any defect that moves an update moves it by ~lr = 1e-3.
# GPipe against 1F1B: the first PIPE_GPIPE_1F1B_EPOCHS epochs' losses
# within rel PIPE_GPIPE_1F1B_RTOL (the reference's law, 3 steps); later
# epochs part, by the same amplification (the two accumulate the
# microbatches' grads in opposite orders)
PIPE_TOY = dict(batch=64, n_micro=4, epochs=16, seed=42, lr=1e-3)
PIPE_TOY_LEGS = (("gpipe", 2), ("1f1b", 2), ("interleaved", 4))
PIPE_TOY_LOSS_RTOL, PIPE_TOY_GRAD_REL_L2 = 1e-5, 1e-5
PIPE_TOY_PARAM_ATOL = 1e-4
PIPE_GPIPE_1F1B_RTOL, PIPE_GPIPE_1F1B_EPOCHS = 1e-6, 3
# the reference's pinned 1F1B clock at 2 stages and 4 microbatches
# (tests/test_pipeline.py; tests/test_torch_pipeline.py holds the port's
# clock to it on the CPU): (tick, stage, op, microbatch)
PIPE_1F1B_TRACE = [
    (0, 0, "fwd", 0), (0, 1, "fwd", 0), (0, 1, "bwd", 0),
    (1, 0, "fwd", 1), (1, 0, "bwd", 0), (1, 1, "fwd", 1), (1, 1, "bwd", 1),
    (2, 0, "fwd", 2), (2, 0, "bwd", 1), (2, 1, "fwd", 2), (2, 1, "bwd", 2),
    (3, 0, "fwd", 3), (3, 0, "bwd", 2), (3, 1, "fwd", 3), (3, 1, "bwd", 3),
    (4, 0, "bwd", 3),
]
# (b) SMOLLM3_3B_L8 at full width (8 layers, flash attention, the
# streamed loss, remat "full", bf16), untied, as 4 stages of 2 layers on
# the one card: seq 256, batch 64 in 4 microbatches (the shapes of
# scripts/_pp_driver.py), 3 epochs each of GPipe and 1F1B
PIPE_LM = dict(model="smollm3-3b-l8", n_stages=4, n_micro=4, batch=64,
               seq=256, epochs=3, seed=42, lr=3e-4, warmup=2)
PIPE_LM_CFG = T.SMOLLM3_3B_L8
# Step-0 parity of the flash pipeline: (i) against one monolithic lm_loss
# step on the same untied params and batch, through the same kernels:
# |loss difference| <= PIPE_MONO_LOSS_ATOL, every grad leaf's relative L2
# error <= PIPE_MONO_GRAD_REL_L2.  The pipeline adds four microbatches'
# bf16 grads where the monolithic step rounds one: on an H100 the loss
# reads 0 and the grads 0.0036-0.0037; a microbatch left out or counted
# twice moves every grad by a quarter.  (ii) Against the same pipeline
# with plain attention (PIPE_PLAIN_LOSS_ATOL, PIPE_PLAIN_GRAD_REL_L2),
# set between the sound kernels' reading (loss 4.0e-5, grads 0.0347)
# and the FA mutants' (chip_gate_mutation.py: PV tile dropped 0.0032 and
# 0.861, dV tile dropped 4.0e-5 and 0.207; PERF.md)
PIPE_MONO_LOSS_ATOL = 1e-4
PIPE_MONO_GRAD_REL_L2 = 0.01
PIPE_PLAIN_LOSS_ATOL = 1e-3
PIPE_PLAIN_GRAD_REL_L2 = 0.07
# the FA backward at a pipeline stage's microbatch (B 16, S 256, 16 / 4
# heads, hd 128), one draw from each seed: each of dQ, dK, dV held to
# the exact f64 gradient (FA.BWD_ORACLE_L2_RATIO), with the module's
# elementwise ratio and block relative L2 against the plain path logged
FA_BWD_PIPE_SEEDS = tuple(range(8))
# phase 12, busbench: every collective at these payloads (MiB), bf16, on
# the one-rank NCCL group
BUSBENCH_MB = (1, 16, 128)
# phase 13, the precision tier on the one-rank NCCL group.  (a) The FSDP
# step with int8 gathers, int8 grad reduce-scatters and int8 Adam
# moments: SMOLLM3_3B_L8 at int8_pallas_bwd (K5 forward, K4 backward),
# flash attention, remat "full", seq 8192, batch 1, 4 steps of
# train_fsdp.run.  Its step 0 against the same step with the plain int8
# products (bit-equal: K5 and K4 are); the flash kernels on the step's
# own layer-0 attention inputs and output grad against the plain
# attention at FA's limits (FA.TOLERANCE, FA.BLOCK_REL_L2, FA.LSE_ATOL);
# and the step against the plain int8 products with plain attention:
# |loss difference| <= PREC_PLAIN_LOSS_ATOL, every grad leaf's relative
# L2 error <= PREC_PLAIN_GRAD_REL_L2.  That last reading is mostly int8
# codes flipped by the attention's last-bit differences: the sound
# kernels read 4.4e-4 and 0.0824, the FA forward dropping a PV tile
# 4.0e-4 and 0.0926 (chip_gate_mutation.py; PERF.md).  The grad limit
# sits between the two; no mutant moves the loss past the sound
# reading, so its limit is the pipeline gate's (PIPE_PLAIN_LOSS_ATOL)
PREC_TRAIN = dict(model="smollm3-3b-l8", precision="int8_pallas_bwd",
                  attention="flash", seq=8192, bs=1, num_steps=4, seed=42)
PREC_CFG = train_fsdp.model_config(PREC_TRAIN["model"],
                                   PREC_TRAIN["precision"],
                                   PREC_TRAIN["attention"])
PREC_PLAIN_LOSS_ATOL = PIPE_PLAIN_LOSS_ATOL
PREC_PLAIN_GRAD_REL_L2 = 0.087
# the FSDP step's Adam (its defaults) for the int8 moments' CPU check
PREC_ADAM = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8)
# (b) the remat policies: the same model at bf16 with flash attention,
# one step after a warm-up under each policy.  save_dots_q8's loss
# within rel REMAT_Q8_LOSS_RTOL of full's (the reference's tier,
# tests/test_quant.py) and at least REMAT_Q8_LOSS_MIN_RTOL from it: the
# sound round-trip reads 3.79e-5, a forward that skips it reads 0
# (chip_gate_mutation.py's dot_q8_skipped; PERF.md).  Its saved bytes
# (peak above the step's start, less full's) at most
# REMAT_Q8_SAVED_RATIO of save_dots': int8 codes and f32 row scales
# read 0.502; keeping the bf16 products, as save_dots does, reads 1.
REMAT = dict(model="smollm3-3b-l8", seq=8192, bs=1, num_steps=1, seed=42)
REMAT_Q8_LOSS_RTOL = 0.02
REMAT_Q8_LOSS_MIN_RTOL = 4e-6
REMAT_Q8_SAVED_RATIO = 0.6
# (c) train.precision_benchmark.run_one at seq 2048, batch 1, 3 steps, for
# each of these precisions (K6 runs in the fp8_pallas row).  Each row's
# step 0 first, on its own inputs: the flash kernels on its layer-0
# attention inputs at FA's limits; int8_pallas_bwd bit-equal to the
# plain int8 products; fp8_pallas K6 on each projection's first operands
# at K6's tolerance (Q.TOLERANCE), and the step against the plain fp8
# recipe (flash attention on both sides): |loss difference| <=
# PREC_BENCH_FP8_LOSS_ATOL, every grad leaf's relative L2 error <=
# PREC_BENCH_FP8_GRAD_REL_L2; then the run's step-0 loss bit-equal to
# the kernel path's.  At S 2048 the sound K6 reads 1.95e-3 and 0.2195
# there, above the fp8 training phase's limits (S 8192: 1.188e-3,
# 0.173): fewer tokens average fewer e4m3/e5m2 code flips.  K6 rounding
# its accumulator to bf16 reads 1.41e-3 and 0.2736 (chip_gate_mutation.py;
# PERF.md): the grad limit sits between; no mutant moves the loss past
# the sound reading, so its limit is an end check
PREC_BENCH = dict(model="smollm3-3b-l8", seq=2048, bs=1, num_steps=3,
                  precisions=("bf16", "int8_pallas_bwd", "fp8_pallas"))
PREC_BENCH_FP8_LOSS_ATOL = 2.5e-3
PREC_BENCH_FP8_GRAD_REL_L2 = 0.24
PREC_BENCH_KEYS = {"model", "precision", "sequence_length", "num_devices",
                   "batch_size", "steps_per_second", "tokens_per_second",
                   "tflops_per_device", "avg_loss", "peak_memory"}
# phase 15, the MoE model on the one-rank NCCL group: SMOLLM3_3B_L8_MOE
# (8 experts of ffn 2752, top-1, grouped dispatch, group 128, cf 2.0)
# with flash attention, the streamed loss, remat "full", seq 8192, batch
# 1, through parallel.expert.make_moe_lm_train_step at dp 1 x ep 1.
# (a) Step 0 at int8_pallas_bwd through K5 and K4 bit-equal to the plain
# int8 products, and the loss equal to xent + aux_weight x aux recomposed
# apart (within MOE_LOSS_SUM_ATOL: the same operations, so 0 expected).
# (oracle) moe_mlp against chip_smoke's own moe_oracle on layer 0's
# weights and normed embeddings: each of the output and the probe loss's
# grads within relative L2 MOE_ORACLE_REL_L2, the aux within
# MOE_AUX_RTOL, for each case (dtype, precision, cf, top_k).
# (b) Step 0 at bf16 with the flash kernels against plain attention:
# MOE_BF16_LOSS_ATOL and MOE_BF16_GRAD_REL_L2 on the dense leaves, set
# between the sound kernels' reading (8.1e-5, 0.01095 on an H100) and
# the FA mutants' (chip_gate_mutation.py: PV tile dropped 1.55e-4 and
# 0.0307; rowsum from rounded p 4.16e-4; scores rounded to bf16
# 3.43e-4; the dV tile and the bf16 logsumexp read 8.1e-5 and 0.0127,
# 0.0116, which this gate cannot tell from sound; PERF.md).
# (c) 6 steps of train.moe.run at int8_pallas_bwd: at the reference
# step's constant lr 3e-4 the random router already crowds most tokens
# into few experts (15a's drop fraction 0.30-0.74 a layer at step 0 on
# an H100); the loss rises at steps 2-3 and is below step 0's again by
# step 5, so 4 steps would not show it falling.
MOE_TRAIN = dict(model="smollm3-3b-l8", experts=8, precision="int8_pallas_bwd",
                 seq=8192, bs=1, num_steps=6, seed=42)
MOE_CFG = moe_run.model_config(MOE_TRAIN["model"],
                               experts=MOE_TRAIN["experts"],
                               precision=MOE_TRAIN["precision"])
assert MOE_CFG == dataclasses.replace(T.SMOLLM3_3B_L8_MOE,
                                      matmul_precision="int8_pallas_bwd")
MOE_LOSS_SUM_ATOL = 1e-5
MOE_ORACLE_CASES = {
    "top-1 cf 0.75 f32": (torch.float32, "bf16", 0.75, 1),
    "top-2 cf 1.0 f32": (torch.float32, "bf16", 1.0, 2),
    "top-1 cf 2.0 int8_pallas_bwd": (torch.bfloat16, "int8_pallas_bwd", 2.0,
                                     1)}
MOE_ORACLE_REL_L2 = 1e-4
MOE_AUX_RTOL = 1e-6
MOE_BF16_LOSS_ATOL = 1.2e-4
MOE_BF16_GRAD_REL_L2 = 0.02
# Phase 16 (tensor and sequence parallelism), on the one-rank
# group: (a) layer 0 of SmolLM3-3B-L8 cut into tp 2 and tp 4 shards at M
# 8192 through K5/K4 (bit-equal) and the flash kernels on local heads;
# (b) the TP step at dp 1 x tp 1, int8_pallas_bwd, seq 8192; (d) the
# twins and the dp x sp x ep step, 6 steps each.
TP_TRAIN = dict(model="smollm3-3b-l8", seq=8192, bs=1, num_steps=6, seed=42)
TP_PARITY_CFG = dataclasses.replace(T.SMOLLM3_3B_L8,
                                    matmul_precision="int8_pallas_bwd")
TP_SHARD_TPS = (2, 4)
# the row-parallel shards' f32 partial products summed over the ranks
# against the whole product: max |difference| / max |product|, f32
# reassociation of a K-sum of 2048 or 11 008 terms
TP_PARTIAL_REL = 1e-5
# (c) the ring fold: seq 16384 over 4 virtual ranks; against the exact
# f64 attention on slices of rows, elementwise (atol as a fraction of
# the tensor's max |value|, rtol)
RING = dict(seq=16384, sp=4, seed=SEED + 16)
RING_ORACLE_TOL = (4e-4, 2 ** -6)
MOE_SCOPES = ("moe_route", "moe_dispatch", "moe_a2a_out", "moe_expert_mlp",
              "moe_a2a_back", "moe_combine", "moe_aux_loss")
# the record_function ranges of the port's steps (parallel/expert.py)
STEP_SCOPES = MOE_SCOPES + ("forward_backward", "loss_mean", "grad_sync",
                            "opt_step")
# One decode step's logits through the kernels vs the plain path, from
# one pool state: max |difference| <= LOGIT_ATOL.  The kernels do the
# plain path's operations in another summation order, so a few bf16
# roundings per layer land one ulp apart, and 36 layers of x3 weights
# amplify that.  On an H100 the kernels read 0.89 at max |logit| 35
# (argmax unchanged); a decode kernel that skips the probabilities' bf16
# rounding read 2.81 (one-pass) and 2.13 (``chip_gate_mutation.py``).
# The limit lies between them.
LOGIT_ATOL = 1.5
# The prefill logits through K3 and through the plain gather path (the
# parity phase's chunked prefill of two prompts into fresh pools): max
# |difference| <= PREFILL_LOGIT_ATOL, the max over the serve's first two
# prompts and two prompts from each seed of PARITY_PROMPT_SEEDS.  The
# plain path equals one-shot generate's bit for bit (the same
# arithmetic); K3 differs from it where a normalised probability rounds
# to the neighbouring bf16 value, and 36 layers of x3 weights over up to
# six chunks amplify each such flip: the f64 oracle pushed through the
# same prefill, an attention independent of both, reads as far from the
# plain path.  On an H100 K3 reads 2.0-2.6035 over the five pairs
# (oracle 1.9375-2.625) at max |logit| 31.75-36.0, argmax unchanged; K3
# truncating the probabilities reads 3.5625-5.375, K3 losing each row's
# own key 8.875-12.97 (chip_gate_mutation.py).  The limit lies between.
PREFILL_LOGIT_ATOL = 3.5
# the prefill-logit gate's further prompt pairs: two prompts from each
# seed, of the serve's prompt lengths
PARITY_PROMPT_SEEDS = (SEED + 6, SEED + 7, SEED + 8, SEED + 9)
# The same for int8 serving, through K2 and K4 against the plain int8
# path: K4 is bit-equal to its plain version, so the logits differ only
# where K2 moves a code of the requantised probabilities or a row's
# scale by an ulp (which the bf16 rounding of the attention output has
# absorbed in every run: the sound kernels read 0.0000).  Set between
# that and the mutants' readings: K2 losing each slot's own key 0.6562,
# a rank's partial PV sums 32.875, each block requantising with its own
# absmax 50.5; K4's GEMV losing a split 47.125 (PERF.md).
INT8_LOGIT_ATOL = 0.25
# Phase 18, the serving frontier.  18a's trace (frontier_trace): two
# tenants, each a 512-token system prompt (32 full pages), eight requests
# with private suffixes of 256-1024 tokens; requests 0 and 1 (one a
# tenant) are served first.  18b speculates SPEC_K tokens a macro-step
# with the target's first 4 layers and with all 36 (the draft is the
# target).
FRONTIER = dict(tenants=2, sys_len=512, suffix=(256, 1024), requests=8,
                first=(0, 1))
SPEC_K = 3
SPEC_DRAFT_LAYERS = (4, CFG.num_hidden_layers)
# The near-argmax law (serve_bench.argmax_gaps): every emitted token's
# teacher-forced logit within this of its row's maximum.  The card's
# kernels sum in other orders than generate's plain path, and the draft's
# S = 1 step and the verify's S = k+1 step run different kernels and GEMM
# shapes, so the frontier's tokens cannot be held bit-equal to vanilla
# decode; a token the engine emits is the argmax of a forward an ulp away.
# On an H100 the sound paths read 1.75 (bf16: 18a, 18b; 68-77 of 512
# tokens not the exact argmax), 0.0 (18c) and 0.625 (18d); accepting past
# a mismatch 53.0 and 20.19, a verify writing every row at ``lengths``
# 45.1-47.9 (chip_gate_mutation.py).  The limit, PREFILL_LOGIT_ATOL, lies
# between.
FRONTIER_ARGMAX_ATOL = serve_bench.FRONTIER_ARGMAX_ATOL
# 18b at 36 draft layers: the acceptance rate must pass this.  The sound
# engine reads 0.4943 on an H100 (the draft's K1 steps and the verify's
# K3 block flip near-ties of the x3 weights; the stop clamp), the verify
# mutant 0.0815; the limit lies between.
ACCEPT_RATE_MIN = 0.25
# 18d: the serve bench twin at SmolLM3-3B, the tenant trace with the
# cache and speculation on
TWIN_ARGS = ["--model", "SMOLLM3_3B", "--requests", "16", "--tenants", "2",
             "--prefix-cache", "--spec-k", str(SPEC_K), "--draft-layers",
             "4", "--check-parity", "4"]
# the keys of the reference's serving block (its engine's SLO report with
# the cache and speculation on, and serve_bench's own two), but the
# recompile watch, which has no eager counterpart; a dict's value lists
# its keys (tests/test_torch_serve_traces.py holds it to the reference)
SERVING_KEYS = {
    "requests": None, "completed": None,
    "ttft_ms": ["mean", "p50", "p99"], "per_token_ms": ["p50", "p99"],
    "tokens_total": None, "tokens_per_s": None,
    "tokens_per_s_per_device": None, "devices": None,
    "pool": ["n_pages", "page_size", "peak_util"],
    "scheduler": ["admit_ms_total", "bookkeep_ms_total", "decode_ms_total",
                  "decode_steps", "decode_steps_per_token", "host_syncs",
                  "mean_occupancy", "prefill_chunks", "prefill_ms_total",
                  "rounds"],
    "disaggregated": None, "kv_quant": None, "flash_prefill": None,
    "prefix_cache": ["cached_pages", "evictions", "hit_pages", "hit_rate",
                     "inserted_pages", "lookup_pages"],
    "speculative": ["acceptance_rate", "accepted", "draft_layers",
                    "draft_steps", "k", "proposed"],
    "parity_checked": None, "failures": None}
# the keys of the reference fleet's report (serve_bench's ``fleet``
# block) but its recompile watch; a dict's value lists its keys
# (tests/test_torch_fleet.py holds it to the reference)
FLEET_KEYS = {
    "replicas": None, "live": None, "submitted": None, "shed": None,
    "completed": None, "dropped": None, "ttft_ms": ["p50", "p99"],
    "per_token_ms": ["p50", "p99"],
    "admission": ["burst_s_prior", "max_queue", "offered", "shed",
                  "total_slots"],
    "rejections": None, "replica_slo": None, "events": None}
# Phase 19.  19a, 19c, 19g's trace (fleet_trace): phase 18d's tenant trace
# (TWIN_ARGS), every request NEW_TOKENS new, every arrival at virtual time
# 0 so that dispatch does not depend on the host's clock; 19a's hang leg
# under a 2 s watchdog, bounded by the watchdog + 60 s
FLEET = dict(requests=16, tenants=2, max_seq_len=80, watchdog_s=2.0,
             hang_slack_s=60.0)
# 19b: one replica, a modeled queue two deep, a frozen 50 ms prior; the
# odd requests carry an 80 ms deadline, under two modeled bursts, so that
# both reasons shed
SHED = dict(requests=24, max_queue=2, burst_s=0.05, deadline_s=0.08, new=16)
# 19c: the hot-swap's model (full width, 8 layers: the save stays short),
# the new weights' seed, the trigger, the requests that arrive after it,
# the replicas' slots (4: the first wave's 12 requests outnumber them, so
# that the swap finds requests in flight)
SWAP_CFG = T.SMOLLM3_3B_L8
SWAP = dict(seed=SEED + 19, after=2, wave2=4, max_batch=4)
# 19f: SmolLM3-3B-L8-MoE with its capacity factor at its expert count, so
# that no token is dropped: at 2.0 a token's expert would depend on its
# batch neighbours and a request's tokens on where it ran
MOE_SERVE_CFG = dataclasses.replace(T.SMOLLM3_3B_L8_MOE,
                                    moe_capacity_factor=8.0)
# 19f's batching law: these first requests, each served alone, against
# the batched run; C9's route-aware law on the same requests
MOE_ALONE = 3
# C9's route-aware law (route_aware_law): generate teacher-forced on the
# engine's experts, each gate generate's own router probability.  At f32
# (the kernels' f32 noise): every emitted token's logit within
# MOE_F32_GAP_ATOL of its row's maximum, the engine's router
# probabilities within MOE_F32_PROB_ATOL of generate's, and a route the
# engine took apart from the pass's own top-1 only where that top-1's
# router log-probability lies at most MOE_ROUTE_FLIP_MARGIN over the
# engine's expert's.  On an H100 over three prompt draws the sound
# engine reads gaps 0-0.0225, probabilities 0.020-0.107 and margins
# 0.001-0.039; a router whose decode rows' logits are raised by 2 ·
# expert index reads 49.3, 1.0 and 35.3.
MOE_F32_GAP_ATOL = 0.5
MOE_F32_PROB_ATOL = 0.5
MOE_ROUTE_FLIP_MARGIN = 5.0
# At bf16 and int8 the router probabilities of the decode rows, as RMS
# distances from an f32 pass teacher-forced on the same experts: the
# engine's at most this times generate's own (the witness of the
# dtype's noise).  Sound 0.9992-1.0046 (generate's own 0.140-0.208); the
# skewed router 1.68 (bf16) and 1.38 (int8).  The gaps and margins are
# logged there, not gated: the gates' noise alone moves emitted tokens by
# up to 13.1 and routes by margins up to 9.5 in the sound engine.
MOE_ROUTER_RMS_RATIO = 1.2
# After every phase a full collection may free at most this much card
# memory: a finished phase leaves nothing of its state in reference
# cycles (tests/test_torch_cycles.py holds the port's runs to none on the
# CPU).  A leg's params and optimizer state are gigabytes.
CYCLIC_LIMIT_BYTES = 256 * 2 ** 20
# 19g: the serve bench twin's fleet on one card, a replica killed
TWIN_FLEET_ARGS = ["--model", "SMOLLM3_3B", "--requests", "16", "--replicas",
                   "2", "--inject-fault", "kill_replica@2:1", "--device",
                   "cuda:0"]
# Phase 2's tensor-parallel shapes: SmolLM3-3B's 16 query and 4 KV heads
# at tp 2 and 4 leave a rank 2 and 1 KV heads of 4 query rows each
LOCAL_KV_HEADS = (2, 1)
# phase 20d: the native data engine's Zipf stream at (n, vocab, seed) and
# its SHA-256 digest, which tests/test_torch_data.py reads off the JAX
# package's engine (the stream is a pure function of its arguments)
NATIVE_ZIPF = (1_000_000, 8192, 42)
NATIVE_ZIPF_DIGEST = ("800868051b5cb5bdd5b0a936b416e0a458a99521b99ecadd7d1f"
                      "43d5fb60e8a7")
# phase 2's new shapes: the flash kernels at hd 64 (B 1, S 8192) at
# Llama-3.2-1B's 32 / 8 and corpus-350m's 15 / 5 heads, the backward at
# a pipeline stage's microbatch against the exact gradient over these
# seeds at the first; K6, K5 and K4 at these configs' projections
FA_HD64 = (("llama3.2-1b", T.LLAMA32_1B), ("corpus-350m", T.CORPUS_350M))
FA_HD64_BWD_SEEDS = tuple(range(4))
WIDE_CFGS = (("corpus-350m", T.CORPUS_350M), ("qwen3-4b-l6", T.QWEN3_4B_L6))
# phase 20a: corpus-70m (8 layers, 12 / 4 heads at hd 64) on the committed
# corpus through the flagship twin, then train.eval_lm on the held-out
# tail from its final params
CORPUS_TRAIN = dict(model="corpus-70m", precision="bf16", seq=2048, bs=8,
                    num_steps=6, warmup_steps=0, peak_lr=3e-4, seed=42,
                    data="corpus")
# 20b: the families the port had not run, 3 steps at seq 8192, batch 1,
# then corpus-350m at the twin's default fp8_pallas
FAMILY_TRAINS = tuple(
    dict(CORPUS_TRAIN, model=m, seq=8192, bs=1, num_steps=3,
         data="synthetic") for m in ("llama3.2-1b", "qwen3-4b-l6"))
FP8_FAMILY = dict(FAMILY_TRAINS[0], model="corpus-350m",
                  precision="fp8_pallas", num_steps=2)
# 20c: the DDP twin's classification leg at SmolLM3-350M's full width
CLS = dict(model="smollm3-350m", batch=32, num_steps=10, q8_steps=3,
           source="synthetic")


# phase 21, the observability tier: (a) the pipeline twin under the run
# harness at PIPE_LM's shapes, profiled with the host prefetcher, and
# preempted before epoch ``preempt`` and resumed; (b)
# the DDP twin on the ZeRO toy and the FSDP twin at SmolLM3-3B-L8
# (``overlap="none"``: a gather and a reduce_scatter a leaf, copies at
# one rank) profiled over LEDGER_SCHEDULE's steps, their ledgers joined
# to the contracts; (c) the serve bench twin's timeline (TIMELINE_ARGS:
# SmolLM3-3B's 8-layer cut at full width, 4 requests: the 36-layer
# serve's timeline held 376 978 events, most of the phase's wall);
# (d) train/report.py over every run dir phase 21 wrote
PIPE_HARNESS = dict(epochs=4, preempt=2, prefetch_depth=2)
LEDGER_SCHEDULE = ProfileSchedule(skip_first=1, wait=0, warmup=0, active=2)
LEDGER_DDP = dict(scale=1, num_steps=4, batch_size=32, seed=42)
LEDGER_FSDP = dict(model="smollm3-3b-l8", overlap="none", seq=2048, bs=1,
                   num_steps=4, seed=42)
TIMELINE_ARGS = ["--model", "SMOLLM3_3B_L8", "--requests", "4",
                 "--check-parity", "1", "--profile", "--export-timeline"]
# the kernels' symbols in a trace: K1, K3 (both of its paths), the FA
# forward
K1_SYMBOL, K3_SYMBOL, FA_FWD_SYMBOL = ("decode_kernel", "flash_prefill",
                                       "fa_fwd_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """CUDA-event mean of ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=8, replays=20) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, its replays timed by CUDA events (no host launch cost between
    the calls, which a kernel of a few tens of microseconds would
    otherwise measure)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del g
    return ms


def bound(nbytes: float, flops: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gate_ratio(got, ref, atol, rtol) -> float:
    """max |got - ref| / (atol + rtol·|ref|): allclose passes iff <= 1."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (atol + rtol * r.abs())).max())


# ------------------------------------------------------------ kernel phase

def _pools(gen, n_pages, page, nkv, hd, copies):
    """``copies`` independent K/V pools: timing cycles through them so
    that no launch finds the previous one's pages in the 50 MB L2."""
    def one():
        return torch.randn((n_pages, page, nkv, hd), generator=gen,
                           device="cuda", dtype=CFG.dtype)
    return [(one(), one()) for _ in range(copies)]


def _page_table(rng, last, page, P, n_pages):
    pages = np.zeros((len(last), P), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for b, a in enumerate(last):
        n = int(a) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    return torch.as_tensor(pages, device="cuda")


def _sdpa_inputs(qg, pk, pv, pages, apos):
    """SDPA operands for the same attention over a gathered view (the
    gather is done here, outside the timed call)."""
    B, S, nkv, rep, hd = qg.shape
    V = pages.shape[1] * pk.shape[1]
    gk = pk[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    gv = pv[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    q = qg.reshape(B, S, nkv * rep, hd).transpose(1, 2)
    mask = (torch.arange(V, device="cuda")[None, None, :]
            <= apos[:, :, None])[:, None]
    return q, gk.contiguous(), gv.contiguous(), mask


def kernel_phase(rng, gen) -> list[dict]:
    """Both kernels at the serve phase's shapes: B = 8 slots, pages of
    16 rows, a 2048-position view, 4 kv heads × 4 query rows, hd 128,
    bf16; apos drawn like the serve phase's prompts."""
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages, V = B * P + 1, P * page
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    copies = 4
    pools = _pools(gen, n_pages, page, nkv, hd, copies)
    results = []

    # K1 decode: one row per slot somewhere in its 64 decode steps
    dec_apos = plen + rng.integers(0, NEW_TOKENS, size=B)
    # K3 prefill: each slot's final 256-row chunk
    chunk = ENGINE["prefill_chunk"]
    pos = (plen - 1) // chunk * chunk
    pre_apos = pos[:, None] + np.arange(chunk)[None, :]
    specs = [
        ("paged_decode", PA.paged_attention_decode, PA.paged_attention_plain,
         PA, 1, dec_apos[:, None], "distributed_training_sandbox_tpu/ops/"
         "paged_attention.py:104 (paged_attention_decode, _decode_kernel)"),
        ("flash_prefill", FP.paged_flash_prefill,
         FP.paged_flash_prefill_plain, FP, chunk, pre_apos,
         "distributed_training_sandbox_tpu/ops/flash_prefill.py:126 "
         "(paged_flash_prefill, _prefill_kernel)"),
    ]
    for name, fn, plain, mod, S, apos_np, replaces in specs:
        apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
        pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
        qg = torch.randn((B, S, nkv, rep, hd), generator=gen, device="cuda",
                         dtype=CFG.dtype)
        pk, pv = pools[0]
        got = fn(qg, pk, pv, pages, apos)
        torch.cuda.synchronize()
        ref = plain(qg, pk, pv, pages, apos)
        err = float((got - ref).abs().max())
        atol, rtol = mod.TOLERANCE[CFG.dtype]
        check(torch.isfinite(got).all(), f"{name}: non-finite output")
        check(torch.allclose(got, ref, atol=atol, rtol=rtol),
              f"{name}: max |kernel - plain| = {err} over atol {atol} "
              f"rtol {rtol}")

        it = iter(range(10 ** 9))

        def cyc():
            return pools[next(it) % copies]

        # device times from CUDA-graph replays (the calls cycle through
        # the pool copies; a graph replays the same ones), the host-loop
        # time of the kernel beside them
        k_eager = time_ms(lambda: fn(qg, *cyc(), pages, apos))
        k_ms = graph_ms(lambda: fn(qg, *cyc(), pages, apos))
        p_ms = time_ms(lambda: plain(qg, *cyc(), pages, apos), iters=5)
        sd = [_sdpa_inputs(qg, k_, v_, pages, apos) for k_, v_ in pools]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = graph_ms(lambda: sdpa(*sd[next(it) % copies][:3],
                                     attn_mask=sd[0][3], enable_gqa=True))

        # work this run's data needs: every visible key row read once,
        # QK and PV over the visible positions of every query row
        vis_rows = np.minimum(apos_np, V - 1) + 1                # (B, S)
        kv_rows = vis_rows.max(axis=1).sum()
        item = qg.element_size()
        nbytes = (qg.numel() * item + kv_rows * nkv * hd * item * 2
                  + got.numel() * 4 + pages.numel() * 4 + apos.numel() * 4)
        flops = float(vis_rows.sum()) * nkv * rep * hd * 4
        b_ms, b_by = bound(nbytes, flops)
        log(f"{name}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}); "
            f"kernel {k_ms:.5f} ms (graph replays; host loop {k_eager:.5f} "
            f"ms), plain {p_ms:.4f} ms, SDPA {l_ms:.5f} ms (graph), bound "
            f"{b_ms:.6f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        results.append({
            "name": name, "route": "cuda",
            "source": f"distributed_training_sandbox_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms, "eager_ms": k_eager,
            "max_err": err, "kernel_ms": k_ms})
        del sd
    results[1]["verify"] = k3_verify_reading(pools)
    del pools
    torch.cuda.empty_cache()
    k3_draws_reading(FP.paged_flash_prefill)
    return results


def k3_verify_reading(pools) -> dict:
    """K3 at the speculative verify's shape (phase 18b): the serve's 8
    slots, S = SPEC_K + 1 rows at apos = lengths + i, contexts 256-1600
    (a KV group then fills 16 of the kernel's 64 query vectors); against
    its plain version at its one-draw tolerance, twice bit-equal, timed in
    CUDA-graph replays beside SDPA and its bound.  Its own draws, so the
    serve's prompts stay the ones earlier runs drew."""
    vr = np.random.default_rng(SEED + 18)
    vgen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages, V, S = B * P + 1, P * page, SPEC_K + 1
    apos_np = vr.integers(256, 1601, size=B)[:, None] + np.arange(S)
    apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
    pages = _page_table(vr, apos_np.max(axis=1), page, P, n_pages)
    qg = torch.randn((B, S, nkv, rep, hd), generator=vgen, device="cuda",
                     dtype=CFG.dtype)
    pk, pv = pools[0]
    got = FP.paged_flash_prefill(qg, pk, pv, pages, apos)
    torch.cuda.synchronize()
    ref = FP.paged_flash_prefill_plain(qg, pk, pv, pages, apos)
    err = float((got - ref).abs().max())
    atol, rtol = FP.TOLERANCE[CFG.dtype]
    check(torch.isfinite(got).all() and torch.allclose(got, ref, atol=atol,
                                                       rtol=rtol),
          f"flash_prefill verify: max |kernel - plain| = {err} over atol "
          f"{atol} rtol {rtol} at S {S}")
    _twice_equal("flash_prefill verify",
                 lambda: FP.paged_flash_prefill(qg, pk, pv, pages, apos))
    it = iter(range(10 ** 9))

    def cyc():
        return pools[next(it) % len(pools)]

    k_ms = graph_ms(lambda: FP.paged_flash_prefill(qg, *cyc(), pages, apos))
    p_ms = time_ms(lambda: FP.paged_flash_prefill_plain(qg, *cyc(), pages,
                                                        apos), iters=5)
    sd = [_sdpa_inputs(qg, k_, v_, pages, apos) for k_, v_ in pools]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = graph_ms(lambda: sdpa(*sd[next(it) % len(pools)][:3],
                                 attn_mask=sd[0][3], enable_gqa=True))
    del sd
    vis_rows = np.minimum(apos_np, V - 1) + 1
    item = qg.element_size()
    nbytes = (qg.numel() * item + vis_rows.max(axis=1).sum() * nkv * hd
              * item * 2 + got.numel() * 4 + pages.numel() * 4
              + apos.numel() * 4)
    flops = float(vis_rows.sum()) * nkv * rep * hd * 4
    b_ms, b_by = bound(nbytes, flops)
    log(f"flash_prefill verify (B {B}, S {S}, contexts "
        f"{int(apos_np.min())}-{int(apos_np.max())}): max_abs_err {err:.3e} "
        f"(atol {atol}); kernel {k_ms:.5f} ms (graph replays), plain "
        f"{p_ms:.4f} ms, SDPA {l_ms:.5f} ms (graph), bound {b_ms:.6f} ms by "
        f"{b_by}")
    return {"S": S, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}


def k3_draws(seed, n=COMPARE_DRAWS):
    """``n`` draws of K3's serve shapes (kernel_phase's: 8 slots, each
    slot's final 256-row chunk of a prompt of 256-1536, a 2048 view),
    from ``seed``: four pool copies are drawn and the first is read, then
    each draw's prompt lengths, page table and queries.  The default run
    and ``--parent-csrc`` read the same draws; yields (qg, pk, pv, pages,
    apos)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    chunk = ENGINE["prefill_chunk"]
    pk, pv = _pools(gen, B * P + 1, page, nkv, hd, 4)[0]
    for _ in range(n):
        plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
        apos_np = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)
        pages = _page_table(rng, apos_np.max(axis=1), page, P, B * P + 1)
        qg = torch.randn((B, chunk, nkv, rep, hd), generator=gen,
                         device="cuda", dtype=CFG.dtype)
        yield (qg, pk, pv, pages,
               torch.as_tensor(apos_np.astype(np.int32), device="cuda"))


def k3_draws_reading(kernels, label="flash_prefill", gated=None) -> dict:
    """K3 over ``COMPARE_DRAWS`` draws (:func:`k3_draws`) of each seed of
    ``K3_DRAW_SEEDS``: each kernel of ``kernels`` (one callable, or a
    dict of named ones) and the plain path against the f64 oracle of the
    reference's arithmetic, and each kernel against the plain path; per
    reading the max |difference| over a seed's draws and the count of
    outputs off by more than atol / 4.  Every output where |kernel -
    plain| passes atol is logged with |plain - oracle| and |kernel -
    oracle| there.  Gates each seed's count of ``|kernel - plain|`` at
    ``FP.DRAW_COUNT_LIMIT`` (the one-draw atol stays kernel_phase's), and
    the kernel's count against the oracle, summed over the seeds, at
    ``FP.ORACLE_COUNT_RATIO`` times the plain path's; ``gated`` names
    the kernels held to the ratio (all by default), the others log it."""
    kernels = kernels if isinstance(kernels, dict) else {label: kernels}
    gated = set(kernels) if gated is None else set(gated)
    atol = FP.TOLERANCE[CFG.dtype][0]
    th = atol / 4
    res = {}
    # outputs off the oracle by more than atol / 4, summed over the seeds
    vs_oracle = {n: 0 for n in [*kernels, "plain"]}
    for seed in K3_DRAW_SEEDS:
        read = {f"{n} - {r}": [0.0, 0] for n in kernels
                for r in ("oracle", "plain")}
        read["plain - oracle"] = [0.0, 0]
        # where |kernel - plain| > atol: (draw, index, kernel - plain,
        # plain - oracle, kernel - oracle)
        over = {n: [] for n in kernels}
        for d, (qg, pk, pv, pages, apos) in enumerate(k3_draws(seed)):
            orc = FP.paged_flash_prefill_oracle(qg, pk, pv, pages, apos)
            ref = FP.paged_flash_prefill_plain(qg, pk, pv, pages, apos)
            outs = {n: fn(qg, pk, pv, pages, apos)
                    for n, fn in kernels.items()}
            torch.cuda.synchronize()
            pairs = [("plain - oracle", ref, orc)]
            for n, got in outs.items():
                pairs += [(f"{n} - oracle", got, orc),
                          (f"{n} - plain", got, ref)]
                kp = got.double() - ref.double()
                for i in (kp.abs() > atol).nonzero()[:16].tolist():
                    i = tuple(i)
                    over[n].append([d, list(i), float(kp[i]),
                                    float(ref[i].double() - orc[i]),
                                    float(got[i].double() - orc[i])])
            for key, a, b in pairs:
                read[key][0] = max(read[key][0], float(
                    (a.double() - b.double()).abs().max()))
                read[key][1] += FP.off_count(a, b, th)
            del orc, ref, outs
        torch.cuda.empty_cache()
        log(f"{label} over {COMPARE_DRAWS} draws of seed {seed}, (max "
            f"|difference|, outputs off by > {th}): {json.dumps(read)}; "
            f"outputs where |kernel - plain| > {atol}, as [draw, index, "
            f"kernel - plain, plain - oracle, kernel - oracle]: "
            f"{json.dumps(over)}")
        vs_oracle["plain"] += read["plain - oracle"][1]
        for n in kernels:
            vs_oracle[n] += read[f"{n} - oracle"][1]
            cnt = read[f"{n} - plain"][1]
            check(cnt <= FP.DRAW_COUNT_LIMIT,
                  f"{n} draws: {cnt} outputs off the plain path by more "
                  f"than {th} over {COMPARE_DRAWS} draws of seed {seed}, "
                  f"above {FP.DRAW_COUNT_LIMIT}")
        res[f"seed {seed}"] = {"readings": read, "over_atol": over}
    ratios = {n: vs_oracle[n] / max(vs_oracle["plain"], 1) for n in kernels}
    log(f"{label} over the seeds {list(K3_DRAW_SEEDS)}: outputs off the "
        f"oracle by > {th} {json.dumps(vs_oracle)}; each kernel's count over"
        f" the plain path's {json.dumps(ratios)} (limit "
        f"{FP.ORACLE_COUNT_RATIO} for {sorted(gated)})")
    for n in sorted(gated):
        check(ratios[n] <= FP.ORACLE_COUNT_RATIO,
              f"{n} oracle: {vs_oracle[n]} outputs off the f64 oracle by "
              f"more than {th}, {ratios[n]:.3f} times the plain path's "
              f"{vs_oracle['plain']}, above {FP.ORACLE_COUNT_RATIO}")
    res["oracle_counts"], res["oracle_ratio"] = vs_oracle, ratios
    return res


def _q8_pools(gen, n_pages, page, nkv, hd, copies):
    """``copies`` int8 pools quantised per row from random bf16 K/V rows
    (codes and f32 scales, as the engine writes them)."""
    def one():
        return Q.quantize_int8(torch.randn((n_pages, page, nkv, hd),
                                           generator=gen, device="cuda"))
    return [(*one(), *one()) for _ in range(copies)]   # kq, ks, vq, vs


def _q8_decode_inputs(rng, gen, copies=4):
    """K2's inputs at the int8 serve phase's shapes: B = 8 slots, pages
    of 16 rows, a 2048-position view, 4 kv heads × 4 query rows, hd 128,
    int8 codes with f32 row scales; apos drawn like the serve phase's.
    Returns (qq, qs, pools, pages, apos, apos_np), ``copies`` pools."""
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages = B * P + 1
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    apos_np = (plen + rng.integers(0, NEW_TOKENS, size=B))[:, None]
    apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
    pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
    pools = _q8_pools(gen, n_pages, page, nkv, hd, copies)
    qq, qs = Q.quantize_int8(torch.randn((B, 1, nkv, rep, hd), generator=gen,
                                         device="cuda"))
    return qq, qs, pools, pages, apos, apos_np


def _q8_reading(name, got, ref) -> tuple[float, float]:
    """K2's output against its plain version's: logged (with the count of
    outputs that differ at all) and gated at ``PA.TOLERANCE_Q8``;
    returns (max |difference|, gate ratio)."""
    atol, rtol = PA.TOLERANCE_Q8
    err, ratio = float((got - ref).abs().max()), gate_ratio(got, ref, atol,
                                                            rtol)
    n_diff = int((got != ref).sum())
    # an f32 ulp of a row's scale moves every output of the row by about
    # an ulp; a moved code moves one output by a step of sc · |v|
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    log(f"{name}: max_abs_err {err:.3e}, gate ratio {ratio:.4f} (atol "
        f"{atol}, rtol {rtol}); {n_diff} of {got.numel()} outputs differ, "
        f"by at most {rel:.3e} of |plain|; max |plain| "
        f"{float(ref.abs().max()):.4f}")
    check(torch.isfinite(got).all(), f"{name}: non-finite output")
    check(ratio <= 1.0, f"{name}: max |kernel - plain| = {err} over atol "
          f"{atol} rtol {rtol} (gate ratio {ratio:.3f})")
    return err, ratio


def q8_decode_phase(rng, gen) -> dict:
    """K2 at the int8 serve phase's shapes (:func:`_q8_decode_inputs`):
    against its plain version, twice bit-equal, then timed in CUDA-graph
    replays and in a host loop, beside SDPA over the dequantised view
    timed both ways."""
    qq, qs, pools, pages, apos, apos_np = _q8_decode_inputs(rng, gen)
    copies = len(pools)
    V = pages.shape[1] * ENGINE["page_size"]
    nkv, rep, hd = qq.shape[2:]

    def kernel(kq, ks, vq, vs):
        return PA.paged_attention_decode(qq, kq, vq, pages, apos, q_scale=qs,
                                         pk_s=ks, pv_s=vs)

    def plain(kq, ks, vq, vs):
        return PA.paged_attention_plain_q8(qq, qs, kq, vq, ks, vs, pages, apos)

    got = kernel(*pools[0])
    torch.cuda.synchronize()
    err, ratio = _q8_reading("paged_decode_q8", got, plain(*pools[0]))
    _twice_equal("paged_decode_q8", lambda: kernel(*pools[0]))

    it = iter(range(10 ** 9))

    def cyc():
        return pools[next(it) % copies]

    # graph replays: a host loop times the launch of a kernel of a few
    # tens of microseconds, not the kernel
    k_ms = graph_ms(lambda: kernel(*cyc()))
    k_eager = time_ms(lambda: kernel(*cyc()))
    p_ms = time_ms(lambda: plain(*cyc()), iters=5)
    # the yardstick: SDPA over the dequantised gathered view (dequantised
    # and gathered outside the timed call)
    qd = (qq.float() * qs).to(CFG.dtype)
    sd = [_sdpa_inputs(qd, (kq.float() * ks).to(CFG.dtype),
                       (vq.float() * vs).to(CFG.dtype), pages, apos)
          for kq, ks, vq, vs in pools]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            *sd[next(it) % copies][:3], attn_mask=sd[0][3], enable_gqa=True)

    l_ms = graph_ms(sdpa)
    l_eager = time_ms(sdpa)
    del sd, pools
    torch.cuda.empty_cache()
    # what this run's data needs: every visible K and V row (codes and
    # scale) read once, the int8 q rows and scales, the f32 output;
    # QK and PV over the visible positions as int8 operations
    vis_rows = np.minimum(apos_np, V - 1) + 1
    kv_rows = int(vis_rows.sum())
    nbytes = (qq.numel() + qs.numel() * 4 + kv_rows * nkv * (hd + 4) * 2
              + got.numel() * 4 + pages.numel() * 4 + apos.numel() * 4)
    ops = float(kv_rows) * nkv * rep * hd * 4
    b_ms, b_by = bound(nbytes, ops, PEAK_INT8_OPS)
    log(f"paged_decode_q8: kernel {k_ms:.5f} ms (graph replays; host loop "
        f"{k_eager:.5f} ms), plain {p_ms:.4f} ms, SDPA (dequantised view) "
        f"{l_ms:.5f} ms (graph; host loop {l_eager:.5f} ms), bound "
        f"{b_ms:.6f} ms by {b_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
        f"int8 operations)")
    entry = _entry("paged_decode_q8", "paged_decode_q8.cu",
                   "distributed_training_sandbox_tpu/ops/paged_attention.py"
                   ":140 (paged_attention_decode int8 branch, "
                   "_decode_kernel_q8 :75)", err, ratio, k_ms, p_ms, l_ms,
                   b_ms, b_by)
    entry.update(eager_ms=k_eager, library_eager_ms=l_eager)
    return entry


def local_heads_phase() -> dict:
    """K1, K2 and K3 on a tensor-parallel rank's local heads
    (``LOCAL_KV_HEADS`` KV heads of 4 query rows: SmolLM3-3B at tp 2 and
    4) at the serve's B, pages and contexts: each against its plain
    version at its module's tolerance (K2 at ``TOLERANCE_Q8``), timed in
    CUDA-graph replays beside SDPA on the gathered view and its byte
    bound.  Draws from its own seed, so that the phases after it see
    the smoke's draws."""
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P, chunk = ENGINE["max_seq_len"] // page, ENGINE["prefill_chunk"]
    hd = CFG.resolved_head_dim
    rep = CFG.num_attention_heads // CFG.num_key_value_heads
    n_pages, V, copies = B * P + 1, P * page, 4
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    dec = (plen + rng.integers(0, NEW_TOKENS, size=B))[:, None]
    pre = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)[None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for nkv in LOCAL_KV_HEADS:
        floats = _pools(gen, n_pages, page, nkv, hd, copies)
        ints = _q8_pools(gen, n_pages, page, nkv, hd, copies)
        for name, apos_np in (("paged_decode", dec), ("flash_prefill", pre),
                              ("paged_decode_q8", dec)):
            S = apos_np.shape[1]
            apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
            pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
            q = torch.randn((B, S, nkv, rep, hd), generator=gen,
                            device="cuda", dtype=CFG.dtype)
            if name == "paged_decode_q8":
                qq, qs = Q.quantize_int8(q.float())
                pools, (atol, rtol), item = ints, PA.TOLERANCE_Q8, 1

                def fn(kq, ks, vq, vs):
                    return PA.paged_attention_decode(
                        qq, kq, vq, pages, apos, q_scale=qs, pk_s=ks,
                        pv_s=vs)

                def plain(kq, ks, vq, vs):
                    return PA.paged_attention_plain_q8(qq, qs, kq, vq, ks,
                                                       vs, pages, apos)

                sd = [_sdpa_inputs((qq.float() * qs).to(CFG.dtype),
                                   (kq.float() * ks).to(CFG.dtype),
                                   (vq.float() * vs).to(CFG.dtype), pages,
                                   apos) for kq, ks, vq, vs in pools]
            else:
                mod = PA if name == "paged_decode" else FP
                kern = (PA.paged_attention_decode if name == "paged_decode"
                        else FP.paged_flash_prefill)
                ref_fn = (PA.paged_attention_plain if name == "paged_decode"
                          else FP.paged_flash_prefill_plain)
                pools, (atol, rtol) = floats, mod.TOLERANCE[CFG.dtype]
                item = q.element_size()

                def fn(k, v, kern=kern):
                    return kern(q, k, v, pages, apos)

                def plain(k, v, ref_fn=ref_fn):
                    return ref_fn(q, k, v, pages, apos)

                sd = [_sdpa_inputs(q, k, v, pages, apos) for k, v in pools]
            got = fn(*pools[0])
            torch.cuda.synchronize()
            ref = plain(*pools[0])
            err = float((got - ref).abs().max())
            ratio = gate_ratio(got, ref, atol, rtol)
            label = f"{name} on {nkv} local KV heads"
            check(torch.isfinite(got).all(), f"{label}: non-finite output")
            check(ratio <= 1.0, f"{label}: max |kernel - plain| = {err} "
                  f"over atol {atol} rtol {rtol} (gate ratio {ratio:.3f})")
            it = iter(range(10 ** 9))
            k_ms = graph_ms(lambda: fn(*pools[next(it) % copies]))
            p_ms = time_ms(lambda: plain(*pools[next(it) % copies]), iters=5)
            l_ms = graph_ms(lambda: sdpa(*sd[next(it) % copies][:3],
                                         attn_mask=sd[0][3],
                                         enable_gqa=True))
            vis = np.minimum(apos_np, V - 1) + 1
            kv_rows = vis.max(axis=1).sum()
            scales = 4 if name == "paged_decode_q8" else 0
            nbytes = (q.numel() * item + kv_rows * nkv * (hd * item + scales)
                      * 2 + got.numel() * 4 + pages.numel() * 4
                      + apos.numel() * 4)
            flops = float(vis.sum()) * nkv * rep * hd * 4
            b_ms, b_by = bound(nbytes, flops,
                               PEAK_INT8_OPS if scales else PEAK_BF16_FLOPS)
            log(f"{label}: max_abs_err {err:.3e} (gate ratio {ratio:.4f}); "
                f"kernel {k_ms:.5f} ms (graph replays), plain {p_ms:.4f} "
                f"ms, SDPA {l_ms:.5f} ms (graph), bound {b_ms:.6f} ms by "
                f"{b_by}")
            out[f"{name}@nkv{nkv}"] = {
                "max_abs_err": err, "ratio": ratio, "ms": k_ms,
                "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            del sd
        del floats, ints
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- serve phase

def build_params():
    return serve_bench.build_params(CFG, SEED, PARAM_SCALE, "cuda")


def serve_phase(params, rng, card: str):
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    eng = E.ServingEngine(params, CFG, **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = {"paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
              "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls)}
    L = CFG.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    for r in reqs:
        check(len(r.tokens) == NEW_TOKENS,
              f"request {r.rid}: {len(r.tokens)} tokens, not {NEW_TOKENS}")
        check(all(0 <= t < CFG.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    check(counts["paged_decode"] == (steps * L, 0),
          f"paged_decode (launches, plain) {counts['paged_decode']} != "
          f"({steps} decode steps x {L} layers, 0)")
    check(counts["flash_prefill"] == (chunks * L, 0),
          f"flash_prefill (launches, plain) {counts['flash_prefill']} != "
          f"({chunks} prefill chunks x {L} layers, 0)")
    slo = eng.slo_report()
    log(f"serve on {card}: {slo['completed']}/{N_REQUESTS} requests, "
        f"{steps} decode steps, {chunks} prefill chunks; TTFT p50 "
        f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} ms, "
        f"per-token p50 {slo['per_token_ms']['p50']} ms, "
        f"{slo['tokens_per_s']} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"serve scheduler: {json.dumps(slo['scheduler'])}")
    # the least a decode step could take: every weight byte and the KV
    # rows of the active slots read once (the mean context of the run)
    ctx = np.mean([r.n_prompt + NEW_TOKENS / 2 for r in reqs])
    step_bytes = (weight_read_bytes(CFG, params, tree_bytes(params))
                  + kv_bytes_per_step(CFG, N_REQUESTS, int(ctx)))
    log(f"decode step: {slo['scheduler']['decode_ms_total'] / steps:.3f} ms"
        f" on the host clock, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms by bytes ({step_bytes / 1e9:.3f} GB: weights + KV of "
        f"{N_REQUESTS} slots at mean context {ctx:.0f})")
    return eng, reqs, {k: v[0] for k, v in counts.items()}


# ------------------------------------------------------------ parity phase

def _prefill(reqs, eng, flash: bool):
    """Chunked prefill of ``reqs`` (one row each) into a fresh pool, the
    engine's way; returns the pool, the page table and each row's f32
    logits at its last prompt position (B, vocab)."""
    page, P, Ck = eng.page_size, eng.pages_per_request, eng.prefill_chunk
    B = len(reqs)
    pool = PagedKVPool(eng.cfg, B * P + 1, page, kv_quant=eng.kv_quant,
                       device="cuda")
    pages = torch.arange(1, B * P + 1, dtype=torch.int32,
                         device="cuda").reshape(B, P)
    plen = np.array([r.n_prompt for r in reqs], np.int32)
    plen_d = torch.as_tensor(plen, device="cuda")
    logits = None
    for pos in range(0, int(plen.max()), Ck):
        ids = np.zeros((B, Ck), np.int32)
        for i, r in enumerate(reqs):
            ids[i, :len(r.prompt[pos:pos + Ck])] = r.prompt[pos:pos + Ck]
        apos = pos + torch.arange(Ck, dtype=torch.int32,
                                  device="cuda")[None, :].repeat(B, 1)
        with torch.no_grad():
            x = E._paged_forward(eng._params,
                                 torch.as_tensor(ids, device="cuda"),
                                 eng.cfg, pool.bufs, pages, apos,
                                 apos < plen_d[:, None],
                                 flash_prefill=flash)
            last = torch.as_tensor(np.clip(plen - 1 - pos, 0, Ck - 1),
                                   device="cuda").long()
            lg = E._last_logits(eng._params,
                                x[torch.arange(B, device="cuda"), last][:, None],
                                eng.cfg)
        # a row's logits count only in the chunk holding its last position
        ends = torch.as_tensor((pos < plen) & (plen <= pos + Ck),
                               device="cuda")[:, None]
        logits = lg if logits is None else torch.where(ends, lg, logits)
    return pool, pages, logits


@contextlib.contextmanager
def _oracle_prefill():
    """The engine's flash prefill through K3's f64 oracle of the
    reference's arithmetic, rounded to f32 as K3 returns it (uncounted):
    a second attention that sums in another order than the plain path,
    independent of K3."""
    saved = E.paged_flash_prefill
    E.paged_flash_prefill = \
        lambda *a: FP.paged_flash_prefill_oracle(*a).float()
    try:
        yield
    finally:
        E.paged_flash_prefill = saved


def _prefill_logit_readings(pair, eng):
    """The prefill logits of ``pair`` through K3, the plain gather path
    and the oracle (:func:`_oracle_prefill`): the readings (max |K3 -
    plain|, |oracle - plain|, |K3 - oracle|, max |logit|) and K3's pool,
    page table and logits, and the plain path's logits."""
    pool, pages, lg_k = _prefill(pair, eng, flash=True)
    _, _, lg_p = _prefill(pair, eng, flash=False)
    with _oracle_prefill():
        _, _, lg_o = _prefill(pair, eng, flash=True)
    d = lambda a, b: float((a - b).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (lg_k, lg_p, lg_o))
    read = {"kernel - plain": d(lg_k, lg_p), "oracle - plain": d(lg_o, lg_p),
            "kernel - oracle": d(lg_k, lg_o),
            "max |logit|": float(lg_p.abs().max()), "finite": finite}
    return read, pool, pages, lg_k, lg_p


def _pool_tensors(pool):
    b = pool.bufs
    return [*b.k, *b.v, *(b.k_scale or ()), *(b.v_scale or ())]


def _decode_step_logits(eng, pool, pages, toks, lengths, kernel: bool):
    """One decode step from the pool's current state, restored after."""
    snapshot = [t.clone() for t in _pool_tensors(pool)]
    with torch.no_grad():
        x = E._paged_forward(eng._params, toks[:, None], eng.cfg, pool.bufs,
                             pages, lengths[:, None],
                             torch.ones_like(toks[:, None], dtype=torch.bool),
                             paged_kernel=kernel)
        out = E._last_logits(eng._params, x, eng.cfg)
    for t, s in zip(_pool_tensors(pool), snapshot):
        t.copy_(s)
    return out


def _gap(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def parity_phase(params, reqs, eng):
    """One-shot ``generate`` against the engine, and the kernels against
    the plain path from one state.  Everything is logged first; the
    gates follow."""
    pair = reqs[:2]
    failures = []
    gen_first = []
    for r in pair:
        ref = generate(params, r.prompt[None], CFG,
                       max_new_tokens=NEW_TOKENS,
                       cache_capacity=eng.view_capacity)[0].tolist()
        gen_first.append(ref[0])
        same = sum(a == b for a, b in zip(r.tokens, ref))
        prefix = next((i for i, (a, b) in enumerate(zip(r.tokens, ref))
                       if a != b), len(ref))
        log(f"parity rid {r.rid}: {same}/{len(ref)} tokens agree with "
            f"one-shot generate, first {prefix} in a row")
        if r.tokens[0] != ref[0]:
            failures.append(f"request {r.rid}: first token {r.tokens[0]} "
                            f"!= one-shot generate's {ref[0]}")
    cache_logits = []
    for r in pair:
        cache = init_cache(CFG, 1, eng.view_capacity, device="cuda")
        with torch.no_grad():
            lg, _ = _forward_cached(params, torch.as_tensor(
                r.prompt[None], device="cuda").long(), CFG, cache, 0)
        cache_logits.append(lg[0])
    lg_gen = torch.stack(cache_logits)
    read, pool, pages, lg_k, lg_p = _prefill_logit_readings(pair, eng)
    d = lambda a, b: float((a - b).abs().max())
    log(f"parity prefill logits: |kernel - plain| "
        f"{read['kernel - plain']:.4f}, |oracle - plain| "
        f"{read['oracle - plain']:.4f}, |kernel - oracle| "
        f"{read['kernel - oracle']:.4f}, |kernel - generate| "
        f"{d(lg_k, lg_gen):.4f}, |plain - generate| {d(lg_p, lg_gen):.4f}"
        f"; max |logit| {read['max |logit|']:.2f}; top1-top2 gap "
        f"(generate) {_gap(lg_gen)}; argmax kernel "
        f"{lg_k.argmax(-1).tolist()} plain {lg_p.argmax(-1).tolist()} "
        f"generate {lg_gen.argmax(-1).tolist()} engine "
        f"{[r.tokens[0] for r in pair]}")
    reads = {"serve": read}
    for seed in PARITY_PROMPT_SEEDS:
        prng = np.random.default_rng(seed)
        prompts = [prng.integers(1, CFG.vocab_size, size=int(prng.integers(
            PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32)
            for _ in range(2)]
        reads[f"seed {seed}"] = _prefill_logit_readings(
            [types.SimpleNamespace(prompt=p, n_prompt=len(p))
             for p in prompts], eng)[0]
        torch.cuda.empty_cache()
    log(f"parity prefill logits by prompt pair (the serve's first two, "
        f"then two prompts from each seed): {json.dumps(reads)}")
    pre_err = max(r["kernel - plain"] for r in reads.values())
    if not all(r["finite"] for r in reads.values()):
        failures.append("non-finite prefill logits")
    if not pre_err <= PREFILL_LOGIT_ATOL:
        failures.append(f"prefill logits kernel vs plain: max abs diff "
                        f"{pre_err} over atol {PREFILL_LOGIT_ATOL} (max "
                        f"over the prompt pairs)")
    toks = lg_k.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in pair], dtype=torch.int32,
                              device="cuda")
    lk = _decode_step_logits(eng, pool, pages, toks, lengths, True)
    lp = _decode_step_logits(eng, pool, pages, toks, lengths, False)
    err, scale = d(lk, lp), float(lp.abs().max())
    log(f"parity decode logits kernel vs plain: max abs diff {err:.4f}, "
        f"max |logit| {scale:.2f}, atol {LOGIT_ATOL}, argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}, top1-top2 gap "
        f"(plain) {_gap(lp)}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        failures.append("non-finite decode logits")
    if not torch.allclose(lk, lp, atol=LOGIT_ATOL, rtol=0.0):
        failures.append(f"decode logits kernel vs plain: max abs diff "
                        f"{err} over atol {LOGIT_ATOL}")
    check(not failures, "; ".join(failures))


def profile_phase(params, rng, engine=None, label="serve",
                  window=None) -> None:
    """A second serve run of the same shape under ``torch.profiler``
    (default: the bf16 serve's ``ENGINE``): the device's busy share of
    the run's wall time and the kernels that take it.  ``window =
    (first, n)`` profiles scheduler rounds first .. first + n - 1 only
    (each a prefill chunk or two and a decode burst), and the run stops
    after them: the int8 run launches ~50 000 kernels, whose trace takes
    minutes to post-process.
    It comes after every gate, so profiler overhead touches none of the
    gated numbers; it reports and gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    eng = E.ServingEngine(params, CFG, **(engine or ENGINE))
    for _ in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        eng.submit(rng.integers(1, CFG.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    # device activity only: tracing every CPU operator as well doubles
    # the run's wall time and takes minutes to post-process
    prof = profile(activities=[ProfilerActivity.CUDA])
    if window is None:
        with prof:
            t = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    else:
        # run()'s loop with every request arriving at t = 0
        first, n = window
        eng.start()
        for req in eng._pending:
            eng.batcher.submit(req, 0.0)
        eng._pending = []
        i = 0
        while eng.batcher.has_work():
            if i == first:
                torch.cuda.synchronize()
                prof.start()
                t = time.perf_counter()
            eng.step_round(time.perf_counter() - eng._t0)
            i += 1
            if i == first + n:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
                prof.stop()
                break   # the rounds after the window read nothing
        eng.close_pump()
        if i < first + n:
            check(False, f"profile ({label}): the run took {i} rounds, "
                  f"fewer than the window's {first + n}")
            return
        label += f", rounds {first}-{first + n - 1}"
    # device-side entries only: a CPU op's entry repeats the device time
    # of the kernels it launched (a profile of CPU and CUDA activity)
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0
           and e.device_type != torch.autograd.DeviceType.CPU]
    busy_us = sum(d for _, _, d in dev)
    if not dev:
        log(f"profile ({label}): torch.profiler recorded no device time "
            f"(not measured)")
        return
    log(f"profile ({label} run under torch.profiler): device busy "
        f"{busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall = "
        f"{busy_us / wall_us:.3f}; idle share {1 - busy_us / wall_us:.3f}")
    for key, count, d in sorted(dev, key=lambda e: -e[2])[:8]:
        log(f"profile ({label}): {d / busy_us:.3f} of device time, {count} "
            f"calls, {d / 1e3:.1f} ms: {key[:90]}")


DECODE_PROFILE_STEPS = 8


# the paged decode kernels' names in a profile (K1's, K2's, and the
# four passes of K2's first design)
PAGED_DECODE_KERNELS = "(anonymous namespace)::decode_"


def decode_step_profile(eng, reqs, label, flash: bool) -> dict:
    """The device time of one decode step at the serve's shape: every
    request of the serve prefilled into a fresh pool (the engine's way),
    then ``DECODE_PROFILE_STEPS`` steps of the engine's ``_decode_core``
    over all its slots under ``torch.profiler`` (device activity): the
    device's busy time a step beside the step's host clock, the kernels
    that take it, and the paged decode attention's share
    (``PAGED_DECODE_KERNELS``).  Reports and gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    pool, pages, lg = _prefill(reqs, eng, flash=flash)
    toks = lg.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in reqs], dtype=torch.int32,
                              device="cuda")
    stop = lengths + DECODE_PROFILE_STEPS + 1
    active = torch.ones_like(toks, dtype=torch.bool)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            toks, lengths, active, _ = E._decode_core(
                pool.bufs, eng._params, pages, toks, lengths, stop, active,
                cfg=eng.cfg, paged_kernel=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / DECODE_PROFILE_STEPS
    dev = sorted(((e.key, e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda e: -e[2])
    busy_ms = sum(d for _, _, d in dev) / 1e3 / DECODE_PROFILE_STEPS
    log(f"decode step profile ({label}, {len(reqs)} slots, "
        f"{DECODE_PROFILE_STEPS} steps): device busy {busy_ms:.3f} ms a "
        f"step, host clock {wall_ms:.3f} ms a step")
    for key, count, d in dev[:5]:
        step_ms = d / 1e3 / DECODE_PROFILE_STEPS
        log(f"decode step profile ({label}): {step_ms:.4f} ms a step, "
            f"{count} calls: {key[:90]}")
    attn_ms = sum(d for key, _, d in dev if PAGED_DECODE_KERNELS in key) \
        / 1e3 / DECODE_PROFILE_STEPS
    log(f"decode step profile ({label}): the paged decode attention's "
        f"kernels {attn_ms:.4f} ms a step")
    del pool
    return {"device_busy_ms": busy_ms, "host_ms": wall_ms,
            "paged_decode_ms": attn_ms}


# ------------------------------------------------------ int8 serve phases

def int8_serve_phase(params_q8, rng, card: str):
    """The int8 engine (int8 weights, int8 pool, K2 decode, K4 for every
    projection and the unembedding) answers 8 requests."""
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    eng = E.ServingEngine(params_q8, CFG, **INT8_ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (PA.Q8_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS, PA.COUNTS,
                FP.COUNTS)
    for c in counters:
        c.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = {"paged_decode_q8": (PA.Q8_COUNTS.launches,
                                  PA.Q8_COUNTS.plain_calls),
              "int8_matmul": (Q.INT8_COUNTS.launches,
                              Q.INT8_COUNTS.plain_calls)}
    L = CFG.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    want = {"paged_decode_q8": steps * L,
            "int8_matmul": (steps + chunks) * (len(PROJECTIONS) * L + 1)}
    log(f"int8 serve launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)} ({steps} decode steps,"
        f" {chunks} prefill chunks); K1 {PA.COUNTS.launches}, K3 "
        f"{FP.COUNTS.launches}, K5 {Q.INT8_FUSED_COUNTS.launches}")
    for r in reqs:
        check(len(r.tokens) == NEW_TOKENS,
              f"int8 request {r.rid}: {len(r.tokens)} tokens, not "
              f"{NEW_TOKENS}")
        check(all(0 <= t < CFG.vocab_size for t in r.tokens),
              f"int8 request {r.rid}: token out of the vocabulary")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"int8 serve: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    slo = eng.slo_report()
    log(f"int8 serve on {card}: {slo['completed']}/{N_REQUESTS} requests, "
        f"{steps} decode steps, {chunks} prefill chunks; TTFT p50 "
        f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} ms, "
        f"per-token p50 {slo['per_token_ms']['p50']} ms, "
        f"{slo['tokens_per_s']} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, pool "
        f"prediction {slo['pool']['predicted_gb']:.3f} GiB")
    log(f"int8 serve scheduler: {json.dumps(slo['scheduler'])}")
    ctx = np.mean([r.n_prompt + NEW_TOKENS / 2 for r in reqs])
    w_bytes = weight_read_bytes(CFG, params_q8, tree_bytes(params_q8))
    kv_bytes = kv_bytes_per_step(CFG, N_REQUESTS, int(ctx), kv_quant=True)
    step_bytes = w_bytes + kv_bytes
    log(f"int8 decode step: {slo['scheduler']['decode_ms_total'] / steps:.3f}"
        f" ms on the host clock, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms by bytes ({w_bytes / 1e9:.3f} GB of weights + "
        f"{kv_bytes / 1e9:.3f} GB of int8 KV of {N_REQUESTS} slots at mean "
        f"context {ctx:.0f})")
    return eng, reqs, {k: v[0] for k, v in counts.items()}


def int8_parity_phase(params_q8, reqs, eng):
    """Every request's first token against the port's one-shot
    ``generate(kv_quant=True)`` at the view capacity, and one decode
    step's logits through K2 and K4 against the plain int8 path from one
    pool state.  Everything is logged first; the gates follow."""
    failures = []
    firsts = []
    for r in reqs:
        ref = int(generate(params_q8, r.prompt[None], CFG, max_new_tokens=1,
                           cache_capacity=eng.view_capacity,
                           kv_quant=True)[0, 0])
        firsts.append((r.tokens[0], ref))
        if r.tokens[0] != ref:
            failures.append(f"int8 request {r.rid}: first token "
                            f"{r.tokens[0]} != one-shot generate's {ref}")
    log(f"int8 parity: first tokens (engine, generate) {firsts}; "
        f"{sum(a == b for a, b in firsts)}/{len(firsts)} equal")
    pair = reqs[:2]
    pool, pages, lg = _prefill(pair, eng, flash=False)
    toks = lg.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in pair], dtype=torch.int32,
                              device="cuda")
    lk = _decode_step_logits(eng, pool, pages, toks, lengths, True)
    with Q.plain_int8_products():
        lp = _decode_step_logits(eng, pool, pages, toks, lengths, False)
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    log(f"int8 parity decode logits kernel vs plain: max abs diff {err:.4f},"
        f" max |logit| {scale:.2f}, atol {INT8_LOGIT_ATOL}, argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}, top1-top2 gap "
        f"(plain) {_gap(lp)}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        failures.append("non-finite int8 decode logits")
    if not torch.allclose(lk, lp, atol=INT8_LOGIT_ATOL, rtol=0.0):
        failures.append(f"int8 decode logits kernel vs plain: max abs diff "
                        f"{err} over atol {INT8_LOGIT_ATOL}")
    del pool
    check(not failures, "; ".join(failures))


# ------------------------------------------------- training kernel phase

def _twice_equal(name, fn):
    """Launch ``fn`` twice on the same inputs; the results must be bit
    for bit equal (no float atomics: remat's recompute repeats)."""
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two launches on the same inputs differ")


def _entry(name, source, replaces, err, ratio, k_ms, p_ms, l_ms, b_ms,
           b_by):
    return {"name": name, "route": "cuda",
            "source": f"distributed_training_sandbox_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "gate_ratio": ratio, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "max_err": err, "kernel_ms": k_ms}


def fp8_phase(projections=PROJECTIONS, label="SmolLM3-3B") -> dict:
    """K6 at one layer's seven projections (M = 8192; ``projections``,
    by default SmolLM3-3B's): each against the plain version, then times
    summed over the seven.  Operands cycle through 3 copies so that no
    launch finds the last one's in L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    M = TRAIN["seq"] * TRAIN["bs"]
    atol, rtol = Q.TOLERANCE[torch.bfloat16]

    def k6(aq, a_s, bt, b_s):
        return Q.fp8_matmul_kernel(aq, a_s, bt, b_s)

    tot = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, flops=0.0)
    err = ratio = 0.0
    times = {}
    for name, K, N in projections:
        if (K, N) not in times:
            ops = []
            for _ in range(3):
                x = torch.randn((M, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                w = (torch.randn((K, N), generator=gen, device="cuda")
                     * 0.02).to(torch.bfloat16)
                # the weight's codes K-major, as the training path
                # quantises them
                ops.append((*Q.quantize_fp8(x), *Q.quantize_fp8_kmajor(w)))
            aq, a_s, bt, b_s = ops[0]
            got = k6(aq, a_s, bt, b_s)
            ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, torch.bfloat16)
            e = float((got.float() - ref.float()).abs().max())
            r = gate_ratio(got, ref, atol, rtol)
            _twice_equal("fp8_matmul", lambda: k6(aq, a_s, bt, b_s))
            check(torch.isfinite(got).all(), "fp8_matmul: non-finite output")
            check(r <= 1.0, f"fp8_matmul: ({M}, {K}) x ({K}, {N}) max |kernel"
                  f" - plain| = {e} over atol {atol} rtol {rtol} (gate "
                  f"ratio {r:.3f})")
            it = iter(range(10 ** 9))
            cyc = lambda: ops[next(it) % len(ops)]
            k_ms = time_ms(lambda: k6(*cyc()))
            p_ms = time_ms(lambda: (lambda a, sa, b, sb: Q.fp8_matmul(
                a, sa, b.t(), sb, torch.bfloat16))(*cyc()), iters=5)
            # the library's layout, B column-major, is the K-major codes'
            # transposed view
            l_ms = time_ms(lambda: (lambda a, sa, b, sb: torch._scaled_mm(
                a, b.t(), sa, sb, out_dtype=torch.bfloat16))(*cyc()))
            del ops, got, ref
            times[(K, N)] = (k_ms, p_ms, l_ms, e, r)
            log(f"fp8_matmul ({M}, {K}) x ({K}, {N}): max_abs_err {e:.3e}, "
                f"gate ratio {r:.4f} (atol {atol}, rtol {rtol}); kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, _scaled_mm {l_ms:.4f} "
                f"ms")
        k_ms, p_ms, l_ms, e, r = times[(K, N)]
        err, ratio = max(err, e), max(ratio, r)
        tot["k"] += k_ms
        tot["p"] += p_ms
        tot["l"] += l_ms
        # fp8 operands read once, bf16 output written once (the weight
        # arrives K-major: no copy)
        tot["nbytes"] += M * K + K * N + 2 * M * N
        tot["flops"] += 2 * M * K * N
    b_ms, b_by = bound(tot["nbytes"], tot["flops"], PEAK_FP8_FLOPS)
    log(f"fp8_matmul, {label}'s 7 projections: kernel {tot['k']:.4f} ms, "
        f"plain {tot['p']:.4f} ms, _scaled_mm {tot['l']:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({tot['nbytes'] / 1e6:.1f} MB, "
        f"{tot['flops'] / 1e12:.3f} TFLOP at fp8)")
    torch.cuda.empty_cache()
    return _entry("fp8_matmul", "fp8_matmul.cu",
                  "distributed_training_sandbox_tpu/ops/quant.py:613 "
                  "(fp8_matmul_pallas, _fp8_mm_kernel)", err, ratio,
                  tot["k"], tot["p"], tot["l"], b_ms, b_by)


def _int_mm_ms(a, b_kn, it, copies, timer=time_ms):
    """CUDA-event ms of ``torch._int_mm`` (int32 out, no scales) on
    row-major A and column-major B, cycling through ``copies``; None
    where its shape rules refuse (M must exceed 16)."""
    try:
        torch._int_mm(a[0], b_kn[0])
    except RuntimeError as e:
        log(f"torch._int_mm refuses ({a[0].shape[0]}, {a[0].shape[1]}) x "
            f"({b_kn[0].shape[0]}, {b_kn[0].shape[1]}): {str(e)[:80]}")
        return None
    return timer(lambda: torch._int_mm(*(lambda i: (a[i], b_kn[i]))(
        next(it) % copies)))


def _col_major(t):
    return t.t().contiguous().t()


def _gate_bitwise(name, shape, got, ref):
    """K4 and K5 must equal their plain versions bit for bit."""
    err = float((got.float() - ref.float()).abs().max())
    n = int((got != ref).sum())
    check(torch.isfinite(got).all(), f"{name}: non-finite output")
    check(n == 0, f"{name}: {shape} not bit-equal to the plain version: "
          f"{n} outputs differ, max |kernel - plain| {err}")
    return err


# K4 at decode: the rows it is gated at (the serve's 8 slots timed), and
# the weights as quantize_decode_params stores them ((K, N) codes, one
# scale a column): the seven projections and the unembedding
K4_DECODE_ROWS = (1, 8, 16)
K4_DECODE_SHAPES = PROJECTIONS + [("unembed", CFG.hidden_size,
                                   CFG.vocab_size)]
# K4 at the int8 prefill: one chunk of 256 rows (the mma.sync design)
K4_PREFILL_M = ENGINE["prefill_chunk"]
# K4 at the speculative verify: the serve's 8 slots x (SPEC_K + 1) rows,
# the mma.sync design (M > GEMV_MAX_M)
K4_VERIFY_M = ENGINE["max_batch"] * (SPEC_K + 1)


def _decode_operands(gen, M, K, N, copies=3):
    """``copies`` sets of (xq, xs, wq (K, N), ws) at decode"""
    sets = []
    for _ in range(copies):
        xq, xs = Q.quantize_int8(torch.randn((M, K), generator=gen,
                                             device="cuda"))
        wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                           dtype=torch.int8)
        ws = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
        sets.append((xq, xs, wq, ws))
    return sets


def k4_decode_gates() -> float:
    """K4 (its split-K GEMV) at every decode shape and each of
    ``K4_DECODE_ROWS``: bit-equal to the plain version and twice-launch
    equal.  Returns the max |kernel - plain| (0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    err = 0.0
    for name, K, N in K4_DECODE_SHAPES:
        for M in K4_DECODE_ROWS:
            ops = _decode_operands(gen, M, K, N, copies=1)[0]
            check(Q.k4_design(M, N, K, False) == "gemv",
                  f"int8_matmul decode: ({M}, {K}) x ({K}, {N}) does not "
                  f"take the GEMV")
            err = max(err, _gate_bitwise(
                "int8_matmul decode", f"{name} ({M}, {K}) x ({K}, {N})",
                Q.int8_matmul_kernel(*ops),
                Q.int8_matmul(*ops, torch.bfloat16)))
            _twice_equal("int8_matmul decode",
                         lambda: Q.int8_matmul_kernel(*ops))
            del ops
    log(f"int8_matmul decode: bit-equal at M {K4_DECODE_ROWS} on the seven "
        f"projections and the unembedding")
    return err


def int8_train_products(gen, projections, label: str = "",
                        copies: int = 3) -> dict:
    """K5 (the forward, the weight K-major as the training path passes
    it and in the reference's (K, N) layout) and K4 (the backward's dX
    and dW, both K-major, on its wgmma GEMM) at one layer's
    ``projections`` at M = 8192: bit-equal to the plain versions and
    twice-launch equal; CUDA-event times beside ``torch._int_mm`` and
    the bytes and operations of the bound, summed over the shapes, and
    the backward's quantisers timed.  Operands cycle through ``copies``
    copies so that no launch finds the last one's in L2."""
    M = TRAIN["seq"] * TRAIN["bs"]
    bf16 = torch.bfloat16
    pre = f"{label} " if label else ""
    zero = lambda: dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)  # noqa
    out = dict(t5=zero(), t4=zero(), e5=0.0, e4=0.0, lib_missing=set(),
               quant_ms=0.0, quant_copy_ms=0.0)
    t5, t4 = out["t5"], out["t4"]
    for name, K, N in projections:
        sets = []
        for _ in range(copies):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            g = (torch.randn((M, N), generator=gen, device="cuda")
                 * 1e-3).to(bf16)
            wq, ws = Q.quantize_int8(w, axis=0)
            # the training path's K5 weight: (N, K) codes, K-major
            wq_t, ws_t = Q.quantize_int8(w.t(), axis=-1)
            gq, gs = Q.quantize_int8(g, axis=-1)
            wq_n, ws_n = Q.quantize_int8(w, axis=1)
            # dW's operands as the backward quantises them: along M,
            # the codes K-major ((K, M) and (N, M))
            xq_t, xs_t = Q.quantize_int8(x.t(), axis=-1)
            gq_t, gs_t = Q.quantize_int8(g.t(), axis=-1)
            sets.append(dict(x=x, g=g, wq=wq, ws=ws, wq_t=wq_t, ws_t=ws_t,
                             xq=Q.quantize_int8(x)[0],
                             dx=(gq, gs, wq_n, ws_n.T, (1, 1)),
                             dw=(xq_t, xs_t, gq_t, gs_t.T, (1, 1))))
            del w
        it = iter(range(10 ** 9))
        c = lambda: sets[next(it) % copies]  # noqa: E731
        s0 = sets[0]
        shape = f"{pre}({M}, {K}) x ({K}, {N})"
        # the backward's quantisers of X and g along M into K-major
        # codes, and the same codes from a layout-keeping quantiser and
        # an int8 transposed copy (the parent's dW operand)
        out["quant_ms"] += time_ms(lambda: (lambda d: (
            Q.quantize_int8(d["x"].t(), axis=-1),
            Q.quantize_int8(d["g"].t(), axis=-1)))(c()), iters=5)
        out["quant_copy_ms"] += time_ms(lambda: (lambda d: (
            Q.quantize_int8(d["x"], axis=0)[0].t().contiguous(),
            Q.quantize_int8(d["g"], axis=0)[0].t().contiguous()))(c()),
            iters=5)

        def k5(d):
            return Q.int8_matmul_fused_kernel(d["x"], d["wq_t"], d["ws_t"],
                                              b_kmajor=True)

        ref = Q.int8_matmul_fused(s0["x"], s0["wq"], s0["ws"], bf16)
        out["e5"] = max(out["e5"], _gate_bitwise(
            "int8_matmul_fused", shape, k5(s0), ref))
        out["e5"] = max(out["e5"], _gate_bitwise(
            "int8_matmul_fused", f"{shape}, weight (K, N)",
            Q.int8_matmul_fused_kernel(s0["x"], s0["wq"], s0["ws"]), ref))
        del ref
        _twice_equal("int8_matmul_fused", lambda: k5(s0))
        k_ms = time_ms(lambda: k5(c()))
        p_ms = time_ms(lambda: (lambda d: Q.int8_matmul_fused(
            d["x"], d["wq"], d["ws"], bf16))(c()), iters=3, warmup=1)
        l_ms = _int_mm_ms([d["xq"] for d in sets],
                          [_col_major(d["wq"]) for d in sets], it, copies)
        t5["k"] += k_ms
        t5["p"] += p_ms
        t5["l"] += l_ms or 0.0
        if l_ms is None:
            out["lib_missing"].add("int8_matmul_fused")
        # what the function must move: bf16 x read once, the K-major
        # weight codes and their scales read, the bf16 output written
        # (x's codes and row scales are the kernel's own scratch; the
        # TPU kernel quantises inside its body)
        t5["nbytes"] += 2 * M * K + K * N + 4 * N + 2 * M * N
        t5["ops"] += 2 * M * K * N
        log(f"int8_matmul_fused {shape}: bit-equal; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, _int_mm {l_ms} ms")
        # K4: dX = g · Wᵀ and dW = Xᵀ · g, both operands K-major
        for prod, Mo, No, Kc in (("dx", M, K, N), ("dw", K, N, M)):
            sh = f"{pre}{prod} ({Mo}, {Kc}) x ({Kc}, {No})"
            got = Q._int8_dot(*s0[prod], bf16, plain=False)
            out["e4"] = max(out["e4"], _gate_bitwise(
                "int8_matmul", sh, got,
                Q._int8_dot(*s0[prod], bf16, plain=True)))
            del got
            _twice_equal("int8_matmul", lambda: Q._int8_dot(
                *s0[prod], bf16, plain=False))
            k_ms = time_ms(lambda: Q._int8_dot(*c()[prod], bf16, plain=False))
            p_ms = time_ms(lambda: Q._int8_dot(*c()[prod], bf16, plain=True),
                           iters=3, warmup=1)
            # the library's layout, B column-major, is B's K-major codes'
            # transposed view
            l_ms = _int_mm_ms([d[prod][0] for d in sets],
                              [d[prod][2].t() for d in sets], it, copies)
            t4["k"] += k_ms
            t4["p"] += p_ms
            t4["l"] += l_ms or 0.0
            if l_ms is None:
                out["lib_missing"].add("int8_matmul")
            # int8 operands read once, bf16 output written once, scales
            t4["nbytes"] += (Mo * Kc + Kc * No + 4 * (Mo + No)
                             + 2 * Mo * No)
            t4["ops"] += 2 * Mo * No * Kc
            log(f"int8_matmul {sh}: bit-equal; kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, _int_mm {l_ms} ms")
        del sets
        torch.cuda.empty_cache()
    return out


def int8_gemm_phase() -> list[dict]:
    """K5 and K4 at one layer's seven projections at M = 8192
    (:func:`int8_train_products`), then K4 at decode (the split-K GEMV:
    :func:`k4_decode_gates`, then times at M = 8, the seven projections
    and the unembedding, in CUDA-graph replays) and at one prefill chunk
    (M = 256, mma.sync): bit-equal to the plain versions and
    twice-launch equal; times summed over the shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    M = TRAIN["seq"] * TRAIN["bs"]
    bf16 = torch.bfloat16
    tr = int8_train_products(gen, PROJECTIONS)
    t5, t4, e5, e4 = tr["t5"], tr["t4"], tr["e5"], tr["e4"]
    lib_missing = tr["lib_missing"]
    quant_ms, quant_copy_ms = tr["quant_ms"], tr["quant_copy_ms"]
    b5 = bound(t5["nbytes"], t5["ops"], PEAK_INT8_OPS)
    b4 = bound(t4["nbytes"], t4["ops"], PEAK_INT8_OPS)
    for nm, t, b in (("int8_matmul_fused", t5, b5), ("int8_matmul", t4, b4)):
        log(f"{nm}, one layer's 7 projections at M = {M}: kernel "
            f"{t['k']:.4f} ms, plain {t['p']:.4f} ms, _int_mm {t['l']:.4f} "
            f"ms, bound {b[0]:.4f} ms by {b[1]} ({t['nbytes'] / 1e6:.1f} "
            f"MB, {t['ops'] / 1e12:.3f} T int8 operations)")
    log(f"the int8 backward's quantisers (plain PyTorch) of X and g along "
        f"M into K-major codes, one layer's 7 projections: {quant_ms:.4f} "
        f"ms; a layout-keeping quantiser and an int8 transposed copy "
        f"instead: {quant_copy_ms:.4f} ms")

    # K4 at decode: gated at every decode row count, timed at the serve's
    # 8 rows in CUDA-graph replays (a host loop would time the launch);
    # the library yardstick is torch._int_mm on the 8 rows zero-padded
    # to the fewest rows it takes
    e4 = max(e4, k4_decode_gates())
    dec = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)
    unembed, pad_rows = None, None
    Md = ENGINE["max_batch"]
    for name, K, N in K4_DECODE_SHAPES:
        sets = _decode_operands(gen, Md, K, N)
        it = iter(range(10 ** 9))
        shape = f"decode {name} ({Md}, {K}) x ({K}, {N})"
        k_ms = graph_ms(lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]))
        p_ms = time_ms(lambda: Q.int8_matmul(*sets[next(it) % 3], bf16))
        l_ms = None
        for rows in (17, 24, 32):
            la = [torch.nn.functional.pad(d[0], (0, 0, 0, rows - Md))
                  for d in sets]
            l_ms = _int_mm_ms(la, [_col_major(d[2]) for d in sets], it, 3,
                              graph_ms)
            if l_ms is not None:
                pad_rows = rows
                break
        nbytes = Md * K + K * N + 4 * (Md + N) + 2 * Md * N
        b_ms = bound(nbytes, 2 * Md * K * N, PEAK_INT8_OPS)[0]
        log(f"int8_matmul {shape}: kernel {k_ms:.5f} ms (graph replays), "
            f"plain {p_ms:.4f} ms, _int_mm on {pad_rows} rows (padded) "
            f"{l_ms} ms, bound {b_ms:.5f} ms by bytes "
            f"({nbytes / 1e6:.2f} MB)")
        if name == "unembed":
            unembed = (k_ms, p_ms, l_ms, b_ms)
        else:
            dec["k"] += k_ms
            dec["p"] += p_ms
            dec["l"] += l_ms or 0.0
            dec["nbytes"] += nbytes
            dec["ops"] += 2 * Md * K * N
        del sets
    torch.cuda.empty_cache()
    db = bound(dec["nbytes"], dec["ops"], PEAK_INT8_OPS)
    log(f"int8_matmul at decode, one layer's 7 projections (M = {Md}): "
        f"kernel {dec['k']:.5f} ms, plain {dec['p']:.4f} ms, _int_mm on "
        f"{pad_rows} rows (padded) {dec['l']:.5f} ms, bound {db[0]:.5f} ms "
        f"by {db[1]}; the unembedding: kernel {unembed[0]:.5f} ms, plain "
        f"{unembed[1]:.4f} ms, _int_mm (padded) {unembed[2]} ms, bound "
        f"{unembed[3]:.5f} ms")

    # K4 at one int8 prefill chunk: M = 256 rows, (K, N) weights
    pre = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)
    Mp = K4_PREFILL_M
    for name, K, N in PROJECTIONS:
        sets = _decode_operands(gen, Mp, K, N)
        it = iter(range(10 ** 9))
        shape = f"prefill {name} ({Mp}, {K}) x ({K}, {N})"
        check(Q.k4_design(Mp, N, K, False) == "mma",
              f"int8_matmul: {shape} does not take the mma.sync GEMM")
        e4 = max(e4, _gate_bitwise("int8_matmul", shape,
                                   Q.int8_matmul_kernel(*sets[0]),
                                   Q.int8_matmul(*sets[0], bf16)))
        _twice_equal("int8_matmul", lambda: Q.int8_matmul_kernel(*sets[0]))
        k_ms = time_ms(lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]))
        p_ms = time_ms(lambda: Q.int8_matmul(*sets[next(it) % 3], bf16))
        l_ms = _int_mm_ms([d[0] for d in sets],
                          [_col_major(d[2]) for d in sets], it, 3)
        pre["k"] += k_ms
        pre["p"] += p_ms
        pre["l"] += l_ms or 0.0
        pre["nbytes"] += Mp * K + K * N + 4 * (Mp + N) + 2 * Mp * N
        pre["ops"] += 2 * Mp * K * N
        log(f"int8_matmul {shape}: bit-equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, _int_mm {l_ms} ms")
        del sets
    torch.cuda.empty_cache()
    pb = bound(pre["nbytes"], pre["ops"], PEAK_INT8_OPS)
    log(f"int8_matmul at prefill, one layer's 7 projections (M = {Mp}): "
        f"kernel {pre['k']:.4f} ms, plain {pre['p']:.4f} ms, _int_mm "
        f"{pre['l']:.4f} ms, bound {pb[0]:.5f} ms by {pb[1]}")

    # K4 at the speculative verify (phase 18c): M = 32 rows, every
    # projection and the unembedding, the mma.sync design
    ver = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)
    Mv = K4_VERIFY_M
    for name, K, N in K4_DECODE_SHAPES:
        sets = _decode_operands(gen, Mv, K, N)
        it = iter(range(10 ** 9))
        shape = f"verify {name} ({Mv}, {K}) x ({K}, {N})"
        check(Q.k4_design(Mv, N, K, False) == "mma",
              f"int8_matmul verify: {shape} does not take the mma.sync GEMM")
        e4 = max(e4, _gate_bitwise("int8_matmul verify", shape,
                                   Q.int8_matmul_kernel(*sets[0]),
                                   Q.int8_matmul(*sets[0], bf16)))
        _twice_equal("int8_matmul verify",
                     lambda: Q.int8_matmul_kernel(*sets[0]))
        k_ms = graph_ms(lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]))
        p_ms = time_ms(lambda: Q.int8_matmul(*sets[next(it) % 3], bf16))
        l_ms = _int_mm_ms([d[0] for d in sets],
                          [_col_major(d[2]) for d in sets], it, 3, graph_ms)
        nbytes = Mv * K + K * N + 4 * (Mv + N) + 2 * Mv * N
        b_ms = bound(nbytes, 2 * Mv * K * N, PEAK_INT8_OPS)[0]
        log(f"int8_matmul {shape}: bit-equal; kernel {k_ms:.5f} ms (graph "
            f"replays), plain {p_ms:.4f} ms, _int_mm {l_ms} ms (graph), "
            f"bound {b_ms:.5f} ms")
        if name == "unembed":
            ver_unembed = (k_ms, p_ms, l_ms, b_ms)
        else:
            ver["k"] += k_ms
            ver["p"] += p_ms
            ver["l"] += l_ms or 0.0
            ver["nbytes"] += nbytes
            ver["ops"] += 2 * Mv * K * N
        del sets
    torch.cuda.empty_cache()
    vb = bound(ver["nbytes"], ver["ops"], PEAK_INT8_OPS)
    log(f"int8_matmul at the verify, one layer's 7 projections (M = {Mv}): "
        f"kernel {ver['k']:.5f} ms, plain {ver['p']:.4f} ms, _int_mm "
        f"{ver['l']:.5f} ms, bound {vb[0]:.5f} ms by {vb[1]}; the "
        f"unembedding: kernel {ver_unembed[0]:.5f} ms, _int_mm "
        f"{ver_unembed[2]} ms, bound {ver_unembed[3]:.5f} ms")
    k5 = _entry("int8_matmul_fused", "int8_matmul.cu",
                "distributed_training_sandbox_tpu/ops/quant.py:226 "
                "(int8_matmul_pallas_fused, _fused_qmm_kernel :210)", e5, 0.0,
                t5["k"], t5["p"],
                None if "int8_matmul_fused" in lib_missing else t5["l"],
                *b5)
    k4 = _entry("int8_matmul", "int8_matmul.cu",
                "distributed_training_sandbox_tpu/ops/quant.py:162 "
                "(int8_matmul_pallas, _qmm_kernel :153)", e4, 0.0, t4["k"],
                t4["p"], None if "int8_matmul" in lib_missing else t4["l"],
                *b4)
    k4.update(decode_layer_ms=dec["k"], decode_layer_plain_ms=dec["p"],
              decode_layer_library_padded_ms=dec["l"],
              decode_library_rows=pad_rows,
              decode_layer_bound_ms=db[0], unembed_ms=unembed[0],
              unembed_plain_ms=unembed[1],
              unembed_library_padded_ms=unembed[2],
              unembed_bound_ms=unembed[3], prefill_layer_ms=pre["k"],
              prefill_layer_plain_ms=pre["p"],
              prefill_layer_library_ms=pre["l"],
              prefill_layer_bound_ms=pb[0], verify_layer_ms=ver["k"],
              verify_layer_plain_ms=ver["p"],
              verify_layer_library_ms=ver["l"], verify_layer_bound_ms=vb[0],
              verify_unembed_ms=ver_unembed[0],
              verify_unembed_library_ms=ver_unembed[2],
              bwd_quantisers_layer_ms=quant_ms,
              bwd_quantisers_copy_layer_ms=quant_copy_ms)
    return [k4, k5]


def _fa_reading(kernel, name, got, ref, which) -> tuple[float, float]:
    """Log one flash-attention output against the plain version: its
    elementwise gate ratio (and the worst element), and its largest
    64-row block relative L2 error over ``FA.BLOCK_REL_L2``.  Returns
    (max abs error, gate ratio: the larger of the two)."""
    atol, rtol = FA.TOLERANCE[which]
    g, r = got.float(), ref.float()
    q = (g - r).abs() / (atol + rtol * r.abs())
    i = int(q.argmax())
    pos = i // (r.shape[2] * r.shape[3]) % r.shape[1]
    err, ratio = float((g - r).abs().max()), float(q.max())
    blk = FA.block_rel_l2(got, ref)
    log(f"{kernel}: {name} max_abs_err {err:.3e}; elementwise ratio "
        f"{ratio:.4f} (atol {atol}, rtol {rtol}), worst at position {pos}: "
        f"plain {float(r.flatten()[i]):.4e}, kernel "
        f"{float(g.flatten()[i]):.4e}; block relative L2 {blk:.5f} (limit "
        f"{FA.BLOCK_REL_L2})")
    return err, max(ratio, blk / FA.BLOCK_REL_L2)


def _heads(cfg) -> tuple[int, int, int]:
    """(nq, nkv, hd) of a config."""
    return (cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.resolved_head_dim)


def fa_draws(heads=None):
    """``FA_ORACLE_DRAWS`` draws of (q, k, v): B 1, S ``FA_ORACLE_SEQ``,
    bf16, at ``heads`` (nq, nkv, hd; default the training shape's 16 / 4
    heads at hd 128)."""
    nq, nkv, hd = heads or _heads(TRAIN_CFG)
    for d in range(FA_ORACLE_DRAWS):
        gen = torch.Generator(device="cuda").manual_seed(FA_ORACLE_SEED + d)
        yield tuple(torch.randn((1, FA_ORACLE_SEQ, n, hd), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for n in (nq, nkv, nkv))


def fa_oracle_reading(kernels, label="flash_attention_fwd",
                      gated=None, heads=None) -> dict:
    """The FA forward over :func:`fa_draws` beside the f64 oracle of the
    reference's arithmetic (``FA.attention_oracle``): for each kernel of
    ``kernels`` (name -> fn(q, k, v, scale) -> (O, lse)) and the plain
    path, O's count of outputs off the oracle by more than a quarter of
    the elementwise tolerance (``FA.off_count``), summed over the draws,
    and each kernel's count off the plain path; the max |difference| of
    each.  Gates the kernels named in ``gated`` (all by default): their
    count off the oracle over the plain path's, at most
    ``FA.ORACLE_COUNT_RATIO``.  ``heads``: :func:`fa_draws`'."""
    gated = set(kernels) if gated is None else set(gated)
    nq, nkv, hd = heads or _heads(TRAIN_CFG)
    scale = hd ** -0.5
    read = {f"{n} - {r}": [0.0, 0] for n in kernels
            for r in ("oracle", "plain")}
    read["plain - oracle"] = [0.0, 0]
    for q, k, v in fa_draws(heads):
        orc = FA.attention_oracle(q, k, v, scale)
        ref = FA.attention_plain_lse(q, k, v, scale)[0]
        pairs = [("plain - oracle", ref, orc)]
        for n, fn in kernels.items():
            got = fn(q, k, v, scale)[0]
            pairs += [(f"{n} - oracle", got, orc), (f"{n} - plain", got, ref)]
        torch.cuda.synchronize()
        for key, a, b in pairs:
            read[key][0] = max(read[key][0], float(
                (a.double() - b.double()).abs().max()))
            read[key][1] += FA.off_count(a, b)
        del orc, ref, pairs
        torch.cuda.empty_cache()
    plain = read["plain - oracle"][1]
    ratios = {n: read[f"{n} - oracle"][1] / max(plain, 1) for n in kernels}
    log(f"{label} over {FA_ORACLE_DRAWS} draws (B 1, S {FA_ORACLE_SEQ}, "
        f"{nq} / {nkv} heads, hd {hd}), "
        f"(max |difference|, outputs off by > a quarter of the elementwise "
        f"tolerance): {json.dumps(read)}; each kernel's count off the "
        f"oracle over the plain path's {json.dumps(ratios)} (limit "
        f"{FA.ORACLE_COUNT_RATIO} for {sorted(gated)})")
    for n in sorted(gated):
        check(ratios[n] <= FA.ORACLE_COUNT_RATIO,
              f"{n} oracle: {read[f'{n} - oracle'][1]} outputs off the f64 "
              f"oracle, {ratios[n]:.3f} times the plain path's {plain}, "
              f"above {FA.ORACLE_COUNT_RATIO}")
    return {"readings": read, "oracle_ratio": ratios}


def attention_phase(heads=None, seed=SEED + 2) -> list[dict]:
    """The flash attention at the training shape (B 1, S 8192, bf16; at
    ``heads`` (nq, nkv, hd), by default the 16 query and 4 kv heads at
    hd 128 of ``TRAIN_CFG``), forward and backward, against the plain
    version, the forward over its f64 oracle reading too; inputs cycle
    through 3 copies."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S = TRAIN["bs"], TRAIN["seq"]
    nq, nkv, hd = heads or _heads(TRAIN_CFG)
    scale = hd ** -0.5
    log(f"flash attention at B {B}, S {S}, {nq} / {nkv} heads, hd {hd}")
    mk = lambda n: torch.randn((B, S, n, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
    sets = [(mk(nq), mk(nkv), mk(nkv), mk(nq)) for _ in range(3)]
    q, k, v, do = sets[0]
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    e_o, r_o = _fa_reading("flash_attention_fwd", "O", o, ref_o, "fwd")
    e_lse = float((lse - ref_lse).abs().max())
    r_fwd = max(r_o, e_lse / FA.LSE_ATOL)
    log(f"flash_attention_fwd: logsumexp max_abs_err {e_lse:.3e} (atol "
        f"{FA.LSE_ATOL}); gate ratio {r_fwd:.4f}")
    check(torch.isfinite(o).all(), "flash_attention_fwd: non-finite output")
    check(r_fwd <= 1.0, f"flash_attention_fwd: O max |kernel - plain| "
          f"{e_o}, logsumexp {e_lse} (gate ratio {r_fwd:.3f})")
    _twice_equal("flash_attention_fwd",
                 lambda: FA.flash_attention_fwd(q, k, v, scale))
    del ref_o, ref_lse
    torch.cuda.empty_cache()
    oracle = fa_oracle_reading({"flash_attention_fwd": FA.flash_attention_fwd},
                               heads=(nq, nkv, hd))
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ref_g = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    e_g, r_g = zip(*(_fa_reading("flash_attention_bwd", n, g, r, "bwd")
                     for n, g, r in zip(("dq", "dk", "dv"), grads, ref_g)))
    r_bwd = max(r_g)
    log(f"flash_attention_bwd: gate ratio {r_bwd:.4f}")
    check(all(torch.isfinite(g).all() for g in grads),
          "flash_attention_bwd: non-finite grads")
    check(r_bwd <= 1.0, f"flash_attention_bwd: max |kernel - plain| "
          f"{max(e_g)} (gate ratio {r_bwd:.3f})")
    _twice_equal("flash_attention_bwd", lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, do, scale))
    del grads, ref_g
    torch.cuda.empty_cache()

    it = iter(range(10 ** 9))
    cyc = lambda: sets[next(it) % len(sets)]
    saved = [(*s[:3], *FA.flash_attention_fwd(*s[:3], scale), s[3])
             for s in sets]
    fwd_ms = time_ms(lambda: FA.flash_attention_fwd(*cyc()[:3], scale))
    bwd_ms = time_ms(lambda: FA.flash_attention_bwd(
        *saved[next(it) % len(saved)], scale))
    fwd_plain = time_ms(lambda: FA.attention_plain_lse(*cyc()[:3], scale),
                        iters=3, warmup=1)
    bwd_plain = time_ms(lambda: FA.flash_attention_bwd_plain(*cyc(), scale),
                        iters=3, warmup=1)
    # SDPA over K/V repeated to the query heads outside the timed region;
    # its backward timed alone on a retained graph
    rep = nq // nkv
    sd = []
    for q_, k_, v_, do_ in sets:
        args = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in
                (q_, k_.repeat_interleave(rep, 2), v_.repeat_interleave(rep,
                                                                       2))]
        out = torch.nn.functional.scaled_dot_product_attention(
            *args, is_causal=True, scale=scale)
        sd.append((args, out, do_.transpose(1, 2).contiguous()))
    fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *[a.detach() for a in sd[next(it) % 3][0]], is_causal=True,
        scale=scale))

    def sdpa_bwd():
        args, out, g = sd[next(it) % 3]
        return torch.autograd.grad(out, args, g, retain_graph=True)

    bwd_lib = time_ms(sdpa_bwd)
    del sd, saved, sets
    torch.cuda.empty_cache()

    item = 2
    io = (2 * B * S * nq * hd + 2 * B * S * nkv * hd) * item   # q, o; k, v
    f_flops = 2.0 * B * nq * S * S * hd   # causal QK and PV
    fb, fby = bound(io + B * nq * S * 4, f_flops)
    # backward: q, k, v, o, dO read, dq, dk, dv written, lse read
    bb, bby = bound(io + B * S * nq * hd * item * 2
                    + 2 * B * S * nkv * hd * item + B * nq * S * 4,
                    2.5 * f_flops)
    log(f"flash_attention_fwd: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f}"
        f" ms, SDPA {fwd_lib:.4f} ms, bound {fb:.4f} ms by {fby} "
        f"({f_flops / 1e12:.3f} TFLOP)")
    log(f"flash_attention_bwd: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f}"
        f" ms, SDPA backward {bwd_lib:.4f} ms, bound {bb:.4f} ms by {bby}")
    replaces = ("distributed_training_sandbox_tpu/models/transformer.py:382 "
                "(_attention_flash, splash attention {})")
    return [
        dict(_entry("flash_attention_fwd", "flash_attention.cu",
                    replaces.format("forward"), max(e_o, e_lse), r_fwd,
                    fwd_ms, fwd_plain, fwd_lib, fb, fby),
             oracle_ratio=oracle["oracle_ratio"]["flash_attention_fwd"]),
        _entry("flash_attention_bwd", "flash_attention.cu",
               replaces.format("dq / dkv backward"), max(e_g), r_bwd,
               bwd_ms, bwd_plain, bwd_lib, bb, bby)]


def ag_matmul_phase() -> dict:
    """K7 at one layer's seven projections at one rank (M = 8192, the
    whole weight a chunk) and at a rank's K-chunk of a four-rank ring
    (Kc 512 and 2752, the activation's chunk a strided view): each
    against the plain version and launched twice bit for bit; then
    CUDA-event times of K7, the plain version and ``torch.matmul`` on
    the same bf16 operands (the yardstick), summed over the seven.
    Operands cycle through 3 copies so that no launch finds the last
    one's in L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    M = FSDP_TRAIN["seq"] * FSDP_TRAIN["bs"]
    atol, rtol = C.TOLERANCE[torch.bfloat16]
    tot = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, flops=0.0)
    err = ratio = 0.0
    times, chunks = {}, {}
    shapes = [(n, K, K, N) for n, K, N in PROJECTIONS] + AG_CHUNKS
    for name, K, Kc, N in shapes:
        key = (K, Kc, N)
        if key not in times:
            ops = []
            for i in range(3):
                a = torch.randn((M, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                w = (torch.randn((Kc, N), generator=gen, device="cuda")
                     * 0.02).to(torch.bfloat16)
                c0 = (i + 1) % (K // Kc) * Kc   # a chunk off the start
                ops.append((a[:, c0:c0 + Kc], w))
            a2, w = ops[0]
            got = C.ag_matmul_kernel(a2, w)
            ref = C.ag_matmul_plain(a2, w)
            e = float((got.float() - ref.float()).abs().max())
            r = gate_ratio(got, ref, atol, rtol)
            n_diff = int((got != ref).sum())
            small = ref.float().abs() < 2 ** -10
            e_small = float((got.float() - ref.float()).abs()[small].max())
            shape = f"({M}, {Kc}) x ({Kc}, {N})" + (
                f", a strided (row stride {K})" if Kc < K else "")
            log(f"ag_matmul {shape}: max_abs_err {e:.3e} ({e_small:.3e} "
                f"where |plain| < 2^-10), gate ratio {r:.4f} (atol {atol}, "
                f"rtol {rtol}); {n_diff} of {got.numel()} outputs differ "
                f"from the plain version")
            check(torch.isfinite(got).all(), "ag_matmul: non-finite output")
            check(r <= 1.0, f"ag_matmul: {shape} max |kernel - plain| = {e}"
                  f" over atol {atol} rtol {rtol} (gate ratio {r:.3f})")
            _twice_equal("ag_matmul", lambda: C.ag_matmul_kernel(a2, w))
            it = iter(range(10 ** 9))
            cyc = lambda: ops[next(it) % len(ops)]  # noqa: E731
            k_ms = time_ms(lambda: C.ag_matmul_kernel(*cyc()))
            p_ms = time_ms(lambda: C.ag_matmul_plain(*cyc()), iters=5)
            l_ms = time_ms(lambda: torch.matmul(*cyc()))
            del ops, got, ref
            times[key] = (k_ms, p_ms, l_ms, e, r)
            log(f"ag_matmul {shape}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, torch.matmul {l_ms:.4f} ms")
        k_ms, p_ms, l_ms, e, r = times[key]
        err, ratio = max(err, e), max(ratio, r)
        # bf16 operands read once (the chunk of a in place), bf16 out
        nbytes = 2 * (M * Kc + Kc * N + M * N)
        flops = 2 * M * Kc * N
        if Kc < K:
            b_ms, b_by = bound(nbytes, flops)
            chunks[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by)
            log(f"ag_matmul {name}: bound {b_ms:.4f} ms by {b_by}")
            continue
        tot["k"] += k_ms
        tot["p"] += p_ms
        tot["l"] += l_ms
        tot["nbytes"] += nbytes
        tot["flops"] += flops
    b_ms, b_by = bound(tot["nbytes"], tot["flops"])
    log(f"ag_matmul, one layer's 7 projections at one rank: kernel "
        f"{tot['k']:.4f} ms, plain {tot['p']:.4f} ms, torch.matmul "
        f"{tot['l']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({tot['nbytes'] / 1e6:.1f} MB, {tot['flops'] / 1e12:.3f} TFLOP)")
    torch.cuda.empty_cache()
    entry = _entry("ag_matmul", "ag_matmul.cu",
                   "distributed_training_sandbox_tpu/ops/collectives.py:391 "
                   "(all_gather_matmul_pallas, pallas_call :350, "
                   "_agmm_chunk_kernel :333)", err, ratio, tot["k"],
                   tot["p"], tot["l"], b_ms, b_by)
    entry["four_rank_chunks"] = chunks
    return entry


# ------------------------------------------------------------ train phases

def _first_batch():
    """run_leg's first batch."""
    ib, lb = next(flagship.leg_batches(TRAIN_CFG.vocab_size, TRAIN["seq"],
                                       TRAIN["bs"], TRAIN["num_steps"],
                                       TRAIN["seed"]))
    return (torch.as_tensor(ib, device="cuda"),
            torch.as_tensor(lb, device="cuda"))


def train_parity_phase() -> float:
    """Step-0 loss and grads on run_leg's params and first batch: the
    kernel path (K6 forward, flash attention) against the plain path
    (plain fp8 forward, plain attention at S = 8192, which fits under
    per-layer checkpointing).  Returns the kernel path's loss."""
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"])
    params = T.init_params(TRAIN_CFG, gen, "cuda")
    batch = _first_batch()
    plain_cfg = dataclasses.replace(TRAIN_CFG, matmul_precision="fp8",
                                    attention_impl="xla")
    # without fp8: bf16 projections, the flash kernels against the plain
    # attention
    bf16_cfg = dataclasses.replace(TRAIN_CFG, matmul_precision="bf16")
    bf16_plain = dataclasses.replace(bf16_cfg, attention_impl="xla")
    out = {}
    for name, cfg in (("kernel", TRAIN_CFG), ("plain", plain_cfg),
                      ("bf16 flash", bf16_cfg), ("bf16 plain", bf16_plain)):
        t = time.perf_counter()
        loss, grads = fsdp.microbatch_value_and_grad(
            lambda p, b, cfg=cfg: T.lm_loss(p, b, cfg), params, batch, 1)
        out[name] = (float(loss), grads)
        log(f"train parity: {name} path loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s)")
    def rel_l2(ga, gb):
        return {"/".join(path): float(
            torch.linalg.vector_norm(a.float() - fsdp.optim.tree_get(gb, path)
                                     .float())
            / torch.linalg.vector_norm(fsdp.optim.tree_get(gb, path).float()))
            for path, a in fsdp.optim.tree_leaves(ga)}

    (lb, gb), (lbp, gbp) = out.pop("bf16 flash"), out.pop("bf16 plain")
    rel_b = rel_l2(gb, gbp)
    worst_b = max(rel_b, key=rel_b.get)
    log(f"train parity without fp8: |loss flash - plain| "
        f"{abs(lb - lbp):.6f}; grad relative L2, worst leaf {worst_b} "
        f"{rel_b[worst_b]:.5f} (limit {BF16_GRAD_REL_L2})")
    del gb, gbp
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    rel = rel_l2(gk, gp)
    worst = max(rel, key=rel.get)
    log(f"train parity: |loss kernel - plain| {abs(lk - lp):.6f} (atol "
        f"{LOSS_ATOL}); grad relative L2, worst leaf {worst} "
        f"{rel[worst]:.5f} (limit {GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("step-0 loss: non-finite")
    if abs(lk - lp) > LOSS_ATOL:
        failures.append(f"step-0 loss: |kernel - plain| {abs(lk - lp)} over "
                        f"{LOSS_ATOL}")
    if not rel[worst] <= GRAD_REL_L2:
        failures.append(f"step-0 grads: {worst} relative L2 {rel[worst]} "
                        f"over {GRAD_REL_L2}")
    if not (np.isfinite(lb) and rel_b[worst_b] <= BF16_GRAD_REL_L2):
        failures.append(f"step-0 bf16 grads: {worst_b} relative L2 "
                        f"{rel_b[worst_b]} over {BF16_GRAD_REL_L2}")
    del params, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def _step_profile(prof, wall_us, label, step) -> None:
    """Log one profiled step: the device's busy and idle share of its
    wall time and the kernels that take the most device time."""
    # device-side entries only: a CPU op's entry repeats the device time
    # of the kernels it launched (a profile of CPU and CUDA activity),
    # and so does a record_function range's annotation on the device
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0
           and e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)
           and e.key not in STEP_SCOPES]
    busy_us = sum(d for _, _, d in dev)
    if not dev:
        log(f"{label} profile: torch.profiler recorded no device time (not "
            f"measured)")
        return
    log(f"{label} profile (step {step}): device busy {busy_us / 1e3:.1f} ms "
        f"of {wall_us / 1e3:.1f} ms wall, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for key, cnt, d in sorted(dev, key=lambda e: -e[2])[:10]:
        log(f"{label} profile: {d / busy_us:.3f} of device time, {cnt} "
            f"calls, {d / 1e3:.1f} ms: {key[:90]}")


def train_phase(card: str, loss0: float, train=None, cfg=None,
                expect=None, label="train") -> dict:
    """``train["num_steps"]`` steps of run_leg on the card (default: the
    fp8 leg, ``TRAIN``); ``expect`` maps each kernel's name to (its
    counter, launches per step).  Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    train, cfg = train or TRAIN, cfg or TRAIN_CFG
    L = cfg.num_hidden_layers
    if expect is None:   # the fp8 path: K6 forward, the flash attention
        expect = {"fp8_matmul": (Q.COUNTS, L * len(PROJECTIONS) * 2),
                  "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
                  "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    for c in (Q.COUNTS, Q.BWD_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS,
              FA.FWD_COUNTS, FA.BWD_COUNTS):
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = train["num_steps"]
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        log(f"{label} step {i}: loss {loss!r}")
        if i == n - 2:   # trace the last step: device activity only
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = flagship.run_leg(train["model"], train["precision"], train["seq"],
                           train["bs"], n, train["warmup_steps"],
                           train["peak_lr"], seed=train["seed"],
                           device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {name: (c.launches, c.plain_calls)
              for name, (c, _) in expect.items()}
    want = {name: n * per for name, (_, per) in expect.items()}
    losses = res["losses"]
    times = res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])   # unprofiled, after step 0
    tok_s = train["seq"] * train["bs"] / step_s
    flops_tok = T.model_flops_per_token(cfg, train["seq"])
    log(f"{label} on {card}: losses {losses}; lrs {res['lrs']}")
    log(f"{label}: step times (s, host clock, each ending in a sync) "
        f"{steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f" ({flops_tok:.4e} model FLOP/token over the 989 TFLOP/s bf16 "
        f"dense peak); run_leg tokens_per_second "
        f"{res['tokens_per_second']:.1f}; peak memory {peak / 2 ** 30:.2f} "
        f"GiB")
    log(f"{label} launches (kernel, plain): {json.dumps(counts)}; expected "
        f"kernel launches {json.dumps(want)}; the fp8 backward's plain "
        f"products {Q.BWD_COUNTS.plain_calls}")
    log(f"{label}: step-0 loss {losses[0]!r}, the parity phase's kernel "
        f"path {loss0!r}, bit-equal {losses[0] == loss0}")
    check(losses[0] == loss0, f"{label}: step-0 loss {losses[0]!r} of the "
          f"run is not the parity phase's {loss0!r} (same params and batch)")
    _step_profile(prof, marks["wall_us"], label, n - 1)
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"{label}: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"{label}: step-{n - 1} loss {losses[-1]} "
          f"is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


def int8_train_parity_phase() -> float:
    """Step-0 loss and grads at ``int8_pallas_bwd`` on run_leg's params
    and first batch, the flash attention on both sides: the kernel path
    (K5 forward, K4 dX and dW) against the plain int8 products
    (``quant.plain_int8_products``).  Every int8 product is exact and
    both sides round at the same points, so the loss and every grad leaf
    must be bit-equal.  Returns the kernel path's loss."""
    gen = torch.Generator(device="cuda").manual_seed(INT8_TRAIN["seed"])
    params = T.init_params(INT8_TRAIN_CFG, gen, "cuda")
    batch = _first_batch()
    out = {}
    for name in ("kernel", "plain"):
        t = time.perf_counter()
        with (Q.plain_int8_products() if name == "plain"
              else contextlib.nullcontext()):
            loss, grads = fsdp.microbatch_value_and_grad(
                lambda p, b: T.lm_loss(p, b, INT8_TRAIN_CFG), params, batch, 1)
        torch.cuda.synchronize()
        out[name] = (float(loss), grads)
        log(f"int8 train parity: {name} path loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s)")
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    unequal = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path)
        if not torch.equal(a, b):
            unequal["/".join(path)] = float((a.float() - b.float()).abs().max())
    log(f"int8 train parity: loss kernel {lk!r} plain {lp!r} (bit-equal "
        f"{lk == lp}); grad leaves not bit-equal: {json.dumps(unequal)}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("int8 step-0 loss: non-finite")
    if lk != lp:
        failures.append(f"int8 step-0 loss: kernel {lk!r} != plain {lp!r}")
    if unequal:
        failures.append(f"int8 step-0 grads: {len(unequal)} leaves not "
                        f"bit-equal, max |kernel - plain| "
                        f"{max(unequal.values())}")
    del params, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def _fsdp_inputs():
    """train_fsdp.run's shards (seeded init, this rank's rows) and first
    global batch."""
    gen = torch.Generator(device="cuda").manual_seed(FSDP_TRAIN["seed"])
    shards = fsdp.shard_params_fsdp(T.init_params(FSDP_CFG, gen, "cuda"))
    ib, lb = next(train_fsdp.fsdp_batches(
        FSDP_CFG.vocab_size, FSDP_TRAIN["seq"], FSDP_TRAIN["bs"],
        FSDP_TRAIN["num_steps"], FSDP_TRAIN["seed"]))
    return shards, (torch.as_tensor(ib, device="cuda"),
                    torch.as_tensor(lb, device="cuda"))


def fsdp_train_parity_phase() -> float:
    """On a one-rank NCCL group (made here, as torchrun would give it):
    the FSDP step's step-0 loss and grads at ``ring_fused_pallas`` (every
    projection through K7; the backward plain bf16 products) against
    ``none`` (the gathers, then plain bf16 products), on train_fsdp.run's
    shards and first batch.  Returns the K7 path's loss."""
    mesh.init_process_group("cuda")
    log(f"fsdp: process group of {mesh.axis_size()} rank(s), backend "
        f"{torch.distributed.get_backend()}")
    shards, batch = _fsdp_inputs()
    L = FSDP_CFG.num_hidden_layers
    out = {}
    for overlap in ("ring_fused_pallas", "none"):
        C.COUNTS.reset()
        C.COLLECTIVES.reset()
        t = time.perf_counter()
        vg = fsdp.make_fsdp_value_and_grad(shards, FSDP_CFG, overlap=overlap)
        loss, grads = vg(shards, batch)
        torch.cuda.synchronize()
        out[overlap] = (float(loss), grads)
        log(f"fsdp train parity: {overlap} loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s); K7 (launches, plain) "
            f"({C.COUNTS.launches}, {C.COUNTS.plain_calls}); collectives "
            f"{json.dumps(C.COLLECTIVES.read())}")
        want = (len(PROJECTIONS) * L * 2 if overlap != "none" else 0, 0)
        check((C.COUNTS.launches, C.COUNTS.plain_calls) == want,
              f"fsdp train parity: {overlap} K7 (launches, plain) "
              f"{(C.COUNTS.launches, C.COUNTS.plain_calls)} != {want}")
    (lk, gk), (lp, gp) = out["ring_fused_pallas"], out["none"]
    rel = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path).float()
        rel["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    worst = max(rel, key=rel.get)
    equal = lk == lp and all(torch.equal(a, fsdp.optim.tree_get(gp, path))
                             for path, a in fsdp.optim.tree_leaves(gk))
    log(f"fsdp train parity: loss and grads bit-equal {equal}; |loss K7 - "
        f"plain| {abs(lk - lp):.6f} (atol {FSDP_LOSS_ATOL}); grad relative "
        f"L2, worst leaf {worst} "
        f"{rel[worst]:.5f} (limit {FSDP_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("fsdp step-0 loss: non-finite")
    if abs(lk - lp) > FSDP_LOSS_ATOL:
        failures.append(f"fsdp step-0 loss: |K7 - plain| {abs(lk - lp)} "
                        f"over {FSDP_LOSS_ATOL}")
    if not rel[worst] <= FSDP_GRAD_REL_L2:
        failures.append(f"fsdp step-0 grads: {worst} relative L2 "
                        f"{rel[worst]} over {FSDP_GRAD_REL_L2}")
    del shards, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def fsdp_train_phase(card: str, loss0: float) -> tuple[dict, dict]:
    """``FSDP_TRAIN["num_steps"]`` steps of ``train_fsdp.run`` at
    ring_fused_pallas on the parity phase's process group: K7 and the
    flash attention's launch counts exact, plain counts 0, the losses
    finite and falling, step 0's loss bit-equal to the parity's K7 path;
    the last step profiled.  Returns the launch counts and the step's
    readings (a host sync every step: ``step_ms``, ``tokens_per_s``)."""
    from torch.profiler import ProfilerActivity, profile
    L, n = FSDP_CFG.num_hidden_layers, FSDP_TRAIN["num_steps"]
    expect = {"ag_matmul": (C.COUNTS, L * len(PROJECTIONS) * 2),
              "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
              "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    for c, _ in expect.values():
        c.reset()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        if i == n - 2:   # trace the last step: device activity only
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = train_fsdp.run(FSDP_TRAIN["model"], overlap=FSDP_TRAIN["overlap"],
                         batch_size=FSDP_TRAIN["bs"], seq=FSDP_TRAIN["seq"],
                         num_steps=n, device="cuda", seed=FSDP_TRAIN["seed"],
                         on_step=on_step, log=log)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    want = {k: n * per for k, (_, per) in expect.items()}
    losses, times = res["losses"], res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])   # unprofiled, after step 0
    tok_s = FSDP_TRAIN["seq"] * FSDP_TRAIN["bs"] / step_s
    flops_tok = res["model_flops_per_token"]
    log(f"fsdp train on {card}: losses {losses}; collectives a step "
        f"{json.dumps(res['collectives'][-1])}")
    log(f"fsdp train: step times (s, host clock, each ending in a sync) "
        f"{steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f" ({flops_tok:.4e} model FLOP/token over the 989 TFLOP/s bf16 "
        f"dense peak); run tokens_per_second {res['tokens_per_second']:.1f};"
        f" peak memory {res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"fsdp train launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)}")
    log(f"fsdp train: step-0 loss {losses[0]!r}, the parity phase's K7 "
        f"path {loss0!r}, bit-equal {losses[0] == loss0}")
    _step_profile(prof, marks["wall_us"], "fsdp train", n - 1)
    check(losses[0] == loss0, f"fsdp train: step-0 loss {losses[0]!r} of "
          f"the run is not the parity phase's {loss0!r} (same shards and "
          f"batch)")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"fsdp train: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    check(all(np.isfinite(losses)), f"fsdp train: non-finite loss in "
          f"{losses}")
    check(losses[-1] < losses[0], f"fsdp train: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return ({k: v[0] for k, v in counts.items()},
            {"step_ms": step_s * 1e3, "tokens_per_s": tok_s})


def _step_ms(step_s: list) -> float:
    """The median of the steps between the first and the last (which
    phase 10 may profile), in ms."""
    return statistics.median(step_s[1:-1]) * 1e3


def _last_step_profiler(n: int, label: str):
    """An ``on_step`` hook for the twins (``(i, loss)`` or ``(leg, i,
    loss)``) that profiles each leg's step n - 1, device activity only,
    and logs its breakdown (``_step_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    held = {}

    def hook(*args):
        *leg, i, _ = args
        if i == n - 2:
            held["prof"] = profile(activities=[ProfilerActivity.CUDA])
            held["prof"].start()
            held["t"] = time.perf_counter()
        elif i == n - 1:
            wall_us = (time.perf_counter() - held["t"]) * 1e6
            held["prof"].stop()
            _step_profile(held["prof"], wall_us, " ".join([label, *leg]), i)
    return hook


def ddp_zero_phase(card: str) -> dict:
    """Phase 10 on the FSDP phases' one-rank NCCL group: ``train.ddp.run``
    (``DDP_ZERO["num_steps"]`` SGD steps, per-leaf sync) and
    ``train.zero.run`` for ZeRO-1 (both rebuilds), -2 and -3 at full
    width.  Gates: the sync check; the shim's counts a step (DDP n + 2
    all_reduces, its init 12 broadcasts; each ZeRO leg its contract's);
    losses finite and falling (DDP: the first batch's loss under the
    final params below step 0's, since each step draws a new batch);
    every sharded leg equal to its baseline Adam leg in losses and final
    params, bit for bit (at one rank every collective is a copy and a
    chunk the whole flat param, so each sharded leg does the baseline's
    arithmetic on the same values); ZeRO-1's broadcast rebuild
    bit-equal to its all_gather rebuild.  The last step of DDP and of
    both legs of ZeRO-1 (broadcast) and ZeRO-3 is profiled.  Returns the
    readings: step ms (host clock, the median of the steps between the
    first and the profiled last) beside each step's byte bound,
    optimizer MB, memory, collectives a step."""
    torch.cuda.empty_cache()
    cfg = DDP_ZERO
    out = {}
    n_steps = cfg["num_steps"]
    r = ddp_run.run(scale=cfg["scale"], num_steps=n_steps,
                    batch_size=cfg["ddp_batch"], seed=cfg["seed"],
                    device="cuda", on_step=_last_step_profiler(n_steps, "ddp"),
                    log=log)
    n = r["n_leaves"]
    sizes = [w // cfg["scale"] for w in MLP.ZERO_TOY_SIZES]
    p_bytes = 4 * sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
    bound = lambda k: STEP_BYTES_OVER_P[k] * p_bytes / HBM_BYTES_PER_S * 1e3
    steps = r["step_s"]
    out["ddp"] = {"step_ms": _step_ms(steps), "bound_ms": bound("ddp"),
                  "peak_gib": r["peak_memory_bytes"] / 2 ** 30,
                  "collectives": r["collectives"][-1],
                  "losses": r["losses"],
                  "final_loss_batch0": r["final_loss_batch0"]}
    log(f"ddp on {card}: params {p_bytes / 1e9:.3f} GB ({n} leaves); step "
        f"{out['ddp']['step_ms']:.3f} ms (host clock, median of steps 1-"
        f"{n_steps - 2}; steps {[round(t * 1e3, 3) for t in steps]})"
        f" against a byte bound of {out['ddp']['bound_ms']:.3f} ms; peak "
        f"memory {out['ddp']['peak_gib']:.3f} GiB; collectives a step "
        f"{json.dumps(C.COLLECTIVES.nonzero(r['collectives'][-1]))}")
    check(r["sync_error"] == 0.0, f"ddp: sync check read {r['sync_error']}")
    broadcasts = {**dict.fromkeys(C.CollectiveCounts.KINDS, 0),
                  "broadcast": n}
    check(r["init_collectives"] == broadcasts,
          f"ddp: init broadcast {r['init_collectives']}")
    want = step_collectives("ddp", n)
    check(all(c == want for c in r["collectives"]),
          f"ddp: collectives a step {r['collectives']} != {want}")
    check(all(np.isfinite(r["losses"] + [r["final_loss_batch0"]])),
          f"ddp: non-finite loss in {r['losses']}")
    check(r["final_loss_batch0"] < r["losses"][0],
          f"ddp: the first batch's loss under the final params "
          f"{r['final_loss_batch0']!r} is not below step 0's "
          f"{r['losses'][0]!r}")
    del r
    for stage, rebuild in ((1, "broadcast"), (1, "all_gather"),
                           (2, "broadcast"), (3, "all_gather")):
        name = f"zero{stage}" + ("_all_gather" if (stage, rebuild) == (
            1, "all_gather") else "")
        torch.cuda.empty_cache()
        profiled = (stage, rebuild) in ((1, "broadcast"), (3, "all_gather"))
        z = zero_run.run(stage, rebuild=rebuild, scale=cfg["scale"],
                         num_steps=n_steps, batch_size=cfg["zero_batch"],
                         seed=cfg["seed"], device="cuda",
                         keep_params=stage == 1,
                         on_step=_last_step_profiler(n_steps, name)
                         if profiled else None, log=log)
        bits = z["params_bit_equal"] and z["base_losses"] == z["shard_losses"]
        rd = {"base_ms": _step_ms(z["base_step_s"]),
              "shard_ms": _step_ms(z["shard_step_s"]),
              "base_bound_ms": bound("adam"),
              "shard_bound_ms": bound(f"zero{stage}"),
              "base_opt_mb": z["base_opt_mb"],
              "shard_opt_mb": z["shard_opt_mb"],
              "shard_param_mb": z["shard_param_mb"],
              "base_gib": {k: v / 2 ** 30
                           for k, v in z["base_memory_bytes"].items()},
              "shard_gib": {k: v / 2 ** 30
                            for k, v in z["shard_memory_bytes"].items()},
              "base_collectives": z["base_counts"][-1],
              "shard_collectives": z["shard_counts"][-1],
              "loss_drift": z["loss_drift"],
              "param_max_abs_diff": z["param_max_abs_diff"]}
        out[name] = rd
        log(f"{name} on {card}: step baseline {rd['base_ms']:.3f} ms "
            f"(bound {rd['base_bound_ms']:.3f}), sharded "
            f"{rd['shard_ms']:.3f} ms (bound {rd['shard_bound_ms']:.3f}); "
            f"optimizer {rd['base_opt_mb']:.1f} -> {rd['shard_opt_mb']:.1f} "
            f"MB" + (f", params {z['param_mb']:.1f} -> "
                     f"{rd['shard_param_mb']:.1f} MB" if stage == 3 else "")
            + f"; memory at start and peak (GiB) baseline "
            f"{rd['base_gib']['start']:.3f}, {rd['base_gib']['peak']:.3f}, "
            f"sharded {rd['shard_gib']['start']:.3f}, "
            f"{rd['shard_gib']['peak']:.3f}; loss drift "
            f"{rd['loss_drift']!r}, params max |diff| "
            f"{rd['param_max_abs_diff']!r}, bit-equal {bits}")
        check(bits, f"{name}: sharded leg not bit-equal to baseline Adam: "
              f"losses baseline {z['base_losses']} sharded "
              f"{z['shard_losses']}, params max |diff| "
              f"{z['param_max_abs_diff']}")
        want = step_collectives(f"zero{stage}", n, rebuild=rebuild)
        check(all(c == want for c in z["shard_counts"]),
              f"{name}: collectives a step {z['shard_counts'][-1]} != {want}")
        check(all(c == step_collectives("ddp", n)
                  for c in z["base_counts"]),
              f"{name}: baseline collectives a step {z['base_counts'][-1]}")
        losses = z["base_losses"] + z["shard_losses"]
        check(all(np.isfinite(losses)), f"{name}: non-finite loss")
        check(z["shard_losses"][-1] < z["shard_losses"][0],
              f"{name}: losses not falling {z['shard_losses']}")
        if name == "zero1":   # the broadcast rebuild, kept for the next
            kept = z["shard_losses"], z["shard_params"]
        elif name == "zero1_all_gather":
            same = kept[0] == z["shard_losses"] and all(
                torch.equal(a, fsdp.optim.tree_get(z["shard_params"], path))
                for path, a in fsdp.optim.tree_leaves(kept[1]))
            log(f"zero1: rebuild broadcast bit-equal to all_gather {same}")
            check(same, "zero1: rebuild broadcast is not bit-equal to "
                  "all_gather")
            kept = None
        del z
    torch.cuda.empty_cache()
    return out

# ------------------------------------------------------- the pipeline

def _toy_monolithic(params, batch, lr):
    """One full-batch Adam step of the toy MLP on a copy of ``params``:
    ``(loss, grads, params after the step)``."""
    p = fsdp.optim.tree_map(lambda t: t.detach().clone(), params)
    loss, grads = fsdp.microbatch_value_and_grad(MLP.mse_loss, p, batch, 1)
    p, _ = fsdp.optim.adam_update(grads, fsdp.optim.adam_init(p), p, lr=lr)
    return float(loss), grads, p


def _rel_l2(a, b) -> float:
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def _schedule(name):
    return {"gpipe": PP.run_gpipe, "1f1b": PP.run_1f1b,
            "interleaved": PP.run_interleaved_1f1b}[name]


def pipeline_toy_phase(card: str) -> dict:
    """Phase 11a: the PP toy through ``train.pipeline.run``, a leg each
    of ``PIPE_TOY_LEGS``.  Gates: each leg's step 0 (the schedule on the
    run's params and first batch) against one monolithic Adam step (loss,
    grads, params after it); its 16-epoch run's step-0 loss that step's;
    GPipe's first losses 1F1B's;
    the 1F1B clock ``PIPE_1F1B_TRACE``; the high-water marks (GPipe
    n_micro a stage, 1F1B at most n_stages); no collective; losses
    finite and the first batch's loss lower under the final params.
    Returns each leg's epoch ms and schedule statistics."""
    cfg, dev = PIPE_TOY, torch.device("cuda")
    params = MLP.pp_toy_mlp(torch.Generator(device=dev).manual_seed(
        cfg["seed"]), device=dev)
    batch = next(pp_run.epoch_batches(None, cfg["batch"], 0, cfg["seed"],
                                      dev))
    mono_loss, mono_grads, mono = _toy_monolithic(params, batch, cfg["lr"])
    out, losses = {}, {}
    for schedule, n in PIPE_TOY_LEGS:
        stages, _ = pp_run.build_stages("mlp", schedule, n, 2, cfg["seed"],
                                        "cuda")
        trace = []
        loss0 = _schedule(schedule)(
            stages, *batch, n_micro=cfg["n_micro"], lr=cfg["lr"],
            **({} if schedule == "gpipe" else {"schedule_trace": trace}))
        got = [layer for s in stages for layer in s.params]
        diff = max(float((a[k] - b[k]).abs().max())
                   for a, b in zip(got, mono, strict=True) for k in a)
        grads = [layer for s in stages for layer in s.grad_acc]
        rel = max(_rel_l2(a[k], b[k])
                  for a, b in zip(grads, mono_grads, strict=True) for k in a)
        del stages, grads
        full = []
        r = pp_run.run(schedule, model="mlp", n_stages=n,
                       n_micro=cfg["n_micro"], lr=cfg["lr"],
                       num_epochs=cfg["epochs"], batch_size=cfg["batch"],
                       seed=cfg["seed"], device="cuda",
                       on_step=lambda e, l: full.append(l), log=log)
        losses[schedule] = full
        ms = statistics.median(r["step_ms"][1:])
        out[schedule] = {"epoch_ms": ms, "stats": r["schedule_stats"],
                         "max_stored": r["max_stored_activations"]}
        log(f"pipeline toy {schedule} on {card}: {len(r['devices'])} stages"
            f" on {r['devices']}; step 0 loss {loss0!r} against the "
            f"monolithic step's {mono_loss!r} (rel "
            f"{abs(loss0 - mono_loss) / abs(mono_loss):.3e}, limit "
            f"{PIPE_TOY_LOSS_RTOL}), grads' worst relative L2 {rel:.3e} "
            f"(limit {PIPE_TOY_GRAD_REL_L2}), params max |diff| {diff:.3e} "
            f"(atol {PIPE_TOY_PARAM_ATOL}); losses {full}; the first batch's "
            f"loss under the final params {r['final_loss_batch0']!r}; "
            f"epoch ms (host clock, median of epochs 1-"
            f"{cfg['epochs'] - 1}) {ms:.3f}; max stored "
            f"{r['max_stored_activations']}; schedule stats "
            f"{json.dumps(r['schedule_stats'])}; MB a card at the start "
            f"{json.dumps(r['start_memory_mb'])}, peak "
            f"{json.dumps(r['peak_memory_mb'])}")
        check(abs(loss0 - mono_loss) <= PIPE_TOY_LOSS_RTOL * abs(mono_loss),
              f"pipeline toy {schedule}: step-0 loss {loss0!r} against the "
              f"monolithic {mono_loss!r}")
        check(rel <= PIPE_TOY_GRAD_REL_L2, f"pipeline toy {schedule}: "
              f"step-0 grads off the monolithic step's by relative L2 {rel}")
        check(diff <= PIPE_TOY_PARAM_ATOL, f"pipeline toy {schedule}: "
              f"params after step 0 off the monolithic step by {diff}")
        check(full[0] == loss0, f"pipeline toy {schedule}: the run's step-0 "
              f"loss {full[0]!r} is not the schedule's {loss0!r}")
        check(r["contract"]["holds"], f"pipeline toy {schedule}: "
              f"collectives {r['contract']['collectives'][-1]}")
        check(all(np.isfinite(full)), f"pipeline toy {schedule}: non-finite "
              f"loss in {full}")
        check(r["final_loss_batch0"] < full[0], f"pipeline toy {schedule}: "
              f"the first batch's loss under the final params "
              f"{r['final_loss_batch0']!r} is not below step 0's {full[0]!r}")
        stored = list(r["max_stored_activations"].values())
        if schedule == "gpipe":
            check(stored == [cfg["n_micro"]] * n, f"pipeline toy gpipe: "
                  f"max stored {stored}")
        elif schedule == "1f1b":
            check(trace == PIPE_1F1B_TRACE, f"pipeline toy 1f1b: tick trace "
                  f"{trace} is not the pinned one")
            check(max(stored) <= n, f"pipeline toy 1f1b: max stored {stored}")
    rels = [abs(a - b) / abs(b)
            for a, b in zip(losses["gpipe"], losses["1f1b"], strict=True)]
    k = PIPE_GPIPE_1F1B_EPOCHS
    log(f"pipeline toy: GPipe against 1F1B, relative loss difference of "
        f"each epoch {[float(f'{r:.3e}') for r in rels]} (limit "
        f"{PIPE_GPIPE_1F1B_RTOL} over the first {k})")
    check(max(rels[:k]) <= PIPE_GPIPE_1F1B_RTOL, f"pipeline toy: GPipe and "
          f"1F1B losses differ by rel {max(rels[:k])} in the first {k} "
          f"epochs")
    return out


def _stage_rel_l2(stage_grads, ref) -> dict:
    """Every grad leaf's relative L2 error of a pipeline's stages (their
    ``grad_acc`` trees) against ``ref(s, path)``, the reference leaf."""
    return {f"stage{s}/" + "/".join(path): _rel_l2(a, ref(s, path))
            for s, g in enumerate(stage_grads)
            for path, a in fsdp.optim.tree_leaves(g)}


def pipeline_lm_parity_phase() -> float:
    """Phase 11b's gates at step 0: the GPipe pipeline of
    ``PIPE_LM_CFG`` (4 stages on the card, the run's params and first
    batch) through the flash kernels against (i) one monolithic
    ``lm_loss`` step on the same untied params and batch, through the
    same kernels, and (ii) the same pipeline with plain attention; the
    flash step's FA launches exact (forward 2 · L · n_micro: each stage
    layer's forward and its remat recompute; backward L · n_micro) and
    plain calls 0.  Returns the flash pipeline's loss."""
    cfg, pl, dev = PIPE_LM_CFG, PIPE_LM, torch.device("cuda")
    L, nm = cfg.num_hidden_layers, pl["n_micro"]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        pl["seed"]), dev)
    batch = next(pp_run.epoch_batches(cfg, pl["batch"], pl["seq"],
                                      pl["seed"], dev))
    ucfg = dataclasses.replace(cfg, tie_word_embeddings=False)
    t = time.perf_counter()
    mono_loss, mono = fsdp.microbatch_value_and_grad(
        lambda p, b: T.lm_loss(p, b, ucfg),
        dict(params, lm_head=params["embed"].T.contiguous()), batch, 1)
    mono_loss = float(mono_loss)
    log(f"pipeline parity: monolithic lm_loss {mono_loss!r} "
        f"({time.perf_counter() - t:.1f} s)")
    ranges = [(i[0], i[-1] + 1) for i in PP.split_stages(list(range(L)),
                                                          pl["n_stages"])]
    out = {}
    for name, c in (("flash", cfg),
                    ("plain", dataclasses.replace(cfg, attention_impl="xla"))):
        FA.FWD_COUNTS.reset()
        FA.BWD_COUNTS.reset()
        t = time.perf_counter()
        stages = PP.build_transformer_pipeline(params, c, pl["n_stages"],
                                               devices=[dev])
        loss = PP.run_gpipe(stages, *batch, n_micro=nm, lr=pl["lr"])
        torch.cuda.synchronize()
        counts = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls,
                  FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls)
        out[name] = (loss, [s.grad_acc for s in stages])
        del stages
        log(f"pipeline parity: {name} attention, GPipe step 0 loss "
            f"{loss!r} ({time.perf_counter() - t:.1f} s); FA (forward "
            f"launches, plain, backward launches, plain) {counts}")
        if name == "flash":
            want = (2 * L * nm, 0, L * nm, 0)
            check(counts == want, f"pipeline parity: FA counts {counts} != "
                  f"{want}")
    (lf, gf), (lp, gp) = out["flash"], out["plain"]

    def mono_leaf(s, path):   # the stage's layer slice of the full grads
        b = fsdp.optim.tree_get(mono, path)
        return b[slice(*ranges[s])] if path[0] == "layers" else b

    rel_m = _stage_rel_l2(gf, mono_leaf)
    rel_p = _stage_rel_l2(gf, lambda s, path: fsdp.optim.tree_get(gp[s],
                                                                  path))
    wm, wp = max(rel_m, key=rel_m.get), max(rel_p, key=rel_p.get)
    log(f"pipeline step-0 against the monolithic step: |loss difference| "
        f"{abs(lf - mono_loss):.6f} (atol {PIPE_MONO_LOSS_ATOL}); grad "
        f"relative L2, worst leaf {wm} {rel_m[wm]:.5f} (limit "
        f"{PIPE_MONO_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel_m.items()})}")
    log(f"pipeline plain: flash against plain attention: |loss "
        f"difference| {abs(lf - lp):.6f} (atol {PIPE_PLAIN_LOSS_ATOL}); "
        f"grad relative L2, worst leaf {wp} {rel_p[wp]:.5f} (limit "
        f"{PIPE_PLAIN_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel_p.items()})}")
    failures = []
    if not all(np.isfinite([lf, lp, mono_loss])):
        failures.append("pipeline step-0 loss: non-finite")
    if abs(lf - mono_loss) > PIPE_MONO_LOSS_ATOL:
        failures.append(f"pipeline step-0 loss: |pipeline - monolithic| "
                        f"{abs(lf - mono_loss)} over {PIPE_MONO_LOSS_ATOL}")
    if not rel_m[wm] <= PIPE_MONO_GRAD_REL_L2:
        failures.append(f"pipeline step-0 grads: {wm} relative L2 "
                        f"{rel_m[wm]} over {PIPE_MONO_GRAD_REL_L2}")
    if abs(lf - lp) > PIPE_PLAIN_LOSS_ATOL:
        failures.append(f"pipeline plain loss: |flash - plain| {abs(lf - lp)}"
                        f" over {PIPE_PLAIN_LOSS_ATOL}")
    if not rel_p[wp] <= PIPE_PLAIN_GRAD_REL_L2:
        failures.append(f"pipeline plain grads: {wp} relative L2 "
                        f"{rel_p[wp]} over {PIPE_PLAIN_GRAD_REL_L2}")
    del params, mono, out, gf, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lf


def fa_bwd_oracle_gate(heads=None, seeds=FA_BWD_PIPE_SEEDS) -> dict:
    """The FA backward at a pipeline stage's microbatch over
    ``FA_BWD_PIPE_SEEDS``, on the forward kernel's O and logsumexp.
    Gates each grad's L2 distance from the exact f64 gradient
    (``FA.attention_bwd_oracle``) over the plain path's at
    ``FA.BWD_ORACLE_L2_RATIO``.  Logs each grad's relative L2 from the
    exact gradient for the kernel and the plain path, its elementwise
    ratio against plain (``FA.TOLERANCE["bwd"]``) and its block relative
    L2, and at the element where the kernel and plain differ most
    against the tolerance, |kernel - exact| and |plain - exact| in bf16
    ulps of the exact value.  ``heads`` (nq, nkv, hd): default the
    pipeline's (``PIPE_LM_CFG``)."""
    B = PIPE_LM["batch"] // PIPE_LM["n_micro"]
    S = PIPE_LM["seq"]
    nq, nkv, hd = heads or _heads(PIPE_LM_CFG)
    scale = hd ** -0.5
    atol, rtol = FA.TOLERANCE["bwd"]
    out = {}
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for n in (nq, nkv, nkv, nq))
        o, lse = FA.flash_attention_fwd(q, k, v, scale)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
        ref = FA.flash_attention_bwd_plain(q, k, v, do, scale)
        exact = FA.attention_bwd_oracle(q, k, v, do, scale)
        for name, a, b, e in zip(("dq", "dk", "dv"), got, ref, exact):
            a64, b64 = a.double(), b.double()
            i = int(((a64 - b64).abs() / (atol + rtol * b64.abs())).argmax())
            ei = float(e.flatten()[i])
            ulp = 2.0 ** (math.frexp(ei)[1] - 8) if ei else 2.0 ** -133
            out[f"{seed}/{name}"] = {
                "ratio": round(FA.oracle_l2_ratio(a, b, e), 4),
                "kernel": round(float(torch.linalg.vector_norm(a64 - e)
                                      / torch.linalg.vector_norm(e)), 6),
                "plain": round(float(torch.linalg.vector_norm(b64 - e)
                                     / torch.linalg.vector_norm(e)), 6),
                "vs_plain": round(gate_ratio(a, b, atol, rtol), 4),
                "block": round(FA.block_rel_l2(a, b), 5),
                "worst_ulps": (round(abs(float(a64.flatten()[i]) - ei) / ulp,
                                     2),
                               round(abs(float(b64.flatten()[i]) - ei) / ulp,
                                     2))}
        del q, k, v, do, o, lse, got, ref, exact
    worst = max(out, key=lambda n: out[n]["ratio"])
    over = [n for n, r in out.items() if r["vs_plain"] > 1]
    log(f"flash_attention_bwd at B {B}, S {S}, {nq} / {nkv} heads, hd {hd}"
        f" over seeds {list(seeds)}: {json.dumps(out)}; worst L2 ratio "
        f"{out[worst]['ratio']} at {worst} (limit {FA.BWD_ORACLE_L2_RATIO});"
        f" elementwise ratio against plain over 1 at {over}")
    check(out[worst]["ratio"] <= FA.BWD_ORACLE_L2_RATIO,
          f"flash_attention_bwd oracle: {worst} L2 distance from the exact "
          f"gradient {out[worst]['ratio']} times the plain path's, above "
          f"{FA.BWD_ORACLE_L2_RATIO}")
    torch.cuda.empty_cache()
    return out


def pipeline_lm_phase(card: str, loss0: float) -> dict:
    """Phase 11b's runs: ``train.pipeline.run`` on ``PIPE_LM`` for GPipe
    and 1F1B, ``PIPE_LM["epochs"]`` epochs each, the last profiled.
    Gates: FA's launches exact (the steps' and the run's closing forward
    of the first batch) and plain calls 0, GPipe's step-0 loss
    bit-equal to the parity phase's flash pipeline, 1F1B's within
    ``PIPE_GPIPE_1F1B_RTOL`` of it, losses finite, no collective, the
    high-water marks.  Returns FA's launches over both runs."""
    cfg, pl = PIPE_LM_CFG, PIPE_LM
    L, n = cfg.num_hidden_layers, pl["epochs"]
    tokens = pl["batch"] * pl["seq"]
    flops_tok = T.model_flops_per_token(cfg, pl["seq"])
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    for schedule in ("gpipe", "1f1b"):
        FA.FWD_COUNTS.reset()
        FA.BWD_COUNTS.reset()
        torch.cuda.empty_cache()
        full, prof = [], _last_step_profiler(n, f"pipeline {schedule}")

        def on_step(e, loss):
            full.append(loss)
            prof(e, loss)

        r = pp_run.run(schedule, model=pl["model"], n_stages=pl["n_stages"],
                       n_micro=pl["n_micro"], lr=pl["lr"],
                       warmup_epochs=pl["warmup"], num_epochs=n,
                       batch_size=pl["batch"], seq=pl["seq"],
                       seed=pl["seed"], device="cuda", on_step=on_step,
                       log=log)
        torch.cuda.synchronize()
        counts = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls,
                  FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls)
        launches["flash_attention_fwd"] += counts[0]
        launches["flash_attention_bwd"] += counts[2]
        step_s = statistics.median(r["step_ms"][1:-1]) / 1e3
        tok_s = tokens / step_s
        mem = (r["start_memory_mb"]["cuda:0"] / 1024,
               r["peak_memory_mb"]["cuda:0"] / 1024)
        log(f"pipeline {schedule} on {card}: {pl['model']}, "
            f"{pl['n_stages']} stages on {r['devices']}, batch "
            f"{pl['batch']} x seq {pl['seq']} in {pl['n_micro']} "
            f"microbatches; losses {full}; step ms (host clock) "
            f"{r['step_ms']}; step {step_s * 1e3:.1f} ms (median of epochs "
            f"1-{n - 2}), {tok_s:.1f} tokens/s, MFU "
            f"{flops_tok * tok_s / PEAK_BF16_FLOPS:.4f} ({flops_tok:.4e} "
            f"model FLOP/token at seq {pl['seq']} over the 989 TFLOP/s bf16 "
            f"dense peak); the card's memory at the start and the peak "
            f"{mem[0]:.3f}, {mem[1]:.3f} GiB; "
            f"accounted MB a stage {json.dumps(r['memory_plan_mb'])}; "
            f"stored inputs {json.dumps(r['max_stored_activations'])} of "
            f"{json.dumps(r['activation_mb_per_microbatch'])} MB; FA "
            f"(forward launches, plain, backward launches, plain) {counts}")
        # a step: each stage layer's forward and its remat recompute a
        # microbatch, one backward; then the run's one forward of the
        # first batch under the final params (final_loss_batch0)
        want = (2 * L * pl["n_micro"] * n + L, 0, L * pl["n_micro"] * n, 0)
        check(counts == want, f"pipeline {schedule}: FA counts {counts} != "
              f"{want}")
        check(all(np.isfinite(full)), f"pipeline {schedule}: non-finite loss "
              f"in {full}")
        check(r["contract"]["holds"], f"pipeline {schedule}: collectives "
              f"{r['contract']['collectives'][-1]}")
        stored = list(r["max_stored_activations"].values())
        if schedule == "gpipe":
            check(full[0] == loss0, f"pipeline gpipe: step-0 loss {full[0]!r}"
                  f" of the run is not the parity phase's {loss0!r}")
            check(stored == [pl["n_micro"]] * pl["n_stages"],
                  f"pipeline gpipe: max stored {stored}")
        else:
            check(abs(full[0] - loss0) <= PIPE_GPIPE_1F1B_RTOL * abs(loss0),
                  f"pipeline 1f1b: step-0 loss {full[0]!r} against GPipe's "
                  f"{loss0!r}")
            check(max(stored) <= pl["n_stages"], f"pipeline 1f1b: max "
                  f"stored {stored}")
    torch.cuda.empty_cache()
    return launches


def busbench_phase(card: str) -> list[dict]:
    """Phase 12: ``train.busbench.run`` on the one-rank NCCL group, every
    collective at ``BUSBENCH_MB``, bf16.  Gates: the reference's schema,
    each payload the reference's sizing, and each collective's output
    its input (at one rank a copy: no link is measured)."""
    doc = bb_run.run(payloads_mb=BUSBENCH_MB, out_dir="build/busbench",
                     device="cuda", log=log)
    fields = [f.name for f in dataclasses.fields(BB.BusResult)]
    n = doc["devices"]
    check(len(doc["rows"]) == len(BB.COLLECTIVE_NAMES) * len(BUSBENCH_MB),
          f"busbench: {len(doc['rows'])} rows")
    for row in doc["rows"]:
        check(list(row) == fields, f"busbench: row keys {list(row)}")
    want = {BB.payload_elems(mb * 2 ** 20, n, 2) * 2 for mb in BUSBENCH_MB}
    check({r["payload_bytes"] for r in doc["rows"]} == want,
          f"busbench: payloads {doc['payload_bytes']} != {sorted(want)}")
    for name in BB.COLLECTIVE_NAMES:
        x = BB.make_input(name, 2 ** 20, 0, n, torch.bfloat16, "cuda")
        check(torch.equal(BB.collective_fn(name)(x), x),
              f"busbench: {name} at one rank is not a copy of its input")
    log(f"busbench on {card}: {n} NCCL rank(s), every collective a copy of "
        f"its buffer (ppermute returns it without a call): these times "
        f"measure no link")
    return doc["rows"]


# ------------------------------------------------ phase 13: the precision tier

def _prec_inputs(cfg, seed, seq, bs, num_steps):
    """train_fsdp.run's shards (seeded init, this rank's rows) and first
    global batch for ``cfg``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shards = fsdp.shard_params_fsdp(T.init_params(cfg, gen, "cuda"))
    ib, lb = next(train_fsdp.fsdp_batches(cfg.vocab_size, seq, bs,
                                          num_steps, seed))
    return shards, (torch.as_tensor(ib, device="cuda"),
                    torch.as_tensor(lb, device="cuda"))


def _prec_expect(L: int) -> dict:
    """The kernels one int8_pallas_bwd FSDP step launches (remat
    "full"): K5 each projection's forward and its recompute, K4 its dX
    and dW, the flash forward twice a layer and its backward once."""
    return {"int8_matmul_fused": (Q.INT8_FUSED_COUNTS,
                                  L * len(PROJECTIONS) * 2),
            "int8_matmul": (Q.INT8_COUNTS, L * len(PROJECTIONS) * 2),
            "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
            "flash_attention_bwd": (FA.BWD_COUNTS, L)}


def _reset_kernel_counts():
    for c in (Q.COUNTS, Q.BWD_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS,
              FA.FWD_COUNTS, FA.BWD_COUNTS, C.COUNTS):
        c.reset()
    C.COLLECTIVES.reset()


def _first_layer(tree):
    """Layer 0 of every stacked leaf (``Q8`` moments field by field) and
    the final norm: rows the int8 update treats alone, small enough for
    the CPU."""
    def cut(v):
        if isinstance(v, optim8.Q8):
            return optim8.Q8(v.q[:1], v.scale[:1])
        return v[:1]
    return {"layers": {k: cut(v) for k, v in tree["layers"].items()},
            "final_norm": tree["final_norm"]}


def _to(tree, device):
    """A copy of a tree of tensors and ``Q8`` moments on ``device``."""
    def leaf(t):
        if isinstance(t, optim8.Q8):
            return optim8.Q8(*(leaf(x) for x in t))
        return t.detach().to(device, copy=True)
    return fsdp.optim.tree_map(leaf, tree)


def _adam8_readings(shards, grads) -> dict:
    """The int8 moments on the card against ``optim8.adam8_update`` on a
    CPU copy of the same params, grads and state, two updates (the second
    dequantises the first's codes), compared on layer 0 of every stacked
    leaf and the final norm; and the update's CUDA-event time on the
    whole tree beside its byte bound and full-precision Adam's."""
    params = _to(shards, "cuda")
    state = fsdp.init_fsdp_opt_state8(params)
    cpu_p = _to(_first_layer(params), "cpu")
    cpu_g = _to(_first_layer(grads), "cpu")
    cpu_s = optim8.adam8_init(cpu_p)
    for _ in range(2):
        optim8.adam8_update(grads, state, params, **PREC_ADAM)
        optim8.adam8_update(cpu_g, cpu_s, cpu_p, **PREC_ADAM)
    torch.cuda.synchronize()
    card = _to({"p": _first_layer(params), "mu": _first_layer(state.mu),
                "nu": _first_layer(state.nu)}, "cpu")
    unequal = {}
    for key, want in (("p", cpu_p), ("mu", cpu_s.mu), ("nu", cpu_s.nu)):
        for path, a in fsdp.optim.tree_leaves(card[key]):
            b = fsdp.optim.tree_get(want, path)
            pairs = (zip(("q", "scale"), a, b) if isinstance(a, optim8.Q8)
                     else (("", a, b),))
            for field, x, y in pairs:
                if not torch.equal(x, y):
                    unequal["/".join((key, *path, field))] = int(
                        (x != y).sum())
    n_params = sum(t.numel() for _, t in fsdp.optim.tree_leaves(params))
    # bytes: each param read and written (bf16), its grad read (bf16),
    # each moment's code read and written and its row scale likewise
    rows = sum(t.q.numel() // t.q.shape[-1] if isinstance(t, optim8.Q8)
               else 0 for _, t in fsdp.optim.tree_leaves(state.mu))
    b8 = n_params * (2 + 2 + 2 + 2 * 2) + rows * 2 * 2 * 4
    full = fsdp.init_fsdp_opt_state(params)
    bfull = n_params * (2 + 2 + 2 + 2 * 2 * 2)
    ms8 = time_ms(lambda: optim8.adam8_update(grads, state, params,
                                              **PREC_ADAM), iters=3, warmup=1)
    msf = time_ms(lambda: fsdp.optim.adam_update(grads, full, params,
                                                 **PREC_ADAM),
                  iters=3, warmup=1)
    del full
    # why the update takes its square roots through optim8._sqrt: the
    # CPU's vectorised torch.sqrt against the card's (correctly rounded)
    gen = torch.Generator().manual_seed(SEED)
    v = torch.rand(4_000_000, generator=gen) * 10.0 ** (
        torch.rand(4_000_000, generator=gen) * 12 - 14)
    card_root = torch.sqrt(v.cuda()).cpu()
    sqrt_off = (int((torch.sqrt(v) != card_root).sum()),
                int((optim8._sqrt(v) != card_root).sum()))
    return {"unequal": unequal, "n_params": n_params, "sqrt_off": sqrt_off,
            "adam8_ms": ms8, "adam8_bound_ms": b8 / HBM_BYTES_PER_S * 1e3,
            "adam_ms": msf, "adam_bound_ms": bfull / HBM_BYTES_PER_S * 1e3,
            "state8_bytes": optim8.state_bytes(state),
            "state_full_bytes": 2 * 2 * n_params}


def _prec_attention_reading(cap: dict) -> float:
    """The flash forward and backward on a step's captured attention
    inputs and output grad against the plain versions, at FA's limits
    (``_fa_reading``): the largest gate ratio (<= 1 passes)."""
    q, k, v, scale, do = (cap[n] for n in ("q", "k", "v", "scale", "do"))
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    _, r_o = _fa_reading("precision attention fwd", "O", o, ref_o, "fwd")
    e_lse = float((lse - ref_lse).abs().max())
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    refs = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    r_g = [_fa_reading("precision attention bwd", n, g, r, "bwd")[1]
           for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
    ratio = max(r_o, e_lse / FA.LSE_ATOL, *r_g)
    log(f"precision attention: layer 0 of the step (q {tuple(q.shape)}), "
        f"logsumexp max_abs_err {e_lse:.3e} (atol {FA.LSE_ATOL}); gate "
        f"ratio {ratio:.4f}")
    return ratio


def precision_parity_phase() -> float:
    """Phase 13a's step-0 parity on the one-rank NCCL group (made here if
    there is none, as torchrun would give it): the FSDP step with
    quantised gathers and grads at int8_pallas_bwd through K5, K4 and the
    flash kernels, against the same step with the plain int8 products
    (bit-equal) and against the plain int8 products with plain attention
    (``PREC_PLAIN_*``); the flash kernels on the step's own layer-0
    attention inputs at FA's limits; the gathered weights bit for bit
    the int8 round-trip; the launches and the collectives of the kernel
    path; the int8 moments on the card against the CPU's.  Returns the
    kernel path's loss."""
    mesh.init_process_group("cuda")
    p = PREC_TRAIN
    L = PREC_CFG.num_hidden_layers
    shards, batch = _prec_inputs(PREC_CFG, p["seed"], p["seq"], p["bs"],
                                 p["num_steps"])
    failures = []
    for name, x in (("layers/wq[0]", shards["layers"]["wq"][0]),
                    ("layers/w_down[0]", shards["layers"]["w_down"][0]),
                    ("embed", shards["embed"])):
        got = fsdp._gather_leaf(x, ("dp",), "dp", True)
        want = Q.dequantize(*Q.quantize_int8(x, axis=-1), x.dtype)
        if not torch.equal(got, want):
            failures.append(f"precision gather: {name} is not the int8 "
                            f"round-trip")
    log(f"precision gather: layer and root leaves are the int8 round-trip "
        f"bit for bit: {not failures}")
    # the kernel path's first attention call (layer 0's forward): its
    # inputs, and the grad its output receives in the backward
    captured, flash = {}, T.flash_attention

    def capture(q, k, v, scale):
        o = flash(q, k, v, scale)
        if "q" not in captured:
            captured.update(q=q.detach().clone(), k=k.detach().clone(),
                            v=v.detach().clone(), scale=scale)
            o.register_hook(lambda g: captured.setdefault(
                "do", g.detach().clone()))
        return o
    plain_cfg = dataclasses.replace(PREC_CFG, attention_impl="xla")
    want_coll = fsdp_quantized_step_collectives(
        shards, remat=PREC_CFG.remat, quantized_grads=True)
    out = {}
    for name, cfg, plain in (("kernel", PREC_CFG, False),
                             ("plain int8", PREC_CFG, True),
                             ("plain", plain_cfg, True)):
        _reset_kernel_counts()
        t = time.perf_counter()
        vg = fsdp.make_fsdp_value_and_grad(shards, cfg, quantized_gather=True,
                                           quantized_grads=True)
        T.flash_attention = capture if name == "kernel" else flash
        try:
            with (Q.plain_int8_products() if plain
                  else contextlib.nullcontext()):
                loss, grads = vg(shards, batch)
        finally:
            T.flash_attention = flash
        torch.cuda.synchronize()
        counts = {k: (c.launches, c.plain_calls)
                  for k, (c, _) in _prec_expect(L).items()}
        coll = C.COLLECTIVES.read()
        out[name] = (float(loss), grads)
        log(f"precision parity: {name} loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s); (launches, plain) "
            f"{json.dumps(counts)}; collectives {json.dumps(coll)}")
        if name == "kernel":
            for k, (_, per) in _prec_expect(L).items():
                if counts[k] != (per, 0):
                    failures.append(f"precision parity: {k} (launches, "
                                    f"plain) {counts[k]} != ({per}, 0)")
            if coll != want_coll:
                failures.append(f"precision parity: collectives {coll} != "
                                f"the contract's {want_coll}")
    (lk, gk), (lp, gp), (lx, gx) = out["kernel"], out["plain int8"], \
        out["plain"]
    unequal = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path)
        if not torch.equal(a, b):
            unequal["/".join(path)] = float((a.float() - b.float()).abs()
                                            .max())
    rel = {}
    for path, a in fsdp.optim.tree_leaves(gp):
        b = fsdp.optim.tree_get(gx, path).float()
        rel["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    worst = max(rel, key=rel.get)
    log(f"precision step-0: loss kernel {lk!r} plain int8 {lp!r} (bit-equal "
        f"{lk == lp}); grad leaves not bit-equal: {json.dumps(unequal)}")
    log(f"precision plain: |loss flash - plain attention| {abs(lp - lx):.6f} "
        f"(atol {PREC_PLAIN_LOSS_ATOL}); grad relative L2, worst leaf "
        f"{worst} {rel[worst]:.5f} (limit {PREC_PLAIN_GRAD_REL_L2}); all "
        f"leaves {json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    if not all(np.isfinite((lk, lp, lx))):
        failures.append("precision step-0: non-finite loss")
    if lk != lp or unequal:
        failures.append(f"precision step-0: loss kernel {lk!r} vs plain int8 "
                        f"{lp!r}, {len(unequal)} grad leaves not bit-equal")
    if abs(lp - lx) > PREC_PLAIN_LOSS_ATOL:
        failures.append(f"precision plain: |loss| {abs(lp - lx)} over "
                        f"{PREC_PLAIN_LOSS_ATOL}")
    if not rel[worst] <= PREC_PLAIN_GRAD_REL_L2:
        failures.append(f"precision plain: {worst} relative L2 {rel[worst]} "
                        f"over {PREC_PLAIN_GRAD_REL_L2}")
    del out, gp, gx
    torch.cuda.empty_cache()
    ratio = _prec_attention_reading(captured)
    if not ratio <= 1.0:
        failures.append(f"precision attention: the flash kernels on the "
                        f"step's layer-0 inputs against plain attention, "
                        f"gate ratio {ratio:.3f}")
    r = _adam8_readings(shards, gk)
    log(f"precision adam8: card against the CPU after two updates, leaves "
        f"not bit-equal (elements): {json.dumps(r['unequal'])}; square roots "
        f"of 4 000 000 f32 draws off the card's: torch.sqrt on the CPU "
        f"{r['sqrt_off'][0]}, optim8._sqrt {r['sqrt_off'][1]}")
    log(f"precision adam8: {r['n_params']} params a rank; moments at rest "
        f"int8 {r['state8_bytes']} bytes against bf16 "
        f"{r['state_full_bytes']} ({r['state8_bytes'] / r['state_full_bytes']:.4f}); "
        f"adam8_update {r['adam8_ms']:.3f} ms (byte bound "
        f"{r['adam8_bound_ms']:.3f}, {r['adam8_ms'] / r['adam8_bound_ms']:.1f}x), "
        f"adam_update {r['adam_ms']:.3f} ms (bound {r['adam_bound_ms']:.3f}, "
        f"{r['adam_ms'] / r['adam_bound_ms']:.1f}x)")
    if r["unequal"]:
        failures.append(f"precision adam8: {len(r['unequal'])} leaves of the "
                        f"card's update differ from the CPU's")
    del shards, gk
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def precision_train_phase(card: str, loss0: float) -> dict:
    """Phase 13a's run: ``PREC_TRAIN["num_steps"]`` steps of
    ``train_fsdp.run`` with quantised gathers and grads and int8 state:
    launches exact, plain calls 0, every step's collectives the
    contract's, the step-0 loss bit-equal to the parity's kernel path,
    losses finite and falling; the state's bytes at rest, step time,
    tokens/s, MFU, peak memory, and a profile of the last step.
    Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    p = PREC_TRAIN
    L, n = PREC_CFG.num_hidden_layers, p["num_steps"]
    expect = _prec_expect(L)
    _reset_kernel_counts()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        if i == n - 2:
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = train_fsdp.run(p["model"], precision=p["precision"],
                         attention=p["attention"], batch_size=p["bs"],
                         seq=p["seq"], num_steps=n, device="cuda",
                         seed=p["seed"], quantized_gather=True,
                         quantized_grads=True, state_precision="int8",
                         on_step=on_step, log=log)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    want = {k: n * per for k, (_, per) in expect.items()}
    losses, times = res["losses"], res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])
    tok_s = p["seq"] * p["bs"] / step_s
    flops_tok = res["model_flops_per_token"]
    # the tree's shapes (drawn on the card, kept on the meta device)
    shapes = T.init_params(PREC_CFG, torch.Generator(device="cuda"), "meta")
    n_params = sum(t.numel() for _, t in fsdp.optim.tree_leaves(shapes))
    full_bytes = 2 * 2 * n_params   # two bf16 moments
    want_coll = fsdp_quantized_step_collectives(
        shapes, remat=PREC_CFG.remat, quantized_grads=True)
    log(f"precision train on {card}: losses {losses}; collectives a step "
        f"{json.dumps(res['collectives'][-1])}")
    log(f"precision train: step times (s, host clock, each ending in a "
        f"sync) {steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f"; peak memory {res['peak_memory_bytes'] / 2 ** 30:.3f} GiB; Adam "
        f"moments at rest {res['opt_state_bytes']} bytes (int8) against "
        f"{full_bytes} (bf16), ratio {res['opt_state_bytes'] / full_bytes:.4f}")
    log(f"precision train launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)}")
    log(f"precision train: step-0 loss {losses[0]!r}, the parity phase's "
        f"kernel path {loss0!r}, bit-equal {losses[0] == loss0}")
    _step_profile(prof, marks["wall_us"], "precision train", n - 1)
    check(losses[0] == loss0, f"precision train: step-0 loss {losses[0]!r} "
          f"of the run is not the parity phase's {loss0!r}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"precision train: {name} (launches, plain) "
              f"{(launches, plain)} != ({want[name]}, 0)")
    for i, c in enumerate(res["collectives"]):
        check(c == want_coll, f"precision train: step {i} collectives {c} "
              f"!= the contract's {want_coll}")
    check(all(np.isfinite(losses)), f"precision train: non-finite loss in "
          f"{losses}")
    check(losses[-1] < losses[0], f"precision train: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


def remat_phase(card: str) -> dict:
    """Phase 13b: SMOLLM3_3B_L8 at bf16 with flash attention on the
    one-rank group, one FSDP value-and-grad after a warm-up under each
    remat policy.  Gates: the flash forward's launches a step (2·L under
    ``full``, ``save_dots`` and ``save_dots_q8``, whose policies keep only
    the projections; L under ``save_attn``) and the backward's L, plain
    calls 0; ``save_attn`` and ``save_dots`` bit-equal to ``full`` in loss
    and grads; ``save_dots_q8``'s loss within rel ``REMAT_Q8_LOSS_RTOL``
    of ``full``'s and not closer than ``REMAT_Q8_LOSS_MIN_RTOL``, and the
    bytes it keeps beyond ``full``'s at most ``REMAT_Q8_SAVED_RATIO`` of
    ``save_dots``'.  Logs each policy's step ms and its peak above the
    step's start."""
    cfg0 = train_fsdp.model_config(REMAT["model"])
    L = cfg0.num_hidden_layers
    shards, batch = _prec_inputs(cfg0, REMAT["seed"], REMAT["seq"],
                                 REMAT["bs"], REMAT["num_steps"])
    want_fwd = {"full": 2 * L, "save_attn": L, "save_dots": 2 * L,
                "save_dots_q8": 2 * L}
    rows, failures, ref = {}, [], None
    for policy in T.REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        vg = fsdp.make_fsdp_value_and_grad(shards, cfg)
        vg(shards, batch)   # the warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        _reset_kernel_counts()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = vg(shards, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() - start
        launches = {"flash_attention_fwd": (FA.FWD_COUNTS.launches,
                                            FA.FWD_COUNTS.plain_calls),
                    "flash_attention_bwd": (FA.BWD_COUNTS.launches,
                                            FA.BWD_COUNTS.plain_calls)}
        rows[policy] = {"loss": float(loss), "ms": round(ms, 1),
                        "peak_above_start_gib": round(peak / 2 ** 30, 3),
                        "peak_bytes": peak, "launches": launches}
        log(f"remat {policy} on {card}: loss {float(loss)!r}, step {ms:.1f} "
            f"ms (host clock, one fwd+bwd), peak above the start "
            f"{peak / 2 ** 30:.3f} GiB, FA (launches, plain) "
            f"{json.dumps(launches)}")
        if launches != {"flash_attention_fwd": (want_fwd[policy], 0),
                        "flash_attention_bwd": (L, 0)}:
            failures.append(f"remat {policy}: FA launches {launches} != "
                            f"forward {want_fwd[policy]}, backward {L}")
        if policy == "full":
            ref = (float(loss), grads)
            continue
        if policy == "save_dots_q8":
            rel = abs(float(loss) - ref[0]) / abs(ref[0])
            saved = {k: (rows[k]["peak_bytes"] - rows["full"]["peak_bytes"])
                     for k in ("save_dots", "save_dots_q8")}
            ratio = saved["save_dots_q8"] / saved["save_dots"]
            log(f"remat save_dots_q8: |loss - full| / full {rel:.3e} "
                f"(limits {REMAT_Q8_LOSS_MIN_RTOL}, {REMAT_Q8_LOSS_RTOL}); "
                f"bytes kept beyond full's {saved['save_dots_q8']} against "
                f"save_dots' {saved['save_dots']}, ratio {ratio:.4f} (limit "
                f"{REMAT_Q8_SAVED_RATIO})")
            if not REMAT_Q8_LOSS_MIN_RTOL <= rel <= REMAT_Q8_LOSS_RTOL:
                failures.append(f"remat save_dots_q8: loss rel {rel} "
                                f"outside [{REMAT_Q8_LOSS_MIN_RTOL}, "
                                f"{REMAT_Q8_LOSS_RTOL}]")
            if not ratio <= REMAT_Q8_SAVED_RATIO:
                failures.append(f"remat save_dots_q8: saved bytes ratio "
                                f"{ratio} over {REMAT_Q8_SAVED_RATIO}")
        else:
            unequal = [("/".join(path)) for path, a in
                       fsdp.optim.tree_leaves(grads)
                       if not torch.equal(a, fsdp.optim.tree_get(ref[1],
                                                                 path))]
            log(f"remat {policy}: loss bit-equal to full's "
                f"{float(loss) == ref[0]}; grad leaves not bit-equal "
                f"{unequal}")
            if float(loss) != ref[0] or unequal:
                failures.append(f"remat {policy}: not bit-equal to full "
                                f"({len(unequal)} grad leaves)")
        del grads
    del shards, ref
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return rows


def _grad_rel_l2(ga, gb) -> dict:
    """Each grad leaf's relative L2 distance of ``ga`` from ``gb``."""
    out = {}
    for path, a in fsdp.optim.tree_leaves(ga):
        b = fsdp.optim.tree_get(gb, path).float()
        out["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    return out


def _bench_step0(cfg, shards, batch, plain: bool):
    """One FSDP value-and-grad of a 13c row on its inputs: the kernel
    path with the first layer's attention inputs and output grad and
    K6's first operands at each projection shape captured, or (``plain``)
    with the int8 products plain (``int8*``) or the plain fp8 recipe
    (``fp8_pallas`` as ``fp8``).  Returns (loss, grads, captures)."""
    flash, k6 = T.flash_attention, Q.fp8_matmul_kernel
    att, ops = {}, {}

    def capture(q, k, v, scale):
        o = flash(q, k, v, scale)
        if "q" not in att:
            att.update(q=q.detach().clone(), k=k.detach().clone(),
                       v=v.detach().clone(), scale=scale)
            o.register_hook(lambda g: att.setdefault("do", g.detach()
                                                     .clone()))
        return o

    def k6_capture(aq, a_s, bt, b_s, out_dtype=torch.bfloat16):
        ops.setdefault((aq.shape[1], bt.shape[0]), tuple(
            t.detach().clone() for t in (aq, a_s, bt, b_s)))
        return k6(aq, a_s, bt, b_s, out_dtype)

    if plain and cfg.matmul_precision == "fp8_pallas":
        cfg = dataclasses.replace(cfg, matmul_precision="fp8")
    vg = fsdp.make_fsdp_value_and_grad(shards, cfg)
    if not plain:
        T.flash_attention, Q.fp8_matmul_kernel = capture, k6_capture
    try:
        with (Q.plain_int8_products() if plain
              else contextlib.nullcontext()):
            loss, grads = vg(shards, batch)
    finally:
        T.flash_attention, Q.fp8_matmul_kernel = flash, k6
    torch.cuda.synchronize()
    return float(loss), grads, att, ops


def precision_bench_parity_phase() -> dict:
    """Phase 13c's gates, on each row's own inputs
    (``prec_bench.row_inputs``) on the one-rank group, before the rows
    run and uncounted: step 0 through the kernels against the plain
    versions at the shapes the rows give them (``PREC_BENCH``'s
    comment).  Returns each precision's kernel-path step-0 loss."""
    b = PREC_BENCH
    dev = mesh.init_process_group("cuda")
    atol, rtol = Q.TOLERANCE[torch.bfloat16]
    failures, loss0 = [], {}
    for precision in b["precisions"]:
        cfg, shards, batch = prec_bench.row_inputs(b["model"], precision,
                                                   b["seq"], b["bs"], dev)
        lk, gk, att, ops = _bench_step0(cfg, shards, batch, plain=False)
        loss0[precision] = lk
        ratio = _prec_attention_reading(att)
        if not ratio <= 1.0:
            failures.append(f"precision bench attention: {precision} row's "
                            f"layer-0 inputs, gate ratio {ratio:.3f}")
        if not np.isfinite(lk):
            failures.append(f"precision bench {precision}: non-finite "
                            f"step-0 loss")
        for (K, N), (aq, a_s, bt, b_s) in sorted(ops.items()):
            got = Q.fp8_matmul_kernel(aq, a_s, bt, b_s)
            ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, torch.bfloat16)
            r = gate_ratio(got, ref, atol, rtol)
            log(f"precision bench fp8_matmul ({aq.shape[0]}, {K}) x ({K}, "
                f"{N}), the row's first operands: max_abs_err "
                f"{float((got.float() - ref.float()).abs().max()):.3e}, gate "
                f"ratio {r:.4f} (atol {atol}, rtol {rtol})")
            if not r <= 1.0:
                failures.append(f"precision bench fp8_matmul: ({K}, {N}) "
                                f"gate ratio {r:.3f}")
        if precision == "bf16":
            log(f"precision bench {precision}: step-0 loss {lk!r}")
            del gk, shards
            continue
        lp, gp, _, _ = _bench_step0(cfg, shards, batch, plain=True)
        rel = _grad_rel_l2(gk, gp)
        worst = max(rel, key=rel.get)
        unequal = [k for k, v in rel.items() if v != 0.0]
        log(f"precision bench {precision}: step-0 loss kernel {lk!r} plain "
            f"{lp!r}; grad relative L2, worst leaf {worst} "
            f"{rel[worst]:.5f}; all leaves "
            f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
        if precision.startswith("int8"):
            if lk != lp or any(not torch.equal(
                    a, fsdp.optim.tree_get(gp, path))
                    for path, a in fsdp.optim.tree_leaves(gk)):
                failures.append(f"precision bench {precision} step-0: loss "
                                f"{lk!r} vs plain {lp!r}, grad leaves not "
                                f"bit-equal {unequal}")
        else:
            if ops.keys() != {(K, N) for _, K, N in PROJECTIONS}:
                failures.append(f"precision bench fp8_matmul: captured "
                                f"shapes {sorted(ops)}")
            if abs(lk - lp) > PREC_BENCH_FP8_LOSS_ATOL:
                failures.append(f"precision bench {precision} step-0: |loss "
                                f"kernel - plain| {abs(lk - lp)} over "
                                f"{PREC_BENCH_FP8_LOSS_ATOL}")
            if not rel[worst] <= PREC_BENCH_FP8_GRAD_REL_L2:
                failures.append(f"precision bench {precision} step-0: "
                                f"{worst} relative L2 {rel[worst]} over "
                                f"{PREC_BENCH_FP8_GRAD_REL_L2}")
        del gk, gp, shards, ops, att
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return loss0


def precision_bench_phase(card: str, loss0: dict) -> tuple[list, dict]:
    """Phase 13c: ``train.precision_benchmark.run_one`` at
    ``PREC_BENCH``'s shapes for each of its precisions on the one-rank
    group: the reference's row keys, no failure, finite losses, each
    row's step-0 loss bit-equal to its kernel path's in
    :func:`precision_bench_parity_phase` (``loss0``); the launches of K6
    (fp8_pallas), K5 and K4 (int8_pallas_bwd) and the flash kernels
    (every row) exact, plain calls 0.  Returns the rows and the launch
    counts."""
    b = PREC_BENCH
    L = T.SMOLLM3_3B_L8.num_hidden_layers
    per = len(PROJECTIONS) * L * 2 * b["num_steps"]
    n_rows = len(b["precisions"])
    expect = {"fp8_matmul": (Q.COUNTS, per),
              "int8_matmul_fused": (Q.INT8_FUSED_COUNTS, per),
              "int8_matmul": (Q.INT8_COUNTS, per),
              "flash_attention_fwd": (FA.FWD_COUNTS,
                                      2 * L * b["num_steps"] * n_rows),
              "flash_attention_bwd": (FA.BWD_COUNTS,
                                      L * b["num_steps"] * n_rows)}
    _reset_kernel_counts()
    rows = []
    for precision in b["precisions"]:
        first = {}
        row = prec_bench.run_one(b["model"], precision, b["seq"],
                                 b["num_steps"], b["bs"],
                                 Path("build/precision"), device="cuda",
                                 log=log, on_step=lambda i, loss, first=first:
                                 first.setdefault(i, loss))
        rows.append(row)
        check(set(row) == PREC_BENCH_KEYS and "failure" not in row,
              f"precision bench: row keys {sorted(row)}")
        check(np.isfinite(row["avg_loss"]) and row["tokens_per_second"] > 0,
              f"precision bench: {precision} row {row}")
        check(first[0] == loss0[precision], f"precision bench: {precision} "
              f"row's step-0 loss {first[0]!r} is not its parity's "
              f"{loss0[precision]!r}")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    log(f"precision bench on {card}: rows {json.dumps(rows)}")
    log(f"precision bench launches (kernel, plain): {json.dumps(counts)}; "
        f"expected {json.dumps({k: v for k, (_, v) in expect.items()})}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (expect[name][1], 0),
              f"precision bench: {name} (launches, plain) "
              f"{(launches, plain)} != ({expect[name][1]}, 0)")
    return rows, {k: v[0] for k, v in counts.items()}


# ------------------------------------------------ phase 14: resilience

def _disk_check(label: str, directory: str, need: int) -> None:
    """Fail, both numbers printed, when ``directory``'s file system has
    less free space than the saves of a run need."""
    free = shutil.disk_usage(directory).free
    log(f"{label}: the saves need up to {need / 1e9:.2f} GB under "
        f"{directory}, {free / 1e9:.2f} GB free")
    check(free >= need, f"{label}: too little disk for the checkpoints: "
          f"{need} bytes needed, {free} bytes free under {directory}")


def _run_dirs(root: Path) -> list[Path]:
    return sorted(p for p in root.iterdir() if p.is_dir()) \
        if root.is_dir() else []


def _saves_line(saves: list) -> str:
    return "; ".join(
        f"step {s['step']}: {s['bytes']} bytes, blocking "
        f"{s['blocking_s'] * 1e3:.1f} ms, background "
        + (f"{s['write_s'] * 1e3:.1f} ms" if s["write_s"] is not None
           else "not measured") for s in saves)


def _harness(root: Path, tag: str, **kw):
    """The run harness's config for one leg of phase 14: run directories
    and traces under ``root``; ``kw`` the leg's own options."""
    return quiet_config(telemetry=True, results_dir=str(root / "runs" / tag),
                        trace_dir=str(root / "traces" / tag), **kw)


def _fsdp_resilience(card: str, root: Path, sync: dict) -> dict:
    """14(a): ``train_fsdp.run`` at ``ring_fused_pallas`` with flash
    attention, uninterrupted and preempted at step 3, telemetry and the
    profiler on."""
    from distributed_training_sandbox_tpu_torch.telemetry.schema import (
        validate_step)
    from distributed_training_sandbox_tpu_torch.telemetry.spans import (
        read_spans)
    r = RESILIENCE
    L, n = FSDP_CFG.num_hidden_layers, r["num_steps"]
    per = {"ag_matmul": (C.COUNTS, L * len(PROJECTIONS) * 2),
           "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
           "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    pbytes = 2 * FSDP_PARAMS          # bf16 params
    need = (r["keep"] + 1) * 3 * pbytes   # params, m and v, keep + 1 steps
    _disk_check("resilience fsdp", str(root), need)
    kw = dict(overlap=r["overlap"], attention="flash",
              batch_size=r["bs"], seq=r["seq"], num_steps=n,
              device="cuda", seed=r["seed"], log=log,
              profile_schedule=ProfileSchedule(**r["profile"]))
    runs = {}
    for tag, fault in (("whole", {}), ("preempted", dict(
            checkpoint_dir=str(root / "ck-fsdp"),
            checkpoint_every=r["ckpt_every"], inject_fault=r["fault"],
            max_restarts=1))):
        for c, _ in per.values():
            c.reset()
        seg1 = {}

        def on_step(i, loss, seg1=seg1):
            if i == r["fault_step"] - 1:   # resolved at segment 1's drain
                seg1.update({k: c.launches for k, (c, _) in per.items()})

        cfg = _harness(root, f"fsdp-{tag}", profile=True, dispatch="async",
                       sync_every=r["sync_every"], **fault)
        t = time.perf_counter()
        res = train_fsdp.run(r["model"], config=cfg, on_step=on_step, **kw)
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t
        res["counts"] = {k: (c.launches, c.plain_calls)
                         for k, (c, _) in per.items()}
        res["seg1"] = seg1
        runs[tag] = res
        shutil.rmtree(root / "ck-fsdp", ignore_errors=True)
    whole, cut = runs["whole"], runs["preempted"]
    log(f"resilience fsdp on {card}: uninterrupted losses {whole['losses']}"
        f"; preempted at step {r['fault_step']} and resumed "
        f"{cut['losses']} (status {cut['status']}, this segment from step "
        f"{cut['start_step']})")
    check(cut["status"] == "completed" and cut["start_step"]
          == r["fault_step"], f"resilience fsdp: the run did not resume at "
          f"step {r['fault_step']} ({cut['status']}, {cut['start_step']})")
    check(cut["losses"] == whole["losses"], f"resilience fsdp: stitched "
          f"losses {cut['losses']} are not the uninterrupted run's "
          f"{whole['losses']} bit for bit")
    for tag, res in runs.items():
        want = {k: (n * p, 0) for k, (_, p) in per.items()}
        log(f"resilience fsdp {tag} launches (kernel, plain) "
            f"{json.dumps(res['counts'])}, expected {json.dumps(want)}; "
            f"segment 1 {json.dumps(res['seg1'])}")
        check(res["counts"] == want, f"resilience fsdp {tag}: launches "
              f"{res['counts']} != {want}")
    want1 = {k: r["fault_step"] * p for k, (_, p) in per.items()}
    check(cut["seg1"] == want1, f"resilience fsdp: segment 1 launched "
          f"{cut['seg1']}, its {r['fault_step']} steps take {want1}")
    # the run directories: lineage, schema, spans, trace
    dirs = _run_dirs(root / "runs" / "fsdp-preempted")
    mans = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    lin = mans[-1].get("lineage") or {}
    segs = lin.get("segments") or []
    log(f"resilience fsdp lineage: resumed_from_step "
        f"{lin.get('resumed_from_step')}, segments {json.dumps(segs)}; "
        f"manifest card {mans[-1].get('card')!r}, torch "
        f"{mans[-1].get('torch_version')}, CUDA "
        f"{mans[-1].get('cuda_version')}, NCCL {mans[-1].get('nccl_version')}")
    check(len(dirs) == 2 and lin.get("resumed_from_step")
          == r["fault_step"] - 1 and any(s.get("status") == "preempted"
                                         for s in segs),
          f"resilience fsdp: lineage {lin} in {len(dirs)} run directories")
    bad, spans = [], []
    for d in dirs + _run_dirs(root / "runs" / "fsdp-whole"):
        for line in (d / "steps.jsonl").read_text().splitlines():
            bad += validate_step(json.loads(line))
        spans += [sp["name"] for sp in read_spans(str(d))]
    check(not bad, f"resilience fsdp: steps.jsonl lines fail the schema: "
          f"{bad[:5]}")
    names = set(spans)
    log(f"resilience fsdp spans: {sorted(names)}")
    check({"checkpoint/save", "prefetch/wait", "prefetch/stage"} <= names,
          f"resilience fsdp: spans.jsonl lacks checkpoint or prefetch "
          f"spans: {sorted(names)}")
    prof = whole["profiler"]
    check(prof is not None and prof.trace_files and all(
        Path(f).is_file() for f in prof.trace_files),
        "resilience fsdp: the profiler wrote no trace")
    _step_profile(prof.last_profile, prof.windows[-1] * 1e6,
                  "resilience fsdp async", r["profile"]["wait"])
    # saves, restore, async against sync
    saves = cut["saves"]
    log(f"resilience fsdp saves on {card} (predicted "
        f"{3 * pbytes / 1e9:.3f} GB each: bf16 params, m and v): "
        f"{_saves_line(saves)}; restore "
        f"{[round(x * 1e3, 1) for x in cut['restore_s']]} ms")
    # params, m and v (the moments in the params' dtype), and the seed's
    # generator state
    state = whole["opt_state_bytes"] * 3 // 2 + sum(
        t.numel() for t in generator_states(
            {"params": r["seed"]}, whole["device"]).values())
    check(saves and all(s["bytes"] == state for s in saves),
          f"resilience fsdp: a save wrote {[s['bytes'] for s in saves]} "
          f"bytes, not {state} (params, m, v and the generator state)")
    # steps 4 and 5 between two full sync points (steps 3 and 5), after
    # the traced step: the async per-step time on the host clock
    times = whole["step_times_s"]
    async_ms = (times[n - 1] - times[n - 3]) / 2 * 1e3
    tr = whole["tracker"] or {}
    log(f"resilience fsdp on {card}: async step {async_ms:.1f} ms (steps "
        f"{n - 2}-{n - 1} between the pump's sync points at steps {n - 3} "
        f"and {n - 1}, host clock; host syncs {whole['host_syncs']}; "
        f"the whole run {whole['wall_s']:.3f} s), tracker tokens/s "
        f"{tr.get('tokens_per_second', float('nan')):.1f}, TFLOP/s a "
        f"device {tr.get('tflops_per_device', float('nan')):.2f}; sync "
        f"(phase 9, a host sync every step) step "
        f"{sync.get('step_ms', float('nan')):.1f} ms, "
        f"{sync.get('tokens_per_s', float('nan')):.1f} tokens/s")
    return {"losses": whole["losses"], "async_step_ms": async_ms,
            "tracker_tokens_per_s": tr.get("tokens_per_second"),
            "sync_step_ms": sync.get("step_ms"), "saves": saves,
            "restore_s": cut["restore_s"],
            "counts": {k: v[0] for k, v in whole["counts"].items()},
            "resumed_counts": {k: v[0] for k, v in cut["counts"].items()}}


def _toy_resilience(card: str, root: Path) -> dict:
    """14(b): ``train.ddp.run`` preempted at step 3 and crashed at step 5
    (saves every 2 steps, at the pump's sync points) and
    ``train.zero.run`` stage 3 preempted in its sharded leg, at the ZeRO
    toy's full width, each against its uninterrupted run."""
    t = RESILIENCE_TOY
    sizes = [w // t["scale"] for w in MLP.ZERO_TOY_SIZES]
    pbytes = 4 * sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
    out = {}
    ddp_kw = dict(scale=t["scale"], num_steps=t["num_steps"],
                  batch_size=t["ddp_batch"], seed=t["seed"],
                  device="cuda", log=log)
    whole = ddp_run.run(config=_harness(root, "ddp", dispatch="async"),
                        **ddp_kw)
    for tag, kw in (("ddp", dict(inject_fault=t["fault"])),
                    ("ddp crash", dict(inject_fault=t["crash"],
                                       checkpoint_every=2, sync_every=2))):
        ck = root / "ck-ddp"
        _disk_check(f"resilience {tag}", str(root), 4 * pbytes)
        res = ddp_run.run(config=_harness(
            root, tag.replace(" ", "-"), dispatch="async",
            checkpoint_dir=str(ck), max_restarts=1, **kw), **ddp_kw)
        shutil.rmtree(ck, ignore_errors=True)
        same = [torch.equal(a, fsdp.optim.tree_get(res["params"], p))
                for p, a in fsdp.optim.tree_leaves(whole["params"])]
        log(f"resilience {tag} on {card}: losses {res['losses']} against "
            f"{whole['losses']}; final params bit-equal {all(same)}; saves "
            f"{_saves_line(res['saves'])}; restore "
            f"{[round(x * 1e3, 1) for x in res['restore_s']]} ms")
        check(res["status"] == "completed" and res["losses"]
              == whole["losses"] and all(same),
              f"resilience {tag}: stitched losses {res['losses']} or final "
              f"params (bit-equal {all(same)}) are not the uninterrupted "
              f"run's {whole['losses']}")
        out[tag] = {"saves": res["saves"], "restore_s": res["restore_s"]}
        del res
    del whole
    torch.cuda.empty_cache()
    zkw = dict(scale=t["scale"], num_steps=t["num_steps"],
               batch_size=t["zero_batch"], seed=t["seed"], device="cuda",
               keep_params=True, log=log)
    whole = zero_run.run(3, config=_harness(root, "zero3",
                                            dispatch="async"), **zkw)
    whole_params = (whole.pop("base_params"), whole.pop("shard_params"))
    torch.cuda.empty_cache()
    _disk_check("resilience zero3", str(root), 4 * 3 * pbytes)
    ck = root / "ck-zero3"
    cut = zero_run.run(3, config=_harness(
        root, "zero3-preempted", dispatch="async", checkpoint_dir=str(ck),
        inject_fault=t["zero_fault"], max_restarts=1), **zkw)
    shutil.rmtree(ck, ignore_errors=True)
    same = all(torch.equal(a, fsdp.optim.tree_get(b, p))
               for w, b in zip(whole_params, (cut["base_params"],
                                              cut["shard_params"]))
               for p, a in fsdp.optim.tree_leaves(w))
    log(f"resilience zero3 on {card}: baseline {cut['base_losses']}, "
        f"sharded {cut['shard_losses']} against {whole['base_losses']}, "
        f"{whole['shard_losses']}; final params bit-equal {same}; sharded "
        f"bit-equal to baseline Adam {cut['params_bit_equal']}; saves "
        f"{_saves_line(cut['saves'])}; restore "
        f"{[round(x * 1e3, 1) for x in cut['restore_s']]} ms")
    check(cut["status"] == "completed" and same
          and cut["base_losses"] == whole["base_losses"]
          and cut["shard_losses"] == whole["shard_losses"],
          "resilience zero3: stitched losses or final params are not the "
          "uninterrupted run's")
    check(cut["params_bit_equal"] and cut["base_losses"]
          == cut["shard_losses"], "resilience zero3: the sharded leg is not "
          "bit-equal to baseline Adam")
    out["zero3"] = {"saves": cut["saves"], "restore_s": cut["restore_s"]}
    return out


def resilience_phase(card: str, sync: dict | None = None) -> dict:
    """Phase 14 on the one-rank NCCL group: preempt → resume of FSDP
    (K7 and the flash kernels), DDP and ZeRO-3, bit for bit; checkpoints,
    run directories and traces under a temporary directory, removed at
    the end.  ``sync``: phase 9's readings (``fsdp_train_phase``), printed
    beside the async ones.  Returns the readings and the kernels'
    launches of both FSDP runs."""
    import tempfile
    torch.cuda.empty_cache()
    mesh.init_process_group("cuda")
    root = Path(tempfile.mkdtemp(prefix="smoke-resilience-"))
    try:
        a = _fsdp_resilience(card, root, sync or {})
        torch.cuda.empty_cache()
        b = _toy_resilience(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"resilience readings on {card}: " + json.dumps(
        {"fsdp": {k: v for k, v in a.items() if k != "counts"}, **b}))
    return a


# ------------------------------------------------- phase 15: the MoE model

def _moe_expect(cfg) -> dict:
    """The kernels one int8_pallas_bwd MoE step launches (remat "full"):
    K5 each attention projection's and each expert's three products'
    forward and recompute, K4 their dX and dW, the flash forward twice a
    layer and its backward once."""
    L, E = cfg.num_hidden_layers, cfg.n_experts
    products = 4 + 3 * E
    return {"int8_matmul_fused": (Q.INT8_FUSED_COUNTS, L * products * 2),
            "int8_matmul": (Q.INT8_COUNTS, L * products * 2),
            "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
            "flash_attention_bwd": (FA.BWD_COUNTS, L)}


def _moe_inputs(cfg):
    """train.moe.run's params (seeded init on the card, whole at ep 1)
    and first global batch, and the one-rank dp x ep axes."""
    mesh.init_process_group("cuda")
    axes = mesh.dp_ep_axes(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(MOE_TRAIN["seed"])
    params = T.init_params(cfg, gen, "cuda")
    ib, lb = next(train_fsdp.fsdp_batches(
        cfg.vocab_size, MOE_TRAIN["seq"], MOE_TRAIN["bs"],
        MOE_TRAIN["num_steps"], MOE_TRAIN["seed"]))
    return params, (torch.as_tensor(ib, device="cuda"),
                    torch.as_tensor(lb, device="cuda")), axes


def moe_parity_phase() -> float:
    """Phase 15a: SMOLLM3_3B_L8_MOE's step-0 loss and grads at
    int8_pallas_bwd, the MoE step's forward and backward at dp 1 x ep 1
    (flash attention on both sides), through K5 and K4 against the plain
    int8 products: every product is exact and both sides round at the
    same points, so the loss and every grad leaf (router and expert
    banks too) must be bit-equal.  The kernel path's launches must be
    ``_moe_expect``'s, and the loss the streamed cross-entropy plus
    ``moe_aux_weight`` times the layers' aux, recomposed apart.  Returns
    the kernel path's loss."""
    params, batch, (_, ep_ax) = _moe_inputs(MOE_CFG)
    cfg = dataclasses.replace(MOE_CFG, ep_axis=ep_ax)
    expect = _moe_expect(MOE_CFG)
    out, counts = {}, {}
    for name in ("kernel", "plain"):
        _reset_kernel_counts()
        t = time.perf_counter()
        seen, undo = _capture_routes()
        try:
            with (Q.plain_int8_products() if name == "plain"
                  else contextlib.nullcontext()):
                loss, grads = fsdp.microbatch_value_and_grad(
                    lambda p, b: T.lm_loss(p, b, cfg), params, batch, 1)
        finally:
            undo()
        torch.cuda.synchronize()
        if name == "kernel":   # the forward's L routes, as dispatched
            drops = [float(EX.grouped_drop_fraction(
                e, cfg.n_experts, cfg.moe_group_size,
                cfg.moe_capacity_factor)) for e in seen[:cfg.num_hidden_layers]]
            log(f"moe parity: {MOE_TRAIN['model']} with {cfg.n_experts} "
                f"experts of ffn {cfg.moe_ffn}, {cfg.param_count()} params; "
                f"the grouped dispatch's drop fraction at init by layer "
                f"(group {cfg.moe_group_size}, cf "
                f"{cfg.moe_capacity_factor}) {drops}")
        counts[name] = {k: (c.launches, c.plain_calls)
                        for k, (c, _) in expect.items()}
        out[name] = (float(loss), grads)
        log(f"moe parity: {name} path loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s); launches (kernel, plain) "
            f"{json.dumps(counts[name])}")
    with torch.no_grad():
        x, aux = T.hidden_states(params, batch[0], cfg, return_aux=True)
        xent = T.xent_from_hidden(x, T._output_embedding(params, cfg),
                                  batch[1], chunk=cfg.loss_vocab_chunk)
        composed = float(xent + cfg.moe_aux_weight * aux)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    unequal = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path)
        if not torch.equal(a, b):
            unequal["/".join(path)] = float((a.float() - b.float()).abs().max())
    log(f"moe parity: loss kernel {lk!r} plain {lp!r} (bit-equal {lk == lp})"
        f"; grad leaves not bit-equal: {json.dumps(unequal)}; the loss "
        f"recomposed: xent {float(xent)!r} + {cfg.moe_aux_weight} x aux "
        f"{float(aux)!r} = {composed!r}, |difference| {abs(composed - lk)!r}"
        f" (atol {MOE_LOSS_SUM_ATOL})")
    want = {k: per for k, (_, per) in expect.items()}
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("moe int8 step-0 loss: non-finite")
    if lk != lp:
        failures.append(f"moe int8 step-0 loss: kernel {lk!r} != plain "
                        f"{lp!r}")
    if unequal:
        failures.append(f"moe int8 step-0 grads: {len(unequal)} leaves not "
                        f"bit-equal, max |kernel - plain| "
                        f"{max(unequal.values())}")
    if not abs(composed - lk) <= MOE_LOSS_SUM_ATOL:
        failures.append(f"moe loss sum: lm_loss {lk!r} is not xent + "
                        f"aux_weight x aux {composed!r}")
    for k, (launches, plain) in counts["kernel"].items():
        if (launches, plain) != (want[k], 0):
            failures.append(f"moe parity: {k} (launches, plain) "
                            f"{(launches, plain)} != ({want[k]}, 0)")
    del params, out, gk, gp, grads
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def moe_oracle(x, w_router, w_gate, w_up, w_down, *, capacity_factor,
               group_size, top_k, dense):
    """The grouped MoE MLP computed apart from ``parallel.expert`` (its
    router ``_route_topk`` aside): each group's assignments claim their
    experts' ``ceil(cf · k · G / E)`` slots first choices first, in token
    order, counted one by one on the host; each expert's products
    (``dense``) run on its kept tokens only, and each output row is the
    sum of its kept assignments' outputs times their gates, in the
    tokens' dtype.  Returns ``(y (N, H), aux)``."""
    N, H = x.shape
    E = w_router.shape[1]
    gates, experts, probs = EX._route_topk(x, w_router, top_k)
    G = EX._resolve_group(N, group_size)
    capg = math.ceil(capacity_factor * top_k * G / E)
    ex = experts.cpu().numpy()
    kept = np.zeros(ex.shape, dtype=bool)
    for g0 in range(0, N, G):
        claimed = [0] * E
        for j in range(top_k):
            for t in range(g0, g0 + G):
                e = ex[t, j]
                kept[t, j] = claimed[e] < capg
                claimed[e] += 1
    y = torch.zeros((N, H), dtype=x.dtype, device=x.device)
    for e in range(E):
        tok, j = np.nonzero((ex == e) & kept)
        if not len(tok):
            continue
        tok = torch.as_tensor(tok, device=x.device)
        xe = x[tok]
        h = dense(torch.nn.functional.silu(dense(xe, w_gate[e]))
                  * dense(xe, w_up[e]), w_down[e])
        g = gates[tok, torch.as_tensor(j, device=x.device)]
        y = y.index_add(0, tok, h * g[:, None].to(h.dtype))
    frac = torch.bincount(experts.reshape(-1), minlength=E).float() / (
        N * top_k)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return y, aux


def moe_oracle_phase() -> dict:
    """Phase 15 (oracle): ``parallel.expert.moe_mlp`` on layer 0's
    weights and the normed embeddings of the first batch (full width,
    8192 tokens) at dp 1 x ep 1, against :func:`moe_oracle`: the output
    and the grads of a probe loss (``Σ y · probe + aux``) with respect
    to the tokens, the router and each expert bank, each at relative L2
    distance <= ``MOE_ORACLE_REL_L2``, the aux within ``MOE_AUX_RTOL``.
    Cases (``MOE_ORACLE_CASES``): top-1 at cf 0.75 and top-2 at cf 1.0
    in f32 (the capacities drop assignments, so the capacity rule and
    the first-choices-first priority show) and top-1 at cf 2.0 at
    int8_pallas_bwd through K5 and K4 (each expert's int8 scales its
    own).  Returns the readings."""
    params, batch, (_, ep_ax) = _moe_inputs(MOE_CFG)
    lay = T.layer_params(params, 0)
    with torch.no_grad():
        x0 = T.rms_norm(params["embed"][batch[0].long()][0],
                        lay["ln1"], MOE_CFG.rms_norm_eps)
    weights = [lay[k] for k in ("w_router", "w_gate", "w_up", "w_down")]
    del params
    probe = torch.randn(x0.shape, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 15), device="cuda")
    readings, failures = {}, []
    for name, (dtype, precision, cf, k) in MOE_ORACLE_CASES.items():
        leaves = [t.detach().to(dtype).requires_grad_() for t in
                  [x0] + weights]
        kw = dict(capacity_factor=cf, top_k=k,
                  group_size=MOE_CFG.moe_group_size)
        y, aux = EX.moe_mlp(leaves[0][None], *leaves[1:], axis=ep_ax,
                            matmul_precision=precision, **kw)
        y = y[0]
        g = torch.autograd.grad((y.float() * probe).sum() + aux, leaves)
        oleaves = [t.detach().clone().requires_grad_() for t in leaves]
        yo, auxo = moe_oracle(*oleaves, dense=Q.resolve_quantized_dense(
            precision), **kw)
        go = torch.autograd.grad((yo.float() * probe).sum() + auxo, oleaves)
        rel = {n: float(torch.linalg.vector_norm(a.float() - b.float())
                        / torch.linalg.vector_norm(b.float()))
               for n, a, b in zip(("y", "x", "w_router", "w_gate", "w_up",
                                   "w_down"), [y] + list(g), [yo] + list(go))}
        aux_rel = abs(float(aux) - float(auxo)) / abs(float(auxo))
        readings[name] = {"rel_l2": rel, "aux_rel": aux_rel}
        log(f"moe oracle {name}: relative L2 off the oracle "
            f"{json.dumps({n: float(f'{v:.3e}') for n, v in rel.items()})} "
            f"(limit {MOE_ORACLE_REL_L2}); aux {float(aux)!r} oracle "
            f"{float(auxo)!r} (rtol {MOE_AUX_RTOL})")
        worst = max(rel, key=rel.get)
        if not rel[worst] <= MOE_ORACLE_REL_L2:
            failures.append(f"moe oracle {name}: {worst} relative L2 "
                            f"{rel[worst]} over {MOE_ORACLE_REL_L2}")
        if not aux_rel <= MOE_AUX_RTOL:
            failures.append(f"moe oracle {name}: aux {float(aux)!r} off the "
                            f"oracle's {float(auxo)!r}")
    check(not failures, "; ".join(failures))
    return readings


def _capture_routes():
    """Patch ``parallel.expert._route_topk`` to keep every call's expert
    choices; returns the list and the undo."""
    seen, orig = [], EX._route_topk

    def route(x2d, w_router, k):
        out = orig(x2d, w_router, k)
        seen.append(out[1].detach().clone())
        return out
    EX._route_topk = route
    return seen, lambda: setattr(EX, "_route_topk", orig)


def moe_bf16_phase() -> dict:
    """Phase 15b: the same model at bf16, step 0 with the flash kernels
    against plain attention (``attention_impl="xla"``), the rest plain
    on both sides: |loss difference| <= ``MOE_BF16_LOSS_ATOL`` and every
    dense leaf's grad (the expert banks and the router aside: a token
    whose near-tie route moves carries its grads to another expert)
    within relative L2 ``MOE_BF16_GRAD_REL_L2``; logs how many tokens
    chose another expert in any layer."""
    bf16 = dataclasses.replace(MOE_CFG, matmul_precision="bf16")
    params, batch, (_, ep_ax) = _moe_inputs(bf16)
    out = {}
    for name, attn in (("flash", "flash"), ("plain", "xla")):
        cfg = dataclasses.replace(bf16, attention_impl=attn, ep_axis=ep_ax)
        seen, undo = _capture_routes()
        t = time.perf_counter()
        try:
            loss, grads = fsdp.microbatch_value_and_grad(
                lambda p, b: T.lm_loss(p, b, cfg), params, batch, 1)
        finally:
            undo()
        torch.cuda.synchronize()
        # the forward's L calls (the recomputes follow in the backward)
        out[name] = (float(loss), grads, seen[:bf16.num_hidden_layers])
        log(f"moe bf16: {name} attention loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s)")
    (lf, gf, rf), (lp, gp, rp) = out["flash"], out["plain"]
    moved = [int((a != b).any(dim=-1).sum()) for a, b in zip(rf, rp)]
    rel = {k: v for k, v in _grad_rel_l2(gf, gp).items()
           if k.split("/")[-1] not in EX.EXPERT_LEAVES + ("w_router",)}
    worst = max(rel, key=rel.get)
    log(f"moe bf16: |loss flash - plain| {abs(lf - lp)!r} (atol "
        f"{MOE_BF16_LOSS_ATOL}); dense grad relative L2, worst leaf {worst} "
        f"{rel[worst]:.5f} (limit {MOE_BF16_GRAD_REL_L2}); all "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}; tokens "
        f"routed to another expert, by layer: {moved} of "
        f"{batch[0].numel()}")
    del params, out, gf, gp
    torch.cuda.empty_cache()
    check(np.isfinite(lf) and abs(lf - lp) <= MOE_BF16_LOSS_ATOL,
          f"moe bf16 step-0 loss: |flash - plain| {abs(lf - lp)} over "
          f"{MOE_BF16_LOSS_ATOL}")
    check(rel[worst] <= MOE_BF16_GRAD_REL_L2,
          f"moe bf16 step-0 grads: {worst} relative L2 {rel[worst]} over "
          f"{MOE_BF16_GRAD_REL_L2}")
    return {"loss_diff": abs(lf - lp), "worst_rel_l2": rel[worst],
            "moved_tokens": moved}


def _scope_profile(prof, label) -> None:
    """Log the MoE layer's ``record_function`` ranges of a profiled
    step: calls and each range's device span (its annotation on the
    device timeline, the gaps between its kernels included)."""
    rows = {e.key: e for e in prof.key_averages() if e.key in MOE_SCOPES}
    if not rows:
        log(f"{label} scopes: torch.profiler recorded none (not measured)")
        return
    for key in MOE_SCOPES:
        e = rows.get(key)
        if e is not None:
            log(f"{label} scope {key}: {e.count} calls, device span "
                f"{e.device_time_total / 1e3:.2f} ms")


def moe_train_phase(card: str, loss0: float) -> dict:
    """Phase 15c: ``train.moe.run`` at ep 1, ``MOE_TRAIN["num_steps"]``
    steps at int8_pallas_bwd under the harness (quiet config): launches
    exact, plain calls 0, every step's collectives the ``moe``
    contract's, the step-0 loss bit-equal to the parity's kernel path,
    losses finite and falling; step time, tokens/s, MFU on active FLOPs,
    peak memory and a ``torch.profiler`` breakdown of the last step by
    kernel and by the MoE layer's ranges.  Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    p = MOE_TRAIN
    n = p["num_steps"]
    expect = _moe_expect(MOE_CFG)
    _reset_kernel_counts()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        if i == n - 2:
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = moe_run.run(p["model"], ep=1, experts=p["experts"],
                      precision=p["precision"], batch_size=p["bs"],
                      seq=p["seq"], num_steps=n, device="cuda",
                      seed=p["seed"], on_step=on_step, log=log)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    want = {k: n * per for k, (_, per) in expect.items()}
    losses, times = res["losses"], res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])
    tok_s = p["seq"] * p["bs"] / step_s
    flops_tok = res["model_flops_per_token"]
    log(f"moe train on {card}: losses {losses}; collectives a step "
        f"{json.dumps(res['collectives'][-1])}, the moe contract's "
        f"{json.dumps(res['contract'])}")
    log(f"moe train: step times (s, host clock, each ending in a sync) "
        f"{steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f" ({flops_tok:.4e} active model FLOP/token over the 989 TFLOP/s "
        f"bf16 dense peak); peak memory "
        f"{res['peak_memory_bytes'] / 2 ** 30:.3f} GiB")
    log(f"moe train launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)}")
    log(f"moe train: step-0 loss {losses[0]!r}, the parity phase's kernel "
        f"path {loss0!r}, bit-equal {losses[0] == loss0}")
    # CPU activity slows the traced step's host (its wall read 2.3 s
    # against 1.1 s untraced on an H100): the idle share is read against
    # the median untraced step, whose device work is the same
    log(f"moe train: the traced step's wall "
        f"{marks['wall_us'] / 1e3:.1f} ms (CPU and CUDA activity)")
    _step_profile(prof, step_s * 1e6, "moe train", n - 1)
    _scope_profile(prof, "moe train")
    check(losses[0] == loss0, f"moe train: step-0 loss {losses[0]!r} of the "
          f"run is not the parity phase's {loss0!r}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"moe train: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    for i, c in enumerate(res["collectives"]):
        check(c == res["contract"], f"moe train: step {i} collectives {c} "
              f"!= the moe contract's {res['contract']}")
    check(all(np.isfinite(losses)), f"moe train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"moe train: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


# ------------------------------- phase 16: tensor and sequence parallelism

def _tp_axes(*names):
    """The one-rank grid of ``names`` on the smoke's NCCL group."""
    mesh.init_process_group("cuda")
    return mesh.grid_axes(names, (1,) * len(names))


def _rel_max(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def tp_shards_phase() -> dict:
    """Phase 16a: layer 0 of the seeded SMOLLM3_3B_L8 sliced by
    ``tensor.tp_specs`` for tp 2 and 4, every rank, at M = 8192 (seq
    8192, batch 1): each projection shard's product at int8_pallas_bwd
    through K5 (forward) and K4 (dX, dW) bit-equal to the plain int8
    products; the flash kernels on a rank's local heads (16/tp query,
    4/tp KV) within FA's limits of plain attention (the forward
    elementwise and by block; the grads by block and by their L2
    distance from the exact f64 gradient over the plain path's, as a
    pipeline stage's are: a dK element summed over 4 query heads and
    8192 queries reads up to 1.02 of the elementwise limit against the
    plain path on an H100, which rounds P to bf16 itself); the row-parallel
    shards' f32 partial products (wo, w_down), summed over the ranks,
    within ``TP_PARTIAL_REL`` of the whole layer's product."""
    p = TP_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(p["seed"])
    params = T.init_params(T.SMOLLM3_3B_L8, gen, "cuda")
    M = p["seq"] * p["bs"]
    H, F = T.SMOLLM3_3B_L8.hidden_size, T.SMOLLM3_3B_L8.intermediate_size
    ins = {"h": torch.randn((M, H), generator=gen, device="cuda"),
           "f": torch.randn((M, F), generator=gen, device="cuda")}
    ins = {k: v.to(torch.bfloat16) for k, v in ins.items()}
    dense = Q.resolve_quantized_dense("int8_pallas_bwd")
    unequal, launches, partial, fa = [], {}, {}, {}
    for tp in TP_SHARD_TPS:
        ranks = [tensor.shard_tree_tp(
            {"layers": {k: v[:1] for k, v in params["layers"].items()}},
            r, tp)["layers"] for r in range(tp)]
        sums = {}
        for r, shard in enumerate(ranks):
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                w = shard[name][0]
                if name in tensor.ROW:
                    full = ins["h" if name == "wo" else "f"]
                    x = full[:, r * w.shape[0]:(r + 1) * w.shape[0]]
                    part = x.float() @ w.float()
                    sums[name] = sums.get(name, 0) + part
                else:
                    x = ins["h"]
                dy = torch.randn((M, w.shape[1]), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                outs = {}
                for path in ("kernel", "plain"):
                    _reset_kernel_counts()
                    xx, ww = (t.detach().clone().requires_grad_(True)
                              for t in (x, w))
                    with (Q.plain_int8_products() if path == "plain"
                          else contextlib.nullcontext()):
                        y = dense(xx, ww)
                        dx, dw = torch.autograd.grad(y, (xx, ww), dy)
                    outs[path] = (y.detach(), dx, dw)
                    if path == "kernel":
                        key = f"{name} {tuple(w.shape)}"
                        launches[key] = (Q.INT8_FUSED_COUNTS.launches,
                                         Q.INT8_COUNTS.launches)
                for what, a, b in zip(("y", "dX", "dW"), outs["kernel"],
                                      outs["plain"]):
                    if not torch.equal(a, b):
                        unequal.append(f"tp {tp} rank {r} {name} {what}: "
                                       f"{float((a.float() - b.float()).abs().max())}")
        for name in tensor.ROW:
            w = params["layers"][name][0]
            whole = ins["h" if name == "wo" else "f"].float() @ w.float()
            partial[f"tp {tp} {name}"] = _rel_max(sums[name], whole)
        # the flash kernels on each rank's local heads
        hd = T.SMOLLM3_3B_L8.resolved_head_dim
        nq = T.SMOLLM3_3B_L8.num_attention_heads // tp
        nkv = T.SMOLLM3_3B_L8.num_key_value_heads // tp
        for r in range(tp):
            mk = lambda n: torch.randn((p["bs"], p["seq"], n, hd),
                                       generator=gen,
                                       device="cuda").to(torch.bfloat16)
            q, k, v, do = mk(nq), mk(nkv), mk(nkv), mk(nq)
            scale = hd ** -0.5
            o, lse = FA.flash_attention_fwd(q, k, v, scale)
            ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
            _, r_o = _fa_reading("flash_attention_fwd",
                                 f"tp {tp} rank {r} O ({nq}/{nkv} heads)",
                                 o, ref_o, "fwd")
            r_o = max(r_o, float((lse - ref_lse).abs().max()) / FA.LSE_ATOL)
            grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
            ref_g = FA.flash_attention_bwd_plain(q, k, v, do, scale)
            exact = FA.attention_bwd_oracle(q, k, v, do, scale)
            r_g, elem = 0.0, {}
            for n, g, rg, ex in zip(("dq", "dk", "dv"), grads, ref_g, exact):
                _fa_reading("flash_attention_bwd", f"tp {tp} rank {r} {n}",
                            g, rg, "bwd")
                blk = FA.block_rel_l2(g, rg) / FA.BLOCK_REL_L2
                l2 = FA.oracle_l2_ratio(g, rg, ex) / FA.BWD_ORACLE_L2_RATIO
                r_g = max(r_g, blk, l2)
                elem[n] = (gate_ratio(g, rg, *FA.TOLERANCE["bwd"]),
                           gate_ratio(g.double(), ex, *FA.TOLERANCE["bwd"]),
                           gate_ratio(rg.double(), ex, *FA.TOLERANCE["bwd"]))
            log(f"flash_attention_bwd: tp {tp} rank {r} elementwise ratios "
                f"at FA's limits (kernel - plain, kernel - exact, plain - "
                f"exact) {json.dumps(elem)}")
            fa[f"tp {tp} rank {r}"] = (r_o, r_g)
            del o, lse, ref_o, ref_lse, grads, ref_g, exact
    del params, ins
    torch.cuda.empty_cache()
    log(f"tp shards: K5/K4 launches (fused, K4) for each shard product "
        f"{json.dumps(launches)}; not bit-equal: {unequal}")
    log(f"tp shards: row-parallel partials summed over the ranks against "
        f"the whole product, max |difference| / max |product| (f32) "
        f"{json.dumps(partial)} (limit {TP_PARTIAL_REL})")
    log(f"tp shards: FA gate ratios on local heads: (forward at FA's "
        f"limits; backward, the larger of each grad's block relative L2 "
        f"over {FA.BLOCK_REL_L2} and its L2 distance from the exact f64 "
        f"gradient over the plain path's, over {FA.BWD_ORACLE_L2_RATIO}) "
        f"{json.dumps(fa)}")
    check(not unequal, f"tp shards int8: {len(unequal)} products not "
          f"bit-equal to the plain int8 products: {unequal[:4]}")
    check(all(v == (1, 2) for v in launches.values()),
          f"tp shards int8: launches (K5, K4) {launches} != (1, 2) a product")
    check(all(v <= TP_PARTIAL_REL for v in partial.values()),
          f"tp shards partial sums: {partial} above {TP_PARTIAL_REL}")
    check(all(max(v) <= 1.0 for v in fa.values()),
          f"tp shards flash attention: gate ratios {fa} above 1")
    return {"partial": partial, "fa": fa}


def tp_parity_phase() -> float:
    """Phase 16b: ``tensor.make_tp_train_step`` at dp 1 x tp 1 on
    SMOLLM3_3B_L8 at int8_pallas_bwd (flash attention), seq 8192: the
    step-0 loss and every grad leaf of ``tp_lm_loss`` through K5 and K4
    bit-equal to the plain int8 products (the rejoins at one rank copy),
    the launches exact; then one step: its loss bit-equal to the kernel
    path's, its launches exact and its collectives the ``tp`` contract's
    (``contracts.tp_step_collectives``).  Returns the step-0 loss."""
    p = TP_TRAIN
    axes = _tp_axes("dp", "tp")
    shards, batch = _prec_inputs(TP_PARITY_CFG, p["seed"], p["seq"], p["bs"],
                                 p["num_steps"])
    # the TP layer at tp 1 launches what the FSDP step's does
    expect = _prec_expect(TP_PARITY_CFG.num_hidden_layers)
    out, counts = {}, {}
    for name in ("kernel", "plain"):
        _reset_kernel_counts()
        with (Q.plain_int8_products() if name == "plain"
              else contextlib.nullcontext()):
            loss, grads = fsdp.microbatch_value_and_grad(
                lambda q, b: tensor.tp_lm_loss(q, b, TP_PARITY_CFG,
                                               axis=axes["tp"]),
                shards, batch, 1)
        torch.cuda.synchronize()
        counts[name] = {k: (c.launches, c.plain_calls)
                        for k, (c, _) in expect.items()}
        out[name] = (float(loss), grads)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    unequal = {"/".join(path): float((a.float() - fsdp.optim.tree_get(
        gp, path).float()).abs().max())
        for path, a in fsdp.optim.tree_leaves(gk)
        if not torch.equal(a, fsdp.optim.tree_get(gp, path))}
    del out, gk, gp, grads
    torch.cuda.empty_cache()
    step = tensor.make_tp_train_step(shards, TP_PARITY_CFG,
                                     dp_axis=axes["dp"], tp_axis=axes["tp"])
    opt = fsdp.init_fsdp_opt_state(shards)
    _reset_kernel_counts()
    shards, opt, loss = step(shards, opt, batch)
    ls = float(loss)
    step_counts = {k: (c.launches, c.plain_calls)
                   for k, (c, _) in expect.items()}
    coll = C.COLLECTIVES.read()
    contract = tp_step_collectives(shards, 1, remat=True)
    want = {k: per for k, (_, per) in expect.items()}
    log(f"tp parity: loss kernel {lk!r} plain {lp!r} (bit-equal "
        f"{lk == lp}); grad leaves not bit-equal {json.dumps(unequal)}; "
        f"launches (kernel, plain) {json.dumps(counts['kernel'])}, the "
        f"step's {json.dumps(step_counts)}, expected {json.dumps(want)}")
    log(f"tp parity: the step's loss {ls!r}; its collectives "
        f"{json.dumps(C.COLLECTIVES.nonzero(coll))}, the tp contract's "
        f"{json.dumps(C.COLLECTIVES.nonzero(contract))}")
    del shards, opt
    torch.cuda.empty_cache()
    check(np.isfinite(lk) and lk == lp, f"tp int8 step-0 loss: kernel "
          f"{lk!r} != plain {lp!r}")
    check(not unequal, f"tp int8 step-0 grads: {len(unequal)} leaves not "
          f"bit-equal: {unequal}")
    check(ls == lk, f"tp step: loss {ls!r} is not the parity's {lk!r}")
    for k, c in (("parity", counts["kernel"]), ("step", step_counts)):
        for name, (launches, plain) in c.items():
            check((launches, plain) == (want[name], 0),
                  f"tp {k}: {name} (launches, plain) {(launches, plain)} "
                  f"!= ({want[name]}, 0)")
    check(coll == contract, f"tp step: collectives {coll} != the tp "
          f"contract's {contract}")
    return lk


def _rows_oracle(q, k, v, do, scale, qrows, krows, chunk=512):
    """The exact f64 output and grads of causal GQA attention on slices:
    O and dQ on the query rows ``qrows``, dK and dV on the key rows
    ``krows`` (each a range), for (B, S, n, hd) inputs.  The row
    normalisers and ``rowsum(dO · O)`` of every query row come from a
    pass over chunks of ``chunk`` rows, so nothing S x S is held."""
    B, S, nq, hd = q.shape
    rep = nq // k.shape[2]
    q64, do64 = q.double(), do.double()
    k64 = k.double().repeat_interleave(rep, 2)
    v64 = v.double().repeat_interleave(rep, 2)
    cols = torch.arange(S, device=q.device)
    lse = torch.empty((B, nq, S), dtype=torch.float64, device=q.device)
    dsum = torch.empty_like(lse)
    for c0 in range(0, S, chunk):
        rows = cols[c0:c0 + chunk]
        s = torch.einsum("bqnh,bknh->bnqk", q64[:, rows], k64) * scale
        s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
        lse[:, :, rows] = torch.logsumexp(s, -1)
        o = torch.einsum("bnqk,bknh->bqnh", torch.exp(
            s - lse[:, :, rows, None]), v64)
        dsum[:, :, rows] = (do64[:, rows] * o).sum(-1).transpose(1, 2)
    # O and dQ on the query rows
    s = torch.einsum("bqnh,bknh->bnqk", q64[:, qrows], k64) * scale
    s = s.masked_fill(cols[None, :] > cols[qrows][:, None], -math.inf)
    pq = torch.exp(s - lse[:, :, qrows, None])
    o = torch.einsum("bnqk,bknh->bqnh", pq, v64)
    dp = torch.einsum("bqnh,bknh->bnqk", do64[:, qrows], v64)
    ds = pq * (dp - dsum[:, :, qrows, None])
    dq = torch.einsum("bnqk,bknh->bqnh", ds, k64) * scale
    # dK and dV on the key rows, summed over each KV head's query heads
    s = torch.einsum("bqnh,bknh->bnqk", q64, k64[:, krows]) * scale
    s = s.masked_fill(cols[krows][None, :] > cols[:, None], -math.inf)
    pk = torch.exp(s - lse[..., None])
    dv = torch.einsum("bnqk,bqnh->bknh", pk, do64)
    dp = torch.einsum("bqnh,bknh->bnqk", do64, v64[:, krows])
    ds = pk * (dp - dsum[..., None])
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q64) * scale
    fold = lambda t: t.reshape(B, t.shape[1], -1, rep, hd).sum(3)
    return o, dq, fold(dk), fold(dv)


def ring_fold_phase() -> dict:
    """Phase 16c: ring attention at full width in one process: seq
    16384, batch 1, SMOLLM3_3B_L8's heads (16 query, 4 KV, hd 128) in
    bf16, over ``RING["sp"]`` virtual ranks (S_local 4096).  Each rank's
    output is folded from every rank's K/V block in hop order through
    the module-level hops (``ring_attention.contiguous_hop`` /
    ``zigzag_hop``), then its backward runs, for the contiguous layout
    and for zigzag (shuffled in, unshuffled out).  The output and dq,
    dk, dv are held against the flash kernels on the whole sequence (at
    FA's limits) and against the exact f64 attention on slices of rows
    (``RING_ORACLE_TOL``); the merges are counted: the zigzag fold
    computes D + D(D - 1)/2 stripe-pair blocks of S_local² scores where
    the contiguous one computes D², D(D - 1)/2 of them fully masked."""
    S, D = RING["seq"], RING["sp"]
    cfg = T.SMOLLM3_3B_L8
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.resolved_head_dim)
    scale = hd ** -0.5
    Sl = S // D
    gen = torch.Generator(device="cuda").manual_seed(RING["seed"])
    mk = lambda n: torch.randn((1, S, n, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(nq), mk(nkv), mk(nkv), mk(nq)
    t0 = time.perf_counter()
    o_fa, lse = FA.flash_attention_fwd(q, k, v, scale)
    g_fa = FA.flash_attention_bwd(q, k, v, o_fa, lse, do, scale)
    qrows = torch.cat([torch.arange(Sl - 128, Sl + 128),
                       torch.arange(S - 128, S)]).cuda()
    krows = torch.cat([torch.arange(0, 128),
                       torch.arange(2 * Sl - 64, 2 * Sl + 64)]).cuda()
    orc = _rows_oracle(q, k, v, do, scale, qrows, krows)
    log(f"ring fold: FA on the whole sequence and the f64 oracle on "
        f"{len(qrows)} query rows and {len(krows)} key rows in "
        f"{time.perf_counter() - t0:.1f} s")
    readings, merges = {}, {}
    for layout in RA.LAYOUTS:
        t0 = time.perf_counter()
        zig = layout == "zigzag"
        shuf = (lambda t: PS.zigzag_shuffle(t, D)) if zig else (lambda t: t)
        unshuf = (lambda t: PS.zigzag_unshuffle(t, D)) if zig else (
            lambda t: t)
        qs, ks, vs = (shuf(t).detach().requires_grad_(True)
                      for t in (q, k, v))
        dos = shuf(do)
        RA.MERGES.reset()
        outs = []
        for r in range(D):
            qf = qs[:, r * Sl:(r + 1) * Sl].float()
            acc = RA.init_acc(qf, Sl // 2 if zig else Sl)
            for t in range(D):
                src = (r - t) % D
                kb, vb = (x[:, src * Sl:(src + 1) * Sl] for x in (ks, vs))
                acc = (RA.zigzag_hop(qf, kb, vb, src, r, D, acc, scale=scale)
                       if zig else RA.contiguous_hop(qf, kb, vb, src, r, acc,
                                                     scale=scale))
            out = RA.finish(acc, q.dtype)
            out.backward(dos[:, r * Sl:(r + 1) * Sl])
            outs.append(out.detach())
            del acc, out
        merges[layout] = RA.MERGES.read()
        got = [unshuf(torch.cat(outs, 1))] + [unshuf(x.grad)
                                              for x in (qs, ks, vs)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read = {}
        for i, name in enumerate(("O", "dq", "dk", "dv")):
            which = "fwd" if i == 0 else "bwd"
            fa_ref = o_fa if i == 0 else g_fa[i - 1]
            _, r_fa = _fa_reading(f"ring {layout}", f"{name} vs FA", got[i],
                                  fa_ref, which)
            rows = qrows if i < 2 else krows
            atol, rtol = RING_ORACLE_TOL
            ref = orc[i]
            r_or = gate_ratio(got[i][:, rows].double(), ref,
                              atol * float(ref.abs().max()), rtol)
            read[name] = (r_fa, r_or)
        readings[layout] = read
        log(f"ring fold {layout}: {wall:.1f} s (forward and backward, "
            f"{D} ranks); merges {json.dumps(merges[layout])}; gate ratios "
            f"(vs FA at FA's limits, vs the f64 oracle at "
            f"{RING_ORACLE_TOL} of each tensor's max) {json.dumps(read)}")
        del qs, ks, vs, dos, outs, got
        torch.cuda.empty_cache()
    block = nq * Sl * Sl
    c, z = merges["contiguous"], merges["zigzag"]
    log(f"ring fold: score elements computed, zigzag over contiguous "
        f"{z['scores'] / c['scores']:.4f}; over the contiguous merges not "
        f"fully masked {z['scores'] / (c['scores'] - c['masked'] * block):.4f}")
    del q, k, v, do, o_fa, lse, g_fa, orc
    torch.cuda.empty_cache()
    check(c["calls"] == D * D and c["masked"] == D * (D - 1) // 2
          and c["scores"] == D * D * block,
          f"ring fold contiguous merges {c}: expected {D * D} calls, "
          f"{D * (D - 1) // 2} masked")
    check(z["masked"] == 0 and z["scores"] == (D + D * (D - 1) // 2) * block,
          f"ring fold zigzag merges {z}: expected {D + D * (D - 1) // 2} "
          f"blocks of S_local^2 scores, none masked")
    for layout, read in readings.items():
        for name, (r_fa, r_or) in read.items():
            check(r_fa <= 1.0, f"ring {layout} {name}: gate ratio {r_fa:.3f} "
                  f"against the flash kernels above 1")
            check(r_or <= 1.0, f"ring {layout} {name}: gate ratio {r_or:.3f} "
                  f"against the f64 oracle above 1")
    return {"readings": readings, "merges": merges}


def _run_steps(step, shards, opt, batches, n, on_step=None):
    """``n`` steps of ``step``, each ending in a sync: (losses, host
    seconds a step, collectives a step)."""
    losses, times, colls = [], [], []
    for i, batch in zip(range(n), batches):
        C.COLLECTIVES.reset()
        t = time.perf_counter()
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
        colls.append(C.COLLECTIVES.read())
        if on_step is not None:
            on_step(i, losses[-1])
    return losses, times, colls


def _train_reading(label, card, losses, step_s, tokens, flops_tok, peak,
                   counts, want, colls, contract) -> dict:
    """Log one phase-16d leg and check it: launches exact, plain 0,
    collectives the contract's, losses finite and falling."""
    n = len(losses)
    ms = statistics.median(step_s[1:n - 1]) * 1e3
    tok_s = tokens / ms * 1e3
    log(f"{label} on {card}: losses {losses}; step times (s) {step_s}; "
        f"median of steps 1-{n - 2} {ms:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches (kernel, plain) "
        f"{json.dumps(counts)}, expected {json.dumps(want)}; collectives a "
        f"step {json.dumps(C.COLLECTIVES.nonzero(colls[-1]))}, the "
        f"contract's {json.dumps(C.COLLECTIVES.nonzero(contract))}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"{label}: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    for i, c in enumerate(colls):
        check(c == contract, f"{label}: step {i} collectives {c} != the "
              f"contract's {contract}")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"{label}: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return {"step_ms": ms, "tokens_per_s": tok_s,
            "mfu": flops_tok * tok_s / PEAK_BF16_FLOPS,
            "peak_gib": peak / 2 ** 30}


def tp_sp_train_phase(card: str) -> tuple[dict, dict]:
    """Phase 16d, ``TP_TRAIN["num_steps"]`` steps each on the one-rank
    group: ``train.train_tp.run`` at tp 1 (SMOLLM3_3B_L8, bf16, flash),
    ``train.train_sp.run`` at sp 1 with ``overlap="ring_fused_pallas"``
    (every projection through K7, attention the ring's own block), and
    ``expert.make_moe_lm_train_step(sp_axis=...)`` at dp 1 x sp 1 x ep 1
    on SMOLLM3_3B_L8_MOE at int8_pallas_bwd (K5, K4; the ring in place
    of the flash kernels).  Each: launches exact, plain calls 0, every
    step's collectives the contract's, losses finite and falling; step
    ms, tokens/s, MFU, peak memory.  Returns the readings and each
    leg's launches."""
    p = TP_TRAIN
    n, L = p["num_steps"], T.SMOLLM3_3B_L8.num_hidden_layers
    out, launches = {}, {}
    legs = {"tp": (train_tp, dict(attention="flash"),
                   {"flash_attention_fwd": (FA.FWD_COUNTS, 2 * L),
                    "flash_attention_bwd": (FA.BWD_COUNTS, L),
                    "ag_matmul": (C.COUNTS, 0)}),
            "sp": (train_sp, dict(overlap="ring_fused_pallas"),
                   {"ag_matmul": (C.COUNTS, 2 * 7 * L),
                    "flash_attention_fwd": (FA.FWD_COUNTS, 0)})}
    for mode, (twin, kw, expect) in legs.items():
        _reset_kernel_counts()
        torch.cuda.synchronize()
        res = twin.run(p["model"], second=1, seq=p["seq"],
                       batch_size=p["bs"], num_steps=n, device="cuda",
                       seed=p["seed"], log=log, **kw)
        torch.cuda.synchronize()
        counts = {k: (c.launches, c.plain_calls)
                  for k, (c, _) in expect.items()}
        steps = [b - a for a, b in zip([0.0] + res["step_times_s"][:-1],
                                       res["step_times_s"])]
        out[f"train_{mode}"] = _train_reading(
            f"train_{mode}", card, res["losses"], steps, p["seq"] * p["bs"],
            res["model_flops_per_token"], res["peak_memory_bytes"], counts,
            {k: n * per for k, (_, per) in expect.items()},
            res["collectives"], res["contract"])
        launches[f"train_{mode}"] = {k: c[0] for k, c in counts.items()}
    # dp x sp x ep
    axes = _tp_axes("dp", "sp", "ep")
    gen = torch.Generator(device="cuda").manual_seed(p["seed"])
    params = T.init_params(MOE_CFG, gen, "cuda")
    opt = fsdp.optim.adam_init(params)
    step = EX.make_moe_lm_train_step(params, MOE_CFG, dp_axis=axes["dp"],
                                     ep_axis=axes["ep"], sp_axis=axes["sp"])
    batches = ((torch.as_tensor(i, device="cuda"),
                torch.as_tensor(lb, device="cuda"))
               for i, lb in train_fsdp.fsdp_batches(
                   MOE_CFG.vocab_size, p["seq"], p["bs"], n, p["seed"]))
    exp_moe = _moe_expect(MOE_CFG)
    exp_moe["flash_attention_fwd"] = (FA.FWD_COUNTS, 0)
    exp_moe["flash_attention_bwd"] = (FA.BWD_COUNTS, 0)
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, colls = _run_steps(step, params, opt, batches, n)
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in exp_moe.items()}
    out["moe_sp"] = _train_reading(
        "moe dp x sp x ep", card, losses, step_s, p["seq"] * p["bs"],
        T.model_flops_per_token(MOE_CFG, p["seq"]),
        torch.cuda.max_memory_allocated(), counts,
        {k: n * per for k, (_, per) in exp_moe.items()}, colls,
        moe_step_collectives(params, remat=True, sp=1))
    launches["moe_sp"] = {k: c[0] for k, c in counts.items()}
    del params, opt, step
    torch.cuda.empty_cache()
    return out, launches



# ------------------------------------------------ phase 17: composable

def _phase_steps(res) -> list:
    t = res["step_times_s"]
    return [b - a for a, b in zip([0.0] + t[:-1], t)]


def composable_parity_phase() -> float:
    """Phase 17a: ``composable.make_dp_fsdp_tp_value_and_grad`` at dp 1
    x fsdp 1 x tp 1 on SMOLLM3_3B_L8 at int8_pallas_bwd (flash), seq
    8192, on phase 16b's shards and batch: the step-0 loss and every
    synced grad leaf bit-equal to ``tensor.tp_lm_loss``'s at dp 1 x tp 1
    (the TP step's grads, the all_reduces at one rank copies), both
    through K5, K4 and the flash kernels, launches exact.  Returns the
    step-0 loss."""
    p = TP_TRAIN
    cfg = TP_PARITY_CFG
    ax3 = _tp_axes("dp", "fsdp", "tp")
    ax2 = _tp_axes("dp", "tp")
    shards, batch = _prec_inputs(cfg, p["seed"], p["seq"], p["bs"],
                                 p["num_steps"])
    expect = _prec_expect(cfg.num_hidden_layers)
    vg3 = CP.make_dp_fsdp_tp_value_and_grad(
        shards, cfg, dp_axis=ax3["dp"], fsdp_axis=ax3["fsdp"],
        tp_axis=ax3["tp"])
    runs = {"3-axis": lambda: vg3(shards, batch),
            "tp": lambda: fsdp.microbatch_value_and_grad(
                lambda q, b: tensor.tp_lm_loss(q, b, cfg, axis=ax2["tp"]),
                shards, batch, 1)}
    out, counts = {}, {}
    for name, fn in runs.items():
        _reset_kernel_counts()
        loss, grads = fn()
        torch.cuda.synchronize()
        counts[name] = {k: (c.launches, c.plain_calls)
                        for k, (c, _) in expect.items()}
        out[name] = (float(loss), grads)
    (l3, g3), (lt, gt) = out["3-axis"], out["tp"]
    unequal = {"/".join(path): float((a.float() - fsdp.optim.tree_get(
        gt, path).float()).abs().max())
        for path, a in fsdp.optim.tree_leaves(g3)
        if not torch.equal(a, fsdp.optim.tree_get(gt, path))}
    want = {k: per for k, (_, per) in expect.items()}
    log(f"composable parity: the 3-axis step's loss {l3!r}, the TP "
        f"step's {lt!r} (bit-equal {l3 == lt}); grad leaves not bit-equal "
        f"{json.dumps(unequal)}; launches (kernel, plain) "
        f"{json.dumps(counts)}, expected {json.dumps(want)}")
    del out, g3, gt, shards
    torch.cuda.empty_cache()
    check(np.isfinite(l3) and l3 == lt, f"composable step-0 loss: 3-axis "
          f"{l3!r} != TP {lt!r}")
    check(not unequal, f"composable step-0 grads: {len(unequal)} leaves "
          f"not bit-equal to the TP step's: {unequal}")
    for k, c in counts.items():
        for name, (launches, plain) in c.items():
            check((launches, plain) == (want[name], 0),
                  f"composable step-0 {k}: {name} (launches, plain) "
                  f"{(launches, plain)} != ({want[name]}, 0)")
    return l3


def composable_train_phase(card: str, loss0: float) -> tuple[dict, dict]:
    """Phase 17a's steps: ``TP_TRAIN["num_steps"]`` steps of
    ``composable.make_dp_fsdp_tp_step`` at dp 1 x fsdp 1 x tp 1
    (int8_pallas_bwd, flash) on the seeded shards, one global batch a
    step: step 0's loss the parity's, launches exact, plain calls 0,
    every step's collectives the generated contract's
    (``analysis.contract_gen``), losses finite and falling; step ms,
    tokens/s, MFU, peak memory."""
    p = TP_TRAIN
    cfg, n = TP_PARITY_CFG, p["num_steps"]
    ax = _tp_axes("dp", "fsdp", "tp")
    gen = torch.Generator(device="cuda").manual_seed(p["seed"])
    shards = CP.shard_params_by_rules(T.init_params(cfg, gen, "cuda"),
                                      "composable_dp_fsdp_tp", ax)
    step = CP.make_dp_fsdp_tp_step(shards, cfg, dp_axis=ax["dp"],
                                   fsdp_axis=ax["fsdp"], tp_axis=ax["tp"])
    opt = fsdp.init_fsdp_opt_state(shards)
    contract = CG.generate_counts(
        "composable_dp_fsdp_tp", shards,
        CG.Ctx({"dp": 1, "fsdp": 1, "tp": 1}, remat=cfg.remat))
    batches = ((torch.as_tensor(i, device="cuda"),
                torch.as_tensor(lb, device="cuda"))
               for i, lb in train_fsdp.fsdp_batches(
                   cfg.vocab_size, p["seq"], p["bs"], n, p["seed"]))
    expect = _prec_expect(cfg.num_hidden_layers)
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, colls = _run_steps(step, shards, opt, batches, n)
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    reading = _train_reading(
        "composable step", card, losses, step_s, p["seq"] * p["bs"],
        T.model_flops_per_token(cfg, p["seq"]),
        torch.cuda.max_memory_allocated(), counts,
        {k: n * per for k, (_, per) in expect.items()}, colls, contract)
    check(losses[0] == loss0, f"composable step: step-0 loss {losses[0]!r} "
          f"is not the parity's {loss0!r} (same shards and batch)")
    del shards, opt, step
    torch.cuda.empty_cache()
    return reading, {k: c[0] for k, c in counts.items()}


def composable_twin_phase(card: str) -> tuple[dict, dict]:
    """Phase 17b: ``train.train_composable.run`` at ``--mesh
    dp1xw3named --overlap ring_fused_pallas`` (the FSDP replay: K7, the
    flash kernels) for ``FSDP_TRAIN["num_steps"]`` steps, its losses bit
    for bit ``train.train_fsdp.run``'s with the same flags, which runs
    next; the twin's launches exact, plain calls 0, every step's
    collectives the generated contract's, its rules verdict ok."""
    f = FSDP_TRAIN
    n, L = f["num_steps"], FSDP_CFG.num_hidden_layers
    expect = {"ag_matmul": (C.COUNTS, 2 * len(PROJECTIONS) * L),
              "flash_attention_fwd": (FA.FWD_COUNTS, 2 * L),
              "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    kw = dict(overlap=f["overlap"], seq=f["seq"], batch_size=f["bs"],
              num_steps=n, device="cuda", seed=f["seed"], log=log)
    _reset_kernel_counts()
    torch.cuda.synchronize()
    twin = train_composable.run("dp1xw3named", f["model"], **kw)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    reading = _train_reading(
        "composable twin", card, twin["losses"], _phase_steps(twin),
        f["seq"] * f["bs"], twin["model_flops_per_token"],
        twin["peak_memory_bytes"], counts,
        {k: n * per for k, (_, per) in expect.items()},
        twin["collectives"], twin["contract"])
    ref = train_fsdp.run(f["model"], **kw)
    log(f"composable twin: losses {twin['losses']}, train_fsdp's "
        f"{ref['losses']} (bit-equal {twin['losses'] == ref['losses']}); "
        f"strategy {twin['strategy']}, rules ok {twin['rules']['ok']} "
        f"({twin['rules']['checked']} leaves checked)")
    check(twin["losses"] == ref["losses"], f"composable twin: losses "
          f"{twin['losses']} != train_fsdp's {ref['losses']}")
    check(twin["strategy"] == "fsdp" and twin["rules"]["ok"],
          f"composable twin: strategy {twin['strategy']}, rules "
          f"{twin['rules']}")
    torch.cuda.empty_cache()
    return reading, {k: c[0] for k, c in counts.items()}


def auto_phase(card: str) -> tuple[dict, dict]:
    """Phase 17c: FSDP's auto variant (``fsdp.fully_shard_params``,
    ``make_fsdp_auto_train_step``) at one rank on SMOLLM3_3B_L8, bf16,
    flash, seq 8192: the step-0 loss and every grad leaf (its divide
    factor at one rank, 1) bit-equal to the explicit step's
    (``make_fsdp_value_and_grad``: the same ``lm_loss``, identity
    gathers) on the same params and batch, the flash kernels fed the
    plain tensors ``fully_shard`` gathers; then
    ``TP_TRAIN["num_steps"]`` steps: launches exact, plain calls 0, each
    step's shim calls the loss mean only (the library's gathers are its
    own), losses finite and falling; step ms, tokens/s, MFU, peak."""
    p, cfg = TP_TRAIN, FSDP_CFG
    n, L = p["num_steps"], cfg.num_hidden_layers
    mesh.init_process_group("cuda")
    gen = torch.Generator(device="cuda").manual_seed(p["seed"])
    full = T.init_params(cfg, gen, "cuda")
    expl = fsdp.shard_params_fsdp(fsdp.optim.tree_map(
        lambda x: x.clone(), full))
    module = fsdp.fully_shard_params(full, cfg)
    del full
    auto = fsdp.auto_shards(module)
    batches = [(torch.as_tensor(i, device="cuda"),
                torch.as_tensor(lb, device="cuda"))
               for i, lb in train_fsdp.fsdp_batches(
                   cfg.vocab_size, p["seq"], p["bs"], n, p["seed"])]
    expect = {"flash_attention_fwd": (FA.FWD_COUNTS, 2 * L),
              "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    out, counts = {}, {}
    for name, vg in (("auto", fsdp.make_fsdp_auto_value_and_grad(module)),
                     ("explicit", fsdp.make_fsdp_value_and_grad(expl, cfg))):
        _reset_kernel_counts()
        loss, grads = vg(auto if name == "auto" else expl, batches[0])
        torch.cuda.synchronize()
        counts[name] = {k: (c.launches, c.plain_calls)
                        for k, (c, _) in expect.items()}
        out[name] = (float(loss), grads)
    (la, ga), (le, ge) = out["auto"], out["explicit"]
    unequal = {"/".join(path): float((a.float() - fsdp.optim.tree_get(
        ge, path).float()).abs().max())
        for path, a in fsdp.optim.tree_leaves(ga)
        if not torch.equal(a, fsdp.optim.tree_get(ge, path))}
    log(f"auto step-0: loss {la!r}, the explicit step's {le!r} (bit-equal "
        f"{la == le}); grad leaves not bit-equal {json.dumps(unequal)}; "
        f"launches (kernel, plain) {json.dumps(counts)}")
    del out, ga, ge, expl
    torch.cuda.empty_cache()
    check(np.isfinite(la) and la == le, f"auto step-0 loss: {la!r} != "
          f"the explicit step's {le!r}")
    check(not unequal, f"auto step-0 grads: {len(unequal)} leaves not "
          f"bit-equal to the explicit step's: {unequal}")
    step = fsdp.make_fsdp_auto_train_step(module)
    opt = fsdp.init_fsdp_opt_state(auto)
    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, colls = _run_steps(step, auto, opt, iter(batches), n)
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    loss_mean = dict.fromkeys(C.CollectiveCounts.KINDS, 0)
    loss_mean["all_reduce"] = 1
    reading = _train_reading(
        "auto step", card, losses, step_s, p["seq"] * p["bs"],
        T.model_flops_per_token(cfg, p["seq"]),
        torch.cuda.max_memory_allocated(), counts,
        {k: n * per for k, (_, per) in expect.items()}, colls, loss_mean)
    check(losses[0] == la, f"auto step: step-0 loss {losses[0]!r} is not "
          f"the parity's {la!r}")
    del module, auto, opt, step
    gc.collect()   # fully_shard's module and state refer to each other
    torch.cuda.empty_cache()
    return reading, {k: c[0] for k, c in counts.items()}


# the laws only more than one rank shows, on two gloo ranks of the
# host's CPU (one card holds one NCCL rank): TINY_LM (2 layers, f32,
# remat), one global batch of 4 rows; each rank's synced grads against
# the one-process grads of the global mean loss, cut as the rules cut
# the params, at rtol = atol = COMPOSABLE_LAW_TOL (f32 sums in another
# order: the row-parallel partials, the gathers' reduce_scatters)
COMPOSABLE_LAW_TOL = 1e-5
LAW_WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import torch
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.parallel import composable as CP
from distributed_training_sandbox_tpu_torch.parallel import fsdp, optim
from distributed_training_sandbox_tpu_torch.utils import mesh

tol = float(sys.argv[2])
mesh.init_process_group("cpu")
r = mesh.axis_rank()
cfg = dataclasses.replace(T.TINY_LM, num_hidden_layers=2, remat=True)
params = T.init_params(cfg, torch.Generator().manual_seed(0))
ids = torch.randint(0, cfg.vocab_size, (4, 32),
                    generator=torch.Generator().manual_seed(1))
batch = (ids, ids.roll(-1, 1))
ref_loss, ref = fsdp.microbatch_value_and_grad(
    lambda p, b: T.lm_loss(p, b, cfg),
    optim.tree_map(lambda x: x.clone(), params), batch, 1)

def ratio(loss, grads, want):
    worst = abs(float(loss) - float(ref_loss)) / (tol + tol * abs(
        float(ref_loss)))
    for path, g in optim.tree_leaves(grads):
        w = optim.tree_get(want, path)
        worst = max(worst, float(((g - w).abs() / (tol + tol * w.abs())
                                  ).max()))
    return worst

out = {}
S = "composable_dp_fsdp_tp"
for name, sizes in (("t2", (1, 1, 2)), ("f2", (1, 2, 1))):
    try:
        ax = mesh.grid_axes(("dp", "fsdp", "tp"), sizes)
        shards = CP.shard_params_by_rules(params, S, ax)
        vg = CP.make_dp_fsdp_tp_value_and_grad(
            shards, cfg, dp_axis=ax["dp"], fsdp_axis=ax["fsdp"],
            tp_axis=ax["tp"])
        out[name] = ratio(*vg(shards, batch),
                          CP.shard_params_by_rules(ref, S, ax))
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
try:
    module = fsdp.fully_shard_params(params, cfg)
    vg = fsdp.make_fsdp_auto_value_and_grad(module)
    out["auto"] = ratio(*vg(fsdp.auto_shards(module), batch),
                        fsdp.shard_params_fsdp(ref))
except Exception as e:
    out["auto"] = f"{type(e).__name__}: {e}"
(Path(sys.argv[1]) / f"law{r}.json").write_text(json.dumps(out))
mesh.destroy_process_group()
"""


def composable_law_phase() -> dict:
    """Phase 17d: the laws at two ranks, on two gloo ranks of the host's
    CPU (``LAW_WORKER``): the 3-axis step's loss and synced grads at dp
    1 x fsdp 1 x tp 2 (``composable law t2``: the tp-replicated leaves'
    grads summed over tp) and at 1 x 2 x 1 (``composable law f2``: the
    gathers' reduce_scatters over fsdp), and the auto variant's at two
    ranks (``auto law``: ``fully_shard``'s sum divided by the ranks),
    each against the one-process grads of the global mean loss within
    ``COMPOSABLE_LAW_TOL``.  The processes are stopped on return."""
    import os
    import tempfile
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as work:
        env = {**os.environ, "PYTHONPATH": str(here), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(mesh.free_port()), "OMP_NUM_THREADS": "2",
               "CUDA_VISIBLE_DEVICES": ""}
        procs = [subprocess.Popen(
            [sys.executable, "-c", LAW_WORKER, work,
             str(COMPOSABLE_LAW_TOL)], cwd=here,
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"composable law: rank {r} exited "
                  f"{p.returncode}: {o[-2000:]}")
        ranks = [json.loads((Path(work) / f"law{r}.json").read_text())
                 for r in range(2)]
    res = {k: [rk[k] for rk in ranks] for k in ranks[0]}
    log(f"composable law (2 gloo ranks, TINY_LM f32): worst |Δ| / (atol + "
        f"rtol |want|) at {COMPOSABLE_LAW_TOL} a rank {json.dumps(res)}")
    for key, gate in (("t2", "composable law t2"),
                      ("f2", "composable law f2"), ("auto", "auto law")):
        vals = res[key]
        check(all(isinstance(v, float) and v <= 1.0 for v in vals),
              f"{gate}: {vals}")
    return res

# ------------------------------------------- phase 18: the serving frontier

def frontier_trace():
    """Phase 18a's trace: ``FRONTIER["tenants"]`` tenants, each with a
    ``sys_len``-token system prompt (32 full pages), and
    ``FRONTIER["requests"]`` requests alternating between them, each the
    tenant's system prompt and a private suffix of ``suffix`` tokens.
    Returns the prompts (request i belongs to tenant i % tenants)."""
    rng = np.random.default_rng(SEED + 18)
    heads = [rng.integers(1, CFG.vocab_size, size=FRONTIER["sys_len"])
             .astype(np.int32) for _ in range(FRONTIER["tenants"])]
    lo, hi = FRONTIER["suffix"]
    return [np.concatenate([heads[i % FRONTIER["tenants"]], rng.integers(
        1, CFG.vocab_size, size=int(rng.integers(lo, hi + 1))).astype(
            np.int32)]) for i in range(FRONTIER["requests"])]


def _serve(eng, prompts):
    new = NEW_TOKENS
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    for r in reqs:
        check(len(r.tokens) == new and all(0 <= t < CFG.vocab_size
                                           for t in r.tokens),
              f"frontier request {r.rid}: {len(r.tokens)} tokens, or one "
              f"out of the vocabulary")
    return reqs


def near_argmax_law(label, params, reqs, eng, kv_quant=False) -> dict:
    """The near-argmax law: every request's prompt and emitted tokens
    teacher-forced through ``generate``'s cached forward
    (``serve_bench.argmax_gaps``); every emitted token's logit within
    ``FRONTIER_ARGMAX_ATOL`` of its row's maximum.  Logged: the largest
    gap and how many tokens are the exact argmax."""
    gaps = torch.cat([serve_bench.argmax_gaps(
        params, eng.cfg, r.prompt, r.tokens, capacity=eng.view_capacity,
        kv_quant=kv_quant).cpu() for r in reqs])
    read = {"tokens": int(gaps.numel()), "argmax": int((gaps == 0).sum()),
            "max_gap": float(gaps.max()),
            "gaps_over_0.25": int((gaps > 0.25).sum())}
    log(f"{label} near-argmax law: {json.dumps(read)} (limit "
        f"{FRONTIER_ARGMAX_ATOL})")
    check(torch.isfinite(gaps).all() and read["max_gap"]
          <= FRONTIER_ARGMAX_ATOL,
          f"{label} near-argmax: an emitted token's logit lies "
          f"{read['max_gap']} under its row's maximum, over "
          f"{FRONTIER_ARGMAX_ATOL}")
    return read


def _pool_tensors_of(eng):
    pools = [eng.pool] + ([eng.draft_pool] if eng.draft_pool else [])
    return [t for p in pools for t in _pool_tensors(p)]


@contextlib.contextmanager
def _written_pages():
    """Every page a ``_paged_forward`` in the block writes a valid row
    into (both pools; the positions' pages read from the page tables),
    gathered on the device and read once at the end."""
    seen = []
    fwd = E._paged_forward

    def watch(params, ids, cfg, bufs, pages, apos, valid, **kw):
        pi = (apos // bufs.k[0].shape[1]).clamp(0, pages.shape[1] - 1)
        seen.append(torch.where(valid, torch.gather(pages, 1, pi.long()),
                                0).flatten())
        return fwd(params, ids, cfg, bufs, pages, apos, valid, **kw)

    out = set()
    E._paged_forward = watch
    try:
        yield out
    finally:
        E._paged_forward = fwd
        if seen:
            out.update(torch.cat(seen).unique().tolist())
        out.discard(0)


def allocator_law(label, eng) -> None:
    """With no request resident, every usable page is free or the
    trie's: free + cached = n_pages - 1."""
    a, c = eng.pool.allocator.free_pages, eng.prefix_cache.cached_pages
    check(not eng.batcher.has_work() and a + c == eng.n_pages - 1,
          f"{label} allocator law: {a} free + {c} cached != "
          f"{eng.n_pages - 1} usable pages")


def cow_law(label, eng, cached, snap, written) -> dict:
    """Copy-on-write: no write of the block landed on a cached page, and
    every cached page's K and V (and an int8 pool's scales; the draft's
    pool too) in every layer is bit-equal to its snapshot."""
    hit = sorted(set(cached) & written)
    now = [t[cached] for t in _pool_tensors_of(eng)]
    same = all(torch.equal(a, b) for a, b in zip(now, snap))
    log(f"{label} CoW law: {len(cached)} cached pages, {len(written)} "
        f"pages written, {len(hit)} of them cached; bytes "
        f"{'equal' if same else 'CHANGED'}")
    check(not hit and same,
          f"{label} CoW law: writes on cached pages {hit[:8]}, bytes "
          f"{'equal' if same else 'changed'}")
    return {"cached": len(cached), "written": len(written)}


def _snapshot(eng):
    cached = sorted(n.page for n in eng.prefix_cache._nodes)
    return cached, [t[cached].clone() for t in _pool_tensors_of(eng)]


def _p50(reqs, attr):
    return float(np.percentile([getattr(r, attr) for r in reqs], 50)) * 1e3


def prefix_phase(params, card: str) -> tuple[dict, dict]:
    """18a: the prefix cache on ``ENGINE``.  One request per tenant is
    served first, then the other six: their 32 system-prompt pages come
    from the trie.  Gates: hit and lookup pages, prefill chunks and K3's
    and K1's launches exactly as the suffixes predict, plain calls 0, the
    CoW and allocator laws, the near-argmax law.  Then the six again
    through an engine without the cache, for their TTFT."""
    prompts = frontier_trace()
    page, Ck, L = ENGINE["page_size"], ENGINE["prefill_chunk"], \
        CFG.num_hidden_layers
    first = list(FRONTIER["first"])
    rest = [i for i in range(len(prompts)) if i not in first]
    eng = E.ServingEngine(params, CFG, prefix_cache=True, **ENGINE)
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    reqs = _serve(eng, [prompts[i] for i in first])
    allocator_law("frontier cache run 1", eng)
    cached, snap = _snapshot(eng)
    with _written_pages() as written:
        reqs += _serve(eng, [prompts[i] for i in rest])
    counts = {"paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
              "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls)}
    cow = cow_law("frontier cache", eng, cached, snap, written)
    allocator_law("frontier cache run 2", eng)
    st = eng.prefix_cache.stats()
    sys_pages = FRONTIER["sys_len"] // page
    want_hits = len(rest) * sys_pages
    want_lookup = sum((len(p) - 1) // page for p in prompts)
    # batched prefill: every resident advances a chunk a step, so a run
    # takes as many chunks as its longest uncached part
    want_chunks = (max(-(-len(prompts[i]) // Ck) for i in first)
                   + max(-(-(len(prompts[i]) - FRONTIER["sys_len"]) // Ck)
                         for i in rest))
    steps = eng.stats["decode_steps"]
    chunks = eng.stats["prefill_chunks"]
    log(f"frontier cache on {card}: trie {json.dumps(st)}; {chunks} prefill "
        f"chunks (predicted {want_chunks}), {steps} decode steps; (launches, "
        f"plain) {json.dumps(counts)}")
    check(st["hit_pages"] == want_hits and st["lookup_pages"] == want_lookup,
          f"frontier cache: hit / lookup pages {st['hit_pages']} / "
          f"{st['lookup_pages']} != {want_hits} / {want_lookup}")
    check(chunks == want_chunks,
          f"frontier cache prefix chunks: {chunks} prefill chunks, the "
          f"suffixes predict {want_chunks}")
    check(counts["flash_prefill"] == (chunks * L, 0),
          f"frontier cache: flash_prefill (launches, plain) "
          f"{counts['flash_prefill']} != ({chunks} x {L}, 0)")
    check(counts["paged_decode"] == (steps * L, 0),
          f"frontier cache: paged_decode (launches, plain) "
          f"{counts['paged_decode']} != ({steps} x {L}, 0)")
    law = near_argmax_law("frontier cache", params, reqs, eng)
    hits = reqs[len(first):]
    ttft = _p50(hits, "ttft_s")
    del eng
    plain = E.ServingEngine(params, CFG, **ENGINE)
    again = _serve(plain, [prompts[i] for i in rest])
    ttft_plain = _p50(again, "ttft_s")
    del plain
    torch.cuda.empty_cache()
    log(f"frontier cache on {card}: the six hit requests' TTFT p50 "
        f"{ttft} ms with the cache, {ttft_plain} ms without (ratio "
        f"{ttft / ttft_plain:.4f})")
    read = {"trie": st, "prefill_chunks": chunks, "decode_steps": steps,
            "ttft_p50_ms": ttft, "ttft_p50_uncached_ms": ttft_plain,
            "cow": cow, "near_argmax": law}
    return read, {k: v[0] for k, v in counts.items()}


@contextlib.contextmanager
def _no_host_sync():
    """The speculative chain's device functions (each draft step, the
    verify, the accept) run under ``torch.cuda`` sync-debug mode
    ``warn``: a synchronising operation inside them is recorded."""
    caught = []
    saved = {n: getattr(E, n) for n in ("_decode_core", "_spec_verify_core",
                                        "_spec_accept_core")}

    def guard(fn):
        def run(*a, **kw):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                    # the mode's own notice ("a prototype feature") is
                    # not a sync
                    caught.extend(str(x.message) for x in w if
                                  "called a synchronizing" in str(x.message))
        return run

    for n, fn in saved.items():
        setattr(E, n, guard(fn))
    try:
        yield caught
    finally:
        for n, fn in saved.items():
            setattr(E, n, fn)


def spec_phase(params, prompts, vanilla: dict, card: str) -> tuple[dict,
                                                                 dict]:
    """18b: speculative decoding (``SPEC_K``) on the serve phase's
    requests at each of ``SPEC_DRAFT_LAYERS``: K1 launches = draft steps x
    draft layers, K3 launches = prefill chunks x (36 + draft layers) +
    verify steps x 36, plain calls 0; one host sync a burst (the pump's,
    at its last macro-step) and none inside the chain; the near-argmax
    law; at 36 layers (the draft is the target) fewer steps than tokens
    and the acceptance over ``ACCEPT_RATE_MIN``; at 4, rollbacks."""
    L = CFG.num_hidden_layers
    reads, launches = {}, {}
    for dl in SPEC_DRAFT_LAYERS:
        label = f"frontier spec {dl}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = E.ServingEngine(params, CFG, spec_k=SPEC_K, draft_layers=dl,
                              **ENGINE)
        bursts = []
        burst = eng._spec_burst
        eng._spec_burst = lambda *a: (bursts.append(1), burst(*a))[1]
        eng.start()
        pump = eng._pump
        PA.COUNTS.reset()
        FP.COUNTS.reset()
        with _no_host_sync() as synced:
            reqs = _serve(eng, prompts)
        counts = {"paged_decode": (PA.COUNTS.launches,
                                   PA.COUNTS.plain_calls),
                  "flash_prefill": (FP.COUNTS.launches,
                                    FP.COUNTS.plain_calls)}
        st, slo = eng.stats, eng.slo_report()
        sp, sch = slo["speculative"], slo["scheduler"]
        # the engine's own peak with the (already resident) weights: the
        # prediction prices the draft's weights as resident, though a
        # truncated draft is views of the target's
        gib = 2 ** 30
        peak = (torch.cuda.max_memory_allocated() - base
                + tree_bytes(params)) / gib
        draft_gib = tree_bytes(eng._draft_params) / gib
        log(f"{label} memory: peak {peak:.3f} GiB with the weights, "
            f"predicted {slo['pool']['predicted_gb']:.3f} GiB, of which "
            f"the draft's weights (views) {draft_gib:.3f} GiB")
        want = {"paged_decode": (st["draft_steps"] * dl, 0),
                "flash_prefill": (st["prefill_chunks"] * (L + dl)
                                  + st["decode_steps"] * L, 0)}
        log(f"{label} on {card}: {json.dumps(sp)}; {st['decode_steps']} "
            f"verify steps, {st['prefill_chunks']} prefill chunks, "
            f"{len(bursts)} bursts, pump syncs "
            f"{json.dumps(pump.sync_breakdown)}, syncs inside the chain "
            f"{len(synced)} {synced[:3]}; (launches, plain) "
            f"{json.dumps(counts)}, expected {json.dumps(want)}")
        log(f"{label} on {card}: per-token p50 {slo['per_token_ms']['p50']} "
            f"ms, {slo['tokens_per_s']} tok/s, acceptance "
            f"{sp['acceptance_rate']}, {sch['decode_steps_per_token']} "
            f"steps a token, TTFT p50 {slo['ttft_ms']['p50']} ms; phase 3's "
            f"vanilla serve: per-token p50 {vanilla['per_token_ms']['p50']} "
            f"ms, {vanilla['tokens_per_s']} tok/s, "
            f"{vanilla['scheduler']['decode_steps_per_token']} steps a token")
        for k in want:
            check(counts[k] == want[k],
                  f"{label}: {k} (launches, plain) {counts[k]} != {want[k]}")
        check(not synced and pump.sync_breakdown.get("sync_every") ==
              len(bursts) and "throttle" not in pump.sync_breakdown,
              f"{label} sync law: {len(synced)} syncs inside the chain, pump "
              f"syncs {pump.sync_breakdown} over {len(bursts)} bursts")
        law = near_argmax_law(label, params, reqs, eng)
        if dl == L:
            check(sch["decode_steps_per_token"] < 1.0
                  and sp["acceptance_rate"] > ACCEPT_RATE_MIN,
                  f"{label} acceptance: {sp['acceptance_rate']} (limit "
                  f"{ACCEPT_RATE_MIN}), {sch['decode_steps_per_token']} "
                  f"steps a token")
        else:
            check(sp["proposed"] > sp["accepted"],
                  f"{label}: no rollback ({sp['accepted']} of "
                  f"{sp['proposed']} accepted)")
        reads[dl] = {"speculative": sp, "scheduler": sch,
                     "per_token_p50_ms": slo["per_token_ms"]["p50"],
                     "tokens_per_s": slo["tokens_per_s"],
                     "ttft_p50_ms": slo["ttft_ms"]["p50"],
                     "bursts": len(bursts), "near_argmax": law,
                     "peak_gib": peak, "draft_weights_gib": draft_gib,
                     "predicted_gib": slo["pool"]["predicted_gb"]}
        launches[label] = {k: v[0] for k, v in counts.items()}
        del eng._spec_burst   # the counting wrapper holds the engine
        del eng
        torch.cuda.empty_cache()
    return reads, launches


def int8_frontier_phase(params_q8, card: str) -> tuple[dict, dict]:
    """18c: ``INT8_ENGINE`` with the prefix cache and ``SPEC_K`` at 4
    draft layers on 18a's trace: the first four requests (two a tenant,
    prefilled together: the later finisher swaps to its twin's pages),
    then the other four on the cached system prompts.  K2 = draft steps x
    4, K4 exact, plain calls 0; the allocator and CoW laws (the int8
    pools and their scales, the draft's too); the near-argmax law through
    the int8 ``generate``."""
    prompts = frontier_trace()
    page, L, dl = ENGINE["page_size"], CFG.num_hidden_layers, 4
    eng = E.ServingEngine(params_q8, CFG, prefix_cache=True, spec_k=SPEC_K,
                          draft_layers=dl, **INT8_ENGINE)
    counters = (PA.Q8_COUNTS, Q.INT8_COUNTS, PA.COUNTS, FP.COUNTS)
    for c in counters:
        c.reset()
    half = len(prompts) // 2
    reqs = _serve(eng, prompts[:half])
    allocator_law("int8 frontier run 1", eng)
    inserted = eng.prefix_cache.inserted_pages
    twins = half - FRONTIER["tenants"]
    want_ins = (sum((len(p) - 1) // page for p in prompts[:half])
                - twins * (FRONTIER["sys_len"] // page))
    cached, snap = _snapshot(eng)
    with _written_pages() as written:
        reqs += _serve(eng, prompts[half:])
    counts = {"paged_decode_q8": (PA.Q8_COUNTS.launches,
                                  PA.Q8_COUNTS.plain_calls),
              "int8_matmul": (Q.INT8_COUNTS.launches,
                              Q.INT8_COUNTS.plain_calls),
              "paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
              "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls)}
    cow = cow_law("int8 frontier", eng, cached, snap, written)
    allocator_law("int8 frontier run 2", eng)
    st, slo = eng.stats, eng.slo_report()
    P7 = len(PROJECTIONS)
    chunks, verifies, drafts = (st["prefill_chunks"], st["decode_steps"],
                                st["draft_steps"])
    want = {"paged_decode_q8": (drafts * dl, 0),
            "int8_matmul": ((chunks + verifies) * (P7 * L + 1)
                            + (chunks + drafts) * (P7 * dl + 1), 0),
            "paged_decode": (0, 0), "flash_prefill": (0, 0)}
    trie = eng.prefix_cache.stats()
    log(f"int8 frontier on {card}: trie {json.dumps(trie)} (run 1 inserted "
        f"{inserted}, predicted {want_ins} with {twins} twins swapped); "
        f"{json.dumps(slo['speculative'])}; {chunks} prefill chunks, "
        f"{verifies} verify steps; (launches, plain) {json.dumps(counts)}, "
        f"expected {json.dumps(want)}")
    log(f"int8 frontier on {card}: per-token p50 "
        f"{slo['per_token_ms']['p50']} ms, TTFT p50 {slo['ttft_ms']['p50']}"
        f" ms, {slo['tokens_per_s']} tok/s, peak pool util "
        f"{slo['pool']['peak_util']}")
    for k in want:
        check(counts[k] == want[k],
              f"int8 frontier: {k} (launches, plain) {counts[k]} != {want[k]}")
    check(inserted == want_ins and trie["hit_pages"] == (
        len(prompts) - half) * (FRONTIER["sys_len"] // page),
          f"int8 frontier: run 1 inserted {inserted} pages (predicted "
          f"{want_ins}); {trie['hit_pages']} hit pages")
    law = near_argmax_law("int8 frontier", params_q8, reqs, eng,
                          kv_quant=True)
    read = {"trie": trie, "speculative": slo["speculative"],
            "per_token_p50_ms": slo["per_token_ms"]["p50"],
            "ttft_p50_ms": slo["ttft_ms"]["p50"],
            "tokens_per_s": slo["tokens_per_s"], "cow": cow,
            "near_argmax": law}
    del eng
    torch.cuda.empty_cache()
    return read, {k: v[0] for k, v in counts.items() if v[0]}


def twin_phase(card: str) -> tuple[dict, dict]:
    """18d: one run of the serve bench twin at SmolLM3-3B (``TWIN_ARGS``):
    exit 0 (its own gates: every request completed, the first tokens and
    the near-argmax law against ``generate``), and its ``serving`` block
    with the reference's keys (``SERVING_KEYS``)."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="serve_twin_"))
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    try:
        rc = serve_bench.main([*TWIN_ARGS, "--results-dir", str(out)])
        torch.cuda.synchronize()
        counts = {"paged_decode": PA.COUNTS.launches,
                  "flash_prefill": FP.COUNTS.launches}
        runs = [p for p in out.iterdir() if p.is_dir()]
        serving = json.loads((runs[0] / "summary.json").read_text()).get(
            "serving", {}) if len(runs) == 1 else {}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    missing = [k for k, sub in SERVING_KEYS.items() if k not in serving or (
        sub is not None and not set(sub) <= set(serving[k]))]
    shown = ("completed", "ttft_ms", "per_token_ms", "tokens_per_s",
             "prefix_cache", "speculative", "parity", "failures")
    log(f"serve twin on {card}: rc {rc}, launches {json.dumps(counts)}, "
        f"serving {json.dumps({k: serving.get(k) for k in shown})}")
    check(rc == 0 and not missing,
          f"serve twin: exit {rc}; serving keys missing {missing}")
    return serving, counts


def frontier_phase(params, params_q8, serve_prompts, vanilla, card):
    """Phase 18 (the serving frontier): 18a-18d.  Returns the readings
    and each path's launches."""
    t18 = time.perf_counter()
    a, la = prefix_phase(params, card)
    b, lb = spec_phase(params, serve_prompts, vanilla, card)
    c, lc = int8_frontier_phase(params_q8, card)
    d, ld = twin_phase(card)
    wall = time.perf_counter() - t18
    log(f"phase 18 (the serving frontier): {wall:.1f} s")
    return ({"cache": a, "spec": b, "int8": c, "twin": d, "wall_s": wall},
            {"frontier cache": la, **lb, "int8 frontier": lc,
             "serve twin": ld})


# ------------------- phase 19: the fleet, TP, disaggregation, MoE serve

def fleet_trace(n=None):
    """Phase 19's prompts: phase 18d's tenant trace (``TWIN_ARGS``: two
    tenants' 16-token system prompts, prompts capped by the twin's 80
    positions), ``n`` requests."""
    rng = np.random.default_rng(SEED)
    return [p for _, p, _ in build_trace(
        rng, n or FLEET["requests"], 16.0, CFG.vocab_size,
        FLEET["max_seq_len"], tenants=FLEET["tenants"], overlap_frac=0.6)]


def _reset_serve_counts():
    for c in (PA.COUNTS, PA.Q8_COUNTS, FP.COUNTS, Q.INT8_COUNTS):
        c.reset()


def _serve_launches(label, engines, L, *, q8=False, int8_w=0) -> dict:
    """The launches and plain calls since the last reset against what the
    engines' dispatched decode steps and prefill chunks predict: K1 (K2
    on an int8 pool) a layer a step, K3 a layer a chunk (none on an int8
    pool: its prefill gathers), K4 ``int8_w`` a step and a chunk; plain
    calls 0.  Returns each kernel's launches."""
    steps = sum(e.stats["decode_steps"] for e in engines)
    chunks = sum(e.stats["prefill_chunks"] for e in engines)
    got = {"paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
           "paged_decode_q8": (PA.Q8_COUNTS.launches,
                               PA.Q8_COUNTS.plain_calls),
           "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls),
           "int8_matmul": (Q.INT8_COUNTS.launches,
                           Q.INT8_COUNTS.plain_calls)}
    want = {"paged_decode": (0 if q8 else steps * L, 0),
            "paged_decode_q8": (steps * L if q8 else 0, 0),
            "flash_prefill": (0 if q8 else chunks * L, 0),
            "int8_matmul": ((steps + chunks) * int8_w, 0)}
    log(f"{label} launches (kernel, plain): {json.dumps(got)} for {steps} "
        f"decode steps and {chunks} prefill chunks")
    check(got == want, f"{label} launches: {json.dumps(got)} != "
          f"{json.dumps(want)}")
    return {k: v[0] for k, v in got.items() if v[0]}


def _fleet_run(params, prompts, **kw):
    """Two replicas of ``CFG`` on cuda:0 with ``ENGINE``'s flags, every
    prompt submitted at virtual time 0 with ``NEW_TOKENS`` new and
    driven to the end; the kernels' counts are reset just before the
    run."""
    fleet = Fleet(params, CFG, replicas=2, device="cuda:0", **kw, **ENGINE)
    reqs = [fleet.submit(p, max_new_tokens=NEW_TOKENS, arrival_s=0.0)
            for p in prompts]
    torch.cuda.synchronize()
    _reset_serve_counts()
    t = time.perf_counter()
    fleet.run()
    torch.cuda.synchronize()
    return fleet, reqs, time.perf_counter() - t


def _fleet_reading(fleet, reqs, wall) -> dict:
    slo = fleet.slo_report()
    toks = sum(len(r.tokens) for r in reqs)
    return {"wall_s": wall, "tokens_per_s": toks / wall,
            "ttft_ms": slo["ttft_ms"], "per_token_ms": slo["per_token_ms"],
            "events": [e["event"] for e in slo["events"]],
            "bursts": [r.bursts for r in fleet.replicas]}


def failover_phase(params, card: str) -> tuple[dict, dict]:
    """19a: two replicas on cuda:0 serve ``fleet_trace`` undisturbed,
    then with ``kill_replica@1:1``, then with ``hang_decode@1:0`` under
    a ``FLEET["watchdog_s"]`` watchdog.  Gates: zero dropped, one
    ``replica_dead`` event with the fault's trigger, the survivor's pool
    empty at the end, launches exact over both replicas' dispatched
    steps (the victim's included), plain calls 0, the hang bounded, and
    every request's tokens bit-equal to the undisturbed fleet's."""
    prompts, L = fleet_trace(), CFG.num_hidden_layers
    base, breqs, wall = _fleet_run(params, prompts, watchdog_timeout_s=0.0)
    check(base.dropped() == [] and not base.events,
          f"fleet undisturbed: dropped {base.dropped()}, events "
          f"{base.events}")
    launches = _serve_launches("fleet undisturbed",
                               [r.engine for r in base.replicas], L)
    want = {r.rid: list(r.tokens) for r in breqs}
    out = {"undisturbed": _fleet_reading(base, breqs, wall)}
    del base
    for label, fault, trigger, victim, wd in (
            ("kill", "kill_replica@1:1", "WorkerLost", 1, 0.0),
            ("hang", "hang_decode@1:0", "StepTimeoutError", 0,
             FLEET["watchdog_s"])):
        fleet, reqs, wall = _fleet_run(params, prompts,
                                       watchdog_timeout_s=wd, fault=fault)
        dead = [e for e in fleet.events if e["event"] == "replica_dead"]
        survivor = fleet.replicas[1 - victim].engine
        check(fleet.dropped() == [],
              f"fleet {label}: dropped {fleet.dropped()}")
        check(len(dead) == 1 and dead[0]["replica"] == victim
              and dead[0]["trigger"] == trigger,
              f"fleet {label}: replica_dead events {dead}")
        check(survivor.pool.allocator.free_pages == survivor.n_pages - 1,
              f"fleet {label}: the survivor's pool holds "
              f"{survivor.pool.allocator.pages_in_use} pages at the end")
        got = _serve_launches(f"fleet {label}",
                              [r.engine for r in fleet.replicas], L)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if label == "hang":
            check(wall < wd + FLEET["hang_slack_s"],
                  f"fleet hang: {wall:.1f} s, over the watchdog's {wd} s "
                  f"+ {FLEET['hang_slack_s']} s")
        diff = [r.rid for r in reqs if list(r.tokens) != want[r.rid]]
        check(not diff, f"fleet {label} tokens: requests {diff} are not "
              f"bit-equal to the undisturbed fleet's")
        out[label] = {**_fleet_reading(fleet, reqs, wall),
                      "requeued": dead[0]["requeued"] if dead else None}
        del fleet
    log(f"fleet failover on {card}: {json.dumps(out)}")
    return out, launches


def shed_phase(params, card: str) -> tuple[dict, dict]:
    """19b: one replica, a ``SHED["max_queue"]``-deep modeled queue, a
    frozen prior, ``SHED["requests"]`` arrivals at virtual time 0, the
    odd ones with a deadline.  Gates: the shed set and every
    ``Rejection`` record equal to the port's router replayed on the host
    over the same arrivals, both reasons shed, every admitted request
    completed."""
    prompts = fleet_trace(SHED["requests"])
    dl = [SHED["deadline_s"] if i % 2 else None for i in range(len(prompts))]
    kw = dict(max_queue=SHED["max_queue"], calibrate=False)
    fleet = Fleet(params, CFG, replicas=1, device="cuda:0",
                  watchdog_timeout_s=0.0, burst_s_prior=SHED["burst_s"],
                  max_queue=kw["max_queue"], calibrate_admission=False,
                  **ENGINE)
    out = [fleet.submit(p, max_new_tokens=SHED["new"], arrival_s=0.0,
                        deadline_s=d) for p, d in zip(prompts, dl)]
    router = Router(AdmissionController(
        ENGINE["max_batch"], burst_s=SHED["burst_s"],
        steps_per_burst=ENGINE["sync_every"], **kw))
    for i, (p, d) in enumerate(zip(prompts, dl)):
        router.submit(Request(rid=i, prompt=p, max_new_tokens=SHED["new"],
                              arrival_s=0.0), d)
    shed = [r.as_dict() for r in out if isinstance(r, Rejection)]
    check(shed == [r.as_dict() for r in router.rejections],
          f"fleet shed: {shed} != the host router's "
          f"{[r.as_dict() for r in router.rejections]}")
    reasons = sorted({r["reason"] for r in shed})
    check(reasons == ["deadline", "queue_full"],
          f"fleet shed: reasons {reasons}, not both")
    admitted = [r for r in out if isinstance(r, Request)]
    torch.cuda.synchronize()
    _reset_serve_counts()
    t = time.perf_counter()
    fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(fleet.dropped() == [] and all(
        len(r.tokens) == SHED["new"] for r in admitted),
        f"fleet shed: dropped {fleet.dropped()}")
    launches = _serve_launches("fleet shed", [fleet.replicas[0].engine],
                               CFG.num_hidden_layers)
    read = {"admitted": len(admitted), "shed": len(shed),
            "reasons": {x: sum(r["reason"] == x for r in shed)
                        for x in reasons}, "wall_s": wall}
    log(f"fleet shed on {card}: {json.dumps(read)}")
    return read, launches


def _weights_law(label, params_by_tag, cfg, reqs, capacity) -> dict:
    """The old-or-new law: each request's tokens keep the near-argmax law
    (``FRONTIER_ARGMAX_ATOL``) against ``generate`` on exactly one of the
    weight sets.  Returns rid -> that set's tag."""
    on = {}
    for r in reqs:
        gaps = {tag: float(serve_bench.argmax_gaps(
            p, cfg, r.prompt, r.tokens, capacity=capacity).max())
            for tag, p in params_by_tag.items()}
        held = [t for t, g in gaps.items() if g <= FRONTIER_ARGMAX_ATOL]
        check(len(held) == 1, f"{label} old-or-new: request {r.rid}'s "
              f"largest gaps {json.dumps(gaps)} hold the law on {held}")
        on[r.rid] = held[0] if len(held) == 1 else None
    return on


def swap_phase(card: str) -> tuple[dict, dict]:
    """19c: two replicas of ``SWAP_CFG`` (full width, 8 layers) with
    ``SWAP["max_batch"]`` slots each serve ``fleet_trace``; new weights
    (x3, another seed) saved with the port's ``Checkpointer`` are
    hot-swapped in after ``SWAP["after"]`` completions, with requests in
    flight; ``SWAP["wave2"]`` more requests arrive after the swap ended.
    Gates: the swap's events, zero dropped, launches exact, the
    old-or-new law (each request wholly on one weight set), the later
    wave on the new weights.
    Then ``corrupt_swap``: the fleet keeps the old weights (the law on
    every request), prints its warning, drops nothing."""
    import tempfile
    L = SWAP_CFG.num_hidden_layers
    old = serve_bench.build_params(SWAP_CFG, SEED, PARAM_SCALE, "cuda")
    new = serve_bench.build_params(SWAP_CFG, SWAP["seed"], PARAM_SCALE,
                                   "cuda")
    root = Path(tempfile.mkdtemp(prefix="swap19_"))
    read = {}
    try:
        t = time.perf_counter()
        ck = Checkpointer(root / "ckpt")
        ck.save(RunState(params=new, step=0), wait=True)
        ck.close()
        read["save_s"] = time.perf_counter() - t
        prompts = fleet_trace()
        first, later = prompts[:-SWAP["wave2"]], prompts[-SWAP["wave2"]:]
        eng = dict(ENGINE, max_batch=SWAP["max_batch"])
        fleet = Fleet(old, SWAP_CFG, replicas=2, device="cuda:0",
                      watchdog_timeout_s=0.0, max_queue=32, **eng)
        wave1 = [fleet.submit(p, max_new_tokens=NEW_TOKENS, arrival_s=0.0)
                 for p in first]
        fleet.schedule_swap(root / "ckpt", after_completed=SWAP["after"])
        torch.cuda.synchronize()
        _reset_serve_counts()
        t = time.perf_counter()
        fleet.run()
        names = [e["event"] for e in fleet.events]
        check("swap_complete" in names and names.count("swap_replica") == 2
              and names.index("swap_started") < names.index("swap_complete"),
              f"fleet swap: events {names}")
        wave2 = [fleet.submit(p, max_new_tokens=NEW_TOKENS, arrival_s=0.0)
                 for p in later]
        fleet.run()
        torch.cuda.synchronize()
        read["wall_s"] = time.perf_counter() - t
        check(fleet.dropped() == [], f"fleet swap: dropped "
              f"{fleet.dropped()}")
        launches = _serve_launches("fleet swap",
                                   [r.engine for r in fleet.replicas], L)
        ev = {e["event"]: e["t_s"] for e in fleet.events}
        read["swap_window_s"] = (ev.get("swap_complete", 0.0)
                                 - ev.get("swap_started", 0.0))
        check(read["swap_window_s"] > 0, f"fleet swap: the swap found no "
              f"request in flight (events {fleet.events})")
        cap = fleet.view_capacity
        on = _weights_law("fleet swap", {"old": old, "new": new}, SWAP_CFG,
                          wave1 + wave2, cap)
        n1 = {t: sum(on[r.rid] == t for r in wave1) for t in ("old", "new")}
        n2 = sum(on[r.rid] == "new" for r in wave2)
        read.update(wave1=n1, wave2_new=n2)
        check(n2 == len(wave2), f"fleet swap: {n2} of the {len(wave2)} "
              f"requests after the swap ended are on the new weights")
        del fleet
        # the torn swap: the fleet keeps serving on the old weights
        buf = io.StringIO()
        fleet = Fleet(old, SWAP_CFG, replicas=2, device="cuda:0",
                      watchdog_timeout_s=0.0, max_queue=32,
                      fault="corrupt_swap", **eng)
        reqs = [fleet.submit(p, max_new_tokens=NEW_TOKENS, arrival_s=0.0)
                for p in first]
        fleet.schedule_swap(root / "ckpt", after_completed=SWAP["after"])
        with contextlib.redirect_stderr(buf):
            fleet.run()
        torch.cuda.synchronize()
        warning = [ln for ln in buf.getvalue().splitlines()
                   if "fleet keeps serving on the previous weights" in ln]
        print(buf.getvalue(), end="", file=sys.stderr, flush=True)
        names = [e["event"] for e in fleet.events]
        check(bool(warning) and "swap_fault_injected" in names
              and "swap_failed" in names and "swap_replica" not in names,
              f"fleet corrupt swap: events {names}, warning {warning}")
        check(fleet.dropped() == [], f"fleet corrupt swap: dropped "
              f"{fleet.dropped()}")
        on = _weights_law("fleet corrupt swap", {"old": old, "new": new},
                          SWAP_CFG, reqs, cap)
        check(all(v == "old" for v in on.values()),
              f"fleet corrupt swap: {on}")
        read["corrupt_warning"] = warning[0][:160] if warning else None
        del fleet
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"fleet swap on {card}: {json.dumps(read)}")
    return read, launches


def tp_serve_phase(params, serve, card: str) -> tuple[dict, dict]:
    """19d: the engine under ``mesh`` (a ``grid_axes`` of one tp rank, on
    the one-rank group) and ``ENGINE``'s flags serves phase 3's requests:
    tokens bit-equal to phase 3's engine, launches exact, and the shim's
    calls equal to the generated ``serve_decode`` contract (2 · 36
    all_reduces a layer-stack pass, nothing else) times the passes."""
    prompts, want = serve
    L = CFG.num_hidden_layers
    grid = mesh.grid_axes(("tp",), (1,))
    eng = E.ServingEngine(params, CFG, mesh=grid, tp_axis="tp", **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    _reset_serve_counts()
    C.COLLECTIVES.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = C.COLLECTIVES.read()
    per = CG.generate_counts("serve_decode", params, CG.Ctx({"tp": 1}))
    passes = eng.stats["decode_steps"] + eng.stats["prefill_chunks"]
    expect = {k: v * passes for k, v in per.items()}
    log(f"tp serve collectives: {json.dumps(C.COLLECTIVES.nonzero(counts))}"
        f" over {passes} passes; the serve_decode contract "
        f"{json.dumps(C.COLLECTIVES.nonzero(per))} a pass")
    check(per["all_reduce"] == 2 * L and counts == expect,
          f"tp serve collectives: {json.dumps(counts)} != "
          f"{json.dumps(expect)}")
    diff = [r.rid for r, w in zip(reqs, want) if list(r.tokens) != w]
    check(not diff, f"tp serve tokens: requests {diff} differ from phase "
          f"3's engine")
    launches = _serve_launches("tp serve", [eng], L)
    slo = eng.slo_report()
    read = {"per_token_ms": slo["per_token_ms"], "ttft_ms": slo["ttft_ms"],
            "tokens_per_s": slo["tokens_per_s"],
            "all_reduce_per_step": per["all_reduce"]}
    log(f"tp serve (tp 1) on {card}: {json.dumps(read)}")
    return read, launches


def disagg_phase(params, params_q8, serve, q8, card: str
                 ) -> tuple[dict, dict]:
    """19e: ``disaggregate`` on ``device=("cuda:0", "cuda:0")``: phase 3's
    requests on ``ENGINE`` and phase 7's on ``INT8_ENGINE`` (int8
    weights, the int8 pool), each against its phase's tokens bit for
    bit (the handoff is pure data movement), launches exact (K2 and K4
    on the int8 leg).  Each handoff's device time (CUDA events) and
    bytes, logged beside the bytes' bound (read once, written once)."""
    L = CFG.num_hidden_layers
    launches, read = {}, {}
    for label, p, kw, (prompts, want), q8_leg in (
            ("float", params, ENGINE, serve, False),
            ("int8", params_q8, INT8_ENGINE, q8, True)):
        eng = E.ServingEngine(p, CFG, disaggregate=True,
                              device=("cuda:0", "cuda:0"), **kw)
        events, handoff = [], eng._handoff

        def timed_handoff(req, handoff=handoff, events=events):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            handoff(req)
            b.record()
            events.append((a, b))

        eng._handoff = timed_handoff
        reqs = [eng.submit(x, max_new_tokens=NEW_TOKENS) for x in prompts]
        torch.cuda.synchronize()
        _reset_serve_counts()
        eng.run()
        torch.cuda.synchronize()
        diff = [r.rid for r, w in zip(reqs, want) if list(r.tokens) != w]
        check(not diff, f"disaggregated {label} tokens: requests {diff} "
              f"differ from the engine without disaggregate")
        got = _serve_launches(f"disaggregated {label}", [eng], L, q8=q8_leg,
                              int8_w=len(PROJECTIONS) * L + 1 if q8_leg
                              else 0)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ms = [a.elapsed_time(b) for a, b in events]
        h = eng.slo_report()["handoff"]
        check(h["requests"] == len(prompts) == len(ms),
              f"disaggregated {label}: {h['requests']} handoffs")
        per = h["bytes_per_request"]
        read[label] = {"bytes_per_request": per,
                       "device_ms_per_request": statistics.mean(ms),
                       "device_ms_max": max(ms),
                       "host_ms_per_request": h["ms_total"] / len(ms),
                       "bound_ms_per_request":
                           2 * per / HBM_BYTES_PER_S * 1e3,
                       "per_token_ms": eng.slo_report()["per_token_ms"]}
        del eng._handoff   # the timing wrapper holds the engine
        del eng
    log(f"disaggregated handoff on {card}: {json.dumps(read)}")
    return read, launches


def _gap_reading(label, params, reqs, eng) -> dict:
    """The near-argmax reading of ``reqs`` against ``generate`` (logged,
    not gated): the largest gap and how many tokens are the exact
    argmax."""
    gaps = torch.cat([serve_bench.argmax_gaps(
        params, eng.cfg, r.prompt, r.tokens, capacity=eng.view_capacity
    ).cpu() for r in reqs])
    read = {"tokens": int(gaps.numel()), "argmax": int((gaps == 0).sum()),
            "max_gap": float(gaps.max()),
            "gaps_over_atol": int((gaps > FRONTIER_ARGMAX_ATOL).sum())}
    log(f"{label} near-argmax reading (not gated): {json.dumps(read)}")
    return read


@contextlib.contextmanager
def _engine_routes():
    """Record the top-1 routes the engine takes: ``serving.engine.
    _paged_forward`` notes each forward's positions and valid rows,
    ``parallel.expert._route_topk`` (one call a layer, in layer order)
    the valid rows' expert and router probabilities.  Yields a dict
    layer -> list of (positions, experts, probs) on the device; serve one
    request at a time under it, so that every valid row is that
    request's."""
    rec, state = {}, {}
    fwd0, route0 = E._paged_forward, EX._route_topk

    def fwd(params, ids, cfg, bufs, pages, apos, valid, *a, **kw):
        state.update(apos=apos.reshape(-1), valid=valid.reshape(-1), li=0)
        try:
            return fwd0(params, ids, cfg, bufs, pages, apos, valid, *a, **kw)
        finally:
            state.clear()

    def route(x2d, w_router, k):
        out = route0(x2d, w_router, k)
        if state:
            li, sel = state["li"], state["valid"]
            state["li"] += 1
            rec.setdefault(li, []).append(
                (state["apos"][sel].long(), out[1][sel, 0], out[2][sel]))
        return out

    E._paged_forward, EX._route_topk = fwd, route
    try:
        yield rec
    finally:
        E._paged_forward, EX._route_topk = fwd0, route0


def _route_tables(rec: dict, n: int) -> dict:
    """``_engine_routes``' record as per-layer tables over positions 0 ..
    n - 1: expert (n,) and probabilities (n, E); every position recorded
    once."""
    out = {}
    for li, parts in rec.items():
        pos = torch.cat([p[0] for p in parts])
        keep = pos < n
        pos = pos[keep]
        check(pos.numel() == n and torch.equal(pos.sort().values,
                                               torch.arange(n, device=pos.device)),
              f"moe routes: layer {li} recorded {pos.numel()} of {n} "
              f"positions, or one twice")
        out[li] = tuple(
            torch.empty_like(t).index_copy_(0, pos, t) for t in (
                torch.cat([p[j] for p in parts])[keep] for j in (1, 2)))
    return out


def _forced_pass(params, cfg, req, experts, capacity):
    """``req``'s prompt and emitted tokens teacher-forced through
    ``generate``'s cached forward (``serve_bench.argmax_gaps``) with every
    layer's top-1 expert forced to ``experts`` (layer -> (n,)) and its
    gate the pass's own router probability of that expert.  Returns the
    gaps and the pass's router probabilities, layer -> (n, E)."""
    L = cfg.num_hidden_layers
    route0, state, probs_by = EX._route_topk, {"i": 0}, {}

    def forced(x2d, w_router, k):
        li = state["i"] % L
        state["i"] += 1
        _, _, probs = route0(x2d, w_router, k)
        ex = experts[li][:x2d.shape[0], None]
        probs_by[li] = probs
        return probs.gather(-1, ex), ex, probs

    EX._route_topk = forced
    try:
        gaps = serve_bench.argmax_gaps(params, cfg, req.prompt, req.tokens,
                                       capacity=capacity).cpu()
    finally:
        EX._route_topk = route0
    return gaps, probs_by


def _f32_tree(tree):
    """A copy of a params tree with every floating leaf in f32."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def route_aware_law(params, cfg, req, routes, capacity,
                    oracle=None) -> dict:
    """C9's law for one request served alone, with ``routes`` the
    engine's (:func:`_route_tables`): ``generate`` teacher-forced on the
    engine's experts (:func:`_forced_pass`; nothing of the engine's
    arithmetic is copied, the gates are the pass's own) and, with
    ``oracle`` (f32 params and config), the same pass in f32 as the
    witness of the serve dtype's noise.  Returns the gaps, the largest
    difference between the engine's router probabilities and the pass's
    at any row and expert, the sums of squares at the decode rows of the
    engine's and the pass's distances from the oracle's (and their
    count), the rows (layer and position) where the engine's expert is
    not the pass's own top-1 (a route flip), and the largest margin the
    pass's top-1 holds there: ``log p(own) - log p(engine's)`` of the
    pass's router probabilities, 0 at an exact tie."""
    experts = {li: ex for li, (ex, _) in routes.items()}
    gaps, probs = _forced_pass(params, cfg, req, experts, capacity)
    ref = (_forced_pass(*oracle, req, experts, capacity)[1]
           if oracle else None)
    first = len(req.prompt)
    out = {"gaps": gaps, "prob_diff": 0.0, "sq_engine": 0.0,
           "sq_pass": 0.0, "count": 0, "flips": 0, "flip_margin": 0.0}
    for li, (ex, pe) in routes.items():
        pg = probs[li]
        out["prob_diff"] = max(out["prob_diff"],
                               float((pe - pg).abs().max()))
        own = pg.argmax(dim=-1)
        flip = own != ex
        out["flips"] += int(flip.sum())
        if flip.any():
            lp = pg[flip].log()
            out["flip_margin"] = max(out["flip_margin"], float((
                lp.gather(-1, own[flip, None])
                - lp.gather(-1, ex[flip, None])).max()))
        if ref is not None:
            po = ref[li][first:]
            out["sq_engine"] += float(((pe[first:] - po) ** 2).sum())
            out["sq_pass"] += float(((pg[first:] - po) ** 2).sum())
            out["count"] += po.numel()
    return out


def moe_serve_phase(prompts, card: str) -> tuple[dict, dict]:
    """19f: ``MOE_SERVE_CFG`` (SmolLM3-3B-L8-MoE, full width, no drops)
    served through the engine with ``ENGINE``'s flags at bf16, with
    ``quantize_decode_params`` (the attention projections and the
    unembedding int8: K4) and at f32.  Gates: launches exact, plain calls
    0; the batching law: the first ``MOE_ALONE`` requests, each served
    alone by the same engine, emit the batched run's tokens bit for bit
    (slots, padding rows and the experts' buckets leave a row's
    arithmetic alone); and C9's route-aware law on those requests
    (:func:`route_aware_law`), ``generate`` teacher-forced on the
    engine's experts: at f32 every emitted token within
    ``MOE_F32_GAP_ATOL`` of its row's maximum, the engine's router
    probabilities within ``MOE_F32_PROB_ATOL`` of the pass's, and every
    expert the engine took within ``MOE_ROUTE_FLIP_MARGIN`` of the
    pass's own top-1 (a flip only at a near tie); at bf16 and int8 the
    engine's router probabilities at the decode rows no farther (RMS)
    from an f32 pass than ``MOE_ROUTER_RMS_RATIO`` times generate's own.
    The near-argmax reading against ``generate``'s own routes is
    logged."""
    L = MOE_SERVE_CFG.num_hidden_layers
    f32_cfg = dataclasses.replace(MOE_SERVE_CFG, dtype=torch.float32)
    launches, read = {}, {}
    legs = (("bf16", MOE_SERVE_CFG, False), ("int8", MOE_SERVE_CFG, True),
            ("f32", f32_cfg, False))
    for label, cfg, q8w in legs:
        p = serve_bench.build_params(cfg, SEED, PARAM_SCALE, "cuda")
        oracle = (None if label == "f32" else (_f32_tree(p), f32_cfg))
        if q8w:
            p = quantize_decode_params(p, cfg)
        eng = E.ServingEngine(p, cfg, **ENGINE)
        reqs = [eng.submit(x, max_new_tokens=NEW_TOKENS) for x in prompts]
        torch.cuda.synchronize()
        _reset_serve_counts()
        eng.run()
        torch.cuda.synchronize()
        got = _serve_launches(f"moe serve {label}", [eng], L,
                              int8_w=4 * L + 1 if q8w else 0)
        if label != "f32":
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        diff, laws = [], []
        for r in reqs[:MOE_ALONE]:
            alone = E.ServingEngine(p, cfg, **ENGINE)
            q = alone.submit(r.prompt, max_new_tokens=NEW_TOKENS)
            with _engine_routes() as rec:
                alone.run()
            torch.cuda.synchronize()
            if list(q.tokens) != list(r.tokens):
                diff.append(r.rid)
            n = len(q.prompt) + len(q.tokens) - 1
            laws.append(route_aware_law(p, cfg, q, _route_tables(rec, n),
                                        alone.view_capacity, oracle))
            del alone, rec
        del oracle
        check(not diff, f"moe serve {label} batching law: requests "
              f"{diff} served alone differ from the batched run")
        gaps = torch.cat([w["gaps"] for w in laws])
        law = {"tokens": int(gaps.numel()),
               "argmax": int((gaps == 0).sum()),
               "max_gap": float(gaps.max()),
               "gaps_over_2": int((gaps > 2).sum()),
               "worst_token": [int(gaps.argmax()) // NEW_TOKENS,
                               int(gaps.argmax()) % NEW_TOKENS],
               "prob_diff": max(w["prob_diff"] for w in laws),
               "route_flips": sum(w["flips"] for w in laws),
               "flip_margin": max(w["flip_margin"] for w in laws)}
        count = sum(w["count"] for w in laws)
        if count:
            law["rms_engine"] = math.sqrt(
                sum(w["sq_engine"] for w in laws) / count)
            law["rms_pass"] = math.sqrt(
                sum(w["sq_pass"] for w in laws) / count)
            law["rms_ratio"] = law["rms_engine"] / max(law["rms_pass"],
                                                       1e-30)
        read[f"{label} route-aware"] = law
        log(f"moe serve {label} route-aware law (C9) over the first "
            f"{MOE_ALONE} requests: {json.dumps(law)} (limits: "
            + (f"rms ratio {MOE_ROUTER_RMS_RATIO}; gaps and margins not "
               f"gated)" if count else
               f"gap {MOE_F32_GAP_ATOL}, router probabilities "
               f"{MOE_F32_PROB_ATOL}, a flip's margin "
               f"{MOE_ROUTE_FLIP_MARGIN})"))
        check(bool(torch.isfinite(gaps).all()),
              f"moe serve {label} route-aware near-argmax: a gap is not "
              f"finite")
        if count:
            check(law["rms_ratio"] <= MOE_ROUTER_RMS_RATIO,
                  f"moe serve {label} router probabilities: the engine's "
                  f"lie {law['rms_engine']} (RMS) from the f32 pass's at "
                  f"the decode rows, {law['rms_ratio']} times generate's "
                  f"{law['rms_pass']}, over {MOE_ROUTER_RMS_RATIO}")
        else:
            check(law["max_gap"] <= MOE_F32_GAP_ATOL,
                  f"moe serve {label} route-aware near-argmax: an emitted "
                  f"token's logit lies {law['max_gap']} under its row's "
                  f"maximum with the engine's experts, over "
                  f"{MOE_F32_GAP_ATOL}")
            check(law["prob_diff"] <= MOE_F32_PROB_ATOL,
                  f"moe serve {label} router probabilities: the engine's "
                  f"differ from generate's by {law['prob_diff']}, over "
                  f"{MOE_F32_PROB_ATOL}")
            check(law["flip_margin"] <= MOE_ROUTE_FLIP_MARGIN,
                  f"moe serve {label} route flips: the engine took an "
                  f"expert whose router log-probability lies "
                  f"{law['flip_margin']} under the teacher-forced pass's "
                  f"top-1, over {MOE_ROUTE_FLIP_MARGIN}")
        slo = eng.slo_report()
        read[label] = {**read.get(label, {}),
                       **_gap_reading(f"moe serve {label}", p, reqs, eng),
                       "per_token_ms": slo["per_token_ms"],
                       "ttft_ms": slo["ttft_ms"],
                       "tokens_per_s": slo["tokens_per_s"]}
        del eng, p
        torch.cuda.empty_cache()
    log(f"moe serve on {card}: {json.dumps(read)}")
    return read, launches


def fleet_twin_phase(card: str) -> tuple[dict, dict]:
    """19g: ``train.serve_bench.main`` at ``TWIN_FLEET_ARGS`` (SmolLM3-3B,
    two replicas on cuda:0, a replica killed): exit 0 (its own gates:
    nothing dropped, completed + shed = offered, the first requests'
    near-argmax law) and its ``fleet`` block with the reference's keys
    (``FLEET_KEYS``)."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="fleet_twin_"))
    _reset_serve_counts()
    try:
        rc = serve_bench.main([*TWIN_FLEET_ARGS, "--results-dir", str(out)])
        torch.cuda.synchronize()
        counts = {"paged_decode": PA.COUNTS.launches,
                  "flash_prefill": FP.COUNTS.launches}
        runs = [p for p in out.iterdir() if p.is_dir()]
        block = json.loads((runs[0] / "summary.json").read_text()).get(
            "fleet", {}) if len(runs) == 1 else {}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    missing = [k for k, sub in FLEET_KEYS.items() if k not in block or (
        sub is not None and not set(sub) <= set(block[k]))]
    shown = ("completed", "shed", "dropped", "live", "ttft_ms",
             "per_token_ms", "parity", "failures")
    log(f"fleet twin on {card}: rc {rc}, launches {json.dumps(counts)}, "
        f"fleet {json.dumps({k: block.get(k) for k in shown})}, events "
        f"{[e.get('event') for e in block.get('events', [])]}")
    check(rc == 0 and not missing,
          f"fleet twin: exit {rc}; fleet keys missing {missing}")
    return block, counts


def fleet_phase(params, params_q8, serve, q8, card):
    """Phase 19 (the fleet, TP serving, disaggregation, the MoE serve):
    19a-19g.  Returns the readings and each path's launches."""
    t19 = time.perf_counter()
    a, la = failover_phase(params, card)
    b, lb = shed_phase(params, card)
    d, ld = tp_serve_phase(params, serve, card)
    e, le = disagg_phase(params, params_q8, serve, q8, card)
    g, lg = fleet_twin_phase(card)
    c, lc = swap_phase(card)
    f, lf = moe_serve_phase(serve[0], card)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t19
    log(f"phase 19 (the fleet, TP, disaggregation, MoE serve): "
        f"{wall:.1f} s")
    return ({"failover": a, "shed": b, "swap": c, "tp": d, "disagg": e,
             "moe": f, "twin": {k: g.get(k) for k in (
                 "completed", "shed", "dropped", "ttft_ms",
                 "per_token_ms")}, "wall_s": wall},
            {"fleet failover": la, "fleet shed": lb, "fleet swap": lc,
             "tp serve": ld, "disaggregated": le, "moe serve": lf,
             "fleet twin": lg})


# ------------------------------- new shapes (phase 2) and phase 20

def projections_of(cfg) -> list:
    """One layer's seven projections (name, K, N) of ``cfg``, as
    ``PROJECTIONS`` lists SmolLM3-3B's."""
    H, hd = cfg.hidden_size, cfg.resolved_head_dim
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    F = cfg.intermediate_size
    return [("wq", H, q), ("wk", H, kv), ("wv", H, kv), ("wo", q, H),
            ("w_gate", H, F), ("w_up", H, F), ("w_down", F, H)]


def int8_wide_phase(projections, label) -> dict:
    """K5 and K4 at one layer's ``projections`` at M = 8192
    (:func:`int8_train_products`, 2 operand copies): each kernel's
    readings as ``kernels`` lists them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    tr = int8_train_products(gen, projections, label, copies=2)
    M, out = TRAIN["seq"] * TRAIN["bs"], {}
    for n, t, e in (("int8_matmul_fused", tr["t5"], tr["e5"]),
                    ("int8_matmul", tr["t4"], tr["e4"])):
        b_ms, b_by = bound(t["nbytes"], t["ops"], PEAK_INT8_OPS)
        lib = None if n in tr["lib_missing"] else t["l"]
        out[n] = {"max_abs_err": e, "gate_ratio": 0.0, "ms": t["k"],
                  "plain_ms": t["p"], "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
        log(f"{n}, {label}'s 7 projections at M = {M}: bit-equal; kernel "
            f"{t['k']:.4f} ms, plain {t['p']:.4f} ms, _int_mm {lib} ms, "
            f"bound {b_ms:.4f} ms by {b_by}")
    return out


def _shape_reading(entry: dict) -> dict:
    keys = ("max_abs_err", "gate_ratio", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "oracle_ratio")
    return {k: entry[k] for k in keys if k in entry}


def attention_hd64_phase() -> dict:
    """The flash kernels at hd 64 (``FA_HD64``: B 1, S 8192, forward and
    backward against the plain version at FA's limits, the forward over
    its f64 oracle reading, a second launch bit-equal, times beside
    SDPA) and the backward at a pipeline stage's microbatch against the
    exact gradient (``FA_HD64_BWD_SEEDS``).  Returns each kernel's
    readings by config."""
    out = {}
    for i, (label, cfg) in enumerate(FA_HD64):
        fwd, bwd = attention_phase(_heads(cfg), seed=SEED + 30 + i)
        out.setdefault("flash_attention_fwd", {})[label] = _shape_reading(fwd)
        out.setdefault("flash_attention_bwd", {})[label] = _shape_reading(bwd)
    fa_bwd_oracle_gate(_heads(FA_HD64[0][1]), FA_HD64_BWD_SEEDS)
    return out


def new_shapes_phase() -> dict:
    """Phase 2's shapes of phase 20's configs: :func:`attention_hd64_phase`,
    then K6, K5 and K4 at ``WIDE_CFGS``' projections against their plain
    versions.  Returns each kernel's readings by config."""
    out = attention_hd64_phase()
    for label, cfg in WIDE_CFGS:
        projs = projections_of(cfg)
        out.setdefault("fp8_matmul", {})[label] = _shape_reading(
            fp8_phase(projs, label))
        for n, r in int8_wide_phase(projs, label).items():
            out.setdefault(n, {})[label] = r
    log(f"new shapes: {json.dumps(out)}")
    return out


def _leg_cfg(train):
    return dataclasses.replace(getattr(T, MODEL_REGISTRY[train["model"]]),
                               matmul_precision=train["precision"],
                               attention_impl="flash")


def _leg_first_batch(train, cfg):
    """run_leg's first batch of ``train``."""
    if train.get("data") == "corpus":
        it = flagship.corpus_batches(cfg.vocab_size, train["seq"],
                                     train["bs"], train["num_steps"])
    else:
        it = flagship.leg_batches(cfg.vocab_size, train["seq"], train["bs"],
                                  train["num_steps"], train["seed"])
    return tuple(torch.as_tensor(a, device="cuda") for a in next(it))


@contextlib.contextmanager
def _plain_attention_by_kv_heads(group: int):
    """``T.attention_plain`` over ``group`` KV heads at a time, each with
    its query heads: every head's arithmetic as the plain path's, in a
    fraction of its (B, n, S, S) f32 buffers (32 heads at S 8192 hold
    8.6 GB each, and their backward several)."""
    orig = T.attention_plain

    def by_heads(q, k, v, scale):
        rep = q.shape[2] // k.shape[2]
        return torch.cat([orig(q[:, :, i * rep:(i + group) * rep],
                               k[:, :, i:i + group], v[:, :, i:i + group],
                               scale)
                          for i in range(0, k.shape[2], group)], dim=2)
    T.attention_plain = by_heads
    try:
        yield
    finally:
        T.attention_plain = orig


def family_parity(label, train) -> float:
    """Step 0 of ``train``'s run on its params and first batch: the flash
    kernels against plain attention (``FAMILY_PLAIN_KV_HEADS`` KV heads
    at a time), the rest the same on both sides: |loss difference| <=
    ``LOSS_ATOL`` and every grad leaf's relative L2 <=
    ``FAMILY_GRAD_REL_L2``.  Returns the kernel path's loss."""
    cfg = _leg_cfg(train)
    gen = torch.Generator(device="cuda").manual_seed(train["seed"])
    params = T.init_params(cfg, gen, "cuda")
    batch = _leg_first_batch(train, cfg)
    got = {}
    for name, c in (("flash", cfg), ("plain", dataclasses.replace(
            cfg, attention_impl="xla"))):
        with _plain_attention_by_kv_heads(FAMILY_PLAIN_KV_HEADS):
            loss, grads = fsdp.microbatch_value_and_grad(
                lambda p, b, c=c: T.lm_loss(p, b, c), params, batch, 1)
        got[name] = (float(loss), grads)
    (lk, gk), (lp, gp) = got["flash"], got["plain"]
    rel = _grad_rel_l2(gk, gp)
    worst = max(rel, key=rel.get)
    log(f"{label} step-0 parity (flash against plain attention): |loss "
        f"difference| {abs(lk - lp):.6f} (atol {LOSS_ATOL}), losses {lk!r},"
        f" {lp!r}; grad relative L2, worst leaf {worst} {rel[worst]:.5f} "
        f"(limit {FAMILY_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    check(np.isfinite(lk) and abs(lk - lp) <= LOSS_ATOL,
          f"{label} step-0 loss: flash {lk} against plain {lp}, over "
          f"{LOSS_ATOL}")
    check(rel[worst] <= FAMILY_GRAD_REL_L2,
          f"{label} step-0 grads: {worst} relative L2 {rel[worst]} over "
          f"{FAMILY_GRAD_REL_L2}")
    del params, got, gk, gp
    torch.cuda.empty_cache()
    return lk


def family_train(label, train, card, loss0=None, ckpt_dir=None) -> tuple:
    """``train["num_steps"]`` steps of ``flagship.run_leg`` at ``train``;
    the kernels' launches exact (per step: the flash forward 2 · L under
    the full remat, its backward L, K6 14 · L at fp8_pallas) with no
    plain call, the step-0 loss bit-equal to ``loss0`` when given.
    Returns (readings, launches)."""
    cfg = _leg_cfg(train)
    L, n = cfg.num_hidden_layers, train["num_steps"]
    expect = {"flash_attention_fwd": (FA.FWD_COUNTS, 2 * L),
              "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    if train["precision"] == "fp8_pallas":
        expect["fp8_matmul"] = (Q.COUNTS, 2 * L * len(PROJECTIONS))
    _reset_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = flagship.run_leg(
        train["model"], train["precision"], train["seq"], train["bs"], n,
        train["warmup_steps"], train["peak_lr"], seed=train["seed"],
        device="cuda", data=train.get("data", "synthetic"),
        ckpt_dir=ckpt_dir,
        on_step=lambda i, loss: log(f"{label} step {i}: loss {loss!r}"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    times = res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:]) if n > 1 else steps[0]
    tok_s = train["seq"] * train["bs"] / step_s
    mfu = T.model_flops_per_token(cfg, train["seq"]) * tok_s \
        / PEAK_BF16_FLOPS
    read = {"losses": res["losses"], "step_ms": step_s * 1e3,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_gib": peak / 2 ** 30,
            "launches": counts}
    log(f"{label} on {card}: {json.dumps(read)} (step ms the median after "
        f"step 0, host clock, each step ending in a sync; MFU over 989 "
        f"TFLOP/s bf16)")
    for k, (c, per) in expect.items():
        check(counts[k] == (n * per, 0),
              f"{label}: {k} (launches, plain) {counts[k]} != ({n * per}, 0)")
    check(all(np.isfinite(res["losses"])),
          f"{label}: non-finite loss in {res['losses']}")
    if loss0 is not None:
        check(res["losses"][0] == loss0, f"{label}: step-0 loss "
              f"{res['losses'][0]!r} is not the parity phase's {loss0!r}")
    return read, {k: v[0] for k, v in counts.items()}


def corpus_phase(card: str, keep_ckpt=None) -> tuple[dict, dict]:
    """20a: ``corpus-70m`` on the committed corpus (``CORPUS_TRAIN``):
    step-0 parity, the run with its final params saved (into
    ``keep_ckpt``, left for the caller, when given), then
    ``train.eval_lm`` on the held-out tail from that save: restored at
    the run's last step, a finite loss, the flash forward launched L a
    batch, and no held-out window among the trained ones."""
    import tempfile
    from distributed_training_sandbox_tpu_torch.train import eval_lm
    train = CORPUS_TRAIN
    loss0 = family_parity("corpus-70m", train)
    ck = keep_ckpt or Path(tempfile.mkdtemp(prefix="corpus_ck_"))
    try:
        read, launches = family_train("corpus-70m", train, card, loss0, ck)
        _reset_kernel_counts()
        ev = eval_lm.run(train["model"], "corpus", train["seq"], train["bs"],
                         ck, train["precision"], "cuda")
        torch.cuda.synchronize()
        ev_fa = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls)
    finally:
        if keep_ckpt is None:
            shutil.rmtree(ck, ignore_errors=True)
    cfg = _leg_cfg(train)
    (tr, _), (ho, _) = flagship.corpus_windows(cfg.vocab_size, train["seq"])
    seen = {r.tobytes() for r in tr[:train["num_steps"] * train["bs"]]}
    shared = sum(r.tobytes() in seen for r in ho)
    read.update(eval=ev, eval_launches=ev_fa, heldout_in_trained=shared)
    L = cfg.num_hidden_layers
    log(f"corpus-70m eval on {card}: {json.dumps(ev)}; flash forward "
        f"(launches, plain) {ev_fa}; held-out windows among the trained "
        f"{shared} of {len(ho)}")
    check(ev["restored_step"] == train["num_steps"]
          and np.isfinite(ev["eval_loss"]),
          f"corpus eval: restored step {ev['restored_step']}, loss "
          f"{ev['eval_loss']}")
    check(ev_fa == (L * ev["eval_steps"], 0),
          f"corpus eval: flash forward (launches, plain) {ev_fa} != "
          f"({L * ev['eval_steps']}, 0)")
    check(shared == 0, f"corpus eval: {shared} held-out windows were "
          f"trained on")
    return read, launches


def families_phase(card: str) -> tuple[dict, dict]:
    """20b: ``FAMILY_TRAINS`` (Llama-3.2-1B at hd 64, Qwen3-4B-L6 at hd
    128 and vocab 151 936) through the flagship twin, each gated at step
    0 and by its launches; then ``FP8_FAMILY`` (corpus-350m at
    fp8_pallas: K6 and the hd-64 flash kernels) by its launches."""
    read, launches = {}, {}
    for train in FAMILY_TRAINS:
        loss0 = family_parity(train["model"], train)
        read[train["model"]], launches[train["model"]] = family_train(
            train["model"], train, card, loss0)
    m = FP8_FAMILY["model"]
    read[m], launches[m] = family_train(m, FP8_FAMILY, card)
    return read, launches


def classification_phase(card: str) -> dict:
    """20c: ``train.ddp.run`` on the one-rank group at ``CLS``
    (SmolLM3-350M's full width, its own plain attention, synthetic
    pairs), per-leaf sync, then ``CLS["q8_steps"]`` steps with int8
    grads and error feedback.  Gates: the sync check exactly 0.0, every
    step's collectives the ``ddp`` contract's (an all_reduce a leaf, the
    loss mean, the barrier; q8: two all_gathers a bucket), every padded
    width a multiple of 8 and at least two widths, finite losses."""
    out = {}
    for label, kw in (("per-leaf", {}), ("q8 ef", dict(
            quantize_grads=True, error_feedback=True))):
        steps = CLS["q8_steps"] if kw else CLS["num_steps"]
        res = ddp_run.run(model=CLS["model"], source=CLS["source"],
                          num_steps=steps, batch_size=CLS["batch"],
                          device="cuda", log=log, **kw)
        params = res.pop("params")
        nbytes = sum(p.numel() * p.element_size()
                     for _, p in fsdp.optim.tree_leaves(params))
        want = C.COLLECTIVES.nonzero(step_collectives(
            "ddp", res["n_leaves"], nbytes, q8=bool(kw)))
        got = [C.COLLECTIVES.nonzero(c) for c in res["collectives"]]
        widths = res["widths"]
        r = {"losses": res["losses"], "widths": widths,
             "step_ms": [round(t * 1e3, 3) for t in res["step_s"]],
             "peak_gib": res["peak_memory_bytes"] / 2 ** 30,
             "accuracy_batch0": res["accuracy_batch0"],
             "collectives": got[0], "contract": want,
             "sync_error": res["sync_error"]}
        out[label] = r
        log(f"classification {label} on {card}: {json.dumps(r)}")
        check(res["sync_error"] == 0.0, f"classification {label}: params "
              f"sync error {res['sync_error']}")
        check(all(g == want for g in got) and len(got) == steps,
              f"classification {label}: collectives {got} against the "
              f"contract's {want} a step")
        check(all(w % 8 == 0 for w in widths) and len(set(widths)) >= 2,
              f"classification {label}: padded widths {widths}")
        check(all(np.isfinite(res["losses"])),
              f"classification {label}: non-finite loss in {res['losses']}")
        del params
        torch.cuda.empty_cache()
    return out


def native_phase() -> dict:
    """20d: the native data engine built on the card's host from
    ``native/dtsdata.cpp``: its Zipf stream at ``NATIVE_ZIPF`` hashes to
    ``NATIVE_ZIPF_DIGEST`` and its packer's windows equal the numpy
    packer's bit for bit; host times beside numpy's."""
    import hashlib
    from distributed_training_sandbox_tpu_torch.data import native as NV
    from distributed_training_sandbox_tpu_torch.data import packing
    t = time.perf_counter()
    ok = NV.available()
    build_s = time.perf_counter() - t
    check(ok, f"native engine: {NV.build_error()}")
    t = time.perf_counter()
    stream = NV.synthetic_token_stream(*NATIVE_ZIPF)
    zipf_s = time.perf_counter() - t
    digest = hashlib.sha256(stream.tobytes()).hexdigest()
    out = {"build_s": build_s, "zipf_s": zipf_s, "digest": digest}
    for seq in (2048, 8192):
        t = time.perf_counter()
        got = NV.pack_tokens(stream, seq)
        t_nv = time.perf_counter() - t
        t = time.perf_counter()
        want = packing.pack_tokens(stream, seq)
        t_np = time.perf_counter() - t
        same = all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got, want))
        out[f"pack {seq}"] = {"equal": same, "native_s": t_nv,
                              "numpy_s": t_np}
        check(same, f"native engine: pack_tokens at seq {seq} differs "
              f"from the numpy packer")
    log(f"native engine on the card's host: {json.dumps(out)}")
    check(digest == NATIVE_ZIPF_DIGEST, f"native engine: Zipf stream "
          f"digest {digest}, expected {NATIVE_ZIPF_DIGEST}")
    return out


def phase20(card: str, corpus_ckpt=None) -> tuple[dict, dict]:
    """Phase 20 (the data tier, classification and the model families):
    20a-20d, 20a's checkpoint left in ``corpus_ckpt`` when given.
    Returns the readings and each path's launches."""
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    a, la = corpus_phase(card, corpus_ckpt)
    b, lb = families_phase(card)
    c = classification_phase(card)
    d = native_phase()
    wall = time.perf_counter() - t20
    log(f"phase 20 (data, classification and the model families): "
        f"{wall:.1f} s")
    return ({"corpus": a, "families": b, "classification": c, "native": d,
             "wall_s": wall},
            {"corpus": la, **{f"family {k}": v for k, v in lb.items()}})


# ------------------------------------------------ phase 21: observability

def _stage_states_equal(a, b) -> bool:
    """Every stage's params and Adam state (moments, count) bit-equal."""
    for sa, sb in zip(a, b, strict=True):
        fa = flatten_tree({"p": sa.params, "o": sa.opt_state})
        fb = flatten_tree({"p": sb.params, "o": sb.opt_state})
        if fa.keys() != fb.keys():
            return False
        for k, x in fa.items():
            y = fb[k]
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y):
                return False
    return True


def pipeline_harness_phase(card: str, root: Path) -> tuple[dict, dict, str]:
    """21a: ``train.pipeline.run`` at ``PIPE_LM`` (1F1B, 4 stages on the
    card) under the run harness: ``PIPE_HARNESS["epochs"]`` epochs,
    profiled (the owned session over ``LEDGER_SCHEDULE``'s epochs) with
    the host prefetcher; then the same run preempted before epoch
    ``preempt`` and resumed in process from its checkpoint (every
    stage's params and Adam state): losses, params and moments bit-equal
    to the profiled run's (the profiler only reads).  The profiled run's
    summary: the comm/compute split present, device time on compute,
    none on comm (one card: a stage hands its activations to the next
    without a copy), its ledger joined to the zero-collective contract.
    FA's launches exact over both runs.  Returns the readings, FA's
    launches and the profiled run's dir."""
    cfg, pl, ph = PIPE_LM_CFG, PIPE_LM, PIPE_HARNESS
    L = cfg.num_hidden_layers
    kw = dict(model=pl["model"], n_stages=pl["n_stages"],
              n_micro=pl["n_micro"], lr=pl["lr"], warmup_epochs=pl["warmup"],
              batch_size=pl["batch"], seq=pl["seq"], seed=pl["seed"],
              num_epochs=ph["epochs"], keep_stages=True, device="cuda",
              log=log)
    FA.FWD_COUNTS.reset()
    FA.BWD_COUNTS.reset()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    a = pp_run.run("1f1b", config=quiet_config(
        telemetry=True, profile=True, results_dir=str(root / "runs"),
        trace_dir=str(root / "traces" / "pipeline"),
        prefetch_depth=ph["prefetch_depth"]),
        profile_schedule=LEDGER_SCHEDULE, **kw)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t
    summary = json.loads((Path(a["run_dir"]) / "summary.json").read_text())
    sp, led = summary.get("comm_split"), summary.get("ledger")
    ck = root / "pipeline_ckpt"   # under the phase's root (TMPDIR)
    t = time.perf_counter()
    try:
        b = pp_run.run("1f1b", config=quiet_config(
            checkpoint_dir=str(ck), max_restarts=1,
            inject_fault=f"preempt@{ph['preempt']}"), **kw)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    t_b = time.perf_counter() - t
    same = _stage_states_equal(a["stages"], b["stages"])
    counts = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls,
              FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls)
    out = {"profiled_s": round(t_a, 1), "resumed_s": round(t_b, 1),
           "checkpoint_dir": str(ck.parent), "losses": a["losses"],
           "resumed_losses": b["losses"], "start_epoch": b["start_epoch"],
           "state_bit_equal": same,
           "save": [{k: v for k, v in sv.items() if k != "dir"}
                    for sv in b["saves"]], "restore_s": b["restore_s"],
           "comm_split": {k: v for k, v in (sp or {}).items()
                          if k != "trace_file"},
           "comm_split_error": summary.get("comm_split_error"),
           "ledger": led, "step_ms": a["step_ms"], "fa_counts": counts}
    log(f"pipeline harness on {card}: {json.dumps(out)}")
    check(b["status"] == "completed" and b["start_epoch"] == ph["preempt"],
          f"pipeline harness: resumed run {b['status']} from epoch "
          f"{b['start_epoch']}")
    check(b["losses"] == a["losses"], f"pipeline harness: resumed losses "
          f"{b['losses']} against {a['losses']}")
    check(same, "pipeline harness: the resumed run's params or Adam state "
          "differ from the uninterrupted run's")
    check(sp is not None and not summary.get("comm_split_error"),
          f"pipeline harness: no comm split "
          f"({summary.get('comm_split_error')})")
    check(sp["source"] == "device" and sp["compute_us"] > 0,
          f"pipeline harness: split {sp}")
    check(sp["comm_us"] == 0.0, f"pipeline harness: {sp['comm_us']} us of "
          f"comm on one card, where the stages share the card")
    check(led is not None and led.get("ok") and led["traced_steps"] == 2,
          f"pipeline harness: ledger {led} ({summary.get('ledger_error')})")
    # each epoch's forwards (remat recomputes each) and backward a
    # microbatch, and each completed run's closing forward; the
    # preempted segment runs epochs 0 .. preempt - 1 and no closing one
    epochs = 2 * ph["epochs"]
    want = (2 * L * pl["n_micro"] * epochs + 2 * L, 0,
            L * pl["n_micro"] * epochs, 0)
    check(counts == want, f"pipeline harness: FA counts {counts} != {want}")
    run_dir = a["run_dir"]
    del a, b
    torch.cuda.empty_cache()
    return (out, {"flash_attention_fwd": counts[0],
                  "flash_attention_bwd": counts[2]}, run_dir)


def _ledger_gates(name: str, run_dir: str, per_step: list) -> dict:
    """A profiled twin's ledger: filed, its join ok, the traced calls of
    each kind the shim's a step times the traced steps; the join not ok
    once the contract is edited by one call.  Returns its readings."""
    summary = json.loads((Path(run_dir) / "summary.json").read_text())
    led = summary.get("ledger")
    check(led is not None and led.get("ok") and not summary.get(
        "ledger_error"), f"ledger {name}: {led} "
        f"({summary.get('ledger_error')})")
    doc = json.loads((Path(run_dir) / LD.LEDGER_FILENAME).read_text())
    steps = led["traced_steps"]
    measured: dict = {}
    for e in doc["entries"]:
        measured[e["kind"]] = measured.get(e["kind"], 0) + e["occurrences"]
    want = {k: v * steps for k, v in per_step[-1].items() if v}
    check(steps == LEDGER_SCHEDULE.active and measured == want,
          f"ledger {name}: {measured} traced calls over {steps} steps, the "
          f"shim's {want}")
    ledger = LD.CollectiveLedger(
        entries=[LD.LedgerEntry(**e) for e in doc["entries"]],
        unmatched_events=doc["unmatched_events"],
        unmeasured_instances=doc["unmeasured_instances"],
        axis_sizes=doc["axis_sizes"])
    expected = dict(doc["contract_join"]["expected"])
    kind = next(k for k, v in expected.items() if v)
    edited = LD.join_contract(ledger, dict(expected,
                                           **{kind: expected[kind] + 1}))
    check(not edited["ok"], f"ledger {name}: the join holds with "
          f"{kind} edited to {expected[kind] + 1}")
    aggs = {k: {f: a[f] for f in ("events", "total_us", "busbw_gbps")}
            for k, a in doc["aggregates"].items()}
    sp = summary.get("comm_split") or {}
    return {"traced_calls": measured, "aggregates": aggs,
            "busbw_gbps": doc["totals"]["busbw_gbps"],
            "comm_us": sp.get("comm_us"), "compute_us": sp.get("compute_us"),
            "edited_violations": edited["violations"]}


def ledger_phase(card: str, root: Path) -> dict:
    """21b: the DDP twin (``LEDGER_DDP``) and the FSDP twin
    (``LEDGER_FSDP``) on the one-rank group, profiled over
    ``LEDGER_SCHEDULE``'s steps: each one's ledger (:func:`_ledger_gates`)."""
    def cfg(tag):
        return quiet_config(telemetry=True, profile=True,
                            results_dir=str(root / "runs"),
                            trace_dir=str(root / "traces" / tag))
    d, f = LEDGER_DDP, LEDGER_FSDP
    r = ddp_run.run(scale=d["scale"], num_steps=d["num_steps"],
                    batch_size=d["batch_size"], seed=d["seed"],
                    device="cuda", config=cfg("ddp"),
                    profile_schedule=LEDGER_SCHEDULE, log=log)
    out = {"ddp": _ledger_gates("ddp", r["run_dir"], r["collectives"])}
    del r
    torch.cuda.empty_cache()
    r = train_fsdp.run(model=f["model"], overlap=f["overlap"], seq=f["seq"],
                       batch_size=f["bs"], num_steps=f["num_steps"],
                       seed=f["seed"], device="cuda", config=cfg("fsdp"),
                       profile_schedule=LEDGER_SCHEDULE, log=log)
    out["fsdp"] = _ledger_gates("fsdp", r["run_dir"], r["collectives"])
    del r
    torch.cuda.empty_cache()
    log(f"ledger readings on {card} (one rank: copies): {json.dumps(out)}")
    return out


def _timeline_events(run_dir: Path) -> list[dict]:
    with gzip.open(run_dir / "timeline.json.gz", "rt") as fh:
        return json.load(fh)["traceEvents"]


def timeline_phase(card: str, root: Path, pipe_run_dir: str) -> dict:
    """21c: ``serve_bench --profile --export-timeline`` at
    ``TIMELINE_ARGS``: exit 0, the timeline's device rows hold K1 and K3
    kernels and its host rows the ``serve/*`` spans; then 21a's profiled
    run exported, its device rows holding the FA forward."""
    before = {p.name for p in (root / "runs").iterdir()}
    rc = serve_bench.main([*TIMELINE_ARGS, "--results-dir",
                           str(root / "runs"), "--trace-dir",
                           str(root / "traces" / "serve")])
    check(rc == 0, f"timeline: serve_bench exit {rc}")
    (serve_dir,) = [p for p in (root / "runs").iterdir()
                    if p.name not in before]
    evs = _timeline_events(serve_dir)
    kernels = [e["name"] for e in evs if e.get("cat") == "kernel"]
    spans = {e["name"] for e in evs if e.get("pid") == xt_run.HOST_PID
             and e.get("ph") == "X"}
    out = {"events": len(evs), "kernels": len(kernels),
           "k1": sum(K1_SYMBOL in n for n in kernels),
           "k3": sum(K3_SYMBOL in n for n in kernels),
           "host_spans": sorted(spans)}
    check(out["k1"] > 0 and out["k3"] > 0, f"timeline: K1 {out['k1']} and "
          f"K3 {out['k3']} events among {len(kernels)} kernels")
    check(any(n.startswith("serve/") for n in spans),
          f"timeline: host rows {sorted(spans)}")
    rc = xt_run.main([pipe_run_dir])
    evs = _timeline_events(Path(pipe_run_dir))
    out["pipeline_fa_fwd"] = sum(FA_FWD_SYMBOL in e.get("name", "")
                                 for e in evs if e.get("cat") == "kernel")
    check(rc == 0 and out["pipeline_fa_fwd"] > 0, f"timeline: the "
          f"pipeline run's export exit {rc}, FA forward events "
          f"{out['pipeline_fa_fwd']}")
    log(f"timeline readings on {card}: {json.dumps(out)}")
    return out


def report_phase(root: Path) -> dict:
    """21d: ``train/report.py`` over every run dir phase 21 wrote (the
    bandwidth table from 21b's ledgers beside phase 12's busbench rows),
    exit 0; and against the same dirs as ``--baseline``, exit 0."""
    runs = str(root / "runs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report_run.main([runs])
    text = buf.getvalue()
    table = text[text.find("## Collective bus bandwidth"):].split("\n## ")[0]
    log(f"report over {len(list((root / 'runs').iterdir()))} run dirs, exit "
        f"{rc}; its bandwidth table:\n{table}")
    check(rc == 0 and "## Collective bus bandwidth" in text,
          f"report: exit {rc}, bandwidth table "
          f"{'## Collective bus bandwidth' in text}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_base = report_run.main([runs, "--baseline", runs])
    check(rc_base == 0, f"report --baseline: exit {rc_base}: "
          f"{buf.getvalue()[-2000:]}")
    return {"rc": rc, "rc_baseline": rc_base, "chars": len(text)}


def phase21(card: str) -> tuple[dict, dict]:
    """Phase 21 (the observability tier): 21a-21d, under a temporary
    directory removed at the end.  Returns the readings and the
    pipeline harness's launches."""
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="phase21_"))
    (root / "runs").mkdir()
    try:
        a, la, pipe_dir = pipeline_harness_phase(card, root)
        b = ledger_phase(card, root)
        c = timeline_phase(card, root, pipe_dir)
        d = report_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t21
    log(f"phase 21 (the pipeline harness, the ledger, the timeline, the "
        f"report): {wall:.1f} s")
    return ({"pipeline harness": a, "ledger": b, "timeline": c, "report": d,
             "wall_s": wall}, {"pipeline harness": la})


# ------------------------------------- phase 22: the model core's rest

# (a) the remat policies at the precisions whose projections run a kernel
# (SmolLM3-3B-L8, seq 8192, batch 1, flash attention, one FSDP
# value-and-grad after a recorded warm-up a policy).  Kept bytes are the
# policy's cache (transformer.record_kept): save_dots keeps none at the
# *_pallas precisions (the reference's dots_with_no_batch_dims_saveable
# sees no dot in a kernel), save_dots_q8 the int8 pairs, at most
# REMAT_Q8_SAVED_RATIO of bf16 save_dots' bytes (int8 codes and f32 row
# scales of the same six products a layer read about 0.5).  The same
# two laws on the measured peak above the step's start: save_dots' peak
# within REMAT22_PEAK_SLACK_BYTES of full's (the allocator's own spread:
# 1 MiB between two readings; the smallest product a policy could keep,
# a layer's K projection, is 8 MiB and the six a layer 3.3 GiB over the
# 8 layers), save_dots_q8's peak excess over full's at most
# REMAT_Q8_SAVED_RATIO of bf16 save_dots' (as 13b gates it).  The int8
# leg keeps K4's bf16 outputs where the reference keeps its XLA dot's
# int32 accumulator (REF_ACC_BYTES an element): logged beside it.
REMAT22 = dict(model="smollm3-3b-l8", seq=8192, bs=1, seed=42)
REMAT22_PRECISIONS = ("int8_pallas_bwd", "fp8_pallas")
REMAT22_PEAK_SLACK_BYTES = 6 * 2 ** 20
REF_ACC_BYTES = 4
# (b) the twins at cut depth, each on the one-rank group: moe_bench's
# rows of MOE_BENCH22 (grouped bf16; grouped cf 1.25 int8_bwd) at
# MOE22_LAYERS layers and batch 1; one moe_profile step at MOE22_LAYERS;
# one long_context row; the flagship's spike demo; generate_demo with
# --serve on 20a's corpus-70m checkpoint (phase 22 alone trains one of
# DEMO22 steps); decode_bench on SmolLM3-3B (C14: its slope, over
# DECODE22's new tokens, positive).  Before generate_demo, K3 at
# corpus-70m's heads (12 / 4, a GQA group of 3 that splits rows across
# the kernel's 64-vector blocks): K3_GROUP22's slots and chunk, one draw
# a pool dtype against the plain version at its tolerance, the f64
# oracle's off-counts of both logged
MOE_BENCH22 = "0,3"
MOE22_LAYERS = 2
LONG22_SEQ = 16384
SPIKE22 = dict(seq=2048, steps=3)
DEMO22 = dict(model="corpus-70m", seq=2048, bs=8, steps=5)   # 20a's windows
K3_GROUP22 = dict(slots=8, page=16, view=2048, chunk=256, prompt=(256, 1536))
DECODE22 = ["--model", "smollm3-3b", "--batch", "1", "--prompt", "128",
            "--new", "32"]
# the a2a ranges hold views only at one rank (no all_to_all runs; the
# reference's one-chip rows have no a2a phase at all)
MOE22_VIEW_PHASES = ("moe_a2a_out", "moe_a2a_back")


def _kernel_counts() -> dict:
    """Every kernel's (launches, plain calls)."""
    return {"paged_decode": PA.COUNTS, "paged_decode_q8": PA.Q8_COUNTS,
            "flash_prefill": FP.COUNTS, "int8_matmul": Q.INT8_COUNTS,
            "int8_matmul_fused": Q.INT8_FUSED_COUNTS,
            "fp8_matmul": Q.COUNTS, "flash_attention_fwd": FA.FWD_COUNTS,
            "flash_attention_bwd": FA.BWD_COUNTS, "ag_matmul": C.COUNTS}


def _launches_now() -> dict:
    return {k: c.launches for k, c in _kernel_counts().items()
            if c.launches}


def _reset_all_counts() -> None:
    for c in _kernel_counts().values():
        c.reset()
    Q.BWD_COUNTS.reset()


def _remat22_leg(shards, batch, cfg) -> dict:
    """One policy's leg: a warm-up under ``record_kept``, then the timed
    value-and-grad with its launches, peak and step ms."""
    vg = fsdp.make_fsdp_value_and_grad(shards, cfg)
    with T.record_kept() as entries:
        vg(shards, batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _reset_all_counts()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, grads = vg(shards, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts = {k: (c.launches, c.plain_calls)
              for k, c in _kernel_counts().items()
              if c.launches or c.plain_calls}
    proj = {str(Q.INT8_DENSE_OP), str(Q.FP8_DENSE_OP)}
    # a kept projection: its output, or under save_dots_q8 its codes
    # (each dot_q8 keeps codes and scales)
    kept = sum(op in proj or (op == str(Q.DOT_Q8_OP) and dt == torch.int8)
               for _, dt, op in entries)
    return {"loss": float(loss), "grads": grads, "ms": round(ms, 1),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated()
            - start, "kept_bytes": T.kept_bytes(entries),
            "kept_entries": len(entries),
            "kept_projections": kept,
            "kept_dtypes": sorted({str(dt) for _, dt, _ in entries}),
            "ref_acc_bytes": sum(math.prod(s) * REF_ACC_BYTES
                                 for s, _, op in entries if op in proj),
            "counts": counts,
            "fp8_bwd_plain": Q.BWD_COUNTS.plain_calls}


def _remat22_want(precision: str, kept: int, L: int) -> dict:
    """The launches a step implies for a kept set of ``kept``
    projections: each projection's forward, its recompute unless kept,
    the int8 backward's dX and dW (K4), FA twice forward, once back."""
    n = L * len(PROJECTIONS)
    fwd = n + (n - kept)
    want = {"flash_attention_fwd": (2 * L, 0), "flash_attention_bwd": (L, 0)}
    if precision == "bf16":
        return want
    if precision == "int8_pallas_bwd":
        want.update(int8_matmul_fused=(fwd, 0), int8_matmul=(2 * n, 0))
    elif precision == "fp8_pallas":
        want["fp8_matmul"] = (fwd, 0)
    else:   # int8: K4 forward, a straight-through bf16 backward
        want["int8_matmul"] = (fwd, 0)
    return want


def remat22_phase(card: str) -> tuple[dict, dict]:
    """22a: the remat policies at ``REMAT22_PRECISIONS`` and the int8
    ``save_dots`` leg, beside bf16 ``full`` and ``save_dots``.  Gates:
    ``save_dots`` bit-equal to ``full`` (loss, every grad) at each
    precision, with no kept byte and its peak within
    ``REMAT22_PEAK_SLACK_BYTES`` of ``full``'s at each ``*_pallas``
    precision; ``save_dots_q8``'s loss within [``REMAT_Q8_LOSS_MIN_RTOL``,
    ``REMAT_Q8_LOSS_RTOL``] of ``full``'s, its kept bytes and its peak's
    excess over ``full``'s each at most ``REMAT_Q8_SAVED_RATIO`` of bf16
    ``save_dots``'; every leg's launches what its kept set implies
    (:func:`_remat22_want`: under ``save_dots_q8`` a kept projection's
    kernel does not run again in the recompute); the int8 leg's six
    products a layer kept in bf16.  Returns the readings and the
    launches (the path "22: remat")."""
    cfg0 = train_fsdp.model_config(REMAT22["model"])
    L = cfg0.num_hidden_layers
    shards, batch = _prec_inputs(cfg0, REMAT22["seed"], REMAT22["seq"],
                                 REMAT22["bs"], 1)
    rows, launches, failures = {}, {}, []
    legs = [("bf16", "full"), ("bf16", "save_dots")]
    legs += [(p, pol) for p in REMAT22_PRECISIONS
             for pol in ("full", "save_dots", "save_dots_q8")]
    legs += [("int8", "full"), ("int8", "save_dots")]
    ref = bf16_kept = bf16_excess = None
    for precision, policy in legs:
        cfg = dataclasses.replace(cfg0, matmul_precision=precision,
                                  remat_policy=policy)
        leg = _remat22_leg(shards, batch, cfg)
        grads = leg.pop("grads")
        name = f"{precision} {policy}"
        rows[name] = leg
        for k, (n, _) in leg["counts"].items():
            launches[k] = launches.get(k, 0) + n
        want = _remat22_want(precision, leg["kept_projections"], L)
        log(f"remat22 {name} on {card}: loss {leg['loss']!r}, step "
            f"{leg['ms']} ms (host clock, one fwd+bwd), peak above the "
            f"start {leg['peak_above_start_bytes']} bytes "
            f"({leg['peak_above_start_bytes'] / 2 ** 30:.3f} GiB), kept "
            f"{leg['kept_bytes']} bytes in {leg['kept_entries']} tensors "
            f"({leg['kept_dtypes']}), launches {json.dumps(leg['counts'])}"
            f" against {json.dumps(want)}")
        if leg["counts"] != want:
            failures.append(f"remat22 {name}: launches {leg['counts']} != "
                            f"{want}")
        if precision == "fp8_pallas" and leg["fp8_bwd_plain"] != 2 * L * len(
                PROJECTIONS):
            failures.append(f"remat22 {name}: fp8 backward products "
                            f"{leg['fp8_bwd_plain']}")
        if policy == "full":
            ref = (leg["loss"], grads, leg["peak_above_start_bytes"])
            continue
        excess = leg["peak_above_start_bytes"] - ref[2]
        unequal = [("/".join(path)) for path, a in
                   fsdp.optim.tree_leaves(grads)
                   if not torch.equal(a, fsdp.optim.tree_get(ref[1], path))]
        if policy == "save_dots":
            log(f"remat22 {name}: loss bit-equal to full's "
                f"{leg['loss'] == ref[0]}; grad leaves not bit-equal "
                f"{unequal}; peak above full's {excess} bytes")
            if leg["loss"] != ref[0] or unequal:
                failures.append(f"remat22 {name}: not bit-equal to full "
                                f"({len(unequal)} grad leaves)")
            if precision == "bf16":
                bf16_kept, bf16_excess = leg["kept_bytes"], excess
            elif precision == "int8":
                log(f"remat22 int8 save_dots: kept {leg['kept_bytes']} bytes "
                    f"of K4's bf16 outputs against the reference's int32 "
                    f"accumulators {leg['ref_acc_bytes']} bytes (ratio "
                    f"{leg['kept_bytes'] / max(leg['ref_acc_bytes'], 1):.4f})")
                if (leg["kept_projections"] != 6 * L
                        or leg["kept_dtypes"] != ["torch.bfloat16"]):
                    failures.append(f"remat22 int8 save_dots: kept "
                                    f"{leg['kept_projections']} products "
                                    f"{leg['kept_dtypes']}")
            else:
                if leg["kept_bytes"] != 0:
                    failures.append(f"remat22 {name}: {leg['kept_bytes']} "
                                    f"bytes kept beyond full's")
                if abs(excess) > REMAT22_PEAK_SLACK_BYTES:
                    failures.append(f"remat22 {name}: peak {excess} bytes "
                                    f"from full's, over "
                                    f"{REMAT22_PEAK_SLACK_BYTES}")
        else:
            rel = abs(leg["loss"] - ref[0]) / abs(ref[0])
            ratio = leg["kept_bytes"] / bf16_kept
            peak_ratio = excess / bf16_excess
            leg.update(loss_rel=rel, kept_ratio=ratio,
                       peak_excess_ratio=peak_ratio)
            log(f"remat22 {name}: |loss - full| / full {rel:.3e} (limits "
                f"{REMAT_Q8_LOSS_MIN_RTOL}, {REMAT_Q8_LOSS_RTOL}); kept "
                f"{leg['kept_bytes']} bytes against bf16 save_dots' "
                f"{bf16_kept}, ratio {ratio:.4f}; peak {excess} bytes above "
                f"full's against bf16 save_dots' {bf16_excess}, ratio "
                f"{peak_ratio:.4f} (limit {REMAT_Q8_SAVED_RATIO} each)")
            if not REMAT_Q8_LOSS_MIN_RTOL <= rel <= REMAT_Q8_LOSS_RTOL:
                failures.append(f"remat22 {name}: loss rel {rel} outside "
                                f"[{REMAT_Q8_LOSS_MIN_RTOL}, "
                                f"{REMAT_Q8_LOSS_RTOL}]")
            if not ratio <= REMAT_Q8_SAVED_RATIO:
                failures.append(f"remat22 {name}: kept bytes ratio {ratio} "
                                f"over {REMAT_Q8_SAVED_RATIO}")
            if not peak_ratio <= REMAT_Q8_SAVED_RATIO:
                failures.append(f"remat22 {name}: peak excess ratio "
                                f"{peak_ratio} over {REMAT_Q8_SAVED_RATIO}")
        del grads
    del shards, ref
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return rows, launches


def k3_group_check(cfg, card: str) -> dict:
    """K3 at ``cfg``'s GQA group (``K3_GROUP22``), a bf16 and an f32
    pool: the kernel against its plain version at ``FP.TOLERANCE``, twice
    bit-equal, and both against the f64 oracle (outputs off by more than
    atol / 4, logged)."""
    rng = np.random.default_rng(SEED + 22)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    g = K3_GROUP22
    B, page, chunk = g["slots"], g["page"], g["chunk"]
    P, nkv, hd = g["view"] // page, cfg.num_key_value_heads, \
        cfg.resolved_head_dim
    rep = cfg.num_attention_heads // nkv
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        n_pages = B * P + 1
        pk, pv = (torch.randn((n_pages, page, nkv, hd), generator=gen,
                              device="cuda", dtype=dt) for _ in range(2))
        plen = rng.integers(g["prompt"][0], g["prompt"][1] + 1, size=B)
        apos_np = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)
        pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
        apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
        qg = torch.randn((B, chunk, nkv, rep, hd), generator=gen,
                         device="cuda", dtype=dt)
        got = FP.paged_flash_prefill(qg, pk, pv, pages, apos)
        torch.cuda.synchronize()
        ref = FP.paged_flash_prefill_plain(qg, pk, pv, pages, apos)
        orc = FP.paged_flash_prefill_oracle(qg, pk, pv, pages, apos)
        atol, rtol = FP.TOLERANCE[dt]
        err = float((got - ref).abs().max())
        read = {"rep": rep, "max_abs_err": err,
                "kernel_off_oracle": FP.off_count(got, orc, atol / 4),
                "plain_off_oracle": FP.off_count(ref, orc, atol / 4)}
        out[str(dt)] = read
        log(f"flash_prefill group {rep} ({dt}) on {card}: {json.dumps(read)}"
            f" (atol {atol}, rtol {rtol}; off-counts over atol / 4 of "
            f"{got.numel()} outputs)")
        check(torch.isfinite(got).all() and torch.allclose(
            got, ref, atol=atol, rtol=rtol),
            f"flash_prefill group {rep} ({dt}): max |kernel - plain| = "
            f"{err} over atol {atol} rtol {rtol}")
        _twice_equal(f"flash_prefill group {rep} ({dt})",
                     lambda: FP.paged_flash_prefill(qg, pk, pv, pages, apos))
        del pk, pv, qg, got, ref, orc
    torch.cuda.empty_cache()
    return out


def twins22_phase(card: str, root: Path, corpus_ckpt=None) -> tuple[dict,
                                                                    dict]:
    """22b: the twins at cut depth (``MOE_BENCH22`` … ``DECODE22``), each
    path's launches read with every count set to 0 just before it.
    Gates: moe_bench's rows without error and finite; moe_profile's
    trace holding every phase, each with device time but the two a2a
    ranges (views at one rank); the long_context row without error;
    the spike demo's two legs; K3 at corpus-70m's GQA group against its
    plain version (:func:`k3_group_check`); generate_demo's greedy
    tokens equal to the engine's, K1 and K3 launched, on
    ``corpus_ckpt`` (20a's, of ``CORPUS_TRAIN`` steps) or a checkpoint
    of ``DEMO22`` steps trained here; decode_bench's slope positive
    (C14)."""
    out, paths = {}, {}

    def path(name, fn):
        _reset_all_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        paths[name] = _launches_now()
        log(f"twins22 {name} on {card}: {time.perf_counter() - t:.1f} s, "
            f"launches {json.dumps(paths[name])}")
        return res

    doc = path("moe_bench", lambda: moe_bench_run.main([
        "--rows", MOE_BENCH22, "--layers", str(MOE22_LAYERS), "--batch",
        "1", "--steps", "2", "--out-dir", str(root / "moe")]))
    out["moe_bench"] = [{k: v for k, v in r.items() if k != "losses"}
                        for r in doc["rows"]]
    check(len(doc["rows"]) == 2 and all(
        "error" not in r and all(np.isfinite(r["losses"]))
        and r["tokens_per_sec"] > 0 for r in doc["rows"]),
        f"twins22 moe_bench: rows {out['moe_bench']}")
    check(paths["moe_bench"].get("int8_matmul", 0) > 0
          and paths["moe_bench"].get("flash_attention_fwd", 0) > 0,
          f"twins22 moe_bench: launches {paths['moe_bench']}")
    row = path("moe_profile", lambda: moe_profile_run.run(
        "SMOLLM3_3B_L8", seq=8192, batch=1, steps=1, layers=MOE22_LAYERS,
        device="cuda", trace_dir=str(root / "moe_prof")))
    out["moe_profile"] = {k: v for k, v in row.items()
                          if k not in ("trace_file",)}
    us = row["phase_us"]
    check(set(moe_profile_run.PHASES) | {"other"} <= set(us)
          and all(us[p] > 0 for p in moe_profile_run.PHASES
                  if p not in MOE22_VIEW_PHASES) and us["other"] > 0,
          f"twins22 moe_profile: phases {us}")
    rows = path("long_context", lambda: long_context_run.main([
        "--seqs", str(LONG22_SEQ), "--precisions", "bf16", "--steps", "2",
        "--out-dir", str(root / "lc")]))
    out["long_context"] = [{k: v for k, v in r.items() if k != "losses"}
                           for r in rows]
    check(len(rows) == 1 and "error" not in rows[0]
          and all(np.isfinite(rows[0]["losses"])),
          f"twins22 long_context: {out['long_context']}")
    path("flagship spike demo", lambda: flagship.main([
        "--model", "smollm3-3b-l8", "--precision", "bf16",
        "--sequence-length", str(SPIKE22["seq"]), "--batch-size", "1",
        "--num-steps", str(SPIKE22["steps"]), "--warmup-steps", "1",
        "--spike-demo", "--spike-steps", str(SPIKE22["steps"]),
        "--out-dir", str(root / "flagship"), "--plot",
        str(root / "flagship_loss.png")]))
    legs = sorted(p.name for p in (root / "flagship").glob("*.json"))
    spike = [json.loads((root / "flagship" / n).read_text())["losses"]
             for n in legs]
    out["flagship spike demo"] = {"legs": legs, "losses": spike,
                                  "plot": (root / "flagship_loss.png")
                                  .exists()}
    check(len(legs) == 2 and all(np.isfinite(v).all() for v in spike),
          f"twins22 flagship: {out['flagship spike demo']}")
    cfg70 = train_fsdp.model_config(DEMO22["model"])
    out["flash_prefill group"] = k3_group_check(cfg70, card)
    ck, steps = corpus_ckpt, CORPUS_TRAIN["num_steps"]
    if ck is None:
        ck, steps = root / "ck70", DEMO22["steps"]
        path("corpus-70m checkpoint", lambda: flagship.run_leg(
            DEMO22["model"], "bf16", DEMO22["seq"], DEMO22["bs"], steps, 1,
            3e-4, device="cuda", ckpt_dir=str(ck), data="corpus"))
    demo = path("generate_demo --serve", lambda: generate_demo_run.main([
        "--model", DEMO22["model"], "--ckpt-dir", str(ck), "--serve",
        "--out-file", str(root / "demo.json")]))
    out["generate_demo"] = {k: demo[k] for k in (
        "restored_step", "samples", "sample_ids", "serve_matches_greedy")}
    g = paths["generate_demo --serve"]
    check(demo["restored_step"] == steps and demo["serve_matches_greedy"]
          and g.get("paged_decode", 0) > 0 and g.get("flash_prefill", 0) > 0,
          f"twins22 generate_demo: step {demo['restored_step']} (want "
          f"{steps}), serve tokens equal generate's "
          f"{demo['serve_matches_greedy']}, launches {g}")
    dec = path("decode_bench", lambda: decode_bench_run.main(
        DECODE22 + ["--out-dir", str(root / "decode")]))
    out["decode_bench"] = dec
    check(len(dec) == 1 and dec[0].get("failed_reading") is None
          and dec[0]["steady_ms_per_step"] > 0,
          f"twins22 decode_bench (C14): {dec}")
    return out, {f"22: {k}": v for k, v in paths.items() if v}


def phase22(card: str, corpus_ckpt=None) -> tuple[dict, dict]:
    """Phase 22 (the model core's rest): 22a and 22b under a temporary
    directory removed at the end; ``corpus_ckpt``: 20a's checkpoint, for
    22b's generate_demo."""
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="phase22_"))
    try:
        a, la = remat22_phase(card)
        b, lb = twins22_phase(card, root, corpus_ckpt)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t22
    log(f"phase 22 (the model core's rest: the remat policies at the "
        f"kernels' precisions, the twins): {wall:.1f} s")
    return {"remat": a, "twins": b, "wall_s": wall}, {"22: remat": la, **lb}


# ------------------------------------------- parent-versus-change timing

def _parent_libs(csrc: Path) -> dict:
    """K1's, K2's, K3's, K4/K5's, K6's, K7's and the flash attention's
    libraries built from another commit's ``csrc`` (one nvcc each, in
    parallel) into ``build/parent_kernels``, with that commit's C
    signatures (K1 then took a scratch buffer of
    ``paged_decode_scratch_floats``; K2's, four passes, a scratch of
    ``paged_decode_q8_scratch_floats`` always nonzero; K4 had no
    GEMV)."""
    out = loader.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("paged_decode", "paged_decode_q8", "flash_prefill",
                 "fp8_matmul", "flash_attention", "int8_matmul",
                 "ag_matmul"):
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [loader._nvcc(), *loader.NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"parent {name}: nvcc failed:\n{text}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["flash_prefill"].flash_prefill_launch.argtypes = [P] * 6 + [I] * 8 \
        + [P]
    libs["fp8_matmul"].fp8_matmul_launch.argtypes = [P] * 7 + [I] * 3 + [P]
    libs["flash_attention"].flash_attn_bwd_launch.argtypes = [P] * 10 \
        + [I] * 5 + [F, P]
    libs["flash_attention"].flash_attn_fwd_launch.argtypes = [P] * 5 \
        + [I] * 5 + [F, P]
    libs["paged_decode"].paged_decode_launch.argtypes = [P] * 7 + [I] * 7 \
        + [P]
    libs["paged_decode"].paged_decode_scratch_floats.argtypes = [I] * 6
    libs["paged_decode"].paged_decode_scratch_floats.restype = \
        ctypes.c_int64
    libs["paged_decode_q8"].paged_decode_q8_launch.argtypes = [P] * 10 \
        + [I] * 6 + [P]
    libs["paged_decode_q8"].paged_decode_q8_scratch_floats.argtypes = \
        [I] * 6
    libs["paged_decode_q8"].paged_decode_q8_scratch_floats.restype = \
        ctypes.c_int64
    libs["int8_matmul"].int8_matmul_launch.argtypes = [P] * 5 + [I] * 4 \
        + [P]
    libs["int8_matmul"].int8_matmul_fused_launch.argtypes = [P] * 6 \
        + [I] * 3 + [P]
    libs["ag_matmul"].ag_matmul_launch.argtypes = [P] * 3 + [I] * 4 + [P]
    return libs


def _turns(old, new, timer=time_ms) -> tuple[list, list]:
    """CUDA-event times in turns: old, new, new, old."""
    a, b = timer(old), timer(new)
    c, d = timer(new), timer(old)
    return [a, d], [b, c]


def _compare_gemms(libs, ptr, stream, gen) -> dict:
    """--parent-csrc for K7 (one layer's seven projections at M = 8192
    and the four-rank chunks), K5 and K4's training products (the
    seven projections' forward, dX and dW at M = 8192; K5 in CUDA-graph
    replays) and K4 at decode (M = 8, the seven projections and the
    unembedding, CUDA-graph replays): each build gated against the plain
    version (K7 at its tolerance, K4 and K5 bit for bit) and timed in
    turns.  The parent's
    K4 takes each operand as its wrapper passed it: dW's A as a
    transposed copy of X's (M, K) codes, made in the timed call."""
    res, bf16 = {}, torch.bfloat16
    M = TRAIN["seq"] * TRAIN["bs"]

    def launched(name, rc):
        check(rc == 0, f"parent {name}: CUDA error {rc}")

    # K7: the same operands for both builds, the chunk a strided view
    atol, rtol = C.TOLERANCE[bf16]
    tot = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    chunks, seen = {}, {}
    for name, K, Kc, N in [(n, K, K, N) for n, K, N in PROJECTIONS] \
            + AG_CHUNKS:
        if (K, Kc, N) not in seen:
            ops = []
            for i in range(3):
                a = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
                w = (torch.randn((Kc, N), generator=gen, device="cuda")
                     * 0.02).to(bf16)
                c0 = (i + 1) % (K // Kc) * Kc
                ops.append((a[:, c0:c0 + Kc], w))
            o7 = torch.empty((M, N), device="cuda", dtype=bf16)

            def old_k7(a2, w, o7=o7, N=N, Kc=Kc):
                launched("ag_matmul", libs["ag_matmul"].ag_matmul_launch(
                    ptr(a2), ptr(w), ptr(o7), M, N, Kc, a2.stride(0),
                    stream()))
                return o7

            ref = C.ag_matmul_plain(*ops[0])
            ratios = {}
            for nm, fn in (("parent", old_k7), ("change", C.ag_matmul_kernel)):
                ratios[nm] = gate_ratio(fn(*ops[0]), ref, atol, rtol)
                check(ratios[nm] <= 1.0, f"compare ag_matmul {nm}: ({M}, "
                      f"{Kc}) x ({Kc}, {N}) gate ratio {ratios[nm]:.3f}")
            it = iter(range(10 ** 9))
            old, new = _turns(lambda: old_k7(*ops[next(it) % 3]),
                              lambda: C.ag_matmul_kernel(*ops[next(it) % 3]))
            seen[(K, Kc, N)] = (old, new)
            log(f"compare ag_matmul ({M}, {Kc}) x ({Kc}, {N})"
                f"{', a strided' if Kc < K else ''}: parent {old} ms, change "
                f"{new} ms; gate ratios {json.dumps(ratios)}")
            del ops, ref, o7
            torch.cuda.empty_cache()
        old, new = seen[(K, Kc, N)]
        if Kc < K:
            chunks[name] = {"parent_ms": old, "change_ms": new}
            continue
        tot["parent"] = [a + b for a, b in zip(tot["parent"], old)]
        tot["change"] = [a + b for a, b in zip(tot["change"], new)]
    res["ag_matmul"] = {"parent_ms": tot["parent"],
                        "change_ms": tot["change"],
                        "four_rank_chunks": chunks}
    log(f"compare ag_matmul, one layer's 7 projections: parent "
        f"{tot['parent']} ms, change {tot['change']} ms")

    # K5 and K4's training products
    lib8 = libs["int8_matmul"]
    t5 = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    t4 = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    for name, K, N in PROJECTIONS:
        sets = []
        for _ in range(3):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            g = (torch.randn((M, N), generator=gen, device="cuda")
                 * 1e-3).to(bf16)
            wq_t, ws_t = Q.quantize_int8(w.t(), axis=-1)
            gq, gs = Q.quantize_int8(g, axis=-1)
            wq_n, ws_n = Q.quantize_int8(w, axis=1)
            xq_t, xs_t = Q.quantize_int8(x.t(), axis=-1)
            gq_t, gs_t = Q.quantize_int8(g.t(), axis=-1)
            sets.append(dict(
                x=x, wq_t=wq_t, ws_t=ws_t,
                dx=(gq, gs, wq_n, ws_n.T, (1, 1)),
                dw=(xq_t, xs_t, gq_t, gs_t.T, (1, 1)),
                # the parent's dW operands: X's and g's (M, ·) codes
                xq_m=xq_t.t().contiguous(), gq_m=gq_t.t().contiguous()))
            del w, g
        codes = torch.empty((M, K), dtype=torch.int8, device="cuda")
        xs5 = torch.empty((M,), device="cuda")
        out = {"x": torch.empty((M, N), device="cuda", dtype=bf16),
               "dx": torch.empty((M, K), device="cuda", dtype=bf16),
               "dw": torch.empty((K, N), device="cuda", dtype=bf16)}

        def old_k5(d):
            launched("int8_matmul_fused", lib8.int8_matmul_fused_launch(
                ptr(d["x"]), ptr(d["wq_t"]), ptr(codes), ptr(xs5),
                ptr(d["ws_t"]), ptr(out["x"]), M, N, K, stream()))
            return out["x"]

        def new_k5(d):
            return Q.int8_matmul_fused_kernel(d["x"], d["wq_t"], d["ws_t"],
                                              b_kmajor=True)

        def old_k4(d, prod):
            if prod == "dx":
                gq, gs, wq_n, ws_n, _ = d["dx"]
                a, b, sa, sb, Mo, No, Kc, kmaj = (gq, wq_n, gs, ws_n, M, K,
                                                  N, 1)
            else:   # the parent's wrapper copied X's codes transposed
                _, xs_t, _, gs_n, _ = d["dw"]
                a, b, sa, sb, Mo, No, Kc, kmaj = (
                    d["xq_m"].t().contiguous(), d["gq_m"], xs_t, gs_n, K, N,
                    M, 0)
            launched("int8_matmul", lib8.int8_matmul_launch(
                ptr(a), ptr(b), ptr(sa), ptr(sb), ptr(out[prod]), Mo, No, Kc,
                kmaj, stream()))
            return out[prod]

        s0 = sets[0]
        ref = Q.int8_matmul_fused(s0["x"], s0["wq_t"].t(), s0["ws_t"].T, bf16)
        for nm, fn in (("parent", old_k5), ("change", new_k5)):
            _gate_bitwise(f"compare int8_matmul_fused {nm}", name, fn(s0),
                          ref)
        # in graph replays: the change launches through its wrapper, the
        # parent straight into its C function, and the host work between
        # launches would otherwise count against the change
        it = iter(range(10 ** 9))
        old, new = _turns(lambda: old_k5(sets[next(it) % 3]),
                          lambda: new_k5(sets[next(it) % 3]), graph_ms)
        t5["parent"] = [a + b for a, b in zip(t5["parent"], old)]
        t5["change"] = [a + b for a, b in zip(t5["change"], new)]
        log(f"compare int8_matmul_fused {name} ({M}, {K}) x ({K}, {N}): "
            f"parent {old} ms, change {new} ms")
        for prod in ("dx", "dw"):
            ref = Q._int8_dot(*s0[prod], bf16, plain=True)
            for nm, fn in (("parent", lambda d: old_k4(d, prod)),
                           ("change", lambda d: Q._int8_dot(
                               *d[prod], bf16, plain=False))):
                _gate_bitwise(f"compare int8_matmul {nm}",
                              f"{name} {prod}", fn(s0), ref)
            it = iter(range(10 ** 9))
            old, new = _turns(
                lambda: old_k4(sets[next(it) % 3], prod),
                lambda: Q._int8_dot(*sets[next(it) % 3][prod], bf16,
                                    plain=False))
            t4["parent"] = [a + b for a, b in zip(t4["parent"], old)]
            t4["change"] = [a + b for a, b in zip(t4["change"], new)]
            log(f"compare int8_matmul {name} {prod}: parent {old} ms, change "
                f"{new} ms")
        del sets, ref, codes, out
        torch.cuda.empty_cache()
    res["int8_matmul_fused"] = {"parent_ms": t5["parent"],
                                "change_ms": t5["change"]}
    res["int8_matmul"] = {"parent_ms": t4["parent"],
                          "change_ms": t4["change"]}
    log(f"compare int8_matmul_fused, one layer's 7 projections: parent "
        f"{t5['parent']} ms, change {t5['change']} ms; int8_matmul, the 14 "
        f"backward products: parent {t4['parent']} ms, change "
        f"{t4['change']} ms")

    # K4 at decode, M = 8: the parent's mma.sync against the GEMV
    Md = ENGINE["max_batch"]
    td = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    for name, K, N in K4_DECODE_SHAPES:
        sets = _decode_operands(gen, Md, K, N)
        o4 = torch.empty((Md, N), device="cuda", dtype=bf16)

        def old_dec(xq, xs, wq, ws, o4=o4, N=N, K=K):
            launched("int8_matmul", lib8.int8_matmul_launch(
                ptr(xq), ptr(wq), ptr(xs), ptr(ws), ptr(o4), Md, N, K, 0,
                stream()))
            return o4

        ref = Q.int8_matmul(*sets[0], bf16)
        for nm, fn in (("parent", old_dec), ("change", Q.int8_matmul_kernel)):
            _gate_bitwise(f"compare int8_matmul decode {nm}", name,
                          fn(*sets[0]), ref)
        it = iter(range(10 ** 9))
        old, new = _turns(lambda: old_dec(*sets[next(it) % 3]),
                          lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]),
                          graph_ms)
        log(f"compare int8_matmul decode {name} ({Md}, {K}) x ({K}, {N}): "
            f"parent {old} ms, change {new} ms (graph replays)")
        if name == "unembed":
            res["int8_matmul_unembed"] = {"parent_ms": old, "change_ms": new}
        else:
            td["parent"] = [a + b for a, b in zip(td["parent"], old)]
            td["change"] = [a + b for a, b in zip(td["change"], new)]
        del sets, ref, o4
    torch.cuda.empty_cache()
    res["int8_matmul_decode"] = {"parent_ms": td["parent"],
                                 "change_ms": td["change"]}
    log(f"compare int8_matmul decode, one layer's 7 projections: parent "
        f"{td['parent']} ms, change {td['change']} ms (graph replays)")
    return res


@contextlib.contextmanager
def _engine_decode(attend):
    """The engine's paged decode attention replaced by ``attend``."""
    saved, E.paged_attention_decode = E.paged_attention_decode, attend
    try:
        yield
    finally:
        E.paged_attention_decode = saved


def _compare_k2(lib, ptr, stream) -> dict:
    """--parent-csrc for K2: at q8_decode_phase's shapes (drawn from
    ``SEED``) each build against the plain version at
    ``PA.TOLERANCE_Q8`` and twice bit-equal, both timed in CUDA-graph
    replays in turns; then the int8 serve's decode step
    (:func:`decode_step_profile`, over 8 prompts of the serve's lengths
    drawn from ``SEED + 12``) with either build's K2 as the engine's, in
    turns, its device time read by ``torch.profiler``."""
    def old_k2(qq, kq, vq, pages, apos, *, q_scale, pk_s, pv_s):
        """The parent's K2 as its wrapper launched it (a scratch a
        call), counted in ``PA.Q8_COUNTS``."""
        B, _, nkv, rep, hd = qq.shape
        geom = (B, pages.shape[1], kq.shape[1], nkv, rep, hd)
        scratch = torch.empty(lib.paged_decode_q8_scratch_floats(*geom),
                              device="cuda")
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = lib.paged_decode_q8_launch(
            ptr(qq), ptr(q_scale), ptr(kq), ptr(vq), ptr(pk_s), ptr(pv_s),
            ptr(pages), ptr(apos), ptr(scratch), ptr(out), *geom, stream())
        check(rc == 0, f"parent paged_decode_q8: CUDA error {rc}")
        PA.Q8_COUNTS.launches += 1
        return out

    builds = {"parent": old_k2, "change": PA.paged_attention_decode}
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qq, qs, pools, pages, apos, _ = _q8_decode_inputs(rng, gen)
    ref = PA.paged_attention_plain_q8(qq, qs, pools[0][0], pools[0][2],
                                      pools[0][1], pools[0][3], pages, apos)
    res = {"max_abs_err": {}, "gate_ratio": {}}
    calls = {}
    for nm, fn in builds.items():
        calls[nm] = lambda kq, ks, vq, vs, fn=fn: fn(
            qq, kq, vq, pages, apos, q_scale=qs, pk_s=ks, pv_s=vs)
        got = calls[nm](*pools[0])
        torch.cuda.synchronize()
        err, ratio = _q8_reading(f"compare paged_decode_q8 {nm}", got, ref)
        res["max_abs_err"][nm], res["gate_ratio"][nm] = err, ratio
        _twice_equal(f"compare paged_decode_q8 {nm}",
                     lambda: calls[nm](*pools[0]))
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: calls["parent"](*pools[next(it) % 4]),
                      lambda: calls["change"](*pools[next(it) % 4]), graph_ms)
    res.update(parent_ms=old, change_ms=new)
    log(f"compare paged_decode_q8 (serve shapes): parent {old} ms, change "
        f"{new} ms (graph replays; turns: parent, change, change, parent)")
    del pools, ref
    torch.cuda.empty_cache()

    # the int8 serve's decode step with either K2, in turns
    params_q8 = quantize_decode_params(build_params(), CFG)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 12)
    eng = E.ServingEngine(params_q8, CFG, **INT8_ENGINE)
    reqs = [eng.submit(rng.integers(1, CFG.vocab_size, size=int(
        rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32),
        max_new_tokens=NEW_TOKENS) for _ in range(N_REQUESTS)]
    steps = {"parent": [], "change": []}
    want = DECODE_PROFILE_STEPS * CFG.num_hidden_layers
    for nm in ("parent", "change", "change", "parent"):
        PA.Q8_COUNTS.reset()
        with _engine_decode(builds[nm]):
            reading = decode_step_profile(eng, reqs, f"compare int8 serve, "
                                          f"{nm} K2", False)
        check(PA.Q8_COUNTS.launches == want,
              f"compare int8 decode step: {PA.Q8_COUNTS.launches} {nm} K2 "
              f"launches, not {want}")
        steps[nm].append(reading)
    res["int8_decode_step"] = steps
    for key in ("device_busy_ms", "paged_decode_ms"):
        log(f"compare int8 decode step, {key} a step (turns): parent "
            f"{[r[key] for r in steps['parent']]}, change "
            f"{[r[key] for r in steps['change']]}")
    del eng, reqs, params_q8
    torch.cuda.empty_cache()
    return res


def parent_compare_phase(csrc: Path) -> dict:
    """K7, K5 and K4 (:func:`_compare_gemms`), K1, K2
    (:func:`_compare_k2`) and K3 at the kernel phase's serve shapes, K6
    at one layer's
    seven projections (M = 8192) and the flash attention's backward and
    forward at the training shape (B 1, S 8192, 16 / 4 heads, hd 128),
    each built from
    this checkout and from ``csrc`` (another commit's sources) and timed
    in one process in turns (old, new, new, old).  Both builds are gated
    against their plain versions at their modules' tolerances; K3 over
    the multi-draw reading (:func:`k3_draws_reading`) and the forward
    over its oracle reading (:func:`fa_oracle_reading`) as well, whose
    counts against the oracle gate the change and are logged for the
    parent.  Then SMOLLM3_3B serves 8 requests with either build's K1 as
    the engine's paged decode (:func:`_serve_reading`), in
    ``SERVE_ROUNDS`` rounds of the same turns after one warm-up serve."""
    libs = _parent_libs(csrc)
    ptr, stream = (lambda t: ctypes.c_void_p(t.data_ptr())), (
        lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = _compare_gemms(libs, ptr, stream,
                         torch.Generator(device="cuda").manual_seed(SEED + 4))

    # K3, as kernel_phase draws it
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    chunk = ENGINE["prefill_chunk"]
    apos_np = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)
    pools = _pools(gen, B * P + 1, page, nkv, hd, 4)
    apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
    pages = _page_table(rng, apos_np.max(axis=1), page, P, B * P + 1)
    qg = torch.randn((B, chunk, nkv, rep, hd), generator=gen, device="cuda",
                     dtype=CFG.dtype)

    def old_k3_on(qg, pk, pv, pages, apos):
        out = torch.empty(qg.shape, device="cuda")
        rc = libs["flash_prefill"].flash_prefill_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(out),
            qg.shape[0], qg.shape[1], pages.shape[1], pk.shape[1], nkv, rep,
            hd, 1, stream())
        check(rc == 0, f"parent flash_prefill: CUDA error {rc}")
        return out

    it = iter(range(10 ** 9))
    old, new = _turns(
        lambda: old_k3_on(qg, *pools[next(it) % 4], pages, apos),
        lambda: FP.paged_flash_prefill(qg, *pools[next(it) % 4], pages,
                                       apos))
    res["flash_prefill"] = {"parent_ms": old, "change_ms": new}
    log(f"compare flash_prefill (serve shapes): parent {old} ms, change "
        f"{new} ms (turns: parent, change, change, parent)")
    del pools
    torch.cuda.empty_cache()
    res["flash_prefill"].update(k3_draws_reading(
        {"parent": old_k3_on, "change": FP.paged_flash_prefill},
        "compare flash_prefill", gated=("change",)))

    # K6, one layer's seven projections; the weight's codes K-major, the
    # layout both builds' C functions take
    M, bf16 = TRAIN["seq"] * TRAIN["bs"], torch.bfloat16
    atol, rtol = Q.TOLERANCE[bf16]
    tot_old, tot_new = [0.0, 0.0], [0.0, 0.0]
    for name, K, N in PROJECTIONS:
        sets = []
        for _ in range(3):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            sets.append((*Q.quantize_fp8(x), *Q.quantize_fp8_kmajor(w)))
        o6 = torch.empty((M, N), device="cuda", dtype=bf16)
        # the codes as bf16, the prologue's scratch
        a16 = torch.empty((M, K), device="cuda", dtype=bf16)
        b16 = torch.empty((N, K), device="cuda", dtype=bf16)
        it = iter(range(10 ** 9))

        def old_k6():
            aq, a_s, bt, b_s = sets[next(it) % 3]
            rc = libs["fp8_matmul"].fp8_matmul_launch(
                ptr(aq), ptr(bt), ptr(a_s), ptr(b_s), ptr(a16), ptr(b16),
                ptr(o6), M, N, K, stream())
            check(rc == 0, f"parent fp8_matmul: CUDA error {rc}")
            return o6

        def new_k6():
            aq, a_s, bt, b_s = sets[next(it) % 3]
            return Q.fp8_matmul_kernel(aq, a_s, bt, b_s)

        aq, a_s, bt, b_s = sets[0]
        ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, bf16)
        ratios = {}
        for nm, fn in (("parent", old_k6), ("change", new_k6)):
            it = iter(range(0, 10 ** 9, 3))
            ratios[nm] = gate_ratio(fn(), ref, atol, rtol)
            check(ratios[nm] <= 1.0, f"compare fp8_matmul {nm}: ({M}, {K}) x "
                  f"({K}, {N}) gate ratio {ratios[nm]:.3f}")
        it = iter(range(10 ** 9))
        old, new = _turns(old_k6, new_k6)
        tot_old = [a + b for a, b in zip(tot_old, old)]
        tot_new = [a + b for a, b in zip(tot_new, new)]
        log(f"compare fp8_matmul {name} ({M}, {K}) x ({K}, {N}): parent "
            f"{old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
        del sets, ref, a16, b16
        torch.cuda.empty_cache()
    res["fp8_matmul"] = {"parent_ms": tot_old, "change_ms": tot_new}
    log(f"compare fp8_matmul, one layer's 7 projections: parent {tot_old} "
        f"ms, change {tot_new} ms")

    # the flash attention's backward at the training shape, from the
    # change's forward (the forward is the same code in both)
    Bt, S = TRAIN["bs"], TRAIN["seq"]
    nq, nkv_t = TRAIN_CFG.num_attention_heads, TRAIN_CFG.num_key_value_heads
    scale = hd ** -0.5
    mk = lambda n: torch.randn((Bt, S, n, hd), generator=gen,  # noqa: E731
                               device="cuda").to(bf16)
    sets = []
    for _ in range(3):
        q, k, v, do = mk(nq), mk(nkv_t), mk(nkv_t), mk(nq)
        sets.append((q, k, v, *FA.flash_attention_fwd(q, k, v, scale), do))
    it = iter(range(10 ** 9))

    def old_bwd():
        q, k, v, o, lse, do = sets[next(it) % 3]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dvec = torch.empty_like(lse)
        rc = libs["flash_attention"].flash_attn_bwd_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dvec),
            ptr(dq), ptr(dk), ptr(dv), Bt, S, nq, nkv_t, hd, scale, stream())
        check(rc == 0, f"parent flash_attention_bwd: CUDA error {rc}")
        return dq, dk, dv

    def new_bwd():
        return FA.flash_attention_bwd(*sets[next(it) % 3], scale)

    q, k, v, _, _, do = sets[0]
    ref_g = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    ratios = {}
    for nm, fn in (("parent", old_bwd), ("change", new_bwd)):
        it = iter(range(0, 10 ** 9, 3))
        ratios[nm] = max(_fa_reading(f"compare flash_attention_bwd {nm}", g,
                                     got, r, "bwd")[1]
                         for g, got, r in zip(("dq", "dk", "dv"), fn(), ref_g))
        check(ratios[nm] <= 1.0, f"compare flash_attention_bwd {nm}: gate "
              f"ratio {ratios[nm]:.3f}")
    del ref_g
    it = iter(range(10 ** 9))
    old, new = _turns(old_bwd, new_bwd)
    res["flash_attention_bwd"] = {"parent_ms": old, "change_ms": new,
                                  "gate_ratio": ratios}
    log(f"compare flash_attention_bwd (B {Bt}, S {S}, {nq}/{nkv_t} heads): "
        f"parent {old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
    del sets
    torch.cuda.empty_cache()

    # the flash attention's forward at the training shape
    def old_fwd_on(q, k, v, scale):
        o, lse = torch.empty_like(q), torch.empty(
            (q.shape[0], nq, q.shape[1]), device="cuda")
        rc = libs["flash_attention"].flash_attn_fwd_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), q.shape[0], q.shape[1],
            nq, nkv_t, hd, scale, stream())
        check(rc == 0, f"parent flash_attention_fwd: CUDA error {rc}")
        return o, lse

    sets = [(mk(nq), mk(nkv_t), mk(nkv_t)) for _ in range(3)]
    q, k, v = sets[0]
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    ratios = {}
    for nm, fn in (("parent", old_fwd_on), ("change", FA.flash_attention_fwd)):
        o, lse = fn(q, k, v, scale)
        e_lse = float((lse - ref_lse).abs().max())
        ratios[nm] = max(_fa_reading(f"compare flash_attention_fwd {nm}", "O",
                                     o, ref_o, "fwd")[1], e_lse / FA.LSE_ATOL)
        check(ratios[nm] <= 1.0, f"compare flash_attention_fwd {nm}: gate "
              f"ratio {ratios[nm]:.3f}")
    del ref_o, ref_lse, o, lse
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: old_fwd_on(*sets[next(it) % 3], scale),
                      lambda: FA.flash_attention_fwd(*sets[next(it) % 3],
                                                     scale))
    res["flash_attention_fwd"] = {"parent_ms": old, "change_ms": new,
                                  "gate_ratio": ratios}
    log(f"compare flash_attention_fwd (B {Bt}, S {S}, {nq}/{nkv_t} heads): "
        f"parent {old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
    del sets
    torch.cuda.empty_cache()
    res["flash_attention_fwd"].update(fa_oracle_reading(
        {"parent": old_fwd_on, "change": FA.flash_attention_fwd},
        "compare flash_attention_fwd", gated=("change",)))

    # K1 at the kernel phase's serve shapes: one row per slot somewhere in
    # its 64 decode steps
    rng = np.random.default_rng(SEED + 3)
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    dec = plen + rng.integers(0, NEW_TOKENS, size=B)
    pools = _pools(gen, B * P + 1, page, nkv, hd, 4)
    apos = torch.as_tensor(dec[:, None].astype(np.int32), device="cuda")
    pages = _page_table(rng, dec, page, P, B * P + 1)
    qg = torch.randn((B, 1, nkv, rep, hd), generator=gen, device="cuda",
                     dtype=CFG.dtype)
    geom = (B, P, page, nkv, rep, hd)
    scratch = torch.empty(
        libs["paged_decode"].paged_decode_scratch_floats(*geom),
        device="cuda")

    def old_k1_on(pk, pv):
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = libs["paged_decode"].paged_decode_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(scratch),
            ptr(out), *geom, 1, stream())
        check(rc == 0, f"parent paged_decode: CUDA error {rc}")
        return out

    ref = PA.paged_attention_plain(qg, *pools[0], pages, apos)
    atol, rtol = PA.TOLERANCE[CFG.dtype]
    errs = {}
    for nm, fn in (("parent", old_k1_on), ("change", lambda pk, pv:
                   PA.paged_attention_decode(qg, pk, pv, pages, apos))):
        got = fn(*pools[0])
        errs[nm] = float((got - ref).abs().max())
        check(torch.allclose(got, ref, atol=atol, rtol=rtol),
              f"compare paged_decode {nm}: max |kernel - plain| = "
              f"{errs[nm]} over atol {atol} rtol {rtol}")
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: old_k1_on(*pools[next(it) % 4]),
                      lambda: PA.paged_attention_decode(
                          qg, *pools[next(it) % 4], pages, apos), graph_ms)
    res["paged_decode"] = {"parent_ms": old, "change_ms": new,
                           "max_abs_err": errs}
    log(f"compare paged_decode (serve shapes): parent {old} ms, change {new}"
        f" ms (graph replays); max |kernel - plain| {json.dumps(errs)}")
    del pools, scratch
    torch.cuda.empty_cache()

    res["paged_decode_q8"] = _compare_k2(libs["paged_decode_q8"], ptr,
                                         stream)

    def old_k1_serve(qg, pk, pv, pages, apos):
        """The parent's K1 as its wrapper launched it (a scratch a call)."""
        code = PA.check_cuda_operands(
            "paged_attention_decode", {"qg": qg, "pk": pk, "pv": pv},
            {"pages": pages, "apos": apos})
        B, _, nkv, rep, hd = qg.shape
        geom = (B, pages.shape[1], pk.shape[1], nkv, rep, hd)
        scratch = torch.empty(
            libs["paged_decode"].paged_decode_scratch_floats(*geom),
            device="cuda")
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = libs["paged_decode"].paged_decode_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(scratch),
            ptr(out), *geom, code, stream())
        check(rc == 0, f"parent paged_decode: CUDA error {rc}")
        PA.COUNTS.launches += 1
        return out

    params = build_params()
    serve = {"parent": [], "change": []}
    k1 = {"parent": old_k1_serve, "change": PA.paged_attention_decode}
    # the first serve warms the allocator and the libraries; then
    # SERVE_ROUNDS rounds of turns: the host clock spreads between serves
    order = ["change"] + ["parent", "change", "change", "parent"] \
        * SERVE_ROUNDS
    for i, nm in enumerate(order):
        reading = _serve_reading(params, k1[nm])
        if i:
            serve[nm].append(reading)
        log(f"compare serve ({'warm-up, ' if not i else ''}{nm} K1): "
            f"{json.dumps(reading)}")
    for nm, rs in serve.items():
        log(f"compare serve, {nm} K1 over {len(rs)} serves: medians "
            + json.dumps({k: statistics.median(r[k] for r in rs)
                          for k in rs[0]}))
    res["serve"] = serve
    del params
    torch.cuda.empty_cache()
    return res


def _serve_reading(params, attend) -> dict:
    """The serve phase's requests (the same prompts every call) through a
    fresh engine whose paged decode is ``attend``: the decode step on the
    host clock, TTFT p50 and tokens a second."""
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    with _engine_decode(attend):
        eng = E.ServingEngine(params, CFG, **ENGINE)
        for p in prompts:
            eng.submit(p, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        PA.COUNTS.reset()
        eng.run()
        torch.cuda.synchronize()
    steps = eng.stats["decode_steps"]
    check(PA.COUNTS.launches == steps * CFG.num_hidden_layers,
          f"compare serve: {PA.COUNTS.launches} K1 launches for {steps} "
          "decode steps")
    slo = eng.slo_report()
    return {"decode_step_ms": slo["scheduler"]["decode_ms_total"] / steps,
            "ttft_p50_ms": slo["ttft_ms"]["p50"],
            "tokens_per_s": slo["tokens_per_s"]}


def cyclic_card_bytes() -> int:
    """The card memory that only reference cycles held: a full
    collection here, and the allocated bytes it freed."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    return before - torch.cuda.memory_allocated()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="time K7, K4, K5, K1, K2, K3, K6 and the flash "
                    "attention built from this csrc directory (an unpacked "
                    "parent commit) against this checkout's, the int8 "
                    "decode step with either K2 and the serve with either "
                    "K1, in turns, and run nothing else")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: the smoke runs on the card",
              file=sys.stderr)
        return 2
    # the plain paths are f32 oracles: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    if args.parent_csrc is not None:
        try:
            res = parent_compare_phase(args.parent_csrc.resolve())
        except SmokeFailure as e:
            print(f"[smoke] FAILED: {e}", file=sys.stderr)
            return 1
        print(card, flush=True)
        print(json.dumps({"compare": res}), flush=True)
        return 0
    t_all = t = time.perf_counter()
    loader.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, text in loader.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    walls, cyclic = {}, {}
    corpus_ckpt = None   # 20a's checkpoint, removed at the end
    # torch.utils.checkpoint imports torch._dynamo at its first call, and
    # that import leaves the calling frames in a reference cycle, once a
    # process; imported here, it holds nothing of a phase's
    importlib.import_module("torch._dynamo")

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {walls[name]} s")
        cyclic[name] = cyclic_card_bytes()
        check(cyclic[name] <= CYCLIC_LIMIT_BYTES,
              f"cyclic garbage: phase {name} left {cyclic[name]} bytes of "
              f"card memory held only by reference cycles, over "
              f"{CYCLIC_LIMIT_BYTES}")
        return out

    L, L8 = CFG.num_hidden_layers, INT8_TRAIN_CFG.num_hidden_layers
    try:
        kernels = timed("kernels K1 K3", kernel_phase, rng, gen)
        kernels.append(timed("kernel K2", q8_decode_phase, rng, gen))
        kernels.extend(timed("kernels K4 K5", int8_gemm_phase))
        kernels.append(timed("kernel K6", fp8_phase))
        kernels.extend(timed("kernels FA", attention_phase))
        timed("FA backward oracle", fa_bwd_oracle_gate)
        new_shapes = timed("kernels at phase 20's shapes", new_shapes_phase)
        kernels.append(timed("kernel K7", ag_matmul_phase))
        local = timed("kernels K1 K2 K3 on local heads", local_heads_phase)
        for k in kernels:
            mine = {key.split("@")[1]: v for key, v in local.items()
                    if key.split("@")[0] == k["name"]}
            if mine:
                k["local_heads"] = mine
            if k["name"] in new_shapes:
                k["new_shapes"] = new_shapes[k["name"]]
        params = timed("SMOLLM3_3B params", build_params)
        eng, reqs, launches = timed("serve", serve_phase, params, rng, card)
        # phase 18b serves the same requests, beside this serve's report
        serve_prompts, vanilla = [r.prompt for r in reqs], eng.slo_report()
        # phase 19d and 19e hold their tokens to this serve's
        serve = (serve_prompts, [list(r.tokens) for r in reqs])
        timed("parity", parity_phase, params, reqs, eng)
        timed("decode profile", decode_step_profile, eng, reqs, "serve",
              ENGINE["flash_prefill"])
        # round 4 of the serve, as the int8 profile: the whole run under
        # the profiler took 51 s of the smoke's limit, rounds 4-5 of the
        # int8 serve 49 s
        timed("profile", profile_phase, params, rng, None, "serve", (4, 1))
        del eng, reqs
        params_q8 = timed("int8 params", quantize_decode_params, params, CFG)
        del params
        torch.cuda.empty_cache()
        eng, reqs, q8_counts = timed("int8 serve", int8_serve_phase,
                                     params_q8, rng, card)
        timed("int8 parity", int8_parity_phase, params_q8, reqs, eng)
        q8 = ([r.prompt for r in reqs], [list(r.tokens) for r in reqs])
        timed("int8 decode profile", decode_step_profile, eng, reqs,
              "int8 serve", INT8_ENGINE["flash_prefill"])
        timed("int8 profile", profile_phase, params_q8, rng, INT8_ENGINE,
              "int8 serve", (4, 1))
        del eng, reqs, params_q8
        torch.cuda.empty_cache()
        loss0 = timed("train parity", train_parity_phase)
        fp8 = timed("train", train_phase, card, loss0)
        loss0 = timed("int8 train parity", int8_train_parity_phase)
        i8 = timed("int8 train", train_phase, card, loss0, INT8_TRAIN,
                   INT8_TRAIN_CFG, {
                       "int8_matmul_fused": (Q.INT8_FUSED_COUNTS,
                                             L8 * len(PROJECTIONS) * 2),
                       "int8_matmul": (Q.INT8_COUNTS,
                                       L8 * len(PROJECTIONS) * 2),
                       "flash_attention_fwd": (FA.FWD_COUNTS, L8 * 2),
                       "flash_attention_bwd": (FA.BWD_COUNTS, L8)},
                   "int8 train")
        loss0 = timed("fsdp train parity", fsdp_train_parity_phase)
        fs, fs_sync = timed("fsdp train", fsdp_train_phase, card, loss0)
        ddp_zero = timed("ddp and zero", ddp_zero_phase, card)
        pipe_toy = timed("pipeline toy", pipeline_toy_phase, card)
        loss0 = timed("pipeline parity", pipeline_lm_parity_phase)
        pp = timed("pipeline", pipeline_lm_phase, card, loss0)
        bus = timed("busbench", busbench_phase, card)
        loss0 = timed("precision parity", precision_parity_phase)
        prec = timed("precision train", precision_train_phase, card, loss0)
        remat = timed("remat policies", remat_phase, card)
        bench0 = timed("precision bench parity",
                       precision_bench_parity_phase)
        bench_rows, bench = timed("precision bench", precision_bench_phase,
                                  card, bench0)
        res14 = timed("resilience", resilience_phase, card, fs_sync)
        loss0 = timed("moe parity", moe_parity_phase)
        timed("moe oracle", moe_oracle_phase)
        timed("moe bf16", moe_bf16_phase)
        moe = timed("moe train", moe_train_phase, card, loss0)
        t16 = time.perf_counter()
        tp_shards = timed("tp shards", tp_shards_phase)
        timed("tp parity", tp_parity_phase)
        ring = timed("ring fold", ring_fold_phase)
        tpsp, tpsp_launches = timed("tp and sp train", tp_sp_train_phase,
                                    card)
        log(f"phase 16 (tensor and sequence parallelism): "
            f"{time.perf_counter() - t16:.1f} s")
        t17 = time.perf_counter()
        loss0 = timed("composable parity", composable_parity_phase)
        comp, comp_launches = timed("composable train",
                                    composable_train_phase, card, loss0)
        twin, twin_launches = timed("composable twin",
                                    composable_twin_phase, card)
        auto, auto_launches = timed("fsdp auto", auto_phase, card)
        law = timed("composable law", composable_law_phase)
        log(f"phase 17 (the composable step, its twin, FSDP's auto "
            f"variant): {time.perf_counter() - t17:.1f} s")
        params = timed("SMOLLM3_3B params again", build_params)
        params_q8 = quantize_decode_params(params, CFG)
        frontier, frontier_launches = timed(
            "serving frontier", frontier_phase, params, params_q8,
            serve_prompts, vanilla, card)
        fleet, fleet_launches = timed(
            "fleet, TP, disaggregation, MoE serve", fleet_phase, params,
            params_q8, serve, q8, card)
        del params, params_q8
        torch.cuda.empty_cache()
        # 20a's corpus-70m checkpoint, which 22b's generate_demo restores
        corpus_ckpt = Path(tempfile.mkdtemp(prefix="corpus_ck_"))
        p20, p20_launches = timed(
            "data, classification and the model families", phase20, card,
            corpus_ckpt)
        p21, p21_launches = timed(
            "the pipeline harness, the ledger, the timeline, the report",
            phase21, card)
        p22, p22_launches = timed(
            "the model core's rest: remat at the kernels' precisions, twins",
            phase22, card, corpus_ckpt)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        mesh.destroy_process_group()
        if corpus_ckpt is not None:
            shutil.rmtree(corpus_ckpt, ignore_errors=True)
    # each kernel's launches on the main paths that run it, each path
    # read with its counts set to 0 just before it
    precision = {k: prec.get(k, 0) + bench.get(k, 0)
                 for k in {**prec, **bench}}
    resilience = {k: v + res14["resumed_counts"][k]
                  for k, v in res14["counts"].items()}
    paths = {"serve": launches, "int8 serve": q8_counts, "train": fp8,
             "int8 train": i8, "fsdp train": fs, "pipeline": pp,
             "precision": precision, "resilience": resilience, "moe": moe,
             **tpsp_launches, "composable step": comp_launches,
             "composable twin": twin_launches, "fsdp auto": auto_launches,
             **frontier_launches, **fleet_launches, **p20_launches,
             **p21_launches, **p22_launches}
    for k in kernels:
        per = {p: c[k["name"]] for p, c in paths.items() if k["name"] in c}
        k["launches"] = sum(per.values())
        k["launches_by_path"] = per
    log(f"phase wall times (s): {json.dumps(walls)}; total "
        f"{time.perf_counter() - t_all:.1f} s")
    log(f"card memory freed by a collection after each phase (bytes; "
        f"limit {CYCLIC_LIMIT_BYTES}): {json.dumps(cyclic)}")
    log(f"ddp and zero readings on {card}: {json.dumps(ddp_zero)}")
    log(f"pipeline toy readings on {card}: {json.dumps(pipe_toy)}")
    log(f"busbench rows on {card} (one rank: copies): {json.dumps(bus)}")
    log(f"remat policies on {card}: {json.dumps(remat)}")
    log(f"precision bench rows on {card}: {json.dumps(bench_rows)}")
    log(f"tp and sp readings on {card}: shards {json.dumps(tp_shards)}; "
        f"ring fold {json.dumps(ring)}; train {json.dumps(tpsp)}")
    log(f"composable readings on {card}: 3-axis step {json.dumps(comp)}; "
        f"twin {json.dumps(twin)}; fsdp auto {json.dumps(auto)}; laws "
        f"{json.dumps(law)}")
    log(f"serving frontier readings on {card}: {json.dumps(frontier)}")
    log(f"fleet, TP, disaggregation and MoE serve readings on {card}: "
        f"{json.dumps(fleet)}")
    log(f"phase 20 readings on {card}: {json.dumps(p20)}")
    log(f"phase 21 readings on {card}: {json.dumps(p21)}")
    log(f"phase 22 readings on {card}: {json.dumps(p22, default=str)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
