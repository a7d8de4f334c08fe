"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: require CUDA; print the card's name and power limit (nvidia-smi)
   and the versions of torch, CUDA, Python and numpy;
2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, in parallel) and print the build time and
   the compiler's register report;
3. row kernels: each row kernel against its plain PyTorch version on the
   card at the engine's block (4096, 32), the whole fleet (102400, 32), wide
   rows (256, 65536), a ragged (1000, 1000) and (4096, 1024): top-k and QSGD
   bitwise (QSGD both with its norms computed in the kernel, the engine's
   path, and given), scaled sign + EF to rtol 1e-5 / atol 1e-6; with each
   kernel's time per call (host launch included), its time alone on the
   device (a CUDA graph of many launches), the plain version's time and the
   least time the card could take (bytes or operations over the card's peak
   rate), and top-k's device time over scaled sign's at the engine's block
   (the median of RATIO_ROUNDS alternating timings). Then QSGD and scaled
   sign at the other layouts' shapes (4096, 64), (4096, 128), (999, 36) and
   from views one element into their storage (not 16-byte aligned); and at
   the engine's block the card's floor for such one-wave kernels, by the
   same CUDA-graph timing: a one-element add (the launch), an add that
   moves QSGD's 12 B per element and a concatenation that moves scaled
   sign's 16 B, with scaled sign, QSGD given its norms and the engine's
   whole ``ops.qsgd_rows`` call each over its floor (medians of
   RATIO_ROUNDS alternating rounds);
4. tile kernels: the whole-tensor kernels the same way at (100,), (3, 777),
   (5, 7, 11), 2^18, 2^22 and 10^8 elements in float32, and 2^22 and 10^8
   in bf16, and at 10^8 in both types from a view one element into its
   storage (not 16-byte aligned): top-k (k = 10 of 1024) and QSGD (256
   levels) bitwise, scaled sign + EF to rtol 1e-5 / atol 1e-6; then both
   top-k kernels bit for bit against their plain versions on adversarial
   rows (``ref.topk_adversarial``: ties at the threshold, constant rows,
   NaN, +inf and -inf, signed zeros, denormals, more candidates than a warp
   row's buffer) for budgets below 0, 0, fractional, past 32 and at and
   past the row's width, the tile form also from an unaligned view;
5. API: ``block_topk``, ``qsgd_quantize`` and ``sign_ef_compress`` on one
   10^8-element gradient (the ~100M-parameter model of
   ``examples/train_fl_100m.py --full-100m``), each launch counter set to 0
   before and required to read 1 after; each call's wall time, and the
   share of ``qsgd_quantize`` that is the threefry draw of its dither;
6. reference: the engine on the card against the same engine on the CPU
   (whose plain versions the test suite holds against the JAX reference) at
   N = 4096, d = 256, the kernel-dispatch threshold, for each kernel-backed
   compressor under fedavg and for scaffold, fedadam and fedbuff under
   top-k: participation, uplink and downlink bits equal, loss within rtol
   1e-4; then with ``benchmarks/bench_faults.py``'s faults
   (``max_retries=2``) under
   fedavg x each kernel-backed compressor and fedbuff x top-k, and with
   privacy (clip 0.5, sigma 0.3, as ``benchmarks/bench_privacy.py``)
   secagg x QSGD, secagg_dp x scaled sign and dp x top-k: participation,
   survivors, drops, retransmissions, uplink and mask bits equal, loss
   within rtol 1e-4, epsilon within rtol 1e-5; the CPU run's smallest SNR
   margin to the decode threshold, ``|snr / snr_min - 1|``, must exceed
   1e-5 (an ulp of the fading draw could flip a decode closer than that);
   then a sweep (random and best_channel in mixture mode x a dropout
   probability of 0.4 x privacy none and dp) and the host loop with an
   opaque ``eval_fn``, each on the card against the CPU; every run of the
   phase takes REF_ROUNDS rounds;
7. engine: the headline fleet configuration (N = 100000 clients, linear
   model d = 32, H = 2 local steps of batch 8, 4096-client blocks, on-device
   data, random scheduling of 256, 6 rounds) once per kernel-backed
   compressor with dense EF; every launch counter is set to 0 just before a
   run and read just after, and each run must launch its kernel; the loss
   must stay finite and fall;
8. algorithms: all eight algorithms at the same fleet configuration with
   top-k and dense EF, 3 rounds after a 1-round warm-up: rounds/s each, the
   loss finite and falling, and ``topk_rows`` launched 25 times per round
   (50 under SCAFFOLD, whose ctrl delta is a second uplink message);
9. faults: the fleet configuration with ``bench_faults.py``'s faults and
   ``max_retries=2``, once per kernel-backed compressor, 3 rounds after a
   1-round warm-up: each kernel launched 25 times a round (every client
   compresses, survivor or not), survivors + drops at most the schedule,
   drops in every round, the loss finite and falling; rounds/s beside
   phase 7's fault-free rate, and the retransmissions;
10. privacy: the fleet configuration under secagg x QSGD, secagg_dp x
   scaled sign and dp x top-k (clip 0.5, sigma 0.3), 3 rounds each after a
   warm-up: 25 launches a round, the loss finite and falling, epsilon
   finite and non-decreasing under DP; secagg's final params bit for bit
   those of the same run without masks (``_secagg_unmasked``); and the
   mask prepass of one round timed alone;
11. sweep: (a) ``benchmarks/bench_sweep.py``'s full grid, N = 16 clients,
   4 scheduled, top-k, 10 policies x 4 seeds x 5 learning rates = 200
   variants in mixture mode, cut from the bench's 20 rounds to
   SWEEP_ROUNDS (variants/s; the loss finite and falling on average); (b)
   its ``--fast`` grid (40 variants, rounds capped at 8) in mixture and
   loop mode, bitwise equal; (c) its tuner call on the same cell (seconds,
   variants, engine traces, the winner); (d) the fleet
   configuration swept over random, best_channel and pf x seeds 0 and 1 for
   2 rounds with top-k (variant-rounds/s, ``topk_rows`` launched 25 times a
   variant-round, the loss finite and falling in every variant), then
   under QSGD and scaled sign (25 launches of their kernels a
   variant-round); every kernel's counter, the tile kernels' too, is set
   to 0 before each of these sweeps and read after (``sweep_launches`` in
   the kernels line);
12. host: the fleet configuration through the host loop with an opaque
   ``eval_fn`` for 3 rounds: participation and uplink bits equal to the
   scan's, its loss equal to the scan's ``eval_batch`` loss, 25 ``topk_rows``
   launches a round; rounds/s beside phase 7's;
13. hfl: ``benchmarks/bench_hfl.py``'s cell, the hierarchical engine at its
   full width (N = 21 devices in 7 hex clusters, the examples' LM problem,
   D = 5120, top-k at 1%, 1e8 model bits, random scheduling of 21 a
   cluster, lr 1.0, 2 local steps of batch 16: the problem, config and
   cells of ``repro_torch.examples.hierarchical_fl``), with
   every kernel counter set to 0 at its start: (a) H = 2 with
   the example's per-cluster cells for HFL_CHECK_ROUNDS
   rounds, the card against the CPU (participation, schedule sizes,
   uplink and downlink bits equal, latency within rtol 1e-5, loss within
   rtol 1e-4) and the host loop on the card bitwise the scan; (b) the
   bench at its 80 rounds on the card: flat FL in one 1500 m cell, then
   HFL at H = 2, 4, 6, each with rounds/s, its final loss, the simulated
   wall-clock speed-up over flat FL and the loss ratio at equal wall clock
   (as ``bench_hfl.py`` computes it); (c) at (a)'s cell for
   HFL_CASE_ROUNDS rounds, card against CPU: ``bench_faults.py``'s faults,
   secagg x QSGD (bitwise its unmasked oracle on the card), dp x top-k and
   a sweep over 2 backhaul rates x 2 seeds x 3 policies, with the trace
   counts; (d) the six kernels' counters read at the end must be 0: the
   reference's HFL reaches no kernel (``hfl_launches`` in the kernels line).
14. gossip: ``benchmarks/bench_decentralized.py``'s cell (N = 64 nodes, the
   8x8 torus's Laplacian mixing, the linear problem of phase 11, lr 0.1)
   and the fog hybrid (7 hex clusters, sync every 4 rounds), with every
   kernel counter set to 0 at its start: (a) GOSSIP_CHECK_ROUNDS rounds
   under no compression, QSGD, top-k, sign x ``bench_faults.py``'s faults,
   fog at k = 2 and fog x faults, the card against the CPU (bits, edges and
   online counts equal, latency within rtol 1e-5, loss and drift within
   rtol 1e-4, final params within 1e-5) and the host loop on the card
   bitwise the scan; (b) the bench at its 40 rounds on the card: gossip
   rounds/s (the better of two timed runs after a warm one, as the bench's
   ``_timed``), the 4-topology frontier through one ``run_gossip_sweep``
   (1 trace on a cold cache), fog rounds/s at k = 2 and the frontier at
   k = 1, 2, 4 (final loss, simulated wall clock, backhaul bits, drift);
   (c) the LM cells of ``repro_torch.examples.decentralized_gossip`` (N =
   16, ring, 4x4 torus, ER(0.4), 40 rounds: its ``main`` whole) and
   ``fog_hybrid`` (N = 28, k = 1, 2, 4, 24 rounds, a fresh problem each),
   QSGD, 1e6 model bits, lr 0.5, after EX_CHECK_ROUNDS rounds of each on
   the card against the CPU; (d) PROFILE_ROUNDS rounds of the bench's
   gossip run under ``torch.profiler`` (host ms, ``cudaLaunchKernel`` a
   round, the device's busy share); (e) the six kernels' counters read 0
   (``gossip_launches`` in the kernels line).
15. lm: the dense transformer LM through the flat engine, every kernel
   counter set to 0 at its start: (a) ``examples/quickstart.py``'s cell at
   its width (gemma-2b ``reduced()``, D = 541 312, N = 12, 4 scheduled by
   age, H = 2, batch 4, seq 32, 2048 sequences, Dirichlet 0.3, top-k at
   D // 50 with EF, lr 2e-3, 32 x param_count model bits): QS_CHECK_ROUNDS
   rounds on the card against the CPU (participation bitwise, uplink bits
   equal, latency within rtol 1e-5, loss within rtol 1e-4), then
   ``repro_torch.examples.quickstart.main`` whole (its 30 rounds through
   ``run_simulation``, its assert that the last loss is below the first,
   ``topk_rows`` launched once a round); ``private_fl``'s runs (none,
   secagg, secagg_dp at clip 1.0, sigma 0.5) and its dp sweep at sigma 0.3,
   1.0, 3.0, PF_CHECK_ROUNDS rounds each on the batches after the
   quickstart's 30 rounds, card against CPU; (b) the
   quickstart at gemma-2b's published widths (d_model 2048, 8 heads, MQA,
   head_dim 256, GeGLU d_ff 16 384, vocab 256 000, tied embeddings), cut to
   QS_FULL_DEPTH layers in float32, D = 744 499 200: the init's peak memory,
   one ``lm_loss`` and its gradient card against CPU (loss within rtol 1e-5,
   the gradient's relative L2 error), ``topk_rows`` on one (1, D) row
   against its plain version (bitwise) with its time, then QS_FULL_ROUNDS
   rounds in blocks of QS_FULL_CHUNK (s a round, peak memory, loss and
   bits, ``topk_rows`` launched rounds x 12 times, the five other counters
   0); then, since the example's traffic schedules nobody at that width,
   two untimed ``fl_round``s as the engine calls them (blocks of one,
   ``donate=True``) with two clients forced to participate, the second held
   bit for bit against plain versions: each client's new EF row against
   its corrected message less ``topk_rows_plain`` of it, and the new params
   against the plain mean of the two messages (the fold of the two block
   partials and the server step); ``lm_launches`` in the kernels line.
16. families: the moe, ssm and hybrid families through the CLI's federated
   trainer (``repro_torch.launch.train``), every kernel counter set to 0 at
   its start: (a) ``run_federated`` at ``--reduced`` for minicpm-2b
   (dense), qwen2-moe-a2.7b (moe), falcon-mamba-7b (ssm) and
   recurrentgemma-2b (hybrid), CLI_ARGS (8 devices, 4 scheduled, top-k, 3
   rounds), on the card against the same call on the CPU: participation
   bitwise, bits equal, latency within rtol 1e-5, loss within rtol 1e-4 for
   the first two rounds and FLIP_RTOL after (at lr 2.0 a top-k selection
   flipping between coordinates an ulp apart moves the model by a
   threshold-sized step), ``topk_rows`` launched once a round; (b)
   falcon-mamba-7b at its published widths (d_model 4096, d_inner 8192,
   ssm_state 16, d_conv 4, dt_rank 256, vocab 65 024, untied head), cut to
   FM_DEPTH layers in float32, through ``run_federated``'s own pieces
   (``federated_problem``, FM_ARGS: 4 devices, 2 scheduled by the random
   policy, 2 local steps of (8, 128) batches, top-k at 1% with EF, 32 x D
   model bits) in blocks of one client for one timed round (s a round,
   peak memory, ``topk_rows`` launched 4 times, the five others 0), B2 on
   one (1, D) row against its plain version (bitwise) and timed, then the
   two forced ``fl_round``s of phase 15 (b) at this D, EF rows and params
   bit for bit against plain versions; (c) qwen2-moe-a2.7b (60 experts,
   top-4, 4 shared, capacity 1.25) at 1 layer and recurrentgemma-2b at one
   pattern period (3 layers), published widths, float32: one (4, 32) batch
   through ``lm_loss`` and its gradient on the card and on the CPU (init on
   the card, copied), loss within rtol 1e-5, the gradient's relative L2
   error within 1e-4, and the MoE's token choices dropped by capacity,
   layer by layer, equal on both; ``families_launches`` in the kernels line.

17. trainer: the one-card trainer (``launch/steps.py`` through the CLI's
   ``run_cluster``), no kernel on its path, every kernel counter set to 0
   at its start and required to read 0 at its end: (a) ``run_cluster`` at
   ``--reduced`` for gemma-2b (cosine) and minicpm-2b (wsd), TRAINER_ARGS (6
   steps of (8, 64) batches at the CLI's lr 1e-3) for pssgd x {none, bf16,
   int8 + EF, sign + EF}, localsgd (H = 2) and fsdp, on the card against
   the same call on the CPU: the loss within rtol 1e-4 at every step and
   the final params' relative L2 error within 1e-4; (b) gemma-2b at its
   published size (18 layers, d_model 2048, 8 heads, MQA, head_dim 256,
   GeGLU d_ff 16 384, vocab 256 000, tied embeddings), cut only to float32
   (the config says bfloat16), through ``run_cluster`` with the CLI's
   defaults but ``--steps``: pssgd, int8 + EF, adamw, lr 1e-3, remat, 10
   steps of (8, 128) batches: the init's seconds and peak memory, each
   step's time by CUDA events (s a step: the median of steps 2-9), tokens
   per second, the peak memory in the steps, the loss falling (the CLI's
   assertion), and its ``--ckpt-dir`` checkpoint loaded back bit for bit;
   (c) ``python -m repro_torch.examples.train_fl_100m --full-100m`` at its
   default 300 steps, the ~100M config's widths, lr and remat at depth 12
   -> 4 (its tokens per second and the loss's fall of at least 0.3, which
   the example asserts); ``trainer_launches`` in the kernels
   line.

18. serve: the serving path (``launch/serve.py``, ``launch/steps.py``'s
   serving steps, ``transformer.prefill`` / ``decode_step``) and the vlm and
   audio families, no kernel on the path, every kernel counter set to 0 at
   its start and required to read 0 at its end: (a) ``serve --reduced``
   (batch 2, prompt 32, 16 greedy steps) for gemma-2b, qwen2-moe-a2.7b,
   falcon-mamba-7b, recurrentgemma-2b, llama-3.2-vision-11b and
   whisper-base on the card against the same call on the CPU (every step's
   logits within SERVE_TOL of the largest |logit|, greedy tokens equal
   wherever the CPU's top-2 gap exceeds that), then circular decode past a
   window of 16 at positions 0, 5, 15, 16 and 50 for falcon-mamba-7b,
   recurrentgemma-2b and gemma-2b (logits and caches); (b) ``run_cluster
   --reduced`` for llama-3.2-vision-11b and whisper-base, pssgd, int8 +
   EF, 6 steps of (8, 64), card against CPU as phase 17(a); (c)
   llama-3.2-vision-11b at its published widths cut to 10 layers and
   float32, both gates 0.5 and seeded normal vision embeds: the init's s
   and peak, prefill (4, 512) and 64 greedy decode steps through
   ``make_prefill_step`` / ``_load_prefill`` / ``make_decode_step``, each
   beside its bound (``_vlm_bounds``), the peak in serving, and the decode's
   logits against one teacher-forced ``forward_trunk`` over the 576 tokens
   within VLM_TOL, greedy tokens equal wherever the top-2 gap exceeds it;
   (d) the same widths cut to 5 layers through ``run_cluster`` (pssgd, int8
   + EF, adamw, lr 1e-3, remat, 10 steps of (8, 128)): init s and peak, s
   a step, tokens/s, peak; (e) whisper-base at its published size in
   float32: ``serve`` (4, 64) + 64 steps card against CPU, and
   ``run_cluster`` for 10 steps of (8, 128); ``serve_launches`` in the
   kernels line;
19. leaf: the per-leaf compressors and the numpy reference layer, which
   reach no kernel: (a) the nine operators (sign, scaled sign, blockwise
   scaled sign, ternary, QSGD, random sparsification, top-k, R-top-K,
   rand-k) on every leaf of gemma-2b's reduced() tree, float32 and bf16,
   and ``tree_ef_compress`` with each, card against CPU (the bitwise
   operators equal, the others within LEAF_RTOL, flips only at their
   thresholds, counted); (b) gemma-2b's published parameter tree (11
   leaves, 2 506 172 416 elements, bfloat16) with a float32 EF, one
   ``tree_ef_compress`` a compressor: s a call, peak GB, c + e' = x + e,
   exactly k kept, top-k a k-contraction, random sparsification's variance
   within its budget; (c) the numpy channel and policies at N = 10^5
   against their torch twins on the card (the greedies at N = 256) and the
   update-success analytics over bench_rs_rr_pf.py's grid; (d) the position
   codec on embed's top 0.1%, encode and decode timed; ``leaf_launches`` in
   the kernels line.

20. cluster: the cluster side, on members that are processes sharing the
   one card over gloo (``torch.multiprocessing`` spawn; the numbers test
   the code, the placement and the wire, not the speed of several cards):
   (a) the compressed collectives, every method with and without EF on
   (pod 2, data 2) and (data 4), a (4096, 1024) leaf a member: every
   member's output bitwise the others', card == CPU (none, bf16, int8
   bitwise; sign within the collectives tests' tolerances), the bytes a
   member sends, the gloo ops that take CUDA tensors and those staged
   through host memory; (b) the ring gossip on 4 members, card == CPU
   bitwise; (c) the trainer at ``--reduced``, card members against CPU
   members: gemma-2b pssgd int8 + EF on (data 2), localsgd int8 at H = 2
   with the pod sync on (pod 2, data 2) through ``launch/steps.py``, fsdp on
   (data 2) with each member's bytes at rest, qwen2-moe-a2.7b pssgd int8 +
   EF on (data 1, model 2) and pssgd none on (data 2, model 2) (the plain
   mean of each expert block as it is) through ``moe_forward_ep``, and the
   block split over model (``models/tp.py``): stablelm-12b pssgd int8 + EF
   on (data 2, model 2) and whisper-base pssgd none on (data 1, model 2);
   each member's wire bytes; (d) gemma-2b at its
   published widths, depth 18 -> 4, float32, pssgd int8 + EF on (data 2),
   global batch (8, 128), 2 steps: per member s a step (CUDA events and
   wall clock), peak GB, wire bytes, params bitwise alike after every step,
   the EF identity within the float32 bound; (e) qwen2-moe-a2.7b at its
   published widths, 1 layer, one (4, 128) batch's loss and gradient
   through ``moe_forward_ep`` on (data 1, model 4) against the
   one-process ``moe_forward``; (f) the fleet config's top-k sweep over 2
   members, bitwise the one-process sweep, ``topk_rows`` launches a member
   summing to its launches; (g) gemma-2b as in (d) but pssgd none with
   every leaf split over model on (data 1, model 2): a (4, 128) prompt and
   8 greedy decode steps, then 2 train steps, against the same on (1, 1) in
   one process: loss a step, gathered params, greedy tokens and logits
   within TP_WIDE_*; the members' whole leaves bitwise alike; per member s
   a step, step-only peak, bytes held, wire a step by kind, ms a decode
   step; then the prompt served into a ring of d_inner = 4096 positions,
   which the cache rule splits over model (its one kv head does not
   divide): 8 greedy steps, then TP_WIDE_RING past position 4096, against
   one process holding the ring whole: tokens equal, logits within
   TP_WIDE_LOGITS_L2, a member's cache half of one process's; (h) (g)'s
   run for the mamba and RG-LRU blocks split over model
   (their channels and recurrent states): falcon-mamba-7b at its published
   widths, depth 64 -> 2, and recurrentgemma-2b, depth 26 -> 3 (one
   pattern period; its attention's 10 q heads split, its 1 kv head stays
   whole); (i) fsdp a layer at a time: (1) gemma-2b as in (d), fsdp (the
   dry-run's policy: bf16 moments, remat) on (data 2), each layer's leaves
   gathered where the layer runs and again in its recomputation, against
   the same on (1, 1) in one process: loss a step and gathered params
   within TP_WIDE_*, both members' gathered params bitwise alike; per
   member s a step, step-only peak, bytes held, wire a step by kind; (2)
   qwen2-moe-a2.7b at its published widths, 2 layers, at its own capacity
   factor: a (4, 128) prompt and 8 greedy decode steps on (data 2, model 1),
   a member's rows routed as its part of the whole batch, against one
   process over the whole batch: tokens equal, logits within
   SERVE_SPLIT_TOL, the choices dropped equal and more than 0, and bitwise
   the members replayed in one process at their shapes (``_replayed``);
   ``cluster_launches`` in the kernels line.

21. dryrun: ``python -m repro_torch.launch.dryrun`` in subprocesses run
   side by side, one member's step under fake tensors on the card's device
   over a fake process group (nothing allocated, nothing computed), held
   against what this run measured: (a) phase 17(b)'s case (gemma-2b at its
   published size, float32, int8 + EF, (8, 128), one member): argument
   bytes equal to the state and batch the card held, exactly; peak within
   DRYRUN_PEAK_RTOL of the card's step-only peak; the flops beside the
   achieved TFLOP/s at 17(b)'s s a step; (b) phase 20(d)'s case on
   (data 2): wire bytes a member a step equal to what each member's
   ``collectives.WIRE`` counted, argument bytes equal to each member's
   held bytes, peak within DRYRUN_PEAK_RTOL of each member's step-only
   peak; (b moe) phase 20(c)'s qwen2-moe-a2.7b pssgd none on (data 2,
   model 2): its wire bytes a member a step, times 3 steps, equal to what
   each member counted; (g), (h) phase 20(g)'s and 20(h)'s cases on
   (data 1, model 2): wire bytes a step by kind and argument bytes equal to
   each member's, peak within DRYRUN_PEAK_RTOL of each member's step-only
   peak; (i) phase 20(i)(1)'s case on (data 2): the same three checks;
   (c) gemma-2b train_4k ok on 256x1 and on (16, 16), falcon-mamba-7b
   and recurrentgemma-2b train_4k ok on (16, 16) and llama3-405b train_4k
   (fsdp) on 256x1, its peak at most LLAMA_PEAK_LIMIT_GB, printed beside
   the whole-gather step's 1 848.7 GB and the prediction (traced from
   phase 17 on: minutes of CPU each; the other cases from phase 20 on),
   qwen2-moe-a2.7b ok in all four shapes on (16, 16), llama3-405b
   decode_32k and llama-3.2-vision-11b long_500k ok on (16, 16) (traced
   from phase 17 on too), a member's decode cache (its argument bytes less
   its params and token) equal to the reference's block, its positions
   split over model, printed beside the figure of the port that held it
   whole over model; every kernel counter 0 in each case's own process
   (each record's
   ``kernel_launches``; their sum is ``dryrun_launches`` in the kernels
   line).

22. examples (run before phase 21, while the dry-run's last traces run):
   the walk-through examples as a user starts them (``python
   -m repro_torch.examples.<name>``, their ``main`` at their own
   constants) that no earlier phase runs whole, every kernel counter set
   to 0 before each and required to read 0 after it: (a) the chapter's
   scheduling study, ``wireless_scheduling_sim`` (the examples' LM problem
   at N = 20, Dirichlet 0.1, 4 scheduled, 4 local steps, lr 1.0, the ten
   policies through ``run_sweep`` for 60 rounds): s for the study and ms a
   variant-round, its first STUDY_CHECK_ROUNDS rounds against the same
   module on the CPU at that many rounds (participation and schedule
   sizes bitwise, wall clock within rtol 1e-5, loss within rtol 1e-4); (b)
   ``hierarchical_fl`` (flat FL in a 1500 m cell, then HFL at H = 2, 4, 6
   over the per-cluster cells, 60 rounds each, a fresh problem each); (c)
   ``private_fl`` (none, secagg, secagg_dp, 20 rounds each, then the dp
   sweep over sigma 0.3, 1, 3); (d) ``fog_hybrid`` (k = 1, 2, 4, 24 rounds
   each, on one problem); each part's line names the dry-run traces still
   running (niced) when it started and ended, so its times say whether
   they shared the host; ``examples_launches`` in the kernels line.

Phase 3 also holds ``qsgd_rows`` given its norms at (6, 744 497 152), rows
x d past 2^32 (the flat pass), against its plain version row by row.

Every phase prints its wall time. The last two lines of output are the
kernel table as JSON and the result.
"""
from __future__ import annotations

import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SHAPES = [(4096, 32), (102400, 32), (256, 65536), (1000, 1000), (4096, 1024)]
ENGINE_BLOCK = (4096, 32)
GRAD_ELEMS = 10 ** 8       # the ~100M-parameter model's gradient
# (shape, x type, offset): an offset of 1 makes x a view that starts one
# element into its storage, so that it is not 16-byte aligned
TILE_CASES = ([((100,), torch.float32, 0), ((3, 777), torch.float32, 0),
               ((5, 7, 11), torch.float32, 0), ((1 << 18,), torch.float32, 0)]
              + [((n,), dt, 0) for n in (1 << 22, GRAD_ELEMS)
                 for dt in (torch.float32, torch.bfloat16)]
              + [((GRAD_ELEMS,), dt, 1)
                 for dt in (torch.float32, torch.bfloat16)])
RATIO_ROUNDS = 5  # alternating device timings of top-k and scaled sign
# (shape, offset) of the further row cases: a warp a row group in 8-byte
# accesses (64 columns) and in 16-byte ones (128), a ragged group (36
# columns: 18 float2s in 32 threads), and the engine's block from views one
# element into their storage (4-byte accesses)
ROW_CASES = [((4096, 64), 0), ((4096, 128), 0), ((999, 36), 0),
             ((4096, 32), 1)]
ADVERSARIAL_SHAPES = [(4096, 32), (999, 33), (4096, 1024), (64, 3000),
                      (18, 65536)]
TILE_K, TILE_LEVELS = 10, 256  # block_topk's default k_frac, qsgd's levels
FLEET = dict(n_devices=100_000, n_scheduled=256, local_steps=2,
             policy="random", chunk_size=4096, seed=0)
D_FLEET, ROUNDS, ALGO_ROUNDS, BATCH = 32, 6, 3, 8
ALGOS = ("fedavg", "fedavg_m", "fedprox", "scaffold", "slowmo", "fedadam",
         "fedyogi", "fedbuff")
# benchmarks/bench_faults.py's FAULTS and bench_privacy.py's clip and sigma
FAULTS = dict(drop_prob=0.2, churn_p_off=0.05, churn_p_on=0.5,
              straggler_prob=0.1, straggler_alpha=1.5, snr_min=1.0,
              fading_rho=0.5)
MAX_RETRIES = 2
PRIVACY = dict(clip=0.5, sigma=0.3)
PRIV_CASES = (("secagg", "qsgd"), ("secagg_dp", "scaled_sign"),
              ("dp", "topk"))
KERNEL_OF = {"topk": "topk_rows", "qsgd": "qsgd_rows",
             "scaled_sign": "sign_ef_rows"}
SNR_MARGIN = 1e-5
# phase 6's depth: its N = 4096 runs on the CPU dominate the script, so they
# take one round (they took two); N and d are not cut. Its sweep's CPU run
# took 92.5 s of the phase's 189 s for 16 variants (2 seeds x 2 dropout
# probabilities): it runs 4 (one seed, the dropout of 0.4), which keeps the
# script inside its time limit
REF_ROUNDS, REF_SWEEP_DROP = 1, 0.4
# benchmarks/bench_sweep.py: N = 16 clients, 4 scheduled, top-k, the full
# grid (10 policies x 4 seeds x 5 learning rates) and its --fast grid (2 x 2,
# its rounds capped at 8), the linear problem of benchmarks/common.py at
# d = 32, H = 2, B = 8; its tuner call on the same cell. The bench runs 20
# rounds; here 2, so that the script stays well inside its time limit (a
# variant-round takes 40-60 ms of an H100 machine's host, PERF.md)
SWEEP_N, SWEEP_ROUNDS = 16, 2
FAST_ROUNDS = min(SWEEP_ROUNDS, 8)
SWEEP_SEEDS, SWEEP_LRS = (0, 1, 2, 3), (0.02, 0.05, 0.1, 0.15, 0.2)
FAST_SEEDS, FAST_LRS = (0, 1), (0.05, 0.1)
TUNE = dict(policies=("random", "best_channel", "latency", "pf"),
            compressions=("topk", "none"), n_scheduled_grid=(2, 4, 8))
FLEET_POLICIES, FLEET_SEEDS, FLEET_SWEEP_ROUNDS = (
    ("random", "best_channel", "pf"), (0, 1), 2)
HOST_ROUNDS = 3
# benchmarks/bench_hfl.py: the cell of examples/hierarchical_fl.py (N = 21
# devices in 7 hex clusters, the examples' LM problem at alpha 0.3: D =
# 5120, top-k at 1%, 1e8 model bits; repro_torch.examples), 80 rounds
HFL_ROUNDS, HFL_CHECK_ROUNDS, HFL_CASE_ROUNDS = 80, 10, 4
# benchmarks/bench_decentralized.py: N = 64 nodes, the 8x8 torus's Laplacian
# mixing, the linear problem (d = 32, H = 2, B = 8), lr 0.1, 40 rounds; the
# fog hybrid in 7 hex clusters synced every 4 rounds at k = 1, 2, 4 gossip
# steps. The LM cells of examples/decentralized_gossip.py and
# examples/fog_hybrid.py come from repro_torch.examples, checked on the card
# against the CPU for EX_CHECK_ROUNDS rounds
GOSSIP_N, GOSSIP_ROUNDS, GOSSIP_CHECK_ROUNDS = 64, 40, 5
# (d) profiles this many of the bench's rounds: its figures are a round's,
# and the profiler's processing of 40 rounds' ~64k launches took ~30 s
PROFILE_ROUNDS = 10
FOG_STEPS = (1, 2, 4)
EX_CHECK_ROUNDS = 4
# examples/quickstart.py and examples/private_fl.py (repro_torch.examples):
# the card against the CPU for QS_CHECK_ROUNDS and PF_CHECK_ROUNDS rounds
QS_CHECK_ROUNDS, PF_CHECK_ROUNDS = 3, 3
# the scheduling study (examples/wireless_scheduling_sim.py) on the CPU, to
# hold the card's first rounds against
STUDY_CHECK_ROUNDS = 3
# the quickstart at gemma-2b's published widths: the depth cut from 18 to
# 2, as reduced() cuts it; clients in blocks of one, so that the round
# holds one client's local SGD beside the (12, D) EF; one round (the
# example runs 30): a round takes about 24 s on an H100, 0.97 of it
# topk_rows on twelve 744M-wide rows, and two rounds would take the script
# past 300 s; (6, D) the flat QSGD case past 2^32
QS_FULL_DEPTH, QS_FULL_CHUNK, QS_FULL_ROUNDS = 2, 1, 1
FLAT_QSGD_SHAPE = (6, 744_497_152)
# the CLI's federated path at --reduced, one config of each family it
# trains: 8 devices, 4 scheduled, top-k, 3 rounds of 2 local steps of (4, 16)
# batches at lr 2.0 (at the CLI's lr 1e-3 no family's loss falls in 3 rounds,
# and the CLI asserts that it does)
CLI_ARCHS = ("minicpm-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
             "recurrentgemma-2b")
CLI_ARGS = ["--reduced", "--n-devices", "8", "--n-scheduled", "4",
            "--compressor", "topk", "--rounds", "3", "--seq-len", "16",
            "--batch", "4", "--lr", "2.0"]
CLI_ROUNDS, FLIP_RTOL = 3, 1e-3
# falcon-mamba-7b at its published widths through run_federated's pieces:
# depth 64 -> 2, float32 (the config says bfloat16), clients in blocks of
# one, one timed round (B2 takes about 2 s a 743M-wide row, four a round)
FM_DEPTH, FM_ROUNDS = 2, 1
FM_ARGS = ["--arch", "falcon-mamba-7b", "--n-devices", "4", "--n-scheduled",
           "2", "--policy", "random", "--local-steps", "2", "--batch", "8",
           "--seq-len", "128", "--compressor", "topk", "--rounds",
           str(FM_ROUNDS)]
# published widths, one (4, 32) batch: (arch, depth)
WIDE_ARCHS = (("qwen2-moe-a2.7b", 1), ("recurrentgemma-2b", 3))
WIDE_B, WIDE_SEQ = 4, 32
# the one-card trainer at --reduced: gemma-2b (cosine) and minicpm-2b (wsd),
# 6 steps of (8, 64) batches at the CLI's lr 1e-3, each mode x compression
TRAINER_ARCHS = ("gemma-2b", "minicpm-2b")
TRAINER_MODES = (("pssgd", "none"), ("pssgd", "bf16"), ("pssgd", "int8"),
                 ("pssgd", "sign"), ("localsgd", "none"), ("fsdp", "none"))
TRAINER_ARGS = ["--reduced", "--cluster", "--steps", "6", "--seq-len", "64",
                "--batch", "8", "--local-steps", "2"]
TRAINER_RTOL = 1e-4
# gemma-2b at its published size through run_cluster, the CLI's defaults
# (pssgd, adamw, lr 1e-3, (8, 128) batches, remat) with int8 + EF, 10 steps;
# s a step is the median of steps 2-9
GEMMA_ARGS = ["--arch", "gemma-2b", "--cluster", "--mode", "pssgd",
              "--compression", "int8", "--steps", "10"]
GEMMA_TIMED = slice(2, 10)
# the 100M example at its default 300 steps: in 30 its loss falls from
# 10.903 to 10.846 on an H100, short of the 0.3 the example asserts; the
# ~100M config's widths, lr and remat with its depth cut 12 -> FL100M_DEPTH
# (the script's time limit)
FL100M_ARGS, FL100M_DEPTH = ["--full-100m"], 4
# phase 18, the serving path: (a) serve --reduced for one config of each
# family (batch 2, prompt 32, 16 greedy steps) and circular decode past a
# window of 16, card against CPU; every step's logits within SERVE_TOL of
# the largest |logit|, greedy tokens equal wherever the top-2 gap exceeds
# that
SERVE_ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
               "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-base")
SERVE_ARGS = ["--reduced", "--batch", "2", "--prompt-len", "32", "--gen",
              "16"]
SERVE_TOL = 1e-4
CIRC_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b", "gemma-2b")
CIRC_POS, CIRC_WINDOW = (0, 5, 15, 16, 50), 16
# (b) run_cluster --reduced for the vlm and audio families, card vs CPU
NEW_FAMILY_ARCHS = ("llama-3.2-vision-11b", "whisper-base")
NEW_FAMILY_ARGS = ["--reduced", "--cluster", "--steps", "6", "--seq-len",
                   "64", "--batch", "8", "--compression", "int8"]
# (c) llama-3.2-vision-11b at its published widths, depth 40 -> 10 (two
# superblocks), float32, both gates 0.5 and seeded normal vision embeds:
# prefill (4, 512), 64 greedy steps; decode against the teacher-forced
# forward within VLM_TOL of the largest |logit|
VLM = "llama-3.2-vision-11b"
VLM_DEPTH, VLM_B, VLM_PROMPT, VLM_GEN, VLM_GATE = 10, 4, 512, 64, 0.5
VLM_TOL = 1e-3
# (d) the same widths through run_cluster at one superblock (5 layers), the
# CLI's defaults with int8 + EF, 10 steps of (8, 128)
VLM_TRAIN_DEPTH = 5
VLM_TRAIN_ARGS = ["--arch", VLM, "--cluster", "--mode", "pssgd",
                  "--compression", "int8", "--steps", "10"]
# (e) whisper-base at its published size (6 + 6 layers, 1500 frames),
# float32: serve (4, 64) + 64 steps card vs CPU, run_cluster 10 steps
WHISPER_SERVE_ARGS = ["--arch", "whisper-base", "--batch", "4",
                      "--prompt-len", "64", "--gen", "64"]
WHISPER_TRAIN_ARGS = ["--arch", "whisper-base", "--cluster", "--mode",
                      "pssgd", "--compression", "int8", "--steps", "10"]
CLUSTER_TIMED = slice(2, 10)
# phase 19, the per-leaf compressors and the numpy reference layer: the
# nine operators at k = max(1, ceil(1% of the leaf)), r = min(4k, d), 256
# levels, blocks of 4096, eps 1, one key for every leaf
LEAF_ARCH, LEAF_SEED = "gemma-2b", 19
LEAF_FRAC, LEAF_LEVELS, LEAF_BLOCK, LEAF_EPS = 0.01, 256, 4096, 1.0
LEAF_OPS = ("sign", "scaled_sign", "blockwise_scaled_sign", "ternary", "qsgd",
            "random_sparsify", "topk", "rtopk", "randk")
LEAF_BITWISE = ("sign", "ternary", "topk", "rtopk", "randk")
LEAF_SPARSE = ("topk", "rtopk", "randk")
# (a) card against CPU: values of the operators that sum over a leaf within
# LEAF_RTOL (float32; one bfloat16 ulp), dither and keep flips within
# QSGD_MARGIN * levels of the fraction or KEEP_MARGIN of the probability,
# at most LEAF_MAX_FLIPS an operator over both trees
LEAF_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
QSGD_MARGIN, KEEP_MARGIN, LEAF_MAX_FLIPS = 8 * 2.0 ** -24, 2e-5, 16
# (b) gemma-2b's published parameter tree in its bfloat16 with a float32 EF
# of std 0.01, drawn leaf by leaf from a seeded generator on the card; (d)
# the codec on embed's top 0.1%
LEAF_E_STD, CODEC_FRAC = 0.01, 0.001
# (c) the numpy layer at the fleet's N = 10^5 (k = 256) against the torch
# twins on the card; the greedy policies' numpy loops are quadratic, so
# they run at N = 256; bench_rs_rr_pf.py's K, N, alpha and regimes, and the
# reference test's gamma 1 (tests/test_wireless.py:47)
LEAF_N, LEAF_K, GREEDY_N = 100_000, 256, 256
RSRRPF_K, RSRRPF_N, RSRRPF_ALPHA, RSRRPF_DB = 4, 20, 4.0, (20.0, -25.0, 0.0)
# phase 20, the cluster side: members are processes (torch.multiprocessing
# spawn, gloo) that share the one card (NCCL refuses two ranks on one
# device), so its numbers test the code, the data placement and the wire,
# not the speed of several cards. (a) a (4096, 1024) float32 leaf a member,
# every method with and without EF, on each mesh, card against CPU; (b) a
# (1, 1024, 1024) block a member around the ring
CLUSTER_LEAF, RING_BLOCK = (4096, 1024), (1, 1024, 1024)
CLUSTER_METHODS = ("none", "bf16", "int8", "sign")
CLUSTER_MESHES = (((2, 2), ("pod", "data")), ((4,), ("data",)))
# tests/test_torch_collectives.py's tolerances for scaled sign
CLUSTER_SCALE_RTOL, CLUSTER_SIGN_ATOL = 1e-4, 1e-6
# (c) --reduced, 3 steps of (8, 64) at lr 3e-3, card members against CPU
# members: (what, arch, mode, compression, mesh shape, axes); (data, model)
# meshes through run_cluster, the pod mesh through launch/steps.py; the
# plain float32 mean on (data 2, model 2) reduces each expert block as it
# is, and phase 21 holds its wire against the dry-run's
CLUSTER_B, CLUSTER_SEQ, CLUSTER_STEPS = 8, 64, 3
CLUSTER_ARGS = ["--reduced", "--cluster", "--steps", str(CLUSTER_STEPS),
                "--seq-len", str(CLUSTER_SEQ), "--batch", str(CLUSTER_B),
                "--local-steps", "2", "--lr", "3e-3"]
CLUSTER_MOE_NONE = "pssgd none on (data 2, model 2), moe_forward_ep"
CLUSTER_STABLELM = ("pssgd int8 + EF on (data 2, model 2), the block split "
                    "over model")
CLUSTER_WHISPER = "pssgd none on (data 1, model 2), the block split over model"
# a case's arguments after CLUSTER_ARGS: run_cluster asserts the loss falls,
# and in 3 steps of (8, 64) at lr 3e-3 it does not for stablelm-12b (one
# member or four) nor whisper-base (4 steps of (8, 16) as
# tests/test_torch_cluster_cli.py trains the audio family)
CLUSTER_EXTRA = {CLUSTER_STABLELM: ["--lr", "1e-2"],
                 CLUSTER_WHISPER: ["--steps", "4", "--seq-len", "16"]}
CLUSTER_TRAIN_FOUR = (
    ("localsgd int8 + EF, H = 2, pod sync, on (pod 2, data 2)", "gemma-2b",
     "localsgd", "int8", (2, 2, 1), ("pod", "data", "model")),
    (CLUSTER_MOE_NONE, "qwen2-moe-a2.7b", "pssgd", "none", (2, 2),
     ("data", "model")),
    (CLUSTER_STABLELM, "stablelm-12b", "pssgd", "int8", (2, 2),
     ("data", "model")))
CLUSTER_TRAIN_TWO = (
    ("pssgd int8 + EF on (data 2)", "gemma-2b", "pssgd", "int8", (2, 1),
     ("data", "model")),
    ("fsdp on (data 2)", "gemma-2b", "fsdp", "none", (2, 1),
     ("data", "model")),
    ("pssgd int8 + EF on (data 1, model 2), moe_forward_ep",
     "qwen2-moe-a2.7b", "pssgd", "int8", (1, 2), ("data", "model")),
    (CLUSTER_WHISPER, "whisper-base", "pssgd", "none", (1, 2),
     ("data", "model")))
# (d) gemma-2b at its published widths, depth 18 -> 4 so that two members'
# float32 states fit on the card (~23 GB each; one member's init draw peaks
# near 60 GB, so the members draw in turns), pssgd int8 + EF, adamw at the
# CLI's lr 1e-3, remat, global batch (8, 128), 2 steps (3 until the
# examples' phase 22 took the time: the members' third step of (d), (g),
# (h) and (i) cost ~12 s, ~7 of them (i)'s)
GEMMA_WIDE_DEPTH, GEMMA_WIDE_B, GEMMA_WIDE_SEQ, GEMMA_WIDE_STEPS = (4, 8,
                                                                    128, 2)
# (e) qwen2-moe-a2.7b at its published widths, 1 layer (as phase 16(c)),
# one (4, 128) batch; (i)(2) serves it at 2 layers
MOE_WIDE_DEPTH, MOE_WIDE_B, MOE_WIDE_SEQ, MOE_SERVE_DEPTH = 1, 4, 128, 2
# (g) gemma-2b at its published widths split over model: (d)'s depth,
# dtype, optimizer, remat, batch and steps, pssgd none on (data 1, model 2)
# (int8 on a data axis of 1 would gather every split leaf for its scales),
# against one process on (1, 1); then a (4, 128) prompt and 8 greedy decode
# steps. The tolerances of the (1, 2) run against the (1, 1) run: about
# ten times the drift the order of the sums over model gave on an NVIDIA
# H100 80GB HBM3 at 700 W (loss 9.83e-08 relative, params and logits
# 1.8e-06 relative L2; PERF.md section 6)
TP_WIDE_PROMPT, TP_WIDE_GEN = (4, 128), 8
# then the same prompt served into a ring of d_inner = 4096 positions, which
# the cache rule splits over model (gemma-2b's one kv head does not
# divide): TP_WIDE_GEN greedy steps, then TP_WIDE_RING at positions past
# 4096, against one process holding the ring whole
TP_WIDE_RING = 3
TP_WIDE_LOSS_RTOL, TP_WIDE_PARAMS_L2, TP_WIDE_LOGITS_L2 = 1e-6, 2e-5, 2e-5
# (h) (g)'s run for the mamba and RG-LRU blocks at their published widths:
# falcon-mamba-7b (arXiv:2410.05355) depth 64 -> 2, recurrentgemma-2b
# (arXiv:2402.19427) depth 26 -> 3 (one pattern period); (g)'s tolerances
TP_RECURRENT = (("h falcon", "falcon-mamba-7b", 2),
                ("h rgemma", "recurrentgemma-2b", 3))
# (i) fsdp a layer at a time: (1) (d)'s gemma-2b, its batch and steps, at
# the dry-run's fsdp policy (bf16 moments, remat), held to (g)'s tolerances
# against one process; (2) qwen2-moe-a2.7b at its published widths, 2
# layers, served on (data 2, model 1) against one process over the whole
# batch within tests/test_torch_serve.py's TOL
FSDP_POLICY = dict(mode="fsdp", compression="none",
                   opt_state_dtype="bfloat16", lr=1e-3,
                   total_steps=GEMMA_WIDE_STEPS, remat=True)
SERVE_SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the dry-run's record of llama3-405b train_4k on 256x1 before fsdp held a
# layer at a time, the prediction written before the change (PERF.md) and
# the most a member's peak may be
LLAMA_PARENT_PEAK_GB, LLAMA_PREDICTED_GB, LLAMA_PEAK_LIMIT_GB = (
    1848.731, 70.0, 85.0)
# phase 21, the dry-run (python -m repro_torch.launch.dryrun, fake tensors
# on the card's device, a fake process group) in subprocesses run side by
# side, held against what phases 17(b), 20(c), 20(d) and 20(g) measured in
# this run: (name, CLI arguments, the exit code it must give)
DRYRUN_CASES = (
    ("i", ["--arch", "gemma-2b", "--batch", str(GEMMA_WIDE_B), "--seq-len",
           str(GEMMA_WIDE_SEQ), "--policy", "fsdp", "--dtype", "float32",
           "--depth", str(GEMMA_WIDE_DEPTH), "--mesh-shape", "2x1"], 0),
    ("c 256x1 llama", ["--arch", "llama3-405b", "--shape", "train_4k",
                       "--mesh-shape", "256x1"], 0),
    ("a", ["--arch", "gemma-2b", "--batch", "8", "--seq-len", "128",
           "--policy", "int8_ef", "--dtype", "float32", "--mesh-shape",
           "1x1"], 0),
    ("b", ["--arch", "gemma-2b", "--batch", str(GEMMA_WIDE_B), "--seq-len",
           str(GEMMA_WIDE_SEQ), "--policy", "int8_ef", "--dtype", "float32",
           "--depth", str(GEMMA_WIDE_DEPTH), "--mesh-shape", "2x1"], 0),
    ("b moe", ["--arch", "qwen2-moe-a2.7b", "--reduced", "--no-remat",
               "--batch", str(CLUSTER_B), "--seq-len", str(CLUSTER_SEQ),
               "--mesh-shape", "2x2"], 0),
    ("c 256x1", ["--arch", "gemma-2b", "--shape", "train_4k",
                 "--mesh-shape", "256x1"], 0),
    ("c 16x16 gemma", ["--arch", "gemma-2b", "--shape", "train_4k"], 0),
    ("c 16x16 falcon", ["--arch", "falcon-mamba-7b", "--shape", "train_4k"],
     0),
    ("c 16x16 rgemma", ["--arch", "recurrentgemma-2b", "--shape",
                        "train_4k"], 0),
    ("c 16x16 qwen", ["--arch", "qwen2-moe-a2.7b"], 0),
    ("c 16x16 llama decode", ["--arch", "llama3-405b", "--shape",
                              "decode_32k"], 0),
    ("c 16x16 vlm long", ["--arch", "llama-3.2-vision-11b", "--shape",
                          "long_500k"], 0),
    ("g", ["--arch", "gemma-2b", "--batch", str(GEMMA_WIDE_B), "--seq-len",
           str(GEMMA_WIDE_SEQ), "--policy", "baseline", "--dtype", "float32",
           "--depth", str(GEMMA_WIDE_DEPTH), "--mesh-shape", "1x2"], 0)) + tuple(
    (name, ["--arch", arch, "--batch", str(GEMMA_WIDE_B), "--seq-len",
            str(GEMMA_WIDE_SEQ), "--policy", "baseline", "--dtype", "float32",
            "--depth", str(depth), "--mesh-shape", "1x2"], 0)
    for name, arch, depth in TP_RECURRENT)
# the dry-run's cases compute nothing on the card and need no measurement
# to run (phase 21 compares their records afterwards), so they run beside
# other phases: the production traces that take a minute or more of CPU
# from phase 17 on (beside GPU-bound work), the rest from phase 20 on
DRYRUN_EARLY = ("c 16x16 falcon", "c 16x16 rgemma", "c 256x1 llama",
                "c 16x16 llama decode", "c 16x16 vlm long")
DRYRUN_PROCS: dict = {}
DRYRUN_PEAK_RTOL = 0.10
# (c): the decode caches the cache rule splits over their positions on
# (16, 16), and a member's bytes of each (every leaf; the vlm's cross
# caches, 52 461 568 B, are whole before and after) when the port held the
# split leaves whole over model (the dry-run's records then, PERF.md):
# (arch, shape, bytes)
DRYRUN_SEQ_SPLIT = (("llama3-405b", "decode_32k", 135291469824),
                    ("llama-3.2-vision-11b", "long_500k", 1126203392))
# what phases 17(b), 20(c), 20(d) and 20(g) measured, for phase 21
MEASURED: dict = {}
ROWS_SRC = "src/repro_torch/kernels/csrc/rows.cu"
TILES_SRC = "src/repro_torch/kernels/csrc/tiles.cu"

# per kernel: the TPU kernel it replaces, its source, and what it must move
# and compute: bytes per element as a function of x's element size (each
# input read once, each output written once), bytes per call, and float32
# operations per element (top-k, select then replay: |x| with the denormal
# flush, key, max, candidate compare and count, final compare + select;
# QSGD on the engine's path, its norms computed: square, sum and 11
# elementwise ops; scaled sign + EF: add, |.|, sum, sign, scale, subtract)
KERNELS = {
    "sign_ef_rows": ("src/repro/kernels/sign_ef.py:55", ROWS_SRC,
                     lambda sx: 16, 0, 6),
    "topk_rows": ("src/repro/kernels/topk_mask.py:83", ROWS_SRC,
                  lambda sx: 8, 0, 7),
    "qsgd_rows": ("src/repro/kernels/qsgd.py:64", ROWS_SRC,
                  lambda sx: 12, 0, 13),
    "block_topk_tiles": ("src/repro/kernels/topk_mask.py:42", TILES_SRC,
                         lambda sx: 2 * sx, 0, 7),
    "qsgd_tiles": ("src/repro/kernels/qsgd.py:28", TILES_SRC,
                   lambda sx: 2 * sx + 4, 4, 11),
    "sign_ef_tiles": ("src/repro/kernels/sign_ef.py:23", TILES_SRC,
                      lambda sx: sx + 12, 0, 6),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(name: str, n: int, sx: int = 4, extra: int = 0) -> tuple:
    """The least time for ``name`` on n elements of x's size sx, with
    ``extra`` bytes more to move (QSGD's norms, where they are given)."""
    _, _, b_elem, b_call, ops = KERNELS[name]
    t_bytes = (n * b_elem(sx) + b_call + extra) / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int) -> float:
    """The kernel alone on the device: ``reps`` calls captured in one CUDA
    graph, replayed three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm on a side stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def wall_s(fn):
    """One call on the host clock, the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} numpy {np.__version__}")
    return smi


def build() -> None:
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    so = kbuild.build()
    kbuild.lib()
    log(f"build: {so.name} from {len(kbuild.sources())} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(topk_rows_warp|topk_rows_block|qsgd_rows_group|"
                      r"qsgd_rows_flat|qsgd_rows_block|sign_ef_rows_group|"
                      r"sign_ef_rows_warp|sign_ef_rows_block|topk_tiles_warp|"
                      r"topk_tiles_staged|sign_ef_tiles_warp|qsgd_tiles_kernel)"
                      r"(?:I((?:Li\d+E|Lb[01]E|f|13__nv_bfloat16)+)E)?", line)
        if m and "Compiling" in line:
            # the template arguments, as mangled: ints, bools, the x type
            args = [i or {"1": "vec", "0": "scalar"}.get(b) or
                    ("float" if f else "bf16") for i, b, f, _ in re.findall(
                        r"Li(\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)",
                        m.group(2) or "")]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")


def _record(table, name, err, ms, dev_ms, plain_ms, b_ms, b_by, headline):
    row = table.setdefault(name, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    if headline:
        row.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by)


def _compare(name, what, got, want, tolerant):
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if tolerant else [(got, want)]
    for g, w in pairs:
        if tolerant:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        elif not torch.equal(g, w):
            raise AssertionError(f"{name} {what}: kernel differs from its "
                                 "plain version")
    return max(float((g.float() - w.float()).abs().max()) if g.numel()
               else 0.0 for g, w in pairs)


def _row_inputs(dev, gen, shape, offset=0):
    """x, e (EF state) and u (dither) of ``shape``; each a view ``offset``
    elements into its storage."""
    n = shape[0] * shape[1]

    def draw(fn, scale=1.0):
        return (scale * fn(offset + n, device=dev, generator=gen))[
            offset:].view(shape)
    x, e, u = draw(torch.randn), draw(torch.randn, 0.1), draw(torch.rand)
    if offset and x.data_ptr() % 16 == 0:
        raise AssertionError(f"row case {shape} offset {offset}: the view "
                             "is 16-byte aligned")
    return x, e, u


def _row_runs(x, e, u, k, lv, norms):
    """(kernel, plain) per row kernel; ``qsgd_rows`` is the engine's path,
    its norms computed in the kernel, and ``qsgd_rows+norms`` the TPU
    kernel's interface, its norms given."""
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    return {
        "topk_rows": (lambda: topk_mask.topk_rows(x, k),
                      lambda: topk_mask.topk_rows_plain(x, k)),
        "qsgd_rows": (lambda: qsgd.qsgd_rows(x, u, None, lv),
                      lambda: qsgd.qsgd_rows_plain(x, u, None, lv)),
        "qsgd_rows+norms": (lambda: qsgd.qsgd_rows(x, u, norms, lv),
                            lambda: qsgd.qsgd_rows_plain(x, u, norms, lv)),
        "sign_ef_rows": (lambda: sign_ef.sign_ef_rows(x, e),
                         lambda: sign_ef.sign_ef_rows_plain(x, e)),
    }


def _median_rounds(timed: dict, floors: dict, iters: int) -> dict:
    """RATIO_ROUNDS alternating rounds: each floor, then each timed call,
    by device_ms; returns each timed call's median device ms and median
    ratio to its floor."""
    got = {name: ([], []) for name in timed}
    for rnd in range(RATIO_ROUNDS):
        f_ms = {name: device_ms(fn, iters) for name, fn in floors.items()}
        line = ", ".join(f"{n} {v * 1e3:.4f} us" for n, v in f_ms.items())
        for name, (fn, floor) in timed.items():
            t_ms = device_ms(fn, iters)
            got[name][0].append(t_ms)
            got[name][1].append(t_ms / f_ms[floor])
            line += (f"; {name} {t_ms * 1e3:.4f} us = "
                     f"{got[name][1][-1]:.3f}x {floor}")
        log(f"floor round {rnd}: {line}")
    return {name: (float(np.median(t)), float(np.median(r)), min(r), max(r))
            for name, (t, r) in got.items()}


def check_floor(dev, x, e, u, lv, iters) -> None:
    """The card's floor for a one-wave row kernel at the engine's block,
    beside scaled sign, QSGD given its norms and the engine's QSGD call."""
    from repro_torch.kernels import ops, qsgd, sign_ef
    rows, d = x.shape
    one = torch.zeros(1, device=dev)
    o12 = torch.empty_like(x)
    o16 = torch.empty(2 * rows, d, device=dev)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    floors = {"launch": lambda: one.add_(1.0),
              "12 B/elem": lambda: torch.add(x, u, out=o12),
              "16 B/elem": lambda: torch.cat((x, e), out=o16)}
    timed = {"sign_ef_rows": (lambda: sign_ef.sign_ef_rows(x, e),
                              "16 B/elem"),
             "qsgd_rows+norms": (lambda: qsgd.qsgd_rows(x, u, norms, lv),
                                 "12 B/elem"),
             "ops.qsgd_rows": (lambda: ops.qsgd_rows(x, u, lv),
                               "12 B/elem")}
    for name, (t_ms, ratio, lo, hi) in _median_rounds(
            timed, floors, iters).items():
        log(f"floor {name} {tuple(x.shape)}: device_ms {t_ms:.6f}, "
            f"{ratio:.3f}x the {timed[name][1]} floor (rounds {lo:.3f}-"
            f"{hi:.3f}), the median of {RATIO_ROUNDS} alternating rounds")


def check_kernels(dev, table: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    lv = torch.tensor(256.0, device=dev)
    for shape in SHAPES:
        rows, d = shape
        x, e, u = _row_inputs(dev, gen, shape)
        k = torch.tensor(float(max(1, d // 100)), device=dev)
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        iters = 200 if rows * d <= 1 << 22 else 20
        runs = _row_runs(x, e, u, k, lv, norms)
        dev_t = {}
        for name, (kern, plain) in runs.items():
            kname = name.split("+")[0]
            err = _compare(name, shape, kern(), plain(),
                           kname == "sign_ef_rows")
            ms, plain_ms = time_ms(kern, iters), time_ms(plain, iters)
            dev_t[name] = device_ms(kern, iters)
            b_ms, b_by = bound_ms(kname, rows * d,
                                  extra=4 * rows if "+" in name else 0)
            log(f"kernel {name} {shape}: max_abs_err {err:.3g} "
                f"ms {ms:.5f} device_ms {dev_t[name]:.5f} "
                f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.5f} ({b_by})")
            _record(table, name, err, ms, dev_t[name], plain_ms, b_ms, b_by,
                    shape == ENGINE_BLOCK)
        if shape == ENGINE_BLOCK:
            ratios = []
            for _ in range(RATIO_ROUNDS):
                t_ms = device_ms(runs["topk_rows"][0], iters)
                s_ms = device_ms(runs["sign_ef_rows"][0], iters)
                ratios.append(t_ms / s_ms)
                log(f"kernel topk_rows {shape}: device_ms {t_ms:.5f}, "
                    f"sign_ef_rows {s_ms:.5f}, ratio {ratios[-1]:.3f}")
            log(f"kernel topk_rows {shape}: device time "
                f"{float(np.median(ratios)):.3f}x sign_ef_rows's, the "
                f"median of {RATIO_ROUNDS} alternating rounds")
            check_floor(dev, x, e, u, lv, iters)
        del x, e, u, norms
    for shape, offset in ROW_CASES:
        x, e, u = _row_inputs(dev, gen, shape, offset)
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        runs = _row_runs(x, e, u, None, lv, norms)
        del runs["topk_rows"]
        for name, (kern, plain) in runs.items():
            err = _compare(name, f"{shape} offset {offset}", kern(), plain(),
                           name == "sign_ef_rows")
            table[name.split("+")[0]]["max_abs_err"] = max(
                table[name.split("+")[0]]["max_abs_err"], err)
            log(f"kernel {name} {shape} offset {offset}: max_abs_err "
                f"{err:.3g} device_ms {device_ms(kern, 200):.5f}")
        del x, e, u, norms
    check_qsgd_flat(dev, table)


def check_qsgd_flat(dev, table: dict) -> None:
    """QSGD given its norms at FLAT_QSGD_SHAPE, rows x d past 2^32 (the
    flat pass, whose index must be 64-bit), against its plain version row
    by row (the plain version's temporaries at the whole size would not fit
    beside the three 17.9 GB operands); all freed before returning."""
    from repro_torch.kernels import qsgd
    rows, d = FLAT_QSGD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(rows, d, device=dev, generator=gen)
    u = torch.rand(rows, d, device=dev, generator=gen)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    lv = torch.tensor(256.0, device=dev)
    out, secs = wall_s(lambda: qsgd.qsgd_rows(x, u, norms, lv))
    for r in range(rows):
        if not torch.equal(out[r:r + 1], qsgd.qsgd_rows_plain(
                x[r:r + 1], u[r:r + 1], norms[r:r + 1], lv)):
            raise AssertionError(f"qsgd_rows {FLAT_QSGD_SHAPE}: row {r} "
                                 "differs from its plain version")
    log(f"kernel qsgd_rows+norms {FLAT_QSGD_SHAPE} (rows x d = {rows * d} "
        f"> 2^32): bitwise its plain version row by row; {secs * 1e3:.3f} "
        f"ms a call")
    del x, u, norms, out
    torch.cuda.empty_cache()


def check_tile_kernels(dev, table: dict) -> None:
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape, dt, offset in TILE_CASES:
        n = int(np.prod(shape))
        x = torch.randn(offset + n, device=dev, generator=gen).to(dt)
        x = x[offset:].view(shape)
        if offset and x.data_ptr() % 16 == 0:
            raise AssertionError(f"tile case {shape} offset {offset}: the "
                                 "view is 16-byte aligned")
        e = 0.1 * torch.randn(shape, device=dev, generator=gen)
        u = torch.rand(-(-n // 8192) * 8, 1024, device=dev, generator=gen)
        norm = torch.linalg.vector_norm(x.to(torch.float32).reshape(-1))
        runs = {
            "block_topk_tiles": (
                lambda: topk_mask.block_topk_tiles(x, TILE_K),
                lambda: topk_mask.block_topk_tiles_plain(x, TILE_K)),
            "qsgd_tiles": (
                lambda: qsgd.qsgd_tiles(x, u, norm, TILE_LEVELS),
                lambda: qsgd.qsgd_tiles_plain(x, u, norm, TILE_LEVELS)),
            "sign_ef_tiles": (lambda: sign_ef.sign_ef_tiles(x, e),
                              lambda: sign_ef.sign_ef_tiles_plain(x, e)),
        }
        what = (f"{shape} {str(dt).split('.')[-1]}"
                + (f" offset {offset}" if offset else ""))
        iters = 200 if n <= 1 << 22 else 12
        for name, (kern, plain) in runs.items():
            err = _compare(name, what, kern(), plain(),
                           name == "sign_ef_tiles")
            ms, plain_ms = time_ms(kern, iters), time_ms(plain, iters // 4)
            dev_ms = device_ms(kern, iters)
            b_ms, b_by = bound_ms(name, n, x.element_size())
            log(f"kernel {name} {what}: max_abs_err {err:.3g} "
                f"ms {ms:.5f} device_ms {dev_ms:.5f} "
                f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.5f} ({b_by})")
            _record(table, name, err, ms, dev_ms, plain_ms, b_ms, b_by,
                    n == GRAD_ELEMS and dt == torch.float32 and not offset)
        del x, e, u, norm
    torch.cuda.empty_cache()


def _same_bits(a, b) -> bool:
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def check_topk_adversarial(dev) -> None:
    """Both top-k kernels bit for bit against their plain versions on rows
    built to break a selection: the warp path at 32, 33 and 1024 columns,
    the block path at 3000 (cached row) and 65536 (re-read)."""
    from repro_torch.kernels import ref, topk_mask
    n_cases = 0
    for rows, d in ADVERSARIAL_SHAPES:
        x = torch.from_numpy(ref.topk_adversarial(rows, d, seed=d)).to(dev)
        for k in (-1.0, 0.0, 0.5, 1.0, 3.7, 10.0, 40.0, d - 1.0, float(d),
                  d + 5.0):
            kt = torch.tensor(k, device=dev)
            if not _same_bits(topk_mask.topk_rows(x, kt),
                              topk_mask.topk_rows_plain(x, kt)):
                raise AssertionError(f"topk_rows adversarial ({rows}, {d}) "
                                     f"k={k}: kernel differs from plain")
            n_cases += 1
        # a ragged last tile row, from the storage's start and from a view
        # one element in (not 16-byte aligned)
        n_flat = x.numel() - 77
        for dt, offset in [(torch.float32, 0), (torch.float32, 1),
                           (torch.bfloat16, 0), (torch.bfloat16, 1)]:
            xf = x.reshape(-1).to(dt)[offset:offset + n_flat]
            for k in (-1, 0, 1, 10, 31, 32, 40, 1023, 1024, 1030):
                if not _same_bits(topk_mask.block_topk_tiles(xf, k),
                                  topk_mask.block_topk_tiles_plain(xf, k)):
                    raise AssertionError(
                        f"block_topk_tiles adversarial {n_flat} {dt} "
                        f"offset {offset} k={k}: kernel differs from plain")
                n_cases += 1
        del x, xf
    torch.cuda.synchronize()
    log(f"topk adversarial: both kernels bitwise equal to plain in "
        f"{n_cases} cases (NaN, +-inf, zero, denormal, tie, constant and "
        f"overflow rows)")


def run_api(dev) -> dict:
    """The whole-tensor APIs once each on a 10^8-element gradient."""
    from repro_torch import random as trandom
    from repro_torch.kernels import ops, qsgd, topk_mask
    counters = _tile_counters()
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(GRAD_ELEMS, device=dev, generator=gen)
    e = 0.1 * torch.randn(GRAD_ELEMS, device=dev, generator=gen)
    key = trandom.PRNGKey(7, dev)
    calls = {"block_topk_tiles": lambda: ops.block_topk(x),
             "qsgd_tiles": lambda: ops.qsgd_quantize(key, x),
             "sign_ef_tiles": lambda: ops.sign_ef_compress(x, e)}
    for call in calls.values():  # warm-up: allocator and first launches
        call()
    rows = -(-GRAD_ELEMS // 8192) * 8
    u, draw_s = wall_s(lambda: trandom.uniform(key, (rows, 1024)))
    for fn in counters.values():
        fn.launches = 0
    outs, secs = {}, {}
    for name, call in calls.items():
        outs[name], secs[name] = wall_s(call)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"api at {GRAD_ELEMS} elements: block_topk {secs['block_topk_tiles']:.6f} s, "
        f"qsgd_quantize {secs['qsgd_tiles']:.6f} s (threefry draw of u "
        f"{draw_s:.6f} s = {draw_s / secs['qsgd_tiles']:.3f} of it), "
        f"sign_ef_compress {secs['sign_ef_tiles']:.6f} s; "
        f"launches {launches}")
    if any(v != 1 for v in launches.values()):
        raise AssertionError(f"api: each kernel must launch once: {launches}")
    # the outputs, by the repo's own means: the plain versions on the same
    # inputs (and the same dither), finite, shaped like the gradient, and the
    # EF invariant c + e' = x + e
    norm = torch.linalg.vector_norm(x.to(torch.float32).reshape(-1))
    if not (torch.equal(outs["block_topk_tiles"],
                        topk_mask.block_topk_tiles_plain(x, TILE_K))
            and torch.equal(outs["qsgd_tiles"], qsgd.qsgd_tiles_plain(
                x, u, norm, TILE_LEVELS))):
        raise AssertionError("api: block_topk / qsgd_quantize differ from "
                             "their plain versions")
    c, e_new = outs["sign_ef_tiles"]
    torch.testing.assert_close(c + e_new, x + e, rtol=1e-5, atol=1e-6)
    kept = int((outs["block_topk_tiles"] != 0).sum())
    for out in (outs["block_topk_tiles"], outs["qsgd_tiles"], c, e_new):
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError("api: output not finite or misshapen")
    log(f"api: block_topk kept {kept} of {GRAD_ELEMS} "
        f"({kept / GRAD_ELEMS:.5f}, k = {TILE_K} of 1024 per row)")
    del x, e, u, outs, c, e_new
    torch.cuda.empty_cache()
    return launches


def _loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def _snr_margin(seed: int, n: int, rounds: int, fp, max_retries: int) -> float:
    """The smallest ``|snr / snr_min - 1|`` a fault run meets on the CPU:
    each round's Gauss-Markov draw and every retry draw, all clients."""
    from repro_torch import random as trandom
    from repro_torch.core import faults, wireless
    chan = wireless.channel_params(wireless.WirelessConfig(n_devices=n))
    k_pos, k_rounds = trandom.split(trandom.PRNGKey(seed))
    dist = wireless.sample_positions_jax(k_pos, chan, n)
    fad = torch.zeros(n, 2)
    worst = float("inf")
    for t in range(rounds):
        kt = trandom.fold_in(k_rounds, t)
        fad, power = faults.gauss_markov_fading(fp, kt, fad, t)
        for p in [power] + [faults.retry_fading(kt, r, n)
                            for r in range(1, max_retries + 1)]:
            snr = wireless.snr_jax(dist, p, chan)
            worst = min(worst, float((snr / fp.snr_min - 1.0).abs().min()))
    return worst


def check_against_cpu(dev) -> None:
    """The engine on the card against the engine on the CPU."""
    from repro_torch.core import faults, privacy
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.data import make_linear_datagen
    from repro_torch.fl import runtime as rt
    d, n, rounds, seed = 256, 4096, REF_ROUNDS, 20
    w_star = np.random.default_rng(42).standard_normal(d).astype(np.float32)
    fp = faults.fault_params(**FAULTS)
    pp = privacy.privacy_params(**PRIVACY)
    cases = ([(a, c, {}) for a, c in (
        [("fedavg", c) for c in ("topk", "qsgd", "scaled_sign")]
        + [(a, "topk") for a in ("scaffold", "fedadam", "fedbuff")])]
        + [(a, c, dict(faults=fp, max_retries=MAX_RETRIES)) for a, c in (
            [("fedavg", c) for c in ("topk", "qsgd", "scaled_sign")]
            + [("fedbuff", "topk")])]
        + [("fedavg", c, dict(privacy=p, privacy_params=pp))
           for p, c in PRIV_CASES])
    margin = _snr_margin(seed, n, rounds, fp, MAX_RETRIES)
    log(f"reference: the CPU fault runs' smallest |snr / snr_min - 1| is "
        f"{margin:.3g}")
    if margin <= SNR_MARGIN:
        raise AssertionError(f"reference: an SNR lies within {margin:.3g} "
                             "of the decode threshold; pick another seed")
    for algo, comp, extra in cases:
        logs, secs = [], []
        for device in (dev, "cpu"):
            t0 = time.perf_counter()
            cfg = rt.SimConfig(
                n_devices=n, n_scheduled=64, rounds=rounds, local_steps=2,
                policy="random", compression=comp, chunk_size=1024,
                seed=seed, algorithm=algo,
                algo_params=algos.algo_params(lr=0.1),
                datagen=make_linear_datagen(w_star), **extra)
            _, lg = rt.run_simulation_scan(
                cfg, _loss, {"w": np.zeros(d, np.float32)}, device=device)
            logs.append(lg)
            secs.append(time.perf_counter() - t0)
        g, c = logs
        what = " ".join(v for v in (algo, comp, extra.get("privacy"),
                                    "faults" if "faults" in extra else None)
                        if v)
        rel = _card_equals_cpu(what, g, c)
        log(f"reference {what}: card == cpu (participation, bits, "
            f"survivors {c.n_survived.tolist()}, drops "
            f"{c.n_dropped.tolist()}, retransmissions "
            f"{c.retransmissions.tolist()}); loss max rel diff {rel:.3g}; "
            f"epsilon {c.epsilon.tolist()}; s card / cpu "
            f"{secs[0]:.2f} / {secs[1]:.2f}")
    check_sweep_and_host_against_cpu(dev, w_star, d, n, seed)


def _card_equals_cpu(what, g, c) -> float:
    """Logs of the card against the CPU's: counts, participation and bits
    equal, loss within rtol 1e-4, latency and epsilon within rtol 1e-5.
    Returns the loss's largest relative difference."""
    for f in ("participation", "n_scheduled", "uplink_bits", "downlink_bits",
              "n_survived", "n_dropped", "retransmissions", "mask_bits"):
        np.testing.assert_array_equal(getattr(g, f), getattr(c, f),
                                      err_msg=f"{what} {f}")
    for f, rtol in (("loss", 1e-4), ("latency_s", 1e-5), ("epsilon", 1e-5)):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=rtol,
                                   err_msg=f"{what} {f}")
    return float(np.max(np.abs(np.asarray(g.loss) - c.loss)
                        / np.abs(c.loss)))


def check_sweep_and_host_against_cpu(dev, w_star, d, n, seed) -> None:
    """A sweep (seeds x policies in mixture mode x a dropout grid x privacy
    none and dp) and the host loop with an opaque eval_fn, each on the
    card against the CPU."""
    from repro_torch import random as trandom
    from repro_torch.core import faults, privacy
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.data import make_linear_datagen
    from repro_torch.fl import runtime as rt
    datagen = make_linear_datagen(w_star)
    cfg = rt.SimConfig(n_devices=n, n_scheduled=64, rounds=REF_ROUNDS,
                       local_steps=2, compression="topk", chunk_size=1024,
                       seed=seed,
                       algo_params=algos.algo_params(lr=0.1),
                       datagen=datagen)
    params0 = {"w": np.zeros(d, np.float32)}
    sweeps, sweep_s = [], []
    for device in (dev, "cpu"):
        out, secs = wall_s(lambda: rt.run_sweep(
            cfg, _loss, params0, None, seeds=(0,),
            policies=("random", "best_channel"),
            fparams_grid=[faults.fault_params(drop_prob=REF_SWEEP_DROP)],
            privacies=("none", "dp"),
            pparams_grid=[privacy.privacy_params(**PRIVACY)],
            device=device))
        sweeps.append(out)
        sweep_s.append(secs)
    log(f"reference sweep: s card / cpu {sweep_s[0]:.2f} / "
        f"{sweep_s[1]:.2f}")
    for key, c in sweeps[1].items():
        rel = _card_equals_cpu(f"sweep {key}", sweeps[0][key], c)
        log(f"reference sweep {key} {c.loss.shape[0]} variants: card == "
            f"cpu; loss max rel diff {rel:.3g}; survivors "
            f"{c.n_survived.sum(axis=1).tolist()}")
    eval_cpu = datagen(trandom.PRNGKey(999), torch.arange(64))
    hosts = []
    for device in (dev, "cpu"):
        eval_batch = {k: v.to(device) for k, v in eval_cpu.items()}
        hosts.append(rt.run_simulation(
            cfg, _loss, params0, None,
            eval_fn=lambda p, b=eval_batch: float(_loss(p, b)[0]),
            engine="host", device=device))
    g, c = ({f: np.array([getattr(r, f) for r in logs])
             for f in ("participation", "n_scheduled", "uplink_bits",
                       "downlink_bits", "n_survived", "n_dropped",
                       "retransmissions", "mask_bits", "loss", "latency_s",
                       "epsilon")}
            for logs in hosts)
    rel = _card_equals_cpu("host", SimpleNamespace(**g),
                           SimpleNamespace(**c))
    log(f"reference host loop (opaque eval_fn): card == cpu; loss "
        f"{c['loss'].tolist()}, max rel diff {rel:.3g}")


def _fleet_run(dev, datagen, rounds, full_schedule=True, **kw):
    """One warmed-up engine run at the fleet configuration, every row
    launch counter set to 0 just before it and read just after. Under churn
    fewer than ``n_scheduled`` clients may be online: ``full_schedule=False``
    asks only for at most that many."""
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    counters = _row_counters()

    def cfg(r):
        return rt.SimConfig(rounds=r, datagen=datagen,
                            algo_params=algos.algo_params(lr=0.05),
                            **FLEET, **kw)
    params0 = {"w": np.zeros(D_FLEET, np.float32)}
    rt.run_simulation_scan(cfg(1), _loss, params0, device=dev)  # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    (params, logs), dt = wall_s(
        lambda: rt.run_simulation_scan(cfg(rounds), _loss, params0,
                                       device=dev))
    counts = {n: fn.launches for n, fn in counters.items()}
    what = " ".join(str(v) for v in kw.values() if isinstance(v, str))
    if not np.all(np.isfinite(logs.loss)) or not (
            logs.loss[-1] < logs.loss[0]):
        raise AssertionError(f"engine {what}: loss not finite or not "
                             f"falling: {logs.loss}")
    if params["w"].shape != (D_FLEET,) or not bool(
            torch.isfinite(params["w"]).all()):
        raise AssertionError(f"engine {what}: bad final params")
    if not (np.all(logs.n_scheduled == FLEET["n_scheduled"])
            if full_schedule
            else np.all(logs.n_scheduled <= FLEET["n_scheduled"])):
        raise AssertionError(f"engine {what}: schedule size off")
    return rounds / dt, counts, logs, params["w"]


def _datagen():
    from repro_torch.data import make_linear_datagen
    w_star = np.random.default_rng(42).standard_normal(D_FLEET).astype(
        np.float32)
    return make_linear_datagen(w_star, local_steps=2, batch=BATCH)


def run_engine(dev, smi: str) -> tuple:
    datagen = _datagen()
    launches, rates = {}, {}
    for comp, kname in KERNEL_OF.items():
        rate, counts, logs, _ = _fleet_run(dev, datagen, ROUNDS,
                                           compression=comp)
        launches[kname] = counts[kname]
        rates[comp] = rate
        log(f"engine {comp}: {rate:.4f} rounds/s at N="
            f"{FLEET['n_devices']} on {smi}; launches {counts}; "
            f"loss {logs.loss.tolist()}")
        if counts[kname] == 0:
            raise AssertionError(f"engine {comp} never launched {kname}")
    return launches, rates


def run_algorithms(dev, smi: str) -> None:
    datagen = _datagen()
    blocks = -(-FLEET["n_devices"] // FLEET["chunk_size"])
    for algo in ALGOS:
        rate, counts, logs, _ = _fleet_run(dev, datagen, ALGO_ROUNDS,
                                           compression="topk",
                                           algorithm=algo)
        per_round = blocks * (2 if algo == "scaffold" else 1)
        log(f"algorithm {algo}: {rate:.4f} rounds/s at N="
            f"{FLEET['n_devices']} (top-k, dense EF) on {smi}; launches "
            f"{counts}; loss {logs.loss.tolist()}")
        if counts["topk_rows"] != per_round * ALGO_ROUNDS:
            raise AssertionError(
                f"algorithm {algo}: topk_rows launched {counts['topk_rows']}"
                f" times, expected {per_round} per round")


def _check_launches(what, counts, kname, rounds) -> None:
    blocks = -(-FLEET["n_devices"] // FLEET["chunk_size"])
    if counts[kname] != blocks * rounds:
        raise AssertionError(f"{what}: {kname} launched {counts[kname]} "
                             f"times, expected {blocks} per round")


def run_faults(dev, smi: str, base_rates: dict) -> None:
    from repro_torch.core import faults
    datagen = _datagen()
    fp = faults.fault_params(**FAULTS)
    for comp, kname in KERNEL_OF.items():
        rate, counts, logs, _ = _fleet_run(
            dev, datagen, ALGO_ROUNDS, full_schedule=False, compression=comp,
            faults=fp, max_retries=MAX_RETRIES)
        log(f"faults {comp}: {rate:.4f} rounds/s at N={FLEET['n_devices']} "
            f"(fault-free {base_rates[comp]:.4f}, phase 7) on {smi}; "
            f"launches {counts}; scheduled {logs.n_scheduled.tolist()}, "
            f"survived {logs.n_survived.tolist()}, dropped "
            f"{logs.n_dropped.tolist()}, retransmissions "
            f"{logs.retransmissions.tolist()}; loss {logs.loss.tolist()}")
        _check_launches(f"faults {comp}", counts, kname, ALGO_ROUNDS)
        if not (np.all(logs.n_survived + logs.n_dropped <= logs.n_scheduled)
                and np.all(logs.n_dropped > 0)):
            raise AssertionError(f"faults {comp}: survivors and drops off")


def run_privacy(dev, smi: str) -> None:
    from repro_torch.core import privacy
    from repro_torch.fl import server
    datagen = _datagen()
    pp = privacy.privacy_params(**PRIVACY)
    finals = {}
    for priv, comp in PRIV_CASES + (("_secagg_unmasked", "qsgd"),):
        kname = KERNEL_OF[comp]
        rate, counts, logs, w = _fleet_run(
            dev, datagen, ALGO_ROUNDS, compression=comp, privacy=priv,
            privacy_params=pp)
        finals[priv] = (logs, w)
        log(f"privacy {priv} {comp}: {rate:.4f} rounds/s at N="
            f"{FLEET['n_devices']} on {smi}; launches {counts}; epsilon "
            f"{logs.epsilon.tolist()}; mask bits {logs.mask_bits.tolist()}; "
            f"loss {logs.loss.tolist()}")
        _check_launches(f"privacy {priv}", counts, kname, ALGO_ROUNDS)
        if privacy.get_privacy(priv).uses_dp and not (
                np.all(np.isfinite(logs.epsilon))
                and np.all(np.diff(logs.epsilon) >= 0)):
            raise AssertionError(f"privacy {priv}: epsilon not finite or "
                                 "decreasing")
    (masked, w_masked), (plain, w_plain) = (finals["secagg"],
                                            finals["_secagg_unmasked"])
    if not (np.array_equal(masked.loss, plain.loss)
            and torch.equal(w_masked, w_plain)):
        raise AssertionError("privacy: secagg differs from the same run "
                             "without masks")
    log(f"privacy: secagg's final params and losses bit for bit those of "
        f"_secagg_unmasked at N={FLEET['n_devices']}")
    # the mask prepass of one round alone: the survivor set of a round
    from repro_torch import random as trandom
    n = FLEET["n_devices"]
    part = torch.zeros(n, device=dev)
    part[torch.randperm(n, device=dev)[:FLEET["n_scheduled"]]] = 1.0
    key = trandom.PRNGKey(3, dev)
    server._mask_prepass(key, n, D_FLEET, part, FLEET["chunk_size"])
    times = [wall_s(lambda: server._mask_prepass(
        key, n, D_FLEET, part, FLEET["chunk_size"]))[1] for _ in range(3)]
    log(f"privacy: mask prepass of one round at N={n}, d={D_FLEET}, blocks "
        f"of {FLEET['chunk_size']}: {min(times):.6f} s (min of 3; "
        f"{[round(t, 6) for t in times]}) on {smi}")


def _row_counters() -> dict:
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    return {"topk_rows": topk_mask.topk_rows, "qsgd_rows": qsgd.qsgd_rows,
            "sign_ef_rows": sign_ef.sign_ef_rows}


def _tile_counters() -> dict:
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    return {"block_topk_tiles": topk_mask.block_topk_tiles,
            "qsgd_tiles": qsgd.qsgd_tiles,
            "sign_ef_tiles": sign_ef.sign_ef_tiles}


def _linear_batches():
    """``benchmarks/common.make_linear_problem``'s ``make_batches`` at d =
    32, H = 2, B = 8; w* is the port's ``normal(PRNGKey(42), (32,))``."""
    from repro_torch import random as trandom
    w_star = trandom.normal(trandom.PRNGKey(42), (D_FLEET,)).numpy()

    def make_batches(t, n):
        rng = np.random.default_rng(t)
        x = rng.normal(size=(n, 2, BATCH, D_FLEET)).astype(np.float32)
        y = x @ w_star + 0.01 * rng.normal(size=(n, 2, BATCH))
        return {"x": x, "y": y.astype(np.float32)}
    return make_batches


def _sweep_batches(rounds: int) -> dict:
    """The linear problem's client batches for SWEEP_N clients, stacked
    over ``rounds``."""
    from repro_torch.fl import runtime as rt
    return rt.stack_batches(_linear_batches(), rounds, SWEEP_N)


def run_sweep(dev, smi: str, base_rates: dict) -> dict:
    """Phase 11: bench_sweep.py's grids and tuner call, then the fleet
    configuration swept. Returns every kernel's launches in (d)."""
    from repro_torch.core import scheduling
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    from repro_torch.fl import tune
    policies = scheduling.policy_names()
    params0 = {"w": np.zeros(D_FLEET, np.float32)}

    def cfg(rounds):
        return rt.SimConfig(n_devices=SWEEP_N, n_scheduled=4, rounds=rounds,
                            compression="topk")

    # (a) the full grid in mixture mode
    batches = _sweep_batches(SWEEP_ROUNDS)
    aps = [algos.algo_params(lr=lr) for lr in SWEEP_LRS]
    out, dt = wall_s(lambda: rt.run_sweep(
        cfg(SWEEP_ROUNDS), _loss, params0, batches, seeds=SWEEP_SEEDS,
        policies=policies, aparams_grid=aps, device=dev))
    n_var = len(policies) * len(SWEEP_SEEDS) * len(aps)
    loss = np.stack([out[p].loss for p in policies])
    if (loss.shape != (len(policies), n_var // len(policies), SWEEP_ROUNDS)
            or not np.all(np.isfinite(loss))
            or not loss[..., -1].mean() < loss[..., 0].mean()):
        raise AssertionError(f"sweep: losses misshapen, not finite or not "
                             f"falling: {loss.shape}")
    log(f"sweep bench_sweep grid: {n_var} variants x {SWEEP_ROUNDS} rounds "
        f"(N={SWEEP_N}, top-k, mixture) in {dt:.3f} s = "
        f"{n_var / dt:.3f} variants/s, {n_var * SWEEP_ROUNDS / dt:.2f} "
        f"variant-rounds/s on {smi}; mean loss {loss[..., 0].mean():.4f} "
        f"-> {loss[..., -1].mean():.4f}")
    # (b) the --fast grid in both modes, bitwise equal
    fast = _sweep_batches(FAST_ROUNDS)
    aps_fast = [algos.algo_params(lr=lr) for lr in FAST_LRS]
    modes = {}
    for mode in ("mixture", "loop"):
        modes[mode], secs = wall_s(lambda: rt.run_sweep(
            cfg(FAST_ROUNDS), _loss, params0, fast, seeds=FAST_SEEDS,
            policies=policies, aparams_grid=aps_fast, policy_mode=mode,
            device=dev))
        n_fast = len(policies) * len(FAST_SEEDS) * len(FAST_LRS)
        log(f"sweep fast grid {mode}: {n_fast} variants x {FAST_ROUNDS} "
            f"rounds in {secs:.3f} s = {n_fast / secs:.3f} variants/s")
    for pol in policies:
        for f in rt._LOG_FIELDS:
            if not np.array_equal(getattr(modes["mixture"][pol], f),
                                  getattr(modes["loop"][pol], f)):
                raise AssertionError(f"sweep fast grid {pol} {f}: mixture "
                                     "differs from loop")
    log("sweep fast grid: mixture bitwise equal to loop in every field")
    # (c) bench_sweep.py's tuner call
    traces0 = rt.ENGINE_STATS["traces"]
    res, secs = wall_s(lambda: tune.tune(
        cfg(SWEEP_ROUNDS), _loss, params0, batches, seeds=SWEEP_SEEDS,
        lr_grid=SWEEP_LRS, device=dev, **TUNE))
    if not (np.isfinite(res.best_score) and res.best in res.scores
            and res.n_traces == rt.ENGINE_STATS["traces"] - traces0):
        raise AssertionError(f"tune: bad result {res.best} "
                             f"{res.best_score}")
    log(f"tune: {secs:.3f} s, {res.n_variants} variants "
        f"({secs / res.n_variants * 1e6:.1f} us a variant), "
        f"{len(res.history)} rungs, n_traces {res.n_traces}, best "
        f"{res.best} score {res.best_score:.6f}")
    # (d) the fleet configuration swept
    return _fleet_sweep(dev, smi, base_rates)


def _fleet_sweep(dev, smi: str, base_rates: dict) -> dict:
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    counters = dict(_row_counters(), **_tile_counters())
    blocks = -(-FLEET["n_devices"] // FLEET["chunk_size"])
    params0 = {"w": np.zeros(D_FLEET, np.float32)}
    cfg = rt.SimConfig(rounds=FLEET_SWEEP_ROUNDS, datagen=_datagen(),
                       algo_params=algos.algo_params(lr=0.05),
                       compression="topk", **FLEET)
    launches = dict.fromkeys(counters, 0)
    for comps, pols, seeds in ((("topk",), FLEET_POLICIES, FLEET_SEEDS),
                               (("qsgd", "scaled_sign"), ("random",), (0,))):
        for fn in counters.values():
            fn.launches = 0
        out, dt = wall_s(lambda: rt.run_sweep(
            cfg, _loss, params0, None, seeds=seeds, policies=pols,
            compressions=comps, device=dev))
        counts = {n: fn.launches for n, fn in counters.items()}
        for n, c in counts.items():
            launches[n] += c
        n_vr = len(pols) * len(seeds) * FLEET_SWEEP_ROUNDS
        for comp in comps:
            kname = KERNEL_OF[comp]
            if counts[kname] != blocks * n_vr:
                raise AssertionError(
                    f"fleet sweep {comp}: {kname} launched {counts[kname]} "
                    f"times, expected {blocks} a variant-round")
        for key, logs in out.items():
            if not (np.all(np.isfinite(logs.loss))
                    and np.all(logs.loss[:, -1] < logs.loss[:, 0])
                    and np.all(logs.n_scheduled == FLEET["n_scheduled"])):
                raise AssertionError(f"fleet sweep {key}: loss not finite "
                                     f"or not falling: {logs.loss}")
        log(f"sweep fleet {'/'.join(comps)}: {len(pols)} policies x "
            f"{len(seeds)} seeds x {FLEET_SWEEP_ROUNDS} rounds at N="
            f"{FLEET['n_devices']} in {dt:.3f} s = "
            f"{n_vr * len(comps) / dt:.4f} variant-rounds/s (the single "
            f"run: {base_rates[comps[0]]:.4f} "
            f"rounds/s, phase 7) on {smi}; launches {counts}; loss "
            f"{ {str(k): v.loss.tolist() for k, v in out.items()} }")
    return launches


def run_host(dev, smi: str, base_rates: dict) -> None:
    """Phase 12: the fleet configuration through the host loop with an
    opaque eval_fn, against the scan with the same eval batch."""
    from repro_torch import random as trandom
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    counters = _row_counters()
    blocks = -(-FLEET["n_devices"] // FLEET["chunk_size"])
    datagen = _datagen()
    eval_batch = datagen(trandom.PRNGKey(999, dev),
                         torch.arange(64, device=dev))
    cfg = rt.SimConfig(rounds=HOST_ROUNDS, datagen=datagen,
                       algo_params=algos.algo_params(lr=0.05),
                       compression="topk", **FLEET)
    params0 = {"w": np.zeros(D_FLEET, np.float32)}
    for fn in counters.values():
        fn.launches = 0
    host, dt = wall_s(lambda: rt.run_simulation(
        cfg, _loss, params0, None,
        eval_fn=lambda p: float(_loss(p, eval_batch)[0]), engine="host",
        device=dev))
    counts = {n: fn.launches for n, fn in counters.items()}
    _, scan = rt.run_simulation_scan(cfg, _loss, params0,
                                     eval_batch=eval_batch, device=dev)
    for t, r in enumerate(host):
        if not (np.array_equal(r.participation, scan.participation[t])
                and r.uplink_bits == float(scan.uplink_bits[t])
                and r.loss == float(scan.loss[t])):
            raise AssertionError(f"host round {t} differs from the scan")
    losses = [r.loss for r in host]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"host: loss not finite or falling: {losses}")
    if counts["topk_rows"] != blocks * HOST_ROUNDS:
        raise AssertionError(f"host: topk_rows launched "
                             f"{counts['topk_rows']} times")
    log(f"host loop (opaque eval_fn): {HOST_ROUNDS / dt:.4f} rounds/s at N="
        f"{FLEET['n_devices']} (the scan: {base_rates['topk']:.4f} rounds/s, "
        f"phase 7) on {smi}; participation, uplink bits and eval loss "
        f"equal to the scan's; launches {counts}; eval loss {losses}")


def _hfl_lm(device):
    """examples/hierarchical_fl.py's problem: the examples' LM at N = 21,
    alpha 0.3."""
    from repro_torch.examples import hierarchical_fl as hfl, problems
    return problems.make_lm_problem(hfl.N, 0.3, device=device)


def _hfl_cfg(rounds, **kw):
    from repro_torch.examples import hierarchical_fl as hfl, problems
    return hfl.base_config(problems.D, rounds, **kw)


def _logs_of(round_logs) -> SimpleNamespace:
    return SimpleNamespace(**{f: np.array([getattr(r, f) for r in round_logs])
                              for f in ("participation", "n_scheduled",
                                        "uplink_bits", "downlink_bits",
                                        "n_survived", "n_dropped",
                                        "retransmissions", "mask_bits",
                                        "loss", "latency_s", "epsilon")})


def _hfl_snr_margin(cfg, hcfg, cells) -> float:
    """The smallest ``|snr / snr_min - 1|`` an HFL fault run meets on the
    CPU: each round's Gauss-Markov draw and every retry draw, every device
    against its own SBS."""
    from repro_torch import random as trandom
    from repro_torch.core import faults, hierarchy, wireless
    fp = cfg.faults
    k_geo, k_rounds = trandom.split(trandom.PRNGKey(cfg.seed))
    ids, dist, _, _ = hierarchy.hfl_geometry_jax(k_geo, hcfg, cfg.n_devices)
    chan = wireless.gather_channel_params(
        wireless.stack_channel_params(cells), ids)
    fad = torch.zeros(cfg.n_devices, 2)
    worst = float("inf")
    for t in range(cfg.rounds):
        kt = trandom.fold_in(k_rounds, t)
        fad, power = faults.gauss_markov_fading(fp, kt, fad, t)
        for p in [power] + [faults.retry_fading(kt, r, cfg.n_devices)
                            for r in range(1, cfg.max_retries + 1)]:
            snr = wireless.snr_jax(dist, p, chan)
            worst = min(worst, float((snr / fp.snr_min - 1.0).abs().min()))
    return worst


def run_hfl(dev, smi: str) -> dict:
    """Phase 13: bench_hfl.py's cell on the hierarchical engine. Returns
    each kernel's launches across the phase (all must be 0)."""
    import bisect
    import dataclasses
    from repro_torch.core import faults, privacy
    from repro_torch.core.hierarchy import HFLConfig
    from repro_torch.examples import hierarchical_fl as hfl
    from repro_torch.fl import runtime as rt
    counters = dict(_row_counters(), **_tile_counters())
    for fn in counters.values():
        fn.launches = 0
    cells = hfl.cluster_cells()
    h2 = HFLConfig(n_clusters=7, inter_cluster_period=2)

    # (a) the card against the CPU, and the host loop against the scan
    runs = {}
    for device, engine in ((dev, None), ("cpu", None), (dev, "host")):
        params, loss_fn, sample, eval_fn = _hfl_lm(device)
        runs[device, engine], secs = wall_s(lambda: rt.run_hfl(
            _hfl_cfg(HFL_CHECK_ROUNDS), h2, loss_fn, params, sample,
            eval_fn=eval_fn, cluster_wcfgs=cells, engine=engine,
            device=device))
        log(f"hfl (a) {device} {engine or 'scan'}: {HFL_CHECK_ROUNDS} "
            f"rounds in {secs:.3f} s")
    g, c = (_logs_of(runs[dv, None]) for dv in (dev, "cpu"))
    rel = _card_equals_cpu("hfl (a)", g, c)
    host = _logs_of(runs[dev, "host"])
    for f in vars(g):
        if not np.array_equal(getattr(host, f), getattr(g, f)):
            raise AssertionError(f"hfl (a) host loop differs from the scan "
                                 f"in {f}")
    log(f"hfl (a) H=2, per-cluster cells: card == cpu (participation, "
        f"schedule, uplink and downlink bits; loss max rel diff {rel:.3g}); "
        f"host loop == scan on the card bitwise; loss {g.loss.tolist()}")

    # (b) bench_hfl.py at its 80 rounds on the card
    params, loss_fn, sample, eval_fn = _hfl_lm(dev)
    init_loss = eval_fn({k: v.to(dev) for k, v in params.items()})
    fl_logs, secs = wall_s(lambda: rt.run_simulation(
        _hfl_cfg(HFL_ROUNDS), loss_fn, params, sample, eval_fn=eval_fn,
        wcfg=hfl.macro_cell(), device=dev))
    fl_clock = [r.latency_s for r in fl_logs]
    log(f"hfl (b) flat FL: {HFL_ROUNDS / secs:.4f} rounds/s on {smi}; "
        f"final loss {fl_logs[-1].loss:.6f}; simulated wall clock "
        f"{fl_clock[-1]:.3f} s")
    bench = {"fl": fl_logs}
    for h in hfl.PERIODS:
        params, loss_fn, sample, eval_fn = _hfl_lm(dev)
        logs, secs = wall_s(lambda: rt.run_hfl(
            _hfl_cfg(HFL_ROUNDS), HFLConfig(n_clusters=7,
                                            inter_cluster_period=h),
            loss_fn, params, sample, eval_fn=eval_fn, device=dev))
        bench[h] = logs
        clock = logs[-1].latency_s
        i = min(bisect.bisect_right(fl_clock, clock) - 1, HFL_ROUNDS - 1)
        fl_at_t = fl_logs[i].loss if i >= 0 else init_loss
        log(f"hfl (b) H={h}: {HFL_ROUNDS / secs:.4f} rounds/s on {smi}; "
            f"final loss {logs[-1].loss:.6f}; simulated wall clock "
            f"{clock:.3f} s, speed-up over flat FL "
            f"{fl_clock[-1] / clock:.4f}x; loss at equal wall clock "
            f"{logs[-1].loss:.6f} vs flat FL {fl_at_t:.6f}, ratio "
            f"{logs[-1].loss / fl_at_t:.4f}")
    for key, logs in bench.items():
        losses = [r.loss for r in logs]
        if len(logs) != HFL_ROUNDS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"hfl (b) {key}: {len(logs)} rounds, "
                                 f"losses {losses}")

    # (c) faults, privacy and the sweep at (a)'s cell, card against CPU
    fp = faults.fault_params(**FAULTS)
    pp = privacy.privacy_params(**PRIVACY)
    cases = {"faults": dict(faults=fp, max_retries=MAX_RETRIES),
             "secagg x qsgd": dict(privacy="secagg", compression="qsgd",
                                   privacy_params=pp),
             "dp x topk": dict(privacy="dp", privacy_params=pp)}
    margin = _hfl_snr_margin(_hfl_cfg(HFL_CASE_ROUNDS, **cases["faults"]),
                             h2, cells)
    if margin <= SNR_MARGIN:
        raise AssertionError(f"hfl (c): an SNR lies within {margin:.3g} of "
                             "the decode threshold; pick another seed")
    finals = {}
    for what, kw in cases.items():
        out = {}
        for device in (dev, "cpu"):
            params, loss_fn, sample, eval_fn = _hfl_lm(device)
            cfg = _hfl_cfg(HFL_CASE_ROUNDS, **kw)
            d = torch.device(device)
            wstat, chan = rt._resolve_hfl_channel(cfg, h2, None, cells, d)
            out[device] = rt._run_hfl_scan(
                cfg, h2, loss_fn, params,
                rt.stack_batches(sample, HFL_CASE_ROUNDS, hfl.N),
                eval_fn.eval_batch, chan, wstat, d)
        rel = _card_equals_cpu(f"hfl (c) {what}", out[dev][1],
                                   out["cpu"][1])
        finals[what] = out[dev]
        c = out["cpu"][1]
        log(f"hfl (c) {what}: card == cpu; loss max rel diff {rel:.3g}; "
            f"survivors {c.n_survived.tolist()}, retransmissions "
            f"{c.retransmissions.tolist()}, mask bits {c.mask_bits.tolist()}"
            f", epsilon {c.epsilon.tolist()}")
    params, loss_fn, sample, eval_fn = _hfl_lm(dev)
    cfg = _hfl_cfg(HFL_CASE_ROUNDS, **dict(cases["secagg x qsgd"],
                                           privacy="_secagg_unmasked"))
    wstat, chan = rt._resolve_hfl_channel(cfg, h2, None, cells, dev)
    oracle = rt._run_hfl_scan(cfg, h2, loss_fn, params,
                              rt.stack_batches(sample, HFL_CASE_ROUNDS,
                                               hfl.N),
                              eval_fn.eval_batch, chan, wstat, dev)
    masked = finals["secagg x qsgd"]
    if not (all(torch.equal(masked[0][k], oracle[0][k]) for k in oracle[0])
            and np.array_equal(masked[1].loss, oracle[1].loss)):
        raise AssertionError("hfl (c) secagg differs from its unmasked "
                             "oracle on the card")
    log("hfl (c) secagg x qsgd: final params and losses bit for bit those "
        "of the unmasked oracle on the card")
    sweeps, traces = {}, {}
    for device in (dev, "cpu"):
        params, loss_fn, sample, eval_fn = _hfl_lm(device)
        t0 = rt.ENGINE_STATS["traces"]
        rt._ENGINE_CACHE.clear()
        sweeps[device], secs = wall_s(lambda: rt.run_sweep(
            _hfl_cfg(HFL_CASE_ROUNDS), loss_fn, params,
            rt.stack_batches(sample, HFL_CASE_ROUNDS, hfl.N),
            seeds=[0, 1], policies=["random", "best_channel", "pf"],
            eval_batch=eval_fn.eval_batch,
            hcfgs=[dataclasses.replace(h2, backhaul_rate_bps=r)
                   for r in (1e5, 1e9)], device=device))
        traces[device] = rt.ENGINE_STATS["traces"] - t0
        log(f"hfl (c) sweep on {device}: 3 policies x 2 seeds x 2 backhaul "
            f"rates x {HFL_CASE_ROUNDS} rounds in {secs:.3f} s, "
            f"{traces[device]} traces")
    for key, c in sweeps["cpu"].items():
        rel = _card_equals_cpu(f"hfl (c) sweep {key}",
                                   sweeps[dev][key], c)
        log(f"hfl (c) sweep {key} {c.loss.shape[0]} variants: card == cpu; "
            f"loss max rel diff {rel:.3g}; final clock "
            f"{c.latency_s[:, -1].tolist()}")
    if traces[dev] != 3 or traces["cpu"] != 3:
        raise AssertionError(f"hfl (c) sweep traces {traces}, expected 3")

    # (d) the HFL path reaches no kernel
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"hfl (d) kernel launches across phase 13: {launches}")
    if any(launches.values()):
        raise AssertionError(f"hfl: a kernel launched on the HFL path: "
                             f"{launches}")
    return launches


_GOSSIP_EXACT = ("uplink_bits", "backhaul_bits", "n_edges", "n_online")


def _gossip_card_equals_cpu(what, g, c, gp=None, cp=None) -> int:
    """Gossip logs of the card against the CPU's: bits, edges and online
    counts equal, latency within rtol 1e-5, loss and drift within rtol 1e-4
    (drift atol 1e-6: a fog sync leaves round-off). With final params,
    returns how many coordinates differ by more than atol 1e-5 (QSGD's
    dither can round a coordinate to the neighbouring level where the
    card's message norm differs from the CPU's by an ulp)."""
    for f in _GOSSIP_EXACT:
        np.testing.assert_array_equal(getattr(g, f), getattr(c, f),
                                      err_msg=f"{what} {f}")
    for f in ("latency_s", "comm_s", "comp_s"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-5,
                                   err_msg=f"{what} {f}")
    np.testing.assert_allclose(g.loss, c.loss, rtol=1e-4,
                               err_msg=f"{what} loss")
    np.testing.assert_allclose(g.consensus_err, c.consensus_err, rtol=1e-4,
                               atol=1e-6, err_msg=f"{what} drift")
    if gp is None:
        return 0
    return int(sum((np.abs(gp[k].cpu().numpy() - cp[k].numpy()) > 1e-5).sum()
                   for k in cp))


def _gossip_cases():
    """Phase 14(a)'s cells: (name, GossipConfig keywords, fog?)."""
    from repro_torch.core import faults
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.core.compression import registry as comp
    base = dict(n_nodes=GOSSIP_N, rounds=GOSSIP_CHECK_ROUNDS,
                algo_params=algos.algo_params(lr=0.1))
    fp = faults.fault_params(**FAULTS)
    return [("none", base, False),
            ("qsgd", dict(base, compression="qsgd"), False),
            ("topk", dict(base, compression="topk",
                          compression_params=comp.compression_params(k=4)),
             False),
            ("sign x faults", dict(base, compression="sign", faults=fp),
             False),
            ("fog k=2", dict(base, gossip_steps=2), True),
            ("fog k=2 x faults", dict(base, gossip_steps=2, faults=fp),
             True)]


def _profile_rounds(fn, rounds: int) -> tuple:
    """``fn`` under ``torch.profiler``: (wall s, cudaLaunchKernel a round,
    device busy share of the wall clock, the top device kernels)."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_gossip.txt"),
              "w") as f:
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return (wall, launches / rounds, device_us / 1e6 / wall,
            [(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
             for e in top])


def run_gossip(dev, smi: str) -> dict:
    """Phase 14: bench_decentralized.py's cells and the two examples' LM
    cells on the gossip and fog engines. Returns each kernel's launches
    across the phase (all must be 0)."""
    from repro_torch.core import topology as topo
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.core.hierarchy import HFLConfig
    from repro_torch.examples import decentralized_gossip as dg
    from repro_torch.examples import fog_hybrid as fh
    from repro_torch.examples import problems
    from repro_torch.fl import decentralized as dz
    from repro_torch.fl import runtime as rt
    counters = dict(_row_counters(), **_tile_counters())
    for fn in counters.values():
        fn.launches = 0
    params0 = {"w": np.zeros(D_FLEET, np.float32)}
    batches = _linear_batches()
    w_torus = topo.laplacian_mixing(topo.torus_2d(8, 8))
    h4 = HFLConfig(n_clusters=7, inter_cluster_period=4)

    def go(kw, fog, device, engine="scan", rounds=None):
        cfg = dz.GossipConfig(**dict(kw, rounds=rounds or kw["rounds"]))
        if fog:
            return dz.run_fog(cfg, h4, _loss, params0, batches,
                              engine=engine, device=device)
        return dz.run_gossip(cfg, _loss, params0, batches, w_torus,
                             engine=engine, device=device)

    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"gossip {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    # (a) the card against the CPU at the bench's width; host loop == scan
    for name, kw, fog in _gossip_cases():
        (gp, g), secs = wall_s(lambda: go(kw, fog, dev))
        cp, c = go(kw, fog, "cpu")
        hp, hl = go(kw, fog, dev, "host")
        off = _gossip_card_equals_cpu(f"gossip (a) {name}", g, c, gp, cp)
        if off:
            raise AssertionError(f"gossip (a) {name}: {off} coordinates of "
                                 "the final params differ beyond 1e-5")
        for f in _GOSSIP_EXACT + ("loss", "latency_s", "comm_s", "comp_s",
                                  "consensus_err"):
            if not np.array_equal(getattr(hl, f), getattr(g, f)):
                raise AssertionError(f"gossip (a) {name}: host loop differs "
                                     f"from the scan in {f}")
        if not all(torch.equal(hp[k], gp[k]) for k in gp):
            raise AssertionError(f"gossip (a) {name}: host params differ")
        log(f"gossip (a) {name}: card == cpu (bits, edges, online; final "
            f"params within 1e-5), host loop == scan bitwise; "
            f"{GOSSIP_CHECK_ROUNDS} rounds in {secs:.3f} s on the card; "
            f"online {c.n_online.tolist()}, edges {c.n_edges.tolist()}, "
            f"loss {c.loss.tolist()}")

    took("(a)")

    # (b) bench_decentralized.py at its 40 rounds on the card
    gkw = dict(n_nodes=GOSSIP_N, rounds=GOSSIP_ROUNDS,
               algo_params=algos.algo_params(lr=0.1))
    go(gkw, False, dev)  # warm
    timed = [wall_s(lambda: go(gkw, False, dev)) for _ in range(2)]
    secs = min(t for _, t in timed)
    _, logs = timed[-1][0]
    log(f"gossip (b) rounds/s at N={GOSSIP_N}: {GOSSIP_ROUNDS / secs:.4f} "
        f"({secs / GOSSIP_ROUNDS * 1e6:.1f} us a round) on {smi}; torus, "
        f"edges {int(logs.n_edges[-1])}, simulated wall clock "
        f"{float(logs.latency_s[-1]):.3f} s, final loss "
        f"{float(logs.loss[-1]):.6f}")
    adjs = topo.standard_adjacencies(GOSSIP_N, seed=0, p=0.3)
    names = sorted(adjs)
    rt._ENGINE_CACHE.clear()
    t0 = rt.ENGINE_STATS["traces"]
    slogs, secs = wall_s(lambda: dz.run_gossip_sweep(
        dz.GossipConfig(**gkw), _loss, params0, batches,
        wgrid=[topo.laplacian_mixing(adjs[k]) for k in names], seeds=(0,),
        device=dev))
    n_traces = rt.ENGINE_STATS["traces"] - t0
    for i, name in enumerate(names):
        log(f"gossip (b) frontier {name}: final loss "
            f"{float(slogs.loss[i, -1]):.6f}, simulated wall clock "
            f"{float(slogs.latency_s[i, -1]):.3f} s, edges "
            f"{int(slogs.n_edges[i, -1])}, drift "
            f"{float(slogs.consensus_err[i, -1]):.3e}")
    log(f"gossip (b) frontier: {len(names)} topologies x {GOSSIP_ROUNDS} "
        f"rounds in {secs:.3f} s, {n_traces} trace(s)")
    if n_traces != 1 or not np.isfinite(slogs.loss).all():
        raise AssertionError(f"gossip (b) frontier: {n_traces} traces")
    fkw = dict(gkw, gossip_steps=2)
    go(fkw, True, dev)  # warm
    timed = [wall_s(lambda: go(fkw, True, dev)) for _ in range(2)]
    secs = min(t for _, t in timed)
    _, flogs = timed[-1][0]
    log(f"gossip (b) fog rounds/s at N={GOSSIP_N}: "
        f"{GOSSIP_ROUNDS / secs:.4f} ({secs / GOSSIP_ROUNDS * 1e6:.1f} us a "
        f"round) on {smi}; L=7, H=4, k=2, backhaul "
        f"{float(flogs.backhaul_bits.sum()):.4e} bits")
    for k in FOG_STEPS:  # k = 2 is the timed run's
        kl = flogs if k == 2 else go(dict(gkw, gossip_steps=k), True, dev)[1]
        log(f"gossip (b) fog frontier k={k}: final loss "
            f"{float(kl.loss[-1]):.6f}, simulated wall clock "
            f"{float(kl.latency_s[-1]):.3f} s, backhaul "
            f"{float(kl.backhaul_bits.sum()):.4e} bits, drift "
            f"{float(kl.consensus_err[-1]):.3e}")
        if not np.isfinite(kl.loss).all():
            raise AssertionError(f"gossip (b) fog k={k}: loss {kl.loss}")

    took("(b)")

    # (c) the examples' LM cells: card against CPU, then the card alone
    graphs = dg.graphs()
    wgrid = [topo.laplacian_mixing(a) for a in graphs.values()]

    def lm_gossip(device, rounds):
        params, loss_fn, sample, eval_fn = problems.make_lm_problem(
            dg.N, 0.5, device=device)
        return dz.run_gossip_sweep(dg.gossip_config(dg.N, rounds), loss_fn,
                                   params, sample, wgrid=wgrid,
                                   eval_batch=eval_fn.eval_batch,
                                   device=device)

    def lm_fog(device, rounds, k):
        # a fresh problem for each k (the example runs its three k on one)
        params, loss_fn, sample, eval_fn = problems.make_lm_problem(
            fh.N, 0.5, device=device)
        return dz.run_fog(dg.gossip_config(fh.N, rounds, gossip_steps=k),
                          fh.hfl_config(), loss_fn, params, sample,
                          eval_batch=eval_fn.eval_batch, device=device)

    g, c = (lm_gossip(dv, EX_CHECK_ROUNDS) for dv in (dev, "cpu"))
    for i, name in enumerate(graphs):
        _gossip_card_equals_cpu(
            f"gossip (c) {name}",
            *(SimpleNamespace(**{f: getattr(x, f)[i] for f in vars(x)})
              for x in (g, c)))
    (gp, g), (cp, c) = (lm_fog(dv, EX_CHECK_ROUNDS, 2) for dv in (dev,
                                                                   "cpu"))
    flips = _gossip_card_equals_cpu("gossip (c) fog k=2", g, c, gp, cp)
    log(f"gossip (c) LM cells: card == cpu for {EX_CHECK_ROUNDS} rounds "
        f"(bits, edges, online equal; latency, loss, drift within "
        f"tolerance); fog k=2 final params: {flips} coordinates beyond 1e-5 "
        f"(QSGD's dither rounds a coordinate to the neighbouring level "
        f"where the card's message norm is an ulp off the CPU's, and the "
        f"local updates and mixing carry that on)")
    took("(c) card against cpu")
    rt._ENGINE_CACHE.clear()
    t0 = rt.ENGINE_STATS["traces"]
    ex, secs = wall_s(lambda: dg.main([], device=dev))
    n_traces = rt.ENGINE_STATS["traces"] - t0
    for i, name in enumerate(graphs):
        log(f"gossip (c) decentralized_gossip.py {name}: spectral gap "
            f"{topo.spectral_gap(wgrid[i]):.3f}, final loss "
            f"{float(ex.loss[i, -1]):.6f}, drift "
            f"{float(ex.consensus_err[i, -1]):.6f}, simulated wall clock "
            f"{float(ex.latency_s[i, -1]):.3f} s, edges "
            f"{int(ex.n_edges[i, -1])}")
    log(f"gossip (c) decentralized_gossip.py: {len(graphs)} topologies x "
        f"{dg.ROUNDS} rounds in {secs:.3f} s on {smi}, {n_traces} "
        f"trace(s)")
    for k in fh.STEPS:
        (_, kl), secs = wall_s(lambda: lm_fog(dev, fh.ROUNDS, k))
        log(f"gossip (c) fog_hybrid.py k={k}: final loss "
            f"{float(kl.loss[-1]):.6f}, simulated wall clock "
            f"{float(kl.latency_s[-1]):.3f} s, backhaul "
            f"{float(kl.backhaul_bits.sum()):.4e} bits, drift "
            f"{float(kl.consensus_err[-1]):.3e}; {fh.ROUNDS} rounds in "
            f"{secs:.3f} s")
        if not np.isfinite(kl.loss).all():
            raise AssertionError(f"gossip (c) fog k={k}: loss {kl.loss}")
    if not np.isfinite(ex.loss).all():
        raise AssertionError("gossip (c): a loss is not finite")

    took("(c)")

    # (d) one bench gossip run under torch.profiler
    wall, per_round, busy, top = _profile_rounds(
        lambda: go(gkw, False, dev, rounds=PROFILE_ROUNDS), PROFILE_ROUNDS)
    log(f"gossip (d) profiled {PROFILE_ROUNDS} rounds at N={GOSSIP_N}: host "
        f"{wall / PROFILE_ROUNDS * 1e3:.3f} ms a round, cudaLaunchKernel "
        f"{per_round:.1f} a round, device busy {busy:.4f} of the wall clock "
        f"on {smi}; top device kernels {top}")

    # (e) the gossip and fog paths reach no kernel
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"gossip (e) kernel launches across phase 14: {launches}")
    if any(launches.values()):
        raise AssertionError(f"gossip: a kernel launched on the gossip "
                             f"path: {launches}")
    return launches


def _on(batches: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batches.items()}


def _lm_forced_rounds(dev, loss_fn, params, batches, k: int,
                      lr: float = 2e-3) -> dict:
    """Phase 15 (b): two rounds of ``fl_round`` as the engine calls it
    (blocks of one, ``donate=True``) at full width, two clients forced to
    participate, so that the two block partials fold through
    ``CanonicalFold`` and the server applies their mean. The second round,
    whose old EF rows are not zero, is held against plain versions: each
    client's new EF row against ``corrected - topk_rows_plain(corrected)``,
    with ``corrected`` its delta (its client step computed again, the same
    operations on the same inputs) plus its old EF row, and the new params
    against ``params + server_lr * (m_0 + m_1) / 2`` with ``m_i`` the plain
    top-k of ``corrected_i``. Both must agree bit for bit. Returns the
    launches of the two rounds, their peak memory and what was compared."""
    from repro_torch import random as trandom
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.core.compression import registry as comp
    from repro_torch.fl import client as fl_client
    from repro_torch.fl import server as fl_server
    from repro_torch.kernels import topk_mask
    n = 2
    ap = algos.algo_params(lr=lr, device=dev)
    cp = comp.compression_params(k=k, device=dev)
    kt = torch.tensor(float(k), device=dev)
    part = torch.ones(n, device=dev)
    b = {k_: v[:n] for k_, v in batches.items()}
    kw = dict(algo="fedavg", aparams=ap, participation=part,
              compression_name="topk", cparams=cp, chunk_size=1,
              donate=True)
    counter = topk_mask.topk_rows
    counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state = fl_server.init_fl_state(params, n, use_ef=True, n_rows=n)
    state, _ = fl_server.fl_round(state, b, loss_fn,
                                  key=trandom.PRNGKey(1, dev), **kw)
    p1, ef1 = state.params, state.client_error.clone()
    state, metrics = fl_server.fl_round(state, b, loss_fn,
                                        key=trandom.PRNGKey(2, dev), **kw)
    launches = counter.launches
    peak = torch.cuda.max_memory_allocated()
    step = fl_client.make_client_step(loss_fn, ap.lr)
    msgs, ef_bad = [], 0
    for i in range(n):  # one client at a time, as the blocks of one ran
        deltas, _ = step(p1, {k_: v[i:i + 1] for k_, v in b.items()})
        corrected = fl_server.flatten_clients(deltas)[0] + ef1[i:i + 1]
        del deltas
        m = topk_mask.topk_rows_plain(corrected, kt)
        ef_bad += int((corrected - m != state.client_error[i:i + 1]).sum())
        msgs.append(m[0])
        del corrected, m
    del ef1
    want = algos.flatten_vec(p1) + ap.server_lr * ((msgs[0] + msgs[1]) / 2.0)
    p_bad = int((algos.flatten_vec(state.params) != want).sum())
    nnz = [int((m != 0).sum()) for m in msgs]
    del msgs, want, state, p1
    torch.cuda.empty_cache()
    return dict(launches=launches, peak=peak, ef_bad=ef_bad, p_bad=p_bad,
                nnz=nnz, loss=float(metrics["loss"]),
                bits=float(metrics["uplink_bits"]))


def _counting(counters: dict):
    """(zero, read, total) over the kernels' launch counters: ``read``
    adds what was launched since ``zero`` into ``total``."""
    total = dict.fromkeys(counters, 0)

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        got = {n: fn.launches for n, fn in counters.items()}
        for n, v in got.items():
            total[n] += v
        return got
    return zero, read, total


def run_lm(dev, smi: str) -> dict:
    """Phase 15: the dense transformer LM through the flat engine, the two
    examples at their width (a), then the quickstart at gemma-2b's published
    widths (b). Returns each kernel's launches across the phase."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.core.privacy import registry as priv
    from repro_torch.examples import private_fl as pf
    from repro_torch.examples import quickstart as qs
    from repro_torch.fl import runtime as rt
    from repro_torch.kernels import topk_mask
    from repro_torch.models import transformer as tf
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"lm {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    # (a) the examples at their own width
    cfg, params, loss_fn = qs.model(dev)
    _, cparams, _ = qs.model("cpu")
    # each leaf's largest difference over its largest value (threefry is
    # bitwise; normal's erfinv rounds a few ulps apart on the two devices)
    init_err = max(float((params[k].cpu() - cparams[k]).abs().max()
                         / cparams[k].abs().max().clamp_min(1e-30))
                   for k in cparams)
    if init_err > 1e-5:
        raise AssertionError(f"lm (a) init: card {init_err:.3g} off the cpu")
    cparams = {k: v.cpu() for k, v in params.items()}
    d = algos.flat_dim(params)
    loader = qs.make_loader(cfg.vocab_size)
    batches = rt.stack_batches(lambda t, n: loader.next_round(),
                               QS_CHECK_ROUNDS, qs.N)
    sim = qs.topk_config(cfg, d, QS_CHECK_ROUNDS)
    zero()
    (_, g), secs = wall_s(lambda: rt.run_simulation_scan(
        sim, loss_fn, params, _on(batches, dev), device=dev))
    got = read()
    _, c = rt.run_simulation_scan(sim, loss_fn, cparams, _on(batches, "cpu"),
                                  device="cpu")
    rel = _card_equals_cpu("lm (a) quickstart", g, c)
    if got["topk_rows"] != QS_CHECK_ROUNDS or sum(got.values()) != \
            QS_CHECK_ROUNDS:
        raise AssertionError(f"lm (a) quickstart: launches {got}")
    log(f"lm (a) quickstart D={d} N={qs.N}: card == cpu for "
        f"{QS_CHECK_ROUNDS} rounds (participation, bits; latency; loss max "
        f"rel diff {rel:.3g}), init max rel diff {init_err:.3g}; "
        f"{secs:.3f} s on the card; launches {got}; loss {c.loss.tolist()}")
    # the example whole, as ``python -m repro_torch.examples.quickstart``
    # runs it (its own lines, its assert that the loss falls)
    zero()
    logs, secs = wall_s(lambda: qs.main([], device=dev))
    got = read()
    if not logs[-1].loss < logs[0].loss or got["topk_rows"] != qs.ROUNDS:
        raise AssertionError(f"lm (a) quickstart: loss {logs[0].loss} -> "
                             f"{logs[-1].loss}, launches {got}")
    log(f"lm (a) quickstart: {qs.ROUNDS} rounds in {secs:.3f} s "
        f"({qs.ROUNDS / secs:.4f} rounds/s) on {smi}; the loss falls "
        f"{logs[0].loss:.4f} -> {logs[-1].loss:.4f}; launches {got}")
    took("(a) quickstart")

    # private_fl's cells on the batches that follow the example's rounds
    loader = qs.make_loader(cfg.vocab_size)
    for _ in range(qs.ROUNDS):
        loader.next_round()
    pp = priv.privacy_params(clip=pf.CLIP, sigma=pf.SIGMA)
    batches = rt.stack_batches(lambda t, n: loader.next_round(),
                               PF_CHECK_ROUNDS, qs.N)
    zero()
    for privacy in ("none", "secagg", "secagg_dp"):
        psim = qs.sim_config(cfg, PF_CHECK_ROUNDS, privacy=privacy,
                             privacy_params=pp)
        g, c = (rt.run_simulation_scan(psim, loss_fn, p, _on(batches, dv),
                                       device=dv)[1]
                for p, dv in ((params, dev), (cparams, "cpu")))
        rel = _card_equals_cpu(f"lm (a) private_fl {privacy}", g, c)
        log(f"lm (a) private_fl {privacy}: card == cpu for "
            f"{PF_CHECK_ROUNDS} rounds; loss {c.loss.tolist()} (max rel "
            f"diff {rel:.3g}), epsilon {c.epsilon.tolist()}, mask bits "
            f"{c.mask_bits.tolist()}")
    grid = [priv.privacy_params(clip=pf.CLIP, sigma=s) for s in pf.SIGMAS]
    g, c = (rt.run_sweep(qs.sim_config(cfg, PF_CHECK_ROUNDS, privacy="dp",
                                       privacy_params=pp), loss_fn, p,
                         _on(batches, dv), seeds=[0], privacies=["dp"],
                         pparams_grid=grid, device=dv)[("age", "dp")]
            for p, dv in ((params, dev), (cparams, "cpu")))
    _card_equals_cpu("lm (a) private_fl dp sweep", g, c)
    got = read()
    if any(got.values()):
        raise AssertionError(f"lm (a) private_fl: launches {got}")
    log(f"lm (a) private_fl dp sweep sigma {pf.SIGMAS}: card == cpu; final "
        f"loss {c.loss[:, -1].tolist()}, epsilon {c.epsilon[:, -1].tolist()}"
        f"; launches {got}")
    del params, cparams
    took("(a) private_fl")

    # (b) the quickstart at gemma-2b's published widths, depth cut
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=QS_FULL_DEPTH,
                              dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, secs = wall_s(lambda: tf.init_params(cfg, trandom.PRNGKey(0,
                                                                       dev)))
    d = algos.flat_dim(params)
    init_peak = torch.cuda.max_memory_allocated() - base
    k = max(1, d // 50)
    gb = 4 * d / 1e9
    log(f"lm (b) {cfg.name} at its published widths, {cfg.n_layers} layers, "
        f"float32: D = {d} (param_count {cfg.param_count()}), k = {k}; init "
        f"{secs:.3f} s, peak {init_peak / 1e9:.3f} GB (params {gb:.3f} GB); "
        f"reckoned: the (12, D) EF {12 * gb:.1f} GB, server params "
        f"{gb:.2f} GB (and the caller's copy), about 8 D-sized buffers a "
        f"client in a block of {QS_FULL_CHUNK}: {8 * gb:.1f} GB")
    loader = qs.make_loader(cfg.vocab_size)
    batches = rt.stack_batches(lambda t, n: loader.next_round(),
                               QS_FULL_ROUNDS, qs.N)
    b0 = {k_: torch.as_tensor(v[0, 0, 0]) for k_, v in batches.items()}

    def value_grad(p, b):
        return torch.func.grad_and_value(
            lambda q: tf.lm_loss(q, cfg, b, remat=False)[0])(p)

    (gg, gl), secs = wall_s(lambda: value_grad(params, _on(b0, dev)))
    cp = {k_: v.cpu() for k_, v in params.items()}
    t0 = time.perf_counter()
    cg, cl = value_grad(cp, b0)
    cpu_s = time.perf_counter() - t0
    num = sum(float(((gg[k_].cpu() - cg[k_]) ** 2).sum()) for k_ in cg)
    den = sum(float((cg[k_] ** 2).sum()) for k_ in cg)
    grad_err = (num / den) ** 0.5
    loss_err = abs(float(gl) - float(cl)) / abs(float(cl))
    del gg, cg, cp
    log(f"lm (b) lm_loss of a ({qs.BATCH}, {qs.SEQ}) batch: card "
        f"{float(gl):.6f} "
        f"cpu {float(cl):.6f} (rel diff {loss_err:.3g}); gradient relative "
        f"L2 error {grad_err:.3g}; {secs:.3f} s on the card, {cpu_s:.3f} s on "
        f"the cpu")
    if loss_err > 1e-5 or not grad_err < 1e-4:
        raise AssertionError(f"lm (b) lm_loss: loss {loss_err:.3g}, "
                             f"gradient {grad_err:.3g} off the cpu")
    took("(b) init and gradient")

    # B2 on one (c, D) block: against its plain version, and its time
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(QS_FULL_CHUNK, d, device=dev, generator=gen)
    kt = torch.tensor(float(k), device=dev)
    err = _compare("topk_rows", (QS_FULL_CHUNK, d),
                   topk_mask.topk_rows(x, kt),
                   topk_mask.topk_rows_plain(x, kt), False)
    # a call takes about 2 s: one timed call each, after time_ms's warm-up
    ms = time_ms(lambda: topk_mask.topk_rows(x, kt), 1)
    dev_ms = device_ms(lambda: topk_mask.topk_rows(x, kt), 1)
    plain_ms = time_ms(lambda: topk_mask.topk_rows_plain(x, kt), 1)
    b_ms, b_by = bound_ms("topk_rows", QS_FULL_CHUNK * d)
    del x
    torch.cuda.empty_cache()
    row = dict(shape=[QS_FULL_CHUNK, d], max_abs_err=err, ms=ms,
               device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by)
    log(f"lm (b) kernel topk_rows ({QS_FULL_CHUNK}, {d}): max_abs_err "
        f"{err:.3g} ms {ms:.3f} device_ms {dev_ms:.3f} plain_ms "
        f"{plain_ms:.3f} bound_ms {b_ms:.3f} ({b_by}, 8 B/elem at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {dev_ms / b_ms:.1f}x the bound")
    took("(b) topk_rows")

    zero()
    torch.cuda.reset_peak_memory_stats()
    sim = qs.topk_config(cfg, d, QS_FULL_ROUNDS, chunk_size=QS_FULL_CHUNK)
    (_, logs), secs = wall_s(lambda: rt.run_simulation_scan(
        sim, lambda p, b: tf.lm_loss(p, cfg, b, remat=False), params,
        _on(batches, dev), device=dev))
    got = read()
    peak = torch.cuda.max_memory_allocated()
    blocks = -(-qs.N // QS_FULL_CHUNK)
    for t in range(QS_FULL_ROUNDS):
        log(f"lm (b) round {t}: loss {float(logs.loss[t]):.6f}, uplink "
            f"{float(logs.uplink_bits[t]):.6e} bits, simulated wall clock "
            f"{float(logs.latency_s[t]):.3f} s, scheduled "
            f"{int(logs.n_scheduled[t])}")
    why = ("" if logs.n_scheduled.any() else
           "; no device clears it, so no update is aggregated (every client "
           "still trains and compresses)")
    log(f"lm (b) scheduled {logs.n_scheduled.tolist()}: the age policy "
        f"schedules devices that clear R_min = model_bits / deadline = "
        f"{sim.model_bits / sim.deadline_s:.4e} b/s on their free "
        f"subchannels{why}")
    log(f"lm (b) {QS_FULL_ROUNDS} rounds in {secs:.3f} s: "
        f"{secs / QS_FULL_ROUNDS:.3f} s a round on {smi}; "
        f"max_memory_allocated {peak / 1e9:.3f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.3f}; "
        f"launches {got}")
    if (got["topk_rows"] != QS_FULL_ROUNDS * blocks
            or sum(got.values()) != got["topk_rows"]
            or not np.isfinite(logs.loss).all()):
        raise AssertionError(f"lm (b): launches {got}, loss {logs.loss}")
    took("(b) engine")

    f = _lm_forced_rounds(dev, lambda p, b: tf.lm_loss(p, cfg, b,
                                                       remat=False),
                          params, {k_: v[0].to(dev)
                                   for k_, v in batches.items()}, k)
    log(f"lm (b) fl_round with 2 clients forced to participate, blocks of "
        f"one, donate=True: topk_rows launched {f['launches']} times in 2 "
        f"rounds; round 2 loss {f['loss']:.6f}, uplink {f['bits']:.6e} "
        f"bits, kept {f['nnz']} of k = {k}; new EF rows off the plain "
        f"residual at {f['ef_bad']} coordinates, new params off the plain "
        f"mean at {f['p_bad']}; max_memory_allocated in the rounds "
        f"{f['peak'] / 1e9:.3f} GB")
    if (f["launches"] != 4 or f["ef_bad"] or f["p_bad"]
            or not np.isfinite(f["loss"])):
        raise AssertionError(f"lm (b) forced rounds: {f}")
    del params
    torch.cuda.empty_cache()
    took("(b) forced rounds")
    log(f"lm kernel launches across phase 15: {total}")
    return total, row


def _moe_drops(fn) -> list:
    """Run ``fn`` with every ``moe_forward`` call counting the token
    choices its capacity drops; returns the counts, layer by layer."""
    from repro_torch.models import moe
    drops, orig = [], moe.moe_forward

    def counted(p, x, cfg, *a, **kw):
        r = moe.route(p, x.reshape(-1, x.shape[-1]), cfg)
        drops.append(int(r.overflow.sum()))
        return orig(p, x, cfg, *a, **kw)
    moe.moe_forward = counted
    try:
        fn()
    finally:
        moe.moe_forward = orig
    return drops


def run_families(dev, smi: str) -> tuple:
    """Phase 16: the moe, ssm and hybrid families through the CLI's
    federated trainer: every family at ``--reduced``, card against CPU (a);
    falcon-mamba-7b at its published widths through ``run_federated``'s
    pieces (b); qwen2-moe-a2.7b and recurrentgemma-2b at their published
    widths, one batch's loss and gradient, card against CPU (c). Returns
    each kernel's launches across the phase and B2's (1, D) row."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    from repro_torch.kernels import topk_mask
    from repro_torch.launch import train as cli
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"families {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    # (a) run_federated at --reduced, one config of each family
    for arch in CLI_ARCHS:
        args = cli.parser().parse_args(["--arch", arch] + CLI_ARGS)
        zero()
        g, secs = wall_s(lambda: cli.run_federated(args, device=dev))
        got = read()
        c = cli.run_federated(args, device="cpu")
        g, c = _logs_of(g), _logs_of(c)
        for f in ("participation", "n_scheduled", "uplink_bits",
                  "downlink_bits"):
            np.testing.assert_array_equal(getattr(g, f), getattr(c, f),
                                          err_msg=f"families (a) {arch} {f}")
        np.testing.assert_allclose(g.latency_s, c.latency_s, rtol=1e-5)
        rel = np.abs(g.loss - c.loss) / np.abs(c.loss)
        if (rel[:2] > 1e-4).any() or (rel > FLIP_RTOL).any():
            raise AssertionError(f"families (a) {arch}: loss rel diff {rel}")
        if got["topk_rows"] != CLI_ROUNDS or sum(got.values()) != CLI_ROUNDS:
            raise AssertionError(f"families (a) {arch}: launches {got}")
        log(f"families (a) {arch} --reduced: card == cpu for {CLI_ROUNDS} "
            f"rounds (participation, bits; latency; loss rel diff by round "
            f"{rel.tolist()}); loss {c.loss.tolist()}, uplink "
            f"{c.uplink_bits.tolist()} bits; {secs:.3f} s on the card; "
            f"launches {got}")
    took("(a) run_federated --reduced")

    # (b) falcon-mamba-7b at its published widths, depth cut
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=FM_DEPTH, dtype="float32")
    args = cli.parser().parse_args(FM_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (cfg, sim, loss_fn, params, loader), secs = wall_s(
        lambda: cli.federated_problem(args, cfg=cfg, device=dev))
    init_peak = torch.cuda.max_memory_allocated() - base
    d, k = algos.flat_dim(params), int(sim.compression_params.k)
    sim = dataclasses.replace(sim, chunk_size=1)
    gb = 4 * d / 1e9
    log(f"families (b) {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, ssm_state {cfg.ssm_state}, "
        f"d_conv {cfg.d_conv}, dt_rank {cfg.dt_rank_eff}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}); cuts: depth 64 -> "
        f"{cfg.n_layers}, {cfg.dtype} (the config says bfloat16); D = {d} "
        f"(param_count {cfg.param_count()}), k = {k}; init {secs:.3f} s, "
        f"peak {init_peak / 1e9:.3f} GB (params {gb:.3f} GB, the (4, D) EF "
        f"{4 * gb:.1f} GB)")
    zero()
    torch.cuda.reset_peak_memory_stats()
    logs, secs = wall_s(lambda: rt.run_simulation(
        sim, loss_fn, params, lambda t, n: loader.next_round(),
        engine=args.engine, device=dev))
    got = read()
    peak = torch.cuda.max_memory_allocated()
    for lg in logs:
        log(f"families (b) round {lg.round}: loss {lg.loss:.6f}, scheduled "
            f"{lg.n_scheduled} {lg.participation.tolist()}, uplink "
            f"{lg.uplink_bits:.6e} bits, simulated wall clock "
            f"{lg.latency_s:.3f} s")
    log(f"families (b) {FM_ROUNDS} round(s) in {secs:.3f} s: "
        f"{secs / FM_ROUNDS:.3f} s a round on {smi}; max_memory_allocated "
        f"{peak / 1e9:.3f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.3f}; "
        f"launches {got}")
    n_dev = args.n_devices
    if (got["topk_rows"] != FM_ROUNDS * n_dev
            or sum(got.values()) != got["topk_rows"]
            or not all(np.isfinite(lg.loss) for lg in logs)
            or not all(lg.n_scheduled == args.n_scheduled for lg in logs)):
        raise AssertionError(f"families (b): launches {got}, logs {logs}")
    took("(b) round")

    # B2 on one (1, D) row: against its plain version, and one timed call
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, d, device=dev, generator=gen)
    kt = torch.tensor(float(k), device=dev)
    err = _compare("topk_rows", (1, d), topk_mask.topk_rows(x, kt),
                   topk_mask.topk_rows_plain(x, kt), False)
    ms = time_ms(lambda: topk_mask.topk_rows(x, kt), 1)
    plain_ms = time_ms(lambda: topk_mask.topk_rows_plain(x, kt), 1)
    b_ms, b_by = bound_ms("topk_rows", d)
    del x
    torch.cuda.empty_cache()
    row = dict(shape=[1, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by)
    log(f"families (b) kernel topk_rows (1, {d}): max_abs_err {err:.3g} ms "
        f"{ms:.3f} plain_ms {plain_ms:.3f} bound_ms {b_ms:.3f} ({b_by}); "
        f"{ms / b_ms:.1f}x the bound")
    took("(b) topk_rows")

    batches = {k_: torch.as_tensor(v, device=dev)
               for k_, v in loader.next_round().items()}
    f = _lm_forced_rounds(dev, loss_fn, params, batches, k, lr=args.lr)
    log(f"families (b) fl_round with 2 clients forced to participate, "
        f"blocks of one, donate=True: topk_rows launched {f['launches']} "
        f"times in 2 rounds; round 2 loss {f['loss']:.6f}, uplink "
        f"{f['bits']:.6e} bits, kept {f['nnz']} of k = {k}; new EF rows off "
        f"the plain residual at {f['ef_bad']} coordinates, new params off "
        f"the plain mean at {f['p_bad']}; max_memory_allocated in the rounds "
        f"{f['peak'] / 1e9:.3f} GB")
    if (f["launches"] != 4 or f["ef_bad"] or f["p_bad"]
            or not np.isfinite(f["loss"])):
        raise AssertionError(f"families (b) forced rounds: {f}")
    del params, batches, loader
    torch.cuda.empty_cache()
    took("(b) forced rounds")

    # (c) published widths, one batch's loss and gradient, card vs CPU
    for arch, depth in WIDE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  dtype="float32")
        params, secs = wall_s(lambda: tf.init_params(
            cfg, trandom.PRNGKey(0, dev)))
        d = algos.flat_dim(params)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(2, WIDE_B, WIDE_SEQ))
        batch = {"tokens": torch.as_tensor(toks[0], dtype=torch.int32),
                 "labels": torch.as_tensor(toks[1], dtype=torch.int32)}

        def value_grad(p, b):
            return torch.func.grad_and_value(
                lambda q: tf.lm_loss(q, cfg, b, remat=False)[0])(p)

        def drops(p, b):
            with torch.no_grad():
                return _moe_drops(lambda: tf.lm_loss(p, cfg, b))

        (gg, gl), g_s = wall_s(lambda: value_grad(params, _on(batch, dev)))
        g_drop = drops(params, _on(batch, dev))
        cp = {k_: v.cpu() for k_, v in params.items()}
        del params
        t0 = time.perf_counter()
        cg, cl = value_grad(cp, batch)
        c_s = time.perf_counter() - t0
        c_drop = drops(cp, batch)
        num = sum(float(((gg[k_].cpu() - cg[k_]) ** 2).sum()) for k_ in cg)
        den = sum(float((cg[k_] ** 2).sum()) for k_ in cg)
        grad_err = (num / den) ** 0.5
        loss_err = abs(float(gl) - float(cl)) / abs(float(cl))
        del gg, cg, cp
        torch.cuda.empty_cache()
        moe_txt = (f"; token choices dropped by capacity, by layer: card "
                   f"{g_drop}, cpu {c_drop} (of {WIDE_B * WIDE_SEQ} tokens x "
                   f"top-{cfg.moe_top_k}, capacity "
                   f"{moe.capacity(cfg, WIDE_B * WIDE_SEQ)})"
                   if cfg.family == "moe" else "")
        log(f"families (c) {arch} at its published widths, {depth} layers, "
            f"float32: D = {d}; init {secs:.3f} s; lm_loss of a ({WIDE_B}, "
            f"{WIDE_SEQ}) batch: card {float(gl):.6f} cpu {float(cl):.6f} "
            f"(rel diff {loss_err:.3g}); gradient relative L2 error "
            f"{grad_err:.3g}; {g_s:.3f} s on the card, {c_s:.3f} s on the "
            f"cpu{moe_txt}")
        if (loss_err > 1e-5 or not grad_err < 1e-4 or g_drop != c_drop
                or (cfg.family == "moe" and len(g_drop) != depth)):
            raise AssertionError(f"families (c) {arch}: loss {loss_err:.3g}"
                                 f", gradient {grad_err:.3g}, drops "
                                 f"{g_drop} / {c_drop}")
    took("(c) published widths")
    log(f"families kernel launches across phase 16: {total}")
    return total, row


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].cpu().double() - want[k].double()) ** 2).sum())
              for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _timed_cluster(args, cfg, dev):
    """``run_cluster(args, cfg=cfg)`` on the card, its init and each step
    timed: returns (its result, its wall s, {"init": (s, peak bytes),
    "step_s": each step's s by CUDA events, "peak": peak bytes after the
    init, "step_peak": peak bytes over the steps less what was allocated
    before the init, "held": bytes of the state and batch the first step
    was handed})."""
    from repro_torch.launch import train as cli
    got = {"events": []}
    orig_init, orig_step = cli.make_init_fn, cli.make_train_step

    def timed_init(*a):
        init = orig_init(*a)

        def run(key):
            torch.cuda.reset_peak_memory_stats()
            base = got["base"] = torch.cuda.memory_allocated()
            state, secs = wall_s(lambda: init(key))
            got["init"] = (secs, torch.cuda.max_memory_allocated() - base)
            torch.cuda.reset_peak_memory_stats()
            return state
        return run

    def timed_step(*a):
        step = orig_step(*a)

        def run(state, batch):
            from repro_torch.launch.specs import state_bytes
            got.setdefault("held", state_bytes((state, batch)))
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(state, batch)
            ev[1].record()
            got["events"].append(ev)
            got["step_peak"] = torch.cuda.max_memory_allocated() - got["base"]
            return out
        return run

    torch.cuda.empty_cache()
    cli.make_init_fn, cli.make_train_step = timed_init, timed_step
    try:
        out, secs = wall_s(lambda: cli.run_cluster(args, cfg=cfg, device=dev))
    finally:
        cli.make_init_fn, cli.make_train_step = orig_init, orig_step
    got["peak"] = torch.cuda.max_memory_allocated()
    got["step_s"] = [a.elapsed_time(b) / 1e3 for a, b in got.pop("events")]
    return out, secs, got


def run_trainer(dev, smi: str) -> dict:
    """Phase 17: the one-card trainer through ``run_cluster``: every mode x
    compression at ``--reduced``, card against CPU (a); gemma-2b at its
    published size (b); the 100M example (c). Returns each kernel's
    launches across the phase (all must be 0)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.examples import train_fl_100m as ex
    from repro_torch.launch import train as cli
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))
    zero()
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"trainer {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    # (a) every mode x compression at --reduced, card against CPU
    for arch in TRAINER_ARCHS:
        for mode, comp in TRAINER_MODES:
            args = cli.parser().parse_args(
                ["--arch", arch, "--mode", mode, "--compression", comp]
                + TRAINER_ARGS)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                (gl, gs), secs = wall_s(lambda: cli.run_cluster(args,
                                                                device=dev))
                cl, cs = cli.run_cluster(args, device="cpu")
            rel = np.abs(np.array(gl) - np.array(cl)) / np.abs(cl)
            p_err = _rel_l2(gs["params"], cs["params"])
            log(f"trainer (a) {arch} {mode}/{comp}: loss "
                f"{np.round(cl, 6).tolist()}; card vs cpu rel diff by step "
                f"max "
                f"{rel.max():.3g}, final params relative L2 {p_err:.3g}; "
                f"{secs:.3f} s on the card; {out.getvalue().splitlines()[-1]}")
            if not (rel.max() <= TRAINER_RTOL and p_err <= TRAINER_RTOL):
                raise AssertionError(f"trainer (a) {arch} {mode}/{comp}: "
                                     f"loss {rel}, params {p_err}")
            del gs, cs
    took("(a) run_cluster --reduced")

    # (b) gemma-2b at its published size, float32
    cfg = dataclasses.replace(get_config("gemma-2b"), dtype="float32")
    ckpt_dir = os.path.join(ROOT, "build", "trainer_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = cli.parser().parse_args(GEMMA_ARGS + ["--ckpt-dir", ckpt_dir])
    (losses, state), secs, got = _timed_cluster(args, cfg, dev)
    peak = got["peak"]
    step_s = got["step_s"]
    med = float(np.median(step_s[GEMMA_TIMED]))
    d = sum(v.numel() for v in state["params"].values())
    toks = args.batch * args.seq_len
    log(f"trainer (b) {cfg.name} at its published size ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads}"
        f" kv head, head_dim {cfg.head_dim}, {cfg.mlp_type} d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}); cut: "
        f"{cfg.dtype} (the config says bfloat16); D = {d} (param_count "
        f"{cfg.param_count()}); {args.mode}/{args.compression}+EF, "
        f"{args.optimizer}, lr {args.lr}, remat, {args.steps} steps of "
        f"({args.batch}, {args.seq_len})")
    MEASURED["trainer_b"] = dict(held=got["held"],
                                 step_peak=got["step_peak"], step_s=med)
    log(f"trainer (b) init {got['init'][0]:.3f} s, peak "
        f"{got['init'][1] / 1e9:.3f} GB; state and batch held "
        f"{got['held']} B, step-only peak {got['step_peak']} B; step s "
        f"(CUDA events) "
        f"{[round(x, 4) for x in step_s]}; s a step (median of steps 2-9) "
        f"{med:.4f}, {toks / med:.1f} tokens/s; max_memory_allocated in the "
        f"steps {peak / 1e9:.3f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.3f}; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; run_cluster {secs:.3f} s "
        f"on {smi}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"trainer (b): losses {losses}")
    back, load_s = wall_s(lambda: ckpt.load_checkpoint(ckpt_dir, args.steps,
                                                       state["params"]))
    off = [k for k, v in state["params"].items()
           if not torch.equal(back[k], v)]
    size = os.path.getsize(os.path.join(ckpt_dir,
                                        f"ckpt_{args.steps:08d}.npz"))
    log(f"trainer (b) checkpoint {size / 1e9:.3f} GB, loaded back in "
        f"{load_s:.3f} s: {len(back)} leaves, {len(off)} not bitwise {off}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if off or sorted(back) != sorted(state["params"]):
        raise AssertionError(f"trainer (b) checkpoint: {off}")
    del back, state
    torch.cuda.empty_cache()
    took("(b) gemma-2b")

    # (c) the 100M example on the card, its depth cut
    model = ex.model_100m
    ex.model_100m = lambda full: dataclasses.replace(
        model(full), n_layers=FL100M_DEPTH)
    try:
        _, secs = wall_s(lambda: ex.main(FL100M_ARGS, device=dev))
    finally:
        ex.model_100m = model
    log(f"trainer (c) train_fl_100m {' '.join(FL100M_ARGS)}, depth 12 -> "
        f"{FL100M_DEPTH}: {secs:.3f} s")
    took("(c) train_fl_100m")
    got = read()
    log(f"trainer kernel launches across phase 17: {got}")
    if any(got.values()):
        raise AssertionError(f"trainer: kernels launched {got}")
    return total


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (1 at least)."""
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def _greedy_agree(got_logits, want_logits, tol: float) -> tuple:
    """(B, n, V) logits: the positions where ``want``'s top-2 gap exceeds
    ``tol`` times its largest |logit|, and how many of them pick another
    greedy token in ``got``."""
    want = want_logits.cpu().double()
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol * max(1.0, float(
        want.abs().max()))
    off = (got_logits.cpu().argmax(-1) != want.argmax(-1)) & sure
    return int(sure.sum()), int(off.sum())


def _served_agree(g, c) -> tuple:
    """Two ``serve`` results step by step, until the CPU's top-2 gap falls
    within SERVE_TOL (the inputs may part after that): (steps compared,
    largest relative logit error, greedy tokens that differ)."""
    err, n, off = 0.0, 0, 0
    for gl, cl in zip(g.logits, c.logits):
        err = max(err, _rel_err(gl, cl))
        sure, bad = _greedy_agree(gl, cl, SERVE_TOL)
        off += bad
        n += 1
        if sure < gl.shape[0]:
            break
    return n, err, off


def _served_line(what, g, c, args, secs, launches) -> None:
    n, err, off = _served_agree(g, c)
    log(f"serve {what}: card == cpu for {n} of {len(c.logits)} steps (logit "
        f"rel err {err:.3g}, tokens off {off}); card prefill "
        f"{g.prefill_s:.3f} s, decode {g.decode_s / args.gen * 1e3:.3f} ms a "
        f"step ({args.gen * args.batch / g.decode_s:.1f} tokens/s); cpu "
        f"prefill {c.prefill_s:.3f} s, decode "
        f"{c.decode_s / args.gen * 1e3:.3f} ms a step; serve {secs:.3f} s on "
        f"the card; sample {g.tokens[0, :8].tolist()}; launches {launches}")
    if n != len(c.logits) or err > SERVE_TOL or off or any(launches.values()):
        raise AssertionError(f"serve {what}: {n} steps, err {err}, off "
                             f"{off}, launches {launches}")


def _vlm_bounds(cfg, b: int, s: int, t: int) -> dict:
    """The least times of (c)'s prefill of (b, s) and of one decode step
    over a t-slot cache: the matmul and attention operations over the
    card's float32 peak, and the bytes (every weight read once, the caches
    and vision K/V once) over its memory rate; the larger of the two."""
    d, v, ff = cfg.d_model, cfg.vocab_size, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    n_super = cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers - n_super
    w_self = 2 * d * qd + 2 * d * kvd + 3 * d * ff
    w_cross = 2 * d * qd + 3 * d * ff
    w_trunk = n_self * w_self + n_super * w_cross
    w_vis = n_super * 2 * cfg.vision_dim * kvd
    nv = cfg.n_vision_tokens
    attn = lambda q, k: 4 * b * cfg.n_heads * q * k * cfg.head_dim  # noqa
    pre_ops = (2 * b * s * w_trunk + 2 * b * nv * w_vis + 2 * b * d * v
               + n_self * attn(s, s) + n_super * attn(s, nv))
    pre_bytes = 4 * (w_trunk + w_vis + d * v + b * nv * cfg.vision_dim)
    dec_ops = (2 * b * w_trunk + 2 * b * d * v + n_self * attn(1, t)
               + n_super * attn(1, nv))
    dec_bytes = 4 * (w_trunk + d * v + 2 * b * kvd * (n_self * t
                                                     + n_super * nv))
    out = {}
    for name, ops, nbytes in (("prefill", pre_ops, pre_bytes),
                              ("decode", dec_ops, dec_bytes)):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def _serve_vlm(dev, smi: str) -> None:
    """Phase 18 (c): llama-3.2-vision-11b at its published widths through
    ``make_prefill_step`` / ``_load_prefill`` / ``make_decode_step``, then
    the decode checked against one teacher-forced forward."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(VLM), n_layers=VLM_DEPTH,
                              dtype="float32")
    b, s, n_gen = VLM_B, VLM_PROMPT, VLM_GEN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, init_s = wall_s(lambda: tf.init_params(
        cfg, trandom.PRNGKey(0, dev)))
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(v.numel() for v in params.values())
    for g in ("gate_attn", "gate_mlp"):
        params[f"blocks/cross/{g}"].fill_(VLM_GATE)
    gen = torch.Generator(device=dev).manual_seed(0)
    vis = torch.randn((b, cfg.n_vision_tokens, cfg.vision_dim),
                      generator=gen, device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=dev)
    batch = {"tokens": toks, "vision_embeds": vis}
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg, circular=False)
    log(f"serve (c) {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, "
        f"head_dim {cfg.head_dim}, {cfg.mlp_type} d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, one cross-attention "
        f"layer in {cfg.cross_attn_every} over {cfg.n_vision_tokens} vision "
        f"tokens of {cfg.vision_dim}); cuts: depth 40 -> {cfg.n_layers}, "
        f"{cfg.dtype} (the config says bfloat16); {n_params} params "
        f"(param_count {cfg.param_count()}); gates {VLM_GATE}, seeded normal "
        f"vision embeds; init {init_s:.3f} s, peak {init_peak / 1e9:.3f} GB")
    bounds = _vlm_bounds(cfg, b, s, s + n_gen)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _, warm_s = wall_s(lambda: prefill(params, batch))
        (logits, pf), pre_s = wall_s(lambda: prefill(params, batch))
        cache = serve._load_prefill(cfg, tf.init_decode_cache(
            cfg, b, s + n_gen, device=dev), pf, s)
        del pf
        token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        fed, outs, evs = [], [logits], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_gen):
            fed.append(token)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, cache = decode(params, cache, token, s + i)
            ev[1].record()
            evs.append(ev)
            token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            outs.append(logits)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        step_ms = [a.elapsed_time(e) for a, e in evs]
        med = float(np.median(step_ms[2:]))
        del cache
        # one teacher-forced forward over the prompt and the fed tokens
        seq = torch.cat([toks] + fed, dim=1)
        h = tf.forward_trunk(params, cfg, seq, {"vision_embeds": vis},
                             remat=False)[0]
        want = tf.unembed(params, cfg, h[:, s - 1:])
        got = torch.cat(outs, dim=1)
        err = _rel_err(got, want)
        sure, off = _greedy_agree(got, want, VLM_TOL)
    (pb, pby), (db, dby) = bounds["prefill"], bounds["decode"]
    log(f"serve (c) prefill ({b}, {s}): {pre_s:.4f} s (first call "
        f"{warm_s:.4f} s), {b * s / pre_s:.1f} tokens/s, bound {pb:.4f} s "
        f"({pby}), {pre_s / pb:.2f}x the bound; decode {n_gen} steps: "
        f"{med:.3f} ms a step (CUDA events, median of steps 2-{n_gen - 1}), "
        f"bound {db * 1e3:.3f} ms ({dby}), {med / (db * 1e3):.2f}x the bound; "
        f"{b * n_gen / dec_s:.1f} tokens/s ({dec_s:.3f} s on the host clock "
        f"with the greedy picks); step ms {[round(x, 3) for x in step_ms]}; "
        f"max_memory_allocated in serving {peak / 1e9:.3f} GB on {smi}")
    log(f"serve (c) decode vs the teacher-forced forward over ({b}, "
        f"{s + n_gen}): logit rel err {err:.3g} (tolerance {VLM_TOL}); "
        f"greedy tokens compared at {sure} of {b * (n_gen + 1)} positions "
        f"(top-2 gap above the tolerance), {off} differ; generated "
        f"{torch.cat(fed, 1)[0, :8].tolist()}")
    if err > VLM_TOL or off or not torch.isfinite(got).all():
        raise AssertionError(f"serve (c): err {err}, off {off}")


def _cluster_line(what, cfg, args, res, secs, got, smi) -> None:
    (losses, state) = res
    med = float(np.median(got["step_s"][CLUSTER_TIMED]))
    d = sum(v.numel() for v in state["params"].values())
    log(f"serve {what} {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) "
        f"through run_cluster: D = {d} (param_count {cfg.param_count()}); "
        f"{args.mode}/{args.compression}+EF, {args.optimizer}, lr {args.lr}, "
        f"remat, {args.steps} steps of ({args.batch}, {args.seq_len}); init "
        f"{got['init'][0]:.3f} s, peak {got['init'][1] / 1e9:.3f} GB; step s "
        f"{[round(x, 4) for x in got['step_s']]}; s a step (median of steps "
        f"2-9) {med:.4f}, {args.batch * args.seq_len / med:.1f} tokens/s; "
        f"max_memory_allocated in the steps {got['peak'] / 1e9:.3f} GB; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; run_cluster {secs:.3f} s on "
        f"{smi}")


def run_serve(dev, smi: str) -> dict:
    """Phase 18: the serving path and the vlm and audio families: serve
    and circular decode card against CPU (a), run_cluster for both new
    families card against CPU (b), llama-3.2-vision-11b at its published
    widths served (c) and trained (d), whisper-base at its published size
    (e). Returns each kernel's launches across the phase (all must be
    0)."""
    import contextlib
    import dataclasses
    import io
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as tf
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))
    zero()
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"serve {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    # (a) serve --reduced, one config of each family, card against CPU
    for arch in SERVE_ARCHS:
        args = serve.parser().parse_args(["--arch", arch] + SERVE_ARGS)
        zero()
        with contextlib.redirect_stdout(io.StringIO()):
            g, secs = wall_s(lambda: serve.serve(args, device=dev))
            got = read()
            c = serve.serve(args, device="cpu")
        _served_line(f"(a) {arch} --reduced", g, c, args, secs, got)
    for arch in CIRC_ARCHS:
        cfg = get_config(arch).reduced()
        pg = tf.init_params(cfg, trandom.PRNGKey(0, dev))
        pc = {k: v.cpu() for k, v in pg.items()}
        step = steps.make_decode_step(cfg, circular=True)
        cg = tf.init_decode_cache(cfg, 2, CIRC_WINDOW, sliding=True,
                                  device=dev)
        cc = tf.init_decode_cache(cfg, 2, CIRC_WINDOW, sliding=True)
        tok = torch.ones((2, 1), dtype=torch.int32)
        errs = []
        with torch.no_grad():
            for pos in CIRC_POS:
                lg, cg = step(pg, cg, tok.to(dev), pos)
                lc, cc = step(pc, cc, tok, pos)
                errs.append(max([_rel_err(lg, lc)] + [
                    _rel_err(a, b_) for a, b_ in zip(_tree_leaves(cg),
                                                     _tree_leaves(cc))]))
        log(f"serve (a) circular decode {arch} --reduced, window "
            f"{CIRC_WINDOW}, positions {list(CIRC_POS)}: card == cpu, "
            f"logits and cache rel err by position "
            f"{[float(f'{e:.3g}') for e in errs]}")
        if max(errs) > SERVE_TOL:
            raise AssertionError(f"serve (a) circular {arch}: {errs}")
    took("(a) serve --reduced")

    # (b) run_cluster --reduced for the vlm and audio families
    for arch in NEW_FAMILY_ARCHS:
        args = cli.parser().parse_args(["--arch", arch] + NEW_FAMILY_ARGS)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            (gl, gs), secs = wall_s(lambda: cli.run_cluster(args,
                                                            device=dev))
            cl, cs = cli.run_cluster(args, device="cpu")
        rel = np.abs(np.array(gl) - np.array(cl)) / np.abs(cl)
        p_err = _rel_l2(gs["params"], cs["params"])
        log(f"serve (b) run_cluster {arch} --reduced pssgd/int8+EF, 6 steps "
            f"of (8, 64): loss {np.round(cl, 6).tolist()}; card vs cpu rel "
            f"diff by step max {rel.max():.3g}, final params relative L2 "
            f"{p_err:.3g}; {secs:.3f} s on the card")
        if not (rel.max() <= TRAINER_RTOL and p_err <= TRAINER_RTOL):
            raise AssertionError(f"serve (b) {arch}: loss {rel}, params "
                                 f"{p_err}")
        del gs, cs
    took("(b) run_cluster --reduced")

    # (c) llama-3.2-vision-11b at its published widths, served
    _serve_vlm(dev, smi)
    torch.cuda.empty_cache()
    took("(c) vlm served")

    # (d) the same widths trained, one superblock
    cfg = dataclasses.replace(get_config(VLM), n_layers=VLM_TRAIN_DEPTH,
                              dtype="float32")
    args = cli.parser().parse_args(VLM_TRAIN_ARGS)
    with contextlib.redirect_stdout(io.StringIO()):
        res, secs, got = _timed_cluster(args, cfg, dev)
    _cluster_line("(d)", cfg, args, res, secs, got, smi)
    del res
    torch.cuda.empty_cache()
    took("(d) vlm trained")

    # (e) whisper-base at its published size
    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32")
    args = serve.parser().parse_args(WHISPER_SERVE_ARGS)
    with contextlib.redirect_stdout(io.StringIO()):
        g, secs = wall_s(lambda: serve.serve(args, device=dev, cfg=cfg))
        c = serve.serve(args, device="cpu", cfg=cfg)
    _served_line(f"(e) {cfg.name} at its published size ({cfg.n_layers} + "
                 f"{cfg.n_encoder_layers} layers, d_model {cfg.d_model}, "
                 f"{cfg.n_audio_frames} frames, vocab {cfg.vocab_size}; cut: "
                 f"{cfg.dtype})", g, c, args, secs, {})
    del g, c
    args = cli.parser().parse_args(WHISPER_TRAIN_ARGS)
    with contextlib.redirect_stdout(io.StringIO()):
        res, secs, got = _timed_cluster(args, cfg, dev)
    _cluster_line("(e)", cfg, args, res, secs, got, smi)
    del res
    torch.cuda.empty_cache()
    took("(e) whisper-base")
    got = read()
    log(f"serve kernel launches across phase 18: {got}")
    if any(got.values()):
        raise AssertionError(f"serve: kernels launched {got}")
    return total


def _leaf_k(x) -> int:
    return max(1, math.ceil(x.numel() * LEAF_FRAC))


def _leaf_ops(key) -> dict:
    """The nine per-leaf operators at phase 19's parameters, keyed."""
    from repro_torch.core.compression import quantize as q
    from repro_torch.core.compression import sparsify as sp
    return {
        "sign": q.sign_compress,
        "scaled_sign": q.scaled_sign,
        "blockwise_scaled_sign": lambda x: q.blockwise_scaled_sign(
            x, LEAF_BLOCK),
        "ternary": lambda x: q.ternary(key, x),
        "qsgd": lambda x: q.qsgd(key, x, LEAF_LEVELS),
        "random_sparsify": lambda x: sp.random_sparsify(key, x, LEAF_EPS),
        "topk": lambda x: sp.topk_sparsify(x, _leaf_k(x)),
        "rtopk": lambda x: sp.rtopk_sparsify(
            key, x, min(4 * _leaf_k(x), x.numel()), _leaf_k(x)),
        "randk": lambda x: sp.randk_sparsify(key, x, _leaf_k(x)),
    }


def _leaf_tree(cfg, device, dtype, gen) -> dict:
    """``cfg``'s parameter tree (the port's flat dict) as normal draws of
    ``dtype`` from ``gen``, leaf by leaf; shapes from a one-layer init on
    the meta device, the stacked leaves' depth restored."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.models import transformer as tf
    meta = tf.init_params(dataclasses.replace(cfg, n_layers=1),
                          trandom.PRNGKey(0, "meta"))
    return {k: torch.randn(((cfg.n_layers,) + tuple(v.shape[1:])
                            if k.startswith("blocks/") else v.shape),
                           generator=gen, device=device, dtype=dtype)
            for k, v in sorted(meta.items())}


def _leaf_diff(name, got, want, rtol) -> tuple:
    """A card result (or mask) against the CPU's: (where they differ beyond
    ``rtol``, the largest relative error elsewhere); the bitwise operators
    must be equal."""
    got = got.cpu()
    if name in LEAF_BITWISE or got.dtype == torch.bool:
        off = got != want
        if name in LEAF_BITWISE and off.any():
            raise AssertionError(f"leaf (a) {name}: {int(off.sum())} "
                                 f"entries differ, card vs cpu")
        return off, 0.0
    g, w = got.double(), want.double()
    close = torch.isclose(g, w, rtol=rtol, atol=0.0)
    rel = ((g - w).abs() / w.abs().clamp_min(1e-300))[close]
    return ~close, float(rel.max()) if rel.numel() else 0.0


def _leaf_near(name, x, key, off) -> bool:
    """Do the flips ``off`` of a dithered operator on the CPU leaf ``x`` lie
    on their thresholds (QSGD's fraction, random_sparsify's p)?"""
    from repro_torch import random as trandom
    from repro_torch.core.compression import sparsify as sp
    if name not in ("qsgd", "random_sparsify"):
        return False
    u = trandom.uniform(key, x.shape).double()[off]
    if name == "qsgd":
        x64 = x.double()
        frac = (x64.abs() / x64.square().sum().sqrt() * LEAF_LEVELS) % 1.0
        gap = (u - frac[off]).abs()
        return bool((torch.minimum(gap, 1.0 - gap)
                     < QSGD_MARGIN * LEAF_LEVELS).all())
    p = sp._keep_probability(x, LEAF_EPS).double()[off]
    return bool(((u - p).abs() < KEEP_MARGIN).all())


def _leaf_card_vs_cpu(dev) -> None:
    """(a): each operator on every leaf of gemma-2b's reduced() tree, and
    tree_ef_compress with it, on the card against the CPU."""
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.core.compression import error_feedback as ef
    cfg = get_config(LEAF_ARCH).reduced()
    gen = torch.Generator().manual_seed(LEAF_SEED)
    base = _leaf_tree(cfg, "cpu", torch.float32, gen)
    e_cpu = {k: v.clone().normal_(0.0, 0.1, generator=gen)
             for k, v in base.items()}
    e_dev = {k: v.to(dev) for k, v in e_cpu.items()}
    k_cpu, k_dev = trandom.PRNGKey(LEAF_SEED), trandom.PRNGKey(LEAF_SEED, dev)
    ops_cpu, ops_dev = _leaf_ops(k_cpu), _leaf_ops(k_dev)
    flips = dict.fromkeys(LEAF_OPS, 0)
    errs = dict.fromkeys(LEAF_OPS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        x_cpu = {k: v.to(dtype) for k, v in base.items()}
        x_dev = {k: v.to(dev) for k, v in x_cpu.items()}
        rtol = LEAF_RTOL[dtype]
        for name in LEAF_OPS:
            for k in sorted(x_cpu):
                got, want = ops_dev[name](x_dev[k]), ops_cpu[name](x_cpu[k])
                off, rel = _leaf_diff(name, got[0], want[0], rtol)
                if not isinstance(want[1], float):  # the masks
                    off = off | _leaf_diff(name, got[1], want[1], rtol)[0]
                if off.any() and not _leaf_near(name, x_cpu[k], k_cpu, off):
                    raise AssertionError(f"leaf (a) {name} {k} {dtype}: "
                                         f"{int(off.sum())} flips off their "
                                         f"thresholds")
                flips[name] += int(off.sum())
                errs[name] = max(errs[name], rel)
            (cg, eg), (cc, ec) = (
                ef.tree_ef_compress(ops_dev[name], x_dev, e_dev),
                ef.tree_ef_compress(ops_cpu[name], x_cpu, e_cpu))
            for k in sorted(cc):
                off, rel = _leaf_diff(name, cg[k], cc[k], rtol)
                tol = rtol * float(cc[k].float().abs().max().clamp_min(
                    1e-30))
                e_off = ((eg[k].cpu() - ec[k]).abs() > tol) & ~off
                if e_off.any() or (off.any() and name not in (
                        "qsgd", "random_sparsify")):
                    raise AssertionError(f"leaf (a) EF {name} {k} {dtype}: "
                                         f"{int(e_off.sum())} errors differ")
                flips[name] += int(off.sum())
                errs[name] = max(errs[name], rel)
    log(f"leaf (a) {cfg.name} tree ({sum(v.numel() for v in base.values())} "
        f"elements, {len(base)} leaves), float32 and bfloat16, each operator "
        f"and tree_ef_compress, card vs cpu: flips {flips}; max rel err "
        f"elsewhere {{{', '.join(f'{n}: {v:.3g}' for n, v in errs.items())}}}")
    if max(flips.values()) > LEAF_MAX_FLIPS:
        raise AssertionError(f"leaf (a): flips {flips}")


def _leaf_invariants(name, x, e, c, e2) -> str:
    """(b)'s checks of one tree_ef_compress: c + e' = x + e to float32
    rounding on every leaf; top-k, rand-k and R-top-K keep exactly k a
    leaf; top-k is a k-contraction on every leaf; random_sparsify's
    variance within (1 + eps) ||g||^2 of its input g = x + e."""
    from repro_torch.core.compression import error_feedback as ef
    from repro_torch.core.compression import sparsify as sp
    worst, ratio = 0.0, 0.0
    for k in sorted(x):
        cf = c[k].float()
        err = (cf + e2[k] - (x[k].float() + e[k])).abs()
        bound = (cf.abs() + e2[k].abs()).mul_(2.0 ** -22)
        worst = max(worst, float((err / bound.clamp_min(1e-38)).max()))
        if bool((err > bound).any()):
            raise AssertionError(f"leaf (b) {name} {k}: c + e' != x + e")
        del cf, err, bound
        kk = _leaf_k(x[k])
        if name in LEAF_SPARSE and int(torch.count_nonzero(c[k])) != kk:
            raise AssertionError(f"leaf (b) {name} {k}: "
                                 f"{int(torch.count_nonzero(c[k]))} kept, "
                                 f"not {kk}")
        if name == "topk" and not bool(ef.is_k_contraction(
                lambda v: sp.topk_sparsify(v, kk), x[k], kk)):
            raise AssertionError(f"leaf (b) topk {k}: not a k-contraction")
        if name == "random_sparsify":
            g = (x[k].float() + e[k]).to(x[k].dtype).float()
            p = sp._keep_probability(g, LEAF_EPS)
            var = torch.where(p > 0, g * g / p.clamp_min(1e-30), 0.0).sum()
            budget = (1.0 + LEAF_EPS) * (g * g).sum()
            ratio = max(ratio, float(var / budget))
            if ratio > 1.0 + 1e-5:
                raise AssertionError(f"leaf (b) random_sparsify {k}: "
                                     f"variance {ratio} of its budget")
    out = f"c + e' vs x + e at most {worst:.3g} of the float32 bound"
    if name == "random_sparsify":
        out += f"; variance at most {ratio:.6f} of (1 + eps) ||g||^2"
    if name in LEAF_SPARSE:
        out += "; exactly k kept a leaf"
    if name == "topk":
        out += "; a k-contraction on every leaf"
    return out


def _leaf_full(dev, smi: str) -> None:
    """(b) and (d): gemma-2b's published parameter tree through
    tree_ef_compress once per operator, then the codec on embed."""
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.core.compression import coding
    from repro_torch.core.compression import error_feedback as ef
    from repro_torch.core.compression import sparsify as sp
    cfg = get_config(LEAF_ARCH)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(LEAF_SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, secs = wall_s(lambda: _leaf_tree(cfg, dev, dtype, gen))
    e = ef.tree_init_error(x)
    for v in e.values():
        v.normal_(0.0, LEAF_E_STD, generator=gen)
    n = sum(v.numel() for v in x.values())
    held = torch.cuda.memory_allocated() / 1e9
    big = max(x, key=lambda k: x[k].numel())
    log(f"leaf (b) {cfg.name} published tree ({cfg.source}): {len(x)} "
        f"leaves, {n} elements, {cfg.dtype}; largest {big} "
        f"{tuple(x[big].shape)}; tree + float32 EF {held:.3f} GB on the card, "
        f"drawn in {secs:.3f} s; {smi}")
    if n != 2_506_172_416 or len(x) != 11:
        raise AssertionError(f"leaf (b): {len(x)} leaves, {n} elements")
    ops = _leaf_ops(trandom.PRNGKey(LEAF_SEED, dev))
    for name in LEAF_OPS:
        torch.cuda.reset_peak_memory_stats()
        (c, e2), secs = wall_s(lambda: ef.tree_ef_compress(ops[name], x, e))
        peak = torch.cuda.max_memory_allocated() / 1e9
        checks = _leaf_invariants(name, x, e, c, e2)
        log(f"leaf (b) tree_ef_compress {name}: {secs:.3f} s a call, peak "
            f"{peak:.3f} GB (tree + EF held {held:.3f} GB, the call's two "
            f"trees {held:.3f} GB more); {checks}; {smi}")
        del c, e2
        torch.cuda.empty_cache()

    # (d) the codec on embed's top 0.1%
    emb = x["embed"]
    d, k = emb.numel(), math.ceil(emb.numel() * CODEC_FRAC)
    mask, secs = wall_s(lambda: sp.topk_mask(emb, k))
    t0 = time.perf_counter()
    idx = coding.mask_to_indices(mask.cpu().numpy())
    t_idx = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits, bs = coding.encode_positions(idx, d)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = coding.decode_positions(bits, d, bs)
    t_dec = time.perf_counter() - t0
    want = coding.sparse_message_bits(d, k, 0.0)
    log(f"leaf (d) codec on embed {tuple(emb.shape)} top {CODEC_FRAC:.1%} "
        f"({k} indices, d = {d}): top-k mask {secs:.3f} s on the card, "
        f"mask_to_indices {t_idx:.3f} s, encode {t_enc:.3f} s, decode "
        f"{t_dec:.3f} s; block {bs}, {len(bits)} bits (sparse_message_bits "
        f"{want:.0f}); decode == input {back == idx.tolist()}")
    if len(idx) != k or back != idx.tolist() or len(bits) != want:
        raise AssertionError(f"leaf (d): {len(idx)} indices, {len(bits)} "
                             f"bits against {want}")
    del x, e, mask
    torch.cuda.empty_cache()


def _leaf_numpy(dev) -> None:
    """(c): the numpy channel and policies at N = 10^5 against their torch
    twins on the card, the greedies at N = 256, and the update-success
    analytics over bench_rs_rr_pf.py's grid."""
    from repro_torch import random as trandom
    from repro_torch.core import scheduling as sch
    from repro_torch.core import wireless as w
    rng = np.random.default_rng(LEAF_SEED)
    cfg = w.WirelessConfig(n_devices=LEAF_N)
    cp = w.channel_params(cfg, dev)
    dist = w.sample_positions(rng, cfg).astype(np.float32)
    fad = w.sample_fading(rng, LEAF_N).astype(np.float32)
    td, tf = torch.from_numpy(dist).to(dev), torch.from_numpy(fad).to(dev)
    bw = cfg.bandwidth_hz
    t0 = time.perf_counter()
    s32 = w.snr_jax(td, tf, cp).cpu().numpy()
    r32 = w.shannon_rate_jax(torch.from_numpy(s32).to(dev),
                             cp.bandwidth_hz).cpu().numpy()
    l32 = w.comm_latency_jax(1e6, torch.from_numpy(r32).to(dev)).cpu().numpy()
    pairs = (("path_gain", w.path_gain_jax(td, cp).cpu().numpy(),
              w.path_gain(dist.astype(np.float64), cfg), 1e-5, 0.0),
             ("snr", s32, w.snr(dist.astype(np.float64),
                                fad.astype(np.float64), cfg), 1e-5, 0.0),
             ("shannon_rate", r32, w.shannon_rate(s32.astype(np.float64), bw),
              1e-6, bw * 2.0 ** -22),
             ("comm_latency", l32, w.comm_latency(1e6, r32.astype(np.float64)),
              1e-6, 0.0))
    errs = {}
    for name, got, want, rtol, atol in pairs:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
        errs[name] = float(np.max(np.abs(got - want) / np.abs(want)))
    shown = ", ".join(f"{k}: {v:.3g}" for k, v in errs.items())
    log(f"leaf (c) channel at N = {LEAF_N}, numpy vs the torch twins on the "
        f"card, max rel err {{{shown}}} "
        f"(tolerances rtol 1e-5, 1e-5, 1e-6 + {bw * 2.0 ** -22:.3g} b/s, "
        f"1e-6); {time.perf_counter() - t0:.3f} s")

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    avg, comp = f32(s32 * rng.exponential(1.0, LEAF_N)), f32(
        rng.exponential(0.3, LEAF_N))
    norms = f32(rng.random(LEAF_N))
    ages = rng.integers(0, 12, LEAF_N).astype(np.float32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    pc = sch.PolicyConfig(n_devices=LEAF_N, n_scheduled=LEAF_K,
                          model_bits=1e6, deadline_s=5.0)
    st = sch.RoundState(t=3, key=trandom.PRNGKey(0, dev), snr_lin=on(s32),
                        avg_snr=on(avg), rates=on(r32), comm_lat=on(l32),
                        comp_lat=on(comp), ages=on(ages),
                        update_norms=on(norms))
    dp = int(pc.model_bits / 32)
    t0 = time.perf_counter()
    want = {"round_robin": (sch.round_robin(3, LEAF_N, LEAF_K), None),
            "pf": (sch.proportional_fair(s32, avg, LEAF_K),
                   s32 / np.maximum(avg, 1e-12)),
            "latency": (sch.latency_minimal(l32, comp, LEAF_K),
                        -(l32 + comp)),
            "best_channel": (sch.best_channel(s32, LEAF_K), s32),
            "bn2": (sch.best_norm(norms, LEAF_K), norms),
            "bc_bn2": (sch.bc_bn2(s32, norms, 2 * LEAF_K, LEAF_K), s32),
            "bn2_c": (sch.bn2_c(norms, r32, dp, pc.deadline_s, LEAF_K),
                      sch.quantized_norm(norms, r32, dp, pc.deadline_s))}
    ties = {}
    for name, (mask, score) in want.items():
        got = sch.get_policy(name)(pc, st).cpu().numpy()
        kth = None if score is None else np.sort(score)[::-1][LEAF_K - 1]
        ties[name] = 0 if kth is None else int((score == kth).sum()) - 1
        off = int((got != mask).sum())
        if off > 2 * ties[name]:
            raise AssertionError(f"leaf (c) {name}: {off} devices differ, "
                                 f"{ties[name]} ties at the k-th score")
    m = GREEDY_N
    pc_m = sch.PolicyConfig(n_devices=m, n_scheduled=LEAF_K, deadline_s=2.0)
    st_m = st._replace(comm_lat=st.comm_lat[:m], comp_lat=st.comp_lat[:m],
                       snr_lin=st.snr_lin[:m])
    dl = sch.get_policy("deadline")(pc_m, st_m).cpu().numpy()
    snr_w = f32(rng.exponential(1.0, (m, 20)) * s32[:m, None])
    ag = sch.age_greedy_jax(on(ages[:m]), on(snr_w), 2e5, 1e6).cpu().numpy()
    if not (np.array_equal(dl, sch.deadline_greedy(l32[:m], comp[:m], 2.0))
            and np.array_equal(ag, sch.age_based_greedy(
                ages[:m], snr_w, 2e5, 1e6, 20)[0])):
        raise AssertionError("leaf (c): a greedy policy differs")
    sched = on(s32 > np.median(s32))
    if not (np.array_equal(sch.update_ages_jax(on(ages), sched).cpu().numpy(),
                           sch.update_ages(ages, s32 > np.median(s32)))
            and np.allclose(sch._f_alpha(on(ages + 1), 1.0).cpu().numpy(),
                            sch.f_alpha(ages + 1, 1.0), rtol=1e-6)):
        raise AssertionError("leaf (c): ages or f_alpha differ")
    log(f"leaf (c) policies, numpy vs the torch twins on the card: "
        f"{', '.join(want)} at N = {LEAF_N}, k = {LEAF_K} select the same "
        f"sets (ties at the k-th score {ties}); deadline ({int(dl.sum())} "
        f"scheduled) and age ({int(ag.sum())}) greedy at N = {m} equal; "
        f"update_ages and f_alpha equal; {time.perf_counter() - t0:.3f} s")

    k_, n_, alpha = RSRRPF_K, RSRRPF_N, RSRRPF_ALPHA
    for db in RSRRPF_DB:
        gamma = 10 ** (db / 10)
        v = w.interference_functional(gamma, alpha)
        u = (w.update_success_rs(k_, n_, v), w.update_success_rr(v),
             w.update_success_pf(k_, n_, gamma, alpha))
        t = (w.rounds_required(u[0]), w.rounds_required_rr(u[1], k_, n_),
             w.rounds_required(u[2]))
        log(f"leaf (c) update success at K = {k_}, N = {n_}, alpha {alpha}, "
            f"gamma* {db:+.0f} dB: V {v:.6g}; U rs {u[0]:.6g}, rr "
            f"{u[1]:.6g}, pf {u[2]:.6g}; rounds rs {t[0]:.6g}, rr {t[1]:.6g},"
            f" pf {t[2]:.6g}; T_pf / T_rr {t[2] / t[1]:.4g}")
        if not (0 < u[0] < u[1] <= 1 and u[2] >= 0.9 * u[0]):
            raise AssertionError(f"leaf (c) at {db} dB: order {u}")


def run_leaf(dev, smi: str) -> dict:
    """Phase 19: the per-leaf compressors and the numpy reference layer:
    card against CPU on the reduced tree (a), gemma-2b's published tree
    through tree_ef_compress (b), the numpy layer at the fleet's size (c),
    the codec on embed (d). Returns each kernel's launches across the phase
    (all must be 0)."""
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))
    zero()
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"leaf {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    _leaf_card_vs_cpu(dev)
    took("(a) card vs cpu")
    _leaf_numpy(dev)
    took("(c) numpy layer")
    _leaf_full(dev, smi)
    took("(b, d) published tree and codec")
    got = read()
    log(f"leaf kernel launches across phase 19: {got}")
    if any(got.values()):
        raise AssertionError(f"leaf: kernels launched {got}")
    return total


def _digest(tensors: dict, chunk: int = 1 << 26) -> dict:
    """Two sums of each leaf's bits (int64, and float64 of their squares),
    a chunk at a time: equal digests on two members say their leaves agree
    bit for bit."""
    out = {}
    for k, v in tensors.items():
        flat = v.detach().contiguous().reshape(-1).view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[v.element_size()])
        s1, s2 = 0, 0.0
        for i in range(0, flat.numel(), chunk):
            bits = flat[i:i + chunk].to(torch.int64)
            s1 += int(bits.sum())
            s2 += float(bits.double().pow(2).sum())
        out[k] = (s1, s2)
    return out


def _to(tree, device):
    """Every tensor of a state (dicts, ``OptState``) on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree


def _in_turns(rank: int, world: int, make, dev):
    """``make()`` on one member at a time, the members that are done
    waiting in host memory (a draw peaks at several times its output, and
    the members share one card); then everyone's result on ``dev``."""
    import torch.distributed as dist
    out = None
    for r in range(world):
        if r == rank:
            out = make()
            torch.cuda.synchronize()
            if r < world - 1:
                out = _to(out, "cpu")
            torch.cuda.empty_cache()
        dist.barrier()
    return _to(out, dev)


def _member_counts() -> dict:
    counters = dict(_row_counters(), **_tile_counters())
    out = {n: fn.launches for n, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    return out


def _cluster_collectives(rank: int, dev) -> dict:
    """(a): every method with and without EF on each mesh, the card's call
    against the same call on CPU tensors."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    res = {}
    gen = np.random.default_rng([20, rank])
    g = gen.standard_normal(CLUSTER_LEAF).astype(np.float32)
    e = (0.1 * gen.standard_normal(CLUSTER_LEAF)).astype(np.float32)
    g.reshape(-1)[::7] = 0.0
    for shape, axes in CLUSTER_MESHES:
        mesh = make_mesh(shape, axes)
        for method in CLUSTER_METHODS:
            for with_e in (True, False):
                runs = {}
                for where in ("cuda", "cpu"):
                    d = dev if where == "cuda" else torch.device("cpu")
                    coll.WIRE.reset()
                    (o, en), secs = wall_s(lambda: coll.hierarchical_allreduce(
                        {"w": torch.as_tensor(g, device=d)}, axes, method,
                        {"w": torch.as_tensor(e, device=d)} if with_e
                        else None, mesh=mesh))
                    runs[where] = (o["w"].cpu(), None if en is None
                                   else en["w"].cpu(), secs,
                                   coll.WIRE.total, sorted(coll.WIRE.staged))
                (go, ge, secs, wire, staged), (co, ce, *_) = (runs["cuda"],
                                                             runs["cpu"])
                if method == "sign":
                    ok = (torch.equal(torch.sign(go), torch.sign(co))
                          and torch.allclose(go, co, rtol=CLUSTER_SCALE_RTOL,
                                             atol=0)
                          and (ge is None or torch.allclose(
                              ge, ce, rtol=0, atol=CLUSTER_SIGN_ATOL)))
                else:
                    ok = torch.equal(go, co) and (ge is None
                                                  or torch.equal(ge, ce))
                rel = float(((go - co).abs() / co.abs().clamp_min(
                    1e-30)).max())
                res[(axes, method, with_e)] = dict(
                    ok=ok, rel=rel, secs=secs, wire=wire, staged=staged,
                    digest=_digest({"o": go}))
    return res


def _cluster_ring(rank: int, dev) -> dict:
    """(b): the ring on 4 members, float32 and bf16, card against CPU."""
    from repro_torch.fl.decentralized import ring_gossip_shard_map
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4,), ("data",))
    x = torch.as_tensor(np.random.default_rng([21, rank]).standard_normal(
        RING_BLOCK).astype(np.float32))
    mix = ring_gossip_shard_map(mesh, "data")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        got, secs = wall_s(lambda: mix({"x": x.to(dev, dt)})["x"].cpu())
        want = mix({"x": x.to(dt)})["x"]
        out[str(dt)] = dict(ok=torch.equal(got, want), secs=secs)
    return out


def _batches(cfg, steps: int, batch: int, seq: int, device):
    from repro_torch.data import SyntheticLMDataset, batch_iterator
    it = batch_iterator(SyntheticLMDataset(cfg.vocab_size, seq, 4096,
                                           seed=0), batch, seed=0)
    return [{k: torch.as_tensor(v, device=device)
             for k, v in next(it).items()} for _ in range(steps)]


def _steps_run(cfg, policy, mesh, device, steps: int, batch: int,
               seq: int) -> tuple:
    """``launch/steps.py`` as ``run_cluster`` drives it: (losses, this
    member's state)."""
    from repro_torch import random as trandom
    from repro_torch.launch import steps as tsteps
    state = tsteps.make_init_fn(cfg, policy, mesh)(
        trandom.PRNGKey(0, device))
    step = tsteps.make_train_step(cfg, policy, mesh)
    losses = []
    for b in _batches(cfg, steps, batch, seq, device):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state


def _held_bytes(state) -> int:
    opt = state["opt"]
    return sum(v.numel() * v.element_size() for t in (
        state["params"], opt.m, opt.v) if t is not None for v in t.values())


def _cluster_trainer(rank: int, dev, cases) -> dict:
    """(c): each case card against CPU on these members: (what, arch,
    mode, compression, mesh shape, axes); the data-and-model ones through
    ``run_cluster``, the others through ``launch/steps.py``."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models.tp import set_model_mesh
    res = {}
    for what, arch, mode, comp, shape, axes in cases:
        cfg = get_config(arch).reduced()
        # the leaves a member holds a block of over model
        split = {k for k, sp in tsteps.held_specs(
            cfg, tsteps.TrainPolicy(mode=mode, compression=comp),
            Mesh(shape, axes, bind=False))["params"].items() if "model" in sp}
        runs = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else "cpu"
            t0 = time.perf_counter()
            coll.WIRE.reset()
            if axes == ("data", "model"):
                args = cli.parser().parse_args(
                    ["--arch", arch, "--mode", mode, "--compression", comp,
                     "--mesh-data", str(shape[0]), "--mesh-model",
                     str(shape[1])] + CLUSTER_ARGS
                    + CLUSTER_EXTRA.get(what, []))
                with contextlib.redirect_stdout(io.StringIO()):
                    losses, state = cli.run_cluster(args, device=d)
            else:
                pol = tsteps.TrainPolicy(
                    mode=mode, compression=comp,
                    error_feedback=comp in ("int8", "sign"),
                    local_steps=2, lr=3e-3, total_steps=3, remat=False)
                losses, state = _steps_run(cfg, pol, make_mesh(shape, axes),
                                           d, 3, 8, 64)
            # the train step's builder names its mesh to the layers; (e)
            # after this runs in one process
            set_model_mesh(None)
            if where == "cuda":
                torch.cuda.synchronize()
            runs[where] = (losses, {k: v.cpu() for k, v in
                                    state["params"].items()},
                           time.perf_counter() - t0, _held_bytes(state),
                           coll.WIRE.total)
        (gl, gp, secs, held, wire), (cl, cp, *_) = runs["cuda"], runs["cpu"]
        rel = float(np.max(np.abs(np.array(gl) - cl) / np.abs(cl)))
        num = sum(float(((gp[k].double() - cp[k].double()) ** 2).sum())
                  for k in cp)
        den = sum(float((cp[k].double() ** 2).sum()) for k in cp)
        whole = sum(math.prod(p.shape) * 4 for p in
                    tsteps.param_shapes(cfg).values()) * 3
        res[what] = dict(loss=cl, rel=rel, p_err=(num / den) ** 0.5,
                         secs=secs, held=held, whole=whole, wire=wire,
                         digest=_digest({k: v for k, v in gp.items()
                                         if k not in split}))
    return res


def _ef_checked(orig, worst: list):
    """``compressed_allreduce_leaf`` that records, for each int8 leaf with
    EF, the largest |sent + e' - corrected| (sent = q * scale, in float64)
    over the float32 bound 2^-24 max|corrected|; a chunk of 2^24 elements
    at a time, so that the check adds little to the step's peak."""
    from repro_torch.core import collectives as coll

    def leaf(g, axis="data", method="none", e=None, min_size=65_536,
             mesh=None):
        out, e_new = orig(g, axis, method, e, min_size, mesh)
        if e is not None and method == "int8" and g.numel() >= min_size:
            gf, ef, en = g.reshape(-1), e.reshape(-1), e_new.reshape(-1)
            chunk = 1 << 24
            parts = range(0, gf.numel(), chunk)
            cmax = max((gf[i:i + chunk].float() + ef[i:i + chunk]).abs().max()
                       for i in parts)
            scale = torch.clamp_min(cmax, 1e-20) * coll._INV127
            bad = 0.0
            for i in parts:
                ci = gf[i:i + chunk].float() + ef[i:i + chunk]
                q = torch.clamp(torch.round(ci / scale), -127, 127)
                d = (q.double() * scale.double()
                     + en[i:i + chunk].double() - ci.double())
                bad = max(bad, float(d.abs().max()))
            worst.append(bad / (2.0 ** -24 * float(cmax)))
        return out, e_new
    return leaf


def _cluster_gemma(rank: int, dev) -> dict:
    """(d): gemma-2b at its published widths, depth cut, float32, pssgd
    int8 + EF on (data 2): s a step, peak, wire bytes, the params' digests
    after every step and the EF identity."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import state_bytes
    cfg = dataclasses.replace(get_config("gemma-2b"),
                              n_layers=GEMMA_WIDE_DEPTH, dtype="float32")
    pol = tsteps.TrainPolicy(mode="pssgd", compression="int8",
                             error_feedback=True, lr=1e-3,
                             total_steps=GEMMA_WIDE_STEPS, remat=True)
    mesh = make_local_mesh(2, 1)
    init = tsteps.make_init_fn(cfg, pol, mesh)
    base = torch.cuda.memory_allocated()
    state, init_s = wall_s(lambda: _in_turns(
        rank, 2, lambda: init(trandom.PRNGKey(0, dev)), dev))
    step = tsteps.make_train_step(cfg, pol, mesh)
    worst, orig = [], coll.compressed_allreduce_leaf
    coll.compressed_allreduce_leaf = _ef_checked(orig, worst)
    out = dict(init_s=init_s, step_s=[], event_s=[], peak=[], wire=[],
               digests=[], loss=[], ef_worst=[], held=[], base=base,
               d=sum(v.numel() for v in state["params"].values()))
    try:
        for b in _batches(cfg, GEMMA_WIDE_STEPS, GEMMA_WIDE_B, GEMMA_WIDE_SEQ,
                          dev):
            out["held"].append(state_bytes((state, b)))
            torch.cuda.reset_peak_memory_stats()
            coll.WIRE.reset()
            worst.clear()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            (state, m), secs = wall_s(lambda: step(state, b))
            ev[1].record()
            torch.cuda.synchronize()
            out["step_s"].append(secs)
            out["event_s"].append(ev[0].elapsed_time(ev[1]) / 1e3)
            out["peak"].append(torch.cuda.max_memory_allocated())
            out["wire"].append(coll.WIRE.total)
            out["loss"].append(float(m["loss"]))
            out["ef_worst"].append(max(worst))
            out["digests"].append(_digest(state["params"]))
    finally:
        coll.compressed_allreduce_leaf = orig
    del state
    torch.cuda.empty_cache()
    return out


def _tp_serve(cfg, params, mesh, dev, ring: int = 0) -> dict:
    """A (4, 128) prompt and TP_WIDE_GEN greedy decode steps on ``mesh``
    (this member's blocks of ``params``): the tokens, each step's logits
    gathered whole (on the host), ms a decode step and the bytes of the
    member's decode cache. ``ring``: a cache of that many positions
    decoded as a ring, and TP_WIDE_RING greedy steps more at positions
    past its end (the ring wraps)."""
    from repro_torch.launch import serve
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.specs import state_bytes
    from repro_torch.models import tp, transformer as tf
    b, s_ = TP_WIDE_PROMPT
    t = ring or s_ + TP_WIDE_GEN
    at = [s_ + i for i in range(TP_WIDE_GEN)] + [
        ring + i for i in range(TP_WIDE_RING if ring else 0)]
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s_)), dtype=torch.int32, device=dev)
    out = dict(tokens=[], logits=[], decode_ms=[])
    with torch.no_grad():
        logits, pf = tsteps.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": prompt})
        cache = serve._load_prefill(cfg, tf.init_decode_cache(
            cfg, b, t, device=dev, mesh=mesh), pf, s_, mesh=mesh,
            cache_len=t)
        out["cache_bytes"] = state_bytes(cache)
        del pf
        decode = tsteps.make_decode_step(cfg, circular=bool(ring),
                                         mesh=mesh, cache_len=t)
        for i in range(len(at) + 1):
            full = tp.gather_last(logits, cfg.vocab_size)
            token = full[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
            out["tokens"].append(token.cpu())
            out["logits"].append(full.cpu())
            if i == len(at):
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, token, at[i])
            torch.cuda.synchronize()
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
    tp.set_model_mesh(None)
    return out


def _tp_train(cfg, pol, mesh, dev, rank: int, world: int,
              serve: bool = True, ring: int = 0) -> dict:
    """(g)'s run on ``mesh``: the init (in turns over ``world`` members),
    the serving of ``_tp_serve`` (with ``serve``; with ``ring`` too into a
    ring of that many positions), then GEMMA_WIDE_STEPS
    train steps, each timed (wall clock and CUDA events), with its
    step-only peak, the state and batch held and the wire by kind; returns
    the state too."""
    from repro_torch import random as trandom
    from repro_torch.core import collectives as coll
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.specs import state_bytes
    init = tsteps.make_init_fn(cfg, pol, mesh)
    base = torch.cuda.memory_allocated()
    make = (lambda: init(trandom.PRNGKey(0, dev)))
    state, init_s = wall_s(lambda: _in_turns(rank, world, make, dev)
                           if world > 1 else make())
    out = dict(init_s=init_s, base=base, step_s=[], event_s=[], peak=[],
               held=[], wire=[], loss=[])
    if serve:
        out["serve"] = _tp_serve(cfg, state["params"], mesh, dev)
        torch.cuda.empty_cache()
    if ring:
        out["serve_ring"] = _tp_serve(cfg, state["params"], mesh, dev, ring)
        torch.cuda.empty_cache()
    step = tsteps.make_train_step(cfg, pol, mesh)
    coll.WIRE.record_calls()
    try:
        for b in _batches(cfg, GEMMA_WIDE_STEPS, GEMMA_WIDE_B,
                          GEMMA_WIDE_SEQ, dev):
            out["held"].append(state_bytes((state, b)))
            torch.cuda.reset_peak_memory_stats()
            coll.WIRE.reset()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            (state, m), secs = wall_s(lambda: step(state, b))
            ev[1].record()
            torch.cuda.synchronize()
            out["step_s"].append(secs)
            out["event_s"].append(ev[0].elapsed_time(ev[1]) / 1e3)
            out["peak"].append(torch.cuda.max_memory_allocated())
            kinds = {}
            for kind, nbytes, _ in coll.WIRE.calls:
                kinds[kind] = kinds.get(kind, 0) + nbytes
            out["wire"].append(kinds)
            out["loss"].append(float(m["loss"]))
    finally:
        coll.WIRE.record_calls(False)
    return out, state


def _cluster_tp(rank: int, dev, arch: str = "gemma-2b",
                depth: int = GEMMA_WIDE_DEPTH, ring: bool = False) -> dict:
    """(g), (h): ``arch`` at its published widths, ``depth`` layers,
    float32, pssgd none, every leaf the rules split held in blocks over
    model on (data 1, model 2); member 0 first runs the same on (1, 1)
    alone (the other waits), and holds the members' losses, served tokens
    and logits and gathered params against it. ``ring``: also served into
    a ring of ``d_inner`` positions, which the cache rule splits over
    model where the kv heads do not divide."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shard_rules
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models import tp
    cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                              dtype="float32")
    pol = tsteps.TrainPolicy(mode="pssgd", compression="none", lr=1e-3,
                             total_steps=GEMMA_WIDE_STEPS, remat=True)
    one = None
    if rank == 0:
        one, state = _tp_train(cfg, pol, Mesh((1, 1), ("data", "model"),
                                                bind=False), dev, 0, 1,
                               ring=cfg.d_inner if ring else 0)
        one["params"] = {k: v.cpu() for k, v in state["params"].items()}
        del state
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_local_mesh(1, 2)
    out, state = _tp_train(cfg, pol, mesh, dev, rank, 2,
                           ring=cfg.d_inner if ring else 0)
    specs = tsteps.held_specs(cfg, pol, mesh)["params"]
    split = {k for k, sp in specs.items() if "model" in sp}
    out["split"] = sorted(split)
    out["digest"] = _digest({k: v for k, v in state["params"].items()
                             if k not in split})
    num = den = 0.0
    for k in sorted(state["params"]):   # gathered whole, leaf by leaf
        g = shard_rules.gather(state["params"][k], specs[k], mesh)
        if rank == 0:
            r = one["params"].pop(k).to(dev).double()
            num += float(((g.double() - r) ** 2).sum())
            den += float((r ** 2).sum())
        del g
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        out["params_err"] = (num / den) ** 0.5
        del one["params"]
        out["one"] = one
    tp.set_model_mesh(None)
    dist.barrier()
    return out


def _cluster_fsdp(rank: int, dev) -> dict:
    """(i)(1): gemma-2b at its published widths, depth cut, float32, fsdp
    on (data 2), a layer's leaves gathered where the layer runs; member 0
    first runs the same on (1, 1) alone (the other waits) and holds the
    members' losses and gathered params against it; every member's
    gathered params' digest."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models import tp
    cfg = dataclasses.replace(get_config("gemma-2b"),
                              n_layers=GEMMA_WIDE_DEPTH, dtype="float32")
    pol = tsteps.TrainPolicy(**FSDP_POLICY)
    one = None
    if rank == 0:
        one, state = _tp_train(cfg, pol, Mesh((1, 1), ("data", "model"),
                                                bind=False), dev, 0, 1,
                               serve=False)
        one["params"] = {k: v.cpu() for k, v in state["params"].items()}
        del state
        torch.cuda.empty_cache()
    tp.set_model_mesh(None)
    dist.barrier()
    mesh = make_local_mesh(2, 1)
    out, state = _tp_train(cfg, pol, mesh, dev, rank, 2, serve=False)
    whole = tsteps.gather_params(cfg, pol, mesh, state["params"])
    del state
    out["digest"] = _digest(whole)
    if rank == 0:
        num = den = 0.0
        for k in sorted(whole):
            g, r = whole[k].double(), one["params"].pop(k).to(dev).double()
            num += float(((g - r) ** 2).sum())
            den += float((r ** 2).sum())
        out["params_err"] = (num / den) ** 0.5
        del one["params"]
        out["one"] = one
    del whole
    torch.cuda.empty_cache()
    tp.set_model_mesh(None)
    dist.barrier()
    return out


def _served_greedy(cfg, params, prompt, mesh=None, global_batch=None
                   ) -> dict:
    """``prompt``'s rows (this member's on ``mesh``, of a global batch of
    ``global_batch`` rows) prefilled, then TP_WIDE_GEN greedy decode steps:
    the tokens, each step's logits (on the host) and the choices the MoE
    layers' capacity dropped."""
    from repro_torch.launch import serve
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import moe, transformer as tf
    route, drops = moe.route, []

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(r.overflow.sum())
        return r
    moe.route = counted
    b, s_ = prompt.shape
    out = dict(tokens=[], logits=[])
    try:
        with torch.no_grad():
            logits, pf = tsteps.make_prefill_step(
                cfg, mesh=mesh, global_batch=global_batch)(
                params, {"tokens": prompt})
            cache = serve._load_prefill(cfg, tf.init_decode_cache(
                cfg, b, s_ + TP_WIDE_GEN, device=prompt.device), pf, s_)
            del pf
            decode = tsteps.make_decode_step(cfg, circular=False, mesh=mesh,
                                             global_batch=global_batch)
            for i in range(TP_WIDE_GEN + 1):
                token = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
                out["tokens"].append(token[:, None].cpu())
                out["logits"].append(logits.cpu())
                if i < TP_WIDE_GEN:
                    logits, cache = decode(params, cache, token[:, None],
                                           s_ + i)
    finally:
        moe.route = route
    out["drops"] = int(sum(int(d) for d in drops))
    return out


def _replayed(cfg, params, prompt, n: int = 2) -> list:
    """(i)(2)'s members served in this one process, one after another:
    member r's rows of ``prompt`` through ``_served_greedy`` on a
    description of (data n, model 1) placed at r, each MoE layer handed
    the per-expert counts of the lower-ranked members' same layer and step
    in place of the all-gather (the higher ranks' enter only the aux loss,
    which serving drops: zeros). The members' shapes and routing without
    the process group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe, tp
    gather, counts = moe.all_gather, [[] for _ in range(n)]

    def replay(x, mesh, axes, log=True):
        r = mesh.index(axes)
        counts[r].append(x)
        i = len(counts[r]) - 1
        return torch.stack([c[i] for c in counts[:r]] + [x] + [
            torch.zeros_like(x)] * (n - 1 - r))
    moe.all_gather = replay
    b = prompt.shape[0]
    outs = []
    try:
        for r in range(n):
            mesh = Mesh((n, 1), ("data", "model"), bind=False)
            mesh.coords = mesh.coords_of(r)
            outs.append(_served_greedy(
                cfg, params, prompt[r * b // n:(r + 1) * b // n], mesh, b))
    finally:
        moe.all_gather = gather
        tp.set_model_mesh(None)
    return outs


def _row_drift(cfg, params, dev) -> dict:
    """The largest |difference| between the first rows of one float32
    product on the card computed over a member's rows and over the whole
    batch's: a (rows, d_model) x (d_model, d_model) product at the
    prefill's 256 and 512 token rows, and the unembedding at the decode's
    2 and 4 rows."""
    g = torch.Generator(device=dev).manual_seed(5)
    d = cfg.d_model
    w = torch.randn(d, d, generator=g, device=dev) / d ** 0.5
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = {}
    for name, m, mat in (("prefill rows", TP_WIDE_PROMPT[0]
                          * TP_WIDE_PROMPT[1], w),
                         ("unembedding", TP_WIDE_PROMPT[0], table)):
        x = torch.randn(m, d, generator=g, device=dev)
        half = x[:m // 2] @ mat
        out[name] = float((half - (x @ mat)[:m // 2]).abs().max())
    return out


def _cluster_moe_serve(rank: int, dev) -> dict:
    """(i)(2): qwen2-moe-a2.7b at its published widths, 2 layers, float32,
    a (4, 128) prompt and TP_WIDE_GEN greedy steps on (data 2, model 1),
    each member its 2 rows, routed as its part of the whole batch; member
    0 first serves the whole prompt alone and replays the members at their
    shapes (``_replayed``), the other waiting."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import tp, transformer as tf
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              n_layers=MOE_SERVE_DEPTH, dtype="float32")
    b, s_ = TP_WIDE_PROMPT
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s_)), dtype=torch.int32, device=dev)
    params = _in_turns(rank, 2, lambda: tf.init_params(
        cfg, trandom.PRNGKey(0, dev)), dev)
    out = {"cf": cfg.capacity_factor}
    if rank == 0:
        out["one"], out["one_s"] = wall_s(
            lambda: _served_greedy(cfg, params, prompt))
        out["replay"] = _replayed(cfg, params, prompt)
        out["drift"] = _row_drift(cfg, params, dev)
    dist.barrier()
    mesh = make_local_mesh(2, 1)
    rows = prompt[rank * b // 2:(rank + 1) * b // 2]
    out["mesh"], out["mesh_s"] = wall_s(
        lambda: _served_greedy(cfg, params, rows, mesh, b))
    tp.set_model_mesh(None)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _cluster_moe_wide(rank: int, dev) -> dict:
    """(e): qwen2-moe-a2.7b at its published widths, MOE_WIDE_DEPTH layers,
    one batch's loss and gradient through ``moe_forward_ep`` on (data 1,
    model 4), each member holding 16 of the 64 padded experts a layer;
    rank 0 holds it against the one-process ``moe_forward`` on the card
    with the same params."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shard_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import tp, transformer as tf
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              n_layers=MOE_WIDE_DEPTH, dtype="float32")
    mesh = make_local_mesh(1, 4)
    shapes = tf.init_params(cfg, trandom.PRNGKey(0, "meta"))
    specs = {k: shard_rules.param_spec(k, tuple(v.shape), cfg, mesh,
                                       fsdp=False)
             for k, v in shapes.items()
             if shard_rules.is_expert_stack(k, v.shape, cfg)}
    experts = sorted(specs)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, MOE_WIDE_B, MOE_WIDE_SEQ))
    batch = {"tokens": torch.as_tensor(toks[0], dtype=torch.int32,
                                       device=dev),
             "labels": torch.as_tensor(toks[1], dtype=torch.int32,
                                       device=dev)}

    def value_grad(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _ = tf.lm_loss(leaves, cfg, batch, remat=False)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))
    parts, t = {}, time.perf_counter()

    def took(what):
        nonlocal t
        torch.cuda.synchronize()
        parts[what] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
    # rank 0 draws the params once, takes the one-process gradient, and
    # hands the params out leaf by leaf (every member's draw would be the
    # same, and a draw peaks at several times its output on the shared
    # card); each member keeps its experts
    drawn, out = {}, {}
    if rank == 0:
        drawn = tf.init_params(cfg, trandom.PRNGKey(0, dev))
        took("draw")
        (out["ref_loss"], ref), out["ref_secs"] = wall_s(
            lambda: value_grad(drawn))
        took("one process")
    params = {}
    for k, v in shapes.items():
        x = drawn.pop(k) if rank == 0 else torch.empty(
            v.shape, dtype=v.dtype, device=dev)
        dist.broadcast(x, 0)
        params[k] = shard_rules.shard(x, specs[k], mesh) if k in specs else x
        del x
    torch.cuda.empty_cache()
    took("hand out")
    tp.set_model_mesh(mesh)
    try:
        (loss, grads), secs = wall_s(lambda: value_grad(params))
    finally:
        tp.set_model_mesh(None)
    took("moe_forward_ep")
    out.update(loss=loss, secs=secs,
               expert_bytes=sum(params[k].numel() * 4 for k in experts),
               all_bytes=sum(v.numel() * 4 for v in params.values()))
    del params
    num = den = 0.0
    for k in list(grads):   # the expert stacks gathered whole, leaf by leaf
        g = grads.pop(k)
        if k in specs:
            g = shard_rules.gather(g, specs[k], mesh)
        if rank == 0:
            r = ref.pop(k).double()
            num += float(((g.double() - r) ** 2).sum())
            den += float((r ** 2).sum())
        del g
    if rank == 0:
        out["grad_err"] = (num / den) ** 0.5
    took("compare")
    out["parts"] = parts
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _cluster_sweep(rank: int, dev) -> dict:
    """(f): the fleet configuration's top-k sweep over the members."""
    import torch.distributed as dist
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    cfg = rt.SimConfig(rounds=FLEET_SWEEP_ROUNDS, datagen=_datagen(),
                       algo_params=algos.algo_params(lr=0.05),
                       compression="topk", **FLEET)
    _member_counts()
    out, secs = wall_s(lambda: rt.run_sweep(
        cfg, _loss, {"w": np.zeros(D_FLEET, np.float32)}, None,
        seeds=FLEET_SEEDS, policies=FLEET_POLICIES, compressions=("topk",),
        devices=dist.get_world_size(), device=dev))
    return dict(logs={k: {f: getattr(v, f) for f in rt._LOG_FIELDS}
                      for k, v in out.items()},
                secs=secs, launches=_member_counts())


def _members_four(rank: int, device: str) -> dict:
    """Spawn A: 4 members sharing the card (gloo)."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    _member_counts()
    out = {}
    parts = (("a", lambda: _cluster_collectives(rank, dev)),
             ("b", lambda: _cluster_ring(rank, dev)),
             ("c", lambda: _cluster_trainer(rank, dev, CLUSTER_TRAIN_FOUR)),
             ("e", lambda: _cluster_moe_wide(rank, dev)))
    for name, fn in parts:
        out[name], out[name + "_s"] = wall_s(fn)
    out["launches"] = _member_counts()
    return out


def _members_two(rank: int, device: str) -> dict:
    """Spawn B: 2 members sharing the card (gloo)."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    _member_counts()
    out = {}
    parts = (("c", lambda: _cluster_trainer(rank, dev, CLUSTER_TRAIN_TWO)),
             ("d", lambda: _cluster_gemma(rank, dev)),
             ("g", lambda: _cluster_tp(rank, dev, ring=True))) + tuple(
        (name, functools.partial(_cluster_tp, rank, dev, arch, depth))
        for name, arch, depth in TP_RECURRENT) + (
        ("i", lambda: _cluster_fsdp(rank, dev)),
        ("i moe", lambda: _cluster_moe_serve(rank, dev)))
    for name, fn in parts:
        out[name], out[name + "_s"] = wall_s(fn)
    out["launches"] = _member_counts()
    out["f"], out["f_s"] = wall_s(lambda: _cluster_sweep(rank, dev))
    return out


def _fleet_sweep_once(dev) -> tuple:
    """The one-process sweep (f) is held to, and its launches."""
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.fl import runtime as rt
    cfg = rt.SimConfig(rounds=FLEET_SWEEP_ROUNDS, datagen=_datagen(),
                       algo_params=algos.algo_params(lr=0.05),
                       compression="topk", **FLEET)
    _member_counts()
    out, secs = wall_s(lambda: rt.run_sweep(
        cfg, _loss, {"w": np.zeros(D_FLEET, np.float32)}, None,
        seeds=FLEET_SEEDS, policies=FLEET_POLICIES, compressions=("topk",),
        device=dev))
    return out, secs, _member_counts()


def run_cluster_phase(dev, smi: str) -> dict:
    """Phase 20: the cluster side on members that share the card (see the
    module docstring). Returns each kernel's launches summed over the
    members (only (f)'s sweep launches one)."""
    from repro_torch.core import collectives as coll
    from repro_torch.fl import runtime as rt
    from repro_torch.launch import members
    part = time.perf_counter()

    def took(what):
        nonlocal part
        log(f"cluster {what}: {time.perf_counter() - part:.2f} s")
        part = time.perf_counter()

    torch.cuda.empty_cache()
    log(f"cluster: members are processes sharing {smi}, backend "
        f"{members.choose_backend('cuda', 2)} (nccl refuses two ranks on one "
        f"device); the numbers test the code, the placement and the wire, "
        f"not the speed of several cards. gloo ops that take CUDA tensors "
        f"(torch {torch.__version__}): {coll.GLOO_CUDA_OPS}")
    a = members.spawn(_members_four, 4, (dev.type,), threads=2)
    took("spawn A (4 members)")
    for key in a[0]["a"]:
        axes, method, with_e = key
        rows = [m["a"][key] for m in a]
        alike = all(r["digest"] == rows[0]["digest"] for r in rows)
        log(f"cluster (a) {axes} {method} EF={with_e}: members bitwise "
            f"alike {alike}; card == cpu {all(r['ok'] for r in rows)} (max "
            f"rel {max(r['rel'] for r in rows):.3g}); wire bytes a member "
            f"{rows[0]['wire']}; {max(r['secs'] for r in rows):.4f} s on the "
            f"card; staged through host {rows[0]['staged']}")
        if not (alike and all(r["ok"] for r in rows)):
            raise AssertionError(f"cluster (a) {key}: {rows}")
    for dt in a[0]["b"]:
        ok = all(m["b"][dt]["ok"] for m in a)
        log(f"cluster (b) ring {dt} {RING_BLOCK} a member: card == cpu "
            f"bitwise {ok}, {max(m['b'][dt]['secs'] for m in a):.4f} s")
        if not ok:
            raise AssertionError(f"cluster (b) ring {dt}")
    _check_trainer(a, "c", CLUSTER_TRAIN_FOUR)
    MEASURED["cluster_moe"] = [m["c"][CLUSTER_MOE_NONE]["wire"] for m in a]
    e = [m["e"] for m in a]
    r0 = e[0]
    loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    log(f"cluster (e) qwen2-moe-a2.7b at its published widths, "
        f"{MOE_WIDE_DEPTH} layers, float32, ({MOE_WIDE_B}, {MOE_WIDE_SEQ}): "
        f"moe_forward_ep on (data 1, model 4): loss {r0['loss']:.6f} vs one "
        f"process {r0['ref_loss']:.6f} (rel {loss_err:.3g}), gradient "
        f"relative L2 {r0['grad_err']:.3g}; members' losses "
        f"{[m['loss'] for m in e]}; expert bytes a member "
        f"{[m['expert_bytes'] for m in e]} of {e[0]['all_bytes']} held; "
        f"{max(m['secs'] for m in e):.3f} s (one process "
        f"{r0['ref_secs']:.3f} s) on {smi}; rank 0's parts s {r0['parts']}")
    if not (loss_err <= 1e-5 and r0["grad_err"] <= 1e-5
            and len({m["loss"] for m in e}) == 1):
        raise AssertionError(f"cluster (e): {r0}")
    log(f"cluster spawn A parts s: "
        f"{ {k: round(a[0][k + '_s'], 2) for k in 'abce'} }; launches a "
        f"member {[m['launches'] for m in a]}")
    one, one_s, one_counts = _fleet_sweep_once(dev)
    took("(f) the one-process sweep")
    torch.cuda.empty_cache()
    b = members.spawn(_members_two, 2, (dev.type,), threads=4)
    took("spawn B (2 members)")
    _check_trainer(b, "c", CLUSTER_TRAIN_TWO)
    d = [m["d"] for m in b]
    for r, m in enumerate(d):
        log(f"cluster (d) gemma-2b at its published widths, depth 18 -> "
            f"{GEMMA_WIDE_DEPTH}, float32, pssgd int8 + EF on (data 2), "
            f"global batch ({GEMMA_WIDE_B}, {GEMMA_WIDE_SEQ}), member {r}: D "
            f"= {m['d']}; init (in turns) {m['init_s']:.3f} s; s a step "
            f"{[round(x, 4) for x in m['step_s']]} (CUDA events "
            f"{[round(x, 4) for x in m['event_s']]}); peak GB "
            f"{[round(x / 1e9, 3) for x in m['peak']]} (step-only, less the "
            f"{m['base']} B held before the init: "
            f"{[x - m['base'] for x in m['peak']]} B); state and batch held "
            f"{m['held']} B; wire bytes a step "
            f"{m['wire']}; loss {m['loss']}; EF identity worst share of the "
            f"float32 bound {[round(x, 4) for x in m['ef_worst']]} on {smi}")
    MEASURED["cluster_d"] = d
    same = [d[0]["digests"][i] == d[1]["digests"][i]
            for i in range(GEMMA_WIDE_STEPS)]
    log(f"cluster (d) members' params bitwise alike after each step: {same}")
    if not (all(same) and all(x <= 1.0 for m in d for x in m["ef_worst"])
            and all(np.isfinite(m["loss"]).all() for m in d)):
        raise AssertionError(f"cluster (d): {same} {d[0]['ef_worst']}")
    f = [m["f"] for m in b]
    for key, logs in one.items():
        for m in f:
            for fld in rt._LOG_FIELDS:
                if not np.array_equal(m["logs"][key][fld],
                                      getattr(logs, fld)):
                    raise AssertionError(f"cluster (f) {key} {fld}: the "
                                         "members' sweep differs")
    per = [m["launches"]["topk_rows"] for m in f]
    log(f"cluster (f) the fleet config's top-k sweep ({len(FLEET_POLICIES)} "
        f"policies x {len(FLEET_SEEDS)} seeds x {FLEET_SWEEP_ROUNDS} rounds, "
        f"N={FLEET['n_devices']}) over 2 members: bitwise the one-process "
        f"sweep; topk_rows launches a member {per} (one process "
        f"{one_counts['topk_rows']}); {max(m['secs'] for m in f):.3f} s "
        f"(one process {one_s:.3f} s)")
    if sum(per) != one_counts["topk_rows"]:
        raise AssertionError(f"cluster (f): launches {per} vs {one_counts}")
    _check_tp(b, smi, "g", "gemma-2b", GEMMA_WIDE_DEPTH, 18)
    for name, arch, depth in TP_RECURRENT:
        _check_tp(b, smi, name, arch, depth,
                  {"falcon-mamba-7b": 64, "recurrentgemma-2b": 26}[arch])
    _check_fsdp(b, smi)
    _check_moe_serve(b, smi)
    parts = list("cdfg") + [name for name, *_ in TP_RECURRENT] + [
        "i", "i moe"]
    log(f"cluster spawn B parts s: "
        f"{ {k: round(b[0][k + '_s'], 2) for k in parts} }")
    total = dict.fromkeys(one_counts, 0)
    for m in a + b:
        for n, v in m["launches"].items():
            total[n] += v
        if any(m["launches"].values()):
            raise AssertionError(f"cluster: trainer, EP, ring or collectives "
                                 f"launched kernels {m['launches']}")
    for m in f:
        for n, v in m["launches"].items():
            total[n] += v
    log(f"cluster kernel launches summed over the members: {total}")
    return total


def _check_tp(b: list, smi: str, key: str, arch: str, depth: int,
              published: int) -> None:
    """(g), (h): the (1, 2) members against the (1, 1) run: losses, served
    tokens and logits, gathered params; the members' whole leaves bitwise
    alike; each member's figures, kept for phase 21."""
    g = [m[key] for m in b]
    one = g[0]["one"]
    for r, m in enumerate([one] + g):
        what = "one process (1, 1)" if r == 0 else f"member {r - 1} of (1, 2)"
        dec = m["serve"]["decode_ms"]
        log(f"cluster ({key}) {arch} at its published widths, depth "
            f"{published} -> {depth}, float32, pssgd none, global batch "
            f"({GEMMA_WIDE_B}, {GEMMA_WIDE_SEQ}), {what}: init "
            f"{m['init_s']:.3f} s; s a step "
            f"{[round(x, 4) for x in m['step_s']]} (CUDA events "
            f"{[round(x, 4) for x in m['event_s']]}); step-only peak B "
            f"{[x - m['base'] for x in m['peak']]} (peak GB "
            f"{[round(x / 1e9, 3) for x in m['peak']]}); state and batch "
            f"held {m['held']} B; wire bytes a step by kind {m['wire']}; "
            f"loss {m['loss']}; serve {TP_WIDE_PROMPT} + {TP_WIDE_GEN} "
            f"greedy steps: ms a decode step median "
            f"{float(np.median(dec)):.3f} (all {[round(x, 3) for x in dec]}) "
            f"on {smi}")
    loss_err = max(abs(a - c) / abs(c) for m in g
                   for a, c in zip(m["loss"], one["loss"]))
    tok_same, lg_err, gaps = _served_vs_one(g, one, "serve")
    alike = g[0]["digest"] == g[1]["digest"]
    log(f"cluster ({key}) (1, 2) against (1, 1): loss max rel diff "
        f"{loss_err:.3g} (limit {TP_WIDE_LOSS_RTOL}); gathered params "
        f"relative L2 {g[0]['params_err']:.3g} (limit {TP_WIDE_PARAMS_L2}); "
        f"greedy tokens equal {tok_same} (smallest top-2 logit gap a step "
        f"{min(gaps):.3g}); logits relative L2 max {lg_err:.3g} (limit "
        f"{TP_WIDE_LOGITS_L2}); members' whole leaves bitwise alike {alike} "
        f"(split over model: {len(g[0]['split'])} leaves)")
    MEASURED["cluster_" + key] = g
    if not (loss_err <= TP_WIDE_LOSS_RTOL
            and g[0]["params_err"] <= TP_WIDE_PARAMS_L2 and tok_same
            and lg_err <= TP_WIDE_LOGITS_L2 and alike
            and g[0]["loss"] == g[1]["loss"]
            and all(np.isfinite(m["loss"]).all() for m in g)):
        raise AssertionError(f"cluster ({key}): the (1, 2) run against "
                             f"(1, 1)")
    if "serve_ring" in one:
        _check_tp_ring(g, one, smi, key, arch)


def _served_vs_one(g: list, one: dict, serve: str) -> tuple:
    """The members' served tokens and logits of ``serve`` against one
    process's: (tokens equal, the largest relative L2 of a step's logits,
    one process's smallest top-2 logit gap a step)."""
    tok_same = all(torch.equal(torch.cat(m[serve]["tokens"], 1),
                               torch.cat(one[serve]["tokens"], 1))
                   for m in g)
    lg_err = max(float((a.double() - c.double()).norm() / c.double().norm())
                 for m in g for a, c in zip(m[serve]["logits"],
                                            one[serve]["logits"]))
    gaps = [float(torch.topk(c[:, -1], 2).values.diff(dim=-1).abs().min())
            for c in one[serve]["logits"]]
    return tok_same, lg_err, gaps


def _check_tp_ring(g: list, one: dict, smi: str, key: str, arch: str
                   ) -> None:
    """(g)'s serving into a ring of ``d_inner`` positions, split over
    model on (1, 2), against one process holding it whole: tokens equal,
    logits within (g)'s tolerance, a member's cache half of one
    process's."""
    tok_same, lg_err, gaps = _served_vs_one(g, one, "serve_ring")
    cache = [m["serve_ring"]["cache_bytes"] for m in g]
    whole = one["serve_ring"]["cache_bytes"]
    dec = [np.median(m["serve_ring"]["decode_ms"]) for m in [one] + g]
    log(f"cluster ({key}) {arch}: {TP_WIDE_PROMPT} prompt, "
        f"{TP_WIDE_GEN} greedy steps then {TP_WIDE_RING} past the end of a "
        f"ring of d_inner positions, the members' caches split over their "
        f"positions: greedy tokens equal {tok_same} (smallest top-2 logit "
        f"gap a step {min(gaps):.3g}); logits relative L2 max {lg_err:.3g} "
        f"(limit {TP_WIDE_LOGITS_L2}); cache B a member {cache} against one "
        f"process's {whole}; ms a decode step median (one process, "
        f"members) {[round(float(x), 3) for x in dec]} on {smi}")
    if not (tok_same and lg_err <= TP_WIDE_LOGITS_L2
            and all(2 * c == whole for c in cache)):
        raise AssertionError(f"cluster ({key}): the ring split over model "
                             f"against (1, 1)")


def _check_fsdp(b: list, smi: str) -> None:
    """(i)(1): the (data 2) members against the (1, 1) run: losses and
    gathered params; both members' gathered params bitwise alike; each
    member's figures, kept for phase 21."""
    g = [m["i"] for m in b]
    one = g[0]["one"]
    for r, m in enumerate([one] + g):
        what = "one process (1, 1)" if r == 0 else f"member {r - 1} of (2, 1)"
        log(f"cluster (i) gemma-2b at its published widths, depth 18 -> "
            f"{GEMMA_WIDE_DEPTH}, float32, fsdp (bf16 moments, remat, a "
            f"layer gathered at a time), global batch ({GEMMA_WIDE_B}, "
            f"{GEMMA_WIDE_SEQ}), {what}: init {m['init_s']:.3f} s; s a step "
            f"{[round(x, 4) for x in m['step_s']]} (CUDA events "
            f"{[round(x, 4) for x in m['event_s']]}); step-only peak B "
            f"{[x - m['base'] for x in m['peak']]} (peak GB "
            f"{[round(x / 1e9, 3) for x in m['peak']]}); state and batch "
            f"held {m['held']} B; wire bytes a step by kind {m['wire']}; "
            f"loss {m['loss']} on {smi}")
    loss_err = max(abs(a - c) / abs(c) for m in g
                   for a, c in zip(m["loss"], one["loss"]))
    alike = g[0]["digest"] == g[1]["digest"]
    log(f"cluster (i) (data 2) against (1, 1): loss max rel diff "
        f"{loss_err:.3g} (limit {TP_WIDE_LOSS_RTOL}); gathered params "
        f"relative L2 {g[0]['params_err']:.3g} (limit {TP_WIDE_PARAMS_L2}); "
        f"members' gathered params bitwise alike {alike}")
    MEASURED["cluster_i"] = g
    if not (loss_err <= TP_WIDE_LOSS_RTOL
            and g[0]["params_err"] <= TP_WIDE_PARAMS_L2 and alike
            and g[0]["loss"] == g[1]["loss"]
            and all(np.isfinite(m["loss"]).all() for m in g)):
        raise AssertionError("cluster (i): the (2, 1) fsdp run against "
                             "(1, 1)")


def _check_moe_serve(b: list, smi: str) -> None:
    """(i)(2): the members' rows against one process over the whole
    batch: tokens equal, logits within SERVE_SPLIT_TOL, the drops equal
    and more than 0; against the members replayed in one process at their
    shapes: tokens, logits and drops bitwise equal."""
    r = [m["i moe"] for m in b]
    one, replay = r[0]["one"], r[0]["replay"]
    replayed = all(
        m["mesh"]["drops"] == p["drops"]
        and all(torch.equal(x, y) for key in ("tokens", "logits")
                for x, y in zip(m["mesh"][key], p[key]))
        for m, p in zip(r, replay))
    tokens = torch.cat([torch.cat(m["mesh"]["tokens"], 1) for m in r])
    same = torch.equal(tokens, torch.cat(one["tokens"], 1))
    worst = 0.0
    for i, want in enumerate(one["logits"]):
        got = torch.cat([m["mesh"]["logits"][i] for m in r])
        err = (got.double() - want.double()).abs() - SERVE_SPLIT_TOL[
            "rtol"] * want.double().abs()
        worst = max(worst, float(err.max()))
    drops = [m["mesh"]["drops"] for m in r]
    log(f"cluster (i moe) qwen2-moe-a2.7b at its published widths, "
        f"{MOE_SERVE_DEPTH} layers, float32, capacity factor {r[0]['cf']}: a "
        f"{TP_WIDE_PROMPT} prompt and {TP_WIDE_GEN} greedy steps on (data 2, "
        f"model 1), each member's rows routed as its part of the whole "
        f"batch, against one process: tokens equal {same}; logits' largest "
        f"|diff| - rtol |want| {worst:.3g} (atol {SERVE_SPLIT_TOL['atol']}); "
        f"choices dropped by the capacity a member {drops} (one process "
        f"{one['drops']}); s {[round(m['mesh_s'], 3) for m in r]} (one "
        f"process {r[0]['one_s']:.3f}) on {smi}")
    log(f"cluster (i moe) the members against their replay in one process "
        f"at their shapes: tokens, logits and drops bitwise equal "
        f"{replayed}; so the logits' drift from one process is its row "
        f"count: a float32 product's first rows over a member's rows "
        f"against over the whole batch's, largest |diff| {r[0]['drift']}")
    if not (same and worst <= SERVE_SPLIT_TOL["atol"] and replayed
            and sum(drops) == one["drops"] > 0):
        raise AssertionError("cluster (i moe): the members' serving against "
                             "one process")


def _dryrun_records(out_dir: str) -> dict:
    """{(arch, shape, mesh, policy): record} of the dry-run's records in
    ``out_dir``."""
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"], r["policy"])] = r
    return recs


def _dryrun_record(recs: dict, arch: str, shape: str, mesh: str,
                   policy: str = "") -> dict:
    """The one record of (arch, shape, mesh) whose policy starts with
    ``policy``."""
    (r,) = [r for k, r in recs.items()
            if k[:3] == (arch, shape, mesh) and k[3].startswith(policy)]
    return r


DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")


def start_dryrun(dev, names=None) -> None:
    """Start the dry-run's CLI in a subprocess for each of DRYRUN_CASES
    (those in ``names``; every one not started yet by default), fake
    tensors on the card's device; ``run_dryrun`` waits for them."""
    import shutil
    if not DRYRUN_PROCS:
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
        os.makedirs(DRYRUN_DIR)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    # the traces take the host's spare cores: the phases they run beside
    # keep theirs
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    for name, argv, _ in DRYRUN_CASES:
        if name in DRYRUN_PROCS or (names is not None and name not in names):
            continue
        logf = open(os.path.join(DRYRUN_DIR,
                                 f"{name.replace(' ', '_')}.log"), "w")
        DRYRUN_PROCS[name] = (subprocess.Popen(
            nice + [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                    "--device", dev.type, "--out", DRYRUN_DIR], cwd=ROOT,
            env=env, stdout=logf, stderr=subprocess.STDOUT), logf)


def _traces_running() -> list:
    """The dry-run cases whose subprocess is still running."""
    return [n for n, (p, _) in DRYRUN_PROCS.items() if p.poll() is None]


def stop_dryrun() -> None:
    """Kill any dry-run subprocess still running."""
    for p, logf in DRYRUN_PROCS.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()
    DRYRUN_PROCS.clear()


def run_dryrun(dev, smi: str) -> dict:
    """Phase 21: the dry-run's CLI in subprocesses, fake tensors on the
    card's device (started before phases 17 and 20), held against
    phase 17(b)'s trainer and phase 20(d)'s, 20(g)'s, 20(h)'s and 20(i)'s
    members as this run measured them (a, b, g, h, i) and a sample of its
    table on the production meshes (c). Returns each kernel's launches
    summed over the dry-run's cases, each counted in the process that ran
    it (all 0)."""
    out_dir = DRYRUN_DIR
    start_dryrun(dev)
    rcs = {}
    try:
        for name, (p, logf) in DRYRUN_PROCS.items():
            rcs[name] = p.wait(timeout=600)
    finally:
        stop_dryrun()
    for name, argv, want in DRYRUN_CASES:
        with open(os.path.join(out_dir, f"{name.replace(' ', '_')}.log")) as f:
            text = f.read()
        log(f"dryrun ({name}) {' '.join(argv)}: exit {rcs[name]}; "
            + " | ".join(text.strip().splitlines()[-6:]))
        if rcs[name] != want:
            raise AssertionError(f"dryrun ({name}): exit {rcs[name]}, want "
                                 f"{want}: {text[-3000:]}")
    recs = _dryrun_records(out_dir)
    total = dict.fromkeys(KERNELS, 0)
    for r in recs.values():
        for n, v in r["kernel_launches"].items():
            total[n] += v

    def wire(r):
        return int(sum(v["bytes"] for v in r["collectives"].values()))

    # (a) phase 17(b)'s case on one member
    ra = _dryrun_record(recs, "gemma-2b", "train_8x128", "1x1")
    tb = MEASURED["trainer_b"]
    mem = ra["memory"]
    share = mem["peak_bytes"] / tb["step_peak"] - 1.0
    rate = ra["cost"]["flops"] / tb["step_s"]
    log(f"dryrun (a) gemma-2b float32, int8 + EF, (8, 128), one member: "
        f"argument bytes {mem['argument_bytes']} (the card held "
        f"{tb['held']}); peak {mem['peak_bytes']} B against the card's "
        f"step-only peak {tb['step_peak']} B ({share:+.4f}); flops "
        f"{ra['cost']['flops']:.6e} a step, {rate / 1e12:.3f} TFLOP/s at "
        f"phase 17(b)'s {tb['step_s']:.4f} s a step "
        f"({rate / FP32_OPS_PER_S:.4f} of 67 TFLOP/s float32); traced in "
        f"{ra['trace_s']} s, {ra['ops']} "
        f"ops, on {smi}")
    if not (mem["argument_bytes"] == tb["held"]
            and abs(share) <= DRYRUN_PEAK_RTOL):
        raise AssertionError(f"dryrun (a): {mem} vs {tb}")

    # (b) phase 20(d)'s case, member 0 of (data 2)
    wide = f"train_{GEMMA_WIDE_B}x{GEMMA_WIDE_SEQ}"
    rb = _dryrun_record(recs, "gemma-2b", wide, "2x1", "int8_ef")
    members = MEASURED["cluster_d"]
    mem = rb["memory"]
    log(f"dryrun (b) gemma-2b depth {GEMMA_WIDE_DEPTH}, float32, int8 + EF "
        f"on (data 2): wire bytes a member a step {wire(rb)} "
        f"{ {k: int(v['bytes']) for k, v in rb['collectives'].items()} } "
        f"(phase 20(d) measured {[m['wire'] for m in members]}); argument "
        f"bytes {mem['argument_bytes']} (held {[m['held'] for m in members]}"
        f"); peak {mem['peak_bytes']} B against the members' step-only peaks "
        f"{[[x - m['base'] for x in m['peak']] for m in members]} B; flops "
        f"{rb['cost']['flops']:.6e}; traced in {rb['trace_s']} s")
    for m in members:
        peaks = [x - m["base"] for x in m["peak"]]
        if not (all(w == wire(rb) for w in m["wire"])
                and all(h == mem["argument_bytes"] for h in m["held"])
                and abs(mem["peak_bytes"] / max(peaks) - 1.0)
                <= DRYRUN_PEAK_RTOL):
            raise AssertionError(f"dryrun (b): {mem}, {wire(rb)} vs "
                                 f"{m['wire']} {m['held']} {peaks}")

    # (b moe) phase 20(c)'s expert stacks split over model, plain mean
    rm = _dryrun_record(recs, "qwen2-moe-a2.7b",
                        f"train_{CLUSTER_B}x{CLUSTER_SEQ}", "2x2")
    got = MEASURED["cluster_moe"]
    log(f"dryrun (b moe) qwen2-moe-a2.7b --reduced, pssgd none, no remat, "
        f"on (data 2, model 2): wire bytes a member a step {wire(rm)} "
        f"{ {k: int(v['bytes']) for k, v in rm['collectives'].items()} } "
        f"x {CLUSTER_STEPS} steps = {CLUSTER_STEPS * wire(rm)} (phase 20(c) "
        f"measured {got} on the card); traced in {rm['trace_s']} s")
    if not all(w == CLUSTER_STEPS * wire(rm) for w in got):
        raise AssertionError(f"dryrun (b moe): {wire(rm)} vs {got}")

    # (g), (h) phase 20(g)'s and 20(h)'s cases, each member of (data 1,
    # model 2)
    for key, arch, depth in (("g", "gemma-2b", GEMMA_WIDE_DEPTH),
                             ) + TP_RECURRENT:
        rg = _dryrun_record(recs, arch, wide, "1x2")
        members = MEASURED["cluster_" + key]
        mem = rg["memory"]
        kinds = {k: int(v["bytes"]) for k, v in rg["collectives"].items()}
        peaks = [[x - m["base"] for x in m["peak"]] for m in members]
        log(f"dryrun ({key}) {arch} depth {depth}, float32, pssgd none on "
            f"(data 1, model 2): wire bytes a member a step by kind {kinds} "
            f"(phase 20({key[0]}) measured {[m['wire'] for m in members]}); "
            f"argument bytes {mem['argument_bytes']} (held "
            f"{[m['held'] for m in members]}); peak {mem['peak_bytes']} B "
            f"against the members' step-only peaks {peaks} B "
            f"({[round(mem['peak_bytes'] / max(pk) - 1.0, 4) for pk in peaks]}"
            f"); flops {rg['cost']['flops']:.6e}; traced in {rg['trace_s']} "
            f"s")
        for m, pk in zip(members, peaks):
            if not (all(w == kinds for w in m["wire"])
                    and all(h == mem["argument_bytes"] for h in m["held"])
                    and abs(mem["peak_bytes"] / max(pk) - 1.0)
                    <= DRYRUN_PEAK_RTOL):
                raise AssertionError(f"dryrun ({key}): {mem}, {kinds} vs "
                                     f"{m['wire']} {m['held']} {pk}")

    # (i) phase 20(i)(1)'s case, each member of (data 2)
    ri = _dryrun_record(recs, "gemma-2b", wide, "2x1", "fsdp")
    members = MEASURED["cluster_i"]
    mem = ri["memory"]
    kinds = {k: int(v["bytes"]) for k, v in ri["collectives"].items()}
    peaks = [[x - m["base"] for x in m["peak"]] for m in members]
    log(f"dryrun (i) gemma-2b depth {GEMMA_WIDE_DEPTH}, float32, fsdp on "
        f"(data 2), a layer gathered at a time: wire bytes a member a step "
        f"by kind {kinds} (phase 20(i) measured "
        f"{[m['wire'] for m in members]}); argument bytes "
        f"{mem['argument_bytes']} (held {[m['held'] for m in members]}); "
        f"peak {mem['peak_bytes']} B against the members' step-only peaks "
        f"{peaks} B "
        f"({[round(mem['peak_bytes'] / max(pk) - 1.0, 4) for pk in peaks]}"
        f"); flops {ri['cost']['flops']:.6e}; traced in {ri['trace_s']} s")
    for m, pk in zip(members, peaks):
        if not (all(w == kinds for w in m["wire"])
                and all(h == mem["argument_bytes"] for h in m["held"])
                and abs(mem["peak_bytes"] / max(pk) - 1.0)
                <= DRYRUN_PEAK_RTOL):
            raise AssertionError(f"dryrun (i): {mem}, {kinds} vs "
                                 f"{m['wire']} {m['held']} {pk}")

    # (c) a sample of the table
    rl = _dryrun_record(recs, "llama3-405b", "train_4k", "256x1")
    log(f"dryrun (c) llama3-405b train_4k on 256x1 ({rl['policy']}): peak "
        f"{rl['memory']['peak_bytes'] / 1e9:.3f} GB a member, against "
        f"{LLAMA_PARENT_PEAK_GB} GB with every leaf gathered for the step "
        f"and ~{LLAMA_PREDICTED_GB} GB predicted (PERF.md); limit "
        f"{LLAMA_PEAK_LIMIT_GB} GB")
    if not rl["memory"]["peak_bytes"] <= LLAMA_PEAK_LIMIT_GB * 1e9:
        raise AssertionError("dryrun (c): llama3-405b's peak on 256x1")
    sample = [_dryrun_record(recs, "gemma-2b", "train_4k", "256x1"), rl] + [
        _dryrun_record(recs, a, "train_4k", "16x16") for a in (
            "gemma-2b", "falcon-mamba-7b", "recurrentgemma-2b")] + [
        _dryrun_record(recs, "qwen2-moe-a2.7b", s, "16x16") for s in
        ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    for r in sample:
        log(f"dryrun (c) {r['arch']} {r['shape']} on {r['mesh']}: "
            f"{r['status']}; argument {r['memory']['argument_bytes']} B, "
            f"peak {r['memory']['peak_bytes']} B, flops "
            f"{r['cost']['flops']:.6e}, wire {wire(r)} B "
            f"{ {k: int(v['bytes']) for k, v in r['collectives'].items()} }, "
            f"traced in {r['trace_s']} s, {r['ops']} ops")
    if not all(r["status"] == "ok" for r in sample):
        raise AssertionError("dryrun (c): the table's sample")
    for arch, shape, whole in DRYRUN_SEQ_SPLIT:
        r = _dryrun_record(recs, arch, shape, "16x16")
        held, block = _seq_split_cache(arch, shape, r)
        log(f"dryrun (c) {arch} {shape} on 16x16: {r['status']}; a member's "
            f"decode cache {held} B (the arguments less its params and "
            f"token blocks), the reference's block {block} B, held whole "
            f"over model before {whole} B; argument {r['memory']['argument_bytes']} B, peak "
            f"{r['memory']['peak_bytes']} B, wire {wire(r)} B "
            f"{ {k: int(v['bytes']) for k, v in r['collectives'].items()} }, "
            f"traced in {r['trace_s']} s")
        if not (r["status"] == "ok" and held == block < whole):
            raise AssertionError(f"dryrun (c): {arch} {shape}'s cache")
    log(f"dryrun kernel launches summed over the {len(recs)} cases' "
        f"records: {total}")
    if any(total.values()):
        raise AssertionError("dryrun: kernels launched " + str(
            {k: r["kernel_launches"] for k, r in recs.items()}))
    return total


def _seq_split_cache(arch: str, shape: str, rec: dict) -> tuple:
    """(a member's decode-cache bytes in the dry-run's record ``rec``: its
    argument bytes less the member's blocks of the params and the token;
    the bytes of the reference's block of the cache under its cache rule),
    on (16, 16)."""
    import math
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import sharding as shard_rules
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import policy_from_name
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    cfg, shp = get_config(arch), SHAPES[shape]
    glob, sp, held = specs.case_specs(cfg, shp, mesh,
                                      policy_from_name(rec["policy"]))
    sizes = []

    def add(x, spec):
        if torch.is_tensor(x):
            sizes.append(math.prod(shard_rules.shard_shape(
                x.shape, spec, mesh)) * x.element_size())
    specs.tree_map(add, glob[1], sp[1])
    block = sum(sizes)
    sizes.clear()
    specs.tree_map(add, (glob[0], glob[2]), (held[0], held[2]))
    return rec["memory"]["argument_bytes"] - sum(sizes), block


def _check_trainer(res: list, key: str, cases) -> None:
    """(c): each case card == CPU within TRAINER_RTOL, and the members'
    replicated params bitwise alike."""
    for what, arch, mode, comp, shape, axes in cases:
        rows = [m[key][what] for m in res]
        r0 = rows[0]
        alike = mode == "fsdp" or all(r["digest"] == r0["digest"]
                                      for r in rows)
        log(f"cluster (c) {arch} --reduced {what}: loss "
            f"{np.round(r0['loss'], 6).tolist()}; card vs cpu rel diff by "
            f"step max {max(r['rel'] for r in rows):.3g}, params relative "
            f"L2 {max(r['p_err'] for r in rows):.3g}; members' replicated "
            f"params bitwise alike {alike}; bytes at rest a member "
            f"{[r['held'] for r in rows]} of {r0['whole']} (params and "
            f"moments whole); wire bytes a member over the run "
            f"{[r['wire'] for r in rows]}; {max(r['secs'] for r in rows):.3f}"
            f" s")
        if not (alike and all(r["rel"] <= TRAINER_RTOL
                              and r["p_err"] <= TRAINER_RTOL for r in rows)):
            raise AssertionError(f"cluster (c) {what}: {rows}")


def run_examples(dev, smi: str) -> dict:
    """Phase 22: the walk-through examples as a user starts them (``python
    -m repro_torch.examples.<name>``: their ``main``) at their own
    constants, those that no earlier phase runs whole. Every kernel counter
    is set to 0 before each example and read after it; none of these paths
    reaches a kernel. Returns each kernel's launches across the phase."""
    from repro_torch.examples import fog_hybrid as fh
    from repro_torch.examples import hierarchical_fl as hfl
    from repro_torch.examples import private_fl as pf
    from repro_torch.examples import wireless_scheduling_sim as wss
    zero, read, total = _counting(dict(_row_counters(), **_tile_counters()))

    def launched(what):
        got = read()
        if any(got.values()):
            raise AssertionError(f"examples {what}: launches {got}")
        return got

    def beside(fn):
        """``fn()``, its seconds, and the dry-run traces running at its
        start and end (a time taken beside them shares the host)."""
        before = _traces_running()
        res, secs = wall_s(fn)
        return res, secs, (f"beside dry-run traces {before} at the start, "
                           f"{_traces_running()} at the end")

    # (a) the scheduling study whole on the card; its first rounds against
    # the same module on the CPU
    log(f"examples (a) wireless_scheduling_sim on the card, {wss.ROUNDS} "
        "rounds:")
    zero()
    sweep, secs, load = beside(lambda: wss.main([], device=dev))
    got = launched("(a)")
    rounds, r = wss.ROUNDS, STUDY_CHECK_ROUNDS
    log(f"examples (a) wireless_scheduling_sim on the cpu, {r} rounds:")
    wss.ROUNDS = r
    try:
        t0 = time.perf_counter()
        cpu = wss.main([], device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        wss.ROUNDS = rounds
    rel = 0.0
    for pol, c in cpu.items():
        g = sweep[pol]
        if not (g.loss.shape == (1, rounds) and np.isfinite(g.loss).all()):
            raise AssertionError(f"examples (a) {pol}: loss {g.loss}")
        for f in ("participation", "n_scheduled"):
            np.testing.assert_array_equal(getattr(g, f)[:, :r],
                                          getattr(c, f),
                                          err_msg=f"examples (a) {pol} {f}")
        np.testing.assert_allclose(g.latency_s[:, :r], c.latency_s,
                                   rtol=1e-5, err_msg=f"examples (a) {pol}")
        np.testing.assert_allclose(g.loss[:, :r], c.loss, rtol=1e-4,
                                   err_msg=f"examples (a) {pol}")
        rel = max(rel, float(np.max(np.abs(g.loss[:, :r] / c.loss - 1))))
    vr = len(sweep) * rounds
    log(f"examples (a) wireless_scheduling_sim: {len(sweep)} policies x "
        f"{rounds} rounds in {secs:.3f} s on {smi}, "
        f"{secs / vr * 1e3:.3f} ms a variant-round; its first {r} rounds == "
        f"the cpu's (participation, schedule sizes bitwise; wall clock "
        f"within rtol 1e-5; loss max rel diff {rel:.3g}); the cpu's {r} "
        f"rounds in {cpu_s:.3f} s; launches {got}; {load}")

    # (b) hierarchical_fl: flat FL, then HFL at each H, a fresh problem each
    zero()
    out, secs, load = beside(lambda: hfl.main([], device=dev))
    got = launched("(b)")
    for key, logs in out.items():
        losses = [lg.loss for lg in logs]
        if len(logs) != hfl.ROUNDS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"examples (b) {key}: {losses}")
        log(f"examples (b) hierarchical_fl {key}: final loss "
            f"{losses[-1]:.6f}, simulated wall clock "
            f"{logs[-1].latency_s:.3f} s")
    log(f"examples (b) hierarchical_fl: {len(out)} runs x {hfl.ROUNDS} "
        f"rounds in {secs:.3f} s on {smi}; launches {got}; {load}")

    # (c) private_fl: the three mechanisms, then the dp sweep
    zero()
    out, secs, load = beside(lambda: pf.main([], device=dev))
    got = launched("(c)")
    for key, logs in out.items():
        loss = (logs.loss[:, -1] if key == "dp"
                else np.array([logs[-1].loss]))
        if not np.isfinite(loss).all():
            raise AssertionError(f"examples (c) {key}: loss {loss}")
    log(f"examples (c) private_fl: 3 runs and a {len(pf.SIGMAS)}-variant "
        f"sweep x {pf.ROUNDS} rounds in {secs:.3f} s on {smi}; final loss "
        f"{[out[k][-1].loss for k in ('none', 'secagg', 'secagg_dp')]}, dp "
        f"{out['dp'].loss[:, -1].tolist()}, epsilon "
        f"{out['dp'].epsilon[:, -1].tolist()}; launches {got}; {load}")

    # (d) fog_hybrid: k = 1, 2, 4 on one problem (phase 14(c) runs each k
    # on a fresh one)
    zero()
    out, secs, load = beside(lambda: fh.main([], device=dev))
    got = launched("(d)")
    for k, logs in out.items():
        if not np.isfinite(logs.loss).all():
            raise AssertionError(f"examples (d) k={k}: loss {logs.loss}")
    log(f"examples (d) fog_hybrid: k = {list(out)} x {fh.ROUNDS} rounds in "
        f"{secs:.3f} s on {smi}; final loss "
        f"{[float(v.loss[-1]) for v in out.values()]}; launches {got}; "
        f"{load}")
    return total


def main() -> int:
    t0 = time.perf_counter()
    smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = {}
    phases = [("build", build),
              ("row kernels", lambda: check_kernels(dev, table)),
              ("tile kernels", lambda: (check_tile_kernels(dev, table),
                                        check_topk_adversarial(dev))),
              ("api", lambda: run_api(dev)),
              ("reference", lambda: check_against_cpu(dev)),
              ("engine", lambda: run_engine(dev, smi)),
              ("algorithms", lambda: run_algorithms(dev, smi)),
              ("faults", lambda: run_faults(dev, smi, out["engine"][1])),
              ("privacy", lambda: run_privacy(dev, smi)),
              ("sweep", lambda: run_sweep(dev, smi, out["engine"][1])),
              ("host", lambda: run_host(dev, smi, out["engine"][1])),
              ("hfl", lambda: run_hfl(dev, smi)),
              ("gossip", lambda: run_gossip(dev, smi)),
              ("lm", lambda: run_lm(dev, smi)),
              ("families", lambda: run_families(dev, smi)),
              ("dryrun start", lambda: start_dryrun(dev, DRYRUN_EARLY)),
              ("trainer", lambda: run_trainer(dev, smi)),
              ("serve", lambda: run_serve(dev, smi)),
              ("leaf", lambda: run_leaf(dev, smi)),
              ("dryrun start rest", lambda: start_dryrun(dev)),
              ("cluster", lambda: run_cluster_phase(dev, smi)),
              # host-bound, beside the dry-run's last traces
              ("examples", lambda: run_examples(dev, smi)),
              ("dryrun", lambda: run_dryrun(dev, smi))]
    out = {}
    log(f"phase card: {time.perf_counter() - t0:.2f} s")
    try:
        for name, fn in phases:
            t = time.perf_counter()
            out[name] = fn()
            log(f"phase {name}: {time.perf_counter() - t:.2f} s")
    finally:
        stop_dryrun()
    log("kernels: no single PyTorch call computes any of the six "
        "functions, so library_ms is null")
    launches = dict(out["api"], **out["engine"][0])
    rows = []
    for name, (replaces, source, *_rest) in KERNELS.items():
        r = table[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "sweep_launches": out["sweep"][name],
                     "hfl_launches": out["hfl"][name],
                     "gossip_launches": out["gossip"][name],
                     "lm_launches": out["lm"][0][name],
                     "families_launches": out["families"][0][name],
                     "trainer_launches": out["trainer"][name],
                     "serve_launches": out["serve"][name],
                     "leaf_launches": out["leaf"][name],
                     "cluster_launches": out["cluster"][name],
                     "dryrun_launches": out["dryrun"][name],
                     "examples_launches": out["examples"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    rows[list(KERNELS).index("topk_rows")]["lm_row"] = out["lm"][1]
    rows[list(KERNELS).index("topk_rows")]["mamba_row"] = out["families"][1]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
