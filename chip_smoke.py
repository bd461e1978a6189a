#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from a checkout of the repository, on a machine with one NVIDIA H100.
It exits non-zero, and prints no result, when no GPU is present or the
package is missing.  Phases, any failure of which fails the run:

1. device: the card's name and power limit, the versions, and the kernels'
   build (one ``nvcc`` per source, all at once, and a link into
   ``build/``) with its time and the compiler's register report (every
   instance of the fp32 flash kernel with 0 spill bytes), and the
   tensor-core instructions (``HMMA``) that ``cuobjdump -sass`` finds in
   the flash kernels (every bf16 instance must have some, every fp32
   instance TF32 ones);
2. kernels: each single-RHS kernel (``fused_dots``, ``fused_axpy``,
   ``spmv_ell``, ``fused_dots_health``) against its plain PyTorch version
   on the card, in fp64 and fp32, at the main path's shape (n = 108**3 =
   1,259,712 rows, k = 7), with its device time beside the plain version's,
   one PyTorch library call's where there is one, and the HBM bound;
2b. batched kernels: the same for ``fused_dots_batched``,
   ``fused_axpy_batched`` (fed a mask with frozen columns whose
   coefficients are NaN: their outputs must be their inputs, bit for bit),
   ``spmv_ell_batched`` and ``fused_dots_health_batched`` (whose probe row
   must be non-finite in exactly the columns fed a NaN or an Inf) at
   (1,259,712, 8), the width the JAX package's service binds; then each
   dots kernel, single and batched, timed on one column (m = 1);
2c. preconditioner kernels: the block-Jacobi set-up on the main path's ELL
   operator (timed: n / 64 = 19,683 blocks of 64 x 64), then
   ``block_jacobi_apply`` on (n,) and ``block_jacobi_apply_batched`` on
   (n, 8) with its blocks, against their plain versions in fp64 and fp32,
   each repeated and required bitwise equal, timed beside the plain
   version, one ``torch.bmm`` and the HBM bound, with the TB/s, the ratio
   to ``bmm`` and the batched kernel's route (it must be "bulk": the
   persistent bulk-copy kernel);
3. main path: p-BiCGSafe and p-BiCGSafe-rr through
   ``repro_torch.make_solver(...).solve(b)`` on ``substrate="cuda"`` for
   the 1,259,712-row convection-diffusion system in ELL form, fp64,
   tol 1e-8: convergence, true residual, solution error, wall time, and
   the kernels' launch counters held against the steps the solver ran;
3c. batched path: ``solve_many`` of an (n, 8) block on the same system
   (column 0 is b, the others seeded normal vectors; tol 1e-8 for four
   columns, 1e-6 for four): every column converges with a true residual
   within 100x its tol, column 0 within 2 iterations of 3's solve of b,
   and the batched kernels' launch counters match the steps;
3d. guarded path: ``make_solver(..., recovery=RecoveryPolicy(chunk=16))``
   on the same system: ``solve_many`` of 3c's block (every column
   CONVERGED, no recovery event, iterations within 2 of 3c's, one
   ``fused_dots_health_batched`` launch per step and no
   ``fused_dots_batched``), the same with a NaN written into column 2
   before chunk 1 (one restart of column 2, every column converges), and
   ``solve(b)`` (m = 1, the single-vector health kernel; within 2
   iterations of 3's solve of b);
3e. preconditioned path: ``make_solver(..., precond=...)`` on the same
   system, fp64, tol 1e-8: ``solve(b)`` with block_jacobi for both methods,
   ``solve_many`` of 3c's block with block_jacobi (its step's device time
   back to back beside 3c's), and ``solve(b)`` with jacobi and with
   neumann (degree 2) on the ELL form and with ssor on the Stencil7 form:
   every run converged with the preconditioned system's true residual
   within 100x its tol, the original system's residual printed, and the
   launch counters held to the steps (block-Jacobi applies = SpMVs + 1;
   neumann adds 2 SpMVs per apply);
3f. the paper's comparison: the seven methods of ``SOLVERS``
   (p-BiCGSafe, -rr, ssBiCGSafe2, p-BiCGStab, BiCGStab, GPBi-CG, CGS)
   through ``make_solver(m, ell, substrate="cuda").solve(b)`` on the same
   system, fp64, tol 1e-8, maxiter 2,000: each converges with a true
   relres within 1e-6, except CGS, which must end as the JAX package's
   does on this system (MAXITER at 2,000, no breakdown: its residual
   grows), ssBiCGSafe2 within 2 iterations of p-BiCGSafe, and
   the launch counters match the steps queued (``method_launches``: the
   fused dots once a step in ssBiCGSafe2, two SpMVs a step everywhere,
   plus two at p-BiCGStab's set-up); then p-BiCGStab with 2c's
   block-Jacobi preconditioner (applies = SpMVs + 1).  Each prints its
   iterations, steps queued, reductions per iteration, true relres,
   max|x - 1|, time to solution and per iteration;
   then, after every timed phase, the kernels the card runs per step of
   3c, 3d and 3e's batched solve and of each 3f solve, counted from
   ``torch.profiler`` traces;
3g. the distributed driver at world 1: a one-rank NCCL process group
   (``file://`` store under ``build/``) and its ``(1,)`` DeviceMesh; the
   Stencil7 form of the same system through ``make_solver(m, stencil,
   substrate="cuda").on_mesh(mesh)``, held to the same session's
   single-process solve: p-BiCGSafe bit for bit (x and iterations), true
   relres within 1e-6, ``fused_dots`` and ``fused_axpy`` once a step, one
   all-reduce started per step (the binding's ``SyncCounter``) and at most
   one NCCL kernel per step (profiled chunks of 16 and 32 steps), the graph
   run bit for bit the eager chunk's; the seven methods with their
   iterations, statuses and Table 3.1's all-reduces per step; ``solve_many``
   of 3c's block (tol 1e-8) and the same guarded, bit for bit, one (9, 8) /
   (11, 8) all-reduce per step; block-Jacobi bit for bit.  Printed: ms
   per iteration on the mesh and single-process, whether the chunks are
   graphs, and which kernels the NCCL kernel overlaps;
2d. flash attention: ``flash_attention`` against its plain version on the
   card at qwen3-8b's prefill shape (B, H, K, S, hd) = (4, 32, 8, 1024,
   128), causal, in bf16 (``flash_attention_mma.cu``) and fp32
   (``flash_attention.cu``, 3xTF32), both on the tensor cores, then
   llama4-scout's prefill shape (4, 40, 8, 1024, 128) in bf16 (G = 5: an
   odd grouping), phi3's (1, 32, 32, 1024, 96) full (non-causal), a
   ragged S = 1000 in both types, whisper-tiny's decoder prefill (4,
   6, 6, 432, 64) causal (head dim 64, G = 1) in both types, and
   qwen2-vl-72b's prefill (4, 64, 8, 1024, 128) causal (G = 8) in both
   types; a bitwise repeat; at qwen3's, llama4's, whisper's and qwen2-vl's
   shapes the kernel's device time beside the plain version's, one ``scaled_dot_product_attention``
   call's, the bound (fp32: three TF32 products at the tensor cores' TF32
   rate, and beside it the CUDA cores' bound) and an earlier run's time
   before the redesign;
4. serving path: ``ServingEngine`` on full-width qwen3-8b (36 layers,
   bf16, weights from a seeded generator on the card) with
   ``use_flash_kernel=True``: warmed on the prompts' first 256 tokens at
   the measured batch size (its decode graph captured then, the seconds
   printed), then 4 requests of 1,024-token prompts and 16 new tokens
   each, served twice: with the decode steps eager (``_eager_chunks``)
   and with each step one replay of the engine's decode graph (the main
   path; ``stats["decode_program"]`` must read ``"graph"`` and nothing be
   captured in the run); the two runs' greedy tokens identical; per run
   the launch counter (36 flash launches per prefill batch, no other
   kernel), the prefill time, the time per decode step (median, range),
   tokens per second and, from profiler traces, the kernels, device time
   and busy share of a decode step; the graph pool's and the cache's
   bytes; a replay under ``set_sync_debug_mode("error")`` must not
   synchronise; every token in the vocabulary, the last-position prefill
   logits finite and within a bf16 tolerance of the same engine's without
   the kernel (the plain single-block path), the kernel's share of the
   prefill, and the kernels and busy time of a prefill; then an
   fp32 prefill of the same prompts with the kernel (its launches counted
   on their own: 36 fp32 flash launches, no other kernel), its
   last-position logits within ``SERVE_LOGITS_TOL_F32`` of the fp32 plain
   prefill's, and the fp32 prefill's wall with and without the kernel; the
   bar's control, the plain fp32 prefill with its products in one TF32
   pass (``allow_tf32``), must miss it;
4b. the MoE family (run after 4, its model freed before 6):
   ``ServingEngine`` on llama4-scout-17b-a16e at full width (d 5,120, 40
   query and 8 KV heads, 16 experts top-1 and a shared one, d_ff 8,192,
   vocab 202,048), depth cut 48 -> 12 (28.5 G parameters, 57 GB of seeded
   bf16 weights; 48 layers are 215 GB), ``use_flash_kernel=True``, on
   phase 4's prompts (4 x 1,024 tokens, 16 new), warmed and served eager
   and graphed as in 4 (the same bars and readings): 12 flash launches per
   prefill batch and no other kernel, every token in the vocabulary; the
   experts each layer chose (forward hooks on each ``moe``) in a prefill
   with the kernel and one on the plain path agree on at least
   ``MOE_ROUTE_AGREE`` of (layer, token), and the last-position logits of
   each prompt whose last token chose alike in every layer (at least 3)
   within ``SERVE_LOGITS_TOL``; layer 0 on the prefill's 4,096 tokens:
   ``"gather"`` with the capacity factor raised to E (nothing drops)
   against ``"sort"`` within ``MOE_BF16_TOL``, the share the config's
   capacity drops, each dispatch's time; ``moe_ffn(impl="gather")`` at
   decode size and a whole ``decode_step`` with ``cache_len`` a device
   tensor free of host synchronisation
   (``torch.cuda.set_sync_debug_mode("error")``), and where the sort layer
   synchronises, printed; the init
   seconds, parameters, peak memory, prefill ms beside its products'
   bound, decode ms per step (median, range) beside the weight-read bound,
   tokens/s, the kernel's share of the prefill and, from profiler traces,
   the kernels and busy time per prefill and decode step;
4c. MLA and the grouped kernel (run after 4b, its model freed before 6):
   first one full-width MLA layer in fp32 with TF32 off, the absorbed
   decode of position 1,023 against the prefill's row within 1e-4 of its
   max-abs (``MLA_FP32_TOL``); then ``ServingEngine`` on deepseek-v3-671b
   at full width (d 7,168, 128 heads, q_lora 1,536, kv_lora 512, nope /
   rope / v 128 / 64 / 128, 256 experts top-8 and a shared one, d_ff
   2,048, vocab 129,280, the dropless sort dispatch), depth cut 61 -> 2 and
   the MTP block off (24.9 G parameters, 49.7 GB of seeded bf16), with
   ``grouped_mm`` against its plain version at the prefill's (32,768 rows)
   and a decode step's (32 rows) shapes with layer 0's ``wi`` and ``wo``,
   each routing with an empty group and one of one row (bf16 bar, bitwise
   repeats, the route ``grouped_mm.route`` names taken; device time, plain,
   bound and ``torch._grouped_mm``'s; each tile of the bf16 route
   (``csrc/grouped_mm_sm90.cu``), 128 x 256 and 192 x 192, launched by
   name, held to the same bars and timed in turns); phase 4's
   prompts warmed and served eager and
   graphed as in 4 (the same bars): 6 grouped launches a prefill and 6 a
   decode step, eager or replayed, and no other kernel; layer 0's MoE on
   the prefill's input, the sort dispatch with the kernel against the
   plain grouped product, and gather at capacity factor E against sort on
   64 of its tokens, within ``MOE_BF16_TOL``; the sort layer and a whole
   decode step free of host synchronisation; the parameters, bytes and
   peak memory, the prefill's ms and TFLOP (the head's apart), the decode
   step's wall eager and graphed, device time, busy share and tokens/s
   beside the weight-read bound of the experts that step hit;
4d. an fp32 sort config (run after 4c; ROADMAP C26): deepseek-v3 at full
   width in fp32 (TF32 off), depth cut 61 -> 1 and the MTP block off (53.4
   GB of seeded weights), with the sort dispatch served eager and graphed
   on 4 seeded prompts of 64 tokens (3 grouped launches a layer a
   prefill and a step, all on the "mma" route, the graphed tokens the
   eager ones), the prefill's last logits within 1e-4 of the same model's
   with the plain grouped product patched in (whose tokens agree too), a
   replay free of host syncs; then the f32 and f64 route at deepseek's
   full-width ``wi`` at 32,768 and 32 rows against their plain version
   (1e-5, 1e-12, bitwise repeats), timed beside their bound, the plain
   loop and ``torch._grouped_mm`` (f32), each of its tiles
   (``csrc/grouped_mm.cu``), 64 x 128 and 144 x 128, launched by name,
   held to the same bars and timed in turns;
4e. the hybrid family (run after 4d): ``ServingEngine`` on zamba2-1.2b at
   full width and depth (38 Mamba2 layers, the shared attention + SwiGLU
   block at every 6th, d 2,048, 64 SSM heads, a 4,096-token window;
   1,170,473,856 seeded bf16 parameters), max_len 4,608 (a 4,096-row ring
   per application of the shared block): warmed on 256-token prompts at B
   = 4 (its decode graph captured there, the rings not full), then 4
   prompts of 5,120 tokens (20 SSD chunks, 1,024 past the window) and 16
   new tokens served eager and graphed as in 4 (the same greedy tokens,
   nothing captured in the run), every step rolling the rings on the
   device; no kernel of the port launched (the window keeps the shared
   block off flash, as in the reference); a replay free of host syncs; the
   prefill's ms, device time and kernels beside its TFLOP, a step's
   (median, range) beside its bytes' bound with and without the roll,
   tokens/s, busy share, peak memory, cache and graph-pool bytes; then
   ``decode_step`` run eagerly over 15 greedy tokens (the engine's)
   against ``forward`` over the prompt and those tokens: in bf16 within
   0.15 of the logits' max-abs (5e-2 recorded) and no further from the
   fp32 forward on the same weights than twice the bf16 forward is; in
   fp32 at depth 7 (two rings) within 1e-3;
4f. the SSM family (run after 4e): ``ServingEngine`` on xlstm-350m at full
   width and depth (12 sLSTM + mLSTM pairs, d 1,024, 4 heads, vocab
   50,304; 442,283,104 seeded bf16 parameters), max_len 256, under the
   prompt (the decode state, 202.5 MB of f32 at B = 4, has no sequence
   axis, so no batch is refused): warmed on 256-token prompts at B = 4
   (its decode graph captured there), then 4 prompts of 1,024 tokens (four
   256-token mLSTM chunks) and 16 new tokens served eager and graphed as
   in 4 (the same greedy tokens, nothing captured in the run); no kernel
   of the port launched (the family runs none); a replay free of host
   syncs; the prefill's ms, device time and kernels beside its TFLOP, the
   sLSTM loop's part of it (its 12 blocks' span by CUDA events, its
   kernels from one block profiled alone), a step's (median, range)
   beside its bytes' bound (the weights but the embedding, the state read
   and written), tokens/s, busy share, peak memory, cache and graph-pool
   bytes; then ``decode_step`` run eagerly over 15 greedy tokens (the
   engine's) against ``forward`` over the prompt and those tokens (padded
   to the 256-token chunk): at full depth in bf16 no further from the fp32
   forward on the same weights than twice the bf16 forward is (its
   distance from the bf16 forward recorded beside 0.15 and 5e-2: bf16
   rounding decorrelates 24 layers), the same weights in fp32 (TF32 off)
   within 1e-3; at depth 4 (two pairs) bf16 within 0.15 and the same rule,
   fp32 within 1e-3;
4g. the audio family (run after 4f): ``ServingEngine`` on whisper-tiny at
   full width and depth (4 encoder and 4 decoder layers, d 384, 6 heads of
   64, vocab 51,865, the 32,768-row learned position table; 49,046,016
   seeded bf16 parameters) with ``use_flash_kernel=True``, max_len 448
   (whisper's decoder context): warmed at B = 4 on the measured prompts
   (its decode graph captured there), then 4 prompts of 432 tokens (the
   frames all-zero, as the JAX engine builds them) and 16 new tokens
   served eager and graphed as in 4 (the same greedy tokens, nothing
   captured in the run); exactly 4 flash launches a prefill (the decoder's
   causal self-attention; the encoder and the cross-attention stay plain,
   as in the reference) and none in a decode step; a replay free of host
   syncs; the prefill's last logits within 5e-2 of the same model's with
   ``use_flash_kernel=False`` (the argmax agreement printed); the
   prefill's ms, device time and kernels beside its FLOP, a step's
   (median, range) beside its bytes' bound, tokens/s, busy share, peak
   memory, cache and graph-pool bytes; then ``prefill_step`` through the
   entry points on seeded frames (4, 1,024, 384), the largest encoder both
   packages take (ROADMAP C30), and 15 eager ``decode_step``s, timed; then
   the same weights in fp32 (TF32 off) at B = 1, 15 teacher-forced
   ``decode_step``s on the card against the same steps on this machine's
   CPU: within 1e-4 of the logits' max-abs; the decode's distance from
   ``forward`` over the same tokens printed as C29's reading (the
   reference's decode rotates with RoPE, its prefill does not), not
   gated;
4h. the VLM family (run after 4g, every earlier model freed):
   ``ServingEngine`` on qwen2-vl-72b at full width (d 8,192, 64 query heads
   on 8 KV heads of 128, d_ff 29,568, vocab 152,064, QKV biases, M-RoPE
   sections (16, 24, 24)), depth cut 80 -> 32 (30,577,336,320 seeded bf16
   parameters, 61.15 GB) with ``use_flash_kernel=True``: warmed on the
   prompts' first 256 tokens at B = 4 (its decode graph captured there),
   then phase 4's 4 prompts of 1,024 tokens (text positions, t = h = w, as
   the JAX engine serves them) and 16 new tokens served eager and graphed
   as in 4 (the same greedy tokens, nothing captured in the run); exactly
   32 flash launches a prefill (G = 8) and none in a decode step; a replay
   free of host syncs; the prefill's last logits within 5e-2 of the plain
   branch's; the prefill's ms, device time and kernels beside its TFLOP, a
   step's (median, range) beside its bytes' bound (``vlm_decode_bytes``:
   the layers, the head and the K/V cache), tokens/s, busy share, the
   draw's and the phase's peak memory; then ``prefill_step`` through the
   entry point with an image (256 seeded patch rows at row 1, their (t, h,
   w) ids t fixed over a 16 x 16 grid, the text after them): 32 flash
   launches, the kernel's last logits within 5e-2 of the plain branch's,
   and how far the same tokens on text positions land (a reading); then
   ``apply_mrope`` with t = h = w against ``apply_rope`` on the card, bit
   for bit, in bf16 and f32;
5. the solve service (run before 4): ``repro_torch.service.SolveEngine``
   with ``ServiceConfig(max_batch=8, chunk=32, substrate="cuda", tol=1e-8,
   maxiter=2000)`` on 3a's system; a burst of 32 right-hand sides from
   ``--seed`` (numpy), queued at t = 0, tolerances alternating 1e-8 and
   1e-6, served warm three ways: sequentially (``session.solve(b,
   tol=...)``, one program for every tol: a third tol must leave one),
   in static FIFO batches of 8 (``solve_many``, the standalone reference)
   and by the engine; for each the throughput, p50 and p99 latency and the
   mean chunks resident, for the engine also the graph replays and host
   reads per chunk (1 and 1), the launches per step of the batched
   kernels (exact) and the device's busy share (a profiled run); every
   request CONVERGED with a true relres within 100x its tol and its
   iterations within 2 of its static column, the engine's ``x`` within
   1e-6 of it (relative); then the guarded engine
   (``RecoveryPolicy(max_retries=1)``) on 16 requests with column 0
   corrupted after the first chunk (the victim CONVERGED with one retry,
   the rest within 2 iterations of their unguarded counts, the health
   kernel on every step), a request with a 0.05 s deadline and tol 1e-14
   (DEADLINE), 8 requests on an operator registered with 2c's
   block-Jacobi (its batched apply launched), the session cache's bytes
   under its budget, and C16: six (n, 8) sessions of scaled copies of the
   operator under a budget of 2.2 sessions' bytes, after which the memory
   reserved must be under the budget plus one session;
3h. traces and profiles (run after 5 and C16, before 4), on 3a's system:
   p-BiCGSafe, -rr and ssBiCGSafe2 ``solve(b, trace=True)`` bitwise their
   untraced solves (x, iterations, relres, status) with the same launches,
   the trace's first row (0, 1.0), its iteration channel stepping by 1,
   its last row (iterations, relres, CONVERGED), ``steps`` = iterations +
   1, the relres channel bitwise a ``record_history`` solve's history, and
   ``trace=64`` the last 64 rows of the full trace; ms per iteration and
   kernels per step (profiled chunks) traced and untraced; 3c's block
   through ``solve_many(trace=True)`` and the guarded ``solve_many`` and
   ``solve(b)`` with ``SolverConfig(trace_cap=2000)``, each bitwise its
   untraced run, every column's trace from (0, 1.0) to its iterations; the
   traced
   Stencil7 solve at world 1 (one NCCL rank) bitwise the single-process
   traced solve, ring included, one all-reduce per step; ``solve(b,
   profile=...)`` and ``solve_many(B, profile=...)`` under
   ``build/observe/profile/``: device time > 0 in matvec, reduce and axpy,
   the reduce-phase kernels the fused dots' two per launch, the overlap
   efficiency, exposed time per iteration and unmapped ops printed, and
   the phase totals the name rules alone give on the same timeline; phase
   5's burst served with ``ServiceConfig(trace_cap=64)`` (1.00 replay and
   host read per chunk, every request CONVERGED with the iterations of 5's
   engine and its trace ending there, req/s against 5's), once more with
   ``trace_cap=2000`` (every request's whole residency: no row in a
   reused slot's column from before its admission chunk, each trace from
   (0, 1.0) to its iterations), then a profiled
   engine run (``profile_dir``); and ``python -m repro_torch.observe smoke``
   writing its four artifacts with their schemas;
3i. the contract analyzer (run after 3h, before 4): ``python -m
   repro_torch.analysis``'s full audit (``run_audit(quick=False,
   device="cuda")``: the 116 matrix cells and the 16 scenario rows of the
   registry traced in fake mode on the card, the rows' problems built on
   the card before the counters are zeroed) with the 5
   mesh cells on a one-rank NCCL mesh (3g's): no deviation, no kernel
   launched, every cell's statuses and the method x substrate matrix those
   of the committed CPU artifact (``experiments/torch_contract_audit
   .json``), the audit's wall time printed; then
   ``make_solver("p-bicgsafe", ell, substrate="cuda").verify_contracts()``
   on the full system for ``solve`` and ``solve_many``: every contract
   holds, ``kernel_backed`` with at least 4 kernel op nodes a step (dots,
   axpy, two SpMVs), no kernel launched.  The solver kernels are
   ``torch.library`` ops (``repro_torch::*``): every earlier phase's
   bitwise checks and launch counts hold through them, and 3b's graph and
   eager ms per iteration are printed beside PERF.md's;
3j. the scenario registry (run after 3i, before 4, from an empty session
   cache): (a) ``repro_torch.scenarios.run_sweep(quick=False,
   device="cuda")`` over the 17 seed scenarios (``poisson-mesh`` on a
   one-rank NCCL mesh, 3g's set-up): every cell converged,
   oracle-verified and contract-clean, within 2 iterations of the JAX
   package's committed ``experiments/scenario_sweep.json`` (read as JSON)
   and of the port's CPU ``experiments/torch_scenario_sweep.json``, the
   batched dots and update kernels once a step in the two "cuda" cells and
   no other launch; (b) three full-size scenarios registered with
   ``register_scenario`` and bound with ``make_solver(scenario=...)``:
   ``convdiff-108-cuda`` (3b's system in its Stencil7 form, one RHS),
   ``helmholtz-108-multirhs-cuda`` (the complex-shifted Helmholtz plugin
   at 108^3, 2,519,424 rows, an (n, 8) block) and ``random-1m-ell-rr-cuda``
   (1,259,712 random rows, 8 a row, ELL, p-BiCGSafe-rr): each converged and
   passing its plugin's oracle, its iterations, ms per iteration, first
   solve's wall and launches printed, a second bind the same session with
   no new capture; (c) ``SolveEngine.register_scenario("convdiff-108-cuda")``
   serving 8 seeded right-hand sides, each CONVERGED within 100x its tol.
   The problem memo and the session cache are cleared before 4;
6. training and the Newton-Krylov step (run after 4, with the session
   cache cleared): 6a ``repro_torch.train.train`` on phi3-mini-3.8b at full
   width (d 3,072, 32 heads, d_ff 8,192, vocab 32,064), depth cut to 4
   (650,013,696 parameters, bf16, f32 AdamW moments), 4 x 1,024 synthetic
   tokens a step, 8 steps, a checkpoint every 4 under ``build/train/``
   (deleted after), AdamW as the JAX launcher sets it: every step
   accepted, every loss finite, the last below the first, no kernel of the
   port launched (the plain attention branch, as the JAX trainer takes);
   ms per step, tokens/s, peak memory, the checkpoints' bytes and seconds
   and the device's busy share of one profiled step; then the same run
   with a failure injected at step 6 under ``run_with_restarts``: one
   restart, resumed from step 4, steps 4-7's losses within
   ``TRAIN_RESUME_RTOL`` of the uninterrupted run's; then 2 steps with
   8-bit moments (losses finite, peak memory).  6d: 6a's run (its model,
   data, seed and steps, one checkpoint at the last) through ``train(lm=)``
   on a one-rank NCCL (1, 1) ("data", "model") mesh: every parameter a
   DTensor placed as ``module_param_specs`` gives, each step's loss beside
   6a's and bitwise equal, ms a step against 6a's, the busy share of one
   profiled step, peak memory, no kernel launched, and the mesh's
   checkpoint restored by the plain trainer bit for bit.  6e: the dry
   run's cells (``repro_torch.launch``) on a one-rank NCCL (1, 1) mesh:
   the solver cell (``dryrun_solver``'s step at 108^3, fp64, "cuda")
   counted in fake mode and over 16 real steps after a warm one, FLOPs,
   bytes and collectives equal, one all-reduce an iteration, rows 1 and 2
   once a step, ms an eager iteration beside the bytes at 3.35 TB/s; the
   prefill cell (``dryrun.build_cell``'s qwen3-8b prefill, 4 x 1,024
   tokens, full width and depth, bf16, flash on) counted in fake mode and
   run for real, the counts equal, within 1% of the hand count, 36 flash
   launches, wall, TFLOP/s and share of 989, the fake peak within 0.5-2x
   the card's; 6d's step counted in fake mode (FLOPs, peak, MFU at 6d's
   ms a step); (d) deepseek-v3-671b's absorbed MLA decode (ROADMAP C35's
   path) at 4c's width, depth 2 and batch 4, the sort dispatch through the
   grouped kernel: a step counted in fake mode and for real, the counts
   equal; 4c's prompts prefilled off the mesh, then 4 greedy steps off
   the mesh and the same on it, 24 grouped launches on it, logits and
   tokens bitwise equal; (e) whisper-tiny's ``prefill_step`` at full
   width and depth, flash on, 4g's 4 x 432 tokens on 1,024 seeded frames:
   counted in fake mode and for real, the counts equal, 4 flash launches
   (once a decoder layer, through the op's DTensor rule), logits within
   5e-2 of the plain prefill off the mesh.  6b ``newton_krylov_step``
   on phi3-mini-3.8b at full width, depth 1 (310,256,640 parameters), f32,
   remat none, 2 x 128 tokens, the JAX model test's settings, its inner
   p-BiCGSafe solve on ``substrate="cuda"`` and then ``"torch"`` from the
   same weights: the fused dots and update kernels launched in f32 once
   per queued step on "cuda" and never on "torch", the same line-search
   step, inner iterations within 2, the new loss at most the old; the new
   losses within 1e-4 relative after one inner iteration, and after ten
   the loss decreases within 2e-2 of each other (``NK_DECREASE_RTOL``: the
   inner solve carries rounding apart on this operator, which is linear
   only to f32 rounding; a third step, "torch" on b (1 +- 2^-24), prints
   how far rounding alone moves it); inner iterations, steps queued,
   relres, the solve's route (the eager program), ms per GGN matvec and
   per inner iteration and the two kernels' share of it; 6c rows 1 and 2
   in f32 at n = 310,256,640 against their plain versions at phase 2's
   tolerances, timed beside their bounds;
7. a ``{"kernels": [...]}`` JSON line (rows 1-4 and 7 with
   ``launches_scenarios``: 3j's counted runs; rows 1 and 2 with
   ``launches_nk``, ``launches_nk_torch`` and ``nk_fp32``, 6b's and 6c's;
   the flash row with ``launches_moe``, 4b's, ``launches_hybrid``, 4e's
   (0), ``moe_shape``, 2d's times at llama4's shape, and ``audio_shape``,
   2d's at whisper's; every row with ``launches_ssm``, 4f's (0), and
   ``launches_audio``, 4g's (flash: 4 a prefill batch; 0 elsewhere), and
   ``launches_vlm``, 4h's (flash: 32 a prefill batch; 0 elsewhere), and
   ``launches_train_mesh``, 6d's (0), and ``launches_launch``, 6e's
   (rows 1 and 2: 17; flash: 36 + 4; grouped: 24; 0 elsewhere); the
   flash row with ``vlm_shape``, 2d's times at qwen2-vl's shape (G = 8),
   bf16 and its ``fp32``; the
   grouped row, 4c's, at a decode step's
   shape with ``prefill`` at the prefill's, each with ``kernel_route``
   (the route taken), ``tile`` and ``tile_ms`` (each bf16 tile's time), and
   ``fp32_fp64``, 4d's f32 and f64 route with its ``tile`` and ``tile_ms``,
   and ``launches_fp32_sort``),
   then the last line ``{"ok": true, "device": {...}}``.

Every solve of phases 3b-3f runs through a session's programs: each
solver chunk is a CUDA graph, captured on the session's first solve with
the measured call's settings (that first solve's wall time, capture
included, is printed on a line of its own, with the graphs captured) and
replayed after.  3b's p-BiCGSafe solve and 3c's block are solved again
through the eager chunk (``repro_torch.core.program._eager_chunks``), after
their counters are read: the eager run's ms per iteration is printed
beside the graph's with the card's name and power limit, and its ``x``,
iterations and relres must equal the graph run's bit for bit.  The memory
the allocator holds is printed after each solver phase, and the session
cache is cleared before phase 4.

The run goes 1, 3a (the matrix), 2, 2b, 2c, 2d, 3b-3f, the profiler's
counts, 3g, 5, 3h, 3i, 3j, 4, 4b, 4c, 4d, 4e, 4f, 4g, 4h, 6a, 6d, 6e, 6b, 6c, 7.  Each path is driven with the
launch counters set to 0 just before it and read just after; the kernels'
checks and timings are not counted.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

NX = 108                    # 108**3 = 1,259,712 rows, about atmosmodd's 1.27 M
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# peak rates (H100 SXM data sheet).  fp64: the tensor cores' DMMA rate, the
# most the card does in fp64 (the block-Jacobi kernel's products run
# there; the CUDA cores' is 34); fp32: the CUDA cores' rate
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12,
              # bf16 inputs: the tensor cores' dense rate (the bf16 flash
              # kernel's products run there, through mma.sync)
              "bfloat16": 989e12,
              # the tensor cores' dense TF32 rate: the fp32 flash kernel's
              # products, three TF32 passes each (3xTF32)
              "tf32": 495e12}
# max |kernel - plain| over the result's scale (a dot's sum of |a_i b_i|, a
# vector's max-abs).  fp64: FMA contraction and another summation order move
# the last ulps only.  fp32: the tolerances of tests/test_kernels.py.
TOL = {"float64": {"fused_dots": 1e-12, "fused_axpy": 1e-12,
                   "spmv_ell": 1e-12, "fused_dots_batched": 1e-12,
                   "fused_axpy_batched": 1e-12, "spmv_ell_batched": 1e-12,
                   "fused_dots_health": 1e-12,
                   "fused_dots_health_batched": 1e-12,
                   "block_jacobi_apply": 1e-12,
                   "block_jacobi_apply_batched": 1e-12},
       "float32": {"fused_dots": 2e-5, "fused_axpy": 5e-5, "spmv_ell": 1e-4,
                   "fused_dots_batched": 2e-4, "fused_axpy_batched": 5e-5,
                   "spmv_ell_batched": 1e-4, "fused_dots_health": 2e-5,
                   "fused_dots_health_batched": 2e-4,
                   "block_jacobi_apply": 5e-5,
                   "block_jacobi_apply_batched": 5e-5}}
REPLACES = {"fused_dots": "src/repro/kernels/fused_dots.py:63",
            "fused_axpy": "src/repro/kernels/fused_axpy.py:73",
            "spmv_ell": "src/repro/kernels/spmv_ell.py:45",
            "fused_dots_batched": "src/repro/kernels/fused_dots.py:110",
            "fused_axpy_batched": "src/repro/kernels/fused_axpy.py:154",
            "spmv_ell_batched": "src/repro/kernels/spmv_ell.py:99",
            "fused_dots_health": "src/repro/kernels/fused_dots.py:167",
            "fused_dots_health_batched": "src/repro/kernels/fused_dots.py:220",
            "block_jacobi_apply": "src/repro/kernels/precond_apply.py:47",
            "block_jacobi_apply_batched":
                "src/repro/kernels/precond_apply.py:80"}
# the health kernels are the 11-row forms of the dots kernels' templates
SOURCE = dict({k: f"src/repro_torch/csrc/{k}.cu" for k in REPLACES},
              fused_dots_health="src/repro_torch/csrc/fused_dots.cu",
              fused_dots_health_batched=(
                  "src/repro_torch/csrc/fused_dots_batched.cu"))
SINGLE = ("fused_dots", "fused_axpy", "spmv_ell")
BATCHED = ("fused_dots_batched", "fused_axpy_batched", "spmv_ell_batched")
HEALTH = ("fused_dots_health", "fused_dots_health_batched")
PRECOND = ("block_jacobi_apply", "block_jacobi_apply_batched")
# the flash kernel's two routes, fixed by dtype
FLASH_SOURCES = {"bfloat16": "src/repro_torch/csrc/flash_attention_mma.cu",
                 "float32": "src/repro_torch/csrc/flash_attention.cu"}
# the flash kernel's times at FLASH_SHAPE before it moved to the tensor
# cores (f32 FMAs on the CUDA cores): earlier runs' readings from PERF.md,
# row 11 (bf16, PR 17) and its fp32 row (PR 23), printed beside this run's
# times in phase 2d and nowhere else
FLASH_BF16_MS_BEFORE = 1.4795
FLASH_F32_MS_BEFORE = 1.4834
FLASH_MS_BEFORE = {"bfloat16": FLASH_BF16_MS_BEFORE,
                   "float32": FLASH_F32_MS_BEFORE}
# (B, H, K, S, hd): qwen3-8b's prefill of 4 prompts of 1,024 tokens
FLASH_SHAPE = (4, 32, 8, 1024, 128)
# llama4-scout's prefill of the same prompts (phase 4b): 40 query heads on
# 8 KV heads, G = 5 (odd; qwen3's is 4)
FLASH_SHAPE_MOE = (4, 40, 8, 1024, 128)
# whisper-tiny's decoder prefill in phase 4g: 4 prompts of 432 tokens, 6
# query heads on 6 KV heads (G = 1) of head dim 64
FLASH_SHAPE_AUDIO = (4, 6, 6, 432, 64)
# qwen2-vl-72b's prefill in phase 4h: 4 prompts of 1,024 tokens, 64 query
# heads on 8 KV heads (G = 8) of head dim 128
FLASH_SHAPE_VLM = (4, 64, 8, 1024, 128)
# the shapes timed (and repeated bitwise) in phase 2d
FLASH_TIMED = (FLASH_SHAPE, FLASH_SHAPE_MOE, FLASH_SHAPE_AUDIO,
               FLASH_SHAPE_VLM)
# (shape, causal, dtype name): the full shape, phi3's heads without the
# mask, and a ragged S (no multiple of the kernels' tiles), in both types;
# llama4's shape in bf16, the route its prefill takes
FLASH_CASES = ((FLASH_SHAPE, True, "bfloat16"), (FLASH_SHAPE, True, "float32"),
               (FLASH_SHAPE_MOE, True, "bfloat16"),
               ((1, 32, 32, 1024, 96), False, "bfloat16"),
               ((4, 32, 8, 1000, 128), True, "bfloat16"),
               ((1, 32, 32, 1024, 96), False, "float32"),
               ((4, 32, 8, 1000, 128), True, "float32"),
               (FLASH_SHAPE_AUDIO, True, "bfloat16"),
               (FLASH_SHAPE_AUDIO, True, "float32"),
               (FLASH_SHAPE_VLM, True, "bfloat16"),
               (FLASH_SHAPE_VLM, True, "float32"))
# the flash check, per output row (b, s, h): max |kernel - plain| over that
# row's max-abs, the largest over all rows (a row's scale falls with its
# causal length, so one max-abs for the whole output would let the late rows
# be wrong by most of their size); the values are tests/test_kernels.py's
# flash tolerances (bf16: both round the same f32 values at other points)
TOL_FLASH = {"bfloat16": 2e-2, "float32": 2e-5}
SERVE_ARCH = "qwen3-8b"
SERVE_REQUESTS = 4
SERVE_PROMPT = 1024
SERVE_NEW = 16
# max |flash - plain| of the last-position prefill logits over the plain
# ones' max-abs, bf16 through 36 layers: both paths round the softmax
# probabilities to bf16 before the product with V, but from other f32
# values (the kernel's online softmax against one softmax over the row), so
# each layer's attention output differs by about a bf16 ulp (2^-8) and the
# random-weight stack carries that on, as it carries bf16's other roundings
# (the run prints each path's gap to an fp32 run of the plain path beside
# it: the size of bf16's own noise at this depth)
SERVE_LOGITS_TOL = 5e-2
# the same bar for an fp32 prefill with the kernel against the fp32 plain
# prefill: per layer the two differ by about the kernel's 1e-6 (another
# summation order, exp2 and 3xTF32's 2^-22), and the random-weight stack
# carries that through 36 layers; the plain fp32 prefill with its products
# in one TF32 pass (the run's control) must miss it.  On an H100 the kernel
# read 6.27e-6 and the control 1.325e-3; the bar lies between them, an
# order of magnitude from each
SERVE_LOGITS_TOL_F32 = 1e-4
# phase 4b: llama4-scout-17b-a16e at full width, depth cut 48 -> 12 (48
# layers are 215 GB of bf16 weights, one card holds 80 GB; 12 are 57 GB)
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 12
# the MoE checks.  Through the whole stack no bar on the expert choices of
# the prefill with the kernel against the plain one can hold: bf16 noise
# flips the router's near-ties, a flipped token's whole feed-forward
# changes, and that carries on to every later layer and, through attention
# and the capacity's slot ranks, to other tokens.  On an H100 the plain
# bf16 prefill itself agreed with an fp32 prefill on 0.9017 of (layer,
# token) (layer 0: 0.9929, layer 11: 0.8071), the kernel's on 0.9144, and
# the two bf16 prefills on 0.9082.  So the checks are: (1) each layer given
# the same input (the plain prefill's input to it): the experts its block
# chooses with and without the kernel agree on MOE_ROUTE_AGREE of the
# tokens, and on the tokens that agree (and keep or lose their capacity
# slot alike) its outputs are within MOE_BF16_TOL;
# (2) through the stack, the kernel's prefill disagrees with the fp32
# prefill on at most MOE_FLIP_RATIO times the share the plain bf16
# prefill does (the control): the kernel routes no worse than plain bf16
MOE_ROUTE_AGREE = 0.95
MOE_FLIP_RATIO = 2.0
# gather (capacity raised to E: nothing drops) against sort on one
# full-width layer, and a block with the kernel against one without on the
# same input: tests/test_kernels.py's bf16 bar, over the max-abs
MOE_BF16_TOL = 2e-2
# phase 4c: deepseek-v3-671b at full width (MLA, 256 experts top-8 and a
# shared one, the dropless sort dispatch through the grouped kernel), depth
# cut 61 -> 2 (one layer is 11.5 G parameters, 23.0 GB of bf16: two and the
# embedding and head are 49.7 GB, three would leave too little room for the
# prefill's f32 scores), the MTP block off (serving never reads it)
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 2
# the absorbed decode of position S - 1 against the prefill's row S - 1 of
# one full-width MLA layer in fp32 (TF32 off), over the row's max-abs: the
# same sums in another order
MLA_FP32_TOL = 1e-4
MLA_FP32_SHAPE = (2, 1024)          # (B, S) of that check
# the grouped kernel against its plain version (bf16 operands, f32 sums,
# both rounded to bf16 from other orders): tests/test_kernels.py's bf16 bar
GROUPED_TOL = MOE_BF16_TOL
# f32 and f64 (the "mma" route: 3xTF32 with each stage's sums joined in
# f32, and f64 products, against the plain version's f32 / f64 sums in
# another order): tests/test_torch_cuda.py's bars
GROUPED_TOL_OF = {"bfloat16": GROUPED_TOL, "float32": 1e-5,
                  "float64": 1e-12}
# phase 4d (ROADMAP C26): deepseek-v3 at full width in fp32, this many
# layers, with the sort dispatch, its grouped products on the "mma" route
# at the shapes an fp32 config sends, held to the same model with the plain
# grouped product (the same sums in another order, over the logits'
# max-abs); its prompts' length; then the f32 and f64 routes at
# deepseek's `wi` shapes, these rows
FP32_SORT_LAYERS = 1
FP32_SORT_TOL = 1e-4
FP32_SORT_PROMPT = 64
FP32_GROUPED_ROWS = (32768, 32)
FP32_GROUPED_SHAPE = (256, 7168, 2048)      # (E, K, N) of deepseek's wi
# the gather dispatch with capacity E against sort on this many of the
# prefill's tokens: at 4,096 tokens its (G, E, C, d) input would be 120 GB
MLA_GATHER_TOKENS = 64
# phase 4e: zamba2-1.2b (the hybrid family: 38 Mamba2 layers, one shared
# attention block applied at every 6th, a 4,096-token window) at full width
# and depth, bf16.  Its prompts: 20 SSD chunks of 256, 1,024 tokens past the
# window, so the prefill's window mask and its K/V cut both act; a multiple
# of the plain attention's 1,024-row query blocks (4,352 tokens, 256 past
# the window, is not: both packages refuse it).  max_len at or above the
# window gives a 4,096-row ring, full from the first decode step on, so
# every step rolls it
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PROMPT = 5120
HYBRID_MAX_LEN = 4608
# the teacher-forced check: ``decode_step`` over the generated tokens
# against ``forward`` over the prompt and those tokens, max-abs over the
# logits' max-abs.  bf16 through 38 layers: phase 4's bar is recorded; the
# phase holds the decode under HYBRID_TF_OUTER (twice the 7.2e-2 the check
# reads on the H100, so a gross fault fails) and no further from the fp32
# forward of the same weights (TF32 off) than twice the bf16 forward is
# (the CPU tests' rule).  fp32 (TF32 off) at a depth with two applications
# of the shared block, so two rings, where decode and forward differ by
# f32 rounding alone, under HYBRID_TF_TOL_F32
HYBRID_TF_TOL = SERVE_LOGITS_TOL
HYBRID_TF_OUTER = 0.15
HYBRID_TF_TOL_F32 = 1e-3
HYBRID_F32_LAYERS = 7
# phase 4f: xlstm-350m (the SSM family: 12 sLSTM + mLSTM pairs, d 1,024, 4
# heads) at full width and depth, bf16, on phase 4's prompt length (four
# 256-token mLSTM chunks).  Its decode state has no sequence axis, so
# max_len bounds nothing: it is set under the prompt, as the JAX engine
# serves such a batch and the port's must not refuse it.  The
# teacher-forced check, the forward's input padded to the mLSTM's chunk so
# that it runs chunked as the prefill does: at full depth the bf16 decode
# no further from the fp32 forward (TF32 off) than twice the bf16 forward
# is, and the same weights in fp32 (TF32 off) under XLSTM_TF_TOL_F32; at
# depth XLSTM_F32_LAYERS (two pairs) bf16 under XLSTM_TF_OUTER (and the
# same rule against fp32) and fp32 under XLSTM_TF_TOL_F32.  At full depth
# bf16 rounding alone decorrelates the stack: on the H100 the bf16 forward
# reads 0.70 of the logits' max-abs from the fp32 forward of the same
# weights, and the bf16 decode 0.40 from the bf16 forward, so 4e's
# XLSTM_TF_OUTER and phase 4's bar are recorded there, not held (the JAX
# package's own bf16 forward is 0.47-0.77 from its fp32 one at 24 layers
# on the CPU at d 64 and 256); fp32 at full depth reads 4.3e-4
XLSTM_ARCH = "xlstm-350m"
XLSTM_PROMPT = SERVE_PROMPT
XLSTM_MAX_LEN = 256
XLSTM_CHUNK = 256
XLSTM_TF_TOL = SERVE_LOGITS_TOL
XLSTM_TF_OUTER = 0.15
XLSTM_TF_TOL_F32 = 1e-3
XLSTM_F32_LAYERS = 4
XLSTM_PARAMS = 442_283_104      # the JAX package's count, jax.eval_shape
# phase 4g: whisper-tiny (the audio family) at full width and depth, bf16,
# max_len 448 (whisper's decoder context): 4 prompts of 432 tokens, 16 new
AUDIO_ARCH = "whisper-tiny"
AUDIO_PROMPT = 432
AUDIO_MAX_LEN = 448
AUDIO_PARAMS = 49_046_016       # the JAX package's count, jax.eval_shape
# the encoder's frames in 4g's entry-point prefill: 1,024, the largest one
# query block of the plain attention takes in both packages (1,500, whisper's
# own, is refused by both: ROADMAP C30)
AUDIO_FRAMES = 1024
# the fp32 (TF32 off) decode on the card against the same steps on the CPU,
# over the logits' max-abs: both sum the same f32 products in other orders
AUDIO_DECODE_TOL_F32 = 1e-4
# phase 4h: qwen2-vl-72b (the VLM family: M-RoPE, QKV biases, 64 query
# heads on 8 KV heads) at full width, bf16, depth cut 80 -> 32: a layer is
# 877,684,224 parameters (1.755 GB of bf16), the embedding and the untied
# head 4.98 GB, so 32 layers are 61.15 GB of weights and leave the
# prefill and the plain branch's f32 scores room on the 80 GB card (80
# layers are 145 GB)
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 32
VLM_PARAMS = 30_577_336_320     # the JAX package's count at depth 32
# the entry point with an image: 256 seeded patch rows spliced in at row 1
# of each prompt, their (t, h, w) ids t fixed over a 16 x 16 grid, the
# text after them from the largest id plus one
VLM_GRID = (16, 16)
GROUPED_SOURCE = "src/repro_torch/csrc/grouped_mm_sm90.cu"
GROUPED_SOURCES = {"wgmma": GROUPED_SOURCE,
                   "mma": "src/repro_torch/csrc/grouped_mm.cu"}
GROUPED_STANDS_IN = ("src/repro/models/moe.py:172 (jax.lax.ragged_dot; no "
                     "Pallas kernel)")
M = 8                       # columns of the batched path (ServiceConfig.max_batch)
SOLVE_MAXITER = 2000        # maxiter of the single-RHS solves (3b, 3f)
# phase 3f: the JAX package's seven methods, and the reduction phases each
# runs per iteration (the paper's Table 3.1)
COMPARISON = ("p-bicgsafe", "p-bicgsafe-rr", "ssbicgsafe2", "p-bicgstab",
              "bicgstab", "gpbicg", "cgs")
REDUCTIONS = {"p-bicgsafe": 1, "p-bicgsafe-rr": 1, "ssbicgsafe2": 1,
              "p-bicgstab": 2, "bicgstab": 2, "gpbicg": 3, "cgs": 2}
# the typed outcome of a 3f method that does not converge on this system:
# the JAX package's CGS runs to maxiter here without a breakdown, its
# residual growing (tools/reference_methods.py on the CPU; ROADMAP C14)
EXPECT = {"cgs": "MAXITER"}
STEP_REPS = 4               # solver steps queued per timing (see device_ms)
SERVICE_REQUESTS = 32       # phase 5's burst, queued at t = 0
SERVICE_TOLS = (1e-8, 1e-6)  # alternating, as bench_service's tol_mix
SERVICE_CHUNK = 32
SERVICE_GUARDED = 16        # requests of the guarded run
SERVICE_BJ = 8              # requests of the block-Jacobi-registered run
SERVICE_SESSIONS = 6        # (n, M) sessions bound under a small budget
# phase 3h: the traced methods, the ring of trace=N and of the traced
# service, and where its profiles and the CLI's artifacts go
OBSERVE_METHODS = ("p-bicgsafe", "p-bicgsafe-rr", "ssbicgsafe2")
OBSERVE_RING = 64
OBSERVE_DIR = os.path.join(ROOT, "build", "observe")
# phase 3i: the contract audit's committed CPU artifact, and the kernel ops
# a p-BiCGSafe step on the ELL operator holds (dots, axpy, two SpMVs)
AUDIT_ARTIFACT = os.path.join(ROOT, "experiments",
                              "torch_contract_audit.json")
STEP_KERNEL_OPS = 4
# phase 3j: the scenario sweep's references (the JAX package's committed
# artifact, read as JSON, and the port's CPU one), their iteration slack
# (ROADMAP C4), the service burst, and the kernels the path must launch
JAX_SWEEP = os.path.join(ROOT, "experiments", "scenario_sweep.json")
TORCH_SWEEP = os.path.join(ROOT, "experiments", "torch_scenario_sweep.json")
SCENARIO_ITER_SLACK = 2
SCENARIO_REQUESTS = 8
SCENARIO_KERNELS = ("fused_dots", "fused_axpy", "spmv_ell",
                    "fused_dots_batched", "fused_axpy_batched")
# phase 6a: training phi3-mini-3.8b at full width, depth cut to 4 (the
# checkpoint's volume: bf16 weights stored as f32 and two f32 moments, 7.8
# GB a save), 4 x 1,024 synthetic tokens a step, 8 steps, a checkpoint every
# 4, AdamW as the JAX launcher sets it; a failure injected at step 6 of a
# second run; then 2 steps with 8-bit moments
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
TRAIN_I8_STEPS = 2
TRAIN_LR = 3e-3
TRAIN_DIR = os.path.join(ROOT, "build", "train")
# the resumed run's losses of steps 4-7 against the uninterrupted run's,
# relative: both step from the same restored state, but the card's
# reductions (the embedding's backward among them) may sum in another order
TRAIN_RESUME_RTOL = 1e-3
# phase 6d: 6a's run (model, data, seed, steps) on a one-rank NCCL (1, 1)
# ("data", "model") mesh, one checkpoint at its last step (restored by the
# plain trainer, bit for bit); the losses are held bitwise to 6a's, the gap
# printed if not (a one-rank mesh runs the same local products)
TRAIN_MESH_SHAPE, TRAIN_MESH_NAMES = (1, 1), ("data", "model")
TRAIN_MESH_DIR = os.path.join(ROOT, "build", "train_mesh")
# phase 6e: the dry run's cells (repro_torch.launch) on a one-rank NCCL
# (1, 1) mesh: the solver's step at 3a's grid (108^3, fp64, "cuda"), counted
# in fake mode and over LAUNCH_SOLVER_STEPS real steps after one warm step;
# qwen3-8b's prefill at phase 4's size (full width and depth, bf16, flash
# on), counted in fake mode and run for real; 6d's step counted in fake
# mode.  The prefill's count within LAUNCH_HAND_RTOL of the hand count
# (causal: S (S + 1) / 2 positions a head), the fake peak within
# LAUNCH_PEAK_RATIO of the card's max_memory_allocated
LAUNCH_SOLVER_STEPS = 16
LAUNCH_HAND_RTOL = 1e-2
LAUNCH_PEAK_RATIO = (0.5, 2.0)
# 6e (d): deepseek-v3's absorbed MLA decode on the mesh, the path of
# ROADMAP C35: 4c's width, depth, prompts and batch, the sort dispatch
# through the grouped kernel; a prefill off the mesh, then LAUNCH_MLA_STEPS
# greedy decode steps off the mesh and the same steps on it from the same
# cache.  A one-rank mesh runs the same local products in the same order
# (the repaired cache write takes its one row through index_select and a
# where, the same values), so the steps' logits and tokens are held bitwise
LAUNCH_MLA_STEPS = 4
LAUNCH_MLA_SEED = 0
# 6e (e): whisper-tiny's prefill_step on the mesh, full width and depth,
# flash on: 4g's prompts (AUDIO_PROMPT tokens) and AUDIO_FRAMES seeded
# frames; its logits within SERVE_LOGITS_TOL (4g's bf16 bar, flash against
# the plain branch) of the plain prefill (flash off) off the mesh
BF16_PEAK_FLOPS = 989e12    # H100 SXM, dense
# phase 6b: one Newton-Krylov step on phi3-mini-3.8b at full width, depth 1
# (310,256,640 parameters, as the JAX package's model test has one layer),
# f32, remat none, 2 x 128 tokens, the JAX model test's settings, through
# substrate "cuda" and "torch"
NK_LAYERS = 1
NK_BATCH, NK_SEQ = 2, 128
NK_PARAMS = 310_256_640
NK_CFG = dict(damping=1e-2, inner_maxiter=10, inner_tol=1e-2, lr=0.5)
NK_ITER_SLACK = 2
# the "cuda" and "torch" steps: their new losses within NK_LOSS_RTOL
# (relative) after one inner iteration, and after NK_CFG's ten their loss
# decreases (old - new) within NK_DECREASE_RTOL of each other.  The ISSUE's
# bar, 1e-4 on the new losses after ten, cannot hold: both packages run
# attention and RoPE in f32, so the GGN matvec is linear only to f32
# rounding (ROADMAP C22), and p-BiCGSafe carries each iteration's rounding
# apart.  On the card the two substrates' new losses were 8.1e-8 apart after
# one iteration and 6.4e-3 after ten (decreases 5.968 and 5.998 from
# 10.713), where the same solve with its right-hand side changed by 2^-24
# moved by 3.2e-4 (PERF.md, PR 27); that control is printed beside
NK_LOSS_RTOL = 1e-4
NK_DECREASE_RTOL = 2e-2
# the two kernels the Newton-Krylov solve launches (6c checks them at its n)
NK_KERNELS = ("fused_dots", "fused_axpy")
# 3b's ms per iteration in PERF.md (section 5: a run on one H100 80GB HBM3
# at 700.00 W, before the solver kernels were torch.library ops)
PERF_3B_MS = {"graph": 0.5840, "eager": 1.2987}


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def log_memory(torch, label: str) -> None:
    log(f"memory after {label}: {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB reserved, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")


def first_solve(torch, label: str, session, call) -> float:
    """Run a session's first solve with the measured call's settings (its
    programs' capture included), print its wall time and the graphs the
    session captured, and return the wall time in seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"{label}: first solve {wall * 1e3:.1f} ms (capture included), "
        f"{session.stats['graphs']} graphs captured, "
        f"{session.stats['programs']} programs")
    return wall


def eager_rerun(torch, label: str, call, graph_res, graph_ms: float,
                per: str) -> float:
    """The same solve through the eager chunk (not counted): it must equal
    the graph run's result bit for bit; prints both times per ``per``
    beside the card, and returns the eager ms per ``per``."""
    from repro_torch.core.program import _eager_chunks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _eager_chunks():
        res, n = call()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / n * 1e3
    same = all(torch.equal(a, b) for a, b in (
        (res.x, graph_res.x), (res.iterations, graph_res.iterations),
        (res.relres, graph_res.relres)))
    log(f"{label}: graph {graph_ms:.4f} ms per {per}, eager chunk "
        f"{eager_ms:.4f} ms per {per} (x{eager_ms / graph_ms:.3f}); x "
        f"bitwise equal: {same} [{card()}]")
    if not same:
        raise SystemExit(f"{label}: the graph run's result differs from the "
                         "eager chunk's")
    return eager_ms


def device_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """Median device time of one call of ``fn``, in ms.

    A sleep kernel holds the stream while the host queues ``reps`` calls,
    so the events time the calls back to back on the device and not the
    host's launch rate.  The ``reps`` calls must launch well under the
    1,024 kernels the launch queue holds, or the host blocks and its rate
    shows in the time again: a solver step of about 100-170 kernels is
    timed with ``reps=STEP_REPS``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 2e9 * 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(trials):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile_device(torch, fn, trace: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (the trace kept as
    ``build/profile/<trace>.json``): ``kernels`` counts the card's kernel
    events (copies and memsets are not kernels; ``kernel_events`` are
    they), ``busy_ms`` is the union of its kernel, copy and memset
    intervals, ``wall_s`` the run's wall time, synchronized."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{trace}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in (
                        "kernel", "gpu_memcpy", "gpu_memset"))
    kernel_events = [e for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernel_events:
        raise SystemExit("the profiler's trace holds no kernel")
    busy, end = 0.0, float("-inf")
    for t0, t1 in device:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return dict(kernels=len(kernel_events), busy_ms=busy / 1e3, wall_s=wall,
                kernel_events=kernel_events)


def device_activity(torch, fn, reps: int = 16) -> dict:
    """What the device ran per call of ``fn``, from a profiler trace of
    ``reps`` calls: kernels and busy ms per call."""
    fn()

    def calls():
        for _ in range(reps):
            fn()
    rec = profile_device(torch, calls, "chip_smoke_step_trace")
    return dict(kernels=rec["kernels"] / reps, busy_ms=rec["busy_ms"] / reps)



def sass_by_function(path, nvcc: str) -> dict:
    """The SASS of the built library, from ``cuobjdump -sass`` (beside
    ``nvcc``): {mangled kernel name: its lines}."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def count_hmma(path, nvcc: str) -> dict:
    """Tensor-core instructions (``HMMA``) in the flash kernels' SASS; fails
    if an instance of the bf16 kernel has none, or an instance of the fp32
    one (3xTF32) has no TF32 ``HMMA``.  Returns the fewest per instance of
    each."""
    sass = sass_by_function(path, nvcc)
    mma = {f: sum("HMMA" in x for x in lines) for f, lines in sass.items()
           if "flash_attention_mma" in f}
    f32 = {f: sum("HMMA" in x and "TF32" in x for x in lines)
           for f, lines in sass.items() if "flash_attention_kernel" in f}
    log(f"SASS: HMMA per instance of the bf16 flash kernel "
        f"{sorted(mma.values())}, TF32 HMMA per instance of the fp32 one "
        f"{sorted(f32.values())}")
    for f, lines in sass.items():
        # the fp32 instance the serving shape runs (HD = 128, 16-byte loads)
        if "flash_attention_kernelILi128ELb1" in f:
            ops = collections.Counter(
                m[1] for x in lines
                if (m := re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                                   x)))
            log(f"SASS: the fp32 instance HD = 128 (16-byte loads): "
                f"{sum(ops.values())} instructions, by opcode "
                f"{ops.most_common(16)}")
    if not mma or min(mma.values()) == 0 or not f32 \
            or min(f32.values()) == 0:
        raise SystemExit(f"SASS: bf16 flash kernels {mma}, fp32 {f32}")
    return dict(bfloat16=min(mma.values()), float32=min(f32.values()))


def ptxas_report(report: str) -> dict:
    """Registers and spill bytes per kernel instance from ``ptxas -v``'s
    report of the build: {mangled name: dict(registers, spill_stores,
    spill_loads)}."""
    out, fn = {}, None
    for line in report.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ", 1)[1].strip()
            out[fn] = dict(registers=None, spill_stores=None,
                           spill_loads=None)
        elif fn is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            out[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif m := re.search(r"Used (\d+) registers", line):
            out[fn]["registers"] = int(m[1])
            fn = None
    return out


def check_flash_spills(report: str) -> dict:
    """Phase 1's gate on the fp32 flash kernel: every instance compiled
    with 0 spill bytes; returns its instances' registers and spills."""
    inst = {f: r for f, r in ptxas_report(report).items()
            if "flash_attention_kernel" in f}
    log("ptxas: fp32 flash instances (registers, spill stores, spill "
        "loads): " + str(sorted((r["registers"], r["spill_stores"],
                                 r["spill_loads"]) for r in inst.values())))
    if len(inst) != 8 or any(r["spill_stores"] != 0 or r["spill_loads"] != 0
                             for r in inst.values()):
        raise SystemExit(f"ptxas: fp32 flash instances {inst}: each of the "
                         "8 must spill 0 bytes")
    return inst


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, ops, ref, values, cols, dtype) -> dict:
    """Each kernel against its plain version on the card, in ``dtype``."""
    name = str(dtype).replace("torch.", "")
    dev = values.device
    n, k = values.shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn(n, generator=gen, device=dev, dtype=torch.float64
                           ).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    out = {}

    # fused_dots: scale of a dot is sum |a_i b_i|
    s, y, r, t, rs = (randn() for _ in range(5))
    got = ops.fused_dots(s, y, r, t, rs)
    want = ref.fused_dots(s, y, r, t, rs)
    scale = ref.fused_dots(*(v.abs() for v in (s, y, r, t, rs)))
    stacked = torch.stack([s, y, r, t, rs])
    out["fused_dots"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots(s, y, r, t, rs)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots(s, y, r, t, rs)),
        library_ms=device_ms(torch, lambda: stacked @ stacked.T),
        bound=bound_ms(5 * item * n + 9 * item, 18 * n, name))
    del stacked

    # fused_dots_health: the 9 dots, x.x and the probe; the yardstick is the
    # Gram of the six stacked vectors (it omits the probe row).  Rows 0-8
    # must equal fused_dots' bit for bit (one template).
    x = randn()
    got = ops.fused_dots_health(s, y, r, t, rs, x)
    want = ref.fused_dots_health(s, y, r, t, rs, x)
    scale = ref.fused_dots_health(*(v.abs() for v in (s, y, r, t, rs, x)))
    same_rows = torch.equal(got[:9], ops.fused_dots(s, y, r, t, rs))
    probe = ops.fused_dots_health(s, y, r, t, rs,
                                  torch.where(torch.arange(n, device=dev)
                                              == n // 3, float("nan"), x))
    if bool(torch.isfinite(probe[10])) or \
            not bool(torch.isfinite(probe[:9]).all()):
        raise SystemExit(f"fused_dots_health {name}: a NaN in x did not "
                         f"reach the probe row alone: {probe.tolist()}")
    stacked = torch.stack([s, y, r, t, rs, x])
    out["fused_dots_health"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots_health(s, y, r, t, rs, x)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots_health(s, y, r, t,
                                                                rs, x)),
        library_ms=device_ms(torch, lambda: stacked @ stacked.T),
        bound=bound_ms(6 * item * n + 11 * item, 25 * n, name),
        rows_0_8_bitwise=same_rows)
    del stacked

    # fused_axpy: scale of an output vector is its max-abs
    from repro_torch.kernels.fused_axpy import IN_ORDER
    vecs = {key: randn() for key in IN_ORDER}
    scal = torch.tensor([0.3, -0.7, 1.1, 0.2], dtype=dtype, device=dev)
    got = ops.fused_axpy(vecs, scal)
    want = ref.fused_axpy(vecs, scal.unbind(0))
    out["fused_axpy"] = dict(
        err=max(float((got[key] - want[key]).abs().max()
                      / want[key].abs().max()) for key in want),
        max_abs_err=max(float((got[key] - want[key]).abs().max())
                        for key in want),
        ms=device_ms(torch, lambda: ops.fused_axpy(vecs, scal)),
        plain_ms=device_ms(torch, lambda: ref.fused_axpy(vecs,
                                                          scal.unbind(0))),
        library_ms=None,
        bound=bound_ms(22 * item * n + 4 * item, 34 * n, name))
    del vecs, got, want

    # spmv_ell on the main path's matrix
    from repro_torch.core.linear_operator import ELLOperator
    op = ELLOperator(values.to(dtype), cols, n)
    x = randn()
    got = ops.spmv_ell(op, x)
    want = ref.spmv_ell(op.values, op.cols, x)
    crow = torch.arange(0, n * k + 1, k, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1).to(torch.int64),
                                  op.values.reshape(-1), size=(n, n))
    out["spmv_ell"] = dict(
        err=float((got - want).abs().max() / want.abs().max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.spmv_ell(op, x)),
        plain_ms=device_ms(torch, lambda: ref.spmv_ell(op.values, op.cols, x)),
        library_ms=device_ms(torch, lambda: csr @ x),
        bound=bound_ms(k * item * n + k * 4 * n + 2 * item * n, 2 * k * n,
                       name))
    return finish(out, name)


def finish(out: dict, name: str) -> dict:
    """Attach each kernel's tolerance and log its line."""
    for kname, rec in out.items():
        rec["tol"] = TOL[name][kname]
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f}"
        log(f"kernel {kname:18s} {name}: max_rel_err {rec['err']:.3e} "
            f"(tol {rec['tol']:.0e}) kernel_ms {rec['ms']:.4f} "
            f"plain_ms {rec['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {rec['bound'][0]:.4f} ({rec['bound'][1]})")
    return out


def check_batched_kernels(torch, ops, ref, values, cols, dtype) -> dict:
    """Each batched kernel against its plain version on the card, in
    ``dtype``, on (n, M) blocks."""
    name = str(dtype).replace("torch.", "")
    dev = values.device
    n, k = values.shape
    m = M
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    out = {}

    # fused_dots_batched: scale of a dot is sum |a_i b_i|; the library
    # yardstick is the per-column Gram of the five blocks, one bmm
    s, y, r, t, rs = (randn(n, m) for _ in range(5))
    got = ops.fused_dots(s, y, r, t, rs)
    want = ref.fused_dots(s, y, r, t, rs)
    scale = ref.fused_dots(*(v.abs() for v in (s, y, r, t, rs)))
    cols_major = torch.stack([s, y, r, t, rs]).permute(2, 0, 1).contiguous()
    gram_t = cols_major.transpose(1, 2)
    out["fused_dots_batched"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots(s, y, r, t, rs)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots(s, y, r, t, rs)),
        library_ms=device_ms(torch, lambda: torch.bmm(cols_major, gram_t)),
        bound=bound_ms(5 * item * n * m + 9 * item * m, 18 * n * m, name))
    del cols_major, gram_t, s, y, r, t, rs

    # fused_axpy_batched: every other column frozen with NaN coefficients;
    # the live columns against the plain version (scale: their max-abs),
    # the frozen ones must be their inputs bit for bit.  Timed with every
    # column live, as in most of a solve.
    from repro_torch.kernels.fused_axpy import IN_ORDER, MASKED_OUT
    vecs = {key: randn(n, m) for key in IN_ORDER}
    scal = randn(4, m)
    mask = torch.arange(m, device=dev) % 2 == 0
    scal[:, ~mask] = float("nan")
    got = ops.fused_axpy(vecs, scal, mask)
    want = ref.fused_axpy(vecs, scal.unbind(0), mask)
    for key in MASKED_OUT:
        if not torch.equal(got[key][:, ~mask], vecs[key][:, ~mask]):
            raise SystemExit(f"fused_axpy_batched {name}: frozen columns of "
                             f"{key} are not their inputs")
    live = {key: (got[key][:, mask] - want[key][:, mask]).abs()
            for key in want}
    err = max(float(live[key].max() / want[key][:, mask].abs().max())
              for key in want)
    max_abs = max(float(v.max()) for v in live.values())
    del got, want, live
    scal = randn(4, m)
    every = torch.ones(m, dtype=torch.bool, device=dev)
    out["fused_axpy_batched"] = dict(
        err=err, max_abs_err=max_abs,
        ms=device_ms(torch, lambda: ops.fused_axpy(vecs, scal, every)),
        plain_ms=device_ms(torch, lambda: ref.fused_axpy(
            vecs, scal.unbind(0), every)),
        library_ms=None,
        bound=bound_ms(22 * item * n * m + 4 * item * m + m, 34 * n * m,
                       name))
    del vecs

    # spmv_ell_batched on the main path's matrix; the library yardstick is
    # cuSPARSE's SpMM through a CSR tensor
    from repro_torch.core.linear_operator import ELLOperator
    op = ELLOperator(values.to(dtype), cols, n)
    x = randn(n, m)
    got = ops.spmv_ell(op, x)
    want = ref.spmv_ell(op.values, op.cols, x)
    crow = torch.arange(0, n * k + 1, k, device=dev, dtype=torch.int64)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1).to(torch.int64),
                                  op.values.reshape(-1), size=(n, n))
    out["spmv_ell_batched"] = dict(
        err=float((got - want).abs().max() / want.abs().max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.spmv_ell(op, x)),
        plain_ms=device_ms(torch, lambda: ref.spmv_ell(op.values, op.cols,
                                                       x)),
        library_ms=device_ms(torch, lambda: csr @ x),
        bound=bound_ms(k * item * n + k * 4 * n + 2 * item * n * m,
                       2 * k * n * m, name))
    del x, csr

    # fused_dots_health_batched: the yardstick is the per-column Gram of the
    # six blocks, one bmm (it omits the probe row).  The probe row must be
    # non-finite in exactly the columns fed an Inf (s) or a NaN (x).
    s, y, r, t, rs, x = (randn(n, m) for _ in range(6))
    got = ops.fused_dots_health(s, y, r, t, rs, x)
    want = ref.fused_dots_health(s, y, r, t, rs, x)
    scale = ref.fused_dots_health(*(v.abs() for v in (s, y, r, t, rs, x)))
    same_rows = torch.equal(got[:9], ops.fused_dots(s, y, r, t, rs))
    s_bad, x_bad = s.clone(), x.clone()
    s_bad[17, 1] = float("inf")
    x_bad[n // 2, 3] = float("nan")
    flagged = (~torch.isfinite(ops.fused_dots_health(
        s_bad, y, r, t, rs, x_bad)[10])).tolist()
    if flagged != [j in (1, 3) for j in range(m)]:
        raise SystemExit(f"fused_dots_health_batched {name}: the probe row "
                         f"flags columns {flagged}, not 1 and 3")
    del s_bad, x_bad
    cols_major = torch.stack([s, y, r, t, rs, x]).permute(2, 0, 1).contiguous()
    gram_t = cols_major.transpose(1, 2)
    out["fused_dots_health_batched"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots_health(s, y, r, t, rs, x)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots_health(s, y, r, t,
                                                                rs, x)),
        library_ms=device_ms(torch, lambda: torch.bmm(cols_major, gram_t)),
        bound=bound_ms(6 * item * n * m + 11 * item * m, 25 * n * m, name),
        rows_0_8_bitwise=same_rows)
    del cols_major, gram_t
    finish(out, name)

    # m = 1: an (n, 1) block is an (n,) vector in memory, so either kernel
    # of a pair can serve it; each pair timed on the same column
    from repro_torch.kernels import fused_dots as fd
    col = [v[:, :1].contiguous() for v in (s, y, r, t, rs, x)]
    vec = [v.view(-1) for v in col]
    at_m1 = dict(
        fused_dots=device_ms(torch, lambda: fd.fused_dots_cuda(*vec[:5])),
        fused_dots_batched=device_ms(
            torch, lambda: fd.fused_dots_batched_cuda(*col[:5])),
        fused_dots_health=device_ms(
            torch, lambda: fd.fused_dots_health_cuda(*vec)),
        fused_dots_health_batched=device_ms(
            torch, lambda: fd.fused_dots_health_batched_cuda(*col)))
    log(f"m = 1 {name}: ms of each kernel on one column: "
        f"{json.dumps(at_m1)}")
    return out, at_m1


def check_precond_kernels(torch, ops, ref, inv_blocks, dtype) -> dict:
    """Phase 2c: the block-Jacobi kernels against their plain versions on
    the card, in ``dtype``, with the main path's blocks; each repeated and
    required bitwise equal.  The library yardstick is one ``torch.bmm`` of
    the blocks and x viewed as (nb, bs, m).  Each time is printed with its
    TB/s, its ratio to ``bmm``'s and to the bound, and the batched kernel's
    route (``precond_apply.batched_route``), which must be "bulk" here."""
    from repro_torch.kernels import precond_apply
    name = str(dtype).replace("torch.", "")
    inv = inv_blocks.to(dtype).contiguous()
    nb, bs, _ = inv.shape
    n = nb * bs
    dev = inv.device
    gen = torch.Generator(device=dev).manual_seed(4)
    item = torch.empty((), dtype=dtype).element_size()
    out = {}
    for kname, m in (("block_jacobi_apply", None),
                     ("block_jacobi_apply_batched", M)):
        shape = (n,) if m is None else (n, m)
        x = torch.randn(*shape, generator=gen, device=dev,
                        dtype=torch.float64).to(dtype)
        got = ops.block_jacobi_apply(inv, x)
        want = ref.block_jacobi_apply(inv, x)
        scale = ref.block_jacobi_apply(inv.abs(), x.abs())
        repeats = all(torch.equal(ops.block_jacobi_apply(inv, x), got)
                      for _ in range(3))
        if not repeats:
            raise SystemExit(f"{kname} {name}: a repeat is not bitwise equal")
        xb = x.view(nb, bs, -1)
        cols = 1 if m is None else m
        nbytes = nb * bs * bs * item + 2 * n * cols * item
        out[kname] = dict(
            err=float(((got - want).abs() / scale).max()),
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(torch, lambda: ops.block_jacobi_apply(inv, x)),
            plain_ms=device_ms(torch, lambda: ref.block_jacobi_apply(inv, x)),
            library_ms=device_ms(torch, lambda: torch.bmm(inv, xb)),
            bound=bound_ms(nbytes, 2 * n * bs * cols, name),
            repeats_bitwise=repeats, bs=bs, nb=nb, nbytes=nbytes,
            route="block" if m is None else precond_apply.batched_route(
                nb, bs, m, dtype, aligned=all(
                    p % 16 == 0 for p in (inv.data_ptr(), x.data_ptr(),
                                          got.data_ptr()))))
        del x, got, want, scale, xb
    finish(out, name)
    for kname, rec in out.items():
        log(f"kernel {kname:18s} {name}: route {rec['route']}, "
            f"{rec['nbytes'] / rec['ms'] / 1e9:.3f} TB/s, "
            f"{rec['ms'] / rec['library_ms']:.3f}x torch.bmm's time, "
            f"{rec['ms'] / rec['bound'][0]:.3f}x the bound")
    if out["block_jacobi_apply_batched"]["route"] != "bulk":
        raise SystemExit(f"block_jacobi_apply_batched {name}: route "
                         f"{out['block_jacobi_apply_batched']['route']} at "
                         "the main path's shape, not bulk")
    return out


def method_launches(method: str, steps: int, rr_steps: int = 0) -> dict:
    """A single-RHS solve's kernel launches on the ELL operator for
    ``steps`` queued steps (phase 3f's table): the fused dots only where
    the method has the 9-dot phase, the update kernel only in p-BiCGSafe's,
    and two SpMVs a step (p-BiCGSafe: plus its set-up's A r_0 and -rr's
    four per replacement; p-BiCGStab: plus its set-up's two)."""
    if method.startswith("p-bicgsafe"):
        return dict(fused_dots=steps, fused_axpy=steps,
                    spmv_ell=1 + 2 * steps + 4 * rr_steps)
    if method == "ssbicgsafe2":
        return dict(fused_dots=steps, spmv_ell=2 * steps)
    if method == "p-bicgstab":
        return dict(spmv_ell=2 + 2 * steps)
    return dict(spmv_ell=2 * steps)


def run_main_path(torch, repro_torch, ops, method, ell, stencil, b,
                  label="main", precond=None, expect="CONVERGED",
                  eager=False):
    """One measured solve through the front door, with the launch counters
    set to 0 just before it and read just after: it must converge with a
    true relres within 1e-6 (of the preconditioned system, with
    ``precond``, the block-Jacobi preconditioner of phase 2c) and launch
    :func:`method_launches` (and one apply per SpMV plus b's) for the
    steps it queued.  ``expect="MAXITER"``: it must instead end as the JAX
    package's solve of this system does, at ``SOLVE_MAXITER`` without a
    breakdown (``EXPECT``).  ``eager``: then the same solve through the
    eager chunk, held to it bit for bit, with its time."""
    solver = repro_torch.make_solver(method, ell, substrate="cuda",
                                     precond=precond)
    first_s = first_solve(                           # warm-up, not counted
        torch, f"{label} {method}", solver,
        lambda: solver.solve(b, tol=1e-8, maxiter=SOLVE_MAXITER))
    solver.stats.update(steps=0, rr_steps=0, host_reads=0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(b, tol=1e-8, maxiter=SOLVE_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    it = int(res.iterations)
    resid = b - stencil.matvec(res.x)
    true_relres = float(torch.linalg.vector_norm(resid)
                        / torch.linalg.vector_norm(b))
    steps, rr_steps = solver.stats["steps"], solver.stats["rr_steps"]
    rec = dict(method=method, iterations=it, converged=bool(res.converged),
               status=repro_torch.SolveStatus(int(res.status)).name,
               relres=float(res.relres), true_relres=true_relres,
               max_err=float((res.x - 1.0).abs().max()), wall_s=wall,
               ms_per_iteration=wall / max(it, 1) * 1e3, steps=steps,
               rr_steps=rr_steps, host_reads=solver.stats["host_reads"],
               reductions_per_iteration=REDUCTIONS[method],
               launches=launches, first_solve_s=first_s,
               graphs=solver.stats["graphs"],
               traces=solver.stats["traces"])
    bar = true_relres
    want = dict(dict.fromkeys(ops.LAUNCHES, 0),
                **method_launches(method, steps, rr_steps))
    if precond is not None:
        papply = solver.precond.apply
        bar = rec["precond_true_relres"] = float(
            torch.linalg.vector_norm(papply(resid))
            / torch.linalg.vector_norm(papply(b)))
        rec["precond"] = solver.precond.name
        want["block_jacobi_apply"] = want["spmv_ell"] + 1
    log(f"{label} {method}: {json.dumps(rec)}")
    if launches != want or steps == 0:
        raise SystemExit(f"{label} {method}: launches {launches} != {want}")
    if eager:
        rec["eager_ms_per_iteration"] = eager_rerun(
            torch, f"{label} {method}",
            lambda: (solver.solve(b, tol=1e-8, maxiter=SOLVE_MAXITER), it),
            res, rec["ms_per_iteration"], "iteration")
    if expect != "CONVERGED":
        if rec["status"] != expect or bool(res.breakdown) \
                or not it == steps == SOLVE_MAXITER:
            raise SystemExit(f"{label} {method}: not the reference's "
                             f"{expect} at {SOLVE_MAXITER}: {rec}")
        return rec
    if not rec["converged"] or bar > 1e-6:
        raise SystemExit(f"{label} {method} did not converge: {rec}")
    # the steps queued are the iterations, the step that found convergence,
    # and the rest of its chunk
    from repro_torch.core.pipelined_bicgsafe import CHUNK
    if not it + 1 <= steps <= it + CHUNK:
        raise SystemExit(f"{label} {method}: {steps} steps for {it} "
                         "iterations")
    return rec


def run_comparison_path(torch, repro_torch, ops, ell, stencil, b, pc) -> dict:
    """Phase 3f: the paper's comparison on the card.  The seven methods of
    ``SOLVERS`` through ``make_solver(m, ell, substrate="cuda").solve(b)``
    on the main path's system, each run with the launch counters set to 0
    just before it and read just after (:func:`run_main_path`); then
    p-BiCGStab with the block-Jacobi preconditioner of phase 2c.
    ssBiCGSafe2, p-BiCGSafe in exact arithmetic, must stay within 2
    iterations of it; CGS must end as the JAX package's does here
    (``EXPECT``)."""
    out = {m: run_main_path(torch, repro_torch, ops, m, ell, stencil, b,
                            label="comparison",
                            expect=EXPECT.get(m, "CONVERGED"))
           for m in COMPARISON}
    gap = out["ssbicgsafe2"]["iterations"] - out["p-bicgsafe"]["iterations"]
    if abs(gap) > 2:
        raise SystemExit(f"comparison: ssbicgsafe2 takes {gap:+d} iterations "
                         "against p-bicgsafe's")
    out["p-bicgstab block_jacobi"] = run_main_path(
        torch, repro_torch, ops, "p-bicgstab", ell, stencil, b,
        label="comparison block_jacobi", precond=pc)
    torch.cuda.empty_cache()
    return out


def count_method_kernels(torch, repro_torch, ell, b, pc, runs: dict) -> None:
    """Kernels per step on the card of each of 3f's solves, from profiler
    traces of two solves with tol 0 (no step converges), 16 and 48 steps
    long: the difference over 32 steps drops the set-up and keeps the
    loop's share of its host reads.  Run after every timed phase; the
    counts go into ``runs`` and one summary line is printed per solve."""
    for key, rec in runs.items():
        solver = repro_torch.make_solver(
            rec["method"], ell, substrate="cuda",
            precond=pc if "precond" in rec else None)
        k = [device_activity(torch, lambda: solver.solve(
            b, tol=0.0, maxiter=steps), reps=1)["kernels"]
            for steps in (16, 48)]
        rec["kernels_per_step"] = (k[1] - k[0]) / 32
        log(f"comparison {key:24s}: {rec['status']} in "
            f"{rec['iterations']} iterations "
            f"({rec['steps']} steps queued; reductions per iteration "
            f"{rec['reductions_per_iteration']}), true relres "
            f"{rec['true_relres']:.3e}, "
            f"max|x - 1| {rec['max_err']:.3e}, {rec['wall_s'] * 1e3:.1f} ms "
            f"to solution, {rec['ms_per_iteration']:.3f} ms per iteration, "
            f"{rec['kernels_per_step']:.2f} kernels per step")


def batched_rhs(torch, b):
    """3c's (n, M) block, column 0 = b, and its per-column tolerances."""
    gen = torch.Generator(device=b.device).manual_seed(3)
    B = torch.stack([b] + [torch.randn(b.shape[0], generator=gen,
                                       device=b.device, dtype=b.dtype)
                           for _ in range(M - 1)], dim=1)
    tol = torch.tensor([1e-8] * (M // 2) + [1e-6] * (M - M // 2),
                       dtype=b.dtype, device=b.device)
    return B, tol


def run_batched_path(torch, repro_torch, ops, ell, stencil, b, single_it):
    """One measured ``solve_many`` of an (n, M) block through the front
    door, with the launch counters set to 0 just before it and read just
    after."""
    B, tol = batched_rhs(torch, b)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    first_s = first_solve(torch, "batched solve_many", solver,  # not counted
                          lambda: solver.solve_many(B, tol=tol))
    solver.stats.update(steps=0, host_reads=0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve_many(B, tol=tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    its = [int(v) for v in res.iterations]
    true = (torch.linalg.vector_norm(B - stencil.matvec(res.x), dim=0)
            / torch.linalg.vector_norm(B, dim=0))
    steps = solver.stats["steps"]
    rec = dict(m=M, iterations=its, converged=[bool(v) for v in
                                               res.converged],
               tol=[float(v) for v in tol],
               relres=[float(v) for v in res.relres],
               true_relres=[float(v) for v in true], wall_s=wall,
               ms_per_step=wall / steps * 1e3,
               ms_per_iteration=wall / max(its) * 1e3, steps=steps,
               host_reads=solver.stats["host_reads"], launches=launches,
               single_rhs_iterations=single_it, first_solve_s=first_s,
               graphs=solver.stats["graphs"])
    log(f"batched solve_many: {json.dumps(rec)}")
    if not all(rec["converged"]):
        raise SystemExit(f"solve_many: a column did not converge: {rec}")
    if bool((true > 100 * tol).any()):
        raise SystemExit(f"solve_many: true residual above 100 x tol: {rec}")
    if abs(its[0] - single_it) > 2:
        raise SystemExit(f"solve_many: column 0 took {its[0]} iterations, "
                         f"the single-RHS solve of b {single_it}")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(fused_dots_batched=steps, fused_axpy_batched=steps,
                spmv_ell_batched=1 + 2 * steps)
    if launches != want or steps == 0:
        raise SystemExit(f"solve_many: launches {launches} != {want}")
    rec["eager_ms_per_step"] = eager_rerun(
        torch, "batched solve_many",
        lambda: (solver.solve_many(B, tol=tol), steps), res,
        rec["ms_per_step"], "step")
    # the device time of one step with every column live, queued back to
    # back (no host gaps); over the solve's wall time per step it is the
    # device's busy share
    from repro_torch.core import multirhs
    st0 = solver.init(B, tol=tol)
    body = multirhs._make_body(solver.sub, solver.block_matvec,
                               solver.config)
    rec["device_ms_per_step"] = device_ms(torch, lambda: body(st0),
                                          reps=STEP_REPS)
    rec["busy_share"] = rec["device_ms_per_step"] / rec["ms_per_step"]
    log(f"batched step: {rec['device_ms_per_step']:.4f} ms of device time "
        f"back to back; busy share {rec['busy_share']:.3f}")
    return rec


def run_guarded_path(torch, repro_torch, ops, ell, stencil, b, many, main):
    """Phase 3d: the guarded driver on 3c's block (clean, then with a NaN
    written into column 2 before chunk 1) and on b alone, each run with the
    launch counters set to 0 just before it and read just after."""
    from repro_torch.core import multirhs
    from repro_torch.resilience import ChunkFaultInjector, RecoveryPolicy
    B, tol = batched_rhs(torch, b)
    gs = repro_torch.make_solver(
        "p-bicgsafe", ell, substrate="cuda",
        recovery=RecoveryPolicy(chunk=16, substrate_fallback=False))
    first_solve(torch, "guarded", gs,                # warm-ups, not counted
                lambda: (gs.solve_many(B, tol=tol), gs.solve(b)))

    def measured(label, rhs, **kw):
        gs.events.clear()
        gs.stats.update(steps=0, host_reads=0)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = gs.solve(rhs) if rhs.dim() == 1 else gs.solve_many(rhs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        X = res.x.reshape(rhs.shape[0], -1)
        R = rhs.reshape(rhs.shape[0], -1)
        true = (torch.linalg.vector_norm(R - stencil.matvec(X), dim=0)
                / torch.linalg.vector_norm(R, dim=0))
        steps = gs.stats["steps"]
        rec = dict(
            run=label, iterations=res.iterations.reshape(-1).tolist(),
            status=[repro_torch.SolveStatus(int(v)).name
                    for v in res.status.reshape(-1)],
            true_relres=true.tolist(), finite=bool(torch.isfinite(X).all()),
            events=list(gs.events), wall_s=wall, steps=steps,
            ms_per_step=wall / max(steps, 1) * 1e3,
            host_reads=gs.stats["host_reads"], launches=dict(ops.LAUNCHES),
            ms_per_iteration=wall / max(res.iterations.max().item(), 1) * 1e3,
            graphs=gs.stats["graphs"])
        log(f"guarded {label}: {json.dumps(rec)}")
        tol_col = tol if rhs.dim() == 2 else torch.full_like(true, 1e-8)
        if rec["status"] != ["CONVERGED"] * len(rec["status"]) \
                or not rec["finite"] or bool((true > 100 * tol_col).any()):
            raise SystemExit(f"guarded {label}: a column failed: {rec}")
        return rec

    def want(**counts):
        return dict(dict.fromkeys(ops.LAUNCHES, 0), **counts)

    clean = measured("clean", B, tol=tol)
    steps = clean["steps"]
    same = clean["iterations"] == many["iterations"]
    log(f"guarded clean: iterations equal to 3c's: {same}")
    if clean["events"] or max(abs(a - c) for a, c in zip(
            clean["iterations"], many["iterations"])) > 2:
        raise SystemExit(f"guarded clean: events {clean['events']} or "
                         "iterations off 3c's by more than 2")
    if clean["launches"] != want(fused_dots_health_batched=steps,
                                 fused_axpy_batched=steps,
                                 spmv_ell_batched=1 + 2 * steps) \
            or steps == 0:
        raise SystemExit(f"guarded clean: launches {clean['launches']}")
    # one guarded step's device time back to back, beside 3c's
    sess = gs.session
    st0 = sess.init(B, tol=tol)
    body = multirhs._make_body(sess.sub, sess.block_matvec, sess.config)
    clean["device_ms_per_step"] = device_ms(torch, lambda: body(st0),
                                            reps=STEP_REPS)
    del st0
    log(f"guarded step: {clean['ms_per_step']:.4f} ms wall, "
        f"{clean['device_ms_per_step']:.4f} ms device, against 3c's "
        f"{many['ms_per_step']:.4f} / {many['device_ms_per_step']:.4f}: "
        f"x{clean['ms_per_step'] / many['ms_per_step']:.3f} wall, "
        f"x{clean['device_ms_per_step'] / many['device_ms_per_step']:.3f} "
        "device")

    gs.inject = ChunkFaultInjector(nan_at={1: (2,)})
    fault = measured("fault", B, tol=tol)
    gs.inject = None
    # the driver logs an action at the boundary after the chunk that found
    # it: the NaN written before chunk 1 is restarted at boundary 2
    if fault["events"] != [dict(event="restart", chunk=2, columns=[2])]:
        raise SystemExit(f"guarded fault: events {fault['events']}")
    fsteps = fault["steps"]
    if fault["launches"] != want(fused_dots_health_batched=fsteps,
                                 fused_axpy_batched=fsteps,
                                 spmv_ell_batched=1 + 2 * fsteps + 2):
        raise SystemExit(f"guarded fault: launches {fault['launches']}")

    one = measured("single", b)
    if abs(one["iterations"][0] - main["iterations"]) > 2:
        raise SystemExit(f"guarded single: {one['iterations'][0]} "
                         f"iterations, 3's solve of b {main['iterations']}")
    osteps = one["steps"]
    if one["launches"] != want(fused_dots_health=osteps,
                               fused_axpy_batched=osteps,
                               spmv_ell_batched=1 + 2 * osteps):
        raise SystemExit(f"guarded single: launches {one['launches']}")
    return dict(clean=clean, fault=fault, single=one)


def run_precond_path(torch, repro_torch, ops, ell, stencil, b, pc, main,
                     many) -> dict:
    """Phase 3e: preconditioned solves through the front door, each run
    with the launch counters set to 0 just before it and read just after.
    ``pc`` is the block-Jacobi preconditioner built in phase 2c from
    ``ell`` (sessions take the built instance: no second build)."""
    from repro_torch.core import multirhs
    from repro_torch.core.pipelined_bicgsafe import CHUNK
    B, tol = batched_rhs(torch, b)
    zero = dict.fromkeys(ops.LAUNCHES, 0)

    def measured(label, solver, rhs, want, **kw):
        first_s = first_solve(                           # warm-up, not counted
            torch, f"precond {label}", solver,
            lambda: solver.solve(rhs, **kw) if rhs.dim() == 1
            else solver.solve_many(rhs, **kw))
        solver.stats.update(steps=0, rr_steps=0, host_reads=0)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(rhs, **kw) if rhs.dim() == 1 \
            else solver.solve_many(rhs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        steps, rr_steps = solver.stats["steps"], solver.stats["rr_steps"]
        # true residuals of the preconditioned system (what tol bounds),
        # with the plain apply, and of the original one
        papply = solver.precond.apply
        resid = rhs - solver.operator.matvec(res.x)
        n = rhs.shape[0]
        prec_true = (torch.linalg.vector_norm(papply(resid).reshape(n, -1),
                                              dim=0)
                     / torch.linalg.vector_norm(papply(rhs).reshape(n, -1),
                                                dim=0))
        orig = (torch.linalg.vector_norm(resid.reshape(n, -1), dim=0)
                / torch.linalg.vector_norm(rhs.reshape(n, -1), dim=0))
        its = res.iterations.reshape(-1).tolist()
        rec = dict(
            run=label, precond=solver.precond.name, method=solver.method,
            iterations=its,
            converged=[bool(v) for v in res.converged.reshape(-1)],
            relres=res.relres.reshape(-1).tolist(),
            precond_true_relres=prec_true.tolist(),
            original_relres=orig.tolist(),
            max_err=float((res.x - 1.0).abs().max()) if rhs.dim() == 1
            else None,
            wall_s=wall, steps=steps, rr_steps=rr_steps,
            ms_per_step=wall / max(steps, 1) * 1e3,
            ms_per_iteration=wall / max(max(its), 1) * 1e3,
            host_reads=solver.stats["host_reads"], launches=launches,
            first_solve_s=first_s, graphs=solver.stats["graphs"])
        log(f"precond {label}: {json.dumps(rec)}")
        tol_col = tol if rhs.dim() == 2 else torch.full_like(prec_true, 1e-8)
        if not all(rec["converged"]) \
                or bool((prec_true > 100 * tol_col).any()):
            raise SystemExit(f"precond {label}: not converged to its tol: "
                             f"{rec}")
        expect = dict(zero, **want(steps, rr_steps))
        if launches != expect or steps == 0:
            raise SystemExit(f"precond {label}: launches {launches} != "
                             f"{expect}")
        if not max(its) + 1 <= steps <= max(its) + CHUNK:
            raise SystemExit(f"precond {label}: {steps} steps for {its}")
        return rec

    def single(steps, rr):
        spmv = 1 + 2 * steps + 4 * rr
        return dict(fused_dots=steps, fused_axpy=steps, spmv_ell=spmv,
                    block_jacobi_apply=spmv + 1)

    out = {}
    for method in ("p-bicgsafe", "p-bicgsafe-rr"):
        solver = repro_torch.make_solver(method, ell, substrate="cuda",
                                         precond=pc)
        out[method] = measured(f"block_jacobi {method}", solver, b, single,
                               tol=1e-8)
    pre = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                  precond=pc)
    rec = measured("block_jacobi solve_many", pre, B, lambda steps, rr: dict(
        fused_dots_batched=steps, fused_axpy_batched=steps,
        spmv_ell_batched=1 + 2 * steps,
        block_jacobi_apply_batched=2 + 2 * steps), tol=tol)
    st0 = pre.init(B, tol=tol)
    body = multirhs._make_body(pre.sub, pre.block_matvec, pre.config)
    rec["device_ms_per_step"] = device_ms(torch, lambda: body(st0),
                                          reps=STEP_REPS)
    del st0
    out["solve_many"] = rec
    log(f"precond step (n, {M}): {rec['ms_per_step']:.4f} ms wall, "
        f"{rec['device_ms_per_step']:.4f} ms device, against 3c's "
        f"{many['ms_per_step']:.4f} / {many['device_ms_per_step']:.4f}; "
        f"one RHS: {out['p-bicgsafe']['ms_per_step']:.4f} ms wall per step "
        f"against 3b's {main['wall_s'] / main['steps'] * 1e3:.4f}; "
        f"iterations {out['p-bicgsafe']['iterations'][0]} against "
        f"{main['iterations']}")
    torch.cuda.empty_cache()

    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                     precond="jacobi")
    out["jacobi"] = measured("jacobi", solver, b, lambda steps, rr: dict(
        fused_dots=steps, fused_axpy=steps, spmv_ell=1 + 2 * steps),
        tol=1e-8)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                     precond="neumann")
    # an apply of degree 2 runs 2 SpMVs: b's apply, then 3 per matvec
    out["neumann"] = measured("neumann", solver, b, lambda steps, rr: dict(
        fused_dots=steps, fused_axpy=steps,
        spmv_ell=2 + 3 * (1 + 2 * steps)), tol=1e-8)
    solver = repro_torch.make_solver("p-bicgsafe", stencil, substrate="cuda",
                                     precond="ssor")
    out["ssor"] = measured("ssor (Stencil7)", solver, b, lambda steps, rr: dict(
        fused_dots=steps, fused_axpy=steps), tol=1e-8)
    return out


def count_step_kernels(torch, repro_torch, ell, b, pc) -> dict:
    """Kernels per step on the card of 3c's step, of 3d's guarded step and
    of 3e's preconditioned (n, M) step, from a profiler trace; run after
    every timed phase, so the profiler touches no timing."""
    from repro_torch.core import multirhs
    from repro_torch.resilience import RecoveryPolicy
    B, tol = batched_rhs(torch, b)
    out = {}
    for label, recovery, precond in (
            ("batched", None, None),
            ("guarded", RecoveryPolicy(chunk=16), None),
            ("preconditioned", None, pc)):
        sess = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                       recovery=recovery, precond=precond)
        sess = getattr(sess, "session", sess)
        st0 = sess.init(B, tol=tol)
        body = multirhs._make_body(sess.sub, sess.block_matvec, sess.config)
        out[label] = device_activity(torch, lambda: body(st0))["kernels"]
        del st0
    log(f"kernels per step on the card: {json.dumps(out)}")
    return out


def latency_stats(lat_s, wall_s: float, chunks) -> dict:
    """Throughput over the burst, p50 / p99 latency and mean chunks
    resident of one serving mode."""
    lat = sorted(lat_s)
    return dict(requests_per_s=len(lat) / wall_s, wall_s=wall_s,
                p50_s=statistics.median(lat),
                p99_s=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                mean_chunks_resident=sum(chunks) / len(chunks))


def service_requests(n: int, seed: int):
    """The burst: SERVICE_REQUESTS right-hand sides from ``seed`` (numpy),
    the tolerances alternating SERVICE_TOLS."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((SERVICE_REQUESTS, n))
    tols = [SERVICE_TOLS[i % len(SERVICE_TOLS)]
            for i in range(SERVICE_REQUESTS)]
    return rhs, tols


def check_requests(torch, label, stencil, rhs, tols, got, ref, *,
                   batched: bool = True) -> None:
    """The bar of every served request: CONVERGED and a true relres at
    most 100x its tol; served by the batched iteration (``batched``), also
    its iterations within 2 of the same RHS's standalone ``solve_many``
    column (``ref``) and its ``x`` within 1e-6 of that column's, relative
    to its max-abs.  The gap and the error are printed either way: the
    sequential mode's single-RHS iteration rounds otherwise than the
    batched one, and on these rough right-hand sides the two stop several
    iterations apart in the JAX package as well
    (``tools/iteration_gap.py``)."""
    import numpy as np

    from repro_torch import SolveStatus
    bad = []
    for i, r in enumerate(got):
        dev = stencil.c.device
        x = torch.from_numpy(r["x"]).to(dev)
        b = torch.from_numpy(rhs[i]).to(dev)
        true = float(torch.linalg.vector_norm(b - stencil.matvec(x))
                     / torch.linalg.vector_norm(b))
        xref = ref[i]["x"]
        xerr = float(np.abs(r["x"] - xref).max() / np.abs(xref).max())
        r.update(true_relres=true, x_rel_err=xerr)
        if (r["status"] != SolveStatus.CONVERGED.name
                or not true <= 100 * tols[i]
                or (batched and (abs(r["iterations"]
                                     - ref[i]["iterations"]) > 2
                                 or not xerr <= 1e-6))):
            bad.append((i, r["status"], r["iterations"],
                        ref[i]["iterations"], true, xerr))
    worst = max(r["x_rel_err"] for r in got)
    log(f"service {label}: every request checked; worst true relres / tol "
        f"{max(r['true_relres'] / t for r, t in zip(got, tols)):.3f}, "
        f"worst x rel err {worst:.3e}, largest iteration gap "
        f"{max(abs(r['iterations'] - f['iterations']) for r, f in zip(got, ref))}")
    if bad:
        raise SystemExit(f"service {label}: requests off their bar "
                         f"(request, status, iterations, standalone, true "
                         f"relres, x rel err): {bad}")


def chunk_profile(torch, solve, trace: str) -> dict:
    """Kernels and device busy ms per step of ``solve(maxiter)`` (tol 0:
    no step stops), from profiled solves of 16 and 32 steps, the
    difference over 16; and from the second, the NCCL kernels (their names
    hold "nccl") and for each the other kernels whose intervals overlap it
    (the compute stream's, which between an all-reduce's start and its
    wait are the matvec's)."""
    recs = [profile_device(torch, lambda: solve(n), f"{trace}_{n}")
            for n in (16, 32)]
    nccl = [[e for e in r["kernel_events"] if "nccl" in e["name"].lower()]
            for r in recs]
    events = recs[1]["kernel_events"]
    return dict(
        kernels_per_step=(recs[1]["kernels"] - recs[0]["kernels"]) / 16,
        busy_ms_per_step=(recs[1]["busy_ms"] - recs[0]["busy_ms"]) / 16,
        nccl_kernels_per_step=(len(nccl[1]) - len(nccl[0])) / 16,
        nccl_kernel_names=sorted({e["name"][:60] for e in nccl[1]}),
        nccl_overlapped_kernels=[
            sum(1 for k in events if k is not e
                and k["ts"] < e["ts"] + e["dur"]
                and e["ts"] < k["ts"] + k["dur"]) for e in nccl[1]])


def run_mesh_path(torch, repro_torch, ops, stencil, b) -> dict:
    """Phase 3g: the distributed driver on the card at world 1.  A
    one-rank NCCL process group (``file://`` store under ``build/``) and
    its ``(1,)`` DeviceMesh; the Stencil7 form of 3a's system through
    ``make_solver(...).on_mesh(mesh)``, each solve run with the launch
    counters set to 0 just before it and read just after, and held to the
    same session's single-process solve: p-BiCGSafe bitwise, with its
    launches, one all-reduce started per step (the binding's
    ``SyncCounter``) and the NCCL kernels per step from profiled chunks;
    the seven methods (iterations, status and Table 3.1's reductions per
    step); ``solve_many`` of 3c's block, plain and guarded, bitwise, one
    (9, M) / (11, M) all-reduce per step; block-Jacobi bitwise.  Printed:
    ms per iteration, kernels and device ms per step on the mesh against
    single-process, and whether the NCCL kernel overlaps the matvec's."""
    log(f"mesh: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
        f"NCCL_SOCKET_IFNAME={os.environ.get('NCCL_SOCKET_IFNAME')}")
    sessions = []
    with one_rank_mesh(sessions) as mesh:
        out = _mesh_cases(torch, repro_torch, ops, stencil, b, mesh,
                          sessions)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def one_rank_mesh(sessions: list, shape=(1,), names=("rows",)):
    """A one-rank NCCL process group (``file://`` store under ``build/``)
    and its DeviceMesh of ``shape`` (ones) with the dimensions ``names``,
    for the length of a ``with``; the sessions put in ``sessions`` are
    released before the group goes (their programs hold it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = os.path.join(ROOT, "build", "nccl_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", shape, mesh_dim_names=names)
    finally:
        for sess in sessions:
            sess.release()
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def _mesh_solve(torch, ops, session, dsolver, call):
    """One measured mesh solve: counters, steps and reductions set to 0
    just before it and read just after."""
    session.stats.update(steps=0, rr_steps=0, host_reads=0)
    dsolver.syncs.calls = 0
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = session.stats["steps"]
    rec = dict(wall_s=wall, steps=steps, launches=dict(ops.LAUNCHES),
               syncs=dsolver.syncs.calls,
               syncs_per_step=(dsolver.syncs.calls - 1) / max(steps, 1))
    return res, rec


def _mesh_cases(torch, repro_torch, ops, stencil, b, mesh, sessions):
    grid = b.reshape(NX, NX, NX)
    kw = dict(tol=1e-8, maxiter=SOLVE_MAXITER)
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}

    # -- p-BiCGSafe: bitwise, launches, one all-reduce per step ------------
    solver = repro_torch.make_solver("p-bicgsafe", stencil, substrate="cuda")
    sessions.append(solver)
    first_solve(torch, "mesh p-bicgsafe single-process", solver,
                lambda: solver.solve(b, **kw))
    graphs = solver.stats["graphs"]
    dsolver = solver.on_mesh(mesh)
    first_solve(torch, "mesh p-bicgsafe on_mesh", solver,
                lambda: dsolver.solve(grid, **kw))
    mesh_graphs = solver.stats["graphs"] - graphs
    single = solver.solve(b, **kw)
    res, rec = _mesh_solve(torch, ops, solver, dsolver,
                           lambda: dsolver.solve(grid, **kw))
    steps = rec["steps"]
    x = res.x.reshape(-1)
    true = float(torch.linalg.vector_norm(b - stencil.matvec(x))
                 / torch.linalg.vector_norm(b))
    rec.update(iterations=int(res.iterations), true_relres=true,
               bitwise=bool(torch.equal(x, single.x)
                            and torch.equal(res.iterations,
                                            single.iterations)),
               chunks="CUDA graphs" if mesh_graphs else "eager",
               graphs=mesh_graphs)
    # ms per iteration, single-process and mesh in turns (s, m, m, s)
    times = {"single": [], "mesh": []}
    for mode in ("single", "mesh", "mesh", "single"):
        call = (lambda: solver.solve(b, **kw)) if mode == "single" \
            else (lambda: dsolver.solve(grid, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0)
                           / rec["iterations"] * 1e3)
    rec["ms_per_iteration"] = statistics.mean(times["mesh"])
    rec["single_ms_per_iteration"] = statistics.mean(times["single"])
    rec["eager_ms_per_iteration"] = eager_rerun(
        torch, "mesh p-bicgsafe",
        lambda: (dsolver.solve(grid, **kw), rec["iterations"]), res,
        rec["ms_per_iteration"], "iteration")
    # the device per step, single-process and mesh; the NCCL kernels
    single_prof = chunk_profile(
        torch, lambda n: solver.solve(b, tol=0.0, maxiter=n),
        "chip_smoke_single")
    rec.update(chunk_profile(
        torch, lambda n: dsolver.solve(grid, tol=0.0, maxiter=n),
        "chip_smoke_mesh"))
    rec["single_kernels_per_step"] = single_prof["kernels_per_step"]
    rec["single_busy_ms_per_step"] = single_prof["busy_ms_per_step"]
    want = dict(zero, fused_dots=steps, fused_axpy=steps)
    log(f"mesh p-bicgsafe: {json.dumps(rec)}")
    log(f"mesh p-bicgsafe: {rec['ms_per_iteration']:.4f} ms per iteration "
        f"on the mesh against {rec['single_ms_per_iteration']:.4f} "
        f"single-process (x{rec['ms_per_iteration'] / rec['single_ms_per_iteration']:.4f}"
        f", world 1); device per step {rec['busy_ms_per_step']:.4f} ms and "
        f"{rec['kernels_per_step']:.2f} kernels against "
        f"{rec['single_busy_ms_per_step']:.4f} ms and "
        f"{rec['single_kernels_per_step']:.2f}; chunks run as "
        f"{rec['chunks']} ({mesh_graphs} captured, the NCCL all-reduce in "
        f"them); {rec['syncs_per_step']:.3f} all-reduces started and "
        f"{rec['nccl_kernels_per_step']:.3f} NCCL kernels per step; the NCCL "
        f"kernels overlap {rec['nccl_overlapped_kernels'] or 'no'} other "
        "kernels" + ("" if rec["nccl_kernel_names"] else
                     " (NCCL launches no kernel for an in-place sum over "
                     "one rank)") + f" [{card()}]")
    if not rec["bitwise"] or not res.converged or true > 1e-6:
        raise SystemExit(f"mesh p-bicgsafe: not the single-process solve "
                         f"bit for bit, or not converged: {rec}")
    if rec["launches"] != want or steps == 0:
        raise SystemExit(f"mesh p-bicgsafe: launches {rec['launches']} != "
                         f"{want}")
    if rec["syncs"] != 1 + steps:
        raise SystemExit(f"mesh p-bicgsafe: {rec['syncs']} all-reduces for "
                         f"{steps} steps and the set-up's one")
    if rec["nccl_kernels_per_step"] > 1:
        raise SystemExit(f"mesh p-bicgsafe: {rec['nccl_kernels_per_step']} "
                         "NCCL kernels per step, more than the one "
                         "all-reduce started")
    out["p-bicgsafe"] = rec

    # -- the seven methods -------------------------------------------------
    out["methods"] = {}
    for method in COMPARISON:
        sess = repro_torch.make_solver(method, stencil, substrate="cuda")
        sessions.append(sess)
        single = sess.solve(b, **kw)
        d = sess.on_mesh(mesh)
        d.solve(grid, **kw)                          # captures, not counted
        res, m_rec = _mesh_solve(torch, ops, sess, d,
                                 lambda: d.solve(grid, **kw))
        status = repro_torch.SolveStatus(int(res.status)).name
        m_rec.update(
            iterations=int(res.iterations), status=status,
            single_iterations=int(single.iterations),
            single_status=repro_torch.SolveStatus(int(single.status)).name,
            bitwise=bool(torch.equal(res.x.reshape(-1), single.x)),
            ms_per_iteration=m_rec["wall_s"] / max(int(res.iterations), 1)
            * 1e3)
        log(f"mesh {method:14s}: {status} in {m_rec['iterations']} "
            f"iterations (single-process {m_rec['single_status']} in "
            f"{m_rec['single_iterations']}), {m_rec['syncs_per_step']:.3f} "
            f"all-reduces per step (Table 3.1: {REDUCTIONS[method]}), x "
            f"bitwise {m_rec['bitwise']}, {m_rec['ms_per_iteration']:.4f} ms "
            f"per iteration [{card()}]")
        if (m_rec["iterations"], status) != (m_rec["single_iterations"],
                                             m_rec["single_status"]) \
                or m_rec["syncs_per_step"] != REDUCTIONS[method]:
            raise SystemExit(f"mesh {method}: {m_rec}")
        out["methods"][method] = m_rec

    # -- solve_many, plain and guarded ---------------------------------------
    B, _ = batched_rhs(torch, b)
    B_grid = B.reshape(NX, NX, NX, M)
    for guard in (False, True):
        label = "guarded solve_many" if guard else "solve_many"
        sess = repro_torch.make_solver(
            "p-bicgsafe", stencil, substrate="cuda",
            config=repro_torch.SolverConfig(guard=guard))
        sessions.append(sess)
        single = sess.solve_many(B, **kw)
        d = sess.on_mesh(mesh)
        d.syncs.shapes.clear()       # what the capture and the init start
        d.solve_many(B_grid, **kw)                   # captures, not counted
        res, m_rec = _mesh_solve(torch, ops, sess, d,
                                 lambda: d.solve_many(B_grid, **kw))
        steps = m_rec["steps"]
        rows = 11 if guard else 9
        m_rec.update(
            iterations=[int(v) for v in res.iterations],
            converged=bool(res.converged.all()),
            bitwise=bool(torch.equal(res.x.reshape(B.shape), single.x)
                         and torch.equal(res.iterations, single.iterations)),
            shapes=sorted(d.syncs.shapes),
            ms_per_step=m_rec["wall_s"] / max(steps, 1) * 1e3)
        want = dict(zero, fused_axpy_batched=steps)
        want["fused_dots_health_batched" if guard
             else "fused_dots_batched"] = steps
        log(f"mesh {label}: {json.dumps(m_rec)}")
        if not m_rec["bitwise"] or not m_rec["converged"] \
                or m_rec["shapes"] != [(1, M), (rows, M)] \
                or m_rec["syncs"] != 1 + steps \
                or m_rec["launches"] != want or steps == 0:
            raise SystemExit(f"mesh {label}: {m_rec}; launches want {want}")
        out[label] = m_rec

    # -- block-Jacobi, shard-local ----------------------------------------
    sess = repro_torch.make_solver("p-bicgsafe", stencil, substrate="cuda",
                                   precond="block_jacobi")
    sessions.append(sess)
    single = sess.solve(b, **kw)
    d = sess.on_mesh(mesh)
    d.solve(grid, **kw)                              # captures, not counted
    res, m_rec = _mesh_solve(torch, ops, sess, d,
                             lambda: d.solve(grid, **kw))
    m_rec.update(iterations=int(res.iterations),
                 single_iterations=int(single.iterations),
                 bitwise=bool(torch.equal(res.x.reshape(-1), single.x)),
                 block=tuple(sess.precond.inv_blocks.shape))
    log(f"mesh block_jacobi: {json.dumps(m_rec)} (Stencil7's block-Jacobi "
        "is one shared z-line block, applied by torch.matmul)")
    if not m_rec["bitwise"] or m_rec["iterations"] != \
            m_rec["single_iterations"] or not res.converged \
            or m_rec["syncs"] != 1 + m_rec["steps"]:
        raise SystemExit(f"mesh block_jacobi: {m_rec}")
    out["block_jacobi"] = m_rec
    return out


def run_service_path(torch, repro_torch, ops, ell, stencil, pc, seed):
    """Phase 5: the solve service at full size (see the module docstring):
    the burst served sequentially, in static batches and by the engine,
    the guarded run, the deadline, a block-Jacobi-registered run and the
    session cache's byte budget.  The engine's run is driven with the
    launch counters set to 0 just before it and read just after."""
    import numpy as np

    from repro_torch import SolverConfig, api
    from repro_torch.resilience import RecoveryPolicy, corrupt_engine_block
    from repro_torch.service import ServiceConfig, SolveEngine
    n, dev = ell.n, ell.values.device
    rhs, tols = service_requests(n, seed)
    cfg = SolverConfig(tol=1e-8, maxiter=SOLVE_MAXITER)
    scfg = dict(max_batch=M, chunk=SERVICE_CHUNK, substrate="cuda",
                tol=1e-8, maxiter=SOLVE_MAXITER, device=dev)
    session = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda",
                                      config=cfg, device=dev)
    out = {}

    # -- sequential: session.solve(b, tol=...) one at a time -------------
    def sequential():
        res, done = [], []
        t0 = time.perf_counter()
        for b, tol in zip(rhs, tols):
            steps0 = session.stats["steps"]
            r = session.solve(torch.from_numpy(b).to(dev), tol=tol)
            x = r.x.cpu().numpy()
            done.append(time.perf_counter() - t0)
            res.append(dict(x=x, iterations=int(r.iterations),
                            status=repro_torch.SolveStatus(int(r.status)).name,
                            chunks=(session.stats["steps"] - steps0)
                            / SERVICE_CHUNK))
        return res, done, time.perf_counter() - t0
    session.solve(torch.from_numpy(rhs[0]).to(dev), tol=tols[0])   # warm
    seq, seq_done, seq_wall = sequential()
    session.solve(torch.from_numpy(rhs[0]).to(dev), tol=1e-10)
    solve_programs = sum(1 for k in session._programs if k[0] == "solve")
    out["sequential"] = latency_stats(seq_done, seq_wall,
                                      [r["chunks"] for r in seq])
    log(f"service sequential: {json.dumps(out['sequential'])}; solve "
        f"programs after tol 1e-8, 1e-6 and 1e-10: {solve_programs}")
    if solve_programs != 1:
        raise SystemExit(f"three tol overrides built {solve_programs} solve "
                         "programs, not 1")

    # -- static: solve_many on FIFO batches of M ------------------------
    def static():
        res, done = [], []
        t0 = time.perf_counter()
        for lo in range(0, SERVICE_REQUESTS, M):
            # one right-hand side per row on the host, transposed on the card
            B = torch.from_numpy(rhs[lo:lo + M]).to(dev).t()
            steps0 = session.stats["steps"]
            r = session.solve_many(B, tol=torch.tensor(
                tols[lo:lo + M], dtype=torch.float64, device=dev))
            x = r.x.t().contiguous().cpu().numpy()
            t = time.perf_counter() - t0
            chunks = (session.stats["steps"] - steps0) / SERVICE_CHUNK
            for j in range(x.shape[0]):
                done.append(t)
                res.append(dict(
                    x=x[j], iterations=int(r.iterations[j]),
                    status=repro_torch.SolveStatus(int(r.status[j])).name,
                    chunks=chunks))
        return res, done, time.perf_counter() - t0
    static()                                                     # warm
    ref, st_done, st_wall = static()
    out["static"] = latency_stats(st_done, st_wall,
                                  [r["chunks"] for r in ref])
    log(f"service static: {json.dumps(out['static'])}")

    # -- engine: SolveEngine.run() on the burst --------------------------
    def engine_run(eng, name, k=SERVICE_REQUESTS, kw=None):
        for i in range(k):
            eng.submit(name, rhs[i], tol=tols[i], **(kw or {}))
        t0 = time.perf_counter()
        results = eng.run()
        return results, time.perf_counter() - t0

    eng = SolveEngine(ServiceConfig(**scfg))
    name = eng.register(ell)
    if eng.registry[name].session is not session:
        raise SystemExit("the engine's registry did not reuse the session")
    engine_run(eng, name, M + 3)             # warm: the chunk and the splice
    eng.stats.update(dict.fromkeys(eng.stats, 0))
    torch.cuda.synchronize()
    ops.reset_launches()
    results, eng_wall = engine_run(eng, name)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stats = dict(eng.stats)
    by_rid = {r.rid - (M + 3): r for r in results}
    served = [dict(x=by_rid[i].x, iterations=by_rid[i].iterations,
                   status=by_rid[i].status.name,
                   chunks=by_rid[i].telemetry.chunks_resident)
              for i in range(SERVICE_REQUESTS)]
    out["engine"] = latency_stats(
        [by_rid[i].telemetry.wall_s for i in range(SERVICE_REQUESTS)],
        eng_wall, [r["chunks"] for r in served])
    steps = stats["steps"]
    per_step = {k: launches[k] / steps for k in (
        "fused_dots_batched", "fused_axpy_batched", "spmv_ell_batched")}
    out["engine"].update(
        iterations=[r["iterations"] for r in served],
        stats=stats, launches=launches, launches_per_step=per_step,
        replays_per_chunk=stats["runs"] / stats["chunks"],
        host_reads_per_chunk=stats["host_reads"] / stats["chunks"],
        graphs=session.stats["graphs"])
    want = dict.fromkeys(launches, 0)
    want.update(fused_dots_batched=steps, fused_axpy_batched=steps,
                spmv_ell_batched=2 * steps + stats["admissions"] + 1)
    if launches != want or stats["runs"] != stats["chunks"] \
            or stats["host_reads"] != stats["chunks"]:
        raise SystemExit(f"service engine: launches {launches} != {want} "
                         f"or a chunk was not one replay and one read "
                         f"({stats})")
    # the device's busy share, from a profiled run of the same burst (not
    # the timed one)
    prof = profile_device(torch, lambda: engine_run(eng, name),
                          "chip_smoke_service_trace")
    prof["share"] = prof["busy_ms"] / 1e3 / prof["wall_s"]
    del prof["kernel_events"]           # tens of MB of JSON on the log
    out["engine"]["busy"] = prof
    log(f"service engine: {json.dumps(out['engine'])}")
    log(f"service throughput: engine {out['engine']['requests_per_s']:.3f} "
        f"req/s, static {out['static']['requests_per_s']:.3f}, sequential "
        f"{out['sequential']['requests_per_s']:.3f} (engine / sequential "
        f"x{out['engine']['requests_per_s'] / out['sequential']['requests_per_s']:.3f}"
        f"); busy share {prof['share']:.3f} [{card()}]")
    check_requests(torch, "engine", stencil, rhs, tols, served, ref)
    # static is the reference: its own true residuals
    check_requests(torch, "static", stencil, rhs, tols, ref, ref)
    check_requests(torch, "sequential", stencil, rhs, tols, seq, ref,
                   batched=False)

    # -- guarded: corrupt column 0 after the first chunk ----------------
    geng = SolveEngine(ServiceConfig(**scfg,
                                     recovery=RecoveryPolicy(max_retries=1)))
    gname = geng.register(ell)
    engine_run(geng, gname, M + 3)                               # warm
    geng.stats.update(dict.fromkeys(geng.stats, 0))
    ops.reset_launches()
    for i in range(SERVICE_GUARDED):
        geng.submit(gname, rhs[i], tol=tols[i])
    first = geng.poll()
    corrupt_engine_block(geng, gname, cols=[0])
    gres = {r.rid - (M + 3): r for r in first + geng.run()}
    torch.cuda.synchronize()
    glaunch = dict(ops.LAUNCHES)
    victim = gres[0]
    gap = max(abs(gres[i].iterations - served[i]["iterations"])
              for i in range(1, SERVICE_GUARDED))
    out["guarded"] = dict(
        victim=dict(status=victim.status.name, retries=victim.retries,
                    iterations=victim.iterations),
        statuses=sorted({r.status.name for r in gres.values()}),
        max_iteration_gap_to_unguarded=gap, launches=glaunch,
        steps=geng.stats["steps"])
    log(f"service guarded: {json.dumps(out['guarded'])}")
    if victim.status.name != "CONVERGED" or victim.retries != 1 \
            or out["guarded"]["statuses"] != ["CONVERGED"] or gap > 2 \
            or glaunch["fused_dots_health_batched"] != geng.stats["steps"] \
            or glaunch["fused_dots_batched"]:
        raise SystemExit(f"service guarded run off its bar: "
                         f"{out['guarded']}")

    # -- deadline ----------------------------------------------------------
    rid = eng.submit(name, rhs[0], tol=1e-14, deadline=0.05)
    dres = {r.rid: r for r in eng.run()}[rid]
    out["deadline"] = dict(status=dres.status.name,
                           deadline_exceeded=dres.telemetry.deadline_exceeded,
                           iterations=dres.iterations,
                           wall_s=dres.telemetry.wall_s)
    log(f"service deadline: {json.dumps(out['deadline'])}")
    if dres.status.name != "DEADLINE" or not \
            dres.telemetry.deadline_exceeded:
        raise SystemExit(f"service deadline off its bar: {out['deadline']}")

    # -- registered with 2c's block-Jacobi preconditioner ---------------
    beng = SolveEngine(ServiceConfig(**scfg))
    bname = beng.register(ell, precond=pc)
    ops.reset_launches()
    bres, _ = engine_run(beng, bname, SERVICE_BJ)
    torch.cuda.synchronize()
    out["block_jacobi"] = dict(
        launches=dict(ops.LAUNCHES), steps=beng.stats["steps"],
        statuses=sorted({r.status.name for r in bres}))
    log(f"service block_jacobi: {json.dumps(out['block_jacobi'])}")
    if out["block_jacobi"]["statuses"] != ["CONVERGED"] or \
            ops.LAUNCHES["block_jacobi_apply_batched"] \
            < 2 * beng.stats["steps"]:
        raise SystemExit(f"service block_jacobi off its bar: "
                         f"{out['block_jacobi']}")

    info = api.session_cache_info()
    budget = api._cache_budget(session)
    out["cache"] = dict(info, budget=budget)
    log(f"service: session cache {json.dumps(out['cache'])}")
    if info["bytes"] > budget:
        raise SystemExit("the cached sessions' programs exceed the budget")
    log_memory(torch, "5 (the service)")
    del eng, geng, beng, session
    return out


# ---------------------------------------------------------------------------
# phase 3h: traces and profiles
# ---------------------------------------------------------------------------

def _bitwise(torch, a, b) -> bool:
    """x, iterations, relres and status of two results, bit for bit."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "iterations", "relres", "status"))


def check_trace(label: str, trace, iterations: int, relres=None,
                complete: bool = True) -> None:
    """A single column's trace: the iteration channel stepping by 1 (a
    reused slot's predecessor would break it), the last row (iterations,
    the result's relres, CONVERGED), and with ``complete`` (the ring held
    the whole solve) the first row: iteration 0, relres 1.0 up to the two
    reductions' rounding (||r_0|| comes from the set-up's dot, the first
    relres from the fused dots)."""
    import numpy as np
    from repro_torch.core.types import TRACE_CHANNELS
    ch = {n: i for i, n in enumerate(TRACE_CHANNELS)}
    rows = trace.per_iteration()
    it = rows[:, ch["iteration"]] if len(rows) else np.zeros(0)
    ok = bool(len(rows)) and (not complete or (
        it[0] == 0 and abs(rows[0, ch["relres"]] - 1.0) <= 1e-12)) \
        and bool((np.diff(it) == 1).all()) and it[-1] == iterations \
        and rows[-1, ch["status"]] == 1 \
        and (relres is None or rows[-1, ch["relres"]] == relres)
    if not ok:
        raise SystemExit(f"{label}: the trace's rows are off: first "
                         f"{rows[:1].tolist()}, last {rows[-1:].tolist()}, "
                         f"{iterations} iterations, relres {relres}")


def check_splice_reset(label: str, results, chunk: int, slots: int) -> int:
    """The engine's traces from a ring that held the block's whole run (no
    wrap): in each request's column no finite row lies before its admission
    chunk (the block's step count advances by at most ``chunk`` a chunk,
    so the admission slot is at least ``steps - chunks_resident * chunk``;
    a predecessor's leaked rows would start a whole chunk before it), the
    finite rows are one unbroken run, and ``check_trace`` holds with its
    first row.  Returns how many requests reused a slot (their first row
    after slot 0), which must be all but the first fill's ``slots``."""
    import numpy as np
    from repro_torch.core.types import TRACE_CHANNELS
    it_ch = TRACE_CHANNELS.index("iteration")
    reused = 0
    for r in results:
        tr = r.trace
        it = tr.rows()[:, it_ch]
        live = np.flatnonzero(np.isfinite(it))
        earliest = tr.steps - r.telemetry.chunks_resident * chunk
        ok = tr.steps <= tr.cap and len(live) > 0 \
            and live[0] >= earliest \
            and len(live) == live[-1] - live[0] + 1 \
            and len(tr.per_iteration()) == r.iterations + 1
        if not ok:
            raise SystemExit(
                f"{label} request {r.rid}: a reused slot kept rows from "
                f"before its admission (first row at slot "
                f"{live[:1].tolist()}, admitted at slot {earliest} or "
                f"later, {len(live)} rows for {r.iterations} iterations)")
        check_trace(f"{label} request {r.rid}", tr, r.iterations, r.relres)
        reused += bool(live[0] > 0)
    if reused < len(results) - slots:
        raise SystemExit(f"{label}: only {reused} of {len(results)} requests "
                         "reused a slot")
    return reused


def run_observe_path(torch, repro_torch, ops, ell, stencil, b, main, many,
                     service, seed) -> dict:
    """Phase 3h: the trace ring and the profiles on 3a's system (see the
    module docstring).  Each traced run is driven with the launch counters
    set to 0 just before it and read just after."""
    import numpy as np

    from repro_torch import SolverConfig
    from repro_torch.observe import profile as oprofile
    from repro_torch.resilience import RecoveryPolicy
    from repro_torch.service import ServiceConfig, SolveEngine
    kw = dict(tol=1e-8, maxiter=SOLVE_MAXITER)
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    out = {"single": {}, "launches": {}}

    def counted(call):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(ops.LAUNCHES)

    # -- traced single-RHS solves ------------------------------------------
    for method in OBSERVE_METHODS:
        solver = repro_torch.make_solver(method, ell, substrate="cuda")
        solver.solve(b, **kw)                      # warm: the captures
        solver.solve(b, trace=True, **kw)
        # untraced and traced in turns (u, t, t, u), each counted
        runs = {False: [], True: []}
        for traced in (False, True, True, False):
            runs[traced].append(counted(
                lambda: solver.solve(b, trace=traced or None, **kw)))
        (res0, _, l0), (res1, _, l1) = runs[False][0], runs[True][0]
        wall0 = statistics.mean(r[1] for r in runs[False])
        wall1 = statistics.mean(r[1] for r in runs[True])
        it = int(res0.iterations)
        hist = repro_torch.make_solver(
            method, ell, substrate="cuda",
            config=SolverConfig(record_history=True)).solve(b, **kw)
        ring = solver.solve(b, trace=OBSERVE_RING, **kw)
        plain_prof = chunk_profile(
            torch, lambda n: solver.solve(b, tol=0.0, maxiter=n),
            f"chip_smoke_observe_{method}_plain")
        traced_prof = chunk_profile(
            torch, lambda n: solver.solve(b, tol=0.0, maxiter=n,
                                          trace=OBSERVE_RING),
            f"chip_smoke_observe_{method}_traced")
        tr = res1.trace
        rec = dict(
            iterations=it, bitwise=_bitwise(torch, res0, res1),
            trace_steps=tr.steps, cap=tr.cap,
            relres_is_history=bool(np.array_equal(
                tr.channel("relres")[:it + 1],
                hist.residual_history[:it + 1].cpu().numpy())),
            ring_is_the_last_rows=bool(
                _bitwise(torch, res0, ring) and ring.trace.steps == tr.steps
                and np.array_equal(ring.trace.rows(),
                                   tr.rows()[-OBSERVE_RING:],
                                   equal_nan=True)),
            first_relres=float(tr.per_iteration()[0, 1]),
            launches=l0, traced_launches=l1,
            ms_per_iteration=wall0 / it * 1e3,
            traced_ms_per_iteration=wall1 / it * 1e3,
            kernels_per_step=plain_prof["kernels_per_step"],
            traced_kernels_per_step=traced_prof["kernels_per_step"],
            busy_ms_per_step=plain_prof["busy_ms_per_step"],
            traced_busy_ms_per_step=traced_prof["busy_ms_per_step"])
        log(f"observe {method}: {json.dumps(rec)}")
        log(f"observe {method}: traced {rec['traced_ms_per_iteration']:.4f} "
            f"ms per iteration against {rec['ms_per_iteration']:.4f} "
            f"untraced; {rec['traced_kernels_per_step']:.2f} kernels per "
            f"step against {rec['kernels_per_step']:.2f} [{card()}]")
        check_trace(f"observe {method}", tr, it, float(res0.relres))
        if not (rec["bitwise"] and rec["relres_is_history"]
                and rec["ring_is_the_last_rows"] and l1 == l0
                and tr.steps == it + 1 and res0.converged
                and all(l1[k] for k in ("fused_dots", "spmv_ell"))):
            raise SystemExit(f"observe {method}: {rec}")
        out["single"][method] = rec
        if method == "p-bicgsafe":
            out["launches"].update({k: l1[k] for k in SINGLE})
    torch.cuda.empty_cache()

    # -- traced batched and guarded solves ------------------------------------
    B, tol = batched_rhs(torch, b)
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    solver.solve_many(B, tol=tol, trace=True)                 # warm
    plain = solver.solve_many(B, tol=tol)
    traced, _, lb = counted(lambda: solver.solve_many(B, tol=tol, trace=True))
    rec = dict(bitwise=_bitwise(torch, plain, traced),
               iterations=[int(v) for v in traced.iterations],
               steps=traced.trace.steps, launches=lb)
    for j in range(M):
        check_trace(f"observe solve_many column {j}", traced.trace.column(j),
                    int(traced.iterations[j]), float(traced.relres[j]))
    out["launches"].update({k: lb[k] for k in BATCHED})
    # the guarded ring holds the whole solve (SOLVE_MAXITER rows), so its
    # first rows are checked too
    guarded = {}
    for cap in (0, SOLVE_MAXITER):
        g = repro_torch.make_solver(
            "p-bicgsafe", ell, substrate="cuda",
            config=SolverConfig(trace_cap=cap),
            recovery=RecoveryPolicy(chunk=16))
        many_g, _, lg = counted(lambda: g.solve_many(B, tol=tol))
        single_g, _, ls = counted(lambda: g.solve(b, **kw))
        guarded[cap] = (many_g, single_g, g.events)
    (m0, s0, e0), (m1, s1, e1) = guarded[0], guarded[SOLVE_MAXITER]
    rec.update(guarded_bitwise=_bitwise(torch, m0, m1)
               and _bitwise(torch, s0, s1), guarded_events=e0 + e1,
               guarded_launches=lg, guarded_single_launches=ls,
               guarded_whole=m1.trace.steps <= m1.trace.cap
               and s1.trace.steps <= s1.trace.cap)
    for j in range(M):
        check_trace(f"observe guarded column {j}", m1.trace.column(j),
                    int(m1.iterations[j]), float(m1.relres[j]),
                    complete=m1.trace.steps <= m1.trace.cap)
    check_trace("observe guarded solve(b)", s1.trace, int(s1.iterations),
                float(s1.relres), complete=s1.trace.steps <= s1.trace.cap)
    out["launches"].update(
        fused_dots_health_batched=lg["fused_dots_health_batched"],
        fused_dots_health=ls["fused_dots_health"])
    log(f"observe batched and guarded: {json.dumps(rec)}")
    if not (rec["bitwise"] and rec["guarded_bitwise"]
            and rec["guarded_whole"]) or e0 or e1 \
            or not all(lb[k] for k in BATCHED) \
            or not lg["fused_dots_health_batched"] \
            or not ls["fused_dots_health"]:
        raise SystemExit(f"observe batched and guarded: {rec}")
    out["batched"] = rec
    del plain, traced, guarded, m0, m1, s0, s1
    torch.cuda.empty_cache()

    # -- the traced mesh at world 1 -------------------------------------------
    grid = b.reshape(NX, NX, NX)
    sessions = []
    with one_rank_mesh(sessions) as mesh:
        sess = repro_torch.make_solver("p-bicgsafe", stencil,
                                       substrate="cuda")
        sessions.append(sess)
        single = sess.solve(b, trace=True, **kw)
        d = sess.on_mesh(mesh)
        d.solve(grid, trace=True, **kw)              # captures, not counted
        res, m_rec = _mesh_solve(torch, ops, sess, d,
                                 lambda: d.solve(grid, trace=True, **kw))
        m_rec.update(
            iterations=int(res.iterations),
            ring_bitwise=bool(res.trace.steps == single.trace.steps
                              and np.array_equal(res.trace.buffer,
                                                 single.trace.buffer,
                                                 equal_nan=True)),
            x_bitwise=bool(torch.equal(res.x.reshape(-1), single.x)))
        log(f"observe mesh: {json.dumps(m_rec)}")
        if not (m_rec["ring_bitwise"] and m_rec["x_bitwise"]) \
                or m_rec["syncs"] != 1 + m_rec["steps"]:
            raise SystemExit(f"observe mesh: {m_rec}")
        out["mesh"] = m_rec
    torch.cuda.empty_cache()

    # -- profiles -------------------------------------------------------------
    out["profiles"] = {}
    solver = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    for entry, call, dots, ref in (
            ("solve", lambda **k: solver.solve(b, **kw, **k), "fused_dots",
             main),
            ("solve_many", lambda **k: solver.solve_many(B, tol=tol, **k),
             "fused_dots_batched", many)):
        res, _, lp = counted(call)
        where = os.path.join(OBSERVE_DIR, "profile", entry)
        prof_res = call(profile=where)
        rep = solver.last_profile
        with open(os.path.join(where, "kernel_map.json")) as fh:
            kmap = json.load(fh)["kernels"]
        events = oprofile.phase_events(rep.timeline_path, kmap)
        reduce_kernels = sum(e["phase"] == "reduce" for e in events)
        # what the learnt map buys over the name rules alone: the mapped
        # names the rules class otherwise, and their device time here
        rules = oprofile.analyze_timeline(rep.timeline_path,
                                          iterations=rep.iterations)
        differ = {n: oprofile.classify_op(n, t) for n, t in kmap.items()
                  if oprofile.classify_op(n, t) != oprofile.classify_op(n)}
        moved_us = {}
        for e in events:
            if e["name"] in differ:
                key = f"{differ[e['name']]}: {e['name'][:72]}"
                moved_us[key] = moved_us.get(key, 0.0) + e["dur"]
        its = int(res.iterations.max())
        p_rec = dict(
            label=rep.label, device_wall_us=rep.device_wall_us,
            phase_us=rep.phase_us, phase_ops=rep.phase_ops,
            n_device_events=rep.n_device_events,
            unmapped_ops=rep.unmapped_ops,
            overlap_efficiency=rep.overlap_efficiency,
            exposed_per_iter_us=rep.exposed_per_iter_us,
            iterations=rep.iterations, reduce_kernels=reduce_kernels,
            dots_launches=lp[dots], mapped_kernels=len(kmap),
            device_ms_per_iteration=rep.device_wall_us / 1e3 / its,
            wall_ms_per_iteration=ref["ms_per_iteration"],
            bitwise=_bitwise(torch, res, prof_res),
            name_rules_phase_us=rules.phase_us,
            name_rules_unmapped_ops=rules.unmapped_ops,
            map_moves_us=moved_us)
        log(f"observe profile {entry}: {json.dumps(p_rec)}")
        log(f"observe profile {entry}: the kernel map moves "
            f"{sum(moved_us.values()) / 1e3:.3f} ms of "
            f"{rep.device_wall_us / 1e3:.3f} ms device time to another "
            f"phase ({len(differ)} names); by the name rules alone: "
            + ", ".join(f"{k} {v / 1e3:.3f} ms"
                        for k, v in rules.phase_us.items()))
        log(f"observe profile {entry}: overlap efficiency "
            f"{rep.overlap_efficiency}, exposed per iteration "
            f"{rep.exposed_per_iter_us} us, {rep.unmapped_ops} unmapped ops "
            f"of {rep.n_device_events}; device "
            f"{p_rec['device_ms_per_iteration']:.4f} ms per iteration "
            f"against the untraced run's wall "
            f"{ref['ms_per_iteration']:.4f} [{card()}]")
        log(rep.render())
        if rep.n_device_events == 0 or rep.device_wall_us <= 0 \
                or not all(rep.phase_us[k] > 0
                           for k in ("matvec", "reduce", "axpy")) \
                or reduce_kernels != 2 * lp[dots] or not p_rec["bitwise"]:
            raise SystemExit(f"observe profile {entry}: {p_rec} (the reduce "
                             f"kernels must be the {dots} launches' two "
                             "kernels each)")
        out["profiles"][entry] = p_rec
    torch.cuda.empty_cache()

    # -- the service: phase 5's burst, traced; then a profiled run ------------
    rhs, tols = service_requests(ell.n, seed)
    scfg = dict(max_batch=M, chunk=SERVICE_CHUNK, substrate="cuda",
                tol=1e-8, maxiter=SOLVE_MAXITER, device=ell.values.device)

    def engine_run(eng, name, k):
        for i in range(k):
            eng.submit(name, rhs[i], tol=tols[i])
        t0 = time.perf_counter()
        results = eng.run()
        return results, time.perf_counter() - t0

    engines = {}
    for cap in (0, OBSERVE_RING, SOLVE_MAXITER):
        eng = SolveEngine(ServiceConfig(**scfg, trace_cap=cap))
        name = eng.register(ell)
        engine_run(eng, name, M + 3)               # warm, as phase 5's
        engines[cap] = (eng, name)
    # the burst untraced and traced in turns (u, t, t, u); the first traced
    # one counted and checked
    walls = {0: [], OBSERVE_RING: []}
    for cap in (0, OBSERVE_RING, OBSERVE_RING, 0):
        eng, name = engines[cap]
        eng.stats.update(dict.fromkeys(eng.stats, 0))
        torch.cuda.synchronize()
        ops.reset_launches()
        got, wall = engine_run(eng, name, SERVICE_REQUESTS)
        torch.cuda.synchronize()
        walls[cap].append(wall)
        if cap and len(walls[cap]) == 1:
            results, stats = got, dict(eng.stats)
            launches = dict(ops.LAUNCHES)
    by_rid = {r.rid - (M + 3): r for r in results}
    for i in range(SERVICE_REQUESTS):
        r = by_rid[i]
        if r.status.name != "CONVERGED":
            raise SystemExit(f"observe service: request {i} {r.status}")
        # the ring holds the last OBSERVE_RING steps of the block: all of a
        # request's only when it was resident for no more steps than that
        check_trace(f"observe service request {i}", r.trace, r.iterations,
                    r.relres, complete=r.telemetry.chunks_resident
                    * SERVICE_CHUNK <= OBSERVE_RING)
    s_rec = dict(
        requests_per_s=[SERVICE_REQUESTS / w for w in walls[OBSERVE_RING]],
        untraced_requests_per_s=[SERVICE_REQUESTS / w for w in walls[0]],
        replays_per_chunk=stats["runs"] / stats["chunks"],
        host_reads_per_chunk=stats["host_reads"] / stats["chunks"],
        iterations=[by_rid[i].iterations for i in range(SERVICE_REQUESTS)],
        stats=stats, launches=launches)
    s_rec["iterations_as_untraced"] = \
        s_rec["iterations"] == service["engine"]["iterations"]
    # the burst once more, its ring holding every request's whole residency
    # (SOLVE_MAXITER rows against some 900 steps): the splice's reset of
    # each reused slot, checked on every request
    eng, name = engines[SOLVE_MAXITER]
    eng.stats.update(dict.fromkeys(eng.stats, 0))
    whole, _ = engine_run(eng, name, SERVICE_REQUESTS)
    s_rec["reused_slots"] = check_splice_reset(
        "observe service, whole ring", whole, SERVICE_CHUNK, M)
    s_rec["whole_ring_iterations"] = sorted(
        (r.rid - (M + 3), r.iterations) for r in whole)
    s_rec["whole_ring_reads_per_chunk"] = \
        eng.stats["host_reads"] / eng.stats["chunks"]
    log(f"observe service: {json.dumps(s_rec)}")
    log(f"observe service: traced "
        f"{statistics.mean(s_rec['requests_per_s']):.3f} req/s against "
        f"{statistics.mean(s_rec['untraced_requests_per_s']):.3f} untraced "
        f"(each the mean of two runs in turns); "
        f"{s_rec['replays_per_chunk']:.2f} replays and "
        f"{s_rec['host_reads_per_chunk']:.2f} host reads per chunk "
        f"[{card()}]")
    if stats["runs"] != stats["chunks"] \
            or stats["host_reads"] != stats["chunks"] \
            or s_rec["whole_ring_reads_per_chunk"] != 1 \
            or [it for _, it in s_rec["whole_ring_iterations"]] \
            != service["engine"]["iterations"] \
            or not s_rec["iterations_as_untraced"] \
            or s_rec["launches"]["fused_dots_batched"] != stats["steps"]:
        raise SystemExit(f"observe service: {s_rec}")
    out["service"] = s_rec
    del engines, eng, results, by_rid, whole
    peng = SolveEngine(ServiceConfig(**scfg))
    pname = peng.register(ell)
    engine_run(peng, pname, M + 3)                 # warm: its captures
    where = os.path.join(OBSERVE_DIR, "profile", "engine")
    peng = SolveEngine(ServiceConfig(**scfg, profile_dir=where))
    pname = peng.register(ell)
    presults, _ = engine_run(peng, pname, M)
    rep = peng.last_profile
    e_rec = dict(label=rep.label, device_wall_us=rep.device_wall_us,
                 phase_us=rep.phase_us, n_device_events=rep.n_device_events,
                 unmapped_ops=rep.unmapped_ops,
                 overlap_efficiency=rep.overlap_efficiency,
                 statuses=sorted({r.status.name for r in presults}))
    log(f"observe profile engine: {json.dumps(e_rec)}")
    if rep.n_device_events == 0 or e_rec["statuses"] != ["CONVERGED"] \
            or not all(rep.phase_us[k] > 0
                       for k in ("matvec", "reduce", "axpy")):
        raise SystemExit(f"observe profile engine: {e_rec}")
    out["profiles"]["engine"] = e_rec
    del peng

    # -- the CLI --------------------------------------------------------------
    cli_dir = os.path.join(OBSERVE_DIR, "cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.observe", "smoke", "--out",
         cli_dir], env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    log(f"observe CLI: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {proc.stdout.strip()}")
    schemas = {}
    for fname, key in (("convergence.json", None), ("metrics.json", None),
                       ("spans.trace.json", "metadata")):
        path = os.path.join(cli_dir, fname)
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
            schemas[fname] = (data[key] if key else data).get("schema")
    prom = os.path.join(cli_dir, "metrics.prom")
    schemas["metrics.prom"] = os.path.exists(prom) and \
        os.path.getsize(prom) > 0
    log(f"observe CLI artifacts: {json.dumps(schemas)}")
    if proc.returncode != 0 or schemas != {
            "convergence.json": "repro.observe/convergence-trace/v1",
            "metrics.json": "repro.observe/metrics-snapshot/v1",
            "spans.trace.json": "repro.observe/chrome-trace/v1",
            "metrics.prom": True}:
        raise SystemExit(f"observe CLI: exit {proc.returncode}, artifacts "
                         f"{schemas}; stderr {proc.stderr[-2000:]}")
    out["cli"] = schemas
    log_memory(torch, "3h")
    return out


# ---------------------------------------------------------------------------
# phase 3i: the contract analyzer
# ---------------------------------------------------------------------------

def _statuses(record: dict) -> dict:
    return {f["contract"]: f["status"] for f in record["findings"]}


def _cell(record: dict) -> tuple:
    b = record["binding"]
    return (b["method"], b["substrate"], b["binding"], b["guard"],
            b["precond"], str(b["mesh_shape"]), record.get("scenario"))


def run_analysis_path(torch, repro_torch, ops, ell) -> dict:
    """Phase 3i: the contract analyzer on the card, with the launch
    counters set to 0 just before each part and read just after (fake
    mode: nothing may launch).  The full audit (116 matrix cells and the
    16 scenario rows, CUDA fake tensors; the scenario rows' problems are
    built on the card first, before the counters are zeroed) and the 5
    mesh cells on a one-rank NCCL mesh (3g's): no deviation, every cell's
    statuses and the method x substrate matrix those of the committed CPU
    artifact; then 3b's session's
    ``verify_contracts`` for ``solve`` and ``solve_many`` on the full
    system: every contract holds, ``kernel_backed`` with at least
    ``STEP_KERNEL_OPS`` kernel nodes."""
    from repro_torch.analysis import audit
    from repro_torch.scenarios import build_problem
    with open(AUDIT_ARTIFACT) as f:
        committed = json.load(f)
    specs = audit.audit_specs(quick=False)
    for kw in specs:
        if kw.get("operator_class"):
            build_problem(kw["operator_class"], device="cuda",
                          **kw["operator_params"])
    torch.cuda.synchronize()
    sessions = []
    ops.reset_launches()
    t0 = time.perf_counter()
    with one_rank_mesh(sessions) as mesh:
        art = audit.run_audit(quick=False, device="cuda", mesh=mesh)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    log(f"3i audit: {art['n_cells']} cells ({art['n_mesh_cells']} mesh, "
        f"{art['n_scenario_cells']} scenario rows, {art['n_devices']} "
        f"rank, on {art['device']}) in {wall:.2f} s "
        f"wall, {len(art['deviations'])} deviations, launches {launched}")
    log(audit.audit_table(art))
    want = {_cell(r): _statuses(r) for r in committed["reports"]}
    got = {_cell(r): _statuses(r) for r in art["reports"]}
    if not art["ok"] or launched or got != want \
            or art["matrix"] != committed["matrix"] \
            or art["n_cells"] != len(specs) + 5 \
            or art["n_scenario_cells"] != committed["n_scenario_cells"]:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise SystemExit(f"3i audit: ok {art['ok']}, launches {launched}, "
                         f"cells unlike the committed artifact: {diff}")
    out = dict(audit_wall_s=wall, n_cells=art["n_cells"],
               n_mesh_cells=art["n_mesh_cells"],
               n_scenario_cells=art["n_scenario_cells"], verify={})

    session = repro_torch.make_solver("p-bicgsafe", ell, substrate="cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    reports = session.verify_contracts(bindings=("single", "batched"))
    verify_s = time.perf_counter() - t0
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    for rep in reports:
        kb = rep.finding("kernel_backed")
        n_ops = int(kb.detail.split()[0]) if kb.status == "ok" else 0
        rec = dict(ok=rep.ok, kernel_ops=n_ops,
                   findings={f.contract: f.status for f in rep.findings},
                   kernels=list(kb.provenance))
        out["verify"][rep.spec.binding] = rec
        log(f"3i verify_contracts {rep.spec.label} (n = {ell.n}): "
            f"{json.dumps(rec)}")
        if not rep.ok or n_ops < STEP_KERNEL_OPS:
            raise SystemExit(f"3i verify_contracts {rep.spec.label}: "
                             f"{[f.to_dict() for f in rep.findings]}")
    log(f"3i verify_contracts: {verify_s:.2f} s wall for "
        f"{len(reports)} bindings, launches {launched} [{card()}]")
    if launched:
        raise SystemExit(f"3i verify_contracts launched kernels: {launched}")
    out["verify_s"] = verify_s
    return out


# ---------------------------------------------------------------------------
# phase 3j: the scenario registry
# ---------------------------------------------------------------------------

def _launched(ops) -> dict:
    return {k: v for k, v in ops.LAUNCHES.items() if v}


def run_seed_sweep(torch, repro_torch, ops) -> dict:
    """3j (a): ``run_sweep(quick=False, device="cuda")`` over the 17 seed
    scenarios, ``poisson-mesh`` on a one-rank NCCL mesh (3g's set-up), with
    the launch counters set to 0 just before it and read just after: every
    cell converged, oracle-verified and contract-clean, its iterations
    within ``SCENARIO_ITER_SLACK`` of the JAX package's committed artifact
    (read as JSON) and of the port's committed CPU artifact; the batched
    dots and update kernels launched once a step each by the two "cuda"
    cells, and no other kernel by any cell."""
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.sweep import run_sweep, sweep_table
    refs = {}
    for label, path in (("jax", JAX_SWEEP), ("cpu", TORCH_SWEEP)):
        with open(path) as f:
            refs[label] = {c["scenario"]: c["iterations"]
                           for c in json.load(f)["cells"]}
    ops.reset_launches()
    with one_rank_mesh([]) as mesh:
        art = run_sweep(quick=False, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    launched = _launched(ops)
    log(sweep_table(art))
    cuda_cells = [c["scenario"] for c in art["cells"]
                  if c["substrate"] == "cuda"]
    steps = {name: get_scenario(name).bind("cuda").stats["steps"]
             for name in cuda_cells}
    want = dict(fused_dots_batched=sum(steps.values()),
                fused_axpy_batched=sum(steps.values()))
    gaps = {c["scenario"]: (c["iterations"], refs["jax"][c["scenario"]],
                            refs["cpu"][c["scenario"]])
            for c in art["cells"]}
    rec = dict(n_cells=art["summary"]["n_cells"], claims=art["claims"],
               wall_s=art["summary"]["wall_s"], cuda_cells=cuda_cells,
               steps=steps, launches=launched,
               iterations_card_jax_cpu=gaps)
    log(f"3j sweep: {json.dumps(rec)} [{card()}]")
    off = {k: v for k, v in gaps.items()
           if max(abs(v[0] - v[1]), abs(v[0] - v[2])) > SCENARIO_ITER_SLACK}
    if art["summary"]["n_cells"] != 17 or not all(art["claims"].values()) \
            or off or launched != want or len(cuda_cells) != 2 \
            or not all(steps.values()):
        raise SystemExit(f"3j sweep: claims {art['claims']}, iterations "
                         f"off the references {off}, launches {launched} "
                         f"!= {want}")
    return rec


def scenario_launches(method: str, batched: bool, ell: bool, steps: int,
                      rr_steps: int) -> dict:
    """The launches of one "cuda" scenario solve of ``steps`` queued steps:
    the batched dots and update kernels once a step; a single-RHS solve as
    :func:`method_launches`, without the SpMVs on a matrix-free operator."""
    if batched:
        return dict(fused_dots_batched=steps, fused_axpy_batched=steps)
    out = method_launches(method, steps, rr_steps)
    if not ell:
        out.pop("spmv_ell")
    return out


def run_full_scenario(torch, repro_torch, ops, sc) -> dict:
    """3j (b), one full-size scenario: registered with the public
    ``register_scenario``, its problem built on the card (timed), bound
    with ``make_solver(scenario=...)``; a first solve (its captures
    included), then a second bind, which must be the same session, and the
    measured solve with the launch counters set to 0 just before it and
    read just after: converged, its plugin's oracle, the launches of each
    kernel per step, and no new graph captured."""
    from repro_torch.core.linear_operator import ELLOperator
    from repro_torch.scenarios import get_operator_class, register_scenario
    from repro_torch.scenarios.registry import _host
    from repro_torch.scenarios.sweep import _rhs_block
    register_scenario(sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = sc.problem()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    op, b, _ = problem
    batched = sc.resolved_binding() == "batched"
    rhs = _rhs_block(b, sc.batch) if batched else b
    session = repro_torch.make_solver(scenario=sc.name)

    def solve():
        return session.solve_many(rhs) if batched else session.solve(rhs)
    first_s = first_solve(torch, f"3j {sc.name}", session, solve)
    graphs = session.stats["graphs"]
    same = repro_torch.make_solver(scenario=sc.name) is session \
        and sc.bind() is session
    session.stats.update(steps=0, rr_steps=0, host_reads=0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launched(ops)
    steps, rr_steps = session.stats["steps"], session.stats["rr_steps"]
    it = int(_host(res.iterations).max())
    X = _host(res.x)
    X, B = (X, _host(rhs)) if batched else (X[:, None], _host(b)[:, None])
    oracle = get_operator_class(sc.operator.cls).oracle(problem, B, X,
                                                        sc.tol)
    want = scenario_launches(sc.method, batched, isinstance(op, ELLOperator),
                             steps, rr_steps)
    rec = dict(scenario=sc.name, operator=str(sc.operator), n=op.shape[0],
               m=sc.batch, method=sc.method, substrate=sc.substrate,
               problem_build_s=build_s, iterations=it,
               converged=bool(_host(res.converged).all()), oracle=oracle,
               wall_s=wall, ms_per_iteration=wall / max(it, 1) * 1e3,
               ms_per_step=wall / max(steps, 1) * 1e3, steps=steps,
               rr_steps=rr_steps, host_reads=session.stats["host_reads"],
               first_solve_s=first_s, graphs=session.stats["graphs"],
               new_graphs=session.stats["graphs"] - graphs,
               same_session=same, launches=launched)
    log(f"3j {sc.name}: {json.dumps(rec)} [{card()}]")
    if not (rec["converged"] and oracle["ok"] and same and steps
            and launched == want and rec["new_graphs"] == 0):
        raise SystemExit(f"3j {sc.name}: launches {launched} != {want}, "
                         f"{rec}")
    return rec


def run_scenario_service(torch, repro_torch, ops, seed: int) -> dict:
    """3j (c): ``SolveEngine.register_scenario("convdiff-108-cuda")`` serves
    ``SCENARIO_REQUESTS`` seeded right-hand sides (numpy, ``seed``), with
    the launch counters set to 0 just before the run and read just after:
    every request CONVERGED, its true relres within 100x its tol, the
    batched dots and update kernels once a step."""
    import numpy as np

    from repro_torch.service import ServiceConfig, SolveEngine
    eng = SolveEngine(ServiceConfig(max_batch=M, chunk=SERVICE_CHUNK,
                                    substrate="cuda", tol=1e-8,
                                    maxiter=SOLVE_MAXITER))
    name = eng.register_scenario("convdiff-108-cuda")
    entry = eng.registry[name]
    rhs = np.random.default_rng(seed).standard_normal(
        (SCENARIO_REQUESTS, entry.n))
    for b in rhs:
        eng.submit(name, b)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = sorted(eng.run(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launched(ops)
    op = entry.op
    true = []
    for r in results:
        x = torch.from_numpy(np.asarray(r.x)).to(op.device)
        b = torch.from_numpy(rhs[r.rid]).to(op.device)
        true.append(float(torch.linalg.vector_norm(b - op.matvec(x))
                          / torch.linalg.vector_norm(b)))
    steps = eng.stats["steps"]
    rec = dict(operator=name, requests=len(results), wall_s=wall,
               requests_per_s=len(results) / wall, steps=steps,
               chunks=eng.stats["chunks"], runs=eng.stats["runs"],
               host_reads=eng.stats["host_reads"],
               statuses=sorted({r.status.name for r in results}),
               iterations=[r.iterations for r in results],
               worst_true_relres=max(true), launches=launched)
    log(f"3j service: {json.dumps(rec)} [{card()}]")
    want = dict(fused_dots_batched=steps, fused_axpy_batched=steps)
    if len(results) != SCENARIO_REQUESTS or rec["statuses"] != ["CONVERGED"] \
            or max(true) > 100 * 1e-8 or launched != want:
        raise SystemExit(f"3j service: launches {launched} != {want}, "
                         f"{rec}")
    return rec


def run_scenario_path(torch, repro_torch, ops, main_iterations: int,
                      seed: int) -> dict:
    """Phase 3j: the scenario registry on the card (see the module
    docstring).  Starts from an empty session cache."""
    from repro_torch.scenarios import OperatorSpec, Scenario
    repro_torch.clear_session_cache()
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(sweep=run_seed_sweep(torch, repro_torch, ops), full={})
    total = collections.Counter(out["sweep"]["launches"])
    for sc in (
            Scenario("convdiff-108-cuda",
                     OperatorSpec.of("convection_diffusion", nx=NX,
                                     peclet=0.5),
                     substrate="cuda", tags=("full-size",)),
            Scenario("helmholtz-108-multirhs-cuda",
                     OperatorSpec.of("helmholtz_shifted", nx=NX),
                     substrate="cuda", batch=M, maxiter=4000,
                     tags=("full-size",)),
            Scenario("random-1m-ell-rr-cuda",
                     OperatorSpec.of("random_nonsym", n=NX ** 3,
                                     nnz_per_row=8, seed=5, fmt="ell"),
                     method="p-bicgsafe-rr", substrate="cuda",
                     tags=("full-size",))):
        rec = out["full"][sc.name] = run_full_scenario(torch, repro_torch,
                                                       ops, sc)
        total.update(rec["launches"])
        log_memory(torch, f"3j {sc.name}")
    conv = out["full"]["convdiff-108-cuda"]
    log(f"3j convdiff-108-cuda (Stencil7 form): {conv['iterations']} "
        f"iterations, 3b's ELL form {main_iterations} [{card()}]")
    out["service"] = run_scenario_service(torch, repro_torch, ops, seed)
    total.update(out["service"]["launches"])
    out["launches"] = dict(total)
    log(f"3j launches (sweep, the three full-size solves, the service): "
        f"{json.dumps(out['launches'])}")
    missing = [k for k in SCENARIO_KERNELS if not total[k]]
    if missing:
        raise SystemExit(f"3j: the scenario path launched no {missing}")
    return out


def check_session_budget(torch, repro_torch, ell) -> dict:
    """C16 on the card: SERVICE_SESSIONS (n, M) sessions of distinct
    operators (scaled copies of ``ell``) under a budget of about two
    sessions' bytes; the memory reserved must fall back under the budget
    plus one session."""
    import dataclasses

    from repro_torch import api
    copies = [dataclasses.replace(ell, values=ell.values * (1.0 + i / 8))
              for i in range(SERVICE_SESSIONS)]
    dev = ell.values.device
    B = torch.ones((ell.n, M), dtype=torch.float64, device=dev)
    repro_torch.clear_session_cache()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    first = repro_torch.make_solver("p-bicgsafe", copies[0],
                                    substrate="cuda", device=dev)
    first.solve_many(B, maxiter=32)
    one = first.nbytes
    budget = int(2.2 * one)
    saved = api._SESSION_CACHE_BYTES
    api._SESSION_CACHE_BYTES = budget
    try:
        peak = 0
        for op in copies[1:]:
            repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                    device=dev).solve_many(B, maxiter=32)
            peak = max(peak, torch.cuda.memory_reserved() - base)
        info = api.session_cache_info()
        del first
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base
    finally:
        api._SESSION_CACHE_BYTES = saved
    rec = dict(session_bytes=one, budget=budget, cache=info,
               reserved_above_base=held, peak_reserved_above_base=peak,
               base_reserved=base)
    log(f"C16: {json.dumps(rec)} [{card()}]")
    if info["bytes"] > budget or held > budget + one:
        raise SystemExit(f"C16: the card holds {held} bytes above the "
                         f"base, past the budget {budget} plus one "
                         f"session {one}")
    repro_torch.clear_session_cache()
    return rec


def flash_operands(torch, shape, dtype, seed):
    """qg (B, S, K, G, hd) and k, v (B, S, K, hd): the model's layout."""
    B, H, K, S, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*dims):
        return torch.randn(*dims, generator=g, device="cuda").to(dtype)

    return rnd(B, S, K, H // K, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)


def flash_row_err(got, want, hd: int):
    """The largest over the output rows (b, s, h) of max |got - want| over
    that row's max-abs; got and want are (B, S, H * hd)."""
    d = (got.float() - want.float()).unflatten(-1, (-1, hd)).abs().amax(-1)
    return float((d / want.float().unflatten(-1, (-1, hd)).abs().amax(-1))
                 .max())


def check_flash_kernel(torch, ops, ref) -> dict:
    """Phase 2d: the flash kernel against its plain version on the card;
    at the full shape also a bitwise repeat and the times."""
    F = torch.nn.functional
    out = {}
    for shape, causal, name in FLASH_CASES:
        dtype = getattr(torch, name)
        B, H, K, S, hd = shape
        qg, k, v = flash_operands(torch, shape, dtype, seed=S + hd)
        scale = 1.0 / hd ** 0.5
        q4 = qg.view(B, S, H, hd).transpose(1, 2)          # (B, H, S, hd)
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)      # (B, K, S, hd)

        def kernel():
            return ops.flash_attention(qg, k, v, scale=scale, causal=causal)

        def plain():
            return ref.flash_attention(q4, k4, v4, scale=scale,
                                       causal=causal)

        got = kernel()
        want = plain().transpose(1, 2).reshape(B, S, H * hd)
        diff = (got.float() - want.float()).abs().max()
        rec = dict(shape=list(shape), causal=causal, dtype=name,
                   err=flash_row_err(got, want, hd),
                   whole_err=float(diff / want.float().abs().max()),
                   max_abs_err=float(diff), tol=TOL_FLASH[name])
        del want
        if shape in FLASH_TIMED:
            rec["repeats_bitwise"] = all(torch.equal(kernel(), got)
                                         for _ in range(3))
            if not rec["repeats_bitwise"]:
                raise SystemExit(f"flash_attention {name}: a repeat is not "
                                 "bitwise equal")
            lib = [t.contiguous() for t in (q4, k4, v4)]
            item = torch.empty((), dtype=dtype).element_size()
            pairs = S * (S + 1) // 2 if causal else S * S
            nbytes = (2 * B * H + 2 * B * K) * S * hd * item
            flops = 4 * B * H * hd * pairs
            rec.update(
                ms=device_ms(torch, kernel),
                plain_ms=device_ms(torch, plain, reps=5),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    *lib, is_causal=causal, scale=scale, enable_gqa=True)),
                # fp32: three TF32 products at the tensor cores' TF32 rate,
                # the least this card needs for products that keep f32's
                # digits; the CUDA cores' bound printed beside it
                bound=(bound_ms(nbytes, 3 * flops, "tf32")
                       if name == "float32" else
                       bound_ms(nbytes, flops, name)))
            if name == "float32":
                rec["cuda_core_bound"] = bound_ms(nbytes, flops, name)
            del lib
        out[(shape, causal, name)] = rec
        times = "" if "ms" not in rec else (
            f" kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"library_ms {rec['library_ms']:.4f} bound_ms "
            f"{rec['bound'][0]:.4f} ({rec['bound'][1]})")
        if "ms" in rec:
            times += (f" (before the redesign {FLASH_MS_BEFORE[name]}, "
                      "PERF.md row 11, not this run; "
                      if shape == FLASH_SHAPE else " (")
            times += (f"{rec['ms'] / rec['library_ms']:.2f}x the library, "
                      f"{rec['ms'] / rec['bound'][0]:.2f}x the bound")
            if name == "float32":
                times += (f" of three TF32 products, "
                          f"{rec['ms'] / rec['cuda_core_bound'][0]:.2f}x the "
                          f"CUDA cores' bound "
                          f"{rec['cuda_core_bound'][0]:.4f}")
            times += f") [{card()}]"
        log(f"kernel flash_attention {shape} causal={causal} {name} "
            f"({FLASH_SOURCES[name].rsplit('/', 1)[1]}): "
            f"max_row_rel_err {rec['err']:.3e} (tol {rec['tol']:.0e}; over "
            f"the whole output's max-abs {rec['whole_err']:.3e}){times}")
        if not rec["err"] <= rec["tol"]:
            raise SystemExit(f"flash_attention {shape} {name}: error "
                             f"{rec['err']} above {rec['tol']}")
        del qg, k, v, q4, k4, v4, got
        torch.cuda.empty_cache()
    return out


def serve_prompts(torch, vocab: int):
    """Phase 4's prompts: SERVE_REQUESTS x SERVE_PROMPT tokens in [1,
    vocab) from a seeded generator (phase 4b draws them with qwen3-8b's
    vocab, the same tokens)."""
    g = torch.Generator().manual_seed(5)
    return [torch.randint(1, vocab, (SERVE_PROMPT,), generator=g).tolist()
            for _ in range(SERVE_REQUESTS)]


def warm_engine(torch, eng, prompts) -> None:
    """Serve the first 256 tokens of ``prompts`` (all of them: the measured
    batch size), 2 new tokens each: the prefill's kernels and the decode
    program of that batch size (its graph captured) are ready before the
    measured runs; then the engine's times are cleared."""
    from repro_torch.serve import Request
    for p in prompts:
        eng.submit(Request(prompt=p[:256], max_new_tokens=2))
    eng.run()
    eng.done.clear()
    eng.stats["prefill_s"].clear()
    eng.stats["decode_s"].clear()
    torch.cuda.synchronize()


def serve_eager_and_graphed(torch, ops, eng, prompts, label: str) -> dict:
    """``prompts`` (SERVE_NEW new tokens each) served twice on the warmed
    engine: once with its decode steps eager (``_eager_chunks``), then
    with each step one replay of its decode graph, the main path; each run
    with the launch counters set to 0 just before it and read just after.
    Fails unless both give the same greedy tokens and the graphed run
    captured nothing new.  Returns each run's record."""
    from repro_torch.core.program import _eager_chunks
    from repro_torch.serve import Request
    runs = {}
    for mode in ("eager", "graph"):
        graphs = eng.stats["decode_graphs"]
        eng.stats["prefill_s"].clear()
        eng.stats["decode_s"].clear()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with _eager_chunks() if mode == "eager" else contextlib.nullcontext():
            for p in prompts:
                eng.submit(Request(prompt=p, max_new_tokens=SERVE_NEW))
            done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        outputs = [r.output for r in done]
        eng.done.clear()
        dec = eng.stats["decode_s"]
        decode_ms = statistics.median(dec) * 1e3
        runs[mode] = dict(
            decode_program=eng.stats["decode_program"],
            new_graphs=eng.stats["decode_graphs"] - graphs, wall_s=wall,
            launches=launches, prefill_batches=len(eng.stats["prefill_s"]),
            prefill_ms=eng.stats["prefill_s"][0] * 1e3,
            decode_step_ms=decode_ms,
            decode_step_ms_range=[min(dec) * 1e3, max(dec) * 1e3],
            tokens_per_s=sum(len(o) for o in outputs) / wall,
            decode_tokens_per_s=len(prompts) / (decode_ms / 1e3),
            outputs=outputs)
    eager, graph = runs["eager"], runs["graph"]
    if graph["decode_program"] != "graph" or graph["new_graphs"] != 0 \
            or not eager["decode_program"].startswith("eager: "):
        raise SystemExit(f"{label}: decode programs "
                         f"{eager['decode_program']!r} / "
                         f"{graph['decode_program']!r}, "
                         f"{graph['new_graphs']} captures in the measured run")
    if graph["outputs"] != eager["outputs"]:
        raise SystemExit(f"{label}: the graphed decode's greedy tokens "
                         f"{graph['outputs']} differ from the eager decode's "
                         f"{eager['outputs']}")
    return runs


def decode_activity(torch, eng, tokens) -> dict:
    """What the device runs per decode step (profiler traces) on a fresh
    splice of ``tokens``' prefill: the eager step and the replay of the
    same batch size's graph; and where a replay, run under
    ``set_sync_debug_mode("error")``, synchronises (``None``: nowhere).
    Each advances the program's ``cache_len`` by one a step."""
    with torch.inference_mode():
        logits, pcache = eng.prefill(tokens)
        prog = eng._splice(pcache, logits[:, -1].argmax(dim=-1),
                           tokens.shape[1])
        del logits, pcache
        eager = device_activity(
            torch, lambda: prog._step(prog.tokens, prog.cache_len), reps=4)
        graph = device_activity(torch, prog.step, reps=4)
        replay_sync = sync_error(torch, prog.step)
    return dict(program=prog, eager=eager, graph=graph,
                replay_sync=replay_sync)


def log_decode_runs(label: str, runs: dict, act: dict, eng) -> dict:
    """Print both runs' prefill and decode walls, device time, kernels and
    busy share per step and tokens/s, the decode program and its memory;
    returns the record's decode fields.  Drops ``act``'s program (and its
    hold on the model)."""
    prog = act.pop("program")
    rec = dict(decode_program=runs["graph"]["decode_program"],
               eager_decode_program=runs["eager"]["decode_program"],
               decode_graphs=eng.stats["decode_graphs"],
               capture_s=eng.stats["capture_s"],
               graph_pool_bytes=prog.pool_bytes,
               decode_cache_bytes=prog.nbytes - prog.pool_bytes,
               replay_sync=act["replay_sync"])
    for mode in ("eager", "graph"):
        r, a = runs[mode], act[mode]
        r.update(decode_kernels_per_step=a["kernels"],
                 decode_device_ms_per_step=a["busy_ms"],
                 decode_busy_share=a["busy_ms"] / r["decode_step_ms"])
        log(f"{label} decode {mode}: prefill {r['prefill_ms']:.2f} ms, a "
            f"decode step {r['decode_step_ms']:.3f} ms (median; range "
            f"{r['decode_step_ms_range'][0]:.3f}-"
            f"{r['decode_step_ms_range'][1]:.3f}), {a['busy_ms']:.3f} ms of "
            f"device and {a['kernels']:.0f} kernels a step, busy "
            f"{r['decode_busy_share']:.3f}; {r['tokens_per_s']:.1f} tokens/s "
            f"over the run, {r['decode_tokens_per_s']:.1f} a decode step "
            f"[{card()}]")
    log(f"{label} decode program: {rec['decode_program']!r} (the eager run "
        f"{rec['eager_decode_program']!r}); {rec['decode_graphs']} graph "
        f"captured in {rec['capture_s']:.3f} s (warm-up included); the "
        f"graph pool {prog.pool_bytes:,} bytes, the cache "
        f"{rec['decode_cache_bytes']:,}; a replay synchronises: "
        f"{act['replay_sync'] or 'nowhere'}; the greedy tokens of both runs "
        f"identical")
    if act["replay_sync"] is not None:
        raise SystemExit(f"{label}: a replayed decode step synchronises: "
                         f"{act['replay_sync']}")
    return rec


def run_serving_path(torch, ops, flash_ms: float, flash32_ms: float) -> dict:
    """Phase 4: full-width qwen3-8b through the serving engine, warmed at
    the measured batch size, then the prompts served with the decode eager
    and graphed (:func:`serve_eager_and_graphed`; the graphed run is the
    main path); then the prefill logits with and without the kernel (not
    counted), and an fp32 prefill with the kernel, counted on its own.
    ``flash_ms`` / ``flash32_ms``: the kernel's device time at this shape
    in bf16 / fp32."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(SERVE_ARCH).replace(use_flash_kernel=True)
    scfg = ServeConfig(max_batch=SERVE_REQUESTS,
                       max_len=SERVE_PROMPT + 2 * SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.params.parameters())
    prompts = serve_prompts(torch, cfg.vocab_size)
    warm_engine(torch, eng, prompts)
    log(f"serving {SERVE_ARCH}: warmed at batch {SERVE_REQUESTS}, the decode "
        f"graph captured in {eng.stats['capture_s']:.3f} s")
    runs = serve_eager_and_graphed(torch, ops, eng, prompts,
                                   f"serving {SERVE_ARCH}")
    main = runs["graph"]
    launches, batches, outputs = (main["launches"], main["prefill_batches"],
                                  main["outputs"])
    for mode, r in runs.items():
        if r["launches"] != dict(dict.fromkeys(ops.LAUNCHES, 0),
                                 flash_attention=cfg.n_layers
                                 * r["prefill_batches"]) \
                or r["prefill_batches"] == 0:
            raise SystemExit(f"serving ({mode} decode): launches "
                             f"{r['launches']} for {r['prefill_batches']} "
                             f"prefill batches of {cfg.n_layers} layers")
    if [len(o) for o in outputs] != [SERVE_NEW] * SERVE_REQUESTS or not all(
            0 <= t < cfg.vocab_size for o in outputs for t in o):
        raise SystemExit(f"serving: bad outputs {outputs}")

    tokens = torch.tensor(prompts, device=eng.device)
    plain = cfg.replace(use_flash_kernel=False)
    last = {}
    with torch.inference_mode():
        for label, c in (("flash", cfg), ("plain", plain)):
            e = eng if c is cfg else ServingEngine(c, scfg, params=eng.params)
            logits, _ = e.prefill(tokens)
            last[label] = logits[:, -1].float()
            del logits, e
            torch.cuda.empty_cache()
    f32 = fp32_prefills(torch, ops, eng, cfg, scfg, tokens, last)
    finite = all(bool(torch.isfinite(t).all()) for t in last.values())

    def gap(a, b):
        return float((last[a] - last[b]).abs().max() / last[b].abs().max())

    err = gap("flash", "plain")
    agree = (last["flash"].argmax(-1) == last["plain"].argmax(-1)).tolist()
    first = [o[0] for o in outputs] == last["flash"].argmax(-1).tolist()
    prefill_ms = main["prefill_ms"]
    decode_ms = main["decode_step_ms"]
    # the device's share of a prefill and of a decode step, from traces
    # (not counted: the launch counters were read above)
    with torch.inference_mode():
        pre = device_activity(torch, lambda: eng.prefill(tokens), reps=1)
    act = decode_activity(torch, eng, tokens)
    torch.cuda.empty_cache()
    dec_rec = log_decode_runs(f"serving {SERVE_ARCH}", runs, act, eng)
    dec = act["graph"]
    eager = {k: v for k, v in runs["eager"].items() if k != "outputs"}
    rec = dict(
        arch=SERVE_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
        params=n_params, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
        new_tokens=SERVE_NEW, init_s=init_s, wall_s=main["wall_s"],
        prefill_batches=batches, launches=launches, prefill_ms=prefill_ms,
        decode_step_ms=decode_ms,
        decode_step_ms_range=main["decode_step_ms_range"],
        tokens_per_s=main["tokens_per_s"],
        decode_tokens_per_s=main["decode_tokens_per_s"],
        flash_share_of_prefill=flash_ms * launches["flash_attention"]
        / batches / prefill_ms,
        prefill_kernels=pre["kernels"], prefill_device_ms=pre["busy_ms"],
        prefill_busy_share=pre["busy_ms"] / prefill_ms,
        decode_kernels_per_step=dec["kernels"],
        decode_device_ms_per_step=dec["busy_ms"],
        decode_busy_share=dec["busy_ms"] / decode_ms, eager_decode=eager,
        **dec_rec,
        logits_finite=finite, logits_max_rel_err=err,
        logits_tol=SERVE_LOGITS_TOL, flash_vs_fp32=gap("flash", "fp32"),
        plain_vs_fp32=gap("plain", "fp32"), argmax_agree=agree,
        first_tokens_are_logits_argmax=first,
        fp32_launches=f32["launches"], fp32_prefill_ms=f32["prefill_ms"],
        fp32_logits_max_rel_err=gap("fp32_flash", "fp32"),
        fp32_logits_tol=SERVE_LOGITS_TOL_F32,
        fp32_tf32_control_logits_max_rel_err=gap("fp32_tf32", "fp32"),
        fp32_flash_share_of_prefill=flash32_ms
        * f32["launches"]["flash_attention"] / f32["prefill_ms"]["flash"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        outputs=outputs)
    log(f"serving: {json.dumps(rec)}")
    if not finite or not err <= SERVE_LOGITS_TOL:
        raise SystemExit(f"serving: prefill logits with the kernel off the "
                         f"plain path's by {err} (tol {SERVE_LOGITS_TOL}), "
                         f"finite {finite}")
    log(f"serving {SERVE_ARCH}: prefill {prefill_ms:.1f} ms for "
        f"{SERVE_REQUESTS} x {SERVE_PROMPT} tokens, decode "
        f"{decode_ms:.2f} ms per step, {rec['tokens_per_s']:.1f} tokens/s "
        f"over the run; the flash kernel is {rec['flash_share_of_prefill']:.3f}"
        f" of the prefill; device busy {rec['prefill_busy_share']:.3f} of "
        f"the prefill, {rec['decode_busy_share']:.3f} of a decode step "
        f"({rec['decode_kernels_per_step']:.0f} kernels per step)")
    if f32["launches"] != dict(dict.fromkeys(ops.LAUNCHES, 0),
                               flash_attention=cfg.n_layers):
        raise SystemExit(f"serving fp32: launches {f32['launches']} for one "
                         f"prefill of {cfg.n_layers} layers")
    if not rec["fp32_logits_max_rel_err"] <= SERVE_LOGITS_TOL_F32:
        raise SystemExit(f"serving fp32: prefill logits with the kernel off "
                         f"the plain path's by "
                         f"{rec['fp32_logits_max_rel_err']} (tol "
                         f"{SERVE_LOGITS_TOL_F32})")
    control = rec["fp32_tf32_control_logits_max_rel_err"]
    if not control > SERVE_LOGITS_TOL_F32:
        raise SystemExit(f"serving fp32: the plain prefill in one TF32 pass "
                         f"is within the bar ({control} <= "
                         f"{SERVE_LOGITS_TOL_F32}): it does not tell TF32 "
                         f"products from fp32 ones")
    log(f"serving {SERVE_ARCH} fp32: prefill {f32['prefill_ms']['flash']:.1f}"
        f" ms with the kernel ({f32['launches']['flash_attention']} "
        f"launches), {f32['prefill_ms']['plain']:.1f} ms without; the "
        f"kernel is {rec['fp32_flash_share_of_prefill']:.4f} of it; "
        f"last-position logits {rec['fp32_logits_max_rel_err']:.3e} off the "
        f"plain prefill's max-abs (tol {SERVE_LOGITS_TOL_F32:.0e}; the "
        f"plain prefill in one TF32 pass {control:.3e}) [{card()}]")
    del eng, tokens, last
    torch.cuda.empty_cache()
    return rec


def fp32_prefills(torch, ops, eng, cfg, scfg, tokens, last: dict) -> dict:
    """Phase 4's fp32 prefills of ``tokens`` on the bf16 engine's weights,
    without the kernel ("fp32") and with it ("fp32_flash"): each warmed
    once, then timed (synchronized) with its last-position logits kept in
    ``last``; the launch counters are set to 0 just before the timed
    prefill with the kernel and read just after.  Then the bar's control
    ("fp32_tf32"), untimed: the plain prefill with
    ``torch.backends.cuda.matmul.allow_tf32`` on (restored after), every
    product in one TF32 pass, as a kernel that lost fp32's digits would
    take its attention's."""
    from repro_torch.serve import ServingEngine
    runs = (("plain", "fp32", cfg.replace(use_flash_kernel=False,
                                          dtype=torch.float32)),
            ("flash", "fp32_flash", cfg.replace(dtype=torch.float32)))
    prefill_ms, launches = {}, None
    with torch.inference_mode():
        for key, label, c in runs:
            e = ServingEngine(c, scfg, params=eng.params)
            e.prefill(tokens)                        # warm-up
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            if key == "flash":
                ops.reset_launches()
            t0 = time.perf_counter()
            logits, _ = e.prefill(tokens)
            torch.cuda.synchronize()
            prefill_ms[key] = (time.perf_counter() - t0) * 1e3
            if key == "flash":
                launches = dict(ops.LAUNCHES)
            last[label] = logits[:, -1].float()
            del logits, e
            torch.cuda.empty_cache()
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            logits, _ = ServingEngine(runs[0][2], scfg,
                                      params=eng.params).prefill(tokens)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        last["fp32_tf32"] = logits[:, -1].float()
        del logits
        torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, launches=launches)


def sync_error(torch, fn):
    """``None`` when ``fn`` runs under ``torch.cuda.set_sync_debug_mode(
    "error")``, else where it synchronised: the error's first line and the
    innermost frame of the port that made the call."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return None
    except RuntimeError as err:
        torch.cuda.set_sync_debug_mode(0)
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if "repro_torch" in f.filename] or \
            traceback.extract_tb(err.__traceback__)
        f = frames[-1]
        where = f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} `{f.line}`"
        return f"{str(err).strip().splitlines()[0]} at {where}"


def moe_prefill_flop(cfg, B: int, S: int) -> float:
    """The products of one prefill of B x S tokens as the gather dispatch
    runs them: every capacity slot is a row of the experts' products."""
    from repro_torch.models import moe as mmoe
    N = B * S
    d, H, K, hd, ff, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff, cfg.moe_experts)
    G, _, C = mmoe.capacity(N, cfg)
    proj = 2 * N * d * (H * hd + 2 * K * hd) + 2 * N * H * hd * d
    attn = 4 * B * H * hd * (S * (S + 1) // 2)
    experts = 3 * 2 * G * E * C * d * ff
    shared = 3 * 2 * N * d * ff * cfg.moe_shared_experts
    router = 2 * N * d * E
    return cfg.n_layers * (proj + attn + experts + shared + router) \
        + 2 * N * d * cfg.vocab_size


def moe_decode_bytes(torch, model, cfg, B: int, cache_len: int) -> int:
    """The bytes a decode step of B tokens must read: every weight but the
    embedding table (B of its rows), each expert's included (the gather
    dispatch at decode size runs every expert), and the K/V cache rows up
    to the new one."""
    w = sum(p.numel() * p.element_size()
            for n, p in model.named_parameters() if n != "embed")
    w += B * cfg.d_model * model.embed.element_size()
    item = torch.empty((), dtype=cfg.dtype).element_size()
    kv = 2 * cfg.n_layers * B * (cache_len + 1) * cfg.n_kv_heads * cfg.hd \
        * item
    return w + kv


def run_moe_serving_path(torch, ops, flash_ms: float) -> dict:
    """Phase 4b: llama4-scout-17b-a16e at full width and depth MOE_LAYERS
    through the serving engine, on phase 4's prompts, with the launch
    counters set to 0 just before the measured run and read just after;
    then (not counted) the experts each layer chose with and without the
    kernel, one full-width MoE layer's gather against sort, the host-sync
    checks and the profiles.  ``flash_ms``: the kernel's device time at
    FLASH_SHAPE_MOE.  The model is freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step
    from repro_torch.models import moe as mmoe
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS,
                                       use_flash_kernel=True)
    scfg = ServeConfig(max_batch=SERVE_REQUESTS,
                       max_len=SERVE_PROMPT + 2 * SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.params.parameters())
    prompts = serve_prompts(torch, get_config(SERVE_ARCH).vocab_size)
    warm_engine(torch, eng, prompts)
    log(f"serving {MOE_ARCH}: warmed at batch {SERVE_REQUESTS}, the decode "
        f"graph captured in {eng.stats['capture_s']:.3f} s")
    runs = serve_eager_and_graphed(torch, ops, eng, prompts,
                                   f"serving {MOE_ARCH}")
    main = runs["graph"]
    launches, batches, outputs = (main["launches"], main["prefill_batches"],
                                  main["outputs"])
    serve_peak = torch.cuda.max_memory_allocated()
    for mode, r in runs.items():
        if r["launches"] != dict(dict.fromkeys(ops.LAUNCHES, 0),
                                 flash_attention=cfg.n_layers
                                 * r["prefill_batches"]) \
                or r["prefill_batches"] != 1:
            raise SystemExit(f"serving {MOE_ARCH} ({mode} decode): launches "
                             f"{r['launches']} for {r['prefill_batches']} "
                             f"prefill batches of {cfg.n_layers} layers")
    if [len(o) for o in outputs] != [SERVE_NEW] * SERVE_REQUESTS or not all(
            0 <= t < cfg.vocab_size for o in outputs for t in o):
        raise SystemExit(f"serving {MOE_ARCH}: bad outputs {outputs}")

    # the experts each layer chose in three prefills: with the kernel, on
    # the plain path, and on the plain path in fp32 (the control); forward
    # hooks on each layer's moe recompute its routing from its input, and
    # each block's input in the plain prefill is kept for the per-layer
    # check below
    from repro_torch.models.transformer import _positions
    tokens = torch.tensor(prompts, device=eng.device)
    plain = cfg.replace(use_flash_kernel=False)
    N, d = SERVE_REQUESTS * SERVE_PROMPT, cfg.d_model
    chosen, last, block_in, moe_in = {}, {}, {}, {}

    def route_hook(layer, label):
        def fn(mod, args, out):
            chosen[label][layer] = mmoe._route(
                mod.p, args[0].reshape(-1, d), cfg)[1]
            if layer == 0 and label == "plain":
                moe_in[0] = args[0].detach().clone()
        return fn

    def input_hook(layer):
        def fn(mod, args, out):
            block_in[layer] = args[0].detach().clone()
        return fn

    def hooked(label, inputs=False):
        chosen[label] = {}
        layers = list(enumerate(eng.params.layers))
        return [b.moe.register_forward_hook(route_hook(i, label))
                for i, b in layers] + [
            b.register_forward_hook(input_hook(i)) for i, b in layers
            if inputs]

    with torch.inference_mode():
        for label, c in (("flash", cfg), ("plain", plain),
                         ("fp32", plain.replace(dtype=torch.float32))):
            handles = hooked(label, inputs=label == "plain")
            try:
                e = ServingEngine(c, scfg, params=eng.params)
                logits, _ = e.prefill(tokens)
            finally:
                for h in handles:
                    h.remove()
            last[label] = logits[:, -1].float()
            del logits, e
            torch.cuda.empty_cache()
    last_rows = [(b + 1) * SERVE_PROMPT - 1 for b in range(SERVE_REQUESTS)]

    def compare(a, b):
        same = torch.stack([(chosen[a][i] == chosen[b][i]).all(-1)
                            for i in range(cfg.n_layers)])   # (L, N)
        # a token counts as diverged from the first layer it differs on
        alike = same.cumprod(0).bool()
        return dict(
            agree=float(same.float().mean()),
            per_layer=[round(float(v), 5) for v in same.float().mean(1)],
            alike_through=[round(float(v), 5)
                           for v in alike.float().mean(1)],
            prompts_same_route=[i for i, row in enumerate(last_rows)
                                if bool(same[:, row].all())],
            logits=[float((last[a][i] - last[b][i]).abs().max()
                          / last[b][i].abs().max())
                    for i in range(SERVE_REQUESTS)])

    routes = {f"{a}_vs_{b}": compare(a, b) for a, b in (
        ("flash", "plain"), ("flash", "fp32"), ("plain", "fp32"))}
    flips = {k: 1.0 - routes[f"{k}_vs_fp32"]["agree"]
             for k in ("flash", "plain")}
    finite = all(bool(torch.isfinite(t).all()) for t in last.values())
    # the share of (layer, token, k) choices the config's capacity drops
    dropped = sum(float((~mmoe.slots(chosen["flash"][i], cfg)[1]).sum())
                  for i in range(cfg.n_layers)) / (
        cfg.n_layers * N * cfg.moe_top_k)

    # each layer on the same input, with and without the kernel
    positions = _positions(cfg, SERVE_REQUESTS, SERVE_PROMPT, eng.device)
    layer_agree, layer_err = [], []
    with torch.inference_mode():
        for i, blk in enumerate(eng.params.layers):
            outs = {}
            for label, c in (("flash", cfg), ("plain", plain)):
                handles = hooked(label)
                try:
                    outs[label] = blk(block_in[i], positions, c)[0] \
                        .reshape(N, d).float()
                finally:
                    for h in handles:
                        h.remove()
            same = (chosen["flash"][i] == chosen["plain"][i]).all(-1)
            layer_agree.append(float(same.float().mean()))
            # a token routed alike may still lose its slot in one run and
            # keep it in the other (another token's flip moves the ranks)
            keep = {k: mmoe.slots(chosen[k][i], cfg)[1].reshape(N, -1)
                    for k in outs}
            same &= (keep["flash"] == keep["plain"]).all(-1)
            diff = (outs["flash"][same] - outs["plain"][same]).abs().max()
            layer_err.append(float(diff / outs["plain"][same].abs().max()))
            del outs, same, keep
    del chosen, block_in, blk        # blk: the last layer's weights

    # one full-width MoE layer on the prefill's tokens: gather with nothing
    # dropped (capacity factor E) against the dropless sort
    p0 = eng.params.layers[0].moe.p
    xl = moe_in.pop(0)
    wide = cfg.replace(moe_capacity_factor=float(cfg.moe_experts))
    with torch.inference_mode():
        _, keep = mmoe.slots(mmoe._route(p0, xl.reshape(-1, d), wide)[1],
                             wide)
        y_gather, _ = mmoe.moe_ffn(p0, xl, wide, impl="gather")
        y_sort, _ = mmoe.moe_ffn(p0, xl, wide, impl="sort")
        dispatch_err = float((y_gather.float() - y_sort.float()).abs().max()
                             / y_sort.float().abs().max())
        wide_keeps_all = bool(keep.all())
        del y_gather, y_sort, keep
        torch.cuda.empty_cache()
        layer_ms = dict(
            gather=device_ms(torch, lambda: mmoe.moe_ffn(p0, xl, cfg,
                                                         impl="gather"),
                             reps=5, trials=3),
            gather_no_drop=device_ms(torch, lambda: mmoe.moe_ffn(
                p0, xl, wide, impl="gather"), reps=5, trials=3))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        mmoe.moe_ffn(p0, xl, cfg, impl="sort")
        start.record()
        for _ in range(5):
            mmoe.moe_ffn(p0, xl, cfg, impl="sort")  # a host read each
        end.record()
        end.synchronize()
        layer_ms["sort_wall"] = start.elapsed_time(end) / 5
        torch.cuda.empty_cache()

        # host synchronisation at decode size: the gather layer must have
        # none, nor the whole step (below); the sort layer's one host read
        # is shown as the error it raises
        xd = xl[:, -1:].contiguous()                  # (B, 1, d)
        moe_sync = sync_error(torch, lambda: mmoe.moe_ffn(p0, xd, cfg,
                                                          impl="gather"))
        sort_sync = sync_error(torch, lambda: mmoe.moe_ffn(p0, xd, cfg,
                                                           impl="sort"))
    # the whole decode step with cache_len on the device, eagerly; the
    # device's share of a prefill and of a decode step, eager and replayed
    act = decode_activity(torch, eng, tokens)
    prog = act["program"]
    with torch.inference_mode():
        step_sync = sync_error(torch, lambda: decode_step(
            eng.params, cfg, prog.cache, prog.tokens, prog.cache_len))
        pre = device_activity(torch, lambda: eng.prefill(tokens), reps=1)
    del xd, prog
    del xl, p0
    dec_rec = log_decode_runs(f"serving {MOE_ARCH}", runs, act, eng)
    dec = act["graph"]
    eager = {k: v for k, v in runs["eager"].items() if k != "outputs"}
    prefill_ms = main["prefill_ms"]
    decode_ms = main["decode_step_ms"]
    flop = moe_prefill_flop(cfg, SERVE_REQUESTS, SERVE_PROMPT)
    dec_bytes = moe_decode_bytes(torch, eng.params, cfg, SERVE_REQUESTS,
                                 SERVE_PROMPT)
    rec = dict(
        arch=MOE_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
        experts=cfg.moe_experts, top_k=cfg.moe_top_k, params=n_params,
        weight_gb=sum(p.numel() * p.element_size()
                      for p in eng.params.parameters()) / 1e9,
        requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
        new_tokens=SERVE_NEW, init_s=init_s, wall_s=main["wall_s"],
        prefill_batches=batches, launches=launches, prefill_ms=prefill_ms,
        prefill_flop=flop, prefill_bound_ms=bound_ms(0, flop, "bfloat16")[0],
        decode_step_ms=decode_ms,
        decode_step_ms_range=main["decode_step_ms_range"],
        decode_bytes=dec_bytes,
        decode_bound_ms=bound_ms(dec_bytes, 0, "bfloat16")[0],
        tokens_per_s=main["tokens_per_s"],
        decode_tokens_per_s=main["decode_tokens_per_s"],
        flash_ms=flash_ms,
        flash_share_of_prefill=flash_ms * launches["flash_attention"]
        / batches / prefill_ms,
        prefill_kernels=pre["kernels"], prefill_device_ms=pre["busy_ms"],
        prefill_busy_share=pre["busy_ms"] / prefill_ms,
        decode_kernels_per_step=dec["kernels"],
        decode_device_ms_per_step=dec["busy_ms"],
        decode_busy_share=dec["busy_ms"] / decode_ms, eager_decode=eager,
        **dec_rec,
        routes=routes, flips_vs_fp32=flips, flip_ratio_bar=MOE_FLIP_RATIO,
        layer_route_agree=layer_agree, layer_route_agree_bar=MOE_ROUTE_AGREE,
        layer_out_err=layer_err, layer_out_tol=MOE_BF16_TOL,
        logits_finite=finite,
        capacity_dropped_share=dropped,
        dispatch_gather_vs_sort=dispatch_err,
        dispatch_tol=MOE_BF16_TOL, wide_capacity_keeps_all=wide_keeps_all,
        layer_ms=layer_ms, moe_layer_sync=moe_sync, sort_layer_sync=sort_sync,
        decode_step_sync=step_sync,
        serve_peak_memory_gb=serve_peak / 1e9,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        outputs=outputs)
    log(f"serving moe: {json.dumps(rec)}")
    del eng, tokens, last
    gc.collect()
    torch.cuda.empty_cache()
    log_memory(torch, "4b (the llama4 model freed)")
    if not finite:
        raise SystemExit(f"serving {MOE_ARCH}: non-finite prefill logits")
    if not min(layer_agree) >= MOE_ROUTE_AGREE or \
            not max(layer_err) <= MOE_BF16_TOL:
        raise SystemExit(f"serving {MOE_ARCH}: on the same input the blocks "
                         f"with and without the kernel chose the same "
                         f"experts on {layer_agree} of the tokens (bar "
                         f"{MOE_ROUTE_AGREE}), their outputs off by "
                         f"{layer_err} (tol {MOE_BF16_TOL})")
    if not flips["flash"] <= MOE_FLIP_RATIO * flips["plain"]:
        raise SystemExit(f"serving {MOE_ARCH}: the prefill with the kernel "
                         f"chose other experts than the fp32 prefill on "
                         f"{flips['flash']} of (layer, token), the plain "
                         f"bf16 prefill on {flips['plain']} (bar: at most "
                         f"{MOE_FLIP_RATIO}x)")
    if not (wide_keeps_all and dispatch_err <= MOE_BF16_TOL):
        raise SystemExit(f"serving {MOE_ARCH}: gather with capacity "
                         f"factor E (drops none: {wide_keeps_all}) off sort "
                         f"by {dispatch_err} (tol {MOE_BF16_TOL})")
    if moe_sync is not None or step_sync is not None:
        raise SystemExit(f"serving {MOE_ARCH}: at decode size the gather MoE "
                         f"layer synchronises {moe_sync or 'nowhere'}, the "
                         f"whole step with cache_len on the device "
                         f"{step_sync or 'nowhere'}")
    log(f"serving {MOE_ARCH} (depth {cfg.n_layers}, {n_params:,} "
        f"parameters, {rec['weight_gb']:.2f} GB; init {init_s:.1f} s, peak "
        f"{rec['peak_memory_gb']:.2f} GB): prefill {prefill_ms:.1f} ms for "
        f"{SERVE_REQUESTS} x {SERVE_PROMPT} tokens (its products "
        f"{flop / 1e12:.1f} TFLOP, bound {rec['prefill_bound_ms']:.1f} ms), "
        f"decode {decode_ms:.2f} ms per step (range "
        f"{rec['decode_step_ms_range'][0]:.2f}-"
        f"{rec['decode_step_ms_range'][1]:.2f}; {dec['busy_ms']:.2f} ms of "
        f"device, {dec['kernels']:.0f} kernels; the weight-read bound "
        f"{rec['decode_bound_ms']:.2f} ms for {dec_bytes / 1e9:.2f} GB), "
        f"{rec['tokens_per_s']:.1f} tokens/s over the run; the flash kernel "
        f"is {rec['flash_share_of_prefill']:.4f} of the prefill ({batches} "
        f"batch, {launches['flash_attention']} launches); device busy "
        f"{rec['prefill_busy_share']:.3f} of the prefill "
        f"({pre['busy_ms']:.1f} ms, {pre['kernels']:.0f} kernels), "
        f"{rec['decode_busy_share']:.3f} of a decode step [{card()}]")
    fvp = routes["flash_vs_plain"]
    log(f"serving {MOE_ARCH}: each layer on the same input, the experts "
        f"with and without the kernel agree on {min(layer_agree):.4f}-"
        f"{max(layer_agree):.4f} of the tokens (bar {MOE_ROUTE_AGREE}), "
        f"outputs {max(layer_err):.3e} apart (tol {MOE_BF16_TOL}); through "
        f"the stack the two bf16 prefills agree on {fvp['agree']:.4f} of "
        f"(layer, token) (layer 0 {fvp['per_layer'][0]:.4f}, layer "
        f"{cfg.n_layers - 1} {fvp['per_layer'][-1]:.4f}), prompts routed "
        f"alike in every layer {fvp['prompts_same_route']}, last logits "
        f"{[round(v, 4) for v in fvp['logits']]} apart; against the fp32 "
        f"prefill the kernel's choices differ on {flips['flash']:.4f}, the "
        f"plain bf16 path's on {flips['plain']:.4f} (bar: at most "
        f"{MOE_FLIP_RATIO}x); the capacity drops {dropped:.4f} of the "
        f"choices; one layer's gather (no drop) vs sort {dispatch_err:.3e} "
        f"(tol "
        f"{MOE_BF16_TOL}); the layer at {N:,} tokens: gather "
        f"{layer_ms['gather']:.3f} ms, gather no-drop "
        f"{layer_ms['gather_no_drop']:.3f}, sort (wall, one host read) "
        f"{layer_ms['sort_wall']:.3f} [{card()}]")
    log(f"serving {MOE_ARCH} host syncs at decode size: gather layer "
        f"{moe_sync or 'none'}; sort layer {sort_sync or 'none'}; the "
        f"whole decode step, cache_len a device tensor, {step_sync or 'none'}")
    return rec


def grouped_sizes(torch, R: int, E: int, seed: int):
    """The group sizes of a routing of R (token, k) pairs over E experts:
    each of R / 8 tokens picks 8 distinct experts at random (the decode
    step's shape: most experts empty, most of the hit ones one row); above
    that, a multinomial draw with expert 0 emptied and expert 1 given one
    row.  Returns the sizes (E,) int64 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    if R <= 64:
        picks = torch.stack([torch.randperm(E, generator=g)[:8]
                             for _ in range(R // 8)]).reshape(-1)
        return torch.bincount(picks, minlength=E)
    sizes = torch.multinomial(torch.ones(E), R, replacement=True,
                              generator=g)
    sizes = torch.bincount(sizes, minlength=E)
    sizes[2] += sizes[0] + sizes[1] - 1
    sizes[0], sizes[1] = 0, 1
    return sizes


def check_grouped_kernel(torch, ops, w, R: int, label: str, seed: int
                         ) -> dict:
    """``ops.grouped_mm`` on R seeded rows (in w's dtype) against the
    grouped kernel's plain version with the experts' weights ``w`` (E, K,
    N), on a routing with an empty group and a group of one row
    (:func:`grouped_sizes`): the route ``grouped_mm.route`` names, the one
    the call took (the route counters), its device time beside the plain
    version's (events around its calls, its host read included), one
    ``torch._grouped_mm`` call's where the card's torch takes the dtype,
    and the bound: the rows, the weights of the experts hit and the output,
    once each, over 3.35 TB/s, against the products over the dtype's peak
    (f32: three TF32 products at the tensor cores' TF32 rate, the least
    that keeps f32's digits, as the fp32 flash kernel's; the CUDA cores'
    bound beside it).  Each tile of the route (``grouped_mm.WGMMA_TILES``
    in bf16, ``MMA_TILES`` in f32 and f64) is also launched by name, held
    to the same bar and bitwise repeat, and timed in turns."""
    from repro_torch.kernels import grouped_mm
    E, K, N = w.shape
    dtype = str(w.dtype).replace("torch.", "")
    tol = GROUPED_TOL_OF[dtype]
    sizes = grouped_sizes(torch, R, E, seed)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(sizes, 0)]).to(w.device)
    g = torch.Generator(device=w.device).manual_seed(seed)
    x = torch.randn(R, K, generator=g, device=w.device, dtype=w.dtype)
    route = grouped_mm.route(w.dtype)
    grouped_mm.reset_route_launches()
    got = ops.grouped_mm(x, w, offsets)
    taken = [r for r, n in grouped_mm.ROUTE_LAUNCHES.items() if n]
    again = ops.grouped_mm(x, w, offsets)
    want = grouped_mm.plain(x, w, offsets)

    def rel(y):
        return float((y.double() - want.double()).abs().max()
                     / want.double().abs().max())

    err = rel(got)
    diff = (got.double() - want.double()).abs().max()
    hit = int((sizes > 0).sum())
    item = w.element_size()
    nbytes = (R * K + hit * K * N + R * N) * item + 8 * (E + 1)
    flop = 2.0 * R * K * N
    bound = (bound_ms(nbytes, 3 * flop, "tf32") if dtype == "float32"
             else bound_ms(nbytes, flop, dtype))
    ms = device_ms(torch, lambda: ops.grouped_mm(x, w, offsets), reps=10,
                   trials=3)
    tiles = {}
    names = list(grouped_mm.WGMMA_TILES if route == "wgmma"
                 else grouped_mm.MMA_TILES)
    for name in names:
        y1 = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=name)
        y2 = grouped_mm.grouped_mm_cuda(x, w, offsets, tile=name)
        tiles[name] = dict(err=rel(y1), repeats_bitwise=bool(
            torch.equal(y1, y2)), ms=[])
        del y1, y2
    for name in names + names[::-1]:                            # a b b a
        tiles[name]["ms"].append(device_ms(
            torch, lambda: grouped_mm.grouped_mm_cuda(
                x, w, offsets, tile=name), reps=10, trials=3))
    for name, r in tiles.items():
        r["ms"] = statistics.median(r["ms"])
        # the host's time to check and enqueue one call (its launch
        # arguments, and two tensor maps on the wgmma route), no sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            grouped_mm.grouped_mm_cuda(x, w, offsets, tile=name)
        r["host_us"] = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    grouped_mm.plain(x, w, offsets)
    start.record()
    for _ in range(3):
        grouped_mm.plain(x, w, offsets)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end) / 3
    library_ms, library_note, library_err = None, None, None
    ends = offsets[1:].to(torch.int32)
    try:
        lib = torch._grouped_mm(x, w, offs=ends)
        library_err = rel(lib)
        del lib
        library_ms = device_ms(torch, lambda: torch._grouped_mm(
            x, w, offs=ends), reps=10, trials=3)
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        library_note = f"torch._grouped_mm: {str(exc).splitlines()[0]}"
    rec = dict(shape=dict(R=R, K=K, N=N, E=E), dtype=dtype,
               experts_hit=hit, empty_groups=int((sizes == 0).sum()),
               one_row_groups=int((sizes == 1).sum()), route=route,
               route_taken=taken, err=err, max_abs_err=float(diff), tol=tol,
               repeats_bitwise=bool(torch.equal(got, again)), ms=ms,
               tile=(grouped_mm.wgmma_tile(R, E) if route == "wgmma"
                     else grouped_mm.mma_tile(R, E)),
               tiles=tiles, plain_ms=plain_ms, library_ms=library_ms,
               library_note=library_note, library_rel_err=library_err,
               bound_ms=bound[0], bound_by=bound[1], bytes=nbytes, flop=flop)
    if dtype == "float32":
        rec["cuda_core_bound_ms"] = bound_ms(nbytes, flop, dtype)[0]
    tile_text = ", ".join(f"{k} {v['ms']:.4f} ms (err {v['err']:.2e}, "
                          f"bitwise {v['repeats_bitwise']}, host "
                          f"{v['host_us']:.1f} us a call)"
                          for k, v in tiles.items())
    cores = (f"; CUDA cores {rec['cuda_core_bound_ms']:.4f} ms"
             if "cuda_core_bound_ms" in rec else "")
    log(f"grouped_mm {label} ({dtype}, R {R:,}, K {K:,}, N {N:,}, {hit} of "
        f"{E} experts hit, {rec['empty_groups']} empty, "
        f"{rec['one_row_groups']} of one row): route {route}, tile "
        f"{rec['tile']} (taken {taken}), max_rel_err {err:.3e} (tol "
        f"{tol}), repeat bitwise {rec['repeats_bitwise']}; {ms:.4f} ms, bound {bound[0]:.4f} ms by "
        f"{bound[1]} ({nbytes / 1e9:.3f} GB, {rec['flop'] / 1e12:.3f} "
        f"TFLOP{cores}), tiles {tile_text or 'not timed'}, plain "
        f"{plain_ms:.4f}, library "
        f"{'%.4f' % library_ms if library_ms is not None else library_note}"
        f" [{card()}]")
    del x, got, again, want
    torch.cuda.empty_cache()
    bad_tiles = {k: v for k, v in tiles.items()
                 if not (v["err"] <= tol and v["repeats_bitwise"])}
    if not (err <= tol and rec["repeats_bitwise"] and rec["empty_groups"]
            and rec["one_row_groups"] and taken == [route]
            and not bad_tiles):
        raise SystemExit(f"grouped_mm {label}: error {err} above {tol}, a "
                         f"repeat differs, the routing lacks an empty group "
                         f"or one of one row, the route taken {taken} is not "
                         f"{route!r}, or a tile fails {bad_tiles}: {rec}")
    return rec


def check_mla_fp32(torch, device="cuda") -> dict:
    """One full-width MLA layer in fp32, TF32 off (the hopper guide's
    section 6): the absorbed decode of position S - 1, against the latent
    rows of positions 0 .. S - 2 from the prefill, gives the prefill's row
    S - 1 within ``MLA_FP32_TOL`` of its max-abs."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla
    cfg = get_config(MLA_ARCH).replace(dtype=torch.float32,
                                       param_dtype=torch.float32)
    B, S = MLA_FP32_SHAPE
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            g = torch.Generator(device=device).manual_seed(11)
            p = mla.init_mla_params(g, cfg)
            x = torch.randn(B, S, cfg.d_model, generator=g, device=device)
            pos = torch.arange(S, device=device)[None].expand(B, S)
            out, (ckv, kr) = mla.mla_attention(p, x, pos, cfg,
                                               return_cache=True)
            c1, c2 = ckv.clone(), kr.clone()
            c1[:, S - 1:] = 0
            c2[:, S - 1:] = 0
            y, c1, c2 = mla.mla_decode(p, x[:, S - 1:], pos[:, S - 1], c1, c2,
                                       torch.tensor(S - 1, device=device),
                                       cfg)
            want = out[:, S - 1]
            err = float((y[:, 0] - want).abs().max() / want.abs().max())
            cache_err = float((c1 - ckv).abs().max() / ckv.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    del p, x, out, ckv, kr, c1, c2, y
    torch.cuda.empty_cache()
    log(f"MLA fp32 (full width, B {B}, S {S:,}, TF32 off): the absorbed "
        f"decode of position {S - 1} against the prefill's row: "
        f"{err:.3e} of its max-abs (tol {MLA_FP32_TOL}); the latent row "
        f"written {cache_err:.3e} [{card()}]")
    if not (err <= MLA_FP32_TOL and cache_err <= MLA_FP32_TOL):
        raise SystemExit(f"MLA fp32: the absorbed decode is {err} off the "
                         f"prefill's row (tol {MLA_FP32_TOL}), its latent "
                         f"row {cache_err}")
    return dict(shape_bs=[B, S], err=err, cache_err=cache_err,
                tol=MLA_FP32_TOL)


def mla_prefill_flop(cfg, B: int, S: int) -> float:
    """The products of one prefill of B x S tokens: MLA's projections, its
    full S x S score and value products (the plain branch computes the
    masked half too), the sort dispatch's rows (N k of them) through the
    three expert products, the shared expert, the router and the LM head
    at every position."""
    N = B * S
    d, H, E, ff = cfg.d_model, cfg.n_heads, cfg.moe_experts, cfg.d_ff
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    proj = 2 * N * (d * qr + qr * H * (dn + dr) + d * (kvr + dr)
                    + kvr * H * dn + kvr * H * dv + H * dv * d)
    attn = 2 * B * H * S * S * (dn + dr + dv)
    experts = 3 * 2 * N * cfg.moe_top_k * d * ff
    shared = 3 * 2 * N * d * ff * cfg.moe_shared_experts
    router = 2 * N * d * E
    return cfg.n_layers * (proj + attn + experts + shared + router) \
        + 2 * N * d * cfg.vocab_size


def mla_decode_bytes(torch, model, cfg, B: int, cache_len: int,
                     distinct) -> int:
    """The bytes a decode step of B tokens must read: every weight but the
    embedding table (B of its rows) and the routed experts, each layer's
    ``distinct[l]`` experts hit (three matrices each), and the latent
    cache's rows up to the new one."""
    routed = ("moe.p.wi", "moe.p.wg", "moe.p.wo")
    w = sum(p.numel() * p.element_size()
            for n, p in model.named_parameters()
            if n != "embed" and not n.endswith(routed))
    w += B * cfg.d_model * model.embed.element_size()
    item = torch.empty((), dtype=cfg.dtype).element_size()
    w += sum(distinct) * 3 * cfg.d_model * cfg.d_ff * item
    cache = cfg.n_layers * B * (cache_len + 1) * (
        cfg.kv_lora_rank + cfg.qk_rope_head_dim) * item
    return w + cache


def run_mla_serving_path(torch, ops) -> dict:
    """Phase 4c: deepseek-v3-671b at full width and depth MLA_LAYERS
    through the serving engine on phase 4's prompts, with the launch
    counters set to 0 just before each measured run and read just after
    (:func:`serve_eager_and_graphed`: the decode eager, then graphed, the
    main path); before it (not counted) one full-width MLA layer in fp32
    (:func:`check_mla_fp32`) and the grouped kernel against its plain
    version at the prefill's and a decode step's shapes with layer 0's
    weights; after it (not counted) layer 0's MoE on the prefill's input
    with the kernel against the plain grouped product and against gather
    at capacity E, the experts a decode step hits, the host-sync checks and
    the profiles.  The model is freed before it returns."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_mm
    from repro_torch.models import decode_step
    from repro_torch.models import moe as mmoe
    from repro_torch.serve import ServeConfig, ServingEngine
    fp32 = check_mla_fp32(torch)
    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_LAYERS, use_mtp=False)
    scfg = ServeConfig(max_batch=SERVE_REQUESTS,
                       max_len=SERVE_PROMPT + 2 * SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in eng.params.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in eng.params.parameters()) / 1e9
    log(f"serving {MLA_ARCH}: depth {cfg.n_layers}, {n_params:,} "
        f"parameters, {weight_gb:.2f} GB, drawn in {init_s:.1f} s (peak "
        f"{init_peak / 1e9:.2f} GB: the f32 draw of an expert tensor)")

    # the grouped kernel at the prefill's and a decode step's shapes
    N = SERVE_REQUESTS * SERVE_PROMPT
    p0 = eng.params.layers[0].moe.p
    grouped = {}
    with torch.inference_mode():
        for i, (label, R) in enumerate((("prefill", N * cfg.moe_top_k),
                                        ("decode", SERVE_REQUESTS
                                         * cfg.moe_top_k))):
            for key in ("wi", "wo"):
                grouped[f"{label}_{key}"] = check_grouped_kernel(
                    torch, ops, p0[key], R, f"{label} {key}", seed=20 + i)

    # phase 4's shape and seed, drawn within deepseek's smaller vocab
    prompts = serve_prompts(torch, cfg.vocab_size)
    warm_engine(torch, eng, prompts)
    log(f"serving {MLA_ARCH}: warmed at batch {SERVE_REQUESTS}, the decode "
        f"graph captured in {eng.stats['capture_s']:.3f} s")
    runs = serve_eager_and_graphed(torch, ops, eng, prompts,
                                   f"serving {MLA_ARCH}")
    main = runs["graph"]
    serve_peak = torch.cuda.max_memory_allocated()
    steps = SERVE_NEW - 1
    per = 3 * cfg.n_layers                 # grouped launches a forward
    for mode, r in runs.items():
        want = dict(dict.fromkeys(ops.LAUNCHES, 0),
                    grouped_mm=per * (r["prefill_batches"] + steps))
        if r["launches"] != want or r["prefill_batches"] != 1:
            raise SystemExit(f"serving {MLA_ARCH} ({mode} decode): launches "
                             f"{r['launches']} for {r['prefill_batches']} "
                             f"prefill batches and {steps} decode steps, "
                             f"{per} a forward")
    outputs = main["outputs"]
    if [len(o) for o in outputs] != [SERVE_NEW] * SERVE_REQUESTS or not all(
            0 <= t < cfg.vocab_size for o in outputs for t in o):
        raise SystemExit(f"serving {MLA_ARCH}: bad outputs {outputs}")

    # layer 0's MoE on the prefill's input: the sort dispatch with the
    # kernel against the same dispatch with the plain grouped product, and
    # against gather with capacity E (nothing drops) on MLA_GATHER_TOKENS
    tokens = torch.tensor(prompts, device=eng.device)
    seen = {}

    def keep_input(mod, args, out):
        seen["x"] = args[0].detach()

    handle = eng.params.layers[0].moe.register_forward_hook(keep_input)
    try:
        with torch.inference_mode():
            logits, _ = eng.prefill(tokens)
    finally:
        handle.remove()
    finite = bool(torch.isfinite(logits[:, -1]).all())
    del logits
    xl = seen.pop("x")
    d = cfg.d_model
    with torch.inference_mode():
        y_kernel, _ = mmoe.moe_ffn(p0, xl, cfg, impl="sort")
        with mock.patch.object(ops, "grouped_mm", grouped_mm.plain):
            y_plain, _ = mmoe.moe_ffn(p0, xl, cfg, impl="sort")
        sort_err = float((y_kernel.float() - y_plain.float()).abs().max()
                         / y_plain.float().abs().max())
        del y_kernel, y_plain
        xs = xl.reshape(-1, d)[:MLA_GATHER_TOKENS][None]
        wide = cfg.replace(moe_capacity_factor=float(cfg.moe_experts))
        _, keep = mmoe.slots(mmoe._route(p0, xs.reshape(-1, d), wide)[1],
                             wide)
        y_gather, _ = mmoe.moe_ffn(p0, xs, wide, impl="gather")
        y_sort, _ = mmoe.moe_ffn(p0, xs, wide, impl="sort")
        gather_err = float((y_gather.float() - y_sort.float()).abs().max()
                           / y_sort.float().abs().max())
        wide_keeps_all = bool(keep.all())
        del y_gather, y_sort, keep, xs
        torch.cuda.empty_cache()
        layer_ms = device_ms(torch, lambda: mmoe.moe_ffn(p0, xl, cfg,
                                                         impl="sort"),
                             reps=5, trials=3)
        xd = xl[:, -1:].contiguous()                  # (B, 1, d)
        sort_sync = sync_error(torch, lambda: mmoe.moe_ffn(p0, xd, cfg,
                                                           impl="sort"))
    del xl, xd
    torch.cuda.empty_cache()

    # the experts a decode step hits, per layer, on a fresh splice of the
    # prompts' prefill
    distinct = []
    handles = [b.moe.register_forward_hook(
        lambda mod, args, out: distinct.append(int(torch.unique(mmoe._route(
            mod.p, args[0].reshape(-1, d), cfg)[1]).numel())))
        for b in eng.params.layers]
    try:
        with torch.inference_mode():
            logits, pcache = eng.prefill(tokens)
            prog = eng._splice(pcache, logits[:, -1].argmax(dim=-1),
                               SERVE_PROMPT)
            del logits, pcache
            distinct.clear()
            prog._step(prog.tokens, prog.cache_len)
    finally:
        for h in handles:
            h.remove()
    del prog
    # a whole decode step with cache_len on the device, eagerly; the
    # device's share of a prefill and of a decode step, eager and replayed
    act = decode_activity(torch, eng, tokens)
    prog = act["program"]
    with torch.inference_mode():
        step_sync = sync_error(torch, lambda: decode_step(
            eng.params, cfg, prog.cache, prog.tokens, prog.cache_len))
        pre = device_activity(torch, lambda: eng.prefill(tokens), reps=1)
    del prog
    dec_rec = log_decode_runs(f"serving {MLA_ARCH}", runs, act, eng)
    dec = act["graph"]
    eager = {k: v for k, v in runs["eager"].items() if k != "outputs"}
    prefill_ms, decode_ms = main["prefill_ms"], main["decode_step_ms"]
    flop = mla_prefill_flop(cfg, SERVE_REQUESTS, SERVE_PROMPT)
    head_flop = 2.0 * N * d * cfg.vocab_size
    dec_bytes = mla_decode_bytes(torch, eng.params, cfg, SERVE_REQUESTS,
                                 SERVE_PROMPT, distinct)
    rec = dict(
        arch=MLA_ARCH, n_layers=cfg.n_layers, d_model=d,
        heads=cfg.n_heads, experts=cfg.moe_experts, top_k=cfg.moe_top_k,
        params=n_params, weight_gb=weight_gb, init_s=init_s,
        init_peak_memory_gb=init_peak / 1e9,
        reduced=dict(n_layers=[61, cfg.n_layers], use_mtp=[True, False]),
        requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
        new_tokens=SERVE_NEW, wall_s=main["wall_s"],
        prefill_batches=main["prefill_batches"],
        launches=main["launches"], eager_launches=runs["eager"]["launches"],
        prefill_ms=prefill_ms, prefill_flop=flop, head_flop=head_flop,
        prefill_bound_ms=bound_ms(0, flop, "bfloat16")[0],
        decode_step_ms=decode_ms,
        decode_step_ms_range=main["decode_step_ms_range"],
        decode_experts_hit=distinct, decode_bytes=dec_bytes,
        decode_bound_ms=bound_ms(dec_bytes, 0, "bfloat16")[0],
        tokens_per_s=main["tokens_per_s"],
        decode_tokens_per_s=main["decode_tokens_per_s"],
        prefill_kernels=pre["kernels"], prefill_device_ms=pre["busy_ms"],
        prefill_busy_share=pre["busy_ms"] / prefill_ms,
        decode_kernels_per_step=dec["kernels"],
        decode_device_ms_per_step=dec["busy_ms"],
        decode_busy_share=dec["busy_ms"] / decode_ms, eager_decode=eager,
        **dec_rec, mla_fp32=fp32, grouped=grouped,
        sort_kernel_vs_plain=sort_err, gather_vs_sort=gather_err,
        gather_tokens=MLA_GATHER_TOKENS,
        wide_capacity_keeps_all=wide_keeps_all, dispatch_tol=MOE_BF16_TOL,
        moe_layer_ms=layer_ms, sort_layer_sync=sort_sync,
        decode_step_sync=step_sync, logits_finite=finite,
        serve_peak_memory_gb=serve_peak / 1e9,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        outputs=outputs)
    log(f"serving mla: {json.dumps(rec)}")
    del eng, tokens, p0
    gc.collect()
    torch.cuda.empty_cache()
    log_memory(torch, "4c (the deepseek model freed)")
    if not finite:
        raise SystemExit(f"serving {MLA_ARCH}: non-finite prefill logits")
    if not sort_err <= MOE_BF16_TOL:
        raise SystemExit(f"serving {MLA_ARCH}: layer 0's sort dispatch with "
                         f"the kernel is {sort_err} off the plain grouped "
                         f"product (tol {MOE_BF16_TOL})")
    if not (wide_keeps_all and gather_err <= MOE_BF16_TOL):
        raise SystemExit(f"serving {MLA_ARCH}: gather with capacity factor "
                         f"E (drops none: {wide_keeps_all}) off sort by "
                         f"{gather_err} (tol {MOE_BF16_TOL})")
    if sort_sync is not None or step_sync is not None:
        raise SystemExit(f"serving {MLA_ARCH}: at decode size the sort MoE "
                         f"layer synchronises {sort_sync or 'nowhere'}, the "
                         f"whole step with cache_len on the device "
                         f"{step_sync or 'nowhere'}")
    log(f"serving {MLA_ARCH} (depth {cfg.n_layers}, {n_params:,} "
        f"parameters, {weight_gb:.2f} GB; peak {rec['peak_memory_gb']:.2f} "
        f"GB): prefill {prefill_ms:.1f} ms for {SERVE_REQUESTS} x "
        f"{SERVE_PROMPT} tokens ({flop / 1e12:.2f} TFLOP, the head's "
        f"{head_flop / 1e12:.2f}; bound {rec['prefill_bound_ms']:.1f} ms), "
        f"decode {decode_ms:.3f} ms per step graphed (range "
        f"{rec['decode_step_ms_range'][0]:.3f}-"
        f"{rec['decode_step_ms_range'][1]:.3f}; {dec['busy_ms']:.3f} ms of "
        f"device, {dec['kernels']:.0f} kernels, busy "
        f"{rec['decode_busy_share']:.3f}), eager "
        f"{eager['decode_step_ms']:.3f}; the weight-read bound "
        f"{rec['decode_bound_ms']:.3f} ms for {dec_bytes / 1e9:.3f} GB "
        f"({distinct} experts hit a layer); "
        f"{rec['decode_tokens_per_s']:.1f} decode tokens/s; grouped "
        f"launches {main['launches']['grouped_mm']} graphed, "
        f"{runs['eager']['launches']['grouped_mm']} eager ({per} a prefill "
        f"and {per} a decode step); device busy "
        f"{rec['prefill_busy_share']:.3f} of the prefill [{card()}]")
    log(f"serving {MLA_ARCH}: layer 0's sort dispatch, kernel vs plain "
        f"{sort_err:.3e}, gather (capacity E, {MLA_GATHER_TOKENS} tokens) vs "
        f"sort {gather_err:.3e} (tol {MOE_BF16_TOL}); the layer at {N:,} "
        f"tokens {layer_ms:.3f} ms; host syncs at decode size: sort layer "
        f"{sort_sync or 'none'}, the whole step {step_sync or 'none'} "
        f"[{card()}]")
    return rec


def run_fp32_sort_path(torch, ops, device="cuda") -> dict:
    """Phase 4d (ROADMAP C26): deepseek-v3 at full width in fp32 (TF32
    off), depth FP32_SORT_LAYERS and the MTP block off, with the sort
    dispatch through ``ServingEngine``, so that its grouped products run at
    the shapes an fp32 config sends: SERVE_REQUESTS
    seeded prompts of FP32_SORT_PROMPT tokens warmed, then served eager and
    graphed (:func:`serve_eager_and_graphed`, the launch counters set to 0
    just before each run and read just after: 3 grouped launches a layer a
    prefill and a step, all on the "mma" route); the prefill's last logits
    within ``FP32_SORT_TOL`` of the same model's with the plain grouped
    product patched in, whose eager decode gives the same tokens; a replay
    free of host syncs.  Then (not counted) the f32 and f64 routes at
    deepseek's full-width ``wi`` (K 7,168, N 2,048, 256 experts) and
    FP32_GROUPED_ROWS rows against their plain version, timed beside their
    bound (:func:`check_grouped_kernel`)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core.program import _eager_chunks
    from repro_torch.kernels import grouped_mm
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(MLA_ARCH).replace(
            n_layers=FP32_SORT_LAYERS, use_mtp=False, dtype=torch.float32,
            param_dtype=torch.float32, moe_impl="sort")
        model = init_params(cfg, torch.Generator(device=device).manual_seed(7))
        weight_gb = sum(p.numel() * p.element_size()
                        for p in model.parameters()) / 1e9
        gen = torch.Generator().manual_seed(8)
        prompts = [torch.randint(1, cfg.vocab_size, (FP32_SORT_PROMPT,),
                                 generator=gen).tolist()
                   for _ in range(SERVE_REQUESTS)]
        tokens = torch.tensor(prompts, device=device)
        scfg = ServeConfig(max_batch=SERVE_REQUESTS,
                           max_len=FP32_SORT_PROMPT + 2 * SERVE_NEW)
        eng = ServingEngine(cfg, scfg, params=model, device=device)
        warm_engine(torch, eng, prompts)
        grouped_mm.reset_route_launches()
        runs = serve_eager_and_graphed(torch, ops, eng, prompts,
                                       "fp32 sort")
        routes = dict(grouped_mm.ROUTE_LAUNCHES)
        steps = SERVE_NEW - 1
        per = 3 * cfg.n_layers
        for mode, r in runs.items():
            want = dict(dict.fromkeys(ops.LAUNCHES, 0),
                        grouped_mm=per * (r["prefill_batches"] + steps))
            if r["launches"] != want or r["prefill_batches"] != 1:
                raise SystemExit(f"fp32 sort ({mode} decode): launches "
                                 f"{r['launches']}, want {want}")
        with torch.inference_mode():
            logits = eng.prefill(tokens)[0][:, -1].double()
        prog = eng.programs[SERVE_REQUESTS]
        with torch.inference_mode():
            replay_sync = sync_error(torch, prog.step)
        plain_eng = ServingEngine(cfg, scfg, params=model, device=device)
        with _eager_chunks(), mock.patch.object(ops, "grouped_mm",
                                                grouped_mm.plain):
            with torch.inference_mode():
                plain_logits = plain_eng.prefill(tokens)[0][:, -1].double()
            for p in prompts:
                plain_eng.submit(Request(prompt=p, max_new_tokens=SERVE_NEW))
            plain_out = [r.output for r in plain_eng.run()]
        err = float((logits - plain_logits).abs().max()
                    / plain_logits.abs().max())
        del eng, plain_eng, model, prog, logits, plain_logits, tokens
        gc.collect()
        torch.cuda.empty_cache()
        # the f32 and f64 routes at deepseek's full-width wi
        kernels = {}
        with torch.inference_mode():
            for dtype in (torch.float32, torch.float64):
                E, K, N = FP32_GROUPED_SHAPE
                w = torch.randn(E, K, N, device=device, dtype=dtype,
                                generator=torch.Generator(device=device)
                                .manual_seed(21)).div_(K ** 0.5)
                for R in FP32_GROUPED_ROWS:
                    name = str(dtype).replace("torch.", "")
                    kernels[f"{name}_{R}"] = check_grouped_kernel(
                        torch, ops, w, R, f"4d {name} wi", seed=22)
                del w
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    outputs = runs["graph"]["outputs"]
    rec = dict(arch=MLA_ARCH, config="full width", dtype="float32",
               weight_gb=weight_gb, n_layers=cfg.n_layers,
               experts=cfg.moe_experts,
               top_k=cfg.moe_top_k, requests=SERVE_REQUESTS,
               prompt_len=FP32_SORT_PROMPT, new_tokens=SERVE_NEW,
               launches=runs["graph"]["launches"],
               eager_launches=runs["eager"]["launches"],
               route=grouped_mm.route(torch.float32),
               route_launches=routes, prefill_logits_err=err,
               tol=FP32_SORT_TOL, replay_sync=replay_sync,
               tokens_equal_plain=outputs == plain_out,
               decode_step_ms=runs["graph"]["decode_step_ms"],
               eager_decode_step_ms=runs["eager"]["decode_step_ms"],
               kernels=kernels)
    log(f"4d fp32 sort ({MLA_ARCH} full width, {cfg.n_layers} layer, "
        f"{weight_gb:.2f} GB, {cfg.moe_experts} experts "
        f"top-{cfg.moe_top_k}): prefill logits "
        f"{err:.3e} off the plain grouped product's (tol {FP32_SORT_TOL}); "
        f"graphed = eager = plain tokens {rec['tokens_equal_plain']}; "
        f"launches {runs['graph']['launches']['grouped_mm']} graphed, "
        f"{runs['eager']['launches']['grouped_mm']} eager ({per} a prefill "
        f"and a step), routes {routes}; decode {rec['decode_step_ms']:.3f} "
        f"ms graphed, {rec['eager_decode_step_ms']:.3f} eager; replay sync "
        f"{replay_sync or 'none'} [{card()}]")
    if not (err <= FP32_SORT_TOL and rec["tokens_equal_plain"]
            and replay_sync is None and rec["route"] == "mma"
            and routes["mma"] > 0 and routes["wgmma"] == 0):
        raise SystemExit(f"4d fp32 sort: {rec}")
    return rec


def hybrid_prefill_flop(cfg, B: int, S: int) -> dict:
    """The products of one hybrid prefill of B x S tokens: the projections
    (the shared block's once per application), the plain attention's
    scores and probabilities over every (query, key) pair (the window is a
    mask: it saves no work), and the SSD's einsums at 256-token chunks."""
    d, din, ns, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P, hd, L = din // H, cfg.hd, cfg.n_layers
    npts = -(-L // cfg.hybrid_shared_period)
    mamba_w = d * (2 * din + 2 * ns + H) + din * d
    shared_w = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    Q = 256 if S % 256 == 0 else S
    ssd = L * 2 * B * S * (Q * ns + Q * H * P + 2 * H * P * ns)
    return dict(projections=2 * B * S * (L * mamba_w + npts * shared_w
                                         + d * cfg.vocab_size),
                attention=npts * 4 * B * cfg.n_heads * S * S * hd, ssd=ssd)


def hybrid_decode_bytes(torch, model, cfg, B: int, W: int) -> dict:
    """The bytes a hybrid decode step must move: every weight it reads (the
    shared block's once per application: 134 MB do not stay in the 50 MB
    L2), B rows of the embedding, the SSM state read and written, the rings
    read; and a full ring's roll, ideal (each ring read and written once)
    and as run (gathered into a temporary, then copied back)."""
    def nbytes(params):
        return sum(p.numel() * p.element_size() for p in params)
    npts = -(-cfg.n_layers // cfg.hybrid_shared_period)
    H, ns = cfg.n_ssm_heads, cfg.ssm_state
    el = torch.empty((), dtype=cfg.dtype).element_size()
    state = 2 * cfg.n_layers * B * (H * (cfg.d_inner // H) * ns * 4
                                   + (cfg.ssm_conv - 1)
                                   * (cfg.d_inner + 2 * ns) * el)
    ring = 2 * npts * B * W * cfg.n_kv_heads * cfg.hd * el
    base = dict(mamba=nbytes(model.layers.parameters()),
                shared=npts * nbytes(model.shared_attn.parameters()),
                head=nbytes([model.lm_head, model.final_norm]),
                embed_rows=B * cfg.d_model * model.embed.element_size(),
                state=state, rings=ring)
    total = sum(base.values())
    return dict(base, total=total, roll_ideal=2 * ring, roll_run=4 * ring)


@contextlib.contextmanager
def no_tf32(torch):
    """fp32 matrix products in full f32 (TF32 off), restored after."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def teacher_forced(torch, model, cfg, prompts, n: int, max_len: int,
                   pad: int, device="cuda", fp32_reference=False) -> dict:
    """The prompts' prefill spliced into a fresh decode program of
    ``max_len``, then ``n`` greedy steps of it run eagerly (``cache_len``
    a 0-d device tensor), against ``forward`` over the prompt
    and the n fed tokens, zero-padded at the end to a multiple of ``pad``
    (the plain attention's 1,024-row query blocks, or the mLSTM's 256-token
    chunks; every layer is causal, so the padding moves no logit before
    it): the max-abs difference over those n positions over the forward's
    max-abs, and the tokens fed.  With
    ``fp32_reference``, also the distances of the decode's and the
    forward's logits from those of ``forward`` in fp32 (TF32 off) on the
    same weights, upcast."""
    import copy
    from repro_torch.models import forward, prefill_step
    from repro_torch.serve.engine import DecodeProgram
    B, S = len(prompts), len(prompts[0])

    def dist(a, b):
        return float((a - b).abs().max() / b.abs().max())

    with torch.inference_mode():
        tokens = torch.tensor(prompts, device=device)
        logits, pcache = prefill_step(model, cfg, {"tokens": tokens})
        prog = DecodeProgram(model, cfg, B, max_len, device)
        prog.start(pcache, logits[:, -1].argmax(dim=-1), S, graphed=False)
        del logits, pcache
        steps, fed = [], []
        for _ in range(n):
            fed.append(prog.tokens.clone())
            prog.step()
            steps.append(prog.logits[:, 0].float())
        del prog
        fed = torch.cat(fed, 1)
        total = -(-(S + n) // pad) * pad
        seq = torch.zeros((B, total), dtype=torch.long, device=device)
        seq[:, :S] = tokens
        seq[:, S:S + n] = fed
        want = forward(model, cfg, {"tokens": seq})[0][:, S:S + n].float()
        got = torch.stack(steps, 1)
        rec = dict(err=dist(got, want), fed=fed.tolist(),
                   positions=[S, S + n - 1], forward_len=total)
        if fp32_reference:
            m32 = copy.deepcopy(model).float()
            c32 = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
            with no_tf32(torch):
                ref = forward(m32, c32, {"tokens": seq})[0][:, S:S + n]
            del m32
            rec.update(forward_vs_fp32=dist(want, ref),
                       decode_vs_fp32=dist(got, ref))
    return rec


def run_hybrid_serving_path(torch, ops, device="cuda") -> dict:
    """Phase 4e: zamba2-1.2b at full width and depth (seeded bf16 weights)
    through ``ServingEngine`` at B = SERVE_REQUESTS, max_len
    HYBRID_MAX_LEN: warmed on the prompts' first 256 tokens (its decode
    graph captured there, the rings not full), then SERVE_REQUESTS prompts
    of HYBRID_PROMPT tokens served eager and graphed
    (:func:`serve_eager_and_graphed`: the same greedy tokens, nothing
    captured in the run), every decode step rolling the rings; the launch
    counters, set to 0 just before each run and read just after, read 0
    (the window keeps the shared block off the flash kernel, as in the
    reference); a replay free of host syncs; the prefill's and a step's
    times, kernels and busy share against their bounds; peak memory; then
    the teacher-forced check (:func:`teacher_forced`), in bf16
    (HYBRID_TF_TOL recorded; under HYBRID_TF_OUTER, no further from the fp32
    forward than twice the bf16 forward is, fed the engine's tokens) and in
    fp32 at depth HYBRID_F32_LAYERS under HYBRID_TF_TOL_F32."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(9))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(10)
    prompts = [torch.randint(1, cfg.vocab_size, (HYBRID_PROMPT,),
                             generator=gen).tolist()
               for _ in range(SERVE_REQUESTS)]
    eng = ServingEngine(cfg, ServeConfig(max_batch=SERVE_REQUESTS,
                                         max_len=HYBRID_MAX_LEN),
                        params=model, device=device)
    warm_engine(torch, eng, prompts)
    runs = serve_eager_and_graphed(torch, ops, eng, prompts, "4e hybrid")
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    for mode, r in runs.items():
        if r["launches"] != zero or r["prefill_batches"] != 1:
            raise SystemExit(f"4e hybrid ({mode} decode): launches "
                             f"{r['launches']} over {r['prefill_batches']} "
                             "prefill batches; want none over 1")
    prog = eng.programs[SERVE_REQUESTS]
    W = prog.cache["attn_k"].shape[2]
    last_len = int(prog.cache_len)
    if not (W == cfg.sliding_window and HYBRID_PROMPT >= W
            and last_len == HYBRID_PROMPT + SERVE_NEW - 1):
        raise SystemExit(f"4e hybrid: ring {W} rows, cache_len {last_len} "
                         "after the run: not every step rolled the ring")
    serve_peak = torch.cuda.max_memory_allocated()
    tokens = torch.tensor(prompts, device=device)
    act = decode_activity(torch, eng, tokens)
    with torch.inference_mode():
        prefill_act = device_activity(torch, lambda: eng.prefill(tokens),
                                      reps=1)
    del tokens
    dec = log_decode_runs("4e hybrid", runs, act, eng)
    flop = hybrid_prefill_flop(cfg, SERVE_REQUESTS, HYBRID_PROMPT)
    nbytes = hybrid_decode_bytes(torch, model, cfg, SERVE_REQUESTS, W)
    bound = nbytes["total"] / HBM_BYTES_PER_S * 1e3
    bound_roll = (nbytes["total"] + nbytes["roll_ideal"]) \
        / HBM_BYTES_PER_S * 1e3
    bound_run = (nbytes["total"] + nbytes["roll_run"]) \
        / HBM_BYTES_PER_S * 1e3
    del eng, prog
    gc.collect()
    torch.cuda.empty_cache()
    tf = teacher_forced(torch, model, cfg, prompts, SERVE_NEW - 1,
                        HYBRID_MAX_LEN, 1024, device, fp32_reference=True)
    tf["fed_are_the_engines"] = tf["fed"] == [
        o[:SERVE_NEW - 1] for o in runs["graph"]["outputs"]]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    c32 = cfg.replace(n_layers=HYBRID_F32_LAYERS, dtype=torch.float32,
                      param_dtype=torch.float32)
    with no_tf32(torch):
        m32 = init_params(c32, torch.Generator(device=device).manual_seed(9))
        tf32 = teacher_forced(torch, m32, c32, prompts, SERVE_NEW - 1,
                              HYBRID_MAX_LEN, 1024, device)
    tf32["rings"] = -(-HYBRID_F32_LAYERS // cfg.hybrid_shared_period)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    rec = dict(
        arch=HYBRID_ARCH, config="full width and depth", dtype="bfloat16",
        parameters=n_params, init_s=init_s, layers=cfg.n_layers,
        shared_applications=-(-cfg.n_layers // cfg.hybrid_shared_period),
        requests=SERVE_REQUESTS, prompt_len=HYBRID_PROMPT,
        max_len=HYBRID_MAX_LEN, ring_rows=W, new_tokens=SERVE_NEW,
        launches=g["launches"], eager_launches=e["launches"],
        prefill_ms=g["prefill_ms"], eager_prefill_ms=e["prefill_ms"],
        prefill_kernels=prefill_act["kernels"],
        prefill_device_ms=prefill_act["busy_ms"],
        prefill_tflop={k: v / 1e12 for k, v in flop.items()},
        decode_step_ms=g["decode_step_ms"],
        decode_step_ms_range=g["decode_step_ms_range"],
        eager_decode_step_ms=e["decode_step_ms"],
        eager_decode_step_ms_range=e["decode_step_ms_range"],
        tokens_per_s=g["tokens_per_s"],
        decode_tokens_per_s=g["decode_tokens_per_s"],
        decode_bytes=nbytes, decode_bound_ms=bound,
        decode_bound_with_roll_ms=bound_roll,
        decode_bound_as_run_ms=bound_run, peak_memory_gb=serve_peak / 1e9,
        teacher_forced=dict(tf, fed=None), teacher_forced_tol=HYBRID_TF_TOL,
        teacher_forced_within_tol=tf["err"] <= HYBRID_TF_TOL,
        teacher_forced_outer_tol=HYBRID_TF_OUTER,
        teacher_forced_fp32=dict(tf32, fed=None, layers=HYBRID_F32_LAYERS,
                                 tol=HYBRID_TF_TOL_F32),
        **dec)
    log(f"4e hybrid ({HYBRID_ARCH}, {n_params:,} parameters, "
        f"{cfg.n_layers} Mamba2 layers, the shared block "
        f"{rec['shared_applications']} times, bf16; drawn in {init_s:.2f} "
        f"s): {SERVE_REQUESTS} x {HYBRID_PROMPT} tokens, {SERVE_NEW} new, "
        f"max_len {HYBRID_MAX_LEN} (a {W}-row ring, rolled at every step); "
        f"launches {g['launches']} graphed, {e['launches']} eager (the "
        f"window keeps flash off); prefill {g['prefill_ms']:.2f} ms "
        f"(eager run {e['prefill_ms']:.2f}), {prefill_act['busy_ms']:.2f} ms "
        f"of device and {prefill_act['kernels']:.0f} kernels, for "
        f"{flop['projections'] / 1e12:.2f} TFLOP of projections, "
        f"{flop['attention'] / 1e12:.2f} of attention scores and "
        f"{flop['ssd'] / 1e12:.2f} of SSD einsums; a graphed step "
        f"{g['decode_step_ms']:.3f} ms against its "
        f"{nbytes['total'] / 1e9:.3f} GB bound of {bound:.3f} ms "
        f"({bound_roll:.3f} with an ideal roll of "
        f"{nbytes['roll_ideal'] / 1e9:.3f} GB, {bound_run:.3f} with the "
        f"roll as run, {nbytes['roll_run'] / 1e9:.3f} GB); eager "
        f"{e['decode_step_ms']:.3f} ms; peak memory "
        f"{serve_peak / 1e9:.2f} GB [{card()}]")
    log(f"4e hybrid teacher-forced: decode_step over {SERVE_NEW - 1} tokens "
        f"at positions {tf['positions'][0]}-{tf['positions'][1]} against "
        f"forward over {tf['forward_len']} tokens: {tf['err']:.3e} of the "
        f"logits' max-abs (bf16; phase 4's bar {HYBRID_TF_TOL}: "
        f"{rec['teacher_forced_within_tol']}; outer bar {HYBRID_TF_OUTER}); "
        f"from the fp32 forward on the same weights the bf16 forward is "
        f"{tf['forward_vs_fp32']:.3e}, the bf16 decode "
        f"{tf['decode_vs_fp32']:.3e} (bar twice the forward's); the fed "
        f"tokens the engine's: {tf['fed_are_the_engines']}; fp32 at depth "
        f"{HYBRID_F32_LAYERS} ({tf32['rings']} rings): {tf32['err']:.3e} (tol "
        f"{HYBRID_TF_TOL_F32}) [{card()}]")
    ok = (tf["err"] <= HYBRID_TF_OUTER
          and tf["decode_vs_fp32"] <= 2 * tf["forward_vs_fp32"]
          and tf["fed_are_the_engines"]
          and tf32["err"] <= HYBRID_TF_TOL_F32)
    for mode in ("eager", "graph"):
        bad = [t for o in runs[mode]["outputs"] for t in o
               if not 0 <= t < cfg.vocab_size]
        if bad or len(runs[mode]["outputs"]) != SERVE_REQUESTS or any(
                len(o) != SERVE_NEW for o in runs[mode]["outputs"]):
            ok = False
    if not ok:
        raise SystemExit(f"4e hybrid: {rec}")
    return rec


def xlstm_prefill_flop(cfg, B: int, S: int) -> dict:
    """The products of one xLSTM prefill of B x S tokens: the projections
    (the sLSTM's input, FFN; the mLSTM's up, q / k / v, gates, down; the
    head), the sLSTM's recurrent products (a (hd, 4 hd) block per head a
    token), and the mLSTM's chunk einsums at XLSTM_CHUNK tokens (scores
    and their product with v over each chunk's (t, j) pairs, the carry's
    read and update)."""
    d, H, V = cfg.d_model, cfg.n_heads, cfg.vocab_size
    pairs, dp = cfg.n_layers // 2, 2 * cfg.d_model
    hd_m, hd_s = dp // H, d // H
    ff = int(d * 4 / 3 / 64) * 64 * 2 or 2 * d
    s_w = d * 4 * d + d * ff + ff // 2 * d
    m_w = d * 2 * dp + 3 * dp * dp + dp * 2 * H + dp * d
    Q = XLSTM_CHUNK if S % XLSTM_CHUNK == 0 else S
    chunk = 2 * B * S * H * (2 * Q * hd_m + 2 * hd_m * hd_m + 2 * hd_m)
    return dict(projections=2 * B * S * (pairs * (s_w + m_w) + d * V),
                recurrent=pairs * 2 * B * S * H * hd_s * 4 * hd_s,
                mlstm=pairs * chunk)


def xlstm_decode_bytes(torch, model, cfg, B: int) -> dict:
    """The bytes an xLSTM decode step must move: every weight but the
    embedding (the pairs' and the head's), B rows of the embedding, and the
    state (the matrix memory ``m_c`` most of it) read and written once."""
    from repro_torch.models import init_cache

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    parts = dict(
        pairs=nbytes(model.layers.parameters()),
        head=nbytes([model.lm_head, model.final_norm]),
        embed_rows=B * cfg.d_model * model.embed.element_size(),
        state_read_written=2 * nbytes(
            init_cache(cfg, B, 1, device="meta").values()))
    return dict(parts, total=sum(parts.values()))


def slstm_in_prefill(torch, model, cfg, tokens) -> dict:
    """The sLSTM blocks' part of one prefill of ``tokens``: their span on
    the device (CUDA events recorded by a forward pre-hook and a forward
    hook on each block, summed), beside the prefill's (events around it);
    and their kernels: one block at the prefill's shape profiled alone
    (every pair's block launches the same kernels), times the pairs."""
    from repro_torch.models import prefill_step
    spans, hooks = [], []

    def pre(module, args):
        spans.append([torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)])
        spans[-1][0].record()

    def post(module, args, out):
        spans[-1][1].record()
    for pair in model.layers:
        hooks.append(pair.slstm.register_forward_pre_hook(pre))
        hooks.append(pair.slstm.register_forward_hook(post))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            prefill_step(model, cfg, {"tokens": tokens})
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    slstm_ms = sum(a.elapsed_time(b) for a, b in spans)
    block = model.layers[0].slstm
    with torch.inference_mode():
        x = model.embed[tokens.long()].to(cfg.dtype)
        one = device_activity(torch, lambda: block(x, cfg), reps=1)
    del x
    prefill_ms = start.elapsed_time(end)
    return dict(blocks=len(spans), ms=slstm_ms, prefill_ms=prefill_ms,
                prefill_wall_ms=wall * 1e3, share=slstm_ms / prefill_ms,
                kernels_per_block=one["kernels"],
                device_ms_per_block=one["busy_ms"],
                kernels=one["kernels"] * len(spans))


def xlstm_teacher_forced(torch, model, cfg, prompts, device) -> tuple:
    """:func:`teacher_forced` of the bf16 ``model`` (with its distances
    from the fp32 forward), then of its weights upcast to fp32, TF32 off:
    both records; the fp32 copy freed."""
    import copy
    tf = teacher_forced(torch, model, cfg, prompts, SERVE_NEW - 1,
                        XLSTM_MAX_LEN, XLSTM_CHUNK, device,
                        fp32_reference=True)
    c32 = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    with no_tf32(torch):
        m32 = copy.deepcopy(model).float()
        tf32 = teacher_forced(torch, m32, c32, prompts, SERVE_NEW - 1,
                              XLSTM_MAX_LEN, XLSTM_CHUNK, device)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    return tf, tf32


def run_xlstm_serving_path(torch, ops, device="cuda") -> dict:
    """Phase 4f: xlstm-350m at full width and depth (seeded bf16 weights)
    through ``ServingEngine`` at B = SERVE_REQUESTS, max_len XLSTM_MAX_LEN
    (under the prompt: the state has no rows): warmed on the prompts'
    first 256 tokens (its decode graph captured there), then
    SERVE_REQUESTS prompts of XLSTM_PROMPT tokens served eager and graphed
    (:func:`serve_eager_and_graphed`: the same greedy tokens, nothing
    captured in the run); the launch counters, set to 0 just before each
    run and read just after, read 0 (the family runs no kernel of the
    port); a replay free of host syncs; the prefill's time, kernels and
    device time beside its TFLOP, the sLSTM loop's part of it
    (:func:`slstm_in_prefill`), a step's times, kernels and busy share
    against its bytes' bound; peak memory; then the teacher-forced check
    (:func:`xlstm_teacher_forced`): at full depth in bf16, fed the
    engine's tokens, no further from the fp32 forward than twice the bf16
    forward is (XLSTM_TF_TOL and XLSTM_TF_OUTER recorded), and the same
    weights in fp32 under XLSTM_TF_TOL_F32; at depth XLSTM_F32_LAYERS in
    bf16 under XLSTM_TF_OUTER (and the same rule against fp32) and in fp32
    under XLSTM_TF_TOL_F32."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(11))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(12)
    prompts = [torch.randint(1, cfg.vocab_size, (XLSTM_PROMPT,),
                             generator=gen).tolist()
               for _ in range(SERVE_REQUESTS)]
    eng = ServingEngine(cfg, ServeConfig(max_batch=SERVE_REQUESTS,
                                         max_len=XLSTM_MAX_LEN),
                        params=model, device=device)
    warm_engine(torch, eng, prompts)
    runs = serve_eager_and_graphed(torch, ops, eng, prompts, "4f xlstm")
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    for mode, r in runs.items():
        if r["launches"] != zero or r["prefill_batches"] != 1:
            raise SystemExit(f"4f xlstm ({mode} decode): launches "
                             f"{r['launches']} over {r['prefill_batches']} "
                             "prefill batches; want none over 1")
    prog = eng.programs[SERVE_REQUESTS]
    if int(prog.cache_len) != XLSTM_PROMPT + SERVE_NEW - 1:
        raise SystemExit(f"4f xlstm: cache_len {int(prog.cache_len)} after "
                         "the run")
    serve_peak = torch.cuda.max_memory_allocated()
    tokens = torch.tensor(prompts, device=device)
    slstm = slstm_in_prefill(torch, model, cfg, tokens)
    act = decode_activity(torch, eng, tokens)
    with torch.inference_mode():
        prefill_act = device_activity(torch, lambda: eng.prefill(tokens),
                                      reps=1)
    del tokens
    dec = log_decode_runs("4f xlstm", runs, act, eng)
    flop = xlstm_prefill_flop(cfg, SERVE_REQUESTS, XLSTM_PROMPT)
    nbytes = xlstm_decode_bytes(torch, model, cfg, SERVE_REQUESTS)
    bound = nbytes["total"] / HBM_BYTES_PER_S * 1e3
    del eng, prog
    gc.collect()
    torch.cuda.empty_cache()
    tf, tf32_full = xlstm_teacher_forced(torch, model, cfg, prompts, device)
    tf["fed_are_the_engines"] = tf["fed"] == [
        o[:SERVE_NEW - 1] for o in runs["graph"]["outputs"]]
    del model
    gc.collect()
    c4 = cfg.replace(n_layers=XLSTM_F32_LAYERS)
    tf4, tf32 = xlstm_teacher_forced(
        torch, init_params(c4, torch.Generator(device=device).manual_seed(11)),
        c4, prompts, device)
    g, e = runs["graph"], runs["eager"]
    rec = dict(
        arch=XLSTM_ARCH, config="full width and depth", dtype="bfloat16",
        parameters=n_params, init_s=init_s, layers=cfg.n_layers,
        pairs=cfg.n_layers // 2, requests=SERVE_REQUESTS,
        prompt_len=XLSTM_PROMPT, max_len=XLSTM_MAX_LEN,
        new_tokens=SERVE_NEW, launches=g["launches"],
        eager_launches=e["launches"], prefill_ms=g["prefill_ms"],
        eager_prefill_ms=e["prefill_ms"],
        prefill_kernels=prefill_act["kernels"],
        prefill_device_ms=prefill_act["busy_ms"],
        prefill_tflop={k: v / 1e12 for k, v in flop.items()},
        slstm_in_prefill=slstm,
        decode_step_ms=g["decode_step_ms"],
        decode_step_ms_range=g["decode_step_ms_range"],
        eager_decode_step_ms=e["decode_step_ms"],
        eager_decode_step_ms_range=e["decode_step_ms_range"],
        tokens_per_s=g["tokens_per_s"],
        decode_tokens_per_s=g["decode_tokens_per_s"],
        decode_bytes=nbytes, decode_bound_ms=bound,
        peak_memory_gb=serve_peak / 1e9,
        teacher_forced=dict(tf, fed=None), teacher_forced_tol=XLSTM_TF_TOL,
        teacher_forced_within_tol=tf["err"] <= XLSTM_TF_TOL,
        teacher_forced_outer_tol=XLSTM_TF_OUTER,
        teacher_forced_fp32_full=dict(tf32_full, fed=None,
                                      tol=XLSTM_TF_TOL_F32),
        teacher_forced_shallow=dict(tf4, fed=None, layers=XLSTM_F32_LAYERS,
                                    tol=XLSTM_TF_OUTER),
        teacher_forced_fp32=dict(tf32, fed=None, layers=XLSTM_F32_LAYERS,
                                 tol=XLSTM_TF_TOL_F32),
        **dec)
    log(f"4f xlstm ({XLSTM_ARCH}, {n_params:,} parameters, "
        f"{rec['pairs']} sLSTM + mLSTM pairs, bf16; drawn in {init_s:.2f} "
        f"s): {SERVE_REQUESTS} x {XLSTM_PROMPT} tokens, {SERVE_NEW} new, "
        f"max_len {XLSTM_MAX_LEN} (the state holds no rows); launches "
        f"{g['launches']} graphed, {e['launches']} eager; prefill "
        f"{g['prefill_ms']:.2f} ms (eager run {e['prefill_ms']:.2f}), "
        f"{prefill_act['busy_ms']:.2f} ms of device and "
        f"{prefill_act['kernels']:.0f} kernels, for "
        f"{flop['projections'] / 1e12:.3f} TFLOP of projections, "
        f"{flop['recurrent'] / 1e12:.4f} of sLSTM recurrent products and "
        f"{flop['mlstm'] / 1e12:.3f} of mLSTM chunk einsums; a graphed "
        f"step {g['decode_step_ms']:.3f} ms against its "
        f"{nbytes['total'] / 1e9:.3f} GB bound of {bound:.3f} ms (weights "
        f"but the embedding {(nbytes['pairs'] + nbytes['head']) / 1e9:.3f} "
        f"GB, the state read and written "
        f"{nbytes['state_read_written'] / 1e9:.3f} GB); eager "
        f"{e['decode_step_ms']:.3f} ms; peak memory "
        f"{serve_peak / 1e9:.2f} GB [{card()}]")
    log(f"4f xlstm sLSTM loop: {slstm['blocks']} blocks of "
        f"{XLSTM_PROMPT} sequential steps, {slstm['ms']:.2f} ms of the "
        f"prefill's {slstm['prefill_ms']:.2f} (events; share "
        f"{slstm['share']:.3f}; wall {slstm['prefill_wall_ms']:.2f}); "
        f"{slstm['kernels_per_block']:.0f} kernels a block "
        f"({slstm['kernels_per_block'] / XLSTM_PROMPT:.1f} a token), "
        f"{slstm['kernels']:.0f} in the prefill, "
        f"{slstm['device_ms_per_block']:.2f} ms of device a block "
        f"[{card()}]")
    log(f"4f xlstm teacher-forced: decode_step over {SERVE_NEW - 1} tokens "
        f"at positions {tf['positions'][0]}-{tf['positions'][1]} against "
        f"forward over {tf['forward_len']} tokens, max-abs over the "
        f"logits' max-abs.  Depth {cfg.n_layers}: bf16 {tf['err']:.3e} "
        f"(phase 4's bar {XLSTM_TF_TOL}: {rec['teacher_forced_within_tol']}"
        f"; {XLSTM_TF_OUTER}: {tf['err'] <= XLSTM_TF_OUTER}, recorded); "
        f"from the fp32 forward on the same weights the bf16 forward is "
        f"{tf['forward_vs_fp32']:.3e}, the bf16 decode "
        f"{tf['decode_vs_fp32']:.3e} (bar twice the forward's); the fed "
        f"tokens the engine's: {tf['fed_are_the_engines']}; the same "
        f"weights in fp32: {tf32_full['err']:.3e} (tol "
        f"{XLSTM_TF_TOL_F32}).  Depth {XLSTM_F32_LAYERS}: bf16 "
        f"{tf4['err']:.3e} (bar {XLSTM_TF_OUTER}), the forward "
        f"{tf4['forward_vs_fp32']:.3e} and the decode "
        f"{tf4['decode_vs_fp32']:.3e} from fp32; fp32 {tf32['err']:.3e} "
        f"(tol {XLSTM_TF_TOL_F32}) [{card()}]")
    ok = (n_params == XLSTM_PARAMS
          and tf["decode_vs_fp32"] <= 2 * tf["forward_vs_fp32"]
          and tf["fed_are_the_engines"]
          and tf32_full["err"] <= XLSTM_TF_TOL_F32
          and tf4["err"] <= XLSTM_TF_OUTER
          and tf4["decode_vs_fp32"] <= 2 * tf4["forward_vs_fp32"]
          and tf32["err"] <= XLSTM_TF_TOL_F32
          and slstm["blocks"] == cfg.n_layers // 2)
    for mode in ("eager", "graph"):
        bad = [t for o in runs[mode]["outputs"] for t in o
               if not 0 <= t < cfg.vocab_size]
        if bad or len(runs[mode]["outputs"]) != SERVE_REQUESTS or any(
                len(o) != SERVE_NEW for o in runs[mode]["outputs"]):
            ok = False
    if not ok:
        raise SystemExit(f"4f xlstm: {rec}")
    return rec


def whisper_prefill_flop(cfg, B: int, S: int, T: int) -> dict:
    """The products of one whisper prefill of B x S tokens against B x T
    frames: the projections (an encoder layer's q, k, v, o and MLP over T;
    a decoder layer's self q, k, v, o, cross q and o and MLP over S, cross
    k and v over T; the head over S) and the attention's two einsums (the
    encoder's T x T pairs, the decoder's S (S + 1) / 2 causal ones and S x
    T cross ones; H * hd = d)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    return dict(
        projections=2 * B * (Le * T * (4 * d * d + 2 * d * ff)
                             + L * (S * (4 * d * d + 2 * d * ff + 2 * d * d)
                                    + T * 2 * d * d) + S * d * V),
        attention=4 * B * d * (Le * T * T + L * (S * (S + 1) // 2 + S * T)))


def whisper_decode_bytes(model, prog, B: int) -> dict:
    """The bytes a whisper decode step must move: the decoder's weights,
    the head (the tied embedding) and B rows of it and of the learned
    positions, the self K/V and the encoder's K/V as the decode program
    holds them (max_len rows each, read once; the new row written)."""
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    d = model.embed.shape[1]
    parts = dict(
        decoder=nbytes(model.dec_layers.parameters()),
        head=nbytes([model.embed, model.final_norm]),
        rows=2 * B * d * model.embed.element_size(),
        self_kv=nbytes([prog.cache["k"], prog.cache["v"]]),
        cross_kv=nbytes([prog.cache["cross_k"], prog.cache["cross_v"]]))
    return dict(parts, total=sum(parts.values()))


def whisper_fp32_decode(torch, model, cfg, tokens, frames, device) -> dict:
    """The bf16 ``model``'s weights in fp32 (TF32 off) at B = 1: the
    prefill of ``tokens`` against ``frames`` on the card (its decoder on
    the fp32 kernel) and on this machine's CPU (the plain path), then
    SERVE_NEW - 1 ``decode_step``s on each from its own cache, both fed the
    CPU's greedy tokens: the largest distance of a step's logits (max-abs
    over the CPU's max-abs); and, as ROADMAP C29's reading, the card's
    decode logits against ``forward`` on the card over the prompt and the
    fed tokens."""
    import copy
    from repro_torch.models import (decode_step, forward, init_cache,
                                    prefill_step)
    c32 = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    S = tokens.shape[1]

    def dist(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max())

    def spliced(pcache, dev):
        cache = init_cache(c32, 1, AUDIO_MAX_LEN, enc_len=frames.shape[1],
                           device=dev)
        for key, dst in cache.items():
            dst[:, :, :pcache[key].shape[2]].copy_(pcache[key])
        return cache

    with torch.inference_mode(), no_tf32(torch):
        card32 = copy.deepcopy(model).float()
        cpu32 = copy.deepcopy(card32).to("cpu")
        batch = {"tokens": tokens, "frames": frames.float()}
        gl, gpc = prefill_step(card32, c32, batch)
        cl, cpc = prefill_step(cpu32, c32, {k: v.cpu() for k, v in
                                            batch.items()})
        prefill_err = dist(gl[:, -1], cl[:, -1])
        gcache, ccache = spliced(gpc, device), spliced(cpc, "cpu")
        del gpc, cpc
        nxt = cl[:, -1].argmax(-1, keepdim=True)
        fed, errs, got = [], [], []
        for i in range(SERVE_NEW - 1):
            fed.append(nxt)
            glog, _ = decode_step(card32, c32, gcache, nxt.to(device),
                                  torch.tensor(S + i, device=device))
            clog, _ = decode_step(cpu32, c32, ccache, nxt, torch.tensor(S + i))
            errs.append(dist(glog, clog))
            got.append(glog[:, 0].float())
            nxt = clog[:, 0].argmax(-1, keepdim=True)
        seq = torch.cat([tokens] + [f.to(device) for f in fed], 1)
        fwd = forward(card32, c32, dict(batch, tokens=seq))[0]
        c29 = dist(torch.stack(got, 1), fwd[:, S:S + len(fed)])
    del card32, cpu32, gcache, ccache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(err=max(errs), errs=errs, prefill_err=prefill_err,
                c29_decode_vs_forward=c29, positions=[S, S + len(fed) - 1],
                fed=torch.cat(fed, 1).tolist())


def run_whisper_serving_path(torch, ops, flash_ms: float,
                             device="cuda") -> dict:
    """Phase 4g: whisper-tiny at full width and depth (seeded bf16
    weights) with the flash kernel through ``ServingEngine`` at B =
    SERVE_REQUESTS, max_len AUDIO_MAX_LEN: warmed on the measured prompts
    (its decode graph captured there), then SERVE_REQUESTS prompts of
    AUDIO_PROMPT tokens served eager and graphed
    (:func:`serve_eager_and_graphed`: the same greedy tokens, nothing
    captured in the run); the launch counters, set to 0 just before each
    run and read just after, read one flash launch a decoder layer in the
    prefill and none in the decode; a replay free of host syncs; the
    prefill's last logits against the plain branch's; its time, kernels
    and device time beside its FLOP, a step's against its bytes' bound;
    then ``prefill_step`` on AUDIO_FRAMES seeded frames and 15 eager
    ``decode_step``s through the entry points, timed; then
    :func:`whisper_fp32_decode`.  ``flash_ms``: 2d's kernel time at this
    prefill's shape."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step)
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = get_config(AUDIO_ARCH).replace(use_flash_kernel=True)
    B = SERVE_REQUESTS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(13))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(1, cfg.vocab_size, (AUDIO_PROMPT,),
                             generator=gen).tolist() for _ in range(B)]
    scfg = ServeConfig(max_batch=B, max_len=AUDIO_MAX_LEN)
    eng = ServingEngine(cfg, scfg, params=model, device=device)
    for p in prompts:                   # warm at the measured length
        eng.submit(Request(prompt=p, max_new_tokens=2))
    eng.run()
    eng.done.clear()
    eng.stats["prefill_s"].clear()
    eng.stats["decode_s"].clear()
    torch.cuda.synchronize()
    runs = serve_eager_and_graphed(torch, ops, eng, prompts, "4g whisper")
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), flash_attention=cfg.n_layers)
    for mode, r in runs.items():
        if r["launches"] != want or r["prefill_batches"] != 1:
            raise SystemExit(f"4g whisper ({mode} decode): launches "
                             f"{r['launches']} over {r['prefill_batches']} "
                             f"prefill batches; want {cfg.n_layers} flash "
                             "launches over 1 (none in a decode step)")
    prog = eng.programs[B]
    if int(prog.cache_len) != AUDIO_PROMPT + SERVE_NEW - 1 \
            or int(prog.enc_len) != AUDIO_PROMPT:
        raise SystemExit(f"4g whisper: cache_len {int(prog.cache_len)}, "
                         f"enc_len {int(prog.enc_len)} after the run")
    serve_peak = torch.cuda.max_memory_allocated()
    tokens = torch.tensor(prompts, device=device)
    plain = ServingEngine(cfg.replace(use_flash_kernel=False), scfg,
                          params=model, device=device)
    with torch.inference_mode():
        last = {"flash": eng.prefill(tokens)[0][:, -1].float(),
                "plain": plain.prefill(tokens)[0][:, -1].float()}
        pre = device_activity(torch, lambda: eng.prefill(tokens), reps=1)
    del plain
    outputs = runs["graph"]["outputs"]
    finite = all(bool(torch.isfinite(t).all()) for t in last.values())
    err = float((last["flash"] - last["plain"]).abs().max()
                / last["plain"].abs().max())
    agree = (last["flash"].argmax(-1) == last["plain"].argmax(-1)).tolist()
    first = [o[0] for o in outputs] == last["flash"].argmax(-1).tolist()
    act = decode_activity(torch, eng, tokens)
    dec = log_decode_runs("4g whisper", runs, act, eng)
    nbytes = whisper_decode_bytes(model, prog, B)
    bound = nbytes["total"] / HBM_BYTES_PER_S * 1e3
    flop = whisper_prefill_flop(cfg, B, AUDIO_PROMPT, AUDIO_PROMPT)
    del eng, prog
    gc.collect()
    torch.cuda.empty_cache()

    # the entry points: a prefill on AUDIO_FRAMES seeded frames, then 15
    # eager decode steps, each timed (synchronized)
    g = torch.Generator(device=device).manual_seed(15)
    frames = torch.randn(B, AUDIO_FRAMES, cfg.d_model, generator=g,
                         device=device).to(cfg.dtype)
    with torch.inference_mode():
        prefill_step(model, cfg, {"tokens": tokens, "frames": frames})
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, pcache = prefill_step(model, cfg, {"tokens": tokens,
                                                   "frames": frames})
        torch.cuda.synchronize()
        ep_prefill_ms = (time.perf_counter() - t0) * 1e3
        ep_launches = dict(ops.LAUNCHES)
        cache = init_cache(cfg, B, AUDIO_MAX_LEN, enc_len=AUDIO_FRAMES,
                           device=device)
        for key, dst in cache.items():
            dst[:, :, :pcache[key].shape[2]].copy_(pcache[key])
        cur = logits[:, -1].argmax(-1, keepdim=True)
        ep_finite = bool(torch.isfinite(logits[:, -1]).all())
        del logits, pcache
        ep_steps = []
        for i in range(SERVE_NEW - 1):
            t0 = time.perf_counter()
            out, _ = decode_step(model, cfg, cache, cur,
                                 torch.tensor(AUDIO_PROMPT + i,
                                              device=device))
            cur = out[:, 0].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            ep_steps.append((time.perf_counter() - t0) * 1e3)
            ep_finite &= bool(torch.isfinite(out).all())
        del cache, out
    f32 = whisper_fp32_decode(torch, model, cfg, tokens[:1], frames[:1],
                              device)
    g_run, e_run = runs["graph"], runs["eager"]
    rec = dict(
        arch=AUDIO_ARCH, config="full width and depth", dtype="bfloat16",
        parameters=n_params, init_s=init_s, encoder_layers=cfg.n_encoder_layers,
        decoder_layers=cfg.n_layers, requests=B, prompt_len=AUDIO_PROMPT,
        max_len=AUDIO_MAX_LEN, new_tokens=SERVE_NEW,
        launches=g_run["launches"], eager_launches=e_run["launches"],
        prefill_ms=g_run["prefill_ms"], eager_prefill_ms=e_run["prefill_ms"],
        prefill_kernels=pre["kernels"], prefill_device_ms=pre["busy_ms"],
        prefill_busy_share=pre["busy_ms"] / g_run["prefill_ms"],
        prefill_gflop={k: v / 1e9 for k, v in flop.items()},
        flash_share_of_prefill=flash_ms * cfg.n_layers / g_run["prefill_ms"],
        decode_step_ms=g_run["decode_step_ms"],
        decode_step_ms_range=g_run["decode_step_ms_range"],
        eager_decode_step_ms=e_run["decode_step_ms"],
        eager_decode_step_ms_range=e_run["decode_step_ms_range"],
        tokens_per_s=g_run["tokens_per_s"],
        decode_tokens_per_s=g_run["decode_tokens_per_s"],
        decode_bytes=nbytes, decode_bound_ms=bound,
        peak_memory_gb=serve_peak / 1e9, logits_finite=finite,
        logits_max_rel_err=err, logits_tol=SERVE_LOGITS_TOL,
        argmax_agree=agree, first_tokens_are_logits_argmax=first,
        entry_points=dict(frames=AUDIO_FRAMES, prefill_ms=ep_prefill_ms,
                          launches=ep_launches,
                          decode_step_ms=statistics.median(ep_steps),
                          decode_step_ms_range=[min(ep_steps),
                                                max(ep_steps)],
                          finite=ep_finite),
        fp32_decode=dict(f32, fed=None, tol=AUDIO_DECODE_TOL_F32,
                         frames=AUDIO_FRAMES),
        outputs=outputs, **dec)
    log(f"4g whisper ({AUDIO_ARCH}, {n_params:,} parameters, "
        f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, bf16; drawn in "
        f"{init_s:.2f} s): {B} x {AUDIO_PROMPT} tokens on zero frames, "
        f"{SERVE_NEW} new, max_len {AUDIO_MAX_LEN}; launches "
        f"{g_run['launches']} graphed, {e_run['launches']} eager; prefill "
        f"{g_run['prefill_ms']:.2f} ms (eager run {e_run['prefill_ms']:.2f})"
        f", {pre['busy_ms']:.3f} ms of device and {pre['kernels']:.0f} "
        f"kernels (busy {rec['prefill_busy_share']:.3f}), for "
        f"{flop['projections'] / 1e9:.2f} GFLOP of projections and "
        f"{flop['attention'] / 1e9:.2f} of attention; the flash kernel "
        f"{rec['flash_share_of_prefill']:.4f} of it; a graphed step "
        f"{g_run['decode_step_ms']:.3f} ms (range "
        f"{g_run['decode_step_ms_range'][0]:.3f}-"
        f"{g_run['decode_step_ms_range'][1]:.3f}) against its "
        f"{nbytes['total'] / 1e6:.1f} MB bound of {bound:.4f} ms (decoder "
        f"and head {(nbytes['decoder'] + nbytes['head']) / 1e6:.1f} MB, "
        f"self K/V {nbytes['self_kv'] / 1e6:.1f}, cross K/V "
        f"{nbytes['cross_kv'] / 1e6:.1f}); eager "
        f"{e_run['decode_step_ms']:.3f} ms; {g_run['tokens_per_s']:.1f} "
        f"tokens/s; peak memory {serve_peak / 1e9:.3f} GB [{card()}]")
    log(f"4g whisper prefill logits: the kernel's last-position logits "
        f"{err:.3e} off the plain branch's max-abs (tol {SERVE_LOGITS_TOL})"
        f", argmax agreement {sum(agree)}/{len(agree)}, finite {finite}; "
        f"the first tokens are the prefill's argmax: {first}")
    log(f"4g whisper entry points: prefill_step on {B} x {AUDIO_PROMPT} "
        f"tokens and {B} x {AUDIO_FRAMES} seeded frames "
        f"{ep_prefill_ms:.2f} ms (launches {ep_launches}), 15 eager "
        f"decode_steps median {statistics.median(ep_steps):.3f} ms (range "
        f"{min(ep_steps):.3f}-{max(ep_steps):.3f}), finite {ep_finite} "
        f"[{card()}]")
    log(f"4g whisper fp32 decode (TF32 off, B = 1, {AUDIO_FRAMES} frames): "
        f"{SERVE_NEW - 1} steps at positions {f32['positions'][0]}-"
        f"{f32['positions'][1]} on the card against the same steps on the "
        f"CPU: {f32['err']:.3e} of the logits' max-abs at worst (tol "
        f"{AUDIO_DECODE_TOL_F32:.0e}); the prefill's last logits "
        f"{f32['prefill_err']:.3e}.  C29 (a reading, not a gate): the "
        f"card's decode against its forward over the same tokens "
        f"{f32['c29_decode_vs_forward']:.3e} of the forward's max-abs "
        f"(the decode rotates q and the new k with RoPE, the prefill "
        f"rotates nothing, as in the reference) [{card()}]")
    ok = (n_params == AUDIO_PARAMS and finite and err <= SERVE_LOGITS_TOL
          and ep_finite and ep_launches == want
          and f32["err"] <= AUDIO_DECODE_TOL_F32)
    for mode in ("eager", "graph"):
        outs = runs[mode]["outputs"]
        if len(outs) != B or any(len(o) != SERVE_NEW for o in outs) or any(
                not 0 <= t < cfg.vocab_size for o in outs for t in o):
            ok = False
    if not ok:
        raise SystemExit(f"4g whisper: {rec}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def vlm_prefill_flop(cfg, B: int, S: int) -> dict:
    """The products of one qwen2-vl prefill of B x S tokens: a layer's
    projections (q and o of H * hd, k and v of K * hd, the SwiGLU MLP's
    three), the head over every position, and the causal attention's two
    einsums, S (S + 1) / 2 pairs a head."""
    d, ff, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    H, K, L, N = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, B * S
    return dict(
        projections=2 * N * (L * (2 * d * H * hd + 2 * d * K * hd
                                  + 3 * d * ff) + d * V),
        attention=4 * B * H * hd * L * (S * (S + 1) // 2))


def vlm_decode_bytes(model, prog, B: int) -> dict:
    """The bytes a qwen2-vl decode step must move: every layer's weights,
    the head (``lm_head`` and the final norm) and B rows of the embedding,
    and the K/V cache as the decode program holds it (``max_len`` rows,
    read once; the new row written)."""
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    parts = dict(
        layers=nbytes(model.layers.parameters()),
        head=nbytes([model.lm_head, model.final_norm]),
        rows=B * model.embed.shape[1] * model.embed.element_size(),
        kv=nbytes([prog.cache["k"], prog.cache["v"]]))
    return dict(parts, total=sum(parts.values()))


def vlm_image_batch(torch, cfg, tokens, device) -> dict:
    """``prefill_step``'s batch for prompts with one image each: ``tokens``
    (B, S), VLM_GRID's patch rows (seeded, ``cfg.dtype``) spliced in at row
    1, and the (t, h, w) ids Qwen2-VL gives such a prompt: row 0 at 0, the
    patches t = 1 over the grid's (1 + row, 1 + column), the text after
    them from the largest id plus one."""
    B, S = tokens.shape
    gh, gw = VLM_GRID
    P = gh * gw
    g = torch.Generator(device=device).manual_seed(16)
    r = torch.arange(P, device=device)
    pos = torch.zeros(S, 3, dtype=torch.int64, device=device)
    pos[1:1 + P] = torch.stack([torch.ones_like(r), 1 + r // gw,
                                1 + r % gw], 1)
    pos[1 + P:] = (max(gh, gw) + 1 + torch.arange(
        S - 1 - P, device=device))[:, None]
    return {"tokens": tokens,
            "patch_embeds": torch.randn(B, P, cfg.d_model, generator=g,
                                        device=device).to(cfg.dtype),
            "positions": pos[None].expand(B, S, 3)}


def check_mrope_is_rope(torch, cfg, device) -> dict:
    """``apply_mrope`` with t = h = w (the engine's text positions) against
    ``apply_rope`` on the card, bit for bit, at the prefill's query shape
    (4, 1024, H, hd) in bf16 and f32, seeded; and how far distinct (t, h,
    w) streams move the rotation (a reading)."""
    from repro_torch.models.common import apply_mrope, apply_rope
    g = torch.Generator(device=device).manual_seed(17)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(SERVE_REQUESTS, SERVE_PROMPT, cfg.n_heads, cfg.hd,
                        generator=g, device=device).to(dtype)
        pos = torch.arange(SERVE_PROMPT, device=device)[None].expand(
            SERVE_REQUESTS, SERVE_PROMPT)
        rope = apply_rope(x, pos, cfg.rope_theta)
        same = apply_mrope(x, pos[..., None].expand(*pos.shape, 3),
                           cfg.rope_theta, cfg.mrope_sections)
        grid = torch.stack([pos, pos // 2, pos % 7], -1)
        other = apply_mrope(x, grid, cfg.rope_theta, cfg.mrope_sections)
        out[str(dtype).replace("torch.", "")] = dict(
            bitwise=torch.equal(same, rope),
            distinct_streams_move=float(
                (other.float() - rope.float()).abs().max()
                / rope.float().abs().max()))
        del x, rope, same, other
    return out


def run_vlm_serving_path(torch, ops, flash_ms: float,
                         device="cuda") -> dict:
    """Phase 4h: qwen2-vl-72b at full width, depth VLM_LAYERS (seeded bf16
    weights) with the flash kernel through ``ServingEngine`` at B =
    SERVE_REQUESTS: warmed on the prompts' first 256 tokens (its decode
    graph captured there), then phase 4's prompt length and SERVE_NEW new
    tokens served eager and graphed (:func:`serve_eager_and_graphed`: the
    same greedy tokens, nothing captured in the run; the engine prefills on
    text positions, t = h = w); the launch counters, set to 0 just before
    each run and read just after, read one flash launch a layer in the
    prefill (G = 8) and none in the decode; a replay free of host syncs;
    the prefill's last logits against the plain branch's; its time,
    kernels and device time beside its FLOP, a step's against its bytes'
    bound; then ``prefill_step`` through the entry point with an image
    (:func:`vlm_image_batch`), the kernel against the plain branch, timed;
    then :func:`check_mrope_is_rope`.  ``flash_ms``: 2d's bf16 kernel time
    at FLASH_SHAPE_VLM.  The model is freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import prefill_step
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS,
                                       use_flash_kernel=True)
    B = SERVE_REQUESTS
    scfg = ServeConfig(max_batch=B, max_len=SERVE_PROMPT + 2 * SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, scfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    model = eng.params
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = serve_prompts(torch, cfg.vocab_size)
    warm_engine(torch, eng, prompts)
    log(f"4h vlm ({VLM_ARCH}, depth {VLM_LAYERS}): warmed at batch {B}, "
        f"the decode graph captured in {eng.stats['capture_s']:.3f} s")
    runs = serve_eager_and_graphed(torch, ops, eng, prompts, "4h vlm")
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), flash_attention=cfg.n_layers)
    for mode, r in runs.items():
        if r["launches"] != want or r["prefill_batches"] != 1:
            raise SystemExit(f"4h vlm ({mode} decode): launches "
                             f"{r['launches']} over {r['prefill_batches']} "
                             f"prefill batches; want {cfg.n_layers} flash "
                             "launches over 1 (none in a decode step)")
    serve_peak = torch.cuda.max_memory_allocated()
    prog = eng.programs[B]
    tokens = torch.tensor(prompts, device=device)
    plain = ServingEngine(cfg.replace(use_flash_kernel=False), scfg,
                          params=model, device=device)
    with torch.inference_mode():
        last = {"flash": eng.prefill(tokens)[0][:, -1].float(),
                "plain": plain.prefill(tokens)[0][:, -1].float()}
        torch.cuda.empty_cache()
        pre = device_activity(torch, lambda: eng.prefill(tokens), reps=1)
    del plain
    outputs = runs["graph"]["outputs"]
    finite = all(bool(torch.isfinite(t).all()) for t in last.values())
    err = float((last["flash"] - last["plain"]).abs().max()
                / last["plain"].abs().max())
    agree = (last["flash"].argmax(-1) == last["plain"].argmax(-1)).tolist()
    first = [o[0] for o in outputs] == last["flash"].argmax(-1).tolist()
    act = decode_activity(torch, eng, tokens)
    torch.cuda.empty_cache()
    dec = log_decode_runs("4h vlm", runs, act, eng)
    nbytes = vlm_decode_bytes(model, prog, B)
    bound = nbytes["total"] / HBM_BYTES_PER_S * 1e3
    flop = vlm_prefill_flop(cfg, B, SERVE_PROMPT)
    del eng, prog
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point with an image: the kernel's prefill (counted on its
    # own) against the plain branch's on the same batch, then the same
    # tokens on text positions (how far the image's ids move the logits)
    batch = vlm_image_batch(torch, cfg, tokens, device)
    text = {k: v for k, v in batch.items() if k != "positions"}
    with torch.inference_mode():
        prefill_step(model, cfg, batch)                   # warm-up
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = prefill_step(model, cfg, batch)[0]
        torch.cuda.synchronize()
        ep_prefill_ms = (time.perf_counter() - t0) * 1e3
        ep_launches = dict(ops.LAUNCHES)
        ep = {"flash": logits[:, -1].float()}
        del logits
        torch.cuda.empty_cache()
        ep["plain"] = prefill_step(model, cfg.replace(use_flash_kernel=False),
                                   batch)[0][:, -1].float()
        torch.cuda.empty_cache()
        ep["text"] = prefill_step(model, cfg, text)[0][:, -1].float()
        torch.cuda.empty_cache()
    ep_finite = all(bool(torch.isfinite(t).all()) for t in ep.values())
    ep_err = float((ep["flash"] - ep["plain"]).abs().max()
                   / ep["plain"].abs().max())
    image_moves = float((ep["text"] - ep["flash"]).abs().max()
                        / ep["flash"].abs().max())
    mrope = check_mrope_is_rope(torch, cfg, device)
    peak = torch.cuda.max_memory_allocated()
    g_run, e_run = runs["graph"], runs["eager"]
    rec = dict(
        arch=VLM_ARCH, config=f"full width, depth {VLM_LAYERS} of 80",
        dtype="bfloat16", parameters=n_params, weight_gb=weight_bytes / 1e9,
        init_s=init_s, init_peak_memory_gb=init_peak / 1e9,
        reduced={"n_layers": [80, VLM_LAYERS]}, requests=B,
        prompt_len=SERVE_PROMPT, max_len=scfg.max_len, new_tokens=SERVE_NEW,
        launches=g_run["launches"], eager_launches=e_run["launches"],
        prefill_ms=g_run["prefill_ms"], eager_prefill_ms=e_run["prefill_ms"],
        prefill_kernels=pre["kernels"], prefill_device_ms=pre["busy_ms"],
        prefill_busy_share=pre["busy_ms"] / g_run["prefill_ms"],
        prefill_tflop={k: v / 1e12 for k, v in flop.items()},
        prefill_bound_ms=sum(flop.values()) / PEAK_FLOPS["bfloat16"] * 1e3,
        flash_ms=flash_ms,
        flash_share_of_prefill=flash_ms * cfg.n_layers / g_run["prefill_ms"],
        decode_step_ms=g_run["decode_step_ms"],
        decode_step_ms_range=g_run["decode_step_ms_range"],
        eager_decode_step_ms=e_run["decode_step_ms"],
        eager_decode_step_ms_range=e_run["decode_step_ms_range"],
        tokens_per_s=g_run["tokens_per_s"],
        decode_tokens_per_s=g_run["decode_tokens_per_s"],
        decode_bytes=nbytes, decode_bound_ms=bound,
        serve_peak_memory_gb=serve_peak / 1e9, peak_memory_gb=peak / 1e9,
        logits_finite=finite, logits_max_rel_err=err,
        logits_tol=SERVE_LOGITS_TOL, argmax_agree=agree,
        first_tokens_are_logits_argmax=first,
        image_entry_point=dict(
            patches=VLM_GRID[0] * VLM_GRID[1], grid=list(VLM_GRID),
            prefill_ms=ep_prefill_ms, launches=ep_launches,
            logits_max_rel_err=ep_err, logits_tol=SERVE_LOGITS_TOL,
            finite=ep_finite, text_positions_move_logits=image_moves),
        mrope_vs_rope=mrope, outputs=outputs, **dec)
    log(f"4h vlm: {json.dumps(rec)}")
    log(f"4h vlm ({VLM_ARCH}, {n_params:,} parameters, depth {VLM_LAYERS} "
        f"of 80, {weight_bytes / 1e9:.2f} GB of bf16 drawn in "
        f"{init_s:.2f} s, {init_peak / 1e9:.2f} GB at the draw's peak): "
        f"{B} x {SERVE_PROMPT} tokens, {SERVE_NEW} new; launches "
        f"{g_run['launches']} graphed, {e_run['launches']} eager; prefill "
        f"{g_run['prefill_ms']:.2f} ms (eager run {e_run['prefill_ms']:.2f})"
        f", {pre['busy_ms']:.3f} ms of device and {pre['kernels']:.0f} "
        f"kernels (busy {rec['prefill_busy_share']:.3f}) for "
        f"{flop['projections'] / 1e12:.2f} TFLOP of projections and "
        f"{flop['attention'] / 1e12:.3f} of attention (bound "
        f"{rec['prefill_bound_ms']:.2f} ms at 989 TFLOP/s); the flash "
        f"kernel {rec['flash_share_of_prefill']:.4f} of it; a graphed step "
        f"{g_run['decode_step_ms']:.3f} ms (range "
        f"{g_run['decode_step_ms_range'][0]:.3f}-"
        f"{g_run['decode_step_ms_range'][1]:.3f}) against its "
        f"{nbytes['total'] / 1e9:.2f} GB bound of {bound:.3f} ms (layers "
        f"{nbytes['layers'] / 1e9:.2f} GB, head {nbytes['head'] / 1e9:.2f}, "
        f"K/V {nbytes['kv'] / 1e9:.3f}); eager "
        f"{e_run['decode_step_ms']:.3f} ms; {g_run['tokens_per_s']:.1f} "
        f"tokens/s; peak memory {serve_peak / 1e9:.2f} GB serving, "
        f"{peak / 1e9:.2f} GB in the phase [{card()}]")
    log(f"4h vlm prefill logits: the kernel's last-position logits "
        f"{err:.3e} off the plain branch's max-abs (tol {SERVE_LOGITS_TOL})"
        f", argmax agreement {sum(agree)}/{len(agree)}, finite {finite}; "
        f"the first tokens are the prefill's argmax: {first}")
    log(f"4h vlm entry point with an image: prefill_step on {B} x "
        f"{SERVE_PROMPT} tokens with {VLM_GRID[0] * VLM_GRID[1]} patch rows "
        f"at row 1 and their (t, h, w) ids over a {VLM_GRID[0]} x "
        f"{VLM_GRID[1]} grid: {ep_prefill_ms:.2f} ms (launches "
        f"{ep_launches}); the kernel's last logits {ep_err:.3e} off the "
        f"plain branch's (tol {SERVE_LOGITS_TOL}), finite {ep_finite}; the "
        f"same batch on text positions {image_moves:.3e} away; M-RoPE with "
        f"t = h = w against RoPE on the card: {mrope} [{card()}]")
    ok = (n_params == VLM_PARAMS and finite and err <= SERVE_LOGITS_TOL
          and ep_finite and ep_err <= SERVE_LOGITS_TOL and ep_launches == want
          and all(r["bitwise"] for r in mrope.values()))
    for mode in ("eager", "graph"):
        outs = runs[mode]["outputs"]
        if len(outs) != B or any(len(o) != SERVE_NEW for o in outs) or any(
                not 0 <= t < cfg.vocab_size for o in outs for t in o):
            ok = False
    if not ok:
        raise SystemExit(f"4h vlm: {rec}")
    del model, batch, text, ep, last
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_training_path(torch, ops, seed: int) -> dict:
    """Phase 6a: ``repro_torch.train.train`` on phi3-mini-3.8b (full width,
    depth ``TRAIN_LAYERS``, bf16 weights, f32 moments) on the card, with the
    launch counters set to 0 just before each run and read just after (no
    kernel of the port runs: training takes the plain attention branch);
    then the same run with a failure injected at ``TRAIN_FAIL_AT`` under
    ``run_with_restarts``, and ``TRAIN_I8_STEPS`` steps with 8-bit
    moments.  The checkpoints go under ``build/train/``, deleted after."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.optim import AdamWConfig, adamw_init, pipelined_clip_init
    from repro_torch.train import (FailureInjector, TrainConfig,
                                   make_train_step, run_with_restarts, train)
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size, seed=seed)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def tcfg(d, steps, state_dtype="f32"):
        return TrainConfig(
            steps=steps, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=os.path.join(TRAIN_DIR, d), seed=seed,
            opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(1, steps // 20),
                            decay_steps=steps, state_dtype=state_dtype))

    def run(label, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        losses = [h["loss"] for h in out["history"]]
        rec = dict(wall_s=wall, start_step=out["start_step"],
                   restarts=out.get("restarts", 0), losses=losses,
                   accepted=[h["accepted"] for h in out["history"]],
                   ms_per_step=statistics.median(
                       h["time_s"] for h in out["history"]) * 1e3,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   checkpoint=out["checkpoint"], launches=launched)
        log(f"6a {label}: {json.dumps(rec)} [{card()}]")
        if launched:
            raise SystemExit(f"6a {label}: the training path launched "
                             f"{launched}; it runs no kernel of the port")
        if not all(rec["accepted"]) or not all(
                math.isfinite(x) for x in losses):
            raise SystemExit(f"6a {label}: a step was rejected or a loss is "
                             f"not finite: {losses} {rec['accepted']}")
        return out, rec

    out, ref = run("train", lambda: train(
        cfg, dcfg, tcfg("ref", TRAIN_STEPS), device="cuda"))
    model = out["params"]
    n_params = sum(p.numel() for p in model.parameters())
    if not ref["losses"][-1] < ref["losses"][0]:
        raise SystemExit(f"6a train: the last loss is not below the first: "
                         f"{ref['losses']}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ref.update(params=n_params, tokens_per_step=tokens,
               tokens_per_s=tokens / (ref["ms_per_step"] / 1e3))
    ckpt = ref["checkpoint"]
    log(f"6a train {TRAIN_ARCH} depth {TRAIN_LAYERS} ({n_params:,} "
        f"parameters, bf16): {ref['ms_per_step']:.1f} ms per step (median "
        f"of {TRAIN_STEPS}), {ref['tokens_per_s']:.0f} tokens/s, loss "
        f"{ref['losses'][0]:.4f} -> {ref['losses'][-1]:.4f}, peak "
        f"{ref['peak_memory_gb']:.2f} GB; {ckpt['saves']} checkpoints of "
        f"{ckpt['bytes'] / ckpt['saves'] / 1e9:.3f} GB, "
        f"{ckpt['copy_s'] / ckpt['saves']:.2f} s to the host and "
        f"{ckpt['write_s'] / ckpt['saves']:.2f} s to disk each [{card()}]")

    # the device's busy share of one fused step, profiled (not counted)
    step_fn = make_train_step(cfg, tcfg("ref", TRAIN_STEPS))
    opt = adamw_init(dict(model.named_parameters()),
                     tcfg("ref", TRAIN_STEPS).opt)
    clip = pipelined_clip_init("cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             make_dataset(dcfg, cfg)(TRAIN_STEPS).items()}
    spike = torch.tensor(1e9, device="cuda")

    def one_step():
        m = step_fn(model, opt, clip, batch, spike)[3]
        float(m["loss"])
    one_step()
    prof = profile_device(torch, one_step, "chip_smoke_train_step")
    ref.update(step_kernels=prof["kernels"], step_device_ms=prof["busy_ms"],
               step_busy_share=prof["busy_ms"] / (prof["wall_s"] * 1e3))
    log(f"6a train: one profiled step {prof['wall_s'] * 1e3:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms ({ref['step_busy_share']:.3f}), "
        f"{prof['kernels']} kernels [{card()}]")
    del step_fn, opt, clip, batch, model, out, prof
    shutil.rmtree(os.path.join(TRAIN_DIR, "ref"), ignore_errors=True)

    inj = FailureInjector(fail_at=[TRAIN_FAIL_AT])
    _, restart = run("restart", lambda: run_with_restarts(
        lambda: train(cfg, dcfg, tcfg("restart", TRAIN_STEPS), injector=inj,
                      device="cuda"), max_restarts=2))
    want = ref["losses"][TRAIN_CKPT_EVERY:]
    gap = max(abs(a - b) / abs(b) for a, b in zip(restart["losses"], want))
    restart["loss_max_rel_gap"] = gap
    log(f"6a restart: resumed from step {restart['start_step']} after "
        f"{restart['restarts']} restart(s); steps {TRAIN_CKPT_EVERY}-"
        f"{TRAIN_STEPS - 1} {restart['losses']} against {want}: max "
        f"relative gap {gap:.3e} (tol {TRAIN_RESUME_RTOL:.0e}) [{card()}]")
    if restart["restarts"] != 1 or restart["start_step"] != TRAIN_CKPT_EVERY \
            or len(restart["losses"]) != len(want) \
            or not gap <= TRAIN_RESUME_RTOL:
        raise SystemExit("6a restart: the resumed run does not match the "
                         "uninterrupted one")
    shutil.rmtree(os.path.join(TRAIN_DIR, "restart"), ignore_errors=True)

    _, i8 = run("i8", lambda: train(
        cfg, dcfg, tcfg("i8", TRAIN_I8_STEPS, "i8"), device="cuda"))
    log(f"6a i8: {TRAIN_I8_STEPS} steps with 8-bit moments, losses "
        f"{i8['losses']}, peak {i8['peak_memory_gb']:.2f} GB (f32 moments "
        f"{ref['peak_memory_gb']:.2f}) [{card()}]")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(train=ref, restart=restart, i8=i8)


def run_train_mesh_path(torch, ops, seed: int, plain: dict) -> dict:
    """Phase 6d: 6a's run (``plain``, its record) through ``train(lm=)`` on
    a one-rank NCCL (1, 1) ("data", "model") mesh: every parameter a
    DTensor placed as ``module_param_specs`` says, each step's loss beside
    6a's (bitwise expected), ms a step against 6a's (DTensor's dispatch on
    the host), the device's busy share of one profiled step, peak memory,
    no kernel of the port launched; the mesh's checkpoint (its last step,
    under ``build/train_mesh/``, deleted after) restored by the plain
    trainer bit for bit."""
    import shutil
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.optim import AdamWConfig, adamw_init, pipelined_clip_init
    from repro_torch.parallel import LogicalMesh, module_param_specs
    from repro_torch.train import TrainConfig, make_train_step, train
    from repro_torch.train.train_loop import place_opt_state
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size, seed=seed)
    tcfg = TrainConfig(
        steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=TRAIN_MESH_DIR,
        seed=seed, opt=AdamWConfig(lr=TRAIN_LR,
                                   warmup_steps=max(1, TRAIN_STEPS // 20),
                                   decay_steps=TRAIN_STEPS))
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    with one_rank_mesh([], TRAIN_MESH_SHAPE, TRAIN_MESH_NAMES) as mesh:
        lm = LogicalMesh(mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = train(cfg, dcfg, tcfg, lm=lm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        model = out["params"]
        losses = [h["loss"] for h in out["history"]]
        gaps = [abs(a - b) for a, b in zip(losses, plain["losses"])]
        rec = dict(wall_s=wall, losses=losses, plain_losses=plain["losses"],
                   max_abs_gap=max(gaps), bitwise=losses == plain["losses"],
                   accepted=[h["accepted"] for h in out["history"]],
                   ms_per_step=statistics.median(
                       h["time_s"] for h in out["history"]) * 1e3,
                   plain_ms_per_step=plain["ms_per_step"],
                   peak_memory_gb=peak,
                   plain_peak_memory_gb=plain["peak_memory_gb"],
                   checkpoint=out["checkpoint"], launches=launched)
        # the values the checkpoint of the last step holds (copied: on one
        # rank full_tensor() is the parameter's own storage, which the
        # profiled step below writes)
        full = {k: p.full_tensor().clone()
                for k, p in model.named_parameters()}
        # every parameter a DTensor on the mesh, placed by the rules
        specs = module_param_specs(model, lm)
        wrong = [k for k, p in model.named_parameters()
                 if not isinstance(p, DTensor) or p.device_mesh is not mesh
                 or tuple(p.placements) != lm.placements(specs[k])]
        rec["params_placed"] = len(specs) - len(wrong)
        rec["params"] = len(specs)
        rec["sharded_specs"] = sum(any(e is not None for e in spec)
                                   for spec in specs.values())
        log(f"6d train on a (1, 1) mesh: {json.dumps(rec)} [{card()}]")
        if wrong:
            raise SystemExit(f"6d: parameters not placed by the rules: "
                             f"{wrong[:5]}")
        if launched:
            raise SystemExit(f"6d: the training path launched {launched}; "
                             "it runs no kernel of the port")
        if len(losses) != TRAIN_STEPS or not all(rec["accepted"]) \
                or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"6d: a step was rejected or a loss is not "
                             f"finite: {losses} {rec['accepted']}")
        for step, (a, b) in enumerate(zip(losses, plain["losses"])):
            log(f"6d step {step}: loss {a!r} on the mesh, {b!r} in 6a, gap "
                f"{abs(a - b):.3e} [{card()}]")
        if not rec["bitwise"]:
            raise SystemExit(f"6d: the mesh's losses are not 6a's bit for "
                             f"bit: largest gap {rec['max_abs_gap']:.3e}")

        # the device's busy share of one fused step on the mesh, profiled
        step_fn = make_train_step(cfg, tcfg, lm)
        params = dict(model.named_parameters())
        opt = place_opt_state(adamw_init(params, tcfg.opt), specs, lm)
        clip = pipelined_clip_init("cuda")
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                 make_dataset(dcfg, cfg)(TRAIN_STEPS).items()}
        spike = torch.tensor(1e9, device="cuda")

        def one_step():
            m = step_fn(model, opt, clip, batch, spike)[3]
            float(m["loss"])
        one_step()
        prof = profile_device(torch, one_step, "chip_smoke_train_mesh_step")
        rec.update(step_kernels=prof["kernels"],
                   step_device_ms=prof["busy_ms"],
                   step_wall_ms=prof["wall_s"] * 1e3,
                   step_busy_share=prof["busy_ms"] / (prof["wall_s"] * 1e3),
                   plain_step_busy_share=plain["step_busy_share"])
        log(f"6d train on a (1, 1) mesh: {rec['ms_per_step']:.1f} ms a step "
            f"(median of {TRAIN_STEPS}) against 6a's "
            f"{plain['ms_per_step']:.1f}; one profiled step "
            f"{rec['step_wall_ms']:.1f} ms, device busy "
            f"{rec['step_device_ms']:.1f} ms ({rec['step_busy_share']:.3f}; "
            f"6a {plain['step_busy_share']:.3f}), {prof['kernels']} kernels; "
            f"peak {peak:.2f} GB (6a {plain['peak_memory_gb']:.2f}); "
            f"{rec['params_placed']} of {rec['params']} parameters DTensors "
            f"placed by module_param_specs [{card()}]")
        del step_fn, opt, clip, batch, params, model, out, prof
    # the mesh's checkpoint, restored by the plain trainer (its last step:
    # no step runs)
    t0 = time.perf_counter()
    back = train(cfg, dcfg, tcfg, device="cuda")
    rec["restore_s"] = time.perf_counter() - t0
    restored = dict(back["params"].named_parameters())
    same = [k for k, t in full.items() if torch.equal(restored[k], t)]
    rec["restored_bitwise"] = len(same)
    log(f"6d: the mesh's checkpoint of step {TRAIN_STEPS} restored by the "
        f"plain trainer (start step {back['start_step']}) in "
        f"{rec['restore_s']:.1f} s: {len(same)} of {len(full)} parameters "
        f"bit for bit; the phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card()}]")
    if back["start_step"] != TRAIN_STEPS or len(same) != len(full):
        raise SystemExit("6d: the mesh's checkpoint does not restore bit "
                         "for bit in the plain trainer")
    del back, restored, full
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def _counted(torch, ops, fn):
    """``fn()`` run for real with the launch counters set to 0 just before
    it and read just after; returns ``(its value, launches, wall s)``."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES), time.perf_counter() - t0


def _same_counts(label: str, fake: dict, real: dict) -> None:
    keys = ("flops", "bytes", "dot_bytes")
    for k in keys:
        if fake[k] != real[k]:
            raise SystemExit(f"6e {label}: the fake {k} {fake[k]!r} is not "
                             f"the real run's {real[k]!r}")
    if fake["collectives"]["counts"] != real["collectives"]["counts"]:
        raise SystemExit(f"6e {label}: the fake collectives "
                         f"{fake['collectives']['counts']} are not the real "
                         f"run's {real['collectives']['counts']}")


def _launch_solver_cell(torch, ops, mesh) -> dict:
    """6e's solver cell: ``dryrun_solver``'s step at 3a's grid on the mesh,
    counted in fake mode (one step) and for real (LAUNCH_SOLVER_STEPS after
    a warm one), then LAUNCH_SOLVER_STEPS real steps timed uncounted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun_solver as ds

    def build(fake):
        return ds.build_step("p-bicgsafe", mesh, NX, NX, NX, torch.float64,
                             SOLVE_MAXITER, device="cuda", fake=fake)
    step, state, consts, _ = build(True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = ds.count_steps(step, state, consts, 1)
    del step, state, consts
    step, state, consts, _ = build(False)
    real, launched, _ = _counted(torch, ops, lambda: ds.count_steps(
        step, state, consts, LAUNCH_SOLVER_STEPS))
    _same_counts("solver", fake, real)
    ran = LAUNCH_SOLVER_STEPS + 1                      # the warm step too
    for k in ("fused_dots", "fused_axpy"):
        if launched.get(k) != ran:
            raise SystemExit(f"6e solver: {k} launched {launched.get(k)} "
                             f"times in {ran} steps, not once a step")
    st = real["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCH_SOLVER_STEPS):
        st = step(st, consts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / LAUNCH_SOLVER_STEPS
    counts = fake["collectives"]["counts"]
    rec = dict(n=NX ** 3, flops=fake["flops"], bytes=fake["bytes"],
               dot_bytes=fake["dot_bytes"], collectives=counts,
               real_collectives=real["collectives"]["counts"],
               launches=launched, steps_run=ran, ms_per_iteration=ms,
               bytes_ms=fake["bytes"] / HBM_BYTES_PER_S * 1e3,
               state_bytes=real["argument_size_in_bytes"],
               fake_peak_bytes=fake["peak_memory_in_bytes"])
    log(f"6e solver cell (p-bicgsafe, {NX}^3 fp64, cuda, a (1, 1) mesh): "
        f"fake = real per iteration: {fake['flops']:.6e} FLOP, "
        f"{fake['bytes']:.6e} B ({rec['bytes_ms']:.4f} ms at 3.35 TB/s), "
        f"dot bytes {fake['dot_bytes']:.6e}, collectives {counts}; "
        f"fused_dots {launched.get('fused_dots')} and fused_axpy "
        f"{launched.get('fused_axpy')} launches in {ran} steps; "
        f"{ms:.4f} ms an eager iteration; state {rec['state_bytes'] / 1e6:.1f}"
        f" MB [{card()}]")
    if counts.get("all-reduce") != 1:
        raise SystemExit(f"6e solver: {counts} is not one all-reduce an "
                         "iteration")
    return rec


def _launch_prefill_cell(torch, ops, lm) -> dict:
    """6e's prefill cell: ``dryrun.build_cell``'s qwen3-8b prefill at phase
    4's size with flash on, on the mesh: counted in fake mode, run for real
    counted (the flash launches, the card's peak), then timed uncounted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.flops import Counter
    sp = ShapeSpec("prefill", SERVE_PROMPT, SERVE_REQUESTS, "prefill")
    over = {"use_flash_kernel": True}

    def count(cell):
        with Counter(track_memory=True) as c:
            c.hold(cell.arguments)
            cell.fn()
        return dict(c.totals(), collectives=c.collectives(),
                    peak=c.peak_bytes)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = count(dryrun.build_cell(SERVE_ARCH, sp, overrides=over,
                                       lm=lm, device="cuda"))
    torch.cuda.empty_cache()
    cell = dryrun.build_cell(SERVE_ARCH, sp, overrides=over, lm=lm,
                             device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real, launched, counted_s = _counted(torch, ops, lambda: count(cell))
    card_peak = torch.cuda.max_memory_allocated()
    _same_counts("prefill", fake, real)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = cell.fn()[0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    logits = logits.full_tensor() if hasattr(logits, "full_tensor") \
        else logits
    finite = bool(torch.isfinite(logits.float()).all())
    hand = sum(vlm_prefill_flop(cell.cfg, SERVE_REQUESTS,
                                SERVE_PROMPT).values())
    layers, vocab = cell.cfg.n_layers, cell.cfg.vocab_size
    wall = min(walls)
    rec = dict(flops=fake["flops"], bytes=fake["bytes"],
               dot_bytes=fake["dot_bytes"], hand_flops=hand,
               hand_rel=fake["flops"] / hand - 1,
               collectives=fake["collectives"]["counts"],
               launches=launched, counted_wall_s=counted_s, wall_s=walls,
               tflops=fake["flops"] / wall / 1e12,
               peak_share=fake["flops"] / wall / BF16_PEAK_FLOPS,
               fake_peak_bytes=fake["peak"], card_peak_bytes=card_peak,
               peak_ratio=fake["peak"] / card_peak,
               logits_shape=list(logits.shape), finite=finite)
    log(f"6e prefill cell ({SERVE_ARCH}, {SERVE_REQUESTS} x {SERVE_PROMPT} "
        f"tokens, bf16, flash on, a (1, 1) mesh): fake = real "
        f"{fake['flops']:.6e} FLOP (hand count, causal S (S + 1) / 2: "
        f"{hand:.6e}, {rec['hand_rel']:+.2e}), {fake['bytes']:.6e} B; "
        f"flash launched {launched.get('flash_attention', 0)}; wall "
        f"{wall * 1e3:.2f} ms ({walls[0] * 1e3:.2f}, {walls[1] * 1e3:.2f}), "
        f"{rec['tflops']:.1f} TFLOP/s, {rec['peak_share']:.4f} of 989; peak "
        f"fake {fake['peak'] / 1e9:.3f} GB, card {card_peak / 1e9:.3f} GB, "
        f"ratio {rec['peak_ratio']:.3f} [{card()}]")
    del cell, logits
    torch.cuda.empty_cache()
    if launched.get("flash_attention", 0) != layers:
        raise SystemExit(f"6e prefill: the flash op launched "
                         f"{launched.get('flash_attention', 0)} times, not "
                         f"once a layer ({layers}): the DTensor prefill did "
                         "not reach the kernel")
    if not abs(rec["hand_rel"]) <= LAUNCH_HAND_RTOL:
        raise SystemExit(f"6e prefill: the count is {rec['hand_rel']:+.3e} "
                         f"off the hand count")
    lo, hi = LAUNCH_PEAK_RATIO
    if not lo <= rec["peak_ratio"] <= hi:
        raise SystemExit(f"6e prefill: the fake peak is {rec['peak_ratio']}"
                         f" x the card's, outside {LAUNCH_PEAK_RATIO}")
    if not finite or rec["logits_shape"] != [SERVE_REQUESTS, SERVE_PROMPT,
                                             vocab]:
        raise SystemExit(f"6e prefill: logits {rec['logits_shape']} finite "
                         f"{finite}")
    return rec


def _launch_train_cell(torch, lm, mesh_rec: dict, seed: int) -> dict:
    """6e's train cell: 6d's step (``make_train_step`` on the mesh: loss
    and grad, the clip, the gate, AdamW) counted in fake mode; nothing runs
    on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.launch.flops import Counter
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, pipelined_clip_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_loop import place_model, place_opt_state
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(steps=TRAIN_STEPS, seed=seed, opt=AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(1, TRAIN_STEPS // 20),
        decay_steps=TRAIN_STEPS))
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = init_params(cfg, torch.Generator(device="cuda"))
        specs = place_model(model, lm)
        opt = place_opt_state(adamw_init(dict(model.named_parameters()),
                                         tcfg.opt), specs, lm)
        clip = pipelined_clip_init("cuda")
        batch = {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ),
                                       dtype=torch.int32, device="cuda")}
        spike = torch.tensor(1e9, device="cuda")
        step_fn = make_train_step(cfg, tcfg, lm)
        with Counter(track_memory=True) as c:
            c.hold((dict(model.named_parameters()), opt, batch))
            step_fn(model, opt, clip, batch, spike)
    ms = mesh_rec["ms_per_step"]
    rec = dict(flops=c.flops, bytes=c.bytes, dot_bytes=c.dot_bytes,
               fake_peak_bytes=c.peak_bytes,
               collectives=c.collectives()["counts"],
               trace_s=time.perf_counter() - t0,
               measured_ms_per_step=ms,
               measured_peak_gb=mesh_rec["peak_memory_gb"],
               mfu=c.flops / (ms / 1e3) / BF16_PEAK_FLOPS)
    log(f"6e train cell (6d's step, {TRAIN_ARCH} depth {TRAIN_LAYERS}, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, counted in fake mode in "
        f"{rec['trace_s']:.1f} s): {c.flops:.6e} FLOP, fake peak "
        f"{c.peak_bytes / 1e9:.3f} GB beside 6d's measured "
        f"{mesh_rec['peak_memory_gb']:.3f} GB; at 6d's {ms:.1f} ms a step "
        f"{c.flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, MFU {rec['mfu']:.4f} "
        f"of 989 [{card()}]")
    return rec


def _mesh_placed(lm, t, *names):
    """``t`` placed on ``lm``'s mesh by the logical ``names``, a name
    dropped where its axes do not divide the dimension (the dry run's
    ``div_spec``)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import div_spec
    return distribute_tensor(t, lm.mesh,
                             lm.placements(div_spec(lm, t.shape, *names)))


def _count_call(args, fn):
    """``fn()`` under the dry run's counter, ``args`` held as its
    arguments: ``(its value, {flops, bytes, dot_bytes, collectives,
    peak})``."""
    from repro_torch.launch.flops import Counter
    with Counter(track_memory=True) as c:
        c.hold(args)
        out = fn()
    return out, dict(c.totals(), collectives=c.collectives(),
                     peak=c.peak_bytes)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _launch_mla_decode_cell(torch, ops, lm) -> dict:
    """6e (d): deepseek-v3-671b's decode on the mesh (LAUNCH_MLA_STEPS):
    one step counted in fake mode and for real, the counts equal; 4c's
    prompts prefilled off the mesh, then the same greedy steps off the mesh
    and on it (counted: the grouped kernel, 3 a layer a step), logits and
    tokens bitwise equal.  The model is freed before it returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.models import (cache_logical_axes, decode_step,
                                    init_cache, init_params, prefill_step)
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.train.train_loop import place_model
    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_LAYERS, use_mtp=False)
    B, S, n = SERVE_REQUESTS, SERVE_PROMPT, LAUNCH_MLA_STEPS
    axes = cache_logical_axes(cfg)

    def on_mesh(model, cache, tokens):
        place_model(model, lm)
        return ({k: _mesh_placed(lm, v, *axes[k]) for k, v in cache.items()},
                _mesh_placed(lm, tokens, "batch", None))

    def step(model, cache, tokens, row: int, mesh: bool):
        cache_len = torch.full((), row, dtype=torch.int32, device="cuda")
        with torch.no_grad(), mesh_context(lm if mesh else None):
            return decode_step(model, cfg, cache, tokens, cache_len)[0]

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fmodel = init_params(cfg, torch.Generator(device="cuda"))
        fcache, ftok = on_mesh(fmodel, init_cache(
            cfg, B, S + n, device="cuda"), torch.zeros(
            (B, 1), dtype=torch.int32, device="cuda"))
        _, fake = _count_call((dict(fmodel.named_parameters()), fcache,
                               ftok), lambda: step(fmodel, fcache, ftok, S,
                                                   True))
        del fmodel, fcache, ftok
    fake_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        LAUNCH_MLA_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    prompts = torch.tensor(serve_prompts(torch, cfg.vocab_size),
                           dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, pcache = prefill_step(model, cfg, {"tokens": prompts})
        first = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        del logits
        cache = init_cache(cfg, B, S + n, device="cuda")
        for key, dst in cache.items():
            dst[:, :, :S].copy_(pcache[key])
        del pcache

    def run(cache, tokens, mesh: bool):
        rows, toks = [], []
        for i in range(n):
            lg = _whole(step(model, cache, tokens, S + i, mesh))[:, -1]
            rows.append(lg.float())
            nxt = lg.argmax(-1, keepdim=True).to(torch.int32)
            toks.append(nxt[:, 0].tolist())
            tokens = _mesh_placed(lm, nxt, "batch", None) if mesh else nxt
        return rows, toks

    (off, off_toks), off_launched, off_s = _counted(
        torch, ops, lambda: run({k: v.clone() for k, v in cache.items()},
                                first, False))
    # the step counted for real on a copy of the cache, then the steps
    mcache, mtok = on_mesh(model, {k: v.clone() for k, v in cache.items()},
                           first)
    _, real = _count_call((dict(model.named_parameters()), mcache, mtok),
                          lambda: step(model, mcache, mtok, S, True))
    _same_counts("mla decode", fake, real)
    mcache, mtok = ({k: _mesh_placed(lm, v, *axes[k])
                     for k, v in cache.items()},
                    _mesh_placed(lm, first, "batch", None))
    (on, on_toks), launched, on_s = _counted(
        torch, ops, lambda: run(mcache, mtok, True))
    bitwise = all(torch.equal(a, b) for a, b in zip(on, off))
    gap = max(float((a - b).abs().max()) for a, b in zip(on, off))
    finite = all(bool(torch.isfinite(a).all()) for a in on)
    per = 3 * cfg.n_layers
    rec = dict(layers=cfg.n_layers, weight_gb=weight_gb, init_s=init_s,
               fake_trace_s=fake_s, flops=fake["flops"],
               bytes=fake["bytes"], dot_bytes=fake["dot_bytes"],
               collectives=fake["collectives"]["counts"],
               fake_peak_bytes=fake["peak"], launches=launched,
               off_mesh_launches=off_launched, steps=n,
               ms_per_step=on_s * 1e3 / n, off_ms_per_step=off_s * 1e3 / n,
               tokens=on_toks, tokens_equal=on_toks == off_toks,
               logits_bitwise=bitwise, logits_max_abs_gap=gap,
               finite=finite)
    log(f"6e (d) MLA decode cell ({MLA_ARCH}, depth {cfg.n_layers}, "
        f"{weight_gb:.2f} GB of bf16 drawn in {init_s:.1f} s, B = {B}, "
        f"{n} greedy steps after a {S}-token prefill, a (1, 1) mesh): fake "
        f"= real a step: {fake['flops']:.6e} FLOP, {fake['bytes']:.6e} B, "
        f"collectives {rec['collectives']} (fake traced in {fake_s:.1f} s);"
        f" grouped_mm launched {launched.get('grouped_mm', 0)} on the mesh "
        f"({per} a step); {rec['ms_per_step']:.2f} ms a step on the mesh, "
        f"{rec['off_ms_per_step']:.2f} off it (eager, host-bound); tokens "
        f"equal {rec['tokens_equal']}, logits bitwise {bitwise} (max gap "
        f"{gap:.3e}) [{card()}]")
    del model, cache, mcache, mtok, on, off
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), grouped_mm=per * n)
    if launched != want or off_launched != want:
        raise SystemExit(f"6e (d): launches {launched} on the mesh and "
                         f"{off_launched} off it; want {want}")
    if not (finite and bitwise and rec["tokens_equal"]):
        raise SystemExit(f"6e (d): the mesh's decode is not the plain one's"
                         f": tokens {on_toks} against {off_toks}, logits "
                         f"bitwise {bitwise} (gap {gap:.3e}), finite {finite}")
    return rec


def _launch_whisper_prefill_cell(torch, ops, lm) -> dict:
    """6e (e): whisper-tiny's ``prefill_step`` on the mesh, flash on, over
    4g's prompts and AUDIO_FRAMES seeded frames: counted in fake mode and
    for real (counted: the flash kernel once a decoder layer, through its
    DTensor rule), the counts equal; logits within SERVE_LOGITS_TOL of the
    plain prefill off the mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill_step
    from repro_torch.models.common import sinusoidal_on
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.train.train_loop import place_model
    cfg = get_config(AUDIO_ARCH).replace(use_flash_kernel=True)
    B, S, T = SERVE_REQUESTS, AUDIO_PROMPT, AUDIO_FRAMES

    def on_mesh(model, tokens, frames):
        place_model(model, lm)
        return {"tokens": _mesh_placed(lm, tokens, "batch", None),
                "frames": _mesh_placed(lm, frames, "batch", None, None)}

    def prefill(model, c, batch, mesh: bool):
        with torch.no_grad(), mesh_context(lm if mesh else None):
            return prefill_step(model, c, batch)[0]

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fmodel = init_params(cfg, torch.Generator(device="cuda"))
        fbatch = on_mesh(fmodel, torch.zeros(
            (B, S), dtype=torch.int32, device="cuda"), torch.zeros(
            (B, T, cfg.d_model), dtype=cfg.dtype, device="cuda"))
        _, fake = _count_call((dict(fmodel.named_parameters()), fbatch),
                              lambda: prefill(fmodel, cfg, fbatch, True))
        del fmodel, fbatch
    fake_s = time.perf_counter() - t0

    gen = torch.Generator().manual_seed(14)             # 4g's prompts
    tokens = torch.tensor([torch.randint(1, cfg.vocab_size, (S,),
                                         generator=gen).tolist()
                           for _ in range(B)], dtype=torch.int32,
                          device="cuda")
    g = torch.Generator(device="cuda").manual_seed(15)  # 4g's frames
    frames = torch.randn(B, T, cfg.d_model, generator=g,
                         device="cuda").to(cfg.dtype)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(13))
    plain = prefill(model, cfg.replace(use_flash_kernel=False),
                    {"tokens": tokens, "frames": frames}, False).float()
    batch = on_mesh(model, tokens, frames)
    args = (dict(model.named_parameters()), batch)
    # the encoder's sinusoidal positions, a copy to the card cached per
    # shape (4g and the plain prefill made them), made inside the counted
    # run as a fake-mode trace makes them
    sinusoidal_on.cache_clear()
    (logits, real), launched, wall = _counted(torch, ops, lambda: _count_call(
        args, lambda: prefill(model, cfg, batch, True)))
    _same_counts("whisper prefill", fake, real)
    logits = _whole(logits).float()
    finite = bool(torch.isfinite(logits).all())
    err = float((logits - plain).abs().max() / plain.abs().max())
    rec = dict(flops=fake["flops"], bytes=fake["bytes"],
               dot_bytes=fake["dot_bytes"],
               collectives=fake["collectives"]["counts"],
               fake_peak_bytes=fake["peak"], fake_trace_s=fake_s,
               launches=launched, counted_wall_s=wall,
               logits_shape=list(logits.shape), finite=finite,
               logits_max_rel_err=err, tol=SERVE_LOGITS_TOL)
    log(f"6e (e) whisper prefill cell ({AUDIO_ARCH}, {B} x {S} tokens and "
        f"{T} frames, bf16, flash on, a (1, 1) mesh): fake = real "
        f"{fake['flops']:.6e} FLOP, {fake['bytes']:.6e} B, collectives "
        f"{rec['collectives']}; flash launched "
        f"{launched.get('flash_attention', 0)} (once a decoder layer); "
        f"logits {err:.3e} off the plain prefill off the mesh (tol "
        f"{SERVE_LOGITS_TOL}); counted run {wall * 1e3:.1f} ms [{card()}]")
    del model, batch, args, logits, plain
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), flash_attention=cfg.n_layers)
    if launched != want:
        raise SystemExit(f"6e (e): launches {launched}; want {want}")
    if not finite or err > SERVE_LOGITS_TOL \
            or rec["logits_shape"] != [B, S, cfg.vocab_size]:
        raise SystemExit(f"6e (e): logits {rec['logits_shape']} finite "
                         f"{finite}, {err:.3e} off the plain prefill")
    return rec


def run_launch_path(torch, ops, mesh_rec: dict, seed: int) -> dict:
    """Phase 6e: the dry run's cells (``repro_torch.launch``) on a one-rank
    NCCL (1, 1) ("data", "model") mesh, each real run with the launch
    counters set to 0 just before it and read just after: the solver cell,
    the prefill cell, deepseek-v3's decode and whisper's prefill, fake
    counts equal to real ones; the train cell counted only.  ``mesh_rec``:
    6d's record."""
    from repro_torch.parallel import LogicalMesh
    t0 = time.perf_counter()
    with one_rank_mesh([], TRAIN_MESH_SHAPE, TRAIN_MESH_NAMES) as mesh:
        lm = LogicalMesh(mesh)
        solver = _launch_solver_cell(torch, ops, mesh)
        torch.cuda.empty_cache()
        prefill = _launch_prefill_cell(torch, ops, lm)
        train = _launch_train_cell(torch, lm, mesh_rec, seed)
        mla = _launch_mla_decode_cell(torch, ops, lm)
        audio = _launch_whisper_prefill_cell(torch, ops, lm)
    launches = collections.Counter(solver["launches"])
    for cell in (prefill, mla, audio):
        launches.update(cell["launches"])
    wall = time.perf_counter() - t0
    log(f"6e: the phase took {wall:.1f} s; launches {dict(launches)} "
        f"[{card()}]")
    torch.cuda.empty_cache()
    return dict(solver=solver, prefill=prefill, train=train, mla_decode=mla,
                whisper_prefill=audio, launches=dict(launches), wall_s=wall)


def run_newton_krylov_path(torch, ops, seed: int) -> dict:
    """Phase 6b: ``newton_krylov_step`` on phi3-mini-3.8b (full width, depth
    ``NK_LAYERS``, f32, remat none) on the card, its inner p-BiCGSafe solve
    on ``substrate="cuda"`` and then on ``"torch"`` from the same weights,
    the launch counters set to 0 just before each step and read just
    after; then one GGN matvec timed on its own (not counted)."""
    import functools
    from repro_torch.configs import get_config
    from repro_torch.core.pipelined_bicgsafe import pbicgsafe_solve
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.optim import (NewtonKrylovConfig, make_ggn_matvec,
                                   newton_krylov_step)
    from repro_torch.optim.newton_krylov import ravel
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=NK_LAYERS, dtype=torch.float32, param_dtype=torch.float32,
        remat="none")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    rv = ravel(model)
    if rv.flat.numel() != NK_PARAMS or rv.flat.dtype != torch.float32:
        raise SystemExit(f"6b: {rv.flat.numel()} {rv.flat.dtype} unknowns, "
                         f"not {NK_PARAMS} float32")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in make_dataset(
        DataConfig(batch_size=NK_BATCH, seq_len=NK_SEQ,
                   vocab_size=cfg.vocab_size, seed=seed), cfg)(0).items()}

    def loss_fn_(p, b):
        return loss_fn(p, cfg, b)[0]

    def logits_fn(p, b):
        return forward(p, cfg, b)[0]

    named = dict(model.named_parameters())
    signs = torch.where(torch.rand(
        rv.flat.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(5)) < 0.5, -1.0, 1.0) * 2.0 ** -24

    def step(label, sub, maxiter, perturb=False):
        """One step from the same weights, counted; its record."""
        with torch.no_grad():
            for k, t in rv.unravel(rv.flat).items():
                named[k].copy_(t)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats, solve_s = {}, []

        def solver(matvec, b, **kw):
            if perturb:                          # the rounding control
                b = b * (1.0 + signs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pbicgsafe_solve(matvec, b, substrate=sub, stats=stats,
                                  **kw)
            torch.cuda.synchronize()
            solve_s.append(time.perf_counter() - t0)
            return res
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        _, m = newton_krylov_step(
            loss_fn_, logits_fn, model, batch,
            NewtonKrylovConfig(**dict(NK_CFG, inner_maxiter=maxiter),
                               solver=solver))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(ops.LAUNCHES)
        rec = {k: float(v) for k, v in m.items()}
        rec.update(substrate=sub, inner_maxiter=maxiter, wall_s=wall,
                   solve_s=solve_s[0], steps=stats["steps"],
                   host_reads=stats["host_reads"],
                   graphs=stats.get("graphs", 0),
                   route="eager program" if not stats.get("graphs")
                   else "CUDA graph",
                   ms_per_inner_iteration=solve_s[0] * 1e3 / stats["steps"],
                   launches={k: v for k, v in launched.items() if v},
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"6b newton_krylov_step {label}: {json.dumps(rec)} [{card()}]")
        want = dict.fromkeys(ops.LAUNCHES, 0)
        if sub == "cuda":
            want.update(fused_dots=stats["steps"], fused_axpy=stats["steps"])
        if launched != want:
            raise SystemExit(f"6b {label}: launches {launched}, expected "
                             f"{want}")
        if not rec["new_loss"] <= rec["loss"] or not math.isfinite(
                rec["new_loss"]):
            raise SystemExit(f"6b {label}: the new loss {rec['new_loss']} "
                             f"is above the old {rec['loss']}")
        return rec

    def gap(a, b):
        return abs(a["new_loss"] - b["new_loss"]) / abs(b["new_loss"])

    runs = {sub: step(sub, sub, NK_CFG["inner_maxiter"])
            for sub in ("cuda", "torch")}
    control = step("torch, rhs perturbed", "torch", NK_CFG["inner_maxiter"],
                   perturb=True)
    one = {sub: step(f"{sub}, one inner iteration", sub, 1)
           for sub in ("cuda", "torch")}
    c, t = runs["cuda"], runs["torch"]
    decrease = {k: r["loss"] - r["new_loss"] for k, r in runs.items()}
    checks = dict(gap=gap(c, t), control_gap=gap(control, t),
                  one_iteration_gap=gap(one["cuda"], one["torch"]),
                  decrease_gap=abs(decrease["cuda"] - decrease["torch"])
                  / decrease["torch"])
    c.update(checks)
    log(f"6b cuda against torch: step scale {c['step_scale']} / "
        f"{t['step_scale']}, inner iterations {c['inner_iters']:.0f} / "
        f"{t['inner_iters']:.0f} ({c['steps']} / {t['steps']} steps "
        f"queued), inner relres {c['inner_relres']:.4e} / "
        f"{t['inner_relres']:.4e}, new loss {c['new_loss']:.6f} / "
        f"{t['new_loss']:.6f} from {c['loss']:.6f}: relative gap "
        f"{checks['gap']:.3e} (the right-hand side's rounding control "
        f"{checks['control_gap']:.3e}), the decreases' "
        f"{checks['decrease_gap']:.3e} (tol {NK_DECREASE_RTOL:.0e}); after "
        f"one inner iteration {checks['one_iteration_gap']:.3e} (tol "
        f"{NK_LOSS_RTOL:.0e}); route: {c['route']} [{card()}]")
    if c["step_scale"] != t["step_scale"] \
            or abs(c["inner_iters"] - t["inner_iters"]) > NK_ITER_SLACK \
            or not checks["decrease_gap"] <= NK_DECREASE_RTOL \
            or not checks["one_iteration_gap"] <= NK_LOSS_RTOL:
        raise SystemExit("6b: the cuda and torch substrates' steps differ")
    del signs

    # one GGN matvec on its own, at the step's linearization point
    with torch.no_grad():
        for k, tt in rv.unravel(rv.flat).items():
            named[k].copy_(tt)
    matvec, flat0, _ = make_ggn_matvec(logits_fn, model, batch,
                                       NK_CFG["damping"])
    v = torch.randn(flat0.shape, device="cuda", dtype=flat0.dtype,
                    generator=torch.Generator(device="cuda").manual_seed(3))
    matvec_ms = device_ms(torch, lambda: matvec(v), reps=4, trials=3)
    for rec in runs.values():
        rec["matvec_ms"] = matvec_ms
    log(f"6b GGN matvec: {matvec_ms:.3f} ms ({NK_PARAMS:,} unknowns, f32); "
        f"an inner iteration {c['ms_per_inner_iteration']:.3f} ms on cuda, "
        f"{t['ms_per_inner_iteration']:.3f} on torch [{card()}]")
    del matvec, flat0, v, model, rv, named, batch
    torch.cuda.empty_cache()
    return runs


def check_nk_kernels(torch, ops, ref, n: int) -> dict:
    """Phase 6c: rows 1 and 2 (``NK_KERNELS``) in f32 at the Newton-Krylov
    solve's n against their plain versions, at phase 2's tolerances, timed
    beside their bounds (not counted)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    item = 4

    def randn():
        return torch.randn(n, generator=gen, device="cuda",
                           dtype=torch.float32)
    out = {}
    s, y, r, t, rs = (randn() for _ in range(5))
    got = ops.fused_dots(s, y, r, t, rs)
    want = ref.fused_dots(s, y, r, t, rs)
    scale = ref.fused_dots(*(x.abs() for x in (s, y, r, t, rs)))
    out["fused_dots"] = dict(
        err=float(((got - want).abs() / scale).max()),
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(torch, lambda: ops.fused_dots(s, y, r, t, rs)),
        plain_ms=device_ms(torch, lambda: ref.fused_dots(s, y, r, t, rs)),
        bound=bound_ms(5 * item * n + 9 * item, 18 * n, "float32"))
    stacked = torch.stack([s, y, r, t, rs])
    out["fused_dots"]["library_ms"] = device_ms(
        torch, lambda: stacked @ stacked.T)
    del s, y, r, t, rs, stacked, scale
    torch.cuda.empty_cache()

    from repro_torch.kernels.fused_axpy import IN_ORDER
    vecs = {key: randn() for key in IN_ORDER}
    scal = torch.tensor([0.3, -0.7, 1.1, 0.2], dtype=torch.float32,
                        device="cuda")
    got = ops.fused_axpy(vecs, scal)
    want = ref.fused_axpy(vecs, scal.unbind(0))
    out["fused_axpy"] = dict(
        err=max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
                for k in want),
        max_abs_err=max(float((got[k] - want[k]).abs().max())
                        for k in want),
        library_ms=None,
        bound=bound_ms(22 * item * n + 4 * item, 34 * n, "float32"))
    del got, want
    torch.cuda.empty_cache()
    out["fused_axpy"].update(
        ms=device_ms(torch, lambda: ops.fused_axpy(vecs, scal)),
        plain_ms=device_ms(torch, lambda: ref.fused_axpy(
            vecs, scal.unbind(0))))
    del vecs
    torch.cuda.empty_cache()
    for kname, rec in out.items():
        rec.update(n=n, tol=TOL["float32"][kname])
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f}"
        log(f"6c kernel {kname} float32 at n = {n:,}: max_rel_err "
            f"{rec['err']:.3e} (tol {rec['tol']:.0e}) kernel_ms "
            f"{rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} library_ms "
            f"{lib} bound_ms {rec['bound'][0]:.4f} ({rec['bound'][1]}) "
            f"[{card()}]")
        if not rec["err"] <= rec["tol"]:
            raise SystemExit(f"6c {kname}: error {rec['err']} above "
                             f"{rec['tol']}")
    return out


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 5's right-hand sides (numpy)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch
    from repro_torch.core import matrices
    from repro_torch.kernels import _build, ops, ref

    # -- 1. device and build ------------------------------------------------
    log(card())                     # the card's name and power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path = _build.library_path()
    report = _build.build(path)     # always: phase 1 reads its report
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    spills = check_flash_spills(report)
    hmma = count_hmma(path, _build.nvcc())

    # -- 3a. the main path's matrix (built first: phase 2 uses its shape) --
    stencil, b, _ = matrices.convection_diffusion(NX, peclet=0.5,
                                                  dtype=torch.float64)
    ell = matrices.stencil_to_ell(stencil)
    v = torch.randn(ell.n, dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    want = stencil.matvec(v)
    for label, got in (("plain", ell.matvec(v)),
                       ("kernel", ops.spmv_ell(ell, v))):
        err = float((got - want).abs().max() / want.abs().max())
        log(f"ELL {label} matvec vs stencil: max_rel_err {err:.3e}")
        if err > 1e-14:
            raise SystemExit(f"ELL {label} matvec disagrees with the stencil")

    # -- 2 and 2b. kernels against their plain versions ----------------------
    results, at_m1 = {}, {}
    for dtype in (torch.float64, torch.float32):
        res = check_kernels(torch, ops, ref, ell.values, ell.cols, dtype)
        torch.cuda.empty_cache()
        batched, at_m1[str(dtype).replace("torch.", "")] = \
            check_batched_kernels(torch, ops, ref, ell.values, ell.cols,
                                  dtype)
        res.update(batched)
        torch.cuda.empty_cache()
        for kname, rec in res.items():
            if not rec["err"] <= rec["tol"]:
                raise SystemExit(f"{kname} {dtype}: error {rec['err']} above "
                                 f"{rec['tol']}")
        results[str(dtype).replace("torch.", "")] = res

    # -- 2c. the preconditioner's set-up and kernels --------------------------
    from repro_torch import precond
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc = precond.block_jacobi(ell)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"block_jacobi set-up on the ELL operator: {setup_s:.2f} s, "
        f"inv_blocks {tuple(pc.inv_blocks.shape)} "
        f"({pc.inv_blocks.numel() * 8 / 1e6:.0f} MB fp64)")
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        res = check_precond_kernels(torch, ops, ref, pc.inv_blocks, dtype)
        torch.cuda.empty_cache()
        for kname, rec in res.items():
            if not rec["err"] <= rec["tol"]:
                raise SystemExit(f"{kname} {dtype}: error {rec['err']} above "
                                 f"{rec['tol']}")
        results[name].update(res)

    # -- 2d. the flash-attention kernel --------------------------------------
    flash = check_flash_kernel(torch, ops, ref)

    # -- 3b. the main path ----------------------------------------------------
    runs = [run_main_path(torch, repro_torch, ops, method, ell, stencil, b,
                          eager=method == "p-bicgsafe")
            for method in ("p-bicgsafe", "p-bicgsafe-rr")]
    main, rr = runs
    log(f"main p-bicgsafe against PERF.md: graph "
        f"{main['ms_per_iteration']:.4f} ms per iteration (PERF.md "
        f"{PERF_3B_MS['graph']:.4f}), eager chunk "
        f"{main['eager_ms_per_iteration']:.4f} (PERF.md "
        f"{PERF_3B_MS['eager']:.4f}), the kernels now torch.library ops "
        f"[{card()}]")
    share = sum(results["float64"][k]["ms"] * main["launches"][k]
                for k in SINGLE) / (main["wall_s"] * 1e3)
    log(f"main p-bicgsafe: the three kernels' device time is {share:.3f} "
        "of the wall time")
    torch.cuda.empty_cache()
    log_memory(torch, "3b")

    # -- 3c. the batched path ------------------------------------------------
    many = run_batched_path(torch, repro_torch, ops, ell, stencil, b,
                            main["iterations"])
    kernel_ms = sum(results["float64"][k]["ms"] * many["launches"][k]
                    for k in BATCHED)
    log(f"batched solve_many: {many['ms_per_step']:.3f} ms per step, "
        f"{many['ms_per_iteration']:.3f} ms per iteration (of the slowest "
        f"column); the three batched kernels' device time is "
        f"{kernel_ms / (many['wall_s'] * 1e3):.3f} of the wall time "
        f"({kernel_ms / many['steps']:.3f} ms per step)")
    torch.cuda.empty_cache()
    log_memory(torch, "3c")

    # -- 3d. the guarded path -----------------------------------------------
    guarded = run_guarded_path(torch, repro_torch, ops, ell, stencil, b, many,
                               main)
    path_launches = dict(main["launches"])
    path_launches.update({k: many["launches"][k] for k in BATCHED})
    path_launches.update(
        fused_dots_health=guarded["single"]["launches"]["fused_dots_health"],
        fused_dots_health_batched=guarded["clean"]["launches"][
            "fused_dots_health_batched"])

    torch.cuda.empty_cache()
    log_memory(torch, "3d")

    # -- 3e. the preconditioned path ------------------------------------------
    pre = run_precond_path(torch, repro_torch, ops, ell, stencil, b, pc, main,
                           many)
    pre["setup_s"] = setup_s
    path_launches.update(
        block_jacobi_apply=pre["p-bicgsafe"]["launches"]["block_jacobi_apply"],
        block_jacobi_apply_batched=pre["solve_many"]["launches"][
            "block_jacobi_apply_batched"])
    log_memory(torch, "3e")

    # -- 3f. the paper's comparison methods ----------------------------------
    comparison = run_comparison_path(torch, repro_torch, ops, ell, stencil,
                                     b, pc)
    comparison_launches = {
        kname: {key: rec["launches"][kname] for key, rec in comparison.items()
                if rec["launches"][kname]}
        for kname in ("fused_dots", "spmv_ell", "block_jacobi_apply")}

    step_kernels = count_step_kernels(torch, repro_torch, ell, b, pc)
    count_method_kernels(torch, repro_torch, ell, b, pc, comparison)
    many["kernels_per_step"] = step_kernels["batched"]
    guarded["clean"]["kernels_per_step"] = step_kernels["guarded"]
    pre["solve_many"]["kernels_per_step"] = step_kernels["preconditioned"]
    log_memory(torch, "3f")

    # -- 3g. the distributed driver at world 1 -------------------------------
    mesh = run_mesh_path(torch, repro_torch, ops, stencil, b)
    mesh_launches = dict(
        fused_dots=mesh["p-bicgsafe"]["launches"]["fused_dots"],
        fused_axpy=mesh["p-bicgsafe"]["launches"]["fused_axpy"],
        fused_dots_batched=mesh["solve_many"]["launches"][
            "fused_dots_batched"],
        fused_axpy_batched=mesh["solve_many"]["launches"][
            "fused_axpy_batched"],
        fused_dots_health_batched=mesh["guarded solve_many"]["launches"][
            "fused_dots_health_batched"])
    log_memory(torch, "3g")

    # -- 5. the solve service -------------------------------------------------
    service = run_service_path(torch, repro_torch, ops, ell, stencil, pc,
                               args.seed)
    service_launches = dict(
        fused_dots_batched=service["engine"]["launches"]["fused_dots_batched"],
        fused_axpy_batched=service["engine"]["launches"]["fused_axpy_batched"],
        spmv_ell_batched=service["engine"]["launches"]["spmv_ell_batched"],
        fused_dots_health_batched=service["guarded"]["launches"][
            "fused_dots_health_batched"],
        block_jacobi_apply_batched=service["block_jacobi"]["launches"][
            "block_jacobi_apply_batched"])
    service["c16"] = check_session_budget(torch, repro_torch, ell)

    # -- 3h. traces and profiles (after 5: it serves 5's burst traced) -------
    observe = run_observe_path(torch, repro_torch, ops, ell, stencil, b,
                               main, many, service, args.seed)

    # -- 3i. the contract analyzer -------------------------------------------
    analysis = run_analysis_path(torch, repro_torch, ops, ell)
    log(f"3i: audit {analysis['audit_wall_s']:.2f} s for "
        f"{analysis['n_cells']} cells")

    # -- 3j. the scenario registry -------------------------------------------
    scen = run_scenario_path(torch, repro_torch, ops, main["iterations"],
                             args.seed)

    # -- 4. the serving path --------------------------------------------------
    # the cached sessions hold their programs' buffers and graph pools, the
    # problem memo the scenarios' operators
    from repro_torch.scenarios import registry as scenario_registry
    del pc, ell, stencil, b, v, want
    scenario_registry._PROBLEMS.clear()
    repro_torch.clear_session_cache()
    gc.collect()
    torch.cuda.empty_cache()
    log_memory(torch, "clearing the session cache and the problem memo")
    main_flash = flash[(FLASH_SHAPE, True, "bfloat16")]
    f32 = flash[(FLASH_SHAPE, True, "float32")]
    serving = run_serving_path(torch, ops, main_flash["ms"], f32["ms"])
    path_launches.update(flash_attention=serving["launches"]["flash_attention"])
    gc.collect()
    torch.cuda.empty_cache()
    log_memory(torch, "4")

    # -- 4b. the MoE family: llama4-scout at full width ----------------------
    moe_flash = flash[(FLASH_SHAPE_MOE, True, "bfloat16")]
    moe = run_moe_serving_path(torch, ops, moe_flash["ms"])

    # -- 4c. MLA and the grouped kernel: deepseek-v3 at full width ----------
    mla = run_mla_serving_path(torch, ops)

    # -- 4d. an fp32 sort config (C26) and the f32 / f64 grouped routes -----
    fp32_sort = run_fp32_sort_path(torch, ops)

    # -- 4e. the hybrid family: zamba2-1.2b at full width -------------------
    hybrid = run_hybrid_serving_path(torch, ops)
    log_memory(torch, "4e (the zamba2 model freed)")

    # -- 4f. the SSM family: xlstm-350m at full width and depth --------------
    xlstm = run_xlstm_serving_path(torch, ops)
    log_memory(torch, "4f (the xlstm model freed)")

    # -- 4g. the audio family: whisper-tiny at full width and depth ----------
    audio_flash = flash[(FLASH_SHAPE_AUDIO, True, "bfloat16")]
    whisper = run_whisper_serving_path(torch, ops, audio_flash["ms"])
    log_memory(torch, "4g (the whisper model freed)")

    # -- 4h. the VLM family: qwen2-vl-72b at full width, depth 32 ------------
    vlm_flash = flash[(FLASH_SHAPE_VLM, True, "bfloat16")]
    vlm_f32 = flash[(FLASH_SHAPE_VLM, True, "float32")]
    vlm = run_vlm_serving_path(torch, ops, vlm_flash["ms"])
    log_memory(torch, "4h (the qwen2-vl model freed)")

    # -- 6. training and the Newton-Krylov step -------------------------------
    training = run_training_path(torch, ops, args.seed)
    log_memory(torch, "6a")
    train_mesh = run_train_mesh_path(torch, ops, args.seed, training["train"])
    log_memory(torch, "6d")
    launch = run_launch_path(torch, ops, train_mesh, args.seed)
    log_memory(torch, "6e")
    nk = run_newton_krylov_path(torch, ops, args.seed)
    log_memory(torch, "6b")
    nk_kernels = check_nk_kernels(torch, ops, ref, NK_PARAMS)
    kernel_ms = sum(nk_kernels[k]["ms"] for k in NK_KERNELS)
    log(f"6b: the fused dots and update kernels take {kernel_ms:.3f} ms of "
        f"an inner iteration's {nk['cuda']['ms_per_inner_iteration']:.3f} "
        f"({kernel_ms / nk['cuda']['ms_per_inner_iteration']:.4f}); an "
        f"iteration is two GGN matvecs of {nk['cuda']['matvec_ms']:.3f} ms "
        f"[{card()}]")
    log_memory(torch, "6c")

    # -- 7. the kernel table and the result line ------------------------------
    kernels = []
    for kname in SINGLE + BATCHED + HEALTH + PRECOND:
        r64, r32 = results["float64"][kname], results["float32"][kname]
        if kname in SINGLE:
            extra = dict(launches_rr=rr["launches"][kname])
            if kname in comparison_launches:
                extra["launches_3f"] = comparison_launches[kname]
        elif kname in PRECOND:
            extra = dict(m=M if kname.endswith("batched") else 1,
                         bs=r64["bs"], nb=r64["nb"],
                         repeats_bitwise=r64["repeats_bitwise"],
                         library_call="torch.bmm")
            if kname == "block_jacobi_apply_batched":
                extra.update(route_variant=r64["route"],
                             fp32_route_variant=r32["route"])
            if kname == "block_jacobi_apply":
                extra["launches_rr"] = \
                    pre["p-bicgsafe-rr"]["launches"][kname]
                extra["launches_3f"] = comparison_launches[kname]
        elif kname in HEALTH:
            extra = dict(m=M if kname.endswith("batched") else 1,
                         rows_0_8_bitwise=r64["rows_0_8_bitwise"],
                         library_omits="the probe row (row 10)")
        else:
            extra = dict(m=M)
        extra["launches_ssm"] = xlstm["launches"][kname]
        extra["launches_audio"] = whisper["launches"][kname]
        extra["launches_vlm"] = vlm["launches"][kname]
        extra["launches_train_mesh"] = train_mesh["launches"].get(kname, 0)
        extra["launches_launch"] = launch["launches"].get(kname, 0)
        if kname in service_launches:
            extra["launches_service"] = service_launches[kname]
        if kname in mesh_launches:
            extra["launches_mesh"] = mesh_launches[kname]
        if kname in observe["launches"]:
            extra["launches_observe"] = observe["launches"][kname]
        if kname in SCENARIO_KERNELS:
            extra["launches_scenarios"] = scen["launches"].get(kname, 0)
        if kname in NK_KERNELS:
            rec = nk_kernels[kname]
            extra.update(
                launches_nk=nk["cuda"]["launches"][kname],
                launches_nk_torch=nk["torch"]["launches"].get(kname, 0),
                nk_fp32=dict(n=rec["n"], max_rel_err=rec["err"],
                             max_abs_err=rec["max_abs_err"], tol=rec["tol"],
                             ms=rec["ms"], plain_ms=rec["plain_ms"],
                             library_ms=rec["library_ms"],
                             bound_ms=rec["bound"][0],
                             bound_by=rec["bound"][1]))
        kernels.append(dict(
            name=kname, route="cuda", source=SOURCE[kname],
            replaces=REPLACES[kname],
            launches=path_launches[kname],
            ms_at_m1=at_m1["float64"].get(kname),
            max_abs_err=r64["max_abs_err"], ms=r64["ms"],
            plain_ms=r64["plain_ms"], bound_ms=r64["bound"][0],
            bound_by=r64["bound"][1], library_ms=r64["library_ms"],
            passed=True, dtype="float64", max_rel_err=r64["err"],
            tol=r64["tol"], fp32_max_rel_err=r32["err"], fp32_ms=r32["ms"],
            fp32_plain_ms=r32["plain_ms"],
            fp32_library_ms=r32["library_ms"],
            fp32_bound_ms=r32["bound"][0], **extra))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source=FLASH_SOURCES["bfloat16"], sources=FLASH_SOURCES,
        hmma_in_bf16_kernel=hmma["bfloat16"],
        tf32_hmma_in_fp32_kernel=hmma["float32"],
        fp32_registers=sorted(r["registers"] for r in spills.values()),
        replaces="src/repro/kernels/flash_attention.py:68",
        launches=path_launches["flash_attention"],
        max_abs_err=main_flash["max_abs_err"], ms=main_flash["ms"],
        plain_ms=main_flash["plain_ms"], bound_ms=main_flash["bound"][0],
        bound_by=main_flash["bound"][1], library_ms=main_flash["library_ms"],
        passed=True, dtype="bfloat16", shape_bhksd=list(FLASH_SHAPE),
        causal=True, max_row_rel_err=main_flash["err"],
        tol=main_flash["tol"],
        repeats_bitwise=main_flash["repeats_bitwise"],
        library_call="scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True)",
        fp32_max_row_rel_err=f32["err"], fp32_ms=f32["ms"],
        fp32_plain_ms=f32["plain_ms"], fp32_library_ms=f32["library_ms"],
        fp32_bound_ms=f32["bound"][0], fp32_bound_by=f32["bound"][1],
        fp32_bound="three TF32 products at 495 TFLOP/s",
        fp32_cuda_core_bound_ms=f32["cuda_core_bound"][0],
        fp32_launches=serving["fp32_launches"]["flash_attention"],
        launches_moe=moe["launches"]["flash_attention"],
        launches_hybrid=hybrid["launches"]["flash_attention"],
        launches_ssm=xlstm["launches"]["flash_attention"],
        launches_audio=whisper["launches"]["flash_attention"],
        launches_vlm=vlm["launches"]["flash_attention"],
        launches_train_mesh=train_mesh["launches"].get("flash_attention", 0),
        launches_launch=launch["launches"].get("flash_attention", 0),
        vlm_shape=dict(shape_bhksd=list(FLASH_SHAPE_VLM), causal=True,
                       dtype="bfloat16", ms=vlm_flash["ms"],
                       plain_ms=vlm_flash["plain_ms"],
                       library_ms=vlm_flash["library_ms"],
                       bound_ms=vlm_flash["bound"][0],
                       bound_by=vlm_flash["bound"][1],
                       max_row_rel_err=vlm_flash["err"],
                       max_abs_err=vlm_flash["max_abs_err"],
                       repeats_bitwise=vlm_flash["repeats_bitwise"],
                       fp32=dict(ms=vlm_f32["ms"],
                                 plain_ms=vlm_f32["plain_ms"],
                                 library_ms=vlm_f32["library_ms"],
                                 bound_ms=vlm_f32["bound"][0],
                                 bound_by=vlm_f32["bound"][1],
                                 cuda_core_bound_ms=vlm_f32[
                                     "cuda_core_bound"][0],
                                 max_row_rel_err=vlm_f32["err"],
                                 max_abs_err=vlm_f32["max_abs_err"])),
        audio_shape=dict(shape_bhksd=list(FLASH_SHAPE_AUDIO), causal=True,
                         dtype="bfloat16", ms=audio_flash["ms"],
                         plain_ms=audio_flash["plain_ms"],
                         library_ms=audio_flash["library_ms"],
                         bound_ms=audio_flash["bound"][0],
                         bound_by=audio_flash["bound"][1],
                         max_row_rel_err=audio_flash["err"],
                         max_abs_err=audio_flash["max_abs_err"],
                         repeats_bitwise=audio_flash["repeats_bitwise"]),
        moe_shape=dict(shape_bhksd=list(FLASH_SHAPE_MOE), causal=True,
                       dtype="bfloat16", ms=moe_flash["ms"],
                       plain_ms=moe_flash["plain_ms"],
                       library_ms=moe_flash["library_ms"],
                       bound_ms=moe_flash["bound"][0],
                       bound_by=moe_flash["bound"][1],
                       max_row_rel_err=moe_flash["err"],
                       max_abs_err=moe_flash["max_abs_err"],
                       repeats_bitwise=moe_flash["repeats_bitwise"]),
        fp32_max_abs_err=f32["max_abs_err"],
        fp32_repeats_bitwise=f32["repeats_bitwise"],
        other_cases=[dict(shape=r["shape"], causal=r["causal"],
                          dtype=r["dtype"], max_row_rel_err=r["err"],
                          ms=r.get("ms"), library_ms=r.get("library_ms"),
                          bound_ms=r["bound"][0] if "bound" in r else None)
                     for key, r in flash.items()
                     if r is not main_flash and r is not f32
                     and r is not moe_flash and r is not audio_flash
                     and r is not vlm_flash and r is not vlm_f32]))
    gdec, gpre = mla["grouped"]["decode_wi"], mla["grouped"]["prefill_wi"]

    def tile_ms(r):
        return {k: v["ms"] for k, v in r["tiles"].items()}

    kernels.append(dict(
        name="grouped_mm", route="cuda", source=GROUPED_SOURCE,
        sources=GROUPED_SOURCES, replaces=GROUPED_STANDS_IN,
        launches=mla["launches"]["grouped_mm"],
        launches_eager=mla["eager_launches"]["grouped_mm"],
        launches_fp32_sort=fp32_sort["launches"]["grouped_mm"],
        launches_ssm=xlstm["launches"]["grouped_mm"],
        launches_audio=whisper["launches"]["grouped_mm"],
        launches_vlm=vlm["launches"]["grouped_mm"],
        launches_train_mesh=train_mesh["launches"].get("grouped_mm", 0),
        launches_launch=launch["launches"].get("grouped_mm", 0),
        max_abs_err=gdec["max_abs_err"], ms=gdec["ms"],
        plain_ms=gdec["plain_ms"], bound_ms=gdec["bound_ms"],
        bound_by=gdec["bound_by"], library_ms=gdec["library_ms"],
        passed=True, dtype="bfloat16", shape=gdec["shape"],
        kernel_route=gdec["route"], tile=gdec["tile"], tile_ms=tile_ms(gdec),
        max_rel_err=gdec["err"], tol=gdec["tol"],
        repeats_bitwise=gdec["repeats_bitwise"],
        library_call="torch._grouped_mm(x, w, offs=offsets[1:])",
        library_note=gdec["library_note"],
        prefill=dict(shape=gpre["shape"], kernel_route=gpre["route"],
                     ms=gpre["ms"], tile=gpre["tile"], tile_ms=tile_ms(gpre),
                     plain_ms=gpre["plain_ms"], bound_ms=gpre["bound_ms"],
                     bound_by=gpre["bound_by"],
                     library_ms=gpre["library_ms"],
                     max_abs_err=gpre["max_abs_err"],
                     max_rel_err=gpre["err"]),
        other_cases=[dict(case=k, shape=r["shape"], kernel_route=r["route"],
                          ms=r["ms"], tile=r["tile"], tile_ms=tile_ms(r),
                          bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                          max_rel_err=r["err"])
                     for k, r in mla["grouped"].items()
                     if r is not gdec and r is not gpre],
        fp32_fp64=[dict(case=k, dtype=r["dtype"], shape=r["shape"],
                        kernel_route=r["route"], ms=r["ms"], tile=r["tile"],
                        tile_ms=tile_ms(r),
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"],
                        cuda_core_bound_ms=r.get("cuda_core_bound_ms"),
                        library_ms=r["library_ms"],
                        library_note=r["library_note"],
                        max_abs_err=r["max_abs_err"], max_rel_err=r["err"],
                        tol=r["tol"])
                   for k, r in fp32_sort["kernels"].items()]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
