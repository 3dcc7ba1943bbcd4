#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]
    python3 chip_smoke.py --decode-ab OTHER_TREE/src [--out FILE.json]
    python3 chip_smoke.py --ab OTHER_TREE [--out FILE.json]

Run from the repository root on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA. Phases, in order; any failure raises
and the script exits non-zero without printing a result:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of pdADMM-G / pdADMM-G-Q on cora with the paper's 10×1000
   GA-MLP, and time the kernel, the plain version and, where one PyTorch
   call computes the same function, that call (``library_ms``; the port
   never calls it), each by CUDA events over back-to-back calls; the
   kernel also by the device time its launches take (``device_ms``,
   torch.profiler), which leaves out the host's gaps that set the event
   time of the smallest kernels.
   ``fista_zlast`` also runs at coauthor_cs's and ogbn_arxiv's last
   layers ([18333, 15], [169343, 40]) and ogbn_arxiv's ring last layer
   ([169343, 1000], 40 classes), from ``graph.datasets.TABLE_II``, and
   past the lane-group route's 64 classes (the kernels line's
   ``fista_zlast_wide``): cora's [2485, 1000] rows with 1000 and 65
   classes and head-folded with 100, [2485, 4096] with 4096 (the
   shared-memory route), cora's [2485, 7] and [2485, 100] at 300
   iterations, and 2048 token rows over tinyllama's 32000-entry
   vocabulary ([2048, 32000], the streaming route); every case must
   give the same bits on a second call, and the [V, C] cases print the
   launch floor (the device time of a one-element ``torch.zeros`` fill)
   beside the bound. The row-predicated forms of ``grid_encode``,
   ``grid_decode``, ``pack_codes`` and ``unpack_codes`` (the mixed-width
   ring's padded wire: one launch a width, each row a stage's slab of
   2,485,000 codes, run where the stage's entry of a device table is that
   width) run on a 4/8/16 mix over 10 stages, with all 10 rows at 4 bits
   and 8 rows at 16 (the unpredicated rows' shapes), and as launches that
   match no row (a table without 8-bit stages; an all-8-bit one), each
   bitwise against its plain version and beside the launch floor.
3. Train pdADMM-G on cora at 10×1000 for a few iterations through
   ``repro_torch.core.pdadmm.train`` with every launch counter set to 0
   just before; its four kernels must have launched, the objective must be
   finite and must track the same run with ``use_kernels=False`` on the
   card at rtol 1e-3. Then time 5 steady-state iterations of each path,
   three times each in turns (kernels, plain, plain, kernels, kernels,
   plain; the medians are kept), and trace one kernel-path iteration with
   torch.profiler (device time by kernel, the device's idle share).
4. The same for pdADMM-G-Q (p and q on ``uniform_grid(8, -2, 6)``, the
   quickstart's grid): the four, ``backtrack_resnorm`` and
   ``grid_project`` must launch. Both paths' τ per layer and iteration are
   printed with the trials per p-update that were active, and the layers
   where the two paths' τ differ. Where rtol 1e-3 fails and a τ differs,
   the two paths are held from one shared state one iteration at a time
   instead, and each flip is printed with its accept-test margin.
5. Two G-Q iterations with 8-bit grid codecs on the dual's wire
   (``u_codecs``): ``grid_encode`` and ``grid_decode`` must launch.
6. The stage-parallel runtime (``repro_torch.parallel.stage_parallel``)
   on a ``LocalRing`` of mesh (1, 10): the same 10×1000 GA-MLP as a ring
   of 10 layer-stages on ``Xp = relu(X @ P0)`` (P0 a seeded [5732, 1000]
   projection), 5 iterations of G and of G-Q through
   ``distributed_train``: its kernels must launch, the objectives track
   ``use_kernels=False`` at rtol 1e-3, ``overlap=True`` gives the same
   bits as ``overlap=False``, the ledger's bytes per iteration equal
   ``wire_bytes_per_iteration`` and the bytes the ring's shifts moved
   (counted from the payload tensors); ms per iteration of the step, and
   the memory one step allocates without and with ``donate=True`` (the
   donated peak lower). Then 5
   iterations of the mixed-width padded wire (a ``BitWidthController`` over
   ``stage_ring_edges``, widths {4, 8, 16}): one step built, the schedules
   printed, ``pack_codes`` and ``unpack_codes`` launched, the launches those
   of ``step_program_plan`` each iteration (a predicated launch a width of
   the wire, whatever the schedule), the shifts' bytes
   equal to the ledger's physical bytes, the objectives tracking the same
   run with ``use_kernels=False`` at rtol 1e-3; the same iterations again
   under torch.profiler give each pack and unpack kernel's device ms a
   launch inside the ring's iterations (its inputs where the step leaves
   them, not re-read back to back from L2). Last,
   ``quantized_psum`` on a ``LocalRing`` of data 4 over [2485, 1000]
   shards: gather and code_psum give the same bits (4-bit affine and grid).
6b. ``replay_phase``, the replay cost model (``repro_torch.analysis``) on
   the same ring: ``calibrate`` a cost table from micro-runs on a
   ``LocalRing`` of mesh (1, 10) (its solver probe runs ``fused_linear``,
   ``admm_pgrad``, ``relu_zupdate``, ``fista_zlast``, ``backtrack_resnorm``
   and ``grid_project``) and print it; record one step of the G ring with
   overlap off and on, the G-Q ring and the mixed-width ring (widths 4, 8
   and 16 all in use) on the CPU with shape-only tensors
   (``trace_step_program``), replay each DAG twice (the same bits,
   finite and positive), and print its predicted ms beside the measured
   ms per iteration (the four timed in turns, medians of three) and their
   ratio; whether the predicted overlap ordering matches the measured one
   (readings, not gates). Gates: each DAG's shift bytes × links equal the
   ledger's physical bytes of one iteration of the same run; the
   recorder's launches of one step equal ``ops.launch_counts()`` over one
   real step on the card and ``step_program_plan(...).pallas_calls``;
   ``distributed_train(overlap="replay", cost_table=...)`` runs what
   ``choose_overlap_for`` says and tracks ``use_kernels=False`` at rtol
   1e-3; the mixed-width ring under ``BitWidthController(objective=
   "walltime", cost_model=step_cost_model(...))`` runs every boundary at
   16 bits (the container's capacity is fixed, so the predicted time is
   flat) and tracks ``use_kernels=False`` at rtol 1e-3, its logical bytes
   per iteration printed beside the bytes objective's; the uniform-codec
   walltime run prints the widths it chose and each candidate's predicted
   ms.
6c. ``contract_phase``, the program-contract linter
   (``repro_torch.analysis.contracts``) on the same ring: each of the 11
   registered step specs widened to mesh (1, 10), V 2485, h 1000, L 10, 7
   classes, recorded on the card on the ring's data
   (``check_contracts(..., device="cuda", inputs=...)``) with zero error
   findings (the table and each spec's seconds printed); the kernel
   wrappers' counters over one real step equal the recorded launches and
   ``step_program_plan(...).pallas_calls`` on every spec, and on the
   ragged V of the ``check_ragged`` specs; the peak memory of one step
   with ``donate=True`` below the one without (``max_memory_allocated``,
   reset before each); at full width overlap off on the ``overlap`` spec
   fires exactly ``schedule.carried`` and ``schedule.work_to_consumer``,
   and ``use_kernels=False`` on ``baseline`` exactly the dispatch keys;
   the four psum specs clean on the card; and ``python -m
   repro_torch.analysis.lint --all --format json`` (the specs' sizes, on
   the card) exits 0 with no error.
7. ``ft_phase``, fault tolerance on the same ring (mesh (1, 10)), with
   checkpoints in a ``tempfile.mkdtemp()`` directory deleted at the end:
   (a) ``distributed_train(health=True)`` and a zero-rate ``FaultPlan``
   give the plain ring's objectives and state bit for bit over 5
   iterations; the sentinel step's ms per iteration beside the plain
   step's, through ``distributed_train`` too, the device ms of an
   iteration's six checksums, and a profile of the health step;
   (b) the G-Q ring under ``FT_CHAOS`` (link flips and drops) for 10 ticks,
   overlap off and on: per edge injected == detected == recovered == the
   ledger's counts, the header bytes == ``_record_sentinel_headers``'s, and
   a second run gives the same bits; (c) the G ring under ``FT_SNEAKY``
   with a checkpoint every 2 iterations rolls back at least once and ends
   finite; (d) 4 iterations, a save and a fresh ``resume=True`` run to 8
   equal 8 uninterrupted iterations bit for bit, and the checkpoint
   restores onto mesh (1, 5) and trains on; (e) the paper's G-Q setting
   (Δ = {-1..20}, p on it and q not, ν 1e-2, 15 FISTA steps) through
   ``pdadmm.train`` as phase 4 runs it, then ``train_adaptive`` with the
   controller over the p/q ``admm_edges`` and the grid Δ as its one 8-bit
   entry (so q lies on Δ too) against ``use_kernels=False`` at rtol 1e-3
   (stepwise where a τ flips), and again with a ``fault_hook`` that puts a
   NaN into iteration 3: one rollback, objectives equal to the clean run's.
   Test accuracies of G, G-Q on the uniform grid and the paper's setting
   are printed side by side, and those of the two G-Q settings after the
   paper's 100 iterations.
7b. ``graph_phase``, the compiled driver (``core.graphs``: one iteration
   captured as a CUDA graph and replayed by ``pdadmm.run_chunked(...,
   jit=True)``) against the eager loop (``jit=False``) on every path that
   rides it: G, G-Q, G-Q with 8-bit u codecs, the G and G-Q rings of mesh
   (1, 10) with overlap off and on and the G ring with ``donate=True``
   (``run_chunked`` on the step), one ``train_adaptive`` control step,
   ``train_adaptive`` with a control step every iteration over 4/8/16-bit
   grids (a graph per schedule, all over one state's buffers) and
   ``greedy_train`` over the schedule (2, 5) (their entry points), and
   ``distributed_train``'s per-iteration loops on the G ring
   (``graph_loops``, each of its calls capturing inside): the mixed-width
   ring over its device widths table with 10 and with 20 managed edges,
   overlap off and on; the per-epoch controller ring at 4/8/16 bits with
   overlap on (its schedules must switch); and the sentinel loop with
   ``health=True`` (overlap on), under ``FT_SNEAKY`` for ``FT_TICKS``
   iterations (a rollback at least, every tick one replay) and with a
   checkpoint every 2 of 3 iterations and a resume to 5 (``hist``, the
   ledger's bytes and the ring's shifted bytes held too). Each
   runs GRAPH_ITERS (5) iterations a stage from one state in both forms:
   states and metrics bitwise equal, the launch counters (and a ring's
   shifted bytes) equal, one replay per iteration, the peak MiB of each
   form (the graph's first call captures); then ms per iteration in turns
   (graph, eager, eager, graph, graph, eager; medians), and a profile of
   each form: device busy ms, idle share and host CUDA API calls per
   iteration. The graph's launches are read from the CUDA driver: each
   kernel wrapper's head kernel among each graph's nodes, times its
   replays, with the launches outside the graphs, held against the eager
   wrappers' counts (what each form's device trace lacks of them is kept). ``train_adaptive``'s and ``greedy_train``'s graph form
   captures inside every call, so its ms include the capture. Every
   earlier phase runs the eager loop (``jit=False``), so its numbers and
   the ``kernels`` line's launches are the wrappers' own counts.
8. ``baseline_phase``, the paper's comparison methods at cora 10×1000:
   the kernels held against their plain versions at the shapes greedy
   growth adds (the 5-layer stage's ×3 stack, its [4, V, h] and the
   2-layer stage's [V, h] z-updates); ``core.greedy.greedy_train`` with
   ``GAMLP.greedy_schedule`` (2, 5, 10) and ``GAMLP.epochs // 3`` iterations
   a stage for pdADMM-G, and for pdADMM-G-Q with p (not q) on the paper's
   Δ = {-1..20} and on ``calibrate_grid``'s 8-bit grid, each with every
   launch count set to 0 just before (its kernels must launch; per stage
   ms per iteration, test accuracy and launches) and against
   ``use_kernels=False`` at rtol 1e-3 (stepwise from shared states where a
   τ flips); ``core.gd_baseline.train_gd`` with GD, Adadelta, Adagrad and
   Adam for 2 × ``GAMLP.epochs`` epochs at ``benchmarks/bench_accuracy.py``'s
   learning rates (finite losses, ms per epoch, no port kernel launched);
   block-pdADMM (``core.block_admm``) on 9 stacked relu(p @ W_l) blocks
   [1, 2485, 1000] behind a seeded relu(X @ W_in), 5 iterations by the CE
   route (one ``fista_zlast`` launch an iteration) against the generic
   route (objectives at rtol 1e-4, z_last within 1e-4 × its max), each
   route's ms per iteration, once at cora's 7 classes and once at
   ``n_classes=None``, the CE over all 1000 columns (the kernel's register
   route, whose launches the kernels line reports); and the test
   accuracies side by side.
9. ``lm_phase``: the dense LM served at tinyllama-1.1b's full width (22
   layers, d 2048, 32 query / 4 KV heads, bf16, seeded random weights):
   ``ModelBundle.prefill`` of 4 prompts of 2048 tokens with every launch
   count set to 0 just before (``flash_attention`` must launch exactly 22
   times, once per layer), ms per prefill and tokens/s; the same prefill
   with the plain attention on the card (``use_kernels=False``): max
   |Δlogit| and the relative L2 error of the last-position logits, at most
   2e-2; each bf16 path's relative L2 to the same prefill in f32 through
   the plain attention, of the logits and of the last layer's K/V at every
   position, the kernel path's at most 1.05 times the plain path's on
   both, and two controls (the kernel without its causal mask; without the
   last 64-key tile) that must break that limit. Then 32 greedy tokens with
   ``serve_step`` from that cache (ms per token at B 4; the tokens the two
   paths agree on are counted, not asserted: bf16 logits tie often under
   the 0.02 init), a profile of one prefill and one decode step, and
   ``ServingEngine`` answering 7 requests on 4 slots
   (``examples/serve_lm.py``'s), each with 12 tokens in the vocab.
9b. ``lm_family_phase``: the MoE and VLM families at their published
   widths (bf16, seeded random weights), one config at a time with the
   card's caches freed between them: granite-moe-3b-a800m (32 layers, d
   1536, 40 experts top-8), qwen3-moe-235b-a22b cut from 94 to 8 layers
   (d 4096, 128 experts top-8; 94 layers are 470 GB) and qwen2-vl-7b (28
   layers; 3-D positions: 512 text tokens at t = h = w = index, one image
   block of 32 × 32 patches at t = 512 with h, w from 512, then 512 text
   tokens from 544). Each: ``ModelBundle.prefill`` of 4 prompts of 2048
   tokens with every launch count set to 0 just before
   (``flash_attention`` exactly once per layer, no other port kernel),
   finite logits, peak allocated MiB; the plain-attention prefill on the
   card: max |Δlogit| and relative L2 (reported, not held: a bf16 path's
   noise flips near-tied routes and grows through the layers), for the
   MoE per layer the share of (token, k) picks the two paths make (as
   sets) and the picks dropped at capacity (and those of the last
   expert); ``lm_vs_f32``'s rule (the kernel path's relative L2 to the
   f32 plain prefill at most LM_VS_F32 times the plain path's, logits and
   last layer's K/V, the mask-off and tile-dropped controls breaking it),
   for the MoE with every bf16 prefill routed to the f32 prefill's
   experts (``route_log``), and for qwen3-moe at FAMILY_F32_LAYERS (2)
   layers, since its f32 copy would not fit beside the bf16 weights; ms
   per prefill (kernels, plain), tokens/s and a profile; 32 greedy
   tokens at B 4 (ms per token beside two floors: the einsum dispatch's,
   every weight read once, and the function's own, the experts the steps
   pick with the other weights; peak MiB, no port kernel launched, agreement with the plain path
   counted) and a profile of one step. granite-moe also: the prefill at
   ``moe_impl="gather"``, finite in bf16 with picks dropped (at least one,
   else the check fails), and in f32 at the f32 einsum prefill's picks
   within a relative L2 of FAMILY_GATHER_F32_REL (1e-4) of it on the
   logits and the last layer's K/V; ``ServingEngine`` on 7 requests / 4
   slots as in phase 9; and three ``Trainer.run`` steps on 4 × 4096
   tokens in 4 microbatches (adamw 3e-4, remat) at FAMILY_TRAIN_LAYERS
   (16) of its layers (at 32 its weights, f32 gradient sum and copy and
   old and new adamw moments need ~95 GB): losses finite, step 0's within
   [ln V − 0.5, ln V + 1.5], no port kernel, the router kept f32, the aux
   term, ms per step, tokens/s, peak MiB. qwen2-vl also: t = h = w = index
   against the same weights with ``mrope_sections=None`` (plain RoPE):
   the logits within a relative L2 of FAMILY_MROPE_REL (1e-5).
9c. ``lm_seq_phase``: the SSM, hybrid and audio families at their
   published widths (bf16, seeded random weights), one config at a time:
   mamba2-130m (24 layers, d 768, state 128, tied embeddings),
   jamba-v0.1-52b at 2 of its 4 periods (16 of 32 layers, d 4096, 16
   experts top-2 on odd layers, NoPE attention at index 4 of 8; one period
   is ~25.5 GB in bf16) and whisper-tiny in full (4 + 4 layers, d 384, 6
   heads, 1500 frames, 448 text tokens). Each: ``ModelBundle.prefill``
   (these families' prefill is the forward pass and the last position's
   logits, with no state, as the reference's) of 4 × 2048 tokens (whisper:
   4 × 1500 frames and 4 × 448 tokens) with every launch count set to 0
   just before (``flash_attention`` 0 times for mamba2, once per period
   for jamba, 12 times for whisper: 4 encoder, 4 decoder self, 4 cross; no
   other port kernel), finite logits, peak MiB; the plain-attention prefill
   beside it (and jamba's picks shared by the two paths); ms per prefill of
   both, tokens/s, a profile. whisper's encoder alone, timed. jamba's
   gather dispatch: finite under capacity drops, its picks and ms beside
   the einsum's, and 8 greedy decode tokens (the reference's gather cannot
   decode). 32 greedy tokens at B 4 from the state these families decode
   from (mamba2's and jamba's zero state; whisper's ``precompute_cross``
   K/V) with no port kernel launched: ms per token beside the floor of
   reading every weight and touching the state once (jamba also: the
   experts its tokens pick), peak MiB, a profile of one step. mamba2 and
   whisper: decode over 64 tokens against the forward pass's logits, in
   bf16 within the reference test's rtol 5e-2, atol 5e-1 (its argmax
   agreement reported: at mamba2's full width bf16 near-ties flip), and in
   f32 (the weights cast) relative L2 1e-4 and agreement 0.99. The engine on
   7 requests / 4 slots (whisper against zero cross K/V, as the
   reference's engine serves it). jamba (at one period, new seeded weights:
   2 periods in f32 would not fit beside bf16) and whisper:
   ``lm_vs_f32``'s rule on the forward pass (``seq_vs_f32``: the hidden
   states, every attention's output and its last 64 query rows; every run
   routed to the kernel path's picks), the mask-off and tile-dropped
   controls breaking it, and jamba's gather in f32 within 1e-4 of the
   einsum at the same picks. mamba2 trains 3 steps of ``Trainer.run`` on 4
   × 4096 tokens, whisper 3 of ``launch.steps.make_train_step`` on
   ``make_inputs`` batches (frames, tokens, targets) at 4 × 448: losses
   finite, step 0's within [ln V − 0.5, ln V + 1.5], no port kernel, ms per
   step, tokens/s, peak MiB.
9d. ``decode_graph``, the compiled decode (``serve.engine.decode_program``:
   one decode step captured as a CUDA graph, the reference's ``jax.jit``
   of ``serve_step`` over a traced ``length``), inside phases 9–9c for
   each of their seven bundles (tinyllama-1.1b, granite-moe-3b-a800m,
   qwen3-moe at 8 layers, qwen2-vl-7b, mamba2-130m, jamba at 2 periods,
   whisper-tiny) from the prefill's cache or the zero state they decode
   from, and in ``phi3_phase`` for phi3-mini-3.8b at its published widths
   and PHI3_LAYERS (8) of its 32 layers, from a 4 × 2048 prefill's K/V
   quantized into its int8 ``KVCacheQ``. Each: DECODE_GRAPH_TOKENS (16)
   greedy tokens at B 4 by ``greedy`` with ``jit=False`` (the eager step,
   tokens kept on the card) and with ``jit=True`` (the engine's program:
   one replay a token, each step's tokens read on the host in one copy),
   from two copies of one state. Held: tokens, every step's logits and the
   final state bit for bit; one replay a token; the capture's warm-up
   under sync-debug "error" (a host sync raises); the graph's kernel
   nodes (read from the CUDA driver, demangled) equal by name to the
   kernels the program's body launches when run eagerly (the second of
   two eager runs in a profiler trace, between marker kernels; taken
   again up to PROFILE_TRIES times), so nodes × replays are the eager
   launches. Recorded: the capture's ms and MiB, ms per token in
   turns (graph, eager, eager, graph; medians), peak MiB of each form,
   and a profile of each (device busy ms, idle share, host CUDA API calls
   a token). Every ``engine_run`` (7 requests on 4 slots) runs the
   ``ServingEngine`` in both forms, ``jit=False`` and the default (one
   capture when the engine is made, its ms apart; one replay a step),
   with the same tokens. Every other decode in the script pins
   ``jit=False``.
10. ``lm_train_phase``: the same LM trained, through the port's
   training path (``Trainer``, ``make_accum_train_step``,
   ``ModelBundle.loss``: the plain attention, no port kernel). (a) At full
   width, bf16 weights with f32 adamw(3e-4) moments and remat, six steps
   of ``Trainer.run`` on ``TokenPipeline``'s 4 × 4096 tokens (one card's
   share of the reference's ``TRAIN_4K``) with every launch count set to 0
   just before, checkpointing once at the end into a temporary directory:
   the losses finite, step 0's within [ln 32000 − 0.5, ln 32000 + 1.5]
   (beside ln V + σ²/2 for the measured std σ of its logits), the smaller
   of the last two below step 0's, no port kernel launched; ms per step
   (host clock, median of steps 1-5), tokens/s, peak allocated memory,
   the save's seconds and bytes, a profile of one step with device time by
   kernel group, and one layer's plain attention (forward, recompute and
   backward) by events. (b) ``ops.flash_attention`` on inputs that require
   grad raises under grad mode; under no_grad it matches its plain version
   by the flash check. At full width with the depth cut to 2 layers: (c)
   ``ModelBundle.loss`` and every leaf's gradient in bf16 against the same
   weights in f32, and a control with q, k, v detached before attention
   that must break the limit; (d) one step with two microbatches (f32,
   then bf16 accumulator) against one; (e) a crash at step 2 with a
   checkpoint every 2 steps, then a resume: the restored leaves equal the
   saved ones bit for bit, the resumed losses within rtol 1e-2 of an
   uninterrupted run.
10b. ``mesh_phase``, the mesh tools (``launch.mesh``, ``parallel.sharding``,
   ``launch.dryrun``) in three subprocesses of this script at once (one
   process holds one default process group): (a) the port's dry run on
   this host in two of them: tinyllama-1.1b's ``train_4k``,
   ``prefill_32k`` and ``decode_32k`` on the (16, 16) production mesh (a
   fake world of 256 ranks), the stage-parallel ``stage_v1m_b32`` and
   ``stage_v1m_b8`` cells and granite-moe-3b-a800m's ``train_4k`` (its 40
   experts do not divide 16: the experts' f is split; one microbatch of
   its 8):
   per-device flops, peak live bytes and moved bytes, each finite and
   above 0, and the trace seconds; beside it, on the card, through
   ``build(cfg, mesh=make_host_mesh(), shape)``, a 1×1 mesh over an NCCL
   world of one: (b) tinyllama-1.1b at its published width, a prefill of
   4 × 2048 (``flash_attention`` 22 times, through ``local_map``) and 32
   greedy tokens at batch 4, logits, K/V and tokens bitwise equal to the
   plain bundle's (else within an f32 relative L2 of 1e-6), ms per
   prefill and per token beside the plain path's in turns, and one adamw
   step at 2 layers against the plain step; (c) granite-moe-3b-a800m
   (einsum and gather dispatch) and qwen2-vl-7b (text, a 32 × 32 image
   block at 3-D positions, text) at their published widths, a prefill of
   4 × 2048 (``flash_attention`` 32 and 28 times) and 8 greedy tokens,
   held as (b), the router's picks equal call by call, ms in turns. The
   ms of (b) and (c) are taken once (a)'s processes have exited. The
   phase must take at most 90 s. (a) also traces mamba2-130m's
   ``decode_32k`` on (16, 16) (24 heads do not divide 16: its d_inner
   layout is ``ssm_inner``, each rank 1.5 heads).
10c. ``mesh_seq_phase``, alone after it, in a subprocess of its own: the
   SSM, hybrid and audio families on the 1×1 mesh against the plain
   bundle: mamba2-130m and whisper-tiny at their published configs,
   jamba-v0.1-52b at its published width and one period (8 of 32
   layers). Each: a prefill of 4 × 2048 tokens (whisper: 4 × 1500 frames
   and 4 × 448 tokens), its logits bitwise equal to the plain bundle's,
   ``flash_attention`` 0 (mamba2), 1 (jamba) and 12 (whisper) times; 8
   greedy tokens from the zero state (whisper's cross K/V from
   ``precompute_cross``): tokens, the last logits and every leaf of the
   decode state bitwise equal; jamba's router picks equal call by call
   (einsum dispatch); ms per prefill and per token in turns with the
   plain bundle. The phase must take at most MESH_SEQ_PHASE_S (90 s).
11. Print the wire bytes per iteration from the port's ledger (G, G-Q,
   G-Q with the u wire), the script's wall time, the card (``nvidia-smi``),
   one JSON line with every kernel's numbers, and last the device line.

With ``--ab`` the script builds another tree's ``fista_zlast.cu``,
``admm_pgrad.cu`` and ``pack_codes.cu`` (e.g. a ``git archive`` of the
parent commit), each alone, and times them against this tree's kernels in
turns (parent, this, this, parent) by device time per launch and by
events, at phase 2's six ``fista_zlast`` shapes, its ``admm_pgrad`` shapes
and every ``unpack_codes`` and ``pack_codes`` case, after checking the two
versions' outputs against each other (unpack and pack bit for bit, pack
also against its plain version); then G's and G-Q's ms per
iteration (as phases 3 and 4 time them, and through each tree's default
``run_chunked`` driver: the parent's eager loop, this tree's CUDA graph)
with the other tree's package and with this one's, each in a process of
its own, in the same turns.

With ``--decode-ab`` the script only times the plain (meshless)
tinyllama-1.1b and granite-moe-3b-a800m bundles' greedy decode at B 4
after a 4 × 2048 prefill,
with another tree's ``src`` (e.g. a ``git archive`` of the parent commit)
and with this tree's, each in a process of its own, in turns (parent,
this, this, parent, twice), four runs of 8 tokens a process. ``greedy``
replays the engine's captured step where the tree's package has one
(``serve.engine.decode_program``, captured in each process's untimed
first run) and runs the eager step where it has none: a parent without
it is timed eager against this tree's graph.

Tolerances (f32 on both sides, sums in another order): matmul kernels
max|kernel − plain| ≤ 1e-5·max|plain|; backtrack_resnorm within rtol 1e-5
of the plain value per layer; fista_zlast atol 1e-5 + rtol 1e-5 (expf
against torch's exp and the row sums in another order, ulps over 16
steps); relu_zupdate within 1e-6 relative (IEEE /3 in the kernel, a
reciprocal multiply in PyTorch's CUDA division by a scalar), and where the two branch objectives tie to 1e-5,
equal objective values; the grid kernels bitwise (the same arithmetic);
fista_zlast on rows wider than the classes: the class columns as above, the
proximal columns bitwise; pack_codes / unpack_codes bitwise (the wire
layout); flash_attention against its plain versions at the prefill's
shape (B 4, S = T = 2048, Hq 32, Hkv 4, D 64, bf16) causal and not, one
16384-token row, phi-3-mini's (Hq = Hkv = 32, D 96) and granite-8b's
(Hq 32, Hkv 8, D 128) heads at B 1, S = T = 2048 causal, granite-moe's
(Hq 24, Hkv 8, D 64), qwen3-moe's (64, 4, 128), qwen2-vl's (28, 4,
128) and jamba's (32, 8, 128) at B 4, S = T = 2048 causal, whisper's
encoder (H 6, D 64, S = T = 1500, full: a ragged last key tile), its
cross-attention (448 queries on 1500 keys, full) and its decoder's
self-attention (S = T = 448, causal) at B 4, and f32 at S 512:
f32 at the JAX test's rtol = atol = 1e-4; bf16 (P rounded to bf16, as the
model rounds it) by its relative L2 distance to the f32-P plain version,
at most 1.1 times that of the bf16-P plain version, over the whole output
and over every 64-query-position block, with the JAX test's 3e-2 as a
ceiling. Each case also runs controls that the check must refuse: the
output 10% off, the last 64-key tile dropped, and in causal cases the mask
off. Its library yardstick is ``F.scaled_dot_product_attention(...,
enable_gqa=True)``, never on the port's path. The three matmul kernels
are bounded by the route they take (3xTF32 or SIMT f32,
``bound_f32_simt_ms`` beside it) and must give the same bits on a second
call; the script prints the tensor-core instructions (HGMMA, HMMA) in each
redesigned kernel's SASS.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor
# cores, and the dense tensor-core rates. The f32-accurate products of
# fused_linear, admm_pgrad and backtrack_resnorm run as three TF32 passes
# (3xTF32) where the output (admm_pgrad: r) is wider than 16 columns, so
# their bound there is 3·2MNK flops at the TF32 rate; their narrow routes
# are SIMT f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12   # the bound for bf16 inputs
MATMUL_REL_TOL = 1e-5
RESNORM_RTOL = 1e-5
FISTA_ATOL = 1e-5
FISTA_RTOL = 1e-5
FISTA_ITERS = 15
# fista_zlast beyond cora, from the paper's Table II: (dataset, row width;
# None = the classes alone, a one-host last layer)
FISTA_TABLE_CASES = (("coauthor_cs", None), ("ogbn_arxiv", None),
                     ("ogbn_arxiv", 1000))
# token rows of the streaming-route solve over LM_ARCH's vocabulary
FISTA_TOKEN_ROWS = 2048
# classes of the shared-memory-route solve on cora's rows (48 KB a row)
FISTA_SMEM_CLASSES = 4096
TRAJ_RTOL = 1e-3
EPOCHS = 5          # iterations of each training run (the reference trains 200)
MAX_DOUBLINGS = 12  # the p-update's backtracking trials (subproblems.update_p)
BASE_KERNELS = ("fused_linear", "admm_pgrad", "relu_zupdate", "fista_zlast")
GQ_KERNELS = BASE_KERNELS + ("backtrack_resnorm", "grid_project")
WIRE_KERNELS = ("grid_encode", "grid_decode")
PACK_KERNELS = ("pack_codes", "unpack_codes")
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # tests/test_kernels.py
# bf16 flash_attention rounds P to bf16 before the PV product, as the model
# does: it is held by its relative L2 distance to the plain version with f32
# P, which may be at most FLASH_BF16_FACTOR times the distance of the plain
# version with bf16 P (``p_dtype``) to the same output, over the whole
# output and over every block of FLASH_BLOCK query positions; FLASH_TOL
# stays a hard ceiling
FLASH_BF16_FACTOR = 1.1
FLASH_BLOCK = 64
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LONG_ROW = 16384          # prefill_32k's sequence, halved for the plain check
LM_REL_L2 = 2e-2          # last-position logits, kernel vs plain attention
LM_VS_F32 = 1.05          # kernel path's distance to f32, x the plain path's
# lm_family_phase: (arch, depth cut or None). qwen3-moe's 94 layers (470 GB
# in bf16) cannot sit on one card: 8 of them are 39.8 GB with 2.5 GB of
# embedding and head
LM_FAMILY = (("granite-moe-3b-a800m", None), ("qwen3-moe-235b-a22b", 8),
             ("qwen2-vl-7b", None))
FAMILY_F32_LAYERS = {"qwen3-moe-235b-a22b": 2}   # lm_vs_f32's f32 copy
FAMILY_GATHER_ARCH = "granite-moe-3b-a800m"   # both dispatches, engine, train
# gather against einsum in f32 at the same picks: sums in another order
# (f32 products and a K-term sum against one f32 GEMM), ~1e-6 a layer
FAMILY_GATHER_F32_REL = 1e-4
# M-RoPE at t = h = w against RoPE: the same angles on the same path, so
# the same bits up to the order of a sum (tests/test_torch_vlm.py: rtol 1e-5)
FAMILY_MROPE_REL = 1e-5
VLM_IMAGE_GRID = 32       # qwen2-vl's image block: 32 x 32 patches (h, w)
# lm_seq_phase: (arch, depth cut or None). jamba's 4 periods are ~103 GB in
# bf16 (one period of 8 layers ~25.5 GB), so it serves at 2 of them; its
# f32 check runs at one (~53 GB in f32)
LM_SEQ = (("mamba2-130m", None), ("jamba-v0.1-52b", 16),
          ("whisper-tiny", None))
SEQ_F32_LAYERS = {"jamba-v0.1-52b": 8}
WHISPER_FRAMES, WHISPER_TEXT = 1500, 448   # whisper's audio and text contexts
# decode against the full forward pass over DVF_TOKENS tokens from the
# zero state: bf16 within tests/test_model_invariants.py's rtol 5e-2, atol
# 5e-1, its argmax agreement (above 0.95 there, at 2 layers of d 64)
# reported: at mamba2-130m's full width bf16 logits tie within the two
# paths' noise (0.914 measured on an H100); f32 (the same weights cast)
# the same function up to sums in another order
DVF_TOKENS = 64
DVF_F32_REL, DVF_F32_AGREE = 1e-4, 0.99
SEQ_TRAIN_STEPS = 3
# granite-moe trained: its config's 8 microbatches do not divide a batch of
# 4; 16 of its 32 layers, since at full depth the old and new f32 adamw
# moments (27 GB each), the f32 gradient sum and its scaled copy (13.5 GB
# each) and the bf16 weights outgrow 80 GB (~95 GB reckoned)
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_MICRO = 3, 4, 4
FAMILY_TRAIN_LAYERS = 16
# mesh_phase: the port's dry run traced in fake worlds on the host, in two
# processes of about equal trace time (MESH_DRYRUN_SPLIT): tinyllama-1.1b
# on the single production mesh (16, 16), the paper's stage-parallel cells
# and granite-moe's train_4k (its ffn_exp layout: 40 experts do not divide
# 16). Beside them, in a third process,
# tinyllama-1.1b served and trained, granite-moe-3b-a800m (both
# dispatches) and qwen2-vl-7b served, on a 1×1 DeviceMesh over an NCCL
# world of one against the plain (meshless) bundle; the serving runs are
# timed once both dry-run processes have exited
MESH_CELLS = ("train_4k", "prefill_32k", "decode_32k")
MESH_MOE_CELL = ("granite-moe-3b-a800m", "train_4k")
# granite-moe's train step traced at one microbatch of its 8: the same
# tokens, flops and weights in an eighth of the recorded ops
MESH_MOE_MICROBATCHES = 1
# (arch, dispatches) served on the 1×1 mesh at LM serving's prefill and
# MESH_FAMILY_TOKENS greedy tokens
MESH_FAMILY = (("granite-moe-3b-a800m", ("einsum", "gather")),
               ("qwen2-vl-7b", ("einsum",)))
MESH_FAMILY_TOKENS = 8
MESH_FAMILY_TIMED_TOKENS = 4   # greedy tokens per timed decode run
# the bundle's attention chunk (the dry run's CLI takes the reference's
# 256): the same flops in a quarter of the recorded ops, to keep the phase
# in its budget
MESH_ATTN_CHUNK = 1024
MESH_ADMM_BITS = (0, 8)
MESH_PHASE_S = 90              # the phase's wall-time budget (subprocess)
# the dry run's cells (mesh_dryrun's names) by process: each ~30 s of
# traces on the H100's host
MESH_DRYRUN_SPLIT = (("train_4k", "prefill_32k",
                      "mamba2-130m decode_32k"),
                     ("granite-moe-3b-a800m train_4k", "decode_32k",
                      "stage_v1m_b32", "stage_v1m_b8"))
# the SSM's cell in the dry run: mamba2-130m's 24 heads on 16 ranks, the
# ssm_inner layout at full width
MESH_SSM_CELL = ("mamba2-130m", "decode_32k")
MESH_PARTS = ("dryrun-0", "dryrun-1", "host")   # the phase's subprocesses
# mesh_seq_phase: (arch, layers or None for the config's) served on the
# 1×1 mesh against the plain bundle; jamba at one period of its four
# (8 of 32 layers, ~25.5 GB in bf16)
MESH_SEQ = (("mamba2-130m", None), ("whisper-tiny", None),
            ("jamba-v0.1-52b", 8))
MESH_SEQ_PART = "seq"          # its subprocess's part
MESH_SEQ_PHASE_S = 90          # its wall-time budget (subprocess)
MESH_DRYRUN_DONE = "dryrun.done"   # written once the dry run has exited
MESH_TRAIN_SEQ, MESH_TRAIN_BATCH = 1024, 2
MESH_REL_L2 = 1e-6             # f32 relative L2 where the bits differ
MESH_TIMED_TOKENS = 8          # greedy tokens per timed decode run
AB_ORDER = ("parent", "this", "this", "parent")   # --ab's turns
AB_TRAIN_RUNS = 3              # samples of 5 iterations per --ab process
DECODE_AB_RUNS = 4             # timed decode runs per --decode-ab process
DECODE_AB_ORDER = ("parent", "this", "this", "parent") * 2
# the dense decode, and the MoE's (its router and dispatch take their
# own path without a mesh too)
DECODE_AB_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m")
# decode_graph: greedy tokens a run, and the turns of its timing (graph,
# eager, eager, graph)
DECODE_GRAPH_TOKENS = 16
DECODE_GRAPH_TURNS = (True, False, False, True)
# phi3-mini's int8 KV cache decoded at its published widths (d 3072, 32
# MHA heads of 96) and 8 of its 32 layers: the layer is what the graph
# repeats, and full depth's 3.8B seeded weights would only lengthen the
# phase
PHI3_ARCH, PHI3_LAYERS = "phi3-mini-3.8b", 8
# the marker kernel of a traced_kernels window: ~10 µs at 1.98 GHz
TRACE_MARK_CYCLES = 20_000
# lm_train_phase: tinyllama-1.1b trained at full width through Trainer.run
# on one card's share of TRAIN_4K (sequences of 4096, global batch 4), and
# the checks (c)-(e) at full width with the depth cut to TRAIN_CUT_LAYERS
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4096, 4, 6, 3e-4
TRAIN_CUT_LAYERS = 2
# step 0's loss: ln(vocab) for uniform logits, plus about σ²/2 for logits of
# std σ (the 0.02 head over unit-RMS hidden states: σ ≈ 0.02·√2048 ≈ 0.9)
TRAIN_LOSS0_BELOW, TRAIN_LOSS0_ABOVE = 0.5, 1.5
# (c) bf16 against the same weights in f32, full width, 2 layers, 4 × 4096
# tokens: the loss within TRAIN_F32_LOSS_RTOL (measured 4.6e-5); every
# leaf's gradient within TRAIN_F32_GRAD_REL_L2, 3x the largest measured
# (wq 6.7e-3; the others 3.9-6.6e-3 on an H100). Detaching q, k, v puts
# ln1, wq, wk, wv and embed at 1.0
TRAIN_F32_LOSS_RTOL = 1e-2
TRAIN_F32_GRAD_REL_L2 = 2e-2
# (d) two microbatches against one: the loss (measured equal) and each
# leaf's first adamw update within TRAIN_ACCUM_UPDATE_REL_L2, 3x the
# largest measured (wq 1.45e-2; an update is ±lr where |g| >> eps, so this
# counts the elements whose sign flips between the two sums)
TRAIN_ACCUM_LOSS_RTOL = 1e-3
TRAIN_ACCUM_UPDATE_REL_L2 = 5e-2
TRAIN_RESUME_RTOL = 1e-2       # (e) resumed losses against uninterrupted
PROFILE_TRIES = 3   # traces of one iteration (see profile_phase, train_full)
GRAPH_ITERS = 5     # iterations of each graph_phase run
GRAPH_TURNS = (True, False, False, True, True, False)   # graph, eager, ...
SEL_ITERS = 10      # timed calls of each row-predicated kernel case
# graph_loops: steps a turn of the steady timing (one step's calls after
# its capture, graph, eager, eager, graph)
GRAPH_STEADY = 20
API_CALL = re.compile(r"^cu(da)?[A-Z]")   # a CUDA runtime or driver API call
# each kernel wrapper's head kernel, launched once for every call of the
# wrapper (a wrapper may launch a reduction after it: fused_linear_reduce,
# resnorm_sum_kernel; the grid wrappers share one kernel): graph_phase
# counts them in each graph's kernel nodes and in the device traces
HEAD_KERNELS = {
    ("fused_linear",): ("fused_linear_tc", "fused_linear_narrow"),
    ("admm_pgrad",): ("admm_pgrad_tc", "admm_pgrad_narrow"),
    ("relu_zupdate",): ("relu_zupdate_kernel",),
    ("fista_zlast",): ("fista_zlast_kernel",),
    ("backtrack_resnorm",): ("resnorm_partials_tc", "resnorm_partials_rows"),
    ("grid_project", "grid_encode", "grid_decode"): (
        "grid_elementwise_kernel",),
    ("pack_codes",): ("pack4_kernel", "pack16_kernel"),
    ("unpack_codes",): ("unpack4_kernel", "unpack16_kernel"),
}
# a name demangled ("void pack4_kernel<...>") or mangled ("12pack4_kernel")
HEAD_PATTERNS = {"+".join(w): re.compile(r"(?<![A-Za-z_])(" + "|".join(
    names) + ")") for w, names in HEAD_KERNELS.items()}
STAGES = 10         # the ring: mesh (data 1, model 10), one layer per stage
MIXED_CONTROLLER = dict(allowed_bits=(4, 8, 16), min_bits=4, max_bits=16,
                        min_dwell=1, hysteresis=0.0, signal="per_edge",
                        thresholds=((0.5, 4), (0.1, 8)))
REPLAY_CAL_ITERS = 10   # calls per timed batch of the replay calibration
FT_TICKS = 10      # iterations of the chaos and rollback runs
FT_ZERO_SEED = 7
FT_CHAOS = dict(seed=3, flip_rate=0.05, drop_rate=0.05)
# picked on the host from the port's own bit draw (comm.faults.flip_draws)
# at this ring's slab size: at tick 8 two sneaky u slabs (stages 3 and 5)
# carry a flip of bit 30 (the exponent's top bit), which sends a dual of
# magnitude below 2 past 1e30 and so must trip the sentinels
FT_SNEAKY = dict(seed=35, sneaky_rate=0.02, flips_per_event=6)
# baseline_phase: the paper's comparison methods at cora 10x1000. The
# backprop baselines train for twice the ADMM epochs and take the learning
# rates of benchmarks/bench_accuracy.py (GD_METHODS); block-pdADMM stacks 9
# relu(p @ W_l) blocks behind a seeded relu(X @ W_in)
GD_METHODS = (("gd", 1e-1), ("adadelta", 1.0), ("adagrad", 1e-2),
              ("adam", 1e-3))
BLOCK_LAYERS = 9
BLOCK_ITERS = 5
BLOCK_OBJ_RTOL = 1e-4
# z_last of the CE route (the fista_zlast kernel) against the generic route
# (autograd's CE gradient in PyTorch), relative to max |z_last|: each solve
# agrees to 1e-5 + 1e-5·|z| (FISTA_ATOL, FISTA_RTOL), and over 5 iterations
# z_last feeds back only through its own next solve and the last block's
# W-step, so 5 solves' worth of that, with room, is 1e-4
BLOCK_Z_TOL = 1e-4
SASS_KERNELS = ("flash", "fused_linear", "admm_pgrad", "resnorm_partials")
# admm_pgrad's widest narrow r (its streaming route's KP = 16)
NARROW_MAX = 16
# rows of the skewed-stride unpack and pack cases (each row's streams
# realigned)
UNPACK_SKEW_ROWS = 4
# pack from rows this many codes further off a 16-byte boundary than the
# last (4-bit: 4 and 1 bytes; 16-bit: 4 and 2 bytes)
PACK_SKEWS = {4: (4, 1), 16: (2, 1)}
# the pack and unpack kernels, whose device ms a launch the mixed-width
# ring's iterations report
PACK_DEVICE_KERNELS = ("pack4_kernel", "pack16_kernel", "unpack4_kernel",
                     "unpack16_kernel")
# what the port's kernels' names start with, for the profiles: every
# __global__ name in the sources starts with one of them
# (tests/test_torch_kernel_names.py)
PORT_KERNEL_NAMES = (
    "fused_linear_", "admm_pgrad_", "relu_zupdate_kernel", "fista_zlast_kernel",
    "resnorm_", "grid_elementwise_kernel", "pack4_kernel", "pack16_kernel",
    "unpack4_kernel", "unpack16_kernel", "flash_bf16_kernel",
    "flash_f32_kernel")
SOURCES = {
    "fused_linear": ("src/repro_torch/kernels/csrc/fused_linear.cu",
                     "src/repro/kernels/fused_linear.py:40"),
    "admm_pgrad": ("src/repro_torch/kernels/csrc/admm_pgrad.cu",
                   "src/repro/kernels/admm_pgrad.py:18"),
    "relu_zupdate": ("src/repro_torch/kernels/csrc/relu_zupdate.cu",
                     "src/repro/kernels/relu_zupdate.py:28"),
    "fista_zlast": ("src/repro_torch/kernels/csrc/fista_zlast.cu",
                    "src/repro/kernels/fista_zlast.py:88"),
    "fista_zlast_wide": ("src/repro_torch/kernels/csrc/fista_zlast.cu",
                         "src/repro/kernels/fista_zlast.py:88"),
    "backtrack_resnorm": ("src/repro_torch/kernels/csrc/backtrack_resnorm.cu",
                          "src/repro/kernels/backtrack_phi.py:44"),
    "grid_project": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                     "src/repro/kernels/quantize_kernel.py:51"),
    "grid_encode": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                    "src/repro/kernels/quantize_kernel.py:57"),
    "grid_decode": ("src/repro_torch/kernels/csrc/quantize_grid.cu",
                    "src/repro/kernels/quantize_kernel.py:64"),
    "pack_codes": ("src/repro_torch/kernels/csrc/pack_codes.cu",
                   "src/repro/kernels/pack_codes.py:77"),
    "unpack_codes": ("src/repro_torch/kernels/csrc/pack_codes.cu",
                     "src/repro/kernels/pack_codes.py:97"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:52"),
}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events over ``iters``."""
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


def device_ms(fn, iters: int = 20, tries: int = 5,
              per_launch: bool = False) -> float:
    """Device time of one call: the self time of every kernel it launches,
    summed by torch.profiler over ``iters`` calls. Unlike ``time_ms`` it
    leaves out the gaps where the device waits for the host, which set
    the event time of the smallest kernels. Every call launches a kernel,
    so a trace that holds fewer than ``iters`` kernels lost some (the
    profiler has been seen to drop them) and is taken again. With
    ``per_launch`` (for a call that launches one kernel) the time is the
    mean of the kernels the trace holds, at least half of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        caught = sum(ev.count for ev in kernels)
        total = sum(ev.self_device_time_total for ev in kernels) / 1e3
        if caught >= iters:
            return total / iters
        if per_launch and 2 * caught >= iters:
            return total / caught
        print(f"  device_ms: the trace holds {caught} kernels for {iters} "
              f"calls; tracing again", flush=True)
    raise AssertionError(f"device_ms: {tries} traces lost kernels")


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_F32_FLOPS) -> tuple:
    """(least ms, what bounds it) on the card for this much work."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def case(name, kernel, plain, library, n_bytes, n_ops, check,
         peak=PEAK_F32_FLOPS, iters=20):
    """Run, check and time one kernel at one shape."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    readings = check(got, want, err) or {}
    del got, want
    b_ms, b_by = bound(n_bytes, n_ops, peak)
    row = {"shape": name, "max_abs_err": err, "ms": time_ms(kernel, iters),
           "device_ms": device_ms(kernel, iters),
           "plain_ms": time_ms(plain, iters),
           "library_ms": None if library is None else time_ms(library, iters),
           "bound_ms": b_ms, "bound_by": b_by, **readings}
    print(f"  {name}: err {err:.3e}  kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f})  plain {row['plain_ms']:.4f} ms  library "
          f"{row['library_ms']}  bound {b_ms:.4f} ms ({b_by})", flush=True)
    return row


def matmul_case(name, kernel, plain, library, n_bytes, n_ops, n_epi, check,
                route):
    """``case`` for a matmul kernel of ``n_ops`` product flops and ``n_epi``
    f32 epilogue operations, bounded by the route it takes (its wrapper's
    name for it). "tensor_cores": three TF32 products per f32 product at
    495 TFLOP/s plus the epilogue at the f32 rate; any other route: all at
    the SIMT f32 rate, whose bound is kept beside it in either case. A
    second call on the same inputs must give the same bits."""
    tensor_cores = route == "tensor_cores"
    if tensor_cores:   # the epilogue's f32 time, in TF32-rate operations
        ops = 3 * n_ops + n_epi * PEAK_TF32_FLOPS / PEAK_F32_FLOPS
        peak = PEAK_TF32_FLOPS
    else:
        ops, peak = n_ops + n_epi, PEAK_F32_FLOPS
    row = case(name, kernel, plain, library, n_bytes, ops, check, peak)
    row["kernel_route"] = route
    row["bound_route"] = ("3xTF32 tensor cores" if tensor_cores
                          else f"f32 SIMT ({route})")
    row["bound_f32_simt_ms"] = bound(n_bytes, n_ops + n_epi)[0]
    if not torch.equal(kernel(), kernel()):
        raise AssertionError(f"{name}: a second call gave other bits")
    print(f"    bound by route: {row['bound_route']} {row['bound_ms']:.4f} "
          f"ms; SIMT f32 {row['bound_f32_simt_ms']:.4f} ms; repeat bitwise",
          flush=True)
    return row


def matmul_check(got, want, err):
    tol = MATMUL_REL_TOL * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f"max abs err {err:.3e} > {tol:.3e}")


def resnorm_check(got, want, err):
    bad = (got - want).abs() > RESNORM_RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"backtrack_resnorm: {got.tolist()} vs plain "
                             f"{want.tolist()} beyond rtol {RESNORM_RTOL}")


def bitwise_check(got, want, err):
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"not bitwise equal ({got.dtype} vs "
                             f"{want.dtype}, max abs err {err:.3e})")


def fista_check(got, want, err):
    bad = (got - want).abs() > FISTA_ATOL + FISTA_RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"fista_zlast: {int(bad.sum())} elements beyond "
                             f"atol {FISTA_ATOL} + rtol {FISTA_RTOL}")


def fista_wide_check(C):
    """Class columns at the FISTA tolerance, the proximal columns bitwise
    (the kernel keeps the plain version's roundings there)."""
    def check(got, want, err):
        fista_check(got[:, :C], want[:, :C], err)
        if not torch.equal(got[:, C:], want[:, C:]):
            d = float((got[:, C:] - want[:, C:]).abs().max())
            raise AssertionError(f"fista_zlast: proximal columns differ "
                                 f"(max {d:.3e})")
    return check


def zupdate_check_for(a, q, z0):
    def obj(z):
        return (z - a) ** 2 + (q - z.clamp(min=0)) ** 2 + (z - z0) ** 2

    def check(got, want, err):
        # The kernel divides by 3 in IEEE; PyTorch on CUDA multiplies by the
        # reciprocal, so values may differ by an ulp, and where the two
        # branch objectives tie the branch itself may differ.
        zn = ((a + z0) / 2).clamp(max=0)
        zp = ((a + q + z0) / 3).clamp(min=0)
        tied = (obj(zn) - obj(zp)).abs() <= 1e-5 * (obj(zn).abs() + 1e-6)
        far = (got - want).abs() > 1e-6 * want.abs() + 1e-7
        bad = far & ~tied
        if bool(bad.any()):
            raise AssertionError(f"relu_zupdate: {int(bad.sum())} untied "
                                 f"elements differ")
        if not bool(((obj(got) - obj(want)).abs()
                     <= 1e-5 * (obj(want).abs() + 1e-6)).all()):
            raise AssertionError("relu_zupdate: objective differs at a tie")
    return check


def launch_floor_ms(dev) -> float:
    """Device time of the smallest launch: a one-element torch.zeros fill."""
    return device_ms(lambda: torch.zeros(1, device=dev))


def with_floor(row: dict, floor_ms: float) -> dict:
    """``row`` with the launch floor beside its bound, printed."""
    row["launch_floor_ms"] = floor_ms
    print(f"    launch floor {floor_ms:.4f} ms; bound + floor "
          f"{row['bound_ms'] + floor_ms:.4f} ms; device / bound "
          f"{row['device_ms'] / row['bound_ms']:.3f}", flush=True)
    return row


def fista_work(nr: int, w: int, nc: int, steps: int = FISTA_ITERS + 1) -> tuple:
    """(bytes, flops) of one z_L solve on [nr, w] with nc classes: a, z_old
    read and z_L written once, labels and mask; 16 flops a class column and
    step (the expf counted as one); a proximal column 4 in the first step
    and 7 in each later one (y = z + m(z − z₋), g = ν(y − a), z⁺ = y −
    step·g, each rounded)."""
    return (4 * (3 * nr * w + 2 * nr),
            nr * (16 * nc * steps + (w - nc) * (4 + 7 * (steps - 1))))


def fista_inputs(ds, gen, C: int, h: int):
    """The z_L solves, one at a time: cora's last layer [V, C] and the
    ring's head-folded [V, h] and [10 V, h] (cora's labels and train mask),
    then coauthor_cs's and ogbn_arxiv's last layers [V, C] and ogbn_arxiv's
    ring last layer [V, h] (V, C from ``graph.datasets.TABLE_II``; labels
    and a train mask of the table's size drawn on the card from ``gen``).
    Yields (label, a, z_old, labels, mask, classes)."""
    from repro_torch.graph.datasets import TABLE_II
    dev = ds.labels.device
    steps = FISTA_ITERS + 1

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 3.0

    V = ds.labels.shape[0]
    mask = ds.masks["train"]
    yield f"[{V},{C}] x{steps} steps", rand(V, C), rand(V, C), ds.labels, \
        mask, C
    for nr in (V, STAGES * V):
        yield (f"[{nr},{h}] {C} classes x{steps} steps", rand(nr, h),
               rand(nr, h), ds.labels.repeat(nr // V), mask.repeat(nr // V), C)
    for name, w in FISTA_TABLE_CASES:
        nr, _, nc, _, n_tr = TABLE_II[name][:5]
        w = nc if w is None else w
        lab = torch.randint(0, nc, (nr,), generator=gen, device=dev,
                            dtype=torch.int32)
        msk = (torch.rand(nr, generator=gen, device=dev) < n_tr / nr).float()
        yield (f"[{nr},{w}] {nc} classes x{steps} steps ({name})",
               rand(nr, w), rand(nr, w), lab, msk, nc)


def fista_wide_inputs(ds, gen, h: int):
    """The z_L solves past 64 classes (the block-a-row routes) and past
    255 steps, one at a time: cora's rows at h wide with h classes
    (block-pdADMM's CE route at d = h, first: the kernels line's head
    row), with 65 and head-folded with 100; cora's rows at 4096 classes
    (the shared-memory route); cora's [V, C] and [V, 100] at 300
    iterations; 2048 token rows over tinyllama-1.1b's 32000-entry
    vocabulary (the streaming route: 262 MB a tensor). Yields (label, a,
    z_old, labels, mask, classes, n_iters)."""
    from repro_torch.configs.base import get_arch
    dev = ds.labels.device
    V, C = ds.labels.shape[0], ds.n_classes
    mask = ds.masks["train"]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 3.0

    def labels(nr, nc):
        return torch.randint(0, nc, (nr,), generator=gen, device=dev,
                             dtype=torch.int32)

    for w, nc, n_iters in ((h, h, FISTA_ITERS), (h, 65, FISTA_ITERS),
                           (h, 100, FISTA_ITERS),
                           (FISTA_SMEM_CLASSES, FISTA_SMEM_CLASSES,
                            FISTA_ITERS), (C, C, 300), (100, 100, 300)):
        yield (f"[{V},{w}] {nc} classes x{n_iters + 1} steps", rand(V, w),
               rand(V, w), labels(V, nc), mask, nc, n_iters)
    vocab = get_arch(LM_ARCH).vocab
    nr = FISTA_TOKEN_ROWS
    msk = (torch.rand(nr, generator=gen, device=dev) < 0.9).float()
    yield (f"[{nr},{vocab}] {vocab} classes x{FISTA_ITERS + 1} steps "
           f"({LM_ARCH} vocabulary)", rand(nr, vocab), rand(nr, vocab),
           labels(nr, vocab), msk, vocab, FISTA_ITERS)


def fista_rows(ds, gen, C: int, h: int, nu: float) -> tuple:
    """``case`` for fista_zlast at every ``fista_inputs`` shape (the
    lane-group route) and every ``fista_wide_inputs`` shape (the others),
    each also called twice more for the same bits; the [V, C] rows carry
    the launch floor. Returns (the lane-group rows at 16 steps, the rows
    past 64 classes or 255 steps: the kernels line's ``fista_zlast_wide``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fista_zlast import fista_zlast, route
    print("fista_zlast:", flush=True)
    floor_ms = launch_floor_ms(ds.labels.device)
    print(f"  launch floor (device ms of a one-element torch.zeros fill): "
          f"{floor_ms:.4f}", flush=True)
    lanes, wide = [], []
    solves = itertools.chain(
        ((*x, FISTA_ITERS) for x in fista_inputs(ds, gen, C, h)),
        fista_wide_inputs(ds, gen, h))
    for label, a, z0, lab, msk, nc, n_iters in solves:
        nr, w = a.shape

        def kern(a=a, z0=z0, lab=lab, msk=msk, nc=nc, n_iters=n_iters):
            return fista_zlast(a, z0, lab, msk, nu=nu, n_iters=n_iters,
                               n_classes=nc)
        row = case(
            label, kern,
            lambda a=a, z0=z0, lab=lab, msk=msk, nc=nc, n_iters=n_iters:
            ref.fista_zlast_ref(a, z0, lab, msk, nu=nu, n_iters=n_iters,
                                n_classes=nc),
            None, *fista_work(nr, w, nc, n_iters + 1),
            fista_check if w == nc else fista_wide_check(nc))
        if not torch.equal(kern(), kern()):
            raise AssertionError(f"fista_zlast {label}: a second call gave "
                                 f"other bits")
        row["repeat_bitwise"] = True
        row["kernel_route"] = route(nc)
        if w == nc:
            row["launch_floor_ms"] = floor_ms
        (lanes if route(nc) == "lanes" and n_iters == FISTA_ITERS
         else wide).append(row)
    return lanes, wide


def fista_entry(lib, nu: float, host_moms: bool = False):
    """A caller of ``lib``'s ``fista_zlast_f32`` (the C entry point every
    version of the kernel exports) as the port's wrapper calls it, with no
    launch count: the same host path for each library timed. Sources
    before the wide route (``host_moms``) take the momentum weights as
    host floats and no scratch; the wide rows' scratch is never needed at
    the lane-group shapes timed here."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.fista_zlast import (momentum_buffer,
                                                 momentum_schedule)
    fn = lib.fista_zlast_f32
    fn.restype = ctypes.c_int
    if host_moms:
        _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.POINTER(_F),
                       _I, _F, _F, _P]
        moms = momentum_schedule(FISTA_ITERS)
        moms_c = (ctypes.c_float * len(moms))(*moms)
    else:
        fn.argtypes = build.SIGNATURES["fista_zlast_f32"]

    def call(a, z0, lab, msk, nc):
        out = torch.empty_like(a)
        V, N = a.shape
        ptrs = (a.data_ptr(), z0.data_ptr(), lab.data_ptr(), msk.data_ptr(),
                out.data_ptr())
        if host_moms:
            err = fn(*ptrs, V, N, nc, moms_c, len(moms), 1.0 / (1.0 + nu),
                     nu, build.stream_handle(a))
        else:
            m = momentum_buffer(FISTA_ITERS, a.device)
            err = fn(*ptrs, None, 0, V, N, nc, m.data_ptr(), m.numel(),
                     1.0 / (1.0 + nu), nu, build.stream_handle(a))
        build.check(err, "fista_zlast_f32")
        return out
    return call


def build_one(src, out_dir) -> str:
    """``src`` alone (a plain-C-interface CUDA source) built as the port's
    build builds each source, into ``out_dir``; ptxas's report printed."""
    from repro_torch.kernels import build
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "lib" + os.path.basename(src)[:-3] + ".so")
    res = subprocess.run([build.find_nvcc(), *build.ARCH, *build.CFLAGS,
                          "-shared", "-o", lib, src], capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas (parent):", line.strip())
    return lib


def ab_turns(label, runs, bound_ms) -> dict:
    """``runs`` ({"parent": fn, "this": fn}, one launch a call) timed in
    turns (AB_ORDER) by device time per launch (a trace of the other
    tree's separately loaded library has been seen to lose one kernel in
    20) and by events; printed beside the bound."""
    r = {"shape": label, "device_ms": {}, "ms": {}, "bound_ms": bound_ms}
    for k in AB_ORDER:
        r["device_ms"].setdefault(k, []).append(
            device_ms(runs[k], per_launch=True))
        r["ms"].setdefault(k, []).append(time_ms(runs[k]))
    print(f"  {label}: device ms parent {r['device_ms']['parent']} this "
          f"{r['device_ms']['this']}; events parent {r['ms']['parent']} this "
          f"{r['ms']['this']}; bound {bound_ms:.4f}", flush=True)
    return r


def fista_ab(csrc, ds, nu, h) -> list:
    """fista_zlast from another tree's sources (``csrc``, its
    ``kernels/csrc``) against this tree's, in turns (``ab_turns``) at
    every ``fista_inputs`` shape; each pair's outputs checked against each
    other (class columns at the FISTA tolerance, proximal columns
    bitwise)."""
    import ctypes

    from repro_torch.kernels import build
    src = os.path.join(csrc, "fista_zlast.cu")
    with open(src) as fh:
        host_moms = "struct Momentum" in fh.read()
    lib = build_one(src, str(build.BUILD_ROOT.parent / "ab_parent_lib"))
    versions = {"parent": fista_entry(ctypes.CDLL(lib), nu, host_moms),
                "this": fista_entry(build.library(), nu)}
    gen = torch.Generator(device=ds.labels.device).manual_seed(1)
    C = ds.n_classes
    out = []
    print("fista_zlast, parent against this tree:", flush=True)
    for label, a, z0, lab, msk, nc in fista_inputs(ds, gen, C, h):
        runs = {k: (lambda f=f: f(a, z0, lab, msk, nc))
                for k, f in versions.items()}
        got, want = runs["this"](), runs["parent"]()
        torch.cuda.synchronize()
        (fista_check if a.shape[1] == nc else fista_wide_check(nc))(
            got, want, float((got - want).abs().max()))
        same = torch.equal(got, want)
        print(f"  {label}: bitwise the parent's: {same}", flush=True)
        del got, want
        out.append(ab_turns(label, runs, bound(*fista_work(*a.shape, nc))[0]))
        out[-1]["bitwise_parent"] = same
    return out


def pgrad_entry(lib, nu: float, rho: float):
    """A caller of ``lib``'s ``admm_pgrad_f32`` as the port's wrapper calls
    it (the route from ``admm_pgrad.route``), with no launch count."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.admm_pgrad import route
    fn = lib.admm_pgrad_f32
    fn.argtypes = build.SIGNATURES["admm_pgrad_f32"]
    fn.restype = ctypes.c_int

    def call(r, W, u, p, q):
        lead = tuple(r.shape[:-2])
        V, n_out = r.shape[-2:]
        n_in = W.shape[-2]
        out = torch.empty(lead + (V, n_in), dtype=torch.float32,
                          device=r.device)
        build.check(fn(r.data_ptr(), W.data_ptr(), u.data_ptr(), p.data_ptr(),
                       q.data_ptr(), out.data_ptr(), lead[0] if lead else 1,
                       V, n_out, n_in, V * n_out, n_in * n_out, V * n_in, nu,
                       rho, int(route(n_out) == "tensor_cores"),
                       build.stream_handle(r)), "admm_pgrad_f32")
        return out
    return call


def unpack_entry(lib, bits: int):
    """A caller of ``lib``'s ``unpack_codes4`` / ``unpack_codes16`` on a
    [rows, ≥ body] uint8 container (any row stride), with no launch
    count."""
    import ctypes

    from repro_torch.kernels import build
    name = "unpack_codes4" if bits <= 4 else "unpack_codes16"
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    dt = torch.uint8 if bits <= 4 else torch.uint16

    def call(packed, n):
        rows = packed.shape[0]
        out = torch.empty((rows, n), dtype=dt, device=packed.device)
        build.check(fn(packed.data_ptr(), out.data_ptr(), rows, n,
                       packed.stride(0), n, build.stream_handle(packed)), name)
        return out
    return call


def skewed_rows(x, skew: int):
    """The first UNPACK_SKEW_ROWS rows of x [rows, m], copied into a buffer
    whose row stride is m rounded up to 16 bytes plus ``skew`` elements:
    each row starts skew elements further off a 16-byte boundary than the
    last."""
    per16 = 16 // x.element_size()
    m = x.shape[1]
    ld = (m + per16 - 1) // per16 * per16 + skew
    flat = torch.zeros(UNPACK_SKEW_ROWS * ld, dtype=x.dtype, device=x.device)
    rows = flat.view(UNPACK_SKEW_ROWS, ld)[:, :m]
    rows.copy_(x[:UNPACK_SKEW_ROWS])
    return rows


def pack_entry(lib, bits: int):
    """A caller of ``lib``'s ``pack_codes4`` / ``pack_codes16`` on [rows, n]
    codes (any row stride), with no launch count."""
    import ctypes

    from repro_torch.comm.codecs import _body_bytes
    from repro_torch.kernels import build
    name = "pack_codes4" if bits <= 4 else "pack_codes16"
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    fn.restype = ctypes.c_int

    def call(codes):
        rows, n = codes.shape
        nb = _body_bytes(bits, n)
        out = torch.empty((rows, nb), dtype=torch.uint8, device=codes.device)
        build.check(fn(codes.data_ptr(), out.data_ptr(), rows, n,
                       codes.stride(0), nb, build.stream_handle(codes)), name)
        return out
    return call


def kernel_ab(csrc, X, dims, nu, rho) -> dict:
    """``admm_pgrad``, ``unpack_codes`` and ``pack_codes`` built from
    another tree's sources (``csrc``, its ``kernels/csrc``) against this
    tree's, in turns (``ab_turns``), at kernel_phase's shapes: the narrow
    route at n_out 7 and 16, the 3xTF32 route ×8, every unpack case and
    every pack case. The two versions' outputs are compared bit for bit:
    unpack and pack must agree (the wire layout), and pack must equal its
    plain version; admm_pgrad's agreement is reported."""
    import ctypes

    from repro_torch.comm.codecs import _body_bytes
    from repro_torch.kernels import build, ref
    out_dir = str(build.BUILD_ROOT.parent / "ab_parent_lib")
    libs = {"parent": {k: ctypes.CDLL(build_one(
                os.path.join(csrc, k + ".cu"), out_dir))
                for k in ("admm_pgrad", "pack_codes")},
            "this": {k: build.library() for k in ("admm_pgrad", "pack_codes")}}
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(2)
    V, h, C = X.shape[0], dims[1], dims[-1]
    B = len(dims) - 3
    res = {"admm_pgrad": [], "unpack_codes": [], "pack_codes": []}
    print("admm_pgrad, parent against this tree:", flush=True)
    for label, lead, n_out in ((f"[{V},{C}]@[{h},{C}]ᵀ", (), C),
                               (f"[{V},{NARROW_MAX}]@[{h},{NARROW_MAX}]ᵀ", (),
                                NARROW_MAX),
                               (f"x{B} [{V},{h}]@[{h},{h}]ᵀ", (B,), h)):
        r = torch.randn(lead + (V, n_out), generator=gen, device=dev)
        W = torch.randn(lead + (h, n_out), generator=gen, device=dev)
        u, p, q = (torch.randn(lead + (V, h), generator=gen, device=dev)
                   for _ in range(3))
        runs = {k: (lambda f=pgrad_entry(v["admm_pgrad"], nu, rho):
                    f(r, W, u, p, q)) for k, v in libs.items()}
        same = bool(torch.equal(runs["parent"](), runs["this"]()))
        nb = lead[0] if lead else 1
        n_bytes = 4 * nb * (V * n_out + h * n_out + 4 * V * h)
        flops, epi = nb * 2 * V * n_out * h, nb * 5 * V * h
        row = ab_turns(label, runs, (
            bound(n_bytes, 3 * flops + epi * PEAK_TF32_FLOPS / PEAK_F32_FLOPS,
                  PEAK_TF32_FLOPS) if n_out > NARROW_MAX
            else bound(n_bytes, flops + epi))[0])
        row["same_bits"] = same
        print(f"    parent and this tree give the same bits: {same}",
              flush=True)
        res["admm_pgrad"].append(row)
    print("unpack_codes, parent against this tree:", flush=True)
    n = V * h
    for bits in (4, 16):
        cases = [(f"[{m}] {bits}-bit", torch.randint(
            0, 256, (1, _body_bytes(bits, m)), generator=gen, device=dev,
            dtype=torch.int32).to(torch.uint8), m) for m in (n, n + 1)]
        nr = STAGES if bits <= 4 else STAGES - 2
        cap = _body_bytes(16, n)
        cases.append((f"[{nr},{cap}] container, {bits}-bit", torch.randint(
            0, 256, (nr, cap), generator=gen, device=dev,
            dtype=torch.int32).to(torch.uint8), n))
        nb = _body_bytes(bits, n)
        for skew in (4, 1):
            ld = (nb + 15) // 16 * 16 + skew
            flat = torch.randint(0, 256, (UNPACK_SKEW_ROWS * ld,),
                                 generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint8)
            cases.append((f"[{UNPACK_SKEW_ROWS},{nb}] row stride {ld}, "
                          f"{bits}-bit", flat.view(UNPACK_SKEW_ROWS, ld)[:, :nb],
                          n))
        for label, packed, m in cases:
            runs = {k: (lambda f=unpack_entry(v["pack_codes"], bits):
                        f(packed, m)) for k, v in libs.items()}
            if not torch.equal(runs["parent"]().to(torch.int32),
                               runs["this"]().to(torch.int32)):
                raise AssertionError(f"unpack_codes {label}: parent and this "
                                     f"tree differ")
            cb = 1 if bits <= 4 else 2
            res["unpack_codes"].append(ab_turns(label, runs, bound(
                packed.shape[0] * (_body_bytes(bits, m) + cb * m), 0)[0]))
    print("pack_codes, parent against this tree:", flush=True)
    for bits in (4, 16):
        dt = torch.uint8 if bits <= 8 else torch.uint16
        nr = STAGES if bits <= 4 else STAGES - 2
        draw = [torch.randint(0, 2 ** bits, (r, m), generator=gen, device=dev,
                              dtype=torch.int32).to(dt)
                for r, m in ((1, n), (1, n + 1), (nr, n))]
        cases = [(f"[{n}] {bits}-bit", draw[0]),
                 (f"[{n + 1}] {bits}-bit", draw[1]),
                 (f"[{nr},{n}] {bits}-bit (mixed-width ring)", draw[2])]
        for skew in PACK_SKEWS[bits]:
            skewed = skewed_rows(draw[2], skew)
            cases.append((f"[{UNPACK_SKEW_ROWS},{n}] row stride "
                          f"{skewed.stride(0)}, {bits}-bit", skewed))
        for label, codes in cases:
            runs = {k: (lambda f=pack_entry(v["pack_codes"], bits):
                        f(codes)) for k, v in libs.items()}
            got = runs["this"]()
            if not torch.equal(runs["parent"](), got):
                raise AssertionError(f"pack_codes {label}: parent and this "
                                     f"tree differ")
            if not torch.equal(got, ref.pack_codes_ref(codes, bits)):
                raise AssertionError(f"pack_codes {label}: this tree differs "
                                     f"from the plain version")
            del got
            rows, m = codes.shape
            res["pack_codes"].append(ab_turns(label, runs, bound(
                rows * (codes.element_size() * m + _body_bytes(bits, m)),
                0)[0]))
    return res


def driver_ms_per_iter(X, ds, cfg, state, n=5) -> list:
    """ms per iteration through ``pdadmm.run_chunked`` as the tree's
    ``train`` calls it (its default driver: eager before the compiled
    driver, a CUDA graph after): AB_TRAIN_RUNS samples of ``n``
    iterations, host clock, each ending in the metrics' copy to the host
    (a sync), after one call that warms (and captures)."""
    from repro_torch.core import pdadmm
    step = functools.partial(pdadmm.iterate, config=cfg)
    args = (X, ds.labels, ds.masks["train"])
    state, _ = pdadmm.run_chunked(step, state, args, n)
    out = []
    for _ in range(AB_TRAIN_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = pdadmm.run_chunked(step, state, args, n)
        out.append((time.perf_counter() - t) / n * 1e3)
    return out


def train_child(src: str, path: str) -> int:
    """``--train-child``: G's and G-Q's ms per iteration through the
    kernels, as ``train_phase`` times them (AB_TRAIN_RUNS samples of 5
    iterations from a trained state), and through the tree's default
    chunked driver (``driver_ms_per_iter``), with the ``repro_torch``
    package under ``src``."""
    src = os.path.abspath(src)
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise AssertionError(f"repro_torch came from {repro_torch.__file__}"
                             f", not {src}")
    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.graph.datasets import synthetic
    from repro_torch.kernels import build
    build.build()
    build.library()
    dev = torch.device("cuda")
    ds = synthetic("cora", scale=1.0, device=dev)
    X = ds.augmented(4)
    dims = [X.shape[1]] + [1000] * 9 + [ds.n_classes]
    out = {"src": src}
    for label, cfg in (("G", ADMMConfig(nu=1e-2, rho=1.0)),
                       ("GQ", ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True,
                                         quantize_q=True,
                                         grid=uniform_grid(8, -2.0, 6.0)))):
        state = train_run(X, ds, dims, cfg, EPOCHS)[0]
        out[label] = [ms_per_iter(X, ds, cfg, state)
                      for _ in range(AB_TRAIN_RUNS)]
        out[label + "_driver"] = driver_ms_per_iter(X, ds, cfg, state)
    write_record(path, out)
    return 0


def train_ab(parent_root: str) -> dict:
    """``--ab``'s training part: G's and G-Q's ms per iteration with
    another tree's package (``PARENT_ROOT/src``) and with this tree's,
    each in a process of its own, in turns (AB_ORDER): ``iterate`` in a
    loop, and each tree's default chunked driver (``*_driver``: the
    parent's eager loop against this tree's CUDA graph)."""
    import tempfile
    d = tempfile.mkdtemp()
    keys = ("G", "GQ", "G_driver", "GQ_driver")
    res = {k: {"parent": [], "this": []} for k in keys}
    try:
        for i, name in enumerate(AB_ORDER):
            src = (os.path.join(os.path.abspath(parent_root), "src")
                   if name == "parent" else os.path.join(ROOT, "src"))
            path = os.path.join(d, f"train.{i}.json")
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--train-child", path, "--src", src],
                                 timeout=900)
            if run.returncode != 0:
                raise AssertionError(f"train child ({name}): exit "
                                     f"{run.returncode}")
            with open(path) as f:
                got = json.load(f)
            for key in keys:
                res[key][name] += got[key]
            print(f"  {name}: ms per iteration " + ", ".join(
                f"{key} {got[key]}" for key in keys), flush=True)
        for key, v in res.items():
            print(f"{key} ms per iteration, median: parent "
                  f"{float(np.median(v['parent'])):.3f}, this tree "
                  f"{float(np.median(v['this'])):.3f}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res


def pack_rows(gen, n: int, floor_ms: float) -> tuple:
    """``case`` rows of pack_codes and unpack_codes (each with the launch
    floor) at one boundary slab of n codes and an odd n + 1, the
    mixed-width ring's batches, and rows at skewed strides; codes drawn on
    the card from ``gen``."""
    from repro_torch.comm.codecs import _body_bytes
    from repro_torch.kernels import pack_codes as pc
    from repro_torch.kernels import ref
    dev = gen.device
    print("pack_codes / unpack_codes:", flush=True)
    pk, upk = [], []
    for bits in (4, 16):
        dt = torch.uint8 if bits <= 8 else torch.uint16
        for m in (n, n + 1):         # one boundary slab; an odd n
            codes = torch.randint(0, 2 ** bits, (m,), generator=gen,
                                  device=dev, dtype=torch.int32).to(dt)
            nb = _body_bytes(bits, m)
            cb = codes.element_size()
            pk.append(with_floor(case(
                f"[{m}] {bits}-bit", lambda c=codes, b=bits: pc.pack_codes(c, b),
                lambda c=codes, b=bits: ref.pack_codes_ref(c, b), None,
                cb * m + nb, 2 * m, bitwise_check), floor_ms))
            packed = ref.pack_codes_ref(codes, bits)
            upk.append(with_floor(case(
                f"[{m}] {bits}-bit",
                lambda p=packed, b=bits, m=m: pc.unpack_codes(p, b, m),
                lambda p=packed, b=bits, m=m: ref.unpack_codes_ref(p, b, m),
                None, nb + cb * m, 2 * m, bitwise_check), floor_ms))
    # the mixed-width ring's own shapes: one row per stage's slab (row
    # strides of 2,485,000 codes leave every other row 8 bytes off a
    # 16-byte boundary), unpacked from the head of each 16-bit-wide
    # container row (4,970,000 bytes)
    cap = _body_bytes(16, n)
    for bits, nr in ((4, STAGES), (16, STAGES - 2)):
        dt = torch.uint8 if bits <= 8 else torch.uint16
        codes = torch.randint(0, 2 ** bits, (nr, n), generator=gen,
                              device=dev, dtype=torch.int32).to(dt)
        nb = _body_bytes(bits, n)
        cb = codes.element_size()
        pk.append(with_floor(case(
            f"[{nr},{n}] {bits}-bit (mixed-width ring)",
            lambda c=codes, b=bits: pc.pack_codes(c, b),
            lambda c=codes, b=bits: ref.pack_codes_ref(c, b), None,
            nr * (cb * n + nb), 2 * nr * n, bitwise_check), floor_ms))
        # packing from rows whose stride leaves each one further off a
        # 16-byte boundary than the last (every input stream realigned)
        for skew in PACK_SKEWS[bits]:
            skewed = skewed_rows(codes, skew)
            pk.append(with_floor(case(
                f"[{UNPACK_SKEW_ROWS},{n}] row stride {skewed.stride(0)} "
                f"({cb * skew} off 16), {bits}-bit",
                lambda c=skewed, b=bits: pc.pack_codes(c, b),
                lambda c=skewed, b=bits: ref.pack_codes_ref(c, b), None,
                UNPACK_SKEW_ROWS * (cb * n + nb), 2 * UNPACK_SKEW_ROWS * n,
                bitwise_check), floor_ms))
        container = torch.zeros((nr, cap), dtype=torch.uint8, device=dev)
        container[:, :nb] = ref.pack_codes_ref(codes, bits)
        upk.append(with_floor(case(
            f"[{nr},{cap}] container, {bits}-bit (mixed-width ring)",
            lambda p=container, b=bits: pc.unpack_codes(p, b, n),
            lambda p=container, b=bits: ref.unpack_codes_ref(p, b, n),
            None, nr * (nb + cb * n), 2 * nr * n, bitwise_check), floor_ms))
        # rows whose stride leaves each one 4 or 1 bytes further off a
        # 16-byte boundary than the last (every stream realigned)
        for skew in (4, 1):
            skewed = skewed_rows(container[:, :nb], skew)
            upk.append(with_floor(case(
                f"[{UNPACK_SKEW_ROWS},{nb}] row stride {skewed.stride(0)} "
                f"({skew} off 16), {bits}-bit",
                lambda p=skewed, b=bits: pc.unpack_codes(p, b, n),
                lambda p=skewed, b=bits: ref.unpack_codes_ref(p, b, n),
                None, UNPACK_SKEW_ROWS * (nb + cb * n),
                2 * UNPACK_SKEW_ROWS * n, bitwise_check), floor_ms))
    return pk, upk


def sel_rows(gen, n: int, floor_ms: float) -> dict:
    """``case`` rows of the row-predicated wire kernels (the mixed-width
    ring's padded wire: one launch a width of the 4/8/16 wire, each row a
    stage's slab of n codes, rows of the width's stages written) at the
    ring's shapes, keyed by wrapper: on a 4/8/16 mix over 10 stages each
    width's launch; all 10 rows at 4 bits and 8 rows at 16 (the
    unpredicated rows' [10, n] and [8, n]); and a launch that matches no
    row (a table without 8-bit stages for the grid kernels, an all-8-bit
    one for pack and unpack), beside the launch floor. Each bitwise
    against its plain version on the same table; the bound counts the
    bytes of the rows the table selects."""
    from repro_torch.comm.codecs import _body_bytes
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.kernels import pack_codes as pc
    from repro_torch.kernels import quantize_kernel as qk
    from repro_torch.kernels import ref
    dev = gen.device
    widths = (4, 8, 16)
    grids = [uniform_grid(b, -2.0, 6.0) for b in widths]
    cap = _body_bytes(16, n)
    out = {k: [] for k in ("grid_encode", "grid_decode", "pack_codes",
                           "unpack_codes")}
    print("row-predicated wire kernels (a launch a width):", flush=True)
    for label, table, ks in (
            ("4/8/16 mix", [0, 1, 2] * 3 + [0], (0, 1, 2)),
            ("all 4-bit", [0] * STAGES, (0,)),
            ("all 16-bit", [2] * (STAGES - 2), (2,)),
            ("no 8-bit stage", [0, 2] * (STAGES // 2), (1,)),
            ("all 8-bit", [1] * STAGES, (0, 2))):
        rows = len(table)
        sel = torch.tensor(table, dtype=torch.int32, device=dev)
        x = torch.rand((rows, n), generator=gen, device=dev) * 9.0 - 2.5
        for k in ks:
            bits, grid = widths[k], grids[k]
            m = table.count(k)
            cb = 1 if bits <= 8 else 2
            nb = _body_bytes(bits, n)
            name = (f"sel [{rows},{n}] {label}, {bits}-bit launch ({m} of "
                    f"{rows} rows)")
            codes = ref.grid_encode_ref(x, grid)
            packed = torch.zeros((rows, cap), dtype=torch.uint8, device=dev)
            if bits != 8:
                packed[:, :nb] = ref.pack_codes_ref(codes, bits)
            cases = [("grid_encode", lambda b, x=x, g=grid, s=sel, k=k:
                      qk.grid_encode_sel(x, g, b, s, k),
                      lambda b, x=x, g=grid, s=sel, k=k:
                      ref.grid_encode_sel_ref(x, g, b, s, k),
                      torch.zeros_like(codes), m * n * (4 + cb), 4 * m * n),
                     ("grid_decode", lambda b, c=codes, g=grid, s=sel, k=k:
                      qk.grid_decode_sel(c, g, b, s, k),
                      lambda b, c=codes, g=grid, s=sel, k=k:
                      ref.grid_decode_sel_ref(c, g, b, s, k),
                      torch.full((rows, n), -1.0, device=dev),
                      m * n * (4 + cb), 2 * m * n)]
            if bits != 8:
                cases += [
                    ("pack_codes", lambda b, c=codes, s=sel, k=k, w=bits:
                     pc.pack_codes_sel(c, w, b, s, k),
                     lambda b, c=codes, s=sel, k=k, w=bits:
                     ref.pack_codes_sel_ref(c, w, b, s, k),
                     torch.zeros((rows, cap), dtype=torch.uint8, device=dev),
                     m * (cb * n + nb), 2 * m * n),
                    ("unpack_codes", lambda b, p=packed, s=sel, k=k, w=bits:
                     pc.unpack_codes_sel(p, w, b, s, k),
                     lambda b, p=packed, s=sel, k=k, w=bits:
                     ref.unpack_codes_sel_ref(p, w, b, s, k),
                     torch.zeros_like(codes), m * (nb + cb * n), 2 * m * n)]
            for wrapper, kern, plain, base, n_bytes, n_ops in cases:
                if wrapper in ("pack_codes", "unpack_codes") \
                        and label == "no 8-bit stage":
                    continue
                if wrapper in ("grid_encode", "grid_decode") \
                        and label == "all 8-bit":
                    continue
                # each form writes into a buffer of its own, filled alike
                bk, bp = base.clone(), base.clone()
                row = case(name, lambda f=kern, b=bk: f(b),
                           lambda f=plain, b=bp: f(b), None, n_bytes, n_ops,
                           bitwise_check, iters=SEL_ITERS)
                row.update(predicated=True, rows_selected=m,
                           launch_floor_ms=floor_ms)
                print(f"    launch floor {floor_ms:.4f} ms; device / floor "
                      f"{row['device_ms'] / floor_ms:.2f}", flush=True)
                out[wrapper].append(row)
    return out


def kernel_phase(X, ds, dims, nu, rho, grid):
    from repro_torch.kernels import ref
    from repro_torch.kernels import quantize_kernel as qk
    from repro_torch.kernels.admm_pgrad import admm_pgrad
    from repro_torch.kernels.admm_pgrad import route as pgrad_route
    from repro_torch.kernels.backtrack_phi import backtrack_resnorm
    from repro_torch.kernels.backtrack_phi import route as resnorm_route
    from repro_torch.kernels.fused_linear import NARROW_N as NARROW
    from repro_torch.kernels.fused_linear import fused_linear
    from repro_torch.kernels.relu_zupdate import relu_zupdate

    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    V, K0, h, C = X.shape[0], dims[0], dims[1], dims[-1]
    B = len(dims) - 3                       # stacked hidden layers 1..L-2
    rows = {}
    floor_ms = launch_floor_ms(dev)
    print(f"launch floor (device ms of a one-element torch.zeros fill): "
          f"{floor_ms:.4f}", flush=True)

    print("fused_linear:", flush=True)
    fl = []
    for name, p, W, b, z in (
            (f"residual [{V},{K0}]@[{K0},{h}]", X, rand(K0, h, scale=K0 ** -0.5),
             rand(h), rand(V, h)),
            (f"residual x{B} [{V},{h}]@[{h},{h}]", rand(B, V, h).relu(),
             rand(B, h, h, scale=h ** -0.5), rand(B, h), rand(B, V, h)),
            (f"residual x{STAGES} [{V},{h}]@[{h},{h}] (ring)",
             rand(STAGES, V, h).relu(), rand(STAGES, h, h, scale=h ** -0.5),
             rand(STAGES, h), rand(STAGES, V, h)),
            (f"residual [{V},{h}]@[{h},{C}]", rand(V, h).relu(),
             rand(h, C, scale=h ** -0.5), rand(C), rand(V, C))):
        zb = z - b.unsqueeze(-2)
        lib = ((lambda zb=zb, p=p, W=W: torch.addmm(zb, p, W, alpha=-1))
               if p.dim() == 2 else
               (lambda zb=zb, p=p, W=W: torch.baddbmm(zb, p, W, alpha=-1)))
        nb = p.shape[0] if p.dim() == 3 else 1
        M, K = p.shape[-2:]
        N = W.shape[-1]
        fl.append(matmul_case(
            name, lambda: fused_linear(p, W, b, z, mode="residual"),
            lambda: ref.fused_linear_ref(p, W, b, z, mode="residual"), lib,
            4 * nb * (M * K + K * N + N + 2 * M * N), nb * 2 * M * K * N,
            nb * 2 * M * N, matmul_check,
            "tensor_cores" if N > NARROW else "rows"))
    g = rand(K0, h, scale=1e-3)
    fl.append(matmul_case(
        f"linear [{V},{K0}]@[{K0},{h}] (W-update pg)",
        lambda: fused_linear(X, g, None, mode="linear"),
        lambda: ref.fused_linear_ref(X, g, None, mode="linear"),
        lambda: torch.mm(X, g), 4 * (V * K0 + K0 * h + V * h),
        2 * V * K0 * h, 0, matmul_check, "tensor_cores"))
    rows["fused_linear"] = fl

    print("admm_pgrad:", flush=True)
    pg = []
    for name, r, W, shape_in in (
            (f"x{B} [{V},{h}]@[{h},{h}]ᵀ", rand(B, V, h),
             rand(B, h, h, scale=h ** -0.5), (B, V, h)),
            (f"x{STAGES} [{V},{h}]@[{h},{h}]ᵀ (ring)", rand(STAGES, V, h),
             rand(STAGES, h, h, scale=h ** -0.5), (STAGES, V, h)),
            (f"[{V},{C}]@[{h},{C}]ᵀ", rand(V, C), rand(h, C, scale=C ** -0.5),
             (V, h)),
            (f"[{V},{NARROW_MAX}]@[{h},{NARROW_MAX}]ᵀ", rand(V, NARROW_MAX),
             rand(h, NARROW_MAX, scale=NARROW_MAX ** -0.5), (V, h))):
        u, p, q = rand(*shape_in), rand(*shape_in).relu(), rand(*shape_in).relu()
        c = u + rho * (p - q)
        lib = ((lambda c=c, r=r, W=W: torch.addmm(c, r, W.mT, alpha=-nu))
               if r.dim() == 2 else
               (lambda c=c, r=r, W=W: torch.baddbmm(c, r, W.mT, alpha=-nu)))
        nb = r.shape[0] if r.dim() == 3 else 1
        Vr, n_out = r.shape[-2:]
        n_in = W.shape[-2]
        pg.append(matmul_case(
            name, lambda: admm_pgrad(r, W, u, p, q, nu=nu, rho=rho),
            lambda: ref.admm_pgrad_ref(r, W, u, p, q, nu=nu, rho=rho), lib,
            4 * nb * (Vr * n_out + n_in * n_out + 4 * Vr * n_in),
            nb * 2 * Vr * n_out * n_in, nb * 5 * Vr * n_in, matmul_check,
            pgrad_route(n_out)))
        if pgrad_route(n_out) != "tensor_cores":
            with_floor(pg[-1], floor_ms)
    rows["admm_pgrad"] = pg

    print("relu_zupdate:", flush=True)
    rows["relu_zupdate"] = []
    for L1, tail in ((len(dims) - 2, ""), (STAGES, " (ring)")):
        a, q, z0 = rand(L1, V, h), rand(L1, V, h).relu(), rand(L1, V, h)
        n = a.numel()
        rows["relu_zupdate"].append(case(
            f"[{L1},{V},{h}]{tail}",
            lambda a=a, q=q, z0=z0: relu_zupdate(a, q, z0),
            lambda a=a, q=q, z0=z0: ref.relu_zupdate_ref(a, q, z0), None,
            16 * n, 27 * n, zupdate_check_for(a, q, z0)))

    rows["fista_zlast"], rows["fista_zlast_wide"] = fista_rows(ds, gen, C, h,
                                                             nu)

    print("backtrack_resnorm:", flush=True)
    bt = []
    half = (torch.arange(B, device=dev) % 2).to(torch.int32)
    for name, r0, d, W, active in (
            (f"x{B} [{V},{h}]@[{h},{h}], all active", rand(B, V, h),
             rand(B, V, h, scale=0.05), rand(B, h, h, scale=h ** -0.5), None),
            (f"x{B} [{V},{h}]@[{h},{h}], {int(half.sum())} active",
             rand(B, V, h), rand(B, V, h, scale=0.05),
             rand(B, h, h, scale=h ** -0.5), half),
            (f"x{STAGES} [{V},{h}]@[{h},{h}], all active (ring)",
             rand(STAGES, V, h), rand(STAGES, V, h, scale=0.05),
             rand(STAGES, h, h, scale=h ** -0.5), None),
            (f"[{V},{h}]@[{h},{C}]", rand(V, C), rand(V, h, scale=0.05),
             rand(h, C, scale=h ** -0.5), None)):
        lib = ((lambda r0=r0, d=d, W=W: torch.addmm(r0, d, W, alpha=-1))
               if d.dim() == 2 else
               (lambda r0=r0, d=d, W=W: torch.baddbmm(r0, d, W, alpha=-1)))
        nb = d.shape[0] if d.dim() == 3 else 1
        n_act = nb if active is None else int(active.sum())
        M, K = d.shape[-2:]
        N = W.shape[-1]
        bt.append(matmul_case(
            name, lambda r0=r0, d=d, W=W, a=active: backtrack_resnorm(r0, d, W, a),
            lambda r0=r0, d=d, W=W, a=active: ref.backtrack_resnorm_ref(r0, d, W, a),
            lib, 4 * (n_act * (M * N + M * K + K * N) + nb),
            n_act * 2 * M * K * N, n_act * 3 * M * N, resnorm_check,
            resnorm_route(N)))
    rows["backtrack_resnorm"] = bt

    def grid_input(*shape):
        # the p-update's candidates: mostly inside [lo, hi], some clipped
        return (torch.rand(shape, generator=gen, device=dev) * 9.0 - 2.5
                + rand(*shape, scale=0.01))

    print("grid_project:", flush=True)
    gp = []
    for shape in ((B, V, h), (V, h), (STAGES, V, h)):
        x = grid_input(*shape)
        n = x.numel()
        gp.append(case(
            "[" + ",".join(map(str, shape)) + "]",
            lambda x=x: qk.grid_project(x, grid),
            lambda x=x: ref.grid_project_ref(x, grid), None, 8 * n, 5 * n,
            bitwise_check))
    rows["grid_project"] = gp

    print("grid_encode / grid_decode:", flush=True)
    from repro_torch.core.quantize import uniform_grid
    enc, dec = [], []
    # the G-Q ring encodes every stage's boundary slab at once
    for bits, shape in ((8, (V, h)), (16, (V, h)), (8, (1, STAGES, 1, V, h))):
        g = uniform_grid(bits, grid.lo, grid.hi)
        x = grid_input(*shape)
        n = x.numel()
        codes = ref.grid_encode_ref(x, g)
        cb = codes.element_size()
        label = "[" + ",".join(map(str, shape)) + f"] {bits}-bit"
        enc.append(case(
            label, lambda x=x, g=g: qk.grid_encode(x, g),
            lambda x=x, g=g: ref.grid_encode_ref(x, g), None, (4 + cb) * n,
            4 * n, bitwise_check))
        dec.append(case(
            label, lambda c=codes, g=g: qk.grid_decode(c, g),
            lambda c=codes, g=g: ref.grid_decode_ref(c, g), None,
            (4 + cb) * n, 2 * n, bitwise_check))
    rows["grid_encode"], rows["grid_decode"] = enc, dec

    rows["pack_codes"], rows["unpack_codes"] = pack_rows(gen, V * h,
                                                         floor_ms)
    for name, cases in sel_rows(gen, V * h, floor_ms).items():
        rows[name] += cases
    rows["flash_attention"] = flash_cases(dev)
    return rows


def block_rel_l2(got, want):
    """Relative L2 distance over each block of FLASH_BLOCK query positions
    (all batches, heads and columns of [B, S, H, D]); a ragged tail joins
    the block before it."""
    d = (got.float() - want.float()).square().sum(dim=(0, 2, 3))
    w = want.float().square().sum(dim=(0, 2, 3))
    n = max(d.numel() // FLASH_BLOCK, 1)
    blk = (torch.arange(d.numel(), device=d.device)
           // FLASH_BLOCK).clamp(max=n - 1)
    zero = torch.zeros(n, device=d.device)
    return (zero.index_add(0, blk, d) / zero.index_add(0, blk, w)).sqrt()


def flash_readings(got, want, want_p_bf16=None) -> dict:
    """How far ``got`` lies from ``want`` (the plain version with f32 P):
    the relative L2 error and the largest ratio of |got − want| to the JAX
    test's ``assert_allclose`` bound (|got − want| ≤ tol + tol·|want|;
    above 1 breaks it). bf16: also the same distances of ``want_p_bf16``
    (the plain version with bf16 P) and the ratios of got's to them, over
    the whole output and the largest over blocks of query positions."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    tol = FLASH_TOL[want.dtype]
    r = {"rel_l2": float((g - w).norm() / w.norm()),
         "jax_tol_ratio": float((d / (tol + tol * w.abs())).max())}
    if want_p_bf16 is not None:
        pb = want_p_bf16.float()
        r["plain_p_bf16_rel_l2"] = float((pb - w).norm() / w.norm())
        r["ratio"] = r["rel_l2"] / r["plain_p_bf16_rel_l2"]
        r["block_ratio"] = float((block_rel_l2(got, want)
                                  / block_rel_l2(want_p_bf16, want)).max())
    return r


def flash_breaks(r: dict, dtype) -> list:
    """The bounds ``r`` breaks: the JAX test's rtol = atol (1e-4 f32, 3e-2
    bf16); bf16 also FLASH_BF16_FACTOR on both distance ratios."""
    out = ([f"|Δ| at {r['jax_tol_ratio']:.3g}× rtol = atol = "
            f"{FLASH_TOL[dtype]}"] if not r["jax_tol_ratio"] <= 1 else [])
    if dtype == torch.bfloat16:
        out += [f"{key} {r[key]:.3f} > {FLASH_BF16_FACTOR}"
                for key in ("ratio", "block_ratio")
                if not r[key] <= FLASH_BF16_FACTOR]
    return out


def flash_print(label, r):
    extra = ("" if "ratio" not in r else
             f", bf16-P plain {r['plain_p_bf16_rel_l2']:.3e}, ratio "
             f"{r['ratio']:.3f}, largest block ratio {r['block_ratio']:.3f}")
    print(f"    {label}relative L2 {r['rel_l2']:.3e}{extra}, |Δ| / JAX "
          f"tolerance {r['jax_tol_ratio']:.4f}", flush=True)


def flash_check_for(want_f32p):
    """bf16: ``case``'s plain version is the bf16-P one and ``want_f32p``
    the f32-P one; f32: ``want_f32p`` is None and the plain version is the
    reference."""
    def check(got, want, err):
        r = (flash_readings(got, want) if want_f32p is None
             else flash_readings(got, want_f32p, want))
        flash_print("", r)
        broken = flash_breaks(r, want.dtype)
        if broken:
            raise AssertionError(f"flash_attention (max abs err {err:.3e}): "
                                 + "; ".join(broken))
        return r
    return check


def flash_controls(q, k, v, causal, want, want_p_bf16) -> dict:
    """Wrong attentions that the check must refuse: the kernel's output 10%
    off, the kernel without the last 64-key tile, and (causal cases) the
    kernel without its mask."""
    from repro_torch.kernels.flash_attention import flash_attention
    good = flash_attention(q, k, v, causal=causal)
    wrong = {"output x1.1": (good.float() * 1.1).to(good.dtype),
             "last key tile dropped": flash_attention(
                 q, k[:, :-64], v[:, :-64], causal=causal)}
    del good
    if causal:
        wrong["mask off"] = flash_attention(q, k, v, causal=False)
    out = {}
    for name, got in wrong.items():
        r = flash_readings(got, want, want_p_bf16)
        out[name] = r
        flash_print(f"control '{name}': ", r)
        if not flash_breaks(r, want.dtype):
            raise AssertionError(f"flash_attention: the check passes the "
                                 f"control '{name}'")
    return out


def flash_cases(dev):
    """flash_attention against its plain versions at the prefill's
    per-layer shape (tinyllama: Hq 32, Hkv 4, D 64), causal and not, one
    long row, phi-3-mini's and granite-8b's heads, the per-layer prefills
    of granite-moe (Hq 24, Hkv 8, D 64: G 3), qwen3-moe (64, 4, 128: G 16),
    qwen2-vl (28, 4, 128: G 7) and jamba (32, 8, 128: G 4, NoPE), whisper's
    encoder (S = T = 1500, not a multiple of the 64-key tile, full; H 6, G
    1, D 64), its cross-attention (448 queries on 1500 keys, full) and its
    decoder's self-attention (448, causal), and f32, each with controls the
    check must refuse. The bound counts the (query, key) pairs the mask
    keeps. bf16's plain version (timed as ``plain_ms``) rounds P to bf16
    like the kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    print("flash_attention:", flush=True)
    out = []
    P, W = LM_PROMPT, WHISPER_FRAMES
    for B, S, T, Hq, Hkv, D, dtype, causal, iters in (
            (LM_BATCH, P, P, 32, 4, 64, bf16, True, 20),
            (LM_BATCH, P, P, 32, 4, 64, bf16, False, 20),
            (1, LONG_ROW, LONG_ROW, 32, 4, 64, bf16, True, 5),
            (1, 2048, 2048, 32, 32, 96, bf16, True, 20),      # phi-3-mini
            (1, 2048, 2048, 32, 8, 128, bf16, True, 20),      # granite-8b
            # the per-layer prefill of lm_family_phase's three configs
            (LM_BATCH, P, P, 24, 8, 64, bf16, True, 20),      # granite-moe
            (LM_BATCH, P, P, 64, 4, 128, bf16, True, 20),     # qwen3-moe
            (LM_BATCH, P, P, 28, 4, 128, bf16, True, 20),     # qwen2-vl
            # lm_seq_phase's: jamba's attention, whisper's three
            (LM_BATCH, P, P, 32, 8, 128, bf16, True, 20),     # jamba
            (LM_BATCH, W, W, 6, 6, 64, bf16, False, 20),      # encoder
            (LM_BATCH, WHISPER_TEXT, W, 6, 6, 64, bf16, False, 20),  # cross
            (LM_BATCH, WHISPER_TEXT, WHISPER_TEXT, 6, 6, 64, bf16, True,
             20),                                              # decoder self
            (1, 512, 512, 32, 4, 64, torch.float32, True, 20)):
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
        pairs = S * (S + 1) // 2 if causal else S * T   # causal: S == T
        n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        p_dtype = bf16 if dtype == bf16 else None
        name = (f"B{B} {f'S=T={S}' if S == T else f'S={S} T={T}'} Hq{Hq} "
                f"Hkv{Hkv} D{D} {str(dtype).split('.')[-1]} "
                f"{'causal' if causal else 'full'}")
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        row = case(
            name,
            lambda q=q, k=k, v=v, c=causal: flash_attention(q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal, pd=p_dtype:
                ref.flash_attention_ref(q, k, v, causal=c, p_dtype=pd),
            lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=c, enable_gqa=True),
            n_bytes, 4 * B * Hq * D * pairs,
            flash_check_for(want if dtype == bf16 else None), peak, iters)
        row["controls"] = flash_controls(
            q, k, v, causal, want,
            ref.flash_attention_ref(q, k, v, causal=causal, p_dtype=bf16)
            if dtype == bf16 else None)
        out.append(row)
        del q, k, v, want
    return out


def p_trials(tau_prev, tau_new):
    """Backtracking trials per p-update that ran the resnorm on this layer:
    τ = τ0·2^j with τ0 = τ_prev·decay + 1e-6 in f32 (the driver's warm
    start), and the trial that passed ran too, so min(j + 1, 12)."""
    t0 = np.float32(np.float32(tau_prev) * np.float32(0.5) + np.float32(1e-6))
    j = int(round(math.log2(float(np.float32(tau_new) / t0))))
    return min(j + 1, MAX_DOUBLINGS)


def accept_margin(state, args, cfg, layer: int, t: float) -> float:
    """(φ(x⁺) − U − 1e-6|U|) / |U| for ``layer``'s p-update at trial τ = t,
    in f64 with plain tensor code: where it is near 0 the accept test is
    on its 1e-6 slack and two correct sums may decide either way."""
    from repro_torch.core import subproblems as sp
    f = [x.double() for x in (state.p[layer], state.W[layer], state.b[layer],
                              state.z[layer], state.q[layer - 1],
                              state.u[layer - 1])]
    p, W, b, z, qp, up = f
    nu, rho = cfg.nu, cfg.rho
    g = sp.grad_p(p, W, b, z, qp, up, nu, rho)
    phi0 = sp.phi(p, W, b, z, qp, up, nu, rho)
    x = p - g / t
    if cfg.quantize_p and cfg.grid is not None:
        x = cfg.grid.project(x.float()).double()
    d = x - p
    u_val = phi0 + sp._dot(g, d) + 0.5 * t * sp._dot(d, d)
    phi_x = sp.phi(x, W, b, z, qp, up, nu, rho)
    return float((phi_x - u_val - 1e-6 * u_val.abs()) / u_val.abs())


def train_run(X, ds, dims, cfg, epochs):
    """``pdadmm.train`` from seed 0 by the eager loop (``jit=False``, where
    the tree has the switch: the wrappers count every launch as it is
    made); for G-Q with a per-epoch callback that keeps τ. Returns (state,
    history, τ per iteration [epochs][L] or [], seconds)."""
    import inspect
    from repro_torch.core import pdadmm
    taus = []
    keep_tau = None
    if cfg.quantize_p:
        def keep_tau(e, s, m):
            taus.append([float(t) for t in s.tau])
    eager = ({"jit": False} if "jit" in inspect.signature(
        pdadmm.train).parameters else {})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = pdadmm.train(0, X, ds.labels, ds.masks, dims, cfg, epochs,
                               device=X.device, callback=keep_tau, **eager)
    torch.cuda.synchronize()
    return state, hist, taus, time.perf_counter() - t0


def ms_per_iter(X, ds, config, state, n=5, **kw):
    from repro_torch.core import pdadmm
    args = (X, ds.labels, ds.masks["train"])
    state, _ = pdadmm.iterate(state, *args, config, **kw)      # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        state, m = pdadmm.iterate(state, *args, config, **kw)
    float(m["objective"])
    return (time.perf_counter() - t) / n * 1e3


def hold_step(s, args, cfg, it, flips):
    """One iteration of both paths from the shared state ``s``: the
    objective at rtol 1e-3 where τ agree on every layer, each τ flip
    appended to ``flips`` with its accept-test margin. Returns (the kernel
    path's new state, whether the objective was held)."""
    from repro_torch.core import pdadmm
    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    sk, mk = pdadmm.iterate(s, *args, cfg)
    sp_, mp = pdadmm.iterate(s, *args, cfg_plain)
    tk = [float(t) for t in sk.tau]
    tp = [float(t) for t in sp_.tau]
    ok, op = float(mk["objective"]), float(mp["objective"])
    differ = [l for l in range(1, len(tk)) if tk[l] != tp[l]]
    for l in differ:
        margin = accept_margin(s, args, cfg, l, min(tk[l], tp[l]))
        flips.append({"iteration": it, "layer": l, "tau_kernels": tk[l],
                      "tau_plain": tp[l], "margin": margin})
        print(f"  τ flip: iteration {it} layer {l}: kernels {tk[l]:.6g} "
              f"plain {tp[l]:.6g}; (φ−U−slack)/|U| at the smaller τ "
              f"{margin:.3e}", flush=True)
    if not math.isfinite(ok) or not math.isfinite(op):
        raise AssertionError(f"objective not finite at {it}: {ok}, {op}")
    if not differ:
        np.testing.assert_allclose(ok, op, rtol=TRAJ_RTOL)
    return sk, not differ


def stepwise_check(X, ds, dims, cfg, epochs):
    """Both paths from one shared state (the kernel path's), one iteration
    at a time (``hold_step``)."""
    from repro_torch.core import pdadmm
    args = (X, ds.labels, ds.masks["train"])
    s = pdadmm.init_state(0, X, dims, cfg, device=X.device)
    flips, held = [], 0
    for it in range(epochs):
        s, ok = hold_step(s, args, cfg, it, flips)
        held += ok
    return {"flips": flips, "iterations_held": held}


def train_phase(X, ds, dims, cfg, epochs, required, label):
    """Train ``epochs`` iterations through the kernels with every launch
    count set to 0 just before, and again on the plain path; check the
    launches of ``required``, finiteness and the trajectory."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    state, hist, taus, t_train = train_run(X, ds, dims, cfg, epochs)
    counts = ops.launch_counts()
    print(f"{label}: {epochs} iterations in {t_train:.3f} s, launches "
          f"{counts}", flush=True)
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: "
                             f"{missing}")
    obj = np.asarray(hist["objective"])
    if obj.shape != (epochs,) or not np.all(np.isfinite(obj)):
        raise AssertionError(f"{label}: objective not finite: {obj}")

    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    _, hist_plain, taus_plain, _ = train_run(X, ds, dims, cfg_plain, epochs)
    obj_plain = np.asarray(hist_plain["objective"])
    print(f"  objective kernels {obj.tolist()}", flush=True)
    print(f"  objective plain   {obj_plain.tolist()}", flush=True)
    run = {"launches": counts, "objective": obj.tolist(),
           "objective_plain": obj_plain.tolist(),
           "test_acc": hist["test_acc"][-1], "val_acc": hist["val_acc"][-1],
           "test_acc_plain": hist_plain["test_acc"][-1], "train_s": t_train}
    if cfg.quantize_p:
        L = len(dims) - 1
        tau0 = [cfg.tau0] * L
        trials = [[p_trials(prev[l], cur[l]) for l in range(1, L)]
                  for prev, cur in zip([tau0] + taus[:-1], taus)]
        differ = [(it, l) for it in range(epochs) for l in range(1, L)
                  if taus[it][l] != taus_plain[it][l]]
        for it in range(epochs):
            print(f"  iteration {it}: τ kernels {taus[it][1:]}", flush=True)
            print(f"               τ plain   {taus_plain[it][1:]}")
            print(f"               active trials per p-update (layers 1.."
                  f"{L - 1}) {trials[it]}")
        print(f"  τ differs between the paths at {len(differ)} of "
              f"{epochs * (L - 1)} (iteration, layer): {differ}", flush=True)
        run.update(tau=taus, tau_plain=taus_plain, active_trials=trials,
                   tau_differs=differ)
    try:
        np.testing.assert_allclose(obj, obj_plain, rtol=TRAJ_RTOL)
        run["trajectory_check"] = f"rtol {TRAJ_RTOL} over {epochs} iterations"
    except AssertionError:
        if not run.get("tau_differs"):
            raise
        print(f"  the trajectories part beyond rtol {TRAJ_RTOL} after a τ "
              f"flip; holding both paths from one shared state instead",
              flush=True)
        run["stepwise"] = stepwise_check(X, ds, dims, cfg, epochs)
        run["trajectory_check"] = "stepwise from shared states"
    # in turns, so that a change in the host's speed falls on both paths
    samples = {True: [], False: []}
    for kernels in (True, False, False, True, True, False):
        samples[kernels].append(ms_per_iter(
            X, ds, cfg if kernels else cfg_plain, state))
    run["ms_per_iter"] = float(np.median(samples[True]))
    run["ms_per_iter_plain"] = float(np.median(samples[False]))
    run["ms_per_iter_samples"] = samples[True]
    run["ms_per_iter_plain_samples"] = samples[False]
    print(f"  ms per iteration in turns: kernels {samples[True]}, plain "
          f"{samples[False]}", flush=True)
    return state, run


def wire_phase(X, ds, cfg, state, n_iters: int = 2):
    """G-Q iterations with 8-bit grid codecs on every dual's wire, from
    ``state``; grid_encode and grid_decode must launch."""
    from repro_torch.comm.codecs import GridCodec
    from repro_torch.core import pdadmm
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.kernels import ops

    codecs = (GridCodec(uniform_grid(8, -1.0, 1.0)),) * (len(state.u))
    args = (X, ds.labels, ds.masks["train"])
    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    ops.reset_launch_counts()
    s, objs = state, []
    for _ in range(n_iters):
        s, m = pdadmm.iterate(s, *args, cfg, u_codecs=codecs)
        objs.append(float(m["objective"]))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"u wire (8-bit grid codecs): {n_iters} iterations, launches "
          f"{counts}, objective {objs}", flush=True)
    missing = [k for k in WIRE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"u wire: kernels never launched: {missing}")
    if not all(math.isfinite(o) for o in objs):
        raise AssertionError(f"u wire: objective not finite: {objs}")
    _, m_plain = pdadmm.iterate(state, *args, cfg_plain, u_codecs=codecs)
    _, m_kern = pdadmm.iterate(state, *args, cfg, u_codecs=codecs)
    np.testing.assert_allclose(float(m_kern["objective"]),
                               float(m_plain["objective"]), rtol=TRAJ_RTOL)
    return {"launches": counts, "objective": objs, "iterations": n_iters,
            "ms_per_iter": ms_per_iter(X, ds, cfg, state, n=3,
                                       u_codecs=codecs)}


def kernel_group(name: str) -> str:
    """The group of a device kernel, by its name: the port's kernels;
    cuBLAS products in bf16 (Hopper's ``nvjet`` kernels; TF32 is off, so
    no f32 product takes them) and in f32 (SIMT ``xmma`` FFMA kernels, e.g.
    the plain attention's scores); softmax and its backward; copies and
    casts; other elementwise kernels; reductions; the rest."""
    if any(k in name for k in PORT_KERNEL_NAMES):
        return "port kernels"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return ("GEMM bf16" if "bf16" in low or "nvjet" in low
                else "GEMM f32")
    for key, group in (("softmax", "softmax"), ("copy", "copies and casts"),
                       ("reduce", "reductions"),
                       ("elementwise", "other elementwise")):
        if key in low:
            return group
    return "other"


def profile_phase(label, run_once, ms_per_iter: float, top: int = 12):
    """Device time by kernel over one iteration, ``run_once()``
    (torch.profiler): the ``top`` largest and every kernel of the port
    beyond them, and the device ms of each ``kernel_group`` over all
    kernels; and the device's idle share of an unprofiled iteration
    (1 − busy / ``ms_per_iter``).

    CUPTI now and then hands a trace back with no device event at all.
    Such a trace is taken again, up to PROFILE_TRIES times; if every one
    is empty, one iteration is timed with CUDA events instead
    (``device_span_ms``: the device's span from the first launch to the
    last, busy or not), and the busy time, idle share and kernels are
    None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_once()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_once()
            torch.cuda.synchronize()
        # device-side events only: a CPU op's entry repeats its kernels' time
        events = sorted((ev for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA
                         and ev.self_device_time_total > 0),
                        key=lambda ev: -ev.self_device_time_total)
        if events:
            break
        print(f"profile ({label}): trace {attempt + 1} of {PROFILE_TRIES} "
              f"recorded no device time", flush=True)
    else:
        return events_span(label, run_once, ms_per_iter)
    rows = [{"name": ev.key[:90], "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3} for ev in events]
    busy = sum(r["device_ms"] for r in rows)
    launches = sum(r["calls"] for r in rows)
    print(f"profile ({label}, one iteration): device busy {busy:.3f} ms in "
          f"{launches} launches; idle share of a {ms_per_iter:.3f} ms "
          f"iteration {1.0 - busy / ms_per_iter:.3f}", flush=True)
    port = [r for r, ev in zip(rows[top:], events[top:])
            if any(k in ev.key for k in PORT_KERNEL_NAMES)]
    for r in rows[:top] + port:
        print(f"  {r['device_ms']:8.3f} ms  x{r['calls']:<4d} {r['name']}")
    groups = {}
    for r, ev in zip(rows, events):
        g = groups.setdefault(kernel_group(ev.key), {"device_ms": 0.0,
                                                     "calls": 0})
        g["device_ms"] += r["device_ms"]
        g["calls"] += r["calls"]
    print("  by group: " + "; ".join(
        f"{name} {g['device_ms']:.3f} ms ({g['device_ms'] / busy:.3f}), "
        f"x{g['calls']}" for name, g in sorted(
            groups.items(), key=lambda kv: -kv[1]["device_ms"])), flush=True)
    return {"device_busy_ms": busy, "device_launches": launches,
            "idle_share": 1.0 - busy / ms_per_iter,
            "kernels": rows[:top] + port, "groups": groups,
            "source": "torch.profiler"}


def launch_ms_by_kernel(label, run_once, names) -> dict:
    """Device ms of every launch of each kernel in ``names`` over one
    ``run_once()`` under torch.profiler, in launch order, printed: {name:
    [ms, ...]}. A name matches a trace's kernel where it starts a word
    (``pack4_kernel`` is not ``unpack4_kernel``). A trace with no device
    event is taken again, up to PROFILE_TRIES times; after that every list
    is empty (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kernels = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_once()
            torch.cuda.synchronize()
        kernels = sorted((ev for ev in prof.events()
                          if ev.device_type == DeviceType.CUDA
                          and ev.self_device_time_total > 0),
                         key=lambda ev: ev.time_range.start)
        if kernels:
            break
        print(f"profile ({label}): trace {attempt + 1} of {PROFILE_TRIES} "
              f"recorded no device time", flush=True)
    out = {}
    for name in names:
        word = re.compile(r"(?<![A-Za-z0-9_])" + name + r"\b")
        out[name] = [ev.self_device_time_total / 1e3 for ev in kernels
                     if word.search(ev.name)]
        print(f"  {label}: {name} device ms a launch, in launch order: "
              + ", ".join(f"{x:.4f}" for x in out[name]), flush=True)
    return out


def events_span(label, run_once, ms_per_iter: float) -> dict:
    """profile_phase's stand-in when the profiler records no device time:
    one iteration between two CUDA events. The span must be positive, or
    nothing ran on the device."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run_once()
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    print(f"profile ({label}, one iteration): the profiler recorded no "
          f"device time in {PROFILE_TRIES} traces; CUDA events: device span "
          f"{span:.3f} ms of a {ms_per_iter:.3f} ms iteration (busy time, "
          f"idle share and kernels not measured)", flush=True)
    if not span > 0:
        raise AssertionError(f"{label}: no device time by profiler or events")
    return {"device_busy_ms": None, "device_launches": None,
            "idle_share": None, "kernels": [], "groups": {},
            "device_span_ms": span, "source": "cuda events"}


def iterate_once(X, ds, cfg, state):
    """One ``pdadmm.iterate`` from ``state`` (a closure for profile_phase),
    which advances the state it holds."""
    from repro_torch.core import pdadmm
    held = [state]
    args = (X, ds.labels, ds.masks["train"])

    def run():
        held[0], _ = pdadmm.iterate(held[0], *args, cfg)
    return run


def ring_problem(X, ds, dev):
    """The ring's input: Xp = relu(X @ P0), P0 a seeded [K·d, 1000]
    projection (the reference's homogenisation)."""
    g = torch.Generator(device=dev).manual_seed(0)
    P0 = torch.randn((X.shape[1], 1000), generator=g, device=dev) \
        * float(np.sqrt(2.0 / X.shape[1]))
    return torch.relu(X @ P0)


def ring_ms_per_iter(mesh, L, C, cfg, init, data, n=5, overlap=False,
                     wire=None, widths=None):
    """Steady-state ms per ring iteration (host clock around ``n`` steps
    ending in a device sync), from the shard layout of ``init``; returns
    (ms, step, carry after the run). With a padded ``wire`` the step runs
    at the ``widths`` table."""
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing
    ring = LocalRing(mesh, init.p.device)
    step, _ = SP.make_distributed_step(mesh, L, C, cfg, overlap=overlap,
                                       wire=wire, ring=ring)
    carry = SP.shard_stack(init, ring)
    if wire is not None:
        data = tuple(data) + (widths,)
    if overlap:
        carry = (carry, SP.make_overlap_primer(
            mesh, SP.codec_for_grid(cfg.grid if cfg.quantize_q else None),
            wire=wire, ring=ring)(carry.q, carry.u, *data[3:]))
    carry, _ = step(carry, *data)                              # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        carry, m = step(carry, *data)
    float(m["objective"])
    return (time.perf_counter() - t) / n * 1e3, step, carry


def ring_peak_mib(mesh, L, C, cfg, init, data) -> dict:
    """Peak device memory of one ring step without and with
    ``donate=True``: ``max_memory_allocated`` with the peak counter reset
    just before each step, absolute and above what was allocated before
    it (MiB). Gate: the donated peak is lower."""
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing
    ring = LocalRing(mesh, init.p.device)
    out = {}
    for donate in (False, True):
        step, _ = SP.make_distributed_step(mesh, L, C, cfg, donate=donate,
                                           ring=ring)
        # a copy: at data 1 the shard layout may share init's storage
        st = SP.StackState(*(x.clone() for x in SP.shard_stack(init, ring)))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st, m = step(st, *data)
        float(m["objective"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["donate" if donate else "plain"] = {
            "peak_mib": peak / 2 ** 20, "above_mib": (peak - base) / 2 ** 20,
            "base_mib": base / 2 ** 20}
        del st, m
    if not out["donate"]["peak_mib"] < out["plain"]["peak_mib"]:
        raise AssertionError(f"the donated step's peak is not lower: {out}")
    return out


def dist_phase(X, ds, cfg, cfg_q, epochs):
    """The stage-parallel runtime on a LocalRing of mesh (1, 10): G and
    G-Q through ``distributed_train``, the mixed-width wire, and the
    quantized psum (see the module docstring, phase 6)."""
    from repro_torch.comm.codecs import FP32, AffineCodec, GridCodec
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig,
                                             stage_ring_edges)
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.comm.transport import quantized_psum
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.kernels import ops
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    dev = X.device
    Xp = ring_problem(X, ds, dev)
    V, h = Xp.shape
    L, C = STAGES, ds.n_classes
    mesh = StageMesh(1, STAGES)
    args = (Xp, ds.labels, ds.masks)
    out = {}
    print(f"ring: mesh (data 1, model {STAGES}), Xp {tuple(Xp.shape)}, "
          f"L={L}, C={C}", flush=True)
    for name, c, required in (("G_ring", cfg, BASE_KERNELS),
                              ("GQ_ring", cfg_q, GQ_KERNELS)):
        init = SP.init_stack(0, Xp, L, c)
        led = CommLedger()
        ring = LocalRing(mesh, dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, hist = SP.distributed_train(mesh, None, *args, L, C, c, epochs,
                                        ledger=led, init=init, ring=ring,
                                        jit=False)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"{name}: {epochs} iterations in {t_train:.3f} s, launches "
              f"{counts}", flush=True)
        missing = [k for k in required if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: {missing}")
        obj = np.asarray(hist["objective"])
        if obj.shape != (epochs,) or not np.all(np.isfinite(obj)):
            raise AssertionError(f"{name}: objective not finite: {obj}")
        c_plain = dataclasses.replace(c, use_kernels=False)
        _, h_plain = SP.distributed_train(mesh, None, *args, L, C, c_plain,
                                          epochs, init=init, jit=False)
        st_ov, h_ov = SP.distributed_train(mesh, None, *args, L, C, c,
                                           epochs, init=init, overlap=True,
                                           jit=False)
        print(f"  objective kernels {obj.tolist()}", flush=True)
        print(f"  objective plain   {h_plain['objective']}", flush=True)
        np.testing.assert_allclose(obj, h_plain["objective"], rtol=TRAJ_RTOL)
        if h_ov["objective"] != hist["objective"] or not all(
                torch.equal(a, b) for a, b in zip(st, st_ov)):
            raise AssertionError(f"{name}: overlap=True differs from "
                                 "overlap=False")
        pc = GridCodec(c.grid) if c.quantize_p else FP32
        wb = SP.wire_bytes_per_iteration(mesh, L, V, h, pc, pc)
        per_iter = wb["q_fwd"] + wb["u_fwd"] + wb["p_bwd"]
        ledger_iters = led.per_iteration()
        if sorted(ledger_iters) != list(range(epochs)) or set(
                ledger_iters.values()) != {per_iter}:
            raise AssertionError(f"{name}: ledger {ledger_iters} != "
                                 f"{per_iter} bytes per iteration")
        # what the shifts moved, counted from the payload tensors
        if ring.shifted_bytes != led.total_wire_bytes():
            raise AssertionError(f"{name}: the ring's shifts moved "
                                 f"{ring.shifted_bytes} B, the ledger says "
                                 f"{led.total_wire_bytes()} B")
        data = [LocalRing(mesh, dev).to_local(x, "rows")
                for x in (Xp, ds.labels, ds.masks["train"])]
        peak = ring_peak_mib(mesh, L, C, c, init, data)
        ms, step, st_s = ring_ms_per_iter(mesh, L, C, c, init, data)
        ms_plain = ring_ms_per_iter(mesh, L, C, c_plain, init, data)[0]
        ms_overlap = ring_ms_per_iter(mesh, L, C, c, init, data,
                                      overlap=True)[0]
        held = [st_s]

        def run_once(step=step, held=held, data=data):
            held[0], _ = step(held[0], *data)
        prof = profile_phase(name, run_once, ms)
        print(f"  ms per iteration: kernels {ms:.3f}  plain {ms_plain:.3f}  "
              f"kernels with overlap {ms_overlap:.3f}; ledger bytes per "
              f"iteration {per_iter} = bytes the shifts moved "
              f"{ring.shifted_bytes // epochs}; peak MiB above the state "
              f"in one step: plain {peak['plain']['above_mib']}, donated "
              f"{peak['donate']['above_mib']}", flush=True)
        out[name] = {"launches": counts, "iterations": epochs,
                     "objective": obj.tolist(),
                     "objective_plain": h_plain["objective"],
                     "overlap_bitwise": True, "train_s": t_train,
                     "ms_per_iter": ms, "ms_per_iter_plain": ms_plain,
                     "ms_per_iter_overlap": ms_overlap,
                     "wire_bytes_per_iter": per_iter,
                     "shifted_bytes": ring.shifted_bytes,
                     "step_peak_mib": peak, "profile": prof}

    # the mixed-width padded wire: one step, a width per boundary
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    ctl = BitWidthController(stage_ring_edges(STAGES, V, h),
                             ControllerConfig(**MIXED_CONTROLLER))
    led = CommLedger()
    init = SP.init_stack(0, Xp, L, cfg)
    ring = LocalRing(mesh, dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                   controller=ctl, grids_by_bits=grids,
                                   ledger=led, mixed_width=True, init=init,
                                   ring=ring, jit=False)
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"mixed width: {epochs} iterations in {t_mixed:.3f} s, steps "
          f"built {hist['n_compiled_steps']}, launches {counts}", flush=True)
    for e, sched in enumerate(hist["schedules"]):
        print(f"  iteration {e}: widths per boundary {list(sched)}")
    if hist["n_compiled_steps"] != 1:
        raise AssertionError("mixed width built more than one step")
    missing = [k for k in PACK_KERNELS + BASE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"mixed width: kernels never launched: "
                             f"{missing}")
    # a predicated launch per width of the wire, whatever the schedule
    plan = SP.step_program_plan(mesh, L, C, cfg, V=V, h=h, ring=ring,
                                wire=SP.PaddedWire.from_grids(grids))
    want = {k: epochs * v for k, v in plan.pallas_calls.items()}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"mixed width: launches {counts}, the plan's "
                             f"{want} (a launch a width per iteration)")
    if not all(math.isfinite(o) for o in hist["objective"]):
        raise AssertionError(f"mixed width: objective not finite: "
                             f"{hist['objective']}")
    s = led.summary()
    print(f"  objective {hist['objective']}; ledger {s['total_bytes']} "
          f"logical B vs {s['wire_bytes']} physical B; the shifts moved "
          f"{ring.shifted_bytes} B", flush=True)
    if ring.shifted_bytes != s["wire_bytes"]:
        raise AssertionError(f"mixed width: the ring's shifts moved "
                             f"{ring.shifted_bytes} B, the ledger says "
                             f"{s['wire_bytes']} physical B")
    ctl_plain = BitWidthController(stage_ring_edges(STAGES, V, h),
                                   ControllerConfig(**MIXED_CONTROLLER))
    _, h_plain = SP.distributed_train(
        mesh, None, *args, L, C, dataclasses.replace(cfg, use_kernels=False),
        epochs, controller=ctl_plain, grids_by_bits=grids, mixed_width=True,
        init=init, jit=False)
    print(f"  objective plain   {h_plain['objective']}; schedules "
          f"{'equal' if h_plain['schedules'] == hist['schedules'] else 'differ'}",
          flush=True)
    np.testing.assert_allclose(hist["objective"], h_plain["objective"],
                               rtol=TRAJ_RTOL)

    # the same iterations again under the profiler: each pack and unpack
    # launch's device ms with its inputs where the step leaves them (one
    # predicated launch a packed width and direction, its rows those of the
    # stages the schedule puts at that width, none at times)
    def mixed_run():
        ctl_prof = BitWidthController(stage_ring_edges(STAGES, V, h),
                                      ControllerConfig(**MIXED_CONTROLLER))
        SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                             controller=ctl_prof, grids_by_bits=grids,
                             mixed_width=True, init=init, jit=False)
    per_launch = launch_ms_by_kernel("mixed width", mixed_run,
                                     PACK_DEVICE_KERNELS)
    out["mixed"] = {"launches": counts, "iterations": epochs,
                    "schedules": [list(x) for x in hist["schedules"]],
                    "objective": hist["objective"],
                    "objective_plain": h_plain["objective"],
                    "train_s": t_mixed, "device_ms_by_launch": per_launch,
                    "logical_bytes": s["total_bytes"],
                    "physical_bytes": s["wire_bytes"],
                    "shifted_bytes": ring.shifted_bytes}

    # quantized psum over data 4: gather and code_psum, the same bits
    ring = LocalRing(StageMesh(4, 1), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4, 1, V, h), generator=g, device=dev)
    psum = {}
    for label, codec in (("affine4", AffineCodec(4)),
                         ("grid4", GridCodec(uniform_grid(4, -3.0, 3.0)))):
        a = quantized_psum(x, ring, "data", codec, mode="gather")
        b = quantized_psum(x, ring, "data", codec, mode="code_psum")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"quantized_psum {label}: gather != "
                                 "code_psum")
        err = float((a[0] - x.sum(0)).abs().max())
        psum[label] = {"bitwise": True, "max_abs_err_vs_exact": err}
        print(f"quantized_psum {label} over data 4, [{V},{h}] shards: "
              f"gather == code_psum bitwise; max |sum − exact| {err:.4f}",
              flush=True)
    out["psum"] = psum
    return out


def replay_launches(mesh, L, C, cfg, init, data, overlap=False, wire=None,
                    widths=None) -> dict:
    """Launches of ONE real ring step on the card (the counts set to 0
    after the step is built and its carry primed)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing
    ring = LocalRing(mesh, init.p.device)
    step, _ = SP.make_distributed_step(mesh, L, C, cfg, overlap=overlap,
                                       wire=wire, ring=ring)
    carry = SP.shard_stack(init, ring)
    args = tuple(data) + ((widths,) if wire is not None else ())
    if overlap:
        carry = (carry, SP.make_overlap_primer(
            mesh, SP.codec_for_grid(cfg.grid if cfg.quantize_q else None),
            wire=wire, ring=ring)(carry.q, carry.u, *args[3:]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    step(carry, *args)
    torch.cuda.synchronize()
    return {k: v for k, v in ops.launch_counts().items() if v}


def ledger_iteration_bytes(led) -> dict:
    """Physical bytes per edge of iteration 0 (per-stage records summed)."""
    out = {}
    for edge, b in led.per_edge_iteration_wire(0).items():
        base = edge.split("/")[0]
        out[base] = out.get(base, 0) + b
    return out


def replay_phase(X, ds, cfg, cfg_q, epochs) -> dict:
    """The replay cost model on the ring of mesh (1, 10) (see the module
    docstring, phase 6b): a cost table from micro-runs, each ring variant
    recorded into its DAG and replayed beside its measured ms, the gates
    on bits, ledger bytes and launches, ``overlap="replay"`` and the
    walltime controller."""
    from repro_torch.analysis.replay import calibrate, extract_step_dag, \
        replay
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig,
                                             stage_ring_edges)
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.comm.transport import PaddedWire
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    dev = X.device
    Xp = ring_problem(X, ds, dev)
    V, h = Xp.shape
    L, C = STAGES, ds.n_classes
    mesh = StageMesh(1, STAGES)
    links = mesh.size
    args = (Xp, ds.labels, ds.masks)
    data = [LocalRing(mesh, dev).to_local(x, "rows")
            for x in (Xp, ds.labels, ds.masks["train"])]
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    wire = PaddedWire.from_grids(grids)
    # all three widths in use on both edges
    widths = [[s % 3 for s in range(STAGES)],
              [(s + 1) % 3 for s in range(STAGES)]]
    out = {}

    t0 = time.perf_counter()
    costs = calibrate(LocalRing(mesh, dev), V=V, h=h, n_classes=C,
                      fista_iters=cfg.fista_iters, iters=REPLAY_CAL_ITERS,
                      grid=cfg_q.grid)
    t_cal = time.perf_counter() - t0
    print(f"replay: cost table calibrated in {t_cal:.2f} s on "
          f"{costs.meta['device']}, mesh {costs.meta['mesh']}:", flush=True)
    for k in sorted(costs.entries):
        print(f"  {k:30s} {costs.entries[k]:.6g}")
    out["costs"] = {"entries": dict(costs.entries), "meta": costs.meta,
                    "calibrate_s": t_cal}

    variants = {"G_off": dict(cfg=cfg, overlap=False),
                "G_on": dict(cfg=cfg, overlap=True),
                "GQ": dict(cfg=cfg_q, overlap=False),
                "mixed": dict(cfg=cfg, overlap=False, wire=wire,
                              widths=widths)}
    inits = {"G": SP.init_stack(0, Xp, L, cfg),
             "GQ": SP.init_stack(0, Xp, L, cfg_q)}
    rows = {}
    for name, v in variants.items():
        c, ov = v["cfg"], v["overlap"]
        w, wd = v.get("wire"), v.get("widths")
        init = inits["GQ" if c is cfg_q else "G"]
        t0 = time.perf_counter()
        prog = SP.trace_step_program(mesh, L, C, c, V=V, h=h, overlap=ov,
                                     wire=w, widths=wd)
        t_trace = time.perf_counter() - t0
        dag = extract_step_dag(prog, n_stages=STAGES, n_rows=1)
        a = replay(dag, costs, n_workers=1)
        b = replay(dag, costs, n_workers=1)
        if (a.step_time_s, a.per_stage_busy_s, a.per_stage_idle_s,
                a.critical_path) != (b.step_time_s, b.per_stage_busy_s,
                                     b.per_stage_idle_s, b.critical_path):
            raise AssertionError(f"replay {name}: two replays differ")
        if not (math.isfinite(a.step_time_s) and a.step_time_s > 0):
            raise AssertionError(f"replay {name}: prediction {a.step_time_s}")
        # the DAG's shift bytes against the ledger of one iteration
        led = CommLedger()
        kw = {}
        if w is not None:
            kw = dict(mixed_width=True, grids_by_bits=grids,
                      controller=BitWidthController(
                          stage_ring_edges(STAGES, V, h),
                          ControllerConfig(**MIXED_CONTROLLER)))
        SP.distributed_train(mesh, None, *args, L, C, c, 1, ledger=led,
                             init=init, overlap=ov, **kw, jit=False)
        dag_bytes = {e.edge: e.wire_bytes * links for e in dag.comm_events
                     if e.prim == "ppermute"}
        led_bytes = ledger_iteration_bytes(led)
        if dag_bytes != led_bytes:
            raise AssertionError(f"replay {name}: DAG bytes {dag_bytes} != "
                                 f"ledger {led_bytes}")
        # launches: recorder == one real step == the plan
        recorded = prog.launch_counts()
        real = replay_launches(mesh, L, C, c, init, data, overlap=ov,
                               wire=w, widths=wd)
        plan = SP.step_program_plan(mesh, L, C, c, V=V, h=h, overlap=ov,
                                    wire=w, device=dev)
        if not recorded == real == plan.pallas_calls:
            raise AssertionError(f"replay {name}: launches recorded "
                                 f"{recorded}, real {real}, plan "
                                 f"{plan.pallas_calls}")
        pp = [e for e in dag.comm_events if e.prim == "ppermute"]
        rows[name] = {
            "predicted_ms": a.step_time_ms, "trace_s": t_trace,
            "events": [(e.edge, e.dtype, e.wire_bytes, e.carried,
                        e.work_to_consumer) for e in pp],
            "collectives": dag.counts(), "launches": real,
            "wire_bytes_per_iter": sum(dag_bytes.values()),
            "busy_ms": [x * 1e3 for x in a.per_stage_busy_s],
            "critical_comm": a.critical_comm()[:3]}
        print(f"  {name}: traced in {t_trace:.2f} s; predicted "
              f"{a.step_time_ms:.3f} ms; shifts {rows[name]['events']}; "
              f"collectives {dag.counts()}; ledger bytes {led_bytes} == "
              f"DAG's; launches {real} == recorded == plan", flush=True)

    # measured ms per iteration, the four in turns, medians of three
    samples = {name: [] for name in variants}
    for _ in range(3):
        for name, v in variants.items():
            c = v["cfg"]
            init = inits["GQ" if c is cfg_q else "G"]
            samples[name].append(ring_ms_per_iter(
                mesh, L, C, c, init, data, overlap=v["overlap"],
                wire=v.get("wire"), widths=v.get("widths"))[0])
    for name, r in rows.items():
        r["measured_ms"] = float(np.median(samples[name]))
        r["measured_ms_all"] = samples[name]
        r["ratio"] = r["predicted_ms"] / r["measured_ms"]
        print(f"  {name}: predicted {r['predicted_ms']:.3f} ms, measured "
              f"{r['measured_ms']:.3f} ms ({samples[name]}), ratio "
              f"{r['ratio']:.3f} (the reference's target: within 0.40)",
              flush=True)
    pred_on = rows["G_on"]["predicted_ms"] <= rows["G_off"]["predicted_ms"]
    meas_on = rows["G_on"]["measured_ms"] <= rows["G_off"]["measured_ms"]
    print(f"  overlap ordering: predicted on <= off {pred_on}, measured "
          f"{meas_on}: {'match' if pred_on == meas_on else 'differ'}",
          flush=True)
    out["variants"] = rows
    out["overlap_ordering_match"] = pred_on == meas_on

    # overlap="replay" on the G ring, against use_kernels=False
    choice = SP.choose_overlap_for(mesh, L, C, cfg, V=V, h=h, costs=costs,
                                   ring=LocalRing(mesh, dev))
    _, hist = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                   init=inits["G"], overlap="replay",
                                   cost_table=costs, jit=False)
    if hist["overlap"] != choice:
        raise AssertionError(f"overlap='replay' ran {hist['overlap']}, "
                             f"choose_overlap_for says {choice}")
    _, h_plain = SP.distributed_train(
        mesh, None, *args, L, C, dataclasses.replace(cfg, use_kernels=False),
        epochs, init=inits["G"], jit=False)
    np.testing.assert_allclose(hist["objective"], h_plain["objective"],
                               rtol=TRAJ_RTOL)
    print(f"  overlap='replay': chose overlap={choice}; objective "
          f"{hist['objective']} tracks plain {h_plain['objective']}",
          flush=True)
    out["overlap_replay"] = {"choice": choice,
                             "objective": hist["objective"],
                             "objective_plain": h_plain["objective"]}

    # the mixed-width ring under the walltime controller: the container's
    # capacity is fixed, so predicted time is flat and every boundary is
    # promoted to the widest width
    ring = LocalRing(mesh, dev)
    cm = SP.step_cost_model(mesh, L, C, cfg, costs, V=V, h=h,
                            grids_by_bits=grids, mixed_width=True,
                            ring=ring)

    def walltime_ctl(model):
        return BitWidthController(
            stage_ring_edges(STAGES, V, h),
            ControllerConfig(objective="walltime", **MIXED_CONTROLLER),
            cost_model=model)
    led_w = CommLedger()
    _, hw = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                 controller=walltime_ctl(cm),
                                 grids_by_bits=grids, ledger=led_w,
                                 mixed_width=True, init=inits["G"],
                                 ring=ring, jit=False)
    widest = (max(MIXED_CONTROLLER["allowed_bits"]),) * STAGES
    if any(tuple(sched) != widest for sched in hw["schedules"]):
        raise AssertionError(f"walltime schedules {hw['schedules']} are not "
                             f"all {widest}")
    _, hw_plain = SP.distributed_train(
        mesh, None, *args, L, C, dataclasses.replace(cfg, use_kernels=False),
        epochs, controller=walltime_ctl(cm), grids_by_bits=grids,
        mixed_width=True, init=inits["G"], jit=False)
    np.testing.assert_allclose(hw["objective"], hw_plain["objective"],
                               rtol=TRAJ_RTOL)
    led_b = CommLedger()
    SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                         controller=BitWidthController(
                             stage_ring_edges(STAGES, V, h),
                             ControllerConfig(**MIXED_CONTROLLER)),
                         grids_by_bits=grids, ledger=led_b, mixed_width=True,
                         init=inits["G"], jit=False)
    per_w = led_w.summary()["total_bytes"] / epochs
    per_b = led_b.summary()["total_bytes"] / epochs
    print(f"  walltime mixed ring: schedules all {widest}; predicted "
          f"{cm(widest) * 1e3:.3f} ms; objective {hw['objective']} tracks "
          f"plain; logical bytes per iteration {per_w:.0f} (bytes "
          f"objective {per_b:.0f}), physical {led_w.summary()['wire_bytes'] / epochs:.0f}",
          flush=True)
    out["walltime_mixed"] = {"schedules": [list(x) for x in hw["schedules"]],
                             "objective": hw["objective"],
                             "objective_plain": hw_plain["objective"],
                             "logical_bytes_per_iter": per_w,
                             "bytes_objective_logical_per_iter": per_b,
                             "predicted_ms": cm(widest) * 1e3}

    # the uniform-codec walltime path: one managed edge, the packed payload
    # grows with the width
    cu = SP.step_cost_model(mesh, L, C, cfg, costs, V=V, h=h,
                            grids_by_bits=grids, mixed_width=False,
                            ring=ring)
    ctl_u = BitWidthController(
        [2 * V * h], ControllerConfig(objective="walltime",
                                      **MIXED_CONTROLLER), cost_model=cu)
    _, hu = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                 controller=ctl_u, grids_by_bits=grids,
                                 init=inits["G"], ring=ring, jit=False)
    cand = {b: cu((b,)) * 1e3 for b in sorted(grids)}
    print(f"  walltime uniform codec: widths {hu['schedules']}; predicted "
          f"ms per candidate {cand}", flush=True)
    if not all(math.isfinite(o) for o in hu["objective"]):
        raise AssertionError(f"walltime uniform: objective {hu['objective']}")
    out["walltime_uniform"] = {"schedules": [int(b) for b in hu["schedules"]],
                               "predicted_ms": cand,
                               "objective": hu["objective"]}
    return out


def contract_phase(X, ds, cfg) -> dict:
    """The program-contract linter on the ring of mesh (1, 10) (the module
    docstring, phase 6c): every step spec at full width on the card,
    clean; the wrappers' counters over one real step equal the plan
    (ragged views too); the donated step's peak memory below the plain
    one's; full-width mutations fire their keys; the psum specs and the
    CLI at the specs' sizes."""
    from repro_torch.analysis import contracts as CT
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    t_phase = time.perf_counter()
    dev = X.device
    Xp = ring_problem(X, ds, dev)
    V, h = Xp.shape
    L, C = STAGES, ds.n_classes
    mesh = StageMesh(1, STAGES)
    inputs = (Xp, ds.labels, ds.masks["train"])
    full = {s.name: dataclasses.replace(s, mesh=(1, STAGES), V=V, h=h, L=L,
                                        n_classes=C)
            for s in CT.STEP_SPECS}
    out = {"seconds": {}, "launches": {}}

    findings = []
    for name, spec in full.items():
        t0 = time.perf_counter()
        findings += CT.check_contracts(spec, device=dev, inputs=inputs)
        out["seconds"][name] = time.perf_counter() - t0
    print(f"contract: {len(full)} step specs at full width (mesh (1, "
          f"{STAGES}), V {V}, h {h}, L {L}, C {C}) on the card:", flush=True)
    print(CT.summary_table(findings, list(full)), flush=True)
    for f in findings:
        print(f"  {f.severity.upper():5s} {f.config}: [{f.key}] {f.message}")
    print("  seconds per spec: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["seconds"].items()), flush=True)
    out["findings"] = [f.to_dict() for f in findings]
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise AssertionError(f"contract: {len(errors)} error finding(s) at "
                             f"full width: {[f.to_dict() for f in errors]}")

    # the wrappers' own counters over one real step == the plan
    for name, spec in full.items():
        view = CT.ProgramView(spec, device=dev, inputs=inputs)
        want = view.plan.pallas_calls
        got = {"counted": view.launches, "recorded": view.pallas_counts}
        if spec.check_ragged:
            ragged = view.ragged_view()
            got["ragged_V"] = ragged.spec.V
            got["ragged_counted"] = ragged.launches
            if ragged.launches != want:
                raise AssertionError(f"contract {name}: ragged V "
                                     f"{ragged.spec.V} counted "
                                     f"{ragged.launches} != plan {want}")
        if not view.launches == view.pallas_counts == want:
            raise AssertionError(f"contract {name}: counted "
                                 f"{view.launches}, recorded "
                                 f"{view.pallas_counts}, plan {want}")
        out["launches"][name] = dict(got, plan=want)
    print("  launches counted == recorded == plan on every spec; ragged: "
          + ", ".join(f"{k} V={v['ragged_V']} {v['ragged_counted']}"
                      for k, v in out["launches"].items()
                      if "ragged_V" in v), flush=True)

    # peak memory of one step, plain and donated
    ring = LocalRing(mesh, dev)
    data = [ring.to_local(x, "rows") for x in inputs]
    out["peak"] = ring_peak_mib(mesh, L, C, cfg,
                                SP.init_stack(0, Xp, L, cfg), data)
    pk = out["peak"]
    print(f"  peak memory of one step: plain {pk['plain']['peak_mib']:.1f} "
          f"MiB ({pk['plain']['above_mib']:.1f} above its start), donated "
          f"{pk['donate']['peak_mib']:.1f} MiB "
          f"({pk['donate']['above_mib']:.1f} above its start)", flush=True)

    # mutations at full width fire exactly their keys
    muts = {"overlap_off": (full["overlap"], dict(overrides={"overlap":
                                                             False})),
            "use_kernels_off": (full["baseline"], dict(
                overrides={"use_kernels": False}, families=["dispatch"]))}
    want_keys = {"overlap_off": ["schedule.carried",
                                 "schedule.work_to_consumer"],
                 "use_kernels_off": ["dispatch.pallas_calls",
                                     "dispatch.ragged_fallback"]}
    out["mutations"] = {}
    for k, (spec, kw) in muts.items():
        fs = CT.check_contracts(spec, device=dev, inputs=inputs, **kw)
        keys = sorted({f.key for f in fs if f.severity == "error"})
        out["mutations"][k] = keys
        if keys != want_keys[k]:
            raise AssertionError(f"contract mutation {k}: fired {keys}, "
                                 f"want {want_keys[k]}")
    print(f"  mutations at full width: {out['mutations']}", flush=True)

    # the psum specs on the card, at their sizes
    ps = []
    for spec in CT.PSUM_SPECS:
        ps += CT.check_contracts(spec, device=dev)
    if [f for f in ps if f.severity == "error"]:
        raise AssertionError(f"contract psum: {[f.to_dict() for f in ps]}")
    print(f"  psum specs clean on the card: "
          f"{[s.name for s in CT.PSUM_SPECS]}", flush=True)

    # the CLI, every spec at its size, recorded on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          "--all", "--format", "json"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"contract: lint --all exited {res.returncode}:"
                             f" {res.stdout[-2000:]} {res.stderr[-2000:]}")
    report = json.loads(res.stdout)
    if report["device"] != "cuda" or report["counts"]["error"]:
        raise AssertionError(f"contract: lint report {report['device']} "
                             f"{report['counts']}")
    out["cli"] = {"seconds": time.perf_counter() - t0,
                  "counts": report["counts"],
                  "device_name": report["device_name"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  lint --all --format json on {report['device_name']}: exit 0, "
          f"{report['counts']} in {out['cli']['seconds']:.1f} s; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def sentinel_ms_per_iter(mesh, L, C, cfg, init, data, n=5, plan=None):
    """``ring_ms_per_iter`` for the sentinel step (health=True, or a fault
    plan's controls at tick 0), the good slabs primed once and the controls
    made once on the card; returns (ms, step, carry after the run, ctl)."""
    from repro_torch.comm import faults as FT
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing
    ring = LocalRing(mesh, init.p.device)
    step, _ = SP.make_distributed_step(mesh, L, C, cfg, health=True,
                                       faults=plan, ring=ring)
    st = SP.shard_stack(init, ring)
    carry = (st, SP.make_sentinel_primer(mesh, ring=ring)(st.q, st.u, st.p))
    ctl = (FT.null_controls(mesh.model, device=ring.device) if plan is None
           else plan.controls(0, mesh.model, device=ring.device))
    carry, _ = step(carry, *data, ctl)                         # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        carry, m = step(carry, *data, ctl)
    float(m["objective"])
    return (time.perf_counter() - t) / n * 1e3, step, carry, ctl


def ft_check_equal(label, got, want):
    """Objectives and the final global stacks of two runs, bit for bit."""
    (sg, hg), (sw, hw) = got, want
    if hg["objective"] != hw["objective"]:
        raise AssertionError(f"{label}: objectives differ: {hg['objective']} "
                             f"vs {hw['objective']}")
    for f in sg._fields:
        if not torch.equal(getattr(sg, f), getattr(sw, f)):
            raise AssertionError(f"{label}: state {f} differs")


def ft_phase(X, ds, dims, cfg, cfg_q, epochs, runs):
    """Fault tolerance at full width (module docstring, phase 7): (a) the
    sentinel ring without faults, (b) chaos accounting, (c) rollback,
    (d) resume and elastic restore, (e) the paper's G-Q setting through
    train_adaptive, with a NaN rollback."""
    import tempfile
    from repro_torch.comm import faults as FT
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig, admm_edges,
                                             train_adaptive)
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.configs.gamlp_paper import GAMLP
    from repro_torch.core.quantize import integer_grid
    from repro_torch.kernels import ops
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    dev = X.device
    Xp = ring_problem(X, ds, dev)
    L, C = STAGES, ds.n_classes
    mesh = StageMesh(1, STAGES)
    args = (Xp, ds.labels, ds.masks)
    data = [LocalRing(mesh, dev).to_local(x, "rows")
            for x in (Xp, ds.labels, ds.masks["train"])]
    init = SP.init_stack(0, Xp, L, cfg)
    out = {}
    tmp = tempfile.mkdtemp()
    try:
        # (a) health and a zero-rate plan: today's ring, bit for bit
        plain = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                     init=init, jit=False)
        for label, kw in (("health", dict(health=True)),
                          ("zero-rate plan", dict(
                              faults=FT.FaultPlan(seed=FT_ZERO_SEED)))):
            ops.reset_launch_counts()
            got = SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                       init=init, **kw, jit=False)
            counts = ops.launch_counts()
            missing = [k for k in BASE_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"sentinel ring ({label}): kernels never"
                                     f" launched: {missing}")
            ft_check_equal(f"sentinel ring ({label})", got, plain)
            if got[1]["faults"]["detected"] or got[1]["faults"]["rolled_back"]:
                raise AssertionError(f"{label}: {got[1]['faults']}")
            print(f"ft (a) {label}: {epochs} iterations bitwise equal to the "
                  f"plain ring; launches {counts}", flush=True)
        ms_plain, _, _ = ring_ms_per_iter(mesh, L, C, cfg, init, data)
        ms_health, step_h, carry_h, ctl = sentinel_ms_per_iter(
            mesh, L, C, cfg, init, data)
        ms_zero = sentinel_ms_per_iter(mesh, L, C, cfg, init, data,
                                       plan=FT.FaultPlan(seed=FT_ZERO_SEED))[0]
        ms_plain_b, _, _ = ring_ms_per_iter(mesh, L, C, cfg, init, data)
        loop_ms = {}
        for label, kw in (("plain", {}), ("health", dict(health=True))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SP.distributed_train(mesh, None, *args, L, C, cfg, epochs,
                                 init=init, **kw, jit=False)
            torch.cuda.synchronize()
            loop_ms[label] = (time.perf_counter() - t0) / epochs * 1e3
        slab = torch.randn((1, STAGES, 1) + tuple(Xp.shape), device=dev)
        seq = torch.zeros((), dtype=torch.int32, device=dev)
        cs_ms = device_ms(lambda: [FT.checksum_header(slab, seq, batch_dims=2)
                                   for _ in range(6)])
        held = [carry_h]

        def run_once():
            held[0], _ = step_h(held[0], *data, ctl)
        prof = profile_phase("G ring, health step", run_once, ms_health)
        print(f"ft (a) sentinel cost, G ring: step ms per iteration plain "
              f"{ms_plain:.3f} / {ms_plain_b:.3f}, health {ms_health:.3f}, "
              f"zero-rate plan {ms_zero:.3f}; through distributed_train "
              f"(one host read per iteration with health) plain "
              f"{loop_ms['plain']:.3f}, health {loop_ms['health']:.3f}; the "
              f"six checksums of an iteration ([1,10,1,{Xp.shape[0]},"
              f"{Xp.shape[1]}] f32 each) {cs_ms:.4f} device ms", flush=True)
        out["health"] = {"bitwise": True, "ms_plain": [ms_plain, ms_plain_b],
                         "ms_health": ms_health, "ms_zero_rate": ms_zero,
                         "loop_ms": loop_ms, "checksums_device_ms": cs_ms,
                         "profile": prof}

        # (b) chaos accounting on the G-Q ring
        init_q = SP.init_stack(0, Xp, L, cfg_q)
        plan = FT.FaultPlan(**FT_CHAOS)
        chaos = {}
        for overlap in (False, True):
            led = CommLedger()
            ops.reset_launch_counts()
            st, h = SP.distributed_train(mesh, None, *args, L, C, cfg_q,
                                         FT_TICKS, init=init_q, faults=plan,
                                         overlap=overlap, ledger=led,
                                         jit=False)
            counts = ops.launch_counts()
            missing = [k for k in GQ_KERNELS if counts[k] == 0]
            if missing:
                raise AssertionError(f"chaos ring: kernels never launched: "
                                     f"{missing}")
            f, fc = h["faults"], led.fault_counts()
            for en in FT.EDGES:
                c = f["per_edge"][en]
                if not (c["injected"] == c["detected"] == c["recovered"]
                        == fc.get(en, {}).get("injected", 0)
                        == fc.get(en, {}).get("detected", 0)):
                    raise AssertionError(f"chaos accounting {en}: {c}, "
                                         f"ledger {fc.get(en)}")
            if f["injected"] == 0 or f["rolled_back"]:
                raise AssertionError(f"chaos: {f}")
            hdr = sum(r.wire_bytes for r in led.records
                      if r.kind == "header" and r.edge in FT.EDGES)
            want = CommLedger()
            SP._record_sentinel_headers(want, 0, FT_TICKS, mesh)
            if hdr != want.total_wire_bytes():
                raise AssertionError(f"header bytes {hdr} != "
                                     f"{want.total_wire_bytes()}")
            again = SP.distributed_train(mesh, None, *args, L, C, cfg_q,
                                         FT_TICKS, init=init_q, faults=plan,
                                         overlap=overlap, jit=False)
            ft_check_equal(f"chaos repeat (overlap {overlap})", again,
                           (st, h))
            if not all(math.isfinite(o) for o in h["objective"]):
                raise AssertionError(f"chaos: objective {h['objective']}")
            print(f"ft (b) chaos G-Q ring, overlap {overlap}: {FT_CHAOS}, "
                  f"{FT_TICKS} ticks: per edge "
                  f"{ {en: f['per_edge'][en]['injected'] for en in FT.EDGES} }"
                  f" injected == detected == recovered == the ledger's; "
                  f"header bytes {hdr} == _record_sentinel_headers; a second "
                  f"run gives the same bits; objective {h['objective'][-1]:.6g}",
                  flush=True)
            chaos[str(overlap)] = {"faults": {k: f[k] for k in (
                "per_edge", "injected", "detected", "recovered",
                "rolled_back", "ticks")}, "header_bytes": hdr,
                "objective": h["objective"], "launches": counts}
        out["chaos"] = chaos

        # (c) undetected corruption rolls back to a checkpoint
        led = CommLedger()
        d = os.path.join(tmp, "rollback")
        _, h = SP.distributed_train(mesh, None, *args, L, C, cfg, FT_TICKS,
                                    init=init, faults=FT.FaultPlan(**FT_SNEAKY),
                                    ckpt=d, ckpt_every=2, ledger=led,
                                    jit=False)
        shutil.rmtree(d)
        f = h["faults"]
        print(f"ft (c) rollback: {FT_SNEAKY}: {f['injected']} sneaky slabs "
              f"injected, rolled back {f['rolled_back']} time(s) over "
              f"{f['ticks']} ticks; objectives {h['objective']}", flush=True)
        if f["rolled_back"] < 1 or len(h["objective"]) != FT_TICKS or not all(
                math.isfinite(o) for o in h["objective"]):
            raise AssertionError(f"rollback: {f}, {h['objective']}")
        if led.fault_counts()["step"]["rolled_back"] != f["rolled_back"]:
            raise AssertionError("rollback: the ledger's count differs")
        out["rollback"] = {"plan": FT_SNEAKY, "rolled_back": f["rolled_back"],
                           "injected": f["injected"], "ticks": f["ticks"],
                           "objective": h["objective"]}

        # (d) resume: 4 + a save + a fresh resume to 8 == 8, bit for bit
        d = os.path.join(tmp, "resume")
        _, h4 = SP.distributed_train(mesh, None, *args, L, C, cfg, 4,
                                     init=init, ckpt=d, ckpt_every=4,
                                     jit=False)
        s8r, h8r = SP.distributed_train(mesh, None, *args, L, C, cfg, 8,
                                        init=init, ckpt=d, resume=True,
                                        jit=False)
        s8, h8 = SP.distributed_train(mesh, None, *args, L, C, cfg, 8,
                                      init=init, health=True, jit=False)
        ft_check_equal("resume", (s8r, {"objective": h4["objective"]
                                        + h8r["objective"]}), (s8, h8))
        mesh5 = StageMesh(1, STAGES // 2)
        _, h5 = SP.distributed_train(mesh5, None, *args, L, C, cfg, 6,
                                     init=init, ckpt=d, resume=True, jit=False)
        shutil.rmtree(d)
        if len(h5["objective"]) != 2 or not all(
                math.isfinite(o) for o in h5["objective"]):
            raise AssertionError(f"elastic restore: {h5['objective']}")
        print(f"ft (d) resume: 4 iterations + save + resume to 8 == 8 "
              f"uninterrupted, bit for bit (objectives {h8['objective'][-1]:.6g}"
              f"); restored onto mesh (1, {STAGES // 2}) and trained 2 more: "
              f"{h5['objective']}", flush=True)
        out["resume"] = {"bitwise": True, "elastic_1x5": h5["objective"]}

        # (e) the paper's G-Q setting on one host
        grid = integer_grid(-1, 20)
        cfg_paper = dataclasses.replace(
            cfg, nu=GAMLP.nu, rho=GAMLP.rho, fista_iters=GAMLP.fista_iters,
            quantize_p=GAMLP.quantize_p, quantize_q=GAMLP.quantize_q,
            grid=grid)
        _, runs["GQ_paper"] = train_phase(
            X, ds, dims, cfg_paper, epochs, GQ_KERNELS,
            "pdADMM-G-Q, the paper's setting (Δ = {-1..20}, p on it, q not)")
        V = X.shape[0]

        def adaptive(config, **kw):
            ctl = BitWidthController(admm_edges(dims, V)[:len(dims) - 2],
                                     ControllerConfig(allowed_bits=(8,),
                                                      min_bits=8, max_bits=8))
            led = CommLedger()
            _, h = train_adaptive(0, X, ds.labels, ds.masks, dims, config,
                                  epochs, controller=ctl, ledger=led,
                                  grids_by_bits={8: grid}, device=dev, **kw,
                                  jit=False)
            return h, led
        ops.reset_launch_counts()
        ha, led_a = adaptive(cfg_paper)
        counts = ops.launch_counts()
        missing = [k for k in GQ_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"train_adaptive: kernels never launched: "
                                 f"{missing}")
        hp, _ = adaptive(dataclasses.replace(cfg_paper, use_kernels=False))
        print(f"ft (e) train_adaptive (Δ = {{-1..20}} as the 8-bit entry, "
              f"p and q on it): objective kernels {ha['objective']}, plain "
              f"{hp['objective']}; launches {counts}", flush=True)
        try:
            np.testing.assert_allclose(ha["objective"], hp["objective"],
                                       rtol=TRAJ_RTOL)
            check = f"rtol {TRAJ_RTOL}"
        except AssertionError:
            print("  beyond rtol: holding both paths from shared states",
                  flush=True)
            stepwise_check(X, ds, dims, dataclasses.replace(
                cfg_paper, quantize_q=True), epochs)
            check = "stepwise"
        poisoned = {"n": 0}

        def hook(e, state):
            if e == 3 and poisoned["n"] == 0:
                poisoned["n"] += 1
                W = list(state.W)
                W[0] = W[0].clone()
                W[0][0, 0] = float("nan")
                return state._replace(W=W)
            return state
        hr, led_r = adaptive(cfg_paper, ckpt=os.path.join(tmp, "adaptive"),
                             ckpt_every=2, fault_hook=hook)
        n_rb = led_r.fault_counts().get("step", {}).get("rolled_back", 0)
        if poisoned["n"] != 1 or n_rb != 1 or hr["objective"] != \
                ha["objective"]:
            raise AssertionError(f"train_adaptive rollback: {n_rb} "
                                 f"rollbacks, {hr['objective']} vs "
                                 f"{ha['objective']}")
        acc = {"G": runs["G"]["test_acc"], "GQ_uniform": runs["GQ"]["test_acc"],
               "GQ_paper": runs["GQ_paper"]["test_acc"],
               "GQ_paper_adaptive": ha["test_acc"][-1]}
        # the paper's epoch count, for G-Q on either grid
        from repro_torch.core import pdadmm
        for key, c in (("GQ_paper", cfg_paper), ("GQ_uniform", cfg_q)):
            _, h = pdadmm.train(0, X, ds.labels, ds.masks, dims, c,
                                GAMLP.epochs, device=dev, jit=False)
            acc[f"{key}_{GAMLP.epochs}"] = h["test_acc"][-1]
            if not math.isfinite(h["objective"][-1]):
                raise AssertionError(f"{key}: {GAMLP.epochs} iterations end "
                                     f"at {h['objective'][-1]}")
        print(f"ft (e) NaN at iteration 3: rolled back {n_rb} time, "
              f"objectives equal to the clean run's; test accuracy after "
              f"{epochs} iterations: G {acc['G']:.4f}, G-Q uniform_grid(8, "
              f"-2, 6) {acc['GQ_uniform']:.4f}, G-Q paper (p on Δ) "
              f"{acc['GQ_paper']:.4f}, train_adaptive (p, q on Δ) "
              f"{acc['GQ_paper_adaptive']:.4f}; after {GAMLP.epochs}: G-Q "
              f"paper {acc[f'GQ_paper_{GAMLP.epochs}']:.4f}, G-Q uniform "
              f"{acc[f'GQ_uniform_{GAMLP.epochs}']:.4f}", flush=True)
        out["paper_gq"] = {"adaptive_objective": ha["objective"],
                           "adaptive_objective_plain": hp["objective"],
                           "check": check, "launches": counts,
                           "rollback_equal": True, "test_acc": acc,
                           "wire_bytes_per_iter": led_a.iteration_bytes(0)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def graph_profile(label, run_once, n_iters: int, ms_per_iter: float) -> dict:
    """Device busy ms and host CUDA API calls per iteration over one
    ``run_once()`` of ``n_iters`` iterations (torch.profiler), the idle
    share of a ``ms_per_iter`` iteration, and the records of each
    ``HEAD_KERNELS`` group in the trace (over the whole run). A trace with
    no device event is taken again, up to PROFILE_TRIES times; then the
    busy time, the idle share and the records are None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_once()
            torch.cuda.synchronize()
        events = prof.events()
        device = [ev for ev in events if ev.device_type == DeviceType.CUDA]
        kernels = [ev for ev in device if ev.self_device_time_total > 0]
        if kernels:
            break
    calls = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and API_CALL.match(ev.name):
            calls[ev.name] = calls.get(ev.name, 0) + 1
    res = {"api_calls": sum(calls.values()) / n_iters,
           "api_calls_by_name": calls, "device_busy_ms": None,
           "device_launches": None, "idle_share": None,
           "head_launches": None, "source": "torch.profiler"}
    if kernels:
        busy = sum(ev.self_device_time_total for ev in kernels) / 1e3
        res.update(device_busy_ms=busy / n_iters,
                   device_launches=len(kernels) / n_iters,
                   idle_share=1.0 - busy / n_iters / ms_per_iter,
                   head_launches={g: sum(bool(pat.search(ev.name))
                                         for ev in device)
                                  for g, pat in HEAD_PATTERNS.items()})
        return res
    # no kernel in any trace: the device's span by CUDA events instead
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run_once()
    end.record()
    torch.cuda.synchronize()
    res.update(device_span_ms=start.elapsed_time(end) / n_iters,
               source="cuda events (the profiler recorded no kernel)")
    print(f"profile ({label}): no kernel in {PROFILE_TRIES} traces; device "
          f"span by events {res['device_span_ms']:.3f} ms an iteration",
          flush=True)
    return res


def graph_kernel_names(graph) -> list:
    """The kernel names (mangled) of a captured graph's kernel nodes, as
    the CUDA driver holds them: what each replay launches. ``graph`` was
    captured with ``core.graphs.debug`` set (it keeps its cudaGraph_t)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    class Params(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc:
            raise RuntimeError(f"{fn}: CUresult {rc}")

    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        par, name = Params(), ctypes.c_char_p()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
             ctypes.byref(par))
        if not par.func or cu.cuFuncGetName(ctypes.byref(name),
                                            ctypes.c_void_p(par.func)):
            call("cuKernelGetName", ctypes.byref(name),
                 ctypes.c_void_p(par.kern or par.func))
        names.append(name.value.decode())
    return names


def head_group(name: str):
    """The ``HEAD_KERNELS`` group a kernel's name belongs to, or None."""
    return next((g for g, pat in HEAD_PATTERNS.items() if pat.search(name)),
                None)


def peak_of(fn):
    """(fn(), peak MiB allocated while it ran, MiB above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak / 2 ** 20, (peak - base) / 2 ** 20


def graph_same(label, got, want) -> None:
    """Two runs' states and metrics (but their seconds), bit for bit."""
    from torch.utils._pytree import tree_leaves
    (sg, mg), (se, me) = got, want
    lg, le = tree_leaves(sg), tree_leaves(se)
    if len(lg) != len(le):
        raise AssertionError(f"graph {label}: state trees differ")
    for i, (a, b) in enumerate(zip(lg, le)):
        if isinstance(a, torch.Tensor) and not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"graph {label}: state leaf {i} "
                                 f"{tuple(a.shape)} differs from eager by "
                                 f"max |Δ| {d:.3e}")
    for k in me:
        if k.endswith("seconds"):
            continue
        a, b = np.asarray(mg[k]), np.asarray(me[k])
        if not np.array_equal(a, b):
            raise AssertionError(f"graph {label}: metric {k} differs from "
                                 f"eager: {a.tolist()} vs {b.tolist()}")


def graph_form(label, run, n_iters: int, required=(), steps=None,
               turns=GRAPH_TURNS, report=None) -> dict:
    """One path of ``graph_phase``: ``run(jit, state)`` runs ``n_iters``
    iterations of the path by the graphed (``jit=True``) or eager driver
    from ``state`` (None: the path's initial state) and returns
    ``(state, metrics)``, the state being what the next call may take back.
    ``steps(metrics)``, where given, is the number of steps a run took
    (a sentinel loop's ticks, rolled-back attempts included): the
    replays it must make and the count ms and calls are divided by;
    ``report(metrics)`` what the result keeps of the first eager run's
    metrics. The two forms from one state: the same bits, the same launch counts,
    one replay per step, peak MiB; then ms per step in ``turns``
    (medians) and a profile of each form. The graph's
    launches are read from the CUDA driver: the ``HEAD_KERNELS`` nodes of
    each graph the first run captured, times its replays, equal to the
    eager run's wrapper counts group by group. The profiles' device traces
    count the same kernels in each form; what a trace lacks of the
    wrappers' count (and the graph's warm-ups, two eager bodies a capture)
    is kept beside it."""
    from repro_torch.core import graphs
    from repro_torch.kernels import ops
    res, outs = {}, {}
    for jit in (True, False):
        ops.reset_launch_counts()
        graphs.replays = 0
        graphs.debug_programs.clear()
        graphs.debug = jit      # this run's graphs keep their nodes
        try:
            out, peak, above = peak_of(lambda: run(jit, None))
        finally:
            graphs.debug = False
        outs[jit] = out
        res["graph" if jit else "eager"] = {
            "launches": ops.launch_counts(), "replays": graphs.replays,
            "peak_mib": peak, "above_mib": above}
        if jit:
            # each captured graph's head nodes × its replays, and the
            # launches the wrappers made outside the graphs (the counters
            # less what the replays added to them: an entry point's
            # initial state, greedy growth's forward pass)
            nodes, outside = collections.Counter(), ops.launch_counts()
            for prog in graphs.debug_programs:
                for name in graph_kernel_names(prog.graph):
                    if head_group(name) is not None:
                        nodes[head_group(name)] += prog.replays
                for k, v in prog.delta[0].items():
                    outside[k] -= v * prog.replays
            graphs.debug_programs.clear()
    g, e = res["graph"], res["eager"]
    graph_same(label, outs[True], outs[False])
    want = {"+".join(w): sum(e["launches"][k] for k in w)
            for w in HEAD_KERNELS}
    g["graph_node_launches"] = {k: nodes.get(k, 0) for k in want}
    g["outside_launches"] = {k: v for k, v in outside.items() if v}
    got = {k: v + sum(outside[w] for w in k.split("+"))
           for k, v in g["graph_node_launches"].items()}
    if got != want:
        raise AssertionError(f"graph {label}: the graphs' kernel nodes × "
                             f"replays {g['graph_node_launches']} and the "
                             f"launches outside them {g['outside_launches']}"
                             f" make {got}; the eager wrappers count {want}")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"graph {label}: launches {g['launches']} vs "
                             f"eager {e['launches']}")
    missing = [k for k in required if e["launches"][k] == 0]
    count = n_iters if steps is None else steps(outs[False][1])
    if missing or g["replays"] != count or e["replays"]:
        raise AssertionError(f"graph {label}: {g['replays']} replays for "
                             f"{count} steps (eager {e['replays']});"
                             f" kernels never launched: {missing}")
    res["steps"] = count
    if report is not None:
        res["report"] = report(outs[False][1])
    states = {jit: outs[jit][0] for jit in (True, False)}
    del outs
    samples, wrapped = {True: [], False: []}, {}
    for jit in turns:
        torch.cuda.synchronize()
        t = time.perf_counter()
        states[jit], m = run(jit, states[jit])
        took = n_iters if steps is None else steps(m)
        samples[jit].append((time.perf_counter() - t) / took * 1e3)
    # eager first: its wrappers' counts are what both traces are read by
    for jit in (False, True):
        r = res["graph" if jit else "eager"]
        r["ms_per_iter_samples"] = samples[jit]
        r["ms_per_iter"] = float(np.median(samples[jit]))

        def once(jit=jit):
            ops.reset_launch_counts()
            graphs.warmup_launches.clear()
            states[jit], _ = run(jit, states[jit])
            wrapped[jit] = (ops.launch_counts(),
                            dict(graphs.warmup_launches))
        r["profile"] = graph_profile(label, once, count, r["ms_per_iter"])
        got = r["profile"]["head_launches"]
        if got is not None:
            counted, extra = wrapped[False][0], wrapped[jit][1]
            # a trace loses device records now and then (1-4 of a run's
            # 90-225 grid launches seen): what it lacks is kept as read
            r["trace_lacks"] = {
                k: sum(counted[w] + extra.get(w, 0) for w in k.split("+"))
                - v for k, v in got.items()}
            r["trace_lacks"] = {k: v for k, v in r["trace_lacks"].items()
                                if v}
            if r["trace_lacks"]:
                print(f"graph {label}: the {'graph' if jit else 'eager'} "
                      f"form's trace lacks {r['trace_lacks']} of the "
                      f"wrappers' count", flush=True)
    g["warmup_launches"] = wrapped[True][1]
    per_iter = {k: v / count for k, v in g["graph_node_launches"].items()
                if v}
    print(f"graph {label}: bitwise equal to eager over {count} steps,"
          f" counters equal ({sum(g['launches'].values())}), {g['replays']}"
          f" replays; head kernels a replay launches (the graphs' nodes; "
          f"with {g['outside_launches']} outside the graphs, as the eager "
          f"wrappers count): {per_iter}", flush=True)
    for name in ("graph", "eager"):
        r, p = res[name], res[name]["profile"]
        busy = ("not measured" if p["device_busy_ms"] is None else
                f"{p['device_busy_ms']:.3f}")
        idle = ("not measured" if p["idle_share"] is None else
                f"{p['idle_share']:.3f}")
        print(f"  {name}: ms per iteration {r['ms_per_iter']:.3f} (turns "
              f"{[round(x, 3) for x in r['ms_per_iter_samples']]}); device "
              f"busy {busy} ms, idle share {idle}, host CUDA API calls "
              f"{p['api_calls']:.1f} an iteration; peak {r['peak_mib']:.1f}"
              f" MiB ({r['above_mib']:.1f} above the base)", flush=True)
    return res


def graph_loops(Xp, ds, cfg) -> dict:
    """``graph_phase``'s paths through ``distributed_train``'s
    per-iteration loops on the G ring of mesh (1, 10), each by
    ``graph_form`` through the entry point (so the graph form captures
    inside every call): the mixed-width ring over its device widths table
    (``MIXED_CONTROLLER``'s 4/8/16 bits) with 10 managed edges and with
    20, overlap off and on; the per-epoch controller ring at 4/8/16 bits
    with overlap on, whose schedules must switch; and the sentinel loop
    with ``health=True`` (overlap on), under ``FT_SNEAKY`` (a rollback at
    least; ``FT_TICKS`` iterations) and with a checkpoint every 2
    iterations of 3 and a resume to 5. Each run's ``hist`` (objectives,
    schedules, fault counts, steps built), the ledger's bytes and the
    ring's shifted bytes are held bitwise against the eager loop with the
    state; one replay a step (a tick, for the sentinel loop)."""
    import tempfile
    from repro_torch.comm import faults as FT
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig,
                                             stage_ring_edges)
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    t_phase = time.perf_counter()
    dev, n = Xp.device, GRAPH_ITERS
    mesh = StageMesh(1, STAGES)
    L, C = STAGES, ds.n_classes
    V, h = Xp.shape
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    uniform = {k: v for k, v in MIXED_CONTROLLER.items() if k != "signal"}
    init = SP.init_stack(0, Xp, L, cfg)
    out = {}

    def loop(kw, epochs, ckpt=False, fresh=False):
        # fresh: every run from the initial state (a fault plan's rollbacks
        # depend on the state its flips strike)
        def run(jit, st):
            st = None if fresh else st
            kwargs = dict(kw)
            if "edges" in kwargs:
                kwargs.update(controller=BitWidthController(
                    stage_ring_edges(STAGES, V, h) * kwargs.pop("edges"),
                    ControllerConfig(**MIXED_CONTROLLER)),
                    grids_by_bits=grids)
            if kwargs.pop("uniform", False):
                kwargs.update(controller=BitWidthController(
                    [2 * V * h], ControllerConfig(**uniform)),
                    grids_by_bits=grids)
            ring, led = LocalRing(mesh, dev), CommLedger()
            train = functools.partial(
                SP.distributed_train, mesh, None, Xp, ds.labels, ds.masks,
                L, C, cfg, init=init if st is None else st, ledger=led,
                ring=ring, jit=jit, **kwargs)
            if ckpt:
                d = tempfile.mkdtemp()
                try:
                    train(epochs, ckpt=d, ckpt_every=2)
                    st, hist = train(epochs + 2, ckpt=d, resume=True)
                finally:
                    shutil.rmtree(d, ignore_errors=True)
            else:
                st, hist = train(epochs)
            hist = dict(hist, ledger_bytes=led.total_bytes(),
                        ledger_wire_bytes=led.total_wire_bytes(),
                        shifted_bytes=ring.shifted_bytes)
            return st, hist
        return run

    def ticks(hist):
        return hist["faults"]["ticks"]

    def loop_report(hist):
        keep = {k: hist[k] for k in (
            "n_compiled_steps", "ledger_bytes", "ledger_wire_bytes",
            "shifted_bytes")}
        keep["schedules"] = [list(x) if isinstance(x, tuple) else x
                             for x in hist["schedules"]]
        if "faults" in hist:
            keep["faults"] = {k: hist["faults"][k] for k in (
                "injected", "detected", "recovered", "rolled_back", "ticks")}
        return keep

    for label, kw, epochs, steps, turns in (
            ("mixed_10_edges", dict(mixed_width=True, edges=1), n, None,
             GRAPH_TURNS),
            ("mixed_10_edges_overlap", dict(mixed_width=True, edges=1,
                                            overlap=True), n, None,
             GRAPH_TURNS),
            ("mixed_20_edges", dict(mixed_width=True, edges=2), n, None,
             GRAPH_TURNS[:4]),
            ("mixed_20_edges_overlap", dict(mixed_width=True, edges=2,
                                            overlap=True), n, None,
             GRAPH_TURNS[:4]),
            ("controller_overlap", dict(uniform=True, overlap=True), n, None,
             GRAPH_TURNS),
            ("sentinel_health_overlap", dict(health=True, overlap=True), n,
             ticks, GRAPH_TURNS),
            ("sentinel_rollback", dict(faults=FT.FaultPlan(**FT_SNEAKY)),
             FT_TICKS, ticks, (True, False)),
            ("sentinel_ckpt_resume", dict(health=True), 3, None,
             (True, False))):
        ckpt = label.endswith("ckpt_resume")
        # 3 ticks with a save at 2, then a resume from 2 to 5
        n_steps = 6 if ckpt else epochs
        res = graph_form(label, loop(kw, epochs, ckpt,
                                     fresh=label == "sentinel_rollback"),
                         n_steps,
                         BASE_KERNELS + (WIRE_KERNELS + PACK_KERNELS
                                         if "mixed" in label else ()),
                         steps=steps, turns=turns, report=loop_report)
        hist = res["report"]
        schedules = [tuple(x) if isinstance(x, list) else x
                     for x in hist["schedules"]]
        if "mixed" in label and (hist["n_compiled_steps"] != 1
                                 or len(set(schedules)) < 2):
            raise AssertionError(f"graph {label}: {hist['n_compiled_steps']}"
                                 f" steps built, schedules {schedules}")
        if label == "controller_overlap" and len(set(schedules)) < 2:
            raise AssertionError(f"graph {label}: the schedules never "
                                 f"switched: {schedules}")
        if label == "sentinel_rollback" and \
                hist["faults"]["rolled_back"] < 1:
            raise AssertionError(f"graph {label}: no rollback: "
                                 f"{hist['faults']}")
        print(f"  {label}: schedules {schedules[:6]}"
              f"{' ...' if len(schedules) > 6 else ''}; steps built "
              f"{hist['n_compiled_steps']}, ledger {hist['ledger_bytes']} "
              f"logical / {hist['ledger_wire_bytes']} physical B, shifted "
              f"{hist['shifted_bytes']} B; faults {hist.get('faults')}",
              flush=True)
        out[label] = res
    out["steady"] = loop_steady(Xp, ds, cfg, grids)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"graph loops: {out['seconds']:.1f} s", flush=True)
    return out


def loop_steady(Xp, ds, cfg, grids) -> dict:
    """ms per step of three of ``graph_loops``' steps as their loops call
    them (``stage_parallel._Calls``: the widths table or the tick's
    controls rewritten, one call, the metrics read on the host), over
    GRAPH_STEADY steps after the first (the replayed form's capture), the
    replayed and the eager form in turns: the mixed-width step (a 4/8/16
    mix of widths), the controller ring's 8-bit step with overlap, and
    the sentinel step with ``health=True`` and overlap."""
    from repro_torch.comm import faults as FT
    from repro_torch.core import graphs
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh

    mesh = StageMesh(1, STAGES)
    L, C = STAGES, ds.n_classes
    wire = SP.PaddedWire.from_grids(grids)
    codec = SP.codec_for_grid(grids[8])
    mix = [(4, 8, 16)[s % 3] for s in range(STAGES)]
    out = {}
    for label in ("mixed", "controller_8bit_overlap",
                  "sentinel_health_overlap"):
        ring = LocalRing(mesh, Xp.device)
        data = tuple(ring.to_local(x, "rows")
                     for x in (Xp, ds.labels, ds.masks["train"]))
        st = SP.shard_stack(SP.init_stack(0, Xp, L, cfg), ring)
        if label == "mixed":
            step = SP.make_distributed_step(mesh, L, C, cfg, wire=wire,
                                            ring=ring)[0]
            table = wire.widths_table(mix, mix, Xp.device)
            carry, args = st, data + (table,)

            def before(replay, args, t):
                wire.widths_table(mix, mix, out=args[-1])
                return args
        elif label.startswith("controller"):
            step = SP.make_distributed_step(mesh, L, C, cfg, overlap=True,
                                            p_codec=codec, q_codec=codec,
                                            ring=ring)[0]
            carry = (st, SP.make_overlap_primer(mesh, codec, ring=ring)(
                st.q, st.u))
            args = data

            def before(replay, args, t):
                return args
        else:
            step = SP.make_distributed_step(mesh, L, C, cfg, overlap=True,
                                            health=True, ring=ring)[0]
            good = SP.make_sentinel_primer(mesh, ring=ring)(st.q, st.u,
                                                            st.p)
            fly = SP.make_overlap_primer(mesh, sentinel=True, ring=ring)(
                st.q, st.u, -1)
            carry = ((st, good), fly)
            args = data + (FT.null_controls(STAGES, device=Xp.device),)

            def before(replay, args, t):
                # the replayed form rewrites its controls, as the loop does
                ctl = FT.null_controls(STAGES, seqno=t, device=Xp.device,
                                       into=args[-1] if replay else None)
                return args[:-1] + (ctl,)
        samples = {True: [], False: []}
        for replay in (True, False, False, True):
            calls = SP._Calls(replay)
            c, m = calls(step, carry, before(replay, args, 0))
            float(m["objective"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(1, GRAPH_STEADY + 1):
                c, m = calls(step, c, before(replay, args, t))
                float(m["objective"])          # the loop's host read
            samples[replay].append((time.perf_counter() - t0)
                                   / GRAPH_STEADY * 1e3)
            del c, m, calls
        graphs.release(step)
        out[label] = {"graph": samples[True], "eager": samples[False]}
        print(f"graph steady {label}: ms per step over {GRAPH_STEADY} "
              f"steps after the capture: replayed {samples[True]}, eager "
              f"{samples[False]}", flush=True)
        del step, carry, args, st, ring, data
    return out


def graph_phase(X, ds, dims, cfg, cfg_q) -> dict:
    """The compiled ADMM driver (``core.graphs``) against the eager loop on
    the paths that ride ``pdadmm.run_chunked``: G, G-Q, G-Q with 8-bit u
    codecs, the G and G-Q rings of mesh (1, 10) with overlap off and on
    (and G with ``donate=True``), one ``train_adaptive`` control step,
    ``train_adaptive`` with a control step every iteration over 4/8/16-bit
    grids, and ``greedy_train``'s (2, 5) schedule, each by
    ``graph_form``."""
    from repro_torch.comm.codecs import GridCodec
    from repro_torch.comm.controller import (BitWidthController,
                                             ControllerConfig, admm_edges,
                                             train_adaptive)
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.core import graphs, pdadmm
    from repro_torch.core.greedy import greedy_train
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.parallel import stage_parallel as SP
    from repro_torch.parallel.ring import LocalRing, StageMesh
    from torch.utils._pytree import tree_map

    dev, n = X.device, GRAPH_ITERS
    args = (X, ds.labels, ds.masks["train"])
    # programs the earlier phases left alive (0: each died with its step)
    out = {"programs_alive_at_start": len(graphs.programs())}
    print(f"graph: {out['programs_alive_at_start']} captured programs alive "
          f"from earlier phases; {torch.cuda.memory_allocated() / 2 ** 20:.1f}"
          f" MiB allocated, {torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB "
          f"reserved", flush=True)

    def chunked(step, s0, a, donate=False, ring=None, moved=None):
        def run(jit, st):
            if st is None:      # a donated eager step writes into its input
                st = tree_map(torch.clone, s0) if donate else s0
            b0 = ring.shifted_bytes if ring is not None else 0
            res = pdadmm.run_chunked(step, st, a, n, jit=jit)
            if ring is not None:
                moved[jit].add(ring.shifted_bytes - b0)
            return res
        return run

    u_codecs = (GridCodec(uniform_grid(8, -1.0, 1.0)),) * (len(dims) - 2)
    for label, c, kw, required in (
            ("G", cfg, {}, BASE_KERNELS), ("GQ", cfg_q, {}, GQ_KERNELS),
            ("GQ_u_wire", cfg_q, {"u_codecs": u_codecs},
             GQ_KERNELS + WIRE_KERNELS)):
        step = functools.partial(pdadmm.iterate, config=c, **kw)
        s0 = pdadmm.init_state(0, X, dims, c, device=dev)
        out[label] = graph_form(label, chunked(step, s0, args), n, required)
        graphs.release(step)
        del step, s0

    Xp = ring_problem(X, ds, dev)
    mesh = StageMesh(1, STAGES)
    L, C = STAGES, ds.n_classes
    for label, c, overlap, donate, required in (
            ("G_ring", cfg, False, False, BASE_KERNELS),
            ("G_ring_overlap", cfg, True, False, BASE_KERNELS),
            ("G_ring_donate", cfg, False, True, BASE_KERNELS),
            ("GQ_ring", cfg_q, False, False, GQ_KERNELS + WIRE_KERNELS),
            ("GQ_ring_overlap", cfg_q, True, False,
             GQ_KERNELS + WIRE_KERNELS)):
        ring = LocalRing(mesh, dev)
        step, _ = SP.make_distributed_step(mesh, L, C, c, overlap=overlap,
                                           donate=donate, ring=ring)
        data = tuple(ring.to_local(x, "rows") for x in
                     (Xp, ds.labels, ds.masks["train"]))
        st = SP.shard_stack(SP.init_stack(0, Xp, L, c), ring)
        if overlap:
            st = (st, SP.make_overlap_primer(
                mesh, SP.codec_for_grid(c.grid if c.quantize_q else None),
                ring=ring)(st.q, st.u))
        moved = {True: set(), False: set()}
        out[label] = graph_form(label, chunked(step, st, data, donate, ring,
                                               moved), n, required)
        if len(moved[True] | moved[False]) != 1:
            raise AssertionError(f"graph {label}: the shifts' bytes a run "
                                 f"{moved}: graph and eager differ")
        out[label]["shifted_bytes_per_iter"] = moved[True].pop() / n
        graphs.release(step)
        del step, st, ring
    out.update(graph_loops(Xp, ds, cfg))

    grid = cfg_q.grid
    V = X.shape[0]

    def adaptive(jit, st):
        ctl = BitWidthController(admm_edges(dims, V)[:len(dims) - 2],
                                 ControllerConfig(allowed_bits=(8,),
                                                  min_bits=8, max_bits=8))
        return train_adaptive(0, X, ds.labels, ds.masks, dims, cfg, n,
                              controller=ctl, ledger=CommLedger(),
                              grids_by_bits={8: grid}, control_interval=n,
                              device=dev, jit=jit)
    out["adaptive"] = graph_form("adaptive (one control step)", adaptive, n,
                                 GQ_KERNELS)

    # a control step every iteration over 4/8/16-bit grids: each schedule
    # the controller picks gets its graph, all over one state's buffers
    grids = {b: uniform_grid(b, -2.0, 6.0) for b in (4, 8, 16)}
    visited = {True: [], False: []}

    def adaptive_mixed(jit, st):
        ctl = BitWidthController(admm_edges(dims, V)[:len(dims) - 2],
                                 ControllerConfig(**MIXED_CONTROLLER))
        st, h = train_adaptive(0, X, ds.labels, ds.masks, dims, cfg, n,
                               controller=ctl, ledger=CommLedger(),
                               grids_by_bits=grids, control_interval=1,
                               device=dev, jit=jit)
        visited[jit].append(h["schedules"])
        return st, h
    out["adaptive_mixed"] = graph_form(
        "adaptive (4/8/16 bits, a control step an iteration)",
        adaptive_mixed, n, GQ_KERNELS)
    out["adaptive_mixed"]["schedules"] = visited[True][0]
    print(f"  schedules (graph and eager alike): {visited[True][0]}; "
          f"{len(set(visited[True][0]))} distinct", flush=True)

    def greedy(jit, st):
        return greedy_train(0, X, ds.labels, ds.masks, dims[1],
                            ds.n_classes, (2, 5), n, cfg, device=dev,
                            jit=jit)
    out["greedy"] = graph_form("greedy (2, 5)", greedy, 2 * n, BASE_KERNELS)
    return out


def held(name, kernel, plain, check) -> dict:
    """One kernel call held against its plain version (no timing)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    check(got, want, err)
    print(f"  {name}: err {err:.3e}, held", flush=True)
    return {"shape": name, "max_abs_err": err}


def greedy_kernel_checks(X, h: int, nu: float, rho: float, grid) -> list:
    """The kernels at the shapes greedy growth adds to those of
    ``kernel_phase``: the 5-layer stage's stacked block (x3) and its four
    hidden z-updates, and the 2-layer stage's single [V, h] z-update."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.admm_pgrad import admm_pgrad
    from repro_torch.kernels.backtrack_phi import backtrack_resnorm
    from repro_torch.kernels.fused_linear import fused_linear
    from repro_torch.kernels.quantize_kernel import grid_project
    from repro_torch.kernels.relu_zupdate import relu_zupdate

    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(2)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    V, k = X.shape[0], 3
    p, W, b, z = (rand(k, V, h).relu(), rand(k, h, h, scale=h ** -0.5),
                  rand(k, h), rand(k, V, h))
    u, q = rand(k, V, h), rand(k, V, h).relu()
    d = rand(k, V, h, scale=0.05)
    out = [
        held(f"fused_linear residual x{k} [{V},{h}]@[{h},{h}]",
             lambda: fused_linear(p, W, b, z, mode="residual"),
             lambda: ref.fused_linear_ref(p, W, b, z, mode="residual"),
             matmul_check),
        held(f"admm_pgrad x{k} [{V},{h}]@[{h},{h}]ᵀ",
             lambda: admm_pgrad(z, W, u, p, q, nu=nu, rho=rho),
             lambda: ref.admm_pgrad_ref(z, W, u, p, q, nu=nu, rho=rho),
             matmul_check),
        held(f"backtrack_resnorm x{k} [{V},{h}]@[{h},{h}], all active",
             lambda: backtrack_resnorm(z, d, W, None),
             lambda: ref.backtrack_resnorm_ref(z, d, W, None), resnorm_check),
        held(f"grid_project [{k},{V},{h}]",
             lambda: grid_project(z * 3.0 + 2.0, grid),
             lambda: ref.grid_project_ref(z * 3.0 + 2.0, grid),
             bitwise_check)]
    for shape in ((k + 1, V, h), (V, h)):
        a, qz, z0 = rand(*shape), rand(*shape).relu(), rand(*shape)
        out.append(held(
            "relu_zupdate [" + ",".join(map(str, shape)) + "]",
            lambda a=a, qz=qz, z0=z0: relu_zupdate(a, qz, z0),
            lambda a=a, qz=qz, z0=z0: ref.relu_zupdate_ref(a, qz, z0),
            zupdate_check_for(a, qz, z0)))
    return out


def greedy_stepwise(X, ds, h: int, cfg, schedule, epochs: int) -> dict:
    """Greedy growth with both paths held from one shared state (the kernel
    path's) one iteration at a time (``hold_step``), through each growth;
    the state and noise are drawn as ``greedy_train`` draws them from seed
    0, so this follows its kernel path's trajectory."""
    from repro_torch.core import pdadmm
    from repro_torch.core.greedy import grow
    args = (X, ds.labels, ds.masks["train"])
    gen = torch.Generator().manual_seed(0)
    flips, held_n, it, s = [], 0, 0, None
    for L in schedule:
        dims = [X.shape[1]] + [h] * (L - 1) + [ds.n_classes]
        if s is None:
            s = pdadmm.init_state(gen, X, dims, cfg, device=X.device)
        else:
            s = grow(s, X, dims, cfg, [
                torch.randn((h, h), generator=gen, dtype=torch.float32)
                for _ in range(L - len(s.W))])
        for _ in range(epochs):
            s, ok = hold_step(s, args, cfg, it, flips)
            held_n += ok
            it += 1
    return {"flips": flips, "iterations_held": held_n}


def greedy_phase(X, ds, h: int, cfg, required, label) -> dict:
    """``greedy_train`` at the paper's schedule through the kernels, with
    every launch count set to 0 just before (per stage: the launches since
    the last stage's end, ms per iteration, test accuracy), then with
    ``use_kernels=False``; the objectives at rtol 1e-3, or stepwise from
    shared states where a τ flips."""
    from repro_torch.configs.gamlp_paper import GAMLP
    from repro_torch.core.greedy import greedy_train
    from repro_torch.kernels import ops
    schedule, epochs = tuple(GAMLP.greedy_schedule), GAMLP.epochs // 3
    marks = []

    def stage_end(si, state):
        marks.append(ops.launch_counts())

    ops.reset_launch_counts()
    state, hist = greedy_train(0, X, ds.labels, ds.masks, h, ds.n_classes,
                               schedule, epochs, cfg, device=X.device,
                               callback=stage_end, jit=False)
    counts = ops.launch_counts()
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: "
                             f"{missing}")
    obj = np.asarray(hist["objective"])
    if obj.shape != (len(schedule) * epochs,) or not np.all(np.isfinite(obj)):
        raise AssertionError(f"{label}: objective not finite: {obj}")
    stages = []
    prev = dict.fromkeys(counts, 0)
    for si, L in enumerate(schedule):
        per = {k: marks[si][k] - prev[k] for k in required}
        prev = marks[si]
        stages.append({
            "layers": L, "test_acc": hist["test_acc"][si],
            "val_acc": hist["val_acc"][si],
            "ms_per_iter": hist["stage_seconds"][si] / epochs * 1e3,
            "launches": per,
            "launches_per_iter": {k: v / epochs for k, v in per.items()}})
        print(f"{label}: stage {si} ({L} layers, {epochs} iterations): "
              f"{stages[-1]['ms_per_iter']:.3f} ms per iteration, test "
              f"accuracy {hist['test_acc'][si]:.4f}, launches {per}",
              flush=True)

    cfg_plain = dataclasses.replace(cfg, use_kernels=False)
    _, hist_plain = greedy_train(0, X, ds.labels, ds.masks, h, ds.n_classes,
                                 schedule, epochs, cfg_plain, device=X.device,
                                 jit=False)
    obj_plain = np.asarray(hist_plain["objective"])
    run = {"schedule": list(schedule), "epochs_per_stage": epochs,
           "launches": counts, "iterations": len(obj), "stages": stages,
           "objective": obj.tolist(), "objective_plain": obj_plain.tolist(),
           "test_acc": hist["test_acc"][-1],
           "test_acc_plain": hist_plain["test_acc"][-1],
           "ms_per_iter_plain": [t / epochs * 1e3
                                 for t in hist_plain["stage_seconds"]],
           # how much of the hidden activity survives p's grid: the largest
           # hidden relu(z) and the share of nonzero entries of p[1:]
           "hidden_relu_max": max(float(z.clamp(min=0).max())
                                  for z in state.z[:-1]),
           "p_nonzero": float(sum(int((p != 0).sum()) for p in state.p[1:])
                              / sum(p.numel() for p in state.p[1:]))}
    try:
        np.testing.assert_allclose(obj, obj_plain, rtol=TRAJ_RTOL)
        run["trajectory_check"] = f"rtol {TRAJ_RTOL} over {len(obj)} iterations"
    except AssertionError as e:
        print(f"  {label}: the trajectories part beyond rtol {TRAJ_RTOL} "
              f"({str(e).splitlines()[-1]}); holding both paths from shared "
              f"states instead", flush=True)
        run["stepwise"] = greedy_stepwise(X, ds, h, cfg, schedule, epochs)
        if not run["stepwise"]["flips"]:
            raise AssertionError(f"{label}: the paths part with no τ flip")
        run["trajectory_check"] = "stepwise from shared states"
    print(f"  {label}: {run['trajectory_check']}; ms per iteration, plain "
          f"path, per stage {run['ms_per_iter_plain']}; largest hidden "
          f"relu(z) {run['hidden_relu_max']:.4g}, nonzero share of p "
          f"{run['p_nonzero']:.4f}", flush=True)
    return run


def gd_phase(X, ds, dims) -> dict:
    """The four backprop baselines, 2 x GAMLP.epochs epochs each from one
    seeded init: ms per epoch (host clock, the run ends in a device sync),
    finite losses, test accuracy; no port kernel launches."""
    from repro_torch.configs.gamlp_paper import GAMLP
    from repro_torch.core.gd_baseline import init_mlp, train_gd
    from repro_torch.kernels import ops
    epochs = 2 * GAMLP.epochs
    out = {}
    for method, lr in GD_METHODS:
        params = init_mlp(0, dims, device=X.device)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = train_gd(0, X, ds.labels, ds.masks, dims, method, lr,
                           epochs, device=X.device, params=params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / epochs * 1e3
        loss = np.asarray(hist["loss"])
        if loss.shape != (epochs,) or not np.all(np.isfinite(loss)):
            raise AssertionError(f"{method}: loss not finite: {loss}")
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        if launched:
            raise AssertionError(f"{method}: port kernels launched {launched}")
        out[method] = {"lr": lr, "epochs": epochs, "ms_per_epoch": ms,
                       "loss_first": float(loss[0]),
                       "loss_last": float(loss[-1]),
                       "test_acc": hist["test_acc"], "val_acc": hist["val_acc"]}
        print(f"{method} (lr {lr}): {epochs} epochs, {ms:.3f} ms per epoch, "
              f"loss {loss[0]:.4f} -> {loss[-1]:.4f}, test accuracy "
              f"{hist['test_acc']:.4f}", flush=True)
    return out


def block_phase(X, ds, h: int, nu: float, rho: float,
                n_classes=None) -> dict:
    """block-pdADMM at full width: BLOCK_LAYERS stacked relu(p @ W_l) blocks
    on x0 = relu(X @ W_in), cora's labels and train mask; the CE over
    ``n_classes`` columns (None: all h, the CE route's default);
    BLOCK_ITERS iterations by the CE route (one ``fista_zlast`` launch an
    iteration, on [V, h] rows) and by the generic route, held against each
    other; then ms per iteration of each, in turns."""
    from repro_torch.core.block_admm import init_block_state, make_block_iterate
    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.fista_zlast import route
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(11)
    K0 = X.shape[1]
    C = h if n_classes is None else n_classes
    W_in = torch.randn((K0, h), generator=gen, device=dev) * (2.0 / K0) ** 0.5
    W = torch.randn((BLOCK_LAYERS, h, h), generator=gen, device=dev) \
        * (2.0 / h) ** 0.5
    x0 = (X @ W_in).relu()[None]                      # [B 1, S V, h]
    labels, mask = ds.labels[None], ds.masks["train"][None]

    def block_fn(Wl, p):
        return torch.clamp(p @ Wl, min=0.0)

    def risk_fn(z):
        zc = z.reshape(-1, h)[:, :C]
        logp = torch.log_softmax(zc, dim=-1)
        nll = -logp.gather(-1, labels.reshape(-1, 1).long())[:, 0]
        return (nll * mask.reshape(-1)).sum()

    cfg = ADMMConfig(nu=nu, rho=rho)
    st0 = init_block_state(block_fn, W, x0, BLOCK_LAYERS, cfg, device=dev)
    routes = {
        "ce": make_block_iterate(block_fn, risk_fn, cfg,
                                 fista_iters=FISTA_ITERS, labels=labels,
                                 label_mask=mask, n_classes=n_classes),
        "generic": make_block_iterate(block_fn, risk_fn, cfg,
                                      fista_iters=FISTA_ITERS)}

    def run(it):
        st, objs = st0, []
        for _ in range(BLOCK_ITERS):
            st, m = it(st, x0)
            objs.append(m["objective"])
        return st, [float(o) for o in torch.stack(objs).cpu()]

    ops.reset_launch_counts()
    st_ce, obj_ce = run(routes["ce"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st_gen, obj_gen = run(routes["generic"])
    if counts["fista_zlast"] != BLOCK_ITERS:
        raise AssertionError(f"block CE route: fista_zlast launched "
                             f"{counts['fista_zlast']} times in {BLOCK_ITERS} "
                             f"iterations")
    if not (np.all(np.isfinite(obj_ce)) and np.all(np.isfinite(obj_gen))):
        raise AssertionError(f"block objectives {obj_ce} / {obj_gen}")
    np.testing.assert_allclose(obj_ce, obj_gen, rtol=BLOCK_OBJ_RTOL)
    z_ce, z_gen = st_ce.z[-1], st_gen.z[-1]
    z_err = float((z_ce - z_gen).abs().max())
    z_tol = BLOCK_Z_TOL * float(z_gen.abs().max())
    if not z_err <= z_tol:
        raise AssertionError(f"block z_last: max |CE − generic| {z_err:.3e} "
                             f"> {z_tol:.3e}")
    samples = {"ce": [], "generic": []}
    for name in ("ce", "generic", "generic", "ce"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(routes[name])
        torch.cuda.synchronize()
        samples[name].append((time.perf_counter() - t0) / BLOCK_ITERS * 1e3)
    out = {"layers": BLOCK_LAYERS, "iterations": BLOCK_ITERS,
           "shape": [BLOCK_LAYERS, 1, X.shape[0], h], "classes": C,
           "n_classes_arg": n_classes, "fista_route": route(C),
           "launches": counts, "objective_ce": obj_ce,
           "objective_generic": obj_gen, "z_last_max_abs_err": z_err,
           "z_last_tol": z_tol,
           "ms_per_iter_ce": float(np.mean(samples["ce"])),
           "ms_per_iter_generic": float(np.mean(samples["generic"])),
           "ms_samples": samples}
    print(f"block-pdADMM ({BLOCK_LAYERS} blocks [{X.shape[0]}, {h}], {C} "
          f"classes, fista_zlast route {route(C)}): objective CE {obj_ce}, "
          f"generic {obj_gen}; z_last max "
          f"|Δ| {z_err:.3e} (tolerance {z_tol:.3e}); fista_zlast launches "
          f"{counts['fista_zlast']}; ms per iteration CE "
          f"{out['ms_per_iter_ce']:.3f}, generic "
          f"{out['ms_per_iter_generic']:.3f} ({samples})", flush=True)
    return out


def baseline_phase(X, ds, dims, cfg, runs) -> dict:
    """The paper's comparison methods at cora 10x1000 (module docstring,
    phase 8): the kernels at greedy growth's new shapes, greedy pdADMM-G,
    greedy pdADMM-G-Q on the paper's grid and on an 8-bit calibrated grid,
    the four backprop baselines, block-pdADMM's two routes, and the
    accuracy table."""
    from repro_torch.configs.gamlp_paper import GAMLP
    from repro_torch.core import pdadmm
    from repro_torch.core.quantize import integer_grid
    h = dims[1]
    grid_paper = integer_grid(min(GAMLP.quant_levels), max(GAMLP.quant_levels))
    grid8 = pdadmm.calibrate_grid(0, X, [X.shape[1], h, ds.n_classes], 8)
    out = {"kernel_checks": greedy_kernel_checks(X, h, cfg.nu, cfg.rho,
                                                 grid_paper)}
    out["greedy_G"] = greedy_phase(X, ds, h, cfg, BASE_KERNELS,
                                   "greedy pdADMM-G")
    for key, grid, label in (
            ("greedy_GQ_paper", grid_paper, "greedy pdADMM-G-Q, Δ = {-1..20}"),
            ("greedy_GQ_8bit", grid8,
             f"greedy pdADMM-G-Q, 8-bit grid [{grid8.lo:.4g}, "
             f"{grid8.hi:.4g}]")):
        cfg_q = dataclasses.replace(cfg, quantize_p=True, quantize_q=False,
                                    grid=grid)
        out[key] = greedy_phase(X, ds, h, cfg_q, GQ_KERNELS, label)
    out["grid8"] = dataclasses.asdict(grid8)
    out["gd"] = gd_phase(X, ds, dims)
    out["block"] = block_phase(X, ds, h, cfg.nu, cfg.rho, ds.n_classes)
    out["block_d"] = block_phase(X, ds, h, cfg.nu, cfg.rho)

    no_growth = runs["ft"]["paper_gq"]["test_acc"]
    table = {m: out["gd"][m]["test_acc"] for m, _ in GD_METHODS}
    table.update({k: out[k]["test_acc"] for k in
                  ("greedy_G", "greedy_GQ_paper", "greedy_GQ_8bit")})
    out["accuracy_table"] = table
    print("accuracy on cora, 10x1000 (test): " + ", ".join(
        f"{k} {v:.4f}" for k, v in table.items()), flush=True)
    print(f"  G-Q on Δ = {{-1..20}}: greedy {table['greedy_GQ_paper']:.4f} "
          f"after {len(out['greedy_GQ_paper']['objective'])} iterations; "
          f"without growth {no_growth[f'GQ_paper_{GAMLP.epochs}']:.4f} after "
          f"{GAMLP.epochs} (ft (e), this run)", flush=True)
    return out


def timed_ms(fn, n: int) -> float:
    """Mean host-clock ms of ``n`` calls after one warm-up, each run ending
    in a device sync."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def greedy(bundle, params, cache, logits, n: int, start: int,
           pos_next=None, jit=None, record=None):
    """``n`` greedy tokens with ``serve_step`` from a prefill's cache and
    logits at positions start, start + 1, ...; the VLM's token t at the 3-D
    positions ``pos_next + t``. ``jit`` (default: where the package has
    it) replays the engine's captured step
    (``serve.engine.decode_program``: the cache adopted as its buffers, or
    copied into them; each step's tokens read on the host, as the engine
    reads them), else the eager step writes ``cache`` in place and the
    tokens stay on the card. Returns the tokens [B, n] on the card;
    ``record`` (a dict) gets each step's logits and the program."""
    from repro_torch.serve import engine
    vocab = bundle.cfg.vocab
    tok = logits[..., :vocab].argmax(-1).to(torch.int32)
    if jit is None:
        jit = hasattr(engine, "decode_program")
    steps = [] if record is None else record.setdefault("logits", [])
    out = []
    if jit:
        batch = {"token": tok}
        if pos_next is not None:
            batch["positions"] = pos_next
        prog = engine.decode_program(bundle, params, cache, batch)
        if record is not None:
            record["program"] = prog
        for t in range(n):
            tok = prog.step(tok, start + t,
                            None if pos_next is None else pos_next + t)
            tok = tok[:, None]
            out.append(tok)
            if record is not None:
                steps.append(prog.logits.clone())
        return torch.from_numpy(np.concatenate(out, axis=1)).to(
            logits.device)
    for t in range(n):
        batch = {"token": tok}
        if pos_next is not None:
            batch["positions"] = pos_next + t
        logits, cache = bundle.serve_step(params, cache, batch,
                                          length=start + t)
        tok = logits[..., :vocab].argmax(-1).to(torch.int32)
        out.append(tok)
        if record is not None:
            steps.append(logits.clone())
    return torch.cat(out, dim=1)


def engine_run(bundle, params) -> dict:
    """``ServingEngine`` on 7 requests of 3-token prompts on 4 slots, 12 new
    tokens each (``examples/serve_lm.py``'s), every token in the vocab, in
    both forms: the eager step (``jit=False``) and the captured one (the
    default on the card: one capture when the engine is made, its ms kept
    apart, one replay a step), with the same tokens."""
    from repro_torch.core import graphs
    from repro_torch.serve.engine import Request, ServingEngine
    res = {"requests": 7, "slots": 4}
    done = {}
    for jit in (False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine = ServingEngine(bundle, params, slots=4, max_len=128,
                               jit=None if jit else False)
        torch.cuda.synchronize()
        made = time.perf_counter() - t
        if (engine.program is not None) != jit:
            raise AssertionError(f"engine: jit={jit} made program "
                                 f"{engine.program}")
        reqs = [Request(rid=i, prompt=[10 + i, 20 + i, 30 + i], max_new=12)
                for i in range(7)]
        # a program the bundle already holds at these shapes is reused
        # (mamba2's state has no length: decode_graph's program serves)
        mine = 0 if engine.program is None else engine.program.replays
        replays, calls, step = graphs.replays, [], engine.step
        engine.step = lambda: (calls.append(1), step())
        t = time.perf_counter()
        done[jit] = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = len(calls)
        del engine.step     # the counter's cycle would keep the engine
        form = "graph" if jit else "eager"
        print(f"  engine ({form}): 7 requests on 4 slots in {wall:.3f} s "
              f"(made in {made * 1e3:.1f} ms): {done[jit]}", flush=True)
        for rid, toks in done[jit].items():
            if len(toks) != 12 or not all(0 <= x < bundle.cfg.vocab
                                          for x in toks):
                raise AssertionError(f"engine: request {rid} got {toks}")
        res[form] = {"wall_s": wall, "made_ms": made * 1e3}
        if jit:
            res[form]["replays"] = graphs.replays - replays
            if engine.program.replays - mine != steps or \
                    res[form]["replays"] != steps:
                raise AssertionError(f"engine: {res[form]['replays']} "
                                     f"replays for {steps} steps")
        del engine
    if done[True] != done[False]:
        raise AssertionError(f"engine: the graph's tokens {done[True]} are "
                             f"not the eager engine's {done[False]}")
    res["wall_s"] = res["graph"]["wall_s"]
    res["tokens"] = {str(k): v for k, v in done[True].items()}
    return res


def demangled(name: str) -> str:
    """A kernel's name as the profiler's traces give it: a mangled name
    (the CUDA driver's) through the C++ runtime's ``__cxa_demangle``, which
    CUPTI's traces pass it through too; any other name as it is."""
    import ctypes
    if not name.startswith("_Z"):
        return name
    cxa = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    cxa.restype = ctypes.c_void_p
    cxa.argtypes = (ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int))
    status = ctypes.c_int()
    ptr = cxa(name.encode(), None, None, ctypes.byref(status))
    if status.value or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(ptr))


def traced_kernels(run_once, reset) -> collections.Counter:
    """The kernels one ``run_once()`` launches on the card, by name, from
    a torch.profiler trace (copies and fills by the runtime left out).
    A trace drops the first kernels of its window now and then (on an
    H100, with a spin kernel ahead of them or not), so the window runs
    ``reset()``, a marker, ``run_once()`` twice and a marker last (the
    marker a short ``torch.cuda._sleep``, ``spin_kernel``), and the
    count is of the kernels between the last two markers in the order
    they ran on the one stream: the second run alone. Empty where a
    marker is missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            reset()
            torch.cuda._sleep(TRACE_MARK_CYCLES)
            run_once()
        torch.cuda._sleep(TRACE_MARK_CYCLES)
        torch.cuda.synchronize()
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and not ev.name.startswith(("Memcpy", "Memset"))),
                     key=lambda ev: ev.time_range.start)
    marks = [i for i, ev in enumerate(kernels) if "spin_kernel" in ev.name]
    if len(marks) < 2:
        return collections.Counter()
    return collections.Counter(ev.name for ev in
                               kernels[marks[-2] + 1:marks[-1]])


def decode_graph(label, bundle, params, state, logits, start: int,
                 pos_next=None) -> dict:
    """The compiled decode against the eager one (the module docstring,
    phase 9d): DECODE_GRAPH_TOKENS greedy tokens from copies of ``state``
    at ``start`` (the VLM at ``pos_next + t``) by ``greedy`` in each form.
    Held: tokens, every step's logits and the final state bit for bit, one
    replay a token, the graph's kernel nodes (from the CUDA driver) equal
    by name to the kernels the program's body launches run eagerly (a
    profiler trace of one body, taken again up to PROFILE_TRIES times)
    and so, × replays, to the eager launches of the run. Recorded: the
    capture's ms (two eager warm-ups, the second under sync-debug
    "error", then the capture), ms per token in DECODE_GRAPH_TURNS
    (medians), each form's peak MiB, and a profile of each form (device
    busy ms, idle share, host CUDA API calls a token)."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.core import graphs
    from repro_torch.serve.engine import decode_program
    n = DECODE_GRAPH_TOKENS
    vocab = bundle.cfg.vocab

    def copy():
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else x, state)

    def tensors(tree):
        return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]

    res = {"tokens": n, "batch": int(logits.shape[0]), "start": start}
    rec = {False: {}, True: {}}
    toks, peak, above = {}, {}, {}
    s_eager, s_graph = copy(), copy()
    toks[False], peak[False], above[False] = peak_of(lambda: greedy(
        bundle, params, s_eager, logits, n, start, pos_next, False,
        rec[False]))
    batch = {"token": toks[False][:, :1].to(torch.int32)}
    if pos_next is not None:
        batch["positions"] = pos_next
    graphs.debug_programs.clear()
    graphs.debug = True             # the capture keeps its nodes
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        prog = decode_program(bundle, params, s_graph, batch)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t) * 1e3
        capture_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    finally:
        graphs.debug = False
        graphs.debug_programs.clear()
    del s_graph
    replays = prog.replays
    toks[True], peak[True], above[True] = peak_of(lambda: greedy(
        bundle, params, prog.state, logits, n, start, pos_next, True,
        rec[True]))
    if rec[True]["program"] is not prog or prog.replays - replays != n:
        raise AssertionError(f"decode graph {label}: "
                             f"{prog.replays - replays} replays for {n} "
                             f"tokens (or a new program)")
    if not torch.equal(toks[True], toks[False]):
        raise AssertionError(f"decode graph {label}: tokens {toks[True]} "
                             f"against eager {toks[False]}")
    for i, (a, b) in enumerate(zip(rec[True]["logits"], rec[False]["logits"],
                                   strict=True)):
        if not torch.equal(a, b):
            d = float((a - b).abs().max())
            raise AssertionError(f"decode graph {label}: step {i}'s logits "
                                 f"differ from eager's by max |Δ| {d:.3e}")
    for i, (a, b) in enumerate(zip(tensors(prog.state), tensors(s_eager),
                                   strict=True)):
        if not torch.equal(a, b):
            raise AssertionError(f"decode graph {label}: state leaf {i} "
                                 f"{tuple(a.shape)} differs from eager's")
    if bool((toks[True] < 0).any()) or bool((toks[True] >= vocab).any()):
        raise AssertionError(f"decode graph {label}: a token outside the "
                             f"vocab")
    del rec
    nodes = collections.Counter(demangled(k) for k in graph_kernel_names(
        prog.program.graph))
    for attempt in range(PROFILE_TRIES):
        eager = traced_kernels(lambda: prog.program.step(prog._fn,
                                                         eager=True),
                               prog.program.row.zero_)
        if eager == nodes:
            break
    else:
        raise AssertionError(
            f"decode graph {label}: the graph's kernel nodes and the body's "
            f"eager launches differ in {PROFILE_TRIES} traces: nodes only "
            f"{dict(nodes - eager)}, eager only {dict(eager - nodes)}")
    res.update(capture_ms=capture_ms, capture_above_mib=capture_peak,
               sync_debug="error", replays=n,
               nodes_per_replay=sum(nodes.values()),
               node_launches=sum(nodes.values()) * n,
               kernel_names=len(nodes), traces_taken=attempt + 1)
    states = {True: prog.state, False: s_eager}
    samples = {True: [], False: []}

    def run(jit):
        return greedy(bundle, params, states[jit], logits, n, start,
                      pos_next, jit)
    for jit in DECODE_GRAPH_TURNS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(jit)
        torch.cuda.synchronize()
        samples[jit].append((time.perf_counter() - t) / n * 1e3)
    for jit in (True, False):
        r = res["graph" if jit else "eager"] = {
            "ms_per_token_samples": samples[jit],
            "ms_per_token": float(np.median(samples[jit])),
            "peak_mib": peak[jit], "above_mib": above[jit]}
        r["profile"] = graph_profile(f"decode {label}", lambda jit=jit:
                                     run(jit), n, r["ms_per_token"])
    g, e = res["graph"], res["eager"]
    print(f"decode graph {label}: {n} tokens at B {res['batch']} from "
          f"{start}, bitwise equal to eager (tokens, logits, state), "
          f"{n} replays; {res['nodes_per_replay']} kernel nodes a replay "
          f"({res['kernel_names']} names) = the body's eager launches "
          f"(trace {res['traces_taken']}); capture {capture_ms:.1f} ms "
          f"(+{capture_peak:.1f} MiB)", flush=True)
    for name, r in (("graph", g), ("eager", e)):
        p = r["profile"]
        busy = ("not measured" if p["device_busy_ms"] is None else
                f"{p['device_busy_ms']:.3f}")
        idle = ("not measured" if p["idle_share"] is None else
                f"{p['idle_share']:.3f}")
        print(f"  {name}: ms per token {r['ms_per_token']:.3f} (turns "
              f"{[round(x, 3) for x in r['ms_per_token_samples']]}); device "
              f"busy {busy} ms, idle share {idle}, host CUDA API calls "
              f"{p['api_calls']:.1f} a token; peak {r['peak_mib']:.1f} MiB "
              f"({r['above_mib']:.1f} above the base)", flush=True)
    return res


def phi3_phase(dev) -> dict:
    """phi3-mini-3.8b at its published widths and PHI3_LAYERS of its
    layers (module docstring, phase 9d): a prefill of LM_BATCH ×
    LM_PROMPT tokens (finite logits), its K/V quantized into the config's
    int8 ``KVCacheQ`` (``cache_update_q`` per layer, as decode writes
    it), then ``decode_graph`` from that cache, and the engine in both
    forms."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.models import layers as L
    from repro_torch.models.api import build
    cfg = dataclasses.replace(get_arch(PHI3_ARCH), n_layers=PHI3_LAYERS)
    bundle = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    max_len = LM_PROMPT + DECODE_GRAPH_TOKENS
    print(f"LM phi3: {cfg.name} at {cfg.n_layers} of "
          f"{get_arch(PHI3_ARCH).n_layers} layers, {bundle.n_params():,} "
          f"parameters, int8 KV cache", flush=True)
    out = {"layers": cfg.n_layers, "n_params": bundle.n_params()}
    with torch.inference_mode():
        logits, kv = bundle.prefill(params, {"tokens": tokens}, max_len)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("phi3 prefill: logits not finite")
        state = bundle.serve_state_shape(ShapeConfig(
            "decode", max_len, LM_BATCH, "decode"))
        if not isinstance(state, L.KVCacheQ):
            raise AssertionError(f"phi3: the decode state is {type(state)}")
        for i in range(cfg.n_layers):
            L.cache_update_q(L.KVCacheQ(state.k[i], state.v[i],
                                        state.k_scale[i], state.v_scale[i],
                                        0),
                             kv.k[i, :, :LM_PROMPT], kv.v[i, :, :LM_PROMPT])
        del kv
        state = state._replace(length=LM_PROMPT)
        out["decode_graph"] = decode_graph(cfg.name, bundle, params, state,
                                           logits, LM_PROMPT)
        del state, logits
    out["engine"] = engine_run(bundle, params)
    return {"LM_phi3": out}


def lm_vs_f32(cfg, dev, bundle, plain, params, batch, max_len,
              pin_routes: bool = False) -> dict:
    """Each bf16 prefill's relative L2 distance to the same prefill in f32
    through the plain attention: of the last-position logits, and of the
    last layer's K and V at every prompt position (which every earlier
    layer's attention at every position feeds). The kernel path may lie no
    farther than LM_VS_F32 times the plain path on either; two wrong
    attentions on the kernel path (without its causal mask; without the
    last 64-key tile) must break the limit on one. ``pin_routes`` (MoE):
    every bf16 prefill routes each token to the f32 prefill's experts
    (``route_log``), so that the rule compares continuous noise and not
    which near-tied picks flipped."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build
    from repro_torch.models.common import tree_map

    S = batch["tokens"].shape[1]

    def readout(logits, cache):
        return logits, torch.cat([cache.k[-1, :, :S].float().flatten(),
                                  cache.v[-1, :, :S].float().flatten()])

    params32 = tree_map(lambda t: t.float(), params)
    with route_log() as f32_picks:
        ref = readout(*build(cfg, device=dev, dtype=torch.float32,
                             use_kernels=False).prefill(params32, batch, S))
    del params32
    real = ops.flash_attention
    wrong = {"mask off": lambda q, k, v, **kw: real(
                 q, k, v, **{**kw, "causal": False}),
             "last key tile dropped": lambda q, k, v, **kw: real(
                 q, k[:, :-64], v[:, :-64], **kw)}
    runs = {"kernels": lambda: bundle.prefill(params, batch, max_len),
            "plain": lambda: plain.prefill(params, batch, max_len)}
    for name, fn in wrong.items():
        def control(fn=fn):
            ops.flash_attention = fn
            try:
                return bundle.prefill(params, batch, max_len)
            finally:
                ops.flash_attention = real
        runs[f"control: {name}"] = control
    out = {}
    for name, run in runs.items():
        with route_log(pin=f32_picks if pin_routes else None):
            got = readout(*run())
        out[name] = {part: float((g - w).norm() / w.norm())
                     for part, g, w in zip(("logits", "last_layer_kv"),
                                           got, ref)}
        print(f"  relative L2 to the f32 prefill (plain attention), {name}: "
              f"logits {out[name]['logits']:.4e}, last layer's K/V "
              f"{out[name]['last_layer_kv']:.4e}", flush=True)
    limit = {part: LM_VS_F32 * out["plain"][part] for part in out["plain"]}
    for name, r in out.items():
        broken = [part for part in limit if not r[part] <= limit[part]]
        if name == "kernels" and broken:
            raise AssertionError(f"prefill: the kernel path is farther from "
                                 f"f32 than {LM_VS_F32} x the plain path's "
                                 f"({', '.join(broken)}): {r}")
        if name.startswith("control") and not broken:
            raise AssertionError(f"prefill: the check passes the {name}")
    return out


def lm_phase(dev, cfg):
    """The dense LM ``cfg`` (tinyllama-1.1b at full width) served on
    ``dev`` (see the module docstring, phase 9)."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build

    bundle = build(cfg, device=dev)
    plain = build(cfg, device=dev, use_kernels=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    max_len = LM_PROMPT + LM_DECODE
    n_tok = LM_BATCH * LM_PROMPT
    print(f"LM: {cfg.name}, {bundle.n_params():,} parameters "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card), "
          f"{LM_BATCH} prompts of {LM_PROMPT} tokens, max_len {max_len}",
          flush=True)
    out = {}
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits, cache = bundle.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"  prefill launches {counts}", flush=True)
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill: flash_attention launched "
                                 f"{counts['flash_attention']} times, not "
                                 f"once per layer ({cfg.n_layers})")
        if logits.shape != (LM_BATCH, 1, bundle.vocab_padded) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits: shape "
                                 f"{tuple(logits.shape)} or not finite")
        logits_p, cache_p = plain.prefill(params, batch, max_len)
        d = logits - logits_p
        rel_l2 = float(d.norm() / logits_p.norm())
        max_d = float(d.abs().max())
        print(f"  vs the plain attention on the card: max |Δlogit| "
              f"{max_d:.4e} (logits up to {float(logits_p.abs().max()):.4f}),"
              f" relative L2 {rel_l2:.4e}", flush=True)
        if not rel_l2 <= LM_REL_L2:
            raise AssertionError(f"prefill: relative L2 {rel_l2:.3e} of the "
                                 f"logits > {LM_REL_L2}")
        vs32 = lm_vs_f32(cfg, dev, bundle, plain, params, batch, max_len)
        ms = timed_ms(lambda: bundle.prefill(params, batch, max_len), 3)
        ms_plain = timed_ms(lambda: plain.prefill(params, batch, max_len), 2)
        print(f"  ms per prefill: kernels {ms:.3f} ({n_tok / ms * 1e3:.0f} "
              f"tokens/s)  plain {ms_plain:.3f}", flush=True)
        prof = profile_phase("prefill", lambda: bundle.prefill(
            params, batch, max_len), ms)
        out["LM_prefill"] = {
            "launches": counts, "iterations": 1, "ms": ms,
            "ms_plain": ms_plain, "tokens_per_s": n_tok / ms * 1e3,
            "max_abs_dlogit": max_d, "rel_l2": rel_l2,
            "rel_l2_to_f32": vs32, "profile": prof}

        greedy(bundle, params, cache, logits, LM_DECODE, LM_PROMPT,
               jit=False)                                    # warm
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = greedy(bundle, params, cache, logits, LM_DECODE, LM_PROMPT,
                      jit=False)
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t) / LM_DECODE * 1e3
        dcounts = ops.launch_counts()
        toks_p = greedy(plain, params, cache_p, logits_p, LM_DECODE,
                        LM_PROMPT, jit=False)
        agree = int((toks == toks_p).sum())
        print(f"  decode: {LM_DECODE} greedy tokens at B {LM_BATCH}, "
              f"{ms_tok:.3f} ms per token; launches {dcounts}; kernel and "
              f"plain paths agree on {agree} of {toks.numel()} tokens",
              flush=True)
        if bool((toks < 0).any()) or bool((toks >= cfg.vocab).any()):
            raise AssertionError("decode: a token outside the vocab")
        if dcounts["flash_attention"] != 0:
            raise AssertionError("decode launched flash_attention")
        step_len = [LM_PROMPT]

        def decode_once():
            bundle.serve_step(params, cache, {"token": toks[:, :1]},
                              length=step_len[0])
        dprof = profile_phase("decode step", decode_once, ms_tok)
        out["LM_decode"] = {"launches": dcounts, "iterations": LM_DECODE,
                            "ms_per_token": ms_tok, "tokens_agree": agree,
                            "tokens": toks.numel(), "profile": dprof}
        out["LM_decode_graph"] = decode_graph(cfg.name, bundle, params,
                                              cache, logits, LM_PROMPT)
        del cache, cache_p, logits_p

    out["LM_engine"] = engine_run(bundle, params)
    return out


class route_log:
    """Context manager over ``models.layers._router`` (the MoE's router,
    called once per MoE layer in order): it records each call's picks in
    the list it yields; with ``pin`` (such a list) call i takes pin[i]'s
    picks instead, with the weights and the aux loss its own probabilities
    give them. A model without a router leaves the list empty."""

    def __init__(self, pin=None):
        self.pin, self.picks = pin, []

    def __enter__(self):
        import torch.nn.functional as F
        from repro_torch.models import layers
        self.real = real = layers._router
        pinned = iter(self.pin) if self.pin is not None else None

        def router(x, w, k):
            probs, idx, top, aux, kmask = real(x, w, k)
            if pinned is not None:
                idx = next(pinned)
                kmask = layers._one_hot(idx, w.shape[-1])
                top = probs.gather(-1, idx)
                top = top / top.sum(dim=-1, keepdim=True)
                ce = F.one_hot(idx[..., 0], w.shape[-1]).float().mean(
                    dim=(0, 1))
                aux = w.shape[-1] * torch.sum(probs.mean(dim=(0, 1)) * ce)
            self.picks.append(idx)
            return probs, idx, top, aux, kmask
        layers._router = router
        return self.picks

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._router = self.real


def route_report(cfg, picks, other=None) -> dict:
    """Per MoE layer of one prefill (``route_log``'s picks, [groups, g, K]
    each): the picks dropped at capacity (arrived after C others at their
    expert), those of the last expert, and with ``other`` (another path's
    picks of the same prefill) the share of (token, k) picks that both
    paths made (as sets: a near-tie that swaps order inside the top K
    changes nothing)."""
    from repro_torch.models import layers
    out = {"dropped": [], "dropped_last_expert": [], "agree": []}
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    for i, idx in enumerate(picks):
        C = layers._capacity(idx.shape[1], K, E, cfg.moe.capacity_factor)
        emask, pos = layers._arrivals(layers._one_hot(idx, E))
        dropped = (emask > 0) & (pos >= C)
        out["dropped"].append(int(dropped.sum()))
        out["dropped_last_expert"].append(int(dropped[..., E - 1].sum()))
        if other is not None:
            same = (idx[..., :, None] == other[i][..., None, :]).any(-1)
            out["agree"].append(float(same.float().mean()))
    out["capacity"] = layers._capacity(picks[0].shape[1], K, E,
                                       cfg.moe.capacity_factor)
    out["picks_per_layer"] = int(picks[0].numel())
    return out


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def vlm_positions(B, n_text, grid, device):
    """[B, 2·n_text + grid², 3] int32 M-RoPE positions (t, h, w): text with
    t = h = w = its index, one image block of grid × grid patches at t =
    n_text with h and w from n_text across the grid, then text from
    n_text + grid (the block's largest position + 1)."""
    text = torch.arange(n_text, device=device)
    hh, ww = torch.meshgrid(torch.arange(grid, device=device),
                            torch.arange(grid, device=device), indexing="ij")
    image = torch.stack([torch.full((grid * grid,), n_text, device=device),
                         n_text + hh.flatten(), n_text + ww.flatten()], -1)
    tail = n_text + grid + text
    pos = torch.cat([text[:, None].expand(n_text, 3), image,
                     tail[:, None].expand(n_text, 3)])
    return pos.to(torch.int32)[None].expand(B, -1, -1).contiguous()


def decode_bytes(bundle, picks, n_steps: int) -> tuple:
    """Bytes of weights a decode step must read, two floors, the embedding
    row and the decode state left out: the einsum dispatch's (every block
    weight, of whisper's decoder all but the cross K/V projections, and the
    head: each decode token is its own group of C = 8 slots, so every
    expert runs), and the function's own
    (the experts the step's tokens pick in each MoE layer, the other
    weights and the head), averaged over ``n_steps`` steps of
    ``route_log``'s ``picks`` (a layer's call per entry; none for a model
    without experts, where the two agree)."""
    from repro_torch.models.common import leaves
    specs = bundle.param_specs()
    head = specs.get("head", specs["embed"])
    total = math.prod(head.shape) * head.dtype.itemsize
    expert_bytes, n_experts = 0, 0    # over every (MoE layer, expert)
    blocks = {k: v for k, v in specs.items() if k in ("blocks", "decoder")}
    for path, s in leaves(blocks):
        if path[-1] in ("x_wk", "x_wv"):   # whisper's: the cross K/V's
            continue
        total += math.prod(s.shape) * s.dtype.itemsize
        if s.axes[1] == "experts":
            expert_bytes += math.prod(s.shape) * s.dtype.itemsize
            if path[-1] == "w_gate_e":
                n_experts += s.shape[0] * s.shape[1]
    if not n_experts:
        return total, total
    picked = sum(int(torch.unique(idx).numel()) for idx in picks) / n_steps
    return total, total - (n_experts - picked) * expert_bytes / n_experts


def family_prefill(dev, cfg, bundle, plain, params, batch, max_len) -> dict:
    """One config's prefill, its launches, the kernel path against the plain
    one and against f32, timed and profiled (see the module docstring,
    phase 9b)."""
    from repro_torch.kernels import ops
    moe = cfg.moe is not None
    n_tok = batch["tokens"].numel()
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with route_log() as picks:
        logits, cache = bundle.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"  prefill launches {counts}; peak allocated "
          f"{out['peak_mib']:.1f} MiB", flush=True)
    if counts["flash_attention"] != cfg.n_layers or any(
            n for k, n in counts.items() if k != "flash_attention"):
        raise AssertionError(f"prefill: launches {counts}, not "
                             f"flash_attention once per layer "
                             f"({cfg.n_layers})")
    if logits.shape != (batch["tokens"].shape[0], 1, bundle.vocab_padded) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} "
                             f"or not finite")
    with route_log() as picks_p:
        logits_p, cache_p = plain.prefill(params, batch, max_len)
    out["rel_l2_vs_plain"] = rel_l2(logits, logits_p)
    out["max_abs_dlogit"] = float((logits - logits_p).abs().max())
    print(f"  vs the plain attention on the card: max |Δlogit| "
          f"{out['max_abs_dlogit']:.4e}, relative L2 "
          f"{out['rel_l2_vs_plain']:.4e}", flush=True)
    if moe:
        r = route_report(cfg, picks, picks_p)
        out["routes"] = r
        print(f"  routes (C {r['capacity']}, {r['picks_per_layer']} picks "
              f"a layer): kernel and plain paths share "
              f"{min(r['agree']):.5f}-{max(r['agree']):.5f} of the picks "
              f"per layer (mean {sum(r['agree']) / len(r['agree']):.5f}); "
              f"dropped per layer {r['dropped']} (of the last expert "
              f"{r['dropped_last_expert']})", flush=True)
    out["launches"] = counts
    return out, (logits, cache, logits_p, cache_p, picks)


def family_decode(dev, cfg, bundle, plain, params, pre, n_prompt,
                  pos_next=None) -> dict:
    """LM_DECODE greedy tokens from the prefill's cache on both paths (the
    VLM at 3-D positions ``pos_next + t``), the kernel path timed, its
    launches (none), ``decode_bytes``' two floors over the card's memory
    rate, and a profile of one step."""
    from repro_torch.kernels import ops
    logits, cache, logits_p, cache_p = pre
    vocab = cfg.vocab

    def run(b, c, lg):
        return greedy(b, params, c, lg, LM_DECODE, n_prompt, pos_next,
                      jit=False)

    with route_log() as picks:            # warm-up; the timed run repeats it
        run(bundle, cache, logits)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    toks = run(bundle, cache, logits)
    torch.cuda.synchronize()
    ms_tok = (time.perf_counter() - t) / LM_DECODE * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    toks_p = run(plain, cache_p, logits_p)
    agree = int((toks == toks_p).sum())
    floor_einsum, floor = (n / PEAK_BYTES_PER_S * 1e3 for n in
                           decode_bytes(bundle, picks, LM_DECODE))
    print(f"  decode: {LM_DECODE} greedy tokens at B {toks.shape[0]}, "
          f"{ms_tok:.3f} ms per token (floors: the einsum dispatch's, every "
          f"weight read once, {floor_einsum:.3f} ms; the function's own, "
          f"the experts the steps pick, {floor:.3f} ms); peak {peak:.1f} "
          f"MiB; launches {counts}; "
          f"kernel and plain paths agree on {agree} of {toks.numel()} "
          f"tokens", flush=True)
    if bool((toks < 0).any()) or bool((toks >= vocab).any()):
        raise AssertionError("decode: a token outside the vocab")
    if any(counts.values()):
        raise AssertionError(f"decode launched a port kernel: {counts}")
    batch = {"token": toks[:, :1]}
    if pos_next is not None:
        batch["positions"] = pos_next
    prof = profile_phase(f"{cfg.name} decode step", lambda: bundle.serve_step(
        params, cache, batch, length=n_prompt), ms_tok)
    return {"ms_per_token": ms_tok, "einsum_floor_ms": floor_einsum,
            "floor_ms": floor, "peak_mib": peak,
            "launches": counts, "tokens_agree": agree,
            "tokens": toks.numel(), "profile": prof,
            "graph": decode_graph(cfg.name, bundle, params, cache, logits,
                                  n_prompt, pos_next)}


def family_gather(cfg, bundle, params, batch, max_len, picks) -> dict:
    """The prefill at ``moe_impl="gather"`` against the einsum dispatch's:
    in bf16 (``picks``: the einsum prefill's) finite under capacity drops,
    the share of picks the two make, both timed; and in f32, with every
    token routed to the f32 einsum prefill's experts, the logits and the
    last layer's K/V within FAMILY_GATHER_F32_REL of it."""
    from repro_torch.models.api import build
    from repro_torch.models.common import tree_map
    gather = build(cfg, device=bundle.device, moe_impl="gather")
    with route_log() as picks_g:
        lg, cg = gather.prefill(params, batch, max_len)
    r = route_report(cfg, picks, picks_g)
    if not sum(r["dropped"]):
        raise AssertionError("gather: no pick was dropped, so the repair "
                             "of a dropped pick is not exercised")
    if not bool(torch.isfinite(lg).all()) or not bool(
            torch.isfinite(cg.k).all()):
        raise AssertionError("gather: the bf16 prefill is not finite")
    del lg, cg
    out = {"agree": r["agree"], "dropped": r["dropped"],
           "dropped_last_expert": r["dropped_last_expert"],
           "ms": timed_ms(lambda: gather.prefill(params, batch, max_len), 3)}
    params32 = tree_map(lambda t: t.float(), params)
    S = batch["tokens"].shape[1]
    with route_log() as picks32:
        le, ce = build(cfg, device=bundle.device, dtype=torch.float32
                       ).prefill(params32, batch, S)
    with route_log(pin=picks32):
        lg, cg = build(cfg, device=bundle.device, dtype=torch.float32,
                       moe_impl="gather").prefill(params32, batch, S)
    del params32
    r32 = route_report(cfg, picks32)
    out.update({
        "f32_dropped": r32["dropped"],
        "f32_rel_l2_logits": rel_l2(lg, le),
        "f32_rel_l2_last_layer_kv": rel_l2(torch.cat([cg.k[-1], cg.v[-1]]),
                                           torch.cat([ce.k[-1], ce.v[-1]])),
        "f32_finite": bool(torch.isfinite(lg).all())
        and bool(torch.isfinite(cg.k).all())})
    del lg, cg, le, ce
    print(f"  gather dispatch: bf16 finite with {sum(r['dropped'])} dropped "
          f"picks ({sum(r['dropped_last_expert'])} of the last expert), "
          f"sharing {sum(r['agree']) / len(r['agree']):.5f} of einsum's "
          f"picks, {out['ms']:.3f} ms per prefill; f32 at einsum's picks "
          f"({sum(r32['dropped'])} dropped): relative L2 logits "
          f"{out['f32_rel_l2_logits']:.4e}, last layer's K/V "
          f"{out['f32_rel_l2_last_layer_kv']:.4e}", flush=True)
    if not out["f32_finite"]:
        raise AssertionError("gather: the f32 prefill is not finite")
    for key in ("f32_rel_l2_logits", "f32_rel_l2_last_layer_kv"):
        if not out[key] <= FAMILY_GATHER_F32_REL:
            raise AssertionError(f"gather against einsum: {key} "
                                 f"{out[key]:.3e} > {FAMILY_GATHER_F32_REL}")
    return out


def family_mrope(cfg, params, batch, max_len, dev) -> dict:
    """qwen2-vl with t = h = w = token index against the same weights with
    ``mrope_sections=None`` (plain RoPE at the index): the reference's
    invariant, logits within FAMILY_MROPE_REL (both the kernel path)."""
    from repro_torch.models.api import build
    B, S = batch["tokens"].shape
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None, :, None]
    lm, cm = build(cfg, device=dev).prefill(
        params, {**batch, "positions": pos.expand(B, S, 3).contiguous()},
        max_len)
    rope = dataclasses.replace(cfg, mrope_sections=None)
    lr, cr = build(rope, device=dev).prefill(
        params, {"tokens": batch["tokens"]}, max_len)
    out = {"rel_l2_logits": rel_l2(lm, lr),
           "rel_l2_k": rel_l2(cm.k, cr.k), "bitwise": bool(
               torch.equal(lm, lr) and torch.equal(cm.k, cr.k))}
    print(f"  M-RoPE at t = h = w against RoPE: relative L2 logits "
          f"{out['rel_l2_logits']:.4e}, K {out['rel_l2_k']:.4e}, the same "
          f"bits {out['bitwise']}", flush=True)
    if not out["rel_l2_logits"] <= FAMILY_MROPE_REL:
        raise AssertionError(f"M-RoPE: {out}")
    return out


def family_train(dev, cfg) -> dict:
    """granite-moe trained with ``Trainer.run`` (see the module docstring,
    phase 9b): FAMILY_TRAIN_STEPS steps of FAMILY_TRAIN_BATCH sequences of
    TRAIN_SEQ tokens in FAMILY_TRAIN_MICRO microbatches, adamw(TRAIN_LR),
    remat, the depth cut to FAMILY_TRAIN_LAYERS. The trainer's checkpoint
    of the last step is skipped (lm_train_phase times a save)."""
    import tempfile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(cfg, n_layers=FAMILY_TRAIN_LAYERS)
    bundle = build(cfg, device=dev)
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, FAMILY_TRAIN_BATCH, device=dev)
    n_tok = TRAIN_SEQ * FAMILY_TRAIN_BATCH
    with torch.no_grad():
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        _, aux = transformer.forward_hidden(
            cfg, params, {"tokens": pipe.batch(0)["tokens"][:1]})
        aux = float(aux)
        del params
    print(f"LM family train: {cfg.name} at {cfg.n_layers} of its layers, "
          f"{bundle.n_params():,} parameters, {FAMILY_TRAIN_BATCH} × "
          f"{TRAIN_SEQ} tokens a step in {FAMILY_TRAIN_MICRO} microbatches, "
          f"adamw({TRAIN_LR}), remat {cfg.remat}; step 0's aux loss (summed "
          f"over layers, one sequence) {aux:.5f}, its term in the loss "
          f"{0.01 * aux / cfg.n_layers:.6f}", flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="lm_family_train_")
    try:
        tc = TrainerConfig(steps=FAMILY_TRAIN_STEPS, ckpt_every=10 ** 9,
                           ckpt_dir=ckpt_dir, log_every=1,
                           microbatches=FAMILY_TRAIN_MICRO)
        trainer = Trainer(bundle, optim.adamw(TRAIN_LR), pipe, tc)
        saves = []
        trainer.ckpt.save = lambda step, tree, extra=None: saves.append(step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        params, state = trainer.run(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        router = params["blocks"]["w_router"].dtype
        del params, state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [h["loss"] for h in trainer.history]
    step_ms = sorted(h["sec"] * 1e3 for h in trainer.history[1:])
    ms = step_ms[len(step_ms) // 2]
    lo = math.log(cfg.vocab) - TRAIN_LOSS0_BELOW
    hi = math.log(cfg.vocab) + TRAIN_LOSS0_ABOVE
    print(f"  losses {losses}; ms per step (host clock, steps 1-"
          f"{FAMILY_TRAIN_STEPS - 1}) {[round(x, 3) for x in step_ms]}, "
          f"median {ms:.3f} ({n_tok / ms * 1e3:.0f} tokens/s); first step "
          f"{trainer.history[0]['sec'] * 1e3:.3f} ms; peak allocated "
          f"{peak_mib:.1f} MiB; router {router}; launches {counts}",
          flush=True)
    if len(losses) != FAMILY_TRAIN_STEPS or not all(map(math.isfinite,
                                                        losses)):
        raise AssertionError(f"family train: losses {losses}")
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"family train: step 0's loss {losses[0]:.4f} "
                             f"outside [{lo:.4f}, {hi:.4f}]")
    if any(counts.values()):
        raise AssertionError(f"family train: a port kernel launched: "
                             f"{counts}")
    if router != torch.float32 or saves != [FAMILY_TRAIN_STEPS - 1]:
        raise AssertionError(f"family train: router {router}, saves {saves}")
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "n_params": bundle.n_params(), "launches": counts,
            "losses": losses, "aux_step0": aux, "step_ms": step_ms,
            "ms_per_step": ms, "tokens_per_s": n_tok / ms * 1e3,
            "first_step_ms": trainer.history[0]["sec"] * 1e3,
            "peak_mib": peak_mib}


def lm_family_phase(dev) -> dict:
    """The MoE and VLM families served at their published widths, and
    granite-moe trained (see the module docstring, phase 9b). The card's
    caches are freed between configs."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.api import build

    out = {}
    for name, layers_cut in LM_FAMILY:
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        if layers_cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers_cut)
        bundle = build(cfg, device=dev)
        plain = build(cfg, device=dev, use_kernels=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = bundle.init(gen)
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": tokens}
        pos_next = None
        if cfg.mrope_sections is not None:
            n_text = (LM_PROMPT - VLM_IMAGE_GRID ** 2) // 2
            batch["positions"] = vlm_positions(LM_BATCH, n_text,
                                               VLM_IMAGE_GRID, dev)
            pos_next = batch["positions"][:, -1:] + 1
        max_len = LM_PROMPT + LM_DECODE
        n_tok = LM_BATCH * LM_PROMPT
        print(f"LM family: {cfg.name} ({cfg.family}) at {cfg.n_layers} "
              f"layers{' (cut)' if layers_cut else ''}, "
              f"{bundle.n_params():,} parameters "
              f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              f"card), {LM_BATCH} prompts of {LM_PROMPT} tokens", flush=True)
        r = {"layers": cfg.n_layers, "layers_published": get_arch(
            name).n_layers, "n_params": bundle.n_params()}
        with torch.inference_mode():
            pre, (logits, cache, logits_p, cache_p, picks) = family_prefill(
                dev, cfg, bundle, plain, params, batch, max_len)
            r.update(pre)
            r["ms"] = timed_ms(lambda: bundle.prefill(params, batch,
                                                      max_len), 3)
            r["ms_plain"] = timed_ms(lambda: plain.prefill(params, batch,
                                                           max_len), 2)
            r["tokens_per_s"] = n_tok / r["ms"] * 1e3
            print(f"  ms per prefill: kernels {r['ms']:.3f} "
                  f"({r['tokens_per_s']:.0f} tokens/s)  plain "
                  f"{r['ms_plain']:.3f}", flush=True)
            r["profile"] = profile_phase(f"{cfg.name} prefill",
                                         lambda: bundle.prefill(
                                             params, batch, max_len), r["ms"])
            if cfg.moe is not None and name == FAMILY_GATHER_ARCH:
                r["gather"] = family_gather(cfg, bundle, params, batch,
                                            max_len, picks)
            if cfg.mrope_sections is not None:
                r["mrope_is_rope"] = family_mrope(cfg, params, batch,
                                                  max_len, dev)
            r["decode"] = family_decode(dev, cfg, bundle, plain, params,
                                        (logits, cache, logits_p, cache_p),
                                        LM_PROMPT, pos_next)
            del logits, cache, logits_p, cache_p, picks
            torch.cuda.empty_cache()
            f32_layers = FAMILY_F32_LAYERS.get(name)
            if f32_layers is not None:     # the f32 copy needs a cut
                params = {**params, "blocks": {
                    k: v[:f32_layers].clone()
                    for k, v in params["blocks"].items()}}
                cfg32 = dataclasses.replace(cfg, n_layers=f32_layers)
                bundle = build(cfg32, device=dev)
                plain = build(cfg32, device=dev, use_kernels=False)
                torch.cuda.empty_cache()
            else:
                cfg32 = cfg
            print(f"  against f32 at {cfg32.n_layers} layers:", flush=True)
            r["rel_l2_to_f32"] = lm_vs_f32(cfg32, dev, bundle, plain, params,
                                           batch, max_len,
                                           pin_routes=cfg.moe is not None)
            r["f32_layers"] = cfg32.n_layers
        if name == FAMILY_GATHER_ARCH:
            r["engine"] = engine_run(bundle, params)
        out[name] = r
        del params, bundle, plain
    torch.cuda.empty_cache()
    out["train"] = family_train(dev, get_arch(FAMILY_GATHER_ARCH))
    return {"LM_family": out}


def seq_flash_launches(cfg) -> int:
    """flash_attention launches of one prefill: none for mamba2, one per
    period for jamba, whisper's encoder layers plus two per decoder layer
    (self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.encoder_layers + 2 * cfg.n_layers


def seq_hidden(bundle, params, batch):
    """(``bundle``'s forward pass as its prefill runs it: the kernel path
    unless ``use_kernels`` is False, every position's final hidden state in
    the bundle's dtype, the head), the frames cast to that dtype."""
    batch = {k: v.to(bundle.dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    hidden, _ = bundle.forward_hidden(params, batch,
                                      use_kernel=bundle.use_kernels)
    return hidden, params["head"] if "head" in params else params["embed"].T


def seq_readout(bundle, params, batch):
    """(the last position's logits, every position's final hidden state,
    every attention's output [B, S, H, D] in call order) of ``seq_hidden``,
    f32: the attentions' through ``models.layers.attention``, wrapped for
    the call."""
    from repro_torch.models import layers
    real, outs = layers.attention, []

    def attention(*args, **kw):
        o = real(*args, **kw)
        outs.append(o.float())
        return o
    layers.attention = attention
    try:
        hidden, head = seq_hidden(bundle, params, batch)
    finally:
        layers.attention = real
    return (hidden[:, -1:] @ head).float(), hidden.float(), outs


# the parts seq_vs_f32 holds each path by; the others are printed
SEQ_HELD_PARTS = ("hidden", "attention", "attention_last_block")


def seq_parts(readout) -> dict:
    """A readout's parts: every position's hidden state, and the last
    FLASH_BLOCK positions'; every attention's output, and its last
    FLASH_BLOCK query rows' (where a dropped last key tile shows: one
    attention layer among jamba's 8 moves the final hidden state less than
    the mixers' bf16 noise); the last position's logits (4 rows)."""
    logits, hidden, attn = readout
    return {"hidden": hidden, "last_block": hidden[:, -FLASH_BLOCK:],
            "attention": torch.cat([o.flatten() for o in attn]),
            "attention_last_block": torch.cat(
                [o[:, -FLASH_BLOCK:].flatten() for o in attn]),
            "logits": logits}


def to_f32_in_place(tree) -> None:
    """Every leaf of a nested dict of tensors cast to f32, leaf by leaf, so
    that each bf16 leaf is freed as its f32 copy is made."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            to_f32_in_place(tree[k])
        else:
            tree[k] = tree[k].float()


def seq_vs_f32(dev, cfg, bundle, plain, params, batch) -> dict:
    """``lm_vs_f32``'s rule for a family whose prefill keeps no state, on
    its forward pass's readouts (``seq_parts``; SEQ_HELD_PARTS: every
    position's hidden state, every attention's output and its last
    FLASH_BLOCK query rows): each bf16 path's relative L2 to the same
    weights in f32 through the plain attention; the kernel path at most
    LM_VS_F32 times the plain path's on every held part, and two wrong
    attentions on the kernel path (mask off; last 64-key tile dropped)
    must break it on one. Every run takes the kernel path's picks
    (``route_log``); jamba's gather dispatch in f32 at those picks is held
    to the einsum's within FAMILY_GATHER_F32_REL. The bf16 readouts are
    taken first; then ``params`` is cast to f32 IN PLACE (each bf16 leaf
    freed as its copy is made) for the f32 runs."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build

    real = ops.flash_attention
    wrong = {"mask off": lambda q, k, v, **kw: real(
                 q, k, v, **{**kw, "causal": False}),
             "last key tile dropped": lambda q, k, v, **kw: real(
                 q, k[:, :-64], v[:, :-64], **kw)}
    got = {}
    with route_log() as picks:
        got["kernels"] = seq_readout(bundle, params, batch)
    with route_log(pin=picks):
        got["plain"] = seq_readout(plain, params, batch)
    for name, fn in wrong.items():
        ops.flash_attention = fn
        try:
            with route_log(pin=picks):
                got[f"control: {name}"] = seq_readout(bundle, params, batch)
        finally:
            ops.flash_attention = real
    to_f32_in_place(params)
    torch.cuda.empty_cache()
    with route_log(pin=picks):
        ref = seq_parts(seq_readout(build(
            cfg, device=dev, dtype=torch.float32, use_kernels=False),
            params, batch))
    out = {}
    for name, r in got.items():
        out[name] = {part: rel_l2(g, ref[part])
                     for part, g in seq_parts(r).items()}
        print(f"  relative L2 to the f32 forward (plain attention), {name}: "
              + ", ".join(f"{k} {v:.4e}" for k, v in out[name].items()),
              flush=True)
    limit = {part: LM_VS_F32 * out["plain"][part] for part in SEQ_HELD_PARTS}
    for name, r in out.items():
        broken = [part for part in limit if not r[part] <= limit[part]]
        if name == "kernels" and broken:
            raise AssertionError(f"{cfg.name}: the kernel path is farther "
                                 f"from f32 than {LM_VS_F32} x the plain "
                                 f"path's ({', '.join(broken)}): {r}")
        if name.startswith("control") and not broken:
            raise AssertionError(f"{cfg.name}: the check passes the {name}")
    if cfg.moe is not None:
        with route_log(pin=picks):
            g = seq_parts(seq_readout(build(
                cfg, device=dev, dtype=torch.float32, use_kernels=False,
                moe_impl="gather"), params, batch))
        out["gather_f32"] = {part: rel_l2(g[part], ref[part]) for part in g}
        print(f"  gather against einsum in f32 at the same picks: "
              + ", ".join(f"{k} {v:.4e}" for k, v in
                          out["gather_f32"].items()), flush=True)
        if not all(v <= FAMILY_GATHER_F32_REL
                   for v in out["gather_f32"].values()):
            raise AssertionError(f"{cfg.name}: gather against einsum in "
                                 f"f32 {out['gather_f32']}")
    return out


def seq_prefill(cfg, bundle, plain, params, batch) -> tuple:
    """One prefill with every launch count set to 0 just before:
    flash_attention exactly ``seq_flash_launches(cfg)`` times and no other
    port kernel, finite logits, peak MiB; the plain path's prefill against
    it (reported) and for jamba the share of picks the two paths make;
    ms per prefill of both paths, tokens/s and a profile. Returns (that
    record, the kernel path's logits, its picks)."""
    from repro_torch.kernels import ops
    n_tok = batch["tokens"].numel()
    want = seq_flash_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with route_log() as picks:
        logits, state = bundle.prefill(params, batch, batch["tokens"].shape[1])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out = {"launches": counts,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    print(f"  prefill launches {counts}; peak allocated "
          f"{out['peak_mib']:.1f} MiB", flush=True)
    if counts["flash_attention"] != want or any(
            n for k, n in counts.items() if k != "flash_attention"):
        raise AssertionError(f"prefill: launches {counts}, not "
                             f"flash_attention {want} times")
    if state is not None or logits.shape != (
            batch["tokens"].shape[0], 1, bundle.vocab_padded) or not bool(
                torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)} not "
                             f"finite or a state {type(state)}")
    with route_log() as picks_p:
        logits_p, _ = plain.prefill(params, batch, batch["tokens"].shape[1])
    out["rel_l2_vs_plain"] = rel_l2(logits, logits_p)
    out["max_abs_dlogit"] = float((logits - logits_p).abs().max())
    print(f"  vs the plain attention on the card: max |Δlogit| "
          f"{out['max_abs_dlogit']:.4e}, relative L2 "
          f"{out['rel_l2_vs_plain']:.4e}", flush=True)
    if cfg.moe is not None:
        r = route_report(cfg, picks, picks_p)
        out["routes"] = r
        print(f"  routes (C {r['capacity']}): kernel and plain paths share "
              f"{min(r['agree']):.5f}-{max(r['agree']):.5f} of the picks "
              f"per layer; dropped per layer {r['dropped']}", flush=True)
    S = batch["tokens"].shape[1]
    out["ms"] = timed_ms(lambda: bundle.prefill(params, batch, S), 3)
    out["ms_plain"] = timed_ms(lambda: plain.prefill(params, batch, S), 2)
    out["tokens_per_s"] = n_tok / out["ms"] * 1e3
    print(f"  ms per prefill: kernels {out['ms']:.3f} "
          f"({out['tokens_per_s']:.0f} tokens/s)  plain "
          f"{out['ms_plain']:.3f}", flush=True)
    out["profile"] = profile_phase(f"{cfg.name} prefill", lambda: bundle
                                   .prefill(params, batch, S), out["ms"])
    return out, logits, picks


def decode_state_bytes(state, start: int, n_steps: int) -> float:
    """Bytes of the decode state a step must touch, averaged over
    ``n_steps`` steps from position ``start``: an SSM state read and
    written whole; a self K/V cache's rows before and at the step's
    position read; whisper's cross K/V read whole."""
    from repro_torch.models.mamba2 import SSMState
    rows = start + (n_steps + 1) / 2

    def nbytes(t):
        return t.numel() * t.element_size()
    if isinstance(state, SSMState):
        return 2.0 * sum(nbytes(t) for t in state)
    total = 0.0
    for key, part in state.items():
        if isinstance(part, SSMState):
            total += 2.0 * sum(nbytes(t) for t in part)
        elif key.startswith("cross"):
            total += nbytes(part)
        else:                                   # (k, v) or self_k / self_v
            for t in (part if isinstance(part, tuple) else (part,)):
                total += nbytes(t) * min(rows / t.shape[-3], 1.0)
    return total


def seq_state(bundle, params, batch, max_len: int):
    """The decode state a family without a prefill state decodes from: the
    zero state of LM_BATCH sequences of ``max_len``, whisper's with the
    cross K/V of ``batch["frames"]`` (``precompute_cross``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import whisper
    state = bundle.serve_state_shape(ShapeConfig("decode", max_len,
                                                 LM_BATCH, "decode"))
    if bundle.cfg.family == "audio":
        state["cross_k"], state["cross_v"] = whisper.precompute_cross(
            bundle.cfg, params, batch["frames"].to(bundle.dtype),
            use_kernel=bundle.use_kernels)
    return state


def seq_decode(cfg, bundle, params, make_state, logits) -> dict:
    """LM_DECODE greedy tokens at B 4 from ``make_state()`` (these families'
    prefill keeps no state, as the reference's: mamba2 and jamba decode
    from the zero state, whisper against ``precompute_cross``'s K/V), the
    first fed the prefill's greedy token, with every launch count set to
    0 just before (no port kernel); ms per token beside its floors (every
    weight read once, the einsum dispatch's; the experts the steps pick;
    each with the state a step reads and writes), peak MiB and a profile
    of one step."""
    from repro_torch.kernels import ops
    with route_log() as picks:            # warm-up; the timed run repeats it
        greedy(bundle, params, make_state(), logits, LM_DECODE, 0,
               jit=False)
    state = make_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    toks = greedy(bundle, params, state, logits, LM_DECODE, 0, jit=False)
    torch.cuda.synchronize()
    ms_tok = (time.perf_counter() - t) / LM_DECODE * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    sbytes = decode_state_bytes(state, 0, LM_DECODE)
    floor_einsum, floor = ((n + sbytes) / PEAK_BYTES_PER_S * 1e3 for n in
                           decode_bytes(bundle, picks, LM_DECODE))
    print(f"  decode: {LM_DECODE} greedy tokens at B {toks.shape[0]}, "
          f"{ms_tok:.3f} ms per token (floors with {sbytes / 1e6:.1f} MB of "
          f"state a step: every weight read once {floor_einsum:.3f} ms; the "
          f"experts the steps pick {floor:.3f} ms); peak {peak:.1f} MiB; "
          f"launches {counts}", flush=True)
    if bool((toks < 0).any()) or bool((toks >= cfg.vocab).any()):
        raise AssertionError("decode: a token outside the vocab")
    if any(counts.values()):
        raise AssertionError(f"decode launched a port kernel: {counts}")
    prof = profile_phase(f"{cfg.name} decode step", lambda: bundle.serve_step(
        params, state, {"token": toks[:, :1]}, length=LM_DECODE), ms_tok)
    del state
    return {"ms_per_token": ms_tok, "einsum_floor_ms": floor_einsum,
            "floor_ms": floor, "state_bytes": sbytes, "peak_mib": peak,
            "launches": counts, "tokens": toks.numel(), "profile": prof,
            "graph": decode_graph(cfg.name, bundle, params, make_state(),
                                  logits, 0)}


def decode_vs_forward(dev, cfg, bundle, params, batch) -> dict:
    """Decode over the first DVF_TOKENS tokens of ``batch`` from
    ``seq_state`` against the full forward pass over them (the logits at
    every position): in bf16 within the reference's own rtol 5e-2, atol
    5e-1 (``tests/test_model_invariants.py``; its argmax agreement is
    reported), and with the weights cast to f32 the same function
    (relative L2 at most DVF_F32_REL, agreement at least
    DVF_F32_AGREE)."""
    from repro_torch.models.api import build
    from repro_torch.models.common import tree_map
    n = DVF_TOKENS
    sub = {**batch, "tokens": batch["tokens"][:, :n]}
    out = {}
    for label, b, p in (("bf16", bundle, params),
                        ("f32", build(cfg, device=dev, dtype=torch.float32),
                         tree_map(lambda t: t.float(), params))):
        full, head = seq_hidden(b, p, sub)
        full = (full @ head).float()
        state = seq_state(b, p, sub, n)
        dec = torch.cat([b.serve_step(p, state, {"token": sub["tokens"][
            :, t:t + 1]}, length=t)[0] for t in range(n)], dim=1)
        agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
        r = {"rel_l2": rel_l2(dec, full), "agree": agree,
             "max_abs": float((dec - full).abs().max())}
        if label == "bf16":
            r["within_rule"] = bool(torch.isclose(
                dec, full, rtol=5e-2, atol=5e-1).all())
            ok = r["within_rule"]
        else:
            ok = r["rel_l2"] <= DVF_F32_REL and agree >= DVF_F32_AGREE
        print(f"  decode against the forward pass over {n} tokens, {label}: "
              f"relative L2 {r['rel_l2']:.4e}, max |Δ| {r['max_abs']:.4e}, "
              f"argmax agreement {agree:.4f}", flush=True)
        out[label] = r
        if not ok:
            raise AssertionError(f"{cfg.name}: decode against the forward "
                                 f"pass, {label}: {r}")
        del full, dec, state
    return out


def seq_train(dev, cfg) -> dict:
    """SEQ_TRAIN_STEPS training steps (see the module docstring, phase 9c):
    mamba2 through ``Trainer.run`` on ``TokenPipeline``'s 4 ×
    4096 tokens; whisper through ``launch.steps.make_train_step`` on
    ``make_inputs`` batches (frames, tokens, targets) at 4 × 448 (the
    pipeline makes no frames). adamw(TRAIN_LR), remat; losses finite, step
    0's within [ln V − 0.5, ln V + 1.5], no port kernel; ms per step
    (median of steps 1-2, host clock), tokens/s, peak MiB."""
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    bundle = build(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if cfg.family == "audio":
        seq, gen = WHISPER_TEXT, torch.Generator(device=dev).manual_seed(3)
        opt = optim.adamw(TRAIN_LR)
        params = bundle.init(gen)
        state = opt.init(params)
        step = steps.make_train_step(bundle, opt)
        shape = ShapeConfig("train", seq, TRAIN_BATCH, "train")
        losses, secs = [], []
        for _ in range(SEQ_TRAIN_STEPS):
            batch = bundle.make_inputs(shape, gen)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t)
        del params, state
    else:
        seq = TRAIN_SEQ
        ckpt_dir = tempfile.mkdtemp(prefix="lm_seq_train_")
        try:
            trainer = Trainer(
                bundle, optim.adamw(TRAIN_LR),
                TokenPipeline(cfg.vocab, seq, TRAIN_BATCH, device=dev),
                TrainerConfig(steps=SEQ_TRAIN_STEPS, ckpt_every=10 ** 9,
                              ckpt_dir=ckpt_dir, log_every=1,
                              microbatches=cfg.microbatches))
            trainer.ckpt.save = lambda step, tree, extra=None: None
            params, state = trainer.run(
                torch.Generator(device=dev).manual_seed(0))
            del params, state
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        losses = [h["loss"] for h in trainer.history]
        secs = [h["sec"] for h in trainer.history]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = sorted(x * 1e3 for x in secs[1:])
    ms = step_ms[len(step_ms) // 2]
    n_tok = seq * TRAIN_BATCH
    lo = math.log(cfg.vocab) - TRAIN_LOSS0_BELOW
    hi = math.log(cfg.vocab) + TRAIN_LOSS0_ABOVE
    print(f"  train: {SEQ_TRAIN_STEPS} steps of {TRAIN_BATCH} × {seq} tokens "
          f"(remat {cfg.remat}): losses {losses}; ms per step {step_ms} "
          f"(first {secs[0] * 1e3:.3f}), {n_tok / ms * 1e3:.0f} tokens/s; "
          f"peak {peak:.1f} MiB; launches {counts}", flush=True)
    if len(losses) != SEQ_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name} train: losses {losses}")
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"{cfg.name} train: step 0's loss "
                             f"{losses[0]:.4f} outside [{lo:.4f}, {hi:.4f}]")
    if any(counts.values()):
        raise AssertionError(f"{cfg.name} train: a port kernel launched: "
                             f"{counts}")
    return {"losses": losses, "step_ms": step_ms, "ms_per_step": ms,
            "first_step_ms": secs[0] * 1e3, "tokens_per_s": n_tok / ms * 1e3,
            "peak_mib": peak, "tokens_per_step": n_tok, "launches": counts}


def lm_seq_phase(dev) -> dict:
    """The SSM, hybrid and audio families at their published widths (see
    the module docstring, phase 9c). The card's caches are freed between
    configs."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.models import whisper
    from repro_torch.models.api import build

    out = {}
    for name, layers_cut in LM_SEQ:
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        if layers_cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers_cut)
        bundle = build(cfg, device=dev)
        plain = build(cfg, device=dev, use_kernels=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = bundle.init(gen)
        audio = cfg.family == "audio"
        S = WHISPER_TEXT if audio else LM_PROMPT
        batch = bundle.make_inputs(ShapeConfig("prefill", S, LM_BATCH,
                                               "prefill"), gen)
        print(f"LM seq: {cfg.name} ({cfg.family}) at {cfg.n_layers} layers"
              f"{' (cut)' if layers_cut else ''}, {bundle.n_params():,} "
              f"parameters ({torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              f"GiB on the card), {LM_BATCH} × {S} tokens"
              f"{f', {cfg.encoder_seq} frames' if audio else ''}", flush=True)
        r = {"layers": cfg.n_layers, "layers_published": get_arch(
            name).n_layers, "n_params": bundle.n_params()}

        max_len = WHISPER_TEXT if audio else S + LM_DECODE
        with torch.inference_mode():
            pre, logits, picks = seq_prefill(cfg, bundle, plain, params,
                                             batch)
            r["prefill"] = pre
            if audio:
                from repro_torch.kernels import ops
                ops.reset_launch_counts()
                r["encoder_ms"] = timed_ms(lambda: whisper.encode(
                    cfg, params, batch["frames"], use_kernel=True), 3)
                torch.cuda.synchronize()
                r["encoder_launches"] = ops.launch_counts()["flash_attention"]
                print(f"  encoder alone on {LM_BATCH} × {cfg.encoder_seq} "
                      f"frames: {r['encoder_ms']:.3f} ms", flush=True)
            if cfg.moe is not None:
                gather = build(cfg, device=dev, moe_impl="gather")
                with route_log() as picks_g:
                    lg, _ = gather.prefill(params, batch, S)
                rg = route_report(cfg, picks, picks_g)
                if not sum(rg["dropped"]) or not bool(
                        torch.isfinite(lg).all()):
                    raise AssertionError(f"gather: dropped {rg['dropped']} "
                                         f"or not finite")
                r["gather"] = {"agree": rg["agree"], "dropped": rg["dropped"],
                               "ms": timed_ms(lambda: gather.prefill(
                                   params, batch, S), 3)}
                del lg
                print(f"  gather dispatch: finite with {sum(rg['dropped'])} "
                      f"dropped picks, sharing "
                      f"{sum(rg['agree']) / len(rg['agree']):.5f} of "
                      f"einsum's picks, {r['gather']['ms']:.3f} ms per "
                      f"prefill", flush=True)
            r["decode"] = seq_decode(cfg, bundle, params, lambda: seq_state(
                bundle, params, batch, max_len), logits)
            if cfg.moe is not None:
                toks_e = greedy(bundle, params, seq_state(
                    bundle, params, batch, max_len), logits, 8, 0, jit=False)
                toks_g = greedy(gather, params, seq_state(
                    gather, params, batch, max_len), logits, 8, 0, jit=False)
                r["gather"]["decode_tokens_agree"] = int(
                    (toks_e == toks_g).sum())
                print(f"  gather decode: 8 greedy tokens at B {LM_BATCH}, "
                      f"{r['gather']['decode_tokens_agree']} of "
                      f"{toks_e.numel()} equal to einsum's", flush=True)
                del gather
            if cfg.family in ("ssm", "audio"):
                r["decode_vs_forward"] = decode_vs_forward(
                    dev, cfg, bundle, params, batch)
            del logits, picks
        r["engine"] = engine_run(bundle, params)
        torch.cuda.empty_cache()
        f32_layers = SEQ_F32_LAYERS.get(name)
        if f32_layers is not None:       # the f32 copy needs a cut: new weights
            del params
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, n_layers=f32_layers)
            bundle = build(cfg, device=dev)
            plain = build(cfg, device=dev, use_kernels=False)
            params = bundle.init(torch.Generator(device=dev).manual_seed(1))
        if seq_flash_launches(cfg):      # mamba2: no attention, no kernel
            print(f"  against f32 at {cfg.n_layers} layers:", flush=True)
            with torch.inference_mode():
                r["rel_l2_to_f32"] = seq_vs_f32(dev, cfg, bundle, plain,
                                                params, batch)
            r["f32_layers"] = cfg.n_layers
        del params, bundle, plain, batch
        torch.cuda.empty_cache()
        if cfg.family in ("ssm", "audio"):
            r["train"] = seq_train(dev, get_arch(name))
        out[name] = r
    torch.cuda.empty_cache()
    return {"LM_seq": out}


def attention_ms(dev, cfg) -> float:
    """Device ms of one layer's plain attention as a remat training step
    runs it (CUDA events): a forward pass, the layer's recomputed forward
    under grad, and the backward pass that recomputes each query chunk,
    at the training shape."""
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.hd
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    grad = torch.randn((B, S, cfg.n_heads, hd), generator=gen,
                       device=dev).to(torch.bfloat16)

    def once():
        layers.attention(q, k, v, use_kernel=False)
        layers.attention(q, k, v, use_kernel=False).backward(grad)
    return time_ms(once, iters=2, warmup=1)


def leaf_items(tree):
    """(dotted name, tensor) of a params tree, keys sorted."""
    from repro_torch.models.common import leaves
    return sorted((".".join(k), t) for k, t in leaves(tree))


def train_full(dev, cfg) -> dict:
    """(a) ``Trainer.run`` at full width (see the module docstring)."""
    import tempfile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if not cfg.remat or cfg.microbatches != 1:
        raise AssertionError(f"{cfg.name}: expected remat on and one "
                             f"microbatch, got {cfg.remat}, "
                             f"{cfg.microbatches}")
    bundle = build(cfg, device=dev)
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, device=dev)
    n_tok = TRAIN_SEQ * TRAIN_BATCH
    # the head's logits on step 0's batch, from the same seeded init
    with torch.no_grad():
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        hidden, _ = transformer.forward_hidden(
            cfg, params, {"tokens": pipe.batch(0)["tokens"][:1]})
        sigma = float((hidden[:, :512] @ params["head"]).float().std())
        del params, hidden
    predicted = math.log(cfg.vocab) + sigma ** 2 / 2
    print(f"LM train (a): {cfg.name}, {bundle.n_params():,} parameters, "
          f"{TRAIN_BATCH} × {TRAIN_SEQ} tokens a step, adamw({TRAIN_LR}), "
          f"remat {cfg.remat}; step 0's logits have std {sigma:.4f}, so "
          f"its loss should be near ln V + σ²/2 = {predicted:.4f}",
          flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="lm_train_")
    try:
        tc = TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                           ckpt_dir=ckpt_dir, log_every=1)
        trainer = Trainer(bundle, optim.adamw(TRAIN_LR), pipe, tc)
        saves = []
        real_save = trainer.ckpt.save

        def timed_save(step, tree, extra=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = real_save(step, tree, extra)
            saves.append({"step": step, "s": time.perf_counter() - t,
                          "bytes": sum(f.stat().st_size
                                       for f in path.iterdir())})
            return path
        trainer.ckpt.save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        params, state = trainer.run(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [h["loss"] for h in trainer.history]
    step_ms = sorted(h["sec"] * 1e3 for h in trainer.history[1:])
    ms = step_ms[len(step_ms) // 2]
    lo = math.log(cfg.vocab) - TRAIN_LOSS0_BELOW
    hi = math.log(cfg.vocab) + TRAIN_LOSS0_ABOVE
    save = saves[-1]
    print(f"  losses {losses}; ms per step (host clock, steps 1-"
          f"{TRAIN_STEPS - 1}) {[round(x, 3) for x in step_ms]}, median "
          f"{ms:.3f} ({n_tok / ms * 1e3:.0f} tokens/s); first step "
          f"{trainer.history[0]['sec'] * 1e3:.3f} ms; peak allocated "
          f"{peak_mib:.1f} MiB; final save (step {save['step']}) "
          f"{save['s']:.3f} s, {save['bytes'] / 1e9:.3f} GB; launches "
          f"{counts}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train (a): losses {losses}")
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"train (a): step 0's loss {losses[0]:.4f} "
                             f"outside [{lo:.4f}, {hi:.4f}]")
    if not min(losses[-2:]) < losses[0]:
        raise AssertionError(f"train (a): the loss did not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"train (a): a port kernel launched on the "
                             f"training path: {counts}")
    if [x["step"] for x in saves] != [TRAIN_STEPS - 1]:
        raise AssertionError(f"train (a): saves at {saves}")
    attn = attention_ms(dev, cfg)
    print(f"  plain attention, one layer's forward, recompute and backward "
          f"at {TRAIN_BATCH} × {TRAIN_SEQ}: {attn:.3f} ms (events); × "
          f"{cfg.n_layers} layers = {attn * cfg.n_layers:.1f} ms, "
          f"{attn * cfg.n_layers / ms:.3f} of the step", flush=True)
    batch = pipe.batch(TRAIN_STEPS)
    held = [params, state]
    del params, state

    def step_once():
        held[0], held[1], _ = trainer.step_fn(held[0], held[1], batch)
    # the step's device time cannot fall below its attention's alone: one
    # trace of this step read every kernel ~0.54x as long as another (an f32
    # GEMM past the card's peak), a clock the profiler got wrong
    for _ in range(PROFILE_TRIES):
        prof = profile_phase("training step", step_once, ms)
        prof["attention_events_ms"] = attn * cfg.n_layers
        if (prof["device_busy_ms"] is None
                or prof["device_busy_ms"] >= 0.95 * attn * cfg.n_layers):
            break
        print(f"  the trace's device time {prof['device_busy_ms']:.1f} ms "
              f"is below the attention's alone by events "
              f"({attn * cfg.n_layers:.1f} ms): its clock is off; "
              f"tracing again", flush=True)
    del held
    return {"launches": counts, "iterations": TRAIN_STEPS, "losses": losses,
            "step_ms": step_ms, "ms_per_step": ms,
            "first_step_ms": trainer.history[0]["sec"] * 1e3,
            "tokens_per_s": n_tok / ms * 1e3, "peak_mib": peak_mib,
            "logit_std": sigma, "loss0_predicted": predicted,
            "save_s": save["s"], "save_bytes": save["bytes"],
            "attention_ms_per_layer": attn, "profile": prof}


def train_guard(dev) -> dict:
    """(b) ``ops.flash_attention`` refuses inputs that require grad under
    grad mode; under no_grad the same call runs and holds against its
    plain version as ``flash_cases`` holds it."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 2048, h, 64), generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_() for h in (32, 4, 4))
    try:
        ops.flash_attention(q, k, v)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("flash_attention ran on inputs that require "
                             "grad")
    print(f"LM train (b): flash_attention under grad mode raised: "
          f"{message}", flush=True)
    with torch.no_grad():
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        plain = ref.flash_attention_ref(q, k, v, p_dtype=torch.bfloat16)
        err = float((got.double() - plain.double()).abs().max())
        r = flash_check_for(want)(got, plain, err)
    return {"message": message, "max_abs_err": err, **r}


def train_vs_f32(dev, cfg, params, batch) -> dict:
    """(c) One ``ModelBundle.loss`` and backward in bf16 and with the same
    weights in f32: the loss within TRAIN_F32_LOSS_RTOL, each leaf's
    gradient within a relative L2 distance of TRAIN_F32_GRAD_REL_L2; the
    same bf16 run with q, k, v detached before attention must break it."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers
    from repro_torch.models.api import build
    from repro_torch.models.common import tree_map

    b16 = build(cfg, device=dev)
    b32 = build(cfg, device=dev, dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    loss32, g32 = value_and_grad(b32, params32, batch)
    del params32
    g32 = leaf_items(g32)
    real = layers.attention

    def detached(q, k, v, **kw):
        return real(q.detach(), k.detach(), v.detach(), **kw)
    out = {}
    for name in ("bf16", "control: q, k, v detached"):
        layers.attention = real if name == "bf16" else detached
        try:
            loss, g = value_and_grad(b16, params, batch)
        finally:
            layers.attention = real
        rel = {n: float((a.float() - b).norm() / b.norm())
               for (n, a), (_, b) in zip(leaf_items(g), g32)}
        dloss = abs(float(loss) - float(loss32)) / abs(float(loss32))
        out[name] = {"loss": float(loss), "loss_rel": dloss, "grad_rel_l2": rel}
        print(f"LM train (c), {name}: loss {float(loss):.6f} (f32 "
              f"{float(loss32):.6f}, relative {dloss:.3e}); gradients' "
              f"relative L2 to f32: " + ", ".join(
                  f"{n} {x:.3e}" for n, x in rel.items()), flush=True)
        del g
    ok = out["bf16"]
    broken = [n for n, x in ok["grad_rel_l2"].items()
              if not x <= TRAIN_F32_GRAD_REL_L2]
    if not ok["loss_rel"] <= TRAIN_F32_LOSS_RTOL or broken:
        raise AssertionError(f"train (c): bf16 against f32: loss relative "
                             f"{ok['loss_rel']:.3e}, leaves above "
                             f"{TRAIN_F32_GRAD_REL_L2}: {broken}")
    ctl = out["control: q, k, v detached"]["grad_rel_l2"]
    if all(x <= TRAIN_F32_GRAD_REL_L2 for x in ctl.values()):
        raise AssertionError("train (c): the check passes the control with "
                             "q, k, v detached")
    out["loss_f32"] = float(loss32)
    return out


def train_accum(dev, cfg, params, batch) -> dict:
    """(d) One adamw step with two microbatches (f32, then bf16
    accumulator) against one: the loss within TRAIN_ACCUM_LOSS_RTOL; each
    leaf's update (new − old, f32) within a relative L2 distance of
    TRAIN_ACCUM_UPDATE_REL_L2 of one microbatch's (a leaf that neither run
    moves, bf16 norms at 1 under a 3e-4 step, counts as 0); and every
    updated element within 2.2·lr + 2⁻⁷·|p| of one microbatch's: Adam's
    first step moves an element by lr·g/(|g| + eps) plus lr·0.1·p of
    decay, so two runs differ by at most a flipped sign, 2·lr, and the
    rounding to bf16."""
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_accum_train_step

    bundle = build(cfg, device=dev)
    opt = optim.adamw(TRAIN_LR)
    state = opt.init(params)
    old = dict(leaf_items(params))
    runs = {}
    for name, mb, adt in (("one", 1, None), ("two, f32", 2, None),
                          ("two, bf16", 2, torch.bfloat16)):
        new, _, loss = make_accum_train_step(bundle, opt, mb, adt)(
            params, state, batch)
        runs[name] = (float(loss), dict(leaf_items(new)))
    base_loss, base = runs.pop("one")
    out = {"loss_one": base_loss}
    for name, (loss, new) in runs.items():
        r = {"loss": loss, "loss_rel": abs(loss - base_loss) / base_loss,
             "update_rel_l2": {}, "max_abs": {}, "over_bound": {}}
        for n, p in new.items():
            p1, p2 = base[n].float(), p.float()
            d1, d2 = p1 - old[n].float(), p2 - old[n].float()
            diff = float((d2 - d1).norm())
            r["update_rel_l2"][n] = diff / float(d1.norm()) if diff else 0.0
            r["max_abs"][n] = float((p2 - p1).abs().max())
            limit = 2.2 * TRAIN_LR + 2.0 ** -7 * torch.maximum(p1.abs(),
                                                             p2.abs())
            r["over_bound"][n] = int(((p2 - p1).abs() > limit).sum())
        out[name] = r
        print(f"LM train (d), {name} microbatches against one: loss "
              f"{loss:.6f} ({base_loss:.6f}, relative {r['loss_rel']:.3e}); "
              f"updates' relative L2 " + ", ".join(
                  f"{n} {x:.3e}" for n, x in r["update_rel_l2"].items())
              + "; max |Δp| " + ", ".join(
                  f"{n} {x:.2e}" for n, x in r["max_abs"].items()),
              flush=True)
        broken = [n for n, x in r["update_rel_l2"].items()
                  if not x <= TRAIN_ACCUM_UPDATE_REL_L2]
        broken += [f"{n}: {c} elements past 2.2·lr + 2⁻⁷·|p|"
                   for n, c in r["over_bound"].items() if c]
        if not r["loss_rel"] <= TRAIN_ACCUM_LOSS_RTOL or broken:
            raise AssertionError(f"train (d), {name}: loss relative "
                                 f"{r['loss_rel']:.3e}; {broken}")
    return out


def train_resume(dev, cfg) -> dict:
    """(e) ``Trainer`` with ``fail_at_step=2``, ``ckpt_every=2``, then a
    resume: the restored leaves are the saved ones bit for bit, and the
    losses of steps 2-3 lie within TRAIN_RESUME_RTOL of a run without the
    crash."""
    import tempfile

    from repro_torch.ckpt.manager import flatten
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    bundle = build(cfg, device=dev)
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, device=dev)
    root = tempfile.mkdtemp(prefix="lm_resume_")

    def trainer(name, every, fail_at=None):
        return Trainer(bundle, optim.adamw(TRAIN_LR), pipe, TrainerConfig(
            steps=4, ckpt_every=every, ckpt_dir=os.path.join(root, name),
            log_every=100, fail_at_step=fail_at))

    def gen():
        return torch.Generator(device=dev).manual_seed(1)
    try:
        whole = trainer("whole", 4)
        whole.run(gen())
        crash = trainer("crash", 2, fail_at=2)
        saved = []
        real_save = crash.ckpt.save

        def keep_save(step, tree, extra=None):
            saved.append((step, flatten(tree)))
            return real_save(step, tree, extra)
        crash.ckpt.save = keep_save
        try:
            crash.run(gen())
        except RuntimeError as e:
            if "injected failure at step 2" not in str(e):
                raise
        else:
            raise AssertionError("train (e): no injected failure")
        resumed = trainer("crash", 2)
        restored = []
        real_restore = resumed.init_or_restore

        def keep_restore(generator):
            out = real_restore(generator)
            restored.append(flatten(out[:2]))
            return out
        resumed.init_or_restore = keep_restore
        resumed.run(gen())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if [s for s, _ in saved] != [1] or len(restored) != 1:
        raise AssertionError(f"train (e): saved {[s for s, _ in saved]}, "
                             f"restored {len(restored)} times")
    same = sum(torch.equal(a, b) for a, b in zip(saved[0][1], restored[0]))
    want = {h["step"]: h["loss"] for h in whole.history}
    got = {h["step"]: h["loss"] for h in resumed.history}
    rel = {s: abs(got[s] - want[s]) / want[s] for s in got}
    print(f"LM train (e): crash at step 2, resume from step 1's checkpoint: "
          f"{same} of {len(restored[0])} leaves restored bit for bit; "
          f"losses resumed {got} against {want}, relative {rel}", flush=True)
    if same != len(saved[0][1]) or len(restored[0]) != len(saved[0][1]):
        raise AssertionError("train (e): restored leaves differ from the "
                             "saved ones")
    if sorted(got) != [2, 3] or not all(x <= TRAIN_RESUME_RTOL
                                        for x in rel.values()):
        raise AssertionError(f"train (e): resumed losses {got} against "
                             f"{want}")
    return {"leaves": same, "losses_resumed": got, "losses_whole": want,
            "loss_rel": rel}


def lm_train_phase(dev, cfg) -> dict:
    """The dense LM ``cfg`` (tinyllama-1.1b) trained on ``dev``: (a) at full
    width, (b) the flash kernel's autograd guard, (c)-(e) at full width and
    TRAIN_CUT_LAYERS layers (see the module docstring, phase 10)."""
    from repro_torch.data.pipeline import TokenPipeline

    out = {"LM_train": train_full(dev, cfg)}
    torch.cuda.empty_cache()
    out["LM_train_guard"] = train_guard(dev)
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    batch = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                          device=dev).batch(0)
    from repro_torch.models.api import build
    params = build(cut, device=dev).init(
        torch.Generator(device=dev).manual_seed(1))
    out["LM_train_vs_f32"] = train_vs_f32(dev, cut, params, batch)
    torch.cuda.empty_cache()
    out["LM_train_accum"] = train_accum(dev, cut, params, batch)
    del params
    torch.cuda.empty_cache()
    out["LM_train_resume"] = train_resume(dev, cut)
    return out


def wire_bytes(dims, V: int, grid) -> dict:
    """Bytes per iteration on the layer links (the Fig-5 model, from the
    port's ledger) for G, G-Q, and G-Q with 8-bit u codecs."""
    from repro_torch.comm.codecs import GridCodec, codec_for_grid
    from repro_torch.comm.ledger import admm_bytes_per_iteration
    from repro_torch.core.quantize import uniform_grid
    fp32, gq = codec_for_grid(None), codec_for_grid(grid)
    out = {"G": admm_bytes_per_iteration(dims, V, fp32, fp32),
           "GQ": admm_bytes_per_iteration(dims, V, gq, gq),
           "GQ_u_wire": admm_bytes_per_iteration(
               dims, V, gq, gq, GridCodec(uniform_grid(8, -1.0, 1.0)))}
    print(f"wire bytes per iteration (ledger): {out}; G-Q saves "
          f"{1 - out['GQ'] / out['G']:.4f}, with the u wire "
          f"{1 - out['GQ_u_wire'] / out['G']:.4f}", flush=True)
    return out


def cuda_tool(name: str):
    """A CUDA toolkit program on PATH or beside nvcc, else None."""
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return path if os.path.exists(path) else None


def sass_report(lib_path) -> dict:
    """Tensor-core instructions in the SASS of the redesigned kernels
    (flash_attention, fused_linear, admm_pgrad, backtrack_resnorm's pass
    1): HGMMA (wgmma) and HMMA (mma.sync)
    counts per kernel from ``cuobjdump -sass`` of the built library. A
    report of what was compiled, not a route."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        print("SASS: cuobjdump not found; tensor-core instructions not "
              "counted", flush=True)
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
        elif cur and any(k in cur for k in SASS_KERNELS):
            c = counts.setdefault(cur, {"HGMMA": 0, "HMMA": 0})
            for op in c:
                c[op] += f" {op}." in line
    filt = cuda_tool("cu++filt")
    if filt and counts:
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        def short(name):   # "void <unnamed>::tc::k<(int)64>(...)" -> "tc::k<64>"
            name = re.sub(r"\((unsigned )?(int|long|bool)\)", "", name)
            for junk in ("void ", "<unnamed>::", "(anonymous namespace)::"):
                name = name.replace(junk, "")
            return name.split("(")[0]
        counts = {short(n) or m: c
                  for n, (m, c) in zip(names, counts.items())}
    print("SASS tensor-core instructions (cuobjdump -sass): " + "; ".join(
        f"{name} HGMMA {c['HGMMA']} HMMA {c['HMMA']}"
        for name, c in counts.items()), flush=True)
    return counts


# ---------------------------------------------------------------------------
# mesh_phase: the mesh tools (launch/mesh, parallel/sharding, launch/dryrun)
# ---------------------------------------------------------------------------

def mesh_dryrun(names) -> dict:
    """(a) ``launch.dryrun`` on this host, the cells ``names`` of:
    tinyllama-1.1b's MESH_CELLS on the single production mesh (a fake
    world of 256 ranks; attention chunks of MESH_ATTN_CHUNK queries), the
    stage-parallel cells (StageMesh(16, 16), V 1,048,576, h 4096, L 16, 64
    classes) with an fp32 and an 8-bit wire, MESH_MOE_CELL (the experts'
    ffn_exp layout) at MESH_MOE_MICROBATCHES microbatches and
    MESH_SSM_CELL (the SSM's ssm_inner layout). Per device: flops, peak
    live bytes, the collectives' moved bytes; each finite and above 0."""
    from repro_torch.launch import dryrun as D
    cells = {shape: lambda shape=shape: D.trace_cell(
        LM_ARCH, shape, False, attn_chunk=MESH_ATTN_CHUNK)
        for shape in MESH_CELLS}
    cells.update({f"stage_v1m_b{bits or 32}":
                  lambda bits=bits: D.lower_admm_cell(False, bits=bits)
                  for bits in MESH_ADMM_BITS})
    arch, shape = MESH_MOE_CELL
    cells[f"{arch} {shape}"] = lambda: D.trace_cell(
        arch, shape, False, attn_chunk=MESH_ATTN_CHUNK,
        microbatches=MESH_MOE_MICROBATCHES)
    ssm, ssm_shape = MESH_SSM_CELL
    cells[f"{ssm} {ssm_shape}"] = lambda: D.trace_cell(
        ssm, ssm_shape, False, attn_chunk=MESH_ATTN_CHUNK)
    out = {}
    for name in names:
        program, meta = cells[name]()
        st = D.cell_stats(program, meta, meta["n_devices"])
        r = {"flops_per_device": st["flops_per_device"],
             "peak_live_bytes": st["memory"]["peak_live_bytes"],
             "argument_bytes": st["memory"]["argument_bytes"],
             "moved_bytes": st["collectives"]["total"]["moved_bytes"],
             "collectives": st["collectives"]["by_kind"],
             "trace_s": st["trace_s"], "records": st["hlo_chars"]}
        print(f"  dry run {name}: flops/dev {r['flops_per_device']:.4e}, "
              f"peak bytes/dev {r['peak_live_bytes']:.4e}, moved bytes/dev "
              f"{r['moved_bytes']:.4e}, trace {r['trace_s']} s "
              f"({r['records']} records)", flush=True)
        for k in ("flops_per_device", "peak_live_bytes", "moved_bytes"):
            if not (math.isfinite(r[k]) and r[k] > 0):
                raise AssertionError(f"dry run {name}: {k} = {r[k]}")
        out[name] = r
    return out


def mesh_greedy(bundle, params, cache, logits, n: int, start: int,
                shape, pos_next=None) -> torch.Tensor:
    """``n`` greedy tokens from a prefill's cache and logits (the VLM's
    token t at the 3-D positions ``pos_next + t``); on a mesh the logits
    are gathered whole and each token goes back as the decode shape's
    input DTensor."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    vocab = bundle.cfg.vocab
    tok = whole(logits)[..., :vocab].argmax(-1).to(torch.int32)
    out = []
    for t in range(n):
        batch = {"token": tok}
        if pos_next is not None:
            batch["positions"] = pos_next + t
        if bundle.on_mesh:
            batch = bundle.distribute(batch, bundle.input_pspecs(shape))
        logits, cache = bundle.serve_step(params, cache, batch,
                                          length=start + t)
        tok = whole(logits)[..., :vocab].argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1), logits


def mesh_same(label, got, want) -> dict:
    """Bitwise equality of two tensors (a DTensor gathered whole), else
    their f32 relative L2 distance, which must be at most MESH_REL_L2."""
    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    same = bool(torch.equal(got, want))
    rel = 0.0 if same else float((got.float() - want.float()).norm()
                                 / want.float().norm())
    if not rel <= MESH_REL_L2:
        raise AssertionError(f"1x1 mesh: {label} differs from the plain "
                             f"path (relative L2 {rel:.3e})")
    return {"bitwise": same, "rel_l2": rel}


def mesh_routes_equal(label, got, want) -> int:
    """``route_log``'s picks of the mesh path (DTensors) equal the plain
    path's, call by call; returns the number of calls."""
    if len(got) != len(want):
        raise AssertionError(f"1x1 mesh: {label}: {len(got)} router calls, "
                             f"the plain path {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        if not torch.equal(a, b):
            raise AssertionError(f"1x1 mesh: {label}: router call {i} picks "
                                 "differ from the plain path's")
    return len(got)


def mesh_serve(label, cfg, plain, on_mesh, params, mparams, batch,
               max_len: int, n_decode: int, n_timed: int, timers: list,
               pos_next=None) -> dict:
    """``cfg`` served on the 1×1 mesh (``on_mesh``, its weights
    ``mparams``) against the plain bundle on the same weights
    (``params``): a prefill of ``batch`` (logits and K/V bitwise, else
    within MESH_REL_L2; ``flash_attention`` once a layer on the card) and
    ``n_decode`` greedy tokens (tokens equal, the last logits and K/V as
    the prefill's), the router's picks equal call by call. Appends to
    ``timers`` (the returned dict, its timing): ms per prefill and per
    token (``n_timed`` tokens a run; one run a turn, the checks having
    warmed both paths) in turns (plain, mesh, mesh, plain), the best of
    each, to be run when the host is otherwise idle."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    dev = plain.device
    B, prompt = batch["tokens"].shape
    shape = ShapeConfig("serve", max_len, B, "decode")
    pshape = ShapeConfig("serve", max_len, B, "prefill")
    mbatch = on_mesh.distribute(batch, on_mesh.input_pspecs(pshape))
    out = {"mesh": str(on_mesh.mesh)}
    # no_grad, not inference_mode: DTensor's views (the layers' unbind) set
    # a version counter, which an inference tensor refuses
    with torch.no_grad():
        ops.reset_launch_counts()
        with route_log() as picks:
            logits, cache = on_mesh.prefill(mparams, mbatch, max_len)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        flash = ops.launch_counts().get("flash_attention", 0)
        want = cfg.n_layers if dev.type == "cuda" else 0
        print(f"  1x1 mesh {label} prefill: flash_attention launched {flash} "
              "times", flush=True)
        if flash != want:
            raise AssertionError(f"1x1 mesh {label} prefill: flash_attention "
                                 f"launched {flash} times, not {want}")
        with route_log() as picks_p:
            logits_p, cache_p = plain.prefill(params, batch, max_len)
        out["prefill"] = {
            "logits": mesh_same(f"{label} prefill logits", logits, logits_p),
            "k": mesh_same(f"{label} prefill K", cache.k, cache_p.k),
            "v": mesh_same(f"{label} prefill V", cache.v, cache_p.v),
            "flash_launches": flash}
        with route_log() as more:
            toks, last = mesh_greedy(on_mesh, mparams, cache, logits,
                                     n_decode, prompt, shape, pos_next)
        picks += more
        with route_log() as more:
            toks_p, last_p = mesh_greedy(plain, params, cache_p, logits_p,
                                         n_decode, prompt, shape, pos_next)
        picks_p += more
        if not torch.equal(toks, toks_p):
            raise AssertionError(f"1x1 mesh {label}: greedy tokens differ "
                                 "from the plain path's")
        out["router_calls_equal"] = mesh_routes_equal(label, picks, picks_p)
        out["decode"] = {"tokens_equal": True, "tokens": toks.numel(),
                         "last_logits": mesh_same(f"{label} decode logits",
                                                  last, last_p),
                         "k": mesh_same(f"{label} decode K", cache.k,
                                        cache_p.k)}
        print(f"  1x1 mesh {label}: prefill and {n_decode} greedy tokens at "
              f"B {B} equal the plain path's ({out['router_calls_equal']} "
              f"router calls with equal picks): {out['prefill']} "
              f"{out['decode']}", flush=True)
        del cache, cache_p, logits, logits_p, last, last_p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    runs = {"plain": (plain, params, batch),
            "mesh": (on_mesh, mparams, mbatch)}

    def timed():
        ms = {"prefill": {"plain": [], "mesh": []},
              "token": {"plain": [], "mesh": []}}
        # the checks warmed both paths: one timed run each a turn
        with torch.no_grad():
            for name in ("plain", "mesh", "mesh", "plain"):
                b, p, bt = runs[name]
                t = time.perf_counter()
                lg, c = b.prefill(p, bt, max_len)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms["prefill"][name].append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                mesh_greedy(b, p, c, lg, n_timed, prompt, shape, pos_next)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ms["token"][name].append((time.perf_counter() - t) * 1e3
                                         / n_timed)
                del lg, c
        for what in ms:
            for name in ms[what]:
                ms[what][name] = min(ms[what][name])
        print(f"  1x1 mesh {label} ms per prefill ({B} x {prompt}): mesh "
              f"{ms['prefill']['mesh']:.3f}, plain "
              f"{ms['prefill']['plain']:.3f}; ms per token (B {B}): mesh "
              f"{ms['token']['mesh']:.3f}, plain {ms['token']['plain']:.3f}"
              " (best of two, in turns)", flush=True)
        return ms
    timers.append((out, timed))
    return out


def mesh_host(dev, cfg, timers: list, batch_size: int = LM_BATCH,
              prompt: int = LM_PROMPT, n_decode: int = LM_DECODE,
              train_seq: int = MESH_TRAIN_SEQ,
              train_batch: int = MESH_TRAIN_BATCH) -> dict:
    """(b) ``cfg`` (the dense LM) through ``build(cfg,
    mesh=make_host_mesh(), shape)``: a 1×1 DeviceMesh over a world of one
    on ``dev``. ``mesh_serve``'s prefill and greedy decode against the
    plain bundle on the same weights (its timing appended to
    ``timers``); one adamw training step at TRAIN_CUT_LAYERS layers
    against the plain step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_accum_train_step

    mesh = make_host_mesh(dev)
    max_len = prompt + n_decode
    shape = ShapeConfig("serve", max_len, batch_size, "decode")
    plain = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = plain.init(gen)
    tokens = torch.randint(0, cfg.vocab, (batch_size, prompt), generator=gen,
                           device=dev, dtype=torch.int32)
    on_mesh = build(cfg, mesh, shape)
    out = mesh_serve(cfg.name, cfg, plain, on_mesh, params,
                     on_mesh.distribute(params, on_mesh.param_pspecs()),
                     {"tokens": tokens}, max_len, n_decode,
                     min(MESH_TIMED_TOKENS, n_decode), timers)
    del params

    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    tshape = ShapeConfig("train", train_seq, train_batch, "train")
    m2 = build(cfg2, mesh, tshape)
    p2 = build(cfg2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = p2.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (train_batch, train_seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    opt = optim.adamw(3e-4)
    new_p, _, loss_p = make_accum_train_step(p2, opt, 1)(
        params, opt.init(params), batch)
    mparams = m2.distribute(params, m2.param_pspecs())
    new_m, _, loss_m = make_accum_train_step(m2, opt, 1)(
        mparams, opt.init(mparams), m2.distribute(
            batch, m2.input_pspecs(tshape)))
    leaves = {"loss": mesh_same("train loss", loss_m, loss_p)}
    from repro_torch.models.common import leaves as tree_leaves
    for (path, a), (_, b) in zip(tree_leaves(new_m), tree_leaves(new_p)):
        leaves["/".join(path)] = mesh_same("/".join(path), a, b)
    n_bits = sum(r["bitwise"] for r in leaves.values())
    print(f"  1x1 mesh train step ({TRAIN_CUT_LAYERS} layers, "
          f"{train_batch} x {train_seq}): loss {float(loss_p):.6f}; "
          f"{n_bits} of {len(leaves)} results bitwise equal to the plain "
          f"step's, max relative L2 "
          f"{max(r['rel_l2'] for r in leaves.values()):.3e}", flush=True)
    out["train"] = leaves
    return out


def mesh_family(dev, cfg, impls, timers: list, batch_size: int = LM_BATCH,
                prompt: int = LM_PROMPT,
                n_decode: int = MESH_FAMILY_TOKENS) -> dict:
    """(c) an MoE or VLM ``cfg`` on the 1×1 mesh (``make_host_mesh``):
    ``mesh_serve`` for each MoE dispatch in ``impls`` on one set of seeded
    weights (laid out once on the mesh; the timings appended to
    ``timers``); the VLM's prompt is text, a VLM_IMAGE_GRID² image block
    at 3-D positions, then text (``vlm_positions``, as
    lm_family_phase)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build

    mesh = make_host_mesh(dev)
    max_len = prompt + n_decode
    shape = ShapeConfig("serve", max_len, batch_size, "decode")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build(cfg, device=dev).init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (batch_size, prompt),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    pos_next = None
    if cfg.mrope_sections is not None:
        grid = min(VLM_IMAGE_GRID, math.isqrt(prompt // 2))
        batch["positions"] = vlm_positions(batch_size,
                                           (prompt - grid ** 2) // 2, grid,
                                           dev)
        pos_next = batch["positions"][:, -1:] + 1
    out = {"layers": cfg.n_layers}
    mparams = None
    for impl in impls:
        label = f"{cfg.name} ({impl})" if cfg.moe is not None else cfg.name
        on_mesh = build(cfg, mesh, shape, moe_impl=impl)
        if mparams is None:
            mparams = on_mesh.distribute(params, on_mesh.param_pspecs())
        out[impl] = mesh_serve(label, cfg, build(cfg, device=dev,
                                                 moe_impl=impl),
                               on_mesh, params, mparams, batch, max_len,
                               n_decode,
                               min(MESH_FAMILY_TIMED_TOKENS, n_decode),
                               timers, pos_next)
    del params, mparams
    return out


def mesh_bitwise(label, got, want) -> bool:
    """``got`` (a DTensor gathered whole) equal to ``want`` bit for bit."""
    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    if not torch.equal(got, want):
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        raise AssertionError(f"1x1 mesh: {label} differs from the plain "
                             f"path (relative L2 {rel:.3e})")
    return True


def mesh_seq_state(bundle, params, batch, shape):
    """The state these families decode from: the zero state of ``shape``
    (on a mesh laid out by ``serve_state_pspecs``), whisper's with the
    cross K/V of ``batch["frames"]`` (``precompute_cross``), written into
    the state's shards."""
    from repro_torch.models import whisper
    state = bundle.serve_state_shape(shape)
    if bundle.cfg.family == "audio":
        cross = whisper.precompute_cross(
            bundle.cfg, params, batch["frames"],
            use_kernel=bundle.use_kernels, rules=bundle.rules)
        for key, t in zip(("cross_k", "cross_v"), cross):
            if bundle.on_mesh:
                t = t.redistribute(t.device_mesh, state[key].placements)
                state[key].to_local().copy_(t.to_local())
            else:
                state[key] = t
    return state


def mesh_state_leaves(state) -> dict:
    """A decode state's tensors by path (dict keys, tuple positions)."""
    if isinstance(state, dict):
        return {f"{k}/{p}": t for k in sorted(state)
                for p, t in mesh_state_leaves(state[k]).items()}
    if isinstance(state, tuple):
        return {f"{i}/{p}": t for i, part in enumerate(state)
                for p, t in mesh_state_leaves(part).items()}
    return {"": state}


def mesh_seq(dev, cfg, timers: list, batch_size: int = LM_BATCH,
             prompt: int = LM_PROMPT,
             n_decode: int = MESH_FAMILY_TOKENS) -> dict:
    """(mesh_seq_phase) an SSM, hybrid or audio ``cfg`` on the 1×1 mesh
    (``make_host_mesh``) against the plain bundle on the same seeded
    weights: the prefill's logits bitwise and ``flash_attention`` launched
    ``seq_flash_launches`` times; ``n_decode`` greedy tokens from
    ``mesh_seq_state``: tokens, last logits and every state leaf bitwise;
    the router's picks equal call by call. Appends its timing to
    ``timers``: ms per prefill and per token (MESH_FAMILY_TIMED_TOKENS a
    run) in turns (plain, mesh, mesh, plain), the best of each."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build

    audio = cfg.family == "audio"
    S = WHISPER_TEXT if audio else prompt
    max_len = WHISPER_TEXT if audio else S + n_decode
    pshape = ShapeConfig("serve", max_len, batch_size, "prefill")
    dshape = ShapeConfig("serve", max_len, batch_size, "decode")
    mesh = make_host_mesh(dev)
    plain = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = plain.init(gen)
    batch = plain.make_inputs(ShapeConfig("prefill", S, batch_size,
                                          "prefill"), gen)
    on_mesh = build(cfg, mesh, dshape)
    mparams = on_mesh.distribute(params, on_mesh.param_pspecs())
    mbatch = on_mesh.distribute(batch, on_mesh.input_pspecs(pshape))
    label = cfg.name
    out = {"mesh": str(mesh), "layers": cfg.n_layers}
    with torch.no_grad():
        ops.reset_launch_counts()
        with route_log() as picks:
            logits, _ = on_mesh.prefill(mparams, mbatch, max_len)
        torch.cuda.synchronize()
        flash = ops.launch_counts().get("flash_attention", 0)
        print(f"  1x1 mesh {label} prefill: flash_attention launched {flash} "
              "times", flush=True)
        if flash != seq_flash_launches(cfg):
            raise AssertionError(f"1x1 mesh {label} prefill: flash_attention "
                                 f"launched {flash} times, not "
                                 f"{seq_flash_launches(cfg)}")
        with route_log() as picks_p:
            logits_p, _ = plain.prefill(params, batch, max_len)
        out["prefill"] = {"logits_bitwise": mesh_bitwise(
            f"{label} prefill logits", logits, logits_p),
            "flash_launches": flash}
        state = mesh_seq_state(on_mesh, mparams, mbatch, dshape)
        state_p = mesh_seq_state(plain, params, batch, dshape)
        with route_log() as more:
            toks, last = mesh_greedy(on_mesh, mparams, state, logits,
                                     n_decode, 0, dshape)
        picks += more
        with route_log() as more:
            toks_p, last_p = mesh_greedy(plain, params, state_p, logits_p,
                                         n_decode, 0, dshape)
        picks_p += more
        if not torch.equal(toks, toks_p):
            raise AssertionError(f"1x1 mesh {label}: greedy tokens differ "
                                 "from the plain path's")
        leaves, leaves_p = mesh_state_leaves(state), mesh_state_leaves(state_p)
        if list(leaves) != list(leaves_p):
            raise AssertionError(f"1x1 mesh {label}: decode states differ in "
                                 f"structure: {list(leaves)}, {list(leaves_p)}")
        for k in leaves:
            mesh_bitwise(f"{label} decode state {k}", leaves[k], leaves_p[k])
        out["router_calls_equal"] = mesh_routes_equal(label, picks, picks_p)
        out["decode"] = {"tokens_equal": True, "tokens": toks.numel(),
                         "last_logits_bitwise": mesh_bitwise(
                             f"{label} decode logits", last, last_p),
                         "state_leaves_bitwise": len(leaves)}
        print(f"  1x1 mesh {label} ({cfg.n_layers} layers): prefill of "
              f"{batch_size} x {S} and {n_decode} greedy tokens bitwise "
              f"equal to the plain path's (logits, tokens, {len(leaves)} "
              f"state leaves; {out['router_calls_equal']} router calls with "
              "equal picks)", flush=True)
        del state, state_p, logits, logits_p, last, last_p
    torch.cuda.empty_cache()
    runs = {"plain": (plain, params, batch), "mesh": (on_mesh, mparams,
                                                      mbatch)}
    n_timed = min(MESH_FAMILY_TIMED_TOKENS, n_decode)

    def timed():
        ms = {"prefill": {"plain": [], "mesh": []},
              "token": {"plain": [], "mesh": []}}
        with torch.no_grad():
            for name in ("plain", "mesh", "mesh", "plain"):
                b, p, bt = runs[name]
                t = time.perf_counter()
                lg, _ = b.prefill(p, bt, max_len)
                torch.cuda.synchronize()
                ms["prefill"][name].append((time.perf_counter() - t) * 1e3)
                st = mesh_seq_state(b, p, bt, dshape)
                torch.cuda.synchronize()
                t = time.perf_counter()
                mesh_greedy(b, p, st, lg, n_timed, 0, dshape)
                torch.cuda.synchronize()
                ms["token"][name].append((time.perf_counter() - t) * 1e3
                                         / n_timed)
                del lg, st
        for what in ms:
            for name in ms[what]:
                ms[what][name] = min(ms[what][name])
        print(f"  1x1 mesh {label} ms per prefill ({batch_size} x {S}): mesh "
              f"{ms['prefill']['mesh']:.3f}, plain "
              f"{ms['prefill']['plain']:.3f}; ms per token (B {batch_size}):"
              f" mesh {ms['token']['mesh']:.3f}, plain "
              f"{ms['token']['plain']:.3f} (best of two, in turns)",
              flush=True)
        return ms
    timers.append((out, timed))
    return out


def mesh_wait_for(path: str, timeout: float = 600.0) -> None:
    """Return once the file ``path`` exists."""
    t = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"mesh phase: no {path} in {timeout} s")
        time.sleep(0.05)


def mesh_child(path: str, part: str) -> int:
    """One of the mesh phase's subprocesses (MESH_PARTS; one process holds
    one default process group): "dryrun-i", the fake worlds of the dry
    run's cells MESH_DRYRUN_SPLIT[i] on this host; "host", the
    card's world of one (the 1×1 mesh): its checks beside the dry run,
    its timings once the dry run has exited (MESH_DRYRUN_DONE beside
    ``path``), so that no trace shares the host's cores with them."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    t0 = time.perf_counter()
    res = {}
    if part.startswith("dryrun-"):
        res = {"dryrun": mesh_dryrun(
            MESH_DRYRUN_SPLIT[int(part[len("dryrun-"):])])}
    elif part == MESH_SEQ_PART:
        from repro_torch.kernels import build as kbuild
        kbuild.library()
        dev = torch.device("cuda")
        timers = []
        for name, layers in MESH_SEQ:
            cfg = get_arch(name)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            res[name] = mesh_seq(dev, cfg, timers)
            torch.cuda.empty_cache()
        res["seq_checks_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        while timers:
            out, timed = timers.pop(0)
            out["ms"] = timed()
        res["seq_timed_s"] = time.perf_counter() - t
    else:
        from repro_torch.kernels import build as kbuild
        kbuild.library()
        dev = torch.device("cuda")
        timers = []
        res = {"host": mesh_host(dev, get_arch(LM_ARCH), timers)}
        for name, impls in MESH_FAMILY:
            res[name] = mesh_family(dev, get_arch(name), impls, timers)
            torch.cuda.empty_cache()
        res["host_checks_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        mesh_wait_for(os.path.join(os.path.dirname(path), MESH_DRYRUN_DONE))
        res["host_waited_s"] = time.perf_counter() - t
        t = time.perf_counter()
        while timers:
            out, timed = timers.pop(0)
            out["ms"] = timed()
        res["host_timed_s"] = time.perf_counter() - t
    res[f"{part}_s"] = time.perf_counter() - t0
    if dist.is_initialized():
        dist.destroy_process_group()
    write_record(path, res)
    return 0


def mesh_phase() -> dict:
    """Run ``mesh_child``'s parts (MESH_PARTS) in subprocesses of this
    script at once (the dry run's two on the host's cores, the 1×1 mesh on
    the card), tell the 1×1 mesh's process when the dry run has exited,
    and read their records; the phase's wall time must stay within
    MESH_PHASE_S."""
    import tempfile
    d = tempfile.mkdtemp()
    t = time.perf_counter()
    out = {"dryrun": {}}
    procs, codes = {}, {}
    try:
        procs = {p: subprocess.Popen([sys.executable, os.path.abspath(
            __file__), "--mesh-phase", os.path.join(d, f"{p}.json"),
            "--mesh-part", p]) for p in MESH_PARTS}
        for p in MESH_PARTS[:-1]:
            codes[p] = procs[p].wait(timeout=600)
        open(os.path.join(d, MESH_DRYRUN_DONE), "w").close()
        codes["host"] = procs["host"].wait(timeout=600)
        wall = time.perf_counter() - t
        for p in MESH_PARTS:
            if codes[p] != 0:
                raise AssertionError(f"mesh phase ({p}): exit {codes[p]}")
            with open(os.path.join(d, f"{p}.json")) as f:
                rec = json.load(f)
            out["dryrun"].update(rec.pop("dryrun", {}))
            out.update(rec)
    finally:
        for q in procs.values():
            if q.poll() is None:
                q.kill()
                q.wait()
        shutil.rmtree(d, ignore_errors=True)
    out["wall_s"] = wall
    print(f"mesh phase: {wall:.1f} s (dry run {out['dryrun-0_s']:.1f} "
          f"and {out['dryrun-1_s']:.1f} s in two processes; 1x1 mesh "
          f"checks {out['host_checks_s']:.1f} s beside them, then "
          f"{out['host_waited_s']:.1f} s waiting for the dry run and "
          f"{out['host_timed_s']:.1f} s timing alone)", flush=True)
    if wall > MESH_PHASE_S:
        raise AssertionError(f"mesh phase took {wall:.1f} s > "
                             f"{MESH_PHASE_S} s")
    return out


def mesh_seq_phase() -> dict:
    """Run ``mesh_child``'s MESH_SEQ_PART in a subprocess of this script
    (its own process group) and read its record; the phase's wall time
    must stay within MESH_SEQ_PHASE_S."""
    import tempfile
    d = tempfile.mkdtemp()
    path = os.path.join(d, f"{MESH_SEQ_PART}.json")
    t = time.perf_counter()
    proc = None
    try:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--mesh-phase", path, "--mesh-part",
                                 MESH_SEQ_PART])
        code = proc.wait(timeout=600)
        wall = time.perf_counter() - t
        if code != 0:
            raise AssertionError(f"mesh seq phase: exit {code}")
        with open(path) as f:
            out = json.load(f)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    out["wall_s"] = wall
    print(f"mesh seq phase: {wall:.1f} s (checks {out['seq_checks_s']:.1f} "
          f"s, then {out['seq_timed_s']:.1f} s timing)", flush=True)
    if wall > MESH_SEQ_PHASE_S:
        raise AssertionError(f"mesh seq phase took {wall:.1f} s > "
                             f"{MESH_SEQ_PHASE_S} s")
    return out


def plain_decode_child(src: str, path: str, arch: str) -> int:
    """``--plain-decode``: ms per greedy token (MESH_TIMED_TOKENS a run,
    DECODE_AB_RUNS runs, each after its own prefill) of the plain bundle of
    ``arch`` at its published width, B LM_BATCH after an LM_PROMPT-token
    prefill, with the ``repro_torch`` package under ``src``."""
    src = os.path.abspath(src)
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise AssertionError(f"repro_torch came from {repro_torch.__file__}"
                             f", not {src}")
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.api import build
    kbuild.build()
    kbuild.library()
    dev = torch.device("cuda")
    cfg = get_arch(arch)
    bundle = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    n = MESH_TIMED_TOKENS
    ms = []
    with torch.no_grad():
        for _ in range(DECODE_AB_RUNS):
            logits, cache = bundle.prefill(params, {"tokens": tokens},
                                           LM_PROMPT + n)
            ms.append(timed_ms(lambda: greedy(bundle, params, cache, logits,
                                              n, LM_PROMPT), 1) / n)
    write_record(path, {"src": src, "arch": arch, "ms_per_token": ms})
    return 0


def decode_ab(parent_src: str) -> dict:
    """``--decode-ab``: the plain bundle's decode ms per token of each of
    DECODE_AB_ARCHS with another tree's package (``parent_src``, e.g. a
    ``git archive`` of the parent commit's ``src``) and with this tree's,
    each in a process of its own, in turns (DECODE_AB_ORDER)."""
    import tempfile
    d = tempfile.mkdtemp()
    res = {}
    try:
        for arch in DECODE_AB_ARCHS:
            out = {"parent": [], "this": []}
            for i, name in enumerate(DECODE_AB_ORDER):
                src = (parent_src if name == "parent"
                       else os.path.join(ROOT, "src"))
                path = os.path.join(d, f"{arch}.{i}.json")
                run = subprocess.run([sys.executable, os.path.abspath(
                    __file__), "--plain-decode", path, "--src", src,
                    "--arch", arch], timeout=600)
                if run.returncode != 0:
                    raise AssertionError(f"plain decode ({arch}, {name}): "
                                         f"exit {run.returncode}")
                with open(path) as f:
                    ms = json.load(f)["ms_per_token"]
                print(f"  {arch} plain decode ms per token ({name}): {ms}",
                      flush=True)
                out[name].append(ms)
            best = {k: min(min(r) for r in v) for k, v in out.items()}
            median = {k: float(np.median(sum(v, []))) for k, v in out.items()}
            n = DECODE_AB_ORDER.count("this") * DECODE_AB_RUNS
            print(f"{arch} plain decode ms per token (B {LM_BATCH}, {n} runs "
                  f"of {MESH_TIMED_TOKENS} tokens each): best parent "
                  f"{best['parent']:.3f}, this tree {best['this']:.3f}; "
                  f"median parent {median['parent']:.3f}, this tree "
                  f"{median['this']:.3f}", flush=True)
            res[arch] = {"runs": out, "best": best, "median": median}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res


def graph_smoke() -> dict:
    """``graph_phase`` alone at cora 10×1000, after the kernels' build:
    ``python3 -c "import chip_smoke as C; C.graph_smoke()"`` on the card.
    Prints the card's name and power limit last."""
    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.graph.datasets import synthetic
    from repro_torch.kernels import build
    build.library()
    ds = synthetic("cora", scale=1.0, device=torch.device("cuda"))
    X = ds.augmented(4)
    dims = [X.shape[1]] + [1000] * 9 + [ds.n_classes]
    out = graph_phase(X, ds, dims, ADMMConfig(nu=1e-2, rho=1.0),
                      ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True,
                                 quantize_q=True,
                                 grid=uniform_grid(8, -2.0, 6.0)))
    print(card_line())
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def write_record(path, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--mesh-phase", default=None, metavar="OUT_JSON",
                    help=argparse.SUPPRESS)   # mesh_phase's subprocess
    ap.add_argument("--mesh-part", default="host",
                    choices=MESH_PARTS + (MESH_SEQ_PART,),
                    help=argparse.SUPPRESS)   # which of its parts
    ap.add_argument("--ab", default=None, metavar="OTHER_ROOT",
                    help="only time fista_zlast, admm_pgrad, unpack_codes "
                         "and pack_codes built from another tree's sources "
                         "against this one's, and G's and G-Q's ms per "
                         "iteration with its package, in turns")
    ap.add_argument("--train-child", default=None, metavar="OUT_JSON",
                    help=argparse.SUPPRESS)   # train_ab's subprocess
    ap.add_argument("--decode-ab", default=None, metavar="OTHER_SRC",
                    help="only time the plain bundle's decode with another "
                         "tree's src/ against this one's, in turns")
    ap.add_argument("--plain-decode", default=None, metavar="OUT_JSON",
                    help=argparse.SUPPRESS)   # decode_ab's subprocess
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help=argparse.SUPPRESS)   # its package's tree
    ap.add_argument("--arch", default=LM_ARCH,
                    help=argparse.SUPPRESS)   # and its arch
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if args.mesh_phase:
        return mesh_child(args.mesh_phase, args.mesh_part)
    if args.plain_decode:
        return plain_decode_child(args.src, args.plain_decode, args.arch)
    if args.train_child:
        return train_child(args.src, args.train_child)
    if args.decode_ab:
        record = {"card": card_line(), "decode_ab": decode_ab(args.decode_ab)}
        print(record["card"])
        if args.out:
            write_record(args.out, record)
        return 0

    from repro_torch.core.pdadmm import ADMMConfig
    from repro_torch.core.quantize import uniform_grid
    from repro_torch.graph.datasets import synthetic
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    t_build = time.perf_counter() - t0
    print(f"build: {lib_path} in {t_build:.1f} s", flush=True)
    log = (lib_path.parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    sass = sass_report(lib_path)
    for k in ("fused_linear_tc", "admm_pgrad_tc", "resnorm_partials_tc"):
        if sass and not any(k in n and c["HGMMA"] for n, c in sass.items()):
            raise AssertionError(f"SASS: no HGMMA in {k}")

    device = torch.device("cuda")
    ds = synthetic("cora", scale=1.0, device=device)
    X = ds.augmented(4)
    dims = [X.shape[1]] + [1000] * 9 + [ds.n_classes]
    cfg = ADMMConfig(nu=1e-2, rho=1.0)
    cfg_q = ADMMConfig(nu=1e-2, rho=1.0, quantize_p=True, quantize_q=True,
                       grid=uniform_grid(8, -2.0, 6.0))
    print(f"cora: V={X.shape[0]} X={tuple(X.shape)} dims={dims}", flush=True)

    if args.ab:
        csrc = os.path.join(os.path.abspath(args.ab), "src", "repro_torch",
                            "kernels", "csrc")
        record = {"card": card_line(), "launch_floor_ms": launch_floor_ms(
            device), "fista_ab": fista_ab(csrc, ds, cfg.nu, dims[1]),
            "kernels": kernel_ab(csrc, X, dims, cfg.nu, cfg.rho)}
        del X, ds
        torch.cuda.empty_cache()
        record["train"] = train_ab(args.ab)
        print(record["card"])
        if args.out:
            write_record(args.out, record)
        return 0
    rows = kernel_phase(X, ds, dims, cfg.nu, cfg.rho, cfg_q.grid)
    runs = {}
    state, runs["G"] = train_phase(X, ds, dims, cfg, EPOCHS, BASE_KERNELS,
                                   "pdADMM-G")
    runs["G"]["profile"] = profile_phase(
        "pdADMM-G", iterate_once(X, ds, cfg, state), runs["G"]["ms_per_iter"])
    state_q, runs["GQ"] = train_phase(X, ds, dims, cfg_q, EPOCHS, GQ_KERNELS,
                                      "pdADMM-G-Q")
    runs["GQ"]["profile"] = profile_phase(
        "pdADMM-G-Q", iterate_once(X, ds, cfg_q, state_q),
        runs["GQ"]["ms_per_iter"])
    runs["GQ_u_wire"] = wire_phase(X, ds, cfg_q, state_q)
    runs["wire_bytes_per_iter"] = wire_bytes(dims, X.shape[0], cfg_q.grid)
    for key in ("G", "GQ"):
        r = runs[key]
        print(f"{key}: ms per iteration: kernels {r['ms_per_iter']:.3f}  "
              f"plain {r['ms_per_iter_plain']:.3f}; test accuracy "
              f"{r['test_acc']:.4f} (plain {r['test_acc_plain']:.4f})",
              flush=True)
    runs.update(dist_phase(X, ds, cfg, cfg_q, EPOCHS))
    runs["replay"] = replay_phase(X, ds, cfg, cfg_q, EPOCHS)
    runs["contract"] = contract_phase(X, ds, cfg)
    runs["ft"] = ft_phase(X, ds, dims, cfg, cfg_q, EPOCHS, runs)
    runs["graph"] = graph_phase(X, ds, dims, cfg, cfg_q)
    runs["baselines"] = baseline_phase(X, ds, dims, cfg, runs)
    del X, ds
    torch.cuda.empty_cache()
    from repro_torch.configs.base import get_arch
    runs.update(lm_phase(device, get_arch(LM_ARCH)))
    torch.cuda.empty_cache()
    runs.update(lm_family_phase(device))
    torch.cuda.empty_cache()
    runs.update(lm_seq_phase(device))
    torch.cuda.empty_cache()
    runs.update(phi3_phase(device))
    torch.cuda.empty_cache()
    runs.update(lm_train_phase(device, get_arch(LM_ARCH)))
    torch.cuda.empty_cache()
    runs["mesh"] = mesh_phase()
    runs["mesh_seq"] = mesh_seq_phase()

    # each kernel's launches come from the run whose path needs it
    run_of = dict.fromkeys(BASE_KERNELS, "G")
    run_of.update(backtrack_resnorm="GQ", grid_project="GQ",
                  grid_encode="GQ_u_wire", grid_decode="GQ_u_wire",
                  pack_codes="mixed", unpack_codes="mixed",
                  flash_attention="LM_prefill", fista_zlast_wide="block_d")
    # the wide route's launches: block-pdADMM's CE route at h classes,
    # where every fista_zlast launch takes it
    block_d = runs["baselines"]["block_d"]
    runs["block_d"] = {"iterations": block_d["iterations"], "launches": {
        "fista_zlast_wide": block_d["launches"]["fista_zlast"]}}
    kernels = []
    for name, cases in rows.items():
        head = cases[0]
        run = runs[run_of[name]]
        n_iter = run.get("iterations", EPOCHS)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": run["launches"][name],
            "launches_run": run_of[name],
            "launches_per_iter": run["launches"][name] / n_iter,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "cases": cases})
    card = card_line()
    wall = time.perf_counter() - t0
    record = {"card": card, "build_s": t_build, "wall_s": wall,
              "sass_tensor_core": sass, "kernels": kernels, "train": runs}
    if args.out:
        write_record(args.out, record)
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is not finite")
    print(f"chip_smoke: wall time {wall:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
