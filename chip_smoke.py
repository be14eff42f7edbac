"""Drive the PyTorch/CUDA port (``fia_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. require a CUDA device; print the card's name and power limit;
  2. build every CUDA kernel of the paths from the sources in the
     checkout (``mf_scores``, ``ncf_scores``, ``segment_hessian``,
     ``segment_certificate``, ``block_eigmin``; one ``nvcc`` each, all
     started together);
     print ``nvcc --version`` and
     each kernel instantiation's ``ptxas`` registers and spills;
  3. hold ``segment_hessian`` (two launches: the pieces, their
     combination) bit for bit against its plain pieced form
     (``piece=piece_rows(d)``: pieces of P rows from each segment's
     start, each in row order, the partials added in piece order; run on
     the card, and held bit for bit to the same form on the CPU on two
     cases) and against float64 (``SEG_RTOL``), on the main path's
     operands at every batch size and on synthetic segments at every block
     size RQ2 runs (d = 34, 64, 514, 1,024): empty, one row, the longest
     related set of the data, P - 1, P, P + 1 and 3P + 5 rows, wv = 0
     rows, a truncated last segment; two launches the same bits; one
     segment the same bits at another offset in another batch size.
     Then hold each score kernel against its plain PyTorch version on
     the card, at
     its main path's shapes plus edge cases (a ragged row count, a fully
     masked segment, rows matching neither query id, rows that are their
     query's own pair (a = b = 1), rows permuted so that ``t`` is
     unsorted, one query over many row tiles; MF's scalar path and k = 6;
     NCF's general path on unaligned tables, and NCF at every width of the
     sweep, k = 6, 8, 32, 64, 128 and 256, where at k = 64, 128 and 256
     the kernel and the float32 plain version are each held against the
     plain version in float64), and require that two launches on the same
     inputs give the same bits;
  4. drive each main path — ``InfluenceEngine.query_batch`` at ML-1M
     shape (6040 users x 3706 items, 975,460 rows, k = 16), random seeded
     weights, for 256 and then 1024 held-out queries, first MF, then
     NCF; require that it launched its score kernel and ``segment_hessian``
     (each geometry a captured CUDA graph, whose replays count the
     launches it holds), that its scores equal those of the same engine
     with the plain score stage, and that a small input agrees with the
     port's CPU path;
  S. split invariance: the probe (:func:`probe`) takes fixed queries
     through the flat program at several batch compositions and
     requires every stage's per-query output (g and e rows, H_t, v_t,
     iHVP, reg_dot, scores) the same bits, at k = 16 and every RQ2 width,
     MF and NCF, and the batched LU alone the same bits at every batch
     size; the any-split phase requires ``query_many`` over 1024 queries
     at ``batch_queries`` 1024, 256, 100, 64 and 23 bitwise equal to one
     dispatch; the graph phase requires a replayed graph bitwise equal to
     the eager program, ``precompile_flat`` to report compiled then
     cached, and a warm ``query_batch`` plus ``query_many`` at two
     geometries to capture nothing (``utils/compilemon``);
  5. time the stages (and the Hessian stage of the one-hot form it
     replaced, in the same run), the end-to-end query rate with graphs
     and the eager program's, and each kernel beside its bound and its
     plain version (CUDA events; the card's power limit is printed
     beside them);
  6. drive the padded per-query program, first MF, then NCF, on 256 of
     the same queries: ``impl="padded"`` with the direct solve, then
     ``solver="cg"``, ``"schulz"`` and ``"lissa"`` (spectral tuning,
     depth 5,000, half the reference's 10,000). Require that every result
     was computed on the card,
     that neither score kernel launched (the padded path scores by
     matvec), that two identical calls give the same bytes, and that
     counts and related rows equal the flat path's; hold padded-direct,
     cg and schulz to the flat direct path of phase 4 (rtol 1e-3, atol
     1e-5, per-query Spearman ≥ 0.999), and LiSSA, which need not have
     converged at that depth, to the same truncated recursion in float64
     on the materialised block Hessians of 32 queries with the same
     (scale, shift) (rtol 1e-3, atol 1e-5); its Spearman against direct
     is recorded, not gated. On phase 4's small input, run every
     configuration of the padded program (also the autodiff Hessian,
     static LiSSA, ``group_queries`` and ``pad_policy="dataset"``) on
     the card against the port's CPU path, at the same bars. Time each
     solver's ``query_batch`` (median
     of 3 after a warm-up, of 2 for LiSSA), its device busy share and
     top kernels, the CG and Schulz iteration counts and LiSSA's ms a
     recursion step, under ``models.<family>.padded`` in the ``perf``
     line;
  7. training and the paper's experiments, first MF, then NCF, under
     ``models.<family>.train``:
     a. on phase 4's small input (k = 8), ``Trainer.fit`` through all
        three phases (minibatch Adam, full-batch Adam, SGD), a
        ``retrain`` and ``loo_retrain_many`` with four lanes (one of
        them -1) on the card against the same calls on the CPU with the
        same schedules, per-step losses and params at rtol 1e-4 /
        atol 1e-6; lanes chunked 2 and 4 agree at the same bar;
     b. at ML-1M shape (k = 16, batch 3020), a bounded run of each
        training phase (``FULL_STEPS``), steps/s per phase, the device
        busy share of a 200-step window, the loss required to fall; a
        checkpoint round trip through ``save_rotated`` and
        ``restore_latest_valid`` required bitwise; ``query_batch`` at
        T = 256 on the trained weights, kernel against plain score
        stage at phase 4's bar, relu-boundary rows counted;
     c. RQ1: ``test_retraining`` on two held-out points with 7b's
        weights (16 removals x 2 repeats, all lanes in one stack),
        every lane finite, the score kernel launched for each point;
        lane-steps/s, Pearson and Spearman printed, not gated;
     d. RQ2: ``time_influence_queries`` at k = 8 ... 256 on 64 held-out
        points with seeded weights, through ``query_batch`` and through
        ``query_many(batch_queries=32)``; at each k the kernel's
        ``query_batch`` against the plain score stage's at phase 4's
        bar; each ``query_many`` batch bitwise equal to ``query_batch``
        on its queries, no dispatch waiting on the card
        (``torch.cuda.set_sync_debug_mode``), and the whole bitwise equal
        to one ``query_batch``; each width's stages timed by cumulative
        prefix, its captured geometries counted with their memory.
     The kernel launches of each path (phase 4's ``query_batch``, 7c,
     7d) go into the ``kernels`` line under ``launches_by_path``.
  8. the rest of the solver ladder at ML-1M shape, first MF, then NCF,
     under ``ladder`` in the ``perf`` line:
     a. ``segment_certificate`` (two launches a call) against its
        plain version on the card (rtol 1e-5 plus 1e-6 of the output's
        largest entry, NaN and infinity where it is), on the sampled
        program's operands at T = 256 and 1024 and on synthetic
        segments (empty; m = 0; m = 1; m = n; m = cap < n; the longest
        related set; one truncated at the flat pad; pad rows past the
        last segment; an infinite row that is not sampled, which must
        make its segment's σ̂ NaN); two launches the same bits; its ms
        by graph replay beside its bytes bound and the plain version;
     g. ``block_eigmin`` (the sampled certificate's λ_min: Householder
        tridiagonalisation, then Sturm multisection) on the sampled
        program's H at T = 256 and 1024, and (once) on synthetic
        blocks: diagonal, repeated eigenvalues, indefinite, λ_min at the
        damping floor, and d = 18, 130, and 16 blocks at each of
        ``EIG_WIDE_D`` (256, 258, 512, 514, 1,024: one thread-block
        cluster a block, of 2, 2, 3, 3 and 11 CTAs; the damping-floor
        and indefinite kinds at 512 too), and 1,024 random and
        indefinite blocks at each of ``EIG_SMALL_D`` (d = 2 … 12). Each
        block's λ_min bit for bit its plain version (run on the card)
        and, from d = ``EIG_REACH`` (12) up, within ``EIG_C`` · d · eps ·
        ‖H‖_F of float64 ``eigvalsh`` (the largest c seen, and each
        case's λ_min range beside its bar, are printed; below 12, where
        float32 ``eigvalsh`` misses that bar too, c is printed beside
        its c, with the least width from which the bar held); two
        launches the same bits; a block the same bits in a batch of 1
        and in the whole batch; a diagonal block exactly its smallest
        diagonal entry; ms by graph replay beside its bound, the plain
        version and ``torch.linalg.eigvalsh`` in pieces of 64 (the
        library call it replaced, which the port no longer calls); at
        each wide width the kernel's ms (events) required below
        ``eigvalsh``'s on the same blocks, with its rounds, cluster size,
        resident clusters and the device-memory scratch of a call on
        1,024 blocks (``max_memory_allocated`` less the output, checked
        0 there and at the main path's T = 1024);
     h. the sampled rung at RQ2's upper widths (MF k = 256, d = 514; NCF
        k = 128, d = 512) on 256 queries beside direct on the same
        queries: wall ms, busy share, ``block_eigmin``'s share of the
        device time, the graph pools; the rung's H on those queries
        held as g holds a case;
     b. ``segment_hessian`` under the sampled rung's weights n/m, on
        the sampled program's operands and on synthetic segments (m < n,
        m = 1): bit for bit the plain pieced form, and within the
        float64 bar;
     c. the sampled rung (``solver="sampled"``, cap 64; one captured
        CUDA graph a geometry): each of its kernels launched; a replayed
        graph bitwise the eager program; no host wait while a dispatch
        is queued (``torch.cuda.set_sync_debug_mode("error")``); on phase
        4's small input the card against the CPU path, each query's
        largest score error within ``CPU_RTOL`` of its largest |score|;
        |sampled − direct| <= err_bound + 1e-6 on at
        least 99% of 1024 queries; at cap 1e6 bitwise the direct path
        with every bound 0; ``query_many`` at 1024, 256, 100 and 23 a
        batch bitwise one dispatch, scores and bounds; at a tolerance
        of the median bound of 64 queries, those over it bitwise the
        lissa rung's (depth 200), each in its place; wall ms and
        scores/s (median of 5) beside direct, busy share and device ms
        by kernel, host waits a dispatch, ``sample_weights``' host ms;
        each captured geometry's graph pool beside the eager program's
        peak memory on the same batch;
     d. the factor bank: 1024 hot pairs built (time, Cholesky and
        inverse kinds, MB), published, loaded with nothing stale; on
        256 queries, half bank pairs, hits at Spearman >= 0.999 against
        direct, misses bitwise direct, a hit alone the same bits as in
        the batch; all-hit batches of 256 and 1024 beside direct (and
        the graph pools of the engines' sampled miss delegates); a
        user's row moved, ``refresh_bank`` drops exactly the entries it
        touches; the library calls' times (``cholesky_ex``, ``eigh``,
        the bank solve, ``eigvalsh`` in pieces of 64);
     e. ``FullInfluenceEngine`` (MF, ML-1M shape, CG, maxiter 100, two
        points): ms an HVP, iterations, relative residual; on phase 4's
        small input the card against the CPU at rtol 1e-4;
     f. ``FIAModel`` on phase 4's small input, trained 60 steps on the
        card: its influence bitwise the engine's.
     The ``kernels`` line gains the ``segment_certificate`` and
     ``block_eigmin`` rows, and each row's ``launches_by_path`` the
     sampled and bank paths.
  9. recovery and observability, first MF, then NCF, at ML-1M shape on
     phase 8's held-out queries (the memory envelope in a temporary
     file), under ``recovery`` in the ``perf`` line:
     a. a worker death injected at the second dispatch of
        ``query_many`` (1024 queries, 256 a batch, 4 in flight): every
        batch bitwise the run without the fault, ``engine.upload`` fired
        once, the captured graphs dropped and recaptured (counts before
        and after printed), no tensor from before the reset reachable
        from the engine or its delegates;
     b. in ``query_batch(1024)``, a worker death at the first dispatch
        retried as 512 + 512 and a preemption retried once at 1024, each
        bitwise the run without the fault;
     c. a real CUDA OOM on the flat path (all but 1 MiB of the card's
        free memory, and the allocator's cached free blocks, held by
        blockers, then a geometry not captured yet), and one raised
        inside a capture (the captured program asks for more memory than
        the card has): with ``cpu_fallback=False`` it rises classified
        OOM, the capture ended and the graph's pool released; with
        the CPU rung on (``cpu_fallback=True``) on phase 4's small input,
        the answer within phase 4's card-vs-CPU bar, one batch counted in
        ``engine.cpu_fallback_batches`` and one reliability diagnostic;
        no capture
        left open; once the blocker is freed, the same engines answer on
        the card bitwise as before;
     d. a real CUDA OOM on the padded direct program at T = 256 under
        ``set_per_process_memory_fraction`` (the resident memory plus
        three quarters of the full batch's own): it ends in halves, at
        phase 6's bars against the uncapped run (bitwise or not,
        printed), the memlimits file holds the failing size as the
        ceiling, and a fresh engine dispatches only the chunks that
        succeeded, none failing;
     e. (once) a device-side assert in a child process, then a query:
        it raises classified DEVICE_LOST within 60 s, with no retry,
        reset or CPU rung;
     f. ``query_many(1024)`` traced (``obs.configure(trace=True)``) with
        each dispatch under ``set_sync_debug_mode("error")``: bitwise the
        untraced run, ``engine.query`` and ``engine.dispatch_flat`` spans
        present, the Perfetto and Prometheus exports parse; the traced
        and untraced walls (``utils.timing.fenced_time``) are printed,
        not gated.
 10. serving, first MF, then NCF, at ML-1M shape on phase 4's engines
     and phase 8's held-out queries, under ``serving`` in the ``perf``
     line:
     a. the direct service (``ServeConfig(max_batch=1024,
        dispatch_window=2)``): 4,096 requests of ``smoke_stream`` (hot
        share 0.5, seed 10), drained every 1,024; ``warmup`` over each
        drain's expected misses reports every planned geometry built,
        and nothing is captured from the first request on; every answer
        bitwise ``query_many`` over the dispatch order at 1,024, each
        hot hit bitwise the compute that filled it, all 4,096 ok, host
        waits a drain at most its batches, the score kernel and
        ``segment_hessian`` launched, no recovery; requests/s, latency
        (submit to answer) p50/p95/p99, solve ms, the hot-hit share and
        the device busy share (the stream again, under the profiler)
        printed;
     b. brownout: a ``precomputed`` service on 8d's bank, driven to
        ``bank_preferred`` by two drains a worker death at
        ``serve.dispatch`` sheds, then 512 requests, 256 banked pairs
        and 256 others: hits at tier ``precomputed`` bitwise the bank
        engine's ``query_batch``, the others ``approx`` with a bound,
        |approx − direct| <= bound + 1e-6 on at least 99%,
        ``segment_certificate`` and ``block_eigmin`` launched, the exact
        answers bitwise a run with approx serving off; captures and
        ``sample_weights``' host ms beside the sampled program's device
        ms printed;
     c. faults: a worker death at ``serve.dispatch`` on batch 1 of 10a's
        stream sheds exactly that batch's requests (the rest bitwise
        10a, a replay the same set); one at ``engine.dispatch_flat`` with
        two batches in flight (1,024 queries, 256 a batch, three in the
        window: the third dispatch fails) reroutes after a device-state
        reset, every answer bitwise, no pre-reset tensor reachable;
     d. (once) ``cli.serve --warmup 64 --smoke_requests 512`` and
        ``cli.factor --verify`` in process on the card, each returning
        0; the verify's worst Spearman printed.
     The score, Hessian, certificate and λ_min rows of the ``kernels``
     line gain a ``serve`` path under ``launches_by_path``.
 11. streaming updates and the audit subsystem, under ``stream`` (11a)
     and ``audit`` (11b–11d) in the ``perf`` line; 11a and 11b first MF,
     then NCF:
     a. on a community graph of ML-1M's shape (``community_ratings``:
        USERS x ITEMS, ROWS rows in 40 communities; on phase 4's data the
        read reach of 256 held-out pairs is every user and item, printed,
        so no block there lies outside a footprint), a ``FIAModel`` with
        a factor bank of its 64 hottest pairs and a direct service
        (``max_batch`` 1,024, ``dispatch_window`` 2) whose hot and disk
        tiers hold 8 probes inside community 0's footprint and 8 outside;
        256 new ratings in community 0, 400 steps (two epoch
        dispatches at batch 3,020), a checkpoint every 200: an OOM
        injected at ``trainer.epoch`` (the second dispatch) and a
        preemption at ``stream.swap`` each roll back, the service
        answering bitwise on the old state; the identical retry resumes
        at step 323 and commits, params bitwise an uninterrupted update's
        on a twin, every row outside the moved masks and every global
        leaf bitwise the old; requests in flight across the swap answer
        bitwise the old engine's ``query_batch``; the warmed pair builds
        nothing; every probe after the swap bitwise a fresh service (0
        stale), the outside ones hot hits re-keyed, the inside ones
        recomputed; the bank refreshed; three more updates with drains
        between them leave ``memory_allocated`` no higher than after the
        first plus one engine's tables and graphs;
     b. ``reverse_topk`` over phase 8's 1,024 held-out queries on 7b's
        trained weights (labels seeded in 1..5, k = 64, 256 a batch):
        bitwise under ``chunk_points=100, batch_queries=64`` and under
        ``segment=4096``, the card's selection exactly the (value, id)
        order of ``group_scores`` and of a tied accumulator, the score
        kernel and ``segment_hessian`` launched, the plan round-tripped;
        then, on 11a's model and service, one sweep over 64 community-0
        held-out pairs gives a reweight plan (w = 0.5) and a removal plan
        (16 rows), each saved and loaded, the first applied through
        ``FIAModel.apply_removal``, the second through ``apply_plan``:
        committed, the probes 0 stale, the outside ones re-keyed;
     c. (once) ``verify_plan`` on phase 4's small input, the lanes on the
        card within 7a's bar of the CPU's and a journaled rerun bitwise
        with nothing appended; then at ML-1M shape on 7b's MF weights, 4
        plan rows and 4 controls, 2 repeats, 300 steps (actual finite;
        sign agreement and Spearman printed, not gated);
     d. (once) ``cli.debug_data`` in process with
        ``scripts/unlearn_smoke.sh``'s arguments: it returns, the
        summary has the reference's keys and the apply committed.
     The score and Hessian rows of the ``kernels`` line gain ``stream``
     (11a's serving after the swap) and ``audit`` (11b's sweep) paths.
 12. the data-axis device mesh (``fia_tpu_torch.parallel.mesh``), first
     MF, then NCF, on phase 4's engines and data and phase 8's held-out
     queries, over meshes of virtual slots laid over ``cuda:0`` (they
     share the card: their walls measure the mesh's overhead, not a
     speedup), under ``mesh`` in the ``perf`` line:
     a. over 1, 2 and 4 slots, ``query_batch`` at T = 256 and 1024,
        ``query_many`` over 1,024 at 300 a batch (ragged) and a batch of
        256 of 8d's banked pairs each bitwise the single-device engine
        (counts, packed scores, iHVPs, test vectors), and
        ``block_hessians`` of 256 queries, every shard of a dispatch
        queued with no host wait;
        ``precompile_flat`` over the mesh geometries, then nothing
        captured by those runs; the geometry keys of two mesh sizes
        disjoint; the state the single-device engine's (one replica a
        physical device, nothing on a card outside the mesh) and
        ``memory_allocated`` of each card at most that state plus the
        graph pools of the engine's programs on it; a program on each
        card of the mesh; ``query_batch(1024)`` wall per size printed
        beside the single-device engine's;
     b. a 4-slot service over 512 requests of 10a's stream at 128 a
        batch: a ``serve.dispatch`` device loss at batch 1 shrinks the
        mesh to 3 slots (``device_loss_recoveries`` 1), every answer
        bitwise the single-device service's, the same traffic again
        captures nothing; a ``mesh.rebuild`` fault during the recovery
        sheds that batch classified while the rest serves bitwise; a mesh
        naming a dead slot (``live_device_ids`` patched) fails
        construction with ``DeviceLost``;
     c. ``Trainer.fit`` on a 2-slot mesh (60 steps at batch 3,020) within
        rtol 2e-4 / atol 1e-5 of single-device; ``loo_retrain_many`` with
        8 lanes on a 3-slot mesh (lanes padded) lane for lane at that bar;
        ``FullInfluenceEngine``'s HVP on a 2-slot mesh within rtol 1e-3 /
        atol 1e-6; ``reverse_topk`` over 256 queries bitwise over 1, 2
        and 4 slots and the meshless engine;
     d. (once) ``cli.rq2 --mesh 2`` and ``cli.serve --mesh 2`` in process
        on 10d's synthetic set over two virtual slots.
     With two or more CUDA devices, a-c run again over the real cards
     (meshes of 2 and of all of them, up to 4; the service over all of
     them, the lanes over up to 3), where each shard runs on its own
     card and the walls measure a speedup; with one, the script prints
     that they did not run. ``python3 chip_smoke.py --phase 12`` runs
     phases 1 and 2, the set-up and 8d's banks, then phase 12 alone: the
     mesh's check on a host of several cards.
     The score and Hessian rows of the ``kernels`` line gain a ``mesh``
     path (12a's, 12b's and 12c's launches).
 13. row-sharded embedding tables on the ``('data', 'model')`` mesh and
     the multi-process runtime (``fia_tpu_torch.parallel.sharded``,
     ``parallel.distributed``), first MF, then NCF, on phase 4's engines,
     data and weights, under ``sharded`` in the ``perf`` line:
     a. ``InfluenceEngine(shard_tables=True)`` over the (data, model)
        meshes (2, 2) and (1, 4) of 4 virtual slots on ``cuda:0``: each
        slot holds exactly ``padded_rows(n, m) / m`` rows of each table;
        ``precompile_flat`` at the geometries of ``query_batch`` at T =
        256 and 1024, then those batches bitwise the single-device engine
        (scores, iHVPs, test vectors) with no capture, the score kernel
        and ``segment_hessian`` launched; 256 of 8d's banked pairs
        bitwise; the padded direct program at T = 256 bitwise the
        replicated padded engine on the same mesh; walls beside the
        single-device engine's. With two or more cards visible, again
        over the real cards (the tables split across cards, the gather
        crossing them);
     b. ``rebuild_mesh`` (2, 2) -> (1, 2) keeps the tables sharded and
        (1, 2) -> (1, 1) places them replicated, ``query_batch(1024)``
        bitwise after each; a service on the (2, 2) sharded mesh loses
        a device at batch 1 and shrinks to (1, 2), every answer bitwise
        the single-device service's;
     c. (once) the script starts two processes of itself
        (``--phase13-worker``), gloo on loopback, each owning 2 virtual
        slots on ``cuda:0``, on ``make_hybrid_mesh(model_parallel=2)``:
        the sharded ``query_batch(1024)`` of MF and NCF, the full
        engine's CG influence and a few data-parallel ``fit`` steps (MF)
        bitwise the one-process (2, 2) mesh on both processes.
     ``python3 chip_smoke.py --phase 13`` runs phases 1 and 2, the
     set-up and 8d's banks, then phase 13 alone. The score and Hessian
     rows of the ``kernels`` line gain a ``sharded`` path (13a's
     launches).
 14. host roles, the host-loss shrink and sharded checkpoints
     (``fia_tpu_torch.serve.hostshard``, ``ServeConfig.host_role``,
     ``train.checkpoint_orbax``), MF and NCF at ML-1M shape, on phase
     4's data and weights, under ``hostroles`` in the ``perf`` line:
     a. the script starts two processes of itself (``--phase14-worker``),
        gloo on loopback, each joining with
        ``initialize(..., local_device_ids=[0])``; each serves the same
        1,024 requests (phase 4's held-out pairs, one drain in batches of
        256) under ``host_role=(h, 2, dir)``: its half of the batches
        through ``query_many`` (the flat program: the score kernel and
        ``segment_hessian``, both counted in each process), its journal
        published, both merged; every answer, iHVP, test vector and batch
        id bitwise one in-process service over the stream (run here
        meanwhile), no adoption; then host 1 restarts here against the
        same journals: no ``query_many`` call, bitwise;
     b. host 0 alone with a 2 s merge budget adopts host 1's shard:
        bitwise, ``host_loss_recoveries`` 1;
     c. a ``serve.dispatch`` host loss at batch 1 on 4 virtual slots over
        2 virtual hosts (``virtual_hosts``): the mesh drops both of host
        1's slots at once, every answer bitwise the meshless service's;
     d. in the two processes, a ``shard_tables`` engine on
        ``make_hybrid_mesh(model_parallel=2)`` (2 virtual slots each, the
        (2, 2) mesh across them): its params saved and restored by both
        (``checkpoint_orbax``, collective over the group) into a template
        of zeros, an engine rebuilt from them, ``query_batch(1024)``
        bitwise the saved engine's; the save and restore seconds printed.
     ``python3 chip_smoke.py --phase 14`` runs phases 1 and 2, the set-up
     and phase 14 alone. The score and Hessian rows of the ``kernels``
     line gain a ``hostroles`` path (14a's launches in each process,
     14b's and 14c's).
 15. the chaos engine and the observability CLI
     (``fia_tpu_torch.chaos``, ``cli.chaos``, ``cli.obs``) on the
     reference's toy workloads (MF, U = 30, I = 20, k = 4), under
     ``chaos`` in the ``perf`` line; each battery runs ``cli.chaos`` in
     process once a smoke scenario (``--scenario``, ``--backend cuda``),
     its kernel launches counted alone:
     a. the smoke battery (``--smoke``: 12 scenarios x 2 benign seeds x
        3 faults): every report passed; every engine a scenario built
        resolved the ``cuda`` score stage; no ``mesh_skipped`` event (the
        mesh scenarios lay virtual slots on the card); in every run that
        ended, each fired ``device_lost`` took one slot off the mesh
        (``mesh_after``) and each ``host_lost`` one host of two slots
        (``hosts_after``); every scenario that queries launched
        ``mf_scores`` and ``segment_hessian``, and ``serve_brownout``
        ``segment_certificate`` and ``block_eigmin``;
     b. one full-domain seed a scenario (``--soak 0:1 --all_kinds``):
        every oracle holds, every error classified;
     c. ``serve_stream`` untraced and traced: the outcome bytes equal
        (the chaos oracle's comparison); the traced run's JSONL through
        ``cli.obs``: ``report`` exits 0 with every chain complete,
        ``trace`` and ``prom`` parse;
     d. the full-domain seed 2 (``--soak 2:3 --all_kinds``), whose kill
        kinds (OOM, deadline) fire inside the workloads: as b, and a kill
        kind fired.
     ``python3 chip_smoke.py --phase 15`` runs phases 1 and 2, then phase
     15 alone (no ML-1M set-up). The score, Hessian, certificate and
     λ_min rows of the ``kernels`` line gain a ``chaos`` path (15a's, 15b's
     and 15d's launches by scenario; ``ncf_scores`` launches none there,
     every scenario being MF).
 16. the port's last modules, under ``parity``, ``lint`` and ``native``
     in the ``perf`` line, on an ML-1M set-up of its own:
     a. the lint on the card's host: ``python -m
        fia_tpu_torch.analysis.lint --self-check`` exits 0 with no
        finding (its files, justified suppressions and seconds printed);
        after b, every kernel module whose launches were recorded into a
        CUDA graph during b (``kernels.captured_counts()``) has its launch
        wrapper (the function that counts the launch) registered as a
        capture scope in the lint's config
        (``REGISTERED_CAPTURE_ENTRY_POINTS``);
     b. the independent oracle: MF and NCF trained on the card at ML-1M
        shape with ``bench.py``'s settings (k = 16, wd 1e-3, batch 3,020,
        lr 1e-3; ``PARITY_STEPS`` minibatch steps, a budget of about 30 s
        a model at phase 7b's rates), then ``query_batch`` (kernel
        ``cuda``, damping 1e-6) on ``PARITY_Q`` held-out pairs against
        ``backends.torch_ref``'s engine on the CPU (``REF_THREADS``
        threads) at its defaults and at ``bench.py``'s converged settings
        (``REF_TIGHT``): identical related sets, and Spearman and Pearson
        >= ``PARITY_MIN`` (``tests/test_parity.py``'s bar) for every
        query against both — save a query where the defaults' solve is
        the side that is off, which ``fmin_ncg``'s early stop is
        (reference behaviour): there the card must be within the bar of a
        float64 solve and the defaults outside it, both printed. The
        reference's seconds a query at its defaults (the CPU baseline,
        beside the host CPU's model) and the card's for the same queries
        are printed; the score kernel and ``segment_hessian`` must have
        launched (``launches_by_path["parity"]``);
     c. the native data path: ``data.native.available()`` (a fallback
        fails the phase); the set-up's ratings written as a TSV, parsed
        natively equal to ``np.loadtxt``'s arrays, ``build_csr`` over
        users and items equal to the stable argsort; an MF engine built
        on the native index gives the numpy index's bits on one
        ``query_batch``; both paths' seconds printed.
     ``python3 chip_smoke.py --phase 16`` runs phases 1 and 2, then phase
     16 alone.
     The whole script runs phases 12, 13, 14, 15 and 16 that way, each in
     a process of its own started once phase 9 is over, beside phases 10
     and 11 in this one, which keeps the script well inside its time
     limit; so the walls of phases 10 to 16 are taken with the other
     processes on the card (and 16b's CPU baseline with theirs on the
     host), and the kernels' times of phases 3 to 8 with none. Their
     output follows phase 11's, each line prefixed ``[12]`` … ``[16]``; a
     failure of any fails the script, and their ``perf`` lines go into
     its own.
     Every engine outside phase 9 is built with ``cpu_fallback=False``
     (the port's default, passed explicitly), and after each earlier
     phase the obs registry must show no retry
     (``reliability.retries_total``), no device-state reset
     (``engine.device_resets``), no batch on the CPU rung
     (``engine.cpu_fallback_batches``) and no reliability diagnostic;
     so must 10a and 10b (the registry is emptied after phase 9),
     phase 11 outside the faults 11a injects (counted, then emptied),
     phase 12 outside 12b's injected losses, phase 13 outside 13b's and
     phase 14 outside 14c's (no retry, reset or CPU rung there either;
     counted, then emptied). Phase 15 injects faults throughout and holds
     its runs to the chaos oracles instead.

NCF's kernel and plain version sum each relu pre-activation in another
order, so a pre-activation within rounding of 0 can take the other side
of its mask and move that row's score far beyond the bar. Such a row
passes only if the plain version in float64 puts one of the row's
pre-activations within ``BOUNDARY_REL`` of 0; the rows so excused are
counted and printed, and any other row beyond the bar fails the run.
The same rule holds the NCF padded path against the flat one (phase 6),
whose relu masks come from another forward pass.

Likewise two rows whose exact scores differ by a few float32 ulps can
be ordered either way by two summation orders, and one such swap costs a
query of 156 rows 3.2e-6 of Spearman. A query below ``RHO_MIN`` passes
only if the plain version in float64 puts every pair the two rankings
order differently within ``TIE_REL`` of each other plus the plain
float32 version's own distance from float64 on the two rows; such pairs
are counted and printed.

The last lines of standard output are a ``perf`` line, the card's
``nvidia-smi`` name and power limit, a ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import platform
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.analysis import config as lint_config
from fia_tpu_torch.backends.torch_ref import TorchRefMFEngine, TorchRefNCFEngine
from fia_tpu_torch.data import native
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.loaders import save_tsv
from fia_tpu_torch.data.synthetic import (
    sample_heldout_pairs,
    synthesize_ratings,
    synthetic_splits,
)
from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.audit import (apply_plan, build_plan, load_plan, reverse_topk,
                                 save_plan, verify_plan)
from fia_tpu_torch.audit import reverse as audit_reverse
from fia_tpu_torch.audit import verify as audit_verify
from fia_tpu_torch.chaos import oracles as chaos_oracles
from fia_tpu_torch.chaos.scenarios import (HostLossRecoveryScenario,
                                           ServeStreamScenario)
from fia_tpu_torch.cli import chaos as chaos_cli
from fia_tpu_torch.cli import obs as cli_obs
from fia_tpu_torch.cli.serve import smoke_stream
from fia_tpu_torch.eval import metrics
from fia_tpu_torch.eval.rq1 import test_retraining
from fia_tpu_torch.eval.rq2 import time_influence_queries
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence import grads as G
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence import sampled as sampled_mod
from fia_tpu_torch.influence import solvers, spectral
from fia_tpu_torch.influence.engine import (STAGES, InfluenceEngine,
                                           _FlatGraph,
                                           _bank_solve, _in_pieces,
                                           capturing)
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.influence.kernels import certificate as kcert
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import eigmin as keig
from fia_tpu_torch.influence.kernels import mf as kmf
from fia_tpu_torch.influence.kernels import ncf as kncf
from fia_tpu_torch.influence.kernels import segment as kseg
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.obs.export import (perfetto, prometheus, read_spans,
                                      span_fields)
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability.journal import Journal
from fia_tpu_torch.serve import (HealthConfig, InfluenceService, Request,
                                 ServeConfig)
from fia_tpu_torch.stream import compute_footprint
from fia_tpu_torch.train import checkpoint
from fia_tpu_torch.train.trainer import (Trainer, TrainConfig, TrainState,
                                         loo_retrain_many)
from fia_tpu_torch.utils import compilemon, memlimits
from fia_tpu_torch.utils.timing import fenced_time

# ML-1M shape and the reference's defaults (bench.py's full run)
USERS, ITEMS, ROWS = 6040, 3706, 975_460
K_EMB, WD, DAMPING = 16, 1e-3, 1e-6
BATCHES = (256, 1024)
# kernel against its plain version, same inputs, same card
RTOL, ATOL = 2e-5, 1e-6
RHO_MIN = 1.0 - 1e-6  # ~5 adjacent swaps of float-noise ties at 400 rows
# the card against the port's CPU path on a small input: another
# Hessian summation order and another LU implementation
CPU_RTOL, CPU_ATOL, CPU_RHO_MIN = 1e-4, 1e-5, 0.9999
# an NCF row beyond the bar is a relu-mask flip only if a float64
# pre-activation of it is within this share of the row's largest (or 1)
BOUNDARY_REL = 1e-5
# two scores closer than this share of the larger (≈ 8 float32 ulps, in
# float64) are a tie that float32 arithmetic cannot order
TIE_REL = 1e-6
# NCF operand-level widths beyond the main path's k = 16: the kernel's
# register-blocked widths (8, 32, 64) and its general path (6, 128, 256);
# and row cuts
NCF_WIDE_K = (6, 8, 32, 64, 128, 256)
NCF_WIDE_ROWS = {256: 65_536}
# widths whose 128..512-term dots drift apart in two float32 orders: there
# the kernel and the float32 plain version are each held against float64
NCF_FLOAT64_K = (64, 128, 256)
# queries whose rows make the one-query case (~4k rows, many row tiles)
ONE_QUERY_FROM = 12
# published H100 SXM peaks (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the padded program (phase 6): its batch, solvers and bars against the
# flat direct path on the same card (the reference's flat-vs-padded bar,
# tests/test_influence.py:356-377, and the rank bar of an iterative solve)
PADDED_T = 256
PADDED_SOLVERS = ("direct", "cg", "schulz", "lissa")
PADDED_RTOL, PADDED_ATOL, PADDED_RHO = 1e-3, 1e-5, 0.999
# LiSSA runs at LISSA_DEPTH steps (half the reference's 10,000, to keep
# the script inside its limit: each step's cost does not depend on the
# depth) and is held to the same truncated recursion in float64 on
# LISSA_GATE_Q queries; a first call slower than LISSA_SLOW_S seconds
# times the rest at LISSA_SMALL_T queries, else one timed call at the
# same queries is compared with the first; the per-step time is over
# LISSA_TIMED_STEPS steps; the profiled call runs LISSA_PROFILE_DEPTH
# steps (a full-depth trace is too large for the profiler)
LISSA_DEPTH = 5_000
LISSA_GATE_Q, LISSA_SLOW_S, LISSA_SMALL_T = 32, 30.0, 64
LISSA_TIMED_STEPS, LISSA_PROFILE_DEPTH = 200, 200
# every configuration of the padded program, on the small input of phase
# 4 on the card against the port's CPU path, at the phase's bars; damping
# 1e-2 keeps MF's blocks there at cond ≤ 2e2, so CG's float32 stopping
# point (‖r‖ ≤ 1e-5‖v‖) stays well inside rtol 1e-3 on both sides
SMALL_DAMPING = 1e-2
SMALL_CONFIGS = {
    "padded direct": {"impl": "padded"},
    "autodiff Hessian": {"impl": "padded", "hessian_mode": "autodiff"},
    "cg": {"solver": "cg"},
    "schulz": {"solver": "schulz"},
    "lissa spectral": {"solver": "lissa", "lissa_depth": 1000},
    "lissa static": {"solver": "lissa", "lissa_tune": "static",
                     "lissa_depth": 1000},
    "group_queries": {"group_queries": True, "pad_bucket": 32},
    "pad_policy dataset": {"pad_policy": "dataset"},
}
# phase 7a: training on the card against the port on the CPU, on phase
# 4's small input at k = 8: one fit through all three phases, a retrain
# and four leave-one-out lanes (one of them -1), with the same schedules
TRAIN_SMALL_FIT = dict(batch_size=200, num_steps=60, learning_rate=1e-2,
                       seed=5, iter_to_switch_to_batch=30,
                       iter_to_switch_to_sgd=45)
TRAIN_SMALL_LOO = dict(removed=(3, -1, 17, 3), seeds=(1, 2, 1, 2), steps=25)
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6
# phase 7b: training at full width (ML-1M shape, the reference's batch
# 3020, lr 1e-3): minibatch Adam for three epochs, then full-batch Adam
# and full-batch SGD; the device-busy share over a 200-step window
FULL_BATCH, TRAIN_LR = 3020, 1e-3
FULL_STEPS = {"minibatch": 969, "batch": 30, "sgd": 30}
BUSY_WINDOW = 200
# phase 7c: RQ1 on two held-out points per model from 7b's weights, all
# (16 + 1) x 2 lanes stacked in one chunk, two epochs of retraining
RQ1_POINTS, RQ1_REMOVE, RQ1_TIMES, RQ1_STEPS = 2, 16, 2, 646
# phase 7d: RQ2's width sweep on 64 held-out points, through query_batch
# and through query_many in batches of 32
RQ2_K, RQ2_Q, RQ2_BATCH = (8, 16, 32, 64, 128, 256), 64, 32
# the any-split phase: 1024 held-out queries through query_many at each
# batch size (ragged finals; t_pad 1024, 256, 128, 64, 64), every query's
# scores, iHVP and test vector the same bits as one dispatch of all
ANY_SPLIT_Q, ANY_SPLITS = 1024, (1024, 256, 100, 64, 23)
# the graph phase: query_batch at T = 256, then query_many at these batch
# sizes over the same queries, once to warm and once counted
GRAPH_T, GRAPH_SPLITS = 256, (8, 16)
# widths whose dots drift apart in two float32 orders: there 7d holds the
# kernel and the float32 plain version each against float64
RQ2_FLOAT64_K = (64, 128, 256)
# the segment-Hessian kernel: bit for bit the plain pieced form
# (piece=piece_rows(d); the same products and sums in the same order: wv is
# 0 or 1 on every case), and against float64 each entry of H_t within
# SEG_RTOL of it plus SEG_ATOL_REL of max |H_t|; an entry beyond that
# passes only within the bound of a float32 sum of the segment's n_t terms
# in order, γ_{n_t} Σ|terms| (γ_n = n u / (1 - n u), u = 2^-24), and is
# counted. Cases: the main path's operands (MF and NCF, every T of BATCHES),
# and
# synthetic rows at every block size of SEG_D (MF k = 16, NCF k = 16, MF
# k = 256, NCF k = 256) with segments empty, of one row, of the longest
# related set (the data's at d <= 64, RQ2's 64 queries' at d > 64), of
# P - 1, P, P + 1 and 3P + 5 rows (P = piece_rows(d)), rows with wv = 0,
# and a last segment truncated at the flat pad
SEG_RTOL, SEG_ATOL_REL = 1e-5, 1e-6
SEG_D = (34, 64, 514, 1024)
# phase 8, the rest of the solver ladder, at ML-1M shape. The certificate
# kernel against its plain version: another float32 order of the same
# sums (σ̂ from up to ~86k squared deviations), rtol 1e-5 plus 1e-6 of the
# output's largest entry; the sampled rung at cap 64, its fidelity gate
# (|sampled − direct| <= err_bound + 1e-6, influence/sampled.py) on at
# least 99% of 1024 queries; query_many at these batch sizes bitwise one
# dispatch; the escalation on 64 queries at LiSSA depth 200; a bank of
# 1024 hot pairs, 256 queries half hits, hits at Spearman >= 0.999 against
# direct (the reference's factor smoke bar); the full-parameter engine's
# CG at maxiter 100, and on the small input the card against the CPU at
# the training bar, rtol 1e-4 (damping 1: the tiny model's full Hessian
# PD, so both CG runs converge); FIAModel trained 60 steps
CERT_SOURCE = "segment_certificate"
CERT_REPLACES = "fia_tpu/influence/sampled.py:103"
CERT_RTOL, CERT_ATOL_REL = 1e-5, 1e-6
SAMPLED_CAP = 64
FIDELITY_SHARE = 0.99
# the sampled rung on phase 4's small input, card against the CPU on the
# same samples: scores at CPU_RTOL / CPU_ATOL, bounds at the rtol that
# tests/test_torch_sampled.py holds the port's bound to against the
# reference's (BOUND_RTOL): another Hessian order, another eigensolver
SAMPLED_BOUND_RTOL = 1e-4
SAMPLED_SPLITS = (1024, 256, 100, 23)
# 8g, the certificate's λ_min kernel: each block bit for bit its plain
# version and within EIG_C · d · eps · ‖H‖_F of float64 eigvalsh (eps =
# 2^-23; the earlier Jacobi kernel within 0.046 on the card) at every width
# from EIG_REACH up, where tests/test_torch_eigmin.py holds the plain
# version to it on the CPU; below, at EIG_SMALL_D (MF and NCF at k = 1 have
# d = 4), neither it nor float32 eigvalsh reaches that bar, and c is
# printed beside eigvalsh's on EIG_SMALL_T blocks of each kind. Synthetic
# blocks of EIG_T each, EIG_WIDE_T at each of the wide widths EIG_WIDE_D
# (RQ2's MF k = 128 and 256, NCF k = 64, 128 and 256), the device-memory
# scratch of a call on BATCHES[-1] blocks at each; 8h: the sampled rung at
# WIDE_RUNG's widths on WIDE_RUNG_T queries, its H held as 8g's
EIGMIN_SOURCE = "block_eigmin"
EIGMIN_REPLACES = "fia_tpu/influence/engine.py:2504"
EIG_C = 0.25
EIG_T, EIG_WIDE_T, EIG_WIDE_D = 64, 16, (256, 258, 512, 514, 1024)
EIG_REACH, EIG_SMALL_T, EIG_SMALL_D = 12, 1024, (2, 3, 4, 5, 6, 8, 10, 12)
WIDE_RUNG, WIDE_RUNG_T = (("mf", 256), ("ncf", 128)), 256
ESCALATE_T, ESCALATE_DEPTH = 64, 200
BANK_ENTRIES, BANK_T, BANK_RHO = 1024, 256, 0.999
FULL_MAXITER, FULL_RTOL, FULL_SMALL_DAMPING = 100, 1e-4, 1.0
EPS32 = float(np.finfo(np.float32).eps)
FACADE_STEPS = 60
# the card (phase 7 names it once)
CARD = "cuda"
SOURCES = {"mf": "mf_scores", "ncf": "ncf_scores"}
SEGMENT_SOURCE = "segment_hessian"
# the reference's XLA segment reduction the Hessian kernel replaces
# (accum: body_scatter / body_onehot, assembled into H_t at 972-977)
SEGMENT_REPLACES = "fia_tpu/influence/engine.py:920"
KERNEL_MODULES = {"mf": kmf, "ncf": kncf}
REPLACES = {"mf": "fia_tpu/influence/kernels/mf.py:25",
            "ncf": "fia_tpu/influence/kernels/ncf.py:30"}


def engine(*args, **kw) -> InfluenceEngine:
    """An engine with the CPU rung off (``cpu_fallback=False``, the
    port's default, passed so that no later default can turn it on): outside
    phase 9 a phase passes on the card or fails, never on a recovery
    ladder (:func:`no_recovery` checks the rest of them)."""
    return InfluenceEngine(*args, cpu_fallback=False, **kw)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's release)."""
    out = subprocess.run([common.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()
    return out[-1].strip() if out else "unknown"


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output, names demangled where ``c++filt`` is."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if m.group(1) in report else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and report:
        names = subprocess.run([filt], input="\n".join(report), text=True,
                               capture_output=True, timeout=60,
                               check=True).stdout.splitlines()
        if len(names) == len(report):
            report = dict(zip(names, report.values()))
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Rank correlation with average ranks for ties."""

    def ranks(x):
        _, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
        # average rank of each distinct value, in sorted order
        start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        return (start + (cnt - 1) / 2.0)[inv]

    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back runs, by CUDA events
    on the current stream, after ``warmup`` runs."""
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


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Device ms of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so the host's launch
    overhead is not counted; the median of ``replays`` replays, so one
    stall of the card during a replay does not set the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # warm up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_breakdown(fn, wall_ms: float, top: int = 8,
                     match: str | None = None) -> dict:
    """Device time of one ``fn`` call by kernel (``torch.profiler``), and
    the busy share of ``wall_ms``, the call's unprofiled host time; with
    ``match``, also the device ms of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    out = {
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                        for e in kern[:top]],
    }
    if match is not None:
        out["matched_ms"] = sum(e.self_device_time_total for e in kern
                                if match in e.key) / 1e3
    return out


def boundary_rows(rel_x, tables64) -> torch.Tensor:
    """(R,) bool: the NCF rows ``rel_x`` whose float64 pre-activations
    (z1, z2) come within BOUNDARY_REL · max(1, max |z| of the row) of 0,
    where a relu mask may rightly differ between two summation orders."""
    P_mlp, Q_mlp, _, _, W1, b1, W2, b2, _ = tables64
    z1, z2 = kncf.preactivations(rel_x[:, 0].long(), rel_x[:, 1].long(),
                                 P_mlp, Q_mlp, W1, b1, W2, b2)
    z = torch.cat([z1, z2], dim=1).abs()
    lim = BOUNDARY_REL * torch.clamp(z.max(dim=1).values, min=1.0)
    return z.min(dim=1).values <= lim


def hold(got, want, wv, what: str, rel_x=None, tables64=None
         ) -> tuple[float, int]:
    """Scores ``got`` against ``want`` at RTOL/ATOL, exact 0 where
    wv = 0. With ``tables64`` (NCF) a row beyond the bar passes only if
    it sits on a relu boundary (:func:`boundary_rows`). Returns the max
    abs error over the other rows and the count of rows so excused."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite scores")
    check(bool((got[wv == 0] == 0).all()), f"{what}: a wv = 0 row scored non-zero")
    diff = (got.double() - want.double()).abs()
    bad = diff > ATOL + RTOL * want.double().abs()
    n_bad = int(bad.sum())
    if n_bad:
        worst = float(diff.max())
        check(tables64 is not None,
              f"{what}: {n_bad} rows beyond rtol {RTOL} atol {ATOL} (max abs "
              f"err {worst:.3e})")
        on_edge = boundary_rows(rel_x[bad], tables64)
        check(bool(on_edge.all()),
              f"{what}: {int((~on_edge).sum())} rows beyond rtol {RTOL} atol "
              f"{ATOL} and not on a relu boundary (max abs err {worst:.3e})")
    err = float(diff[~bad].max()) if int((~bad).sum()) else 0.0
    return err, n_bad


def float32_ties(a, b, exact) -> tuple[int, list]:
    """The pairs of rows that rankings ``a`` and ``b`` (``b`` the plain
    float32 version) order differently: their count, and those that
    ``exact`` (float64) does not put within TIE_REL of each other plus
    the plain float32 version's own error on the two rows, as ``(i, j,
    a_i, a_j, b_i, b_j, exact_i, exact_j)`` (at most three)."""
    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    i, j = np.nonzero(np.triu(sa != sb, 1))
    gap = np.abs(exact[i] - exact[j])
    own = np.abs(b - exact)
    tie = gap <= (TIE_REL * np.maximum(np.abs(exact[i]), np.abs(exact[j]))
                  + own[i] + own[j])
    wide = [(int(x), int(y), float(a[x]), float(a[y]), float(b[x]),
             float(b[y]), float(exact[x]), float(exact[y]))
            for x, y in zip(i[~tie][:3], j[~tie][:3])]
    return len(i), wide


def compare_results(res, ref, what: str, rtol: float, atol: float,
                    rho_min: float, excuse=None, exact=None) -> dict:
    """Counts and related rows exact, scores allclose, per-query
    Spearman; returns the worst errors seen. ``excuse(rows)`` (NCF), on
    the packed row numbers of a query's rows beyond the bar, says which
    lie on a relu boundary: those pass, are counted, and are left out
    of the query's Spearman. ``exact`` (the packed scores in float64)
    lets a query below ``rho_min`` pass when every pair the two rankings
    order differently is a float32 tie (:func:`float32_ties`); it is a
    callable, called only once a query falls below ``rho_min``."""
    check(np.array_equal(res.counts, ref.counts), f"{what}: counts differ")
    offsets = np.concatenate([[0], np.cumsum(res.counts)])
    max_abs, min_rho, excused = 0.0, 1.0, 0
    tie_pairs = 0
    for t in range(len(res.counts)):
        a, b = res.scores_of(t), ref.scores_of(t)
        check(a.shape == b.shape == (int(res.counts[t]),),
              f"{what}: query {t} has {a.shape} scores, want {res.counts[t]}")
        check(bool(np.isfinite(a).all()), f"{what}: non-finite scores")
        keep = np.ones(len(a), bool)
        if len(a):
            bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
            if bad.any():
                worst = float(np.max(np.abs(a - b)))
                ok = (excuse(offsets[t] + np.flatnonzero(bad))
                      if excuse is not None else np.zeros(int(bad.sum()), bool))
                check(bool(ok.all()),
                      f"{what}: query {t} scores differ beyond rtol {rtol} "
                      f"atol {atol} (max abs {worst:.3e})")
                excused += int(bad.sum())
                keep = ~bad
            if keep.any():
                max_abs = max(max_abs, float(np.max(np.abs(a - b)[keep])))
        a, b = a[keep], b[keep]
        if len(a) > 1 and np.ptp(a) > 0 and np.ptp(b) > 0:
            rho = spearman(a, b)
            min_rho = min(min_rho, rho)
            if rho < rho_min:
                check(exact is not None,
                      f"{what}: query {t} Spearman {rho} < {rho_min}")
                n, wide = float32_ties(
                    a, b, exact()[offsets[t]: offsets[t + 1]][keep])
                check(not wide, f"{what}: query {t} Spearman {rho} < "
                      f"{rho_min} and its rankings differ beyond float32 "
                      f"ties: (i, j, a_i, a_j, b_i, b_j, float64 i, j) "
                      f"{wide}")
                tie_pairs += n
    check(bool(np.isfinite(res.ihvp).all()), f"{what}: non-finite ihvp")
    return {"max_abs_err": max_abs, "min_spearman": min_rho,
            "boundary_rows": excused, "float32_tie_pairs": tie_pairs}


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def bound(nb: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mf_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for one MF score call on these
    operands: each input read once, the output written once, against
    ~4k + 10 fp32 operations a row."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    S, k = rel_x.shape[0], P.shape[1]
    return bound(nbytes(*ops) + S * 4, S * (4 * k + 10))


def ncf_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for one NCF score call on these
    operands: each input read once, the output written once, against
    the fp32 operations this run's rows need once every product that
    depends on the query alone is formed once per query. A row with
    wv ≠ 0, a = [user = u_t] and b = [item = i_t] needs, in FMAs, the
    half of [pm|qm] W1 that is not the query's own row (k², none when
    a = b = 1), z2 and dz2 W2ᵀ (2·k·k2), and 2k(a + b) for the dots
    dz1 · (W1ᵀx)-half and (qg or pg) · (w3g ⊙ x)-quarter, plus 5
    operations of the score epilogue. Each query needs 4k² FMAs (its own
    rows times W1, W1's halves times x) and 2k products w3g ⊙ x."""
    tx, t, rel_x, e, wv, B, *tables = ops
    T, k, k2 = tx.shape[0], tables[0].shape[1], tables[6].shape[1]
    q = tx[t.long()]
    live = wv != 0
    a = live & (rel_x[:, 0] == q[:, 0])
    b = live & (rel_x[:, 1] == q[:, 1])
    need = a | b
    fma = (int((need & ~(a & b)).sum()) * k * k
           + int(need.sum()) * 2 * k * k2
           + int(a.sum() + b.sum()) * 2 * k
           + T * 4 * k * k)
    flops = 2 * fma + 5 * int(live.sum()) + T * 2 * k
    return bound(nbytes(*ops) + rel_x.shape[0] * 4, flops)


BOUNDS = {"mf": mf_bound_ms, "ncf": ncf_bound_ms}


def kernel_args(ops):
    """Operands ``(tx, t, rel_x, e, wv, B, *tables)`` in the kernel
    wrappers' order ``(rel_x, t, e, wv, tx, *tables, B)``."""
    tx, t, rel_x, e, wv, B, *tables = ops
    return (rel_x, t, e, wv, tx, *tables, B)


def edge_cases(ops, gen: torch.Generator):
    """(name, operands) at the main path's shapes plus the edge cases
    both kernels take: a ragged S, a fully masked segment, foreign rows,
    rows that are their query's own pair, unsorted ``t``, and one query
    whose rows span many row tiles."""
    tx, t, rel_x, e, wv, B, *tables = ops
    S = rel_x.shape[0]
    cases = [("main path", ops)]
    r = S - 37  # not a multiple of the 64-row block
    cases.append(("ragged S", (tx, t[:r], rel_x[:r], e[:r], wv[:r], B,
                               *tables)))
    wv0 = wv.clone()
    wv0[t == 0] = 0.0  # segment 0 fully masked
    cases.append(("masked segment", (tx, t, rel_x, e, wv0, B, *tables)))
    foreign = rel_x.clone()
    pick = torch.randint(0, S, (S,), generator=gen).to(rel_x.device)
    foreign[::3] = rel_x[pick[::3]]  # mostly rows of other queries
    cases.append(("foreign rows", (tx, t, foreign, e, wv, B, *tables)))
    own = rel_x.clone()
    own[::7] = tx[t[::7].long()]  # a = b = 1
    cases.append(("own pair rows", (tx, t, own, e, wv, B, *tables)))
    perm = torch.randperm(S, generator=gen).to(rel_x.device)
    cases.append(("unsorted t", (tx, t[perm], rel_x[perm], e[perm], wv[perm],
                                 B, *tables)))
    one = t < ONE_QUERY_FROM  # query 0's rows, then other queries' as foreign
    cases.append(("T=1", (tx[:1], torch.zeros_like(t[one]), rel_x[one], e[one],
                          wv[one], B[:1], *tables)))
    return cases


def ncf_cases(ops, gen: torch.Generator):
    """NCF: the edge cases and the general path (one warp a row) at the
    main path's width, which tables off 16-byte alignment take."""
    tx, t, rel_x, e, wv, B, *tables = ops
    cases = edge_cases(ops, gen)
    shifted = []
    for x in tables[:4]:  # the embedding tables, 4 bytes off alignment
        y = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
        y.copy_(x)
        shifted.append(y)
    cases.append(("general path", (tx, t, rel_x, e, wv, B, *shifted,
                                   *tables[4:])))
    return cases


def launch_twice(mod, args) -> torch.Tensor:
    """The kernel's scores; fails unless a second launch on the same
    inputs gives the same bits."""
    got = mod.fused_scores(*args)
    again = mod.fused_scores(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{mod.__name__}: two launches on the same "
          "inputs differ")
    return got


def mf_cases(ops, gen: torch.Generator):
    """MF: the edge cases, the scalar (non-float4) path and k = 6."""
    tx, t, rel_x, e, wv, B, P, Q = ops
    cases = edge_cases(ops, gen)
    # 4-byte offset tables take the scalar (non-float4) path
    P1 = torch.empty(P.numel() + 1, device=P.device)[1:].view_as(P)
    Q1 = torch.empty(Q.numel() + 1, device=Q.device)[1:].view_as(Q)
    P1.copy_(P)
    Q1.copy_(Q)
    cases.append(("scalar path", (tx, t, rel_x, e, wv, B, P1, Q1)))
    # k = 6: a width that is not a multiple of 4
    k6 = 6
    P6 = torch.randn(P.shape[0], k6, generator=gen).to(P.device)
    Q6 = torch.randn(Q.shape[0], k6, generator=gen).to(Q.device)
    B6 = torch.randn(B.shape[0], 2 * k6 + 4, generator=gen).to(B.device)
    B6[:, -1] = B[:, -1]  # keep the real n_t column
    cases.append(("k=6", (tx, t, rel_x, e, wv, B6, P6, Q6)))
    return cases


def ncf_wide_ops(ops, k: int, gen: torch.Generator):
    """NCF operands at width k: the main path's rows, queries and n_t
    column (rows cut to NCF_WIDE_ROWS), seeded random tables and weights
    at the init's scales with small random biases, and a random
    iHVP/reg_dot part of B."""
    tx, t, rel_x, e, wv, B, *_ = ops
    S = min(rel_x.shape[0], NCF_WIDE_ROWS.get(k, rel_x.shape[0]))
    k2 = k // 2
    dev = rel_x.device

    def rnd(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen)).to(dev)

    se = 1.0 / math.sqrt(k)
    tables = (rnd(USERS, k, std=se), rnd(ITEMS, k, std=se),
              rnd(USERS, k, std=se), rnd(ITEMS, k, std=se),
              rnd(2 * k, k, std=1.0 / math.sqrt(2 * k)), rnd(k, std=0.1),
              rnd(k, k2, std=se), rnd(k2, std=0.1),
              rnd(k2 + k, 1, std=1.0 / math.sqrt(k2 + k)))
    Bk = rnd(B.shape[0], 4 * k + 2)
    Bk[:, -1] = B[:, -1]  # keep the real n_t column
    return (tx, t[:S], rel_x[:S], e[:S], wv[:S], Bk, *tables)


def to64(ops):
    return tuple(x.double() if x.is_floating_point() else x for x in ops)


def setup_engines(model, train):
    params = model.init_params(torch.Generator().manual_seed(0), device="cuda")
    eng = engine(model, params, train, damping=DAMPING)
    check(eng.active_kernel_variant() == "cuda",
          f"{type(model).__name__} engine did not pick cuda")
    plain = engine(model, params, train, damping=DAMPING,
                            kernel="torch", device="cuda")
    return eng, plain


def operands(eng, pts, T):
    """The score stage's operands ``(tx, t, rel_x, e, wv, B, *tables)``
    of a T-query batch, from the flat program's "operands" prefix."""
    _, tx, s_pad = eng._flat_inputs(pts[:T])
    out = eng._flat_fn(s_pad, "operands")(
        eng.params, eng.train_x, eng.train_y, eng._postings, tx)
    return (*out, *eng.model.kernel_operands(eng.params))


def check_kernel(family: str, eng, pts) -> dict:
    """Phase 3: the kernel against its plain version on the card."""
    mod = KERNEL_MODULES[family]
    name = SOURCES[family]
    gen = torch.Generator().manual_seed(1)
    ops = operands(eng, pts, BATCHES[0])
    err, excused = 0.0, 0
    # NCF's float64 tables, for its relu-boundary rule
    tables64 = to64(ops[6:]) if family == "ncf" else None
    cases = mf_cases if family == "mf" else ncf_cases
    for case, c_ops in cases(ops, gen):
        args = kernel_args(c_ops)
        got = launch_twice(mod, args)
        want = mod.fused_scores_reference(*args)
        torch.cuda.synchronize()
        e, n = hold(got, want, c_ops[4], f"{name} {case}", c_ops[2], tables64)
        err, excused = max(err, e), excused + n
        log(f"{name} vs plain [{case}] S={len(got)} max abs err {e:.3e}, "
            f"relu-boundary rows {n}")
    if family == "mf":
        return {"max_abs_err": err, "boundary_rows": excused}
    for k in NCF_WIDE_K:
        w_ops = ncf_wide_ops(ops, k, gen)
        args = kernel_args(w_ops)
        got = launch_twice(mod, args)
        plain32 = mod.fused_scores_reference(*args)
        args64 = kernel_args(to64(w_ops))
        want64 = mod.fused_scores_reference(*args64)
        torch.cuda.synchronize()
        t64 = to64(w_ops[6:])
        S = len(got)
        if k not in NCF_FLOAT64_K:  # kernel against the float32 plain version
            e, n = hold(got, plain32, w_ops[4], f"{name} k={k}", w_ops[2], t64)
            log(f"{name} vs plain [k={k}] S={S} max abs err {e:.3e}, "
                f"relu-boundary rows {n}")
        else:
            e, n = hold(got, want64, w_ops[4], f"{name} k={k} vs float64",
                        w_ops[2], t64)
            e32, n32 = hold(plain32, want64, w_ops[4],
                            f"{name} plain k={k} vs float64", w_ops[2], t64)
            log(f"{name} vs float64 plain [k={k}] S={S} max abs err {e:.3e}, "
                f"relu-boundary rows {n}; float32 plain vs float64 "
                f"{e32:.3e}, relu-boundary rows {n32}")
        err, excused = max(err, e), excused + n
    return {"max_abs_err": err, "boundary_rows": excused}


def segment_operands(eng, pts, T):
    """The Hessian kernel's operands ``(g, t, wv, abe, off)`` of a
    T-query batch, from the flat program's "segments" prefix."""
    _, tx, s_pad = eng._flat_inputs(pts[:T])
    return eng._flat_fn(s_pad, "segments")(
        eng.params, eng.train_x, eng.train_y, eng._postings, tx)


def segment_plain(ops, dtype=torch.float32, onehot: bool = False,
                  piece: int | None = None):
    """A plain form of the kernel on ``ops``, in ``dtype``: the scatter
    form in row order, the one-hot product it replaced, or (``piece``)
    the kernel's pieced order."""
    g, t, wv, abe, off = ops
    d = g.shape[1]
    chunk = max(1, min(2048, 4_000_000 // (d * d)))
    return kseg.segment_sums_reference(g.to(dtype), t, wv.to(dtype),
                                       abe.to(dtype), off.numel() - 1, chunk,
                                       onehot=onehot, piece=piece, off=off)


def segment_float64(ops, absolute: bool = False):
    """``(HH, sabe)`` in float64 by definition, a segment at a time on
    the card: (wv g)ᵀ g over its rows, or with ``absolute`` |wv g|ᵀ |g|
    and Σ |abe| (the terms' magnitudes, for the float32 sum's bound)."""
    g, t, wv, abe, off = ops
    S, d = g.shape
    g64, w64, a64 = g.double(), wv.double(), abe.double()
    if absolute:
        g64, w64, a64 = g64.abs(), w64.abs(), a64.abs()
    r0, r1 = (x.tolist() for x in kseg.segment_rows(off, S))
    HH = g64.new_zeros((len(r0), d, d))
    sabe = g64.new_zeros((len(r0),))
    for j, (a, b) in enumerate(zip(r0, r1)):
        if b > a:
            HH[j] = (g64[a:b] * w64[a:b, None]).T @ g64[a:b]
            sabe[j] = a64[a:b].sum()
    return HH, sabe


def segment_launch_twice(ops):
    g, t, wv, abe, off = ops
    got = kseg.segment_sums(g, t, wv, abe, off, 0)
    again = kseg.segment_sums(g, t, wv, abe, off, 0)
    torch.cuda.synchronize()
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "segment_hessian: two launches on the same inputs differ")
    return got


def segment_pieced_plain(ops):
    """The pieced plain form at ``piece_rows(d)`` on the operands' device
    (elementwise float32 products and sums in the kernel's order)."""
    return segment_plain(ops, piece=kseg.piece_rows(ops[0].shape[1]))


def segment_hold(got, ops, what: str) -> dict:
    """``(HH, sabe)`` of the kernel on ``ops`` against the plain pieced
    form (bit for bit) and float64 (at SEG_RTOL / SEG_ATOL_REL, or within
    the float32 recursive-sum bound γ_{n_t} Σ|terms|, counted). Returns
    the largest error as a share of max |H_t| and the count of entries
    the bound excused."""
    g, t, wv, abe, off = ops
    for x, c in zip(got, segment_pieced_plain(ops)):
        check(torch.equal(x, c), f"{what}: not bit for bit the plain "
              "pieced form")
    want = segment_float64(ops)
    absolute = segment_float64(ops, absolute=True)
    n = (off[1:] - off[:-1]).double() * 2.0 ** -24
    gamma = n / (1.0 - n)
    worst, worst_abs, excused = 0.0, 0.0, 0
    for x, w, a in zip(got, want, absolute):
        shape = (-1, *([1] * (w.dim() - 1)))
        scale = w.abs().reshape(w.shape[0], -1).amax(dim=1).reshape(shape)
        diff = (x.double() - w).abs()
        bad = diff > SEG_RTOL * w.abs() + SEG_ATOL_REL * scale
        beyond = bad & (diff > gamma.reshape(shape) * a)
        check(not bool(beyond.any()), f"{what}: {int(beyond.sum())} entries "
              f"beyond rtol {SEG_RTOL} / atol {SEG_ATOL_REL} x max|H_t| of "
              "float64 and beyond the float32 sum's bound (max abs err "
              f"{float(diff.max()):.3e})")
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite sums")
        worst = max(worst, float((diff / scale.clamp(min=1e-30)).max()))
        worst_abs = max(worst_abs, float(diff.max()))
        excused += int(bad.sum())
    return {"max_err_of_max_abs_H": worst, "max_abs_err": worst_abs,
            "excused_by_float32_bound": excused}


def synthetic_segments(counts, S: int, d: int, gen: torch.Generator):
    """Operands ``(g, t, wv, abe, off)`` for segments of ``counts`` rows on
    an S-row flat axis (offsets clamped to S; rows past the total belong
    to the last segment with wv = 0, as the prelude lays them out), random
    rows, and every 7th row's wv = 0."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    T = counts.numel()
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).clamp(
        max=S)
    s = torch.arange(S)
    t = torch.searchsorted(off[1:T].contiguous(), s, right=True).to(
        torch.int32)
    wv = (s < off[-1]).to(torch.float32)
    wv[::7] = 0.0
    g = torch.randn(S, d, generator=gen)
    abe = torch.randn(S, generator=gen) * wv
    return tuple(x.to(CARD) for x in (g, t, wv, abe, off))


def check_segment(engines, pts, longest: int, longest_rq2: int) -> dict:
    """Phase 3 for the Hessian kernel (:func:`segment_hold`) on the main
    path's operands and on synthetic segments at every block size of
    SEG_D; two launches the same bits; the pieced form the same bits on
    the CPU and on the card; and a segment's sums the same bits alone and
    at another offset in another batch size."""
    gen = torch.Generator().manual_seed(2)
    cases = [(f"{f} main path T={T}", segment_operands(eng, pts, T))
             for f, (eng, _) in engines.items() for T in BATCHES]
    for d in SEG_D:
        n = longest if d <= 64 else longest_rq2
        P = kseg.piece_rows(d)
        cases.append((f"d={d} mixed", synthetic_segments(
            [0, 1, n, 5, 0, 77], n + 83 + 300, d, gen)))
        cases.append((f"d={d} truncated", synthetic_segments(
            [40, 1, 300], 191, d, gen)))
        pieces = [P - 1, 0, P, P + 1, 3 * P + 5, 2]
        cases.append((f"d={d} pieces P={P}", synthetic_segments(
            pieces, sum(pieces) + 77, d, gen)))
    worst, worst_abs, excused = 0.0, 0.0, 0
    for name, ops in cases:
        got = segment_launch_twice(ops)
        r = segment_hold(got, ops, f"segment_hessian {name}")
        worst_abs = max(worst_abs, r["max_abs_err"])
        log(f"segment_hessian [{name}] S={ops[0].shape[0]} "
            f"d={ops[0].shape[1]} T={ops[4].numel() - 1}: bit for bit the "
            f"pieced plain form; vs float64 {r}")
        worst = max(worst, r["max_err_of_max_abs_H"])
        excused += r["excused_by_float32_bound"]
    # the pieced form is one function on either device
    for name, ops in cases:
        if name in (f"ncf main path T={BATCHES[-1]}", f"d={SEG_D[2]} mixed"):
            cpu = segment_pieced_plain(tuple(x.cpu() for x in ops))
            card = segment_pieced_plain(ops)
            check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)),
                  f"segment_hessian [{name}]: the pieced plain form differs "
                  "between the CPU and the card")
            log(f"segment_hessian [{name}]: the pieced plain form the same "
                "bits on the CPU and on the card")
    offsets = ((SEG_D[0], longest), (SEG_D[1], 3 * kseg.piece_rows(64) + 5),
               (SEG_D[2], 3 * kseg.piece_rows(SEG_D[2]) + 5),
               (SEG_D[-1], longest_rq2))
    for d, n in offsets:
        g1, t1, wv1, abe1, off1 = synthetic_segments([n], n, d, gen)
        counts = torch.randint(0, 400, (40,), generator=gen)
        counts[23] = n
        g2, t2, wv2, abe2, off2 = synthetic_segments(counts, int(counts.sum()),
                                                     d, gen)
        a, b = int(off2[23]), int(off2[24])
        g2[a:b], wv2[a:b], abe2[a:b] = g1, wv1, abe1
        one = kseg.segment_sums(g1, t1, wv1, abe1, off1, 0)
        many = kseg.segment_sums(g2, t2, wv2, abe2, off2, 0)
        check(torch.equal(one[0][0], many[0][23])
              and torch.equal(one[1][0], many[1][23]),
              f"segment_hessian d={d}: a segment's sums change with its "
              "offset or the batch size")
        log(f"segment_hessian d={d}: a {n}-row segment alone and as segment "
            f"23 of 40 at row {a} (row {a % kseg.piece_rows(d)} of a piece "
            "grid from 0): the same bits")
        del g1, g2, one, many
    torch.cuda.empty_cache()
    return {"max_err_of_max_abs_H": worst, "max_abs_err": worst_abs,
            "excused_by_float32_bound": excused, "longest_segment": longest,
            "longest_segment_rq2": longest_rq2, "cases": len(cases),
            "piece_rows": {str(d): kseg.piece_rows(d) for d in SEG_D}}


def segment_geometry(ops) -> dict:
    """The kernel's work on ``ops``: its pieces (blocks with rows, each
    over every tile pair) and the scratch its later pieces may fill."""
    g, off = ops[0], ops[4]
    S, d = g.shape
    P = kseg.piece_rows(d)
    slots = kseg.scratch_slots(S, P)
    return {"piece_rows": P,
            "pieces": int(kseg.piece_counts(off, S, P).sum()),
            "grid_x": off.numel() - 1 + slots,
            "scratch_mb": slots * (d * d + 1) * 4 / 1e6}


def segment_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for the Hessian sums of ``ops``: the
    rows inside a segment read once (g, wv, abe), the offsets, HH and sabe
    written once; one multiply-add a row for each distinct entry of the
    symmetric block."""
    g, t, wv, abe, off = ops
    d = g.shape[1]
    T = off.numel() - 1
    rows = int(off[-1] - off[0])
    nb = rows * (d * 4 + 8) + (T + 1) * 8 + T * d * d * 4 + T * 4
    return bound(nb, rows * d * (d + 1))


def relu_excuse(family: str, ops):
    """NCF: ``excuse(rows)`` for :func:`compare_results`, over the packed
    row numbers of a batch whose flat operands are ``ops``: which rows
    lie on a relu boundary in float64. MF: ``None``."""
    if family != "ncf":
        return None
    rel_x, tables64 = ops[2], to64(ops[6:])

    def excuse(rows):
        idx = torch.as_tensor(rows, device=rel_x.device)
        return boundary_rows(rel_x[idx], tables64).cpu().numpy()

    return excuse


def drive(family: str, eng, plain, pts) -> dict:
    """Phase 4: the main path, launches counted from 0, against the
    plain score stage on the card and a small input against the CPU."""
    mod = KERNEL_MODULES[family]
    for m in (*KERNEL_MODULES.values(), kseg):
        m.launches = 0
    results = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    launches, seg_launches = mod.launches, kseg.launches
    check(launches > 0, f"the {family} main path never launched "
          f"{SOURCES[family]}")
    check(seg_launches > 0, f"the {family} main path never launched "
          f"{SEGMENT_SOURCE}")
    d = eng.model.block_size
    parity = {}
    for T, res in results.items():
        check(res.ihvp.shape == (T, d) and res.test_grad.shape == (T, d),
              f"{family} T={T}: ihvp/test_grad shapes {res.ihvp.shape}")
        ref = plain.query_batch(pts[:T])
        ops = operands(eng, pts, T)
        total = int(res.counts.sum())

        @functools.cache
        def exact(ops=ops, total=total):
            scores = mod.fused_scores_reference(*kernel_args(to64(ops)))
            return scores[:total].cpu().numpy()
        parity[T] = compare_results(res, ref, f"{family} T={T} kernel vs "
                                    "plain", RTOL, ATOL, RHO_MIN,
                                    relu_excuse(family, ops), exact)
        log(f"{family} T={T}: {int(res.counts.sum())} scores, kernel vs "
            f"plain {parity[T]}")
    # a small input against the port's CPU path
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(eng.model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    on_card = engine(tm, tp, tiny["train"], damping=1e-3
                              ).query_batch(tq)
    on_cpu = engine(tm, tp, tiny["train"], damping=1e-3,
                             device="cpu").query_batch(tq)
    cpu_parity = compare_results(on_card, on_cpu, f"{family} card vs CPU "
                                 "(small)", CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    log(f"{family} card vs CPU path, small input: {cpu_parity}")
    return {"launches": launches, "segment_launches": seg_launches,
            "parity": {str(T): v for T, v in parity.items()},
            "cpu_parity": cpu_parity}


def measure(family: str, eng, train, pts) -> tuple[dict, dict, dict]:
    """Phase 5: stage prefixes, query rate, the kernel beside its bound
    and its plain version, and the device breakdown, per batch size."""
    mod = KERNEL_MODULES[family]
    batches, last, seg_last = {}, None, None
    # the one-hot contraction the Hessian kernel replaced, same weights
    onehot = engine(eng.model, eng.params, train,
                             damping=DAMPING, flat_accum="onehot")
    for T in BATCHES:
        counts, tx, s_pad = eng._flat_inputs(pts[:T])
        args = (eng.params, eng.train_x, eng.train_y, eng._postings, tx)
        stage_ms = stage_times(eng, pts[:T])
        onehot_ms = stage_times(onehot, pts[:T], iters=3)
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            eng.query_batch(pts[:T])  # returns host arrays: synchronised
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[1:]))
        program = eng._flat_fn(s_pad)
        eager = []
        for _ in range(6):
            t0 = time.perf_counter()
            [o.cpu() for o in program(*args)]
            eager.append(time.perf_counter() - t0)
        seg_ops = segment_operands(eng, pts, T)
        seg_ms = graph_ms(lambda: kseg.segment_sums(*seg_ops, 0), iters=20)
        seg_call_ms = time_ms(lambda: kseg.segment_sums(*seg_ops, 0),
                              iters=20)
        # one call's device time by launch (the pieces, the combination)
        seg_parts = device_breakdown(lambda: kseg.segment_sums(*seg_ops, 0),
                                     seg_call_ms)
        # the plain version: the row-order scatter form by graph replay;
        # the pieced form has host waits (its step count): events
        seg_plain_ms = graph_ms(lambda: segment_plain(seg_ops), iters=3)
        seg_pieced_ms = time_ms(lambda: segment_pieced_plain(seg_ops),
                                iters=2, warmup=1)
        seg_onehot_ms = graph_ms(lambda: segment_plain(seg_ops, onehot=True),
                                 iters=1)
        seg_bound, seg_by = segment_bound_ms(seg_ops)
        seg_geo = segment_geometry(seg_ops)
        ops = operands(eng, pts, T)
        k_args = kernel_args(ops)
        k_ms = graph_ms(lambda: mod.fused_scores(*k_args), iters=50)
        p_ms = graph_ms(lambda: mod.fused_scores_reference(*k_args), iters=20)
        call_ms = time_ms(lambda: mod.fused_scores(*k_args), iters=50)
        # one call's device time by kernel (NCF: its two launches)
        parts = device_breakdown(lambda: mod.fused_scores(*k_args), call_ms)
        b_ms, bound_by = BOUNDS[family](ops)
        total = int(counts.sum())
        batches[str(T)] = {
            "scores": total, "s_pad": s_pad,
            "stage_ms_cumulative": stage_ms,
            "hessian_stage_ms": stage_ms["hessian"] - stage_ms["grads"],
            "stage_ms_cumulative_onehot": onehot_ms,
            "hessian_stage_ms_onehot": onehot_ms["hessian"]
            - onehot_ms["grads"],
            "segment_kernel_ms": seg_ms, "segment_plain_ms": seg_plain_ms,
            "segment_pieced_ms": seg_pieced_ms,
            "segment_onehot_ms": seg_onehot_ms,
            "segment_call_ms": seg_call_ms,
            "segment_parts_ms": [[name, ms] for name, ms, _ in
                                 seg_parts["top_kernels"]],
            "segment_geometry": seg_geo,
            "segment_bound_ms": seg_bound, "segment_bound_by": seg_by,
            "query_batch_ms": wall * 1e3,
            "query_batch_ms_runs": [w * 1e3 for w in walls],
            "eager_program_ms": float(np.median(eager[1:])) * 1e3,
            "scores_per_s": total / wall,
            "kernel_ms": k_ms, "kernel_plain_ms": p_ms,
            "kernel_call_ms": call_ms,
            "kernel_parts_ms": [[name, ms] for name, ms, _ in
                                parts["top_kernels"]],
            "kernel_bound_ms": b_ms, "kernel_bound_by": bound_by,
            "query_batch_device": device_breakdown(
                lambda: eng.query_batch(pts[:T]), wall * 1e3),
        }
        last = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": bound_by,
                "shape": {"S": int(ops[2].shape[0]), "T": int(tx.shape[0]),
                          "k": K_EMB}}
        seg_last = {"ms": seg_ms, "plain_ms": seg_plain_ms,
                    "pieced_ms": seg_pieced_ms,
                    "onehot_ms": seg_onehot_ms, "bound_ms": seg_bound,
                    "bound_by": seg_by, **seg_geo,
                    "shape": {"S": int(seg_ops[0].shape[0]),
                              "T": int(tx.shape[0]),
                              "d": int(seg_ops[0].shape[1])}}
        log(f"{family} T={T}: {json.dumps(batches[str(T)], sort_keys=True)}")
    del onehot
    torch.cuda.empty_cache()
    return batches, last, seg_last


def drive_any_split(family: str, eng, pts) -> dict:
    """The any-split phase: ANY_SPLIT_Q held-out queries through
    ``query_many`` at each of ANY_SPLITS, every query the same bits as
    one ``query_batch`` of all (``tests/test_dispatch.py:67-92`` restated
    port against port, on the card)."""
    q = pts[:ANY_SPLIT_Q]
    whole = eng.query_batch(q)
    out = {}
    for bq in ANY_SPLITS:
        parts = eng.query_many(q, batch_queries=bq)
        same_bytes_stitched(parts, whole, f"{family} any split: "
                            f"query_many(batch_queries={bq})")
        out[str(bq)] = {"batches": len(parts), "t_pad": sorted(
            {eng._query_pad(len(r.counts)) for r in parts})}
    out["geometries_captured"] = len(eng._programs)
    log(f"{family} any split, {ANY_SPLIT_Q} queries: bitwise equal to one "
        f"dispatch at batch_queries {ANY_SPLITS}: {json.dumps(out)}")
    return out


def drive_graphs(family: str, eng, train, pts) -> dict:
    """The graph phase: a replayed graph equals the eager program of the
    same geometry bit for bit; ``precompile_flat`` on a fresh engine
    reports two geometries compiled, then cached, and arms the rest of
    the plan; and after one warm pass, ``query_batch`` at GRAPH_T plus
    ``query_many`` at GRAPH_SPLITS capture nothing (the compilemon count
    stays; ``tests/test_dispatch.py:142-162`` restated)."""
    q = pts[:GRAPH_T]
    counts, tx, s_pad = eng._flat_inputs(q)
    eager = eng._flat_fn(s_pad)(eng.params, eng.train_x, eng.train_y,
                                eng._postings, tx)
    res = eng.query_batch(q)
    total, T = int(counts.sum()), len(q)
    check(res._packed.tobytes() == eager[0][:total].cpu().numpy().tobytes()
          and res.ihvp.tobytes() == eager[1][:T].cpu().numpy().tobytes()
          and res.test_grad.tobytes() == eager[2][:T].cpu().numpy().tobytes(),
          f"{family} graphs: a replayed graph differs from the eager program")
    fresh = engine(eng.model, eng.params, train, damping=DAMPING)
    plan = {fresh.flat_geometry(q)}
    for bq in GRAPH_SPLITS:
        plan |= {fresh.flat_geometry(q[i: i + bq])
                 for i in range(0, len(q), bq)}
    two = [fresh.flat_geometry(q), fresh.flat_geometry(q[:GRAPH_SPLITS[0]])]
    first = fresh.precompile_flat(two)
    again = fresh.precompile_flat(sorted(plan))
    check(first["compiled"] == [list(g) for g in two] and not first["cached"]
          and all(list(g) in again["cached"] for g in two)
          and len(again["compiled"]) == len(plan) - 2,
          f"{family} graphs: precompile_flat reported {first} then {again}")
    fresh.query_batch(q)
    for bq in GRAPH_SPLITS:
        fresh.query_many(q, batch_queries=bq)
    before = compilemon.count()
    warm = fresh.query_batch(q)
    for bq in GRAPH_SPLITS:
        fresh.query_many(q, batch_queries=bq)
    check(compilemon.count() == before, f"{family} graphs: the warm steady "
          f"state captured {compilemon.count() - before} programs")
    same_bytes(warm, res, f"{family} graphs: a precompiled engine")
    out = {"replay_vs_eager": "bitwise equal",
           "precompile_two": {"compiled": first["compiled"],
                              "seconds": first["seconds"]},
           "precompile_plan": {"geometries": len(plan),
                               "compiled": len(again["compiled"]),
                               "cached": len(again["cached"]),
                               "seconds": again["seconds"]},
           "steady_state_captures": 0,
           "compiled_geometries_aot": len(
               fresh.compiled_geometries()["aot"]),
           **graph_inventory(fresh)}
    log(f"{family} graphs: {json.dumps(out)}")
    del fresh
    torch.cuda.empty_cache()
    return out


def padded_engine(eng, train, solver: str, **kw):
    """A padded-path engine on ``eng``'s params: ``impl="padded"`` for
    the direct solve, else the iterative ``solver``."""
    kw = dict(kw, **({"impl": "padded"} if solver == "direct"
                     else {"solver": solver}))
    return engine(eng.model, eng.params, train, damping=DAMPING, **kw)


def spy_devices(eng) -> list:
    """Record the device of every output tensor the engine fetches to
    the host (its packed scores, iHVPs and test vectors)."""
    seen = []
    assemble = eng._assemble_packed

    def spy(test_points, counts, outs, pad, iterations=None, q=None):
        seen.extend(o.device.type for out in outs for o in out)
        return assemble(test_points, counts, outs, pad, iterations, q=q)

    eng._assemble_packed = spy
    return seen


def padded_rows(eng, pts):
    """``(u, i, rel_x, rel_y, w)`` of the padded program for queries
    ``pts`` on the card: the related rows from the host index, in the
    program's order (user rows, then item rows), padded as it pads."""
    rel_idx, rel_mask, _ = eng.index.related_padded(pts, bucket=eng.pad_bucket)
    idx = torch.as_tensor(rel_idx, device=eng.device).long()
    tx = torch.as_tensor(np.asarray(pts, np.int64), device=eng.device)
    w = torch.as_tensor(rel_mask, device=eng.device).to(torch.float32)
    return tx[:, 0], tx[:, 1], eng.train_x[idx], eng.train_y[idx], w


def lissa_recursions(eng, pts, depth: int) -> tuple[np.ndarray, np.ndarray,
                                                    dict]:
    """The LiSSA gate's references for queries ``pts``: the padded
    program's truncated recursion run on the materialised analytic block
    Hessians (+ damping + shift), with the (scale, shift) that
    ``spectral.lissa_tuning`` gives on the port's traced HVP, once in
    float64 and once in float32 on the same matrices; and the scores of
    the per-example gradients against each iHVP. Returns the packed
    float64 and float32 scores and the tuning's range."""
    model, params = eng.model, eng.params
    u, i, rel_x, rel_y, w = padded_rows(eng, pts)
    d = model.block_size
    hvp = HV.make_batched_block_hvp(model, params, u, i, rel_x, rel_y, w,
                                    eng.damping, linearize=True)
    scale, shift = spectral.lissa_tuning(hvp, d, scale_floor=eng.lissa_scale,
                                         batch_shape=(len(pts),),
                                         device=eng.device)
    H = torch.func.vmap(lambda uu, ii, xx, yy, ww: model.block_hessian(
        params, uu, ii, xx, yy, ww))(u, i, rel_x, rel_y, w)
    H = H + (eng.damping + shift[:, None, None]) * torch.eye(
        d, device=eng.device)
    v = torch.func.vmap(lambda uu, ii, xj: G.block_prediction_grad(
        model, params, uu, ii, xj[None, :]))(
            u, i, torch.stack([u, i], dim=1).to(torch.int32))
    per_ex = torch.func.vmap(
        lambda uu, ii, xx, yy: G.per_example_block_loss_grads(
            model, params, uu, ii, xx, yy))(u, i, rel_x, rel_y)
    n = torch.clamp(w.sum(1), min=1.0)
    mask = w.bool()
    out = []
    for dt in (torch.float64, torch.float32):
        Hd, vd, s = H.to(dt), v.to(dt), scale.to(dt)[:, None]
        cur = vd
        for _ in range(depth):
            cur = vd + cur - torch.einsum("tij,tj->ti", Hd, cur) / s
        scores = torch.einsum("tpd,td->tp", per_ex.to(dt), cur / s) / n.to(
            dt)[:, None]
        out.append(scores[mask].double().cpu().numpy())  # query order
    return out[0], out[1], {"scale": [float(scale.min()), float(scale.max())],
                            "shift_max": float(shift.max())}


def hold_float32_slack(got, exact, plain32, counts, rtol: float,
                       atol: float, what: str, excuse=None) -> dict:
    """Scores ``got`` against their float64 computation ``exact``: each
    within ``rtol`` / ``atol``, plus a per-query slack of twice the plain
    float32 computation's own distance from float64 on that query
    (``plain32``: the same formula on the same operands in float32).
    ``excuse(rows)`` (NCF), on the packed numbers of the rows that either
    float32 version puts beyond the bar, says which lie on a relu
    boundary: those pass, are counted, and are left out of the slack.

    Used for LiSSA's scores against the float64 recursion (phase 6), and
    for the score kernels at RQ2's widths k >= 64 (7d), whose 64..256-term
    dots (MF) and 128..512-term dots (NCF) end many ulps apart in two
    float32 orders on scores that are small by cancellation (MF at
    k = 128: kernel and plain 1.48e-6 apart on a score whose bar was
    1.0e-6, H100 80GB HBM3 at 700 W), as phase 3 found for NCF.

    Why the slack, for LiSSA (float64 argument): thousands of float32
    steps (10,000 measured) round the running sum to ~1e-6 of the iHVP's
    norm, and that error reaches every
    score of the query through one dot product as an ABSOLUTE error, so
    a score that is small by cancellation misses a relative bar whatever
    float32 recursion computes it: the plain float32 recursion, which
    shares nothing with the port but the matrices, misses it on the same
    scores by the same amounts (measured on an H100 at ML-1M shape, 32
    queries: 1 (MF) and 6 (NCF) of 8,147 scores miss the elementwise
    bar, the same ones for both, and the port is 7.3e-7 / 1.8e-7 from
    the plain float32 recursion). The slack is that measured float32
    error, and it must itself stay within ``rtol`` of the query's
    largest score, so it cannot hide a wrong HVP, scale or shift.
    """
    off = np.concatenate([[0], np.cumsum(counts)])
    beyond = beyond32 = slack_max = excused = 0
    max_abs = 0.0  # over the rows not excused
    for t in range(len(counts)):
        a, b, c = (x[off[t]:off[t + 1]] for x in (got, exact, plain32))
        if not len(a):
            continue
        bar = atol + rtol * np.abs(b)
        keep = np.ones(len(a), bool)
        if excuse is not None:
            rows = np.flatnonzero((np.abs(a - b) > bar) | (np.abs(c - b) > bar))
            if len(rows):
                edge = excuse(off[t] + rows)
                keep[rows[edge]] = False
                excused += int(edge.sum())
        slack = 2.0 * float(np.max(np.abs(c - b)[keep], initial=0.0))
        check(slack <= rtol * float(np.max(np.abs(b))) + atol,
              f"{what}: the plain float32 version itself is {slack / 2:.3e} "
              f"from float64 on query {t}, beyond rtol {rtol} of its "
              "largest score")
        err = np.abs(a - b)
        out = int(np.sum((err > bar + slack) & keep))
        check(out == 0,
              f"{what}: query {t}: {out} scores beyond rtol {rtol} atol "
              f"{atol} plus the float32 slack {slack:.3e} of float64 (max "
              f"abs err {float(err[keep].max()):.3e})")
        max_abs = max(max_abs, float(np.max(err[keep], initial=0.0)))
        beyond += int(np.sum(err > bar))
        beyond32 += int(np.sum(np.abs(c - b) > bar))
        slack_max = max(slack_max, slack / max(float(np.max(np.abs(b))),
                                                1e-30))
    return {"scores": int(got.size), "max_abs_err": max_abs,
            "max_abs_err_float32_recursion": float(np.abs(plain32 - exact)
                                                   .max()),
            "max_abs_err_vs_float32_recursion": float(np.abs(got - plain32)
                                                      .max()),
            "beyond_elementwise_bar": beyond,
            "float32_recursion_beyond_elementwise_bar": beyond32,
            "max_slack_share_of_largest_score": slack_max,
            "boundary_rows": excused}


def query_walls(eng, pts, n: int) -> tuple[list, list]:
    """Host seconds of ``n`` back-to-back ``query_batch`` calls (each
    returns host arrays, so each ends synchronised) and their results."""
    walls, results = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        results.append(eng.query_batch(pts))
        walls.append(time.perf_counter() - t0)
    return walls, results


def rank_agreement(res, ref) -> dict:
    """Per-query Spearman of ``res`` against ``ref``: min and median."""
    rhos = [spearman(res.scores_of(t), ref.scores_of(t))
            for t in range(len(res.counts))
            if res.counts[t] > 1 and np.ptp(res.scores_of(t)) > 0
            and np.ptp(ref.scores_of(t)) > 0]
    return {"min_spearman": float(min(rhos)),
            "median_spearman": float(np.median(rhos))}


def same_bytes(a, b, what: str) -> None:
    """Counts, packed scores, iHVPs and test vectors the same bits."""
    check(np.array_equal(a.counts, b.counts)
          and a._packed.tobytes() == b._packed.tobytes()
          and a.ihvp.tobytes() == b.ihvp.tobytes()
          and a.test_grad.tobytes() == b.test_grad.tobytes(),
          f"{what}: the two results differ bit for bit")


def padded_small(family: str, model) -> dict:
    """Every padded configuration (``SMALL_CONFIGS``) on the card against
    the port's CPU path, on phase 4's small input."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x[:21]
    out = {}
    for name, kw in SMALL_CONFIGS.items():
        card = engine(tm, tp, tiny["train"], damping=SMALL_DAMPING,
                               **kw)
        devices = spy_devices(card)
        on_card = card.query_batch(tq)
        on_cpu = engine(tm, tp, tiny["train"], damping=SMALL_DAMPING,
                                 device="cpu", **kw).query_batch(tq)
        what = f"{family} {name} card vs CPU (small)"
        check(card.solver == kw.get("solver", "direct"),
              f"{what}: the ladder escalated to {card.solver!r}")
        check(devices and set(devices) == {"cuda"},
              f"{what}: results computed on {set(devices)}")
        if "group_queries" in kw:
            check(on_card._packed is None
                  and np.array_equal(on_card.related_idx, on_cpu.related_idx)
                  and np.array_equal(on_card.related_mask,
                                     on_cpu.related_mask),
                  f"{what}: the dense views differ")
        out[name] = compare_results(on_card, on_cpu, what, PADDED_RTOL,
                                    PADDED_ATOL, PADDED_RHO)
        log(f"{what}: {out[name]}")
    return out


def drive_padded(family: str, eng, train, pts) -> dict:
    """Phase 6: the padded per-query program, each solver against the
    flat direct path on the same card, with its times."""
    T = PADDED_T
    q = pts[:T]
    flat = eng.query_batch(q)
    ops = operands(eng, pts, T)
    excuse = relu_excuse(family, ops)
    d = eng.model.block_size
    out = {"T": T}
    for m in KERNEL_MODULES.values():
        m.launches = 0
    for solver in PADDED_SOLVERS:
        p_eng = padded_engine(eng, train, solver,
                              **({"lissa_depth": LISSA_DEPTH}
                                 if solver == "lissa" else {}))
        devices = spy_devices(p_eng)
        t0 = time.perf_counter()
        res = p_eng.query_batch(q)  # the warm-up
        first_s = time.perf_counter() - t0
        check(p_eng.solver == solver, f"{family} padded {solver}: the NaN "
              f"ladder escalated it to {p_eng.solver!r}")
        check(res.ihvp.shape == (T, d) and np.isfinite(res.ihvp).all(),
              f"{family} padded {solver}: iHVPs {res.ihvp.shape}, or "
              "non-finite")
        check(np.array_equal(res.counts, flat.counts)
              and all(np.array_equal(res.related_of(t), flat.related_of(t))
                      for t in range(T)),
              f"{family} padded {solver}: counts or related rows differ "
              "from the flat path's")
        row = {"first_call_ms": first_s * 1e3, "iterations": res.iterations}
        if solver == "lissa":
            lt = T if first_s <= LISSA_SLOW_S else min(T, LISSA_SMALL_T)
            walls, results = query_walls(p_eng, pts[:lt], 2 if lt < T else 1)
            if lt == T:
                results.append(res)
            same_bytes(*results, f"{family} padded lissa")
            row["T"] = lt
            row["vs_flat_direct"] = rank_agreement(res, flat)  # recorded
            exact, plain32, tuning = lissa_recursions(
                p_eng, pts[:LISSA_GATE_Q], p_eng.lissa_depth)
            got = np.concatenate([res.scores_of(t)
                                  for t in range(LISSA_GATE_Q)])
            row["vs_float64_recursion"] = {
                "queries": LISSA_GATE_Q, **tuning,
                **hold_float32_slack(got, exact, plain32,
                                     res.counts[:LISSA_GATE_Q], PADDED_RTOL,
                                     PADDED_ATOL, "LiSSA gate")}
            # the HVP's trace, then the recursion alone on it, per step
            u, i, rel_x, rel_y, w = padded_rows(p_eng, pts[:lt])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hvp = HV.make_batched_block_hvp(p_eng.model, p_eng.params, u, i,
                                            rel_x, rel_y, w, DAMPING,
                                            linearize=True)
            torch.cuda.synchronize()
            row["hvp_trace_ms"] = (time.perf_counter() - t0) * 1e3
            v = torch.as_tensor(results[-1].test_grad, device=p_eng.device)

            def steps():
                return solvers.solve_lissa(
                    hvp, v, scale=100.0, recursion_depth=LISSA_TIMED_STEPS,
                    auto_scale=False)

            steps_ms = time_ms(steps, iters=1, warmup=1)
            row["ms_per_step"] = steps_ms / LISSA_TIMED_STEPS
            row["recursion_device"] = device_breakdown(steps, steps_ms)
            prof = padded_engine(eng, train, solver,
                                 lissa_depth=LISSA_PROFILE_DEPTH)
            pw, _ = query_walls(prof, pts[:lt], 2)
            row["device"] = {"lissa_depth": LISSA_PROFILE_DEPTH,
                             **device_breakdown(lambda: prof.query_batch(
                                 pts[:lt]), pw[-1] * 1e3)}
        else:
            walls, results = query_walls(p_eng, q, 3)
            same_bytes(res, results[-1], f"{family} padded {solver}")
            row["T"] = T
            row["vs_flat_direct"] = compare_results(
                res, flat, f"{family} padded {solver} vs flat direct",
                PADDED_RTOL, PADDED_ATOL, PADDED_RHO, excuse)
            row["device"] = device_breakdown(lambda: p_eng.query_batch(q),
                                             float(np.median(walls)) * 1e3)
        check(devices and set(devices) == {"cuda"},
              f"{family} padded {solver}: results computed on {set(devices)}")
        wall = float(np.median(walls))
        row["query_batch_ms"] = wall * 1e3
        row["query_batch_ms_runs"] = [x * 1e3 for x in walls]
        row["scores_per_s"] = int(results[-1].counts.sum()) / wall
        out[solver] = row
        log(f"{family} padded {solver}: {json.dumps(row, sort_keys=True)}")
    out["small_card_vs_cpu"] = padded_small(family, eng.model)
    launches = {SOURCES[f]: m.launches for f, m in KERNEL_MODULES.items()}
    check(not any(launches.values()), f"{family} padded path launched a "
          f"score kernel: {launches}")
    out["score_kernel_launches"] = launches
    return out


# -- phase 7: training, checkpoints, RQ1 and RQ2 ---------------------------
def close(got, want, rtol: float, atol: float, what: str) -> float:
    """Tensors (or dicts of them) ``got`` against ``want`` elementwise at
    ``rtol``/``atol``; returns the largest absolute difference."""
    if isinstance(want, dict):
        check(sorted(got) == sorted(want), f"{what}: keys differ")
        return max(close(got[k], want[k], rtol, atol, f"{what} {k}")
                   for k in sorted(want))
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} != "
          f"{tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} values beyond rtol "
          f"{rtol} atol {atol} (max abs err {float(diff.max()):.3e})")
    return float(diff.max()) if diff.numel() else 0.0


def train_small(family: str, cls) -> dict:
    """Phase 7a: the small input's fit (all three phases), retrain and
    leave-one-out lanes on the card against the same calls on the CPU,
    with the same schedules; and lane chunking on the card."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)["train"]
    x, y = tiny.x, tiny.y
    model = cls(60, 40, 8, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    w = np.ones(len(x), np.float32)
    w[11] = 0.0
    lo = TRAIN_SMALL_LOO
    out = {}
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        tr = Trainer(model, TrainConfig(**TRAIN_SMALL_FIT), device=dev)
        s = tr.fit(tr.init_state(params), x, y)
        fit_losses = tr.last_losses
        r = tr.retrain(s, x, y, weights=w, num_steps=20,
                       reset_adam=family == "mf")
        lanes = loo_retrain_many(model, params, x, y, np.asarray(lo["removed"]),
                                 lo["steps"], 200, 1e-2,
                                 seeds=np.asarray(lo["seeds"]), device=dev)
        out[side] = {"fit losses": fit_losses, "fit params": s.params,
                    "fit adam mu": s.opt_state.mu,
                    "retrain losses": tr.last_losses,
                    "retrain params": r.params, "lanes": lanes}
    errs = {name: close(out["card"][name], out["cpu"][name], TRAIN_RTOL,
                        TRAIN_ATOL, f"{family} 7a {name} card vs CPU")
            for name in out["cpu"]}
    whole = out["card"]["lanes"]
    chunk_err = 0.0
    for c in (0, 2):
        part = loo_retrain_many(model, params, x, y,
                                np.asarray(lo["removed"][c:c + 2]), lo["steps"],
                                200, 1e-2, seeds=np.asarray(lo["seeds"][c:c + 2]),
                                device=CARD)
        chunk_err = max(chunk_err, close(
            part, {k: v[c:c + 2] for k, v in whole.items()}, TRAIN_RTOL,
            TRAIN_ATOL, f"{family} 7a lane_chunk 2 vs 4 on the card"))
    errs["lane_chunk 2 vs 4 (card)"] = chunk_err
    log(f"{family} 7a training card vs CPU, max abs err: {errs}")
    return errs


def full_loss(model, params, x, y) -> float:
    with torch.no_grad():
        return float(model.loss(params, x, y))


def train_full(family: str, model, train, pts) -> tuple[TrainState, dict]:
    """Phase 7b: training at ML-1M shape through the three phases, timed
    a phase at a time; the device-busy share of a 200-step window; a
    checkpoint round trip; and the flat query on the trained weights,
    kernel against plain score stage. Returns the trained state (phase
    11 starts from it) and the phase's report."""
    dev = torch.device(CARD)
    x = torch.as_tensor(train.x).to(dev)
    y = torch.as_tensor(train.y).to(dev)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    rep = {"batch": FULL_BATCH, "learning_rate": TRAIN_LR,
           "steps": dict(FULL_STEPS), "loss_full_before": full_loss(
               model, params, x, y)}
    phase_cfgs = {
        "minibatch": {},
        "batch": {"iter_to_switch_to_batch": 0},
        "sgd": {"iter_to_switch_to_batch": 0, "iter_to_switch_to_sgd": 0},
    }
    state, losses, steps_per_s = None, [], {}
    for phase, extra in phase_cfgs.items():
        tr = Trainer(model, TrainConfig(FULL_BATCH, FULL_STEPS[phase],
                                        TRAIN_LR, seed=0, **extra))
        if state is None:
            state = tr.init_state(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.fit(state, x, y)
        torch.cuda.synchronize()
        steps_per_s[phase] = FULL_STEPS[phase] / (time.perf_counter() - t0)
        losses.append(tr.last_losses.cpu())
    losses = torch.cat(losses)
    check(bool(torch.isfinite(losses).all()), f"{family} 7b: non-finite loss")
    rep["steps_per_s"] = steps_per_s
    rep["first_step_loss"] = float(losses[0])
    rep["last_step_loss"] = float(losses[-1])
    rep["loss_full_after"] = full_loss(model, state.params, x, y)
    check(rep["loss_full_after"] < rep["loss_full_before"],
          f"{family} 7b: the training loss did not fall "
          f"({rep['loss_full_before']} -> {rep['loss_full_after']})")
    # a 200-step minibatch window: host wall, then its device time
    tr = Trainer(model, TrainConfig(FULL_BATCH, BUSY_WINDOW, TRAIN_LR, seed=0))
    tr.fit(state, x, y)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(state, x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rep["window"] = {"steps": BUSY_WINDOW, "wall_ms": wall_ms,
                     "ms_per_step": wall_ms / BUSY_WINDOW,
                     **device_breakdown(lambda: tr.fit(state, x, y), wall_ms)}
    # the checkpoint round trip through the rotated directory
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_rotated(d, state.params, state.opt_state, state.step)
        restored = checkpoint.restore_latest_valid(d, state.params,
                                                   state.opt_state,
                                                   verbose=False)
    check(restored is not None, f"{family} 7b: no checkpoint restored")
    p, o, step = restored
    check(step == state.step and all(
        torch.equal(p[k], state.params[k]) for k in state.params) and all(
        torch.equal(a, b) for a, b in zip(checkpoint.leaves(o),
                                          checkpoint.leaves(state.opt_state))),
          f"{family} 7b: the restored checkpoint is not bitwise equal")
    rep["checkpoint"] = "bitwise equal"
    # the flat query on the trained weights: kernel against plain
    T = BATCHES[0]
    eng = engine(model, state.params, train, damping=DAMPING)
    plain = engine(model, state.params, train, damping=DAMPING,
                            kernel="torch", device=CARD)
    res, ref = eng.query_batch(pts[:T]), plain.query_batch(pts[:T])
    ops = operands(eng, pts, T)
    total = int(res.counts.sum())
    mod = KERNEL_MODULES[family]

    @functools.cache
    def exact():
        return mod.fused_scores_reference(
            *kernel_args(to64(ops)))[:total].cpu().numpy()

    rep["trained_parity"] = compare_results(
        res, ref, f"{family} 7b trained weights kernel vs plain", RTOL, ATOL,
        RHO_MIN, relu_excuse(family, ops), exact)
    log(f"{family} 7b: {json.dumps(rep, sort_keys=True)}")
    return state, rep


def drive_rq1(family: str, eng, train, pts) -> dict:
    """Phase 7c: ``test_retraining`` on held-out points with the trained
    weights; every lane finite and the score kernel launched for each
    point's query. The correlation is printed, not gated."""
    test = RatingDataset(pts[:RQ1_POINTS], np.zeros(RQ1_POINTS, np.float32))
    mod = KERNEL_MODULES[family]
    for m in (*KERNEL_MODULES.values(), kseg):
        m.launches = 0
    actual, predicted, points = [], [], []
    for i in range(RQ1_POINTS):
        before = mod.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = test_retraining(eng, train, test, i, num_to_remove=RQ1_REMOVE,
                              num_steps=RQ1_STEPS, batch_size=FULL_BATCH,
                              learning_rate=TRAIN_LR,
                              retrain_times=RQ1_TIMES,
                              lane_chunk=(RQ1_REMOVE + 1) * RQ1_TIMES,
                              verbose=False)
        secs = time.perf_counter() - t0
        lanes = res.per_repeat_y.size
        check(mod.launches - before >= 1, f"{family} 7c point {i}: the score "
              "kernel never launched")
        check(bool(np.isfinite(res.per_repeat_y).all()),
              f"{family} 7c point {i}: a retrained lane is not finite")
        actual.append(res.actual_y_diffs)
        predicted.append(res.predicted_y_diffs)
        points.append({"seconds": secs, "lanes": lanes,
                       "lane_steps_per_s": lanes * RQ1_STEPS / secs,
                       "bias_retrain": res.bias_retrain,
                       "pearson": metrics.pearson(res.actual_y_diffs,
                                                  res.predicted_y_diffs)})
    a, p = np.concatenate(actual), np.concatenate(predicted)
    rep = {"points": points, "steps": RQ1_STEPS, "removed": RQ1_REMOVE,
           "retrain_times": RQ1_TIMES, "pearson": metrics.pearson(a, p),
           "spearman": metrics.spearman(a, p),
           "score_kernel_launches": mod.launches,
           "segment_launches": kseg.launches,
           "graphs": graph_inventory(eng)}
    check(kseg.launches >= RQ1_POINTS, f"{family} 7c: the Hessian kernel "
          f"launched {kseg.launches} times for {RQ1_POINTS} points")
    log(f"{family} 7c RQ1: {json.dumps(rep, sort_keys=True)}")
    return rep


def dispatch_without_waits(eng) -> None:
    """Make ``eng._dispatch_flat`` fail on any host wait for the card
    (``torch.cuda.set_sync_debug_mode("error")``), so ``query_many``
    provably queues batch k + 1 before it fetches batch k."""
    dispatch = eng._dispatch_flat

    def checked(points, pad_to):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(points, pad_to)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng._dispatch_flat = checked


def same_bytes_stitched(parts, whole, what: str) -> None:
    """``query_many``'s batches ``parts`` against one result ``whole`` of
    the same queries: counts, related rows, and each query's scores, iHVP
    and test vector the same bits."""
    t = 0
    for part in parts:
        for j in range(len(part.counts)):
            check(part.counts[j] == whole.counts[t]
                  and np.array_equal(part.related_of(j), whole.related_of(t))
                  and part.scores_of(j).tobytes()
                  == whole.scores_of(t).tobytes()
                  and part.ihvp[j].tobytes() == whole.ihvp[t].tobytes()
                  and part.test_grad[j].tobytes()
                  == whole.test_grad[t].tobytes(),
                  f"{what}: query {t} differs from one dispatch")
            t += 1
    check(t == len(whole.counts), f"{what}: {t} queries, want "
          f"{len(whole.counts)}")


def stage_times(eng, pts, iters: int = 5) -> dict:
    """Device ms of each cumulative prefix of the flat program on
    ``pts`` (eager, CUDA events)."""
    _, tx, s_pad = eng._flat_inputs(pts)
    args = (eng.params, eng.train_x, eng.train_y, eng._postings, tx)
    out = {}
    for stage in STAGES:
        fn = eng._flat_fn(s_pad, stage)
        out[stage] = time_ms(lambda: fn(*args), iters=iters)
    return out


def graph_inventory(eng) -> dict:
    """The engine's captured flat programs: how many, and the memory each
    graph's pool holds."""
    pools = [p.pool_bytes for p in eng._programs.values()]
    return {"geometries": len(pools),
            "pool_mb": [round(b / 2 ** 20, 1) for b in pools],
            "capture_ms": [round(p.capture_s * 1e3, 1)
                           for p in eng._programs.values()]}


def drive_rq2(family: str, cls, train, pts) -> dict:
    """Phase 7d: RQ2's width sweep with seeded weights (a query's cost
    does not depend on training): ``time_influence_queries`` through
    ``query_batch`` and through ``query_many``. At each width the
    kernel's ``query_batch`` is held against the plain score stage's at
    the kernel's bar (at RQ2_FLOAT64_K, each of the two against float64
    with float32's own slack, :func:`hold_float32_slack`); each of
    ``query_many``'s batches must equal ``query_batch`` on the same
    queries bit for bit, its dispatches must not wait on the card, and
    the whole must equal one ``query_batch`` of all the queries bit for
    bit. Each width's flat stages are timed by cumulative prefix, and the
    geometries its engine captured are counted with their graphs'
    memory."""
    mod = KERNEL_MODULES[family]
    q = pts[:RQ2_Q]
    out = {}
    for k in RQ2_K:
        model = cls(USERS, ITEMS, k, WD)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=CARD)
        eng = engine(model, params, train, damping=DAMPING)
        plain = engine(model, params, train, damping=DAMPING,
                                kernel="torch", device=CARD)
        row = {}
        for name, bq in (("query_batch", None), ("query_many", RQ2_BATCH)):
            for m in (*KERNEL_MODULES.values(), kseg):
                m.launches = 0
            t = time_influence_queries(eng, q, repeats=3, batch_queries=bq)
            row[name] = {**t.json(), "times_s": t.times_s,
                         "compile_time_s": t.compile_time_s,
                         "score_kernel_launches": mod.launches,
                         "segment_launches": kseg.launches}
            check(mod.launches >= 1 and kseg.launches >= 1,
                  f"{family} 7d k={k} {name}: a kernel never launched "
                  f"(score {mod.launches}, Hessian {kseg.launches})")
        check(row["query_batch"]["num_scores"] == row["query_many"]["num_scores"],
              f"{family} 7d k={k}: query_many scored another row count")
        whole = eng.query_batch(q)
        ops = operands(eng, pts, RQ2_Q)
        total = int(whole.counts.sum())

        @functools.cache
        def exact(ops=ops, total=total):
            return mod.fused_scores_reference(
                *kernel_args(to64(ops)))[:total].cpu().numpy()

        excuse = relu_excuse(family, ops)
        ref = plain.query_batch(q)
        what = f"{family} 7d k={k} kernel vs plain"
        if k not in RQ2_FLOAT64_K:
            row["kernel_vs_plain"] = compare_results(
                whole, ref, what, RTOL, ATOL, RHO_MIN, excuse, exact)
        else:
            check(np.array_equal(whole.counts, ref.counts) and all(
                np.array_equal(whole.related_of(t), ref.related_of(t))
                for t in range(RQ2_Q)), f"{what}: rows differ")
            got = np.concatenate([whole.scores_of(t) for t in range(RQ2_Q)])
            plain32 = np.concatenate([ref.scores_of(t) for t in range(RQ2_Q)])
            row["kernel_vs_plain"] = {
                "vs_float64": True,
                "max_abs_err_vs_plain": float(np.abs(got - plain32).max()),
                **hold_float32_slack(got, exact(), plain32, whole.counts,
                                     RTOL, ATOL, what + " vs float64",
                                     excuse)}
        dispatch_without_waits(eng)
        parts = eng.query_many(q, batch_queries=RQ2_BATCH)
        for j, part in enumerate(parts):
            same_bytes(part, eng.query_batch(q[j * RQ2_BATCH:
                                               (j + 1) * RQ2_BATCH]),
                       f"{family} 7d k={k} query_many batch {j} vs "
                       "query_batch on the same queries")
        same_bytes_stitched(parts, whole, f"{family} 7d k={k} query_many "
                            f"({RQ2_BATCH} a batch) vs one query_batch")
        row["query_many_vs_query_batch"] = "bitwise equal"
        row["stage_ms_cumulative"] = stage_times(eng, q, iters=3)
        row["graphs"] = graph_inventory(eng)
        out[str(k)] = row
        log(f"{family} 7d RQ2 k={k}: per-query ms "
            f"{row['query_batch']['per_query_ms']:.4f} (query_batch) / "
            f"{row['query_many']['per_query_ms']:.4f} (query_many), "
            f"{row['query_batch']['scores_per_sec']:.0f} scores/s, launches "
            f"{row['query_batch']['score_kernel_launches']} / "
            f"{row['query_many']['score_kernel_launches']}, kernel vs plain "
            f"{row['kernel_vs_plain']}, query_many vs query_batch "
            f"{row['query_many_vs_query_batch']}, stages (ms, cumulative) "
            f"{row['stage_ms_cumulative']}, graphs {row['graphs']}")
        del eng, plain, params, model, ops, exact
        torch.cuda.empty_cache()
    return out


# -- the split-invariance probe ----------------------------------------
def flat_stage_outputs(eng, batch) -> dict:
    """Every stage's per-query output of one flat dispatch of ``batch``:
    ``{stage: [tensor of query j, ...]}`` for the query's g rows and e
    rows, H_t, v_t, ihvp_t, reg_dot_t and its scores (query-pad rows and
    flat pad rows dropped)."""
    counts, tx, s_pad = eng._flat_inputs(batch)
    T = len(counts)

    def run(stage):
        return eng._flat_fn(s_pad, stage)(eng.params, eng.train_x,
                                          eng.train_y, eng._postings, tx)

    g, e = run("grads")
    H = run("hessian")
    ihvp, v = run("solve")
    B = run("operands")[5]
    scores = run("scores")[0]
    d = eng.model.block_size
    off = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    rows = [slice(int(off[j]), int(off[j + 1])) for j in range(T)]
    return {
        "g": [g[r] for r in rows], "e": [e[r] for r in rows],
        "H": list(H[:T]), "v": list(v[:T]), "ihvp": list(ihvp[:T]),
        "reg_dot": list(B[:T, d]), "scores": [scores[r] for r in rows],
    }


PROBE_STAGES = ("g", "e", "H", "v", "ihvp", "reg_dot", "scores")


def probe_layouts(n: int, wide: bool):
    """``(name, [batch index arrays])`` of the probe: each batch a list of
    positions into the probe's point list, whose first ``n`` points are
    the queries compared. ``wide`` (RQ2's 64 queries): two halves, the
    reverse order, and the queries inside a 72-query batch (t_pad 128);
    else (256 queries): inside 1024 (t_pad 1024), behind 44 others
    (rows shifted, t_pad 320), batches of 100 (t_pad 128, 128, 64) and
    the reverse order."""
    q = np.arange(n)
    if wide:
        return [("halves", [q[: n // 2], q[n // 2:]]),
                ("reversed", [q[::-1]]),
                ("inside 72", [np.arange(72)])]
    return [("inside 1024", [np.arange(1024)]),
            ("shifted 44", [np.concatenate([np.arange(n, n + 44), q])]),
            ("batches of 100", [q[i: i + 100] for i in range(0, n, 100)]),
            ("reversed", [q[::-1]])]


def solve_isolated(H, v, n: int, batches) -> dict:
    """The batched LU alone: the first ``n`` systems of (H, v) solved at
    their own batch size and again inside batches of each size in
    ``batches`` (rolled to other positions, padded by repeating the last
    system); per batch size the count of systems whose solution differs
    by a bit, for the library's solve over the whole batch (``library``,
    recorded: it changes with the batch size on the card) and for the
    engine's, in pieces of ``QUERY_PIECE`` systems (``engine``)."""
    out = {}
    for name, solve in (("library", solvers.solve_direct),
                        ("engine", lambda Hb, vb: _in_pieces(
                            solvers.solve_direct, Hb, vb))):
        ref = solve(H[:n], v[:n])
        out[name] = {}
        for b in batches:
            m = min(n, b)
            sel = np.concatenate([np.arange(m), np.full(b - m, m - 1)])
            shift = b // 3
            x = torch.roll(solve(torch.roll(H[sel], shift, 0),
                                 torch.roll(v[sel], shift, 0)), -shift, 0)[:m]
            out[name][str(b)] = int(sum(not torch.equal(x[j], ref[j])
                                        for j in range(m)))
    return out


def probe_split(eng, pts, n: int, wide: bool, solve_batches) -> dict:
    """Module 1's probe on one engine: the first ``n`` of ``pts`` through
    one flat dispatch, then through each of :func:`probe_layouts`; per
    layout the count of queries whose output differs by a bit at each
    stage, and the first stage that differs; and the batched LU alone
    (:func:`solve_isolated`)."""
    ref = flat_stage_outputs(eng, pts[:n])
    out = {}
    for name, batches in probe_layouts(n, wide):
        got = {s: [None] * n for s in PROBE_STAGES}
        for idx in batches:
            outs = flat_stage_outputs(eng, pts[idx])
            for j, q in enumerate(idx):
                if q < n:
                    for s in PROBE_STAGES:
                        got[s][q] = outs[s][j]
            del outs
        diff = {s: int(sum(not torch.equal(got[s][q], ref[s][q])
                           for q in range(n))) for s in PROBE_STAGES}
        first = next((s for s in PROBE_STAGES if diff[s]), None)
        out[name] = {"first_differing_stage": first, "queries_differing": diff}
        del got
    H = torch.stack(ref["H"])
    v = torch.stack(ref["v"])
    out["solve_isolated"] = solve_isolated(H, v, n, solve_batches)
    return out


def probe(train, pts) -> dict:
    """The split-invariance probe for MF and NCF: at k = 16 on 256
    queries, and at RQ2's other widths on 64."""
    out = {}
    for family, cls in (("mf", MF), ("ncf", NCF)):
        for k in (K_EMB, *(k for k in RQ2_K if k != K_EMB)):
            wide = k != K_EMB
            model = cls(USERS, ITEMS, k, WD)
            params = model.init_params(torch.Generator().manual_seed(0),
                                       device=CARD)
            eng = engine(model, params, train, damping=DAMPING)
            row = probe_split(eng, pts, RQ2_Q if wide else BATCHES[0], wide,
                              (64, 128, 256) if wide else (64, 256, 1024))
            out[f"{family} k={k}"] = row
            log(f"probe {family} k={k}: {json.dumps(row, sort_keys=True)}")
            del eng, params, model
            torch.cuda.empty_cache()
    return out


# -- phase 8: the rest of the solver ladder ----------------------------------
def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, NaNs included."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def ladder_engine(eng, train, **kw) -> InfluenceEngine:
    """An engine on ``eng``'s model and weights at another rung."""
    kw.setdefault("damping", DAMPING)
    return engine(eng.model, eng.params, train, **kw)


def certificate_operands(samp, pts, T):
    """The certificate kernel's operands ``(g, t, ihvp, Cx, wv, ws, abe,
    e, off, m)`` of a T-query sampled dispatch, from the sampled
    program's "certificate" prefix."""
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
    return samp._flat_fn(s_pad, "certificate", mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)


def synthetic_certificate(counts, ms, S: int, d: int, gen: torch.Generator):
    """Certificate operands for segments of ``counts`` rows on an S-row
    axis (offsets clamped to S: a last segment past S is truncated; rows
    past the total are pad rows of no segment), ``ms[k]`` rows of segment
    k sampled at weight n/m, random rows and query vectors."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    T = counts.numel()
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).clamp(
        max=S)
    s = torch.arange(S)
    t = torch.searchsorted(off[1:T].contiguous(), s, right=True).to(
        torch.int32)
    wv = (s < off[-1]).to(torch.float32)
    ws = torch.zeros(S)
    for k, (n, m) in enumerate(zip(counts.tolist(), ms)):
        rows = int(off[k]) + torch.randperm(n, generator=gen)[:m]
        rows = rows[rows < S]
        ws[rows] = float(np.float32(n) / np.float32(max(m, 1)))
    g = torch.randn(S, d, generator=gen) * 0.3
    ihvp = torch.randn(T, d, generator=gen)
    cx = torch.randn(T, d, generator=gen) * 0.1
    e = torch.randn(S, generator=gen)
    abe = e * (torch.rand(S, generator=gen) < 0.05) * wv
    m = torch.as_tensor(ms, dtype=torch.int32)
    return tuple(x.to(CARD) for x in (g, t, ihvp, cx, wv, ws, abe, e, off,
                                      m))


def certificate_hold(got, ops, what: str) -> float:
    """The kernel's ``(sigma, gmax, wmax)`` against the plain version on
    the same operands: NaN where it is NaN, the same infinity where it is
    infinite, else within CERT_RTOL of it plus CERT_ATOL_REL of the
    output's largest finite entry. Returns the worst
    error as a share of that entry, and the worst absolute error."""
    want = kcert.segment_certificate_reference(*ops)
    worst, worst_abs = 0.0, 0.0
    for a, b, name in zip(got, want, ("sigma", "gmax", "wmax")):
        nan = torch.isnan(b)
        check(torch.equal(torch.isnan(a), nan),
              f"{what} {name}: NaN where the plain version is not, or not "
              "where it is")
        a, b = a[~nan].double(), b[~nan].double()
        inf = torch.isinf(b)
        check(torch.equal(a[inf], b[inf]), f"{what} {name}: an infinite "
              "entry differs from the plain version's")
        a, b = a[~inf], b[~inf]
        if not a.numel():
            continue
        scale = float(b.abs().max())
        diff = (a - b).abs()
        check(bool((diff <= CERT_RTOL * b.abs() + CERT_ATOL_REL * scale
                    ).all()),
              f"{what} {name}: beyond rtol {CERT_RTOL} / atol "
              f"{CERT_ATOL_REL} x max of the plain version (max abs err "
              f"{float(diff.max()):.3e})")
        worst = max(worst, float(diff.max()) / max(scale, 1e-30))
        worst_abs = max(worst_abs, float(diff.max()))
    return worst, worst_abs


def cert_launch_twice(ops):
    got = kcert.segment_certificate(*ops)
    again = kcert.segment_certificate(*ops)
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, again)),
          "segment_certificate: two launches on the same inputs differ")
    return got


def certificate_bound_ms(ops) -> tuple[float, str]:
    """Least time an H100 could take for the certificate of ``ops``: every
    input the function needs read once (g and the four row vectors the
    kernel reads, over the rows inside segments only: pad rows past
    off[-1] belong to no query; ihvp and Cx, off, m), three (T,) outputs
    written; per row in a segment ~10 d operations (two dots and h, its
    masked sum), per sampled row ~8 d more (a dot, h and the squared
    deviation)."""
    g, t, ihvp, cx, wv, ws, abe, e, off, m = ops
    d = g.shape[1]
    T = off.numel() - 1
    lo, hi = int(off[0]), int(off[-1])
    rows = hi - lo
    sampled = int((ws[lo:hi] > 0).sum())
    nb = nbytes(*(x[lo:hi] for x in (g, wv, ws, abe, e)), ihvp, cx, off,
                m) + 3 * T * 4
    return bound(nb, rows * d * 10 + sampled * d * 8)


def check_certificate(family: str, samp, pts, gen) -> dict:
    """8a: the certificate kernel against its plain version on the card,
    on the sampled program's operands at every batch size and on
    synthetic segments (empty; m = 0; m = 1; m = n; m = cap < n; the
    longest related set; a segment truncated at the flat pad; pad rows
    past the last segment; a non-finite row that is not sampled)."""
    d = samp.model.block_size
    longest = samp.index.max_related_count()
    cap = samp.sampled_cap
    cases = [(f"main path T={T}", certificate_operands(samp, pts, T))
             for T in BATCHES]
    counts = [0, 37, 37, 50, 300, longest, 500]
    ms = [0, 0, 1, 50, cap, cap, cap]
    cases.append(("edges", synthetic_certificate(
        counts, ms, sum(counts) - 200, d, gen)))
    cases.append(("pad tail", synthetic_certificate(
        [3, 0, cap, cap + 1], [3, 0, cap, cap], 2 * cap + 104, d, gen)))
    nonfinite = synthetic_certificate([40, 40], [8, 8], 80, d, gen)
    unsampled = int(torch.nonzero(nonfinite[5][:40] == 0)[0])
    nonfinite[0][unsampled] = float("inf")
    cases.append(("inf on an unsampled row", nonfinite))
    worst, worst_abs = 0.0, 0.0
    for name, ops in cases:
        got = cert_launch_twice(ops)
        w, a = certificate_hold(got, ops,
                                f"segment_certificate {family} {name}")
        worst, worst_abs = max(worst, w), max(worst_abs, a)
        log(f"segment_certificate {family} [{name}] S={ops[0].shape[0]} "
            f"d={d} T={ops[8].numel() - 1}: two launches the same bits; vs "
            f"plain max err {w:.3e} of max |out|")
    sigma = kcert.segment_certificate(*nonfinite)[0]
    check(bool(torch.isnan(sigma[0])) and bool(torch.isfinite(sigma[1])),
          "segment_certificate: an inf on an unsampled row did not make "
          "its segment's sigma, and only its, NaN")
    ops = cases[len(BATCHES) - 1][1]
    ms_kernel = graph_ms(lambda: kcert.segment_certificate(*ops), iters=20)
    ms_plain = time_ms(lambda: kcert.segment_certificate_reference(*ops),
                       iters=3, warmup=1)
    b_ms, b_by = certificate_bound_ms(ops)
    out = {"max_err_of_max_abs": worst, "max_abs_err": worst_abs,
           "cases": len(cases),
           "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms_kernel,
           "shape": {"S": ops[0].shape[0], "d": d,
                     "T": ops[8].numel() - 1,
                     "sampled_rows": int((ops[5] > 0).sum())}}
    log(f"segment_certificate {family} T={BATCHES[-1]}: {ms_kernel:.4f} ms "
        f"(graph replay), plain {ms_plain:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {100 * b_ms / ms_kernel:.1f}% of bound")
    return out


def lower_float64(H: torch.Tensor) -> np.ndarray:
    """H's lower triangles mirrored, in float64 on the host (what
    eigvalsh reads)."""
    L = np.tril(H.double().cpu().numpy())
    return L + np.swapaxes(np.tril(L, -1), 1, 2)


def eigmin_hold(H: torch.Tensor, what: str, alone=None,
                gate: bool = True) -> dict:
    """8g on one batch of blocks: the kernel's λ_min bit for bit its
    plain version on the card (the same operations in the same order),
    and (where ``gate``) within EIG_C · d · eps · ‖H‖_F of float64
    eigvalsh; two launches the same bits; the blocks ``alone`` (default
    the first and last) the same bits in a batch of 1. Returns the
    largest c seen against float64, the ranges of λ_min and of the bar,
    and the first launch's ms (events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = keig.block_eigmin(H)
    end.record()
    again = keig.block_eigmin(H)
    torch.cuda.synchronize()
    check(bits_equal(got, again), f"{what}: two launches differ")
    T, d = H.shape[0], H.shape[-1]
    for j in sorted({0, T - 1} if alone is None else set(alone)):
        one = keig.block_eigmin(H[j: j + 1].contiguous())
        check(bits_equal(one, got[j: j + 1]), f"{what}: block {j} alone "
              f"differs from block {j} in the batch of {T}")
    plain = keig.block_eigmin_reference(H)
    check(bits_equal(got, plain), f"{what}: not bit for bit the plain "
          "version")
    exact = np.linalg.eigvalsh(lower_float64(H))[:, 0]
    g = got.double().cpu().numpy()
    diff = np.abs(g - plain.double().cpu().numpy())
    unit = eigmin_unit(H)
    c_exact = float(np.max(np.abs(g - exact) / unit, initial=0.0))
    if gate:
        check(c_exact <= EIG_C, f"{what}: beyond {EIG_C} d eps ||H||_F of "
              f"float64 eigvalsh (c = {c_exact:.3e})")
    return {"T": T, "d": d, "c_float64": c_exact, "gated": gate,
            "first_launch_ms": start.elapsed_time(end),
            "max_abs_err": float(np.max(diff, initial=0.0,
                                        where=~np.isnan(diff))),
            "lambda_min_range": [float(np.min(g)), float(np.max(g))],
            "bar_range": [float(EIG_C * unit.min()),
                          float(EIG_C * unit.max())]}


def eigmin_unit(H: torch.Tensor) -> np.ndarray:
    """(T,) d · eps · ‖H‖_F of each block, float64 on the host (the
    float64 bar's unit)."""
    T, d = H.shape[0], H.shape[-1]
    return d * EPS32 * np.linalg.norm(
        H.double().reshape(T, -1).cpu().numpy(), axis=1)


def eigmin_line(r: dict) -> str:
    """One case of :func:`eigmin_hold` for the log."""
    bar = f"bar c = {EIG_C}" if r["gated"] else f"below {EIG_REACH}: no bar"
    return (f"bit for bit the plain version; c = {r['c_float64']:.3e} "
            f"against float64 ({bar}); λ_min in "
            f"[{r['lambda_min_range'][0]:.3e}, {r['lambda_min_range'][1]:.3e}]"
            f", bar in [{r['bar_range'][0]:.3e}, {r['bar_range'][1]:.3e}]")


def sampled_hessians(samp, pts, T: int) -> torch.Tensor:
    """The damped H (T, d, d) of a T-query sampled dispatch, from the
    sampled program's "hessian" prefix."""
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
    return samp._flat_fn(s_pad, "hessian", mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)


def eigmin_bound_ms(H: torch.Tensor) -> tuple[float, str]:
    """Least time an H100 could take for λ_min of ``H``: the lower
    triangles read once (all the function reads) and T floats written,
    against one tridiagonalisation's 4 d³ / 3 flops a block."""
    T, d = H.shape[0], H.shape[-1]
    return bound(4 * T * d * (d + 1) // 2 + 4 * T, T * 4.0 * d ** 3 / 3.0)


def check_eigmin(family: str, samp, pts) -> dict:
    """8g on the main path: ``block_eigmin`` on the sampled program's H
    at every batch size (:func:`eigmin_hold`; at the largest, blocks 0,
    1, T/2 and T - 1 alone), then its ms by graph replay at each, and at
    the largest beside its bound, the plain version and the library call
    it replaced (``eigvalsh`` in pieces of 64, events)."""
    out = {"cases": {}, "ms": {}}
    for T in BATCHES:
        H = sampled_hessians(samp, pts, T)
        r = eigmin_hold(H, f"block_eigmin {family} main path T={T}",
                        alone=(0, 1, T // 2, T - 1))
        out["cases"][str(T)] = r
        out["ms"][str(T)] = graph_ms(lambda: keig.block_eigmin(H), iters=20)
        log(f"block_eigmin {family} [main path T={T}] d={r['d']}: two "
            f"launches the same bits, a block alone its bits in the batch; "
            f"{eigmin_line(r)}; {out['ms'][str(T)]:.4f} ms (graph replay)")
    ms = out["ms"][str(T)]
    b_ms, b_by = eigmin_bound_ms(H)
    out.update({
        "plain_ms": time_ms(lambda: keig.block_eigmin_reference(H), iters=1,
                            warmup=1),
        "library_ms": time_ms(lambda: _in_pieces(
            lambda h: torch.linalg.eigvalsh(h)[:, 0], H), iters=1, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
        "rounds": keig.ROUNDS, "points": keig.STURM_POINTS,
        "cluster_ctas": keig.cluster_size(H.shape[-1]),
        "scratch_mb": eigmin_scratch_mb(H, T),
        "max_abs_err": max(r["max_abs_err"] for r in out["cases"].values()),
        "c_max": max(r["c_float64"] for r in out["cases"].values()),
        "shape": {"T": T, "d": H.shape[-1]}})
    log(f"block_eigmin {family} T={T}: {ms:.4f} ms (graph replay), plain "
        f"{out['plain_ms']:.2f} ms, eigvalsh in pieces of 64 "
        f"{out['library_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / ms:.2f}% of bound; device-memory scratch "
        f"{out['scratch_mb']} MiB")
    return out


def eigmin_scratch_mb(H: torch.Tensor, T: int) -> float:
    """MiB of device memory one ``block_eigmin`` call on T blocks (``H``
    repeated) takes beyond its (T,) output: the peak allocated during the
    call, less what was allocated before it and the output's bytes
    (``torch.cuda.max_memory_allocated``). Checked 0: the kernel holds a
    block in shared memory and allocates nothing."""
    big = H.repeat(-(-T // H.shape[0]), 1, 1)[:T].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lam = keig.block_eigmin(big)
    torch.cuda.synchronize()
    taken = (torch.cuda.max_memory_allocated() - before
             - lam.untyped_storage().nbytes())
    del big, lam
    mb = taken / 2 ** 20
    check(taken == 0, f"block_eigmin d={H.shape[-1]}: {mb:.3f} MiB of "
          f"device memory beyond its output at T={T}")
    return mb


def synthetic_blocks(kind: str, d: int, T: int, gen: torch.Generator
                     ) -> torch.Tensor:
    """(T, d, d) float32 blocks on the card: ``diagonal``; ``repeated``
    (eigenvalues 1, 2, 5, each d/3 times); ``indefinite`` ((W + Wᵀ)/2);
    ``floor`` (λ_min at DAMPING, the rest in [0.5, 2]); ``random`` (a
    Gauss-Newton sum of 64 rows plus DAMPING, as the sampled H)."""
    if kind == "diagonal":
        return torch.diag_embed(torch.randn(T, d, generator=gen)).to(CARD)
    if kind == "indefinite":
        W = torch.randn(T, d, d, generator=gen)
        return ((W + W.transpose(1, 2)) / 2).to(CARD)
    if kind == "random":
        G = torch.randn(T, 64, d, generator=gen, dtype=torch.float64) * 0.3
        H = G.transpose(1, 2) @ G * (2 / 64) + DAMPING * torch.eye(
            d, dtype=torch.float64)
        return H.float().to(CARD)
    Q = torch.linalg.qr(torch.randn(T, d, d, generator=gen,
                                    dtype=torch.float64))[0]
    if kind == "repeated":
        lam = torch.tensor([1.0, 2.0, 5.0],
                           dtype=torch.float64).repeat_interleave(
            -(-d // 3))[:d]
    else:  # floor
        lam = torch.cat([torch.tensor([DAMPING], dtype=torch.float64),
                         0.5 + 1.5 * torch.rand(d - 1, generator=gen,
                                                dtype=torch.float64)])
    return ((Q * lam) @ Q.transpose(1, 2)).float().to(CARD)


def check_eigmin_synthetic() -> dict:
    """8g on synthetic blocks (:func:`synthetic_blocks`), each kind at a
    main-path width, random blocks at d = 18 and 130 (one CTA a block),
    and EIG_WIDE_T random and diagonal blocks at each of EIG_WIDE_D (a
    thread-block cluster a block), and the damping-floor and indefinite
    kinds at d = 512: at each wide width the kernel's ms (events) below
    ``eigvalsh`` in pieces of 64 on the same blocks, its rounds, cluster
    size and resident clusters, and the device-memory scratch a call on
    BATCHES[-1] blocks takes (:func:`eigmin_scratch_mb`)."""
    gen = torch.Generator().manual_seed(9)
    cases = [("diagonal", 34, EIG_T), ("repeated", 64, EIG_T),
             ("indefinite", 64, EIG_T), ("floor", 34, EIG_T),
             ("random", 18, EIG_T), ("random", 130, EIG_T)]
    for d in EIG_WIDE_D:
        cases += [("random", d, EIG_WIDE_T), ("diagonal", d, EIG_WIDE_T)]
    cases += [("floor", 512, EIG_WIDE_T), ("indefinite", 512, EIG_WIDE_T)]
    out = {}
    for kind, d, T in cases:
        H = synthetic_blocks(kind, d, T, gen)
        name = f"{kind} d={d}"
        r = out[name] = eigmin_hold(H, f"block_eigmin [{name}]",
                                    alone=(0,) if d in EIG_WIDE_D else None)
        if kind == "diagonal":
            check(bits_equal(keig.block_eigmin(H),
                             torch.diagonal(H, dim1=1, dim2=2).amin(1)),
                  f"block_eigmin [{name}]: a diagonal block's λ_min is not "
                  "its smallest diagonal entry")
        if kind == "indefinite":
            check(bool((keig.block_eigmin(H) < 0).all()),
                  "block_eigmin: an indefinite block's λ_min is not < 0")
        wide = ""
        if d in EIG_WIDE_D and kind == "random":
            r.update({
                "ms": time_ms(lambda: keig.block_eigmin(H), iters=3,
                              warmup=1),
                "library_ms": time_ms(lambda: _in_pieces(
                    lambda h: torch.linalg.eigvalsh(h)[:, 0], H), iters=1,
                    warmup=1),
                "rounds": keig.ROUNDS, "points": keig.STURM_POINTS,
                "cluster_ctas": keig.cluster_size(d),
                "resident_clusters": keig.resident_clusters(d),
                "scratch_mb_at_T": {
                    str(BATCHES[-1]): eigmin_scratch_mb(H, BATCHES[-1])}})
            check(r["ms"] < r["library_ms"], f"block_eigmin [{name}]: "
                  f"{r['ms']:.2f} ms, not below eigvalsh in pieces of 64 "
                  f"({r['library_ms']:.2f} ms) on the same blocks")
            wide = (f"; {r['ms']:.3f} ms, eigvalsh in pieces of 64 "
                    f"{r['library_ms']:.1f} ms ({r['library_ms'] / r['ms']:.1f}"
                    f"x the kernel); {r['rounds']} rounds of "
                    f"{r['points']} points; {r['cluster_ctas']} CTA(s) a "
                    f"block, {r['resident_clusters']} clusters resident "
                    "(-1: no cluster); device-memory scratch "
                    f"{r['scratch_mb_at_T'][str(BATCHES[-1])]} MiB at "
                    f"T={BATCHES[-1]}")
        log(f"block_eigmin [{name}] T={T}: two launches the same bits, a "
            f"block alone its bits in the batch; {eigmin_line(r)}{wide}")
    return out


def check_eigmin_small() -> dict:
    """8g below the main path's widths: EIG_SMALL_T random and indefinite
    blocks at each of EIG_SMALL_D, held as :func:`eigmin_hold` holds a
    case, to the float64 bar from EIG_REACH up; c printed beside float32
    ``eigvalsh``'s on the same blocks, and the least width of the sweep
    from which every case met the bar."""
    gen = torch.Generator().manual_seed(10)
    out = {}
    for d in EIG_SMALL_D:
        for kind in ("random", "indefinite"):
            H = synthetic_blocks(kind, d, EIG_SMALL_T, gen)
            name = f"{kind} d={d}"
            r = out[name] = eigmin_hold(H, f"block_eigmin [{name}]",
                                        gate=d >= EIG_REACH)
            lib = torch.linalg.eigvalsh(H)[:, 0].double().cpu().numpy()
            exact = np.linalg.eigvalsh(lower_float64(H))[:, 0]
            r["c_eigvalsh_float32"] = float(np.max(
                np.abs(lib - exact) / eigmin_unit(H)))
            log(f"block_eigmin [{name}] T={EIG_SMALL_T}: two launches the "
                f"same bits, a block alone its bits in the batch; "
                f"{eigmin_line(r)}; float32 eigvalsh c = "
                f"{r['c_eigvalsh_float32']:.3e}")
    met = [all(out[f"{k} d={e}"]["c_float64"] <= EIG_C
               for k in ("random", "indefinite") for e in EIG_SMALL_D
               if e >= d) for d in EIG_SMALL_D]
    reach = next((d for d, m in zip(EIG_SMALL_D, met) if m), None)
    log(f"block_eigmin: the float64 bar c = {EIG_C} met at every width of "
        f"the sweep from d = {reach} up (gated from {EIG_REACH})")
    return {"cases": out, "bar_met_from_d": reach}


def drive_sampled_wide(train, pts) -> dict:
    """8h: the sampled rung (cap SAMPLED_CAP) at RQ2's upper widths
    (WIDE_RUNG) on WIDE_RUNG_T queries at ML-1M shape, seeded weights,
    beside direct on the same queries: wall ms (median of 5), busy share,
    ``block_eigmin``'s launches and share of the device time, each
    captured geometry's graph pool; every bound finite and >= 0; the
    rung's H on those queries held as 8g's (:func:`eigmin_hold`)."""
    out = {}
    q = pts[:WIDE_RUNG_T]
    for family, k in WIDE_RUNG:
        cls = {"mf": MF, "ncf": NCF}[family]
        model = cls(USERS, ITEMS, k, WD)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=CARD)
        direct = engine(model, params, train, damping=DAMPING)
        samp = engine(model, params, train, damping=DAMPING,
                               solver="sampled", sampled_cap=SAMPLED_CAP)
        reset_counts()
        res = samp.query_batch(q)
        launched = keig.launches
        check(launched > 0, f"{family} 8h k={k}: block_eigmin never launched")
        check(bool(np.isfinite(res.err_bound).all())
              and bool((res.err_bound >= 0).all()),
              f"{family} 8h k={k}: bounds {res.err_bound[:4]}...")
        H = sampled_hessians(samp, q, WIDE_RUNG_T)
        held = eigmin_hold(H, f"block_eigmin {family} 8h k={k} "
                           f"T={WIDE_RUNG_T}", alone=(0, WIDE_RUNG_T - 1))
        log(f"block_eigmin {family} [8h k={k}] d={held['d']} "
            f"T={WIDE_RUNG_T}: two launches the same bits, a block alone "
            f"its bits in the batch; {eigmin_line(held)}")
        del H
        ms = wall_ms(lambda: samp.query_batch(q))
        ms_direct = wall_ms(lambda: direct.query_batch(q))
        dev = device_breakdown(lambda: samp.query_batch(q), ms,
                               match="eigmin_")
        row = out[f"{family} k={k}"] = {
            "d": model.block_size, "T": WIDE_RUNG_T, "ms": ms,
            "direct_ms": ms_direct, "busy_share": dev["busy_share"],
            "device_busy_ms": dev["device_busy_ms"],
            "eigmin_device_ms": dev["matched_ms"],
            "eigmin_share_of_device": dev["matched_ms"]
            / dev["device_busy_ms"],
            "eigmin_launches": launched, "eigmin_hold": held,
            "top_kernels": dev["top_kernels"],
            "graphs": graph_inventory(samp)}
        log(f"{family} 8h sampled rung k={k} (d={row['d']}), T={WIDE_RUNG_T}:"
            f" {ms:.2f} ms, direct {ms_direct:.2f} ms; busy share "
            f"{row['busy_share']:.2f}; block_eigmin {row['eigmin_device_ms']:.3f}"
            f" ms, {100 * row['eigmin_share_of_device']:.1f}% of the device "
            f"time; graphs {row['graphs']}")
        del direct, samp, params, model, res
        torch.cuda.empty_cache()
    return out


def check_segment_ht(family: str, samp, pts, gen) -> dict:
    """8b: ``segment_hessian`` on the sampled program's operands (weights
    wv·n/m) at every batch size, and on synthetic segments with weights
    n/m for m < n and for m = 1: bit for bit the plain pieced form and
    within the float64 bar (:func:`segment_hold`)."""
    d = samp.model.block_size
    cases = []
    for T in BATCHES:
        _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
        cases.append((f"main path T={T}", samp._flat_fn(
            s_pad, "segments", mode="sampled")(
            samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws,
            m)))
    P = kseg.piece_rows(d)
    for cap in (13, 1):
        counts = [0, 1, 37, P - 1, P + 1, 3 * P + 5, 500]
        g, t, wv, abe, off = synthetic_segments(counts, sum(counts) + 50, d,
                                                gen)
        ws = np.zeros(g.shape[0], np.float32)
        for k, n in enumerate(counts):
            mk = min(n, cap)
            rows = int(off[k]) + torch.randperm(n, generator=gen)[:mk]
            ws[rows.numpy()] = np.float32(n) / np.float32(max(mk, 1))
        cases.append((f"HT weights cap={cap}",
                      (g, t, wv * torch.as_tensor(ws).to(CARD), abe, off)))
    worst = 0.0
    for name, ops in cases:
        got = segment_launch_twice(ops)
        r = segment_hold(got, ops, f"segment_hessian {family} {name}")
        worst = max(worst, r["max_err_of_max_abs_H"])
        log(f"segment_hessian {family} [{name}] S={ops[0].shape[0]}: bit for "
            f"bit the pieced plain form under n/m weights; vs float64 {r}")
    return {"cases": len(cases), "max_err_of_max_abs_H": worst}


def reset_counts() -> None:
    for m in (*KERNEL_MODULES.values(), kseg, kcert, keig):
        m.launches = 0


def launch_counts() -> dict:
    return {name: m.launches for name, m in
            (*((SOURCES[f], m) for f, m in KERNEL_MODULES.items()),
             (SEGMENT_SOURCE, kseg), (CERT_SOURCE, kcert),
             (EIGMIN_SOURCE, keig))}


def host_waits(fn) -> int:
    """Host waits for the card during ``fn()``
    (``torch.cuda.set_sync_debug_mode("warn")``), the final fetch
    included: the warnings of synchronizing operations, not the one the
    mode itself gives on its first use."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()`` ended by a synchronise, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sampled_small(family: str, model) -> dict:
    """The sampled rung at cap SAMPLED_CAP on phase 4's small input (about
    half its queries have more related rows than the cap, so their
    Hessians are HT-weighted samples): the card against the port's CPU
    path on the same samples, scores at phase 4's card-vs-CPU bar and
    bounds within SAMPLED_BOUND_RTOL."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq = tiny["test"].x.astype(np.int64)
    kw = dict(damping=1e-3, solver="sampled", sampled_cap=SAMPLED_CAP)
    on_card = engine(tm, tp, tiny["train"], **kw).query_batch(tq)
    on_cpu = engine(tm, tp, tiny["train"], device="cpu", **kw
                             ).query_batch(tq)
    sampled = int((on_cpu.counts > SAMPLED_CAP).sum())
    check(sampled > 0 and bool((on_cpu.err_bound > 0).any()),
          f"{family} sampled, small input: no query was sampled")
    parity = compare_results(on_card, on_cpu, f"{family} sampled card vs "
                             "CPU (small)", CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    # each query's largest score error as a share of its largest |score|
    share = max((float(np.max(np.abs(on_card.scores_of(t)
                                     - on_cpu.scores_of(t))))
                 / float(np.max(np.abs(on_cpu.scores_of(t))))
                 for t in range(len(tq))
                 if on_cpu.counts[t] and np.any(on_cpu.scores_of(t))),
                default=0.0)
    check(share <= CPU_RTOL, f"{family} sampled card vs CPU (small): a "
          f"query's largest score error is {share:.3e} of its largest "
          f"|score|, want <= {CPU_RTOL}")
    a, b = on_card.err_bound.astype(np.float64), on_cpu.err_bound
    check(np.array_equal(a == 0, b == 0), f"{family} sampled card vs CPU "
          "(small): exact (bound 0) queries differ")
    rel = float(np.max(np.abs(a - b) / np.where(b > 0, b, 1.0)))
    check(rel <= SAMPLED_BOUND_RTOL, f"{family} sampled card vs CPU (small): "
          f"bounds differ by {rel:.3e} relative, want <= "
          f"{SAMPLED_BOUND_RTOL}")
    log(f"{family} sampled cap={SAMPLED_CAP}, small input ({sampled} of "
        f"{len(tq)} queries sampled): card vs CPU {parity}; scores within "
        f"{share:.3e} of each query's largest |score|; bounds within "
        f"{rel:.3e} relative")
    return {**parity, "sampled_queries": sampled, "bound_max_rel_err": rel,
            "max_err_of_query_max_abs": share}


def drive_sampled(family: str, eng, train, pts) -> dict:
    """8c: the sampled rung at cap SAMPLED_CAP, tol inf."""
    samp = ladder_engine(eng, train, solver="sampled",
                         sampled_cap=SAMPLED_CAP)
    reset_counts()
    res = {T: samp.query_batch(pts[:T]) for T in BATCHES}
    launches = launch_counts()
    for name in (SOURCES[family], SEGMENT_SOURCE, CERT_SOURCE,
                 EIGMIN_SOURCE):
        check(launches[name] > 0, f"the {family} sampled rung never "
              f"launched {name}")
    # a replayed graph is the eager program, bit for bit
    T0 = BATCHES[0]
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T0])
    eager = [o.cpu().numpy() for o in samp._flat_fn(s_pad, mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)]
    r0, total0 = res[T0], int(res[T0].counts.sum())
    check(r0._packed.tobytes() == eager[0][:total0].tobytes()
          and r0.ihvp.tobytes() == eager[1][:T0].tobytes()
          and r0.test_grad.tobytes() == eager[2][:T0].tobytes()
          and r0.err_bound.tobytes() == eager[3][:T0].tobytes(),
          f"{family} sampled: a replayed graph differs from the eager "
          "program")
    # no host wait while a dispatch is queued (the geometries are warm)
    enqueue = samp._enqueue_sampled

    def checked(points):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enqueue(points)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    samp._enqueue_sampled = checked
    try:
        for T in BATCHES:
            got = samp.query_batch(pts[:T])
            check(got._packed.tobytes() == res[T]._packed.tobytes()
                  and got.err_bound.tobytes() == res[T].err_bound.tobytes(),
                  f"{family} sampled T={T}: a dispatch under sync debug "
                  "mode differs")
    finally:
        del samp._enqueue_sampled
    check(not samp.sampled_stats()["escalations"], f"{family} sampled: "
          f"escalations {samp.sampled_stats()['escalations']}")
    log(f"{family} sampled: a replayed graph bitwise the eager program "
        f"(T={T0}); no host wait while a dispatch is queued "
        f"(set_sync_debug_mode('error'), T={BATCHES}); captured geometries "
        f"{len(samp.compiled_geometries()['jit'])}")
    # memory: each sampled geometry's graph pool (held for the engine's
    # life) beside the eager program's peak on the same batch (what the
    # uncaptured program took at once, then gave back to the allocator)
    eager_peak_mb = {}
    for T in BATCHES:
        _, tx, ws, m, s_pad = samp._sampled_inputs(pts[:T])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = samp._flat_fn(s_pad, mode="sampled")(
            samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)
        torch.cuda.synchronize()
        eager_peak_mb[str(T)] = (torch.cuda.max_memory_allocated()
                                 - base) / 2 ** 20
        del outs
    graphs = graph_inventory(samp)
    log(f"{family} sampled graphs: pools {graphs['pool_mb']} MiB "
        f"({sum(graphs['pool_mb']):.1f} in all) for {graphs['geometries']} "
        f"geometries; the eager program's peak "
        f"{ {k: round(v, 1) for k, v in eager_peak_mb.items()} } MiB")
    direct = {T: eng.query_batch(pts[:T]) for T in BATCHES}
    T = BATCHES[-1]
    r, dr = res[T], direct[T]
    check(r.approx and r.err_bound.shape == (T,)
          and bool(np.isfinite(r.err_bound).all())
          and bool((r.err_bound >= 0).all()),
          f"{family} sampled: bounds {r.err_bound[:4]}...")
    ok = np.array([
        float(np.max(np.abs(r.scores_of(t) - dr.scores_of(t)), initial=0.0))
        <= float(r.err_bound[t]) + 1e-6 for t in range(T)])
    share = float(ok.mean())
    check(share >= FIDELITY_SHARE, f"{family} sampled: |sampled - direct| "
          f"<= err_bound + 1e-6 on {share:.4f} of {T} queries, want >= "
          f"{FIDELITY_SHARE}")
    # at these random weights λ_min sits at the damping floor, so the
    # bound is loose and the gate above says little: print a query's
    # typical largest |score| beside it
    typical = float(np.median([np.abs(dr.scores_of(t)).max(initial=0.0)
                               for t in range(T)]))
    log(f"{family} sampled cap={SAMPLED_CAP}: |sampled - direct| within the "
        f"bound on {share:.4f} of {T} queries; bound median "
        f"{float(np.median(r.err_bound)):.3e}, max "
        f"{float(r.err_bound.max()):.3e} (a query's largest |score|: "
        f"median {typical:.3e}); launches {launches}")
    small = sampled_small(family, eng.model)
    # at a cap above every count the rung is the direct path, bound 0
    T0 = BATCHES[0]
    full = ladder_engine(eng, train, solver="sampled", sampled_cap=10 ** 6)
    ex = full.query_batch(pts[:T0])
    check(ex._packed.tobytes() == direct[T0]._packed.tobytes()
          and ex.ihvp.tobytes() == direct[T0].ihvp.tobytes()
          and bool((ex.err_bound == 0.0).all()),
          f"{family} sampled at cap 1e6: not bitwise the direct path with "
          "bounds 0")
    log(f"{family} sampled at cap 1e6, T={T0}: bitwise the direct path, "
        "every bound exactly 0")
    # any split: every query's scores and bound the same bits
    for bq in SAMPLED_SPLITS:
        parts = samp.query_many(pts[:T], batch_queries=bq)
        same_bytes_stitched(parts, r, f"{family} sampled query_many({bq})")
        check(np.concatenate([p.err_bound for p in parts]).tobytes()
              == r.err_bound.tobytes(), f"{family} sampled query_many({bq}): "
              "bounds differ from one dispatch")
    log(f"{family} sampled: query_many at {SAMPLED_SPLITS} bitwise one "
        "dispatch, scores and bounds")
    # escalation: tol at the median bound of ESCALATE_T queries
    q = pts[:ESCALATE_T]
    eb = r.err_bound[:ESCALATE_T]
    tol = float(np.median(eb))
    over, keep = np.flatnonzero(eb > tol), np.flatnonzero(eb <= tol)
    esc = ladder_engine(eng, train, solver="sampled", sampled_cap=SAMPLED_CAP,
                        sampled_tol=tol, lissa_depth=ESCALATE_DEPTH)
    got = esc.query_batch(q)
    lissa = ladder_engine(eng, train, solver="lissa",
                          lissa_depth=ESCALATE_DEPTH).query_batch(q[over])
    for k, t in enumerate(over):
        check(got.scores_of(int(t)).tobytes() == lissa.scores_of(k).tobytes()
              and got.err_bound[t] == 0.0,
              f"{family} sampled escalation: query {t} not the lissa rung's")
    for t in keep:
        check(got.scores_of(int(t)).tobytes() == r.scores_of(int(t)).tobytes()
              and got.err_bound[t] == r.err_bound[t],
              f"{family} sampled escalation: kept query {t} changed")
    check(esc.sampled_stats()["escalations"] == {"tolerance": len(over)},
          f"{family} sampled escalation counts {esc.sampled_stats()}")
    log(f"{family} sampled tol={tol:.3e} on {ESCALATE_T} queries: "
        f"{len(over)} escalated to lissa (depth {ESCALATE_DEPTH}), each in "
        "its place, the rest unchanged")
    # times, beside direct in the same run
    times = {}
    for T in BATCHES:
        q = pts[:T]
        ms = wall_ms(lambda: samp.query_batch(q))
        ms_direct = wall_ms(lambda: eng.query_batch(q))
        total = int(res[T].counts.sum())
        times[str(T)] = {
            "ms": ms, "scores_per_s": total / ms * 1e3,
            "direct_ms": ms_direct,
            "direct_scores_per_s": total / ms_direct * 1e3,
            "device": device_breakdown(lambda: samp.query_batch(q), ms),
            "host_waits": host_waits(lambda: samp.query_batch(q)),
        }
        log(f"{family} sampled T={T}: {ms:.2f} ms ({total / ms:.0f} k "
            f"scores/s), direct {ms_direct:.2f} ms; busy share "
            f"{times[str(T)]['device']['busy_share']:.2f}; host waits "
            f"{times[str(T)]['host_waits']}")
    counts = samp.index.counts_batch(pts[:T])
    s_pad = samp._s_pad_for(int(counts.sum()))
    t0 = time.perf_counter()
    sampled_mod.sample_weights(pts[:T], counts, s_pad, SAMPLED_CAP)
    sw_ms = (time.perf_counter() - t0) * 1e3
    log(f"{family} sample_weights on the host, T={T}: {sw_ms:.2f} ms")
    return {"launches": launches, "fidelity_share": share,
            "replay_vs_eager": "bitwise equal",
            "host_waits_while_queued": 0,
            "bound_median": float(np.median(r.err_bound)),
            "typical_max_abs_score": typical, "small_card_vs_cpu": small,
            "escalated": int(len(over)), "times": times,
            "sample_weights_host_ms": sw_ms, "graphs": graphs,
            "eager_peak_mb": eager_peak_mb}


def library_times(eng, H, v) -> dict:
    """The ladder's library calls at T = 1024 by CUDA events: the bank's
    batched Cholesky (``cholesky_ex``) and ``eigh`` of ``factorize``, the
    bank hit's solve (two triangular solves and a matvec, in pieces of
    64), and the sampled rung's ``eigvalsh`` in pieces of 64."""
    Hc = H.contiguous()
    L = torch.linalg.cholesky_ex(Hc)[0]
    kind = torch.zeros(Hc.shape[0], dtype=torch.int32, device=CARD)
    return {
        "cholesky_ex_ms": time_ms(lambda: torch.linalg.cholesky_ex(Hc),
                                  iters=5),
        "eigh_ms": time_ms(lambda: torch.linalg.eigh(Hc), iters=1,
                           warmup=1),
        "bank_solve_ms": time_ms(lambda: _in_pieces(_bank_solve, L, kind, v),
                                 iters=5),
        "eigvalsh_pieces_ms": time_ms(lambda: _in_pieces(
            lambda h: torch.linalg.eigvalsh(h)[:, 0], Hc), iters=1, warmup=1),
    }


def publish_hot_bank(family: str, eng, train, workdir: str) -> tuple:
    """8d's bank: BANK_ENTRIES hot pairs built and published under
    ``workdir`` as ``smoke-<family>``'s; ``(bank, builder, build_s)``."""
    name = f"smoke-{family}"
    builder = ladder_engine(eng, train, cache_dir=workdir, model_name=name)
    pairs = fbank.select_hot_pairs(builder.index, BANK_ENTRIES)
    t0 = time.perf_counter()
    bank = fbank.build_bank(builder, pairs, batch_queries=512)
    build_s = time.perf_counter() - t0
    fbank.publish_bank(bank, builder.factor_bank_path(), fbank.bank_fingerprint(
        name, eng.model.block_size, DAMPING, *builder._train_host))
    return bank, builder, build_s


def drive_bank(family: str, eng, train, pts, workdir: str) -> dict:
    """8d: a bank of BANK_ENTRIES hot pairs built, published and loaded;
    hits against direct, misses bitwise direct, a hit alone and in the
    batch, all-hit batches timed beside direct, and a surgical refresh."""
    name = f"smoke-{family}"
    reset_counts()
    bank, builder, build_s = publish_hot_bank(family, eng, train, workdir)
    build_launches = launch_counts()
    check(build_launches[SEGMENT_SOURCE] > 0, f"{family} bank build never "
          f"launched {SEGMENT_SOURCE}")
    kinds = {"cholesky": int((bank.kind == fbank.KIND_CHOLESKY).sum()),
             "inverse": int((bank.kind == fbank.KIND_INVERSE).sum())}
    log(f"{family} bank: {len(bank)} entries built in {build_s:.2f} s "
        f"({kinds}), {bank.factor.nbytes / 1e6:.1f} MB")
    # the hot blocks for the library calls' times, taken now: the eager
    # Hessian of 512 hot queries (~10M rows) needs several GB, which the
    # graphs captured below for the all-hit batches hold later
    H_hot = builder.block_hessians(bank.pairs[:BATCHES[-1]].astype(np.int64),
                                   batch_queries=512)
    # misses fall through the sampled rung at a cap above every count:
    # bitwise the direct path
    pre = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                        model_name=name, sampled_cap=10 ** 6)
    check(pre.ensure_factor_bank() == len(bank)
          and pre.bank_stats()["dropped_stale"] == 0,
          f"{family} bank: loaded {pre.bank_stats()}")
    half = BANK_T // 2
    banked = {tuple(p) for p in bank.pairs.tolist()}
    misses = np.asarray([p for p in pts.tolist() if tuple(p) not in banked]
                        [:half], np.int64)
    hits = bank.pairs[:half].astype(np.int64)
    mixed = np.empty((2 * half, 2), np.int64)
    mixed[0::2], mixed[1::2] = hits, misses
    reset_counts()
    res = pre.query_batch(mixed)
    bank_launches = launch_counts()
    check(bank_launches[SOURCES[family]] > 0, f"{family} bank hits never "
          f"launched {SOURCES[family]}")
    check(pre.bank_stats()["hits"] == half
          and pre.bank_stats()["misses"] == half,
          f"{family} bank: {pre.bank_stats()}")
    ref = eng.query_batch(mixed)
    worst_rho, worst_rel = 1.0, 0.0
    for t in range(len(mixed)):
        a, b = res.scores_of(t), ref.scores_of(t)
        if t % 2:
            check(a.tobytes() == b.tobytes(), f"{family} bank miss {t} not "
                  "bitwise the direct path")
            continue
        check(bool(np.isfinite(a).all()), f"{family} bank hit {t}: non-finite")
        if len(a):
            worst_rel = max(worst_rel, float(np.max(np.abs(a - b)))
                            / max(float(np.max(np.abs(b))), 1e-30))
        if len(a) > 1 and np.ptp(a) > 0 and np.ptp(b) > 0:
            worst_rho = min(worst_rho, spearman(a, b))
    check(worst_rho >= BANK_RHO, f"{family} bank hits: Spearman "
          f"{worst_rho} < {BANK_RHO} against direct")
    for t in (0, 2, 4):
        solo = pre.query_batch(mixed[t:t + 1])
        check(solo.scores_of(0).tobytes() == res.scores_of(t).tobytes(),
              f"{family} bank hit {t}: alone differs from in the batch")
    log(f"{family} bank on {2 * half} queries (half hits): hits' Spearman "
        f">= {worst_rho:.6f} against direct (largest score difference "
        f"{worst_rel:.3e} of the query's largest |score|); misses bitwise "
        f"direct; a hit alone "
        f"the same bits as in the batch; launches {bank_launches}")
    # the mixed batch timed at the default sampled_cap (a miss then takes
    # the sampled rung, eigvalsh and all) and at cap 1e6, beside direct
    dflt = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                         model_name=name)
    check(dflt.sampled_cap == sampled_mod.DEFAULT_CAP
          and dflt.ensure_factor_bank() == len(bank),
          f"{family} bank at the default cap: {dflt.bank_stats()}")
    mixed_ms = {"default_cap": wall_ms(lambda: dflt.query_batch(mixed)),
                "cap_1e6": wall_ms(lambda: pre.query_batch(mixed)),
                "direct": wall_ms(lambda: eng.query_batch(mixed))}
    log(f"{family} bank mixed T={len(mixed)} (half misses): "
        f"{mixed_ms['default_cap']:.2f} ms at the default cap "
        f"{sampled_mod.DEFAULT_CAP}, {mixed_ms['cap_1e6']:.2f} ms at cap "
        f"1e6, direct {mixed_ms['direct']:.2f} ms")
    # the sampled graphs each precomputed engine's miss delegate holds
    miss_graphs = {"default_cap": graph_inventory(dflt._miss_delegate()),
                   "cap_1e6": graph_inventory(pre._miss_delegate())}
    log(f"{family} bank miss delegates' sampled graphs: {miss_graphs}")
    times = {"mixed": mixed_ms, "miss_delegate_graphs": miss_graphs}
    hot = bank.pairs.astype(np.int64)
    for T in BATCHES:
        q = hot[:T]
        ms = wall_ms(lambda: pre.query_batch(q))
        ms_direct = wall_ms(lambda: eng.query_batch(q))
        total = int(pre.index.counts_batch(q).sum())
        times[str(T)] = {"ms": ms, "direct_ms": ms_direct, "rows": total,
                         "device": device_breakdown(
                             lambda: pre.query_batch(q), ms)}
        log(f"{family} bank all-hit T={T} ({total} rows): {ms:.2f} ms, "
            f"direct {ms_direct:.2f} ms")
    # surgical refresh: one user's row moves. A hot user rated every hot
    # item, which touches every entry, so the user is the least active
    # one who rated some banked item but not all of them
    x = builder._train_host[0]
    items = np.unique(bank.pairs[:, 1])
    deg = builder.index.user_degrees()
    u0 = next(int(u) for u in np.argsort(deg, kind="stable") if deg[u] and
              0 < np.isin(x[builder.index.rows_of_user(int(u)), 1],
                          items).sum() < len(items))
    table = "P" if family == "mf" else "P_mlp"
    host = {k: v.detach().cpu().numpy().copy()
            for k, v in eng.params.items()}
    host[table][u0] += 0.125
    stale = np.asarray([
        u == u0 or u0 in x[builder.index.rows_of_item(i), 0]
        for u, i in bank.pairs.tolist()])
    check(0 < stale.sum() < len(bank), f"{family} bank refresh: user {u0} "
          f"touches {int(stale.sum())} of {len(bank)} entries")
    out = fbank.refresh_bank(eng.model, host, *builder._train_host,
                             builder.index, DAMPING,
                             builder.factor_bank_path(), name)
    check(out == {"kept": int((~stale).sum()), "dropped": int(stale.sum())},
          f"{family} bank refresh {out}, want dropped {int(stale.sum())}")
    log(f"{family} bank refresh after user {u0}'s row moved: {out}")
    Hd = torch.as_tensor(H_hot).to(CARD)
    v = torch.randn(Hd.shape[0], Hd.shape[1], device=CARD)
    lib = library_times(eng, Hd, v)
    log(f"{family} library calls at T={Hd.shape[0]}: {lib}")
    return {"entries": len(bank), "kinds": kinds, "build_s": build_s,
            "mb": bank.factor.nbytes / 1e6, "hit_spearman_min": worst_rho,
            "hit_max_rel_diff": worst_rel, "times": times,
            "refresh": out, "launches": bank_launches,
            "build_launches": build_launches, "library_ms": lib}


def drive_full(train, pts) -> dict:
    """8e: ``FullInfluenceEngine`` on MF k = 16 at ML-1M shape (CG,
    maxiter FULL_MAXITER, two test points): ms an HVP, iterations and the
    relative residual; on phase 4's small input, the card against the
    port's CPU path."""
    model = MF(USERS, ITEMS, K_EMB, WD)
    params = model.init_params(torch.Generator().manual_seed(0), device=CARD)
    full = FullInfluenceEngine(model, params, train, damping=DAMPING,
                               solver="cg", cg_maxiter=FULL_MAXITER)
    tx = pts[:2].astype(np.int32)
    ty = np.ones(2, np.float32) * 3.0
    v = full.test_loss_grad(tx, ty)
    hvp_ms = time_ms(lambda: full._hvp(v), iters=5)
    t0 = time.perf_counter()
    scores = full.get_influence_on_test_loss(tx, ty)
    wall_s = time.perf_counter() - t0
    x = full.get_inverse_hvp(v)
    rr = full.relative_residual(v, x)
    check(scores.shape == (ROWS,) and bool(np.isfinite(scores).all()),
          f"full engine: scores {scores.shape}")
    log(f"full engine MF k={K_EMB}: {hvp_ms:.2f} ms an HVP, CG "
        f"{full.last_iterations} iterations, relative residual {rr:.3e}, "
        f"influence of {ROWS} rows in {wall_s:.2f} s")
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = MF(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    kw = dict(damping=FULL_SMALL_DAMPING, solver="cg", cg_tol=1e-12,
              cg_maxiter=300)
    tq, tyy = tiny["test"].x[:2], tiny["test"].y[:2]
    card = FullInfluenceEngine(tm, tp, tiny["train"], **kw
                               ).get_influence_on_test_loss(tq, tyy)
    cpu = FullInfluenceEngine(tm, tp, tiny["train"], device="cpu", **kw
                              ).get_influence_on_test_loss(tq, tyy)
    err = float(np.max(np.abs(card - cpu)) / np.max(np.abs(cpu)))
    check(np.allclose(card, cpu, rtol=FULL_RTOL,
                      atol=FULL_RTOL * np.abs(cpu).max()),
          f"full engine: card vs CPU beyond rtol {FULL_RTOL} (max err "
          f"{err:.3e} of max |score|)")
    log(f"full engine, small input: card vs CPU within rtol {FULL_RTOL} "
        f"(max err {err:.3e} of max |score|)")
    return {"hvp_ms": hvp_ms, "iterations": full.last_iterations,
            "relative_residual": rr, "influence_s": wall_s,
            "small_card_vs_cpu_err": err}


def drive_facade(workdir: str) -> dict:
    """8f: ``FIAModel`` on phase 4's small input, trained a few steps on
    the card; its influence bitwise the engine's."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    fia = FIAModel(model="MF", num_users=60, num_items=40, embedding_size=8,
                   weight_decay=1e-3, batch_size=200, data_sets=tiny,
                   initial_learning_rate=1e-2, damping=1e-3,
                   train_dir=workdir, model_name="smoke-facade")
    fia.train(num_steps=FACADE_STEPS, verbose=False)
    got = fia.get_influence_on_test_loss([0])
    eng = engine(fia.model, fia.params, tiny["train"], damping=1e-3)
    want = eng.get_influence_on_test_loss([0], tiny["test"])
    check(got.tobytes() == want.tobytes() and bool(np.isfinite(got).all()),
          "FIAModel: influence differs from the engine's")
    log(f"FIAModel: trained {FACADE_STEPS} steps on the card; "
        f"get_influence_on_test_loss bitwise the engine's ({got.size} rows)")
    return {"steps": FACADE_STEPS, "rows": int(got.size)}


def drive_ladder(engines, train, pts, workdir: str) -> dict:
    """Phase 8, per model: 8a-8d and 8g, then 8g's synthetic blocks, 8h,
    8e and 8f once. 8d's banks stay in ``workdir`` for phase 10."""
    out = {}
    gen = torch.Generator().manual_seed(8)
    for family, (eng, _) in engines.items():
        samp = ladder_engine(eng, train, solver="sampled",
                             sampled_cap=SAMPLED_CAP)
        out[family] = {
            "certificate": check_certificate(family, samp, pts, gen),
            "eigmin": check_eigmin(family, samp, pts),
            "segment_ht": check_segment_ht(family, samp, pts, gen),
            "sampled": drive_sampled(family, eng, train, pts),
            "bank": drive_bank(family, eng, train, pts, workdir),
        }
        torch.cuda.empty_cache()
    out["eigmin_synthetic"] = check_eigmin_synthetic()
    out["eigmin_small"] = check_eigmin_small()
    out["sampled_wide"] = drive_sampled_wide(train, pts)
    out["full"] = drive_full(train, pts)
    out["facade"] = drive_facade(workdir)
    return out


# -- phase 9: recovery and observability -----------------------------------
# 9a: query_many over 1024 queries, 256 a batch, 4 in flight, a worker
# death injected at the second dispatch; 9b: query_batch(1024) with a
# worker death (then halves) and a preemption (then the same size) at the
# first dispatch; 9c: a real CUDA OOM on the flat path, all but
# OOM_MARGIN bytes of the card's free memory (and the allocator's cached
# free blocks) held by blockers, and one inside a capture; 9d: a
# real CUDA OOM on the padded direct program at PADDED_T queries, the
# allocator capped at OOM_CAP_SHARE of the full batch's own memory above
# what is resident; 9e: a device-side assert in a child process, whose
# next query must raise DEVICE_LOST within STICKY_LIMIT_S; 9f: tracing on.
RECOVERY_Q, RECOVERY_BATCH, RECOVERY_WINDOW = 1024, 256, 4
OOM_MARGIN = 1 << 20
BLOCKER_PIECES = 100_000  # the most blockers 9c allocates
OOM_Q = 100  # 9c's query count: a geometry no earlier phase captured
OOM_CAPTURE_Q = 200  # 9c's capture-time OOM: another new geometry
# what a failed capture may leave reserved: a library workspace of the
# warm-up's stream, not the graph's private pool (hundreds of MiB here)
CAPTURE_LEFT_MB = 64
OOM_CAP_SHARE = 0.75
STICKY_LIMIT_S = 60.0
TRACE_REPS = 3
# the child of 9e: a small engine on the card with the CPU rung on (so
# that taking it would show), one query, then an out-of-range index on
# the card (a device-side assert, which poisons the CUDA context) and
# the query again; prints what the query raised
STICKY_CHILD = r"""
import json, time
import torch
from fia_tpu_torch import obs
from fia_tpu_torch.data.synthetic import synthetic_splits
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF
from fia_tpu_torch.reliability import inject, taxonomy
tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
model = MF(60, 40, 8, 1e-3)
eng = InfluenceEngine(model, model.init_params(torch.Generator().manual_seed(0)),
                      tiny["train"], damping=1e-3, cpu_fallback=True)
q = tiny["test"].x[:21]
eng.query_batch(q)
x = torch.zeros(4, device="cuda")
x[torch.tensor([1 << 20], device="cuda")] += 1.0  # device-side assert
out = {"cls": None, "message": None}
t0 = time.perf_counter()
with inject.active() as inj:
    try:
        eng.query_batch(q)
    except Exception as e:
        out["cls"] = taxonomy.classify(e)
        out["message"] = str(e).splitlines()[0][:300]
out["seconds"] = time.perf_counter() - t0
snap = obs.REGISTRY.snapshot()["counters"]
out["uploads"] = inj.counts.get("engine.upload", 0)
out["resets"] = snap.get("engine.device_resets", 0)
out["retries"] = sum(v for k, v in snap.items()
                     if k.startswith("reliability.retries_total"))
out["reliability_diags"] = snap.get("diag_total{channel=reliability}", 0)
out["cpu_rung"] = eng._cpu_engine is not None
print("STICKY " + json.dumps(out), flush=True)
"""


def recovery_counts() -> dict:
    """The registry's recovery counters: retries (any kind), device-state
    resets, reliability diagnostics (the CPU rung announces itself so,
    and so does the NaN ladder)."""
    snap = obs.REGISTRY.snapshot()["counters"]
    return {"retries": sum(v for k, v in snap.items()
                           if k.startswith("reliability.retries_total")),
            "resets": snap.get("engine.device_resets", 0.0),
            "cpu_rung_batches": snap.get("engine.cpu_fallback_batches", 0.0),
            "reliability_diags": snap.get("diag_total{channel=reliability}",
                                          0.0)}


def no_recovery(phase: str) -> None:
    """Fail if ``phase`` passed through a recovery ladder: it must pass on
    the card, with no retry, rebuild or CPU rung."""
    got = recovery_counts()
    check(not any(got.values()), f"phase {phase} went through a recovery "
          f"ladder: {got}")
    log(f"phase {phase}: no retry, reset or reliability diagnostic")


def engine_tensors(eng) -> dict:
    """``id -> tensor`` of every tensor reachable from the engine and its
    delegates: their attributes (dicts, tuples and lists of them), the
    captured programs' static inputs and outputs, the CPU rung aside."""
    out, seen = {}, set()
    stack = [eng, *eng._delegates_deep()]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            out[id(obj)] = obj
        elif isinstance(obj, dict):
            stack.extend(obj.values())
            stack.extend(obj.keys())
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)
        elif isinstance(obj, InfluenceEngine):
            stack.extend(v for k, v in vars(obj).items() if k != "_cpu_engine")
        elif isinstance(obj, _FlatGraph):
            stack.extend((obj.inputs, obj.out))
    return out


def recover_worker_stream(family: str, eng, pts) -> dict:
    """9a: a worker death mid-stream in ``query_many``."""
    q = pts[:RECOVERY_Q]
    kw = dict(batch_queries=RECOVERY_BATCH, window=RECOVERY_WINDOW)
    base = eng.query_many(q, **kw)
    ref = eng.query_batch(q)
    same_bytes_stitched(base, ref, f"{family} 9a fault-free query_many")
    # the second dispatch raises while the first is still in flight
    before = engine_tensors(eng)
    progs_before = len(eng._programs)
    builds0 = compilemon.count()
    with inject.active(inject.Fault(sites.ENGINE_DISPATCH_FLAT, at=1,
                                    kind=taxonomy.WORKER),
                       strict=True) as inj:
        got = eng.query_many(q, **kw)
    builds = compilemon.count() - builds0
    check(inj.counts.get(sites.ENGINE_UPLOAD, 0) == 1,
          f"{family} 9a: engine.upload fired {inj.counts}")
    check(len(got) == len(base), f"{family} 9a: {len(got)} batches")
    for k, (g, b) in enumerate(zip(got, base)):
        same_bytes(g, b, f"{family} 9a batch {k}")
    after = engine_tensors(eng)
    stale = set(before) & set(after)
    check(not stale, f"{family} 9a: {len(stale)} pre-reset tensors still "
          "reachable from the engine or its delegates")
    check(builds > 0, f"{family} 9a: nothing was recaptured after the reset")
    out = {"dispatches": inj.counts.get(sites.ENGINE_DISPATCH_FLAT, 0),
           "uploads": inj.counts.get(sites.ENGINE_UPLOAD, 0),
           "graphs_before": progs_before, "graphs_after": len(eng._programs),
           "captures_in_recovery": builds,
           "tensors_before": len(before), "tensors_after": len(after),
           "pre_reset_tensors_reachable": 0, "bitwise": True}
    log(f"{family} 9a worker death mid-stream: {json.dumps(out)}")
    return out


def recover_batch(family: str, eng, pts) -> dict:
    """9b: the halving and preemption ladders in one ``query_batch``."""
    q = pts[:RECOVERY_Q]
    base = eng.query_batch(q)
    out = {}
    for kind, want in ((taxonomy.WORKER, 3), (taxonomy.PREEMPTION, 2)):
        t0 = time.perf_counter()
        with inject.active(inject.Fault(sites.ENGINE_DISPATCH_FLAT, at=0,
                                        kind=kind), strict=True) as inj:
            got = eng.query_batch(q)
        secs = time.perf_counter() - t0
        n = inj.counts.get(sites.ENGINE_DISPATCH_FLAT, 0)
        check(n == want and inj.counts.get(sites.ENGINE_UPLOAD, 0) == 1,
              f"{family} 9b {kind}: {inj.counts} (want {want} dispatches, "
              "one upload)")
        same_bytes(got, base, f"{family} 9b {kind}")
        out[kind] = {"dispatches": n, "seconds": secs, "bitwise": True}
    log(f"{family} 9b ladders: {json.dumps(out)}")
    return out


def free_bytes() -> int:
    torch.cuda.synchronize()
    return int(torch.cuda.mem_get_info()[0])


@contextlib.contextmanager
def blocking(margin: int):
    """Blockers holding, for the block, all of the card's free memory but
    ``margin`` bytes (in whole 2 MiB pages, as the allocator maps them),
    and every free block of 1 MiB or more inside the allocator's cached
    segments (which would serve an allocation without asking the card);
    released to the card when the block ends."""
    gc.collect()
    torch.cuda.empty_cache()
    n = (free_bytes() - margin) // (2 << 20) * (2 << 20)
    held = [torch.empty(n, dtype=torch.uint8, device=CARD)]
    size = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    while size >= 1 << 20 and len(held) < BLOCKER_PIECES:
        try:
            held.append(torch.empty(size, dtype=torch.uint8, device=CARD))
        except torch.cuda.OutOfMemoryError:
            size //= 2
    try:
        yield
    finally:
        del held
        torch.cuda.empty_cache()


def capture_state_clean(what: str) -> None:
    check(not torch.cuda.is_current_stream_capturing()
          and torch.cuda.current_stream() == torch.cuda.default_stream(),
          f"{what}: a capture was left open, or the capture stream is "
          "still current")


def capture_oom(family: str, off, eng, q) -> dict:
    """9c, inside a capture: the program of a new geometry asks, while
    the stream captures, for more memory than the card has. The CUDA OOM
    must rise classified OOM with the capture ended (no stream left
    capturing, the previous stream current), the graph's pool released,
    and the engine must capture that geometry afterwards and answer as
    another engine does."""
    total = torch.cuda.get_device_properties(0).total_memory
    inner = off._flat_fn

    def greedy(s_pad, stage="scores", mode="direct", **kw):
        fn = inner(s_pad, stage, mode, **kw)

        def run(*args):
            if torch.cuda.is_current_stream_capturing():
                torch.empty(total, dtype=torch.uint8, device=CARD)
            return fn(*args)

        return run

    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    off._flat_fn = greedy
    err = None
    try:
        off.query_batch(q)
    except Exception as e:
        err = e
    finally:
        del off._flat_fn
    check(err is not None, f"{family} 9c: no OOM inside the capture")
    cls, text = taxonomy.classify(err), str(err)
    del err  # its traceback holds the failed program's tensors
    check(cls == taxonomy.OOM and ": capture: " in text,
          f"{family} 9c in a capture: {cls!r}: {text[:400]}")
    capture_state_clean(f"{family} 9c in a capture")
    gc.collect()
    torch.cuda.empty_cache()
    left_mb = (torch.cuda.memory_reserved() - reserved0) / 2**20
    check(left_mb < CAPTURE_LEFT_MB, f"{family} 9c: the failed capture "
          f"left {left_mb} MiB reserved")
    same_bytes(off.query_batch(q), eng.query_batch(q),
                f"{family} 9c the geometry captured after the OOM")
    return {"class": cls, "reserved_left_mb": left_mb,
            "recaptured": "bitwise another engine's answer"}


def recover_flat_oom(family: str, eng, train, pts) -> dict:
    """9c: a real CUDA OOM on the flat path (an uncaptured geometry under
    a blocker): it rises classified OOM with the CPU rung off, the CPU
    rung answers with it on, and once the blocker is freed the same
    engines answer on the card as before."""
    q = pts[:OOM_Q]
    want = eng.query_batch(q)  # the card's answer, another engine
    off = engine(eng.model, eng.params, train, damping=DAMPING)
    err = None
    with blocking(OOM_MARGIN):
        try:
            off.query_batch(q)  # a fresh engine: the geometry is new
        except Exception as e:
            err = e
    check(err is not None, f"{family} 9c: no OOM under the blocker")
    cls, text = taxonomy.classify(err), str(err)
    del err  # its traceback holds the failed program's tensors
    check(cls == taxonomy.OOM, f"{family} 9c: the failure classified "
          f"{cls!r}: {text[:400]}")
    stage = ("capture" if ": capture: " in text else
             "warm-up" if ": warm-up: " in text else "eager")
    capture_state_clean(f"{family} 9c")
    again = off.query_batch(q)
    same_bytes(again, want, f"{family} 9c after the OOM (rung off)")
    in_capture = capture_oom(family, off, eng, pts[:OOM_CAPTURE_Q])
    # the CPU rung, on phase 4's small input
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    tm = type(eng.model)(60, 40, 8, 1e-3)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tq, tq2 = tiny["test"].x[:21], tiny["test"].x[21:50]
    card = engine(tm, tp, tiny["train"], damping=1e-3)
    card_ans = card.query_batch(tq2)
    on = InfluenceEngine(tm, tp, tiny["train"], damping=1e-3,
                         cpu_fallback=True)
    first = on.query_batch(tq)  # captured before the OOM
    before = recovery_counts()
    with blocking(OOM_MARGIN):
        rung = on.query_batch(tq2)  # an uncaptured geometry: the CPU rung
    capture_state_clean(f"{family} 9c (CPU rung)")
    check(on._cpu_engine is not None, f"{family} 9c: the CPU rung did not run")
    after = recovery_counts()
    diags = after["reliability_diags"] - before["reliability_diags"]
    batches = after["cpu_rung_batches"] - before["cpu_rung_batches"]
    check(diags == 1 and batches == 1, f"{family} 9c: {diags} reliability "
          f"diagnostics and {batches} CPU-rung batches, want 1 and 1")
    parity = compare_results(rung, card_ans, f"{family} 9c CPU rung vs card",
                             CPU_RTOL, CPU_ATOL, CPU_RHO_MIN)
    same_bytes(on.query_batch(tq), first, f"{family} 9c replay after the OOM")
    same_bytes(on.query_batch(tq2), card_ans,
                f"{family} 9c the same engine on the card after the OOM")
    out = {"rung_off": {"class": cls, "failed_in": stage,
                        "message": text.splitlines()[0][:200]},
           "in_capture": in_capture,
           "cpu_rung": {"reliability_diags": diags, "batches": batches,
                        **parity},
           "after_blocker_freed": "bitwise the card's answer"}
    log(f"{family} 9c flat OOM: {json.dumps(out)}")
    return out


def chunk_log(eng) -> list:
    """Record each padded dispatch of ``eng`` as (queries, succeeded)."""
    log_, inner = [], eng._query_padded

    def spy(points, pad_to, s_pad=None):
        try:
            out = inner(points, pad_to, s_pad)
        except Exception:
            log_.append((len(points), False))
            raise
        log_.append((len(points), True))
        return out

    eng._query_padded = spy
    return log_


def recover_padded_oom(family: str, eng, train, pts) -> dict:
    """9d: a real CUDA OOM on the padded direct program: the batch ends
    in halves, the ceiling persists, and a fresh engine pre-chunks."""
    q = pts[:PADDED_T]
    full = padded_engine(eng, train, "direct", model_name=f"{family}-9d-ref")
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    ref = full.query_batch(q)
    need = torch.cuda.max_memory_reserved() - reserved0
    del full
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    limit = torch.cuda.memory_reserved() + OOM_CAP_SHARE * need
    name = f"{family}-9d"
    capped = padded_engine(eng, train, "direct", model_name=name)
    fresh = padded_engine(eng, train, "direct", model_name=name)
    first, second = chunk_log(capped), chunk_log(fresh)
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        got = capped.query_batch(q)
        pad = got._pad
        ok, bad = memlimits.load(capped._memkey)
        with inject.active() as inj:  # an empty plan: counts dispatches
            again = fresh.query_batch(q)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    failed = [n for n, ok_ in first if not ok_]
    check(failed and failed[0] == PADDED_T, f"{family} 9d: the capped "
          f"batch's dispatches {first}: no OOM at the full batch")
    check(bad == min(failed) * pad, f"{family} 9d: memlimits recorded "
          f"cells_bad {bad}, want {min(failed)} x {pad}")
    check(all(ok_ for _, ok_ in second)
          and [n for n, _ in second] == [n for n, ok_ in first if ok_]
          and inj.counts.get(sites.ENGINE_DISPATCH_PADDED, 0) == len(second),
          f"{family} 9d: the fresh engine dispatched {second}, want the "
          f"capped run's successful chunks {first} and no failure")
    ops = operands(eng, pts, PADDED_T)
    parity = compare_results(got, ref, f"{family} 9d halves vs uncapped",
                             PADDED_RTOL, PADDED_ATOL, PADDED_RHO,
                             relu_excuse(family, ops))
    same_bytes(again, got, f"{family} 9d the pre-chunked engine")
    bitwise = (got._packed.tobytes() == ref._packed.tobytes()
               and got.ihvp.tobytes() == ref.ihvp.tobytes())
    out = {"uncapped_mb": need / 2**20, "cap_mb": limit / 2**20,
           "dispatches": first, "fresh_dispatches": second,
           "cells_ok": ok, "cells_bad": bad, "pad": pad,
           "bitwise_vs_uncapped": bitwise, **parity}
    log(f"{family} 9d padded OOM: {json.dumps(out)}")
    return out


def recover_sticky() -> dict:
    """9e: a device-side assert in a child process, then a query: it
    must raise DEVICE_LOST within STICKY_LIMIT_S, with no retry, reset
    or CPU rung."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STICKY_CHILD],
                          capture_output=True, text=True,
                          timeout=STICKY_LIMIT_S + 120)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("STICKY ")]
    check(len(lines) == 1, f"9e: the child printed no result (exit "
          f"{proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(lines[0][len("STICKY "):])
    check(out["cls"] == taxonomy.DEVICE_LOST, f"9e: the query raised "
          f"{out['cls']!r}: {out['message']}")
    check(out["seconds"] < STICKY_LIMIT_S, f"9e: {out['seconds']:.1f} s to "
          "raise")
    check(not (out["uploads"] or out["resets"] or out["retries"]
               or out["reliability_diags"] or out["cpu_rung"]),
          f"9e: the failure went through a recovery ladder: {out}")
    out["child_seconds"] = time.perf_counter() - t0
    log(f"9e sticky error: {json.dumps(out)}")
    return out


def trace_on_card(family: str, eng, pts) -> dict:
    """9f: tracing on, no host wait in a dispatch, the same bits."""
    q = pts[:RECOVERY_Q]
    kw = dict(batch_queries=RECOVERY_BATCH, window=RECOVERY_WINDOW)

    def walls(traced: bool):
        obs.configure(trace=traced)
        try:
            times, res = [], None
            for _ in range(TRACE_REPS):
                # host results: the fetch already waited on the card
                res, s = fenced_time(eng.query_many, q, **kw)
                times.append(s * 1e3)
            return float(np.median(times)), res
        finally:
            obs.configure(trace=False)

    plain_ms, plain = walls(False)
    obs.TRACER.reset()
    dispatch = eng._dispatch_flat
    dispatch_without_waits(eng)
    try:
        traced_ms, traced = walls(True)
        obs.configure(trace=True)
        try:
            with obs.trace(f"{family}-9f"):
                one = eng.query_batch(q[:RECOVERY_BATCH])
        finally:
            obs.configure(trace=False)
    finally:
        eng._dispatch_flat = dispatch
    for k, (a, b) in enumerate(zip(traced, plain)):
        same_bytes(a, b, f"{family} 9f traced batch {k}")
    same_bytes_stitched([one], plain[0], f"{family} 9f traced query_batch")
    spans = [span_fields(s) for s in obs.TRACER.flush()]
    names = [s["name"] for s in spans]
    for name in ("engine.query", "engine.dispatch_flat"):
        check(name in names, f"{family} 9f: no {name} span")
    doc = json.loads(json.dumps(perfetto(spans)))
    check(len([e for e in doc["traceEvents"] if e["ph"] == "X"])
          == len(spans), f"{family} 9f: the Perfetto export lost spans")
    prom = prometheus(obs.REGISTRY.snapshot())
    for line in prom.splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])  # every sample parses
    out = {"untraced_ms": plain_ms, "traced_ms": traced_ms,
           "spans": len(spans),
           "dispatch_spans": names.count("engine.dispatch_flat"),
           "prometheus_lines": len(prom.splitlines()), "bitwise": True}
    log(f"{family} 9f tracing: {json.dumps(out)}")
    return out


def drive_recovery(engines, train, pts) -> dict:
    """Phase 9 (each model: 9a, 9b, 9c, 9d, 9f; 9e once), its memory
    envelope in a file of its own."""
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        os.environ["FIA_MEMLIMIT_CACHE"] = os.path.join(workdir, "mem.json")
        for family, (eng0, _) in engines.items():
            t0 = time.perf_counter()
            eng = InfluenceEngine(eng0.model, eng0.params, train,
                                  damping=DAMPING)  # the CPU rung on
            row = {"9a": recover_worker_stream(family, eng, pts),
                   "9b": recover_batch(family, eng, pts),
                   "9c": recover_flat_oom(family, eng, train, pts),
                   "9d": recover_padded_oom(family, eng0, train, pts),
                   "9f": trace_on_card(family, eng, pts)}
            row["seconds"] = time.perf_counter() - t0
            out[family] = row
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        out["9e"] = recover_sticky()
    return out


# -- phase 10: serving on the card -----------------------------------------
# 10a: SERVE_N requests from smoke_stream over the held-out queries (hot
# share SERVE_HOT_FRAC, seed SERVE_SEED), drained every SERVE_DRAIN, at
# max_batch SERVE_BATCH and dispatch_window SERVE_WINDOW; 10b: a
# precomputed service on 8d's bank browned out by two shed drains, then
# BROWNOUT_N requests, half banked pairs, half misses; 10c: a host-side
# fault at serve.dispatch on batch 1 of 10a's stream, and a worker death
# at engine.dispatch_flat with two batches in flight (ENGINE_FAULT_Q
# distinct queries at ENGINE_FAULT_BATCH a batch, ENGINE_FAULT_WINDOW in
# the window: the third dispatch fails); 10d: the serving and factor
# drivers in process.
SERVE_N, SERVE_DRAIN, SERVE_BATCH, SERVE_WINDOW = 4096, 1024, 1024, 2
SERVE_HOT_FRAC, SERVE_SEED = 0.5, 10
BROWNOUT_N = 512
ENGINE_FAULT_Q, ENGINE_FAULT_BATCH, ENGINE_FAULT_WINDOW = 1024, 256, 3
BROWNOUT_HEALTH = dict(window=4, min_evidence=2, hold=2, err_cache_only=2.0)


def serve_config(**kw) -> ServeConfig:
    """The phase's service knobs: no disk tier, a hot tier that holds
    every key of the stream (so that a drain's misses are the keys the
    stream has not seen yet)."""
    kw.setdefault("max_batch", SERVE_BATCH)
    kw.setdefault("dispatch_window", SERVE_WINDOW)
    kw.setdefault("disk_cache", False)
    kw.setdefault("cache_entries", SERVE_N)
    kw.setdefault("max_queue", SERVE_N)
    return ServeConfig(**kw)


def serve_stream(pts) -> list:
    return smoke_stream(pts, SERVE_N, SERVE_HOT_FRAC, SERVE_SEED)


def drain_misses(reqs) -> list:
    """Each drain's misses in first-arrival order, when no entry is ever
    evicted: the keys the stream has not seen before that drain."""
    seen, out = set(), []
    for s in range(0, len(reqs), SERVE_DRAIN):
        miss = []
        for r in reqs[s: s + SERVE_DRAIN]:
            if r.key() not in seen:
                seen.add(r.key())
                miss.append(r.key())
        out.append(np.asarray(miss, np.int64).reshape(-1, 2))
    return out


def serve_run(svc, reqs, waits: list | None = None) -> dict:
    """Submit ``reqs`` and drain every SERVE_DRAIN; with ``waits``,
    append each drain's (host waits, batches dispatched)."""
    out = {}
    for s in range(0, len(reqs), SERVE_DRAIN):
        for r in reqs[s: s + SERVE_DRAIN]:
            rej = svc.submit(r)
            if rej is not None:
                out[rej.id] = rej
        if waits is None:
            for r in svc.drain():
                out[r.id] = r
            continue
        nb = len(svc.dispatch_log)
        got = []
        n = host_waits(lambda: got.extend(svc.drain()))
        waits.append((n, len(svc.dispatch_log) - nb))
        for r in got:
            out[r.id] = r
    return out


def dispatched_rows(eng, svc, batch: int) -> dict:
    """``(user, item) -> (scores, related)`` of every key the service
    dispatched, from ``query_many`` over its dispatch order."""
    pts = np.concatenate([p for _, p in svc.dispatch_log])
    rows = {}
    for res in eng.query_many(pts, batch_queries=batch):
        for t, (u, i) in enumerate(res._test_points.tolist()):
            rows.setdefault((u, i), (res.scores_of(t).copy(),
                                     res.related_of(t)))
    return rows


def same_answer(r, want, what: str) -> None:
    check(r.scores.tobytes() == want[0].tobytes()
          and np.array_equal(r.related, want[1]),
          f"{what}: request {r.id} ({r.user}, {r.item}) not bitwise the "
          "engine's answer")


def serve_direct(family: str, eng, pts) -> tuple[dict, dict]:
    """10a: the direct service over a repeat-heavy stream."""
    reqs = serve_stream(pts)
    svc = InfluenceService(engine=eng, config=serve_config())
    t0 = time.perf_counter()
    warm = [svc.warmup(m) for m in drain_misses(reqs) if len(m)]
    warm_s = time.perf_counter() - t0
    check(all(w["all_planned_compiled"] for w in warm)
          and all(w["kernel_variant"] == "cuda" for w in warm),
          f"{family} 10a warmup: {warm}")
    reset_counts()
    builds0 = compilemon.count()
    waits = []
    t0 = time.perf_counter()
    out = serve_run(svc, reqs, waits)
    wall_s = time.perf_counter() - t0
    captures = compilemon.count() - builds0
    launches = launch_counts()
    check(captures == 0, f"{family} 10a: {captures} programs built after "
          "the warmup")
    check(launches[SOURCES[family]] > 0 and launches[SEGMENT_SOURCE] > 0,
          f"{family} 10a: kernels not launched: {launches}")
    check(all(n <= b for n, b in waits), f"{family} 10a: host waits "
          f"(waits, batches) by drain {waits}")
    resp = [out[r.id] for r in reqs]
    check(all(r.ok for r in resp), f"{family} 10a: "
          f"{sum(not r.ok for r in resp)} of {len(resp)} not ok")
    planned = [m for m in drain_misses(reqs) if len(m)]
    check([len(p) for _, p in svc.dispatch_log] == [len(m) for m in planned],
          f"{family} 10a: dispatches {[len(p) for _, p in svc.dispatch_log]}"
          f" != the warmed plan {[len(m) for m in planned]}")
    rows = dispatched_rows(eng, svc, SERVE_BATCH)
    filled = {}
    for r in resp:
        same_answer(r, rows[(r.user, r.item)], f"{family} 10a")
        if r.cache_tier == "compute":
            filled[(r.user, r.item)] = r
    for r in resp:
        if r.cache_tier == "hot":
            f = filled[(r.user, r.item)]
            check(r.scores.tobytes() == f.scores.tobytes()
                  and r.ihvp.tobytes() == f.ihvp.tobytes(),
                  f"{family} 10a: hot hit {r.id} differs from its compute")
    roll = svc.rollup()
    lat = np.asarray([r.queue_wait_s * 1e3 for r in resp])
    wall_ms_ = wall_s * 1e3
    # the same stream again through a fresh service (the engine holds
    # every geometry), under the profiler: the device's busy share
    dev = device_breakdown(
        lambda: serve_run(InfluenceService(engine=eng,
                                           config=serve_config()), reqs),
        wall_ms_)
    no_recovery(f"10a {family}")
    res = {
        "requests": len(resp), "ok": roll["ok"], "seconds": wall_s,
        "requests_per_s": len(resp) / wall_s,
        "latency_ms": {"p50": float(np.percentile(lat, 50)),
                       "p95": float(np.percentile(lat, 95)),
                       "p99": float(np.percentile(lat, 99))},
        "solve_ms": roll["solve_ms"], "hot_hit_share": roll["hot_hit_rate"],
        "tiers": roll["tiers"], "batches": len(svc.dispatch_log),
        "batch_sizes": [len(p) for _, p in svc.dispatch_log],
        "captures_after_warmup": captures, "warmup_s": warm_s,
        "warmup_builds": sum(w["builds"] for w in warm),
        "host_waits_by_drain": waits, "launches": launches,
        "device_busy_share": dev["busy_share"],
        "device_busy_ms": dev["device_busy_ms"],
    }
    log(f"{family} 10a direct service: {len(resp)} requests at "
        f"{res['requests_per_s']:.0f}/s; latency p50/p95/p99 "
        f"{res['latency_ms']['p50']:.1f}/{res['latency_ms']['p95']:.1f}/"
        f"{res['latency_ms']['p99']:.1f} ms; solve p50 "
        f"{roll['solve_ms']['p50']} ms; hot share {roll['hot_hit_rate']}; "
        f"busy share {dev['busy_share']:.2f}; batches "
        f"{res['batch_sizes']}; 0 captures after warmup; host waits "
        f"{waits}; every answer bitwise query_many; launches {launches}")
    return res, {"reqs": reqs, "out": out, "rows": rows, "svc": svc}


def brownout_service(pre, approx_ok: bool, misses) -> InfluenceService:
    """A precomputed service driven to bank_preferred by two drains whose
    dispatch sheds (a worker death at serve.dispatch each)."""
    svc = InfluenceService(engine=pre, config=serve_config(
        health=HealthConfig(approx_ok=approx_ok, **BROWNOUT_HEALTH)))
    with inject.active(
        inject.Fault(sites.SERVE_DISPATCH, at=0, kind=taxonomy.WORKER),
        inject.Fault(sites.SERVE_DISPATCH, at=1, kind=taxonomy.WORKER),
        strict=True, validate=True,
    ):
        for n, (u, i) in enumerate(misses[:2]):
            svc.submit(Request(int(u), int(i), id=f"degrade{n}"))
            svc.drain()
    check(svc.health.mode == "bank_preferred", f"brownout: mode "
          f"{svc.health.mode} after two shed drains")
    return svc


def serve_brownout(family: str, eng, train, pts, workdir: str) -> dict:
    """10b: bank hits and certified approximate misses under brownout."""
    pre = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                        model_name=f"smoke-{family}")
    n_bank = pre.ensure_factor_bank()
    check(n_bank >= BROWNOUT_N // 2, f"{family} 10b: bank of {n_bank}")
    half = BROWNOUT_N // 2
    banked = pre._bank.pairs[:half].astype(np.int64)
    bset = {tuple(p) for p in pre._bank.pairs.tolist()}
    pool = [p for p in pts.tolist() if tuple(p) not in bset]
    misses = np.asarray(pool[2: 2 + half], np.int64)
    mixed = np.empty((BROWNOUT_N, 2), np.int64)
    mixed[0::2], mixed[1::2] = banked, misses
    reqs = [Request(int(u), int(i), id=f"b{k}")
            for k, (u, i) in enumerate(mixed)]
    svc = brownout_service(pre, True, pool)
    reset_counts()
    builds0 = compilemon.count()
    t0 = time.perf_counter()
    for r in reqs:
        svc.submit(r)
    out = {r.id: r for r in svc.drain()}
    wall_s = time.perf_counter() - t0
    captures = compilemon.count() - builds0
    launches = launch_counts()
    for name in (SOURCES[family], CERT_SOURCE, EIGMIN_SOURCE):
        check(launches[name] > 0, f"{family} 10b never launched {name}")
    hits = [out[f"b{k}"] for k in range(0, BROWNOUT_N, 2)]
    apx = [out[f"b{k}"] for k in range(1, BROWNOUT_N, 2)]
    check(all(r.ok and r.cache_tier == "precomputed" and not r.approx
              for r in hits), f"{family} 10b: bank hits "
          f"{[(r.status, r.cache_tier) for r in hits[:4]]}")
    check(all(r.ok and r.approx and r.err_bound is not None for r in apx),
          f"{family} 10b: misses not answered approx with a bound")
    # bank hits bitwise the bank engine's query_batch on their batch
    for bid, bpts in svc.dispatch_log:
        keys = {tuple(p) for p in bpts.tolist()}
        if not keys <= bset:
            continue
        res = pre.query_batch(bpts)
        by_key = {tuple(p): t for t, p in enumerate(bpts.tolist())}
        for r in hits:
            t = by_key.get((r.user, r.item))
            if t is not None:
                check(r.scores.tobytes() == res.scores_of(t).tobytes(),
                      f"{family} 10b: bank hit {r.id} not bitwise "
                      "query_batch")
    # the certificate against the direct path
    direct = eng.query_batch(misses)
    inside = [float(np.max(np.abs(r.scores - direct.scores_of(t)),
                           initial=0.0)) <= r.err_bound + 1e-6
              for t, r in enumerate(apx)]
    share = float(np.mean(inside))
    check(share >= FIDELITY_SHARE, f"{family} 10b: |approx - direct| <= "
          f"err_bound + 1e-6 on {share:.4f} of misses")
    # approx serving off: the exact path's responses are the same bits
    off = brownout_service(pre, False, pool)
    for r in reqs:
        off.submit(Request(r.user, r.item, id=r.id))
    got_off = {r.id: r for r in off.drain()}
    for r in hits:
        o = got_off[r.id]
        check(o.ok and o.batch_id == r.batch_id
              and o.scores.tobytes() == r.scores.tobytes(),
              f"{family} 10b: exact answer {r.id} differs with approx off")
    check(all(not got_off[r.id].ok and got_off[r.id].reason == "degraded"
              for r in apx), f"{family} 10b: approx off must shed misses")
    # the host sampler beside the sampled program's device time
    sib = pre.approx_sibling()
    counts = sib.index.counts_batch(misses)
    s_pad = sib._s_pad_for(int(counts.sum()))
    sw = []
    for _ in range(3):
        t1 = time.perf_counter()
        sampled_mod.sample_weights(misses, counts, s_pad, sib.sampled_cap)
        sw.append((time.perf_counter() - t1) * 1e3)
    samp_ms = wall_ms(lambda: sib.query_batch(misses))
    dev = device_breakdown(lambda: sib.query_batch(misses), samp_ms)
    res = {"requests": len(reqs), "seconds": wall_s, "bank_entries": n_bank,
           "captures": captures, "launches": launches,
           "fidelity_share": share,
           "err_bound_median": float(np.median([r.err_bound for r in apx])),
           "sample_weights_ms": float(np.median(sw)),
           "sampled_wall_ms": samp_ms,
           "sampled_device_ms": dev["device_busy_ms"],
           "mode_transitions": len(svc.health.transitions)}
    log(f"{family} 10b brownout: {half} bank hits at tier precomputed "
        f"(bitwise query_batch), {half} misses approx (fidelity share "
        f"{share:.4f}, median bound {res['err_bound_median']:.3e}); exact "
        f"answers bitwise the approx-off run; {captures} captures in the "
        f"stream; sample_weights {res['sample_weights_ms']:.2f} ms on the "
        f"host beside the sampled program's {dev['device_busy_ms']:.2f} "
        f"device ms ({samp_ms:.2f} ms wall) at T={half}; launches "
        f"{launches}")
    return res


def serve_faults(family: str, eng, pts, direct: dict) -> dict:
    """10c: a host-side fault sheds exactly its batch; an engine fault
    with two batches in flight reroutes after a reset."""
    reqs, rows = direct["reqs"], direct["rows"]

    def faulted():
        svc = InfluenceService(engine=eng, config=serve_config())
        with inject.active(inject.Fault(sites.SERVE_DISPATCH, at=1,
                                        kind=taxonomy.WORKER),
                           strict=True, validate=True):
            out = serve_run(svc, reqs)
        return svc, out

    svc, out = faulted()
    shed = sorted(r.id for r in out.values() if not r.ok)
    batch1 = {tuple(p) for p in dict(svc.dispatch_log)[1].tolist()}
    want = sorted(r.id for r in reqs[SERVE_DRAIN: 2 * SERVE_DRAIN]
                  if r.key() in batch1)
    check(shed == want and all(out[i].reason == taxonomy.WORKER
                               for i in shed),
          f"{family} 10c: shed {len(shed)} requests, want batch 1's "
          f"{len(want)}")
    for r in out.values():
        if r.ok:
            same_answer(r, rows[(r.user, r.item)], f"{family} 10c host")
    check(sorted(r.id for r in faulted()[1].values() if not r.ok) == shed,
          f"{family} 10c: a replay shed another set")
    # a worker death at the engine's dispatch with a batch in flight
    q = pts[:ENGINE_FAULT_Q]
    before = engine_tensors(eng)
    svc = InfluenceService(engine=eng, config=serve_config(
        max_batch=ENGINE_FAULT_BATCH, dispatch_window=ENGINE_FAULT_WINDOW))
    with inject.active(inject.Fault(sites.ENGINE_DISPATCH_FLAT, at=2,
                                    kind=taxonomy.WORKER),
                       strict=True, validate=True) as inj:
        got = svc.run([Request(int(u), int(i), id=f"e{k}")
                       for k, (u, i) in enumerate(q)])
    resets = obs.REGISTRY.snapshot()["counters"].get(
        "engine.device_resets", 0.0)
    after = engine_tensors(eng)
    stale = set(before) & set(after)
    check(not stale, f"{family} 10c: {len(stale)} pre-reset tensors "
          "reachable from the engine")
    shed_e = [r for r in got if not r.ok]
    check(not shed_e, f"{family} 10c engine fault: {len(shed_e)} shed")
    rows_e = dispatched_rows(eng, svc, ENGINE_FAULT_BATCH)
    for r in got:
        same_answer(r, rows_e[(r.user, r.item)], f"{family} 10c engine")
        if (r.user, r.item) in rows:
            same_answer(r, rows[(r.user, r.item)], f"{family} 10c vs 10a")
    res = {"host_fault_shed": len(shed), "host_fault_batch": len(batch1),
           "replay_same": True, "engine_fault_shed": 0,
           "engine_fault_batches": len(svc.dispatch_log),
           "device_resets": resets,
           "uploads": inj.counts.get(sites.ENGINE_UPLOAD, 0),
           "pre_reset_tensors_reachable": 0}
    log(f"{family} 10c faults: serve.dispatch on batch 1 shed exactly its "
        f"{len(shed)} requests (reason {taxonomy.WORKER}), the rest bitwise "
        f"10a, a replay the same set; engine.dispatch_flat with two in "
        f"flight rerouted after {resets:.0f} reset(s), every answer "
        f"bitwise; no pre-reset tensor reachable")
    return res


def serve_entry_points(workdir: str) -> dict:
    """10d: the serving and factor drivers, in process on the card."""
    import contextlib
    import io

    from fia_tpu_torch.cli import factor as cli_factor
    from fia_tpu_torch.cli import serve as cli_serve

    base = ["--dataset", "synthetic", "--model", "MF",
            "--num_steps_train", "300", "--batch_size", "3000"]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_serve.main(base + [
            "--warmup", "64", "--smoke_requests", "512",
            "--train_dir", os.path.join(workdir, "serve")])
    serve_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"10d: cli.serve returned {rc}: {lines[-3:]}")
    smoke = next(json.loads(x) for x in lines if '"serve.smoke"' in x)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_factor.main(base + [
            "--bank_entries", "256", "--verify",
            "--train_dir", os.path.join(workdir, "factor")])
    factor_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"10d: cli.factor --verify returned {rc}: {lines[-3:]}")
    summary = json.loads(lines[-1])
    res = {"serve_rc": 0, "serve_s": serve_s, "serve_ok": smoke["ok"],
           "serve_hot_hit_rate": smoke["hot_hit_rate"],
           "factor_rc": 0, "factor_s": factor_s,
           "factor_entries": summary["entries"],
           "verify_spearman_worst": summary["verify"]["spearman_worst"]}
    log(f"10d entry points: cli.serve --warmup 64 --smoke_requests 512 "
        f"returned 0 ({smoke['ok']}/512 ok) in {serve_s:.1f} s; "
        f"cli.factor --verify returned 0 in {factor_s:.1f} s, worst "
        f"Spearman {res['verify_spearman_worst']:.6f}")
    return res


def drive_serving(engines, train, pts, workdir: str) -> dict:
    """Phase 10 (each model: 10a, 10b, 10c; 10d once)."""
    out = {}
    obs.REGISTRY.reset()  # phase 9's recoveries are its own
    for family, (eng, _) in engines.items():
        t0 = time.perf_counter()
        row = {}
        row["10a"], direct = serve_direct(family, eng, pts)
        row["10b"] = serve_brownout(family, eng, train, pts, workdir)
        no_recovery(f"10b {family}")
        row["10c"] = serve_faults(family, eng, pts, direct)
        obs.REGISTRY.reset()
        row["seconds"] = time.perf_counter() - t0
        out[family] = row
        del direct
        gc.collect()
        torch.cuda.empty_cache()
    out["10d"] = serve_entry_points(workdir)
    return out


# -- phase 11: streaming updates and the audit subsystem ---------------------
# 11a and 11b's removal run on a community graph of ML-1M's shape (USERS,
# ITEMS, ROWS; STREAM_GROUPS communities, no row crosses one): on phase
# 4's data the read reach of STREAM_NEW held-out pairs covers every user
# and item (printed as reach_phase4), so no block there lies outside an
# update's footprint and re-keying could not be seen. The updates land in
# community 0. 11b's sweep runs on phase 4's data from 7b's weights.
STREAM_GROUPS = 40
STREAM_NEW, STREAM_STEPS, STREAM_CKPT = 256, 400, 200
STREAM_PROBES = 8  # probes inside the footprint, and as many outside
STREAM_BANK = 64
STREAM_CYCLES = 3  # updates in a row for the memory bound
STREAM_CONFIG = dict(max_batch=1024, dispatch_window=2)
SWEEP_K, SWEEP_BATCH = 64, 256
SWEEP_ALT = ({"chunk_points": 100, "batch_queries": 64}, {"segment": 4096})
PLAN_ROWS, REWEIGHT_W, APPLY_STEPS = 16, 0.5, 100
AUDIT_GROUP_POINTS = 64  # 11b's removal: community-0 held-out test points
# 11c: verify on phase 4's small input (card against the CPU at 7a's
# bar), then at ML-1M shape at reduced depth
VERIFY_SMALL = dict(num_steps=150, batch_size=200, learning_rate=1e-3,
                    retrain_times=2, max_rows=4, seed=0)
VERIFY_FULL = dict(num_steps=300, batch_size=FULL_BATCH, learning_rate=1e-3,
                   retrain_times=2, max_rows=4, seed=0)
VERIFY_CONTROLS = 4
# 11d: scripts/unlearn_smoke.sh's arguments, on the card
UNLEARN_SMOKE = [
    "--dataset", "synthetic", "--synth_users", "60", "--synth_items", "40",
    "--synth_train", "2000", "--synth_test", "40", "--split_seed", "3",
    "--seed", "0", "--model", "MF", "--embed_size", "4",
    "--weight_decay", "1e-3", "--damping", "1e-3", "--lr", "1e-2",
    "--batch_size", "200", "--num_steps_train", "300", "--solver", "direct",
    "--corrupt_rows", "40", "--topk", "16", "--plan_rows", "4",
    "--controls", "4", "--verify", "1", "--verify_steps", "150",
    "--retrain_times", "2", "--apply", "1", "--apply_steps", "40",
    "--force_apply",
]
DEBUG_DATA_KEYS = {
    "model_key", "sweep_id", "rows_scored", "rows_per_s", "plan_id",
    "plan_action", "plan_rows", "predicted_delta", "planted_hit_rate",
    "plan_path", "gate_passed", "sign_agreement", "spearman",
    "verify_artifact", "apply_status", "apply_seconds",
}
FAMILY_NAMES = {"mf": "MF", "ncf": "NCF"}


def group_bounds(g: int) -> tuple[int, int, int, int]:
    """Community g's user range [u0, u1) and item range [i0, i1)."""
    return (g * USERS // STREAM_GROUPS, (g + 1) * USERS // STREAM_GROUPS,
            g * ITEMS // STREAM_GROUPS, (g + 1) * ITEMS // STREAM_GROUPS)


def community_ratings(seed: int = 0) -> RatingDataset:
    """ROWS ratings in 1..5 over USERS x ITEMS, each row inside one of
    STREAM_GROUPS communities drawn uniformly, its user and item uniform
    within the community's ranges."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, STREAM_GROUPS, ROWS)
    b = np.asarray([group_bounds(k) for k in range(STREAM_GROUPS + 1)])
    u = b[g, 0] + (rng.random(ROWS) * (b[g, 1] - b[g, 0])).astype(np.int64)
    i = b[g, 2] + (rng.random(ROWS) * (b[g, 3] - b[g, 2])).astype(np.int64)
    y = rng.integers(1, 6, ROWS).astype(np.float32)
    return RatingDataset(np.stack([u, i], axis=1).astype(np.int32), y)


def group_heldout(train_x, groups, n: int, seed: int) -> np.ndarray:
    """n distinct (u, i) pairs absent from ``train_x``, the k-th inside
    community ``groups[k % len(groups)]``."""
    rng = np.random.default_rng(seed)
    have = set((np.asarray(train_x[:, 0], np.int64) * ITEMS
                + train_x[:, 1]).tolist())
    out = []
    for _ in range(1000 * n):
        if len(out) == n:
            break
        u0, u1, i0, i1 = group_bounds(groups[len(out) % len(groups)])
        u, i = int(rng.integers(u0, u1)), int(rng.integers(i0, i1))
        if u * ITEMS + i not in have:
            have.add(u * ITEMS + i)
            out.append((u, i))
    check(len(out) == n, f"only {len(out)} of {n} held-out pairs found in "
          f"communities {list(groups)}")
    return np.asarray(out, np.int64)


def stream_model(family: str, train, workdir: str, name: str,
                 state: TrainState | None = None) -> FIAModel:
    """An ML-1M-shape FIAModel on the card: seeded weights, or ``state``."""
    m = FIAModel(FAMILY_NAMES[family], USERS, ITEMS, K_EMB, WD,
                 batch_size=FULL_BATCH, data_sets={"train": train},
                 initial_learning_rate=TRAIN_LR, damping=DAMPING,
                 train_dir=workdir, model_name=name, solver="direct",
                 seed=0, device=CARD)
    if state is not None:
        m.state = state
    return m


def host_params(m) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in m.state.params.items()}


def same_params(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def outside_moved_bitwise(m, before: dict, fp) -> bool:
    """Every user- or item-keyed row outside the moved masks, and every
    global leaf, has its pre-update bytes."""
    after = host_params(m)
    for k, old in before.items():
        new = after[k]
        if old.ndim and old.shape[0] == USERS:
            new, old = new[~fp.user_touched], old[~fp.user_touched]
        elif old.ndim and old.shape[0] == ITEMS:
            new, old = new[~fp.item_touched], old[~fp.item_touched]
        if new.tobytes() != old.tobytes():
            return False
    return True


def serve_pairs(svc, pairs, tag: str, drain: bool = True) -> dict:
    """Submit one request a pair; with ``drain``, drain and return
    ``(u, i) -> Response``, each ok."""
    for n, (u, i) in enumerate(np.asarray(pairs).tolist()):
        rej = svc.submit(Request(int(u), int(i), id=f"{tag}-{n}"))
        check(rej is None, f"{tag}: request ({u}, {i}) rejected: {rej}")
    if not drain:
        return {}
    out = {(r.user, r.item): r for r in svc.drain()}
    check(all(r.ok for r in out.values()), f"{tag}: "
          f"{[(r.id, r.status, r.reason) for r in out.values() if not r.ok]}")
    return out


def rows_of(eng, pairs) -> dict:
    """``(u, i) -> (scores, related)`` of ``eng.query_batch(pairs)``."""
    res = eng.query_batch(np.asarray(pairs))
    return {(int(u), int(i)): (res.scores_of(t).copy(), res.related_of(t))
            for t, (u, i) in enumerate(np.asarray(pairs).tolist())}


def publish_bank(m) -> int:
    """The model's factor bank of its STREAM_BANK hottest pairs."""
    eng = m.engine()
    pairs = fbank.select_hot_pairs(eng.index, STREAM_BANK)
    bank = fbank.build_bank(eng, pairs, batch_queries=512)
    fbank.publish_bank(bank, eng.factor_bank_path(), fbank.bank_fingerprint(
        m.model_name, m.model.block_size, DAMPING, *eng._train_host))
    return len(bank)


def events(path: str, name: str) -> list:
    with open(path) as f:
        return [e for e in map(json.loads, f) if e.get("event") == name]


def settled_allocated() -> int:
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def keeps_serving(family: str, svc, eng, probes, pre: dict, misses,
                  what: str) -> None:
    """After a rollback: the probes answer their pre-update bytes, and new
    keys compute bitwise the old engine's ``query_batch``."""
    got = serve_pairs(svc, np.concatenate([probes, misses]), what)
    for key, r in pre.items():
        check(got[key].scores.tobytes() == r.scores.tobytes(),
              f"{family} {what}: probe {key} changed after the rollback")
    want = rows_of(eng, misses)
    for key, w in want.items():
        same_answer(got[key], w, f"{family} {what}")


def stream_update(family: str, workdir: str, reach: dict) -> tuple:
    """11a: a streaming update under live serving on the community graph;
    returns the report and (model, service, probes, their footprint
    sides) for 11b's removal."""
    train = community_ratings()
    m = stream_model(family, train, os.path.join(workdir, family),
                     f"stream-{family}")
    eng0 = m.engine()
    bank_n = publish_bank(m)
    mpath = os.path.join(workdir, f"{family}-serve.jsonl")
    svc = m.serve(config=ServeConfig(metrics_path=mpath, **STREAM_CONFIG))
    pool = group_heldout(train.x, [0], (1 + STREAM_CYCLES) * STREAM_NEW
                         + 4 * STREAM_PROBES, seed=29)
    rng = np.random.default_rng(31)
    updates = [(pool[k * STREAM_NEW:(k + 1) * STREAM_NEW].astype(np.int32),
                rng.integers(1, 6, STREAM_NEW).astype(np.float32))
               for k in range(1 + STREAM_CYCLES)]
    nx, ny = updates[0]
    fp = compute_footprint(train.x, nx, USERS, ITEMS)
    u1, i1 = group_bounds(0)[1], group_bounds(0)[3]
    check(not fp.user_read[u1:].any() and not fp.item_read[i1:].any(),
          f"{family} 11a: the footprint leaves community 0")
    spare = pool[(1 + STREAM_CYCLES) * STREAM_NEW:]
    inside = np.asarray([p for p in spare if fp.touched(*p)][:STREAM_PROBES])
    outside = group_heldout(train.x, list(range(1, 1 + STREAM_PROBES)),
                            STREAM_PROBES, seed=37)
    check(len(inside) == STREAM_PROBES
          and not any(fp.touched(*p) for p in outside),
          f"{family} 11a: probes inside {len(inside)}, outside touched")
    probes = np.concatenate([inside, outside])
    misses = group_heldout(train.x, list(range(9, 9 + STREAM_PROBES)),
                           2 * STREAM_PROBES, seed=41)
    pre = serve_pairs(svc, probes, "pre")
    base, base_state = host_params(m), m.state

    # the kill: an OOM in the fine-tune's second epoch dispatch, after the
    # first dispatch's checkpoint; then a fault at the swap (the retry
    # resumes from that checkpoint, fine-tunes the rest and fails there)
    with inject.active(inject.Fault(sites.TRAINER_EPOCH, at=1,
                                    kind=taxonomy.OOM)):
        killed = m.apply_updates(nx, ny, steps=STREAM_STEPS,
                                 checkpoint_every=STREAM_CKPT)
    check(killed.status == "rolled_back" and killed.reason == taxonomy.OOM
          and same_params(host_params(m), base)
          and m.data_sets["train"] is train and svc.epoch == 0,
          f"{family} 11a: the killed update did not roll back: {killed}")
    ckpt_dir = os.path.join(m.train_dir, "stream", f"upd-{killed.update_id}")
    check(bool(checkpoint.generations(ckpt_dir)),
          f"{family} 11a: the killed update left no checkpoint")
    keeps_serving(family, svc, eng0, probes, pre, misses[:STREAM_PROBES],
                  "11a after the kill")
    with inject.active(inject.Fault(sites.STREAM_SWAP, at=0,
                                    kind=taxonomy.PREEMPTION)):
        swapped = m.apply_updates(nx, ny, steps=STREAM_STEPS,
                                  checkpoint_every=STREAM_CKPT)
    check(swapped.status == "rolled_back"
          and swapped.reason == taxonomy.PREEMPTION
          and swapped.resumed_step is not None
          and same_params(host_params(m), base)
          and m.data_sets["train"] is train and svc.epoch == 0,
          f"{family} 11a: the swap fault did not roll back: {swapped}")
    keeps_serving(family, svc, eng0, probes, pre,
                  misses[STREAM_PROBES:2 * STREAM_PROBES],
                  "11a after the swap fault")
    injected = recovery_counts()
    obs.REGISTRY.reset()

    # the uninterrupted update, on a twin with no service
    twin = stream_model(family, train, os.path.join(workdir, f"{family}-twin"),
                        f"stream-{family}", state=base_state)
    clean = twin.apply_updates(nx, ny, steps=STREAM_STEPS,
                               checkpoint_every=STREAM_CKPT)
    check(clean.committed, f"{family} 11a: the uninterrupted update: {clean}")
    clean_params = host_params(twin)
    del twin
    gc.collect()

    # the retry commits with requests in flight across the swap
    serve_pairs(svc, probes, "inflight", drain=False)
    old_rows = rows_of(eng0, probes)
    stats0 = dict(vars(svc.cache.stats))
    res = m.apply_updates(nx, ny, steps=STREAM_STEPS,
                          checkpoint_every=STREAM_CKPT)
    check(res.committed and res.update_id == killed.update_id
          and res.resumed_step is not None
          and res.resumed_step > res.base_step and svc.epoch == 1,
          f"{family} 11a: the retry did not commit resumed: {res}")
    check(same_params(host_params(m), clean_params),
          f"{family} 11a: the resumed update is not bitwise the "
          "uninterrupted one")
    check(outside_moved_bitwise(m, base, res.footprint),
          f"{family} 11a: a row outside the moved masks or a global leaf "
          "moved")
    check(not os.path.isdir(ckpt_dir), f"{family} 11a: checkpoints kept")
    inflight = {(r.user, r.item): r for r in svc.drain()}
    for key, w in old_rows.items():
        same_answer(inflight[key], w, f"{family} 11a in flight across the "
                    "swap (the old engine's answer)")
    del eng0, old_rows
    # the warmed pair first, alone: nothing is built for it
    reset_counts()
    builds0 = compilemon.count()
    serve_pairs(svc, nx[:1], "warmed")
    warmed_builds = compilemon.count() - builds0
    check(warmed_builds == 0, f"{family} 11a: the warmed pair's first "
          f"request built {warmed_builds} programs")
    post = serve_pairs(svc, probes, "post")
    launches = launch_counts()
    check(launches[SOURCES[family]] > 0 and launches[SEGMENT_SOURCE] > 0,
          f"{family} 11a: kernels not launched after the swap: {launches}")
    fresh = serve_pairs(InfluenceService(
        engine=m.engine(), config=ServeConfig(disk_cache=False,
                                              **STREAM_CONFIG)),
        probes, "fresh")
    stale = sum(post[k].scores.tobytes() != fresh[k].scores.tobytes()
                or not np.array_equal(post[k].related, fresh[k].related)
                for k in fresh)
    check(stale == 0, f"{family} 11a: {stale} stale probes after the swap")
    for p in outside.tolist():
        k = tuple(p)
        check(post[k].cache_tier == "hot"
              and post[k].scores.tobytes() == pre[k].scores.tobytes(),
              f"{family} 11a: untouched probe {k} not re-keyed "
              f"(tier {post[k].cache_tier})")
    for p in inside.tolist():
        k = tuple(p)
        check(post[k].cache_tier == "compute",
              f"{family} 11a: touched probe {k} served from "
              f"{post[k].cache_tier}")
    st = vars(svc.cache.stats)
    swap = {"hot_rekeyed": st["rekeyed"] - stats0["rekeyed"],
            "hot_dropped": st["rekey_dropped"] - stats0["rekey_dropped"],
            "disk_rekeyed": st["disk_rekeyed"] - stats0["disk_rekeyed"],
            "disk_dropped": (st["disk_rekey_dropped"]
                             - stats0["disk_rekey_dropped"])}
    check(swap["hot_rekeyed"] >= STREAM_PROBES
          and swap["hot_dropped"] >= STREAM_PROBES,
          f"{family} 11a: re-key accounting {swap}")
    refresh = events(mpath, "factor.refresh")
    check(bool(refresh), f"{family} 11a: the factor bank was not refreshed")
    bank = {"entries": bank_n, "kept": refresh[-1]["kept"],
            "dropped": refresh[-1]["dropped"]}
    check(bank["kept"] > 0 and bank["kept"] + bank["dropped"] == bank_n,
          f"{family} 11a: bank refresh {bank}")
    no_recovery(f"11a {family}")

    # three more updates in a row, draining between them: fenced engines
    # and their graphs are released once their epoch drains
    a0 = settled_allocated()
    extra = engine(m.model, m.state.params, m.data_sets["train"],
                   damping=DAMPING, device=CARD)
    for pts_ in (nx[:1], inside, probes):
        extra.query_batch(pts_)
    one_engine = settled_allocated() - a0
    del extra
    allocated, cycles = [], []
    for k in range(1, 1 + STREAM_CYCLES):
        serve_pairs(svc, probes, f"cycle{k}", drain=False)
        r = m.apply_updates(*updates[k], steps=STREAM_STEPS,
                            checkpoint_every=STREAM_CKPT)
        check(r.committed, f"{family} 11a: update {k + 1}: {r}")
        svc.drain()
        serve_pairs(svc, probes, f"cycle{k}-post")
        allocated.append(settled_allocated())
        cycles.append({"seconds": r.seconds, "staleness_ms":
                       r.staleness_s * 1e3})
    check(allocated[-1] <= allocated[0] + one_engine,
          f"{family} 11a: device memory grew across updates: "
          f"{[a >> 20 for a in allocated]} MiB, one engine "
          f"{one_engine >> 20} MiB")
    no_recovery(f"11a {family} cycles")
    out = {
        "update_s": res.seconds, "staleness_ms": res.staleness_s * 1e3,
        "clean_update_s": clean.seconds, "steps": STREAM_STEPS,
        "base_step": res.base_step, "resumed_step": res.resumed_step,
        "killed_s": killed.seconds, "swap_fault_s": swapped.seconds,
        "touched_users": res.touched_users,
        "touched_items": res.touched_items, "swap": swap, "bank": bank,
        "stale_probes": stale, "warmed_builds": warmed_builds,
        "launches": launches, "injected_counts": injected,
        "memory_mib": {"after_drain": [a / 2**20 for a in allocated],
                       "one_engine": one_engine / 2**20},
        "cycles": cycles, "reach_phase4": reach,
    }
    log(f"{family} 11a streaming update: {out['update_s']:.2f} s "
        f"({STREAM_STEPS} steps resumed from {res.resumed_step}; "
        f"uninterrupted {clean.seconds:.2f} s), staleness "
        f"{out['staleness_ms']:.1f} ms, touched {res.touched_users} users / "
        f"{res.touched_items} items; hot re-keyed {swap['hot_rekeyed']} "
        f"dropped {swap['hot_dropped']}, disk re-keyed "
        f"{swap['disk_rekeyed']} dropped {swap['disk_dropped']}; bank kept "
        f"{bank['kept']} dropped {bank['dropped']} of {bank_n}; 0 stale "
        f"probes; kill -> resume bitwise; both rollbacks served bitwise; "
        f"memory after each drain "
        f"{[round(a / 2**20) for a in allocated]} MiB (one engine "
        f"{one_engine / 2**20:.0f} MiB)")
    return out, (m, svc, probes, inside, outside)


def tied_accumulator(n: int) -> np.ndarray:
    """Exact zeros everywhere, and runs of equal negative values across
    the 4096- and 65536-wide segments' edges."""
    acc = np.zeros(n, np.float32)
    for edge in range(4096, n, 4096):
        acc[edge - 3: edge + 3] = -1.0 if edge % 65536 else -2.0
    return acc


def selection_holds(acc, k: int, segment: int, what: str) -> None:
    """The card's segmented selection is exactly the plain numpy one under
    the (value, row id) order."""
    ids, vals = audit_reverse._segmented_topk_negative(acc, k, segment,
                                                       device=CARD)
    order = np.lexsort((np.arange(len(acc)), acc))[:k]
    check(np.array_equal(ids, order)
          and vals.tobytes() == acc[order].tobytes(),
          f"{what}: the card's selection is not the (value, id) order")


def audit_sweep(family: str, state, train, pts, workdir: str) -> dict:
    """11b: the reverse sweep on phase 4's data from 7b's weights."""
    a = stream_model(family, train, os.path.join(workdir, f"{family}-audit"),
                     f"audit-{family}", state=state)
    ty = np.random.default_rng(43).integers(1, 6, len(pts)).astype(np.float32)
    # every geometry of the stream built first, outside the sweep's time
    a.engine().query_many(pts, batch_queries=SWEEP_BATCH)
    reset_counts()
    sweep = reverse_topk(a, pts, ty, k=SWEEP_K, batch_queries=SWEEP_BATCH)
    launches = launch_counts()
    check(launches[SOURCES[family]] > 0 and launches[SEGMENT_SOURCE] > 0,
          f"{family} 11b: kernels not launched by the sweep: {launches}")
    key = (sweep.row_ids.tobytes(), sweep.loss_deltas.tobytes(),
           sweep.group_scores.tobytes())
    for kw in SWEEP_ALT:
        r = reverse_topk(a, pts, ty, k=SWEEP_K,
                         **{"batch_queries": SWEEP_BATCH, **kw})
        check((r.row_ids.tobytes(), r.loss_deltas.tobytes(),
               r.group_scores.tobytes()) == key,
              f"{family} 11b: the sweep differs under {kw}")
    selection_holds(sweep.group_scores, SWEEP_K, audit_reverse.SEGMENT,
                    f"{family} 11b sweep")
    for seg in (audit_reverse.SEGMENT, 4096):
        selection_holds(tied_accumulator(len(train.x)), 5000, seg,
                        f"{family} 11b tied accumulator, segment {seg}")
    plan = build_plan(a, sweep, action="remove", max_rows=PLAN_ROWS)
    back = load_plan(save_plan(plan, os.path.join(workdir,
                                                  f"{family}-plan.npz")))
    check(back.plan_id == plan.plan_id
          and back.row_ids.tobytes() == plan.row_ids.tobytes()
          and back.per_row_delta.tobytes() == plan.per_row_delta.tobytes(),
          f"{family} 11b: the plan did not round-trip")
    no_recovery(f"11b {family} sweep")
    out = {"rows_scored": sweep.rows_scored, "seconds": sweep.seconds,
           "rows_per_s": sweep.rows_per_s, "launches": launches,
           "negative_rows": int((sweep.group_scores < 0).sum()),
           "plan_rows": plan.rows, "plan_predicted": plan.predicted_delta}
    log(f"{family} 11b sweep: {len(pts)} test points, {sweep.rows_scored} "
        f"row-scores in {sweep.seconds:.3f} s ({sweep.rows_per_s:,.0f} "
        f"rows audited/s); bitwise under {list(SWEEP_ALT)}; selection = "
        f"(value, id) order, tied accumulator too; launches {launches}")
    return out, (a, sweep, ty)


def audit_apply(family: str, stream, workdir: str) -> dict:
    """11b: a reweight and then a removal plan under 11a's service, both
    from one sweep over community 0's held-out pairs (a reweight keeps
    the train rows, so the removal plan stays fresh); the reweight
    through ``FIAModel.apply_removal``, the removal through
    ``apply_plan``."""
    m, svc, probes, inside, outside = stream
    train = m.data_sets["train"]
    tp = group_heldout(train.x, [0], AUDIT_GROUP_POINTS, seed=47)
    ty = np.random.default_rng(53).integers(
        1, 6, len(tp)).astype(np.float32)
    sweep = reverse_topk(m, tp, ty, k=SWEEP_K, batch_queries=SWEEP_BATCH)
    out = {}
    for action in ("reweight", "remove"):
        pre = serve_pairs(svc, probes, f"{action}-pre")
        plan = build_plan(m, sweep, action=action, max_rows=PLAN_ROWS,
                          reweight=REWEIGHT_W)
        plan = load_plan(save_plan(plan, os.path.join(
            workdir, f"{family}-{action}-plan.npz")))
        fp = compute_footprint(train.x, train.x[plan.row_ids], USERS, ITEMS)
        check(not any(fp.touched(*p) for p in outside),
              f"{family} 11b {action}: the plan reaches the outside probes")
        stats0 = dict(vars(svc.cache.stats))
        n0 = len(train.x)
        res = (apply_plan(m, plan, steps=APPLY_STEPS) if action == "remove"
               else m.apply_removal(plan.row_ids, steps=APPLY_STEPS,
                                    reweight=plan.reweight))
        check(res.committed, f"{family} 11b {action}: {res}")
        train = m.data_sets["train"]
        check(len(train.x) == n0 - (plan.rows if action == "remove" else 0),
              f"{family} 11b {action}: train rows {n0} -> {len(train.x)}")
        post = serve_pairs(svc, probes, f"{action}-post")
        fresh = serve_pairs(InfluenceService(
            engine=m.engine(), config=ServeConfig(disk_cache=False,
                                                  **STREAM_CONFIG)),
            probes, f"{action}-fresh")
        stale = sum(post[k].scores.tobytes() != fresh[k].scores.tobytes()
                    for k in fresh)
        check(stale == 0, f"{family} 11b {action}: {stale} stale probes")
        for p in outside.tolist():
            k = tuple(p)
            check(post[k].cache_tier == "hot"
                  and post[k].scores.tobytes() == pre[k].scores.tobytes(),
                  f"{family} 11b {action}: untouched probe {k} not re-keyed")
        st = vars(svc.cache.stats)
        out[action] = {
            "deletion_s": res.seconds, "staleness_ms": res.staleness_s * 1e3,
            "rows": plan.rows, "touched_users": res.touched_users,
            "touched_items": res.touched_items, "stale_probes": stale,
            "hot_rekeyed": st["rekeyed"] - stats0["rekeyed"],
            "hot_dropped": st["rekey_dropped"] - stats0["rekey_dropped"],
            "sweep_rows_per_s": sweep.rows_per_s}
        log(f"{family} 11b {action} plan ({plan.rows} rows, predicted "
            f"{plan.predicted_delta:+.4f}): committed in {res.seconds:.2f} s, "
            f"staleness {res.staleness_s * 1e3:.1f} ms, 0 stale probes, "
            f"hot re-keyed {out[action]['hot_rekeyed']} dropped "
            f"{out[action]['hot_dropped']}")
    no_recovery(f"11b {family} apply")
    return out


def verify_small() -> dict:
    """11c: ``verify_plan``'s lanes on the card against the same call on
    the CPU (phase 4's small input, 7a's bar), and a journaled rerun."""
    tiny = synthetic_splits(60, 40, 2000, 50, seed=3)
    kw = dict(model="MF", num_users=60, num_items=40, embedding_size=8,
              weight_decay=1e-3, batch_size=200,
              data_sets={"train": tiny["train"]},
              initial_learning_rate=1e-2, damping=1e-3, train_dir="",
              model_name="verify-small")
    card = FIAModel(**kw, device=CARD)
    card.train(300, save_checkpoints=False, verbose=False)
    cpu = FIAModel(**kw, device="cpu")
    cpu.state = TrainState({k: v.cpu() for k, v in card.state.params.items()},
                           cpu.state.opt_state, int(card.state.step))
    tp = np.asarray(tiny["test"].x, np.int64)
    ty = np.asarray(tiny["test"].y, np.float32)
    sweep = reverse_topk(card, tp, ty, k=16)
    plan = build_plan(card, sweep, action="remove",
                      max_rows=VERIFY_SMALL["max_rows"])
    controls = np.argsort(-sweep.group_scores.astype(np.float64),
                          kind="stable")[:VERIFY_CONTROLS].astype(np.int64)
    deltas = sweep.group_scores[controls].astype(np.float64)
    runs, lanes = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for side, m in (("card", card), ("cpu", cpu)):
            path = os.path.join(d, f"{side}.jsonl")
            fp = audit_verify.verify_fingerprint(
                m, plan, tp, control_rows=controls, **VERIFY_SMALL)
            with Journal.open(path, fp, fsync=False) as j:
                runs[side] = verify_plan(m, plan, tp, ty, journal=j,
                                         control_rows=controls,
                                         control_deltas=deltas,
                                         **VERIFY_SMALL)
            with Journal.open(path, fp, resume=True, fsync=False) as j:
                lanes[side] = np.asarray(j.get("lanes:0"), np.float32)
        err = close(torch.as_tensor(lanes["card"]),
                    torch.as_tensor(lanes["cpu"]), TRAIN_RTOL, TRAIN_ATOL,
                    "11c verify lanes, card vs CPU")
        check(runs["card"].predicted.tobytes()
              == runs["cpu"].predicted.tobytes(),
              "11c: predicted deltas differ card vs CPU")
        path = os.path.join(d, "card.jsonl")
        size = os.path.getsize(path)
        fp = audit_verify.verify_fingerprint(
            card, plan, tp, control_rows=controls, **VERIFY_SMALL)
        with Journal.open(path, fp, resume=True, fsync=False) as j:
            again = verify_plan(card, plan, tp, ty, journal=j,
                                control_rows=controls, control_deltas=deltas,
                                **VERIFY_SMALL)
        check(again.actual.tobytes() == runs["card"].actual.tobytes()
              and os.path.getsize(path) == size,
              "11c: the journaled rerun is not bitwise or appended")
    out = {"lanes": int(lanes["card"].shape[0]), "max_abs_err": err,
           "sign_agreement": runs["card"].sign_agreement,
           "spearman": runs["card"].spearman}
    log(f"11c verify, small input: {out['lanes']} lanes card vs CPU within "
        f"{err:.3g} (rtol {TRAIN_RTOL:g}, atol {TRAIN_ATOL:g}); journaled "
        "rerun bitwise, nothing appended")
    return out


def verify_full(audit) -> dict:
    """11c: ``verify_plan`` at ML-1M shape at reduced depth, from 11b's
    sweep (MF)."""
    a, sweep, ty = audit
    plan = build_plan(a, sweep, action="remove",
                      max_rows=VERIFY_FULL["max_rows"])
    controls = np.argsort(-sweep.group_scores.astype(np.float64),
                          kind="stable")[:VERIFY_CONTROLS].astype(np.int64)
    t0 = time.perf_counter()
    res = verify_plan(a, plan, sweep.test_points, ty, control_rows=controls,
                      control_deltas=sweep.group_scores[controls].astype(
                          np.float64), **VERIFY_FULL)
    seconds = time.perf_counter() - t0
    check(bool(np.isfinite(res.actual).all()),
          f"11c verify at ML-1M shape: non-finite actual {res.actual}")
    lanes = (len(res.row_ids) + 1) * VERIFY_FULL["retrain_times"]
    out = {"seconds": seconds, "lanes": lanes,
           "steps": VERIFY_FULL["num_steps"],
           "sign_agreement": res.sign_agreement, "spearman": res.spearman,
           "predicted": res.predicted.tolist(), "actual": res.actual.tolist()}
    log(f"11c verify at ML-1M shape: {lanes} lanes x "
        f"{VERIFY_FULL['num_steps']} steps in {seconds:.1f} s; sign "
        f"agreement {res.sign_agreement:.3f}, Spearman {res.spearman:.3f} "
        "(printed, not gated)")
    return out


def debug_data_driver(workdir: str) -> dict:
    """11d: ``cli.debug_data`` in process on the card with
    ``scripts/unlearn_smoke.sh``'s arguments."""
    import contextlib
    import io

    from fia_tpu_torch.cli import debug_data

    out_json = os.path.join(workdir, "unlearn.json")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        debug_data.main(UNLEARN_SMOKE + [
            "--train_dir", os.path.join(workdir, "debug_data"),
            "--json_out", out_json])
    seconds = time.perf_counter() - t0
    with open(out_json) as f:
        s = json.load(f)
    check(set(s) == DEBUG_DATA_KEYS and s["apply_status"] == "committed"
          and s["rows_scored"] > 0 and s["predicted_delta"] < 0
          and math.isfinite(s["sign_agreement"])
          and math.isfinite(s["spearman"]),
          f"11d: cli.debug_data summary {s}")
    out = {"rc": 0, "seconds": seconds, "rows_per_s": s["rows_per_s"],
           "sign_agreement": s["sign_agreement"], "spearman": s["spearman"],
           "gate_passed": s["gate_passed"],
           "planted_hit_rate": s["planted_hit_rate"]}
    log(f"11d cli.debug_data returned 0 in {seconds:.1f} s: gate sign "
        f"agreement {s['sign_agreement']:.3f}, Spearman "
        f"{s['spearman']:.3f} (passed {s['gate_passed']}), planted hit rate "
        f"{s['planted_hit_rate']:.2f}, apply committed")
    return out


def phase4_reach(train) -> dict:
    """How far STREAM_NEW held-out pairs reach on phase 4's data."""
    nx = sample_heldout_pairs(train.x, USERS, ITEMS, STREAM_NEW, seed=23)
    fp = compute_footprint(train.x, nx, USERS, ITEMS)
    one = compute_footprint(train.x, nx[:1], USERS, ITEMS)
    return {"read_users": int(fp.user_read.sum()),
            "read_items": int(fp.item_read.sum()),
            "one_pair_read_users": int(one.user_read.sum()),
            "one_pair_read_items": int(one.item_read.sum())}


def drive_stream_audit(states, train, pts, workdir: str) -> tuple:
    """Phase 11 (11a, 11b per model; 11c, 11d once): the ``stream`` and
    ``audit`` sections of the ``perf`` line."""
    stream, audit = {}, {}
    obs.REGISTRY.reset()
    reach = phase4_reach(train)
    log(f"11: on phase 4's data {STREAM_NEW} held-out pairs read-reach "
        f"{reach['read_users']}/{USERS} users, {reach['read_items']}/"
        f"{ITEMS} items (one pair: {reach['one_pair_read_users']} / "
        f"{reach['one_pair_read_items']}); 11a runs on "
        f"{STREAM_GROUPS} communities of the same shape")
    kept = None
    for family in ("mf", "ncf"):
        t0 = time.perf_counter()
        stream[family], served = stream_update(family, workdir, reach)
        stream[family]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row = audit[family] = {}
        row["sweep"], swept = audit_sweep(family, states[family], train,
                                          pts, workdir)
        row["apply"] = audit_apply(family, served, workdir)
        row["seconds"] = time.perf_counter() - t0
        log(f"{family} 11a: {stream[family]['seconds']:.1f} s; 11b: "
            f"{row['seconds']:.1f} s")
        kept = swept if family == "mf" else kept
        del served, swept
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    audit["verify"] = {"small": verify_small(), "full": verify_full(kept)}
    audit["verify"]["seconds"] = time.perf_counter() - t0
    del kept
    t0 = time.perf_counter()
    audit["debug_data"] = debug_data_driver(workdir)
    audit["debug_data"]["seconds"] = time.perf_counter() - t0
    log(f"11c: {audit['verify']['seconds']:.1f} s; 11d: "
        f"{audit['debug_data']['seconds']:.1f} s")
    no_recovery("11c-11d")
    return stream, audit

# -- phase 12: the data-axis device mesh ----------------------------------
# 12a: meshes of MESH_SIZES virtual slots over cuda:0 (and a 2-slot mesh of
# the real devices when two or more are visible): query_batch at BATCHES,
# query_many at MESH_MANY_BATCH a batch (ragged) and a batch of MESH_BANK_T
# of 8d's banked pairs, each bitwise the single-device engine; 12b: a
# MESH_SERVE_SLOTS-slot service over phase 10's stream cut to MESH_SERVE_N
# requests at MESH_SERVE_BATCH a batch, a device loss injected at batch 1;
# 12c: Trainer.fit on a 2-slot mesh for MESH_FIT_STEPS steps at FULL_BATCH,
# loo_retrain_many with MESH_LANES lanes on a MESH_LANE_SLOTS-slot mesh, the
# full engine's HVP on a 2-slot mesh, reverse_topk over MESH_SWEEP_T queries
# over MESH_SIZES slots; 12d: cli.rq2 and cli.serve with --mesh 2.
MESH_SIZES = (1, 2, 4)
MESH_MANY_BATCH, MESH_BANK_T = 300, 256
MESH_SERVE_SLOTS, MESH_SERVE_N, MESH_SERVE_BATCH = 4, 512, 128
MESH_FIT_STEPS, MESH_LANES, MESH_LANE_SLOTS = 60, 8, 3
MESH_SWEEP_T = 256
# the reference's mesh bars (tests/test_parallel.py:134-196, 199-225)
MESH_TRAIN_RTOL, MESH_TRAIN_ATOL = 2e-4, 1e-5
MESH_HVP_RTOL, MESH_HVP_ATOL = 1e-3, 1e-6


def same_result(got, want, what: str) -> None:
    """Counts, packed scores, iHVPs and test vectors the same bytes."""
    check(np.array_equal(got.counts, want.counts)
          and got._packed.tobytes() == want._packed.tobytes()
          and got.ihvp.tobytes() == want.ihvp.tobytes()
          and got.test_grad.tobytes() == want.test_grad.tobytes(),
          f"{what}: not bitwise the single-device engine")


def mesh_engine(eng, train, mesh, **kw) -> InfluenceEngine:
    """An engine on ``eng``'s model and weights over ``mesh``."""
    kw.setdefault("damping", DAMPING)
    return engine(eng.model, eng.params, train, mesh=mesh, **kw)


def add_counts(total: dict, got: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in got.items()}


def mesh_slots(real: int, n: int):
    """The context a mesh of up to ``n`` slots is made in: virtual slots
    over cuda:0 (``real`` 0), or the real cards."""
    return contextlib.nullcontext() if real else pmesh.virtual_devices(n)


def card_allocated() -> list[int]:
    """``memory_allocated`` of every visible card, settled."""
    gc.collect()
    n = torch.cuda.device_count()
    for i in range(n):
        torch.cuda.synchronize(i)
    return [torch.cuda.memory_allocated(i) for i in range(n)]


def dispatch_baselines(family: str, eng, train, pts, workdir: str) -> dict:
    """12a's single-device side: ``query_batch`` at BATCHES,
    ``query_many`` at MESH_MANY_BATCH, ``block_hessians``, MESH_BANK_T
    hits of 8d's bank, the state a single-device engine places and its
    ``query_batch`` wall at the largest batch."""
    pre1 = ladder_engine(eng, train, solver="precomputed", cache_dir=workdir,
                         model_name=f"smoke-{family}")
    check(pre1.ensure_factor_bank() >= MESH_BANK_T,
          f"{family} 12a: 8d's bank did not load")
    hits = pre1._bank.pairs[:MESH_BANK_T].astype(np.int64)
    out = {"batch": {T: eng.query_batch(pts[:T]) for T in BATCHES},
           "many": eng.query_many(pts, batch_queries=MESH_MANY_BATCH),
           "hessians": eng.block_hessians(pts[:BATCHES[0]]),
           "hits": hits, "bank": pre1.query_batch(hits)}
    del pre1
    a0 = settled_allocated()
    single = engine(eng.model, eng.params, train, damping=DAMPING)
    out["state"] = settled_allocated() - a0
    del single
    out["ms"] = wall_ms(lambda: eng.query_batch(pts[:BATCHES[-1]]), reps=3)
    return out


def mesh_dispatch(family: str, eng, train, pts, workdir: str, base: dict,
                  real: int = 0) -> dict:
    """12a: the flat dispatch, query_many, block_hessians and bank hits
    over meshes of MESH_SIZES virtual slots over cuda:0 (``real`` 0) or
    of 2 and ``real`` real cards, bitwise the single-device engine
    (``base``, :func:`dispatch_baselines`); a program on each card of the
    mesh; no capture after ``precompile_flat``; one replica of the state
    a card of the mesh, and nothing on a card outside it."""
    name = f"smoke-{family}"
    sizes = sorted({2, real}) if real else MESH_SIZES
    kind = "real card(s)" if real else "virtual slot(s)"
    tag = f"{family} 12a{' real' if real else ''}"
    state1 = base["state"]
    many_batches = [pts[i: i + MESH_MANY_BATCH]
                    for i in range(0, len(pts), MESH_MANY_BATCH)]
    out, keys, launches = {"sizes": {}, "single_ms": base["ms"]}, {}, {}
    with mesh_slots(real, max(sizes)):
        for n in sizes:
            gc.collect()
            torch.cuda.empty_cache()
            a0 = card_allocated()
            m = pmesh.make_mesh(n)
            me = mesh_engine(eng, train, m)
            cards = [d.index for d in pmesh.physical_devices(m)]
            state = [b - a for a, b in zip(a0, card_allocated())]
            check(all(x <= state1 if i in cards else x <= 0
                      for i, x in enumerate(state)),
                  f"{tag} n={n}: the state took {state} B by card, the "
                  f"single-device engine's {state1} B: not one replica a "
                  "card of the mesh")
            geoms = sorted({me.flat_geometry(pts[:T]) for T in BATCHES}
                           | {me.flat_geometry(b) for b in many_batches})
            armed = me.precompile_flat(geoms)
            check(len(armed["compiled"]) == len(geoms),
                  f"{tag} n={n}: precompile built {armed}")
            on = sorted({p.inputs[0].device.index
                         for p in me._programs.values()})
            check(on == cards, f"{tag} n={n}: programs on cards {on}, the "
                  f"mesh's are {cards}")
            c0 = compilemon.count()
            dispatch_without_waits(me)  # every shard queued, no host wait
            reset_counts()
            got = {T: me.query_batch(pts[:T]) for T in BATCHES}
            many = me.query_many(pts, batch_queries=MESH_MANY_BATCH)
            counted = launch_counts()
            captured = compilemon.count() - c0
            check(captured == 0, f"{tag} n={n}: {captured} captures after "
                  "precompile_flat")
            check(counted[SOURCES[family]] > 0 and counted[SEGMENT_SOURCE] > 0,
                  f"{tag} n={n}: kernels not launched: {counted}")
            launches = add_counts(launches, counted)
            for T in BATCHES:
                same_result(got[T], base["batch"][T], f"{tag} n={n} T={T}")
            check(len(many) == len(base["many"]),
                  f"{tag} n={n}: query_many batches")
            for k, (a, b) in enumerate(zip(many, base["many"])):
                same_result(a, b, f"{tag} n={n} query_many batch {k}")
            check(np.array_equal(me.block_hessians(pts[:BATCHES[0]]),
                                 base["hessians"]),
                  f"{tag} n={n}: block_hessians not bitwise single-device")
            alloc = [b - a for a, b in zip(a0, card_allocated())]
            held = [sum(p.pool_bytes + sum(x.nbytes for x in p.inputs)
                        for p in me._programs.values()
                        if p.inputs[0].device.index == i)
                    for i in range(len(alloc))]
            check(all(x <= state1 + h for x, h in zip(alloc, held)),
                  f"{tag} n={n}: {alloc} B allocated by card, more than "
                  f"the single-device state {state1} B plus the graphs' "
                  f"{held} B")
            keys[n] = set(me._aot)
            ms = wall_ms(lambda: me.query_batch(pts[:BATCHES[-1]]), reps=3)
            del me, got, many
            pm = ladder_engine(eng, train, solver="precomputed",
                               cache_dir=workdir, model_name=name,
                               mesh=pmesh.make_mesh(n))
            reset_counts()
            same_result(pm.query_batch(base["hits"]), base["bank"],
                        f"{tag} n={n} bank hits")
            bank_counted = launch_counts()
            check(bank_counted[SOURCES[family]] > 0,
                  f"{tag} n={n}: bank hits never launched "
                  f"{SOURCES[family]}")
            launches = add_counts(launches, bank_counted)
            del pm
            out["sizes"][n] = {"state_bytes": state, "allocated": alloc,
                               "graph_bytes": held,
                               "geometries": [list(g) for g in geoms],
                               "query_batch_ms": ms}
            log(f"{tag}: a mesh of {n} {kind}: query_batch {BATCHES}, "
                f"query_many at {MESH_MANY_BATCH}, block_hessians and "
                f"{MESH_BANK_T} bank hits bitwise single-device; 0 captures "
                f"after precompile_flat ({len(geoms)} geometries); state "
                f"{[round(x / 2**20, 1) for x in state]} MiB by card "
                f"(single-device {state1 / 2**20:.1f} MiB), allocated "
                f"{[round(x / 2**20, 1) for x in alloc]} MiB <= state + "
                f"graphs; query_batch({BATCHES[-1]}) {ms:.2f} ms wall, "
                f"{base['ms']:.2f} ms single-device"
                + ("" if real else " (virtual slots share the card: "
                   "overhead, not speedup)"))
    sizes = list(keys)
    for i, a in enumerate(sizes):
        for b in sizes[i + 1:]:
            check(not keys[a] & keys[b], f"{tag}: meshes of {a} and {b} "
                  "slots share a geometry key")
    out["launches"] = launches
    return out


def mesh_serving(family: str, eng, train, pts, real: int = 0) -> dict:
    """12b: a MESH_SERVE_SLOTS-slot mesh service of virtual slots
    (``real`` 0; else over ``real`` real cards) loses a device at batch 1
    and shrinks by one slot, every answer bitwise the single-device
    service's."""
    reqs = serve_stream(pts)[:MESH_SERVE_N]
    slots = real or MESH_SERVE_SLOTS
    tag = f"{family} 12b{' real' if real else ''}"

    def config(**kw):
        return serve_config(max_batch=MESH_SERVE_BATCH, **kw)

    want = {r.id: r for r in InfluenceService(engine=eng,
                                              config=config()).run(reqs)}
    check(all(r.ok for r in want.values()), f"{tag}: single-device "
          "service shed requests")
    seen, misses = set(), []
    for r in reqs:
        if r.key() not in seen:
            seen.add(r.key())
            misses.append(r.key())
    misses = np.asarray(misses, np.int64)

    def same_answers(got, what):
        for r in got:
            check(r.ok and r.scores.tobytes() == want[r.id].scores.tobytes(),
                  f"{what}: request {r.id} not bitwise the single-device "
                  "service's")

    with mesh_slots(real, slots):
        m = pmesh.make_mesh(slots)
        me = mesh_engine(eng, train, m)
        svc = InfluenceService(engine=me, config=config(mesh=m))
        warm = svc.warmup(misses)
        check(warm["all_planned_compiled"], f"{tag} warmup: {warm}")
        reset_counts()
        with inject.active(inject.Fault(sites.SERVE_DISPATCH, at=1,
                                        kind=taxonomy.DEVICE_LOST),
                           strict=True, validate=True):
            got = svc.run(list(reqs))
        launches = launch_counts()
        same_answers(got, f"{tag} after the loss")
        check(svc.mesh.devices.size == slots - 1
              and me.mesh.devices.size == slots - 1
              and svc.rollup()["device_loss_recoveries"] == 1,
              f"{tag}: mesh {svc.mesh} after the loss, "
              f"{svc.rollup()['device_loss_recoveries']} recoveries")
        armed, c0 = set(me._aot), compilemon.count()
        svc.invalidate()
        same_answers(svc.run(list(reqs)), f"{tag} traffic after")
        check(compilemon.count() == c0 and set(me._aot) == armed,
              f"{tag}: traffic at the same geometries after the "
              f"shrink captured {compilemon.count() - c0} program(s)")
        # a fault inside the rebuild sheds that batch, classified
        me2 = mesh_engine(eng, train, pmesh.make_mesh(slots))
        svc2 = InfluenceService(engine=me2, config=config(mesh=me2.mesh))
        with inject.active(inject.Fault(sites.SERVE_DISPATCH, at=1,
                                        kind=taxonomy.DEVICE_LOST),
                           inject.Fault(sites.MESH_REBUILD, at=0,
                                        kind=taxonomy.OOM),
                           strict=True, validate=True):
            got2 = svc2.run(list(reqs))
        shed = [r for r in got2 if not r.ok]
        check(shed and all(r.reason in (taxonomy.DEVICE_LOST, taxonomy.OOM)
                           for r in shed),
              f"{tag} rebuild fault: shed {[r.reason for r in shed]}")
        served = [r for r in got2 if r.ok]
        check(served, f"{tag} rebuild fault: nothing served")
        same_answers(served, f"{tag} rebuild fault")
        # a mesh naming a dead slot fails construction, classified
        live = pmesh.live_device_ids
        pmesh.live_device_ids = lambda: frozenset(range(slots - 1))
        try:
            InfluenceService(engine=me2, config=config(mesh=me2.mesh))
            dead = None
        except taxonomy.DeviceLost as e:
            dead = e
        finally:
            pmesh.live_device_ids = live
        check(dead is not None and dead.devices == [slots - 1],
              f"{tag}: a dead slot did not fail construction: {dead}")
    got_counts = recovery_counts()
    check(not got_counts["retries"] and not got_counts["resets"]
          and not got_counts["cpu_rung_batches"],
          f"{tag}: a recovery ladder beyond the shrink: {got_counts}")
    obs.REGISTRY.reset()  # the injected losses and their sheds, counted
    log(f"{tag}: a {slots}-slot service over "
        f"{MESH_SERVE_N} requests lost a device at batch 1 and shrank to "
        f"{slots - 1} slots, every answer bitwise the "
        f"single-device service; traffic after captured nothing; a "
        f"rebuild fault shed {len(shed)} request(s) classified, "
        f"{len(served)} served; a dead slot failed construction "
        "(DeviceLost)")
    return {"launches": launches, "shed_on_rebuild_fault": len(shed),
            "recoveries": 1}


def training_baselines(family: str, eng, train, pts, workdir: str) -> dict:
    """12c's single-device side: ``Trainer.fit``, MESH_LANES
    leave-one-out lanes, the full engine's HVP of a seeded vector, and a
    ``reverse_topk`` sweep of MESH_SWEEP_T queries on a streaming model
    (with the model, its labels and queries)."""
    model, x, y = eng.model, train.x, train.y
    cfg = TrainConfig(batch_size=FULL_BATCH, num_steps=MESH_FIT_STEPS,
                      learning_rate=TRAIN_LR, seed=0)
    t1 = Trainer(model, cfg, device=CARD)
    out = {"cfg": cfg, "fit": t1.fit(t1.init_state(eng.params), x, y).params,
           "removed": np.asarray([3, 1_000, 77_777, -1, 250_000, 500_000,
                                  900_000, 975_459][:MESH_LANES], np.int64),
           "seeds": np.arange(MESH_LANES, dtype=np.uint32)}
    out["lanes"] = loo_retrain_many(model, eng.params, x, y, out["removed"],
                                    MESH_FIT_STEPS, FULL_BATCH, TRAIN_LR,
                                    seeds=out["seeds"], device=CARD)
    full1 = FullInfluenceEngine(model, eng.params, train, damping=DAMPING,
                                device=CARD)
    out["num_train"] = full1.num_train
    out["v"] = torch.randn(full1.num_params,
                           generator=torch.Generator().manual_seed(5)).to(CARD)
    out["hvp"] = full1._hvp(out["v"])
    del full1
    a = out["stream"] = stream_model(
        family, train, os.path.join(workdir, f"{family}-mesh"),
        f"mesh-{family}")
    out["ty"] = np.random.default_rng(47).integers(1, 6, MESH_SWEEP_T).astype(
        np.float32)
    r = reverse_topk(a, pts[:MESH_SWEEP_T], out["ty"], k=SWEEP_K,
                     batch_queries=SWEEP_BATCH)
    out["sweep"] = (r.row_ids.tobytes(), r.loss_deltas.tobytes(),
                    r.group_scores.tobytes())
    return out


def mesh_training(family: str, eng, train, pts, base: dict,
                  real: int = 0) -> dict:
    """12c: data-parallel training, sharded lanes, the sharded full HVP
    and the audit sweep on meshes of virtual slots (``real`` 0) or of
    real cards, against the single-device side ``base``
    (:func:`training_baselines`)."""
    model, x, y = eng.model, train.x, train.y
    tag = f"{family} 12c{' real' if real else ''}"
    lane_slots = min(MESH_LANE_SLOTS, real) if real else MESH_LANE_SLOTS
    sweep_sizes = sorted({2, real}) if real else MESH_SIZES

    def close_params(a, b, rtol, atol, what):
        worst = 0.0
        for k in a:
            d = (a[k] - b[k]).abs() - atol - rtol * b[k].abs()
            worst = max(worst, float(d.max()))
            check(a[k].shape == b[k].shape and worst <= 0,
                  f"{tag} {what}: {k} beyond rtol {rtol} / atol {atol}")
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    a, ty = base["stream"], base["ty"]
    sweep_pts = pts[:MESH_SWEEP_T]
    with mesh_slots(real, max(*sweep_sizes, lane_slots)):
        t2 = Trainer(model, base["cfg"], mesh=pmesh.make_mesh(2))
        t0 = time.perf_counter()
        s2 = t2.fit(t2.init_state(eng.params), x, y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_err = close_params(s2.params, base["fit"], MESH_TRAIN_RTOL,
                               MESH_TRAIN_ATOL, "fit on a 2-slot mesh")
        lanes2 = loo_retrain_many(model, eng.params, x, y, base["removed"],
                                  MESH_FIT_STEPS, FULL_BATCH, TRAIN_LR,
                                  seeds=base["seeds"],
                                  mesh=pmesh.make_mesh(lane_slots))
        lane_err = close_params(lanes2, base["lanes"], MESH_TRAIN_RTOL,
                                MESH_TRAIN_ATOL,
                                f"{MESH_LANES} lanes on {lane_slots} slots")
        full2 = FullInfluenceEngine(model, eng.params, train,
                                    damping=DAMPING, mesh=pmesh.make_mesh(2))
        check(full2.num_train == base["num_train"],
              f"{tag}: the 2-slot full engine kept {full2.num_train}")
        h1, h2 = base["hvp"], full2._hvp(base["v"])
        hvp_err = float((h2 - h1).abs().max())
        check(bool(((h2 - h1).abs() <= MESH_HVP_ATOL
                    + MESH_HVP_RTOL * h1.abs()).all()),
              f"{tag}: the sharded HVP is beyond rtol {MESH_HVP_RTOL} / "
              f"atol {MESH_HVP_ATOL} ({hvp_err})")
        del full2, h2
        launches = {}
        for n in sweep_sizes:
            me = engine(a.model, a.state.params, train, damping=DAMPING,
                        mesh=pmesh.make_mesh(n))
            me.query_many(sweep_pts, batch_queries=SWEEP_BATCH)  # captures
            reset_counts()
            r = reverse_topk(a, sweep_pts, ty, k=SWEEP_K, engine=me,
                             batch_queries=SWEEP_BATCH)
            launches = add_counts(launches, launch_counts())
            check((r.row_ids.tobytes(), r.loss_deltas.tobytes(),
                   r.group_scores.tobytes()) == base["sweep"],
                  f"{tag}: the sweep over {n} slot(s) differs")
            del me
    check(launches[SOURCES[family]] > 0 and launches[SEGMENT_SOURCE] > 0,
          f"{tag}: the mesh sweep launched {launches}")
    log(f"{tag}: fit on a 2-slot mesh ({MESH_FIT_STEPS} steps at "
        f"{FULL_BATCH}, {fit_s:.2f} s) max |diff| {fit_err:.3g} within "
        f"rtol {MESH_TRAIN_RTOL} / atol {MESH_TRAIN_ATOL} of single-device; "
        f"{MESH_LANES} lanes on {lane_slots} slots max |diff| "
        f"{lane_err:.3g}; the 2-slot HVP max |diff| {hvp_err:.3g} "
        f"(rtol {MESH_HVP_RTOL}); reverse_topk over {MESH_SWEEP_T} queries "
        f"bitwise over {sweep_sizes} slots")
    return {"fit_max_abs_diff": fit_err, "fit_s": fit_s,
            "lanes_max_abs_diff": lane_err, "hvp_max_abs_diff": hvp_err,
            "launches": launches}


def mesh_drivers(workdir: str) -> dict:
    """12d: ``cli.rq2 --mesh 2`` and ``cli.serve --mesh 2`` in process
    over two virtual slots."""
    import contextlib
    import io

    from fia_tpu_torch.cli import rq2 as cli_rq2
    from fia_tpu_torch.cli import serve as cli_serve

    base = ["--dataset", "synthetic", "--model", "MF",
            "--num_steps_train", "300", "--batch_size", "3000", "--mesh",
            "2"]
    with pmesh.virtual_devices(2):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            timing = cli_rq2.main(base + [
                "--num_test", "64", "--train_dir",
                os.path.join(workdir, "mesh-rq2")])
        rq2_s = time.perf_counter() - t0
        check(timing.num_queries == 64 and timing.num_scores > 0,
              f"12d: cli.rq2 --mesh 2: {buf.getvalue().splitlines()[-3:]}")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_serve.main(base + [
                "--warmup", "64", "--smoke_requests", "512",
                "--train_dir", os.path.join(workdir, "mesh-serve")])
        serve_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"12d: cli.serve --mesh 2 returned {rc}: {lines[-3:]}")
    smoke = next(json.loads(x) for x in lines if '"serve.smoke"' in x)
    log(f"12d: cli.rq2 --mesh 2 returned ({timing.num_queries} queries, "
        f"{timing.num_scores} scores) in {rq2_s:.1f} s; cli.serve --mesh 2 "
        f"returned 0 ({smoke['ok']}/512 ok) in {serve_s:.1f} s")
    return {"rq2_s": rq2_s, "rq2_queries": timing.num_queries,
            "serve_rc": rc, "serve_s": serve_s, "serve_ok": smoke["ok"]}


def drive_mesh(engines, train, pts, workdir: str) -> dict:
    """Phase 12 (each model: 12a, 12b, 12c over virtual slots, and again
    over the real cards, up to 4, where two or more are visible; 12d
    once)."""
    out = {}
    real = min(4, torch.cuda.device_count())
    real = real if real >= 2 else 0
    obs.REGISTRY.reset()  # phase 11's injected faults are its own
    for family, (eng, _) in engines.items():
        t0 = time.perf_counter()
        dispatched = dispatch_baselines(family, eng, train, pts, workdir)
        trained = training_baselines(family, eng, train, pts, workdir)
        for r in (0, real) if real else (0,):
            row = out.setdefault(family, {}).setdefault(
                "real" if r else "virtual", {})
            row["12a"] = mesh_dispatch(family, eng, train, pts, workdir,
                                       dispatched, real=r)
            no_recovery(f"12a {family}")
            row["12b"] = mesh_serving(family, eng, train, pts, real=r)
            row["12c"] = mesh_training(family, eng, train, pts, trained,
                                       real=r)
            no_recovery(f"12c {family}")
        if not real:
            log(f"{family} 12: {torch.cuda.device_count()} CUDA device "
                "visible: the mesh over real cards was not run")
        out[family]["real_cards"] = real
        out[family]["seconds"] = time.perf_counter() - t0
        del dispatched, trained
        gc.collect()
        torch.cuda.empty_cache()
    out["12d"] = mesh_drivers(workdir)
    no_recovery("12d")
    return out


def mesh_only(engines, train, pts, card: str, kind: str,
              t_main: float) -> int:
    """``--phase 12``: after the build and the set-up, 8d's banks, then
    phase 12 alone (over the real cards too where two or more are
    visible), its results on the ``perf`` line."""
    with tempfile.TemporaryDirectory() as workdir:
        for family, (eng, _) in engines.items():
            publish_hot_bank(family, eng, train, workdir)
        t12 = time.perf_counter()
        perf = {"card": card, "mesh": drive_mesh(engines, train, pts,
                                                 workdir)}
    perf["phase12_seconds"] = time.perf_counter() - t12
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"phase 12: {perf['phase12_seconds']:.1f} s; chip_smoke --phase 12 "
        f"total: {perf['total_seconds']:.1f} s")
    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def mesh_launches(row: dict, source: str) -> dict:
    """A kernel's launches in phase 12's parts, over virtual slots and
    (where they ran) real cards."""
    return {mode: {part: row[mode][part]["launches"][source]
                   for part in ("12a", "12b", "12c")}
            for mode in ("virtual", "real") if mode in row}


# -- phase 13: row-sharded tables and the multi-process runtime ---------
# 13a: the (data, model) meshes over 4 virtual slots on one card, the
# query batches of BATCHES bitwise single-device, the padded program at
# SHARD_PADDED_T bitwise the replicated padded engine, MESH_BANK_T bank
# hits; 13b: the rebuild (2, 2) -> (1, 2) -> (1, 1) and a service over
# SHARD_SERVE_N requests losing a device; 13c: two processes of
# SHARD_PROC_SLOTS virtual slots each on cuda:0 (gloo on loopback), a
# make_hybrid_mesh(model_parallel=2): query_batch(BATCHES[-1]) for MF and
# NCF, the full engine's CG at SHARD_FULL_MAXITER and SHARD_FIT_STEPS fit
# steps at FULL_BATCH (MF), each bitwise the one-process (2, 2) mesh
SHARD_SHAPES = ((2, 2), (1, 4))
SHARD_PADDED_T, SHARD_SERVE_N = 256, 512
SHARD_PROC_SLOTS, SHARD_FULL_MAXITER, SHARD_FIT_STEPS = 2, 10, 4
SHARD_WORKER = "--phase13-worker"
SHARD_WORKER_S = 240
# how 13c starts a worker: this script, with SHARD_WORKER and its slot
SHARD_WORKER_CMD = (sys.executable, os.path.abspath(__file__))


def shard_shapes(real: int) -> tuple:
    """13a's (data, model) shapes: SHARD_SHAPES over 4 virtual slots
    (``real`` 0), else the shapes of ``real`` real cards with a model
    axis of at least 2."""
    if not real:
        return SHARD_SHAPES
    return tuple((real // m, m) for m in (2, 4) if real % m == 0
                 and real >= m)


def table_slot_bytes(eng, model) -> dict:
    """Each slot's bytes of each row-sharded table, and what the
    contract asks: ``padded_rows(n, m) / m`` rows of the whole table."""
    from fia_tpu_torch.parallel import sharded as SH

    m = int(eng.mesh.shape["model"])
    got, want = {}, {}
    for name in SH.table_names(model):
        v = eng.params[name]
        host = eng._params_host[name]
        row = host[0].nbytes
        want[name] = SH.padded_rows(host.shape[0], m) // m * row
        got[name] = sorted({x.numel() * x.element_size()
                            for x in v.shards})
    return {"got": got, "want": want}


def sharded_dispatch(family: str, eng, train, pts, workdir: str,
                     base: dict, real: int = 0) -> dict:
    """13a: the sharded engine over each (data, model) shape: bitwise
    the single-device engine (``base``) at BATCHES, bank hits bitwise,
    the padded program at SHARD_PADDED_T bitwise the replicated padded
    engine on the same mesh; each slot's table bytes padded_rows / m of
    the table; the score kernel and segment_hessian launched on the
    sharded path; no capture after ``precompile_flat``; walls beside
    the single-device engine's."""
    from fia_tpu_torch.parallel import sharded as SH

    tag = f"{family} 13a{' real' if real else ''}"
    out, launches = {"shapes": {}, "single_ms": base["ms"]}, {}
    with mesh_slots(real, 4):
        for d, m in shard_shapes(real):
            mesh = SH.make_2d_mesh(d * m, model_parallel=m)
            se = mesh_engine(eng, train, mesh, shard_tables=True)
            check(se._sharded_now() and se.active_kernel_variant() == "cuda",
                  f"{tag} ({d}, {m}): not a sharded cuda engine")
            tb = table_slot_bytes(se, eng.model)
            check(all(tb["got"][k] == [tb["want"][k]] for k in tb["want"]),
                  f"{tag} ({d}, {m}): table bytes by slot {tb['got']}, "
                  f"padded_rows / {m} is {tb['want']}")
            geoms = sorted({se.flat_geometry(pts[:T]) for T in BATCHES})
            armed = se.precompile_flat(geoms)
            check(len(armed["compiled"]) == len(geoms),
                  f"{tag} ({d}, {m}): precompile built {armed}")
            c0 = compilemon.count()
            reset_counts()
            got = {T: se.query_batch(pts[:T]) for T in BATCHES}
            counted = launch_counts()
            captured = compilemon.count() - c0
            check(captured == 0, f"{tag} ({d}, {m}): {captured} captures "
                  "after precompile_flat")
            check(counted[SOURCES[family]] > 0
                  and counted[SEGMENT_SOURCE] > 0,
                  f"{tag} ({d}, {m}): kernels not launched: {counted}")
            launches = add_counts(launches, counted)
            for T in BATCHES:
                same_result(got[T], base["batch"][T],
                            f"{tag} ({d}, {m}) T={T}")
            ms = wall_ms(lambda: se.query_batch(pts[:BATCHES[-1]]), reps=3)
            del se, got
            pm = ladder_engine(eng, train, solver="precomputed",
                               cache_dir=workdir, model_name=f"smoke-{family}",
                               mesh=mesh, shard_tables=True)
            reset_counts()
            same_result(pm.query_batch(base["hits"]), base["bank"],
                        f"{tag} ({d}, {m}) bank hits")
            bank_counted = launch_counts()
            check(bank_counted[SOURCES[family]] > 0,
                  f"{tag} ({d}, {m}): bank hits never launched "
                  f"{SOURCES[family]}")
            launches = add_counts(launches, bank_counted)
            del pm
            q = pts[:SHARD_PADDED_T]
            walls = {}
            for sharded in (True, False):
                pe = mesh_engine(eng, train, mesh, impl="padded",
                                 shard_tables=sharded)
                t0 = time.perf_counter()
                res = pe.query_batch(q)
                torch.cuda.synchronize()
                walls[sharded] = (time.perf_counter() - t0) * 1e3
                if sharded:
                    padded = res
                del pe
            check(padded._packed.tobytes() == res._packed.tobytes()
                  and padded.ihvp.tobytes() == res.ihvp.tobytes()
                  and padded.test_grad.tobytes() == res.test_grad.tobytes(),
                  f"{tag} ({d}, {m}): the sharded padded program is not "
                  "bitwise the replicated one")
            out["shapes"][f"{d}x{m}"] = {
                "query_batch_ms": ms, "table_bytes": tb,
                "geometries": [list(g) for g in geoms],
                "padded_ms": walls[True], "padded_replicated_ms": walls[False]}
            log(f"{tag}: ({d}, {m}) mesh of "
                f"{'real cards' if real else 'virtual slots'}, row-sharded "
                f"tables ({', '.join(f'{k} {v}' for k, v in tb['want'].items())}"
                f" B a slot): query_batch {BATCHES}, {MESH_BANK_T} bank hits "
                f"bitwise single-device; padded T={SHARD_PADDED_T} bitwise "
                f"the replicated padded engine ({walls[True]:.1f} ms, "
                f"replicated {walls[False]:.1f} ms, first call each); 0 "
                f"captures after precompile_flat; query_batch({BATCHES[-1]})"
                f" {ms:.2f} ms wall, {base['ms']:.2f} ms single-device")
    out["launches"] = launches
    return out


def sharded_recovery(family: str, eng, train, pts) -> dict:
    """13b: ``rebuild_mesh`` (2, 2) -> (1, 2) keeps the tables sharded,
    (1, 2) -> (1, 1) places them replicated, each bitwise; a service on
    the (2, 2) sharded mesh loses a device at batch 1 and shrinks to
    (1, 2), every answer bitwise the single-device service's."""
    from fia_tpu_torch.parallel import sharded as SH

    tag = f"{family} 13b"
    T = BATCHES[-1]
    want = eng.query_batch(pts[:T])
    reqs = serve_stream(pts)[:SHARD_SERVE_N]

    def config(**kw):
        return serve_config(max_batch=MESH_SERVE_BATCH, **kw)

    single = {r.id: r for r in InfluenceService(engine=eng,
                                                config=config()).run(reqs)}
    with pmesh.virtual_devices(4):
        mesh = SH.make_2d_mesh(4, model_parallel=2)
        se = mesh_engine(eng, train, mesh, shard_tables=True)
        shrunk = pmesh.surviving_mesh(mesh)
        se.rebuild_mesh(shrunk)
        check(shrunk.shape == {"data": 1, "model": 2} and se._sharded_now()
              and isinstance(se.params["P" if family == "mf" else "P_mlp"],
                             SH.Placed),
              f"{tag}: the rebuild onto {shrunk} did not keep the tables "
              "sharded")
        same_result(se.query_batch(pts[:T]), want, f"{tag} after (1, 2)")
        se.rebuild_mesh(pmesh.surviving_mesh(shrunk))
        check(not se._sharded_now(), f"{tag}: (1, 1) still sharded")
        same_result(se.query_batch(pts[:T]), want, f"{tag} after (1, 1)")
        del se
        me = mesh_engine(eng, train, mesh, shard_tables=True)
        svc = InfluenceService(engine=me, config=config(mesh=mesh))
        with inject.active(inject.Fault(sites.SERVE_DISPATCH, at=1,
                                        kind=taxonomy.DEVICE_LOST),
                           strict=True, validate=True):
            got = svc.run(list(reqs))
        for r in got:
            check(r.ok and r.scores.tobytes() == single[r.id].scores.tobytes(),
                  f"{tag}: request {r.id} not bitwise the single-device "
                  "service's")
        check(svc.mesh.shape == {"data": 1, "model": 2} and me._sharded_now()
              and svc.rollup()["device_loss_recoveries"] == 1,
              f"{tag}: the service's mesh {svc.mesh} after the loss")
        del me, svc
    got_counts = recovery_counts()
    check(not got_counts["retries"] and not got_counts["resets"]
          and not got_counts["cpu_rung_batches"],
          f"{tag}: a recovery ladder beyond the shrink: {got_counts}")
    obs.REGISTRY.reset()  # the injected loss, counted
    log(f"{tag}: rebuild (2, 2) -> (1, 2) kept the tables row-sharded and "
        f"(1, 2) -> (1, 1) placed them replicated, query_batch({T}) bitwise "
        f"single-device after each; a (2, 2) sharded service over "
        f"{SHARD_SERVE_N} requests lost a device at batch 1 and shrank to "
        "(1, 2), every answer bitwise the single-device service's")
    return {"recoveries": 1}


def shard_process_run(mesh, models: dict, train, pts) -> dict:
    """13c's work on ``mesh`` (one process's or two processes'):
    host results by name."""
    out = {}
    for family, model in models.items():
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=CARD)
        se = engine(model, params, train, damping=DAMPING, mesh=mesh,
                    shard_tables=True)
        reset_counts()
        res = se.query_batch(pts[:BATCHES[-1]])
        counted = launch_counts()
        out[f"{family}_launches"] = np.asarray(
            [counted[SOURCES[family]], counted[SEGMENT_SOURCE]])
        out.update({f"{family}_packed": res._packed,
                    f"{family}_ihvp": res.ihvp,
                    f"{family}_v": res.test_grad})
        del se
        if family != "mf":
            continue
        full = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg",
                                   cg_maxiter=SHARD_FULL_MAXITER, mesh=mesh)
        out["full_scores"] = full.get_influence_on_test_loss(
            train.x[:2], train.y[:2])
        del full
        tr = Trainer(model, TrainConfig(batch_size=FULL_BATCH,
                                        num_steps=SHARD_FIT_STEPS,
                                        learning_rate=TRAIN_LR, seed=0),
                     mesh=mesh)
        state = tr.fit(tr.init_state(params), train.x, train.y)
        out.update({f"fit_{k}": v.cpu().numpy()
                    for k, v in state.params.items()})
    return out


def shard_worker(argv) -> int:
    """One process of 13c: ``--phase13-worker <id> <port> <out>``."""
    from fia_tpu_torch.parallel import distributed as D

    pid, port, path = int(argv[0]), int(argv[1]), argv[2]
    pmesh.set_virtual_devices(SHARD_PROC_SLOTS)
    D.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    try:
        mesh = D.make_hybrid_mesh(model_parallel=2)
        check(dict(mesh.shape) == {"data": 2, "model": 2}
              and D.spans_processes(mesh)
              and all(len({s.process_index for s in row}) == 1
                      for row in mesh.devices),
              f"13c worker {pid}: mesh {mesh}")
        train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
        pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES),
                                   seed=17)
        t0 = time.perf_counter()
        out = shard_process_run(mesh, {"mf": MF(USERS, ITEMS, K_EMB, WD),
                                       "ncf": NCF(USERS, ITEMS, K_EMB, WD)},
                                train, pts)
        out["seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(f"{path}.{pid}.npz", **out)
    finally:
        D.shutdown()
    return 0


def sharded_processes(engines, train, pts) -> dict:
    """13c: two processes, gloo on loopback, each owning SHARD_PROC_SLOTS
    virtual slots on cuda:0, on ``make_hybrid_mesh(model_parallel=2)``:
    every result bitwise the one-process (2, 2) mesh of the same slots."""
    import socket

    from fia_tpu_torch.parallel import sharded as SH

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    work = tempfile.TemporaryDirectory()
    path = os.path.join(work.name, "proc")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*SHARD_WORKER_CMD, SHARD_WORKER, str(p), str(port), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for p in (0, 1)]
    try:
        # the one-process side runs while the workers start and run
        with pmesh.virtual_devices(2 * SHARD_PROC_SLOTS):
            mesh = SH.make_2d_mesh(2 * SHARD_PROC_SLOTS, model_parallel=2)
            want = shard_process_run(mesh, {f: e.model for f, (e, _)
                                            in engines.items()}, train, pts)
        logs = [p.communicate(timeout=SHARD_WORKER_S)[0].decode()
                for p in procs]
    except subprocess.TimeoutExpired:
        logs = ["timed out"] * 2
    finally:
        for p in procs:  # a crashed worker leaves its peer waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, text in zip(procs, logs):
        check(p.returncode == 0, f"13c: a worker failed ({p.returncode}):\n"
              + text[-4000:])
    got = [dict(np.load(f"{path}.{p}.npz")) for p in (0, 1)]
    work.cleanup()
    for p, g in enumerate(got):
        for k, v in want.items():
            if k.endswith("_launches"):
                continue
            check(g[k].tobytes() == v.tobytes(),
                  f"13c: process {p}'s {k} is not bitwise the one-process "
                  "(2, 2) mesh's")
    for f in engines:
        check(all(g[f"{f}_launches"].min() > 0 for g in got),
              f"13c: {f}'s kernels not launched in a process: "
              f"{[g[f + '_launches'].tolist() for g in got]}")
    log(f"13c: two processes (gloo on loopback, {SHARD_PROC_SLOTS} virtual "
        f"slots each on cuda:0, make_hybrid_mesh(model_parallel=2)): "
        f"query_batch({BATCHES[-1]}) of MF and NCF, the full engine's CG "
        f"({SHARD_FULL_MAXITER} iterations) and {SHARD_FIT_STEPS} fit steps "
        f"bitwise the one-process (2, 2) mesh on both processes; "
        f"{wall:.1f} s wall for the pair (start-up included; the "
        f"one-process side ran meanwhile), their work "
        f"{[round(float(g['seconds']), 1) for g in got]} s")
    return {"wall_s": wall, "work_s": [float(g["seconds"]) for g in got],
            "launches": {f: [g[f"{f}_launches"].tolist() for g in got]
                         for f in engines}}


def drive_sharded(engines, train, pts, workdir: str) -> dict:
    """Phase 13 (per model: 13a over virtual slots, and over the real
    cards where two or more are visible; 13b; then 13c once)."""
    out = {}
    real = min(4, torch.cuda.device_count())
    real = real if real >= 2 else 0
    obs.REGISTRY.reset()
    for family, (eng, _) in engines.items():
        t0 = time.perf_counter()
        pre1 = ladder_engine(eng, train, solver="precomputed",
                             cache_dir=workdir, model_name=f"smoke-{family}")
        check(pre1.ensure_factor_bank() >= MESH_BANK_T,
              f"{family} 13a: 8d's bank did not load")
        hits = pre1._bank.pairs[:MESH_BANK_T].astype(np.int64)
        base = {"batch": {T: eng.query_batch(pts[:T]) for T in BATCHES},
                "hits": hits, "bank": pre1.query_batch(hits),
                "ms": wall_ms(lambda: eng.query_batch(pts[:BATCHES[-1]]),
                              reps=3)}
        del pre1
        row = out.setdefault(family, {})
        row["13a"] = sharded_dispatch(family, eng, train, pts, workdir, base)
        if real:
            row["13a_real"] = sharded_dispatch(family, eng, train, pts,
                                               workdir, base, real=real)
        else:
            log(f"{family} 13a: {torch.cuda.device_count()} CUDA device "
                "visible: the sharded mesh over real cards was not run")
        no_recovery(f"13a {family}")
        row["13b"] = sharded_recovery(family, eng, train, pts)
        row["real_cards"] = real
        row["seconds"] = time.perf_counter() - t0
        del base
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["13c"] = sharded_processes(engines, train, pts)
    out["13c"]["seconds"] = time.perf_counter() - t0
    no_recovery("13c")
    return out


def sharded_only(engines, train, pts, card: str, kind: str,
                 t_main: float) -> int:
    """``--phase 13``: after the build and the set-up, 8d's banks, then
    phase 13 alone, its results on the ``perf`` line."""
    with tempfile.TemporaryDirectory() as workdir:
        for family, (eng, _) in engines.items():
            publish_hot_bank(family, eng, train, workdir)
        t13 = time.perf_counter()
        perf = {"card": card, "sharded": drive_sharded(engines, train, pts,
                                                       workdir)}
    perf["phase13_seconds"] = time.perf_counter() - t13
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"phase 13: {perf['phase13_seconds']:.1f} s; chip_smoke --phase 13 "
        f"total: {perf['total_seconds']:.1f} s")
    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def sharded_launches(row: dict, source: str) -> dict:
    """A kernel's launches in phase 13a (virtual slots, and real cards
    where they ran)."""
    return {part: row[part]["launches"][source]
            for part in ("13a", "13a_real") if part in row}


# -- phase 14: host roles, the host-loss shrink, sharded checkpoints ----
# 14a: two processes of this script (HOSTROLE_WORKER), gloo on loopback,
# each pinned to cuda:0 through initialize(local_device_ids=[0]), serve
# HOSTROLE_N requests under host_role=(h, 2, dir) at HOSTROLE_BATCH a
# batch, each bitwise one in-process service over the stream; then host
# 1 restarts in this process against the same journals with no
# query_many call; 14b: host 0 alone adopts host 1's shard after
# HOSTROLE_ADOPT_S; 14c: HOST_LOST at serve.dispatch on 4 virtual slots
# over 2 virtual hosts; 14d: in the two processes, the sharded engine's
# params on make_hybrid_mesh(model_parallel=2) (HOSTROLE_PROC_SLOTS each)
# saved and restored (train/checkpoint_orbax.py), the query bitwise
HOSTROLE_N, HOSTROLE_BATCH = 1024, 256
HOSTROLE_PROC_SLOTS = 2
HOSTROLE_MERGE_S = 150.0  # a worker's merge budget for its peer's shard
HOSTROLE_ADOPT_S = 2.0  # 14b's merge budget before it adopts
HOSTROLE_WORKER = "--phase14-worker"
HOSTROLE_WORKER_S = 270
# how 14a starts a worker: this script, with HOSTROLE_WORKER and its id
HOSTROLE_WORKER_CMD = (sys.executable, os.path.abspath(__file__))
HOSTROLE_FAMILIES = {"mf": MF, "ncf": NCF}


def hostrole_config(**kw) -> ServeConfig:
    """Phase 14's service knobs: one drain of HOSTROLE_N misses in
    batches of HOSTROLE_BATCH, no disk tier."""
    return ServeConfig(max_batch=HOSTROLE_BATCH, max_queue=HOSTROLE_N,
                       cache_entries=HOSTROLE_N, disk_cache=False, **kw)


def hostrole_requests(pts) -> list:
    return [Request(int(u), int(i), id=f"h{n}")
            for n, (u, i) in enumerate(pts[:HOSTROLE_N])]


def hostrole_answers(responses) -> dict:
    """A stream's answers as arrays in request order."""
    check(all(r.ok for r in responses),
          f"14: {sum(not r.ok for r in responses)} requests not answered: "
          f"{[r.reason for r in responses if not r.ok][:4]}")
    return {"scores": np.concatenate([r.scores for r in responses]),
            "ihvp": np.stack([r.ihvp for r in responses]),
            "test_grad": np.stack([r.test_grad for r in responses]),
            "counts": np.asarray([len(r.scores) for r in responses]),
            "batch_ids": np.asarray([r.batch_id for r in responses])}


def hostrole_warm(eng, pts) -> float:
    """The process's first work on the card, timed: a query of the last
    16 held-out pairs (a geometry no drain of the phase uses), so a
    drain's wall holds no one-time start-up of the libraries."""
    t0 = time.perf_counter()
    eng.query_batch(pts[-16:])  # its results are on the host: synchronised
    return time.perf_counter() - t0


def same_answers(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        check(np.asarray(got[k]).tobytes() == v.tobytes(),
              f"{what}: {k} not bitwise one in-process service's")


def hostrole_worker(argv) -> int:
    """One process of 14a and 14d: ``--phase14-worker <id> <port> <dir>``
    (its results to ``<dir>/proc.<id>.npz``)."""
    from fia_tpu_torch.parallel import distributed as D
    from fia_tpu_torch.parallel import sharded as SH
    from fia_tpu_torch.train import checkpoint_orbax as co

    pid, port, work = int(argv[0]), int(argv[1]), argv[2]
    pmesh.set_virtual_devices(HOSTROLE_PROC_SLOTS)
    D.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                 local_device_ids=[0])
    try:
        home = torch.device("cuda", 0) if CARD == "cuda" else \
            torch.device(CARD)
        check(all(s.device == home for s in pmesh._local_slots(CARD, None)),
              f"14 worker {pid}: slots not on {home}")
        train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
        pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES),
                                   seed=17)
        out = {}
        for family, cls in HOSTROLE_FAMILIES.items():
            model = cls(USERS, ITEMS, K_EMB, WD)
            params = model.init_params(torch.Generator().manual_seed(0),
                                       device=CARD)
            eng = engine(model, params, train, damping=DAMPING)
            out[f"{family}_warm_s"] = np.asarray(hostrole_warm(eng, pts))
            svc = InfluenceService(engine=eng, config=hostrole_config(
                host_role=(pid, 2, os.path.join(work, family)),
                host_merge_timeout_s=HOSTROLE_MERGE_S))
            reset_counts()
            t0 = time.perf_counter()
            got = svc.run(hostrole_requests(pts))
            out[f"{family}_drain_s"] = np.asarray(time.perf_counter() - t0)
            counted = launch_counts()
            out[f"{family}_launches"] = np.asarray(
                [counted[SOURCES[family]], counted[SEGMENT_SOURCE]])
            out[f"{family}_recoveries"] = np.asarray(
                svc.rollup()["host_loss_recoveries"])
            out.update({f"{family}_{k}": v
                        for k, v in hostrole_answers(got).items()})
            del svc, eng
            # 14d: the sharded engine's params through the checkpoint
            mesh = D.make_hybrid_mesh(model_parallel=2, device=CARD)
            check(D.spans_processes(mesh) and dict(mesh.shape) == {
                "data": 2, "model": 2}, f"14d worker {pid}: mesh {mesh}")
            se = engine(model, params, train, damping=DAMPING, mesh=mesh,
                        shard_tables=True)
            before = se.query_batch(pts[:BATCHES[-1]])
            path = os.path.join(work, f"ckpt-{family}")
            t0 = time.perf_counter()
            co.save(path, se.params, step=1)
            out[f"{family}_save_s"] = np.asarray(time.perf_counter() - t0)
            zeros = engine(model, {k: torch.zeros_like(v)
                                   for k, v in params.items()}, train,
                           damping=DAMPING, mesh=mesh, shard_tables=True)
            t0 = time.perf_counter()
            got_params, _, step = co.load(path, zeros.params)
            out[f"{family}_restore_s"] = np.asarray(time.perf_counter() - t0)
            check(step == 1, f"14d worker {pid}: step {step}")
            del zeros
            again = engine(model, SH.whole_params(got_params, model),
                           train, damping=DAMPING, mesh=mesh,
                           shard_tables=True).query_batch(pts[:BATCHES[-1]])
            out[f"{family}_ckpt_before"] = before._packed
            out[f"{family}_ckpt_after"] = again._packed
            out[f"{family}_ckpt_ihvp"] = np.stack([before.ihvp, again.ihvp])
            del se, again
            gc.collect()
            torch.cuda.empty_cache()
        np.savez(os.path.join(work, f"proc.{pid}.npz"), **out)
    finally:
        D.shutdown()
    return 0


def count_calls(obj, name: str) -> list:
    """Replace ``obj.name`` by a wrapper that records each call."""
    calls, real = [], getattr(obj, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    setattr(obj, name, spy)
    return calls


def hostrole_processes(engines, pts, work: str) -> tuple[dict, dict]:
    """14a (the two processes, then host 1's restart here) and 14d (the
    processes' checkpoints); the in-process service over the whole
    stream runs while they work. Returns (results by family and the
    pair's wall, that service's answers by family)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*HOSTROLE_WORKER_CMD, HOSTROLE_WORKER, str(p), str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for p in (0, 1)]
    want, single_s, warm_s = {}, {}, {}
    try:
        for family, (eng, _) in engines.items():
            warm_s[family] = hostrole_warm(eng, pts)
            svc = InfluenceService(engine=eng, config=hostrole_config())
            t1 = time.perf_counter()
            want[family] = hostrole_answers(svc.run(hostrole_requests(pts)))
            single_s[family] = time.perf_counter() - t1
        logs = [p.communicate(timeout=HOSTROLE_WORKER_S)[0].decode()
                for p in procs]
    except subprocess.TimeoutExpired:
        logs = ["timed out"] * 2
    finally:
        for p in procs:  # a crashed worker leaves its peer waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, text in zip(procs, logs):
        check(p.returncode == 0, f"14a: a worker failed ({p.returncode}):\n"
              + text[-4000:])
    got = [dict(np.load(os.path.join(work, f"proc.{p}.npz"))) for p in (0, 1)]
    out = {"wall_s": wall}
    for family, (eng, _) in engines.items():
        for p, g in enumerate(got):
            same_answers({k: g[f"{family}_{k}"] for k in want[family]},
                         want[family], f"{family} 14a process {p}")
            check(int(g[f"{family}_recoveries"]) == 0,
                  f"{family} 14a process {p} adopted a shard")
            check(g[f"{family}_launches"].min() > 0,
                  f"{family} 14a: process {p} launched "
                  f"{g[f'{family}_launches'].tolist()} (score, Hessian)")
            check(g[f"{family}_ckpt_after"].tobytes()
                  == g[f"{family}_ckpt_before"].tobytes()
                  and g[f"{family}_ckpt_ihvp"][0].tobytes()
                  == g[f"{family}_ckpt_ihvp"][1].tobytes(),
                  f"{family} 14d process {p}: the restored params' query is "
                  "not bitwise the saved engine's")
        check(got[0][f"{family}_ckpt_before"].tobytes()
              == got[1][f"{family}_ckpt_before"].tobytes(),
              f"{family} 14d: the two processes' queries differ")
        # host 1 restarted against the same journals: no recompute
        svc = InfluenceService(engine=eng, config=hostrole_config(
            host_role=(1, 2, os.path.join(work, family)),
            host_merge_timeout_s=0.0))
        calls = count_calls(eng, "query_many")
        try:
            t1 = time.perf_counter()
            again = hostrole_answers(svc.run(hostrole_requests(pts)))
            resume_s = time.perf_counter() - t1
        finally:
            del eng.query_many
        check(not calls, f"{family} 14a: the restarted host 1 called "
              f"query_many {len(calls)} time(s)")
        same_answers(again, want[family], f"{family} 14a restarted host 1")
        out[family] = {
            "drain_s": [float(g[f"{family}_drain_s"]) for g in got],
            "single_drain_s": single_s[family],
            "warm_s": [float(g[f"{family}_warm_s"]) for g in got],
            "single_warm_s": warm_s[family],
            "launches": [g[f"{family}_launches"].tolist() for g in got],
            "resume_s": resume_s,
            "save_s": [float(g[f"{family}_save_s"]) for g in got],
            "restore_s": [float(g[f"{family}_restore_s"]) for g in got]}
        log(f"{family} 14a: two host roles (gloo pair on loopback, each "
            f"initialize(local_device_ids=[0])) served {HOSTROLE_N} requests "
            f"at {HOSTROLE_BATCH} a batch bitwise one in-process service; "
            f"drains {out[family]['drain_s'][0]:.3f} / "
            f"{out[family]['drain_s'][1]:.3f} s against one process's "
            f"{single_s[family]:.3f} s (after a first query of 16 pairs: "
            f"{out[family]['warm_s'][0]:.3f} / {out[family]['warm_s'][1]:.3f}"
            f" s, here {warm_s[family]:.3f} s); launches (score, Hessian) "
            f"{out[family]['launches']}; host 1 restarted: no query_many "
            f"call, {resume_s:.3f} s")
        log(f"{family} 14d: (2, 2) row-sharded params across the two "
            f"processes saved in {out[family]['save_s'][0]:.3f} / "
            f"{out[family]['save_s'][1]:.3f} s, restored in "
            f"{out[family]['restore_s'][0]:.3f} / "
            f"{out[family]['restore_s'][1]:.3f} s; query_batch"
            f"({BATCHES[-1]}) from them bitwise the saved engine's")
    log(f"14a/14d: the pair's wall {wall:.1f} s (start-up included; the "
        "in-process services ran meanwhile)")
    return out, want


def hostrole_adoption(family: str, eng, pts, work: str, want) -> dict:
    """14b: host 0 alone, its peer's shard adopted after the merge
    budget; bitwise, one recovery."""
    svc = InfluenceService(engine=eng, config=hostrole_config(
        host_role=(0, 2, work), host_merge_timeout_s=HOSTROLE_ADOPT_S))
    reset_counts()
    t0 = time.perf_counter()
    got = hostrole_answers(svc.run(hostrole_requests(pts)))
    seconds = time.perf_counter() - t0
    counted = launch_counts()
    same_answers(got, want, f"{family} 14b")
    check(svc.rollup()["host_loss_recoveries"] == 1,
          f"{family} 14b: host_loss_recoveries "
          f"{svc.rollup()['host_loss_recoveries']}")
    check(counted[SOURCES[family]] > 0 and counted[SEGMENT_SOURCE] > 0,
          f"{family} 14b: kernels not launched: {counted}")
    log(f"{family} 14b: host 0 alone adopted host 1's shard after its "
        f"{HOSTROLE_ADOPT_S} s merge budget: {seconds:.3f} s for the drain, "
        "bitwise, host_loss_recoveries 1")
    return {"seconds": seconds, "launches": counted}


def hostrole_shrink(family: str, eng, train, pts, want) -> dict:
    """14c: HOST_LOST at serve.dispatch on 4 virtual slots over 2 virtual
    hosts: the mesh drops a whole host, bitwise the meshless service."""
    with pmesh.virtual_devices(4):
        mesh = pmesh.make_mesh(4, device=CARD)
        hosts = {int(s.id): k // 2 for k, s in enumerate(mesh.devices.flat)}
        with pmesh.virtual_hosts(hosts):
            me = mesh_engine(eng, train, mesh)
            svc = InfluenceService(engine=me, config=hostrole_config(
                mesh=mesh))
            reset_counts()
            t0 = time.perf_counter()
            with inject.active(inject.Fault(sites.SERVE_DISPATCH, at=1,
                                            kind=taxonomy.HOST_LOST),
                               strict=True, validate=True):
                got = hostrole_answers(svc.run(hostrole_requests(pts)))
            seconds = time.perf_counter() - t0
            counted = launch_counts()
            kept = [int(s.id) for s in svc.mesh.devices.flat]
            roll = svc.rollup()
            del me, svc
    same_answers({k: v for k, v in got.items() if k != "batch_ids"},
                 {k: v for k, v in want.items() if k != "batch_ids"},
                 f"{family} 14c")
    check(kept == [0, 1] and roll["host_loss_recoveries"] == 1
          and roll["device_loss_recoveries"] == 0,
          f"{family} 14c: kept slots {kept}, {roll['host_loss_recoveries']} "
          f"host / {roll['device_loss_recoveries']} device recoveries")
    check(counted[SOURCES[family]] > 0 and counted[SEGMENT_SOURCE] > 0,
          f"{family} 14c: kernels not launched: {counted}")
    got_counts = recovery_counts()
    check(not got_counts["retries"] and not got_counts["resets"]
          and not got_counts["cpu_rung_batches"],
          f"{family} 14c: a recovery ladder beyond the shrink: {got_counts}")
    obs.REGISTRY.reset()  # the injected loss, counted
    log(f"{family} 14c: HOST_LOST at batch 1 of {HOSTROLE_N} requests on 4 "
        "virtual slots over 2 virtual hosts: the mesh dropped host 1's two "
        f"slots at once, every answer bitwise the meshless service, "
        f"{seconds:.3f} s")
    return {"seconds": seconds, "launches": counted}


def drive_hostroles(engines, train, pts, workdir: str) -> dict:
    """Phase 14: 14a and 14d in two processes (the in-process service
    meanwhile), then 14b and 14c per model."""
    obs.REGISTRY.reset()
    t0 = time.perf_counter()
    procs, want = hostrole_processes(engines, pts, workdir)
    out = {"14a_14d_seconds": time.perf_counter() - t0,
           "pair_wall_s": procs.pop("wall_s")}
    no_recovery("14a")
    for family, (eng, _) in engines.items():
        t0 = time.perf_counter()
        out[family] = {
            "14a": procs[family],
            "14b": hostrole_adoption(family, eng, pts,
                                     os.path.join(workdir, f"{family}-14b"),
                                     want[family])}
        no_recovery(f"14b {family}")
        out[family]["14c"] = hostrole_shrink(family, eng, train, pts,
                                             want[family])
        out[family]["14b_14c_seconds"] = time.perf_counter() - t0
    return out


def hostroles_only(engines, train, pts, card: str, kind: str,
                   t_main: float) -> int:
    """``--phase 14``: after the build and the set-up, phase 14 alone, its
    results on the ``perf`` line."""
    with tempfile.TemporaryDirectory() as workdir:
        t14 = time.perf_counter()
        perf = {"card": card, "hostroles": drive_hostroles(engines, train,
                                                           pts, workdir)}
    perf["phase14_seconds"] = time.perf_counter() - t14
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"phase 14: {perf['phase14_seconds']:.1f} s; chip_smoke --phase 14 "
        f"total: {perf['total_seconds']:.1f} s")
    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def hostrole_launches(row: dict, source: str) -> dict:
    """A kernel's launches in phase 14: each process's in 14a, and 14b's
    and 14c's."""
    at = 1 if source == SEGMENT_SOURCE else 0
    return {"14a": [n[at] for n in row["14a"]["launches"]],
            "14b": row["14b"]["launches"][source],
            "14c": row["14c"]["launches"][source]}


# -- phase 15: the chaos engine and the observability CLI ---------------
# scenarios of the smoke battery that serve queries (every one but the
# device-free selftest and train_resume, which only trains), and those
# whose queries take the sampled rung (certificate and λ_min kernels)
CHAOS_QUERYING = ("query_cache", "serve_stream", "serve_stream_mesh",
                  "device_loss_recovery", "host_loss_recovery",
                  "factor_bank", "update_while_serving",
                  "unlearn_while_serving", "serve_brownout",
                  "serve_multitenant")
CHAOS_SAMPLED = ("serve_brownout",)
CHAOS_SOAK = ("--soak", "0:1", "--all_kinds")
# seed 0's full-domain draws kill 10 of the 12 scenarios at
# chaos.scenario before they query; seed 2's fire OOM and deadline kills
# inside the workloads (train, dispatch, update, apply)
CHAOS_KILLS = ("--soak", "2:3", "--all_kinds")
CHAOS_KILL_KINDS = (taxonomy.OOM, taxonomy.HOST_OOM, taxonomy.DEADLINE)


def scenario_engines(scen) -> list:
    """Every ``InfluenceEngine`` a chaos scenario holds (its own, its
    ``FIAModel``'s, and their delegates), once each."""
    roots = [v for v in vars(scen).values() if isinstance(v, InfluenceEngine)]
    fm = getattr(scen, "fm", None)
    if fm is not None:
        roots += list(fm._engines.values())
    out = []
    for e in roots:
        for d in (e, *e._delegates_deep()):
            if all(d is not o for o in out):
                out.append(d)
    return out


def chaos_cli_run(argv: list, name: str, workdir: str) -> tuple:
    """``python -m fia_tpu_torch.cli.chaos <argv> --scenario <name>`` in
    process, on the card: returns (exit code, the printed summary, the
    reports it ran, its scenario instance, this run's kernel launches)."""
    made, reports = [], []
    orig_engine, orig_finish = chaos_cli._engine, chaos_cli._finish

    def engine_(args):
        made.append(orig_engine(args))
        return made[-1]

    def finish(reps, eng, label):
        reports.extend(reps)
        return orig_finish(reps, eng, label)

    chaos_cli._engine, chaos_cli._finish = engine_, finish
    buf = io.StringIO()
    try:
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = chaos_cli.main([*argv, "--scenario", name, "--quiet",
                                 "--workdir", workdir, "--backend", CARD])
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        chaos_cli._engine, chaos_cli._finish = orig_engine, orig_finish
    return rc, json.loads(buf.getvalue()), reports, \
        made[-1]._scenarios.get(name), launches


def fired_kinds(report) -> list:
    return [kind for _, _, kind in report.record.report["fired"]]


def chaos_run_checks(name: str, rep, what: str) -> dict:
    """A report's shrink accounting: each fired ``device_lost`` took one
    slot off the mesh and each ``host_lost`` one host, in a run that
    ended; no run degraded to one device."""
    ev = rep.record.events
    check(not any(e.get("event") == "mesh_skipped" for e in ev),
          f"{what}: {name} logged mesh_skipped")
    kinds = fired_kinds(rep)
    out = {"fired": rep.record.report["fired"],
           "error": rep.record.error}
    if rep.record.error is not None:
        return out
    after = {e["event"]: e for e in ev
             if e.get("event") in ("mesh_after", "hosts_after")}
    lost = kinds.count(taxonomy.DEVICE_LOST) + kinds.count(taxonomy.HOST_LOST)
    if lost:
        host = HostLossRecoveryScenario
        hosts = host.NHOSTS if name == host.name else 0
        per = host.NDEV // host.NHOSTS if hosts else 1  # slots a loss drops
        check("mesh_after" in after, f"{what}: {name}: a loss fired "
              f"({kinds}) but no mesh_after event")
        check(after["mesh_after"]["shrunk"] == per * lost,
              f"{what}: {name}: {lost} loss(es) fired but the mesh shrank "
              f"by {after['mesh_after']['shrunk']} slots")
        if hosts:
            check(after["hosts_after"]["hosts"] == hosts - lost,
                  f"{what}: {name}: {lost} host loss(es) but "
                  f"{after['hosts_after']['hosts']} hosts left")
    out.update({k: {kk: vv for kk, vv in e.items() if kk != "event"}
                for k, e in after.items()})
    return out


def chaos_battery(argv: list, workdir: str, label: str) -> dict:
    """Every smoke scenario through ``cli.chaos <argv>`` on the card, one
    invocation a scenario (its kernel launches counted alone): every
    report passed, every engine built resolved the ``cuda`` score
    stage, the shrink accounting, and the launch gates."""
    out = {}
    for name in chaos_cli.SMOKE_SCENARIOS:
        t0 = time.perf_counter()
        rc, summary, reports, scen, launches = chaos_cli_run(
            argv, name, os.path.join(workdir, name))
        secs = time.perf_counter() - t0
        check(rc == 0 and summary["failed"] == [],
              f"{label}: {name} failed: "
              + json.dumps(summary["failed"], default=str)[:4000])
        check(len(reports) == summary["runs"] and all(
            r.passed for r in reports), f"{label}: {name}: a report failed")
        engines = scenario_engines(scen)
        variants = sorted({e._kernel_variant for e in engines})
        check(name in ("selftest", "train_resume") or (
            engines and variants == ["cuda"]),
            f"{label}: {name}: engines resolved {variants}, not cuda")
        runs = [chaos_run_checks(name, r, label) for r in reports]
        if name in CHAOS_QUERYING:
            for src in (SOURCES["mf"], SEGMENT_SOURCE):
                check(launches[src] > 0, f"{label}: {name} queried but "
                      f"launched no {src}")
        if name in CHAOS_SAMPLED:
            for src in (CERT_SOURCE, EIGMIN_SOURCE):
                check(launches[src] > 0, f"{label}: {name} took the "
                      f"sampled rung but launched no {src}")
        errors = [r.record.error for r in reports if r.record.error]
        check(all(e.get("kind") is not None for e in errors),
              f"{label}: {name}: an unclassified error: {errors}")
        kills = [k for r in reports for k in fired_kinds(r)
                 if k in CHAOS_KILL_KINDS]
        out[name] = {"runs": summary["runs"], "seconds": secs,
                     "engines": len(engines), "variants": variants,
                     "launches": launches, "run_checks": runs,
                     "errors": [e["kind"] for e in errors],
                     "kill_kinds_fired": kills}
        log(f"{label} {name}: {summary['runs']} runs passed in {secs:.1f} s; "
            f"{len(engines)} engines {variants}; launches {launches}; "
            f"fired {[r['fired'] for r in runs]}"
            + (f"; classified errors {out[name]['errors']}" if errors
               else ""))
    return out


def chaos_traced(workdir: str) -> dict:
    """15c: ``serve_stream`` on the card untraced and traced, the outcome
    bytes equal (the chaos oracle's own comparison); the traced run's
    JSONL through ``cli.obs``: ``report`` exits 0 with every chain
    complete, ``trace`` and ``prom`` parse."""
    scen = ServeStreamScenario(device=CARD)
    jsonl = os.path.join(workdir, "serve_stream.jsonl")

    def run(traced: bool, sub: str, path):
        obs.TRACER.reset()
        obs.configure(trace=traced)
        scen.metrics_path = path
        try:
            return scen.run(os.path.join(workdir, sub), [])
        finally:
            obs.configure(trace=False)
            obs.TRACER.reset()
            scen.metrics_path = None

    off = run(False, "off", None)
    on = run(True, "on", jsonl)
    diffs = chaos_oracles.compare_outcomes(off, on)
    check(not diffs, f"15c: tracing changed the outcome bytes: {diffs[:4]}")
    n_ok = sum(1 for k, v in on.items()
               if k.endswith(":status") and str(v).startswith("ok/"))
    audit = cli_obs.audit_chains(read_spans(jsonl))
    check(audit["incomplete"] == 0 and audit["ok_complete"] == n_ok,
          f"15c: chains {audit} for {n_ok} ok answers")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_report = cli_obs.main(["report", jsonl])
    check(rc_report == 0 and "incomplete: 0" in buf.getvalue(),
          f"15c: cli.obs report exited {rc_report}: {buf.getvalue()[:500]}")
    trace_path = os.path.join(workdir, "trace.json")
    with contextlib.redirect_stderr(io.StringIO()):
        rc_trace = cli_obs.main(["trace", jsonl, "--out", trace_path])
    with open(trace_path) as f:
        events_ = json.load(f)["traceEvents"]
    check(rc_trace == 0 and events_, "15c: cli.obs trace gave no events")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_prom = cli_obs.main(["prom", jsonl])
    samples = [ln for ln in buf.getvalue().splitlines()
               if ln and not ln.startswith("#")]
    check(rc_prom == 0 and samples and all(
        math.isfinite(float(ln.rsplit(" ", 1)[1])) or "Inf" in ln
        for ln in samples), "15c: cli.obs prom did not parse")
    out = {"outcome_entries": len(on), "ok": n_ok, "chains": audit,
           "trace_events": len(events_), "prom_samples": len(samples)}
    log(f"15c: serve_stream traced == untraced ({len(on)} entries); "
        f"chains {audit['ok_complete']} ok + {audit['rejected_complete']} "
        f"rejected complete; {len(events_)} trace events, {len(samples)} "
        "prom samples")
    return out


def drive_chaos(workdir: str) -> dict:
    """Phase 15: 15a the smoke battery, 15b one full-domain seed a
    scenario, 15c tracing and ``cli.obs``, 15d a full-domain seed whose
    kill kinds fire inside the workloads."""
    out = {}
    for key, argv in (("15a", ["--smoke"]), ("15b", list(CHAOS_SOAK)),
                      ("15d", list(CHAOS_KILLS))):
        t0 = time.perf_counter()
        out[key] = chaos_battery(argv, os.path.join(workdir, key), key)
        out[key + "_seconds"] = time.perf_counter() - t0
        log(f"{key}: {out[key + '_seconds']:.1f} s")
    kills = [k for row in out["15d"].values() for k in row["kill_kinds_fired"]]
    check(kills, "15d: no kill kind fired inside a workload")
    t0 = time.perf_counter()
    out["15c"] = chaos_traced(os.path.join(workdir, "15c"))
    out["15c_seconds"] = time.perf_counter() - t0
    return out


def chaos_only(card: str, kind: str, t_main: float) -> int:
    """``--phase 15``: after the build, phase 15 alone (it needs no
    ML-1M set-up), its results on the ``perf`` line."""
    with tempfile.TemporaryDirectory() as workdir:
        t15 = time.perf_counter()
        perf = {"card": card, "chaos": drive_chaos(workdir)}
    perf["phase15_seconds"] = time.perf_counter() - t15
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"phase 15: {perf['phase15_seconds']:.1f} s; chip_smoke --phase 15 "
        f"total: {perf['total_seconds']:.1f} s")
    log("perf " + json.dumps(perf, sort_keys=True, default=str))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def chaos_launches(chaos: dict, source: str) -> dict:
    """A kernel's launches in phase 15, by battery and scenario."""
    return {key: {name: row["launches"][source]
                  for name, row in chaos[key].items()}
            for key in ("15a", "15b", "15d")}


# -- phase 16: the lint, the CPU reference engines, the native data path --
PARITY_Q = 8  # held-out queries a model
# minibatch steps a model at bench.py's settings: a budget of about 30 s
# of training each on an H100 alone (MF 397, NCF 187 steps/s there)
PARITY_STEPS = {"mf": 12_000, "ncf": 6_000}
PARITY_MIN = 0.99  # tests/test_parity.py's bar, Spearman and Pearson
REF_THREADS = 2
# bench.py's converged reference solve (its parity protocol)
REF_TIGHT = {"avextol": 1e-8, "maxiter": 2000}
REF_ENGINES = {"mf": TorchRefMFEngine, "ncf": TorchRefNCFEngine}
NATIVE_T = 256
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def cpu_model() -> str:
    """The host CPU's model name and its count of logical CPUs, from
    ``/proc/cpuinfo``: where the model name reads "unknown" (a
    virtualised host can say so), its vendor, family, model and stepping
    identify the part."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if not key and info:
                    break  # the first processor's block is enough
                info.setdefault(key, value.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if not name or name.lower() == "unknown":
        ident = " ".join(f"{k} {info[k]}" for k in ("cpu family", "model",
                                                    "stepping") if k in info)
        name = " ".join(x for x in (info.get("vendor_id"), ident) if x) or (
            platform.processor() or platform.machine())
    return f"{name}, {os.cpu_count()} logical CPUs"


def drive_lint() -> dict:
    """16a, first half: the port's lint over its own tree, in a process of
    its own as a user runs it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fia_tpu_torch.analysis.lint", "--self-check",
         "--json"], cwd=REPO_DIR, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"16a: fialint --self-check exited "
          f"{proc.returncode}: {proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    check(doc["ok"] and not doc["findings"],
          f"16a: fialint findings: {doc['findings']}")
    out = {"seconds": secs, "files_checked": doc["files_checked"],
           "suppressed": sum(doc["suppressed_counts"].values()),
           "suppressed_counts": doc["suppressed_counts"]}
    log(f"16a: fialint --self-check exit 0 in {secs:.2f} s: "
        f"{out['files_checked']} files, 0 findings, {out['suppressed']} "
        f"findings under justified suppressions {out['suppressed_counts']}")
    return out


def launch_wrappers(path: str) -> set[str]:
    """Names of the functions of a kernel module that count its kernel's
    launches (``common.count_launch``)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    return {fn.name for fn in ast.walk(tree)
            if isinstance(fn, ast.FunctionDef) and any(
                isinstance(c, ast.Call)
                and getattr(c.func, "attr", None) == "count_launch"
                for c in ast.walk(fn))}


def capture_binding(captured) -> dict:
    """16a, second half: every kernel module whose launches 16b recorded
    into a CUDA graph has its launch wrapper registered as a capture scope
    of the lint's config."""
    registered = {(e[0], e[1])
                  for e in lint_config.REGISTERED_CAPTURE_ENTRY_POINTS}
    out = {}
    for mod, n in zip(K.KERNEL_MODULES, captured):
        if n == 0:
            continue
        rel = os.path.relpath(mod.__file__, REPO_DIR).replace(os.sep, "/")
        wrappers = sorted(launch_wrappers(mod.__file__))
        check(bool(wrappers), f"16a: {rel} counts no launch")
        for name in wrappers:
            check((rel, name) in registered, f"16a: {rel}:{name} launched "
                  "into a captured graph but is no capture scope of "
                  "analysis/config.py")
        out[rel] = {"captured": n, "wrappers": wrappers}
    check(bool(out), "16a: 16b recorded no kernel launch into a graph")
    log(f"16a: captured kernel modules bound to the lint's capture scopes: "
        f"{out}")
    return out


def float64_scores(ref64, u: int, i: int) -> np.ndarray:
    """A query's scores from an exact float64 solve: the reference
    engine's block Hessian column by column (its HVP on each unit
    vector), ``np.linalg.solve``, then its per-row gradients."""
    rows = ref64.related(u, i)
    v = ref64.test_vector(u, i)
    H = np.stack([ref64._hvp(u, i, rows, e) for e in np.eye(v.shape[0])],
                 axis=1)
    ihvp = np.linalg.solve(H, v)
    return np.array([ihvp @ ref64._row_grad(u, i, int(r)) for r in rows]
                    ) / len(rows)


def parity_family(family: str, cls, train, pts) -> tuple[dict, tuple]:
    """16b for one model: train, query on the card, hold against the
    reference engine on the CPU. Returns the report and the kernel
    launches captured into graphs meanwhile."""
    dev = torch.device(CARD)
    x = torch.as_tensor(train.x).to(dev)
    y = torch.as_tensor(train.y).to(dev)
    model = cls(USERS, ITEMS, K_EMB, WD)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    steps = PARITY_STEPS[family]
    tr = Trainer(model, TrainConfig(FULL_BATCH, steps, TRAIN_LR, seed=0),
                 device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tr.fit(tr.init_state(params), x, y)
    torch.cuda.synchronize()
    rep = {"steps": steps, "train_seconds": time.perf_counter() - t0,
           "loss_full": full_loss(model, state.params, x, y)}
    check(math.isfinite(rep["loss_full"]), f"16b {family}: non-finite loss")
    eng = engine(model, state.params, train, damping=DAMPING,
                 solver="direct")
    check(eng.active_kernel_variant() == "cuda",
          f"16b {family}: the engine did not pick cuda")
    q = pts[:PARITY_Q]
    before, cap0 = launch_counts(), K.captured_counts()
    res = eng.query_batch(q)
    torch.cuda.synchronize()
    after, cap1 = launch_counts(), K.captured_counts()
    rep["launches"] = {k: after[k] - before[k] for k in after}
    captured = tuple(b - a for a, b in zip(cap0, cap1))
    for name in (SOURCES[family], SEGMENT_SOURCE):
        check(rep["launches"][name] > 0, f"16b {family}: {name} was not "
              f"launched ({rep['launches']})")
    rep["card_ms_batch"] = wall_ms(lambda: eng.query_batch(q))
    rep["card_ms_one"] = wall_ms(lambda: eng.query_batch(q[:1]))

    host = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    ref_cls = REF_ENGINES[family]
    threads = torch.get_num_threads()
    torch.set_num_threads(REF_THREADS)
    try:
        ref = ref_cls(host, train.x, train.y, weight_decay=WD,
                      damping=DAMPING)
        tight = ref_cls(host, train.x, train.y, weight_decay=WD,
                        damping=DAMPING, **REF_TIGHT)
        ref64 = ref_cls(host, train.x, train.y, weight_decay=WD,
                        damping=DAMPING, dtype=torch.float64)
        rows = []
        for t, (u, i) in enumerate(q):
            u, i = int(u), int(i)
            t0 = time.perf_counter()
            ref_scores, ref_rows = ref.query(u, i)
            ref_s = time.perf_counter() - t0
            check(np.array_equal(res.related_of(t), ref_rows),
                  f"16b {family}: query {t} ({u}, {i}): related sets differ")
            got = res.scores_of(t).astype(np.float64)
            tight_scores = tight.query(u, i)[0]
            row = {"u": u, "i": i, "rows": int(len(ref_rows)),
                   "ref_seconds": ref_s,
                   "rho": spearman(got, ref_scores),
                   "r": metrics.pearson(got, ref_scores),
                   "rho_tight": spearman(got, tight_scores),
                   "r_tight": metrics.pearson(got, tight_scores)}
            if min(row["rho"], row["r"]) < PARITY_MIN:
                # which side is off: both against an exact float64 solve
                exact = float64_scores(ref64, u, i)
                row["float64"] = {
                    "rho_card": spearman(got, exact),
                    "r_card": metrics.pearson(got, exact),
                    "rho_ref": spearman(ref_scores, exact),
                    "r_ref": metrics.pearson(ref_scores, exact)}
                f64 = row["float64"]
                check(min(f64["rho_card"], f64["r_card"]) >= PARITY_MIN
                      and min(f64["rho_ref"], f64["r_ref"]) < PARITY_MIN,
                      f"16b {family}: query {t} misses the bar against the "
                      f"reference's defaults and the card is the side off: "
                      f"{row}")
                row["reference_behaviour"] = "fmin_ncg early stop"
            check(min(row["rho_tight"], row["r_tight"]) >= PARITY_MIN,
                  f"16b {family}: query {t} misses the bar against the "
                  f"converged reference: {row}")
            rows.append(row)
            log(f"16b {family} query {t} ({u}, {i}), {row['rows']} rows: "
                f"rho {row['rho']:.6f} r {row['r']:.6f} (converged "
                f"{row['rho_tight']:.6f} / {row['r_tight']:.6f}); the "
                f"reference {ref_s:.3f} s" + (
                    f"; float64: card {row['float64']}"
                    if "float64" in row else ""))
    finally:
        torch.set_num_threads(threads)
    rep["queries"] = rows
    rep["ref_seconds_per_query"] = float(np.mean([r["ref_seconds"]
                                                  for r in rows]))
    rep["card_ms_per_query"] = rep["card_ms_batch"] / PARITY_Q
    rep["min_rho"] = min(r["rho"] for r in rows)
    rep["min_r"] = min(r["r"] for r in rows)
    log(f"16b {family}: {steps} steps in {rep['train_seconds']:.1f} s (full "
        f"loss {rep['loss_full']:.4f}); {PARITY_Q} queries at rho >= "
        f"{rep['min_rho']:.6f}, r >= {rep['min_r']:.6f} against the "
        f"reference; CPU baseline {rep['ref_seconds_per_query']:.3f} s a "
        f"query ({REF_THREADS} threads, {cpu_model()}); the card "
        f"{rep['card_ms_per_query']:.3f} ms a query in the batch of "
        f"{PARITY_Q} ({rep['card_ms_batch']:.3f} ms), "
        f"{rep['card_ms_one']:.3f} ms one alone; launches {rep['launches']}")
    return rep, captured


def drive_native(train, pts) -> dict:
    """16c: the native parse and CSR against numpy's, and an engine on
    the native index against one on the numpy index, bit for bit."""
    check(native.available(), "16c: the native library did not build or "
          "load (the numpy fallback is a failure here)")
    out = {"library": os.path.basename(native.library_path())}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ml-1m.train.rating")
        save_tsv(train, path)
        t0 = time.perf_counter()
        got = native.parse_tsv(path)
        out["parse_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = native.parse_tsv_numpy(path)
        out["parse_numpy_s"] = time.perf_counter() - t0
    for name, a, b in zip(("users", "items", "ratings"), got, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"16c: native parse differs from np.loadtxt in {name}")
    check(np.array_equal(got[0], train.x[:, 0])
          and np.array_equal(got[1], train.x[:, 1])
          and np.array_equal(got[2], train.y),
          "16c: the parsed ratings are not the set-up's")
    for name, ids, n in (("users", train.x[:, 0], USERS),
                         ("items", train.x[:, 1], ITEMS)):
        t0 = time.perf_counter()
        csr = native.build_csr(ids, n)
        out[f"csr_{name}_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = native.build_csr_numpy(ids, n)
        out[f"csr_{name}_numpy_s"] = time.perf_counter() - t0
        check(all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(csr, ref)),
              f"16c: native CSR over {name} differs from the stable argsort")
    model = MF(USERS, ITEMS, K_EMB, WD)
    params = model.init_params(torch.Generator().manual_seed(0), device=CARD)
    eng_native = engine(model, params, train, damping=DAMPING)
    old = os.environ.get("FIA_NATIVE")
    os.environ["FIA_NATIVE"] = "0"
    try:
        check(not native.available(), "16c: FIA_NATIVE=0 kept the library")
        eng_numpy = engine(model, params, train, damping=DAMPING)
    finally:
        if old is None:
            del os.environ["FIA_NATIVE"]
        else:
            os.environ["FIA_NATIVE"] = old
    check(all(np.array_equal(a, b) for a, b in zip(
        eng_native.index.postings(), eng_numpy.index.postings())),
        "16c: the native index's postings differ from numpy's")
    q = pts[:NATIVE_T]
    a, b = eng_native.query_batch(q), eng_numpy.query_batch(q)
    same = np.array_equal(a.ihvp, b.ihvp) and all(
        np.array_equal(a.scores_of(t).view(np.uint32),
                       b.scores_of(t).view(np.uint32))
        for t in range(len(q)))
    check(same, "16c: the native index's query_batch differs from the "
          "numpy index's")
    out["query_batch_bitwise"] = len(q)
    log(f"16c: native {out['library']}: parse {out['parse_native_s']:.3f} s "
        f"against np.loadtxt {out['parse_numpy_s']:.3f} s; CSR users "
        f"{out['csr_users_native_s']:.4f} / {out['csr_users_numpy_s']:.4f} "
        f"s, items {out['csr_items_native_s']:.4f} / "
        f"{out['csr_items_numpy_s']:.4f} s (native / numpy), all equal; "
        f"query_batch({len(q)}) bitwise on either index")
    return out


def drive_phase16() -> dict:
    """Phase 16 on an ML-1M set-up of its own: 16a's lint, 16b, 16a's
    binding of the captured kernels, 16c."""
    out = {"lint": drive_lint()}
    t0 = time.perf_counter()
    train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
    pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES), seed=17)
    out["setup_seconds"] = time.perf_counter() - t0
    parity, captured = {"cpu": cpu_model(), "threads": REF_THREADS}, None
    for family, cls in (("mf", MF), ("ncf", NCF)):
        t0 = time.perf_counter()
        parity[family], cap = parity_family(family, cls, train, pts)
        parity[family]["seconds"] = time.perf_counter() - t0
        captured = cap if captured is None else tuple(
            a + b for a, b in zip(captured, cap))
    out["parity"] = parity
    out["lint"]["capture_binding"] = capture_binding(captured)
    t0 = time.perf_counter()
    out["native"] = drive_native(train, pts)
    out["native"]["seconds"] = time.perf_counter() - t0
    no_recovery("16")
    return out


def phase16_only(card: str, kind: str, t_main: float) -> int:
    """``--phase 16``: after the build, phase 16 alone, its results on the
    ``perf`` line."""
    t16 = time.perf_counter()
    perf = {"card": card, **drive_phase16()}
    perf["phase16_seconds"] = time.perf_counter() - t16
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"phase 16: {perf['phase16_seconds']:.1f} s; chip_smoke --phase 16 "
        f"total: {perf['total_seconds']:.1f} s")
    log("perf " + json.dumps(perf, sort_keys=True, default=str))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    t_main = time.perf_counter()
    # -- phase 1: the card ---------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # the padded path's learned memory envelope goes to a file of this
    # run's own, not into the checkout
    envelope_dir = tempfile.TemporaryDirectory()
    os.environ["FIA_MEMLIMIT_CACHE"] = os.path.join(envelope_dir.name,
                                                    "mem.json")
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build --------------------------------------------------
    build = {"nvcc": nvcc_version(), "seconds": {}, "ptxas": {}}
    log(f"nvcc: {build['nvcc']}")
    secs = common.build([*SOURCES.values(), SEGMENT_SOURCE, CERT_SOURCE,
                         EIGMIN_SOURCE])
    for name, s in secs.items():
        log(f"build {name}: {s:.2f} s")
        build["seconds"][name] = s
        build["ptxas"][name] = ptxas_report(common.build_log(name))
        for fn, r in build["ptxas"][name].items():
            log(f"  ptxas: {fn}: {r.get('registers')} registers, spill "
                f"stores {r.get('spill_stores')} B, loads "
                f"{r.get('spill_loads')} B")

    if sys.argv[1:] == ["--phase", "15"]:
        return chaos_only(card, kind, t_main)
    if sys.argv[1:] == ["--phase", "16"]:
        return phase16_only(card, kind, t_main)

    # -- main paths' set-up (ML-1M shape, seeded weights) ---------------
    t0 = time.perf_counter()
    train = synthesize_ratings(USERS, ITEMS, ROWS, seed=0)
    pts = sample_heldout_pairs(train.x, USERS, ITEMS, max(BATCHES), seed=17)
    engines = {f: setup_engines(cls(USERS, ITEMS, K_EMB, WD), train)
               for f, cls in (("mf", MF), ("ncf", NCF))}
    index = engines["mf"][0].index
    longest = index.max_related_count()
    longest_rq2 = int(index.counts_batch(pts[:RQ2_Q]).max())
    log(f"set-up: {time.perf_counter() - t0:.2f} s; longest related set "
        f"{longest} rows (RQ2's 64 queries: {longest_rq2})")
    if sys.argv[1:] == ["--phase", "12"]:
        return mesh_only(engines, train, pts, card, kind, t_main)
    if sys.argv[1:] == ["--phase", "13"]:
        return sharded_only(engines, train, pts, card, kind, t_main)
    if sys.argv[1:] == ["--phase", "14"]:
        return hostroles_only(engines, train, pts, card, kind, t_main)

    # -- phases 3 and 4, per model: kernels, then main path --------------
    checked, driven = {}, {}
    seg_checked = check_segment(engines, pts, longest, longest_rq2)
    for family, (eng, plain) in engines.items():
        checked[family] = check_kernel(family, eng, pts)
        driven[family] = drive(family, eng, plain, pts)
    no_recovery("3-4")

    # -- the split-invariance probe, the any-split and graph phases ----
    t_split = time.perf_counter()
    probed = probe(train, pts)
    for name, row in probed.items():
        for layout, r in row.items():
            if layout == "solve_isolated":
                check(not any(r["engine"].values()), f"probe {name}: the "
                      "engine's batched LU alone changes bits with the "
                      f"batch size: {r}")
            else:
                check(r["first_differing_stage"] is None,
                      f"probe {name} [{layout}]: stage "
                      f"{r['first_differing_stage']} differs by batch split: "
                      f"{r['queries_differing']}")
    split, graphs = {}, {}
    for family, (eng, _) in engines.items():
        split[family] = drive_any_split(family, eng, pts)
        graphs[family] = drive_graphs(family, eng, train, pts)
    split_s = time.perf_counter() - t_split
    log(f"probe, any-split and graph phases: {split_s:.1f} s")
    no_recovery("S")

    # -- phase 5: times --------------------------------------------------
    perf = {"card": card, "build": build, "models": {},
            "segment_kernel_vs_plain": seg_checked, "probe": probed,
            "split_and_graph_seconds": split_s}
    rows, seg_rows = [], {}
    for family, (eng, _) in engines.items():
        batches, last, seg_last = measure(family, eng, train, pts)
        perf["models"][family] = {
            "batches": batches,
            "kernel_vs_plain": checked[family],
            "any_split": split[family],
            "graphs": graphs[family],
            **driven[family],
        }
        seg_rows[family] = seg_last
        rows.append({
            "name": SOURCES[family],
            "route": "cuda",
            "source": f"fia_tpu_torch/influence/kernels/csrc/{SOURCES[family]}.cu",
            "replaces": REPLACES[family],
            "launches": driven[family]["launches"],
            "max_abs_err": checked[family]["max_abs_err"],
            "ms": last["ms"], "plain_ms": last["plain_ms"],
            "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
            "library_ms": None,
            "shape": last["shape"],
        })
    # the Hessian kernel's row: NCF's (d = 64) times, pieces and scratch at
    # T = 1024; launches (two a call) of both models' main paths; plain_ms
    # the row-order scatter form by graph replay, pieced_ms the kernel's
    # bit-for-bit reference (events, host waits a step)
    seg_last = seg_rows["ncf"]
    rows.append({
        "name": SEGMENT_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{SEGMENT_SOURCE}.cu",
        "replaces": SEGMENT_REPLACES,
        "launches": sum(d["segment_launches"] for d in driven.values()),
        "max_abs_err": seg_checked["max_abs_err"],
        "max_err_of_max_abs_H": seg_checked["max_err_of_max_abs_H"],
        "launches_per_call": 2,
        "ms": seg_last["ms"], "plain_ms": seg_last["plain_ms"],
        "bound_ms": seg_last["bound_ms"], "bound_by": seg_last["bound_by"],
        "library_ms": None,
        "onehot_ms": seg_last["onehot_ms"],
        "pieced_ms": seg_last["pieced_ms"],
        "piece_rows": seg_last["piece_rows"], "pieces": seg_last["pieces"],
        "scratch_mb": seg_last["scratch_mb"],
        "shape": seg_last["shape"],
        "mf": seg_rows["mf"],
    })

    no_recovery("5")

    # -- phase 6: the padded per-query program -------------------------
    for family, (eng, _) in engines.items():
        perf["models"][family]["padded"] = drive_padded(family, eng, train,
                                                        pts)
    no_recovery("6")

    # -- phase 7: training, checkpoints, RQ1 and RQ2 -------------------
    t7 = time.perf_counter()
    classes = {"mf": MF, "ncf": NCF}
    seg_by_path, trained_states = {}, {}
    for row, (family, (eng, _)) in zip(rows, engines.items()):
        out = {"card_vs_cpu": train_small(family, classes[family])}
        trained_states[family], out["full"] = train_full(family, eng.model,
                                                         train, pts)
        trained = engine(eng.model, trained_states[family].params, train,
                         damping=DAMPING)
        out["rq1"] = drive_rq1(family, trained, train, pts)
        out["rq2"] = drive_rq2(family, classes[family], train, pts)
        perf["models"][family]["train"] = out
        row["launches_by_path"] = {
            "query_batch": row["launches"],
            "rq1": out["rq1"]["score_kernel_launches"],
            "rq2_query_batch": {k: v["query_batch"]["score_kernel_launches"]
                                for k, v in out["rq2"].items()},
            "rq2_query_many": {k: v["query_many"]["score_kernel_launches"]
                               for k, v in out["rq2"].items()},
        }
        seg_by_path[family] = {
            "query_batch": driven[family]["segment_launches"],
            "rq1": out["rq1"]["segment_launches"],
            "rq2_query_batch": {k: v["query_batch"]["segment_launches"]
                                for k, v in out["rq2"].items()},
            "rq2_query_many": {k: v["query_many"]["segment_launches"]
                               for k, v in out["rq2"].items()},
        }
    rows[-1]["launches_by_path"] = seg_by_path
    perf["phase7_seconds"] = time.perf_counter() - t7
    log(f"phase 7: {perf['phase7_seconds']:.1f} s")
    no_recovery("7")

    # -- phase 8: the rest of the solver ladder ------------------------
    t8 = time.perf_counter()
    ladder_dir = tempfile.TemporaryDirectory()
    ladder = perf["ladder"] = drive_ladder(engines, train, pts,
                                           ladder_dir.name)
    for row, family in zip(rows, engines):
        lad = ladder[family]
        row["launches_by_path"]["sampled"] = lad["sampled"]["launches"][
            SOURCES[family]]
        row["launches_by_path"]["bank"] = lad["bank"]["launches"][
            SOURCES[family]]
    for family in engines:
        lad = ladder[family]
        seg_by_path[family]["sampled"] = lad["sampled"]["launches"][
            SEGMENT_SOURCE]
        seg_by_path[family]["bank"] = lad["bank"]["launches"][SEGMENT_SOURCE]
        seg_by_path[family]["bank_build"] = lad["bank"]["build_launches"][
            SEGMENT_SOURCE]
    # the certificate kernel's row: NCF's (d = 64) times at T = 1024, MF's
    # beside them; launches of both models' sampled rungs (three a call)
    cert = ladder["ncf"]["certificate"]
    rows.append({
        "name": CERT_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{CERT_SOURCE}.cu",
        "replaces": CERT_REPLACES,
        "launches": sum(ladder[f]["sampled"]["launches"][CERT_SOURCE]
                        for f in engines),
        "max_abs_err": max(ladder[f]["certificate"]["max_abs_err"]
                           for f in engines),
        "max_err_of_max_abs": max(ladder[f]["certificate"][
            "max_err_of_max_abs"] for f in engines),
        "launches_per_call": kcert.LAUNCHES_PER_CALL,
        "ms": cert["ms"], "plain_ms": cert["plain_ms"],
        "bound_ms": cert["bound_ms"], "bound_by": cert["bound_by"],
        "library_ms": None,
        "shape": cert["shape"],
        "mf": ladder["mf"]["certificate"],
        "ptxas": build["ptxas"][CERT_SOURCE],
        "launches_by_path": {
            path: {f: ladder[f][path]["launches"][CERT_SOURCE]
                   for f in engines} for path in ("sampled", "bank")},
    })
    # the λ_min kernel's row: NCF's (d = 64) times at T = 1024, MF's
    # beside them; launches of both models' sampled rungs (one a call)
    eig = ladder["ncf"]["eigmin"]
    rows.append({
        "name": EIGMIN_SOURCE,
        "route": "cuda",
        "source": f"fia_tpu_torch/influence/kernels/csrc/{EIGMIN_SOURCE}.cu",
        "replaces": EIGMIN_REPLACES,
        "launches": sum(ladder[f]["sampled"]["launches"][EIGMIN_SOURCE]
                        for f in engines),
        "max_abs_err": max(ladder[f]["eigmin"]["max_abs_err"]
                           for f in engines),
        "c_max": max(ladder[f]["eigmin"]["c_max"] for f in engines),
        "launches_per_call": keig.LAUNCHES_PER_CALL,
        "ms": eig["ms"][str(BATCHES[-1])], "plain_ms": eig["plain_ms"],
        "bound_ms": eig["bound_ms"], "bound_by": eig["bound_by"],
        "library_ms": eig["library_ms"],
        "shape": eig["shape"],
        "mf": ladder["mf"]["eigmin"],
        "synthetic": ladder["eigmin_synthetic"],
        "small": ladder["eigmin_small"],
        "sampled_wide": ladder["sampled_wide"],
        "ptxas": build["ptxas"][EIGMIN_SOURCE],
        "launches_by_path": {
            path: {f: ladder[f][path]["launches"][EIGMIN_SOURCE]
                   for f in engines} for path in ("sampled", "bank")},
    })
    perf["phase8_seconds"] = time.perf_counter() - t8
    log(f"phase 8: {perf['phase8_seconds']:.1f} s")
    no_recovery("8")

    # -- phase 9: recovery and observability ---------------------------
    t9 = time.perf_counter()
    perf["recovery"] = drive_recovery(engines, train, pts)
    perf["phase9_seconds"] = time.perf_counter() - t9
    log(f"phase 9: {perf['phase9_seconds']:.1f} s")

    # -- phases 12-16 in processes of their own, beside 10 and 11 ------
    t_apart = time.perf_counter()
    apart_dir = tempfile.TemporaryDirectory()
    apart = {n: start_apart(n, apart_dir.name) for n in APART_PHASES}
    try:
        perf.update(phases_10_11(engines, train, pts, envelope_dir,
                                 ladder_dir, trained_states, rows,
                                 seg_by_path))
        got = {n: finish_apart(n, h) for n, h in apart.items()}
    finally:
        for h in apart.values():
            stop_apart(h)
    apart_dir.cleanup()
    perf["phases_10_16_seconds"] = time.perf_counter() - t_apart
    log(f"phases 10-16: {perf['phases_10_16_seconds']:.1f} s (12, 13, 14, "
        "15 and 16 in processes of their own beside 10 and 11)")
    by_name = {row["name"]: row for row in rows}

    # -- phase 12: the data-axis device mesh ----------------------------
    mesh = perf["mesh"] = got[12]["mesh"]
    perf["phase12_seconds"] = got[12]["phase12_seconds"]
    for family in engines:
        by_name[SOURCES[family]]["launches_by_path"]["mesh"] = mesh_launches(
            mesh[family], SOURCES[family])
        seg_by_path[family]["mesh"] = mesh_launches(mesh[family],
                                                    SEGMENT_SOURCE)

    # -- phase 13: row-sharded tables and the multi-process runtime -----
    sharded = perf["sharded"] = got[13]["sharded"]
    perf["phase13_seconds"] = got[13]["phase13_seconds"]
    for family in engines:
        by_name[SOURCES[family]]["launches_by_path"]["sharded"] = \
            sharded_launches(sharded[family], SOURCES[family])
        seg_by_path[family]["sharded"] = sharded_launches(sharded[family],
                                                          SEGMENT_SOURCE)

    # -- phase 14: host roles, host-loss shrink, sharded checkpoints ----
    hostroles = perf["hostroles"] = got[14]["hostroles"]
    perf["phase14_seconds"] = got[14]["phase14_seconds"]
    for family in engines:
        by_name[SOURCES[family]]["launches_by_path"]["hostroles"] = \
            hostrole_launches(hostroles[family], SOURCES[family])
        seg_by_path[family]["hostroles"] = hostrole_launches(
            hostroles[family], SEGMENT_SOURCE)

    # -- phase 15: the chaos engine and the observability CLI ----------
    chaos = perf["chaos"] = got[15]["chaos"]
    perf["phase15_seconds"] = got[15]["phase15_seconds"]
    for family in engines:
        by_name[SOURCES[family]]["launches_by_path"]["chaos"] = \
            chaos_launches(chaos, SOURCES[family])
    seg_by_path["mf"]["chaos"] = chaos_launches(chaos, SEGMENT_SOURCE)
    for name in (CERT_SOURCE, EIGMIN_SOURCE):
        by_name[name]["launches_by_path"]["chaos"] = {
            "mf": chaos_launches(chaos, name)}

    # -- phase 16: the lint, the CPU reference engines, native data ----
    for key in ("lint", "parity", "native", "phase16_seconds"):
        perf[key] = got[16][key]
    for family in engines:
        by_name[SOURCES[family]]["launches_by_path"]["parity"] = \
            perf["parity"][family]["launches"][SOURCES[family]]
        seg_by_path[family]["parity"] = perf["parity"][family]["launches"][
            SEGMENT_SOURCE]
    ladder_dir.cleanup()
    envelope_dir.cleanup()
    perf["total_seconds"] = time.perf_counter() - t_main
    log(f"chip_smoke total: {perf['total_seconds']:.1f} s")

    log("perf " + json.dumps(perf, sort_keys=True))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def phases_10_11(engines, train, pts, envelope_dir, ladder_dir,
                 trained_states, rows, seg_by_path) -> dict:
    """Phases 10 and 11 in this process; their launches go into
    ``rows``' and ``seg_by_path``'s ``launches_by_path``. Returns their
    entries of the ``perf`` line."""
    perf = {}
    t10 = time.perf_counter()
    os.environ["FIA_MEMLIMIT_CACHE"] = os.path.join(envelope_dir.name,
                                                    "mem.json")
    serving = perf["serving"] = drive_serving(engines, train, pts,
                                              ladder_dir.name)
    by_name = {row["name"]: row for row in rows}
    for family in engines:
        a = serving[family]["10a"]["launches"]
        b = serving[family]["10b"]["launches"]
        by_name[SOURCES[family]]["launches_by_path"]["serve"] = {
            "direct": a[SOURCES[family]], "brownout": b[SOURCES[family]]}
        seg_by_path[family]["serve"] = {"direct": a[SEGMENT_SOURCE],
                                        "brownout": b[SEGMENT_SOURCE]}
    for name in (CERT_SOURCE, EIGMIN_SOURCE):
        by_name[name]["launches_by_path"]["serve"] = {
            f: serving[f]["10b"]["launches"][name] for f in engines}
    perf["phase10_seconds"] = time.perf_counter() - t10
    log(f"phase 10: {perf['phase10_seconds']:.1f} s")

    # -- phase 11: streaming updates and the audit subsystem ------------
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as stream_dir:
        perf["stream"], perf["audit"] = drive_stream_audit(
            trained_states, train, pts, stream_dir)
    for family in engines:
        a = perf["stream"][family]["launches"]
        b = perf["audit"][family]["sweep"]["launches"]
        by_name[SOURCES[family]]["launches_by_path"].update(
            stream=a[SOURCES[family]], audit=b[SOURCES[family]])
        seg_by_path[family].update(stream=a[SEGMENT_SOURCE],
                                   audit=b[SEGMENT_SOURCE])
    perf["phase11_seconds"] = time.perf_counter() - t11
    log(f"phase 11: {perf['phase11_seconds']:.1f} s")
    return perf


# phases run in processes of their own (``--phase N``) beside phases 10
# and 11, each given APART_S seconds
APART_PHASES, APART_S = (12, 13, 14, 15, 16), 300


def start_apart(n: int, workdir: str) -> tuple:
    """Start ``chip_smoke.py --phase n``, its output to a file."""
    path = os.path.join(workdir, f"phase{n}.log")
    out = open(path, "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phase", str(n)],
                            stdout=out, stderr=subprocess.STDOUT)
    return proc, out, path


def stop_apart(handle) -> None:
    """End a phase's process if it still runs."""
    proc, out, _ = handle
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    out.close()


def finish_apart(n: int, handle) -> dict:
    """Wait for phase ``n``'s process, print its output (each line
    prefixed ``[n]``), require exit 0, and return its ``perf`` line."""
    proc, out, path = handle
    try:
        proc.wait(timeout=APART_S)
    except subprocess.TimeoutExpired:
        stop_apart(handle)
    out.close()
    with open(path, errors="replace") as f:
        text = f.read().splitlines()
    for line in text:
        log(f"[{n}] {line}")
    check(proc.returncode == 0, f"phase {n} (its own process) exited "
          f"{proc.returncode}: " + "\n".join(text[-20:]))
    perf = [ln for ln in text if ln.startswith("perf ")]
    check(len(perf) == 1, f"phase {n} printed {len(perf)} perf lines")
    return json.loads(perf[0][len("perf "):])


if __name__ == "__main__":
    if sys.argv[1:2] == [SHARD_WORKER]:
        sys.exit(shard_worker(sys.argv[2:]))
    if sys.argv[1:2] == [HOSTROLE_WORKER]:
        sys.exit(hostrole_worker(sys.argv[2:]))
    sys.exit(main())
