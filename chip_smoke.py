#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, all started together) and prints the seconds;
   beside the build, compiles ``fused_morsel.cu``, ``fused_batch.cu``,
   ``segmented_agg.cu``, ``radix_histogram.cu`` and ``hash_table.cu``
   with ``-Xptxas -v`` and fails unless every variant of
   ``fused_morsel_kernel``, ``fused_batch_kernel``,
   ``segmented_sum_kernel``, ``segmented_minmax_kernel``,
   ``partition_histogram_kernel`` and ``hash_probe_multi_kernel`` (the
   whole-row expansion probe) has a 0-byte stack frame and no spill;
3. checks each kernel against its plain PyTorch version on the card, on
   the shapes the main path gives it, with the tolerance stated beside each:
   the segmented sums on ``_SEG_CASES`` (sorted and unsorted 1M-row
   morsels, counts, every id dead, n % 4 of 1-3, bases 1-3 rows past a
   16-byte boundary, G = 8192 and 8193, 2^24 sorted rows with a dead tail;
   int32 bit-exact, float32 within 1e-4 * sum(|v|) + 1e-6) and on the
   calls a run makes (Q1's first of each at G = 16, Q3's first part and
   first merge, Q17's first int merge, captured with the other kernels'
   inputs below, and the stacked float call of one serving batch at 32
   lanes), the fused program on Q1's and Q6's stages (on a
   1M-row lineitem morsel and on its views ``_FUSED_VIEWS``: 999,999 rows,
   3 rows, and a one-row offset that leaves every column base unaligned),
   and the kernels of one SF 1 run of the 22 queries on the inputs that
   run gives them, captured by wrapping the kernel functions:
   every ``build_table`` of Q3 and Q10 bit-identical, every standalone
   ``hash_probe`` call of the 22 queries and the first morsel of each
   fused probe of Q3 and Q10 exact (the first also on the views of
   ``_FUSED_VIEWS``);
   ``block_prefix_sum`` on the first compaction mask of Q9 and of Q22,
   every ``segmented_minmax`` call (Q2's grouped min) and every
   ``hash_probe_multi`` call (Q9's and Q20's expansion probes), and the
   fused program on Q22's ``PrefixCode`` stages, each exact; plus builds
   of synthetic keys, each
   bit-identical and naming its route (the passes below ``table_size``
   rows, the rounds from it): many duplicate keys with invalid rows and
   -1 keys, unique keys at the same size, an all-ghost cluster, ghosts
   inside the run of a key of 200 rows, a cluster that wraps slot T - 1
   -> 0, one home of 1,000 rows, and ``n >= table_size`` with the valid
   rows below and above it (after phase 9, so that no profile precedes
   its own: the unique and the duplicate build must launch the same
   kernels, ``ceil(log2 T / 8) + 3``, copy nothing back and not wait for
   the card); the probes of ``_PROBE_CASES`` (tables of 1-8 slots, runs
   across 32-byte sectors and wrapping at T, max_probes ending inside a
   sector, keys -1, views) and 1 << 20 probe keys with hits, misses and
   -1 keys, each exact; the expansion probe's ``_MULTI_CASES`` (a table
   with some 8 rows a key probed at m of 1, 2, 3, 4, 8, 9 and 300, each
   route of the row store; runs that wrap; max_probes 1-7; keys -1;
   views) and min/max's ``_MINMAX_CASES`` (NaNs of both signs, +-inf,
   +-0 and subnormals; random float bit patterns; int32 extremes; Q2's
   shape at G = 2^20; G of 1, 8192 and 8193; views), each through the
   wrapper and through the C entry on outputs filled with a pattern
   first (a count, slot or group left unwritten shows), exact;
4. times each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (``library_ms``), with CUDA events over warm
   runs, and computes each kernel's bound from its inputs (for the join
   kernels, from the table sectors this run's keys reach; for the
   segmented sums, every id, the values of the rows with a live id and the
   G results); after phase 9, the segmented rows' device time from
   ``torch.profiler``: the kernel's (``device_ms``) and the whole call's,
   the wrapper's zero fill included (``call_device_ms``);
5. generates TPC-H at SF 1 with the port's ``dbgen`` and runs all 22
   queries (``queries.build_query``) through
   ``Session(device="cuda", batch_rows=1 << 20).execute``, with the launch
   counters set to 0 just before each query and read just after: Q6, Q1, Q3
   and Q10 are held to the launch counts their morsel counts imply, and
   every query must launch exactly the all-queries kernels the reference's
   pallas run reaches (``hash_probe_multi`` in Q9 and Q20,
   ``block_prefix_sum`` in Q9, Q11, Q15, Q20 and Q22, ``segmented_minmax``
   in Q2; Q15's max has no group key, so it is a plain reduction in both
   engines) and Q22 the fused program; each result must match the same
   plan run by ``Session(device="cpu")`` at SF 1 (exact for keys, counts
   and bytes columns, rtol 2e-3 for floats);
6. captures the kernels' inputs of one W = 4 run of the 22 queries with
   ``ICIExchange`` (by wrapping the kernel functions, as phase 3 does) and
   holds against their plain versions, exact, every ``build_table`` and
   fused probe call of Q3 and Q7 (the worker-local build and probe sides
   that the exchange hands them), every standalone ``hash_probe``,
   ``hash_probe_multi`` and ``segmented_minmax`` call, and the exchange's
   metadata pass (``partition_histogram``: pids and
   counts) on every repartition's inputs and on ``_PART_CASES`` (each W
   of 1-8 at n of 0, 5, 100,003 and 2^22 rows a source, a bytes key,
   three keys, views 1-3 rows off, bool, int64 and float keys, every row
   dead, one row, sources of unequal sizes); then the standalone
   ``radix_histogram`` on the bins of Q3's first ``l_orderkey``
   repartition, plus edge cases (no ids; ids -1, P and INT32_MAX; P of 1,
   4, 16, 8192 and 8193; a count of ids that is no multiple of the
   block);
7. runs all 22 queries planned for four workers
   (``queries.build_query(q, catalog, num_workers=4)``) through
   ``Session(num_workers=4, batch_rows=1 << 20)`` with ``ICIExchange`` on
   the same SF 1 catalog, the launch counters set to 0 just before each
   query and read just after: each result must equal that query's W = 1
   result of phase 5 (the comparison of phase 5), ``radix_histogram`` must
   launch once per repartition of the query's ``exchanges`` stats, and no
   byte may pass through the host; then Q1, Q3, Q5, Q6, Q13 and Q22 through
   ``HostExchange``, each equal to its ICI result, with bytes staged
   through the host and no ``radix_histogram`` launch. Each query prints
   its wall times (three runs after one warm-up), its exchange rounds,
   rows and bytes moved, and its launches. Then the storage phase
   (``--storage`` runs it alone, with the build, and prints no ok line):
   (a) ``dbgen.write_dataset`` at SF 1 (seed 19940729,
   ``chunks=8``: lineitem chunks of 750,079 rows) into a temporary
   directory, removed when the script exits, with its seconds and bytes on
   disk; ``storage_catalog`` over the files and ``Catalog.from_numpy`` over
   the rows it wrote, in their order; (b) the 22 queries at W = 1 from the
   files through ``Session(device="cuda", batch_rows=1 << 20)``, each equal
   to the same plan over the in-memory rows on the card, with a line per
   query and table (chunks, chunks skipped, ``bytes_read``,
   ``bytes_transferred``, ``read_seconds``, ``wait_seconds``,
   ``prefetch_overlap``), the walls of both runs (three after a warm-up
   each) and the launches of the files' first timed run, the counters set
   to 0 just before it: the
   all-queries kernels of phase 5 reached by the same queries,
   ``bytes_read`` equal to the sizes of the chunk files each scan's zone
   maps leave, Q6 skipping a lineitem chunk and launching the fused
   program once per surviving chunk; (c) ``storage_catalog(...,
   skip_with_stats=False)`` and ``Session(streaming=False)``, each of the
   22 equal to (b), skipping nothing, the synchronous walls beside the
   streaming ones; (d) Q1, Q3, Q5 and Q6 planned for four workers, each
   equal to its W = 1 result, no byte through the host; (e) lineitem
   written by ``write_paged_table(row_groups=8)``: Q6 on a catalog whose
   lineitem is a ``PagedTableSource`` equal to (b), and one full
   synchronous scan of Q6's lineitem columns (read and copied to the card)
   in each format, in turns, its seconds and GB/s; (f) Q1 and Q3 with
   ``host_only_ops={"HashAggregation"}``: equal results and bytes through
   the host round trip; (g) one step of a lineitem chunk read into
   pinned buffers by ``readinto`` (as the scan reads) and by a memmap copy,
   host seconds, then copied by ``morsel_to_device``, timed with CUDA
   events, from those pinned buffers and from pageable ones. Then the SQL
   phase (``--sql`` runs it alone, with the build, and prints no ok line;
   alone it first runs each query's hand-built plan for (a) to compare
   with), on the in-memory SF 1 catalog through ``Session(device="cuda",
   batch_rows=1 << 20).sql``: (a) the 20 texts of ``tpch.sqltext`` at
   W = 1, each equal to phase 5's result of the query on their common
   columns (Q10 and Q18, restated in the texts, as multisets of rows under
   ``compare``'s tolerance), their walls (three after a warm-up) and
   lowering seconds beside phase 5's walls, then ``_YEAR_LIKE`` (no TPC-H
   text fuses an EXTRACT(YEAR)) against its CPU run; (b) the 20 at W = 4
   with ``ICIExchange``, each equal to its W = 1 SQL result; (c) Q1, Q2,
   Q3, Q4, Q6, Q14, Q16 and Q22 with ``ExecutionOptions(optimize=False)``,
   with their fused launches (Q4's and Q22's fused runs carry a bytes
   column through, Q2's part filter, an IN of 30 values, is split over
   several programs): at SF 1 each equal to the same raw plan on the CPU
   and, but for Q2, Q3 and Q16 (``_SQL_RAW_CAPPED``: a raw aggregation
   keeps the default 4096 groups and drops the rest, in the reference as
   here, and these pass it at SF 1), to its optimized result; at SF 0.01
   (``_RAW_SF``) each equal to its optimized result; (d) the fused
   instructions against ``apply_stages``, exact: YEAR over every year
   start +-1 from 1969 to 2040 and the int32 extremes, BYTESMATCH over
   ``_MATCH_ROWS`` (a row of spaces, parts that would overlap, a part at
   the very end, a part longer than the row) with each of
   ``_MATCH_CASES``, then the fused run of ``_YEAR_LIKE`` on the first 1M
   rows of orders and SQL Q16's BYTESMATCH run (its supplier morsel), each
   also on the views of ``_FUSED_VIEWS``, each timed with its plain
   version and its bound (the bytes it must move, a bytes column's n x W
   among them); (e) the composite join of ``_COMPOSITE`` (two key columns
   that do not pack into 31 bits at SF 1), whose count must equal the
   exact count numpy computes from the catalog's columns and whose build
   must take the sorted-key path (one ``fallback_probe`` in
   ``kernel_dispatch``); (f) 32 texts of ``_SERVING_TEXT`` (EXTRACT(YEAR)
   and LIKE, differing only in literals) submitted with batching on, each
   equal to its solo run, at least one stacked batch and no fallback, a
   repeated text served from the result cache under its ``sql=`` key, and
   the stacked program at 32 lanes on the first 1M rows of orders (and
   n = 999,999, a one-row offset) exact against
   ``apply_batched_stages``, timed. After phase 9 the three timed
   programs' device ms from ``torch.profiler``. Then the out-of-core
   phase (``--spill`` runs it alone, with the build, and prints no ok
   line; alone it first runs each query in memory to compare with), on
   the same SF 1 catalog at ``batch_rows = 1 << 20``: (a) each of the 22
   at W = 1 under ``device_budget`` = a quarter of its estimated
   footprint (``footprint_budget``, the reference's sweep rule), then Q3
   under a sixteenth (``_FORCED_SHARE``: at SF 1 a quarter of Q3's leaves
   its joins inside their reservations), each a warm-up run (the grace
   joins' histogram calls captured) and three timed runs with the launch
   counters set to 0 just before the first and read just after: each
   result equal to phase 5's, Q18 spilled under the quarter and Q3 under
   the sixteenth (``_MUST_SPILL``), ``radix_histogram`` launched once per
   ``_grace_pids`` call (its ``partition`` dispatch); a line a run with
   the spill counters,
   the grace joins and their partitions, the walls beside phase 5's and
   the card's peak allocated bytes under the budget and in memory; (b)
   the forced Q3 again with a host budget one byte below the most spilled
   bytes its host tier held at once in (a) and a spill directory of its
   own: disk spills and restores above 0,
   no more bytes read back than written, the directory empty after; (c)
   Q3, Q5 and Q18 planned for four workers under a quarter and a
   sixty-fourth of their W = 4 footprint (``_W4_SHARES``), run as in (a),
   each equal to its W = 1 result, with the exchanges staged through the
   spill store: at least one grace join forms at W = 4, each of its
   histogram calls counts its ``W * P`` (worker, partition) bins, and
   those calls join (a)'s in the bit-exact check below; (d) Q18 submitted with
   ``SchedulerConfig(memory_budget=...)`` at a quarter of its footprint:
   admitted with a spill plan (``spill_admitted == 1``) and right; (e) Q6
   with a host budget of 1 B: right, the budget's ``in_use`` back at 0.
   The standalone ``radix_histogram`` is held bit-exact to its plain
   version on every captured grace call (a row count that is no multiple
   of the 512-id block among them) and on ``_HIST_CASES``, then timed on
   the largest captured call (row 8s of the kernels line: its bound is
   the ids read once and the counts written once, its ``library_ms`` one
   ``torch.bincount`` of the same ids; its device ms after phase 9).
   Then the adaptive phase (``--adaptive`` runs it alone, with the
   build, and prints no ok line), on the same catalog, each query on a
   ``FeedbackStore`` of its own (another query's observation of a shared
   subtree would make its first plan warm), the port's numpy oracle of
   the 22 computed after the timed runs in ``_ORACLE_PROCS`` forked
   processes:
   (a) each of the 22 at W = 1: the cold plan, fingerprint-equal to the
   static ``build_query`` plan, run once; the warm plan re-optimized from
   its observations, one warm-up run and three timed runs, beside three
   runs each of the static plan with feedback off and on (their
   difference is the observation's cost; the harvest's host time after
   its one read-back, ``op_seconds["FeedbackHarvest"]``, beside it), with
   the launch counters set to
   0 just before the cold run and the first timed warm run and read just
   after; warm equal to cold (exact for keys, counts and bytes, rtol 2e-3
   for floats) and both equal to the oracle; a line a query with the sums
   of ``max_groups`` and of hash-table slots cold and warm, the joins
   whose distribution, orientation or ``max_matches`` changed, and
   ``kernel_dispatch`` cold and warm (warm ``fallback_probe`` at most
   cold's, no warm capacity above the cold node's), and a line of the
   sums over the 22; the warm runs must launch every kernel the cold runs
   launched; (b) the same at W = 4 (``ICIExchange``): cold once, warm
   three times, each warm result equal to warm W = 1; (c) Q3 submitted
   three times to a ``feedback=True`` scheduler with ``cache_results=
   False``: a plan-cache miss, a miss again (the q-error check evicted
   the cold entry), a hit, all equal; (d) ``estimate_memory`` cold and
   warm for the 22 in (a)'s lines, warm at most cold, then Q3's static
   plan and its warm plan under the forced Q3's budget (a sixteenth of
   the static footprint) through ``_spill_run``, the spill counters and
   walls side by side, both equal to (a)'s warm run;
8. serving on the same SF 1 catalog: (a) ``fused_batch_program`` at 32
   lanes, for the three small-query programs of
   ``benchmarks/bench_concurrency.py`` (point lookup on orders, filtered
   global aggregate with a projection and low-cardinality group-by on
   lineitem, distinct literals a lane), against ``apply_batched_stages`` on
   the first lineitem or orders morsel, exact (columns, validity, masks),
   plus n = 0, one lane, 64, 65 and 128 lanes (ceil(B / 64) launches, one
   a run of the kernel's 64-lane word), a morsel of 999,999 rows and one at
   a one-row offset, then timed;
   (b) eight client threads submit 96 such queries (32 a shape) to
   ``Session(device="cuda").submit`` with ``SchedulerConfig(batching=True,
   max_batch=32, max_concurrency=8, cache_results=False,
   batch_window_ms=10, memory_budget=8 << 30)``: each result must equal the
   same plan's solo ``execute`` on the card (six also its CPU run), at
   least three stacked batches must form, none may fall back, and
   ``fused_batch_program`` must launch once per stacked morsel step; it
   prints the walls and q/s of the batched run, of the same workload with
   ``batching=False`` and of a serial ``execute`` loop, p50 and p99
   latency and the mean batch size; (c) four clients submit the dashboard
   of ``examples/serve_queries.py`` (Q1, Q6, Q14, Q3, unoptimized) twice
   each without batching: each result must equal its phase 5 result, and
   every repeat must come from the result cache or coalesce;
   then the mesh phase (``--mesh`` runs it alone, with the build, and
   prints no ok line):
   (a) on ``EngineMesh([cuda:0])`` (``launch.mesh``: the staged
   all-to-all of ``ICIExchange(mesh=...)``, one card), the 22 queries at
   W = 4, each equal to the same plan off the mesh (the comparison of
   phase 5) and, in the full run, to its W = 1 result, with equal exchange
   fragments (rounds, rows and bytes moved), no byte through the host, one
   ``radix_histogram`` launch a repartition and every worker on
   ``cuda:0``, each run once to warm up and once timed with the launch
   counters set to 0 just before it and read just after (every kernel of
   the path but ``fused_batch_program`` and ``flash_attention`` must
   launch), its wall on and off the mesh; one more run of each on and off
   the mesh with CUDA events around every repartition's data phase (the
   staged layout, all-to-all and compaction against the fused gather),
   their ms and the rows each worker received (equal on and off); then
   W = 2 on ``_MESH_W2`` against the same plans off the mesh, and
   ``HostExchange`` on ``_MESH_HOST`` against the mesh's ICI results,
   bytes staged through the host and no ``radix_histogram`` launch; the
   device guard: ``partition_histogram`` on ``cuda:1`` tensors while
   ``cuda:0`` is current, exact against its plain version (on one card a
   line says it cannot run); (c) serving on the mesh: the 22 planned for
   W = 4 through a scheduler (``submit``, then ``gather``) from eight
   client threads off the mesh and on it, each result equal to its
   off-mesh ``execute``, then (b)'s 96-query workload at W = 1 with
   batching off the mesh and on the one-card mesh, each member equal to
   its off-mesh serving, at least one stacked batch, no fallback, each
   with its wall, q/s, p50, p99 and launches; (d) out of core on the
   mesh: the 22 at W = 4 under a quarter of their footprint off the mesh
   and on it, each equal to its in-memory result, the spill counters
   equal field for field (where the mesh's broadcast, the W tables end to
   end, changed a reservation: equal to an off-mesh run with the mesh's
   layout, ``ICIExchange(mesh=...)``), walls and the card's
   ``max_memory_allocated``; Q5 and Q18 under a sixty-fourth: grace joins
   form, every standalone histogram call on a card of the mesh, one
   launch a call, each bit-exact against its plain version; (e) adaptive
   execution on the mesh: the 22 at W = 4 cold then warm on a store of
   their own, off the mesh and on it, both mesh runs equal to the port's
   oracle (in the full run the adaptive phase's answers, else computed
   here), the stores' entries and the warm plans equal; Q3 submitted
   three times to a ``feedback=True`` scheduler: at W = 1 on the mesh
   miss, miss (evicted), hit, at W = 4 the same hits on the mesh as off
   it; (b) where there are two or more cards, the
   22 at W = 4 on a mesh of four cards (two where three are visible), each
   equal to its off-mesh result, every worker's output tables on its mesh
   device, with each pair's peer access and the bytes copied between
   cards, then (c)-(e) for Q3, Q5 and Q18 across those cards: served,
   under a quarter and a sixty-fourth (every restored partition back on
   the card it left, each histogram call on a card of the mesh, each
   card's ``max_memory_allocated``, the bytes copied between cards), cold
   then warm (the stores equal to (e)'s off the mesh); on one card a line
   says (b) did not run.
9. attention: ``flash_attention`` against its plain version (TF32 off) on
   edge cases (S = 128 with blocks 64 and 128, D = 40 and 1, B * H = 1 and
   96, S = 96 and 1; S 192 with block_k 128, S 256 with block_q 96 and
   D 257 refused), then driven
   through ``ops.flash_attention`` once a case, one launch each, at
   qwen2-1.5B's attention width (``[1, 12, 4096, 128]`` causal in float32
   and bfloat16, ``[1, 12, 32768, 128]`` causal in bfloat16, checked on
   heads 0 and 11), ``[1, 16, 4096, 64]`` full in bfloat16, ``[1, 16,
   1000, 64]`` full (a ragged S, no padding: the kernel masks the keys
   past S; q drawn around +1 and k around -1, so that a key past S left
   unmasked would take most of a row's weight) in both, and ``[1, 2,
   1024, D]`` causal for D = 160, 192 in both: float32 within 1e-4 at 4096
   and 2e-5 at 1024, bfloat16 within 2e-2, and every case within
   ``SCALED_ERROR_TOL`` of ``flash_attention.scaled_error``, the error in
   units of each row's own size (a fixed limit is as large as the outputs
   of a 32k row); one profiled call of each case names the kernels it ran,
   which must be ``attn_tf32x3_kernel`` in float32 and
   ``attn_wgmma_kernel`` in bfloat16, with ``attn_combine_kernel`` at D =
   160 and 192 (32 and 16 CTAs, which the kernels split over K); then the
   kernel, the plain version and ``scaled_dot_product_attention`` are
   timed, and the bound is operations at the card's dense bfloat16 rate,
   or in float32 three times the operations at its TF32 rate (3xTF32),
   with the FFMA bound printed beside it;
9b. the LM side, after phase 10 and every profile (then only 9c-9f)
   (a profile taken after it lost one kernel event of ten; ``--lm`` runs
   it alone after the build and prints its kernels line and the card
   line, and no ok line): ``repro_torch.models``
   at qwen2-1.5B's full ``CONFIG`` (28 layers, d_model 1536, vocab
   151,936; bfloat16 weights drawn on the card from a ``torch.Generator``
   seeded ``_LM_SEED``). (a) prefill of 8 prompts of 512 tokens with
   ``max_len`` 1024 and 64 greedy decode steps, after one warm-up at the
   same shapes and one prefill and decode step under torch's sync debug
   mode (which must report no host sync), with the launch counters set to
   0 just before the prefill and read just after it: ``flash_attention`` must launch once a layer
   and nothing else; every logit finite; the prefill's ms, the ms a decode
   step, tokens/s and ``torch.cuda.max_memory_allocated``. (b) ``forward``
   over each prompt and its first 64 generated tokens, at full depth: the
   prefill's logits and each decode step's equal its logits at that
   position within ``_LM_TOL`` (max |diff| <= atol + rtol * |forward|),
   the greedy tokens equal wherever forward's top two are further apart.
   (c) the card against the port on the CPU at full width and 2 layers,
   one set of weights made on the CPU and copied to the card: B 2, prompts
   of 128 and 200 tokens (200 a ragged S for the kernel), 8 decode
   steps fed the CPU's greedy tokens; logits within ``_LM_CPU_TOL``, each
   K/V cache entry within it times its head row's largest |entry|. (d) the
   first ``flash_attention`` call of (a)'s prefill, captured, against
   ``flash_attention_plain``: ``scaled_error`` within
   ``SCALED_ERROR_TOL``; then the kernel, the plain version and
   ``scaled_dot_product_attention`` timed at that shape ([8, 12, 512,
   128] bfloat16, causal) beside the bound: the
   ``flash_attention[lm qwen2_1_5b prefill]`` row of the kernels line, its
   launches those of (a)'s prefill. (e) prefill of 2 prompts of 512 and 4
   decode steps for phi4-mini, granite-3-8B, granite-34B and pixtral-12B
   (through ``embeds``, d_head 160) at full width and 2 layers: two
   launches a prefill, finite logits, the prefill and the decode steps
   against ``forward`` within ``_LM_TOL`` (pixtral's prefill only: its
   prompt is embeddings);
9c. training, after 9b (``--train`` runs it alone after the build and
   prints its kernels line and the card line, and no ok line): (a) a
   corpus table of ``_TRAIN_ROWS`` (16,777,216) synthetic tokens (``doc``,
   ``tok`` skewed towards small ids, ``quality``), registered with the
   port's ``Session`` on the card and filtered by ``quality > 0.2``
   through ``Session.execute``, which must launch ``fused_morsel_program``
   and return numpy's filter of the table; those tokens through
   ``TokenPipeline(device="cuda")`` (B 8, S 512, prefetch 2) into
   ``make_train_step(model, microbatches=2)`` at qwen2-1.5B's full
   ``CONFIG`` (weights drawn on the card, seed ``_TRAIN_SEED``): the
   memory reckoned from the parameters printed first, one warm-up step,
   one step under torch's sync debug mode (no host sync), then
   ``_TRAIN_STEPS`` timed steps (ms a step, tokens/s,
   ``max_memory_allocated``, each step's loss, lr and grad_norm, which
   must be finite), the launch counters set to 0 just before the query
   and read after the last step; the query's first fused call, kept, is
   held bit-identical to ``apply_stages`` and timed: the
   ``fused_morsel_program[train corpus]`` row of the kernels line. (b) the
   card against the port on the CPU at full width and 2 layers: one set
   of weights and one AdamW state at step 150 (seeded m and v) drawn on
   the card and copied to the CPU, one step of 2 microbatches at B 2, S 64
   (base lr 1e-2): the loss, grad_norm, every parameter, m and v within
   ``_TRAIN_TOL``, the differences computed on the card; then ``adamw_update`` alone on float32 tensors within
   1e-6 of each tensor's largest |value|. (c) the ``--full-100m`` config
   of ``examples/train_lm_torch.py`` (12 layers, d_model 768, vocab
   32,000) through ``TrainLoop``: 200 steps of 8 x 128 tokens with a
   checkpoint every 50 into a temporary directory (removed after),
   uninterrupted and with a failure at step 100: one restart, the final
   parameters equal within atol 1e-6, the last loss below the first;
9d. the MoE and hybrid families, after 9c (``--moe`` runs it alone after
   the build and prints its kernels line and the card line, and no ok
   line): ``repro_torch.models`` with ``moe`` and ``moe_a2a``'s local path
   and ``mamba``. (a) deepseek-moe-16B's full ``CONFIG`` (28 layers,
   d_model 2048, 64 routed experts top-6 and 2 shared, vocab 102,400;
   bfloat16 weights drawn on the card, seed ``_MOE_SEED``): prefill of 8
   prompts of 512 with ``max_len`` 1024 and 16 greedy decode steps,
   after a warm-up and one prefill and decode step under sync debug mode
   (no host sync): ``flash_attention`` launches once a layer and nothing
   else, every logit finite; the prefill's ms, ms a decode step,
   tokens/s, ``max_memory_allocated`` and the share of token copies that
   capacity dropped in the prefill (each call's own capacity, 512 slots
   an expert at 4,096 tokens), and one profiled prefill and decode step
   (device busy against the wall, the heaviest kernels). (b) decode
   against ``forward`` at full depth, B 2, prompts of 64 and 16 steps fed
   drawn tokens: ``forward`` over the 80, then the prefill and each step
   on the forward's routing (``tests/torch_routing.py``: each MoE call
   takes the first run's experts, and a choice of its own that differs
   must be a near tie, the first run's gap between the k-th and (k+1)-th
   probability below the architecture's ``_MOE_MARGIN``), no copy dropped
   (the check's precondition), each position's logits within ``_LM_TOL``,
   and the residual stream's difference after each layer printed. (c) the
   card against the port on the CPU at full width and 2 layers, one set
   of weights made on the CPU, B 2, prompts of 128, 8 decode steps fed
   the CPU's tokens, the card on the CPU's routing: logits within
   ``_LM_CPU_TOL``, K/V caches within it by row. (d) dbrx-132B (GQA
   48/8, 16 experts top-4) at full width and 2 layers and jamba-v0.1 at
   full width and one period of 8 layers (7 Mamba, 1 attention, 4 MoE):
   prefill of 2 prompts of 512 and 4 decode steps, ``flash_attention``
   launched once an attention layer, finite logits, jamba's Mamba loop
   timed by CUDA events as a share of the prefill, and (b)'s check at B 2,
   S 64 (jamba's logits within ``_LM_HYBRID_TOL``). (e) one MoE training
   step of 2 microbatches at deepseek's full width and 2 layers against
   the CPU, as 9c (b) without ``adamw_update`` alone, on the CPU's
   routing.
   (f) the first ``flash_attention`` call of (a)'s prefill ([8, 16, 512,
   128] bfloat16, causal) against its plain version, timed beside SDPA
   and the bound: the ``flash_attention[lm deepseek_moe_16b prefill]``
   row, its launches (a)'s prefill's;
9e. the xLSTM and encoder-decoder families, after 9d (``--xlstm-encdec``
   runs it alone after the build and prints its kernels line and the card
   line, and no ok line), TF32 off throughout and set back after:
   ``repro_torch.models`` with ``xlstm`` and ``encdec`` (bfloat16 weights
   drawn on the card, seed ``_XE_SEED``). (a) xlstm-125M's full
   ``CONFIG`` (12 layers, 9 mLSTM and 3 sLSTM, d_model 768, 4 heads,
   vocab 50,304, tied embeddings): prefill of 8 prompts of 512 and 64
   greedy decode steps, after a warm-up and one prefill and decode step
   under sync debug mode (no host sync); no kernel of the port launches
   (none computes the xLSTM), every logit finite; the prefill's ms and
   tokens/s, ms a decode step and tokens/s, ``max_memory_allocated``, the
   CUDA-event ms of the sLSTM loops and of the mLSTM chunk loops as
   shares of a prefill, and one profiled prefill and decode step (device
   busy against the wall, the heaviest kernels). (b) decode against
   ``forward`` at full depth, B 2, prompts of 64 and of 100 (a ragged S,
   which the reference refuses), 16 steps fed drawn tokens: each
   position's logits within ``_LM_TOL``, the greedy tokens equal beyond
   it, and the residual stream's difference after each layer printed;
   ``forward`` with ``MLSTM_MODE`` chunkwise against recurrent within
   ``_XL_MODES_TOL`` (the reference's test holds them to 5e-2 at the SMOKE
   config's 4 layers; at 12 its own forms part by more). (c) the card
   against the port on the CPU at full width and depth, one set of
   weights made on the CPU: B 2, prompts of 128, 8 decode steps fed the
   CPU's tokens, logits within ``_XL_CPU_TOL`` and each state tensor
   after the prefill within ``_XL_STATE_TOL`` times its largest
   |value|. (d) seamless-m4t-large-v2's
   full ``CONFIG`` (24 encoder and 24 decoder layers, d_model 1024, 16
   heads of 64, d_ff 8192, vocab 256,206): prefill of 8 utterances of
   1,000 frames (a ragged S for the encoder's attention), then 64 greedy
   decode steps from a drawn start token, after a warm-up and a sync
   debug check as in (a); ``flash_attention`` launches once an encoder
   layer (24) and nothing else; the prefill's ms, ms a decode step and
   tokens/s, ``max_memory_allocated``, the cross and self caches' bytes,
   one profiled prefill and decode step. (e) decode against ``forward`` at
   full depth, B 2, 200 frames, 16 steps fed drawn tokens, within
   ``_LM_TOL`` (the prefill's encoder runs the kernel, ``forward``'s plain
   torch). (f) the card against the CPU at full width and 2 + 2 layers, B
   2, 200 frames, 8 steps fed the CPU's tokens: logits within
   ``_LM_CPU_TOL``, cross K/V within it by row. (g) one training step
   each against the CPU, as 9c (b) without ``adamw_update`` alone:
   xlstm-125M at full depth, B 2, S 64, and seamless at 2 + 2 layers,
   B 2, 64 frames and 16 tokens; the loss, grad_norm, m and v within the
   larger of ``_TRAIN_TOL`` and twice the CPU's own spread between the
   model's exact forms (one microbatch against two; the xLSTM's recurrent
   mLSTM against its chunkwise one), the parameters printed. (h) the first ``flash_attention`` call of
   (d)'s prefill ([8, 16, 1000, 64] bfloat16, full) against its plain
   version, timed beside SDPA and the bound: the ``flash_attention[lm
   seamless_m4t_large_v2 encode]`` row, its launches (d)'s prefill's;
9f. the tools and the sharding policy, after 9e (``--tools`` runs it
   alone after the build and prints its kernels line and the card line,
   and no ok line). (a) ``launch.roofline.measure_program`` on qwen2-1.5B's
   prefill as 9b runs it (full ``CONFIG``, bfloat16, 8 prompts of 512,
   ``max_len`` 1024; ``flash_attention`` launching once a layer, 28, the
   counters set to 0 just before one prefill and read just after): the
   counted FLOPs and bytes, ``model_flops``, the ms by CUDA events, the
   roofline bound, the dominant term and ``achieved_fraction``, the card
   line; the count equal to ``meta``'s at full depth, and the same program
   at 2 layers counted on the card equal to its count on the CPU, exactly
   (the kernel's report standing for its plain version there); (b) the
   count of (a)'s first attention call ([8, 12, 512, 128] bfloat16,
   causal) equal to the bytes and operations of row 10's bound, which it
   prints; the ``flash_attention[lm qwen2_1_5b prefill 9f]`` row, its
   launches (a)'s prefill's; (c) ``moe_ffn_a2a`` of one deepseek-moe-16B
   MoE layer at full width, B 8 x S 512, on a 1 x 4 ``ModelMesh`` naming
   cuda:0 four times, its experts placed by ``params_shardings`` (each tp
   rank's 16 experts its local shard), against the local path on the
   same card: on the local path's routing (``tests/torch_routing.py``,
   each differing own choice a near tie), the output within rtol = atol =
   2e-2, aux within 1e-6 relative, the all-reduce's counted bytes
   (``--cards`` runs (c) alone over the host's cards after its mesh
   part); (d) ``runtime.elastic.reshard_state`` of a qwen2-1.5B
   ``TrainState`` at full width and 2 layers (moments drawn, step 7) on
   the card from (1, 1) to (1, 4) to (2, 2) and back to (1, 1), every
   leaf bit-equal at each step, each layout's largest position's bytes
   printed; ``restore_for_mesh`` of a ``CheckpointManager`` checkpoint of
   it onto (2, 2), bit-equal;
10. the main path's shapes: every captured standalone probe (W = 1 and
   W = 4) once in one profile, a line each (keys, slots, max_probes, hit
   rate, whether the table fits the L2, bound, device µs) and the sums;
   every captured expansion probe the same way (keys, slots, m,
   max_probes, matches, the slots walked a key, L2 fit, bound, device
   µs); every captured ``segmented_minmax`` call profiled alone (rows,
   G, live rows and groups, dtype, whether the live ids are sorted, the
   bound (no value read for a dead row) and the bound with every row's
   value read, device µs of the call's kernels); every repartition's metadata pass profiled alone,
   a line each (rows a source, key dtypes and widths, bound, device µs);
   the heaviest group of probe calls, of expansion probes of each query,
   of min/max calls and the heaviest repartition are the ``hash_probe``,
   ``hash_probe_multi``, ``segmented_minmax`` and ``radix_histogram``
   rows of the kernels line, with the wrapper's host µs a call
   (``host_us``) and the device ms (``device_ms``);
11. prints one ``{"kernels": [...]}`` line, then the card line again;
12. prints as its last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without printing the last line. The script
imports only the port, torch, numpy and the standard library; it fails when
``torch.cuda.is_available()`` is false or when ``src/repro_torch`` is not
beside it. ``--profile DIR`` adds, after phase 5, each kernel's device time
per launch at the main path's shapes and the kernels a call launches
(``block_prefix_sum`` must be one, beside its memset; ``build_table``
must show no ``cudaStreamSynchronize`` and no ``Memcpy DtoH``), then one
``torch.profiler`` run of each
query, whose device time by kernel (and trace) it writes into DIR, and
after phase 7 one profiled W = 4 run of each query, then one profiled
W = 1 run of Q1 and of Q6 from the storage phase's files and from the
same rows in memory (their ``Memcpy HtoD`` copies and ms), and last one
profiled run of phase 8's serving workload with and one without batching.
``--attention`` runs phase 9 alone after the build and prints its kernels
line and the card line, and no ok line (``--lm`` phase 9b, ``--train``
phase 9c, ``--moe`` phase 9d, ``--xlstm-encdec`` phase 9e, ``--tools``
phase 9f); ``--build``
runs phase 3's synthetic builds alone; ``--fused`` the fused program's checks (Q1 and Q6
and their views), phase 8(a) and the SQL phase's (d) alone; ``--sql`` the
SQL phase alone; ``--segmented`` the segmented
sums' ``_SEG_CASES`` and min/max's ``_MINMAX_CASES`` alone; ``--probe``
the probe's ``_PROBE_CASES`` and the expansion probe's ``_MULTI_CASES``
alone; ``--partition`` the metadata pass's ``_PART_CASES`` alone;
``--storage`` the storage phase alone; ``--spill`` the out-of-core phase
alone (the metadata pass's ``--partition`` run also holds the standalone
histogram's ``_HIST_CASES``); ``--adaptive`` the adaptive phase alone;
``--mesh`` the mesh phase alone; ``--cards`` its part (b) alone, with
the off-mesh runs it compares with.
``--faults`` runs the six on the kernels as they are and then on copies,
in a temporary directory, each with one fault planted (a K tile left
out, early or late; V tiles not reloaded; the keys past a ragged S left
unmasked; the split over K's combine dropping a split; float32 by one
TF32 product; a ghost pop that ends its slot's turn in the build; the fused kernels' copies of the tail tile's
last partial group of four rows dropped; the segmented sums' scalar tail
read as absent; a run that crosses a warp step joined without its
earlier part; YEAR one year late on the last day of a leap year;
BYTESMATCH searching a later part of a LIKE from the row's start, not
from the end of the previous part's hit; a bytes key's first lane left out of the partition hash;
the standalone histogram's ids past the last full 512-id block left out; a
probe run ended at the end of a 32-byte sector of slots; a NaN folded as
the min/max key that loses; the expansion probe's whole-row store writing
the matches only, the zeros past the count left unwritten), and exits 0 only
when the kernels pass and every fault is caught, the late K tile at
``prefill_32k``, the unmasked keys at both ``ragged_1000`` cases, the
dropped split at D = 160 and 192, the one TF32
product at (a) and (d) in float32, the ghost pop at
``ghosts_over_a_run``, the dropped group at Q1's 999,999 rows, the late
year at ``YEAR synthetic``, the restarted search at ``BYTESMATCH
synthetic``, the tail
at n % 4 of 1, 2 and 3, the join at sorted G = 16 and its counts, the
bytes lane at ``bytes W=4`` and ``views W=4``, the histogram's tail at ``grace n=1500000 P=64``,
``grace n=100003 P=8`` and ``grace W=4 n=1048579 P=64``, the cut run at
``dense T=1024``, the losing NaN at ``specials f32 G=4096`` and the
unwritten zeros at ``duplicates m=4``.

No PyTorch call builds or probes a hash table, so the join kernels'
``library_ms`` is null; the segmented sums' is one ``index_add_`` into a
G + 1 buffer; ``block_prefix_sum``'s is one ``torch.cumsum``,
``segmented_minmax``'s one ``scatter_reduce``, ``radix_histogram``'s one
``torch.bincount`` of the call's in-range (source, destination) bins, the
histogram alone (no PyTorch call hashes the rows too); no PyTorch call
evaluates a batch of predicate lanes, so ``fused_batch_program``'s is null,
nor a program of stages with a LIKE over bytes rows, so the SQL phase's
fused rows' is null;
``flash_attention``'s is one ``scaled_dot_product_attention``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

_MAIN_ROWS = 1 << 20
_SF = 1.0
# the slices' first queries, then the rest of the 22
_QUERIES = (6, 1, 3, 10) + tuple(q for q in range(1, 23)
                                 if q not in (6, 1, 3, 10))
# the queries that reach each all-queries kernel, as the reference's pallas
# runs do (block_prefix_sum: expansion outputs, compacting filters and the
# scalar side of ScalarBroadcast)
_REACHES = {"hash_probe_multi": (9, 20),
            "block_prefix_sum": (9, 11, 15, 20, 22),
            "segmented_minmax": (2,)}
# phase 7: the workers on the one card, and the sample of the reference's
# distributed oracle slice that also runs through the host-staged exchange
_WORKERS = 4
_HOST_QUERIES = (1, 3, 5, 6, 13, 22)
# the storage phase: write_dataset's seed (dbgen's default) and chunks a
# column of the chunked tables (lineitem chunks of 750,079 rows), the
# queries run at four workers from the files, and those run behind the
# host round trip of a host-only HashAggregation
_SEED = 19940729
_STORAGE_CHUNKS = 8
_STORAGE_W4 = (1, 3, 5, 6)
_ROUND_TRIP = (1, 3)
# phase 6: the queries whose kernel inputs are captured at four workers (Q3
# repartitions both join sides; Q7 keeps the fused probe)
_CAPTURED_W = (3, 7)
# phase 8: the serving workload (three shapes, 32 distinct literals each),
# its clients and stacked lanes, and the dashboard of
# examples/serve_queries.py
_SHAPES = ("point", "global", "group")
_LANES = 32
_SERVING_QUERIES = 96
_CLIENTS = 8
_DASHBOARD = (1, 6, 14, 3)
# phase 9: flash attention, (row, [B, H, S, D], dtype, causal, tolerance,
# the kernels a call runs): qwen2-1.5B's attention width
# (src/repro/configs/qwen2_1_5b.py: 12 heads of 128) at the train_4k and
# prefill_32k shapes (src/repro/configs/base.py), seamless_m4t_large_v2's
# encoder width (16 heads of 64, full) at 4,096 frames and at 1,000 (a
# ragged S, which 128 does not divide, as its encoder's prefill meets it),
# and the head dims 160 (pixtral_12b's, zero-filled to the kernels'
# 192-wide template) and 192 (that template at full width; no attention of
# the repository's configs has it), whose 16 CTAs of 128 rows the 16-bit
# kernel splits over K, as the float32 kernel splits its 32 CTAs of 64 rows
_F32 = ("attn_tf32x3_kernel",)
_F32_SPLIT = ("attn_combine_kernel", "attn_tf32x3_kernel")
_WGMMA = ("attn_wgmma_kernel",)
_SPLIT = ("attn_combine_kernel", "attn_wgmma_kernel")
_ATTN_CASES = (
    ("train_4k f32", (1, 12, 4096, 128), "float32", True, 1e-4, _F32),
    ("train_4k bf16", (1, 12, 4096, 128), "bfloat16", True, 2e-2, _WGMMA),
    ("prefill_32k bf16", (1, 12, 32768, 128), "bfloat16", True, 2e-2,
     _WGMMA),
    ("encoder_4k bf16 full", (1, 16, 4096, 64), "bfloat16", False, 2e-2,
     _WGMMA),
    ("ragged_1000 bf16 full", (1, 16, 1000, 64), "bfloat16", False, 2e-2,
     _WGMMA),
    ("ragged_1000 f32 full", (1, 16, 1000, 64), "float32", False, 2e-5,
     _F32),
    ("d160 f32", (1, 2, 1024, 160), "float32", True, 2e-5, _F32_SPLIT),
    ("d160 bf16", (1, 2, 1024, 160), "bfloat16", True, 2e-2, _SPLIT),
    ("d192 f32", (1, 2, 1024, 192), "float32", True, 2e-5, _F32_SPLIT),
    ("d192 bf16", (1, 2, 1024, 192), "bfloat16", True, 2e-2, _SPLIT),
)
_ATTN_SEED = 2024
# a ragged case (S that 128 does not divide) draws q's entries around +1
# and k's around -1: every real score lies far below the 0 that a zero
# key past S would score, so a key past S left unmasked would take most of
# its row's weight (with centred inputs, reckoned from the scores' N(0, 1)
# spread, the 24 such keys of S 1,000 would take about 1.5% of it, too
# little for either limit)
_RAGGED_SHIFT = 1.0
# phase 9b: the LM side at qwen2-1.5B's full CONFIG
# (src/repro/configs/qwen2_1_5b.py), its weights' seed, the batch of
# prompts, their length, the caches' max_len and the greedy decode steps;
# the CPU comparison's prompt lengths (200 is a ragged S for the kernel)
# and the other dense CONFIGs run at full width and 2 layers
_LM_ARCH = "qwen2_1_5b"
_LM_SEED = 29
_LM_BATCH, _LM_PROMPT, _LM_MAX_LEN, _LM_STEPS = 8, 512, 1024, 64
_LM_CPU_PROMPTS = (128, 200)
_LM_OTHERS = ("phi4_mini_3_8b", "granite_3_8b", "granite_34b", "pixtral_12b")
# (atol, rtol) on bfloat16 logits (~N(0, 0.8) at qwen2's width): decode
# and prefill against forward on the card (b, e), and the card against the
# CPU (c); about twice the largest max |diff| read on the card (PERF.md:
# 0.090 in (b) at 28 layers, 0.074 in (e), 0.051 in (c))
_LM_TOL = (0.2, 0.02)
_LM_CPU_TOL = (0.1, 0.02)
# phase 9c: training at qwen2-1.5B's full CONFIG. (a) the corpus table's
# rows (16,777,216 synthetic tokens), the quality a row must exceed, the
# weights' and corpus's seed, the batch, sequence, microbatches and
# prefetch, and the timed steps after one warm-up; (b) the card against the
# CPU at full width and 2 layers: the batch, the mid-training step, its base
# lr, the moments' scale; (c) the example's --full-100m config through the
# fault-tolerant loop: steps, batch, sequence, checkpoint interval, the step
# that fails
_TRAIN_ROWS = 1 << 24
_TRAIN_QUALITY = 0.2
_TRAIN_SEED = 30
_TRAIN_B, _TRAIN_S, _TRAIN_MICRO, _TRAIN_PREFETCH = 8, 512, 2, 2
_TRAIN_STEPS = 8
_TRAIN_CPU_B, _TRAIN_CPU_S, _TRAIN_MID_STEP, _TRAIN_CPU_LR = 2, 64, 150, 1e-2
_TRAIN_MOMENT = 1e-4
_FT_STEPS, _FT_B, _FT_S, _FT_EVERY, _FT_FAIL = 200, 8, 128, 50, 100
# (b)'s tolerances: the loss and grad_norm relative; m and v against the
# largest |part| the step's gradients added (m - b1 m_old, v - b2 v_old);
# each parameter within one bfloat16 ulp plus this many learning rates;
# adamw_update alone on float32 tensors against each tensor's largest
# |value|. bfloat16 gradients round differently on the card and the CPU
# (1-2% of each leaf's largest gradient at qwen2's SMOKE config against
# the reference, tests/test_torch_train.py)
_TRAIN_TOL = {"loss": 1e-3, "grad_norm": 5e-3, "moments": 5e-2,
              "param_lr": 0.3, "adamw": 1e-6}
# phase 9d: the MoE and hybrid families. (a) deepseek-moe-16B's full CONFIG
# (src/repro/configs/deepseek_moe_16b.py: 28 layers, 64 routed experts
# top-6, 2 shared), its weights' seed, 8 prompts of 512, max_len 1024, 16
# greedy steps; (b) decode against forward at B 2, prompts of 64, 16 steps;
# (c) the card against the CPU at 2 layers, prompts of 128, 8 steps; (d)
# dbrx-132B at 2 layers and jamba-v0.1 at one period of 8 layers, 2 prompts
# of 512, 4 steps; each architecture's near-tie margin on the router
# probabilities for a routing choice that differs between two runs
# (tests/torch_routing.py), about twice its largest gap read on an H100:
# deepseek 0.00273 (its 64 experts' probabilities average 0.016), dbrx
# 0.00362 (16 experts, 0.0625), jamba 0.00948 (16 experts), whose decode's
# router probabilities drift from its forward's by up to 0.031 as its
# residual stream's difference grows through its Mamba layers (0.011 after
# layer 0, 0.060 after layer 7; deepseek's 0.015-0.043 over 28 layers);
# (b)'s tolerance for a hybrid config (about twice
# jamba's largest readings, 0.28 and 0.33 over 8 layers, against the dense
# configs' 0.090 over 28: its Mamba layers carry the roundings in which
# decode and forward differ further than attention layers do; (b) prints
# the residual stream's difference after each layer)
_MOE_ARCH = "deepseek_moe_16b"
_MOE_SEED = 31
_MOE_BATCH, _MOE_PROMPT, _MOE_MAX_LEN, _MOE_STEPS = 8, 512, 1024, 16
_MOE_FWD_B, _MOE_FWD_PROMPT, _MOE_FWD_STEPS = 2, 64, 16
_MOE_CPU_PROMPT, _MOE_CPU_STEPS = 128, 8
_MOE_OTHERS = (("dbrx_132b", 2), ("jamba_v0_1_52b", 8))
_LM_HYBRID_TOL = (0.6, 0.02)
_MOE_MARGIN = {"deepseek_moe_16b": 5e-3, "dbrx_132b": 8e-3,
               "jamba_v0_1_52b": 2e-2}
# phase 9e: the xLSTM and encoder-decoder families. (a) xlstm-125M's full
# CONFIG (src/repro/configs/xlstm_125m.py: 12 layers, 9 mLSTM and 3
# sLSTM, d_model 768, 4 heads, vocab 50,304, tied embeddings), its weights'
# seed, 8 prompts of 512, 64 greedy steps; (b) decode against forward at B
# 2, prompts of 64 and of 100 (a ragged S, which the reference refuses), 16
# steps fed drawn tokens; (c) the card against the CPU at full depth, B 2,
# prompts of 128, 8 steps; (d) seamless-m4t-large-v2's full CONFIG
# (src/repro/configs/seamless_m4t_large_v2.py: 24 + 24 layers, d_model
# 1024, 16 heads of 64, d_ff 8192, vocab 256,206), 8 utterances of 1,000
# frames (20 s of speech at a 20 ms stride; 128 does not divide it), 64
# greedy steps; (e) decode against forward at B 2, 200 frames, 16 steps
# fed drawn tokens; (f) the card against the CPU at 2 + 2 layers, B 2, 200
# frames, 8 steps; (g) a training step each against the CPU: xlstm at full
# depth (B 2, S 64), seamless at 2 + 2 layers (B 2, 64 frames, 16 tokens).
# (b) and (e) hold decode to forward within _LM_TOL (twice and 2.6 times
# their largest readings on an H100, 0.0975 and 0.0762) and (f) the card to
# the CPU within _LM_CPU_TOL (0.0313). xLSTM's exponential gates and
# mLSTM's normalizer carry a rounding's difference on through the layers
# (tools/xlstm_conditioning.py: on the CPU the reference's own chunkwise
# and recurrent forms differ by 0.116 at full depth, 0.051 at 4 layers of
# full width; its test holds them to 5e-2 at the SMOKE config's d_model
# 64), so at full depth (b)'s two mLSTM forms are held within
# _XL_MODES_TOL and (c)'s card against the CPU within _XL_CPU_TOL, each
# about twice its largest reading on an H100
# (0.163 and 0.2305), and each state tensor within _XL_STATE_TOL of its
# largest |value| (0.0512). (g) holds a step's loss, grad_norm, m and v to
# the larger of _TRAIN_TOL and twice the CPU's own spread between the
# model's exact forms, and prints its parameters (train_against_cpu's
# spread): on the CPU xlstm's chunkwise and recurrent steps part by m 0.30
# and v 0.42 of the step's largest added part; seamless's embedding reads
# 0.336 lr past an ulp on the card with its m and v within 0.024 (PERF.md)
_XE_SEED = 32
_XL_ARCH, _ED_ARCH = "xlstm_125m", "seamless_m4t_large_v2"
_XL_BATCH, _XL_PROMPT, _XL_STEPS = 8, 512, 64
_XL_FWD_B, _XL_FWD_PROMPTS, _XL_FWD_STEPS = 2, (64, 100), 16
_XL_CPU_PROMPT, _XL_CPU_STEPS = 128, 8
_ED_BATCH, _ED_FRAMES, _ED_STEPS = 8, 1000, 64
_ED_FWD_FRAMES, _ED_FWD_STEPS = 200, 16
_ED_CPU_LAYERS, _ED_CPU_FRAMES, _ED_CPU_STEPS = 2, 200, 8
_ED_TRAIN_FRAMES = 64
_XL_MODES_TOL = (0.3, 0.02)
_XL_CPU_TOL = (0.45, 0.02)
_XL_STATE_TOL = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str = None):
    """The card's data-sheet rates by its name (``name``, else card 0's):
    ``repro_torch.launch.roofline.peaks``, the one table of them (dense
    bfloat16 ``bf16`` and TF32 ``tf32`` tensor-core rates, float32 outside
    the tensor cores ``f32``, ``hbm`` bytes/s); a 3xTF32 float32 product
    costs three TF32 products."""
    from repro_torch.launch import roofline
    return roofline.peaks(name)


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, rate: float, op_rate: float = None):
    """The least time for ``nbytes`` at the memory ``rate`` and ``ops`` at
    ``op_rate`` (the card's float32 rate unless a tensor-core kernel says
    otherwise): (ms, "bytes" or "operations")."""
    op_rate = card_rates().f32 if op_rate is None else op_rate
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the kernels whose ptxas report (-Xptxas -v) the run prints and holds to
# a 0-byte stack frame and no spill, every template variant of each (the
# fused kernels' registers are shared memory; the segmented reductions keep
# a thread's two chunks in registers; the metadata pass its W counts; the
# expansion probe a row of up to 8 matches)
_NO_LOCAL = {"fused_morsel": ("fused_morsel_kernel",),
             "fused_batch": ("fused_batch_kernel",),
             "segmented_agg": ("segmented_sum_kernel",
                               "segmented_minmax_kernel"),
             "radix_histogram": ("partition_histogram_kernel",),
             "hash_table": ("hash_probe_multi_kernel",)}


def start_ptxas(build, out_dir):
    """nvcc of each source of ``_NO_LOCAL`` with ``-Xptxas -v`` into
    ``out_dir``, started (to run beside the build)."""
    procs = {}
    for name in _NO_LOCAL:
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(out_dir, f"lib{name}-ptxas.so"),
               str(build.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    return procs


def ptxas_report(text: str) -> dict:
    """{mangled kernel: {"stack", "spill_stores", "spill_loads",
    "registers"}} from nvcc's ``-Xptxas -v`` output."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def check_ptxas(procs) -> dict:
    """Waits for ``start_ptxas``'s nvcc runs, prints the stack frame, spills
    and registers of each variant of each kernel of ``_NO_LOCAL``, and fails
    unless the stack frames and the spills are 0 bytes."""
    seen = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v {name}.cu:\n{err}")
        report = ptxas_report(err)
        for kernel in _NO_LOCAL[name]:
            infos = {k: v for k, v in report.items() if kernel in k}
            if not infos or any("stack" not in v for v in infos.values()):
                fail(f"ptxas printed no stack frame for {kernel}:\n{err}")
            seen.update(_check_no_local(kernel, infos))
    return seen


def _check_no_local(kernel, infos) -> dict:
    """Prints each variant's ptxas report and fails on a stack frame or a
    spill; returns ``infos``."""
    for mangled, info in sorted(infos.items()):
        print(f"ptxas {kernel} ({mangled}): {info['stack']} bytes stack "
              f"frame, {info['spill_stores']} bytes spill stores, "
              f"{info['spill_loads']} bytes spill loads, "
              f"{info.get('registers')} registers", flush=True)
        if info["stack"] or info["spill_stores"] or info["spill_loads"]:
            fail(f"{kernel}: a stack frame or spills in local memory")
    return infos


# ---------------------------------------------------------------------------
# phase 3 + 4: each kernel against its plain version, then timed
# ---------------------------------------------------------------------------

# the segmented sums' cases on synthetic ids (``--segmented`` runs them
# alone): sorted and unsorted at the main path's morsel, counts, every id
# dead, n % 4 of 1-3 (the scalar tail), bases 1-3 rows past a 16-byte
# boundary with ids and values misaligned differently or alike (the scalar
# head; values row by row), the largest shared-partials G and the first
# global one, and a merge's shape: 2^24 sorted rows, most of them a dead tail
_SEG_CASES = ("sorted G=16", "unsorted G=4096", "counts G=16", "all dead",
              "tail n%4=1", "tail n%4=2", "tail n%4=3",
              "offset ids 1 values 2", "offset ids 3 values 0",
              "offset ids 2 values 2", "G=8192", "G=8193",
              "n=2^24 dead tail")
_SEG_REPLACES = {"segmented_sum": "src/repro/kernels/segmented_agg.py:80",
                 "segmented_int_sum": "src/repro/kernels/segmented_agg.py:131"}


def _seg_inputs(torch, case, gen):
    """(ids, float32 values, int32 values, G) of a ``_SEG_CASES`` case on the
    card; the int values lie near 2^30, so every group's sum wraps."""
    dev = "cuda"

    def ids(n, lo, hi, sort=False):
        x = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(x).values if sort else x

    def values(n):
        return (torch.randn(n, generator=gen, device=dev),
                torch.randint(1 << 29, 1 << 30, (n,), generator=gen,
                              device=dev, dtype=torch.int32))

    rows = _MAIN_ROWS
    if case in ("sorted G=16", "unsorted G=4096", "counts G=16"):
        g = 4096 if case.startswith("unsorted") else 16
        gids = ids(rows, 0, g + 1, sort=not case.startswith("unsorted"))
        fv, iv = values(rows)
        if case == "counts G=16":
            iv = (gids < g).to(torch.int32)
        return gids, fv, iv, g
    if case == "all dead":
        n, g = 100_003, 1000
        pick = torch.tensor([-1, -5, g, g + 7, 2 ** 31 - 1], dtype=torch.int32,
                            device=dev)
        return (pick[ids(n, 0, 5).long()], *values(n), g)
    if case.startswith("tail"):
        n, g = 100_000 + int(case[-1]), 500
        gids = ids(n, -1, g + 2)
        gids[-3:] = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
        return (gids, *values(n), g)
    if case.startswith("offset"):
        # views 1-3 rows into their buffers: the wrapper's .contiguous()
        # keeps them, so the kernel sees the unaligned bases
        n, g = 100_001, 700
        _, _, oi, _, ov = case.split()
        fv, iv = values(n + 8)
        gids = ids(n + 8, 0, g)[int(oi):int(oi) + n]
        return (gids, fv[int(ov):int(ov) + n], iv[int(ov):int(ov) + n], g)
    if case in ("G=8192", "G=8193"):
        g = int(case[2:])
        return (ids(rows, -1, g + 2), *values(rows), g)
    if case == "n=2^24 dead tail":
        n, g, live = 1 << 24, 1 << 23, 40_000
        gids = torch.full((n,), g, dtype=torch.int32, device=dev)
        gids[:live] = ids(live, 0, g, sort=True)
        return (gids, *values(n), g)
    raise ValueError(case)


def _seg_check(torch, seg, gids, vals, g):
    """(error, whether it is within the tolerance) of the kernel against
    the plain version: int32 bit-exact (the error: the groups that
    differ); float32 within 1e-4 * sum(|v|) of the group + 1e-6, the
    reordering error of float32 partial sums added by atomics in any order
    (the error: max |kernel - plain|)."""
    if vals.dtype == torch.int32:
        got = seg.segmented_int_sum(gids, vals, g)
        want = seg.segmented_int_sum_plain(gids, vals, g)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        return float(bad), bad == 0
    got = seg.segmented_sum(gids, vals, g)
    want = seg.segmented_sum_plain(gids, vals, g)
    scale = seg.segmented_sum_plain(gids, vals.abs(), g)
    torch.cuda.synchronize()
    err = (got - want).abs()
    return float(err.max()) if g else 0.0, bool(
        (err <= 1e-4 * scale + 1e-6).all())


def check_segmented_cases(torch, seg, failures):
    """``_SEG_CASES`` on the card, each with float32 and int32 values
    against the plain versions; misses go into ``failures``. Returns the
    G = 16 inputs (the float sums of "sorted G=16", the counts of "counts
    G=16") for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    kept = {}
    for case in _SEG_CASES:
        gids, fv, iv, g = _seg_inputs(torch, case, gen)
        live = int(((gids >= 0) & (gids < g)).sum())
        ferr, fok = _seg_check(torch, seg, gids, fv, g)
        ibad, iok = _seg_check(torch, seg, gids, iv, g)
        if not fok:
            failures.append(f"segmented_sum[{case}]: max err {ferr}")
        if not iok:
            failures.append(f"segmented_int_sum[{case}]: {int(ibad)} groups "
                            "differ")
        print(f"check segmented[{case}] rows={gids.shape[0]} live={live} "
              f"G={g} ids at +{gids.data_ptr() % 16 // 4} values at "
              f"+{fv.data_ptr() % 16 // 4} rows: float32 max_abs_err={ferr} "
              f"({'within' if fok else 'OUTSIDE'} 1e-4*sum|v|), int32 "
              + ("bit-exact" if iok else f"{int(ibad)} groups differ"),
              flush=True)
        if case == "sorted G=16":
            kept["segmented_sum"] = (gids, fv, g, ferr)
        if case == "counts G=16":
            kept["segmented_int_sum"] = (gids, iv, g, 0.0)
    return kept


def run_segmented(torch, seg):
    """``--segmented``: the segmented sums' and min/max's cases alone."""
    failures = []
    check_segmented_cases(torch, seg, failures)
    check_minmax_cases(torch, seg, failures)
    if failures:
        fail("; ".join(failures))


def seg_bound_ms(gids, g, rate):
    """The segmented sums' bound from their inputs: every id read, the value
    of every row whose id is in [0, G) read, the G results written once (the
    wrapper's fill and the adds), over the memory rate; an add a row never
    bounds it. (ms, "bytes" or "operations", the live rows)."""
    n = gids.shape[0]
    live = int(((gids >= 0) & (gids < g)).sum())
    b, by = bound_ms(n * 4 + live * 4 + g * 4, n, rate)
    return b, by, live


def segmented_row(torch, seg, name, gids, vals, g, err, rate):
    """The kernels line's row of one segmented call and its launcher:
    ``ms`` (CUDA events, the wrapper's fill included), the plain version's
    and one ``index_add_`` into a G + 1 buffer (``library_ms``)."""
    key = name.partition("[")[0]
    kernel, plain = ((seg.segmented_sum, seg.segmented_sum_plain)
                     if key == "segmented_sum" else
                     (seg.segmented_int_sum, seg.segmented_int_sum_plain))
    launcher = (lambda: kernel(gids, vals, g))
    lib_ids = torch.where((gids >= 0) & (gids < g), gids, g)
    buf = torch.zeros(g + 1, dtype=vals.dtype, device=gids.device)
    b, by, live = seg_bound_ms(gids, g, rate)
    n = gids.shape[0]
    sorted_ids = bool((gids[1:] >= gids[:-1]).all()) if n > 1 else True
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/segmented_agg.cu",
               replaces=_SEG_REPLACES[key], max_abs_err=err,
               ms=time_ms(torch, launcher),
               plain_ms=time_ms(torch, lambda: plain(gids, vals, g),
                                reps=5, warm=1),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(torch, lambda: buf.index_add_(0, lib_ids,
                                                                vals)),
               rows=n, live_rows=live, groups=g, sorted=sorted_ids)
    print(f"check {name} rows={n} live={live} G={g} sorted={sorted_ids}: "
          f"max_abs_err={err}; ms {row['ms']:.4f}, bound {b:.4f} ({by}), "
          f"plain {row['plain_ms']:.4f}, index_add_ {row['library_ms']:.4f}",
          flush=True)
    return row, launcher


def stacked_call(torch, fused, catalog, data):
    """The float ``segmented_sum`` call of one stacked aggregation as
    batched serving makes it (``batch._stacked_segment_agg``): the "group"
    serving program at ``_LANES`` lanes over the first lineitem morsel,
    through ``batch_morsel_op`` and ``_stacked_aggregate``, its ids
    unsorted (a member-dead row breaks a lane's runs): (ids, values, G)."""
    from repro_torch.core import batch
    from repro_torch.kernels import segmented_agg as seg

    prog, shapes, full = serving_morsel(catalog, data, "group", _LANES)
    params = batch._params(prog, shapes, _LANES, full.device)
    table, masks = batch.batch_morsel_op(prog, _LANES, full, params)
    got = []
    orig = seg.segmented_sum

    def segmented_sum(gids, values, num_groups):
        if not got:
            got.append((gids.clone(), values.clone(), num_groups))
        return orig(gids, values, num_groups)

    seg.segmented_sum = segmented_sum
    try:
        batch._stacked_aggregate(table, masks, prog, _LANES)
    finally:
        seg.segmented_sum = orig
    if not got:
        fail("stacked aggregation: no segmented_sum call")
    return got[0]


def check_segmented(torch, seg, rate, calls, stacked):
    """segmented_sum / segmented_int_sum: ``_SEG_CASES``, then the calls
    the main path makes, captured by ``capture_calls`` (Q1's first call of
    each, G = 16; Q3's first part and first merge, G = 2^23; Q17's first
    int merge) and ``stacked_call``; each against its plain version and
    timed. Returns the kernels line's rows and their launchers."""
    failures = []
    kept = check_segmented_cases(torch, seg, failures)
    rows_out, launchers = [], {}
    for name, (gids, vals, g, err) in kept.items():
        row, launchers[name] = segmented_row(torch, seg, name, gids, vals, g,
                                             err, rate)
        rows_out.append(row)
    cases = [(f"{c['kernel']}[{c['case']}]", c["gids"], c["values"], c["g"])
             for c in calls]
    cases.append(("segmented_sum[stacked]", *stacked))
    for name, gids, vals, g in cases:
        err, ok = _seg_check(torch, seg, gids, vals, g)
        if not ok:
            failures.append(f"{name}: error {err}")
            continue
        row, launchers[name] = segmented_row(torch, seg, name, gids, vals, g,
                                             err, rate)
        rows_out.append(row)
    if failures:
        fail("; ".join(failures))
    return rows_out, launchers


def _profile_calls(torch, name, fn, syms, reps):
    """``reps`` calls of ``fn`` in one profile, taken again until it holds
    ``reps`` events of the kernels ``syms``: (those events, every device
    event)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(_PROFILE_ATTEMPTS):
        prof, _ = _profiled(torch, lambda: [fn() for _ in range(reps)])
        events = _device_events(prof)
        hits = [e for e in events if any(s in e[0] for s in syms)]
        if sum(e[1] for e in hits) == reps:
            return hits, events
        print(f"profile of {name}: {sum(e[1] for e in hits)} kernel "
              f"events for {reps} calls in attempt {attempt + 1}", flush=True)
    fail(f"profile of {name}: no {reps} kernel events")


def segmented_device_ms(torch, rows, launchers, reps: int = 10):
    """Device ms a call of each segmented row from ``torch.profiler``: the
    kernel's events (``device_ms``) and every device event of the call
    (``call_device_ms``: the wrapper's zero fill and the kernel). After
    phase 9, as every profile of the run."""
    for r in rows:
        key = r["name"].partition("[")[0]
        if key not in ("segmented_sum", "segmented_int_sum"):
            continue
        hits, events = _profile_calls(torch, r["name"], launchers[r["name"]],
                                      _KERNEL_SYMBOLS[key], reps)
        r["device_ms"] = sum(e[2] for e in hits) / reps / 1e3
        r["call_device_ms"] = sum(e[2] for e in events) / reps / 1e3
        print(f"device {r['name']}: kernel {r['device_ms']:.5f} ms, call "
              f"{r['call_device_ms']:.5f} ms (bound {r['bound_ms']:.5f}); "
              f"events {[(e[0][:50], e[1] / reps) for e in events]}",
              flush=True)


def fused_case(queries, catalog, morsel, q):
    """The fused stages of query ``q`` as FusedMorsel receives them: the
    scan's pushed-down filter, then the projection."""
    plan = queries.build_query(q, catalog)
    while type(plan).__name__ != "Project":
        plan = plan.child
    scan = plan.child
    stages = [(scan.filter, None), (None, tuple(plan.projections))]
    table = morsel.select(list(scan.columns))
    return table, stages


# views of a main-path morsel that every fused check also runs: a ragged
# tail (n no multiple of the 1024-row tile nor of a thread's four rows),
# fewer rows than one thread's four, and a one-row offset (column bases
# that are not 16-byte, or for bools 4-byte, aligned)
_FUSED_VIEWS = (("n=999999", slice(0, 999_999)), ("n=3", slice(0, 3)),
                ("offset 1", slice(1, None)))


def view(table, sl):
    """The rows ``sl`` of a TorchTable, as views of its tensors."""
    return type(table)({c: a[sl] for c, a in table.columns.items()},
                       table.validity[sl], table.schema)


def _check_fused_case(torch, fused, table, stages, program, what):
    """One fused call (no probe) against ``apply_stages``: validity and
    every column bit-identical."""
    got, _, _ = fused.fused_morsel_program(table, stages, program=program)
    want = fused.apply_stages(table, stages)
    torch.cuda.synchronize()
    if not torch.equal(got.validity, want.validity):
        fail(f"{what}: validity differs from apply_stages")
    for name in want.column_names:
        if not _bits_equal(torch, got.columns[name], want.columns[name]):
            a, b = got.columns[name], want.columns[name]
            d = (a.double() - b.double()).abs().max() if len(a) else 0
            fail(f"{what}: column {name} differs (max {float(d)})")
    return got


def check_fused(torch, fused, queries, catalog, morsel, rate):
    """fused_morsel_program for Q1's and Q6's stages on one morsel and on
    the views of ``_FUSED_VIEWS``: output columns and validity must be
    bit-identical to ``apply_stages`` (the kernel rounds every float op to
    nearest, like the plain version)."""
    rows_out, launchers = [], {}
    for q in (1, 6):
        table, stages = fused_case(queries, catalog, morsel, q)
        program = fused.lower_stages(table, stages)
        got = _check_fused_case(torch, fused, table, stages, program,
                                f"fused_morsel_program[Q{q}]")
        for label, sl in _FUSED_VIEWS:
            part = view(table, sl)
            _check_fused_case(torch, fused, part, stages, program,
                              f"fused_morsel_program[Q{q} {label}]")
        print(f"check fused_morsel_program Q{q} rows={table.capacity}: "
              f"{program.code.shape[0]} instructions, {program.n_regs} "
              f"registers ({program.n_vec} vector slots, "
              f"{program.n_uniform} uniform), {program.plan.stages} load "
              f"stages, {program.plan.smem_bytes()} B of shared memory, "
              f"bit-identical (and {', '.join(v for v, _ in _FUSED_VIEWS)})",
              flush=True)
        name = f"fused_morsel_program[Q{q}]"
        launchers[name] = (lambda t=table, st=stages, p=program:
                           fused.fused_morsel_program(t, st, program=p))
        ms = time_ms(torch, launchers[name])
        plain_ms = time_ms(torch, lambda: fused.apply_stages(table, stages))
        n = table.capacity
        nbytes = n * (sum(table.columns[c].element_size()
                          for c in program.in_names) + 1
                      + sum(got.columns[c].element_size()
                            for c in program.out_names) + 1)
        alu = sum(1 for op in program.code[:, 0].tolist()
                  if op >= fused.OPS["FILTER"])
        b, by = bound_ms(nbytes, n * alu, rate)
        rows_out.append(dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/fused_morsel.cu",
                             replaces="src/repro/core/fused.py:78",
                             max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=None))
    return rows_out, launchers


def capture_calls(torch, hp, fused, catalog):
    """The kernels' inputs as the main path gives them: one run of each
    of the 22 queries at SF 1 through the card's ``Session``, with the
    kernel functions wrapped so that each call's arguments are kept before
    the kernel runs on them: every ``hash_probe`` call of every query,
    every ``build_table`` call of Q3 and Q10, the first call of each fused
    probe's join of Q3 and Q10, the first ``block_prefix_sum`` mask of Q9
    and Q22, every ``segmented_minmax`` and ``hash_probe_multi`` call of
    every query, Q22's fused calls without a probe (its
    ``PrefixCode`` stages), and the segmented sums' calls
    ``check_segmented`` holds: Q1's first call of each (G = 16), Q3's
    first part (a batch's aggregation) and first merge (the accumulator
    and a part, n = 2G) and Q17's first ``segmented_int_sum`` merge."""
    from repro_torch.core import table as table_mod
    from repro_torch.core.session import Session
    from repro_torch.kernels import segmented_agg as seg
    from repro_torch.tpch import queries
    calls = {"build": [], "probe": [], "fused": [], "compact": [],
             "minmax": [], "multi": [], "fused_plain": [], "seg": []}
    now = {}
    orig = (hp.build_table, hp.hash_probe, fused.fused_morsel_program,
            table_mod.block_prefix_sum, seg.segmented_minmax,
            hp.hash_probe_multi, seg.segmented_sum, seg.segmented_int_sum)

    def first(kind):
        return not any(c["q"] == now["q"] for c in calls[kind])

    def build_table(keys, vals, table_size, empty_key=-1, valid=None):
        if now["q"] in (3, 10):
            calls["build"].append(dict(
            q=now["q"], keys=keys.clone(), vals=vals.clone(), t=table_size,
            empty=empty_key, valid=None if valid is None else valid.clone()))
        return orig[0](keys, vals, table_size, empty_key, valid)

    def hash_probe(tk, tv, keys, empty_key=-1,
                   max_probes=hp.MAX_PROBES_DEFAULT):
        calls["probe"].append(dict(q=now["q"], w=1, tk=tk, tv=tv,
                                   keys=keys.clone(), empty=empty_key,
                                   max_probes=max_probes))
        return orig[1](tk, tv, keys, empty_key, max_probes)

    def fused_morsel_program(table, stages, probe=None, program=None):
        if probe is not None and now["q"] in (3, 10) and not any(
                c["probe"]["tk"] is probe["tk"] for c in calls["fused"]):
            calls["fused"].append(dict(q=now["q"], table=table, stages=stages,
                                       probe=probe, program=program))
        if probe is None and now["q"] == 22:
            calls["fused_plain"].append(dict(q=22, table=table, stages=stages,
                                             program=program))
        return orig[2](table, stages, probe=probe, program=program)

    def block_prefix_sum(mask):
        if now["q"] in (9, 22) and first("compact"):
            calls["compact"].append(dict(q=now["q"], mask=mask.clone()))
        return orig[3](mask)

    segmented_minmax = _keep_minmax(calls["minmax"], now, 1, orig[4])
    hash_probe_multi = _keep_multi(hp, calls["multi"], now, 1, orig[5])

    def segmented(kernel, run):
        def call(gids, values, num_groups):
            merge = gids.shape[0] == 2 * num_groups
            case = {1: "Q1",
                    3: f"Q3 {'merge' if merge else 'part'}"
                    if kernel == "segmented_sum" else None,
                    17: "Q17 merge"
                    if merge and kernel == "segmented_int_sum" else None
                    }.get(now["q"])
            if case and not any(c["kernel"] == kernel and c["case"] == case
                                for c in calls["seg"]):
                calls["seg"].append(dict(q=now["q"], kernel=kernel, case=case,
                                         gids=gids.clone(),
                                         values=values.clone(),
                                         g=num_groups))
            return run(gids, values, num_groups)
        return call

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    (hp.build_table, hp.hash_probe, fused.fused_morsel_program,
     table_mod.block_prefix_sum, seg.segmented_minmax,
     hp.hash_probe_multi, seg.segmented_sum, seg.segmented_int_sum) = (
        build_table, hash_probe, fused_morsel_program, block_prefix_sum,
        segmented_minmax, hash_probe_multi,
        segmented("segmented_sum", orig[6]),
        segmented("segmented_int_sum", orig[7]))
    try:
        for q in _QUERIES:
            now["q"] = q
            gpu.execute(queries.build_query(q, catalog))
    finally:
        (hp.build_table, hp.hash_probe, fused.fused_morsel_program,
         table_mod.block_prefix_sum, seg.segmented_minmax,
         hp.hash_probe_multi, seg.segmented_sum, seg.segmented_int_sum) = orig
    torch.cuda.synchronize()
    return calls


def _keep_minmax(kept, now, w, run):
    """A ``segmented_minmax`` that keeps each call's inputs in ``kept``
    (query ``now["q"]``, ``w`` workers) before ``run`` takes them."""
    def segmented_minmax(gids, values, num_groups, kind):
        kept.append(dict(q=now["q"], w=w, gids=gids.clone(),
                         values=values.clone(), g=num_groups, kind=kind))
        return run(gids, values, num_groups, kind)
    return segmented_minmax


def _keep_multi(hp, kept, now, w, run):
    """A ``hash_probe_multi`` that keeps each call's inputs in ``kept``."""
    def hash_probe_multi(tk, tv, keys, max_matches, empty_key=-1,
                         max_probes=hp.MAX_PROBES_DEFAULT):
        kept.append(dict(q=now["q"], w=w, tk=tk, tv=tv, keys=keys.clone(),
                         m=max_matches, empty=empty_key,
                         max_probes=max_probes))
        return run(tk, tv, keys, max_matches, empty_key, max_probes)
    return hash_probe_multi


def _sectors(torch, mask, item_bytes):
    """32-byte sectors of an array of ``item_bytes``-byte items that hold
    at least one item where ``mask`` is True."""
    idx = torch.nonzero(mask).squeeze(1) // (32 // item_bytes)
    return int(torch.unique(idx).numel())


def probe_table_bytes(torch, hp, tk, keys, max_probes, empty_key=-1,
                      max_matches=1):
    """Bytes of the table that a probe of ``keys`` must read: the 32-byte
    sectors of the key array that the keys' runs visit (home slot to the
    ``max_matches``-th hit, an empty slot or ``max_probes``), and those of
    the value array only at hits."""
    t = tk.shape[0]
    seen_k = torch.zeros(t, dtype=torch.bool, device=tk.device)
    seen_v = torch.zeros_like(seen_k)
    home, key = hp.hash_home(keys, t), keys
    count = torch.zeros_like(key)
    for i in range(min(max_probes, t)):
        idx = (home + i) & (t - 1)
        k = tk.index_select(0, idx)
        seen_k[idx] = True
        hit = k == key
        seen_v[idx[hit]] = True
        count = count + hit.to(count.dtype)
        go = ~((count >= max_matches) | (k == empty_key))
        if not bool(go.any()):
            break
        home, key, count = home[go], key[go], count[go]
    return 32 * (_sectors(torch, seen_k, 4) + _sectors(torch, seen_v, 4))


def build_bytes(torch, c):
    """Bytes a build must move: the validity of every row, the keys and
    values of valid rows (the 32-byte sectors that hold one), the table
    written once."""
    n = c["keys"].shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=c["keys"].device)
             if c["valid"] is None else c["valid"])
    return (n * (c["valid"] is not None) + 2 * 32 * _sectors(torch, valid, 4)
            + c["t"] * 8)


def _same_table(torch, got, want, what):
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        fail(f"build_table {what}: {bad} slots differ from the plain version")


def _rounds(torch, hp, tk):
    """Rounds the round-synchronous build needed: the longest displacement
    of a key from its home slot, plus 1."""
    t = tk.shape[0]
    occ = tk != -1
    idx = torch.arange(t, device=tk.device)
    disp = (idx - hp.hash_home(tk, t)) & (t - 1)
    return int(disp[occ].max()) + 1 if bool(occ.any()) else 0


def _largest(cs, q, size):
    return max((c for c in cs if c["q"] == q), key=size)


def check_build_call(torch, hp, c, what):
    """One captured ``build_table`` call against its plain version,
    bit-identical; keeps the table in ``c["table"]``."""
    args = (c["keys"], c["vals"], c["t"], c["empty"], c["valid"])
    got = hp.build_table(*args)
    _same_table(torch, got, hp.build_table_plain(*args),
                f"{what} {c['t']} slots")
    c["table"] = got
    nv = c["keys"].shape[0] if c["valid"] is None else int(c["valid"].sum())
    route = "rounds" if c["keys"].shape[0] >= c["t"] else "passes"
    print(f"check build_table {what}: rows={c['keys'].shape[0]} "
          f"valid={nv} slots={c['t']} route={route} "
          f"rounds={_rounds(torch, hp, got[0])} "
          f"max_probes={hp.probe_bound(got[0])}: bit-identical", flush=True)


def check_probe_call(torch, hp, c, what):
    """One captured ``hash_probe`` call against its plain version, exact."""
    args = (c["tk"], c["tv"], c["keys"], c["empty"], c["max_probes"])
    got, want = hp.hash_probe(*args), hp.hash_probe_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"hash_probe {what} {c['tk'].shape[0]} slots differs from the "
             "plain version")
    c["hits"] = int(got[0].sum())
    print(f"check hash_probe {what}: keys={c['keys'].shape[0]} "
          f"slots={c['tk'].shape[0]} max_probes={c['max_probes']} "
          f"hits={c['hits']}: exact", flush=True)


def check_fused_probe_call(torch, fused, c, what):
    """One captured fused probe call against ``apply_stages`` +
    ``apply_probe``, exact; keeps the probe key and the output in ``c``."""
    table, stages, probe = c["table"], c["stages"], c["probe"]
    got, gf, gb = fused.fused_morsel_program(table, stages, probe=probe,
                                             program=c["program"])
    want = fused.apply_stages(table, stages)
    wf, wb = fused.apply_probe(want, probe)
    torch.cuda.synchronize()
    if not torch.equal(got.validity, want.validity):
        fail(f"fused probe {what}: validity differs from apply_stages")
    for col in want.column_names:
        if not torch.equal(got.columns[col], want.columns[col]):
            fail(f"fused probe {what}: column {col} differs")
    if not (torch.equal(gf, wf) and torch.equal(gb, wb)):
        fail(f"fused probe {what}: found/bidx differ from the plain version")
    c["key"] = fused.probe_key(want, probe["probe_keys"], probe["pack"],
                               probe["empty_key"])
    c["out"] = got
    print(f"check fused_morsel_probe {what} {probe['probe_keys']}: "
          f"rows={table.capacity} slots={probe['tk'].shape[0]} "
          f"{c['program'].code.shape[0]} instructions, found="
          f"{int(gf.sum())}: exact", flush=True)


def _build_case(torch, hp, case, gen):
    """(keys, vals, table_size, empty_key, valid) of a synthetic build case
    on the card: ``duplicates`` (16 rows a key on average, invalid rows and
    -1 keys, 671 rounds of the reference) and ``unique`` at the same rows
    and slots; an all-ghost cluster (40 rows of key -1 among sparse unique
    keys); 30 ghosts whose home lies inside the run of a key of 200 rows,
    so that the run's rows pop into the slots the ghosts leave empty; a
    cluster that wraps slot T - 1 -> 0; one home holding 1,000 rows; and n
    >= table_size with the valid rows below and above the table's size
    (the round kernels)."""
    dev = "cuda"

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def unique(n, span):
        return (torch.randperm(span, generator=gen, device=dev)[:n]
                .to(torch.int32))

    valid = None
    if case == "duplicates":
        n, t = 1 << 18, 1 << 19
        keys = ints(-1, 1 << 14, n)
        valid = torch.rand(n, generator=gen, device=dev) < 0.9
    elif case == "unique":
        n, t = 1 << 18, 1 << 19
        keys = unique(n, 1 << 24)
    elif case == "all_ghost_cluster":
        n, t = 2000, 1 << 13
        keys = unique(n, 1 << 24)
        keys[torch.randperm(n, generator=gen, device=dev)[:40]] = -1
    elif case == "ghosts_over_a_run":
        n, t = 1000, 1 << 12
        pool = torch.arange(1 << 20, dtype=torch.int32, device=dev)
        ghost = int(hp.hash_home(pool[:1] - 1, t))
        run = pool[hp.hash_home(pool, t) == (ghost - 20) % t][0]
        keys = unique(n, 1 << 24) + (1 << 20)
        keys[:200], keys[200:230] = run, -1
        keys = keys[torch.randperm(n, generator=gen, device=dev)]
    elif case == "wrap_through_last_slot":
        n, t = 300, 1 << 12
        pool = torch.arange(1 << 20, dtype=torch.int32, device=dev)
        pool = pool[hp.hash_home(pool, t) >= t - 8]
        keys = pool[torch.randint(0, pool.shape[0], (n,), generator=gen,
                                  device=dev)]
    elif case == "one_home_1000_rows":
        n, t = 4000, 1 << 13
        keys = unique(n, 1 << 24) + 1
        keys[torch.randperm(n, generator=gen, device=dev)[:1000]] = 0
    else:   # rounds_below_t, rounds_above_t
        n, t = 1 << 13, 1 << 12
        keys = ints(-1, 1 << 20, n)
        share = 0.3 if case == "rounds_below_t" else 0.9
        valid = torch.rand(n, generator=gen, device=dev) < share
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    return keys, vals, t, -1, valid


_BUILD_CASES = ("duplicates", "unique", "all_ghost_cluster",
                "ghosts_over_a_run", "wrap_through_last_slot",
                "one_home_1000_rows", "rounds_below_t", "rounds_above_t")


def _build_profile(torch, fn):
    """(build kernel -> launches, every device event name) of one call of
    ``fn``, from a profile of the device (retried as ``_kernels_seen``
    retries)."""
    fn()
    torch.cuda.synchronize()
    kernels, names = {}, set()
    for attempt in range(_PROFILE_ATTEMPTS):
        prof, _ = _profiled(torch, fn)
        names = {e.key for e in prof.key_averages()}
        kernels = {}
        for row in _device_events(prof):
            for sym in _KERNEL_SYMBOLS["build_table"]:
                if sym in row[0]:
                    kernels[sym] = kernels.get(sym, 0) + row[1]
        if kernels:
            break
        print(f"profile of build_table: no build kernel in attempt "
              f"{attempt + 1}", flush=True)
    return kernels, names


def _syncs(names):
    """The events of a build's profile that read back or synchronise
    (``torch.cuda.synchronize`` at the window's end aside)."""
    return sorted(n for n in names
                  if "Memcpy DtoH" in n or "cudaStreamSynchronize" in n)


# cycles of the spin that ``_waits_ms`` queues ahead of a call (~0.1 s)
_SPIN_CYCLES = 200_000_000


def _waits_ms(torch, fn):
    """Host milliseconds of one call of ``fn`` made while the card runs a
    spin of ``_SPIN_CYCLES`` (``torch.cuda._sleep``) queued ahead of it: a
    call that synchronises or reads a result back waits for the spin, one
    that only queues its work returns at once. ``fn`` runs once before,
    so that its allocations are cached."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(_SPIN_CYCLES)
    t0 = time.perf_counter()
    fn()
    waited = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return waited


def _build_inputs(torch, hp):
    """``_BUILD_CASES``' inputs, from one seed."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    return {case: _build_case(torch, hp, case, gen) for case in _BUILD_CASES}


def check_build_cases(torch, hp, failures):
    """``_BUILD_CASES`` on the card, each bit-identical to
    ``build_table_plain``, with the route it took (the passes below
    ``table_size`` rows, the rounds from it). Misses go into
    ``failures``."""
    for case, (keys, vals, t, empty, valid) in _build_inputs(torch,
                                                             hp).items():
        got = hp.build_table(keys, vals, t, empty, valid)
        want = hp.build_table_plain(keys, vals, t, empty, valid)
        torch.cuda.synchronize()
        bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        n = keys.shape[0]
        nv = n if valid is None else int(valid.sum())
        route = "rounds" if n >= t else "passes"
        if bad:
            failures.append(f"build_table[{case}]: {bad} slots differ from "
                            "the plain version")
        print(f"check build_table[{case}]: rows={n} valid={nv} slots={t} "
              f"route={route} rounds={_rounds(torch, hp, got[0])}: "
              + ("bit-identical" if not bad else f"{bad} slots differ"),
              flush=True)


def check_build_launches(torch, hp, failures):
    """The kernels a ``build_table`` call launches, by profile, for the
    unique and the duplicate keys of ``_BUILD_CASES`` (the same rows and
    slots): they must be the same kernels the same number of times,
    ``ceil(log2 T / 8) + 3``, with no read-back or stream synchronisation:
    no ``Memcpy DtoH`` in the profile, and a call queued behind a 0.1 s
    spin returns within 20 ms (``_waits_ms``). It runs after phase 9: a
    process whose first profile comes before the threads and streams of
    phases 5-8 loses the device events of later profiles (PERF.md §7).
    Misses go into ``failures``."""
    inputs = _build_inputs(torch, hp)
    seen = {}
    for case in ("unique", "duplicates"):
        kernels, names = _build_profile(
            torch, lambda a=inputs[case]: hp.build_table(*a))
        seen[case] = kernels
        t = inputs[case][2]
        want = (t.bit_length() - 1 + 7) // 8 + 3
        waited = _waits_ms(torch, lambda a=inputs[case]: hp.build_table(*a))
        print(f"check build_table[{case}] launches: {json.dumps(kernels)} "
              f"({sum(kernels.values())}, want {want}); read-backs "
              f"{_syncs(names)}; {waited:.3f} ms on the host behind a 0.1 s "
              "spin", flush=True)
        if sum(kernels.values()) != want or _syncs(names) or waited > 20:
            failures.append(f"build_table[{case}]: launched {kernels}, "
                            f"read back {_syncs(names)}, waited {waited} ms")
    if seen["unique"] != seen["duplicates"]:
        failures.append(f"build_table: duplicates launched "
                        f"{seen['duplicates']}, unique {seen['unique']}")


def run_build(torch, hp):
    """``--build``: the build checks alone (``check_build_cases`` and
    ``check_build_launches``)."""
    failures = []
    check_build_cases(torch, hp, failures)
    check_build_launches(torch, hp, failures)
    if failures:
        fail("; ".join(failures))


# the standalone probe's cases on synthetic tables (``--probe`` runs them
# alone): tables of 1, 2, 4 and 8 slots, tables of 1,024 slots 95% full
# (random slots, and a build of 972 rows of 300 keys) whose runs cross
# 32-byte sectors and wrap at T, max_probes of 1-7 ending inside a
# sector, every probe key -1, keys at a view 1-3 rows past a 16-byte
# boundary, the table at a view one slot off, and 1-5 keys
_PROBE_CASES = ("T=1", "T=2", "T=4", "T=8", "dense T=1024",
                "max_probes 1-7", "keys -1", "keys view +1..3",
                "table view +1", "n=1..5")


def _probe_inputs(torch, hp, case, gen):
    """[(tk, tv, keys, max_probes), ...] of a probe case on the card: a
    table of ``t`` slots a ``full`` share occupied by keys of a small pool
    (duplicates along runs), probed by pool keys, absent keys and -1."""
    dev = "cuda"

    def table(t, full, off=0):
        occ = torch.rand(t + off, generator=gen, device=dev) < full
        tk = torch.randint(0, max(t // 2, 2), (t + off,), generator=gen,
                           device=dev, dtype=torch.int32)
        tk = torch.where(occ, tk, torch.full_like(tk, -1))
        tv = torch.randint(-2 ** 31, 2 ** 31 - 1, (t + off,), generator=gen,
                           device=dev, dtype=torch.int32)
        return tk[off:], tv[off:]

    def keys(n, t, off=0):
        k = torch.randint(-1, t, (n + off,), generator=gen, device=dev,
                          dtype=torch.int32)
        return k[off:]

    if case.startswith("T="):
        t = int(case[2:])
        tk, tv = table(t, 0.7)
        return [(tk, tv, keys(1000, t), mp) for mp in (1, t)]
    if case == "dense T=1024":
        tk, tv = table(1024, 0.95)
        # and a table the build filled to 95%: 972 rows of 300 keys, so
        # each key's rows lie along its run, runs long and clustered
        bk = torch.randint(0, 300, (972,), generator=gen, device=dev,
                           dtype=torch.int32)
        btk, btv = hp.build_table_plain(bk, torch.arange(
            972, dtype=torch.int32, device=dev), 1024)
        return ([(tk, tv, keys(1 << 16, 1024), mp) for mp in (64, 1024)]
                + [(btk, btv, keys(1 << 16, 400), mp) for mp in (64, 1024)])
    if case == "max_probes 1-7":
        tk, tv = table(1024, 0.95)
        return [(tk, tv, keys(1 << 16, 1024), mp) for mp in range(1, 8)]
    if case == "keys -1":
        tk, tv = table(256, 0.6)
        return [(tk, tv, torch.full((4099,), -1, dtype=torch.int32,
                                    device=dev), 256)]
    if case == "keys view +1..3":
        tk, tv = table(4096, 0.5)
        return [(tk, tv, keys(10_001, 4096, off), 64) for off in (1, 2, 3)]
    if case == "table view +1":
        tk, tv = table(4096, 0.9, 1)
        return [(tk, tv, keys(10_001, 4096), 4096)]
    if case == "n=1..5":
        tk, tv = table(64, 0.8)
        return [(tk, tv, keys(n, 64), 64) for n in range(1, 6)]
    raise ValueError(case)


def check_probe_cases(torch, hp, failures):
    """``_PROBE_CASES`` on the card, found and values each exactly the
    plain version's. Misses go into ``failures``."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    for case in _PROBE_CASES:
        bad = 0
        hits = 0
        for tk, tv, pk, mp in _probe_inputs(torch, hp, case, gen):
            got = hp.hash_probe(tk, tv, pk, -1, mp)
            want = hp.hash_probe_plain(tk, tv, pk, -1, mp)
            torch.cuda.synchronize()
            bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            hits += int(want[0].sum())
        if bad:
            failures.append(f"hash_probe[{case}]: {bad} found/values differ "
                            "from the plain version")
        print(f"check hash_probe[{case}]: hits={hits}: "
              + ("exact" if not bad else f"{bad} differ"), flush=True)


def run_probe(torch, hp):
    """``--probe``: the standalone and expansion probes' synthetic cases
    alone."""
    failures = []
    check_probe_cases(torch, hp, failures)
    check_multi_cases(torch, hp, failures)
    if failures:
        fail("; ".join(failures))


# the exchange's metadata pass on synthetic sources (``--partition`` runs
# them alone): n of 0, 5, 100,003 and 2^22 rows a source at each W of 1-8
# (one int32 key, 70% live), then at W = 4 a bytes key (18 lanes) beside
# an int32 one, three int32 keys, every column and validity at views 1-3
# rows off their boundaries (the bytes column too), bool, int64 and
# float32 keys (cast to int32), every row dead, one row a source, and
# sources of unequal sizes
_PART_NS = (0, 5, 100_003, 1 << 22)
_PART_CASES = tuple(f"n={n} W={w}" for n in _PART_NS for w in range(1, 9)) + (
    "bytes W=4", "three cols W=4", "views W=4", "cast W=4", "dead W=4",
    "one row W=4", "ragged W=4")


def _partition_inputs(torch, case, gen):
    """(key columns a source, validity a source, W) of a partition case."""
    dev = "cuda"

    def ints(n, off=0):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n + off,), generator=gen,
                             device=dev, dtype=torch.int32)[off:]

    def valid(n, off=0, share=0.7):
        return (torch.rand(n + off, generator=gen, device=dev) < share)[off:]

    def lanes(n, width=18, off=0):
        return torch.randint(0, 256, (n + off, width), generator=gen,
                             device=dev, dtype=torch.uint8)[off:]

    if case.startswith("n="):
        n, w = (int(x.split("=")[1]) for x in case.split())
        return [[ints(n)] for _ in range(w)], [valid(n) for _ in range(w)], w
    w, n = 4, 100_003
    if case == "bytes W=4":
        return ([[lanes(n), ints(n)] for _ in range(w)],
                [valid(n) for _ in range(w)], w)
    if case == "three cols W=4":
        return ([[ints(n), ints(n), ints(n)] for _ in range(w)],
                [valid(n) for _ in range(w)], w)
    if case == "views W=4":
        return ([[ints(n, 1 + s % 3), lanes(n, 7, s), ints(n, 3 - s % 3)]
                 for s in range(w)],
                [valid(n, (s + 2) % 4) for s in range(w)], w)
    if case == "cast W=4":
        return ([[valid(n), ints(n).to(torch.int64) * 3 - 7,
                  torch.randn(n, generator=gen, device=dev) * 1e6]
                 for _ in range(w)], [valid(n) for _ in range(w)], w)
    if case == "dead W=4":
        return ([[ints(n)] for _ in range(w)],
                [valid(n, 0, 0.0) for _ in range(w)], w)
    if case == "one row W=4":
        return [[ints(1)] for _ in range(w)], [valid(1, 0, 1.0)
                                               for _ in range(w)], w
    if case == "ragged W=4":
        ns = (0, 3, 1 << 20, 77_777)
        return [[ints(k)] for k in ns], [valid(k) for k in ns], w
    raise ValueError(case)


def check_partition_call(torch, rh, keys, valid, w, what, failures):
    """One metadata pass against ``partition_histogram_plain``: pids and
    counts exactly equal. A miss goes into ``failures``."""
    pids, counts = rh.partition_histogram(keys, valid, w)
    want_pids, want_counts = rh.partition_histogram_plain(keys, valid, w)
    torch.cuda.synchronize()
    bad = int((pids != want_pids).sum())
    same = not bad and torch.equal(counts, want_counts)
    if not same:
        failures.append(f"partition_histogram[{what}]: {bad} pids differ, "
                        f"counts {counts.tolist()} vs plain "
                        f"{want_counts.tolist()}")
    print(f"check partition_histogram[{what}]: rows "
          f"{[v.shape[0] for v in valid]} live {int(counts.sum())}: "
          + ("exact" if same else "differs"), flush=True)
    return pids, counts


def check_partition_cases(torch, rh, failures):
    """``_PART_CASES`` on the card (``check_partition_call`` each)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    for case in _PART_CASES:
        keys, valid, w = _partition_inputs(torch, case, gen)
        check_partition_call(torch, rh, keys, valid, w, case, failures)


def run_partition(torch, rh):
    """``--partition``: the metadata pass's synthetic cases and the
    standalone histogram's grace shapes alone."""
    failures = []
    check_partition_cases(torch, rh, failures)
    check_hist_cases(torch, rh, failures)
    if failures:
        fail("; ".join(failures))


def check_join(torch, hp, fused, calls, rate):
    """build_table, hash_probe and the fused probe, each against its plain
    version on the card, exact, on the inputs the main path gives them at
    SF 1 (``capture_calls``): Q3's and Q10's five builds, every standalone
    probe of the 22 queries and the first morsel of each fused probe. Then
    synthetic cases: the builds of ``_BUILD_CASES``, the probes of
    ``_PROBE_CASES``, and 1 << 20 probe keys with hits, misses and -1 into
    Q3's orders table. The builds and the fused probe are timed on their
    largest main-path input of Q3 and of Q10 (the standalone probe after
    phase 9, on its heaviest main-path calls: ``probe_row``)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(14)
    for c in calls["build"]:
        check_build_call(torch, hp, c, f"Q{c['q']}")
    failures = []
    check_build_cases(torch, hp, failures)
    if failures:
        fail("; ".join(failures))
    for c in calls["probe"]:
        check_probe_call(torch, hp, c, f"Q{c['q']}")
    check_probe_cases(torch, hp, failures)
    if failures:
        fail("; ".join(failures))
    for c in calls["fused"]:
        check_fused_probe_call(torch, fused, c, f"Q{c['q']}")
    # the probe variant on the views of _FUSED_VIEWS of Q3's first call
    c = calls["fused"][0]
    for label, sl in _FUSED_VIEWS:
        check_fused_probe_call(torch, fused, dict(c, table=view(c["table"], sl)),
                               f"Q{c['q']} {label}")

    rows_out, launchers = [], {}

    def row(name, source, replaces, ms, plain_ms, nbytes, ops):
        b, by = bound_ms(nbytes, ops, rate)
        rows_out.append(dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=0.0, ms=ms,
                             plain_ms=plain_ms, bound_ms=b, bound_by=by,
                             library_ms=None))

    table_cu = "src/repro_torch/kernels/csrc/hash_table.cu"
    for q in (3, 10):
        c = _largest(calls["build"], q, lambda c: c["t"])
        args = (c["keys"], c["vals"], c["t"], c["empty"], c["valid"])
        name = f"build_table[Q{q}]"
        launchers[name] = lambda a=args: hp.build_table(*a)
        # a hash and a compare a row
        row(name, table_cu, "src/repro/kernels/hash_probe.py:122",
            time_ms(torch, launchers[name], reps=10),
            time_ms(torch, lambda a=args: hp.build_table_plain(*a), reps=3,
                    warm=1),
            build_bytes(torch, c), c["keys"].shape[0] * 8)

    # an extra case off the main path: 1 << 20 keys into Q3's orders table,
    # hits, keys of orders the build filtered out, absent keys and -1
    b3 = _largest(calls["build"], 3, lambda c: c["t"])
    tk, tv = b3["table"]
    mp = hp.probe_bound(tk)
    np_ = 1 << 20
    keys = b3["keys"]
    pk = keys[torch.randint(0, keys.shape[0], (np_,), generator=gen,
                            device=dev)]
    r = torch.rand(np_, generator=gen, device=dev)
    pk = torch.where(r < 0.2, pk + (1 << 28), pk)
    pk = torch.where(r > 0.95, torch.full_like(pk, -1), pk)
    got = hp.hash_probe(tk, tv, pk, -1, mp)
    want = hp.hash_probe_plain(tk, tv, pk, -1, mp)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("hash_probe 1 << 20 keys differs from the plain version")
    ms = time_ms(torch, lambda: hp.hash_probe(tk, tv, pk, -1, mp))
    b, _ = bound_ms(np_ * 9 + probe_table_bytes(torch, hp, tk, pk, mp), 0,
                    rate)
    print(f"check hash_probe keys={np_} slots={tk.shape[0]} max_probes={mp} "
          f"hits={int(got[0].sum())}: exact; ms={ms} bound_ms={b}",
          flush=True)

    # the fused probe: the first lineitem morsel of each query, its scan
    # stages, the probe of l_orderkey into the orders table
    for q in (3, 10):
        c = next(c for c in calls["fused"]
                 if c["q"] == q and c["probe"]["probe_keys"] == ("l_orderkey",))
        table, stages, probe, program = (c["table"], c["stages"], c["probe"],
                                         c["program"])
        name = f"fused_morsel_probe[Q{q}]"
        launchers[name] = (lambda t_=table, st=stages, pr=probe, p=program:
                           fused.fused_morsel_program(t_, st, probe=pr,
                                                      program=p))
        m = table.capacity
        # columns and validity in and out, found and bidx out, the table
        # sectors the runs of every row's key visit (dead rows are probed
        # too: bidx is defined everywhere)
        nbytes = (m * (sum(table.columns[x].element_size()
                           for x in program.in_names) + 1)
                  + m * (sum(c["out"].columns[x].element_size()
                             for x in program.out_names) + 1)
                  + m * 5 + probe_table_bytes(torch, hp, probe["tk"], c["key"],
                                              probe["max_probes"],
                                              probe["empty_key"]))
        alu = sum(1 for op in program.code[:, 0].tolist()
                  if op >= fused.OPS["FILTER"]) + 8
        row(name, "src/repro_torch/kernels/csrc/fused_morsel.cu",
            "src/repro/core/fused.py:78",
            time_ms(torch, launchers[name]),
            time_ms(torch, lambda t_=table, st=stages, pr=probe:
                    fused.apply_probe(fused.apply_stages(t_, st), pr)),
            nbytes, m * alu)
    return rows_out, launchers


def _bits_equal(torch, a, b):
    """Same dtype and shape and the same bits (a NaN equals the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_compact(torch, bps, calls, rate):
    """block_prefix_sum on the first compaction mask of Q9 (the expansion
    join's P x 4 rows) and of Q22 (the 1-row scalar side of its
    ScalarBroadcast), exact against the plain version (cumsum - mask);
    timed on Q9's."""
    for c in calls["compact"]:
        if c["q"] not in (9, 22):
            continue
        got, want = bps.block_prefix_sum(c["mask"]), bps.block_prefix_sum_plain(c["mask"])
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"block_prefix_sum Q{c['q']} differs from the plain version")
        print(f"check block_prefix_sum Q{c['q']}: rows={c['mask'].shape[0]} "
              f"set={int(want[1])}: exact", flush=True)
    c = next(c for c in calls["compact"] if c["q"] == 9)
    mask = c["mask"]
    n = mask.shape[0]
    name = "block_prefix_sum[Q9]"
    launchers = {name: lambda: bps.block_prefix_sum(mask)}
    # the mask read once, the positions and the total written once
    b, by = bound_ms(n * 1 + n * 4 + 4, n, rate)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/block_prefix_sum.cu",
               replaces="src/repro/kernels/block_prefix_sum.py:40",
               max_abs_err=0.0, ms=time_ms(torch, launchers[name]),
               plain_ms=time_ms(torch, lambda: bps.block_prefix_sum_plain(mask)),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(torch, lambda: torch.cumsum(
                   mask, 0, dtype=torch.int32)))
    return [row], launchers


# segmented_minmax's cases on synthetic inputs (``--segmented`` runs them
# beside the sums'), each min and max, through the wrapper and through the
# C entry on an output filled with a pattern first (every group must be
# written): float32 with NaNs of both signs, +-inf, +-0 and subnormals
# (sorted ids, shared partials); random float32 bit patterns (unsorted
# ids, the first G of global updates); int32 extremes at the largest
# shared G; Q2's shape (sorted live ids, a dead tail carrying the
# identity, G = 2^20); unsorted ids with ids out of range; G = 1; ids and
# values at views 1-3 rows past a 16-byte boundary; 1-5 rows
_MINMAX_CASES = ("specials f32 G=4096", "random bits f32 G=8193",
                 "int32 extremes G=8192", "dead tail G=2^20",
                 "unsorted G=16", "G=1", "views +1..3", "n=1..5")
# what an output holds before a patterned check: a value or slot the
# kernel leaves unwritten keeps it
_POISON = 0x5A5A5A5A


def _minmax_inputs(torch, case, gen):
    """[(ids, values, G), ...] of a ``_MINMAX_CASES`` case on the card."""
    dev = "cuda"

    def ids(n, lo, hi, sort=False):
        x = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(x).values if sort else x

    def bits(n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)

    def floats(n):
        return torch.randn(n, generator=gen, device=dev) * 100

    rows = _MAIN_ROWS
    if case == "specials f32 G=4096":
        g = 4096
        gids = ids(rows, 0, g + 1, sort=True)
        v = floats(rows)
        r = torch.rand(rows, generator=gen, device=dev)
        nan = torch.tensor([0x7FC00000, -0x00400000, 0x7F800001, -1],
                           dtype=torch.int32, device=dev).view(torch.float32)
        sub = (bits(rows) & -0x7F800001).view(torch.float32)  # subnormals
        v = torch.where(r < 0.01, float("inf"), v)
        v = torch.where(r > 0.99, float("-inf"), v)
        v = torch.where((r > 0.5) & (r < 0.5004),
                        nan[ids(rows, 0, 4).long()], v)
        v = torch.where((r > 0.3) & (r < 0.32), sub, v)
        # every fifth group holds only zeros of both signs
        zero = torch.where(r < 0.5, 0.0, -0.0)
        v = torch.where(gids % 5 == 0, zero, v)
        return [(gids, v, g)]
    if case == "random bits f32 G=8193":
        g = 8193
        return [(ids(rows, -2, g + 4), bits(rows).view(torch.float32), g)]
    if case == "int32 extremes G=8192":
        g = 8192
        v = bits(rows)
        r = torch.rand(rows, generator=gen, device=dev)
        v = torch.where(r < 0.01, 2 ** 31 - 1, v)
        v = torch.where(r > 0.99, -2 ** 31, v).to(torch.int32)
        return [(ids(rows, 0, g + 1, sort=True), v, g)]
    if case == "dead tail G=2^20":
        n, live, g = 800_000, 600_000, 1 << 20
        gids = torch.full((n,), g, dtype=torch.int32, device=dev)
        gids[:live] = ids(live, 0, g, sort=True)
        v = torch.where(gids < g, floats(n).abs() + 1.0, float("inf"))
        return [(gids, v, g), (gids, bits(n), g)]
    if case == "unsorted G=16":
        n, g = 100_003, 16
        gids = ids(n, -2, g + 4)
        return [(gids, floats(n), g), (gids, bits(n), g)]
    if case == "G=1":
        n = 5_001
        pick = torch.tensor([0, 1, -1, 0], dtype=torch.int32, device=dev)
        return [(pick[ids(n, 0, 4).long()], floats(n), 1)]
    if case == "views +1..3":
        n, g = 100_001, 700
        out = []
        for oi, ov in ((1, 2), (3, 0), (2, 2)):
            gids = ids(n + 8, 0, g, sort=True)[oi:oi + n]
            out += [(gids, floats(n + 8)[ov:ov + n], g),
                    (gids, bits(n + 8)[ov:ov + n], g)]
        return out
    if case == "n=1..5":
        return [(ids(n, -1, 4), floats(n), 3) for n in range(1, 6)]
    raise ValueError(case)


def _minmax_entry(torch, seg, gids, vals, g, kind):
    """``segmented_minmax`` through its C entry onto an output filled with
    ``_POISON`` first."""
    from repro_torch.kernels import build
    symbol = ("segmented_minmax_f32" if vals.dtype == torch.float32
              else "segmented_minmax_i32")
    out = torch.full((g,), _POISON, dtype=torch.int32, device=gids.device)
    fn = build.function(seg._LIB, symbol, seg._MINMAX_ARGTYPES,
                        device=gids.device)
    rc = fn(gids.data_ptr(), vals.data_ptr(), gids.shape[0], g,
            int(kind == "min"), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(seg._LIB, rc, "segmented_minmax")
    return out.view(vals.dtype)


def check_minmax_cases(torch, seg, failures):
    """``_MINMAX_CASES`` on the card, min and max, the wrapper's output and
    the entry's on a patterned output each bit-exact against the plain
    version. Misses go into ``failures``."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for case in _MINMAX_CASES:
        bad = 0
        for gids, vals, g in _minmax_inputs(torch, case, gen):
            for kind in ("min", "max"):
                want = seg.segmented_minmax_plain(gids, vals, g, kind)
                for got in (seg.segmented_minmax(gids, vals, g, kind),
                            _minmax_entry(torch, seg, gids, vals, g, kind)):
                    torch.cuda.synchronize()
                    bad += int((got.view(torch.int32)
                                != want.view(torch.int32)).sum())
        if bad:
            failures.append(f"segmented_minmax[{case}]: {bad} groups differ "
                            "from the plain version")
        print(f"check segmented_minmax[{case}]: min and max, wrapper and "
              "patterned output: "
              + ("bit-exact" if not bad else f"{bad} groups differ"),
              flush=True)


def check_minmax_call(torch, seg, c, what):
    """One captured ``segmented_minmax`` call against its plain version,
    bit-exact."""
    got = seg.segmented_minmax(c["gids"], c["values"], c["g"], c["kind"])
    want = seg.segmented_minmax_plain(c["gids"], c["values"], c["g"],
                                      c["kind"])
    torch.cuda.synchronize()
    if not _bits_equal(torch, got, want):
        fail(f"segmented_minmax {what} differs from the plain version")
    print(f"check segmented_minmax {what} {c['kind']}({c['values'].dtype}): "
          f"rows={c['gids'].shape[0]} G={c['g']}: bit-exact", flush=True)


def check_minmax(torch, seg, calls):
    """segmented_minmax on every main-path call at one worker (Q2's grouped
    min: sorted ids, dead rows carrying the identity), then
    ``_MINMAX_CASES``: bit-exact against the plain version (order-free)."""
    for c in calls:
        check_minmax_call(torch, seg, c, f"Q{c['q']}")
    failures = []
    check_minmax_cases(torch, seg, failures)
    if failures:
        fail("; ".join(failures))


def minmax_shape(torch, c, rate):
    """The shape of a captured ``segmented_minmax`` call and its bound:
    every id read, the value of every row whose id is in [0, G) read and
    the G results written once (``bound_us``), as the sums' bound counts
    them; beside it the bound with every row's value read
    (``full_bound_us``)."""
    gids, g = c["gids"], c["g"]
    n = gids.shape[0]
    live = (gids >= 0) & (gids < g)
    ids = gids[live]
    nlive = int(live.sum())
    size = c["values"].element_size()
    b, by = bound_ms(n * 4 + nlive * size + g * size, n, rate)
    fb, _ = bound_ms(n * 4 + n * size + g * size, n, rate)
    return dict(rows=n, groups=g, live_rows=nlive,
                live_groups=int(torch.unique(ids).numel()),
                dtype=str(c["values"].dtype).replace("torch.", ""),
                sorted=bool((ids[1:] >= ids[:-1]).all()),
                bound_us=b * 1e3, full_bound_us=fb * 1e3, bound_by=by)


def report_minmax(torch, seg, calls, rate):
    """Every captured ``segmented_minmax`` call (``capture_calls`` at W = 1,
    ``capture_workers`` at W = 4): device µs of every event of a call
    (``call_device_us``: its kernels, a fill among them); a line a call
    and the sums at each W. Returns the heaviest group of calls (one
    query, W and shape)."""
    groups, sums = {}, {}
    for c in calls:
        c["shape"] = minmax_shape(torch, c, rate)
        c["device_us"] = call_device_us(torch, lambda c=c: seg.segmented_minmax(
            c["gids"], c["values"], c["g"], c["kind"]))
        print(f"shape segmented_minmax Q{c['q']} W={c['w']}: "
              f"{json.dumps(c['shape'])} device_us={c['device_us']:.3f}",
              flush=True)
        groups.setdefault((c["q"], c["w"], c["g"], c["gids"].shape[0]),
                          []).append(c)
        s = sums.setdefault(c["w"], [0, 0.0, 0.0])
        s[0], s[1], s[2] = (s[0] + 1, s[1] + c["device_us"],
                            s[2] + c["shape"]["bound_us"])
    for w, (k, u, b) in sorted(sums.items()):
        print(f"shape segmented_minmax W={w}: {k} calls, device_us {u:.3f}, "
              f"bound_us {b:.3f}", flush=True)
    return max(groups.values(), key=lambda g: sum(c["device_us"] for c in g))


def minmax_row(torch, seg, calls, rate):
    """segmented_minmax's row of the kernels line, on the heaviest group of
    main-path calls (``report_minmax``): its first call timed (CUDA
    events; the wrapper's host µs a call), its plain version, one
    ``scatter_reduce_`` into a G + 1 buffer (``library_ms``);
    ``device_ms`` the group's mean."""
    group = report_minmax(torch, seg, calls, rate)
    c = group[0]
    gids, vals, g, kind = c["gids"], c["values"], c["g"], c["kind"]
    name = (f"segmented_minmax[Q{c['q']}]" if c["w"] == 1
            else f"segmented_minmax[Q{c['q']} W={c['w']}]")
    launcher = lambda: seg.segmented_minmax(gids, vals, g, kind)  # noqa: E731
    buf = torch.empty(g + 1, dtype=vals.dtype, device=gids.device)
    lib_ids = torch.where((gids >= 0) & (gids < g), gids, g).long()
    ident = seg._identity(vals.dtype, kind)

    def library():
        buf.fill_(ident)
        buf.scatter_reduce_(0, lib_ids, vals,
                            "amin" if kind == "min" else "amax",
                            include_self=True)

    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/segmented_agg.cu",
               replaces="src/repro/kernels/segmented_agg.py:188",
               max_abs_err=0.0, ms=time_ms(torch, launcher),
               plain_ms=time_ms(torch, lambda: seg.segmented_minmax_plain(
                   gids, vals, g, kind)),
               bound_ms=c["shape"]["bound_us"] / 1e3,
               bound_by=c["shape"]["bound_by"],
               library_ms=time_ms(torch, library),
               device_ms=sum(x["device_us"] for x in group) / len(group) / 1e3,
               host_us=host_us(torch, launcher), calls=len(group),
               **{k: v for k, v in c["shape"].items()
                  if k not in ("bound_us", "bound_by")})
    print(f"row {json.dumps(row)}", flush=True)
    return [row], {name: launcher}


# hash_probe_multi's cases on synthetic tables (``--probe`` runs them
# beside the single probe's), each through the wrapper and through the C
# entry on outputs filled with a pattern first (every count and every slot
# must be written): a build of 2^18 rows over 2^15 keys (some 8 rows a
# key, past m) probed by hits, misses and -1 at m = 4 (the run read in
# 16-byte groups of slots, a row one 16-byte store) and m = 3 (rows staged
# in shared memory), then m of 1, 2, 8, 9 and 300 (past shared memory: a
# store a slot); runs that wrap at T = 64; tables of 1-8 slots (below 4
# the rows are staged); a table one slot off its 16-byte boundary (the
# same); max_probes 1-7 cutting runs; every key -1; keys at views 1-3
# rows past a 16-byte boundary; 1-5 keys
_MULTI_CASES = ("duplicates m=4", "duplicates m=3", "m=1", "m=2", "m=8",
                "m=9", "m=300", "wrap T=64", "T=1..8", "table view +1",
                "max_probes 1-7", "keys -1", "keys view +1..3", "n=1..5")


def _multi_inputs(torch, hp, case, gen):
    """[(tk, tv, keys, m, max_probes), ...] of a ``_MULTI_CASES`` case."""
    dev = "cuda"

    def keys(n, hi, off=0):
        return torch.randint(-1, hi, (n + off,), generator=gen, device=dev,
                             dtype=torch.int32)[off:]

    def built(nb, pool, t):
        bk = torch.randint(-1, pool, (nb,), generator=gen, device=dev,
                           dtype=torch.int32)
        tk, tv = hp.build_table(bk, torch.arange(nb, dtype=torch.int32,
                                                 device=dev), t)
        return tk, tv, hp.probe_bound(tk)

    if case.startswith("duplicates") or case in ("m=1", "m=2", "m=8", "m=9"):
        tk, tv, mp = built(1 << 18, 1 << 15, 1 << 19)
        n = 1 << 20 if case.startswith("duplicates") else 1 << 16
        return [(tk, tv, keys(n, 1 << 16), int(case.split("=")[1]), mp)]
    if case == "m=300":
        # 3,000 rows of 10 keys: some 300 rows a key along one cluster
        tk, tv, mp = built(3000, 10, 4096)
        return [(tk, tv, keys(2048, 12), 300, mp)]
    if case == "wrap T=64":
        tk, tv, _ = built(50, 20, 64)
        return [(tk, tv, keys(1000, 24), m, 64) for m in (4, 3)]
    if case == "T=1..8":
        out = []
        for t in (1, 2, 4, 8):
            tk, tv, _ = built(t - 1 if t > 1 else 0, 3, t)
            out += [(tk, tv, keys(500, 4), m, t) for m in (4, 1, 3)]
        return out
    if case == "table view +1":
        tk, tv, mp = built(2000, 500, 4096)
        tk2 = torch.empty(4097, dtype=torch.int32, device=dev)
        tv2 = torch.empty(4097, dtype=torch.int32, device=dev)
        tk2[1:], tv2[1:] = tk, tv
        return [(tk2[1:], tv2[1:], keys(10_001, 600), m, mp) for m in (4, 3)]
    if case == "max_probes 1-7":
        tk, tv, _ = built(900, 300, 1024)
        k = keys(1 << 14, 400)
        return [(tk, tv, k, m, mp) for mp in range(1, 8) for m in (4, 3)]
    if case == "keys -1":
        tk, tv, mp = built(150, 100, 256)
        return [(tk, tv, torch.full((4099,), -1, dtype=torch.int32,
                                    device=dev), m, mp) for m in (4, 3)]
    if case == "keys view +1..3":
        tk, tv, mp = built(2000, 500, 4096)
        return [(tk, tv, keys(10_001, 600, off), 4, mp) for off in (1, 2, 3)]
    if case == "n=1..5":
        tk, tv, mp = built(40, 10, 64)
        return [(tk, tv, keys(n, 12), m, mp) for n in range(1, 6)
                for m in (4, 3)]
    raise ValueError(case)


def _multi_entry(torch, hp, tk, tv, pk, m, mp):
    """``hash_probe_multi`` through its C entry onto a count and slots
    filled with ``_POISON`` first."""
    from repro_torch.kernels import build
    n = pk.shape[0]
    count = torch.full((n,), _POISON, dtype=torch.int32, device=pk.device)
    slots = torch.full((n, m), _POISON, dtype=torch.int32, device=pk.device)
    fn = build.function(hp._LIB, "hash_table_probe_multi",
                        hp._PROBE_MULTI_ARGTYPES, device=pk.device)
    rc = fn(tk.data_ptr(), tv.data_ptr(), tk.shape[0], min(mp, tk.shape[0]),
            -1, pk.data_ptr(), n, m, count.data_ptr(), slots.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(hp._LIB, rc, "hash_probe_multi")
    return count, slots


def check_multi_cases(torch, hp, failures):
    """``_MULTI_CASES`` on the card, counts and every slot of the wrapper's
    output and of the entry's on patterned outputs each exactly the plain
    version's. Misses go into ``failures``."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    for case in _MULTI_CASES:
        bad = matches = 0
        for tk, tv, pk, m, mp in _multi_inputs(torch, hp, case, gen):
            want = hp.hash_probe_multi_plain(tk, tv, pk, m, -1, mp)
            matches += int(want[0].sum())
            for got in (hp.hash_probe_multi(tk, tv, pk, m, -1, mp),
                        _multi_entry(torch, hp, tk, tv, pk, m, mp)):
                torch.cuda.synchronize()
                bad += int((got[0] != want[0]).sum()
                           + (got[1] != want[1]).sum())
        if bad:
            failures.append(f"hash_probe_multi[{case}]: {bad} counts/slots "
                            "differ from the plain version")
        print(f"check hash_probe_multi[{case}]: matches={matches}, wrapper "
              "and patterned outputs: "
              + ("exact" if not bad else f"{bad} differ"), flush=True)


def _multi_args(c):
    return (c["tk"], c["tv"], c["keys"], c["m"], c["empty"], c["max_probes"])


def check_multi_call(torch, hp, c, what):
    """One captured ``hash_probe_multi`` call against its plain version:
    counts and every slot (zeros past the count) exact."""
    got = hp.hash_probe_multi(*_multi_args(c))
    want = hp.hash_probe_multi_plain(*_multi_args(c))
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"hash_probe_multi {what} differs from the plain version")
    print(f"check hash_probe_multi {what}: keys={c['keys'].shape[0]} "
          f"slots={c['tk'].shape[0]} m={c['m']} max_probes="
          f"{c['max_probes']} matches={int(got[0].sum())}: exact",
          flush=True)


def check_multi(torch, hp, calls):
    """hash_probe_multi on every main-path call at one worker (Q9's and
    Q20's expansion probes: lineitem's and partsupp's composite keys,
    packed, into the partsupp and the aggregate's tables, m = 4), then
    ``_MULTI_CASES``."""
    for c in calls:
        check_multi_call(torch, hp, c, f"Q{c['q']}")
    failures = []
    check_multi_cases(torch, hp, failures)
    if failures:
        fail("; ".join(failures))


def multi_shape(torch, hp, c, rate):
    """The shape of a captured expansion probe: its matches, the slots its
    keys' runs walk a key (home slot to the m-th match, an empty slot or
    max_probes), whether the table's 8 B a slot fit the L2, and its bound:
    the keys in, counts and rows out, the table sectors the runs visit."""
    tk, keys, m = c["tk"], c["keys"], c["m"]
    t, n = tk.shape[0], keys.shape[0]
    home, key = hp.hash_home(keys, t), keys
    count = torch.zeros_like(key)
    walked = matches = 0
    for i in range(min(c["max_probes"], t)):
        walked += key.shape[0]
        k = tk.index_select(0, (home + i) & (t - 1))
        count = count + (k == key).to(count.dtype)
        go = ~((count >= m) | (k == c["empty"]))
        matches += int(count[~go].sum())
        home, key, count = home[go], key[go], count[go]
        if not key.numel():
            break
    matches += int(count.sum())
    b, by = bound_ms(n * (8 + 4 * m) + probe_table_bytes(
        torch, hp, tk, keys, c["max_probes"], c["empty"], m), n * 8, rate)
    return dict(keys=n, slots=t, m=m, max_probes=c["max_probes"],
                matches=matches, mean_walk=walked / max(n, 1),
                fits_l2=8 * t <= _L2_BYTES, bound_us=b * 1e3, bound_by=by)


def report_multi(torch, hp, calls, rate):
    """Every captured ``hash_probe_multi`` call (``capture_calls`` at W =
    1, ``capture_workers`` at W = 4), each launched once in profiles of
    100: a line a call and the sums at each W. Returns the heaviest group
    of calls (one query, W and shape) of each query."""
    fns = [lambda c=c: hp.hash_probe_multi(*_multi_args(c)) for c in calls]
    us = per_call_device_us(torch, fns, _KERNEL_SYMBOLS["hash_probe_multi"])
    groups, sums = {}, {}
    for c, u in zip(calls, us):
        c["shape"], c["device_us"] = multi_shape(torch, hp, c, rate), u
        print(f"shape hash_probe_multi Q{c['q']} W={c['w']}: "
              f"{json.dumps(c['shape'])} device_us={u:.3f}", flush=True)
        groups.setdefault((c["q"], c["w"], c["tk"].shape[0],
                           c["keys"].shape[0]), []).append(c)
        s = sums.setdefault(c["w"], [0, 0.0, 0.0])
        s[0], s[1], s[2] = s[0] + 1, s[1] + u, s[2] + c["shape"]["bound_us"]
    for w, (k, u, b) in sorted(sums.items()):
        print(f"shape hash_probe_multi W={w}: {k} calls, device_us {u:.3f}, "
              f"bound_us {b:.3f}", flush=True)
    heaviest = {}
    for key, g in groups.items():
        best = heaviest.get(key[0])
        if best is None or (sum(c["device_us"] for c in g)
                            > sum(c["device_us"] for c in best)):
            heaviest[key[0]] = g
    return [heaviest[q] for q in sorted(heaviest)]


def multi_rows(torch, hp, calls, rate):
    """hash_probe_multi's rows of the kernels line, one a query on its
    heaviest group of main-path calls (``report_multi``): the first call
    timed (CUDA events; the wrapper's host µs a call), its plain version,
    its bound; ``device_ms`` the group's mean."""
    rows_out, launchers = [], {}
    for group in report_multi(torch, hp, calls, rate):
        c = group[0]
        args = _multi_args(c)
        name = (f"hash_probe_multi[Q{c['q']}]" if c["w"] == 1
                else f"hash_probe_multi[Q{c['q']} W={c['w']}]")
        launchers[name] = lambda a=args: hp.hash_probe_multi(*a)
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/hash_table.cu",
            replaces="src/repro/kernels/hash_probe.py:209", max_abs_err=0.0,
            ms=time_ms(torch, launchers[name]),
            plain_ms=time_ms(torch, lambda a=args: hp.hash_probe_multi_plain(
                *a), reps=3, warm=1),
            bound_ms=c["shape"]["bound_us"] / 1e3,
            bound_by=c["shape"]["bound_by"], library_ms=None,
            device_ms=sum(x["device_us"] for x in group) / len(group) / 1e3,
            host_us=host_us(torch, launchers[name]), calls=len(group),
            **{k: v for k, v in c["shape"].items()
               if k not in ("bound_us", "bound_by")})
        print(f"row {json.dumps(row)}", flush=True)
        rows_out.append(row)
    return rows_out, launchers


def check_prefix_code(torch, fused, calls, rate):
    """The fused program on Q22's PrefixCode stages (the customer morsel
    with its uint8[N, 15] c_phone): output columns and validity
    bit-identical to ``apply_stages``."""
    for c in calls["fused_plain"]:
        table, stages, program = c["table"], c["stages"], c["program"]
        got, _, _ = fused.fused_morsel_program(table, stages, program=program)
        want = fused.apply_stages(table, stages)
        torch.cuda.synchronize()
        if not torch.equal(got.validity, want.validity):
            fail("fused Q22: validity differs from apply_stages")
        for col in want.column_names:
            if not _bits_equal(torch, got.columns[col], want.columns[col]):
                fail(f"fused Q22: column {col} differs")
        print(f"check fused_morsel_program Q22 rows={table.capacity}: "
              f"{program.code.shape[0]} instructions, widths "
              f"{program.in_widths}, valid={int(want.validity.sum())}: "
              "bit-identical", flush=True)
    c = max(calls["fused_plain"], key=lambda c: c["program"].code.shape[0])
    table, stages, program = c["table"], c["stages"], c["program"]
    out = fused.apply_stages(table, stages)
    name = "fused_morsel_program[Q22]"
    launchers = {name: lambda: fused.fused_morsel_program(table, stages,
                                                          program=program)}
    n = table.capacity
    nbytes = n * (sum(table.columns[x].element_size()
                      * (w if w else 1)
                      for x, w in zip(program.in_names, program.in_widths))
                  + 1 + sum(out.columns[x].element_size()
                            for x in program.out_names) + 1)
    alu = sum(1 for op in program.code[:, 0].tolist()
              if op >= fused.OPS["FILTER"] and op != fused.OPS["LOADB"])
    b, by = bound_ms(nbytes, n * alu, rate)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/fused_morsel.cu",
               replaces="src/repro/core/fused.py:78", max_abs_err=0.0,
               ms=time_ms(torch, launchers[name]),
               plain_ms=time_ms(torch, lambda: fused.apply_stages(table, stages)),
               bound_ms=b, bound_by=by, library_ms=None)
    return [row], launchers


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def compare(q, got, want, what="the CPU run"):
    """Exact for integer and bytes columns (keys, counts, names), rtol 2e-3
    for floats. Rows are matched by sorting on the exact columns; a bytes
    column ([N, W] uint8) sorts by its row bytes."""
    import numpy as np
    q = q if isinstance(q, int) else f" {q}"    # a label, not a query
    if sorted(got) != sorted(want):
        fail(f"Q{q}: columns {sorted(got)} vs {sorted(want)} of {what}")
    n = len(next(iter(want.values())))
    if any(len(v) != n for v in got.values()):
        fail(f"Q{q}: row count differs from {what}")
    ints = [c for c in sorted(want) if want[c].dtype.kind in "iub"]

    def sort_key(a):
        if a.ndim == 2:
            return np.array([row.tobytes() for row in a])
        return a

    def order(res):
        if not ints:
            return slice(None)
        return np.lexsort([sort_key(res[c]) for c in reversed(ints)])

    go, wo = order(got), order(want)
    for c in sorted(want):
        a, b = got[c][go], want[c][wo]
        if c in ints:
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"Q{q}: column {c} differs from {what}")
        else:
            if not np.all(np.isfinite(a)):
                fail(f"Q{q}: column {c} has non-finite values")
            if not np.allclose(a, b, rtol=2e-3, atol=1e-2):
                fail(f"Q{q}: column {c} differs from {what}: {a} vs {b}")


def expected_launches(ops, data):
    """Each query's launch counts at the main path's morsel size, from its
    tables' morsel counts: one fused launch per scanned morsel of a fused
    pipeline, one segmented-sum launch per aggregate per ``_aggregate`` call
    (one per morsel, one per merge), one build per hash join, one
    standalone probe per probe-side morsel of a join the scan cannot fuse
    (Q10's customer scan has no stage before its joins)."""
    def morsels(table):
        return math.ceil(len(next(iter(data[table].values()))) / _MAIN_ROWS)

    li, orders, cust = morsels("lineitem"), morsels("orders"), morsels("customer")
    calls = 2 * li - 1           # one _aggregate per morsel, one per merge

    def counts(**kw):
        out = dict.fromkeys(ops.KERNELS, 0)
        out.update(kw)
        return out

    return {6: counts(fused_morsel_program=li),
            1: counts(fused_morsel_program=li, segmented_sum=7 * calls,
                      segmented_int_sum=4 * calls),
            3: counts(fused_morsel_probe=orders + li, build_table=2,
                      segmented_sum=calls),
            10: counts(fused_morsel_probe=li, build_table=3,
                       hash_probe=2 * cust, segmented_sum=calls)}


def run_main_path(torch, data, catalog):
    """All 22 queries through the port's Session on the card, each against
    the same plan on the CPU; returns the launch counts of each query's
    timed run, the card's session, each query's result and its three
    walls."""
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    cpu = Session(catalog, device="cpu", batch_rows=_MAIN_ROWS)
    expect = expected_launches(ops, data)
    launches, results, walls = {}, {}, {}
    for q in _QUERIES:
        plan = queries.build_query(q, catalog)
        gpu.execute(plan)                       # warm: allocator, streams
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = gpu.execute(plan)
        torch.cuda.synchronize()
        gpu_s = [time.perf_counter() - t0]
        counts = ops.launch_counts()
        stats = gpu.executor_stats()
        for _ in range(2):                      # two more timed runs
            t0 = time.perf_counter()
            gpu.execute(plan)
            torch.cuda.synchronize()
            gpu_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = cpu.execute(plan)
        cpu_s = time.perf_counter() - t0
        compare(q, got, want)
        print(f"Q{q} SF {_SF}: gpu {[round(t, 4) for t in gpu_s]} s, "
              f"cpu {cpu_s:.4f} s, rows "
              f"{len(next(iter(got.values())))}, launches "
              f"{ {k: v for k, v in counts.items() if v} }, "
              f"kernel_dispatch {stats['kernel_dispatch']}", flush=True)
        if q in expect and counts != expect[q]:
            fail(f"Q{q}: launches {counts}, expected {expect[q]}")
        check_reaches(q, counts)
        launches[q], results[q], walls[q] = counts, got, gpu_s
    check_w1_kernels(ops, launches, "the main path")
    return launches, gpu, results, walls


def check_reaches(q, counts, what=""):
    """The all-queries kernels a W = 1 query must launch, and no other."""
    for kernel, qs in _REACHES.items():
        if (counts[kernel] > 0) != (q in qs):
            fail(f"Q{q}{what}: {counts[kernel]} launches of {kernel}; the "
                 f"queries that reach it are {qs}")
    if q == 22 and not counts["fused_morsel_program"]:
        fail(f"Q22{what}: its PrefixCode stages did not run in the fused "
             "kernel")


def check_w1_kernels(ops, launches, what):
    """Every kernel a W = 1 execute serves was launched by one of the 22
    queries; radix_histogram serves the exchange (phase 7 holds it),
    fused_batch_program the scheduler's stacked launches (phase 8) and
    flash_attention no query (phase 9 drives it)."""
    for k in ops.KERNELS:
        later = k in ("radix_histogram", "fused_batch_program",
                      "flash_attention")
        if not later and not any(c[k] for c in launches.values()):
            fail(f"kernel {k} was not launched by {what}")
        if later and any(c[k] for c in launches.values()):
            fail(f"{k} launched by a W=1 execute of {what}, which it does "
                 "not serve")


# ---------------------------------------------------------------------------
# phase 6 + 7: the exchange's kernel, then four workers on the card
# ---------------------------------------------------------------------------

def _repartitions(exchanges) -> int:
    """Repartition rounds of a query's ``exchanges`` stats (a
    repartition's fragment label names its keys, a broadcast's does not)."""
    return sum(v["rounds"] for k, v in exchanges.items() if "(" in k)


def capture_workers(torch, hp, fused, catalog):
    """The kernels' inputs at ``_WORKERS`` workers: one run of each of the
    22 queries through the card's Session with ``ICIExchange``, the kernel
    functions wrapped as in ``capture_calls``. Keeps the inputs of every
    repartition (each source worker's key columns and validity, as the
    metadata phase reads them), every ``hash_probe`` call, and every
    ``build_table`` and fused probe call of the queries of ``_CAPTURED_W``
    (each worker's repartitioned or broadcast build side, its
    repartitioned probe batches, its morsels), and every
    ``hash_probe_multi`` and ``segmented_minmax`` call."""
    from repro_torch.core import exchange as ex_mod
    from repro_torch.core.session import Session
    from repro_torch.kernels import segmented_agg as seg
    from repro_torch.tpch import queries
    calls = {"repartition": [], "build": [], "probe": [], "fused": [],
             "multi": [], "minmax": []}
    now = {}
    orig = (ex_mod.ICIExchange.repartition, hp.build_table, hp.hash_probe,
            fused.fused_morsel_program, hp.hash_probe_multi,
            seg.segmented_minmax)
    orig_data = ex_mod.ICIExchange.__dict__["_repartition_fused"]

    def repartition(self, tables, key_names, num_workers):
        ts = self._ensure_rows(tables)
        calls["repartition"].append(dict(
            q=now["q"], w=num_workers, names=tuple(key_names),
            keys=[[t.columns[k].clone() for k in key_names] for t in ts],
            valid=[t.validity.clone() for t in ts]))
        return orig[0](self, tables, key_names, num_workers)

    def data_phase(tables, pids, per_dst, out_cap):
        # CUDA events around the data phase (its host work between the
        # kernels included): the lead after the metadata pass
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_data.__func__(tables, pids, per_dst, out_cap)
        end.record()
        end.synchronize()
        calls["repartition"][-1]["data_ms"] = start.elapsed_time(end)
        return out

    def build_table(keys, vals, table_size, empty_key=-1, valid=None):
        if now["q"] in _CAPTURED_W:
            calls["build"].append(dict(
                q=now["q"], keys=keys.clone(), vals=vals.clone(),
                t=table_size, empty=empty_key,
                valid=None if valid is None else valid.clone()))
        return orig[1](keys, vals, table_size, empty_key, valid)

    def hash_probe(tk, tv, keys, empty_key=-1,
                   max_probes=hp.MAX_PROBES_DEFAULT):
        calls["probe"].append(dict(q=now["q"], w=_WORKERS, tk=tk, tv=tv,
                                   keys=keys.clone(), empty=empty_key,
                                   max_probes=max_probes))
        return orig[2](tk, tv, keys, empty_key, max_probes)

    def fused_morsel_program(table, stages, probe=None, program=None):
        if probe is not None and now["q"] in _CAPTURED_W:
            calls["fused"].append(dict(q=now["q"], table=table, stages=stages,
                                       probe=probe, program=program))
        return orig[3](table, stages, probe=probe, program=program)

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                  num_workers=_WORKERS)
    (ex_mod.ICIExchange.repartition, hp.build_table, hp.hash_probe,
     fused.fused_morsel_program, hp.hash_probe_multi,
     seg.segmented_minmax) = (
        repartition, build_table, hash_probe, fused_morsel_program,
        _keep_multi(hp, calls["multi"], now, _WORKERS, orig[4]),
        _keep_minmax(calls["minmax"], now, _WORKERS, orig[5]))
    ex_mod.ICIExchange._repartition_fused = staticmethod(data_phase)
    try:
        for q in _QUERIES:
            now["q"] = q
            gpu.execute(queries.build_query(q, catalog, num_workers=_WORKERS))
    finally:
        (ex_mod.ICIExchange.repartition, hp.build_table, hp.hash_probe,
         fused.fused_morsel_program, hp.hash_probe_multi,
         seg.segmented_minmax) = orig
        ex_mod.ICIExchange._repartition_fused = orig_data
    torch.cuda.synchronize()
    for kind in calls:
        if not calls[kind]:
            fail(f"W={_WORKERS} runs of the 22 queries made no {kind} call")
    return calls


def check_worker_joins(torch, hp, fused, calls):
    """The join kernels against their plain versions, exact, on every
    ``build_table`` and fused probe call of the queries of
    ``_CAPTURED_W`` and every ``hash_probe``, ``hash_probe_multi`` and
    ``segmented_minmax`` call at ``_WORKERS`` workers
    (``capture_workers``)."""
    from repro_torch.kernels import segmented_agg as seg
    for c in calls["build"]:
        check_build_call(torch, hp, c, f"Q{c['q']} W={_WORKERS}")
    for c in calls["probe"]:
        check_probe_call(torch, hp, c, f"Q{c['q']} W={_WORKERS}")
    for c in calls["multi"]:
        check_multi_call(torch, hp, c, f"Q{c['q']} W={_WORKERS}")
    for c in calls["minmax"]:
        check_minmax_call(torch, seg, c, f"Q{c['q']} W={_WORKERS}")
    for c in calls["fused"]:
        check_fused_probe_call(torch, fused, c, f"Q{c['q']} W={_WORKERS}")


def _bins(torch, pids, valid, w):
    """The (source, destination) bin of each row of a metadata pass's flat
    pids (``source * W + pid``; a dead row's pid W goes to the dropped bin
    W * W), as the exchange's former histogram took them."""
    src = torch.repeat_interleave(
        torch.arange(w, device=pids.device, dtype=torch.int32),
        torch.tensor([v.shape[0] for v in valid], device=pids.device))
    return torch.where(pids < w, pids + src * w,
                       torch.full_like(pids, w * w)).to(torch.int32)


def check_exchange(torch, rh, calls):
    """The exchange's metadata pass against ``partition_histogram_plain``,
    exact (pids and counts), on every repartition of the 22 queries at
    ``_WORKERS`` workers (``capture_workers``: each source's key columns and
    validity) and on ``_PART_CASES``; then the standalone
    ``radix_histogram`` on the bins of Q3's first repartition on
    ``l_orderkey`` (at SF 1 its lineitem rows: P = W * W bins of source and
    destination worker, the dead rows in the dropped bin W * W) and on
    edge cases: no ids, ids -1, P and INT32_MAX, P of 1, 4, 16, 8192 (the
    largest shared-memory histogram) and 8193 (global atomics), counts of
    ids that are no multiple of the 512-thread block. Integer counts:
    exact."""
    failures, ids = [], None
    for c in calls:
        pids, _ = check_partition_call(torch, rh, c["keys"], c["valid"], c["w"],
                                       f"Q{c['q']} W={c['w']} {c['names']}",
                                       failures)
        if ids is None and c["q"] == 3 and c["names"] == ("l_orderkey",):
            ids = _bins(torch, pids, c["valid"], c["w"])
    check_partition_cases(torch, rh, failures)
    if failures:
        fail("; ".join(failures))
    if ids is None:
        fail(f"W={_WORKERS}: Q3 made no repartition on l_orderkey")
    p = _WORKERS * _WORKERS
    got, want = rh.radix_histogram(ids, p), rh.radix_histogram_plain(ids, p)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"radix_histogram Q3 W={_WORKERS}: {got.tolist()} vs plain "
             f"{want.tolist()}")
    print(f"check radix_histogram Q3 W={_WORKERS}: ids={ids.shape[0]} P={p} "
          f"counts={got.tolist()}: exact", flush=True)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(23)
    for n, bins in ((0, 4), (5, 1), (100_003, 4), (1 << 20, 16),
                    (100_003, 8192), (100_003, 8193)):
        e = torch.randint(-2, bins + 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        edge = torch.tensor([-1, bins, 2 ** 31 - 1], dtype=torch.int32,
                            device=dev)[:min(n, 3)]
        e[:edge.shape[0]] = edge
        got = rh.radix_histogram(e, bins)
        want = rh.radix_histogram_plain(e, bins)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"radix_histogram n={n} P={bins} differs from the plain "
                 "version")
    print("check radix_histogram n in {0, 5, 100003, 2^20}, P in "
          "{1, 4, 16, 8192, 8193}, ids -1, P and INT32_MAX: exact",
          flush=True)


def run_distributed(torch, catalog, w1_results):
    """All 22 queries planned for ``_WORKERS`` workers through the card's
    Session with ``ICIExchange``, each against its W = 1 result, then the
    ``_HOST_QUERIES`` through ``HostExchange``, each against its ICI
    result; returns the launch counts of each ICI query's first timed run
    and the ICI session."""
    from repro_torch import HostExchange, ICIExchange
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    sessions = {proto: Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                               num_workers=_WORKERS, exchange=ex)
                for proto, ex in (("ici", ICIExchange()),
                                  ("host", HostExchange()))}
    launches, ici = {}, {}
    for proto, qs in (("ici", _QUERIES), ("host", _HOST_QUERIES)):
        session = sessions[proto]
        for q in qs:
            plan = queries.build_query(q, catalog, num_workers=_WORKERS)
            session.execute(plan)               # warm: allocator, streams
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = session.execute(plan)
            torch.cuda.synchronize()
            wall = [time.perf_counter() - t0]
            counts = ops.launch_counts()
            stats = session.executor_stats()
            for _ in range(2):                  # two more timed runs
                t0 = time.perf_counter()
                session.execute(plan)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
            ex = stats["exchanges"]
            reps = _repartitions(ex)
            staged = sum(v["host_staged_bytes"] for v in ex.values())
            print(f"Q{q} SF {_SF} W={_WORKERS} {proto}: gpu "
                  f"{[round(t, 4) for t in wall]} s, rows "
                  f"{len(next(iter(got.values())))}, exchanges {len(ex)} "
                  f"({reps} repartitions), rows_moved "
                  f"{sum(v['rows_moved'] for v in ex.values())}, bytes_moved "
                  f"{sum(v['bytes_moved'] for v in ex.values())}, "
                  f"host_staged_bytes {staged}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            if proto == "ici":
                compare(q, got, w1_results[q], "its W=1 run on the card")
                partition = stats["kernel_dispatch"].get("partition", 0)
                if counts["radix_histogram"] != reps or partition != reps:
                    fail(f"Q{q} W={_WORKERS}: {counts['radix_histogram']} "
                         f"radix_histogram launches and {partition} partition "
                         f"dispatches for {reps} repartitions")
                if staged:
                    fail(f"Q{q} W={_WORKERS} ici: {staged} bytes through the "
                         "host")
                launches[q], ici[q] = counts, got
            else:
                compare(q, got, ici[q], f"its W={_WORKERS} ICI run")
                if counts["radix_histogram"] or not staged:
                    fail(f"Q{q} W={_WORKERS} host: {counts['radix_histogram']}"
                         f" radix_histogram launches, {staged} bytes staged")
    if not any(c["radix_histogram"] for c in launches.values()):
        fail("kernel radix_histogram was not launched by the main path")
    totals = {k: sum(c[k] for c in launches.values()) for k in ops.KERNELS}
    print(f"launches at W={_WORKERS} (22 queries, ici): {json.dumps(totals)}",
          flush=True)
    return launches, sessions["ici"]


# ---------------------------------------------------------------------------
# the mesh phase: the staged all-to-all, one card a mesh, then several
# ---------------------------------------------------------------------------

# the queries run at two workers a mesh and through the host-staged
# exchange on it
_MESH_W2 = (3, 5, 9, 13, 18, 21)
_MESH_HOST = (5, 9, 13)
# the path's kernels: every kernel but the serving batch and attention
_MESH_KERNELS = ("fused_batch_program", "flash_attention")


def _counters(stats):
    """Each exchange fragment's rounds, rows and bytes moved."""
    return {k: (v["rounds"], v["rows_moved"], v["bytes_moved"])
            for k, v in stats["exchanges"].items()}


def _staged_bytes(stats):
    return sum(v["host_staged_bytes"] for v in stats["exchanges"].values())


def data_phase_ms(torch, session, plans):
    """One run of each plan with CUDA events around each repartition's data
    phase (the fused gather off the mesh, the staged layout, all-to-all and
    compaction on it): q -> (data-phase ms summed over its repartitions,
    the rows each destination worker received, summed the same way)."""
    from repro_torch.core import exchange as ex_mod
    cls = ex_mod.ICIExchange
    fused = cls.__dict__["_repartition_fused"]
    staged = cls.__dict__["_repartition_staged"]
    now = {}

    def timed(fn, per_dst):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        now["ms"] += start.elapsed_time(end)
        now["rows"] = [a + int(b) for a, b in zip(now["rows"], per_dst)]
        return out

    def fused_phase(tables, pids, per_dst, out_cap):
        return timed(lambda: fused.__func__(tables, pids, per_dst, out_cap),
                     per_dst)

    def staged_phase(self, tables, pids, counts, out_cap):
        return timed(lambda: staged(self, tables, pids, counts, out_cap),
                     counts.sum(axis=0))

    out = {}
    cls._repartition_fused = staticmethod(fused_phase)
    cls._repartition_staged = staged_phase
    try:
        for q, plan in plans.items():
            now.update(ms=0.0, rows=[0] * session.num_workers)
            session.execute(plan)
            torch.cuda.synchronize()
            out[q] = (now["ms"], now["rows"])
    finally:
        cls._repartition_fused = fused
        cls._repartition_staged = staged
    return out


def _mesh_run(torch, session, plan):
    """One warm-up run, then one timed run with the launch counters set to
    0 just before it and read just after: (result, stats, counts, wall)."""
    from repro_torch.kernels import ops
    session.execute(plan)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = session.execute(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return got, session.executor_stats(), ops.launch_counts(), wall


def mesh_one_card(torch, catalog, w1_results=None):
    """(a) The 22 queries at ``_WORKERS`` workers on
    ``EngineMesh([cuda:0])`` (the staged all-to-all on one card) against the
    same plans off the mesh, walls side by side; then two workers on
    ``_MESH_W2`` and ``HostExchange`` on ``_MESH_HOST``; the data phase's
    CUDA-event ms on and off the mesh and the rows each worker received.
    Returns the off-mesh results at ``_WORKERS`` workers."""
    from repro_torch import HostExchange
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import EngineMesh
    from repro_torch.tpch import queries
    mesh = EngineMesh([torch.device("cuda", 0)])
    plans = {q: queries.build_query(q, catalog, num_workers=_WORKERS)
             for q in _QUERIES}
    off = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                  num_workers=_WORKERS)
    on = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                 mesh=mesh)
    if on.device != torch.device("cuda", 0):
        fail(f"mesh session on {on.device}, not its mesh's first device")
    off_results, totals = {}, dict.fromkeys(ops.KERNELS, 0)
    wall_on = wall_off = 0.0
    for q, plan in plans.items():
        want, want_stats, _, t_off = _mesh_run(torch, off, plan)
        got, stats, counts, t_on = _mesh_run(torch, on, plan)
        compare(q, got, want, f"its off-mesh W={_WORKERS} run")
        if w1_results is not None:
            compare(q, got, w1_results[q], "its W=1 run on the card")
        if _counters(stats) != _counters(want_stats):
            fail(f"Q{q} mesh W={_WORKERS}: exchanges {_counters(stats)}, off "
                 f"the mesh {_counters(want_stats)}")
        staged = _staged_bytes(stats)
        reps = _repartitions(stats["exchanges"])
        if staged or counts["radix_histogram"] != reps:
            fail(f"Q{q} mesh W={_WORKERS}: {staged} bytes through the host, "
                 f"{counts['radix_histogram']} radix_histogram launches for "
                 f"{reps} repartitions")
        if stats["worker_devices"] != ["cuda:0"] * _WORKERS:
            fail(f"Q{q} mesh: workers on {stats['worker_devices']}")
        for k in ops.KERNELS:
            totals[k] += counts[k]
        wall_on += t_on
        wall_off += t_off
        off_results[q] = want
        print(f"mesh Q{q} SF {_SF} W={_WORKERS} on 1 card: wall on the mesh "
              f"{t_on:.4f} s, off {t_off:.4f} s, rows "
              f"{len(next(iter(got.values())))}, {reps} repartitions, "
              f"host_staged_bytes {staged}, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    for k in ops.KERNELS:
        if k not in _MESH_KERNELS and not totals[k]:
            fail(f"kernel {k} was not launched by the mesh path")
    print(f"mesh W={_WORKERS} 1 card (22 queries): walls on the mesh "
          f"{wall_on:.4f} s, off {wall_off:.4f} s; launches "
          f"{json.dumps(totals)}", flush=True)
    # the data phase, staged against fused, and where the rows went
    ms_on = data_phase_ms(torch, on, plans)
    ms_off = data_phase_ms(torch, off, plans)
    rows = [0] * _WORKERS
    for q in plans:
        if ms_on[q][1] != ms_off[q][1]:
            fail(f"Q{q}: rows received {ms_on[q][1]} on the mesh, "
                 f"{ms_off[q][1]} off it")
        rows = [a + b for a, b in zip(rows, ms_on[q][1])]
        print(f"mesh data phase Q{q}: staged {ms_on[q][0]:.3f} ms, fused "
              f"{ms_off[q][0]:.3f} ms, rows each worker received "
              f"{ms_on[q][1]}", flush=True)
    print(f"mesh data phase (22 queries, W={_WORKERS}, CUDA events): staged "
          f"{sum(v[0] for v in ms_on.values()):.3f} ms, fused "
          f"{sum(v[0] for v in ms_off.values()):.3f} ms; rows each worker "
          f"received {rows}", flush=True)
    # two workers a mesh, and the host-staged exchange on it
    on2 = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=2, mesh=mesh)
    off2 = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                   num_workers=2)
    for q in _MESH_W2:
        plan = queries.build_query(q, catalog, num_workers=2)
        want, want_stats, _, t_off = _mesh_run(torch, off2, plan)
        got, stats, counts, t_on = _mesh_run(torch, on2, plan)
        compare(q, got, want, "its off-mesh W=2 run")
        if _counters(stats) != _counters(want_stats) or _staged_bytes(stats):
            fail(f"Q{q} mesh W=2: exchanges {_counters(stats)} vs "
                 f"{_counters(want_stats)}, {_staged_bytes(stats)} bytes "
                 "through the host")
        print(f"mesh Q{q} W=2 on 1 card: wall on the mesh {t_on:.4f} s, off "
              f"{t_off:.4f} s", flush=True)
    host = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                   mesh=mesh, exchange=HostExchange())
    for q in _MESH_HOST:
        got, stats, counts, wall = _mesh_run(torch, host, plans[q])
        compare(q, got, off_results[q], f"its W={_WORKERS} ICI run")
        staged = _staged_bytes(stats)
        if not staged or counts["radix_histogram"]:
            fail(f"Q{q} mesh host: {staged} bytes staged, "
                 f"{counts['radix_histogram']} radix_histogram launches")
        print(f"mesh Q{q} W={_WORKERS} host on 1 card: wall {wall:.4f} s, "
              f"host_staged_bytes {staged}", flush=True)
    return off_results


def check_device_guard(torch, rh):
    """``partition_histogram`` on tensors of ``cuda:1`` while ``cuda:0`` is
    current, against its plain version: the launch must run under its
    tensors' device."""
    if torch.cuda.device_count() < 2:
        print("device guard: one card, so a launch on another card than the "
              "current one cannot be tried here", flush=True)
        return
    gen = torch.Generator().manual_seed(29)
    keys = [[torch.randint(-1000, 1000, (100_003,), generator=gen,
                           dtype=torch.int32).to("cuda:1")] for _ in range(4)]
    valid = [(torch.rand(100_003, generator=gen) < 0.8).to("cuda:1")
             for _ in range(4)]
    with torch.cuda.device(0):
        pids, counts = rh.partition_histogram(keys, valid, 4)
        torch.cuda.synchronize(1)
    want_pids, want_counts = rh.partition_histogram_plain(
        [[k.cpu() for k in ks] for ks in keys], [v.cpu() for v in valid], 4)
    if pids.device != torch.device("cuda", 1) or not (
            torch.equal(pids.cpu(), want_pids)
            and torch.equal(counts.cpu(), want_counts)):
        fail("device guard: partition_histogram on cuda:1 with cuda:0 "
             "current differs from its plain version")
    print("device guard: partition_histogram on cuda:1 with cuda:0 current: "
          "exact", flush=True)


def mesh_cards(torch, catalog, results, off):
    """(b) The 22 queries at ``_WORKERS`` workers on a mesh of
    ``min(count, 4)`` cards (2 when 3 are visible), each equal to
    ``results`` (the off-mesh run), every worker's output tables on its
    mesh device, with the peer access of each pair of cards and the bytes
    copied between cards; then (c)-(e) for ``_MESH_CARDS_QUERIES`` on
    those cards (``mesh_cards_serving_spill_feedback``; ``off`` holds (e)'s
    off-mesh stores)."""
    from repro_torch.core.driver import Driver
    from repro_torch.core.session import Session
    from repro_torch.launch.mesh import EngineMesh
    from repro_torch.tpch import queries
    count = torch.cuda.device_count()
    if count < 2:
        print("mesh (b): needs two or more cards, this host has one; not "
              "run, nor (c)-(e) across cards", flush=True)
        return
    cards = 4 if count >= 4 else 2
    mesh = EngineMesh([torch.device("cuda", i) for i in range(cards)])
    for i in range(cards):
        peers = {f"cuda:{j}": torch.cuda.can_device_access_peer(i, j)
                 for j in range(cards) if j != i}
        print(f"mesh (b): peer access from cuda:{i}: {peers}", flush=True)
    session = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                      mesh=mesh)
    peer = 0
    for q in _QUERIES:
        plan = queries.build_query(q, catalog, num_workers=_WORKERS)
        got, stats, _, wall = _mesh_run(torch, session, plan)
        compare(q, got, results[q], f"its off-mesh W={_WORKERS} run")
        copied = session.last_driver.ctx.exchange.peer_bytes
        peer += copied
        if _staged_bytes(stats):
            fail(f"Q{q} mesh of {cards} cards: bytes through the host")
        tables = Driver(session.context()).execute(plan)
        torch.cuda.synchronize()
        where = [str(t.device) for t in tables]
        if where != [str(mesh.device_of(w, _WORKERS))
                     for w in range(_WORKERS)]:
            fail(f"Q{q} mesh of {cards} cards: outputs on {where}")
        print(f"mesh Q{q} W={_WORKERS} on {cards} cards: wall {wall:.4f} s, "
              f"workers on {stats['worker_devices']}, bytes copied between "
              f"cards {copied}", flush=True)
    print(f"mesh (b) {cards} cards (22 queries): bytes copied between cards "
          f"{peer}", flush=True)
    mesh_cards_serving_spill_feedback(torch, catalog, mesh, results, off)


# (c)-(e): serving, out of core and adaptive execution on the one-card
# mesh; part (b) runs them for these queries across the cards
_MESH_CARDS_QUERIES = (3, 5, 18)
# the admission budget of the 22 served at W = 4 (each query's estimate
# is under it, so none runs out of core)
_MESH_SERVE_BUDGET = 24 << 30
# (d): the queries under a sixty-fourth of their W = 4 footprint, whose
# grace joins form
_MESH_GRACE = (5, 18)


def _latency_text(handles):
    lat = [h.latency for h in handles]
    return (f"p50 {_percentile(lat, 0.5):.4f} s p99 "
            f"{_percentile(lat, 0.99):.4f} s")


def _card_peaks(torch, mesh, fn):
    """(fn's result, each mesh card's ``max_memory_allocated`` over the
    call in bytes)."""
    for d in mesh.devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    out = fn()
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    return out, [torch.cuda.max_memory_allocated(d) for d in mesh.devices]


def mesh_serving(torch, catalog, data, mesh, off_results):
    """(c) The 22 planned for ``_WORKERS`` workers through the scheduler
    (``submit``, then ``gather``) from ``_CLIENTS`` client threads, off the
    mesh and on it, each result equal to its off-mesh ``execute``
    (``off_results``); then phase 8's 96-query workload at W = 1 with
    batching off the mesh and on the one-card mesh, each member equal to
    its off-mesh serving, at least one stacked batch and no fallback;
    q/s, p50 and p99 of each, and the launches on the mesh."""
    from repro_torch.core.builder import QueryBuilder
    from repro_torch.core.expr import col
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    plans = [queries.build_query(q, catalog, num_workers=_WORKERS)
             for q in _QUERIES]
    for where, m in (("off the mesh", None), ("on the mesh", mesh)):
        ops.reset_launch_counts()
        got, handles, wall, stats = _serve(
            torch, catalog, plans, False, workers=_WORKERS, mesh=m,
            budget=_MESH_SERVE_BUDGET, gather=True)
        counts = ops.launch_counts()
        for q, g in zip(_QUERIES, got):
            compare(q, g, off_results[q],
                    f"its off-mesh W={_WORKERS} execute (served {where})")
        if stats["failed"] or stats["spill_admitted"]:
            fail(f"mesh (c) served {where}: {json.dumps(stats)}")
        if m is not None and any(h.executor_stats["worker_devices"]
                                 != [str(d) for d in
                                     m.worker_devices(_WORKERS)]
                                 for h in handles):
            fail("mesh (c): a served query ran off its mesh devices")
        print(f"mesh (c) serving the 22 W={_WORKERS} {where}: "
              f"{_CLIENTS} clients, wall {wall:.4f} s "
              f"({len(plans) / wall:.1f} q/s), {_latency_text(handles)}; "
              f"launches {json.dumps(_nonzero(counts))}", flush=True)
    keys = data["orders"]["o_orderkey"]
    labels = [(_SHAPES[i % 3], i // 3) for i in range(_SERVING_QUERIES)]
    builders = [small_query(QueryBuilder, col, catalog, keys, shape, j)
                for shape, j in labels]
    served = {}
    for where, m in (("off the mesh", None), ("on the mesh", mesh)):
        ops.reset_launch_counts()
        got, handles, wall, stats = _serve(torch, catalog, builders, True,
                                           mesh=m)
        counts = ops.launch_counts()
        served[where] = got
        if (stats["batches"] < 1 or stats["batch_fallbacks"]
                or not counts["fused_batch_program"]):
            fail(f"mesh (c) batched serving {where}: {json.dumps(stats)}, "
                 f"{counts['fused_batch_program']} fused_batch_program "
                 "launches")
        print(f"mesh (c) serving {_SERVING_QUERIES} small queries W=1 "
              f"batched {where}: wall {wall:.4f} s "
              f"({_SERVING_QUERIES / wall:.1f} q/s), "
              f"{_latency_text(handles)}, {stats['batches']} stacked "
              f"batches of {stats['batched_queries']} queries, "
              f"{stats['batch_fallbacks']} fallbacks; launches "
              f"{json.dumps(_nonzero(counts))}", flush=True)
    for (shape, j), g, w in zip(labels, served["on the mesh"],
                                served["off the mesh"]):
        compare(f"{shape}#{j}", g, w, "its off-mesh serving")


def _spilled(torch, catalog, plan, budget, **kw):
    """One run of ``plan`` on a fresh W = 4 session under ``budget``:
    (result, executor stats, launches, wall)."""
    from repro_torch.core.session import Session
    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                      num_workers=_WORKERS, device_budget=budget, **kw)
    return _counted(torch, session, plan)


def _same_spill(torch, catalog, plan, budget, mesh, got, want, what):
    """Fail unless the mesh run's spill counters ``got`` equal the
    off-mesh run's ``want``, or, where the mesh's broadcast layout (the W
    tables end to end, the reference's) changed a reservation, those of an
    off-mesh run whose exchange lays rows out as the mesh does. Returns
    whether they equal ``want``."""
    from repro_torch import ICIExchange
    if got == want:
        return True
    _, st, _, _ = _spilled(torch, catalog, plan, budget,
                           exchange=ICIExchange(mesh=mesh))
    if st["spill"] != got:
        fail(f"{what}: spill counters on the mesh {_spill_text(got)}; off "
             f"it {_spill_text(want)}; off it with the mesh's layout "
             f"{_spill_text(st['spill'])}")
    return False


def mesh_spill(torch, rh, catalog, mesh, off_results):
    """(d) The 22 planned for ``_WORKERS`` workers under a quarter of their
    footprint, off the mesh and on it, each equal to its in-memory result,
    the spill counters equal (``_same_spill``), each card's
    ``max_memory_allocated``; then ``_MESH_GRACE`` under a sixty-fourth:
    grace joins must form, each standalone histogram call on its worker's
    card, bit-exact against its plain version, one launch a call."""
    from repro_torch import ICIExchange
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    totals = dict.fromkeys(ops.KERNELS, 0)
    walls = {"on": 0.0, "off": 0.0}
    layout, spilled, top = [], [], [0] * len(mesh.devices)
    for q in _QUERIES:
        plan = queries.build_query(q, catalog, num_workers=_WORKERS)
        budget = footprint_budget(catalog, plan, _WORKERS, 4)
        _, off_stats, _, t_off = _spilled(torch, catalog, plan, budget,
                                          exchange=ICIExchange())
        on = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                     mesh=mesh, device_budget=budget)
        (got, stats, counts, t_on), peaks = _card_peaks(
            torch, mesh, lambda: _counted(torch, on, plan))
        compare(q, got, off_results[q], "its in-memory off-mesh run")
        sp = stats["spill"]
        what = f"Q{q} W={_WORKERS} at 1/4 on the mesh"
        if not _same_spill(torch, catalog, plan, budget, mesh, sp,
                           off_stats["spill"], what):
            layout.append(q)
        if sp["spilled_bytes"]:
            spilled.append(q)
        for k in ops.KERNELS:
            totals[k] += counts[k]
        walls["on"] += t_on
        walls["off"] += t_off
        top = [max(a, b) for a, b in zip(top, peaks)]
        print(f"mesh (d) {what}, budget {budget} B: wall {t_on:.4f} s, off "
              f"the mesh {t_off:.4f} s; {_spill_text(sp)}; staged exchanges "
              f"{stats['spill_staged_exchanges']}; max_memory_allocated by "
              f"card {peaks}", flush=True)
    print(f"mesh (d) the 22 W={_WORKERS} at 1/4: walls on the mesh "
          f"{walls['on']:.4f} s, off {walls['off']:.4f} s; spilled "
          f"{spilled}; counters equal off the mesh but for {layout} (equal "
          f"there to the mesh's layout off the mesh); max_memory_allocated "
          f"by card {top}; launches {json.dumps(_nonzero(totals))}",
          flush=True)
    failures, graced = [], []
    for q in _MESH_GRACE:
        plan = queries.build_query(q, catalog, num_workers=_WORKERS)
        budget = footprint_budget(catalog, plan, _WORKERS, 64)
        _, off_stats, _, t_off = _spilled(torch, catalog, plan, budget,
                                          exchange=ICIExchange())
        on = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                     mesh=mesh, device_budget=budget)
        calls, joins, grace = [], [], {}
        with grace_capture(calls, joins), grace_launches(grace):
            (got, stats, counts, t_on), peaks = _card_peaks(
                torch, mesh, lambda: _counted(torch, on, plan))
        what = f"Q{q} W={_WORKERS} at 1/64 on the mesh"
        compare(q, got, off_results[q], "its in-memory off-mesh run")
        _same_spill(torch, catalog, plan, budget, mesh, stats["spill"],
                    off_stats["spill"], what)
        if not joins or grace["n"] != len(calls):
            fail(f"{what}: grace joins {joins}, {grace['n']} standalone "
                 f"histogram launches for {len(calls)} calls")
        for i, c in enumerate(calls):
            if c["device"] not in mesh.devices:
                fail(f"{what}: histogram call {i} on {c['device']}")
            check_hist_call(torch, rh, c["ids"].to(c["device"]), c["bins"],
                            f"{what} call {i}", failures, show=False)
        graced.append(q)
        print(f"mesh (d) {what}, budget {budget} B: wall {t_on:.4f} s, off "
              f"the mesh {t_off:.4f} s; {_spill_text(stats['spill'])}; "
              f"grace joins (partitions, spilled build partitions) {joins}; "
              f"{len(calls)} standalone histogram calls on "
              f"{sorted({str(c['device']) for c in calls})}, exact: "
              f"{not failures}; max_memory_allocated by card {peaks}; "
              f"launches {json.dumps(_nonzero(counts))}", flush=True)
    if failures:
        fail("; ".join(failures))


def _entries(store):
    """A feedback store's entries: key -> (rows, estimated, max_matches,
    skip_fraction)."""
    return {k: (e.rows, e.estimated, e.max_matches, e.skip_fraction)
            for k, e in store._entries.items()}


def _cold_warm(torch, session, raw):
    """The cold plan once, then the warm plan once, each through
    ``_counted``: (cold, warm results, launches summed, cold and warm
    walls, the warm plan)."""
    cold_plan = session.optimize(raw)
    cold, _, counts, t_cold = _counted(torch, session, cold_plan)
    warm_plan = session.optimize(raw)
    warm, _, more, t_warm = _counted(torch, session, warm_plan)
    return (cold, warm, {k: counts[k] + more[k] for k in counts}, t_cold,
            t_warm, warm_plan)


def mesh_adaptive(torch, catalog, mesh, answers):
    """(e) Each of the 22 at ``_WORKERS`` workers cold, then warm, on a
    store of its own, off the mesh (``ICIExchange()``) and on it: both
    runs on the mesh equal the oracle (``answers``), the store's entries
    and the warm plan equal off the mesh's; then Q3 submitted three times
    to a ``feedback=True`` scheduler: at W = 1 on the mesh a plan-cache
    miss, a miss again (evicted), a hit, as in the adaptive phase; at
    W = 4 the same hits on the mesh as off it. Returns the off-mesh
    stores' entries."""
    from repro_torch import ICIExchange, SchedulerConfig
    from repro_torch.core import plan as P
    from repro_torch.core.feedback import FeedbackStore
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    off_entries, totals = {}, dict.fromkeys(ops.KERNELS, 0)
    walls = dict.fromkeys(("cold on", "warm on", "cold off", "warm off"), 0.0)
    for q in range(1, 23):
        raw = queries.build_query(q, catalog, optimized=False)
        off = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                      num_workers=_WORKERS, exchange=ICIExchange(),
                      feedback=FeedbackStore())
        _, _, _, c_off, w_off, off_plan = _cold_warm(torch, off, raw)
        on = Session(catalog, batch_rows=_MAIN_ROWS, num_workers=_WORKERS,
                     mesh=mesh, feedback=FeedbackStore())
        cold, warm, counts, c_on, w_on, warm_plan = _cold_warm(torch, on,
                                                               raw)
        for what, got in (("cold", cold), ("warm", warm)):
            compare_oracle(q, got, answers[q],
                           f"W={_WORKERS} {what} on the mesh")
        off_entries[q] = _entries(off.feedback_store())
        got_entries = _entries(on.feedback_store())
        if got_entries != off_entries[q]:
            diff = sorted(k for k in set(got_entries) | set(off_entries[q])
                          if got_entries.get(k) != off_entries[q].get(k))
            fail(f"adaptive Q{q} W={_WORKERS} on the mesh: store entries "
                 f"differ from off the mesh at {diff[:3]}")
        if P.fingerprint(warm_plan) != P.fingerprint(off_plan):
            fail(f"adaptive Q{q} W={_WORKERS}: the warm plan on the mesh is "
                 "not the warm plan off it")
        for k in ops.KERNELS:
            totals[k] += counts[k]
        for k, v in (("cold on", c_on), ("warm on", w_on),
                     ("cold off", c_off), ("warm off", w_off)):
            walls[k] += v
        print(f"mesh (e) adaptive Q{q} W={_WORKERS}: cold {c_on:.4f} s, warm "
              f"{w_on:.4f} s on the mesh; off it {c_off:.4f} s, "
              f"{w_off:.4f} s; store {len(got_entries)} entries, equal",
              flush=True)
    print(f"mesh (e) the 22 W={_WORKERS} cold and warm equal the oracle, "
          f"stores equal off the mesh; walls "
          f"{_sums_text(walls)}; launches {json.dumps(_nonzero(totals))}",
          flush=True)
    hits = {}
    for label, w, m in (("W=1 on the mesh", 1, mesh),
                        (f"W={_WORKERS} on the mesh", _WORKERS, mesh),
                        (f"W={_WORKERS} off the mesh", _WORKERS, None)):
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          num_workers=w, mesh=m, feedback=True,
                          scheduler_config=SchedulerConfig(
                              cache_results=False))
        raw = queries.build_query(3, catalog, optimized=False)
        try:
            handles = []
            for _ in range(3):
                handles.append(session.submit(raw))
                compare_oracle(3, handles[-1].result(timeout=600),
                               answers[3], f"scheduled {label}")
        finally:
            session.scheduler().close()
        hits[label] = [h.plan_cache_hit for h in handles]
    print(f"mesh (e) scheduler Q3 x3, plan cache hits: {json.dumps(hits)}",
          flush=True)
    on, off = hits[f"W={_WORKERS} on the mesh"], hits[
        f"W={_WORKERS} off the mesh"]
    if hits["W=1 on the mesh"] != [False, False, True] or on != off:
        fail(f"mesh (e) scheduler Q3: plan cache hits {hits}; expected at "
             "W=1 a miss, a miss after the eviction, then a hit, and at "
             f"W={_WORKERS} the same on the mesh as off it")
    return off_entries


@contextlib.contextmanager
def restored_places(record):
    """While active, ``record`` gets (the devices a spilled partition's
    tables left, the devices they came back on) for each restore."""
    from repro_torch.core.spill import SpillManager
    place = SpillManager._place

    def kept(self, part, held):
        out = place(self, part, held)
        record.append((list(part.devices), [t.device for t in out]))
        return out

    SpillManager._place = kept
    try:
        yield
    finally:
        SpillManager._place = place


def mesh_cards_serving_spill_feedback(torch, catalog, mesh, results,
                                      off_entries):
    """(b)'s (c)-(e) for ``_MESH_CARDS_QUERIES`` across ``mesh``'s cards:
    served through the scheduler (``submit``, ``gather``), under a quarter
    and a sixty-fourth of their footprint (every restored partition back
    on the card it left, outputs on each worker's card, each grace
    histogram call on a card of the mesh) and cold then warm (the store
    equal to (e)'s off-mesh one); each equal to its off-mesh result, the
    bytes copied between cards."""
    from repro_torch.core.driver import Driver
    from repro_torch.core.feedback import FeedbackStore
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    cards = len(mesh.devices)
    plans = {q: queries.build_query(q, catalog, num_workers=_WORKERS)
             for q in _MESH_CARDS_QUERIES}
    got, handles, wall, _ = _serve(
        torch, catalog, list(plans.values()), False, workers=_WORKERS,
        mesh=mesh, budget=_MESH_SERVE_BUDGET, gather=True)
    for q, g in zip(plans, got):
        compare(q, g, results[q], f"its off-mesh run (served on {cards} "
                "cards)")
    print(f"mesh (b) (c) serving {list(plans)} W={_WORKERS} on {cards} "
          f"cards: wall {wall:.4f} s, {_latency_text(handles)}", flush=True)
    for q, plan in plans.items():
        for share in (4, 64):
            budget = footprint_budget(catalog, plan, _WORKERS, share)
            session = Session(catalog, batch_rows=_MAIN_ROWS,
                              num_workers=_WORKERS, mesh=mesh,
                              device_budget=budget)
            places, calls, joins = [], [], []
            with restored_places(places), grace_capture(calls, joins):
                (out, stats, _, t), peaks = _card_peaks(
                    torch, mesh, lambda: _counted(torch, session, plan))
            tables = Driver(session.context()).execute(plan)
            torch.cuda.synchronize()
            compare(q, out, results[q], f"its off-mesh run (1/{share} on "
                    f"{cards} cards)")
            wrong = [p for p in places if p[0] != p[1]]
            where = [t.device for t in tables]
            if wrong or where != mesh.worker_devices(_WORKERS) or any(
                    c["device"] not in mesh.devices for c in calls):
                fail(f"Q{q} 1/{share} on {cards} cards: restores {wrong[:3]}"
                     f", outputs on {where}, histogram calls on "
                     f"{[c['device'] for c in calls]}")
            print(f"mesh (b) (d) Q{q} W={_WORKERS} at 1/{share} on {cards} "
                  f"cards: wall {t:.4f} s; {_spill_text(stats['spill'])}; "
                  f"{len(places)} restores, each on the card it left; grace "
                  f"joins {joins}, {len(calls)} histogram calls on "
                  f"{sorted({str(c['device']) for c in calls})}; bytes "
                  f"copied between cards "
                  f"{session.last_driver.ctx.exchange.peer_bytes}; "
                  f"max_memory_allocated by card {peaks}", flush=True)
        session = Session(catalog, batch_rows=_MAIN_ROWS,
                          num_workers=_WORKERS, mesh=mesh,
                          feedback=FeedbackStore())
        cold, warm, _, t_cold, t_warm, _ = _cold_warm(
            torch, session, queries.build_query(q, catalog, optimized=False))
        compare(q, cold, results[q], f"its off-mesh run (cold on {cards} "
                "cards)")
        compare(q, warm, results[q], f"its off-mesh run (warm on {cards} "
                "cards)")
        if _entries(session.feedback_store()) != off_entries[q]:
            fail(f"adaptive Q{q} on {cards} cards: store entries differ "
                 "from off the mesh")
        print(f"mesh (b) (e) Q{q} W={_WORKERS} on {cards} cards: cold "
              f"{t_cold:.4f} s, warm {t_warm:.4f} s, store equal to off the "
              "mesh's", flush=True)


def run_mesh_cards(torch, catalog):
    """Part (b) of the mesh phase alone, and what it is compared with:
    the 22 at ``_WORKERS`` workers off the mesh on ``cuda:0``, and
    ``_MESH_CARDS_QUERIES`` cold then warm off the mesh, each on a store
    of its own."""
    from repro_torch import ICIExchange
    from repro_torch.core.feedback import FeedbackStore
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries
    t0 = time.perf_counter()
    off = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                  num_workers=_WORKERS)
    results = {q: off.execute(queries.build_query(q, catalog,
                                                  num_workers=_WORKERS))
               for q in _QUERIES}
    entries = {}
    for q in _MESH_CARDS_QUERIES:
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          num_workers=_WORKERS, exchange=ICIExchange(),
                          feedback=FeedbackStore())
        _cold_warm(torch, session, queries.build_query(q, catalog,
                                                       optimized=False))
        entries[q] = _entries(session.feedback_store())
    mesh_cards(torch, catalog, results, entries)
    print(f"mesh (b) alone: {time.perf_counter() - t0:.1f} s", flush=True)


def run_mesh(torch, rh, catalog, data, w1_results=None, answers=None):
    """The mesh phase: (a), the device guard, (c)-(e) on the one-card
    mesh, then (b) (with (c)-(e) across the cards). ``answers`` are the
    oracle's (computed here when None)."""
    from repro_torch.launch.mesh import EngineMesh
    t0 = time.perf_counter()
    off_results = mesh_one_card(torch, catalog, w1_results)
    check_device_guard(torch, rh)
    print(f"mesh (a): {time.perf_counter() - t0:.1f} s", flush=True)
    if answers is None:
        answers = oracle_answers(data)
    mesh = EngineMesh([torch.device("cuda", 0)])

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        print(f"mesh {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    part("(c)", lambda: mesh_serving(torch, catalog, data, mesh,
                                     off_results))
    part("(d)", lambda: mesh_spill(torch, rh, catalog, mesh, off_results))
    off_entries = part("(e)", lambda: mesh_adaptive(torch, catalog, mesh,
                                                    answers))
    mesh_cards(torch, catalog, off_results, off_entries)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the storage phase: the 22 queries read from column-chunk files at SF 1
# ---------------------------------------------------------------------------

def _timed(torch, session, plan):
    """One warm-up run of ``plan``, then three timed runs: (the first timed
    run's result, its executor stats and launch counts, the three walls).
    The launch counters are set to 0 just before that run and read just
    after."""
    from repro_torch.kernels import ops
    session.execute(plan)                       # warm: allocator, streams
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = session.execute(plan)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts, stats = ops.launch_counts(), session.executor_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        session.execute(plan)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return got, stats, counts, walls


def _scans(plan):
    """Every TableScan node of a plan."""
    from repro_torch.core import plan as P
    out = [plan] if isinstance(plan, P.TableScan) else []
    for child in plan.children():
        out += _scans(child)
    return out


def expected_bytes_read(catalog, plan):
    """table -> the sizes of the chunk files that each of the plan's scans
    of it reads: the columns it scans, in the chunks its pushed-down filter
    leaves by the zone maps."""
    out = {}
    for node in _scans(plan):
        src = catalog.get(node.table)
        cols = list(node.columns) if node.columns else list(src.schema)
        live = [k for k in range(src.num_chunks)
                if src._chunk_survives(k, node.filter)]
        out[node.table] = out.get(node.table, 0) + sum(
            os.path.getsize(os.path.join(src.root, src.name, src._files[c, k]))
            for c in cols for k in live)
    return out


def _walls(walls):
    return [round(t, 4) for t in walls]


def storage_from_files(torch, catalog, mem):
    """(b): the 22 queries at W = 1 from the files, each against the same
    plan over the same rows in memory on the card; bytes read against the
    surviving chunk files; Q6's skipping and fused launches."""
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    gpu_mem = Session(mem, device="cuda", batch_rows=_MAIN_ROWS)
    plans, results, walls, launches = {}, {}, {}, {}
    for q in _QUERIES:
        plan = plans[q] = queries.build_query(q, catalog)
        got, stats, counts, walls[q] = _timed(torch, gpu, plan)
        want, _, _, mem_walls = _timed(torch, gpu_mem, plan)
        compare(q, got, want, "its in-memory run on the card")
        want = expected_bytes_read(catalog, plan)
        for t, s in sorted(stats["tables"].items()):
            print(f"storage Q{q} {t}: chunks {s['chunks_total']} skipped "
                  f"{s['chunks_skipped']}, bytes_read {s['bytes_read']}, "
                  f"bytes_transferred {s['bytes_transferred']}, morsels "
                  f"{s['morsels']}, read_seconds {s['read_seconds']:.4f}, "
                  f"wait_seconds {s['wait_seconds']:.4f}, prefetch_overlap "
                  f"{s['prefetch_overlap']}", flush=True)
            if s["bytes_read"] != want[t]:
                fail(f"storage Q{q}: {t} bytes_read {s['bytes_read']}, the "
                     f"surviving chunk files hold {want[t]}")
        print(f"storage Q{q} SF {_SF} W=1: gpu {_walls(walls[q])} s (in "
              f"memory {_walls(mem_walls)} s), rows "
              f"{len(next(iter(got.values())))}, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        check_reaches(q, counts, " from storage")
        if q == 6:
            li = stats["tables"]["lineitem"]
            live = li["chunks_total"] - li["chunks_skipped"]
            if not li["chunks_skipped"]:
                fail("storage Q6: no lineitem chunk skipped")
            if counts["fused_morsel_program"] != live:
                fail(f"storage Q6: {counts['fused_morsel_program']} fused "
                     f"launches for {live} surviving lineitem chunks")
        results[q], launches[q] = got, counts
    check_w1_kernels(ops, launches, "the 22 queries from storage")
    totals = {k: sum(c[k] for c in launches.values()) for k in ops.KERNELS}
    print(f"launches from storage (22 queries, W=1): {json.dumps(totals)}",
          flush=True)
    return gpu, gpu_mem, plans, results, walls


def storage_baselines(torch, tmp, catalog, plans, results, walls):
    """(c): skipping off, then the synchronous scan, each of the 22 equal
    to its skipping, streaming run; the synchronous walls beside the
    streaming walls."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import dbgen, queries

    nostats = dbgen.storage_catalog(tmp, skip_with_stats=False)
    off = Session(nostats, device="cuda", batch_rows=_MAIN_ROWS)
    sync = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                   streaming=False)
    sums = [0.0, 0.0]
    for q in _QUERIES:
        compare(q, off.execute(queries.build_query(q, nostats)), results[q],
                "its run with zone-map skipping")
        skipped = {t: s["chunks_skipped"]
                   for t, s in off.executor_stats()["tables"].items()}
        if any(skipped.values()):
            fail(f"storage Q{q}: skipping off skipped {skipped}")
        got, _, _, sync_walls = _timed(torch, sync, plans[q])
        compare(q, got, results[q], "its streaming run")
        sums[0] += sorted(walls[q])[1]
        sums[1] += sorted(sync_walls)[1]
        print(f"storage Q{q} streaming=False: gpu {_walls(sync_walls)} s, "
              f"streaming {_walls(walls[q])} s", flush=True)
    print(f"storage walls, sums of the 22 medians: streaming {sums[0]:.4f} s,"
          f" synchronous {sums[1]:.4f} s", flush=True)


def storage_workers(torch, catalog, results):
    """(d): Q1, Q3, Q5 and Q6 planned for four workers from the files, each
    equal to its W = 1 storage result, with no byte through the host."""
    from repro_torch import ICIExchange
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    w4 = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                 num_workers=_WORKERS, exchange=ICIExchange())
    for q in _STORAGE_W4:
        got, stats, counts, wall = _timed(
            torch, w4, queries.build_query(q, catalog, num_workers=_WORKERS))
        compare(q, got, results[q], "its W=1 storage run")
        ex = stats["exchanges"]
        staged = sum(v["host_staged_bytes"] for v in ex.values())
        li = stats["tables"].get("lineitem", {})
        print(f"storage Q{q} W={_WORKERS}: gpu {_walls(wall)} s, lineitem "
              f"morsels {li.get('morsels')}, skipped {li.get('chunks_skipped')},"
              f" repartitions {_repartitions(ex)}, host_staged_bytes {staged},"
              f" launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        if staged:
            fail(f"storage Q{q} W={_WORKERS}: {staged} bytes through the host")


def _scan_rate(torch, source, cols):
    """Seconds of one synchronous scan of ``cols`` (every chunk read and
    copied to the card), and the values' bytes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in source.scan(cols, _MAIN_ROWS, "cuda"):
        pass
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nbytes = sum(source.num_rows() * source.schema[c].np_dtype().itemsize
                 * max(source.schema[c].width, 1) for c in cols)
    return secs, nbytes


def storage_paged(torch, tmp, data, results, plans):
    """(e): lineitem in the paged format: Q6 equal to its column-chunk run,
    and one full scan of Q6's lineitem columns in each format, timed."""
    from repro_torch.core.session import Session
    from repro_torch.storage import PagedTableSource, write_paged_table
    from repro_torch.tpch import dbgen, queries, schema

    t0 = time.perf_counter()
    write_paged_table(tmp, "lineitem", data["lineitem"],
                      schema.SCHEMAS["lineitem"], row_groups=_STORAGE_CHUNKS)
    size = os.path.getsize(os.path.join(tmp, "lineitem.paged"))
    print(f"storage paged: write_paged_table lineitem row_groups="
          f"{_STORAGE_CHUNKS} in {time.perf_counter() - t0:.3f} s, {size} "
          "bytes", flush=True)
    catalog = dbgen.storage_catalog(tmp)
    paged = PagedTableSource(tmp, "lineitem")
    paged.unique_keys = (schema.PRIMARY_KEYS["lineitem"],)
    catalog.register(paged)
    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    got = session.execute(queries.build_query(6, catalog))
    compare(6, got, results[6], "its column-chunk run")
    li = session.executor_stats()["tables"]["lineitem"]
    print(f"storage paged Q6: row groups {li['chunks_total']} skipped "
          f"{li['chunks_skipped']}, bytes_read {li['bytes_read']}, "
          f"read_seconds {li['read_seconds']:.4f}", flush=True)
    cols = list(_scans(plans[6])[0].columns)
    colchunk = dbgen.storage_catalog(tmp).get("lineitem")
    # in turns: a format's second scan sees the first one's warm state
    for name, source in (("colchunk", colchunk), ("paged", paged),
                         ("paged", paged), ("colchunk", colchunk)):
        secs, nbytes = _scan_rate(torch, source, cols)
        print(f"storage scan lineitem {cols} {name}: {secs:.4f} s, {nbytes} "
              f"value bytes, {nbytes / secs / 1e9:.3f} GB/s (read warm from "
              "the page cache, copied to the card)", flush=True)


def storage_round_trip(torch, catalog, plans, results, walls):
    """(f): Q1 and Q3 with HashAggregation declared host-only: equal
    results, and bytes through the host round trip."""
    from repro_torch.core.session import Session

    rt = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                 host_only_ops=frozenset({"HashAggregation"}))
    for q in _ROUND_TRIP:
        got, stats, _, wall = _timed(torch, rt, plans[q])
        compare(q, got, results[q], "its run on the card")
        conv = stats["conversions"].get("bytes", 0)
        print(f"storage Q{q} host round trip: gpu {_walls(wall)} s "
              f"(device-resident {_walls(walls[q])} s), conversions "
              f"{conv} bytes", flush=True)
        if not conv:
            fail(f"storage Q{q}: no bytes through the host round trip")


def storage_copy(torch, catalog):
    """(g): one step of lineitem's first chunk, every column: read from the
    files into pinned buffers (by ``readinto``, as the scan reads, and by
    copying a memmap of each file), host seconds; then copied to the card
    by ``morsel_to_device``, timed with CUDA events, from those pinned
    buffers and from pageable ones (``morsel_to_device`` pins a copy
    first). Medians of three after a warm-up."""
    from repro_torch.core.streaming import morsel_to_device, stacked_morsel
    from repro_torch.storage import read_column_chunk

    src = catalog.get("lineitem")
    cols = list(src.schema)

    def by_memmap(c, k, out):
        arr = read_column_chunk(src.root, src.name, c, k,
                                fname=src._files[c, k])
        out[:len(arr)] = arr
        return len(arr)

    def first_step(pin):
        return next(src._host_morsels(cols, _MAIN_ROWS, pin=pin))

    readers = (("readinto", lambda: first_step(True)),
               ("memmap copy", lambda: stacked_morsel(
                   cols, src.schema, 1, [0], src._chunk_rows[0], by_memmap,
                   pin=True)))
    for name, read in readers:
        secs = []
        for _ in range(4):
            t0 = time.perf_counter()
            step = read()
            secs.append(time.perf_counter() - t0)
        nbytes = sum(h.nbytes() for h in step)
        median = sorted(secs[1:])[1]
        print(f"storage read: one lineitem chunk step ({nbytes} bytes) into "
              f"pinned buffers by {name}: "
              f"{[round(t * 1e3, 3) for t in secs[1:]]} ms, "
              f"{nbytes / median / 1e9:.3f} GB/s (warm page cache)",
              flush=True)
    for pin in (True, False):
        step = first_step(pin)
        nbytes = sum(h.nbytes() for h in step)
        ms = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for h in step:
                morsel_to_device(h, "cuda")
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        median = sorted(ms[1:])[1]
        print(f"storage copy: one lineitem chunk step ({nbytes} bytes, "
              f"{'pinned' if pin else 'pageable'} buffers) {_walls(ms[1:])} "
              f"ms, {nbytes / median / 1e6:.3f} GB/s", flush=True)


def run_storage(torch, tmp):
    """The storage phase (a)-(g) in ``tmp``; returns what ``--profile``
    needs: the files' session, the in-memory session and the plans."""
    from repro_torch.core.session import Catalog
    from repro_torch.tpch import dbgen, schema

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = dbgen.write_dataset(tmp, sf=_SF, seed=_SEED, chunks=_STORAGE_CHUNKS)
    secs = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(tmp) for f in files)
    print(f"storage: write_dataset SF {_SF} chunks={_STORAGE_CHUNKS} in "
          f"{secs:.3f} s, {on_disk} bytes on disk", flush=True)
    catalog = dbgen.storage_catalog(tmp)
    mem = Catalog.from_numpy(
        data, schema.SCHEMAS, {t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    gpu, gpu_mem, plans, results, walls = storage_from_files(torch, catalog,
                                                             mem)
    storage_baselines(torch, tmp, catalog, plans, results, walls)
    storage_workers(torch, catalog, results)
    storage_paged(torch, tmp, data, results, plans)
    storage_round_trip(torch, catalog, plans, results, walls)
    storage_copy(torch, catalog)
    print(f"storage phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return gpu, gpu_mem, plans


def profile_storage(torch, gpu, gpu_mem, plans, out_dir):
    """One profiled warm run of Q1 and Q6 from the files and from memory:
    the host-to-device copies each makes."""
    os.makedirs(out_dir, exist_ok=True)
    for q in (1, 6):
        for source, session in (("files", gpu), ("memory", gpu_mem)):

            def run():
                session.execute(plans[q])

            for attempt in range(_PROFILE_ATTEMPTS):  # as in profile_kernels
                prof, _ = _profiled(torch, run)
                rows = _device_events(prof)
                if rows:
                    break
            if not rows:
                fail(f"profile of storage Q{q} ({source}): no device events")
            h2d = [r for r in rows if r[0].startswith("Memcpy HtoD")]
            summary = {"query": q, "source": source,
                       "h2d_copies": sum(r[1] for r in h2d),
                       "h2d_ms": sum(r[2] for r in h2d) / 1e3,
                       "device_busy_ms": sum(r[2] for r in rows) / 1e3}
            with open(os.path.join(out_dir, f"profile_storage_q{q}_{source}"
                                   ".json"), "w") as f:
                json.dump(dict(summary, by_kernel=rows), f, indent=1)
            print(json.dumps({"profile_storage": summary}), flush=True)


# ---------------------------------------------------------------------------
# the main path's shapes: every captured probe and repartition, timed after
# phase 9 (no profile may precede it)
# ---------------------------------------------------------------------------

# the card's L2 cache (NVIDIA's H100 data sheet: 50 MB)
_L2_BYTES = 50 * 2 ** 20


def sql_device_ms(torch, rows, launchers, reps: int = 10):
    """Device ms a call of each row of the SQL phase's instructions (the
    fused runs with YEAR and BYTESMATCH) from ``torch.profiler``: its fused
    kernel's events (``device_ms``). After phase 9, as every profile of
    the run."""
    for r in rows:
        if "BYTESMATCH" not in r["name"]:
            continue
        syms = _KERNEL_SYMBOLS["fused_batch_program"
                               if r["name"].startswith("fused_batch")
                               else "fused"]
        hits, _ = _profile_calls(torch, r["name"], launchers[r["name"]],
                                 syms, reps)
        r["device_ms"] = sum(e[2] for e in hits) / reps / 1e3
        print(f"device {r['name']}: kernel {r['device_ms']:.5f} ms (bound "
              f"{r['bound_ms']:.5f}, ms {r['ms']:.5f})", flush=True)


def host_us(torch, fn, reps: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (the wrapper's
    checks, allocations and launch), over ``reps`` calls with no
    synchronisation between them; the card runs them behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def per_call_device_us(torch, fns, symbols, per_profile: int = 100):
    """Device microseconds of each call of ``fns``, each of which launches
    one kernel named in ``symbols``: profiles of ``per_profile`` calls in
    turn, their kernel events taken in order of their start. A part whose
    profiles keep missing an event is profiled again in halves."""
    from torch.autograd import DeviceType
    out = []
    for lo in range(0, len(fns), per_profile):
        part = fns[lo:lo + per_profile]
        for fn in part:
            fn()
        torch.cuda.synchronize()
        for attempt in range(_PROFILE_ATTEMPTS):
            prof, _ = _profiled(torch, lambda: [fn() for fn in part])
            events = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and any(k in e.name for k in symbols)),
                            key=lambda e: e.time_range.start)
            if len(events) == len(part):
                out += [e.time_range.elapsed_us() for e in events]
                break
            print(f"profile of {len(part)} calls: {len(events)} kernel "
                  f"events in attempt {attempt + 1}", flush=True)
        else:
            if len(part) == 1:
                fail(f"profile of {len(part)} calls: no kernel event a call")
            half = (len(part) + 1) // 2
            out += per_call_device_us(torch, part, symbols, half)
    return out


def call_device_us(torch, fn, reps: int = 5) -> float:
    """Device microseconds of one call of ``fn``: every device event of
    ``reps`` calls (kernels, fills and copies), over ``reps``."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(_PROFILE_ATTEMPTS):
        prof, _ = _profiled(torch, lambda: [fn() for _ in range(reps)])
        events = _device_events(prof)
        if events:
            return sum(e[2] for e in events) / reps
    fail("profile of a call: no device event")


def probe_bound(torch, hp, c, rate):
    """(ms, by) of one probe call: its keys in, found and value out, and
    the table sectors its keys' runs visit; a hash and a compare a key."""
    n = c["keys"].shape[0]
    return bound_ms(n * 9 + probe_table_bytes(torch, hp, c["tk"], c["keys"],
                                              c["max_probes"], c["empty"]),
                    n * 8, rate)


def report_probes(torch, hp, calls, rate):
    """Every captured ``hash_probe`` call (``capture_calls`` at W = 1,
    ``capture_workers`` at W = 4), each launched once in profiles of 100:
    prints a line a call (keys, table slots, ``max_probes``, hit rate,
    whether the table's 8 bytes a slot fit the L2, the bound, device µs)
    and the sums at each W; returns the heaviest group of calls, those of
    one query, W and shape with the most device time in all."""
    fns = [lambda c=c: hp.hash_probe(c["tk"], c["tv"], c["keys"], c["empty"],
                                     c["max_probes"]) for c in calls]
    us = per_call_device_us(torch, fns, _KERNEL_SYMBOLS["hash_probe"])
    groups, sums = {}, {}
    for c, u in zip(calls, us):
        n, t = c["keys"].shape[0], c["tk"].shape[0]
        b, _ = probe_bound(torch, hp, c, rate)
        c["device_us"], c["bound_us"] = u, b * 1e3
        print(f"shape hash_probe Q{c['q']} W={c['w']}: n={n} T={t} "
              f"max_probes={c['max_probes']} hit_rate="
              f"{c['hits'] / max(n, 1):.4f} fits_l2={8 * t <= _L2_BYTES} "
              f"bound_us={c['bound_us']:.3f} device_us={u:.3f}", flush=True)
        groups.setdefault((c["q"], c["w"], t, n), []).append(c)
        s = sums.setdefault(c["w"], [0, 0.0, 0.0])
        s[0], s[1], s[2] = s[0] + 1, s[1] + u, s[2] + c["bound_us"]
    for w, (k, u, b) in sorted(sums.items()):
        print(f"shape hash_probe W={w}: {k} calls, device_us {u:.3f}, "
              f"bound_us {b:.3f}", flush=True)
    return max(groups.values(), key=lambda g: sum(c["device_us"] for c in g))


def partition_bound(torch, c, rate):
    """(ms, by) of one repartition's metadata pass: 1 B of validity and 4 B
    of pid a row, the W x W counts, and the key bytes of the live rows as
    the kernel reads them (an int32 column's 32-byte sectors that hold a
    live row, a bytes column's lanes of each live row); some ten integer
    operations a key column and row."""
    nbytes, ops = 4 * c["w"] ** 2, 0
    for cols, v in zip(c["keys"], c["valid"]):
        live = int(v.sum())
        nbytes += 5 * v.shape[0]
        ops += 10 * len(cols) * v.shape[0]
        for k in cols:
            nbytes += (32 * _sectors(torch, v, 4) if k.dim() == 1
                       else live * k.shape[1])
    return bound_ms(nbytes, ops, rate)


def report_partitions(torch, calls, run, rate):
    """Every captured repartition's metadata phase, ``run(c)`` of it: a
    line a call (rows a source, the key columns' dtypes and widths, the
    bound, device µs of every event of the call, and the data phase's ms
    in the capture run) and the sums; returns the heaviest call."""
    total = [0.0, 0.0, 0.0]
    for c in calls:
        u = call_device_us(torch, lambda c=c: run(c))
        b, _ = partition_bound(torch, c, rate)
        c["device_us"], c["bound_us"] = u, b * 1e3
        total[0] += u
        total[1] += c["bound_us"]
        total[2] += c.get("data_ms", 0.0)
        keys = [(name, str(k.dtype).replace("torch.", ""),
                 1 if k.dim() == 1 else k.shape[1])
                for name, k in zip(c["names"], c["keys"][0])]
        print(f"shape repartition Q{c['q']} W={c['w']}: rows "
              f"{[v.shape[0] for v in c['valid']]} keys {keys} bound_us="
              f"{c['bound_us']:.3f} device_us={u:.3f} data_phase_ms="
              f"{c.get('data_ms', 0.0):.4f}", flush=True)
    print(f"shape repartition: {len(calls)} calls, device_us {total[0]:.3f}, "
          f"bound_us {total[1]:.3f}, data_phase_ms {total[2]:.4f}",
          flush=True)
    return max(calls, key=lambda c: c["device_us"])


def probe_row(torch, hp, calls, rate):
    """The standalone probe's row of the kernels line, on the heaviest
    group of main-path calls (``report_probes``): its first call timed
    (CUDA events; the wrapper's host µs a call), its plain version, its
    bound; ``device_ms`` the group's mean."""
    group = report_probes(torch, hp, calls, rate)
    c = group[0]
    args = (c["tk"], c["tv"], c["keys"], c["empty"], c["max_probes"])
    name = (f"hash_probe[Q{c['q']}]" if c["w"] == 1
            else f"hash_probe[Q{c['q']} W={c['w']}]")
    launcher = lambda a=args: hp.hash_probe(*a)  # noqa: E731
    b, by = probe_bound(torch, hp, c, rate)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/hash_table.cu",
               replaces="src/repro/kernels/hash_probe.py:174",
               max_abs_err=0.0, ms=time_ms(torch, launcher),
               plain_ms=time_ms(torch, lambda: hp.hash_probe_plain(*args),
                                reps=3, warm=1),
               bound_ms=b, bound_by=by, library_ms=None,
               device_ms=sum(x["device_us"] for x in group) / len(group) / 1e3,
               host_us=host_us(torch, launcher), calls=len(group),
               keys=c["keys"].shape[0], slots=c["tk"].shape[0])
    print(f"row {json.dumps(row)}", flush=True)
    return [row], {name: launcher}


def partition_row(torch, rh, calls, rate):
    """The exchange's metadata pass's row of the kernels line, on the
    heaviest repartition (``report_partitions``): timed (CUDA events; the
    wrapper's host µs a call), its plain version, its bound; beside it one
    ``torch.bincount`` of the call's in-range (source, destination) bins,
    the histogram alone (no PyTorch call hashes the rows too)."""
    def run(c):
        return rh.partition_histogram(c["keys"], c["valid"], c["w"])

    c = report_partitions(torch, calls, run, rate)
    w = c["w"]
    pids, _ = rh.partition_histogram_plain(c["keys"], c["valid"], w)
    bins = _bins(torch, pids, c["valid"], w)
    in_range = bins[bins < w * w]
    b, by = partition_bound(torch, c, rate)
    launcher = lambda: run(c)  # noqa: E731
    name = f"radix_histogram[Q{c['q']} W={w}]"
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/radix_histogram.cu",
               replaces="src/repro/kernels/radix_histogram.py:36",
               max_abs_err=0.0, ms=time_ms(torch, launcher),
               plain_ms=time_ms(torch, lambda: rh.partition_histogram_plain(
                   c["keys"], c["valid"], w), reps=3, warm=1),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(torch, lambda: torch.bincount(
                   in_range, minlength=w * w)),
               device_ms=c["device_us"] / 1e3,
               host_us=host_us(torch, launcher, 50),
               rows=sum(v.shape[0] for v in c["valid"]),
               keys=list(c["names"]))
    print(f"row {json.dumps(row)}", flush=True)
    return [row], {name: launcher}


# ---------------------------------------------------------------------------
# the SQL phase: Session.sql on the card
# ---------------------------------------------------------------------------

# (c): the texts run unoptimized, among them Q4's and Q22's fused runs that
# carry a bytes column, Q16's LIKE and Q2's part filter (an IN of 30 values)
# split over several programs
_SQL_RAW = (1, 2, 3, 4, 6, 14, 16, 22)
# an unoptimized plan's aggregation keeps the builder's default capacity of
# 4096 groups and drops the groups past it, in the reference as in the
# port; at SF 1 these texts' raw plans pass it (Q2's min over 200,000
# parts, Q3's 11,620 orders, Q16's 18,314 groups), so there they are held
# to the same raw plan on the CPU, and all eight to their optimized
# results at _RAW_SF, where every raw capacity holds
_SQL_RAW_CAPPED = (2, 3, 16)
_RAW_SF = 0.01
# (d): EXTRACT(YEAR) and LIKE in one fused run over orders
_YEAR_LIKE = ("SELECT o_orderkey, EXTRACT(YEAR FROM o_orderdate) AS y, "
              "o_comment FROM orders WHERE EXTRACT(YEAR FROM o_orderdate) "
              "= 1995 AND o_comment LIKE '%special%requests%'")
# (e): a composite join whose two key columns do not pack into 31 bits at
# SF 1 (6M order keys x 150K customer keys): the sorted-key path
_COMPOSITE = ("SELECT count(*) AS n FROM lineitem, orders "
              "WHERE l_orderkey = o_orderkey AND l_suppkey = o_custkey")
# (f): one serving template, its texts differing only in literals
_SQL_SERVING = 32
_SERVING_TEXT = ("SELECT count(*) AS n, sum(o_totalprice) AS total "
                 "FROM orders WHERE EXTRACT(YEAR FROM o_orderdate) = {y} "
                 "AND o_comment LIKE '%special%requests%' "
                 "AND o_totalprice > {p}")
# (d): synthetic rows for BYTESMATCH, 12 bytes wide, space padded, and the
# patterns held to the plain version on them: a row of spaces (length 0),
# parts that would overlap, a part at the very end, a part longer than W
_MATCH_ROWS = ("", "ab", "special requests", "special  requestsx",
               "requests special", "aaa", "aaaa", "abcab", "xxxxxxxxxxab",
               "ab          ", "   ab", "Customer Co")
_MATCH_CASES = ((("a",), "contains"), (("aa", "aa"), "contains"),
                (("ab", "ab"), "contains"),
                (("special", "requests"), "contains"),
                (("requests", "special"), "contains"), (("ab",), "endswith"),
                ((" ab",), "endswith"), (("ab",), "startswith"),
                (("x" * 13,), "contains"), (("x" * 13,), "endswith"),
                (("xxxxxxxxxxab",), "contains"), ((" ",), "endswith"))


def _year_days(np):
    """Every year start from 1969 to 2040, a day either side, and the
    int32 extremes."""
    starts = [(np.datetime64(f"{y}-01-01") - np.datetime64("1970-01-01"))
              .astype(int) for y in range(1969, 2042)]
    i32 = np.iinfo(np.int32)
    return np.array([d + k for d in starts for k in (-1, 0, 1)]
                    + [i32.min, i32.min + 1, i32.max - 1, i32.max], np.int32)


def _fused_bytes(program, table, out):
    """The bytes a fused program must move on ``table``: each column it
    reads (a bytes column's n x W), the validity, each stored output and
    the output validity."""
    n = table.capacity
    read = sum(table.columns[c].element_size()
               * (table.columns[c].shape[1] if table.columns[c].dim() == 2
                  else 1) for c in program.in_names)
    alias = program.out_alias or (None,) * len(program.out_names)
    wrote = sum(out.columns[c].element_size()
                for c, a in zip(program.out_names, alias) if a is None)
    return n * (read + 1 + wrote + 1)


def _fused_ops(fused, program, table):
    """Operations a row: one an instruction, a bytes row's W a BYTESMATCH."""
    widths = dict(zip(program.in_names, program.in_widths))
    ops = 0
    for op, _, a, _ in program.code.tolist():
        ops += (widths[program.in_names[a]]
                if op == fused.OPS["BYTESMATCH"] else 1)
    return table.capacity * ops


def check_sql_instructions(torch, fused, catalog, data, rate, q16=None):
    """(d): YEAR and BYTESMATCH on the card against ``apply_stages``,
    exact: YEAR over every year start +-1 from 1969 to 2040 and the int32
    extremes, BYTESMATCH over ``_MATCH_ROWS`` with each of
    ``_MATCH_CASES``, then the fused run of ``_YEAR_LIKE`` on the first 1M
    rows of orders and SQL Q16's BYTESMATCH run (``q16``: the table and
    stages its FusedMorsel received), each also on the views of
    ``_FUSED_VIEWS``. Returns the kernels-line rows and their launchers."""
    import numpy as np

    from repro_torch.core import dtypes as dt
    from repro_torch.core.expr import BytesMatch, Year, col, lit
    from repro_torch.core.session import Session
    from repro_torch.core.table import TorchTable

    days = _year_days(np)
    table = TorchTable.from_numpy({"d": days}, {"d": dt.DATE32},
                                  device="cuda")
    stages = [(Year(col("d")) > lit(1960), (("y", Year(col("d"))),
                                            ("c", Year(lit(9500)))))]
    program = fused.lower_stages(table, stages)
    _check_fused_case(torch, fused, table, stages, program,
                      "fused_morsel_program[YEAR synthetic]")
    rows = np.array([list(s.encode().ljust(12)[:12]) for s in _MATCH_ROWS],
                    np.uint8)
    table = TorchTable.from_numpy({"s": rows}, {"s": dt.bytes_(12)},
                                  device="cuda")
    for parts, mode in _MATCH_CASES:
        e = BytesMatch(col("s"), parts, mode)
        stages = [(None, (("m", e), ("s", col("s"))))]
        _check_fused_case(torch, fused, table, stages,
                          fused.lower_stages(table, stages),
                          "fused_morsel_program[BYTESMATCH synthetic]")
    print(f"check fused_morsel_program[YEAR synthetic]: {len(days)} days "
          f"exact; check fused_morsel_program[BYTESMATCH synthetic]: "
          f"{len(_MATCH_CASES)} patterns over {len(rows)} rows exact",
          flush=True)

    cases = []
    plan = Session(catalog, device="cuda").sql(_YEAR_LIKE).optimized()
    while type(plan).__name__ != "Project":
        plan = plan.child
    scan = plan.child
    orders = data["orders"]
    n = min(len(orders["o_orderkey"]), _MAIN_ROWS)
    schema = catalog.get("orders").schema
    morsel = TorchTable.from_numpy(
        {c: orders[c][:n] for c in scan.columns},
        {c: schema[c] for c in scan.columns}, capacity=_MAIN_ROWS,
        device="cuda")
    cases.append(("YEAR+BYTESMATCH orders", morsel,
                  [(scan.filter, None), (None, tuple(plan.projections))]))
    if q16 is not None:
        cases.append(("BYTESMATCH SQL Q16",) + q16)
    rows_out, launchers = [], {}
    for label, table, stages in cases:
        program = fused.lower_stages(table, stages)
        ops = set(program.code[:, 0].tolist())
        if fused.OPS["BYTESMATCH"] not in ops or (
                "YEAR" in label and fused.OPS["YEAR"] not in ops):
            fail(f"fused_morsel_program[{label}]: the program holds no "
                 f"{label.split()[0]}")
        name = f"fused_morsel_program[{label}]"
        got = _check_fused_case(torch, fused, table, stages, program, name)
        for view_label, sl in _FUSED_VIEWS:
            _check_fused_case(torch, fused, view(table, sl), stages, program,
                              f"fused_morsel_program[{label} {view_label}]")
        launchers[name] = (lambda t=table, st=stages, p=program:
                           fused.fused_morsel_program(t, st, program=p))
        ms = time_ms(torch, launchers[name])
        plain_ms = time_ms(torch, lambda t=table, st=stages:
                           fused.apply_stages(t, st))
        b, by = bound_ms(_fused_bytes(program, table, got),
                         _fused_ops(fused, program, table), rate)
        print(f"check {name} rows={table.capacity}: "
              f"{program.code.shape[0]} instructions, pool "
              f"{len(program.pool)} B, {program.plan.smem_bytes()} B of "
              f"shared memory, live {int(got.validity.sum())}, bit-identical "
              f"(and {', '.join(v for v, _ in _FUSED_VIEWS)}); {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by})", flush=True)
        rows_out.append(dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/fused_morsel.cu",
                             replaces="src/repro/core/fused.py:78",
                             max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=None))
    return rows_out, launchers


def compare_common(q, got, want, what):
    """``compare`` on the columns both results have (a SQL text names the
    oracle's output columns, the hand-built plan may carry more)."""
    common = sorted(set(got) & set(want))
    if not common:
        fail(f"Q{q}: no column in common with {what}")
    compare(q, {c: got[c] for c in common}, {c: want[c] for c in common},
            what)


def _sql_once(torch, builder, options=None):
    """One collect of a SQL builder, timed, with the counters (kernels and
    instructions) set to 0 just before and read just after."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = builder.collect(options=options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts.update(ops.instruction_launches())
    return got, counts, [wall]


def _sql_timed(torch, builder, options=None):
    """``_timed`` for a SQL builder: one warm-up collect, then three timed
    ones, the first counted by ``_sql_once``."""
    builder.collect(options=options)
    got, counts, walls = _sql_once(torch, builder, options)
    for _ in range(2):
        t0 = time.perf_counter()
        builder.collect(options=options)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return got, counts, walls


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def sql_texts(torch, fused, catalog, results, walls):
    """(a) the 20 texts at W = 1, each equal to phase 5's result of the
    query on their common columns (Q10 and Q18, restated, as multisets of
    rows under ``compare``'s tolerance), walls (three after a warm-up)
    beside phase 5's, then ``_YEAR_LIKE`` against its CPU run; (b) the 20
    at W = 4 (one run each), each equal to its W = 1 SQL result. Returns
    the W = 1 results, the launches (kernels and instructions) of the
    counted runs and the table and stages of Q16's BYTESMATCH run."""
    from repro_torch import ICIExchange
    from repro_torch.core.session import ExecutionOptions, Session
    from repro_torch.tpch import sqltext

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    w4 = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                 num_workers=_WORKERS, exchange=ICIExchange())
    total, sql_results, q16 = {}, {}, []
    orig = fused.fused_morsel_program

    def keep(table, stages, probe=None, program=None):
        if not q16 and probe is None:
            held = program or fused.lower_stages(table, stages)
            if fused.OPS["BYTESMATCH"] in held.code[:, 0].tolist():
                q16.append((table, list(stages)))
        return orig(table, stages, probe=probe, program=program)

    sums = [0.0, 0.0]
    for q in sqltext.SUPPORTED:
        text = sqltext.sql_text(q, catalog)
        t0 = time.perf_counter()
        builder = gpu.sql(text)
        plan_s = time.perf_counter() - t0
        if q == 16:
            fused.fused_morsel_program = keep
        try:
            got, counts, sql_walls = _sql_timed(torch, builder)
        finally:
            fused.fused_morsel_program = orig
        compare_common(q, got, results[q], "phase 5's run of the query")
        _add(total, counts)
        sums[0] += sorted(sql_walls)[1]
        sums[1] += sorted(walls[q])[1]
        print(f"sql Q{q} SF {_SF} W=1: lowering {plan_s:.4f} s, gpu "
              f"{_walls(sql_walls)} s, phase 5 {_walls(walls[q])} s, rows "
              f"{len(next(iter(got.values())))}, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        w4_got, w4_counts, w4_walls = _sql_once(torch, w4.sql(text))
        compare(q, w4_got, got, "its W=1 SQL run")
        print(f"sql Q{q} W={_WORKERS}: gpu {_walls(w4_walls)} s, launches "
              f"{ {k: v for k, v in w4_counts.items() if v} }", flush=True)
        sql_results[q] = got
    print(f"sql walls, sums of the 20 medians: SQL {sums[0]:.4f} s, phase 5 "
          f"{sums[1]:.4f} s", flush=True)
    if not q16:
        fail("sql Q16: no fused run held BYTESMATCH")
    # no TPC-H text fuses an EXTRACT(YEAR): _YEAR_LIKE does, against its
    # CPU run
    got, counts, year_walls = _sql_timed(torch, gpu.sql(_YEAR_LIKE))
    cpu = Session(catalog, device="cpu", batch_rows=_MAIN_ROWS)
    compare("year_like", got, cpu.sql(_YEAR_LIKE).collect(), "its CPU run")
    if not counts["fused_morsel_program.YEAR"]:
        fail(f"sql year_like: no fused launch ran YEAR ({counts})")
    _add(total, counts)
    print(f"sql year_like W=1: gpu {_walls(year_walls)} s, rows "
          f"{len(next(iter(got.values())))}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return sql_results, total, q16[0]


def sql_unoptimized(torch, catalog, sql_results, total):
    """(c) ``_SQL_RAW`` with ``ExecutionOptions(optimize=False)``, one run
    each with its fused launches: at SF 1 each equal to the same raw plan
    on the CPU and, but for ``_SQL_RAW_CAPPED``, to its optimized result;
    at ``_RAW_SF`` each equal to its optimized result on the card."""
    from repro_torch.core.session import Catalog, ExecutionOptions, Session
    from repro_torch.tpch import dbgen, schema, sqltext

    raw = ExecutionOptions(optimize=False)
    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    cpu = Session(catalog, device="cpu", batch_rows=_MAIN_ROWS)
    for q in _SQL_RAW:
        text = sqltext.sql_text(q, catalog)
        got, counts, raw_walls = _sql_once(torch, gpu.sql(text), raw)
        compare(q, got, cpu.sql(text, options=raw).collect(),
                "the same unoptimized plan on the CPU")
        rows = (len(next(iter(got.values()))),
                len(next(iter(sql_results[q].values()))))
        if q not in _SQL_RAW_CAPPED:
            compare(q, got, sql_results[q], "its optimized SQL run")
        _add(total, counts)
        print(f"sql Q{q} optimize=False: gpu {_walls(raw_walls)} s, rows "
              f"{rows[0]} (optimized {rows[1]}), fused_morsel_program "
              f"launches {counts['fused_morsel_program']}, "
              f"fused_morsel_probe {counts['fused_morsel_probe']}, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    small = Catalog.from_numpy(
        dbgen.generate(_RAW_SF), schema.SCHEMAS,
        {t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    gpu = Session(small, device="cuda", batch_rows=_MAIN_ROWS)
    for q in _SQL_RAW:
        builder = gpu.sql(sqltext.sql_text(q, small))
        got, counts, _ = _sql_once(torch, builder, raw)
        compare(q, got, builder.collect(), f"its optimized run at SF "
                f"{_RAW_SF}")
        print(f"sql Q{q} optimize=False SF {_RAW_SF}: equal to its optimized "
              f"run, fused_morsel_program launches "
              f"{counts['fused_morsel_program']}", flush=True)


def sql_composite(torch, catalog, data):
    """(e): ``_COMPOSITE`` at SF 1 through the sorted-key join, its count
    equal to the exact count computed with numpy from the catalog's
    columns."""
    import numpy as np

    from repro_torch.core.session import Session

    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    got, counts, walls = _sql_timed(torch, gpu.sql(_COMPOSITE))
    li, od = data["lineitem"], data["orders"]
    pairs = (od["o_orderkey"].astype(np.int64) << 20) | od["o_custkey"]
    keys = (li["l_orderkey"].astype(np.int64) << 20) | li["l_suppkey"]
    want = int(np.isin(keys, pairs).sum())
    dispatch = gpu.executor_stats()["kernel_dispatch"]
    if int(got["n"][0]) != want:
        fail(f"sql composite join: count {int(got['n'][0])}, numpy {want}")
    if dispatch.get("fallback_probe") != 1:
        fail(f"sql composite join: kernel_dispatch {dispatch}, want one "
             "fallback_probe (the sorted-key path)")
    print(f"sql composite join SF {_SF}: count {want} equal to numpy's, "
          f"sorted-key path (kernel_dispatch {dispatch}), gpu "
          f"{_walls(walls)} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)


def sql_serving(torch, fused, catalog, data, rate):
    """(f): ``_SQL_SERVING`` texts of ``_SERVING_TEXT`` through the
    scheduler with batching on, each equal to its solo run; at least one
    stacked batch, no fallback, and a repeated text served from the result
    cache under its ``sql=`` key. Then the stacked program at 32 lanes on
    the first 1M rows of orders against ``apply_batched_stages``, exact,
    and timed. Returns its kernels-line row, launcher and the instruction
    launches of the batched run."""
    from repro_torch import SchedulerConfig, Session
    from repro_torch.core import batch
    from repro_torch.core.table import TorchTable
    from repro_torch.kernels import ops

    texts = [_SERVING_TEXT.format(y=1992 + j % 7, p=1000.0 * (j + 1))
             for j in range(_SQL_SERVING)]
    solo_session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    solo = [solo_session.sql(t).collect() for t in texts]
    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    session.scheduler_config = SchedulerConfig(
        batching=True, max_batch=_SQL_SERVING, max_concurrency=4,
        batch_window_ms=50, memory_budget=8 << 30, max_queue=2 * len(texts))
    session.scheduler()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [session.sql(t).submit() for t in texts]
    got = session.gather(*handles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    instr = ops.instruction_launches()
    for j, (g, w) in enumerate(zip(got, solo)):
        compare(f"serving sql#{j}", g, w, "its solo run on the card")
    again = session.sql(texts[0]).submit()
    compare("serving sql#0 repeat", again.result(), solo[0],
            "its solo run on the card")
    stats = session.scheduler().stats()
    session.scheduler().close()
    _check_threads_exited("sql serving")
    if stats["batches"] < 1 or stats["batch_fallbacks"]:
        fail(f"sql serving: {stats['batches']} batches, "
             f"{stats['batch_fallbacks']} fallbacks (want >= 1 and 0)")
    if not (again.cache_hit and handles[0]._result_key.startswith("sql=")):
        fail(f"sql serving: the repeated text was no result-cache hit "
             f"(key {handles[0]._result_key[:24]})")
    if not (counts["fused_batch_program"]
            and instr["fused_batch_program.BYTESMATCH"]
            and instr["fused_batch_program.YEAR"]):
        fail(f"sql serving: launches {counts}, instructions {instr}")
    print(f"sql serving SF {_SF}: {len(texts)} texts in {wall:.4f} s "
          f"({len(texts) / wall:.1f} q/s), {stats['batches']} stacked "
          f"batches of {stats['batched_queries']} queries, "
          f"{stats['batch_fallbacks']} fallbacks, repeat from the result "
          f"cache, launches { {k: v for k, v in counts.items() if v} }, "
          f"instructions { {k: v for k, v in instr.items() if v} }",
          flush=True)

    shapes = [batch.extract_shape(session.sql(t).optimized())
              for t in texts]
    prog = shapes[0].program
    if any(s is None or s.program is not prog for s in shapes):
        fail("sql serving: the texts do not share one batch program")
    src, schema = data[prog.table], catalog.get(prog.table).schema
    n = min(len(src[prog.columns[0]]), _MAIN_ROWS)
    table = TorchTable.from_numpy({c: src[c][:n] for c in prog.columns},
                                  {c: schema[c] for c in prog.columns},
                                  capacity=_MAIN_ROWS, device="cuda")
    params = batch._params(prog, shapes, _LANES, table.device)
    lowered = prog.lowered(table)
    name = "fused_batch_program[YEAR+BYTESMATCH sql]"
    for part in (table, view(table, slice(0, 999_999)),
                 view(table, slice(1, None))):
        got_t, masks = fused.fused_batch_program(part, prog.pre_stages,
                                                 params, _LANES,
                                                 program=lowered)
        want_t, want_masks = fused.apply_batched_stages(
            part, prog.pre_stages, params, _LANES)
        torch.cuda.synchronize()
        if not torch.equal(masks, want_masks):
            fail(f"{name} n={part.capacity}: masks differ from "
                 "apply_batched_stages")
        for c in want_t.column_names:
            if not torch.equal(got_t.columns[c], want_t.columns[c]):
                fail(f"{name} n={part.capacity}: column {c} differs")
    launcher = (lambda: fused.fused_batch_program(
        table, prog.pre_stages, params, _LANES, program=lowered))
    ms = time_ms(torch, launcher)
    plain_ms = time_ms(torch, lambda: fused.apply_batched_stages(
        table, prog.pre_stages, params, _LANES), reps=5)
    widths = dict(zip(lowered.in_names, lowered.in_widths))
    read = sum(table.columns[c].element_size() * (widths[c] or 1)
               for c in lowered.in_names)
    stored = [torch.tensor([], dtype=d).element_size()
              for d, a in zip(lowered.out_dtypes, lowered.out_alias)
              if a is None]
    nbytes = table.capacity * (read + 1 + sum(stored) + _LANES)
    b, by = bound_ms(nbytes, table.capacity * _batch_ops(fused, lowered,
                                                           _LANES), rate)
    print(f"check {name} rows={table.capacity} lanes={_LANES}: "
          f"{lowered.code.shape[0]} instructions, pool "
          f"{len(lowered.pool)} B, exact (and n=999999, offset 1); "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b:.5f} ms ({by})",
          flush=True)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/fused_batch.cu",
               replaces="src/repro/core/fused.py:178", max_abs_err=0.0,
               ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=None,
               launches=instr["fused_batch_program.BYTESMATCH"])
    return row, {name: launcher}


def run_sql(torch, fused, catalog, data, rate, results=None, walls=None):
    """The SQL phase (a)-(f). ``results`` and ``walls`` are phase 5's; with
    none (``--sql`` alone) each query's ``build_query`` plan runs on the
    card here first. Returns the kernels-line rows of the new instructions
    and their launchers."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries, sqltext

    t_phase = time.perf_counter()
    if results is None:
        gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
        results, walls = {}, {}
        for q in sqltext.SUPPORTED:
            results[q], _, _, walls[q] = _timed(
                torch, gpu, queries.build_query(q, catalog))
    sql_results, total, q16 = sql_texts(torch, fused, catalog, results,
                                        walls)
    sql_unoptimized(torch, catalog, sql_results, total)
    rows_out, launchers = check_sql_instructions(torch, fused, catalog, data,
                                                 rate, q16)
    for r in rows_out:
        key = "BYTESMATCH" if "Q16" in r["name"] else "YEAR"
        r["launches"] = (total.get(f"fused_morsel_program.{key}", 0)
                         + total.get(f"fused_morsel_probe.{key}", 0))
    sql_composite(torch, catalog, data)
    row, more = sql_serving(torch, fused, catalog, data, rate)
    rows_out.append(row)
    launchers.update(more)
    print(f"sql instructions in the counted runs of (a) and (c): "
          f"{json.dumps({k: v for k, v in total.items() if '.' in k})}",
          flush=True)
    print(f"sql phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows_out, launchers


# ---------------------------------------------------------------------------
# the out-of-core phase: the 22 queries under a quarter of their footprint
# ---------------------------------------------------------------------------

# (a): the queries that must spill at W = 1, each with the share of its
# footprint it must spill under: Q18 under a quarter, Q3 under a
# sixteenth, since at SF 1 a quarter of Q3's leaves its joins inside
# their reservations (the estimate is mostly its OrderBy and aggregation,
# which reserve no more than the flush point needs)
_FORCED_SHARE = 16
_MUST_SPILL = {18: 4, 3: _FORCED_SHARE}
# (c): the queries run at W = 4, each under these shares of its W = 4
# footprint: a quarter, and a sixty-fourth. At SF 1 the W = 4 footprint is
# mostly the aggregations' accumulators, one a worker, so under a quarter
# or a sixteenth every join still fits its reservation; under a
# sixty-fourth Q5's and Q18's largest joins go grace
_SPILL_W4 = (3, 5, 18)
_W4_SHARES = (4, 64)
# the standalone histogram at grace shapes, synthetic (``--partition`` runs
# them too): ids of W workers' rows in [0, W * P], the last the dead rows'
# dropped bin; row counts that are no multiple of the 512-thread block
# among them, and W * P = 256 at W = 4
_HIST_CASES = ("grace n=1500000 P=64", "grace n=1048576 P=2",
               "grace n=100003 P=8", "grace n=1 P=2",
               "grace W=4 n=1048579 P=64")
_HIST_SYMBOLS = ("histogram_shared_kernel", "histogram_global_kernel")


def footprint_budget(catalog, plan, workers: int = 1, share: int = 4) -> int:
    """The reference's sweep rule at ``share`` 4: a ``1 / share`` of the
    plan's estimated footprint at the main path's morsel size, at least
    1 KiB."""
    from repro_torch.core.optimizer import estimate_memory
    est = estimate_memory(plan, catalog, num_workers=workers,
                          batch_rows=_MAIN_ROWS, prefetch_depth=2)
    return max(est // share, 1024)


def check_hist_call(torch, rh, ids, bins, what, failures, show=True):
    """The standalone ``radix_histogram`` against its plain version on one
    call's ids, exact. A miss goes into ``failures`` (and is printed
    whatever ``show`` says)."""
    got = rh.radix_histogram(ids, bins)
    want = rh.radix_histogram_plain(ids, bins)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    if not same:
        failures.append(f"radix_histogram[{what}]: {got.tolist()} vs plain "
                        f"{want.tolist()}")
    if show or not same:
        print(f"check radix_histogram[{what}]: ids={ids.shape[0]} P={bins} "
              f"(n % 512 = {ids.shape[0] % 512}) live {int(got.sum())}: "
              + ("exact" if same else "differs"), flush=True)


def check_hist_cases(torch, rh, failures):
    """``_HIST_CASES`` on the card (``check_hist_call`` each)."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    for case in _HIST_CASES:
        parts = dict(x.split("=") for x in case.split()[1:])
        w, n, p = int(parts.get("W", 1)), int(parts["n"]), int(parts["P"])
        ids = torch.randint(0, w * p + 1, (w * n,), generator=gen,
                            device="cuda", dtype=torch.int32)
        check_hist_call(torch, rh, ids, w * p, case, failures)


@contextlib.contextmanager
def grace_capture(calls, joins):
    """While active, keep each grace-join histogram call's ids (copied to
    the host, so that the card's peak memory is the query's), device and
    bins
    (``operators.radix_histogram``, the standalone kernel's wrapper, as
    ``_grace_pids`` calls it) in ``calls``, and each sealed grace join's
    (partitions, spilled build partitions) in ``joins``."""
    from repro_torch.core import operators
    hist, seal = operators.radix_histogram, operators.GraceHashJoin.seal_build

    def hist_kept(ids, bins):
        calls.append({"ids": ids.cpu(), "bins": bins, "device": ids.device})
        return hist(ids, bins)

    def seal_kept(self):
        seal(self)
        joins.append((self.num_partitions, len(self._spilled_build)))

    operators.radix_histogram = hist_kept
    operators.GraceHashJoin.seal_build = seal_kept
    try:
        yield
    finally:
        operators.radix_histogram = hist
        operators.GraceHashJoin.seal_build = seal


@contextlib.contextmanager
def grace_launches(record):
    """While active, ``record["n"]`` counts the standalone histogram's
    launches made by grace joins (by the calls of
    ``operators.radix_histogram``, as ``_grace_pids`` makes them), apart
    from the exchange's ``partition_histogram``, whose launches share the
    ``radix_histogram`` counter."""
    from repro_torch.core import operators
    from repro_torch.kernels import ops
    hist = operators.radix_histogram

    def counted(ids, bins):
        before = ops.launch_counts()["radix_histogram"]
        out = hist(ids, bins)
        record["n"] += ops.launch_counts()["radix_histogram"] - before
        return out

    record["n"] = 0
    operators.radix_histogram = counted
    try:
        yield
    finally:
        operators.radix_histogram = hist


@contextlib.contextmanager
def host_peak(record):
    """While active, ``record["peak"]`` is the most bytes of spilled
    partitions any ``SpillManager``'s host tier held at once (read after
    each partition it took in)."""
    from repro_torch.core.spill import SpillManager
    make_room = SpillManager._make_room

    def kept(self):
        held = sum(p.nbytes for p in self._host_store.values())
        record["peak"] = max(record.get("peak", 0), held)
        make_room(self)

    SpillManager._make_room = kept
    try:
        yield
    finally:
        SpillManager._make_room = make_room


def _spill_text(sp) -> str:
    h, d = sp["host"], sp["disk"]
    return (f"spilled {sp['spilled_bytes']} B, host {h['spills']} spills "
            f"{h['restores']} restores {h['restored_bytes']} B restored, disk "
            f"{d['spills']} spills {d['restores']} restores "
            f"{d['spilled_bytes']} B written {d['restored_bytes']} B read, "
            f"reserved_peak {sp['reserved_peak']} B, denials "
            f"{sp['reserve_denials']}")


def _peak(torch, fn):
    """(fn's result, the bytes the caching allocator's peak rose above what
    was allocated before the call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _spill_run(torch, session, mem, plan, calls, what):
    """One query under ``session``'s budget: a warm-up run (its grace
    joins' histogram calls captured, the card's peak memory and the host
    tier's peak of spilled bytes read, and the in-memory session's card
    peak beside them), then three timed runs, the launch counters set to 0 just before
    the first and read just after, the grace joins' own histogram
    launches among them as ``radix_histogram[grace]``: those of the
    exchange's ``partition_histogram`` (W > 1) share the counter. Returns
    (the first timed run's result, its executor stats, its launches, the
    grace joins, the walls, the card's two peaks and the host peak)."""
    from repro_torch.kernels import ops
    joins, host, grace = [], {}, {}
    with grace_capture(calls, joins), host_peak(host):
        _, peak = _peak(torch, lambda: session.execute(plan))
    _, mem_peak = _peak(torch, lambda: mem.execute(plan))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with grace_launches(grace):
        got = session.execute(plan)
        torch.cuda.synchronize()
    wall = [time.perf_counter() - t0]
    counts, stats = ops.launch_counts(), session.executor_stats()
    counts["radix_histogram[grace]"] = grace["n"]
    for _ in range(2):
        t0 = time.perf_counter()
        session.execute(plan)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    grace_pids = stats["kernel_dispatch"].get("partition", 0)
    if (counts["radix_histogram"] != grace_pids or (joins and not grace["n"])
            or (session.num_workers == 1
                and grace["n"] != counts["radix_histogram"])):
        fail(f"{what}: {counts['radix_histogram']} radix_histogram launches "
             f"({grace['n']} by grace joins) for {grace_pids} partition "
             f"dispatches and {len(joins)} grace joins")
    return got, stats, counts, joins, wall, (peak, mem_peak,
                                             host.get("peak", 0))


def _spill_line(what, budget, sp, joins, wall, peaks, counts,
                extra="") -> str:
    peak, mem_peak, hpeak = peaks
    return (f"spill {what} SF {_SF}, budget {budget} B: {_spill_text(sp)}, "
            f"grace joins (partitions, spilled build partitions) {joins}, "
            f"walls {_walls(wall)} s{extra}, peak allocated {peak} B vs "
            f"{mem_peak} B in memory, host tier peak {hpeak} B, launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")


def spill_queries(torch, catalog, results, walls):
    """(a): each of the 22 at W = 1 under a quarter of its footprint
    (``footprint_budget``), then Q3 under ``_FORCED_SHARE``, each through
    ``_spill_run``: each result equal to the in-memory one, each query of
    ``_MUST_SPILL`` spilled under its share, one standalone histogram
    launch a ``_grace_pids`` call (its ``partition`` dispatch). Returns
    the captured calls, the histogram's launches and the forced Q3's host
    peak."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    mem = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    calls, hist_launches, q3_host, spilled = [], 0, 0, []
    runs = [(q, 4) for q in _QUERIES] + [
        (q, share) for q, share in _MUST_SPILL.items() if share != 4]
    for q, share in runs:
        plan = queries.build_query(q, catalog)
        budget = footprint_budget(catalog, plan, share=share)
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          device_budget=budget)
        what = f"Q{q} W=1 at 1/{share} of its footprint"
        got, stats, counts, joins, wall, peaks = _spill_run(
            torch, session, mem, plan, calls, what)
        sp = stats["spill"]
        print(_spill_line(what, budget, sp, joins, wall, peaks, counts,
                          f" vs in memory {_walls(walls[q])} s"), flush=True)
        compare(q, got, results[q], "its in-memory run on the card")
        if share == 4 and sp["spilled_bytes"]:
            spilled.append(q)
        if _MUST_SPILL.get(q) == share and not sp["spilled_bytes"]:
            fail(f"{what} ({budget} B) spilled nothing")
        if q == 3 and share == _FORCED_SHARE:
            q3_host = peaks[2]
        hist_launches += counts["radix_histogram[grace]"]
    print(f"spill: under a quarter of their footprint {spilled} spilled",
          flush=True)
    return calls, hist_launches, q3_host


def spill_disk(torch, catalog, results, q3_host):
    """(b): Q3 under ``_FORCED_SHARE`` with a host budget one byte below
    the most spilled bytes its host tier held at once in (a), so that the
    largest partitions sink to disk at that peak (prefetched morsels share
    the budget, so a few more may) and the host decode (0.13-0.16 GB/s)
    stays within seconds; its spill files in a directory of its own: disk
    spills and restores, no more read back than written, the directory
    empty after."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    plan = queries.build_query(3, catalog)
    root = tempfile.mkdtemp(prefix="spill_disk_")
    try:
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          device_budget=footprint_budget(
                              catalog, plan, share=_FORCED_SHARE),
                          host_budget=max(q3_host - 1, 1), spill_dir=root)
        t0 = time.perf_counter()
        got = session.execute(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sp = session.executor_stats()["spill"]
        left = os.listdir(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"spill disk Q3 host budget {max(q3_host - 1, 1)} B: "
          f"{_spill_text(sp)}, wall {wall:.4f} s, files left {len(left)}",
          flush=True)
    compare(3, got, results[3], "its in-memory run on the card")
    d = sp["disk"]
    if not (d["spills"] and d["restores"]) or (
            d["restored_bytes"] > d["spilled_bytes"]) or left:
        fail(f"Q3 disk tier: {d}, {len(left)} files left")


def spill_workers(torch, catalog, results):
    """(c): Q3, Q5 and Q18 planned for ``_WORKERS`` workers under each
    of ``_W4_SHARES`` of their W = 4 footprint, each through ``_spill_run``
    (beside the in-memory run at W = 4) and equal to its W = 1 result,
    with its staged exchanges. At least one grace join must form, and
    every histogram call of a run's grace joins counts ``W * P`` bins for
    one of its joins' P. Returns the captured calls and the histogram's
    launches."""
    from repro_torch import ICIExchange
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    mem = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                  num_workers=_WORKERS, exchange=ICIExchange())
    calls, launches, graced = [], 0, []
    for q in _SPILL_W4:
        plan = queries.build_query(q, catalog, num_workers=_WORKERS)
        for share in _W4_SHARES:
            budget = footprint_budget(catalog, plan, _WORKERS, share)
            session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                              num_workers=_WORKERS, exchange=ICIExchange(),
                              device_budget=budget)
            what = f"Q{q} W={_WORKERS} at 1/{share} of its footprint"
            run_calls = []
            got, stats, counts, joins, wall, peaks = _spill_run(
                torch, session, mem, plan, run_calls, what)
            print(_spill_line(what, budget, stats["spill"], joins, wall,
                              peaks, counts, ", staged exchanges "
                              f"{stats['spill_staged_exchanges']}"),
                  flush=True)
            compare(q, got, results[q], "its W=1 run on the card")
            bins = {_WORKERS * p for p, _ in joins}
            odd = [c["bins"] for c in run_calls if c["bins"] not in bins]
            if odd:
                fail(f"{what}: histogram calls of {odd} bins for grace "
                     f"joins {joins}")
            if joins:
                graced.append(what)
            calls += run_calls
            launches += counts["radix_histogram[grace]"]
    if not graced:
        fail(f"no grace join formed at W={_WORKERS} under shares "
             f"{_W4_SHARES}")
    print(f"spill: grace joins at W={_WORKERS} in {graced}", flush=True)
    return calls, launches


def spill_scheduler(torch, catalog, results):
    """(d): Q18 submitted with a ``memory_budget`` of a quarter of its
    footprint: admitted with a spill plan, run under a spill manager of
    that budget, right."""
    from repro_torch import SchedulerConfig
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    plan = queries.build_query(18, catalog)
    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    session.scheduler_config = SchedulerConfig(
        memory_budget=footprint_budget(catalog, plan), cache_results=False)
    try:
        handle = session.submit(plan)
        got = handle.result(timeout=600)
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    sp = handle.executor_stats["spill"]
    print(f"spill scheduler Q18 memory_budget "
          f"{session.scheduler_config.memory_budget} B: spill_admitted "
          f"{stats['spill_admitted']}, {_spill_text(sp)}", flush=True)
    compare(18, got, results[18], "its in-memory run on the card")
    if stats["spill_admitted"] != 1 or handle.spill_plan is None:
        fail(f"scheduler Q18: spill_admitted {stats['spill_admitted']}")


def spill_prefetch(torch, catalog, results):
    """(e): Q6 with a host budget of 1 B (each step over-subscribes it
    alone): right, and the budget's ``in_use`` back at 0."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                      device_budget=1 << 40, host_budget=1)
    got = session.execute(queries.build_query(6, catalog))
    in_use = session.last_driver.ctx.spill.host.in_use
    scan = session.executor_stats()["tables"]["lineitem"]
    print(f"spill prefetch Q6 host budget 1 B: morsels {scan['morsels']}, "
          f"in_use after {in_use} B", flush=True)
    compare(6, got, results[6], "its in-memory run on the card")
    if in_use:
        fail(f"Q6 host budget: {in_use} B still held")


def grace_hist_row(torch, rh, calls, launches, rate):
    """Row 8s of the kernels line: the standalone histogram on the largest
    captured grace call, timed (CUDA events), its plain version, its bound
    (each id read once, the counts written once) and one
    ``torch.bincount`` of the same ids beside it."""
    c = max(calls, key=lambda c: c["ids"].shape[0])
    ids, bins = c["ids"].cuda(), c["bins"]
    n = ids.shape[0]
    b, by = bound_ms(4 * n + 4 * bins, n, rate)
    launcher = lambda: rh.radix_histogram(ids, bins)  # noqa: E731
    name = f"radix_histogram[grace n={n} P={bins}]"
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/radix_histogram.cu",
               replaces="src/repro/kernels/radix_histogram.py:36",
               launches=launches, max_abs_err=0.0,
               ms=time_ms(torch, launcher),
               plain_ms=time_ms(torch, lambda: rh.radix_histogram_plain(
                   ids, bins), reps=3, warm=1),
               bound_ms=b, bound_by=by,
               library_ms=time_ms(torch, lambda: torch.bincount(
                   ids, minlength=bins + 1)),
               host_us=host_us(torch, launcher, 50), rows=n,
               calls=len(calls))
    print(f"row {json.dumps(row)}", flush=True)
    return [row], {name: launcher}


def grace_device_ms(torch, rows, launchers, reps: int = 10):
    """Device ms a call of row 8s from ``torch.profiler`` (the histogram
    kernel's events). After phase 9, as every profile of the run."""
    for r in rows:
        if r["name"].startswith("radix_histogram[grace"):
            hits, _ = _profile_calls(torch, r["name"], launchers[r["name"]],
                                     _HIST_SYMBOLS, reps)
            r["device_ms"] = sum(e[2] for e in hits) / reps / 1e3
            print(f"device {r['name']}: kernel {r['device_ms']:.5f} ms "
                  f"(bound {r['bound_ms']:.5f}, ms {r['ms']:.5f})",
                  flush=True)


def run_spill(torch, rh, catalog, rate, results=None, walls=None):
    """The out-of-core phase (a)-(e), then the standalone histogram on
    every captured grace call and ``_HIST_CASES``, exact. ``results`` and
    ``walls`` are phase 5's; with none (``--spill`` alone) each query runs
    in memory on the card here first. Returns row 8s of the kernels line
    and its launcher."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    t_phase = time.perf_counter()
    if results is None:
        gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
        results, walls = {}, {}
        for q in _QUERIES:
            results[q], _, _, walls[q] = _timed(
                torch, gpu, queries.build_query(q, catalog))
    calls, launches, q3_host = spill_queries(torch, catalog, results, walls)
    spill_disk(torch, catalog, results, q3_host)
    w4_calls, w4_launches = spill_workers(torch, catalog, results)
    failures = []
    for where, got in (("W=1", calls), (f"W={_WORKERS}", w4_calls)):
        for i, c in enumerate(got):
            check_hist_call(torch, rh, c["ids"].cuda(), c["bins"],
                            f"grace call {i} {where}", failures, show=False)
        shapes = sorted({(c["ids"].shape[0], c["bins"]) for c in got})
        print(f"check radix_histogram on the {len(got)} captured grace "
              f"calls at {where} (ids, bins) {shapes}: "
              + ("exact" if not failures else "differs"), flush=True)
    check_hist_cases(torch, rh, failures)
    if failures:
        fail("; ".join(failures))
    calls += w4_calls
    if not any(c["ids"].shape[0] % 512 for c in calls):
        fail("no captured grace histogram call has a row count that is no "
             "multiple of the block")
    spill_scheduler(torch, catalog, results)
    spill_prefetch(torch, catalog, results)
    rows, launchers = grace_hist_row(torch, rh, calls,
                                     launches + w4_launches, rate)
    print(f"out-of-core phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows, launchers


# ---------------------------------------------------------------------------
# the adaptive phase: the 22 queries cold, then warm from what they observed
# ---------------------------------------------------------------------------

# the oracle's worker processes, forked after the timed runs so that each
# reads the tables the script generated without a copy, and
# ``_ORACLE_DATA``, those tables, set just before the fork
_ORACLE_PROCS = 8
_ORACLE_DATA = None


def _oracle(q):
    """One query's answer from the port's numpy oracle (a pool worker)."""
    from repro_torch.tpch import oracle
    return q, oracle.ORACLES[q](_ORACLE_DATA)


def compare_oracle(q, got, want, what):
    """A result against the oracle's as the tests hold them
    (``tests/tpch_util.assert_results_match``): the columns both have,
    the same rows, exact for the oracle's integer and bytes columns
    (bytes rows compared as bytes), rtol 2e-3 (atol 1e-2) for its floats;
    rows matched by sorting on the exact columns, then on the floats
    rounded to 2 places."""
    import numpy as np

    def canon(a):
        a = np.asarray(a)
        if a.ndim == 2 and a.dtype == np.uint8:
            return np.array([row.tobytes() for row in a])
        return a

    common = [c for c in want if c in got]
    if not common:
        fail(f"Q{q} {what}: no column in common with the oracle")
    n = len(canon(next(iter(want.values()))))
    if any(len(canon(got[c])) != n for c in common):
        fail(f"Q{q} {what}: row count differs from the oracle's {n}")
    exact = [c for c in common if canon(want[c]).dtype.kind in "iubS"]
    floats = [c for c in common if c not in exact]

    def order(res):
        keys = []
        for c in (exact or common) + floats:
            a = canon(res[c])
            keys.append(a if a.dtype.kind == "S"
                        else np.round(a.astype(np.float64), 2))
        return np.lexsort(tuple(reversed(keys)))

    go, wo = order(got), order(want)
    for c in exact:
        if not np.array_equal(canon(got[c])[go], canon(want[c])[wo]):
            fail(f"Q{q} {what}: column {c} differs from the oracle")
    for c in floats:
        a = canon(got[c]).astype(np.float64)[go]
        b = canon(want[c]).astype(np.float64)[wo]
        if not np.all(np.isfinite(a)):
            fail(f"Q{q} {what}: column {c} has non-finite values")
        if not np.allclose(a, b, rtol=2e-3, atol=1e-2):
            fail(f"Q{q} {what}: column {c} differs from the oracle: "
                 f"{a} vs {b}")


def plan_sizes(plan):
    """(the sum of ``max_groups``, the sum of hash-table slots, the joins)
    of a plan: a join's table takes ``2 * build_rows`` slots rounded up to
    a power of two; each join as ``[type, probe keys, build keys,
    distribution, max_matches]``, the distribution of a W > 1 plan's
    ``local`` join read from the exchange placed on its build side."""
    from repro_torch.core import plan as P
    groups, slots, joins = 0, 0, []

    def visit(node):
        nonlocal groups, slots
        if isinstance(node, (P.Aggregation, P.Distinct)):
            groups += node.max_groups
        if isinstance(node, P.Join):
            if node.build_rows is not None:
                slots += 2 ** math.ceil(math.log2(max(2 * node.build_rows,
                                                      2)))
            dist = node.distribution
            if dist == "local" and isinstance(node.build, P.Broadcast):
                dist = "broadcast"
            elif dist == "local" and isinstance(node.build, P.Repartition):
                dist = "partitioned"
            joins.append([node.join_type, list(node.probe_keys),
                          list(node.build_keys), dist, node.max_matches])
        for child in node.children():
            visit(child)

    visit(plan)
    return groups, slots, joins


def capacity_rises(cold_plan, warm_plan):
    """The capacities (``max_groups``, ``build_rows``, ``max_matches``) of
    warm plan nodes above those of the cold node with the same feedback
    key (a node under a swapped join keys apart and is not compared)."""
    from repro_torch.core import plan as P
    fields = {"Aggregation": ("max_groups",), "Distinct": ("max_groups",),
              "Join": ("build_rows", "max_matches")}

    def sizes(plan):
        out = {}

        def visit(node):
            for f in fields.get(type(node).__name__, ()):
                out[(P.feedback_key(node), f)] = getattr(node, f)
            for child in node.children():
                visit(child)

        visit(plan)
        return out

    cold = sizes(cold_plan)
    return [(key[1], cold[key], v) for key, v in sizes(warm_plan).items()
            if cold.get(key) is not None and v > cold[key]]


def joins_changed(cold, warm):
    """The joins whose distribution, orientation (build and probe sides
    swapped) or ``max_matches`` the warm plan changed, paired with the
    cold plan's by type and key sets in walk order."""
    pending = {}
    for j in cold:
        pending.setdefault((j[0], frozenset(map(tuple, j[1:3]))),
                           []).append(j)
    out = []
    for w in warm:
        same = pending.get((w[0], frozenset(map(tuple, w[1:3]))))
        if not same:
            out.append({"new": w})
            continue
        c = same.pop(0)
        diff = {}
        if c[1] != w[1]:
            diff["orientation"] = f"{c[1]}={c[2]} -> {w[1]}={w[2]}"
        if c[3] != w[3]:
            diff["distribution"] = f"{c[3]} -> {w[3]}"
        if c[4] != w[4]:
            diff["max_matches"] = f"{c[4]} -> {w[4]}"
        if diff:
            out.append(dict({"keys": f"{c[1]}={c[2]}"}, **diff))
    return out


def _counted(torch, session, plan):
    """One run with the launch counters set to 0 just before and read
    just after: (result, executor stats, launches, wall)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = session.execute(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return got, session.executor_stats(), ops.launch_counts(), wall


def _wall(torch, session, plan):
    t0 = time.perf_counter()
    session.execute(plan)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _median(values):
    return sorted(values)[len(values) // 2]


def _sums_text(total):
    """The summed walls (s; each query's median of its timed runs, the
    cold run's own at W = 4) and capacities, as one line's text."""
    return ", ".join(f"{k} {round(v, 4) if isinstance(v, float) else v}"
                     for k, v in total.items())


def adaptive_w1(torch, catalog):
    """(a) and (d)'s estimates: each of the 22 at W = 1 on a store of its
    own (another query's observation of a shared subtree would make its
    first plan warm): the cold plan, fingerprint-equal to the static
    ``build_query`` plan, run once with the counters set to 0; the warm
    plan after one warm-up run, three timed runs with the counters read
    over the first, beside the static plan's three runs with feedback off
    and on (interleaved); warm equal to cold; warm ``fallback_probe`` at
    most cold's; ``estimate_memory`` warm at most cold. Returns each
    query's (cold, warm) results, the warm launches, the stores and warm
    plans."""
    from repro_torch.core import plan as P
    from repro_torch.core.feedback import FeedbackStore
    from repro_torch.core.optimizer import estimate_memory
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    off = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    results, launches, warm_state = {}, {}, {}
    cold_launches, total = {}, {}
    for q in range(1, 23):
        store = FeedbackStore()
        on = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                     feedback=store)
        raw = queries.build_query(q, catalog, optimized=False)
        static = queries.build_query(q, catalog)
        cold_plan = on.optimize(raw)
        if P.fingerprint(cold_plan) != P.fingerprint(static):
            fail(f"adaptive Q{q}: the cold plan is not the static plan")
        cold, cold_stats, cold_counts, cold_wall = _counted(torch, on,
                                                            cold_plan)
        warm_plan = on.optimize(raw)
        est = (estimate_memory(static, catalog, batch_rows=_MAIN_ROWS),
               estimate_memory(warm_plan, catalog, batch_rows=_MAIN_ROWS,
                               feedback=store))
        on.execute(warm_plan)                   # warm-up
        walls = {"off": [], "on": [], "warm": [], "harvest": []}
        for i in range(3):
            walls["off"].append(_wall(torch, off, static))
            walls["on"].append(_wall(torch, on, cold_plan))
            walls["harvest"].append(
                on.executor_stats()["op_seconds"]["FeedbackHarvest"])
            if i == 0:
                warm, warm_stats, warm_counts, t = _counted(torch, on,
                                                            warm_plan)
                walls["warm"].append(t)
            else:
                walls["warm"].append(_wall(torch, on, warm_plan))
        compare(q, warm, cold, "its cold run on the card")
        cg, cs, cj = plan_sizes(cold_plan)
        wg, ws, wj = plan_sizes(warm_plan)
        kd_cold, kd_warm = (cold_stats["kernel_dispatch"],
                            warm_stats["kernel_dispatch"])
        print(f"adaptive Q{q} W=1 SF {_SF}: cold {cold_wall:.4f} s, static "
              f"feedback off {_walls(walls['off'])} on "
              f"{_walls(walls['on'])} s, warm {_walls(walls['warm'])} s "
              f"(medians warm / off "
              f"{_median(walls['warm']) / _median(walls['off']):.3f}, on / "
              f"off {_median(walls['on']) / _median(walls['off']):.3f}; the "
              f"harvest's host ms after its read-back "
              f"{_median(walls['harvest']) * 1e3:.3f}); "
              f"max_groups {cg} -> {wg}, table slots {cs} -> {ws}; joins "
              f"changed {json.dumps(joins_changed(cj, wj))}; "
              f"estimate_memory {est[0]} -> {est[1]} B; kernel_dispatch "
              f"cold {json.dumps(kd_cold)} warm {json.dumps(kd_warm)}; "
              f"launches cold {json.dumps(_nonzero(cold_counts))} warm "
              f"{json.dumps(_nonzero(warm_counts))}; store "
              f"{len(store)} entries", flush=True)
        if kd_warm.get("fallback_probe", 0) > kd_cold.get("fallback_probe",
                                                          0):
            fail(f"adaptive Q{q}: warm fallback_probe "
                 f"{kd_warm.get('fallback_probe')} above cold's "
                 f"{kd_cold.get('fallback_probe', 0)}")
        if capacity_rises(cold_plan, warm_plan):
            fail(f"adaptive Q{q}: warm capacities above cold's: "
                 f"{capacity_rises(cold_plan, warm_plan)}")
        if est[1] > est[0]:
            fail(f"adaptive Q{q}: warm estimate_memory {est[1]} B above "
                 f"cold's {est[0]} B")
        results[q] = (cold, warm)
        launches[q], cold_launches[q] = warm_counts, cold_counts
        _add(total, {"off": _median(walls["off"]), "on": _median(walls["on"]),
                     "warm": _median(walls["warm"]),
                     "harvest": _median(walls["harvest"]), "groups cold": cg,
                     "groups warm": wg, "slots cold": cs, "slots warm": ws,
                     "estimate cold": est[0], "estimate warm": est[1]})
        warm_state[q] = (store, warm_plan, static)
    print(f"adaptive W=1 sums over the 22: {_sums_text(total)}", flush=True)
    used = {k for c in cold_launches.values() for k, v in c.items() if v}
    warm_used = {k for c in launches.values() for k, v in c.items() if v}
    if used - warm_used:
        fail(f"adaptive: the warm runs launched no {sorted(used - warm_used)}"
             f", which the cold runs launched")
    return results, launches, warm_state


def adaptive_w4(torch, catalog, results):
    """(b): each of the 22 planned for four workers (``ICIExchange``) on a
    store of its own, cold once, then warm three times (the counters read
    over the first): the cold plan fingerprint-equal to the static W = 4
    plan, the warm result equal to warm W = 1."""
    from repro_torch import ICIExchange
    from repro_torch.core import plan as P
    from repro_torch.core.feedback import FeedbackStore
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    launches, total = {}, {}
    for q in range(1, 23):
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          num_workers=_WORKERS, exchange=ICIExchange(),
                          feedback=FeedbackStore())
        raw = queries.build_query(q, catalog, optimized=False)
        cold_plan = session.optimize(raw)
        if P.fingerprint(cold_plan) != P.fingerprint(
                queries.build_query(q, catalog, num_workers=_WORKERS)):
            fail(f"adaptive Q{q} W={_WORKERS}: the cold plan is not the "
                 "static plan")
        _, cold_stats, _, cold_wall = _counted(torch, session, cold_plan)
        warm_plan = session.optimize(raw)
        warm, warm_stats, counts, t = _counted(torch, session, warm_plan)
        walls = [t] + [_wall(torch, session, warm_plan) for _ in range(2)]
        compare(q, warm, results[q][1], "its warm W=1 run")
        cg, cs, cj = plan_sizes(cold_plan)
        wg, ws, wj = plan_sizes(warm_plan)
        print(f"adaptive Q{q} W={_WORKERS} SF {_SF}: cold {cold_wall:.4f} s, "
              f"warm {_walls(walls)} s; max_groups {cg} -> {wg}, table "
              f"slots {cs} -> {ws}; joins changed "
              f"{json.dumps(joins_changed(cj, wj))}; kernel_dispatch cold "
              f"{json.dumps(cold_stats['kernel_dispatch'])} warm "
              f"{json.dumps(warm_stats['kernel_dispatch'])}; launches warm "
              f"{json.dumps(_nonzero(counts))}", flush=True)
        if (warm_stats["kernel_dispatch"].get("fallback_probe", 0)
                > cold_stats["kernel_dispatch"].get("fallback_probe", 0)):
            fail(f"adaptive Q{q} W={_WORKERS}: warm fallback_probe above "
                 "cold's")
        if capacity_rises(cold_plan, warm_plan):
            fail(f"adaptive Q{q} W={_WORKERS}: warm capacities above "
                 f"cold's: {capacity_rises(cold_plan, warm_plan)}")
        launches[q] = counts
        _add(total, {"cold": cold_wall, "warm": _median(walls),
                     "groups cold": cg, "groups warm": wg, "slots cold": cs,
                     "slots warm": ws})
    print(f"adaptive W={_WORKERS} sums over the 22: {_sums_text(total)}",
          flush=True)
    return launches


def adaptive_scheduler(torch, catalog, results):
    """(c): Q3 submitted three times on a ``feedback=True`` session with
    ``cache_results=False``: a plan-cache miss, a miss again (the cold
    entry evicted by the q-error check), then a hit; all three equal, and
    equal to (a)'s cold run."""
    from repro_torch import SchedulerConfig
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries

    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                      feedback=True,
                      scheduler_config=SchedulerConfig(cache_results=False))
    raw = queries.build_query(3, catalog, optimized=False)
    try:
        handles = []
        for _ in range(3):
            handles.append(session.submit(raw))
            handles[-1].result(timeout=600)
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    hits = [h.plan_cache_hit for h in handles]
    print(f"adaptive scheduler Q3 x3: plan cache hits {hits}, stats "
          f"{json.dumps({k: stats[k] for k in ('plan_cache_hits', 'plan_cache_misses', 'completed')})}, "
          f"store {json.dumps(session.executor_stats()['feedback'])}",
          flush=True)
    if hits != [False, False, True]:
        fail(f"adaptive scheduler Q3: plan cache hits {hits}, expected a "
             "miss, a miss after the eviction, then a hit")
    for h in handles:
        compare(3, h.result(), results[3][0], "(a)'s cold run")


def adaptive_spill(torch, catalog, results, warm_state):
    """(d): Q3's static plan and its warm plan (on (a)'s store) under the
    out-of-core phase's forced budget (``_FORCED_SHARE`` of the static
    plan's footprint), each through ``_spill_run``: the counters and walls
    side by side, both equal to (a)'s warm run."""
    from repro_torch.core.session import Session

    store, warm_plan, static = warm_state[3]
    budget = footprint_budget(catalog, static, share=_FORCED_SHARE)
    mem = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    calls = []
    for what, plan, fb in (("cold", static, None), ("warm", warm_plan, store)):
        session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                          device_budget=budget, feedback=fb)
        label = f"adaptive Q3 {what} W=1 at 1/{_FORCED_SHARE}"
        got, stats, counts, joins, wall, peaks = _spill_run(
            torch, session, mem, plan, calls, label)
        print(_spill_line(label, budget, stats["spill"], joins, wall, peaks,
                          counts), flush=True)
        compare(3, got, results[3][1], "(a)'s warm run")


def oracle_answers(data):
    """The port's oracle of the 22 on ``data``, in ``_ORACLE_PROCS``
    forked processes: q -> answer."""
    import multiprocessing

    global _ORACLE_DATA
    t0 = time.perf_counter()
    _ORACLE_DATA = data
    with multiprocessing.get_context("fork").Pool(_ORACLE_PROCS) as pool:
        answers = dict(pool.map(_oracle, range(1, 23)))
        pool.close()
        pool.join()
    _ORACLE_DATA = None
    print(f"oracle: the 22 in {time.perf_counter() - t0:.1f} s on "
          f"{_ORACLE_PROCS} processes", flush=True)
    return answers


def run_adaptive(torch, catalog, data):
    """The adaptive phase (a)-(d) on the SF 1 catalog at ``batch_rows =
    1 << 20``, then the oracle's 22 answers in ``_ORACLE_PROCS`` forked
    processes; each cold and warm W = 1 result held against them.
    Returns the oracle's answers."""
    t_phase = time.perf_counter()
    results, _, warm_state = adaptive_w1(torch, catalog)
    adaptive_w4(torch, catalog, results)
    adaptive_scheduler(torch, catalog, results)
    adaptive_spill(torch, catalog, results, warm_state)
    # the oracle after the timed runs, so that its processes take no core
    # from the driver's host thread while it is timed
    answers = oracle_answers(data)
    for q in range(1, 23):
        for what, got in zip(("cold", "warm"), results[q]):
            compare_oracle(q, got, answers[q], f"W=1 {what}")
    print(f"adaptive: the 22 cold and warm at W=1 equal the oracle; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return answers


# ---------------------------------------------------------------------------
# phase 8: serving -- the batched kernel, then the scheduler on the card
# ---------------------------------------------------------------------------

def small_query(QueryBuilder, col, catalog, keys, shape, j):
    """Query ``j`` of a serving shape, as
    ``benchmarks/bench_concurrency.py``'s ``_small_queries`` builds it, with
    a literal of its own for each ``j < 32``."""
    if shape == "point":
        return (QueryBuilder.scan(catalog, "orders")
                .filter(col("o_orderkey") == int(keys[(j * 37) % len(keys)]))
                .project("o_orderkey", "o_totalprice"))
    if shape == "global":
        return (QueryBuilder.scan(catalog, "lineitem")
                .filter(col("l_quantity") < float(2 + (j % 47)))
                .project(rev=col("l_extendedprice") * col("l_discount"))
                .agg(total=("sum", "rev"), n=("count", None)))
    return (QueryBuilder.scan(catalog, "lineitem")
            .filter(col("l_quantity") < float(3 + (j % 43)))
            .group_by("l_returnflag")
            .agg(total=("sum", "l_extendedprice"), n=("count", None)))


def _batch_ops(fused, program, lanes):
    """Register operations a row of a batch program: every lane runs each
    loop body once."""
    code = program.code.tolist()
    ops, pc = 0, 0
    while pc < len(code):
        op, _, a, _ = code[pc]
        if op == fused.OPS["LOOP"]:
            ops += a * lanes
            pc += a + 1
            continue
        ops += 1
        pc += 1
    return ops


def serving_morsel(catalog, data, shape, lanes):
    """The batch program of ``lanes`` serving queries of ``shape`` (query
    ``j`` of ``small_query``), the shapes, and the first morsel of its
    table on the card: (program, shapes, table). Fails unless the queries
    share one program."""
    from repro_torch.core import batch
    from repro_torch.core.builder import QueryBuilder
    from repro_torch.core.expr import col
    from repro_torch.core.table import TorchTable

    keys = data["orders"]["o_orderkey"]
    shapes = [batch.extract_shape(small_query(
        QueryBuilder, col, catalog, keys, shape, j).optimized())
        for j in range(lanes)]
    prog = shapes[0].program
    if any(s is None or s.program is not prog for s in shapes):
        fail(f"fused_batch_program[{shape}]: the queries do not share one "
             "batch program")
    src = data[prog.table]
    schema = catalog.get(prog.table).schema
    n_rows = min(len(src[prog.columns[0]]), _MAIN_ROWS)
    full = TorchTable.from_numpy(
        {c: src[c][:n_rows] for c in prog.columns},
        {c: schema[c] for c in prog.columns}, capacity=_MAIN_ROWS,
        device="cuda")
    return prog, shapes, full


def check_batch(torch, fused, catalog, data, rate):
    """fused_batch_program against apply_batched_stages on the card for the
    three serving programs: 32 lanes on the first morsel of the program's
    table, then n = 0, one lane, 64, 65 and 128 lanes and a morsel of
    999,999 rows; columns, validity and masks exact, and ceil(B / 64)
    launches (one a run of the kernel's 64-lane word). Then timed at 32
    lanes."""
    from repro_torch.core import batch
    from repro_torch.kernels import ops as kops

    rows_out, launchers = [], {}
    for shape in _SHAPES:
        prog, shapes, full = serving_morsel(catalog, data, shape, 128)
        odd, empty, shifted = (view(full, slice(0, 999_999)),
                               view(full, slice(0, 0)),
                               view(full, slice(1, None)))

        def run(table, lanes):
            params = batch._params(prog, shapes[:lanes], lanes, table.device)
            lowered = prog.lowered(table)
            kops.reset_launch_counts()
            got, masks = fused.fused_batch_program(
                table, prog.pre_stages, params, lanes, program=lowered)
            launched = kops.launch_counts()["fused_batch_program"]
            want, want_masks = fused.apply_batched_stages(
                table, prog.pre_stages, params, lanes)
            torch.cuda.synchronize()
            what = f"fused_batch_program[{shape}] n={table.capacity} " \
                   f"B={lanes}"
            if launched != (-(-lanes // 64) if table.capacity else 0):
                fail(f"{what}: {launched} launches")
            if not torch.equal(masks, want_masks):
                fail(f"{what}: masks differ from apply_batched_stages "
                     f"({int((masks != want_masks).sum())} bytes)")
            if got.validity is not table.validity:
                fail(f"{what}: the validity is not the input's")
            for c in want.column_names:
                a, b = got.columns[c], want.columns[c]
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"{what}: column {c} differs")
            return lowered, params, masks

        for table, lanes in ((empty, _LANES), (full, 1), (full, 64),
                             (full, 65), (full, 128), (odd, _LANES),
                             (shifted, _LANES)):
            run(table, lanes)
        lowered, params, masks = run(full, _LANES)
        live = float(masks.float().mean())
        print(f"check fused_batch_program[{shape}] rows={full.capacity} "
              f"lanes={_LANES}: {lowered.code.shape[0]} instructions, "
              f"{lowered.n_regs} registers, live share {live:.5f}, exact "
              f"(and n=0, B=1, B=64, B=65 and B=128 in 2 launches, "
              f"n=999999, offset 1)", flush=True)
        name = f"fused_batch_program[{shape}]"
        launchers[name] = (lambda t=full, p=params, lw=lowered, st=prog:
                           fused.fused_batch_program(
                               t, st.pre_stages, p, _LANES, program=lw))
        ms = time_ms(torch, launchers[name])
        plain_ms = time_ms(torch, lambda: fused.apply_batched_stages(
            full, prog.pre_stages, params, _LANES), reps=5)
        n = full.capacity
        stored = [d for d, a in zip(lowered.out_dtypes, lowered.out_alias)
                  if a is None]
        nbytes = n * (sum(full.columns[c].element_size()
                          for c in lowered.in_names) + 1
                      + sum(torch.tensor([], dtype=d).element_size()
                            for d in stored) + _LANES)
        b, by = bound_ms(nbytes, n * _batch_ops(fused, lowered, _LANES), rate)
        rows_out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_batch.cu",
            replaces="src/repro/core/fused.py:178", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None))
    return rows_out, launchers


def _percentile(values, p):
    values = sorted(values)
    return values[min(len(values) - 1, int(len(values) * p))]


def _check_threads_exited(what):
    """Fail if a scheduler worker or a scan's prefetch thread outlived
    ``close()``: no later phase (a profile above all) may share the card
    with one."""
    import threading

    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("query-sched-", "morsel-prefetch"))]
    if left:
        fail(f"{what}: threads alive after close(): {left}")


def _serve(torch, catalog, builders, batching, profile_dir=None, *,
           workers=1, mesh=None, budget=8 << 30, gather=False):
    """``builders`` (builders or plans) through a fresh card session's
    scheduler (``workers`` workers, on ``mesh`` when given) from
    ``_CLIENTS`` client threads, each submitting its share and then waiting
    for it (``session.gather`` with ``gather``); returns (results, handles,
    wall seconds, stats)."""
    import threading

    from repro_torch import SchedulerConfig, Session

    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS,
                      num_workers=workers, mesh=mesh)
    # the queue holds the whole workload: every client submits all of its
    # queries before it waits
    session.scheduler_config = SchedulerConfig(
        batching=batching, max_batch=32, max_concurrency=8,
        cache_results=False, batch_window_ms=10, memory_budget=budget,
        max_queue=len(builders))
    session.scheduler()
    handles = [None] * len(builders)
    errors = []

    def client(c):
        try:
            mine = range(c, len(builders), _CLIENTS)
            for i in mine:
                handles[i] = session.submit(builders[i])
            if gather:
                session.gather(*(handles[i] for i in mine))
            for i in mine:
                handles[i].result(timeout=600)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(_CLIENTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = session.scheduler().stats()
    session.scheduler().close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving (batching={batching}): {errors[:3]}")
    _check_threads_exited(f"serving (batching={batching})")
    return [h.result() for h in handles], handles, wall, stats


def run_serving(torch, catalog, data):
    """Phase 8 (b): the 96-query serving workload, batched, unbatched and
    as a serial execute loop on the card; returns the launch counts of the
    batched run and the workload's builders."""
    from repro_torch.core.builder import QueryBuilder
    from repro_torch.core.expr import col
    from repro_torch.core.session import Session
    from repro_torch.kernels import ops

    keys = data["orders"]["o_orderkey"]
    labels = [(_SHAPES[i % 3], i // 3) for i in range(_SERVING_QUERIES)]
    builders = [small_query(QueryBuilder, col, catalog, keys, shape, j)
                for shape, j in labels]
    plans = [b.optimized() for b in builders]
    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    for p in plans[:3]:                     # warm: allocator, streams
        gpu.execute(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [gpu.execute(p) for p in plans]
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0

    ops.reset_launch_counts()
    got, handles, wall, stats = _serve(torch, catalog, builders, True)
    counts = ops.launch_counts()
    for (shape, j), g, w in zip(labels, got, solo):
        compare(f"{shape}#{j}", g, w, "its solo run on the card")
    cpu = Session(catalog, device="cpu", batch_rows=_MAIN_ROWS)
    for k in range(6):                      # two of each shape
        compare(f"{labels[k][0]}#{labels[k][1]}", got[k],
                cpu.execute(plans[k]), "its CPU run")
    # members of one stacked launch share its driver's stats
    batches, shape_of = {}, {}
    for (shape, _), h in zip(labels, handles):
        if "batch" in h.executor_stats:
            batches[id(h.executor_stats["tables"])] = h.executor_stats
            shape_of[id(h.executor_stats["tables"])] = shape
    # stacked morsel steps of each program (one launch each, checked
    # against the kernel's own count below)
    by_shape = {shape: 0 for shape in _SHAPES}
    for k, es in batches.items():
        by_shape[shape_of[k]] += es["kernel_dispatch"].get("fused_batch", 0)
    steps = sum(by_shape.values())
    morsels = sum(t["morsels"] for es in batches.values()
                  for t in es["tables"].values())
    if stats["batches"] < 3 or stats["batch_fallbacks"]:
        fail(f"serving: {stats['batches']} batches, "
             f"{stats['batch_fallbacks']} fallbacks (want >= 3 and 0)")
    if len(batches) != stats["batches"] or steps != morsels:
        fail(f"serving: {len(batches)} batches in the handles against "
             f"{stats['batches']}; {steps} fused_batch dispatches against "
             f"{morsels} stacked morsel steps")
    if counts["fused_batch_program"] != steps or not all(by_shape.values()):
        fail(f"serving: {counts['fused_batch_program']} fused_batch_program "
             f"launches for {steps} stacked morsel steps {by_shape}")
    lat = [h.latency for h in handles]

    ops.reset_launch_counts()
    got_u, handles_u, wall_u, stats_u = _serve(torch, catalog, builders,
                                               False)
    if ops.launch_counts()["fused_batch_program"] or stats_u["batches"]:
        fail("serving without batching launched a stacked batch")
    for (shape, j), g, w in zip(labels, got_u, solo):
        compare(f"{shape}#{j}", g, w, "its solo run on the card")
    lat_u = [h.latency for h in handles_u]
    n = _SERVING_QUERIES
    print(f"serving SF {_SF}: {n} queries, {_CLIENTS} clients: batched "
          f"{wall:.4f} s ({n / wall:.1f} q/s), unbatched {wall_u:.4f} s "
          f"({n / wall_u:.1f} q/s), serial execute {serial_wall:.4f} s "
          f"({n / serial_wall:.1f} q/s)", flush=True)
    print(f"serving latency: batched p50 {_percentile(lat, 0.5):.4f} s p99 "
          f"{_percentile(lat, 0.99):.4f} s; unbatched p50 "
          f"{_percentile(lat_u, 0.5):.4f} s p99 "
          f"{_percentile(lat_u, 0.99):.4f} s", flush=True)
    print(f"serving batches: {stats['batches']} stacked launches of "
          f"{stats['batched_queries']} queries (mean size "
          f"{stats['batched_queries'] / stats['batches']:.2f}), "
          f"{steps} fused_batch_program launches ({json.dumps(by_shape)}), "
          f"launches { {k: v for k, v in counts.items() if v} }, stats "
          f"{json.dumps(stats)}", flush=True)
    return by_shape, builders, counts


def profile_serving(torch, catalog, builders, out_dir):
    """One profiled run of the serving workload with and one without
    batching: device busy time, idle share of the wall and device time by
    kernel (all threads; the profiler lengthens the wall)."""
    os.makedirs(out_dir, exist_ok=True)
    for batching in (True, False):
        for attempt in range(_PROFILE_ATTEMPTS):  # as in profile_kernels
            prof, (_, _, wall, stats) = _profiled(
                torch, lambda: _serve(torch, catalog, builders, batching),
                cpu=True)
            rows = _device_events(prof)
            if rows:
                break
            print(f"profile of serving: no device events in attempt "
                  f"{attempt + 1}", flush=True)
        if not rows:
            fail("profile of serving: no device events")
        busy_us = sum(r[2] for r in rows)
        kernels = [r for r in rows if not r[0].startswith("Mem")]
        summary = {"batching": batching, "queries": len(builders),
                   "wall_s": wall, "device_busy_us": busy_us,
                   "idle_share": 1.0 - busy_us / (wall * 1e6),
                   "kernel_launches": sum(r[1] for r in kernels),
                   "batches": stats["batches"], "by_kernel": rows,
                   "host_top": _host_events(prof)}
        tag = "batched" if batching else "unbatched"
        with open(os.path.join(out_dir, f"profile_serving_{tag}.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps({"profile_serving": dict(
            summary, by_kernel=rows[:8], host_top=summary["host_top"][:8])}),
            flush=True)


def run_dashboard(torch, catalog, w1_results):
    """Phase 8 (c): four clients submit the dashboard twice each through
    the scheduler without batching; every result equals its phase 5
    result, and every repeat comes from the result cache or coalesces."""
    import threading

    from repro_torch import SchedulerConfig, Session
    from repro_torch.tpch import queries

    session = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    session.scheduler_config = SchedulerConfig(memory_budget=8 << 30,
                                               max_concurrency=8)
    out, errors = [], []

    def client():
        try:
            handles = []
            for _ in range(2):
                for i, q in enumerate(_DASHBOARD):
                    plan = queries.build_query(q, catalog, optimized=False)
                    handles.append(
                        (q, session.submit(plan,
                                           priority=len(_DASHBOARD) - i)))
            out.extend((q, h, h.result(timeout=600)) for q, h in handles)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=client) for _ in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    stats = session.scheduler().stats()
    session.scheduler().close()
    if errors or len(out) != 8 * len(_DASHBOARD):
        fail(f"dashboard: {errors[:3]}")
    _check_threads_exited("dashboard")
    for q, _, res in out:
        compare(q, res, w1_results[q], "its phase 5 run")
    repeats = len(out) - len(_DASHBOARD)
    served = stats["result_cache_hits"] + stats["coalesced"]
    if served != repeats or stats["failed"]:
        fail(f"dashboard: {served} repeats from the cache or coalesced of "
             f"{repeats}; stats {stats}")
    print(f"dashboard SF {_SF}: {len(out)} queries from 4 clients in "
          f"{wall:.4f} s, footprints "
          f"{ {q: h.footprint for q, h, _ in out if not h.cache_hit} }, "
          f"stats {json.dumps(stats)}", flush=True)


# ---------------------------------------------------------------------------
# phase 9: flash attention at qwen2-1.5B's attention width
# ---------------------------------------------------------------------------

def _attn_inputs(torch, shape, dtype, seed, shift=0.0):
    """q, k, v of ``shape`` drawn with numpy from ``seed``, on the card;
    q's entries around ``shift``, k's around ``-shift``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             + centre)
            .to("cuda", getattr(torch, dtype)) for centre in (shift, -shift,
                                                              0.0)]


def _attn_errs(fa, got, q, k, v, causal, heads=None):
    """(max |kernel - plain|, ``scaled_error``) over all heads, or over
    ``heads`` one at a time (the plain version of a 32k head holds 4.3 GB of
    scores)."""
    err = scaled = 0.0
    for sl in ([slice(None)] if heads is None else
               [slice(h, h + 1) for h in heads]):
        want = fa.flash_attention_plain(q[:, sl], k[:, sl], v[:, sl], causal)
        err = max(err, float((got[:, sl].float() - want.float()).abs().max()))
        scaled = max(scaled, fa.scaled_error(got[:, sl], want, v[:, sl],
                                             causal))
    return err, scaled


def _attn_verdict(fa, what, err, scaled, tol, failures):
    """Holds one case's readings to both limits: ``tol`` on max |kernel -
    plain| and ``SCALED_ERROR_TOL`` on ``scaled_error``, which a fixed
    absolute limit cannot replace (PERF.md). A miss goes into
    ``failures``."""
    if not err <= tol:
        failures.append(f"{what}: max |kernel - plain| {err:.3g} > {tol}")
    if not scaled <= fa.SCALED_ERROR_TOL:
        failures.append(f"{what}: scaled error {scaled:.3g} > "
                        f"{fa.SCALED_ERROR_TOL}")


def check_attention_edges(torch, fa, kops, failures):
    """Edge cases of the attention kernel against its plain version, one
    launch a call: S = 128 with blocks (64, 128); D = 40 and D = 1 (no
    16-byte rows); B * H = 1 and 96; S = 96 and S = 1 (rows that fill no
    tile); and what the wrapper refuses with no launch: S that does not
    divide by blocks given, D = 257."""
    cases = [((1, 2, 128, 64), True, dict(block_q=64, block_k=128)),
             ((1, 2, 256, 40), True, {}), ((1, 2, 256, 1), False, {}),
             ((1, 1, 256, 64), True, {}), ((8, 12, 256, 64), True, {}),
             ((1, 2, 96, 64), True, dict(block_q=32, block_k=32)),
             ((1, 3, 1, 64), False, {})]
    worst = {}
    for i, (shape, causal, blocks) in enumerate(cases):
        for dtype, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            q, k, v = _attn_inputs(torch, shape, dtype, 100 + i)
            kops.reset_launch_counts()
            got = fa.flash_attention(q, k, v, causal=causal, **blocks)
            torch.cuda.synchronize()
            launched = kops.launch_counts()["flash_attention"]
            err, scaled = _attn_errs(fa, got, q, k, v, causal)
            what = f"flash_attention {list(shape)} {dtype} causal={causal}"
            if launched != 1:
                failures.append(f"{what}: {launched} launches")
            _attn_verdict(fa, what, err, scaled, tol, failures)
            old = worst.get(dtype, (0.0, 0.0))
            worst[dtype] = (max(old[0], err), max(old[1], scaled))
    kops.reset_launch_counts()
    for shape, blocks, want in (((1, 1, 192, 64), dict(block_k=128),
                                 "S 192, block_k 128"),
                                ((1, 1, 256, 64), dict(block_q=96),
                                 "S 256, block_q 96"),
                                ((1, 1, 128, 257), {}, "D 257")):
        q = torch.zeros(shape, device="cuda")
        try:
            fa.flash_attention(q, q, q, **blocks)
        except ValueError:
            continue
        failures.append(f"flash_attention: {want} was not refused")
    if kops.launch_counts()["flash_attention"]:
        failures.append("flash_attention: a refused call launched")
    print(f"check flash_attention edges: {len(cases)} shapes, one launch "
          "each; worst (max |kernel - plain|, scaled error): " + ", ".join(
              f"{dt} ({e:.3g}, {sc:.3g})" for dt, (e, sc) in worst.items())
          + "; S 192 with block_k 128, S 256 with block_q 96 and D 257 "
          "refused", flush=True)


def run_attention(torch, fa, kops, rate, name):
    """Phase 9: ``ops.flash_attention`` at qwen2-1.5B's attention width
    (12 heads of 128; K and V at 12 heads, as a GQA caller passes them
    once it has expanded its 2 KV heads), seamless' encoder width and the
    head dims 160 and 192. Each case is driven once through the entry point
    with the launch counters set to 0 just before and read just after (one
    launch of the kernel and nothing else), then held against the plain
    version, then one profiled call names the kernels it ran
    (``_ATTN_CASES``' last field), then the kernel, the plain version and
    ``scaled_dot_product_attention`` (``library_ms``, a yardstick the port
    never calls) are timed. TF32 is off for the whole phase, edge cases
    included, and set back after it. Every case is checked and printed
    before the phase fails on any miss."""
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        failures = []
        check_attention_edges(torch, fa, kops, failures)
        rows_out, launchers = _attention_cases(torch, fa, kops, rate, name,
                                               failures)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    if failures:
        fail("; ".join(failures))
    return rows_out, launchers


def _attention_cases(torch, fa, kops, rate, name, failures):
    """``_ATTN_CASES`` for ``run_attention``: (rows of the kernels line,
    the timed launchers)."""
    import torch.nn.functional as F
    rows_out, launchers = [], {}
    for i, (case, shape, dtype, causal, tol, kernels) in enumerate(
            _ATTN_CASES):
        q, k, v = _attn_inputs(torch, shape, dtype, _ATTN_SEED + i,
                               _RAGGED_SHIFT if shape[2] % 128 else 0.0)
        row = f"flash_attention[{case}]"
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        got = kops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        if counts["flash_attention"] != 1 or sum(counts.values()) != 1:
            failures.append(f"{row}: launches {counts}, want one "
                            "flash_attention")
        if got.shape != q.shape or got.dtype != q.dtype or \
                not bool(torch.isfinite(got).all()):
            fail(f"{row}: {got.dtype}{tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        heads = (0, shape[1] - 1) if shape[2] > 8192 else None
        err, scaled = _attn_errs(fa, got, q, k, v, causal, heads)
        _attn_verdict(fa, row, err, scaled, tol, failures)
        del got
        big = heads is not None
        launchers[row] = (lambda q=q, k=k, v=v, c=causal:
                          fa.flash_attention(q, k, v, causal=c))
        ran = _kernels_seen(torch, launchers[row], _ATTN_KERNELS)
        if tuple(ran) != kernels:
            failures.append(f"{row}: ran {ran}, want {list(kernels)}")
        ms = time_ms(torch, launchers[row], reps=5 if big else 20)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal), reps=2 if big else 5, warm=1)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), reps=5 if big else 20)
        b, h, s, d = shape
        elt = q.element_size()
        flops = 4 * b * h * s * s * d / (2 if causal else 1)
        nbytes = 4 * b * h * s * d * elt
        extra = {}
        if dtype == "float32":
            # three TF32 products a float32 one; the FFMA bound beside it,
            # the yardstick of the kernel it replaced
            bound, by = bound_ms(nbytes, 3 * flops, rate,
                                 card_rates(name).tf32)
            extra["bound_ffma_ms"] = bound_ms(nbytes, flops, rate)[0]
            if not bound <= ms:
                failures.append(f"{row}: {ms:.4f} ms is below its bound "
                                f"{bound:.4f} ms")
        else:
            bound, by = bound_ms(nbytes, flops, rate,
                                 card_rates(name).bf16)
        rows_out.append(dict(
            name=row, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:71",
            launches=counts["flash_attention"], max_abs_err=err,
            scaled_err=scaled, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=library_ms, kernels=ran, **extra))
        over = f"heads {heads}" if heads else "all heads"
        ffma = (f", FFMA bound {extra['bound_ffma_ms']:.4f} ms"
                if extra else "")
        print(f"check {row} {list(shape)} causal={causal}: max |kernel - "
              f"plain| {err:.3g} (tol {tol}), scaled error {scaled:.3g} "
              f"(tol {fa.SCALED_ERROR_TOL}) over {over}, {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms ({by})"
              f"{ffma}, kernels {ran}", flush=True)
    return rows_out, launchers


def _kernels_seen(torch, fn, names):
    """The kernels of ``names`` that one call of ``fn`` ran on the card,
    sorted, from ``torch.profiler``. Every call of ``fn`` runs one of
    ``names``, so a profile in which none shows has lost the call's
    events; it is taken again, at most ``_PROFILE_ATTEMPTS`` times in all,
    and each such profile's device events are printed."""
    fn()
    torch.cuda.synchronize()
    ran = []
    for attempt in range(_PROFILE_ATTEMPTS):
        prof, _ = _profiled(torch, fn)
        events = _device_events(prof)
        ran = sorted(n for n in names if any(n in r[0] for r in events))
        if ran:
            break
        print(f"profile: none of {list(names)} in attempt {attempt + 1}; "
              f"all device events {[(r[0][:60], r[1]) for r in events]}",
              flush=True)
    return ran


# ---------------------------------------------------------------------------
# phase 9b: the LM side, qwen2-1.5B's dense serving path
# ---------------------------------------------------------------------------

def _lm_batch(torch, cfg, b, s, seed, device):
    """B prompts of ``s`` tokens drawn with numpy from ``seed`` (patch
    embeddings for a frontend-stub config), on ``device``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.embed_frontend_stub:
        e = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
        return {"embeds": torch.from_numpy(e).to(device, torch.bfloat16)}
    tok = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return {"tokens": torch.from_numpy(tok).to(device)}


def _lm_model(torch, mods, cfg, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return mods.build_model(cfg, device=device, generator=gen)


def _cpu_and_card(torch, mods, cfg, seed):
    """One set of weights made on the CPU, and its copy on the card."""
    import copy
    cpu = _lm_model(torch, mods, cfg, "cpu", seed)
    return cpu, copy.deepcopy(cpu).to("cuda")


def _lm_serve(torch, model, batch, max_len, steps, feed=None):
    """Prefill then ``steps`` decode steps, each fed the greedy token of
    the step before (or ``feed[:, t]``): (the prefill's and each step's
    logits [B, 1, V], the tokens fed [B, steps], the caches after the
    prefill (copies of each ``KVCache`` or ``MambaState``), the prefill's
    seconds, the decode's seconds). The
    clocks are the host's around work that ends in a synchronize."""
    s = next(iter(batch.values())).shape[1]
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, max_len)
    sync()
    t_prefill = time.perf_counter() - t0
    first = [type(c)(*(t.clone() for t in c)) for c in caches]
    outs, fed = [logits], []
    t0 = time.perf_counter()
    for t in range(steps):
        tok = (logits[:, -1].argmax(-1).to(torch.int32) if feed is None
               else feed[:, t])
        fed.append(tok)
        logits, caches = model.decode_step(tok[:, None], caches, s + t)
        outs.append(logits)
    sync()
    t_decode = time.perf_counter() - t0
    return outs, torch.stack(fed, dim=1), first, t_prefill, t_decode


def _lm_diff(torch, got, want, tol):
    """(max |got - want|, the largest ratio of |got - want| to atol + rtol *
    |want|) of two logits tensors, as float32; a NaN reads as inf."""
    atol, rtol = tol
    d = (got.float() - want.float()).abs().nan_to_num(nan=math.inf)
    return float(d.max()), float((d / (atol + rtol * want.float().abs()))
                                 .nan_to_num(nan=math.inf).max())


def _lm_greedy_misses(torch, got, want, tol) -> int:
    """Rows whose greedy token differs although ``want``'s top two logits
    are further apart than the tolerance at the top logit."""
    atol, rtol = tol
    top2 = want.float().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > atol + rtol * top2[..., 0].abs()
    return int(((got.argmax(-1) != want.argmax(-1)) & sure).sum())


def _logits_diff(torch, got, want, tol):
    """(max |diff|, its largest ratio to ``tol`` by ``_lm_diff``, greedy
    misses) over pairs of logits tensors, each compared on ``want``'s
    device."""
    err = ratio = 0.0
    misses = 0
    for g, w in zip(got, want):
        g = g.to(w.device)
        e, r = _lm_diff(torch, g, w, tol)
        err, ratio = max(err, e), max(ratio, r)
        misses += _lm_greedy_misses(torch, g, w, tol)
    return err, ratio, misses


def _rows_ratio(torch, pairs, tol) -> float:
    """The largest |got - want| over ``atol + rtol`` times its row's
    largest |want| (the last axis), over (got, want) pairs of cache
    tensors, on ``want``'s device."""
    atol, rtol = tol
    worst = 0.0
    for g, w in pairs:
        w = w.float()
        row = w.abs().amax(-1, keepdim=True)
        d = (g.to(w.device).float() - w).abs()
        worst = max(worst, float((d / (atol + rtol * row)).max()))
    return worst


def _lm_against_forward(torch, model, batch, outs, fed, tol, what, failures):
    """(b): ``forward`` over the prompt and the fed tokens; the prefill's
    logits against its position S - 1 and step t's against S + t. A
    frontend-stub prompt (embeddings) checks the prefill alone."""
    with torch.inference_mode():
        if "tokens" in batch:
            seq = torch.cat([batch["tokens"], fed], dim=1)
            logits, _ = model.forward({"tokens": seq})
        else:
            logits, _ = model.forward(batch)
            outs = outs[:1]
    s = next(iter(batch.values())).shape[1]
    err, ratio, misses = _logits_diff(torch, outs, [
        logits[:, s - 1 + t:s + t] for t in range(len(outs))], tol)
    if not ratio <= 1.0:
        failures.append(f"{what}: against forward max |diff| {err:.4g}, "
                        f"{ratio:.3g} of the tolerance {tol}")
    if misses:
        failures.append(f"{what}: {misses} greedy tokens differ from "
                        "forward's beyond the tolerance")
    print(f"check {what} against forward over {len(outs)} positions: max "
          f"|diff| {err:.4g}, {ratio:.3g} of the tolerance "
          f"(atol, rtol) {tol}, greedy misses {misses}", flush=True)


def _lm_finite(torch, outs, what, failures):
    bad = sum(int((~torch.isfinite(o.float())).sum()) for o in outs)
    if bad:
        failures.append(f"{what}: {bad} non-finite logits")


def _host_syncs(torch, fn):
    """What torch's sync debug mode reports for a call of ``fn``: the
    messages of the host syncs it makes (none expected)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message)[:120] for w in caught
            if "called a synchronizing" in str(w.message)]


def _lm_host_syncs(torch, model, batch, max_len):
    """``_host_syncs`` of one prefill and one decode step."""
    s = next(iter(batch.values())).shape[1]

    def prefill_and_step():
        logits, caches = model.prefill(batch, max_len)
        model.decode_step(logits[:, -1].argmax(-1).to(torch.int32)[:, None],
                          caches, s)
    return _host_syncs(torch, prefill_and_step)


class _Capture:
    """Wraps ``ops.flash_attention`` while it is entered: counts the model's
    calls and keeps the first call's q, k and v (references only)."""

    def __init__(self, kops):
        self.kops, self.first, self.calls = kops, None, 0

    def __enter__(self):
        real = self.real = self.kops.flash_attention

        def wrapped(q, k, v, *a, **kw):
            self.calls += 1
            if self.first is None:
                self.first = (q, k, v)
            return real(q, k, v, *a, **kw)
        self.kops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.kops.flash_attention = self.real


def lm_qwen2(torch, mods, cfgs, kops, failures):
    """(a), (b) and the capture of (d) at qwen2-1.5B's full CONFIG: (the
    first attention call's q, k and v, contiguous; the prefill's
    launches)."""
    cfg = cfgs.get_config(_LM_ARCH)
    model = _lm_model(torch, mods, cfg, "cuda", _LM_SEED)
    batch = _lm_batch(torch, cfg, _LM_BATCH, _LM_PROMPT, _LM_SEED, "cuda")
    _lm_serve(torch, model, batch, _LM_MAX_LEN, 2)    # warm-up
    syncs = _lm_host_syncs(torch, model, batch, _LM_MAX_LEN)
    if syncs:
        failures.append(f"lm {_LM_ARCH}: {len(syncs)} host syncs in a "
                        f"prefill and a decode step: {syncs[:3]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    with _Capture(kops) as cap:
        outs, fed, _, t_prefill, t_decode = _lm_serve(
            torch, model, batch, _LM_MAX_LEN, _LM_STEPS)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    what = f"lm {_LM_ARCH}"
    if counts["flash_attention"] != cfg.n_layers or \
            sum(counts.values()) != cfg.n_layers or cap.calls != cfg.n_layers:
        failures.append(f"{what}: launches {counts}, {cap.calls} calls; "
                        f"want {cfg.n_layers} flash_attention a prefill")
    _lm_finite(torch, outs, what, failures)
    n_tok = _LM_BATCH * _LM_STEPS
    print(f"lm {_LM_ARCH} (a): {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, "
          f"{sum(p.numel() for p in model.parameters())} parameters; "
          f"prefill {_LM_BATCH}x{_LM_PROMPT} tokens in "
          f"{t_prefill * 1e3:.3f} ms "
          f"({_LM_BATCH * _LM_PROMPT / t_prefill:.1f} tokens/s), "
          f"{_LM_STEPS} decode steps at {t_decode / _LM_STEPS * 1e3:.3f} ms "
          f"a step ({n_tok / t_decode:.1f} tokens/s), max_memory_allocated "
          f"{peak / 1e9:.3f} GB, launches {dict(_nonzero(counts))}; "
          f"{card_line()}", flush=True)
    _lm_against_forward(torch, model, batch, outs, fed, _LM_TOL,
                        f"{what} (b) decode", failures)
    qkv = tuple(t.contiguous() for t in cap.first)
    del model, outs, cap
    torch.cuda.empty_cache()
    return qkv, counts["flash_attention"]


def lm_against_cpu(torch, mods, cfgs, failures):
    """(c): full width, 2 layers, one set of weights made on the CPU."""
    import dataclasses
    cfg = dataclasses.replace(cfgs.get_config(_LM_ARCH), n_layers=2)
    cpu, gpu = _cpu_and_card(torch, mods, cfg, _LM_SEED)
    for s in _LM_CPU_PROMPTS:
        what = f"lm {_LM_ARCH} 2 layers S {s} (c) card vs CPU"
        batch = _lm_batch(torch, cfg, 2, s, _LM_SEED + s, "cpu")
        want, fed, want_c, _, _ = _lm_serve(torch, cpu, batch, s + 8, 8)
        got, _, got_c, _, _ = _lm_serve(
            torch, gpu, {k: x.cuda() for k, x in batch.items()}, s + 8, 8,
            feed=fed.cuda())
        err, ratio, misses = _logits_diff(torch, got, want, _LM_CPU_TOL)
        cache = _rows_ratio(torch, [p for gc, wc in zip(got_c, want_c)
                                    for p in ((gc.k, wc.k), (gc.v, wc.v))],
                            _LM_CPU_TOL)
        _lm_finite(torch, got, what, failures)
        if not (ratio <= 1.0 and cache <= 1.0) or misses:
            failures.append(f"{what}: logits max |diff| {err:.4g} "
                            f"({ratio:.3g} of the tolerance), caches "
                            f"{cache:.3g} of it, greedy misses {misses}")
        print(f"check {what}: prefill and 8 decode steps, logits max |diff| "
              f"{err:.4g} ({ratio:.3g} of (atol, rtol) {_LM_CPU_TOL}), K/V "
              f"caches {cache:.3g} of it by row, greedy misses {misses}",
              flush=True)
    del gpu
    torch.cuda.empty_cache()


def lm_others(torch, mods, cfgs, kops, failures):
    """(e): the other dense CONFIGs at full width and 2 layers."""
    import dataclasses
    for arch in _LM_OTHERS:
        cfg = dataclasses.replace(cfgs.get_config(arch), n_layers=2)
        model = _lm_model(torch, mods, cfg, "cuda", _LM_SEED)
        batch = _lm_batch(torch, cfg, 2, _LM_PROMPT, _LM_SEED, "cuda")
        _lm_serve(torch, model, batch, _LM_PROMPT + 4, 1)    # warm-up
        kops.reset_launch_counts()
        outs, fed, _, t_prefill, t_decode = _lm_serve(
            torch, model, batch, _LM_PROMPT + 4, 4)
        counts = kops.launch_counts()
        what = f"lm {arch} 2 layers (e)"
        if counts["flash_attention"] != 2 or sum(counts.values()) != 2:
            failures.append(f"{what}: launches {counts}, want 2 "
                            "flash_attention")
        _lm_finite(torch, outs, what, failures)
        print(f"lm {arch} (e): d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv} of {cfg.head_dim}, vocab {cfg.vocab}, "
              f"{'GeLU' if cfg.mlp_gelu else 'SwiGLU'}, prompt "
              f"{next(iter(batch))}; prefill 2x{_LM_PROMPT} in "
              f"{t_prefill * 1e3:.3f} ms, decode {t_decode / 4 * 1e3:.3f} ms "
              f"a step, launches {dict(_nonzero(counts))}", flush=True)
        _lm_against_forward(torch, model, batch, outs, fed, _LM_TOL,
                            f"{what} decode", failures)
        del model, outs
        torch.cuda.empty_cache()


def lm_attention_row(torch, fa, qkv, launches, rate, name, failures,
                     arch=_LM_ARCH, causal=True, part="prefill"):
    """(d): the captured call against the plain version, timed: the
    kernels line's ``flash_attention[lm <arch> <part>]`` row."""
    import torch.nn.functional as F
    q, k, v = qkv
    row = f"flash_attention[lm {arch} {part}]"
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    scaled = fa.scaled_error(got, want, v, causal)
    if not scaled <= fa.SCALED_ERROR_TOL:
        failures.append(f"{row}: scaled error {scaled:.3g} > "
                        f"{fa.SCALED_ERROR_TOL}")
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), reps=5, warm=1)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    b, h, s, d = q.shape
    flops = 4 * b * h * s * s * d / (2 if causal else 1)
    nbytes = 4 * b * h * s * d * q.element_size()
    bound, by = bound_ms(nbytes, flops, rate, card_rates(name).bf16)
    print(f"check {row} {list(q.shape)} {str(q.dtype)[6:]} "
          f"{'causal' if causal else 'full'}: max "
          f"|kernel - plain| {err:.3g}, scaled error {scaled:.3g} (tol "
          f"{fa.SCALED_ERROR_TOL}), {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}), launches {launches} in (a)'s "
          "prefill", flush=True)
    return dict(name=row, route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:71",
                launches=launches, max_abs_err=err, scaled_err=scaled, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def run_lm(torch, fa, kops, rate, name):
    """Phase 9b: the LM side's dense serving path; (rows of the kernels
    line). Every part is checked and printed before the phase fails."""
    cfgs = importlib.import_module("repro_torch.configs")
    mods = importlib.import_module("repro_torch.models")
    t0 = time.perf_counter()
    failures = []
    qkv, launches = lm_qwen2(torch, mods, cfgs, kops, failures)
    lm_against_cpu(torch, mods, cfgs, failures)
    row = lm_attention_row(torch, fa, qkv, launches, rate, name, failures)
    del qkv
    lm_others(torch, mods, cfgs, kops, failures)
    torch.cuda.empty_cache()
    print(f"phase 9b (LM): {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        fail("; ".join(failures))
    return [row]


# ---------------------------------------------------------------------------
# phase 9c: training, qwen2-1.5B at full width taking AdamW steps
# ---------------------------------------------------------------------------

def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_corpus(torch, fused, kops, vocab, device):
    """(a)'s corpus: a table of ``_TRAIN_ROWS`` synthetic tokens (``doc``,
    ``tok`` skewed towards small ids as tests/test_system.py's, ``quality``)
    registered with the port's ``Session`` on ``device`` and filtered by
    ``quality > _TRAIN_QUALITY`` through ``Session.execute``, with the first
    ``fused_morsel_program`` call's inputs kept (cloned) -> (the tokens,
    that call, the launch counts, the seconds)."""
    import numpy as np
    from repro_torch.core import dtypes as dt
    from repro_torch.core import plan as P
    from repro_torch.core.expr import col
    from repro_torch.core.session import Catalog, Session
    rng = np.random.default_rng(_TRAIN_SEED)
    n = _TRAIN_ROWS
    corpus = {"doc": np.arange(n, dtype=np.int32) // 64,
              "tok": (rng.random(n) ** 4 * vocab).astype(np.int32),
              "quality": rng.random(n, dtype=np.float32)}
    catalog = Catalog()
    catalog.register_numpy("corpus", corpus, {
        "doc": dt.INT32, "tok": dt.INT32, "quality": dt.FLOAT32})
    plan = P.Project(P.Filter(P.TableScan("corpus"),
                              col("quality") > _TRAIN_QUALITY),
                     [("tok", col("tok"))])
    session = Session(catalog, device=device, batch_rows=_MAIN_ROWS)
    kept = []
    real = fused.fused_morsel_program

    def keep_first(table, stages, probe=None, program=None):
        if not kept:
            kept.append((type(table)(
                {c: a.clone() for c, a in table.columns.items()},
                table.validity.clone(), table.schema), stages, program))
        return real(table, stages, probe=probe, program=program)

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    fused.fused_morsel_program = keep_first
    try:
        tokens = session.execute(plan)["tok"]
    finally:
        fused.fused_morsel_program = real
    secs = time.perf_counter() - t0
    counts = kops.launch_counts()
    want = corpus["tok"][corpus["quality"] > np.float32(_TRAIN_QUALITY)]
    if not np.array_equal(tokens, want):
        fail(f"train (a): the corpus query's {len(tokens)} tokens differ "
             f"from numpy's filter ({len(want)})")
    return tokens, kept[0], counts, secs


def train_memory_prediction(n_params: int, weight_bytes: int) -> str:
    """(a)'s memory, reckoned from the parameters before the run: between
    steps the model's own weights, the state's weights and float32 m and v;
    in a step also the float32 gradient sums, one microbatch's bfloat16
    gradients, the new weights and new m and v (the step is functional:
    the old state lives until it returns) and the activations."""
    gb = 1e9
    f32 = 4 * n_params
    return (f"train (a) memory reckoned before the run: weights "
            f"{weight_bytes / gb:.2f} GB (the model's and the state's, "
            f"{2 * weight_bytes / gb:.2f}), float32 m and v "
            f"{2 * f32 / gb:.2f} GB, float32 gradient sums {f32 / gb:.2f} GB,"
            f" one microbatch's bfloat16 gradients {weight_bytes / gb:.2f} GB;"
            f" between steps {(2 * weight_bytes + 2 * f32) / gb:.2f} GB; in "
            f"the update also new m, v and weights "
            f"{(2 * f32 + weight_bytes) / gb:.2f} GB and the group "
            f"temporaries, activations on top in the backward")


def train_full(torch, fused, kops, cfg, device, failures):
    """(a): the corpus filtered on the card, then ``_TRAIN_STEPS`` timed
    steps of ``make_train_step(model, microbatches=_TRAIN_MICRO)`` on
    ``TokenPipeline(device=...)`` batches after one warm-up step and one
    step under torch's sync debug mode; the launch counters set to 0 just
    before the query and read after the last step -> (the kept fused call,
    the counts)."""
    import warnings
    mods = importlib.import_module("repro_torch.models")
    from repro_torch.data import TokenPipeline
    from repro_torch.train import make_train_step, optimizer, train_state_init
    tokens, call, counts_query, q_secs = train_corpus(torch, fused, kops,
                                                      cfg.vocab, device)
    print(f"train (a) corpus: {_TRAIN_ROWS} rows filtered by quality > "
          f"{_TRAIN_QUALITY} on {device} in {q_secs:.3f} s: {len(tokens)} "
          f"tokens, equal to numpy's filter; launches "
          f"{dict(_nonzero(counts_query))}", flush=True)
    model = _lm_model(torch, mods, cfg, device, _TRAIN_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(train_memory_prediction(n_params, weight_bytes), flush=True)
    pipe = TokenPipeline(tokens, _TRAIN_B, _TRAIN_S, device=device,
                         prefetch=_TRAIN_PREFETCH, seed=_TRAIN_SEED)
    step = make_train_step(model, microbatches=_TRAIN_MICRO)
    state, _ = step(train_state_init(model), next(pipe))     # warm-up
    batch = next(pipe)
    _sync(torch, device)
    syncs = []
    if device.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, _ = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message)[:120] for w in caught
                 if "called a synchronizing" in str(w.message)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    else:
        state, _ = step(state, batch)
    if syncs:
        failures.append(f"train (a): {len(syncs)} host syncs in a step: "
                        f"{syncs[:3]}")
    metrics = []
    t0 = time.perf_counter()
    for _ in range(_TRAIN_STEPS):
        state, m = step(state, next(pipe))
        metrics.append(m)
    _sync(torch, device)
    secs = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    # the update alone, on float32 gradients of the sums' shapes
    update_s = []
    for _ in range(2):
        t1 = time.perf_counter()
        optimizer.adamw_update(state.params, state.opt.m, state.opt)
        _sync(torch, device)
        update_s.append(time.perf_counter() - t1)
    rows = torch.stack([torch.stack([m["loss"], m["lr"], m["grad_norm"]])
                        for m in metrics]).tolist()
    if not all(math.isfinite(x) for r in rows for x in (r[0], r[2])):
        failures.append(f"train (a): a loss or grad_norm is not finite: "
                        f"{rows}")
    if counts["fused_morsel_program"] < 1:
        failures.append(f"train (a): fused_morsel_program did not run: "
                        f"{counts}")
    n_tok = _TRAIN_B * _TRAIN_S * _TRAIN_STEPS
    print(f"train (a) {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters; "
          f"{_TRAIN_STEPS} steps of {_TRAIN_B}x{_TRAIN_S} tokens in "
          f"{_TRAIN_MICRO} microbatches, {secs / _TRAIN_STEPS * 1e3:.3f} ms "
          f"a step, {n_tok / secs:.1f} tokens/s, max_memory_allocated "
          f"{peak / 1e9:.3f} GB, host syncs in a step {len(syncs)}, "
          f"launches {dict(_nonzero(counts))}; adamw_update alone "
          f"{min(update_s) * 1e3:.3f} ms (host clock, synchronized); "
          f"{card_line()}", flush=True)
    for i, (loss, lr, gnorm) in enumerate(rows):
        print(f"train (a) step {i + 2}: loss {loss:.6f} lr {lr:.6g} "
              f"grad_norm {gnorm:.6f}", flush=True)
    del model, state, metrics, pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return call, counts["fused_morsel_program"]


def train_fused_row(torch, fused, call, launches, rate):
    """(a)'s kept ``fused_morsel_program`` call against ``apply_stages``
    (bit-identical), timed: the ``fused_morsel_program[train corpus]`` row
    of the kernels line, its launches those of (a)."""
    table, stages, program = call
    got = _check_fused_case(torch, fused, table, stages, program,
                            "fused_morsel_program[train corpus]")
    ms = time_ms(torch, lambda: fused.fused_morsel_program(
        table, stages, program=program))
    plain_ms = time_ms(torch, lambda: fused.apply_stages(table, stages))
    n = table.capacity
    nbytes = n * (sum(table.columns[c].element_size()
                      for c in program.in_names) + 1
                  + sum(got.columns[c].element_size()
                        for c in program.out_names) + 1)
    alu = sum(1 for op in program.code[:, 0].tolist()
              if op >= fused.OPS["FILTER"])
    bound, by = bound_ms(nbytes, n * alu, rate)
    print(f"check fused_morsel_program[train corpus] rows={n}: "
          f"bit-identical to apply_stages, {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}), launches {launches} in (a)",
          flush=True)
    return dict(name="fused_morsel_program[train corpus]", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_morsel.cu",
                replaces="src/repro/core/fused.py:78", launches=launches,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _mid_training_state(torch, model, seed, draw_on):
    """The model's weights and an AdamW state at ``_TRAIN_MID_STEP``: m ~
    N(0, _TRAIN_MOMENT), v uniform in [0.5, 1.5] _TRAIN_MOMENT ** 2, drawn
    on ``draw_on`` (the card draws billions of numbers far faster than a
    CPU generator) and kept on the model's device."""
    from repro_torch.train import train_state_init
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState
    params = train_state_init(model).params
    gen = torch.Generator(draw_on).manual_seed(seed)

    def draw(fn, p):
        return fn(p.shape, generator=gen, device=draw_on).to(p.device)
    m = {k: draw(torch.randn, p) * _TRAIN_MOMENT for k, p in params.items()}
    v = {k: (draw(torch.rand, p) + 0.5) * _TRAIN_MOMENT ** 2
         for k, p in params.items()}
    return TrainState(params, AdamWState(
        torch.tensor(_TRAIN_MID_STEP, dtype=torch.int32), m, v))


def _state_on(state, device):
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    def move(tree):
        return {k: x.to(device) for k, x in tree.items()}
    return TrainState(move(state.params), AdamWState(
        state.opt.step.to(device), move(state.opt.m), move(state.opt.v)))


def _worst(a, b, scale) -> float:
    """max |a - b| over ``scale`` (a float), as float64."""
    return float((a.double() - b.double()).abs().max()) / max(scale, 1e-30)


def _adamw_alone(torch, optimizer, state, device) -> float:
    """``adamw_update`` on float32 copies of ``state``'s parameters (the
    gradients 7 m) on the CPU and on ``device``: the largest difference
    relative to each tensor's largest |value|, lr's and grad_norm's."""
    f32 = {k: x.float() for k, x in state.params.items()}
    grads = {k: x * 7.0 for k, x in state.opt.m.items()}
    pw, sw, iw = optimizer.adamw_update(f32, grads, state.opt)
    on = _state_on(state, device)
    pg, sg, ig = optimizer.adamw_update(
        {k: x.to(device) for k, x in f32.items()},
        {k: x.to(device) for k, x in grads.items()}, on.opt)
    adamw = max(_worst(a, b.to(device), float(b.abs().max()))
                for k in f32 for a, b in ((pg[k], pw[k]), (sg.m[k], sw.m[k]),
                                          (sg.v[k], sw.v[k])))
    return max(adamw, *(abs(float(ig[k]) - float(iw[k])) / float(iw[k])
                        for k in ("lr", "grad_norm")))


def _step_diff(torch, got, gm, want, wm, state, device):
    """How far a training step (``got``, its metrics ``gm``) is from
    another (``want``, ``wm``) from ``state``: (the relative differences
    of loss, grad_norm and lr; the parameters' largest difference past a
    bfloat16 ulp in learning rates, m's and v's against the step's
    largest added |part|; the leaf of each of the last three), computed
    on ``device``."""
    err = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
           for k in ("loss", "grad_norm", "lr")}
    lr = float(wm["lr"])
    worst = {"param_lr": 0.0, "m": 0.0, "v": 0.0}
    where = {}

    def keep(what, value, name):
        if value > worst[what]:
            worst[what], where[what] = value, name
    for name, w in want.params.items():
        g = got.params[name].to(device).double()
        w = w.to(device).double()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30)))
                         - 7)
        keep("param_lr", float(((g - w).abs() - ulp).max()) / lr, name)
        for what, b in (("m", 0.9), ("v", 0.95)):
            new_w = getattr(want.opt, what)[name].to(device)
            added = float((new_w - b * getattr(state.opt, what)[name].to(
                device)).abs().max())
            keep(what, _worst(getattr(got.opt, what)[name].to(device), new_w,
                              added), name)
    return err, worst, where


def train_against_cpu(torch, cfg, device, failures, label="train (b)",
                      adamw_alone=True, n_layers=2, batch=None, spread=False):
    """(b): full width, ``n_layers`` layers (None: ``cfg``'s); one set of
    weights and one mid-training state drawn on ``device`` and copied to
    the CPU; one step of ``_TRAIN_MICRO`` microbatches on each of
    ``batch`` (a CPU batch; by default ``_TRAIN_CPU_B`` x
    ``_TRAIN_CPU_S`` drawn tokens), then ``adamw_update`` alone on float32
    tensors (unless not ``adamw_alone``); the differences computed on
    ``device``. With ``spread``, the CPU also takes the step in the model's
    other exact forms (one microbatch; an xLSTM's recurrent mLSTM), each
    the same function in another float order; the loss, grad_norm, m and
    v of the card's step are held to the larger of ``_TRAIN_TOL`` and
    twice the largest difference those CPU steps show from the first, the
    model's own spread under a reordering (an xLSTM's gates carry a
    rounding's difference past ``_TRAIN_TOL``'s element limits even on the
    CPU), and the parameters are printed, not held: their difference in
    learning rates is not scale-free, it grows with an element's gradient
    error against the synthetic state's sqrt(v) of ``_TRAIN_MOMENT``
    (PERF.md). A MoE
    config's step on ``device`` runs on the CPU's routing
    (``tests/torch_routing.py``), its own differing choices near ties."""
    import copy
    import dataclasses
    import numpy as np
    mods = importlib.import_module("repro_torch.models")
    from repro_torch.train import make_train_step, optimizer
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = _lm_model(torch, mods, cfg, device, _TRAIN_SEED)
    cpu = copy.deepcopy(dev).to("cpu")
    state = _mid_training_state(torch, cpu, _TRAIN_SEED, device)
    if batch is None:
        tok = torch.from_numpy(np.random.default_rng(_TRAIN_SEED).integers(
            0, cfg.vocab, (_TRAIN_CPU_B, _TRAIN_CPU_S + 1), dtype=np.int32))
        batch = {"tokens": tok[:, :-1].contiguous(),
                 "labels": tok[:, 1:].contiguous()}
    moe = cfg.n_experts > 0
    t0 = time.perf_counter()
    rt = _routing() if moe else None
    with rt.recorded() if moe else contextlib.nullcontext() as probs:
        want, wm = make_train_step(cpu, microbatches=_TRAIN_MICRO,
                                   base_lr=_TRAIN_CPU_LR)(state, batch)
    cpu_secs = time.perf_counter() - t0
    rec = rt.Routed(cfg.top_k, probs) if moe else None
    with rt.forced(rec) if moe else contextlib.nullcontext():
        got, gm = make_train_step(dev, microbatches=_TRAIN_MICRO,
                                  base_lr=_TRAIN_CPU_LR)(
            _state_on(state, device),
            {k: x.to(device) for k, x in batch.items()})
    _sync(torch, device)
    routing = _route_check(rec, cfg, label, failures) if moe else ""
    tol = _TRAIN_TOL
    err, worst, where = _step_diff(torch, got, gm, want, wm, state, device)
    # each part's limit: _TRAIN_TOL's, or twice the CPU's own spread
    limit = {"loss": tol["loss"], "grad_norm": tol["grad_norm"],
             "param_lr": tol["param_lr"], "m": tol["moments"],
             "v": tol["moments"]}
    own = ""
    if spread:
        forms = {"one microbatch": (1, contextlib.nullcontext)}
        if cfg.family == "ssm":
            forms["recurrent mLSTM"] = (_TRAIN_MICRO, _Recurrent)
        sp = {}
        for form, (micro, ctx) in forms.items():
            with ctx():
                again, am = make_train_step(cpu, microbatches=micro,
                                            base_lr=_TRAIN_CPU_LR)(state,
                                                                   batch)
            s_err, s_worst, _ = _step_diff(torch, again, am, want, wm, state,
                                           device)
            del again
            sp[form] = {**s_err, **s_worst}
        for k in limit:
            limit[k] = max(limit[k], 2 * max(s[k] for s in sp.values()))
        limit["param_lr"] = math.inf
        own = ("; the CPU's own spread, its exact forms against the first: "
               + "; ".join(f"{form} " + ", ".join(
                   f"{k} {s[k]:.3g}" for k in limit) for form, s in sp.items())
               + f"; the limits {limit} (the parameters printed, not held)")
    lr = float(wm["lr"])
    for k in ("loss", "grad_norm"):
        if not err[k] <= limit[k]:
            failures.append(f"{label}: {k} {float(gm[k])} against the "
                            f"CPU's {float(wm[k])}")
    if not (err["lr"] <= tol["adamw"]
            and all(worst[k] <= limit[k] for k in ("param_lr", "m", "v"))):
        failures.append(f"{label}: lr {err['lr']:.3g}, parameters "
                        f"{worst['param_lr']:.3g} lr past an ulp, m "
                        f"{worst['m']:.3g}, v {worst['v']:.3g} (limits "
                        f"{limit})")
    # adamw_update alone, float32 in, float32 out
    adamw = _adamw_alone(torch, optimizer, state, device) if adamw_alone \
        else None
    if adamw is not None and not adamw <= tol["adamw"]:
        failures.append(f"{label}: adamw_update on float32 tensors "
                        f"{adamw:.3g} of each tensor's largest |value|")
    print(f"check {label} {cfg.name} at {cfg.n_layers} layers, batch "
          f"{ {k: list(x.shape) for k, x in batch.items()} }, "
          f"{_TRAIN_MICRO} microbatches, step "
          f"{_TRAIN_MID_STEP} -> {int(got.opt.step)}, lr {lr:.6g}, {device} "
          f"against the CPU ({cpu_secs:.1f} s there): loss {float(gm['loss'])}"
          f" / {float(wm['loss'])} (rel {err['loss']:.3g}), grad_norm "
          f"{float(gm['grad_norm'])} / {float(wm['grad_norm'])} (rel "
          f"{err['grad_norm']:.3g}), parameters {worst['param_lr']:.3g} lr "
          f"past a bfloat16 ulp, m {worst['m']:.3g} and v {worst['v']:.3g} "
          f"of the step's largest added |part| (at {where}){own}; "
          f"adamw_update on float32 "
          f"{'not run' if adamw is None else f'{adamw:.3g} relative'}; "
          f"tolerances {tol}{routing}; {card_line()}",
          flush=True)


def train_fault_tolerant(torch, here, device, failures):
    """(c): the example's ``--full-100m`` config through
    ``TrainLoop``: ``_FT_STEPS`` steps of ``_FT_B`` x ``_FT_S`` tokens with
    a checkpoint every ``_FT_EVERY`` into a temporary directory (removed
    after), uninterrupted and with a failure at ``_FT_FAIL``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(here, "examples", "train_lm_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = ex.make_config(True)
    corpus = ex.make_corpus(cfg)
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    runs = {}
    try:
        for which, fail_at in (("clean", ()), ("faulty", (_FT_FAIL,))):
            t0 = time.perf_counter()
            loop, state = ex.train(
                cfg, corpus, steps=_FT_STEPS, batch=_FT_B, seq=_FT_S,
                device=device, ckpt_dir=os.path.join(tmp, which),
                fail_at=fail_at, ckpt_every=_FT_EVERY)
            _sync(torch, device)
            runs[which] = (loop, state, time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (clean, clean_state, t_clean), (faulty, state, t_faulty) = (
        runs["clean"], runs["faulty"])
    diff = max(float((a.float() - state.params[k].float()).abs().max())
               for k, a in clean_state.params.items())
    on_device = all(x.device.type == device.type
                    for x in state.params.values())
    losses = [m["loss"] for m in faulty.metrics]
    ms = 1e3 * sorted(m["seconds"] for m in faulty.metrics)[
        len(faulty.metrics) // 2]
    if faulty.restarts != 1 or clean.restarts != 0:
        failures.append(f"train (c): restarts {faulty.restarts} (clean "
                        f"{clean.restarts}), want 1 and 0")
    if not diff <= 1e-6 or not on_device:
        failures.append(f"train (c): the recovered parameters differ from "
                        f"the uninterrupted run's by {diff} (atol 1e-6), "
                        f"on the device {on_device}")
    if not losses[-1] < losses[0]:
        failures.append(f"train (c): loss {losses[0]} -> {losses[-1]} did not "
                        "fall")
    print(f"check train (c) {cfg.name} ({sum(x.numel() for x in state.params.values())} "
          f"parameters) {_FT_STEPS} steps of {_FT_B}x{_FT_S} tokens on "
          f"{device}, a checkpoint every {_FT_EVERY}, a failure at "
          f"{_FT_FAIL}: restarts {faulty.restarts}, {len(faulty.metrics)} "
          f"steps run, recovered parameters against the uninterrupted "
          f"run's max |diff| {diff} (atol 1e-6), loss {losses[0]:.4f} -> "
          f"{losses[len(losses) // 2]:.4f} -> {losses[-1]:.4f}, median "
          f"{ms:.3f} ms a step (the loop reads each loss back), runs "
          f"{t_clean:.1f} s and {t_faulty:.1f} s; {card_line()}", flush=True)


def run_train(torch, fused, kops, rate, here):
    """Phase 9c: training on the card; (rows of the kernels line). Every
    part is checked and printed before the phase fails."""
    cfgs = importlib.import_module("repro_torch.configs")
    device = torch.device("cuda")
    t0 = time.perf_counter()
    failures = []
    cfg = cfgs.get_config(_LM_ARCH)
    call, launches = train_full(torch, fused, kops, cfg, device, failures)
    row = train_fused_row(torch, fused, call, launches, rate)
    del call
    train_against_cpu(torch, cfg, device, failures)
    train_fault_tolerant(torch, here, device, failures)
    torch.cuda.empty_cache()
    print(f"phase 9c (training): {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failures:
        fail("; ".join(failures))
    return [row]


# ---------------------------------------------------------------------------
# phase 9d: the MoE and hybrid families (deepseek-moe-16B at full depth,
# dbrx-132B and jamba-v0.1 at a few layers, a MoE training step)
# ---------------------------------------------------------------------------

def _routing():
    """``tests/torch_routing.py``: the near-tie rule for top-k routing (a
    run on another run's experts, each differing choice of its own a near
    tie)."""
    return importlib.import_module("torch_routing")


def _route_check(rec, cfg, what, failures) -> str:
    """Holds ``rec`` (a ``Routed`` after its forced run) to ``cfg``'s
    margin; returns its summary."""
    margin = _MOE_MARGIN[cfg.name]
    msg = rec.failure(margin, what)
    if msg:
        failures.append(msg)
    return ", " + rec.summary(margin)


class _LayerOuts:
    """Keeps the residual stream after each layer (``blocks.apply_train``,
    ``apply_prefill``, ``apply_decode``) while entered, in call order."""

    def __init__(self):
        from repro_torch.models import blocks
        self.mod, self.outs = blocks, []

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in (
            "apply_train", "apply_prefill", "apply_decode")}
        for n, fn in self.saved.items():
            setattr(self.mod, n, self._keep(fn))
        return self

    def _keep(self, fn):
        def kept(*args, **kw):
            out = fn(*args, **kw)
            self.outs.append(out[0].detach().clone())
            return out
        return kept

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.mod, n, fn)


def _layer_drift(torch, cfg, fwd, serve, s, steps) -> str:
    """Each layer's largest |serve - forward| over its row's largest
    |value| (the prefill's rows and each step's), from ``_LayerOuts``."""
    from repro_torch.models.blocks import layer_kind
    n = cfg.n_layers
    parts = []
    for i in range(n):
        want = fwd[i].float()
        got = [serve[i].float()] + [serve[n * (1 + t) + i].float()
                                    for t in range(steps)]
        rows = [want[:, :s]] + [want[:, s + t:s + t + 1]
                                for t in range(steps)]
        worst = max(float(((g - w).abs() / w.abs().amax(-1, keepdim=True))
                          .max()) for g, w in zip(got, rows))
        parts.append(f"{i} {'+'.join(layer_kind(cfg, i))} {worst:.3g}")
    return "; ".join(parts)


class _Drops:
    """Keeps each MoE call's routing while entered: ``copies(n)`` gives
    (token copies, copies dropped by capacity) over the calls of ``n``
    tokens (all calls when None), read back after the run."""

    def __init__(self):
        from repro_torch.models import moe_a2a
        self.mod, self.calls = moe_a2a, []

    def __enter__(self):
        route = self.route = self.mod._route

        def kept(flat, params, cfg, *args):
            r = route(flat, params, cfg, *args)
            self.calls.append((flat.shape[0], r.topi.numel(), r.slot_w))
            return r

        self.mod._route = kept
        return self

    def __exit__(self, *exc):
        self.mod._route = self.route

    def copies(self, n=None):
        calls = [c for c in self.calls if n is None or c[0] == n]
        total = sum(c[1] for c in calls)
        return total, total - sum(int((c[2] != 0).sum()) for c in calls)


def _moe_shares(n_tok, drops):
    total, dropped = drops.copies(n_tok)
    return (f"capacity dropped {dropped} of {total} token copies "
            f"({dropped / max(total, 1):.6f})")


def moe_against_forward(torch, model, b, s, steps, seed, what, failures):
    """(b): ``forward`` over ``b`` prompts of ``s`` tokens and ``steps``
    more (its routing recorded), then the prefill of the prompts and
    ``steps`` decode steps fed the same tokens on the forward's routing:
    each position's logits against forward's within ``_LM_TOL``
    (``_LM_HYBRID_TOL`` for a hybrid config). The tokens are drawn, not
    greedy: greedy steps of a random model repeat a token, whose copies
    then crowd one expert. No copy may be dropped (the check's
    precondition: capacity follows each call's tokens)."""
    cfg = model.cfg
    seq = _lm_batch(torch, cfg, b, s + steps, seed, model.device)["tokens"]
    batch, fed = {"tokens": seq[:, :s]}, seq[:, s:]
    rt = _routing()
    with _Drops() as d_fwd, rt.recorded() as probs, \
            _LayerOuts() as l_fwd, torch.inference_mode():
        logits, _ = model.forward({"tokens": seq})
    # the forward's routing in the serve's call order: the prefill's calls
    # (its first s positions), then each step's (position s + t)
    n_moe = len(probs)
    probs = [p.reshape(b, s + steps, -1) for p in probs]
    order = [p[:, :s].reshape(b * s, -1) for p in probs]
    for t in range(steps):
        order += [p[:, s + t] for p in probs]
    rec = rt.Routed(cfg.top_k, order)
    with _Drops() as d_serve, rt.forced(rec), _LayerOuts() as l_serve:
        outs, _, _, _, _ = _lm_serve(torch, model, batch, s + steps, steps,
                                     feed=fed)
    routing = _route_check(rec, cfg, what, failures)
    layers = _layer_drift(torch, cfg, l_fwd.outs, l_serve.outs, s, steps)
    del l_fwd, l_serve
    _lm_finite(torch, outs, what, failures)
    dropped = d_fwd.copies()[1] + d_serve.copies()[1]
    if dropped:
        failures.append(f"{what}: {dropped} token copies dropped; the check "
                        "needs none")
    tol = _LM_HYBRID_TOL if cfg.family == "hybrid" else _LM_TOL
    err, ratio, misses = _logits_diff(torch, outs, [
        logits[:, s - 1 + t:s + t] for t in range(len(outs))], tol)
    if not ratio <= 1.0 or misses:
        failures.append(f"{what}: against forward max |diff| {err:.4g}, "
                        f"{ratio:.3g} of the tolerance {tol}, greedy "
                        f"misses {misses}")
    print(f"check {what} against forward, B {b}, prompts of {s}, {steps} "
          f"steps, {n_moe} MoE calls a forward: max |diff| {err:.4g}, "
          f"{ratio:.3g} of the tolerance (atol, rtol) {tol}, greedy "
          f"misses {misses}, copies dropped {dropped}{routing}; the "
          f"residual stream's largest |decode - forward| over its row's "
          f"largest |value| after each layer: {layers}", flush=True)


def _profile_once(torch, what, fn):
    """One profiled call of ``fn``: its device busy ms and its heaviest
    kernels, printed beside the call's wall."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof, _ = _profiled(torch, fn)
    rows = _device_events(prof)
    busy = sum(r[2] for r in rows) / 1e3
    top = "; ".join(f"{r[0][:60]} x{r[1]} {r[2] / 1e3:.3f} ms"
                    for r in rows[:8])
    print(f"profile {what}: wall {wall:.3f} ms unprofiled, device busy "
          f"{busy:.3f} ms ({len(rows)} kernel names); {top}", flush=True)


def moe_deepseek(torch, mods, cfgs, kops, failures):
    """(a) and (b) at deepseek-moe-16B's full CONFIG: (the first attention
    call's q, k and v, contiguous; the prefill's launches)."""
    cfg = cfgs.get_config(_MOE_ARCH)
    what = f"moe {_MOE_ARCH}"
    t0 = time.perf_counter()
    model = _lm_model(torch, mods, cfg, "cuda", _MOE_SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = _lm_batch(torch, cfg, _MOE_BATCH, _MOE_PROMPT, _MOE_SEED, "cuda")
    _lm_serve(torch, model, batch, _MOE_MAX_LEN, 2)    # warm-up
    syncs = _lm_host_syncs(torch, model, batch, _MOE_MAX_LEN)
    if syncs:
        failures.append(f"{what}: {len(syncs)} host syncs in a prefill and "
                        f"a decode step: {syncs[:3]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    with _Capture(kops) as cap, _Drops() as drops:
        outs, fed, _, t_prefill, t_decode = _lm_serve(
            torch, model, batch, _MOE_MAX_LEN, _MOE_STEPS)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["flash_attention"] != cfg.n_layers or \
            sum(counts.values()) != cfg.n_layers or cap.calls != cfg.n_layers:
        failures.append(f"{what}: launches {counts}, {cap.calls} calls; "
                        f"want {cfg.n_layers} flash_attention a prefill")
    _lm_finite(torch, outs, what, failures)
    n_tok = _MOE_BATCH * _MOE_STEPS
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{what} (a): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
          f"shared, vocab {cfg.vocab}, {n_params} parameters drawn on the "
          f"card in {t_init:.1f} s; prefill {_MOE_BATCH}x{_MOE_PROMPT} tokens "
          f"in {t_prefill * 1e3:.3f} ms "
          f"({_MOE_BATCH * _MOE_PROMPT / t_prefill:.1f} tokens/s), "
          f"{_MOE_STEPS} decode steps at {t_decode / _MOE_STEPS * 1e3:.3f} ms "
          f"a step ({n_tok / t_decode:.1f} tokens/s), max_memory_allocated "
          f"{peak / 1e9:.3f} GB, launches {dict(_nonzero(counts))}, host "
          f"syncs {len(syncs)}; the prefill's "
          f"{_moe_shares(_MOE_BATCH * _MOE_PROMPT, drops)}, the decode's "
          f"{_moe_shares(_MOE_BATCH, drops)}; {card_line()}", flush=True)
    qkv = tuple(t.contiguous() for t in cap.first)
    del outs, cap, drops
    with torch.inference_mode():
        _profile_once(torch, f"{what} prefill", lambda: model.prefill(
            batch, _MOE_MAX_LEN))
        logits, caches = model.prefill(batch, _MOE_MAX_LEN)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        _profile_once(torch, f"{what} decode step", lambda: model.decode_step(
            tok, caches, _MOE_PROMPT))
        del logits, caches
    moe_against_forward(torch, model, _MOE_FWD_B, _MOE_FWD_PROMPT,
                        _MOE_FWD_STEPS, _MOE_SEED + 1, f"{what} (b) decode",
                        failures)
    del model
    torch.cuda.empty_cache()
    return qkv, counts["flash_attention"]


def moe_against_cpu(torch, mods, cfgs, failures):
    """(c): full width, 2 layers, one set of weights made on the CPU; the
    card on the CPU's routing."""
    import dataclasses
    cfg = dataclasses.replace(cfgs.get_config(_MOE_ARCH), n_layers=2)
    cpu, gpu = _cpu_and_card(torch, mods, cfg, _MOE_SEED)
    s, steps = _MOE_CPU_PROMPT, _MOE_CPU_STEPS
    what = f"moe {_MOE_ARCH} 2 layers S {s} (c) card vs CPU"
    batch = _lm_batch(torch, cfg, 2, s, _MOE_SEED + s, "cpu")
    t0 = time.perf_counter()
    rt = _routing()
    with rt.recorded() as probs:
        want, fed, want_c, _, _ = _lm_serve(torch, cpu, batch, s + steps,
                                            steps)
    cpu_secs = time.perf_counter() - t0
    rec = rt.Routed(cfg.top_k, probs)
    with rt.forced(rec):
        got, _, got_c, _, _ = _lm_serve(
            torch, gpu, {k: x.cuda() for k, x in batch.items()}, s + steps,
            steps, feed=fed.cuda())
    routing = _route_check(rec, cfg, what, failures)
    err, ratio, misses = _logits_diff(torch, got, want, _LM_CPU_TOL)
    cache = _rows_ratio(torch, [p for gc, wc in zip(got_c, want_c)
                                for p in zip(gc, wc)], _LM_CPU_TOL)
    _lm_finite(torch, got, what, failures)
    if not (ratio <= 1.0 and cache <= 1.0) or misses:
        failures.append(f"{what}: logits max |diff| {err:.4g} ({ratio:.3g} "
                        f"of the tolerance), caches {cache:.3g} of it, "
                        f"greedy misses {misses}")
    print(f"check {what}: prefill and {steps} decode steps ({cpu_secs:.1f} s "
          f"on the CPU), logits max |diff| {err:.4g} ({ratio:.3g} of (atol, "
          f"rtol) {_LM_CPU_TOL}), K/V caches {cache:.3g} of it by row, greedy "
          f"misses {misses}{routing}", flush=True)
    del gpu
    torch.cuda.empty_cache()


class _FnClock:
    """CUDA events around each call of ``mod.<name>`` (looked up at call
    time, as the module's own calls look it up) while entered: ``ms()``
    sums them after a synchronize."""

    def __init__(self, torch, mod, name):
        self.torch, self.mod, self.name, self.events = torch, mod, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.mod, self.name)
        torch = self.torch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def moe_others(torch, mods, cfgs, kops, failures):
    """(d): dbrx-132B and jamba-v0.1 at full width and a few layers."""
    import dataclasses
    for arch, layers in _MOE_OTHERS:
        cfg = dataclasses.replace(cfgs.get_config(arch), n_layers=layers)
        n_attn = sum(cfg.family != "hybrid" or cfg.is_attn_layer(i)
                     for i in range(layers))
        model = _lm_model(torch, mods, cfg, "cuda", _MOE_SEED)
        batch = _lm_batch(torch, cfg, 2, _MOE_PROMPT, _MOE_SEED, "cuda")
        _lm_serve(torch, model, batch, _MOE_PROMPT + 4, 1)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        with _FnClock(torch, importlib.import_module(
                "repro_torch.models.mamba"), "_selective_scan") as clock:
            outs, fed, _, t_prefill, t_decode = _lm_serve(
                torch, model, batch, _MOE_PROMPT + 4, 4)
        counts = kops.launch_counts()
        what = f"moe {arch} {layers} layers (d)"
        if counts["flash_attention"] != n_attn or \
                sum(counts.values()) != n_attn:
            failures.append(f"{what}: launches {counts}, want {n_attn} "
                            "flash_attention")
        _lm_finite(torch, outs, what, failures)
        scan = (f", the Mamba loop ({len(clock.events)} scans) "
                f"{clock.ms():.3f} ms of it "
                f"({clock.ms() / (t_prefill * 1e3):.3f})"
                if clock.events else "")
        print(f"{what}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv}, {cfg.n_experts} experts top-{cfg.top_k}, "
              f"{n_attn} attention layers, "
              f"{sum(p.numel() for p in model.parameters())} parameters; "
              f"prefill 2x{_MOE_PROMPT} in {t_prefill * 1e3:.3f} ms{scan}, "
              f"decode {t_decode / 4 * 1e3:.3f} ms a step, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches "
              f"{dict(_nonzero(counts))}", flush=True)
        moe_against_forward(torch, model, _MOE_FWD_B, _MOE_FWD_PROMPT,
                            _MOE_FWD_STEPS, _MOE_SEED + 2, f"{what} decode",
                            failures)
        del model, outs
        torch.cuda.empty_cache()


def run_moe(torch, fa, kops, rate, name):
    """Phase 9d: the MoE and hybrid families; (rows of the kernels line).
    Every part is checked and printed before the phase fails."""
    cfgs = importlib.import_module("repro_torch.configs")
    mods = importlib.import_module("repro_torch.models")
    t0 = time.perf_counter()
    failures = []
    marks = [t0]

    def mark():
        marks.append(time.perf_counter())
    qkv, launches = moe_deepseek(torch, mods, cfgs, kops, failures)
    row = lm_attention_row(torch, fa, qkv, launches, rate, name, failures,
                           arch=_MOE_ARCH)
    del qkv
    mark()
    moe_against_cpu(torch, mods, cfgs, failures)
    mark()
    moe_others(torch, mods, cfgs, kops, failures)
    mark()
    train_against_cpu(torch, cfgs.get_config(_MOE_ARCH),
                      torch.device("cuda"), failures, label="moe train (e)",
                      adamw_alone=False)
    mark()
    torch.cuda.empty_cache()
    print("phase 9d parts, s: (a), (b) and (f) {:.1f}, (c) {:.1f}, (d) "
          "{:.1f}, (e) {:.1f}".format(*(b - a for a, b in zip(marks,
                                                              marks[1:]))),
          flush=True)
    print(f"phase 9d (MoE and hybrid): {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failures:
        fail("; ".join(failures))
    return [row]


# ---------------------------------------------------------------------------
# phase 9e: the xLSTM and encoder-decoder families (xlstm-125M and
# seamless-m4t-large-v2 at full width and depth)
# ---------------------------------------------------------------------------

def _xl_module():
    return importlib.import_module("repro_torch.models.xlstm")


def xl_full(torch, mods, cfgs, kops, failures):
    """(a) and (b) at xlstm-125M's full CONFIG."""
    cfg = cfgs.get_config(_XL_ARCH)
    what = f"xlstm {_XL_ARCH}"
    model = _lm_model(torch, mods, cfg, "cuda", _XE_SEED)
    batch = _lm_batch(torch, cfg, _XL_BATCH, _XL_PROMPT, _XE_SEED, "cuda")
    max_len = _XL_PROMPT + _XL_STEPS
    _lm_serve(torch, model, batch, max_len, 2)    # warm-up
    syncs = _lm_host_syncs(torch, model, batch, max_len)
    if syncs:
        failures.append(f"{what}: {len(syncs)} host syncs in a prefill and "
                        f"a decode step: {syncs[:3]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    outs, _, first, t_prefill, t_decode = _lm_serve(
        torch, model, batch, max_len, _XL_STEPS)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if sum(counts.values()):
        failures.append(f"{what}: launches {dict(_nonzero(counts))}; no "
                        "kernel of the port computes the xLSTM")
    _lm_finite(torch, outs, what, failures)
    state_bytes = sum(x.numel() * x.element_size() for c in first for x in c)
    del outs, first
    # the loops' shares of one more prefill, timed by CUDA events
    xl = _xl_module()
    with _FnClock(torch, xl, "_slstm_scan") as sl, \
            _FnClock(torch, xl, "_mlstm_chunkwise") as ml:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(batch, max_len)
        torch.cuda.synchronize()
        t_clocked = (time.perf_counter() - t0) * 1e3
    n_tok = _XL_BATCH * _XL_STEPS
    n_slstm = sum(cfg.is_slstm_layer(i) for i in range(cfg.n_layers))
    print(f"{what} (a): {cfg.n_layers} layers ({n_slstm} "
          f"sLSTM), d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
          f"{cfg.vocab}, {sum(p.numel() for p in model.parameters())} "
          f"parameters; prefill {_XL_BATCH}x{_XL_PROMPT} tokens in "
          f"{t_prefill * 1e3:.3f} ms "
          f"({_XL_BATCH * _XL_PROMPT / t_prefill:.1f} tokens/s), "
          f"{_XL_STEPS} decode steps at {t_decode / _XL_STEPS * 1e3:.3f} ms "
          f"a step ({n_tok / t_decode:.1f} tokens/s), max_memory_allocated "
          f"{peak / 1e9:.3f} GB, the states {state_bytes / 1e6:.3f} MB, "
          f"launches {dict(_nonzero(counts))}, host syncs {len(syncs)}; a "
          f"prefill timed with its loops {t_clocked:.3f} ms: the sLSTM "
          f"loops ({len(sl.events)}) {sl.ms():.3f} ms "
          f"({sl.ms() / t_clocked:.3f}), the mLSTM chunk loops "
          f"({len(ml.events)}) {ml.ms():.3f} ms ({ml.ms() / t_clocked:.3f}); "
          f"{card_line()}", flush=True)
    with torch.inference_mode():
        _profile_once(torch, f"{what} prefill", lambda: model.prefill(
            batch, max_len))
        logits, caches = model.prefill(batch, max_len)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        _profile_once(torch, f"{what} decode step", lambda: model.decode_step(
            tok, caches, _XL_PROMPT))
        del logits, caches
    xl_against_forward(torch, model, f"{what} (b) decode", failures)
    del model
    torch.cuda.empty_cache()


def xl_against_forward(torch, model, what, failures):
    """(b): prefill and decode fed drawn tokens against ``forward`` at each
    prompt length of ``_XL_FWD_PROMPTS``; ``forward`` in the two mLSTM
    modes."""
    cfg = model.cfg
    b, steps = _XL_FWD_B, _XL_FWD_STEPS
    seq = None
    for s in _XL_FWD_PROMPTS:
        seq = _lm_batch(torch, cfg, b, s + steps, _XE_SEED + s,
                        model.device)["tokens"]
        batch, fed = {"tokens": seq[:, :s]}, seq[:, s:]
        with _LayerOuts() as l_serve:
            outs, _, _, _, _ = _lm_serve(torch, model, batch, s + steps,
                                         steps, feed=fed)
        with _LayerOuts() as l_fwd, torch.inference_mode():
            model.forward({"tokens": seq})
        _lm_finite(torch, outs, what, failures)
        _lm_against_forward(torch, model, batch, outs, fed, _LM_TOL,
                            f"{what} B {b} S {s}", failures)
        print(f"{what} B {b} S {s}: the residual stream's largest |decode - "
              "forward| over its row's largest |value| after each layer: "
              + _layer_drift(torch, cfg, l_fwd.outs, l_serve.outs, s, steps),
              flush=True)
        del l_serve, l_fwd
    xl = _xl_module()
    tokens = {"tokens": seq[:, :_XL_FWD_PROMPTS[0]]}
    old = xl.MLSTM_MODE
    try:
        with torch.inference_mode():
            xl.MLSTM_MODE = "recurrent"
            rec, _ = model.forward(tokens)
            xl.MLSTM_MODE = "chunkwise"
            chk, _ = model.forward(tokens)
    finally:
        xl.MLSTM_MODE = old
    err, ratio = _lm_diff(torch, chk, rec, _XL_MODES_TOL)
    if not ratio <= 1.0:
        failures.append(f"{what}: chunkwise against recurrent max |diff| "
                        f"{err:.4g}, {ratio:.3g} of the tolerance")
    print(f"check {what}: forward, MLSTM_MODE chunkwise against recurrent "
          f"at {cfg.n_layers} layers, B {b} S {tokens['tokens'].shape[1]}: "
          f"max |diff| {err:.4g}, {ratio:.3g} of (atol, rtol) "
          f"{_XL_MODES_TOL}", flush=True)


def xl_against_cpu(torch, mods, cfgs, failures):
    """(c): full width and depth, prompts of ``_XL_CPU_PROMPT``, the card
    fed the CPU's greedy tokens."""
    cfg = cfgs.get_config(_XL_ARCH)
    cpu, gpu = _cpu_and_card(torch, mods, cfg, _XE_SEED)
    s, steps = _XL_CPU_PROMPT, _XL_CPU_STEPS
    what = f"xlstm {_XL_ARCH} S {s} (c) card vs CPU"
    batch = _lm_batch(torch, cfg, 2, s, _XE_SEED + s, "cpu")
    t0 = time.perf_counter()
    want, fed, want_c, _, _ = _lm_serve(torch, cpu, batch, s + steps, steps)
    cpu_secs = time.perf_counter() - t0
    got, _, got_c, _, _ = _lm_serve(
        torch, gpu, {k: x.cuda() for k, x in batch.items()}, s + steps,
        steps, feed=fed.cuda())
    err, ratio, misses = _logits_diff(torch, got, want, _XL_CPU_TOL)
    # each state tensor against its largest |value|
    worst = {}
    for gc, wc in zip(got_c, want_c):
        for field, g, w in zip(wc._fields, gc, wc):
            key = f"{type(wc).__name__}.{field}"
            rel = float((g.cpu() - w).abs().max() / w.abs().max())
            worst[key] = max(worst.get(key, 0.0), rel)
    _lm_finite(torch, got, what, failures)
    bad = {k: v for k, v in worst.items() if not v <= _XL_STATE_TOL}
    if not ratio <= 1.0 or misses or bad:
        failures.append(f"{what}: logits max |diff| {err:.4g} ({ratio:.3g} "
                        f"of the tolerance), greedy misses {misses}, states "
                        f"past {_XL_STATE_TOL} of their largest |value|: "
                        f"{bad}")
    print(f"check {what}: prefill and {steps} decode steps ({cpu_secs:.1f} s "
          f"on the CPU), logits max |diff| {err:.4g} ({ratio:.3g} of (atol, "
          f"rtol) {_XL_CPU_TOL}), greedy misses {misses}; each state "
          f"after the prefill, max |diff| over its largest |value| (limit "
          f"{_XL_STATE_TOL}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)
    del gpu
    torch.cuda.empty_cache()


def _ed_frames(torch, cfg, b, t, seed, device):
    """B utterances of ``t`` frames (the frontend stub's embeddings) and
    a start token each, drawn with numpy from ``seed``, on ``device``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, t, cfg.d_model), dtype=np.float32)
    start = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
    return (torch.from_numpy(frames).to(device, torch.bfloat16),
            torch.from_numpy(start).to(device))


def _ed_serve(torch, model, frames, feed, steps):
    """The encoder-decoder's prefill of ``frames``, then ``steps`` decode
    steps from position 0, step t fed ``feed[:, t]`` (a [B, 1] start token
    and then each step's greedy token when ``feed`` has one column): (each
    step's logits [B, 1, V], the tokens fed [B, steps], the caches, the
    prefill's seconds, the decode's seconds)."""
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    caches = model.prefill({"frames": frames})
    sync()
    t_prefill = time.perf_counter() - t0
    outs, fed = [], []
    tok = feed[:, 0]
    t0 = time.perf_counter()
    for t in range(steps):
        fed.append(tok)
        logits, caches = model.decode_step(tok[:, None], caches, t)
        outs.append(logits)
        tok = (feed[:, t + 1] if feed.shape[1] > 1 and t + 1 < steps
               else logits[:, -1].argmax(-1).to(torch.int32))
    sync()
    t_decode = time.perf_counter() - t0
    return outs, torch.stack(fed, dim=1), caches, t_prefill, t_decode


def ed_full(torch, mods, cfgs, kops, failures):
    """(d) and (e) at seamless-m4t-large-v2's full CONFIG: (the first
    attention call's q, k and v, contiguous; the prefill's launches)."""
    cfg = cfgs.get_config(_ED_ARCH)
    what = f"encdec {_ED_ARCH}"
    t0 = time.perf_counter()
    model = _lm_model(torch, mods, cfg, "cuda", _XE_SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    frames, start = _ed_frames(torch, cfg, _ED_BATCH, _ED_FRAMES, _XE_SEED,
                               "cuda")
    _ed_serve(torch, model, frames, start, 2)    # warm-up
    syncs = _host_syncs(torch, lambda: model.decode_step(
        start, model.prefill({"frames": frames}), 0))
    if syncs:
        failures.append(f"{what}: {len(syncs)} host syncs in a prefill and "
                        f"a decode step: {syncs[:3]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    with _Capture(kops) as cap:
        outs, _, caches, t_prefill, t_decode = _ed_serve(
            torch, model, frames, start, _ED_STEPS)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_enc = cfg.n_enc_layers
    if counts["flash_attention"] != n_enc or \
            sum(counts.values()) != n_enc or cap.calls != n_enc:
        failures.append(f"{what}: launches {counts}, {cap.calls} calls; "
                        f"want {n_enc} flash_attention (one an encoder "
                        "layer) and nothing else")
    _lm_finite(torch, outs, what, failures)
    cross = sum(x.numel() * x.element_size()
                for x in (caches["cross_k"], caches["cross_v"]))
    own = sum(x.numel() * x.element_size() for x in caches["self"])
    n_tok = _ED_BATCH * _ED_STEPS
    print(f"{what} (d): {n_enc} encoder and {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{sum(p.numel() for p in model.parameters())} parameters drawn "
          f"on the card in {t_init:.1f} s; prefill of {_ED_BATCH}x"
          f"{_ED_FRAMES} frames in {t_prefill * 1e3:.3f} ms "
          f"({_ED_BATCH * _ED_FRAMES / t_prefill:.1f} frames/s), "
          f"{_ED_STEPS} decode steps at {t_decode / _ED_STEPS * 1e3:.3f} ms "
          f"a step ({n_tok / t_decode:.1f} tokens/s), max_memory_allocated "
          f"{peak / 1e9:.3f} GB, cross K/V {cross / 1e9:.3f} GB, self "
          f"caches {own / 1e9:.3f} GB, launches {dict(_nonzero(counts))}, "
          f"host syncs {len(syncs)}; {card_line()}", flush=True)
    qkv = tuple(x.contiguous() for x in cap.first)
    del outs, cap, caches
    with torch.inference_mode():
        _profile_once(torch, f"{what} prefill", lambda: model.prefill(
            {"frames": frames}))
        caches = model.prefill({"frames": frames})
        _profile_once(torch, f"{what} decode step", lambda: model.decode_step(
            start, caches, 0))
        del caches
    ed_against_forward(torch, model, f"{what} (e) decode", failures)
    del model
    torch.cuda.empty_cache()
    return qkv, counts["flash_attention"]


def ed_against_forward(torch, model, what, failures):
    """(e): ``_ED_FWD_FRAMES`` frames, ``_ED_FWD_STEPS`` steps fed drawn
    tokens, against ``forward`` over the frames and those tokens."""
    import numpy as np
    cfg = model.cfg
    frames, _ = _ed_frames(torch, cfg, 2, _ED_FWD_FRAMES, _XE_SEED + 1,
                           model.device)
    feed = torch.from_numpy(np.random.default_rng(_XE_SEED + 2).integers(
        0, cfg.vocab, (2, _ED_FWD_STEPS), dtype=np.int32)).to(model.device)
    outs, _, _, _, _ = _ed_serve(torch, model, frames, feed, _ED_FWD_STEPS)
    with torch.inference_mode():
        logits, _ = model.forward({"frames": frames, "tokens": feed})
    err, ratio, misses = _logits_diff(torch, outs, [
        logits[:, t:t + 1] for t in range(len(outs))], _LM_TOL)
    _lm_finite(torch, outs, what, failures)
    if not ratio <= 1.0 or misses:
        failures.append(f"{what}: against forward max |diff| {err:.4g}, "
                        f"{ratio:.3g} of the tolerance {_LM_TOL}, greedy "
                        f"misses {misses}")
    print(f"check {what} against forward, B 2, {_ED_FWD_FRAMES} frames, "
          f"{_ED_FWD_STEPS} steps fed drawn tokens (the prefill's encoder "
          f"on the kernel, forward's plain): max |diff| {err:.4g}, "
          f"{ratio:.3g} of the tolerance (atol, rtol) {_LM_TOL}, greedy "
          f"misses {misses}", flush=True)


def ed_against_cpu(torch, mods, cfgs, failures):
    """(f): full width, ``_ED_CPU_LAYERS`` encoder and decoder layers, the
    card fed the CPU's greedy tokens."""
    import dataclasses
    cfg = dataclasses.replace(cfgs.get_config(_ED_ARCH),
                              n_layers=_ED_CPU_LAYERS,
                              n_enc_layers=_ED_CPU_LAYERS)
    cpu, gpu = _cpu_and_card(torch, mods, cfg, _XE_SEED)
    t, steps = _ED_CPU_FRAMES, _ED_CPU_STEPS
    what = (f"encdec {_ED_ARCH} {_ED_CPU_LAYERS}+{_ED_CPU_LAYERS} layers T "
            f"{t} (f) card vs CPU")
    frames, start = _ed_frames(torch, cfg, 2, t, _XE_SEED + t, "cpu")
    t0 = time.perf_counter()
    want, fed, want_c, _, _ = _ed_serve(torch, cpu, frames, start, steps)
    cpu_secs = time.perf_counter() - t0
    got, _, got_c, _, _ = _ed_serve(torch, gpu, frames.cuda(), fed.cuda(),
                                    steps)
    err, ratio, misses = _logits_diff(torch, got, want, _LM_CPU_TOL)
    cache = _rows_ratio(torch, [(got_c[k], want_c[k])
                                for k in ("cross_k", "cross_v")], _LM_CPU_TOL)
    _lm_finite(torch, got, what, failures)
    if not (ratio <= 1.0 and cache <= 1.0) or misses:
        failures.append(f"{what}: logits max |diff| {err:.4g} ({ratio:.3g} "
                        f"of the tolerance), cross K/V {cache:.3g} of it, "
                        f"greedy misses {misses}")
    print(f"check {what}: prefill and {steps} decode steps ({cpu_secs:.1f} s "
          f"on the CPU), logits max |diff| {err:.4g} ({ratio:.3g} of (atol, "
          f"rtol) {_LM_CPU_TOL}), cross K/V {cache:.3g} of it by row, greedy "
          f"misses {misses}", flush=True)
    del gpu
    torch.cuda.empty_cache()


class _Recurrent:
    """While entered, the xLSTM runs its mLSTM in the recurrent form, the
    chunkwise form's exact equal in another float order."""

    def __enter__(self):
        self.mod = _xl_module()
        self.old, self.mod.MLSTM_MODE = self.mod.MLSTM_MODE, "recurrent"

    def __exit__(self, *exc):
        self.mod.MLSTM_MODE = self.old


def xe_train(torch, cfgs, failures):
    """(g): a training step of each family against the CPU, each part held
    against the CPU's own spread as well (``train_against_cpu``): xlstm at
    full depth, seamless at ``_ED_CPU_LAYERS`` + ``_ED_CPU_LAYERS`` layers
    on ``_ED_TRAIN_FRAMES`` frames (the reference's train shape:
    ``max(S // 4, 16)`` tokens)."""
    import dataclasses
    import numpy as np
    train_against_cpu(torch, cfgs.get_config(_XL_ARCH), torch.device("cuda"),
                      failures, label="xlstm train (g)", adamw_alone=False,
                      n_layers=None, spread=True)
    cfg = dataclasses.replace(cfgs.get_config(_ED_ARCH),
                              n_enc_layers=_ED_CPU_LAYERS)
    n_tok = max(_ED_TRAIN_FRAMES // 4, 16)
    rng = np.random.default_rng(_TRAIN_SEED)
    frames = rng.standard_normal((_TRAIN_CPU_B, _ED_TRAIN_FRAMES,
                                  cfg.d_model), dtype=np.float32)
    tok = rng.integers(0, cfg.vocab, (_TRAIN_CPU_B, n_tok + 1),
                       dtype=np.int32)
    batch = {"frames": torch.from_numpy(frames).bfloat16(),
             "tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    train_against_cpu(torch, cfg, torch.device("cuda"), failures,
                      label="encdec train (g)", adamw_alone=False,
                      n_layers=_ED_CPU_LAYERS, batch=batch, spread=True)


def run_xlstm_encdec(torch, fa, kops, rate, name):
    """Phase 9e: the xLSTM and encoder-decoder families; (rows of the
    kernels line). TF32 is off for the whole phase (the xLSTM's float32
    products run in full float32) and set back after it. Every part is
    checked and printed before the phase fails."""
    cfgs = importlib.import_module("repro_torch.configs")
    mods = importlib.import_module("repro_torch.models")
    t0 = time.perf_counter()
    failures = []
    marks = [t0]

    def mark():
        marks.append(time.perf_counter())
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xl_full(torch, mods, cfgs, kops, failures)
        mark()
        xl_against_cpu(torch, mods, cfgs, failures)
        mark()
        qkv, launches = ed_full(torch, mods, cfgs, kops, failures)
        row = lm_attention_row(torch, fa, qkv, launches, rate, name,
                               failures, arch=_ED_ARCH, causal=False,
                               part="encode")
        del qkv
        mark()
        ed_against_cpu(torch, mods, cfgs, failures)
        mark()
        xe_train(torch, cfgs, failures)
        mark()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    torch.cuda.empty_cache()
    print("phase 9e parts, s: (a) and (b) {:.1f}, (c) {:.1f}, (d), (e) and "
          "(h) {:.1f}, (f) {:.1f}, (g) {:.1f}".format(
              *(b - a for a, b in zip(marks, marks[1:]))), flush=True)
    print(f"phase 9e (xLSTM and encoder-decoder): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        fail("; ".join(failures))
    return [row]


# ---------------------------------------------------------------------------
# phase 9f: the tools and the sharding policy (launch.roofline,
# models.sharding, moe_a2a across tp positions, runtime.elastic)
# ---------------------------------------------------------------------------

def _count_diff(got, want) -> str:
    """The ATen ops whose counts differ between two ``count_program``
    records (the first few), for a failure's message."""
    ops = sorted(set(got["ops"]) | set(want["ops"]))
    diff = [f"{k}: {got['ops'].get(k)} vs {want['ops'].get(k)}" for k in ops
            if got["ops"].get(k) != want["ops"].get(k)]
    return "; ".join(diff[:4])


def tools_prefill(torch, mods, cfgs, kops, fa, rate, name, failures):
    """(a) ``measure_program`` on qwen2-1.5B's prefill (9b's setup) against
    the card's roofline, its count equal to the CPU's at 2 layers and to
    ``meta``'s at full depth; (b) row 10's count of the first attention
    call against its bound's bytes and operations: (the kernels line's
    row)."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import roofline
    cfg = cfgs.get_config(_LM_ARCH)
    model = _lm_model(torch, mods, cfg, "cuda", _LM_SEED)
    batch = _lm_batch(torch, cfg, _LM_BATCH, _LM_PROMPT, _LM_SEED, "cuda")
    model.prefill(batch, _LM_MAX_LEN)                  # warm-up
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    with _Capture(kops) as cap:
        model.prefill(batch, _LM_MAX_LEN)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    if counts["flash_attention"] != cfg.n_layers or \
            sum(counts.values()) != cfg.n_layers:
        failures.append(f"tools (a): launches {dict(_nonzero(counts))}, want "
                        f"{cfg.n_layers} flash_attention a prefill")
    rec = roofline.measure_program(model.prefill, batch, _LM_MAX_LEN,
                                   warmup=2, iters=10)
    meta = mods.build_model(cfg, device="meta")
    on_meta = roofline.count_program(meta.prefill, {
        k: v.to("meta") for k, v in batch.items()}, _LM_MAX_LEN)
    if (on_meta["flops"], on_meta["bytes_accessed"]) != (
            rec["flops"], rec["bytes_accessed"]):
        failures.append("tools (a): the card's count differs from meta's: "
                        + _count_diff(roofline.count_program(
                            model.prefill, batch, _LM_MAX_LEN), on_meta))
    mf = roofline.model_flops(cfg, ShapeSpec("p", _LM_PROMPT, _LM_BATCH,
                                             "prefill"))
    attn = rec["kernels"].get("flash_attention", {})
    heavy = sorted(rec["ops"].items(), key=lambda kv: -kv[1]["bytes"])[:6]
    print(f"tools (a) measure_program {_LM_ARCH} prefill {_LM_BATCH}x"
          f"{_LM_PROMPT} (max_len {_LM_MAX_LEN}): counted flops "
          f"{rec['flops']}, bytes {rec['bytes_accessed']}, collective bytes "
          f"{rec['collective_bytes']}; model_flops {mf:.6g}; flash_attention "
          f"reports {attn}; measured {rec['measured_s'] * 1e3:.4f} ms (CUDA "
          f"events, 10 calls); roofline_bound_s {rec['roofline_bound_s']:.6g}"
          f" ({rec['dominant']}); achieved_fraction "
          f"{rec['achieved_fraction']:.4f}; model_flops / measured "
          f"{mf / rec['measured_s'] / 1e12:.1f} TFLOP/s "
          f"({mf / rec['measured_s'] / roofline.peaks(name).bf16:.4f} of the "
          f"dense bf16 peak); meta's count equal; launches "
          f"{dict(_nonzero(counts))}; {card_line()}", flush=True)
    print("tools (a) the count's heaviest ATen ops by bytes: " + "; ".join(
        f"{k} {v['calls']} calls {v['bytes']} B {v['flops']} FLOP"
        for k, v in heavy), flush=True)
    qkv = tuple(t.contiguous() for t in cap.first)
    del model, meta, cap
    torch.cuda.empty_cache()

    # the same program at 2 layers: the card's count against the CPU's
    small = dataclasses.replace(cfg, n_layers=2)
    cpu, gpu = _cpu_and_card(torch, mods, small, _LM_SEED)
    on_card = roofline.count_program(gpu.prefill, batch, _LM_MAX_LEN)
    on_cpu = roofline.count_program(cpu.prefill, {
        k: v.cpu() for k, v in batch.items()}, _LM_MAX_LEN)
    same = all(on_card[k] == on_cpu[k] for k in (
        "flops", "bytes_accessed", "collective_bytes", "kernels"))
    if not same:
        failures.append("tools (a): the 2-layer count on the card differs "
                        "from the CPU's: " + _count_diff(on_card, on_cpu))
    print(f"check tools (a) 2 layers: card count flops {on_card['flops']} "
          f"bytes {on_card['bytes_accessed']}, CPU flops {on_cpu['flops']} "
          f"bytes {on_cpu['bytes_accessed']}: "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    del cpu, gpu
    torch.cuda.empty_cache()

    # (b) row 10's count of the first call against its bound
    q, k, v = qkv
    c = roofline.count_program(fa.flash_attention, q, k, v, True)
    b, h, s, d = q.shape
    flops, nbytes = 4 * b * h * s * s * d // 2, 4 * b * h * s * d * 2
    if (c["flops"], c["bytes_accessed"], c["ops"]) != (flops, nbytes, {}):
        failures.append(f"tools (b): row 10's count {c['flops']}, "
                        f"{c['bytes_accessed']} (ops {c['ops']}); want "
                        f"{flops}, {nbytes}")
    bound, by = bound_ms(c["bytes_accessed"], c["flops"], rate,
                         card_rates(name).bf16)
    print(f"check tools (b) row 10 count {list(q.shape)} bf16 causal: flops "
          f"{c['flops']} (want {flops}), bytes {c['bytes_accessed']} (want "
          f"{nbytes}), bound {bound:.4f} ms ({by})", flush=True)
    return lm_attention_row(torch, fa, qkv, counts["flash_attention"], rate,
                            name, failures, part="prefill 9f")


def tools_moe(torch, cfgs, failures, devices=None):
    """(c) one deepseek-moe-16B MoE layer at full width, B 8 x S 512, on a
    1 x 4 ``ModelMesh`` naming cuda:0 four times (``devices``: a 1 x N
    mesh of N cards), its experts placed by ``params_shardings``, against
    the local path on the same card, on the local path's routing."""
    import numpy as np
    from torch_routing import Routed, forced, recorded

    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import ModelMesh, axes_of
    from repro_torch.models import moe, moe_a2a
    from repro_torch.models import sharding as shp
    cfg = cfgs.get_config(_MOE_ARCH)
    devices = devices or [torch.device("cuda", 0)] * 4
    tp = len(devices)
    gen = torch.Generator("cuda").manual_seed(_MOE_SEED)
    params = moe.init_moe(cfg, gen, "cuda")
    x = torch.randn((_MOE_BATCH, _MOE_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    with recorded() as probs:
        want, waux = moe_a2a.moe_ffn_a2a(params, x, cfg)
    mesh = ModelMesh(np.array(devices, dtype=object).reshape(1, tp),
                     ("data", "model"))
    axes = axes_of(mesh)
    shardings = shp.params_shardings(params, axes, mesh)
    placed = {k: shp.device_put(v, shardings[k]) for k, v in params.items()}
    rec = Routed(cfg.top_k, probs * tp)
    with shp.use_axes(axes, mesh):
        with forced(rec):
            got, aux = moe_a2a.moe_ffn_a2a(placed, x, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            moe_a2a.moe_ffn_a2a(placed, x, cfg)
        for dev in set(devices):
            torch.cuda.synchronize(dev)
        tp_ms = (time.perf_counter() - t0) / 3 * 1e3
        c = roofline.count_program(moe_a2a.moe_ffn_a2a, placed, x, cfg)
    local_ms = time_ms(torch, lambda: moe_a2a.moe_ffn_a2a(params, x, cfg),
                       reps=3, warm=1)
    what = f"tools (c) moe_ffn_a2a tp {tp} on {sorted({str(d) for d in devices})}"
    msg = rec.failure(_MOE_MARGIN[_MOE_ARCH], what)
    if msg:
        failures.append(msg)
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    rel = abs(float(aux) - float(waux)) / abs(float(waux))
    if not ok or not rel <= 1e-6:
        failures.append(f"{what}: max |diff| {err:.4g} against the local "
                        f"path (rtol = atol = 2e-2), aux relative {rel:.3g}")
    ar = c["kernels"].get("moe_a2a.all_reduce", {})
    print(f"check {what}: B {_MOE_BATCH} x S {_MOE_PROMPT}, {cfg.n_experts} "
          f"experts, {cfg.n_experts // tp} a rank, experts_w1's shard "
          f"{tuple(placed['experts_w1'].local((0, 0)).shape)}; against the "
          f"local path max |diff| {err:.4g} (rtol = atol = 2e-2), aux "
          f"{float(aux):.7g} vs {float(waux):.7g} (relative {rel:.3g}); "
          f"{rec.summary(_MOE_MARGIN[_MOE_ARCH])}; the all-reduce's counted "
          f"bytes {ar.get('collective_bytes')} ({ar.get('calls')} call); "
          f"{tp_ms:.3f} ms a call (host clock) against the local path's "
          f"{local_ms:.3f} (CUDA events)", flush=True)
    del params, placed, x, want, got
    torch.cuda.empty_cache()


def _state_bytes(state, mesh) -> int:
    from repro_torch.launch.mesh import axes_of
    from repro_torch.models import sharding as shp
    return shp.placed_bytes(state, shp.params_shardings(state, axes_of(mesh),
                                                        mesh))


def tools_elastic(torch, mods, cfgs, failures):
    """(d) ``reshard_state`` of a qwen2-1.5B ``TrainState`` (full width, 2
    layers, moments drawn) on the card from (1, 1) to (1, 4) to (2, 2) and
    back, every leaf bit-equal at each step; ``restore_for_mesh`` of a
    ``CheckpointManager`` checkpoint onto (2, 2), bit-equal."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.models import sharding as shp
    from repro_torch.runtime.elastic import reshard_state, restore_for_mesh
    from repro_torch.train import train_state_init
    cfg = dataclasses.replace(cfgs.get_config(_LM_ARCH), n_layers=2)
    model = _lm_model(torch, mods, cfg, "cuda", _LM_SEED)
    st = train_state_init(model)
    gen = torch.Generator("cuda").manual_seed(_LM_SEED)
    st = st._replace(opt=st.opt._replace(
        step=torch.tensor(7, dtype=torch.int32, device="cuda"),
        m={k: torch.randn(v.shape, generator=gen, device="cuda")
           for k, v in st.opt.m.items()},
        v={k: torch.rand(v.shape, generator=gen, device="cuda")
           for k, v in st.opt.v.items()}))

    def mesh_of(dp, tp):
        devs = np.empty((dp, tp), dtype=object)
        devs.fill(torch.device("cuda", 0))
        return ModelMesh(devs, ("data", "model"))

    def bad_leaves(placed, what):
        bad = []
        shp.tree_map(lambda path, got, ref: bad.append(path) if not (
            torch.equal(got.full(), ref)) else None, placed, st)
        if bad:
            failures.append(f"tools (d) {what}: leaves differ: {bad[:4]}")
        return len(bad)

    cur, lines = st, []
    for dp, tp in ((1, 1), (1, 4), (2, 2), (1, 1)):
        mesh = mesh_of(dp, tp)
        t0 = time.perf_counter()
        cur = reshard_state(cur, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bad = bad_leaves(cur, f"({dp}, {tp})")
        lines.append(f"({dp}, {tp}) largest position {_state_bytes(st, mesh)}"
                     f" B in {secs:.2f} s{'' if not bad else f', {bad} BAD'}")
    tmp = tempfile.mkdtemp(prefix="ckpt_")
    try:
        mgr = CheckpointManager(tmp, async_save=False)
        mgr.save(7, st)
        step, placed, _ = restore_for_mesh(tmp, cur, mesh_of(2, 2))
        bad = bad_leaves(placed, "restore_for_mesh (2, 2)")
        if step != 7:
            failures.append(f"tools (d) restore_for_mesh: step {step}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_leaves = len(st.params) * 3 + 1
    print(f"check tools (d) reshard_state {_LM_ARCH} 2 layers, {n_leaves} "
          f"leaves, {_state_bytes(st, mesh_of(1, 1))} B: "
          f"{'; '.join(lines)}; restore_for_mesh (2, 2) step {step}, "
          f"{'bit-equal' if not bad else f'{bad} leaves differ'}",
          flush=True)
    del model, st, cur, placed
    torch.cuda.empty_cache()


def run_tools(torch, fa, kops, rate, name, cards=False):
    """Phase 9f: the tools and the sharding policy; (rows of the kernels
    line). With ``cards`` only (c), over the cards the host has. Every part
    is checked and printed before the phase fails."""
    cfgs = importlib.import_module("repro_torch.configs")
    mods = importlib.import_module("repro_torch.models")
    t0 = time.perf_counter()
    failures, rows, marks = [], [], [t0]
    if cards:
        n = torch.cuda.device_count()
        tools_moe(torch, cfgs, failures,
                  [torch.device("cuda", i) for i in range(n)])
    else:
        rows.append(tools_prefill(torch, mods, cfgs, kops, fa, rate, name,
                                  failures))
        marks.append(time.perf_counter())
        tools_moe(torch, cfgs, failures)
        marks.append(time.perf_counter())
        tools_elastic(torch, mods, cfgs, failures)
        marks.append(time.perf_counter())
        print("phase 9f parts, s: (a) and (b) {:.1f}, (c) {:.1f}, (d) "
              "{:.1f}".format(*(b - a for a, b in zip(marks, marks[1:]))),
              flush=True)
    print(f"phase 9f (tools and sharding): {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failures:
        fail("; ".join(failures))
    return rows


# ---------------------------------------------------------------------------
# --faults: planted faults in the attention and build kernels against the
# checks of phase 9 and of the build
# ---------------------------------------------------------------------------

def _skip_k_tile(t: int):
    """K tile ``t`` is left out of every row that reads it."""
    return [("const bool masked = k0 + BK > s",
             f"const bool masked = kt == {t} || k0 + BK > s", 3),
            ("if (col >= s || (causal && col > row)) x = kNegInf;",
             f"if (kt == {t} || col >= s || (causal && col > row)) "
             "x = kNegInf;", 3)]


# fault -> (text, replacement, count) edits of csrc/flash_attention.cu, or
# of the source _FAULT_TARGETS names; the K-tile faults are planted in the
# float32 (3xTF32), wgmma and mma.sync kernels, the stale V tiles in the
# float32 and wgmma kernels, the dropped split in the combine of both
_FAULTS = {
    "skip_k_tile_5": _skip_k_tile(5),
    # keys 25,600-25,727 at the wgmma kernel's 128-key tiles: only rows past
    # 25,600 of a 32k head read it; their outputs are near 0.01, so the
    # fault moves them by less than 2e-2
    "skip_k_tile_200": _skip_k_tile(200),
    # the V tiles after tile 8 are not loaded: they read tile 8's values
    "stale_v_after_tile_8": [
        ("tma_load(vb + c * BK * 128, &tv, v_full + 8 * st, c * kChunk, "
         "kt * BK, head);",
         "tma_load(vb + c * BK * 128, &tv, v_full + 8 * st, c * kChunk, "
         "min(kt, 8) * BK, head);", 1),
        ("tf_tile<DP, BK>(Vs + stage * BK * LD, vh, tile * BK, s, d, vec);",
         "tf_tile<DP, BK>(Vs + stage * BK * LD, vh, min(tile, 8) * BK, s, d, "
         "vec);", 1)],
    # the keys past S are left unmasked: on the ragged path (S that the
    # tiles do not divide) a zero key past S scores 0 and takes weight
    "ragged_keys_unmasked": [
        ("if (col >= s || (causal && col > row)) x = kNegInf;",
         "if (causal && col > row) x = kNegInf;", 3)],
    # the split over K's combine weighs split 1 as 0 (only (d) splits)
    "combine_drops_split_1": [
        ("const float w = exp2f(pm[sp * rows + row] - mx);",
         "const float w = sp == 1 ? 0.f : exp2f(pm[sp * rows + row] - mx);",
         1)],
    # float32 by one TF32 product: the two products of the small parts are
    # left out (about 5e-4 relative an operand)
    "tf32x3_drops_small": [
        ("mma_tf32(cs, as, bb0, bb1);   // small * big", "// dropped", 1),
        ("mma_tf32(cs, ab, bs0, bs1);   // big * small", "// dropped", 1)],
    # the build: a ghost pop ends the slot's turn, so no group below pops
    # into the slot the ghost left looking empty
    "ghost_pop_ends_turn": [
        ("if (key != empty_key) break;", "break;", 1)],
    # the fused kernels: the copies of the tail tile's last partial group
    # of four rows are dropped (its rows read as rows past n: zero)
    "tail_group_dropped": [
        ("  const int v = group_rows(r0, n);\n  copy8(",
         "  const int v = group_rows(r0, n) == kRowsPerThread ? "
         "kRowsPerThread : 0;\n  copy8(", 1)],
    # the segmented sums: the scalar tail's 1-3 rows read as absent
    "seg_tail_dropped": [
        ("const long long hi = n - r0;",
         "const long long hi = r0 > 0 ? 0 : n - r0;", 1)],
    # the segmented sums: a run that crosses a warp step is joined without
    # its part in the steps before
    "seg_join_drops_carry": [("const A joined = Op::combine(acc.ls, next.fs);",
                              "const A joined = next.fs;", 1)],
    # min/max: a NaN folds as the key that loses, so it no longer
    # propagates
    "minmax_nan_loses": [("if (x != x) return kMin ? INT_MIN : INT_MAX;",
                          "if (x != x) return kMin ? INT_MAX : INT_MIN;", 1)],
    # the expansion probe's whole-row route: only the matches are stored,
    # the zeros past the count left unwritten
    "multi_zeros_unwritten": [
        ("    store_row(slots + i * M, row);",
         "    for (int j = 0; j < c; ++j) slots[i * M + j] = row[j];", 1)],
    # the expansion probe's group walk: the first group is read from its
    # base, not from the home slot (slots before the home visited)
    "multi_walk_from_group_base": [
        ("      if (go && j >= (int)(s & 3u)) {", "      if (go) {", 1)],
    # the exchange's metadata pass: a bytes key's first lane is left out of
    # its fold
    "partition_bytes_lane_skipped": [
        ("for (int b = 0; b < width; ++b) folded = folded * 31u + "
         "__ldg(row + b);",
         "for (int b = 1; b < width; ++b) folded = folded * 31u + "
         "__ldg(row + b);", 1)],
    # the fused kernels' YEAR: the last day of a leap year reads as the
    # next year
    "year_last_day": [("(4 * (d + 365) + 3) / 1461", "(4 * (d + 365) + 4) / 1461",
                       1)],
    # the fused kernels' BYTESMATCH: a later part of a contains is searched
    # from the row's start, not from the end of the previous part's hit
    "bytesmatch_parts_from_zero": [("    int at = from;", "    int at = 0;", 1)],
    # the standalone histogram: the ids past the last full 512-id block
    # are left out
    "hist_tail_dropped": [
        ("    int id = i < n ? ids[i] : -1;\n"
         "    if ((unsigned)id >= (unsigned)num_bins) id = -1;\n"
         "    add_grouped(hist, id);",
         "    int id = base + kThreads <= n ? ids[i] : -1;\n"
         "    if ((unsigned)id >= (unsigned)num_bins) id = -1;\n"
         "    add_grouped(hist, id);", 1)],
    # the single-match probe: a run that reaches the end of a 32-byte
    # sector of slots ends there as a miss
    "probe_run_cut_short": [
        ("      return true;\n    }\n    if (k == empty_key) break;",
         "      return true;\n    }\n    if (k == empty_key || (s & 7) == 7) "
         "break;", 1)],
}
# the cases that must fail under a fault, beyond the run's exit
_FAULT_CASES = {"skip_k_tile_200": ("prefill_32k bf16",),
                "ragged_keys_unmasked": ("ragged_1000 bf16 full",
                                         "ragged_1000 f32 full"),
                "combine_drops_split_1": ("d160 bf16", "d192 bf16",
                                          "d160 f32", "d192 f32"),
                "tf32x3_drops_small": ("train_4k f32", "d160 f32",
                                       "d192 f32"),
                "ghost_pop_ends_turn": ("ghosts_over_a_run",),
                "tail_group_dropped": ("Q1 n=999999",),
                "year_last_day": ("YEAR synthetic",),
                "bytesmatch_parts_from_zero": ("BYTESMATCH synthetic",),
                "seg_tail_dropped": ("tail n%4=1", "tail n%4=2",
                                     "tail n%4=3"),
                "seg_join_drops_carry": ("sorted G=16", "counts G=16"),
                "minmax_nan_loses": ("specials f32 G=4096",),
                "multi_zeros_unwritten": ("duplicates m=4",),
                "multi_walk_from_group_base": ("duplicates m=4",
                                               "wrap T=64"),
                "partition_bytes_lane_skipped": ("bytes W=4", "views W=4"),
                "hist_tail_dropped": ("grace n=1500000 P=64",
                                      "grace n=100003 P=8",
                                      "grace W=4 n=1048579 P=64"),
                "probe_run_cut_short": ("dense T=1024",)}
_ATTN_CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                        "flash_attention.cu")
_TABLE_CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                         "hash_table.cu")
_INTERP_CUH = os.path.join("src", "repro_torch", "kernels", "csrc",
                           "fused_interp.cuh")
_SEG_CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                       "segmented_agg.cu")
_RADIX_CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                         "radix_histogram.cu")
_PROBE_CUH = os.path.join("src", "repro_torch", "kernels", "csrc",
                          "hash_probe.cuh")
# fault -> (source it edits, the run that must catch it); the rest edit
# the attention kernels and run phase 9 alone
_FAULT_TARGETS = {"ghost_pop_ends_turn": (_TABLE_CU, "--build"),
                  "tail_group_dropped": (_INTERP_CUH, "--fused"),
                  "year_last_day": (_INTERP_CUH, "--fused"),
                  "bytesmatch_parts_from_zero": (_INTERP_CUH, "--fused"),
                  "seg_tail_dropped": (_SEG_CU, "--segmented"),
                  "seg_join_drops_carry": (_SEG_CU, "--segmented"),
                  "minmax_nan_loses": (_SEG_CU, "--segmented"),
                  "multi_zeros_unwritten": (_TABLE_CU, "--probe"),
                  "partition_bytes_lane_skipped": (_RADIX_CU, "--partition"),
                  "hist_tail_dropped": (_RADIX_CU, "--partition"),
                  "probe_run_cut_short": (_PROBE_CUH, "--probe"),
                  "multi_walk_from_group_base": (_PROBE_CUH, "--probe")}
# the cases of the fused checks a fault may name (check_fused's views)
_FUSED_CASES = tuple(f"Q{q}{label}" for q in (1, 6) for label in (
    "", *(f" {v}" for v, _ in _FUSED_VIEWS))) + ("YEAR synthetic",
                                                  "BYTESMATCH synthetic")


def fault_target(fault: str):
    """(source, ``chip_smoke.py`` option) of a planted fault."""
    return _FAULT_TARGETS.get(fault, (_ATTN_CU, "--attention"))


def _run_alone(root: str, option: str) -> dict:
    """``chip_smoke.py OPTION`` (``--attention``, ``--build``, ``--fused``,
    ``--segmented``, ``--probe`` or ``--partition``) in ``root``: its exit
    code, each attention case's [max |kernel - plain|, scaled error] and
    its failure message."""
    import re
    case = re.compile(r"^check (flash_attention\[[^\]]+\]) .*max \|kernel"
                      r" - plain\| (\S+) \(tol .*scaled error (\S+) \(tol")
    out = subprocess.run([sys.executable, "chip_smoke.py", option],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    cases = {}
    for line in out.stdout.splitlines():
        if line.startswith(("check flash_attention", "check build_table",
                            "check fused", "check segmented",
                            "check partition_histogram", "check hash_probe",
                            "check radix_histogram")):
            print(line, flush=True)
        m = case.match(line)
        if m:
            cases[m.group(1)] = [float(m.group(2)), float(m.group(3))]
    failed = [ln for ln in out.stderr.splitlines() if "FAILED" in ln]
    print(f"rc {out.returncode} {failed[-1] if failed else ''}", flush=True)
    return {"rc": out.returncode, "cases": cases,
            "failed": failed[-1] if failed else None}


def run_faults(here: str) -> int:
    """``--faults``: phase 9 alone, the build checks alone, the fused
    checks alone, the segmented sums' cases alone, the probe's cases alone
    and the metadata pass's cases alone on the kernels as they are, then
    once for each fault of ``_FAULTS`` in a copy
    of ``chip_smoke.py`` and ``src/repro_torch`` in a temporary directory,
    with the fault planted in the copy's source (``fault_target``). Prints
    each run's check lines and, last, ``{run: {"rc", "cases", "failed"}}``;
    returns 0 when the kernels as they are pass and every fault fails, at
    the cases ``_FAULT_CASES`` names."""
    results = {}
    for option in ("--attention", "--build", "--fused", "--segmented",
                   "--probe", "--partition"):
        print(f"== as it is {option}", flush=True)
        results[f"as_it_is {option}"] = _run_alone(here, option)
    for fault, edits in _FAULTS.items():
        source, option = fault_target(fault)
        tmp = tempfile.mkdtemp(prefix="kernel_fault_")
        try:
            shutil.copy(os.path.join(here, "chip_smoke.py"), tmp)
            shutil.copytree(os.path.join(here, "src", "repro_torch"),
                            os.path.join(tmp, "src", "repro_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            path = os.path.join(tmp, source)
            with open(path) as f:
                text = f.read()
            for old, new, count in edits:
                if text.count(old) != count:
                    fail(f"{fault}: {old!r} occurs {text.count(old)} "
                         f"times, want {count}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            print(f"== {fault}", flush=True)
            results[fault] = _run_alone(tmp, option)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(results), flush=True)
    clean = all(r["rc"] == 0 for k, r in results.items()
                if k.startswith("as_it_is"))
    caught = all(r["rc"] != 0 and all(
        f"[{case}]" in (r["failed"] or "") for case in _FAULT_CASES.get(k, ()))
        for k, r in results.items() if not k.startswith("as_it_is"))
    return 0 if clean and caught else 1


_PORT_KERNELS = ("segmented_sum_kernel", "fused_morsel_kernel",
                 "fused_batch_kernel",
                 "hash_build_claim_kernel", "hash_build_place_kernel",
                 "build_compact_kernel", "build_sort_kernel",
                 "build_levels_kernel", "build_resolve_kernel",
                 "hash_probe_kernel", "segmented_minmax_kernel",
                 "fill_kernel", "block_prefix_sum_kernel",
                 "hash_probe_multi_kernel", "hash_probe_multi_staged_kernel",
                 "hash_probe_multi_slots_kernel",
                 "histogram_shared_kernel", "histogram_global_kernel",
                 "partition_histogram_kernel",
                 "attn_tf32x3_kernel", "attn_wgmma_kernel",
                 "attn_combine_kernel", "attn_mma_kernel")
# the kernel symbols each launcher of profile_kernels runs (the build below
# table_size rows is ceil(log2 T / 8) + 3 kernels, from table_size rows two
# a round; attention at (d) is the float32 or wgmma kernel and its combine)
_KERNEL_SYMBOLS = {
    "segmented_sum": ("segmented_sum_kernel<float",),
    "segmented_int_sum": ("segmented_sum_kernel<int",),
    "fused": ("fused_morsel_kernel",),
    "build_table": ("build_compact_kernel", "build_sort_kernel",
                    "build_levels_kernel", "build_resolve_kernel",
                    "hash_build_claim_kernel", "hash_build_place_kernel"),
    "hash_probe": ("hash_probe_kernel",),
    "block_prefix_sum": ("block_prefix_sum_kernel",),
    "segmented_minmax": ("segmented_minmax_kernel", "fill_kernel"),
    "hash_probe_multi": ("hash_probe_multi_kernel",
                         "hash_probe_multi_staged_kernel",
                         "hash_probe_multi_slots_kernel"),
    "radix_histogram": ("partition_histogram_kernel",
                        "histogram_shared_kernel", "histogram_global_kernel"),
    "fused_batch_program": ("fused_batch_kernel",),
    "flash_attention": ("attn_tf32x3_kernel", "attn_mma_kernel",
                        "attn_wgmma_kernel", "attn_combine_kernel")}
# the attention kernels, for phase 9's account of what each case ran
_ATTN_KERNELS = _KERNEL_SYMBOLS["flash_attention"]


# a profile that comes back without the device events it should hold is
# taken again, up to this many times in all
_PROFILE_ATTEMPTS = 5
# seconds of idle card at each end of a profile's window
_PROFILE_MARGIN_S = 0.02


def _profiled(torch, body, cpu=False):
    """(``torch.profiler`` profile, ``body()``'s result) of one run of
    ``body``, device events only unless ``cpu``. The card is synchronised
    and left idle for ``_PROFILE_MARGIN_S`` at each end of the window: the
    profiler drops a device event whose times, put on the host's clock,
    fall outside its window, and without the margins a kernel that ends
    just before the closing synchronize lies within microseconds of its
    edge."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(_PROFILE_MARGIN_S)
        out = body()
        torch.cuda.synchronize()
        time.sleep(_PROFILE_MARGIN_S)
    return prof, out


def _device_events(prof):
    """(name, count, device microseconds) of the device-side events (kernels,
    copies, fills) in a profile; CPU-side operator rows are left out, since
    their device time repeats that of the kernels they launched."""
    from torch.autograd import DeviceType
    rows = [[e.key, e.count, e.self_device_time_total]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


def _host_events(prof, top: int = 15):
    """(name, count, self host microseconds) of the busiest host-side rows:
    torch operators and CUDA runtime calls."""
    from torch.autograd import DeviceType
    rows = [[e.key, e.count, e.self_cpu_time_total]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def profile_kernels(torch, launchers, reps: int = 20):
    """Device milliseconds per launch of each kernel at the main path's
    shapes, from ``torch.profiler`` (launch overhead on the host excluded),
    and the kernels each call launches; fails unless ``block_prefix_sum``
    is one kernel a call."""
    out, per_call = {}, {}
    for name, fn in launchers.items():
        key = name.partition("[")[0]
        keys = _KERNEL_SYMBOLS.get(key, _KERNEL_SYMBOLS["fused"])
        fn()
        torch.cuda.synchronize()
        # a profile now and then comes back without some or all of the
        # device's events (CUPTI); such a profile is taken again
        for attempt in range(_PROFILE_ATTEMPTS):
            prof, _ = _profiled(torch, lambda: [fn() for _ in range(reps)],
                                cpu=key == "build_table")
            events = _device_events(prof)
            hits = [r for r in events if any(k in r[0] for k in keys)]
            launched = sum(r[1] for r in hits)
            if hits and launched >= reps and launched % reps == 0:
                break
            print(f"profile of {name}: {launched} device events for {reps} "
                  f"calls in attempt {attempt + 1}; all device events "
                  f"{[(r[0][:60], r[1]) for r in events]}", flush=True)
        if not hits or launched < reps or launched % reps:
            fail(f"profile of {name}: {launched} kernel events matching "
                 f"{keys!r} for {reps} calls")
        out[name] = sum(r[2] for r in hits) / reps / 1e3
        per_call[name] = launched // reps
        if key == "block_prefix_sum":
            # one pass: one kernel and one memset of its scratch a call
            print(f"profile of {name}: device events a call "
                  f"{[(r[0][:60], r[1] / reps) for r in events]}", flush=True)
            if launched != reps:
                fail(f"profile of {name}: {launched / reps} kernel launches "
                     "a call, want 1")
        if key == "build_table":
            # a fixed number of passes: the build's kernels, its memset and
            # the table's two fills, and nothing read back or waited for
            syncs = _syncs({e.key for e in prof.key_averages()})
            breakdown = [(r[0][:60], r[1] / reps, r[2] / reps)
                         for r in events]
            print(f"profile of {name}: device events a call (name, count, "
                  f"us) {breakdown}; read-backs and syncs {syncs}",
                  flush=True)
            if syncs:
                fail(f"profile of {name}: {syncs} inside the build")
    print(f"device_ms per launch: {json.dumps(out)}", flush=True)
    print(f"kernel launches a call: {json.dumps(per_call)}", flush=True)
    return out


def profile_main_path(torch, gpu, catalog, out_dir, workers=1):
    """One profiled warm run of each query planned for ``workers`` workers
    (``torch.profiler``) on the session ``gpu``: device time by kernel,
    device busy time and idle share of the wall time. The profiler's own
    overhead lengthens the wall time it is divided by."""
    from repro_torch.tpch import queries

    os.makedirs(out_dir, exist_ok=True)
    tag = "" if workers == 1 else f"w{workers}_"
    for q in _QUERIES:
        plan = queries.build_query(q, catalog, num_workers=workers)

        def run():
            t0 = time.perf_counter()
            gpu.execute(plan)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for attempt in range(_PROFILE_ATTEMPTS):  # as in profile_kernels
            prof, wall = _profiled(torch, run, cpu=True)
            rows = _device_events(prof)
            if rows:
                break
            print(f"profile of Q{q}: no device events in attempt "
                  f"{attempt + 1}", flush=True)
        if not rows:
            fail(f"profile of Q{q}: no device events")
        busy_us = sum(r[2] for r in rows)
        h2d = [r for r in rows if r[0].startswith("Memcpy HtoD")]
        port = [r for r in rows if any(k in r[0] for k in _PORT_KERNELS)]
        kernels = [r for r in rows if not r[0].startswith("Mem")]
        summary = {"query": q, "workers": workers, "wall_s": wall,
                   "device_busy_us": busy_us,
                   "idle_share": 1.0 - busy_us / (wall * 1e6),
                   "h2d_us": sum(r[2] for r in h2d),
                   "h2d_copies": sum(r[1] for r in h2d),
                   "kernel_launches": sum(r[1] for r in kernels),
                   "port_kernels_us": sum(r[2] for r in port),
                   "other_kernels_us": (sum(r[2] for r in kernels)
                                        - sum(r[2] for r in port)),
                   "by_kernel": rows, "host_top": _host_events(prof)}
        with open(os.path.join(out_dir, f"profile_{tag}q{q}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{tag}q{q}.json.gz"))
        print(json.dumps({"profile": dict(summary, by_kernel=rows[:8],
                                          host_top=summary["host_top"][:8])}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the 22 queries and write the "
                         "summaries and (gzipped) traces into DIR")
    ap.add_argument("--attention", action="store_true",
                    help="run phase 9 alone (the attention kernel's "
                         "checks and times) and print its kernels line; "
                         "prints no ok line")
    ap.add_argument("--lm", action="store_true",
                    help="run phase 9b alone (qwen2-1.5B at full width: "
                         "prefill and greedy decode, against forward and "
                         "the CPU, the prefill's attention kernel; the "
                         "other dense configs at 2 layers) and print its "
                         "kernels line; prints no ok line")
    ap.add_argument("--train", action="store_true",
                    help="run phase 9c alone (qwen2-1.5B at full width "
                         "taking AdamW steps on a corpus the engine "
                         "filtered on the card, one step against the CPU "
                         "at 2 layers, the fault-tolerant loop's exact "
                         "recovery) and print its kernels line; prints no "
                         "ok line")
    ap.add_argument("--moe", action="store_true",
                    help="run phase 9d alone (deepseek-moe-16B at full "
                         "width and depth: prefill and greedy decode, "
                         "against forward and the CPU; dbrx-132B and "
                         "jamba-v0.1 at a few layers; a MoE training step "
                         "against the CPU) and print its kernels line; "
                         "prints no ok line")
    ap.add_argument("--xlstm-encdec", action="store_true",
                    help="run phase 9e alone (xlstm-125M and "
                         "seamless-m4t-large-v2 at full width and depth: "
                         "prefill and greedy decode, against forward and "
                         "the CPU, a training step each against the CPU, "
                         "the encoder's attention kernel at a ragged S) "
                         "and print its kernels line; prints no ok line")
    ap.add_argument("--tools", action="store_true",
                    help="run phase 9f alone (measure_program on "
                         "qwen2-1.5B's prefill against the card's roofline, "
                         "its count against the CPU's and meta's, row 10's "
                         "count, moe_ffn_a2a at tp 4 against the local "
                         "path, reshard_state and restore_for_mesh "
                         "bit-equal) and print its kernels line; prints no "
                         "ok line")
    ap.add_argument("--build", action="store_true",
                    help="run the build checks of phase 3 alone (the "
                         "synthetic cases, the route and the launches); "
                         "prints no ok line")
    ap.add_argument("--fused", action="store_true",
                    help="run the fused kernels' checks alone (Q1's and Q6's "
                         "stages on a lineitem morsel and its views, the "
                         "three serving batch programs, YEAR and "
                         "BYTESMATCH); prints no ok line")
    ap.add_argument("--segmented", action="store_true",
                    help="run the segmented sums' cases alone (synthetic "
                         "ids: sorted, unsorted, dead, ragged, offset, "
                         "G=8192/8193, a merge's 2^24 rows); prints no ok "
                         "line")
    ap.add_argument("--probe", action="store_true",
                    help="run the standalone probe's synthetic cases alone "
                         "(small tables, runs across sectors and wrapping, "
                         "max_probes inside a sector, views); prints no ok "
                         "line")
    ap.add_argument("--partition", action="store_true",
                    help="run the exchange's metadata pass's synthetic "
                         "cases alone (each W, n of 0 to 2^22, bytes and "
                         "cast keys, views); prints no ok line")
    ap.add_argument("--storage", action="store_true",
                    help="run the storage phase alone (the 22 queries read "
                         "from column-chunk files at SF 1, skipping off, "
                         "the synchronous scan, W=4, the paged format, the "
                         "host round trip, one timed copy); prints no ok "
                         "line")
    ap.add_argument("--sql", action="store_true",
                    help="run the SQL phase alone (the 20 TPC-H texts at "
                         "W=1 and W=4, unoptimized texts, YEAR and "
                         "BYTESMATCH against their plain version, the "
                         "sorted-key join, SQL-born serving); prints no ok "
                         "line")
    ap.add_argument("--spill", action="store_true",
                    help="run the out-of-core phase alone (the 22 queries "
                         "at W=1 under a quarter of their footprint, the "
                         "disk tier, W=4, the scheduler's over-budget "
                         "query, the bytes-aware prefetcher, the grace "
                         "join's histogram); prints no ok line")
    ap.add_argument("--adaptive", action="store_true",
                    help="run the adaptive phase alone (the 22 queries "
                         "cold then warm on a feedback store at W=1 and "
                         "W=4, each held against the port's oracle, the "
                         "scheduler's q-error eviction, warm estimates and "
                         "the warm Q3 under the forced budget); prints no "
                         "ok line")
    ap.add_argument("--mesh", action="store_true",
                    help="run the mesh phase alone (the 22 queries at W=4 "
                         "on a one-card mesh against the same plans off "
                         "it, W=2 and HostExchange on it, the data phase's "
                         "ms, the device guard, serving, out of core and "
                         "adaptive execution on the mesh, and a mesh over "
                         "the cards where there are several); prints no ok "
                         "line")
    ap.add_argument("--cards", action="store_true",
                    help="run part (b) of the mesh phase alone (the 22 at "
                         "W=4 on a mesh of 2-4 cards, then serving, out of "
                         "core and adaptive execution for Q3, Q5 and Q18 "
                         "across them, against the off-mesh runs); prints "
                         "no ok line")
    ap.add_argument("--faults", action="store_true",
                    help="run phase 9, the build checks, the fused checks "
                         "and the segmented cases alone on the kernels as "
                         "they are and with each planted "
                         "fault, in temporary copies; exits 0 when every "
                         "fault is caught")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail("src/repro_torch is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    if args.faults:
        sys.exit(run_faults(here))
    sys.path.insert(0, src)
    sys.path.append(os.path.join(here, "tests"))     # torch_routing
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from repro_torch.core import fused
    from repro_torch.core.session import Catalog
    from repro_torch.core.table import TorchTable
    from repro_torch.kernels import block_prefix_sum as bps
    from repro_torch.kernels import build
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import radix_histogram as rh
    from repro_torch.kernels import segmented_agg as seg
    from repro_torch.tpch import dbgen, queries, schema

    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    rate = card_rates(name).hbm
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}"
          f" memory rate {rate:.3g} B/s, dense bfloat16 rate "
          f"{card_rates(name).bf16:.4g} op/s", flush=True)

    t0 = time.perf_counter()
    ptxas_dir = tempfile.mkdtemp(prefix="ptxas_")
    ptxas = start_ptxas(build, ptxas_dir)
    secs = build.build_all()
    print(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.3f} s",
          flush=True)
    check_ptxas(ptxas)
    shutil.rmtree(ptxas_dir, ignore_errors=True)
    # the module (the package's attribute of that name is the function)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    if args.attention:
        attn_rows, _ = run_attention(torch, fa, kops, rate, name)
        print(json.dumps({"kernels": attn_rows}))
        print(card)
        return
    if args.lm:
        print(json.dumps({"kernels": run_lm(torch, fa, kops, rate, name)}))
        print(card)
        return
    if args.train:
        print(json.dumps({"kernels": run_train(torch, fused, kops, rate,
                                               here)}))
        print(card)
        return
    if args.moe:
        print(json.dumps({"kernels": run_moe(torch, fa, kops, rate, name)}))
        print(card)
        return
    if args.xlstm_encdec:
        print(json.dumps({"kernels": run_xlstm_encdec(torch, fa, kops, rate,
                                                      name)}))
        print(card)
        return
    if args.tools:
        print(json.dumps({"kernels": run_tools(torch, fa, kops, rate,
                                               name)}))
        print(card)
        return
    if args.build:
        run_build(torch, hp)
        print(card)
        return
    if args.segmented:
        run_segmented(torch, seg)
        print(card)
        return
    if args.probe:
        run_probe(torch, hp)
        print(card)
        return
    if args.partition:
        run_partition(torch, rh)
        print(card)
        return
    # the storage phase's files, removed when the script exits
    storage_dir = tempfile.mkdtemp(prefix="tpch_files_")
    atexit.register(shutil.rmtree, storage_dir, True)
    if args.storage:
        run_storage(torch, storage_dir)
        print(card)
        return

    t0 = time.perf_counter()
    data = dbgen.generate(_SF)
    lineitem = data["lineitem"]
    n = len(lineitem["l_orderkey"])
    print(f"dbgen SF {_SF}: lineitem {n} rows in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    catalog = Catalog.from_numpy(
        data, schema.SCHEMAS, {t: (k,) for t, k in schema.PRIMARY_KEYS.items()})

    # the fused kernel on one main-path morsel of real lineitem rows
    n = min(n, _MAIN_ROWS)
    morsel = TorchTable.from_numpy({c: v[:n] for c, v in lineitem.items()},
                                   dbgen.S.LINEITEM, capacity=_MAIN_ROWS,
                                   device="cuda")
    if args.fused:
        check_fused(torch, fused, queries, catalog, morsel, rate)
        check_batch(torch, fused, catalog, data, rate)
        check_sql_instructions(torch, fused, catalog, data, rate)
        print(card)
        return
    if args.sql:
        run_sql(torch, fused, catalog, data, rate)
        print(card)
        return
    if args.spill:
        spill_rows, spill_launchers = run_spill(torch, rh, catalog, rate)
        grace_device_ms(torch, spill_rows, spill_launchers)
        print(json.dumps({"kernels": spill_rows}))
        print(card)
        return
    if args.adaptive:
        run_adaptive(torch, catalog, data)
        print(card)
        return
    if args.mesh:
        run_mesh(torch, rh, catalog, data)
        print(card)
        return
    if args.cards:
        run_mesh_cards(torch, catalog)
        run_tools(torch, fa, kops, rate, name, cards=True)
        print(card)
        return
    rows_out, launchers = check_fused(torch, fused, queries, catalog, morsel,
                                      rate)
    calls = capture_calls(torch, hp, fused, catalog)
    for more_rows, more_launchers in (
            check_segmented(torch, seg, rate, calls["seg"],
                            stacked_call(torch, fused, catalog, data)),
            check_join(torch, hp, fused, calls, rate),
            check_compact(torch, bps, calls, rate),
            check_prefix_code(torch, fused, calls, rate)):
        rows_out += more_rows
        launchers.update(more_launchers)
    check_minmax(torch, seg, calls["minmax"])
    check_multi(torch, hp, calls["multi"])
    probe_calls, multi_calls, minmax_calls = (calls["probe"], calls["multi"],
                                              calls["minmax"])
    del calls

    launches, gpu, results, walls = run_main_path(torch, data, catalog)
    w4_calls = capture_workers(torch, hp, fused, catalog)
    check_worker_joins(torch, hp, fused, w4_calls)
    check_exchange(torch, rh, w4_calls["repartition"])
    probe_calls += w4_calls["probe"]
    multi_calls += w4_calls["multi"]
    minmax_calls += w4_calls["minmax"]
    repartitions = w4_calls["repartition"]
    del w4_calls
    w4_launches, gpu4 = run_distributed(torch, catalog, results)
    storage_sessions = run_storage(torch, storage_dir)
    sql_rows, sql_launchers = run_sql(torch, fused, catalog, data, rate,
                                      results, walls)
    rows_out += sql_rows
    launchers.update(sql_launchers)
    spill_rows, spill_launchers = run_spill(torch, rh, catalog, rate, results,
                                            walls)
    rows_out += spill_rows
    launchers.update(spill_launchers)
    answers = run_adaptive(torch, catalog, data)
    t0 = time.perf_counter()
    batch_rows, batch_launchers = check_batch(torch, fused, catalog, data,
                                              rate)
    rows_out += batch_rows
    launchers.update(batch_launchers)
    batch_launches, serving_builders, serving_counts = run_serving(
        torch, catalog, data)
    run_dashboard(torch, catalog, results)
    print(f"phase 8 (serving): {time.perf_counter() - t0:.1f} s", flush=True)
    run_mesh(torch, rh, catalog, data, results, answers)
    t0 = time.perf_counter()
    attn_rows, attn_launchers = run_attention(torch, fa, kops, rate, name)
    rows_out += attn_rows
    launchers.update(attn_launchers)
    print(f"phase 9 (attention): {time.perf_counter() - t0:.1f} s",
          flush=True)
    # phase 3's build launches, profiled after phase 9's profiles
    failures = []
    check_build_launches(torch, hp, failures)
    if failures:
        fail("; ".join(failures))
    segmented_device_ms(torch, rows_out, launchers)
    sql_device_ms(torch, rows_out, launchers)
    grace_device_ms(torch, rows_out, launchers)
    # the main path's probe, expansion probe, min/max and repartition
    # shapes, each call timed
    for more_rows, more_launchers in (
            probe_row(torch, hp, probe_calls, rate),
            multi_rows(torch, hp, multi_calls, rate),
            minmax_row(torch, seg, minmax_calls, rate),
            partition_row(torch, rh, repartitions, rate)):
        rows_out += more_rows
        launchers.update(more_launchers)
    del probe_calls, multi_calls, minmax_calls, repartitions
    if args.profile:
        device_ms = profile_kernels(torch, launchers)
        for r in rows_out:
            r["device_ms"] = device_ms[r["name"]]
        profile_main_path(torch, gpu, catalog, args.profile)
        profile_main_path(torch, gpu4, catalog, args.profile, _WORKERS)
        profile_storage(torch, *storage_sessions, args.profile)
        # last: after a profile of the multi-threaded serving run, every
        # profile of 20 kernel launches on this thread records 19, even
        # with every scheduler and prefetch thread joined
        profile_serving(torch, catalog, serving_builders, args.profile)
    # phases 9b-9e last: a profile taken after 9b lost one kernel event of
    # ten
    rows_out += run_lm(torch, fa, kops, rate, name)
    rows_out += run_train(torch, fused, kops, rate, here)
    rows_out += run_moe(torch, fa, kops, rate, name)
    rows_out += run_xlstm_encdec(torch, fa, kops, rate, name)
    rows_out += run_tools(torch, fa, kops, rate, name)
    for r in rows_out:
        if "launches" in r:   # phase 9 counted its own path
            continue
        if r["name"].startswith("fused_batch_program["):
            # this program's stacked launches in the serving run
            r["launches"] = batch_launches[r["name"][20:-1]]
            continue
        if r["name"] == "segmented_sum[stacked]":
            r["launches"] = serving_counts["segmented_sum"]
            continue
        key, _, q = r["name"].partition("[Q")
        # the exchange's kernel runs only with several workers
        source = (w4_launches if key == "radix_histogram" or "W=" in q
                  else launches)
        per_query = ([source[int(q.rstrip("]").split()[0])]] if q
                     else source.values())
        r["launches"] = sum(c[key] for c in per_query)
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
