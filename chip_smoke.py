#!/usr/bin/env python3
"""Drive the PyTorch port's ALS loop (batch, speed, serving), k-means path
and random decision forest on one CUDA card and check every step.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Imports nothing of JAX or of the reference package
``oryx_tpu``. Phases, each printing one JSON object per line:

  env      torch/CUDA versions, the card's name and power limit (the raw
           ``nvidia-smi`` line is printed on its own line too);
  build    every kernel built from ``oryx_tpu_torch/ops/csrc`` into
           ``build/`` (one ``nvcc`` per source, started together); the
           registers and spill bytes ``ptxas -v`` logged for each SPD kernel
           and each of the sweep's kernels (a spill fails);
  data     a seeded synthetic implicit dataset at the batch benchmark's
           training shape — 100,000 users × 10,000 items, ~1,000,000
           interactions with planted rank-5 preferences and power-law item
           popularity (exponent −0.8) — as CSV lines through
           ``data.prepare``, with a 10% hold-out;
  kernels  each kernel against its plain PyTorch version on the card, on
           the first packed block of each side of that data (k = 50;
           gather-Gramian in float32 and bfloat16), timed with CUDA events
           beside the plain version, a one-call library equivalent where
           one exists, and the card's bound for the same work; the
           gather-Gramian also with its work-unit schedule reported (units,
           split rows, largest unit, workspace bytes), called twice for
           the same bits, timed by bare launches and through its wrapper,
           and beside a ``torch.bmm`` of the pre-gathered slab (per-slot
           products only); the SPD solve also on 7,692 seeded systems at
           k = 10 (the reference's default; warp kernel) and k = 128 (CTA
           kernel), and each k <= 64 beside the CTA kernel on the same
           systems (both SPD kernels timed by bare launches of their C
           entries, the wrapper apart;
           the reference's fused elimination step's float64 error is
           reported beside the plain version's);
  spd_crossover
           the warp and CTA SPD kernels on the same 7,692 seeded systems at
           k = 1 .. 65, around the warp kernel's templates and crossover;
  train    the main path: ``als_train`` (k = 50, λ = 1, α = 1, implicit,
           3 iterations, float32) with the launch counters set to 0 just
           before; both kernels must have launched once per row block per
           iteration, at each side's block shape, the SPD solve in its warp
           kernel, and the gather-Gramian's reduce once per iteration for
           each block whose schedule has a split row; factors finite;
           hold-out AUC > 0.75;
  serve    the trained model loaded into ``ALSServingModel``: 256 users'
           ``top_n_batch(how_many=10)`` excluding their training items,
           checked against an exact float64 scan (overlap >= 0.99); the
           counters are read after it;
  als_durability
           trainer checkpoints and the layout cache on the train's batch
           and Y₀, the launch counters set to 0 first and read last, the
           first launch at each shape held against the plain version: a
           train checkpointing every iteration (its factors bit-equal to
           the train's; ``ckpt_wait_s``, the files, one save's bytes and
           seconds), a resume from step 1 after every later file is
           deleted (``ckpt_resumed_from`` 1, one more
           ``oryx_checkpoint_resumes_total``, the factors within 1e-5 of
           the uninterrupted run's, bit-equality reported) and a resume at
           the final step (no kernel launched); one ``BlockedLayoutCache``
           over the batch less a 1% row-wise extension (``full``), the
           whole batch (``delta`` on both sides) and the same arrays again
           (``reused``): pack seconds, blocks touched, peak device memory,
           each cached side bit-equal to a fresh pack, schedules included,
           the delta's factors bit-equal to the train's; the same share
           held out of the first user block's users (``one_block``); and
           two ``ALSUpdate.run_update`` with checkpoints on over the same
           lines and offsets (the first ``DURABILITY_USERS`` users'), a
           generation and its crash-restart: origins ``scratch`` then
           ``resume``, one generation id ``"g" + fingerprint[:12]``, the
           restart launching no kernel and publishing the same factors;
  serve_flagship
           1,000,000 items × 50 features (seeded), ``top_n_batch`` timed
           at batch 1, 16 and 256, top-10, checked against an exact scan;
           and ``y_snapshot()`` with nothing changed, 1,000 calls timed on
           the host (median and p90 microseconds);
  serving_quant
           the serving representations, the launch counters set to 0
           first (no kernel may launch): on the flagship's items (the
           models share its store) int8, bfloat16 and float32 with LSH at
           0.3, ``top_n_batch`` at batch 1, 16 and 256 timed beside
           float32 on the host, overlap with an exact float64 scan, every
           int8 score within 1e-4 relative of its float64 dot, every LSH
           answer in a candidate bucket of its query, the int8 snapshot's
           bytes n·k + 4n; the device programs alone (int8 scan, bf16 scan,
           LSH-masked scan) by CUDA events at batch 16 and 256 beside the
           float32 scan and each one's bound; the int8 scan's transient
           (``max_memory_allocated`` over a scan, reset before, less what
           was allocated before) below one float32 copy of the slab. Then
           the IVF index at ``bench.py``'s shape: 2,097,152 × 50 items
           around 2,048 planted centres, 2,048 cells, 8 probes, beside
           flat int8 on the same store: the build split into quantize /
           fit / assign / land, cell width, skew, device bytes; recall@10
           of 32 queries against an exact float64 scan (>= 0.99, both);
           host qps at batch 16 and 256; the probe and the cell scan alone;
           a burst of 10,000 changed and 1,000 new rows whose incremental
           snapshot must hold the same cell tables, bit for bit, as a
           rebuild with the same centroids (both timed). Its HTTP half runs
           in the loop (``serving_quant_http`` line): a ``ServingLayer`` on
           the loop's update topic with ``device-dtype = int8``, the index,
           ``sample-rate = 0.3`` and this script's
           ``SmokeRescorerProvider``; 1,000 users' ``/recommend`` with
           ``rescorerParams`` against the layer's own model's ``top_n``
           with the same hooks, 100 ``/similarity`` against its
           ``top_n_cosine``; no 5xx, no kernel launch;
  kmeans_kernel
           the Lloyd-sweep kernel against its plain version on 1,000,000 ×
           64 standard-normal points with K = 256 (near ties allowed), on
           200,000 points of 256 planted blobs (exact counts) and on their
           first 100,000 (the update path's shape), both timed by bare
           launches of the C entry (20 per event pair; the same bits as the
           wrapper's) and through the wrapper, beside the plain version, the
           cross term's ``torch.matmul`` (the entry's ``library_ms``) and
           the card's bound; and at K = 1,024, D = 128 (chunked centres,
           partial sums in device memory);
  profile  one ``torch.profiler`` session, started straight after the
           sweep's timing, with four windows back to back: one more
           training iteration, with the packed blocks' schedules as the
           trainer passes them, one sweep at each of the two timed
           shapes, and one RDF tree's growth at the full covtype shape
           (device time by kernel, idle share); each sweep's window
           must list each of its three launches once, and is printed in
           the ``kmeans_kernel`` line (``profile``,
           ``update_shape.profile``), the tree's in the ``rdf`` line;
           inside the session a ``POST /debug/profile`` to a model-less
           ``ServingLayer`` on the card must answer 409;
  profiling
           the device cost accounting (``common/profiling``, configured
           at the start): the ALS train's and every ``als_durability``
           train's (and generation's) ``oryx_device_calls_total{program=
           als.train.user_half|item_half}`` deltas equal the halves run,
           their FLOP and byte deltas calls × the registered cost, which
           equals ``tr.half_cost`` of the sides' shapes where the sides are
           known; first, right after the session closes, one real
           ``POST /debug/profile?seconds=1`` with b256 ``top_n_batch``
           calls on the 1M × 50 flagship in a thread: 200 and a readable
           Chrome trace, its device events counted; the profiled
           iteration's MFU and HBM share over its device-busy and its wall
           time (FLOPs and bytes of ``tr.half_cost``, against 67 TFLOP/s
           and 3.35 TB/s); ``oryx_device_mfu`` and
           ``oryx_device_hbm_bandwidth_fraction`` read from the rendered
           ``/metrics`` text after 2.5 s of b256 ``top_n_batch`` on the
           flagship in f32 and in int8 (the rate window cut to 2 s), beside
           the loop's own count; every share in (0, 1]; the quantized
           bytes gauge; the ``cuda:0`` memory gauges equal to
           ``torch.cuda``'s readings after a synchronise; the blackbox
           bundle's ``memory`` section;
  analyze  the port's static analyser and the card's sync reporting, right
           after ``profiling`` (outside the profiler session and every
           timed call): (a) ``python3 -m oryx_tpu_torch.cli analyze
           --format json`` on the checkout in a child must exit 0 with zero
           unsuppressed findings (its seconds, the suppressed counts by
           checker); then ``analyze --protocol --format json`` in a child
           must exit 0 with the three protocol models clean and complete
           at the tier-1 depth and the reference explorer's states and
           transitions (``PROTOCOL_COUNTS``; each model's seconds
           printed), and each of the six fixtures under
           ``tests/data/protocol_schedules/`` must replay with
           ``--schedule`` (exit 0); then ``analyze --cost --format json
           --bind ...`` in a child, at the b256 scan over the 1M × 50
           flagship and ``y`` bound to the train phase's Y: ``_score``'s
           static FLOPs must equal ``scan_flops`` (the serving phase's
           analytic FLOPs of the same call) and the collective bytes
           priced for ``solve_side_sharded`` must equal the bytes of Y on
           the card (both printed); (b) three windows of what earlier phases built, each
           under ``torch.cuda.set_sync_debug_mode("warn")`` (mode 0
           restored in a ``finally``): one ALS iteration on the train
           phase's blocked sides, ``kmeans_train`` on the first 100,000 of
           the sweep's 1M × 64 points (k = 256, 8 iterations) and
           ``fit_index_centroids`` on them with one reseed round, and a
           b256 ``top_n_batch`` on the 1M × 50 flagship. Each sync warning
           is charged to the innermost stack frame under
           ``oryx_tpu_torch/`` (``traceback.extract_stack`` in a
           ``warnings.showwarning`` hook); every site must be one the
           port's transfer recogniser classifies (``dataflow.transfers_at``:
           a fetch, an upload or an explicit wait on that line), or the
           phase fails. Printed per window and site: the syncs, the kinds,
           whether the site is a host-device-transfer finding (reported or
           suppressed); and the findings in functions the windows ran
           (``sys.setprofile``) that never synced;
  kmeans_update
           the k-means main path: 100,000 CSV lines of 64 features from
           the planted blobs through ``KMeansUpdate.build_model`` (the
           reference's defaults with k = 256: 3 runs × 30 iterations,
           k-means||) and ``evaluate`` with all four strategies, the launch
           counters set to 0 just before and read just after (93 sweeps);
           −SSE against one more sweep's cost on the published centres; the
           PMML served by ``KMeansServingModelManager`` (1,000 queries
           against a host float64 assign); a 10,000-line microbatch folded by
           ``KMeansSpeedModelManager`` and its ``UP`` lines applied to the
           serving model; and one ``KMeansUpdate.run_update`` on the same
           lines (one candidate, 93 sweeps) published to a recording
           producer, whose ``MODEL`` a fresh ``KMeansServingModelManager``
           must hold as the promoted PMML's 256 clusters; the sweep's first
           launch at each shape that run reached is kept and held against
           the plain version after it;
  kmeans_train
           ``kmeans_train`` at 1,000,000 × 64, k = 256, 8 iterations, one
           run, twice (the second timed): point-iters/s, seeding and sweep
           seconds apart;
  mesh     the device mesh on the one card: meshes of four entries of
           ``cuda:0`` (``make_mesh(devices=[cuda:0] * 4)``), each shard its
           own tensors and its own kernel launches. ALS: the train's batch
           and Y₀ (the same generator seed) through ``als_train(mesh=,
           row_axis="model")``, the launch counters set to 0 just before
           and read just after; each shard's block solves counted call by
           call must launch both kernels once per block of its share per
           iteration, the totals iterations × blocks; X and Y (row-sharded,
           zero padding rows) within rtol 2e-4, atol 2e-5 of the one-device
           train's; the first launch at each shape held against the plain
           version. k-means: the data-parallel Lloyd step on the sweep's
           1M × 64 points in 4 shards over ``data``, 8 iterations from the
           same random centres as an unsharded ``_lloyd_run`` (9 sweep
           launches a shard), each step in lockstep (both from the
           unsharded run's centres) at 1e-4 / 1e-5 with equal counts, the
           runs' cost within 1e-4 (their centres part after near ties:
           reported); one sweep timed each way. Serving: a
           1M × 50 seeded catalog sharded 4 ways beside the same store
           unsharded, b256 top-10 plain and with each query's unsharded
           top-3 excluded, without and with LSH at 0.3 (one hash): the
           same ids (ties aside), scores within 1e-5, both timed. Config:
           the default ``ComputeContext`` has the one device,
           ``mesh-shape [2]`` raises the reference's ``ValueError``,
           ``oryx.serving.compute.sharded`` serves unsharded with the log.
           Bootstrap: a one-rank ``nccl`` group through
           ``initialize_from_config``, one all-gather, torn down;
  rdf      the random decision forest, the launch counters set to 0
           first (no kernel may launch: the trainer is plain torch, as the
           reference's is plain jnp), on 581,012 planted covtype-shaped
           rows (Oryx's RDF example schema: 10 numeric predictors, 4
           wilderness and 40 soil indicators, a 7-valued target; see
           ``covtype_data``) with the reference's defaults (20 trees, depth
           8, 100 split candidates, entropy, min-node-size 16,
           min-info-gain 0.001): ``forest_train`` on the card twice (the
           second timed: example-trees/s, seconds of binning, upload,
           device levels, host mask draws and finalize, peak device
           memory, one host sync per level; both runs the same trees); the
           first two trees against a CPU run of two from the same generator
           seed, node by node (equal, or first differing at a near-tie:
           both best gains within 1e-6 relative); regression (5 trees) on
           the card twice, the same PMML apart from its ``Timestamp``, and
           its first two trees against the CPU (leaf means within 1e-5);
           ``RDFUpdate.run_update`` with one candidate on the first 100,000
           rows as CSV lines (hold-out accuracy >= 0.90), its ``MODEL``
           into an ``RDFServingModelManager`` and an
           ``RDFSpeedModelManager``, a 10,000-line microbatch's ``UP``s
           (each example counted once per tree) into the serving manager
           (each leaf grown by exactly its ``UP``); a ``ServingLayer`` with
           the RDF manager and ``resources.classreg`` on a ``memory:``
           topic holding that ``MODEL`` and those ``UP``s: 1,000
           ``/predict`` and 100 ``/classificationDistribution`` equal to
           the manager's own model's, ``/feature/importance`` equal to the
           PMML's, no answer but 200;
  als_quality
           ``tests/test_als_quality.py``'s three trains on the card through
           ``ALSUpdate`` (split, ``build_model``, ``evaluate``), on that
           file's own data (copied here: the synthetic MovieLens-100K shape,
           900 users × 1,600 items, 100,000 lines; 500 users' explicit
           low-rank ratings) and configs, each under ``rand.seeded``: k = 20,
           λ = 0.01, 8 iterations with float32 and then bfloat16 Gramian
           inputs (hold-out AUC > 0.75 each), and explicit k = 8, λ = 0.05,
           10 iterations (RMSE < 0.35). The launch counters are set to 0
           just before each ``build_model`` and read just after: both ALS
           kernels once per row block and iteration, the gather-Gramian in
           the train's compute dtype; each first launch at a shape held
           against the plain version;
  lambda_loop
           the ALS lambda loop through the port's runtime, after the
           k-means phases (mostly host work), on ``memory:`` topics: a ``BatchLayer`` and a
           ``SpeedLayer`` with ``platform`` null (the card), and an
           ``ALSServingModelManager`` on the card consuming the update
           topic from ``earliest`` on a thread of its own (what the serving
           app does). Batch half: the lines of the first 10,000 users
           (``LOOP_USERS``, about 100,000, in order) are sent one by
           one through the input topic's producer (``produce_s``), offset 0
           is stored for the batch layer's group (a layer without a stored
           offset starts at its input's end), both layers start, and the
           batch layer runs one generation: ``ALSUpdate.run_update``
           (time-ordered 10% hold-out, one candidate, λ = 1, trained on the
           card at k = 50, 3 iterations, α = 1, written as part files,
           evaluated by AUC; cut from two λ candidates for time), promoted
           and published to the update topic, then the segment write and
           the offset commit; the batch layer is closed after it. Checks,
           on the stream read back from the update topic: the candidate
           built and evaluated on the card, AUC > 0.75, both ALS kernels
           launched iterations × (user + item blocks) times (counters set
           to 0 just before the layers start) and no sweep, each kernel's
           first launch at each shape held against its plain version after
           the generation, one ``MODEL`` first (inline, under the
           transport's cap), a ``Y`` ``UP`` per item before any ``X``
           ``UP``, one ``X`` ``UP`` with its known items per user of the
           training split; one data segment of all the lines, the
           group's stored offset at the input topic's end, the ``MODEL``'s
           lineage stamp carrying the context's offsets and watermark; the
           serving manager holding the whole stream (fraction 1.0), its
           top-10 for 256 users, known items excluded, equal (ids, and
           scores bit for bit) to a model loaded straight from the promoted
           part files. Printed: the generation's wall split into poll,
           ``run_update`` (with ``MLUpdate``'s stages), segment write and
           offsets (the generation's step seconds and items, and the speed
           layer's published ``UP``s, are the runtime's own, read from the
           metrics registry), and publish-to-servable seconds (the first ``MODEL`` on
           the update topic to the serving manager holding the stream).
           Speed half: the held-out 10% (about 10,000 lines, the newest)
           as two 5,000-line microbatches through the input topic. Before each,
           both managers apply every message on the update topic (the speed
           layer hears its own ``UP``s), the speed manager's solver caches
           are brought current (``settle_solvers``: ``SolverCache`` hands
           out the previous solver while a recompute runs), the pre-batch
           X and Y are read, and the lines are sent just after an idle tick
           of the speed layer's pump (2 s interval), so one generation
           reads exactly them (checked, with the offsets it ends at). The
           ``UP``s are read from the update topic, each with the watermark
           header of the input offsets and watermark it incorporated.
           Checks: one X ``UP`` carrying its item and one Y ``UP`` per
           changed pair; 256 sampled ``UP``s of each kind against
           ``v + solve(VᵀV, w·Δq)`` in float64 from the pre-batch X and Y
           (relative 1e-4); the serving snapshot taken incrementally (no
           whole upload after the generation's first) and ``torch.equal``
           to a whole upload; 256 users' top-10 (half of them touched,
           known items from the ``UP``s included) equal to a model loaded
           fresh from the stores, ids and scores bit for bit; ``get_vtv``
           on the card's matrix against a float64 Gramian (relative 1e-5),
           ``build_temporary_user_vector`` for 256 contexts of 1-20 items
           against a float64 fold-in (relative 1e-4), ``top_n_cosine`` for
           16 item sets against an exact float64 scan (overlap >= 0.99).
           Printed per microbatch: append-to-servable seconds (the last
           line sent to a serving snapshot holding the ``UP``s), with and
           without the wait for the tick; the pump's poll, ``build_updates``
           (by stage) and ``UP`` publish seconds and both consumers' lag
           behind the publish; snapshot milliseconds. No kernel may launch
           in the speed half. Then the 1,000,000 × 50f serving model: three
           rounds of 10,000 changed and 1,000 new rows, each snapshot timed
           incrementally beside a whole upload of the same store
           (``torch.equal``), and 16 queries' top-10 equal to a model loaded
           fresh. Any quarantined generation, corrupt record, failed send,
           layer failure or serving consumer restart fails the phase.
  serving_http
           the serving layer's HTTP app (``ServingLayer`` on the card, on a
           free port), inside the loop before it closes: it replays the
           loop's update topic from ``earliest`` (the stamped ``MODEL``,
           the ``UP``s of the generation and of both microbatches) with the
           ALS resources, read-write on the loop's input topic; printed:
           ``replay_to_ready_s`` (``start()`` to the first 200 from
           ``/ready``) and ``replay_to_current_s`` (to its manager having
           applied every message). Then, through stdlib ``http.client``:
           1,000 seeded users' ``/recommend?howMany=10``, with and without
           ``considerKnownItems``, against the loop's in-process manager's
           ``top_n`` (ids equal wherever neighbouring scores differ by more
           than 1e-5 relative, scores within 1e-5), and every other read
           route once against its direct call (``/recommendToMany``,
           ``/recommendToAnonymous``, ``/similarity``, ``/estimate``,
           ``/because``, ``/knownItems``, ``/mostPopularItems``,
           ``/user/allIDs``, ``/recommend`` as CSV), each answer carrying
           the batch layer's generation id in ``x-oryx-model-generation``;
           1,000 seeded lines through ``POST /ingest``, which must land on
           the input topic, be folded in by the running speed layer and be
           applied by both managers (``ingest_to_served_s``: the last
           ``/ingest`` response to the layer having applied the last
           ``UP``), then 100 of their users' ``/recommend`` checked again;
           closed-loop load at 1, 16, 64 and 256 keep-alive connections from
           a client process (``multiprocessing``, spawn): requests, errors
           (0), qps, p50 / p99 ms, and from the coalescer's registry the
           device calls, mean and largest batch (as the upper edge of its
           histogram bucket) and padding rows (each connection's untimed
           first request is among the calls); the mean batch must be above
           1 at 64 and 256; the layer's Y on the card; ``/readyz`` 200 with
           the model loaded, ``/metrics`` counting the ALS routes, 404 for
           ``/nope``, 405 for ``GET /debug/profile``; after ``close()`` no thread of
           the layer and its port free. No kernel may launch. The k-means
           half runs inside ``kmeans_update`` (a small layer on an update
           topic of its own holding that phase's ``MODEL`` and speed
           ``UP``s: 1,000 ``/assign`` and ``/distanceToNearest`` against
           ``nearest_cluster``, 100 lines through ``POST /add`` onto its
           input topic) and is printed in this line as ``kmeans``.
  chaos    ``tests/test_chaos.py``'s drill on the card, inside the loop
           after ``serving_http`` (no training): the loop's update stream
           bulk-loaded into a ``FileBroker`` directory served by an
           in-process ``tcp:`` ``NetBrokerServer``, and a ``ServingLayer``
           on the card replaying it with the reference test pair's
           resilience settings (a breaker of threshold 2 and 0.3 s reset,
           fast retries and consumer restarts). 20 seeded users' coalesced
           ``/recommend`` answers are held against the loop's model, then
           under ``faults`` schedules: (a) ``serving.device_call=fail:2``:
           the two requests answered by the per-request fallback, the
           breaker's gauge open, a request during it degraded, the breaker
           closed again within 10 s, its open, half-open and closed
           transitions counted, every answer equal to the coalesced one;
           (b) a second app over the same manager (queue depth 1, one call
           in flight, ``latency:400``): a 12-way burst sheds with
           ``Retry-After``, the shed counter equals the 503s, every
           accepted answer checked; (c) a third (``request-timeout-sec``
           0.15, ``latency:2000``): a 504 whose ``trace_id`` ``/trace``
           returns; (d) the broker closed (close-to-refused seconds),
           ``serving.update_consume=fail:1``, at least 2 consumer restarts
           with every answer 200 and checked, the broker back on its port
           over its directory, one ``UP`` of a new item applied within 30 s
           (resume seconds), every user checked again; (f) 48 requests over
           8 threads, all 200, none shed, ``/readyz`` 200; (e) the broker
           down again, the layer closed in the rebuild storm, its consumer
           joined within 10 s (join seconds), no thread left. No kernel may
           launch. Its consumer restarts are the one failure count the
           loop's phase does not fail on.
  tools    the operator's tools of ``oryx_tpu_torch/tools``, reusing what
           earlier phases built (no second profiler session, no training):
           the ``profile`` session's Chrome trace, exported by
           ``device_profiles``, read back by ``trace_summary`` in process
           and as ``python -m oryx_tpu_torch.tools.trace_summary <dir>
           --top 20`` (exit 0, the same top rows): the gather-Gramian's,
           the SPD solve's and the sweep's kernels are op rows, each
           counted as often as its wrapper launched in the session, each
           with its self ms within 1% of the profiler's own sum of that
           kernel's device time, and no ``gpu_user_annotation`` span (the
           windows) an op row; the export's seconds and the trace's bytes.
           Then, on ``serving_http``'s layer after its load levels: the
           tool's metrics view of ``/metrics`` (the device gauges' rows
           equal what ``rendered_gauge`` reads from the same text; the CLI
           on the URL exits 0), ``--trace-id`` of one traced
           ``/recommend`` (the ingress span, the coalescer's queue wait
           under it, the device call with ``batch.size`` and
           ``pad.waste_rows``), and ``traffic.TrafficRunner`` with the
           reference's ALS mix over the loop's ids, 4 threads, no
           interval, 10 s, from the phase's client process: each endpoint
           sent requests, no server error, no exception (404s for ids
           outside the model are reported),
           requests per second and p50 / p99 per endpoint; every answered
           ``/pref`` lands on the input topic and its ``UP``s are applied
           by both managers before the phase goes on.
  serving_swap
           the staged generation swap, inside the loop after
           ``serving_http``: the loop's update stream (k = 50) copied to
           a ``memory:`` topic as generation 1, and generation 2 from
           ``ALSUpdate.run_update`` at k = 60 on the first
           ``SWAP_USERS`` users' lines (the launch counters set to 0
           first and read after, each first launch at a new shape held
           against the plain version; its cost accounting checked). A
           ``ServingLayer`` on the card with ``precompile-batches`` (the
           staged swap: ``prewarm-swap`` at its default) warm on
           generation 1, under closed-loop ``/recommend`` at 16
           connections from a client process (``multiprocessing``, spawn),
           is given generation 2's ``MODEL`` and ``UP``s after 8 s,
           appended to its topic in one burst (as from another process):
           the seconds from stage to promote, the warm ladder's, p50 / p99 and
           statuses in the windows before the stage, staged (also without
           the append's own seconds), and after the flip; no 5xx; each connection's generation headers gen-1 then
           gen-2, never back; the promotion after generation 2's whole
           ladder; ``oryx_serving_prewarmed_swaps_total`` + 1 and the
           deadline counter + 0; then 100 users' ``/recommend`` against an
           in-process generation 2. The same with ``prewarm-swap = false``
           on a fresh layer (contrast): the windows before, while
           generation 2 loads, after, and the answers from it while
           loading. A bare manager with ``swap-deadline-sec = 0.2`` given
           generation 2's ``MODEL`` alone behind generation 1 is promoted
           by the deadline (counter + 1). No kernel launches but
           generation 2's;
  observability
           ``tests/test_spans.py``'s and ``tests/test_metrics.py``'s
           end-to-end assertions on the card, last inside the loop (after
           the ``serving_quant_http`` line; no training): a ``ServingLayer``
           on the card replaying the loop's ``memory:`` update topic,
           read-write. (a) 100 ``/recommend`` from one connection, then 25
           from each of 16, from a client process, each with a fresh
           ``traceparent`` and its trace fetched from ``/trace`` right
           after its answer: every trace holds the ingress span and the
           coalescer's queue wait, the device call (``batch.size`` >= 1,
           ``pad.waste_rows``) reaches the wait as its parent or, for a
           request that was not its batch's first, by a link (found among
           the recent spans), and the wait and the call cover at least 95%
           of the time from the wait's start to the call's end; p50 / p99
           per concurrency of the ingress, wait and call milliseconds and
           of the ingress time outside wait ∪ call (the HTTP front's), and
           at 16 the distinct calls' batch sizes. (b) ``/metrics`` before
           and after (a): the ``/recommend`` 200 counter and the
           coalescer's batch-size sum up by exactly the 500 requests, the
           top-N query counter by at least 500, the queue depth 0; an
           OpenMetrics scrape's exemplar on the ``/recommend`` latency
           resolves through ``/trace`` to its ingress span and a device
           call. (c) one ``POST /pref`` with a fresh ``traceparent``: the
           loop's speed layer records ``speed.consume_input`` under that
           trace id within 15 s (seconds to it), and both of the loop's
           managers apply the ``UP``s before the phase returns. (d)
           ``blackbox.bundle``: the port's and torch's versions,
           ``cuda:0`` in its memory section, the ``/recommend`` counter
           equal to (b)'s scrape. No kernel may launch;
  sanitize the port's runtime concurrency sanitizer
           (``oryx_tpu_torch/tools/sanitize``) in a child interpreter,
           ``tests/torch_sanitize_child.py probe`` under
           ``ORYX_SANITIZE=locks,loop`` (it must install before the first
           lock is allocated, so never in this process, which stays
           unsanitized): (a) the install took — ``threading.Lock``,
           ``RLock`` and ``asyncio``'s ``Handle._run`` are the port's, both
           modes on, a lock allocated from a repo frame is a ``SanLock``;
           (b) inside ``sanitize.isolated()`` the two-thread lock inversion
           of ``tests/test_sanitize.py``'s installed-wrappers case gives
           exactly one cycle (both edges with their acquisition stacks) and
           a 400 ms blocking asyncio callback exactly one stall with its
           live stack, and neither reaches the child's own exit report;
           (c) the overhead that ``tests/test_load_benchmark.py`` gates on
           the CPU, reported here, not gated: bookkeeping events per
           ``top_n_batch`` call (the port's ``ALSServingModel``, 5,000 ×
           16 on the card, batch 128, top 5) × the per-event cost (min of 3
           windows of 5,000 acquire/release pairs) ÷ the mean call;
  deployment
           the same ALS loop as a deployment, last: five processes started
           through ``python -m oryx_tpu_torch.cli`` on one HOCON file (each
           serving replica's adds its port), every topic ``tcp:`` on the
           broker process — ``broker`` (its topic directory holding the
           loop's lines, bulk-loaded into the input log before it starts,
           offset 0 stored for the batch group), two ``serving`` replicas
           on the card (ALS resources, read-write, replaying from
           ``earliest``), ``speed`` and ``batch`` (the loop's config: one
           candidate, k = 50, 3 iterations, on the card) — and in this
           process an ``ALSServingModelManager`` on the card consuming the
           update topic over ``tcp:``, timestamping each message as it
           lands. The batch process is stopped (SIGTERM) once its first
           generation committed the input's end. Printed: ``generation_s``
           (batch process start to the ``MODEL`` landing) beside the batch
           tier's own generation step seconds (its flight-recorder bundle,
           written on SIGTERM), ``publish_to_servable_s`` per replica (the
           ``MODEL`` landing to the replica having consumed every message,
           read from its ``/metrics``), the ``UP`` publish's microseconds a
           message from the landing times. Checks: the local model's
           hold-out AUC > 0.75; 1,000 seeded users' ``/recommend`` on each
           replica, with and without known items, against the local
           manager's ``top_n`` by ``serving_http``'s rule, each answer
           carrying the batch generation's id; ``/readyz`` 200 with the
           model loaded and the build info on ``cuda``. Then probe lines
           one at a time until the speed tier publishes (its model is
           loaded), and a 2,500-line microbatch sent over ``tcp:``
           (``produce_us``, ``ticks``, ``up_publish_us``,
           ``append_to_servable_s`` per replica: the last send returning to
           the replica having consumed the last ``UP`` of the lines), 100
           touched users checked again on both replicas; the in-process
           loop's figures from this run beside them; the broker's RPCs by
           op with their mean server-side milliseconds, after the
           generation and at the end (``broker_ops``, from its registry);
           ``python -m oryx_tpu_torch.cli fleet-status --format json``
           once against both replicas (exit 0, both up, each replica's
           request total outside the ops routes equal to its own
           ``/metrics`` read just after, less the console's own
           ``/metrics/history`` request), then its ``--format table``
           output printed as it is (``fleet_status``). Last, SIGTERM to each
           tier and the broker: each must exit 0 within 30 s, and no tier's
           bundle may count a quarantine, corrupt record, layer failure,
           failed send or consumer restart. On a failure the last 40 lines
           of each process's output are printed. The five processes run
           sanitized (``ORYX_SANITIZE=locks,loop``, long holds from 1 ms
           so that every process shows its wrappers live, the loop-stall
           threshold the config's 250 ms; this process stays unsanitized)
           and, since SIGTERM is a normal exit, each prints its sanitizer
           report at exit: any lock-order cycle in any process fails the
           phase; per process the loop stalls (count, the longest, its
           blocked frame) and the long holds are printed (``sanitizer``),
           and the processes that report none are named.

Then the ``{"kernels": [...], "paths": {...}, "path_checks": {...}}`` line
(``paths``: the launches of each wrapper in the durability phase
``als_durability``, in the loop's batch half ``lambda_loop.batch``, in the k-means generation, in the loop's speed
half ``lambda_loop.speed``, in the HTTP app's path ``serving_http`` and
in the chaos drill ``chaos`` and in the spans and scrape checks'
``observability``, where the last four must be all 0, in the serving representations'
phase and its HTTP half ``serving_quant`` (all 0), in the RDF phase
``rdf_generation`` (all 0), and in the deployment's
batch process
``deployment``, read from its bundle's ``oryx_device_calls_total`` and
equal to ``lambda_loop.batch``, the gather-Gramian's reduce launches too,
in the staged swap's generation 2 at k = 60 ``serving_swap``, in
the mesh phase's sharded train and data-parallel Lloyd run ``mesh``, and
in the three quality trains ``als_quality`` (summed);
``path_checks``:
for each generation, one record per kernel and shape it launched at, that
launch's output against the plain version on the same inputs), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Each kernels-line entry's ``launches``
is its kernel's count at its shape in the run of the path that reaches it
(``K.SHAPE_LAUNCHES``): the ALS train and serve run, ``build_model``'s run
or ``kmeans_train``'s timed call; an entry at a shape no path runs (the
bfloat16 gather-Gramian, the synthetic SPD systems) shows 0, with
``on_main_path`` false; a gather-Gramian entry's ``reduce_launches`` is
counted the same way. Any failed check raises: the script
exits non-zero and prints no ``ok`` line. Without a CUDA card it exits 1
at once.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import http.client
import io
import json
import logging
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
from pathlib import Path

import numpy as np
import torch
from aiohttp import web

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import checkpoint as ck
from oryx_tpu_torch.common import compilecache
from oryx_tpu_torch.common import config as oryx_config
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.common import slo
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import evaluate
from oryx_tpu_torch.models.als import pmml_codec as als_codec
from oryx_tpu_torch.models.als import ivf as ivf_mod
from oryx_tpu_torch.models.als import serving as serving_mod
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.rescorer import Rescorer, RescorerProvider
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.models.als.update import ALSUpdate
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
from oryx_tpu_torch.models.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.models.rdf import pmml_codec as rdf_codec
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.rdf.serving import RDFServingModelManager
from oryx_tpu_torch.models.rdf.speed import RDFSpeedModelManager
from oryx_tpu_torch.models.rdf.update import RDFUpdate
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import kernels as K
from oryx_tpu_torch.ops import vectormath
from oryx_tpu_torch.parallel import distributed
from oryx_tpu_torch.parallel.mesh import ComputeContext, make_mesh, shard_rows
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.serving.app import ServingLayer, make_app
from oryx_tpu_torch.tools import sanitize as port_sanitize
from oryx_tpu_torch.tools import trace_summary
from oryx_tpu_torch.tools import traffic
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp
from oryx_tpu_torch import state

SEED = 20261016
N_USERS, N_ITEMS, NNZ, RANK = 100_000, 10_000, 1_000_000, 5
# λ = 1: with ~9 interactions per user, ALS-WR's λ·n_u at λ = 0.01 leaves
# 50 features nearly unregularised and the hold-out AUC falls well short
# of the 0.75 gate; the kernels' work does not depend on λ
FEATURES, LAM, ALPHA, ITERATIONS = 50, 1.0, 1.0, 3
TEST_FRACTION = 0.1
FLAGSHIP_ITEMS = 1_000_000

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

GG_SOURCE = "oryx_tpu_torch/ops/csrc/gather_gramian.cu"
SPD_SOURCE = "oryx_tpu_torch/ops/csrc/spd_solve.cu"
GG_REPLACES = "oryx_tpu/ops/pallas_kernels.py:221"
SPD_REPLACES = "oryx_tpu/ops/pallas_kernels.py:89"
KM_SOURCE = "oryx_tpu_torch/ops/csrc/kmeans_assign.cu"
KM_REPLACES = "oryx_tpu/ops/pallas_kernels.py:357"
ALS_WRAPPERS = ("gather_gramian_accumulate", "spd_solve_batched")
# synthetic SPD cases: the user block's system count at the reference's
# default k = 10 (the warp kernel) and at k = 128 (the CTA kernel)
SPD_SYNTHETIC_SYSTEMS, SPD_SYNTHETIC_K = 7_692, (10, 128)
# kernel timings: calls per CUDA-event pair (the SPD warp kernel at small k
# and the gather-Gramian on a user block are shorter than one wrapper
# call's host time)
INNER = 20

# k-means: bench_batch.py's accelerator shape (1M × 64, K = 256, 8
# iterations); the update path's data are planted Gaussian blobs (centres
# uniform in [−10, 10]^64, σ = 1), k = 256 with the reference's defaults
KM_N, KM_D, KM_K, KM_ITERATIONS = 1_000_000, 64, 256, 8
KM_BLOB_POINTS, KM_LINES, KM_MICROBATCH = 200_000, 100_000, 10_000

# the k-means generation's timestamp (a recording producer, no layer)
GENERATION_TIMESTAMP_MS = 1_760_000_000_000

# the ALS lambda loop and the deployment: one batch generation with one
# candidate (λ = LAM), cut from a grid of two (λ 0.5 and 1: two took 109 s
# of run_update on the H100, most of it the part-file write and the
# evaluation's re-parse of each candidate), on the lines of the first
# LOOP_USERS users (about 100,000, every item width kept): cut from all
# 100,000 users, and since the mesh phase joined the smoke from 20,000
# (the smoke took 1,130 s of its 1,200 on a slow host, the deployment 495
# of them), because over tcp each published message is one RPC of
# ~1.9 ms on the card's host, ~5 ms with four consumers (netbroker_rpc.py),
# and a generation publishes one UP per user; the in-process loop runs the
# same lines, so that both publish the same stream and launch the kernels
# at the same shapes. The layers tick every BATCH_INTERVAL_S /
# SPEED_INTERVAL_S seconds: the speed interval is long enough that a
# microbatch's append (~0.1 s in process) sent just after a tick lands in
# one generation
LOOP_USERS = 10_000
LOOP_BROKER = "memory:smoke"

# the durability phase: the layout cache's extension holds out 1% of the
# entries; the generation pair (two ALS run_updates with checkpoints on,
# a generation and its crash-restart) runs on the lines of the first
# DURABILITY_USERS users, the loop's, so the pair's host work (parse,
# evaluation, part files) stays near one loop generation's
DURABILITY_HOLDOUT = 0.01
DURABILITY_USERS = 10_000
DURABILITY_FP = "d" * 16
BATCH_INTERVAL_S, SPEED_INTERVAL_S = 1.0, 2.0

# the speed tier: the generation's held-out 10% (about 10,000 lines, the
# newest) as two microbatches of 5,000 (cut with the loop's users from
# two of 50,000, the size the reference's fold-in notes are written for,
# oryx_tpu/models/als/speed.py:205-210); 256 sampled checks of each kind;
# at the flagship width, rounds of 10,000 changed and 1,000 new rows
SPEED_MICROBATCH, SPEED_SAMPLES = 5_000, 256
FLAGSHIP_CHANGED, FLAGSHIP_NEW = 10_000, 1_000

# the serving layer's HTTP app on the loop's update topic: 1,000 users'
# /recommend (with and without their known items) against the loop's
# in-process model, 1,000 ingested lines (100 of their users checked
# after), closed-loop load at four concurrencies (connections, requests)
# from a client process; scores within HTTP_REL relative, and a top 10's
# last tie group may take its ties from the reference's next HTTP_TIE_DEPTH
# answers. k-means: 1,000 queries of each route and 100 /add lines
HTTP_USERS, HTTP_INGEST_LINES, HTTP_TOUCHED = 1_000, 1_000, 100
HTTP_LOAD = ((1, 400), (16, 1_500), (64, 3_000), (256, 3_000))
HTTP_REL = 1e-5
HTTP_TIE_DEPTH = 10
HTTP_KMEANS_QUERIES, HTTP_KMEANS_ADDS = 1_000, 100

# the serving representations: LSH at the reference baseline's rate
# (bench.py:41); the IVF index at bench.py's shape (2,048 planted centres x
# 1,024 items, 50 features, 2,048 cells, 8 probes), 32 recall queries, a
# burst of 10,000 changed and 1,000 new rows; over HTTP, HTTP_USERS users'
# /recommend with a rescorer and 100 /similarity
QUANT_LSH_RATE = 0.3
IVF_CENTERS, IVF_N, IVF_PROBES = 2_048, 2_048 * 1_024, 8
IVF_RECALL_QUERIES, IVF_BURST_CHANGED, IVF_BURST_NEW = 32, 10_000, 1_000
HTTP_QUANT_SIMILARITY = 100

# the deployment: two serving replicas; a 2,500-line microbatch over tcp
# (cut from the loop's 2 x 5,000: each send, and each of the ~2 UPs a
# line makes, is one RPC: 6-9 ms each on the card's host with the tiers
# consuming, so 5,000 lines took 100 s), after up to 20 probe lines sent
# one by one until the speed tier publishes
DEPLOY_REPLICAS, DEPLOY_MICROBATCH, DEPLOY_PROBE_LINES = 2, 2_500, 20

# the port's sanitizer: the sanitize phase's child, and the environment of
# the deployment's processes (every lock hold from 1 ms reported, as
# information: it shows each process's wrappers live; the loop-stall
# threshold stays the config's oryx.sanitize.loop-stall-ms, 250 ms)
SANITIZE_CHILD = Path(__file__).resolve().parent / "tests" / "torch_sanitize_child.py"
SANITIZE_ENV = {"ORYX_SANITIZE": "locks,loop"}
DEPLOY_SANITIZE_ENV = {**SANITIZE_ENV, "ORYX_SANITIZE_LONG_HOLD_MS": "1"}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, warmup: int = 3, inner: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` on the card: ``inner``
    calls back to back between two CUDA events, ``reps`` times. An ``inner``
    of more than 1 keeps the card busy while the host enqueues the next
    call, so a kernel shorter than the host's call overhead is timed for
    itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- data -------------------------------------------------------------------


def synthetic_lines(rng: np.random.Generator) -> list[str]:
    """``user,item,1,ts`` lines: users pick items by power-law popularity
    and keep them almost only when the planted rank-5 score is above the
    user's 75th percentile (the reference's quality-test generator, made
    vectorised: for standard-normal item factors a user's scores are
    N(0, |u|²), whose 75th percentile is 0.6745·|u|)."""
    u_f = rng.standard_normal((N_USERS, RANK))
    i_f = rng.standard_normal((N_ITEMS, RANK))
    pop = rng.permutation(np.arange(1, N_ITEMS + 1, dtype=np.float64) ** -0.8)
    pop /= pop.sum()
    thresholds = 0.6745 * np.linalg.norm(u_f, axis=1)
    keys = np.zeros(0, dtype=np.int64)
    while True:
        m = 4 * NNZ
        u = rng.integers(0, N_USERS, m)
        i = rng.choice(N_ITEMS, p=pop, size=m)
        score = np.einsum("nr,nr->n", u_f[u], i_f[i])
        keep = (score >= thresholds[u]) | (rng.random(m) >= 0.95)
        keys = np.concatenate([keys, u[keep] * N_ITEMS + i[keep]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]  # first occurrence of each pair, in order
        if len(keys) >= NNZ:
            break
    keys = keys[:NNZ]
    return [f"u{k // N_ITEMS},i{k % N_ITEMS},1,{t}"
            for t, k in enumerate(keys.tolist())]


def holdout_batch(lines, users, items) -> als_data.RatingBatch:
    rows, cols = [], []
    for ln in lines:
        u, i, _, _ = ln.split(",")
        r, c = users.id_to_index.get(u), items.id_to_index.get(i)
        if r is not None and c is not None:
            rows.append(r)
            cols.append(c)
    rows = np.asarray(rows, dtype=np.int32)
    order = np.argsort(rows, kind="stable")
    return als_data.RatingBatch(
        rows[order], np.asarray(cols, dtype=np.int32)[order],
        np.ones(len(rows), dtype=np.float32), users, items,
    )


# -- kernels ----------------------------------------------------------------


def launch_key(kernel: str, shape: tuple) -> str:
    return f"{kernel} {tuple(shape)}"


def shape_launches() -> dict:
    """``K.SHAPE_LAUNCHES`` with its keys as strings, for JSON."""
    return {launch_key(*key): n for key, n in K.SHAPE_LAUNCHES.items()}


def gg_entry(side, y, dtype, label):
    """The gather-Gramian kernel on block 0 of ``side`` against its plain
    version: once building its own schedule, once given it (the same bits
    from both), timed by bare launches and through the wrapper as the
    trainer calls it (schedule given), beside the plain version and a
    ``torch.bmm`` of the pre-gathered slab."""
    srow, scols, svals, slens = (side.srows[0], side.scols[0], side.svals[0],
                                 side.slens[0])
    t = scols.shape[-1]
    w, coef = tr._entry_weights(svals, slens, ALPHA, True, t)
    ys = y.to(dtype)
    args = (ys, srow, scols, w, coef, slens)
    sched = K.gather_gramian_schedule(srow, slens, block=side.block,
                                      slot_width=t)
    a, b = K.gather_gramian_accumulate(*args, block=side.block)
    a2, b2 = K.gather_gramian_accumulate(*args, block=side.block,
                                         schedule=sched)
    pa, pb = K.gather_gramian_accumulate_plain(*args, block=side.block)
    torch.cuda.synchronize()
    check(torch.equal(a, a2) and torch.equal(b, b2),
          f"gather_gramian {label}: two calls differ")
    abs_err, rel_err = max_errs([(a, pa), (b, pb)])
    # the same rounded inputs on both sides, so only the summation order
    # differs: float32 sums over up to ~10^4 entries (a popular item's row)
    tol = 1e-4
    check(torch.isfinite(a).all() and torch.isfinite(b).all(),
          f"gather_gramian {label}: non-finite output")
    check(rel_err < tol, f"gather_gramian {label}: rel err {rel_err} >= {tol}")
    launch = gg_bare_launch(args, side.block, sched)
    ba, bb = launch()
    torch.cuda.synchronize()
    check(torch.equal(a, ba) and torch.equal(b, bb),
          f"gather_gramian {label}: the bare launch differs from the wrapper")
    ms = time_ms(launch, inner=INNER)
    # one wrapper call per event pair, the host's Python included: how
    # the kernel was timed before it took a schedule
    wrapper_ms = time_ms(lambda: K.gather_gramian_accumulate(
        *args, block=side.block, schedule=sched))
    plain_ms = time_ms(
        lambda: K.gather_gramian_accumulate_plain(*args, block=side.block),
        reps=10)
    # the yardstick: the per-slot products alone as one batched product,
    # gather and weighting done before, the per-row sums not done
    yg = ys[scols.long()]
    lhs = (yg * w.to(ys.dtype)[..., None]).transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.bmm(lhs, yg))
    del yg, lhs
    valid = torch.arange(t, device=slens.device)[None, :] < slens[:, None]
    n_valid = int(valid.sum())
    rows_read = int(torch.unique(scols[valid]).numel())
    k = y.shape[1]
    s = scols.shape[0]
    nbytes = (rows_read * k * ys.element_size()  # gathered factor rows
              + s * t * (4 + 4 + 4) + s * (4 + 4)  # scols, w, coef; srow, slens
              + (side.block + 1) * k * (k + 1) * 4)  # A and b written
    # A is symmetric: k(k+1)/2 multiply-adds per entry for A, k for b
    flops = n_valid * (k * (k + 1) + 2.0 * k)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    shape = (side.block + 1, s, t, k, str(ys.dtype))
    return {
        "name": f"gather_gramian_accumulate[{label}]",
        "route": "cuda", "source": GG_SOURCE, "replaces": GG_REPLACES,
        "launch_key": launch_key("gather_gramian_accumulate", shape),
        "reduce_launch_key": launch_key("gather_gramian_accumulate.reduce",
                                        shape),
        "shape": {"block": side.block, "slots": s, "T": t, "k": k,
                  "valid_entries": n_valid, "dtype": str(dtype)},
        "schedule": {"units": sched.units, "split_rows": sched.split_rows,
                     "split_units": sched.split_units,
                     "unit_entries": sched.unit_entries,
                     "max_entries_per_unit": sched.max_entries_per_unit,
                     "workspace_bytes": sched.workspace_bytes(k)},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "bitwise_repeat": True,
        "ms": ms, "kernel_ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.bmm of the pre-gathered, weighted (S, k, T) x "
                   "(S, T, k) slab: the per-slot products only, gather and "
                   "per-row accumulation outside the timed call",
    }


def gg_bare_launch(args, block, sched):
    """A no-argument launch of ``oryx_gather_gramian`` (both passes) on the
    wrapper's arguments into preallocated outputs, with the pointers taken
    once: the kernel timed apart from the wrapper's host cost, as the SPD
    kernels are."""
    ys, _, scols, w, coef, slens = args
    t, k = scols.shape[1], ys.shape[1]
    a = torch.empty((block + 1, k, k), device=ys.device)
    b = torch.empty((block + 1, k), device=ys.device)
    ws = torch.empty((max(sched.split_units, 1), k * k + k), device=ys.device)
    fn = K._entry("gather_gramian", "oryx_gather_gramian")
    cargs = (ys.data_ptr(), int(ys.dtype == torch.bfloat16),
             sched.work.data_ptr(), sched.work.shape[0],
             sched.split.data_ptr(), sched.split_rows, scols.data_ptr(),
             w.data_ptr(), coef.data_ptr(), slens.data_ptr(), ws.data_ptr(),
             a.data_ptr(), b.data_ptr(), t, k,
             torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*cargs)
        check(err == 0, f"oryx_gather_gramian: CUDA error {err}")
        return a, b

    return launch


def spd_blocks(side, y):
    """Block 0's regularised normal equations (A, b) on the card."""
    yty = y.T @ y
    big_a, big_b, _ = tr._normal_equations(
        y, side.srows[0], side.scols[0], side.svals[0], side.slens[0],
        block=side.block, features=FEATURES, lam=LAM, alpha=ALPHA,
        implicit=True, slot_chunk=side.slot_chunk, yty=yty,
        fused_gramian=True, schedule=side.gg_schedules[0],
    )
    return big_a.contiguous(), big_b.contiguous()


def spd_synthetic(dev, n, k, seed):
    """n seeded SPD systems m·mᵀ + 2I (m standard normal × 0.3) on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((n, k, k), device=dev, generator=g) * 0.3
    a = m @ m.transpose(1, 2) + 2.0 * torch.eye(k, device=dev)
    return a.contiguous(), torch.randn((n, k), device=dev, generator=g)


def spd_fused_form(a, b):
    """The reference kernel's elimination step as it is written
    (``oryx_tpu/ops/pallas_kernels.py:111-112``): subtracting
    (fac − e_j) ⊗ piv_row from every row, which leaves row j as
    aug_j − (piv − 1)·aug_j/piv. Only its float64 error is reported, beside
    the plain version's; nothing is held to it."""
    k = b.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)
    rows = torch.arange(k, device=a.device)
    for j in range(k):
        piv_row = aug[:, j:j + 1, :] / aug[:, j:j + 1, j:j + 1]
        fac = aug[:, :, j:j + 1] - (rows == j).float()[None, :, None]
        aug = aug - fac * piv_row
    return aug[:, :, k]


def spd_kernel_label(mangled: str) -> str:
    """``warp<KP>`` for each SPD warp-kernel template, ``cta`` for the CTA
    kernel."""
    kp = re.search(r"spd_solve_warp_kernelILi(\d+)E", mangled)
    return f"warp<{kp.group(1)}>" if kp else "cta"


def sweep_kernel_label(mangled: str) -> str:
    """``assign_kernel<true>`` (16-byte loads) / ``<false>`` (scalar loads),
    ``partial_kernel<true>`` (slab in shared memory) / ``<false>``,
    ``reduce_kernel``."""
    m = re.search(r"(assign_kernel|partial_kernel|reduce_kernel)(?:ILb([01])E)?",
                  mangled)
    if m is None:
        return mangled
    flag = {"1": "<true>", "0": "<false>", None: ""}[m.group(2)]
    return m.group(1) + flag


def ptxas_usage(log: str, label) -> dict:
    """Registers and spill bytes per kernel from ``ptxas -v``'s log, keyed
    by ``label(mangled name)``."""
    usage, kernel = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = label(entry.group(1))
            usage[kernel] = {}
        elif kernel and "bytes spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[kernel]["spill_bytes"] = int(stores) + int(loads)
        elif kernel and "Used" in line and "registers" in line:
            usage[kernel]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def ptxas_checked(name: str, label, kernels: int) -> dict:
    """The ptxas usage of every kernel in library ``name``, from its build
    log; fails if any spills, or if fewer than ``kernels`` are listed."""
    usage = ptxas_usage(_build.build_log(name), label)
    check(len(usage) >= kernels and all(
        u.get("spill_bytes") == 0 and u.get("registers") for u in usage.values()),
          f"{name}: ptxas reports spills or no usage: {usage}")
    return usage


def spd_cta_entry():
    """The library's ``oryx_spd_solve_cta``, the CTA kernel at any k, bound
    with ``oryx_spd_solve``'s signature: only this script calls it, to time
    the CTA kernel beside the warp kernel on the same systems."""
    fn = _build.library("spd_solve").oryx_spd_solve_cta
    fn.argtypes, fn.restype = K._SIGNATURES["oryx_spd_solve"]
    return fn


def bare_launch(fn, a, b):
    """A no-argument launch of ``fn``, an ``oryx_spd_solve`` entry, on (a, b)
    into a preallocated x, with the pointers taken once. The warp and the
    CTA kernel are timed through it at the same small host cost per call;
    the wrapper's own checks cost more host time than the warp kernel takes
    at k <= 32."""
    x = torch.empty_like(b)
    args = (a.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0], b.shape[1],
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        check(err == 0, f"oryx_spd_solve: CUDA error {err}")
        return x

    return launch


def spd_entry(big_a, big_b, label, cta_fn):
    """The SPD kernel on (A, b) against its plain version, timed beside the
    plain version, ``torch.linalg.solve``, a Cholesky solve and, for k <= 64,
    the CTA kernel on the same systems (both kernels by bare launches; the
    wrapper call is timed too). Both are also held against a float64 solve
    (reported, not checked), and so is the reference's fused step."""
    n, k = big_b.shape
    x = K.spd_solve_batched(big_a, big_b)
    px = K.spd_solve_batched_plain(big_a, big_b)
    fx = spd_fused_form(big_a, big_b)
    exact = torch.linalg.solve(big_a.double(), big_b.double())
    torch.cuda.synchronize()
    abs_err, rel_err = max_errs([(x, px)])
    f64_err = {name: float((v.double() - exact).abs().max() / exact.abs().max())
               for name, v in (("kernel", x), ("plain", px),
                               ("reference_fused_step", fx))}
    tol = 1e-4
    check(torch.isfinite(x).all(), f"spd_solve {label}: non-finite output")
    check(rel_err < tol, f"spd_solve {label}: rel err {rel_err} >= {tol}")
    ms = time_ms(bare_launch(K._spd_solve_entry(), big_a, big_b),
                 inner=INNER)
    wrapper_ms = time_ms(lambda: K.spd_solve_batched(big_a, big_b),
                         inner=INNER)
    plain_ms = time_ms(lambda: K.spd_solve_batched_plain(big_a, big_b), reps=5,
                       warmup=1)
    rhs = big_b[..., None]
    library_ms = time_ms(lambda: torch.linalg.solve(big_a, rhs),
                         inner=INNER)
    cholesky_ms = time_ms(lambda: K.spd_solve_cholesky(big_a, big_b),
                          inner=INNER)
    variant = K.spd_variant(k)
    cta_ms = (time_ms(bare_launch(cta_fn, big_a, big_b), inner=INNER)
              if variant == "warp" else ms)
    nbytes = n * (k * k + 2 * k) * 4
    flops = n * (k ** 3 / 3.0 + 2.0 * k * k)  # Cholesky factor + 2 solves
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return {
        "name": f"spd_solve_batched[{label}]",
        "route": "cuda", "source": SPD_SOURCE, "replaces": SPD_REPLACES,
        "launch_key": launch_key(f"spd_solve_batched.{variant}", (n, k)),
        "variant": variant,
        "shape": {"batch": n, "k": k},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "rel_err_vs_float64": f64_err,
        "ms": ms, "kernel_ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.linalg.solve", "cholesky_ms": cholesky_ms,
        "cta_ms": cta_ms,
    }


def spd_crossover(dev, cta_fn) -> dict:
    """The warp and the CTA kernel on the same 7,692 seeded systems at each
    k around the warp kernel's crossover, both by bare launches."""
    out = {}
    for k in (1, 10, 16, 17, 32, 33, 50, 64, 65):
        a, b = spd_synthetic(dev, SPD_SYNTHETIC_SYSTEMS, k, SEED + 100 + k)
        launch = bare_launch(K._spd_solve_entry(), a, b)
        cta = bare_launch(cta_fn, a, b)
        x, cx = launch(), cta()
        torch.cuda.synchronize()
        out[f"k={k}"] = {
            "variant": K.spd_variant(k),
            "rel_diff": float((x - cx).abs().max() / cx.abs().max()),
            "ms": time_ms(launch, inner=INNER),
            "cta_ms": time_ms(cta, inner=INNER),
        }
    return out


# -- profile ----------------------------------------------------------------


def _interval_union(intervals) -> float:
    """The length covered by the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def iteration_fn(user_side, item_side, y):
    """One more iteration (both halves) from the trained Y, as a function
    for ``device_profiles``."""
    yp = torch.zeros((item_side.padded_rows, FEATURES), device=y.device)
    yp[: y.shape[0]] = y

    def half(side, opp):
        return tr.solve_side_blocked(
            opp, side.srows, side.scols, side.svals, side.slens, LAM, ALPHA,
            block=side.block, features=FEATURES, implicit=True,
            slot_chunk=side.slot_chunk, schedules=side.gg_schedules,
        )

    return lambda: half(item_side, half(user_side, yp))


WINDOW = "chip_smoke.window"


def launch_counts() -> dict:
    """The wrappers' launches so far (``K.LAUNCHES``), with the
    gather-Gramian's second launch (its reduce) apart."""
    out = dict(K.LAUNCHES)
    out["gather_gramian_accumulate.reduce"] = sum(
        c for (kernel, _), c in K.SHAPE_LAUNCHES.items()
        if kernel == "gather_gramian_accumulate.reduce")
    return out


def device_profiles(windows: dict, during=None, export=None) -> dict:
    """Each function of ``windows`` once to warm up, then each once more,
    back to back, in ONE ``torch.profiler`` session, each inside a window
    of its own: per window, device time by kernel and the share of the
    window's host wall time in which no kernel ran. ``during`` (no
    argument) runs inside the session after the windows, in none of them.
    ``export`` (a dict with ``"dir"``) gets the session's Chrome trace
    written there (``prof.export_chrome_trace``; ``"trace"``,
    ``"export_s"``, ``"bytes"``), the session's device events summed by
    name (``"device_events"``: name -> [count, microseconds]) and the
    kernel wrappers' launches in it (``"launches"``, :func:`launch_counts`).

    One session serves every window because on the H100 machines a session
    begun some seconds after the previous one ended has recorded no device
    events, and no later session of the process recorded any; how many
    seconds differs from run to run (``profiler_gap.py``). A one-element
    fill runs first inside the session (the tracer has been seen to drop
    the first kernel it would record) and is left out. A device event
    counts in the window whose device-side span (the annotation's span on
    the card's clock, from the kernels launched inside it) holds its start;
    where the trace has no such span, in the last window opened on the host
    before it started (the two clocks are aligned only roughly: a sweep's
    first kernel has been seen to start on the card's clock before its
    window opened on the host's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in windows.values():
        fn()
    torch.cuda.synchronize()
    walls_us = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        launches0 = launch_counts()
        for i, (name, fn) in enumerate(windows.items()):
            with record_function(f"{WINDOW}:{i}"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls_us[name] = (time.perf_counter() - t0) * 1e6
        launches = {k: v - launches0[k] for k, v in launch_counts().items()}
        if during is not None:
            during()
    events = prof.events()
    if export is not None:
        t0 = time.perf_counter()
        trace = Path(export["dir"]) / "smoke.pt.trace.json"
        prof.export_chrome_trace(str(trace))
        sums: dict = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and not e.name.startswith(WINDOW):
                c = sums.setdefault(e.name, [0, 0.0])
                c[0] += 1
                c[1] += e.time_range.end - e.time_range.start
        export.update(trace=str(trace), export_s=time.perf_counter() - t0,
                      bytes=trace.stat().st_size, device_events=sums,
                      launches=launches)
    opened = sorted((e.time_range.start, int(e.name.split(":")[1]))
                    for e in events if e.name.startswith(WINDOW + ":")
                    and e.device_type != DeviceType.CUDA)
    on_device = [(e.time_range.start, e.time_range.end, int(e.name.split(":")[1]))
                 for e in events if e.name.startswith(WINDOW + ":")
                 and e.device_type == DeviceType.CUDA]
    names = list(windows)
    spans: dict = {name: [] for name in names}
    for e in events:
        # the annotations' own device-side spans are left out
        if e.device_type != DeviceType.CUDA or e.name.startswith(WINDOW):
            continue
        start = e.time_range.start
        inside = ([i for a, b, i in on_device if a <= start <= b]
                  or [i for t, i in opened if t <= start])
        if inside:
            spans[names[inside[-1]]].append(e)
    return {name: window_profile(spans[name], walls_us[name])
            for name in names}


def window_profile(events, wall_us: float) -> dict:
    """Device time by kernel and idle share of one profiled window."""
    if not events:
        return {"device_time": "not measured", "wall_ms": wall_us / 1e3}
    by_name: dict = {}
    count: dict = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:70]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
        count[name] = count.get(name, 0) + 1
    busy_us = _interval_union(
        [(e.time_range.start, e.time_range.end) for e in events])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "kernels_ms": {n: us / 1e3 for n, us in top},
        "kernel_launches": {n: count[n] for n, _ in top},
    }


# -- the operator's tools ------------------------------------------------------

#: The hand-written kernels as a trace names them (each lives in an
#: anonymous namespace of its source), with the wrapper launch each counts in.
TRACE_KERNELS = {
    "gather_gramian_kernel": "gather_gramian_accumulate",
    "gather_gramian_reduce": "gather_gramian_accumulate.reduce",
    "spd_solve_warp_kernel": "spd_solve_batched",
    "spd_solve_kernel": "spd_solve_batched",
    "assign_kernel": "kmeans_assign_accumulate",
    "partial_kernel": "kmeans_assign_accumulate",
    "reduce_kernel": "kmeans_assign_accumulate",
}
#: a kernel's self ms in the trace against the profiler's own sum
TRACE_SELF_REL = 0.01
TOOLS_TOP = 20
TOOLS_TRAFFIC_S = 10.0
TOOLS_TRAFFIC_THREADS = 4
TOOLS_GAUGES = ("oryx_device_mfu", "oryx_device_hbm_bandwidth_fraction",
                "oryx_device_flops_per_second", "oryx_device_bytes_per_second")


def own_kernel(name: str) -> "str | None":
    """The hand-written kernel a trace event's name is, or None."""
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
    return m.group(1) if m and m.group(1) in TRACE_KERNELS else None


def op_lines(rows) -> list:
    """Op rows as ``trace_summary``'s trace mode prints them."""
    return [f"  {ms:10.2f}  x{cnt:<6d} {name[:90]}" for name, ms, cnt in rows]


def tools_trace(export: dict, n_windows: int) -> dict:
    """The profiled session's Chrome trace (``device_profiles``' export)
    read back by the port's ``trace_summary``: in process, every op row of
    a hand-written kernel has the count and, within 1%, the self ms of
    the profiler's own events of that name, and the kernels' counts are
    the wrappers' launches in the session (the sweep's three kernels one
    each a launch; the gather-Gramian's and the SPD solve's kernels one a
    launch, the gather-Gramian's reduce one a reduce launch); no
    ``gpu_user_annotation`` span (the windows) is an op row, and each
    window is in the windows section. Then ``python -m
    oryx_tpu_torch.tools.trace_summary <dir> --top 20`` exits 0 and prints
    the same top 20 op rows."""
    trace_dir = export["dir"]
    t0 = time.perf_counter()
    windows: list = []
    _, rows = trace_summary.summarize(trace_dir, top=1 << 30, windows=windows)
    summarize_s = time.perf_counter() - t0
    events = export["device_events"]
    kernels: dict = {}
    for name, ms, count in rows:
        base = own_kernel(name)
        if base is None:
            continue
        ev_count, ev_us = events.get(name, (0, 0.0))
        check(count == ev_count, f"tools: {name}: {count} in the trace, "
              f"{ev_count} device events in the profiler")
        check(abs(ms - ev_us / 1e3) <= TRACE_SELF_REL * ev_us / 1e3,
              f"tools: {name}: {ms} self ms in the trace, {ev_us / 1e3} ms in "
              "the profiler")
        k = kernels.setdefault(base, {"rows": 0, "count": 0, "self_ms": 0.0,
                                      "profiler_ms": 0.0})
        k["rows"] += 1
        k["count"] += count
        k["self_ms"] += ms
        k["profiler_ms"] += ev_us / 1e3
    row_names = {n for n, _, _ in rows}
    missed = [n for n in events if own_kernel(n) and n not in row_names]
    check(not missed, f"tools: device events of no op row: {missed}")
    for base in ("gather_gramian_kernel", "assign_kernel", "partial_kernel",
                 "reduce_kernel"):
        check(base in kernels, f"tools: no {base} op row: {sorted(kernels)}")
    spd = [b for b in ("spd_solve_warp_kernel", "spd_solve_kernel") if b in kernels]
    check(bool(spd), f"tools: no SPD kernel op row: {sorted(kernels)}")
    launches = export["launches"]
    counted: dict = {}
    for base, k in kernels.items():
        wrapper = TRACE_KERNELS[base]
        k["launches"] = launches[wrapper]
        if wrapper == "kmeans_assign_accumulate":  # three kernels a launch
            check(k["count"] == k["launches"], f"tools: {k['count']} {base} "
                  f"kernels in the trace, {k['launches']} sweep launches")
        else:
            counted[wrapper] = counted.get(wrapper, 0) + k["count"]
    for wrapper in ("gather_gramian_accumulate", "gather_gramian_accumulate.reduce",
                    "spd_solve_batched"):
        check(counted.get(wrapper, 0) == launches[wrapper],
              f"tools: {counted.get(wrapper, 0)} {wrapper} kernels in the trace, "
              f"{launches[wrapper]} launches in the session")
    window_names = {n for n, _, _ in windows}
    check(not window_names & row_names,
          f"tools: an annotation is an op row: {window_names}")
    want = {f"{WINDOW}:{i}" for i in range(n_windows)}
    check(want <= window_names, f"tools: windows {sorted(window_names)}, "
          f"expected {sorted(want)}")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.tools.trace_summary", trace_dir,
         "--top", str(TOOLS_TOP)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"tools: trace_summary exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    printed = cli.stdout.split(f"top {TOOLS_TOP} ops on matching tracks")[1]
    printed = printed.split("\n\n")[0].splitlines()[1:]
    check(printed == op_lines(rows[:TOOLS_TOP]),
          f"tools: the CLI's op rows {printed} differ from {op_lines(rows[:TOOLS_TOP])}")
    return {"export_s": export["export_s"], "trace_bytes": export["bytes"],
            "summarize_s": summarize_s, "cli_s": cli_s, "op_rows": len(rows),
            "kernels": kernels, "session_launches": launches,
            "windows": {n: {"ms": ms, "count": c} for n, ms, c in windows
                        if n.startswith(WINDOW)},
            "top_ops": [{"name": n[:90], "self_ms": ms, "count": c}
                        for n, ms, c in rows[:8]]}


def tools_metrics(client, port: int, device) -> dict:
    """``trace_summary``'s metrics view of the layer's ``/metrics``: from
    one fetched text, each device gauge's value in the tool's rows equals
    what :func:`rendered_gauge` reads (``oryx_device_mfu``, the HBM
    fraction, the two rates, and on the card ``oryx_device_memory_*``);
    then the tool's CLI on the URL exits 0 with its device-performance
    section."""
    status, _, data = client.request("GET", "/metrics")
    check(status == 200, f"tools: GET /metrics: {status}")
    text = data.decode()
    _, _, scalars = trace_summary.summarize_metrics(text)
    rows = {series: value for series, value, _ in trace_summary.device_perf_rows(scalars)}
    gauges: dict = {}
    for name, key, value in scalars:
        if name not in TOOLS_GAUGES and not name.startswith("oryx_device_memory_"):
            continue
        labels = ",".join(f'{k}="{v}"' for k, v in key)
        want = rendered_gauge(text, name, labels)
        series = name + ("{" + ",".join(f"{k}={v}" for k, v in key) + "}" if key else "")
        check(series in rows and (rows[series] == want
                                  or (rows[series] != rows[series] and want != want)),
              f"tools: {series}: the tool's row {rows.get(series)}, /metrics {want}")
        gauges[series] = want
    names = {s.split("{")[0] for s in gauges}
    need = {"oryx_device_mfu", "oryx_device_hbm_bandwidth_fraction"}
    if resolve(device).type == "cuda":
        need |= {"oryx_device_memory_bytes_in_use", "oryx_device_memory_peak_bytes"}
    check(need <= names, f"tools: device-performance rows {sorted(names)}, "
          f"expected {sorted(need)}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = trace_summary.main([f"http://127.0.0.1:{port}/metrics", "--metrics",
                                 "--top", "5"])
    out = printed.getvalue()
    check(rc == 0 and "device performance" in out and "MFU" in out,
          f"tools: trace_summary --metrics exited {rc}: {out[-1000:]}")
    return {"gauges": gauges, "histograms": out.count("\n  oryx_")}


def tools_trace_id(client, port: int, user: str) -> dict:
    """One ``/recommend`` with a ``traceparent`` of a fresh trace id, then
    ``trace_summary --trace-id`` on the layer's URL: the tree holds the
    ingress span, the coalescer's queue wait under it, and the device call
    with its batch-size and pad-waste attributes."""
    trace_id = spans.new_trace_id()
    status, _, data = client.request(
        "GET", f"/recommend/{user}?howMany=10",
        headers={"traceparent": f"00-{trace_id}-{spans.new_span_id()}-01"})
    check(status == 200, f"tools: traced /recommend: {status} {data[:200]!r}")
    want = ("http GET /recommend/{userID}", "coalescer.queue_wait",
            "coalescer.device_call")

    def tree():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = trace_summary.main([f"http://127.0.0.1:{port}", "--trace-id", trace_id])
        return rc, printed.getvalue()

    rc, out = tree()
    deadline = time.perf_counter() + 10
    while not (rc == 0 and all(w in out for w in want)) and time.perf_counter() < deadline:
        time.sleep(0.05)
        rc, out = tree()
    check(rc == 0 and all(w in out for w in want)
          and "batch.size=" in out and "pad.waste_rows=" in out,
          f"tools: trace_summary --trace-id exited {rc}: {out}")
    lines = out.splitlines()
    # each line: duration, " ms  ", two spaces a level, the span's name
    depth = {w: next(len(rest) - len(rest.lstrip())
                     for rest in (ln.split(" ms  ", 1)[-1] for ln in lines)
                     if rest.lstrip().startswith(w))
             for w in want}
    check(depth[want[0]] < depth[want[1]],
          f"tools: the queue wait is not under the ingress span: {out}")
    return {"trace_id": trace_id, "spans": int(lines[0].split(": ")[1].split()[0]),
            "tree": lines[1:-2]}


def traffic_run(port: int, n_users: int, n_items: int, threads: int,
                seconds: float) -> dict:
    """``traffic.TrafficRunner`` with the reference's ALS mix
    (``build_als_endpoints(n_users, n_items)``) at ``port``: ``threads``
    threads, no interval, ``seconds`` seconds. Run in a client process of
    its own (as ``http_load`` is), so the load's threads do not share the
    serving layer's interpreter. Returns the runner's counters, and per
    endpoint the requests sent and answered (2xx) with p50 / p99 ms of the
    answered."""
    endpoints = traffic.build_als_endpoints(n_users, n_items)
    sent = {e.name: 0 for e in endpoints}
    lock = threading.Lock()
    for e in endpoints:
        def counted(rng, make=e.make_request, name=e.name):
            with lock:
                sent[name] += 1
            return make(rng)
        e.make_request = counted
    runner = traffic.TrafficRunner([f"127.0.0.1:{port}"], endpoints, interval_ms=0,
                                   threads=threads, duration_sec=seconds)
    t0 = time.perf_counter()
    runner.run()
    elapsed = time.perf_counter() - t0
    by_endpoint = {}
    for e in endpoints:
        ms = np.asarray(e.latencies_ms)
        by_endpoint[e.name] = {
            "sent": sent[e.name], "answered": e.count,
            "p50_ms": float(np.percentile(ms, 50)) if len(ms) else None,
            "p99_ms": float(np.percentile(ms, 99)) if len(ms) else None}
    return {"seconds": elapsed, "threads": threads, "requests": runner.requests,
            "rps": runner.requests / elapsed, "client_errors": runner.client_errors,
            "server_errors": runner.server_errors, "exceptions": runner.exceptions,
            "endpoints": by_endpoint}


def tools_traffic(pool, port: int, loop: "LambdaLoop", layer) -> dict:
    """:func:`traffic_run` in the client process ``pool``, over the loop's
    ids (``LOOP_USERS`` users, ``N_ITEMS`` items), 4 threads,
    ``TOOLS_TRAFFIC_S`` seconds. Each endpoint is sent requests; no server
    error and no exception (a 404 for an id outside the loop's model is a
    client error, reported). Each answered ``/pref`` is one line on the
    input topic; the running speed layer folds them in and both managers
    apply its ``UP``s before the phase goes on."""
    input_start = loop.broker.size(loop.input_topic)
    since = len(loop.watch.commits)
    updates = loop.update_size()
    out = pool.apply(traffic_run, (port, LOOP_USERS, N_ITEMS,
                                   TOOLS_TRAFFIC_THREADS, TOOLS_TRAFFIC_S))
    sent = {name: e["sent"] for name, e in out["endpoints"].items()}
    check(all(sent.values()), f"tools: traffic sent no request to some endpoint: {sent}")
    check(out["server_errors"] == 0 and out["exceptions"] == 0,
          f"tools: traffic: {out['server_errors']} server errors, "
          f"{out['exceptions']} exceptions")
    input_end = loop.broker.size(loop.input_topic)
    prefs = out["endpoints"]["pref"]["answered"]
    check(input_end - input_start == prefs,
          f"tools: {prefs} /pref answered, {input_end - input_start} input lines")
    if prefs:
        t_last = time.perf_counter()
        loop.wait_commit(loop.speed_group, input_end, since, 120,
                         "tools: the speed generation of the traffic's /pref")
        update_end = loop.update_size()
        check(update_end > updates, "tools: the traffic's /pref published no UP")
        wait_until(lambda: applied_messages(layer) >= update_end, 120,
                   "tools: the layer applies the traffic's UPs",
                   layers=loop.layers, poll=0.001)
        loop.wait_applied(loop.served, update_end, 120,
                          "tools: the loop's manager applies the traffic's UPs")
        out["pref_ups"] = update_end - updates
        out["pref_to_applied_s"] = time.perf_counter() - t_last
    return out


# -- device cost accounting, memory telemetry, the profiler session -----------

#: the window of the rate gauges while the profiling phase reads them
PROFILING_WINDOW_S = 2.0
PROFILING_BROKER = "memory:profiling"


def rendered_gauge(text: str, name: str, labels: str = "") -> float:
    """A gauge's value in a Prometheus text rendering (``/metrics``'s);
    ``labels`` as rendered between the braces (``device="cuda:0"``)."""
    series = re.escape(f"{name}{{{labels}}}" if labels else name)
    m = re.search(rf"^{series} (\S+)$", text, re.M)
    check(m is not None, f"profiling: {name} missing from /metrics")
    return float(m.group(1))


def share(value: float, what: str) -> float:
    """A share of the card's peak, which must lie in (0, 1]: above 1 the
    count of work is wrong."""
    check(0.0 < value <= 1.0, f"profiling: {what} = {value}, not in (0, 1]")
    return value


def iteration_roofline(user_side, item_side, nnz: int, profile: dict) -> dict:
    """One profiled ALS iteration (``profiles["als_iteration"]``): its
    attributed FLOPs and bytes (the two halves' ``tr.half_cost``) over its
    device-busy time and over its wall time, against the H100's float32
    peak and HBM rate."""
    costs = [tr.half_cost(side, nnz, FEATURES, "float32")
             for side in (user_side, item_side)]
    flops, nbytes = sum(c[0] for c in costs), sum(c[1] for c in costs)
    out = {"flops": flops, "bytes": nbytes, "peak_flops": PEAK_FLOPS[torch.float32],
           "peak_bytes_per_s": HBM_BYTES_PER_S}
    check("device_busy_ms" in profile,
          f"profiling: the ALS iteration's profile recorded no device time: {profile}")
    for name, ms in (("busy", profile["device_busy_ms"]), ("wall", profile["wall_ms"])):
        out[f"{name}_ms"] = ms
        out[f"mfu_{name}"] = share(flops / (ms / 1e3) / PEAK_FLOPS[torch.float32],
                                   f"iteration MFU over its {name} time")
        out[f"hbm_{name}"] = share(nbytes / (ms / 1e3) / HBM_BYTES_PER_S,
                                   f"iteration HBM share over its {name} time")
    return out


def gauges_after_scan(model, qs, key: str, seconds: float) -> dict:
    """``model.top_n_batch(qs, 10)`` back to back for ``seconds`` (at least
    the rate window), then ``oryx_device_mfu`` and
    ``oryx_device_hbm_bandwidth_fraction`` read from the rendered
    ``/metrics`` text; beside them the same rates from the loop's own
    count and host clock."""
    model.top_n_batch(qs, 10)  # registers the signature's cost
    torch.cuda.synchronize()
    cost = profiling.costs().cost(key)
    check(cost is not None, f"profiling: {key} registered no cost")
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        model.top_n_batch(qs, 10)
        calls += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    text = metrics.default_registry().render()
    out = {"program": key, "flops_per_call": cost[0], "bytes_per_call": cost[1],
           "calls": calls, "seconds": elapsed, "ms_per_call": elapsed / calls * 1e3,
           "window_s": PROFILING_WINDOW_S,
           "mfu_gauge": share(rendered_gauge(text, "oryx_device_mfu"),
                              f"{key} oryx_device_mfu"),
           "hbm_fraction_gauge": share(
               rendered_gauge(text, "oryx_device_hbm_bandwidth_fraction"),
               f"{key} oryx_device_hbm_bandwidth_fraction"),
           "flops_per_s_gauge": rendered_gauge(text, "oryx_device_flops_per_second"),
           "mfu_loop": calls * cost[0] / elapsed / profiling.peak_flops_per_s(),
           "hbm_fraction_loop": calls * cost[1] / elapsed / profiling.peak_bytes_per_s()}
    return out


def memory_gauges_check() -> dict:
    """The card's memory gauges (``oryx_device_memory_*{device="cuda:0"}``)
    against ``torch.cuda``'s own readings, taken after a synchronise."""
    torch.cuda.synchronize()
    snap = metrics.default_registry().snapshot()
    stats = torch.cuda.memory_stats(0)
    label = 'device="cuda:0"'
    got = {k: snap.get(f"oryx_device_memory_{k}", {}).get(label)
           for k in ("bytes_in_use", "peak_bytes", "limit_bytes")}
    want = {"bytes_in_use": float(stats["allocated_bytes.all.current"]),
            "peak_bytes": float(stats["allocated_bytes.all.peak"]),
            "limit_bytes": float(torch.cuda.mem_get_info(0)[1])}
    check(got == want, f"profiling: memory gauges {got}, torch.cuda {want}")
    return got


def chrome_trace_events(trace_dir: str) -> dict:
    """A capture's Chrome trace, read back: its events and kernel events."""
    traces = list(Path(trace_dir).glob("*.pt.trace.json"))
    check(len(traces) == 1, f"profiling: {trace_dir} holds {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"events": len(events), "device_events": len(kernels),
            "bytes": traces[0].stat().st_size,
            "kernels": sorted({e.get("name", "")[:60] for e in kernels})[:8]}


def profiling_layer(device=None):
    """A ``ServingLayer`` on ``device`` (None: the card) with no model (an
    empty update topic of its own): the ``POST /debug/profile`` route of a
    live process."""
    conf = oryx_config.overlay_on({
        "oryx.id": "profiling",
        "oryx.input-topic.broker": PROFILING_BROKER,
        "oryx.update-topic.broker": PROFILING_BROKER,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.api.read-only": True,
    }, oryx_config.get_default())
    return start_layer(conf, "profiling", device)


def debug_profile_busy(port: int) -> dict:
    """``POST /debug/profile`` while another torch profiler runs in this
    process: 409."""
    client = HttpClient(port)
    try:
        status, _, data = client.request("POST", "/debug/profile?seconds=1")
    finally:
        client.close()
    check(status == 409, f"profiling: /debug/profile during the smoke's "
          f"session: {status} {data[:200]!r}")
    return {"status": status, "body": data.decode()[:160]}


def debug_profile_capture(port: int, model, qs) -> dict:
    """One real ``POST /debug/profile`` capture with top-N work on the
    flagship inside its window (a thread calling ``top_n_batch``): 200 and
    a readable Chrome trace; its count of device events is reported."""
    stop = threading.Event()
    calls = [0]

    def work():
        while not stop.is_set():
            model.top_n_batch(qs, 10)
            calls[0] += 1

    worker = threading.Thread(target=work, daemon=True)
    client = HttpClient(port)
    worker.start()
    try:
        t0 = time.perf_counter()
        status, _, data = client.request("POST", "/debug/profile?seconds=1")
        capture_s = time.perf_counter() - t0
    finally:
        stop.set()
        worker.join()
        client.close()
    check(status == 200, f"profiling: /debug/profile: {status} {data[:200]!r}")
    body = json.loads(data)
    # gated on a readable trace; its device events are reported (a
    # session begun after another may record none: profiler_gap.py)
    return {"status": status, "capture_s": capture_s, "top_n_calls": calls[0],
            "trace": chrome_trace_events(body["trace_dir"])}


def profiling_phase(layer_port: int, busy: dict, profiles: dict, user_side,
                    item_side, nnz: int, flagship, rng) -> dict:
    """The ``profiling`` line (see the module docstring). ``flagship`` is
    the 1M × 50 model (:func:`flagship_model`), made before the smoke's
    profiler session so that the ``/debug/profile`` capture comes first,
    right after that session closes."""
    t_phase = time.perf_counter()
    model = flagship
    qs = rng.standard_normal((256, FEATURES), dtype=np.float32)
    out = {"debug_profile_during_session": busy,
           "debug_profile": debug_profile_capture(layer_port, model, qs),
           "peaks": {"flops": profiling.peak_flops_per_s(),
                     "bytes_per_s": profiling.peak_bytes_per_s()},
           "trains": list(TRAIN_COSTS)}
    # the H100's figures from the device name: the gauges' yardstick is
    # the bounds' (PEAK_FLOPS, HBM_BYTES_PER_S)
    check(out["peaks"] == {"flops": PEAK_FLOPS[torch.float32],
                           "bytes_per_s": HBM_BYTES_PER_S},
          f"profiling: auto peaks {out['peaks']}, not the H100's")
    out["iteration"] = iteration_roofline(user_side, item_side, nnz,
                                          profiles["als_iteration"])
    int8 = ALSServingModel(FEATURES, True, device_dtype="int8", device=model.device)
    int8.y = model.y  # the same store
    profiling.configure(oryx_config.overlay_on(
        {"oryx.profiling.window-sec": PROFILING_WINDOW_S}, oryx_config.get_default()))
    try:
        out["scan_f32"] = gauges_after_scan(model, qs, "als.top_n_batch/b256",
                                            PROFILING_WINDOW_S + 0.5)
        out["scan_int8"] = gauges_after_scan(int8, qs, "als.top_n_batch/b256+int8",
                                             PROFILING_WINDOW_S + 0.5)
    finally:
        profiling.configure(oryx_config.get_default())
    # the int8 snapshot's bytes are among the quantized-factor gauge's
    out["quantized_bytes"] = {
        "snapshot": int8.y_snapshot().quantized_nbytes(),
        "gauge": metrics.default_registry().snapshot()[
            "oryx_device_quantized_factor_bytes"][""]}
    check(out["quantized_bytes"]["gauge"] >= out["quantized_bytes"]["snapshot"] > 0,
          f"profiling: quantized bytes {out['quantized_bytes']}")
    del int8, model
    torch.cuda.empty_cache()
    out["memory_gauges"] = memory_gauges_check()
    bundle = blackbox.bundle("smoke")
    check("memory" in bundle and "cuda:0" in bundle["memory"]["devices"],
          f"profiling: the bundle's memory section {bundle.get('memory')}")
    out["bundle_memory"] = bundle["memory"]
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- serve ------------------------------------------------------------------


def overlap_with_exact(results, qs: np.ndarray, y: np.ndarray, ids,
                       excluded_rows=None, how_many: int = 10) -> float:
    """Mean share of each query's top-N that an exact float64 scan on the
    host also ranks in its top-N."""
    y64 = y.astype(np.float64)
    hits = 0
    for b, res in enumerate(results):
        scores = y64 @ qs[b].astype(np.float64)
        if excluded_rows is not None:
            scores[excluded_rows[b]] = -np.inf
        top = np.argpartition(-scores, how_many)[:how_many]
        hits += len({ids[j] for j in top} & {i for i, _ in res})
    return hits / (how_many * len(results))


def serve_trained(batch, x, y, rng):
    users, items = batch.users, batch.items
    model = state.serving_model(x, y, users.index_to_id, items.index_to_id)
    starts = np.searchsorted(batch.rows, np.arange(len(users) + 1))
    chosen = rng.choice(len(users), size=256, replace=False)
    for u in chosen:
        cols = batch.cols[starts[u]:starts[u + 1]]
        model.add_known_items(users.index_to_id[u],
                              [items.index_to_id[c] for c in cols])
    excluded = [model.get_known_items(users.index_to_id[u]) for u in chosen]
    qs = x[torch.as_tensor(chosen, device=x.device)].cpu().numpy()
    t0 = time.perf_counter()
    res = model.top_n_batch(qs, 10, excluded=excluded)
    serve_s = time.perf_counter() - t0
    check(all(len(r) == 10 for r in res), "serve: short top-10 list")
    for r, ex in zip(res, excluded):
        check(not ({i for i, _ in r} & ex), "serve: a known item came back")
    excl_rows = [batch.cols[starts[u]:starts[u + 1]] for u in chosen]
    ov = overlap_with_exact(res, qs, y.cpu().numpy(), items.index_to_id,
                            excl_rows)
    check(ov >= 0.99, f"serve: overlap with the exact scan {ov} < 0.99")
    return {"queries": len(chosen), "seconds": serve_s, "overlap": ov}


def flagship_model(rng):
    """A serving model on the card holding 1M items × 50 seeded features:
    (model, Y, ids); Y is loaded, not yet uploaded."""
    y = rng.standard_normal((FLAGSHIP_ITEMS, FEATURES), dtype=np.float32)
    ids = [f"i{j}" for j in range(FLAGSHIP_ITEMS)]
    model = ALSServingModel(FEATURES, True)
    model.bulk_load_items(ids, y)
    return model, y, ids


def serve_flagship(rng):
    """top_n_batch at 1M items × 50 features, seeded factors; and the host
    microseconds of ``y_snapshot()`` with nothing changed (1,000 calls), the
    per-query cost of taking the served matrix. Returns the record and the
    model with its items (``serving_quant`` serves them again)."""
    t0 = time.perf_counter()
    model, y, ids = flagship_model(rng)
    model.y_snapshot()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    snapshot_s = []
    for _ in range(1000):
        t0 = time.perf_counter()
        model.y_snapshot()
        snapshot_s.append(time.perf_counter() - t0)
    us = np.asarray(snapshot_s) * 1e6
    out = {"items": FLAGSHIP_ITEMS, "features": FEATURES, "load_s": load_s,
           "y_snapshot_unchanged_us": {"median": float(np.median(us)),
                                       "p90": float(np.percentile(us, 90)),
                                       "calls": len(us)}}
    for batch_size, reps in ((1, 50), (16, 30), (256, 15)):
        qs = rng.standard_normal((batch_size, FEATURES), dtype=np.float32)
        res = model.top_n_batch(qs, 10)  # warm-up, and the result checked
        ov = overlap_with_exact(res, qs, y, ids)
        check(ov >= 0.99, f"flagship b{batch_size}: overlap {ov} < 0.99")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.top_n_batch(qs, 10)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[f"b{batch_size}"] = {"median_s": med, "qps": batch_size / med,
                                 "p90_s": float(np.percentile(times, 90)),
                                 "overlap": ov}
    return out, model, y, ids


# -- the serving representations ---------------------------------------------


def host_top_n_s(model, qs, reps: int) -> float:
    """Median host seconds of ``model.top_n_batch(qs, 10)`` (after one
    untimed call)."""
    model.top_n_batch(qs, 10)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.top_n_batch(qs, 10)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def scan_flops(batch: int, n: int, k: int) -> float:
    """The FLOPs of one scoring product of a serving scan: ``batch``
    queries against ``n`` rows of ``k`` features."""
    return 2.0 * batch * n * k


def scan_program(name: str, fn, nbytes: float, flops: float, f32: dict,
                 dtype=torch.float32) -> dict:
    """One device program of a serving scan timed by CUDA events (``INNER``
    calls a pair), its bound (the bytes it must read, or ``flops`` at the
    peak of ``dtype``'s products), beside ``f32``: the float32 flat scan at
    the same shape."""
    ms = time_ms(fn, reps=11, warmup=2, inner=INNER)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {"program": name, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "f32_flat_ms": f32["ms"],
            "f32_flat_bound_ms": f32["bound_ms"]}


def f32_flat_scan(mat, qs, top: int) -> dict:
    """The float32 flat scan (one product, ``torch.topk``) timed as
    :func:`scan_program` times, with its byte bound."""
    n, k = mat.shape
    return {"ms": time_ms(lambda: torch.topk(qs @ mat.T, top, dim=1), reps=11,
                          warmup=2, inner=INNER),
            "bound_ms": bound(4 * n * k, 2.0 * len(qs) * n * k, torch.float32)[0]}


def exact_top10(y64: np.ndarray, qs: np.ndarray) -> list:
    """Each query's exact top-10 rows by a float64 scan on the host."""
    out = []
    for a in range(0, len(qs), 32):
        scores = y64 @ qs[a:a + 32].astype(np.float64).T
        out.extend(set(np.argpartition(-scores[:, b], 10)[:10].tolist())
                   for b in range(scores.shape[1]))
    return out


def int8_scan_memory(snap, qs_host, r: int) -> dict:
    """Device bytes the int8 candidate scan allocates beyond what was
    allocated before it (``torch.cuda.max_memory_allocated``, reset just
    before), against one float32 copy of the slab."""
    qs = torch.as_tensor(qs_host, device=snap.qmat.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    serving_mod._quant_candidates(snap, qs, r)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    f32_copy = snap.n * snap.qmat.shape[1] * 4
    out = {"batch": len(qs_host), "allocated_before": base, "peak": peak,
           "transient": peak - base, "f32_slab_bytes": f32_copy,
           "chunk_rows": serving_mod._scan_rows(len(qs_host), snap.qmat.shape[1])}
    check(out["transient"] < f32_copy,
          f"serving_quant: the int8 scan took {out['transient']} bytes, not "
          f"below one float32 copy of the slab ({f32_copy})")
    return out


def check_int8_scores(results, qs, y, ids_index, label: str) -> float:
    """Every returned score equals its float64 dot within 1e-4 relative;
    returns the largest relative error."""
    worst = 0.0
    for b, res in enumerate(results):
        for id_, score in res:
            exact = float(y[ids_index[id_]].astype(np.float64) @ qs[b].astype(np.float64))
            worst = max(worst, abs(score - exact) / max(abs(exact), 1e-12))
    check(worst <= 1e-4, f"{label}: a score is {worst} from its float64 dot")
    return worst


def check_lsh_candidates(model, results, qs) -> int:
    """Every returned item lies in a candidate bucket of its query."""
    lsh = model.lsh
    n = 0
    for b, res in enumerate(results):
        cands = set(lsh.get_candidate_indices(qs[b]).tolist())
        rows = np.stack([model.y.get_vector(i) for i, _ in res])
        check(set(lsh.assign_buckets(rows).tolist()) <= cands,
              "serving_quant: an LSH answer lies outside its query's buckets")
        n += len(res)
    return n


def flat_representations(flagship, y, ids, rng) -> dict:
    """int8, bfloat16 and float32 + LSH at 0.3 on the flagship's 1M × 50
    items (the models share its store): ``top_n_batch`` host seconds at
    batch 1, 16 and 256 beside float32 with their checks, the device
    programs alone at batch 16 and 256, and the int8 scan's transient."""
    dev = flagship.device
    models = {"float32": flagship}
    for label, kw in (("int8", {"device_dtype": "int8"}),
                      ("bfloat16", {"device_dtype": "bfloat16"}),
                      ("lsh_0.3", {"sample_rate": QUANT_LSH_RATE})):
        m = ALSServingModel(FEATURES, True, device=dev, **kw)
        m.y = flagship.y  # the same store: the same ids and rows
        models[label] = m
    n, k = len(ids), FEATURES
    out: dict = {"items": n, "features": k, "lsh_rate": QUANT_LSH_RATE,
                 "models": {}}
    snaps = {}
    for label, m in models.items():
        t0 = time.perf_counter()
        snaps[label] = snap = m.y_snapshot()
        torch.cuda.synchronize()
        rec = {"snapshot_s": time.perf_counter() - t0,
               "snapshot_type": type(snap).__name__,
               "device_bytes": snap.device_nbytes()}
        if label == "int8":
            rec["quantized_nbytes"] = snap.quantized_nbytes()
            want = n * k + 4 * n
            check(rec["quantized_nbytes"] == want,
                  f"serving_quant: int8 holds {rec['quantized_nbytes']} bytes, not {want}")
        out["models"][label] = rec
    ids_index = {id_: j for j, id_ in enumerate(ids)}
    y64 = y.astype(np.float64)
    for batch_size, reps in ((1, 30), (16, 20), (256, 10)):
        qs = rng.standard_normal((batch_size, k), dtype=np.float32)
        truth = exact_top10(y64, qs)
        for label, m in models.items():
            res = m.top_n_batch(qs, 10)
            check(all(len(r) == 10 for r in res), f"serving_quant {label}: short list")
            ov = sum(len(truth[b] & {ids_index[i] for i, _ in r})
                     for b, r in enumerate(res)) / (10 * batch_size)
            med = host_top_n_s(m, qs, reps)
            entry = {"median_s": med, "qps": batch_size / med, "overlap": ov}
            if label == "int8":
                entry["max_rel_err"] = check_int8_scores(res, qs, y, ids_index,
                                                         f"int8 b{batch_size}")
                check(ov >= 0.99, f"serving_quant int8 b{batch_size}: overlap {ov}")
            elif label == "lsh_0.3":
                entry["answers_in_buckets"] = check_lsh_candidates(m, res, qs)
            else:
                check(ov >= 0.95, f"serving_quant {label} b{batch_size}: overlap {ov}")
            out["models"][label][f"b{batch_size}"] = entry
    del y64
    # the device programs alone, at batch 16 and 256
    f32, q8, b16, lsh_snap = (snaps[x] for x in ("float32", "int8", "bfloat16",
                                                 "lsh_0.3"))
    lsh_m = models["lsh_0.3"]
    programs = []
    for b in (16, 256):
        qs_host = rng.standard_normal((b, k), dtype=np.float32)
        qs = torch.as_tensor(qs_host, device=dev)
        top = 16  # top_n_batch's k at how_many = 10
        r = serving_mod._round_up_pow2(max(int(4.0 * 10), 16))  # rescore width
        flops = scan_flops(b, n, k)
        base = f32_flat_scan(f32.mat, qs, top)
        programs.append({"batch": b, "r": r, **scan_program(
            "int8 scan", lambda: serving_mod._quant_candidates(q8, qs, r),
            n * k + 4 * n, flops, base)})
        programs.append({"batch": b, **scan_program(
            "bf16 scan", lambda: torch.topk(serving_mod._score(qs, b16.score_mat),
                                            top, dim=1),
            2 * n * k, flops, base, torch.bfloat16)})
        lut = lsh_m._build_lut(qs_host)
        programs.append({"batch": b, "lsh_rate": QUANT_LSH_RATE, **scan_program(
            "LSH-masked scan", lambda: torch.topk(serving_mod._masked_scores(
                lsh_snap.mat, qs, lut[:, lsh_snap.buckets]), 64, dim=1),
            4 * n * k + 4 * n + lut.numel(), flops, base)})
    out["programs"] = programs
    out["int8_scan_memory"] = [int8_scan_memory(q8, rng.standard_normal(
        (b, k), dtype=np.float32), 64) for b in (1, 256)]
    return out


def planted_catalog(rng):
    """``bench.py``'s IVF catalog (``oryx_tpu``'s index section): 2,048
    centres (standard normal × 2), 1,024 items around each (noise 0.25)."""
    centers = rng.standard_normal((IVF_CENTERS, FEATURES), dtype=np.float32) * 2.0
    items = np.repeat(centers, IVF_N // IVF_CENTERS, axis=0)
    items += rng.standard_normal(items.shape, dtype=np.float32) * 0.25
    return centers, items, [f"i{j}" for j in range(len(items))]


def recall_at_10(model, qs, exact_top) -> float:
    hits = 0
    for b in range(len(qs)):
        got = {int(i[1:]) for i, _ in model.top_n(qs[b], 10)}
        hits += len(got & exact_top[b])
    return hits / (10 * len(qs))


def ivf_phase(rng, device=None) -> dict:
    """The IVF index at ``bench.py``'s shape (2,097,152 × 50, 2,048 cells,
    8 probes) beside flat int8 on the same store: build split by step,
    recall@10 of 32 queries against an exact float64 scan (>= 0.99 both),
    qps at batch 16 and 256, the probe and the cell scan alone, and a
    burst of changed and new rows whose incremental snapshot must hold the
    same cell tables, bit for bit, as a rebuild with the same centroids."""
    dev = resolve(device)
    centers, items, ids = planted_catalog(rng)
    n, k = items.shape
    t0 = time.perf_counter()
    m = ALSServingModel(k, True, device_dtype="int8", index_enabled=True,
                        index_cells=IVF_CENTERS, index_probes=IVF_PROBES, device=dev)
    m.bulk_load_items(ids, items)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = m.y_snapshot()
    build_s = time.perf_counter() - t0
    check(isinstance(snap, ivf_mod.IVFSnapshot), "ivf: not an IVF snapshot")
    flat = ALSServingModel(k, True, device_dtype="int8", device=dev)
    flat.y = m.y  # the same store: measure the index, not a second slab
    t0 = time.perf_counter()
    flat_snap = flat.y_snapshot()
    flat_build_s = time.perf_counter() - t0
    out = {"items": n, "features": k, "cells": snap.n_cells, "probes": snap.probes,
           "cell_width": snap.cell_width, "skew": snap.skew(), "load_s": load_s,
           "build_s": build_s, "build": snap.build_timings,
           "device_bytes": snap.device_nbytes(),
           "quantized_bytes": snap.quantized_nbytes(),
           "flat_int8": {"build_s": flat_build_s,
                         "device_bytes": flat_snap.device_nbytes()}}
    # recall against an exact float64 scan
    qs = (centers[rng.integers(0, IVF_CENTERS, IVF_RECALL_QUERIES)]
          + rng.standard_normal((IVF_RECALL_QUERIES, k), dtype=np.float32) * 0.25)
    exact_top = exact_top10(items.astype(np.float64), qs)
    out["recall_at_10"] = recall_at_10(m, qs, exact_top)
    out["flat_int8"]["recall_at_10"] = recall_at_10(flat, qs, exact_top)
    check(out["recall_at_10"] >= 0.99, f"ivf: recall@10 {out['recall_at_10']} < 0.99")
    check(out["flat_int8"]["recall_at_10"] >= 0.99,
          f"ivf: flat int8 recall@10 {out['flat_int8']['recall_at_10']} < 0.99")
    # qps beside flat int8, and the device programs alone
    queries = (centers[rng.integers(0, IVF_CENTERS, 256)]
               + rng.standard_normal((256, k), dtype=np.float32) * 0.25)
    mat32 = torch.as_tensor(items, device=dev)
    programs = []
    for b, reps in ((16, 20), (256, 10)):
        ivf_s = host_top_n_s(m, queries[:b], reps)
        flat_s = host_top_n_s(flat, queries[:b], reps)
        out[f"b{b}"] = {"ivf_qps": b / ivf_s, "flat_int8_qps": b / flat_s,
                        "ivf_median_s": ivf_s, "flat_int8_median_s": flat_s}
        qs_t = torch.as_tensor(queries[:b], device=dev)
        cells = ivf_mod._probe_cells(snap.centroids, qs_t, snap.probes)
        r = ivf_mod._candidate_width(m, snap, snap.probes, 10)
        distinct = int(torch.unique(cells).numel())
        base = f32_flat_scan(mat32, qs_t, 16)
        programs.append({"batch": b, **scan_program(
            "IVF probe", lambda: ivf_mod._probe_cells(snap.centroids, qs_t, snap.probes),
            snap.n_cells * k * 4, 2.0 * b * snap.n_cells * k, base)})
        # the probed cells' int8 rows, scales and positions, each read once
        programs.append({"batch": b, "distinct_cells": distinct, "r": r, **scan_program(
            "IVF scan", lambda: ivf_mod._ivf_candidates(
                snap.cell_pos, snap.cell_q, snap.cell_scale, qs_t, cells, None, r),
            distinct * snap.cell_width * (k + 4 + 4),
            2.0 * b * snap.probes * snap.cell_width * k, base)})
    out["programs"] = programs
    del mat32
    # a burst: changed rows moved to other centres, new rows
    t0 = time.perf_counter()
    moved = rng.choice(n, IVF_BURST_CHANGED, replace=False)
    targets = centers[rng.integers(0, IVF_CENTERS, IVF_BURST_CHANGED)]
    for j, tgt in zip(moved.tolist(), targets):
        m.set_item_vector(ids[j], tgt + rng.standard_normal(k, dtype=np.float32) * 0.25)
    for j in range(IVF_BURST_NEW):
        m.set_item_vector(f"new{j}", centers[j % IVF_CENTERS]
                          + rng.standard_normal(k, dtype=np.float32) * 0.25)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1 = m.y_snapshot()
    torch.cuda.synchronize()
    incremental_s = time.perf_counter() - t0
    check(s1.centroids_np is snap.centroids_np and s1.n == n + IVF_BURST_NEW,
          "ivf: the burst did not take the incremental path")
    t0 = time.perf_counter()
    ids2, host, version, view = m.y.host_matrix()
    s2 = ivf_mod.IVFSnapshot.build(ids2, host, version, None, view,
                                   centroids=s1.centroids_np,
                                   cell_width=s1.cell_width, probes=s1.probes,
                                   device=dev)
    rebuild_s = time.perf_counter() - t0
    same = {name: bool(torch.equal(getattr(s1, name), getattr(s2, name)))
            for name in ("cell_pos", "cell_q", "cell_scale", "cell_norms")}
    same["cell_len"] = bool((s1.cell_len == s2.cell_len).all())
    check(all(same.values()), f"ivf: incremental cells differ from a rebuild: {same}")
    out["burst"] = {"changed": IVF_BURST_CHANGED, "new": IVF_BURST_NEW,
                    "write_s": write_s, "incremental_s": incremental_s,
                    "rebuild_s": rebuild_s, "rebuild": s2.build_timings,
                    "equal_to_rebuild": same, "skew_after": s1.skew()}
    return out


def serving_quant_phase(flagship, y, ids, rng, device=None) -> dict:
    """The serving representations on the card (see the module docstring):
    flat int8, bfloat16 and LSH on the flagship's items, then the IVF
    index at ``bench.py``'s shape. The launch counters are set to 0 first:
    no kernel may launch."""
    K.reset_launches()
    t_phase = time.perf_counter()
    out = {"flat": flat_representations(flagship, y, ids, rng)}
    torch.cuda.empty_cache()
    out["ivf"] = ivf_phase(rng, device)
    torch.cuda.empty_cache()
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"serving_quant: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


class SmokeRescorer(Rescorer):
    """Filters the items whose id hashes to 0 modulo ``mod`` and lifts the
    others' scores by up to 6% (so the order changes)."""

    def __init__(self, mod: int):
        self.mod = mod

    def rescore(self, id_, score):
        h = zlib.crc32(id_.encode())
        return float("nan") if h % self.mod == 0 else score * (1.0 + 0.01 * (h % 7))


class SmokeRescorerProvider(RescorerProvider):
    """The smoke's ``oryx.als.rescorer-provider-class``: ``/recommend``'s
    ``rescorerParams`` is the filter's modulus."""

    def __init__(self, config=None):
        pass

    def get_recommend_rescorer(self, user_ids, args):
        return SmokeRescorer(int(args[0]) if args else 5)


def serving_quant_http(loop: "LambdaLoop", rng, device=None) -> dict:
    """A ``ServingLayer`` on the loop's update topic serving from int8 with
    the IVF index and LSH at 0.3, with ``SmokeRescorerProvider``: 1,000
    users' ``/recommend`` with ``rescorerParams`` against the layer's own
    model's ``top_n`` with the same hooks, and ``/similarity`` against its
    ``top_n_cosine``; no 5xx. No kernel may launch."""
    K.reset_launches()
    t_phase = time.perf_counter()
    total = loop.update_size()
    conf = loop.conf.with_values({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.device-dtype": "int8",
        "oryx.serving.index.enabled": True,
        "oryx.als.sample-rate": QUANT_LSH_RATE,
        "oryx.als.rescorer-provider-class": "chip_smoke.SmokeRescorerProvider",
    })
    out: dict = {"update_messages": total}
    layer, port, t_start, threads = start_layer(conf, "serving_quant_http", device)
    client = HttpClient(port)
    statuses: dict = {}
    try:
        wait_until(lambda: client.request("GET", "/ready")[0] == 200, 300,
                   "serving_quant_http: /ready", layers=loop.layers, poll=0.01)
        t_current = wait_until(lambda: applied_messages(layer) >= total, 300,
                               "serving_quant_http: the replay",
                               layers=loop.layers, poll=0.01)
        out["replay_to_current_s"] = t_current - t_start
        model = layer.manager.get_model()
        snap = model.y_snapshot()
        out["snapshot"] = {"type": type(snap).__name__, "n": snap.n,
                           "cells": snap.n_cells, "cell_width": snap.cell_width,
                           "lsh_buckets": snap.cell_buckets is not None,
                           "device": str(snap.cell_q.device)}
        check(isinstance(snap, ivf_mod.IVFSnapshot) and snap.cell_buckets is not None
              and snap.cell_q.device.type == layer.device.type,
              f"serving_quant_http: the layer serves {out['snapshot']}")
        provider = layer.manager.rescorer_provider
        check(isinstance(provider, RescorerProvider), "serving_quant_http: no provider")
        users = model.all_user_ids()
        sample = [users[j] for j in rng.choice(len(users), HTTP_USERS, replace=False)]
        t0 = time.perf_counter()
        for j, u in enumerate(sample):
            mod = 3 + j % 5
            rescorer = provider.get_recommend_rescorer([u], [str(mod)])
            want = model.top_n(model.get_user_vector(u), 10, 0,
                               lambda i, r=rescorer: not r.is_filtered(i),
                               rescorer.rescore, excluded=model.get_known_items(u))
            path = f"/recommend/{u}?howMany=10&rescorerParams={mod}"
            status, _, data = client.request("GET", path)
            statuses[status] = statuses.get(status, 0) + 1
            check(status == 200, f"serving_quant_http: GET {path}: {status}")
            got = json.loads(data)
            check(all(zlib.crc32(e["id"].encode()) % mod for e in got),
                  f"serving_quant_http: {path} returned a filtered item")
            check_same_top_n(got, want, f"serving_quant_http {path}")
        out["recommend_checked"] = {"users": len(sample),
                                    "seconds": time.perf_counter() - t0}
        items = model.all_item_ids()
        for _ in range(HTTP_QUANT_SIMILARITY):
            i1, i2 = (items[j] for j in rng.choice(len(items), 2, replace=False))
            qs = np.stack([model.get_item_vector(i1), model.get_item_vector(i2)])
            path = f"/similarity/{i1}/{i2}"
            status, _, data = client.request("GET", path)
            statuses[status] = statuses.get(status, 0) + 1
            check(status == 200, f"serving_quant_http: GET {path}: {status}")
            check_same_top_n(json.loads(data), model.top_n_cosine(
                qs, 10, 0, lambda i: i not in {i1, i2}), f"serving_quant_http {path}")
        out["similarity_checked"] = HTTP_QUANT_SIMILARITY
    finally:
        client.close()
        closed = close_layer(layer, port, "serving_quant_http", threads)
    out["statuses"] = statuses
    check(not any(s >= 500 for s in statuses), f"serving_quant_http: {statuses}")
    out.update(closed)
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"serving_quant_http: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- ALS generation ---------------------------------------------------------


class RecordingProducer:
    """An update-topic producer that records ``(key, message, headers)``."""

    def __init__(self):
        self.sent = []

    def send(self, key, message, headers=None):
        self.sent.append((key, message, headers))


def aligned_copy(value):
    """A contiguous copy of a tensor at the same offset from a 16-byte
    boundary, so a kernel given the copy takes the same load path; any
    other value as it is."""
    if not isinstance(value, torch.Tensor):
        return value
    off = (value.data_ptr() % 16) // value.element_size()
    flat = torch.empty(value.numel() + off, dtype=value.dtype,
                       device=value.device)
    return flat[off:].view(value.shape).copy_(value)


def copy_outputs(out):
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


def gg_key(args, kwargs) -> tuple:
    y, scols = args[0], args[2]
    return (kwargs["block"] + 1, *scols.shape, y.shape[1], str(y.dtype))


def spd_key(args, kwargs) -> tuple:
    return tuple(args[1].shape)


def sweep_key(args, kwargs) -> tuple:
    points, _, centers = args
    return (*points.shape, centers.shape[0])


class FirstLaunches:
    """For the length of a ``with`` block, wraps kernel wrappers where a path
    looks them up (``(module, name, key)`` each, ``key`` giving the shape
    that ``K.SHAPE_LAUNCHES`` counts the launch under) and keeps, for the
    first call at each shape, copies of its inputs and of what it returned:
    the launches a path made, to hold against the plain versions after it.
    Calls from several threads are recorded under a lock."""

    def __init__(self, targets):
        self.targets = targets
        self.calls: dict = {}
        self.saved: list = []
        self.lock = threading.Lock()

    def _wrap(self, name, fn, key):
        def recorded(*args, **kwargs):
            shape = key(args, kwargs)
            with self.lock:
                first = (name, shape) not in self.calls
                if first:
                    self.calls[(name, shape)] = None
            if not first:
                return fn(*args, **kwargs)
            inputs = ([aligned_copy(a) for a in args],
                      {k: aligned_copy(v) for k, v in kwargs.items()})
            out = fn(*args, **kwargs)
            with self.lock:
                self.calls[(name, shape)] = (*inputs, copy_outputs(out))
            return out
        return recorded

    def __enter__(self):
        for module, name, key in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn, key))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()
        return False


def max_errs(pairs) -> tuple[float, float]:
    """The largest |output − plain| over (output, plain) pairs, and the
    largest of each such difference over its plain output's largest
    magnitude."""
    diffs = [(float((o - p).abs().max()), float(p.abs().max())) for o, p in pairs]
    return max(d for d, _ in diffs), max(d / m for d, m in diffs)


def hold_path_launches(first: FirstLaunches, counted: dict, phase: str) -> list:
    """Every shape at which ``phase``'s path launched a kernel, held against
    the plain version on the inputs of its first launch there: the wrapper
    called again on them must return the same bits as on the path, and
    those must agree with the plain version within the kernel phases'
    tolerances — 1e-4 of the plain output's largest magnitude for the
    gather-Gramian and the SPD solve (float32 sums and eliminations in
    another order), and for the sweep ``sweep_check``'s with near ties
    allowed (the path's own centres: two may share a blob, so a point may
    lie within a rounding of both). ``counted`` is ``K.SHAPE_LAUNCHES`` as
    read just after the path; every shape counted there must have been
    recorded."""
    wanted = {(kernel.split(".")[0], shape) for kernel, shape in counted
              if not kernel.endswith(".reduce")}
    check(set(first.calls) == wanted,
          f"{phase}: recorded shapes {sorted(first.calls)} are not the "
          f"counted ones {sorted(wanted)}")
    out = []
    for (name, shape), (args, kwargs, path_out) in sorted(first.calls.items()):
        label = f"{phase} {name} {shape}"
        got = getattr(K, name)(*args, **kwargs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        path_out = path_out if isinstance(path_out, tuple) else (path_out,)
        check(all(torch.equal(g, p) for g, p in zip(got, path_out)),
              f"{label}: the wrapper gives other bits than on the path")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{label}: non-finite output")
        entry = {"kernel": name, "shape": list(shape),
                 "path_launches": counted.get(
                     (f"{name}.{K.spd_variant(shape[1])}"
                      if name == "spd_solve_batched" else name, shape), 0)}
        if name == "kmeans_assign_accumulate":
            entry.update(sweep_check(*args, near_ties=True, label=label),
                         tol=1e-4, cost_tol=1e-5)
        else:
            plain = (K.gather_gramian_accumulate_plain(*args,
                                                       block=kwargs["block"])
                     if name == "gather_gramian_accumulate"
                     else (K.spd_solve_batched_plain(*args),))
            abs_err, rel_err = max_errs(zip(got, plain))
            check(rel_err < 1e-4, f"{label}: rel err {rel_err} >= 1e-4")
            entry.update(max_abs_err=abs_err, max_rel_err=rel_err, tol=1e-4)
        out.append(entry)
    return out


def known_items_of(lines) -> dict:
    """Each user's items over ``user,item,...`` lines, sorted: what the
    ``UP`` X messages carry."""
    known: dict = {}
    for ln in lines:
        user, item = ln.split(",", 2)[:2]
        known.setdefault(user, set()).add(item)
    return {u: sorted(items) for u, items in known.items()}


def read_part_files(path: Path):
    ids, vecs = [], []
    for id_, vec in als_codec.read_features(path):
        ids.append(id_)
        vecs.append(vec)
    return ids, np.stack(vecs)


def check_update_stream(sent, meta, train_users, known) -> dict:
    """One ``MODEL`` (or ``MODEL-REF``) first, then a ``Y`` ``UP`` for every
    item of the model before any ``X``, then one ``X`` ``UP`` for each user
    of the training split with its known items (over all the lines)."""
    keys = [k for k, _, _ in sent]
    check(keys[0] in ("MODEL", "MODEL-REF")
          and not ({"MODEL", "MODEL-REF"} & set(keys[1:])),
          f"lambda_loop: not one model message first: {keys[:3]}")
    check(set(keys[1:]) == {"UP"}, "lambda_loop: a non-UP after the model")
    ups = [json.loads(m) for _, m, _ in sent[1:]]
    kinds = [u[0] for u in ups]
    n_y = kinds.count("Y")
    check(kinds == ["Y"] * n_y + ["X"] * (len(kinds) - n_y),
          "lambda_loop: an X UP came before the last Y UP")
    check([u[1] for u in ups[:n_y]] == meta["y_ids"],
          "lambda_loop: Y UPs are not the model's items in order")
    x_ups = ups[n_y:]
    check([u[1] for u in x_ups] == meta["x_ids"]
          and set(meta["x_ids"]) == train_users,
          "lambda_loop: X UPs are not one per user of the training split")
    check(all(u[3] == known[u[1]] for u in x_ups),
          "lambda_loop: an X UP's known items differ from the user's items")
    check(all(len(u[2]) == meta["features"] for u in ups),
          "lambda_loop: a vector of the wrong width")
    return {"model": 1, "y_ups": n_y, "x_ups": len(x_ups)}


# -- ALS durability: checkpoints and the layout cache --------------------------


def ckpt_counts() -> dict:
    snap = metrics.default_registry().snapshot()
    return {name: snap.get(f"oryx_checkpoint_{name}_total", {}).get("", 0.0)
            for name in ("saves", "save_failures", "resumes", "bytes")}


def launches_since(before: dict) -> dict:
    return {w: K.LAUNCHES[w] - before[w] for w in ALS_WRAPPERS}


def sides_equal(a, b) -> bool:
    """Two packed sides' slabs, geometry and gather-Gramian schedules, bit
    for bit."""
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("srows", "scols", "svals", "slens"))
            and (a.block, a.n_blocks, a.slot_width, a.slot_chunk, a.n_rows)
            == (b.block, b.n_blocks, b.slot_width, b.slot_chunk, b.n_rows)
            and len(a.gg_schedules) == len(b.gg_schedules)
            and all(torch.equal(p.work, q.work) and torch.equal(p.split, q.split)
                    and (p.units, p.split_units, p.unit_entries,
                         p.max_entries_per_unit, p.slots)
                    == (q.units, q.split_units, q.unit_entries,
                        q.max_entries_per_unit, q.slots)
                    for p, q in zip(a.gg_schedules, b.gg_schedules)))


def row_extension(batch, rng, rows_below: "int | None" = None):
    """The batch without DURABILITY_HOLDOUT of its entries (all that qualify
    when ``rows_below`` limits them to the users under it), each held-out
    entry the last of its user's row with another entry before it, and its
    item kept elsewhere: the whole batch is then a row-wise extension of
    the rest with no new id, the production shape of a new generation.
    Returns (the rest, the held-out indices)."""
    rows, cols = batch.rows, batch.cols
    starts = np.r_[True, rows[1:] != rows[:-1]]
    ends = np.r_[rows[1:] != rows[:-1], True]
    cand = np.flatnonzero(ends & ~starts)
    if rows_below is not None:
        cand = cand[rows[cand] < rows_below]
    n = min(len(cand), int(round(DURABILITY_HOLDOUT * len(rows))))
    hold = np.sort(rng.choice(cand, n, replace=False))
    n_items = len(batch.items)
    lost = np.bincount(cols[hold], minlength=n_items)
    hold = hold[np.bincount(cols, minlength=n_items)[cols[hold]] > lost[cols[hold]]]
    keep = np.ones(len(rows), dtype=bool)
    keep[hold] = False
    return als_data.RatingBatch(rows[keep], cols[keep], batch.vals[keep],
                                batch.users, batch.items), hold


# -- device cost accounting (common/profiling) ---------------------------------

HALVES = ("user_half", "item_half")
COST_FAMILIES = ("oryx_device_calls_total", "oryx_device_flops_total",
                 "oryx_device_bytes_total")
#: each checked train's cost deltas, in run order, for the profiling line
TRAIN_COSTS: list = []


def check_train_costs(before: dict, calls: int, what: str, nnz=None,
                      sides=None) -> dict:
    """The trainer's cost accounting since the metrics snapshot ``before``:
    each half recorded ``calls`` calls, and FLOP and byte deltas of calls ×
    the half's registered cost; with ``sides`` (the train's packed user and
    item sides) that cost must be ``tr.half_cost`` of the side's shape."""
    after = metrics.default_registry().snapshot()
    rec = {"train": what, "calls": calls, "sides_checked": sides is not None}
    for half, side in zip(HALVES, sides or (None, None)):
        label = f'program="als.train.{half}"'
        n, flops, nbytes = (after.get(f, {}).get(label, 0.0)
                            - before.get(f, {}).get(label, 0.0)
                            for f in COST_FAMILIES)
        cost = profiling.costs().cost(f"als.train.{half}")
        check(n == calls and cost is not None,
              f"profiling: {what}: {n} calls of als.train.{half} (cost "
              f"{cost}), expected {calls}")
        if side is not None:
            want = tr.half_cost(side, nnz, FEATURES, "float32")
            check(tuple(cost) == want, f"profiling: {what}: als.train.{half} "
                  f"registered {cost}, the side's shape gives {want}")
        for got, per_call, name in ((flops, cost[0], "FLOP"), (nbytes, cost[1], "byte")):
            check(abs(got - calls * per_call) <= 1e-9 * max(calls * per_call, 1.0),
                  f"profiling: {what}: als.train.{half} {name} delta {got}, "
                  f"expected {calls} x {per_call}")
        rec[half] = {"flops": flops, "bytes": nbytes, "cost": list(cost)}
    TRAIN_COSTS.append(rec)
    return rec


def durability_train(batch, y0, sides=None, what: str = "durability", **kwargs):
    """``als_train`` at the smoke's settings from the main train's Y₀; its
    cost accounting checked (:func:`check_train_costs`, one call a half per
    iteration run)."""
    timings: dict = {}
    before = dict(K.LAUNCHES)
    costs0 = metrics.default_registry().snapshot()
    t0 = time.perf_counter()
    x, y = tr.als_train(batch, FEATURES, LAM, ALPHA, True, ITERATIONS,
                        init_y=y0, timings=timings, **kwargs)
    torch.cuda.synchronize()
    timings["seconds"] = time.perf_counter() - t0
    timings["launches"] = launches_since(before)
    check_train_costs(costs0, len(timings["iter_s"]), what, batch.nnz, sides)
    return x, y, timings


def checkpoint_runs(batch, y0, x_plain, y_plain, blocks: int, root: Path,
                    sides) -> dict:
    """A train that checkpoints every iteration, equal to the plain train;
    a resume from step 1 (every later file deleted, as a kill leaves them);
    a resume at the final step, which must launch no kernel; one save's
    bytes and seconds."""
    out = {}
    store = ck.CheckpointStore(root / "ckpt", keep=ITERATIONS)
    counts0 = ckpt_counts()
    x1, y1, t1 = durability_train(
        batch, y0, sides, "checkpointed",
        checkpointer=ck.TrainerCheckpointer(store, DURABILITY_FP, 1))
    check(torch.equal(x1, x_plain) and torch.equal(y1, y_plain),
          "als_durability: the checkpointed factors differ from the plain train's")
    check(store.steps(DURABILITY_FP) == list(range(1, ITERATIONS + 1)),
          f"als_durability: checkpoint steps {store.steps(DURABILITY_FP)}")
    check(t1["launches"] == {w: ITERATIONS * blocks for w in ALS_WRAPPERS},
          f"als_durability: checkpointed train launched {t1['launches']}")
    out["checkpointed"] = {key: t1[key] for key in (
        "seconds", "pack_s", "iter_s", "ckpt_wait_s", "ckpt_final_wait_s",
        "ckpt_resumed_from", "launches")}
    out["store_steps"] = store.steps(DURABILITY_FP)
    out["file_bytes"] = [p.stat().st_size for _, _, p in store.entries()]

    for _, step, path in store.entries():
        if step > 1:
            path.unlink()
    resumes = ckpt_counts()["resumes"]
    x2, y2, t2 = durability_train(
        batch, y0, sides, "resumed",
        checkpointer=ck.TrainerCheckpointer(store, DURABILITY_FP, 1))
    check(t2["ckpt_resumed_from"] == 1
          and ckpt_counts()["resumes"] == resumes + 1,
          f"als_durability: resumed from {t2['ckpt_resumed_from']}")
    check(t2["launches"] == {w: (ITERATIONS - 1) * blocks for w in ALS_WRAPPERS},
          f"als_durability: the resume launched {t2['launches']}")
    diff = max(float((x2 - x1).abs().max()), float((y2 - y1).abs().max()))
    check(diff <= 1e-5, f"als_durability: resumed factors {diff} from the "
          "uninterrupted run's (> 1e-5)")
    out["resumed"] = {key: t2[key] for key in (
        "seconds", "pack_s", "iter_s", "ckpt_wait_s", "ckpt_final_wait_s",
        "ckpt_resumed_from", "launches")}
    out["resumed"].update(max_abs_diff=diff, bit_equal=bool(
        torch.equal(x2, x1) and torch.equal(y2, y1)))

    x3, y3, t3 = durability_train(
        batch, y0, sides, "resumed_final",
        checkpointer=ck.TrainerCheckpointer(store, DURABILITY_FP, 1))
    check(t3["ckpt_resumed_from"] == ITERATIONS and t3["iter_s"] == [],
          f"als_durability: final-step resume from {t3['ckpt_resumed_from']}")
    check(t3["launches"] == {w: 0 for w in ALS_WRAPPERS},
          f"als_durability: the final-step resume launched {t3['launches']}")
    check(torch.equal(x3, x2) and torch.equal(y3, y2),
          "als_durability: the final-step resume is not the checkpoint's factors")
    out["resumed_final"] = {key: t3[key] for key in (
        "seconds", "pack_s", "ckpt_resumed_from", "launches")}

    # one save alone, the card idle: submit to finish (fetch + write), and
    # the store's write of the host arrays
    cp = ck.TrainerCheckpointer(store, "e" * 16, 1)
    t0 = time.perf_counter()
    cp.submit(ITERATIONS, {"x": x_plain, "y": y_plain})
    cp.finish()
    save_s = time.perf_counter() - t0
    host = {"x": x_plain.cpu().numpy(), "y": y_plain.cpu().numpy()}
    t0 = time.perf_counter()
    path = store.save("f" * 16, ITERATIONS, host, {})
    out["save"] = {"bytes": path.stat().st_size, "submit_to_finish_s": save_s,
                   "store_write_s": time.perf_counter() - t0}
    counts = {k: v - counts0[k] for k, v in ckpt_counts().items()}
    check(counts["save_failures"] == 0, f"als_durability: failed saves {counts}")
    out["counters"] = counts
    return out


def layout_cache_runs(batch, y0, x_plain, y_plain, user_side, item_side,
                      blocks: int, rng) -> dict:
    """One ``BlockedLayoutCache`` over three trains: the batch less a 1%
    row-wise extension (``full``), the whole batch (``delta`` on both
    sides), the same arrays again (``reused``); each cached side against a
    fresh pack of the same arrays, slabs and schedules; the delta's and the
    reuse's factors against the plain train's (a fresh pack of the same
    arrays, the same Y₀). Then, on a fresh cache, the same share held out
    of the first user block's users only (``one_block``), where the user
    side's delta re-derives one block."""
    dev = user_side.srows.device
    base, hold = row_extension(batch, rng)
    fresh_base = tr.prepare_blocked(base, FEATURES, device=dev)
    cache = tr.BlockedLayoutCache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode, b, fresh in (("full", base, fresh_base),
                           ("delta", batch, (user_side, item_side)),
                           ("reused", batch, (user_side, item_side))):
        t0 = time.perf_counter()
        appended = cache.match_extension(b.rows, b.cols, b.vals)
        match_s = time.perf_counter() - t0
        x, y, t = durability_train(b, y0, fresh, f"layout_cache.{mode}",
                                   layout_cache=cache)
        check(t["pack_modes"] == {"user": mode, "item": mode},
              f"als_durability: pack modes {t['pack_modes']}, expected {mode}")
        check(t["launches"] == {w: ITERATIONS * blocks for w in ALS_WRAPPERS},
              f"als_durability: the {mode} train launched {t['launches']}")
        # the cache's sides, handed back as they are (the same arrays)
        sides = tr.prepare_blocked(b, FEATURES, cache=cache, device=dev)
        check(cache.last_modes == {"user": "reused", "item": "reused"},
              f"als_durability: after the {mode} train the same arrays on "
              f"{dev} packed as {cache.last_modes}")
        check(all(sides_equal(c, f) for c, f in zip(sides, fresh)),
              f"als_durability: the {mode} sides differ from a fresh pack")
        if mode != "full":
            check(torch.equal(x, x_plain) and torch.equal(y, y_plain),
                  f"als_durability: the {mode} factors differ from a fresh "
                  "pack's")
        runs[mode] = {key: t[key] for key in (
            "seconds", "pack_s", "pack_user_s", "pack_item_s", "pack_wait_s",
            "pack_modes", "launches")}
        runs[mode]["match_s"] = match_s
        runs[mode]["appended"] = None if appended is None else len(appended)
    torch.cuda.synchronize()
    memory = {"allocated_before": mem0,
              "peak_allocated": torch.cuda.max_memory_allocated(),
              "allocated_after": torch.cuda.memory_allocated()}
    del cache, fresh_base, sides

    base1, hold1 = row_extension(batch, rng, rows_below=user_side.block)
    cache = tr.BlockedLayoutCache()
    one_block = {"held_out": len(hold1)}
    for mode, b, sides in (("full", base1, None),
                           ("delta", batch, (user_side, item_side))):
        x, y, t = durability_train(b, y0, sides, f"one_block.{mode}",
                                   layout_cache=cache)
        check(t["pack_modes"] == {"user": mode, "item": mode},
              f"als_durability: one-block pack modes {t['pack_modes']}")
        one_block[mode] = {key: t[key] for key in (
            "pack_s", "pack_user_s", "pack_item_s", "pack_wait_s")}
    check(torch.equal(x, x_plain) and torch.equal(y, y_plain),
          "als_durability: the one-block delta's factors differ from a fresh "
          "pack's")
    del cache

    def touched(held) -> dict:
        return {"user": int(np.unique(batch.rows[held] // user_side.block).size),
                "item": int(np.unique(batch.cols[held] // item_side.block).size)}

    one_block["affected_blocks"] = touched(hold1)
    return {"held_out": len(hold), "affected_blocks": touched(hold),
            "blocks": {"user": user_side.n_blocks, "item": item_side.n_blocks},
            "runs": runs, "device_memory": memory, "one_block": one_block}


def durability_generation(lines, root: Path) -> dict:
    """Two ``ALSUpdate.run_update`` calls with checkpoints on, each on a
    fresh updater, over the same lines and input offsets: a generation, and
    its crash-restart. The first trains from scratch and publishes
    generation ``"g" + fingerprint[:12]``; the second resumes at the final
    step, launches no kernel, and publishes the same generation id and the
    same factors."""
    conf = oryx_config.overlay_on({
        "oryx.ml.eval.test-fraction": TEST_FRACTION,
        "oryx.ml.eval.candidates": 1,
        "oryx.als.hyperparams.lambda": LAM,
        "oryx.als.hyperparams.features": FEATURES,
        "oryx.als.hyperparams.alpha": ALPHA,
        "oryx.als.iterations": ITERATIONS,
        "oryx.batch.checkpoint.enabled": True,
        "oryx.batch.checkpoint.dir": str(root / "generation-ckpt"),
        "oryx.batch.checkpoint.interval-iterations": 1,
    }, oryx_config.get_default())
    messages = [KeyMessage(None, ln) for ln in lines]
    out = []
    for attempt in range(2):
        update = ALSUpdate(conf)
        producer = RecordingProducer()
        context = types.SimpleNamespace(input_offsets={0: len(lines)},
                                        input_watermark_ms=GENERATION_TIMESTAMP_MS)
        model_dir = root / f"generation-model-{attempt}"
        resumes = ckpt_counts()["resumes"]
        before = dict(K.LAUNCHES)
        costs0 = metrics.default_registry().snapshot()
        t0 = time.perf_counter()
        update.run_update(context, GENERATION_TIMESTAMP_MS, messages, [],
                          str(model_dir), producer)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launches_since(before)
        # the first trains every iteration, the restart none
        check_train_costs(costs0, 0 if attempt else ITERATIONS,
                          f"generation.{'restart' if attempt else 'first'}")
        cands = update.report["candidates"]
        check(len(cands) == 1 and all("failed" not in c for c in cands.values()),
              f"als_durability: generation candidates {cands}")
        cand = next(iter(cands.values()))
        check(producer.sent and producer.sent[0][0] == "MODEL",
              "als_durability: the generation did not publish a MODEL first")
        stamp = lineage.parse_stamp(producer.sent[0][2])
        promoted = model_dir / str(GENERATION_TIMESTAMP_MS)
        meta = als_codec.pmml_to_meta(pmmlutils.read(promoted / "model.pmml"))
        factors = (read_part_files(promoted / meta["x_dir"]),
                   read_part_files(promoted / meta["y_dir"]))
        out.append({"run_update_s": run_s, "train_s": cand["train_s"],
                    "blocks": cand["blocks"],
                    "pack_s": cand["pack_s"], "iter_s": cand["iter_s"],
                    "ckpt_wait_s": cand["ckpt_wait_s"],
                    "ckpt_final_wait_s": cand["ckpt_final_wait_s"],
                    "ckpt_resumed_from": cand["ckpt_resumed_from"],
                    "launches": launches,
                    "resumes": ckpt_counts()["resumes"] - resumes,
                    "stamp": {k: stamp[k] for k in (
                        "generation", "fingerprint", "origin", "offsets")},
                    "factors": factors})
    first, second = out
    fp = first["stamp"]["fingerprint"]
    blocks = sum(first["blocks"].values())
    check(first["stamp"]["origin"] == "scratch" and fp
          and first["stamp"]["generation"] == "g" + fp[:12],
          f"als_durability: first publish's stamp {first['stamp']}")
    check(first["launches"] == {w: ITERATIONS * blocks for w in ALS_WRAPPERS},
          f"als_durability: the first generation launched {first['launches']}")
    check(second["stamp"]["origin"] == "resume"
          and second["stamp"]["fingerprint"] == fp
          and second["stamp"]["generation"] == first["stamp"]["generation"]
          and second["ckpt_resumed_from"] == ITERATIONS
          and second["resumes"] == 1,
          f"als_durability: the restart's stamp {second['stamp']}, resumed "
          f"from {second['ckpt_resumed_from']}")
    check(second["launches"] == {w: 0 for w in ALS_WRAPPERS},
          f"als_durability: the restart launched {second['launches']}")
    for (ids_a, mat_a), (ids_b, mat_b) in zip(first["factors"], second["factors"]):
        check(ids_a == ids_b and np.array_equal(mat_a, mat_b),
              "als_durability: the restart's MODEL holds other factors")
    for run in out:
        run["users"], run["items"] = (len(run["factors"][0][0]),
                                      len(run["factors"][1][0]))
        del run["factors"]
    return {"lines": len(lines), "first": first, "restart": second}


def als_durability_phase(batch, x_plain, y_plain, user_side, item_side,
                         lines, rng) -> dict:
    """The ``als_durability`` line (see the module docstring). The launch
    counters are set to 0 at the start and read at the end; the first
    launch at each shape is held against the plain version after it."""
    y0 = tr.init_item_factors(item_side.padded_rows, len(batch.items), FEATURES,
                              torch.Generator().manual_seed(SEED + 1),
                              user_side.srows.device)
    blocks = user_side.n_blocks + item_side.n_blocks
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="oryx-durability-") as tmp, \
            FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                           (tr, "spd_solve_batched", spd_key)]) as first:
        K.reset_launches()
        out = {"checkpoint": checkpoint_runs(batch, y0, x_plain, y_plain,
                                             blocks, Path(tmp),
                                             (user_side, item_side))}
        out["layout_cache"] = layout_cache_runs(batch, y0, x_plain, y_plain,
                                                user_side, item_side, blocks, rng)
        out["generation"] = durability_generation(lines, Path(tmp))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        counted = dict(K.SHAPE_LAUNCHES)
    out["held_against_plain"] = hold_path_launches(first, counted, "als_durability")
    out["launches"] = {w: launches[w] for w in ALS_WRAPPERS}
    out["shape_launches"] = {launch_key(*key): c for key, c in counted.items()}
    others = {k: v for k, v in launches.items() if k not in ALS_WRAPPERS and v}
    check(not others, f"als_durability: other kernels launched: {others}")
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return out


# -- ALS speed tier ---------------------------------------------------------


def settle_solvers(caches) -> float:
    """Bring solver caches up to their vectors: wait out a background
    recompute, then recompute in this thread if dirty; returns the seconds.
    ``SolverCache`` hands out the previous solver while a recompute runs,
    so a microbatch that follows the previous one's ``UP``s at once folds
    in against whichever Gramian that race left; the float64 checks below
    need the current one."""
    t0 = time.perf_counter()
    for cache in caches:
        deadline = time.monotonic() + 60
        while cache._in_flight and time.monotonic() < deadline:
            time.sleep(0.001)
        cache._maybe_launch(wait=True)
    return time.perf_counter() - t0


def pair_values(lines) -> dict:
    """``(user, item) -> summed value`` over ``user,item,value,ts`` lines:
    the implicit aggregation ``data.prepare`` applies (no decay, no log
    strength)."""
    out: dict = {}
    for ln in lines:
        u, i, v = ln.split(",")[:3]
        out[(u, i)] = out.get((u, i), 0.0) + float(v)
    return out


def implicit_target(value: float, current: float) -> float:
    """The implicit target estimate (ALSUtils.computeTargetQui), or NaN."""
    if value > 0.0 and current < 1.0:
        return current + value / (1.0 + value) * (1.0 - max(0.0, current))
    if value < 0.0 and current > 0.0:
        return current + value / (value - 1.0) * -min(1.0, current)
    return float("nan")


def check_speed_updates(ups, values, pre, rng, label) -> dict:
    """The microbatch's ``UP``s against an independent reading of the same
    pre-batch X and Y: one X ``UP``, carrying its item, per pair whose item
    has a vector and whose target estimate is defined (float32 dot, as the
    fold-in computes it), one Y ``UP`` per pair likewise; and for 256
    sampled ``UP``s of each kind, ``v + solve(VᵀV, w·Δq)`` recomputed with
    ``np.linalg.solve`` in float64, within relative 1e-4 (a float32
    Gramian's rounding through the solve)."""
    parsed = [json.loads(u) for u in ups]
    got = {"X": {}, "Y": {}}
    for u in parsed:
        check(len(u) == 4 and len(u[3]) == 1 and len(u[2]) == FEATURES,
              f"{label}: malformed UP {u[:2]}")
        pair = (u[1], u[3][0]) if u[0] == "X" else (u[3][0], u[1])
        check(pair in values, f"{label}: an UP for a pair not in the microbatch")
        check(pair not in got[u[0]], f"{label}: two {u[0]} UPs for {pair}")
        got[u[0]][pair] = np.asarray(u[2], dtype=np.float32)
    (x_index, x0), (y_index, y0) = pre
    gram = {"X": y0.astype(np.float64).T @ y0.astype(np.float64),
            "Y": x0.astype(np.float64).T @ x0.astype(np.float64)}
    want_pairs = {"X": set(), "Y": set()}
    for (user, item), value in values.items():
        xr, yr = x_index.get(user), y_index.get(item)
        dot = float(np.dot(x0[xr], y0[yr])) if xr is not None and yr is not None else 0.0
        if yr is not None and not np.isnan(
                implicit_target(value, dot if xr is not None else 0.5)):
            want_pairs["X"].add((user, item))
        if xr is not None and not np.isnan(
                implicit_target(value, dot if yr is not None else 0.5)):
            want_pairs["Y"].add((user, item))
    out = {}
    for kind in ("X", "Y"):
        check(set(got[kind]) == want_pairs[kind],
              f"{label}: {len(got[kind])} {kind} UPs for "
              f"{len(want_pairs[kind])} changed pairs")
        pairs = sorted(got[kind])
        worst = 0.0
        for j in rng.choice(len(pairs), min(SPEED_SAMPLES, len(pairs)), replace=False):
            user, item = pairs[j]
            xr, yr = x_index.get(user), y_index.get(item)
            xu = x0[xr].astype(np.float64) if xr is not None else None
            yi = y0[yr].astype(np.float64) if yr is not None else None
            own, other = (xu, yi) if kind == "X" else (yi, xu)
            qui = float(own @ other) if own is not None else 0.0
            target = implicit_target(values[(user, item)],
                                     qui if own is not None else 0.5)
            want = np.linalg.solve(gram[kind], other * (target - qui))
            if own is not None:
                want = want + own
            rel = float(np.abs(got[kind][(user, item)] - want).max()
                        / np.abs(want).max())
            worst = max(worst, rel)
        check(worst < 1e-4, f"{label}: {kind} UPs differ from the float64 "
              f"fold-in by rel {worst}")
        out[kind] = {"ups": len(pairs), "max_rel_err_f64": worst}
    return out


def check_served_top_n(model, touched, rng, label) -> dict:
    """256 users, half of them touched by the microbatch: the manager's
    top-10 (known items excluded, ``UP``-carried ones among them) equal to
    a model built fresh from the stores' host matrices, ids and scores bit
    for bit."""
    all_users = model.all_user_ids()
    half = SPEED_SAMPLES // 2
    users = list(rng.choice(sorted(touched), half, replace=False))
    rest = sorted(set(all_users) - set(users))
    users += [rest[j] for j in rng.choice(len(rest), SPEED_SAMPLES - half, replace=False)]
    known = {u: model.get_known_items(u) for u in users}
    x_ids, x, _, _ = model.x.host_matrix()
    y_ids, y, _, _ = model.y.host_matrix()
    fresh = state.serving_model(x, y, x_ids, y_ids, known_items=known)
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [known[u] for u in users]
    res = model.top_n_batch(qs, 10, excluded=excluded)
    want = fresh.top_n_batch(qs, 10, excluded=excluded)
    check([[i for i, _ in r] for r in res] == [[i for i, _ in r] for r in want]
          and all(len(r) == 10 for r in res),
          f"{label}: top-10 ids differ from a freshly loaded model's")
    check(torch.equal(torch.tensor([[v for _, v in r] for r in res]),
                      torch.tensor([[v for _, v in r] for r in want])),
          f"{label}: top-10 scores differ from a freshly loaded model's")
    for r, ex in zip(res, excluded):
        check(not ({i for i, _ in r} & ex), f"{label}: a known item came back")
    return {"users": len(users), "touched": half}


def check_fold_in_api(model, rng, label) -> dict:
    """The serving fold-in API on the card: ``get_vtv`` on the card's
    matrix against a float64 host Gramian (relative 1e-5: a float32
    product over the items); ``build_temporary_user_vector`` for 256
    anonymous contexts of 1-20 items against a float64 fold-in (relative
    1e-4); ``top_n_cosine`` for 16 item sets against an exact float64 scan
    (overlap >= 0.99)."""
    store = model.y
    y_ids, y, version, _ = store.host_matrix()
    check(store._cached_version == version,
          f"{label}: the device matrix is not current for get_vtv")
    t0 = time.perf_counter()
    vtv = store.get_vtv()
    vtv_s = time.perf_counter() - t0
    y64 = y.astype(np.float64)
    gram = y64.T @ y64
    vtv_rel = float(np.abs(vtv - gram).max() / np.abs(gram).max())
    check(vtv_rel < 1e-5, f"{label}: get_vtv rel err {vtv_rel} >= 1e-5")
    solver_s = settle_solvers([model.yty_cache])
    index = {s: i for i, s in enumerate(y_ids)}
    worst = 0.0
    for _ in range(SPEED_SAMPLES):
        items = [y_ids[j] for j in rng.choice(len(y_ids), rng.integers(1, 21),
                                              replace=False)]
        got = model.build_temporary_user_vector([(i, 1.0) for i in items])
        vec = None
        for item in items:
            yi = y64[index[item]]
            qui = float(vec @ yi) if vec is not None else 0.0
            target = implicit_target(1.0, qui if vec is not None else 0.5)
            if np.isnan(target):
                continue
            step = np.linalg.solve(gram, yi * (target - qui))
            vec = step if vec is None else vec + step
        worst = max(worst, float(np.abs(got - vec).max() / np.abs(vec).max()))
    check(worst < 1e-4, f"{label}: temporary user vectors rel err {worst}")
    norms = np.linalg.norm(y64, axis=1)
    hits = 0
    t0 = time.perf_counter()
    for _ in range(16):
        items = rng.choice(len(y_ids), rng.integers(1, 6), replace=False)
        qs = y[items]
        res = model.top_n_cosine(qs, 10)
        q64 = qs.astype(np.float64)
        sims = (y64 @ q64.T) / np.maximum(
            norms[:, None] * np.linalg.norm(q64, axis=1)[None, :], 1e-12)
        top = np.argpartition(-sims.mean(axis=1), 10)[:10]
        hits += len({y_ids[j] for j in top} & {i for i, _ in res})
    cosine_s = time.perf_counter() - t0
    overlap = hits / 160
    check(overlap >= 0.99, f"{label}: cosine overlap {overlap} < 0.99")
    return {"vtv_rel_err": vtv_rel, "vtv_s": vtv_s, "yty_solver_s": solver_s,
            "temporary_user_vector_max_rel_err_f64": worst,
            "cosine_overlap": overlap, "cosine_16_sets_s": cosine_s}


def whole_upload_ms(store, dev) -> tuple:
    """The store uploaded whole (host gather, copy to the card), host
    milliseconds around a synchronise; and the matrix."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, host, _, _ = store.host_matrix()
    mat = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, ids, mat


def timed_snapshot_ms(model) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = model.y_snapshot()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, snap


def flagship_snapshots(dev, rng) -> dict:
    """The seeded 1,000,000 × 50f serving model: three rounds of 10,000
    changed and 1,000 new rows through ``set_item_vector``, each followed
    by a timed incremental ``y_snapshot``, beside a whole upload of the
    same store (``torch.equal`` matrices); then top-10 for 16 queries equal
    to a model loaded fresh from the store, ids and scores bit for bit."""
    model, _, ids = flagship_model(rng)
    first_ms, _ = timed_snapshot_ms(model)
    rounds = []
    for r in range(3):
        changed = rng.choice(len(ids), FLAGSHIP_CHANGED, replace=False)
        vecs = rng.standard_normal((FLAGSHIP_CHANGED + FLAGSHIP_NEW, FEATURES),
                                   dtype=np.float32)
        t0 = time.perf_counter()
        for j, v in zip(changed.tolist(), vecs):
            model.set_item_vector(ids[j], v)
        for j, v in enumerate(vecs[FLAGSHIP_CHANGED:]):
            model.set_item_vector(f"new{r}-{j}", v)
        writes_s = time.perf_counter() - t0
        inc_ms, snap = timed_snapshot_ms(model)
        full_ms, full_ids, full = whole_upload_ms(model.y, dev)
        check(torch.equal(snap.mat, full) and snap.n == len(full_ids)
              and list(snap.ids[:snap.n]) == full_ids,
              f"flagship round {r}: the incremental matrix is not the whole upload")
        rounds.append({"incremental_ms": inc_ms, "full_upload_ms": full_ms,
                       "writes_s": writes_s, "items": snap.n})
    check(model.y.materializations == {"full": 1, "incremental": 3},
          f"flagship: materialisations {model.y.materializations}")
    fresh = ALSServingModel(FEATURES, True)
    fresh.bulk_load_items(full_ids, model.y.host_matrix()[1])
    qs = rng.standard_normal((16, FEATURES), dtype=np.float32)
    res, want = model.top_n_batch(qs, 10), fresh.top_n_batch(qs, 10)
    check(res == want and all(len(r) == 10 for r in res),
          "flagship: top-10 differs from a freshly loaded model's")
    return {"items": FLAGSHIP_ITEMS, "changed_rows": FLAGSHIP_CHANGED,
            "new_rows": FLAGSHIP_NEW, "first_snapshot_ms": first_ms,
            "rounds": rounds, "materializations": dict(model.y.materializations)}


# -- the ALS lambda loop through the runtime --------------------------------


def wait_until(cond, timeout: float, what: str, layers=(), poll: float = 0.005) -> float:
    """Poll ``cond`` until it holds and return ``time.perf_counter()`` then;
    fail after ``timeout`` seconds, or at once if one of ``layers`` stopped
    (a layer stops only on a fatal error or when closed)."""
    deadline = time.monotonic() + timeout
    while True:
        if cond():
            return time.perf_counter()
        stopped = [layer.tier for layer in layers if layer.stopped]
        check(not stopped, f"{what}: the {stopped} layer stopped")
        check(time.monotonic() < deadline, f"{what}: not within {timeout} s")
        time.sleep(poll)


def counting(manager) -> list:
    """Wrap ``manager.consume_key_message`` (the speed and serving SPI's
    per-message call) on the instance: after each message it applies,
    ``time.perf_counter()`` is appended to the returned list, so its length
    is the count applied so far. Set it before the manager is handed its
    first message."""
    inner = manager.consume_key_message
    applied: list = []

    def counted(key, message):
        inner(key, message)
        applied.append(time.perf_counter())

    manager.consume_key_message = counted
    return applied


def time_calls(obj, name: str) -> list:
    """Wrap ``obj.<name>`` on the instance: each call that returns or raises
    appends ``{"t0", "t1"}`` (perf_counter seconds) to the returned list.
    Set it before a thread looks the method up."""
    fn = getattr(obj, name)
    calls: list = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            calls.append({"t0": t0, "t1": time.perf_counter()})

    setattr(obj, name, timed)
    return calls


#: the runtime's own counts, read from the metrics registry: the layers'
#: generation steps (``StepTracer``: summed seconds and items), the batch
#: layer's input items and the speed layer's published ``UP``s
RUNTIME_SERIES = {
    f"{tier}_{key}": (name, f'tier="{tier}",step="generation"')
    for tier in ("batch", "speed")
    for key, name in (("step_s", "oryx_step_duration_seconds_sum"),
                      ("step_items", "oryx_step_items_total"))
}
RUNTIME_SERIES["batch_items"] = ("oryx_batch_generation_items_total", "")
RUNTIME_SERIES["speed_ups"] = ("oryx_speed_updates_published_total", "")


def runtime_counts() -> dict:
    snap = metrics.default_registry().snapshot()
    return {key: snap.get(name, {}).get(labels, 0.0)
            for key, (name, labels) in RUNTIME_SERIES.items()}


def counts_since(before: dict) -> dict:
    now = runtime_counts()
    return {key: now[key] - before[key] for key in now}


def append_after_tick(layer, producer, lines, timeout: float) -> tuple:
    """Wait for the layer's pump to poll once more (its input watermark
    moves), then send every line through ``producer``: the pump sleeps a
    whole generation interval after that poll, so one generation reads all
    the lines unless sending them takes longer. Returns the perf_counter
    times of the first and the last send."""
    seen = layer.current_input_watermark_ms
    wait_until(lambda: layer.current_input_watermark_ms != seen, timeout,
               f"{layer.tier} pump tick", layers=(layer,), poll=0.001)
    t_first = time.perf_counter()
    for ln in lines:
        producer.send(None, ln)
    return t_first, time.perf_counter()


class TopicWatch:
    """Wraps a broker's ``append`` and ``set_offset`` on the instance, for
    what the runtime does not time itself: ``first_model`` is the
    perf_counter time at which a ``MODEL`` / ``MODEL-REF`` first landed on
    ``topic``, and ``commits`` holds every offset commit as ``{"group",
    "topic", "offset", "t0", "t1"}`` (a layer commits after each tick, so a
    group's first commit of an offset ends the generation that read to
    it)."""

    def __init__(self, broker, topic: str):
        self.first_model = None
        self.commits: list = []
        append, set_offset = broker.append, broker.set_offset

        def watched_append(t, key, message, *args, **kwargs):
            out = append(t, key, message, *args, **kwargs)
            if self.first_model is None and t == topic and key in ("MODEL", "MODEL-REF"):
                self.first_model = time.perf_counter()
            return out

        def watched_set_offset(group, t, offset, *args, **kwargs):
            t0 = time.perf_counter()
            set_offset(group, t, offset, *args, **kwargs)
            self.commits.append({"group": group, "topic": t, "offset": offset,
                                 "t0": t0, "t1": time.perf_counter()})

        broker.append = watched_append
        broker.set_offset = watched_set_offset


class LambdaLoop:
    """The ALS lambda loop as a deployment runs it, on ``memory:`` topics:
    a ``BatchLayer`` and a ``SpeedLayer`` (on the card: ``platform`` null,
    unless ``overrides`` say otherwise) and an ``ALSServingModelManager``
    on ``serving_device`` (None: the card) consuming the update topic from
    ``earliest`` on a thread of its own, as the serving app does. The
    generations' seconds and counts are the runtime's own
    (``runtime_counts``); what it does not time — its input polls, the
    batch layer's segment write, the offset commits, the first ``MODEL`` on
    the update topic and each manager's applied messages — is timed by
    wrappers set on the instances before they run. The tests drive the same
    loop on the CPU at a small size."""

    def __init__(self, tmp: str, overrides=None, broker: str = LOOP_BROKER,
                 serving_device=None):
        self.conf = oryx_config.overlay_on({
            "oryx.id": "smoke",
            "oryx.input-topic.broker": broker,
            "oryx.update-topic.broker": broker,
            "oryx.batch.update-class": "oryx_tpu_torch.models.als.update.ALSUpdate",
            "oryx.speed.model-manager-class":
                "oryx_tpu_torch.models.als.speed.ALSSpeedModelManager",
            "oryx.batch.storage.data-dir": f"{tmp}/data",
            "oryx.batch.storage.model-dir": f"{tmp}/model",
            "oryx.ml.eval.test-fraction": TEST_FRACTION,
            "oryx.ml.eval.candidates": 1,
            "oryx.als.hyperparams.lambda": LAM,
            "oryx.als.hyperparams.features": FEATURES,
            "oryx.als.hyperparams.alpha": ALPHA,
            "oryx.als.iterations": ITERATIONS,
            **(overrides or {}),
        }, oryx_config.get_default())
        tp.maybe_create_topics(self.conf, "input-topic", "update-topic")
        self.broker = tp.get_broker(broker)
        self.input_topic = self.conf.get_string("oryx.input-topic.message.topic")
        self.update_topic = self.conf.get_string("oryx.update-topic.message.topic")
        self.input = tp.TopicProducerImpl(broker, self.input_topic)
        self.watch = TopicWatch(self.broker, self.update_topic)
        self.serving = ALSServingModelManager(self.conf, device=serving_device)
        self.served = counting(self.serving)
        self.serving_error = None
        self._updates = None
        self._serving_thread = None
        self.batch = BatchLayer(self.conf)
        self.speed = SpeedLayer(self.conf)
        self.closed: list = []
        oryx_id = self.conf.get_string("oryx.id")
        self.batch_group = f"OryxGroup-batch-{oryx_id}"
        self.speed_group = f"OryxGroup-speed-{oryx_id}"
        self.batch_polls = time_calls(self.batch, "_poll_input")
        self.speed_polls = time_calls(self.speed, "_poll_input")
        self.segment_writes = time_calls(self.batch.data_store, "write_segment")
        self.speed_applied: list = []

    @property
    def layers(self):
        """The layers still meant to run (a closed one is stopped)."""
        return tuple(layer for layer in (self.batch, self.speed)
                     if layer not in self.closed)

    @property
    def update(self):
        """The batch layer's update instance (``start()`` builds it)."""
        return self.batch._update_instance

    def start_serving(self) -> None:
        self._updates = tp.ConsumeDataIterator(self.broker, self.update_topic,
                                               "earliest")

        def serve():
            try:
                self.serving.consume(self._updates)
            except Exception as e:  # noqa: BLE001 — failed by the waits
                self.serving_error = e

        self._serving_thread = threading.Thread(
            target=serve, name="SmokeServingConsumer", daemon=True)
        self._serving_thread.start()

    def start_speed(self, speed_interval: float) -> None:
        """Start the speed layer and count what its manager applies. Nothing
        may be published to the update topic before this returns."""
        self.speed.start(speed_interval)
        self.speed_applied = counting(self.speed.model_manager)

    def update_size(self) -> int:
        return self.broker.size(self.update_topic)

    def wait_applied(self, applied: list, n: int, timeout: float, what: str) -> float:
        """Wait until a manager has applied ``n`` update-topic messages;
        returns the perf_counter time it applied the n-th."""
        wait_until(lambda: len(applied) >= n or self.serving_error is not None,
                   timeout, what, layers=self.layers)
        check(self.serving_error is None,
              f"{what}: the serving consumer failed: {self.serving_error!r}")
        check(len(applied) == n, f"{what}: {len(applied)} applied, expected {n}")
        return applied[n - 1]

    def wait_commit(self, group: str, offset: int, since: int, timeout: float,
                    what: str) -> dict:
        """Wait for ``group``'s first commit of ``offset`` on the input topic
        among the commits after the first ``since``, and return it."""
        def found():
            return next((c for c in self.watch.commits[since:]
                         if c["group"] == group and c["topic"] == self.input_topic
                         and c["offset"] == offset), None)

        wait_until(lambda: found() is not None, timeout, what, layers=self.layers)
        return found()

    def run_batch(self, lines, batch_interval: float, speed_interval: float,
                  timeout: float) -> dict:
        """Send ``lines`` to the input topic, store offset 0 for the batch
        layer's group (without a stored offset a layer starts at the end of
        its input), start the serving consumer and both layers (the speed
        layer's pump starts after the lines), wait for the batch layer to
        commit the input topic's end, then close it, so that no second
        generation reads the speed half's lines. Returns the produce
        seconds, the commit and the runtime's counts over the run."""
        t0 = time.perf_counter()
        for ln in lines:
            self.input.send(None, ln)
        produce_s = time.perf_counter() - t0
        n = self.broker.size(self.input_topic)
        self.broker.set_offset(self.batch_group, self.input_topic, 0)
        self.start_serving()
        since = len(self.watch.commits)
        before = runtime_counts()
        t_start = time.perf_counter()
        self.batch.start(batch_interval)
        self.start_speed(speed_interval)
        commit = self.wait_commit(self.batch_group, n, since, timeout,
                                  "lambda_loop: the batch generation")
        counts = counts_since(before)
        self.batch.close()
        self.closed.append(self.batch)
        return {"produce_s": produce_s, "t_start": t_start, "commit": commit,
                "counts": counts}

    def seed_updates(self, messages, speed_interval: float) -> None:
        """Instead of a batch generation: start the serving consumer and the
        speed layer, then put ``messages`` (KeyMessages of another loop's
        update topic) on this loop's update topic."""
        self.closed.append(self.batch)
        self.start_serving()
        self.start_speed(speed_interval)
        for km in messages:
            self.broker.append(self.update_topic, km.key, km.message, km.headers)

    def settle(self, timeout: float, label: str) -> dict:
        """Wait until the speed and the serving manager have applied every
        message on the update topic, then bring the speed manager's solver
        caches current, so the next microbatch folds in against this
        state."""
        total = self.update_size()
        t_speed = self.wait_applied(self.speed_applied, total, timeout,
                                    f"{label}: the speed manager applies the topic")
        self.wait_applied(self.served, total, timeout,
                          f"{label}: the serving manager applies the topic")
        model = self.speed.model_manager.model
        check(model is not None and model.get_fraction_loaded() == 1.0,
              f"{label}: the speed model is not loaded")
        return {"total": total, "t_speed": t_speed,
                "settle_s": settle_solvers([model.xtx_cache, model.yty_cache])}

    def microbatch(self, lines, label: str, timeout: float) -> dict:
        """Append ``lines`` just after a speed tick (``append_after_tick``)
        and wait for the speed generation that reads them: it must be one
        generation of exactly these lines, ending at the input topic's end
        (no commit of the speed group inside the lines; the runtime's step
        items are the lines; every ``UP`` carries the watermark header of
        the input's end). Returns the published ``UP`` KeyMessages, the
        commit that ended the generation, the runtime's generation seconds
        and the generation's polls."""
        interval = self.speed.generation_interval_sec
        total = self.update_size()
        input_start = self.broker.size(self.input_topic)
        input_end = input_start + len(lines)
        since, n_polls = len(self.watch.commits), len(self.speed_polls)
        before = runtime_counts()
        t_first, t_last = append_after_tick(self.speed, self.input, lines, timeout)
        commit = self.wait_commit(self.speed_group, input_end, since, timeout,
                                  f"{label}: the speed generation")
        counts = counts_since(before)
        split = [c["offset"] for c in self.watch.commits[since:]
                 if c["group"] == self.speed_group and input_start < c["offset"] < input_end]
        check(not split and counts["speed_step_items"] == len(lines)
              and self.speed.current_input_offsets == {0: input_end},
              f"{label}: speed commits at {split} inside the lines, "
              f"{counts['speed_step_items']} items in the generation steps, ending "
              f"at {self.speed.current_input_offsets}; expected one generation of "
              f"{len(lines)} ending at {input_end} (interval {interval} s)")
        end = self.update_size()
        published = self.broker.read(self.update_topic, total, end - total)
        check(len(published) == end - total, f"{label}: short update read")
        check(counts["speed_ups"] == len(published),
              f"{label}: {counts['speed_ups']} UPs counted, {len(published)} on the topic")
        check({km.key for km in published} <= {"UP"},
              f"{label}: a non-UP on the update topic")
        wm_header = json.dumps({"offsets": {"0": input_end},
                                "watermark_ms": self.speed.current_input_watermark_ms},
                               separators=(",", ":"))
        check(all((km.headers or {}).get(lineage.WATERMARK_HEADER) == wm_header
                  for km in published),
              f"{label}: an UP without the watermark header {wm_header}")
        polls = [c for c in self.speed_polls[n_polls:]
                 if c["t0"] >= t_first and c["t1"] <= commit["t0"]]
        check(polls, f"{label}: no poll before the speed generation")
        return {"published": published, "total": total, "end": end,
                "t_first": t_first, "t_last": t_last, "commit": commit,
                "generation_s": counts["speed_step_s"], "poll_t0": polls[0]["t0"],
                "poll_s": sum(c["t1"] - c["t0"] for c in polls)}

    def close(self) -> None:
        self.speed.close()
        self.batch.close()
        if self._updates is not None:
            self._updates.close()
            self._serving_thread.join(10)
        self.input.close()

    def await_layers(self) -> None:
        """A layer failure fails the loop: ``await_termination`` raises it."""
        for layer in (self.batch, self.speed):
            try:
                layer.await_termination(timeout=0)
            except Exception as e:  # noqa: BLE001 — re-raised as the loop's
                raise SmokeFailure(f"lambda_loop: the {layer.tier} layer "
                                   f"failed: {e!r}") from e


def loop_generation(loop: LambdaLoop, lines, rng) -> dict:
    """The batch half (see the module docstring): the loop's lines
    through the input topic, one batch generation run by the layer, its
    stream read back from the update topic and checked, the serving
    manager's top-10 against the promoted part files, and the layer's own
    work."""
    n = len(lines)
    with FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                        (tr, "spd_solve_batched", spd_key)]) as first:
        K.reset_launches()
        run = loop.run_batch(lines, BATCH_INTERVAL_S, SPEED_INTERVAL_S, 900)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        counted = dict(K.SHAPE_LAUNCHES)
    check(loop.broker.size(loop.input_topic) == n, "lambda_loop: input topic size")
    runtime = run["counts"]
    check(runtime["batch_items"] == runtime["batch_step_items"] == n,
          f"lambda_loop: the batch layer counted {runtime['batch_items']} items "
          f"({runtime['batch_step_items']} in its generation steps), expected {n}")
    n_gen = loop.update_size()
    sent = [(km.key, km.message, km.headers)
            for km in loop.broker.read(loop.update_topic, 0, n_gen)]
    check(len(sent) == n_gen, "lambda_loop: short read of the update topic")

    update = loop.update
    report = update.report
    cands = report["candidates"]
    check(len(cands) == 1 and all(
        "failed" not in c and "eval" in c for c in cands.values()),
          f"lambda_loop: not every candidate built and evaluated: "
          f"{ {k: c.get('failed') for k, c in cands.items()} }")
    check(all(c["device"].startswith("cuda") for c in cands.values()),
          "lambda_loop: a candidate was not built on the card")
    aucs = {k: c["eval"] for k, c in cands.items()}
    best = report["best"]
    check(aucs[best] == max(aucs.values()) and aucs[best] > 0.75,
          f"lambda_loop: promoted {best} of AUCs {aucs}")
    expected = sum(ITERATIONS * (c["blocks"]["user"] + c["blocks"]["item"])
                   for c in cands.values())
    for wrapper in ALS_WRAPPERS:
        check(launches[wrapper] == expected,
              f"lambda_loop: {launches[wrapper]} {wrapper} launches in the "
              f"batch half, expected {expected} (iterations x blocks)")
    others = {k: v for k, v in launches.items() if k not in ALS_WRAPPERS and v}
    check(not others, f"lambda_loop: other kernels launched in the batch half: {others}")
    held = hold_path_launches(first, counted, "lambda_loop.batch")
    promoted = loop.batch.model_store.latest()
    meta = als_codec.pmml_to_meta(pmmlutils.read(promoted / "model.pmml"))
    # the lines' timestamps are their positions, so the time-ordered
    # training split is the first 90%
    n_train = int(round(n * (1.0 - TEST_FRACTION)))
    known = known_items_of(lines)
    train_known = known_items_of(lines[:n_train])
    counts = check_update_stream(sent, meta, set(train_known), known)
    train_items = {i for items in train_known.values() for i in items}
    check(set(meta["y_ids"]) == train_items,
          f"lambda_loop: {counts['y_ups']} Y UPs for the {len(train_items)} "
          "items of the training split")
    check(sent[0][0] == "MODEL" and len(sent[0][1]) <= tp.MAX_REQUEST_SIZE,
          "lambda_loop: the model message is not an inline MODEL under the cap")

    # the layer's own work: one segment (one non-empty generation), the
    # offset, the lineage stamp
    segments = loop.batch.data_store.segments()
    check(len(segments) == 1, f"lambda_loop: {len(segments)} data segments")
    with open(segments[0] / "part-00000.jsonl", "rb") as f:
        seg_lines = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 24), b""))
    check(seg_lines == n, f"lambda_loop: the segment holds {seg_lines} lines")
    check(loop.broker.get_offset(loop.batch_group, loop.input_topic)
          == loop.broker.size(loop.input_topic),
          "lambda_loop: the stored offset is not the input topic's size")
    stamp = lineage.parse_stamp(sent[0][2])
    context = loop.batch.get_context()
    check(stamp is not None and stamp["offsets"] == {"0": n}
          and context.input_offsets == {0: n}
          and stamp["watermark_ms"] == context.input_watermark_ms
          == loop.batch.current_input_watermark_ms,
          f"lambda_loop: the MODEL's stamp {stamp} is not the context's "
          f"offsets and watermark")
    check(all(lineage.GENERATION_HEADER in (h or {}) for _, _, h in sent),
          "lambda_loop: a published message lacks the generation header")

    # publish-to-servable through the update topic
    t_served = loop.wait_applied(loop.served, n_gen, 300,
                                 "lambda_loop: serving consumes the generation")
    model = loop.serving.get_model()
    fraction = model.get_fraction_loaded()
    check(fraction == 1.0, f"lambda_loop: fraction loaded {fraction}")
    x_ids, x = read_part_files(promoted / meta["x_dir"])
    y_ids, y = read_part_files(promoted / meta["y_dir"])
    users = [x_ids[i] for i in rng.choice(len(x_ids), 256, replace=False)]
    direct = state.serving_model(x, y, x_ids, y_ids,
                                 known_items={u: known[u] for u in users})
    qs = np.stack([model.get_user_vector(u) for u in users])
    check(np.array_equal(qs, np.stack([direct.get_user_vector(u) for u in users])),
          "lambda_loop: user vectors differ after the JSON round trip")
    excluded = [model.get_known_items(u) for u in users]
    check(excluded == [direct.get_known_items(u) for u in users],
          "lambda_loop: known items differ")
    t0 = time.perf_counter()
    res = model.top_n_batch(qs, 10, excluded=excluded)
    first_top_n_s = time.perf_counter() - t0
    want = direct.top_n_batch(qs, 10, excluded=excluded)
    check(torch.equal(model.y_snapshot().mat, direct.y_snapshot().mat),
          "lambda_loop: the served Y differs from the part files'")
    check([[i for i, _ in r] for r in res] == [[i for i, _ in r] for r in want]
          and all(len(r) == 10 for r in res),
          "lambda_loop: top-10 ids differ from the directly loaded model's")
    check(torch.equal(torch.tensor([[v for _, v in r] for r in res]),
                      torch.tensor([[v for _, v in r] for r in want])),
          "lambda_loop: top-10 scores differ from the directly loaded model's")
    for r, ex in zip(res, excluded):
        check(not ({i for i, _ in r} & ex), "lambda_loop: a known item came back")

    stages = {"split_s": report["split_s"]}
    for name, c in sorted(cands.items()):
        stages[f"candidate_{name}"] = {
            key: c[key] for key in (
                "hyperparameters", "build_s", "prepare_s", "train_s", "pack_s",
                "iter_s", "write_s", "evaluate_s", "evaluate_load_s",
                "evaluate_parse_s", "evaluate_score_s", "eval", "blocks")}
    # the layer polls only in the tick that has input: every poll is the
    # generation's
    poll_t0 = loop.batch_polls[0]["t0"]
    commit, segment = run["commit"], loop.segment_writes[-1]
    run_update_s = report["run_update_s"]
    device_iter_s = sum(sum(c["iter_s"]) for c in cands.values())
    return {
        "lines": n, "produce_s": run["produce_s"],
        "produce_us_per_line": run["produce_s"] / n * 1e6,
        "batch_interval_s": BATCH_INTERVAL_S,
        "generation": {
            "wall_s": commit["t1"] - poll_t0,
            "poll_s": sum(c["t1"] - c["t0"] for c in loop.batch_polls),
            "step_s": runtime["batch_step_s"],
            "run_update_s": run_update_s,
            "segment_write_s": segment["t1"] - segment["t0"],
            "offsets_s": commit["t1"] - commit["t0"],
            "start_to_offsets_s": commit["t1"] - run["t_start"],
        },
        "combos": report["combos"], "best": best, "aucs": aucs, "stages": stages,
        "promote_s": report["promote_s"],
        "publish_model_s": report["publish_model_s"],
        "publish_y_s": report["publish_y_s"],
        "known_items_s": report["known_items_s"],
        "publish_x_s": report["publish_x_s"],
        "device_iter_share": device_iter_s / run_update_s,
        "publish_to_servable_s": t_served - loop.watch.first_model,
        # run_update returns just before the segment write begins
        "served_after_generation_s": t_served - segment["t0"],
        "first_top_n_s": first_top_n_s,
        "published": report["published"],
        "model_bytes": len(sent[0][1].encode("utf-8")),
        "messages": counts, "update_topic_messages": n_gen,
        "fraction_loaded": fraction, "launches": launches,
        "expected_launches": expected,
        "shape_launches": {launch_key(*key): c for key, c in counted.items()},
        "held_against_plain": held, "top_n_users": len(users),
        "segment_lines": seg_lines, "stamp": {k: stamp[k] for k in (
            "offsets", "watermark_ms", "max_event_ms", "origin")},
    }


def loop_speed(loop: LambdaLoop, lines, rng) -> dict:
    """The speed half (see the module docstring): the held-out newest 10%
    as microbatches of ``SPEED_MICROBATCH`` lines through the input topic,
    each appended while the pump is idle, after both managers applied every
    message on the update topic and the speed manager's solver caches were
    brought current; each microbatch's ``UP``s, read from the update topic,
    checked against float64 and served from an incremental snapshot."""
    dev = resolve(None)
    manager = loop.speed.model_manager
    model = loop.serving.get_model()
    full_builds = model.y.materializations["full"]
    n = len(lines)
    n_train = int(round(n * (1.0 - TEST_FRACTION)))
    held_out = lines[n_train:]
    batches = [held_out[j:j + SPEED_MICROBATCH]
               for j in range(0, len(held_out), SPEED_MICROBATCH)]
    out: dict = {"interval_s": SPEED_INTERVAL_S, "microbatches": []}
    phase_t0 = time.perf_counter()
    K.reset_launches()
    for b, batch in enumerate(batches):
        label = f"lambda_loop.speed microbatch {b}"
        settled = loop.settle(300, label)
        if b == 0:
            out["speed_load_s"] = settled["t_speed"] - loop.watch.first_model
        x_ids, x0, _, _ = manager.model.x.host_matrix()
        y_ids, y0, _, _ = manager.model.y.host_matrix()
        pre = (({s: i for i, s in enumerate(x_ids)}, x0),
               ({s: i for i, s in enumerate(y_ids)}, y0))
        incremental = model.y.materializations["incremental"]
        mb = loop.microbatch(batch, label, 3 * SPEED_INTERVAL_S + 120)
        end, commit = mb["end"], mb["commit"]
        ups = [km.message for km in mb["published"]]
        t_applied = loop.wait_applied(loop.served, end, 300,
                                      f"{label}: serving applies the UPs")
        snapshot_ms, snap = timed_snapshot_ms(model)
        t_servable = time.perf_counter()
        t_speed_heard = loop.wait_applied(loop.speed_applied, end, 300,
                                          f"{label}: the speed manager hears its UPs")
        counts = check_speed_updates(ups, pair_values(batch), pre, rng, label)
        check(model.y.materializations == {"full": full_builds,
                                           "incremental": incremental + 1},
              f"{label}: materialisations {model.y.materializations}")
        full_ms, full_ids, full = whole_upload_ms(model.y, dev)
        check(torch.equal(snap.mat, full) and list(snap.ids[:snap.n]) == full_ids,
              f"{label}: the incremental matrix is not the whole upload")
        touched = {json.loads(u)[1] for u in ups if u.startswith('["X"')}
        for u in ups[:1000]:
            up = json.loads(u)
            if up[0] == "X":
                check(up[3][0] in model.get_known_items(up[1]),
                      f"{label}: an UP's item is not among the known items")
        poll_t0, t_last = mb["poll_t0"], mb["t_last"]
        stages = {k: manager.report[k] for k in (
            "prepare_s", "solver_s", "gather_s", "foldin_s", "format_s")}
        build_s = sum(stages.values())
        record = {
            "lines": len(batch), "interactions": manager.report["interactions"],
            "ups": len(ups), "x_ups": counts["X"]["ups"],
            "y_ups": counts["Y"]["ups"], "checks": counts,
            "append_s": t_last - mb["t_first"],
            "append_to_servable_s": t_servable - t_last,
            "append_to_servable_without_wait_s": t_servable - poll_t0,
            "wait_for_tick_s": poll_t0 - t_last,
            "pump": {"poll_s": mb["poll_s"],
                     "generation_s": mb["generation_s"],
                     "build_updates_s": build_s,
                     "up_publish_s": mb["generation_s"] - build_s,
                     "serving_lag_s": t_applied - commit["t0"],
                     "speed_lag_s": t_speed_heard - commit["t0"]},
            "stages_s": stages,
            "ups_per_s": len(ups) / build_s,
            "solver_settle_s": settled["settle_s"],
            "snapshot_incremental_ms": snapshot_ms,
            "snapshot_full_upload_ms": full_ms, "items": snap.n,
            "top_n": check_served_top_n(model, touched, rng, label),
            "fold_in_api": check_fold_in_api(model, rng, label),
        }
        out["microbatches"].append(record)
    out["launches"] = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - phase_t0
    check(not any(out["launches"].values()),
          f"lambda_loop: kernels launched in the speed half: {out['launches']}")
    out["flagship"] = flagship_snapshots(dev, rng)
    return out


#: the counters that must not move in a loop's run, in any tier
FAILURE_COUNTERS = ("oryx_quarantined_generations_total", "oryx_corrupt_records_total",
                    "oryx_layer_failures_total", "oryx_topic_send_failures_total",
                    "oryx_serving_consumer_restarts_total")


def lambda_loop_phase(lines, rng) -> dict:
    """The ALS lambda loop through the runtime (see the module docstring):
    the batch half, then the speed half; any layer failure, quarantined
    generation, corrupt record or failed send fails the phase."""
    registry = metrics.default_registry()
    before = registry.snapshot()
    with tempfile.TemporaryDirectory(prefix="oryx-loop-") as tmp:
        loop = LambdaLoop(tmp)
        try:
            out = {"batch": loop_generation(loop, lines, rng)}
            out["speed"] = loop_speed(loop, lines, rng)
            out["serving_http"] = serving_http_phase(loop, rng)
            # the drill and the swap take generators of their own: the
            # later phases' draws stay as they were
            out["chaos"] = chaos_phase(loop, np.random.default_rng(SEED + 71))
            out["serving_swap"] = serving_swap_phase(
                loop, [ln for ln in lines if int(ln[1:ln.index(",")]) < SWAP_USERS],
                np.random.default_rng(SEED + 41))
            out["serving_quant_http"] = serving_quant_http(loop, rng)
            # last in the loop: its /pref changes one user's and one item's
            # vectors, and no later phase checks an answer of this loop
            out["observability"] = observability_phase(
                loop, np.random.default_rng(SEED + 83))
            check(not loop.speed.stopped, "lambda_loop: the speed layer stopped")
        finally:
            loop.close()
        loop.await_layers()
    after = registry.snapshot()
    # the chaos drill's layer restarts its consumer on purpose
    injected = {"oryx_serving_consumer_restarts_total{}":
                out["chaos"]["consumer_restarts"]}
    failures = {}
    for name in FAILURE_COUNTERS:
        for labels, value in after.get(name, {}).items():
            key = f"{name}{{{labels}}}"
            delta = value - before.get(name, {}).get(labels, 0.0) - injected.get(key, 0)
            if delta:
                failures[key] = delta
    check(not failures, f"lambda_loop: failures counted: {failures}")
    out["failures"] = failures
    return out



# -- the serving layer's HTTP app ------------------------------------------------


class HttpClient:
    """One keep-alive HTTP/1.1 connection (stdlib ``http.client``)."""

    def __init__(self, port: int, timeout: float = 60.0):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def request(self, method: str, path: str, body=None, headers=None) -> tuple:
        """``(status, headers with lower-case names, body bytes)``."""
        self.conn.request(method, path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data

    def json(self, path: str, generation: "str | None" = None, headers=None):
        """GET ``path``, which must answer 200 (and, with ``generation``,
        carry that ``x-oryx-model-generation``); returns the parsed body."""
        status, head, data = self.request("GET", path, headers=headers)
        check(status == 200, f"serving_http: GET {path}: {status} {data[:200]!r}")
        if generation is not None:
            check(head.get("x-oryx-model-generation") == generation,
                  f"serving_http: GET {path}: generation header "
                  f"{head.get('x-oryx-model-generation')!r}, expected {generation!r}")
        return json.loads(data)

    def close(self) -> None:
        self.conn.close()


def check_same_top_n(got, want, label: str, field: str = "value",
                     beyond=(), ties: "list | None" = None) -> None:
    """``got`` (a body's ``[{"id", field}]``) against ``want`` (``(id,
    score)`` pairs): scores within ``HTTP_REL`` relative, and ids equal
    wherever neighbouring scores are not within it of each other (a near
    tie may order its ids either way, but holds the same ids). ``beyond``
    holds the ``(id, score)`` pairs that rank just past ``want``'s cut: a
    tie group that reaches the cut may hold any of those tied with it
    instead (which side of the cut a tie falls on is a rounding), so pass
    enough of them to hold the whole group. Each such stand-in is
    appended to ``ties``, when given, with its two scores."""
    check(len(got) == len(want), f"{label}: {len(got)} results, expected {len(want)}")
    gs = [float(e[field]) for e in got]
    ws = [float(v) for _, v in want]
    close = lambda a, b: abs(a - b) <= HTTP_REL * max(abs(a), abs(b), 1e-30)  # noqa: E731
    shown = (f"{[(e['id'], e[field]) for e in got]} against {list(want)} "
             f"(beyond: {list(beyond)})")
    check(all(close(a, b) for a, b in zip(gs, ws)), f"{label}: scores {shown}")
    start = 0
    for j in range(1, len(got) + 1):
        if j == len(got) or not close(ws[j], ws[j - 1]):
            ids = {e["id"] for e in got[start:j]}
            allowed = {i for i, _ in want[start:j]}
            tied = ({i: float(v) for i, v in beyond if close(float(v), ws[j - 1])}
                    if j == len(got) else {})
            check(ids <= allowed | tied.keys(), f"{label}: ids {shown}")
            if ties is not None:
                ties.extend({"label": label, "id": e["id"], "got": float(e[field]),
                             "ref": tied[e["id"]], "cut": ws[j - 1]}
                            for e in got[start:j] if e["id"] not in allowed)
            start = j


def http_load(port: int, paths: list, concurrency: int, n_requests: int) -> dict:
    """Closed-loop clients, run in a process of their own: ``concurrency``
    threads, each on its own keep-alive connection (one untimed request
    first, so that connecting is not timed), send ``GET`` requests for
    ``paths`` in turn until ``n_requests`` have been sent, each waiting for
    its answer before the next. Returns the count, the errors (a status
    other than 200 or a failed request), the seconds and the latency
    percentiles in milliseconds."""
    lock = threading.Lock()
    issued = [0]
    latencies: list = []
    errors: list = []
    start = threading.Barrier(concurrency + 1)

    def client(c: int) -> None:
        conn = HttpClient(port)
        mine = []
        try:
            conn.request("GET", paths[c % len(paths)])
            start.wait()
            while True:
                with lock:
                    j = issued[0]
                    issued[0] += 1
                if j >= n_requests:
                    break
                t0 = time.perf_counter()
                try:
                    status, _, _ = conn.request("GET", paths[j % len(paths)])
                except (OSError, http.client.HTTPException) as e:
                    errors.append(repr(e))
                    conn.close()
                    conn = HttpClient(port)
                    continue
                mine.append(time.perf_counter() - t0)
                if status != 200:
                    errors.append(status)
        finally:
            conn.close()
            with lock:
                latencies.extend(mine)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    ms = np.sort(np.asarray(latencies)) * 1000.0
    return {"concurrency": concurrency, "requests": len(latencies),
            "errors": len(errors), "error_samples": errors[:5],
            "seconds": seconds, "qps": len(latencies) / seconds,
            "p50_ms": float(np.percentile(ms, 50)) if len(ms) else None,
            "p99_ms": float(np.percentile(ms, 99)) if len(ms) else None}


def coalescer_counts() -> tuple:
    """The coalescer's batch-size histogram (per-bucket counts, sum, count)
    and its padding rows so far, from the port's registry."""
    registry = metrics.default_registry()
    rows = registry.get("oryx_coalescer_batch_size").bucket_samples()
    _, counts, total, n = rows[0] if rows else ((), [], 0.0, 0)
    pad = registry.get("oryx_coalescer_pad_waste_rows_total").value
    return list(counts), float(total), int(n), float(pad)


def coalescer_since(before: tuple) -> dict:
    """The coalescer's calls since ``before``: their count, mean real batch,
    the largest batch as the upper edge of the highest bucket that counted
    one (``max_batch_le``), and the padding rows."""
    counts, total, n, pad = coalescer_counts()
    c0, t0, n0, p0 = before
    delta = [a - (c0[j] if j < len(c0) else 0) for j, a in enumerate(counts)]
    edges = metrics.default_registry().get("oryx_coalescer_batch_size").buckets
    top = max((j for j, d in enumerate(delta) if d), default=None)
    calls = n - n0
    return {"device_calls": calls,
            "mean_batch": (total - t0) / calls if calls else None,
            "max_batch_le": (None if top is None else
                             edges[top] if top < len(edges) else float("inf")),
            "pad_waste_rows": pad - p0}


LAYER_THREADS = ("OryxServingLayer", "oryx-serving-exec", "OryxServingBatchWarmer")


def layer_threads(before) -> list:
    """Names of the serving layer threads alive in this process that were
    not in ``before``."""
    return [t.name for t in threading.enumerate()
            if t not in before and t.is_alive() and t.name.startswith(LAYER_THREADS)]


def applied_messages(layer) -> int:
    """Update-topic messages the layer's manager has applied: its consumer
    asks for the next message only after applying the last, so while it
    waits all it has read are applied."""
    metered = layer._metered_updates
    if metered is None:
        return 0
    return metered._consumed if metered._waiting else metered._consumed - 1


def start_layer(conf, what: str, device=None):
    """A ``ServingLayer`` on ``device`` (None: the card) on a free port,
    started; returns it, its port, the ``perf_counter`` time of the start
    and the threads alive before it."""
    port = ioutils.choose_free_port()
    layer = ServingLayer(conf.with_values({"oryx.serving.api.port": port}),
                         device=device)
    before = set(threading.enumerate())
    t0 = time.perf_counter()
    layer.start()
    check(layer.device == resolve(device), f"{what}: the layer is on {layer.device}")
    return layer, port, t0, before


def close_layer(layer, port: int, what: str, before) -> dict:
    """Close ``layer``: none of its threads (started since ``before``) may
    be left, and its port must be free: a listener may bind it again, as a
    restarted server does (``SO_REUSEADDR``: connections the layer closed
    itself, such as a ``urllib`` client's, linger in TIME_WAIT on it)."""
    t0 = time.perf_counter()
    layer.close()
    close_s = time.perf_counter() - t0
    left = layer_threads(before)
    check(not left, f"{what}: threads left after close(): {left}")
    with socket.socket() as probe:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind(("0.0.0.0", port))
        probe.listen(1)
    check(layer._failure is None and layer.consumer_restarts == 0,
          f"{what}: consumer failure {layer._failure!r}, "
          f"{layer.consumer_restarts} restarts")
    return {"close_s": close_s, "threads_left": left}


def check_routes_once(client, model, http_model, generation: str, rng) -> list:
    """Every ALS read route but ``/recommend`` once, against the in-process
    model's direct calls (``/recommend`` itself is checked per user). Both
    models' YᵀY solvers are brought up to their Y first (``SolverCache``
    hands out the previous solver while a recompute runs)."""
    settle_solvers([model.yty_cache, http_model.yty_cache])
    users = model.all_user_ids()
    u1, u2 = (users[j] for j in rng.choice(len(users), 2, replace=False))
    known1 = sorted(model.get_known_items(u1))
    items = model.all_item_ids()
    i1, i2, i3 = (items[j] for j in rng.choice(len(items), 3, replace=False))
    g = generation
    checked = []

    def route(path):
        checked.append(path)
        return client.json(path, g)

    mean = np.mean([model.get_user_vector(u1), model.get_user_vector(u2)], axis=0)
    known = model.get_known_items(u1) | model.get_known_items(u2)
    check_same_top_n(route(f"/recommendToMany/{u1}/{u2}"),
                     model.top_n(mean, 10, excluded=known), "/recommendToMany")
    vec = model.build_temporary_user_vector([(i1, 2.0), (i2, 1.0)])
    check_same_top_n(route(f"/recommendToAnonymous/{i1}=2/{i2}"),
                     model.top_n(vec, 10, excluded={i1, i2}), "/recommendToAnonymous")
    qs = np.stack([model.get_item_vector(i1), model.get_item_vector(i2)])
    check_same_top_n(route(f"/similarity/{i1}/{i2}"),
                     model.top_n_cosine(qs, 10, 0, lambda i: i not in {i1, i2}),
                     "/similarity")
    uv = model.get_user_vector(u1)
    check_same_top_n(route(f"/estimate/{u1}/{i1}/{i2}/{i3}"),
                     list(zip((i1, i2, i3), model.dot_with_items(uv, [i1, i2, i3]))),
                     "/estimate")
    known_vecs = model.get_known_item_vectors_for_user(u1)
    yi = model.get_item_vector(known1[0])
    sims = vectormath.cosine_similarities(
        np.stack([v for _, v in known_vecs]), yi, float(np.linalg.norm(yi)),
        device=model.device).tolist()
    want = sorted(zip((i for i, _ in known_vecs), sims), key=lambda t: -t[1])[:10]
    check_same_top_n(route(f"/because/{u1}/{known1[0]}"), want, "/because")
    check(route(f"/knownItems/{u1}") == known1, "/knownItems differ")
    counts = sorted(model.item_counts().items(), key=lambda t: -t[1])[:10]
    check_same_top_n(route("/mostPopularItems"), counts, "/mostPopularItems",
                     field="count")
    check(set(route("/user/allIDs")) == set(users), "/user/allIDs differ")
    body = client.json(f"/recommend/{u2}?howMany=10", g)
    status, head, data = client.request("GET", f"/recommend/{u2}?howMany=10",
                                        headers={"Accept": "text/csv"})
    check(status == 200 and head.get("content-type", "").startswith("text/csv")
          and head.get("x-oryx-model-generation") == g, "/recommend as CSV")
    rows = [ln.split(",") for ln in data.decode().splitlines()]
    check([[e["id"], e["value"]] for e in body] == [[i, float(v)] for i, v in rows],
          "/recommend as CSV differs from its JSON")
    checked.append("recommend (CSV)")
    return checked


def check_recommend(client, model, users, generation: str, label: str,
                    ties: "list | None" = None) -> int:
    """``/recommend/{u}?howMany=10`` for ``users``, with and without
    ``considerKnownItems``, against the in-process model's ``top_n`` with
    the same known items excluded (its next ``HTTP_TIE_DEPTH`` answers may
    stand in for the 10th's tie group; each stand-in goes to ``ties``).
    Returns the requests made."""
    for u in users:
        uv = model.get_user_vector(u)
        for consider in (False, True):
            path = f"/recommend/{u}?howMany=10" + ("&considerKnownItems=true"
                                                  if consider else "")
            want = model.top_n(uv, 10 + HTTP_TIE_DEPTH, excluded=None if consider
                               else model.get_known_items(u))
            check_same_top_n(client.json(path, generation), want[:10],
                             f"{label} {path}", beyond=want[10:], ties=ties)
    return 2 * len(users)


def serving_http_phase(loop: "LambdaLoop", rng, device=None) -> dict:
    """The serving layer's HTTP app on the loop's update topic (see the
    module docstring): replay, answers against the loop's in-process
    serving model, writes through the loop, load at four concurrencies,
    probes. No kernel may launch. ``device``: the layer's (None: the card;
    the tests run it on the CPU)."""
    K.reset_launches()
    t_phase = time.perf_counter()
    model = loop.serving.get_model()
    stamp = lineage.parse_stamp(loop.broker.read(loop.update_topic, 0, 1)[0].headers)
    check(stamp is not None, "serving_http: the first update is not a stamped MODEL")
    generation = stamp["generation"]
    total = loop.update_size()
    conf = loop.conf.with_values({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.api.read-only": False,
    })
    out: dict = {"update_messages": total, "generation": generation}
    # the client process starts first: its imports overlap the replay
    with mp.get_context("spawn").Pool(1) as pool:
        layer, port, t_start, threads = start_layer(conf, "serving_http", device)
        client = HttpClient(port)
        try:
            t_ready = wait_until(lambda: client.request("GET", "/ready")[0] == 200,
                                 300, "serving_http: /ready", layers=loop.layers,
                                 poll=0.01)
            t_current = wait_until(lambda: applied_messages(layer) >= total, 300,
                                   "serving_http: the replay", layers=loop.layers,
                                   poll=0.01)
            out["replay_to_ready_s"] = t_ready - t_start
            out["replay_to_current_s"] = t_current - t_start
            http_model = layer.manager.get_model()
            out["y_device"] = str(http_model.y_snapshot().mat.device)
            check(http_model.y_snapshot().mat.device.type == layer.device.type,
                  f"serving_http: the layer's Y is on {out['y_device']}")
            check(http_model.get_fraction_loaded() == 1.0,
                  "serving_http: the replayed model is not fully loaded")

            # answers against the loop's in-process model
            users = model.all_user_ids()
            sample = [users[j] for j in rng.choice(len(users), HTTP_USERS, replace=False)]
            t0 = time.perf_counter()
            ties: list = []
            n = check_recommend(client, model, sample, generation, "serving_http", ties)
            out["recommend_checked"] = {"users": len(sample), "requests": n,
                                        "seconds": time.perf_counter() - t0,
                                        "ties_at_cut": ties}
            out["routes_checked"] = check_routes_once(client, model, http_model,
                                                      generation, rng)

            # writes through the loop: /ingest → input topic → speed → both managers
            items = model.all_item_ids()
            ts0 = int(time.time() * 1000)
            ingest = [f"{users[a]},{items[b]},1,{ts0 + j}" for j, (a, b) in enumerate(zip(
                rng.integers(0, len(users), HTTP_INGEST_LINES),
                rng.integers(0, len(items), HTTP_INGEST_LINES)))]
            input_start = loop.broker.size(loop.input_topic)
            since = len(loop.watch.commits)
            t_first = time.perf_counter()
            for j in range(0, len(ingest), 100):
                status, _, data = client.request(
                    "POST", "/ingest", body="\n".join(ingest[j:j + 100]).encode(),
                    headers={"Content-Type": "text/csv"})
                check(status == 200,
                      f"serving_http: POST /ingest: {status} {data[:200]!r}")
            t_last = time.perf_counter()
            input_end = input_start + len(ingest)
            landed = [km.message for km in loop.broker.read(loop.input_topic, input_start,
                                                            2 * len(ingest))]
            check(landed == ingest, "serving_http: the ingested lines are not the input "
                  f"topic's ({len(landed)} landed)")
            commit = loop.wait_commit(loop.speed_group, input_end, since, 120,
                                      "serving_http: the speed generation of /ingest")
            update_end = loop.update_size()
            check(update_end > total, "serving_http: /ingest published no UP")
            t_served = wait_until(lambda: applied_messages(layer) >= update_end, 120,
                                  "serving_http: the layer applies the ingest UPs",
                                  layers=loop.layers, poll=0.001)
            loop.wait_applied(loop.served, update_end, 120,
                              "serving_http: the loop's manager applies the ingest UPs")
            touched = sorted({ln.split(",")[0] for ln in ingest})
            touched = [touched[j] for j in rng.choice(len(touched), HTTP_TOUCHED,
                                                      replace=False)]
            check_recommend(client, model, touched, generation, "serving_http touched")
            out["ingest"] = {"lines": len(ingest), "requests": len(ingest) // 100,
                             "post_s": t_last - t_first, "ups": update_end - total,
                             "speed_commit_after_last_post_s": commit["t0"] - t_last,
                             "ingest_to_served_s": t_served - t_last,
                             "touched_checked": len(touched)}
            out["ingest_to_served_s"] = t_served - t_last

            # load at four concurrencies from a client process
            paths = [f"/recommend/{u}?howMany=10" for u in sample]
            levels = []
            for concurrency, n_requests in HTTP_LOAD:
                before = coalescer_counts()
                level = pool.apply(http_load, (port, paths, concurrency, n_requests))
                level.update(coalescer_since(before))
                check(level["errors"] == 0 and level["requests"] == n_requests,
                      f"serving_http: load at {concurrency}: {level}")
                if concurrency >= 64:
                    check(level["mean_batch"] is not None and level["mean_batch"] > 1,
                          f"serving_http: load at {concurrency} did not batch: {level}")
                levels.append(level)
            out["load"] = levels

            # the operator's tools against this layer (the tools line)
            t_tools = time.perf_counter()
            out["tools"] = {
                "metrics": tools_metrics(client, port, device),
                "trace_id": tools_trace_id(client, port, sample[0]),
                "traffic": tools_traffic(pool, port, loop, layer)}
            out["tools"]["seconds"] = time.perf_counter() - t_tools

            # probes
            status, _, data = client.request("GET", "/readyz")
            readyz = json.loads(data)
            check(status == 200 and readyz["model"] == "loaded",
                  f"serving_http: /readyz {status} {readyz}")
            _, _, data = client.request("GET", "/metrics")
            routes = re.findall(r'oryx_serving_requests_total\{route="([^"]+)"',
                                data.decode())
            check({"/recommend/{userID}", "/ingest", "/because/{userID}/{itemID}"}
                  <= set(routes), f"serving_http: /metrics routes {sorted(set(routes))}")
            # the profiler route takes POST only (the profiling phase
            # captures through it)
            for method, path, want in (("GET", "/nope", 404),
                                       ("GET", "/debug/profile", 405)):
                status = client.request(method, path)[0]
                check(status == want, f"serving_http: {method} {path}: {status}")
            out["readyz"] = {k: readyz[k]
                             for k in ("status", "model", "update_lag_messages")}
        finally:
            client.close()
            closed = close_layer(layer, port, "serving_http", threads)
    out.update(closed)
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"serving_http: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the resilience subsystem under scheduled faults ----------------------------

# tests/test_chaos.py's pair: fast retries, a breaker that opens after 2
# failures and probes every 300 ms, fast consumer restarts, a dense tsdb
CHAOS_SETTINGS = {
    "oryx.tsdb.sample-interval-sec": 0.05,
    "oryx.resilience.retry.base-delay-ms": 2,
    "oryx.resilience.retry.max-delay-ms": 20,
    "oryx.resilience.breaker.failure-threshold": 2,
    "oryx.resilience.breaker.reset-sec": 0.3,
    "oryx.resilience.consumer-restart.base-delay-ms": 20,
    "oryx.resilience.consumer-restart.max-delay-ms": 100,
}
CHAOS_USERS = 20
CHAOS_BURST = 12
CHAOS_WARM = (8, 48)  # threads, requests
CHAOS_ITEM = "chaos-item"
CHAOS_JOIN_S = 10.0  # the reference case's bound on the consumer's join
BREAKER_LABEL = 'breaker="serving.device_call"'


class AppServer:
    """An aiohttp app from ``make_app`` served on a free port by a thread of
    its own; leaving the block stops the server and waits for its executor
    (a device call still sleeping in an injected latency included)."""

    def __init__(self, app):
        self.port = ioutils.choose_free_port()
        self._app = app
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="SmokeAppServer",
                                        daemon=True)

    def _serve(self) -> None:
        asyncio.set_event_loop(self._loop)
        runner = web.AppRunner(self._app, access_log=None)
        self._loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        self._loop.run_until_complete(site.start())
        self._started.set()
        self._loop.run_forever()
        self._loop.run_until_complete(runner.cleanup())
        self._loop.run_until_complete(self._loop.shutdown_default_executor())
        self._loop.close()

    def __enter__(self) -> int:
        self._thread.start()
        check(self._started.wait(15), "chaos: an app server did not start")
        return self.port

    def __exit__(self, *exc) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(30)
        check(not self._thread.is_alive(), "chaos: an app server did not stop")


def series(name: str, labels: str = "") -> float:
    """One series of the port's registry (0 before its first sample)."""
    return metrics.default_registry().snapshot().get(name, {}).get(labels, 0.0)


def breaker_state(client) -> float:
    """``oryx_circuit_breaker_state`` of the device-call breaker, as
    ``GET /metrics`` renders it (0 closed, 1 open, 2 half-open)."""
    status, _, data = client.request("GET", "/metrics")
    check(status == 200, f"chaos: GET /metrics: {status}")
    return parse_prometheus(data.decode())["oryx_circuit_breaker_state"][BREAKER_LABEL]


def burst(port: int, users: list, threads: int) -> list:
    """``GET /recommend/{u}?howMany=10`` for each of ``users`` from
    ``threads`` threads at once, each request on a connection of its own;
    ``(user, status, headers, body)`` in the order of ``users``."""
    def get(u):
        conn = HttpClient(port)
        try:
            return (u, *conn.request("GET", f"/recommend/{u}?howMany=10"))
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        return list(pool.map(get, users))


def refused(port: int) -> bool:
    """No listener on ``port`` any more: a connect is refused."""
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    except ConnectionRefusedError:
        return True
    return False


def chaos_phase(loop: "LambdaLoop", rng, device=None) -> dict:
    """``tests/test_chaos.py``'s drill on a serving layer of the loop's
    generation (see the module docstring): the update stream bulk-loaded
    under a ``tcp:`` broker in this process, a ``ServingLayer`` on
    ``device`` (None: the card) with the chaos pair's resilience settings,
    then (a) the breaker, (b) shedding, (c) the request deadline, (d) a
    broker outage across consumer restarts, (f) a warm window and (e) a
    close during the rebuild storm. Every answer the layer gives is held
    against the loop's in-process model; no kernel may launch."""
    K.reset_launches()
    t_phase = time.perf_counter()
    model = loop.serving.get_model()
    total = loop.update_size()
    stream = loop.broker.read(loop.update_topic, 0, total)
    check(len(stream) == total, f"chaos: read {len(stream)} of {total} updates")
    users = model.all_user_ids()
    sample = [users[j] for j in rng.choice(len(users), CHAOS_USERS, replace=False)]
    # each user's top 10 from the loop's model, and the HTTP_TIE_DEPTH
    # answers past it that may stand in for the 10th's tie group
    want = {u: model.top_n(model.get_user_vector(u), 10 + HTTP_TIE_DEPTH,
                           excluded=model.get_known_items(u)) for u in sample}
    check(all(float(w[9][1]) > 0 for w in want.values()),
          "chaos: a sampled user's 10th score is not positive (the zero "
          f"{CHAOS_ITEM} could enter the top 10)")
    path = {u: f"/recommend/{u}?howMany=10" for u in sample}
    checked = {"n": 0}

    def hold(body, u: str, label: str, against=None) -> None:
        """``body`` against the loop model's top 10 for ``u`` or, given,
        the ``against`` body's (id, value) pairs."""
        ref = (want[u][:10] if against is None
               else [(e["id"], e["value"]) for e in against])
        check_same_top_n(body, ref, f"chaos {label} {u}", beyond=want[u][10:])
        checked["n"] += 1

    out: dict = {"update_messages": total}
    with tempfile.TemporaryDirectory(prefix="oryx-chaos-") as tmp:
        t0 = time.perf_counter()
        bulk_load(Path(tmp), loop.update_topic, stream, "chaos")
        out["bulk_load_s"] = time.perf_counter() - t0
        server = netbroker.NetBrokerServer(tmp, host="127.0.0.1",
                                           port=0).start_background()
        broker_port = server.port
        url = f"tcp://127.0.0.1:{broker_port}"
        conf = loop.conf.with_values({
            "oryx.input-topic.broker": url,
            "oryx.update-topic.broker": url,
            "oryx.serving.model-manager-class":
                "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
            "oryx.serving.application-resources":
                "oryx_tpu_torch.serving.resources.als",
            **CHAOS_SETTINGS})
        layer, port, t_start, threads = start_layer(conf, "chaos", device)
        client = HttpClient(port)
        closed = False
        try:
            t_current = wait_until(lambda: applied_messages(layer) >= total, 300,
                                   "chaos: the replay over tcp", layers=loop.layers,
                                   poll=0.01)
            out["replay_s"] = t_current - t_start
            check(client.request("GET", "/ready")[0] == 200, "chaos: /ready")
            coalesced = {}
            for u in sample:
                coalesced[u] = client.json(path[u])
                hold(coalesced[u], u, "coalesced")
            u0 = sample[0]

            # (a) the device-call breaker: two failed coalesced calls open
            # it, their requests answered by the per-request fallback
            before = metrics.default_registry().snapshot()
            t0 = time.perf_counter()
            degraded0 = series("oryx_breaker_degraded_requests_total")
            faults.arm("serving.device_call=fail:2", seed=0)
            answered = 0  # every answer of (a), each against the coalesced one
            try:
                for _ in range(2):
                    hold(client.json(path[u0]), u0, "fallback", coalesced[u0])
                    answered += 1
                check(breaker_state(client) == 1.0,
                      "chaos: the breaker did not open after 2 failures")
                hold(client.json(path[u0]), u0, "open breaker", coalesced[u0])
                answered += 1
                check(series("oryx_breaker_degraded_requests_total") > degraded0 + 2,
                      "chaos: no degraded answer while the breaker was open")
                while True:
                    time.sleep(0.15)
                    hold(client.json(path[u0]), u0, "probe", coalesced[u0])
                    answered += 1
                    if breaker_state(client) == 0.0:
                        break
                    check(time.perf_counter() - t0 < 10,
                          "chaos: the breaker did not close within 10 s")
            finally:
                faults.disarm()
            after = metrics.default_registry().snapshot()
            moves = {to: after["oryx_circuit_breaker_transitions_total"].get(
                f'{BREAKER_LABEL},to="{to}"', 0.0)
                - before.get("oryx_circuit_breaker_transitions_total", {}).get(
                f'{BREAKER_LABEL},to="{to}"', 0.0)
                for to in ("open", "half_open", "closed")}
            check(all(n >= 1 for n in moves.values()),
                  f"chaos: breaker transitions {moves}")
            degraded = series("oryx_breaker_degraded_requests_total") - degraded0
            check(degraded <= answered, f"chaos: {degraded} degraded answers, "
                  f"{answered} checked")
            out["breaker"] = {"degraded_requests": degraded,
                              "answers_checked": answered, "transitions": moves,
                              "seconds": time.perf_counter() - t0}

            # (b) shedding: an app over the same manager with a queue of 1
            # and one call in flight, each call 400 ms late
            t0 = time.perf_counter()
            app = make_app(conf.with_values({
                "oryx.serving.compute.max-queue-depth": 1,
                "oryx.serving.compute.coalesce-inflight": 1,
                "oryx.serving.compute.coalesce-deadline-ms": 0}), layer.manager)
            shed0 = series("oryx_shed_requests_total")
            faults.arm("serving.device_call=latency:400", seed=0)
            try:
                with AppServer(app) as shed_port:
                    answers = burst(shed_port, sample[:CHAOS_BURST], CHAOS_BURST)
            finally:
                faults.disarm()
            statuses = sorted(a[1] for a in answers)
            shed = [a for a in answers if a[1] == 503]
            check(set(statuses) <= {200, 503} and shed,
                  f"chaos: the {CHAOS_BURST}-way burst gave {statuses}")
            check(all(h.get("retry-after") and json.loads(b)["status"] == 503
                      for _, _, h, b in shed), "chaos: a 503 without Retry-After")
            shed_n = series("oryx_shed_requests_total") - shed0
            check(shed_n == len(shed), f"chaos: {shed_n} shed counted, "
                  f"{len(shed)} answered 503")
            for u, status, _, body in answers:
                if status == 200:
                    got = json.loads(body)
                    check(len(got) == 10, f"chaos: {path[u]} gave {len(got)} items")
                    hold(got, u, "accepted")
            out["shed"] = {"statuses": statuses, "shed": len(shed),
                           "shed_counted": shed_n, "seconds": time.perf_counter() - t0}

            # (c) the request deadline: 150 ms against a 2 s device call
            t0 = time.perf_counter()
            app = make_app(conf.with_values(
                {"oryx.serving.api.request-timeout-sec": 0.15}), layer.manager)
            faults.arm("serving.device_call=latency:2000", seed=0)
            try:
                with AppServer(app) as dl_port:
                    dl = HttpClient(dl_port)
                    try:
                        status, _, data = dl.request("GET", path[u0])
                        body = json.loads(data)
                        check(status == 504 and body["status"] == 504
                              and body.get("trace_id"),
                              f"chaos: the deadline gave {status} {body}")
                        trace = dl.json(f"/trace?trace_id={body['trace_id']}")
                        names = {sp["name"] for sp in trace["spans"]}
                        check(any(n.startswith("http GET") for n in names),
                              f"chaos: the 504's trace holds {sorted(names)}")
                        check(dl.request("GET", "/healthz")[0] == 200,
                              "chaos: /healthz beside the 504")
                    finally:
                        dl.close()
            finally:
                faults.disarm()
            out["deadline"] = {"status": status, "trace_spans": len(names),
                               "seconds": time.perf_counter() - t0}

            # (d) a broker outage: the consumer restarts while it is down,
            # the layer answers throughout, and consumes again once the
            # broker is back on the same port over the same directory
            t0 = time.perf_counter()
            server.close()
            close_s = time.perf_counter() - t0
            wait_until(lambda: refused(broker_port), 30, "chaos: the broker's port",
                       layers=loop.layers)
            refused_s = time.perf_counter() - t0
            restarts0 = layer.consumer_restarts
            faults.arm("serving.update_consume=fail:1", seed=0)
            down = 0
            try:
                while layer.consumer_restarts < restarts0 + 2:
                    check(time.perf_counter() - t0 < 20,
                          "chaos: the consumer died instead of retrying its rebuild "
                          f"({layer.consumer_restarts - restarts0} restarts)")
                    hold(client.json(path[u0]), u0, "broker down", coalesced[u0])
                    down += 1
                    time.sleep(0.05)
            finally:
                faults.disarm()
            restarts_down = layer.consumer_restarts - restarts0
            t_up = time.perf_counter()
            server = netbroker.NetBrokerServer(tmp, host="127.0.0.1",
                                               port=broker_port).start_background()
            tp.TopicProducerImpl(url, loop.update_topic).send(
                "UP", json.dumps(["Y", CHAOS_ITEM, [0.0] * model.features]))
            def resumed():
                served = layer.manager.get_model()
                return served is not None and served.get_item_vector(CHAOS_ITEM) is not None

            t_item = wait_until(resumed, 30, "chaos: the consumer resumes",
                                layers=loop.layers)
            check(applied_messages(layer) == total + 1,
                  f"chaos: {applied_messages(layer)} applied after the outage, "
                  f"expected {total + 1}")
            for u in sample:
                hold(client.json(path[u]), u, "after the outage")
            out["outage"] = {"close_s": close_s, "close_to_refused_s": refused_s,
                             "restarts_while_down": restarts_down,
                             "answers_while_down": down,
                             "resume_s": t_item - t_up,
                             "seconds": time.perf_counter() - t0}

            # (f) the warm window: no fault armed, no error, nothing shed
            t0 = time.perf_counter()
            shed0 = series("oryx_shed_requests_total")
            threads_n, n = CHAOS_WARM
            answers = burst(port, [sample[j % len(sample)] for j in range(n)],
                            threads_n)
            check([a[1] for a in answers] == [200] * n,
                  f"chaos: the warm window gave {sorted({a[1] for a in answers})}")
            for u, _, _, body in answers:
                hold(json.loads(body), u, "warm")
            shed_n = series("oryx_shed_requests_total") - shed0
            check(shed_n == 0, f"chaos: {shed_n} shed in the warm window")
            check(client.request("GET", "/readyz")[0] == 200, "chaos: /readyz")
            out["warm"] = {"requests": n, "threads": threads_n, "shed": shed_n,
                           "seconds": time.perf_counter() - t0}

            # (e) close during the rebuild storm: the broker down again, the
            # consumer cycling through failed rebuilds, then close()
            t0 = time.perf_counter()
            server.close()
            restarts0 = layer.consumer_restarts
            faults.arm("serving.update_consume=fail:1", seed=0)
            try:
                wait_until(lambda: layer.consumer_restarts > restarts0, 20,
                           "chaos: the rebuild storm", layers=loop.layers)
            finally:
                faults.disarm()
            client.close()
            t_close = time.perf_counter()
            closed = True
            layer.close()
            consumer = layer._consumer_thread
            consumer.join(CHAOS_JOIN_S)
            join_s = time.perf_counter() - t_close
            check(not consumer.is_alive(), "chaos: the consumer thread outlived "
                  f"close() by {CHAOS_JOIN_S} s")
            left = layer_threads(threads)
            check(not left, f"chaos: threads left after close(): {left}")
            out["close_in_storm"] = {"restarts": layer.consumer_restarts - restarts0,
                                     "join_s": join_s, "threads_left": left,
                                     "seconds": time.perf_counter() - t0}
            out["consumer_restarts"] = layer.consumer_restarts
            check(layer._failure is None,
                  f"chaos: the consumer gave up: {layer._failure!r}")
        finally:
            faults.disarm()
            if not closed:
                client.close()
                layer.close()
            server.close()
            tp.reset_tcp_clients()
    out["answers_checked"] = checked["n"]
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"chaos: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- spans, metrics and the flight recorder on the card -------------------------

OBS_LEVELS = ((1, 100), (16, 25))  # connections, requests on each
OBS_USERS = 100
OBS_COVERAGE = 0.95  # tests/test_spans.py's acceptance share
OBS_SPEED_S = 15.0  # the reference case's bound on the topic hop
OBS_ROUTE = 'route="/recommend/{userID}",method="GET",status="200"'
OBS_RECENT = (256, 2048)  # /trace?limit= tried in turn for a linked call


def traced_requests(port: int, paths: list, concurrency: int, per_conn: int) -> list:
    """Run in a client process of its own: ``concurrency`` threads, each on
    its own keep-alive connection, send ``per_conn`` ``GET`` requests of
    ``paths`` each, every one with a ``traceparent`` of a fresh trace id,
    and fetch that trace from ``/trace?trace_id=`` right after the
    response (the span ring is bounded, so a later read could find it
    gone). Where the trace holds no device call with the request's queue
    wait as its parent (the coalescer parents a call into its first waiter
    and links the others), the recent spans are searched for the call
    that links the wait. Returns one record a request: the status, the
    trace id sent and the one answered, the trace's spans and the linked
    call (or None)."""
    out: list = [None] * (concurrency * per_conn)
    start = threading.Barrier(concurrency)

    def linked_call(conn, wait_id: str):
        for limit in OBS_RECENT:
            _, _, data = conn.request("GET", f"/trace?limit={limit}")
            for s in json.loads(data)["recent"]:
                if (s["name"] == "coalescer.device_call"
                        and any(ln["span_id"] == wait_id for ln in s["links"])):
                    return s
        return None

    def client(c: int) -> None:
        conn = HttpClient(port)
        try:
            start.wait()
            for j in range(per_conn):
                k = c * per_conn + j
                trace_id = spans.new_trace_id()
                status, head, _ = conn.request(
                    "GET", paths[k % len(paths)],
                    headers={"traceparent": f"00-{trace_id}-{spans.new_span_id()}-01"})
                _, _, data = conn.request("GET", f"/trace?trace_id={trace_id}")
                got = json.loads(data)["spans"]
                waits = [s for s in got if s["name"] == "coalescer.queue_wait"]
                call = None
                if len(waits) == 1 and not any(
                        s["name"] == "coalescer.device_call"
                        and s["parent_id"] == waits[0]["span_id"] for s in got):
                    call = linked_call(conn, waits[0]["span_id"])
                out[k] = {"status": status, "trace_id": trace_id,
                          "answered": head.get("x-oryx-trace-id"), "spans": got,
                          "linked_call": call}
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _end_s(s: dict) -> float:
    return s["start"] + s["duration_ms"] / 1000.0


def request_breakdown(rec: dict, label: str) -> dict:
    """One traced ``/recommend`` (a :func:`traced_requests` record) held to
    ``tests/test_spans.py``'s acceptance case: 200 under the trace id sent;
    the trace holds the ingress span and one queue wait; the device call,
    with ``batch.size`` >= 1 and ``pad.waste_rows``, reaches the wait as
    its parent or by a link; the wait and the call cover at least
    ``OBS_COVERAGE`` of the time from the wait's start to the call's end.
    Returns the ingress, wait and call milliseconds, the ingress time
    outside wait ∪ call (the HTTP front's own share), the call's id, its
    batch size and whether it was reached by a link."""
    where = f"{label} {rec['trace_id']}"
    check(rec["status"] == 200 and rec["answered"] == rec["trace_id"],
          f"{where}: status {rec['status']}, trace id answered {rec['answered']}")
    got = rec["spans"]
    ingress = [s for s in got if s["name"].startswith("http GET /recommend")]
    waits = [s for s in got if s["name"] == "coalescer.queue_wait"]
    check(len(ingress) == 1 and len(waits) == 1,
          f"{where}: {len(ingress)} ingress spans and {len(waits)} queue waits in "
          f"{[s['name'] for s in got]}")
    (ingress,), (wait,) = ingress, waits
    check("queue_wait_ms" in wait["attributes"], f"{where}: the wait has no queue_wait_ms")
    parented = [s for s in got if s["name"] == "coalescer.device_call"
                and s["parent_id"] == wait["span_id"]]
    call = parented[0] if parented else rec["linked_call"]
    check(call is not None and (call["parent_id"] == wait["span_id"] or any(
        ln["span_id"] == wait["span_id"] for ln in call["links"])),
        f"{where}: no device call reaches the queue wait {wait['span_id']}")
    check(call["attributes"].get("batch.size", 0) >= 1
          and "pad.waste_rows" in call["attributes"],
          f"{where}: the call's attributes {call['attributes']}")
    w0, c1 = wait["start"], _end_s(call)
    inner = _interval_union([(w0, _end_s(wait)), (call["start"], c1)])
    check(inner >= OBS_COVERAGE * (c1 - w0),
          f"{where}: wait and call cover {inner:.6f} of {c1 - w0:.6f} s: {got} {call}")
    lo, hi = ingress["start"], _end_s(ingress)
    covered = _interval_union([(max(lo, a), min(hi, b)) for a, b in
                        ((w0, _end_s(wait)), (call["start"], c1)) if min(hi, b) > max(lo, a)])
    return {"ingress_ms": ingress["duration_ms"], "wait_ms": wait["duration_ms"],
            "call_ms": call["duration_ms"], "front_ms": max(0.0, (hi - lo) - covered) * 1000.0,
            "call": call["span_id"], "batch": call["attributes"]["batch.size"],
            "linked": not parented}


def _quantiles(values) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}


def openmetrics_exemplars(text: str, name: str) -> list:
    """``(labels, trace id)`` of each exemplar on ``name``'s buckets in an
    OpenMetrics exposition."""
    return re.findall(rf'^{re.escape(name)}_bucket\{{(.*?)\}} \S+ # '
                      r'\{trace_id="([0-9a-f]{32})"\}', text, re.MULTILINE)


def observability_phase(loop: "LambdaLoop", rng, device=None) -> dict:
    """``tests/test_spans.py``'s and ``tests/test_metrics.py``'s end-to-end
    assertions on a serving layer of the loop's generation (see the module
    docstring): (a) request spans at 1 and 16 connections, (b) the scrape's
    deltas and an OpenMetrics exemplar resolved to its trace, (c) one
    ``/pref`` continued in the loop's speed layer under its trace id, (d)
    the flight recorder's bundle. No kernel may launch. ``device``: the
    layer's (None: the card; the tests run it on the CPU)."""
    K.reset_launches()
    t_phase = time.perf_counter()
    model = loop.serving.get_model()
    total = loop.update_size()
    conf = loop.conf.with_values({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.api.read-only": False,
    })
    users = model.all_user_ids()
    sample = [users[j] for j in rng.choice(len(users), min(OBS_USERS, len(users)),
                                           replace=False)]
    paths = [f"/recommend/{u}?howMany=10" for u in sample]
    out: dict = {"update_messages": total}
    # the client process starts first: its imports overlap the replay
    with mp.get_context("spawn").Pool(1) as pool:
        layer, port, t_start, threads = start_layer(conf, "observability", device)
        client = HttpClient(port)
        try:
            wait_until(lambda: applied_messages(layer) >= total, 300,
                       "observability: the replay", layers=loop.layers, poll=0.01)
            out["replay_s"] = time.perf_counter() - t_start
            check(client.request("GET", "/ready")[0] == 200, "observability: /ready")
            warm = pool.apply(traced_requests, (port, paths, 1, 1))  # the pool's imports
            check(warm[0]["status"] == 200, f"observability: the first request {warm}")

            # (a) request spans, (b) the scrape around them
            _, _, data = client.request("GET", "/metrics")
            before = parse_prometheus(data.decode())
            t0 = time.perf_counter()
            levels, sent = {}, 0
            for concurrency, per_conn in OBS_LEVELS:
                recs = pool.apply(traced_requests, (port, paths, concurrency, per_conn))
                rows = [request_breakdown(r, f"observability at {concurrency}")
                        for r in recs]
                sent += len(recs)
                calls = {r["call"]: r["batch"] for r in rows}
                level = {"requests": len(rows), "checked": len(rows),
                         "linked": sum(r["linked"] for r in rows),
                         "device_calls": len(calls),
                         **{k: _quantiles([r[k] for r in rows])
                            for k in ("ingress_ms", "wait_ms", "call_ms", "front_ms")}}
                if concurrency > 1:
                    sizes = np.bincount(list(calls.values()))
                    level["batch_sizes"] = {str(b): int(n) for b, n in enumerate(sizes) if n}
                levels[str(concurrency)] = level
            out["spans"] = {"levels": levels, "seconds": time.perf_counter() - t0}
            _, _, data = client.request("GET", "/metrics")
            after = parse_prometheus(data.decode())

            def delta(name: str, labels: str = "") -> float:
                return (after.get(name, {}).get(labels, 0.0)
                        - before.get(name, {}).get(labels, 0.0))

            requests_now = after.get("oryx_serving_requests_total", {}).get(OBS_ROUTE)
            scrape = {"requests_total": delta("oryx_serving_requests_total", OBS_ROUTE),
                      "batch_size_sum": delta("oryx_coalescer_batch_size_sum"),
                      "topn_queries": delta("oryx_serving_topn_queries_total"),
                      "queue_depth": after.get("oryx_coalescer_queue_depth", {}).get("")}
            check(scrape["requests_total"] == sent and scrape["batch_size_sum"] == sent
                  and scrape["topn_queries"] >= sent and scrape["queue_depth"] == 0,
                  f"observability: the scrape's deltas {scrape} for {sent} requests")
            status, head, data = client.request(
                "GET", "/metrics", headers={"Accept": "application/openmetrics-text"})
            check(status == 200 and head.get("content-type", "").startswith(
                "application/openmetrics-text"),
                f"observability: OpenMetrics scrape {status} {head.get('content-type')}")
            exemplars = [tid for labels, tid in openmetrics_exemplars(
                data.decode(), "oryx_serving_request_latency_seconds")
                if labels.startswith('route="/recommend/{userID}"')]
            check(exemplars, "observability: no exemplar on the /recommend latency")
            _, _, data = client.request("GET", "/trace?limit=2048")
            recent = json.loads(data)["recent"]
            resolved = None
            for tid in exemplars:
                got = client.json(f"/trace?trace_id={tid}")["spans"]
                waits = [s for s in got if s["name"] == "coalescer.queue_wait"]
                own = any(s["name"] == "coalescer.device_call" for s in got)
                linked = waits and any(
                    s["name"] == "coalescer.device_call"
                    and any(ln["span_id"] == waits[0]["span_id"] for ln in s["links"])
                    for s in recent)
                if any(s["name"].startswith("http GET") for s in got) and (own or linked):
                    resolved = {"trace_id": tid, "spans": len(got),
                                "call": "in the trace" if own else "by a link"}
                    if own:
                        break
            check(resolved is not None,
                  f"observability: no exemplar of {exemplars} resolves to a device call")
            scrape["exemplars"] = len(exemplars)
            scrape["exemplar"] = resolved
            out["scrape"] = scrape

            # (c) the ingress hop into the loop's speed tier
            t0 = time.perf_counter()
            trace_id = spans.new_trace_id()
            input_start = loop.broker.size(loop.input_topic)
            since = len(loop.watch.commits)
            pref_user = sample[0]
            pref_item = model.all_item_ids()[int(rng.integers(len(model.all_item_ids())))]
            status, head, data = client.request(
                "POST", f"/pref/{pref_user}/{pref_item}", body=b"1.0",
                headers={"traceparent": f"00-{trace_id}-{spans.new_span_id()}-01"})
            check(status == 200 and head.get("x-oryx-trace-id") == trace_id,
                  f"observability: POST /pref {status} {data[:200]!r}")
            t_sent = time.perf_counter()

            def consumed():
                got = client.json(f"/trace?trace_id={trace_id}")["spans"]
                return any(s["name"] == "speed.consume_input" for s in got)

            t_hop = wait_until(consumed, OBS_SPEED_S,
                               "observability: speed.consume_input under the /pref trace",
                               layers=loop.layers, poll=0.05)
            names = sorted({s["name"] for s in
                            client.json(f"/trace?trace_id={trace_id}")["spans"]})
            check(any(n.startswith("http POST /pref") for n in names),
                  f"observability: the /pref trace {names}")
            loop.wait_commit(loop.speed_group, input_start + 1, since, 60,
                             "observability: the speed generation of /pref")
            settled = loop.settle(60, "observability: the /pref UPs")
            check(settled["total"] > total, "observability: /pref published no UP")
            out["speed_hop"] = {"trace_id": trace_id, "spans": names,
                                "to_consume_input_s": t_hop - t_sent,
                                "ups": settled["total"] - total,
                                "seconds": time.perf_counter() - t0}

            # (d) the flight recorder's bundle
            bundle = blackbox.bundle("observability")
            versions = bundle.get("versions", {})
            on_card = layer.device.type == "cuda"
            memory = bundle.get("memory", {}).get("devices", {})
            in_bundle = bundle.get("metrics", {}).get(
                "oryx_serving_requests_total", {}).get(OBS_ROUTE)
            check(versions.get("oryx_tpu_torch") and versions.get("torch")
                  and (not on_card or "cuda:0" in memory)
                  and in_bundle == requests_now,
                  f"observability: the bundle's versions {versions}, memory "
                  f"{sorted(memory)}, requests {in_bundle} against the scrape's "
                  f"{requests_now}")
            out["bundle"] = {"versions": versions, "memory_devices": sorted(memory),
                             "requests_total": in_bundle}
        finally:
            client.close()
            closed = close_layer(layer, port, "observability", threads)
    out.update(closed)
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"observability: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the staged generation swap over HTTP ---------------------------------------

SWAP_FEATURES = 60
SWAP_USERS = DURABILITY_USERS
SWAP_CONNECTIONS = 16
SWAP_WINDOW_S = 8.0
SWAP_CHECKED = 100
SWAP_DEADLINE_S = 0.2
SWAP_TIMESTAMP_MS = GENERATION_TIMESTAMP_MS + 1
SWAP_COUNTERS = ("oryx_serving_prewarmed_swaps_total",
                 "oryx_serving_swap_deadline_promotions_total")


def swap_load(port: int, paths: list, concurrency: int, started_path: str,
              stop_path: str, max_s: float) -> list:
    """Closed-loop clients, run in a process of their own until the file
    ``stop_path`` exists (or ``max_s`` pass): ``concurrency`` threads, each
    on its own keep-alive connection, send ``GET`` requests for ``paths``
    in turn, each waiting for its answer; the file ``started_path`` is
    made once all are connected. Returns, per connection in order, each
    request's ``(wall start, wall end, status, generation header)``; a
    failed request has status 0."""
    out = [[] for _ in range(concurrency)]
    start = threading.Barrier(concurrency, action=lambda: Path(started_path).touch())
    deadline = time.time() + max_s

    def client(c: int) -> None:
        conn = HttpClient(port)
        mine = out[c]
        start.wait()
        j = c
        try:
            while time.time() < deadline and not Path(stop_path).exists():
                t0 = time.time()
                try:
                    status, head, _ = conn.request("GET", paths[j % len(paths)])
                    gen = head.get("x-oryx-model-generation")
                except (OSError, http.client.HTTPException):
                    status, gen = 0, None
                    conn.close()
                    conn = HttpClient(port)
                mine.append((t0, time.time(), status, gen))
                j += concurrency
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def swap_windows(per_conn: list, bounds: dict) -> dict:
    """Per window ``name: (start, end)`` (wall seconds), the requests that
    ended in it: count, statuses, p50 / p99 milliseconds. An empty or
    reversed window counts nothing."""
    flat = [r for conn in per_conn for r in conn]
    out = {}
    for name, (a, b) in bounds.items():
        rows = [r for r in flat if a <= r[1] < b]
        ms = np.sort(np.asarray([(e - s) * 1e3 for s, e, _, _ in rows]))
        statuses: dict = {}
        for r in rows:
            statuses[str(r[2])] = statuses.get(str(r[2]), 0) + 1
        out[name] = {"seconds": b - a, "requests": len(rows), "statuses": statuses,
                     "p50_ms": float(np.percentile(ms, 50)) if len(ms) else None,
                     "p99_ms": float(np.percentile(ms, 99)) if len(ms) else None}
    return out


def generation_order(per_conn: list, gen1: str, gen2: str) -> dict:
    """Each connection's generation headers in order: gen-1, then gen-2,
    never back. Returns the headers' counts and the connections that went
    back."""
    counts: dict = {}
    back = []
    for c, conn in enumerate(per_conn):
        seen2 = False
        for _, _, status, gen in conn:
            counts[str(gen)] = counts.get(str(gen), 0) + 1
            if gen == gen2:
                seen2 = True
            elif gen == gen1 and seen2:
                back.append(c)
                break
    return {"headers": counts, "connections_back": back}


def swap_generation(lines: list, device=None) -> dict:
    """Generation 2: ``ALSUpdate.run_update`` at ``SWAP_FEATURES`` on
    ``lines`` to a recording producer. The launch counters are set to 0
    first and read after; its first launch at each shape is held against
    the plain version."""
    conf = oryx_config.overlay_on({
        "oryx.ml.eval.test-fraction": TEST_FRACTION,
        "oryx.ml.eval.candidates": 1,
        "oryx.als.hyperparams.lambda": LAM,
        "oryx.als.hyperparams.features": SWAP_FEATURES,
        "oryx.als.hyperparams.alpha": ALPHA,
        "oryx.als.iterations": ITERATIONS,
    }, oryx_config.get_default())
    update = ALSUpdate(conf, device=device)
    producer = RecordingProducer()
    context = types.SimpleNamespace(input_offsets={0: len(lines)},
                                    input_watermark_ms=SWAP_TIMESTAMP_MS)
    messages = [KeyMessage(None, ln) for ln in lines]
    with tempfile.TemporaryDirectory(prefix="oryx-swap-") as tmp, \
            FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                           (tr, "spd_solve_batched", spd_key)]) as first:
        K.reset_launches()
        costs0 = metrics.default_registry().snapshot()
        t0 = time.perf_counter()
        update.run_update(context, SWAP_TIMESTAMP_MS, messages, [], tmp, producer)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        counted = dict(K.SHAPE_LAUNCHES)
    check_train_costs(costs0, ITERATIONS, "serving_swap.generation")
    cand = next(iter(update.report["candidates"].values()))
    blocks = sum(cand["blocks"].values())
    check({w: launches[w] for w in ALS_WRAPPERS}
          == {w: ITERATIONS * blocks for w in ALS_WRAPPERS},
          f"serving_swap: generation 2 launched {launches}, expected "
          f"{ITERATIONS} x {blocks} blocks")
    ks = {shape[1] if kernel.startswith("spd") else shape[3]
          for kernel, shape in counted}
    check(ks == {SWAP_FEATURES},
          f"serving_swap: launches at k = {ks}, not {SWAP_FEATURES}: {counted}")
    check(producer.sent and producer.sent[0][0] == "MODEL",
          "serving_swap: generation 2 did not publish a MODEL first")
    stamp = lineage.parse_stamp(producer.sent[0][2])
    check(stamp is not None, "serving_swap: generation 2's MODEL is not stamped")
    return {"run_update_s": run_s, "train_s": cand["train_s"],
            "blocks": cand["blocks"], "messages": len(producer.sent),
            "generation": stamp["generation"], "sent": producer.sent,
            "launches": {w: launches[w] for w in ALS_WRAPPERS},
            "shape_launches": {launch_key(*key): c for key, c in counted.items()},
            "held_against_plain": hold_path_launches(first, counted, "serving_swap")}


def swap_run(conf, broker: str, gen1: list, gen2: list, ids: tuple, paths: list,
             pool, prewarm: bool, tmp: Path, model2=None, users=(),
             device=None) -> dict:
    """One layer on the update topic of ``broker``, holding ``gen1``'s
    stream, under closed-loop load at ``SWAP_CONNECTIONS`` from the client
    process, given ``gen2``'s stream after ``SWAP_WINDOW_S``: the windows
    before the stage, staged (or, without ``prewarm``, while generation 2
    loads), and after the flip; generation 2's answers for ``users``
    against ``model2`` once it is current."""
    what = "serving_swap" if prewarm else "serving_swap.contrast"
    gen1_id, gen2_id = ids
    conf = conf.with_values({
        "oryx.input-topic.broker": broker, "oryx.update-topic.broker": broker,
        "oryx.compile.prewarm-swap": prewarm})
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    topic = conf.get_string("oryx.update-topic.message.topic")
    # appended straight to the broker: a generation published by another
    # process lands as a burst, not at the rate of sends from this one
    # (whose host time would compete with the layer's)
    log = tp.get_broker(broker)
    for key, message, headers in gen1:
        log.append(topic, key, message, headers)
    n1 = len(gen1)
    counters0 = {name: metrics.default_registry().snapshot().get(name, {}).get("", 0.0)
                 for name in SWAP_COUNTERS}
    compilecache.warmup_state().reset()
    layer, port, t_start, threads = start_layer(conf, what, device)
    out: dict = {"prewarm_swap": prewarm, "gen1_messages": n1, "gen2_messages": len(gen2)}
    flips, ladders = [], []
    stop_path = tmp / f"stop-{int(prewarm)}"
    started_path = tmp / f"started-{int(prewarm)}"
    try:
        t_ready = wait_until(lambda: applied_messages(layer) >= n1
                             and layer._warmer.warmed_models >= 1, 300,
                             f"{what}: generation 1 loaded and warm")
        out["gen1_ready_s"] = t_ready - t_start
        manager, warmer = layer.manager, layer._warmer
        promote, warm = manager.promote_staged, warmer._warm_model

        def recorded_promote(expected=None):
            done = promote(expected=expected)
            flips.append((time.time(), done))
            return done

        def recorded_warm(model):
            t0 = time.time()
            ok = warm(model)
            ladders.append({"features": model.features, "start": t0,
                            "end": time.time(), "ok": ok})
            return ok

        # the warmer and the consumer look these up at each call
        manager.promote_staged = recorded_promote
        warmer._warm_model = recorded_warm
        load = pool.apply_async(swap_load, (port, paths, SWAP_CONNECTIONS,
                                            str(started_path), str(stop_path), 600))
        wait_until(started_path.exists, 120, f"{what}: the client process")
        time.sleep(SWAP_WINDOW_S)
        mono_to_wall = time.time() - time.monotonic()
        t_send = time.time()
        for key, message, headers in gen2:
            log.append(topic, key, message, headers)
        t_appended = time.time()
        out["gen2_append_s"] = t_appended - t_send
        wait_until(lambda: manager.get_model().features == SWAP_FEATURES, 120,
                   f"{what}: generation 2 in service", poll=0.001)
        t_live = time.time()
        wait_until(lambda: applied_messages(layer) >= n1 + len(gen2)
                   and manager.get_model().get_fraction_loaded() == 1.0, 120,
                   f"{what}: generation 2 applied", poll=0.001)
        t_loaded = time.time()
        out["append_to_loaded_s"] = t_loaded - t_send
        time.sleep(SWAP_WINDOW_S)
        t_stop = time.time()
        stop_path.touch()
        per_conn = load.get(120)
        t_first = min(conn[0][1] for conn in per_conn if conn)
        if prewarm:
            check(len(flips) >= 1 and flips[-1][1],
                  f"{what}: no prewarmed promotion: {flips}")
            t_stage = manager._staged_at + mono_to_wall
            t_flip = next(t for t, done in flips if done)
            gen2_ladder = [lad for lad in ladders if lad["features"] == SWAP_FEATURES]
            check(gen2_ladder and gen2_ladder[-1]["ok"]
                  and gen2_ladder[-1]["end"] <= t_flip,
                  f"{what}: generation 2's ladder {gen2_ladder} did not finish "
                  f"before the flip at {t_flip}")
            out.update(stage_to_promote_s=t_flip - t_stage,
                       append_to_stage_s=t_stage - t_send,
                       warm_ladder_s=gen2_ladder[-1]["end"] - gen2_ladder[-1]["start"],
                       append_to_promote_s=t_flip - t_send)
            # the staged window also without the burst's own append (host
            # time of this process, which a publisher elsewhere would not take)
            bounds = {"before": (t_first, t_stage), "staged": (t_stage, t_flip),
                      "staged_after_append": (t_appended, t_flip),
                      "after": (t_flip, t_stop)}
        else:
            out.update(append_to_live_s=t_live - t_send)
            bounds = {"before": (t_first, t_send), "loading": (t_send, t_loaded),
                      "loading_after_append": (t_appended, t_loaded),
                      "after": (t_loaded, t_stop)}
        out["windows"] = swap_windows(per_conn, bounds)
        out["order"] = generation_order(per_conn, gen1_id, gen2_id)
        flat = [r for conn in per_conn for r in conn]
        out["requests"] = len(flat)
        out["server_errors"] = sum(1 for r in flat if r[2] >= 500)
        out["failed"] = sum(1 for r in flat if r[2] == 0)
        # answers from a generation 2 still loading: after its MODEL was
        # sent and before it was wholly applied, any non-200 or gen-2 answer
        out["answers_from_loading_gen2"] = sum(
            1 for r in flat if t_send <= r[1] < t_loaded
            and (r[2] != 200 or r[3] == gen2_id))
        out["counters"] = {name: metrics.default_registry().snapshot().get(
            name, {}).get("", 0.0) - counters0[name] for name in SWAP_COUNTERS}
        out["ladders"] = [{"features": lad["features"], "ok": lad["ok"],
                           "seconds": lad["end"] - lad["start"]} for lad in ladders]
        if model2 is not None:
            client = HttpClient(port)
            try:
                t0 = time.perf_counter()
                n = check_recommend(client, model2, users, gen2_id, what)
                out["gen2_answers_checked"] = {"users": len(users), "requests": n,
                                               "seconds": time.perf_counter() - t0}
            finally:
                client.close()
    finally:
        stop_path.touch()
        out.update(close_layer(layer, port, what, threads))
        compilecache.warmup_state().reset()
    return out


def swap_deadline(gen1_model, gen2_model, device=None) -> dict:
    """A bare manager with ``swap-deadline-sec`` = ``SWAP_DEADLINE_S`` and
    no warmer: generation 1's ``MODEL`` goes live, generation 2's (no
    ``UP``) is staged, and the first ``get_model()`` past the deadline
    promotes it; the deadline counter gains 1."""
    manager = ALSServingModelManager(oryx_config.overlay_on({
        "oryx.serving.compute.precompile-batches": True,
        "oryx.compile.swap-deadline-sec": SWAP_DEADLINE_S,
    }, oryx_config.get_default()), device=device)
    name = "oryx_serving_swap_deadline_promotions_total"
    before = metrics.default_registry().snapshot().get(name, {}).get("", 0.0)
    manager.consume_key_message("MODEL", gen1_model)
    manager.consume_key_message("MODEL", gen2_model)
    check(manager.get_model().features == FEATURES
          and manager.get_staged_model().features == SWAP_FEATURES,
          "serving_swap: generation 2 was not staged behind generation 1")
    time.sleep(SWAP_DEADLINE_S + 0.05)
    check(manager.get_model().features == SWAP_FEATURES
          and manager.get_staged_model() is None,
          "serving_swap: the deadline did not promote generation 2")
    delta = metrics.default_registry().snapshot().get(name, {}).get("", 0.0) - before
    check(delta == 1, f"serving_swap: deadline counter +{delta}, expected +1")
    return {"deadline_s": SWAP_DEADLINE_S, "promoted": True, "counter_delta": delta}


def serving_swap_phase(loop: "LambdaLoop", lines: list, rng, device=None) -> dict:
    """The ``serving_swap`` line (see the module docstring). ``device``:
    the layers' and the generation's (None: the card; the tests run it on
    the CPU)."""
    t_phase = time.perf_counter()
    n1 = loop.update_size()
    gen1 = [(km.key, km.message, km.headers)
            for km in loop.broker.read(loop.update_topic, 0, n1)]
    check(len(gen1) == n1 and gen1[0][0] == "MODEL",
          "serving_swap: the loop's update topic does not start with its MODEL")
    gen1_id = lineage.parse_stamp(gen1[0][2])["generation"]
    out: dict = {"gen1": {"messages": n1, "generation": gen1_id,
                          "features": FEATURES}}
    gen = swap_generation(lines, device)
    sent = gen.pop("sent")
    out["gen2"] = gen
    check(gen["generation"] != gen1_id, "serving_swap: both generations share an id")
    model2 = ALSServingModelManager(loop.conf, device=device)
    for key, message, _ in sent:
        model2.consume_key_message(key, message)
    model2 = model2.get_model()
    check(model2.features == SWAP_FEATURES and model2.get_fraction_loaded() == 1.0,
          "serving_swap: the in-process generation 2 is not loaded")
    users1 = set(loop.serving.get_model().all_user_ids())
    users = sorted(u for u in model2.all_user_ids() if u in users1)
    sample = [users[j] for j in rng.choice(len(users), HTTP_USERS, replace=False)]
    paths = [f"/recommend/{u}?howMany=10" for u in sample]
    conf = loop.conf.with_values({
        "oryx.id": "swap",
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.api.read-only": True,
        "oryx.serving.compute.precompile-batches": True,
    })
    ids = (gen1_id, gen["generation"])
    with tempfile.TemporaryDirectory(prefix="oryx-swap-load-") as tmp, \
            mp.get_context("spawn").Pool(1) as pool:
        out["swap"] = swap_run(conf, "memory:swap", gen1, sent, ids, paths, pool,
                               True, Path(tmp), model2, sample[:SWAP_CHECKED],
                               device)
        out["contrast"] = swap_run(conf, "memory:swap-contrast", gen1, sent, ids,
                                   paths, pool, False, Path(tmp), device=device)
    swap = out["swap"]
    check(swap["server_errors"] == 0 and swap["failed"] == 0,
          f"serving_swap: {swap['server_errors']} 5xx, {swap['failed']} failed")
    check(not swap["order"]["connections_back"]
          and set(swap["order"]["headers"]) == set(ids),
          f"serving_swap: generation headers {swap['order']}")
    check(swap["counters"] == {SWAP_COUNTERS[0]: 1.0, SWAP_COUNTERS[1]: 0.0},
          f"serving_swap: counters {swap['counters']}")
    out["deadline"] = swap_deadline(gen1[0][1], sent[0][1], device)
    out["launches"] = gen["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    return out


def kmeans_http(conf, text: str, ups: list, points: np.ndarray, serving, rng,
                device=None) -> dict:
    """A small k-means ``ServingLayer`` on the card, on an update topic of
    its own holding the generation's ``MODEL`` and the speed ``UP``s:
    ``/assign`` and ``/distanceToNearest`` against ``nearest_cluster`` of
    the in-process manager that applied the same messages, and ``/add``
    onto its input topic."""
    K.reset_launches()
    t_phase = time.perf_counter()
    broker_url = "memory:kmeans-serving"
    conf = conf.with_values({
        "oryx.input-topic.broker": broker_url,
        "oryx.update-topic.broker": broker_url,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.kmeans.serving.KMeansServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.kmeans",
    })
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    broker = tp.get_broker(broker_url)
    update_topic = conf.get_string("oryx.update-topic.message.topic")
    input_topic = conf.get_string("oryx.input-topic.message.topic")
    producer = tp.TopicProducerImpl(broker_url, update_topic)
    producer.send("MODEL", text)
    for u in ups:
        producer.send("UP", u)
    producer.close()
    total = broker.size(update_topic)
    layer, port, t_start, threads = start_layer(conf, "kmeans serving_http", device)
    client = HttpClient(port)
    out: dict = {"update_messages": total}
    try:
        wait_until(lambda: applied_messages(layer) >= total, 120,
                   "kmeans serving_http: the replay", poll=0.005)
        out["replay_s"] = time.perf_counter() - t_start
        queries = points[rng.choice(len(points), HTTP_KMEANS_QUERIES, replace=False)]
        model = serving.get_model()
        t0 = time.perf_counter()
        for q in queries:
            datum = ",".join(repr(float(v)) for v in q)
            want_id, want_d = model.nearest_cluster(np.asarray(
                [float(v) for v in datum.split(",")]))
            status, _, data = client.request("GET", f"/assign/{datum}")
            check(status == 200 and int(data) == want_id,
                  f"kmeans serving_http: /assign {status} {data!r}, expected {want_id}")
            status, _, data = client.request("GET", f"/distanceToNearest/{datum}")
            check(status == 200 and float(data) == want_d,
                  f"kmeans serving_http: /distanceToNearest {status} {data!r}, "
                  f"expected {want_d}")
        out["queries"] = {"n": len(queries), "requests": 2 * len(queries),
                          "seconds": time.perf_counter() - t0}
        adds = [",".join(f"{v:.4f}" for v in p) for p in queries[:HTTP_KMEANS_ADDS]]
        start = broker.size(input_topic)
        status, _, data = client.request("POST", "/add",
                                         body="\n".join(adds).encode())
        check(status == 204, f"kmeans serving_http: POST /add {status} {data!r}")
        landed = [km.message for km in broker.read(input_topic, start, 2 * len(adds))]
        check(landed == adds, f"kmeans serving_http: {len(landed)} of {len(adds)} "
              "/add lines on the input topic")
        out["added"] = len(landed)
    finally:
        client.close()
        closed = close_layer(layer, port, "kmeans serving_http", threads)
    out.update(closed)
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"kmeans serving_http: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the deployment: the CLI's processes over tcp: ------------------------------


REPO_ROOT = Path(__file__).resolve().parent


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition as ``{name: {label string: value}}`` (the
    registry snapshot's shape; histograms as their ``_bucket`` / ``_sum`` /
    ``_count`` series)."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        name, _, labels = series.partition("{")
        out.setdefault(name, {})[labels[:-1] if labels else ""] = float(value)
    return out


def hocon(settings: dict) -> str:
    """``settings`` (dotted keys) as HOCON lines, each value as JSON."""
    return "".join(f"{key} = {json.dumps(value)}\n" for key, value in settings.items())


def bulk_load(root: Path, topic: str, lines, what: str = "deployment") -> None:
    """Write ``lines`` (keyless strings, or ``KeyMessage``s with their keys
    and headers) as the one-partition ``file:`` log of ``topic`` under
    ``root`` in one write, framed as ``FileBroker.append`` frames each
    record (checked on the first lines): a million appends, each opening
    and locking the log, would take about a minute."""
    messages = [km if isinstance(km, KeyMessage) else KeyMessage(None, km)
                for km in lines]
    broker = tp.FileBroker(str(root))
    broker.create_topic(topic)
    probe = tp.FileBroker(str(root / ".probe"))
    probe.create_topic(topic)
    for km in messages[:100]:
        probe.append(topic, km.key, km.message, km.headers)

    def record(km):
        out = {"k": km.key, "m": km.message}
        if km.headers:
            out["h"] = km.headers
        return out

    def frames(chunk):
        return b"".join(tp.frame_record(json.dumps(
            record(km), separators=(",", ":")).encode("utf-8")) for km in chunk)

    check(frames(messages[:100]) == probe._log_path(topic, 0).read_bytes(),
          f"{what}: the bulk load's frames are not FileBroker.append's")
    with open(broker._log_path(topic, 0), "ab") as f:
        for j in range(0, len(messages), 100_000):
            f.write(frames(messages[j:j + 100_000]))
    check(broker.size(topic) == len(messages), f"{what}: the bulk-loaded log's size")


def child_env(overrides: dict) -> dict:
    """This process's environment with every ``ORYX_SANITIZE*`` variable
    replaced by ``overrides`` (a child then runs sanitized exactly as
    asked, whatever this process was started with)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ORYX_SANITIZE")}
    env.update(overrides)
    return env


class _Process:
    """One CLI process, sanitized (``DEPLOY_SANITIZE_ENV``): its ``Popen``,
    its name as a tier (for ``wait_until``'s ``layers``) and its output
    file, which ends with its sanitizer report once it exits."""

    def __init__(self, name: str, argv: list, log: Path):
        self.tier = name
        self.log = log
        self.done = False  # asked to stop: its exit is no failure
        with open(log, "wb") as out:
            self.popen = subprocess.Popen(
                [sys.executable, "-m", "oryx_tpu_torch.cli", *argv],
                stdout=out, stderr=subprocess.STDOUT, cwd=REPO_ROOT,
                # faulthandler: a process that dies of a signal writes every
                # thread's stack to its log before it goes
                env={**child_env(DEPLOY_SANITIZE_ENV), "PYTHONFAULTHANDLER": "1"})

    @property
    def stopped(self) -> bool:
        return not self.done and self.popen.poll() is not None

    def tail(self, n: int = 40) -> str:
        try:
            return "\n".join(self.log.read_text(errors="replace").splitlines()[-n:])
        except OSError as e:
            return repr(e)


class Deployment:
    """The ALS lambda loop as a deployment runs it: a ``tcp:`` broker
    process, a batch and a speed process and ``replicas`` serving processes,
    each started through ``python -m oryx_tpu_torch.cli`` on one HOCON file
    (each replica's adds its HTTP port), all topics on the broker. In this
    process: a client of the broker, a producer on the input topic and an
    ``ALSServingModelManager`` on ``local_device`` (None: the card)
    consuming the update topic from ``earliest`` on its own thread, which
    records when each message lands (``landed``) and when it is applied
    (``applied``). The processes run sanitized, each printing its report
    at exit (:meth:`sanitizer_reports`). The tests drive it on the CPU at a
    small size."""

    def __init__(self, tmp: str, overrides: dict, replicas: int, local_device=None):
        self.tmp = Path(tmp)
        self.port = ioutils.choose_free_port()
        self.url = f"tcp://127.0.0.1:{self.port}"
        self.topics_dir = self.tmp / "topics"
        self.dump_dir = self.tmp / "blackbox"
        self.settings = {
            "oryx.id": "deploy",
            "oryx.input-topic.broker": self.url,
            "oryx.update-topic.broker": self.url,
            "oryx.batch.update-class": "oryx_tpu_torch.models.als.update.ALSUpdate",
            "oryx.batch.storage.data-dir": f"{tmp}/data",
            "oryx.batch.storage.model-dir": f"{tmp}/model",
            "oryx.speed.model-manager-class":
                "oryx_tpu_torch.models.als.speed.ALSSpeedModelManager",
            "oryx.serving.model-manager-class":
                "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
            "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
            "oryx.serving.api.read-only": False,
            "oryx.serving.update-resume": "earliest",
            "oryx.ml.eval.test-fraction": TEST_FRACTION,
            "oryx.ml.eval.candidates": 1,
            "oryx.als.hyperparams.lambda": LAM,
            "oryx.als.hyperparams.features": FEATURES,
            "oryx.als.hyperparams.alpha": ALPHA,
            "oryx.als.iterations": ITERATIONS,
            "oryx.batch.streaming.generation-interval-sec": BATCH_INTERVAL_S,
            "oryx.speed.streaming.generation-interval-sec": SPEED_INTERVAL_S,
            # every process tags its bundles with oryx.id and keeps the
            # newest `keep` of that tag: keep them all
            "oryx.blackbox.dump-dir": str(self.dump_dir),
            "oryx.blackbox.keep": 1000,
            **overrides,
        }
        self.conf = oryx_config.overlay_on(self.settings, oryx_config.get_default())
        self.conf_path = self.tmp / "deployment.conf"
        self.conf_path.write_text(hocon(self.settings))
        self.replica_ports = [ioutils.choose_free_port() for _ in range(replicas)]
        self.input_topic = self.conf.get_string("oryx.input-topic.message.topic")
        self.update_topic = self.conf.get_string("oryx.update-topic.message.topic")
        oryx_id = self.conf.get_string("oryx.id")
        self.batch_group = f"OryxGroup-batch-{oryx_id}"
        self.speed_group = f"OryxGroup-speed-{oryx_id}"
        self.procs: dict = {}
        self.local = ALSServingModelManager(self.conf, device=local_device)
        self.applied = counting(self.local)
        self.landed: list = []
        self.local_error = None
        self._updates = None
        self._local_thread = None
        self.broker = None
        self.input = None

    # -- processes ----------------------------------------------------------------
    def spawn(self, name: str, *argv) -> _Process:
        proc = _Process(name, list(argv), self.tmp / f"{name}.log")
        self.procs[name] = proc
        return proc

    def start_broker(self, timeout: float = 120) -> float:
        """The broker process on the topic directory, then ``topic-setup``;
        returns the seconds until the broker answered a ``ping``."""
        t0 = time.perf_counter()
        self.spawn("broker", "broker", "--port", str(self.port), "--dir",
                   str(self.topics_dir), "--host", "127.0.0.1")
        self.broker = tp.get_broker(self.url)

        def answers():
            try:
                return self.broker.ping()["dir"] == str(self.topics_dir)
            except OSError:
                return False

        wait_until(answers, timeout, "deployment: the broker answers",
                   layers=self.procs.values(), poll=0.05)
        up_s = time.perf_counter() - t0
        setup = subprocess.run(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "topic-setup", "--conf",
             str(self.conf_path)], cwd=REPO_ROOT, capture_output=True, text=True,
            timeout=timeout)
        check(setup.returncode == 0 and "update: created topic" in setup.stdout,
              f"deployment: topic-setup: {setup.returncode} {setup.stdout!r} "
              f"{setup.stderr[-2000:]!r}")
        self.input = tp.TopicProducerImpl(self.url, self.input_topic)
        return up_s

    def start_tier(self, tier: str) -> _Process:
        return self.spawn(tier, tier, "--conf", str(self.conf_path))

    def start_replicas(self) -> list:
        out = []
        for r, port in enumerate(self.replica_ports):
            path = self.tmp / f"serving-{r}.conf"
            path.write_text(hocon({**self.settings, "oryx.serving.api.port": port}))
            out.append(self.spawn(f"serving-{r}", "serving", "--conf", str(path)))
        return out

    def start_local(self) -> None:
        """This process's manager on the update topic, from ``earliest``."""
        self._updates = tp.ConsumeDataIterator(self.broker, self.update_topic, "earliest")

        def landing():
            for km in self._updates:
                self.landed.append((time.perf_counter(), km.key, (km.headers or {})
                                    .get(lineage.WATERMARK_HEADER)))
                yield km

        def consume():
            try:
                self.local.consume(landing())
            except Exception as e:  # noqa: BLE001 — failed by the waits
                self.local_error = e

        self._local_thread = threading.Thread(target=consume, name="DeployLocalManager",
                                              daemon=True)
        self._local_thread.start()

    def terminate(self, name: str, timeout: float = 30) -> dict:
        """SIGTERM one process: it must exit 0 within ``timeout`` seconds."""
        proc = self.procs[name]
        check(proc.popen.poll() is None, f"deployment: {name} exited early "
              f"({proc.popen.returncode})")
        proc.done = True
        t0 = time.perf_counter()
        proc.popen.terminate()
        try:
            rc = proc.popen.wait(timeout)
        except subprocess.TimeoutExpired:
            rc = None
        exit_s = time.perf_counter() - t0
        check(rc == 0, f"deployment: {name} exited {rc} after SIGTERM "
              f"(in {exit_s:.1f} s)")
        return {"exit_s": exit_s, "rc": rc}

    def sigterm_bundle(self, seen: set) -> dict:
        """The one bundle a SIGTERM dumped since ``seen`` (file names)."""
        new = sorted(p for p in self.dump_dir.glob("*-sigterm.json") if p.name not in seen)
        check(len(new) == 1, f"deployment: {len(new)} new SIGTERM bundles")
        seen.add(new[0].name)
        return json.loads(new[0].read_text())

    def close(self) -> None:
        """Kill whatever still runs and stop the local consumer."""
        for proc in self.procs.values():
            if not proc.stopped:
                proc.popen.kill()
                proc.popen.wait(10)
        if self._updates is not None:
            self._updates.close()
            self._local_thread.join(10)
        if self.input is not None:
            self.input.close()

    def tails(self) -> str:
        """Each process's last lines; those that exited other than 0 come
        last and longer, so that the end of a failed run's output shows why."""
        procs = sorted(self.procs.items(),
                       key=lambda kv: kv[1].popen.poll() not in (0, None))
        out = []
        for name, p in procs:
            n = 40 if p.popen.poll() in (0, None) else 200
            out.append(f"--- {name} (exit {p.popen.poll()}), last {n} lines:\n{p.tail(n)}")
        return "\n".join(out)

    def sanitizer_reports(self) -> dict:
        """Each process's sanitizer exit report, parsed from its output
        (:func:`sanitizer_report`); read after the processes exited."""
        return {name: sanitizer_report(p.log.read_text(errors="replace"))
                for name, p in self.procs.items()}

    # -- reads --------------------------------------------------------------------
    def update_size(self) -> int:
        return self.broker.size(self.update_topic)

    def metrics(self, r: int) -> dict:
        with contextlib.closing(HttpClient(self.replica_ports[r], timeout=30)) as c:
            status, _, data = c.request("GET", "/metrics")
        check(status == 200, f"deployment: serving-{r} /metrics {status}")
        return parse_prometheus(data.decode())

    def replica_consumed(self, r: int) -> int:
        try:
            m = self.metrics(r)
        except (OSError, http.client.HTTPException):
            return -1
        return int(m.get("oryx_serving_updates_consumed_total", {}).get("", 0))

    def wait_offset(self, group: str, offset: int, timeout: float, what: str) -> float:
        # every poll is an RPC on the broker the tiers are using: 0.1 s
        return wait_until(lambda: self.broker.get_offset(group, self.input_topic) == offset,
                          timeout, what, layers=self.procs.values(), poll=0.1)

    def wait_local(self, n: int, timeout: float, what: str) -> float:
        """Wait until this process's manager has applied ``n`` messages;
        returns the perf_counter time it applied the n-th."""
        wait_until(lambda: len(self.applied) >= n or self.local_error is not None,
                   timeout, what, layers=self.procs.values())
        check(self.local_error is None,
              f"{what}: the local consumer failed: {self.local_error!r}")
        check(len(self.applied) == n, f"{what}: {len(self.applied)} applied, expected {n}")
        return self.applied[n - 1]

    def wait_replicas(self, n: int, timeout: float, what: str) -> list:
        """Wait until every replica has consumed ``n`` update messages (its
        ``oryx_serving_updates_consumed_total``, read every 50 ms; the
        consumer takes a message only after applying the one before, so
        this is the n-th handed to its manager); returns, per replica, the
        perf_counter time it was first seen there."""
        seen: dict = {}

        def all_there():
            for r in range(len(self.replica_ports)):
                if r not in seen and self.replica_consumed(r) >= n:
                    seen[r] = time.perf_counter()
            return len(seen) == len(self.replica_ports)

        wait_until(all_there, timeout, what, layers=self.procs.values(), poll=0.05)
        for r in range(len(self.replica_ports)):
            got = self.replica_consumed(r)
            check(got == n, f"{what}: serving-{r} consumed {got}, expected {n}")
        return [seen[r] for r in range(len(self.replica_ports))]

    def speed_ready(self, lines, timeout: float) -> int:
        """Send ``lines`` one at a time, each after the speed tier's
        generation of the one before committed, until a generation publishes
        an ``UP`` (its model is loaded); returns how many were sent."""
        end = self.broker.size(self.input_topic)
        for n, ln in enumerate(lines, 1):
            before = self.update_size()
            self.input.send(None, ln)
            end += 1
            self.wait_offset(self.speed_group, end, timeout,
                             "deployment: the speed tier's probe generation")
            if self.update_size() > before:
                return n
        raise SmokeFailure(f"deployment: the speed tier published nothing for "
                           f"{len(lines)} probe lines")


def _blocked_frame(stack: list) -> str:
    """The innermost ``File ..., line N, in fn`` of a formatted stack's
    lines, with its source line."""
    lines = [ln.strip() for ln in stack]
    for j in range(len(lines) - 1, -1, -1):
        if lines[j].startswith("File "):
            src = lines[j + 1] if j + 1 < len(lines) else ""
            return f"{lines[j]}: {src}" if src else lines[j]
    return ""


def sanitizer_report(text: str) -> dict:
    """The sanitizer's exit report (``sanitize.render_report``) in a
    process's output, parsed: ``report`` (the header was printed: the
    sanitizer is installed and found something), its ``modes``, the
    lock-order ``cycles`` (each ring with the first lines of its stacks),
    the ``stalls`` (count, the longest, each one's milliseconds, callback,
    thread and blocked frame) and the ``long_holds`` (count, which the
    sanitizer caps at 64 a process, the longest and its site, and the
    count by site)."""
    out: dict = {"report": False, "modes": None, "cycles": [],
                 "stalls": {"count": 0, "longest_ms": None, "each": []},
                 "long_holds": {"count": 0, "longest_ms": None, "longest_site": None,
                                "by_site": {}}}
    block = None  # the indented lines under the last cycle or stall
    for line in text.splitlines():
        if line.startswith("oryx sanitizer report (modes: "):
            out["report"] = True
            out["modes"] = line[len("oryx sanitizer report (modes: "):].rstrip(")")
            block = None
        elif line.startswith("LOCK-ORDER CYCLE: "):
            block = []
            out["cycles"].append({"ring": line[len("LOCK-ORDER CYCLE: "):],
                                  "lines": block})
        elif line.startswith("LOOP STALL: "):
            ms, _, rest = line[len("LOOP STALL: "):].partition(" ms in ")
            callback, _, thread = rest.rpartition(" on ")
            block = []
            out["stalls"]["each"].append({"ms": float(ms), "callback": callback,
                                          "thread": thread, "stack": block})
        elif line.startswith("LONG HOLD: "):
            block = None
            site, _, rest = line[len("LONG HOLD: "):].partition(" held ")
            ms = float(rest.partition(" ms on ")[0])
            holds = out["long_holds"]
            holds["count"] += 1
            holds["by_site"][site] = holds["by_site"].get(site, 0) + 1
            if holds["longest_ms"] is None or ms > holds["longest_ms"]:
                holds["longest_ms"], holds["longest_site"] = ms, site
        elif block is not None and line.startswith("  "):
            block.append(line)
        else:
            block = None
    for cyc in out["cycles"]:
        cyc["lines"] = cyc["lines"][:12]
    stalls = out["stalls"]
    for st in stalls["each"]:
        st["blocked_at"] = _blocked_frame(st.pop("stack"))
    stalls["count"] = len(stalls["each"])
    if stalls["each"]:
        stalls["longest_ms"] = max(st["ms"] for st in stalls["each"])
    return out


def publish_us(landed, start: int, end: int) -> dict:
    """Microseconds a message between landings on the update topic, over
    ``landed[start:end]``, taken within each publisher's run (the messages
    that share a watermark header: one speed generation each; a batch
    generation's stream carries none): summed spans over summed gaps."""
    runs: dict = {}
    for t, _, watermark in landed[start:end]:
        runs.setdefault(watermark, []).append(t)
    span = sum(ts[-1] - ts[0] for ts in runs.values())
    gaps = sum(len(ts) - 1 for ts in runs.values())
    return {"messages": end - start, "runs": len(runs),
            "us_per_message": span / gaps * 1e6 if gaps else None}


def broker_ops(text: str) -> dict:
    """Per RPC op, from the broker process's registry (its ``metrics``
    RPC): the RPCs it handled and their mean server-side milliseconds
    (frame decoded to response written)."""
    m = parse_prometheus(text)
    sums = m.get("oryx_netbroker_rpc_latency_seconds_sum", {})
    return {labels[len('op="'):-1]: {"rpcs": int(n), "mean_ms": sums[labels] / n * 1e3}
            for labels, n in m.get("oryx_netbroker_rpc_latency_seconds_count", {}).items()
            if n}


def read_range(broker, topic: str, start: int, end: int) -> list:
    """Every message of ``topic`` in ``[start, end)``, over as many reads as
    the broker pages them into."""
    out: list = []
    while start + len(out) < end:
        page = broker.read(topic, start + len(out), end - start - len(out))
        check(page, f"deployment: an empty read of {topic} at {start + len(out)}")
        out.extend(page)
    return out


def bundle_failures(bundle: dict) -> dict:
    """The failure counters a tier's flight-recorder bundle holds above 0."""
    return {f"{name}{{{labels}}}": value for name in FAILURE_COUNTERS
            for labels, value in bundle["metrics"].get(name, {}).items() if value}


def replica_requests(port: int) -> tuple:
    """(requests outside the ops routes, ``/metrics/history`` requests) on
    the replica's own ``/metrics``; answers the client cancelled are left
    out, as the fleet console leaves them out."""
    with contextlib.closing(HttpClient(port)) as client:
        status, _, text = client.request("GET", "/metrics")
    check(status == 200, f"GET /metrics on {port}: {status}")
    total = history = 0.0
    for name, key, value in trace_summary.parse_metrics_text(text.decode())[1]:
        labels = dict(key)
        if name != "oryx_serving_requests_total" or labels.get("status") == "cancelled":
            continue
        route = labels.get("route", "")
        history += value if route == "/metrics/history" else 0.0
        total += 0.0 if slo.is_ops_route(route) else value
    return total, history


def fleet_status_check(ports, what: str) -> dict:
    """``python -m oryx_tpu_torch.cli fleet-status`` once, as JSON, against
    the serving replicas on ``ports``: it must exit 0 and see every replica
    up, and each replica's request total outside the ops routes
    (``slo.is_ops_route``) must equal the same sum over that replica's own
    ``/metrics``, read just after, less the console's own
    ``/metrics/history`` request (a route ``is_ops_route`` does not exempt),
    which it sends after reading ``/metrics``: exactly one per replica,
    counted from reads of ``/metrics`` before and after. Then the
    ``--format table`` output is printed as it is."""
    replicas = ",".join(f"127.0.0.1:{p}" for p in ports)

    def fleet_status(fmt: str) -> str:
        done = subprocess.run(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "fleet-status",
             "--replicas", replicas, "--format", fmt],
            capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
        check(done.returncode == 0, f"{what}: fleet-status --format {fmt} "
              f"exited {done.returncode}: {done.stderr[-2000:]}")
        return done.stdout

    before = {port: replica_requests(port) for port in ports}
    t0 = time.perf_counter()
    snap = json.loads(fleet_status("json"))
    json_s = time.perf_counter() - t0
    rows = {row["replica"]: row for row in snap["table"]}
    out: dict = {"json_s": json_s, "replicas": {}}
    for port in ports:
        row = rows.get(f"127.0.0.1:{port}", {})
        check(row.get("up") is True, f"{what}: fleet-status sees 127.0.0.1:{port} "
              f"down: {row.get('error')}")
        own, history = replica_requests(port)
        scrape_history = history - before[port][1]
        check(scrape_history == 1, f"{what}: {scrape_history} /metrics/history "
              f"requests on {port} during one fleet-status")
        check(row["requests_total"] == own - scrape_history,
              f"{what}: fleet-status counts {row['requests_total']} requests on "
              f"{port}, its /metrics {own} (one of them the console's own "
              "/metrics/history)")
        out["replicas"][str(port)] = {"ready": row["ready"],
                                      "requests_total": row["requests_total"],
                                      "own_metrics_after": own}
    fleet = rows["FLEET"]
    check(fleet["n_up"] == len(ports), f"{what}: fleet-status FLEET row {fleet}")
    out["fleet_requests_total"] = fleet["requests_total"]
    print(fleet_status("table"), end="", flush=True)
    return out


def deployment_run(dep: Deployment, lines, rng, timeout: float = 600) -> dict:
    """The phase's body on a ``Deployment`` with nothing started yet; every
    wait fails after ``timeout`` seconds (the batch generation's, 1.5 x)."""
    n = len(lines)
    n_train = int(round(n * (1.0 - TEST_FRACTION)))
    held_out = lines[n_train:]
    out: dict = {"lines": n, "replicas": len(dep.replica_ports)}
    t0 = time.perf_counter()
    bulk_load(dep.topics_dir, dep.input_topic, lines)
    # a layer without a stored offset starts at its input's end
    tp.FileBroker(str(dep.topics_dir)).set_offset(dep.batch_group, dep.input_topic, 0)
    out["bulk_load_s"] = time.perf_counter() - t0
    out["broker_up_s"] = dep.start_broker()
    dep.start_replicas()
    dep.start_tier("speed")
    dep.start_local()
    bundles: set = set()
    t_batch = time.perf_counter()
    dep.start_tier("batch")

    # the batch generation: it ends when the batch group's offset reaches
    # the input's end; the batch process is then stopped, so that no second
    # generation reads the microbatch below (as lambda_loop closes its layer)
    t_commit = dep.wait_offset(dep.batch_group, n, 1.5 * timeout,
                              "deployment: the batch generation")
    exits = {"batch": dep.terminate("batch")}
    batch_bundle = dep.sigterm_bundle(bundles)
    failures = {f"batch: {k}": v for k, v in bundle_failures(batch_bundle).items()}
    n_gen = dep.update_size()
    t_local = dep.wait_local(n_gen, timeout, "deployment: the local manager applies the generation")
    t_served = dep.wait_replicas(n_gen, timeout, "deployment: the replicas apply the generation")
    t_model, key, _ = dep.landed[0]
    check(key == "MODEL", f"deployment: the first update is {key}")
    first = read_range(dep.broker, dep.update_topic, 0, 1)[0]
    stamp = lineage.parse_stamp(first.headers)
    check(stamp is not None and stamp["offsets"] == {"0": n},
          f"deployment: the MODEL's stamp {stamp}")
    generation = stamp["generation"]
    calls = batch_bundle["metrics"].get("oryx_device_calls_total", {})
    out["launches"] = {
        "gather_gramian_accumulate": int(calls.get('program="gather_gramian_accumulate"', 0)),
        "spd_solve_batched": int(sum(v for k, v in calls.items()
                                     if k.startswith('program="spd_solve_batched.'))),
        "gather_gramian_accumulate.reduce":
            int(calls.get('program="gather_gramian_accumulate.reduce"', 0)),
        "by_program": calls}
    out["generation"] = {
        "generation_s": t_model - t_batch,
        "batch_step_s": batch_bundle["metrics"]["oryx_step_duration_seconds_sum"][
            'tier="batch",step="generation"'],
        "start_to_commit_s": t_commit - t_batch,
        "messages": n_gen, "generation_id": generation,
        "up_publish": publish_us(dep.landed, 0, n_gen),
        "local_applied_after_model_s": t_local - t_model,
        "publish_to_servable_s": [t - t_model for t in t_served]}

    # what the broker did for the generation's stream: appends, and the
    # consumers' long-polls and reads around them
    out["generation"]["broker_ops"] = broker_ops(dep.broker.server_metrics())

    # answers: the local manager's model on the 10% hold-out, then both
    # replicas against it
    model = dep.local.get_model()
    check(model.get_fraction_loaded() == 1.0, "deployment: the local model is not loaded")
    train = als_data.prepare(lines[:n_train], implicit=True)
    test = holdout_batch(held_out, train.users, train.items)
    x = torch.as_tensor(np.stack([model.get_user_vector(u)
                                  for u in train.users.index_to_id]), device=model.device)
    y = torch.as_tensor(np.stack([model.get_item_vector(i)
                                  for i in train.items.index_to_id]), device=model.device)
    auc = evaluate.area_under_curve(x, y, train, test, rng=np.random.default_rng(SEED + 3))
    out["auc"] = auc
    users = model.all_user_ids()
    sample = [users[j] for j in rng.choice(len(users), min(HTTP_USERS, len(users)),
                                           replace=False)]
    replicas = []
    for r, port in enumerate(dep.replica_ports):
        client = HttpClient(port)
        try:
            status, _, data = client.request("GET", "/readyz")
            readyz = json.loads(data)
            check(status == 200 and readyz["model"] == "loaded",
                  f"deployment: serving-{r} /readyz {status} {readyz}")
            t0 = time.perf_counter()
            ties: list = []
            requests = check_recommend(client, model, sample, generation,
                                       f"deployment serving-{r}", ties)
            replicas.append({"recommend_checked": requests,
                             "seconds": time.perf_counter() - t0,
                             "ties_at_cut": ties})
        finally:
            client.close()
        info = dep.metrics(r).get("oryx_build_info", {})
        replicas[-1]["build_info"] = [k for k, v in info.items() if v == 1.0]
    out["answers"] = replicas

    # one microbatch over the wire, once the speed tier has its model
    n_probe = dep.speed_ready(held_out[:DEPLOY_PROBE_LINES], timeout)
    mb_lines = held_out[n_probe:n_probe + DEPLOY_MICROBATCH]
    n0 = dep.update_size()
    dep.wait_local(n0, timeout, "deployment: the local manager applies the probe's UPs")
    dep.wait_replicas(n0, timeout, "deployment: the replicas apply the probe's UPs")
    input_end = dep.broker.size(dep.input_topic) + len(mb_lines)
    t_first = time.perf_counter()
    for ln in mb_lines:
        dep.input.send(None, ln)
    t_last = time.perf_counter()
    dep.wait_offset(dep.speed_group, input_end, timeout,
                    "deployment: the speed generations of the microbatch")
    n1 = dep.update_size()
    t_served = dep.wait_replicas(n1, timeout, "deployment: the replicas apply the microbatch")
    dep.wait_local(n1, timeout, "deployment: the local manager applies the microbatch")
    ups = read_range(dep.broker, dep.update_topic, n0, n1)
    check(ups and {km.key for km in ups} == {"UP"},
          f"deployment: {len(ups)} messages of the microbatch, keys "
          f"{ {km.key for km in ups} }")
    touched = sorted({json.loads(km.message)[1] for km in ups
                      if km.message.startswith('["X"')})
    touched = [touched[j] for j in rng.choice(len(touched), min(HTTP_TOUCHED, len(touched)),
                                              replace=False)]
    for r, port in enumerate(dep.replica_ports):
        with contextlib.closing(HttpClient(port)) as client:
            check_recommend(client, model, touched, generation,
                            f"deployment serving-{r} touched")
    publish = publish_us(dep.landed, n0, n1)
    out["microbatch"] = {
        "lines": len(mb_lines), "probe_lines": n_probe, "ups": n1 - n0,
        "produce_us": (t_last - t_first) / len(mb_lines) * 1e6,
        "ticks": publish["runs"], "up_publish_us": publish["us_per_message"],
        "append_to_servable_s": [t - t_last for t in t_served],
        "touched_checked": len(touched)}

    out["broker_ops"] = broker_ops(dep.broker.server_metrics())
    out["fleet_status"] = fleet_status_check(dep.replica_ports, "deployment")

    # shutdown: each tier, then the broker; no tier may count a failure
    for name in [f"serving-{r}" for r in range(len(dep.replica_ports))] + ["speed"]:
        exits[name] = dep.terminate(name)
        failures.update({f"{name}: {k}": v
                         for k, v in bundle_failures(dep.sigterm_bundle(bundles)).items()})
    exits["broker"] = dep.terminate("broker")
    check(not failures, f"deployment: failures counted: {failures}")
    out["exits"] = exits
    out["failures"] = failures
    return out


def sanitizer_summary(reports: dict, what: str) -> dict:
    """The sanitized processes' exit reports (``Deployment.sanitizer_reports``)
    in brief: per process its modes, cycles, stalls (count, the longest,
    the ten longest with their blocked frames) and long holds (count, the
    longest and its site, the five sites with the most of them); the
    processes that printed no report, and those that report no long hold.
    Fails on any lock-order cycle, after printing each one."""
    per: dict = {}
    cycles = {}
    for name, rep in reports.items():
        stalls = rep["stalls"]
        holds = rep["long_holds"]
        per[name] = {
            "modes": rep["modes"], "cycles": len(rep["cycles"]),
            "stalls": {"count": stalls["count"], "longest_ms": stalls["longest_ms"],
                       "longest": sorted(stalls["each"], key=lambda st: -st["ms"])[:10]},
            "long_holds": {"count": holds["count"], "longest_ms": holds["longest_ms"],
                           "longest_site": holds["longest_site"],
                           "top_sites": dict(sorted(holds["by_site"].items(),
                                                    key=lambda kv: -kv[1])[:5])}}
        if rep["cycles"]:
            cycles[name] = rep["cycles"]
    for name, found in cycles.items():
        for cyc in found:
            print(f"{what}: {name}: LOCK-ORDER CYCLE: {cyc['ring']}\n"
                  + "\n".join(cyc["lines"]), file=sys.stderr, flush=True)
    check(not cycles, f"{what}: lock-order cycles in "
          f"{ {name: len(found) for name, found in cycles.items()} }")
    return {"processes": per,
            "stalls": sum(p["stalls"]["count"] for p in per.values()),
            "no_report": sorted(n for n, rep in reports.items() if not rep["report"]),
            "no_long_holds": sorted(n for n, rep in reports.items()
                                    if not rep["long_holds"]["count"])}


def sanitize_phase(device: str = "cuda", timeout: float = 300) -> dict:
    """The port's sanitizer in a child interpreter (see the module
    docstring): ``tests/torch_sanitize_child.py probe`` under
    ``ORYX_SANITIZE=locks,loop``; (a) and (b) are checked, (c) the
    overhead is reported."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, str(SANITIZE_CHILD), "probe", "--device", device],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env=child_env(SANITIZE_ENV))
    child_s = time.perf_counter() - t0
    check(done.returncode == 0, f"sanitize: the child exited {done.returncode}: "
          f"{done.stderr[-3000:]}")
    out = json.loads(done.stdout.strip().splitlines()[-1])
    install = out["install"]
    check(install == {"modes": ["locks", "loop"], "lock": "port", "rlock": "port",
                      "handle_run": "oryx_tpu_torch.tools.sanitize.loop",
                      "lock_type": "SanLock"},
          f"sanitize: the child's install did not take: {install}")
    iso = out["isolated"]
    cycles, stalls = iso["cycles"], iso["stalls"]
    check(len(cycles) == 1 and cycles[0]["edges"] == 2 and cycles[0]["stacks"] == 2
          and all("torch_sanitize_child.py" in site for site in cycles[0]["ring"]),
          f"sanitize: the inversion gave {cycles}, not one cycle with both stacks")
    for st in stalls:
        st["blocked_at"] = _blocked_frame(st.pop("stack").splitlines())
    check(len(stalls) == 1 and stalls[0]["stalled_ms"] >= iso["stall_threshold_ms"]
          and "time.sleep" in stalls[0]["blocked_at"],
          f"sanitize: the 400 ms callback gave {stalls}, not one stall with its "
          "live stack")
    check(iso["rendered"] == {"cycles": 1, "stalls": 1, "blocked_at": 1},
          f"sanitize: the rendered report holds {iso['rendered']}")
    # the isolated window keeps the deliberate cycle and stall out of the
    # child's own report, printed at its exit
    own = sanitizer_report(done.stderr)
    check(not own["cycles"] and not own["stalls"]["count"],
          f"sanitize: the child's exit report holds {len(own['cycles'])} cycles, "
          f"{own['stalls']['count']} stalls")
    out["child_exit_report"] = {"report": own["report"],
                                "long_holds": own["long_holds"]["count"]}
    out["child_s"] = child_s
    # this process's own sanitizer modes: none unless ORYX_SANITIZE was set
    out["this_process_modes"] = sorted(port_sanitize.modes())
    out["seconds"] = time.perf_counter() - t0
    return out


def deployment_phase(lines, rng, in_process: dict) -> dict:
    """The ALS loop as a deployment (see the module docstring): five
    sanitized processes through the port's CLI over ``tcp:``, checked
    against a manager in this process; beside it the in-process loop's
    figures from this run (``in_process``: the ``lambda_loop`` line's
    ``speed``)."""
    K.reset_launches()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="oryx-deploy-") as tmp:
        dep = Deployment(tmp, {}, DEPLOY_REPLICAS)
        try:
            out = deployment_run(dep, lines, rng)
        except BaseException:
            print(dep.tails(), file=sys.stderr, flush=True)
            raise
        finally:
            dep.close()
        reports = dep.sanitizer_reports()
        # a thread that outlived its join at close is logged with its stack
        # (serving/app.py); the count per process is reported, not gated
        out["threads_left_at_close"] = {
            name: p.log.read_text(errors="replace").count("did not stop within")
            for name, p in dep.procs.items()}
        out["sanitized"] = {"env": DEPLOY_SANITIZE_ENV, "loop_stall_ms":
                            dep.conf.get_float("oryx.sanitize.loop-stall-ms")}
    out["sanitizer"] = sanitizer_summary(reports, "deployment")
    check(not any(K.LAUNCHES.values()),
          f"deployment: kernels launched in this process: {K.LAUNCHES}")
    check(out["auc"] > 0.75, f"deployment: hold-out AUC {out['auc']} <= 0.75")
    for r in out["answers"]:
        check(any('backend="cuda"' in k for k in r["build_info"]),
              f"deployment: a replica serves from {r['build_info']}")
    out["in_process"] = [{
        "up_publish_us_per_send": mb["pump"]["up_publish_s"] / mb["ups"] * 1e6,
        "append_to_servable_s": mb["append_to_servable_s"]}
        for mb in in_process["microbatches"]]
    out["reduced"] = {
        "users": f"the lines of the first {LOOP_USERS} of {N_USERS} users, as "
                 "lambda_loop's (one RPC a published UP)",
        "microbatch_lines": f"{DEPLOY_MICROBATCH} over tcp, cut from lambda_loop's "
                            f"2 x {SPEED_MICROBATCH} for the per-send cost",
        "input": "bulk-loaded into the file: log before the broker starts, "
                 "not sent over tcp"}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- k-means --------------------------------------------------------------------


def sweep_check(points, weights, centers, near_ties: bool, label: str) -> dict:
    """The Lloyd-sweep kernel against its plain version on the same card
    tensors. Tolerances, with their reasons:

    * cost: 1e-5 relative — float32 sums of the same d² in another order
      (a near tie changes a point's d² only by a rounding);
    * counts: when the centres are well separated, the same nearest centre
      for every point — unit-weight counts equal, weighted counts to 1e-6
      relative (float32 sums in another order); with near ties
      (standard-normal points: a few lie within float32 rounding of two
      centres, and the two versions round the cross term differently) an
      L1 difference of at most 1e-3·N; either way they sum to Σw;
    * sums: 1e-4 of the largest |sum|, on the clusters whose counts agree
      — float32 sums of the same w·p terms in another order."""
    sums, counts, cost = K.kmeans_assign_accumulate(points, weights, centers)
    p_sums, p_counts, p_cost = K.kmeans_assign_accumulate_plain(
        points, weights, centers)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sums).all()) and bool(torch.isfinite(cost)),
          f"kmeans {label}: non-finite output")
    cost_rel = abs(float(cost) - float(p_cost)) / abs(float(p_cost))
    check(cost_rel <= 1e-5, f"kmeans {label}: cost rel err {cost_rel} > 1e-5")
    total = float(weights.double().sum())
    check(abs(float(counts.double().sum()) - total) <= 1e-6 * total,
          f"kmeans {label}: counts sum to {float(counts.sum())}, not {total}")
    count_l1 = float((counts.double() - p_counts.double()).abs().sum())
    same = counts == p_counts
    if near_ties:
        check(count_l1 <= 1e-3 * points.shape[0],
              f"kmeans {label}: count L1 difference {count_l1}")
    else:
        same[:] = True
        check(bool(torch.allclose(counts, p_counts, rtol=1e-6, atol=0.0)),
              f"kmeans {label}: weighted counts differ ({count_l1})")
        ones = torch.ones_like(weights)
        check(torch.equal(
            K.kmeans_assign_accumulate(points, ones, centers)[1],
            K.kmeans_assign_accumulate_plain(points, ones, centers)[1]),
            f"kmeans {label}: the nearest centres differ")
    diff = (sums.double() - p_sums.double())[same].abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = abs_err / float(p_sums.abs().max())
    check(rel_err <= 1e-4, f"kmeans {label}: sums rel err {rel_err} > 1e-4")
    return {"label": label, "n": points.shape[0], "d": points.shape[1],
            "k": centers.shape[0], "cost_rel_err": cost_rel,
            "count_l1": count_l1, "clusters_compared": int(same.sum()),
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def blob_means(rng: np.random.Generator) -> np.ndarray:
    return rng.uniform(-10.0, 10.0, (KM_K, KM_D)).astype(np.float32)


def blob_points(rng: np.random.Generator, means: np.ndarray, n: int):
    labels = rng.integers(0, len(means), n)
    return (means[labels]
            + rng.standard_normal((n, means.shape[1]), dtype=np.float32))


def sweep_bare_launch(points, weights, centers):
    """A no-argument launch of ``oryx_kmeans_assign`` (all three launches)
    on the wrapper's arguments and plan, into preallocated scratch and
    output, with the pointers taken once: the sweep timed apart from the
    wrapper's host cost, as the other kernels are."""
    n, d = points.shape
    k = centers.shape[0]
    plan = K.kmeans_sweep_plan(n, k, d)
    dev = points.device
    assign = torch.empty(n, device=dev, dtype=torch.int32)
    min_d2 = torch.empty(n, device=dev)
    ws = torch.empty((plan.parts, plan.slab_floats), device=dev)
    out = torch.empty(plan.slab_floats, device=dev)
    fn = K._entry("kmeans_assign", "oryx_kmeans_assign")
    cargs = K.kmeans_sweep_args(points, weights, centers, plan, assign, min_d2,
                                ws, out, torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*cargs)
        check(err == 0, f"oryx_kmeans_assign: CUDA error {err}")
        return out

    return launch


SWEEP_LAUNCHES = ("assign_kernel", "partial_kernel", "reduce_kernel")


def sweep_profile(prof: dict, label: str) -> dict:
    """One sweep's window of ``device_profiles``; fails unless it lists each
    of the sweep's three launches once."""
    launches = prof.get("kernel_launches", {})
    for kernel in SWEEP_LAUNCHES:
        seen = sum(c for name, c in launches.items() if name.startswith(kernel))
        check(seen == 1, f"kmeans {label}: the profile lists {seen} "
              f"{kernel} launches, not 1: {launches}")
    return prof


def sweep_timing(points, weights, centers, label: str) -> dict:
    """The sweep timed by bare launches of its C entry (20 per CUDA-event
    pair) and through the wrapper (one call per pair), beside its plain
    version, the cross term's ``torch.matmul`` (TF32 off) and the card's
    bound for (N, D, K). ``device_profiles`` profiles it later."""
    n, d = points.shape
    k = centers.shape[0]
    args = (points, weights, centers)
    launch = sweep_bare_launch(*args)
    bare = launch().clone()
    sums, counts, cost = K.kmeans_assign_accumulate(*args)
    torch.cuda.synchronize()
    check(torch.equal(bare, torch.cat([sums.flatten(), counts, cost[None]])),
          f"kmeans {label}: the bare launch differs from the wrapper")
    nbytes = (n * d + n + k * d  # points, weights, centres
              + k * d + k + 1) * 4  # sums, counts, cost written
    flops = 2.0 * n * k * d + 2.0 * n * d
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return {
        "kernel_ms": time_ms(launch, inner=INNER),
        "wrapper_ms": time_ms(lambda: K.kmeans_assign_accumulate(*args)),
        "plain_ms": time_ms(lambda: K.kmeans_assign_accumulate_plain(*args),
                            reps=5, warmup=1),
        "cross_term_matmul_ms": time_ms(lambda: points @ centers.T),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def sweep_entry(label, case, timing) -> dict:
    """A kernels-line entry for the sweep at one shape."""
    n, d, k = case["n"], case["d"], case["k"]
    plan = K.kmeans_sweep_plan(n, k, d)
    return {
        "name": f"kmeans_assign_accumulate[{label}]",
        "route": "cuda", "source": KM_SOURCE, "replaces": KM_REPLACES,
        "launch_key": launch_key("kmeans_assign_accumulate", (n, d, k)),
        "shape": {"n": n, "d": d, "k": k, "dtype": "float32"},
        "plan": {"tiles": plan.tiles, "assign_ctas": plan.assign_ctas,
                 "stages": plan.stages,
                 "parts": plan.parts, "walk_threads": plan.walk_threads,
                 "walk_groups": plan.walk_groups,
                 "slab_in_smem": plan.slab_in_smem},
        "max_abs_err": case["max_abs_err"], "max_rel_err": case["max_rel_err"],
        "tol": 1e-4, "cost_rel_err": case["cost_rel_err"], "cost_tol": 1e-5,
        "count_l1": case["count_l1"],
        "ms": timing["kernel_ms"],
        **{key: v for key, v in timing.items() if key != "profile"},
        "library_ms": timing["cross_term_matmul_ms"],
        "library": "cross term only: points @ centers.T (torch.matmul, "
                   "TF32 off); no PyTorch call computes the sweep",
    }


def kmeans_kernel_phase(dev, rng):
    """The sweep kernel in its four cases; the 1M × 64 case and the update
    path's 100k × 64 case timed. Returns the phase's record, the
    kernels-line entries (100k, then 1M), the 1M × 64 points and the two
    timed cases' arguments by label, for ``device_profiles``."""
    pts = torch.from_numpy(
        rng.standard_normal((KM_N, KM_D), dtype=np.float32)).to(dev)
    ones = torch.ones(KM_N, device=dev)
    centers = torch.from_numpy(
        rng.standard_normal((KM_K, KM_D), dtype=np.float32)).to(dev)
    cases = [sweep_check(pts, ones, centers, True, "1M x 64, K=256, normal")]
    args = (pts, ones, centers)
    timing = sweep_timing(*args, "1M x 64")

    means = blob_means(rng)
    blobs = torch.from_numpy(blob_points(rng, means, KM_BLOB_POINTS)).to(dev)
    blob_centers = torch.from_numpy(means).to(dev)
    cases.append(sweep_check(blobs, torch.ones(KM_BLOB_POINTS, device=dev),
                             blob_centers, False, "200k planted blobs, K=256"))
    # the update path's shape: build_model's sweeps run on 100k lines
    update_args = (blobs[:KM_LINES].contiguous(),
                   torch.ones(KM_LINES, device=dev), blob_centers)
    cases.append(sweep_check(*update_args, False, "100k planted blobs, K=256"))
    update_timing = sweep_timing(*update_args, "100k x 64")
    wide_means = rng.uniform(-10.0, 10.0, (1024, 128)).astype(np.float32)
    wide = torch.from_numpy(blob_points(rng, wide_means, 50_000)).to(dev)
    wide_args = (wide, torch.ones(50_000, device=dev),
                 torch.from_numpy(wide_means).to(dev))
    cases.append(sweep_check(*wide_args, False, "50k blobs, K=1024, D=128"))
    wide_ms = time_ms(sweep_bare_launch(*wide_args), inner=INNER)
    entries = [sweep_entry("100k x 64, K=256, update", cases[2], update_timing),
               sweep_entry("1M x 64, K=256", cases[0], timing)]
    record = {"cases": cases, **timing, "update_shape": update_timing,
              "wide_kernel_ms": wide_ms}
    return record, entries, pts, {"1M x 64": args, "100k x 64": update_args}


def csv_lines(points: np.ndarray) -> list:
    return [",".join(f"{v:.6f}" for v in row) for row in points.tolist()]


def kmeans_update_phase(dev, rng) -> dict:
    """The k-means main path through its entry points (see the module
    docstring); returns the phase's record with the launch counts."""
    means = blob_means(rng)
    t0 = time.perf_counter()
    lines = csv_lines(blob_points(rng, means, KM_LINES))
    micro = csv_lines(blob_points(rng, means, KM_MICROBATCH))
    timing = {"make_lines_s": time.perf_counter() - t0}
    conf = oryx_config.overlay_on(
        {"oryx.input-schema.num-features": KM_D,
         "oryx.input-schema.categorical-features": [],
         "oryx.kmeans.hyperparams.k": KM_K},
        oryx_config.get_default())
    runs = conf.get_int("oryx.kmeans.runs")
    iterations = conf.get_int("oryx.kmeans.iterations")
    train = [KeyMessage(None, ln) for ln in lines]
    update = KMeansUpdate(conf)
    k = int(update.get_hyper_parameter_values()[0].get_trial_values(1)[0])
    strategies = ("SILHOUETTE", "DAVIES_BOULDIN", "DUNN", "SSE")
    scorers = {s: KMeansUpdate(conf.with_values(
        {"oryx.kmeans.evaluation-strategy": s})) for s in strategies}

    K.reset_launches()
    t0 = time.perf_counter()
    pmml = update.build_model(None, train, [k], None)
    torch.cuda.synchronize()
    timing["build_model_s"] = time.perf_counter() - t0
    scores = {}
    for strategy in strategies:
        t0 = time.perf_counter()
        scores[strategy] = scorers[strategy].evaluate(None, pmml, None, [], train)
        timing[f"evaluate_{strategy.lower()}_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    by_shape = shape_launches()

    expected = runs * (iterations + 1)
    check(launches["kmeans_assign_accumulate"] == expected,
          f"kmeans_update: {launches['kmeans_assign_accumulate']} sweep "
          f"launches, expected {expected} ({runs} runs x {iterations + 1})")
    clusters = pmml_codec.read(pmml)
    check(len(clusters) == KM_K, f"kmeans_update: {len(clusters)} clusters")
    check(sum(c.count for c in clusters) == KM_LINES,
          "kmeans_update: cluster sizes do not sum to the line count")
    check(-1.0 <= scores["SILHOUETTE"] <= 1.0,
          f"kmeans_update: silhouette {scores['SILHOUETTE']}")
    t0 = time.perf_counter()
    points = update._to_points(train)
    timing["parse_s"] = time.perf_counter() - t0
    published = np.stack([c.center for c in clusters])
    _, _, cost = K.kmeans_assign_accumulate(
        torch.from_numpy(points.astype(np.float32)).to(dev),
        torch.ones(len(points), device=dev),
        torch.from_numpy(published.astype(np.float32)).to(dev))
    sse_rel = abs(-scores["SSE"] - float(cost)) / float(cost)
    check(sse_rel <= 1e-4, f"kmeans_update: -SSE {scores['SSE']} vs the "
          f"sweep's cost {float(cost)}: rel {sse_rel} > 1e-4")

    # serving: MODEL, 1,000 nearest-cluster queries against a host assign
    text = pmmlutils.to_string(pmml)
    serving = KMeansServingModelManager(conf)
    t0 = time.perf_counter()
    serving.consume([KeyMessage("MODEL", text)])
    queries = points[:1000]
    answers = [serving.get_model().nearest_cluster(q) for q in queries]
    timing["serve_1000_s"] = time.perf_counter() - t0
    d2 = ((queries[:, None, :] - published[None, :, :]) ** 2).sum(axis=2)
    ids = [c.id for c in clusters]
    want = [ids[j] for j in d2.argmin(axis=1)]
    check([a[0] for a in answers] == want,
          "kmeans serve: nearest clusters differ from the host assign")
    dist = np.sqrt(d2.min(axis=1))
    check(np.allclose([a[1] for a in answers], dist, rtol=1e-9, atol=1e-9),
          "kmeans serve: distances differ from the host assign")

    # speed: fold a microbatch, apply its UP lines to the serving model
    speed = KMeansSpeedModelManager(conf)
    speed.consume([KeyMessage("MODEL", text)])
    t0 = time.perf_counter()
    ups = speed.build_updates([KeyMessage(None, ln) for ln in micro])
    timing["speed_build_updates_s"] = time.perf_counter() - t0
    serving.consume([KeyMessage("UP", u) for u in ups])
    by_id = {c.id: c for c in speed.model.clusters}
    served = serving.get_model().clusters
    check(len(ups) > 0 and all(
        c.count == by_id[c.id].count and np.array_equal(c.center, by_id[c.id].center)
        for c in served), "kmeans speed: serving does not hold the speed model")
    check(sum(c.count for c in served) == KM_LINES + KM_MICROBATCH,
          "kmeans speed: counts do not add up")
    generation = kmeans_generation(conf, train, runs * (iterations + 1))
    http = kmeans_http(conf, text, ups, points, serving, rng)
    return {"serving_http": http, "lines": KM_LINES, "features": KM_D, "k": k, "runs": runs,
            "iterations": iterations, "launches": launches,
            "shape_launches": by_shape,
            "scores": scores, "sse_vs_sweep_cost_rel": sse_rel,
            "updates": len(ups), "generation": generation, **timing}


def kmeans_generation(conf, lines, expected_sweeps: int) -> dict:
    """The same k-means path behind ``MLUpdate``: one ``run_update`` on the
    lines (one candidate, 10% held out), published to a recording producer
    and consumed by ``KMeansServingModelManager``, whose model must hold the
    promoted PMML's clusters."""
    update = KMeansUpdate(conf)
    producer = RecordingProducer()
    with tempfile.TemporaryDirectory(prefix="oryx-kmeans-generation-") as model_dir:
        K.reset_launches()
        with FirstLaunches([(K, "kmeans_assign_accumulate", sweep_key)]) as first:
            t0 = time.perf_counter()
            update.run_update(None, GENERATION_TIMESTAMP_MS, lines, [],
                              model_dir, producer)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        sweeps = K.LAUNCHES["kmeans_assign_accumulate"]
        counted = dict(K.SHAPE_LAUNCHES)
        check(sweeps == expected_sweeps, f"kmeans generation: {sweeps} sweep "
              f"launches, expected {expected_sweeps}")
        held = hold_path_launches(first, counted, "kmeans_generation")
        cands = update.report["candidates"]
        check(len(cands) == 1 and all("failed" not in c for c in cands.values()),
              f"kmeans generation: candidates {cands}")
        check([k for k, _, _ in producer.sent] == ["MODEL"],
              "kmeans generation: not one MODEL published")
        promoted = pmmlutils.read(
            Path(model_dir) / str(GENERATION_TIMESTAMP_MS) / "model.pmml")
    serving = KMeansServingModelManager(conf)
    serving.consume(KeyMessage(k, m) for k, m, _ in producer.sent)
    served = serving.get_model().clusters
    want = pmml_codec.read(promoted)
    check(len(served) == KM_K and [c.id for c in served] == [c.id for c in want]
          and all(np.array_equal(c.center, w.center) for c, w in zip(served, want)),
          "kmeans generation: the served clusters differ from the promoted PMML's")
    cand = next(iter(cands.values()))
    return {"run_update_s": run_s, "split_s": update.report["split_s"],
            "build_s": cand["build_s"], "evaluate_s": cand["evaluate_s"],
            "eval": cand["eval"], "publish_model_s": update.report["publish_model_s"],
            "model_bytes": len(producer.sent[0][1].encode("utf-8")),
            "clusters": len(served), "launches": sweeps,
            "held_against_plain": held}


def kmeans_train_phase(points) -> dict:
    """``kmeans_train`` at bench_batch.py's accelerator shape, twice."""
    out = {"n": KM_N, "d": KM_D, "k": KM_K, "iterations": KM_ITERATIONS,
           "runs": 1}
    for call in ("first", "timed"):
        K.reset_launches()
        timings: dict = {}
        t0 = time.perf_counter()
        centers, counts = kmtrain.kmeans_train(
            points, KM_K, iterations=KM_ITERATIONS, runs=1,
            generator=torch.Generator().manual_seed(SEED + 7), timings=timings)
        seconds = time.perf_counter() - t0
        launches = K.LAUNCHES["kmeans_assign_accumulate"]
        check(launches == KM_ITERATIONS + 1,
              f"kmeans_train: {launches} sweep launches")
        check(np.isfinite(centers).all() and counts.sum() == KM_N,
              "kmeans_train: bad centres or counts")
        out[call] = {"seconds": seconds, "launches": launches,
                     "shape_launches": shape_launches(), **timings}
    timed = out["timed"]
    out["point_iters_per_s"] = KM_N * KM_ITERATIONS / timed["seconds"]
    out["sweep_point_iters_per_s"] = KM_N * KM_ITERATIONS / timed["sweeps_s"]
    return out


# -- the static analyser ------------------------------------------------------

ANALYZE_KM_N, ANALYZE_TOPN_BATCH, ANALYZE_TOPN_HOW_MANY = 100_000, 256, 10
ANALYZE_TIMEOUT_S = 300
#: the text of torch's warning under ``set_sync_debug_mode("warn")``
SYNC_WARNING = "synchronizing CUDA operation"


def analyzer_run(timeout: float = ANALYZE_TIMEOUT_S) -> dict:
    """``python3 -m oryx_tpu_torch.cli analyze --format json`` on the
    checkout, in a child: it must exit 0 with zero unsuppressed findings.
    Returns the child's seconds, the suppressed counts by checker and the
    findings (reported and suppressed)."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "analyze", "--format", "json"],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env=child_env({}))
    seconds = time.perf_counter() - t0
    check(done.returncode == 0, f"analyze: the analyser exited "
          f"{done.returncode}: {done.stdout[-2000:]} {done.stderr[-2000:]}")
    report = json.loads(done.stdout)
    check(report["unsuppressed"] == 0 and not report["parse_errors"],
          f"analyze: {report['unsuppressed']} unsuppressed findings, parse "
          f"errors {report['parse_errors']}")
    by_checker: dict = {}
    for f in report["findings"]:
        if f["suppressed_by"]:
            by_checker[f["checker"]] = by_checker.get(f["checker"], 0) + 1
    return {"rc": done.returncode, "seconds": seconds, "unsuppressed": 0,
            "suppressed": report["suppressed"],
            "suppressed_by_checker": dict(sorted(by_checker.items())),
            "findings": report["findings"]}


#: The reference explorer's counts at the tier-1 depth (12, crash budget
#: 2), ``python -m oryx_tpu.cli analyze --protocol`` on the reference
#: package: (states, transitions). The port's explorer must equal them.
PROTOCOL_COUNTS = {"consumer-group": (118_213, 248_199),
                   "broker-append": (1_057, 1_143),
                   "ckpt-generation": (59, 100)}
PROTOCOL_DEPTH, PROTOCOL_CRASH_BUDGET = 12, 2
PROTOCOL_TIMEOUT_S = 600
#: The committed counterexample fixtures ``--schedule`` replays.
PROTOCOL_FIXTURES = os.path.join("tests", "data", "protocol_schedules")
#: ``analyze --cost``'s shapes: the b256 scan over the 1M x 50 flagship
#: (``_score(qs, mat)``), and ``y`` bound to the train phase's Y.
COST_SCAN_BATCH = 256


def analyze_child(args: "list[str]", timeout: float) -> "tuple[subprocess.CompletedProcess, float]":
    """``python3 -m oryx_tpu_torch.cli analyze <args>`` on the checkout in
    a child, with its seconds."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "analyze", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env=child_env({}))
    return done, time.perf_counter() - t0


def protocol_run(timeout: float = PROTOCOL_TIMEOUT_S) -> dict:
    """``analyze --protocol --format json``: every model explored clean
    and complete at the tier-1 depth with the reference's states and
    transitions (:data:`PROTOCOL_COUNTS`); then each fixture under
    :data:`PROTOCOL_FIXTURES` replayed with ``--schedule`` (its variant
    and, where the fixture says, HEAD), each exiting 0."""
    done, seconds = analyze_child(["--protocol", "--format", "json"], timeout)
    check(done.returncode == 0, f"analyze --protocol exited {done.returncode}: "
          f"{done.stdout[-2000:]} {done.stderr[-2000:]}")
    report = json.loads(done.stdout)
    check(report["ok"], f"analyze --protocol: not ok: {report}")
    models = {}
    for entry in report["protocol"]:
        name = entry["model"]
        got = (entry["states"], entry["transitions"])
        check(entry["ok"] and entry["complete"] and entry["variant"] is None
              and entry["depth"] == PROTOCOL_DEPTH
              and entry["crash_budget"] == PROTOCOL_CRASH_BUDGET,
              f"analyze --protocol {name}: {entry}")
        check(got == PROTOCOL_COUNTS.get(name),
              f"analyze --protocol {name}: {got[0]} states, {got[1]} "
              f"transitions; the reference explores {PROTOCOL_COUNTS.get(name)}")
        models[name] = {"states": got[0], "transitions": got[1],
                        "seconds": entry["elapsed_s"]}
    check(set(models) == set(PROTOCOL_COUNTS),
          f"analyze --protocol explored {sorted(models)}")
    replays = {}
    fixtures = sorted(f for f in os.listdir(os.path.join(REPO_ROOT, PROTOCOL_FIXTURES))
                      if f.endswith(".json"))
    check(len(fixtures) == 6, f"analyze --schedule: fixtures {fixtures}")
    for f in fixtures:
        rdone, rseconds = analyze_child(
            ["--protocol", "--format", "json", "--schedule",
             os.path.join(PROTOCOL_FIXTURES, f)], 120)
        check(rdone.returncode == 0, f"analyze --schedule {f} exited "
              f"{rdone.returncode}: {rdone.stdout[-2000:]} {rdone.stderr[-2000:]}")
        runs = json.loads(rdone.stdout)["replay"]["runs"]
        check(runs and all(r["ok"] for r in runs), f"analyze --schedule {f}: {runs}")
        replays[f] = {"runs": {r["against"]: r["status"] for r in runs},
                      "seconds": rseconds}
    return {"rc": done.returncode, "seconds": seconds, "models": models,
            "depth": PROTOCOL_DEPTH, "crash_budget": PROTOCOL_CRASH_BUDGET,
            "replays": replays}


def cost_run(y: torch.Tensor, timeout: float = ANALYZE_TIMEOUT_S) -> dict:
    """``analyze --cost --format json --bind ...`` at the smoke's shapes:
    the static FLOPs of ``serving._score`` at the b256 scan over the
    flagship must equal :func:`scan_flops` (the serving phase's analytic
    FLOPs of the same call), and the collective bytes priced for
    ``train.solve_side_sharded`` must equal the bytes of ``y`` (the train
    phase's Y on the card), the copy ``replicated(full, devices)`` makes
    per shard."""
    bindings = {"qs.d0": COST_SCAN_BATCH, "qs.d1": FEATURES,
                "mat.d0": FLAGSHIP_ITEMS, "mat.d1": FEATURES,
                "y.d0": y.shape[0], "y.d1": y.shape[1]}
    done, seconds = analyze_child(
        ["--cost", "--format", "json", "--bind",
         ",".join(f"{s}={v}" for s, v in bindings.items())], timeout)
    check(done.returncode == 0, f"analyze --cost exited {done.returncode}: "
          f"{done.stdout[-2000:]} {done.stderr[-2000:]}")
    progs = {p["program"]: p for p in json.loads(done.stdout)["programs"]}
    score = progs.get("oryx_tpu_torch.models.als.serving._score")
    sharded = progs.get("oryx_tpu_torch.models.als.train.solve_side_sharded")
    check(score is not None and sharded is not None,
          f"analyze --cost: programs {sorted(progs)}")
    want_flops = scan_flops(COST_SCAN_BATCH, FLAGSHIP_ITEMS, FEATURES)
    want_bytes = y.numel() * y.element_size()
    check(score["flops"]["value"] == want_flops,
          f"analyze --cost: _score's static FLOPs {score['flops']} at b"
          f"{COST_SCAN_BATCH} x {FLAGSHIP_ITEMS:,} x {FEATURES}, the "
          f"smoke's {want_flops}")
    check(sharded["collective_bytes"]["value"] == want_bytes,
          f"analyze --cost: solve_side_sharded's collective bytes "
          f"{sharded['collective_bytes']}, the train phase's Y is {want_bytes} B")
    return {"rc": done.returncode, "seconds": seconds, "programs": len(progs),
            "bindings": bindings,
            "score_flops": {"static": score["flops"]["value"],
                            "expr": score["flops"]["expr"],
                            "smoke": want_flops},
            "sharded_collective_bytes": {
                "static": sharded["collective_bytes"]["value"],
                "expr": sharded["collective_bytes"]["expr"],
                "y_bytes": want_bytes, "y_shape": list(y.shape),
                "y_dtype": str(y.dtype)}}


def sync_windows(windows: dict) -> "tuple[dict, set]":
    """Each window run once under ``torch.cuda.set_sync_debug_mode("warn")``
    (mode 0 restored in a ``finally``). Every sync warning is charged to the
    innermost stack frame under ``oryx_tpu_torch/`` when it is raised (its
    own location may be in torch's Python code): ``traceback.extract_stack``
    in a ``warnings.showwarning`` hook, every warning shown (``always``). A
    sync with no frame in the package is charged to ``outside:<file>:<line>``.
    Returns ``{window: {"relpath:line": syncs}}`` and the ``(relpath, first
    line)`` of every port function the windows entered (``sys.setprofile``)."""
    import traceback
    import warnings

    pkg = os.path.join(str(REPO_ROOT), "oryx_tpu_torch") + os.sep
    observed: dict = {}
    ran: set = set()

    def rel(path: str) -> str:
        return os.path.relpath(os.path.abspath(path), str(REPO_ROOT))

    def on_call(frame, event, arg):
        if event == "call":
            path = os.path.abspath(frame.f_code.co_filename)
            if path.startswith(pkg):
                ran.add((rel(path), frame.f_code.co_firstlineno))

    for label, fn in windows.items():
        sites = observed[label] = {}
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown = warnings.showwarning

            def hook(message, category, filename, lineno, file=None, line=None,
                     _sites=sites, _shown=shown):
                if SYNC_WARNING not in str(message):
                    return _shown(message, category, filename, lineno, file, line)
                frame = next((f for f in reversed(traceback.extract_stack())
                              if os.path.abspath(f.filename).startswith(pkg)), None)
                key = (f"{rel(frame.filename)}:{frame.lineno}" if frame is not None
                       else f"outside:{filename}:{lineno}")
                _sites[key] = _sites.get(key, 0) + 1

            warnings.showwarning = hook
            sys.setprofile(on_call)
            try:
                torch.cuda.set_sync_debug_mode("warn")
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
                sys.setprofile(None)
        torch.cuda.synchronize()
    return observed, ran


def classify_syncs(observed: dict, ran: set, findings: list) -> "tuple[dict, list]":
    """Each observed sync site against the port's transfer recogniser
    (``dataflow.transfers_at``: the transfer calls of the site's line) and
    against the analyser's host-device-transfer findings. Returns the
    per-window record and the sites the recogniser does not classify."""
    from oryx_tpu_torch.tools.analyze import dataflow
    from oryx_tpu_torch.tools.analyze.core import build_project

    project, errors = build_project([str(REPO_ROOT / "oryx_tpu_torch")],
                                    root=str(REPO_ROOT))
    check(not errors, f"analyze: parse errors {errors}")
    hdt = {f"{f['path']}:{f['line']}": f for f in findings
           if f["checker"] == "host-device-transfer"}
    out: dict = {}
    unrecognised = []
    seen_sites = set()
    for label, sites in observed.items():
        rows = {}
        for site, n in sorted(sites.items()):
            relpath, _, line = site.rpartition(":")
            fctx = project.by_relpath.get(relpath)
            kinds = (sorted({k for _, k in dataflow.transfers_at(fctx, int(line))})
                     if fctx is not None else [])
            if not kinds:
                unrecognised.append(f"{label}: {site}")
            finding = hdt.get(site)
            rows[site] = {"syncs": n, "kinds": kinds,
                          "finding": (None if finding is None
                                      else finding["suppressed_by"] or "reported")}
            seen_sites.add(site)
        out[label] = {"distinct_sites": len(rows), "syncs": sum(sites.values()),
                      "sites": rows}

    def enclosing(relpath: str, line: int):
        fctx = project.by_relpath.get(relpath)
        best = None
        for _, fn in (fctx.functions if fctx is not None else ()):
            if fn.lineno <= line <= (fn.end_lineno or fn.lineno) and (
                    best is None or fn.lineno > best.lineno):
                best = fn
        if best is None:
            return None
        return (relpath, min([best.lineno] + [d.lineno for d in best.decorator_list]))

    on_paths = [site for site, f in sorted(hdt.items())
                if enclosing(f["path"], f["line"]) in ran]
    return {"windows": out,
            "observed_findings": sorted(s for s in seen_sites if s in hdt),
            "findings_on_paths_never_synced": [s for s in on_paths
                                               if s not in seen_sites],
            "findings_total": len(hdt)}, unrecognised


def analyze_phase(user_side, item_side, y, km_points, flagship, rng) -> dict:
    """The ``analyze`` line (see the module docstring): the analyser over
    the checkout, then three windows of what earlier phases built under
    the card's sync reporting, each sync site held against the
    recogniser."""
    t0 = time.perf_counter()
    analyser = analyzer_run()
    findings = analyser.pop("findings")
    protocol = protocol_run()
    cost = cost_run(y)
    pts = km_points[:ANALYZE_KM_N]
    host_pts = pts.cpu().numpy()
    queries = rng.standard_normal((ANALYZE_TOPN_BATCH, FEATURES), dtype=np.float32)
    flagship.y_snapshot()  # the upload is the serving phases', not the window's

    def kmeans():
        kmtrain.kmeans_train(pts, KM_K, iterations=KM_ITERATIONS, runs=1,
                             generator=torch.Generator().manual_seed(SEED + 61))
        kmtrain.fit_index_centroids(host_pts, KM_K, iterations=2, seed=SEED + 67,
                                    reseed_rounds=1)

    windows = {
        "als_iteration": iteration_fn(user_side, item_side, y),
        "kmeans_train": kmeans,
        "top_n_batch": lambda: flagship.top_n_batch(queries, ANALYZE_TOPN_HOW_MANY),
    }
    t1 = time.perf_counter()
    observed, ran = sync_windows(windows)
    windows_s = time.perf_counter() - t1
    syncs, unrecognised = classify_syncs(observed, ran, findings)
    check(not unrecognised, "analyze: syncs the card reported at sites the "
          f"transfer recogniser does not classify: {unrecognised}")
    return {"analyser": analyser, "protocol": protocol, "cost": cost,
            "syncs": syncs, "windows_s": windows_s,
            "seconds": time.perf_counter() - t0,
            "windows": {"als_iteration": "one iteration (both halves) on the "
                                         "train phase's blocked sides",
                        "kmeans_train": f"kmeans_train at {ANALYZE_KM_N:,} x "
                                        f"{KM_D}, k = {KM_K}, {KM_ITERATIONS} "
                                        "iterations; fit_index_centroids on "
                                        "the same points, 2 iterations, one "
                                        "reseed round",
                        "top_n_batch": f"b{ANALYZE_TOPN_BATCH} top_n_batch on "
                                       f"the {FLAGSHIP_ITEMS:,} x {FEATURES} "
                                       "flagship"}}


# -- the device mesh ----------------------------------------------------------

MESH_SHARDS = 4
MESH_BATCH = 256
MESH_EXCLUDED = 3
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5  # the reference's mesh-training tolerance
MESH_KM_RTOL, MESH_KM_ATOL = 1e-4, 1e-5  # and its data-parallel step's


class CallLaunches:
    """For the length of a ``with`` block, wraps ``module.name`` and keeps,
    for each call in order, the kernel launches counted during it
    (``K.LAUNCHES`` before and after; the phase launches from one thread)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls: list = []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            before = dict(K.LAUNCHES)
            out = self.fn(*args, **kwargs)
            self.calls.append({w: K.LAUNCHES[w] - before[w] for w in K.LAUNCHES})
            return out
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> dict:
    """How far ``got`` is from ``want`` against ``|got − want| <= atol +
    rtol·|want|``: the largest difference and the largest excess over the
    bound (<= 0 within it)."""
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()),
            "max_excess": float((diff - (atol + rtol * want.abs())).max())}


def mesh_als(batch, x, y, train_s: float, mesh) -> tuple:
    """The smoke's ALS train again, its rows sharded 4 ways over ``model``
    (the same batch, Y₀ from the same generator seed), against the
    one-device train's factors; each shard's launches of both kernels
    counted per call of its block solve."""
    timings: dict = {}
    with FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                        (tr, "spd_solve_batched", spd_key)]) as first, \
            CallLaunches(tr, "solve_side_blocked") as calls:
        K.reset_launches()
        t0 = time.perf_counter()
        xs, ys = tr.als_train(batch, FEATURES, LAM, ALPHA, True, ITERATIONS,
                              generator=torch.Generator().manual_seed(SEED + 1),
                              mesh=mesh, row_axis="model", timings=timings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {w: K.LAUNCHES[w] for w in ALS_WRAPPERS}
        counted = dict(K.SHAPE_LAUNCHES)
    n_users, n_items = len(batch.users), len(batch.items)
    check(timings["shards"] == MESH_SHARDS and xs.n_shards == ys.n_shards == MESH_SHARDS,
          f"mesh als: {xs.n_shards}/{ys.n_shards} shards, expected {MESH_SHARDS}")
    check(xs.devices == ys.devices == mesh.axis_devices("model"),
          f"mesh als: shards on {xs.devices} / {ys.devices}, not the mesh's")
    # the calls go half by half (user, item), shard 0 .. 3 within each
    blocks = timings["blocks"]
    per_shard = {side: [{w: 0 for w in ALS_WRAPPERS} for _ in range(MESH_SHARDS)]
                 for side in ("user", "item")}
    check(len(calls.calls) == 2 * ITERATIONS * MESH_SHARDS,
          f"mesh als: {len(calls.calls)} shard solves, expected "
          f"{2 * ITERATIONS * MESH_SHARDS}")
    for i, call in enumerate(calls.calls):
        side = ("user", "item")[(i // MESH_SHARDS) % 2]
        for w in ALS_WRAPPERS:
            per_shard[side][i % MESH_SHARDS][w] += call[w]
        check(call["kmeans_assign_accumulate"] == 0, "mesh als: a sweep launched")
    for side in ("user", "item"):
        want = blocks[side] // MESH_SHARDS * ITERATIONS
        for s, got in enumerate(per_shard[side]):
            check(all(got[w] == want for w in ALS_WRAPPERS),
                  f"mesh als: {side} shard {s} launched {got}, expected {want} "
                  f"of each ({blocks[side] // MESH_SHARDS} blocks x {ITERATIONS})")
    expected = ITERATIONS * (blocks["user"] + blocks["item"])
    check(all(launches[w] == expected for w in ALS_WRAPPERS),
          f"mesh als: {launches} launches, expected {expected} of each")
    xf, yf = xs.full(), ys.full()
    check(not xf[n_users:].any() and not yf[n_items:].any(),
          "mesh als: a padding row is not zero")
    errs = {"x": excess(xf[:n_users], x, MESH_RTOL, MESH_ATOL),
            "y": excess(yf[:n_items], y, MESH_RTOL, MESH_ATOL)}
    for side, e in errs.items():
        check(e["max_excess"] <= 0.0, f"mesh als: sharded {side} off the "
              f"one-device train beyond rtol {MESH_RTOL}, atol {MESH_ATOL}: {e}")
    held = hold_path_launches(first, counted, "mesh.als")
    return {"seconds": seconds, "unsharded_seconds": train_s,
            "iter_s": timings["iter_s"], "pack_s": timings["pack_s"],
            "shards": MESH_SHARDS, "blocks": blocks,
            "padded_rows": {"user": xs.shape[0], "item": ys.shape[0]},
            "launches": launches, "shard_launches": per_shard,
            "shape_launches": {launch_key(*key): n for key, n in counted.items()},
            "vs_unsharded": errs, "rtol": MESH_RTOL, "atol": MESH_ATOL}, held


def mesh_kmeans(points, mesh) -> tuple:
    """The data-parallel Lloyd step on the kmeans phases' 1M × 64 points in
    4 shards over ``data``, from the same random centres as the unsharded
    ``_lloyd_run``, 8 iterations. Each of the 9 steps is held in lockstep
    (both from the unsharded run's centres at that step): the same
    nearest centres (equal counts), the next centres within 1e-4 / 1e-5,
    the cost within 1e-4. The two runs themselves are held by their cost
    (1e-4) and their centres and assignments reported: a rounding of the
    sums moves a few of the standard-normal points that lie within a
    rounding of two centres, and 8 iterations carry that on."""
    dev = points.device
    n = points.shape[0]
    weights = torch.ones(n, device=dev)
    c0 = kmtrain._init_random(torch.Generator(device=dev).manual_seed(SEED + 53),
                              points, KM_K)
    c1, n1, cost1 = kmtrain._lloyd_run(points, weights, c0, KM_ITERATIONS)
    sp = shard_rows(points, mesh, "data")
    sw = shard_rows(weights, mesh, "data")
    check(sp.rows_per_shard * MESH_SHARDS == n, "mesh kmeans: the points did not split evenly")
    per_shard = [0] * MESH_SHARDS
    with FirstLaunches([(K, "kmeans_assign_accumulate", sweep_key)]) as first, \
            CallLaunches(K, "kmeans_assign_accumulate") as calls:
        K.reset_launches()
        c2, n2, cost2 = kmtrain._lloyd_run(sp, sw, c0, KM_ITERATIONS)
        torch.cuda.synchronize()
        launches = K.LAUNCHES["kmeans_assign_accumulate"]
        counted = dict(K.SHAPE_LAUNCHES)
    # each call of the wrapper is one shard's sweep, shards in order
    for i, call in enumerate(calls.calls):
        per_shard[i % MESH_SHARDS] += call["kmeans_assign_accumulate"]
    want = KM_ITERATIONS + 1
    check(per_shard == [want] * MESH_SHARDS and launches == want * MESH_SHARDS,
          f"mesh kmeans: shard launches {per_shard}, total {launches}, "
          f"expected {want} a shard")
    held = hold_path_launches(first, counted, "mesh.kmeans")
    # lockstep: the sharded step from each of the unsharded run's centres
    lockstep = []
    c = c0
    for i in range(KM_ITERATIONS + 1):
        s1, k1, e1 = K.kmeans_assign_accumulate(points, weights, c)
        s2, k2, e2 = kmtrain._sweep_sharded(sp, sw, c)
        nxt1 = torch.where((k1 > 0)[:, None], s1 / k1.clamp_min(1.0)[:, None], c)
        nxt2 = torch.where((k2 > 0)[:, None], s2 / k2.clamp_min(1.0)[:, None], c)
        step = {"centres": excess(nxt2, nxt1, MESH_KM_RTOL, MESH_KM_ATOL),
                "counts_equal": bool(torch.equal(k1, k2)),
                "cost_rel": abs(float(e2) - float(e1)) / float(e1)}
        check(step["centres"]["max_excess"] <= 0.0 and step["counts_equal"]
              and step["cost_rel"] <= MESH_KM_RTOL,
              f"mesh kmeans: step {i} off the unsharded step: {step}")
        lockstep.append(step)
        c = nxt1
    cost_rel = abs(float(cost2) - float(cost1)) / float(cost1)
    check(cost_rel <= MESH_KM_RTOL, f"mesh kmeans: cost {float(cost2)} vs "
          f"{float(cost1)} unsharded, rel {cost_rel} > {MESH_KM_RTOL}")
    run = {"centres": excess(c2, c1, MESH_KM_RTOL, MESH_KM_ATOL),
           "counts_max_abs_diff": float((n2 - n1).abs().max()),
           "cost_rel": cost_rel,
           "assignments_differ": int((torch.cdist(points, c2).argmin(1)
                                      != torch.cdist(points, c1).argmin(1)).sum())}
    step_ms = time_ms(lambda: K.kmeans_assign_accumulate(points, weights, c0))
    sharded_ms = time_ms(lambda: kmtrain._sweep_sharded(sp, sw, c0))
    return {"n": n, "d": points.shape[1], "k": KM_K, "iterations": KM_ITERATIONS,
            "shards": MESH_SHARDS, "launches": launches, "shard_launches": per_shard,
            "shape_launches": {launch_key(*key): v for key, v in counted.items()},
            "vs_unsharded": run, "lockstep": lockstep, "step_ms": sharded_ms,
            "unsharded_step_ms": step_ms, "rtol": MESH_KM_RTOL,
            "atol": MESH_KM_ATOL}, held


def mesh_serving(mesh, rng) -> dict:
    """A 1M × 50 seeded catalog served sharded 4 ways over ``model`` beside
    the same store unsharded: b256 top-10 plain, with each query's
    unsharded top-3 excluded, and with LSH at 0.3 (the same hash on both);
    equal ids, scores within 1e-5 relative; both timed."""
    dev = mesh.devices.flat[0]
    y = rng.standard_normal((FLAGSHIP_ITEMS, FEATURES), dtype=np.float32)
    ids = [f"i{j}" for j in range(FLAGSHIP_ITEMS)]
    qs = rng.standard_normal((MESH_BATCH, FEATURES), dtype=np.float32)
    out: dict = {"items": FLAGSHIP_ITEMS, "features": FEATURES,
                 "batch": MESH_BATCH, "shards": MESH_SHARDS}
    for label, rate in (("plain", 1.0), ("lsh_0.3", QUANT_LSH_RATE)):
        single = ALSServingModel(FEATURES, True, rate, device=dev)
        sharded = ALSServingModel(FEATURES, True, rate, device=dev, mesh=mesh)
        single.bulk_load_items(ids, y)
        sharded.y, sharded.lsh = single.y, single.lsh  # one store, one hash
        snap = sharded.y_snapshot()
        check(snap.sharded_mat is not None and snap.sharded_mat.n_shards == MESH_SHARDS,
              f"mesh serving {label}: not sharded")
        base = single.top_n_batch(qs, 10)
        excluded = [{i for i, _ in r[:MESH_EXCLUDED]} for r in base]
        rec: dict = {}
        for case, kw in (("top10", {}), ("excluded", {"excluded": excluded})):
            want = single.top_n_batch(qs, 10, **kw)
            got = sharded.top_n_batch(qs, 10, **kw)
            for b, (g, w) in enumerate(zip(got, want)):
                check_same_top_n([{"id": i, "value": v} for i, v in g], w,
                                 f"mesh serving {label} {case} query {b}")
            check(all(len(r) == 10 for r in got), f"mesh serving {label}: short list")
            if kw:
                check(all(not ({i for i, _ in r} & e) for r, e in zip(got, excluded)),
                      f"mesh serving {label}: an excluded item came back")
            times = {}
            for name, m in (("sharded", sharded), ("unsharded", single)):
                t = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    m.top_n_batch(qs, 10, **kw)
                    t.append(time.perf_counter() - t0)
                times[name] = float(np.median(t)) * 1e3
            rec[case] = {"ms": times["sharded"], "unsharded_ms": times["unsharded"]}
        out[label] = rec
        del single, sharded, snap
        torch.cuda.empty_cache()
    return out


def mesh_config(dev) -> dict:
    """The config side on one card: the default context has one device;
    ``mesh-shape [2]`` raises the reference's ``ValueError``; a manager
    asked to shard serves unsharded, with the log."""
    ctx = ComputeContext(oryx_config.get_default(), "batch")
    check(ctx.num_devices == torch.cuda.device_count() == 1
          and ctx.device.type == "cuda", f"mesh config: {ctx.mesh}")
    try:
        ComputeContext(oryx_config.get_default().with_values(
            {"oryx.batch.streaming.config.mesh-shape": [2]}), "batch")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "needs 2 devices, have 1" in refused,
          f"mesh config: mesh-shape [2] gave {refused!r}")
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    serving_log = logging.getLogger(serving_mod.__name__)
    serving_log.addHandler(handler)
    level = serving_log.level
    serving_log.setLevel(logging.INFO)
    try:
        manager = ALSServingModelManager(oryx_config.get_default().with_values(
            {"oryx.serving.compute.sharded": True}))
    finally:
        serving_log.removeHandler(handler)
        serving_log.setLevel(level)
    logged = [r.getMessage() for r in records]
    check(manager.mesh is None and "sharded serving requested but only one device" in logged,
          f"mesh config: sharded manager mesh {manager.mesh}, log {logged}")
    return {"context_devices": ctx.num_devices, "context_mesh": ctx.mesh.shape,
            "mesh_shape_2": refused, "sharded_manager_log": logged}


def mesh_bootstrap(dev) -> dict:
    """A one-rank ``nccl`` group through ``initialize_from_config``, one
    all-gather, then torn down."""
    conf = oryx_config.get_default().with_values({
        "oryx.distributed.coordinator": f"127.0.0.1:{ioutils.choose_free_port()}",
        "oryx.distributed.num-processes": 1, "oryx.distributed.process-id": 0})
    t0 = time.perf_counter()
    try:
        check(distributed.initialize_from_config(conf) is True
              and distributed.is_initialized(), "mesh bootstrap: no group")
        backend = torch.distributed.get_backend()
        parts = [torch.zeros(2, device=dev)]
        torch.distributed.all_gather(parts, torch.tensor([1.0, 2.0], device=dev))
        torch.cuda.synchronize()
        gathered = parts[0].tolist()
    finally:
        distributed.shutdown()
    check(backend == "nccl" and gathered == [1.0, 2.0]
          and not distributed.is_initialized(),
          f"mesh bootstrap: backend {backend}, gathered {gathered}")
    return {"backend": backend, "world_size": 1, "all_gather": gathered,
            "seconds": time.perf_counter() - t0}


def mesh_phase(batch, x, y, train_s: float, km_points, rng) -> dict:
    """The device mesh on one card: four mesh entries of ``cuda:0``, each
    shard its own tensors and its own kernel launches."""
    dev = x.device
    t0 = time.perf_counter()
    model_mesh = make_mesh(axes=("model",), devices=[dev] * MESH_SHARDS)
    data_mesh = make_mesh(axes=("data",), devices=[dev] * MESH_SHARDS)
    als, als_held = mesh_als(batch, x, y, train_s, model_mesh)
    torch.cuda.empty_cache()
    km, km_held = mesh_kmeans(km_points, data_mesh)
    torch.cuda.empty_cache()
    out = {"als": als, "kmeans": km, "serving": mesh_serving(model_mesh, rng),
           "config": mesh_config(dev), "bootstrap": mesh_bootstrap(dev),
           "held_against_plain": als_held + km_held}
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the random decision forest ---------------------------------------------

# Oryx's RDF example schema is "covtype-style"
# (conf/rdf-classification-example.conf:2), after the public UCI Covertype
# set: 581,012 rows; 10 integer-valued numeric predictors at Covertype's
# ranges; 4 wilderness and 40 soil indicator columns (two-valued
# categorical); a 7-valued categorical target. The rows are planted from
# the seed: the target follows an axis-aligned rule of depth 3 over
# elevation, slope, road distance and one soil column, with 5% of labels
# redrawn uniformly (the rule's ceiling is ~0.96); classes 1 and 2 hold
# 83% of rows. As in Covertype, the wilderness and soil columns and three
# distance columns follow the elevation band, so a node whose random
# feature subset lacks elevation still finds splits. The regression target
# is a piecewise function of the same columns plus noise. Hyperparameters:
# the reference's defaults (oryx_tpu/common/reference_conf.py:706-715) —
# 20 trees, depth 8, 100 split candidates, entropy, min-node-size 16,
# min-info-gain 0.001. The generation runs on the first RDF_LINES rows as
# CSV lines (its host parse is per-token Python, as in the reference) and
# its speed microbatch is the next RDF_MICROBATCH rows.
RDF_ROWS, RDF_NUMERIC, RDF_WILDERNESS, RDF_SOIL, RDF_CLASSES = 581_012, 10, 4, 40, 7
RDF_TREES, RDF_DEPTH, RDF_CANDIDATES = 20, 8, 100
RDF_MIN_NODE, RDF_MIN_GAIN = 16, 0.001
RDF_REG_TREES, RDF_CPU_TREES, RDF_CPU_ROWS = 5, 2, RDF_ROWS
RDF_LINES, RDF_MICROBATCH = 100_000, 10_000
RDF_HTTP_PREDICT, RDF_HTTP_DISTRIBUTION = 1_000, 100
RDF_GAIN_REL, RDF_MEAN_REL = 1e-6, 1e-5
RDF_NUMERIC_NAMES = (
    "Elevation", "Aspect", "Slope", "Horizontal_Distance_To_Hydrology",
    "Vertical_Distance_To_Hydrology", "Horizontal_Distance_To_Roadways",
    "Hillshade_9am", "Hillshade_Noon", "Hillshade_3pm",
    "Horizontal_Distance_To_Fire_Points")
RDF_CATEGORICAL_NAMES = (tuple(f"Wilderness_Area{i + 1}" for i in range(RDF_WILDERNESS))
                         + tuple(f"Soil_Type{i + 1}" for i in range(RDF_SOIL)))
RDF_PREDICTORS = RDF_NUMERIC + RDF_WILDERNESS + RDF_SOIL


def covtype_data(rng: np.random.Generator, n: int) -> dict:
    """``n`` planted covtype-shaped rows: ``X`` (n, 54) float64 with the
    indicator columns as encodings 0/1, ``cover`` the class index 0..6
    (Cover_Type − 1) and ``y`` the regression target."""
    e = rng.normal(2960, 280, n).clip(1859, 3858).round()
    aspect = rng.uniform(0, 360, n).round()
    slope = rng.gamma(3.0, 4.7, n).clip(0, 66).round()
    hyd_h = (0.5 * (e - 1859) + rng.normal(0, 40, n)).clip(0, 1397).round()
    hyd_v = (0.25 * (e - 2500) + rng.normal(40, 12, n)).clip(-173, 601).round()
    road = rng.gamma(2.0, 1200, n).clip(0, 7117).round()
    sin_a = np.sin(np.radians(aspect))
    shade9 = (212 + 25 * sin_a + rng.normal(0, 10, n)).clip(0, 254).round()
    shade12 = (223 - 0.8 * slope + rng.normal(0, 10, n)).clip(0, 254).round()
    shade3 = (142 - 35 * sin_a + rng.normal(0, 15, n)).clip(0, 254).round()
    fire = (1.6 * (e - 1859) + rng.normal(0, 120, n)).clip(0, 7173).round()
    zone = np.digitize(e, [2500, 3050, 3450])
    wild = np.where(rng.random(n) < 0.8, zone, rng.integers(0, RDF_WILDERNESS, n))
    soil = np.where(rng.random(n) < 0.8, zone * 10 + rng.integers(0, 10, n),
                    rng.integers(0, RDF_SOIL, n))
    soil10 = soil == 9  # Soil_Type10
    cover = np.where(
        e < 2500, np.where(soil10, 4, np.where(slope >= 15, 3, 6)),
        np.where(e < 3050, np.where(road >= 4500, 5, 2),
                 np.where((e >= 3450) & (road >= 1500), 7, 1)))
    cover = np.where(rng.random(n) < 0.05, rng.integers(1, RDF_CLASSES + 1, n), cover)
    y = (10.0 * zone + 5.0 * (slope >= 15) + 3.0 * (road >= 4500)
         + 4.0 * soil10 + rng.normal(0, 1, n))
    X = np.concatenate([
        np.stack([e, aspect, slope, hyd_h, hyd_v, road, shade9, shade12,
                  shade3, fire], axis=1),
        np.eye(RDF_WILDERNESS)[wild], np.eye(RDF_SOIL)[soil]], axis=1)
    return {"X": X, "cover": cover - 1, "y": y}


def covtype_lines(X: np.ndarray, cover: np.ndarray) -> list:
    """CSV lines: the 54 predictors as integers, then Cover_Type 1..7."""
    return [",".join(map(str, row)) + f",{c + 1}"
            for row, c in zip(X.astype(np.int64).tolist(), cover.tolist())]


def rdf_conf(target: str = "Cover_Type"):
    """The covtype schema (``target`` categorical for Cover_Type, numeric
    otherwise) with the reference's RDF defaults (RDF_TREES and RDF_DEPTH
    are them), one candidate."""
    categorical = list(RDF_CATEGORICAL_NAMES)
    if target == "Cover_Type":
        categorical.append(target)
    return oryx_config.overlay_on({
        "oryx.input-schema.feature-names": [*RDF_NUMERIC_NAMES,
                                            *RDF_CATEGORICAL_NAMES, target],
        "oryx.input-schema.categorical-features": categorical,
        "oryx.input-schema.target-feature": target,
        "oryx.rdf.num-trees": RDF_TREES,
        "oryx.rdf.hyperparams.max-depth": RDF_DEPTH,
    }, oryx_config.get_default())


def rdf_train(data: dict, task: str, num_trees: int, seed: int, device=None,
              rows: "int | None" = None, timings=None, levels_out=None):
    """``forest_train`` on the covtype rows with the reference's defaults."""
    n = RDF_ROWS if rows is None else rows
    classification = task == rdftrain.CLASSIFICATION
    return rdftrain.forest_train(
        data["X"][:n], (data["cover"] if classification else data["y"])[:n],
        [False] * RDF_NUMERIC + [True] * (RDF_WILDERNESS + RDF_SOIL),
        [0] * RDF_NUMERIC + [2] * (RDF_WILDERNESS + RDF_SOIL),
        task=task, n_classes=RDF_CLASSES if classification else 0,
        num_trees=num_trees, max_depth=RDF_DEPTH,
        max_split_candidates=RDF_CANDIDATES, impurity="entropy",
        min_node_size=RDF_MIN_NODE, min_info_gain_nats=RDF_MIN_GAIN,
        rng=np.random.default_rng(seed), device=device, timings=timings,
        levels_out=levels_out)


def rdf_tree_window(data: dict, dev):
    """One tree's growth at the full shape (bagged, a feature subset of
    sqrt(54) per node, as each of the forest's 20), as a function for
    ``device_profiles``: the binned inputs are built once, outside it."""
    is_cat = np.array([False] * RDF_NUMERIC + [True] * (RDF_WILDERNESS + RDF_SOIL))
    bins_np, _, n_bins = rdftrain.bin_features(
        data["X"], is_cat, np.where(is_cat, 2, 0), RDF_CANDIDATES)
    inputs = rdftrain.ForestInputs(
        bins_np, data["cover"], is_cat, task=rdftrain.CLASSIFICATION,
        n_classes=RDF_CLASSES, n_bins=n_bins, max_depth=RDF_DEPTH, device=dev)
    bag = np.random.default_rng(SEED + 20).poisson(1.0, RDF_ROWS).astype(np.float32)
    weights, scales = inputs.tree_weights(bag)
    subset = rdftrain.subset_size(RDF_PREDICTORS, RDF_TREES, rdftrain.CLASSIFICATION)

    def grow():
        return rdftrain.grow_tree(
            inputs, weights, scales, np.random.default_rng(SEED + 21),
            subset_size=subset, max_depth=RDF_DEPTH, impurity="entropy",
            min_node_size=RDF_MIN_NODE, min_info_gain_nats=RDF_MIN_GAIN)

    return grow


def _node_index(node_id: str) -> tuple:
    """(depth, index within the level) of a root-path node id."""
    idx = 0
    for ch in node_id[1:]:
        idx = 2 * idx + (ch == "+")
    return len(node_id) - 1, idx


def first_tree_difference(trees_a, trees_b, levels_a, levels_b,
                          mean_rel: float = 0.0) -> "dict | None":
    """The first node, tree by tree and level by level, where two forests
    differ: in its split (feature, threshold or category set, default
    side) or being a leaf in one only (``kind`` "split"), or in its record
    count or leaf payload (``kind`` "payload"); with both best gains of the
    node. Leaf means are compared within ``mean_rel`` relative."""
    import dataclasses

    for t, (ra, rb) in enumerate(zip(trees_a, trees_b)):
        frontier = [(ra, rb)]
        while frontier:
            nxt = []
            for a, b in frontier:
                kind = None
                if (a.split is None) != (b.split is None) or (
                        a.split is not None and dataclasses.astuple(a.split)
                        != dataclasses.astuple(b.split)):
                    kind = "split"
                elif a.count != b.count:
                    kind = "payload"
                elif a.split is None:
                    if a.class_counts is not None:
                        same = np.array_equal(a.class_counts, b.class_counts)
                    else:
                        same = (a.n == b.n and abs(a.mean - b.mean)
                                <= mean_rel * max(abs(a.mean), abs(b.mean)))
                    kind = None if same else "payload"
                if kind is not None:
                    depth, idx = _node_index(a.id)
                    ga = float(levels_a[t][depth]["gain"][idx])
                    gb = float(levels_b[t][depth]["gain"][idx])
                    return {"tree": t, "node": a.id, "kind": kind,
                            "gain_a": ga, "gain_b": gb,
                            "gain_rel": abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)}
                if a.split is not None:
                    nxt += [(a.negative, b.negative), (a.positive, b.positive)]
            frontier = nxt
    return None


def count_nodes(trees) -> int:
    stack, n = list(trees), 0
    while stack:
        node = stack.pop()
        n += 1
        if node.split is not None:
            stack += [node.negative, node.positive]
    return n


def rdf_held_against_cpu(data: dict, task: str, dev_trees, dev_levels,
                         seed: int, mean_rel: float = 0.0) -> dict:
    """The card's first RDF_CPU_TREES trees against a CPU run of that many
    from the same generator seed, node by node: equal, or first differing
    at a near-tie (both best gains within RDF_GAIN_REL relative)."""
    cpu_levels: list = []
    t0 = time.perf_counter()
    cpu_trees, _ = rdf_train(data, task, RDF_CPU_TREES, seed, device="cpu",
                             rows=RDF_CPU_ROWS, levels_out=cpu_levels)
    cpu_s = time.perf_counter() - t0
    diff = first_tree_difference(dev_trees[:RDF_CPU_TREES], cpu_trees,
                                 dev_levels, cpu_levels, mean_rel)
    check(diff is None or (diff["kind"] == "split"
                           and diff["gain_rel"] <= RDF_GAIN_REL),
          f"rdf {task}: card and CPU trees differ: {diff}")
    return {"cpu_s": cpu_s, "trees": RDF_CPU_TREES, "rows": RDF_CPU_ROWS,
            "nodes": count_nodes(cpu_trees), "first_difference": diff}


def forest_pmml_text(trees, importances, conf) -> str:
    """The forest's PMML text without its header ``Timestamp``."""
    schema = InputSchema(conf)
    encodings = CategoricalValueEncodings({
        schema.feature_names.index(name): ["0", "1"]
        for name in RDF_CATEGORICAL_NAMES})
    pmml = rdf_codec.forest_to_pmml(
        trees, importances, schema, encodings, max_depth=RDF_DEPTH,
        max_split_candidates=RDF_CANDIDATES, impurity="variance")
    return re.sub(r"<Timestamp>[^<]*</Timestamp>", "", pmmlutils.to_string(pmml))


def rdf_training(data: dict, dev) -> dict:
    """Classification at the full shape, twice (the second timed), the
    first two trees held against the CPU; regression twice for equal bits
    and against the CPU."""
    out: dict = {}
    seed = SEED + 22
    runs = []
    for call in ("first", "timed"):
        timings: dict = {}
        levels: list = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trees, importances = rdf_train(data, rdftrain.CLASSIFICATION, RDF_TREES,
                                       seed, timings=timings, levels_out=levels)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        check(timings["host_syncs"] == timings["levels"],
              f"rdf: {timings['host_syncs']} host syncs for {timings['levels']} levels")
        runs.append((trees, importances, levels))
        out[call] = {"seconds": seconds, "peak_device_bytes": peak, **timings}
    timed = out["timed"]
    out["example_trees_per_s"] = RDF_ROWS * RDF_TREES / timed["seconds"]
    out["nodes"] = count_nodes(runs[1][0])
    (trees, importances, levels), (trees2, importances2, _) = runs
    check(first_tree_difference(trees, trees2, levels, levels) is None
          and np.array_equal(importances, importances2),
          "rdf: two card runs from one seed grew different forests")
    check(abs(importances.sum() - 1.0) < 1e-9, "rdf: importances do not sum to 1")
    out["held_against_cpu"] = rdf_held_against_cpu(
        data, rdftrain.CLASSIFICATION, trees, levels, seed)

    reg_conf = rdf_conf("Target")
    texts = []
    reg = {}
    for call in ("first", "second"):
        timings = {}
        levels = []
        t0 = time.perf_counter()
        r_trees, r_imp = rdf_train(data, rdftrain.REGRESSION, RDF_REG_TREES,
                                   seed + 1, timings=timings, levels_out=levels)
        reg[call] = {"seconds": time.perf_counter() - t0, **timings}
        texts.append(forest_pmml_text(r_trees, r_imp, reg_conf))
        if call == "first":
            first_trees, first_levels = r_trees, levels
    check(texts[0] == texts[1], "rdf regression: two card runs gave different PMML")
    reg["pmml_bytes"] = len(texts[0])
    reg["equal_bits"] = True
    reg["nodes"] = count_nodes(first_trees)
    reg["held_against_cpu"] = rdf_held_against_cpu(
        data, rdftrain.REGRESSION, first_trees, first_levels, seed + 1,
        mean_rel=RDF_MEAN_REL)
    out["regression"] = reg
    return out


def rdf_generation(conf, lines: list, micro: list) -> dict:
    """``RDFUpdate.run_update`` with one candidate on the lines (10% held
    out), published to a recording producer; its ``MODEL`` into an
    ``RDFServingModelManager`` and an ``RDFSpeedModelManager``; the
    microbatch's ``UP``s from the speed manager into the serving one. The
    generation's draws (the hold-out split, the forest) come from the fixed
    ``SEED`` through ``rand.seeded``, scoped to this call, so the hold-out
    accuracy gate is the same on every run and no later phase's draws
    change."""
    update = RDFUpdate(conf)
    producer = RecordingProducer()
    with tempfile.TemporaryDirectory(prefix="oryx-rdf-generation-") as model_dir:
        t0 = time.perf_counter()
        with rand.seeded(SEED):
            update.run_update(None, GENERATION_TIMESTAMP_MS, lines, [],
                              model_dir, producer)
        run_s = time.perf_counter() - t0
        cands = update.report["candidates"]
        check(len(cands) == 1 and all("failed" not in c for c in cands.values()),
              f"rdf generation: candidates {cands}")
        check([k for k, _, _ in producer.sent] == ["MODEL"],
              "rdf generation: not one MODEL published")
        promoted = pmmlutils.read(
            Path(model_dir) / str(GENERATION_TIMESTAMP_MS) / "model.pmml")
    cand = next(iter(cands.values()))
    check(cand["eval"] >= 0.90, f"rdf generation: hold-out accuracy {cand['eval']}")
    model_text = producer.sent[0][1]
    serving = RDFServingModelManager(conf)
    speed = RDFSpeedModelManager(conf)
    for manager in (serving, speed):
        manager.consume([KeyMessage("MODEL", model_text)])
    forest, _ = rdf_codec.read(promoted)
    check(len(serving.get_model().forest.trees) == RDF_TREES
          and np.array_equal(serving.get_model().forest.feature_importances,
                             forest.feature_importances),
          "rdf generation: the served forest is not the promoted PMML's")
    t0 = time.perf_counter()
    ups = speed.build_updates([KeyMessage(None, ln) for ln in micro])
    build_s = time.perf_counter() - t0
    counted = sum(sum(json.loads(u)[2].values()) for u in ups)
    check(counted == RDF_TREES * len(micro),
          f"rdf speed: the UPs count {counted} examples, expected "
          f"{RDF_TREES} x {len(micro)}")
    # each UP is one (tree, leaf)'s class counts: every leaf's counts must
    # grow by exactly its UP's
    trees = serving.get_model().forest.trees
    parsed = [json.loads(u) for u in ups]
    leaves = [trees[t].find_by_id(node).prediction for t, node, _ in parsed]
    before = [leaf.category_counts.copy() for leaf in leaves]
    t0 = time.perf_counter()
    serving.consume([KeyMessage("UP", u) for u in ups])
    apply_s = time.perf_counter() - t0
    for leaf, was, (t, node, counts) in zip(leaves, before, parsed):
        grown = was.copy()
        for enc, c in counts.items():
            grown[int(enc)] += c
        check(np.array_equal(leaf.category_counts, grown),
              f"rdf speed: leaf {t}/{node} holds {leaf.category_counts}, "
              f"expected {grown}")
    return {"run_update_s": run_s, "split_s": update.report["split_s"],
            "build_s": cand["build_s"], "evaluate_s": cand["evaluate_s"],
            "accuracy": cand["eval"],
            "publish_model_s": update.report["publish_model_s"],
            "model_bytes": len(model_text.encode("utf-8")),
            "speed": {"lines": len(micro), "ups": len(ups),
                      "build_updates_s": build_s, "serving_apply_s": apply_s},
            "model_text": model_text, "ups": ups, "serving": serving}


def rdf_http(conf, gen: dict, rows: list, rng, device=None) -> dict:
    """A ``ServingLayer`` with the RDF manager and ``resources.classreg`` on
    a ``memory:`` update topic holding the generation's ``MODEL`` and the
    speed ``UP``s: ``/predict`` and ``/classificationDistribution`` against
    the in-process manager that applied the same messages, and
    ``/feature/importance`` against the PMML's importances; no 5xx."""
    t_phase = time.perf_counter()
    broker_url = "memory:rdf-serving"
    conf = conf.with_values({
        "oryx.input-topic.broker": broker_url,
        "oryx.update-topic.broker": broker_url,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.rdf.serving.RDFServingModelManager",
        "oryx.serving.application-resources":
            "oryx_tpu_torch.serving.resources.classreg",
    })
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    update_topic = conf.get_string("oryx.update-topic.message.topic")
    producer = tp.TopicProducerImpl(broker_url, update_topic)
    producer.send("MODEL", gen["model_text"])
    for u in gen["ups"]:
        producer.send("UP", u)
    producer.close()
    total = tp.get_broker(broker_url).size(update_topic)
    layer, port, t_start, threads = start_layer(conf, "rdf serving_http", device)
    client = HttpClient(port)
    model = gen["serving"].get_model()
    e2v = model.encodings.get_encoding_value_map(
        model.input_schema.target_feature_index)
    out: dict = {"update_messages": total}
    statuses: dict = {}

    def get(path):
        status, _, data = client.request("GET", path)
        statuses[status] = statuses.get(status, 0) + 1
        check(status == 200, f"rdf serving_http: GET {path}: {status} {data[:200]!r}")
        return data

    try:
        wait_until(lambda: applied_messages(layer) >= total, 120,
                   "rdf serving_http: the replay", poll=0.005)
        out["replay_s"] = time.perf_counter() - t_start
        picks = rng.choice(len(rows), RDF_HTTP_PREDICT, replace=False)
        t0 = time.perf_counter()
        for i, j in enumerate(picks.tolist()):
            datum = rows[j][:rows[j].rindex(",") + 1]  # the target left empty
            tokens = datum.split(",")
            want = model.predict(tokens)
            got = get(f"/predict/{datum}").decode()
            check(got == want, f"rdf serving_http: /predict/{datum}: {got!r}, "
                  f"expected {want!r}")
            if i < RDF_HTTP_DISTRIBUTION:
                probs = model.make_prediction(tokens).category_probabilities
                want_d = {e2v[k]: float(p) for k, p in enumerate(probs)}
                got_d = {e["id"]: e["value"] for e in json.loads(
                    get(f"/classificationDistribution/{datum}"))}
                check(got_d == want_d, f"rdf serving_http: /classificationDistribution"
                      f"/{datum}: {got_d}, expected {want_d}")
        out["queries"] = {"predict": RDF_HTTP_PREDICT,
                          "classification_distribution": RDF_HTTP_DISTRIBUTION,
                          "seconds": time.perf_counter() - t0}
        want_imp = [float(v) for v in model.forest.feature_importances]
        check(json.loads(get("/feature/importance")) == want_imp,
              "rdf serving_http: /feature/importance differs from the PMML's")
        check(float(get("/feature/importance/0")) == want_imp[0],
              "rdf serving_http: /feature/importance/0 differs")
    finally:
        client.close()
        closed = close_layer(layer, port, "rdf serving_http", threads)
    out.update(closed)
    out["statuses"] = statuses
    out["seconds"] = time.perf_counter() - t_phase
    return out


def rdf_phase(data: dict, dev, rng) -> dict:
    """The RDF family on the card, the launch counters set to 0 first: the
    trainer at the full shape (and held against the CPU), the generation,
    the speed ``UP``s and the HTTP app. No kernel of the three launches."""
    K.reset_launches()
    t_phase = time.perf_counter()
    out = {"rows": RDF_ROWS, "predictors": RDF_PREDICTORS,
           "classes": RDF_CLASSES, "trees": RDF_TREES, "max_depth": RDF_DEPTH,
           "split_candidates": RDF_CANDIDATES,
           "histogram": "one index_add_ a level over the N*P (example, "
                        "feature) pairs into a flat (node, feature, bin, "
                        "class) int32 histogram (regression: three int64 "
                        "fixed-point channels, one call each)"}
    out["train"] = rdf_training(data, dev)
    t0 = time.perf_counter()
    lines = covtype_lines(data["X"][:RDF_LINES + RDF_MICROBATCH],
                          data["cover"][:RDF_LINES + RDF_MICROBATCH])
    out["lines_s"] = time.perf_counter() - t0
    conf = rdf_conf()
    gen = rdf_generation(conf, [KeyMessage(None, ln) for ln in lines[:RDF_LINES]],
                         lines[RDF_LINES:])
    out["http"] = rdf_http(conf, gen, lines[:RDF_LINES], rng)
    out["generation"] = {k: v for k, v in gen.items()
                         if k not in ("model_text", "ups", "serving")}
    out["launches"] = dict(K.LAUNCHES)
    check(not any(out["launches"].values()),
          f"rdf: kernels launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- als_quality: the reference's quality gates through the card's kernels ------

# tests/test_als_quality.py's bars, unchanged: hold-out AUC above 0.75 for
# each compute dtype, explicit RMSE below 0.35
QUALITY_AUC, QUALITY_RMSE = 0.75, 0.35
# that file's three trains: (label, config, hyperparameters)
QUALITY_IMPLICIT = {"oryx.als.iterations": 8, "oryx.als.hyperparams.features": 20,
                    "oryx.als.hyperparams.lambda": 0.01,
                    "oryx.ml.eval.test-fraction": 0.1}
QUALITY_TRAINS = (
    ("implicit_float32", {**QUALITY_IMPLICIT, "oryx.als.compute-dtype": "float32"},
     [20, 0.01, 1.0]),
    ("implicit_bfloat16", {**QUALITY_IMPLICIT, "oryx.als.compute-dtype": "bfloat16"},
     [20, 0.01, 1.0]),
    ("explicit", {"oryx.als.implicit": False, "oryx.als.iterations": 10,
                  "oryx.als.hyperparams.features": 8,
                  "oryx.als.hyperparams.lambda": 0.05,
                  "oryx.ml.eval.test-fraction": 0.1}, [8, 0.05, 1.0]),
)


def _synthetic_movielens(n_users=900, n_items=1600, n_ratings=100_000, rank=5, seed=0):
    """Low-rank preference structure with popularity skew, timestamped."""
    rng = np.random.default_rng(seed)
    u_f = rng.standard_normal((n_users, rank))
    i_f = rng.standard_normal((n_items, rank))
    scores = u_f @ i_f.T  # (U, I)
    thresholds = np.quantile(scores, 0.75, axis=1)  # per-user affinity cut
    # popularity skew: power law over item ranks (shuffled across item ids)
    pop = rng.permutation(np.arange(1, n_items + 1, dtype=np.float64) ** -0.8)
    pop /= pop.sum()
    lines = []
    seen = set()
    users = rng.integers(0, n_users, size=n_ratings * 8)
    items = rng.choice(n_items, p=pop, size=n_ratings * 8)
    accept = rng.random(n_ratings * 8)
    for u, i, a in zip(users, items, accept):
        if len(lines) >= n_ratings:
            break
        if (u, i) in seen:
            continue
        # interact almost only with high-affinity items
        if scores[u, i] < thresholds[u] and a < 0.95:
            continue
        seen.add((u, i))
        lines.append(f"u{u},i{i},1,{len(lines)}")
    return lines


def explicit_ratings() -> list:
    """``tests/test_als_quality.py::test_als_explicit_rmse_gate``'s
    ratings: rank-4 preferences around 3.0 with noise 0.1, 60 items for
    each of 500 users, random timestamps (the statements are that body's,
    pinned equal by ``tests/test_torch_als_quality.py``)."""
    rng = np.random.default_rng(3)
    n_users, n_items, rank = 500, 400, 4
    u_f = rng.standard_normal((n_users, rank)) * 0.8
    i_f = rng.standard_normal((n_items, rank)) * 0.8
    full = u_f @ i_f.T + 3.0  # centered on a 1..5-ish scale
    lines = []
    for u in range(n_users):
        for i in rng.choice(n_items, 60, replace=False):
            r = full[u, i] + 0.1 * rng.standard_normal()
            lines.append(f"u{u},i{i},{r:.4f}")
    # random timestamps: the time-ordered test split must interleave users
    # (sequential stamps would put the tail users wholly in test, where
    # their unseen ids drop every pair — reference join semantics)
    for n, t in enumerate(rng.permutation(len(lines)).tolist()):
        lines[n] += f",{t}"
    return lines


def quality_train(label: str, overrides: dict, hyper: list, lines: list,
                  dev) -> dict:
    """One of ``tests/test_als_quality.py``'s trains through ``ALSUpdate``
    on ``dev``: the time-ordered split, ``build_model`` with the launch
    counters set to 0 just before and read just after (both ALS kernels
    once per row block and iteration, at ``features``, the gather-Gramian
    in the config's compute dtype, none other), each first launch at a
    shape held against the plain version, then ``evaluate`` held to the
    file's bar."""
    conf = oryx_config.overlay_on(overrides, oryx_config.get_default())
    update = ALSUpdate(conf, device=dev)
    features, iterations = int(hyper[0]), update.iterations
    t0 = time.perf_counter()
    train, test = update.split_new_data_to_train_test(
        [KeyMessage(None, ln) for ln in lines])
    split_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="oryx-quality-") as tmp, \
            FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                           (tr, "spd_solve_batched", spd_key)]) as first:
        K.reset_launches()
        t0 = time.perf_counter()
        pmml = update.build_model(None, train, hyper, Path(tmp))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        counted = dict(K.SHAPE_LAUNCHES)
        check(pmml is not None, f"als_quality {label}: no model built")
        t0 = time.perf_counter()
        score = update.evaluate(None, pmml, Path(tmp), test, train)
        evaluate_s = time.perf_counter() - t0
        record = update.candidate_record(tmp)
    blocks = sum(record["blocks"].values())
    expected = {"gather_gramian_accumulate": iterations * blocks,
                "spd_solve_batched": iterations * blocks,
                "kmeans_assign_accumulate": 0}
    check(launches == expected, f"als_quality {label}: launched {launches}, "
          f"expected {expected} ({iterations} iterations x {blocks} blocks)")
    dtype = str(getattr(torch, update.compute_dtype))
    gg_shapes = [shape for kernel, shape in counted
                 if kernel.startswith("gather_gramian_accumulate")]
    check(gg_shapes and all(s[3] == features and s[4] == dtype for s in gg_shapes),
          f"als_quality {label}: gather-Gramian shapes {gg_shapes}, expected "
          f"k = {features} in {dtype}")
    check(all(shape[1] == features for kernel, shape in counted
              if kernel.startswith("spd_solve_batched")),
          f"als_quality {label}: SPD shapes {counted}, expected k = {features}")
    held = hold_path_launches(first, counted, f"als_quality.{label}")
    out = {"train_lines": len(train), "test_lines": len(test),
           "features": features, "iterations": iterations,
           "compute_dtype": update.compute_dtype, "split_s": split_s,
           "build_s": build_s, "evaluate_s": evaluate_s,
           "train_s": record["train_s"], "pack_s": record["pack_s"],
           "iter_s": record["iter_s"], "blocks": record["blocks"],
           "launches": launches,
           "shape_launches": {launch_key(*key): c for key, c in counted.items()},
           "held_against_plain": held}
    if update.implicit:
        check(score > QUALITY_AUC, f"als_quality {label}: AUC {score} <= {QUALITY_AUC}")
        out["auc"] = score
    else:
        check(-score < QUALITY_RMSE,
              f"als_quality {label}: RMSE {-score} >= {QUALITY_RMSE}")
        out["rmse"] = -score
    return out


def als_quality_phase(dev) -> dict:
    """``tests/test_als_quality.py``'s three trains on the card through the
    hand-written kernels, each under ``rand.seeded(SEED)`` as each of that
    file's cases starts from the test seed: the synthetic MovieLens-100K
    shape implicit in float32 and in bfloat16, and the explicit low-rank
    ratings; held to that file's AUC and RMSE bars."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = {"implicit": _synthetic_movielens(), "explicit": explicit_ratings()}
    out: dict = {"data_s": time.perf_counter() - t0,
                 "lines": {k: len(v) for k, v in data.items()}, "trains": {}}
    for label, overrides, hyper in QUALITY_TRAINS:
        with rand.seeded(SEED):
            out["trains"][label] = quality_train(
                label, overrides, hyper, data[label.split("_")[0]], dev)
    out["launches"] = {w: sum(t["launches"][w] for t in out["trains"].values())
                       for w in ALS_WRAPPERS}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = resolve(None)
    # device cost accounting from the start: every later record counts
    profiling.configure(oryx_config.get_default())
    smi = gpu_query()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=built,
         spd_ptxas=ptxas_checked("spd_solve", spd_kernel_label, 2),
         sweep_ptxas=ptxas_checked("kmeans_assign", sweep_kernel_label, 5))
    cta_fn = spd_cta_entry()

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    lines = synthetic_lines(rng)
    test_mask = rng.random(len(lines)) < TEST_FRACTION
    train_lines = [ln for ln, m in zip(lines, test_mask) if not m]
    test_lines = [ln for ln, m in zip(lines, test_mask) if m]
    batch = als_data.prepare(train_lines, implicit=True)
    test = holdout_batch(test_lines, batch.users, batch.items)
    emit("data", seconds=time.perf_counter() - t0, users=len(batch.users),
         items=len(batch.items), train_nnz=batch.nnz, test_nnz=test.nnz)

    # kernels against their plain versions, on real packed blocks
    user_side, item_side = tr.prepare_blocked(batch, FEATURES, device=dev)
    g = torch.Generator().manual_seed(SEED)
    y_items = tr.init_item_factors(item_side.padded_rows, len(batch.items),
                                   FEATURES, g, dev)
    y_users = tr.init_item_factors(user_side.padded_rows, len(batch.users),
                                   FEATURES, g, dev)
    # each entry's launches expected on the main path: one per row block
    # per iteration at its side's shape; the trainer computes in float32,
    # so the bfloat16 gather-Gramian and the synthetic SPD systems are on
    # no path
    entries = []
    for side, opp, label in ((user_side, y_items, "user"),
                             (item_side, y_users, "item")):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            entries.append(gg_entry(side, opp, dtype,
                                    f"{label},T={side.slot_width},{dname}"))
            on_path = dtype == torch.float32
            entries[-1]["expected_launches"] = (
                side.n_blocks * ITERATIONS if on_path else 0)
            # a reduce launch per call on a block whose schedule has a
            # split row
            entries[-1]["expected_reduce_launches"] = ITERATIONS * sum(
                1 for sc in side.gg_schedules if sc.split_rows) if on_path else 0
    for side, opp, label in ((user_side, y_items, "user"),
                             (item_side, y_users, "item")):
        entries.append(spd_entry(*spd_blocks(side, opp),
                                 f"{label},k={FEATURES}", cta_fn))
        entries[-1]["expected_launches"] = side.n_blocks * ITERATIONS
    for k in SPD_SYNTHETIC_K:
        entries.append(spd_entry(
            *spd_synthetic(dev, SPD_SYNTHETIC_SYSTEMS, k, SEED + k),
            f"synthetic,k={k}", cta_fn))
        entries[-1]["expected_launches"] = 0
    torch.cuda.empty_cache()
    emit("spd_crossover", **spd_crossover(dev, cta_fn))
    emit("kernels_checked", n=len(entries))

    # the main path: train, then serve the trained model
    K.reset_launches()
    timings: dict = {}
    costs0 = metrics.default_registry().snapshot()
    t0 = time.perf_counter()
    x, y = tr.als_train(batch, FEATURES, LAM, ALPHA, True, ITERATIONS,
                        generator=torch.Generator().manual_seed(SEED + 1),
                        timings=timings)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check_train_costs(costs0, ITERATIONS, "train", batch.nnz, (user_side, item_side))
    blocks = user_side.n_blocks + item_side.n_blocks
    expected = ITERATIONS * blocks
    check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all()),
          "train: non-finite factors")
    check(x.shape == (len(batch.users), FEATURES)
          and y.shape == (len(batch.items), FEATURES), "train: factor shapes")
    t0 = time.perf_counter()
    auc = evaluate.area_under_curve(x, y, batch, test,
                                    rng=np.random.default_rng(SEED + 2))
    auc_s = time.perf_counter() - t0
    check(auc > 0.75, f"train: hold-out AUC {auc} <= 0.75")
    steady = timings["iter_s"][1:] or timings["iter_s"]
    emit("train", seconds=train_s, pack_s=timings["pack_s"],
         pack_user_s=timings["pack_user_s"],
         pack_item_s=timings["pack_item_s"], iter_s=timings["iter_s"],
         ratings_per_s=batch.nnz * ITERATIONS / train_s,
         steady_ratings_per_s=batch.nnz / float(np.mean(steady)),
         blocks={"user": user_side.n_blocks, "item": item_side.n_blocks},
         auc=auc, auc_s=auc_s)
    serve = serve_trained(batch, x, y, rng)
    launches = dict(K.LAUNCHES)
    als_shape_launches = shape_launches()
    emit("serve", **serve, launches=launches,
         shape_launches=als_shape_launches)
    for wrapper in ALS_WRAPPERS:
        n = launches[wrapper]
        check(n == expected, f"{wrapper}: {n} launches on the main path, "
              f"expected {expected} ({blocks} blocks x {ITERATIONS} iterations)")
    kernel = f"spd_solve_batched.{K.spd_variant(FEATURES)}"
    n = sum(c for key, c in K.SHAPE_LAUNCHES.items() if key[0] == kernel)
    check(n == expected, f"spd_solve_batched: {n} launches of {kernel} on the "
          f"main path, expected {expected}: {als_shape_launches}")

    # checkpoints and the layout cache on the same batch and Y₀; the
    # generation pair on the first DURABILITY_USERS users' lines
    durability_lines = [ln for ln in lines
                        if int(ln[1:ln.index(",")]) < DURABILITY_USERS]
    durability = als_durability_phase(batch, x, y, user_side, item_side,
                                      durability_lines,
                                      np.random.default_rng(SEED + 29))
    emit("als_durability", **durability, gpu=smi, reduced={
        "generation": f"the lines of the first {DURABILITY_USERS} of "
                      f"{N_USERS} users ({len(durability_lines)} lines), the "
                      f"loop's {LOOP_USERS}: two run_updates",
        "iterations": f"{ITERATIONS}, the smoke's"})

    flagship, flagship_served, flagship_y, flagship_ids = serve_flagship(rng)
    emit("serve_flagship", **flagship)
    serving_quant = serving_quant_phase(flagship_served, flagship_y, flagship_ids, rng)
    del flagship_served, flagship_y, flagship_ids
    torch.cuda.empty_cache()
    emit("serving_quant", **serving_quant, gpu=smi, reduced={
        "flat": "none: the flagship's 1,000,000 x 50 seeded items, bench.py's "
                "serving shape",
        "ivf": "none: bench.py's index shape (2,097,152 x 50, 2,048 cells, 8 probes)"})

    record, km_entries, km_points, sweep_args = kmeans_kernel_phase(dev, rng)
    # every profiled window in one profiler session, straight after the
    # sweep's timing: see device_profiles
    windows = {"als_iteration": iteration_fn(user_side, item_side, y)}
    for label, args in sweep_args.items():
        windows[label] = lambda a=args: K.kmeans_assign_accumulate(*a)
    # the RDF rows, made here for the one-tree window and reused by the
    # rdf phase
    t0 = time.perf_counter()
    rdf_data = covtype_data(np.random.default_rng(SEED + 19), RDF_ROWS)
    rdf_data_s = time.perf_counter() - t0
    windows["rdf_tree"] = rdf_tree_window(rdf_data, dev)
    # a live POST /debug/profile route, refused (409) inside the session;
    # the flagship its capture serves from, made before the session
    prof_layer, prof_port, _, prof_threads = profiling_layer()
    prof_flagship, _, _ = flagship_model(np.random.default_rng(SEED + 43))
    prof_flagship.y_snapshot()
    busy: dict = {}
    # the session's Chrome trace, read back by the port's trace_summary
    # (the tools line)
    with tempfile.TemporaryDirectory(prefix="oryx-trace-") as trace_dir:
        export = {"dir": trace_dir}
        profiles = device_profiles(
            windows, during=lambda: busy.update(debug_profile_busy(prof_port)),
            export=export)
        tools_read_back = tools_trace(export, len(windows))
    del windows, export
    torch.cuda.empty_cache()
    emit("profile", **profiles["als_iteration"])
    prof = profiling_phase(prof_port, busy, profiles, user_side, item_side,
                           batch.nnz, prof_flagship, np.random.default_rng(SEED + 47))
    # the static analyser, and three windows under the card's sync
    # reporting, after the profiler session and outside every timed call
    analyze = analyze_phase(user_side, item_side, y, km_points, prof_flagship,
                            np.random.default_rng(SEED + 61))
    del prof_flagship
    prof.update(close_layer(prof_layer, prof_port, "profiling", prof_threads))
    emit("profiling", **prof, gpu=smi, reduced={
        "flagship": "none: the 1,000,000 x 50 flagship at batch 256",
        "window": f"the rate gauges' window cut from 60 s to {PROFILING_WINDOW_S} s "
                  "while the scans are timed, so the gauges read the scan alone"})
    emit("analyze", **analyze, gpu=smi)
    record["profile"] = sweep_profile(profiles["1M x 64"], "1M x 64")
    record["update_shape"]["profile"] = sweep_profile(profiles["100k x 64"],
                                                      "100k x 64")
    emit("kmeans_kernel", **record)
    km_update = kmeans_update_phase(dev, rng)
    km_http = km_update.pop("serving_http")
    emit("kmeans_update", **km_update)
    km_train = kmeans_train_phase(km_points)
    emit("kmeans_train", **km_train)
    # the device mesh: the train's batch and Y₀ and the sweep's points,
    # sharded 4 ways over four mesh entries of the one card
    mesh = mesh_phase(batch, x, y, train_s, km_points,
                      np.random.default_rng(SEED + 59))
    mesh_held = mesh.pop("held_against_plain")
    emit("mesh", **mesh, gpu=smi, reduced={
        "cards": f"{MESH_SHARDS} mesh entries of the one card: each shard its "
                 "own tensors and launches, the merges as across cards",
        "serving": f"a 1,000,000 x {FEATURES} seeded catalog, the flagship's "
                   f"shape, at batch {MESH_BATCH}"})
    rdf = rdf_phase(rdf_data, dev, np.random.default_rng(SEED + 23))
    del rdf_data
    emit("rdf", **rdf, data_s=rdf_data_s, profile=profiles["rdf_tree"], gpu=smi,
         reduced={
             "rows": "none: 581,012 rows x 54 predictors, Covertype's shape",
             "trees": f"regression {RDF_REG_TREES} trees; classification "
                      f"{RDF_TREES}, the reference's default",
             "cpu_comparison": f"the first {RDF_CPU_TREES} trees on "
                               f"{RDF_CPU_ROWS:,} rows",
             "generation": f"the first {RDF_LINES:,} rows as CSV lines (the "
                           "host parse is per-token Python, as in the reference)"})
    # the reference's quality gates through the kernels, on its own data
    als_quality = als_quality_phase(dev)
    emit("als_quality", **als_quality, gpu=smi, reduced={
        "data": "none: tests/test_als_quality.py's own shapes (900 users x "
                "1,600 items, 100,000 lines; 500 x 400 explicit ratings, 60 "
                "a user) and configs"})
    # last: mostly host work, and nothing after it is profiled; the loop
    # and the deployment on the first LOOP_USERS users' lines
    loop_lines = [ln for ln in lines if int(ln[1:ln.index(",")]) < LOOP_USERS]
    loop = lambda_loop_phase(loop_lines, rng)
    loop["reduced"] = {
        "users": f"the lines of the first {LOOP_USERS} of {N_USERS} users "
                 f"({len(loop_lines)} lines), as the deployment's",
        "microbatches": f"2 x {SPEED_MICROBATCH}, cut from 2 x 50000 with the users"}
    serving_http = loop.pop("serving_http")
    chaos = loop.pop("chaos")
    serving_swap = loop.pop("serving_swap")
    quant_http = loop.pop("serving_quant_http")
    observability = loop.pop("observability")
    tools = serving_http.pop("tools")
    emit("lambda_loop", **loop)
    emit("serving_http", **serving_http, kmeans=km_http)
    emit("chaos", **chaos, gpu=smi, reduced={
        "layer": "one replica of the loop's generation; the drill's speed "
                 "tier is the loop's, on its memory: topics"})
    tools_s = (tools.pop("seconds") + tools_read_back["export_s"]
               + tools_read_back["summarize_s"] + tools_read_back["cli_s"])
    emit("tools", trace=tools_read_back, **tools, gpu=smi, seconds=tools_s,
         reduced={"traffic": f"{TOOLS_TRAFFIC_S} s at {TOOLS_TRAFFIC_THREADS} "
                             "threads, no interval, from a client process, on "
                             "the loop's layer"})
    emit("serving_swap", **serving_swap, gpu=smi, reduced={
        "generation_2": f"ALSUpdate.run_update at k = {SWAP_FEATURES} on the lines "
                        f"of the first {SWAP_USERS} of the loop's {LOOP_USERS} users",
        "windows": f"{SWAP_WINDOW_S} s of load before the stage and after "
                   "generation 2 is applied",
        "load": f"{SWAP_CONNECTIONS} connections over {HTTP_USERS} users"})
    emit("serving_quant_http", **quant_http, gpu=smi)
    emit("observability", **observability, gpu=smi, reduced={
        "layer": "one replica of the loop's generation on its memory: topics; "
                 "the hop's speed tier is the loop's"})
    generation, speed = loop["batch"], loop["speed"]
    # the port's sanitizer in a child (this process stays unsanitized)
    emit("sanitize", **sanitize_phase(), gpu=smi)
    # the same loop as a deployment of sanitized CLI processes over tcp:
    deployment = deployment_phase(loop_lines, rng, speed)
    emit("deployment", **deployment)

    # each entry's launches at its shape, from the run of the path that
    # reaches it: the ALS run above, build_model (100k x 64), kmeans_train's
    # timed call (1M x 64)
    km_update_entry, km_train_entry = km_entries
    km_update_entry["expected_launches"] = km_update["launches"][
        "kmeans_assign_accumulate"]
    km_train_entry["expected_launches"] = KM_ITERATIONS + 1
    for e, counts in ([(e, als_shape_launches) for e in entries]
                      + [(km_update_entry, km_update["shape_launches"]),
                         (km_train_entry, km_train["timed"]["shape_launches"])]):
        e["launches"] = counts.get(e.pop("launch_key"), 0)
        e["on_main_path"] = e["launches"] > 0
        want = e.pop("expected_launches")
        check(e["launches"] == want, f"{e['name']}: {e['launches']} launches "
              f"at its shape on its path, expected {want}")
        if "reduce_launch_key" in e:
            e["reduce_launches"] = counts.get(e.pop("reduce_launch_key"), 0)
            want = e.pop("expected_reduce_launches")
            check(e["reduce_launches"] == want,
                  f"{e['name']}: {e['reduce_launches']} reduce launches at "
                  f"its shape on its path, expected {want}")
    entries.extend(km_entries)
    for source in {e["source"] for e in entries}:
        check(any(e["on_main_path"] for e in entries if e["source"] == source),
              f"{source}: not launched on its path")
    # each later path's own launch counts, read just after it ran
    paths = {
        "lambda_loop.batch": {w: generation["launches"][w] for w in ALS_WRAPPERS},
        "kmeans_generation": {"kmeans_assign_accumulate":
                              km_update["generation"]["launches"]},
        "lambda_loop.speed": speed["launches"],
        # the HTTP app's path (the ALS and the k-means layer) launches none
        "serving_http": {w: serving_http["launches"][w] + km_http["launches"][w]
                         for w in serving_http["launches"]},
        # the chaos drill's layer and apps launch none
        "chaos": chaos["launches"],
        # the spans, scrape and bundle checks' layer launches none
        "observability": observability["launches"],
        # read from the batch process's oryx_device_calls_total
        "deployment": {w: deployment["launches"][w] for w in ALS_WRAPPERS},
        # the serving representations (in process and over HTTP) launch none
        "serving_quant": {w: serving_quant["launches"][w]
                          + quant_http["launches"][w]
                          for w in serving_quant["launches"]},
        # the RDF family (trainer, generation, speed, HTTP) launches none
        "rdf_generation": rdf["launches"],
        # checkpointed, resumed and cached trains and the generation pair
        "als_durability": durability["launches"],
        # generation 2 of the staged swap at k = 60 (the layers launch none)
        "serving_swap": serving_swap["launches"],
        # the sharded ALS train and the data-parallel Lloyd run, per shard
        # in the mesh line
        "mesh": {**mesh["als"]["launches"],
                 "kmeans_assign_accumulate": mesh["kmeans"]["launches"]},
        # the reference's three quality trains, summed (each in the
        # als_quality line)
        "als_quality": als_quality["launches"],
    }
    # the same lines, split and shapes as the loop's batch half: the same
    # launches, kernel by kernel, the gather-Gramian's reduce too
    loop_reduce = sum(c for key, c in generation["shape_launches"].items()
                      if key.startswith("gather_gramian_accumulate.reduce"))
    check(paths["deployment"] == paths["lambda_loop.batch"]
          and deployment["launches"]["gather_gramian_accumulate.reduce"] == loop_reduce,
          f"deployment: the batch process launched {deployment['launches']}, the "
          f"loop's batch half {paths['lambda_loop.batch']} (reduce {loop_reduce})")
    # each later path's launches held against the plain versions, one
    # record per shape the path launched at
    path_checks = {
        "lambda_loop.batch": generation["held_against_plain"],
        "kmeans_generation": km_update["generation"]["held_against_plain"],
        "als_durability": durability["held_against_plain"],
        "serving_swap": serving_swap["gen2"]["held_against_plain"],
        "mesh": mesh_held,
        "als_quality": [{"train": label, **entry}
                        for label, t in als_quality["trains"].items()
                        for entry in t["held_against_plain"]],
    }
    print(json.dumps({"kernels": entries, "paths": paths,
                      "path_checks": path_checks, "gpu": smi,
                      "smoke_s": time.perf_counter() - t_main}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
