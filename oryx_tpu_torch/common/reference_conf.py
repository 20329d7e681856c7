"""Canonical default configuration for the TPU-native framework.

A copy of the JAX package's
``oryx_tpu/common/reference_conf.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Mirrors the reference's two reference.conf files
(framework/oryx-common/src/main/resources/reference.conf:14-289 and
app/oryx-app-common/src/main/resources/reference.conf:16-157) with the same
``oryx.*`` key structure for the user-facing surface, and TPU-native
infrastructure keys where the reference had Spark/Kafka/YARN knobs:

  * ``*-topic.broker`` selects a transport backend (``memory:`` in-process,
    ``file:<dir>`` durable log) instead of a Kafka broker address.
  * ``batch/speed.streaming`` keeps ``generation-interval-sec`` (the microbatch
    clock) and replaces executor sizing with mesh sizing (``mesh-shape``,
    ``mesh-axes``) for the pjit'd compute tier.
  * storage dirs are plain paths handled by the DataStore (HDFS equivalent).
"""

REFERENCE_CONF = """
oryx = {
  # Unique instance id; keys consumer-offset persistence so restarted layers
  # resume from where they left off (reference reference.conf:16-20).
  id = null

  input-topic = {
    broker = "memory:"
    lock = { master = "memory:" }
    message = {
      topic = "OryxInput"
      key-class = "str"
      message-class = "str"
      # Partition count used by topic-setup (reference oryx-run.sh:345 creates
      # the input topic with 4); >1 lets consumer groups split the topic.
      partitions = 1
    }
  }

  update-topic = {
    broker = "memory:"
    lock = { master = "memory:" }
    message = {
      topic = "OryxUpdate"
      # Max message size; larger models are published by reference
      # (MODEL-REF) instead of inline (reference reference.conf:78).
      max-size = 16777216
      # Update topic stays single-partition (oryx-run.sh:358): every
      # speed/serving consumer must see every MODEL/UP message, in order.
      partitions = 1
    }
  }

  # Network broker (transport/netbroker.py): point any *-topic.broker at
  # "tcp://host:port" of a `python -m oryx_tpu.cli broker --port N --dir D`
  # process — the single writer that owns the topic directory — and tiers
  # on any host share topics with no shared filesystem (docs/admin.md
  # "Broker selection"). These knobs shape the tcp CLIENT (adopted
  # process-wide by netbroker.configure, the resilience idiom) and the
  # server process.
  broker = {
    # Durability policy for the file: broker's append log (adopted
    # process-wide by transport/topic.configure; the tcp: broker server's
    # inner FileBroker honors it too — docs/robustness.md "Durability").
    file = {
      # When the log fsyncs after an append:
      #   "never"    - page cache only (process kill -9 safe; power loss
      #                can drop the un-synced suffix — torn-tail recovery
      #                truncates it cleanly at next open)
      #   "interval" - at most one fsync per fsync-interval-ms per
      #                partition (bounds power-loss exposure at the
      #                interval; ~zero per-append cost)
      #   "always"   - fsync every append (Kafka flush.messages=1
      #                equivalent; the slowest, strongest setting)
      fsync = "never"
      fsync-interval-ms = 100
    }
    tcp = {
      # TCP connect budget for a client's first (or reconnect) dial.
      connect-timeout-sec = 10
      # Per-RPC socket budget; a broker that answers slower than this
      # surfaces as a transient error and rides the retry policy.
      request-timeout-sec = 30
      # Frame-size ceiling both directions (matches the transport-level
      # MAX_REQUEST_SIZE of 1<<26; oversize requests fail typed, locally).
      max-frame-bytes = 67108864
      server = {
        # Bind host for `cli broker` (--host overrides).
        host = "0.0.0.0"
        # Cadence of the server's one-line stats log (connections, frames,
        # bytes); 0 disables. Full counters are in the process metrics
        # registry, scrapeable over the wire via the `metrics` RPC.
        stats-interval-sec = 60
      }
    }
  }

  # Default compute-tier settings shared by batch and speed
  # (replaces oryx.default-streaming-config Spark knobs).
  default-compute-config = {
    platform = null            # null = let jax pick; or "cpu"/"tpu"
    mesh-shape = null          # e.g. [4, 2]; null = all local devices on one axis
    mesh-axes = ["data", "model"]
    matmul-precision = "bfloat16"
  }

  batch = {
    streaming = {
      generation-interval-sec = 21600
      # Reference parity: any generation exception kills the layer. Off by
      # default — transient generations retry with backoff, poison
      # generations quarantine (offsets advance; docs/robustness.md).
      fatal-on-error = false
      config = ${oryx.default-compute-config}
    }
    update-class = null
    # Preemption-tolerant trainer checkpoints (common/checkpoint.py): the
    # ALS trainer saves factor state every interval-iterations into an
    # atomic, checksummed store, and a restarted generation whose data
    # fingerprint (input offsets + hyperparams + shapes) matches resumes
    # from the newest valid checkpoint — a kill -9 mid-training redoes at
    # most one interval instead of the whole generation
    # (docs/robustness.md "Durability").
    checkpoint = {
      enabled = false
      # Directory for checkpoint files; null disables even when enabled.
      dir = null
      # Save cadence in completed ALS iterations (the final iteration is
      # always saved so a crash before publish resumes for free).
      interval-iterations = 5
      # Checkpoints retained per data fingerprint; the directory is
      # additionally capped at 4x this across superseded generations.
      keep = 2
    }
    storage = {
      data-dir = "/tmp/OryxTPU/data/"
      model-dir = "/tmp/OryxTPU/model/"
      key-writable-class = "str"
      message-writable-class = "str"
      max-age-data-hours = -1
      max-age-model-hours = -1
    }
    ui = { port = 4040 }
  }

  speed = {
    streaming = {
      generation-interval-sec = 10
      # Same semantics as oryx.batch.streaming.fatal-on-error.
      fatal-on-error = false
      config = ${oryx.default-compute-config}
    }
    model-manager-class = null
    min-model-load-fraction = 0.8
    ui = { port = 4040 }
  }

  serving = {
    memory = "4000m"
    api = {
      port = 8080
      secure-port = 8443
      user-name = null
      password = null
      # "digest" (reference InMemoryRealm parity) or "basic" (over TLS)
      auth-scheme = "digest"
      keystore-file = null
      keystore-password = null
      key-alias = null
      read-only = false
      context-path = "/"
      # Per-request time budget (seconds): past it the request answers 504
      # carrying the partial trace id, and downstream work that has not
      # started yet (a queued coalesced device call) is abandoned. The
      # budget rides a contextvar (common/resilience.py Deadline) across
      # executor hops exactly like the span context. 0 disables.
      request-timeout-sec = 0
    }
    application-resources = null
    model-manager-class = null
    min-model-load-fraction = 0.8
    # GET /readyz readiness gate: 503 when seconds since the last consumed
    # update-topic message exceed this (a wedged update consumer silently
    # serves a stale model; the lag gate lets a balancer rotate the replica
    # out). 0 disables the lag check; model-loaded is always required.
    ready-max-lag-sec = 600
    # Where the update consumer starts (and resumes after a crash or a
    # kill -9): "earliest" (reference parity — full replay rebuilds the
    # model from the topic head) or "committed" (offset-keyed resume: the
    # layer commits each partition's position AFTER the manager processed
    # the message, keyed by oryx.id in the broker's offset store, and a
    # restarted replica continues from there instead of replaying the
    # topic). Delivery is at-least-once: a crash between applying a
    # message and the next commit re-delivers that message on restart, so
    # "committed" requires oryx.id AND a manager whose apply is idempotent
    # and whose state survives restarts (tests/fleet_app.py dedupes by
    # sequence number — that pattern). Nothing is ever lost or skipped.
    update-resume = "earliest"
    no-init-topics = false
    # Device representation of the serving factor matrix:
    #   "auto"     - bfloat16 scoring copy on TPU, float32 elsewhere (the
    #                historic behavior; exact dots/norms keep f32 either way)
    #   "float32"  - force the f32 scan everywhere
    #   "bfloat16" - force the bf16 scoring copy (half the f32 HBM)
    #   "int8"     - per-row-scaled int8 factors ONLY on device (1/4 the f32
    #                HBM: a 21M x 50f item side is ~1.1 GB instead of 4.2);
    #                the scan returns rescore-factor x howMany candidates
    #                whose final ranking is an exact f32 rescore from the
    #                host factor arena (docs/admin.md "Choosing device-dtype")
    device-dtype = "auto"
    # int8 path: candidates scanned per request = rescore-factor x howMany
    # (pow2-rounded, floor 16). Higher = better recall under heavy
    # quantization error, more rescore work; 4 holds recall@10 >= 0.99.
    rescore-factor = 4
    # Device-resident IVF candidate generation (models/als/ivf.py): cluster
    # the item factors (in-tree k-means, deterministic seed), keep int8
    # cells + f32 centroids in HBM, probe the top-P cells per query and
    # scan ONLY those before the exact f32 arena rescore — per-query HBM
    # traffic drops from n x k to probes x cell-width x k bytes
    # (docs/performance.md "Sublinear serving"). Requires
    # device-dtype = "int8" (degrades loudly otherwise).
    index = {
      enabled = false
      # Cell count C (power of two). 0 sizes automatically to the pow2
      # nearest sqrt(n) — the classic IVF probe/scan balance.
      cells = 0
      # Cells probed per query (power of two). Recall@10 >= 0.99 holds at
      # 8 on clustered catalogs; single-query widening doubles this when
      # host filtering consumes candidates.
      probes = 8
      # Re-cluster (full rebuild, fresh centroids) when the largest cell
      # exceeds this multiple of the mean occupancy n/C: speed-tier
      # fold-in drift concentrates rows and would otherwise stretch every
      # probe's padded gather.
      rebalance-skew = 4.0
    }
    # Host factor-arena sizing (models/als/vectors.py): one contiguous
    # (rows, features) float32 slab per store, grown by doubling.
    arena = {
      # Rows a fresh slab starts with (point-update-built stores; bulk
      # handoffs size to the model exactly).
      initial-rows = 1024
      # Compact the slab after GC when live rows fall below this fraction
      # of capacity (a retained 1%-survivor model must not pin the old
      # generation's full arena). 0 disables compaction.
      min-fill = 0.25
    }
    # Shard the item-factor matrix over all local devices so Y can exceed
    # one chip's memory; top-N becomes per-shard top-k + cross-shard merge.
    compute = {
      sharded = false
      # Gather concurrent top-N requests for up to coalesce-window-ms (or
      # coalesce-max-batch) and answer them with ONE batched device call —
      # the TPU-shaped replacement for the reference's per-request
      # thread-fanned partition scans. 0 disables.
      coalesce-window-ms = 1.0
      coalesce-max-batch = 256
      # Device calls allowed in flight at once. While one is out, arrivals
      # queue and flush on its completion (batch-while-busy), so batch size
      # tracks arrival-rate x device-latency; 2 overlaps transfer/compute.
      coalesce-inflight = 2
      # Upper bound on a request's queue wait behind in-flight batches: a
      # request older than this flushes even if it must exceed
      # coalesce-inflight by one call (tail-latency cap; 0 disables).
      coalesce-deadline-ms = 250
      # Pre-compile the pow2-batch top-N programs in the background when a
      # model becomes ready, so the first client burst after a MODEL
      # handoff does not pay XLA compiles. Off by default; turn on for
      # production accelerator deployments.
      precompile-batches = false
      # Load shedding: when more than this many requests are already queued
      # for a coalesced device call, new arrivals answer 503 + Retry-After
      # immediately (oryx_shed_requests_total) instead of growing the queue
      # without bound. 0 disables (unbounded queue).
      max-queue-depth = 0
    }
  }

  # Multi-host job coordination via the JAX distributed runtime (replaces
  # ZooKeeper/YARN process coordination; SURVEY §5.8). Single-host when
  # coordinator is null.
  distributed = {
    coordinator = null
    num-processes = null
    process-id = null
  }

  # Compile-lifecycle subsystem (common/compilecache.py): persistent XLA
  # compilation cache + serving bucket warmup. Removes steady-state compiles
  # from the request path (docs/performance.md "Compile lifecycle").
  compile = {
    # Directory for jax's persistent compilation cache. Restarted processes
    # and horizontal serving replicas sharing it deserialize XLA binaries
    # instead of recompiling. null disables. Same shared-filesystem caveat
    # as the file: broker (docs/admin.md): local disk or a real shared FS;
    # the cache tolerates concurrent writers (content-keyed entries).
    cache-dir = null
    # Only cache compiled binaries at least this large (bytes). 0 caches
    # everything — the serving tier wants EVERY bucket binary on disk.
    min-entry-size-bytes = 0
    # Only cache compiles that took at least this long. jax's own default
    # (1s) would skip most bucket programs; 0 caches all of them.
    min-compile-time-sec = 0
    # GET /readyz gate with precompile-batches on: fraction of the pow2
    # bucket ladder that must be compiled before the replica reports ready.
    # 1.0 = fully warm; lower values trade cold-start latency risk for
    # earlier traffic.
    ready-warm-fraction = 1.0
    # Double-buffer model-generation handoffs: build + warm the incoming
    # generation off-path and atomically flip, so a MODEL push never causes
    # a request-visible compile storm. Effective only with
    # precompile-batches on (something must run the warmup ladder).
    prewarm-swap = true
    # Upper bound on how long a staged generation may wait for its warmup
    # before being promoted anyway (warmer died, warm keeps failing). 0
    # disables the valve.
    swap-deadline-sec = 120
  }

  # Fault-tolerance subsystem (common/resilience.py): process-wide retry
  # policy, generation quarantine, circuit breaking, and supervised
  # consumer restart (docs/robustness.md has the failure model per tier).
  resilience = {
    # Retry shape for transient transport faults (broker append/read/offset
    # ops): exponential backoff with full jitter, bounded by attempts AND
    # wall time. Outcomes are visible in oryx_retries_total{site,outcome}.
    retry = {
      max-attempts = 4
      base-delay-ms = 50
      max-delay-ms = 2000
      max-elapsed-sec = 30
    }
    # Microbatch generations: re-attempts before the generation is
    # quarantined (offsets advance past the poison input; counted in
    # oryx_quarantined_generations_total). Backoff shape comes from
    # resilience.retry above.
    generation = {
      max-retries = 2
    }
    # Device-call circuit breaker on the serving coalescer: this many
    # consecutive batched-call failures open it (requests degrade to
    # uncoalesced per-request scans), one probe is admitted every reset-sec
    # and closes it on success. State + transitions are /metrics gauges.
    breaker = {
      failure-threshold = 5
      reset-sec = 10
      half-open-probes = 1
    }
    # Supervised restart of the serving update-consumer thread: a crashed
    # or wedged consumer restarts from the update topic's earliest offset
    # (full state replay — safe by construction) after a backed-off delay
    # instead of leaving /readyz stale forever. max-restarts < 0 = never
    # give up.
    consumer-restart = {
      max-restarts = -1
      base-delay-ms = 100
      max-delay-ms = 5000
    }
  }

  # Deterministic fault injection (common/faults.py): when enabled with a
  # spec, named hot-path sites (broker.append, broker.read, broker.offset,
  # serving.update_consume, serving.device_call) follow exact seeded
  # failure schedules — "broker.append=fail:3;serving.device_call=rate:0.1"
  # — so chaos drills exercise the real retry/breaker/restart paths. No-op
  # when disabled (the production default; docs/robustness.md cookbook).
  faults = {
    enabled = false
    seed = 0
    spec = null
  }

  # Static analyzer budgets (tools/analyze/kernelmodel.py): the VMEM math
  # behind the Pallas kernel checker family and the `analyze --cost` kernel
  # table. These are the single source of truth the runtime kernel gates
  # (ops/pallas_kernels._GG_MAX_FEATURES, the spd batch-tile sizing) are
  # pinned against by tests/test_kernel_differential.py — change a budget
  # here and the consistency gate recomputes what the kernels may claim.
  analyze = {
    kernel = {
      # Per-core VMEM (TPU v4/v5e ~16 MB): the ceiling a kernel's whole
      # resident footprint (pipelined blocks x2 + scratch) is checked
      # against by kernel-vmem-budget.
      vmem-limit-bytes = 16777216
      # Scoped-VMEM budget for the LARGEST single buffer of a grid-tiled
      # kernel ((7 << 17) f32 elements ~ 3.5 MB) — what spd_solve_batched
      # sizes its batch tile under.
      scoped-budget-bytes = 3670016
      # Resident-state budget for accumulator kernels whose output blocks
      # stay VMEM-resident across grid steps (the gather-Gramian shape);
      # 1.5 MB ratifies _GG_MAX_FEATURES = 256 exactly
      # (docs/static_analysis.md "Pallas kernel family").
      resident-budget-bytes = 1572864
    }
  }

  # Runtime concurrency sanitizer (tools/sanitize): opt-in via the
  # ORYX_SANITIZE=locks,loop environment variable (it must install before
  # any lock is allocated, so the MODE cannot live in config); these keys
  # tune the installed sanitizer's thresholds (docs/sanitizer.md).
  sanitize = {
    # Event-loop stall watchdog: an asyncio callback blocking the loop
    # longer than this gets its live stack dumped while still blocked.
    # ORYX_SANITIZE_LOOP_STALL_MS overrides (pre-config processes).
    loop-stall-ms = 250
    # Lock-hold outlier threshold: a repo lock held longer than this is
    # reported at exit (information, not a gate — convoy tuning signal).
    # ORYX_SANITIZE_LONG_HOLD_MS overrides.
    long-hold-ms = 250
  }

  # Device-performance attribution (common/profiling.py): per-program XLA
  # cost accounting feeding oryx_device_flops_total and the scrape-time
  # MFU / HBM-bandwidth gauges, device + host memory telemetry, and the
  # on-demand profiler behind POST /debug/profile
  # (docs/observability.md "Device performance attribution").
  profiling = {
    # Per-chip matmul peak the MFU gauge divides by (TFLOP/s). 0 = auto-
    # detect from the local device kind where known (TPU v5e); unknown
    # kinds leave the gauge at 0 rather than reporting a made-up fraction.
    peak-tflops = 0
    # HBM peak for the achieved-bandwidth gauge (GB/s). 0 = auto-detect,
    # same convention as peak-tflops.
    peak-hbm-gbps = 0
    # Sliding window for the scrape-time FLOP/s and bytes/s rates (an idle
    # process decays to 0 within one window instead of freezing at its
    # last busy rate).
    window-sec = 60
    # POST /debug/profile: upper bound on one capture's ?seconds= — the
    # endpoint shares the process's single jax.profiler slot, so a capture
    # must never be allowed to hold it indefinitely.
    max-capture-sec = 60
    # Base directory for on-demand captures (one timestamped subdir per
    # capture); null = a fresh temp dir per capture. Step captures keep
    # using oryx.tracing.profile-dir.
    profile-dir = null
  }

  # SLO burn-rate engine (common/slo.py): objectives evaluated continuously
  # over the metrics registry at scrape time, exposed as
  # oryx_slo_burn_rate{slo,window} / oryx_slo_error_budget_remaining /
  # oryx_slo_alert_active with multi-window alerting (fast 5m/1h pair pages,
  # slow 30m/6h pair tickets). /readyz embeds the active-alert list;
  # docs/slo.md has the objective grammar and the window math.
  slo = {
    enabled = true
    # Minimum requests in a window before its burn rate is reported (one
    # failed request on a quiet replica must not page anyone).
    min-events = 10
    availability = {
      enabled = true
      # Percent of non-probe HTTP requests that must not answer 5xx.
      objective = 99.9
      # Error-budget accounting window (seconds) behind
      # oryx_slo_error_budget_remaining.
      window-sec = 86400
    }
    latency = {
      # Off by default: a latency objective only means something against a
      # deployment's own threshold (the CPU test container's nominal p99
      # sits above any TPU-shaped default).
      enabled = false
      # Percent of non-probe requests that must finish under threshold-ms
      # (the threshold snaps to the nearest latency-histogram bucket edge
      # at or above it).
      objective = 99.0
      threshold-ms = 500
      window-sec = 86400
    }
    freshness = {
      # Off by default: a freshness objective only means something against
      # a deployment's own batch cadence. When enabled, each engine
      # evaluation samples the live model's data age (the lineage
      # watermark, common/lineage.py) — good while at or under
      # threshold-sec — and the burn-rate machinery alerts on sustained
      # staleness: the lambda architecture's bounded-staleness contract
      # as an SLO.
      enabled = false
      # Percent of freshness samples that must be at or under threshold-sec.
      objective = 99.0
      # Maximum acceptable age (seconds) of the data covered by the live
      # model + consumed speed deltas; size it to a few batch generation
      # intervals.
      threshold-sec = 600
      window-sec = 86400
    }
    burn-rate = {
      # Page when BOTH the 5m and 1h burn rates exceed this (14.4 = the
      # whole 30-day budget in ~2 days; Google SRE workbook defaults).
      fast-threshold = 14.4
      # Ticket when BOTH the 30m and 6h burn rates exceed this.
      slow-threshold = 6
    }
  }

  # Model lineage & data freshness (common/lineage.py, docs/observability.md
  # "Model lineage & freshness"): provenance stamps on every published
  # MODEL/update message (generation id, input offsets, watermark, train
  # timing, checkpoint fingerprint, resume/scratch origin), watermark
  # headers on speed-tier deltas, and the serving-side adoption tracker
  # behind GET /lineage, oryx_model_data_freshness_seconds /
  # oryx_model_adoption_lag_seconds / oryx_model_generation_info, and the
  # x-oryx-model-generation response header.
  lineage = {
    # Master switch: off stops stamping outgoing publishes; the serving
    # tracker still runs (consumed stamps are recorded either way) but the
    # freshness gauges read -1 with nothing stamped upstream.
    enabled = true
    # Adoption records retained per replica behind GET /lineage (the live
    # generation, the staged one, and their recent predecessors).
    history = 8
  }

  # Metrics federation / fleet-status (common/federation.py, `python -m
  # oryx_tpu.cli fleet-status`): scrape N replicas' /metrics + /readyz +
  # /trace and merge them soundly (counters sum, histograms add bucket-wise
  # or fall back per-replica on edge mismatch, gauges keep per-replica
  # labels with min/max/sum rollups, down replicas reported down).
  fleet = {
    # Replica scrape targets ("host:port" or full http(s):// base URLs);
    # empty = pass --replicas on the CLI.
    replicas = []
    # Per-replica scrape budget; a replica slower than this reads as down
    # for that scrape rather than stalling the fleet view.
    scrape-timeout-sec = 5
  }

  # Black-box flight recorder (common/blackbox.py): a bounded in-process
  # ring of structured operational events (breaker transitions,
  # quarantines, sheds, consumer restarts, torn-tail recoveries,
  # checkpoint save failures, SLO alert edges, model-generation swaps)
  # behind GET /debug/bundle, auto-dumped so a dead replica leaves
  # evidence (docs/slo.md "Runbook").
  blackbox = {
    # Ring capacity; evictions are counted in
    # oryx_blackbox_events_dropped_total, never silent, and the ring can
    # never grow a dying process's heap.
    ring-size = 512
    # Directory for bundle auto-dumps (SIGTERM, breaker-open/quarantine
    # edges, and the periodic tick below). null disables dumping — the
    # ring and GET /debug/bundle still work.
    dump-dir = null
    # Periodic flight-recorder tick: with a dump-dir set, a bundle lands
    # at most this stale even across a kill -9. 0 disables the tick
    # (edge-triggered and SIGTERM dumps still fire).
    dump-interval-sec = 60
    # Floor between two dumps — an edge storm must not thrash the disk
    # (SIGTERM ignores it: the last words always land).
    dump-min-interval-sec = 5
    # Dump files retained per replica id (oldest deleted).
    keep = 8
  }

  # In-process metrics time-series engine (common/tsdb.py,
  # docs/observability.md "Time series & trends"): a background sampler
  # walks the registry each tick and keeps bounded per-signal history
  # rings — served on GET /metrics/history, embedded as the pre-incident
  # window in blackbox bundles, and fed to the trend-alert early warning.
  tsdb = {
    enabled = true
    # Sampler tick cadence. 0 disables the background thread (manual
    # sample_once() ticks and the rings themselves still work).
    sample-interval-sec = 5
    # Points newer than this are never decimated — the full-resolution
    # window every incident capture draws from.
    full-resolution-sec = 600
    # Wall-clock horizon: points older than this are dropped on append.
    # Between full-resolution-sec and here, history thins 2:1 per
    # decimation pass (tiered; bounded beats pretty).
    retention-sec = 14400
    # Point caps. The total cap is enforced as an even per-signal share,
    # so with the 12 curated signals the defaults hold ~512 points each —
    # a few hundred KB of floats, the whole engine's memory ceiling.
    max-points-per-signal = 512
    max-total-points = 8192
    # Trailing window embedded in blackbox bundles and edge-triggered
    # dumps (captured at TRIGGER time for deferred edge dumps).
    incident-window-sec = 300
    # Subset of the curated signal names to record ([] = all of them):
    # request_rate, request_p99_ms, queue_depth, shed_rate,
    # breaker_degraded_rate, retry_rate, update_lag_sec, freshness_sec,
    # mfu, hbm_fraction, arena_bytes, host_rss_bytes.
    signals = []
    # Trend-aware early warning: least-squares slope over the trailing
    # window plus threshold-crossing ETA. Active rules raise
    # oryx_trend_alert_active, ride /readyz informationally, and record
    # blackbox trend.alert events — firing BEFORE the SLO burn pages.
    trend = {
      enabled = true
      # Slope fit window and the evidence floor below which a rule stays
      # quiet (two samples of noise must never page).
      window-sec = 120
      min-points = 6
      # "Queue depth ramping such that the cap is reached within
      # horizon-sec." limit 0 inherits oryx.serving.compute.max-queue-depth
      # (an unbounded queue has nothing to cross — rule off).
      queue-depth = {
        enabled = true
        horizon-sec = 300
        limit = 0
      }
      # "Data freshness age accelerating past the staleness threshold."
      # limit 0 inherits oryx.slo.freshness.threshold-sec.
      freshness = {
        enabled = true
        horizon-sec = 300
        limit = 0
      }
    }
  }

  # Framework-wide metrics registry + Prometheus text exposition on
  # GET /metrics (replaces the reference's Spark-UI/JMX metrics story;
  # docs/observability.md has the catalog).
  metrics = {
    # Master kill switch for hot-path instrumentation. On by default: one
    # event costs an enabled check + one short-lived per-family lock +
    # a float add (~O(100ns); docs/observability.md "Overhead").
    enabled = true
    # GET /metrics is exempt from oryx.serving.api auth by default
    # (scrapers rarely speak digest); true puts it behind the same auth.
    require-auth = false
    # Bound on distinct label sets per metric family; excess label sets
    # are dropped and counted in oryx_metrics_dropped_label_sets_total.
    max-label-cardinality = 512
  }

  # Per-step timing + optional jax.profiler traces (replaces the reference's
  # Spark-UI observability; SURVEY §5.1).
  tracing = {
    enabled = false
    profile-dir = null
    profile-steps = 5
    log-interval-sec = 60
    # Per-request distributed tracing (common/spans.py): W3C-traceparent
    # propagation across HTTP, the coalescer, and topic hops, served by
    # GET /trace. Independent of `tracing.enabled` above (which drives the
    # StepTracer's logging/profiling side).
    spans = {
      # Master switch for span recording; a disabled recorder costs one
      # attribute read per would-be span (overhead pinned <= 3% of the
      # 10k-qps smoke floor in tests/test_load_benchmark.py).
      enabled = true
      # Bounded ring of finished spans behind GET /trace.
      ring-size = 2048
      # Reservoir retention: the slowest N spans per route survive ring
      # wrap, so the p99 outlier is still inspectable hours later.
      slowest-per-route = 5
    }
  }

  ml = {
    eval = {
      test-fraction = 0.1
      candidates = 1
      hyperparam-search = "random"
      parallelism = 1
      threshold = null
      # Speculative backup execution for straggling candidate builds — the
      # equivalent of the reference's spark.speculation (reference.conf:86):
      # a candidate running longer than multiplier x the median completed
      # build (at least min-runtime-sec) gets one backup attempt on another
      # device; first finisher wins. timeout-sec abandons a candidate whose
      # attempts all hang (null = wait forever).
      speculation = {
        enabled = true
        multiplier = 1.5
        min-runtime-sec = 10
        timeout-sec = null
      }
    }
  }

  # ----- app tier (reference app/oryx-app-common reference.conf) -----

  als = {
    iterations = 10
    implicit = true
    logStrength = false
    hyperparams = {
      features = 10
      lambda = 0.001
      alpha = 1.0
      epsilon = 0.00001
    }
    no-known-items = false
    rescorer-provider-class = null
    # Trainer matmul input precision: "float32" (default) or "bfloat16"
    # (MXU-native: ~4x matmul rate + half the gather bandwidth on TPU;
    # accumulation and solves stay float32 either way).
    compute-dtype = "float32"
    decay = {
      factor = 1.0
      zero-threshold = 0.0
    }
    # Fraction of item vectors scanned per top-N query (LSH-equivalent knob).
    sample-rate = 1.0
  }

  kmeans = {
    iterations = 30
    initialization-strategy = "k-means||"
    evaluation-strategy = "SILHOUETTE"
    runs = 3
    hyperparams = {
      k = 10
    }
  }

  rdf = {
    num-trees = 20
    hyperparams = {
      min-node-size = 16
      min-info-gain-nats = 0.001
      max-split-candidates = 100
      max-depth = 8
      impurity = "entropy"
    }
  }

  input-schema = {
    feature-names = []
    num-features = 0
    id-features = []
    ignored-features = []
    numeric-features = null
    categorical-features = null
    target-feature = null
  }
}
"""
