"""Shared layer base: config parsing, topic wiring, generation clock.

The port of the JAX package's ``oryx_tpu/lambda_rt/layer.py`` (host code, no
JAX), held to it by ``tests/test_torch_lambda.py``. Equivalent of the
original Oryx's AbstractSparkLayer
(framework/oryx-lambda/.../AbstractSparkLayer.java:57-224): where that builds a
JavaStreamingContext + Kafka direct DStream, this builds a ComputeContext
(one torch device) + a microbatch pump over the input topic that resumes from
stored offsets keyed by ``oryx.id`` (buildInputDStream:208-211).

Two changes from the JAX package:

  * ``__init__`` configures only the hooks the port has (metrics, spans,
    resilience, faults, blackbox, the SLO engine, the tsdb sampler, the
    ``tcp:`` client defaults, the file broker's fsync policy, profiling,
    the factor arena's sizing). The reference's compile cache has no torch
    counterpart; its sanitizer hooks are not ported (ROADMAP Queue 1).
  * The context's device is resolved first in ``start()``, before any
    topic is checked, any thread spawned or any socket opened: a layer
    configured for the card on a host without one raises there, instead of
    failing each generation into quarantine. A
    configured class whose constructor takes a ``device`` keyword is built
    on that device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import classutils
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.common import slo
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common import tsdb
from oryx_tpu_torch.common.tracing import StepTracer
from oryx_tpu_torch.parallel.mesh import ComputeContext
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp

log = spans.get_logger(__name__)

#: Per-generation cap on input-message continuation spans/links: a huge
#: replayed batch must not turn one generation into 10^6 span records (the
#: dropped remainder is still counted in the generation span's attributes).
MAX_TRACED_INPUTS_PER_GENERATION = 128

_QUARANTINED = metrics_mod.default_registry().counter(
    "oryx_quarantined_generations_total",
    "Microbatch generations abandoned after exhausting retries (offsets "
    "advanced past the poison input; the layer kept running)",
    ("tier",),
)
_CORRUPT = metrics_mod.default_registry().counter(
    "oryx_corrupt_records_total",
    "Corrupt input-topic records dropped by the microbatch pump",
    ("tier",),
)
_LAYER_FAILURES = metrics_mod.default_registry().counter(
    "oryx_layer_failures_total",
    "Fatal layer-thread failures (the layer closed because of one)",
    ("tier",),
)


class AbstractLayer:
    def __init__(self, config, tier: str):
        self.config = config
        self.tier = tier
        metrics_mod.configure(config)  # batch/speed never build an HTTP app
        spans.configure(config)
        resilience.configure(config)
        faults.configure(config)
        # flight recorder + SLO engine: batch/speed tiers record the same
        # operational events (quarantines, retry exhaustion) and evaluate
        # the same oryx.slo.* objectives as serving replicas
        blackbox.configure(config)
        slo.configure(config)
        # time-series sampler (oryx.tsdb.*): batch/speed tiers record the
        # same curated signal history — their blackbox dumps carry the
        # pre-incident window exactly like a serving replica's
        tsdb.configure(config)
        # tcp:// broker client knobs (oryx.broker.tcp.*), process-wide
        netbroker.configure(config)
        tp.configure(config)  # file-broker fsync durability policy
        # trainer cost accounting + memory gauges report through the same
        # /metrics surface as serving replicas — peaks and gauges
        # configure here too (the device half wires once CUDA is up)
        profiling.configure(config)
        # factor-arena sizing: the speed tier's model stores are arena
        # users exactly like serving's, and honour the same
        # oryx.serving.arena.* knobs
        from oryx_tpu_torch.models.als import vectors as als_vectors

        als_vectors.configure(config)
        self.tracer = StepTracer(config, tier)
        self.id = config.get_string("oryx.id", None)
        self.input_broker = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_broker = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string("oryx.update-topic.message.topic")
        self.generation_interval_sec = config.get_float(
            f"oryx.{tier}.streaming.generation-interval-sec"
        )
        # reference parity knob: the original Spark semantics made any
        # on_batch exception fatal to the layer; default off — transient
        # generations retry, poison generations quarantine
        self.fatal_on_error = config.get_bool(
            f"oryx.{tier}.streaming.fatal-on-error", False
        )
        gen_policy = resilience.RetryPolicy.from_config(
            config, retryable=lambda e: True
        )
        gen_policy.max_attempts = 1 + max(
            0, config.get_int("oryx.resilience.generation.max-retries", 2)
        )
        # generation retries are bounded by ATTEMPTS only: inheriting the
        # transport policy's max-elapsed wall budget (sized for broker ops)
        # would classify the FIRST failure of any generation that ran past
        # it — batch generations legitimately run for minutes — as
        # exhausted, silently disabling max-retries where it matters most
        gen_policy.max_elapsed_sec = float("inf")
        self._generation_policy = gen_policy
        self._group = f"OryxGroup-{tier}-{self.id}" if self.id else None
        # per-partition input positions AFTER reading the current
        # generation's slice — the data-identity half of a trainer
        # checkpoint's fingerprint. Stable across a crash-restart: offsets
        # are only committed after a generation completes, so a re-run
        # generation reads the same slice and lands on the same values.
        self.current_input_offsets: "dict[int, int] | None" = None
        # freshness watermark: the wall time the current generation's input
        # poll STARTED — every event appended before it is in the slice
        # (each partition reads to its size() at poll time), so "data
        # through T is incorporated" holds exactly. Cumulative like the
        # offsets: it covers everything consumed so far, not one slice.
        self.current_input_watermark_ms: "int | None" = None
        # upper bound on the newest consumed event's arrival wall time
        # (poll-start of the last non-empty slice)
        self.current_input_max_event_ms: "int | None" = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._failure: BaseException | None = None
        self._failure_raised = False
        self._context: ComputeContext | None = None

    # -- context ------------------------------------------------------------
    def get_context(self) -> ComputeContext:
        if self._context is None:
            self._context = ComputeContext(self.config, self.tier)
        return self._context

    # -- topics -------------------------------------------------------------
    def assert_topics(self) -> None:
        """Topics must exist before starting (AbstractSparkLayer.java:178-185);
        memory: brokers auto-create since there is no external setup CLI yet."""
        for broker_url, name in (
            (self.input_broker, self.input_topic),
            (self.update_broker, self.update_topic),
        ):
            broker = tp.get_broker(broker_url)
            if not broker.topic_exists(name):
                if broker_url.startswith("memory:"):
                    broker.create_topic(name)
                else:
                    raise tp.TopicException(
                        f"topic {name} does not exist on {broker_url}; run topic-setup"
                    )

    def input_start_offset(self) -> dict[int, int]:
        """Per-partition resume positions: stored offsets for this oryx.id,
        else latest (AbstractSparkLayer.java:208-211)."""
        broker = tp.get_broker(self.input_broker)
        offsets: dict[int, int] = {}
        for p in range(broker.num_partitions(self.input_topic)):
            stored = (
                self._offset_op(
                    lambda p=p: broker.get_offset(self._group, self.input_topic, p)
                )
                if self._group else None
            )
            offsets[p] = stored if stored is not None else broker.size(self.input_topic, p)
        return offsets

    def store_input_offset(self, offsets: dict[int, int]) -> None:
        """Write back consumed per-partition offsets (UpdateOffsetsFn.java)."""
        if self._group:
            broker = tp.get_broker(self.input_broker)
            for p, off in offsets.items():
                self._offset_op(
                    lambda p=p, off=off: broker.set_offset(
                        self._group, self.input_topic, off, p
                    )
                )

    def _offset_op(self, fn):
        """One offset-store read/write under the shared transport retry
        contract (tp.offset_op — the same wrapper the serving layer's
        committed-resume commits ride)."""
        return tp.offset_op(fn, stop=self._stop)

    # -- microbatch pump ----------------------------------------------------
    def run_microbatches(
        self,
        on_batch: Callable[[int, Sequence[KeyMessage]], None],
        interval_sec: float | None = None,
        start_offset: "dict[int, int] | None" = None,
    ) -> None:
        """Every generation interval, hand the new input slice (across all
        input partitions) to on_batch — the foreachRDD loop. Runs until stop.

        Failure semantics (docs/robustness.md): an on_batch exception is
        retried with backoff up to ``oryx.resilience.generation.max-retries``
        times (transient faults — a flaky broker, a briefly-wedged device —
        recover in place), then the generation is QUARANTINED: offsets
        advance past it, ``oryx_quarantined_generations_total`` counts it,
        the generation span records the error, and the layer lives on. With
        ``oryx.<tier>.streaming.fatal-on-error`` the first exception kills
        the layer (reference parity). Input-poll failures past the transport
        retry budget skip the tick without advancing offsets.

        ``start_offset`` should be resolved synchronously in start() so input
        produced after start() returns is never skipped by a slow-to-schedule
        pump thread."""
        interval = interval_sec if interval_sec is not None else self.generation_interval_sec
        broker = tp.get_broker(self.input_broker)
        offsets = dict(start_offset) if start_offset is not None else self.input_start_offset()
        while not self._stop.is_set():
            self._stop.wait(interval)
            if self._stop.is_set():
                break
            batch: list[KeyMessage] = []
            n_corrupt = 0
            first_corrupt: "tuple[int, int] | None" = None
            # stage offset advances in a COPY: a poll failure on a LATER
            # partition must discard the half-built batch and the earlier
            # partitions' advances TOGETHER — advancing the shared dict
            # in place would silently skip the already-read messages on
            # the re-poll (batch dropped, offsets kept)
            new_offsets = dict(offsets)
            poll_start_ms = int(time.time() * 1000)
            try:
                for p in range(broker.num_partitions(self.input_topic)):
                    offset = new_offsets.get(p, 0)
                    end = broker.size(self.input_topic, p)
                    while offset < end:
                        chunk = self._poll_input(broker, p, offset, end - offset)
                        if not chunk:
                            break
                        for i, km in enumerate(chunk):
                            if km is tp.CORRUPT_RECORD:
                                n_corrupt += 1
                                if first_corrupt is None:
                                    first_corrupt = (p, offset + i)
                            else:
                                batch.append(km)
                        offset += len(chunk)
                    new_offsets[p] = offset
            except Exception:  # noqa: BLE001 — poll failure past retry budget
                # transient input-poll failure that outlasted the transport
                # retries: skip this tick WITHOUT advancing offsets — the
                # next tick re-polls the same positions. Killing the layer
                # over a pollable fault is the fragility this path removes.
                log.warning(
                    "input poll failed past the retry budget; re-polling next "
                    "generation", exc_info=True,
                )
                continue
            offsets = new_offsets
            self.current_input_offsets = dict(offsets)
            self.current_input_watermark_ms = poll_start_ms
            if batch:
                # newest-event upper bound: the newest consumed event landed
                # between the previous poll and this one
                self.current_input_max_event_ms = poll_start_ms
            if n_corrupt:
                # one rate-limited (per-generation) line, not one per record:
                # a corrupted log segment would otherwise flood the logger
                _CORRUPT.labels(self.tier).inc(n_corrupt)
                log.warning(
                    "dropped %d corrupt record(s) this generation "
                    "(first at partition %d offset %d)",
                    n_corrupt, first_corrupt[0], first_corrupt[1],
                )
            timestamp_ms = int(time.time() * 1000)
            # trace continuation across the input-topic hop: each traced
            # message gets a span parented into ITS ingress trace (so the
            # HTTP trace that produced the event sees this tier process it),
            # and the generation itself is a root span fan-in-LINKED to
            # every traced message — the exact dual of the coalescer
            traced = []
            if spans.enabled():
                traced = [
                    km.headers[spans.TRACEPARENT] for km in batch
                    if km.headers and spans.TRACEPARENT in km.headers
                ]
            n_traced = len(traced)
            traced = traced[:MAX_TRACED_INPUTS_PER_GENERATION]
            msg_spans = [
                spans.start_span(
                    f"{self.tier}.consume_input", parent=tp_,
                    attributes={"route": f"{self.tier}-input",
                                "batch_items": len(batch)},
                )
                for tp_ in traced
            ]
            try:
                with spans.span(
                    f"{self.tier}.generation", parent=None,
                    links=[s.context for s in msg_spans],
                    attributes={"route": f"{self.tier}.generation",
                                "items": len(batch), "traced_inputs": n_traced},
                ) as gen_span:
                    with self.tracer.step("generation", n_items=len(batch)):
                        self._run_generation(
                            on_batch, timestamp_ms, batch, gen_span
                        )
            finally:
                for s in msg_spans:
                    spans.finish_span(s)
            self.store_input_offset(offsets)

    def _run_generation(self, on_batch, timestamp_ms: int,
                        batch: "list[KeyMessage]", gen_span) -> None:
        """One generation through the transient-vs-poison machinery; raises
        only on fatal-on-error (or during shutdown) — a quarantined
        generation returns normally so the caller advances offsets."""
        site = f"{self.tier}.generation"

        def attempt():
            # chaos hook: an armed "<tier>.generation" schedule fails the
            # generation through the exact path a poison input or a wedged
            # device would take — the quarantine machinery absorbs it
            faults.maybe_fail(site)
            on_batch(timestamp_ms, batch)

        if self.fatal_on_error:
            # reference parity: no retry, first raise kills the layer
            attempt()
            return
        try:
            self._generation_policy.call(site, attempt, stop=self._stop)
        except Exception as e:  # noqa: BLE001 — quarantine after retries
            if self._stop.is_set():
                raise  # shutting down: spawn's guard discards it
            _QUARANTINED.labels(self.tier).inc()
            # flight-recorder edge + dump trigger: an abandoned generation
            # is exactly what the postmortem of a bad model asks about
            blackbox.record_event(
                "quarantine", severity="error", dump=True,
                tier=self.tier, items=len(batch),
                error=f"{type(e).__name__}: {e}",
            )
            gen_span.record_exception(e)
            gen_span.set_attribute("quarantined", True)
            gen_span.set_attribute("items", len(batch))
            log.error(
                "quarantining generation after retries: advancing past %d "
                "input item(s)", len(batch), exc_info=True,
            )

    def _poll_input(self, broker, partition: int, offset: int, n: int):
        """One input-slice read, retried through transient broker failures."""

        def _read():
            faults.maybe_fail("broker.read")
            return broker.read(self.input_topic, offset, n, partition=partition)

        return resilience.default_policy().call(
            "broker.read", _read, retryable=tp.transient_transport_error,
            stop=self._stop,
        )

    # -- threads / lifecycle ------------------------------------------------
    def spawn(self, name: str, fn: Callable[[], None]) -> threading.Thread:
        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                if not self._stop.is_set():
                    log.exception("fatal error in %s; closing layer", name)
                    _LAYER_FAILURES.labels(self.tier).inc()
                    self._failure = e
                    self._stop.set()

        t = threading.Thread(target=run, name=name, daemon=True)
        self._threads.append(t)
        t.start()
        return t

    def load_manager_instance(self, class_key: str, expected_type=None):
        """Reflectively load the configured user class, (config) ctor first
        (BatchLayer.loadUpdateInstance:172-204 / SpeedLayer:160-192). The
        context's device is resolved first, so a missing card raises here;
        a constructor that takes a ``device`` keyword gets it."""
        name = self.config.get_string(class_key)
        if not name:
            raise ValueError(f"no class configured at {class_key}")
        device = self.get_context().device
        return classutils.load_instance_on(name, expected_type, self.config, device)

    def await_termination(self, timeout: float | None = None) -> None:
        """Block until stop; a layer failure is raised exactly ONCE — callers
        polling await_termination in a supervision loop see it the first
        time and a clean return after (it is also already surfaced through
        oryx_layer_failures_total and the spawn-side log line)."""
        self._stop.wait(timeout)
        for t in self._threads:
            t.join(timeout=5)
        if self._failure is not None and not self._failure_raised:
            self._failure_raised = True
            raise self._failure

    def close(self) -> None:
        self._stop.set()
        self.tracer.close()
        for t in self._threads:
            t.join(timeout=5)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()
