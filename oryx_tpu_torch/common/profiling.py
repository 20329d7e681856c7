"""Device-performance attribution: cost accounting, memory telemetry, and
the shared on-demand profiler session.

The port of the JAX package's ``oryx_tpu/common/profiling.py``, with the
same metric names, help strings, labels, ``oryx.profiling.*`` keys and
public functions. Three parts:

  * **Cost accounting** (:class:`CostRegistry`): each device program
    signature registers its per-call ``(flops, bytes)``; call sites
    ``record`` calls × per-call cost into ``oryx_device_flops_total`` /
    ``oryx_device_bytes_total{program}``, and scrape-time gauges divide the
    windowed rate by the peaks (``oryx.profiling.peak-tflops`` /
    ``peak-hbm-gbps``, or :data:`_KNOWN_PEAKS` by device name when those
    are 0) into ``oryx_device_mfu`` and
    ``oryx_device_hbm_bandwidth_fraction``. Torch compiles nothing, so
    there is no ``cost_analysis()``: every cost in the port is analytic
    (the ALS half-iteration in ``models/als/train.py``, each serving scan
    in ``models/als/serving.py`` and ``ivf.py``). ``oryx_device_calls_total``
    is defined here once: the kernel wrappers (``ops/kernels.py``) count
    each launch into it under the kernel's own ``program`` label beside the
    reference's program labels.
  * **Memory telemetry**: scrape-time gauges over
    ``torch.cuda.memory_stats`` (bytes allocated now and at peak, per
    card, labels ``cuda:0``, …) and the card's total memory from
    ``torch.cuda.mem_get_info``, plus host RSS. :func:`memory_snapshot`
    returns the same numbers as a dict with the reference's keys.
  * **On-demand profiling** (:class:`ProfileSession`): ONE
    ``torch.profiler`` capture may be in flight per process. The session
    serializes owners behind a lock with a duration bound — a capture past
    its bound is force-stopped by the next starter instead of wedging
    profiling forever. ``POST /debug/profile`` on the serving console and
    the ``StepTracer`` step captures both go through it; a stop writes a
    Chrome trace (``*.pt.trace.json``) into the capture's directory.

Import cost: metrics families only. torch is never imported here: the
device half wires itself once the process has initialised CUDA (see
:func:`_maybe_wire_torch`), so the transport and tooling processes that
load this module through ``common/tracing`` never load torch.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import weakref
from collections import deque

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans

log = spans.get_logger(__name__)

_FLOPS = metrics_mod.default_registry().counter(
    "oryx_device_flops_total",
    "Device FLOPs attributed via per-program cost accounting "
    "(calls x compiled cost_analysis, or an analytic model where noted)",
    ("program",),
)
_BYTES = metrics_mod.default_registry().counter(
    "oryx_device_bytes_total",
    "Device bytes accessed (HBM traffic proxy) attributed per program",
    ("program",),
)
_CALLS = metrics_mod.default_registry().counter(
    "oryx_device_calls_total",
    "Device-program executions recorded by the cost-accounting layer "
    "(counted even for signatures whose cost is not registered yet)",
    ("program",),
)
#: The process's ``oryx_device_calls_total`` family, for the kernel
#: wrappers' per-launch counts (``ops/kernels.py``).
DEVICE_CALLS = _CALLS
_MFU = metrics_mod.default_registry().gauge(
    "oryx_device_mfu",
    "Model FLOP utilization over the sliding window: attributed FLOP/s "
    "divided by oryx.profiling.peak-tflops (0 when no peak is known)",
)
_FLOPS_RATE = metrics_mod.default_registry().gauge(
    "oryx_device_flops_per_second",
    "Attributed device FLOP/s over the sliding window",
)
_HBM_FRACTION = metrics_mod.default_registry().gauge(
    "oryx_device_hbm_bandwidth_fraction",
    "Achieved HBM bandwidth over the sliding window as a fraction of "
    "oryx.profiling.peak-hbm-gbps (0 when no peak is known)",
)
_BYTES_RATE = metrics_mod.default_registry().gauge(
    "oryx_device_bytes_per_second",
    "Attributed device bytes/s over the sliding window",
)
_HOST_RSS = metrics_mod.default_registry().gauge(
    "oryx_host_rss_bytes",
    "Current resident-set bytes of this process (can go down)",
)
_HOST_PEAK_RSS = metrics_mod.default_registry().gauge(
    "oryx_host_peak_rss_bytes",
    "Peak resident-set bytes of this process since start",
)
_DEV_IN_USE = metrics_mod.default_registry().gauge(
    "oryx_device_memory_bytes_in_use",
    "Device memory currently allocated, per local device "
    "(0 where the backend reports no memory_stats, e.g. CPU)",
    ("device",),
)
_DEV_PEAK = metrics_mod.default_registry().gauge(
    "oryx_device_memory_peak_bytes",
    "Peak device memory allocated since process start, per local device",
    ("device",),
)
_DEV_LIMIT = metrics_mod.default_registry().gauge(
    "oryx_device_memory_limit_bytes",
    "Usable device memory limit, per local device",
    ("device",),
)
_ARENA_BYTES = metrics_mod.default_registry().gauge(
    "oryx_factor_arena_bytes",
    "Host bytes allocated by factor-arena slabs across live vector stores "
    "(models/als/vectors.py: one contiguous (N, k) float32 slab per store)",
)
_ARENA_FILL = metrics_mod.default_registry().gauge(
    "oryx_factor_arena_fill_fraction",
    "Live rows / allocated rows across factor arenas (doubling growth and "
    "tombstones make this < 1; GC compaction pulls it back up)",
)
_QUANT_BYTES = metrics_mod.default_registry().gauge(
    "oryx_device_quantized_factor_bytes",
    "Device bytes held by quantized factor snapshots "
    "(oryx.serving.device-dtype = int8: int8 slab + per-row f32 scales)",
)

#: Known per-card peaks by device-name prefix: (FLOP/s, HBM B/s). Used when
#: ``oryx.profiling.peak-tflops`` / ``peak-hbm-gbps`` are 0. The H100 SXM
#: data sheet at its 700 W limit: 67 TFLOP/s of float32 on the CUDA cores
#: (the port computes float32 with TF32 off, so the tensor cores' rates do
#: not apply) and 3.35 TB/s of HBM3 — the figures ``chip_smoke.py`` bounds
#: every kernel by, so the gauges and the bounds share one yardstick. A
#: card capped below 700 W runs slower than these peaks.
_KNOWN_PEAKS = {
    "NVIDIA H100": (67e12, 3.35e12),
}


class CostRegistry:
    """Per-program device cost table + windowed FLOP/byte rate tracker.

    ``register`` stores (flops, bytes) per program signature; ``record``
    multiplies calls × cost into the process counters and a bounded sample
    window the scrape-time rate gauges read. One lock, critical sections
    of a few arithmetic ops — safe from coalescer executor threads and the
    trainer loop concurrently."""

    def __init__(self, window_sec: float = 60.0):
        self._lock = threading.Lock()
        self._costs: dict[str, tuple[float, float]] = {}
        self._flops_total = 0.0
        self._bytes_total = 0.0
        # (monotonic t, flops delta, bytes delta) per record; pruned past
        # the window on every append and every rate read
        self._events: deque = deque()
        self._window = max(1.0, float(window_sec))
        self._created = time.monotonic()
        # one-scrape memo: four gauges read rates() back to back per scrape
        self._rates_at = float("-inf")
        self._rates_val = (0.0, 0.0)

    def set_window(self, window_sec: float) -> None:
        with self._lock:
            self._window = max(1.0, float(window_sec))

    def register(self, key: str, flops: float, bytes_accessed: float) -> None:
        """Store per-call cost for ``key`` (overwrites: a new model
        generation's re-registration supersedes the old shapes)."""
        with self._lock:
            self._costs[str(key)] = (max(0.0, float(flops)),
                                     max(0.0, float(bytes_accessed)))

    def known(self, key: str) -> bool:
        with self._lock:
            return key in self._costs

    def cost(self, key: str) -> "tuple[float, float] | None":
        with self._lock:
            return self._costs.get(key)

    def record(self, key: str, calls: int = 1) -> None:
        """Attribute ``calls`` executions of ``key``: counters += calls ×
        per-call cost. Signatures with no registered cost still count calls
        (the gap is visible as calls-without-flops, not silently zero)."""
        if calls <= 0 or not metrics_mod.default_registry().enabled:
            return
        _maybe_wire_torch()
        _CALLS.labels(key).inc(calls)
        with self._lock:
            cost = self._costs.get(key)
            if cost is None:
                return
            df, db = cost[0] * calls, cost[1] * calls
            self._flops_total += df
            self._bytes_total += db
            now = time.monotonic()
            self._events.append((now, df, db))
            self._prune(now)
        _FLOPS.labels(key).inc(df)
        _BYTES.labels(key).inc(db)

    def _prune(self, now: float) -> None:
        horizon = now - self._window  # analyze: ignore[lock-discipline] -- _prune runs only under self._lock, taken by its callers
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def rates(self) -> tuple[float, float]:
        """(FLOP/s, bytes/s) over the sliding window. The denominator is
        the full window (clamped to the registry's age), so an idle process
        decays to 0 instead of freezing at its last busy rate. Memoized for
        50 ms: the four scrape-time gauges read it back to back."""
        now = time.monotonic()
        with self._lock:
            if now - self._rates_at < 0.05:
                return self._rates_val
            self._prune(now)
            span = max(1.0, min(self._window, now - self._created))
            df = sum(e[1] for e in self._events)
            db = sum(e[2] for e in self._events)
            self._rates_val = (df / span, db / span)
            self._rates_at = now
            return self._rates_val

    def totals(self) -> tuple[float, float]:
        with self._lock:
            return self._flops_total, self._bytes_total

    def reset(self) -> None:
        with self._lock:
            self._costs.clear()
            self._events.clear()
            self._flops_total = 0.0
            self._bytes_total = 0.0
            self._created = time.monotonic()
            self._rates_at = float("-inf")
            self._rates_val = (0.0, 0.0)


_COSTS = CostRegistry()

# configured peaks (FLOP/s, bytes/s); plain float writes/reads are atomic
# under the GIL — written by configure(), read by the gauge callbacks
_peak_flops_per_s = 0.0
_peak_bytes_per_s = 0.0


def costs() -> CostRegistry:
    """The process-wide cost registry every call site records into."""
    return _COSTS


def peak_flops_per_s() -> float:
    return _peak_flops_per_s


def peak_bytes_per_s() -> float:
    return _peak_bytes_per_s


def _cuda():
    """``torch.cuda`` when this process has initialised CUDA, else None.
    Never imports torch and never initialises CUDA: profiling must not be
    what creates a device context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch.cuda if torch.cuda.is_initialized() else None
    except Exception:  # noqa: BLE001 — a half-imported torch: no device
        return None


def _auto_peaks(cuda) -> tuple[float, float]:
    """Per-card peaks from the device name, for the known table."""
    try:
        name = cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — no usable device: peaks stay unknown
        return 0.0, 0.0
    for prefix, peaks in _KNOWN_PEAKS.items():
        if name.startswith(prefix):
            return peaks
    return 0.0, 0.0


_MFU.set_function(
    lambda: _COSTS.rates()[0] / _peak_flops_per_s if _peak_flops_per_s else 0.0
)
_FLOPS_RATE.set_function(lambda: _COSTS.rates()[0])
_HBM_FRACTION.set_function(
    lambda: _COSTS.rates()[1] / _peak_bytes_per_s if _peak_bytes_per_s else 0.0
)
_BYTES_RATE.set_function(lambda: _COSTS.rates()[1])


def get_used_memory() -> int:
    """CURRENT resident-set bytes of this process (VmRSS, so a long-lived
    layer reports a figure that can go down). The reference reads it
    through ``executils``; the port's ``executils`` imports torch, so the
    reader lives here."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024  # kB
    except OSError:
        pass
    import resource

    # fallback (non-Linux): peak RSS; ru_maxrss is KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_peak_rss_bytes() -> int:
    """Peak RSS of this process (ru_maxrss is KiB on Linux, bytes on mac)."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(peak if sys.platform == "darwin" else peak * 1024)


_HOST_RSS.set_function(lambda: float(get_used_memory()))
_HOST_PEAK_RSS.set_function(lambda: float(host_peak_rss_bytes()))


# -- factor-arena / quantized-snapshot telemetry ----------------------------
# WEAK sets: a retired store or snapshot must never be pinned by its gauge.
# Providers expose arena_nbytes()/arena_fill() and quantized_nbytes().

_ARENAS: "weakref.WeakSet" = weakref.WeakSet()
_QUANT_PROVIDERS: "weakref.WeakSet" = weakref.WeakSet()


def register_arena(store) -> None:
    """Track a live factor arena for the scrape-time byte/fill gauges."""
    _ARENAS.add(store)


def register_quantized(provider) -> None:
    """Track a live quantized device snapshot (``quantized_nbytes()``)."""
    _QUANT_PROVIDERS.add(provider)


def _arena_bytes() -> float:
    return float(sum(s.arena_nbytes() for s in list(_ARENAS)))


def _arena_fill() -> float:
    sized = [(s.arena_nbytes(), s.arena_fill()) for s in list(_ARENAS)]
    sized = [(b, f) for b, f in sized if b > 0]
    if not sized:
        return 0.0
    total = sum(b for b, _ in sized)
    return sum(b * f for b, f in sized) / total  # byte-weighted fill


def _quantized_bytes() -> float:
    return float(sum(p.quantized_nbytes() for p in list(_QUANT_PROVIDERS)))


_ARENA_BYTES.set_function(_arena_bytes)
_ARENA_FILL.set_function(_arena_fill)
_QUANT_BYTES.set_function(_quantized_bytes)


def _device_memory(cuda, index: int) -> dict:
    """One card's ``{bytes_in_use, peak_bytes, limit_bytes}``: the caching
    allocator's allocated bytes now and at peak, and the card's total."""
    stats = cuda.memory_stats(index)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        "limit_bytes": int(cuda.mem_get_info(index)[1]),
    }


def _device_stat_fn(cuda, index: int, stat: str):
    def fn() -> float:
        try:
            return float(_device_memory(cuda, index)[stat])
        except Exception:  # noqa: BLE001 — a scrape must never 500
            return 0.0

    return fn


_devices_wired = False
_wire_lock = threading.Lock()
# whether each peak still wants auto-detection (no explicit config value);
# True until configure() says otherwise so un-configured processes
# (direct als_train callers) still auto-detect on their first record()
_want_auto_flops = True
_want_auto_bytes = True
# device-dependent wiring done — the fast-path flag _maybe_wire_torch
# checks per record()
_torch_wired = False


def _wire_torch_locked(cuda) -> None:
    """The device half of :func:`configure`: resolve wanted auto peaks from
    the device name and mint one memory-gauge child per card. Caller holds
    ``_wire_lock`` and has checked that CUDA is initialised."""
    global _devices_wired, _peak_flops_per_s, _peak_bytes_per_s
    if _want_auto_flops or _want_auto_bytes:
        auto_f, auto_b = _auto_peaks(cuda)
        if _want_auto_flops:
            _peak_flops_per_s = auto_f
        if _want_auto_bytes:
            _peak_bytes_per_s = auto_b
    if _devices_wired:
        return
    try:
        count = cuda.device_count()
        name = cuda.get_device_name(0) if count else None
    except Exception:  # noqa: BLE001 — no usable device
        return
    if name is not None:
        # the oryx_build_info sample: the device becomes known here, the
        # first moment this process has a CUDA context
        metrics_mod.set_build_info("cuda", name)
    for i in range(count):
        label = f"cuda:{i}"
        _DEV_IN_USE.labels(label).set_function(
            _device_stat_fn(cuda, i, "bytes_in_use"))
        _DEV_PEAK.labels(label).set_function(
            _device_stat_fn(cuda, i, "peak_bytes"))
        _DEV_LIMIT.labels(label).set_function(
            _device_stat_fn(cuda, i, "limit_bytes"))
    _devices_wired = True


def _maybe_wire_torch() -> None:
    """Late completion of configure()'s device wiring. Layers construct
    (and call configure) before their model touches the card, so peak
    auto-detection and the device-memory gauges arm on the first
    execution-site record() once CUDA is initialised. A process that has
    not initialised CUDA (a CPU run) pays one ``sys.modules`` lookup and
    one flag read per record and stays unwired."""
    global _torch_wired
    if _torch_wired:
        return
    cuda = _cuda()
    if cuda is None:
        return
    with _wire_lock:
        if _torch_wired:
            return
        _torch_wired = True
        _wire_torch_locked(cuda)


def configure(config) -> None:
    """Apply ``oryx.profiling.*``: roofline peaks for the MFU/bandwidth
    gauges (0 = auto-detect from the device name where known), the rate
    window, and the per-card memory gauges. Safe to call repeatedly —
    every layer entry point calls it like ``metrics.configure``. While CUDA
    is not initialised the device wiring completes lazily on the first
    :meth:`CostRegistry.record` (see :func:`_maybe_wire_torch`); this
    function never initialises CUDA itself."""
    global _peak_flops_per_s, _peak_bytes_per_s
    global _want_auto_flops, _want_auto_bytes, _torch_wired
    tflops = config.get_float("oryx.profiling.peak-tflops", 0.0)
    gbps = config.get_float("oryx.profiling.peak-hbm-gbps", 0.0)
    _COSTS.set_window(config.get_float("oryx.profiling.window-sec", 60.0))
    with _wire_lock:
        _want_auto_flops = tflops <= 0
        _want_auto_bytes = gbps <= 0
        _peak_flops_per_s = tflops * 1e12 if tflops > 0 else 0.0
        _peak_bytes_per_s = gbps * 1e9 if gbps > 0 else 0.0
        cuda = _cuda()
        _torch_wired = cuda is not None
        if _torch_wired:
            _wire_torch_locked(cuda)


def memory_snapshot() -> dict:
    """Host RSS + per-card memory as a JSON-able dict with the reference's
    STABLE keys (what a blackbox bundle's ``memory`` section holds).
    ``devices`` is empty in a process that has not initialised CUDA."""
    out: dict = {
        "host_rss_bytes": int(get_used_memory()),
        "host_peak_rss_bytes": host_peak_rss_bytes(),
        "host_peak_rss_mb": host_peak_rss_bytes() // (1024 * 1024),
        "devices": {},
    }
    cuda = _cuda()
    if cuda is None:
        return out
    try:
        count = cuda.device_count()
    except Exception:  # noqa: BLE001 — snapshot works without a device
        return out
    for i in range(count):
        try:
            out["devices"][f"cuda:{i}"] = _device_memory(cuda, i)
        except Exception:  # noqa: BLE001
            out["devices"][f"cuda:{i}"] = {
                "bytes_in_use": 0, "peak_bytes": 0, "limit_bytes": 0}
    return out


# ---------------------------------------------------------------------------
# On-demand profiler session
# ---------------------------------------------------------------------------


class ProfileBusyError(RuntimeError):
    """A capture is already in flight (one torch profiler per process)."""


def _foreign_profiler_active() -> bool:
    """True while any torch profiler runs in this process (one opened
    outside this session, e.g. ``with torch.profiler.profile()``).
    ``torch.autograd._profiler_enabled()`` answers for the calling thread
    only; the profiler's module flag, set on every start and cleared on
    every stop, answers for the process, and a second profiler started
    from another thread while one runs can crash the process."""
    import torch.autograd
    import torch.autograd.profiler

    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


class ProfileSession:
    """One-at-a-time ``torch.profiler`` capture with ownership + a duration
    bound. ``start`` raises :class:`ProfileBusyError` while another owner's
    capture is within its bound, or while a torch profiler opened outside
    this session runs; a capture PAST its bound is force-stopped by the
    next starter (a crashed owner must not wedge profiling for the process
    lifetime). ``stop(owner=...)`` only stops the matching owner's capture,
    so a late or duplicate stop can never cut someone else's capture
    short. A capture records CPU activity, and CUDA activity when the
    process has initialised CUDA; its stop writes one Chrome trace
    (``oryx-<pid>-<ms>.pt.trace.json``) into the capture's directory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: "str | None" = None
        self._owner: "str | None" = None
        self._deadline = 0.0
        self._prof = None

    def busy(self) -> bool:
        with self._lock:
            return self._dir is not None

    def owner(self) -> "str | None":
        with self._lock:
            return self._owner

    def start(self, log_dir: str, owner: str = "",
              max_seconds: "float | None" = None) -> str:
        """Begin a capture into ``log_dir``; returns the directory. Raises
        :class:`ProfileBusyError` when an in-bound capture is running."""
        import torch.profiler

        with self._lock:
            if self._dir is not None:
                if max_seconds is None or time.monotonic() < self._deadline:
                    raise ProfileBusyError(
                        f"profiler capture already in flight "
                        f"(owner={self._owner!r}, dir={self._dir})"
                    )
                # previous capture outlived its bound: reclaim the profiler
                log.warning(
                    "force-stopping overdue profiler capture "
                    "(owner=%r, dir=%s)", self._owner, self._dir,
                )
                self._stop_locked()
            if _foreign_profiler_active():
                raise ProfileBusyError(
                    "profiler capture already in flight (a torch profiler "
                    "opened outside the session)")
            os.makedirs(log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if _cuda() is not None:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            self._prof = prof
            self._dir = log_dir
            self._owner = owner
            self._deadline = (
                time.monotonic() + max_seconds
                if max_seconds is not None else float("inf")
            )
            return log_dir

    def stop(self, owner: "str | None" = None) -> "str | None":
        """Stop the active capture (any owner when ``owner`` is None) and
        return its directory; None when there is nothing of ours to stop."""
        with self._lock:
            if self._dir is None:
                return None
            if owner is not None and owner != self._owner:
                return None
            return self._stop_locked()

    def _stop_locked(self) -> "str | None":
        d = self._dir  # analyze: ignore[lock-discipline] -- _stop_locked runs only under self._lock, taken by its callers
        prof = self._prof  # analyze: ignore[lock-discipline] -- under self._lock (see above)
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                d, f"oryx-{os.getpid()}-{int(time.time() * 1e3)}.pt.trace.json"))
        except Exception:  # noqa: BLE001 — never leave the session wedged
            log.exception("failed to stop profiler trace (dir=%s)", d)
        finally:
            self._prof = None
            self._dir = None
            self._owner = None  # analyze: ignore[lock-discipline] -- under self._lock (see above)
            self._deadline = 0.0  # analyze: ignore[lock-discipline] -- under self._lock (see above)
        return d

    def capture(self, log_dir: str, seconds: float,
                owner: str = "capture") -> str:
        """Blocking timed capture (run via ``asyncio.to_thread`` from async
        handlers): start, sleep ``seconds``, stop. Returns the trace dir."""
        d = self.start(log_dir, owner=owner, max_seconds=seconds + 30.0)
        try:
            time.sleep(max(0.0, seconds))
        finally:
            self.stop(owner=owner)
        return d


_SESSION = ProfileSession()


def profile_session() -> ProfileSession:
    """The process-wide session /debug/profile and StepTracer share."""
    return _SESSION


def capture_dir(base: "str | None" = None) -> str:
    """A fresh UNIQUE directory for one capture: a timestamped mkdtemp
    subdir under ``base`` (``oryx.profiling.profile-dir``) or a temp dir
    when unset. mkdtemp's suffix keeps two captures starting within the
    same wall-clock second from sharing (and mixing traces in) one dir."""
    if base:
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(
            prefix=time.strftime("profile-%Y%m%d-%H%M%S-"), dir=base)
    return tempfile.mkdtemp(prefix="oryx-profile-")


def timed_capture(base: "str | None", seconds: float,
                  owner: str = "capture") -> str:
    """Blocking one-shot: mint a fresh capture dir and run a timed capture
    through the shared session. This is the complete worker-thread body
    behind ``POST /debug/profile`` — directory creation AND the capture both
    block, so the whole thing must run off the event loop in one hop."""
    d = capture_dir(base)
    try:
        return _SESSION.capture(d, seconds, owner=owner)
    except ProfileBusyError:
        # we minted the dir before losing the session race; don't leave an
        # empty orphan behind every raced 409
        try:
            os.rmdir(d)
        except OSError:
            pass
        raise
