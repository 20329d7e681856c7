"""Host-side parallel execution helpers.

A copy of the JAX package's ``oryx_tpu/common/executils.py`` (host code),
held equal to it by ``tests/test_torch_mlupdate.py``, with two changes:
``pin_cpu_platform_if_forced`` (it only sets a JAX platform) and
``get_used_memory`` (no caller in the port) are left out, and
:func:`device_sync` synchronises a torch tensor's device. Below, "the
reference" is the original Oryx that module was modelled on.

Equivalent of the reference's ExecUtils (framework/oryx-common/.../lang/
ExecUtils.java:42-118): fixed-pool parallel map/collect used for hyperparameter
candidate builds and load tests. The heavy work inside each task runs on the
card; this pool only overlaps host-side orchestration.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
from typing import Callable, Iterable, Iterator, TypeVar

import torch

T = TypeVar("T")

log = logging.getLogger(__name__)


def do_in_parallel(num_tasks: int, fn: Callable[[int], None], parallelism: int | None = None) -> None:
    """Run fn(0..num_tasks-1), up to ``parallelism`` at a time."""
    for _ in collect_in_parallel(num_tasks, fn, parallelism):
        pass


def collect_in_parallel(
    num_tasks: int, fn: Callable[[int], T], parallelism: int | None = None
) -> list[T]:
    """Run fn over task indices in a bounded pool and collect results in order."""
    if num_tasks <= 0:
        return []
    parallelism = max(1, min(parallelism or num_tasks, num_tasks))
    if parallelism == 1:
        return [fn(i) for i in range(num_tasks)]
    with cf.ThreadPoolExecutor(max_workers=parallelism) as pool:
        futures = [pool.submit(_logging_call, fn, i) for i in range(num_tasks)]
        return [f.result() for f in futures]


def _logging_call(fn: Callable[[int], T], i: int) -> T:
    """Log-and-rethrow wrapper (LoggingCallable equivalent,
    framework/oryx-common/.../lang/LoggingCallable.java)."""
    try:
        return fn(i)
    except Exception:
        log.exception("error in parallel task %d", i)
        raise


def map_in_parallel(items: Iterable[T], fn: Callable[[T], "T"], parallelism: int = 4) -> Iterator:
    with cf.ThreadPoolExecutor(max_workers=parallelism) as pool:
        yield from pool.map(fn, items)


def device_sync(x) -> float:
    """Block until ``x``'s computation has finished on its device: a torch
    synchronise of that device, then the sum of ``x`` fetched to the host.
    Returns the fetched value so callers can also use it as a NaN canary."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(torch.sum(x))


def collect_speculative(
    num_tasks: int,
    fn: "Callable[[int, int], T]",
    parallelism: int | None = None,
    multiplier: float = 1.5,
    min_runtime_sec: float = 10.0,
    abandon_sec: "float | None" = None,
    poll_sec: float = 0.1,
) -> list:
    """Parallel collect with SPECULATIVE backup attempts — the equivalent of
    Spark speculation (reference framework/oryx-common/.../reference.conf:86
    ``spark.speculation = true``): a straggling task whose runtime exceeds
    ``multiplier`` × the median completed-task time (but at least
    ``min_runtime_sec``) gets ONE backup attempt ``fn(i, 1)`` — callers use
    the attempt number to pick a different device — and whichever attempt
    finishes first wins. ``abandon_sec`` (None = wait forever) bounds a
    task whose attempts ALL hang: its result becomes None and the collect
    proceeds, leaving the stuck daemon threads behind rather than the whole
    generation.

    Results are positional like :func:`collect_in_parallel`; a failed or
    abandoned task yields None."""
    import threading
    import time

    if num_tasks <= 0:
        return []
    parallelism = max(1, parallelism if parallelism is not None else num_tasks)

    class _Attempt:
        def __init__(self, task: int, attempt: int):
            self.task = task
            self.attempt = attempt
            self.start = time.monotonic()
            self.result = None
            self.ok = False
            self.done = threading.Event()
            threading.Thread(
                target=self._run,
                name=f"oryx-speculative-{task}.{attempt}",
                daemon=True,
            ).start()

        def _run(self) -> None:
            try:
                self.result = fn(self.task, self.attempt)
                self.ok = True
            except Exception:  # noqa: BLE001 — a failed task yields None
                log.exception("task %d attempt %d failed", self.task, self.attempt)
            finally:
                self.done.set()

    results: list = [None] * num_tasks
    running: dict[int, list[_Attempt]] = {}
    durations: list[float] = []
    next_task = 0
    remaining = num_tasks

    def active() -> int:
        return sum(len(a) for a in running.values())

    while remaining:
        while next_task < num_tasks and active() < parallelism:
            running[next_task] = [_Attempt(next_task, 0)]
            next_task += 1
        time.sleep(poll_sec)
        now = time.monotonic()
        threshold = None
        if durations:
            med = sorted(durations)[len(durations) // 2]
            threshold = max(multiplier * med, min_runtime_sec)
        for task in list(running):
            attempts = running[task]
            finished = [a for a in attempts if a.done.is_set()]
            # FIRST SUCCESSFUL attempt wins (Spark speculation semantics): a
            # crashed/empty backup must not discard a sibling that is still
            # running or already succeeded
            winner = next(
                (a for a in finished if a.ok and a.result is not None), None
            )
            if winner is not None:
                results[task] = winner.result
                durations.append(now - winner.start)
                del running[task]
                remaining -= 1
                continue
            if len(finished) == len(attempts):
                # every attempt resolved without a usable result: the task
                # failed (speculation covers stragglers, not deterministic
                # failures — no retry of an already-failed attempt)
                results[task] = next(
                    (a.result for a in finished if a.ok), None
                )
                del running[task]
                remaining -= 1
                continue
            runtime = now - attempts[0].start
            if (
                len(attempts) == 1
                and threshold is not None
                and runtime > threshold
                and active() < parallelism  # Spark: speculate into free slots
            ):
                log.warning(
                    "task %d straggling (%.1fs > %.1fs); launching backup",
                    task, runtime, threshold,
                )
                attempts.append(_Attempt(task, 1))
            # abandon only when the NEWEST attempt has itself exceeded the
            # limit — a freshly-launched healthy backup must get its own
            # full budget, not inherit the hung original's clock
            if (
                abandon_sec is not None
                and now - attempts[-1].start > abandon_sec
            ):
                log.error(
                    "task %d abandoned after %.1fs (%d attempts hung)",
                    task, runtime, len(attempts),
                )
                del running[task]
                remaining -= 1
    return results
