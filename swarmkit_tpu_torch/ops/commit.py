"""Asynchronous commit plane: one background worker for the heavy half of
a scheduler wave's commit (the port of the JAX package's `ops/commit.py`).

A steady wave's host-side commit (slot materialization, the native
add_task segment walk, the caller's store write-back, the fingerprint
restamp) is not needed by the NEXT wave's encode and dispatch; it only has
to be finished before anything reads host scheduling state again (the
encoder's dirty scan, the NodeInfo objects). So the commit splits:

  * synchronous half (stays on the wave loop, `ops/pipeline.py`):
    `fold_counts` before the next encode and `after_apply` before the next
    dispatch, the two pieces placement parity depends on;
  * heavy half (this worker): `commit_cb` + `restamp_counts`, enqueued FIFO
    and overlapped with the next wave's dispatch and counts pull. The
    pull's wait (a CUDA event's synchronize) releases the GIL, and the C
    walk (`native/_hostops.c`) releases it between node segments, so the
    two threads interleave.

The worker runs host code only: it never launches a kernel and never
touches a CUDA tensor.

Discipline:

  * ONE worker thread, bounded queue, strict FIFO: wave k's heavy commit
    fully precedes wave k+1's;
  * every consumer of host scheduling state takes `barrier()` first (in
    TickPipeline the top of every tick, every drain, `flush()`, `close()`);
  * a worker-side exception never dies with the thread: it is captured,
    the queue is poisoned (queued jobs are dropped; they were built on
    state the failed commit left undefined), and the exception re-raises
    on the next `barrier()`/`submit()`, i.e. into the next tick, whose
    caller owns the heal (resident invalidate + re-encode), then `reset()`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from ..analysis.lockgraph import make_rlock
from ..utils import failpoints

# the barrier at each tick keeps at most one wave's heavy half in flight
# per pipeline slot; the bound makes a caller bug fail loudly instead of
# queueing closures without end
DEFAULT_MAX_PENDING = 8


class CommitWorker:
    """A single background thread running submitted thunks FIFO.

    submit() enqueues; barrier() blocks until everything submitted so far
    has retired, then re-raises the first worker exception if one occurred.
    An exception poisons the worker: jobs queued behind it are dropped
    unrun, and every later submit()/barrier() re-raises until the owner
    heals and calls reset()."""

    def __init__(self, name: str = "commit-worker",
                 max_pending: int = DEFAULT_MAX_PENDING):
        self.name = name
        self.max_pending = max_pending
        self._jobs: deque[Callable[[], None]] = deque()
        self._cond = threading.Condition(make_rlock("ops.commit.cond"))
        self._pending = 0            # submitted, not yet retired
        self._exc: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._closed = False
        # seconds the worker spent inside jobs, and each job's duration in
        # retirement (= submission) order
        self.busy_s = 0.0
        self.job_s: list[float] = []
        # jobs retired and poison episodes
        self.jobs_total = 0
        self.poisoned_total = 0

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=self.name, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while not self._jobs and not self._closed:
                    self._cond.wait()
                if self._closed and not self._jobs:
                    return
                job = self._jobs.popleft()
            t0 = time.perf_counter()
            try:
                # failpoint `commit.worker.job`: a worker-side crash at the
                # job boundary (a whole wave's heavy half), for the
                # poison/heal contract
                failpoints.fp("commit.worker.job")
                job()
            except BaseException as exc:  # noqa: BLE001 - must not kill
                # the thread: captured for the next barrier instead
                with self._cond:
                    if self._exc is None:
                        self._exc = exc
                    self.poisoned_total += 1
                    # poison: queued jobs were built on state this failed
                    # commit left undefined; drop, do not run
                    n = len(self._jobs)
                    self._jobs.clear()
                    self._pending -= n
            finally:
                dt = time.perf_counter() - t0
                with self._cond:
                    self.busy_s += dt
                    self.jobs_total += 1
                    # a ring: a long-lived worker must not keep one float
                    # per wave forever
                    if len(self.job_s) >= 4096:
                        del self.job_s[:2048]
                    self.job_s.append(dt)
                    self._pending -= 1
                    self._cond.notify_all()

    @property
    def failed(self) -> bool:
        return self._exc is not None

    def _raise_pending(self):
        exc = self._exc
        if exc is not None:
            raise exc

    def submit(self, job: Callable[[], None]):
        """Enqueue `job` (FIFO). Raises the pending worker exception first,
        if any: a failed plane refuses new work until reset()."""
        with self._cond:
            self._raise_pending()
            if self._closed:
                raise RuntimeError(f"{self.name}: submit after close")
            while self._pending >= self.max_pending and self._exc is None:
                self._cond.wait()
            self._raise_pending()
            self._pending += 1
            self._jobs.append(job)
            self._cond.notify_all()
        self._ensure_thread()

    def barrier(self):
        """Block until every submitted job retired; re-raise the first
        worker exception. After an exception the plane stays poisoned
        (later barriers keep raising) until reset()."""
        with self._cond:
            while self._pending > 0:
                self._cond.wait()
            self._raise_pending()

    def reset(self):
        """Clear a captured exception after the owner healed. Jobs still
        queued were already dropped by the poison path."""
        with self._cond:
            self._exc = None

    def close(self):
        """Drain and stop the thread (idempotent). Does NOT raise a pending
        exception: close runs on teardown paths that must not mask the
        original failure; call barrier() first to see it."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10)

    @property
    def idle(self) -> bool:
        with self._cond:
            return self._pending == 0

    @property
    def pending(self) -> int:
        """Queue depth (submitted, not yet retired)."""
        with self._cond:
            return self._pending
