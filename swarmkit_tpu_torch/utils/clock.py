"""Injectable time source (reference: manager/state/raft/raft.go:186-190
ClockSource + testutils.go:50 AdvanceTicks).

Production code takes a `Clock` and uses it for monotonic reads, timed
waits, and one-shot timers; tests inject `FakeClock` and drive time with
`advance()` so timer-dependent logic (raft tickers, heartbeat expiry)
runs deterministically instead of racing the wall clock on a loaded
machine, where the daemon tier's timers flaked under load.

The port's copy of the JAX package's `utils/clock.py`.
"""
from __future__ import annotations

import threading
from ..analysis.lockgraph import make_lock, make_rlock
import time
from typing import Callable


class _WheelTimer:
    __slots__ = ("due", "fn", "cancelled", "seq", "_wheel")

    def __init__(self, due: float, fn, seq: int, wheel):
        self.due = due
        self.fn = fn
        self.seq = seq
        self.cancelled = False
        self._wheel = wheel

    def cancel(self):
        if not self.cancelled:
            self.cancelled = True
            w = self._wheel
            if w is not None:
                w._note_cancel()

    def __lt__(self, other):          # heap ordering
        return (self.due, self.seq) < (other.due, other.seq)


class TimerWheel:
    """Shared timer service: ONE heap-walking thread plus a small firing
    pool serve every timer in the process.

    The survey's §7 hard-parts note made this a requirement: the
    reference leans on cheap goroutines for 10k per-node heartbeat
    timers; `threading.Timer` spawns an OS THREAD per armed timer and
    the dispatcher re-arms one per node per beat — 10k live timer
    threads and thousands of thread creations/s at the design point.
    Here arming is a heap push; cancellation is a flag (lazily dropped
    when popped). Callbacks fire on a 4-thread pool so one slow expiry
    handler (e.g. a node-down store write during an election) cannot
    stall the wheel."""

    POOL_WORKERS = 4

    def __init__(self):
        self._heap: list[_WheelTimer] = []
        self._cond = threading.Condition(make_rlock("utils.clock.wheel_cond"))
        self._seq = 0
        self._thread: threading.Thread | None = None
        self._pool = None
        self._stopped = False
        self._n_cancelled = 0
        self._busy = 0                 # callbacks currently executing

    def _ensure_started(self):
        if self._thread is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.POOL_WORKERS,
                thread_name_prefix="timer-fire")
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="timer-wheel")
            self._thread.start()

    def _note_cancel(self):
        with self._cond:
            self._n_cancelled += 1

    def timer(self, delay: float, fn: Callable[[], None]) -> _WheelTimer:
        import heapq

        with self._cond:
            if self._stopped:
                raise RuntimeError("timer wheel stopped")
            self._ensure_started()
            self._seq += 1
            t = _WheelTimer(time.monotonic() + delay, fn, self._seq, self)
            heapq.heappush(self._heap, t)
            # heap hygiene (asyncio's rule): cancel-and-re-arm consumers
            # (Heartbeat.beat) would otherwise accumulate dead entries
            # proportional to timeout/beat-interval per node
            if (self._n_cancelled > len(self._heap) // 2
                    and len(self._heap) > 64):
                self._heap = [x for x in self._heap if not x.cancelled]
                heapq.heapify(self._heap)
                self._n_cancelled = 0
            if self._heap[0] is t:
                self._cond.notify()       # new earliest deadline
            return t

    def stop(self):
        """Tests/embedding cleanup; the process-wide wheel never stops."""
        with self._cond:
            self._stopped = True
            self._cond.notify()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def _fire(self, t: _WheelTimer):
        try:
            t.fn()
        except BaseException as exc:   # noqa: BLE001
            # route to threading.excepthook so crashing timer callbacks
            # surface exactly like crashing threads — the conftest guard
            # FAILS the suite on these (a swallowed Future would not)
            threading.excepthook(threading.ExceptHookArgs(
                (type(exc), exc, exc.__traceback__,
                 threading.current_thread())))
        finally:
            with self._cond:
                self._busy -= 1

    def _run(self):
        import heapq

        while True:
            with self._cond:
                if self._stopped:
                    return
                now = time.monotonic()
                due: list[_WheelTimer] = []
                while self._heap and (self._heap[0].cancelled
                                      or self._heap[0].due <= now):
                    t = heapq.heappop(self._heap)
                    if t.cancelled:
                        self._n_cancelled = max(0, self._n_cancelled - 1)
                    else:
                        due.append(t)
                timeout = (self._heap[0].due - now) if self._heap else None
                if not due:
                    self._cond.wait(timeout)
                    continue
                shed = []
                for t in due:
                    # pool saturated (e.g. many node-down handlers stalled
                    # on a raft write during an election): shed to one-off
                    # threads rather than queueing behind blocked workers
                    if self._busy >= self.POOL_WORKERS:
                        shed.append(t)
                    else:
                        self._busy += 1
                        self._pool.submit(self._fire, t)
            for t in shed:
                with self._cond:
                    self._busy += 1
                threading.Thread(target=self._fire, args=(t,),
                                 daemon=True,
                                 name="timer-fire-overflow").start()


class Clock:
    """Real time. Subclass-compatible surface kept deliberately tiny."""

    _wheel: TimerWheel | None = None
    _wheel_lock = make_lock('utils.clock.wheel_lock')

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        """Wall-clock seconds (certificate validity windows are wall time —
        ca/renewer.go computes the renewal point from NotAfter/NotBefore)."""
        return time.time()

    def wait(self, event: threading.Event, timeout: float | None) -> bool:
        """Event.wait under this clock; returns event state like Event.wait."""
        return event.wait(timeout)

    def timer(self, delay: float, fn: Callable[[], None]):
        """One-shot timer; returns an object with .cancel(). Served by the
        process-wide TimerWheel — O(log n) to arm, no thread per timer."""
        if Clock._wheel is None:
            with Clock._wheel_lock:
                if Clock._wheel is None:
                    Clock._wheel = TimerWheel()
        return Clock._wheel.timer(delay, fn)


REAL_CLOCK = Clock()


class _FakeTimer:
    __slots__ = ("due", "fn", "cancelled")

    def __init__(self, due: float, fn):
        self.due = due
        self.fn = fn
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class FakeClock(Clock):
    """Manually-advanced clock. `advance(dt)` moves time forward, fires
    due timers (in due order, outside the lock), and wakes `wait`ers so
    they can re-check their deadlines. Waits on real Events still notice
    sets promptly via a short real-time poll — threads not driven by the
    test cannot deadlock it."""

    def __init__(self, start: float = 1000.0, poll: float = 0.01):
        self._now = start
        self._poll = poll
        self._cond = threading.Condition(make_rlock("utils.clock.fake_cond"))
        self._timers: list[_FakeTimer] = []

    def monotonic(self) -> float:
        with self._cond:
            return self._now

    def time(self) -> float:
        # the fake clock's single timeline serves as wall time too; start
        # it at time.time() in tests that exercise certificate windows
        with self._cond:
            return self._now

    def wait(self, event: threading.Event, timeout: float | None) -> bool:
        if timeout is None:
            return event.wait(None)
        with self._cond:
            deadline = self._now + timeout
            while not event.is_set() and self._now < deadline:
                self._cond.wait(self._poll)
        return event.is_set()

    def timer(self, delay: float, fn):
        with self._cond:
            t = _FakeTimer(self._now + delay, fn)
            self._timers.append(t)
            return t

    def advance(self, dt: float):
        with self._cond:
            self._now += dt
            now = self._now
            due = sorted((t for t in self._timers
                          if not t.cancelled and t.due <= now),
                         key=lambda t: t.due)
            self._timers = [t for t in self._timers
                            if not t.cancelled and t.due > now]
            self._cond.notify_all()
        for t in due:
            t.fn()
