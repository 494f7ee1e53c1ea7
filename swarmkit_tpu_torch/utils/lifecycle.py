"""Task lifecycle timelines: per-task (stage, t) records filed at the
decision boundaries that write task state.

Disarmed (`_REC is None`, the default), a record site costs one
module-global test and builds nothing. `armed()` installs a recorder for
the length of a `with` block.

The port's copy of the part of the JAX package's `utils/lifecycle.py`
that the orchestrator's and the allocator's record sites call: the
recorder keeps timelines only (no capacity bound, no histograms, no
environment arming).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from ..analysis.lockgraph import make_lock
from ..api.types import TaskState

# The armed recorder, or None; hot sites read it without a lock.
_REC: "LifecycleRecorder | None" = None

STAGE_RANK: dict[str, int] = {s.name: int(s) for s in TaskState}


def _stage_name(stage) -> str:
    # accepts TaskState members, their ints, and plain stage strings
    if isinstance(stage, TaskState):
        return stage.name
    if isinstance(stage, int):
        try:
            return TaskState(stage).name
        except ValueError:
            return str(stage)
    return str(stage)


class LifecycleRecorder:
    """Map of task id -> timeline (list of (stage, t) pairs). A stage
    that does not advance past the timeline's last one is dropped, as the
    task state machine is monotonic."""

    def __init__(self):
        self._lock = make_lock('utils.lifecycle.recorder')
        self._timelines: dict[str, list] = {}
        self.records = 0          # timeline entries appended
        self.rejected = 0         # non-advancing records dropped

    def _append(self, task_id: str, stage: str, t: float) -> None:
        tl = self._timelines.setdefault(task_id, [])
        if tl:
            last_rank = STAGE_RANK.get(tl[-1][0], -1)
            if STAGE_RANK.get(stage, last_rank + 1) <= last_rank:
                self.rejected += 1
                return
        tl.append((stage, t))
        self.records += 1

    def record(self, task_id: str, stage, t: float | None = None) -> None:
        stage = _stage_name(stage)
        with self._lock:
            self._append(task_id, stage, time.time() if t is None else t)

    def record_batch(self, stage, task_ids, t: float | None = None) -> None:
        """One stage for many tasks: one lock hold, one timestamp for the
        whole batch."""
        stage = _stage_name(stage)
        with self._lock:
            now = time.time() if t is None else t
            for task_id in task_ids:
                self._append(task_id, stage, now)

    def timeline(self, task_id: str) -> list[tuple[str, float]]:
        with self._lock:
            return list(self._timelines.get(task_id, ()))

    def timelines(self) -> dict[str, list]:
        with self._lock:
            return {tid: list(tl) for tid, tl in self._timelines.items()}


def enabled() -> bool:
    return _REC is not None


def record(task_id: str, stage, t: float | None = None) -> None:
    """Record one task's stage crossing. Disarmed: one test, nothing
    else."""
    r = _REC
    if r is None:
        return
    r.record(task_id, stage, t=t)


def record_batch(stage, task_ids, t: float | None = None) -> None:
    """One stage, many tasks, one call. Callers that must first assemble
    `task_ids` guard the assembly with `enabled()`, so the disarmed path
    builds nothing."""
    r = _REC
    if r is None:
        return
    r.record_batch(stage, task_ids, t=t)


@contextmanager
def armed():
    """`with lifecycle.armed() as rec: ...`; disarms on exit."""
    global _REC
    r = LifecycleRecorder()
    _REC = r
    try:
        yield r
    finally:
        _REC = None
