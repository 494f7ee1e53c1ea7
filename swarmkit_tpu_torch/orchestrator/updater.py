"""Rolling-update supervisor.

Behavioral re-derivation of manager/orchestrator/update/updater.go: dirty
slots are replaced `parallelism` at a time with `delay` between batches,
honoring stop-first vs start-first order; new-task failures within the
monitor window count toward max_failure_ratio, and crossing it triggers the
configured failure action (pause / continue / rollback —
updater.go:204-260, 566-626). One Updater thread runs per service; a newer
spec supersedes the running update (Supervisor.Update spec-diff gate,
updater.go:49-75).

The port's copy of the JAX package's `orchestrator/updater.py`. The port's
store always keeps its columnar mirror, so `UpdateSupervisor` always runs
updates on the shared `UpdateWavePlanner`; the threaded `Updater` stays as
the scalar oracle.
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

from ..analysis.lockgraph import make_lock
from ..api.objects import Task
from ..api.types import (
    TaskState,
    UpdateFailureAction,
    UpdateOrder,
    UpdateStatusState,
)
from ..store import by
from .task import is_task_dirty, mark_shutdown, new_task

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.updater")


# --------------------------------------------------------- shared protocol
# The slot-flip / verdict primitives shared by BOTH rolling-update
# implementations — the per-service threaded `Updater` (the scalar
# oracle) and the shared `UpdateWavePlanner` (orchestrator/batched.py).
# They are the pair's common vocabulary: neither grows a private
# store-write path.

def dirty_slots(store, service) -> list[list[Task]]:
    """Runnable slots whose live tasks drifted from the service spec —
    the unit of rolling-update work (updater.go slotsNeedingUpdate)."""
    from .task import slot_runnable, slots_by_service

    tasks = store.view().find_tasks(by.ByServiceID(service.id))
    slots = slots_by_service(tasks).get(service.id, {})
    dirty = []
    for slot, ts in sorted(slots.items()):
        live = [t for t in ts if t.desired_state <= TaskState.RUNNING]
        if not live or not slot_runnable(live):
            continue
        if any(is_task_dirty(service, t) for t in live):
            dirty.append(live)
    return dirty


def create_replacement(store, service_id: str, slot: int,
                       desired: TaskState,
                       shutdown: list[Task] = ()) -> str | None:
    """Create the fresh-spec replacement for one slot; with `shutdown`
    the old tasks come down in the SAME transaction (stop-first — the
    slot must never look empty to the orchestrator's reconcile,
    updater.go:385-409)."""
    new_task_id: list[str | None] = [None]

    def cb(tx):
        cur_service = tx.get_service(service_id)
        if cur_service is None:
            return
        replacement = new_task(None, cur_service, slot)
        replacement.desired_state = desired
        tx.create(replacement)
        for t in shutdown:
            cur = tx.get_task(t.id)
            if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                cur = cur.copy()
                mark_shutdown(cur)
                tx.update(cur)
        new_task_id[0] = replacement.id

    store.update(cb)
    return new_task_id[0]


def shutdown_tasks(store, slot_tasks: list[Task]) -> None:
    def cb(tx):
        for t in slot_tasks:
            cur = tx.get_task(t.id)
            if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                cur = cur.copy()
                mark_shutdown(cur)
                tx.update(cur)

    store.update(cb)


def remove_task(store, task_id: str) -> None:
    def cb(tx):
        cur = tx.get_task(task_id)
        if cur is not None and cur.desired_state < TaskState.REMOVE:
            cur = cur.copy()
            cur.desired_state = TaskState.REMOVE
            tx.update(cur)

    store.update(cb)


def promote_task(store, task_id: str) -> None:
    def cb(tx):
        cur = tx.get_task(task_id)
        if cur is not None and cur.desired_state == TaskState.READY:
            cur = cur.copy()
            cur.desired_state = TaskState.RUNNING
            tx.update(cur)

    store.update(cb)


def rollback_service(store, service_id: str) -> None:
    """Flip the spec back to previous_spec and mark ROLLBACK_STARTED
    (updater.go:566-626); the resulting service event re-drives a fresh
    update pass in rollback mode."""

    def cb(tx):
        cur = tx.get_service(service_id)
        if cur is None or cur.previous_spec is None:
            return
        cur = cur.copy()
        cur.spec, cur.previous_spec = cur.previous_spec, None
        cur.spec_version.index += 1
        cur.update_status = {
            "state": UpdateStatusState.ROLLBACK_STARTED.value,
            "message": "update rolled back due to failures",
            "timestamp": time.time(),
        }
        tx.update(cur)

    store.update(cb)


def set_update_status(store, service_id: str, state: UpdateStatusState,
                      message: str) -> None:
    def cb(tx):
        cur = tx.get_service(service_id)
        if cur is None:
            return
        cur = cur.copy()
        cur.update_status = {"state": state.value, "message": message,
                             "timestamp": time.time()}
        tx.update(cur)

    try:
        store.update(cb)
    except Exception:
        pass


def finalize_update(store, service_id: str, cfg, rolling_back: bool,
                    failed_out: bool, n_failed: int, total: int) -> None:
    """The shared terminal verdict: failure-policy dispatch when the
    ratio tripped (rollback / pause / continue-with-failures), else the
    completed status for the running kind (updater.go:204-260). A
    failing ROLLBACK cannot roll back again: it pauses."""
    kind = "rollback" if rolling_back else "update"
    paused_state = (UpdateStatusState.ROLLBACK_PAUSED if rolling_back
                    else UpdateStatusState.PAUSED)
    done_state = (UpdateStatusState.ROLLBACK_COMPLETED if rolling_back
                  else UpdateStatusState.COMPLETED)
    if failed_out:
        if cfg.failure_action == UpdateFailureAction.ROLLBACK \
                and not rolling_back:
            rollback_service(store, service_id)
        elif cfg.failure_action == UpdateFailureAction.ROLLBACK:
            set_update_status(
                store, service_id, paused_state,
                f"rollback paused due to failure ratio {n_failed}/{total}")
        elif cfg.failure_action == UpdateFailureAction.PAUSE:
            set_update_status(
                store, service_id, paused_state,
                f"{kind} paused due to failure ratio {n_failed}/{total}")
        else:
            set_update_status(
                store, service_id, done_state,
                f"{kind} completed with {n_failed} failures")
        return
    set_update_status(store, service_id, done_state, f"{kind} completed")


class Updater(threading.Thread):
    def __init__(self, store, restart, service_id: str, supervisor):
        super().__init__(daemon=True, name=f"updater-{service_id[:8]}")
        self.store = store
        self.restart = restart
        self.service_id = service_id
        self.supervisor = supervisor
        self._cancel = threading.Event()
        # failure-policy abort: in-flight slot waits unwind promptly, but
        # (unlike cancel) the final status still gets written
        self._abort = threading.Event()

    def cancel(self):
        self._cancel.set()

    def run(self):
        try:
            self._run()
        finally:
            self.supervisor._done(self.service_id, self)

    def _run(self):
        service = self.store.view().get_service(self.service_id)
        if service is None:
            return
        # a PAUSED update stays paused until the operator acts: the spec
        # update that resolves it clears update_status (controlapi), and
        # only then may a fresh updater run (updater.go Run:129-134)
        state = (service.update_status or {}).get("state")
        if state in (UpdateStatusState.PAUSED.value,
                     UpdateStatusState.ROLLBACK_PAUSED.value):
            return
        # a rollback in progress keeps the rollback status family and uses
        # the rollback config (updater.go Run:162-170)
        rolling_back = state == UpdateStatusState.ROLLBACK_STARTED.value
        if rolling_back:
            from ..api.defaults import default_update_config

            cfg = service.spec.rollback or default_update_config()
        else:
            cfg = service.spec.update
            self._set_update_status(UpdateStatusState.UPDATING,
                                    "update in progress")

        # Worker-pool shape (updater.go:190-260): `parallelism` workers
        # pull slots from a queue, each flipping independently — a slot
        # wedged in its per-slot deadline occupies ONE worker while the
        # others keep rolling; monitor windows overlap everything and
        # failures accrue asynchronously.
        lock = make_lock('orchestrator.updater.rollout')
        monitored: dict[str, float] = {}
        failed: set[str] = set()
        counters = {"updated": 0}
        in_flight: set[int] = set()          # slot numbers queued/flipping
        slot_q: queue_mod.Queue = queue_mod.Queue()
        no_more = threading.Event()

        def poll_failures():
            with lock:
                pending = list(monitored)
            if not pending:
                return
            view = self.store.view()
            now = time.monotonic()
            for tid in pending:
                t = view.get_task(tid)
                with lock:
                    if tid not in monitored:
                        continue
                    if t is not None and t.status.state in (
                            TaskState.FAILED, TaskState.REJECTED):
                        failed.add(tid)
                        del monitored[tid]
                    elif now > monitored[tid]:
                        del monitored[tid]  # window expired healthy

        def over_threshold() -> bool:
            with lock:
                total = max(counters["updated"], 1)
                return (cfg.max_failure_ratio >= 0 and failed
                        and len(failed) / total > cfg.max_failure_ratio)

        def pacing_wait(seconds: float) -> bool:
            """Sleep that also wakes on abort / pool drain. True = bail."""
            deadline = time.monotonic() + seconds
            while True:
                if self._abort.is_set() or no_more.is_set():
                    return False  # no point pacing a finished update
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                if self._cancel.wait(min(0.1, remaining)):
                    return True

        def worker():
            while not (self._cancel.is_set() or self._abort.is_set()):
                try:
                    slot_tasks = slot_q.get(timeout=0.1)
                except queue_mod.Empty:
                    if no_more.is_set():
                        return
                    continue
                outcome, nid = "error", None
                try:
                    outcome, nid = self._update_slot(slot_tasks, cfg.order)
                except Exception:
                    log.exception("updater %s: slot flip failed",
                                  self.service_id[:8])
                with lock:
                    in_flight.discard(slot_tasks[0].slot)
                    if outcome == "ok" and nid is not None:
                        counters["updated"] += 1
                        if cfg.monitor > 0:
                            monitored[nid] = time.monotonic() + cfg.monitor
                    elif outcome == "failed":
                        # per-slot deadline expired: the wedged replacement
                        # was removed; it counts toward the failure ratio
                        # instead of stalling the update
                        counters["updated"] += 1
                        failed.add(nid or f"slot-{slot_tasks[0].slot}")
                if outcome == "error":
                    # store unavailable during churn: the slot stays dirty
                    # and re-queues; back off instead of hot-spinning
                    if pacing_wait(1.0):
                        return
                if cfg.delay > 0 and pacing_wait(cfg.delay):
                    return

        workers: list[threading.Thread] = []

        def ensure_workers(want: int):
            while len(workers) < want:
                w = threading.Thread(target=worker, daemon=True,
                                     name=f"{self.name}-w{len(workers)}")
                w.start()
                workers.append(w)

        aborted = False
        try:
            while not self._cancel.is_set():
                poll_failures()
                # CONTINUE keeps rolling despite failures; PAUSE/ROLLBACK
                # stop — checked BEFORE queueing retries, or a failed slot
                # would start one more doomed flip on its way out
                if over_threshold() and \
                        cfg.failure_action != UpdateFailureAction.CONTINUE:
                    aborted = True
                    self._abort.set()  # unwind in-flight waits promptly
                    break
                service = self.store.view().get_service(self.service_id)
                if service is None:
                    self._abort.set()  # flips are moot: unwind and drain
                    return
                with lock:
                    busy = set(in_flight)
                fresh = [st for st in self._dirty_slots(service)
                         if st[0].slot not in busy]
                with lock:
                    for st in fresh:
                        in_flight.add(st[0].slot)
                    backlog = len(in_flight)
                for st in fresh:
                    slot_q.put(st)
                if backlog:
                    # pool sized by the whole backlog, not just this
                    # iteration's arrivals: slots dirtied one at a time
                    # must not queue behind a wedged worker while the
                    # parallelism budget has headroom
                    ensure_workers(min(cfg.parallelism or backlog, backlog))
                with lock:
                    idle = not in_flight
                if idle and not fresh:
                    break
                if self._cancel.wait(0.1):
                    return
        finally:
            no_more.set()
        for w in workers:
            w.join(timeout=5)

        # drain remaining monitor windows (the pool overlapped them with
        # the flips; only the tail waits here), reacting to failures
        while not self._cancel.is_set() and not over_threshold():
            with lock:
                if not monitored:
                    break
            if self._cancel.wait(0.05):
                return
            poll_failures()

        if over_threshold() or aborted:
            with lock:
                total = max(counters["updated"], 1)
                n_failed = len(failed)
            finalize_update(self.store, self.service_id, cfg, rolling_back,
                            True, n_failed, total)
            return
        if not self._cancel.is_set():
            finalize_update(self.store, self.service_id, cfg, rolling_back,
                            False, 0, 1)

    # ------------------------------------------------------------------ steps
    def _dirty_slots(self, service) -> list[list[Task]]:
        return dirty_slots(self.store, service)

    # bound for the stop-first old-task drain
    SLOT_PHASE_TIMEOUT = 30.0
    # bound for the start-first replacement start: generous (slow prepares
    # are legitimate), and on expiry the stuck replacement is REMOVED so
    # the retry can't accumulate duplicates in the slot
    START_FIRST_TIMEOUT = 600.0

    def _update_slot(self, slot_tasks: list[Task],
                     order) -> tuple[str, str | None]:
        """Replace one slot's tasks with a fresh-spec task. Returns
        (outcome, new_task_id): 'ok' (flip landed — the monitor window
        judges it from here), 'failed' (the per-slot deadline expired and
        the wedged replacement was removed; counts toward the failure
        ratio), or 'error' (store hiccup / abort; the slot stays dirty
        and re-queues).

        Both orders are two-phase (update/updater.go:367-451):
          start-first: create + start the replacement, WAIT until it is
          observed RUNNING (replica count never dips below desired), then
          shut the old tasks down; if the replacement dies first, the old
          tasks are left running and the failure feeds the monitor.
          stop-first: shut the old tasks down, WAIT until they stopped,
          then create the replacement.
        """
        slot = slot_tasks[0].slot
        if order == UpdateOrder.START_FIRST:
            new_id = self._create_replacement(slot, TaskState.RUNNING)
            if new_id is None:
                return "error", None
            outcome = self._wait_task_state(new_id, TaskState.RUNNING,
                                            timeout=self.START_FIRST_TIMEOUT)
            if outcome == "running":
                self._shutdown_tasks(slot_tasks)
            elif outcome == "aborted":
                # the update is over (policy abort / supersession): don't
                # leave an unstarted replacement behind in the slot
                self._remove_task(new_id)
                return "error", None
            elif outcome == "timeout":
                # a replacement that never starts (unschedulable on a full
                # cluster) must not pile up: remove it, keep the old task,
                # count the failure so the policy can act
                self._remove_task(new_id)
                return "failed", new_id
            # 'failed' (died before RUNNING) flows through the monitor
            # window like any young-task death
            return "ok", new_id
        # stop-first: the replacement is created (desired READY) in the
        # SAME transaction that brings the old tasks down, so the slot
        # never looks empty to the orchestrator's reconcile — else it
        # races in a duplicate replica (updater.go:385-409 does the
        # create + removeOldTasks in one batch for this exact reason).
        # The READY→RUNNING promote happens once the old tasks stopped.
        new_id = self._create_replacement(slot, TaskState.READY,
                                          shutdown=slot_tasks)
        if new_id is None:
            return "error", None
        self._wait_tasks_stopped(slot_tasks)
        self._promote(new_id)
        return "ok", new_id

    def _create_replacement(self, slot: int, desired: TaskState,
                            shutdown: list[Task] = ()) -> str | None:
        return create_replacement(self.store, self.service_id, slot,
                                  desired, shutdown)

    def _shutdown_tasks(self, slot_tasks: list[Task]):
        shutdown_tasks(self.store, slot_tasks)

    def _remove_task(self, task_id: str):
        remove_task(self.store, task_id)

    def _promote(self, task_id: str):
        promote_task(self.store, task_id)

    def _wait_task_state(self, task_id: str, want: TaskState,
                         timeout: float | None = SLOT_PHASE_TIMEOUT) -> str:
        """Poll until the task is observed at `want`, dies first, the
        updater is cancelled/aborted, or (when bounded) the phase times
        out. Returns 'running' | 'failed' | 'timeout' | 'aborted'."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else float("inf")
        while not self._cancel.is_set() and time.monotonic() < deadline:
            if self._abort.is_set():
                return "aborted"
            t = self.store.view().get_task(task_id)
            if t is None:
                return "failed"
            if t.status.state >= TaskState.FAILED:
                return "failed"
            if t.status.state >= want:
                return "running"
            if self._cancel.wait(0.05):
                break
        return "aborted" if (self._cancel.is_set() or self._abort.is_set()) \
            else "timeout"

    def _wait_tasks_stopped(self, slot_tasks: list[Task]):
        deadline = time.monotonic() + self.SLOT_PHASE_TIMEOUT
        ids = [t.id for t in slot_tasks]
        while not self._cancel.is_set() and not self._abort.is_set() \
                and time.monotonic() < deadline:
            view = self.store.view()
            live = [tid for tid in ids
                    if (t := view.get_task(tid)) is not None
                    and t.status.state <= TaskState.RUNNING]
            if not live:
                return
            if self._cancel.wait(0.05):
                return

    def _rollback(self, service):
        rollback_service(self.store, self.service_id)

    def _set_update_status(self, state: UpdateStatusState, message: str):
        set_update_status(self.store, self.service_id, state, message)


class UpdateSupervisor:
    """reference: update/updater.go Supervisor.

    Updates run on the SHARED `UpdateWavePlanner` — one thread schedules
    every service's replacement waves instead of one thread per updating
    service. The per-service threaded Updater above stays as the scalar
    oracle: it runs where a caller sets `planner` to None."""

    def __init__(self, store, restart, clock=None):
        self.store = store
        self.restart = restart
        self._updaters: dict[str, Updater] = {}
        self._lock = make_lock('orchestrator.updater.supervisor')
        from .batched import UpdateWavePlanner

        # None only where a caller takes the planner away to run the
        # threaded Updater, the scalar oracle
        self.planner = UpdateWavePlanner(store, restart, clock=clock)

    def update(self, service, dirty_slots):
        if self.planner is not None:
            self.planner.update(service, dirty_slots)
            return
        with self._lock:
            existing = self._updaters.get(service.id)
            if existing is not None and existing.is_alive():
                return  # an update is already converging on the live spec
            u = Updater(self.store, self.restart, service.id, self)
            self._updaters[service.id] = u
            u.start()

    def _done(self, service_id: str, updater):
        with self._lock:
            if self._updaters.get(service_id) is updater:
                del self._updaters[service_id]

    def stop(self):
        if self.planner is not None:
            self.planner.stop()
        with self._lock:
            updaters = list(self._updaters.values())
        for u in updaters:
            u.cancel()
        for u in updaters:
            u.join(timeout=2)
